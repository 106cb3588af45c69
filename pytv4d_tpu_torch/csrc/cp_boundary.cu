// The boundary kernels of the overlapped z-sharded Chambolle-Pock step for
// NVIDIA Hopper (sm_90a), bound to Python through a plain C interface
// (ctypes).
//
// Replaces the Pallas TPU kernels of pytv4d_tpu/kernels/fused.py:
//   cp_dual_boundary_kernel   <- make_cp_dual_boundary_kernel   (fused.py:1093)
//   cp_primal_boundary_kernel <- make_cp_primal_boundary_kernel (fused.py:1187)
// The overlapped step (parallel/fused_halo.py, overlap=True) first takes the
// two z-edge planes of every shard's x for its neighbours, runs passes A and
// B of csrc/cp_fused.cu over the planes 1..Nz-2 of each shard (which need no
// neighbour's data), and then these two kernels redo the planes z = 0 and
// z = Nz-1 from the exchanged planes, in place into the same arrays and into
// the same per-block partials.  Slot b of a (2, ...) halo stack is the plane
// from the left neighbour (b = 0: the value at z - 1 of plane 0) or from the
// right one (b = 1: the value at z + 1 of plane Nz-1); at a global edge the
// x stack holds the ghost plane that makes every z difference there zero and
// the dual stack holds zeros.  Time is not sharded on this path, so the t
// gates stay on; the z gates are off (Params::sharded).
//
// Layouts as in cp_fused.cu; x_halo is (2, M, Nr, Nc), y_halo
// (2, M, Nd, Nr, Nc).
//
// What bounds it: the launch.  The kernels touch 2 of Nz planes ((4 + 2 Nd)
// and (4 + Nd) arrays of 2 M Nr Nc voxels plus the halo stacks): tens of
// microseconds of HBM time at most, so the fixed cost of a launch shows.
//
// Design: the per-voxel bodies are voxel.cuh's cp_dual_voxel and
// cp_primal_voxel, the ones every other CP kernel runs, so the overlapped
// step equals the ghost-plane step to the bit.  One thread per voxel;
// blockIdx.y = b * M + t.  Pass A takes its z neighbours by register
// (weighted_d<ZREG>, as the z-marching pass A does): the halo value across
// the shard's edge, the in-shard plane on the other side.  Pass B computes
// the full adjoint at the voxel and reads a z channel's neighbour across the
// edge from the halo stack, every other value from the shard's own dual.
// The TPU kernels' (2, R) row-tile grid, seam rows and alias-carrier inputs
// belong to VMEM tiling and are not carried over.
//
// Built with -fmad=false like the other sources.

#include "voxel.cuh"

// The (z, t) plane of the shard a block works on: blockIdx.y = b * M + t is
// time t of edge plane b, which is plane z = 0 (b = 0) or z = Nz - 1.
__device__ __forceinline__ int edge_plane(const Params& p, int& b) {
  b = blockIdx.y / p.M;
  return b * (p.Nz - 1) * p.M + (blockIdx.y - b * p.M);
}

// Pass A on the two edge planes: y_A', y_D' in place and the planes' TV
// partials of D x into `parts` (the interior launch's array).
template <typename TX, typename TD>
__global__ void __launch_bounds__(BLOCK)
cp_dual_boundary_kernel(const Params p, const TX* __restrict__ x,
                        const TX* __restrict__ x_halo,
                        const TX* __restrict__ x0, TX* __restrict__ yA,
                        TD* __restrict__ yD, const float* __restrict__ tmul,
                        float* __restrict__ parts) {
  const int64_t pix = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  int b;
  const int zt = edge_plane(p, b);
  float part = 0.f;
  if (pix < (int64_t)p.Nr * p.Nc) {
    const Vox v = make_vox<true>(p, zt, pix, tmul);
    const int64_t zs = (int64_t)p.M * v.plane;  // one z plane of x
    const int64_t hi = ((int64_t)b * p.M + v.t) * v.plane + pix;
    const float xzm = b == 0 ? ld(x_halo, hi) : ld(x, v.xi - zs);
    const float xzp = b == 1 ? ld(x_halo, hi) : ld(x, v.xi + zs);
    part = cp_dual_voxel<true, true>(p, v, x, x0, yA, yD, ld(x, v.xi), xzm,
                                     xzp);
  }
  const float s = block_sum(part);
  if (threadIdx.x == 0) parts[(int64_t)zt * gridDim.x + blockIdx.x] = s;
}

// Pass B on the two edge planes: x' in place and the planes' fidelity
// partials of x' into `parts`.
template <typename TX, typename TD>
__global__ void __launch_bounds__(BLOCK)
cp_primal_boundary_kernel(const Params p, TX* x, const TX* __restrict__ x0,
                          const TX* __restrict__ yA,
                          const TD* __restrict__ yD,
                          const TD* __restrict__ y_halo,
                          const float* __restrict__ tmul,
                          float* __restrict__ parts) {
  const int64_t pix = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  int b;
  const int zt = edge_plane(p, b);
  float part = 0.f;
  if (pix < (int64_t)p.Nr * p.Nc) {
    const Vox v = make_vox<true>(p, zt, pix, tmul);
    const int64_t zs = (int64_t)p.M * p.Nd * v.plane;  // one z plane of y_D
    const int64_t hb = ((int64_t)b * p.M + v.t) * p.Nd * v.plane + pix;
    // channel 0 of the dual at z - 1 and at z + 1: across the edge in the
    // halo stack, inside the shard in y_D
    const TD* zlo = b == 0 ? y_halo : yD;
    const TD* zhi = b == 1 ? y_halo : yD;
    const int64_t zlo_b = b == 0 ? hb : v.yb - zs;
    const int64_t zhi_b = b == 1 ? hb : v.yb + zs;
    part = cp_primal_voxel<true, true>(p, v, x, x0, yA, yD, x, yD, zlo, zlo_b,
                                       zhi, zhi_b);
  }
  const float s = block_sum(part);
  if (threadIdx.x == 0)
    parts[(int64_t)zt * gridDim.x + blockIdx.x] = p.fid_scale * s;
}

template <typename TX, typename TD>
static int launch_dual_boundary(const Params* p, const void* x,
                                const void* x_halo, const void* x0, void* yA,
                                void* yD, const void* tmul, void* parts,
                                cudaStream_t stream) {
  cp_dual_boundary_kernel<TX, TD><<<plane_grid(p, 2), BLOCK, 0, stream>>>(
      *p, (const TX*)x, (const TX*)x_halo, (const TX*)x0, (TX*)yA, (TD*)yD,
      (const float*)tmul, (float*)parts);
  return (int)cudaGetLastError();
}

template <typename TX, typename TD>
static int launch_primal_boundary(const Params* p, void* x, const void* x0,
                                  const void* yA, const void* yD,
                                  const void* y_halo, const void* tmul,
                                  void* parts, cudaStream_t stream) {
  cp_primal_boundary_kernel<TX, TD><<<plane_grid(p, 2), BLOCK, 0, stream>>>(
      *p, (TX*)x, (const TX*)x0, (const TX*)yA, (const TD*)yD,
      (const TD*)y_halo, (const float*)tmul, (float*)parts);
  return (int)cudaGetLastError();
}

extern "C" {

// Both return cudaGetLastError() after the launch (0 = cudaSuccess).  `parts`
// is the array of cp_num_parts(Nz, M, Nr, Nc) partials (csrc/cp_fused.cu) the
// interior launch wrote; only the two edge planes' entries are written.
int cp_dual_boundary_launch(const Params* p, int x_bf16, int d_bf16,
                            const void* x, const void* x_halo, const void* x0,
                            void* yA, void* yD, const void* tmul, void* parts,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!x_bf16 && !d_bf16)
    return launch_dual_boundary<float, float>(p, x, x_halo, x0, yA, yD, tmul,
                                              parts, s);
  if (!x_bf16)
    return launch_dual_boundary<float, __nv_bfloat16>(p, x, x_halo, x0, yA,
                                                      yD, tmul, parts, s);
  if (!d_bf16)
    return launch_dual_boundary<__nv_bfloat16, float>(p, x, x_halo, x0, yA,
                                                      yD, tmul, parts, s);
  return launch_dual_boundary<__nv_bfloat16, __nv_bfloat16>(
      p, x, x_halo, x0, yA, yD, tmul, parts, s);
}

int cp_primal_boundary_launch(const Params* p, int x_bf16, int d_bf16,
                              void* x, const void* x0, const void* yA,
                              const void* yD, const void* y_halo,
                              const void* tmul, void* parts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!x_bf16 && !d_bf16)
    return launch_primal_boundary<float, float>(p, x, x0, yA, yD, y_halo,
                                                tmul, parts, s);
  if (!x_bf16)
    return launch_primal_boundary<float, __nv_bfloat16>(p, x, x0, yA, yD,
                                                        y_halo, tmul, parts,
                                                        s);
  if (!d_bf16)
    return launch_primal_boundary<__nv_bfloat16, float>(p, x, x0, yA, yD,
                                                        y_halo, tmul, parts,
                                                        s);
  return launch_primal_boundary<__nv_bfloat16, __nv_bfloat16>(
      p, x, x0, yA, yD, y_halo, tmul, parts, s);
}

const char* bnd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
