// Chambolle-Pock TV step for NVIDIA Hopper (sm_90a): pass A (dual) in the
// sharded modes and pass B (primal), bound to Python through a plain C
// interface (ctypes).
//
// Replaces the Pallas TPU kernels of pytv4d_tpu/kernels/fused.py:
//   cp_dual_kernel   <- make_cp_dual_kernel   (pass A, fused.py:652; its
//                                              sharded modes: the unsharded
//                                              pass A is specialised per
//                                              channel table, in
//                                              csrc/specialised.cu)
//   cp_primal_kernel <- make_cp_primal_kernel (pass B, fused.py:859)
// Pass A for inverse problems (make_tv_dual_kernel, fused.py:759), which has
// no sharded mode, is specialised per channel table in
// csrc/specialised_tv.cu.
// The denoising contract is cp_step_fused_internal (fused.py:1303): for
// (x, y_A, y_D, x0) the pair returns (x', y_A', y_D', loss) with
// loss = sum(fid parts of x') + reg * sum(TV parts of D x_old).  For an
// inverse problem min F(A x) + reg TV(x) (solvers/inverse.py) the fidelity
// dual lives in the measurement space and is updated outside: pass A for
// inverse problems takes (x_bar, y_D) to (y_D', TV parts of D x_bar), and
// pass B runs with A^T y_A in its y_A slot, writing x' to a second buffer
// because the solver still needs x for x_bar' = 2 x' - x.  The TPU kernel's
// third output, dt_local (the in-tile part of D^T y_D'), is dropped as in
// pass A: pass B computes the full adjoint.
//
// Layouts (internal, row-major): x, x0, y_A are (Nz, M, Nr, Nc); the TV dual
// y_D is channel-contiguous (Nz, M, Nd, Nr, Nc).  Storage is float or bf16,
// set independently for the primary arrays and the dual; compute is float.
//
// What bounds it: HBM bytes.  One step does ~10 flops per byte moved, far
// below the card's ridge point, so the design keeps every intermediate (D x,
// the prox argument, D^T y') in registers and touches each array once per
// pass (utils/profiling.py cp_traffic_model).
//
// Design: one thread per voxel, a 1-D block of 256 threads along a
// (z, t) plane; blockIdx.y is the plane (stencil.cuh).  The per-voxel bodies
// are voxel.cuh's, which csrc/cp_zstream.cu and csrc/resident.cu call too.  Each thread gates its
// own global index against the one-sided zero-slot boundary
// (core/schemes.py), so there are no tiles, seams or halos.  The TPU kernel's row tiling, seam thin
// blocks and split adjoint (dt_local) existed because VMEM could not hold the
// dual; they are dropped: pass B computes the full D^T y_D' at its pixel from
// y_D' at the pixel and its +-1 neighbours per channel (neighbour reads hit
// L1/L2).  Pass A writes y_A, y_D and pass B reads x and writes x' only at
// the thread's own pixel, so both run in place (pass B also out of place, at
// no cost).  Loss partials: one float per block,
// reduced in a fixed order (warp shuffles, then one warp) -- no float
// atomics, so two runs give the same bits.
//
// Built with -fmad=false: every multiply and add rounds as it does in the
// plain PyTorch version (kernels/fused.py), which keeps the two within f32
// round-off of each other and flips few bf16 roundings.
//
// Passes A and B also run on one shard of a (z, t)-sharded solve
// (parallel/fused_halo.py; the TPU kernels' halo_mode and interior): the HALO
// instantiations, chosen by Params::sharded.  Pass A then reads x extended by
// a ghost or neighbour plane per side in z and t, pass B the neighbour slots
// of the dual from such an extended copy, the z and t gates are off (the
// ghost planes reproduce the zero-slot boundary), and a launch may compute
// only planes z_first..z_last, leaving the others and their partials as they
// are (the edge planes are csrc/cp_boundary.cu's).  Without the flag the
// instantiations are the ones above, unchanged, but for pass A, which then
// runs csrc/specialised.cu's kernel instead.

#include "voxel.cuh"

// Pass A: y_A' = fid prox, y_D' = TV dual prox of y_D + sigma_D D x, and one
// TV partial of D x per block (voxel.cuh::cp_dual_voxel).
template <typename TX, typename TD, bool HALO>
__global__ void __launch_bounds__(BLOCK)
cp_dual_kernel(const Params p, const TX* __restrict__ x,
               const TX* __restrict__ x0, TX* __restrict__ yA,
               TD* __restrict__ yD, const float* __restrict__ tmul,
               float* __restrict__ parts) {
  const int64_t pix = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  const int zt = HALO ? blockIdx.y + p.z_first * p.M : blockIdx.y;
  float part = 0.f;
  if (pix < (int64_t)p.Nr * p.Nc) {
    const Vox v = make_vox<HALO>(p, zt, pix, tmul);
    part = cp_dual_voxel<false, HALO>(p, v, x, x0, yA, yD,
                                      ld(x, HALO ? v.xn : v.xi));
  }
  const float s = block_sum(part);
  if (threadIdx.x == 0) parts[(int64_t)zt * gridDim.x + blockIdx.x] = s;
}

// Pass B: x' = x - tau y_A' - tau D^T y_D' (then max(x', 0) when nonneg), and
// one fidelity partial of x' per block (voxel.cuh::cp_primal_voxel).  x'
// goes to `out`, which is x itself (in place) or a second buffer; x0 may be
// x (the inverse solver discards the partial), so none of the three is
// __restrict__.  yN (HALO only) is the array the dual is read from: the
// extended copy of yD, or yD itself where the launch computes interior
// planes.
template <typename TX, typename TD, bool HALO>
__global__ void __launch_bounds__(BLOCK)
cp_primal_kernel(const Params p, const TX* x, const TX* x0,
                 const TX* __restrict__ yA, const TD* __restrict__ yD,
                 const TD* __restrict__ yN,
                 const float* __restrict__ tmul, TX* out,
                 float* __restrict__ parts) {
  const int64_t pix = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  const int zt = HALO ? blockIdx.y + p.z_first * p.M : blockIdx.y;
  float part = 0.f;
  if (pix < (int64_t)p.Nr * p.Nc)
    part = cp_primal_voxel<HALO>(p, make_vox<HALO>(p, zt, pix, tmul), x, x0,
                                 yA, yD, out, yN);
  const float s = block_sum(part);
  if (threadIdx.x == 0)
    parts[(int64_t)zt * gridDim.x + blockIdx.x] = p.fid_scale * s;
}

// Sharded modes only (the unsharded pass A is csrc/specialised.cu's).
template <typename TX, typename TD>
static int launch_dual(const Params* p, const void* x, const void* x0,
                       void* yA, void* yD, const void* tmul, void* parts,
                       cudaStream_t stream) {
  if (!p->sharded) return (int)cudaErrorInvalidValue;
  cp_dual_kernel<TX, TD, true>
      <<<plane_grid(p, p->z_last - p->z_first + 1), BLOCK, 0, stream>>>(
          *p, (const TX*)x, (const TX*)x0, (TX*)yA, (TD*)yD,
          (const float*)tmul, (float*)parts);
  return (int)cudaGetLastError();
}

template <typename TX, typename TD>
static int launch_primal(const Params* p, const void* x, const void* x0,
                         const void* yA, const void* yD, const void* yN,
                         const void* tmul, void* out, void* parts,
                         cudaStream_t stream) {
  if (p->sharded)
    cp_primal_kernel<TX, TD, true>
        <<<plane_grid(p, p->z_last - p->z_first + 1), BLOCK, 0, stream>>>(
            *p, (const TX*)x, (const TX*)x0, (const TX*)yA, (const TD*)yD,
            (const TD*)yN, (const float*)tmul, (TX*)out, (float*)parts);
  else
    cp_primal_kernel<TX, TD, false><<<plane_grid(p), BLOCK, 0, stream>>>(
        *p, (const TX*)x, (const TX*)x0, (const TX*)yA, (const TD*)yD,
        nullptr, (const float*)tmul, (TX*)out, (float*)parts);
  return (int)cudaGetLastError();
}

extern "C" {

// Number of loss partials each pass writes for an (Nz, M, Nr, Nc) volume.
long long cp_num_parts(int Nz, int M, int Nr, int Nc) {
  return num_parts(Nz, M, Nr, Nc);
}

// Each returns cudaGetLastError() after the launch (0 = cudaSuccess).
int cp_dual_launch(const Params* p, int x_bf16, int d_bf16, const void* x,
                   const void* x0, void* yA, void* yD, const void* tmul,
                   void* parts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!x_bf16 && !d_bf16)
    return launch_dual<float, float>(p, x, x0, yA, yD, tmul, parts, s);
  if (!x_bf16)
    return launch_dual<float, __nv_bfloat16>(p, x, x0, yA, yD, tmul, parts, s);
  if (!d_bf16)
    return launch_dual<__nv_bfloat16, float>(p, x, x0, yA, yD, tmul, parts, s);
  return launch_dual<__nv_bfloat16, __nv_bfloat16>(p, x, x0, yA, yD, tmul,
                                                   parts, s);
}

// `out` receives x': x itself for the in-place step, or a second buffer.
// yN is read only when p->sharded (see cp_primal_kernel).
int cp_primal_launch(const Params* p, int x_bf16, int d_bf16, const void* x,
                     const void* x0, const void* yA, const void* yD,
                     const void* yN, const void* tmul, void* out, void* parts,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!x_bf16 && !d_bf16)
    return launch_primal<float, float>(p, x, x0, yA, yD, yN, tmul, out, parts,
                                       s);
  if (!x_bf16)
    return launch_primal<float, __nv_bfloat16>(p, x, x0, yA, yD, yN, tmul,
                                               out, parts, s);
  if (!d_bf16)
    return launch_primal<__nv_bfloat16, float>(p, x, x0, yA, yD, yN, tmul,
                                               out, parts, s);
  return launch_primal<__nv_bfloat16, __nv_bfloat16>(p, x, x0, yA, yD, yN,
                                                     tmul, out, parts, s);
}

const char* cp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
