// Chambolle-Pock TV step for NVIDIA Hopper (sm_90a): pass B (primal) on an
// unsharded volume, bound to Python through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel of pytv4d_tpu/kernels/fused.py:
//   cp_primal_kernel <- make_cp_primal_kernel (pass B, fused.py:859;
//                                              unsharded launches)
// Pass A (make_cp_dual_kernel, fused.py:652) is specialised per channel
// table: on a volume in csrc/specialised.cu, on one shard of a (z, t)-sharded
// solve, in both of its modes, in csrc/specialised_cp.cu, which also holds
// pass B's sharded modes.  Pass A for inverse problems
// (make_tv_dual_kernel, fused.py:759) is csrc/specialised_tv.cu's, on a
// volume and on a shard.
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
// below the card's ridge point, so the design keeps every intermediate (the
// prox argument, D^T y') in registers and touches each array once per pass
// (utils/profiling.py cp_traffic_model).
//
// Design: one thread per voxel, a 1-D block of 256 threads along a
// (z, t) plane; blockIdx.y is the plane (stencil.cuh).  The per-voxel body
// is voxel.cuh's, which csrc/resident.cu calls too.  Each thread gates its
// own global index against the one-sided zero-slot boundary
// (core/schemes.py), so there are no tiles, seams or halos.  The TPU
// kernel's row tiling, seam thin blocks and split adjoint (dt_local) existed
// because VMEM could not hold the dual; they are dropped: pass B computes
// the full D^T y_D' at its pixel from y_D' at the pixel and its +-1
// neighbours per channel (neighbour reads hit L1/L2).  Pass B reads x and
// writes x' only at the thread's own pixel, so it runs in place or out of
// place, at no cost.  Loss partials: one float per block, reduced in a fixed
// order (warp shuffles, then one warp) -- no float atomics, so two runs give
// the same bits.
//
// Built with -fmad=false: every multiply and add rounds as it does in the
// plain PyTorch version (kernels/fused.py), which keeps the two within f32
// round-off of each other and flips few bf16 roundings.

#include "voxel.cuh"

// Pass B: x' = x - tau y_A' - tau D^T y_D' (then max(x', 0) when nonneg), and
// one fidelity partial of x' per block (voxel.cuh::cp_primal_voxel).  x'
// goes to `out`, which is x itself (in place) or a second buffer; x0 may be
// x (the inverse solver discards the partial), so none of the three is
// __restrict__.
template <typename TX, typename TD>
__global__ void __launch_bounds__(BLOCK)
cp_primal_kernel(const Params p, const TX* x, const TX* x0,
                 const TX* __restrict__ yA, const TD* __restrict__ yD,
                 const float* __restrict__ tmul, TX* out,
                 float* __restrict__ parts) {
  const int64_t pix = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  const int zt = blockIdx.y;
  float part = 0.f;
  if (pix < (int64_t)p.Nr * p.Nc)
    part = cp_primal_voxel(p, make_vox(p, zt, pix, tmul), x, x0, yA, yD,
                           out);
  const float s = block_sum(part);
  if (threadIdx.x == 0)
    parts[(int64_t)zt * gridDim.x + blockIdx.x] = p.fid_scale * s;
}

// Unsharded volumes only (a shard's pass B is csrc/specialised_cp.cu's).
template <typename TX, typename TD>
static int launch_primal(const Params* p, const void* x, const void* x0,
                         const void* yA, const void* yD, const void* tmul,
                         void* out, void* parts, cudaStream_t stream) {
  if (p->sharded) return (int)cudaErrorInvalidValue;
  cp_primal_kernel<TX, TD><<<plane_grid(p), BLOCK, 0, stream>>>(
      *p, (const TX*)x, (const TX*)x0, (const TX*)yA, (const TD*)yD,
      (const float*)tmul, (TX*)out, (float*)parts);
  return (int)cudaGetLastError();
}

extern "C" {

// Number of loss partials pass B writes for an (Nz, M, Nr, Nc) volume.
long long cp_num_parts(int Nz, int M, int Nr, int Nc) {
  return num_parts(Nz, M, Nr, Nc);
}

// Returns cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for Params of a shard.  `out` receives x': x itself
// for the in-place step, or a second buffer.
int cp_primal_launch(const Params* p, int x_bf16, int d_bf16, const void* x,
                     const void* x0, const void* yA, const void* yD,
                     const void* tmul, void* out, void* parts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!x_bf16 && !d_bf16)
    return launch_primal<float, float>(p, x, x0, yA, yD, tmul, out, parts, s);
  if (!x_bf16)
    return launch_primal<float, __nv_bfloat16>(p, x, x0, yA, yD, tmul, out,
                                               parts, s);
  if (!d_bf16)
    return launch_primal<__nv_bfloat16, float>(p, x, x0, yA, yD, tmul, out,
                                               parts, s);
  return launch_primal<__nv_bfloat16, __nv_bfloat16>(p, x, x0, yA, yD, tmul,
                                                     out, parts, s);
}

const char* cp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
