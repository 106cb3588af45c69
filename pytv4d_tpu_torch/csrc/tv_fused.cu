// Pass A for inverse problems (the TV dual prox of the over-relaxed
// iterate) in the halo mode of a (z, t)-sharded solve, for NVIDIA Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces, on one shard, the Pallas TPU kernel of
// pytv4d_tpu/kernels/fused.py:
//   tv_dual_kernel <- make_tv_dual_kernel (pass A for inverse problems,
//                                          fused.py:759)
// in its halo mode.  On an unsharded volume it launches the kernel
// specialised per channel table in csrc/specialised_tv.cu instead.  The TV
// passes 1 and 2 (B3, B4), which this source held in their halo mode, are
// specialised per channel table in both modes: pass 1 in
// csrc/specialised_tv.cu, pass 2 in csrc/specialised.cu.
//
// Pass A for inverse problems (solvers/inverse.py, the sharded CT solve of
// parallel/fused_halo.py) is CP pass A's body without its fidelity dual:
// voxel.cuh's weighted_d and tv_dual_prox, the order of operations of
// CP pass A on a shard (csrc/specialised_cp.cu) and of
// csrc/specialised_tv.cu's tv_dual_spec_kernel, so that a shard's y_D'
// equals the unsharded kernel's on the gathered volume bit for bit (its TV
// partials are summed per block of the shard, so their sum differs in the
// last bits).  No time-plane
// multiplier, as in the TPU kernel.  It reads x_bar (1 + Nd / 2 arrays'
// worth with the dual read and written: (1 + 2 Nd) arrays a voxel) and is
// bound by HBM bytes.
//
// Design: one thread per voxel on the plane grid of stencil.cuh, each gating
// its own global index, so there are no tiles, seams or halos; the runtime
// channel table of Params.  x_bar arrives extended by Params::xe = 1 ghost
// or neighbour plane per side in z and t, with the z and t gates off; a
// launch without Params::sharded is refused.  TV partials: one float per
// block in a fixed order (block_sum), no atomics.
//
// Built with -fmad=false, like cp_fused.cu, so each multiply, add and divide
// rounds as in the plain PyTorch version (kernels/fused.py::tv_dual_plain).

#include "voxel.cuh"

// Pass A for inverse problems: y_D' = prox(y_D + sigma_D D x_bar) in place
// and one TV partial of D x_bar per block, x_bar extended by p.xe = 1 plane
// per side in z and t (ghost or neighbour planes), y_D of the shard's shape.
template <typename TX, typename TD>
__global__ void __launch_bounds__(BLOCK)
tv_dual_kernel(const Params p, const TX* __restrict__ x,
               TD* __restrict__ yD, float* __restrict__ parts) {
  const int64_t pix = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  float part = 0.f;
  if (pix < (int64_t)p.Nr * p.Nc) {
    const Vox v = make_vox<true>(p, blockIdx.y, pix, nullptr);
    float d[MAX_CH];
    weighted_d<false, true>(p, x, v.xn, ld(x, v.xn), v.z, v.t, v.r, v.c,
                            v.tm, d);
    part = tv_dual_prox(p, d, yD, v.yb, v.plane);
  }
  const float s = block_sum(part);
  if (threadIdx.x == 0) parts[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// The halo mode only (the unsharded pass A is csrc/specialised_tv.cu's).
template <typename TX, typename TD>
static int launch_dual(const Params* p, const void* x, void* yD, void* parts,
                       cudaStream_t stream) {
  if (!p->sharded || !p->t_free || p->xe != 1 || p->has_tmul)
    return (int)cudaErrorInvalidValue;
  tv_dual_kernel<TX, TD><<<plane_grid(p), BLOCK, 0, stream>>>(
      *p, (const TX*)x, (TD*)yD, (float*)parts);
  return (int)cudaGetLastError();
}

extern "C" {

// Number of TV partials pass A writes for an (Nz, M, Nr, Nc) shard.
long long tv_num_parts(int Nz, int M, int Nr, int Nc) {
  return num_parts(Nz, M, Nr, Nc);
}

// x (extended by one plane per side in z and t) in x_bf16's storage, y_D
// (Nz, M, Nd, Nr, Nc) in d_bf16's; returns cudaGetLastError() after the
// launch (0 = cudaSuccess).
int tv_dual_launch(const Params* p, int x_bf16, int d_bf16, const void* x,
                   void* yD, void* parts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!x_bf16 && !d_bf16) return launch_dual<float, float>(p, x, yD, parts, s);
  if (!x_bf16)
    return launch_dual<float, __nv_bfloat16>(p, x, yD, parts, s);
  if (!d_bf16)
    return launch_dual<__nv_bfloat16, float>(p, x, yD, parts, s);
  return launch_dual<__nv_bfloat16, __nv_bfloat16>(p, x, yD, parts, s);
}

const char* tv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
