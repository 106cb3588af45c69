// Total variation and its subgradient for NVIDIA Hopper (sm_90a), in the
// halo mode of a (z, t)-sharded solve: pass 1 (per-voxel gradient norms and
// TV partials), pass 2 (the subgradient G) and pass A for inverse problems
// (the TV dual prox of the over-relaxed iterate), bound to Python through a
// plain C interface (ctypes).
//
// Replaces, on one shard, the Pallas TPU kernels of
// pytv4d_tpu/kernels/fused.py:
//   tv_norms_kernel   <- make_tv_norms_kernel   (pass 1, fused.py:1353)
//   tv_subgrad_kernel <- make_tv_subgrad_kernel (pass 2, fused.py:1473)
//   tv_dual_kernel    <- make_tv_dual_kernel    (pass A for inverse
//                                                problems, fused.py:759)
// in their halo mode.  On an unsharded volume the three passes launch
// kernels specialised per channel table instead: passes 1 and A in
// csrc/specialised_tv.cu, pass 2 in csrc/specialised.cu.
//
// The contract is tv_and_subgrad_fused (fused.py:1715), which equals
// ops/tv.py::tv_and_subgrad:
//   iso   n = |D x|_2 per voxel (+inf where 0), TV = sum n,
//         G = s * S^T(D x / n) with S^T the adjoint scatter WITHOUT the
//         per-axis weights and s the scheme normalisation, so that s is
//         applied twice (the reference's convention, ops/tv.py:1-10);
//   aniso n = sum |D x|, TV = sum n, G = D^T sign(D x) (full weights);
//   huber n = |D x|_2 (raw), TV = sum huber(n), G = D^T(D x / max(n, delta)).
//
// Layouts (row-major): x, the norms and G are (Nz, M, Nr, Nc).  x and G are
// float or bf16; the norms are float; compute is float.
//
// What bounds it: HBM bytes.  Pass 1 reads x and writes the norms, pass 2
// reads x and the norms and writes G, with a few flops per byte.  So no
// Nd-channel volume is ever stored: each pass recomputes the D channels it
// needs from x in registers.
//
// Design: one thread per voxel on the plane grid of stencil.cuh, each gating
// its own global index, so there are no tiles, seams or halos.  The per-voxel
// bodies are voxel.cuh's, which csrc/resident.cu calls too.  Pass 2 needs
// each channel's value y = f(D x, n) at its own slot and at the +-1 neighbour
// slots the adjoint reads; it recomputes a neighbour's y from x at that
// neighbour's +-1 and from the neighbour's norm, so it reads x out to +-2 and
// the norms out to +-1 along each axis (served by L1/L2).  The TPU kernel's
// seam thin blocks and x_zm2/x_zp2 operands existed because a VMEM tile could
// not see its neighbours; they are dropped.  A neighbour slot that is invalid
// for its channel is never read, so its y is zero before any division.  TV
// partials: one float per block in a fixed order (block_sum), no atomics.
//
// Pass A for inverse problems (solvers/inverse.py, the sharded CT solve of
// parallel/fused_halo.py) is CP pass A's body without its fidelity dual:
// voxel.cuh's weighted_d and tv_dual_prox, the order of operations of
// cp_dual_kernel's HALO instantiation and of csrc/specialised_tv.cu's
// tv_dual_spec_kernel, so that a shard's y_D' equals the unsharded kernel's
// on the gathered volume bit for bit (its TV partials are summed per block
// of the shard, so their sum differs in the last bits).  No time-plane
// multiplier, as in the TPU kernel.  It reads x_bar (1 + Nd / 2 arrays'
// worth with the dual read and written: (1 + 2 Nd) arrays a voxel) and is
// bound by HBM bytes like the others.
//
// Built with -fmad=false, like cp_fused.cu, so each multiply, add and divide
// rounds as in the plain PyTorch version (kernels/fused.py::tv_*_plain).
//
// On one shard of a (z, t)-sharded solve (parallel/fused_halo.py; the TPU
// kernels' halo_mode) the HALO instantiations, the only ones left, read x
// extended by ghost or neighbour planes per side in z and t (1 in pass 1, 2
// in pass 2) and, in pass 2, norms extended by 1, with the z and t gates
// off; a launch without Params::sharded is refused.

#include "voxel.cuh"

// Pass 1: norms[v] (see above) and one TV partial per block
// (voxel.cuh::tv_norms_voxel).
template <typename TX, bool HALO>
__global__ void __launch_bounds__(BLOCK)
tv_norms_kernel(const Params p, const TX* __restrict__ x,
                const float* __restrict__ tmul, float* __restrict__ norms,
                float* __restrict__ parts) {
  const int64_t pix = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  float part = 0.f;
  if (pix < (int64_t)p.Nr * p.Nc)
    part = tv_norms_voxel<HALO>(p, make_vox<HALO>(p, blockIdx.y, pix, tmul),
                                x, norms);
  const float s = block_sum(part);
  if (threadIdx.x == 0) parts[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// Pass 2: G at every voxel from x and the pass-1 norms (unused for aniso)
// (voxel.cuh::tv_subgrad_voxel).
template <typename TX, bool HALO>
__global__ void __launch_bounds__(BLOCK)
tv_subgrad_kernel(const Params p, const TX* __restrict__ x,
                  const float* __restrict__ norms,
                  const float* __restrict__ tmul, TX* __restrict__ g) {
  const int64_t pix = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  if (pix >= (int64_t)p.Nr * p.Nc) return;
  const Vox v = make_vox<HALO>(p, blockIdx.y, pix, tmul);
  st(g, v.xi, tv_subgrad_voxel<HALO>(p, v, x, norms));
}

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

// The halo mode only (the unsharded passes 1 and A are
// csrc/specialised_tv.cu's, the unsharded pass 2 csrc/specialised.cu's).
template <typename TX>
static int launch_norms(const Params* p, const void* x, const void* tmul,
                        void* norms, void* parts, cudaStream_t stream) {
  if (!p->sharded) return (int)cudaErrorInvalidValue;
  tv_norms_kernel<TX, true><<<plane_grid(p), BLOCK, 0, stream>>>(
      *p, (const TX*)x, (const float*)tmul, (float*)norms, (float*)parts);
  return (int)cudaGetLastError();
}

template <typename TX>
static int launch_subgrad(const Params* p, const void* x, const void* norms,
                          const void* tmul, void* g, cudaStream_t stream) {
  if (!p->sharded) return (int)cudaErrorInvalidValue;
  tv_subgrad_kernel<TX, true><<<plane_grid(p), BLOCK, 0, stream>>>(
      *p, (const TX*)x, (const float*)norms, (const float*)tmul, (TX*)g);
  return (int)cudaGetLastError();
}

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

// Number of TV partials pass 1 (and pass A) writes for an (Nz, M, Nr, Nc) volume.
long long tv_num_parts(int Nz, int M, int Nr, int Nc) {
  return num_parts(Nz, M, Nr, Nc);
}

// Both return cudaGetLastError() after the launch (0 = cudaSuccess).
int tv_norms_launch(const Params* p, int x_bf16, const void* x,
                    const void* tmul, void* norms, void* parts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16)
    return launch_norms<__nv_bfloat16>(p, x, tmul, norms, parts, s);
  return launch_norms<float>(p, x, tmul, norms, parts, s);
}

int tv_subgrad_launch(const Params* p, int x_bf16, const void* x,
                      const void* norms, const void* tmul, void* g,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16)
    return launch_subgrad<__nv_bfloat16>(p, x, norms, tmul, g, s);
  return launch_subgrad<float>(p, x, norms, tmul, g, s);
}

// x (extended by one plane per side in z and t) in x_bf16's storage, y_D
// (Nz, M, Nd, Nr, Nc) in d_bf16's.
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
