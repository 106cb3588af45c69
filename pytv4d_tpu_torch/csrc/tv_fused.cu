// Total variation and its subgradient for NVIDIA Hopper (sm_90a): pass 1
// (per-voxel gradient norms and TV partials) and pass 2 (the subgradient G),
// bound to Python through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernels of pytv4d_tpu/kernels/fused.py:
//   tv_norms_kernel   <- make_tv_norms_kernel   (pass 1, fused.py:1353)
//   tv_subgrad_kernel <- make_tv_subgrad_kernel (pass 2, fused.py:1473)
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
// its own global index, so there are no tiles, seams or halos.  Pass 2 needs
// each channel's value y = f(D x, n) at its own slot and at the +-1 neighbour
// slots the adjoint reads; it recomputes a neighbour's y from x at that
// neighbour's +-1 and from the neighbour's norm, so it reads x out to +-2 and
// the norms out to +-1 along each axis (served by L1/L2).  The TPU kernel's
// seam thin blocks and x_zm2/x_zp2 operands existed because a VMEM tile could
// not see its neighbours; they are dropped.  A neighbour slot that is invalid
// for its channel is never read, so its y is zero before any division.  TV
// partials: one float per block in a fixed order (block_sum), no atomics.
//
// Built with -fmad=false, like cp_fused.cu, so each multiply, add and divide
// rounds as in the plain PyTorch version (kernels/fused.py::tv_*_plain).

#include "stencil.cuh"

// Pass 1: norms[v] (see above) and one TV partial per block.
template <typename TX>
__global__ void __launch_bounds__(BLOCK)
tv_norms_kernel(const Params p, const TX* __restrict__ x,
                const float* __restrict__ tmul, float* __restrict__ norms,
                float* __restrict__ parts) {
  const int64_t plane = (int64_t)p.Nr * p.Nc;
  const int zt = blockIdx.y;
  const int64_t pix = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  float part = 0.f;
  if (pix < plane) {
    const int z = zt / p.M, t = zt - z * p.M;
    const int r = (int)(pix / p.Nc), c = (int)(pix - (int64_t)r * p.Nc);
    const int64_t xi = (int64_t)zt * plane + pix;
    const float tm = p.has_tmul ? tmul[pix] : 1.f;
    float d[MAX_CH];
    weighted_d(p, x, xi, ld(x, xi), z, t, r, c, tm, d);
    if (p.norm == N_ANISO) {
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_CH; ++i)
        if (i < p.Nd) a += fabsf(d[i]);
      part = a;
      norms[xi] = a;
    } else {
      float nsq = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_CH; ++i)
        if (i < p.Nd) nsq += d[i] * d[i];
      const float n = sqrtf(nsq);
      if (p.norm == N_HUBER) {
        part = n <= p.huber_delta ? (n * n) / (2.f * p.huber_delta)
                                  : n - p.huber_delta / 2.f;
        norms[xi] = n;
      } else {
        part = n;  // the TV sum is taken before the +inf replacement
        norms[xi] = n == 0.f ? __int_as_float(0x7f800000) : n;  // +inf
      }
    }
  }
  const float s = block_sum(part);
  if (threadIdx.x == 0) parts[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// Channel i's value y at slot q of its axis (q a valid slot, so every read
// below is inside the volume): the weighted difference dv of x there, then
// sign(dv) for aniso, dv / n(q) for iso (n = +inf gives 0) and
// dv / max(n(q), delta) for huber.
template <typename TX>
__device__ __forceinline__ float chan_y(const Params& p, int i,
                                        const TX* __restrict__ x,
                                        const float* __restrict__ norms,
                                        int64_t q, int64_t s, float tm) {
  float v;
  if (p.kind[i] == K_FWD)
    v = ld(x, q + s) - ld(x, q);
  else if (p.kind[i] == K_BWD)
    v = ld(x, q) - ld(x, q - s);
  else
    v = ld(x, q + s) - ld(x, q - s);
  if (p.axis[i] == AX_T) v = v * tm;
  v = v * p.w[i];
  if (p.norm == N_ANISO) return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
  const float n = norms[q];
  return v / (p.norm == N_HUBER ? fmaxf(n, p.huber_delta) : n);
}

// Pass 2: G at every voxel from x and the pass-1 norms (unused for aniso).
template <typename TX>
__global__ void __launch_bounds__(BLOCK)
tv_subgrad_kernel(const Params p, const TX* __restrict__ x,
                  const float* __restrict__ norms,
                  const float* __restrict__ tmul, TX* __restrict__ g) {
  const int64_t plane = (int64_t)p.Nr * p.Nc;
  const int zt = blockIdx.y;
  const int64_t pix = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  if (pix >= plane) return;
  const int z = zt / p.M, t = zt - z * p.M;
  const int r = (int)(pix / p.Nc), c = (int)(pix - (int64_t)r * p.Nc);
  const int64_t xi = (int64_t)zt * plane + pix;
  const float tm = p.has_tmul ? tmul[pix] : 1.f;
  const bool iso = p.norm == N_ISO;

  // the adjoint scatter of each channel read at this voxel
  // (ops/operators.py::dt_channel): only valid slots are read
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_CH; ++i) {
    if (i < p.Nd) {
      int pos, len;
      int64_t s;
      axis_geom(p, p.axis[i], z, t, r, c, 1, pos, len, s);
      float lo, hi;
      if (p.kind[i] == K_FWD) {         // slots [0, L-2]
        lo = pos >= 1 ? chan_y(p, i, x, norms, xi - s, s, tm) : 0.f;
        hi = pos <= len - 2 ? chan_y(p, i, x, norms, xi, s, tm) : 0.f;
      } else if (p.kind[i] == K_BWD) {  // slots [1, L-1]
        lo = pos >= 1 ? chan_y(p, i, x, norms, xi, s, tm) : 0.f;
        hi = pos <= len - 2 ? chan_y(p, i, x, norms, xi + s, s, tm) : 0.f;
      } else {                          // slots [1, L-2]
        lo = pos >= 2 ? chan_y(p, i, x, norms, xi - s, s, tm) : 0.f;
        hi = pos <= len - 3 ? chan_y(p, i, x, norms, xi + s, s, tm) : 0.f;
      }
      float v = lo - hi;
      if (!iso) {  // aniso / huber re-apply the full weight, like D^T
        v = v * p.w[i];
        if (p.axis[i] == AX_T) v = v * tm;
      }
      acc += v;
    }
  }
  // iso: the y values carry one normalisation inside w, this is the second
  st(g, xi, iso ? acc * p.scheme_norm : acc);
}

template <typename TX>
static int launch_norms(const Params* p, const void* x, const void* tmul,
                        void* norms, void* parts, cudaStream_t stream) {
  tv_norms_kernel<TX><<<plane_grid(p), BLOCK, 0, stream>>>(
      *p, (const TX*)x, (const float*)tmul, (float*)norms, (float*)parts);
  return (int)cudaGetLastError();
}

template <typename TX>
static int launch_subgrad(const Params* p, const void* x, const void* norms,
                          const void* tmul, void* g, cudaStream_t stream) {
  tv_subgrad_kernel<TX><<<plane_grid(p), BLOCK, 0, stream>>>(
      *p, (const TX*)x, (const float*)norms, (const float*)tmul, (TX*)g);
  return (int)cudaGetLastError();
}

extern "C" {

// Number of TV partials pass 1 writes for an (Nz, M, Nr, Nc) volume.
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

const char* tv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
