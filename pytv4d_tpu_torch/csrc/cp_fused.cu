// Chambolle-Pock TV step for NVIDIA Hopper (sm_90a): pass A (dual), its
// variant for inverse problems, and pass B (primal), bound to Python through
// a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernels of pytv4d_tpu/kernels/fused.py:
//   cp_dual_kernel   <- make_cp_dual_kernel   (pass A, fused.py:652)
//   tv_dual_kernel   <- make_tv_dual_kernel   (pass A without the fidelity
//                                              dual, fused.py:759)
//   cp_primal_kernel <- make_cp_primal_kernel (pass B, fused.py:859)
// The denoising contract is cp_step_fused_internal (fused.py:1303): for
// (x, y_A, y_D, x0) the pair returns (x', y_A', y_D', loss) with
// loss = sum(fid parts of x') + reg * sum(TV parts of D x_old).  For an
// inverse problem min F(A x) + reg TV(x) (solvers/inverse.py) the fidelity
// dual lives in the measurement space and is updated outside: tv_dual_kernel
// takes (x_bar, y_D) to (y_D', TV parts of D x_bar) and touches no x0 or
// y_A, and pass B runs with A^T y_A in its y_A slot, writing x' to a second
// buffer because the solver still needs x for x_bar' = 2 x' - x.  The TPU
// kernel's third output, dt_local (the in-tile part of D^T y_D'), is dropped
// as in pass A: pass B computes the full adjoint.
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
// (z, t) plane; blockIdx.y is the plane (stencil.cuh).  Each thread gates its
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

#include "stencil.cuh"

// Fidelity conjugate prox, A = I (solvers/fidelity.py::fidelity_dual_prox).
__device__ __forceinline__ float fid_dual(const Params& p, float ya, float x,
                                          float x0) {
  if (p.fidelity == F_L1)
    return fminf(fmaxf(ya + p.sigma_A * (x - x0), -p.fid_weight), p.fid_weight);
  if (p.fidelity == F_KL) {
    const float q = ya + p.sigma_A * x;
    const float s = q - p.fid_weight;
    return 0.5f * (q + p.fid_weight - sqrtf(s * s + p.kl_c * x0));
  }
  return (ya + p.sigma_A * (x - x0)) / p.fid_den;
}

// Per-voxel fidelity loss term without the weight (fidelity_loss).
__device__ __forceinline__ float fid_term(const Params& p, float x, float x0) {
  const float diff = x - x0;
  if (p.fidelity == F_L1) return fabsf(diff);
  if (p.fidelity == F_KL) {
    const float ax = fmaxf(x, 1e-30f);
    const float ent = x0 > 0.f ? x0 * logf(fmaxf(x0, 1e-30f) / ax) : 0.f;
    return diff + ent;
  }
  return diff * diff;
}

// The TV half of pass A at one voxel, shared by cp_dual_kernel and
// tv_dual_kernel so both round identically: from the weighted channels d of
// D x, y_D' = prox(y_D + sigma_D d) in place at dual offset yb (aniso: the
// [-reg, reg] box; iso: the reg ball; huber: shrink, then the ball), and the
// return value is the voxel's term of the TV value of D x.
template <typename TD>
__device__ __forceinline__ float tv_dual_prox(const Params& p,
                                              const float (&d)[MAX_CH],
                                              TD* __restrict__ yD, int64_t yb,
                                              int64_t plane) {
  float part = 0.f;
  if (p.norm == N_ANISO) {
#pragma unroll
    for (int i = 0; i < MAX_CH; ++i) {
      if (i < p.Nd) {
        part += fabsf(d[i]);
        const float pv = ld(yD, yb + i * plane) + p.sigma_D * d[i];
        st(yD, yb + i * plane, fminf(fmaxf(pv, -p.reg), p.reg));
      }
    }
    return part;
  }
  float nsq = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_CH; ++i)
    if (i < p.Nd) nsq += d[i] * d[i];
  const float n = sqrtf(nsq);
  if (p.norm == N_HUBER)
    part = n <= p.huber_delta ? (n * n) / (2.f * p.huber_delta)
                              : n - p.huber_delta / 2.f;
  else
    part = n;
  float pv[MAX_CH];
  float psq = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_CH; ++i) {
    pv[i] = 0.f;
    if (i < p.Nd) {
      pv[i] = ld(yD, yb + i * plane) + p.sigma_D * d[i];
      if (p.norm == N_HUBER) pv[i] = pv[i] / p.huber_den;
      psq += pv[i] * pv[i];
    }
  }
  const float den = fmaxf(sqrtf(psq) / p.reg, 1.f);
#pragma unroll
  for (int i = 0; i < MAX_CH; ++i)
    if (i < p.Nd) st(yD, yb + i * plane, pv[i] / den);
  return part;
}

// Pass A: y_A' = fid prox, y_D' = TV dual prox of y_D + sigma_D D x, and one
// TV partial of D x per block.
template <typename TX, typename TD>
__global__ void __launch_bounds__(BLOCK)
cp_dual_kernel(const Params p, const TX* __restrict__ x,
               const TX* __restrict__ x0, TX* __restrict__ yA,
               TD* __restrict__ yD, const float* __restrict__ tmul,
               float* __restrict__ parts) {
  const int64_t plane = (int64_t)p.Nr * p.Nc;
  const int zt = blockIdx.y;
  const int64_t pix = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  float part = 0.f;
  if (pix < plane) {
    const int z = zt / p.M, t = zt - z * p.M;
    const int r = (int)(pix / p.Nc), c = (int)(pix - (int64_t)r * p.Nc);
    const int64_t xi = (int64_t)zt * plane + pix;
    const float xc = ld(x, xi);
    st(yA, xi, fid_dual(p, ld(yA, xi), xc, ld(x0, xi)));
    const float tm = p.has_tmul ? tmul[pix] : 1.f;

    float d[MAX_CH];
    weighted_d(p, x, xi, xc, z, t, r, c, tm, d);

    part = tv_dual_prox(p, d, yD, (int64_t)zt * p.Nd * plane + pix, plane);
  }
  const float s = block_sum(part);
  if (threadIdx.x == 0) parts[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// Pass A for inverse problems: y_D' = TV dual prox of y_D + sigma_D D x_bar
// and one TV partial of D x_bar per block; no fidelity dual, no x0, no y_A,
// no time-plane multiplier.
template <typename TX, typename TD>
__global__ void __launch_bounds__(BLOCK)
tv_dual_kernel(const Params p, const TX* __restrict__ x,
               TD* __restrict__ yD, float* __restrict__ parts) {
  const int64_t plane = (int64_t)p.Nr * p.Nc;
  const int zt = blockIdx.y;
  const int64_t pix = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  float part = 0.f;
  if (pix < plane) {
    const int z = zt / p.M, t = zt - z * p.M;
    const int r = (int)(pix / p.Nc), c = (int)(pix - (int64_t)r * p.Nc);
    const int64_t xi = (int64_t)zt * plane + pix;
    float d[MAX_CH];
    weighted_d(p, x, xi, ld(x, xi), z, t, r, c, 1.f, d);
    part = tv_dual_prox(p, d, yD, (int64_t)zt * p.Nd * plane + pix, plane);
  }
  const float s = block_sum(part);
  if (threadIdx.x == 0) parts[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// Pass B: x' = x - tau y_A' - tau D^T y_D' (then max(x', 0) when nonneg), and
// one fidelity partial of x' per block.  x' goes to `out`, which is x itself
// (in place) or a second buffer; x0 may be x (the inverse solver discards the
// partial), so none of the three is __restrict__.
template <typename TX, typename TD>
__global__ void __launch_bounds__(BLOCK)
cp_primal_kernel(const Params p, const TX* x, const TX* x0,
                 const TX* __restrict__ yA, const TD* __restrict__ yD,
                 const float* __restrict__ tmul, TX* out,
                 float* __restrict__ parts) {
  const int64_t plane = (int64_t)p.Nr * p.Nc;
  const int zt = blockIdx.y;
  const int64_t pix = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  float part = 0.f;
  if (pix < plane) {
    const int z = zt / p.M, t = zt - z * p.M;
    const int r = (int)(pix / p.Nc), c = (int)(pix - (int64_t)r * p.Nc);
    const float tm = p.has_tmul ? tmul[pix] : 1.f;
    const int64_t yb = (int64_t)zt * p.Nd * plane + pix;

    // exact adjoint scatter of each channel, read at this pixel
    // (ops/operators.py::dt_channel): only valid stencil slots are read
    float corr = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_CH; ++i) {
      if (i < p.Nd) {
        int pos, len;
        int64_t s;
        axis_geom(p, p.axis[i], z, t, r, c, p.Nd, pos, len, s);
        const int64_t yi = yb + i * plane;
        float lo, hi;
        if (p.kind[i] == K_FWD) {         // slots [0, L-2]
          lo = pos >= 1 ? ld(yD, yi - s) : 0.f;
          hi = pos <= len - 2 ? ld(yD, yi) : 0.f;
        } else if (p.kind[i] == K_BWD) {  // slots [1, L-1]
          lo = pos >= 1 ? ld(yD, yi) : 0.f;
          hi = pos <= len - 2 ? ld(yD, yi + s) : 0.f;
        } else {                          // slots [1, L-2]
          lo = pos >= 2 ? ld(yD, yi - s) : 0.f;
          hi = pos <= len - 3 ? ld(yD, yi + s) : 0.f;
        }
        float v = (lo - hi) * p.w[i];
        if (p.axis[i] == AX_T) v = v * tm;
        corr += v;
      }
    }
    const int64_t xi = (int64_t)zt * plane + pix;
    float xn = ld(x, xi) - p.tau * ld(yA, xi) - p.tau * corr;
    if (p.nonneg) xn = fmaxf(xn, 0.f);
    const float x0v = ld(x0, xi);
    st(out, xi, xn);
    part = fid_term(p, xn, x0v);
  }
  const float s = block_sum(part);
  if (threadIdx.x == 0)
    parts[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = p.fid_scale * s;
}

template <typename TX, typename TD>
static int launch_dual(const Params* p, const void* x, const void* x0,
                       void* yA, void* yD, const void* tmul, void* parts,
                       cudaStream_t stream) {
  cp_dual_kernel<TX, TD><<<plane_grid(p), BLOCK, 0, stream>>>(
      *p, (const TX*)x, (const TX*)x0, (TX*)yA, (TD*)yD, (const float*)tmul,
      (float*)parts);
  return (int)cudaGetLastError();
}

template <typename TX, typename TD>
static int launch_tv_dual(const Params* p, const void* x, void* yD,
                          void* parts, cudaStream_t stream) {
  tv_dual_kernel<TX, TD><<<plane_grid(p), BLOCK, 0, stream>>>(
      *p, (const TX*)x, (TD*)yD, (float*)parts);
  return (int)cudaGetLastError();
}

template <typename TX, typename TD>
static int launch_primal(const Params* p, const void* x, const void* x0,
                         const void* yA, const void* yD, const void* tmul,
                         void* out, void* parts, cudaStream_t stream) {
  cp_primal_kernel<TX, TD><<<plane_grid(p), BLOCK, 0, stream>>>(
      *p, (const TX*)x, (const TX*)x0, (const TX*)yA, (const TD*)yD,
      (const float*)tmul, (TX*)out, (float*)parts);
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

int tv_dual_launch(const Params* p, int x_bf16, int d_bf16, const void* x,
                   void* yD, void* parts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!x_bf16 && !d_bf16)
    return launch_tv_dual<float, float>(p, x, yD, parts, s);
  if (!x_bf16) return launch_tv_dual<float, __nv_bfloat16>(p, x, yD, parts, s);
  if (!d_bf16) return launch_tv_dual<__nv_bfloat16, float>(p, x, yD, parts, s);
  return launch_tv_dual<__nv_bfloat16, __nv_bfloat16>(p, x, yD, parts, s);
}

// `out` receives x': x itself for the in-place step, or a second buffer.
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
