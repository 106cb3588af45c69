// The per-voxel bodies of the stencil passes: CP pass A (fidelity dual, TV
// dual prox), CP pass B (primal update), TV pass 1 (norms) and TV pass 2
// (subgradient).  The whole-solve kernels of csrc/resident.cu (B9 in L2)
// call these functions; the kernels specialised per channel table
// (csrc/specialised.cuh), every per-launch kernel among them, repeat their
// arithmetic in the same order, so they round alike (every source is built
// with -fmad=false, as the plain PyTorch versions round).
//
// The pointers carry neither const-ness beyond what the pass needs nor
// __restrict__: the whole-solve kernels read, after a barrier, what other
// blocks wrote.  The per-launch kernels declare __restrict__ on their own
// parameters.
//
// Layouts as in stencil.cuh: x, x0, y_A, the norms and G are (Nz, M, Nr, Nc);
// the TV dual y_D is channel-contiguous (Nz, M, Nd, Nr, Nc).  These bodies
// serve unsharded volumes only (csrc/resident.cu); the sharded modes of
// every pass are csrc/specialised*.cu's, which address a shard's extended
// operands through ext_plane below.

#pragma once

#include "stencil.cuh"

// One voxel (z, t, r, c): its offset xi in the x-like arrays, the offset yb
// of its channel 0 in the dual, the plane size and the time-channel
// multiplier at its pixel.
struct Vox {
  int z, t, r, c;
  int64_t plane, xi, yb;
  float tm;
};

// Offset of plane (z, t) of a shard's (Nz, M) planes in an array extended by
// e planes per side in z and t, in planes.
__device__ __forceinline__ int64_t ext_plane(const Params& p, int z, int t,
                                             int e) {
  return (int64_t)(z + e) * (p.M + 2 * e) + (t + e);
}

// The voxel at pixel `pix` of plane zt = z * M + t; tmul is read only when
// p.has_tmul.  I is the pixel index's type: int64_t, or int where the caller
// knows the volume is small (its divisions are cheaper).
template <typename I>
__device__ __forceinline__ Vox make_vox(const Params& p, int zt, I pix,
                                        const float* tmul) {
  Vox v;
  v.plane = (int64_t)p.Nr * p.Nc;
  v.z = zt / p.M;
  v.t = zt - v.z * p.M;
  v.r = (int)(pix / p.Nc);
  v.c = (int)(pix - (I)v.r * p.Nc);
  v.xi = (int64_t)zt * v.plane + pix;
  v.yb = (int64_t)zt * p.Nd * v.plane + pix;
  v.tm = p.has_tmul ? tmul[pix] : 1.f;
  return v;
}

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

// The TV half of pass A at one voxel: from the weighted channels d of D x,
// y_D' = prox(y_D + sigma_D d) in place at dual offset yb (aniso: the
// [-reg, reg] box; iso: the reg ball; huber: shrink, then the ball), and the
// return value is the voxel's term of the TV value of D x.
template <typename TD>
__device__ __forceinline__ float tv_dual_prox(const Params& p,
                                              const float (&d)[MAX_CH],
                                              TD* yD, int64_t yb,
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

// Pass A at one voxel whose value xc the caller has loaded: y_A' = fid prox
// and y_D' = TV dual prox of y_D + sigma_D D x, both in place; returns the
// voxel's TV term of D x.  With ZREG the z neighbours are xzm and xzp
// (weighted_d).
template <bool ZREG, typename TX, typename TD>
__device__ __forceinline__ float cp_dual_voxel(const Params& p, const Vox& v,
                                               const TX* x, const TX* x0,
                                               TX* yA, TD* yD, float xc,
                                               float xzm = 0.f,
                                               float xzp = 0.f) {
  st(yA, v.xi, fid_dual(p, ld(yA, v.xi), xc, ld(x0, v.xi)));
  float d[MAX_CH];
  weighted_d<ZREG>(p, x, v.xi, xc, v.z, v.t, v.r, v.c, v.tm, d, xzm, xzp);
  return tv_dual_prox(p, d, yD, v.yb, v.plane);
}

// Pass B at one voxel: x' = x - tau y_A' - tau D^T y_D' (then max(x', 0) when
// nonneg) stored to `out` (which may be x: the voxel reads x only at itself);
// returns the fidelity term of x' without the weight.  The adjoint is the
// exact scatter of each channel read at this voxel
// (ops/operators.py::dt_channel): only valid stencil slots are read.
template <typename TX, typename TD>
__device__ __forceinline__ float cp_primal_voxel(
    const Params& p, const Vox& v, const TX* x, const TX* x0, const TX* yA,
    const TD* yD, TX* out) {
  float corr = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_CH; ++i) {
    if (i < p.Nd) {
      int pos, len;
      int64_t s;
      axis_geom(p, p.axis[i], v.z, v.t, v.r, v.c, p.Nd, pos, len, s);
      const int64_t yi = v.yb + i * v.plane;
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
      float w = (lo - hi) * p.w[i];
      if (p.axis[i] == AX_T) w = w * v.tm;
      corr += w;
    }
  }
  float xn = ld(x, v.xi) - p.tau * ld(yA, v.xi) - p.tau * corr;
  if (p.nonneg) xn = fmaxf(xn, 0.f);
  const float x0v = ld(x0, v.xi);
  st(out, v.xi, xn);
  return fid_term(p, xn, x0v);
}

// TV pass 1 at one voxel: stores the gradient norm (iso: |D x|_2 with +inf
// where it is 0; aniso: the sum of |channels|; huber: the raw |D x|_2) and
// returns the voxel's TV term.
template <typename TX>
__device__ __forceinline__ float tv_norms_voxel(const Params& p, const Vox& v,
                                                const TX* x, float* norms) {
  float d[MAX_CH];
  weighted_d(p, x, v.xi, ld(x, v.xi), v.z, v.t, v.r, v.c, v.tm, d);
  if (p.norm == N_ANISO) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_CH; ++i)
      if (i < p.Nd) a += fabsf(d[i]);
    norms[v.xi] = a;
    return a;
  }
  float nsq = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_CH; ++i)
    if (i < p.Nd) nsq += d[i] * d[i];
  const float n = sqrtf(nsq);
  if (p.norm == N_HUBER) {
    norms[v.xi] = n;
    return n <= p.huber_delta ? (n * n) / (2.f * p.huber_delta)
                              : n - p.huber_delta / 2.f;
  }
  // the TV sum is taken before the +inf replacement
  norms[v.xi] = n == 0.f ? __int_as_float(0x7f800000) : n;
  return n;
}

// Channel i's value y at slot q of its axis (q a valid slot, so every read
// below is inside the volume): the weighted difference dv of x there, then
// sign(dv) for aniso, dv / n(q) for iso (n = +inf gives 0) and
// dv / max(n(q), delta) for huber.  q and s are the slot's offset and the
// axis's stride in x and in the norms, which share its layout.
template <typename TX>
__device__ __forceinline__ float chan_y(const Params& p, int i, const TX* x,
                                        const float* norms, int64_t q,
                                        int64_t s, float tm) {
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

// TV pass 2 at one voxel: G from x and the pass-1 norms (not read for
// aniso).  It needs each channel's y at its own slot and at the +-1
// neighbour slots the adjoint reads, and recomputes a neighbour's y from x
// there, so it reads x out to +-2 and the norms out to +-1 along each axis.
// A neighbour slot that is invalid for its channel is never read.
template <typename TX>
__device__ __forceinline__ float tv_subgrad_voxel(const Params& p,
                                                  const Vox& v, const TX* x,
                                                  const float* norms) {
  const bool iso = p.norm == N_ISO;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_CH; ++i) {
    if (i < p.Nd) {
      int pos, len;
      int64_t s;
      axis_geom(p, p.axis[i], v.z, v.t, v.r, v.c, 1, pos, len, s);
      const int64_t q = v.xi;
      float lo, hi;
      if (p.kind[i] == K_FWD) {         // slots [0, L-2]
        lo = pos >= 1 ? chan_y(p, i, x, norms, q - s, s, v.tm) : 0.f;
        hi = pos <= len - 2 ? chan_y(p, i, x, norms, q, s, v.tm) : 0.f;
      } else if (p.kind[i] == K_BWD) {  // slots [1, L-1]
        lo = pos >= 1 ? chan_y(p, i, x, norms, q, s, v.tm) : 0.f;
        hi = pos <= len - 2 ? chan_y(p, i, x, norms, q + s, s, v.tm) : 0.f;
      } else {                          // slots [1, L-2]
        lo = pos >= 2 ? chan_y(p, i, x, norms, q - s, s, v.tm) : 0.f;
        hi = pos <= len - 3 ? chan_y(p, i, x, norms, q + s, s, v.tm) : 0.f;
      }
      float w = lo - hi;
      if (!iso) {  // aniso / huber re-apply the full weight, like D^T
        w = w * p.w[i];
        if (p.axis[i] == AX_T) w = w * v.tm;
      }
      acc += w;
    }
  }
  // iso: the y values carry one normalisation inside w, this is the second
  return iso ? acc * p.scheme_norm : acc;
}
