// Device code shared by the TGV-2 kernels of csrc/tgv_stream.cu (passes PQ and
// XW, one launch each per iteration, and the objective, one launch a loss),
// csrc/tgv_resident.cu (the whole 2d solve in one launch, state in global
// memory) and csrc/tgv_onchip.cu (the whole 2d solve with each slice's state
// in its cluster's shared memory): the
// launch parameter struct, the geometry of a voxel, and the per-voxel
// arithmetic of the dual pass, the primal pass and the objective.  All three
// sources run exactly this arithmetic, so the whole-solve kernels and a loop
// over the streaming kernels give the same iterates.
//
// One Chambolle-Pock iteration of
//   min_{x,w} 1/2 |x - x0|^2 + a1 |D x - w| + a0 |E w|
// (pytv4d_tpu/solvers/tgv.py:458-476) at a voxel, for a mode with N fields
// (2d: row, col; 3d: z, row, col; 4d: z, t, row, col):
//   p_i' = proj_a1(p_i + sigma (fwd_i(xb) - wb_i))
//   q_c' = proj_a0(q_c + sigma E_c(wb)),  E_ii = bwd_i(wb_i),
//                                          E_ij = (bwd_j(wb_i) + bwd_i(wb_j))/2
//   x'   = (x - tau sum_i fwd_i^T(p_i') + tau x0) / (1 + tau),  xb' = 2x' - x
//   w_i' = w_i - tau (-p_i' + (E^T q')_i),                      wb_i' = 2w_i' - w_i
// with the one-sided zero boundary of stencil.cuh: fwd is 0 at an axis's last
// slot, bwd at its first, and their adjoints never read those slots.
//
// The bodies (tgv_pq_at, tgv_xw_at, tgv_loss_at) take the state through an
// accessor V, which says where a value lives:
//   v.at(a, ch)         array a, channel ch, at the voxel
//   v.fwd(a, ch, ax)    the same at +1 along volume axis ax (caller gates)
//   v.bwd(a, ch, ax)    the same at -1 along ax
//   v.set(a, ch, val)   store at the voxel
//   v.not_first(ax), v.not_last(ax)   the boundary gates
// GlobalTgv reads the arrays in global memory (B6, and B7 in L2); the
// on-chip B7 has its own accessor over a shared-memory band.  Where a value
// comes from changes no float operation, so the accessors give the same bits.
//
// Layouts (row-major): x, xb, x0 are (Nz, M, Nr, Nc); w, wb, p are
// (Nz, N, M, Nr, Nc); q is (Nz, N(N+1)/2, M, Nr, Nc) with the diagonals first,
// then the pairs (i, j), i < j.  Storage float or bf16, compute float.

#pragma once

#include "stencil.cuh"

// Mirrored field for field by kernels/tgv_stream.py::TGVParams.
struct TgvParams {
  int Nz, M, Nr, Nc;
  int norm;            // N_*
  float sigma, tau;
  float one_plus_tau;  // the divisor of the x update
  float a1, a0;        // projection radii of p and q
  float shr1, shr0;    // huber: 1 / (1 + sigma delta / a)
  float delta;         // huber threshold of the objective
};

// The volume axis that field i of an N-field mode differences.
template <int N>
__host__ __device__ __forceinline__ constexpr int mode_axis(int i) {
  return N == 4 ? i : (N == 3 ? (i == 0 ? AX_Z : i + 1) : i + 2);
}

// A voxel (z, t, r, c): its position and the length along each volume axis,
// and what its index in a C-channel array is made of.
struct Geo {
  int pos[4], len[4];
  int z, Nc;
  int64_t plane;  // Nr * Nc
  int64_t mp;     // M * plane: the channel stride of every array
  int64_t zt;     // t * plane + r * Nc + c
};

__device__ __forceinline__ Geo make_geo(const TgvParams& P, int z, int t,
                                        int64_t pix) {
  Geo g;
  // a plane holds fewer than 2^31 voxels (the wrappers check), so the row
  // and column come from one 32-bit division
  const int r = (int)((unsigned)pix / (unsigned)P.Nc);
  const int c = (int)pix - r * P.Nc;
  g.pos[AX_Z] = z; g.pos[AX_T] = t; g.pos[AX_ROW] = r; g.pos[AX_COL] = c;
  g.len[AX_Z] = P.Nz; g.len[AX_T] = P.M; g.len[AX_ROW] = P.Nr;
  g.len[AX_COL] = P.Nc;
  g.z = z; g.Nc = P.Nc;
  g.plane = (int64_t)P.Nr * P.Nc;
  g.mp = (int64_t)P.M * g.plane;
  g.zt = (int64_t)t * g.plane + pix;
  return g;
}

// Index of channel 0 at the voxel in an array of C channels (C = 1: x-like).
__device__ __forceinline__ int64_t base_of(const Geo& g, int C) {
  return (int64_t)g.z * C * g.mp + g.zt;
}

// Element stride of volume axis a in an array of C channels.
__device__ __forceinline__ int64_t stride_of(const Geo& g, int a, int C) {
  return a == AX_Z ? (int64_t)C * g.mp
                   : (a == AX_T ? g.plane : (a == AX_ROW ? (int64_t)g.Nc : 1));
}

__device__ __forceinline__ bool not_first(const Geo& g, int a) {
  return g.pos[a] > 0;
}
__device__ __forceinline__ bool not_last(const Geo& g, int a) {
  return g.pos[a] < g.len[a] - 1;
}

// The arrays a body names to its accessor.
enum { TV_X = 0, TV_XB, TV_X0, TV_W, TV_WB, TV_P, TV_Q };

// Accessor over the arrays in global memory, in the public layouts, at the
// voxel g.  A pointer the body does not use may be null.  It holds g by
// reference and the voxel's three base indices, as the bodies computed
// them before the accessor: B6's code then times as it did, where a copy
// of g, or the indices recomputed at each access, made its bf16 passes
// slower (PERF.md section 6).
template <int N, typename T>
struct GlobalTgv {
  static constexpr int NQ = N * (N + 1) / 2;
  const Geo& g;
  const T *x, *xb, *x0, *w, *wb, *p, *q;
  int64_t xi, wi, qi;
  __device__ __forceinline__ GlobalTgv(const Geo& g_, const T* x_,
                                       const T* xb_, const T* x0_,
                                       const T* w_, const T* wb_,
                                       const T* p_, const T* q_)
      : g(g_), x(x_), xb(xb_), x0(x0_), w(w_), wb(wb_), p(p_), q(q_),
        xi(base_of(g_, 1)), wi(base_of(g_, N)), qi(base_of(g_, NQ)) {}
  __device__ __forceinline__ int64_t idx(int a, int ch) const {
    return a <= TV_X0 ? xi : (a == TV_Q ? qi : wi) + ch * g.mp;
  }

  __device__ __forceinline__ const T* arr(int a) const {
    return a == TV_X ? x : a == TV_XB ? xb : a == TV_X0 ? x0
         : a == TV_W ? w : a == TV_WB ? wb : a == TV_P ? p : q;
  }
  __device__ __forceinline__ int channels(int a) const {
    return a <= TV_X0 ? 1 : (a == TV_Q ? NQ : N);
  }
  __device__ __forceinline__ float at(int a, int ch) const {
    return ld(arr(a), idx(a, ch));
  }
  __device__ __forceinline__ float fwd(int a, int ch, int ax) const {
    return ld(arr(a), idx(a, ch) + stride_of(g, ax, channels(a)));
  }
  __device__ __forceinline__ float bwd(int a, int ch, int ax) const {
    return ld(arr(a), idx(a, ch) - stride_of(g, ax, channels(a)));
  }
  __device__ __forceinline__ void set(int a, int ch, float v) const {
    st(const_cast<T*>(arr(a)), idx(a, ch), v);
  }
  __device__ __forceinline__ bool not_first(int ax) const {
    return ::not_first(g, ax);
  }
  __device__ __forceinline__ bool not_last(int ax) const {
    return ::not_last(g, ax);
  }
};

// d[i] = fwd_i(a) at the voxel (0 at the last slot of axis i).
template <int N, class V>
__device__ __forceinline__ void fwd_grad(const V& v, int a, float (&d)[N]) {
  const float xc = v.at(a, 0);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int ax = mode_axis<N>(i);
    d[i] = v.not_last(ax) ? v.fwd(a, 0, ax) - xc : 0.f;
  }
}

// wc[i] = a_i at the voxel and e[c] = E_c(a): backward differences, 0 at the
// first slot of the differenced axis.
template <int N, class V>
__device__ __forceinline__ void sym_grad(const V& v, int a, float (&wc)[N],
                                         float (&e)[N * (N + 1) / 2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) wc[i] = v.at(a, i);
  // bwd[f][k]: field f differenced backward along the axis of field k
  float bwd[N][N];
#pragma unroll
  for (int f = 0; f < N; ++f) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int ax = mode_axis<N>(k);
      bwd[f][k] = v.not_first(ax) ? wc[f] - v.bwd(a, f, ax) : 0.f;
    }
  }
  int c = N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    e[i] = bwd[i][i];
#pragma unroll
    for (int j = i + 1; j < N; ++j) e[c++] = 0.5f * (bwd[i][j] + bwd[j][i]);
  }
}

// The dual prox over C channels: aniso clips to [-radius, radius]; huber
// shrinks first; iso and huber then scale by 1 / max(1, |c|_2 / radius).
template <int C>
__device__ __forceinline__ void project(float (&v)[C], int norm, float radius,
                                        float shrink) {
  if (norm == N_ANISO) {
#pragma unroll
    for (int i = 0; i < C; ++i) v[i] = fminf(fmaxf(v[i], -radius), radius);
    return;
  }
  if (norm == N_HUBER) {
#pragma unroll
    for (int i = 0; i < C; ++i) v[i] = v[i] * shrink;
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) s += v[i] * v[i];
  const float scale = 1.f / fmaxf(1.f, sqrtf(s) / radius);
#pragma unroll
  for (int i = 0; i < C; ++i) v[i] = v[i] * scale;
}

// Pass PQ at one voxel: p and q are updated in place (only the voxel's own
// p, q are read); xb is read at the voxel and +1 along each axis, wb at the
// voxel and -1 along each axis.
template <int N, class V>
__device__ __forceinline__ void tgv_pq_at(const TgvParams& P, const V& v) {
  constexpr int NQ = N * (N + 1) / 2;
  float d[N], wc[N], e[NQ];
  fwd_grad<N>(v, TV_XB, d);
  sym_grad<N>(v, TV_WB, wc, e);
#pragma unroll
  for (int i = 0; i < N; ++i)
    d[i] = v.at(TV_P, i) + P.sigma * (d[i] - wc[i]);
  project<N>(d, P.norm, P.a1, P.shr1);
#pragma unroll
  for (int i = 0; i < N; ++i) v.set(TV_P, i, d[i]);
#pragma unroll
  for (int c = 0; c < NQ; ++c) e[c] = v.at(TV_Q, c) + P.sigma * e[c];
  project<NQ>(e, P.norm, P.a0, P.shr0);
#pragma unroll
  for (int c = 0; c < NQ; ++c) v.set(TV_Q, c, e[c]);
}

// Adjoint of a backward difference along axis ax of channel c of q, read at
// the voxel (value qv): q[k] - q[k+1], the first slot's own term and the
// last slot's neighbour term dropped.
template <class V>
__device__ __forceinline__ float adj_bwd(const V& v, int c, float qv,
                                         int ax) {
  const float lo = v.not_first(ax) ? qv : 0.f;
  const float hi = v.not_last(ax) ? v.fwd(TV_Q, c, ax) : 0.f;
  return lo - hi;
}

// Pass XW at one voxel: x and w are updated in place, xb and wb written;
// p is read at the voxel and -1 along its own axis, q at the voxel and +1
// along its axes.  None of x, w, xb, wb is read as a neighbour.
template <int N, class V>
__device__ __forceinline__ void tgv_xw_at(const TgvParams& P, const V& v) {
  float pc[N];
  float dtp = 0.f;  // sum_i fwd_i^T(p_i): p[k-1] - p[k], last slot dropped
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int ax = mode_axis<N>(i);
    pc[i] = v.at(TV_P, i);
    const float lo = v.not_first(ax) ? v.bwd(TV_P, i, ax) : 0.f;
    const float hi = v.not_last(ax) ? pc[i] : 0.f;
    dtp += lo - hi;
  }
  const float xc = v.at(TV_X, 0);
  const float x_new = (xc - P.tau * dtp + P.tau * v.at(TV_X0, 0))
                      / P.one_plus_tau;
  v.set(TV_X, 0, x_new);
  v.set(TV_XB, 0, 2.f * x_new - xc);

  // (E^T q)_i: the diagonal channel of axis i along axis i, plus half of
  // every off-diagonal channel with i, differenced along the OTHER axis
  float etq[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    etq[i] = adj_bwd(v, i, v.at(TV_Q, i), mode_axis<N>(i));
  int c = N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      const float qv = v.at(TV_Q, c);
      etq[i] += 0.5f * adj_bwd(v, c, qv, mode_axis<N>(j));
      etq[j] += 0.5f * adj_bwd(v, c, qv, mode_axis<N>(i));
      ++c;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float wv = v.at(TV_W, i);
    const float w_new = wv - P.tau * (-pc[i] + etq[i]);
    v.set(TV_W, i, w_new);
    v.set(TV_WB, i, 2.f * w_new - wv);
  }
}

// The norm of C channels at a voxel, as the objective counts it.
template <int C>
__device__ __forceinline__ float norm_val(const float (&v)[C], int norm,
                                          float delta) {
  if (norm == N_ANISO) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i) a += fabsf(v[i]);
    return a;
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) s += v[i] * v[i];
  const float n = sqrtf(s);
  if (norm == N_HUBER)
    return n <= delta ? (n * n) / (2.f * delta) : n - delta / 2.f;
  return n;
}

// The voxel's term of 1/2 |x - x0|^2 + a1 |D x - w| + a0 |E w|; reads x at
// +1 and w at -1 along each axis.
template <int N, class V>
__device__ __forceinline__ float tgv_loss_at(const TgvParams& P,
                                             const V& v) {
  constexpr int NQ = N * (N + 1) / 2;
  float d[N], wc[N], e[NQ];
  fwd_grad<N>(v, TV_X, d);
  sym_grad<N>(v, TV_W, wc, e);
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = d[i] - wc[i];
  const float r = v.at(TV_X, 0) - v.at(TV_X0, 0);
  return 0.5f * (r * r) + P.a1 * norm_val<N>(d, P.norm, P.delta)
         + P.a0 * norm_val<NQ>(e, P.norm, P.delta);
}

// The bodies over the arrays in global memory, as csrc/tgv_stream.cu and
// csrc/tgv_resident.cu call them.
template <int N, typename T>
__device__ __forceinline__ void tgv_pq_voxel(const TgvParams& P, const Geo& g,
                                             const T* xb, const T* wb, T* p,
                                             T* q) {
  tgv_pq_at<N>(P, GlobalTgv<N, T>(g, nullptr, xb, nullptr, nullptr, wb, p,
                                  q));
}

template <int N, typename T>
__device__ __forceinline__ void tgv_xw_voxel(const TgvParams& P, const Geo& g,
                                             T* x, const T* x0, const T* p,
                                             T* w, const T* q, T* xb, T* wb) {
  tgv_xw_at<N>(P, GlobalTgv<N, T>(g, x, xb, x0, w, wb, p, q));
}

template <int N, typename T>
__device__ __forceinline__ float tgv_loss_voxel(const TgvParams& P,
                                                const Geo& g, const T* x,
                                                const T* x0, const T* w) {
  return tgv_loss_at<N>(P, GlobalTgv<N, T>(g, x, nullptr, x0, w, nullptr,
                                           nullptr, nullptr));
}
