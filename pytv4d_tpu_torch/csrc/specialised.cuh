// Device code of the kernels specialised per channel table (csrc/tables.cuh)
// that csrc/specialised.cu (B1, B2, B4), csrc/specialised_tv.cu (B3, B5),
// csrc/specialised_cp.cu (B1, B2 on a shard) and csrc/cp_boundary.cu (B8)
// share: runs of V consecutive columns in one
// access, the weighted D channels of one voxel from the neighbours a kernel
// gathered, the body of pass A (the TV dual prox, with the fidelity dual for
// B1 and B8 and without it for B5) and the body of pass B (B2, B8).  Both
// bodies take from their caller the plane they work on, the
// planes at z - 1 and z + 1, and the z and t gates, so that one body serves
// an unsharded volume, a shard's edge plane, whose neighbour across the edge
// is an exchanged halo plane, and every plane of a shard whose operands are
// extended by neighbour or ghost planes (csrc/specialised_cp.cu).
//
// Every function here repeats the arithmetic of the generic bodies of
// voxel.cuh (weighted_d, tv_dual_prox, fid_dual, tv_norms_voxel,
// cp_primal_voxel) operation for operation and in the same order, so that,
// built with -fmad=false as every source is, the specialised kernels give
// the generic ones' bits.

#pragma once

#include "tables.cuh"
#include "voxel.cuh"

typedef int Offset;  // from a plane's base pointer: a plane holds < 2^31
                     // voxels (kernels/fused.py::fits_kernel)

static inline bool aligned(const void* ptr, size_t bytes) {
  return (uintptr_t)ptr % bytes == 0;
}

// ------------------------------------------------- runs of V elements
// One access of V = 2 or 4 elements: 8 or 16 bytes of f32, 4 or 8 of bf16
// (bf16 is the high half of a float: widening is a shift, as in
// __bfloat162float).
template <int V>
__device__ __forceinline__ void ld_vec(const float* p, float (&v)[V]) {
  static_assert(V == 2 || V == 4, "runs of 2 or 4 columns");
  if constexpr (V == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
}
template <int V>
__device__ __forceinline__ void ld_vec(const __nv_bfloat16* p,
                                       float (&v)[V]) {
  static_assert(V == 2 || V == 4, "runs of 2 or 4 columns");
  unsigned a[V / 2];
  if constexpr (V == 2) {
    a[0] = *reinterpret_cast<const unsigned*>(p);
  } else {
    const uint2 b = *reinterpret_cast<const uint2*>(p);
    a[0] = b.x;
    a[1] = b.y;
  }
#pragma unroll
  for (int j = 0; j < V / 2; ++j) {
    v[2 * j] = __uint_as_float(a[j] << 16);
    v[2 * j + 1] = __uint_as_float(a[j] & 0xffff0000u);
  }
}
template <int V>
__device__ __forceinline__ void st_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
template <int V>
__device__ __forceinline__ void st_vec(__nv_bfloat16* p,
                                       const float (&v)[V]) {
  const unsigned a = bf16_bits(v[0]) | bf16_bits(v[1]) << 16;
  if constexpr (V == 2)
    *reinterpret_cast<unsigned*>(p) = a;
  else
    *reinterpret_cast<uint2*>(p) =
        make_uint2(a, bf16_bits(v[2]) | bf16_bits(v[3]) << 16);
}

// The n <= V elements from p: one vector access where `vec` (every run the
// launch touches is whole and aligned), else one element at a time, zeros
// past n.
template <int V, typename T>
__device__ __forceinline__ void load_run(const T* p, bool vec, int n,
                                         float (&v)[V]) {
  if (vec) {
    ld_vec(p, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = j < n ? ld(p, j) : 0.f;
}
template <int V, typename T>
__device__ __forceinline__ void store_run(T* p, bool vec, int n,
                                          const float (&v)[V]) {
  if (vec) {
    st_vec(p, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (j < n) st(p, j, v[j]);
}
// A neighbour run: loaded where it lies in the volume (`ok`), else zeros.
template <int V, typename T>
__device__ __forceinline__ void load_nb(const T* p, bool ok, bool vec, int n,
                                        float (&v)[V]) {
  if (ok) {
    load_run(p, vec, n, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = 0.f;
}

// Whether a channel of T reads the neighbour at -1 (BWD, CTR) or at +1
// (FWD, CTR) along axis a.
__host__ __device__ constexpr bool tab_lo(Table t, int a) {
  return tab_has(t, a, K_BWD) || tab_has(t, a, K_CTR);
}
__host__ __device__ constexpr bool tab_hi(Table t, int a) {
  return tab_has(t, a, K_FWD) || tab_has(t, a, K_CTR);
}

// ------------------------------------------------------ one voxel
// weighted_d at one voxel: per axis its position and length and x at -1
// and +1 (xc between; zeros where no channel reads them), tm the time
// channels' multiplier.  x[q+s] - x[q] is FWD's difference at q, x[q] -
// x[q-s] BWD's, x[q+s] - x[q-s] CTR's; a table has at most one channel of
// each (axis, kind), so each difference is formed once.
template <Table T>
__device__ __forceinline__ void spec_d(const Params& p, const int (&pos)[4],
                                       const int (&len)[4], float xc,
                                       const float (&xm)[4],
                                       const float (&xp)[4], float tm,
                                       float (&d)[tab_nd(T)]) {
#pragma unroll
  for (int i = 0; i < tab_nd(T); ++i) {
    const int a = tab_axis(T, i), kd = tab_kind(T, i);
    const int ps = pos[a], ln = len[a];
    float v;
    if (kd == K_FWD)
      v = ps < ln - 1 ? xp[a] - xc : 0.f;
    else if (kd == K_BWD)
      v = ps > 0 ? xc - xm[a] : 0.f;
    else
      v = (ps > 0 && ps < ln - 1) ? xp[a] - xm[a] : 0.f;
    if (a == AX_T) v = v * tm;
    d[i] = v * p.w[i];
  }
}

// tv_norms_voxel's norm from the channels d: stored to `out` (iso: +inf
// where it is 0), and the voxel's TV term returned.
template <Table T>
__device__ __forceinline__ float spec_norm(const Params& p,
                                           const float (&d)[tab_nd(T)],
                                           float& out) {
  if (p.norm == N_ANISO) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < tab_nd(T); ++i) a += fabsf(d[i]);
    out = a;
    return a;
  }
  float nsq = 0.f;
#pragma unroll
  for (int i = 0; i < tab_nd(T); ++i) nsq += d[i] * d[i];
  const float n = sqrtf(nsq);
  if (p.norm == N_HUBER) {
    out = n;
    return n <= p.huber_delta ? (n * n) / (2.f * p.huber_delta)
                              : n - p.huber_delta / 2.f;
  }
  // the TV sum is taken before the +inf replacement
  out = n == 0.f ? __int_as_float(0x7f800000) : n;
  return n;
}

// tv_dual_prox at one voxel from its channels d: y = prox(y + sigma_D d) in
// place (aniso: the [-reg, reg] box; iso: the reg ball; huber: shrink, then
// the ball), and the voxel's TV term of D x returned.
template <Table T>
__device__ __forceinline__ float spec_dual_prox(const Params& p,
                                                const float (&d)[tab_nd(T)],
                                                float (&y)[tab_nd(T)]) {
  constexpr int ND = tab_nd(T);
  float pj = 0.f;
  if (p.norm == N_ANISO) {
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      pj += fabsf(d[i]);
      const float pv = y[i] + p.sigma_D * d[i];
      y[i] = fminf(fmaxf(pv, -p.reg), p.reg);
    }
    return pj;
  }
  float nsq = 0.f;
#pragma unroll
  for (int i = 0; i < ND; ++i) nsq += d[i] * d[i];
  const float nn = sqrtf(nsq);
  if (p.norm == N_HUBER)
    pj = nn <= p.huber_delta ? (nn * nn) / (2.f * p.huber_delta)
                             : nn - p.huber_delta / 2.f;
  else
    pj = nn;
  float psq = 0.f;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    float pv = y[i] + p.sigma_D * d[i];
    if (p.norm == N_HUBER) pv = pv / p.huber_den;
    psq += pv * pv;
    y[i] = pv;
  }
  const float den = fmaxf(sqrtf(psq) / p.reg, 1.f);
#pragma unroll
  for (int i = 0; i < ND; ++i) y[i] = y[i] / den;
  return pj;
}

// chan_y from the slot's difference dv and divisor n.
__device__ __forceinline__ float spec_y(const Params& p, bool t_axis, int i,
                                        float dv, float n, float tm) {
  if (t_axis) dv = dv * tm;
  dv = dv * p.w[i];
  if (p.norm == N_ANISO) return dv > 0.f ? 1.f : (dv < 0.f ? -1.f : 0.f);
  return dv / (p.norm == N_HUBER ? fmaxf(n, p.huber_delta) : n);
}

// tv_subgrad_voxel at one voxel, from what the kernel gathered around it:
// per axis its position and length, x at slots -2..2 (xc at 0) and the
// norms at -1 and +1 (nc at 0); zeros where a channel's gates never read.
template <Table T>
__device__ __forceinline__ float subgrad_at(
    const Params& p, const int (&pos)[4], const int (&len)[4], float xc,
    float nc, const float (&xm2)[4], const float (&xm1)[4],
    const float (&xp1)[4], const float (&xp2)[4], const float (&nm1)[4],
    const float (&np1)[4], float tm) {
  // each axis's differences, once: x[q] - x[q-s] is FWD's at slot q-s and
  // BWD's at q, x[q+s] - x[q] FWD's at q and BWD's at q+s; CTR's at q-s and
  // q+s are x[q] - x[q-2s] and x[q+2s] - x[q]
  float dm[4], dp[4], dm2[4], dp2[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    dm[a] = xc - xm1[a];
    dp[a] = xp1[a] - xc;
    dm2[a] = xc - xm2[a];
    dp2[a] = xp2[a] - xc;
  }
  const bool iso = p.norm == N_ISO;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < tab_nd(T); ++i) {
    const int a = tab_axis(T, i), kd = tab_kind(T, i);
    const bool ta = a == AX_T;
    const int ps = pos[a], ln = len[a];
    float lo, hi;
    if (kd == K_FWD) {         // slots [0, L-2]
      lo = ps >= 1 ? spec_y(p, ta, i, dm[a], nm1[a], tm) : 0.f;
      hi = ps <= ln - 2 ? spec_y(p, ta, i, dp[a], nc, tm) : 0.f;
    } else if (kd == K_BWD) {  // slots [1, L-1]
      lo = ps >= 1 ? spec_y(p, ta, i, dm[a], nc, tm) : 0.f;
      hi = ps <= ln - 2 ? spec_y(p, ta, i, dp[a], np1[a], tm) : 0.f;
    } else {                   // slots [1, L-2]
      lo = ps >= 2 ? spec_y(p, ta, i, dm2[a], nm1[a], tm) : 0.f;
      hi = ps <= ln - 3 ? spec_y(p, ta, i, dp2[a], np1[a], tm) : 0.f;
    }
    float w = lo - hi;
    if (!iso) {  // aniso / huber re-apply the full weight, like D^T
      w = w * p.w[i];
      if (ta) w = w * tm;
    }
    acc += w;
  }
  // iso: the y values carry one normalisation inside w, this is the second
  return iso ? acc * p.scheme_norm : acc;
}

// ------------------------------------------------------- pass A
// Number of blocks along a plane, and of TV partials, of pass A with V
// columns per thread: one block per BLOCK runs of V columns.
template <int V>
static inline long long dual_blocks(int Nr, int Nc) {
  const long long runs = (long long)Nr * ((Nc + V - 1) / V);
  return (runs + BLOCK - 1) / BLOCK;
}
template <int V>
static inline long long dual_num_parts(int Nz, int M, int Nr, int Nc) {
  return dual_blocks<V>(Nr, Nc) * Nz * M;
}

// Pass A on one run of a (z, t) plane: y_D' = tv_dual_prox(y_D + sigma_D
// D x) in place, with FID also y_A' = fid_dual(y_A, x, x0) in place (B1,
// B8, B10), without it no x0, y_A or tmul (B5).  Run k of the plane takes
// the V columns from c0 = V (k mod cpr) of row r = k / cpr, cpr =
// ceil(Nc / V) runs per row (k < Nr cpr); a row's last run may be short
// (n < V) when V does not divide Nc.  `vec`: Nc is a multiple of V and every
// array is V-aligned.  The x planes are the caller's, each addressed by the
// run's offset within a plane (r Nc + c0), so that a plane may lie in
// global or in shared memory: xz the plane (z, t) itself, read at the run,
// one column either side and one row either side; xzm and xzp the planes at
// z - 1 and z + 1 (on a shard's edge plane one of them is the exchanged halo
// plane), xtm and xtp those at t - 1 and t + 1, each read at the run where a
// channel reads it and its gate passes (zpos and zlen are the z gate, tpos
// and tlen the t gate: z, Nz and t, M on an unsharded volume; 2 and 5 turn
// a gate off: position 2 lies inside [2, len - 3], where every channel and
// its adjoint read).  y_D, y_A and x0 are addressed at plane (z, t) of the
// (Nz, M) planes p describes.
// Returns the thread's TV partial.
template <Table T, int V, bool FID, typename TX, typename TD>
__device__ __forceinline__ float dual_spec_run(
    const Params& p, int k, int z, int t, int zpos, int zlen, int tpos,
    int tlen,
    const TX* __restrict__ xz, const TX* __restrict__ xzm,
    const TX* __restrict__ xzp, const TX* __restrict__ xtm,
    const TX* __restrict__ xtp, const TX* __restrict__ x0,
    TX* __restrict__ yA, TD* __restrict__ yD, const float* __restrict__ tmul,
    int vec) {
  constexpr int ND = tab_nd(T);
  const int cpr = (p.Nc + V - 1) / V;
  const int r = k / cpr;
  const int c0 = (k - r * cpr) * V;
  const int n = min(V, p.Nc - c0);
  const int64_t plane = (int64_t)p.Nr * p.Nc, base = (z * p.M + t) * plane;
  const Offset q = (Offset)r * p.Nc + c0;
  const TX* xq = xz + q;
  TD* yq = yD + base * ND + q;

  float xc[V];
  load_run(xq, vec, n, xc);
  // the runs at -1 and +1 along z, t and the rows, where a channel reads
  // them (zeros elsewhere); along the columns, the values either side
  const int len[4] = {zlen, tlen, p.Nr, p.Nc};
  float xm[4][V] = {}, xp[4][V] = {};
  load_nb(xzm + q, tab_lo(T, AX_Z) && zpos > 0, vec, n, xm[AX_Z]);
  load_nb(xzp + q, tab_hi(T, AX_Z) && zpos < zlen - 1, vec, n, xp[AX_Z]);
  load_nb(xtm + q, tab_lo(T, AX_T) && tpos > 0, vec, n, xm[AX_T]);
  load_nb(xtp + q, tab_hi(T, AX_T) && tpos < tlen - 1, vec, n, xp[AX_T]);
  load_nb(xq - p.Nc, tab_lo(T, AX_ROW) && r > 0, vec, n, xm[AX_ROW]);
  load_nb(xq + p.Nc, tab_hi(T, AX_ROW) && r < p.Nr - 1, vec, n, xp[AX_ROW]);
  const float xl = c0 > 0 ? ld(xq, -1) : 0.f;
  const float xr = c0 + V < p.Nc ? ld(xq, V) : 0.f;
  float tm[V];
#pragma unroll
  for (int j = 0; j < V; ++j) tm[j] = 1.f;
  if (FID && tab_has(T, AX_T) && p.has_tmul)
    load_run(tmul + q, vec, n, tm);

  // weighted_d, column by column
  float d[V][ND];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int pj[4] = {zpos, tpos, r, c0 + j};
    const float mj[4] = {xm[AX_Z][j], xm[AX_T][j], xm[AX_ROW][j],
                         j > 0 ? xc[j - 1] : xl};
    const float hj[4] = {xp[AX_Z][j], xp[AX_T][j], xp[AX_ROW][j],
                         j < V - 1 ? xc[j + 1] : xr};
    spec_d<T>(p, pj, len, xc[j], mj, hj, tm[j], d[j]);
  }

  if constexpr (FID) {  // fid_dual
    float ya[V], xo[V];
    load_run(yA + base + q, vec, n, ya);
    load_run(x0 + base + q, vec, n, xo);
#pragma unroll
    for (int j = 0; j < V; ++j) ya[j] = fid_dual(p, ya[j], xc[j], xo[j]);
    store_run(yA + base + q, vec, n, ya);
  }

  // tv_dual_prox, voxel by voxel
  float y[ND][V];
#pragma unroll
  for (int i = 0; i < ND; ++i) load_run(yq + i * plane, vec, n, y[i]);
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float yj[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) yj[i] = y[i][j];
    const float pj = spec_dual_prox<T>(p, d[j], yj);
#pragma unroll
    for (int i = 0; i < ND; ++i) y[i][j] = yj[i];
    if (j < n) part += pj;
  }
#pragma unroll
  for (int i = 0; i < ND; ++i) store_run(yq + i * plane, vec, n, y[i]);
  return part;
}

// Pass A on the block's (z, t) plane: thread k of the plane (k = blockIdx.x
// BLOCK + threadIdx.x) takes run k (dual_spec_run).  xz is x's plane (z, t)
// wherever x lies -- the volume, or a shard's x extended by neighbour or
// ghost planes (voxel.cuh::ext_plane) -- and the planes across t are the
// ones before and after it; those across z are the caller's (xzm, xzp).
// zpos, zlen and tpos, tlen are the z and t gates.  Returns the block's TV
// partial (block_sum, no atomics), valid in thread 0.
template <Table T, int V, bool FID, typename TX, typename TD>
__device__ __forceinline__ float dual_spec_body(
    const Params& p, int z, int t, int zpos, int zlen, int tpos, int tlen,
    const TX* __restrict__ xz, const TX* __restrict__ xzm,
    const TX* __restrict__ xzp, const TX* __restrict__ x0,
    TX* __restrict__ yA, TD* __restrict__ yD, const float* __restrict__ tmul,
    int vec) {
  const int cpr = (p.Nc + V - 1) / V;
  const int k = blockIdx.x * BLOCK + threadIdx.x;
  float part = 0.f;
  if (k < p.Nr * cpr) {
    const int64_t plane = (int64_t)p.Nr * p.Nc;
    part = dual_spec_run<T, V, FID, TX, TD>(
        p, k, z, t, zpos, zlen, tpos, tlen, xz, xzm, xzp, xz - plane,
        xz + plane, x0, yA, yD, tmul, vec);
  }
  return block_sum(part);
}

// Pass A on plane blockIdx.y of an unsharded volume, the block's TV partial
// at parts[blockIdx.y][blockIdx.x].
template <Table T, int V, bool FID, typename TX, typename TD>
__device__ __forceinline__ void dual_spec_plane(
    const Params& p, const TX* __restrict__ x, const TX* __restrict__ x0,
    TX* __restrict__ yA, TD* __restrict__ yD, const float* __restrict__ tmul,
    float* __restrict__ parts, int vec) {
  const int zt = blockIdx.y, z = zt / p.M, t = zt - z * p.M;
  const int64_t plane = (int64_t)p.Nr * p.Nc, zs = p.M * plane;
  const TX* xz = x + zt * plane;
  const float s = dual_spec_body<T, V, FID, TX, TD>(
      p, z, t, z, p.Nz, t, p.M, xz, xz - zs, xz + zs, x0, yA, yD, tmul, vec);
  if (threadIdx.x == 0) parts[(int64_t)zt * gridDim.x + blockIdx.x] = s;
}

// Pass A on plane blockIdx.y of a shard whose x is extended by one plane per
// side in z and t (the neighbour shards' planes, or ghost planes): the
// block's plane (z, t) at extended plane (z + 1, t + 1) (voxel.cuh's
// ext_plane), its z neighbours M + 2 planes either side, both gates off
// (position 2 of 5, where every channel and its adjoint read:
// dual_spec_run); y_D and the partials keep the shard's shape, the block's
// TV partial at parts[blockIdx.y][blockIdx.x].  CP pass A's halo instance
// (FID, csrc/specialised_cp.cu) and B5's (csrc/specialised_tv.cu).
template <Table T, int V, bool FID, typename TX, typename TD>
__device__ __forceinline__ void dual_spec_halo_plane(
    const Params& p, const TX* __restrict__ x, const TX* __restrict__ x0,
    TX* __restrict__ yA, TD* __restrict__ yD, const float* __restrict__ tmul,
    float* __restrict__ parts, int vec) {
  const int zt = blockIdx.y, z = zt / p.M, t = zt - z * p.M;
  const int64_t plane = (int64_t)p.Nr * p.Nc, zs = (p.M + 2) * plane;
  const TX* xz = x + ext_plane(p, z, t, 1) * plane;
  const float s = dual_spec_body<T, V, FID, TX, TD>(
      p, z, t, 2, 5, 2, 5, xz, xz - zs, xz + zs, x0, yA, yD, tmul, vec);
  if (threadIdx.x == 0) parts[(int64_t)zt * gridDim.x + blockIdx.x] = s;
}

// Launch shape of pass A: one block per BLOCK runs of V columns of a plane,
// one plane per blockIdx.y.
template <int V>
static inline dim3 dual_grid(const Params* p) {
  return dim3((unsigned)dual_blocks<V>(p->Nr, p->Nc),
              (unsigned)(p->Nz * p->M));
}

// Whether every run of V columns a launch touches is whole and V-aligned in
// each array it reads or writes (x-like arrays of TX, the dual of TD, tmul
// where the launch reads it): then each run is one vector access
// (load_run's `vec`), else the runs go element by element (an odd width, a
// view one element off).
template <int V, typename TX, typename TD>
static inline int runs_aligned(const Params* p, const void* x, const void* x0,
                               const void* yA, const void* y, const void* out,
                               const void* tmul) {
  return p->Nc % V == 0 && aligned(x, V * sizeof(TX)) &&
         aligned(x0, V * sizeof(TX)) && aligned(yA, V * sizeof(TX)) &&
         aligned(out, V * sizeof(TX)) && aligned(y, V * sizeof(TD)) &&
         (!p->has_tmul || aligned(tmul, V * sizeof(float)));
}

// The block's partial s into row zt of an array whose (z, t) planes hold
// ceil(Nr Nc / BLOCK) slots each (stencil.cuh's num_parts: one per block of
// BLOCK voxels, the overlapped step's layout, whose edge rows B8 fills and
// whose inner rows the interior launches of csrc/specialised_cp.cu fill):
// s at slot blockIdx.x, zeros at blockIdx.x + j gridDim.x (j >= 1) inside
// the row.  With gridDim.x <= slots <= 2 gridDim.x (two columns a thread),
// every slot of the row is written once.
__device__ __forceinline__ void slot_parts(const Params& p, int zt, float s,
                                           float* parts) {
  if (threadIdx.x != 0) return;
  const int slots = (int)(((int64_t)p.Nr * p.Nc + BLOCK - 1) / BLOCK);
  float* row = parts + (int64_t)zt * slots;
  row[blockIdx.x] = s;
  for (int j = blockIdx.x + gridDim.x; j < slots; j += gridDim.x) row[j] = 0.f;
}

// ------------------------------------------------------- pass B
// Pass B on the block's (z, t) plane: x' = x - tau y_A' - tau D^T y_D' (then
// max(x', 0) when nonneg) into `out`, thread k taking the run of V columns
// that pass A gives it.  cp_primal_voxel's arithmetic in its order: each
// channel's (lo - hi) w[i] (times tm on a time channel) added to corr in
// table order, x - tau y_A - tau corr.  Channel i's adjoint reads the dual
// of channel i at the voxel and at one neighbour along its axis (FWD: -1,
// BWD: +1) or two (CTR), each loaded once for the run: along the columns
// the run itself and the element either side, along z, t and the rows a
// run.  yz is the dual's plane (z, t), channel 0, wherever the dual lies --
// y_D, or a copy extended by neighbour planes (voxel.cuh::ext_plane) -- and
// its planes across t are the ones before and after it; the z axis is the
// caller's, as in pass A: yzm and yzp are the dual's planes (channel 0) at
// z - 1 and z + 1.  zpos, zlen and tpos, tlen are the z and t gates.  x,
// x0, y_A and out are addressed at plane (z, t) of the (Nz, M) planes p
// describes; out may be x (in place) and x0 may be x, so none of the three
// is __restrict__ (each run is read before it is written).  Returns the
// block's fidelity partial without fid_scale (block_sum), valid in
// thread 0.
template <Table T, int V, typename TX, typename TD>
__device__ __forceinline__ float primal_spec_body(
    const Params& p, int z, int t, int zpos, int zlen, int tpos, int tlen,
    const TX* x, const TX* x0, const TX* __restrict__ yA,
    const TD* __restrict__ yz, const TD* __restrict__ yzm,
    const TD* __restrict__ yzp, const float* __restrict__ tmul, TX* out,
    int vec) {
  constexpr int ND = tab_nd(T);
  const int cpr = (p.Nc + V - 1) / V;
  const int k = blockIdx.x * BLOCK + threadIdx.x;
  float part = 0.f;
  if (k < p.Nr * cpr) {
    const int r = k / cpr;
    const int c0 = (k - r * cpr) * V;
    const int n = min(V, p.Nc - c0);
    const int64_t plane = (int64_t)p.Nr * p.Nc, base = (z * p.M + t) * plane;
    const Offset q = (Offset)r * p.Nc + c0;
    const TD* yq = yz + q;
    const int pos[4] = {zpos, tpos, r, c0}, len[4] = {zlen, tlen, p.Nr, p.Nc};
    float tm[V];
#pragma unroll
    for (int j = 0; j < V; ++j) tm[j] = 1.f;
    if (tab_has(T, AX_T) && p.has_tmul) load_run(tmul + q, vec, n, tm);

    float corr[V];
#pragma unroll
    for (int j = 0; j < V; ++j) corr[j] = 0.f;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int a = tab_axis(T, i), kd = tab_kind(T, i);
      const TD* yi = yq + i * plane;
      // the dual of channel i at the run (yc) and at -1 (ym) and +1 (yp)
      // along its axis, where its gates read them
      float yc[V], ym[V] = {}, yp[V] = {};
      load_run(yi, vec, n, yc);
      float yl = 0.f, yr = 0.f;  // along the columns: c0 - 1, c0 + V
      const bool lo_nb = kd != K_BWD, hi_nb = kd != K_FWD;
      if (a == AX_COL) {
        if (lo_nb && c0 > 0) yl = ld(yi, -1);
        if (hi_nb && c0 + V < p.Nc) yr = ld(yi, V);
      } else {
        const int lo_min = kd == K_CTR ? 2 : 1;  // the gates of lo and hi
        const int hi_max = len[a] - (kd == K_CTR ? 3 : 2);
        const int64_t s = a == AX_T ? ND * plane : p.Nc;
        load_nb(a == AX_Z ? yzm + i * plane + q : yi - s,
                lo_nb && pos[a] >= lo_min, vec, n, ym);
        load_nb(a == AX_Z ? yzp + i * plane + q : yi + s,
                hi_nb && pos[a] <= hi_max, vec, n, yp);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int ps = a == AX_COL ? c0 + j : pos[a], ln = len[a];
        const float mj = a == AX_COL ? (j > 0 ? yc[j - 1] : yl) : ym[j];
        const float pj = a == AX_COL ? (j < V - 1 ? yc[j + 1] : yr) : yp[j];
        float lo, hi;
        if (kd == K_FWD) {         // slots [0, L-2]
          lo = ps >= 1 ? mj : 0.f;
          hi = ps <= ln - 2 ? yc[j] : 0.f;
        } else if (kd == K_BWD) {  // slots [1, L-1]
          lo = ps >= 1 ? yc[j] : 0.f;
          hi = ps <= ln - 2 ? pj : 0.f;
        } else {                   // slots [1, L-2]
          lo = ps >= 2 ? mj : 0.f;
          hi = ps <= ln - 3 ? pj : 0.f;
        }
        float w = (lo - hi) * p.w[i];
        if (a == AX_T) w = w * tm[j];
        corr[j] += w;
      }
    }

    float xv[V], ya[V], xo[V];
    load_run(x + base + q, vec, n, xv);
    load_run(yA + base + q, vec, n, ya);
    load_run(x0 + base + q, vec, n, xo);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float xn = xv[j] - p.tau * ya[j] - p.tau * corr[j];
      if (p.nonneg) xn = fmaxf(xn, 0.f);
      xv[j] = xn;
      if (j < n) part += fid_term(p, xn, xo[j]);
    }
    store_run(out + base + q, vec, n, xv);
  }
  return block_sum(part);
}
