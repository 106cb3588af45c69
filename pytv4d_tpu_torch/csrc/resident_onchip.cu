// Whole-solve Chambolle-Pock and subgradient-descent kernels for NVIDIA
// Hopper (sm_90a) with the solver state on chip: every iteration of a TV
// denoising solve in ONE launch, each block's share of the state in its
// shared memory for the whole solve.  Bound to Python through a plain C
// interface (ctypes).
//
// Replaces the Pallas TPU kernels of pytv4d_tpu/kernels/resident.py:
//   reso_cp_kernel <- make_resident_cp_solver (:50)
//   reso_gd_kernel <- make_resident_gd_solver (:109)
// which kept the solver state in VMEM for all iterations, as this kernel
// keeps it in shared memory.  Volumes whose blocks' shares do not fit take
// the L2 kernels of csrc/resident.cu (kernels/resident.py::resident_variant
// chooses by shape, before the launch).
//
// What bounds it: latency, not bytes or operations.  A cameraman iteration
// is ~74 operations a voxel, 0.07 us of the card's float rate; the L2
// kernel spends 9.19 us on it, of which its two grid barriers and block sums
// alone take 4.0 us (tools/torch_probe_resident.py, PERF.md section 6), and
// each pass reads every neighbour back through L2.  Here:
// - Block b owns the band of rows [b R, min((b+1) R, Nr)) of EVERY (z, t)
//   plane, so its z and t neighbours are its own; R = ceil(Nr / SMs) at
//   least (kernels/resident.py::onchip_band), one block an SM.  The band's
//   state (CP: x, y_A, x0 and the Nd channels of y_D; GD: two x buffers, the
//   norms and x0) and the halo rows its passes read (CP: x +-1 and the row
//   channels' y_D; GD: x +-1, +-2 for central, and the norms +-1) live in
//   dynamic shared memory.  HBM sees x0 and the start state once and the
//   end state once.
// - No grid barrier.  After a pass, the threads of a band's first and last
//   rows publish the values their neighbours read: each float travels in a
//   64-bit word whose high half is the pass's flag, written with one relaxed
//   store at gpu scope (L2).  A neighbour polls those words themselves until
//   they carry the flag it waits for, copies them into its halo rows, and
//   meets its own threads at one __syncthreads().  So a block waits for its
//   two neighbours only, for one L2 round trip, with no fence and no
//   counter.  x (after pass B, or GD's pass 2) and y_D (after pass A, or the
//   norms after GD's pass 1) travel in regions of their own, two of each,
//   chosen by the parity of the flag: a block rewrites a slot two
//   iterations later, after its x halo of the iteration between has come
//   from both neighbours, who publish it after they have read the slot.
//   (With one copy, a neighbour that need not wait for this block's y_D --
//   upwind and downwind have a row channel on one side only -- could
//   overwrite its x edge before this block had read it.  For the same
//   reason CP's first halo is the start state's edge rows published in the
//   exchange, not read from x, which receives the end state.)  The probe
//   measured this exchange against a release/acquire counter per block and
//   against clusters (PERF.md section 6).
// - The spinning blocks must all be resident: the launch keeps the
//   cooperative attribute for the co-residency guarantee (a launch that
//   cannot hold every block fails and raises), with one block an SM.  A
//   wait that lasts a second traps: a fault, not a hang.
// - The per-voxel bodies are the per-launch kernels' specialised for the
//   channel table (specialised.cuh: spec_d, spec_dual_prox, spec_norm,
//   subgrad_at; fid_dual, fid_term from voxel.cuh), the table a template
//   argument (the 21 of csrc/tables.cuh), with 32-bit offsets and each
//   thread's voxel found by multiply-shift division.  Built with -fmad=false,
//   x, y_A and y_D equal the L2 kernel's (voxel.cuh's generic bodies) bit
//   for bit.
// Losses: two partials per (iteration, block): warp sums by shuffles, then
// thread 0 adds the warps in order after the next barrier the pass has
// anyway; the wrapper adds the blocks.  No float atomics, so two runs give
// the same bits.  CP: the TV term of D x in pass A and fid_scale times the
// fidelity of the new x; GD: the TV of the pre-update x and 1/2 |x' - x0|^2.

#include "specialised.cuh"

#define RESO_THREADS 512
#define RESO_WARPS (RESO_THREADS / 32)
// Dynamic shared memory a block may take: the H100's 232 448 bytes a block
// (227 KB) less this kernel's static warp sums (kernels/resident.py
// ONCHIP_SMEM_BYTES mirrors it).
#define RESO_SMEM_BYTES (232448 - 256)

// Channel of T along the rows that reads the row above (FWD, CTR) or below
// (BWD, CTR), or -1.
__host__ __device__ constexpr int row_chan(Table t, bool above) {
  for (int i = 0; i < tab_nd(t); ++i)
    if (tab_axis(t, i) == AX_ROW &&
        (tab_kind(t, i) == K_CTR || tab_kind(t, i) == (above ? K_FWD : K_BWD)))
      return i;
  return -1;
}
// GD's halo of x: pass 2 reads x out to +-2 along an axis with a CTR channel.
__host__ __device__ constexpr int gd_halo(Table t) {
  return tab_has(t, AX_ROW, K_CTR) ? 2 : 1;
}

// The flag of the start state's x edge rows (CP): no iteration's, and even,
// so in the slot that iteration 1's x takes next -- after the neighbour has
// read it (its x of iteration 0 reached this block first).
#define RESO_FSTART 0x80000000u

// Exchange words a block: two slots (by the flag's parity) of (CP) x and
// y_D, each side, or (GD) x at H rows and the norms, each side.
__host__ __device__ constexpr long long exch_words(int P, int Nc) {
  return 12LL * P * Nc;
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (round-up method).
struct FastDiv {
  unsigned m, s;
  __device__ __forceinline__ explicit FastDiv(unsigned d) {
    s = d > 1 ? 32 - __clz(d - 1) : 0;
    m = d > 1 ? (unsigned)(((1ull << 32) * ((1ull << s) - d)) / d + 1) : 0;
  }
  __device__ __forceinline__ int operator()(int n) const {
    return (int)((__umulhi((unsigned)n, m) + (unsigned)n) >> s);
  }
};

__device__ __forceinline__ unsigned long long reso_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Publish v under `flag` (the word's high half).
__device__ __forceinline__ void ll_put(unsigned long long* w, float v,
                                       unsigned flag) {
  const unsigned long long word =
      ((unsigned long long)flag << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(w), "l"(word)
               : "memory");
}

// The value published at w under `flag`, once it is there (a second
// without it traps).
__device__ __forceinline__ float ll_get(const unsigned long long* w,
                                        unsigned flag) {
  unsigned long long word, t0 = 0;
  for (int k = 0;; ++k) {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(word)
                 : "l"(w)
                 : "memory");
    if ((unsigned)(word >> 32) == flag) break;
    if ((k & 1023) == 1023) {
      const unsigned long long t = reso_now();
      if (t0 == 0) t0 = t;
      else if (t - t0 > 1000000000ull) __trap();
    }
  }
  return __uint_as_float((unsigned)word);
}

// What every thread of a block knows about its band.
struct Band {
  int Nz, M, Nr, Nc, P;  // P = Nz M planes
  int R, rows, row0;     // band stride, this band's rows, its first row
  int b, B;              // block, blocks
};

__device__ __forceinline__ Band band_of(const Params& p, int R) {
  Band bd;
  bd.Nz = p.Nz;
  bd.M = p.M;
  bd.Nr = p.Nr;
  bd.Nc = p.Nc;
  bd.P = p.Nz * p.M;
  bd.R = R;
  bd.b = blockIdx.x;
  bd.B = gridDim.x;
  bd.row0 = bd.b * R;
  bd.rows = min(R, p.Nr - bd.row0);
  return bd;
}

// The voxel li of the band (plane-major, then rows, then columns).
struct BandVox {
  int pl, z, t, rl, c;
};
struct BandDiv {
  FastDiv nc, rows, m;
  __device__ __forceinline__ explicit BandDiv(const Band& bd)
      : nc(bd.Nc), rows(bd.rows), m(bd.M) {}
  __device__ __forceinline__ BandVox at(const Band& bd, int li) const {
    BandVox v;
    const int prow = nc(li);
    v.c = li - prow * bd.Nc;
    v.pl = rows(prow);
    v.rl = prow - v.pl * bd.rows;
    v.z = m(v.pl);
    v.t = v.pl - v.z * bd.M;
    return v;
  }
};

// Warp sums of v: lane 0 of each warp into ws[warp].
__device__ __forceinline__ void warp_sums(float v, float* ws) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = v;
}
// After a barrier: thread 0 adds the warp sums in order into parts[it][k].
__device__ __forceinline__ void flush_sums(const float* ws, float scale,
                                           int it, int k, float* parts) {
  if (threadIdx.x != 0) return;
  float s = 0.f;
  for (int w = 0; w < RESO_WARPS; ++w) s += ws[w];
  parts[((int64_t)it * 2 + k) * gridDim.x + blockIdx.x] = scale * s;
}

// ------------------------------------------------------------------ CP
// n_iter CP iterations (solvers/cp.py::cp_step: l2 fidelity or any other
// of Params, no mask).  x, yA, yD (internal layout) hold the start state
// and receive the end state; parts is (n_iter, 2, blocks); ex holds
// exch_words a block, zeroed.
template <Table T>
__global__ void __launch_bounds__(RESO_THREADS, 1)
reso_cp_kernel(const Params p, int n_iter, int R,
               const float* __restrict__ x0, float* __restrict__ xg,
               float* __restrict__ yAg, float* __restrict__ yDg,
               float* __restrict__ parts, unsigned long long* ex) {
  constexpr int ND = tab_nd(T);
  constexpr int IA = row_chan(T, true), IB = row_chan(T, false);
  extern __shared__ float sm[];
  __shared__ float ws[2][RESO_WARPS];
  const Band bd = band_of(p, R);
  const BandDiv dv(bd);
  const int Nc = bd.Nc, P = bd.P, rows = bd.rows;
  const int XS = (R + 2) * Nc;              // x: a plane with its halo rows
  const int sYA = P * XS, sX0 = sYA + P * R * Nc, sYD = sX0 + P * R * Nc;
  const int sYH = sYD + P * ND * R * Nc;    // the row channels' halo rows
  const int n = P * rows * Nc, edge = P * Nc;
  const FastDiv ncd(Nc);
  const int64_t EW = exch_words(P, Nc);
  unsigned long long* const mine = ex + bd.b * EW;
  // the slot of flag f: x side 0 (the band's first row, read by b - 1),
  // side 1 (its last, read by b + 1); y_D the same after it
  auto xw = [&](int side, int pl, unsigned f) {
    return (((int)(f & 1u) * 6 + side) * P + pl) * Nc;
  };
  auto yw = [&](int side, int pl, unsigned f) {
    return (((int)(f & 1u) * 6 + 2 + side) * P + pl) * Nc;
  };
  auto gx = [&](int pl, int r) { return (pl * bd.Nr + r) * Nc; };

  for (int li = threadIdx.x; li < n; li += RESO_THREADS) {
    const BandVox v = dv.at(bd, li);
    const int g = gx(v.pl, bd.row0 + v.rl) + v.c, s = (v.pl * R + v.rl) * Nc;
    const float xv = xg[g];
    sm[v.pl * XS + (v.rl + 1) * Nc + v.c] = xv;
    // the start state's edge rows go to the neighbours as every later x
    // does: xg receives the end state, which a neighbour that never waits
    // for this block (upwind, downwind) may write before this block has
    // read its first halo when n_iter is 1
    if (v.rl == 0 && bd.b > 0)
      ll_put(mine + xw(0, v.pl, RESO_FSTART) + v.c, xv, RESO_FSTART);
    if (v.rl == rows - 1 && bd.b + 1 < bd.B)
      ll_put(mine + xw(1, v.pl, RESO_FSTART) + v.c, xv, RESO_FSTART);
    sm[sYA + s + v.c] = yAg[g];
    sm[sX0 + s + v.c] = x0[g];
#pragma unroll
    for (int i = 0; i < ND; ++i)
      sm[sYD + (v.pl * ND + i) * R * Nc + v.rl * Nc + v.c] =
          yDg[(gx(v.pl * ND + i, bd.row0 + v.rl)) + v.c];
  }

  for (int it = 0; it < n_iter; ++it) {
    // x's halo rows: the neighbours' start state, then their x after pass B
    const unsigned fx = it == 0 ? RESO_FSTART : (unsigned)it;
    for (int e = threadIdx.x; e < edge; e += RESO_THREADS) {
      const int pl = ncd(e), c = e - pl * Nc;
      if (bd.b > 0)
        sm[pl * XS + c] = ll_get(mine - EW + xw(1, pl, fx) + c, fx);
      if (bd.b + 1 < bd.B)
        sm[pl * XS + (rows + 1) * Nc + c] =
            ll_get(mine + EW + xw(0, pl, fx) + c, fx);
    }
    __syncthreads();
    if (it > 0) flush_sums(ws[1], p.fid_scale, it - 1, 1, parts);

    // pass A: y_A' and y_D' in place, the TV term of D x
    float tv = 0.f;
    for (int li = threadIdx.x; li < n; li += RESO_THREADS) {
      const BandVox v = dv.at(bd, li);
      const int r = bd.row0 + v.rl;
      const int xi = v.pl * XS + (v.rl + 1) * Nc + v.c;
      const int pos[4] = {v.z, v.t, r, v.c};
      const int len[4] = {bd.Nz, bd.M, bd.Nr, Nc};
      const float xc = sm[xi];
      float xm[4] = {0.f, 0.f, 0.f, 0.f}, xp[4] = {0.f, 0.f, 0.f, 0.f};
      if (tab_lo(T, AX_Z) && v.z > 0) xm[AX_Z] = sm[xi - bd.M * XS];
      if (tab_hi(T, AX_Z) && v.z < bd.Nz - 1) xp[AX_Z] = sm[xi + bd.M * XS];
      if (tab_lo(T, AX_T) && v.t > 0) xm[AX_T] = sm[xi - XS];
      if (tab_hi(T, AX_T) && v.t < bd.M - 1) xp[AX_T] = sm[xi + XS];
      if (tab_lo(T, AX_ROW) && r > 0) xm[AX_ROW] = sm[xi - Nc];
      if (tab_hi(T, AX_ROW) && r < bd.Nr - 1) xp[AX_ROW] = sm[xi + Nc];
      if (v.c > 0) xm[AX_COL] = sm[xi - 1];
      if (v.c < Nc - 1) xp[AX_COL] = sm[xi + 1];
      float d[ND];
      spec_d<T>(p, pos, len, xc, xm, xp, 1.f, d);
      const int s = (v.pl * R + v.rl) * Nc + v.c;
      sm[sYA + s] = fid_dual(p, sm[sYA + s], xc, sm[sX0 + s]);
      const int yb = sYD + v.pl * ND * R * Nc + v.rl * Nc + v.c;
      float y[ND];
#pragma unroll
      for (int i = 0; i < ND; ++i) y[i] = sm[yb + i * R * Nc];
      tv += spec_dual_prox<T>(p, d, y);
#pragma unroll
      for (int i = 0; i < ND; ++i) sm[yb + i * R * Nc] = y[i];
      // the row channels' values the neighbour bands read
      if (IA >= 0 && v.rl == rows - 1 && bd.b + 1 < bd.B)
        ll_put(mine + yw(1, v.pl, it + 1) + v.c, y[IA < 0 ? 0 : IA],
               it + 1);
      if (IB >= 0 && v.rl == 0 && bd.b > 0)
        ll_put(mine + yw(0, v.pl, it + 1) + v.c, y[IB < 0 ? 0 : IB],
               it + 1);
    }
    warp_sums(tv, ws[0]);

    // the row channels' halo rows
    for (int e = threadIdx.x; e < edge; e += RESO_THREADS) {
      const int pl = ncd(e), c = e - pl * Nc;
      if (IA >= 0 && bd.b > 0)
        sm[sYH + 2 * pl * Nc + c] =
            ll_get(mine - EW + yw(1, pl, it + 1) + c, it + 1);
      if (IB >= 0 && bd.b + 1 < bd.B)
        sm[sYH + (2 * pl + 1) * Nc + c] =
            ll_get(mine + EW + yw(0, pl, it + 1) + c, it + 1);
    }
    __syncthreads();
    flush_sums(ws[0], 1.f, it, 0, parts);

    // pass B: x' in place, the fidelity of x'
    float fid = 0.f;
    for (int li = threadIdx.x; li < n; li += RESO_THREADS) {
      const BandVox v = dv.at(bd, li);
      const int r = bd.row0 + v.rl;
      const int pos[4] = {v.z, v.t, r, v.c};
      const int len[4] = {bd.Nz, bd.M, bd.Nr, Nc};
      const int yb = sYD + v.pl * ND * R * Nc + v.rl * Nc + v.c;
      float corr = 0.f;
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int a = tab_axis(T, i), kd = tab_kind(T, i);
        const int yi = yb + i * R * Nc;
        const int ps = pos[a], ln = len[a];
        const int lo_min = kd == K_CTR ? 2 : 1;  // the gates of lo and hi
        const int hi_max = ln - (kd == K_CTR ? 3 : 2);
        const int s = a == AX_Z ? bd.M * ND * R * Nc
                    : a == AX_T ? ND * R * Nc : a == AX_ROW ? Nc : 1;
        const float yc = sm[yi];
        float ym = 0.f, yp = 0.f;
        if (kd != K_BWD && ps >= lo_min)
          ym = a == AX_ROW && v.rl == 0 ? sm[sYH + 2 * v.pl * Nc + v.c]
                                        : sm[yi - s];
        if (kd != K_FWD && ps <= hi_max)
          yp = a == AX_ROW && v.rl == rows - 1
                   ? sm[sYH + (2 * v.pl + 1) * Nc + v.c]
                   : sm[yi + s];
        float lo, hi;
        if (kd == K_FWD) {         // slots [0, L-2]
          lo = ps >= 1 ? ym : 0.f;
          hi = ps <= ln - 2 ? yc : 0.f;
        } else if (kd == K_BWD) {  // slots [1, L-1]
          lo = ps >= 1 ? yc : 0.f;
          hi = ps <= ln - 2 ? yp : 0.f;
        } else {                   // slots [1, L-2]
          lo = ps >= 2 ? ym : 0.f;
          hi = ps <= ln - 3 ? yp : 0.f;
        }
        // (cp_primal_voxel times a time channel by tm, which is 1 here)
        corr += (lo - hi) * p.w[i];
      }
      const int xi = v.pl * XS + (v.rl + 1) * Nc + v.c;
      const int s = (v.pl * R + v.rl) * Nc + v.c;
      float xn = sm[xi] - p.tau * sm[sYA + s] - p.tau * corr;
      if (p.nonneg) xn = fmaxf(xn, 0.f);
      sm[xi] = xn;
      fid += fid_term(p, xn, sm[sX0 + s]);
      if (v.rl == 0 && bd.b > 0)
        ll_put(mine + xw(0, v.pl, it + 1) + v.c, xn, it + 1);
      if (v.rl == rows - 1 && bd.b + 1 < bd.B)
        ll_put(mine + xw(1, v.pl, it + 1) + v.c, xn, it + 1);
    }
    warp_sums(fid, ws[1]);
  }
  __syncthreads();
  if (n_iter == 0) return;  // the state is the start state
  flush_sums(ws[1], p.fid_scale, n_iter - 1, 1, parts);
  for (int li = threadIdx.x; li < n; li += RESO_THREADS) {
    const BandVox v = dv.at(bd, li);
    const int g = gx(v.pl, bd.row0 + v.rl) + v.c, s = (v.pl * R + v.rl) * Nc;
    xg[g] = sm[v.pl * XS + (v.rl + 1) * Nc + v.c];
    yAg[g] = sm[sYA + s + v.c];
#pragma unroll
    for (int i = 0; i < ND; ++i)
      yDg[gx(v.pl * ND + i, bd.row0 + v.rl) + v.c] =
          sm[sYD + (v.pl * ND + i) * R * Nc + v.rl * Nc + v.c];
  }
}

// ------------------------------------------------------------------ GD
// n_iter subgradient-descent iterations: x' = x - step ((x - x0) + reg G),
// G the TV subgradient of x (p.tau carries the step size).  xa holds the
// start iterate; the result goes to xa (n_iter even) or xb, as the L2
// kernel leaves it.  parts is (n_iter, 2, blocks); ex as for CP.
template <Table T>
__global__ void __launch_bounds__(RESO_THREADS, 1)
reso_gd_kernel(const Params p, int n_iter, int R,
               const float* __restrict__ x0, float* __restrict__ xa,
               float* __restrict__ xb, float* __restrict__ parts,
               unsigned long long* ex) {
  constexpr int H = gd_halo(T);
  extern __shared__ float sm[];
  __shared__ float ws[2][RESO_WARPS];
  const Band bd = band_of(p, R);
  const BandDiv dv(bd);
  const int Nc = bd.Nc, P = bd.P, rows = bd.rows;
  const int XS = (R + 2 * H) * Nc, NS = (R + 2) * Nc;
  const int sXB = P * XS, sN = 2 * P * XS, sX0 = sN + P * NS;
  const int n = P * rows * Nc, edge = P * Nc;
  const FastDiv ncd(Nc);
  const int64_t EW = exch_words(P, Nc);
  unsigned long long* const mine = ex + bd.b * EW;
  // the slot of flag f: x side 0 rows 0..H-1 of the band (read by b - 1),
  // side 1 rows rows-1, rows-2, .. (read by b + 1); the norms' first and
  // last row after them
  auto xw = [&](int side, int h, int pl, unsigned f) {
    return (((int)(f & 1u) * 6 + side * H + h) * P + pl) * Nc;
  };
  auto nw = [&](int side, int pl, unsigned f) {
    return (((int)(f & 1u) * 6 + 2 * H + side) * P + pl) * Nc;
  };
  auto gx = [&](int pl, int r) { return (pl * bd.Nr + r) * Nc; };

  for (int li = threadIdx.x; li < n; li += RESO_THREADS) {
    const BandVox v = dv.at(bd, li);
    const int g = gx(v.pl, bd.row0 + v.rl) + v.c;
    sm[v.pl * XS + (v.rl + H) * Nc + v.c] = xa[g];
    sm[sX0 + (v.pl * R + v.rl) * Nc + v.c] = x0[g];
  }

  for (int it = 0; it < n_iter; ++it) {
    const int src = (it & 1) ? sXB : 0, dst = (it & 1) ? 0 : sXB;
    // x's halo rows, H each side where the volume has them: at it 0 from
    // xa, which receives the end state only after a second iteration, whose
    // halo has come from both neighbours
    for (int e = threadIdx.x; e < edge; e += RESO_THREADS) {
      const int pl = ncd(e), c = e - pl * Nc;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        if (bd.b > 0 && bd.row0 - 1 - h >= 0)
          sm[src + pl * XS + (H - 1 - h) * Nc + c] =
              it == 0 ? xa[gx(pl, bd.row0 - 1 - h) + c]
                      : ll_get(mine - EW + xw(1, h, pl, it) + c, it);
        if (bd.b + 1 < bd.B && bd.row0 + rows + h < bd.Nr)
          sm[src + pl * XS + (rows + H + h) * Nc + c] =
              it == 0 ? xa[gx(pl, bd.row0 + rows + h) + c]
                      : ll_get(mine + EW + xw(0, h, pl, it) + c, it);
      }
    }
    __syncthreads();
    if (it > 0) flush_sums(ws[1], 0.5f, it - 1, 1, parts);

    // pass 1: the norms, the TV of x
    float tv = 0.f;
    for (int li = threadIdx.x; li < n; li += RESO_THREADS) {
      const BandVox v = dv.at(bd, li);
      const int r = bd.row0 + v.rl;
      const int xi = src + v.pl * XS + (v.rl + H) * Nc + v.c;
      const int pos[4] = {v.z, v.t, r, v.c};
      const int len[4] = {bd.Nz, bd.M, bd.Nr, Nc};
      const float xc = sm[xi];
      float xm[4] = {0.f, 0.f, 0.f, 0.f}, xp[4] = {0.f, 0.f, 0.f, 0.f};
      if (tab_lo(T, AX_Z) && v.z > 0) xm[AX_Z] = sm[xi - bd.M * XS];
      if (tab_hi(T, AX_Z) && v.z < bd.Nz - 1) xp[AX_Z] = sm[xi + bd.M * XS];
      if (tab_lo(T, AX_T) && v.t > 0) xm[AX_T] = sm[xi - XS];
      if (tab_hi(T, AX_T) && v.t < bd.M - 1) xp[AX_T] = sm[xi + XS];
      if (tab_lo(T, AX_ROW) && r > 0) xm[AX_ROW] = sm[xi - Nc];
      if (tab_hi(T, AX_ROW) && r < bd.Nr - 1) xp[AX_ROW] = sm[xi + Nc];
      if (v.c > 0) xm[AX_COL] = sm[xi - 1];
      if (v.c < Nc - 1) xp[AX_COL] = sm[xi + 1];
      float d[tab_nd(T)], nrm;
      spec_d<T>(p, pos, len, xc, xm, xp, 1.f, d);
      tv += spec_norm<T>(p, d, nrm);
      sm[sN + v.pl * NS + (v.rl + 1) * Nc + v.c] = nrm;
      if (v.rl == 0 && bd.b > 0)
        ll_put(mine + nw(0, v.pl, it + 1) + v.c, nrm, it + 1);
      if (v.rl == rows - 1 && bd.b + 1 < bd.B)
        ll_put(mine + nw(1, v.pl, it + 1) + v.c, nrm, it + 1);
    }
    warp_sums(tv, ws[0]);

    // the norms' halo rows
    for (int e = threadIdx.x; e < edge; e += RESO_THREADS) {
      const int pl = ncd(e), c = e - pl * Nc;
      if (bd.b > 0)
        sm[sN + pl * NS + c] =
            ll_get(mine - EW + nw(1, pl, it + 1) + c, it + 1);
      if (bd.b + 1 < bd.B)
        sm[sN + pl * NS + (rows + 1) * Nc + c] =
            ll_get(mine + EW + nw(0, pl, it + 1) + c, it + 1);
    }
    __syncthreads();
    flush_sums(ws[0], 1.f, it, 0, parts);

    // pass 2: x' into the other buffer, 1/2 (x' - x0)^2
    float sq = 0.f;
    for (int li = threadIdx.x; li < n; li += RESO_THREADS) {
      const BandVox v = dv.at(bd, li);
      const int r = bd.row0 + v.rl;
      const int o = v.pl * XS + (v.rl + H) * Nc + v.c, xi = src + o;
      const int ni = sN + v.pl * NS + (v.rl + 1) * Nc + v.c;
      const int pos[4] = {v.z, v.t, r, v.c};
      const int len[4] = {bd.Nz, bd.M, bd.Nr, Nc};
      const int xs[4] = {bd.M * XS, XS, Nc, 1};
      const int ns[4] = {bd.M * NS, NS, Nc, 1};
      // x at -2..2 and the norms at -1, +1 along each axis, where the
      // volume has them (a channel's gates read no other)
      float xm2[4], xm1[4], xp1[4], xp2[4], nm1[4], np1[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const bool m1 = pos[a] >= 1, p1 = pos[a] <= len[a] - 2;
        const bool two = tab_has(T, a, K_CTR);
        xm1[a] = m1 ? sm[xi - xs[a]] : 0.f;
        xp1[a] = p1 ? sm[xi + xs[a]] : 0.f;
        xm2[a] = two && pos[a] >= 2 ? sm[xi - 2 * xs[a]] : 0.f;
        xp2[a] = two && pos[a] <= len[a] - 3 ? sm[xi + 2 * xs[a]] : 0.f;
        nm1[a] = m1 ? sm[ni - ns[a]] : 0.f;
        np1[a] = p1 ? sm[ni + ns[a]] : 0.f;
      }
      const float xc = sm[xi];
      const float g = subgrad_at<T>(p, pos, len, xc, sm[ni], xm2, xm1, xp1,
                                    xp2, nm1, np1, 1.f);
      const float x0v = sm[sX0 + (v.pl * R + v.rl) * Nc + v.c];
      const float xn = xc - p.tau * ((xc - x0v) + p.reg * g);
      sm[dst + o] = xn;
      const float diff = xn - x0v;
      sq += diff * diff;
      if (bd.b > 0 && v.rl < H)
        ll_put(mine + xw(0, v.rl, v.pl, it + 1) + v.c, xn, it + 1);
      if (bd.b + 1 < bd.B && v.rl >= rows - H)
        ll_put(mine + xw(1, rows - 1 - v.rl, v.pl, it + 1) + v.c, xn,
                 it + 1);
    }
    warp_sums(sq, ws[1]);
  }
  __syncthreads();
  if (n_iter == 0) return;  // the result is xa, the start iterate
  flush_sums(ws[1], 0.5f, n_iter - 1, 1, parts);
  float* out = (n_iter & 1) ? xb : xa;
  const int fin = (n_iter & 1) ? sXB : 0;
  for (int li = threadIdx.x; li < n; li += RESO_THREADS) {
    const BandVox v = dv.at(bd, li);
    out[gx(v.pl, bd.row0 + v.rl) + v.c] =
        sm[fin + v.pl * XS + (v.rl + H) * Nc + v.c];
  }
}

// ------------------------------------------------------------ launches
// A cooperative launch of ceil(Nr / R) blocks of RESO_THREADS threads with
// `smem` bytes of dynamic shared memory a block (what the band needs:
// kernels/resident.py::onchip_band sizes it, at most RESO_SMEM_BYTES);
// returns the launch's error code.
template <typename... KArgs, typename... Args>
static int reso_launch(void (*kernel)(KArgs...), const Params* p, int R,
                       int smem, cudaStream_t stream, Args... args) {
  if (R < 1 || smem > RESO_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((p->Nr + R - 1) / R));
    cfg.blockDim = dim3(RESO_THREADS);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel, args...);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear the code; e is what is reported
    return (int)e;
  }
  return (int)cudaGetLastError();
}

template <Table T>
static int cp_table(const Params* p, int n_iter, int R, int smem,
                    const void* x0, void* x, void* yA, void* yD, void* parts,
                    void* ex, cudaStream_t s) {
  return reso_launch(reso_cp_kernel<T>, p, R, smem, s, *p, n_iter, R,
                     (const float*)x0, (float*)x, (float*)yA, (float*)yD,
                     (float*)parts, (unsigned long long*)ex);
}

template <Table T>
static int gd_table(const Params* p, int n_iter, int R, int smem,
                    const void* x0, void* xa, void* xb, void* parts,
                    void* ex, cudaStream_t s) {
  if (p->Nr > R && R < gd_halo(T))  // a band must hold the rows it lends
    return (int)cudaErrorInvalidValue;
  return reso_launch(reso_gd_kernel<T>, p, R, smem, s, *p, n_iter, R,
                     (const float*)x0, (float*)xa, (float*)xb, (float*)parts,
                     (unsigned long long*)ex);
}

extern "C" {

// The CP solve on channel table `id` (csrc/tables.cuh) with bands of R rows
// and `smem` bytes of shared memory a block: x, yA, yD (internal layout)
// updated in place, parts (n_iter, 2, ceil(Nr / R)) floats, ex
// exch_words(Nz M, Nc) words a block, zeroed.  Returns the launch's error
// code (0 = cudaSuccess), cudaErrorInvalidValue for an id outside the list
// or a band that does not fit.
int reso_cp_launch(const Params* p, int id, int n_iter, int R, int smem,
                   const void* x0, void* x, void* yA, void* yD, void* parts,
                   void* ex, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (id) {
#define RESO_CASE(i, code)                                                  \
  case i:                                                                   \
    return cp_table<code>(p, n_iter, R, smem, x0, x, yA, yD, parts, ex, s);
    CHANNEL_TABLES(RESO_CASE)
#undef RESO_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// The GD solve: xa holds the start iterate, the result goes to xa (n_iter
// even) or xb; the rest as reso_cp_launch.
int reso_gd_launch(const Params* p, int id, int n_iter, int R, int smem,
                   const void* x0, void* xa, void* xb, void* parts, void* ex,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (id) {
#define RESO_CASE(i, code)                                                  \
  case i:                                                                   \
    return gd_table<code>(p, n_iter, R, smem, x0, xa, xb, parts, ex, s);
    CHANNEL_TABLES(RESO_CASE)
#undef RESO_CASE
  }
  return (int)cudaErrorInvalidValue;
}

const char* reso_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
