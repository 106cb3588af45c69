// TV pass 1 (B3, the gradient norms) and pass A for inverse problems (B5),
// each on an unsharded volume and in the halo mode of a (z, t)-sharded
// solve, specialised for one channel table of csrc/tables.cuh, for NVIDIA
// Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of pytv4d_tpu/kernels/fused.py:
//   tv_norms_spec_kernel <- make_tv_norms_kernel (pass 1, fused.py:1353;
//                                                 unsharded and halo mode)
//   tv_dual_spec_kernel  <- make_tv_dual_kernel  (pass A without the
//                                                 fidelity dual, fused.py:759;
//                                                 unsharded and halo mode)
//
// What bounds them: bytes, once the per-channel work is gone (the generic
// bodies' runtime table, 64-bit index arithmetic and gated load per
// channel, not bytes, set their time).  As csrc/specialised.cu does
// for B1 and B4, the table is a template argument and an offset within a
// plane is 32-bit (specialised.cuh).  Then:
//   - pass A for inverse problems is CP pass A's body (specialised.cuh,
//     dual_spec_body) without the fidelity dual: no x0, y_A or time
//     multiplier, VEC_TV = 2 columns per thread with one access per array
//     and per dual channel (four ran slower, tools/torch_probe_spec.py);
//   - pass 1 reads x alone and writes one float per voxel, so its bound is
//     one read of x; the generic body read x once per channel (9 loads a
//     voxel for the hybrid 4D table, the z and t ones from L2).  Here each
//     value of x is fetched into shared memory once per block that needs
//     it: a block owns a tile of NORMS_TC x NORMS_TR pixels of the (row,
//     column) plane and marches along t (MARCH), its step k holding in a
//     ring of shared memory the tiles of the planes at t = k-1, k and k+1,
//     each with a +-1 halo of rows and columns, and the tiles of the planes
//     at z-1 and z+1 of step k.  The slots of the next AHEAD planes fill
//     while a step computes: cp.async, 16 bytes a copy, where every row of
//     x is 16-byte aligned, with each thread's share of the copies worked
//     out once for all steps; else element by element.  So a voxel's x is
//     fetched about three times (its own tile with the halo, and as the z
//     neighbour of two other blocks' planes) against nine, and every
//     neighbour read is a shared-memory read.  tools/torch_probe_spec.py
//     times the march against no march (MARCH -1: z and t from global
//     memory, as pass 2 does), along z, other ring depths (AHEAD), tiles
//     and register caps.
//
// Pass A in the halo mode (HALO; one shard of the sharded CT solve,
// parallel/fused_halo.py::make_sharded_tv_half) is CP pass A's halo
// instance (specialised.cuh's dual_spec_halo_plane, as
// csrc/specialised_cp.cu's cp_dual_shard_kernel runs it) without the
// fidelity dual: x arrives extended by Params::xe = 1 plane per side in z
// and t (the neighbour shards' planes, or ghost planes that zero every
// difference across the volume's edge), the block's plane is addressed in
// it (voxel.cuh's ext_plane) with a z stride of M + 2 planes, and the z and
// t gates are off; y_D and the partials keep the shard's shape.
//
// Pass 1 in the halo mode (HALO; one shard of parallel/fused_halo.py's
// sharded TV and of the sharded CT solve's loss) is the same march over x
// extended by Params::xe = 1 plane per side in z and t, holding the
// neighbour shards' planes or, at the volume's edge, ghost planes that zero
// every difference across it: a block's line along t runs over the M + 2
// extended planes, its ring holding their tiles (one more in flight before
// the first step), and computes the M planes of the shard; the z and t
// gates are off, so every z and t neighbour is read from the ring; the
// norms keep the shard's shape.  The table is the whole volume's
// (kernels/fused.py passes its id from table_dims).
//
// The arithmetic is the generic bodies' operation for operation and in the
// same order (voxel.cuh: weighted_d with tv_norms_voxel for pass 1, and with
// tv_dual_prox for pass A; -fmad=false), so the norms equal the generic
// body's and y_D' equals CP pass A's (with no time multiplier) to the bit; a
// shard's norms and y_D' equal the unsharded kernels' on the same voxels of
// the gathered volume.  The TV partials are one per block (block_sum, no
// atomics): the TV value moves only by the order of a sum.
//
// Bound to Python through the plain C interface at the end (ctypes,
// kernels/fused.py::_spec_launch); nvcc compiles its kernels in parallel
// (-split-compile, kernels/build.py), beside csrc/specialised.cu.

#include <cstddef>

#include "specialised.cuh"

constexpr int VEC_TV = 2;    // pass A: columns per thread
constexpr int NORMS_TC = 64;  // pass 1: a block's tile of the plane is
constexpr int NORMS_TR = 16;  // NORMS_TC columns by NORMS_TR rows,
constexpr int NORMS_TY = BLOCK / NORMS_TC;      // thread (tx, ty) taking
constexpr int NORMS_RPT = NORMS_TR / NORMS_TY;  // rows ty + j NORMS_TY
constexpr int MARCH = AX_T;  // the axis a block marches along (-1: none)
// the other out-of-plane axis, whose neighbours a step copies in too
constexpr int ACROSS = MARCH == AX_T ? AX_Z : (MARCH == AX_Z ? AX_T : -1);
constexpr int AHEAD = 3;     // planes whose tiles are in flight
constexpr int RING = MARCH < 0 ? 1 : AHEAD + 2;  // tiles in shared memory
constexpr int NORMS_MIN_BLOCKS = 1;  // resident blocks an SM must hold
static_assert(NORMS_TR % NORMS_TY == 0 && AHEAD >= 2, "pass 1's tiling");

// ------------------------------------------------ pass A (B5)
// specialised.cuh's dual_spec_body without the fidelity dual, on an
// unsharded volume (dual_spec_plane) or (HALO) on a shard whose x is
// extended by one plane per side in z and t (dual_spec_halo_plane); one TV
// partial per block at parts[zt][blockIdx.x].
template <Table T, typename TX, typename TD, bool HALO>
__global__ void __launch_bounds__(BLOCK)
tv_dual_spec_kernel(const Params p, const TX* __restrict__ x,
                    TD* __restrict__ yD, float* __restrict__ parts,
                    int vec) {
  if constexpr (HALO) {
    dual_spec_halo_plane<T, VEC_TV, false, TX, TD>(p, x, nullptr, nullptr,
                                                   yD, nullptr, parts, vec);
  } else {
    dual_spec_plane<T, VEC_TV, false, TX, TD>(p, x, nullptr, nullptr, yD,
                                              nullptr, parts, vec);
  }
}

// ------------------------------------------------ pass 1 (B3)
// Asynchronous copies from global to shared memory (sm_80 and later):
// `bytes` of src, or zeros where !ok (no byte of src is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// What a step of the march reads from shared memory: the block's tile of
// its plane with a +-1 halo of rows and columns, pixel (r, c) at
// x[r - r0 + 1][PAD + c - c0] (a row's interior starts 16 bytes in, so that
// 16-byte copies land aligned), and the tile (no halo) of the planes at -1
// and +1 along the axis not marched along, ACROSS, at nb[0] and nb[1].
template <typename TX>
struct NormsSlot {
  static constexpr int PAD = 16 / sizeof(TX);  // elements in 16 bytes
  static constexpr int W = NORMS_TC + 2 * PAD, H = NORMS_TR + 2;
  TX x[H][W];
  TX nb[2][NORMS_TR][NORMS_TC];
};

constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The copies that fill a slot, where every row of x is 16-byte aligned:
// 16-byte copies of the tile's rows (with the halo rows), 4-byte copies of
// its two halo columns (an element of f32, a pair of bf16 whose other half
// is never read) and 16-byte copies of the two across tiles.  A thread's
// share of each list is the same at every step but for the plane, so it is
// worked out once: per copy, its offset in a plane (src), its byte offset
// in a slot (dst) and whether it reads the volume (ok; else it writes
// zeros) -- or, where the list has run out, no copy (on).
template <typename TX>
struct NormsFill {
  typedef NormsSlot<TX> S;
  static constexpr int CH = NORMS_TC / S::PAD;  // 16-byte copies per row
  static constexpr int HE = 4 / sizeof(TX);     // elements in 4 bytes
  static constexpr int NX = S::H * CH, NH = 2 * S::H, NN = NORMS_TR * CH;
  static constexpr int UX = cdiv(NX, BLOCK), UH = cdiv(NH, BLOCK),
                       UN = cdiv(NN, BLOCK);
  Offset xs[UX], hs[UH], ns[UN];
  unsigned xd[UX], hd[UH], nd[UN];
  bool xok[UX], hok[UH], nok[2][UN], xon[UX], hon[UH], non[UN];

  // nb_ok[b]: the plane at -1 (b = 0) or +1 (b = 1) along ACROSS is read
  __device__ __forceinline__ NormsFill(const Params& p, int r0, int c0,
                                       const bool (&nb_ok)[2]) {
    constexpr unsigned E = sizeof(TX), NB0 = offsetof(S, nb);
#pragma unroll
    for (int u = 0; u < UX; ++u) {
      const int e = threadIdx.x + u * BLOCK, i = e / CH;
      const int rr = r0 - 1 + i, cc = c0 + (e - i * CH) * S::PAD;
      xon[u] = e < NX;
      xok[u] = xon[u] && rr >= 0 && rr < p.Nr && cc < p.Nc;
      xs[u] = xok[u] ? (Offset)rr * p.Nc + cc : 0;
      xd[u] = (unsigned)(i * S::W + S::PAD + cc - c0) * E;
    }
#pragma unroll
    for (int u = 0; u < UH; ++u) {
      const int e = threadIdx.x + u * BLOCK, i = e >> 1;
      const int rr = r0 - 1 + i;
      const bool hi = e & 1;
      const int cc = hi ? c0 + NORMS_TC : c0 - HE;
      hon[u] = e < NH;
      hok[u] = hon[u] && rr >= 0 && rr < p.Nr &&
               (hi ? cc < p.Nc : c0 > 0);
      hs[u] = hok[u] ? (Offset)rr * p.Nc + cc : 0;
      hd[u] = (unsigned)(i * S::W + S::PAD + cc - c0) * E;
    }
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      const int e = threadIdx.x + u * BLOCK, i = e / CH;
      const int rr = r0 + i, cc = c0 + (e - i * CH) * S::PAD;
      non[u] = e < NN;
      const bool ok = non[u] && rr < p.Nr && cc < p.Nc;
      nok[0][u] = ok && nb_ok[0];
      nok[1][u] = ok && nb_ok[1];
      ns[u] = ok ? (Offset)rr * p.Nc + cc : 0;
      nd[u] = NB0 + (unsigned)(i * NORMS_TC + cc - c0) * E;
    }
  }

  // Start the copies of plane xp and, with `across`, of its across
  // neighbours lo and hi (any valid pointer where that neighbour is not
  // read) into slot sl.
  __device__ __forceinline__ void issue(S& sl, const TX* xp, const TX* lo,
                                        const TX* hi, bool across) const {
    char* base = (char*)&sl;
#pragma unroll
    for (int u = 0; u < UX; ++u)
      if (xon[u]) cp_async16(base + xd[u], xp + xs[u], xok[u]);
#pragma unroll
    for (int u = 0; u < UH; ++u)
      if (hon[u]) cp_async4(base + hd[u], xp + hs[u], hok[u]);
    if constexpr (ACROSS >= 0) {
      constexpr unsigned NB = sizeof(TX) * NORMS_TR * NORMS_TC;
#pragma unroll
      for (int u = 0; u < UN; ++u)
        if (non[u] && across) {
          cp_async16(base + nd[u], lo + ns[u], nok[0][u]);
          cp_async16(base + nd[u] + NB, hi + ns[u], nok[1][u]);
        }
    }
  }
};

// Where a row of x is not 16-byte aligned (Nc not a multiple of PAD, or x
// off alignment): slot sl for plane xp and, with `across`, its across
// neighbours lo and hi element by element, synchronously, zeros outside the
// volume.  The thread
// index is read afresh (volatile), so that the march does not keep this
// path's addresses in registers from step to step, which the aligned path
// would pay for in occupancy.
template <typename TX>
__device__ __forceinline__ void fill_slow(NormsSlot<TX>& sl, const TX* xp,
                                          const TX* lo, const TX* hi,
                                          const bool (&nb_ok)[2], bool across,
                                          const Params& p, int r0, int c0) {
  typedef NormsSlot<TX> S;
  constexpr int W2 = NORMS_TC + 2;
  unsigned tid;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  for (int e = tid; e < S::H * W2; e += BLOCK) {
    const int i = e / W2, j = e - i * W2;
    const int rr = r0 - 1 + i, cc = c0 - 1 + j;
    sl.x[i][S::PAD - 1 + j] = rr >= 0 && rr < p.Nr && cc >= 0 && cc < p.Nc
                                  ? xp[(Offset)rr * p.Nc + cc] : TX{};
  }
  if (ACROSS >= 0 && across) {
    for (int e = tid; e < 2 * NORMS_TR * NORMS_TC; e += BLOCK) {
      const int b = e / (NORMS_TR * NORMS_TC);
      const int i = (e / NORMS_TC) % NORMS_TR, j = e % NORMS_TC;
      const int rr = r0 + i, cc = c0 + j;
      sl.nb[b][i][j] = nb_ok[b] && rr < p.Nr && cc < p.Nc
                           ? (b ? hi : lo)[(Offset)rr * p.Nc + cc]
                           : TX{};
    }
  }
}

// The block's tile of the plane is blockIdx.x (row-major over the plane's
// tiles); blockIdx.y picks the line of planes it marches along: the z of a
// march along t, the t of a march along z, the plane itself without one.
// Step k computes plane (z, t) = (blockIdx.y, k) along t, (k, blockIdx.y)
// along z.  One TV partial per block.  With HALO (a march along t only) x is
// extended by one plane per side in z and t: the march fills the ring from
// the extended plane (z + 1, 0) on, step k computing (z, k) from the
// extended planes k, k + 1 and k + 2, ungated.
template <Table T, typename TX, bool HALO>
__global__ void __launch_bounds__(BLOCK, NORMS_MIN_BLOCKS)
tv_norms_spec_kernel(const Params p, const TX* __restrict__ x,
                     const float* __restrict__ tmul,
                     float* __restrict__ norms, float* __restrict__ parts,
                     int vec) {
  typedef NormsSlot<TX> S;
  constexpr int ND = tab_nd(T);
  static_assert(!HALO || MARCH == AX_T, "the halo mode marches along t");
  // the plane a step computes is O planes into the line's extended planes
  constexpr int O = HALO ? 1 : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  S* ring = reinterpret_cast<S*>(smem);
  const int tiles_c = (p.Nc + NORMS_TC - 1) / NORMS_TC;
  const int tr = blockIdx.x / tiles_c;
  const int r0 = tr * NORMS_TR, c0 = (blockIdx.x - tr * tiles_c) * NORMS_TC;
  const int ty = threadIdx.x / NORMS_TC, tx = threadIdx.x % NORMS_TC;
  const int c = c0 + tx;
  const int64_t plane = (int64_t)p.Nr * p.Nc;
  // the march: L steps over L + 2 O planes of x, plane zt0 + j st the
  // j-th; step k computes plane k + O of them
  const int L = MARCH == AX_T ? p.M : (MARCH == AX_Z ? p.Nz : 1);
  const int Lx = L + 2 * O;
  const int zt0 = HALO ? (int)ext_plane(p, blockIdx.y, -1, 1)
                       : (MARCH == AX_T ? blockIdx.y * p.M : blockIdx.y);
  const int st = MARCH == AX_T ? 1 : p.M;
  // the position along ACROSS, fixed for the block, and that axis's stride
  // in x (ungated in the halo mode)
  const int pa = ACROSS == AX_Z ? blockIdx.y : (ACROSS == AX_T ? blockIdx.y
                                                               : 0);
  const int la = ACROSS == AX_Z ? p.Nz : (ACROSS == AX_T ? p.M : 1);
  const int64_t sa = ACROSS == AX_Z ? (HALO ? p.M + 2 : p.M) * plane : plane;
  const bool nb_ok[2] = {
      ACROSS >= 0 && tab_lo(T, ACROSS) && (HALO || pa > 0),
      ACROSS >= 0 && tab_hi(T, ACROSS) && (HALO || pa < la - 1)};
  const NormsFill<TX> fill(p, r0, c0, nb_ok);

  // per row of the thread: inside the plane, its offset, tmul there
  bool in[NORMS_RPT];
  Offset q[NORMS_RPT];
  float tm[NORMS_RPT];
#pragma unroll
  for (int j = 0; j < NORMS_RPT; ++j) {
    const int r = r0 + ty + j * NORMS_TY;
    in[j] = r < p.Nr && c < p.Nc;
    q[j] = in[j] ? (Offset)r * p.Nc + c : 0;
    tm[j] = tab_has(T, AX_T) && p.has_tmul && in[j] ? tmul[q[j]] : 1.f;
  }
  auto start = [&](int j) {  // start filling the slot of plane j
    S& sl = ring[j % RING];
    const TX* xp = x + (int64_t)(zt0 + j * st) * plane;
    const TX* lo = nb_ok[0] ? xp - sa : xp;
    const TX* hi = nb_ok[1] ? xp + sa : xp;
    // no step reads the across tiles of the two ghost or neighbour planes
    // that end a line of the halo mode
    const bool across = !HALO || (j > 0 && j < Lx - 1);
    if (vec)
      fill.issue(sl, xp, lo, hi, across);
    else
      fill_slow(sl, xp, lo, hi, nb_ok, across, p, r0, c0);
  };
  // one group of copies per plane, AHEAD + O of them before the first step
#pragma unroll
  for (int j = 0; j < AHEAD + O; ++j) {
    if (j < Lx) start(j);
    cp_async_commit();
  }

  float part = 0.f;
#pragma unroll 1
  for (int k = 0; k < L; ++k) {
    // the plane computed, in the norms (the shard's planes in the halo mode)
    const int zt = (HALO ? (int)blockIdx.y * p.M : zt0) + k * st;
    const int z = MARCH == AX_T ? blockIdx.y : (MARCH == AX_Z ? k : zt / p.M);
    const int t = MARCH == AX_T ? k : (MARCH == AX_Z ? blockIdx.y
                                                     : zt - z * p.M);
    // without a march, the z and t neighbours from global memory, issued
    // before the wait
    float gm[NORMS_RPT][2] = {}, gp[NORMS_RPT][2] = {};
    if constexpr (MARCH < 0) {
      const int pos0[2] = {z, t}, len0[2] = {p.Nz, p.M};
      const TX* xb = x + zt * plane;
#pragma unroll
      for (int j = 0; j < NORMS_RPT; ++j) {
        if (!in[j]) continue;
#pragma unroll
        for (int a = AX_Z; a <= AX_T; ++a) {
          const int64_t s = a == AX_Z ? p.M * plane : plane;
          if (tab_lo(T, a) && pos0[a] > 0) gm[j][a] = ld(xb - s, q[j]);
          if (tab_hi(T, a) && pos0[a] < len0[a] - 1)
            gp[j][a] = ld(xb + s, q[j]);
        }
      }
    }
    // plane k+O+1 has landed (AHEAD - 2 later groups may still be in
    // flight), and every thread is done with step k-1, which read the slot
    // plane k+O+AHEAD takes
    cp_async_wait<AHEAD - 2>();
    __syncthreads();
    if (k + O + AHEAD < Lx) start(k + O + AHEAD);
    cp_async_commit();

    const S& cur = ring[(k + O) % RING];
    const S& prv = ring[(k + O + RING - 1) % RING];
    const S& nxt = ring[(k + O + 1) % RING];
    float* nz = norms + zt * plane;
#pragma unroll
    for (int j = 0; j < NORMS_RPT; ++j) {
      if (!in[j]) continue;
      const int ry = ty + j * NORMS_TY, i = ry + 1, cx = S::PAD + tx;
      float xm[4], xp[4];
      xm[AX_ROW] = tof(cur.x[i - 1][cx]);
      xp[AX_ROW] = tof(cur.x[i + 1][cx]);
      xm[AX_COL] = tof(cur.x[i][cx - 1]);
      xp[AX_COL] = tof(cur.x[i][cx + 1]);
      if constexpr (MARCH >= 0) {
        xm[MARCH] = tab_lo(T, MARCH) && (HALO || k > 0) ? tof(prv.x[i][cx])
                                                        : 0.f;
        xp[MARCH] = tab_hi(T, MARCH) && (HALO || k < L - 1)
                        ? tof(nxt.x[i][cx]) : 0.f;
        xm[ACROSS] = nb_ok[0] ? tof(cur.nb[0][ry][tx]) : 0.f;
        xp[ACROSS] = nb_ok[1] ? tof(cur.nb[1][ry][tx]) : 0.f;
      } else {
        xm[AX_Z] = gm[j][AX_Z];
        xm[AX_T] = gm[j][AX_T];
        xp[AX_Z] = gp[j][AX_Z];
        xp[AX_T] = gp[j][AX_T];
      }
      // the z and t gates: off in the halo mode (position 2 of 5, which
      // every gate passes: specialised.cuh's dual_spec_run)
      const int pos[4] = {HALO ? 2 : z, HALO ? 2 : t, r0 + ry, c};
      const int len[4] = {HALO ? 5 : p.Nz, HALO ? 5 : p.M, p.Nr, p.Nc};
      float d[ND];
      spec_d<T>(p, pos, len, tof(cur.x[i][cx]), xm, xp, tm[j], d);
      float n;
      part += spec_norm<T>(p, d, n);
      nz[q[j]] = n;
    }
  }
  const float s = block_sum(part);
  if (threadIdx.x == 0)
    parts[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// ------------------------------------------------------------- launches
static inline unsigned norms_tiles(int Nr, int Nc) {
  return (unsigned)(((Nc + NORMS_TC - 1) / NORMS_TC) *
                    ((Nr + NORMS_TR - 1) / NORMS_TR));
}
// Lines of planes a block marches along: blockIdx.y's extent.
static inline unsigned norms_lines(int Nz, int M) {
  return (unsigned)(MARCH == AX_T ? Nz : MARCH == AX_Z ? M : Nz * M);
}

template <Table T, typename TX, bool HALO>
static int tv_norms_spec_launch(const Params* p, const void* x,
                                const void* tmul, void* norms, void* parts,
                                cudaStream_t s) {
  constexpr size_t bytes = RING * sizeof(NormsSlot<TX>);
  static const cudaError_t set = cudaFuncSetAttribute(
      tv_norms_spec_kernel<T, TX, HALO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid(norms_tiles(p->Nr, p->Nc), norms_lines(p->Nz, p->M));
  const int vec = p->Nc % NormsSlot<TX>::PAD == 0 && aligned(x, 16);
  tv_norms_spec_kernel<T, TX, HALO><<<grid, BLOCK, bytes, s>>>(
      *p, (const TX*)x, (const float*)tmul, (float*)norms, (float*)parts,
      vec);
  return (int)cudaGetLastError();
}

template <Table T, typename TX, typename TD, bool HALO>
static int tv_dual_spec_launch(const Params* p, const void* x, void* yD,
                               void* parts, cudaStream_t s) {
  const int vec = p->Nc % VEC_TV == 0 && aligned(x, VEC_TV * sizeof(TX)) &&
                  aligned(yD, VEC_TV * sizeof(TD));
  const dim3 grid = dual_grid<VEC_TV>(p);
  tv_dual_spec_kernel<T, TX, TD, HALO><<<grid, BLOCK, 0, s>>>(
      *p, (const TX*)x, (TD*)yD, (float*)parts, vec);
  return (int)cudaGetLastError();
}

template <Table T, bool HALO>
static int tv_norms_spec_table(const Params* p, int x_bf16, const void* x,
                               const void* tmul, void* norms, void* parts,
                               cudaStream_t s) {
  if (x_bf16)
    return tv_norms_spec_launch<T, __nv_bfloat16, HALO>(p, x, tmul, norms,
                                                        parts, s);
  return tv_norms_spec_launch<T, float, HALO>(p, x, tmul, norms, parts, s);
}

template <Table T, bool HALO>
static int tv_dual_spec_table(const Params* p, int x_bf16, int d_bf16,
                              const void* x, void* yD, void* parts,
                              cudaStream_t s) {
  typedef __nv_bfloat16 B;
  if (!x_bf16 && !d_bf16)
    return tv_dual_spec_launch<T, float, float, HALO>(p, x, yD, parts, s);
  if (!x_bf16)
    return tv_dual_spec_launch<T, float, B, HALO>(p, x, yD, parts, s);
  if (!d_bf16)
    return tv_dual_spec_launch<T, B, float, HALO>(p, x, yD, parts, s);
  return tv_dual_spec_launch<T, B, B, HALO>(p, x, yD, parts, s);
}

extern "C" {

// Number of TV partials each pass writes for an (Nz, M, Nr, Nc) volume (in
// the halo mode: shard): pass 1 one per block (a tile and a line of
// planes), pass A one per block of BLOCK runs of VEC_TV columns.
long long spectv_norms_num_parts(int Nz, int M, int Nr, int Nc) {
  return (long long)norms_tiles(Nr, Nc) * norms_lines(Nz, M);
}
// The halo launches write as many partials at the shard's shape as the
// unsharded ones.  kernels/fused.py::_num_parts_name finds a launch's count
// by the launch's name (<launch>_num_parts, else spectv_halo_num_parts,
// else spectv_num_parts), so each launch has a count of its own name.
long long spectv_norms_halo_num_parts(int Nz, int M, int Nr, int Nc) {
  return spectv_norms_num_parts(Nz, M, Nr, Nc);
}
long long spectv_dual_num_parts(int Nz, int M, int Nr, int Nc) {
  return dual_num_parts<VEC_TV>(Nz, M, Nr, Nc);
}
long long spectv_dual_halo_num_parts(int Nz, int M, int Nr, int Nc) {
  return spectv_dual_num_parts(Nz, M, Nr, Nc);
}

// Each launches table `id` of csrc/tables.cuh and returns cudaGetLastError()
// after the launch (0 = cudaSuccess), or cudaErrorInvalidValue for an id
// outside the list (or, for the halo mode, Params that do not describe a
// shard's extended x).
int spectv_norms_launch(const Params* p, int id, int x_bf16, const void* x,
                        const void* tmul, void* norms, void* parts,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (id) {
#define SPEC_CASE(id, code)                                                 \
  case id:                                                                  \
    return tv_norms_spec_table<code, false>(p, x_bf16, x, tmul, norms,      \
                                            parts, s);
    CHANNEL_TABLES(SPEC_CASE)
#undef SPEC_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Pass 1 in the halo mode: x (Nz+2, M+2, Nr, Nc) of a shard whose norms are
// (Nz, M, Nr, Nc), Params with sharded, t_free and xe = 1.
int spectv_norms_halo_launch(const Params* p, int id, int x_bf16,
                             const void* x, const void* tmul, void* norms,
                             void* parts, void* stream) {
  if (!p->sharded || !p->t_free || p->xe != 1)
    return (int)cudaErrorInvalidValue;
  // the halo mode marches along t (a variant of this source that marches
  // otherwise, tools/torch_probe_spec.py's, has no halo mode)
  if constexpr (MARCH == AX_T) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (id) {
#define SPEC_CASE(id, code)                                                 \
  case id:                                                                  \
    return tv_norms_spec_table<code, true>(p, x_bf16, x, tmul, norms,       \
                                           parts, s);
      CHANNEL_TABLES(SPEC_CASE)
#undef SPEC_CASE
    }
  }
  return (int)cudaErrorInvalidValue;
}

int spectv_dual_launch(const Params* p, int id, int x_bf16, int d_bf16,
                       const void* x, void* yD, void* parts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (id) {
#define SPEC_CASE(id, code)                                                 \
  case id:                                                                  \
    return tv_dual_spec_table<code, false>(p, x_bf16, d_bf16, x, yD, parts, \
                                           s);
    CHANNEL_TABLES(SPEC_CASE)
#undef SPEC_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Pass A in the halo mode: x (Nz+2, M+2, Nr, Nc) of a shard whose y_D is
// (Nz, M, Nd, Nr, Nc), Params with sharded, t_free and xe = 1 and no time
// multiplier (the TPU kernel takes none).
int spectv_dual_halo_launch(const Params* p, int id, int x_bf16, int d_bf16,
                            const void* x, void* yD, void* parts,
                            void* stream) {
  if (!p->sharded || !p->t_free || p->xe != 1 || p->has_tmul)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (id) {
#define SPEC_CASE(id, code)                                                 \
  case id:                                                                  \
    return tv_dual_spec_table<code, true>(p, x_bf16, d_bf16, x, yD, parts,  \
                                          s);
    CHANNEL_TABLES(SPEC_CASE)
#undef SPEC_CASE
  }
  return (int)cudaErrorInvalidValue;
}

const char* spectv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
