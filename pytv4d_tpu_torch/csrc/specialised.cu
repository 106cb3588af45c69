// CP passes A (B1) and B (B2) on an unsharded volume and TV pass 2 (B4) on
// an unsharded volume and in the halo mode of a (z, t)-sharded solve,
// specialised for one channel table of csrc/tables.cuh, for NVIDIA Hopper
// (sm_90a).
//
// Replace the Pallas TPU kernels of pytv4d_tpu/kernels/fused.py:
//   cp_dual_spec_kernel    <- make_cp_dual_kernel    (pass A, fused.py:652;
//                                                     unsharded launches)
//   cp_primal_spec_kernel  <- make_cp_primal_kernel  (pass B, fused.py:859;
//                                                     unsharded launches)
//   tv_subgrad_spec_kernel <- make_tv_subgrad_kernel (pass 2, fused.py:1473;
//                                                     unsharded and halo mode;
//                                                     unsharded also with the
//                                                     GD step's epilogue)
// CP passes A and B in their sharded modes are specialised the same way in
// csrc/specialised_cp.cu, TV pass 1 (B3) and pass A for inverse problems
// (B5) in csrc/specialised_tv.cu, and the sharded step's boundary passes
// (B8) in csrc/cp_boundary.cu, which share specialised.cuh with this
// source.
//
// What bounds them: the generic bodies spent their time on per-channel
// work, not bytes (a runtime switch on each channel's axis and kind, 64-bit
// stride products, loads repeated per channel).  Here:
//   - the table is a template argument: the channel loops unroll at compile
//     time, with no runtime axis or kind;
//   - an offset within a plane is 32-bit (Offset: a plane holds < 2^31
//     voxels, kernels/fused.py::fits_kernel), the stride from one plane
//     to another 64-bit, so any volume the card holds is indexed with
//     32-bit index arithmetic per load (tools/torch_probe_spec.py times a
//     variant with 64-bit offsets);
//   - pass A takes VEC = 2 consecutive columns per thread: one 8-byte (f32)
//     or 4-byte (bf16) access per array and per dual channel, half the
//     index arithmetic per voxel.  Four columns (16-byte accesses) held up
//     to 108 registers for the hybrid 4D table and ran slower on an H100
//     (tools/torch_probe_spec.py builds that variant);
//   - pass B keeps no prox state (31-52 registers at four columns), so it
//     takes VEC_B = 4 consecutive columns per thread: one 16-byte (f32) or
//     8-byte (bf16) access per array and per dual channel, twice the bytes
//     in flight of two columns, which bf16 storage needs to come near its
//     bound (tools/torch_probe_spec.py's `primal` part times 2 against 4 in
//     each storage pair);
//   - pass 2 loads each value of x and of the norms it needs once: the row
//     and column neighbours from a shared tile of the block's TILE_R x
//     TILE_C pixels with a halo (+-1, +-2 for central), the z and t ones
//     from global memory, and forms each axis's differences once; a thread
//     takes RPT = 2 rows, whose z and t loads it issues before the tile's
//     barrier.
//
// Pass 2 with the GD epilogue (GD; solvers/gd.py's fused step) takes the
// subgradient-descent step where G is formed instead of storing G: each
// thread rounds g to x's dtype, reads x0 at the voxel and writes x' =
// x - step ((x - x0) + reg g) to a fresh buffer (the stencil still reads
// x's neighbours), in the order of the eager update's five torch ops and,
// in bf16 storage, rounded to bf16 after each of them as they round; then
// one fidelity partial per block of fid_scale (x' - x0)^2 (rounded as
// torch.square of the bf16 difference rounds).  Params::tau is the step
// and Params::reg the weight of G.  So x' equals the eager update's on
// the standalone pass's G to the bit, and G is never stored.
//
// Pass 2 in the halo mode (HALO; one shard of parallel/fused_halo.py's
// sharded TV) is the same kernel on the extended operands: x extended by
// Params::xe = 2 planes per side in z and t, the norms by ne = 1, both
// holding the neighbour shards' planes or, at the volume's edge, ghost
// planes that zero every difference across it (and safe divisors); the z
// and t gates are off, so every z and t neighbour is read from them, and G
// keeps the shard's shape.  The table is the whole volume's
// (kernels/fused.py passes its id from table_dims).
//
// The arithmetic is the generic bodies' operation for operation and in the
// same order (voxel.cuh: weighted_d and tv_dual_prox for pass A,
// cp_primal_voxel for pass B, chan_y and tv_subgrad_voxel for pass 2;
// -fmad=false), so y_A', y_D', x' and G equal theirs to the bit, and a
// shard's G equals the unsharded kernel's on the same voxels of the
// gathered volume.  The TV partials of pass A and the fidelity partials of
// pass B are one per block of BLOCK runs of their columns (block_sum, no
// atomics): the loss moves only by the order of a sum.
//
// Bound to Python through the plain C interface at the end (ctypes,
// kernels/fused.py::_spec_launch); nvcc compiles the kernels of this one
// source in parallel (-split-compile, kernels/build.py).

#include "specialised.cuh"

constexpr int VEC = 2;             // pass A: columns per thread
constexpr int VEC_B = 4;           // pass B: columns per thread
constexpr int TILE_C = 32;         // pass 2: a block's tile of its plane is
constexpr int TILE_T = BLOCK / TILE_C;  // TILE_C columns by TILE_R rows,
constexpr int RPT = 2;             // each thread taking RPT of them
constexpr int TILE_R = TILE_T * RPT;

// ------------------------------------------------------- pass A (B1)
// specialised.cuh's dual_spec_body with the fidelity dual.
template <Table T, typename TX, typename TD>
__global__ void __launch_bounds__(BLOCK)
cp_dual_spec_kernel(const Params p, const TX* __restrict__ x,
                    const TX* __restrict__ x0, TX* __restrict__ yA,
                    TD* __restrict__ yD, const float* __restrict__ tmul,
                    float* __restrict__ parts, int vec) {
  dual_spec_plane<T, VEC, true>(p, x, x0, yA, yD, tmul, parts, vec);
}

// ------------------------------------------------------- pass B (B2)
// specialised.cuh's primal_spec_body on plane blockIdx.y, both gates on;
// the dual's z neighbours lie M planes of the dual (M Nd planes of a
// channel) either side, as pass A's lie M planes of x away
// (dual_spec_plane), and are read only behind the z gate.  x' goes to
// `out`, x itself (in place) or a second buffer, and x0 may be x (the
// inverse solver's step), so none of the three is __restrict__.  One
// fidelity partial per block, at parts[blockIdx.y][blockIdx.x].
template <Table T, typename TX, typename TD>
__global__ void __launch_bounds__(BLOCK)
cp_primal_spec_kernel(const Params p, const TX* x, const TX* x0,
                      const TX* __restrict__ yA, const TD* __restrict__ yD,
                      const float* __restrict__ tmul, TX* out,
                      float* __restrict__ parts, int vec) {
  const int zt = blockIdx.y, z = zt / p.M, t = zt - z * p.M;
  const int64_t dplane = (int64_t)tab_nd(T) * p.Nr * p.Nc,
                zs = p.M * dplane;
  const TD* yz = yD + zt * dplane;
  const float s = primal_spec_body<T, VEC_B, TX, TD>(
      p, z, t, z, p.Nz, t, p.M, x, x0, yA, yz, yz - zs, yz + zs, tmul, out,
      vec);
  if (threadIdx.x == 0)
    parts[(int64_t)zt * gridDim.x + blockIdx.x] = p.fid_scale * s;
}

// ------------------------------------------------------- pass 2 (B4)
// spec_y and subgrad_at (tv_subgrad_voxel at one voxel) are in
// specialised.cuh.

// v as a torch op on TX storage leaves it: rounded to bf16 in bf16
// storage, as it is in float32.
template <typename TX>
__device__ __forceinline__ float as_stored(float v) {
  if constexpr (sizeof(TX) == 2)
    return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// The block's tile of plane zt (blockIdx.y) is TILE_C columns by TILE_R =
// TILE_T x RPT rows; the tiles of a plane run along blockIdx.x, row-major.
// Thread (tx, ty) takes the RPT voxels of column tx at rows ty + k TILE_T.
// Their z and t neighbours (and with GD, x0) are loaded before the tile's
// barrier, so that the two sets of loads are in flight together.  With
// HALO, x and the norms are the extended operands (x by 2 planes per side
// in z and t, the norms by 1) and the z and t gates are off; G has the
// shard's shape.  `out` receives G, or with GD x'; x0 and the partials
// (one per block, at parts[blockIdx.y][blockIdx.x]) are read and written
// with GD only.  x0 may be x (the first step from x_init = x0), so it is
// not __restrict__.
template <Table T, typename TX, bool HALO, bool GD>
__global__ void __launch_bounds__(BLOCK)
tv_subgrad_spec_kernel(const Params p, const TX* __restrict__ x,
                       const TX* x0, const float* __restrict__ norms,
                       const float* __restrict__ tmul, TX* __restrict__ out,
                       float* __restrict__ parts) {
  static_assert(!(HALO && GD), "the GD epilogue runs on a whole volume");
  // x out to +-2 along rows and columns for central, else +-1; norms +-1
  constexpr int H = tab_has(T, AX_ROW, K_CTR) || tab_has(T, AX_COL, K_CTR)
                        ? 2 : 1;
  constexpr int XR = TILE_R + 2 * H, XC = TILE_C + 2 * H;
  constexpr int NR = TILE_R + 2, NC = TILE_C + 2;
  __shared__ float xs[XR][XC];
  __shared__ float ns[NR][NC];
  const int tiles_c = (p.Nc + TILE_C - 1) / TILE_C;
  const int tr = blockIdx.x / tiles_c;
  const int r0 = tr * TILE_R, c0 = (blockIdx.x - tr * tiles_c) * TILE_C;
  const int zt = blockIdx.y;
  const int z = zt / p.M, t = zt - z * p.M;
  const int ty = threadIdx.x / TILE_C, tx = threadIdx.x % TILE_C;
  const int c = c0 + tx;
  const bool aniso = p.norm == N_ANISO;
  // this plane's base in x, in the norms and in G, and the strides to its
  // z neighbours' in x and in the norms (64-bit; a t neighbour is a plane)
  const int64_t plane = (int64_t)p.Nr * p.Nc, base = zt * plane;
  const TX* xb = x + (HALO ? ext_plane(p, z, t, 2) * plane : base);
  const float* nb =
      aniso ? nullptr : norms + (HALO ? ext_plane(p, z, t, 1) * plane : base);
  const int64_t xsz = (HALO ? p.M + 4 : p.M) * plane;
  const int64_t nsz = (HALO ? p.M + 2 : p.M) * plane;
  // the z and t gates: off in the halo mode (position 2 of 5, which every
  // gate passes: specialised.cuh's dual_spec_run)
  const int zpos = HALO ? 2 : z, zlen = HALO ? 5 : p.Nz;
  const int tpos = HALO ? 2 : t, tlen = HALO ? 5 : p.M;

  // z and t: x at slots -2..2 and the norms at -1, +1 of each voxel
  float xm2[RPT][4] = {}, xm1[RPT][4] = {}, xp1[RPT][4] = {};
  float xp2[RPT][4] = {}, nm1[RPT][4] = {}, np1[RPT][4] = {};
  float x0v[RPT] = {};
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = r0 + ty + k * TILE_T;
    if (r >= p.Nr || c >= p.Nc) continue;
    const Offset q = (Offset)r * p.Nc + c;
    if constexpr (GD) x0v[k] = ld(x0 + base, q);
#pragma unroll
    for (int a = AX_Z; a <= AX_T; ++a) {
      const int64_t s = a == AX_Z ? xsz : plane;
      const int64_t sn = a == AX_Z ? nsz : plane;
      const bool fb = tab_has(T, a, K_FWD) || tab_has(T, a, K_BWD);
      const bool ctr = tab_has(T, a, K_CTR);
      const int ps = a == AX_Z ? zpos : tpos, ln = a == AX_Z ? zlen : tlen;
      if (fb && ps >= 1) xm1[k][a] = ld(xb - s, q);
      if (fb && ps <= ln - 2) xp1[k][a] = ld(xb + s, q);
      if (ctr && ps >= 2) xm2[k][a] = ld(xb - 2 * s, q);
      if (ctr && ps <= ln - 3) xp2[k][a] = ld(xb + 2 * s, q);
      if (!aniso && (tab_has(T, a, K_FWD) || ctr) && ps >= 1)
        nm1[k][a] = (nb - sn)[q];
      if (!aniso && (tab_has(T, a, K_BWD) || ctr) && ps <= ln - 2)
        np1[k][a] = (nb + sn)[q];
    }
  }
  // rows and columns: the tile and its halo (zeros outside the plane)
  for (int e = threadIdx.x; e < XR * XC; e += BLOCK) {
    const int rr = r0 - H + e / XC, cc = c0 - H + e % XC;
    xs[e / XC][e % XC] = rr >= 0 && rr < p.Nr && cc >= 0 && cc < p.Nc
                             ? ld(xb, (Offset)rr * p.Nc + cc) : 0.f;
  }
  if (!aniso)
    for (int e = threadIdx.x; e < NR * NC; e += BLOCK) {
      const int rr = r0 - 1 + e / NC, cc = c0 - 1 + e % NC;
      ns[e / NC][e % NC] = rr >= 0 && rr < p.Nr && cc >= 0 && cc < p.Nc
                               ? nb[(Offset)rr * p.Nc + cc] : 0.f;
    }
  __syncthreads();

  float fid = 0.f;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int ry = ty + k * TILE_T, r = r0 + ry;  // ry: the row in the tile
    if (r >= p.Nr || c >= p.Nc) continue;
    const Offset q = (Offset)r * p.Nc + c;
    const int pos[4] = {zpos, tpos, r, c}, len[4] = {zlen, tlen, p.Nr, p.Nc};
    xm1[k][AX_ROW] = xs[ry + H - 1][tx + H];
    xp1[k][AX_ROW] = xs[ry + H + 1][tx + H];
    xm1[k][AX_COL] = xs[ry + H][tx + H - 1];
    xp1[k][AX_COL] = xs[ry + H][tx + H + 1];
    if constexpr (H == 2) {
      xm2[k][AX_ROW] = xs[ry][tx + H];
      xp2[k][AX_ROW] = xs[ry + 4][tx + H];
      xm2[k][AX_COL] = xs[ry + H][tx];
      xp2[k][AX_COL] = xs[ry + H][tx + 4];
    }
    if (!aniso) {
      nm1[k][AX_ROW] = ns[ry][tx + 1];
      np1[k][AX_ROW] = ns[ry + 2][tx + 1];
      nm1[k][AX_COL] = ns[ry + 1][tx];
      np1[k][AX_COL] = ns[ry + 1][tx + 2];
    }
    const float xc = xs[ry + H][tx + H];
    const float g = subgrad_at<T>(p, pos, len, xc,
                                  aniso ? 0.f : ns[ry + 1][tx + 1], xm2[k],
                                  xm1[k], xp1[k], xp2[k], nm1[k], np1[k],
                                  p.has_tmul ? tmul[q] : 1.f);
    if constexpr (GD) {
      // xs - step ((xs - x0) + reg g), one rounding an op
      const float gs = as_stored<TX>(g);
      const float dx = as_stored<TX>(xc - x0v[k]);
      const float rg = as_stored<TX>(gs * p.reg);
      const float sum = as_stored<TX>(dx + rg);
      const float stp = as_stored<TX>(p.tau * sum);
      const float xn = as_stored<TX>(xc - stp);
      st(out + base, q, xn);
      const float e = as_stored<TX>(xn - x0v[k]);
      fid += as_stored<TX>(e * e);
    } else {
      st(out + base, q, g);
    }
  }
  if constexpr (GD) {
    const float s = block_sum(fid);
    if (threadIdx.x == 0)
      parts[(int64_t)zt * gridDim.x + blockIdx.x] = p.fid_scale * s;
  }
}

// ------------------------------------------------------------- launches
template <Table T, typename TX, typename TD>
static int cp_dual_spec_launch(const Params* p, const void* x, const void* x0,
                               void* yA, void* yD, const void* tmul,
                               void* parts, cudaStream_t stream) {
  // no separate output: y_A stands in for it
  const int vec = runs_aligned<VEC, TX, TD>(p, x, x0, yA, yD, yA, tmul);
  const dim3 grid = dual_grid<VEC>(p);
  cp_dual_spec_kernel<T, TX, TD><<<grid, BLOCK, 0, stream>>>(
      *p, (const TX*)x, (const TX*)x0, (TX*)yA, (TD*)yD, (const float*)tmul,
      (float*)parts, vec);
  return (int)cudaGetLastError();
}

template <Table T>
static int cp_dual_spec_table(const Params* p, int x_bf16, int d_bf16,
                              const void* x, const void* x0, void* yA,
                              void* yD, const void* tmul, void* parts,
                              cudaStream_t s) {
  typedef __nv_bfloat16 B;
  if (!x_bf16 && !d_bf16)
    return cp_dual_spec_launch<T, float, float>(p, x, x0, yA, yD, tmul, parts,
                                                s);
  if (!x_bf16)
    return cp_dual_spec_launch<T, float, B>(p, x, x0, yA, yD, tmul, parts, s);
  if (!d_bf16)
    return cp_dual_spec_launch<T, B, float>(p, x, x0, yA, yD, tmul, parts, s);
  return cp_dual_spec_launch<T, B, B>(p, x, x0, yA, yD, tmul, parts, s);
}

template <Table T, typename TX, typename TD>
static int cp_primal_spec_launch(const Params* p, const void* x,
                                 const void* x0, const void* yA,
                                 const void* yD, const void* tmul, void* out,
                                 void* parts, cudaStream_t stream) {
  const int vec = runs_aligned<VEC_B, TX, TD>(p, x, x0, yA, yD, out, tmul);
  const dim3 grid = dual_grid<VEC_B>(p);
  cp_primal_spec_kernel<T, TX, TD><<<grid, BLOCK, 0, stream>>>(
      *p, (const TX*)x, (const TX*)x0, (const TX*)yA, (const TD*)yD,
      (const float*)tmul, (TX*)out, (float*)parts, vec);
  return (int)cudaGetLastError();
}

template <Table T>
static int cp_primal_spec_table(const Params* p, int x_bf16, int d_bf16,
                                const void* x, const void* x0,
                                const void* yA, const void* yD,
                                const void* tmul, void* out, void* parts,
                                cudaStream_t s) {
  typedef __nv_bfloat16 B;
  if (!x_bf16 && !d_bf16)
    return cp_primal_spec_launch<T, float, float>(p, x, x0, yA, yD, tmul,
                                                  out, parts, s);
  if (!x_bf16)
    return cp_primal_spec_launch<T, float, B>(p, x, x0, yA, yD, tmul, out,
                                              parts, s);
  if (!d_bf16)
    return cp_primal_spec_launch<T, B, float>(p, x, x0, yA, yD, tmul, out,
                                              parts, s);
  return cp_primal_spec_launch<T, B, B>(p, x, x0, yA, yD, tmul, out, parts,
                                        s);
}

// Pass 2's blocks along a plane: its TILE_R x TILE_C tiles.
static inline long long subgrad_tiles(int Nr, int Nc) {
  return (long long)((Nc + TILE_C - 1) / TILE_C) *
         ((Nr + TILE_R - 1) / TILE_R);
}

template <Table T, typename TX, bool HALO, bool GD>
static int tv_subgrad_spec_launch(const Params* p, const void* x,
                                  const void* x0, const void* norms,
                                  const void* tmul, void* out, void* parts,
                                  cudaStream_t s) {
  const dim3 grid((unsigned)subgrad_tiles(p->Nr, p->Nc),
                  (unsigned)(p->Nz * p->M));
  tv_subgrad_spec_kernel<T, TX, HALO, GD><<<grid, BLOCK, 0, s>>>(
      *p, (const TX*)x, (const TX*)x0, (const float*)norms,
      (const float*)tmul, (TX*)out, (float*)parts);
  return (int)cudaGetLastError();
}

template <Table T, bool HALO, bool GD>
static int tv_subgrad_spec_table(const Params* p, int x_bf16, const void* x,
                                 const void* x0, const void* norms,
                                 const void* tmul, void* out, void* parts,
                                 cudaStream_t s) {
  if (x_bf16)
    return tv_subgrad_spec_launch<T, __nv_bfloat16, HALO, GD>(
        p, x, x0, norms, tmul, out, parts, s);
  return tv_subgrad_spec_launch<T, float, HALO, GD>(p, x, x0, norms, tmul,
                                                    out, parts, s);
}

extern "C" {

// Number of TV partials pass A writes for an (Nz, M, Nr, Nc) volume: one per
// block of BLOCK runs of VEC columns.
long long spec_num_parts(int Nz, int M, int Nr, int Nc) {
  return dual_num_parts<VEC>(Nz, M, Nr, Nc);
}

// ... and the fidelity partials pass B writes: one per block of BLOCK runs
// of VEC_B columns.
long long spec_cp_primal_num_parts(int Nz, int M, int Nr, int Nc) {
  return dual_num_parts<VEC_B>(Nz, M, Nr, Nc);
}

// ... and the fidelity partials pass 2 writes with the GD epilogue: one per
// block, a block a TILE_R x TILE_C tile of a plane.
long long spec_tv_gd_num_parts(int Nz, int M, int Nr, int Nc) {
  return subgrad_tiles(Nr, Nc) * Nz * M;
}

// Each launches table `id` of csrc/tables.cuh and returns cudaGetLastError()
// after the launch (0 = cudaSuccess), or cudaErrorInvalidValue for an id
// outside the list (or, for pass B, Params of a shard, and for the halo
// mode, Params that do not describe a shard's extended operands).
int spec_cp_dual_launch(const Params* p, int id, int x_bf16, int d_bf16,
                        const void* x, const void* x0, void* yA, void* yD,
                        const void* tmul, void* parts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (id) {
#define SPEC_CASE(id, code)                                                 \
  case id:                                                                  \
    return cp_dual_spec_table<code>(p, x_bf16, d_bf16, x, x0, yA, yD, tmul, \
                                    parts, s);
    CHANNEL_TABLES(SPEC_CASE)
#undef SPEC_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Pass B on an unsharded volume: x' = x - tau y_A' - tau D^T y_D' (then
// max(x', 0) under nonneg) into `out`, which is x itself (in place) or a
// second buffer; a shard's pass B is csrc/specialised_cp.cu's.
int spec_cp_primal_launch(const Params* p, int id, int x_bf16, int d_bf16,
                          const void* x, const void* x0, const void* yA,
                          const void* yD, const void* tmul, void* out,
                          void* parts, void* stream) {
  if (p->sharded) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (id) {
#define SPEC_CASE(id, code)                                                 \
  case id:                                                                  \
    return cp_primal_spec_table<code>(p, x_bf16, d_bf16, x, x0, yA, yD,     \
                                      tmul, out, parts, s);
    CHANNEL_TABLES(SPEC_CASE)
#undef SPEC_CASE
  }
  return (int)cudaErrorInvalidValue;
}

int spec_tv_subgrad_launch(const Params* p, int id, int x_bf16,
                           const void* x, const void* norms, const void* tmul,
                           void* g, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (id) {
#define SPEC_CASE(id, code)                                                 \
  case id:                                                                  \
    return tv_subgrad_spec_table<code, false, false>(                       \
        p, x_bf16, x, nullptr, norms, tmul, g, nullptr, s);
    CHANNEL_TABLES(SPEC_CASE)
#undef SPEC_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Pass 2 with the GD epilogue on an unsharded volume: x' = x - tau ((x - x0)
// + reg G) into `out`, a buffer other than x (x0 may be x), and the
// fidelity partials of x' (spec_tv_gd_num_parts of them, times fid_scale).
int spec_tv_gd_launch(const Params* p, int id, int x_bf16, const void* x,
                      const void* x0, const void* norms, const void* tmul,
                      void* out, void* parts, void* stream) {
  if (p->sharded || out == x) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (id) {
#define SPEC_CASE(id, code)                                                 \
  case id:                                                                  \
    return tv_subgrad_spec_table<code, false, true>(p, x_bf16, x, x0, norms,\
                                                    tmul, out, parts, s);
    CHANNEL_TABLES(SPEC_CASE)
#undef SPEC_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Pass 2 in the halo mode: x (Nz+4, M+4, Nr, Nc) and the norms (Nz+2, M+2,
// Nr, Nc) of a shard whose G is (Nz, M, Nr, Nc), Params with sharded,
// t_free, xe = 2 and ne = 1.
int spec_tv_subgrad_halo_launch(const Params* p, int id, int x_bf16,
                                const void* x, const void* norms,
                                const void* tmul, void* g, void* stream) {
  if (!p->sharded || !p->t_free || p->xe != 2 || p->ne != 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (id) {
#define SPEC_CASE(id, code)                                                 \
  case id:                                                                  \
    return tv_subgrad_spec_table<code, true, false>(                        \
        p, x_bf16, x, nullptr, norms, tmul, g, nullptr, s);
    CHANNEL_TABLES(SPEC_CASE)
#undef SPEC_CASE
  }
  return (int)cudaErrorInvalidValue;
}

const char* spec_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
