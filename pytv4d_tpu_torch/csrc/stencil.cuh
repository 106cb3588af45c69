// Device code shared by the kernels specialised per channel table
// (csrc/specialised.cuh) and csrc/resident.cu (whole CP and GD solves):
// the launch parameter struct, bf16/f32 loads and stores, the geometry of one
// stencil axis at a voxel, the weighted D channels of x and a deterministic
// block sum.  The per-voxel bodies of the passes are in voxel.cuh, the
// boundary kernels of the sharded CP step in csrc/cp_boundary.cu.
//
// The per-launch kernels run 1-D blocks of BLOCK threads along a (z, t)
// plane of the row-major (Nz, M, Nr, Nc) volume (a voxel or a run of
// columns a thread); blockIdx.y is the plane.  Each thread gates its own
// global index against the one-sided zero-slot boundary of
// core/schemes.py:
//   FWD d[i] = f[i+1] - f[i]    valid at slots [0, L-2]
//   BWD d[i] = f[i]   - f[i-1]  valid at slots [1, L-1]
//   CTR d[i] = f[i+1] - f[i-1]  valid at slots [1, L-2]
//
// The sharded solvers (parallel/fused_halo.py) run the same arithmetic on
// one shard of a (z, t) grid of shards.  There a neighbour along z (and t)
// lies in a ghost or exchanged plane: the kernels' sharded instances (the
// per-table kernels' HALO and interior instances, csrc/specialised*.cu, and
// the boundary kernels of csrc/cp_boundary.cu) read the last fields of
// Params -- gates off along z (and t), x, the dual or the norms extended by
// planes on each side, a range of computed planes.  The unsharded kernels
// do not read those fields.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define BLOCK 256
#define MAX_CH 8

enum { AX_Z = 0, AX_T = 1, AX_ROW = 2, AX_COL = 3 };
enum { K_FWD = 0, K_BWD = 1, K_CTR = 2 };
enum { N_ISO = 0, N_ANISO = 1, N_HUBER = 2 };
enum { F_L2 = 0, F_L1 = 1, F_KL = 2 };

// Mirrored field for field by kernels/fused.py::_Params (all 4-byte fields).
struct Params {
  int Nz, M, Nr, Nc, Nd;
  int axis[MAX_CH];      // AX_*
  int kind[MAX_CH];      // K_*
  float w[MAX_CH];       // channel weight x scheme normalisation
  int norm;              // N_*
  int fidelity;          // F_*
  int nonneg;
  int has_tmul;          // time channels x tmul[(r, c)]
  float sigma_D, sigma_A, reg, tau, fid_weight, huber_delta;
  float fid_den;         // l2: 1 + sigma_A / fid_weight
  float kl_c;            // kl: 4 sigma_A fid_weight
  float huber_den;       // huber: 1 + sigma_D huber_delta / reg
  float fid_scale;       // l2: fid_weight / 2, else fid_weight
  float scheme_norm;     // the scheme normalisation (hybrid 1/sqrt 2, ...)
  // Read by the sharded instances only (one shard of a sharded solve: the
  // HALO and interior instances of csrc/specialised*.cu and the boundary
  // kernels; Nz and M above are the shard's, the channel table the whole
  // volume's):
  int sharded;           // z is not gated: every z neighbour is in the arrays
                         // handed in, a ghost plane standing for a global edge
  int t_free;            // t is not gated either
  int xe, ye, ne;        // planes by which x, the dual read at neighbour
                         // slots and the norms are extended per side in z, t
  int z_first, z_last;   // the planes the launch computes
};

__device__ __forceinline__ float ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Position, length and element stride of axis `a` at voxel (z, t, r, c) of
// an unsharded volume; `chan_stride` is Nd for the channel-contiguous dual,
// 1 for x.
__device__ __forceinline__ void axis_geom(const Params& p, int a, int z,
                                          int t, int r, int c,
                                          int64_t chan_stride, int& pos,
                                          int& len, int64_t& s) {
  const int64_t plane = (int64_t)p.Nr * p.Nc;
  switch (a) {
    case AX_Z: pos = z; len = p.Nz; s = (int64_t)p.M * chan_stride * plane; break;
    case AX_T: pos = t; len = p.M; s = chan_stride * plane; break;
    case AX_ROW: pos = r; len = p.Nr; s = p.Nc; break;
    default: pos = c; len = p.Nc; s = 1; break;
  }
}

// Every weighted D channel of x at voxel xi (value xc): d[i] is the
// difference of channel i, 0 at its invalid slots, times tm on time
// channels, times w[i].  d[i] = 0 for i >= Nd.  With ZREG the z neighbours
// of the voxel are the values xzm (z - 1) and xzp (z + 1) the caller holds
// in registers, and x is read only along t, rows and columns.
template <bool ZREG = false, typename TX>
__device__ __forceinline__ void weighted_d(const Params& p, const TX* x,
                                           int64_t xi, float xc, int z, int t,
                                           int r, int c, float tm,
                                           float (&d)[MAX_CH],
                                           float xzm = 0.f, float xzp = 0.f) {
#pragma unroll
  for (int i = 0; i < MAX_CH; ++i) {
    d[i] = 0.f;
    if (i < p.Nd) {
      int pos, len;
      int64_t s;
      axis_geom(p, p.axis[i], z, t, r, c, 1, pos, len, s);
      float v;
      if (ZREG && p.axis[i] == AX_Z) {
        if (p.kind[i] == K_FWD)
          v = pos < len - 1 ? xzp - xc : 0.f;
        else if (p.kind[i] == K_BWD)
          v = pos > 0 ? xc - xzm : 0.f;
        else
          v = (pos > 0 && pos < len - 1) ? xzp - xzm : 0.f;
      } else if (p.kind[i] == K_FWD)
        v = pos < len - 1 ? ld(x, xi + s) - xc : 0.f;
      else if (p.kind[i] == K_BWD)
        v = pos > 0 ? xc - ld(x, xi - s) : 0.f;
      else
        v = (pos > 0 && pos < len - 1) ? ld(x, xi + s) - ld(x, xi - s) : 0.f;
      if (p.axis[i] == AX_T) v = v * tm;
      d[i] = v * p.w[i];
    }
  }
}

// Sum of `v` over the block, valid in thread 0; every thread must call it.
// A fixed order (warp shuffles, then one warp): no float atomics, so two
// runs give the same bits.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[BLOCK / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) warp_sums[wid] = v;
  __syncthreads();
  v = 0.f;
  if (wid == 0) {
    v = lane < BLOCK / 32 ? warp_sums[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// Number of partials of an array with one slot per BLOCK voxels of each
// (z, t) plane: the overlapped sharded step's (csrc/cp_boundary.cu and the
// interior launches of csrc/specialised_cp.cu fill it).
static inline long long num_parts(int Nz, int M, int Nr, int Nc) {
  const int64_t plane = (int64_t)Nr * Nc;
  return ((plane + BLOCK - 1) / BLOCK) * (int64_t)Nz * M;
}
