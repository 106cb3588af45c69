// Whole-solve TGV-2 kernel for NVIDIA Hopper (sm_90a) with each slice's state
// on chip: every Chambolle-Pock iteration of the in-plane (2d) mode in ONE
// launch, the state of a (z, t) slice held in the shared memory of one
// thread-block cluster for the whole solve.  Bound to Python through a plain
// C interface (ctypes).
//
// Replaces the Pallas TPU kernel
// pytv4d_tpu/kernels/tgv_resident.py::make_resident_tgv_solver (:58), which
// kept one slice's 12 planes of state in VMEM for all iterations.  This is
// the same design on Hopper: a slice's state never leaves the chip, HBM sees
// x0 once and the final state once.
//
// What bounds it.  The 2d iteration does ~103 float operations a pixel and
// reads only +-1 row and column neighbours, so with the state in HBM (the L2
// kernel of csrc/tgv_resident.cu) it moves 12 planes a pixel each iteration:
// at 256 slices of 256 x 256 that ran at the HBM rate (0.80 ms/it with the
// loss).  On chip, instruction issue: an iteration's instructions
// (tools/torch_probe_tgv_resident.py lists them by phase) are mostly the
// IEEE divisions and square roots with their slow-path branches, the norm
// switch and the shared-memory addressing around ~48 shared accesses a
// pixel; 4096 pixels an SM at 256 x 256 take 9.7 us/it with the loss, 7.3
// without, at one slice; and the card holds 7 clusters of 16 blocks at once
// (cudaOccupancyMaxActiveClusters), so 256 slices take 37 waves: 0.36
// ms/it, 0.26 without the loss (NVIDIA H100 80GB HBM3, 700.00 W;
// chip_smoke.py phase 14 and tools/torch_probe_tgv_resident.py, PERF.md
// section 6).
//
// Design:
// - One cluster of C blocks per slice, C the smallest of 1, 2, 4, 8, 16 whose
//   blocks hold the slice (kernels/tgv_resident.py::onchip_band; C = 16 is a
//   non-portable size).  Block b owns the band of rows [b R, min((b+1) R, Nr)),
//   R = ceil(Nr / C).
// - The band's neighbour-read planes live in dynamic shared memory, `plane`
//   = R * Nc floats apart in every block: xb, wb x2, p x2, q x3 and, with the
//   loss, x and w x2 (11 planes, 44 bytes a pixel; 8 and 32 without).  x0,
//   and x and w without the loss, stay in the owning thread's registers: a
//   thread owns pixels threadIdx.x + k * THREADS of its band, k < PPT.
// - The row above a band and the row below it are read from the neighbour
//   blocks' shared memory through DSMEM (cluster.map_shared_rank).  Only the
//   pixels of a band's first and last rows run that code (an EDGE accessor);
//   the others read the block's own memory alone, with no branch between a
//   local and a remote load.  Consecutive threads touch consecutive words of
//   each plane, so no access conflicts on a bank.
// - Two cluster.sync() an iteration: after PQ (reads xb, wb neighbours,
//   writes its own p, q) and after XW (reads p, q neighbours, writes its own
//   x, xb, w, wb).  The loss (x, w neighbours) reads after the XW barrier;
//   the next PQ writes only p and q, which it does not read.  The barrier
//   orders shared-memory writes across the cluster: no __threadfence().  One
//   more barrier before exit keeps every band alive while a neighbour may
//   still read it.
// - The grid is Nz * M * C blocks: the clusters run in waves of those the
//   card holds at once.
// The per-voxel arithmetic is tgv.cuh's (tgv_pq_at, tgv_xw_at, tgv_loss_at)
// through the accessor OnchipTgv, operation for operation the L2 kernel's:
// built with -fmad=false, the two give the same state bit for bit.
//
// Loss: one partial per (iteration, block), summed in a fixed order (warp
// shuffles, then one warp); the wrapper adds the blocks.  No float atomics.

#include <cooperative_groups.h>

#include "tgv.cuh"

namespace cg = cooperative_groups;

// The band's shared-memory planes: slot of each array's channel 0.
enum { SB_XB = 0, SB_WB = 1, SB_P = 3, SB_Q = 5, SB_X = 8, SB_W = 9 };

__host__ __device__ constexpr int onchip_planes(bool loss) {
  return loss ? 11 : 8;
}

// The block's band: dynamic shared memory, addressed through this array so
// that the compiler reads it with shared-memory loads.
extern __shared__ float onchip_band[];

// What every pixel of a block's band shares: where the neighbour bands
// are, and where the band lies in the slice.
struct Band {
  const float* prev;   // the block above's planes (DSMEM), or null
  const float* next;   // the block below's planes, or null
  int plane;           // R * Nc: floats between two planes, in every block
  int Nr, Nc;
  int row0;            // the band's first row in the slice
  int last;            // the band's last row, counted from row0
  int prev_row;        // (R - 1) * Nc: the last row of the band above
};

// Accessor of tgv.cuh over a band: the pixel li of the band, at row rl (of
// the band) and column c.  x, w0, w1 are the pixel's registers (unused with
// the loss, where x and w live in shared memory), x0 its initial value.
// li is the thread's index plus a constant, so that the compiler keeps one
// address a plane, not one a plane and pixel.  EDGE: the pixel lies in the
// band's first or last row, whose row neighbours may lie in another block;
// every other pixel reads only its own block's shared memory.
template <bool LOSS, bool EDGE>
struct OnchipTgv {
  const Band& bd;
  int li, rl, c;
  float& x;
  float& w0;
  float& w1;
  float x0;

  __device__ __forceinline__ OnchipTgv(const Band& b, int li_, int rl_,
                                       int c_, float& x_, float& w0_,
                                       float& w1_, float x0_)
      : bd(b), li(li_), rl(rl_), c(c_), x(x_), w0(w0_), w1(w1_), x0(x0_) {}

  __device__ __forceinline__ static int slot(int a, int ch) {
    return a == TV_XB ? SB_XB : a == TV_WB ? SB_WB + ch
         : a == TV_P ? SB_P + ch : a == TV_Q ? SB_Q + ch
         : a == TV_X ? SB_X : SB_W + ch;
  }
  __device__ __forceinline__ bool in_regs(int a) const {
    return !LOSS && (a == TV_X || a == TV_W);
  }
  __device__ __forceinline__ float at(int a, int ch) const {
    if (a == TV_X0) return x0;
    if (in_regs(a)) return a == TV_X ? x : (ch == 0 ? w0 : w1);
    return onchip_band[slot(a, ch) * bd.plane + li];
  }
  __device__ __forceinline__ float fwd(int a, int ch, int ax) const {
    const int k = slot(a, ch) * bd.plane;
    if (ax == AX_COL) return onchip_band[k + li + 1];
    if (EDGE && rl == bd.last) return bd.next[k + c];
    return onchip_band[k + li + bd.Nc];
  }
  __device__ __forceinline__ float bwd(int a, int ch, int ax) const {
    const int k = slot(a, ch) * bd.plane;
    if (ax == AX_COL) return onchip_band[k + li - 1];
    if (EDGE && rl == 0) return bd.prev[k + bd.prev_row + c];
    return onchip_band[k + li - bd.Nc];
  }
  __device__ __forceinline__ void set(int a, int ch, float v) const {
    if (in_regs(a)) {
      (a == TV_X ? x : (ch == 0 ? w0 : w1)) = v;
      return;
    }
    onchip_band[slot(a, ch) * bd.plane + li] = v;
  }
  __device__ __forceinline__ bool not_first(int ax) const {
    return ax == AX_COL ? c > 0 : bd.row0 + rl > 0;
  }
  __device__ __forceinline__ bool not_last(int ax) const {
    return ax == AX_COL ? c < bd.Nc - 1 : bd.row0 + rl < bd.Nr - 1;
  }
};

// Sum of `v` over a THREADS-thread block, valid in thread 0; every thread
// must call it.
template <int THREADS>
__device__ __forceinline__ float onchip_block_sum(float v) {
  __shared__ float warp_sums[THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) warp_sums[wid] = v;
  __syncthreads();
  v = 0.f;
  if (wid == 0) {
    v = lane < THREADS / 32 ? warp_sums[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  __syncthreads();  // warp_sums is free for the next call
  return v;
}

template <int THREADS, int PPT, bool LOSS>
__global__ void __launch_bounds__(THREADS)
tgv_onchip_kernel(const TgvParams P, int n_iter, int R,
                  const float* __restrict__ x0, float* __restrict__ x,
                  float* __restrict__ xb, float* __restrict__ w,
                  float* __restrict__ wb, float* __restrict__ p,
                  float* __restrict__ q, float* __restrict__ parts) {
  float* const band = onchip_band;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int b = (int)cluster.block_rank();
  const int slice = blockIdx.x / C;
  const int z = slice / P.M, t = slice - z * P.M;
  const int Nc = P.Nc;
  const int row0 = b * R;
  const int rows = max(0, min(R, P.Nr - row0));
  const int n = rows * Nc;  // the band's pixels

  Band bd;
  bd.prev = b > 0 ? cluster.map_shared_rank(band, b - 1) : nullptr;
  bd.next = b + 1 < C ? cluster.map_shared_rank(band, b + 1) : nullptr;
  bd.plane = R * Nc;
  bd.Nr = P.Nr;
  bd.Nc = Nc;
  bd.row0 = row0;
  bd.last = rows - 1;
  bd.prev_row = (R - 1) * Nc;

  // the band's first pixel in an x-like array and in channel 0 of a w-like
  // and a q-like one; mp is the channel stride
  const int64_t sp = (int64_t)P.Nr * Nc;
  const int64_t mp = (int64_t)P.M * sp;
  const int64_t off = (int64_t)row0 * Nc;
  const int64_t xo = (int64_t)slice * sp + off;
  const int64_t wo = ((int64_t)z * 2 * P.M + t) * sp + off;
  const int64_t qo = ((int64_t)z * 3 * P.M + t) * sp + off;
  const int plane = bd.plane;

  float x0r[PPT], xr[PPT], w0r[PPT], w1r[PPT];
  unsigned rc[PPT];  // the pixel's row in the band << 16 | its column
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int li = threadIdx.x + k * THREADS;
    rc[k] = 0u;
    x0r[k] = xr[k] = w0r[k] = w1r[k] = 0.f;
    if (li < n) {
      const int rl = li / Nc;
      rc[k] = ((unsigned)rl << 16) | (unsigned)(li - rl * Nc);
      const float v = x0[xo + li];
      x0r[k] = v;
      xr[k] = v;
      band[SB_XB * plane + li] = v;
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        band[(SB_WB + ch) * plane + li] = 0.f;
        band[(SB_P + ch) * plane + li] = 0.f;
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) band[(SB_Q + ch) * plane + li] = 0.f;
      if (LOSS) {
        band[SB_X * plane + li] = v;
        band[SB_W * plane + li] = 0.f;
        band[(SB_W + 1) * plane + li] = 0.f;
      }
    }
  }
  cluster.sync();

// BODY for each of the thread's pixels, as the accessor v: a pixel in the
// first or the last row of the band as an EDGE accessor, any other as one
// that reads only this block (a warp's pixels share a row where Nc is a
// multiple of 32, so the branch does not split it).  The pixel's position
// passes through an empty asm, so that the compiler computes the addresses
// that depend on its row and column where they are used, not once for
// every pixel and plane before the iterations: that held 36 64-bit
// addresses a thread and spilled them.
#define ONCHIP_PIXELS(BODY)                                               \
  _Pragma("unroll") for (int k = 0; k < PPT; ++k) {                       \
    const int li = threadIdx.x + k * THREADS;                             \
    if (li < n) {                                                         \
      unsigned pos = rc[k];                                               \
      asm volatile("" : "+r"(pos));                                       \
      const int rl = (int)(pos >> 16), c = (int)(pos & 0xffffu);          \
      if (rl == 0 || rl == bd.last) {                                     \
        const OnchipTgv<LOSS, true> v(bd, li, rl, c, xr[k], w0r[k],       \
                                      w1r[k], x0r[k]);                    \
        BODY;                                                             \
      } else {                                                            \
        const OnchipTgv<LOSS, false> v(bd, li, rl, c, xr[k], w0r[k],      \
                                       w1r[k], x0r[k]);                   \
        BODY;                                                             \
      }                                                                   \
    }                                                                     \
  }

  for (int it = 0; it < n_iter; ++it) {
    ONCHIP_PIXELS(tgv_pq_at<2>(P, v))
    cluster.sync();
    ONCHIP_PIXELS(tgv_xw_at<2>(P, v))
    cluster.sync();
    if constexpr (LOSS) {
      float acc = 0.f;
      ONCHIP_PIXELS(acc += tgv_loss_at<2>(P, v))
      const float s = onchip_block_sum<THREADS>(acc);
      if (threadIdx.x == 0) parts[(int64_t)it * gridDim.x + blockIdx.x] = s;
    }
  }

  // the final state, each value written once
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int li = threadIdx.x + k * THREADS;
    if (li < n) {
      const OnchipTgv<LOSS, false> v(bd, li, (int)(rc[k] >> 16),
                                     (int)(rc[k] & 0xffffu), xr[k], w0r[k],
                                     w1r[k], x0r[k]);
      x[xo + li] = v.at(TV_X, 0);
      xb[xo + li] = v.at(TV_XB, 0);
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        w[wo + ch * mp + li] = v.at(TV_W, ch);
        wb[wo + ch * mp + li] = v.at(TV_WB, ch);
        p[wo + ch * mp + li] = v.at(TV_P, ch);
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) q[qo + ch * mp + li] = v.at(TV_Q, ch);
    }
  }
#undef ONCHIP_PIXELS
  cluster.sync();  // no band goes while a neighbour may still read it
}

typedef void (*OnchipKernel)(const TgvParams, int, int, const float*, float*,
                             float*, float*, float*, float*, float*, float*);

// The compiled (threads, pixels a thread) shapes; kernels/tgv_resident.py
// mirrors the list (ONCHIP_PPT).
static OnchipKernel onchip_kernel(int threads, int ppt, int loss) {
#define ONCHIP_CASE(T, K)                                                 \
  if (threads == T && ppt == K)                                           \
    return loss ? tgv_onchip_kernel<T, K, true>                           \
                : tgv_onchip_kernel<T, K, false>;
  ONCHIP_CASE(1024, 1)
  ONCHIP_CASE(1024, 2)
  ONCHIP_CASE(1024, 4)
  ONCHIP_CASE(1024, 8)
  ONCHIP_CASE(512, 8)
#undef ONCHIP_CASE
  return nullptr;
}

// Picks the kernel, sets its shared-memory size (and, for more than 8
// blocks, the non-portable cluster size) and fills the launch; a shape or a
// size the kernel cannot take is cudaErrorInvalidValue, and what the card
// refuses is the card's own error.
static cudaError_t onchip_config(const TgvParams* p, int compute_loss,
                                 int cluster, int threads, int ppt, int smem,
                                 OnchipKernel* fn, int* R,
                                 cudaLaunchConfig_t* cfg,
                                 cudaLaunchAttribute* attr) {
  *fn = onchip_kernel(threads, ppt, compute_loss);
  if (*fn == nullptr || cluster < 1 || cluster > 16)
    return cudaErrorInvalidValue;
  *R = (p->Nr + cluster - 1) / cluster;
  const long long band = (long long)(*R) * p->Nc;
  if (*R > 0xffff || p->Nc > 0xffff || band > (long long)threads * ppt ||
      (long long)smem < band * onchip_planes(compute_loss) * 4)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute((const void*)*fn,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cfg->gridDim = dim3((unsigned)(p->Nz * p->M * cluster));
  cfg->blockDim = dim3((unsigned)threads);
  cfg->dynamicSmemBytes = (size_t)smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

extern "C" {

// Launches the solve with `cluster` blocks of `threads` threads per (z, t)
// slice, each thread holding up to `ppt` pixels, `smem` bytes of dynamic
// shared memory a block; returns the launch's error code (0 = cudaSuccess).
// parts is (n_iter, Nz * M * cluster) floats, written only when
// compute_loss.
int tgvo_launch(const TgvParams* p, int n_iter, int compute_loss, int cluster,
                int threads, int ppt, int smem, const void* x0, void* x,
                void* xb, void* w, void* wb, void* pd, void* qd, void* parts,
                void* stream) {
  OnchipKernel fn;
  int R;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t e = onchip_config(p, compute_loss, cluster, threads, ppt, smem,
                                &fn, &R, &cfg, attr);
  if (e == cudaSuccess) {
    cfg.stream = (cudaStream_t)stream;
    e = cudaLaunchKernelEx(&cfg, fn, *p, n_iter, R, (const float*)x0,
                           (float*)x, (float*)xb, (float*)w, (float*)wb,
                           (float*)pd, (float*)qd, (float*)parts);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear the code; e is what is reported
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// How many clusters of that launch the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus the error code.
int tgvo_max_active_clusters(const TgvParams* p, int compute_loss,
                             int cluster, int threads, int ppt, int smem) {
  OnchipKernel fn;
  int R, n = 0;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t e = onchip_config(p, compute_loss, cluster, threads, ppt, smem,
                                &fn, &R, &cfg, attr);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&n, (const void*)fn, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  return n;
}

const char* tgvo_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
