// Whole-solve TGV-2 kernel for NVIDIA Hopper (sm_90a), the state in global
// memory: every Chambolle-Pock iteration of the in-plane (2d) mode in ONE
// launch, bound to Python through a plain C interface (ctypes).  It serves
// the slices too large for csrc/tgv_onchip.cu, which holds a slice's state
// in its cluster's shared memory (kernels/tgv_resident.py::
// tgv_resident_variant: up to 288 x 288, 336 x 336 without the loss).
//
// Replaces the Pallas TPU kernel
// pytv4d_tpu/kernels/tgv_resident.py::make_resident_tgv_solver (:58), which
// kept one (z, t) slice's 12 planes of state in VMEM for all iterations.  At
// 256 x 256 that is 3 MB per slice, against 227 KB of shared memory per
// thread block here.
//
// Design: one thread-block CLUSTER per slice (the slices of the 2d mode are
// independent problems).  The state (x, xb, w, wb, p, q) lives in global
// memory, where a slice's 3 MB stay in the 50 MB L2 while its cluster works
// on it; the cluster's threads stride over the slice's pixels and loop over
// the iterations themselves, with a cluster-wide barrier wherever one phase
// reads neighbours that the phase before wrote:
//   phase 0  x = xb = x0, w = wb = p = q = 0           | barrier
//   each iteration:
//     PQ     reads xb, wb neighbours, writes own p, q   | barrier
//     XW     reads p, q neighbours, writes own x, xb, w, wb | barrier
//     loss   reads x, w neighbours (compute_loss only); the next PQ writes
//            only p and q, which the loss does not read, so no barrier
// The per-voxel arithmetic is tgv.cuh's, shared with csrc/tgv_stream.cu.
// A __threadfence() before each barrier publishes the phase's global writes
// to the other blocks' SMs (it costs 2-5% of an iteration).
//
// What bounds it (NVIDIA H100 80GB HBM3, 700.00 W): at one slice, the number
// of threads on the slice, not the barriers: at 256 x 256 an iteration took
// 19 us with 8 x 1024 threads, 28-35 us with 4096 and 50 us with 2048 (an
// earlier version of tools/torch_probe_tgv_resident.py), so the launch uses
// the largest block and the largest portable cluster.  At many slices, the
// memory system: 256 slices of 256 x 256 (0.8 GB of state) ran at the
// streaming kernels' pace, 0.80 ms/it with the loss, twice the on-chip
// kernel's 0.36.  At the slices it serves, 8 SMs
// carry the slice: one 1024 x 1024 slice takes 0.43 ms/it with the loss,
// 0.34 without (chip_smoke.py phase 14, PERF.md section 6).
//
// Loss: one partial per (iteration, block), summed in a fixed order (warp
// shuffles, then one warp); the wrapper adds the blocks.  No float atomics,
// so two runs give the same bits.

#include <cooperative_groups.h>

#include "tgv.cuh"

namespace cg = cooperative_groups;

#define RES_BLOCK 1024

// Sum of `v` over a RES_BLOCK-thread block, valid in thread 0; every thread
// must call it.
__device__ __forceinline__ float res_block_sum(float v) {
  __shared__ float warp_sums[RES_BLOCK / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) warp_sums[wid] = v;
  __syncthreads();
  v = 0.f;
  if (wid == 0) {
    v = lane < RES_BLOCK / 32 ? warp_sums[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  __syncthreads();  // warp_sums is free for the next call
  return v;
}

// The state pointers are neither const nor __restrict__: other blocks of the
// cluster write what this block reads after a barrier.
__global__ void __launch_bounds__(RES_BLOCK)
tgv_resident_kernel(const TgvParams P, int n_iter, int compute_loss,
                    const float* __restrict__ x0, float* x, float* xb,
                    float* w, float* wb, float* p, float* q, float* parts) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned blocks = cluster.num_blocks();
  const int slice = blockIdx.x / blocks;
  const int z = slice / P.M, t = slice - z * P.M;
  const int64_t plane = (int64_t)P.Nr * P.Nc;
  const int64_t first = (int64_t)cluster.block_rank() * RES_BLOCK + threadIdx.x;
  const int64_t step = (int64_t)blocks * RES_BLOCK;

  for (int64_t pix = first; pix < plane; pix += step) {
    const Geo g = make_geo(P, z, t, pix);
    const int64_t xi = base_of(g, 1), wi = base_of(g, 2), qi = base_of(g, 3);
    const float v = x0[xi];
    x[xi] = v;
    xb[xi] = v;
    for (int i = 0; i < 2; ++i) {
      w[wi + i * g.mp] = 0.f;
      wb[wi + i * g.mp] = 0.f;
      p[wi + i * g.mp] = 0.f;
    }
    for (int c = 0; c < 3; ++c) q[qi + c * g.mp] = 0.f;
  }
  __threadfence();
  cluster.sync();

  for (int it = 0; it < n_iter; ++it) {
    for (int64_t pix = first; pix < plane; pix += step)
      tgv_pq_voxel<2, float>(P, make_geo(P, z, t, pix), xb, wb, p, q);
    __threadfence();
    cluster.sync();
    for (int64_t pix = first; pix < plane; pix += step)
      tgv_xw_voxel<2, float>(P, make_geo(P, z, t, pix), x, x0, p, w, q, xb,
                             wb);
    __threadfence();
    cluster.sync();
    if (compute_loss) {
      float acc = 0.f;
      for (int64_t pix = first; pix < plane; pix += step)
        acc += tgv_loss_voxel<2, float>(P, make_geo(P, z, t, pix), x, x0, w);
      const float s = res_block_sum(acc);
      if (threadIdx.x == 0) parts[(int64_t)it * gridDim.x + blockIdx.x] = s;
    }
  }
}

extern "C" {

// Launches the solve with `cluster` blocks per (z, t) slice; returns the
// launch's error code (0 = cudaSuccess).  parts is (n_iter, Nz * M * cluster)
// floats, written only when compute_loss.
int tgv_resident_launch(const TgvParams* p, int n_iter, int compute_loss,
                        int cluster, const void* x0, void* x, void* xb,
                        void* w, void* wb, void* pd, void* qd, void* parts,
                        void* stream) {
  if (cluster < 1) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p->Nz * p->M * cluster));
  cfg.blockDim = dim3(RES_BLOCK);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, tgv_resident_kernel, *p, n_iter, compute_loss, (const float*)x0,
      (float*)x, (float*)xb, (float*)w, (float*)wb, (float*)pd, (float*)qd,
      (float*)parts);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear the sticky code; e is what is reported
    return (int)e;
  }
  return (int)cudaGetLastError();
}

const char* tgvr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
