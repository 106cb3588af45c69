// Whole-solve Chambolle-Pock and subgradient-descent kernels for NVIDIA
// Hopper (sm_90a): every iteration of a TV denoising solve in ONE launch,
// bound to Python through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernels of pytv4d_tpu/kernels/resident.py:
//   resident_cp_kernel <- make_resident_cp_solver (:50)
//   resident_gd_kernel <- make_resident_gd_solver (:109)
// which kept the solver state in VMEM for all iterations.  Here the state
// (x, y_A, y_D; or two x buffers and the norms) lives in global memory,
// where a volume the guard admits stays in the 50 MB L2, and the threads of
// the launch stride over ALL voxels of the volume and loop over the
// iterations themselves.
//
// The whole volume is one coupled problem (z and t channels couple the
// slices), so the barrier between the passes of an iteration spans every
// thread of the launch: a cooperative grid of as many blocks as are
// co-resident, with grid.sync().  (One thread-block cluster with
// cluster.sync() holds at most 16 blocks and measured 3 to 6 times slower:
// tools/torch_probe_resident.py builds that variant of this file.)
// Each iteration is the per-launch kernels' own per-voxel code (voxel.cuh):
//   CP   pass A  reads x neighbours, writes own y_A, y_D        | barrier
//        pass B  reads y_D neighbours, writes own x (in place)  | barrier
//   GD   pass 1  reads x neighbours, writes own norm            | barrier
//        pass 2  reads x out to +-2 and the norms, writes x' to the OTHER
//                x buffer (neighbours still read x)             | barrier
// A __threadfence() before each barrier publishes the pass's global writes.
// The state pointers are neither const nor __restrict__: other blocks write
// what this block reads after a barrier.
//
// Losses: two partials per (iteration, block), summed in a fixed order (warp
// shuffles, then one warp); the wrapper adds the blocks.  No float atomics,
// so two runs give the same bits.  CP: the TV term of D x computed in the
// step (the pre-update x) and the fidelity of the new x, as cp_step pairs
// them; GD: the TV of the pre-update x and 1/2 |x' - x0|^2.
//
// What bounds it: at the volumes the guard admits, the barriers and the
// latency of two dependent passes over L2-resident state, not HBM bytes
// (x0 is read and the final state written once per solve).

#include <cooperative_groups.h>

#include "voxel.cuh"

namespace cg = cooperative_groups;

#define RES_MAX_BLOCK 1024

// Sum of `v` over the block (any size up to RES_MAX_BLOCK, a multiple of
// 32), valid in thread 0; every thread must call it.
__device__ __forceinline__ float res_block_sum(float v) {
  __shared__ float warp_sums[RES_MAX_BLOCK / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) warp_sums[wid] = v;
  __syncthreads();
  v = 0.f;
  if (wid == 0) {
    v = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  __syncthreads();  // warp_sums is free for the next call
  return v;
}

// Publish this pass's writes and wait for every thread of the launch.
__device__ __forceinline__ void res_barrier() {
  __threadfence();
  cg::this_grid().sync();
}

// The voxel with linear index vid of the whole volume (the wrapper admits
// volumes far below 2^31 voxels, so the indices are ints).
__device__ __forceinline__ Vox vox_at(const Params& p, int plane, int vid) {
  const int zt = vid / plane;
  return make_vox(p, zt, vid - zt * plane, nullptr);
}

// n_iter CP iterations (solvers/cp.py::cp_step: l2 fidelity or any other
// of Params, no mask).  parts is (n_iter, 2, blocks): TV terms, then
// fidelity terms (already times fid_scale).
__global__ void __launch_bounds__(RES_MAX_BLOCK)
resident_cp_kernel(const Params p, int n_iter, const float* __restrict__ x0,
                   float* x, float* yA, float* yD, float* parts) {
  const int plane = p.Nr * p.Nc, vol = plane * p.Nz * p.M;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int step = gridDim.x * blockDim.x;
  for (int it = 0; it < n_iter; ++it) {
    float tv = 0.f;
    for (int vid = first; vid < vol; vid += step) {
      const Vox v = vox_at(p, plane, vid);
      tv += cp_dual_voxel<false>(p, v, x, x0, yA, yD, x[v.xi]);
    }
    res_barrier();
    float fid = 0.f;
    for (int vid = first; vid < vol; vid += step)
      fid += cp_primal_voxel(p, vox_at(p, plane, vid), x, x0, yA, yD, x);
    tv = res_block_sum(tv);
    fid = res_block_sum(fid);
    if (threadIdx.x == 0) {
      float* row = parts + (int64_t)it * 2 * gridDim.x;
      row[blockIdx.x] = tv;
      row[gridDim.x + blockIdx.x] = p.fid_scale * fid;
    }
    res_barrier();
  }
}

// n_iter subgradient-descent iterations: x' = x - step ((x - x0) + reg G)
// with G the TV subgradient of x (p.tau carries the step size).  Iteration
// `it` reads x from xa (even) or xb (odd) and writes the other; the caller
// puts the start iterate into xa and finds the result in xa (n_iter even)
// or xb.  parts is (n_iter, 2, blocks): TV terms, then 1/2 (x' - x0)^2.
__global__ void __launch_bounds__(RES_MAX_BLOCK)
resident_gd_kernel(const Params p, int n_iter, const float* __restrict__ x0,
                   float* xa, float* xb, float* norms, float* parts) {
  const int plane = p.Nr * p.Nc, vol = plane * p.Nz * p.M;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int step = gridDim.x * blockDim.x;
  for (int it = 0; it < n_iter; ++it) {
    const float* src = (it & 1) ? xb : xa;
    float* dst = (it & 1) ? xa : xb;
    float tv = 0.f;
    for (int vid = first; vid < vol; vid += step)
      tv += tv_norms_voxel(p, vox_at(p, plane, vid), src, norms);
    res_barrier();
    float sq = 0.f;
    for (int vid = first; vid < vol; vid += step) {
      const Vox v = vox_at(p, plane, vid);
      const float g = tv_subgrad_voxel(p, v, src, norms);
      const float xc = src[v.xi], x0v = x0[v.xi];
      const float xn = xc - p.tau * ((xc - x0v) + p.reg * g);
      dst[v.xi] = xn;
      const float diff = xn - x0v;
      sq += diff * diff;
    }
    tv = res_block_sum(tv);
    sq = res_block_sum(sq);
    if (threadIdx.x == 0) {
      float* row = parts + (int64_t)it * 2 * gridDim.x;
      row[blockIdx.x] = tv;
      row[gridDim.x + blockIdx.x] = 0.5f * sq;
    }
    res_barrier();
  }
}

// Launches `kernel` as a cooperative grid of `blocks` x `threads` threads;
// returns the launch's error code.
template <typename... KArgs, typename... Args>
static int res_launch(void (*kernel)(KArgs...), int blocks, int threads,
                      cudaStream_t stream, Args... args) {
  if (blocks < 1 || threads < 32 || threads > RES_MAX_BLOCK || threads % 32)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear the sticky code; e is what is reported
    return (int)e;
  }
  return (int)cudaGetLastError();
}

extern "C" {

// The most blocks of `threads` threads one launch may hold: what is
// co-resident on the current device (the larger of the two kernels' needs
// decides).  Negative: minus the CUDA error code.
int resident_max_blocks(int threads) {
  int dev = 0, sms = 0, per_sm = 1 << 30;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const void* kernels[2] = {(const void*)resident_cp_kernel,
                            (const void*)resident_gd_kernel};
  for (int k = 0; k < 2 && e == cudaSuccess; ++k) {
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernels[k], threads,
                                                      0);
    if (n < per_sm) per_sm = n;
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  return sms * per_sm;
}

// x, yA, yD (internal layout) are updated in place; parts is
// (n_iter, 2, blocks) floats.
int resident_cp_launch(const Params* p, int n_iter, int blocks, int threads,
                       const void* x0, void* x, void* yA, void* yD,
                       void* parts, void* stream) {
  return res_launch(resident_cp_kernel, blocks, threads, (cudaStream_t)stream,
                    *p, n_iter, (const float*)x0, (float*)x, (float*)yA,
                    (float*)yD, (float*)parts);
}

// xa holds the start iterate; the result is in xa (n_iter even) or xb.
int resident_gd_launch(const Params* p, int n_iter, int blocks, int threads,
                       const void* x0, void* xa, void* xb, void* norms,
                       void* parts, void* stream) {
  return res_launch(resident_gd_kernel, blocks, threads, (cudaStream_t)stream,
                    *p, n_iter, (const float*)x0, (float*)xa, (float*)xb,
                    (float*)norms, (float*)parts);
}

const char* resident_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
