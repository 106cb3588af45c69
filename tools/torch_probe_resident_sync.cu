// Synchronisation floors of the whole-solve CP / GD kernels (B9) on NVIDIA
// Hopper (sm_90a): the cost of the exchange between two passes with no
// pass around it.  Built and driven by tools/torch_probe_resident.py, which
// copies this file beside csrc/'s headers; not part of the package.
//
// Each kernel runs n_iter iterations of two passes; a pass publishes 2 E
// floats of a block's edge rows (E for the block above, E for the one
// below), takes its neighbours' 2 E floats into shared memory and adds one
// of them into a warp sum (lane 0 into shared memory), as the on-chip B9
// does (csrc/resident_onchip.cu).  The candidates:
//   ll       : each float travels in a 64-bit word with the pass's flag in
//              its high half (one relaxed store at gpu scope); the reader
//              polls the words themselves until the flag is the pass's,
//              then one __syncthreads().  No fence, no counter.
//   counter  : plain stores, __syncthreads(), thread 0 fences and stores
//              the block's pass counter with release semantics, spins with
//              acquire loads on its two neighbours' counters, then
//              __syncthreads(), L2 loads (__ldcg) of the rows,
//              __syncthreads().
//   cluster  : one thread-block cluster of C blocks, rows through DSMEM,
//              one cluster.sync() a pass (the rows double-buffered).
// A wait that lasts a second traps (a fault, not a hang).
//
// And the byte floor of the z-marching pass A (B10) at a shape: zmarch
// moves exactly pass A's bytes (x and x0 read, y_A and the Nd channels of
// y_D read and written, float32) in B10's order -- a block owns R rows of
// one t-plane and marches z -- with no arithmetic.

#include <cooperative_groups.h>

#include "stencil.cuh"

namespace cg = cooperative_groups;

#define PROBE_THREADS 512

__device__ __forceinline__ unsigned long long probe_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void ll_put(unsigned long long* w, float v,
                                       unsigned flag) {
  const unsigned long long word =
      ((unsigned long long)flag << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(w), "l"(word)
               : "memory");
}

__device__ __forceinline__ float ll_get(const unsigned long long* w,
                                        unsigned flag) {
  unsigned long long word, t0 = 0;
  for (int k = 0;; ++k) {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(word)
                 : "l"(w)
                 : "memory");
    if ((unsigned)(word >> 32) == flag) break;
    if ((k & 1023) == 0) {
      const unsigned long long t = probe_now();
      if (t0 == 0) t0 = t;
      else if (t - t0 > 1000000000ull) __trap();
    }
  }
  return __uint_as_float((unsigned)word);
}

// The warp sums of `v`: lane 0 of each warp into ws[wid].
__device__ __forceinline__ void warp_sums(float v, float* ws) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = v;
}

// Thread 0 adds the warp sums ws (after a barrier) into parts[it][block].
__device__ __forceinline__ void flush_sums(const float* ws, int it,
                                           float* parts) {
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < PROBE_THREADS / 32; ++w) s += ws[w];
    parts[(int64_t)it * gridDim.x + blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(PROBE_THREADS, 1)
probe_ll_kernel(int n_iter, int E, unsigned long long* exch, float* parts) {
  extern __shared__ float halo[];  // 2 E
  __shared__ float ws[2][PROBE_THREADS / 32];
  const int b = blockIdx.x, B = gridDim.x;
  float acc = 1.f;
  for (int it = 0; it < n_iter; ++it) {
    for (int pass = 0; pass < 2; ++pass) {
      const unsigned flag = 2u * it + pass + 1u;
      // the two passes publish into two regions (as x and y_D alternate in
      // the on-chip B9): a block overwrites a region only after its
      // neighbours have published the other one, which they do after
      // reading this one
      const int64_t stride = 4 * (int64_t)E;  // words a block
      unsigned long long* mine = exch + b * stride + pass * 2 * E;
      for (int e = threadIdx.x; e < E; e += PROBE_THREADS) {
        ll_put(mine + e, acc, flag);
        ll_put(mine + E + e, acc, flag);
      }
      for (int e = threadIdx.x; e < E; e += PROBE_THREADS) {
        halo[e] = b > 0 ? ll_get(mine - stride + E + e, flag) : 0.f;
        halo[E + e] = b + 1 < B ? ll_get(mine + stride + e, flag) : 0.f;
      }
      __syncthreads();
      flush_sums(ws[pass], pass ? it : it - 1 >= 0 ? it - 1 : 0, parts);
      acc = 0.5f * acc + halo[(threadIdx.x * 7) % (2 * E)];
      warp_sums(acc, ws[pass]);
    }
  }
}

__global__ void __launch_bounds__(PROBE_THREADS, 1)
probe_counter_kernel(int n_iter, int E, float* exch, int* cnt,
                     float* parts) {
  extern __shared__ float halo[];
  __shared__ float ws[2][PROBE_THREADS / 32];
  const int b = blockIdx.x, B = gridDim.x;
  float acc = 1.f;
  for (int it = 0; it < n_iter; ++it) {
    for (int pass = 0; pass < 2; ++pass) {
      const int flag = 2 * it + pass + 1;
      float* mine = exch + (int64_t)b * 2 * E;
      for (int e = threadIdx.x; e < E; e += PROBE_THREADS) {
        mine[e] = acc;
        mine[E + e] = acc;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(cnt + b),
                     "r"(flag)
                     : "memory");
        const unsigned long long t0 = probe_now();
        for (int nb = b - 1; nb <= b + 1; nb += 2) {
          if (nb < 0 || nb >= B) continue;
          int v;
          for (int k = 0;; ++k) {
            asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                         : "=r"(v)
                         : "l"(cnt + nb)
                         : "memory");
            if (v >= flag) break;
            if ((k & 1023) == 1023 && probe_now() - t0 > 1000000000ull)
              __trap();
          }
        }
      }
      __syncthreads();
      for (int e = threadIdx.x; e < E; e += PROBE_THREADS) {
        halo[e] = b > 0 ? __ldcg(exch + (int64_t)(b - 1) * 2 * E + E + e)
                        : 0.f;
        halo[E + e] =
            b + 1 < B ? __ldcg(exch + (int64_t)(b + 1) * 2 * E + e) : 0.f;
      }
      __syncthreads();
      flush_sums(ws[pass], pass ? it : it - 1 >= 0 ? it - 1 : 0, parts);
      acc = 0.5f * acc + halo[(threadIdx.x * 7) % (2 * E)];
      warp_sums(acc, ws[pass]);
    }
  }
}

__global__ void __launch_bounds__(PROBE_THREADS, 1)
probe_cluster_kernel(int n_iter, int E, float* parts) {
  extern __shared__ float rows[];  // two buffers of 2 E
  __shared__ float ws[2][PROBE_THREADS / 32];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), b = (int)cluster.block_rank();
  const float* prev = b > 0 ? cluster.map_shared_rank(rows, b - 1) : nullptr;
  const float* next = b + 1 < C ? cluster.map_shared_rank(rows, b + 1)
                                : nullptr;
  float acc = 1.f;
  for (int it = 0; it < n_iter; ++it) {
    for (int pass = 0; pass < 2; ++pass) {
      float* mine = rows + pass * 2 * E;
      for (int e = threadIdx.x; e < E; e += PROBE_THREADS) {
        mine[e] = acc;
        mine[E + e] = acc;
      }
      cluster.sync();
      float h = 0.f;
      const int e = (threadIdx.x * 7) % E;
      if (prev) h += prev[pass * 2 * E + E + e];
      if (next) h += next[pass * 2 * E + e];
      flush_sums(ws[pass], pass ? it : it - 1 >= 0 ? it - 1 : 0, parts);
      acc = 0.5f * acc + h;
      warp_sums(acc, ws[pass]);
    }
  }
  cluster.sync();  // no block leaves while a neighbour may read it
}

// One block per (band of R rows, t); thread k takes runs of two columns.
__global__ void __launch_bounds__(BLOCK)
probe_zmarch_kernel(int Nz, int M, int Nr, int Nc, int Nd, int R,
                    const float* __restrict__ x, const float* __restrict__ x0,
                    float* __restrict__ yA, float* __restrict__ yD) {
  const int bands = (Nr + R - 1) / R;
  const int t = blockIdx.x / bands, row0 = (blockIdx.x - t * bands) * R;
  const int rows = min(R, Nr - row0), n = rows * Nc / 2;
  const int64_t plane = (int64_t)Nr * Nc;
  float carry = 0.f;
  for (int z = 0; z < Nz; ++z) {
    const int64_t base = (int64_t)(z * M + t) * plane + (int64_t)row0 * Nc;
    const int64_t dbase = (int64_t)(z * M + t) * Nd * plane +
                          (int64_t)row0 * Nc;
    for (int k = threadIdx.x; k < n; k += BLOCK) {
      const float2 xv = reinterpret_cast<const float2*>(x + base)[k];
      const float2 x0v = reinterpret_cast<const float2*>(x0 + base)[k];
      float2 a = reinterpret_cast<float2*>(yA + base)[k];
      a.x += carry * (xv.x + x0v.x);
      reinterpret_cast<float2*>(yA + base)[k] = a;
      for (int i = 0; i < Nd; ++i) {
        float2* yi = reinterpret_cast<float2*>(yD + dbase + i * plane);
        float2 v = yi[k];
        v.y += carry;
        yi[k] = v;
      }
    }
    carry *= 0.5f;
  }
}

static int probe_finish(cudaError_t e) {
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

extern "C" {

// Cooperative launches of `blocks` blocks (all co-resident, as the
// spinning kernels need); exch holds 4 E words a block, zeroed.
int probe_ll(int blocks, int n_iter, int E, void* exch, void* parts,
             void* stream) {
  const int smem = 2 * E * (int)sizeof(float);
  cudaFuncSetAttribute((const void*)probe_ll_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(PROBE_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return probe_finish(cudaLaunchKernelEx(&cfg, probe_ll_kernel, n_iter, E,
                                         (unsigned long long*)exch,
                                         (float*)parts));
}

// exch holds 2 E floats a block, cnt one int a block, zeroed.
int probe_counter(int blocks, int n_iter, int E, void* exch, void* cnt,
                  void* parts, void* stream) {
  const int smem = 2 * E * (int)sizeof(float);
  cudaFuncSetAttribute((const void*)probe_counter_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(PROBE_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return probe_finish(cudaLaunchKernelEx(&cfg, probe_counter_kernel, n_iter,
                                         E, (float*)exch, (int*)cnt,
                                         (float*)parts));
}

// `blocks` blocks in clusters of `cluster` (up to 16).
int probe_cluster(int blocks, int cluster, int n_iter, int E, void* parts,
                  void* stream) {
  const int smem = 4 * E * (int)sizeof(float);
  cudaFuncSetAttribute((const void*)probe_cluster_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cluster > 8)
    cudaFuncSetAttribute((const void*)probe_cluster_kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(PROBE_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return probe_finish(cudaLaunchKernelEx(&cfg, probe_cluster_kernel, n_iter,
                                         E, (float*)parts));
}

// Nc even, R rows a band; carry is 0 so the arrays keep their values.
int probe_zmarch(int Nz, int M, int Nr, int Nc, int Nd, int R, const void* x,
                 const void* x0, void* yA, void* yD, void* stream) {
  const int bands = (Nr + R - 1) / R;
  probe_zmarch_kernel<<<bands * M, BLOCK, 0, (cudaStream_t)stream>>>(
      Nz, M, Nr, Nc, Nd, R, (const float*)x, (const float*)x0, (float*)yA,
      (float*)yD);
  return (int)cudaGetLastError();
}

const char* probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
