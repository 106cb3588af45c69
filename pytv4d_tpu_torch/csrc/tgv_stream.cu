// Streaming TGV-2 Chambolle-Pock step for NVIDIA Hopper (sm_90a): pass PQ
// (dual update) and pass XW (primal update and extrapolation), bound to
// Python through a plain C interface (ctypes).
//
// Replaces the two pallas_calls of the Pallas TPU kernel
// pytv4d_tpu/kernels/tgv_stream.py::make_tgv_stream_step (:213):
//   tgv_pq_kernel <- pass PQ (tgv_stream.py:275-354)
//   tgv_xw_kernel <- pass XW (tgv_stream.py:357-448)
// The arithmetic of both is in tgv.cuh, shared with csrc/tgv_resident.cu.
//
// What bounds it: HBM bytes.  Pass PQ reads xb, wb, p, q and writes p, q;
// pass XW reads x, x0, p, w, q and writes x, xb, w, wb: 28 / 44 / 63 planes
// per iteration for the 2d / 3d / 4d mode, with a few flops per byte.  So
// every difference channel and prox argument stays in registers, and each
// array is touched once per pass (plus neighbour reads served by L1/L2).
//
// Design: one thread per voxel on the plane grid of stencil.cuh (blockIdx.y
// is the (z, t) plane), each gating its own global index against the
// one-sided zero boundary.  The TPU kernel's row tiles, 8-row seam blocks,
// clamped z-shifted operands and its (Nz, M, n, Nr, Nc) internal layout
// existed because a VMEM tile could not see its neighbours and wanted the
// time axis in-tile; they are dropped, and every array keeps the public
// layout.  The mode (N fields) and the storage type are template
// parameters, so the channel loops unroll fully; the norm is a runtime
// switch.  p, q, x and w are updated in place: a thread reads, of the
// arrays its pass writes, only its own voxel.
//
// The objective, tgv_obj_kernel, replaces no TPU kernel: the JAX package
// evaluates it with plain ops, which at (96, 16, 512, 512) stack the 4
// channels of D x and the 10 of E w at full size.  It reads x, x0 and w (2 +
// N planes; x at +1 and w at -1 along each axis), computes each voxel's
// 1/2 (x - x0)^2 + a1 N(D x - w) + a0 N(E w) in registers (tgv.cuh's
// tgv_loss_at, which the whole-solve kernels also sum) and writes one float
// partial a block (block_sum, a fixed order), which the wrapper sums.  Bound
// by HBM bytes like the passes, on the same plane grid.
//
// Built with -fmad=false, like the other sources, so each multiply, add and
// divide rounds as in the plain PyTorch version
// (kernels/tgv_stream.py::tgv_pq_plain, tgv_xw_plain).

#include "tgv.cuh"

// The voxel of this thread, or false past the plane's end.
__device__ __forceinline__ bool thread_geo(const TgvParams& P, Geo& g) {
  const int64_t plane = (int64_t)P.Nr * P.Nc;
  const int64_t pix = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  if (pix >= plane) return false;
  const int zt = blockIdx.y;
  const int z = zt / P.M;
  g = make_geo(P, z, zt - z * P.M, pix);
  return true;
}

template <int N, typename T>
__global__ void __launch_bounds__(BLOCK)
tgv_pq_kernel(const TgvParams P, const T* __restrict__ xb,
              const T* __restrict__ wb, T* __restrict__ p,
              T* __restrict__ q) {
  Geo g;
  if (thread_geo(P, g)) tgv_pq_voxel<N, T>(P, g, xb, wb, p, q);
}

template <int N, typename T>
__global__ void __launch_bounds__(BLOCK)
tgv_xw_kernel(const TgvParams P, T* __restrict__ x, const T* __restrict__ x0,
              const T* __restrict__ p, T* __restrict__ w,
              const T* __restrict__ q, T* __restrict__ xb,
              T* __restrict__ wb) {
  Geo g;
  if (thread_geo(P, g)) tgv_xw_voxel<N, T>(P, g, x, x0, p, w, q, xb, wb);
}

// One partial a block: the block's voxels' objective terms, summed by
// block_sum (every thread reaches its barrier; a thread past the plane's end
// adds 0).
template <int N, typename T>
__global__ void __launch_bounds__(BLOCK)
tgv_obj_kernel(const TgvParams P, const T* __restrict__ x,
               const T* __restrict__ x0, const T* __restrict__ w,
               float* __restrict__ parts) {
  Geo g;
  const float v = thread_geo(P, g) ? tgv_loss_voxel<N, T>(P, g, x, x0, w)
                                   : 0.f;
  const float s = block_sum(v);
  if (threadIdx.x == 0)
    parts[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
}

static inline dim3 tgv_grid(const TgvParams* p) {
  const int64_t plane = (int64_t)p->Nr * p->Nc;
  return dim3((unsigned)((plane + BLOCK - 1) / BLOCK),
              (unsigned)(p->Nz * p->M));
}

template <int N, typename T>
static int launch_pq(const TgvParams* p, const void* xb, const void* wb,
                     void* pd, void* qd, cudaStream_t stream) {
  tgv_pq_kernel<N, T><<<tgv_grid(p), BLOCK, 0, stream>>>(
      *p, (const T*)xb, (const T*)wb, (T*)pd, (T*)qd);
  return (int)cudaGetLastError();
}

template <int N, typename T>
static int launch_xw(const TgvParams* p, void* x, const void* x0,
                     const void* pd, void* w, const void* qd, void* xb,
                     void* wb, cudaStream_t stream) {
  tgv_xw_kernel<N, T><<<tgv_grid(p), BLOCK, 0, stream>>>(
      *p, (T*)x, (const T*)x0, (const T*)pd, (T*)w, (const T*)qd, (T*)xb,
      (T*)wb);
  return (int)cudaGetLastError();
}

template <int N, typename T>
static int launch_obj(const TgvParams* p, const void* x, const void* x0,
                      const void* w, void* parts, cudaStream_t stream) {
  tgv_obj_kernel<N, T><<<tgv_grid(p), BLOCK, 0, stream>>>(
      *p, (const T*)x, (const T*)x0, (const T*)w, (float*)parts);
  return (int)cudaGetLastError();
}

// Calls LAUNCH<N, T>(ARGS) for the mode's field count and the storage type.
#define TGV_DISPATCH(LAUNCH, ...)                                          \
  do {                                                                     \
    if (bf16) {                                                            \
      if (n_fields == 2) return LAUNCH<2, __nv_bfloat16>(__VA_ARGS__);     \
      if (n_fields == 3) return LAUNCH<3, __nv_bfloat16>(__VA_ARGS__);     \
      if (n_fields == 4) return LAUNCH<4, __nv_bfloat16>(__VA_ARGS__);     \
    } else {                                                               \
      if (n_fields == 2) return LAUNCH<2, float>(__VA_ARGS__);             \
      if (n_fields == 3) return LAUNCH<3, float>(__VA_ARGS__);             \
      if (n_fields == 4) return LAUNCH<4, float>(__VA_ARGS__);             \
    }                                                                      \
    return (int)cudaErrorInvalidValue;                                     \
  } while (0)

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for a field count other than 2, 3 or 4.
int tgv_pq_launch(const TgvParams* p, int n_fields, int bf16, const void* xb,
                  const void* wb, void* pd, void* qd, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  TGV_DISPATCH(launch_pq, p, xb, wb, pd, qd, s);
}

int tgv_xw_launch(const TgvParams* p, int n_fields, int bf16, void* x,
                  const void* x0, const void* pd, void* w, const void* qd,
                  void* xb, void* wb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  TGV_DISPATCH(launch_xw, p, x, x0, pd, w, qd, xb, wb, s);
}

// The objective's partials: tgv_obj_num_parts of them, one a block of the
// plane grid.
int tgv_obj_launch(const TgvParams* p, int n_fields, int bf16, const void* x,
                   const void* x0, const void* w, void* parts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  TGV_DISPATCH(launch_obj, p, x, x0, w, parts, s);
}

long long tgv_obj_num_parts(int Nz, int M, int Nr, int Nc) {
  return num_parts(Nz, M, Nr, Nc);
}

const char* tgv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
