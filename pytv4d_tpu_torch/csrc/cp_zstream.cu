// Chambolle-Pock pass A marching along z for NVIDIA Hopper (sm_90a), bound
// to Python through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel
// pytv4d_tpu/kernels/zstream.py::make_cp_dual_kernel_zstream (:70), which
// streamed z planes through a revolving 4-slot VMEM window with hand-made
// DMA so that every x plane crossed from HBM once.  The per-launch pass A
// (csrc/cp_fused.cu::cp_dual_kernel) reads each voxel's z neighbours from
// memory, so an x plane is requested three times (the two extra reads
// mostly hit L2).
//
// Design: one thread per (t, row, column) COLUMN of the volume.  The thread
// marches z = 0 .. Nz-1 holding x[z-1], x[z], x[z+1] of its column in
// registers, loads x[z+2] one step ahead, and calls the per-launch kernel's
// own per-voxel pass A (voxel.cuh::cp_dual_voxel) with the z neighbours taken
// from those registers; the in-plane and t neighbours still come through
// L1/L2.  So every x value is loaded once for itself and never again along
// z, and the outputs equal cp_dual_kernel's to the bit.  The TPU kernel's
// row tiles, 8-row seam granules, DMA semaphores and dt_local output are not
// carried over.
//
// What bounds it: like cp_dual_kernel, the per-channel work of the runtime
// scheme table rather than HBM bytes; and M * Nr * Nc threads is all the
// parallelism there is, so a small plane starves the card.
//
// L2,1 partials: each thread sums its column over z in order, then one
// partial per block in a fixed order (block_sum): reproducible, and equal to
// cp_dual_kernel's total up to the order of the additions.
//
// Scope (as the TPU kernel): any scheme and norm through the channel table,
// l2/l1/kl fidelity, float or bf16 storage of the primary arrays and of the
// dual, no time-plane multiplier; the wrapper requires Nz >= 3 and a z
// channel.

#include "voxel.cuh"

template <typename TX, typename TD>
__global__ void __launch_bounds__(BLOCK)
cp_dual_zstream_kernel(const Params p, const TX* __restrict__ x,
                       const TX* __restrict__ x0, TX* __restrict__ yA,
                       TD* __restrict__ yD, float* __restrict__ parts) {
  const int64_t plane = (int64_t)p.Nr * p.Nc;
  const int64_t pix = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  float part = 0.f;
  if (pix < plane) {
    Vox v = make_vox(p, blockIdx.y, pix, nullptr);  // plane (z = 0, t)
    const int64_t xs = (int64_t)p.M * plane, ys = xs * p.Nd;
    float xm = 0.f, xc = ld(x, v.xi);
    float xp = p.Nz > 1 ? ld(x, v.xi + xs) : 0.f;
    for (int z = 0; z < p.Nz; ++z) {
      const float xn = z + 2 < p.Nz ? ld(x, v.xi + 2 * xs) : 0.f;
      v.z = z;
      part += cp_dual_voxel<true>(p, v, x, x0, yA, yD, xc, xm, xp);
      xm = xc;
      xc = xp;
      xp = xn;
      v.xi += xs;
      v.yb += ys;
    }
  }
  const float s = block_sum(part);
  if (threadIdx.x == 0) parts[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
}

template <typename TX, typename TD>
static int launch_zstream(const Params* p, const void* x, const void* x0,
                          void* yA, void* yD, void* parts,
                          cudaStream_t stream) {
  const int64_t plane = (int64_t)p->Nr * p->Nc;
  const dim3 grid((unsigned)((plane + BLOCK - 1) / BLOCK), (unsigned)p->M);
  cp_dual_zstream_kernel<TX, TD><<<grid, BLOCK, 0, stream>>>(
      *p, (const TX*)x, (const TX*)x0, (TX*)yA, (TD*)yD, (float*)parts);
  return (int)cudaGetLastError();
}

extern "C" {

// Number of L2,1 partials the kernel writes: one per block of a (t) plane.
long long cpz_num_parts(int Nz, int M, int Nr, int Nc) {
  return num_parts(1, M, Nr, Nc);
}

// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
int cp_dual_zstream_launch(const Params* p, int x_bf16, int d_bf16,
                           const void* x, const void* x0, void* yA, void* yD,
                           void* parts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!x_bf16 && !d_bf16)
    return launch_zstream<float, float>(p, x, x0, yA, yD, parts, s);
  if (!x_bf16)
    return launch_zstream<float, __nv_bfloat16>(p, x, x0, yA, yD, parts, s);
  if (!d_bf16)
    return launch_zstream<__nv_bfloat16, float>(p, x, x0, yA, yD, parts, s);
  return launch_zstream<__nv_bfloat16, __nv_bfloat16>(p, x, x0, yA, yD, parts,
                                                     s);
}

const char* cpz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
