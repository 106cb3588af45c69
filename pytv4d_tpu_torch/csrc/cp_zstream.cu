// Chambolle-Pock pass A marching along z for NVIDIA Hopper (sm_90a),
// specialised per channel table (csrc/tables.cuh), bound to Python through
// a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel
// pytv4d_tpu/kernels/zstream.py::make_cp_dual_kernel_zstream (:70), which
// streamed z planes through a revolving 4-slot VMEM window with hand-made
// DMA so that every x plane crossed from HBM once.  The per-launch pass A
// (B1, csrc/specialised.cu) reads each voxel's z and row neighbours from
// memory, so an x plane is requested five times (the extra reads mostly hit
// L2).
//
// What bounds it: HBM bytes (pass A's, as B1's: x and x0 read, y_A and the
// Nd channels of y_D read and written).  A march that moves those bytes in
// this kernel's order with no arithmetic takes 0.490 ms at (32, 8, 256, 256)
// f32 hybrid reg_time=0.5, B1 0.473 (tools/torch_probe_resident.py, PERF.md
// section 6); the kernel this replaces took 1.110 there: the generic body
// with its runtime channel table, one element a thread, 64-bit offsets and
// one plane of prefetch.
//
// Design:
// - A block owns ZROWS rows of one t-plane and marches z = 0 .. Nz-1.  The
//   x tiles of the planes z - 1, z, z + 1 (with one row either side of the
//   band) sit in a ring of ZSLOTS slots of shared memory while the tile of
//   z + 2 is in flight: cp.async copies of 16 bytes, issued one step
//   ahead, so that each x plane crosses from memory once for the band and
//   the row and z neighbours come from shared memory.  A tile is a
//   contiguous run of the plane (its rows follow each other), so one loop of
//   16-byte copies fills it.  Where a row is not a multiple of 16 bytes or x
//   is not 16-byte aligned the tile is copied by plain loads and stores; a
//   ring too large for ZRING_BYTES (rows wider than 768 float32 columns)
//   takes the instance without the ring (RING = false), which reads the
//   planes from memory, as B1 does.
// - The body is B1's: specialised.cuh's dual_spec_run for the table (the
//   nine tables with a z channel, tables.cuh's TABLES_WITH_Z), runs
//   of ZV = 2 columns, 32-bit offsets within a plane; it takes the x planes
//   from the caller, addressed by offset within a plane, so those in the
//   ring and those across t (from memory) are read alike.  y_A, y_D and x0
//   of plane z stream through once each, as in B1.  Built with -fmad=false,
//   y_A' and y_D' equal B1's bit for bit.
// - One barrier a step: after it the tile of z + 1 has arrived and every
//   thread is done with step z - 1, so the slot of z - 2 takes z + 2.
//
// L2,1 partials: each thread sums its runs over z in order, then one partial
// per block in a fixed order (block_sum): reproducible, and equal to B1's
// total up to the order of the additions.
//
// Scope (as the TPU kernel): any scheme and norm, l2/l1/kl fidelity, float
// or bf16 storage of the primary arrays and of the dual, no time-plane
// multiplier; the wrapper requires Nz >= 3 and a z channel.

#include "specialised.cuh"

constexpr int ZV = 2;      // columns a run, as B1
constexpr int ZROWS = 2;   // rows a block's band
constexpr int ZSLOTS = 4;  // the ring: z - 1, z, z + 1 and z + 2 in flight
constexpr int ZRING_BYTES = 48 * 1024;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Copy `count` elements from src (global) to dst (shared): 16-byte
// cp.async where `async16`, else element by element.
template <typename TX>
__device__ __forceinline__ void tile_copy(TX* dst, const TX* src, int count,
                                          int async16) {
  if (async16) {
    constexpr int E = 16 / sizeof(TX);
    for (int i = threadIdx.x * E; i < count; i += BLOCK * E)
      cp_async16(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < count; i += BLOCK) dst[i] = src[i];
  }
}

// Block (band, t) = (blockIdx.x, blockIdx.y): pass A on rows [band ZROWS,
// band ZROWS + ZROWS) of plane t at every z; its TV partial at
// parts[t][band].  RING: the x tiles go through shared memory (else the
// planes are read from memory); `async16`: by cp.async.
template <Table T, typename TX, typename TD, bool RING>
__global__ void __launch_bounds__(BLOCK)
zstream_spec_kernel(const Params p, const TX* __restrict__ x,
                    const TX* __restrict__ x0, TX* __restrict__ yA,
                    TD* __restrict__ yD, float* __restrict__ parts, int vec,
                    int async16) {
  extern __shared__ __align__(16) unsigned char zs_ring[];
  TX* const slots = reinterpret_cast<TX*>(zs_ring);
  const int t = blockIdx.y, Nc = p.Nc, Nz = p.Nz;
  const int row0 = blockIdx.x * ZROWS, rows = min(ZROWS, p.Nr - row0);
  const int cpr = (Nc + ZV - 1) / ZV, runs = rows * cpr;
  const int64_t plane = (int64_t)p.Nr * Nc, zs = (int64_t)p.M * plane;
  // the tile: rows row0 - 1 .. row0 + rows, those the volume has; a slot
  // holds row r at (r - row0 + 1) Nc
  const int rlo = max(row0 - 1, 0), rhi = min(row0 + rows + 1, p.Nr);
  const int tile = (ZROWS + 2) * Nc;
  auto slot = [&](int z) { return slots + (z & (ZSLOTS - 1)) * tile; };
  // a plane of the ring addressed as the volume's planes are (by r Nc + c)
  auto ring_plane = [&](int z) -> const TX* {
    return slot(z) - (Offset)(row0 - 1) * Nc;
  };
  auto fill = [&](int z) {
    tile_copy(slot(z) + (rlo - row0 + 1) * Nc,
              x + (z * p.M + t) * plane + (Offset)rlo * Nc,
              (rhi - rlo) * Nc, async16);
  };

  if (RING) {
    fill(0);
    if (Nz > 1) fill(1);
  }
  float part = 0.f;
  for (int z = 0; z < Nz; ++z) {
    const TX* xg = x + (z * p.M + t) * plane;
    if (RING) {
      cp_async_wait_all();  // this thread's copies of z + 1 have landed
      __syncthreads();      // everyone's; and step z - 1 is done
      if (z + 2 < Nz) fill(z + 2);
    }
    const TX* xz = RING ? ring_plane(z) : xg;
    const TX* xzm = RING ? ring_plane(z - 1) : xg - zs;  // read for z > 0
    const TX* xzp = RING ? ring_plane(z + 1) : xg + zs;  // and z < Nz - 1
    for (int j = threadIdx.x; j < runs; j += BLOCK)
      part += dual_spec_run<T, ZV, true, TX, TD>(
          p, row0 * cpr + j, z, t, z, Nz, t, p.M, xz, xzm, xzp, xg - plane,
          xg + plane, x0, yA, yD, nullptr, vec);
  }
  const float s = block_sum(part);
  if (threadIdx.x == 0)
    parts[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
}

template <typename TX, typename TD>
static int zs_aligned(const Params* p, const void* x, const void* x0,
                      const void* yA, const void* yD) {
  return p->Nc % ZV == 0 && aligned(x, ZV * sizeof(TX)) &&
         aligned(x0, ZV * sizeof(TX)) && aligned(yA, ZV * sizeof(TX)) &&
         aligned(yD, ZV * sizeof(TD));
}

template <Table T, typename TX, typename TD>
static int zstream_launch(const Params* p, const void* x, const void* x0,
                          void* yA, void* yD, void* parts, cudaStream_t s) {
  const int vec = zs_aligned<TX, TD>(p, x, x0, yA, yD);
  const long long ring_bytes = (long long)ZSLOTS * (ZROWS + 2) * p->Nc *
                               sizeof(TX);
  const int async16 = (p->Nc * sizeof(TX)) % 16 == 0 && aligned(x, 16);
  const dim3 grid((unsigned)((p->Nr + ZROWS - 1) / ZROWS), (unsigned)p->M);
  if (ring_bytes <= ZRING_BYTES)
    zstream_spec_kernel<T, TX, TD, true><<<grid, BLOCK, ring_bytes, s>>>(
        *p, (const TX*)x, (const TX*)x0, (TX*)yA, (TD*)yD, (float*)parts,
        vec, async16);
  else
    zstream_spec_kernel<T, TX, TD, false><<<grid, BLOCK, 0, s>>>(
        *p, (const TX*)x, (const TX*)x0, (TX*)yA, (TD*)yD, (float*)parts,
        vec, 0);
  return (int)cudaGetLastError();
}

template <Table T>
static int zstream_table(const Params* p, int x_bf16, int d_bf16,
                         const void* x, const void* x0, void* yA, void* yD,
                         void* parts, cudaStream_t s) {
  typedef __nv_bfloat16 B;
  if (!x_bf16 && !d_bf16)
    return zstream_launch<T, float, float>(p, x, x0, yA, yD, parts, s);
  if (!x_bf16)
    return zstream_launch<T, float, B>(p, x, x0, yA, yD, parts, s);
  if (!d_bf16)
    return zstream_launch<T, B, float>(p, x, x0, yA, yD, parts, s);
  return zstream_launch<T, B, B>(p, x, x0, yA, yD, parts, s);
}

extern "C" {

// Number of L2,1 partials the kernel writes: one per block, ZROWS rows of
// a t-plane.
long long cpz_num_parts(int Nz, int M, int Nr, int Nc) {
  return (long long)M * ((Nr + ZROWS - 1) / ZROWS);
}

// Launches table `id` of TABLES_WITH_Z; returns cudaGetLastError() after
// the launch (0 = cudaSuccess), or cudaErrorInvalidValue for an id outside
// the list.
int cp_dual_zstream_launch(const Params* p, int id, int x_bf16, int d_bf16,
                           const void* x, const void* x0, void* yA, void* yD,
                           void* parts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (id) {
#define ZS_CASE(id)                                                      \
  case id:                                                               \
    return zstream_table<table_code(id)>(p, x_bf16, d_bf16, x, x0, yA, yD, \
                                         parts, s);
    TABLES_WITH_Z(ZS_CASE)
#undef ZS_CASE
  }
  return (int)cudaErrorInvalidValue;
}

const char* cpz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
