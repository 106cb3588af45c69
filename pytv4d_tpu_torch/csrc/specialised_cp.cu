// CP passes A (B1) and B (B2) on one shard of a (z, t)-sharded solve, in
// the two sharded modes of parallel/fused_halo.py, specialised for one
// channel table of csrc/tables.cuh, for NVIDIA Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of pytv4d_tpu/kernels/fused.py in their
// sharded modes (halo_mode, interior):
//   cp_dual_shard_kernel   <- make_cp_dual_kernel   (pass A, fused.py:652)
//   cp_primal_shard_kernel <- make_cp_primal_kernel (pass B, fused.py:859)
// On an unsharded volume both passes are csrc/specialised.cu's kernels.
// The sharded step's edge planes (B8) are csrc/cp_boundary.cu's.
//
// The modes (HALO, a template flag):
//   - halo mode (the ghost-plane step; the sharded CT solve's pass B): every
//     plane of the shard.  Pass A reads x extended by one plane per side in
//     z and t, (Nz+2, M+2, Nr, Nc), holding the neighbour shards' planes or,
//     at the volume's edge, ghost planes that zero every difference across
//     it; pass B reads the dual from y_ext, the dual extended the same way
//     (zeros at the volume's edge), alone: its own slot too, one array
//     streamed.  The z and t gates are off.  x0, y_A, y_D and x' keep the
//     shard's shape.
//   - interior (the overlapped step): the planes 1 .. Nz-2 of the shard,
//     whose z neighbours lie in the shard itself; the z gate is off, the t
//     gate on (time is not sharded on that path).  The two edge planes are
//     B8's.  Only the tables with a z channel (tables.cuh's TABLES_WITH_Z,
//     B8's list): the overlapped step requires one.
//
// What bounds them: HBM bytes.  The generic bodies they replace
// (voxel.cuh's cp_dual_voxel and cp_primal_voxel, 42-47% of their bounds
// at a z-shard (8, 8, 256, 256), PERF.md) spent their time on per-channel
// work: a runtime switch on each channel's axis and kind, 64-bit offsets,
// one load per channel and neighbour.  Here, as in csrc/specialised.cu for
// the unsharded passes:
//   - the table is a template argument: the channel loops unroll at compile
//     time, with no runtime axis or kind;
//   - offsets within a plane are 32-bit (specialised.cuh's Offset), the
//     strides between planes 64-bit;
//   - a thread takes VEC = 2 consecutive columns: one access per array and
//     per dual channel, each neighbour run loaded once (specialised.cuh's
//     dual_spec_body and primal_spec_body, which take the base pointers of
//     the block's planes in the extended operands and the gates).
//
// The arithmetic is the generic bodies' operation for operation and in the
// same order (-fmad=false), so y_A', y_D' and x' equal theirs to the bit,
// and a shard's equal the unsharded kernels' on the same voxels of the
// gathered volume.  Partials: the halo mode writes one per block of BLOCK
// runs (specialised.cuh's dual_num_parts), as the unsharded pass A does;
// the interior launches fill the inner rows of the overlapped step's
// array, one slot per BLOCK voxels of a plane (specialised.cuh's
// slot_parts), whose edge rows B8 fills.  The loss moves only by the order
// of a sum.
//
// Bound to Python through the plain C interface at the end (ctypes,
// kernels/fused.py::_spec_launch); nvcc compiles the kernels of this one
// source in parallel (-split-compile, kernels/build.py).

#include "specialised.cuh"

constexpr int VEC = 2;  // columns per thread

// The block's plane (z, t) of the shard: every plane in the halo mode,
// planes 1 .. Nz-2 (blockIdx.y counting from plane M) in the interior one.
template <bool HALO>
__device__ __forceinline__ int shard_plane(const Params& p) {
  return blockIdx.y + (HALO ? 0 : p.M);
}

// ------------------------------------------------------- pass A (B1)
// y_A' = fid prox, y_D' = TV dual prox of y_D + sigma_D D x, in place; one
// TV partial per block.  x is extended by one plane per side in z and t
// (HALO: specialised.cuh's dual_spec_halo_plane) or the shard itself
// (interior).
template <Table T, typename TX, typename TD, bool HALO>
__global__ void __launch_bounds__(BLOCK)
cp_dual_shard_kernel(const Params p, const TX* __restrict__ x,
                     const TX* __restrict__ x0, TX* __restrict__ yA,
                     TD* __restrict__ yD, const float* __restrict__ tmul,
                     float* __restrict__ parts, int vec) {
  if constexpr (HALO) {
    dual_spec_halo_plane<T, VEC, true, TX, TD>(p, x, x0, yA, yD, tmul, parts,
                                               vec);
  } else {
    const int zt = shard_plane<false>(p);
    const int z = zt / p.M, t = zt - z * p.M;
    const int64_t plane = (int64_t)p.Nr * p.Nc, zs = p.M * plane;
    const TX* xz = x + zt * plane;
    // the z gate off (position 2 of 5, where every gate passes:
    // specialised.cuh's dual_spec_run), the t gate on
    const float s = dual_spec_body<T, VEC, true, TX, TD>(
        p, z, t, 2, 5, t, p.M, xz, xz - zs, xz + zs, x0, yA, yD, tmul, vec);
    slot_parts(p, zt, s, parts);
  }
}

// ------------------------------------------------------- pass B (B2)
// x' = x - tau y_A' - tau D^T y_D' (then max(x', 0) when nonneg) into
// `out`, and one fidelity partial of x' per block.  y is the dual the
// adjoint reads: y_ext, extended by one plane per side in z and t (HALO),
// or y_D (interior).  out may be x and x0 may be x (the inverse solver's
// out-of-place step), so none of the three is __restrict__.
template <Table T, typename TX, typename TD, bool HALO>
__global__ void __launch_bounds__(BLOCK)
cp_primal_shard_kernel(const Params p, const TX* x, const TX* x0,
                       const TX* __restrict__ yA, const TD* __restrict__ y,
                       const float* __restrict__ tmul, TX* out,
                       float* __restrict__ parts, int vec) {
  const int zt = shard_plane<HALO>(p);
  const int z = zt / p.M, t = zt - z * p.M;
  // a (z, t) plane of the dual, the dual's plane (z, t) and its z stride
  const int64_t dplane = (int64_t)tab_nd(T) * p.Nr * p.Nc;
  const TD* yz = y + (HALO ? ext_plane(p, z, t, 1) : (int64_t)zt) * dplane;
  const int64_t zs = (HALO ? p.M + 2 : p.M) * dplane;
  const float s = primal_spec_body<T, VEC, TX, TD>(
      p, z, t, 2, 5, HALO ? 2 : t, HALO ? 5 : p.M, x, x0, yA, yz, yz - zs,
      yz + zs, tmul, out, vec);
  if constexpr (HALO) {
    if (threadIdx.x == 0)
      parts[(int64_t)zt * gridDim.x + blockIdx.x] = p.fid_scale * s;
  } else {
    slot_parts(p, zt, p.fid_scale * s, parts);
  }
}

// ------------------------------------------------------------- launches
// One block per BLOCK runs of VEC columns of a plane, the computed planes
// along blockIdx.y.
template <bool HALO>
static inline dim3 shard_grid(const Params* p) {
  return dim3((unsigned)dual_blocks<VEC>(p->Nr, p->Nc),
              (unsigned)((HALO ? p->Nz : p->Nz - 2) * p->M));
}

// Params that describe a shard's operands in the mode: the halo mode's
// ungated z and t and one plane of extension (of x for pass A, `xe`, of the
// dual for pass B, `ye`); the interior mode's ungated z, gated t and planes
// 1 .. Nz-2.
template <bool HALO>
static inline bool shard_params(const Params* p, int ext) {
  if (HALO) return p->sharded && p->t_free && ext == 1;
  return p->sharded && !p->t_free && p->Nz >= 3 && p->z_first == 1 &&
         p->z_last == p->Nz - 2;
}

template <Table T, typename TX, typename TD, bool HALO>
static int dual_launch(const Params* p, const void* x, const void* x0,
                       void* yA, void* yD, const void* tmul, void* parts,
                       cudaStream_t s) {
  // no separate output: y_A stands in for it
  const int vec = runs_aligned<VEC, TX, TD>(p, x, x0, yA, yD, yA, tmul);
  const dim3 grid = shard_grid<HALO>(p);
  cp_dual_shard_kernel<T, TX, TD, HALO><<<grid, BLOCK, 0, s>>>(
      *p, (const TX*)x, (const TX*)x0, (TX*)yA, (TD*)yD, (const float*)tmul,
      (float*)parts, vec);
  return (int)cudaGetLastError();
}

template <Table T, typename TX, typename TD, bool HALO>
static int primal_launch(const Params* p, const void* x, const void* x0,
                         const void* yA, const void* y, const void* tmul,
                         void* out, void* parts, cudaStream_t s) {
  const int vec = runs_aligned<VEC, TX, TD>(p, x, x0, yA, y, out, tmul);
  const dim3 grid = shard_grid<HALO>(p);
  cp_primal_shard_kernel<T, TX, TD, HALO><<<grid, BLOCK, 0, s>>>(
      *p, (const TX*)x, (const TX*)x0, (const TX*)yA, (const TD*)y,
      (const float*)tmul, (TX*)out, (float*)parts, vec);
  return (int)cudaGetLastError();
}

template <Table T, bool HALO>
static int dual_table(const Params* p, int x_bf16, int d_bf16, const void* x,
                      const void* x0, void* yA, void* yD, const void* tmul,
                      void* parts, cudaStream_t s) {
  typedef __nv_bfloat16 B;
  if (!x_bf16 && !d_bf16)
    return dual_launch<T, float, float, HALO>(p, x, x0, yA, yD, tmul, parts,
                                              s);
  if (!x_bf16)
    return dual_launch<T, float, B, HALO>(p, x, x0, yA, yD, tmul, parts, s);
  if (!d_bf16)
    return dual_launch<T, B, float, HALO>(p, x, x0, yA, yD, tmul, parts, s);
  return dual_launch<T, B, B, HALO>(p, x, x0, yA, yD, tmul, parts, s);
}

template <Table T, bool HALO>
static int primal_table(const Params* p, int x_bf16, int d_bf16,
                        const void* x, const void* x0, const void* yA,
                        const void* y, const void* tmul, void* out,
                        void* parts, cudaStream_t s) {
  typedef __nv_bfloat16 B;
  if (!x_bf16 && !d_bf16)
    return primal_launch<T, float, float, HALO>(p, x, x0, yA, y, tmul, out,
                                                parts, s);
  if (!x_bf16)
    return primal_launch<T, float, B, HALO>(p, x, x0, yA, y, tmul, out,
                                            parts, s);
  if (!d_bf16)
    return primal_launch<T, B, float, HALO>(p, x, x0, yA, y, tmul, out,
                                            parts, s);
  return primal_launch<T, B, B, HALO>(p, x, x0, yA, y, tmul, out, parts, s);
}

extern "C" {

// Number of partials the halo-mode launches write for an (Nz, M, Nr, Nc)
// shard: one per block of BLOCK runs of VEC columns.
long long spcp_num_parts(int Nz, int M, int Nr, int Nc) {
  return dual_num_parts<VEC>(Nz, M, Nr, Nc);
}

// ... and the array both interior launches write, shared with B8: one slot
// per BLOCK voxels of each plane (stencil.cuh's num_parts), of which they
// write the rows of planes 1 .. Nz-2.
long long spcp_interior_num_parts(int Nz, int M, int Nr, int Nc) {
  return num_parts(Nz, M, Nr, Nc);
}

// Each launches table `id` and returns cudaGetLastError() after the launch
// (0 = cudaSuccess), or cudaErrorInvalidValue for an id outside the mode's
// list or Params that do not describe a shard in the mode (the unsharded
// wrappers' Params among them).

// Pass A in the halo mode: x (Nz+2, M+2, Nr, Nc), the rest the shard's
// shape; Params with sharded, t_free and xe = 1.  All 21 tables.
int spcp_dual_halo_launch(const Params* p, int id, int x_bf16, int d_bf16,
                          const void* x, const void* x0, void* yA, void* yD,
                          const void* tmul, void* parts, void* stream) {
  if (!shard_params<true>(p, p->xe)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (id) {
#define SPEC_CASE(id, code)                                                 \
  case id:                                                                  \
    return dual_table<code, true>(p, x_bf16, d_bf16, x, x0, yA, yD, tmul,   \
                                  parts, s);
    CHANNEL_TABLES(SPEC_CASE)
#undef SPEC_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Pass A on planes 1 .. Nz-2: every operand the shard's shape; Params with
// sharded, not t_free, z_first = 1 and z_last = Nz - 2.
int spcp_dual_interior_launch(const Params* p, int id, int x_bf16,
                              int d_bf16, const void* x, const void* x0,
                              void* yA, void* yD, const void* tmul,
                              void* parts, void* stream) {
  if (!shard_params<false>(p, 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (id) {
#define INTERIOR_CASE(id)                                                   \
  case id:                                                                  \
    return dual_table<table_code(id), false>(p, x_bf16, d_bf16, x, x0, yA,  \
                                             yD, tmul, parts, s);
    TABLES_WITH_Z(INTERIOR_CASE)
#undef INTERIOR_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Pass B in the halo mode: the dual read from y_ext (Nz+2, M+2, Nd, Nr,
// Nc) alone, the rest the shard's shape; Params with sharded, t_free and
// ye = 1.  All 21 tables.
int spcp_primal_halo_launch(const Params* p, int id, int x_bf16, int d_bf16,
                            const void* x, const void* x0, const void* yA,
                            const void* y_ext, const void* tmul, void* out,
                            void* parts, void* stream) {
  if (!shard_params<true>(p, p->ye)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (id) {
#define SPEC_CASE(id, code)                                                 \
  case id:                                                                  \
    return primal_table<code, true>(p, x_bf16, d_bf16, x, x0, yA, y_ext,    \
                                    tmul, out, parts, s);
    CHANNEL_TABLES(SPEC_CASE)
#undef SPEC_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Pass B on planes 1 .. Nz-2, the dual read from y_D: as the interior pass A.
int spcp_primal_interior_launch(const Params* p, int id, int x_bf16,
                                int d_bf16, const void* x, const void* x0,
                                const void* yA, const void* yD,
                                const void* tmul, void* out, void* parts,
                                void* stream) {
  if (!shard_params<false>(p, 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (id) {
#define INTERIOR_CASE(id)                                                   \
  case id:                                                                  \
    return primal_table<table_code(id), false>(p, x_bf16, d_bf16, x, x0,    \
                                               yA, yD, tmul, out, parts,   \
                                               s);
    TABLES_WITH_Z(INTERIOR_CASE)
#undef INTERIOR_CASE
  }
  return (int)cudaErrorInvalidValue;
}

const char* spcp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
