// The boundary kernels of the overlapped z-sharded Chambolle-Pock step for
// NVIDIA Hopper (sm_90a), specialised per channel table (csrc/tables.cuh),
// bound to Python through a plain C interface (ctypes).
//
// Replace the Pallas TPU kernels of pytv4d_tpu/kernels/fused.py:
//   bnd_dual_kernel   <- make_cp_dual_boundary_kernel   (fused.py:1093)
//   bnd_primal_kernel <- make_cp_primal_boundary_kernel (fused.py:1187)
// The overlapped step (parallel/fused_halo.py, overlap=True) first takes the
// two z-edge planes of every shard's x for its neighbours, runs passes A and
// B of csrc/specialised_cp.cu over the planes 1..Nz-2 of each shard (which
// need no neighbour's data), and then these two kernels redo the planes
// z = 0 and z = Nz-1 from the exchanged planes, in place into the same
// arrays and into the same array of partials.  Slot b of a (2, ...) halo
// stack is the plane from the left neighbour (b = 0: the value at z - 1 of
// plane 0) or from the right one (b = 1: the value at z + 1 of plane
// Nz-1); at a global edge the x stack holds the ghost plane that makes
// every z difference there zero and the dual stack holds zeros.  Time is
// not sharded on this path, so the t gates stay on; the z gate is off:
// every z neighbour is read.
//
// Layouts as in stencil.cuh; x_halo is (2, M, Nr, Nc), y_halo
// (2, M, Nd, Nr, Nc).
//
// What bounds them: HBM bytes, once the per-channel work is gone.  The
// generic bodies they replace (voxel.cuh's cp_dual_voxel and
// cp_primal_voxel) switched on each channel's axis and kind at run time,
// built six 64-bit offsets a voxel and loaded each channel's neighbours
// apart.  Here, as in csrc/specialised.cu for the unsharded pass A:
//   - the table is a template argument (only tables.cuh's TABLES_WITH_Z:
//     the ones with a z channel, which the overlapped path requires), so the
//     channel loops unroll with no runtime axis or kind;
//   - offsets within a plane are 32-bit (specialised.cuh's Offset);
//   - a thread takes VEC_BND = 2 columns, one access per array and per
//     channel, and loads each neighbour run a channel reads once
//     (specialised.cuh: dual_spec_body, primal_spec_body);
//   - the edge side b is the block's (blockIdx.y), so the planes across the
//     edge -- the halo slot or the shard's own neighbour plane -- are chosen
//     once per block, not per channel.
// The arithmetic is the generic bodies' operation for operation and in the
// same order (-fmad=false), so y_A', y_D' and x' equal theirs, and the
// ghost-plane step's, to the bit.
//
// Partials: the interior launch's array (specialised_cp.cu, in
// stencil.cuh's num_parts layout) owns ceil(Nr Nc / BLOCK) slots per plane;
// these kernels, with half as many blocks a plane, write each block's sum
// to its own slot and zeros to the slots past the last block
// (specialised.cuh's slot_parts), as the interior launches do on the inner
// planes, so that every slot is written once and the loss moves only by
// the order of a sum.

#include "specialised.cuh"

constexpr int VEC_BND = 2;  // columns per thread

// The edge plane of the block: blockIdx.y = b * M + t is time t of edge b,
// plane z = 0 (b = 0) or z = Nz - 1 (b = 1).
struct Edge {
  int b, z, t;
};
__device__ __forceinline__ Edge edge_of(const Params& p) {
  Edge e;
  e.b = blockIdx.y / p.M;
  e.t = blockIdx.y - e.b * p.M;
  e.z = e.b * (p.Nz - 1);
  return e;
}

// The block's partial s into the interior launch's array, at the edge
// plane's row (slot_parts).
__device__ __forceinline__ void edge_parts(const Params& p, const Edge& e,
                                           float s, float* parts) {
  slot_parts(p, e.z * p.M + e.t, s, parts);
}

// Pass A on the two edge planes: y_A', y_D' in place and the planes' TV
// partials of D x into `parts` (the interior launch's array).
template <Table T, typename TX, typename TD>
__global__ void __launch_bounds__(BLOCK)
bnd_dual_kernel(const Params p, const TX* __restrict__ x,
                const TX* __restrict__ x_halo, const TX* __restrict__ x0,
                TX* __restrict__ yA, TD* __restrict__ yD,
                const float* __restrict__ tmul, float* __restrict__ parts,
                int vec) {
  const Edge e = edge_of(p);
  const int64_t plane = (int64_t)p.Nr * p.Nc;
  const TX* xz = x + (e.z * p.M + e.t) * plane;
  const TX* h = x_halo + (e.b * p.M + e.t) * plane;
  // z gate off: position 1 of 3, where every z channel reads both sides
  const float s = dual_spec_body<T, VEC_BND, true, TX, TD>(
      p, e.z, e.t, 1, 3, e.t, p.M, xz, e.b == 0 ? h : xz - p.M * plane,
      e.b == 1 ? h : xz + p.M * plane, x0, yA, yD, tmul, vec);
  edge_parts(p, e, s, parts);
}

// Pass B on the two edge planes: x' in place and the planes' fidelity
// partials of x' into `parts`.  Only the z channels of the halo stack are
// read.
template <Table T, typename TX, typename TD>
__global__ void __launch_bounds__(BLOCK)
bnd_primal_kernel(const Params p, TX* __restrict__ x,
                  const TX* __restrict__ x0, const TX* __restrict__ yA,
                  const TD* __restrict__ yD, const TD* __restrict__ y_halo,
                  const float* __restrict__ tmul, float* __restrict__ parts,
                  int vec) {
  const Edge e = edge_of(p);
  const int64_t dplane = (int64_t)tab_nd(T) * p.Nr * p.Nc;  // a (z, t) plane
  const TD* yz = yD + (e.z * p.M + e.t) * dplane;            // of the dual
  const TD* h = y_halo + (e.b * p.M + e.t) * dplane;
  // z gate off: position 2 of 5, where FWD, BWD and CTR read both sides
  const float s = primal_spec_body<T, VEC_BND, TX, TD>(
      p, e.z, e.t, 2, 5, e.t, p.M, x, x0, yA, yz,
      e.b == 0 ? h : yz - p.M * dplane, e.b == 1 ? h : yz + p.M * dplane,
      tmul, x, vec);
  edge_parts(p, e, p.fid_scale * s, parts);
}

// ------------------------------------------------------------- launches
// One block per BLOCK runs of VEC_BND columns of a plane, the two edges'
// M planes along blockIdx.y.
static inline dim3 edge_grid(const Params* p) {
  return dim3((unsigned)dual_blocks<VEC_BND>(p->Nr, p->Nc),
              (unsigned)(2 * p->M));
}

template <typename TX, typename TD>
static int runs_aligned(const Params* p, const void* x, const void* h,
                        const void* x0, const void* yA, const void* yD,
                        const void* y_halo, const void* tmul) {
  return p->Nc % VEC_BND == 0 && aligned(x, VEC_BND * sizeof(TX)) &&
         aligned(h, VEC_BND * sizeof(TX)) &&
         aligned(x0, VEC_BND * sizeof(TX)) &&
         aligned(yA, VEC_BND * sizeof(TX)) &&
         aligned(yD, VEC_BND * sizeof(TD)) &&
         aligned(y_halo, VEC_BND * sizeof(TD)) &&
         (!p->has_tmul || aligned(tmul, VEC_BND * sizeof(float)));
}

template <Table T, typename TX, typename TD>
static int dual_launch(const Params* p, const void* x, const void* x_halo,
                       const void* x0, void* yA, void* yD, const void* tmul,
                       void* parts, cudaStream_t s) {
  const int vec = runs_aligned<TX, TD>(p, x, x_halo, x0, yA, yD, yD, tmul);
  bnd_dual_kernel<T, TX, TD><<<edge_grid(p), BLOCK, 0, s>>>(
      *p, (const TX*)x, (const TX*)x_halo, (const TX*)x0, (TX*)yA, (TD*)yD,
      (const float*)tmul, (float*)parts, vec);
  return (int)cudaGetLastError();
}

template <Table T, typename TX, typename TD>
static int primal_launch(const Params* p, void* x, const void* x0,
                         const void* yA, const void* yD, const void* y_halo,
                         const void* tmul, void* parts, cudaStream_t s) {
  const int vec = runs_aligned<TX, TD>(p, x, x, x0, yA, yD, y_halo, tmul);
  bnd_primal_kernel<T, TX, TD><<<edge_grid(p), BLOCK, 0, s>>>(
      *p, (TX*)x, (const TX*)x0, (const TX*)yA, (const TD*)yD,
      (const TD*)y_halo, (const float*)tmul, (float*)parts, vec);
  return (int)cudaGetLastError();
}

template <Table T>
static int dual_table(const Params* p, int x_bf16, int d_bf16, const void* x,
                      const void* x_halo, const void* x0, void* yA, void* yD,
                      const void* tmul, void* parts, cudaStream_t s) {
  typedef __nv_bfloat16 B;
  if (!x_bf16 && !d_bf16)
    return dual_launch<T, float, float>(p, x, x_halo, x0, yA, yD, tmul, parts,
                                        s);
  if (!x_bf16)
    return dual_launch<T, float, B>(p, x, x_halo, x0, yA, yD, tmul, parts, s);
  if (!d_bf16)
    return dual_launch<T, B, float>(p, x, x_halo, x0, yA, yD, tmul, parts, s);
  return dual_launch<T, B, B>(p, x, x_halo, x0, yA, yD, tmul, parts, s);
}

template <Table T>
static int primal_table(const Params* p, int x_bf16, int d_bf16, void* x,
                        const void* x0, const void* yA, const void* yD,
                        const void* y_halo, const void* tmul, void* parts,
                        cudaStream_t s) {
  typedef __nv_bfloat16 B;
  if (!x_bf16 && !d_bf16)
    return primal_launch<T, float, float>(p, x, x0, yA, yD, y_halo, tmul,
                                          parts, s);
  if (!x_bf16)
    return primal_launch<T, float, B>(p, x, x0, yA, yD, y_halo, tmul, parts,
                                      s);
  if (!d_bf16)
    return primal_launch<T, B, float>(p, x, x0, yA, yD, y_halo, tmul, parts,
                                      s);
  return primal_launch<T, B, B>(p, x, x0, yA, yD, y_halo, tmul, parts, s);
}

extern "C" {

// Number of partials of the array the boundary kernels write two planes'
// rows of: the interior launches' (specialised_cp.cu's
// spcp_interior_num_parts), one slot per BLOCK voxels of a plane.
long long bnd_num_parts(int Nz, int M, int Nr, int Nc) {
  return num_parts(Nz, M, Nr, Nc);
}

// Both launch table `id` of TABLES_WITH_Z and return cudaGetLastError()
// after the launch (0 = cudaSuccess), or cudaErrorInvalidValue for an id
// outside the list.
int cp_dual_boundary_launch(const Params* p, int id, int x_bf16, int d_bf16,
                            const void* x, const void* x_halo, const void* x0,
                            void* yA, void* yD, const void* tmul, void* parts,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (id) {
#define BND_CASE(id)                                                        \
  case id:                                                                  \
    return dual_table<table_code(id)>(p, x_bf16, d_bf16, x, x_halo, x0, yA, \
                                      yD, tmul, parts, s);
    TABLES_WITH_Z(BND_CASE)
#undef BND_CASE
  }
  return (int)cudaErrorInvalidValue;
}

int cp_primal_boundary_launch(const Params* p, int id, int x_bf16,
                              int d_bf16, void* x, const void* x0,
                              const void* yA, const void* yD,
                              const void* y_halo, const void* tmul,
                              void* parts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (id) {
#define BND_CASE(id)                                                          \
  case id:                                                                    \
    return primal_table<table_code(id)>(p, x_bf16, d_bf16, x, x0, yA, yD,   \
                                        y_halo, tmul, parts, s);
    TABLES_WITH_Z(BND_CASE)
#undef BND_CASE
  }
  return (int)cudaErrorInvalidValue;
}

const char* bnd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
