// The channel tables that core/schemes.py::scheme_channels can produce, each
// under a fixed id and in scheme_channels' channel order.  The specialised
// CP pass A and TV pass 2 (csrc/specialised.cu), TV pass 1 and pass A for
// inverse problems (csrc/specialised_tv.cu) and the sharded CP step's
// boundary passes (csrc/cp_boundary.cu) take a table as a template
// argument, so their channel loops unroll with no runtime axis or kind.
// kernels/tables.py mirrors this list and maps a (cfg, Nz, M) to its id;
// tests/test_torch_channel_tables.py holds the two equal.
//
// A table is one 64-bit code: Nd in bits 0-3, channel i in the 4 bits from
// 4 + 4 i (its axis AX_* in the low two, its kind K_* in the high two).

#pragma once

#include "stencil.cuh"

typedef unsigned long long Table;

#define CHAN(axis, kind) ((AX_##axis) | ((K_##kind) << 2))

template <typename... C>
constexpr Table table(C... ch) {
  Table code = sizeof...(ch);
  int shift = 4;
  ((code |= (Table)ch << shift, shift += 4), ...);
  return code;
}

__host__ __device__ constexpr int tab_nd(Table t) { return (int)(t & 15u); }
__host__ __device__ constexpr int tab_axis(Table t, int i) {
  return (int)(t >> (4 + 4 * i)) & 3;
}
__host__ __device__ constexpr int tab_kind(Table t, int i) {
  return (int)(t >> (6 + 4 * i)) & 3;
}
// Whether a channel of t runs along `axis`, of kind `kind` (-1: any kind).
__host__ __device__ constexpr bool tab_has(Table t, int axis, int kind = -1) {
  for (int i = 0; i < tab_nd(t); ++i)
    if (tab_axis(t, i) == axis && (kind < 0 || tab_kind(t, i) == kind))
      return true;
  return false;
}

// X(id, code), one family per scheme; central in two: z in {off, CTR} x t
// in {off, CTR}, then the tables with a FWD z (Nz == 2) or t (M == 2)
// channel.
#define UPWIND_TABLES(X)                                                    \
  X(0, table(CHAN(ROW, FWD), CHAN(COL, FWD)))                               \
  X(1, table(CHAN(ROW, FWD), CHAN(COL, FWD), CHAN(Z, FWD)))                 \
  X(2, table(CHAN(ROW, FWD), CHAN(COL, FWD), CHAN(T, FWD)))                 \
  X(3, table(CHAN(ROW, FWD), CHAN(COL, FWD), CHAN(Z, FWD), CHAN(T, FWD)))

#define DOWNWIND_TABLES(X)                                                  \
  X(4, table(CHAN(ROW, BWD), CHAN(COL, BWD)))                               \
  X(5, table(CHAN(ROW, BWD), CHAN(COL, BWD), CHAN(Z, BWD)))                 \
  X(6, table(CHAN(ROW, BWD), CHAN(COL, BWD), CHAN(T, BWD)))                 \
  X(7, table(CHAN(ROW, BWD), CHAN(COL, BWD), CHAN(Z, BWD), CHAN(T, BWD)))

#define HYBRID_TABLES(X)                                                    \
  X(8, table(CHAN(ROW, FWD), CHAN(COL, FWD), CHAN(ROW, BWD), CHAN(COL, BWD))) \
  X(9, table(CHAN(ROW, FWD), CHAN(COL, FWD), CHAN(ROW, BWD), CHAN(COL, BWD), \
             CHAN(Z, FWD), CHAN(Z, BWD)))                                   \
  X(10, table(CHAN(ROW, FWD), CHAN(COL, FWD), CHAN(ROW, BWD), CHAN(COL, BWD), \
              CHAN(T, FWD), CHAN(T, BWD)))                                  \
  X(11, table(CHAN(ROW, FWD), CHAN(COL, FWD), CHAN(ROW, BWD), CHAN(COL, BWD), \
              CHAN(Z, FWD), CHAN(Z, BWD), CHAN(T, FWD), CHAN(T, BWD)))

#define CENTRAL_TABLES(X)                                                   \
  X(12, table(CHAN(ROW, CTR), CHAN(COL, CTR)))                              \
  X(13, table(CHAN(ROW, CTR), CHAN(COL, CTR), CHAN(Z, CTR)))                \
  X(14, table(CHAN(ROW, CTR), CHAN(COL, CTR), CHAN(T, CTR)))                \
  X(15, table(CHAN(ROW, CTR), CHAN(COL, CTR), CHAN(Z, CTR), CHAN(T, CTR)))

#define CENTRAL_FWD_TABLES(X)                                               \
  X(16, table(CHAN(ROW, CTR), CHAN(COL, CTR), CHAN(Z, FWD)))                \
  X(17, table(CHAN(ROW, CTR), CHAN(COL, CTR), CHAN(Z, FWD), CHAN(T, CTR)))  \
  X(18, table(CHAN(ROW, CTR), CHAN(COL, CTR), CHAN(Z, FWD), CHAN(T, FWD)))  \
  X(19, table(CHAN(ROW, CTR), CHAN(COL, CTR), CHAN(T, FWD)))                \
  X(20, table(CHAN(ROW, CTR), CHAN(COL, CTR), CHAN(Z, CTR), CHAN(T, FWD)))

#define CHANNEL_TABLES(X)                                                   \
  UPWIND_TABLES(X) DOWNWIND_TABLES(X) HYBRID_TABLES(X) CENTRAL_TABLES(X)    \
  CENTRAL_FWD_TABLES(X)

// The code of table `id` (0 for an id outside the list), for a source that
// instantiates only some of the tables.
constexpr Table table_code(int id) {
#define TABLE_CODE(i, code) \
  if (id == i) return code;
  CHANNEL_TABLES(TABLE_CODE)
#undef TABLE_CODE
  return 0;
}

// X(id): the tables with a z channel on a volume of Nz >= 3, where
// central's z channel is CTR (tables 16-18 need Nz == 2).  The kernels that
// require a z channel instantiate only these: the overlapped z-sharded CP
// step's (csrc/cp_boundary.cu, and the interior launches of
// csrc/specialised_cp.cu; its shards of >= 3 planes make Nz >= 6) and the
// z-marching pass A (csrc/cp_zstream.cu).  kernels/tables.py mirrors the
// list (BOUNDARY_TABLES, ZSTREAM_TABLES).
#define TABLES_WITH_Z(X) X(1) X(3) X(5) X(7) X(9) X(11) X(13) X(15) X(20)

#define TABLE_HAS_Z(id)                                \
  static_assert(tab_has(table_code(id), AX_Z),           \
                "a table of TABLES_WITH_Z differences along z");
TABLES_WITH_Z(TABLE_HAS_Z)
#undef TABLE_HAS_Z
