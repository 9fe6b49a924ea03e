// Plain C interface between the sparse unique-id CowClip kernels
// (sparse_catchup.cu, sparse_update.cu) and their PyTorch binding
// (kernels/csrc/binding.cpp). No PyTorch header is included here, so nvcc
// compiles the kernels in seconds.
//
// Each kernel takes a list of up to kSparseMaxTables tables in one launch
// (the 26 fm and 26 LR tables of deepfm-criteo are one step's list). A
// table is described by one struct below: its [rows, dim] f32 tables and
// [rows] int32 last_step, its [cap] int32 slot uids and f32 counts, and
// its [cap, dim] f32 slot rows, all contiguous.
#pragma once

#include <cuda_runtime.h>

#include "cowclip_adam.h"

constexpr int kSparseMaxTables = 64;

struct SparseCatchupTable {
  const float* w;
  const float* m;
  const float* v;
  const int* last_step;
  const int* uids;
  const float* counts;
  float* w_out;
  float* m_out;
  float* v_out;
  long long rows;
  long long row_offset;
  int cap;
  int dim;
};

struct SparseUpdateTable {
  float* w;
  float* m;
  float* v;
  int* last_step;
  const int* uids;
  const float* counts;
  const float* w_rows;
  const float* g_rows;
  const float* m_rows;
  const float* v_rows;
  long long rows;
  long long row_offset;
  int cap;
  int dim;
  int do_clip;  // clip && dim >= 2: 1-dim LR-stream tables are exempt
};

// For each of the n tables: gathers the rows of its `cap` slots from w, m,
// v at uid - row_offset (clamped into the table) and scales w by
// factor**k, k = max(lim - last_step[row], 0); exactly 1.0 at k == 0.
// Pad slots (counts == 0) read nothing and write zero rows. `depth` (one
// int32 on the card, or null for none) is raised to the largest k over the
// real slots of all tables; the caller zeroes it first. n <=
// kSparseMaxTables.
void sparse_catchup_launch(const SparseCatchupTable* tables, int n, int lim,
                           float factor, int* depth, cudaStream_t stream);

// For each of the n tables and each slot with counts > 0 whose row
// uid - row_offset lies in the table: CowClip (do_clip), coupled L2 and
// Adam on the caught-up slot rows, the new (w, m, v) written in place at
// that row and last_step stamped with `step`. Pad slots write nothing.
// p.factor and p.do_clip are not read (do_clip is per table). The uids of
// one table must be distinct. n <= kSparseMaxTables.
void sparse_update_launch(const SparseUpdateTable* tables, int n, int step,
                          CowclipAdamParams p, cudaStream_t stream);

#ifdef __CUDACC__
// What the two kernels share: a warp owns the slots whose rows fill at most
// `elems` elements, and the grid is one flat index over the blocks of
// every table. Seen by nvcc only, not by the binding.

// Slots a warp owns: as many as fill `elems`, from 1 to 32.
__host__ __device__ inline int sparse_warp_slots(int dim, int elems) {
  const int slots = elems / dim;
  return slots < 1 ? 1 : (slots > 32 ? 32 : slots);
}

// Each table's first block, in begin[0..n]: ceil(cap / slots a block)
// blocks for a table with rows and a positive dim, none otherwise, and
// the total in begin[n], which is returned.
template <class Table>
inline int sparse_block_prefix(const Table* tables, int n, int warps,
                               int elems, int* begin) {
  int blocks = 0;
  for (int t = 0; t < n; ++t) {
    begin[t] = blocks;
    if (tables[t].rows > 0 && tables[t].dim > 0) {
      const int per_block = warps * sparse_warp_slots(tables[t].dim, elems);
      blocks += (tables[t].cap + per_block - 1) / per_block;
    }
  }
  begin[n] = blocks;
  return blocks;
}

// The table whose blocks hold block b: the last t with begin[t] <= b
// (tables with no slots have no blocks and are skipped).
__device__ inline int sparse_find_table(const int* begin, int n, int b) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (begin[mid] <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// Element e's (slot, column) to element e + 32's: slot_step = 32 / dim,
// j_step = 32 % dim.
__device__ inline void sparse_next_element(int& slot, int& j, int slot_step,
                                           int j_step, int dim) {
  slot += slot_step;
  j += j_step;
  if (j >= dim) {
    j -= dim;
    ++slot;
  }
}
#endif  // __CUDACC__
