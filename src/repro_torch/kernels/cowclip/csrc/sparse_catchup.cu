// Sparse gather + closed-form lazy-decay catch-up for Hopper (sm_90a),
// every table of a step in one launch.
//
// Replaces the TPU kernel repro/kernels/cowclip/sparse.py:
// sparse_gather_catchup (Pallas body `_catchup_kernel`), which a step
// called once per table. For each slot of each table, with row =
// uid - row_offset clamped into the table:
//
//   k      = max(lim - last_step[row], 0)          (lim = step - 1)
//   w_out  = w[row] * (k > 0 ? factor**k : 1)      m_out = m[row]
//   v_out  = v[row]
//
// and `depth` = the largest k over the real slots of all tables (the
// step's catch-up depth diagnostic). The k == 0 guard multiplies by
// exactly 1.0, so a row that is already caught up passes through bit for
// bit. Pad slots (count 0) read no table row and write zero rows. The
// step comes from its block in device memory (`CowclipStep`), read at each
// block's start, so a captured CUDA graph takes each replay's step.
//
// Bound: device-memory bytes. Per slot its count is read and 3 rows
// written (4 + 12*dim bytes); a real slot also reads its uid, its
// last_step and 3 table rows (8 + 12*dim). At deepfm-criteo width and
// batch 131072 the largest table's slot set (cap 131072, ~36k real) is
// 20.9 MB, 6.2 us at 3.35 TB/s; one step's 52 tables (1,058,061 slots a
// group, ~281k real) are ~190 MB, ~56.6 us. (The kernel reads a pad's
// uid beside its count, in the same trip: 4 bytes a pad more.)
//
// What held the first design (one launch per table, a thread per output
// element) back, and what this one does about it:
// - Launches: 52 a step, most on fields of a few hundred or thousand
//   slots, where a launch costs its overhead and one or two dependent
//   trips to memory. Here one launch takes up to kSparseMaxTables tables,
//   described by value in one __grid_constant__ parameter (the descriptor
//   array: no copy to the card, no host sync). Each table gets
//   ceil(cap / slots a block) blocks; a block finds its table by a binary
//   search over the blocks' prefix, so the grid is one flat index over
//   every table's slots.
// - Dependent loads: every element read counts, then uids, then
//   last_step[row], then the row, and redid a 64-bit division (i / dim)
//   and a powf for each of a slot's dim elements. Here a warp owns up to
//   32 slots, whose rows fill at most kWarpElems (160) elements: lane l
//   reads slot l's count and uid (one trip), then issues its slot's
//   last_step load and the row loads of all its 5 elements together (a
//   second trip), the rows' indices passed between lanes by shuffles, and
//   computes factor**k once a slot. The slot and column are carried from
//   one element to the next (one 32-bit division a lane), and no barrier
//   stands between the trips.
// - Pad slots: still written (the contract: finite rows for every slot),
//   as coalesced stores of zeros, with no table read.
// The three outputs of a warp's slots are one contiguous range, so every
// store is 128 contiguous bytes. The depth is a warp max, a block max and
// one atomicMax a block with a pending row (order-free).
//
// What the byte bound leaves out: a real slot's last_step and three rows
// sit at a random row of a large table, so the card moves whole 32-byte
// sectors for 4- and 40-byte pieces at a random-access rate, and the
// coalesced stores (73% of them a batch's pad rows) share the same
// memory.
#include "sparse_cowclip.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// A warp owns the slots whose rows fill at most kWarpElems elements (from 1
// to 32 slots); a wider row goes in chunks of kWarpElems. 5 a lane keeps a
// thread at 64 registers, so 4 blocks fit an SM (10 a lane needed more,
// fit fewer blocks and was slower over a step's tables).
constexpr int kWarpElems = 160;
constexpr int kPerLane = kWarpElems / 32;   // elements a lane a chunk
constexpr unsigned kFull = 0xffffffffu;
static_assert(kPerLane * 32 == kWarpElems, "whole lanes");

struct CatchupParams {
  SparseCatchupTable tables[kSparseMaxTables];
  int block_begin[kSparseMaxTables + 1];  // first block of each table
  int n;
  const CowclipStep* step;
  float factor;
  int* depth;
};
// Hopper under CUDA 12.1+ takes up to 32,764 bytes of kernel parameters.
static_assert(sizeof(CatchupParams) <= 32764, "descriptor too large");

__global__ void __launch_bounds__(kThreads, 4)
sparse_catchup_kernel(const __grid_constant__ CatchupParams p) {
  __shared__ int s_depth[kWarps];

  const int lim = p.step->step - 1;
  const int t = sparse_find_table(p.block_begin, p.n, blockIdx.x);
  const SparseCatchupTable tb = p.tables[t];
  const int dim = tb.dim;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per_warp = sparse_warp_slots(dim, kWarpElems);
  const long long first =
      (static_cast<long long>(blockIdx.x - p.block_begin[t]) * kWarps +
       warp) * per_warp;
  const long long left = tb.cap - first;
  const int n = left <= 0 ? 0 : (left < per_warp ? static_cast<int>(left)
                                                 : per_warp);

  // trip 1: lane l reads slot l's count and uid
  long long row = -1;   // -1 for a pad
  if (lane < n) {
    const float c = tb.counts[first + lane];
    const int uid = tb.uids[first + lane];
    if (c > 0.0f) {
      row = static_cast<long long>(uid) - tb.row_offset;
      row = row < 0 ? 0 : (row >= tb.rows ? tb.rows - 1 : row);
    }
  }

  // trip 2: the slot's last_step and the rows of the warp's elements, in
  // chunks of kWarpElems (one chunk up to 160 elements), all loaded
  // before the chunk's first store
  const int ls = row >= 0 ? tb.last_step[row] : 0;
  const long long base = first * dim;
  const int n_elems = n * dim;
  const int slot_step = 32 / dim;
  const int j_step = 32 - slot_step * dim;
  int k = 0;
  float scale = 1.0f;
  for (int c0 = 0; c0 < n_elems; c0 += kWarpElems) {
    float wv[kPerLane], mv[kPerLane], vv[kPerLane];
    const int slot0 = (c0 + lane) / dim;
    int slot = slot0;
    int j = c0 + lane - slot * dim;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int e = c0 + lane + 32 * i;
      const long long r = __shfl_sync(kFull, row, min(slot, 31));
      wv[i] = mv[i] = vv[i] = 0.0f;
      if (e < n_elems && r >= 0) {
        const long long src = r * dim + j;
        wv[i] = tb.w[src];
        mv[i] = tb.m[src];
        vv[i] = tb.v[src];
      }
      sparse_next_element(slot, j, slot_step, j_step, dim);
    }
    if (c0 == 0 && row >= 0) {
      k = max(lim - ls, 0);
      scale = k > 0 ? powf(p.factor, static_cast<float>(k)) : 1.0f;
    }
    slot = slot0;
    j = c0 + lane - slot * dim;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int e = c0 + lane + 32 * i;
      const float sc = __shfl_sync(kFull, scale, min(slot, 31));
      if (e < n_elems) {
        tb.w_out[base + e] = wv[i] * sc;
        tb.m_out[base + e] = mv[i];
        tb.v_out[base + e] = vv[i];
      }
      sparse_next_element(slot, j, slot_step, j_step, dim);
    }
  }

  // the deepest catch-up: a warp max, a block max, one atomic
  if (p.depth == nullptr) return;
  k = __reduce_max_sync(kFull, k);
  if (lane == 0) s_depth[warp] = k;
  __syncthreads();
  if (threadIdx.x == 0) {
    int deepest = 0;
    for (int i = 0; i < kWarps; ++i) deepest = max(deepest, s_depth[i]);
    if (deepest > 0) atomicMax(p.depth, deepest);
  }
}

}  // namespace

void sparse_catchup_launch(const SparseCatchupTable* tables, int n,
                           const CowclipStep* step, float factor, int* depth,
                           cudaStream_t stream) {
  CatchupParams p;
  for (int t = 0; t < n; ++t) p.tables[t] = tables[t];
  const int blocks =
      sparse_block_prefix(tables, n, kWarps, kWarpElems, p.block_begin);
  p.n = n;
  p.step = step;
  p.factor = factor;
  p.depth = depth;
  if (blocks == 0) return;
  sparse_catchup_kernel<<<blocks, kThreads, 0, stream>>>(p);
}
