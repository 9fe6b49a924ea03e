// Sparse CowClip + coupled-L2 + Adam update, scattered in place, for
// Hopper (sm_90a), every table of a step in one launch.
//
// Replaces the TPU kernel repro/kernels/cowclip/sparse.py:
// sparse_update_scatter (Pallas body `_update_kernel`, with the
// `last_step` stamp its wrapper in ops.py made), which a step called once
// per table. For each slot with count c > 0, on the caught-up slot rows
// (w, g, m, v):
//
//   clip_t = c * max(r * ||w||, zeta)                   (when do_clip)
//   g     <- g * min(1, clip_t / (||g|| + 1e-30))
//   g     <- g + l2 * w
//   m     <- b1*m + (1-b1)*g ;  v <- b2*v + (1-b2)*g*g
//   w     <- w - lr * (m*bc1) / (sqrt(v*bc2) + eps)
//
// and (w, m, v) land at table row uid - row_offset, last_step[row] = step.
// The step and bc1, bc2 come from the step's block in device memory
// (`CowclipStep`), read at each block's start; where the guard's flag is 0
// every block returns before writing. Pad slots (c == 0) and rows outside
// the table write nothing. The uids of
// one table are distinct, so no two slots write one row: no atomics, and
// blocks need no order. JAX wrote in place through input_output_aliases;
// here the tables are simply written.
//
// Bound: O(1) flops per byte, so device-memory bytes: per slot its count
// (4 bytes); per real slot its uid, 4 slot rows read, 3 table rows and
// last_step written (8 + 28*dim). At deepfm-criteo width and batch 131072
// the largest table (cap 131072, ~36k real) needs 11.0 MB, 3.3 us at
// 3.35 TB/s; one step's 52 tables ~99.6 MB, ~29.7 us.
//
// What held the first design (one launch per table; a lane group of
// next-pow2(dim) lanes per slot) back, and what this one does about it:
// - Launches: 52 a step, mostly on small fields. Here one launch takes up
//   to kSparseMaxTables tables, described by value in one
//   __grid_constant__ parameter; each table gets ceil(cap / slots a
//   block) blocks and a block finds its table by a binary search over the
//   blocks' prefix.
// - Dependent loads: each lane read counts, then uids, then the slot
//   rows, with the two norms reduced by shuffles across a lane group that
//   left 6 of 16 lanes idle at dim 10. Here a warp owns up to 32 slots,
//   whose rows fill at most kWarpElems elements (10 a lane): lane l
//   reads slot l's count and uid (one trip), then the warp loads the four
//   slot rows of all its real slots with coalesced loads, every load of a
//   lane issued before its first use (a second trip); w and g go through
//   the warp's shared memory so that lane l takes slot l's two norms in
//   order, and the table rows are written from registers. No block
//   barrier: the warps run apart.
// - Pad slots: a warp with no real slot costs its counts and returns;
//   pads beside real slots load nothing.
// A row wider than kWarpElems (one slot a warp) goes in chunks, its
// norms reduced across the warp by shuffles.
//
// What the byte bound leaves out: each real slot writes its w, m and v
// rows and its last_step at a random row of a large table, 40, 40, 40
// and 4 bytes at dim 10, and every one of them lands in 32-byte sectors
// it only partly covers, which the card must read before it writes them
// back.
#include "sparse_cowclip.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// A warp owns the slots whose rows fill at most kWarpElems elements (from 1
// to 32 slots). 10 a lane: a thread holds its elements' four slot-row
// values in registers, 2 blocks an SM (5 a lane, held to 4 blocks an SM,
// spilled and was slower over a step's tables).
constexpr int kWarpElems = 320;
constexpr int kPerLane = kWarpElems / 32;   // elements a lane
constexpr unsigned kFull = 0xffffffffu;
static_assert(kPerLane * 32 == kWarpElems, "whole lanes");
// a warp's staged rows: its slots' rows at an odd pitch (dim | 1), so lane
// l walking row l hits distinct banks; slots * pitch <= elems + slots
constexpr int kStaged = kWarpElems + 32;

struct UpdateParams {
  SparseUpdateTable tables[kSparseMaxTables];
  int block_begin[kSparseMaxTables + 1];  // first block of each table
  int n;
  CowclipAdamParams p;
  const CowclipStep* step;
  const int* ok;  // null: no guard
};
// Hopper under CUDA 12.1+ takes up to 32,764 bytes of kernel parameters.
static_assert(sizeof(UpdateParams) <= 32764, "descriptor too large");

// The CowClip scale of a row from its count and the squares of its two
// norms.
__device__ inline float clip_scale(float c, float gsq, float wsq,
                                   const CowclipAdamParams& h) {
  const float clip_t = c * fmaxf(h.r * sqrtf(wsq), h.zeta);
  return fminf(1.0f, clip_t / (sqrtf(gsq) + 1e-30f));
}

// Coupled L2 + Adam on one element; writes the table row's element.
__device__ inline void adam_element(const SparseUpdateTable& tb,
                                    const CowclipAdamParams& h, float bc1,
                                    float bc2, long long dst, float w,
                                    float g, float scale, float m, float v) {
  const float gl = g * scale + h.l2 * w;
  const float m2 = h.b1 * m + h.one_minus_b1 * gl;
  const float v2 = h.b2 * v + h.one_minus_b2 * gl * gl;
  const float upd = (m2 * bc1) / (sqrtf(v2 * bc2) + h.eps);
  tb.w[dst] = w - h.lr * upd;
  tb.m[dst] = m2;
  tb.v[dst] = v2;
}

__global__ void __launch_bounds__(kThreads, 2)
sparse_update_kernel(const __grid_constant__ UpdateParams p) {
  __shared__ float s_w[kWarps][kStaged];
  __shared__ float s_g[kWarps][kStaged];

  if (p.ok != nullptr && *p.ok == 0) return;
  const int step = p.step->step;
  const float bc1 = p.step->bc1, bc2 = p.step->bc2;
  const int t = sparse_find_table(p.block_begin, p.n, blockIdx.x);
  const SparseUpdateTable tb = p.tables[t];
  const CowclipAdamParams& h = p.p;
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

  // trip 1: lane l reads slot l's count and uid, and stamps its row
  float c = 0.0f;
  long long row = -1;   // -1: write nothing
  if (lane < n) {
    c = tb.counts[first + lane];
    const long long r =
        static_cast<long long>(tb.uids[first + lane]) - tb.row_offset;
    if (c > 0.0f && r >= 0 && r < tb.rows) {
      row = r;
      tb.last_step[r] = step;
    }
  }
  if (!__any_sync(kFull, row >= 0)) return;   // a warp of pads

  const long long base = first * dim;
  const int n_elems = n * dim;
  if (n_elems > kWarpElems) {
    // one wide row (n == 1): its norms over chunks, then Adam over chunks
    const long long r0 = __shfl_sync(kFull, row, 0);
    float scale = 1.0f;
    if (tb.do_clip) {
      float gsq = 0.0f, wsq = 0.0f;
      for (int e = lane; e < dim; e += 32) {
        const float g = tb.g_rows[base + e], w = tb.w_rows[base + e];
        gsq += g * g;
        wsq += w * w;
      }
      for (int off = 16; off > 0; off >>= 1) {
        gsq += __shfl_xor_sync(kFull, gsq, off);
        wsq += __shfl_xor_sync(kFull, wsq, off);
      }
      scale = clip_scale(__shfl_sync(kFull, c, 0), gsq, wsq, h);
    }
    for (int e = lane; e < dim; e += 32) {
      adam_element(tb, h, bc1, bc2, r0 * dim + e, tb.w_rows[base + e],
                   tb.g_rows[base + e], scale, tb.m_rows[base + e],
                   tb.v_rows[base + e]);
    }
    return;
  }

  // trip 2: the four slot rows of the warp's real slots, coalesced, every
  // load before its first use
  const int slot_step = 32 / dim;
  const int j_step = 32 - slot_step * dim;
  const int slot0 = lane / dim;
  const int j0 = lane - slot0 * dim;
  const int pitch = dim | 1;
  float wv[kPerLane], gv[kPerLane], mv[kPerLane], vv[kPerLane];
  int slot = slot0, j = j0;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int e = lane + 32 * i;
    const long long r = __shfl_sync(kFull, row, min(slot, 31));
    wv[i] = gv[i] = mv[i] = vv[i] = 0.0f;
    if (e < n_elems && r >= 0) {
      wv[i] = tb.w_rows[base + e];
      gv[i] = tb.g_rows[base + e];
      mv[i] = tb.m_rows[base + e];
      vv[i] = tb.v_rows[base + e];
    }
    sparse_next_element(slot, j, slot_step, j_step, dim);
  }

  // the CowClip scale: w and g staged, lane l sums slot l's row in order
  float scale = 1.0f;
  if (tb.do_clip) {
    slot = slot0;
    j = j0;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      if (lane + 32 * i < n_elems) {
        s_w[warp][slot * pitch + j] = wv[i];
        s_g[warp][slot * pitch + j] = gv[i];
      }
      sparse_next_element(slot, j, slot_step, j_step, dim);
    }
    __syncwarp();
    if (row >= 0) {
      float gsq = 0.0f, wsq = 0.0f;
      const float* wr = s_w[warp] + lane * pitch;
      const float* gr = s_g[warp] + lane * pitch;
      for (int q = 0; q < dim; ++q) {
        gsq += gr[q] * gr[q];
        wsq += wr[q] * wr[q];
      }
      scale = clip_scale(c, gsq, wsq, h);
    }
  }

  // coupled L2 + Adam per element, written at the slot's table row
  slot = slot0;
  j = j0;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int e = lane + 32 * i;
    const int src = min(slot, 31);
    const long long r = __shfl_sync(kFull, row, src);
    const float sc = __shfl_sync(kFull, scale, src);
    if (e < n_elems && r >= 0) {
      adam_element(tb, h, bc1, bc2, r * dim + j, wv[i], gv[i], sc, mv[i],
                   vv[i]);
    }
    sparse_next_element(slot, j, slot_step, j_step, dim);
  }
}

}  // namespace

void sparse_update_launch(const SparseUpdateTable* tables, int n,
                          CowclipAdamParams p, const CowclipStep* step,
                          const int* ok, cudaStream_t stream) {
  UpdateParams up;
  for (int t = 0; t < n; ++t) up.tables[t] = tables[t];
  const int blocks =
      sparse_block_prefix(tables, n, kWarps, kWarpElems, up.block_begin);
  up.n = n;
  up.p = p;
  up.step = step;
  up.ok = ok;
  if (blocks == 0) return;
  sparse_update_kernel<<<blocks, kThreads, 0, stream>>>(up);
}
