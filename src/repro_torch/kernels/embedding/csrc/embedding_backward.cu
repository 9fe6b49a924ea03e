// Deterministic embedding backward for Hopper (sm_90a): the gradient of a
// gather, as a sorted segmented sum with a fixed order of additions, for
// every group of tables read at the same keys in one call.
//
// No TPU kernel of the reference: the JAX package leaves the transpose of
// its gathers (`jnp.take`, `rows[inv]`) to XLA, whose scatter-add is
// deterministic on the CPU. PyTorch's CUDA `embedding_dense_backward` is
// not: its segment sums land in an order that changes from run to run
// where an id repeats thousands of times in a batch (the few-id fields of
// deepfm-criteo at batch 131072), so a train step on the card did not
// repeat itself bit for bit. This kernel does.
//
// Input: the gather's row of each output row in a sorted order (each
// key's positions contiguous: a stable sort, `sorted_keys` with `perm`
// the output row of each sorted position, or a plan the caller built
// from sorts it already made), and each group's cotangent rows. Output:
// for each group, grad[key] = the sum of the cotangent rows whose key it
// is; keys outside [0, rows) (an id past its table, a slot past the
// capacity) pass nothing. A CTR step's fm ([*, 10]) and LR ([*, 1])
// lookups read the same keys, so one call sums both: one read of the keys
// and the permutation, one set of level launches.
//
// Order of the sums, the same on every run, for every launch geometry,
// every D and every group beside it:
// - Level 0: the sorted positions in chunks of kEmbedBwdChunk (128), one
//   warp a chunk, as 4 sub-chunks of 32, lanes across positions: each
//   lane holds its position's row in each sub-chunk (16 columns at a
//   time; D is 10 or 1 on the main path). A segmented inclusive scan
//   over the 32 lanes (shuffles up by 1, 2, 4, 8, 16; a lane adds only
//   from its own run) sums each run inside the sub-chunk; the
//   sub-chunk's first run then adds the sum so far of the run it goes on
//   from (the sub-chunk before's last), as carry + part. A run that
//   neither begins nor ends the chunk holds its key's whole segment: it
//   is written to grad. The chunk's first and last runs may go on in the
//   neighbouring chunks: they go, keyed, to the next level as the chunk's
//   two entries (a chunk of one run passes it as its first entry and
//   -0.0 with the same key as the second, which adds nothing).
// - Level L + 1 does the same over level L's entries (2 a chunk, still
//   with each key's entries contiguous); the last level (one chunk)
//   writes every run.
// So every key is written once, by one warp, with no atomics; at 3,407,872
// keys (one deepfm-criteo batch of 131,072 x 26 fields) the levels hold
// 3,407,872, 53,248, 832 and 14 entries: 4 launches a call.
//
// Bound: bytes. The keys and each group's cotangent are read once, and
// each group's gradient is written once, all of it (the zero fill, the
// caller's memset, included): at deepfm-criteo width one step's call
// reads 13.6 MB of keys and 136.3 + 13.6 MB of cotangent and writes 1.35
// GB + 135 MB of gradient: 0.4923 ms at 3.35 TB/s. The levels after the
// first move ~1/64 of the first's bytes each. The sort (torch.sort,
// stable) is the caller's, and the sparse step makes none: its plan comes
// from the dedup's own sorts.
//
// Lanes across positions keep every lane busy at D = 10 and D = 1 (lanes
// across columns left 22 and 31 of 32 idle). Level 0 gathers rows at
// random through `perm`, so the memory pipe's latency bounds it, not the
// adds: what counts is how many loads are in flight. So a warp copies its
// chunk's rows into shared memory with asynchronous copies (cp.async: no
// register waits on them), all 4 sub-chunks' at once, as one flat run of
// floats a sub-chunk (a copy instruction touches ~32 / D + 1 rows, not
// 32); each lane then reads its own row, scans, and the run sums go back
// out the same flat way. A wider row runs in slices of 16 columns through
// the same code, so every column of every D is summed in the one order
// above.
#include <cuda_pipeline.h>

#include "embedding_backward.h"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kEmbedBwdChunk;
constexpr int kSubs = kChunk / 32;
constexpr int kSlice = 16;   // columns a lane holds at a time
constexpr unsigned kFull = 0xffffffffu;

static_assert(kChunk % 32 == 0, "a chunk is whole sub-chunks of 32");

struct LevelGroup {
  const float* in;   // this level's values [*, dim]: row src[p], or p
  float* next;       // the next level's [2 * chunks, dim]; null at the last
  float* grad;       // [rows, dim]
  int dim;
};

struct LevelParams {
  const int* keys;        // [n]
  const long long* src;   // [n] the `in` row of each position, or null
  int* next_keys;         // [2 * chunks]; null at the last level
  long long n;
  int rows;
  int groups;
  LevelGroup group[kEmbedBwdMaxGroups];
};

// A warp's chunk, one position a lane in each sub-chunk: the key, the
// lane its run starts at in the sub-chunk, and whether the run ends at
// this lane; whether the sub-chunk holds a position (live), whether its
// first run goes on from the sub-chunk before (cont) and is the chunk's
// head run (head). Shared by every group and column.
struct Chunk {
  long long index, last;   // the chunk, its last position
  int key[kSubs], first[kSubs];
  bool ends[kSubs], live[kSubs], cont[kSubs], head[kSubs];
};

// A warp's shared memory: each sub-chunk's 32 rows of up to kMax columns
// (row stride kMax | 1: no bank conflicts when each lane reads its own
// row), the source row of each position, and where each position's run
// sum goes (null: nowhere).
template <int kMax>
struct Stage {
  static constexpr int kStride = kMax | 1;
  float vals[kSubs][32 * kStride];
  int src[kSubs][32];
  float* dst[kSubs][32];
};

// Columns [c0, c0 + d) of one group over the warp's chunk, d <= kCols <=
// kMax: the rows copied flat into shared memory (all sub-chunks' copies
// in flight together), each sub-chunk's runs summed by the scan tree and
// carried, the sums scattered flat.
template <int kCols, int kMax>
__device__ __forceinline__ void sum_slice(const LevelParams& p,
                                          const LevelGroup& grp,
                                          const Chunk& ch, Stage<kMax>& st,
                                          int lane, int c0, int d) {
  constexpr int kStride = Stage<kMax>::kStride;
  // flat element j * 32 + lane of a sub-chunk: its row (< 32) and
  // column (< 16), as row << 4 | column
  int rc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int r = (j * 32 + lane) / d;
    rc[j] = r << 4 | (j * 32 + lane - r * d);
  }
#pragma unroll
  for (int s = 0; s < kSubs; ++s) {
    const long long q0 = ch.index * kChunk + s * 32;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int r = rc[j] >> 4, c = rc[j] & 15;
      if (j < d && q0 + r <= ch.last) {
        __pipeline_memcpy_async(
            &st.vals[s][r * kStride + c],
            grp.in + static_cast<long long>(st.src[s][r]) * grp.dim + c0 + c,
            sizeof(float));
      }
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();

  const bool last_level = p.next_keys == nullptr;
  float carry[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) carry[k] = 0.0f;
#pragma unroll
  for (int s = 0; s < kSubs; ++s) {
    if (!ch.live[s]) break;   // the whole warp
    float v[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      v[k] = k < d ? st.vals[s][lane * kStride + k] : 0.0f;
    }
    // the segmented scan: the same tree for every run
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const bool add = lane - o >= ch.first[s];
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        if (k < d) {
          const float t = __shfl_up_sync(kFull, v[k], o);
          if (add) v[k] += t;
        }
      }
    }
    // the first run adds the sum so far of the run it goes on from:
    // carry + part
    if (ch.cont[s] && ch.first[s] == 0) {
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        if (k < d) v[k] = carry[k] + v[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      if (k < d) carry[k] = __shfl_sync(kFull, v[k], 31);
    }
    float* dst = nullptr;
    if (ch.ends[s]) {
      const long long q = ch.index * kChunk + s * 32 + lane;
      const bool is_head = ch.head[s] && ch.first[s] == 0;
      const bool is_tail = q == ch.last;
      const int key = ch.key[s];
      if (last_level || (!is_head && !is_tail)) {
        if (static_cast<unsigned>(key) < static_cast<unsigned>(p.rows)) {
          dst = grp.grad + static_cast<long long>(key) * grp.dim + c0;
        }
      } else {
        float* out = grp.next + 2 * ch.index * grp.dim + c0;
        dst = is_head ? out : out + grp.dim;
        if (is_head && is_tail) {
          // a chunk of one run passes an empty tail: -0.0 adds nothing
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            if (k < d) out[grp.dim + k] = -0.0f;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        if (k < d) st.vals[s][lane * kStride + k] = v[k];
      }
    }
    st.dst[s][lane] = dst;
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kSubs; ++s) {
    if (!ch.live[s]) break;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int r = rc[j] >> 4, c = rc[j] & 15;
      float* dst = j < d ? st.dst[s][r] : nullptr;
      if (dst != nullptr) dst[c] = st.vals[s][r * kStride + c];
    }
  }
  __syncwarp();   // the stage is free for the next slice
}

// The least kCols of 1, 2, 4, 8, 12, 16 that holds d columns, at most
// kMax (the kernel's widest).
template <int kMax>
__device__ __forceinline__ void sum_slice_fit(const LevelParams& p,
                                              const LevelGroup& grp,
                                              const Chunk& ch,
                                              Stage<kMax>& st, int lane,
                                              int c0, int d) {
  if (kMax == 1 || d <= 1) {
    return sum_slice<1, kMax>(p, grp, ch, st, lane, c0, d);
  }
  if constexpr (kMax >= 2) {
    if (kMax == 2 || d <= 2) {
      return sum_slice<2, kMax>(p, grp, ch, st, lane, c0, d);
    }
  }
  if constexpr (kMax >= 4) {
    if (kMax == 4 || d <= 4) {
      return sum_slice<4, kMax>(p, grp, ch, st, lane, c0, d);
    }
  }
  if constexpr (kMax >= 8) {
    if (kMax == 8 || d <= 8) {
      return sum_slice<8, kMax>(p, grp, ch, st, lane, c0, d);
    }
  }
  if constexpr (kMax >= 12) {
    if (kMax == 12 || d <= 12) {
      return sum_slice<12, kMax>(p, grp, ch, st, lane, c0, d);
    }
  }
  if constexpr (kMax >= 16) {
    return sum_slice<16, kMax>(p, grp, ch, st, lane, c0, d);
  }
}

// One level: a warp per chunk of kChunk entries of `keys`. The chunk's
// interior runs are written to each group's grad; its head and tail runs
// go to next_keys and each group's next (2 entries a chunk), or, at the
// last level, to grad as well. kMax: the columns a lane may hold, at
// least every group's dim up to kSlice.
template <int kMax>
__global__ void __launch_bounds__(kThreads)
embedding_backward_level_kernel(const __grid_constant__ LevelParams p) {
  __shared__ Stage<kMax> stages[kWarps];
  const int lane = threadIdx.x & 31;
  Stage<kMax>& st = stages[threadIdx.x >> 5];
  Chunk ch;
  ch.index = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long p0 = ch.index * kChunk;
  if (p0 >= p.n) return;   // the whole warp
  ch.last = min(p0 + kChunk, p.n) - 1;
  const bool last_level = p.next_keys == nullptr;
  const unsigned upto = kFull >> (31 - lane);   // this lane and those below
#pragma unroll
  for (int s = 0; s < kSubs; ++s) {
    const long long q = p0 + s * 32 + lane;
    const bool mine = q <= ch.last;
    ch.key[s] = mine ? p.keys[q] : 0;
    st.src[s][lane] = !mine ? 0
                      : p.src != nullptr ? static_cast<int>(p.src[q])
                                         : static_cast<int>(q);
  }
  int prev_key = 0;
  bool head_through = false;   // the head run fills the sub-chunk before
#pragma unroll
  for (int s = 0; s < kSubs; ++s) {
    const long long q = p0 + s * 32 + lane;
    const bool mine = q <= ch.last;
    const int key = ch.key[s];
    int after = __shfl_down_sync(kFull, key, 1);
    if (lane == 31 && q < ch.last) after = p.keys[q + 1];
    const int before = __shfl_up_sync(kFull, key, 1);
    const unsigned starts =
        __ballot_sync(kFull, mine && (lane == 0 || before != key));
    ch.first[s] = 31 - __clz(starts & upto);
    ch.ends[s] = mine && (q == ch.last || after != key);
    ch.live[s] = p0 + s * 32 <= ch.last;
    ch.cont[s] =
        s > 0 && ch.live[s] && __shfl_sync(kFull, key, 0) == prev_key;
    ch.head[s] = s == 0 || (head_through && ch.cont[s]);
    head_through = ch.head[s] && starts == 1u;
    prev_key = __shfl_sync(kFull, key, 31);
    if (!last_level) {
      if (s == 0 && lane == 0) p.next_keys[2 * ch.index] = key;
      if (q == ch.last) p.next_keys[2 * ch.index + 1] = key;
    }
  }
  __syncwarp();
  for (int g = 0; g < p.groups; ++g) {
    const LevelGroup& grp = p.group[g];
    for (int c0 = 0; c0 < grp.dim; c0 += kSlice) {
      sum_slice_fit<kMax>(p, grp, ch, st, lane, c0,
                          min(kSlice, grp.dim - c0));
    }
  }
}

template <int kMax>
cudaError_t launch_level(const LevelParams& p, unsigned blocks,
                         cudaStream_t stream) {
  embedding_backward_level_kernel<kMax><<<blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_level(int widest, const LevelParams& p, unsigned blocks,
                         cudaStream_t stream) {
  if (widest <= 1) return launch_level<1>(p, blocks, stream);
  if (widest <= 2) return launch_level<2>(p, blocks, stream);
  if (widest <= 4) return launch_level<4>(p, blocks, stream);
  if (widest <= 8) return launch_level<8>(p, blocks, stream);
  if (widest <= 12) return launch_level<12>(p, blocks, stream);
  return launch_level<16>(p, blocks, stream);
}

}  // namespace

cudaError_t embedding_backward_launch(const int* sorted_keys,
                                      const long long* perm, long long n,
                                      int rows, const EmbedBwdGroup* groups,
                                      int n_groups, int* scratch_keys,
                                      float* scratch_vals,
                                      cudaStream_t stream) {
  if (n_groups < 1 || n_groups > kEmbedBwdMaxGroups || n >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  const long long cap = embedding_backward_next(n);
  LevelParams p{};
  p.keys = sorted_keys;
  p.src = perm;
  p.rows = rows;
  p.groups = n_groups;
  long long width = 0;
  int widest = 1;
  for (int g = 0; g < n_groups; ++g) {
    p.group[g].in = groups[g].grad_out;
    p.group[g].grad = groups[g].grad;
    p.group[g].dim = groups[g].dim;
    width += groups[g].dim;
    widest = groups[g].dim > widest ? groups[g].dim : widest;
  }
  int half = 0;
  while (n > 0) {
    const long long chunks = (n + kChunk - 1) / kChunk;
    const bool last = chunks == 1;
    p.n = n;
    p.next_keys = last ? nullptr : scratch_keys + half * cap;
    long long offset = half * cap * width;
    for (int g = 0; g < n_groups; ++g) {
      p.group[g].next = last ? nullptr : scratch_vals + offset;
      offset += cap * p.group[g].dim;
    }
    const unsigned blocks =
        static_cast<unsigned>((chunks + kWarps - 1) / kWarps);
    const cudaError_t err = launch_level(widest, p, blocks, stream);
    if (err != cudaSuccess || last) return err;
    p.keys = p.next_keys;
    p.src = nullptr;
    for (int g = 0; g < n_groups; ++g) p.group[g].in = p.group[g].next;
    n = 2 * chunks;
    half ^= 1;
  }
  return cudaSuccess;
}
