// Deterministic embedding backward for Hopper (sm_90a): the gradient of a
// gather, as a sorted segmented sum with a fixed order of additions.
//
// No TPU kernel of the reference: the JAX package leaves the transpose of
// its gathers (`jnp.take`, `rows[inv]`) to XLA, whose scatter-add is
// deterministic on the CPU. PyTorch's CUDA `embedding_dense_backward` is
// not: its segment sums land in an order that changes from run to run
// where an id repeats thousands of times in a batch (the few-id fields of
// deepfm-criteo at batch 131072), so a train step on the card did not
// repeat itself bit for bit. This kernel does.
//
// Input: the gather's row of each output row, sorted by a stable sort
// (`sorted_keys`, with `perm` the output row of each sorted position), and
// the cotangent rows. Output: grad[key] = the sum of the cotangent rows
// whose key it is; keys >= rows (an id past its table, or a slot past the
// capacity) pass nothing.
//
// Order of the sums, the same on every run and for every launch geometry:
// - Level 0: the sorted positions in chunks of kEmbedBwdChunk (32), one
//   warp a chunk, lanes across the row's columns. The warp walks its
//   chunk in ascending position and sums each run of equal keys from its
//   first element. A run that neither begins nor ends the chunk holds
//   its key's whole segment: it is written to grad. The chunk's first and
//   last runs may continue in the neighbouring chunks: they go, keyed, to
//   the next level as the chunk's two entries (a chunk of one run gives
//   it as its first entry and an empty entry with its key as the second).
// - Level L + 1 does the same over level L's entries (2 a chunk, still
//   in key order), adding an empty entry as nothing; the last level (one
//   chunk) writes every run.
// So every key is written once, by one warp, with no atomics, and a
// segment of 131,072 rows (a field of one id) is summed by 4,096 warps,
// then 256, 16 and 1: no warp adds more than 32 values in a row.
//
// Bound: bytes. The cotangent's rows are read once (n * dim * 4 bytes,
// through perm: n * 8 more), the keys once, and grad is written once, all
// of it (rows * dim * 4 bytes, the zero fill included: the caller's
// memset). At deepfm-criteo width and batch 131072 one lookup of the 26
// fm tables reads 136 MB of cotangent and 13.6 MB of keys and writes
// 1.35 GB of gradient: 0.45 ms at 3.35 TB/s; the levels after the first
// move ~1/16 of the first's bytes each. The sort (torch.sort, stable) is
// the caller's.
//
// Lanes across columns leave lanes idle at dim 10 and 1 (the LR tables):
// a simple first design, each lane holding its column of the chunk's 32
// rows in registers, every load issued before the first add.
#include "embedding_backward.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kEmbedBwdChunk;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kKeyMask = 0x7fffffff;   // bit 31 marks an empty entry

static_assert(kChunk == 32, "a chunk is one warp's lanes");

// One level: a warp per chunk of kChunk entries of `keys`, whose values
// are the rows of `vals` (at row src[p] of the cotangent at level 0, at
// row p of the previous level's entries after it, src null). The chunk's
// interior runs are written to grad; its head and tail runs go to
// next_keys / next_vals (2 entries a chunk), or, at the last level
// (next_keys null), to grad as well.
__global__ void __launch_bounds__(kThreads)
embedding_backward_level_kernel(const int* __restrict__ keys,
                                const long long* __restrict__ src,
                                const float* __restrict__ vals, long long n,
                                int dim, int rows, float* __restrict__ grad,
                                int* __restrict__ next_keys,
                                float* __restrict__ next_vals) {
  const int lane = threadIdx.x & 31;
  const long long chunk =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long p0 = chunk * kChunk;
  if (p0 >= n) return;   // the whole warp
  const int count = static_cast<int>(min(static_cast<long long>(kChunk),
                                         n - p0));
  const bool mine = lane < count;
  const int raw = mine ? keys[p0 + lane] : 0;
  const int key = raw & kKeyMask;
  const long long row =
      mine ? (src != nullptr ? src[p0 + lane] : p0 + lane) : 0;
  const int prev = __shfl_up_sync(kFull, key, 1);
  const int next = __shfl_down_sync(kFull, key, 1);
  const unsigned starts =
      __ballot_sync(kFull, mine && (lane == 0 || prev != key));
  const unsigned ends =
      __ballot_sync(kFull, mine && (lane == count - 1 || next != key));
  const unsigned empties = __ballot_sync(kFull, mine && raw < 0);
  const int runs = __popc(starts);
  const bool last_level = next_keys == nullptr;
  const int head_key = __shfl_sync(kFull, key, 0);
  const int tail_key = __shfl_sync(kFull, key, count - 1);
  if (!last_level && lane == 0) {
    next_keys[2 * chunk] = head_key;
    next_keys[2 * chunk + 1] = runs > 1 ? tail_key : (head_key | ~kKeyMask);
  }
  float* head = last_level ? nullptr : next_vals + 2 * chunk * dim;
  float* tail = last_level ? nullptr : head + dim;

  for (int d0 = 0; d0 < dim; d0 += 32) {
    const int d = d0 + lane;
    const bool col = d < dim;
    float v[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const long long r = __shfl_sync(kFull, row, j);
      v[j] = (j < count && col) ? vals[r * dim + d] : 0.0f;
    }
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < count) {   // the whole warp
        const unsigned bit = 1u << j;
        acc = (starts & bit) ? v[j] : ((empties & bit) ? acc : acc + v[j]);
        if (ends & bit) {
          const int k = __shfl_sync(kFull, key, j);
          const int run = __popc(starts & (bit | (bit - 1))) - 1;
          if (col) {
            if (!last_level && run == 0) {
              head[d] = acc;
            } else if (!last_level && run == runs - 1) {
              tail[d] = acc;
            } else if (k < rows) {
              grad[static_cast<long long>(k) * dim + d] = acc;
            }
          }
        }
      }
    }
    if (!last_level && runs == 1 && col) tail[d] = 0.0f;
  }
}

}  // namespace

cudaError_t embedding_backward_launch(const int* sorted_keys,
                                      const long long* perm,
                                      const float* grad_out, long long n,
                                      int dim, int rows, float* grad,
                                      int* scratch_keys, float* scratch_vals,
                                      cudaStream_t stream) {
  const long long cap = embedding_backward_next(n);
  const int* keys = sorted_keys;
  const long long* src = perm;
  const float* vals = grad_out;
  int half = 0;
  while (n > 0) {
    const long long chunks = (n + kChunk - 1) / kChunk;
    const bool last = chunks == 1;
    int* next_keys = last ? nullptr : scratch_keys + half * cap;
    float* next_vals = last ? nullptr : scratch_vals + half * cap * dim;
    const unsigned blocks =
        static_cast<unsigned>((chunks + kWarps - 1) / kWarps);
    embedding_backward_level_kernel<<<blocks, kThreads, 0, stream>>>(
        keys, src, vals, n, dim, rows, grad, next_keys, next_vals);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || last) return err;
    keys = next_keys;
    src = nullptr;
    vals = next_vals;
    n = 2 * chunks;
    half ^= 1;
  }
  return cudaSuccess;
}
