// Chunked RWKV-6 WKV scan for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/wkv6/wkv6.py:chunked_wkv6 (Pallas
// body `_kernel`). Per batch*head `bh`, over chunks of L steps with the
// [N, N] state S carried from chunk to chunk (S = 0 before the first):
//
//   cum      = cumsum_t log(max(w, 1e-38))      cum_prev = cum - log w
//   cref     = cum[L-1] / 2                     (per channel)
//   r_hat    = r * exp(clip(cum_prev - cref, +-25))
//   k_hat    = k * exp(clip(cref - cum, +-25))
//   A[t, j]  = r_hat[t] . k_hat[j]  for j < t, else 0
//   y        = A v + (r * exp(cum_prev)) S + (r . u . k)[t] v[t]
//   S       <- exp(cum[L-1]) S + (k * exp(cum[L-1] - cum))^T v
//
// y is [BH, S, N]; the final S is [BH, N, N]. All f32.
//
// Numerics: 1e-38 is a subnormal float. This file must be compiled without
// --use_fast_math and without -ftz=true: flushed to zero, fmaxf(w, 1e-38f)
// would give 0, logf(0) = -inf, and cref would turn the chunk into NaN.
// logf and expf are the accurate versions, not __logf / __expf.
//
// Bound: per (bh, chunk) 4*L*L*N + 4*L*N*N floating-point operations
// (A, A v, r S, the state update) against 4*(5*BH*S*N + BH*N + BH*N*N)
// bytes for the whole call (r, k, v, w, y once each; u; the final state).
// At L = 16, N = 64 that is 20 FLOP per byte: under the f32 CUDA-core ridge
// of the H100 (67 TFLOP/s over 3.35 TB/s = 20), so both bounds are close
// and the byte bound is the larger.
//
// Design: the TPU grid (BH parallel, chunks sequential) with the state in
// VMEM becomes one thread block per (bh, tile of value columns) with a loop
// over chunks inside the block, so the state tile stays in shared memory
// for the whole sequence. Column m of y and of S depends only on column m
// of v (and on all of r, k, w), so the value columns split across blocks
// with no communication: tiles of 16 columns give 4 blocks per bh at
// N = 64, 256 blocks at batch 1 x 64 heads against 132 SMs. Each block
// recomputes the chunk's A (its r, k, w are re-read by every column tile;
// the tiles of one bh are neighbouring blocks, so these reads mostly hit
// L2). The next chunk's r, k, w, v are loaded into registers while the
// current one is computed. f32 on CUDA cores: wgmma, TMA and a bf16 input
// path are later work.
#include "wkv6.h"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = kWkv6MaxN;
constexpr int kMaxL = kWkv6MaxChunk;
constexpr int kCols = 16;                          // value columns a block owns
constexpr int kPad = kMaxN + 1;                    // row stride: no bank conflicts
constexpr int kLoads = kMaxL * kMaxN / kThreads;   // [L, N] elements a thread loads
constexpr int kVLoads = kMaxL * kCols / kThreads;  // [L, cols] elements
constexpr float kClamp = 25.0f;

__device__ __forceinline__ float clip(float x) {
  return fminf(fmaxf(x, -kClamp), kClamp);
}

__global__ void __launch_bounds__(kThreads)
wkv6_chunked_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u, float* __restrict__ y,
                    float* __restrict__ s_out, int seq, int n, int chunk,
                    int cols) {
  __shared__ float rr[kMaxL][kPad];
  __shared__ float kk[kMaxL][kPad];
  __shared__ float cum[kMaxL][kPad];     // log w, then its inclusive cumsum
  __shared__ float cprev[kMaxL][kPad];
  __shared__ float rhat[kMaxL][kPad];
  __shared__ float khat[kMaxL][kPad];
  __shared__ float rdec[kMaxL][kPad];    // r * exp(cum_prev)
  __shared__ float ktail[kMaxL][kPad];   // k * exp(cum[L-1] - cum)
  __shared__ float vv[kMaxL][kCols];
  __shared__ float a[kMaxL][kMaxL + 1];
  __shared__ float st[kMaxN][kCols + 1];  // the state's column tile
  __shared__ float uu[kMaxN];
  __shared__ float bonus[kMaxL];

  const int tid = threadIdx.x;
  const int tiles = (n + cols - 1) / cols;
  const int bh = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) * cols;
  const int nc = min(cols, n - c0);               // columns in this tile
  const int len = chunk * n;                      // elements of one [L, N] chunk
  const int vlen = chunk * nc;
  const int n_chunks = seq / chunk;
  const long long base = static_cast<long long>(bh) * seq * n;

  for (int i = tid; i < n; i += kThreads) uu[i] = u[static_cast<long long>(bh) * n + i];
  for (int i = tid; i < n * nc; i += kThreads) st[i / nc][i % nc] = 0.0f;

  float pr[kLoads], pk[kLoads], pw[kLoads], pv[kVLoads];
  auto load = [&](int c) {
    const long long off = base + static_cast<long long>(c) * len;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < len) {
        pr[i] = r[off + idx];
        pk[i] = k[off + idx];
        pw[i] = w[off + idx];
      }
    }
#pragma unroll
    for (int i = 0; i < kVLoads; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < vlen) pv[i] = v[off + (idx / nc) * n + c0 + idx % nc];
    }
  };
  if (n_chunks > 0) load(0);

  for (int c = 0; c < n_chunks; ++c) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < len) {
        const int t = idx / n, j = idx % n;
        rr[t][j] = pr[i];
        kk[t][j] = pk[i];
        cum[t][j] = logf(fmaxf(pw[i], 1e-38f));
      }
    }
#pragma unroll
    for (int i = 0; i < kVLoads; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < vlen) vv[idx / nc][idx % nc] = pv[i];
    }
    __syncthreads();
    if (c + 1 < n_chunks) load(c + 1);  // in flight while this chunk computes

    // per-channel cumulative sums along the chunk
    for (int j = tid; j < n; j += kThreads) {
      float acc = 0.0f;
      for (int t = 0; t < chunk; ++t) {
        const float lw = cum[t][j];
        acc += lw;
        cum[t][j] = acc;
        cprev[t][j] = acc - lw;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < len; idx += kThreads) {
      const int t = idx / n, j = idx % n;
      const float last = cum[chunk - 1][j];
      const float cref = 0.5f * last;
      const float cp = cprev[t][j], cu = cum[t][j];
      rhat[t][j] = rr[t][j] * expf(clip(cp - cref));
      khat[t][j] = kk[t][j] * expf(clip(cref - cu));
      rdec[t][j] = rr[t][j] * expf(cp);
      ktail[t][j] = kk[t][j] * expf(last - cu);
    }
    for (int t = tid; t < chunk; t += kThreads) {
      float acc = 0.0f;
      for (int j = 0; j < n; ++j) acc += rr[t][j] * uu[j] * kk[t][j];
      bonus[t] = acc;
    }
    __syncthreads();

    // intra-chunk, strictly causal (j < t)
    for (int idx = tid; idx < chunk * chunk; idx += kThreads) {
      const int t = idx / chunk, j = idx % chunk;
      float acc = 0.0f;
      if (t > j) {
        for (int q = 0; q < n; ++q) acc += rhat[t][q] * khat[j][q];
      }
      a[t][j] = acc;
    }
    __syncthreads();

    for (int idx = tid; idx < vlen; idx += kThreads) {
      const int t = idx / nc, m = idx % nc;
      float intra = 0.0f;
      for (int j = 0; j < t; ++j) intra += a[t][j] * vv[j][m];
      float inter = 0.0f;
      for (int q = 0; q < n; ++q) inter += rdec[t][q] * st[q][m];
      y[base + static_cast<long long>(c * chunk + t) * n + c0 + m] =
          intra + inter + bonus[t] * vv[t][m];
    }
    __syncthreads();  // every y has read the state before it moves on

    // inter-chunk carry: exponents <= 0, no clip needed
    for (int idx = tid; idx < n * nc; idx += kThreads) {
      const int q = idx / nc, m = idx % nc;
      float acc = 0.0f;
      for (int j = 0; j < chunk; ++j) acc += ktail[j][q] * vv[j][m];
      st[q][m] = expf(cum[chunk - 1][q]) * st[q][m] + acc;
    }
    __syncthreads();  // before the next chunk overwrites the shared tiles
  }

  for (int idx = tid; idx < n * nc; idx += kThreads) {
    const int q = idx / nc, m = idx % nc;
    s_out[static_cast<long long>(bh) * n * n + static_cast<long long>(q) * n + c0 + m] =
        st[q][m];
  }
}

}  // namespace

void wkv6_chunked_launch(const float* r, const float* k, const float* v,
                         const float* w, const float* u, float* y,
                         float* s_out, int bh, int seq, int n, int chunk,
                         cudaStream_t stream) {
  if (bh == 0) return;
  const int cols = n < kCols ? n : kCols;
  const int tiles = (n + cols - 1) / cols;
  wkv6_chunked_kernel<<<bh * tiles, kThreads, 0, stream>>>(
      r, k, v, w, u, y, s_out, seq, n, chunk, cols);
}
