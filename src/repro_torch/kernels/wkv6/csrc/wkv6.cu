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
// and the byte bound is the larger (0.40 ms at [256, 4096, 64], 0.80 ms at
// [64, 32768, 64]).
//
// Why this design: with a block per (bh, tile of value columns), every
// tile recomputes a chunk's exponentials and A; with both operands of
// every FMA in shared memory, the products are load-bound; and at batch 1
// (64 heads) a block per bh walks 2048 chunks in series, so the chain's
// latency, not the bytes, sets the time.
//
// Design:
// - One block of 256 threads per (bh, segment) holds all N value columns,
//   so the logf, the four expf an element, A and the bonus are computed
//   once per (bh, chunk). A chunk's state-independent terms (log w, the
//   cumsum as a 16-lane shuffle scan, r_hat, k_hat, r_dec, k_tail, the
//   decay, the bonus partials) run on all threads, one (step, 4 channels)
//   each; A on two warps.
// - Products on tensor cores in 3xTF32 (hi + lo splits, f32 accuracy; a
//   single TF32 or bf16 pass would not hold the f32 bars): y's 16 x 8
//   columns a warp (A v and r_dec S, m16n8k8 mma.sync) and the state step
//   S <- diag(decay) S + k_tail^T v with S in the warps' accumulator
//   registers (a 16 x 32 tile a warp), copied to shared memory once a
//   chunk as the next chunk's B operand. r_dec is split once by the
//   thread that computes it, not by every warp that reads it.
// - Pipelined: chunk c's products and chunk c+1's terms run between the
//   same two barriers (double-buffered tiles), and chunk c+2's r, k, v, w
//   are copied with cp.async into a shared-memory stage meanwhile, so the
//   DRAM latency of a chunk's 16-byte loads hides behind a chunk of work.
// - Sequence parallelism for small BH (wkv6.py chooses the segment): a
//   bh's chunks are cut into segments of whole chunks. Pass 1 (a block per
//   (bh, segment) but the last, pipelined the same way, one barrier a
//   chunk) runs the carry from a zero state: the segment's own state S_loc
//   and its decay P, the product of its chunks' exp(cum[L-1]). A carry
//   kernel walks the segments in order: S_in[0] = 0, S_in[s] = P[s-1]
//   S_in[s-1] + S_loc[s-1]. Pass 2 runs every segment from S_in[s], and
//   the last writes the final state. The clip stays inside each chunk, so
//   the function is unchanged; only the rounding order is (ref.py:
//   segmented_wkv6_reference is the same split).
//   Cost in bytes, with G segments a bh: pass 1 re-reads k, v, w of all
//   but the last segment, 3/5 (G-1)/G of the base bytes, and the carry
//   moves 4 * BH * (G-1) * N*N floats. At [64, 32768, 64] on 132 SMs
//   (G = 33) that is +1.56 GB (+0.47 ms at 3.35 TB/s) and +134 MB (+0.04
//   ms) against the 2.69 GB / 0.80 ms bound; at [256, 4096, 64] BH gives
//   every SM a block, G = 1, and nothing is added.
// What bounds it now (PERF.md): the instructions of a chunk's serial
// chain (the accurate logf/expf, the fragment loads and splits) against
// two blocks of 8 warps an SM (pass 2's shared memory), not the bytes.
#include "wkv6.h"

namespace {

constexpr int kThreads = 256;
constexpr int kN = kWkv6MaxN;
constexpr int kL = kWkv6MaxChunk;
constexpr int kPadA = kN + 4;  // stride of tiles read as rows (r_hat, k_hat,
                               // r_dec): float4 rows, no bank conflict
constexpr int kPadB = kN + 8;  // stride of tiles read down columns by the
                               // mma fragments (k_tail, v, S): no conflict
constexpr int kPadL = kL + 4;  // stride of A
constexpr float kClamp = 25.0f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kThreads == 16 * (kN / 4), "a (step, 4 channels) per thread");
static_assert(kL == 16, "the cumsum is a 16-lane shuffle scan; y is m16");
static_assert(kThreads / 32 == kN / 8, "a warp per 8 columns of y");

__device__ __forceinline__ float clip(float x) {
  return fminf(fmaxf(x, -kClamp), kClamp);
}

__device__ __forceinline__ float get(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

__device__ __forceinline__ void set(float4& a, int i, float x) {
  if (i == 0) a.x = x; else if (i == 1) a.y = x; else if (i == 2) a.z = x;
  else a.w = x;
}

// 3xTF32: x = hi + lo exactly, hi = x rounded to TF32's 10 mantissa bits
// by an integer add and an AND (cvt.rna.tf32 takes five instructions on
// sm_90; x is finite here); a product of two such numbers is taken as
// hi*hi + hi*lo + lo*hi in f32 accumulation, about f32 accuracy (lo*lo,
// and the low bits of lo the tensor core ignores, are ~2^-22 of the
// product).
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d + small [16 x 8] += a[16 x 8] b[8 x 8] in f32 accuracy, the hi*hi
// product into d and the two cross terms into small (two chains of
// dependent mma instead of one; the caller adds them). Fragments of
// m16n8k8 (g = lane / 4, c = lane % 4): a = {a[g][c], a[g+8][c],
// a[g][c+4], a[g+8][c+4]}, b = {b[c][g], b[c+4][g]}; d = {d[g][2c],
// d[g][2c+1], d[g+8][2c], d[g+8][2c+1]}.
__device__ __forceinline__ void mma3(float (&d)[4], float (&small)[4],
                                     const float (&a)[4],
                                     const float (&b)[2]) {
  unsigned ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], ah[i], al[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) split(b[i], bh[i], bl[i]);
  mma_tf32(small, al, bh);  // the small terms in their own accumulator
  mma_tf32(small, ah, bl);
  mma_tf32(d, ah, bh);
}

// mma3 with A already split (hi, lo), as r_dec is: the front splits
// each element once instead of every warp splitting its fragments.
__device__ __forceinline__ void mma3_split_a(float (&d)[4], float (&small)[4],
                                             const unsigned (&ah)[4],
                                             const unsigned (&al)[4],
                                             const float (&b)[2]) {
  unsigned bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) split(b[i], bh[i], bl[i]);
  mma_tf32(small, al, bh);
  mma_tf32(small, ah, bl);
  mma_tf32(d, ah, bh);
}

// The 4 channels j0 .. j0+3 of one step at p + off, loaded one by one
// (u, and the inputs where n % 4 != 0 or a row is not 16-byte aligned):
// zeros past n or for an invalid step.
__device__ __forceinline__ float4 load4(const float* __restrict__ p,
                                        long long off, int j0, int n,
                                        bool valid) {
  float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (!valid) return x;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (j0 + i < n) set(x, i, p[off + j0 + i]);
  return x;
}

// Asynchronous 16-byte copies into shared memory (cp.async): a chunk's
// inputs are copied two chunks ahead, so their DRAM latency hides behind
// a whole chunk of work and holds no registers. `valid` false fills 16
// zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most the newest group of copies is in flight.
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// A thread's slice of a chunk's T input tensors, staged in shared memory
// [2 stages][T][kL][kPadA] (kVec), or loaded when fetched (scalar path).
template <bool kVec, int T>
struct Staging {
  const float* src[T];
  float* stage;
  long long base;
  int n, chunk, c0, lt, j0;

  __device__ __forceinline__ float* slot(int c, int t) const {
    return stage + (((c - c0) & 1) * T + t) * kL * kPadA + lt * kPadA + j0;
  }
  // chunk c's copies (none past c1), committed as one group either way
  __device__ __forceinline__ void prefetch(int c, int c1) const {
    if (!kVec) return;
    if (c < c1) {
      const bool valid = lt < chunk && j0 < n;
      const long long off =
          base + static_cast<long long>(c * chunk + lt) * n + j0;
#pragma unroll
      for (int t = 0; t < T; ++t)
        cp_async16(slot(c, t), valid ? src[t] + off : src[t], valid);
    }
    cp_async_commit();
  }
  // chunk c's values; with kVec, its copies must have landed
  __device__ __forceinline__ float4 fetch(int c, int t) const {
    if (kVec) return *reinterpret_cast<const float4*>(slot(c, t));
    return load4(src[t], base + static_cast<long long>(c * chunk + lt) * n,
                 j0, n, lt < chunk);
  }
};

// Per-thread log decays of its (step, 4 channels) and their cumsums along
// the chunk: a shuffle scan over the 16 lanes that hold the chunk's steps
// of the same channels. lw = 0 past the chunk and past n, so the padding
// adds nothing and decays nothing.
struct Decays {
  float lw[4], cum[4], last[4];
};

// x[i] for a runtime i in [0, 4), without an indexed (local) array
__device__ __forceinline__ float pick(const float (&x)[4], int i) {
  return i == 0 ? x[0] : i == 1 ? x[1] : i == 2 ? x[2] : x[3];
}

__device__ __forceinline__ Decays decays(const float4& w, int lt, int j0,
                                         int n, int chunk) {
  Decays d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool on = lt < chunk && j0 + i < n;
    d.lw[i] = on ? logf(fmaxf(get(w, i), 1e-38f)) : 0.0f;
    float x = d.lw[i];
#pragma unroll
    for (int off = 1; off < kL; off <<= 1) {
      const float y = __shfl_up_sync(kFull, x, off, kL);
      if (lt >= off) x += y;
    }
    d.cum[i] = x;
    d.last[i] = __shfl_sync(kFull, x, chunk - 1, kL);
  }
  return d;
}

// The state's tiles a warp owns: rows 16 qb .. 16 qb + 15 (qb = warp % 4),
// columns 32 (warp / 4) .. + 31, as 4 m16n8 accumulator fragments.
struct StateTile {
  float c[4][4];
};

// S <- diag(dec) S + k_tail^T v for the warp's tile (k_tail^T is the mma's
// A: A[q][j] = k_tail[j][q]; v its B).
__device__ __forceinline__ void state_step(StateTile& st,
                                           const float (*ktail)[kPadB],
                                           const float (*vv)[kPadB],
                                           const float* dec, int warp,
                                           int lane) {
  const int g = lane / 4, c = lane % 4;
  const int q0 = 16 * (warp % 4), m0 = 32 * (warp / 4);
  const float d0 = dec[q0 + g], d1 = dec[q0 + g + 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st.c[i][0] *= d0; st.c[i][1] *= d0;
    st.c[i][2] *= d1; st.c[i][3] *= d1;
  }
  float small[4][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < kL; k0 += 8) {
    const float a[4] = {ktail[k0 + c][q0 + g], ktail[k0 + c][q0 + g + 8],
                        ktail[k0 + c + 4][q0 + g],
                        ktail[k0 + c + 4][q0 + g + 8]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float b[2] = {vv[k0 + c][m0 + 8 * i + g],
                          vv[k0 + c + 4][m0 + 8 * i + g]};
      mma3(st.c[i], small[i], a, b);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) st.c[i][j] += small[i][j];
}

// S[q][m] of the warp's tile at element i, j of fragment t.
__device__ __forceinline__ int tile_row(int warp, int lane, int j) {
  return 16 * (warp % 4) + lane / 4 + (j >= 2 ? 8 : 0);
}
__device__ __forceinline__ int tile_col(int warp, int lane, int t, int j) {
  return 32 * (warp / 4) + 8 * t + 2 * (lane % 4) + (j & 1);
}

// Pass 1: block (bh, seg) for seg < segs - 1 runs its segment's chunks from
// a zero state; writes S_loc [bh, seg] and P [bh, seg]. Pipelined: the
// state step of chunk c and the terms of chunk c+1 (the other buffer) run
// between two consecutive barriers, so one barrier a chunk.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
wkv6_segment_state_kernel(const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ w,
                          float* __restrict__ s_loc, float* __restrict__ p_seg,
                          int seq, int n, int chunk, int segment, int segs) {
  __shared__ __align__(16) float ktail[2][kL][kPadB];
  __shared__ __align__(16) float vv[2][kL][kPadB];
  __shared__ __align__(16) float dec[2][kN];
  __shared__ __align__(16) float stage[2 * 3 * kL * kPadA];  // k, v, w

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int inner = segs - 1;
  const int bh = blockIdx.x / inner, seg = blockIdx.x % inner;
  const int lt = tid % kL, j0 = 4 * (tid / kL);     // load role
  const int c0 = seg * segment, c1 = c0 + segment;  // never the last segment
  const long long base = static_cast<long long>(bh) * seq * n;

  StateTile st;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) st.c[t][j] = 0.0f;
  float p = 1.0f;

  const Staging<kVec, 3> in{{k, v, w}, stage, base, n, chunk, c0, lt, j0};
  // k_tail, v and the decay of chunk c, into buffer b
  auto terms = [&](int c, int b) {
    const float4 kc = in.fetch(c, 0), vc = in.fetch(c, 1);
    const Decays d = decays(in.fetch(c, 2), lt, j0, n, chunk);
    float4 kt;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      set(kt, i, get(kc, i) * expf(d.last[i] - d.cum[i]));
    *reinterpret_cast<float4*>(&ktail[b][lt][j0]) = kt;
    *reinterpret_cast<float4*>(&vv[b][lt][j0]) = vc;
    if (lt < 4) dec[b][j0 + lt] = expf(pick(d.last, lt));
  };
  in.prefetch(c0, c1);
  in.prefetch(c0 + 1, c1);
  if (kVec) cp_async_wait_all_but_one();
  terms(c0, 0);
  __syncthreads();

  for (int c = c0; c < c1; ++c) {
    const int b = (c - c0) & 1;
    const bool next = c + 1 < c1;
    in.prefetch(c + 2, c1);  // into the stage chunk c's inputs left
    if (tid < kN) p *= dec[b][tid];
    state_step(st, ktail[b], vv[b], dec[b], warp, lane);
    if (next) {
      if (kVec) cp_async_wait_all_but_one();
      terms(c + 1, b ^ 1);
    }
    __syncthreads();
  }

  const long long slot = static_cast<long long>(bh) * inner + seg;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = tile_row(warp, lane, j), m = tile_col(warp, lane, t, j);
      if (q < n && m < n) s_loc[(slot * n + q) * n + m] = st.c[t][j];
    }
  if (tid < n) p_seg[slot * n + tid] = p;
}

// The carry over segments: S_in[s] = P[s-1] S_in[s-1] + S_loc[s-1] for
// s = 1 .. segs-1, stored at slot s-1. One thread per state element:
// blocks (bh, element tile).
__global__ void __launch_bounds__(kThreads)
wkv6_segment_carry_kernel(const float* __restrict__ s_loc,
                          const float* __restrict__ p_seg,
                          float* __restrict__ s_in, int n, int segs) {
  const int e = blockIdx.y * kThreads + threadIdx.x;
  if (e >= n * n) return;
  const int q = e / n;
  const long long first = static_cast<long long>(blockIdx.x) * (segs - 1);
  float cur = 0.0f;
#pragma unroll 4
  for (int s = 0; s + 1 < segs; ++s) {
    const long long slot = first + s;
    cur = p_seg[slot * n + q] * cur + s_loc[slot * n * n + e];
    s_in[slot * n * n + e] = cur;
  }
}

// Pass 2's shared memory: the tiles a chunk's terms fill are double
// buffered (chunk c's products read one while chunk c+1's terms fill the
// other), so the loop needs two barriers a chunk.
struct Pass2Smem {
  float rhat[kL][kPadA];
  float khat[kL][kPadA];
  float bon[kN / 4][kL];           // bonus partials
  unsigned rdec_hi[2][kL][kPadA];  // r * exp(cum_prev), split for 3xTF32
  unsigned rdec_lo[2][kL][kPadA];
  float ktail[2][kL][kPadB];       // k * exp(cum[L-1] - cum)
  float vv[2][kL][kPadB];
  float amat[2][kL][kPadL];        // A, strictly causal
  float bonus[2][kL];              // (r . u . k)[t]
  float dec[2][kN];                // exp(cum[L-1])
  float ss[kN][kPadB];             // S at the chunk's start
  float stage[2 * 4 * kL * kPadA];  // r, k, v, w of the next two chunks
};

// Pass 2: block (bh, seg) runs its segment's chunks from S_in[seg] (zero
// for the first): y, and the final state from the last segment.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_chunked_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u,
                    const float* __restrict__ s_in, float* __restrict__ y,
                    float* __restrict__ s_out, int seq, int n, int chunk,
                    int segment, int segs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Pass2Smem& sm = *reinterpret_cast<Pass2Smem*>(smem_raw);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, cq = lane % 4;                // mma fragment role
  const int bh = blockIdx.x / segs, seg = blockIdx.x % segs;
  const int lt = tid % kL, j0 = 4 * (tid / kL);         // load role
  const int n_chunks = seq / chunk;
  const int c0 = seg * segment, c1 = min(c0 + segment, n_chunks);
  const long long base = static_cast<long long>(bh) * seq * n;

  const float4 uu = load4(u, static_cast<long long>(bh) * n, j0, n,
                                 true);
  StateTile st;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = tile_row(warp, lane, j), m = tile_col(warp, lane, t, j);
      st.c[t][j] = (seg > 0 && q < n && m < n)
          ? s_in[((static_cast<long long>(bh) * (segs - 1) + seg - 1) * n +
                  q) * n + m]
          : 0.0f;
      sm.ss[q][m] = st.c[t][j];
    }

  const Staging<kVec, 4> in{{r, k, v, w}, sm.stage, base, n, chunk, c0,
                            lt, j0};

  // the state-independent terms of chunk c, one (step, 4 channels) a
  // thread, into buffer b
  auto terms = [&](int c, int b) {
    const float4 rc = in.fetch(c, 0), kc = in.fetch(c, 1),
                 vc = in.fetch(c, 2);
    const Decays d = decays(in.fetch(c, 3), lt, j0, n, chunk);
    float4 rh, kh, rd, kt;
    float bsum = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float cu = d.cum[i], cp = cu - d.lw[i], last = d.last[i];
      const float cref = 0.5f * last;
      const float ri = get(rc, i), ki = get(kc, i);
      set(rh, i, ri * expf(clip(cp - cref)));
      set(kh, i, ki * expf(clip(cref - cu)));
      set(rd, i, ri * expf(cp));
      set(kt, i, ki * expf(last - cu));
      bsum += ri * get(uu, i) * ki;
    }
    *reinterpret_cast<float4*>(&sm.rhat[lt][j0]) = rh;
    *reinterpret_cast<float4*>(&sm.khat[lt][j0]) = kh;
    uint4 rh4, rl4;
    split(rd.x, rh4.x, rl4.x);
    split(rd.y, rh4.y, rl4.y);
    split(rd.z, rh4.z, rl4.z);
    split(rd.w, rh4.w, rl4.w);
    *reinterpret_cast<uint4*>(&sm.rdec_hi[b][lt][j0]) = rh4;
    *reinterpret_cast<uint4*>(&sm.rdec_lo[b][lt][j0]) = rl4;
    *reinterpret_cast<float4*>(&sm.ktail[b][lt][j0]) = kt;
    *reinterpret_cast<float4*>(&sm.vv[b][lt][j0]) = vc;
    sm.bon[j0 / 4][lt] = bsum;
    if (lt < 4) sm.dec[b][j0 + lt] = expf(pick(d.last, lt));
  };

  // A = r_hat k_hat^T [16 x 16], strictly causal: two warps on tensor
  // cores, one 8-column half each; a third sums the bonus partials (the
  // others go on to the state's copy)
  auto causal = [&](int b) {
    if (warp == kL / 8 && lane < kL) {
      float acc = 0.0f;
#pragma unroll
      for (int gi = 0; gi < kN / 4; ++gi) acc += sm.bon[gi][lane];
      sm.bonus[b][lane] = acc;
    }
    if (warp >= kL / 8) return;
    const int jc = 8 * warp;
    float acc[2][4] = {}, small[2][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < kN; k0 += 8) {
      const float a[4] = {sm.rhat[g][k0 + cq], sm.rhat[g + 8][k0 + cq],
                          sm.rhat[g][k0 + cq + 4],
                          sm.rhat[g + 8][k0 + cq + 4]};
      const float bb[2] = {sm.khat[jc + g][k0 + cq],
                           sm.khat[jc + g][k0 + cq + 4]};
      mma3(acc[k0 / 8 % 2], small[k0 / 8 % 2], a, bb);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = g + (i >= 2 ? 8 : 0), j = jc + 2 * cq + (i & 1);
      sm.amat[b][t][j] =
          j < t ? (acc[0][i] + acc[1][i]) + (small[0][i] + small[1][i])
                : 0.0f;
    }
  };

  // y[16 x 8 columns of this warp] = A v + r_dec S on tensor cores, with
  // four independent accumulators (two k-step parities, each with its
  // cross terms apart) so the mma chains are short; then + bonus v
  auto output = [&](int c, int b) {
    const int m0 = 8 * warp;
    float acc[2][4] = {}, small[2][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < kL; k0 += 8) {
      const float a[4] = {sm.amat[b][g][k0 + cq], sm.amat[b][g + 8][k0 + cq],
                          sm.amat[b][g][k0 + cq + 4],
                          sm.amat[b][g + 8][k0 + cq + 4]};
      const float bb[2] = {sm.vv[b][k0 + cq][m0 + g],
                           sm.vv[b][k0 + cq + 4][m0 + g]};
      mma3(acc[k0 / 8 % 2], small[k0 / 8 % 2], a, bb);
    }
#pragma unroll
    for (int k0 = 0; k0 < kN; k0 += 8) {
      const unsigned ah[4] = {
          sm.rdec_hi[b][g][k0 + cq], sm.rdec_hi[b][g + 8][k0 + cq],
          sm.rdec_hi[b][g][k0 + cq + 4], sm.rdec_hi[b][g + 8][k0 + cq + 4]};
      const unsigned al[4] = {
          sm.rdec_lo[b][g][k0 + cq], sm.rdec_lo[b][g + 8][k0 + cq],
          sm.rdec_lo[b][g][k0 + cq + 4], sm.rdec_lo[b][g + 8][k0 + cq + 4]};
      const float bb[2] = {sm.ss[k0 + cq][m0 + g], sm.ss[k0 + cq + 4][m0 + g]};
      mma3_split_a(acc[k0 / 8 % 2], small[k0 / 8 % 2], ah, al, bb);
    }
    const int col = m0 + 2 * cq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = g + 8 * h;
      const float bt = sm.bonus[b][t];
      const float y0 = (acc[0][2 * h] + acc[1][2 * h]) +
                       (small[0][2 * h] + small[1][2 * h]) +
                       bt * sm.vv[b][t][col];
      const float y1 = (acc[0][2 * h + 1] + acc[1][2 * h + 1]) +
                       (small[0][2 * h + 1] + small[1][2 * h + 1]) +
                       bt * sm.vv[b][t][col + 1];
      if (t < chunk && col < n) {
        float* yp = y + base + static_cast<long long>(c * chunk + t) * n + col;
        if (kVec) {
          *reinterpret_cast<float2*>(yp) = make_float2(y0, y1);
        } else {
          yp[0] = y0;
          if (col + 1 < n) yp[1] = y1;
        }
      }
    }
  };

  in.prefetch(c0, c1);
  in.prefetch(c0 + 1, c1);
  if (c0 < c1) {
    if (kVec) cp_async_wait_all_but_one();
    terms(c0, 0);
    __syncthreads();
    causal(0);
    __syncthreads();
  }
  for (int c = c0; c < c1; ++c) {
    const int b = (c - c0) & 1;
    const bool next = c + 1 < c1;
    // chunk c's products (buffer b) and chunk c+1's terms (buffer b ^ 1),
    // while chunk c+2's inputs are copied into the stage chunk c's left
    in.prefetch(c + 2, c1);
    output(c, b);
    state_step(st, sm.ktail[b], sm.vv[b], sm.dec[b], warp, lane);
    if (next) {
      if (kVec) cp_async_wait_all_but_one();
      terms(c + 1, b ^ 1);
    }
    __syncthreads();  // every warp has read ss, and the terms are in
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sm.ss[tile_row(warp, lane, j)][tile_col(warp, lane, t, j)] =
            st.c[t][j];
    if (next) causal(b ^ 1);
    __syncthreads();
  }

  if (seg == segs - 1) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = tile_row(warp, lane, j), m = tile_col(warp, lane, t, j);
        if (q < n && m < n)
          s_out[(static_cast<long long>(bh) * n + q) * n + m] = st.c[t][j];
      }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <bool kVec>
void launch(const float* r, const float* k, const float* v, const float* w,
            const float* u, float* y, float* s_out, float* s_loc,
            float* p_seg, float* s_in, int bh, int seq, int n, int chunk,
            int segment, int segs, cudaStream_t stream) {
  if (segs > 1) {
    wkv6_segment_state_kernel<kVec><<<bh * (segs - 1), kThreads, 0, stream>>>(
        k, v, w, s_loc, p_seg, seq, n, chunk, segment, segs);
    const dim3 grid(bh, (n * n + kThreads - 1) / kThreads);
    wkv6_segment_carry_kernel<<<grid, kThreads, 0, stream>>>(s_loc, p_seg,
                                                             s_in, n, segs);
  }
  // more than the 48 KB of static shared memory, on the current device
  // (a failure shows in the launch's error)
  cudaFuncSetAttribute(wkv6_chunked_kernel<kVec>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(sizeof(Pass2Smem)));
  wkv6_chunked_kernel<kVec><<<bh * segs, kThreads, sizeof(Pass2Smem),
                              stream>>>(r, k, v, w, u, s_in, y, s_out, seq,
                                        n, chunk, segment, segs);
}

}  // namespace

void wkv6_chunked_launch(const float* r, const float* k, const float* v,
                         const float* w, const float* u, float* y,
                         float* s_out, float* s_loc, float* p_seg,
                         float* s_in, int bh, int seq, int n, int chunk,
                         int segment, cudaStream_t stream) {
  if (bh == 0) return;
  const int n_chunks = seq / chunk;
  const int segs = n_chunks > 0 ? (n_chunks + segment - 1) / segment : 1;
  const bool vec = n % 4 == 0 && aligned16(r) && aligned16(k) &&
                   aligned16(v) && aligned16(w) && aligned16(y);
  if (vec)
    launch<true>(r, k, v, w, u, y, s_out, s_loc, p_seg, s_in, bh, seq, n,
                 chunk, segment, segs, stream);
  else
    launch<false>(r, k, v, w, u, y, s_out, s_loc, p_seg, s_in, bh, seq, n,
                  chunk, segment, segs, stream);
}
