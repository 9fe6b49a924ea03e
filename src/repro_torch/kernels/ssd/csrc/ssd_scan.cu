// The Mamba-2 (SSD) selective scan for Hopper (sm_90a): forward and
// backward.
//
// Replaces no TPU kernel: the reference runs the scan as a jax.lax.scan
// over repro/models/mamba.py:_ssm_step, which XLA compiles and
// differentiates. Per batch row b and head h, with A = exp(A_log[h]) and
// the [P, N] state s starting at zero:
//
//   a_t = exp(-dt_t A)
//   s_t = a_t s_{t-1} + dt_t (x_t ⊗ b_t)
//   y_t = s_t c_t + D[h] x_t
//
// Forward: the chunk form of the same recurrence (kernels/ssd/ref.py:
// ssd_scan_chunked_reference is the same decomposition in plain
// PyTorch). Over chunks of Q = kSsdChunk tokens, with s_in the state
// entering the chunk, l_t = -dt_t A and cs_t the in-chunk inclusive
// cumsum of l (every exponent below is <= 0: dt >= 0, A > 0):
//
//   y_t   = sum_{j<=t} (c_t . b_j) exp(cs_t - cs_j) dt_j x_j
//           + exp(cs_t) (s_in c_t) + D x_t
//   s_out = exp(cs_{Q-1}) s_in + sum_j exp(cs_{Q-1} - cs_j) dt_j x_j ⊗ b_j
//
// so the state entering each chunk is the one the backward reads from
// s_chunks. No factor is rebuilt by a division (a_t underflows to 0 for
// large dt A).
//
// Backward: the reverse of the same chunk form (kernels/ssd/ref.py:
// ssd_scan_backward_chunked_reference is the same decomposition in plain
// PyTorch, ssd_scan_backward_reference the token recurrence it replaced).
// Over the chunks in reverse, with G^ the cotangent arriving from the
// later chunks (the final state's for the last chunk), E(i, t) = exp(cs_i
// - cs_t) and t, i, j tokens of the chunk:
//
//   G_t       = sum_{i>=t} E(i, t) gy_i c_i^T + exp(cs_{Q-1} - cs_t) G^
//   G^       <- exp(cs_{Q-1}) G^ + sum_i exp(cs_i) gy_i c_i^T   (the carry)
//   g_x_t     = D gy_t + dt_t G_t b_t
//   G_t b_t   = sum_{i>=t} E(i, t) (c_i . b_t) gy_i
//               + exp(cs_{Q-1} - cs_t) G^ b_t
//   g_b_t     = dt_t G_t^T x_t   (summed over heads), where
//   G_t^T x_t = sum_{i>=t} E(i, t) (gy_i . x_t) c_i
//               + exp(cs_{Q-1} - cs_t) G^T x_t
//   g_c_t     = s_t^T gy_t       (summed over heads)
//             = exp(cs_t) s_in^T gy_t + sum_{j<=t} E(t, j) dt_j (x_j . gy_t) b_j
//   g_l_t     = <G_t, a_t s_{t-1}>, a_t s_{t-1} = s_t - dt_t x_t b_t^T:
//             = sum_{i>=t>j} exp(cs_i - cs_j) dt_j (c_i . b_j)(gy_i . x_j)
//               + sum_{i>=t} exp(cs_i) gy_i^T s_in c_i
//               + sum_{j<t} exp(cs_{Q-1} - cs_j) dt_j x_j^T G^ b_j
//               + exp(cs_{Q-1}) <G^, s_in>
//   g_dt_t    = x_t^T G_t b_t - A g_l_t,  g_A_log = -sum g_l dt A,
//   g_D       = sum gy . x.
//
// g_l's sums have j < t, not j <= t, so none is a difference of two large
// terms (a_t underflows to 0 at large dt A). The cumsums are taken in
// f64, so that a gap cs_i - cs_j is rounded as the sum of its own l's, not
// as the chunk's (in f32, ~1e-5 of a decay at dt A ~ 200 a token).
//
// Bound. Forward: 4 (2 BSHP + 2 BSN + BSH + 2H + BHPN) bytes (x and y, b
// and c, dt, A_log and D, the final state; the kept chunk states, when
// asked for, BHPN ceil(S/Q) more) against, per (b, h, chunk), 2 Q^2 N
// (C B^T) + 2 Q^2 P (its masked product with dt x) + 2 Q N P (C s_in^T)
// + 2 Q P N (the chunk's own state) operations on the tensor cores, each
// taken in three TF32 passes (495 TFLOP/s), and P N + 4 Q P + 2 Q^2 on
// the f32 units (the state's decay; y's scale, sums and skip term; the
// masked decays). At zamba2's layer, B 1, S 4096, H 80, P 64, N 64:
// 172 MB, 0.051 ms at 3.35 TB/s, against 6.71 GFLOP, 0.041 ms in three
// TF32 passes (and 0.003 ms of f32): the bytes bound it. The token loop
// this replaced did 6 f32 FLOP a state element a token, 8.05 GFLOP,
// 0.120 ms at 67 TFLOP/s.
// Backward: x, b, c, dt, A_log, D, the kept chunk states and both
// cotangents read, the six gradients written, against, per (b, h, chunk)
// and group of 64 state rows, 3 x 2 Q^2 N (C B^T; M c and M b for G^T x
// and s^T gy) + 2 x 2 Q^2 P (gy x^T; M gy for G b) + 4 x 2 Q P N (b G^T,
// x G^, gy s_in, the carry) on the tensor cores in three TF32 passes and
// 3 P N + 6 Q P + 6 Q N + 8 Q^2 on the f32 units. At zamba2's training
// call, B 2, S 512, H 80, P 64, N 64: 151 MB, 0.045 ms, against 3.52
// GFLOP, 0.021 ms in three passes: the bytes bound it. The sums across
// heads (g_b, g_c) go through part_b and part_c, 2 BSHN floats written
// and read again by the reduce kernel (84 MB more at that call), which
// the bound does not count.
//
// Forward design:
// - A block of 4 warps per (b, h, 64 state rows); warp w holds the 16
//   rows 16 w .. 16 w + 15 of the state, all N columns, in its mma
//   accumulator registers (32 floats a thread). The carry from chunk to
//   chunk is one multiply-add an element, so a chunk, not a token, is the
//   unit of the serial chain.
// - A chunk's products on tensor cores in 3xTF32 (kernels/csrc/
//   mma_tf32.cuh; a single TF32 or bf16 pass would not hold the forward's
//   1e-5 bar): C B^T once a block, as four quarters (two column halves x
//   two halves of N, one a warp); y's masked product M x (M[t][j] =
//   (c_t . b_j) exp(cs_t - cs_j) dt_j, which each thread forms for its
//   own fragment); C s_in^T, the state's accumulator registers serving as
//   the B operand (a permuted depth index, no exchange between lanes);
//   and the chunk's own state (dt x decay)^T B into the accumulators.
// - Staging: b, c, x and dt of the next three chunks are copied with
//   cp.async into a ring of four stages, and C B^T of chunk k + 1 runs
//   beside chunk k's products: one barrier a chunk.
// - With the kept states asked for, each warp writes its rows of the
//   state entering every chunk from its registers. No float atomics: two
//   runs give the same bits.
// - Sequence segments where the (b, h, rows) blocks are fewer than the
//   SMs (80 at zamba2's batch 1 on 132; ssd.py: segment_chunks): pass 1
//   (ssd_segment_state_kernel, every segment but the last, the state step
//   alone: no C, no y) runs each segment from a zero state to its own
//   state and log decay (the sum of its chunks' cs_last); a carry kernel
//   walks the segments in order, s_in[s] = exp(log decay[s-1]) s_in[s-1]
//   + s_loc[s-1]; pass 2 (ssd_scan_forward_kernel) runs every segment from
//   its incoming state. The chunks stay whole, so the function is
//   unchanged; only the rounding order is. Cost in bytes, with G segments:
//   pass 1 reads x, b and dt of all but the last segment again, and the
//   segments' states move 4 (G-1) BHPN floats (written, carried in and
//   out, read; at zamba2's layer, G = 4: +64 MB and +16 MB, +0.024 ms at
//   3.35 TB/s).
// - What bounds it (PERF.md): the chain of a block's chunks (its mma,
//   the accurate expf of the masked decays, one barrier a chunk) against
//   a few blocks an SM, more than the bytes or the tensor cores.
//
// Backward design:
// - A block of 4 warps per (b, h, 64 state rows), as the forward: warp w
//   holds rows 16 w .. 16 w + 15 of G^ in its mma accumulators, so the
//   carry is the chunk's serial chain (the forward's state step with gy
//   for dt x and c for b), and the sums over the rows (gy x^T, G^T x,
//   <G, s>) stay in the block. With P > 64 each group of 64 rows is a
//   block of its own, its shares of those sums summed by the second
//   kernel: every term above is a sum over rows.
// - A chunk's products in 3xTF32 on the tensor cores: C B^T and gy x^T as
//   quarters (one a warp, as the forward's C B^T); g_x's M gy and b G^T
//   over the warp's 16 rows (b G^T's B operand is G^'s registers, as the
//   forward's C s_in^T); G^T x's M c and x G^, s^T gy's M b and gy s_in
//   over the warp's 16 columns of N, G^ read from a transposed copy in
//   shared memory written once a chunk; the carry. Each thread forms its
//   own fragments of the masked matrices from C B^T and gy x^T.
// - g_l's four sums: the rows' shares of x^T G b, u = gy^T s_in c, v =
//   x^T G^ b and <G^, s_in> through shared memory; the double sum as
//   T(t) = sum_{tau<t} (colsuf(tau) - rowpre(tau)) of K's strictly lower
//   part, 8 lanes a token; then warp 0, a lane a token, the prefix and
//   suffix sums by shuffles, g_dt written directly (one group) and
//   A_log's and D's sums.
// - Staging: x, gy, b, c, dt and the kept state of chunk k - 1 are copied
//   with cp.async into the second of two stages while chunk k runs; three
//   barriers a chunk (the stage and G^'s copy in place; the warps' sums in
//   place; the next stage in place, before its C B^T and gy x^T). 94 KB of
//   shared memory a block, two blocks an SM.
// - The sums across blocks (g_b, g_c over heads and groups; g_dt over
//   groups; g_A_log, g_D over batch rows and groups) go to partial
//   buffers that ssd_scan_reduce_kernel adds in a fixed order. No float
//   atomics: two runs give the same bits.
// - expf is the accurate one; no fast-math flag.
#include "mma_tf32.cuh"
#include "ssd_scan.h"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 16;  // state rows a warp holds (an m16 tile)
constexpr int kC = kSsdChunk;
constexpr int kN = kSsdMaxN;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kSsdRows == kWarps * kWarpRows, "a block's rows, 16 a warp");
static_assert(kSsdRows == kN, "a stage's x rows are as wide as b's");
static_assert(kC == 16, "a chunk is one m16 tile of tokens");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// forward: the chunk form on tensor cores
// ---------------------------------------------------------------------------

constexpr int kRing = 4;                      // stages of the copy ring
constexpr int kStride = kN + 8;  // staged rows: = 8 (mod 32) floats, so the
                                 // fragment loads hit no bank twice
constexpr int kCbStride = kC + 4;

// The warp's quarter of a [kC x kC] Gram product in 3xTF32 (C B^T, gy
// x^T): out[half][i][j] = rows[i] . cols[j] over half = warp >> 1 of the
// depth, for the columns j = 8 (warp & 1) .. + 7; the two halves' shares
// stay apart, for the reader to add.
__device__ __forceinline__ void gram_quarter(const float (*rows)[kStride],
                                             const float (*cols)[kStride],
                                             float (*out)[kC][kCbStride],
                                             int warp, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int jt = warp & 1, half = warp >> 1;
  float acc[2][4] = {}, small[2][4] = {};
#pragma unroll
  for (int i = 0; i < kN / 16; ++i) {
    const int col = 8 * (i + half * kN / 16) + 2 * q;
    const float2 r0 = ld2(&rows[g][col]), r1 = ld2(&rows[g + 8][col]);
    const float2 cj = ld2(&cols[8 * jt + g][col]);
    const float a[4] = {r0.x, r1.x, r0.y, r1.y};
    const float bb[2] = {cj.x, cj.y};
    mma3(acc[i & 1], small[i & 1], a, bb);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    out[half][g + (e >= 2 ? 8 : 0)][8 * jt + 2 * q + (e & 1)] =
        (acc[0][e] + acc[1][e]) + (small[0][e] + small[1][e]);
}

struct FwdStage {
  float x[kC][kStride];  // x_t of the block's kSsdRows state rows
  float b[kC][kStride];
  float c[kC][kStride];
  float dt[kC];
};

struct FwdSmem {
  FwdStage stage[kRing];
  float cb[2][2][kC][kCbStride];  // C B^T: [chunk parity][half of N][t][j]
};

// A warp's 16 rows of a [P, N] state (or of its cotangent): rows r0 + g
// (+ 8), columns 8 i + 2 q (+ 1) of n-tile i (g = lane / 4, q = lane %
// 4), as m16n8 accumulators.
struct WarpRows {
  float s[kN / 8][4];
};

__device__ __forceinline__ void store_rows(const WarpRows& st, float* base,
                                           int r0, int lane, int p, int n) {
  const int g = lane >> 2, q = lane & 3;
  const bool pairs = (n & 1) == 0;  // (col, col + 1) 8-byte aligned
#pragma unroll
  for (int i = 0; i < kN / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h, col = 8 * i + 2 * q;
      if (row >= p || col >= n) continue;
      float* at = base + (long long)row * n + col;
      if (pairs) {
        *reinterpret_cast<float2*>(at) =
            make_float2(st.s[i][2 * h], st.s[i][2 * h + 1]);
      } else {
        at[0] = st.s[i][2 * h];
        if (col + 1 < n) at[1] = st.s[i][2 * h + 1];
      }
    }
}

__device__ __forceinline__ void load_rows(WarpRows& st, const float* base,
                                          int r0, int lane, int p, int n) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < kN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + (e >= 2 ? 8 : 0), col = 8 * i + 2 * q + (e & 1);
      st.s[i][e] = row < p && col < n ? base[(long long)row * n + col] : 0.f;
    }
}

// Block (group of 64 state rows, h, b) x segment of `segment` chunks.
// kStateOnly (pass 1, every segment but the last): the state the segment
// leaves from a zero state entering it, into s_loc, and its log decay
// (the sum of its chunks' cs_last), into log_decay; no y. Otherwise (pass
// 2): y from the state entering the segment (zero, or s_in from the
// carry), the kept chunk states, and the final state from the last
// segment.
template <bool kVec, bool kStateOnly>
__device__ __forceinline__ void forward_segment(
    const float* __restrict__ xs, const float* __restrict__ bmat,
    const float* __restrict__ cmat, const float* __restrict__ dt,
    const float* __restrict__ a_log, const float* __restrict__ d_skip,
    const float* __restrict__ s_in, float* __restrict__ y,
    float* __restrict__ s_fin, float* __restrict__ s_chunks,
    float* __restrict__ s_loc, float* __restrict__ log_decay, int seq,
    int heads, int p, int n, int segment, int segs) {
  extern __shared__ float4 smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int per_group = kStateOnly ? segs - 1 : segs;
  const int group = blockIdx.x / per_group, seg = blockIdx.x % per_group;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int row0 = group * kSsdRows;  // the block's first state row
  const int wr = warp * kWarpRows;   // the warp's first row in a stage
  const long long bh = (long long)b * heads + h;
  const long long state = (long long)p * n;
  const int n_chunks = (seq + kC - 1) / kC;
  const int c0 = seg * segment, c1 = min(c0 + segment, n_chunks);
  const float big_a = expf(a_log[h]);
  const float dskip = d_skip[h];

  // chunk k's x, b, c (not in pass 1) and dt into its stage (zeros past
  // the sequence, P and N); one commit group either way
  auto stage_chunk = [&](int k) {
    if (k < c1) {
      FwdStage& stg = sm.stage[(k - c0) % kRing];
      const int t0 = k * kC, len = min(kC, seq - t0);
      if (kVec) {
        for (int i = tid; i < kC * kN / 4; i += kThreads) {
          const int t = i / (kN / 4), col = 4 * (i % (kN / 4));
          const long long tok = (long long)b * seq + t0 + t;
          const bool okx = t < len && row0 + col < p;
          const bool okn = t < len && col < n;
          cp_async16(&stg.x[t][col],
                     okx ? xs + (tok * heads + h) * p + row0 + col : xs, okx);
          cp_async16(&stg.b[t][col], okn ? bmat + tok * n + col : bmat, okn);
          if (!kStateOnly)
            cp_async16(&stg.c[t][col], okn ? cmat + tok * n + col : cmat,
                       okn);
        }
      } else {
        for (int i = tid; i < kC * kN; i += kThreads) {
          const int t = i / kN, col = i % kN;
          const long long tok = (long long)b * seq + t0 + t;
          const bool okx = t < len && row0 + col < p;
          const bool okn = t < len && col < n;
          cp_async4(&stg.x[t][col],
                    okx ? xs + (tok * heads + h) * p + row0 + col : xs, okx);
          cp_async4(&stg.b[t][col], okn ? bmat + tok * n + col : bmat, okn);
          if (!kStateOnly)
            cp_async4(&stg.c[t][col], okn ? cmat + tok * n + col : cmat,
                      okn);
        }
      }
      if (tid < kC) {
        const bool ok = tid < len;
        cp_async4(&stg.dt[tid],
                  ok ? dt + ((long long)b * seq + t0 + tid) * heads + h : dt,
                  ok);
      }
    }
    cp_async_commit();
  };

  // the warp's quarter of chunk k's C B^T, into cb[(k - c0) & 1]
  auto cb_quarter = [&](int k) {
    const FwdStage& sg = sm.stage[(k - c0) % kRing];
    gram_quarter(sg.c, sg.b, sm.cb[(k - c0) & 1], warp, lane);
  };

  WarpRows st = {};
  if (!kStateOnly && seg > 0)  // the state entering the segment, carried
    load_rows(st, s_in + (bh * (segs - 1) + seg - 1) * state, row0 + wr,
              lane, p, n);
  float log_p = 0.f;  // pass 1: the segment's log decay
  stage_chunk(c0);
  stage_chunk(c0 + 1);
  stage_chunk(c0 + 2);
  cp_async_wait<2>();
  __syncthreads();
  if (!kStateOnly) cb_quarter(c0);
  cp_async_wait<1>();
  __syncthreads();

  for (int k = c0; k < c1; ++k) {
    stage_chunk(k + 3);  // into the stage chunk k - 1 left
    const FwdStage& sg = sm.stage[(k - c0) % kRing];
    const int t0 = k * kC, len = min(kC, seq - t0);
    if (!kStateOnly && s_chunks != nullptr)  // the state entering chunk k
      store_rows(st, s_chunks + (bh * n_chunks + k) * state, row0 + wr, lane,
                 p, n);

    // in-chunk cumsum of l_t = -dt_t A: lane L holds token L % 16's
    const int tl = lane & (kC - 1);
    float cs = -sg.dt[tl] * big_a;
#pragma unroll
    for (int off = 1; off < kC; off <<= 1) {
      const float up = __shfl_up_sync(kFull, cs, off, kC);
      if (tl >= off) cs += up;
    }
    const float cs_last = __shfl_sync(kFull, cs, kC - 1);
    // the fragments' tokens j = 8 kk + q + 4 u: their cumsums and dt
    float cs_j[2][2], dt_j[2][2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 8 * kk + q + 4 * u;
        cs_j[kk][u] = __shfl_sync(kFull, cs, j);
        dt_j[kk][u] = sg.dt[j];
      }

    if (!kStateOnly) {
      // y = M x + exp(cs_t) C s_in^T + D x over the warp's two 8-row
      // halves (pt) of its 16 state rows: M's fragment a = {M[g][j],
      // M[g+8][j], M[g][j+4], M[g+8][j+4]}, j = 8 kk + q
      const float(*cb0)[kCbStride] = sm.cb[(k - c0) & 1][0];
      const float(*cb1)[kCbStride] = sm.cb[(k - c0) & 1][1];
      const float cs_t[2] = {__shfl_sync(kFull, cs, g),
                             __shfl_sync(kFull, cs, g + 8)};
      float yi[2][4] = {}, yis[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        unsigned mh[4], ml[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ti = e & 1, u = e >> 1;
          const int t = g + 8 * ti, j = 8 * kk + q + 4 * u;
          const float m = j <= t ? (cb0[t][j] + cb1[t][j]) *
                                       expf(cs_t[ti] - cs_j[kk][u]) *
                                       dt_j[kk][u]
                                 : 0.f;
          split(m, mh[e], ml[e]);
        }
#pragma unroll
        for (int pt = 0; pt < 2; ++pt) {
          const float bb[2] = {sg.x[8 * kk + q][wr + 8 * pt + g],
                               sg.x[8 * kk + q + 4][wr + 8 * pt + g]};
          mma3_split_a(yi[pt], yis[pt], mh, ml, bb);
        }
      }
      float ye[2][2][4] = {}, yes[2][2][4] = {};
#pragma unroll
      for (int i = 0; i < kN / 8; ++i) {
        const int col = 8 * i + 2 * q;
        const float2 c0v = ld2(&sg.c[g][col]), c1v = ld2(&sg.c[g + 8][col]);
        const float a[4] = {c0v.x, c1v.x, c0v.y, c1v.y};
        unsigned ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(a[e], ah[e], al[e]);
#pragma unroll
        for (int pt = 0; pt < 2; ++pt) {
          const float bb[2] = {st.s[i][2 * pt], st.s[i][2 * pt + 1]};
          mma3_split_a(ye[pt][i & 1], yes[pt][i & 1], ah, al, bb);
        }
      }
      const float e_t[2] = {expf(cs_t[0]), expf(cs_t[1])};
      const bool pairs = (p & 1) == 0;  // (col, col + 1) 8-byte aligned
#pragma unroll
      for (int pt = 0; pt < 2; ++pt)
#pragma unroll
        for (int ti = 0; ti < 2; ++ti) {
          const int t = g + 8 * ti, col = wr + 8 * pt + 2 * q;
          float val[2];
#pragma unroll
          for (int o = 0; o < 2; ++o) {
            const int e = 2 * ti + o;
            const float inter = (ye[pt][0][e] + ye[pt][1][e]) +
                                (yes[pt][0][e] + yes[pt][1][e]);
            val[o] = e_t[ti] * inter + (yi[pt][e] + yis[pt][e]) +
                     dskip * sg.x[t][col + o];
          }
          if (t >= len || row0 + col >= p) continue;
          float* at = y + (((long long)b * seq + t0 + t) * heads + h) * p +
                      row0 + col;
          if (pairs) {
            *reinterpret_cast<float2*>(at) = make_float2(val[0], val[1]);
          } else {
            at[0] = val[0];
            if (row0 + col + 1 < p) at[1] = val[1];
          }
        }
    } else {
      log_p += cs_last;
    }

    // the state: s <- exp(cs_last) s + W^T B, W[j][r] = exp(cs_last -
    // cs_j) dt_j x_j[r]; W^T's fragment split once a depth step
    unsigned wh[2][4], wl[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 8 * kk + q + 4 * u;
        const float wj = expf(cs_last - cs_j[kk][u]) * dt_j[kk][u];
        split(wj * sg.x[j][wr + g], wh[kk][2 * u], wl[kk][2 * u]);
        split(wj * sg.x[j][wr + g + 8], wh[kk][2 * u + 1],
              wl[kk][2 * u + 1]);
      }
    const float decay = expf(cs_last);
#pragma unroll
    for (int i = 0; i < kN / 8; ++i) {
      float small[4] = {};
#pragma unroll
      for (int e = 0; e < 4; ++e) st.s[i][e] *= decay;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float bb[2] = {sg.b[8 * kk + q][8 * i + g],
                             sg.b[8 * kk + q + 4][8 * i + g]};
        mma3_split_a(st.s[i], small, wh[kk], wl[kk], bb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) st.s[i][e] += small[e];
    }

    if (!kStateOnly && k + 1 < c1) cb_quarter(k + 1);
    cp_async_wait<1>();  // chunk k + 2's copies, for the next C B^T
    __syncthreads();
  }
  if (kStateOnly) {
    const long long slot = bh * (segs - 1) + seg;
    store_rows(st, s_loc + slot * state, row0 + wr, lane, p, n);
    if (group == 0 && tid == 0) log_decay[slot] = log_p;
  } else if (seg == segs - 1) {
    store_rows(st, s_fin + bh * state, row0 + wr, lane, p, n);
  }
}

// Pass 1: every segment but the last from a zero state (its own state and
// log decay).
template <bool kVec>
__global__ void __launch_bounds__(kThreads) ssd_segment_state_kernel(
    const float* __restrict__ xs, const float* __restrict__ bmat,
    const float* __restrict__ cmat, const float* __restrict__ dt,
    const float* __restrict__ a_log, const float* __restrict__ d_skip,
    const float* __restrict__ s_in, float* __restrict__ y,
    float* __restrict__ s_fin, float* __restrict__ s_chunks,
    float* __restrict__ s_loc, float* __restrict__ log_decay, int seq,
    int heads, int p, int n, int segment, int segs) {
  forward_segment<kVec, true>(xs, bmat, cmat, dt, a_log, d_skip, s_in, y,
                              s_fin, s_chunks, s_loc, log_decay, seq, heads,
                              p, n, segment, segs);
}

// Pass 2 (the only one when the (b, h, rows) blocks fill the card): y,
// the kept states and the final state, every segment from its incoming
// state.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) ssd_scan_forward_kernel(
    const float* __restrict__ xs, const float* __restrict__ bmat,
    const float* __restrict__ cmat, const float* __restrict__ dt,
    const float* __restrict__ a_log, const float* __restrict__ d_skip,
    const float* __restrict__ s_in, float* __restrict__ y,
    float* __restrict__ s_fin, float* __restrict__ s_chunks,
    float* __restrict__ s_loc, float* __restrict__ log_decay, int seq,
    int heads, int p, int n, int segment, int segs) {
  forward_segment<kVec, false>(xs, bmat, cmat, dt, a_log, d_skip, s_in, y,
                               s_fin, s_chunks, s_loc, log_decay, seq, heads,
                               p, n, segment, segs);
}

// The carry over segments: s_in[s] = exp(log_decay[s-1]) s_in[s-1] +
// s_loc[s-1] for s = 1 .. segs-1, stored at slot s-1 (s_in[0] is zero).
// A thread per state element: blocks (b h, element tile), segments in
// order.
__global__ void __launch_bounds__(256)
ssd_segment_carry_kernel(const float* __restrict__ s_loc,
                         const float* __restrict__ log_decay,
                         float* __restrict__ s_in, int elems, int segs) {
  const int e = blockIdx.y * 256 + threadIdx.x;
  if (e >= elems) return;
  const long long first = (long long)blockIdx.x * (segs - 1);
  float cur = 0.f;
  for (int s = 0; s + 1 < segs; ++s) {
    const long long slot = first + s;
    cur = expf(log_decay[slot]) * cur + s_loc[slot * elems + e];
    s_in[slot * elems + e] = cur;
  }
}

// ---------------------------------------------------------------------------
// backward: the chunk form on tensor cores, in reverse
// ---------------------------------------------------------------------------

constexpr int kSinStride = kN + 4;  // s_in rows: = 4 (mod 32) floats, so the
                                    // B-operand loads down a column hit no
                                    // bank twice

struct BwdStage {
  float x[kC][kStride];   // x_t and gy_t of the block's kSsdRows rows
  float gy[kC][kStride];
  float b[kC][kStride];
  float c[kC][kStride];
  float s_in[kSsdRows][kSinStride];  // the kept state entering the chunk
  float dt[kC];
};

struct BwdSmem {
  BwdStage stage[2];
  float g_hat_t[kN][kStride];  // G^ (the cotangent from the later chunks),
                               // transposed: [n][row]
  float cb[2][kC][kCbStride];  // C B^T: [half of N][i][j]
  float w[2][kC][kCbStride];   // gy x^T: [half of the rows][i][j]
  float red[4][kWarps][kC];    // each warp's share of x^T G b, u, v, and
                               // <G^, s_in> (at [3][warp][0])
  float k_gap[kC];             // colsuf(t) - rowpre(t) of g_l's first sum
};

// v summed over the 4 lanes of a quad (q = 0..3), in a fixed order.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// Block (group of 64 state rows, h, b): the chunks in reverse, G^ (the
// group's rows) in the warps' accumulators. Writes g_x, each (b, h, group)'s
// share of g_b and g_c (part_b, part_c: [B, S, H, groups, N]) and of g_dt
// (part_dt: [B, S, H, groups]; g_dt itself with one group), and of A_log's
// and D's sums (part_h: [2, B, H, groups]).
template <bool kVec>
__global__ void __launch_bounds__(kThreads) ssd_scan_backward_kernel(
    const float* __restrict__ xs, const float* __restrict__ bmat,
    const float* __restrict__ cmat, const float* __restrict__ dt,
    const float* __restrict__ a_log, const float* __restrict__ d_skip,
    const float* __restrict__ s_chunks, const float* __restrict__ gy,
    const float* __restrict__ gs, float* __restrict__ gx,
    float* __restrict__ part_b, float* __restrict__ part_c,
    float* __restrict__ part_dt, float* __restrict__ part_h, int batch,
    int seq, int heads, int p, int n) {
  extern __shared__ float4 smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int group = blockIdx.x, groups = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int row0 = group * kSsdRows;  // the block's first state row
  const int wr = warp * kWarpRows;    // the warp's first row in a stage
  const long long bh = (long long)b * heads + h;
  const long long state = (long long)p * n;
  const int n_chunks = (seq + kC - 1) / kC;
  const float big_a = expf(a_log[h]);
  const float dskip = d_skip[h];

  // chunk k's x, gy, b, c, dt and kept state into its stage (zeros past
  // the sequence, P and N); one commit group either way
  auto stage_chunk = [&](int k) {
    if (k >= 0) {
      BwdStage& stg = sm.stage[k & 1];
      const int t0 = k * kC, len = min(kC, seq - t0);
      const float* s_k = s_chunks + (bh * n_chunks + k) * state;
      if (kVec) {
        for (int i = tid; i < kC * kN / 4; i += kThreads) {
          const int t = i / (kN / 4), col = 4 * (i % (kN / 4));
          const long long tok = (long long)b * seq + t0 + t;
          const bool okx = t < len && row0 + col < p;
          const bool okn = t < len && col < n;
          const long long at = (tok * heads + h) * p + row0 + col;
          cp_async16(&stg.x[t][col], okx ? xs + at : xs, okx);
          cp_async16(&stg.gy[t][col], okx ? gy + at : gy, okx);
          cp_async16(&stg.b[t][col], okn ? bmat + tok * n + col : bmat, okn);
          cp_async16(&stg.c[t][col], okn ? cmat + tok * n + col : cmat, okn);
        }
        for (int i = tid; i < kSsdRows * kN / 4; i += kThreads) {
          const int r = i / (kN / 4), col = 4 * (i % (kN / 4));
          const bool ok = row0 + r < p && col < n;
          cp_async16(&stg.s_in[r][col],
                     ok ? s_k + (long long)(row0 + r) * n + col : s_k, ok);
        }
      } else {
        for (int i = tid; i < kC * kN; i += kThreads) {
          const int t = i / kN, col = i % kN;
          const long long tok = (long long)b * seq + t0 + t;
          const bool okx = t < len && row0 + col < p;
          const bool okn = t < len && col < n;
          const long long at = (tok * heads + h) * p + row0 + col;
          cp_async4(&stg.x[t][col], okx ? xs + at : xs, okx);
          cp_async4(&stg.gy[t][col], okx ? gy + at : gy, okx);
          cp_async4(&stg.b[t][col], okn ? bmat + tok * n + col : bmat, okn);
          cp_async4(&stg.c[t][col], okn ? cmat + tok * n + col : cmat, okn);
        }
        for (int i = tid; i < kSsdRows * kN; i += kThreads) {
          const int r = i / kN, col = i % kN;
          const bool ok = row0 + r < p && col < n;
          cp_async4(&stg.s_in[r][col],
                    ok ? s_k + (long long)(row0 + r) * n + col : s_k, ok);
        }
      }
      if (tid < kC) {
        const bool ok = tid < len;
        cp_async4(&stg.dt[tid],
                  ok ? dt + ((long long)b * seq + t0 + tid) * heads + h : dt,
                  ok);
      }
    }
    cp_async_commit();
  };

  // G^ into the transposed shared copy the products over the rows read
  auto store_g_hat = [&](const WarpRows& gh) {
#pragma unroll
    for (int i = 0; i < kN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sm.g_hat_t[8 * i + 2 * q + (e & 1)][wr + g + (e >= 2 ? 8 : 0)] =
            gh.s[i][e];
  };

  WarpRows gh;  // G^ entering the chunk: the final state's cotangent first
  load_rows(gh, gs + bh * state, row0 + wr, lane, p, n);
  store_g_hat(gh);
  stage_chunk(n_chunks - 1);
  cp_async_wait<0>();
  __syncthreads();
  gram_quarter(sm.stage[(n_chunks - 1) & 1].c, sm.stage[(n_chunks - 1) & 1].b,
               sm.cb, warp, lane);
  gram_quarter(sm.stage[(n_chunks - 1) & 1].gy,
               sm.stage[(n_chunks - 1) & 1].x, sm.w, warp, lane);
  float acc_l = 0.f, acc_d = 0.f;  // warp 0: sum g_l dt, sum gy . x

  for (int k = n_chunks - 1; k >= 0; --k) {
    __syncthreads();  // chunk k's stage, C B^T, gy x^T and G^ are in place
    stage_chunk(k - 1);  // into the stage chunk k + 1 left
    const BwdStage& sg = sm.stage[k & 1];
    const int t0 = k * kC, len = min(kC, seq - t0);
    auto cb_at = [&](int i, int j) { return sm.cb[0][i][j] + sm.cb[1][i][j]; };
    auto w_at = [&](int i, int j) { return sm.w[0][i][j] + sm.w[1][i][j]; };

    // in-chunk cumsum of l_t = -dt_t A in f64 (lane L: token L % 16's), so
    // that a gap cs_i - cs_j is rounded as the sum of its own l's
    const int tl = lane & (kC - 1);
    double cs = static_cast<double>(-sg.dt[tl] * big_a);
#pragma unroll
    for (int off = 1; off < kC; off <<= 1) {
      const double up = __shfl_up_sync(kFull, cs, off, kC);
      if (tl >= off) cs += up;
    }
    const double cs_last = __shfl_sync(kFull, cs, kC - 1);
    const double cs_t[2] = {__shfl_sync(kFull, cs, g),
                            __shfl_sync(kFull, cs, g + 8)};
    // the fragments' depth tokens j = 8 kk + q + 4 u: cumsums and dt
    double cs_j[2][2];
    float dt_j[2][2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 8 * kk + q + 4 * u;
        cs_j[kk][u] = __shfl_sync(kFull, cs, j);
        dt_j[kk][u] = sg.dt[j];
      }
    // the masked decays at an A fragment's (t, j) = (g + 8 (e & 1), 8 kk +
    // q + 4 (e >> 1)): up = exp(cs_j - cs_t) for j >= t, lo = exp(cs_t -
    // cs_j) for j <= t
    float up[2][4], lo[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ti = e & 1, u = e >> 1;
        const int t = g + 8 * ti, j = 8 * kk + q + 4 * u;
        const float gap = static_cast<float>(cs_j[kk][u] - cs_t[ti]);
        up[kk][e] = j >= t ? expf(gap) : 0.f;
        lo[kk][e] = j <= t ? expf(-gap) : 0.f;
      }
    const float tail[2] = {expf(static_cast<float>(cs_last - cs_t[0])),
                           expf(static_cast<float>(cs_last - cs_t[1]))};
    const float dt_t[2] = {sg.dt[g], sg.dt[g + 8]};

    // g_x = D gy + dt (Mb gy + exp(cs_last - cs_t) b G^T) over the warp's
    // 16 rows, Mb[t][i] = exp(cs_i - cs_t) (c_i . b_t), i >= t; and each
    // token's x^T G b over them
    {
      float mi[2][4] = {}, mis[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        unsigned mh[4], ml[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = g + 8 * (e & 1), j = 8 * kk + q + 4 * (e >> 1);
          split(up[kk][e] * cb_at(j, t), mh[e], ml[e]);
        }
#pragma unroll
        for (int pt = 0; pt < 2; ++pt) {
          const float bb[2] = {sg.gy[8 * kk + q][wr + 8 * pt + g],
                               sg.gy[8 * kk + q + 4][wr + 8 * pt + g]};
          mma3_split_a(mi[pt], mis[pt], mh, ml, bb);
        }
      }
      float me[2][2][4] = {}, mes[2][2][4] = {};
#pragma unroll
      for (int i = 0; i < kN / 8; ++i) {
        const int col = 8 * i + 2 * q;
        const float2 b0 = ld2(&sg.b[g][col]), b1 = ld2(&sg.b[g + 8][col]);
        const float a[4] = {b0.x, b1.x, b0.y, b1.y};
        unsigned ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(a[e], ah[e], al[e]);
#pragma unroll
        for (int pt = 0; pt < 2; ++pt) {
          const float bb[2] = {gh.s[i][2 * pt], gh.s[i][2 * pt + 1]};
          mma3_split_a(me[pt][i & 1], mes[pt][i & 1], ah, al, bb);
        }
      }
      const bool pairs = (p & 1) == 0;  // (col, col + 1) 8-byte aligned
      float xgb[2] = {0.f, 0.f};
#pragma unroll
      for (int pt = 0; pt < 2; ++pt)
#pragma unroll
        for (int ti = 0; ti < 2; ++ti) {
          const int t = g + 8 * ti, col = wr + 8 * pt + 2 * q;
          float val[2];
#pragma unroll
          for (int o = 0; o < 2; ++o) {
            const int e = 2 * ti + o;
            const float gb = (mi[pt][e] + mis[pt][e]) +
                             tail[ti] * ((me[pt][0][e] + me[pt][1][e]) +
                                         (mes[pt][0][e] + mes[pt][1][e]));
            xgb[ti] += sg.x[t][col + o] * gb;
            val[o] = dskip * sg.gy[t][col + o] + dt_t[ti] * gb;
          }
          if (t >= len || row0 + col >= p) continue;
          float* at = gx + (((long long)b * seq + t0 + t) * heads + h) * p +
                      row0 + col;
          if (pairs) {
            *reinterpret_cast<float2*>(at) = make_float2(val[0], val[1]);
          } else {
            at[0] = val[0];
            if (row0 + col + 1 < p) at[1] = val[1];
          }
        }
#pragma unroll
      for (int ti = 0; ti < 2; ++ti) {
        const float v = quad_sum(xgb[ti]);
        if (q == 0) sm.red[0][warp][g + 8 * ti] = v;
      }
    }

    // the warp's 16 columns of N (n-tiles 2 warp, 2 warp + 1):
    //   G^T x = Mx c + exp(cs_last - cs_t) x G^, Mx[t][i] = exp(cs_i - cs_t)
    //           (gy_i . x_t), i >= t; g_b's share dt G^T x
    //   s^T gy = Mc b + exp(cs_t) gy s_in, Mc[t][j] = exp(cs_t - cs_j) dt_j
    //           (gy_t . x_j), j <= t: g_c's share
    // and each token's v_t = x_t^T G^ b_t and u_t = gy_t^T s_in c_t over
    // them
    {
      const bool pairs = (n & 1) == 0;
      const long long out0 = ((long long)b * seq + t0) * heads + h;
      float vs[2] = {0.f, 0.f}, us[2] = {0.f, 0.f};
#pragma unroll
      for (int which = 0; which < 2; ++which) {  // 0: g_b's, 1: g_c's
        float mm[2][4] = {}, mms[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          unsigned mh[4], ml[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ti = e & 1, u = e >> 1;
            const int t = g + 8 * ti, j = 8 * kk + q + 4 * u;
            const float m = which == 0 ? up[kk][e] * w_at(j, t)
                                       : lo[kk][e] * w_at(t, j) * dt_j[kk][u];
            split(m, mh[e], ml[e]);
          }
          const float(*rhs)[kStride] = which == 0 ? sg.c : sg.b;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int nc = 8 * (2 * warp + nt) + g;
            const float bb[2] = {rhs[8 * kk + q][nc], rhs[8 * kk + q + 4][nc]};
            mma3_split_a(mm[nt], mms[nt], mh, ml, bb);
          }
        }
        // x G^ (G^ from its transposed copy) or gy s_in, over the rows
        float mr[2][2][4] = {}, mrs[2][2][4] = {};
        const float(*lhs)[kStride] = which == 0 ? sg.x : sg.gy;
#pragma unroll
        for (int kp = 0; kp < kSsdRows / 8; ++kp) {
          const int col = 8 * kp + 2 * q;
          const float2 l0 = ld2(&lhs[g][col]), l1 = ld2(&lhs[g + 8][col]);
          const float a[4] = {l0.x, l1.x, l0.y, l1.y};
          unsigned ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split(a[e], ah[e], al[e]);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int nc = 8 * (2 * warp + nt) + g;
            float bb[2];
            if (which == 0) {
              const float2 r = ld2(&sm.g_hat_t[nc][col]);
              bb[0] = r.x;
              bb[1] = r.y;
            } else {
              bb[0] = sg.s_in[col][nc];
              bb[1] = sg.s_in[col + 1][nc];
            }
            mma3_split_a(mr[nt][kp & 1], mrs[nt][kp & 1], ah, al, bb);
          }
        }
        float* part = which == 0 ? part_b : part_c;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int ti = 0; ti < 2; ++ti) {
            const int t = g + 8 * ti, col = 8 * (2 * warp + nt) + 2 * q;
            float val[2];
#pragma unroll
            for (int o = 0; o < 2; ++o) {
              const int e = 2 * ti + o;
              const float r = (mr[nt][0][e] + mr[nt][1][e]) +
                              (mrs[nt][0][e] + mrs[nt][1][e]);
              const float mv = mm[nt][e] + mms[nt][e];
              if (which == 0) {
                vs[ti] += r * sg.b[t][col + o];
                val[o] = dt_t[ti] * (mv + tail[ti] * r);
              } else {
                us[ti] += r * sg.c[t][col + o];
                val[o] = mv + expf(static_cast<float>(cs_t[ti])) * r;
              }
            }
            if (t >= len || col >= n) continue;
            float* at = part + ((out0 + (long long)t * heads) * groups +
                                group) * n + col;
            if (pairs) {
              *reinterpret_cast<float2*>(at) = make_float2(val[0], val[1]);
            } else {
              at[0] = val[0];
              if (col + 1 < n) at[1] = val[1];
            }
          }
      }
#pragma unroll
      for (int ti = 0; ti < 2; ++ti) {
        const float v = quad_sum(vs[ti]), u = quad_sum(us[ti]);
        if (q == 0) {
          sm.red[2][warp][g + 8 * ti] = v;
          sm.red[1][warp][g + 8 * ti] = u;
        }
      }
    }

    // <G^, s_in> over the warp's rows
    {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kN / 8; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 s2 = ld2(&sg.s_in[wr + g + 8 * hh][8 * i + 2 * q]);
          dot += gh.s[i][2 * hh] * s2.x + gh.s[i][2 * hh + 1] * s2.y;
        }
      dot = warp_sum(dot);
      if (lane == 0) sm.red[3][warp][0] = dot;
    }

    // g_l's first sum, sum_{i >= t > j} K[i][j] with K[i][j] = exp(cs_i -
    // cs_j) dt_j (c_i . b_j)(gy_i . x_j), i > j, is T(t) = sum_{tau < t}
    // colsuf(tau) - rowpre(tau): rowpre(tau) = sum_{j < tau} K[tau][j],
    // colsuf(tau) = sum_{i > tau} K[i][tau]. Warp w takes tau = 4 w ..
    // 4 w + 3, 8 lanes a tau, each 2 of the 16 j (and i).
    {
      const int tau = 4 * warp + (lane >> 3), sub = lane & 7;
      const double cs_tau = __shfl_sync(kFull, cs, tau);
      float rowpre = 0.f, colsuf = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = sub + 8 * r;
        const double cs_o = __shfl_sync(kFull, cs, j);
        const float e = expf(static_cast<float>(j < tau ? cs_tau - cs_o
                                                        : cs_o - cs_tau));
        if (j < tau) rowpre += e * sg.dt[j] * cb_at(tau, j) * w_at(tau, j);
        if (j > tau) colsuf += e * sg.dt[tau] * cb_at(j, tau) * w_at(j, tau);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        rowpre += __shfl_xor_sync(kFull, rowpre, off);
        colsuf += __shfl_xor_sync(kFull, colsuf, off);
      }
      if (sub == 0) sm.k_gap[tau] = colsuf - rowpre;
    }
    __syncthreads();  // the warps' sums are in place; G^'s copy is read

    // warp 0, lane t (t < len): g_l, g_dt, and the A_log and D sums
    if (warp == 0) {
      float xgb = 0.f, u = 0.f, v = 0.f, dot = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        xgb += sm.red[0][w][tl];
        u += sm.red[1][w][tl];
        v += sm.red[2][w][tl];
        dot += sm.red[3][w][0];
      }
      const float d_tl = sg.dt[tl];
      // exclusive prefix sums (T(t), and sum_{j < t} exp(cs_last - cs_j)
      // dt_j v_j) and an inclusive suffix sum (sum_{i >= t} exp(cs_i) u_i)
      float t1 = sm.k_gap[tl];
      float t3 = expf(static_cast<float>(cs_last - cs)) * d_tl * v;
      float t2 = expf(static_cast<float>(cs)) * u;
#pragma unroll
      for (int off = 1; off < kC; off <<= 1) {
        const float a1 = __shfl_up_sync(kFull, t1, off, kC);
        const float a3 = __shfl_up_sync(kFull, t3, off, kC);
        const float a2 = __shfl_down_sync(kFull, t2, off, kC);
        if (tl >= off) {
          t1 += a1;
          t3 += a3;
        }
        if (tl + off < kC) t2 += a2;
      }
      t1 = __shfl_up_sync(kFull, t1, 1, kC);
      t3 = __shfl_up_sync(kFull, t3, 1, kC);
      if (tl == 0) t1 = t3 = 0.f;
      const float g_l =
          t1 + t2 + t3 + expf(static_cast<float>(cs_last)) * dot;
      if (lane < len) {
        part_dt[(((long long)b * seq + t0 + lane) * heads + h) * groups +
                group] = xgb - big_a * g_l;
        acc_l += g_l * d_tl;
        acc_d += w_at(lane, lane);
      }
    }

    if (k > 0) {
      // the carry: G^ <- exp(cs_last) G^ + (exp(cs) gy)^T C, the A
      // fragment split once a depth step
      unsigned wh[2][4], wl[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = 8 * kk + q + 4 * u;
          const float wi = expf(static_cast<float>(cs_j[kk][u]));
          split(wi * sg.gy[i][wr + g], wh[kk][2 * u], wl[kk][2 * u]);
          split(wi * sg.gy[i][wr + g + 8], wh[kk][2 * u + 1],
                wl[kk][2 * u + 1]);
        }
      const float decay = expf(static_cast<float>(cs_last));
#pragma unroll
      for (int i = 0; i < kN / 8; ++i) {
        float small[4] = {};
#pragma unroll
        for (int e = 0; e < 4; ++e) gh.s[i][e] *= decay;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float bb[2] = {sg.c[8 * kk + q][8 * i + g],
                               sg.c[8 * kk + q + 4][8 * i + g]};
          mma3_split_a(gh.s[i], small, wh[kk], wl[kk], bb);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) gh.s[i][e] += small[e];
      }
      store_g_hat(gh);
      cp_async_wait<0>();  // chunk k - 1's copies
      __syncthreads();     // ... seen by every warp; warp 0's reads done
      gram_quarter(sm.stage[(k - 1) & 1].c, sm.stage[(k - 1) & 1].b, sm.cb,
                   warp, lane);
      gram_quarter(sm.stage[(k - 1) & 1].gy, sm.stage[(k - 1) & 1].x, sm.w,
                   warp, lane);
    }
  }

  // the block's A_log and D sums, in a fixed order (warp 0's lanes)
  if (warp == 0) {
    acc_l = warp_sum(acc_l);
    acc_d = warp_sum(acc_d);
    if (lane == 0) {
      const long long slot = bh * groups + group;
      part_h[slot] = -big_a * acc_l;
      part_h[(long long)batch * heads * groups + slot] = acc_d;
    }
  }
}

// The sums across blocks, each in a fixed order: g_b and g_c over heads
// and groups; g_dt over groups (with one group the scan wrote it); g_A_log
// and g_D over batch rows and groups.
__global__ void ssd_scan_reduce_kernel(
    const float* __restrict__ part_b, const float* __restrict__ part_c,
    const float* __restrict__ part_dt, const float* __restrict__ part_h,
    float* __restrict__ gb, float* __restrict__ gc, float* __restrict__ gdt,
    float* __restrict__ ga_log, float* __restrict__ gd, int batch, int seq,
    int heads, int groups, int n) {
  const long long bsn = (long long)batch * seq * n;
  const long long bsh = groups > 1 ? (long long)batch * seq * heads : 0;
  const long long total = bsn + bsh + heads;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    if (i < bsn) {
      const long long bs = i / n;
      const int j = static_cast<int>(i % n);
      float sb = 0.f, sc = 0.f;
      for (int h = 0; h < heads; ++h) {
        for (int gr = 0; gr < groups; ++gr) {
          const long long at = ((bs * heads + h) * groups + gr) * n + j;
          sb += part_b[at];
          sc += part_c[at];
        }
      }
      gb[i] = sb;
      gc[i] = sc;
    } else if (i < bsn + bsh) {
      const long long bsh_i = i - bsn;
      float sum = 0.f;
      for (int gr = 0; gr < groups; ++gr) sum += part_dt[bsh_i * groups + gr];
      gdt[bsh_i] = sum;
    } else {
      const int h = static_cast<int>(i - bsn - bsh);
      for (int which = 0; which < 2; ++which) {
        float sum = 0.f;
        for (int b = 0; b < batch; ++b) {
          for (int gr = 0; gr < groups; ++gr) {
            sum += part_h[(((long long)which * batch + b) * heads + h) *
                              groups + gr];
          }
        }
        (which == 0 ? ga_log : gd)[h] = sum;
      }
    }
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<unsigned long long>(ptr) % 16 == 0;
}

}  // namespace

cudaError_t ssd_scan_forward_launch(
    const float* xs, const float* bmat, const float* cmat, const float* dt,
    const float* a_log, const float* d_skip, float* y, float* s_fin,
    float* s_chunks, float* s_loc, float* log_decay, float* s_in, int batch,
    int seq, int heads, int p, int n, int segment, cudaStream_t stream) {
  const int n_chunks = (seq + kC - 1) / kC;
  const int segs = (n_chunks + segment - 1) / segment;
  const int groups = (p + kSsdRows - 1) / kSsdRows;
  const bool vec = p % 4 == 0 && n % 4 == 0 && aligned16(xs) &&
                   aligned16(bmat) && aligned16(cmat);
  cudaError_t err;
  if (segs > 1) {
    const auto pass1 =
        vec ? ssd_segment_state_kernel<true> : ssd_segment_state_kernel<false>;
    // more than the 48 KB of static shared memory, on the current device
    err = cudaFuncSetAttribute(pass1,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(FwdSmem)));
    if (err != cudaSuccess) return err;
    pass1<<<dim3(groups * (segs - 1), heads, batch), kThreads,
            sizeof(FwdSmem), stream>>>(xs, bmat, cmat, dt, a_log, d_skip,
                                       s_in, y, s_fin, s_chunks, s_loc,
                                       log_decay, seq, heads, p, n, segment,
                                       segs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int elems = p * n;
    ssd_segment_carry_kernel<<<dim3(batch * heads, (elems + 255) / 256), 256,
                               0, stream>>>(s_loc, log_decay, s_in, elems,
                                            segs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const auto pass2 =
      vec ? ssd_scan_forward_kernel<true> : ssd_scan_forward_kernel<false>;
  err = cudaFuncSetAttribute(pass2,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(FwdSmem)));
  if (err != cudaSuccess) return err;
  pass2<<<dim3(groups * segs, heads, batch), kThreads, sizeof(FwdSmem),
          stream>>>(xs, bmat, cmat, dt, a_log, d_skip, s_in, y, s_fin,
                    s_chunks, s_loc, log_decay, seq, heads, p, n, segment,
                    segs);
  return cudaGetLastError();
}

cudaError_t ssd_scan_backward_launch(
    const float* xs, const float* bmat, const float* cmat, const float* dt,
    const float* a_log, const float* d_skip, const float* s_chunks,
    const float* gy, const float* gs, float* gx, float* gb, float* gc,
    float* gdt, float* ga_log, float* gd, float* part_b, float* part_c,
    float* part_dt, float* part_h, int batch, int seq, int heads, int p,
    int n, cudaStream_t stream) {
  const int groups = (p + kSsdRows - 1) / kSsdRows;
  const bool vec = p % 4 == 0 && n % 4 == 0 && aligned16(xs) &&
                   aligned16(gy) && aligned16(bmat) && aligned16(cmat) &&
                   aligned16(s_chunks);
  const auto scan =
      vec ? ssd_scan_backward_kernel<true> : ssd_scan_backward_kernel<false>;
  // more than the 48 KB of static shared memory, on the current device
  cudaError_t err = cudaFuncSetAttribute(
      scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(BwdSmem)));
  if (err != cudaSuccess) return err;
  scan<<<dim3(groups, heads, batch), kThreads, sizeof(BwdSmem), stream>>>(
      xs, bmat, cmat, dt, a_log, d_skip, s_chunks, gy, gs, gx, part_b,
      part_c, groups > 1 ? part_dt : gdt, part_h, batch, seq, heads, p, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total =
      (long long)batch * seq * (n + (groups > 1 ? heads : 0)) + heads;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  ssd_scan_reduce_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096),
                           threads, 0, stream>>>(
      part_b, part_c, part_dt, part_h, gb, gc, gdt, ga_log, gd, batch, seq,
      heads, groups, n);
  return cudaGetLastError();
}
