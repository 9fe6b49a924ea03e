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
// Backward (kernels/ssd/ref.py: ssd_scan_backward_reference is the same
// math in plain PyTorch): with G_t the cotangent of s_t,
//   G_t = gy_t c_t^T + a_{t+1} G_{t+1}     (G_{S-1} adds the final state's)
//   g_x = D gy + dt G b,  g_b = dt G^T x,  g_c = s_t^T gy,
//   g_a = <G_t, s_{t-1}>, g_dt = x^T G b - g_a A a_t,
//   g_A_log = -sum g_a dt A a_t,  g_D = sum gy . x.
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
// Backward: 11 FLOP an element a token for the gradient (G's update,
// G^T x, s^T gy, <G, s_{t-1}>, G b; the states' recompute, 4 more, is not
// counted) against x, b, c, dt, gy, the kept states and the final
// state's cotangent read and the six gradients written. A token's G
// depends on the next one's: the chain of dependent instructions a
// token, not the bytes or the FLOPs, sets its time.
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
// - A block of 4 warps per (b, h, tile of 16 state rows); each warp holds
//   4 rows, each lane the columns n = lane and lane + 32, so the state
//   lives in registers (8 floats a thread) and g_x's sum over N is a warp
//   reduction: the 4 rows in 6 shuffles (reduce4).
// - Reverse over chunks. A chunk's states are recomputed from its kept
//   state (never rebuilt by dividing by a_t, which underflows to 0 for
//   large dt A) into shared memory, then the G recurrence runs backward
//   over the chunk. Sums across the warps of a block go through shared
//   memory in a fixed order; sums across blocks (g_b, g_c over heads and
//   tiles, g_dt over tiles, g_A_log and g_D over everything) go to
//   per-block partial buffers that a second kernel adds in a fixed
//   order. No float atomics: two runs give the same bits.
// - Numerics: the recomputed states are rounded as the token loop
//   (ref.py: ssd_scan_reference) rounds them (x b, then dt (x b), then
//   a s, then the sum; __fmul_rn / __fadd_rn keep nvcc from contracting
//   them into an FMA). expf is the accurate one; no fast-math flag.
#include "mma_tf32.cuh"
#include "ssd_scan.h"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kSsdPTile / kWarps;  // state rows a warp holds, bwd
constexpr int kElems = 2 * kRows;          // state elements a thread holds
constexpr int kC = kSsdChunk;
constexpr int kN = kSsdMaxN;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kRows == 4, "reduce4 sums 4 rows a warp");
static_assert(kN == 64, "a lane holds the columns lane and lane + 32");
static_assert(kC == 16, "a chunk is one m16 tile of tokens");

// The state's update, rounded as the token loop rounds it.
__device__ __forceinline__ float step(float a, float s, float dt, float x,
                                      float b) {
  return __fadd_rn(__fmul_rn(a, s), __fmul_rn(dt, __fmul_rn(x, b)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// v[r] summed over the warp's 32 lanes for r = 0..3; lane L gets the sum
// of row (L >> 3) & 3. The first two steps halve the values each lane
// carries (it keeps half and sends the partner the other half).
__device__ __forceinline__ float reduce4(const float (&v)[4], int lane) {
  const bool hi16 = lane & 16;
  float keep0 = hi16 ? v[2] : v[0];
  float keep1 = hi16 ? v[3] : v[1];
  keep0 += __shfl_xor_sync(kFull, hi16 ? v[0] : v[2], 16);
  keep1 += __shfl_xor_sync(kFull, hi16 ? v[1] : v[3], 16);
  const bool hi8 = lane & 8;
  float u = hi8 ? keep1 : keep0;
  u += __shfl_xor_sync(kFull, hi8 ? keep0 : keep1, 8);
  u += __shfl_xor_sync(kFull, u, 4);
  u += __shfl_xor_sync(kFull, u, 2);
  u += __shfl_xor_sync(kFull, u, 1);
  return u;
}

// The thread's state elements from a [p, n] state at `base`: rows p0 +
// warp * kRows + r, columns lane and lane + 32; outside [p, n] they read
// as 0.
__device__ __forceinline__ void load_state(float (&s)[kRows][2],
                                           const float* base, int p0,
                                           int warp, int lane, int p, int n) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = p0 + warp * kRows + r;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = lane + 32 * j;
      s[r][j] = row < p && col < n ? base[(long long)row * n + col] : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// forward: the chunk form on tensor cores
// ---------------------------------------------------------------------------

constexpr int kFwdRows = kWarps * kSsdPTile;  // state rows a block holds
constexpr int kRing = 4;                      // stages of the copy ring
constexpr int kStride = kN + 8;  // staged rows: = 8 (mod 32) floats, so the
                                 // fragment loads hit no bank twice
constexpr int kCbStride = kC + 4;

static_assert(kFwdRows == kN, "a stage's x rows are as wide as b's");

struct FwdStage {
  float x[kC][kStride];  // x_t of the block's kFwdRows state rows
  float b[kC][kStride];
  float c[kC][kStride];
  float dt[kC];
};

struct FwdSmem {
  FwdStage stage[kRing];
  float cb[2][2][kC][kCbStride];  // C B^T: [chunk parity][half of N][t][j]
};

// A warp's 16 rows of the state: rows r0 + g (+ 8), columns 8 i + 2 q
// (+ 1) of n-tile i (g = lane / 4, q = lane % 4), as m16n8 accumulators.
struct FwdState {
  float s[kN / 8][4];
};

__device__ __forceinline__ void store_rows(const FwdState& st, float* base,
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

__device__ __forceinline__ void load_rows(FwdState& st, const float* base,
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
  const int row0 = group * kFwdRows;  // the block's first state row
  const int wr = warp * kSsdPTile;    // the warp's first row in a stage
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

  // the warp's quarter of chunk k's C B^T: columns j = 8 (warp & 1) .. +7
  // summed over half (warp >> 1) of N, into cb[(k - c0) & 1][warp >> 1]
  auto cb_quarter = [&](int k) {
    const FwdStage& sg = sm.stage[(k - c0) % kRing];
    const int jt = warp & 1, half = warp >> 1;
    float acc[2][4] = {}, small[2][4] = {};
#pragma unroll
    for (int i = 0; i < kN / 16; ++i) {
      const int col = 8 * (i + half * kN / 16) + 2 * q;
      const float2 c0v = ld2(&sg.c[g][col]), c1v = ld2(&sg.c[g + 8][col]);
      const float2 bj = ld2(&sg.b[8 * jt + g][col]);
      const float a[4] = {c0v.x, c1v.x, c0v.y, c1v.y};
      const float bb[2] = {bj.x, bj.y};
      mma3(acc[i & 1], small[i & 1], a, bb);
    }
    float(*out)[kCbStride] = sm.cb[(k - c0) & 1][half];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[g + (e >= 2 ? 8 : 0)][8 * jt + 2 * q + (e & 1)] =
          (acc[0][e] + acc[1][e]) + (small[0][e] + small[1][e]);
  };

  FwdState st = {};
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
// backward: the token recurrence in reverse, a chunk at a time
// ---------------------------------------------------------------------------

struct BwdSmem {
  float b[kC][kN], c[kC][kN];
  float x[kC][kSsdPTile], gy[kC][kSsdPTile], gx[kC][kSsdPTile];
  float dt[kC], a[kC];
  float ga[kWarps][kC];               // <G, s_{t-1}> over a warp's rows
  float col_g[kWarps][kC][kN];        // G^T x over a warp's rows
  float col_s[kWarps][kC][kN];        // s^T gy over a warp's rows
  float red[2][kThreads];             // the block's last sums
};
// + the recomputed states, [kC][kElems][kThreads] floats, after it
constexpr int kHistFloats = kC * kElems * kThreads;
constexpr size_t kBwdSmemBytes = sizeof(BwdSmem) + kHistFloats * sizeof(float);

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
  float* hist = reinterpret_cast<float*>(&sm + 1);
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tiles = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = tile * kSsdPTile;
  const long long bh = (long long)b * heads + h;
  const long long state = (long long)p * n;
  const int n_chunks = (seq + kC - 1) / kC;
  const float big_a = expf(a_log[h]);
  const float dskip = d_skip[h];
  float g[kRows][2];
  load_state(g, gs + bh * state, p0, warp, lane, p, n);
  float a_next = 1.f;
  float acc_alog = 0.f, acc_d = 0.f;
  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * kC;
    const int len = min(kC, seq - t0);
    for (int i = tid; i < kC * kN; i += kThreads) {
      const int t = i / kN, j = i % kN;
      const bool ok = t < len && j < n;
      const long long at = ((long long)b * seq + t0 + t) * n + j;
      sm.b[t][j] = ok ? bmat[at] : 0.f;
      sm.c[t][j] = ok ? cmat[at] : 0.f;
    }
    for (int i = tid; i < kC * kSsdPTile; i += kThreads) {
      const int t = i / kSsdPTile, r = i % kSsdPTile;
      const bool ok = t < len && p0 + r < p;
      const long long at = (((long long)b * seq + t0 + t) * heads + h) * p +
                           p0 + r;
      sm.x[t][r] = ok ? xs[at] : 0.f;
      sm.gy[t][r] = ok ? gy[at] : 0.f;
    }
    if (tid < kC) {
      const float d =
          tid < len ? dt[((long long)b * seq + t0 + tid) * heads + h] : 0.f;
      sm.dt[tid] = d;
      sm.a[tid] = expf(-d * big_a);
    }
    __syncthreads();

    // the chunk's states, from the one kept at its start
    float s_in[kRows][2], s[kRows][2];
    load_state(s_in, s_chunks + (bh * n_chunks + k) * state, p0, warp, lane,
               p, n);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      s[r][0] = s_in[r][0];
      s[r][1] = s_in[r][1];
    }
    for (int t = 0; t < len; ++t) {
      const float a = sm.a[t], d = sm.dt[t];
      const float b0 = sm.b[t][lane], b1 = sm.b[t][lane + 32];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float x = sm.x[t][warp * kRows + r];
        s[r][0] = step(a, s[r][0], d, x, b0);
        s[r][1] = step(a, s[r][1], d, x, b1);
        hist[((t * kElems) + 2 * r) * kThreads + tid] = s[r][0];
        hist[((t * kElems) + 2 * r + 1) * kThreads + tid] = s[r][1];
      }
    }

    // G backward over the chunk
    for (int t = len - 1; t >= 0; --t) {
      const float d = sm.dt[t];
      const float b0 = sm.b[t][lane], b1 = sm.b[t][lane + 32];
      const float c0 = sm.c[t][lane], c1 = sm.c[t][lane + 32];
      float gxb0 = 0.f, gxb1 = 0.f, gsy0 = 0.f, gsy1 = 0.f, ga = 0.f;
      float rows[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float x = sm.x[t][warp * kRows + r];
        const float gyv = sm.gy[t][warp * kRows + r];
        g[r][0] = a_next * g[r][0] + gyv * c0;
        g[r][1] = a_next * g[r][1] + gyv * c1;
        const float st0 = hist[((t * kElems) + 2 * r) * kThreads + tid];
        const float st1 = hist[((t * kElems) + 2 * r + 1) * kThreads + tid];
        const float sp0 =
            t ? hist[(((t - 1) * kElems) + 2 * r) * kThreads + tid]
              : s_in[r][0];
        const float sp1 =
            t ? hist[(((t - 1) * kElems) + 2 * r + 1) * kThreads + tid]
              : s_in[r][1];
        gxb0 += g[r][0] * x;
        gxb1 += g[r][1] * x;
        gsy0 += st0 * gyv;
        gsy1 += st1 * gyv;
        ga += g[r][0] * sp0 + g[r][1] * sp1;
        rows[r] = g[r][0] * b0 + g[r][1] * b1;
      }
      sm.col_g[warp][t][lane] = gxb0;
      sm.col_g[warp][t][lane + 32] = gxb1;
      sm.col_s[warp][t][lane] = gsy0;
      sm.col_s[warp][t][lane + 32] = gsy1;
      const float sum = reduce4(rows, lane);
      if ((lane & 7) == 0) {
        const int r = warp * kRows + (lane >> 3);
        sm.gx[t][r] = dskip * sm.gy[t][r] + d * sum;
      }
      ga = warp_sum(ga);
      if (lane == 0) sm.ga[warp][t] = ga;
      a_next = sm.a[t];
    }
    __syncthreads();

    // the chunk's sums across the block's warps, in a fixed order
    for (int t = warp; t < len; t += kWarps) {
      const long long bst = ((long long)b * seq + t0 + t) * heads + h;
      const float d = sm.dt[t];
      float dotb = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = lane + 32 * j;
        float cg = 0.f, cs = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          cg += sm.col_g[w][t][col];
          cs += sm.col_s[w][t][col];
        }
        dotb += sm.b[t][col] * cg;
        if (col < n) {
          part_b[(bst * tiles + tile) * n + col] = d * cg;
          part_c[(bst * tiles + tile) * n + col] = cs;
        }
      }
      dotb = warp_sum(dotb);
      if (lane == 0) {
        float ga = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) ga += sm.ga[w][t];
        const float ga_a = ga * big_a * sm.a[t];
        part_dt[bst * tiles + tile] = dotb - ga_a;
        acc_alog += ga_a * d;
      }
    }
    for (int i = tid; i < len * kSsdPTile; i += kThreads) {
      const int t = i / kSsdPTile, r = i % kSsdPTile;
      if (p0 + r < p) {
        gx[(((long long)b * seq + t0 + t) * heads + h) * p + p0 + r] =
            sm.gx[t][r];
        acc_d += sm.gy[t][r] * sm.x[t][r];
      }
    }
    __syncthreads();
  }

  // the block's A_log and D sums, in a fixed order
  sm.red[0][tid] = acc_alog;
  sm.red[1][tid] = acc_d;
  __syncthreads();
  if (tid < 2) {
    float total = 0.f;
    for (int i = 0; i < kThreads; ++i) total += sm.red[tid][i];
    part_h[(((long long)tid * batch + b) * heads + h) * tiles + tile] =
        tid == 0 ? -total : total;
  }
}

// The sums across blocks: g_b and g_c over heads and tiles, g_dt over
// tiles, g_A_log and g_D over batch rows and tiles, each in a fixed order.
__global__ void ssd_scan_reduce_kernel(
    const float* __restrict__ part_b, const float* __restrict__ part_c,
    const float* __restrict__ part_dt, const float* __restrict__ part_h,
    float* __restrict__ gb, float* __restrict__ gc, float* __restrict__ gdt,
    float* __restrict__ ga_log, float* __restrict__ gd, int batch, int seq,
    int heads, int tiles, int n) {
  const long long bsn = (long long)batch * seq * n;
  const long long bsh = (long long)batch * seq * heads;
  const long long total = bsn + bsh + heads;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    if (i < bsn) {
      const long long bs = i / n;
      const int j = static_cast<int>(i % n);
      float sb = 0.f, sc = 0.f;
      for (int h = 0; h < heads; ++h) {
        for (int tl = 0; tl < tiles; ++tl) {
          const long long at = ((bs * heads + h) * tiles + tl) * n + j;
          sb += part_b[at];
          sc += part_c[at];
        }
      }
      gb[i] = sb;
      gc[i] = sc;
    } else if (i < bsn + bsh) {
      const long long bsh_i = i - bsn;
      float sum = 0.f;
      for (int tl = 0; tl < tiles; ++tl) sum += part_dt[bsh_i * tiles + tl];
      gdt[bsh_i] = sum;
    } else {
      const int h = static_cast<int>(i - bsn - bsh);
      for (int which = 0; which < 2; ++which) {
        float sum = 0.f;
        for (int b = 0; b < batch; ++b) {
          for (int tl = 0; tl < tiles; ++tl) {
            sum += part_h[(((long long)which * batch + b) * heads + h) *
                              tiles + tl];
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
  const int groups = (p + kFwdRows - 1) / kFwdRows;
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
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBwdSmemBytes));
  if (err != cudaSuccess) return err;
  const int tiles = (p + kSsdPTile - 1) / kSsdPTile;
  const dim3 grid(tiles, heads, batch);
  ssd_scan_backward_kernel<<<grid, kThreads, kBwdSmemBytes, stream>>>(
      xs, bmat, cmat, dt, a_log, d_skip, s_chunks, gy, gs, gx, part_b,
      part_c, part_dt, part_h, batch, seq, heads, p, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)batch * seq * (n + heads) + heads;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  ssd_scan_reduce_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096),
                           threads, 0, stream>>>(
      part_b, part_c, part_dt, part_h, gb, gc, gdt, ga_log, gd, batch, seq,
      heads, tiles, n);
  return cudaGetLastError();
}
