// The chunked RWKV-6 WKV scan's backward for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this gradient to XLA
// (jax.grad through the lax.scan of repro/models/rwkv.py:_wkv_chunked).
// The forward is wkv6.cu; kernels/wkv6/ref.py:chunked_wkv6_backward_
// reference is the same math in plain PyTorch. Per bh, over the chunks in
// reverse, with dS the gradient of the state leaving the chunk (the final
// state's cotangent gs after the last), S_c the state entering it (kept
// by the forward) and dy the chunk's rows of y's cotangent:
//
//   d r_dec = dy S_c^T              d k_tail = v dS^T
//   dv      = k_tail dS + mask(A)^T dy + bonus * dy
//   d decay = rowsum(dS * S_c)      dS <- r_dec^T dy + diag(decay) dS
//   dA      = mask(dy v^T)          d r_hat = dA k_hat, d k_hat = dA^T r_hat
//   dr      = d r_hat e1 + d r_dec exp(cum_prev) + d bonus u k   (dk alike)
//   du      = the bh's sum of d bonus r k,   d bonus = rowsum(dy * v)
//
// then back through the exponents: the +-25 clip passes zero gradient
// outside its range; last = cum[L-1] reaches cref (half of it), k_tail and
// the decay; cum and cum_prev become d log w by suffix sums along the
// chunk; dw = d log w / w where w >= 1e-38, else 0.
//
// Numerics: a chunk's factors (log w and its cumsum, r_hat, k_hat, r_dec,
// k_tail, the decay, the bonus) are recomputed with the forward's own
// instructions (wkv6_device.cuh) from the same mid-chunk reference, so
// the clip's exp(+-25) factors lose no digit the forward keeps. The
// products run on tensor cores in 3xTF32 (kernels/csrc/mma_tf32.cuh),
// f32 accuracy in a fixed order; d r_hat and d k_hat (16-long sums) as
// f32 FMA. Compiled, like wkv6.cu, without fast math and without -ftz:
// 1e-38 is subnormal.
//
// Bound: 4 (9 BH S N + 2 BH N + BH N^2 + BH (S/L) N^2) bytes (r, k, v, w
// and gy read and dr, dk, dv and dw written once; u and du; gs; the kept
// chunk states) against, a (bh, chunk), 8 L N^2 + 6 L^2 N operations on
// the tensor cores (the carry's four [L, N] x [N, N] products; A, dA and
// A^T dy), each in three TF32 passes (495 TFLOP/s), and 4 L^2 N on the
// f32 units (d r_hat, d k_hat). At [512, 512, 64], rwkv6-7b's mixer at
// batch 8 x 512: 881,065,984 B, 0.263 ms at 3.35 TB/s, against 10.2
// GFLOP, 0.062 ms in three TF32 passes, and 1.07 GFLOP, 0.016 ms of f32:
// the bytes bound it.
//
// Design:
// - One block of 256 threads (8 warps) per bh walks its chunks in
//   reverse. dS lives in the warps' mma accumulator registers, a 16 x 32
//   tile a warp (rows 16 (w % 4), columns 32 (w / 4)), as the forward
//   holds S; it is copied to shared memory once a chunk, for the two
//   products that read it as an operand (d k_tail, k_tail dS).
// - The four [L, N] x [N, N] products and A, dA and A^T dy run on tensor
//   cores in 3xTF32, m16n8k8 mma.sync: d r_dec and d k_tail a warp per 8
//   of their N columns; k_tail dS + A^T dy (dv) a warp per 8 columns of
//   v; dS <- r_dec^T dy + diag(decay) dS into each warp's accumulators;
//   A and dA on four warps, an 8-column half each. d decay = rowsum(dS *
//   S_c) from the accumulators and S_c at the same positions, summed over
//   the 4 lanes of a row and the 2 column halves.
// - A chunk in three phases between two barriers: (1) a thread per (step,
//   4 channels) recomputes the factors into shared tiles and copies dS
//   out; (2) the products; (3) dv is written, then the (step, channels)
//   threads of (1) form d r_hat and d k_hat and go back through the
//   exponents (16-lane shuffle sums along the chunk) to write dr, dk and
//   dw. The tiles phase (3) reads (r_hat, k_hat, y's cotangent) are
//   double buffered, so (1) of the next chunk needs no barrier after (3).
// - Pipelined loads with cp.async: chunk c-1's r, k, w (into each
//   thread's own slots) and y's cotangent (into the other buffer) are
//   copied while chunk c's products run, its v and its 16 KB kept state
//   S_c while chunk c's phase (3) runs; phase (1) waits for them.
// - du is the block's own: each thread sums its steps' share over the
//   chunks in registers, reduced across lanes once at the end. No float
//   atomics: two runs give the same bits.
// - BH below the SM count leaves SMs idle (a block a bh, its chunks in
//   series); sequence segments are later work (ROADMAP queue 2).
#include "wkv6_backward.h"

#include "mma_tf32.cuh"
#include "wkv6.h"
#include "wkv6_device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kN = kWkv6MaxN;
constexpr int kL = kWkv6MaxChunk;
constexpr int kS = kN + 8;       // tiles read as mma fragments: a row pair
                                 // (2c, 2c+1) or a column, no bank twice
constexpr int kSA = kN + 4;      // k_tail, read as scalar A fragments
constexpr int kSAmat = kL + 8;   // A, read down its columns
constexpr int kSDa = kL + 4;     // dA, read as float4 rows

static_assert(kThreads == kL * (kN / 4), "a (step, 4 channels) a thread");
static_assert(kThreads / 32 == kN / 8, "a warp per 8 columns");
static_assert(kL == 16, "a chunk is one m16 tile of steps");

struct BwdSmem {
  float rhat[2][kL][kS];      // r * e1, by chunk parity
  float khat[2][kL][kS];      // k * e2
  float dy[2][kL][kS];        // the chunk's rows of y's cotangent (copied)
  float vv[kL][kS];           // v (copied)
  float rdec[kL][kS];         // r * exp(cum_prev)
  float ktail[kL][kSA];       // k * exp(last - cum)
  float sc[kN][kS];           // the state entering the chunk (copied)
  float ds[kN][kS];           // the gradient of the state leaving it
  float d_rdec[kL][kS];
  float d_ktail[kL][kS];
  float amat[kL][kSAmat];     // A, strictly causal
  float damat[kL][kSDa];      // dA, strictly causal
  float stage[3][kThreads * 4];  // r, k, w: each thread's own 4 channels
  float bon[kN / 4][kL];      // bonus partials, as the forward sums them
  float dbon[kN / 4][kL];     // d bonus partials
  float bonus[kL];
  float dbonus[kL];
  float dec[kN];              // exp(last)
  float ddec[2][kN];          // d decay over each half of the columns
};

__device__ __forceinline__ float4 row4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <bool kVec>
__device__ __forceinline__ void st4(float* __restrict__ p, long long off,
                                    int j0, int n, bool valid,
                                    const float4& x) {
  if (!valid) return;
  if constexpr (kVec) {
    if (j0 < n) *reinterpret_cast<float4*>(p + off + j0) = x;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (j0 + i < n) p[off + j0 + i] = get(x, i);
  }
}

// The sum over a chunk's 16 step lanes; every lane gets it.
__device__ __forceinline__ float chunk_sum(float x) {
#pragma unroll
  for (int off = kL / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off, kL);
  return x;
}

// Lane lt gets the sum over the step lanes t >= lt.
__device__ __forceinline__ float suffix_sum(float x, int lt) {
#pragma unroll
  for (int off = 1; off < kL; off <<= 1) {
    const float y = __shfl_down_sync(kFull, x, off, kL);
    if (lt + off < kL) x += y;
  }
  return x;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_backward_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u,
                     const float* __restrict__ s_chunks,
                     const float* __restrict__ gy,
                     const float* __restrict__ gs, float* __restrict__ dr,
                     float* __restrict__ dk, float* __restrict__ dv,
                     float* __restrict__ dw, float* __restrict__ du, int seq,
                     int n, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);

  const int tid = threadIdx.x, bh = blockIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, cq = lane % 4;            // mma fragment role
  const int lt = tid % kL, j0 = 4 * (tid / kL);     // (step, 4 channels)
  const int qr = 16 * (warp % 4), mc = 32 * (warp / 4);  // the dS tile
  const int n_chunks = seq / chunk;
  const long long base = static_cast<long long>(bh) * seq * n;
  const long long nn = static_cast<long long>(n) * n;
  const float4 uu = load4(u, static_cast<long long>(bh) * n, j0, n, true);

  // chunk c's (step lt, channels j0..j0+3) of a [bh, seq, n] tensor into
  // dst; zeros off the chunk and past n
  auto copy4 = [&](float* dst, const float* src, int c) {
    const bool valid = lt < chunk;
    const long long off = base + static_cast<long long>(c * chunk + lt) * n
                          + j0;
    if (kVec) {
      const bool ok = valid && j0 < n;
      cp_async16(dst, ok ? src + off : src, ok);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = valid && j0 + i < n;
        cp_async4(dst + i, ok ? src + off + i : src, ok);
      }
    }
  };
  // chunk c's r, k, w (the thread's own slots) and y's cotangent
  auto copy_front = [&](int c, int buf) {
    copy4(&sm.stage[0][4 * tid], r, c);
    copy4(&sm.stage[1][4 * tid], k, c);
    copy4(&sm.stage[2][4 * tid], w, c);
    copy4(&sm.dy[buf][lt][j0], gy, c);
    cp_async_commit();
  };
  // chunk c's v and the state entering it
  auto copy_back = [&](int c) {
    copy4(&sm.vv[lt][j0], v, c);
    const float* s_c = s_chunks + (static_cast<long long>(bh) * n_chunks + c)
                                      * nn;
    if (kVec) {
      for (int e = tid; e < kN * kN / 4; e += kThreads) {
        const int q = e / (kN / 4), m = 4 * (e % (kN / 4));
        const bool ok = q < n && m < n;
        cp_async16(&sm.sc[q][m], ok ? s_c + q * n + m : s_c, ok);
      }
    } else {
      for (int e = tid; e < kN * kN; e += kThreads) {
        const int q = e / kN, m = e % kN;
        const bool ok = q < n && m < n;
        cp_async4(&sm.sc[q][m], ok ? s_c + q * n + m : s_c, ok);
      }
    }
    cp_async_commit();
  };

  // dS at the warp's tile: rows qr + g (+ 8), columns mc + 8 i + 2 cq (+ 1)
  float ds[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = qr + g + (e >= 2 ? 8 : 0);
      const int m = mc + 8 * i + 2 * cq + (e & 1);
      ds[i][e] = (q < n && m < n) ? gs[bh * nn + q * n + m] : 0.0f;
    }
  float du_acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  if (n_chunks > 0) {
    copy_front(n_chunks - 1, (n_chunks - 1) & 1);
    copy_back(n_chunks - 1);
  }
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int b = c & 1;
    const bool valid = lt < chunk;
    const long long row = base + static_cast<long long>(c * chunk + lt) * n;

    // (1) the chunk's factors, with the forward's instructions
    cp_async_wait_all_but_one();  // r, k, w and y's cotangent of chunk c
    const float4 rc = row4(&sm.stage[0][4 * tid]),
                 kc = row4(&sm.stage[1][4 * tid]),
                 wc = row4(&sm.stage[2][4 * tid]);
    const Decays d = decays(wc, lt, j0, n, chunk);
    float e1[4], e2[4], ecp[4], etl[4];
    unsigned inside = 0;  // bit i: x1 inside the clip, bit 4 + i: x2
    float4 rh, kh, kt, rd;
    float bsum = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float cu = d.cum[i], cp = cu - d.lw[i], last = d.last[i];
      const float cref = 0.5f * last;
      const float x1 = cp - cref, x2 = cref - cu;
      const float ri = get(rc, i), ki = get(kc, i);
      e1[i] = expf(clip(x1));
      e2[i] = expf(clip(x2));
      ecp[i] = expf(cp);
      etl[i] = expf(last - cu);
      inside |= (fabsf(x1) <= kClamp ? 1u : 0u) << i;
      inside |= (fabsf(x2) <= kClamp ? 1u : 0u) << (4 + i);
      set(rh, i, ri * e1[i]);
      set(kh, i, ki * e2[i]);
      set(kt, i, ki * etl[i]);
      set(rd, i, ri * ecp[i]);
      bsum += ri * get(uu, i) * ki;
    }
    *reinterpret_cast<float4*>(&sm.rhat[b][lt][j0]) = rh;
    *reinterpret_cast<float4*>(&sm.khat[b][lt][j0]) = kh;
    *reinterpret_cast<float4*>(&sm.ktail[lt][j0]) = kt;
    *reinterpret_cast<float4*>(&sm.rdec[lt][j0]) = rd;
    sm.bon[j0 / 4][lt] = bsum;
    if (lt < 4) sm.dec[j0 + lt] = expf(pick(d.last, lt));
    // dS, the gradient of the state leaving the chunk, for (2)'s operands
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = mc + 8 * i + 2 * cq;
      *reinterpret_cast<float2*>(&sm.ds[qr + g][m]) =
          make_float2(ds[i][0], ds[i][1]);
      *reinterpret_cast<float2*>(&sm.ds[qr + g + 8][m]) =
          make_float2(ds[i][2], ds[i][3]);
    }
    cp_async_wait<0>();  // v and S_c of chunk c
    {
      const float4 vc = row4(&sm.vv[lt][j0]), gc = row4(&sm.dy[b][lt][j0]);
      float db = gc.x * vc.x;
      db = fmaf(gc.y, vc.y, db);
      db = fmaf(gc.z, vc.z, db);
      db = fmaf(gc.w, vc.w, db);
      sm.dbon[j0 / 4][lt] = db;
    }
    __syncthreads();

    // (2) the products; chunk c-1's r, k, w and y's cotangent meanwhile
    if (c > 0) copy_front(c - 1, b ^ 1);
    // A = r_hat k_hat^T (warps 0, 1) and dA = dy v^T (warps 2, 3), one
    // 8-column half a warp, strictly causal; the bonus and its gradient
    // (warp 4)
    if (warp < 4) {
      const float(*ta)[kS] = warp < 2 ? sm.rhat[b] : sm.dy[b];
      const float(*tb)[kS] = warp < 2 ? sm.khat[b] : sm.vv;
      const int jt = warp & 1;
      float acc[2][4] = {}, small[2][4] = {};
#pragma unroll
      for (int i = 0; i < kN / 8; ++i) {
        const int col = 8 * i + 2 * cq;
        const float2 a0 = ld2(&ta[g][col]), a1 = ld2(&ta[g + 8][col]);
        const float2 bj = ld2(&tb[8 * jt + g][col]);
        const float a[4] = {a0.x, a1.x, a0.y, a1.y};
        const float bb[2] = {bj.x, bj.y};
        mma3(acc[i & 1], small[i & 1], a, bb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = g + (e >= 2 ? 8 : 0), j = 8 * jt + 2 * cq + (e & 1);
        const float val =
            j < t ? (acc[0][e] + acc[1][e]) + (small[0][e] + small[1][e])
                  : 0.0f;
        if (warp < 2) {
          sm.amat[t][j] = val;
        } else {
          sm.damat[t][j] = val;
        }
      }
    } else if (warp == 4) {
      const int t = lane % kL;
      const float(*part)[kL] = lane < kL ? sm.bon : sm.dbon;
      float acc = 0.0f;
#pragma unroll
      for (int gi = 0; gi < kN / 4; ++gi) acc += part[gi][t];
      if (lane < kL) {
        sm.bonus[t] = acc;
      } else {
        sm.dbonus[t] = acc;
      }
    }
    // d r_dec = dy S_c^T and d k_tail = v dS^T, the warp's 8 columns q
    {
      const int q0 = 8 * warp;
      float ar[4] = {}, ars[4] = {}, ak[4] = {}, aks[4] = {};
#pragma unroll
      for (int i = 0; i < kN / 8; ++i) {
        const int col = 8 * i + 2 * cq;
        const float2 g0 = ld2(&sm.dy[b][g][col]),
                     g1 = ld2(&sm.dy[b][g + 8][col]);
        const float2 v0 = ld2(&sm.vv[g][col]), v1 = ld2(&sm.vv[g + 8][col]);
        const float2 sq = ld2(&sm.sc[q0 + g][col]),
                     dq = ld2(&sm.ds[q0 + g][col]);
        const float ag[4] = {g0.x, g1.x, g0.y, g1.y};
        const float av[4] = {v0.x, v1.x, v0.y, v1.y};
        const float bs[2] = {sq.x, sq.y};
        const float bd[2] = {dq.x, dq.y};
        mma3(ar, ars, ag, bs);
        mma3(ak, aks, av, bd);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = g + (e >= 2 ? 8 : 0), q = q0 + 2 * cq + (e & 1);
        sm.d_rdec[t][q] = ar[e] + ars[e];
        sm.d_ktail[t][q] = ak[e] + aks[e];
      }
    }
    // d decay = rowsum(dS * S_c): the warp's 32 columns, over its 4 lanes
    // of a row, then the two halves in (3)
    {
      float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = mc + 8 * i + 2 * cq;
        const float2 s0 = ld2(&sm.sc[qr + g][m]),
                     s1 = ld2(&sm.sc[qr + g + 8][m]);
        r0 = fmaf(ds[i][0], s0.x, r0);
        r0 = fmaf(ds[i][1], s0.y, r0);
        r1 = fmaf(ds[i][2], s1.x, r1);
        r1 = fmaf(ds[i][3], s1.y, r1);
      }
      r0 += __shfl_xor_sync(kFull, r0, 1);
      r0 += __shfl_xor_sync(kFull, r0, 2);
      r1 += __shfl_xor_sync(kFull, r1, 1);
      r1 += __shfl_xor_sync(kFull, r1, 2);
      if (cq == 0) {
        sm.ddec[warp / 4][qr + g] = r0;
        sm.ddec[warp / 4][qr + g + 8] = r1;
      }
    }
    // k_tail dS, dv's first term, the warp's 8 columns m (finished in (3))
    float dvp[4] = {}, dvps[4] = {};
    {
      const int m0 = 8 * warp;
#pragma unroll
      for (int kk = 0; kk < kN / 8; ++kk) {
        const int p0 = 8 * kk;
        const float a[4] = {sm.ktail[g][p0 + cq], sm.ktail[g + 8][p0 + cq],
                            sm.ktail[g][p0 + cq + 4],
                            sm.ktail[g + 8][p0 + cq + 4]};
        const float bb[2] = {sm.ds[p0 + cq][m0 + g],
                             sm.ds[p0 + cq + 4][m0 + g]};
        mma3(dvp, dvps, a, bb);
      }
    }
    // dS <- diag(decay) dS + r_dec^T dy, in the accumulators
    {
      const float d0 = sm.dec[qr + g], d1 = sm.dec[qr + g + 8];
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int t0 = 8 * kk;
        const float a[4] = {sm.rdec[t0 + cq][qr + g],
                            sm.rdec[t0 + cq][qr + g + 8],
                            sm.rdec[t0 + cq + 4][qr + g],
                            sm.rdec[t0 + cq + 4][qr + g + 8]};
#pragma unroll
        for (int e = 0; e < 4; ++e) split(a[e], ah[kk][e], al[kk][e]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float small[4] = {};
        ds[i][0] *= d0;
        ds[i][1] *= d0;
        ds[i][2] *= d1;
        ds[i][3] *= d1;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int m = mc + 8 * i + g;
          const float bb[2] = {sm.dy[b][8 * kk + cq][m],
                               sm.dy[b][8 * kk + cq + 4][m]};
          mma3_split_a(ds[i], small, ah[kk], al[kk], bb);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[i][e] += small[e];
      }
    }
    __syncthreads();

    // (3) chunk c-1's v and S_c copied meanwhile (their tiles' readers are
    // all in (2) above)
    if (c > 0) copy_back(c - 1);
    // dv = k_tail dS + A^T dy + bonus * dy, the warp's 8 columns m
    {
      const int m0 = 8 * warp;
      float small[4] = {};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int j1 = 8 * kk + cq;
        const float a[4] = {sm.amat[j1][g], sm.amat[j1][g + 8],
                            sm.amat[j1 + 4][g], sm.amat[j1 + 4][g + 8]};
        const float bb[2] = {sm.dy[b][j1][m0 + g], sm.dy[b][j1 + 4][m0 + g]};
        mma3(dvp, small, a, bb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = g + (e >= 2 ? 8 : 0), m = m0 + 2 * cq + (e & 1);
        const float val = (dvp[e] + (dvps[e] + small[e])) +
                          sm.bonus[t] * sm.dy[b][t][m];
        if (t < chunk && m < n)
          dv[base + static_cast<long long>(c * chunk + t) * n + m] = val;
      }
    }
    // back through the exponents, a (step, 4 channels) a thread
    {
      float drh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float dkh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int jb = 0; jb < kL; jb += 4) {
        const float4 da4 = row4(&sm.damat[lt][jb]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = jb + jj;
          const float da_r = get(da4, jj), da_c = sm.damat[j][lt];
          const float4 kh4 = row4(&sm.khat[b][j][j0]),
                       rh4 = row4(&sm.rhat[b][j][j0]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            drh[i] = fmaf(da_r, get(kh4, i), drh[i]);
            dkh[i] = fmaf(da_c, get(rh4, i), dkh[i]);
          }
        }
      }
      const float4 drd = row4(&sm.d_rdec[lt][j0]),
                   dkt = row4(&sm.d_ktail[lt][j0]);
      const float db = sm.dbonus[lt];
      float4 o_r, o_k, o_w;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ri = get(rc, i), ki = get(kc, i), ui = get(uu, i);
        const float g_rh = drh[i], g_kh = dkh[i];
        const float g_rd = get(drd, i), g_kt = get(dkt, i);
        set(o_r, i, g_rh * e1[i] + g_rd * ecp[i] + db * ui * ki);
        set(o_k, i, g_kh * e2[i] + g_kt * etl[i] + db * ui * ri);
        du_acc[i] += db * ri * ki;
        const float dx1 = (inside >> i) & 1u ? g_rh * (ri * e1[i]) : 0.0f;
        const float dx2 =
            (inside >> (4 + i)) & 1u ? g_kh * (ki * e2[i]) : 0.0f;
        const float dtail = g_kt * (ki * etl[i]);
        const float dcp = dx1 + g_rd * (ri * ecp[i]);
        const float dcum = -dx2 - dtail;
        const float ddec = sm.ddec[0][j0 + i] + sm.ddec[1][j0 + i];
        const float dlast = chunk_sum(0.5f * (dx2 - dx1) + dtail) +
                            ddec * expf(d.last[i]);
        const float suf = suffix_sum(dcum, lt);
        float suf_prev = __shfl_down_sync(kFull, suffix_sum(dcp, lt), 1, kL);
        if (lt == kL - 1) suf_prev = 0.0f;
        const float dlogw = suf + suf_prev + dlast;
        const float wi = get(wc, i);
        set(o_w, i, wi >= 1e-38f ? dlogw / wi : 0.0f);
      }
      st4<kVec>(dr, row, j0, n, valid, o_r);
      st4<kVec>(dk, row, j0, n, valid, o_k);
      st4<kVec>(dw, row, j0, n, valid, o_w);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float s = chunk_sum(du_acc[i]);
    if (lt == 0 && j0 + i < n) du[static_cast<long long>(bh) * n + j0 + i] = s;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <bool kVec>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s_chunks,
                   const float* gy, const float* gs, float* dr, float* dk,
                   float* dv, float* dw, float* du, int bh, int seq, int n,
                   int chunk, cudaStream_t stream) {
  // more than the 48 KB of static shared memory, on the current device
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_backward_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(BwdSmem)));
  if (err != cudaSuccess) return err;
  wkv6_backward_kernel<kVec><<<bh, kThreads, sizeof(BwdSmem), stream>>>(
      r, k, v, w, u, s_chunks, gy, gs, dr, dk, dv, dw, du, seq, n, chunk);
  return cudaGetLastError();
}

}  // namespace

cudaError_t wkv6_backward_launch(const float* r, const float* k,
                                 const float* v, const float* w,
                                 const float* u, const float* s_chunks,
                                 const float* gy, const float* gs, float* dr,
                                 float* dk, float* dv, float* dw, float* du,
                                 int bh, int seq, int n, int chunk,
                                 cudaStream_t stream) {
  if (bh == 0) return cudaSuccess;
  const bool vec = n % 4 == 0 && aligned16(r) && aligned16(k) &&
                   aligned16(v) && aligned16(w) && aligned16(gy) &&
                   aligned16(s_chunks) && aligned16(dr) && aligned16(dk) &&
                   aligned16(dw);
  if (vec)
    return launch<true>(r, k, v, w, u, s_chunks, gy, gs, dr, dk, dv, dw, du,
                        bh, seq, n, chunk, stream);
  return launch<false>(r, k, v, w, u, s_chunks, gy, gs, dr, dk, dv, dw, du,
                       bh, seq, n, chunk, stream);
}
