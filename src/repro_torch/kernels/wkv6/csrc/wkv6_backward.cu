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
// products run as f32 FMA on CUDA cores in a fixed order. Compiled, like
// wkv6.cu, without fast math and without -ftz: 1e-38 is subnormal.
//
// Bound: 4 (9 BH S N + 2 BH N + BH N^2 + BH (S/L) N^2) bytes (r, k, v, w
// and gy read and dr, dk, dv and dw written once; u and du; gs; the kept
// chunk states) against 8 L N^2 + 10 L^2 N floating-point operations a
// (bh, chunk) (the carry's four [L, N] x [N, N] products; A, dA, d r_hat,
// d k_hat and A^T dy). At [512, 512, 64], rwkv6-7b's mixer at batch
// 8 x 512: 881,065,984 B, 0.263 ms at 3.35 TB/s, against 11.3 GFLOP,
// 0.168 ms at 67 TFLOP/s: the bytes bound it.
//
// Design (simple and right first):
// - One block of 256 threads per bh walks its chunks in reverse, dS
//   [N, N] in shared memory. du is the block's own: each thread sums its
//   steps' share over the chunks in registers, reduced across lanes once
//   at the end. No float atomics: two runs give the same bits.
// - A chunk in four steps between three barriers: (a) a thread per (step,
//   4 channels) loads r, k, v, w and gy and recomputes the factors, the
//   block loads S_c; (b) A, dA, d bonus, d r_dec, d k_tail, d decay and
//   k_tail dS, a few outputs a thread, each a dot product over shared
//   memory; (c) dS's update, d r_hat, d k_hat and dv (written); (d) the
//   (step, channels) threads of (a) go back through the exponents (16-lane
//   shuffle sums along the chunk) and write dr, dk and dw. Step (a) of the
//   next chunk touches nothing (d) reads, so no barrier follows (d).
// - BH below the SM count leaves SMs idle (a block a bh, its chunks in
//   series); splitting the sequence, tensor cores and TMA are later work.
#include "wkv6_backward.h"

#include "wkv6.h"
#include "wkv6_device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kN = kWkv6MaxN;
constexpr int kL = kWkv6MaxChunk;
constexpr int kPadA = kN + 4;  // [step][channel] tiles: float4 rows
constexpr int kPadS = kN + 1;  // [N][N] tiles read down a column by the
                               // lanes: no bank conflict
constexpr int kPadT = kL + 4;  // r_dec transposed, [channel][step]
constexpr int kPadL = kL + 1;  // A and dA

static_assert(kThreads == kL * (kN / 4), "a (step, 4 channels) a thread");
static_assert(kThreads == kL * kL, "an element of A a thread");
static_assert(kThreads == 4 * kN && kL == 16, "a column and 4 steps a thread");

struct BwdSmem {
  float rhat[kL][kPadA];     // r * e1
  float khat[kL][kPadA];     // k * e2
  float ktail[kL][kPadA];    // k * exp(last - cum)
  float vv[kL][kPadA];
  float dy[kL][kPadA];       // the chunk's rows of y's cotangent
  float rdec_t[kN][kPadT];   // r * exp(cum_prev), transposed
  float sc[kN][kPadS];       // the state entering the chunk
  float ds[kN][kPadS];       // the gradient of the state leaving it
  float amat[kL][kPadL];     // A, strictly causal
  float damat[kL][kPadL];    // dA, strictly causal
  float d_rhat[kL][kPadA];
  float d_khat[kL][kPadA];
  float d_rdec[kL][kPadA];
  float d_ktail[kL][kPadA];
  float bon[kN / 4][kL];     // bonus partials, as the forward sums them
  float bonus[kL];
  float dbonus[kL];
  float dec[kN];             // exp(last)
  float ddec[kN];            // d decay
};

__device__ __forceinline__ float4 row4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A (step, 4 channels) slice of a [bh, seq, n] tensor at row offset `off`:
// a 16-byte load when kVec, else one by one; zeros past n or off the chunk.
template <bool kVec>
__device__ __forceinline__ float4 ld4(const float* __restrict__ p,
                                      long long off, int j0, int n,
                                      bool valid) {
  if constexpr (kVec) {
    if (!valid || j0 >= n) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return *reinterpret_cast<const float4*>(p + off + j0);
  } else {
    return load4(p, off, j0, n, valid);
  }
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
  const int lt = tid % kL, j0 = 4 * (tid / kL);  // (step, 4 channels)
  const int col = tid % kN, grp = tid / kN;      // (column, steps 4 grp..)
  const int n_chunks = seq / chunk;
  const long long base = static_cast<long long>(bh) * seq * n;
  const long long nn = static_cast<long long>(n) * n;
  const float4 uu = load4(u, static_cast<long long>(bh) * n, j0, n, true);

  for (int e = tid; e < kN * kN; e += kThreads) {
    const int q = e / kN, m = e % kN;
    sm.ds[q][m] = (q < n && m < n) ? gs[bh * nn + q * n + m] : 0.0f;
  }
  float du_acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int c = n_chunks - 1; c >= 0; --c) {
    // (a) the chunk's factors, with the forward's instructions
    const bool valid = lt < chunk;
    const long long row = base + static_cast<long long>(c * chunk + lt) * n;
    const float4 rc = ld4<kVec>(r, row, j0, n, valid),
                 kc = ld4<kVec>(k, row, j0, n, valid),
                 vc = ld4<kVec>(v, row, j0, n, valid),
                 wc = ld4<kVec>(w, row, j0, n, valid),
                 gc = ld4<kVec>(gy, row, j0, n, valid);
    const Decays d = decays(wc, lt, j0, n, chunk);
    float e1[4], e2[4], ecp[4], etl[4];
    bool in1[4], in2[4];
    float4 rh, kh, kt;
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
      in1[i] = fabsf(x1) <= kClamp;
      in2[i] = fabsf(x2) <= kClamp;
      set(rh, i, ri * e1[i]);
      set(kh, i, ki * e2[i]);
      set(kt, i, ki * etl[i]);
      sm.rdec_t[j0 + i][lt] = ri * ecp[i];
      bsum += ri * get(uu, i) * ki;
    }
    *reinterpret_cast<float4*>(&sm.rhat[lt][j0]) = rh;
    *reinterpret_cast<float4*>(&sm.khat[lt][j0]) = kh;
    *reinterpret_cast<float4*>(&sm.ktail[lt][j0]) = kt;
    *reinterpret_cast<float4*>(&sm.vv[lt][j0]) = vc;
    *reinterpret_cast<float4*>(&sm.dy[lt][j0]) = gc;
    sm.bon[j0 / 4][lt] = bsum;
    if (lt < 4) sm.dec[j0 + lt] = expf(pick(d.last, lt));
    const float* s_c =
        s_chunks + (static_cast<long long>(bh) * n_chunks + c) * nn;
    for (int e = tid; e < kN * kN; e += kThreads) {
      const int q = e / kN, m = e % kN;
      sm.sc[q][m] = (q < n && m < n) ? s_c[q * n + m] : 0.0f;
    }
    __syncthreads();

    // (b) A and dA, an element a thread; the bonus and its gradient
    {
      const int t = tid / kL, j = tid % kL;
      float a = 0.0f, da = 0.0f;
      if (j < t) {
#pragma unroll
        for (int q = 0; q < kN; q += 4) {
          const float4 x = row4(&sm.rhat[t][q]), y = row4(&sm.khat[j][q]);
          const float4 g = row4(&sm.dy[t][q]), z = row4(&sm.vv[j][q]);
          a = fmaf(x.x, y.x, a); a = fmaf(x.y, y.y, a);
          a = fmaf(x.z, y.z, a); a = fmaf(x.w, y.w, a);
          da = fmaf(g.x, z.x, da); da = fmaf(g.y, z.y, da);
          da = fmaf(g.z, z.z, da); da = fmaf(g.w, z.w, da);
        }
      }
      sm.amat[t][j] = a;
      sm.damat[t][j] = da;
    }
    if (tid >= kThreads - kL) {
      const int t = tid - (kThreads - kL);
      float acc = 0.0f, db = 0.0f;
#pragma unroll
      for (int gi = 0; gi < kN / 4; ++gi) acc += sm.bon[gi][t];
#pragma unroll 8
      for (int q = 0; q < kN; ++q) db = fmaf(sm.dy[t][q], sm.vv[t][q], db);
      sm.bonus[t] = acc;
      sm.dbonus[t] = db;
    }
    // d r_dec and d k_tail at (step 4 grp + i, channel col), d decay[col];
    // then k_tail dS at (step 4 grp + i, column col), kept for (c)
    float dvp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    {
      float drd[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float dkt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float dd = 0.0f;
#pragma unroll 2
      for (int m = 0; m < kN; m += 4) {
        float4 g[4], vt[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          g[i] = row4(&sm.dy[4 * grp + i][m]);
          vt[i] = row4(&sm.vv[4 * grp + i][m]);
        }
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          const float s = sm.sc[col][m + mm], dsv = sm.ds[col][m + mm];
          dd = fmaf(dsv, s, dd);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            drd[i] = fmaf(get(g[i], mm), s, drd[i]);
            dkt[i] = fmaf(get(vt[i], mm), dsv, dkt[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sm.d_rdec[4 * grp + i][col] = drd[i];
        sm.d_ktail[4 * grp + i][col] = dkt[i];
      }
      if (grp == 0) sm.ddec[col] = dd;
#pragma unroll 2
      for (int p = 0; p < kN; p += 4) {
        float4 kt4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) kt4[i] = row4(&sm.ktail[4 * grp + i][p]);
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          const float dsv = sm.ds[p + pp][col];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dvp[i] = fmaf(get(kt4[i], pp), dsv, dvp[i]);
        }
      }
    }
    __syncthreads();

    // (c) dS <- r_dec^T dy + diag(decay) dS, rows 16 grp .. + 15 of
    // column col; d r_hat and d k_hat at (step 4 grp + i, channel col);
    // dv at (step 4 grp + i, column col), written
    {
      float g[kL];
#pragma unroll
      for (int t = 0; t < kL; ++t) g[t] = sm.dy[t][col];
#pragma unroll 4
      for (int i = 0; i < 16; ++i) {
        const int q = 16 * grp + i;
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < kL; t += 4) {
          const float4 rd = row4(&sm.rdec_t[q][t]);
          acc = fmaf(rd.x, g[t], acc);
          acc = fmaf(rd.y, g[t + 1], acc);
          acc = fmaf(rd.z, g[t + 2], acc);
          acc = fmaf(rd.w, g[t + 3], acc);
        }
        sm.ds[q][col] = fmaf(sm.dec[q], sm.ds[q][col], acc);
      }
      float drh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float dkh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < kL; ++j) {
        const float khj = sm.khat[j][col], rhj = sm.rhat[j][col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          drh[i] = fmaf(sm.damat[4 * grp + i][j], khj, drh[i]);
          dkh[i] = fmaf(sm.damat[j][4 * grp + i], rhj, dkh[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * grp + i;
        sm.d_rhat[t][col] = drh[i];
        sm.d_khat[t][col] = dkh[i];
        float acc = dvp[i];
#pragma unroll
        for (int j = 0; j < kL; ++j) acc = fmaf(sm.amat[j][t], g[j], acc);
        acc = fmaf(sm.bonus[t], sm.dy[t][col], acc);
        if (t < chunk && col < n)
          dv[base + static_cast<long long>(c * chunk + t) * n + col] = acc;
      }
    }
    __syncthreads();

    // (d) back through the exponents, a (step, 4 channels) a thread
    {
      const float4 drh = row4(&sm.d_rhat[lt][j0]),
                   dkh = row4(&sm.d_khat[lt][j0]),
                   drd = row4(&sm.d_rdec[lt][j0]),
                   dkt = row4(&sm.d_ktail[lt][j0]);
      const float db = sm.dbonus[lt];
      float4 o_r, o_k, o_w;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ri = get(rc, i), ki = get(kc, i), ui = get(uu, i);
        const float g_rh = get(drh, i), g_kh = get(dkh, i);
        const float g_rd = get(drd, i), g_kt = get(dkt, i);
        set(o_r, i, g_rh * e1[i] + g_rd * ecp[i] + db * ui * ki);
        set(o_k, i, g_kh * e2[i] + g_kt * etl[i] + db * ui * ri);
        du_acc[i] += db * ri * ki;
        const float dx1 = in1[i] ? g_rh * (ri * e1[i]) : 0.0f;
        const float dx2 = in2[i] ? g_kh * (ki * e2[i]) : 0.0f;
        const float dtail = g_kt * (ki * etl[i]);
        const float dcp = dx1 + g_rd * (ri * ecp[i]);
        const float dcum = -dx2 - dtail;
        const float dlast = chunk_sum(0.5f * (dx2 - dx1) + dtail) +
                            sm.ddec[j0 + i] * expf(d.last[i]);
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
                   aligned16(dr) && aligned16(dk) && aligned16(dw);
  if (vec)
    return launch<true>(r, k, v, w, u, s_chunks, gy, gs, dr, dk, dv, dw, du,
                        bh, seq, n, chunk, stream);
  return launch<false>(r, k, v, w, u, s_chunks, gy, gs, dr, dk, dv, dw, du,
                       bh, seq, n, chunk, stream);
}
