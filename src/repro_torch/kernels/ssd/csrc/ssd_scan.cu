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
// Backward (kernels/ssd/ref.py: ssd_scan_backward_reference is the same
// math in plain PyTorch): with G_t the cotangent of s_t,
//   G_t = gy_t c_t^T + a_{t+1} G_{t+1}     (G_{S-1} adds the final state's)
//   g_x = D gy + dt G b,  g_b = dt G^T x,  g_c = s_t^T gy,
//   g_a = <G_t, s_{t-1}>, g_dt = x^T G b - g_a A a_t,
//   g_A_log = -sum g_a dt A a_t,  g_D = sum gy . x.
//
// Bound. Forward: 6 FLOP a state element a token (x b, dt (x b), a s, the
// add, and y's multiply-add) against 4 (2 BSHP + 2 BSN + BSH + 2H + BHPN)
// bytes (x and y, b and c, dt, A_log and D, the final state); at zamba2's
// layer, B 1, S 4096, H 80, P 64, N 64: 8.05 GFLOP against 172 MB, so f32
// operations bound it (0.120 ms at 67 TFLOP/s; the bytes 0.051 ms at 3.35
// TB/s). Backward: 11 FLOP an element a token for the gradient (G's
// update, G^T x, s^T gy, <G, s_{t-1}>, G b; the states' recompute, 4 more,
// is not counted) against x, b, c, dt, gy, the kept states and the final
// state's cotangent read and the six gradients written.
// A token's state depends on the one before: the chain of dependent
// instructions a token, not the bytes or the FLOPs, sets a simple
// kernel's time.
//
// Design:
// - A block of 4 warps per (b, h, tile of 16 state rows); each warp holds
//   4 rows, each lane the columns n = lane and lane + 32, so the state
//   lives in registers (8 floats a thread) and y's sum over N is a warp
//   reduction: the 4 rows in 6 shuffles (reduce4).
// - Forward: b, c, x and dt of 64 tokens are staged in shared memory at a
//   time; the state at the start of every kSsdChunk tokens is written out
//   when kept (s_chunks), for the backward.
// - Backward: reverse over chunks. A chunk's states are recomputed from
//   its kept state (never rebuilt by dividing by a_t, which underflows to
//   0 for large dt A) into shared memory, then the G recurrence runs
//   backward over the chunk. Sums across the warps of a block go through
//   shared memory in a fixed order; sums across blocks (g_b, g_c over
//   heads and tiles, g_dt over tiles, g_A_log and g_D over everything) go
//   to per-block partial buffers that a second kernel adds in a fixed
//   order. No float atomics: two runs give the same bits.
// - Numerics: the state update is rounded as the plain version rounds it
//   (x b, then dt (x b), then a s, then the sum; __fmul_rn / __fadd_rn
//   keep nvcc from contracting them into an FMA), so the states are the
//   plain version's; y's sum over N runs in another order. expf is the
//   accurate one; no fast-math flag.
#include "ssd_scan.h"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kSsdPTile / kWarps;  // state rows a warp holds
constexpr int kElems = 2 * kRows;          // state elements a thread holds
constexpr int kC = kSsdChunk;
constexpr int kStage = 4 * kC;             // tokens staged at a time, fwd
constexpr int kN = kSsdMaxN;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kRows == 4, "reduce4 sums 4 rows a warp");
static_assert(kN == 64, "a lane holds the columns lane and lane + 32");

// The state's update, rounded as the plain version rounds it.
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

// The thread's state elements from / to a [p, n] state at `base`: rows
// p0 + warp * kRows + r, columns lane and lane + 32; outside [p, n] they
// read as 0 and are not written.
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

__device__ __forceinline__ void store_state(const float (&s)[kRows][2],
                                            float* base, int p0, int warp,
                                            int lane, int p, int n) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = p0 + warp * kRows + r;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = lane + 32 * j;
      if (row < p && col < n) base[(long long)row * n + col] = s[r][j];
    }
  }
}

struct FwdSmem {
  float b[kStage][kN], c[kStage][kN];
  float x[kStage][kSsdPTile], y[kStage][kSsdPTile];
  float dt[kStage], a[kStage];
};

// One token of the forward: the warp's 4 rows of the state, then y.
__device__ __forceinline__ void fwd_token(FwdSmem& sm, int t,
                                          float (&s)[kRows][2], int warp,
                                          int lane, float dskip) {
  const float a = sm.a[t], d = sm.dt[t];
  const float b0 = sm.b[t][lane], b1 = sm.b[t][lane + 32];
  const float c0 = sm.c[t][lane], c1 = sm.c[t][lane + 32];
  float part[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float x = sm.x[t][warp * kRows + r];
    s[r][0] = step(a, s[r][0], d, x, b0);
    s[r][1] = step(a, s[r][1], d, x, b1);
    part[r] = s[r][0] * c0 + s[r][1] * c1;
  }
  const float sum = reduce4(part, lane);
  if ((lane & 7) == 0) {
    const int r = warp * kRows + (lane >> 3);
    sm.y[t][r] = __fadd_rn(sum, __fmul_rn(dskip, sm.x[t][r]));
  }
}

__global__ void __launch_bounds__(kThreads) ssd_scan_forward_kernel(
    const float* __restrict__ xs, const float* __restrict__ bmat,
    const float* __restrict__ cmat, const float* __restrict__ dt,
    const float* __restrict__ a_log, const float* __restrict__ d_skip,
    float* __restrict__ y, float* __restrict__ s_fin,
    float* __restrict__ s_chunks, int seq, int heads, int p, int n) {
  __shared__ FwdSmem sm;
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = tile * kSsdPTile;
  const long long bh = (long long)b * heads + h;
  const long long state = (long long)p * n;
  const int n_chunks = (seq + kC - 1) / kC;
  const float big_a = expf(a_log[h]);
  const float dskip = d_skip[h];
  float s[kRows][2] = {};
  for (int t0 = 0; t0 < seq; t0 += kStage) {
    const int len = min(kStage, seq - t0);
    for (int i = tid; i < kStage * kN; i += kThreads) {
      const int t = i / kN, j = i % kN;
      const bool ok = t < len && j < n;
      const long long at = ((long long)b * seq + t0 + t) * n + j;
      sm.b[t][j] = ok ? bmat[at] : 0.f;
      sm.c[t][j] = ok ? cmat[at] : 0.f;
    }
    for (int i = tid; i < kStage * kSsdPTile; i += kThreads) {
      const int t = i / kSsdPTile, r = i % kSsdPTile;
      const bool ok = t < len && p0 + r < p;
      sm.x[t][r] = ok ? xs[(((long long)b * seq + t0 + t) * heads + h) * p +
                           p0 + r]
                      : 0.f;
    }
    for (int t = tid; t < kStage; t += kThreads) {
      const float d =
          t < len ? dt[((long long)b * seq + t0 + t) * heads + h] : 0.f;
      sm.dt[t] = d;
      sm.a[t] = expf(-d * big_a);
    }
    __syncthreads();
    for (int q = 0; q < len; q += kC) {
      if (s_chunks != nullptr) {
        store_state(s, s_chunks + (bh * n_chunks + (t0 + q) / kC) * state,
                    p0, warp, lane, p, n);
      }
      if (q + kC <= len) {
#pragma unroll 4
        for (int t = q; t < q + kC; ++t) fwd_token(sm, t, s, warp, lane, dskip);
      } else {
        for (int t = q; t < len; ++t) fwd_token(sm, t, s, warp, lane, dskip);
      }
    }
    __syncthreads();
    for (int i = tid; i < len * kSsdPTile; i += kThreads) {
      const int t = i / kSsdPTile, r = i % kSsdPTile;
      if (p0 + r < p) {
        y[(((long long)b * seq + t0 + t) * heads + h) * p + p0 + r] =
            sm.y[t][r];
      }
    }
    // the next stage's loads write no buffer these stores read (y is
    // written again only after the next barrier)
  }
  store_state(s, s_fin + bh * state, p0, warp, lane, p, n);
}

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

}  // namespace

cudaError_t ssd_scan_forward_launch(const float* xs, const float* bmat,
                                    const float* cmat, const float* dt,
                                    const float* a_log, const float* d_skip,
                                    float* y, float* s_fin, float* s_chunks,
                                    int batch, int seq, int heads, int p,
                                    int n, cudaStream_t stream) {
  const dim3 grid((p + kSsdPTile - 1) / kSsdPTile, heads, batch);
  ssd_scan_forward_kernel<<<grid, kThreads, 0, stream>>>(
      xs, bmat, cmat, dt, a_log, d_skip, y, s_fin, s_chunks, seq, heads, p,
      n);
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
