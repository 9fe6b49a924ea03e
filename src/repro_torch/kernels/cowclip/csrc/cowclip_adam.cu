// Fused CowClip + coupled-L2 + Adam embedding update for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/cowclip/cowclip.py:
// cowclip_adam_update (Pallas body `_kernel`). Per row of a [V, D] table:
//
//   touched (cnt > 0):
//     clip_t = cnt * max(r * ||w||, zeta)                 (when D >= 2)
//     g     <- g * min(1, clip_t / (||g|| + 1e-30))
//     g     <- g + l2 * w
//     m     <- b1*m + (1-b1)*g ;  v <- b2*v + (1-b2)*g*g
//     w     <- w - lr * (m*bc1) / (sqrt(v*bc2) + eps)
//   absent (cnt == 0):
//     w     <- w * factor ;  m, v held
//
// bc1 and bc2 (and the guard's flag) come from the step's block in device
// memory (`CowclipStep`), read by every block at its start; with a null
// `ok` there is no guard, and where *ok == 0 every block returns at once.
//
// Unlike the JAX kernel, which returns new arrays, this one updates w, m and
// v in place: at Criteo width that saves three table-sized allocations
// (about 4.5 GB) per step.
//
// Bound: one read-modify-write pass, O(1) flops per byte, so it is bound by
// device-memory bandwidth. If every row is touched it moves V*(28*D + 4)
// bytes (read w, g, m, v and cnt, write w, m, v). An absent row needs only
// its count and w read and w written, V*(8*D + 4) bytes when no row is
// touched; the kernel reads g, m, v only in float4s that hold a touched
// element. On the main path almost
// every row is absent (36,430 of 10,131,227 rows of the largest table are
// touched by one batch), so the pass is a stream over w and cnt.
//
// Why this design: with a warp per row, 22 of 32 lanes idle at D = 10 (31
// at D = 1), each thread loads 4 bytes, and an SM's 64 warps hold 64 rows
// (a few KB) in flight, far from the 15-20 KB an SM needs to cover HBM
// latency.
//
// Design, for D <= 16 (every table of the main path):
// - A warp owns a tile of whole rows: a multiple of 4 rows, at most 512
//   elements (48 rows at D = 10, 512 at D = 1), so the tile starts on a
//   float4 of w and of cnt. A grid of 8 blocks of 4 warps per SM walks the
//   tiles. Each lane loads its up to 4 float4s of w and the tile's counts
//   (float4s, into shared memory) before any math: 64 B of w a lane in
//   flight, neighbouring lanes on neighbouring addresses whatever D is.
// - An absent row costs only those loads and the float4 store of w. A
//   float4 that holds a touched element also loads its float4 of g and
//   leaves w^2 and g^2 in shared memory (24 KB a block, so 8 blocks
//   fit an SM: the grid is one wave); the lane of each touched row sums
//   its two norms in order over D and leaves CowClip's scale; then
//   every lane finishes its float4s (decay, or Adam with the touched
//   float4s' g, m, v) and stores them whole.
//   The warp owns its rows, so nothing is written twice and only the warp
//   synchronises.
// - The (< 4) rows past the tiles take a thread each of the last block.
// - For D > 16, and for tables that are not 16-byte aligned, a warp per
//   row (lanes striding over D, norms reduced with __shfl_xor_sync), so
//   any D at any alignment works.
// The norms are summed in another order than the plain version's (serial
// over D, or a warp's xor tree), within the rtol 1e-5 bar.
#include "cowclip_adam.h"

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;  // warp path: 8 warps = 256 threads
constexpr int kWarps = 4;         // tile path: warps a block
constexpr int kBlocksPerSm = 8;   // tile path: grid size, per SM
constexpr int kUnroll = 4;        // tile path: float4s of w a lane loads
constexpr int kTile = kUnroll * 4 * kWarp;  // elements of a warp's tile
constexpr int kMaxRowDim = 16;    // tile path's D
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float get(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

__device__ __forceinline__ void set(float4& a, int i, float x) {
  if (i == 0) a.x = x; else if (i == 1) a.y = x; else if (i == 2) a.z = x;
  else a.w = x;
}

// The step's bias corrections, from its block in device memory.
struct Bias {
  float bc1, bc2;
};

// Adam on one element: updates *mj, *vj; returns the new w.
__device__ __forceinline__ float adam_w(float wj, float gl, float* mj,
                                        float* vj, const CowclipAdamParams& p,
                                        const Bias& b) {
  const float m2 = p.b1 * *mj + p.one_minus_b1 * gl;
  const float v2 = p.b2 * *vj + p.one_minus_b2 * gl * gl;
  const float upd = (m2 * b.bc1) / (sqrtf(v2 * b.bc2) + p.eps);
  *mj = m2;
  *vj = v2;
  return wj - p.lr * upd;
}

// One row of D <= kMaxRowDim elements, by one thread: the decay if absent,
// else CowClip + L2 + Adam. For the few rows past the tiles.
__device__ __noinline__ void update_row(float* __restrict__ w,
                                        const float* __restrict__ g,
                                        float* __restrict__ m,
                                        float* __restrict__ v, long long row,
                                        int dim, float c,
                                        const CowclipAdamParams& p,
                                        const Bias& b) {
  const long long base = row * dim;
  if (!(c > 0.0f)) {
    for (int j = 0; j < dim; ++j) w[base + j] *= p.factor;
    return;
  }
  float wl[kMaxRowDim], gl[kMaxRowDim];
  float gsq = 0.0f, wsq = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxRowDim; ++j) {
    if (j < dim) {
      wl[j] = w[base + j];
      gl[j] = g[base + j];
      gsq += gl[j] * gl[j];
      wsq += wl[j] * wl[j];
    }
  }
  float scale = 1.0f;
  if (p.do_clip) {
    const float clip_t = c * fmaxf(p.r * sqrtf(wsq), p.zeta);
    scale = fminf(1.0f, clip_t / (sqrtf(gsq) + 1e-30f));
  }
#pragma unroll
  for (int j = 0; j < kMaxRowDim; ++j) {
    if (j < dim) {
      float mj = m[base + j], vj = v[base + j];
      w[base + j] =
          adam_w(wl[j], gl[j] * scale + p.l2 * wl[j], &mj, &vj, p, b);
      m[base + j] = mj;
      v[base + j] = vj;
    }
  }
}

// Tile path, D <= kMaxRowDim, w and cnt 16-byte aligned. A warp owns a
// tile of whole rows: `tile_rows` (a multiple of 4, so the tile starts on
// a float4 of w and of cnt) of at most kTile elements, at most kUnroll
// float4s of w a lane. The tiles cover rows_v = rows rounded down to a
// multiple of 4; the last block's threads take the (< 4) rows past it, a
// thread each.
__global__ void __launch_bounds__(kWarps * kWarp, kBlocksPerSm)
cowclip_adam_tile_kernel(float* __restrict__ w, const float* __restrict__ g,
                         const float* __restrict__ cnt,
                         float* __restrict__ m, float* __restrict__ v,
                         long long rows, int dim, int tile_rows,
                         CowclipAdamParams p,
                         const CowclipStep* __restrict__ step,
                         const int* __restrict__ ok) {
  if (ok != nullptr && *ok == 0) return;
  const Bias bias{step->bc1, step->bc2};
  const long long rows_v = rows / 4 * 4;
  if (blockIdx.x == gridDim.x - 1 && rows_v + threadIdx.x < rows) {
    const long long row = rows_v + threadIdx.x;
    update_row(w, g, m, v, row, dim, cnt[row], p, bias);
  }
  __shared__ float counts[kWarps][kTile];
  __shared__ float wsq[kWarps][kTile];   // w^2 and g^2 of a touched tile;
  __shared__ float gsq[kWarps][kTile];   // a row's scale then replaces the
                                         // g^2 of its first element

  const int lane = threadIdx.x % kWarp, wid = threadIdx.x / kWarp;
  float* cs = counts[wid];
  const long long n_tiles = (rows_v + tile_rows - 1) / tile_rows;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const float4* c4 = reinterpret_cast<const float4*>(cnt);

  for (long long tile = static_cast<long long>(blockIdx.x) * kWarps + wid;
       tile < n_tiles; tile += n_warps) {
    const long long r0 = tile * tile_rows;
    const int nr = static_cast<int>(
        rows_v - r0 < tile_rows ? rows_v - r0 : tile_rows);
    const int nf = nr * dim / 4;                 // float4s of w in the tile
    const long long f0 = r0 * dim / 4;
    // every load of the tile first: w, and the counts into shared memory
    float4 x[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int f = lane + kWarp * k;
      if (f < nf) x[k] = w4[f0 + f];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int f = lane + kWarp * k;
      if (f < nr / 4) {
        const float4 c = c4[r0 / 4 + f];
        cs[4 * f] = c.x; cs[4 * f + 1] = c.y;
        cs[4 * f + 2] = c.z; cs[4 * f + 3] = c.w;
      }
    }
    __syncwarp();

    // the touched float4s also load g, and leave w^2 and g^2
    unsigned touched = 0;  // bit k: float4 k holds a touched element
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int f = lane + kWarp * k;
      if (f >= nf) continue;
      const int row = 4 * f / dim;
      const int last = (4 * f + 3) / dim;
      bool any = false;
      for (int r = row; r <= last; ++r) any |= cs[r] > 0.0f;
      if (any) {
        touched |= 1u << k;
        const float4 gf = reinterpret_cast<const float4*>(g)[f0 + f];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wi = get(x[k], i), gi = get(gf, i);
          wsq[wid][4 * f + i] = wi * wi;
          gsq[wid][4 * f + i] = gi * gi;
        }
      }
    }
    // CowClip's scale of each touched row: both norms summed in order
    if (p.do_clip && __any_sync(kFullMask, touched != 0)) {
      __syncwarp();
      for (int r = lane; r < nr; r += kWarp) {
        const float c = cs[r];
        if (c > 0.0f) {
          float ws = 0.0f, gs = 0.0f;
          for (int j = 0; j < dim; ++j) {
            ws += wsq[wid][r * dim + j];
            gs += gsq[wid][r * dim + j];
          }
          const float clip_t = c * fmaxf(p.r * sqrtf(ws), p.zeta);
          // only this lane reads row r's squares
          gsq[wid][r * dim] = fminf(1.0f, clip_t / (sqrtf(gs) + 1e-30f));
        }
      }
      __syncwarp();
    }

    // the decay of absent elements, Adam on touched ones (their g, m, v
    // loaded here, g again from cache: fewer live registers); float4
    // stores
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int f = lane + kWarp * k;
      if (f >= nf) continue;
      float4 gf, mf, vf;
      if (touched >> k & 1u) {
        gf = reinterpret_cast<const float4*>(g)[f0 + f];
        mf = reinterpret_cast<const float4*>(m)[f0 + f];
        vf = reinterpret_cast<const float4*>(v)[f0 + f];
      }
      int row = 4 * f / dim;
      int col = 4 * f - row * dim;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i > 0 && ++col == dim) {
          col = 0;
          ++row;
        }
        const float wi = get(x[k], i);
        if (!(cs[row] > 0.0f)) {
          set(x[k], i, wi * p.factor);
        } else {
          const float scale = p.do_clip ? gsq[wid][row * dim] : 1.0f;
          float mi = get(mf, i), vi = get(vf, i);
          set(x[k], i,
              adam_w(wi, get(gf, i) * scale + p.l2 * wi, &mi, &vi, p,
                     bias));
          set(mf, i, mi);
          set(vf, i, vi);
        }
      }
      reinterpret_cast<float4*>(w)[f0 + f] = x[k];
      if (touched >> k & 1u) {
        reinterpret_cast<float4*>(m)[f0 + f] = mf;
        reinterpret_cast<float4*>(v)[f0 + f] = vf;
      }
    }
    __syncwarp();  // before the next tile overwrites the shared rows
  }
}

// Warp path, any D at any alignment: one warp per row, lanes striding
// over D.
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
cowclip_adam_kernel(float* __restrict__ w, const float* __restrict__ g,
                    const float* __restrict__ cnt, float* __restrict__ m,
                    float* __restrict__ v, long long rows, int dim,
                    CowclipAdamParams p, const CowclipStep* __restrict__ step,
                    const int* __restrict__ ok) {
  if (ok != nullptr && *ok == 0) return;
  const Bias bias{step->bc1, step->bc2};
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  // the whole warp shares one row, so it leaves together and the shuffles
  // below always see all 32 lanes
  if (row >= rows) return;
  const long long base = row * dim;
  float* wr = w + base;
  const float c = cnt[row];

  if (!(c > 0.0f)) {
    for (int j = lane; j < dim; j += kWarp) wr[j] = wr[j] * p.factor;
    return;
  }

  const float* gr = g + base;
  float* mr = m + base;
  float* vr = v + base;
  float scale = 1.0f;
  if (p.do_clip) {
    float gsq = 0.0f, wsq = 0.0f;
    for (int j = lane; j < dim; j += kWarp) {
      const float gj = gr[j], wj = wr[j];
      gsq += gj * gj;
      wsq += wj * wj;
    }
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      gsq += __shfl_xor_sync(kFullMask, gsq, off);
      wsq += __shfl_xor_sync(kFullMask, wsq, off);
    }
    const float clip_t = c * fmaxf(p.r * sqrtf(wsq), p.zeta);
    scale = fminf(1.0f, clip_t / (sqrtf(gsq) + 1e-30f));
  }

  for (int j = lane; j < dim; j += kWarp) {
    const float wj = wr[j];
    wr[j] = adam_w(wj, gr[j] * scale + p.l2 * wj, mr + j, vr + j, p, bias);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

}  // namespace

void cowclip_adam_launch(float* w, const float* g, const float* cnt,
                         float* m, float* v, long long rows, int dim,
                         CowclipAdamParams p, const CowclipStep* step,
                         const int* ok, cudaStream_t stream) {
  if (rows == 0 || dim == 0) return;
  const bool tiles = dim <= kMaxRowDim && aligned16(w) && aligned16(g) &&
                     aligned16(cnt) && aligned16(m) && aligned16(v);
  if (!tiles) {
    const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    cowclip_adam_kernel<<<static_cast<unsigned>(blocks),
                          kWarp * kRowsPerBlock, 0, stream>>>(
        w, g, cnt, m, v, rows, dim, p, step, ok);
    return;
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // tiles of whole rows: a multiple of 4 rows, at most kTile elements
  const int tile_rows = 4 * (kTile / 4 / dim);
  const long long n_tiles = (rows / 4 * 4 + tile_rows - 1) / tile_rows;
  long long blocks = (n_tiles + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms > 0 ? sms : 1) *
                        kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;    // fewer than 4 rows: the tail alone
  cowclip_adam_tile_kernel<<<static_cast<unsigned>(blocks), kWarps * kWarp,
                             0, stream>>>(w, g, cnt, m, v, rows, dim,
                                          tile_rows, p, step, ok);
}
