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
// Unlike the JAX kernel, which returns new arrays, this one updates w, m and
// v in place: at Criteo width that saves three table-sized allocations
// (about 4.5 GB) per step.
//
// Bound: one read-modify-write pass, O(1) flops per byte, so it is bound by
// device-memory bandwidth. If every row is touched it moves V*(28*D + 4)
// bytes (read w, g, m, v and cnt, write w, m, v). An absent row needs only
// its count and w read and w written, V*(8*D + 4) bytes when no row is
// touched; the kernel reads nothing else for it.
//
// Design: right, not fast. One warp per row, lanes striding over D, so any
// D >= 1 works; both row norms are reduced across the warp with
// __shfl_xor_sync. At the main path's D = 10 (and D = 1 for the LR tables)
// this leaves 22 (31) of 32 lanes idle and the loads are not coalesced
// across rows; packing several rows per warp with vector loads is a later
// change.
#include "cowclip_adam.h"

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;  // 8 warps = 256 threads per block
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
cowclip_adam_kernel(float* __restrict__ w, const float* __restrict__ g,
                    const float* __restrict__ cnt, float* __restrict__ m,
                    float* __restrict__ v, long long rows, int dim,
                    CowclipAdamParams p) {
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
    const float gl = gr[j] * scale + p.l2 * wj;
    const float m2 = p.b1 * mr[j] + p.one_minus_b1 * gl;
    const float v2 = p.b2 * vr[j] + p.one_minus_b2 * gl * gl;
    const float upd = (m2 * p.bc1) / (sqrtf(v2 * p.bc2) + p.eps);
    wr[j] = wj - p.lr * upd;
    mr[j] = m2;
    vr[j] = v2;
  }
}

}  // namespace

void cowclip_adam_launch(float* w, const float* g, const float* cnt,
                         float* m, float* v, long long rows, int dim,
                         CowclipAdamParams p, cudaStream_t stream) {
  if (rows == 0 || dim == 0) return;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  cowclip_adam_kernel<<<static_cast<unsigned>(blocks), kWarp * kRowsPerBlock,
                        0, stream>>>(w, g, cnt, m, v, rows, dim, p);
}
