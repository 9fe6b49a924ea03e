// Sparse CowClip + coupled-L2 + Adam update, scattered in place, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/cowclip/sparse.py:
// sparse_update_scatter (Pallas body `_update_kernel`, with the
// `last_step` stamp its wrapper in ops.py made). For each slot with
// count c > 0, on the caught-up slot rows (w, g, m, v):
//
//   clip_t = c * max(r * ||w||, zeta)                   (when dim >= 2)
//   g     <- g * min(1, clip_t / (||g|| + 1e-30))
//   g     <- g + l2 * w
//   m     <- b1*m + (1-b1)*g ;  v <- b2*v + (1-b2)*g*g
//   w     <- w - lr * (m*bc1) / (sqrt(v*bc2) + eps)
//
// and (w, m, v) land at table row uid - row_offset, last_step[row] = step.
// Pad slots (c == 0) and rows outside the table write nothing. The uids of
// one field are distinct, so no two slots write one row: no atomics, and
// blocks need no order. JAX wrote in place through input_output_aliases;
// here the tables are simply written.
//
// Bound: O(1) flops per byte, so device-memory bytes: per real slot its
// count and uid, 4 slot rows read, 3 table rows and last_step written
// (28*dim + 12 bytes); a pad slot costs its count.
//
// Design: right, not fast. A slot gets `lanes` = min(32, next power of two
// >= dim) lanes of a warp (16 at dim = 10, so two slots a warp; 1 at
// dim = 1), striding over dim; the two row norms are reduced with
// __shfl_xor_sync inside the lane group. Every lane of the warp takes part
// in the shuffles, so nothing returns before them.
#include "sparse_cowclip.h"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
sparse_update_kernel(float* __restrict__ w, float* __restrict__ m,
                     float* __restrict__ v, int* __restrict__ last_step,
                     const int* __restrict__ uids,
                     const float* __restrict__ counts,
                     const float* __restrict__ w_rows,
                     const float* __restrict__ g_rows,
                     const float* __restrict__ m_rows,
                     const float* __restrict__ v_rows, long long rows,
                     int cap, int dim, int lanes, long long row_offset,
                     int step, CowclipAdamParams p) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long slot = tid / lanes;
  const int lane = static_cast<int>(tid % lanes);
  float c = 0.0f;
  long long row = -1;
  if (slot < cap) {
    c = counts[slot];
    row = static_cast<long long>(uids[slot]) - row_offset;
  }
  const bool write = c > 0.0f && row >= 0 && row < rows;
  const long long base = slot * dim;

  float scale = 1.0f;
  if (p.do_clip) {
    float gsq = 0.0f, wsq = 0.0f;
    if (write) {
      for (int j = lane; j < dim; j += lanes) {
        const float gj = g_rows[base + j], wj = w_rows[base + j];
        gsq += gj * gj;
        wsq += wj * wj;
      }
    }
    // xor offsets below `lanes` stay inside the slot's aligned lane group
    for (int off = lanes / 2; off > 0; off >>= 1) {
      gsq += __shfl_xor_sync(kFullMask, gsq, off);
      wsq += __shfl_xor_sync(kFullMask, wsq, off);
    }
    const float clip_t = c * fmaxf(p.r * sqrtf(wsq), p.zeta);
    scale = fminf(1.0f, clip_t / (sqrtf(gsq) + 1e-30f));
  }
  if (!write) return;

  const long long dst = row * dim;
  for (int j = lane; j < dim; j += lanes) {
    const float wj = w_rows[base + j];
    const float gl = g_rows[base + j] * scale + p.l2 * wj;
    const float m2 = p.b1 * m_rows[base + j] + p.one_minus_b1 * gl;
    const float v2 = p.b2 * v_rows[base + j] + p.one_minus_b2 * gl * gl;
    const float upd = (m2 * p.bc1) / (sqrtf(v2 * p.bc2) + p.eps);
    w[dst + j] = wj - p.lr * upd;
    m[dst + j] = m2;
    v[dst + j] = v2;
  }
  if (lane == 0) last_step[row] = step;
}

}  // namespace

void sparse_update_launch(float* w, float* m, float* v, int* last_step,
                          const int* uids, const float* counts,
                          const float* w_rows, const float* g_rows,
                          const float* m_rows, const float* v_rows,
                          long long rows, int cap, int dim,
                          long long row_offset, int step, CowclipAdamParams p,
                          cudaStream_t stream) {
  if (cap == 0 || dim == 0) return;
  int lanes = 1;
  while (lanes < dim && lanes < 32) lanes <<= 1;
  const long long blocks =
      (static_cast<long long>(cap) * lanes + kThreads - 1) / kThreads;
  sparse_update_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(w, m, v, last_step, uids, counts, w_rows,
                                   g_rows, m_rows, v_rows, rows, cap, dim,
                                   lanes, row_offset, step, p);
}
