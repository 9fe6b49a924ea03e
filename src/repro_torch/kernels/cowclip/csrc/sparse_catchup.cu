// Sparse gather + closed-form lazy-decay catch-up for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/cowclip/sparse.py:
// sparse_gather_catchup (Pallas body `_catchup_kernel`). For each of the
// `cap` unique-id slots of one field, with row = uid - row_offset:
//
//   k      = max(lim - last_step[row], 0)          (lim = step - 1)
//   w_out  = w[row] * (k > 0 ? factor**k : 1)      m_out = m[row]
//   v_out  = v[row]
//
// The k == 0 guard multiplies by exactly 1.0, so a row that is already
// caught up passes through bit for bit.
//
// Bound: a gather with one multiply per element, so it is bound by
// device-memory bytes: per real slot its uid, count and last_step and 3
// rows read, and 3 rows written for every slot (12*dim + 12 bytes read,
// 12*dim written). The Pallas kernel walked one slot per grid step and
// remapped pad slots to a real uid to keep its block indices in range;
// here every thread reads its own slot's uid and count, and a pad slot
// (count 0) reads no table row at all and writes zeros.
//
// Design: one thread per output element (slot, j), so neighbouring
// threads write neighbouring addresses and the 3 output rows are written
// coalesced; a slot's dim threads read its one contiguous table row. The
// slot's uid, count and last_step are re-read by each of its dim threads
// (L1 hits), and each computes powf once: at dim = 10 that is cheap next
// to the row traffic.
#include "sparse_cowclip.h"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sparse_catchup_kernel(const float* __restrict__ w, const float* __restrict__ m,
                      const float* __restrict__ v,
                      const int* __restrict__ last_step,
                      const int* __restrict__ uids,
                      const float* __restrict__ counts,
                      float* __restrict__ w_out, float* __restrict__ m_out,
                      float* __restrict__ v_out, long long rows, int cap,
                      int dim, long long row_offset, int lim, float factor) {
  const long long n = static_cast<long long>(cap) * dim;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const long long slot = i / dim;
    float wo = 0.0f, mo = 0.0f, vo = 0.0f;
    if (counts[slot] > 0.0f) {
      long long row = static_cast<long long>(uids[slot]) - row_offset;
      row = row < 0 ? 0 : (row >= rows ? rows - 1 : row);
      const int k = max(lim - last_step[row], 0);
      const float scale = k > 0 ? powf(factor, static_cast<float>(k)) : 1.0f;
      const long long e = row * dim + (i - slot * dim);
      wo = w[e] * scale;
      mo = m[e];
      vo = v[e];
    }
    w_out[i] = wo;
    m_out[i] = mo;
    v_out[i] = vo;
  }
}

}  // namespace

void sparse_catchup_launch(const float* w, const float* m, const float* v,
                           const int* last_step, const int* uids,
                           const float* counts, float* w_out, float* m_out,
                           float* v_out, long long rows, int cap, int dim,
                           long long row_offset, int lim, float factor,
                           cudaStream_t stream) {
  const long long n = static_cast<long long>(cap) * dim;
  if (n == 0 || rows == 0) return;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  sparse_catchup_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(w, m, v, last_step, uids, counts, w_out,
                                    m_out, v_out, rows, cap, dim, row_offset,
                                    lim, factor);
}
