// Plain C interface between the sparse unique-id CowClip kernels
// (sparse_catchup.cu, sparse_update.cu) and their PyTorch binding
// (binding.cpp). No PyTorch header is included here, so nvcc compiles the
// kernels in seconds.
#pragma once

#include <cuda_runtime.h>

#include "cowclip_adam.h"

// Gathers the rows of the `cap` slots from the [rows, dim] tables w, m, v
// at uid - row_offset (clamped into the table) and scales w by
// factor**k, k = max(lim - last_step[row], 0); exactly 1.0 at k == 0.
// Pad slots (counts == 0) read nothing and write zero rows. Outputs are
// [cap, dim].
void sparse_catchup_launch(const float* w, const float* m, const float* v,
                           const int* last_step, const int* uids,
                           const float* counts, float* w_out, float* m_out,
                           float* v_out, long long rows, int cap, int dim,
                           long long row_offset, int lim, float factor,
                           cudaStream_t stream);

// For each slot with counts > 0 whose row uid - row_offset lies in the
// table: CowClip (p.do_clip), coupled L2 and Adam on the caught-up slot
// rows, the new (w, m, v) written in place at that row and last_step
// stamped with `step`. Pad slots write nothing. p.factor is not read.
void sparse_update_launch(float* w, float* m, float* v, int* last_step,
                          const int* uids, const float* counts,
                          const float* w_rows, const float* g_rows,
                          const float* m_rows, const float* v_rows,
                          long long rows, int cap, int dim,
                          long long row_offset, int step, CowclipAdamParams p,
                          cudaStream_t stream);
