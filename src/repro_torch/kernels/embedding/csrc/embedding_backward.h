// Plain C interface between the deterministic embedding backward
// (embedding_backward.cu) and its PyTorch binding
// (kernels/csrc/binding.cpp). No PyTorch header is included here, so nvcc
// compiles the kernel in seconds.
#pragma once

#include <cuda_runtime.h>

// Sorted positions a warp sums, at every level of the reduction.
constexpr int kEmbedBwdChunk = 32;

// Entries of the level after one of `n` entries: each chunk's head run and
// tail run. Also the size of each half of the scratch (see below).
inline long long embedding_backward_next(long long n) {
  return 2 * ((n + kEmbedBwdChunk - 1) / kEmbedBwdChunk);
}

// The gradient of a gather, grad[key] = the sum of grad_out's rows that
// read row `key`, into grad ([rows, dim] f32, contiguous, zeroed by the
// caller; a row no key names stays 0). sorted_keys: [n] int32, ascending
// (a stable sort of the gather's row index of each grad_out row; a key >=
// rows is dropped: no gradient). perm: [n] int64, the grad_out row of
// each sorted position. grad_out: [*, dim] f32, contiguous. The scratch
// holds two levels: scratch_keys [2 * cap] int32, scratch_vals
// [2 * cap * dim] f32, cap = embedding_backward_next(n). Launches on
// `stream` one kernel per level (about log16(n / 32) + 1) and returns the
// first launch error, or cudaSuccess.
cudaError_t embedding_backward_launch(const int* sorted_keys,
                                      const long long* perm,
                                      const float* grad_out, long long n,
                                      int dim, int rows, float* grad,
                                      int* scratch_keys, float* scratch_vals,
                                      cudaStream_t stream);
