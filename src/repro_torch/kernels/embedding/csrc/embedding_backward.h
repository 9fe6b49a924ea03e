// Plain C interface between the deterministic embedding backward
// (embedding_backward.cu) and its PyTorch binding
// (kernels/csrc/binding.cpp). No PyTorch header is included here, so nvcc
// compiles the kernel in seconds.
#pragma once

#include <cuda_runtime.h>

// Sorted positions a warp sums, at every level of the reduction: four
// sub-chunks of 32, one position a lane.
constexpr int kEmbedBwdChunk = 128;

// Groups of tables read at the same keys that one call sums (the fm and
// the LR tables of a CTR model are two).
constexpr int kEmbedBwdMaxGroups = 4;

// Entries of the level after one of `n` entries: each chunk's head run and
// tail run. Also the size of each half of the scratch (see below).
inline long long embedding_backward_next(long long n) {
  return 2 * ((n + kEmbedBwdChunk - 1) / kEmbedBwdChunk);
}

// One group: grad_out [n, dim] f32 (contiguous; row perm[i] is the
// cotangent of sorted position i), grad [rows, dim] f32 (contiguous,
// zeroed by the caller; a row no key names stays 0).
struct EmbedBwdGroup {
  const float* grad_out;
  float* grad;
  int dim;
};

// The gradient of a gather for each of `n_groups` groups read at the same
// keys: grad[key] = the sum of grad_out's rows whose key it is.
// sorted_keys: [n] int32, each key's positions contiguous (a stable sort
// of the gather's row index of each grad_out row); a key outside
// [0, rows) is dropped: no gradient. perm: [n] int64, the grad_out row of
// each sorted position. The scratch holds two levels:
// scratch_keys [2 * cap] int32, scratch_vals [2 * cap * (sum of the
// groups' dims)] f32, cap = embedding_backward_next(n). Launches on
// `stream` one kernel per level (at 3,407,872 keys, 4), each over every
// group, and returns the first launch error, or cudaSuccess.
cudaError_t embedding_backward_launch(const int* sorted_keys,
                                      const long long* perm, long long n,
                                      int rows, const EmbedBwdGroup* groups,
                                      int n_groups, int* scratch_keys,
                                      float* scratch_vals,
                                      cudaStream_t stream);
