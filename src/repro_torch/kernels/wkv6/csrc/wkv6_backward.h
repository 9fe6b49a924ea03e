// Plain C interface between the chunked WKV6 backward kernel
// (wkv6_backward.cu) and its PyTorch binding (kernels/csrc/binding.cpp).
// No PyTorch header is included here, so nvcc compiles the kernel in
// seconds.
#pragma once

#include <cuda_runtime.h>

// r, k, v, w, gy, dr, dk, dv, dw: [bh, seq, n]; u, du: [bh, n]; s_chunks:
// [bh, seq / chunk, n, n], the state entering each chunk (the forward
// kernel's, kept); gs: [bh, n, n], the final state's cotangent. All f32,
// contiguous, on the current device; 1 <= n <= kWkv6MaxN, 1 <= chunk <=
// kWkv6MaxChunk and seq % chunk == 0, which the caller checks. Writes the
// five gradients; launches one kernel on `stream` and returns the first
// error.
cudaError_t wkv6_backward_launch(const float* r, const float* k,
                                 const float* v, const float* w,
                                 const float* u, const float* s_chunks,
                                 const float* gy, const float* gs, float* dr,
                                 float* dk, float* dv, float* dw, float* du,
                                 int bh, int seq, int n, int chunk,
                                 cudaStream_t stream);
