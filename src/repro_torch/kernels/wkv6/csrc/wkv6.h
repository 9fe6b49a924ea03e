// Plain C interface between the chunked WKV6 kernel (wkv6.cu) and its
// PyTorch binding (kernels/csrc/binding.cpp). No PyTorch header is included
// here, so nvcc compiles the kernel in seconds.
#pragma once

#include <cuda_runtime.h>

constexpr int kWkv6MaxN = 64;      // head size the kernel takes
constexpr int kWkv6MaxChunk = 16;  // chunk length the kernel takes

// r, k, v, w, y: [bh, seq, n]; u: [bh, n]; s_out: [bh, n, n]; all f32,
// contiguous, on the current device; 1 <= n <= kWkv6MaxN,
// 1 <= chunk <= kWkv6MaxChunk and seq % chunk == 0, which the caller
// checks. Writes y and the final state; launches on `stream`, and the
// caller checks the launch with cudaGetLastError.
void wkv6_chunked_launch(const float* r, const float* k, const float* v,
                         const float* w, const float* u, float* y,
                         float* s_out, int bh, int seq, int n, int chunk,
                         cudaStream_t stream);
