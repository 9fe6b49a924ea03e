// Plain C interface between the chunked WKV6 kernel (wkv6.cu) and its
// PyTorch binding (kernels/csrc/binding.cpp). No PyTorch header is included
// here, so nvcc compiles the kernel in seconds.
#pragma once

#include <cuda_runtime.h>

constexpr int kWkv6MaxN = 64;      // head size the kernel takes
constexpr int kWkv6MaxChunk = 16;  // chunk length the kernel takes

// r, k, v, w, y: [bh, seq, n]; u: [bh, n]; s_out: [bh, n, n]; all f32,
// contiguous, on the current device; 1 <= n <= kWkv6MaxN,
// 1 <= chunk <= kWkv6MaxChunk, seq % chunk == 0 and segment >= 1, which
// the caller checks. With G = ceil(seq / chunk / segment) segments of
// `segment` chunks a bh (G = 1 when seq = 0), s_loc and s_in are scratch
// of [bh, G-1, n, n] and p_seg of [bh, G-1, n] f32 (unused when G = 1).
// s_chunks is null, or [bh, seq / chunk, n, n] f32 for the state entering
// each chunk (kept for the backward). Writes y, the final state and the
// kept states; launches on `stream` (up to three kernels), and the caller
// checks the launch with cudaGetLastError.
void wkv6_chunked_launch(const float* r, const float* k, const float* v,
                         const float* w, const float* u, float* y,
                         float* s_out, float* s_chunks, float* s_loc,
                         float* p_seg, float* s_in, int bh, int seq, int n,
                         int chunk, int segment, cudaStream_t stream);
