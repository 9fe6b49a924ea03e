// Plain C interface between the Mamba-2 scan kernels (ssd_scan.cu) and
// their PyTorch binding (kernels/csrc/binding.cpp). No PyTorch header is
// included here, so nvcc compiles the kernels in seconds.
#pragma once

#include <cuda_runtime.h>

constexpr int kSsdMaxN = 64;   // state size N the kernels take
constexpr int kSsdChunk = 16;  // tokens between the states kept for the
                               // backward (kernels/ssd/ref.py: CHUNK)
constexpr int kSsdRows = 64;   // state rows a block holds (P is cut into
                               // groups of it)

// xs, y: [batch, seq, heads, p]; bmat, cmat: [batch, seq, n]; dt:
// [batch, seq, heads]; a_log, d_skip: [heads]; s_fin: [batch, heads, p,
// n]; s_chunks: [batch, heads, ceil(seq / kSsdChunk), p, n], the state at
// the start of each chunk, or null (not kept). With G = ceil(ceil(seq /
// kSsdChunk) / segment) segments of `segment` chunks a (b, h), s_loc and
// s_in are scratch of [batch, heads, G-1, p, n] and log_decay of [batch,
// heads, G-1] (unused when G = 1). All f32, contiguous, on the current
// device; seq >= 1, 1 <= n <= kSsdMaxN, segment >= 1, which the caller
// checks. Launches on `stream` (one kernel, or three when G > 1: the
// segments' own states, their carry, the scan); returns the first error.
cudaError_t ssd_scan_forward_launch(
    const float* xs, const float* bmat, const float* cmat, const float* dt,
    const float* a_log, const float* d_skip, float* y, float* s_fin,
    float* s_chunks, float* s_loc, float* log_decay, float* s_in, int batch,
    int seq, int heads, int p, int n, int segment, cudaStream_t stream);

// The gradients of the scan from the forward's inputs, its chunk states
// and the cotangents gy (y's shape) and gs (s_fin's): gx, gb, gc, gdt,
// ga_log and gd, each of its input's shape. With R = ceil(p / kSsdRows)
// groups of rows, the scratch of the sums across blocks: part_b and part_c
// [batch, seq, heads, R, n], part_dt [batch, seq, heads, R] (unused when R
// = 1: the scan writes gdt), part_h [2, batch, heads, R]. Launches two
// kernels on `stream`; returns the first error.
cudaError_t ssd_scan_backward_launch(
    const float* xs, const float* bmat, const float* cmat, const float* dt,
    const float* a_log, const float* d_skip, const float* s_chunks,
    const float* gy, const float* gs, float* gx, float* gb, float* gc,
    float* gdt, float* ga_log, float* gd, float* part_b, float* part_c,
    float* part_dt, float* part_h, int batch, int seq, int heads, int p,
    int n, cudaStream_t stream);
