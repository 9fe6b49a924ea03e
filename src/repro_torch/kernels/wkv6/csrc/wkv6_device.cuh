// Device helpers of the chunked WKV6 kernels shared by the forward
// (wkv6.cu) and the backward (wkv6_backward.cu), so both compute a chunk's
// log decays and their cumsums with the same instructions, in the same
// order: the backward recomputes the forward's factors bit for bit.
#pragma once

#include "wkv6.h"

namespace {

constexpr float kClamp = 25.0f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float clip(float x) {
  return fminf(fmaxf(x, -kClamp), kClamp);
}

__device__ __forceinline__ float get(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

__device__ __forceinline__ void set(float4& a, int i, float x) {
  if (i == 0) a.x = x; else if (i == 1) a.y = x; else if (i == 2) a.z = x;
  else a.w = x;
}

// The 4 channels j0 .. j0+3 of one step at p + off, loaded one by one
// (u, and the inputs where n % 4 != 0 or a row is not 16-byte aligned):
// zeros past n or for an invalid step.
__device__ __forceinline__ float4 load4(const float* __restrict__ p,
                                        long long off, int j0, int n,
                                        bool valid) {
  float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (!valid) return x;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (j0 + i < n) set(x, i, p[off + j0 + i]);
  return x;
}

// Per-thread log decays of its (step, 4 channels) and their cumsums along
// the chunk: a shuffle scan over the 16 lanes that hold the chunk's steps
// of the same channels. lw = 0 past the chunk and past n, so the padding
// adds nothing and decays nothing.
struct Decays {
  float lw[4], cum[4], last[4];
};

// x[i] for a runtime i in [0, 4), without an indexed (local) array
__device__ __forceinline__ float pick(const float (&x)[4], int i) {
  return i == 0 ? x[0] : i == 1 ? x[1] : i == 2 ? x[2] : x[3];
}

__device__ __forceinline__ Decays decays(const float4& w, int lt, int j0,
                                         int n, int chunk) {
  Decays d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool on = lt < chunk && j0 + i < n;
    d.lw[i] = on ? logf(fmaxf(get(w, i), 1e-38f)) : 0.0f;
    float x = d.lw[i];
#pragma unroll
    for (int off = 1; off < kWkv6MaxChunk; off <<= 1) {
      const float y = __shfl_up_sync(kFull, x, off, kWkv6MaxChunk);
      if (lt >= off) x += y;
    }
    d.cum[i] = x;
    d.last[i] = __shfl_sync(kFull, x, chunk - 1, kWkv6MaxChunk);
  }
  return d;
}

}  // namespace
