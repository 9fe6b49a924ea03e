// Plain C interface between the CowClip + coupled-L2 + Adam kernel
// (cowclip_adam.cu) and its PyTorch binding (kernels/csrc/binding.cpp).
// No PyTorch header is included here, so nvcc compiles the kernel in
// seconds.
#pragma once

#include <cuda_runtime.h>

// Scalar hyperparameters, each already rounded to f32 on the host the way
// the JAX kernel rounds its Python-float constants: one_minus_b1/b2 are
// fl32(1 - b1) / fl32(1 - b2) of the double, bc1/bc2 are 1/(1 - b^t)
// computed in f32, factor is decay_factor(lr, l2).
struct CowclipAdamParams {
  float r, zeta, lr, l2;
  float b1, b2, one_minus_b1, one_minus_b2, eps;
  float bc1, bc2, factor;
  int do_clip;  // dim >= 2: 1-dim LR-stream tables are exempt from CowClip
};

// Updates w, m, v ([rows, dim], f32, contiguous) in place from g ([rows,
// dim]) and cnt ([rows]). Launches on `stream`; the caller checks the
// launch with cudaGetLastError.
void cowclip_adam_launch(float* w, const float* g, const float* cnt,
                         float* m, float* v, long long rows, int dim,
                         CowclipAdamParams p, cudaStream_t stream);
