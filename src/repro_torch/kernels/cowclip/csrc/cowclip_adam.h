// Plain C interface between the CowClip + coupled-L2 + Adam kernel
// (cowclip_adam.cu) and its PyTorch binding (kernels/csrc/binding.cpp).
// No PyTorch header is included here, so nvcc compiles the kernel in
// seconds.
#pragma once

#include <cuda_runtime.h>

// Scalar hyperparameters, each already rounded to f32 on the host the way
// the JAX kernel rounds its Python-float constants: one_minus_b1/b2 are
// fl32(1 - b1) / fl32(1 - b2) of the double, factor is decay_factor(lr,
// l2). They are the same at every step.
struct CowclipAdamParams {
  float r, zeta, lr, l2;
  float b1, b2, one_minus_b1, one_minus_b2, eps;
  float factor;
  int do_clip;  // dim >= 2: 1-dim LR-stream tables are exempt from CowClip
};

// What changes from step to step, in device memory (16 bytes the caller
// fills on the card from its step counter, so a captured CUDA graph reads
// each replay's values): the 1-based step, its bias corrections
// bc1 = 1/(1 - b1^t) and bc2 = 1/(1 - b2^t) in f32, and the non-finite
// guard's flag. Each block reads it at its start. The launchers also take
// `ok`: &step->ok when the step is guarded, null when it is not; where
// *ok == 0 the update kernels write nothing.
struct CowclipStep {
  int step;
  float bc1, bc2;
  int ok;
};

// Updates w, m, v ([rows, dim], f32, contiguous) in place from g ([rows,
// dim]) and cnt ([rows]). Launches on `stream`; the caller checks the
// launch with cudaGetLastError.
void cowclip_adam_launch(float* w, const float* g, const float* cnt,
                         float* m, float* v, long long rows, int dim,
                         CowclipAdamParams p, const CowclipStep* step,
                         const int* ok, cudaStream_t stream);
