// Device helpers shared by the port's scan kernels (wkv6/csrc/wkv6.cu,
// wkv6/csrc/wkv6_backward.cu, ssd/csrc/ssd_scan.cu): f32-accurate products
// on the tensor cores in 3xTF32 (m16n8k8 mma.sync), and asynchronous
// copies into shared memory (cp.async).
#pragma once

namespace {

// 3xTF32: x = hi + lo exactly, hi = x rounded to TF32's 10 mantissa bits
// by an integer add and an AND (cvt.rna.tf32 takes five instructions on
// sm_90; x is finite here); a product of two such numbers is taken as
// hi*hi + hi*lo + lo*hi in f32 accumulation, about f32 accuracy (lo*lo,
// and the low bits of lo the tensor core ignores, are ~2^-22 of the
// product).
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d + small [16 x 8] += a[16 x 8] b[8 x 8] in f32 accuracy, the hi*hi
// product into d and the two cross terms into small (two chains of
// dependent mma instead of one; the caller adds them). Fragments of
// m16n8k8 (g = lane / 4, c = lane % 4): a = {a[g][c], a[g+8][c],
// a[g][c+4], a[g+8][c+4]}, b = {b[c][g], b[c+4][g]}; d = {d[g][2c],
// d[g][2c+1], d[g+8][2c], d[g+8][2c+1]}.
//
// The depth index k only pairs a's columns with b's rows, so any
// permutation of it applied to both gives the same product. With k = c
// standing for column 2c of an 8-wide block and k = c + 4 for column
// 2c + 1, a thread's a and b are the pairs (2c, 2c + 1) of a row: one
// 8-byte load each, and a d fragment of one product is the a or b
// fragment of the next with no exchange between lanes.
__device__ __forceinline__ void mma3(float (&d)[4], float (&small)[4],
                                     const float (&a)[4],
                                     const float (&b)[2]) {
  unsigned ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], ah[i], al[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) split(b[i], bh[i], bl[i]);
  mma_tf32(small, al, bh);  // the small terms in their own accumulator
  mma_tf32(small, ah, bl);
  mma_tf32(d, ah, bh);
}

// mma3 with A already split (hi, lo), where one A fragment meets several
// B fragments or one thread's split serves the whole block.
__device__ __forceinline__ void mma3_split_a(float (&d)[4], float (&small)[4],
                                             const unsigned (&ah)[4],
                                             const unsigned (&al)[4],
                                             const float (&b)[2]) {
  unsigned bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) split(b[i], bh[i], bl[i]);
  mma_tf32(small, al, bh);
  mma_tf32(small, ah, bl);
  mma_tf32(d, ah, bh);
}

// Asynchronous 16-byte copies into shared memory (cp.async): a chunk's
// inputs are copied ahead of the chunk that reads them, so their DRAM
// latency hides behind a chunk of work and holds no registers. `valid`
// false fills 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// The same for one float (rows that are not 16-byte aligned).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most the newest group of copies is in flight.
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Wait until at most the newest `kPending` groups of copies are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

}  // namespace
