// PyTorch binding of the port's CUDA kernels: the CowClip + coupled-L2 +
// Adam kernels (the fused dense update and the two sparse unique-id
// kernels) and the chunked WKV6 scan. The one translation unit that
// includes torch/extension.h; the host compiler builds it, nvcc builds only
// the .cu files.
#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

#include "cowclip_adam.h"
#include "sparse_cowclip.h"
#include "wkv6.h"

namespace {

void check_table(const torch::Tensor& t, const char* name,
                 const torch::Tensor& like) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == torch::kFloat32, name, " must be float32");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK(t.device() == like.device(), name, " is on another device");
  TORCH_CHECK(t.sizes() == like.sizes(), name, " shape ", t.sizes(),
              " != ", like.sizes());
}

void cowclip_adam_(torch::Tensor w, torch::Tensor g, torch::Tensor cnt,
                   torch::Tensor m, torch::Tensor v, double r, double zeta,
                   double lr, double l2, double b1, double b2,
                   double one_minus_b1, double one_minus_b2, double eps,
                   double bc1, double bc2, double factor) {
  TORCH_CHECK(w.dim() == 2, "w must be [V, D]");
  check_table(w, "w", w);
  check_table(g, "g", w);
  check_table(m, "m", w);
  check_table(v, "v", w);
  TORCH_CHECK(cnt.is_cuda() && cnt.scalar_type() == torch::kFloat32 &&
                  cnt.is_contiguous() && cnt.device() == w.device(),
              "cnt must be a contiguous float32 tensor on w's device");
  TORCH_CHECK(cnt.dim() == 1 && cnt.size(0) == w.size(0), "cnt must be [V]");
  const c10::cuda::CUDAGuard guard(w.device());
  const int dim = static_cast<int>(w.size(1));
  CowclipAdamParams p{static_cast<float>(r),
                      static_cast<float>(zeta),
                      static_cast<float>(lr),
                      static_cast<float>(l2),
                      static_cast<float>(b1),
                      static_cast<float>(b2),
                      static_cast<float>(one_minus_b1),
                      static_cast<float>(one_minus_b2),
                      static_cast<float>(eps),
                      static_cast<float>(bc1),
                      static_cast<float>(bc2),
                      static_cast<float>(factor),
                      dim >= 2 ? 1 : 0};
  cowclip_adam_launch(w.data_ptr<float>(), g.data_ptr<float>(),
                      cnt.data_ptr<float>(), m.data_ptr<float>(),
                      v.data_ptr<float>(), w.size(0), dim, p,
                      at::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void check_vec(const torch::Tensor& t, const char* name,
               torch::ScalarType dtype, int64_t size,
               const torch::Tensor& like) {
  TORCH_CHECK(t.is_cuda() && t.device() == like.device(), name,
              " must be a CUDA tensor on w's device");
  TORCH_CHECK(t.scalar_type() == dtype, name, " has the wrong dtype");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK(t.dim() == 1 && t.size(0) == size, name, " must be [", size,
              "], got ", t.sizes());
}

// w, m, v [V, D] f32; last_step [V] int32; uids [cap] int32; counts [cap]
// f32; the three [cap, D] f32 outputs are allocated by the caller.
void sparse_gather_catchup(torch::Tensor w, torch::Tensor m, torch::Tensor v,
                           torch::Tensor last_step, torch::Tensor uids,
                           torch::Tensor counts, torch::Tensor w_out,
                           torch::Tensor m_out, torch::Tensor v_out,
                           int64_t row_offset, int64_t lim, double factor) {
  TORCH_CHECK(w.dim() == 2, "w must be [V, D]");
  check_table(w, "w", w);
  check_table(m, "m", w);
  check_table(v, "v", w);
  check_vec(last_step, "last_step", torch::kInt32, w.size(0), w);
  check_vec(uids, "uids", torch::kInt32, uids.size(0), w);
  check_vec(counts, "counts", torch::kFloat32, uids.size(0), w);
  const std::vector<int64_t> out_shape{uids.size(0), w.size(1)};
  for (const auto& t : {w_out, m_out, v_out}) {
    TORCH_CHECK(t.is_cuda() && t.device() == w.device() &&
                    t.scalar_type() == torch::kFloat32 && t.is_contiguous() &&
                    t.sizes() == c10::IntArrayRef(out_shape),
                "outputs must be contiguous float32 [cap, D] on w's device");
  }
  const c10::cuda::CUDAGuard guard(w.device());
  sparse_catchup_launch(
      w.data_ptr<float>(), m.data_ptr<float>(), v.data_ptr<float>(),
      last_step.data_ptr<int>(), uids.data_ptr<int>(),
      counts.data_ptr<float>(), w_out.data_ptr<float>(),
      m_out.data_ptr<float>(), v_out.data_ptr<float>(), w.size(0),
      static_cast<int>(uids.size(0)), static_cast<int>(w.size(1)),
      row_offset, static_cast<int>(lim), static_cast<float>(factor),
      at::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Updates w, m, v [V, D] and last_step [V] in place from the [cap, D] slot
// rows; the scalars are rounded on the host as for cowclip_adam_.
void sparse_update_scatter_(torch::Tensor w, torch::Tensor m, torch::Tensor v,
                            torch::Tensor last_step, torch::Tensor uids,
                            torch::Tensor counts, torch::Tensor w_rows,
                            torch::Tensor g_rows, torch::Tensor m_rows,
                            torch::Tensor v_rows, int64_t row_offset,
                            int64_t step, double r, double zeta, double lr,
                            double l2, double b1, double b2,
                            double one_minus_b1, double one_minus_b2,
                            double eps, double bc1, double bc2, bool clip) {
  TORCH_CHECK(w.dim() == 2, "w must be [V, D]");
  check_table(w, "w", w);
  check_table(m, "m", w);
  check_table(v, "v", w);
  check_vec(last_step, "last_step", torch::kInt32, w.size(0), w);
  check_vec(uids, "uids", torch::kInt32, uids.size(0), w);
  check_vec(counts, "counts", torch::kFloat32, uids.size(0), w);
  const std::vector<int64_t> row_shape{uids.size(0), w.size(1)};
  for (const auto& t : {w_rows, g_rows, m_rows, v_rows}) {
    TORCH_CHECK(t.is_cuda() && t.device() == w.device() &&
                    t.scalar_type() == torch::kFloat32 && t.is_contiguous() &&
                    t.sizes() == c10::IntArrayRef(row_shape),
                "slot rows must be contiguous float32 [cap, D] on w's "
                "device");
  }
  const c10::cuda::CUDAGuard guard(w.device());
  const int dim = static_cast<int>(w.size(1));
  CowclipAdamParams p{static_cast<float>(r),
                      static_cast<float>(zeta),
                      static_cast<float>(lr),
                      static_cast<float>(l2),
                      static_cast<float>(b1),
                      static_cast<float>(b2),
                      static_cast<float>(one_minus_b1),
                      static_cast<float>(one_minus_b2),
                      static_cast<float>(eps),
                      static_cast<float>(bc1),
                      static_cast<float>(bc2),
                      1.0f,
                      clip && dim >= 2 ? 1 : 0};
  sparse_update_launch(
      w.data_ptr<float>(), m.data_ptr<float>(), v.data_ptr<float>(),
      last_step.data_ptr<int>(), uids.data_ptr<int>(),
      counts.data_ptr<float>(), w_rows.data_ptr<float>(),
      g_rows.data_ptr<float>(), m_rows.data_ptr<float>(),
      v_rows.data_ptr<float>(), w.size(0), static_cast<int>(uids.size(0)),
      dim, row_offset, static_cast<int>(step), p,
      at::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// r, k, v, w [bh, seq, n] f32; u [bh, n]; y [bh, seq, n] and s_out
// [bh, n, n] allocated by the caller, and the segment carry's scratch:
// s_loc, s_in [bh, G-1, n, n] and p_seg [bh, G-1, n] for G segments of
// `segment` chunks.
void wkv6_chunked(torch::Tensor r, torch::Tensor k, torch::Tensor v,
                  torch::Tensor w, torch::Tensor u, torch::Tensor y,
                  torch::Tensor s_out, torch::Tensor s_loc,
                  torch::Tensor p_seg, torch::Tensor s_in, int64_t chunk,
                  int64_t segment) {
  TORCH_CHECK(r.dim() == 3, "r must be [BH, S, N]");
  check_table(r, "r", r);
  check_table(k, "k", r);
  check_table(v, "v", r);
  check_table(w, "w", r);
  check_table(y, "y", r);
  const int64_t bh = r.size(0), seq = r.size(1), n = r.size(2);
  TORCH_CHECK(n >= 1 && n <= kWkv6MaxN, "head size ", n, " outside [1, ",
              kWkv6MaxN, "]");
  TORCH_CHECK(chunk >= 1 && chunk <= kWkv6MaxChunk, "chunk ", chunk,
              " outside [1, ", kWkv6MaxChunk, "]");
  TORCH_CHECK(seq % chunk == 0, "seq len ", seq, " is no multiple of chunk ",
              chunk);
  TORCH_CHECK(segment >= 1, "segment ", segment, " < 1 chunk");
  TORCH_CHECK(bh <= INT32_MAX && seq <= INT32_MAX, "r is too large");
  const int64_t n_chunks = seq / chunk;
  const int64_t segs = n_chunks > 0 ? (n_chunks + segment - 1) / segment : 1;
  TORCH_CHECK(bh * segs <= INT32_MAX, "too many segments");
  for (const auto& t : {u, s_out, s_loc, p_seg, s_in}) {
    TORCH_CHECK(t.is_cuda() && t.device() == r.device() &&
                    t.scalar_type() == torch::kFloat32 && t.is_contiguous(),
                "u, s_out and the scratch must be contiguous float32 on r's "
                "device");
  }
  const std::vector<int64_t> u_shape{bh, n}, s_shape{bh, n, n},
      loc_shape{bh, segs - 1, n, n}, p_shape{bh, segs - 1, n};
  TORCH_CHECK(u.sizes() == c10::IntArrayRef(u_shape), "u must be [BH, N]");
  TORCH_CHECK(s_out.sizes() == c10::IntArrayRef(s_shape),
              "s_out must be [BH, N, N]");
  TORCH_CHECK(s_loc.sizes() == c10::IntArrayRef(loc_shape) &&
                  s_in.sizes() == c10::IntArrayRef(loc_shape),
              "s_loc and s_in must be [BH, segments - 1, N, N]");
  TORCH_CHECK(p_seg.sizes() == c10::IntArrayRef(p_shape),
              "p_seg must be [BH, segments - 1, N]");
  const c10::cuda::CUDAGuard guard(r.device());
  wkv6_chunked_launch(r.data_ptr<float>(), k.data_ptr<float>(),
                      v.data_ptr<float>(), w.data_ptr<float>(),
                      u.data_ptr<float>(), y.data_ptr<float>(),
                      s_out.data_ptr<float>(), s_loc.data_ptr<float>(),
                      p_seg.data_ptr<float>(), s_in.data_ptr<float>(),
                      static_cast<int>(bh), static_cast<int>(seq),
                      static_cast<int>(n), static_cast<int>(chunk),
                      static_cast<int>(segment),
                      at::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, mod) {
  mod.def("cowclip_adam_", &cowclip_adam_,
          "fused CowClip + coupled-L2 + Adam update of (w, m, v), in place");
  mod.def("sparse_gather_catchup", &sparse_gather_catchup,
          "gather unique-id slot rows with closed-form lazy-decay catch-up");
  mod.def("sparse_update_scatter_", &sparse_update_scatter_,
          "CowClip + coupled-L2 + Adam on slot rows, scattered in place");
  mod.def("wkv6_chunked", &wkv6_chunked,
          "chunked RWKV-6 WKV scan: y and the final state, written into "
          "the given outputs");
}
