// PyTorch binding of the fused CowClip + coupled-L2 + Adam kernel. The one
// translation unit that includes torch/extension.h; the host compiler
// builds it, nvcc builds only cowclip_adam.cu.
#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

#include "cowclip_adam.h"

namespace {

void check_table(const torch::Tensor& t, const char* name,
                 const torch::Tensor& like) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == torch::kFloat32, name, " must be float32");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK(t.device() == like.device(), name, " is on another device");
  TORCH_CHECK(t.sizes() == like.sizes(), name, " shape ", t.sizes(),
              " != w shape ", like.sizes());
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

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, mod) {
  mod.def("cowclip_adam_", &cowclip_adam_,
          "fused CowClip + coupled-L2 + Adam update of (w, m, v), in place");
}
