// PyTorch binding of the port's CUDA kernels: the CowClip + coupled-L2 +
// Adam kernels (the fused dense update and the two sparse unique-id
// kernels), the chunked WKV6 scan and its backward, the deterministic
// embedding backward
// and the Mamba-2 scan's forward and backward. The one translation unit
// that
// includes torch/extension.h; the host compiler builds it, nvcc builds only
// the .cu files.
#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

#include "cowclip_adam.h"
#include "embedding_backward.h"
#include "sparse_cowclip.h"
#include "ssd_scan.h"
#include "wkv6.h"
#include "wkv6_backward.h"

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

// The step's block (`CowclipStep`: step, bc1, bc2 and the guard's flag,
// one int32 [4] tensor on w's device, bc1 and bc2 as their f32 bits): its
// pointer, and the flag's pointer when `guarded`, else null.
std::pair<const CowclipStep*, const int*> step_block(
    const torch::Tensor& words, bool guarded, const torch::Tensor& like) {
  TORCH_CHECK(words.is_cuda() && words.device() == like.device(),
              "the step block must be on w's device");
  TORCH_CHECK(words.scalar_type() == torch::kInt32 && words.is_contiguous() &&
                  words.numel() == 4,
              "the step block must be 4 contiguous int32 words");
  static_assert(sizeof(CowclipStep) == 4 * sizeof(int), "CowclipStep");
  const auto* step = reinterpret_cast<const CowclipStep*>(
      words.data_ptr<int>());
  return {step, guarded ? &step->ok : nullptr};
}

void cowclip_adam_(torch::Tensor w, torch::Tensor g, torch::Tensor cnt,
                   torch::Tensor m, torch::Tensor v, torch::Tensor step_words,
                   bool guarded, double r, double zeta, double lr, double l2,
                   double b1, double b2, double one_minus_b1,
                   double one_minus_b2, double eps, double factor) {
  TORCH_CHECK(w.dim() == 2, "w must be [V, D]");
  check_table(w, "w", w);
  check_table(g, "g", w);
  check_table(m, "m", w);
  check_table(v, "v", w);
  TORCH_CHECK(cnt.is_cuda() && cnt.scalar_type() == torch::kFloat32 &&
                  cnt.is_contiguous() && cnt.device() == w.device(),
              "cnt must be a contiguous float32 tensor on w's device");
  TORCH_CHECK(cnt.dim() == 1 && cnt.size(0) == w.size(0), "cnt must be [V]");
  const auto [step, ok] = step_block(step_words, guarded, w);
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
                      static_cast<float>(factor),
                      dim >= 2 ? 1 : 0};
  cowclip_adam_launch(w.data_ptr<float>(), g.data_ptr<float>(),
                      cnt.data_ptr<float>(), m.data_ptr<float>(),
                      v.data_ptr<float>(), w.size(0), dim, p, step, ok,
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

void check_rows(const torch::Tensor& t, const char* name, int64_t cap,
                int64_t dim, const torch::Tensor& like) {
  TORCH_CHECK(t.is_cuda() && t.device() == like.device(), name,
              " must be a CUDA tensor on w's device");
  TORCH_CHECK(t.scalar_type() == torch::kFloat32, name, " must be float32");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK(t.dim() == 2 && t.size(0) == cap && t.size(1) == dim, name,
              " must be [", cap, ", ", dim, "], got ", t.sizes());
}

// Checks table i of a sparse list (w, m, v [V, D] f32; last_step [V]
// int32; uids [cap] int32; counts [cap] f32; all on the first w's device)
// and returns its cap.
int64_t check_sparse_table(const std::vector<torch::Tensor>& w,
                           const std::vector<torch::Tensor>& m,
                           const std::vector<torch::Tensor>& v,
                           const std::vector<torch::Tensor>& last_step,
                           const std::vector<torch::Tensor>& uids,
                           const std::vector<torch::Tensor>& counts,
                           size_t i) {
  TORCH_CHECK(w[i].dim() == 2, "w must be [V, D]");
  TORCH_CHECK(w[i].device() == w[0].device(), "tables on two devices");
  check_table(w[i], "w", w[i]);
  check_table(m[i], "m", w[i]);
  check_table(v[i], "v", w[i]);
  check_vec(last_step[i], "last_step", torch::kInt32, w[i].size(0), w[i]);
  TORCH_CHECK(uids[i].dim() == 1 && uids[i].size(0) <= INT32_MAX,
              "uids must be [cap]");
  const int64_t cap = uids[i].size(0);
  check_vec(uids[i], "uids", torch::kInt32, cap, w[i]);
  check_vec(counts[i], "counts", torch::kFloat32, cap, w[i]);
  return cap;
}

void check_list_sizes(std::initializer_list<size_t> sizes) {
  const size_t n = *sizes.begin();
  TORCH_CHECK(n >= 1 && n <= kSparseMaxTables, "a sparse launch takes 1 to ",
              kSparseMaxTables, " tables, got ", n);
  for (const size_t s : sizes) {
    TORCH_CHECK(s == n, "the table lists differ in length");
  }
}

// One launch over the tables of the lists (index i of every list is table
// i): their [cap, D] f32 slot rows, caught up through the step block's
// step - 1, are written into w_out, m_out, v_out (allocated by the
// caller), and depth (one int32, or None for no depth) is raised to the
// deepest catch-up of a real slot, after being zeroed here, on the stream,
// when zero_depth (inside a captured graph, so each replay zeroes it).
void sparse_gather_catchup(
    std::vector<torch::Tensor> w, std::vector<torch::Tensor> m,
    std::vector<torch::Tensor> v, std::vector<torch::Tensor> last_step,
    std::vector<torch::Tensor> uids, std::vector<torch::Tensor> counts,
    std::vector<torch::Tensor> w_out, std::vector<torch::Tensor> m_out,
    std::vector<torch::Tensor> v_out, std::vector<int64_t> row_offset,
    torch::Tensor step_words, double factor,
    std::optional<torch::Tensor> depth, bool zero_depth) {
  check_list_sizes({w.size(), m.size(), v.size(), last_step.size(),
                    uids.size(), counts.size(), w_out.size(), m_out.size(),
                    v_out.size(), row_offset.size()});
  std::vector<SparseCatchupTable> tables(w.size());
  for (size_t i = 0; i < w.size(); ++i) {
    const int64_t cap =
        check_sparse_table(w, m, v, last_step, uids, counts, i);
    const int64_t dim = w[i].size(1);
    check_rows(w_out[i], "w_out", cap, dim, w[i]);
    check_rows(m_out[i], "m_out", cap, dim, w[i]);
    check_rows(v_out[i], "v_out", cap, dim, w[i]);
    tables[i] = SparseCatchupTable{
        w[i].data_ptr<float>(),      m[i].data_ptr<float>(),
        v[i].data_ptr<float>(),      last_step[i].data_ptr<int>(),
        uids[i].data_ptr<int>(),     counts[i].data_ptr<float>(),
        w_out[i].data_ptr<float>(),  m_out[i].data_ptr<float>(),
        v_out[i].data_ptr<float>(),  w[i].size(0),
        row_offset[i],               static_cast<int>(cap),
        static_cast<int>(dim)};
  }
  int* depth_ptr = nullptr;
  if (depth.has_value()) {
    TORCH_CHECK(depth->is_cuda() && depth->device() == w[0].device() &&
                    depth->scalar_type() == torch::kInt32 &&
                    depth->numel() == 1 && depth->is_contiguous(),
                "depth must be one int32 on w's device");
    depth_ptr = depth->data_ptr<int>();
  }
  const CowclipStep* step = step_block(step_words, false, w[0]).first;
  const c10::cuda::CUDAGuard guard(w[0].device());
  const cudaStream_t stream = at::cuda::getCurrentCUDAStream().stream();
  if (depth_ptr != nullptr && zero_depth) {
    C10_CUDA_CHECK(cudaMemsetAsync(depth_ptr, 0, sizeof(int), stream));
  }
  sparse_catchup_launch(tables.data(), static_cast<int>(tables.size()), step,
                        static_cast<float>(factor), depth_ptr, stream);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// One launch over the tables of the lists: w, m, v [V, D] and last_step
// [V] updated in place from the [cap, D] slot rows, the step and its bias
// corrections read from the step block (nothing written where a guarded
// block's flag is 0); the other scalars are rounded on the host as for
// cowclip_adam_.
void sparse_update_scatter_(
    std::vector<torch::Tensor> w, std::vector<torch::Tensor> m,
    std::vector<torch::Tensor> v, std::vector<torch::Tensor> last_step,
    std::vector<torch::Tensor> uids, std::vector<torch::Tensor> counts,
    std::vector<torch::Tensor> w_rows, std::vector<torch::Tensor> g_rows,
    std::vector<torch::Tensor> m_rows, std::vector<torch::Tensor> v_rows,
    std::vector<int64_t> row_offset, torch::Tensor step_words, bool guarded,
    double r, double zeta, double lr, double l2, double b1, double b2,
    double one_minus_b1, double one_minus_b2, double eps, bool clip) {
  check_list_sizes({w.size(), m.size(), v.size(), last_step.size(),
                    uids.size(), counts.size(), w_rows.size(), g_rows.size(),
                    m_rows.size(), v_rows.size(), row_offset.size()});
  std::vector<SparseUpdateTable> tables(w.size());
  for (size_t i = 0; i < w.size(); ++i) {
    const int64_t cap =
        check_sparse_table(w, m, v, last_step, uids, counts, i);
    const int64_t dim = w[i].size(1);
    check_rows(w_rows[i], "w_rows", cap, dim, w[i]);
    check_rows(g_rows[i], "g_rows", cap, dim, w[i]);
    check_rows(m_rows[i], "m_rows", cap, dim, w[i]);
    check_rows(v_rows[i], "v_rows", cap, dim, w[i]);
    tables[i] = SparseUpdateTable{
        w[i].data_ptr<float>(),        m[i].data_ptr<float>(),
        v[i].data_ptr<float>(),        last_step[i].data_ptr<int>(),
        uids[i].data_ptr<int>(),       counts[i].data_ptr<float>(),
        w_rows[i].data_ptr<float>(),   g_rows[i].data_ptr<float>(),
        m_rows[i].data_ptr<float>(),   v_rows[i].data_ptr<float>(),
        w[i].size(0),                  row_offset[i],
        static_cast<int>(cap),         static_cast<int>(dim),
        clip && dim >= 2 ? 1 : 0};
  }
  const auto [step, ok] = step_block(step_words, guarded, w[0]);
  const c10::cuda::CUDAGuard guard(w[0].device());
  CowclipAdamParams p{static_cast<float>(r),
                      static_cast<float>(zeta),
                      static_cast<float>(lr),
                      static_cast<float>(l2),
                      static_cast<float>(b1),
                      static_cast<float>(b2),
                      static_cast<float>(one_minus_b1),
                      static_cast<float>(one_minus_b2),
                      static_cast<float>(eps),
                      1.0f,
                      0};
  sparse_update_launch(tables.data(), static_cast<int>(tables.size()), p,
                       step, ok, at::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// r, k, v, w [bh, seq, n] f32; u [bh, n]; y [bh, seq, n], s_out
// [bh, n, n] and s_chunks, [bh, seq / chunk, n, n] for the state entering
// each chunk or [bh, 0, n, n] (not kept), allocated by the caller, and the
// segment carry's scratch: s_loc, s_in [bh, G-1, n, n] and p_seg
// [bh, G-1, n] for G segments of `segment` chunks.
void wkv6_chunked(torch::Tensor r, torch::Tensor k, torch::Tensor v,
                  torch::Tensor w, torch::Tensor u, torch::Tensor y,
                  torch::Tensor s_out, torch::Tensor s_chunks,
                  torch::Tensor s_loc, torch::Tensor p_seg,
                  torch::Tensor s_in, int64_t chunk, int64_t segment) {
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
  for (const auto& t : {u, s_out, s_chunks, s_loc, p_seg, s_in}) {
    TORCH_CHECK(t.is_cuda() && t.device() == r.device() &&
                    t.scalar_type() == torch::kFloat32 && t.is_contiguous(),
                "u, s_out, s_chunks and the scratch must be contiguous "
                "float32 on r's device");
  }
  const bool keep = s_chunks.dim() == 4 && s_chunks.size(1) > 0;
  const std::vector<int64_t> kept_shape{bh, keep ? n_chunks : 0, n, n};
  TORCH_CHECK(s_chunks.sizes() == c10::IntArrayRef(kept_shape),
              "s_chunks must be [BH, S / chunk, N, N] or [BH, 0, N, N]");
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
                      s_out.data_ptr<float>(),
                      keep ? s_chunks.data_ptr<float>() : nullptr,
                      s_loc.data_ptr<float>(),
                      p_seg.data_ptr<float>(), s_in.data_ptr<float>(),
                      static_cast<int>(bh), static_cast<int>(seq),
                      static_cast<int>(n), static_cast<int>(chunk),
                      static_cast<int>(segment),
                      at::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// The chunked WKV6 scan's gradients: dr, dk, dv, dw [bh, seq, n] and du
// [bh, n] written, from the forward's inputs, the state entering each
// chunk (s_chunks [bh, seq / chunk, n, n]) and the cotangents gy (y's
// shape) and gs (the final state's, [bh, n, n]).
void wkv6_backward(torch::Tensor r, torch::Tensor k, torch::Tensor v,
                   torch::Tensor w, torch::Tensor u, torch::Tensor s_chunks,
                   torch::Tensor gy, torch::Tensor gs, torch::Tensor dr,
                   torch::Tensor dk, torch::Tensor dv, torch::Tensor dw,
                   torch::Tensor du, int64_t chunk) {
  TORCH_CHECK(r.dim() == 3, "r must be [BH, S, N]");
  for (const auto& [t, name] :
       std::vector<std::pair<torch::Tensor, const char*>>{
           {r, "r"}, {k, "k"}, {v, "v"}, {w, "w"}, {gy, "gy"}, {dr, "dr"},
           {dk, "dk"}, {dv, "dv"}, {dw, "dw"}}) {
    check_table(t, name, r);
  }
  const int64_t bh = r.size(0), seq = r.size(1), n = r.size(2);
  TORCH_CHECK(n >= 1 && n <= kWkv6MaxN, "head size ", n, " outside [1, ",
              kWkv6MaxN, "]");
  TORCH_CHECK(chunk >= 1 && chunk <= kWkv6MaxChunk, "chunk ", chunk,
              " outside [1, ", kWkv6MaxChunk, "]");
  TORCH_CHECK(seq % chunk == 0, "seq len ", seq, " is no multiple of chunk ",
              chunk);
  TORCH_CHECK(bh <= INT32_MAX && seq <= INT32_MAX, "r is too large");
  for (const auto& t : {u, du, s_chunks, gs}) {
    TORCH_CHECK(t.is_cuda() && t.device() == r.device() &&
                    t.scalar_type() == torch::kFloat32 && t.is_contiguous(),
                "u, du, s_chunks and gs must be contiguous float32 on r's "
                "device");
  }
  const std::vector<int64_t> u_shape{bh, n}, s_shape{bh, n, n},
      kept_shape{bh, seq / chunk, n, n};
  TORCH_CHECK(u.sizes() == c10::IntArrayRef(u_shape) &&
                  du.sizes() == c10::IntArrayRef(u_shape),
              "u and du must be [BH, N]");
  TORCH_CHECK(gs.sizes() == c10::IntArrayRef(s_shape),
              "gs must be [BH, N, N]");
  TORCH_CHECK(s_chunks.sizes() == c10::IntArrayRef(kept_shape),
              "s_chunks must be [BH, S / chunk, N, N]");
  const c10::cuda::CUDAGuard guard(r.device());
  C10_CUDA_CHECK(wkv6_backward_launch(
      r.data_ptr<float>(), k.data_ptr<float>(), v.data_ptr<float>(),
      w.data_ptr<float>(), u.data_ptr<float>(), s_chunks.data_ptr<float>(),
      gy.data_ptr<float>(), gs.data_ptr<float>(), dr.data_ptr<float>(),
      dk.data_ptr<float>(), dv.data_ptr<float>(), dw.data_ptr<float>(),
      du.data_ptr<float>(), static_cast<int>(bh), static_cast<int>(seq),
      static_cast<int>(n), static_cast<int>(chunk),
      at::cuda::getCurrentCUDAStream().stream()));
}

// For each group i, grads[i] [rows, D_i] f32 (zeroed by the caller) = the
// segmented sum of grad_outs[i]'s rows ([n, D_i] f32) in sorted order:
// sorted_keys [n] int32 (each key's positions contiguous; outside [0,
// rows) dropped), perm [n] int64 the grad_out row of each sorted
// position; the scratch two levels of embedding_backward_next(n) entries
// each: scratch_keys [2, cap] int32, scratch_vals [2, cap * sum(D_i)] f32.
void embedding_backward(torch::Tensor sorted_keys, torch::Tensor perm,
                        std::vector<torch::Tensor> grad_outs,
                        std::vector<torch::Tensor> grads,
                        torch::Tensor scratch_keys,
                        torch::Tensor scratch_vals) {
  TORCH_CHECK(!grads.empty() && grads.size() == grad_outs.size() &&
                  grads.size() <= kEmbedBwdMaxGroups,
              "one to ", kEmbedBwdMaxGroups,
              " groups, a grad_out and a grad each");
  const torch::Tensor& like = grads[0];
  TORCH_CHECK(like.dim() == 2, "grad must be [rows, D]");
  TORCH_CHECK(like.size(0) <= INT32_MAX, "grad has too many rows");
  const int64_t n = sorted_keys.numel();
  TORCH_CHECK(n <= INT32_MAX, "too many keys");
  const int64_t cap = embedding_backward_next(n);
  check_vec(sorted_keys, "sorted_keys", torch::kInt32, n, like);
  check_vec(perm, "perm", torch::kInt64, n, like);
  std::vector<EmbedBwdGroup> groups;
  int64_t width = 0;
  for (size_t i = 0; i < grads.size(); ++i) {
    const torch::Tensor& grad = grads[i];
    const torch::Tensor& grad_out = grad_outs[i];
    TORCH_CHECK(grad.is_cuda() && grad.device() == like.device() &&
                    grad.scalar_type() == torch::kFloat32 &&
                    grad.is_contiguous() && grad.dim() == 2 &&
                    grad.size(0) == like.size(0),
                "each grad must be a contiguous float32 [rows, D] tensor on "
                "the first one's device");
    const int64_t dim = grad.size(1);
    TORCH_CHECK(dim >= 1 && dim <= INT32_MAX, "D must be >= 1");
    TORCH_CHECK(grad_out.is_cuda() && grad_out.device() == like.device() &&
                    grad_out.scalar_type() == torch::kFloat32 &&
                    grad_out.is_contiguous() && grad_out.dim() == 2 &&
                    grad_out.size(0) == n && grad_out.size(1) == dim,
                "grad_out must be a contiguous float32 [n, D] tensor on "
                "grad's device, D its grad's");
    groups.push_back({grad_out.data_ptr<float>(), grad.data_ptr<float>(),
                      static_cast<int>(dim)});
    width += dim;
  }
  const std::vector<int64_t> keys_shape{2, cap}, vals_shape{2, cap * width};
  TORCH_CHECK(scratch_keys.is_cuda() &&
                  scratch_keys.device() == like.device() &&
                  scratch_keys.scalar_type() == torch::kInt32 &&
                  scratch_keys.is_contiguous() &&
                  scratch_keys.sizes() == c10::IntArrayRef(keys_shape),
              "scratch_keys must be contiguous int32 [2, ", cap, "]");
  TORCH_CHECK(scratch_vals.is_cuda() &&
                  scratch_vals.device() == like.device() &&
                  scratch_vals.scalar_type() == torch::kFloat32 &&
                  scratch_vals.is_contiguous() &&
                  scratch_vals.sizes() == c10::IntArrayRef(vals_shape),
              "scratch_vals must be contiguous float32 [2, ", cap * width,
              "]");
  const c10::cuda::CUDAGuard guard(like.device());
  C10_CUDA_CHECK(embedding_backward_launch(
      sorted_keys.data_ptr<int>(),
      reinterpret_cast<const long long*>(perm.data_ptr<int64_t>()), n,
      static_cast<int>(like.size(0)), groups.data(),
      static_cast<int>(groups.size()), scratch_keys.data_ptr<int>(),
      scratch_vals.data_ptr<float>(),
      at::cuda::getCurrentCUDAStream().stream()));
}

// f32, contiguous, on xs's device, of the given shape.
void check_shaped(const torch::Tensor& t, const char* name,
                  std::vector<int64_t> shape, const torch::Tensor& like) {
  TORCH_CHECK(t.is_cuda() && t.device() == like.device(), name,
              " must be a CUDA tensor on xs's device");
  TORCH_CHECK(t.scalar_type() == torch::kFloat32, name, " must be float32");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK(t.sizes() == c10::IntArrayRef(shape), name, " must be ",
              c10::IntArrayRef(shape), ", got ", t.sizes());
}

// The Mamba-2 scan's shapes from xs [B, S, H, P] and bmat [B, S, N],
// checked against the kernels' limits: {B, S, H, P, N}.
std::vector<int64_t> ssd_shapes(const torch::Tensor& xs,
                                const torch::Tensor& bmat) {
  TORCH_CHECK(xs.dim() == 4, "xs must be [B, S, H, P]");
  TORCH_CHECK(bmat.dim() == 3, "bmat must be [B, S, N]");
  const int64_t b = xs.size(0), s = xs.size(1), h = xs.size(2),
                p = xs.size(3), n = bmat.size(2);
  TORCH_CHECK(s >= 1, "the scan needs at least one token");
  TORCH_CHECK(n >= 1 && n <= kSsdMaxN, "state size ", n, " outside [1, ",
              kSsdMaxN, "]");
  TORCH_CHECK(b >= 1 && b <= 65535 && h >= 1 && h <= 65535 && p >= 1,
              "batch and heads must be in [1, 65535], P >= 1");
  TORCH_CHECK(s <= INT32_MAX && p <= INT32_MAX, "xs is too large");
  return {b, s, h, p, n};
}

// The forward: y [B, S, H, P] and s_fin [B, H, P, N] written; s_chunks
// [B, H, ceil(S / kSsdChunk), P, N] the state at each chunk's start, or
// [B, H, 0, P, N] (not kept). With G segments of `segment` chunks, s_loc
// and s_in [B, H, G-1, P, N] and log_decay [B, H, G-1] are scratch.
void ssd_scan_forward(torch::Tensor xs, torch::Tensor bmat,
                      torch::Tensor cmat, torch::Tensor dt,
                      torch::Tensor a_log, torch::Tensor d_skip,
                      torch::Tensor y, torch::Tensor s_fin,
                      torch::Tensor s_chunks, torch::Tensor s_loc,
                      torch::Tensor log_decay, torch::Tensor s_in,
                      int64_t segment) {
  const auto d = ssd_shapes(xs, bmat);
  const int64_t b = d[0], s = d[1], h = d[2], p = d[3], n = d[4];
  const int64_t chunks = (s + kSsdChunk - 1) / kSsdChunk;
  TORCH_CHECK(segment >= 1 && segment <= INT32_MAX, "segment ", segment,
              " must be >= 1");
  const int64_t segs = (chunks + segment - 1) / segment;
  check_shaped(xs, "xs", {b, s, h, p}, xs);
  check_shaped(bmat, "bmat", {b, s, n}, xs);
  check_shaped(cmat, "cmat", {b, s, n}, xs);
  check_shaped(dt, "dt", {b, s, h}, xs);
  check_shaped(a_log, "a_log", {h}, xs);
  check_shaped(d_skip, "d_skip", {h}, xs);
  check_shaped(y, "y", {b, s, h, p}, xs);
  check_shaped(s_fin, "s_fin", {b, h, p, n}, xs);
  const bool keep = s_chunks.numel() > 0;
  check_shaped(s_chunks, "s_chunks", {b, h, keep ? chunks : 0, p, n}, xs);
  check_shaped(s_loc, "s_loc", {b, h, segs - 1, p, n}, xs);
  check_shaped(s_in, "s_in", {b, h, segs - 1, p, n}, xs);
  check_shaped(log_decay, "log_decay", {b, h, segs - 1}, xs);
  const c10::cuda::CUDAGuard guard(xs.device());
  C10_CUDA_CHECK(ssd_scan_forward_launch(
      xs.data_ptr<float>(), bmat.data_ptr<float>(), cmat.data_ptr<float>(),
      dt.data_ptr<float>(), a_log.data_ptr<float>(),
      d_skip.data_ptr<float>(), y.data_ptr<float>(), s_fin.data_ptr<float>(),
      keep ? s_chunks.data_ptr<float>() : nullptr, s_loc.data_ptr<float>(),
      log_decay.data_ptr<float>(), s_in.data_ptr<float>(),
      static_cast<int>(b), static_cast<int>(s), static_cast<int>(h),
      static_cast<int>(p), static_cast<int>(n), static_cast<int>(segment),
      at::cuda::getCurrentCUDAStream().stream()));
}

// The backward: the six gradients (each of its input's shape) written,
// from the forward's inputs, its kept chunk states and the cotangents gy
// and gs; part_b, part_c [B, S, H, R, N], part_dt [B, S, H, R] ([B, S,
// H, 0] when R = 1: the scan writes gdt) and part_h [2, B, H, R] are
// scratch, R = ceil(P / kSsdRows) groups of rows.
void ssd_scan_backward(torch::Tensor xs, torch::Tensor bmat,
                       torch::Tensor cmat, torch::Tensor dt,
                       torch::Tensor a_log, torch::Tensor d_skip,
                       torch::Tensor s_chunks, torch::Tensor gy,
                       torch::Tensor gs, torch::Tensor gx, torch::Tensor gb,
                       torch::Tensor gc, torch::Tensor gdt,
                       torch::Tensor ga_log, torch::Tensor gd,
                       torch::Tensor part_b, torch::Tensor part_c,
                       torch::Tensor part_dt, torch::Tensor part_h) {
  const auto d = ssd_shapes(xs, bmat);
  const int64_t b = d[0], s = d[1], h = d[2], p = d[3], n = d[4];
  const int64_t chunks = (s + kSsdChunk - 1) / kSsdChunk;
  const int64_t groups = (p + kSsdRows - 1) / kSsdRows;
  for (const auto& [t, name] :
       std::vector<std::pair<torch::Tensor, const char*>>{
           {xs, "xs"}, {gy, "gy"}, {gx, "gx"}}) {
    check_shaped(t, name, {b, s, h, p}, xs);
  }
  for (const auto& [t, name] :
       std::vector<std::pair<torch::Tensor, const char*>>{
           {bmat, "bmat"}, {cmat, "cmat"}, {gb, "gb"}, {gc, "gc"}}) {
    check_shaped(t, name, {b, s, n}, xs);
  }
  check_shaped(dt, "dt", {b, s, h}, xs);
  check_shaped(gdt, "gdt", {b, s, h}, xs);
  for (const auto& [t, name] :
       std::vector<std::pair<torch::Tensor, const char*>>{
           {a_log, "a_log"}, {d_skip, "d_skip"}, {ga_log, "ga_log"},
           {gd, "gd"}}) {
    check_shaped(t, name, {h}, xs);
  }
  check_shaped(s_chunks, "s_chunks", {b, h, chunks, p, n}, xs);
  check_shaped(gs, "gs", {b, h, p, n}, xs);
  check_shaped(part_b, "part_b", {b, s, h, groups, n}, xs);
  check_shaped(part_c, "part_c", {b, s, h, groups, n}, xs);
  check_shaped(part_dt, "part_dt", {b, s, h, groups > 1 ? groups : 0}, xs);
  check_shaped(part_h, "part_h", {2, b, h, groups}, xs);
  const c10::cuda::CUDAGuard guard(xs.device());
  C10_CUDA_CHECK(ssd_scan_backward_launch(
      xs.data_ptr<float>(), bmat.data_ptr<float>(), cmat.data_ptr<float>(),
      dt.data_ptr<float>(), a_log.data_ptr<float>(),
      d_skip.data_ptr<float>(), s_chunks.data_ptr<float>(),
      gy.data_ptr<float>(), gs.data_ptr<float>(), gx.data_ptr<float>(),
      gb.data_ptr<float>(), gc.data_ptr<float>(), gdt.data_ptr<float>(),
      ga_log.data_ptr<float>(), gd.data_ptr<float>(),
      part_b.data_ptr<float>(), part_c.data_ptr<float>(),
      part_dt.data_ptr<float>(), part_h.data_ptr<float>(),
      static_cast<int>(b), static_cast<int>(s), static_cast<int>(h),
      static_cast<int>(p), static_cast<int>(n),
      at::cuda::getCurrentCUDAStream().stream()));
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, mod) {
  mod.def("cowclip_adam_", &cowclip_adam_,
          "fused CowClip + coupled-L2 + Adam update of (w, m, v), in place");
  mod.def("sparse_gather_catchup", &sparse_gather_catchup,
          "gather the unique-id slot rows of a list of tables with "
          "closed-form lazy-decay catch-up, one launch");
  mod.def("sparse_update_scatter_", &sparse_update_scatter_,
          "CowClip + coupled-L2 + Adam on the slot rows of a list of "
          "tables, scattered in place, one launch");
  mod.def("wkv6_chunked", &wkv6_chunked,
          "chunked RWKV-6 WKV scan: y, the final state and, when its "
          "tensor is not empty, the state entering each chunk, written "
          "into the given outputs");
  mod.def("wkv6_backward", &wkv6_backward,
          "the chunked RWKV-6 WKV scan's five gradients from the kept "
          "chunk states, written into the given outputs; deterministic");
  mod.def("embedding_backward", &embedding_backward,
          "the gradients of gathers of one or more groups at the same keys, "
          "as a sorted segmented sum in a fixed order, into the given "
          "zeroed grads, one call");
  mod.def("ssd_scan_forward", &ssd_scan_forward,
          "Mamba-2 selective scan: y, the final state and, when its "
          "tensor is not empty, the state at each chunk's start, written "
          "into the given outputs");
  mod.def("ssd_scan_backward", &ssd_scan_backward,
          "the Mamba-2 scan's six gradients from the kept chunk states, "
          "written into the given outputs; deterministic");
}
