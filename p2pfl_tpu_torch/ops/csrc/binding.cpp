// PyTorch binding of the port's Hopper kernels: the only source that
// includes PyTorch's headers. Each function checks its tensors, allocates
// its outputs with torch::empty, launches on the current stream and
// checks the launch; the kernels themselves live in the .cu files.
#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

#include "kernels.h"

namespace {

void check(const torch::Tensor& t, const char* name, at::ScalarType dtype,
           int64_t dim) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == dtype, name, " must be ", dtype, ", got ",
              t.scalar_type());
  TORCH_CHECK(t.dim() == dim, name, " must have ", dim, " dims, got ",
              t.dim());
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

void same_device(const torch::Tensor& a, const torch::Tensor& b) {
  TORCH_CHECK(a.device() == b.device(), "operands on different devices");
}

int as_int(int64_t v, const char* name) {
  TORCH_CHECK(v >= 0 && v <= INT32_MAX, name, " out of int range: ", v);
  return static_cast<int>(v);
}

torch::Tensor stream_gemm(torch::Tensor x, torch::Tensor w) {
  check(x, "x", at::kBFloat16, 3);
  check(w, "w", at::kBFloat16, 3);
  same_device(x, w);
  TORCH_CHECK(x.size(0) == w.size(0) && x.size(2) == w.size(1),
              "stream_gemm shapes ", x.sizes(), " @ ", w.sizes());
  const c10::cuda::CUDAGuard guard(x.device());
  auto out = torch::empty({x.size(0), x.size(1), w.size(2)}, x.options());
  if (out.numel() == 0) return out;
  p2pfl::launch_stream_gemm(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                            as_int(x.size(0), "n"), as_int(x.size(1), "M"),
                            as_int(x.size(2), "K"), as_int(w.size(2), "N"),
                            at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

torch::Tensor stream_wgrad(torch::Tensor x, torch::Tensor g) {
  check(x, "x", at::kBFloat16, 3);
  check(g, "g", at::kBFloat16, 3);
  same_device(x, g);
  TORCH_CHECK(x.size(0) == g.size(0) && x.size(1) == g.size(1),
              "stream_wgrad shapes ", x.sizes(), " ^T@ ", g.sizes());
  const c10::cuda::CUDAGuard guard(x.device());
  const int n = as_int(x.size(0), "n"), M = as_int(x.size(1), "M");
  const int K = as_int(x.size(2), "K"), N = as_int(g.size(2), "N");
  auto f32 = x.options().dtype(at::kFloat);
  auto out = torch::empty({n, K, N}, f32);
  if (out.numel() == 0) return out;
  if (M == 0) return out.zero_();
  auto partial = torch::empty(
      {n, static_cast<int64_t>(p2pfl::wgrad_splits(M)), K, N}, f32);
  p2pfl::launch_stream_wgrad(x.data_ptr(), g.data_ptr(),
                             partial.data_ptr<float>(), out.data_ptr<float>(),
                             n, M, K, N, at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

std::vector<torch::Tensor> dense_bwd(torch::Tensor x, torch::Tensor w,
                                     torch::Tensor g) {
  check(x, "x", at::kBFloat16, 3);
  check(w, "w", at::kBFloat16, 3);
  check(g, "g", at::kBFloat16, 3);
  same_device(x, w);
  same_device(x, g);
  TORCH_CHECK(x.size(0) == w.size(0) && x.size(0) == g.size(0) &&
                  x.size(2) == w.size(1) && x.size(1) == g.size(1) &&
                  w.size(2) == g.size(2),
              "dense_bwd shapes x ", x.sizes(), " w ", w.sizes(), " g ",
              g.sizes());
  const c10::cuda::CUDAGuard guard(x.device());
  auto dx = torch::empty_like(x);
  auto dw = torch::empty_like(w);
  if (dx.numel() == 0 && dw.numel() == 0) return {dx, dw};
  p2pfl::launch_dense_bwd(x.data_ptr(), w.data_ptr(), g.data_ptr(),
                          dx.data_ptr(), dw.data_ptr(),
                          as_int(x.size(0), "n"), as_int(x.size(1), "B"),
                          as_int(x.size(2), "D"), as_int(w.size(2), "H"),
                          at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {dx, dw};
}

std::vector<torch::Tensor> sgd(torch::Tensor p, torch::Tensor m,
                               torch::Tensor g, torch::Tensor lr,
                               double decay) {
  check(p, "p", at::kFloat, 2);
  check(g, "g", at::kFloat, 2);
  check(lr, "lr", at::kFloat, 1);
  TORCH_CHECK(m.is_cuda() && m.dim() == 2 && m.is_contiguous(),
              "m must be a contiguous 2-D CUDA tensor");
  TORCH_CHECK(m.scalar_type() == at::kFloat ||
                  m.scalar_type() == at::kBFloat16,
              "m must be float32 or bfloat16");
  same_device(p, m);
  same_device(p, g);
  same_device(p, lr);
  TORCH_CHECK(p.sizes() == m.sizes() && p.sizes() == g.sizes() &&
                  lr.size(0) == p.size(0),
              "sgd shapes p ", p.sizes(), " m ", m.sizes(), " g ", g.sizes(),
              " lr ", lr.sizes());
  const c10::cuda::CUDAGuard guard(p.device());
  auto p_out = torch::empty_like(p);
  auto m_out = torch::empty_like(m);
  p2pfl::launch_sgd(p.data_ptr<float>(), m.data_ptr(), g.data_ptr<float>(),
                    lr.data_ptr<float>(), p_out.data_ptr<float>(),
                    m_out.data_ptr(), static_cast<float>(decay),
                    m.scalar_type() == at::kBFloat16 ? 1 : 0, p.size(0),
                    p.size(1), at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {p_out, m_out};
}

void check_float_or_bf16(const torch::Tensor& t, const char* name) {
  TORCH_CHECK(t.is_cuda() && t.dim() == 2 && t.is_contiguous(), name,
              " must be a contiguous 2-D CUDA tensor");
  TORCH_CHECK(t.scalar_type() == at::kFloat ||
                  t.scalar_type() == at::kBFloat16,
              name, " must be float32 or bfloat16, got ", t.scalar_type());
}

std::vector<torch::Tensor> sgd_accum(torch::Tensor p, torch::Tensor m,
                                     torch::Tensor g, torch::Tensor lr,
                                     torch::Tensor acc, torch::Tensor w,
                                     double decay) {
  check_float_or_bf16(p, "p");
  check_float_or_bf16(m, "m");
  check(g, "g", p.scalar_type(), 2);
  check(lr, "lr", at::kFloat, 1);
  check(acc, "acc", at::kFloat, 2);
  check(w, "w", at::kFloat, 1);
  for (const auto* t : {&m, &g, &lr, &acc, &w}) same_device(p, *t);
  TORCH_CHECK(p.sizes() == m.sizes() && p.sizes() == g.sizes() &&
                  p.sizes() == acc.sizes() && lr.size(0) == p.size(0) &&
                  w.size(0) == p.size(0),
              "sgd_accum shapes p ", p.sizes(), " m ", m.sizes(), " g ",
              g.sizes(), " acc ", acc.sizes(), " lr ", lr.sizes(), " w ",
              w.sizes());
  const c10::cuda::CUDAGuard guard(p.device());
  auto p_out = torch::empty_like(p);
  auto m_out = torch::empty_like(m);
  auto acc_out = torch::empty_like(acc);
  p2pfl::launch_sgd_accum(
      p.data_ptr(), m.data_ptr(), g.data_ptr(), lr.data_ptr<float>(),
      acc.data_ptr<float>(), w.data_ptr<float>(), p_out.data_ptr(),
      m_out.data_ptr(), acc_out.data_ptr<float>(), static_cast<float>(decay),
      p.scalar_type() == at::kBFloat16 ? 1 : 0,
      m.scalar_type() == at::kBFloat16 ? 1 : 0, p.size(0), p.size(1),
      at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {p_out, m_out, acc_out};
}

torch::Tensor fedavg_accum(torch::Tensor p, torch::Tensor acc,
                           torch::Tensor w) {
  check_float_or_bf16(p, "p");
  check(acc, "acc", at::kFloat, 2);
  check(w, "w", at::kFloat, 1);
  same_device(p, acc);
  same_device(p, w);
  TORCH_CHECK(p.sizes() == acc.sizes() && w.size(0) == p.size(0),
              "fedavg_accum shapes p ", p.sizes(), " acc ", acc.sizes(),
              " w ", w.sizes());
  const c10::cuda::CUDAGuard guard(p.device());
  auto acc_out = torch::empty_like(acc);
  p2pfl::launch_fedavg_accum(p.data_ptr(), acc.data_ptr<float>(),
                             w.data_ptr<float>(), acc_out.data_ptr<float>(),
                             p.scalar_type() == at::kBFloat16 ? 1 : 0,
                             p.size(0), p.size(1),
                             at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return acc_out;
}

// K6: trains `state` (w0, b0, w1, b1, w2, b2 and their traces, f32, the
// caller's copies) in place; returns the per-node mean loss.
torch::Tensor fused_mlp_train_epoch(std::vector<torch::Tensor> state,
                                    torch::Tensor bx, torch::Tensor by,
                                    int64_t batch, double lr, double beta) {
  TORCH_CHECK(state.size() == 12, "state holds 6 params and 6 traces");
  check(bx, "bx", at::kFloat, 3);
  TORCH_CHECK(by.is_cuda() && by.dim() == 3 && by.size(2) == 1 &&
                  by.is_contiguous(),
              "by must be a contiguous [n, rows, 1] CUDA tensor");
  TORCH_CHECK(by.scalar_type() == at::kInt || by.scalar_type() == at::kLong,
              "by must be int32 or int64, got ", by.scalar_type());
  same_device(bx, by);
  const int64_t n = bx.size(0), rows = bx.size(1), d_in = bx.size(2);
  const int64_t d1 = state[0].size(-1), d2 = state[2].size(-1);
  const int64_t C = state[4].size(-1);
  const std::vector<std::vector<int64_t>> shapes = {
      {n, d_in, d1}, {n, 1, d1}, {n, d1, d2}, {n, 1, d2}, {n, d2, C},
      {n, 1, C}};
  for (int i = 0; i < 12; ++i) {
    check(state[i], "state", at::kFloat, 3);
    same_device(bx, state[i]);
    TORCH_CHECK(state[i].sizes() == at::IntArrayRef(shapes[i % 6]),
                "fused epoch leaf ", i % 6, (i < 6 ? " (params)" : " (trace)"),
                " has shape ", state[i].sizes(), ", want ",
                at::IntArrayRef(shapes[i % 6]));
  }
  TORCH_CHECK(by.size(0) == n && by.size(1) == rows, "by shape ", by.sizes(),
              " for bx ", bx.sizes());
  TORCH_CHECK(batch > 0 && rows % batch == 0, "rows (", rows,
              ") must be a positive multiple of batch (", batch, ")");
  const c10::cuda::CUDAGuard guard(bx.device());
  auto f32 = bx.options();
  auto loss = torch::empty({n}, f32);
  const int B = as_int(batch, "batch");
  auto scratch = torch::empty(
      {n, p2pfl::fused_mlp_scratch_floats(B, as_int(d1, "d1"),
                                          as_int(d2, "d2"), as_int(C, "C"))},
      f32);
  float* params[6];
  float* mom[6];
  for (int i = 0; i < 6; ++i) {
    params[i] = state[i].data_ptr<float>();
    mom[i] = state[i + 6].data_ptr<float>();
  }
  p2pfl::launch_fused_mlp_epoch(
      bx.data_ptr<float>(), by.data_ptr(),
      by.scalar_type() == at::kLong ? 1 : 0, params, mom,
      scratch.data_ptr<float>(), loss.data_ptr<float>(), as_int(n, "n"),
      as_int(rows, "rows"), as_int(rows / batch, "steps"), B,
      as_int(d_in, "d_in"), as_int(d1, "d1"), as_int(d2, "d2"),
      as_int(C, "C"), static_cast<float>(lr), static_cast<float>(beta),
      at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return loss;
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("stream_gemm", &stream_gemm, "K1: [n,M,K] @ [n,K,N], bf16");
  m.def("stream_wgrad", &stream_wgrad, "K2: [n,M,K]^T @ [n,M,N] -> f32");
  m.def("dense_bwd", &dense_bwd, "K3: fused dx, dw of y = x @ w");
  m.def("sgd", &sgd, "K4: SGD-with-momentum step over [n, numel]");
  m.def("sgd_accum", &sgd_accum, "K5: K4 plus acc + w * p' over [n, numel]");
  m.def("fedavg_accum", &fedavg_accum, "K5 null form: acc + w * p");
  m.def("fused_mlp_train_epoch", &fused_mlp_train_epoch,
        "K6: one SGD-with-momentum epoch of a 3-layer MLP per node");
}
