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

// Error messages are built here without iostreams: an integer formatted
// into c10::str's ostringstream crashed this extension with a
// segmentation fault on the card's PyTorch build, so every check passes
// one std::string.
std::string piece(const char* s) { return s; }
std::string piece(const std::string& s) { return s; }
std::string piece(at::ScalarType t) { return c10::toString(t); }
std::string piece(const c10::Device& d) { return d.str(); }
std::string piece(at::IntArrayRef a) {
  std::string s = "[";
  for (size_t i = 0; i < a.size(); ++i)
    s += (i ? ", " : "") + std::to_string(a[i]);
  return s + "]";
}
template <typename I, std::enable_if_t<std::is_integral_v<I>, int> = 0>
std::string piece(I v) {
  return std::to_string(v);
}
template <typename... A>
std::string msg(const A&... a) {
  return (std::string() + ... + piece(a));
}

void check(const torch::Tensor& t, const char* name, at::ScalarType dtype,
           int64_t dim) {
  TORCH_CHECK(t.is_cuda(), msg(name, " must be a CUDA tensor"));
  TORCH_CHECK(t.scalar_type() == dtype,
              msg(name, " must be ", dtype, ", got ", t.scalar_type()));
  TORCH_CHECK(t.dim() == dim,
              msg(name, " must have ", dim, " dims, got ", t.dim()));
  TORCH_CHECK(t.is_contiguous(), msg(name, " must be contiguous"));
}

void same_device(const torch::Tensor& a, const torch::Tensor& b) {
  TORCH_CHECK(a.device() == b.device(), "operands on different devices");
}

int as_int(int64_t v, const char* name) {
  TORCH_CHECK(v >= 0 && v <= INT32_MAX,
              msg(name, " out of int range: ", v));
  return static_cast<int>(v);
}

// K1-K3 take bf16 or f32 operands, one dtype a call: the dtype picks
// the instantiation (the f32 ones are gemm_f32_tc.cu's; K1 and K3 take
// scratch for their split small operand).
at::ScalarType gemm_dtype(const torch::Tensor& x) {
  TORCH_CHECK(x.scalar_type() == at::kBFloat16 ||
                  x.scalar_type() == at::kFloat,
              msg("x must be bfloat16 or float32, got ", x.scalar_type()));
  return x.scalar_type();
}

// The branch of K1's last launch, as its launcher chose it
// (stream_gemm_last_branch).
int last_gemm_branch = -1;

torch::Tensor stream_gemm(torch::Tensor x, torch::Tensor w) {
  const at::ScalarType dt = gemm_dtype(x);
  check(x, "x", dt, 3);
  check(w, "w", dt, 3);
  same_device(x, w);
  TORCH_CHECK(x.size(0) == w.size(0) && x.size(2) == w.size(1),
              msg("stream_gemm shapes ", x.sizes(), " @ ", w.sizes()));
  const c10::cuda::CUDAGuard guard(x.device());
  auto out = torch::empty({x.size(0), x.size(1), w.size(2)}, x.options());
  if (out.numel() == 0) return out;
  const int n = as_int(x.size(0), "n"), M = as_int(x.size(1), "M");
  const int K = as_int(x.size(2), "K"), N = as_int(w.size(2), "N");
  if (dt == at::kFloat) {
    last_gemm_branch = p2pfl::stream_gemm_f32_branch(K);
    auto scratch = torch::empty({p2pfl::stream_gemm_f32_scratch(n, K, N)},
                                x.options());
    p2pfl::launch_stream_gemm_f32(x.data_ptr<float>(), w.data_ptr<float>(),
                                  out.data_ptr<float>(),
                                  scratch.data_ptr<float>(), n, M, K, N,
                                  at::cuda::getCurrentCUDAStream());
  } else {
    last_gemm_branch = p2pfl::stream_gemm_branch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), n, M, K, N);
    p2pfl::launch_stream_gemm(x.data_ptr(), w.data_ptr(), out.data_ptr(), n,
                              M, K, N, at::cuda::getCurrentCUDAStream());
  }
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

// The branch (p2pfl::GemmBranch) of K1's last launch.
int64_t stream_gemm_last_branch() {
  TORCH_CHECK(last_gemm_branch >= 0, "stream_gemm has not launched yet");
  return last_gemm_branch;
}

// K2 with the caller's slice plan (ops/gemm.py::wgrad_plan): `route`
// the plan's route code (p2pfl::WgradRoute), checked here against the
// dtype and the shape, `rows` the rows of a slice, `slices` the slices
// of a node.
torch::Tensor stream_wgrad(torch::Tensor x, torch::Tensor g, int64_t route,
                           int64_t rows, int64_t slices) {
  const at::ScalarType dt = gemm_dtype(x);
  const bool f32 = dt == at::kFloat;
  check(x, "x", dt, 3);
  check(g, "g", dt, 3);
  same_device(x, g);
  TORCH_CHECK(x.size(0) == g.size(0) && x.size(1) == g.size(1),
              msg("stream_wgrad shapes ", x.sizes(), " ^T@ ", g.sizes()));
  const bool f32_route =
      route == p2pfl::kWgradF32Tc || route == p2pfl::kWgradF32Narrow;
  const bool bf16_route = route == p2pfl::kWgradGeneral ||
                          route == p2pfl::kWgradWide ||
                          route == p2pfl::kWgradNarrow;
  TORCH_CHECK(f32 ? f32_route : bf16_route,
              msg("stream_wgrad: route ", route, " does not take ", dt));
  const c10::cuda::CUDAGuard guard(x.device());
  const int n = as_int(x.size(0), "n"), M = as_int(x.size(1), "M");
  const int K = as_int(x.size(2), "K"), N = as_int(g.size(2), "N");
  auto f32_opts = x.options().dtype(at::kFloat);
  auto out = torch::empty({n, K, N}, f32_opts);
  if (out.numel() == 0) return out;
  if (M == 0) return out.zero_();
  const int unit = route == p2pfl::kWgradGeneral  ? p2pfl::kWgradGeneralRows
                   : route == p2pfl::kWgradWide   ? p2pfl::kWgradWideRows
                   : route == p2pfl::kWgradF32Tc  ? p2pfl::kWgradF32TcRows
                   : route == p2pfl::kWgradNarrow ? p2pfl::kWgradNarrowRows
                                                  : p2pfl::kWgradF32NarrowRows;
  TORCH_CHECK(rows > 0 && rows % unit == 0 && slices > 0 &&
                  rows * slices >= M && rows * (slices - 1) < M,
              msg("stream_wgrad: ", slices, " slices of ", rows,
                  " rows do not cut M = ", M, " (rows a multiple of ", unit,
                  ")"));
  const auto aligned = [](const torch::Tensor& t) {
    return reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0;
  };
  if (route == p2pfl::kWgradWide) {
    TORCH_CHECK(K % 8 == 0 && N % 8 == 0 && aligned(x) && aligned(g),
                msg("stream_wgrad: the wide route needs K (", K, ") and N (",
                    N, ") multiples of 8 and 16-byte-aligned operands"));
  }
  if (route == p2pfl::kWgradNarrow) {
    TORCH_CHECK(K <= 32 && N <= 64 && N % 8 == 0 && aligned(g),
                msg("stream_wgrad: the narrow route needs K (", K,
                    ") <= 32, N (", N, ") <= 64 a multiple of 8 and a "
                    "16-byte-aligned g"));
  }
  torch::Tensor partial;
  if (slices > 1) partial = torch::empty({n, slices, K, N}, f32_opts);
  float* part = slices > 1 ? partial.data_ptr<float>() : nullptr;
  if (f32) {
    p2pfl::launch_stream_wgrad_f32(
        x.data_ptr<float>(), g.data_ptr<float>(), part,
        out.data_ptr<float>(), n, M, K, N, static_cast<int>(route),
        as_int(rows, "rows"), as_int(slices, "slices"),
        at::cuda::getCurrentCUDAStream());
  } else {
    p2pfl::launch_stream_wgrad(x.data_ptr(), g.data_ptr(), part,
                               out.data_ptr<float>(), n, M, K, N,
                               static_cast<int>(route), as_int(rows, "rows"),
                               as_int(slices, "slices"),
                               at::cuda::getCurrentCUDAStream());
  }
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

std::vector<torch::Tensor> dense_bwd(torch::Tensor x, torch::Tensor w,
                                     torch::Tensor g) {
  const at::ScalarType dt = gemm_dtype(x);
  check(x, "x", dt, 3);
  check(w, "w", dt, 3);
  check(g, "g", dt, 3);
  same_device(x, w);
  same_device(x, g);
  TORCH_CHECK(x.size(0) == w.size(0) && x.size(0) == g.size(0) &&
                  x.size(2) == w.size(1) && x.size(1) == g.size(1) &&
                  w.size(2) == g.size(2),
              msg("dense_bwd shapes x ", x.sizes(), " w ", w.sizes(), " g ",
                  g.sizes()));
  const c10::cuda::CUDAGuard guard(x.device());
  auto dx = torch::empty_like(x);
  auto dw = torch::empty_like(w);
  if (dx.numel() == 0 && dw.numel() == 0) return {dx, dw};
  const int n = as_int(x.size(0), "n"), B = as_int(x.size(1), "B");
  const int D = as_int(x.size(2), "D"), H = as_int(w.size(2), "H");
  if (dt == at::kFloat) {
    auto scratch = torch::empty({p2pfl::dense_bwd_f32_scratch(n, B, H)},
                                x.options());
    p2pfl::launch_dense_bwd_f32(x.data_ptr<float>(), w.data_ptr<float>(),
                                g.data_ptr<float>(), dx.data_ptr<float>(),
                                dw.data_ptr<float>(),
                                scratch.data_ptr<float>(), n, B, D, H,
                                at::cuda::getCurrentCUDAStream());
  } else {
    p2pfl::launch_dense_bwd(x.data_ptr(), w.data_ptr(), g.data_ptr(),
                            dx.data_ptr(), dw.data_ptr(), n, B, D, H,
                            at::cuda::getCurrentCUDAStream());
  }
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {dx, dw};
}

// The accumulation probe (gemm_f32_tc.cu): a [64, K] @ bt [64, K]^T,
// f32 (tf32-valued for exact products), K a multiple of 8; returns
// (wgmma's sums in one accumulator, one fmaf chain a value).
std::vector<torch::Tensor> wgmma_acc_probe(torch::Tensor a, torch::Tensor bt) {
  check(a, "a", at::kFloat, 2);
  check(bt, "bt", at::kFloat, 2);
  same_device(a, bt);
  TORCH_CHECK(a.size(0) == 64 && bt.size(0) == 64 &&
                  a.size(1) == bt.size(1) && a.size(1) % 8 == 0,
              msg("wgmma_acc_probe shapes ", a.sizes(), " ", bt.sizes()));
  const c10::cuda::CUDAGuard guard(a.device());
  auto d_tc = torch::empty({64, 64}, a.options());
  auto d_chain = torch::empty({64, 64}, a.options());
  p2pfl::launch_wgmma_acc_probe(a.data_ptr<float>(), bt.data_ptr<float>(),
                                d_tc.data_ptr<float>(),
                                d_chain.data_ptr<float>(),
                                as_int(a.size(1), "K"),
                                at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {d_tc, d_chain};
}

// K4 and K5 over a list of leaves (csrc/multi_tensor.cuh). Each leaf is
// a parameter stacked over the n slots of lr / w; one dtype combination
// a list. Non-contiguous operands are copied; an operand whose base is
// not aligned to its vector width (a view with a storage offset) takes
// the kernel's scalar path. Each kind of output is one allocation, which
// the leaves' outputs view at offsets of whole 256-byte lines (one
// allocation, not one a leaf, is what the host pays for). Empty leaves
// get empty outputs and no work. Returns (p', m', acc') — a form's
// unused outputs empty — and the number of launches: one per
// kMaxStreamLeaves non-empty leaves.
using Leaves = std::vector<torch::Tensor>;
using ManyOut = std::tuple<Leaves, Leaves, Leaves, int64_t>;

enum Form { kStep, kStepAccum, kAccum };

void on_device(const torch::Tensor& t, const c10::Device& dev,
               const char* name) {
  TORCH_CHECK_VALUE(t.device() == dev,
                    msg("operands must all be on CPU or all on CUDA (one "
                        "device): ", name, " is on ", t.device(), ", p on ",
                        dev));
}

void float_or_bf16(at::ScalarType t, const char* name) {
  TORCH_CHECK_VALUE(t == at::kFloat || t == at::kBFloat16,
                    msg(name, " must be float32 or bfloat16, got ", t));
}

void per_slot(const torch::Tensor& v, const c10::Device& dev,
              const char* name) {
  on_device(v, dev, name);
  TORCH_CHECK_VALUE(v.scalar_type() == at::kFloat && v.dim() == 1 &&
                        v.is_contiguous(),
                    msg(name, " must be a contiguous 1-D float32 tensor, "
                        "got ", v.scalar_type(), " ", v.sizes()));
}

// `like`'s shape, contiguous, `offset` values into the flat `buf`
torch::Tensor view_of(const torch::Tensor& buf, const torch::Tensor& like,
                      int64_t offset) {
  std::vector<int64_t> strides(like.dim());
  int64_t stride = 1;
  for (int64_t d = like.dim() - 1; d >= 0; --d) {
    strides[d] = stride;
    stride *= like.size(d);
  }
  return buf.as_strided(like.sizes(), strides, offset);
}

ManyOut stream_many(Form form, const Leaves& ps, const Leaves& ms,
                    const Leaves& gs, const Leaves& accs,
                    const torch::Tensor* lr, const torch::Tensor* w,
                    double decay) {
  const bool step = form != kAccum, accum = form != kStep;
  const size_t k = ps.size();
  TORCH_CHECK_VALUE((!step || (ms.size() == k && gs.size() == k)) &&
                        (!accum || accs.size() == k),
                    "leaf lists of unequal lengths");
  Leaves p_out, m_out, acc_out;
  if (k == 0) return {p_out, m_out, acc_out, 0};
  const c10::Device dev = ps[0].device();
  TORCH_CHECK_VALUE(dev.is_cuda(), msg("operands must all be on CPU or all "
                                       "on CUDA: p is on ", dev));
  const at::ScalarType pdt = ps[0].scalar_type();
  const at::ScalarType tdt = step ? ms[0].scalar_type() : at::kFloat;
  float_or_bf16(pdt, "p");
  float_or_bf16(tdt, "m");
  const torch::Tensor& slots = step ? *lr : *w;
  if (step) per_slot(*lr, dev, "lr");
  if (accum) per_slot(*w, dev, "weight");
  TORCH_CHECK_VALUE(!(step && accum) || lr->size(0) == w->size(0),
                    msg("lr ", lr->sizes(), " and weight ", w->sizes(),
                        " differ in slots"));
  const int64_t n = slots.size(0);
  const c10::cuda::CUDAGuard guard(dev);
  Leaves keep;  // contiguous copies, alive until the launches are queued
  auto operand = [&](const torch::Tensor& t, const torch::Tensor& p,
                     at::ScalarType dtype, const char* name) {
    on_device(t, dev, name);
    TORCH_CHECK_VALUE(t.scalar_type() == dtype,
                      msg(name, " must be ", dtype, " as the list's first, "
                          "got ", t.scalar_type()));
    TORCH_CHECK_VALUE(t.sizes() == p.sizes(), msg(name, " has shape ",
                                                  t.sizes(), ", p ",
                                                  p.sizes()));
    if (t.is_contiguous()) return t.data_ptr();
    keep.push_back(t.contiguous());
    return keep.back().data_ptr();
  };
  // the inputs, and each leaf's offset in the flat outputs
  std::vector<p2pfl::StreamLeaf> leaves(k);
  std::vector<int64_t> offset(k);
  int64_t total = 0;
  for (size_t i = 0; i < k; ++i) {
    const torch::Tensor& p = ps[i];
    on_device(p, dev, "p");
    TORCH_CHECK_VALUE(p.scalar_type() == pdt,
                      msg("one dtype for every p of a list: ", pdt, " and ",
                          p.scalar_type()));
    TORCH_CHECK_VALUE(p.dim() >= 1 && p.size(0) == n,
                      msg("leaf ", i, " has shape ", p.sizes(), ", want ", n,
                          " slots first"));
    p2pfl::StreamLeaf& leaf = leaves[i];
    leaf.n = n;
    leaf.numel = n == 0 ? 0 : p.numel() / n;
    leaf.p = operand(p, p, pdt, "p");
    if (step) {
      leaf.m = operand(ms[i], p, tdt, "m");
      leaf.g = operand(gs[i], p, pdt, "g");
    }
    if (accum)
      leaf.acc = static_cast<const float*>(
          operand(accs[i], p, at::kFloat, "acc"));
    offset[i] = total;
    total += (p.numel() + 63) / 64 * 64;
  }
  const auto flat = [&](at::ScalarType dtype) {
    return torch::empty({total}, ps[0].options().dtype(dtype));
  };
  torch::Tensor p_flat, m_flat, acc_flat;
  if (step) {
    p_flat = flat(pdt);
    m_flat = flat(tdt);
  }
  if (accum) acc_flat = flat(at::kFloat);
  std::vector<p2pfl::StreamLeaf> table;
  for (size_t i = 0; i < k; ++i) {
    p2pfl::StreamLeaf& leaf = leaves[i];
    if (step) {
      p_out.push_back(view_of(p_flat, ps[i], offset[i]));
      m_out.push_back(view_of(m_flat, ps[i], offset[i]));
      leaf.p_out = p_out.back().data_ptr();
      leaf.m_out = m_out.back().data_ptr();
    }
    if (accum) {
      acc_out.push_back(view_of(acc_flat, ps[i], offset[i]));
      leaf.acc_out = acc_out.back().data_ptr<float>();
    }
    if (ps[i].numel() > 0) table.push_back(leaf);
  }
  const cudaStream_t stream = at::cuda::getCurrentCUDAStream();
  const int p_bf16 = pdt == at::kBFloat16, t_bf16 = tdt == at::kBFloat16;
  int64_t launched = 0;
  for (size_t first = 0; first < table.size();
       first += p2pfl::kMaxStreamLeaves) {
    const int count = static_cast<int>(std::min<size_t>(
        p2pfl::kMaxStreamLeaves, table.size() - first));
    const p2pfl::StreamLeaf* chunk = table.data() + first;
    if (form == kStep)
      p2pfl::launch_sgd(chunk, count, lr->data_ptr<float>(),
                        static_cast<float>(decay), p_bf16, t_bf16, stream);
    else if (form == kStepAccum)
      p2pfl::launch_sgd_accum(chunk, count, lr->data_ptr<float>(),
                              w->data_ptr<float>(),
                              static_cast<float>(decay), p_bf16, t_bf16,
                              stream);
    else
      p2pfl::launch_fedavg_accum(chunk, count, w->data_ptr<float>(), p_bf16,
                                 stream);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
    ++launched;
  }
  return {p_out, m_out, acc_out, launched};
}

ManyOut sgd(const Leaves& ps, const Leaves& ms, const Leaves& gs,
            const torch::Tensor& lr, double decay) {
  return stream_many(kStep, ps, ms, gs, {}, &lr, nullptr, decay);
}

ManyOut sgd_accum(const Leaves& ps, const Leaves& ms, const Leaves& gs,
                  const torch::Tensor& lr, const Leaves& accs,
                  const torch::Tensor& w, double decay) {
  return stream_many(kStepAccum, ps, ms, gs, accs, &lr, &w, decay);
}

ManyOut fedavg_accum(const Leaves& ps, const Leaves& accs,
                     const torch::Tensor& w) {
  return stream_many(kAccum, ps, {}, {}, accs, nullptr, &w, 0.0);
}

// K6: trains `state` (w0, b0, w1, b1, w2, b2 and their traces, the
// caller's copies, each f32 or bf16) in place; bx f32 or bf16. bf16
// tensors are widened into f32 copies before the epoch and the state is
// narrowed back once after it. Returns the per-node mean loss.
torch::Tensor fused_mlp_train_epoch(std::vector<torch::Tensor> state,
                                    torch::Tensor bx, torch::Tensor by,
                                    int64_t batch, double lr, double beta) {
  TORCH_CHECK(state.size() == 12, "state holds 6 params and 6 traces");
  const auto f32_or_bf16 = [](const torch::Tensor& t) {
    return t.scalar_type() == at::kFloat || t.scalar_type() == at::kBFloat16
               ? t.scalar_type()
               : at::kFloat;  // the check below names the bad dtype
  };
  check(bx, "bx", f32_or_bf16(bx), 3);
  TORCH_CHECK(by.is_cuda() && by.dim() == 3 && by.size(2) == 1 &&
                  by.is_contiguous(),
              "by must be a contiguous [n, rows, 1] CUDA tensor");
  TORCH_CHECK(by.scalar_type() == at::kInt || by.scalar_type() == at::kLong,
              msg("by must be int32 or int64, got ", by.scalar_type()));
  same_device(bx, by);
  const int64_t n = bx.size(0), rows = bx.size(1), d_in = bx.size(2);
  const int64_t d1 = state[0].size(-1), d2 = state[2].size(-1);
  const int64_t C = state[4].size(-1);
  const std::vector<std::vector<int64_t>> shapes = {
      {n, d_in, d1}, {n, 1, d1}, {n, d1, d2}, {n, 1, d2}, {n, d2, C},
      {n, 1, C}};
  for (int i = 0; i < 12; ++i) {
    check(state[i], "state", f32_or_bf16(state[i]), 3);
    same_device(bx, state[i]);
    TORCH_CHECK(state[i].sizes() == at::IntArrayRef(shapes[i % 6]),
                msg("fused epoch leaf ", i % 6,
                    (i < 6 ? " (params)" : " (trace)"), " has shape ",
                    state[i].sizes(), ", want ",
                    at::IntArrayRef(shapes[i % 6])));
  }
  TORCH_CHECK(by.size(0) == n && by.size(1) == rows,
              msg("by shape ", by.sizes(), " for bx ", bx.sizes()));
  TORCH_CHECK(batch > 0 && rows % batch == 0,
              msg("rows (", rows, ") must be a positive multiple of batch (",
                  batch, ")"));
  const c10::cuda::CUDAGuard guard(bx.device());
  const cudaStream_t stream = at::cuda::getCurrentCUDAStream();
  auto f32 = bx.options().dtype(at::kFloat);
  // f32 working copies of the bf16 tensors: bx first, then the state
  std::vector<torch::Tensor> work(12);
  std::vector<p2pfl::CastItem> widen, narrow;
  torch::Tensor bx32 = bx;
  if (bx.scalar_type() == at::kBFloat16) {
    bx32 = torch::empty(bx.sizes(), f32);
    widen.push_back({bx.data_ptr(), bx32.data_ptr(), bx.numel()});
  }
  for (int i = 0; i < 12; ++i) {
    work[i] = state[i];
    if (state[i].scalar_type() != at::kBFloat16) continue;
    work[i] = torch::empty(state[i].sizes(), f32);
    widen.push_back({state[i].data_ptr(), work[i].data_ptr(),
                     state[i].numel()});
    narrow.push_back({work[i].data_ptr(), state[i].data_ptr(),
                      state[i].numel()});
  }
  if (!widen.empty()) {
    p2pfl::launch_cast_bf16(widen.data(), static_cast<int>(widen.size()), 1,
                            stream);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
  }
  auto loss = torch::empty({n}, f32);
  const int B = as_int(batch, "batch");
  const p2pfl::MlpEpochPlan plan = p2pfl::fused_mlp_epoch_plan(
      B, as_int(d_in, "d_in"), as_int(d1, "d1"), as_int(d2, "d2"),
      as_int(C, "C"));
  torch::Tensor scratch;
  if (!plan.on_chip)
    scratch = torch::empty(
        {n, p2pfl::fused_mlp_scratch_floats(B, as_int(d1, "d1"),
                                            as_int(d2, "d2"), as_int(C, "C"))},
        f32);
  float* params[6];
  float* mom[6];
  for (int i = 0; i < 6; ++i) {
    params[i] = work[i].data_ptr<float>();
    mom[i] = work[i + 6].data_ptr<float>();
  }
  p2pfl::launch_fused_mlp_epoch(
      bx32.data_ptr<float>(), by.data_ptr(),
      by.scalar_type() == at::kLong ? 1 : 0, params, mom,
      plan.on_chip ? nullptr : scratch.data_ptr<float>(),
      loss.data_ptr<float>(), as_int(n, "n"),
      as_int(rows, "rows"), as_int(rows / batch, "steps"), B,
      as_int(d_in, "d_in"), as_int(d1, "d1"), as_int(d2, "d2"),
      as_int(C, "C"), static_cast<float>(lr), static_cast<float>(beta),
      stream);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  if (!narrow.empty()) {
    p2pfl::launch_cast_bf16(narrow.data(), static_cast<int>(narrow.size()),
                            0, stream);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
  }
  return loss;
}

// K6's instantiation for these widths on the current device:
// ("on_chip" or "l2", shared memory a block, clusters resident at once).
std::tuple<std::string, int64_t, int64_t> fused_mlp_epoch_plan(
    int64_t batch, int64_t d_in, int64_t d1, int64_t d2, int64_t C) {
  const p2pfl::MlpEpochPlan plan = p2pfl::fused_mlp_epoch_plan(
      as_int(batch, "batch"), as_int(d_in, "d_in"), as_int(d1, "d1"),
      as_int(d2, "d2"), as_int(C, "C"));
  return {plan.on_chip ? "on_chip" : "l2", plan.smem_bytes,
          p2pfl::fused_mlp_clusters_resident(plan)};
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("stream_gemm", &stream_gemm, "K1: [n,M,K] @ [n,K,N], bf16 or f32");
  m.def("stream_gemm_last_branch", &stream_gemm_last_branch,
        "K1: the branch code of the last launch");
  m.def("stream_wgrad", &stream_wgrad, "K2: [n,M,K]^T @ [n,M,N] -> f32");
  m.def("dense_bwd", &dense_bwd, "K3: fused dx, dw of y = x @ w");
  m.def("wgmma_acc_probe", &wgmma_acc_probe,
        "wgmma tf32 sums in one accumulator against fmaf chains");
  m.def("sgd", &sgd, "K4: SGD-with-momentum step over a list of leaves");
  m.def("sgd_accum", &sgd_accum,
        "K5: K4 plus acc + w * p' over a list of leaves");
  m.def("fedavg_accum", &fedavg_accum,
        "K5 null form: acc + w * p over a list of leaves");
  m.attr("max_stream_leaves") = p2pfl::kMaxStreamLeaves;
  m.def("fused_mlp_epoch_plan", &fused_mlp_epoch_plan,
        "K6: instantiation, shared memory a block, clusters resident");
  m.def("fused_mlp_train_epoch", &fused_mlp_train_epoch,
        "K6: one SGD-with-momentum epoch of a 3-layer MLP per node");
}
