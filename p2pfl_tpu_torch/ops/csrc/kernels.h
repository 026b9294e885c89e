// Launch functions of the port's Hopper kernels. Plain C++ over raw
// pointers, so that only binding.cpp includes PyTorch's headers. Each
// launches on `stream` and returns without synchronising; the caller
// checks cudaGetLastError() right after.
#pragma once

#include <cuda_runtime.h>

namespace p2pfl {

// K1: out[n, M, N] = x[n, M, K] @ w[n, K, N]; bf16 in/out, f32 sum.
void launch_stream_gemm(const void* x, const void* w, void* out, int n,
                        int M, int K, int N, cudaStream_t stream);

// K1's branches (ops/gemm.py::STREAM_GEMM_BRANCHES, in this order): bf16
// at K <= 32 and N <= 64 the narrow kernel, its tiles stored by 2-D TMA
// (N = 32 or 64 and an output TMA can map) or copied out from a stage;
// the TMA + wgmma kernel (N = 64, TMA-mappable operands); the guarded
// tile routine. float32: exact FFMA at K <= 32, else 3xTF32 on wgmma.
// stream_gemm_branch and stream_gemm_f32_branch are the launchers' own
// choice, for these operands.
enum GemmBranch {
  kGemmNarrowTma = 0,
  kGemmNarrowStaged = 1,
  kGemmWide = 2,
  kGemmTiles = 3,
  kGemmF32Ffma = 4,
  kGemmF32Tc = 5
};
int stream_gemm_branch(const void* x, const void* w, const void* out, int n,
                       int M, int K, int N);
int stream_gemm_f32_branch(int K);

// K2: out[n, K, N] = x[n, M, K]^T @ g[n, M, N] in f32, summed over M.
// Each node's rows are cut into `slices` slices of `rows` rows (the last
// one shorter), each summed on its own; when there is more than one,
// `partial` (n * slices * K * N floats) holds the slices' sums, which a
// second kernel adds in slice order. The route (ops/gemm.py::
// WGRAD_ROUTES, in this order) and its unit of rows:
//   kWgradGeneral (bf16, cp.async + mma.sync, any width): rows a
//     multiple of kWgradGeneralRows;
//   kWgradWide (bf16, TMA + wgmma; K and N multiples of 8, 16-byte-
//     aligned bases): kWgradWideRows;
//   kWgradF32Tc (f32, 3xTF32 on wgmma): kWgradF32TcRows;
//   kWgradF32Narrow (f32, exact FFMA; the plan's route at K <= 32 and
//     at M <= 32): kWgradF32NarrowRows;
//   kWgradNarrow (bf16, K <= 32 and N <= 64 a multiple of 8, a slice's
//     whole output a work item; x by 1-D bulk copy, g by TMA, mma.sync;
//     g 16-byte aligned): kWgradNarrowRows.
// The codes are indices: a new route is appended, never inserted.
enum WgradRoute {
  kWgradGeneral = 0,
  kWgradWide = 1,
  kWgradF32Tc = 2,
  kWgradF32Narrow = 3,
  kWgradNarrow = 4
};
constexpr int kWgradWideRows = 64;
constexpr int kWgradGeneralRows = 256;
constexpr int kWgradF32TcRows = 32;
constexpr int kWgradF32NarrowRows = 64;
constexpr int kWgradNarrowRows = 128;
// The bf16 routes (stream_wgrad.cu): route kWgradGeneral, kWgradWide or
// kWgradNarrow.
void launch_stream_wgrad(const void* x, const void* g, float* partial,
                         float* out, int n, int M, int K, int N, int route,
                         int rows, int slices, cudaStream_t stream);

// K3: dx[n, B, D] = g @ w^T and dw[n, D, H] = x^T @ g in one launch;
// x [n, B, D], w [n, D, H], g [n, B, H], all bf16.
void launch_dense_bwd(const void* x, const void* w, const void* g,
                      void* dx, void* dw, int n, int B, int D, int H,
                      cudaStream_t stream);

// K1 and K3 in float32 (gemm_f32_tc.cu): 3xTF32 on wgmma for K > 32,
// exact FFMA for K1 at K <= 32. `scratch` (16-byte aligned) holds the
// split small operand: stream_gemm_f32_scratch(n, K, N) floats for K1,
// dense_bwd_f32_scratch(n, B, H) for K3.
long long stream_gemm_f32_scratch(int n, int K, int N);
long long dense_bwd_f32_scratch(int n, int B, int H);
void launch_stream_gemm_f32(const float* x, const float* w, float* out,
                            float* scratch, int n, int M, int K, int N,
                            cudaStream_t stream);
void launch_dense_bwd_f32(const float* x, const float* w, const float* g,
                          float* dx, float* dw, float* scratch, int n, int B,
                          int D, int H, cudaStream_t stream);

// K2 in float32 (gemm_f32_tc.cu) on the f32 routes above.
void launch_stream_wgrad_f32(const float* x, const float* g, float* partial,
                             float* out, int n, int M, int K, int N,
                             int route, int rows, int slices,
                             cudaStream_t stream);

// The accumulation probe of gemm_f32_tc.cu: a [64, K] @ bt [64, K]^T
// (K a multiple of 8) summed by wgmma m64n64k8 tf32 in one accumulator
// into d_tc [64, 64], and by one fmaf chain a value into d_chain.
void launch_wgmma_acc_probe(const float* a, const float* bt, float* d_tc,
                            float* d_chain, int K, cudaStream_t stream);

// One leaf of a K4/K5 launch: a parameter stacked over n slots (nodes
// or cohort slots), [n, numel] contiguous. Operands a form does not use
// are null; outputs are the binding's fresh tensors.
struct StreamLeaf {
  const void* p;
  const void* m;
  const void* g;
  const float* acc;
  void* p_out;
  void* m_out;
  float* acc_out;
  long long n, numel;
};

// Leaves one K4/K5 launch takes: their table is a kernel parameter
// (4 KB at most). The binding splits a longer list into launches.
constexpr int kMaxStreamLeaves = 48;

// K4: one SGD-with-momentum step over `count` (1..kMaxStreamLeaves)
// non-empty leaves in one launch; p and g f32 (p_bf16 = 0) or bf16
// (p_bf16 = 1), the trace f32 (trace_bf16 = 0) or bf16, lr [n] f32 (the
// learning rate times the update gate), shared by every leaf.
void launch_sgd(const StreamLeaf* leaves, int count, const float* lr,
                float decay, int p_bf16, int trace_bf16,
                cudaStream_t stream);

// K5, general form: K4's step plus acc_out = acc + w[slot] * f32(p_out)
// over `count` leaves in one launch; w [n] f32, acc f32.
void launch_sgd_accum(const StreamLeaf* leaves, int count, const float* lr,
                      const float* w, float decay, int p_bf16,
                      int trace_bf16, cudaStream_t stream);

// K5, null form (fedavg_accum): acc_out = acc + w[slot] * f32(p) over
// `count` leaves in one launch; p f32 or bf16, acc f32, w [n] f32.
void launch_fedavg_accum(const StreamLeaf* leaves, int count, const float* w,
                         int p_bf16, cudaStream_t stream);

// K6: one SGD-with-momentum epoch of a 3-layer ReLU MLP per node, over
// n nodes. params / mom: 6 f32 tensors each (bf16 state and inputs are
// widened into f32 copies before the epoch and narrowed back once after
// it, by launch_cast_bf16) (w0 [n,d_in,d1], b0 [n,d1],
// w1 [n,d1,d2], b1 [n,d2], w2 [n,d2,C], b2 [n,C]), trained in place;
// bx [n, rows, d_in] f32, by [n, rows] int32 (by_int64 = 0) or int64;
// rows = steps * batch; loss [n] receives each node's mean loss over the
// steps. The instantiation follows from the widths
// (fused_mlp_epoch_plan): on_chip = 1 holds a node's weights in its
// cluster's shared memory (smem_bytes a block); on_chip = 0 is the
// L2-resident kernel, whose `scratch` holds n *
// fused_mlp_scratch_floats(...) floats (unused otherwise).
constexpr long long kMaxSmemBytes = 232448;  // a block's on sm_90
struct MlpEpochPlan {
  int on_chip, smem_bytes;
};
MlpEpochPlan fused_mlp_epoch_plan(int batch, int d_in, int d1, int d2,
                                  int C);
// Clusters of the plan's kernel resident on the current device at once.
int fused_mlp_clusters_resident(const MlpEpochPlan& plan);
long long fused_mlp_scratch_floats(int batch, int d1, int d2, int C);
void launch_fused_mlp_epoch(const float* bx, const void* by, int by_int64,
                            float* const* params, float* const* mom,
                            float* scratch, float* loss, int n, int rows,
                            int steps, int batch, int d_in, int d1, int d2,
                            int C, float lr, float beta, cudaStream_t stream);

// K6's bf16 variant: one launch converts `count` (1..kMaxCasts) tensors,
// bf16 -> f32 (widen = 1, exact) or f32 -> bf16 (widen = 0, round to
// nearest even), each `numel` values from `src` into `dst`.
constexpr int kMaxCasts = 13;
struct CastItem {
  const void* src;
  void* dst;
  long long numel;
};
void launch_cast_bf16(const CastItem* items, int count, int widen,
                      cudaStream_t stream);

}  // namespace p2pfl
