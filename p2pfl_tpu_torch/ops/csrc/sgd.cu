// K4. Replaces p2pfl_tpu/ops/pallas_gemm.py::_sgd (kernel body
// _sgd_kernel): one optax.sgd step with momentum over every leaf of a
// step in one launch, each leaf all nodes' copies at once ([n, numel]):
//
//   m' = g + round_to_trace_dtype(decay * m)
//   p' = round_to(p.dtype, p + m' * (-lr[node]))   lr = rate x gate
//   stored: p', m' cast to the trace dtype
//
// The kernel is multi_tensor.cuh's, which notes its bound and design.
// Bound on an H100 SXM (3.35 TB/s): memory. The FEMNIST CNN's 8 leaves
// over 8 nodes hold 52.8M values; at 20 bytes a value (p, m, g read, p',
// m' written, f32 trace) one step moves 1.06 GB (0.315 ms).
#include "kernels.h"
#include "multi_tensor.cuh"

namespace p2pfl {

void launch_sgd(const StreamLeaf* leaves, int count, const float* lr,
                float decay, int p_bf16, int trace_bf16,
                cudaStream_t stream) {
  using bf = __nv_bfloat16;
  mt::Table tab{};
  mt::fill_table(tab, leaves, count, p_bf16 ? 2 : 4, trace_bf16 ? 2 : 4);
  tab.lr = lr;
  tab.decay = decay;
  if (p_bf16 && trace_bf16)
    mt::launch<mt::kStep, bf, bf>(tab, stream);
  else if (p_bf16)
    mt::launch<mt::kStep, bf, float>(tab, stream);
  else if (trace_bf16)
    mt::launch<mt::kStep, float, bf>(tab, stream);
  else
    mt::launch<mt::kStep, float, float>(tab, stream);
}

}  // namespace p2pfl
