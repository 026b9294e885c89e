// K5. Replaces p2pfl_tpu/ops/pallas_gemm.py::_sgd_acc (kernel body
// _sgd_accum_kernel; public sgd_accum(acc=, weight=) and fedavg_accum):
// K4's SGD-with-momentum step plus the weighted FedAvg accumulate, over
// every leaf of a step in one launch, each leaf all slots' copies at
// once ([n, numel]):
//
//   m' = g + round_to_trace_dtype(decay * m)   (in f32, as the Pallas
//                                               kernel evaluates it)
//   p' = round_to(p.dtype, p + m' * (-lr[slot]))
//   acc' = acc + w[slot] * f32(p')
//
// and a null form (fedavg_accum), the cross-device round's per-step
// accumulate: acc' = acc + w[slot] * f32(p). The JAX package runs the
// null form as the general one with g = 0, momentum 0 and lr 0, where
// p' = p + 0 * -0 is p (at most a -0.0 turns +0.0, which changes no
// weighted sum); here the null form skips the optimizer half and reads
// p and acc, writes acc.
//
// The kernel is multi_tensor.cuh's, which notes its bound and design.
// Bound on an H100 SXM (3.35 TB/s): memory. At the cross-device smoke
// shape (FEMNIST CNN, 6.6M values a slot, 8 slots, 52.8M values a step)
// the null form moves 12 bytes a value with f32 p (p, acc read, acc
// written), 634 MB a step (0.19 ms); the general form with an f32
// trace 28 bytes a value (p, m, g, acc read, p', m', acc' written).
#include "kernels.h"
#include "multi_tensor.cuh"

namespace p2pfl {

void launch_sgd_accum(const StreamLeaf* leaves, int count, const float* lr,
                      const float* w, float decay, int p_bf16,
                      int trace_bf16, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  mt::Table tab{};
  mt::fill_table(tab, leaves, count, p_bf16 ? 2 : 4, trace_bf16 ? 2 : 4);
  tab.lr = lr;
  tab.w = w;
  tab.decay = decay;
  if (p_bf16 && trace_bf16)
    mt::launch<mt::kStepAccum, bf, bf>(tab, stream);
  else if (p_bf16)
    mt::launch<mt::kStepAccum, bf, float>(tab, stream);
  else if (trace_bf16)
    mt::launch<mt::kStepAccum, float, bf>(tab, stream);
  else
    mt::launch<mt::kStepAccum, float, float>(tab, stream);
}

void launch_fedavg_accum(const StreamLeaf* leaves, int count, const float* w,
                         int p_bf16, cudaStream_t stream) {
  mt::Table tab{};
  mt::fill_table(tab, leaves, count, p_bf16 ? 2 : 4, 4);
  tab.w = w;
  if (p_bf16)
    mt::launch<mt::kAccum, __nv_bfloat16, float>(tab, stream);
  else
    mt::launch<mt::kAccum, float, float>(tab, stream);
}

}  // namespace p2pfl
