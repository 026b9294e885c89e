// K4. Replaces p2pfl_tpu/ops/pallas_gemm.py::_sgd (kernel body
// _sgd_kernel): one optax.sgd step with momentum over a parameter leaf,
// here over all nodes' copies of the leaf at once ([n, numel]):
//
//   m' = g + round_to_trace_dtype(decay * m)
//   p' = p + m' * (-lr[node])          lr = learning rate x update gate
//   stored: p' (f32), m' cast to the trace dtype
//
// Bound on an H100 SXM (3.35 TB/s) at the smoke shapes: memory. The
// FEMNIST CNN's 8 leaves hold 52.8M values over 8 nodes; at 20 bytes a
// value (p, m, g read, p', m' written, f32 trace) one step moves
// 1.06 GB (0.32 ms).
//
// Every product and sum is an explicit __fmul_rn / __fadd_rn, so nvcc
// cannot contract them into an FMA: the kernel gives the same bits as
// the plain PyTorch version, and at gate 0 (lr 0) the update is +-0.0,
// which leaves p bit-exact. What it leaves on the table: one launch a
// leaf (8 a step), scalar 4-byte accesses instead of 16-byte vectors.
#include <cuda_bf16.h>

#include "kernels.h"

namespace p2pfl {

__device__ __forceinline__ float load_f(const float* m, long long i) {
  return m[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* m, long long i) {
  return __bfloat162float(m[i]);
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ void store(float* m, long long i, float v) {
  m[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* m, long long i, float v) {
  m[i] = __float2bfloat16(v);
}

template <typename T>
__global__ void sgd_kernel(const float* __restrict__ p,
                           const T* __restrict__ m,
                           const float* __restrict__ g,
                           const float* __restrict__ lr,
                           float* __restrict__ p_out, T* __restrict__ m_out,
                           float decay, long long numel, long long total) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float neg_lr = -lr[i / numel];
    const float dec = round_to(__fmul_rn(decay, load_f(m, i)), m);
    const float m_new = __fadd_rn(g[i], dec);
    p_out[i] = __fadd_rn(p[i], __fmul_rn(m_new, neg_lr));
    store(m_out, i, m_new);
  }
}

void launch_sgd(const float* p, const void* m, const float* g,
                const float* lr, float* p_out, void* m_out, float decay,
                int trace_bf16, long long n, long long numel,
                cudaStream_t stream) {
  const long long total = n * numel;
  if (total == 0) return;
  long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  if (trace_bf16)
    sgd_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(
        p, static_cast<const __nv_bfloat16*>(m), g, lr, p_out,
        static_cast<__nv_bfloat16*>(m_out), decay, numel, total);
  else
    sgd_kernel<float><<<blocks, 256, 0, stream>>>(
        p, static_cast<const float*>(m), g, lr, p_out,
        static_cast<float*>(m_out), decay, numel, total);
}

}  // namespace p2pfl
