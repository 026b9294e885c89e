// K5. Replaces p2pfl_tpu/ops/pallas_gemm.py::_sgd_acc (kernel body
// _sgd_accum_kernel; public sgd_accum(acc=, weight=) and fedavg_accum):
// K4's SGD-with-momentum step plus the weighted FedAvg accumulate, over
// all slots' copies of a parameter leaf at once ([n, numel]):
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
// Bound on an H100 SXM (3.35 TB/s): memory. At the cross-device smoke
// shape (FEMNIST CNN, 6.6M values a slot, 8 slots, 52.8M values a step)
// the null form moves 12 bytes a value with f32 p (p, acc read, acc
// written), 634 MB a step (0.19 ms); the general form with an f32
// trace 28 bytes a value (p, m, g, acc read, p', m', acc' written).
//
// Every product and sum is an explicit __fmul_rn / __fadd_rn, as in
// sgd.cu, so nvcc cannot contract them into an FMA: the kernel gives the
// plain PyTorch version's bits, and at lr 0 p comes back bit-exact.
// The grid's y index is the slot, so no thread divides by numel. What it
// leaves on the table: one launch a leaf, scalar accesses instead of
// 16-byte vectors, and the slot sum at round end is a separate pass.
#include <cuda_bf16.h>

#include "kernels.h"

namespace p2pfl {
namespace {

__device__ __forceinline__ float ld(const float* a, long long i) {
  return a[i];
}
__device__ __forceinline__ float ld(const __nv_bfloat16* a, long long i) {
  return __bfloat162float(a[i]);
}
__device__ __forceinline__ float rnd(float v, const float*) { return v; }
__device__ __forceinline__ float rnd(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ void st(float* a, long long i, float v) {
  a[i] = v;
}
__device__ __forceinline__ void st(__nv_bfloat16* a, long long i, float v) {
  a[i] = __float2bfloat16(v);
}

template <typename P, typename T>
__global__ void sgd_accum_kernel(const P* __restrict__ p,
                                 const T* __restrict__ m,
                                 const P* __restrict__ g,
                                 const float* __restrict__ lr,
                                 const float* __restrict__ acc,
                                 const float* __restrict__ w,
                                 P* __restrict__ p_out, T* __restrict__ m_out,
                                 float* __restrict__ acc_out, float decay,
                                 long long numel) {
  const long long base = blockIdx.y * numel;
  const float neg_lr = -lr[blockIdx.y];
  const float ws = w[blockIdx.y];
  for (long long j = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       j < numel; j += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = base + j;
    const float dec = rnd(__fmul_rn(decay, ld(m, i)), m);
    const float m_new = __fadd_rn(ld(g, i), dec);
    const float p_new = rnd(__fadd_rn(ld(p, i), __fmul_rn(m_new, neg_lr)), p);
    st(p_out, i, p_new);
    st(m_out, i, m_new);
    acc_out[i] = __fadd_rn(acc[i], __fmul_rn(ws, p_new));
  }
}

template <typename P>
__global__ void fedavg_accum_kernel(const P* __restrict__ p,
                                    const float* __restrict__ acc,
                                    const float* __restrict__ w,
                                    float* __restrict__ acc_out,
                                    long long numel) {
  const long long base = blockIdx.y * numel;
  const float ws = w[blockIdx.y];
  for (long long j = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       j < numel; j += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = base + j;
    acc_out[i] = __fadd_rn(acc[i], __fmul_rn(ws, ld(p, i)));
  }
}

// blocks along a slot: enough to fill the card over all n slots
dim3 grid_for(long long n, long long numel) {
  long long want = (numel + 255) / 256;
  const long long cap = 4096;
  return dim3(static_cast<unsigned>(want < cap ? want : cap),
              static_cast<unsigned>(n));
}

template <typename P, typename T>
void launch_general(const void* p, const void* m, const void* g,
                    const float* lr, const float* acc, const float* w,
                    void* p_out, void* m_out, float* acc_out, float decay,
                    long long n, long long numel, cudaStream_t stream) {
  sgd_accum_kernel<P, T><<<grid_for(n, numel), 256, 0, stream>>>(
      static_cast<const P*>(p), static_cast<const T*>(m),
      static_cast<const P*>(g), lr, acc, w, static_cast<P*>(p_out),
      static_cast<T*>(m_out), acc_out, decay, numel);
}

}  // namespace

void launch_sgd_accum(const void* p, const void* m, const void* g,
                      const float* lr, const float* acc, const float* w,
                      void* p_out, void* m_out, float* acc_out, float decay,
                      int p_bf16, int trace_bf16, long long n,
                      long long numel, cudaStream_t stream) {
  if (n == 0 || numel == 0) return;
  using bf = __nv_bfloat16;
  if (p_bf16 && trace_bf16)
    launch_general<bf, bf>(p, m, g, lr, acc, w, p_out, m_out, acc_out,
                           decay, n, numel, stream);
  else if (p_bf16)
    launch_general<bf, float>(p, m, g, lr, acc, w, p_out, m_out, acc_out,
                              decay, n, numel, stream);
  else if (trace_bf16)
    launch_general<float, bf>(p, m, g, lr, acc, w, p_out, m_out, acc_out,
                              decay, n, numel, stream);
  else
    launch_general<float, float>(p, m, g, lr, acc, w, p_out, m_out,
                                 acc_out, decay, n, numel, stream);
}

void launch_fedavg_accum(const void* p, const float* acc, const float* w,
                         float* acc_out, int p_bf16, long long n,
                         long long numel, cudaStream_t stream) {
  if (n == 0 || numel == 0) return;
  if (p_bf16)
    fedavg_accum_kernel<__nv_bfloat16><<<grid_for(n, numel), 256, 0,
                                         stream>>>(
        static_cast<const __nv_bfloat16*>(p), acc, w, acc_out, numel);
  else
    fedavg_accum_kernel<float><<<grid_for(n, numel), 256, 0, stream>>>(
        static_cast<const float*>(p), acc, w, acc_out, numel);
}

}  // namespace p2pfl
