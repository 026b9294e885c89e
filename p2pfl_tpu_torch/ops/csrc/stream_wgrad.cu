// K2. Replaces p2pfl_tpu/ops/pallas_gemm.py::_stream_wgrad (kernel body
// _wgrad_kernel): x[M, K]^T @ g[M, N] -> [K, N] in f32, summed over M,
// with the node axis taken directly.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at the smoke
// shapes (n = 8, b = 336): memory. conv1 wgrad moves 240 MB (0.07 ms),
// conv2 wgrad 912 MB (0.27 ms).
//
// Design: the TPU kernel summed M tiles in grid order into one resident
// block. Here M (0.5M to 2.1M rows a call) is cut into fixed slices of
// at most 4096 rows; each block sums one slice of one 64x64 output tile
// into its own f32 partial, and a second kernel adds the partials of
// each element in slice order. No float atomics, so two runs give the
// same bits. Rows past the end of a slice or of M are zero-filled on
// both operands while staging, so no out-of-range value (even a NaN)
// can enter the sum. What it leaves on the table: x and g are staged
// transposed through scalar loads, every K tile of a slice re-reads
// that slice of g, and the partials take a second pass.
#include "kernels.h"
#include "tile_mma.cuh"

namespace p2pfl {

constexpr int kSliceRows = 4096;

int wgrad_splits(int M) {
  const int slice = ((kSliceRows + kBK - 1) / kBK) * kBK;
  return M <= 0 ? 1 : (M + slice - 1) / slice;
}

__global__ void __launch_bounds__(kThreads) wgrad_partial_kernel(Gemm g) {
  gemm_tile(g, blockIdx.x, blockIdx.y, blockIdx.z);
}

// out[node, i] = sum over s in order of partial[node, s, i]
__global__ void split_reduce_kernel(const float* partial, float* out,
                                    int splits, long long per_node,
                                    long long total) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long node = i / per_node, e = i % per_node;
    const float* p = partial + node * splits * per_node + e;
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += p[k * per_node];
    out[i] = s;
  }
}

void launch_stream_wgrad(const void* x, const void* g, float* partial,
                         float* out, int n, int M, int K, int N,
                         cudaStream_t stream) {
  const int splits = wgrad_splits(M);
  Gemm p;
  // A(i, j) = x[j, i]: rows i over K, depth j over M
  p.a = View{static_cast<const bf16*>(x), 1, K};
  // B^T(c, j) = g[j, c]
  p.bt = View{static_cast<const bf16*>(g), 1, N};
  p.a_node = static_cast<long long>(M) * K;
  p.b_node = static_cast<long long>(M) * N;
  p.c = partial;
  p.c_sm = N;
  p.c_sn = 1;
  p.c_split = static_cast<long long>(K) * N;
  p.c_node = p.c_split * splits;
  p.M = K;
  p.N = N;
  p.K = M;
  p.k_split = ((kSliceRows + kBK - 1) / kBK) * kBK;
  p.c_f32 = 1;
  const int tiles = ((K + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  wgrad_partial_kernel<<<dim3(tiles, splits, n), kThreads, 0, stream>>>(p);
  const long long per_node = static_cast<long long>(K) * N;
  const long long total = per_node * n;
  const int blocks = static_cast<int>((total + 255) / 256);
  split_reduce_kernel<<<blocks, 256, 0, stream>>>(partial, out, splits,
                                                  per_node, total);
}

}  // namespace p2pfl
