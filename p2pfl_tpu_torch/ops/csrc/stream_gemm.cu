// K1. Replaces p2pfl_tpu/ops/pallas_gemm.py::_stream_gemm (kernel body
// _gemm_kernel): x[M, K] @ w[K, N] with f32 accumulation and the output
// cast once to bf16, here with the node axis taken directly
// ([n, M, K] @ [n, K, N]).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at the smoke
// shapes (n = 8, b = 336): memory. conv1 forward moves 240 MB for
// 3.4 GFLOP (0.07 ms); conv2 forward moves 911 MB for 54 GFLOP
// (0.27 ms).
//
// Design: one block per 64x64 output tile of one node; the depth
// (K = 25 for conv1, 800 for conv2) is staged in 32-wide tiles, so
// conv2's 100 KB weight never has to sit in shared memory whole, and
// K = 25 is zero-padded to 32 inside the tile. What it leaves on the
// table: w is re-read from L2 by every row tile, loads are scalar and
// not overlapped with the mma.sync work, and N = 32 (conv1) fills half
// of each 64-wide tile.
#include "kernels.h"
#include "tile_mma.cuh"

namespace p2pfl {

__global__ void __launch_bounds__(kThreads) stream_gemm_kernel(Gemm g) {
  gemm_tile(g, blockIdx.x, 0, blockIdx.z);
}

void launch_stream_gemm(const void* x, const void* w, void* out, int n,
                        int M, int K, int N, cudaStream_t stream) {
  Gemm g;
  g.a = View{static_cast<const bf16*>(x), K, 1};   // A(m, k) = x[m, k]
  g.bt = View{static_cast<const bf16*>(w), 1, N};  // B^T(j, k) = w[k, j]
  g.a_node = static_cast<long long>(M) * K;
  g.b_node = static_cast<long long>(K) * N;
  g.c = out;
  g.c_sm = N;
  g.c_sn = 1;
  g.c_node = static_cast<long long>(M) * N;
  g.c_split = 0;
  g.M = M;
  g.N = N;
  g.K = K;
  g.k_split = ((K + kBK - 1) / kBK) * kBK;
  g.c_f32 = 0;
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  stream_gemm_kernel<<<dim3(tiles, 1, n), kThreads, 0, stream>>>(g);
}

}  // namespace p2pfl
