// K3. Replaces p2pfl_tpu/ops/pallas_gemm.py::_dense_bwd (kernel body
// _dense_bwd_kernel): the fused backward of y = x @ w, dx = g @ w^T and
// dw = x^T @ g in one launch, with the node axis taken directly.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at the smoke
// shapes (n = 8, B = 336, D = 3136, H = 2048): memory, narrowly.
// 250 MB of traffic take 0.075 ms, its 69 GFLOP 0.070 ms.
//
// Design: the blocks of the one launch split by role. The first
// tiles_dx blocks of each node compute 64x64 tiles of dx, the rest
// tiles of dw; both read x, w and g straight from device memory as
// strided views. Unlike the TPU kernel, g (1.4 MB a node) cannot stay
// resident in one SM's shared memory, so each block streams the
// slices of g it needs in 32-deep tiles. What it leaves on the table:
// x and w are each read by many blocks (through L2), the staging is
// scalar and not overlapped with the mma.sync work.
#include "kernels.h"
#include "tile_mma.cuh"

namespace p2pfl {

__global__ void __launch_bounds__(kThreads) dense_bwd_kernel(Gemm dx,
                                                             Gemm dw,
                                                             int tiles_dx) {
  if (static_cast<int>(blockIdx.x) < tiles_dx)
    gemm_tile(dx, blockIdx.x, 0, blockIdx.z);
  else
    gemm_tile(dw, blockIdx.x - tiles_dx, 0, blockIdx.z);
}

static int tiles_of(int M, int N) {
  return ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
}

void launch_dense_bwd(const void* x, const void* w, const void* g,
                      void* dx, void* dw, int n, int B, int D, int H,
                      cudaStream_t stream) {
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* gp = static_cast<const bf16*>(g);
  // dx(b, d) = sum_h g(b, h) w(d, h)
  Gemm a;
  a.a = View{gp, H, 1};
  a.bt = View{wp, H, 1};
  a.a_node = static_cast<long long>(B) * H;
  a.b_node = static_cast<long long>(D) * H;
  a.c = dx;
  a.c_sm = D;
  a.c_sn = 1;
  a.c_node = static_cast<long long>(B) * D;
  a.c_split = 0;
  a.M = B;
  a.N = D;
  a.K = H;
  a.k_split = ((H + kBK - 1) / kBK) * kBK;
  a.c_f32 = 0;
  // dw(d, h) = sum_b x(b, d) g(b, h)
  Gemm b;
  b.a = View{xp, 1, D};
  b.bt = View{gp, 1, H};
  b.a_node = static_cast<long long>(B) * D;
  b.b_node = static_cast<long long>(B) * H;
  b.c = dw;
  b.c_sm = H;
  b.c_sn = 1;
  b.c_node = static_cast<long long>(D) * H;
  b.c_split = 0;
  b.M = D;
  b.N = H;
  b.K = B;
  b.k_split = ((B + kBK - 1) / kBK) * kBK;
  b.c_f32 = 0;
  const int tiles_dx = tiles_of(B, D);
  const int tiles = tiles_dx + tiles_of(D, H);
  dense_bwd_kernel<<<dim3(tiles, 1, n), kThreads, 0, stream>>>(a, b,
                                                                tiles_dx);
}

}  // namespace p2pfl
