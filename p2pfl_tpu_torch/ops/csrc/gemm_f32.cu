// K2 in float32: the instantiation of
// p2pfl_tpu/ops/pallas_gemm.py::_stream_wgrad (:171, pallas_call :177)
// that the JAX package runs when the model computes in float32 (its
// `_dot` is dtype-generic, :101-112). Exact float32: no TF32, whose
// three decimal digits the f32 compute arm exists to avoid. (K1 and K3
// in float32 live in gemm_f32_tc.cu.)
//
//   K2: out[n, K, N] = x[n, M, K]^T @ g[n, M, N], summed over M
//
// Bound on an H100 SXM at the f32 arm's ring step (8 nodes x 336
// FEMNIST-CNN samples), as the least time for an f32-accurate product
// on this card (three TF32 passes at 495 TFLOP/s, or the bytes at
// 3.35 TB/s): bytes for conv2's weight gradient (54 GFLOP over 1.8 GB:
// 0.54 ms; exact SIMT FFMA at 67 TFLOP/s would take 0.80 ms) and for
// conv1's (K = 25, N = 32: 3.4 GFLOP over 0.48 GB, 0.14 ms).
//
// Design: the simple one. One routine computes a 64 x 64 output tile of
// C = A @ B over a range of the contraction, with A and B strided views
// (A(k, r) = x[r, k], B(r, j) = g[r, j]). 256 threads stage
// 16-deep tiles of A and B in shared memory (zero outside the operand,
// so a ragged edge never enters a sum), double-buffered, the next tile's
// global loads held in registers while the current one is consumed;
// each thread sums a 4 x 4 block of outputs, every output one fmaf chain
// in ascending contraction order. Loads are scalar (conv1's 100-byte
// rows are not 16-byte aligned, so no TMA or vector path is assumed).
// The long contraction is cut into slices by ops/gemm.py::wgrad_plan
// (route "f32", a function of the shape alone), each summed by its own
// blocks, and a second kernel adds the slices' partials in slice order:
// two runs give the same bits. What this leaves on the table: scalar
// loads, SIMT FFMA instead of tensor cores (3xTF32 on wgmma, as
// gemm_f32_tc.cu does for K1 and K3: ROADMAP Queue B).
#include "kernels.h"

namespace p2pfl {
namespace {

constexpr int kFM = 64, kFN = 64, kFK = 16, kFThreads = 256, kFPad = 4;

// A strided operand over the node axis: element (o, k) of node z at
// p[z * node + o * so + k * sk], o along the output (rows of A, columns
// of B), k along the contraction.
struct View {
  const float* p;
  long long so, sk, node;
};

// C(m, j) = sum over k in [k0, k0 + rows) of A(m, k) * B(k, j), written
// at c[z * c_node + slice * c_slice + m * c_ld + j].
struct Problem {
  View a, b;
  float* c;
  long long c_ld, c_node, c_slice;
  int M, N, K, rows;
  int tiles_n, tiles;
};

// a thread's four elements of a 64 x 16 tile: along o or along k,
// whichever is unit-stride, so neighbouring threads read neighbours
struct Pos {
  int o[4], k[4];
};

__device__ __forceinline__ Pos positions(const View& v) {
  Pos q;
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = t + kFThreads * i;
    const bool k_fast = v.sk == 1;
    q.o[i] = k_fast ? idx / kFK : idx % kFM;
    q.k[i] = k_fast ? idx % kFK : idx / kFM;
  }
  return q;
}

__device__ __forceinline__ void fetch(float r[4], const View& v,
                                      const float* base, const Pos& q,
                                      int o0, int o_end, int k0, int k_end) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = o0 + q.o[i], k = k0 + q.k[i];
    r[i] = (o < o_end && k < k_end)
               ? base[static_cast<long long>(o) * v.so +
                      static_cast<long long>(k) * v.sk]
               : 0.0f;
  }
}

__device__ __forceinline__ void put(float (*s)[kFM + kFPad], const float r[4],
                                    const Pos& q) {
#pragma unroll
  for (int i = 0; i < 4; ++i) s[q.k[i]][q.o[i]] = r[i];
}

__device__ void gemm_tile(const Problem& pr, int tile, int slice, int z) {
  __shared__ __align__(16) float As[2][kFK][kFM + kFPad];
  __shared__ __align__(16) float Bs[2][kFK][kFN + kFPad];

  const int m0 = (tile / pr.tiles_n) * kFM, n0 = (tile % pr.tiles_n) * kFN;
  const int kb = slice * pr.rows;
  const int ke = min(pr.K, kb + pr.rows);
  const float* a = pr.a.p + z * pr.a.node;
  const float* b = pr.b.p + z * pr.b.node;
  const Pos qa = positions(pr.a), qb = positions(pr.b);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4] = {};
  float ra[4], rb[4];
  int buf = 0;
  if (kb < ke) {
    fetch(ra, pr.a, a, qa, m0, pr.M, kb, ke);
    fetch(rb, pr.b, b, qb, n0, pr.N, kb, ke);
    put(As[0], ra, qa);
    put(Bs[0], rb, qb);
  }
  __syncthreads();
  for (int k0 = kb; k0 < ke; k0 += kFK) {
    const bool more = k0 + kFK < ke;
    if (more) {
      fetch(ra, pr.a, a, qa, m0, pr.M, k0 + kFK, ke);
      fetch(rb, pr.b, b, qb, n0, pr.N, k0 + kFK, ke);
    }
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[buf][kk][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[buf][kk][4 * tx]);
      const float af[4] = {av.x, av.y, av.z, av.w};
      const float bf[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
    }
    if (more) {
      // the other buffer was last read before the previous barrier
      put(As[buf ^ 1], ra, qa);
      put(Bs[buf ^ 1], rb, qb);
    }
    __syncthreads();
    buf ^= 1;
  }

  float* c = pr.c + z * pr.c_node + slice * pr.c_slice;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= pr.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n < pr.N) c[static_cast<long long>(m) * pr.c_ld + n] = acc[i][j];
    }
  }
}

// blockIdx.x: a tile of problem 0, then of problem 1; blockIdx.y: the
// contraction slice; blockIdx.z: the node. K2 passes an empty problem 1:
// this is the body that also ran K3's dx and dw in one grid, kept as it
// was because its one-problem form ran slower at conv2's weight gradient
// (2.346 -> 2.394 ms, scripts/torch_kernel_ab.py, NVIDIA H100 80GB HBM3,
// 700 W).
__global__ void __launch_bounds__(kFThreads)
    gemm_f32_kernel(const Problem p0, const Problem p1) {
  const int t = blockIdx.x;
  if (t < p0.tiles)
    gemm_tile(p0, t, blockIdx.y, blockIdx.z);
  else
    gemm_tile(p1, t - p0.tiles, blockIdx.y, blockIdx.z);
}

// out[node, e] = sum over s in order of partial[node, s, e]
__global__ void slice_sum_f32_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int slices,
                                     long long per_node, long long total) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long node = i / per_node, e = i % per_node;
    const float* q = partial + node * slices * per_node + e;
    float s = 0.0f;
    for (int k = 0; k < slices; ++k) s += q[k * per_node];
    out[i] = s;
  }
}

Problem problem(View a, View b, float* c, long long c_ld, long long c_node,
                int M, int N, int K, int rows) {
  Problem p;
  p.a = a;
  p.b = b;
  p.c = c;
  p.c_ld = c_ld;
  p.c_node = c_node;
  p.c_slice = static_cast<long long>(M) * N;
  p.M = M;
  p.N = N;
  p.K = K;
  p.rows = rows;
  p.tiles_n = (N + kFN - 1) / kFN;
  p.tiles = ((M + kFM - 1) / kFM) * p.tiles_n;
  return p;
}

void launch(const Problem& p0, const Problem& p1, int slices, int n,
            cudaStream_t stream) {
  const int tiles = p0.tiles + p1.tiles;
  if (tiles == 0 || n == 0) return;
  gemm_f32_kernel<<<dim3(tiles, slices, n), kFThreads, 0, stream>>>(p0, p1);
}

}  // namespace

void launch_stream_wgrad_f32(const float* x, const float* g, float* partial,
                             float* out, int n, int M, int K, int N,
                             int rows, int slices, cudaStream_t stream) {
  const long long KN = static_cast<long long>(K) * N;
  // A(k, r) = x[r, k]; B(r, j) = g[r, j]; the contraction runs over the
  // node's M rows, `rows` a slice
  const Problem p = problem(
      View{x, 1, K, static_cast<long long>(M) * K},
      View{g, 1, N, static_cast<long long>(M) * N},
      slices > 1 ? partial : out, N, slices > 1 ? slices * KN : KN, K, N, M,
      rows);
  Problem none = p;
  none.tiles = 0;
  launch(p, none, slices, n, stream);
  if (slices > 1) {
    const long long total = KN * n;
    const int blocks = static_cast<int>((total + 255) / 256);
    slice_sum_f32_kernel<<<blocks, 256, 0, stream>>>(partial, out, slices,
                                                     KN, total);
  }
}

}  // namespace p2pfl
