// One 64x64 output tile of a bf16 GEMM with f32 accumulation: K1's
// fallback for the shapes its Hopper branches do not take
// (stream_gemm.cu).
//
// C(m, n) = sum_k A(m, k) * B(k, n). Each operand is a strided view, so
// one tile routine serves every layout the kernels need (x, x^T, w,
// w^T, g, g^T) without a transpose pass in device memory. The block
// stages a 64x32 tile of A and of B^T in shared memory (zero-filled
// outside the operand, so a ragged edge never enters the sum), then four
// warps each run mma.sync m16n8k16 over 16 rows and all 64 columns.
//
// What this simple design leaves on the table: global loads are scalar
// 2-byte loads (no cp.async, no TMA, no double buffering), so a block
// stalls on every tile it stages; the tensor cores are fed by mma.sync,
// not wgmma. See PERF.md for the time this costs at the smoke shapes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace p2pfl {

constexpr int kBM = 64;       // output rows per block
constexpr int kBN = 64;       // output columns per block
constexpr int kBK = 32;       // depth per staged tile
constexpr int kPad = 8;       // bf16 padding per shared row
constexpr int kThreads = 128; // four warps

typedef __nv_bfloat16 bf16;

// A strided [rows, depth] view: element (r, k) at p[r * sr + k * sk].
struct View {
  const bf16* p;
  long long sr, sk;
};

// One GEMM problem over the node axis (blockIdx.z is the node).
struct Gemm {
  View a;               // A(m, k)
  View bt;              // B^T(n, k) = B(k, n)
  long long a_node, b_node;  // element strides between nodes
  bf16* c;              // C(m, n) at c[m * c_sm + n * c_sn]
  long long c_sm, c_sn, c_node;
  int M, N, K;
};

__device__ __forceinline__ void stage(bf16 (*s)[kBK + kPad], View v,
                                      int r0, int rows, int k0, int k_end) {
  // 64 x kBK elements, 16 per thread; neighbouring threads take
  // neighbouring addresses along whichever axis is unit-stride
  const bool k_fast = v.sk == 1;
#pragma unroll 4
  for (int i = 0; i < (kBM * kBK) / kThreads; ++i) {
    const int idx = threadIdx.x + kThreads * i;
    const int r = k_fast ? idx / kBK : idx % kBM;
    const int k = k_fast ? idx % kBK : idx / kBM;
    const int gr = r0 + r, gk = k0 + k;
    bf16 val = __float2bfloat16(0.0f);
    if (gr < rows && gk < k_end) val = v.p[gr * v.sr + gk * v.sk];
    s[r][k] = val;
  }
}

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Computes output tile `tile` (row-major over the tile grid) for node
// `node`.
static __device__ void gemm_tile(const Gemm& g, int tile, int node) {
  __shared__ __align__(16) bf16 As[kBM][kBK + kPad];
  __shared__ __align__(16) bf16 Bs[kBN][kBK + kPad];

  const int tiles_n = (g.N + kBN - 1) / kBN;
  const int m0 = (tile / tiles_n) * kBM;
  const int n0 = (tile % tiles_n) * kBN;

  View a = g.a, bt = g.bt;
  a.p += node * g.a_node;
  bt.p += node * g.b_node;

  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  for (int k0 = 0; k0 < g.K; k0 += kBK) {
    stage(As, a, m0, g.M, k0, g.K);
    stage(Bs, bt, n0, g.N, k0, g.K);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4];
      af[0] = *reinterpret_cast<const uint32_t*>(&As[wr + gid][kk + 2 * tig]);
      af[1] = *reinterpret_cast<const uint32_t*>(&As[wr + gid + 8][kk + 2 * tig]);
      af[2] = *reinterpret_cast<const uint32_t*>(&As[wr + gid][kk + 2 * tig + 8]);
      af[3] = *reinterpret_cast<const uint32_t*>(&As[wr + gid + 8][kk + 2 * tig + 8]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t bfr[2];
        bfr[0] = *reinterpret_cast<const uint32_t*>(&Bs[j * 8 + gid][kk + 2 * tig]);
        bfr[1] = *reinterpret_cast<const uint32_t*>(&Bs[j * 8 + gid][kk + 2 * tig + 8]);
        mma16816(acc[j], af, bfr);
      }
    }
    __syncthreads();
  }

  // accumulator (row gid [+8], columns 2*tig, 2*tig+1) of each n8 tile
  const long long base = node * g.c_node;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + wr + gid + (e >= 2 ? 8 : 0);
      const int n = n0 + j * 8 + 2 * tig + (e & 1);
      if (m < g.M && n < g.N) {
        g.c[base + m * g.c_sm + n * g.c_sn] = __float2bfloat16(acc[j][e]);
      }
    }
  }
}

}  // namespace p2pfl
