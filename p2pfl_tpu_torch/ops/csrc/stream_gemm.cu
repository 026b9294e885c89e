// K1. Replaces p2pfl_tpu/ops/pallas_gemm.py::_stream_gemm (:116, kernel
// body _gemm_kernel :111, pallas_call :122): x[M, K] @ w[K, N] with f32
// accumulation and the output cast once to bf16, here with the node
// axis taken directly ([n, M, K] @ [n, K, N]).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at every path
// shape: bytes. At the ring shape (n = 8, b = 336) conv1 forward moves
// 240 MB for 3.4 GFLOP (0.072 ms), conv2 forward 911 MB for 54 GFLOP
// (0.272 ms): five times more time in bytes than in operations.
//
// Design: the TPU kernel's, w stationary while the rows stream, rethought
// for this card. Persistent blocks each take one contiguous run of row
// tiles (tile order node-major), so a block loads a node's w once and
// then only streams x in and the output out. Two branches:
//   - Wide (N = 64, K a multiple of 8, w up to 1024 x 64: conv2's
//     (800, 64) and (288, 64)). One 288-thread block per SM. Warp 8
//     loads the node's w into shared memory by TMA (64-row boxes,
//     128-byte swizzle: 104 KB at K = 800, resident for the node's run),
//     then 128 x 64 slices of x by TMA into a ring of 5 stages completing
//     on mbarriers. Two consumer warpgroups run wgmma.mma_async
//     m64n64k16 (A = x K-major, B = w N-major, both from the swizzled
//     boxes; f32 accumulators in registers), and store bf16 tiles by
//     TMA from a swizzled shared-memory stage, completing in the
//     background while the next tile runs. TMA zero-fills K beyond 800
//     in x and w and rows beyond M, and clips the store at M.
//   - Narrow (K <= 32, N <= 64: conv1's (25, 32), (9, 32), (27, ..)
//     and its dgrad shape (32, 25)). A row of x is 18-64 bytes, not a
//     16-byte multiple, so no 2-D TMA descriptor can describe x; but a
//     tile of R consecutive rows is one contiguous run of R * K
//     elements. 256-thread blocks (two an SM) copy 256-row runs with
//     16-byte cp.async into a ring of 4 stages (a run that does not
//     start on a 16-byte boundary, or its last < 8 elements, with
//     guarded element loads), keep w's mma fragments in registers for
//     the node's run, and feed the tensor cores with mma.sync m16n8k16:
//     the 2-byte rows are gathered into the A fragments straight from
//     the packed run, K zero-padded to 16 or 32 in registers. wgmma
//     would need the rows repacked into its core-matrix layout first,
//     and these 3.4 GFLOP need about a twentieth of mma.sync's rate, so
//     the repacking would buy nothing. The output tile is also one
//     contiguous run, written with 16-byte stores.
//   - Any other shape (rows that are not 16-byte multiples with K > 32,
//     N other than 64 with K > 32, or w too large for shared memory; no
//     path gives one) runs the guarded element-wise tile routine of
//     tile_mma.cuh.
//
// Earlier design: one 128-thread block per 64 x 64 output tile, w
// re-read from L2 for every tile, scalar 2-byte loads, mma.sync without
// overlap: 0.290 ms (conv1) and 1.410 ms (conv2) at the ring shape by
// chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W); PERF.md has its times
// beside this design's.
#include "hopper.cuh"
#include "kernels.h"
#include "tile_mma.cuh"

namespace p2pfl {
namespace {

using sm90::Operand;

// ---------------------------------------------------------------------------
// wide branch: TMA + wgmma, w resident
// ---------------------------------------------------------------------------

constexpr int kWBM = 128, kWStages = 5, kWThreads = 288, kWMaxBoxes = 16;
constexpr int kWStageBytes = kWBM * 128;  // 128 rows x 64 bf16
constexpr int kWEpiBytes = 2 * sm90::kBoxBytes64;  // a 64 x 64 box a warpgroup

struct WideParams {
  CUtensorMap x_map;  // x [n, M, K], boxes 128 x 64 (A, K-major)
  CUtensorMap w_map;  // w [n, K, 64], boxes 64 x 64 (B, N-major)
  CUtensorMap out_map;  // out [n, M, 64], boxes 64 x 64 (stores)
  long long M;
  int boxes;  // 64-deep slices of K
  int tiles_per_node;
  long long tiles;
};

int wide_smem(int boxes) {
  return 1024 + boxes * sm90::kBoxBytes64 + kWStages * kWStageBytes +
         kWEpiBytes + 128;
}

__global__ void __launch_bounds__(kWThreads, 1)
    stream_gemm_wide_kernel(const __grid_constant__ WideParams p) {
  extern __shared__ char raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  char* ws = smem;
  char* xs = ws + p.boxes * sm90::kBoxBytes64;
  char* epi = xs + kWStages * kWStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + kWEpiBytes);
  uint64_t* empty = full + kWStages;
  uint64_t* w_full = empty + kWStages;
  uint64_t* w_empty = w_full + 1;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);
    }
    sm90::mbar_init(w_full, 1);
    sm90::mbar_init(w_empty, 8);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const long long t0 = p.tiles * blockIdx.x / gridDim.x;
  const long long t1 = p.tiles * (blockIdx.x + 1) / gridDim.x;

  if (warp == 8) {
    if (lane != 0) return;
    int stage = 0, cur = -1, seg = 0;
    uint32_t phase = 0;
    for (long long t = t0; t < t1; ++t) {
      const int node = static_cast<int>(t / p.tiles_per_node);
      const int m0 = static_cast<int>(t % p.tiles_per_node) * kWBM;
      if (node != cur) {
        // the node's w, once the consumers are done with the last one
        if (seg > 0) sm90::mbar_wait(w_empty, (seg - 1) & 1);
        sm90::mbar_expect_tx(w_full, p.boxes * sm90::kBoxBytes64);
        for (int j = 0; j < p.boxes; ++j)
          sm90::tma_load_3d(ws + j * sm90::kBoxBytes64, &p.w_map, w_full, 0,
                            64 * j, node);
        cur = node;
        ++seg;
      }
      for (int j = 0; j < p.boxes; ++j) {
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        sm90::mbar_expect_tx(&full[stage], kWStageBytes);
        sm90::tma_load_3d(xs + stage * kWStageBytes, &p.x_map, &full[stage],
                          64 * j, m0, node);
        if (++stage == kWStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, t128 = threadIdx.x & 127;
  int stage = 0, cur = -1, seg = 0;
  uint32_t phase = 0;
  float acc[32];
  for (long long t = t0; t < t1; ++t) {
    const int node = static_cast<int>(t / p.tiles_per_node);
    const long long row0 =
        (t % p.tiles_per_node) * static_cast<long long>(kWBM) + 64 * wg;
    if (node != cur) {
      sm90::mbar_wait(w_full, seg & 1);
      cur = node;
      ++seg;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    sm90::fence_acc(acc);
    int prev = -1;
    for (int j = 0; j < p.boxes; ++j) {
      sm90::mbar_wait(&full[stage], phase);
      const uint32_t a =
          sm90::smem_u32(xs + stage * kWStageBytes) + wg * sm90::kBoxBytes64;
      const uint32_t b = sm90::smem_u32(ws + j * sm90::kBoxBytes64);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_m64n64<0, 1>(acc, sm90::make_desc(a + kk * 32, 16),
                                 sm90::make_desc(b + kk * 2048,
                                                 sm90::kBoxBytes64));
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::mbar_arrive_if(&empty[prev], prev >= 0 && lane == 0);
      prev = stage;
      if (++stage == kWStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    sm90::wgmma_wait<0>();
    sm90::fence_acc(acc);
    sm90::mbar_arrive_if(&empty[prev], prev >= 0 && lane == 0);
    // the node's run ends here: its w may be replaced
    sm90::mbar_arrive_if(
        w_empty, (t + 1 == t1 || (t + 1) / p.tiles_per_node != node) &&
                     lane == 0);
    sm90::store_tile_tma<64>(acc, epi + wg * sm90::kBoxBytes64, &p.out_map, 0,
                             static_cast<int>(row0), node, row0 < p.M, t128,
                             1 + wg);
  }
  if (t128 == 0) sm90::bulk_wait();
}

// ---------------------------------------------------------------------------
// narrow branch: contiguous row runs by cp.async + mma.sync
// ---------------------------------------------------------------------------

constexpr int kNR = 256, kNStages = 4, kNThreads = 256;

struct NarrowParams {
  const sm90::bf16* x;
  const sm90::bf16* w;
  sm90::bf16* out;
  long long M;
  int K, N, tiles_per_node;
  long long tiles;
  int stage_elems;  // kNR * K rounded up to 8
};

int narrow_smem(int K, int N) {
  const int stage = (kNR * K + 7) / 8 * 8;
  return kNStages * stage * 2 + (kNR * N + 7) / 8 * 8 * 2;
}

// Copies `count` bf16 from src to dst (16-byte aligned): 16-byte
// cp.async for the whole chunks when src is 16-byte aligned, guarded
// element loads for the rest. Threads of the block stride the chunks.
__device__ __forceinline__ void copy_run_in(unsigned short* dst,
                                            const sm90::bf16* src,
                                            long long count) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  long long done = 0;
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const long long chunks = count / 8;
    for (long long c = threadIdx.x; c < chunks; c += kNThreads)
      sm90::cp_async16(dst + 8 * c, s + 8 * c);
    done = chunks * 8;
  }
  for (long long e = done + threadIdx.x; e < count; e += kNThreads)
    dst[e] = s[e];
}

__device__ __forceinline__ void copy_run_out(sm90::bf16* dst,
                                             const unsigned short* src,
                                             long long count) {
  unsigned short* d = reinterpret_cast<unsigned short*>(dst);
  long long done = 0;
  if (reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
    const long long chunks = count / 8;
    for (long long c = threadIdx.x; c < chunks; c += kNThreads)
      reinterpret_cast<uint4*>(d)[c] = reinterpret_cast<const uint4*>(src)[c];
    done = chunks * 8;
  }
  for (long long e = done + threadIdx.x; e < count; e += kNThreads)
    d[e] = src[e];
}

__device__ __forceinline__ uint32_t pack2(unsigned short lo,
                                          unsigned short hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// kNT: 8-column blocks of the output (4 for N <= 32, 8 for N <= 64).
template <int kNT>
__global__ void __launch_bounds__(kNThreads, 2)
    stream_gemm_narrow_kernel(const NarrowParams p) {
  extern __shared__ __align__(16) unsigned short nsmem[];
  unsigned short* xs = nsmem;
  unsigned short* os = nsmem + kNStages * p.stage_elems;
  const unsigned short* w = reinterpret_cast<const unsigned short*>(p.w);
  const int K = p.K, N = p.N;

  const long long t0 = p.tiles * blockIdx.x / gridDim.x;
  const long long t1 = p.tiles * (blockIdx.x + 1) / gridDim.x;
  auto rows_of = [&](long long t) {
    const long long r0 = (t % p.tiles_per_node) * kNR;
    return static_cast<int>(p.M - r0 < kNR ? p.M - r0 : kNR);
  };
  auto first_row = [&](long long t) {
    return (t / p.tiles_per_node) * p.M + (t % p.tiles_per_node) * kNR;
  };
  auto issue = [&](long long t, int s) {
    copy_run_in(xs + s * p.stage_elems, p.x + first_row(t) * K,
                static_cast<long long>(rows_of(t)) * K);
  };

  for (int i = 0; i < kNStages - 1; ++i) {
    if (t0 + i < t1) issue(t0 + i, i);
    sm90::cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int ksteps = (K + 15) / 16;
  uint32_t wf[2][kNT][2];
  long long cur = -1;
  int i = 0;
  for (long long t = t0; t < t1; ++t, ++i) {
    if (t + kNStages - 1 < t1) issue(t + kNStages - 1, (i + kNStages - 1) % kNStages);
    sm90::cp_async_commit();
    sm90::cp_async_wait<kNStages - 1>();
    __syncthreads();

    const long long node = t / p.tiles_per_node;
    if (node != cur) {
      // w's B fragments: b[h] = (w[k][n], w[k + 1][n]), k = 16 ks +
      // 2 tig + 8 h, n = 8 j + gid; zero beyond K and N
      const unsigned short* wn = w + node * K * N;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = 16 * ks + 2 * tig + 8 * h, n = 8 * j + gid;
            const unsigned short lo = (k < K && n < N) ? wn[k * N + n] : 0;
            const unsigned short hi =
                (k + 1 < K && n < N) ? wn[(k + 1) * N + n] : 0;
            wf[ks][j][h] = pack2(lo, hi);
          }
      cur = node;
    }

    const unsigned short* xt = xs + (i % kNStages) * p.stage_elems;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int rb = warp * 32 + mi * 16;
      float acc[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        if (ks >= ksteps) break;
        // A fragment: a[q] = rows rb + gid (+8 for q odd), k = 16 ks +
        // 2 tig (+8 for q >= 2), two consecutive k a register
        uint32_t a[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = rb + gid + 8 * (q & 1);
          const int k = 16 * ks + 2 * tig + 8 * (q >> 1);
          const unsigned short lo = k < K ? xt[r * K + k] : 0;
          const unsigned short hi = k + 1 < K ? xt[r * K + k + 1] : 0;
          a[q] = pack2(lo, hi);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma16816(acc[j], a, wf[ks][j]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = rb + gid + (e >= 2 ? 8 : 0);
          const int n = 8 * j + 2 * tig + (e & 1);
          if (n < N)
            os[r * N + n] = __bfloat16_as_ushort(__float2bfloat16(acc[j][e]));
        }
    }
    __syncthreads();
    copy_run_out(p.out + first_row(t) * N, os,
                 static_cast<long long>(rows_of(t)) * N);
  }
  sm90::cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// any other shape: the guarded element-wise tile routine
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) stream_gemm_tile_kernel(Gemm g) {
  gemm_tile(g, blockIdx.x, blockIdx.z);
}

void launch_tiles(const bf16* x, const bf16* w, void* out, int n, int M,
                  int K, int N, cudaStream_t stream) {
  Gemm g;
  g.a = View{x, K, 1};   // A(m, k) = x[m, k]
  g.bt = View{w, 1, N};  // B^T(j, k) = w[k, j]
  g.a_node = static_cast<long long>(M) * K;
  g.b_node = static_cast<long long>(K) * N;
  g.c = static_cast<bf16*>(out);
  g.c_sm = N;
  g.c_sn = 1;
  g.c_node = static_cast<long long>(M) * N;
  g.M = M;
  g.N = N;
  g.K = K;
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  stream_gemm_tile_kernel<<<dim3(tiles, 1, n), kThreads, 0, stream>>>(g);
}

template <int kNT>
void launch_narrow(const NarrowParams& p, cudaStream_t stream) {
  const int smem = narrow_smem(p.K, p.N);
  cudaFuncSetAttribute(stream_gemm_narrow_kernel<kNT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  static int cached_smem = -1, per_sm = 1;
  if (smem != cached_smem) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stream_gemm_narrow_kernel<kNT>, kNThreads, smem);
    if (per_sm < 1) per_sm = 1;
    cached_smem = smem;
  }
  const long long cap = static_cast<long long>(per_sm) * sm90::sm_count();
  const int grid = static_cast<int>(p.tiles < cap ? p.tiles : cap);
  stream_gemm_narrow_kernel<kNT><<<grid, kNThreads, smem, stream>>>(p);
}

}  // namespace

void launch_stream_gemm(const void* x, const void* w, void* out, int n,
                        int M, int K, int N, cudaStream_t stream) {
  using sm90::bf16;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w);
  if (M == 0) return;
  if (K <= 32 && N <= 64 && K > 0) {
    NarrowParams p;
    p.x = xp;
    p.w = wp;
    p.out = static_cast<bf16*>(out);
    p.M = M;
    p.K = K;
    p.N = N;
    p.tiles_per_node = (M + kNR - 1) / kNR;
    p.tiles = static_cast<long long>(n) * p.tiles_per_node;
    p.stage_elems = (kNR * K + 7) / 8 * 8;
    if (N <= 32)
      launch_narrow<4>(p, stream);
    else
      launch_narrow<8>(p, stream);
    return;
  }
  const Operand xo{xp, static_cast<long long>(M) * K, K, K, M};
  const Operand wo{wp, static_cast<long long>(K) * N, N, N, K};
  const int boxes = (K + 63) / 64;
  if (N == 64 && boxes <= kWMaxBoxes && sm90::tma_ok(xo, n) &&
      sm90::tma_ok(wo, n) && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    WideParams p;
    p.x_map = sm90::make_tmap(xo, n, kWBM);
    p.w_map = sm90::make_tmap(wo, n, 64);
    p.out_map = sm90::make_tmap(
        Operand{static_cast<const bf16*>(out), static_cast<long long>(M) * 64,
                64, 64, M},
        n, 64);
    p.M = M;
    p.boxes = boxes;
    p.tiles_per_node = (M + kWBM - 1) / kWBM;
    p.tiles = static_cast<long long>(n) * p.tiles_per_node;
    const int smem = wide_smem(boxes);
    cudaFuncSetAttribute(stream_gemm_wide_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    const int sms = sm90::sm_count();
    const int grid = static_cast<int>(p.tiles < sms ? p.tiles : sms);
    stream_gemm_wide_kernel<<<grid, kWThreads, smem, stream>>>(p);
    return;
  }
  launch_tiles(xp, wp, out, n, M, K, N, stream);
}

}  // namespace p2pfl
