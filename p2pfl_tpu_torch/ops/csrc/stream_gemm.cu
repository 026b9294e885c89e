// K1. Replaces p2pfl_tpu/ops/pallas_gemm.py::_stream_gemm (:116, kernel
// body _gemm_kernel :111, pallas_call :122): x[M, K] @ w[K, N] with f32
// accumulation and the output cast once to bf16, here with the node
// axis taken directly ([n, M, K] @ [n, K, N]).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at every path
// shape: bytes. At the ring shape (n = 8, b = 336) conv1 forward moves
// 240 MB for 3.4 GFLOP (0.072 ms), conv2 forward 911 MB for 54 GFLOP
// (0.272 ms): five times more time in bytes than in operations. The
// ResNet9 stem (16 nodes x 131,072 rows, K = 27, N = 64) moves 381 MB,
// 268 of them the output (0.114 ms).
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
//   - Narrow (K <= 32, N <= 64: conv1's (25, 32), (9, 32), the ResNet9
//     stem's (27, 64) and conv1's dgrad shape (32, 25)). A row of x is
//     18-64 bytes, not a 16-byte multiple, so no 2-D TMA descriptor can
//     describe x; but a tile of 256 consecutive rows is one contiguous
//     run. Persistent 288-thread blocks, one an SM: a producer warp's
//     lane 0 issues each tile's run as one 1-D bulk copy (TMA's
//     non-tensor form) into an mbarrier ring of 8 slots, placed so
//     that its 16-byte-aligned middle lands on a 16-byte boundary (an
//     unaligned start or a ragged end, at most 7 elements each, by plain
//     loads: nothing outside the run is read). Eight consumer warps keep
//     w's mma fragments in registers for the node's run and feed the
//     tensor cores with mma.sync m16n8k16 on 32 rows each, the 2-byte
//     rows gathered into the A fragments straight from the packed run, K
//     zero-padded to 16 or 32 in registers (wgmma would need the rows
//     repacked into its core-matrix layout first, and these few GFLOP
//     need a small part of mma.sync's rate). At N = 32 and 64 the bf16
//     tile is staged in the 64- or 128-byte swizzle, in which the 8 rows
//     of a fragment store fall in 8 different bank groups, and stored by
//     2-D TMA (clipped at the node's M) from two stages in turn, so it
//     drains while the next tile runs; other N (conv1's dgrad) stage the
//     tile as it lies and write it with 16-byte stores, in blocks of 4
//     slots two an SM, so that one block's copy-out overlaps the other's
//     tile. Up to 8 tiles' loads and two tiles' stores are in flight a
//     TMA-storing block. Of 128- and 256-row tiles by one and two blocks
//     an SM, this layout was the fastest at conv1 and close to the
//     fastest at the stem (PERF.md).
//   - Any other shape (rows that are not 16-byte multiples with K > 32,
//     N other than 64 with K > 32, or w too large for shared memory; no
//     path gives one) runs the guarded element-wise tile routine of
//     tile_mma.cuh.
//
// Earlier designs: one 128-thread block per 64 x 64 output tile, w
// re-read from L2 for every tile, scalar 2-byte loads, mma.sync without
// overlap: 0.290 ms (conv1) and 1.410 ms (conv2) at the ring shape by
// chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W); then a narrow branch of
// 256-thread blocks, two an SM, copying x by 16-byte cp.async from all
// threads and writing each tile with synchronous stores after 2-byte
// stores into a stage whose 128-byte rows put a fragment store's 8 rows
// on the same banks: 0.097 ms (conv1) and 0.233 ms (the stem). PERF.md
// has their times beside this design's.
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
// narrow branch: row runs by 1-D bulk copy, mma.sync, TMA-stored tiles
// ---------------------------------------------------------------------------

constexpr int kNR = 256, kNConsumers = 8;
constexpr int kNThreads = 32 * kNConsumers + 32;  // + the producer warp
constexpr int kNMT = kNR / (16 * kNConsumers);    // m16 tiles a warp

struct NarrowParams {
  CUtensorMap out_map;  // out [n, M, N], boxes kNR x N (TMA-stored tiles)
  const sm90::bf16* x;
  const sm90::bf16* w;
  sm90::bf16* out;
  long long M;
  int K, N, tiles_per_node;
  long long tiles;
  int out_stride;  // bytes of an output stage (1024-aligned)
  int slot;        // bytes of an x slot: kNR * K * 2 + 16, 128-aligned
};

int narrow_out_stride(int N) { return (kNR * N * 2 + 1023) / 1024 * 1024; }
int narrow_slot(int K) { return (kNR * K * 2 + 16 + 127) / 128 * 128; }
// TMA-stored tiles: 8 x slots, one block an SM (at most 199 KB at K =
// 32, N = 64). A staged copy-out, which the block waits on: 4 slots and
// two blocks an SM, so that one block's copy-out overlaps the other's
// tile.
constexpr int kNStagesTma = 8, kNStagesCopy = 4;
int narrow_smem(int K, int N, bool tma_out) {
  const int stages = tma_out ? kNStagesTma : kNStagesCopy;
  return 1024 + (tma_out ? 2 : 1) * narrow_out_stride(N) +
         stages * narrow_slot(K) + 2 * stages * 8;
}

// The output tile [rows, N] from the stage to `dst`, by the consumers
// (t < 256): 16-byte stores where dst is 16-byte aligned, element
// stores for the rest.
__device__ __forceinline__ void copy_run_out(sm90::bf16* dst,
                                             const unsigned short* src,
                                             long long count, int t) {
  unsigned short* d = reinterpret_cast<unsigned short*>(dst);
  long long done = 0;
  if (reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
    const long long chunks = count / 8;
    for (long long c = t; c < chunks; c += 32 * kNConsumers)
      reinterpret_cast<uint4*>(d)[c] = reinterpret_cast<const uint4*>(src)[c];
    done = chunks * 8;
  }
  for (long long e = done + t; e < count; e += 32 * kNConsumers)
    d[e] = src[e];
}

__device__ __forceinline__ uint32_t pack2(unsigned short lo,
                                          unsigned short hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// kNT: 8-column blocks of the output (4 for N <= 32, 8 for N <= 64).
// kTmaOut: N = 8 kNT (32 or 64), the tile stored by TMA from a swizzled
// stage (64- or 128-byte swizzle), two stages in turn; otherwise the
// tile is staged as it lies and written by the consumers.
template <int kNT, bool kTmaOut>
__global__ void __launch_bounds__(kNThreads, kTmaOut ? 1 : 2)
    stream_gemm_narrow_kernel(const __grid_constant__ NarrowParams p) {
  constexpr int kNStages = kTmaOut ? kNStagesTma : kNStagesCopy;
  extern __shared__ char nraw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(nraw) + 1023) & ~uintptr_t(1023));
  char* obuf = smem;
  char* xs = obuf + (kTmaOut ? 2 : 1) * p.out_stride;
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + kNStages * p.slot);
  uint64_t* empty = full + kNStages;
  const unsigned short* w = reinterpret_cast<const unsigned short*>(p.w);
  const int K = p.K, N = p.N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kNStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kNConsumers);  // one arrive a warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const long long t0 = p.tiles * blockIdx.x / gridDim.x;
  const long long t1 = p.tiles * (blockIdx.x + 1) / gridDim.x;
  auto rows_of = [&](long long t) {
    const long long r0 = (t % p.tiles_per_node) * kNR;
    return static_cast<int>(p.M - r0 < kNR ? p.M - r0 : kNR);
  };
  auto first_row = [&](long long t) {
    return (t / p.tiles_per_node) * p.M + (t % p.tiles_per_node) * kNR;
  };

  if (warp == kNConsumers) {
    // producer: lane 0 keeps kNStages tiles' x runs in flight
    if (lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (long long t = t0; t < t1; ++t) {
      sm90::mbar_wait(&empty[stage], phase ^ 1);
      char* slot = xs + stage * p.slot;
      const sm90::RunCopy rc = sm90::copy_run_edges(
          slot, p.x + first_row(t) * K,
          static_cast<long long>(rows_of(t)) * K);
      sm90::mbar_expect_tx(&full[stage], rc.bytes);
      if (rc.bytes)
        sm90::bulk_load(slot + rc.dst_off, rc.mid, rc.bytes, &full[stage]);
      if (++stage == kNStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumers: warp w takes rows 16 kNMT w .. 16 kNMT (w + 1) - 1 of
  // each tile, one m16 tile at a time
  const int t256 = threadIdx.x;
  const int gid = lane >> 2, tig = lane & 3;
  const int ksteps = (K + 15) / 16;
  uint32_t wf[2][kNT][2];
  long long cur = -1;
  int stage = 0, ob = 0;
  uint32_t phase = 0;
  for (long long t = t0; t < t1; ++t) {
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

    // the output stage: with TMA stores, stage `ob`, free once the store
    // two tiles back has read it; otherwise the one stage, free once the
    // last tile's copy-out is done
    char* os = obuf + (kTmaOut ? ob * p.out_stride : 0);
    if (kTmaOut && t256 == 0) sm90::bulk_wait_read<1>();
    sm90::named_bar_sync(1, 32 * kNConsumers);

    sm90::mbar_wait(&full[stage], phase);
    const unsigned short* xt = reinterpret_cast<const unsigned short*>(
        xs + stage * p.slot + sm90::run_offset(p.x + first_row(t) * K));
#pragma unroll
    for (int mi = 0; mi < kNMT; ++mi) {
      const int rb = (warp * kNMT + mi) * 16;
      float acc[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        if (ks >= ksteps) break;
        // A fragment: a[q] = rows rb + gid (+8 for q odd), k = 16 ks +
        // 2 tig (+8 for q >= 2), two consecutive k a register, gathered
        // from the packed run (rows past the tile's hold stale values
        // whose outputs are never stored)
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
      if constexpr (kTmaOut) {
        // swizzled: the 8 rows of a fragment store in 8 different chunks
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t r = rb + gid + 8 * h, b = (8 * j + 2 * tig) * 2;
            *reinterpret_cast<__nv_bfloat162*>(
                os + (kNT == 8 ? sm90::swz128(r, b) : sm90::swz64(r, b))) =
                __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
          }
      } else {
        unsigned short* o = reinterpret_cast<unsigned short*>(os);
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = rb + gid + (e >= 2 ? 8 : 0);
            const int n = 8 * j + 2 * tig + (e & 1);
            if (n < N)
              o[r * N + n] =
                  __bfloat16_as_ushort(__float2bfloat16(acc[j][e]));
          }
      }
    }
    // the slot is free once every lane's loads have fed its mma
    __syncwarp();
    sm90::mbar_arrive_if(&empty[stage], lane == 0);
    if (++stage == kNStages) {
      stage = 0;
      phase ^= 1;
    }

    if constexpr (kTmaOut) {
      // thread 0 stores the tile by TMA (clipped at the node's M) and
      // the block moves on while it drains
      sm90::fence_proxy_async();
      sm90::named_bar_sync(1, 32 * kNConsumers);
      if (t256 == 0) {
        sm90::tma_store_3d(&p.out_map, os, 0,
                           static_cast<int>((t % p.tiles_per_node) * kNR),
                           static_cast<int>(node));
        sm90::bulk_commit();
      }
      ob ^= 1;
    } else {
      sm90::named_bar_sync(1, 32 * kNConsumers);
      copy_run_out(p.out + first_row(t) * N,
                   reinterpret_cast<const unsigned short*>(os),
                   static_cast<long long>(rows_of(t)) * N, t256);
    }
  }
  if (kTmaOut && t256 == 0) sm90::bulk_wait();
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

template <int kNT, bool kTmaOut>
void launch_narrow(const NarrowParams& p, cudaStream_t stream) {
  const int smem = narrow_smem(p.K, p.N, kTmaOut);
  auto* kernel = stream_gemm_narrow_kernel<kNT, kTmaOut>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const long long cap =
      static_cast<long long>(kTmaOut ? 1 : 2) * sm90::sm_count();
  const int grid = static_cast<int>(p.tiles < cap ? p.tiles : cap);
  kernel<<<grid, kNThreads, smem, stream>>>(p);
}

}  // namespace

int stream_gemm_branch(const void* x, const void* w, const void* out, int n,
                       int M, int K, int N) {
  using sm90::bf16;
  if (K <= 32 && N <= 64 && K > 0) {
    const Operand oo{static_cast<const bf16*>(out),
                     static_cast<long long>(M) * N, N, N, M};
    return (N == 32 || N == 64) && sm90::tma_ok(oo, n) ? kGemmNarrowTma
                                                        : kGemmNarrowStaged;
  }
  const Operand xo{static_cast<const bf16*>(x), static_cast<long long>(M) * K,
                   K, K, M};
  const Operand wo{static_cast<const bf16*>(w), static_cast<long long>(K) * N,
                   N, N, K};
  if (N == 64 && (K + 63) / 64 <= kWMaxBoxes && sm90::tma_ok(xo, n) &&
      sm90::tma_ok(wo, n) && reinterpret_cast<uintptr_t>(out) % 16 == 0)
    return kGemmWide;
  return kGemmTiles;
}

void launch_stream_gemm(const void* x, const void* w, void* out, int n,
                        int M, int K, int N, cudaStream_t stream) {
  using sm90::bf16;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w);
  if (M == 0) return;
  const int branch = stream_gemm_branch(x, w, out, n, M, K, N);
  if (branch == kGemmNarrowTma || branch == kGemmNarrowStaged) {
    NarrowParams p;
    p.x = xp;
    p.w = wp;
    p.out = static_cast<bf16*>(out);
    p.M = M;
    p.K = K;
    p.N = N;
    p.tiles_per_node = (M + kNR - 1) / kNR;
    p.tiles = static_cast<long long>(n) * p.tiles_per_node;
    p.out_stride = narrow_out_stride(N);
    p.slot = narrow_slot(K);
    if (branch == kGemmNarrowTma) {
      p.out_map = sm90::make_tmap(
          Operand{static_cast<const bf16*>(out),
                  static_cast<long long>(M) * N, N, N, M},
          n, kNR, N,
          N == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
      if (N == 32)
        launch_narrow<4, true>(p, stream);
      else
        launch_narrow<8, true>(p, stream);
    } else if (N <= 32) {
      launch_narrow<4, false>(p, stream);
    } else {
      launch_narrow<8, false>(p, stream);
    }
    return;
  }
  if (branch == kGemmWide) {
    const Operand xo{xp, static_cast<long long>(M) * K, K, K, M};
    const Operand wo{wp, static_cast<long long>(K) * N, N, N, K};
    const int boxes = (K + 63) / 64;
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
