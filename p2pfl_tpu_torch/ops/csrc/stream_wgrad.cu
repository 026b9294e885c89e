// K2. Replaces p2pfl_tpu/ops/pallas_gemm.py::_stream_wgrad (:171, kernel
// body _wgrad_kernel :151, pallas_call :177): out[n, K, N] = x[n, M, K]^T
// @ g[n, M, N] in f32, summed over the M rows of each node (the conv
// weight gradients of models/cnn.py::patch_conv).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): bytes at every
// shape of the paths. conv1 (K = 25, N = 32) moves 114 bytes a row for
// 1,600 operations, conv2 (K = 800, N = 64) 1,728 bytes for 102,400;
// at the ring step (n = 8, M = 263,424 and 65,856) 240 + 912 MB,
// 0.072 + 0.272 ms, where conv2's 54 GFLOP take 0.055 ms.
//
// Design. Each node's rows are cut into slices by a plan that depends
// on (n, M, K, N) only (ops/gemm.py::wgrad_plan): about 512 blocks over
// the grid on the wide route, 256 on the general and 128 work items on
// the narrow, and no slice shorter than 1,024 rows where M allows, so
// the f32 partials stay small beside the operands. A block (or a work
// item) sums one slice of one output tile in a fixed order; when a node
// has more than one slice, a second kernel adds the partials of each
// element in slice order. No float atomics, no dependence on the SM
// count: two runs give the same bits, on any H100. Nothing outside a
// node's rows [0, M) enters its sums, so a NaN in one node stays in that
// node.
//
// Three routes, chosen by shape:
//   - narrow (K <= 32 and N <= 64 a multiple of 8, g's base on a
//     16-byte boundary: conv1's and the ResNet9 stem's weight
//     gradients): a work item is (node, slice) and covers the whole K x
//     N output, so x is read once. A persistent grid, one 288-thread
//     block an SM, takes a contiguous run of items. A producer warp
//     streams 128-row stages into a 5-stage mbarrier ring: x's rows (50
//     or 54 bytes, no 2-D TMA row) as one contiguous run by a 1-D bulk
//     copy (the run lands at its address mod 16; an unaligned head and a
//     ragged tail, at any node base, are copied by hand:
//     sm90::copy_run_edges), g's (64 or 128 bytes) as one 128 x 64 TMA
//     box in the 128-byte swizzle, zero-filled past the node's M. Each of eight
//     consumer warps takes 16 rows of a stage as one k16 step of
//     mma.sync m16n8k16 into its own f32 accumulators over the item's
//     rows: A = x^T gathered from the packed run by 16-bit loads (rows
//     past a stage's valid ones as zero), B = g by ldmatrix.trans, whose
//     8 row addresses the swizzle puts in 8 different bank groups. At
//     the item's end the eight warps' sums meet in warp order through
//     shared memory.
//   - wide (rows of x and g 16-byte multiples, conv2): the product is
//     tiled as out^T = g^T x, so g's N columns form one wgmma M tile (64)
//     and up to 256 of x's K columns its N side; x's 64-column boxes are
//     dealt evenly to the column chunks (conv2's 13 as 4, 3, 3, 3). A
//     block (one producer warp, two consumer warpgroups, one block an
//     SM) streams 32-row stages of its slice by TMA from 3-D maps over
//     [n, M, .] (zero-filled past M and past K or N) into an 8-stage
//     mbarrier ring: one g box (32 x 64, 128-byte swizzled) and the
//     chunk's x boxes, up to 20 KB a stage. Each warpgroup runs wgmma
//     m64n128k16 on its half of the chunk's columns with both operands
//     MN-major straight from the boxes (K3's dw form), so x and g are
//     read from HBM once: a slice of g is shared through L2 by the
//     blocks of its column chunks, which sit next to each other in the
//     grid. A slice is whole boxes of two stages (the plan's rows a
//     multiple of 64). Sums: the tensor core adds each wgmma's products
//     into its f32 accumulator by truncation (gemm_f32_tc.cu's probe), a
//     bias that grows with the rows one accumulator takes (a whole
//     slice of about 4,100 rows, as this route first did, summed farther
//     from the f64 product than torch.matmul). So each box of kWBoxRows
//     = 64 rows (two stages) starts from a fresh accumulator (scale-d 0)
//     and its sum is added to an f32 register total with
//     round-to-nearest fadd; 64 was the depth closest to f64 of 32 to
//     512 in a CPU emulation of these sums
//     (tests/test_torch_wgrad_numerics.py). The total and the box's
//     accumulator take 128 registers a thread, so a chunk's 256 columns
//     are split over two warpgroups.
//   - general (any other width, and operands whose base no TMA map can
//     start at: g's on the narrow route's widths, x's or g's on the
//     wide route's): a block
//     covers a 32 x 32 output tile and walks its slice in
//     256-row chunks through a 3-stage cp.async ring. Where a tile spans
//     the whole row (K or N <= 32) and a node's rows start on a 16-byte
//     boundary, a chunk's rows are one contiguous run, copied as it lies
//     by 16-byte cp.async (its last vector zero-filled past the run, so
//     nothing past a node's last row is read); otherwise the tile is
//     copied element by element. Eight warps run mma.sync m16n8k16 on 32
//     rows each, their fragments gathered from the raw rows by 16-bit
//     loads, and the eight partial tiles are summed in warp order.
// Earlier designs: one 128-thread block per 64 x 64 tile and 4,096-row
// slice, x and g staged transposed through scalar 2-byte loads, every
// 64-row K tile re-reading g: 3.008 ms for conv1 + conv2 at the ring
// shape by chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W); then this one
// with the wide route's sums in one accumulator a slice (one consumer
// warpgroup of m64n256, two blocks an SM): 0.438 ms. Before the narrow
// route, conv1 and the stem ran the general route (the stem's 128-byte
// g rows copied element by element, x read once for each of 2 column
// tiles): 0.094 and 0.413 ms. PERF.md has their times beside this
// design's.
#include "hopper.cuh"
#include "kernels.h"

namespace p2pfl {
namespace {

using sm90::bf16;
using sm90::Operand;

// ---------------------------------------------------------------------------
// wide route: TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int kWBoxRows = kWgradWideRows;  // rows a fresh accumulator takes
constexpr int kWRows = kWBoxRows / 2;       // rows (depth) a stage
constexpr int kWStages = 8;
constexpr int kWCols = 256;                // x columns a block at most
constexpr int kWHalf = kWCols / 2;         // a consumer warpgroup's
constexpr int kWBox = kWRows * 128;        // a 32 x 64 bf16 box
constexpr int kWStageBytes = kWBox * (1 + kWCols / 64);
constexpr int kWConsumerWarps = 8;         // two warpgroups
constexpr int kWThreads = 32 * kWConsumerWarps + 32;  // + producer warp
constexpr int kWSmem = 1024 + kWStages * kWStageBytes + 2 * kWStages * 8;

struct WideParams {
  CUtensorMap g_map;  // g [n, M, N], boxes 32 rows x 64
  CUtensorMap x_map;  // x [n, M, K], boxes 32 rows x 64
  float* out;         // [n, slices, K, N]
  int M, K, N, rows, slices;
  // x's 64-column boxes are dealt to chunks_k column chunks, the first
  // `extra` taking box_base + 1 boxes and the others box_base
  int chunks_k, box_base, extra;
};

__global__ void __launch_bounds__(kWThreads, 1)
    wgrad_wide_kernel(const __grid_constant__ WideParams p) {
  extern __shared__ char raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWStages * kWStageBytes);
  uint64_t* empty = full + kWStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ck = blockIdx.x % p.chunks_k;
  const int box0 = ck * p.box_base + min(ck, p.extra);
  const int nbox = p.box_base + (ck < p.extra);
  const int k0 = 64 * box0, k_end = min(p.K, 64 * (box0 + nbox));
  const int n0 = (blockIdx.x / p.chunks_k) * 64;
  const int slice = blockIdx.y, node = blockIdx.z;
  const int row0 = slice * p.rows;
  // whole boxes: a slice is a multiple of kWBoxRows rows, and the rows of
  // the last box past the node's M are zero-filled by TMA
  const int boxes = (min(p.rows, p.M - row0) + kWBoxRows - 1) / kWBoxRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kWConsumerWarps);  // one arrive a warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kWConsumerWarps) {
    // producer: lane 0 keeps the ring full
    if (lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < 2 * boxes; ++it) {
      sm90::mbar_wait(&empty[stage], phase ^ 1);
      char* s = smem + stage * kWStageBytes;
      const int r = row0 + it * kWRows;
      sm90::mbar_expect_tx(&full[stage], kWBox * (1 + nbox));
      sm90::tma_load_3d(s, &p.g_map, &full[stage], n0, r, node);
      for (int j = 0; j < nbox; ++j)
        sm90::tma_load_3d(s + kWBox * (1 + j), &p.x_map, &full[stage],
                          k0 + 64 * j, r, node);
      if (++stage == kWStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumer warpgroup wg: columns 128 wg .. 128 wg + 127 of the chunk,
  // acc(c, k) = sum over a box of g[m, c] x[m, k], sum = the boxes' sums
  // to nearest. The wgmma always spans two boxes; the columns of a box
  // this chunk does not load hold stale values and are never stored.
  const int wg = warp >> 2, wq = warp & 3;
  float acc[kWHalf / 2], sum[kWHalf / 2];
#pragma unroll
  for (int i = 0; i < kWHalf / 2; ++i) sum[i] = acc[i] = 0.0f;
  sm90::fence_acc(acc);
  int stage = 0;
  uint32_t phase = 0;
  for (int bx = 0; bx < boxes; ++bx) {
    // the box's two stages, one commit group; straight-line code, so
    // that no use of the accumulator sits on a branch (ptxas would
    // serialize every wgmma of the kernel)
    const int first_stage = stage;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sm90::mbar_wait(&full[stage], phase);
      const uint32_t a = sm90::smem_u32(smem + stage * kWStageBytes);
      const uint32_t b = a + kWBox * (1 + 2 * wg);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWRows / 16; ++kk)
        // both MN-major: +16 rows of 128 B per k16; x's 64-wide column
        // blocks lie one box apart; the box's first wgmma restarts the
        // sum
        sm90::wgmma_m64n128<1, 1>(acc, sm90::make_desc(a + kk * 2048, kWBox),
                                  sm90::make_desc(b + kk * 2048, kWBox),
                                  h == 0 && kk == 0 ? 0 : 1);
      if (++stage == kWStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(acc);
    // the box's stages are free; its sum joins the total to nearest
    sm90::mbar_arrive_if(&empty[first_stage], lane == 0);
    sm90::mbar_arrive_if(&empty[first_stage + 1 == kWStages ? 0
                                                            : first_stage + 1],
                         lane == 0);
#pragma unroll
    for (int i = 0; i < kWHalf / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
  }

  // d[4j + 2h + e] holds (c, k) = (16 wq + l/4 + 8h, 8j + 2(l%4) + e); a
  // warp's store covers 8 consecutive c of 4 rows k: whole 32-byte sectors
  float* out = p.out + (static_cast<long long>(node) * p.slices + slice) *
                           static_cast<long long>(p.K) * p.N;
#pragma unroll
  for (int j = 0; j < kWHalf / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + 16 * wq + (lane >> 2) + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = k0 + kWHalf * wg + 8 * j + 2 * (lane & 3) + e;
        if (c < p.N && k < k_end)
          out[static_cast<long long>(k) * p.N + c] = sum[4 * j + 2 * h + e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// general route: cp.async runs + mma.sync
// ---------------------------------------------------------------------------

constexpr int kGRows = kWgradGeneralRows;  // rows a chunk
constexpr int kGStages = 3;
constexpr int kGThreads = 256;             // eight warps, 32 rows each
constexpr int kGOperand = kGRows * 32 * 2;  // an operand's chunk, bytes
constexpr int kGSmem = kGStages * 2 * kGOperand;

struct GeneralParams {
  const bf16* x;
  const bf16* g;
  float* out;  // [n, slices, K, N]
  int M, K, N, rows, slices, tiles_k;
};

// One operand's [rows, 32] block of a chunk in a stage. When the tile
// spans the whole row (width <= 32) and the node's rows start on a
// 16-byte boundary, the chunk's rows are one contiguous run, copied as
// it lies by 16-byte cp.async (the last vector zero-filled past the
// run's end, so nothing past it is read): element (m, k) at m * width +
// k. Otherwise the block is copied element by element with zeros past
// the operand's width: (m, k) at m * 32 + k.
struct Run {
  const bf16* base;  // the node's operand
  int width, col0;
  bool fast;
  int ld, cols;  // row stride in the stage; columns of the tile in it

  __device__ __forceinline__ void issue(char* dst, int r0, int rows) const {
    if (fast) {
      const char* src = reinterpret_cast<const char*>(
          base + static_cast<long long>(r0) * width);
      const int bytes = rows * width * 2;
      for (int v = 16 * threadIdx.x; v < bytes; v += 16 * kGThreads) {
        const int n = bytes - v < 16 ? bytes - v : 16;
        asm volatile(
            "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                sm90::smem_u32(dst + v)),
            "l"(src + v), "r"(n)
            : "memory");
      }
    } else {
      bf16* d = reinterpret_cast<bf16*>(dst);
      for (int i = threadIdx.x; i < rows * 32; i += kGThreads) {
        const int r = i >> 5, c = col0 + (i & 31);
        d[i] = c < width ? base[static_cast<long long>(r0 + r) * width + c]
                         : __float2bfloat16(0.0f);
      }
    }
  }
};

// two bf16 of the stage, (m, k) and (m + 1, k), as one mma register;
// zero for rows >= valid and columns >= cols
__device__ __forceinline__ uint32_t pair(const unsigned short* s, int ld,
                                         int m, int k, int valid, int cols) {
  const bool in = k < cols;
  const uint32_t lo = in && m < valid ? s[m * ld + k] : 0;
  const uint32_t hi = in && m + 1 < valid ? s[(m + 1) * ld + k] : 0;
  return lo | (hi << 16);
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kGThreads, 2)
    wgrad_general_kernel(const GeneralParams p) {
  extern __shared__ __align__(16) char gsm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int k0 = (blockIdx.x % p.tiles_k) * 32;
  const int n0 = (blockIdx.x / p.tiles_k) * 32;
  const int slice = blockIdx.y, node = blockIdx.z;
  const int row0 = slice * p.rows;
  const int row_end = min(row0 + p.rows, p.M);
  const int chunks = (row_end - row0 + kGRows - 1) / kGRows;

  Run rx, rg;
  rx.base = p.x + static_cast<long long>(node) * p.M * p.K;
  rx.width = p.K;
  rx.col0 = k0;
  rx.fast = p.K <= 32 && reinterpret_cast<uintptr_t>(rx.base) % 16 == 0;
  rx.ld = rx.fast ? p.K : 32;
  rx.cols = min(32, p.K - k0);
  rg.base = p.g + static_cast<long long>(node) * p.M * p.N;
  rg.width = p.N;
  rg.col0 = n0;
  rg.fast = p.N <= 32 && reinterpret_cast<uintptr_t>(rg.base) % 16 == 0;
  rg.ld = rg.fast ? p.N : 32;
  rg.cols = min(32, p.N - n0);

  auto issue = [&](int c) {
    if (c < chunks) {
      char* st = gsm + (c % kGStages) * 2 * kGOperand;
      const int r0 = row0 + c * kGRows, rows = min(kGRows, row_end - r0);
      rx.issue(st, r0, rows);
      rg.issue(st + kGOperand, r0, rows);
    }
    sm90::cp_async_commit();
  };

  // acc[I][J]: C(k, n) for k in 16I + [0, 16), n in 8J + [0, 8)
  float acc[2][4][4] = {};
  for (int c = 0; c < kGStages - 1; ++c) issue(c);
  for (int c = 0; c < chunks; ++c) {
    issue(c + kGStages - 1);
    sm90::cp_async_wait<kGStages - 1>();
    __syncthreads();
    const char* st = gsm + (c % kGStages) * 2 * kGOperand;
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(st);
    const unsigned short* gs =
        reinterpret_cast<const unsigned short*>(st + kGOperand);
    const int valid = min(kGRows, row_end - row0 - c * kGRows);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int m = 32 * warp + 16 * ks + 2 * tig;
      // A(k, m) = x[m, k]: rows k = 16I + gid (+8), depth m (+8)
      uint32_t a[2][4];
#pragma unroll
      for (int I = 0; I < 2; ++I) {
        const int k = 16 * I + gid;
        a[I][0] = pair(xs, rx.ld, m, k, valid, rx.cols);
        a[I][1] = pair(xs, rx.ld, m, k + 8, valid, rx.cols);
        a[I][2] = pair(xs, rx.ld, m + 8, k, valid, rx.cols);
        a[I][3] = pair(xs, rx.ld, m + 8, k + 8, valid, rx.cols);
      }
      // B(m, n) = g[m, n]: depth m (+8), column n = 8J + gid
#pragma unroll
      for (int J = 0; J < 4; ++J) {
        const int n = 8 * J + gid;
        const uint32_t b0 = pair(gs, rg.ld, m, n, valid, rg.cols);
        const uint32_t b1 = pair(gs, rg.ld, m + 8, n, valid, rg.cols);
#pragma unroll
        for (int I = 0; I < 2; ++I) mma16816(acc[I][J], a[I], b0, b1);
      }
    }
    __syncthreads();  // the stage is free for the chunk after next
  }
  sm90::cp_async_wait<0>();

  // the eight warps' tiles, summed in warp order
  __syncthreads();
  float* red = reinterpret_cast<float*>(gsm);  // [8][32][32]
#pragma unroll
  for (int I = 0; I < 2; ++I)
#pragma unroll
    for (int J = 0; J < 4; ++J)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 16 * I + gid + 8 * (e >> 1);
        const int c = 8 * J + 2 * tig + (e & 1);
        red[(warp * 32 + k) * 32 + c] = acc[I][J][e];
      }
  __syncthreads();
  float* out = p.out + (static_cast<long long>(node) * p.slices + slice) *
                           static_cast<long long>(p.K) * p.N;
  for (int i = threadIdx.x; i < 32 * 32; i += kGThreads) {
    const int k = k0 + (i >> 5), c = n0 + (i & 31);
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kGThreads / 32; ++w) s += red[w * 1024 + i];
    if (k < p.K && c < p.N) out[static_cast<long long>(k) * p.N + c] = s;
  }
}

// ---------------------------------------------------------------------------
// narrow route: a slice's whole K x N output, both operands as streamed
// rows (x by 1-D bulk copy, g by TMA), mma.sync
// ---------------------------------------------------------------------------

constexpr int kNRows = kWgradNarrowRows;  // rows a stage
constexpr int kNStages = 5;
constexpr int kNConsumers = 8;            // 16 rows of a stage each
constexpr int kNThreads = 32 * kNConsumers + 32;  // + the producer warp
constexpr int kNBox = kNRows * 128;       // g's box: kNRows x 64 bf16
constexpr int kNRedLd = 72;               // a reduction row: 64 + 8 floats
constexpr int kNRedBytes = kNConsumers * 32 * kNRedLd * 4;

struct NarrowParams {
  CUtensorMap g_map;  // g [n, M, N], boxes kNRows x 64, 128-byte swizzle
  const bf16* x;      // [n, M, K]
  float* out;         // [n, slices, K, N]
  int M, K, N, rows, slices;
  int stage;  // bytes a stage: g's box, then x's slot (kNRows * K * 2 +
              // 16, rounded up to 1024)
  long long items;  // n * slices
};

int narrow_stage(int K) {
  return kNBox + (kNRows * K * 2 + 16 + 1023) / 1024 * 1024;
}
int narrow_smem(int K) {
  return 1024 + kNStages * narrow_stage(K) + kNRedBytes + 2 * kNStages * 8;
}

// A work item is (node, slice): out(k, n) = the sum over the slice's rows
// of x[r, k] g[r, n] for every k < K and n < N. Warp w sums rows 16 w ..
// 16 w + 15 of each stage into its own accumulators (mma.sync m16n8k16,
// A = x^T gathered from the packed run, B = g by ldmatrix.trans from the
// swizzled box: conflict-free); at the item's end the eight warps' sums
// are added in warp order. kNT: g's 8-column blocks (4 for N <= 32).
template <int kNT>
__global__ void __launch_bounds__(kNThreads, 1)
    wgrad_narrow_bf16_kernel(const __grid_constant__ NarrowParams p) {
  extern __shared__ char nraw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(nraw) + 1023) & ~uintptr_t(1023));
  float* red = reinterpret_cast<float*>(smem + kNStages * p.stage);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + kNStages * p.stage + kNRedBytes);
  uint64_t* empty = full + kNStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int K = p.K, N = p.N;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kNStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kNConsumers);  // one arrive a warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const long long i0 = p.items * blockIdx.x / gridDim.x;
  const long long i1 = p.items * (blockIdx.x + 1) / gridDim.x;
  // item i: node i / slices, rows [r0, r_end) of it
  auto node_of = [&](long long i) { return static_cast<int>(i / p.slices); };
  auto r0_of = [&](long long i) {
    return static_cast<int>(i % p.slices) * p.rows;
  };
  auto r_end_of = [&](long long i) { return min(p.M, r0_of(i) + p.rows); };
  auto x_run = [&](int node, int r) {
    return p.x + (static_cast<long long>(node) * p.M + r) * K;
  };

  if (warp == kNConsumers) {
    // producer: lane 0 keeps the ring full, across items
    if (lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (long long i = i0; i < i1; ++i) {
      const int node = node_of(i), r_end = r_end_of(i);
      for (int r = r0_of(i); r < r_end; r += kNRows) {
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        char* st = smem + stage * p.stage;
        const sm90::RunCopy rc = sm90::copy_run_edges(
            st + kNBox, x_run(node, r),
            static_cast<long long>(min(kNRows, r_end - r)) * K);
        // g's box is zero-filled past the node's M
        sm90::mbar_expect_tx(&full[stage], kNBox + rc.bytes);
        sm90::tma_load_3d(st, &p.g_map, &full[stage], 0, r, node);
        if (rc.bytes)
          sm90::bulk_load(st + kNBox + rc.dst_off, rc.mid, rc.bytes,
                          &full[stage]);
        if (++stage == kNStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int t256 = threadIdx.x;
  const int gid = lane >> 2, tig = lane & 3;
  const int rw = 16 * warp;  // the warp's rows of a stage
  // ldmatrix: lane 8 q + i addresses row rw + i + 8 (q % 2) of chunk
  // 2 jj + q / 2 (jj: a pair of 8-column blocks)
  const int lrow = rw + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int lchunk = lane >> 4;
  // acc[I][J]: out(k, n) for k in 16 I + [0, 16), n in 8 J + [0, 8)
  float acc[2][kNT][4];
#pragma unroll
  for (int I = 0; I < 2; ++I)
#pragma unroll
    for (int J = 0; J < kNT; ++J)
      acc[I][J][0] = acc[I][J][1] = acc[I][J][2] = acc[I][J][3] = 0.0f;
  int stage = 0;
  uint32_t phase = 0;
  for (long long i = i0; i < i1; ++i) {
    const int node = node_of(i), r_end = r_end_of(i);
    for (int r = r0_of(i); r < r_end; r += kNRows) {
      sm90::mbar_wait(&full[stage], phase);
      const int valid = min(kNRows, r_end - r);
      if (rw < valid) {
        const char* st = smem + stage * p.stage;
        const unsigned short* xt = reinterpret_cast<const unsigned short*>(
            st + kNBox + sm90::run_offset(x_run(node, r)));
        // A(k, m) = x[m, k]: rows k = 16 I + gid (+8), depth m = rw +
        // 2 tig (+1, +8); rows past the stage's valid ones are zero (their
        // slot holds stale values; g's are zero-filled past M). Columns k
        // >= K read the next row's values into sums never stored.
        const int m = rw + 2 * tig;
        auto pair = [&](int mm, int k) -> uint32_t {
          const uint32_t lo = mm < valid ? xt[mm * K + k] : 0;
          const uint32_t hi = mm + 1 < valid ? xt[(mm + 1) * K + k] : 0;
          return lo | (hi << 16);
        };
        uint32_t a[2][4];
#pragma unroll
        for (int I = 0; I < 2; ++I) {
          const int k = 16 * I + gid;
          a[I][0] = pair(m, k);
          a[I][1] = pair(m, k + 8);
          a[I][2] = pair(m + 8, k);
          a[I][3] = pair(m + 8, k + 8);
        }
        const uint32_t box = sm90::smem_u32(st);
#pragma unroll
        for (int jj = 0; jj < kNT / 2; ++jj) {
          // b[0], b[1]: block 2 jj's depth halves; b[2], b[3]: 2 jj + 1's
          uint32_t b[4];
          const int c = 2 * jj + lchunk;
          sm90::ldmatrix_x4_trans(
              b, box + lrow * 128 + (((c ^ lrow) & 7) << 4));
#pragma unroll
          for (int I = 0; I < 2; ++I) {
            mma16816(acc[I][2 * jj], a[I], b[0], b[1]);
            mma16816(acc[I][2 * jj + 1], a[I], b[2], b[3]);
          }
        }
      }
      // the stage is free once every lane's loads have fed its mma
      __syncwarp();
      sm90::mbar_arrive_if(&empty[stage], lane == 0);
      if (++stage == kNStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // the item's sums: the eight warps' accumulators added in warp order
#pragma unroll
    for (int I = 0; I < 2; ++I)
#pragma unroll
      for (int J = 0; J < kNT; ++J)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 16 * I + gid + 8 * h, n = 8 * J + 2 * tig;
          *reinterpret_cast<float2*>(&red[(warp * 32 + k) * kNRedLd + n]) =
              make_float2(acc[I][J][2 * h], acc[I][J][2 * h + 1]);
          acc[I][J][2 * h] = acc[I][J][2 * h + 1] = 0.0f;
        }
    sm90::named_bar_sync(1, 32 * kNConsumers);
    float* out = p.out + i * static_cast<long long>(K) * N;
    for (int e = t256; e < K * N; e += 32 * kNConsumers) {
      const int k = e / N, n = e % N;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kNConsumers; ++w)
        s += red[(w * 32 + k) * kNRedLd + n];
      out[e] = s;
    }
    sm90::named_bar_sync(1, 32 * kNConsumers);  // red is free again
  }
}

// out[node, e] = sum over s in order of partial[node, s, e]
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int slices,
                                    long long per_node, long long total) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long node = i / per_node, e = i % per_node;
    const float* q = partial + node * slices * per_node + e;
    float s = 0.0f;
#pragma unroll 8
    for (int k = 0; k < slices; ++k) s += q[k * per_node];
    out[i] = s;
  }
}

}  // namespace

void launch_stream_wgrad(const void* x, const void* g, float* partial,
                         float* out, int n, int M, int K, int N, int route,
                         int rows, int slices, cudaStream_t stream) {
  float* dst = slices > 1 ? partial : out;
  if (route == kWgradNarrow) {
    NarrowParams p;
    p.g_map = sm90::make_tmap(
        Operand{static_cast<const bf16*>(g), static_cast<long long>(M) * N,
                N, N, M},
        n, kNRows);
    p.x = static_cast<const bf16*>(x);
    p.out = dst;
    p.M = M;
    p.K = K;
    p.N = N;
    p.rows = rows;
    p.slices = slices;
    p.stage = narrow_stage(K);
    p.items = static_cast<long long>(n) * slices;
    const int smem = narrow_smem(K);
    const int sms = sm90::sm_count();
    const int grid = static_cast<int>(p.items < sms ? p.items : sms);
    if (N <= 32) {
      cudaFuncSetAttribute(wgrad_narrow_bf16_kernel<4>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      wgrad_narrow_bf16_kernel<4><<<grid, kNThreads, smem, stream>>>(p);
    } else {
      cudaFuncSetAttribute(wgrad_narrow_bf16_kernel<8>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      wgrad_narrow_bf16_kernel<8><<<grid, kNThreads, smem, stream>>>(p);
    }
  } else if (route == kWgradWide) {
    WideParams p;
    const long long nM = M;
    p.g_map = sm90::make_tmap(
        Operand{static_cast<const bf16*>(g), nM * N, N, N, M}, n, kWRows);
    p.x_map = sm90::make_tmap(
        Operand{static_cast<const bf16*>(x), nM * K, K, K, M}, n, kWRows);
    p.out = dst;
    p.M = M;
    p.K = K;
    p.N = N;
    p.rows = rows;
    p.slices = slices;
    const int boxes = (K + 63) / 64;
    p.chunks_k = (boxes + kWCols / 64 - 1) / (kWCols / 64);
    p.box_base = boxes / p.chunks_k;
    p.extra = boxes % p.chunks_k;
    const int tiles = p.chunks_k * ((N + 63) / 64);
    cudaFuncSetAttribute(wgrad_wide_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
    wgrad_wide_kernel<<<dim3(tiles, slices, n), kWThreads, kWSmem, stream>>>(
        p);
  } else {
    GeneralParams p;
    p.x = static_cast<const bf16*>(x);
    p.g = static_cast<const bf16*>(g);
    p.out = dst;
    p.M = M;
    p.K = K;
    p.N = N;
    p.rows = rows;
    p.slices = slices;
    p.tiles_k = (K + 31) / 32;
    const int tiles = p.tiles_k * ((N + 31) / 32);
    cudaFuncSetAttribute(wgrad_general_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmem);
    wgrad_general_kernel<<<dim3(tiles, slices, n), kGThreads, kGSmem,
                           stream>>>(p);
  }
  if (slices > 1) {
    const long long per_node = static_cast<long long>(K) * N;
    const long long total = per_node * n;
    const int blocks = static_cast<int>((total + 255) / 256);
    wgrad_reduce_kernel<<<blocks, 256, 0, stream>>>(partial, out, slices,
                                                    per_node, total);
  }
}

}  // namespace p2pfl
