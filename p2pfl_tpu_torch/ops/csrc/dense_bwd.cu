// K3. Replaces p2pfl_tpu/ops/pallas_gemm.py::_dense_bwd (:249, kernel
// body _dense_bwd_kernel :238, pallas_call :255): the fused backward of
// y = x @ w, dx = g @ w^T and dw = x^T @ g, f32 sums cast once to bf16,
// with the node axis taken directly (x [n,B,D], w [n,D,H], g [n,B,H]).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at the ring shape
// (n = 8, B = 336, D = 3136, H = 2048): bytes and operations nearly
// balanced, 250 MB (0.075 ms) against 69 GFLOP (0.070 ms). At the
// cross-device shape (B = 20) it is bound by bytes: w in and dw out.
//
// Design: one persistent launch, one 288-thread block per SM, walking
// one tile list that holds both products of every node: first the dx
// tiles (node, 256-wide D slice, 128-row B slice innermost, so the
// three B slices of a ring step reuse one w slice from L2), then the dw
// tiles (node, D slice, H slice). A block takes every G-th dx tile, then
// its dw tiles, dealt round by round so that a block with one dx tile
// more takes fewer (a dx tile costs 4-13 dw tiles; schedule() below).
// Every tile is 128 x 256 of the output, summed over its whole depth
// (dx: H = 2048; dw: B) in 64-deep slices, so each output element is
// one f32 sum in a fixed order: the same bits on every run, no split-K
// and no atomics.
//   - Warp 8 is the producer: it loads each slice's A box (128 x 64,
//     16 KB) and B box (256 x 64, 32 KB) by TMA, 128-byte swizzled, into
//     a ring of 3 stages that complete on mbarriers. TMA zero-fills what
//     lies outside the operand, so a ragged B or D edge needs masking
//     only on store.
//   - Warps 0-7 are two consumer warpgroups, each owning 64 rows of the
//     tile: wgmma.mma_async m64n256k16 (bf16 in, f32 accumulators in
//     registers, 128 a thread) straight from the swizzled boxes, one
//     slice in flight while the previous one's stage is released. wgmma
//     reads either major order, so no transpose pass runs in device
//     memory:
//       dx = g w^T : A = g (K-major), B(h, d) = w[d, h] (K-major);
//       dw = x^T g : A(d, b) = x[b, d] (M-major), B = g (N-major).
//     n256 rather than n128 halves the tiles and the re-reads of A from
//     L2 and gives each wgmma more work per operand byte; at the ring
//     shape 128 x 128 tiles in 4 stages ran about 10% slower.
//     dx is tiled as [B, D], not as dx^T = w g^T: the store then needs
//     no transpose, and the cost, up to 127 padded rows of B per D
//     slice (336 -> 384 at the ring, 20 -> 128 at B = 20), is compute
//     this shape has to spare. (A warpgroup whose 64 rows all lie
//     beyond B still runs its wgmma on zeros: a branch around them is a
//     divergent path to ptxas, which then serializes every wgmma
//     (warning C7518): tried, and slower at the ring shape.)
//   - Epilogue: f32 -> bf16 once, staged in shared memory as swizzled
//     64 x 64 boxes and written by TMA stores, which clip the ragged
//     edge and complete in the background while the warpgroup already
//     runs its next tile (the producer has been loading it meanwhile).
// Widths whose rows are not 16-byte multiples (the card test's
// (21, 300, 70)) run the same kernel with the producer warp loading the
// boxes element by element (kTma = false) and the epilogue storing
// element by element from a padded stage.
//
// Earlier design: one 128-thread block per 64 x 64 tile, scalar 2-byte
// loads into unswizzled tiles, mma.sync m16n8k16, no overlap: 1.884 ms
// at the ring shape by chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W);
// PERF.md has its time beside this design's.
#include <algorithm>

#include "hopper.cuh"
#include "kernels.h"

namespace p2pfl {
namespace {

using sm90::Operand;

constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 3;
constexpr int kConsumerThreads = 256, kThreads = 288;
constexpr int kABytes = kBM * 128;             // A: 128 rows x 64 bf16
constexpr int kStageBytes = kABytes + kBN * 128;  // and B: 256 x 64
constexpr int kStageLd = kBN + 8;                 // epilogue row, bf16
// two warpgroups' epilogue stages: 64 padded rows each (element-wise
// stores), or two swizzled 64 x 64 boxes each (TMA stores)
constexpr int kEpiBytes = 2 * 64 * kStageLd * 2;
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + kEpiBytes + 128;

// One product C[M, N] = A[M, K] B[K, N] over the node axis.
struct Problem {
  Operand a, b;  // the operands as loaded (see load_slice)
  sm90::bf16* c;
  long long c_node, c_ld;
  int M, N, K, mt, nt;
  int vec;  // C's rows are 16-byte multiples
};

struct Params {
  CUtensorMap g_a;  // g [n,B,H], boxes 128 x 64 (dx's A, K-major)
  CUtensorMap w_b;  // w [n,D,H], boxes 256 x 64 (dx's B, K-major)
  CUtensorMap x_a;  // x [n,B,D], boxes 64 x 64 (dw's A, M-major)
  CUtensorMap g_b;  // g [n,B,H], boxes 64 x 64 (dw's B, N-major)
  CUtensorMap dx_c;  // dx [n,B,D], boxes 64 x 64 (dx's stores)
  CUtensorMap dw_c;  // dw [n,D,H], boxes 64 x 64 (dw's stores)
  Problem dx, dw;
  int tiles_dx, tiles;
  // dw tiles a block takes after its dx tiles (see schedule())
  int dw_hi, dw_lo, dw_extra;
};

// Block b's share of the tile list: the dx tiles b, b + G, b + 2G, ...
// (G blocks), then its dw tiles, dealt to the blocks round by round as
// cards are: in each round every block with dw tiles left takes the
// next one, so the blocks work on neighbouring tiles (one node's x and
// g stay in L2) and a block that drew one dx tile more takes fewer dw
// tiles (launch_dense_bwd's schedule()). Blocks b < r (r = dx tiles
// mod G) take dw_hi dw tiles, the others dw_lo, and the first dw_extra
// of those one more; dw_lo >= dw_hi.
struct Share {
  int b, G, r, n_dx, n, tiles_dx, hi;
  __device__ __forceinline__ int tile(int i) const {
    if (i < n_dx) return b + i * G;
    const int j = i - n_dx;
    if (j < hi) return tiles_dx + j * G + b;
    // later rounds: only the blocks b >= r deal on
    return tiles_dx + hi * G + (j - hi) * (G - r) + (b - r);
  }
};

__device__ __forceinline__ Share share_of(const Params& p) {
  Share s;
  s.b = blockIdx.x;
  s.G = gridDim.x;
  s.tiles_dx = p.tiles_dx;
  const int q = p.tiles_dx / s.G;
  s.r = p.tiles_dx % s.G;
  s.hi = p.dw_hi;
  s.n_dx = q + (s.b < s.r);
  const int n_dw = s.b < s.r ? p.dw_hi
                             : p.dw_lo + (s.b - s.r < p.dw_extra);
  s.n = s.n_dx + n_dw;
  return s;
}

struct Tile {
  int dw, node, m0, n0, kiters;
};

__device__ __forceinline__ Tile decode(const Params& p, int t) {
  Tile r;
  if (t < p.tiles_dx) {
    const int per = p.dx.mt * p.dx.nt;
    r.dw = 0;
    r.node = t / per;
    const int i = t % per;
    r.n0 = (i / p.dx.mt) * kBN;
    r.m0 = (i % p.dx.mt) * kBM;
    r.kiters = (p.dx.K + kBK - 1) / kBK;
  } else {
    t -= p.tiles_dx;
    const int per = p.dw.mt * p.dw.nt;
    r.dw = 1;
    r.node = t / per;
    const int i = t % per;
    r.m0 = (i / p.dw.nt) * kBM;
    r.n0 = (i % p.dw.nt) * kBN;
    r.kiters = (p.dw.K + kBK - 1) / kBK;
  }
  return r;
}

// The A and B boxes of one 64-deep slice k0 of tile `tl` into stage `s`.
template <bool kTma>
__device__ __forceinline__ void load_slice(const Params& p, const Tile& tl,
                                           int k0, char* s, uint64_t* bar,
                                           int lane) {
  char* a = s;
  char* b = s + kABytes;
  if (!tl.dw) {
    // dx: A = g (inner h = k, outer b = m), B = w (inner h = k, outer d = n)
    sm90::load_box<kTma>(a, &p.g_a, p.dx.a, bar, k0, tl.m0, tl.node, kBM, lane);
    sm90::load_box<kTma>(b, &p.w_b, p.dx.b, bar, k0, tl.n0, tl.node, kBN, lane);
  } else {
    // dw: A = x (inner d = m, outer b = k), B = g (inner h = n, outer b = k),
    // as 64-wide boxes
#pragma unroll
    for (int j = 0; j < kBM / 64; ++j)
      sm90::load_box<kTma>(a + j * sm90::kBoxBytes64, &p.x_a, p.dw.a, bar,
                           tl.m0 + 64 * j, k0, tl.node, 64, lane);
#pragma unroll
    for (int j = 0; j < kBN / 64; ++j)
      sm90::load_box<kTma>(b + j * sm90::kBoxBytes64, &p.g_b, p.dw.b, bar,
                           tl.n0 + 64 * j, k0, tl.node, 64, lane);
  }
}

// One warpgroup's mainloop over a tile's slices: kT = 0 for dx (both
// operands K-major), 1 for dw (both MN-major).
template <int kT>
__device__ __forceinline__ void mainloop(float (&acc)[kBN / 2], char* smem,
                                         uint64_t* full, uint64_t* empty,
                                         int& stage, uint32_t& phase,
                                         int kiters, int wg, int lane) {
  // MN-major: B's 64-wide blocks lie one box apart; K-major: unused
  // (16 B, as CUTLASS sets it)
  constexpr uint32_t lbo = kT ? sm90::kBoxBytes64 : 16;
  int prev = -1;
  for (int kb = 0; kb < kiters; ++kb) {
    sm90::mbar_wait(&full[stage], phase);
    const uint32_t a = sm90::smem_u32(smem + stage * kStageBytes) +
                       wg * sm90::kBoxBytes64;
    const uint32_t b = sm90::smem_u32(smem + stage * kStageBytes) +
                       kABytes;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // K-major: +32 B per k16; MN-major: +16 rows of 128 B
      const uint32_t step = kT ? kk * 2048 : kk * 32;
      sm90::wgmma_m64n256<kT, kT>(acc, sm90::make_desc(a + step, lbo),
                                  sm90::make_desc(b + step, lbo));
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    // the slice before this one has been read: its stage is free
    sm90::mbar_arrive_if(&empty[prev], prev >= 0 && lane == 0);
    prev = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  sm90::wgmma_wait<0>();
  sm90::fence_acc(acc);
  sm90::mbar_arrive_if(&empty[prev], prev >= 0 && lane == 0);
}

template <bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
    dense_bwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ char raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  sm90::bf16* epi =
      reinterpret_cast<sm90::bf16*>(smem + kStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + kStages * kStageBytes + kEpiBytes);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumerThreads / 32);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerThreads / 32) {
    // producer warp
    if (kTma && lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    const Share sh = share_of(p);
    for (int i = 0; i < sh.n; ++i) {
      const Tile tl = decode(p, sh.tile(i));
      for (int kb = 0; kb < tl.kiters; ++kb) {
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        char* s = smem + stage * kStageBytes;
        if constexpr (kTma) {
          sm90::mbar_expect_tx(&full[stage], kStageBytes);
          load_slice<true>(p, tl, kb * kBK, s, &full[stage], lane);
        } else {
          load_slice<false>(p, tl, kb * kBK, s, &full[stage], lane);
          sm90::fence_proxy_async();
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(&full[stage]);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroups
  const int wg = warp >> 2, t128 = threadIdx.x & 127;
  int stage = 0;
  uint32_t phase = 0;
  float acc[kBN / 2];
  const Share sh = share_of(p);
  for (int i = 0; i < sh.n; ++i) {
    const Tile tl = decode(p, sh.tile(i));
    const Problem& pr = tl.dw ? p.dw : p.dx;
    const int row0 = tl.m0 + 64 * wg;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.0f;
    sm90::fence_acc(acc);
    if (tl.dw)
      mainloop<1>(acc, smem, full, empty, stage, phase, tl.kiters, wg, lane);
    else
      mainloop<0>(acc, smem, full, empty, stage, phase, tl.kiters, wg, lane);
    if constexpr (kTma) {
      sm90::store_tile_tma<kBN>(acc, reinterpret_cast<char*>(epi) +
                                         wg * (kBN / 64) * sm90::kBoxBytes64,
                                tl.dw ? &p.dw_c : &p.dx_c, tl.n0, row0,
                                tl.node, row0 < pr.M, t128, 1 + wg);
    } else {
      sm90::store_tile<kBN>(
          acc, epi + wg * 64 * kStageLd,
          pr.c + tl.node * pr.c_node + row0 * pr.c_ld + tl.n0, pr.c_ld,
          pr.M - row0, pr.N - tl.n0, pr.vec != 0, t128, 1 + wg);
    }
  }
  if (kTma && t128 == 0) sm90::bulk_wait();
}

// Splits the dw tiles over the blocks so that each block's dx and dw
// tiles take about the same time. A tile's time is modelled from a
// block's share of the card (an SM's 1/132 of 3.35 TB/s and of
// 989 TFLOP/s): the larger of its bytes from device memory and its
// operations, plus 0.5 us of fixed cost (the epilogue's barriers and
// the pipeline's turn). A dx tile reads its w slice (shared by the
// tile's B slices through L2) and writes 128 x 128; a dw tile writes
// 128 x 128 and reads x and g from L2. At the ring shape a dx tile
// costs about 4 dw tiles (operations), at B = 20 about 12 (its w
// slice's bytes).
void schedule(Params& p, int grid, int B, int H) {
  const int tiles_dw = p.tiles - p.tiles_dx;
  const int r = p.tiles_dx % grid;
  auto us = [](double bytes, double flops) {
    return std::max(bytes / 25.4e3, flops / 7.49e6) + 0.5;
  };
  const double out = 2.0 * kBM * kBN;
  const double c_dx =
      us(2.0 * kBN * H / std::max(p.dx.mt, 1) + out,
         2.0 * kBM * kBN * ((H + kBK - 1) / kBK * kBK));
  const double c_dw =
      us(out, 2.0 * kBM * kBN * ((B + kBK - 1) / kBK * kBK));
  // blocks b < r hold q + 1 dx tiles and take dw_hi dw tiles; the
  // others take dw_hi + c_dx / c_dw, rounded
  int hi = 0;
  if (r > 0 && c_dw > 0) {
    const double k = (tiles_dw - (grid - r) * (c_dx / c_dw)) / grid;
    hi = k > 0 ? static_cast<int>(k) : 0;
    // at most an even share, so that dw_lo >= dw_hi
    hi = std::min(hi, tiles_dw / grid);
  }
  const int rest = tiles_dw - hi * r;
  p.dw_hi = hi;
  p.dw_lo = rest / (grid - r);
  p.dw_extra = rest - p.dw_lo * (grid - r);
}

}  // namespace

void launch_dense_bwd(const void* x, const void* w, const void* g,
                      void* dx, void* dw, int n, int B, int D, int H,
                      cudaStream_t stream) {
  using sm90::bf16;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* gp = static_cast<const bf16*>(g);
  const long long nB = B, nD = D, nH = H;
  Params p;
  // dx(b, d) = sum_h g(b, h) w(d, h): A = g rows b, B^T = w rows d
  p.dx.a = Operand{gp, nB * nH, nH, H, B};
  p.dx.b = Operand{wp, nD * nH, nH, H, D};
  p.dx.c = static_cast<bf16*>(dx);
  p.dx.c_node = nB * nD;
  p.dx.c_ld = nD;
  p.dx.M = B;
  p.dx.N = D;
  p.dx.K = H;
  // dw(d, h) = sum_b x(b, d) g(b, h): A^T = x rows b, B = g rows b
  p.dw.a = Operand{xp, nB * nD, nD, D, B};
  p.dw.b = Operand{gp, nB * nH, nH, H, B};
  p.dw.c = static_cast<bf16*>(dw);
  p.dw.c_node = nD * nH;
  p.dw.c_ld = nH;
  p.dw.M = D;
  p.dw.N = H;
  p.dw.K = B;
  for (Problem* pr : {&p.dx, &p.dw}) {
    pr->mt = (pr->M + kBM - 1) / kBM;
    pr->nt = (pr->N + kBN - 1) / kBN;
    pr->vec = pr->c_ld % 8 == 0 &&
              reinterpret_cast<uintptr_t>(pr->c) % 16 == 0;
  }
  p.tiles_dx = n * p.dx.mt * p.dx.nt;
  p.tiles = p.tiles_dx + n * p.dw.mt * p.dw.nt;
  if (p.tiles == 0) return;
  // TMA loads and stores need 16-byte rows (D and H multiples of 8) and
  // 16-byte-aligned bases
  const bool tma = sm90::tma_ok(p.dx.a, n) && sm90::tma_ok(p.dx.b, n) &&
                   sm90::tma_ok(p.dw.a, n) && p.dx.vec && p.dw.vec;
  const int grid = p.tiles < sm90::sm_count() ? p.tiles : sm90::sm_count();
  schedule(p, grid, B, H);
  if (tma) {
    p.g_a = sm90::make_tmap(p.dx.a, n, kBM);
    p.w_b = sm90::make_tmap(p.dx.b, n, kBN);
    p.x_a = sm90::make_tmap(p.dw.a, n, 64);
    p.g_b = sm90::make_tmap(p.dw.b, n, 64);
    p.dx_c = sm90::make_tmap(Operand{p.dx.c, p.dx.c_node, nD, D, B}, n, 64);
    p.dw_c = sm90::make_tmap(Operand{p.dw.c, p.dw.c_node, nH, H, D}, n, 64);
    cudaFuncSetAttribute(dense_bwd_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemBytes);
    dense_bwd_kernel<true><<<grid, kThreads, kSmemBytes, stream>>>(p);
  } else {
    cudaFuncSetAttribute(dense_bwd_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemBytes);
    dense_bwd_kernel<false><<<grid, kThreads, kSmemBytes, stream>>>(p);
  }
}

}  // namespace p2pfl
