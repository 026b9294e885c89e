// K1, K2 and K3 in float32: the instantiations of
// p2pfl_tpu/ops/pallas_gemm.py::_stream_gemm (:116, pallas_call :122),
// ::_stream_wgrad (:171, :177) and ::_dense_bwd (:249, :255) that the JAX
// package runs when the model computes in float32 (its `_dot` is
// dtype-generic, :101-112).
//
//   K1: out[n, M, N] = x[n, M, K] @ w[n, K, N]
//   K2: out[n, K, N] = x[n, M, K]^T @ g[n, M, N], summed over M
//   K3: dx[n, B, D] = g @ w^T and dw[n, D, H] = x^T @ g in one launch
//
// Bound on an H100 SXM at the f32 arm's ring step (8 nodes x 336
// FEMNIST-CNN samples), counting the least work that gives an
// f32-accurate product on this card: three TF32 passes at 495 TFLOP/s,
// or the bytes at 3.35 TB/s, whichever is longer. conv2's forward and
// weight gradient (M = 65,856 a node, K = 800, N = 64): 54 GFLOP over
// 1.8 GB, bytes, 0.54 ms (three TF32 passes 0.33 ms; exact SIMT FFMA at
// 67 TFLOP/s 0.80 ms). dense1's backward (B = 336, D = 3136, H = 2048):
// 69 GFLOP, operations, 3 x 69 / 495 = 0.42 ms (bytes 0.15 ms; SIMT 1.03
// ms). conv1's forward and weight gradient (K = 25, N = 32): bytes, 0.48
// GB, 0.14 ms; the ResNet9 stem's weight gradient (16 x 131,072 rows,
// K = 27, N = 64): bytes, 0.76 GB, 0.23 ms (7.2 GFLOP: FFMA 0.11 ms).
//
// Design, K >= 33 (conv2's forward and weight gradient, dense1's
// backward): 3xTF32 on wgmma.
// Each f32 operand a is split into hi = RN_tf32(a) and lo = RN_tf32(a -
// hi) (cvt.rna.tf32.f32; the tensor core is never handed a raw f32,
// whose low 13 bits it would drop), |a - hi - lo| <= 2^-22 |a|, and the
// product is hi.hi + hi.lo + lo.hi, three wgmma m64nNk8 with f32
// accumulators. wgmma takes TF32 operands from shared memory only
// K-major, so:
//   - the large operand (x for K1 and K2; w for dx^T and x for dw in K3)
//     is A: TMA loads 128-row x 32-deep f32 boxes in the 128-byte swizzle
//     into a ring of stages (one producer warp, mbarriers); each consumer
//     warpgroup reads its 64 rows' fragments from shared memory, splits
//     them in registers and issues wgmma with A from registers, so A may
//     lie K-major (x for K1, w) or M-major (x for K2 and dw) in device
//     memory;
//   - the small operand (w for K1, g for K2 and K3) is B. K1 and K3: a
//     pre-pass in this file splits it once a call into hi and lo,
//     K-major, into scratch the binding allocates ([n, 2, rows, depth]),
//     which TMA loads like A. K2: g is as long as x (conv2: 135 MB), and
//     such a pre-pass would read it and write its two halves (405 MB,
//     0.12 ms at the card's bytes rate beside a 0.54 ms bound) and the
//     GEMM read them again; instead TMA loads g's raw 32 x 64 box into
//     the stage and a fourth warpgroup (the transposer) splits it into B's
//     two halves in shared memory, in the layout the pre-pass writes,
//     fences them for wgmma and arrives on the stage's `ready` barrier.
// The k order inside each 8-deep step is permuted identically in A and
// B (the pre-pass writes B permuted), so that a thread's A fragment is
// two 16-byte loads a row (K-major) or one 8-byte load of two rows
// (M-major, rows of the fragment paired along M), conflict-free in the
// swizzle; the sum is the same sum in another order.
// dx is computed as dx^T = w g^T (M = D = 3136 = 49 x 64: no rows of B
// padded, as the bf16 K3's 336 -> 384), with B's 336 columns as three
// 112-wide tiles; its transpose needs no staging: a warp's store writes 8
// consecutive d for each of 4 b, whole 32-byte sectors. dw runs 128-wide
// tiles; K1 and K2 64-wide (N = 64). K2 is dw's form (A M-major) over a
// long contraction and a small output (conv2: 7 tiles of 128 x 64 a
// node): its rows are cut into the slices of ops/gemm.py::wgrad_plan
// (route f32_tc, 32-row multiples), the work items are (tile, slice)
// pairs, each writing its partial to [n, slices, K, N], and a second
// kernel adds the partials in slice order.
// Accumulation: the tensor core adds each wgmma's products into its f32
// accumulator by truncation, not rounding to nearest (probed on the card
// by wgmma_acc_probe below; Fasi, Higham, Mikaitis and Pranesh found the
// same on V100 and A100), a bias that grows with the number of k-steps.
// So each 32-deep box's 12 wgmma start from a fresh accumulator (scale-d
// 0), and the box's sum is added to an f32 register sum with
// round-to-nearest fadd (as FP8 GEMMs promote): every output is the same
// sum of boxes in the same order, so two runs give the same bits.
// Pipeline: one 288-thread persistent block per SM (K2: 416 with the
// transposer), warp 8 the producer, two consumer warpgroups of 64 rows
// each; a warpgroup waits for its
// box's wgmma before it splits the next, and the other warpgroup's
// wgmma fill the gap. K3 walks one tile list of both products, dx^T's
// tiles first, dealt to the blocks so that a block with one dx^T tile
// more takes fewer dw tiles (schedule() below). Rows that TMA cannot
// read (not 16-byte multiples) are loaded by the producer warp element
// by element into the same layout (kTma = false).
//
// Design, K <= 32 (conv1's forward and weight gradient, K = 25; the
// ResNet9 stem's, K = 27): exact SIMT FFMA, one fmaf chain a value in
// ascending row (the 3.4 and 7.2 GFLOP cost less than the bytes). K1: a
// block's 128 rows of x are one contiguous span (12,800 bytes at K =
// 25), copied with 16-byte cp.async into a ring of 4 stages; w's
// 32-column slice stays in shared memory; a thread sums 2 rows x 8
// columns and stores them with 16-byte stores. K2 (route f32_narrow): a
// persistent block walks its share of (node, slice, column tile) items;
// a chunk's 64 rows of x and of g are each one contiguous span (x's rows
// 100 or 108 bytes, g's 128 or 256), copied by 16-byte cp.async into a
// ring of 3 stages; a thread sums a 4 x 4 block of the whole [K, N]
// output in registers across the slice and writes its partial.
//
// Earlier designs: gemm_f32.cu's SIMT tiles (64 x 64 tiles, scalar loads,
// FFMA): 2.489 ms for conv1 and conv2's forward together (0.437 + 2.045),
// 2.796 ms for dense1's backward, and for K2 0.83 ms at conv1's weight
// gradient, 2.33 ms at conv2's and 0.738 ms at the stem's, by
// chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W); PERF.md has their times
// beside this design's.
#include <algorithm>

#include "hopper.cuh"
#include "kernels.h"

namespace p2pfl {
namespace {

// ---------------------------------------------------------------------------
// TF32 split and wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));
}

// Keeps registers that an in-flight wgmma reads (A fragments) live, and
// unmoved, until after the wait that retires it.
template <int kN>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int kN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[kN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d);

// D[64 x 64] (+)= A[64 x 8] B[8 x 64], tf32 in, f32 sums; A from four
// registers (tf32 bit patterns: a0 (row g, k t), a1 (row g + 8, k t),
// a2 (row g, k t + 4), a3 (row g + 8, k t + 4) of the warp's 16 rows,
// g = lane / 4, t = lane % 4), B K-major from shared memory; scale_d =
// 0 overwrites D.
template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 112] (+)= A[64 x 8] B[8 x 112], as above.
template <>
__device__ __forceinline__ void wgmma_tf32<112>(float (&d)[56],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 8] B[8 x 128], as above.
template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// the k order inside a 32-deep box (positions of B's split rows)
// ---------------------------------------------------------------------------

// K-major A: thread t of a quad holds box columns 8t .. 8t + 7 of a row
// (two 16-byte loads); in k-step s its slots t and t + 4 take columns
// 8t + 2s and 8t + 2s + 1. B's position 8s + p holds that k.
__host__ __device__ __forceinline__ int perm_kmajor(int q) {
  const int s = q >> 3, p = q & 7;
  return p < 4 ? 8 * p + 2 * s : 8 * (p - 4) + 2 * s + 1;
}

// M-major A: k-step s covers box rows 8s .. 8s + 7; slot p reads row
// 8s + kSigma[p], so that the four slots a load instruction reads (p =
// t or t + 4 over the quad) fall in rows 8 apart mod 8 by pairs: their
// swizzled chunks cover all 32 banks twice.
__host__ __device__ __forceinline__ int perm_mmajor(int q) {
  const int s = q >> 3, p = q & 7;
  return 8 * s + ((p & 1) << 2) + (p >> 1);
}

// ---------------------------------------------------------------------------
// pre-pass: split the small operand into hi and lo, K-major, permuted
// ---------------------------------------------------------------------------

// dst[z][h][r][pos] (h = 0 hi, 1 lo; r < rows_p; pos < depth_p) = the
// half h of src(z, r, k) with k = box base + perm(pos % 32), zero outside
// [rows) x [depth). src(z, r, k) = src[z * s_node + r * s_row + k * s_k].
// A 32 x 32 tile a block, transposed through shared memory so that the
// loads run along src's unit-stride axis and the stores along pos.
__global__ void __launch_bounds__(256)
    split_kernel(const float* __restrict__ src, long long s_node,
                 long long s_row, long long s_k, int rows, int depth,
                 float* __restrict__ dst, int rows_p, int depth_p,
                 int mmajor) {
  __shared__ float tile[32][33];  // [r][k within the box]
  const int z = blockIdx.z, r0 = blockIdx.y * 32, k0 = blockIdx.x * 32;
  const float* s = src + z * s_node;
  const bool k_fast = s_k == 1;
  for (int i = threadIdx.x; i < 1024; i += 256) {
    const int a = i >> 5, b = i & 31;
    const int rr = k_fast ? a : b, kk = k_fast ? b : a;
    const int r = r0 + rr, k = k0 + kk;
    tile[rr][kk] = r < rows && k < depth ? s[r * s_row + k * s_k] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 1024; i += 256) {
    const int rr = i >> 5, q = i & 31;
    const int r = r0 + rr;
    if (r >= rows_p) continue;
    const int kk = mmajor ? perm_mmajor(q) : perm_kmajor(q);
    uint32_t hi, lo;
    split_tf32(tile[rr][kk], hi, lo);
    const long long o = (static_cast<long long>(z) * 2 * rows_p + r) *
                            depth_p + k0 + q;
    dst[o] = __uint_as_float(hi);
    dst[o + static_cast<long long>(rows_p) * depth_p] = __uint_as_float(lo);
  }
}

// ---------------------------------------------------------------------------
// the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBoxK = 32, kConsumers = 256;
constexpr int kABytes = kBM * 128;  // 128 rows x 32 f32
constexpr int kSmemRing = 192 * 1024;

// One product C = A B over the node axis. A(m, k) of node z lies at
// a[z * a_node + m * a_ld + k] (K-major) or a[z * a_node + k * a_ld + m]
// (M-major); B is the pre-pass's split [n, 2, b_rows, kboxes * 32]
// (K1, K3) or K2's g itself (TcParams::g); C(m, j) at
// c[z * c_node + m * c_sm + j * c_sn].
struct TcProblem {
  const float* a;
  long long a_node, a_ld;
  float* c;
  long long c_node, c_sm, c_sn;
  int M, N, K;
  int mt, nt, kboxes, b_rows;
};

struct TcParams {
  CUtensorMap a_map[2];  // A boxes 32 x 128 (K-major) or 32 x 32 (M-major)
  CUtensorMap b_map[2];  // the split B, boxes 32 x BN; K2: g, 64 x 32
  TcProblem pr[2];
  int tiles0, tiles;
  // problem-1 tiles a block takes after its problem-0 tiles (schedule())
  int hi1, lo1, extra1;
  // K2 (problem 1): g [n, K, N]; the contraction cut into `slices`
  // slices of kb_slice 32-deep boxes (its plan), slice s summed on its
  // own into c + s * c_slice
  const float* g;
  int slices, kb_slice;
  long long c_slice;
};

// Block b's share of the tile list: the problem-0 tiles b, b + G, ...,
// then its problem-1 tiles, dealt round by round; blocks b < r (r =
// problem-0 tiles mod G, the blocks with one more) take hi1 of them, the
// others lo1, the first extra1 of those one more (lo1 >= hi1).
struct Share {
  int b, G, r, n0, n, tiles0, hi;
  __device__ __forceinline__ int tile(int i) const {
    if (i < n0) return b + i * G;
    const int j = i - n0;
    if (j < hi) return tiles0 + j * G + b;
    return tiles0 + hi * G + (j - hi) * (G - r) + (b - r);
  }
};

__device__ __forceinline__ Share share_of(const TcParams& p) {
  Share s;
  s.b = blockIdx.x;
  s.G = gridDim.x;
  s.tiles0 = p.tiles0;
  s.r = p.tiles0 % s.G;
  s.hi = p.hi1;
  s.n0 = p.tiles0 / s.G + (s.b < s.r);
  s.n = s.n0 + (s.b < s.r ? p.hi1 : p.lo1 + (s.b - s.r < p.extra1));
  return s;
}

// A work item: an output tile of problem p over the k-boxes [kb0, kb1):
// all of them (K1, K3), or one slice's (K2, kWgrad: a node's items run
// slice by slice, the tiles of a slice next to each other, sharing that
// slice's g through L2).
struct Tile {
  int p, node, slice, m0, n0, kb0, kb1;
};

template <int kBN0, int kBN1, bool kWgrad>
__device__ __forceinline__ Tile decode(const TcParams& p, int t) {
  Tile r;
  r.p = t < p.tiles0 ? 0 : 1;
  if (r.p) t -= p.tiles0;
  const TcProblem& pr = p.pr[r.p];
  const int per = pr.mt * pr.nt;
  r.slice = 0;
  if constexpr (kWgrad) {
    r.node = t / (per * p.slices);
    t %= per * p.slices;
    r.slice = t / per;
  } else {
    r.node = t / per;
  }
  const int i = t % per;
  r.m0 = (i / pr.nt) * kBM;
  r.n0 = (i % pr.nt) * (r.p ? kBN1 : kBN0);
  r.kb0 = kWgrad ? r.slice * p.kb_slice : 0;
  r.kb1 = kWgrad ? min(pr.kboxes, r.kb0 + p.kb_slice) : pr.kboxes;
  return r;
}

// The A box of k-box kb of tile tl into `s`, element by element by the
// 32 lanes of the producer warp, in the layout TMA would write.
__device__ __forceinline__ void load_a_elems(const TcProblem& pr,
                                             const Tile& tl, int kb, char* s,
                                             bool mmajor, int lane) {
  const float* a = pr.a + tl.node * pr.a_node;
  for (int i = lane; i < kBM * kBoxK; i += 32) {
    float v = 0.f;
    uint32_t off;
    if (!mmajor) {
      const int r = i >> 5, c = i & 31;
      const int m = tl.m0 + r, k = kb * kBoxK + c;
      if (m < pr.M && k < pr.K) v = a[m * pr.a_ld + k];
      off = sm90::swz128(r, 4 * c);
    } else {
      const int j = i >> 10, row = (i >> 5) & 31, c = i & 31;
      const int m = tl.m0 + 32 * j + c, k = kb * kBoxK + row;
      if (m < pr.M && k < pr.K) v = a[static_cast<long long>(k) * pr.a_ld + m];
      off = j * 4096 + sm90::swz128(row, 4 * c);
    }
    *reinterpret_cast<float*>(s + off) = v;
  }
}

// K2's g box of k-box kb (32 rows k x kBN columns j from n0, zero outside
// g) into `s` as TMA writes it without swizzle, by the producer warp.
template <int kBN>
__device__ __forceinline__ void load_g_elems(const float* g0,
                                             const TcProblem& pr,
                                             const Tile& tl, int kb, char* s,
                                             int lane) {
  const float* g = g0 + tl.node * static_cast<long long>(pr.K) * pr.N;
  float* d = reinterpret_cast<float*>(s);
  for (int i = lane; i < kBoxK * kBN; i += 32) {
    const int k = kb * kBoxK + i / kBN, j = tl.n0 + i % kBN;
    d[i] = k < pr.K && j < pr.N ? g[static_cast<long long>(k) * pr.N + j]
                                : 0.f;
  }
}

// K2's transposer warpgroup: for each k-box, once g's box (32 rows k x
// kBN columns j, row-major) has landed, writes its TF32 halves into the
// stage's B as the pre-pass would (B(j, q) = half of g[k0 + perm(q)][j],
// K-major, 128-byte swizzled), fences them for wgmma and arrives on
// `ready`. Thread t splits column j = t % 64 at positions 16 (t / 64) ..
// + 15, four at a time into one 16-byte chunk of each half.
template <int kBN, int kBN0, int kBN1, int kStages, int kStageBytes,
          int kBOff>
__device__ __forceinline__ void transpose_g(const TcParams& p, const Share& sh,
                                            char* smem, uint64_t* full,
                                            uint64_t* ready, int t,
                                            int lane) {
  static_assert(kBN == 64, "one thread a column, two halves of the depth");
  const int j = t & 63, q0 = 16 * (t >> 6);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < sh.n; ++i) {
    const Tile tl = decode<kBN0, kBN1, true>(p, sh.tile(i));
    for (int kb = tl.kb0; kb < tl.kb1; ++kb) {
      sm90::mbar_wait(&full[stage], phase);
      char* st = smem + stage * kStageBytes;
      const float* g = reinterpret_cast<const float*>(st + kABytes + 2 * kBOff);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int q = q0 + 4 * c;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(g[perm_mmajor(q + e) * kBN + j], hi[e], lo[e]);
        *reinterpret_cast<uint4*>(st + kABytes + sm90::swz128(j, 4 * q)) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(st + kABytes + kBOff +
                                  sm90::swz128(j, 4 * q)) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      sm90::fence_proxy_async();
      __syncwarp();
      sm90::mbar_arrive_if(&ready[stage], lane == 0);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// One warpgroup's share of a tile: 64 rows x kBN columns over all k-boxes,
// then its stores. kMM: A lies M-major (the fragment's rows paired).
template <int kBN, bool kMM, int kStages, int kStageBytes, int kBOff,
          bool kWgrad>
__device__ __forceinline__ void consume(const TcProblem& pr, const Tile& tl,
                                        long long c_slice, char* smem,
                                        uint64_t* full, uint64_t* empty,
                                        uint64_t* ready, int& stage,
                                        uint32_t& phase, int wg, int lane,
                                        int wq) {
  const int gid = lane >> 2, tig = lane & 3;
  // acc: the box's sum in the tensor core; sum: the boxes', to nearest
  float acc[kBN / 2], sum[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) sum[i] = acc[i] = 0.f;
  sm90::fence_acc(acc);
  for (int kb = tl.kb0; kb < tl.kb1; ++kb) {
    sm90::mbar_wait(&full[stage], phase);
    if constexpr (kWgrad) sm90::mbar_wait(&ready[stage], phase);
    char* st = smem + stage * kStageBytes;
    uint32_t hi[4][4], lo[4][4];
    if constexpr (!kMM) {
      // rows gid and gid + 8 of the warp's 16: columns 8 tig .. 8 tig + 7
      float v[2][8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * wg + 16 * wq + gid + 8 * h;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float4 q = *reinterpret_cast<const float4*>(
              st + sm90::swz128(r, 32 * tig + 16 * c));
          v[h][4 * c] = q.x;
          v[h][4 * c + 1] = q.y;
          v[h][4 * c + 2] = q.z;
          v[h][4 * c + 3] = q.w;
        }
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        split_tf32(v[0][2 * s], hi[s][0], lo[s][0]);
        split_tf32(v[1][2 * s], hi[s][1], lo[s][1]);
        split_tf32(v[0][2 * s + 1], hi[s][2], lo[s][2]);
        split_tf32(v[1][2 * s + 1], hi[s][3], lo[s][3]);
      }
    } else {
      // rows 2 gid and 2 gid + 1 of the warp's 16 (fragment rows gid and
      // gid + 8), box row 8s + perm slot
      const char* box = st + (2 * wg + (wq >> 1)) * 4096;
      const int col = 4 * (16 * (wq & 1) + 2 * gid);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int row = perm_mmajor(8 * s + tig + 4 * u);
          const float2 q = *reinterpret_cast<const float2*>(
              box + sm90::swz128(row, col));
          split_tf32(q.x, hi[s][2 * u], lo[s][2 * u]);
          split_tf32(q.y, hi[s][2 * u + 1], lo[s][2 * u + 1]);
        }
      }
    }
    const uint32_t bh = sm90::smem_u32(st + kABytes);
    const uint32_t bl = bh + kBOff;
    sm90::wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      // the small terms first; the box's first wgmma restarts the sum
      wgmma_tf32<kBN>(acc, lo[s], sm90::make_desc(bh + 32 * s, 16),
                      s == 0 ? 0 : 1);
      wgmma_tf32<kBN>(acc, hi[s], sm90::make_desc(bl + 32 * s, 16), 1);
      wgmma_tf32<kBN>(acc, hi[s], sm90::make_desc(bh + 32 * s, 16), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(acc);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      fence_regs(hi[s]);
      fence_regs(lo[s]);
    }
    sm90::mbar_arrive_if(&empty[stage], lane == 0);
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  // d[4j + 2h + e] is fragment row gid + 8h, column 8j + 2 tig + e
  float* c = pr.c + tl.node * pr.c_node;
  if constexpr (kWgrad) c += tl.slice * c_slice;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tl.m0 + 64 * wg + 16 * wq +
                      (kMM ? 2 * gid + h : gid + 8 * h);
      if (row >= pr.M) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = tl.n0 + 8 * j + 2 * tig + e;
        if (col < pr.N)
          c[row * pr.c_sm + col * pr.c_sn] = sum[4 * j + 2 * h + e];
      }
    }
}

// kBN0: problem 0's tile width (A K-major); kBN1: problem 1's (A
// M-major); 0 for a problem that is absent. One instantiation a kernel:
// K1 <64, 0>, K3 <112, 128>, K2 <0, 64> with kWgrad: sliced, and g split
// in shared memory by a fourth warpgroup (no pre-pass; a stage holds g's
// 32 x 64 box beside the B it is split into).
template <int kBN0, int kBN1, bool kWgrad>
struct TcCfg {
  static constexpr int kBNMax = kBN0 > kBN1 ? kBN0 : kBN1;
  static constexpr int kBOff = kBNMax * 128;  // lo after hi
  static constexpr int kGBytes = kWgrad ? kBoxK * kBNMax * 4 : 0;
  static constexpr int kStageBytes = kABytes + 2 * kBOff + kGBytes;
  static constexpr int kStages = kSmemRing / kStageBytes;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 256;
  // consumer warpgroups, the producer warp, K2's transposer warpgroup
  static constexpr int kThreads = kConsumers + 32 + (kWgrad ? 128 : 0);
};

template <bool kTma, int kBN0, int kBN1, bool kWgrad>
__global__ void __launch_bounds__(TcCfg<kBN0, kBN1, kWgrad>::kThreads, 1)
    gemm_tc_kernel(const __grid_constant__ TcParams p) {
  using Cfg = TcCfg<kBN0, kBN1, kWgrad>;
  constexpr int kStages = Cfg::kStages, kStageBytes = Cfg::kStageBytes;
  extern __shared__ char raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* ready = empty + kStages;  // K2: B split from g

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers / 32);
      if constexpr (kWgrad) sm90::mbar_init(&ready[s], 4);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  const Share sh = share_of(p);

  if constexpr (kWgrad) {
    if (warp > kConsumers / 32) {
      transpose_g<kBN1, kBN0, kBN1, kStages, kStageBytes, Cfg::kBOff>(
          p, sh, smem, full, ready, threadIdx.x - kConsumers - 32, lane);
      return;
    }
  }
  if (warp == kConsumers / 32) {
    // the producer warp
    if (kTma && lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int i = 0; i < sh.n; ++i) {
      const Tile tl = decode<kBN0, kBN1, kWgrad>(p, sh.tile(i));
      const TcProblem& pr = p.pr[tl.p];
      const int bn = tl.p ? kBN1 : kBN0;
      const bool mmajor = tl.p == 1;
      for (int kb = tl.kb0; kb < tl.kb1; ++kb) {
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        char* s = smem + stage * kStageBytes;
        if constexpr (!kTma) {
          load_a_elems(pr, tl, kb, s, mmajor, lane);
          if constexpr (kWgrad)
            load_g_elems<kBN1>(p.g, pr, tl, kb,
                               s + kABytes + 2 * Cfg::kBOff, lane);
          __syncwarp();
        }
        if (lane == 0) {
          // K2's g box (by TMA where A is), or B's two halves (always)
          const int b_bytes = kWgrad ? (kTma ? Cfg::kGBytes : 0)
                                     : 2 * bn * 128;
          sm90::mbar_expect_tx(&full[stage],
                               (kTma ? kABytes : 0) + b_bytes);
          if constexpr (kTma) {
            if (!mmajor) {
              sm90::tma_load_3d(s, &p.a_map[tl.p], &full[stage], kb * kBoxK,
                                tl.m0, tl.node);
            } else {
#pragma unroll
              for (int j = 0; j < kBM / 32; ++j)
                sm90::tma_load_3d(s + j * 4096, &p.a_map[tl.p], &full[stage],
                                  tl.m0 + 32 * j, kb * kBoxK, tl.node);
            }
          }
          if constexpr (kWgrad) {
            if constexpr (kTma)
              sm90::tma_load_3d(s + kABytes + 2 * Cfg::kBOff, &p.b_map[tl.p],
                                &full[stage], tl.n0, kb * kBoxK, tl.node);
          } else {
            sm90::tma_load_3d(s + kABytes, &p.b_map[tl.p], &full[stage],
                              kb * kBoxK, tl.n0, tl.node);
            sm90::tma_load_3d(s + kABytes + Cfg::kBOff, &p.b_map[tl.p],
                              &full[stage], kb * kBoxK, pr.b_rows + tl.n0,
                              tl.node);
          }
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, wq = warp & 3;
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < sh.n; ++i) {
    const Tile tl = decode<kBN0, kBN1, kWgrad>(p, sh.tile(i));
    if constexpr (kBN1 > 0) {
      if (tl.p) {
        consume<kBN1, true, kStages, kStageBytes, Cfg::kBOff, kWgrad>(
            p.pr[1], tl, p.c_slice, smem, full, empty, ready, stage, phase,
            wg, lane, wq);
        continue;
      }
    }
    if constexpr (kBN0 > 0)
      consume<kBN0, false, kStages, kStageBytes, Cfg::kBOff, kWgrad>(
          p.pr[0], tl, p.c_slice, smem, full, empty, ready, stage, phase,
          wg, lane, wq);
  }
}

// ---------------------------------------------------------------------------
// K1, K <= 32: exact SIMT FFMA over contiguous row spans
// ---------------------------------------------------------------------------

constexpr int kNRows = 128, kNCols = 32, kNThreads = 256, kNStages = 4;

struct NarrowParams {
  const float* x;
  const float* w;
  float* out;
  long long M;
  int K, N, mblocks, nblocks;
  long long tiles;
  int stage_floats;  // kNRows * K rounded up to 4
};

int narrow_smem(int K) {
  return (kNCols * 32 + kNStages * ((kNRows * K + 3) / 4 * 4)) * 4;
}

__global__ void __launch_bounds__(kNThreads)
    gemm_narrow_f32_kernel(const NarrowParams p) {
  extern __shared__ __align__(16) float nsm[];
  float* ws = nsm;                 // [K][32] slice of w
  float* xs = nsm + kNCols * 32;   // the stages
  const int K = p.K, N = p.N;
  const long long per_node = static_cast<long long>(p.mblocks) * p.nblocks;
  const long long t0 = p.tiles * blockIdx.x / gridDim.x;
  const long long t1 = p.tiles * (blockIdx.x + 1) / gridDim.x;
  // tile t: node t / per_node, then its n-block, its m-block innermost
  auto node_of = [&](long long t) { return t / per_node; };
  auto nb_of = [&](long long t) {
    return static_cast<int>(t % per_node / p.mblocks);
  };
  auto m0_of = [&](long long t) {
    return static_cast<long long>(t % p.mblocks) * kNRows;
  };
  auto issue = [&](long long t, int s) {
    if (t < t1) {
      const long long m0 = m0_of(t);
      const long long rows = p.M - m0 < kNRows ? p.M - m0 : kNRows;
      const float* src = p.x + (node_of(t) * p.M + m0) * K;
      float* dst = xs + s * p.stage_floats;
      const long long count = rows * K;
      long long done = 0;
      if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
        for (long long c = threadIdx.x; c < count / 4; c += kNThreads)
          sm90::cp_async16(dst + 4 * c, src + 4 * c);
        done = count / 4 * 4;
      }
      for (long long e = done + threadIdx.x; e < count; e += kNThreads)
        dst[e] = src[e];
    }
    sm90::cp_async_commit();
  };

  for (int i = 0; i < kNStages - 1; ++i) issue(t0 + i, i);
  const int r = threadIdx.x >> 2, c0 = 8 * (threadIdx.x & 3);
  long long cur = -1;
  int i = 0;
  for (long long t = t0; t < t1; ++t, ++i) {
    sm90::cp_async_wait<kNStages - 2>();
    __syncthreads();  // tile t has landed; every thread is done with t - 1
    issue(t + kNStages - 1, (i + kNStages - 1) % kNStages);
    const long long node = node_of(t);
    const int nb = nb_of(t);
    const long long key = node * p.nblocks + nb;
    if (key != cur) {
      const float* w = p.w + node * K * N + nb * kNCols;
      for (int e = threadIdx.x; e < K * kNCols; e += kNThreads) {
        const int k = e / kNCols, c = e % kNCols;
        ws[e] = nb * kNCols + c < N ? w[k * N + c] : 0.f;
      }
      __syncthreads();
      cur = key;
    }
    const float* xt = xs + (i % kNStages) * p.stage_floats;
    float acc[2][8] = {};
    for (int k = 0; k < K; ++k) {
      const float xa = xt[r * K + k], xb = xt[(r + 64) * K + k];
      const float4 u = *reinterpret_cast<const float4*>(ws + k * kNCols + c0);
      const float4 v =
          *reinterpret_cast<const float4*>(ws + k * kNCols + c0 + 4);
      const float wv[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[0][j] = fmaf(xa, wv[j], acc[0][j]);
        acc[1][j] = fmaf(xb, wv[j], acc[1][j]);
      }
    }
    const long long m0 = m0_of(t);
    const int n0 = nb * kNCols + c0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + r + 64 * h;
      if (m >= p.M) continue;
      float* o = p.out + (node * p.M + m) * N + n0;
      if (N % 4 == 0 && n0 + 8 <= N &&
          reinterpret_cast<uintptr_t>(p.out) % 16 == 0) {
        reinterpret_cast<float4*>(o)[0] =
            make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
        reinterpret_cast<float4*>(o)[1] =
            make_float4(acc[h][4], acc[h][5], acc[h][6], acc[h][7]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (n0 + j < N) o[j] = acc[h][j];
      }
    }
  }
  sm90::cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// K2, K <= 32: exact SIMT FFMA over contiguous row spans
// ---------------------------------------------------------------------------

constexpr int kWnRows = kWgradF32NarrowRows;  // rows a chunk
constexpr int kWnStages = 3;
constexpr int kWnCols = 64;   // g columns a tile at most
constexpr int kWnDepth = 32;  // x columns a tile at most
constexpr int kWnMaxThreads = (kWnDepth / 4) * (kWnCols / 4);

// A work item is (node, slice, column tile, depth tile): out(k, c) = the
// sum over the slice's rows r, ascending, of x[r, k] g[r, c], for the
// tile's k and c, one fmaf chain a value. Thread t < kgs * cgs sums the
// 4 x 4 block k = k0 + 4 (t / cgs) + i, c = c0 + 4 (t % cgs) + j. At K <=
// 32 (the route's shapes) one depth tile holds every k, and a chunk's
// rows of x are one span; a wider K (a contraction of one box or less,
// which the plan sends here) is gathered 32 columns a tile.
struct WgradNarrowParams {
  const float* x;  // [n, M, K]
  const float* g;  // [n, M, N]
  float* out;      // [n, slices, K, N]
  int M, K, N, rows, slices, ctiles, ktiles, kgs, cgs;
  int ldx;    // x's row stride in a stage: K (a span) or kWnDepth
  int ldg;    // g's: N (a span) or kWnCols
  int xspan;  // x's tile is the whole row (K <= 32)
  int span;   // g's tile is the whole row (N <= 64, N % 4 == 0)
  int stage_floats, x_floats;
  long long items;
};

int wgrad_narrow_smem(const WgradNarrowParams& p) {
  return kWnStages * p.stage_floats * 4;
}

// `count` floats from src to dst (16-byte aligned): 16-byte cp.async
// where src is 16-byte aligned, 4-byte ones for the rest
__device__ __forceinline__ void span_copy(float* dst, const float* src,
                                          int count) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = threadIdx.x; i < count / 4; i += blockDim.x)
      sm90::cp_async16(dst + 4 * i, src + 4 * i);
    done = count / 4 * 4;
  }
  for (int i = done + threadIdx.x; i < count; i += blockDim.x)
    sm90::cp_async4(dst + i, src + i);
}

__global__ void __launch_bounds__(kWnMaxThreads)
    wgrad_narrow_f32_kernel(const WgradNarrowParams p) {
  extern __shared__ __align__(16) float wsm[];
  const int K = p.K, t = threadIdx.x;
  const long long i0 = p.items * blockIdx.x / gridDim.x;
  const long long i1 = p.items * (blockIdx.x + 1) / gridDim.x;
  // item i: node i / (slices * ctiles * ktiles), then its slice, its
  // column tile, its depth tile innermost; a slice's rows [r0, r_end) of
  // its node
  struct Item {
    long long node;
    int slice, ct, kt, r0, r_end, chunks;
  };
  auto item = [&](long long i) {
    Item it;
    const int tiles = p.ctiles * p.ktiles;
    it.node = i / (static_cast<long long>(p.slices) * tiles);
    const int rest = static_cast<int>(i % (static_cast<long long>(p.slices) *
                                           tiles));
    it.slice = rest / tiles;
    it.ct = rest % tiles / p.ktiles;
    it.kt = rest % p.ktiles;
    it.r0 = it.slice * p.rows;
    it.r_end = min(p.M, it.r0 + p.rows);
    it.chunks = (it.r_end - it.r0 + kWnRows - 1) / kWnRows;
    return it;
  };
  // chunk c of item `it` into stage s: x's and g's rows each as one span
  // (xspan, span) or the tile's columns row by row, zero past K or N
  auto issue = [&](const Item& it, int c, int s) {
    const int r = it.r0 + c * kWnRows;
    const int rows = min(kWnRows, it.r_end - r);
    float* xs = wsm + s * p.stage_floats;
    float* gs = xs + p.x_floats;
    const long long row = it.node * p.M + r;
    if (p.xspan) {
      span_copy(xs, p.x + row * K, rows * K);
    } else {
      const int k0 = it.kt * kWnDepth;
      for (int e = t; e < rows * kWnDepth; e += blockDim.x) {
        const int rr = e / kWnDepth, kk = k0 + e % kWnDepth;
        const float* src = p.x + (row + rr) * K + (kk < K ? kk : 0);
        sm90::cp_async4(xs + e, src, kk < K ? 4 : 0);
      }
    }
    if (p.span) {
      span_copy(gs, p.g + row * p.N, rows * p.N);
    } else {
      const int c0 = it.ct * kWnCols;
      for (int e = t; e < rows * kWnCols; e += blockDim.x) {
        const int rr = e / kWnCols, cc = c0 + e % kWnCols;
        const float* src = p.g + (row + rr) * p.N + (cc < p.N ? cc : 0);
        sm90::cp_async4(gs + rr * kWnCols + e % kWnCols, src,
                        cc < p.N ? 4 : 0);
      }
    }
  };
  // the issue side walks (item, chunk) kWnStages - 1 ahead of the sums
  long long in_i = i0;
  int in_c = 0;
  Item in_it = item(i0);
  auto issue_next = [&](int s) {
    if (in_i < i1) {
      issue(in_it, in_c, s);
      if (++in_c == in_it.chunks) {
        in_c = 0;
        if (++in_i < i1) in_it = item(in_i);
      }
    }
    sm90::cp_async_commit();
  };
  for (int s = 0; s < kWnStages - 1; ++s) issue_next(s);

  const bool mine = t < p.kgs * p.cgs;
  const int kg = mine ? t / p.cgs : 0, cg = mine ? t % p.cgs : 0;
  float acc[4][4] = {};
  int stage = 0;
  for (long long i = i0; i < i1; ++i) {
    const Item it = item(i);
    for (int c = 0; c < it.chunks; ++c) {
      sm90::cp_async_wait<kWnStages - 2>();
      __syncthreads();  // chunk c has landed; every thread is done with
                        // the stage the next issue refills
      issue_next(stage == 0 ? kWnStages - 1 : stage - 1);
      const float* xs = wsm + stage * p.stage_floats + 4 * kg;
      const int ldx = p.ldx;
      const float* gs = wsm + stage * p.stage_floats + p.x_floats + 4 * cg;
      const int rows = min(kWnRows, it.r_end - it.r0 - c * kWnRows);
      if (mine) {
#pragma unroll 4
        for (int r = 0; r < rows; ++r) {
          // k past K reads the next row's values (or the stage's
          // padding) into sums that are never stored
          const float xv[4] = {xs[r * ldx], xs[r * ldx + 1],
                               xs[r * ldx + 2], xs[r * ldx + 3]};
          const float4 gv = *reinterpret_cast<const float4*>(gs + r * p.ldg);
          const float gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc[a][b] = fmaf(xv[a], gw[b], acc[a][b]);
        }
      }
      stage = stage == kWnStages - 1 ? 0 : stage + 1;
    }
    if (mine) {
      float* o = p.out + ((it.node * p.slices + it.slice) *
                              static_cast<long long>(K)) * p.N;
      const int c0 = it.ct * kWnCols + 4 * cg;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int k = it.kt * kWnDepth + 4 * kg + a;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (k < K && c0 + b < p.N) o[k * p.N + c0 + b] = acc[a][b];
          acc[a][b] = 0.f;
        }
      }
    }
  }
  sm90::cp_async_wait<0>();
}

// out[node, e] = sum over s in order of partial[node, s, e]. A few
// thousand outputs take hundreds of slices each (conv1: 6,400 x 458), so
// the pass is bound by load latency: each thread loads kSumBatch slices
// into registers before it adds them, in order.
constexpr int kSumBatch = 32;

__global__ void slice_sum_f32_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int slices,
                                     long long per_node, long long total) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long node = i / per_node, e = i % per_node;
    const float* q = partial + node * slices * per_node + e;
    float s = 0.0f;
    for (int k = 0; k < slices; k += kSumBatch, q += kSumBatch * per_node) {
      const int n = min(kSumBatch, slices - k);
      float v[kSumBatch];
#pragma unroll
      for (int j = 0; j < kSumBatch; ++j)
        v[j] = j < n ? q[j * per_node] : 0.0f;
#pragma unroll
      for (int j = 0; j < kSumBatch; ++j)
        if (j < n) s += v[j];
    }
    out[i] = s;
  }
}

// ---------------------------------------------------------------------------
// the accumulation probe
// ---------------------------------------------------------------------------

// One warpgroup: d_tc[64 x 64] = a[64 x K] @ bt[64 x K]^T summed by
// wgmma m64n64k8 in one accumulator over all of K (no promotion; A from
// registers in the natural k order, B's 32-deep boxes staged in the
// 128-byte swizzle), and d_chain by one fmaf chain a value in ascending
// k. With tf32-valued inputs every product is exact, so the two differ
// only in how the sums round.
__global__ void __launch_bounds__(128)
    wgmma_acc_probe_kernel(const float* __restrict__ a,
                           const float* __restrict__ bt,
                           float* __restrict__ d_tc,
                           float* __restrict__ d_chain, int K) {
  __shared__ __align__(1024) char box[64 * 128];
  const int t = threadIdx.x, wq = t >> 5, lane = t & 31;
  const int gid = lane >> 2, tig = lane & 3;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  sm90::fence_acc(acc);
  for (int k0 = 0; k0 < K; k0 += kBoxK) {
    __syncthreads();
    for (int e = t; e < 64 * kBoxK; e += 128) {
      const int n = e >> 5, c = e & 31;
      *reinterpret_cast<float*>(box + sm90::swz128(n, 4 * c)) =
          k0 + c < K ? bt[n * K + k0 + c] : 0.f;
    }
    sm90::fence_proxy_async();
    __syncthreads();
    uint32_t fr[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = 16 * wq + gid + 8 * (q & 1);
        const int k = k0 + 8 * s + tig + 4 * (q >> 1);
        fr[s][q] = __float_as_uint(k < K ? a[row * K + k] : 0.f);
      }
    sm90::wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma_tf32<64>(acc, fr[s],
                     sm90::make_desc(sm90::smem_u32(box) + 32 * s, 16), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(acc);
#pragma unroll
    for (int s = 0; s < 4; ++s) fence_regs(fr[s]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        d_tc[(16 * wq + gid + 8 * h) * 64 + 8 * j + 2 * tig + e] =
            acc[4 * j + 2 * h + e];
  for (int o = t; o < 64 * 64; o += 128) {
    const int m = o >> 6, n = o & 63;
    float s = 0.f;
    for (int k = 0; k < K; ++k) s = fmaf(a[m * K + k], bt[n * K + k], s);
    d_chain[o] = s;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// A TMA descriptor of an f32 operand [n, outer, inner] (row stride ld
// elements, node stride node elements) loading boxes of 32 x box_rows in
// the 128-byte swizzle (or, for K2's g, box_inner x box_rows unswizzled),
// zero-filled outside the operand.
CUtensorMap make_tmap_f32(const float* p, int inner, int outer, int n,
                          long long ld, long long node, int box_rows,
                          int box_inner = 32, bool swizzle = true) {
  CUtensorMap m;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 4,
                                 static_cast<cuuint64_t>(node) * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = sm90::encode_tiled()(
      &m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(p), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS)
    throw std::runtime_error("cuTensorMapEncodeTiled failed: " +
                             std::to_string(static_cast<int>(r)));
  return m;
}

// B of one problem: src(z, r, k) split into dst [n, 2, rows_p, depth_p].
void split(const float* src, long long s_node, long long s_row,
           long long s_k, int rows, int depth, float* dst, int rows_p,
           int depth_p, int n, bool mmajor, cudaStream_t stream) {
  if (rows_p == 0 || depth_p == 0 || n == 0) return;
  split_kernel<<<dim3(depth_p / 32, (rows_p + 31) / 32, n), 256, 0,
                 stream>>>(src, s_node, s_row, s_k, rows, depth, dst, rows_p,
                           depth_p, mmajor ? 1 : 0);
}

TcProblem tc_problem(const float* a, long long a_node, long long a_ld,
                     float* c, long long c_node, long long c_sm,
                     long long c_sn, int M, int N, int K, int bn,
                     int b_rows) {
  TcProblem pr;
  pr.a = a;
  pr.a_node = a_node;
  pr.a_ld = a_ld;
  pr.c = c;
  pr.c_node = c_node;
  pr.c_sm = c_sm;
  pr.c_sn = c_sn;
  pr.M = M;
  pr.N = N;
  pr.K = K;
  pr.mt = (M + kBM - 1) / kBM;
  pr.nt = (N + bn - 1) / bn;
  pr.kboxes = (K + kBoxK - 1) / kBoxK;
  pr.b_rows = b_rows;
  return pr;
}

// Splits the problem-1 tiles over the blocks so that each block's work
// is about even: a tile costs its wgmma columns times its k-boxes, plus
// one box for the epilogue.
void schedule(TcParams& p, int grid, int bn0, int bn1) {
  const int tiles1 = p.tiles - p.tiles0;
  const int r = p.tiles0 % grid;
  const double c0 = static_cast<double>(bn0) * (p.pr[0].kboxes + 1);
  const double c1 = static_cast<double>(bn1) * (p.pr[1].kboxes + 1);
  int hi = 0;
  if (r > 0 && tiles1 > 0) {
    const double k = (tiles1 - (grid - r) * (c0 / c1)) / grid;
    hi = k > 0 ? static_cast<int>(k) : 0;
    hi = std::min(hi, tiles1 / grid);
  }
  const int rest = tiles1 - hi * r;
  p.hi1 = hi;
  p.lo1 = rest / (grid - r);
  p.extra1 = rest - p.lo1 * (grid - r);
}

template <bool kTma, int kBN0, int kBN1, bool kWgrad = false>
void launch_tc(const TcParams& p, cudaStream_t stream) {
  using Cfg = TcCfg<kBN0, kBN1, kWgrad>;
  cudaFuncSetAttribute(gemm_tc_kernel<kTma, kBN0, kBN1, kWgrad>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       Cfg::kSmem);
  const int grid = p.tiles < sm90::sm_count() ? p.tiles : sm90::sm_count();
  gemm_tc_kernel<kTma, kBN0, kBN1, kWgrad>
      <<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(p);
}

// The A map of a problem (K-major: boxes of 32 k x 128 rows; M-major:
// 32 m x 32 k) and its split B's (boxes of 32 x bn), where the problem
// has work; TMA cannot describe an empty operand.
void maps(TcParams& p, int i, const float* b, bool mmajor, bool tma,
          int n, int bn) {
  const TcProblem& pr = p.pr[i];
  if (pr.mt * pr.nt == 0 || pr.kboxes == 0 || n == 0) return;
  if (tma) {
    p.a_map[i] = mmajor ? make_tmap_f32(pr.a, pr.M, pr.K, n, pr.a_ld,
                                        pr.a_node, 32)
                        : make_tmap_f32(pr.a, pr.K, pr.M, n, pr.a_ld,
                                        pr.a_node, kBM);
  }
  const int depth_p = pr.kboxes * kBoxK;
  p.b_map[i] = make_tmap_f32(b, depth_p, 2 * pr.b_rows, n, depth_p,
                             2LL * pr.b_rows * depth_p, bn);
}

bool tma_ok(const float* p, long long ld, long long node) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 4 == 0 &&
         node % 4 == 0;
}

constexpr int kK1BN = 64, kDxBN = 112, kDwBN = 128, kK2BN = 64;

}  // namespace

long long stream_gemm_f32_scratch(int n, int K, int N) {
  if (K <= 32) return 0;
  return 2LL * n * round_up(N, kK1BN) * round_up(K, kBoxK);
}

long long dense_bwd_f32_scratch(int n, int B, int H) {
  return 2LL * n * (static_cast<long long>(round_up(B, kDxBN)) *
                        round_up(H, kBoxK) +
                    static_cast<long long>(round_up(H, kDwBN)) *
                        round_up(B, kBoxK));
}

int stream_gemm_f32_branch(int K) {
  return K <= 32 ? kGemmF32Ffma : kGemmF32Tc;
}

void launch_stream_gemm_f32(const float* x, const float* w, float* out,
                            float* scratch, int n, int M, int K, int N,
                            cudaStream_t stream) {
  if (n == 0 || M == 0 || N == 0) return;
  if (stream_gemm_f32_branch(K) == kGemmF32Ffma) {
    NarrowParams p;
    p.x = x;
    p.w = w;
    p.out = out;
    p.M = M;
    p.K = K;
    p.N = N;
    p.mblocks = (M + kNRows - 1) / kNRows;
    p.nblocks = (N + kNCols - 1) / kNCols;
    p.tiles = static_cast<long long>(n) * p.mblocks * p.nblocks;
    p.stage_floats = (kNRows * K + 3) / 4 * 4;
    const int smem = narrow_smem(K);
    cudaFuncSetAttribute(gemm_narrow_f32_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    static int cached_smem = -1, per_sm = 1;
    if (smem != cached_smem) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gemm_narrow_f32_kernel, kNThreads, smem);
      if (per_sm < 1) per_sm = 1;
      cached_smem = smem;
    }
    const long long cap = static_cast<long long>(per_sm) * sm90::sm_count();
    const int grid = static_cast<int>(p.tiles < cap ? p.tiles : cap);
    gemm_narrow_f32_kernel<<<grid, kNThreads, smem, stream>>>(p);
    return;
  }
  // B = w^T split: rows j < N (w's columns), depth k < K
  const int rows_p = round_up(N, kK1BN), depth_p = round_up(K, kBoxK);
  split(w, static_cast<long long>(K) * N, 1, N, N, K, scratch, rows_p,
        depth_p, n, false, stream);
  TcParams p;
  p.pr[0] = tc_problem(x, static_cast<long long>(M) * K, K, out,
                       static_cast<long long>(M) * N, N, 1, M, N, K, kK1BN,
                       rows_p);
  p.pr[1] = p.pr[0];
  p.tiles0 = p.tiles = n * p.pr[0].mt * p.pr[0].nt;
  p.hi1 = p.lo1 = p.extra1 = 0;
  const bool tma = tma_ok(x, K, static_cast<long long>(M) * K);
  maps(p, 0, scratch, false, tma, n, kK1BN);
  if (tma)
    launch_tc<true, kK1BN, 0>(p, stream);
  else
    launch_tc<false, kK1BN, 0>(p, stream);
}

void launch_dense_bwd_f32(const float* x, const float* w, const float* g,
                          float* dx, float* dw, float* scratch, int n, int B,
                          int D, int H, cudaStream_t stream) {
  if (n == 0 || D == 0 || H == 0) return;
  const long long BD = static_cast<long long>(B) * D;
  const long long BH = static_cast<long long>(B) * H;
  const long long DH = static_cast<long long>(D) * H;
  // dx^T = w g^T: B(b, h) = g[b, h], rows b, depth h
  const int rows0 = round_up(B, kDxBN), depth0 = round_up(H, kBoxK);
  float* b0 = scratch;
  split(g, BH, H, 1, B, H, b0, rows0, depth0, n, false, stream);
  // dw = x^T g: B(h, b) = g[b, h], rows h, depth b
  const int rows1 = round_up(H, kDwBN), depth1 = round_up(B, kBoxK);
  float* b1 = scratch + 2LL * n * rows0 * depth0;
  split(g, BH, 1, H, H, B, b1, rows1, depth1, n, true, stream);
  TcParams p;
  // A(d, h) = w[d, h] (K-major); C(d, b) = dx[b, d]
  p.pr[0] = tc_problem(w, DH, H, dx, BD, 1, D, D, B, H, kDxBN, rows0);
  // A(d, b) = x[b, d] (M-major); C(d, h) = dw[d, h]
  p.pr[1] = tc_problem(x, BD, D, dw, DH, H, 1, D, H, B, kDwBN, rows1);
  p.tiles0 = n * p.pr[0].mt * p.pr[0].nt;
  p.tiles = p.tiles0 + n * p.pr[1].mt * p.pr[1].nt;
  if (p.tiles == 0) return;
  const bool tma = tma_ok(w, H, DH) && tma_ok(x, D, BD);
  maps(p, 0, b0, false, tma, n, kDxBN);
  maps(p, 1, b1, true, tma, n, kDwBN);
  const int grid = p.tiles < sm90::sm_count() ? p.tiles : sm90::sm_count();
  schedule(p, grid, kDxBN, kDwBN);
  if (tma)
    launch_tc<true, kDxBN, kDwBN>(p, stream);
  else
    launch_tc<false, kDxBN, kDwBN>(p, stream);
}

void launch_stream_wgrad_f32(const float* x, const float* g, float* partial,
                             float* out, int n, int M, int K, int N,
                             int route, int rows, int slices,
                             cudaStream_t stream) {
  if (n == 0 || M == 0 || K == 0 || N == 0) return;
  const long long KN = static_cast<long long>(K) * N;
  float* dst = slices > 1 ? partial : out;
  if (route == kWgradF32Tc) {
    TcParams p;
    // A(k, m) = x[m, k] (M-major); B(c, m) = g[m, c], split in shared
    // memory; C(k, c) = dst[slice][k, c]
    p.pr[1] = tc_problem(x, static_cast<long long>(M) * K, K, dst,
                         slices * KN, N, 1, K, N, M, kK2BN, 0);
    p.g = g;
    p.slices = slices;
    p.kb_slice = rows / kBoxK;
    p.c_slice = KN;
    p.pr[0] = p.pr[1];  // no tiles
    p.tiles0 = 0;
    p.tiles = n * p.pr[1].mt * p.pr[1].nt * slices;
    const long long MN = static_cast<long long>(M) * N;
    const bool tma = tma_ok(x, K, static_cast<long long>(M) * K) &&
                     tma_ok(g, N, MN);
    if (tma) {
      p.a_map[1] = make_tmap_f32(x, K, M, n, K,
                                 static_cast<long long>(M) * K, 32);
      p.b_map[1] = make_tmap_f32(g, N, M, n, N, MN, kBoxK, kK2BN, false);
    }
    const int grid = p.tiles < sm90::sm_count() ? p.tiles : sm90::sm_count();
    schedule(p, grid, kK2BN, kK2BN);
    if (tma)
      launch_tc<true, 0, kK2BN, true>(p, stream);
    else
      launch_tc<false, 0, kK2BN, true>(p, stream);
  } else {
    WgradNarrowParams p;
    p.x = x;
    p.g = g;
    p.out = dst;
    p.M = M;
    p.K = K;
    p.N = N;
    p.rows = rows;
    p.slices = slices;
    p.ctiles = (N + kWnCols - 1) / kWnCols;
    p.ktiles = (K + kWnDepth - 1) / kWnDepth;
    p.xspan = K <= kWnDepth;
    p.ldx = p.xspan ? K : kWnDepth;
    p.kgs = (p.xspan ? K + 3 : kWnDepth) / 4;
    p.span = N <= kWnCols && N % 4 == 0;
    p.ldg = p.span ? N : kWnCols;
    p.cgs = (p.span ? N : kWnCols) / 4;
    // x's rows plus padding for the k past K that a span's last row reads
    p.x_floats = round_up(kWnRows * p.ldx + 4, 4);
    p.stage_floats = p.x_floats + kWnRows * p.ldg;
    p.items = static_cast<long long>(n) * slices * p.ctiles * p.ktiles;
    const int threads = round_up(p.kgs * p.cgs, 32);
    const int smem = wgrad_narrow_smem(p);
    cudaFuncSetAttribute(wgrad_narrow_f32_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int per_sm = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, wgrad_narrow_f32_kernel, threads, smem);
    const long long cap =
        static_cast<long long>(per_sm < 1 ? 1 : per_sm) * sm90::sm_count();
    const int grid = static_cast<int>(p.items < cap ? p.items : cap);
    wgrad_narrow_f32_kernel<<<grid, threads, smem, stream>>>(p);
  }
  if (slices > 1) {
    const long long total = KN * n;
    const int blocks = static_cast<int>((total + 255) / 256);
    slice_sum_f32_kernel<<<blocks, 256, 0, stream>>>(partial, out, slices,
                                                     KN, total);
  }
}

void launch_wgmma_acc_probe(const float* a, const float* bt, float* d_tc,
                            float* d_chain, int K, cudaStream_t stream) {
  wgmma_acc_probe_kernel<<<1, 128, 0, stream>>>(a, bt, d_tc, d_chain, K);
}

}  // namespace p2pfl
