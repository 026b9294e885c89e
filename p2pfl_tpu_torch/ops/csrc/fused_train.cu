// K6. Replaces p2pfl_tpu/ops/fused_train.py::_call (:167, kernel body
// _kernel :56, pallas_call :197): one SGD-with-momentum epoch of a
// 3-layer ReLU MLP per node, for a stack of n nodes. For each of `steps`
// batches of B rows:
//
//   h0 = relu(x @ w0 + b0)        h1 = relu(h0 @ w1 + b1)
//   logits = h1 @ w2 + b2         loss = -sum(onehot * logp) / B
//   dl  = (softmax - onehot) / B
//   dh1 = (dl @ w2^T) * (h1 > 0)  dh0 = (dh1 @ w1^T) * (h0 > 0)
//   g   = (x^T dh0, sum dh0, h0^T dh1, sum dh1, h1^T dl, sum dl)
//   m   = beta * m + g            p = p - lr * m      (every leaf)
//
// and the node's loss is the mean over the steps. All in f32.
//
// Bound on an H100 SXM at the headline shape (64 nodes of mnist-mlp,
// 784-256-128-10, batch 32, 19 steps): operations. A node-step is
// 32.2 MFLOP (the backward has no dx of the input), 39.2 GFLOP in all:
// 0.59 ms at 67 TFLOP/s of f32 outside the tensor cores; the bytes
// (params and trace in and out, the batches) are 363 MB, 0.11 ms.
//
// Design: one 8-block cluster per node, each block one SM (256 threads,
// up to 227 KB of shared memory), the node's weights held on chip for
// the whole epoch. Block r owns 32 of layer 0's d1 = 256 output columns:
// its columns of w0 (784 x 32, 100 KB) and b0, the same 32 rows of w1
// (32 x 128), and their traces; w2, b1 and b2 and their traces (6 KB)
// are held by every block, which all apply the same update to them.
// Every product's output is summed by one thread as an fmaf chain over
// its whole depth in ascending order, the order of the plain version's
// f32 GEMMs (torch.bmm), and the bias gradients and the softmax
// denominator in torch.sum's orders (batch_sum, class_sum below; all
// read on the card with a probe kernel), so the epoch gives the
// plain version's bits on the card and a ReLU never sees another
// pre-activation (a K-split forward sum flipped whole nodes' masks over
// 19 steps; sequential bias and softmax sums flipped one node's unit on
// bf16-valued inputs). A step is two cluster barriers:
//   - A: h0's own columns = relu(x @ w0s + b0s) as 8 chains a thread
//     (4 batch rows by 2 columns; 4 warps), over x's 64-column chunks,
//     copied by 16-byte cp.async with four in flight; the next step's x
//     is prefetched into L2 meanwhile; each value is written into every
//     block's copy of h0;
//   - barrier; B: the 16 columns of w1 whose h1 columns this block owns
//     are gathered from the blocks that hold their rows (distributed
//     shared memory), and h1's columns = relu(h0 @ w1 + b1) (8 chains a
//     thread) are written into every block; barrier;
//   - C, in every block: logits, softmax and cross-entropy, dl; dh1 =
//     (dl @ w2^T) * (h1 > 0); the w2, b2, b1 updates; dh0's own columns
//     = (dh1 @ w1s^T) * (h0 > 0) from the old w1s; the w1s update;
//   - D: x's chunks again: the w0s update (4 x 2 outputs a thread, the
//     thread's two columns of dh0 in registers; the trace read one chunk
//     ahead), and b0's.
// Tiles trade shared-memory wavefronts against warps: a warp issues an
// fmaf only every other cycle, so the FP32 pipes want two warps on each
// scheduler, while smaller tiles a thread cost more loads a fmaf.
// The momentum of w0 and w1 (the large leaves) stays in the output
// tensors in device memory; each element is read and written once a
// step, by the thread that updates its weight, and a cluster's 1 MB of
// it stays in L2. Each gradient batch sum and the loss are summed by one
// thread in a fixed order, so two runs give the same bits. The update
// rounds with explicit __fmul_rn / __fadd_rn / __fsub_rn, as the plain
// version does. 15-16 clusters fit the card at once: 64 nodes run in 4-5
// waves.
//
// Widths whose state does not fit (batch > 32, d1 > 256, or more than
// 227 KB of shared memory a block) run the second instantiation, the
// earlier design: the same clusters with the node's params and trace in
// the output tensors (L2-resident), activations in a scratch tensor,
// six phases a step behind cluster barriers, 32 x 32 output tiles staged
// through shared memory with 4 outputs a thread.
//
// bf16 params, traces and inputs (the JAX kernel takes any dtype, casts
// to f32 on entry and stores back in each ref's dtype): the binding
// widens each bf16 tensor into an f32 copy with cast_bf16_kernel, runs
// this f32 epoch on the copies, and narrows the state back to bf16 once
// at the end (round to nearest even), so the epoch holds f32 throughout
// and rounds once, as the JAX kernel and the plain version do. The two
// passes move 6 bytes a value each way; folding them into the epoch's
// own loads and stores is left to a redesign.
//
// Earlier design (PR 3; now the second instantiation only): 13.303 ms at
// the headline shape by chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W);
// PERF.md has its time beside this design's.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "hopper.cuh"
#include "kernels.h"

namespace cg = cooperative_groups;

namespace p2pfl {
namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 256;

struct MlpState {
  float* p[6];  // w0, b0, w1, b1, w2, b2 (trained in place)
  float* m[6];  // their momentum traces
};

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }
__device__ __forceinline__ float gate(float v, float h) {
  return v * (h > 0.f ? 1.f : 0.f);
}

// m = beta * m + g; p = p - lr * m, rounded as the plain version rounds.
__device__ __forceinline__ void sgd_rn(float& p, float& m, float g, float lr,
                                       float beta) {
  m = __fadd_rn(__fmul_rn(beta, m), g);
  p = __fsub_rn(p, __fmul_rn(lr, m));
}

// sum over the k < K with k % step == first, in ascending k
template <typename V>
__device__ __forceinline__ float strided_sum(V v, int first, int step,
                                             int K) {
  float a = 0.f;
#pragma unroll 1
  for (int k = first; k < K; k += step) a += v(k);
  return a;
}

// sum over b < B of v(b), in torch.sum's order along a dimension that
// is not the innermost (the plain version's bias gradients): four
// accumulators, b to accumulator b % 4 in ascending b, then added in
// order (a probe kernel on the card gave its bits). Each
// accumulator is summed in turn, which keeps the code as small as one
// sequential sum's (larger code here slowed the whole epoch).
template <typename V>
__device__ __forceinline__ float batch_sum(V v, int B) {
  float s = strided_sum(v, 0, 4, B);
#pragma unroll 1
  for (int r = 1; r < 4; ++r) s += strided_sum(v, r, 4, B);
  return s;
}

// sum over k < C of v(k), in torch.sum's order along the innermost
// dimension at mnist-mlp's 10 classes (the plain version's softmax
// denominator, read on the card with a probe kernel):
// four lanes take k % 4 in ascending k, each dealing its values to two
// accumulators in turn (k % 8 and k % 8 + 4) and adding them, and the
// lanes meet as (0 + 2) + (1 + 3). Other class counts take the same
// rule, which the probe has not read.
template <typename V>
__device__ __forceinline__ float class_sum(V v, int C) {
  float even = 0.f, odd = 0.f;
#pragma unroll 1
  for (int l = 0; l < 4; ++l) {
    const float lane = strided_sum(v, l, 8, C) + strided_sum(v, l + 4, 8, C);
    if (l & 1)
      odd += lane;
    else
      even += lane;
  }
  return even + odd;
}

// ---------------------------------------------------------------------------
// the cluster-resident instantiation
// ---------------------------------------------------------------------------

constexpr int kMaxB = 32;  // batch rows a step
constexpr int kCols = 32;  // layer-0 columns a block, at most
constexpr int kXR = 64;    // x columns a chunk
constexpr int kXB = 4;     // chunks in flight
constexpr int kXS = kXR + 4;    // a chunk's row [b][i]
constexpr int kHS = kCols + 4;  // a padded [b][c] row (dh0)

// Shared-memory layout in floats, 16-byte-aligned pieces; a function of
// the widths, so the host sizes the launch with it.
struct Layout {
  int d1s, d2p, d2s, w2c;  // h0's row (d1 to 4, + 4); d2 to 4; [*, d2]
                           // rows; w1c's row (a block's h1 columns, to 4)
  int w0s, b0s, mb0s, w1s, w1c, w2, mw2, b1, mb1, b2, mb2, h0, xs, h1, dh1,
      dl, lp, dh0, total;
};

__host__ __device__ inline int take(int& o, int n) {
  const int r = o;
  o += (n + 3) / 4 * 4;
  return r;
}

__host__ __device__ inline Layout layout(int d_in, int d1, int d2, int C) {
  Layout L;
  int o = 0;
  L.d1s = (d1 + 3) / 4 * 4 + 4;
  L.d2p = (d2 + 3) / 4 * 4;
  L.d2s = L.d2p + 4;
  L.w2c = ((d2 + kCluster - 1) / kCluster + 3) / 4 * 4;
  L.w0s = take(o, d_in * kCols);
  L.b0s = take(o, kCols);
  L.mb0s = take(o, kCols);
  L.w1s = take(o, kCols * L.d2s);
  L.w1c = take(o, d1 * L.w2c);
  L.w2 = take(o, d2 * C);
  L.mw2 = take(o, d2 * C);
  L.b1 = take(o, L.d2p);
  L.mb1 = take(o, L.d2p);
  L.b2 = take(o, C);
  L.mb2 = take(o, C);
  L.h0 = take(o, kMaxB * L.d1s);
  // x's chunks in phases A and D; h1, dh1, dl and lp in phase C
  const int xs = kXB * kMaxB * kXS;
  const int c = 2 * kMaxB * L.d2s + kMaxB * C + kMaxB;
  L.xs = take(o, xs > c ? xs : c);
  L.h1 = L.xs;
  L.dh1 = L.h1 + kMaxB * L.d2s;
  L.dl = L.dh1 + kMaxB * L.d2s;
  L.lp = L.dl + kMaxB * C;
  L.dh0 = take(o, kMaxB * kHS);
  L.total = o;
  return L;
}

// layer-0 columns a block owns: d1 / 8 rounded up to a multiple of 4
__host__ __device__ inline int cols_a_block(int d1) {
  return ((d1 + kCluster - 1) / kCluster + 3) / 4 * 4;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Every output below is one thread's fmaf chain over its whole depth in
// ascending order, the order of the plain version's f32 GEMMs; only the
// h1 columns' chains read their weights from other blocks.
template <typename Label>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    mlp_epoch_smem_kernel(const float* __restrict__ bx,
                          const Label* __restrict__ by, MlpState st,
                          float* __restrict__ loss, int rows, int steps,
                          int B, int d_in, int d1, int d2, int C, float lr,
                          float beta) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long node = blockIdx.x / kCluster;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const Layout L = layout(d_in, d1, d2, C);
  const int d1s = L.d1s, d2p = L.d2p, d2s = L.d2s, JG = L.d2p / 4;
  // this block's layer-0 columns [c1, c1 + n1) (rows of w1) and h1
  // columns [c2, c2 + n2)
  const int W0 = cols_a_block(d1), W2 = L.w2c;
  const int H2 = (d2 + kCluster - 1) / kCluster;
  const int c1 = min(d1, rank * W0), n1 = min(d1, c1 + W0) - c1;
  const int c2 = min(d2, rank * H2), n2 = min(d2, c2 + H2) - c2;

  float* w0s = sm + L.w0s;
  float* b0s = sm + L.b0s;
  float* mb0s = sm + L.mb0s;
  float* w1s = sm + L.w1s;
  float* w1c = sm + L.w1c;
  float* w2 = sm + L.w2;
  float* mw2 = sm + L.mw2;
  float* b1 = sm + L.b1;
  float* mb1 = sm + L.mb1;
  float* b2 = sm + L.b2;
  float* mb2 = sm + L.mb2;
  float* h0 = sm + L.h0;
  float* h1 = sm + L.h1;
  float* dh1 = sm + L.dh1;
  float* dl = sm + L.dl;
  float* lp = sm + L.lp;
  float* dh0 = sm + L.dh0;

  // this node's state in device memory
  float* gw0 = st.p[0] + node * d_in * d1;
  float* gb0 = st.p[1] + node * d1;
  float* gw1 = st.p[2] + node * d1 * d2;
  float* gb1 = st.p[3] + node * d2;
  float* gw2 = st.p[4] + node * d2 * C;
  float* gb2 = st.p[5] + node * C;
  float* gmw0 = st.m[0] + node * d_in * d1;
  float* gmb0 = st.m[1] + node * d1;
  float* gmw1 = st.m[2] + node * d1 * d2;
  float* gmb1 = st.m[3] + node * d2;
  float* gmw2 = st.m[4] + node * d2 * C;
  float* gmb2 = st.m[5] + node * C;

  // the state on chip; every pad stays zero
  for (int e = t; e < L.total; e += kThreads) sm[e] = 0.f;
  __syncthreads();
  for (int e = t; e < d_in * kCols; e += kThreads) {
    const int c = e % kCols;
    if (c < n1) w0s[e] = gw0[static_cast<long long>(e / kCols) * d1 + c1 + c];
  }
  for (int c = t; c < n1; c += kThreads) {
    b0s[c] = gb0[c1 + c];
    mb0s[c] = gmb0[c1 + c];
  }
  for (int e = t; e < n1 * d2; e += kThreads) {
    const int c = e / d2, j = e % d2;
    w1s[c * d2s + j] = gw1[static_cast<long long>(c1 + c) * d2 + j];
  }
  for (int e = t; e < d2 * C; e += kThreads) {
    w2[e] = gw2[e];
    mw2[e] = gmw2[e];
  }
  for (int j = t; j < d2; j += kThreads) {
    b1[j] = gb1[j];
    mb1[j] = gmb1[j];
  }
  for (int k = t; k < C; k += kThreads) {
    b2[k] = gb2[k];
    mb2[k] = gmb2[k];
  }
  __syncthreads();

  // x's chunks: chunk ci of step s is xs[b][i] = x[b][ci * kXR + i],
  // kXB of them in flight; a group is committed for every chunk index,
  // so a wait counts them
  const int nch = (d_in + kXR - 1) / kXR;
  const bool vec = d_in % 4 == 0 && reinterpret_cast<uintptr_t>(bx) % 16 == 0;
  auto issue = [&](int s, int ci) {
    if (ci < nch) {
      float* buf = sm + L.xs + (ci % kXB) * kMaxB * kXS;
      const int i0 = ci * kXR, cw = min(kXR, d_in - i0);
      const float* src = bx + (node * rows + static_cast<long long>(s) * B) *
                                  d_in + i0;
      if (vec) {
        for (int e = t; e < B * (kXR / 4); e += kThreads) {
          const int b = e / (kXR / 4), i = 4 * (e % (kXR / 4));
          if (i < cw)
            sm90::cp_async16(buf + b * kXS + i,
                             src + static_cast<long long>(b) * d_in + i);
        }
      } else {
        for (int e = t; e < B * kXR; e += kThreads) {
          const int b = e / kXR, i = e % kXR;
          if (i < cw)
            cp_async4(buf + b * kXS + i,
                      src + static_cast<long long>(b) * d_in + i);
        }
      }
    }
    sm90::cp_async_commit();
  };
  // chunk ci, once every thread's copies of it have landed and every
  // thread is done with chunk ci - 1, whose buffer then takes ci + kXB - 1
  auto chunk = [&](int s, int ci) -> const float* {
    sm90::cp_async_wait<kXB - 2>();
    __syncthreads();
    issue(s, ci + kXB - 1);
    return sm + L.xs + (ci % kXB) * kMaxB * kXS;
  };

  // rows [0, B) x columns [c0, c0 + n) of a [*, ld] buffer into the
  // other blocks' copies, by 16-byte stores where the columns allow
  auto push = [&](float* buf, int ld, int c0, int n) {
    if (c0 % 4 == 0 && n % 4 == 0) {
      const int q = n / 4;
      for (int e = t; e < (kCluster - 1) * B * q; e += kThreads) {
        const int r = (rank + 1 + e / (B * q)) % kCluster;
        const int o = e % (B * q) / q * ld + c0 + 4 * (e % q);
        *reinterpret_cast<float4*>(cluster.map_shared_rank(buf, r) + o) =
            ld4(buf + o);
      }
    } else {
      for (int e = t; e < (kCluster - 1) * B * n; e += kThreads) {
        const int r = (rank + 1 + e / (B * n)) % kCluster;
        const int o = e % (B * n) / n * ld + c0 + e % n;
        cluster.map_shared_rank(buf, r)[o] = buf[o];
      }
    }
  };

  float loss_sum = 0.f;
  for (int s = 0; s < steps; ++s) {
    const Label* y = by + node * rows + static_cast<long long>(s) * B;

    // A: h0[:, own] = relu(x @ w0s + b0s). Warps 0-3: thread (bg, cp)
    // holds rows bg + 8j (j < 4) by columns 2cp, 2cp + 1, 8 chains: four
    // warps keep the FP32 pipes busier than two (a warp issues an fmaf
    // every other cycle) at a shared-memory cost below eight's.
    {
      const int bg = (lane >> 4) + 2 * warp, c0 = 2 * (lane & 15);
      float acc[4][2] = {};
      __syncthreads();  // the last step's chunks have been read
      for (int ci = 0; ci < kXB - 1; ++ci) issue(s, ci);
      for (int ci = 0; ci < nch; ++ci) {
        const float* xt = chunk(s, ci);
        if (warp >= 4) continue;
        const int i0 = ci * kXR, cw = min(kXR, d_in - i0);
        int i = 0;
        for (; i + 4 <= cw; i += 4) {
          // four rows' loads ahead of their 32 fmaf
          float2 w[4];
          float4 xq[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            w[u] = ld2(w0s + (i0 + i + u) * kCols + c0);
#pragma unroll
          for (int j = 0; j < 4; ++j) xq[j] = ld4(xt + (bg + 8 * j) * kXS + i);
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float xv = at(xq[j], u);
              acc[j][0] = fmaf(xv, w[u].x, acc[j][0]);
              acc[j][1] = fmaf(xv, w[u].y, acc[j][1]);
            }
        }
        for (; i < cw; ++i) {
          const float2 w = ld2(w0s + (i0 + i) * kCols + c0);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float xv = xt[(bg + 8 * j) * kXS + i];
            acc[j][0] = fmaf(xv, w.x, acc[j][0]);
            acc[j][1] = fmaf(xv, w.y, acc[j][1]);
          }
        }
      }
      if (warp < 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int b = bg + 8 * j;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (b < B && c0 + e < n1)
              h0[b * d1s + c1 + c0 + e] = relu(acc[j][e] + b0s[c0 + e]);
        }
      }
      __syncthreads();
      // this block's columns into the other blocks' copies of h0
      push(h0, d1s, c1, n1);
    }
    cluster.sync();  // h0 is complete in every block; w1's rows updated

    // the next step's x into L2 (its first read comes from device
    // memory): this block's eighth of its 128-byte lines
    if (s + 1 < steps) {
      const char* nx = reinterpret_cast<const char*>(
          bx + (node * rows + static_cast<long long>(s + 1) * B) * d_in);
      const int lines = (B * d_in * 4 + 127) / 128;
      const int per = (lines + kCluster - 1) / kCluster;
      for (int l = rank * per + t; l < min(lines, (rank + 1) * per);
           l += kThreads)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(nx + 128LL * l));
    }

    // B: this block's h1 columns: w1's columns [c2, c2 + n2) from the
    // blocks that hold its rows, then relu(h0 @ w1c + b1); every block
    // gets the values
    for (int e0 = t; e0 < d1 * n2; e0 += 8 * kThreads) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kThreads, c = e / n2, j = e % n2;
        if (e < d1 * n2)
          v[u] = cluster.map_shared_rank(w1s, c / W0)[(c % W0) * d2s + c2 + j];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kThreads;
        if (e < d1 * n2) w1c[(e / n2) * W2 + e % n2] = v[u];
      }
    }
    __syncthreads();
    // thread (bp, jq) of warps 0-1: rows bp, bp + 16 by columns 4jq ..
    // 4jq + 3 of this block's h1 columns (more columns take more rounds)
    for (int jb = 0; jb < n2; jb += 16) {
      if (warp >= 2) break;
      const int bp = t & 15, j0 = jb + 4 * (t >> 4);
      if (j0 >= n2) continue;
      float a[2][4] = {};
      int c = 0;
      for (; c + 4 <= d1; c += 4) {
        float hl[4], hh[4];
        float4 w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          hl[u] = h0[bp * d1s + c + u];
          hh[u] = h0[(bp + 16) * d1s + c + u];
          w[u] = ld4(w1c + (c + u) * W2 + j0);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a[0][e] = fmaf(hl[u], at(w[u], e), a[0][e]);
            a[1][e] = fmaf(hh[u], at(w[u], e), a[1][e]);
          }
      }
      for (; c < d1; ++c) {
        const float h_lo = h0[bp * d1s + c], h_hi = h0[(bp + 16) * d1s + c];
        const float4 w = ld4(w1c + c * W2 + j0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[0][e] = fmaf(h_lo, at(w, e), a[0][e]);
          a[1][e] = fmaf(h_hi, at(w, e), a[1][e]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int b = bp + 16 * hh;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (b < B && j0 + e < n2)
            h1[b * d2s + c2 + j0 + e] = relu(a[hh][e] + b1[c2 + j0 + e]);
      }
    }
    __syncthreads();
    // this block's columns into the other blocks' copies of h1
    push(h1, d2s, c2, n2);
    cluster.sync();  // h1 is complete in every block

    // C. The trace of this thread's first w1 tile, read ahead of its use
    float m1[4][4];
    {
      const int j0 = 4 * (t % JG), c0 = 4 * (t / JG);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          m1[cc][e] = t < 8 * JG && c0 + cc < n1 && j0 + e < d2
                          ? gmw1[static_cast<long long>(c1 + c0 + cc) * d2 +
                                 j0 + e]
                          : 0.f;
    }
    // logits, two chains a thread, into dl
    {
      const int half = (B * C + 1) / 2;
      for (int o = t; o < half; o += kThreads) {
        const int o2 = o + half, b = o / C, k = o % C;
        const bool two = o2 < B * C;
        const int bb = two ? o2 / C : b, kk = two ? o2 % C : k;
        float a0 = 0.f, a1 = 0.f;
        for (int j = 0; j < d2; ++j) {
          a0 = fmaf(h1[b * d2s + j], w2[j * C + k], a0);
          a1 = fmaf(h1[bb * d2s + j], w2[j * C + kk], a1);
        }
        dl[o] = a0 + b2[k];
        if (two) dl[o2] = a1 + b2[kk];
      }
    }
    __syncthreads();
    // softmax and cross-entropy, one thread a row
    if (t < B) {
      float* row = dl + t * C;
      float zmax = -__int_as_float(0x7f800000);  // -inf
      for (int k = 0; k < C; ++k) zmax = fmaxf(zmax, row[k]);
      const float se =
          class_sum([&](int k) { return expf(row[k] - zmax); }, C);
      const long long label = static_cast<long long>(y[t]);
      float lpy = 0.f;
      for (int k = 0; k < C; ++k) {
        const float z = row[k] - zmax;
        const float onehot = k == label ? 1.f : 0.f;
        if (k == label) lpy = z - logf(se);
        row[k] = (expf(z) / se - onehot) / static_cast<float>(B);
      }
      lp[t] = lpy;
    }
    __syncthreads();
    if (rank == 0 && t == 0) {
      float sum = 0.f;
      for (int b = 0; b < B; ++b) sum += lp[b];
      loss_sum += -sum / static_cast<float>(B);
    }
    // dh1 = (dl @ w2^T) * (h1 > 0), from the old w2; pad columns zero
    for (int tt = t; tt < 8 * JG; tt += kThreads) {
      const int bg = tt & 7, j0 = 4 * (tt >> 3);
      float a[4][4] = {};
      for (int k = 0; k < C; ++k) {
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = j0 + e < d2 ? w2[(j0 + e) * C + k] : 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float dv = dl[(bg + 8 * jj) * C + k];
#pragma unroll
          for (int e = 0; e < 4; ++e) a[jj][e] = fmaf(dv, w[e], a[jj][e]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int b = bg + 8 * jj;
        if (b >= B) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = b * d2s + j0 + e;
          dh1[o] = j0 + e < d2 ? gate(a[jj][e], h1[o]) : 0.f;
        }
      }
    }
    __syncthreads();
    // w2, b2, b1: the same update in every block
    for (int e = t; e < d2 * C; e += kThreads) {
      const int j = e / C, k = e % C;
      float g = 0.f;
      for (int b = 0; b < B; ++b) g = fmaf(h1[b * d2s + j], dl[b * C + k], g);
      sgd_rn(w2[e], mw2[e], g, lr, beta);
    }
    for (int k = t; k < C; k += kThreads) {
      const float g = batch_sum([&](int b) { return dl[b * C + k]; }, B);
      sgd_rn(b2[k], mb2[k], g, lr, beta);
    }
    for (int j = t; j < d2; j += kThreads) {
      const float g = batch_sum([&](int b) { return dh1[b * d2s + j]; }, B);
      sgd_rn(b1[j], mb1[j], g, lr, beta);
    }
    // dh0[:, own] = (dh1 @ w1s^T) * (h0 > 0), from the old w1s: rows
    // bp + 16 bb, columns cp + 16 cc a thread
    {
      const int bp = t >> 4, cp = t & 15;
      float a[2][2] = {};
      for (int j0 = 0; j0 < d2p; j0 += 4) {
        const float4 u0 = ld4(dh1 + bp * d2s + j0);
        const float4 u1 = ld4(dh1 + (bp + 16) * d2s + j0);
        const float4 v0 = ld4(w1s + cp * d2s + j0);
        const float4 v1 = ld4(w1s + (cp + 16) * d2s + j0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[0][0] = fmaf(at(u0, e), at(v0, e), a[0][0]);
          a[0][1] = fmaf(at(u0, e), at(v1, e), a[0][1]);
          a[1][0] = fmaf(at(u1, e), at(v0, e), a[1][0]);
          a[1][1] = fmaf(at(u1, e), at(v1, e), a[1][1]);
        }
      }
#pragma unroll
      for (int bb = 0; bb < 2; ++bb)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int b = bp + 16 * bb, c = cp + 16 * cc;
          if (b < B)
            dh0[b * kHS + c] = gate(a[bb][cc], h0[b * d1s + c1 + c]);
        }
    }
    __syncthreads();
    // w1s -= lr * (beta m + h0[:, own]^T dh1); its trace in device memory
    for (int tt = t; tt < 8 * JG; tt += kThreads) {
      const int j0 = 4 * (tt % JG), c0 = 4 * (tt / JG);
      if (c0 >= n1) continue;
      float m[4][4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          m[cc][e] = tt == t ? m1[cc][e]
                     : c0 + cc < n1 && j0 + e < d2
                         ? gmw1[static_cast<long long>(c1 + c0 + cc) * d2 +
                                j0 + e]
                         : 0.f;
      float a[4][4] = {};
      for (int b = 0; b < B; ++b) {
        const float* hb = h0 + b * d1s + c1 + c0;
        const float4 dv = ld4(dh1 + b * d2s + j0);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a[cc][e] = fmaf(hb[cc], at(dv, e), a[cc][e]);
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c0 + cc >= n1 || j0 + e >= d2) continue;
          sgd_rn(w1s[(c0 + cc) * d2s + j0 + e], m[cc][e], a[cc][e], lr, beta);
          gmw1[static_cast<long long>(c1 + c0 + cc) * d2 + j0 + e] = m[cc][e];
        }
    }
    __syncthreads();  // phase C's buffers are free for x's chunks

    // D: w0s -= lr * (beta m + x^T dh0[:, own]). Thread (iq, cp) holds
    // rows 4iq .. 4iq + 3 of each chunk by columns 2cp, 2cp + 1, and
    // those columns of dh0 in registers for the whole phase: a batch row
    // costs one 16-byte load for 8 fmaf. The trace is in device memory,
    // read one chunk ahead.
    {
      const int i4 = 4 * (t >> 4), c0 = 2 * (t & 15);
      const bool mine = c0 < n1, mvec = d1 % 2 == 0;
      float dr[kMaxB][2];
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) {
        const float2 v = ld2(dh0 + b * kHS + c0);
        dr[b][0] = v.x;
        dr[b][1] = v.y;
      }
      auto load_m = [&](int ci, float (&m)[4][2]) {
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int i = ci * kXR + i4 + ii;
          const float* src = gmw0 + static_cast<long long>(i) * d1 + c1 + c0;
          const bool row = mine && ci < nch && i < d_in;
          if (row && mvec) {
            const float2 v = ld2(src);
            m[ii][0] = v.x;
            m[ii][1] = v.y;
          } else {
#pragma unroll
            for (int cc = 0; cc < 2; ++cc)
              m[ii][cc] = row && c0 + cc < n1 ? src[cc] : 0.f;
          }
        }
      };
      float m[4][2], mn[4][2];
      for (int ci = 0; ci < kXB - 1; ++ci) issue(s, ci);
      load_m(0, m);
      for (int ci = 0; ci < nch; ++ci) {
        const float* xt = chunk(s, ci);
        load_m(ci + 1, mn);
        float a[4][2] = {};
        // rows past B add fmaf(0, 0, a): nothing
#pragma unroll
        for (int b0 = 0; b0 < kMaxB; b0 += 4) {
          if (b0 >= B) continue;
          float4 xv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            xv[u] = b0 + u < B ? ld4(xt + (b0 + u) * kXS + i4)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int ii = 0; ii < 4; ++ii) {
              a[ii][0] = fmaf(at(xv[u], ii), dr[b0 + u][0], a[ii][0]);
              a[ii][1] = fmaf(at(xv[u], ii), dr[b0 + u][1], a[ii][1]);
            }
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int i = ci * kXR + i4 + ii;
          if (!mine || i >= d_in) continue;
          float* dst = gmw0 + static_cast<long long>(i) * d1 + c1 + c0;
          float* p = w0s + i * kCols + c0;
#pragma unroll
          for (int cc = 0; cc < 2; ++cc)
            if (c0 + cc < n1) sgd_rn(p[cc], m[ii][cc], a[ii][cc], lr, beta);
          if (mvec) {
            *reinterpret_cast<float2*>(dst) = make_float2(m[ii][0], m[ii][1]);
          } else {
#pragma unroll
            for (int cc = 0; cc < 2; ++cc)
              if (c0 + cc < n1) dst[cc] = m[ii][cc];
          }
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) m[ii][cc] = mn[ii][cc];
      }
      for (int c = t; c < n1; c += kThreads) {
        const float g =
            batch_sum([&](int b) { return dh0[b * kHS + c]; }, B);
        sgd_rn(b0s[c], mb0s[c], g, lr, beta);
      }
    }
  }
  sm90::cp_async_wait<0>();

  // the state back to device memory
  __syncthreads();
  for (int e = t; e < d_in * kCols; e += kThreads) {
    const int c = e % kCols;
    if (c < n1) gw0[static_cast<long long>(e / kCols) * d1 + c1 + c] = w0s[e];
  }
  for (int c = t; c < n1; c += kThreads) {
    gb0[c1 + c] = b0s[c];
    gmb0[c1 + c] = mb0s[c];
  }
  for (int e = t; e < n1 * d2; e += kThreads) {
    const int c = e / d2, j = e % d2;
    gw1[static_cast<long long>(c1 + c) * d2 + j] = w1s[c * d2s + j];
  }
  if (rank == 0) {
    for (int e = t; e < d2 * C; e += kThreads) {
      gw2[e] = w2[e];
      gmw2[e] = mw2[e];
    }
    for (int j = t; j < d2; j += kThreads) {
      gb1[j] = b1[j];
      gmb1[j] = mb1[j];
    }
    for (int k = t; k < C; k += kThreads) {
      gb2[k] = b2[k];
      gmb2[k] = mb2[k];
    }
    if (t == 0) loss[node] = loss_sum / static_cast<float>(steps);
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

// ---------------------------------------------------------------------------
// the L2-resident instantiation (widths whose state does not fit)
// ---------------------------------------------------------------------------

constexpr int kTile = 32;

__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }

// m = beta * m + g; p = p - lr * m, on the state in device memory.
__device__ __forceinline__ void sgd(float* p, float* m, long long i, float g,
                                    float lr, float beta) {
  const float mn = __fadd_rn(__fmul_rn(beta, ld(m + i)), g);
  m[i] = mn;
  p[i] = __fsub_rn(ld(p + i), __fmul_rn(lr, mn));
}

using Tile = float[kTile + 1];  // a padded row of a staging tile

// out(i, j) = sum_k A(i, k) B(k, j) for i < M, j < N, with
// A(i, k) = A[i * sai + k * sak] and B(k, j) = B[k * sbk + j * sbj],
// staged through the block's shared tiles As [k][i] and Bs [k][j];
// epi(i, j, sum) consumes each output. Every thread of the block calls it
// with the same arguments (it holds __syncthreads).

template <typename Epi>
__device__ void tile_product(Tile* As, Tile* Bs, const float* A,
                             long long sai, long long sak, const float* B,
                             long long sbk, long long sbj, int M, int N,
                             int K, Epi epi) {
  const int t = threadIdx.x;
  const int tj = t & 31, ti = t >> 5;  // this thread: rows ti + 8r, col tj
  for (int i0 = 0; i0 < M; i0 += kTile) {
    for (int j0 = 0; j0 < N; j0 += kTile) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < K; k0 += kTile) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = t + kThreads * q;
          // the unit-stride index runs fastest across the warp
          const int ii = sak == 1 ? e >> 5 : e & 31;
          const int kk = sak == 1 ? e & 31 : e >> 5;
          const int i = i0 + ii, k = k0 + kk;
          As[kk][ii] = (i < M && k < K) ? ld(A + i * sai + k * sak) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = t + kThreads * q;
          const int jj = sbj == 1 ? e & 31 : e >> 5;
          const int kk = sbj == 1 ? e >> 5 : e & 31;
          const int j = j0 + jj, k = k0 + kk;
          Bs[kk][jj] = (j < N && k < K) ? ld(B + k * sbk + j * sbj) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kTile; ++kk) {
          const float b = Bs[kk][tj];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[r] = fmaf(As[kk][ti + 8 * r], b, acc[r]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ti + 8 * r, j = j0 + tj;
        if (i < M && j < N) epi(i, j, acc[r]);
      }
    }
  }
}

__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cluster) {
  __threadfence();
  cluster.sync();
}

// the slice [*lo, *lo + *cnt) of `d` columns block `rank` owns
__device__ __forceinline__ void slice(int d, int rank, int* lo, int* cnt) {
  const int w = (d + kCluster - 1) / kCluster;
  *lo = min(d, rank * w);
  *cnt = min(d, *lo + w) - *lo;
}

template <typename Label>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    mlp_epoch_l2_kernel(const float* __restrict__ bx,
                           const Label* __restrict__ by, MlpState st,
                           float* __restrict__ scratch,
                           float* __restrict__ loss, int rows, int steps,
                           int B, int d_in, int d1, int d2, int C, float lr,
                           float beta) {
  __shared__ Tile As[kTile], Bs[kTile];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long node = blockIdx.x / kCluster;
  const int t = threadIdx.x;

  // this node's state
  float* w0 = st.p[0] + node * d_in * d1;
  float* b0 = st.p[1] + node * d1;
  float* w1 = st.p[2] + node * d1 * d2;
  float* b1 = st.p[3] + node * d2;
  float* w2 = st.p[4] + node * d2 * C;
  float* b2 = st.p[5] + node * C;
  float* mw0 = st.m[0] + node * d_in * d1;
  float* mb0 = st.m[1] + node * d1;
  float* mw1 = st.m[2] + node * d1 * d2;
  float* mb1 = st.m[3] + node * d2;
  float* mw2 = st.m[4] + node * d2 * C;
  float* mb2 = st.m[5] + node * C;
  // this node's scratch: h0 [B,d1], h1 [B,d2], dl [B,C] (logits first),
  // dh1 [B,d2], dh0 [B,d1], lp [B] (each row's log-probability of its
  // label)
  float* h0 = scratch + node * (2LL * B * (d1 + d2) + B * (C + 1LL));
  float* h1 = h0 + static_cast<long long>(B) * d1;
  float* dl = h1 + static_cast<long long>(B) * d2;
  float* dh1 = dl + static_cast<long long>(B) * C;
  float* dh0 = dh1 + static_cast<long long>(B) * d2;
  float* lp = dh0 + static_cast<long long>(B) * d1;

  int c1, n1, c2, n2;  // owned columns of layer 0 (d1) and layer 1 (d2)
  slice(d1, rank, &c1, &n1);
  slice(d2, rank, &c2, &n2);
  float loss_sum = 0.f;

  for (int s = 0; s < steps; ++s) {
    const float* x = bx + (node * rows + static_cast<long long>(s) * B) * d_in;
    const Label* y = by + node * rows + static_cast<long long>(s) * B;

    // fwd L0: h0[:, c1:c1+n1] = relu(x @ w0[:, c1:] + b0)
    tile_product(As, Bs, x, d_in, 1, w0 + c1, d1, 1, B, n1, d_in,
                 [&](int b, int j, float v) {
                   h0[static_cast<long long>(b) * d1 + c1 + j] =
                       relu(v + ld(b0 + c1 + j));
                 });
    cluster_barrier(cluster);

    // fwd L1: h1[:, c2:c2+n2] = relu(h0 @ w1[:, c2:] + b1)
    tile_product(As, Bs, h0, d1, 1, w1 + c2, d2, 1, B, n2, d1,
                 [&](int b, int j, float v) {
                   h1[static_cast<long long>(b) * d2 + c2 + j] =
                       relu(v + ld(b1 + c2 + j));
                 });
    cluster_barrier(cluster);

    // fwd L2, softmax and cross-entropy: block 0
    if (rank == 0) {
      tile_product(As, Bs, h1, d2, 1, w2, C, 1, B, C, d2,
                   [&](int b, int k, float v) {
                     dl[static_cast<long long>(b) * C + k] = v + ld(b2 + k);
                   });
      __syncthreads();
      for (int b = t; b < B; b += kThreads) {
        float* row = dl + static_cast<long long>(b) * C;
        float zmax = -__int_as_float(0x7f800000);  // -inf
        for (int k = 0; k < C; ++k) zmax = fmaxf(zmax, ld(row + k));
        const float se =
            class_sum([&](int k) { return expf(ld(row + k) - zmax); }, C);
        const long long label = static_cast<long long>(y[b]);
        float lpy = 0.f;
        for (int k = 0; k < C; ++k) {
          const float z = ld(row + k) - zmax;
          const float onehot = k == label ? 1.f : 0.f;
          if (k == label) lpy = z - logf(se);
          row[k] = (expf(z) / se - onehot) / static_cast<float>(B);
        }
        lp[b] = lpy;
      }
      __syncthreads();
      if (t == 0) {
        float sum = 0.f;
        for (int b = 0; b < B; ++b) sum += ld(lp + b);
        loss_sum += -sum / static_cast<float>(B);
      }
    }
    cluster_barrier(cluster);

    // bwd L2: dh1[:, c2:] = (dl @ w2[c2:, :]^T) * (h1 > 0), from the old w2
    tile_product(As, Bs, dl, C, 1, w2 + static_cast<long long>(c2) * C, 1,
                 C, B, n2, C, [&](int b, int j, float v) {
                   const long long o = static_cast<long long>(b) * d2 + c2 + j;
                   dh1[o] = gate(v, ld(h1 + o));
                 });
    __syncthreads();
    // w2[c2:, :] -= lr * (beta m + h1[:, c2:]^T dl)
    tile_product(As, Bs, h1 + c2, 1, d2, dl, C, 1, n2, C, B,
                 [&](int j, int k, float g) {
                   sgd(w2, mw2, static_cast<long long>(c2 + j) * C + k, g, lr,
                       beta);
                 });
    for (int j = t; j < n2; j += kThreads) {  // b1[c2:]: sum_b dh1
      const float g = batch_sum(
          [&](int b) {
            return ld(dh1 + static_cast<long long>(b) * d2 + c2 + j);
          },
          B);
      sgd(b1, mb1, c2 + j, g, lr, beta);
    }
    if (rank == 0) {
      for (int k = t; k < C; k += kThreads) {  // b2: sum_b dl
        const float g = batch_sum(
            [&](int b) { return ld(dl + static_cast<long long>(b) * C + k); },
            B);
        sgd(b2, mb2, k, g, lr, beta);
      }
    }
    cluster_barrier(cluster);

    // bwd L1: dh0[:, c1:] = (dh1 @ w1[c1:, :]^T) * (h0 > 0), old w1
    tile_product(As, Bs, dh1, d2, 1, w1 + static_cast<long long>(c1) * d2,
                 1, d2, B, n1, d2, [&](int b, int j, float v) {
                   const long long o = static_cast<long long>(b) * d1 + c1 + j;
                   dh0[o] = gate(v, ld(h0 + o));
                 });
    __syncthreads();
    // w0[:, c1:] -= lr * (beta m + x^T dh0[:, c1:])
    tile_product(As, Bs, x, 1, d_in, dh0 + c1, d1, 1, d_in, n1, B,
                 [&](int i, int j, float g) {
                   sgd(w0, mw0, static_cast<long long>(i) * d1 + c1 + j, g,
                       lr, beta);
                 });
    for (int j = t; j < n1; j += kThreads) {  // b0[c1:]: sum_b dh0
      const float g = batch_sum(
          [&](int b) {
            return ld(dh0 + static_cast<long long>(b) * d1 + c1 + j);
          },
          B);
      sgd(b0, mb0, c1 + j, g, lr, beta);
    }
    cluster_barrier(cluster);

    // w1[:, c2:] -= lr * (beta m + h0^T dh1[:, c2:]), once every block has
    // read the old rows of w1
    tile_product(As, Bs, h0, 1, d1, dh1 + c2, d2, 1, d1, n2, B,
                 [&](int i, int j, float g) {
                   sgd(w1, mw1, static_cast<long long>(i) * d2 + c2 + j, g,
                       lr, beta);
                 });
    cluster_barrier(cluster);
  }
  if (rank == 0 && t == 0) loss[node] = loss_sum / static_cast<float>(steps);
}

}  // namespace

long long fused_mlp_scratch_floats(int B, int d1, int d2, int C) {
  return 2LL * B * (d1 + d2) + static_cast<long long>(B) * (C + 1);
}

MlpEpochPlan fused_mlp_epoch_plan(int batch, int d_in, int d1, int d2,
                                  int C) {
  MlpEpochPlan plan{0, 0};
  if (batch <= kMaxB && cols_a_block(d1) <= kCols) {
    const long long bytes = 4LL * layout(d_in, d1, d2, C).total;
    if (bytes <= kMaxSmemBytes) {
      plan.on_chip = 1;
      plan.smem_bytes = static_cast<int>(bytes);
    }
  }
  return plan;
}

namespace {

template <typename Label>
void launch(const float* bx, const Label* by, const MlpState& st,
            float* scratch, float* loss, int n, int rows, int steps,
            int batch, int d_in, int d1, int d2, int C, float lr, float beta,
            const MlpEpochPlan& plan, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(n) * kCluster);
  if (plan.on_chip) {
    cudaFuncSetAttribute(mlp_epoch_smem_kernel<Label>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         plan.smem_bytes);
    mlp_epoch_smem_kernel<Label><<<grid, kThreads, plan.smem_bytes, stream>>>(
        bx, by, st, loss, rows, steps, batch, d_in, d1, d2, C, lr, beta);
  } else {
    mlp_epoch_l2_kernel<Label><<<grid, kThreads, 0, stream>>>(
        bx, by, st, scratch, loss, rows, steps, batch, d_in, d1, d2, C, lr,
        beta);
  }
}

template <typename Label>
int resident(int smem_bytes, int on_chip) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int count = 0;
  if (on_chip) {
    cudaFuncSetAttribute(mlp_epoch_smem_kernel<Label>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
    cfg.dynamicSmemBytes = smem_bytes;
    cudaOccupancyMaxActiveClusters(&count, mlp_epoch_smem_kernel<Label>, &cfg);
  } else {
    cudaOccupancyMaxActiveClusters(&count, mlp_epoch_l2_kernel<Label>, &cfg);
  }
  return count;
}

}  // namespace

namespace {

struct CastTable {
  CastItem item[kMaxCasts];
};

// blockIdx.y: the tensor; a grid-stride loop over its values
__global__ void cast_bf16_kernel(const __grid_constant__ CastTable tab,
                                 int widen) {
  const CastItem it = tab.item[blockIdx.y];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < it.numel; i += stride) {
    if (widen)
      static_cast<float*>(it.dst)[i] =
          __bfloat162float(static_cast<const __nv_bfloat16*>(it.src)[i]);
    else
      static_cast<__nv_bfloat16*>(it.dst)[i] =
          __float2bfloat16_rn(static_cast<const float*>(it.src)[i]);
  }
}

}  // namespace

void launch_cast_bf16(const CastItem* items, int count, int widen,
                      cudaStream_t stream) {
  if (count <= 0) return;
  CastTable tab{};
  long long most = 0;
  for (int i = 0; i < count && i < kMaxCasts; ++i) {
    tab.item[i] = items[i];
    most = items[i].numel > most ? items[i].numel : most;
  }
  if (most == 0) return;
  const long long want = (most + 255) / 256;
  const int blocks = static_cast<int>(want < 1024 ? want : 1024);
  cast_bf16_kernel<<<dim3(blocks, count < kMaxCasts ? count : kMaxCasts),
                     256, 0, stream>>>(tab, widen);
}

int fused_mlp_clusters_resident(const MlpEpochPlan& plan) {
  return resident<int32_t>(plan.smem_bytes, plan.on_chip);
}

void launch_fused_mlp_epoch(const float* bx, const void* by, int by_int64,
                            float* const* params, float* const* mom,
                            float* scratch, float* loss, int n, int rows,
                            int steps, int batch, int d_in, int d1, int d2,
                            int C, float lr, float beta,
                            cudaStream_t stream) {
  if (n == 0) return;
  MlpState st;
  for (int i = 0; i < 6; ++i) {
    st.p[i] = params[i];
    st.m[i] = mom[i];
  }
  const MlpEpochPlan plan = fused_mlp_epoch_plan(batch, d_in, d1, d2, C);
  if (by_int64)
    launch(bx, static_cast<const int64_t*>(by), st, scratch, loss, n, rows,
           steps, batch, d_in, d1, d2, C, lr, beta, plan, stream);
  else
    launch(bx, static_cast<const int32_t*>(by), st, scratch, loss, n, rows,
           steps, batch, d_in, d1, d2, C, lr, beta, plan, stream);
}

}  // namespace p2pfl
