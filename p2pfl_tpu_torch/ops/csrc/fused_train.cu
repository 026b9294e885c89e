// K6. Replaces p2pfl_tpu/ops/fused_train.py::_call (kernel body _kernel):
// one SGD-with-momentum epoch of a 3-layer ReLU MLP per node, for a
// stack of n nodes. For each of `steps` batches of B rows:
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
// Design. The TPU kernel keeps one node's params and trace in VMEM for
// the whole epoch. One node's f32 state here is 1.88 MB, more than the
// 227 KB of shared memory a block may use. So:
// - one thread-block cluster of 8 blocks per node (__cluster_dims__);
//   each block owns a slice of every layer's output columns (w2 and b2:
//   rows of w2, and block 0 the bias and the softmax);
// - the node's params and trace live in the output tensors in device
//   memory (the wrapper copies the inputs there first); about 16
//   clusters are resident at once, so the live state stays in L2;
// - activations and their gradients (h0, h1, dl, dh1, dh0) go through a
//   per-node scratch tensor the wrapper allocates;
// - six phases a step separated by cluster barriers: fwd L0, fwd L1,
//   fwd L2 + softmax/CE (block 0), bwd L2 with the w2/b2/b1 updates,
//   bwd L1 (dh0) with the w0/b0 updates, the w1 update. Each gradient
//   element is computed by one thread, which applies the SGD update to
//   its parameter at once: no gradient is stored. A weight is updated
//   only after the last read of its old value in the step;
// - data another block wrote is read with ld.global.cg (L2, not the
//   SM's L1), after a fence and the cluster barrier;
// - products are 32x32 output tiles staged through shared memory in
//   32-deep slices, f32 FMA; each output, each batch sum of a gradient
//   and the loss is summed by one thread in a fixed order, so the kernel
//   gives the same bits on every run. The update uses explicit
//   __fmul_rn / __fadd_rn / __fsub_rn, as the plain version rounds.
// What it leaves on the table: the state in distributed shared memory
// across a 16-block non-portable cluster, wgmma in TF32 (or 3xTF32), TMA
// for the batch stream, register tiles larger than 4 outputs a thread.
#include <cooperative_groups.h>

#include <cstdint>

#include "kernels.h"

namespace cg = cooperative_groups;

namespace p2pfl {
namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 256;
constexpr int kTile = 32;

struct MlpState {
  float* p[6];  // w0, b0, w1, b1, w2, b2 (trained in place)
  float* m[6];  // their momentum traces
};

__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }

// m = beta * m + g; p = p - lr * m, rounded as the plain version rounds.
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

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }
__device__ __forceinline__ float gate(float v, float h) {
  return v * (h > 0.f ? 1.f : 0.f);
}

// the slice [*lo, *lo + *cnt) of `d` columns block `rank` owns
__device__ __forceinline__ void slice(int d, int rank, int* lo, int* cnt) {
  const int w = (d + kCluster - 1) / kCluster;
  *lo = min(d, rank * w);
  *cnt = min(d, *lo + w) - *lo;
}

template <typename Label>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    fused_mlp_epoch_kernel(const float* __restrict__ bx,
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
        float se = 0.f;
        for (int k = 0; k < C; ++k) se += expf(ld(row + k) - zmax);
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
      float g = 0.f;
      for (int b = 0; b < B; ++b)
        g += ld(dh1 + static_cast<long long>(b) * d2 + c2 + j);
      sgd(b1, mb1, c2 + j, g, lr, beta);
    }
    if (rank == 0) {
      for (int k = t; k < C; k += kThreads) {  // b2: sum_b dl
        float g = 0.f;
        for (int b = 0; b < B; ++b)
          g += ld(dl + static_cast<long long>(b) * C + k);
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
      float g = 0.f;
      for (int b = 0; b < B; ++b)
        g += ld(dh0 + static_cast<long long>(b) * d1 + c1 + j);
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
  const dim3 grid(static_cast<unsigned>(n) * kCluster);
  if (by_int64)
    fused_mlp_epoch_kernel<int64_t><<<grid, kThreads, 0, stream>>>(
        bx, static_cast<const int64_t*>(by), st, scratch, loss, rows, steps,
        batch, d_in, d1, d2, C, lr, beta);
  else
    fused_mlp_epoch_kernel<int32_t><<<grid, kThreads, 0, stream>>>(
        bx, static_cast<const int32_t*>(by), st, scratch, loss, rows, steps,
        batch, d_in, d1, d2, C, lr, beta);
}

}  // namespace p2pfl
