// K4 and K5 as one multi-tensor streaming kernel, shared by sgd.cu (K4)
// and sgd_accum.cu (K5). Replaces p2pfl_tpu/ops/pallas_gemm.py::_sgd
// (kernel body _sgd_kernel) and ::_sgd_acc (_sgd_accum_kernel; public
// sgd_accum(acc=, weight=) and fedavg_accum). Three forms, each over a
// list of leaves in one launch; a leaf is one parameter stacked over n
// slots (nodes or cohort slots), [n, numel] contiguous:
//
//   step (K4)            m' = g + round_T(decay * m)
//                        p' = round_P(p + m' * (-lr[slot]))
//   step and accumulate  the step, then acc' = acc + w[slot] * f32(p')
//   accumulate (K5 null, fedavg_accum)  acc' = acc + w[slot] * f32(p)
//
// p and g f32 or bf16 (P), the trace f32 or bf16 (T), lr and w [n] f32,
// acc f32; one dtype combination a launch. The JAX package evaluates in
// f32 and rounds only the decayed trace and the outputs; so does this.
//
// Bound on an H100 SXM (3.35 TB/s): memory. Every operand is read once
// and every output written once. The FEMNIST CNN's 8 leaves over 8
// nodes hold 52.8M values: the step with an f32 trace moves 20 bytes a
// value, 1.06 GB (0.315 ms); the null accumulate with f32 p 12 bytes,
// 634 MB (0.189 ms).
//
// What the design does about it:
// - One launch a step, not one a leaf. The leaves' descriptors travel in
//   a __grid_constant__ parameter (kMaxStreamLeaves at most; the binding
//   splits a longer list). Each leaf is cut into tiles of kTileElems
//   values; the tiles of all leaves form one index space of one block a
//   tile, and a block finds its leaf by a binary search of the table.
//   (A persistent grid of the card's resident blocks walking the tiles
//   with a stride, with 4 vectors a thread, reached 84-86% of the bound
//   at Dense_0; one block a tile 88-90%, scripts/torch_stream_variants.py.)
// - 16-byte accesses: a thread moves 4 values of each operand at once
//   (16 bytes of f32, 8 of bf16). 8 blocks of 256 threads are resident
//   on an SM, so each SM has about 100 KB of loads in flight against
//   HBM3's latency; unrolling further lowered the rate (the same script).
// - The slot: one 32-bit division a vector (64-bit only for a leaf of
//   2^32 values or more), then a step to the next slot where the vector
//   crosses a slot boundary (a leaf of 62, 10 or 1 values a slot puts up
//   to four slots in one vector).
// - A leaf whose operands are not all aligned to their vector width (a
//   view with a storage offset) and the ragged last vector of a leaf
//   take a scalar path of the same arithmetic, in the same launch.
// - The plain PyTorch version's bits: every product and sum is an
//   explicit __fmul_rn / __fadd_rn, so nvcc cannot contract them into an
//   FMA, and the bf16 roundings are explicit (round to nearest even). At
//   lr 0 the update is +-0.0, which leaves p bit-exact.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "kernels.h"

namespace p2pfl {
namespace mt {

enum Form { kStep = 0, kStepAccum = 1, kAccum = 2 };

constexpr int kThreads = 256;
constexpr int kVec = 4;  // values a vector, one vector a thread
constexpr int kTileElems = kThreads * kVec;

// A leaf as the kernel reads it.
struct Leaf {
  const void* p;
  const void* m;
  const void* g;
  const float* acc;
  void* p_out;
  void* m_out;
  float* acc_out;
  long long total;  // n * numel values
  long long numel;  // values a slot
  int tile_end;     // one past the leaf's last tile in the launch
  int vec;          // 1: every operand aligned to its vector width
};

struct Table {
  Leaf leaf[kMaxStreamLeaves];
  const float* lr;
  const float* w;
  float decay;
  int count;  // leaves
  int tiles;
};
static_assert(sizeof(Table) <= 4096, "a kernel's parameters take 4 KB");

// ---- loads and stores: 4 values as f32 -----------------------------------

__device__ __forceinline__ void load4(const float* a, long long i,
                                      float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(a + i);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* a, long long i,
                                      float (&v)[4]) {
  // a bf16 is the top half of its f32: widening is a shift
  const uint2 x = *reinterpret_cast<const uint2*>(a + i);
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xffff0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xffff0000u);
}
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}
__device__ __forceinline__ void store4(float* a, long long i,
                                       const float (&v)[4]) {
  *reinterpret_cast<float4*>(a + i) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* a, long long i,
                                       const float (&v)[4]) {
  *reinterpret_cast<uint2*>(a + i) =
      make_uint2(bf16_bits(v[0]) | (bf16_bits(v[1]) << 16),
                 bf16_bits(v[2]) | (bf16_bits(v[3]) << 16));
}
__device__ __forceinline__ float load1(const float* a, long long i) {
  return a[i];
}
__device__ __forceinline__ float load1(const __nv_bfloat16* a, long long i) {
  return __bfloat162float(a[i]);
}
__device__ __forceinline__ void store1(float* a, long long i, float v) {
  a[i] = v;
}
__device__ __forceinline__ void store1(__nv_bfloat16* a, long long i,
                                       float v) {
  a[i] = __float2bfloat16(v);
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// ---- one value ------------------------------------------------------------

template <int F, typename P, typename T>
__device__ __forceinline__ void update(float p, float m, float g, float acc,
                                       float neg_lr, float w, float decay,
                                       float& p_new, float& m_new,
                                       float& acc_new) {
  if constexpr (F == kAccum) {
    acc_new = __fadd_rn(acc, __fmul_rn(w, p));
  } else {
    m_new = __fadd_rn(
        g, round_to(__fmul_rn(decay, m), static_cast<const T*>(nullptr)));
    p_new = round_to(__fadd_rn(p, __fmul_rn(m_new, neg_lr)),
                     static_cast<const P*>(nullptr));
    if constexpr (F == kStepAccum)
      acc_new = __fadd_rn(acc, __fmul_rn(w, p_new));
  }
}

// The slot of value e, its first value's successor, and the slot's lr
// and weight. One division; walk() then steps value by value.
template <int F>
struct Slot {
  long long next;
  int s;
  float neg_lr = 0.f, w = 0.f;

  __device__ __forceinline__ Slot(const Table& tab, const Leaf& L,
                                  long long e) {
    s = L.total <= 0xffffffffLL
            ? static_cast<int>(static_cast<unsigned>(e) /
                               static_cast<unsigned>(L.numel))
            : static_cast<int>(e / L.numel);
    next = (s + 1LL) * L.numel;
    load(tab);
  }
  __device__ __forceinline__ void load(const Table& tab) {
    if constexpr (F != kAccum) neg_lr = -__ldg(tab.lr + s);
    if constexpr (F != kStep) w = __ldg(tab.w + s);
  }
  // value e (the one after the last walked, or the first) lies in the
  // next slot once it reaches `next`; numel >= 1, so one step suffices
  __device__ __forceinline__ void walk(const Table& tab, const Leaf& L,
                                       long long e) {
    if (e >= next) {
      ++s;
      next += L.numel;
      load(tab);
    }
  }
};

// ---- one vector a thread -------------------------------------------------

template <int F, typename P, typename T>
__device__ __forceinline__ void vector4(const Table& tab, const Leaf& L,
                                        long long e) {
  // operands a form does not read stay 0 and are not used
  float pv[4], mv[4] = {}, gv[4] = {}, av[4] = {};
  load4(static_cast<const P*>(L.p), e, pv);
  if constexpr (F != kAccum) {
    load4(static_cast<const T*>(L.m), e, mv);
    load4(static_cast<const P*>(L.g), e, gv);
  }
  if constexpr (F != kStep) load4(L.acc, e, av);
  Slot<F> slot(tab, L, e);
  float po[4] = {}, mo[4] = {}, ao[4] = {};
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    slot.walk(tab, L, e + k);
    update<F, P, T>(pv[k], mv[k], gv[k], av[k], slot.neg_lr, slot.w,
                    tab.decay, po[k], mo[k], ao[k]);
  }
  if constexpr (F != kAccum) {
    store4(static_cast<P*>(L.p_out), e, po);
    store4(static_cast<T*>(L.m_out), e, mo);
  }
  if constexpr (F != kStep) store4(L.acc_out, e, ao);
}

template <int F, typename P, typename T>
__device__ __forceinline__ void scalar4(const Table& tab, const Leaf& L,
                                        long long e) {
  const P* p = static_cast<const P*>(L.p);
  const T* m = static_cast<const T*>(L.m);
  const P* g = static_cast<const P*>(L.g);
  Slot<F> slot(tab, L, e);
  for (long long i = e; i < e + kVec && i < L.total; ++i) {
    slot.walk(tab, L, i);
    float mi = 0.f, gi = 0.f, ai = 0.f, po = 0.f, mo = 0.f, ao = 0.f;
    if constexpr (F != kAccum) {
      mi = load1(m, i);
      gi = load1(g, i);
    }
    if constexpr (F != kStep) ai = L.acc[i];
    update<F, P, T>(load1(p, i), mi, gi, ai, slot.neg_lr, slot.w, tab.decay,
                    po, mo, ao);
    if constexpr (F != kAccum) {
      store1(static_cast<P*>(L.p_out), i, po);
      store1(static_cast<T*>(L.m_out), i, mo);
    }
    if constexpr (F != kStep) L.acc_out[i] = ao;
  }
}

// One block a tile: the block's leaf is the first whose tile_end exceeds
// its tile; each thread takes one vector of it.
template <int F, typename P, typename T>
__global__ void __launch_bounds__(kThreads)
    stream_kernel(const __grid_constant__ Table tab) {
  const int t = blockIdx.x;
  int lo = 0, hi = tab.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (t < tab.leaf[mid].tile_end)
      hi = mid;
    else
      lo = mid + 1;
  }
  const Leaf& L = tab.leaf[lo];
  const int tile0 = lo == 0 ? 0 : tab.leaf[lo - 1].tile_end;
  const long long e =
      static_cast<long long>(t - tile0) * kTileElems + threadIdx.x * kVec;
  if (e >= L.total) return;
  if (L.vec && e + kVec <= L.total)
    vector4<F, P, T>(tab, L, e);
  else
    scalar4<F, P, T>(tab, L, e);
}

// ---- host side ------------------------------------------------------------

inline bool aligned(const void* a, int bytes) {
  return reinterpret_cast<std::uintptr_t>(a) % bytes == 0;
}

// Fill the table from `count` non-empty leaves; p_bytes and t_bytes are
// the element sizes of p (and g) and of the trace.
inline void fill_table(Table& tab, const StreamLeaf* leaves, int count,
                       int p_bytes, int t_bytes) {
  long long tiles = 0;
  for (int i = 0; i < count; ++i) {
    const StreamLeaf& s = leaves[i];
    Leaf& L = tab.leaf[i];
    L.p = s.p;
    L.m = s.m;
    L.g = s.g;
    L.acc = s.acc;
    L.p_out = s.p_out;
    L.m_out = s.m_out;
    L.acc_out = s.acc_out;
    L.total = s.n * s.numel;
    L.numel = s.numel;
    tiles += (L.total + kTileElems - 1) / kTileElems;
    L.tile_end = static_cast<int>(tiles);
    const int pv = kVec * p_bytes, tv = kVec * t_bytes, av = kVec * 4;
    L.vec = aligned(s.p, pv) && aligned(s.g, pv) && aligned(s.p_out, pv) &&
            aligned(s.m, tv) && aligned(s.m_out, tv) &&
            aligned(s.acc, av) && aligned(s.acc_out, av);
  }
  tab.count = count;
  tab.tiles = static_cast<int>(tiles);
}

// Launch on `stream`, one block a tile.
template <int F, typename P, typename T>
void launch(const Table& tab, cudaStream_t stream) {
  if (tab.tiles == 0) return;
  stream_kernel<F, P, T><<<tab.tiles, kThreads, 0, stream>>>(tab);
}

}  // namespace mt
}  // namespace p2pfl
