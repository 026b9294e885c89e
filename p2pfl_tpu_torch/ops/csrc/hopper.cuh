// Hopper (sm_90a) building blocks of the port's kernels (K1, K2, K3 and
// K6), as inline PTX: mbarriers, TMA tensor loads and stores, 1-D bulk
// copies of contiguous runs, 16- and 4-byte cp.async, ldmatrix, wgmma
// descriptors and instructions, and the host-side encoding of TMA
// descriptors (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint so the build needs no -lcuda).
//
// Shared-memory tiles are "boxes" of R rows x 64 bf16 (128 bytes a row,
// the row along the operand's contiguous global axis) in the 128-byte
// swizzle that TMA writes and wgmma reads: the 16-byte chunk c of row r
// lies at r * 128 + ((c ^ (r % 8)) * 16) from a 1024-byte-aligned base.
// A box holds a K-major operand (rows = M or N, 64 deep) or an
// MN-major one (rows = K, 64 wide); load_box() fills it by TMA or, for
// operands whose rows are not 16-byte multiples, with guarded
// element-wise loads into the same layout.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <stdexcept>
#include <string>

namespace p2pfl {
namespace sm90 {

typedef __nv_bfloat16 bf16;

constexpr int kBoxBytes64 = 64 * 128;  // a 64-row box

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Lane 0 (or any lane with `pred`) arrives; the predicate lives in the
// PTX, so the compiler sees no divergent branch between two wgmma.
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %1, 0;\n"
      " @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"(static_cast<uint32_t>(pred))
      : "memory");
}

// Returns once the phase of parity `parity` has completed. The loop is
// written in PTX (labels are local to the braces), so the compiler sees
// straight-line code and keeps the wgmma of the consumers asynchronous;
// a C loop on the try_wait result is a divergent path to it, and ptxas
// then serializes every wgmma (warning C7518). A wait that lasts 10 s
// can only be a fault of the pipeline: it traps, so the launch fails
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .u64 t0, t1;\n"
      " mov.u64 t0, %%globaltimer;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @p bra DONE;\n"
      " mov.u64 t1, %%globaltimer;\n"
      " sub.u64 t1, t1, t0;\n"
      " setp.gt.u64 p, t1, 10000000000;\n"
      " @p trap;\n"
      " bra WAIT;\n"
      "DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Generic-proxy writes to shared memory become visible to the async
// proxy (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// 1-D bulk copy (TMA's non-tensor form): `bytes` (a multiple of 16) from
// global `src` to shared `dst`, both 16-byte aligned, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A run of `count` bf16 at `src` (rows of an operand whose rows are not
// 16-byte multiples, taken as they lie) goes into a shared-memory slot
// at slot + run_offset(src), so that its 16-byte-aligned middle lands on
// a 16-byte boundary: the slot (16-byte aligned) holds count * 2 + 16
// bytes. The middle goes by one bulk copy; the at most 7 elements on
// either side of it (an unaligned start, a ragged end) by plain loads, so
// that nothing outside the run is read.
__device__ __forceinline__ uint32_t run_offset(const void* src) {
  return static_cast<uint32_t>(reinterpret_cast<uintptr_t>(src) & 15);
}

struct RunCopy {
  const char* mid;   // the middle's first byte (16-byte aligned)
  uint32_t dst_off;  // its offset in the slot (0 or 16)
  uint32_t bytes;    // its length, a multiple of 16 (0: no middle)
};

// Called by the one producer thread: copies the run's edges into the
// slot and returns its middle, which the thread issues with bulk_load
// after its mbar_expect_tx (the arrive releases the edge stores to the
// threads that wait on the barrier).
__device__ __forceinline__ RunCopy copy_run_edges(char* slot, const bf16* src,
                                                  long long count) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t lo = (a + 15) & ~uintptr_t(15);
  const uintptr_t hi = (a + 2 * count) & ~uintptr_t(15);
  unsigned short* d = reinterpret_cast<unsigned short*>(slot + (a & 15));
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  RunCopy r{reinterpret_cast<const char*>(lo),
            static_cast<uint32_t>((a & 15) + (lo - a)), 0};
  if (hi <= lo) {  // no whole 16 aligned bytes (14 elements at most)
    for (long long i = 0; i < count; ++i) d[i] = s[i];
    return r;
  }
  r.bytes = static_cast<uint32_t>(hi - lo);
  const long long head = static_cast<long long>(lo - a) / 2;
  for (long long i = 0; i < head; ++i) d[i] = s[i];
  for (long long i = static_cast<long long>(hi - a) / 2; i < count; ++i)
    d[i] = s[i];
  return r;
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The thread's committed TMA stores but the last kPending have read
// their shared memory.
template <int kPending = 0>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending)
               : "memory");
}

// The thread's committed TMA stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// 4 bytes; with src_bytes 0 the destination is zero-filled and nothing
// is read
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          uint32_t src_bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Byte offset of (row r, byte b) in a 128-byte-swizzled box.
__device__ __forceinline__ uint32_t swz128(uint32_t r, uint32_t b) {
  return r * 128u + ((((b >> 4) ^ r) & 7u) << 4) + (b & 15u);
}

// The same in a 64-byte swizzle (rows of 64 bytes from a 512-byte-
// aligned base): chunk c of row r lies at r * 64 + ((c ^ (r / 2) % 4) *
// 16), so that the 8 rows of an mma fragment store fall in 8 different
// 16-byte chunks of the banks.
__device__ __forceinline__ uint32_t swz64(uint32_t r, uint32_t b) {
  return r * 64u + ((((b >> 4) ^ (r >> 1)) & 3u) << 4) + (b & 15u);
}

// Four 8 x 8 bf16 matrices, transposed: lane 8q + i gives the address of
// row i of matrix q, and r[q] of thread (gid, tig) = lane / 4, lane % 4
// holds its elements (2 tig, gid) and (2 tig + 1, gid) — an mma B
// fragment when the rows run along the depth.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// A 2-D operand per node: element (o, i) of node z at
// p[z * node + o * ld + i], for o < outer and i < inner.
struct Operand {
  const bf16* p;
  long long node;
  long long ld;
  int inner, outer;
};

// Fills a box of `rows` rows x 64 elements from (inner0, outer0) of
// node z, zero outside the operand. kTma: one TMA load by the calling
// lane (lane 0 of the producer warp), completing on `bar`. Otherwise
// the 32 lanes of the producer warp load element by element into the
// same swizzled layout; the caller fences and arrives.
template <bool kTma>
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map,
                                         const Operand& op, uint64_t* bar,
                                         int inner0, int outer0, int z,
                                         int rows, int lane) {
  if constexpr (kTma) {
    tma_load_3d(dst, map, bar, inner0, outer0, z);
  } else {
    const bf16* base = op.p + z * op.node;
    unsigned short* s = static_cast<unsigned short*>(dst);
    for (int idx = lane; idx < rows * 64; idx += 32) {
      const int r = idx >> 6, c = idx & 63;
      const int gi = inner0 + c, go = outer0 + r;
      unsigned short v = 0;
      if (gi < op.inner && go < op.outer)
        v = __bfloat16_as_ushort(base[go * op.ld + gi]);
      s[swz128(r, c * 2) >> 1] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle. For a K-major box
// the 8-row groups lie 1024 B apart (SBO) and a k16 step moves the start
// by 32 B; for an MN-major box the 8-deep k groups lie 1024 B apart
// (SBO), 64-wide MN blocks `lbo` bytes apart, and a k16 step moves the
// start by 2048 B.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;  // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving accesses of an accumulator register
// across the asynchronous wgmma that writes it.
template <int kN>
__device__ __forceinline__ void fence_acc(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16 in, f32 sums; kTA /
// kTB: 0 = K-major, 1 = MN-major; scale_d = 0 overwrites D.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
}

// D[64 x 256] += A[64 x 16] B[16 x 256], as above.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], as above.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

// ---------------------------------------------------------------------------
// epilogue: one warpgroup's 64 x kBN f32 tile -> bf16 rows of C
// ---------------------------------------------------------------------------

// The wgmma accumulator of thread t (warp w = t / 32 of the warpgroup,
// lane l) holds, for each 8-column block j, rows 16w + l/4 (+8) and
// columns 8j + 2(l%4) (+1): d[4j + 2h + e] is (16w + l/4 + 8h,
// 8j + 2(l%4) + e). The tile is staged in shared memory (rows padded by
// 16 B) and written out row by row, 16 bytes a thread where C's rows
// are 16-byte multiples (`vec`), element by element otherwise; rows >=
// `rows` and columns >= `cols` are not written.
template <int kBN>
__device__ __forceinline__ void store_tile(const float (&d)[kBN / 2],
                                           bf16* stage, bf16* c, long long ld,
                                           int rows, int cols, bool vec,
                                           int t, int bar_id) {
  constexpr int kLd = kBN + 8;
  const int w = t >> 5, l = t & 31;
  named_bar_sync(bar_id, 128);  // the last tile's reads of `stage` are done
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * w + (l >> 2) + 8 * h;
      const int col = 8 * j + 2 * (l & 3);
      *reinterpret_cast<__nv_bfloat162*>(&stage[r * kLd + col]) =
          __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  }
  named_bar_sync(bar_id, 128);
  if (rows <= 0 || cols <= 0) return;
  if (vec) {
    constexpr int kChunks = kBN / 8;
    for (int i = t; i < 64 * kChunks; i += 128) {
      const int r = i / kChunks, col = (i % kChunks) * 8;
      if (r >= rows || col >= cols) continue;
      if (col + 8 <= cols) {
        *reinterpret_cast<uint4*>(&c[r * ld + col]) =
            *reinterpret_cast<const uint4*>(&stage[r * kLd + col]);
      } else {
        for (int e = 0; col + e < cols; ++e)
          c[r * ld + col + e] = stage[r * kLd + col + e];
      }
    }
  } else {
    for (int i = t; i < 64 * kBN; i += 128) {
      const int r = i / kBN, col = i % kBN;
      if (r < rows && col < cols) c[r * ld + col] = stage[r * kLd + col];
    }
  }
}

// The same tile written by TMA: the warpgroup stages it as kBN / 64
// swizzled 64 x 64 boxes (conflict-free: the 8 rows of a fragment store
// fall in 8 different 16-byte chunks), and thread 0 stores each box at
// (col0 + 64 j, row0, z) of `map`, which clips what lies outside C. The
// store completes in the background while the warpgroup runs its next
// tile; its shared memory is reused only after the store has read it.
template <int kBN>
__device__ __forceinline__ void store_tile_tma(const float (&d)[kBN / 2],
                                               char* stage,
                                               const CUtensorMap* map,
                                               int col0, int row0, int z,
                                               bool write, int t,
                                               int bar_id) {
  const int w = t >> 5, l = t & 31;
  if (t == 0) bulk_wait_read();
  named_bar_sync(bar_id, 128);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * w + (l >> 2) + 8 * h;
      const int col = 8 * j + 2 * (l & 3);
      *reinterpret_cast<__nv_bfloat162*>(
          stage + (col >> 6) * kBoxBytes64 + swz128(r, (col & 63) * 2)) =
          __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  }
  fence_proxy_async();
  named_bar_sync(bar_id, 128);
  if (t == 0 && write) {
#pragma unroll
    for (int b = 0; b < kBN / 64; ++b)
      tma_store_3d(map, stage + b * kBoxBytes64, col0 + 64 * b, row0, z);
    bulk_commit();
  }
}

// ---------------------------------------------------------------------------
// host side// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (p == nullptr || q != cudaDriverEntryPointSuccess)
      throw std::runtime_error("cuTensorMapEncodeTiled is not available");
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A TMA descriptor of a bf16 operand [n, outer, inner] (row stride ld
// elements, a multiple of 8) for boxes of box_rows x box_inner (64 in
// the 128-byte swizzle by default; 32 in the 64-byte one), zero-filled
// outside the operand on loads and clipped to it on stores.
inline CUtensorMap make_tmap(
    const Operand& op, int n, int box_rows, int box_inner = 64,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  CUtensorMap m;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(op.inner),
                              static_cast<cuuint64_t>(op.outer),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(op.ld) * 2,
                                 static_cast<cuuint64_t>(op.node) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode_tiled()(
      &m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(op.p), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS)
    throw std::runtime_error("cuTensorMapEncodeTiled failed: " +
                             std::to_string(static_cast<int>(r)));
  return m;
}

// TMA can describe the operand: 16-byte-aligned base, row stride a
// multiple of 16 bytes, every extent positive.
inline bool tma_ok(const Operand& op, int n) {
  return reinterpret_cast<uintptr_t>(op.p) % 16 == 0 && op.ld % 8 == 0 &&
         op.node % 8 == 0 && op.inner > 0 && op.outer > 0 && n > 0;
}

inline int sm_count() {
  int dev = 0, count = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  return count > 0 ? count : 1;
}

}  // namespace sm90
}  // namespace p2pfl
