"""Variants of K4/K5's streaming loop at the FEMNIST CNN's largest leaf.

    python scripts/torch_stream_variants.py

Needs a CUDA card and ``nvcc`` (``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``
or the ``PATH``). It compiles one stand-alone program (no PyTorch) into
a temporary directory and runs it. The program times, with CUDA events
over 50 launches, the loop that ``p2pfl_tpu_torch/ops/csrc/
multi_tensor.cuh`` runs, over one leaf of 8 x 3136 x 2048 f32 values
(Dense_0.kernel at 8 nodes):

- K4's step (p, m, g read; p', m' written: 20 bytes a value) and K5's
  null accumulate (p, acc read; acc' written: 12 bytes a value);
- a persistent grid (the card's resident blocks walking the tiles with
  a stride) against one block a tile;
- 1, 2, 4 or 8 16-byte vectors a thread; plain loads against
  streaming (evict-first) loads and stores;

and a plain 16-byte copy (8 bytes a value) as the card's yardstick.
Each line gives the time, the rate and its share of the card's 3.35 TB/s.
The arithmetic is the kernel's; the values are zeros (the rate does not
depend on them).
"""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdio>

constexpr long long N = 8LL * 3136 * 2048;
constexpr long long NUMEL = 3136LL * 2048;

template <bool CS>
__device__ __forceinline__ float4 ld4(const float* a, long long i) {
  if constexpr (CS) return __ldcs(reinterpret_cast<const float4*>(a + i));
  else return *reinterpret_cast<const float4*>(a + i);
}
template <bool CS>
__device__ __forceinline__ void st4(float* a, long long i, float4 v) {
  if constexpr (CS) __stcs(reinterpret_cast<float4*>(a + i), v);
  else *reinterpret_cast<float4*>(a + i) = v;
}
__device__ __forceinline__ float step(float p, float m, float g, float nlr,
                                      float& m_new) {
  m_new = __fadd_rn(g, __fmul_rn(0.9f, m));
  return __fadd_rn(p, __fmul_rn(m_new, nlr));
}

// FORM 0: the K4 step; FORM 2: the K5 null accumulate
template <int FORM, int T, int U, bool PERSIST, bool CS>
__global__ void __launch_bounds__(T) loop(
    const float* __restrict__ p, const float* __restrict__ m,
    const float* __restrict__ g, const float* __restrict__ lr,
    float* __restrict__ po, float* __restrict__ mo, int tiles) {
  constexpr int TILE = T * U * 4;
  for (int t = blockIdx.x; t < tiles; t += PERSIST ? gridDim.x : tiles) {
    const long long base = static_cast<long long>(t) * TILE;
    float4 a[U], b[U], c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long e = base + (u * T + threadIdx.x) * 4;
      a[u] = ld4<CS>(p, e);
      b[u] = ld4<CS>(m, e);
      if constexpr (FORM == 0) c[u] = ld4<CS>(g, e);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long e = base + (u * T + threadIdx.x) * 4;
      const float x = __ldg(lr + static_cast<unsigned>(e) /
                                     static_cast<unsigned>(NUMEL));
      if constexpr (FORM == 0) {
        float4 mn, pn;
        pn.x = step(a[u].x, b[u].x, c[u].x, -x, mn.x);
        pn.y = step(a[u].y, b[u].y, c[u].y, -x, mn.y);
        pn.z = step(a[u].z, b[u].z, c[u].z, -x, mn.z);
        pn.w = step(a[u].w, b[u].w, c[u].w, -x, mn.w);
        st4<CS>(po, e, pn);
        st4<CS>(mo, e, mn);
      } else {
        float4 r;
        r.x = __fadd_rn(b[u].x, __fmul_rn(x, a[u].x));
        r.y = __fadd_rn(b[u].y, __fmul_rn(x, a[u].y));
        r.z = __fadd_rn(b[u].z, __fmul_rn(x, a[u].z));
        r.w = __fadd_rn(b[u].w, __fmul_rn(x, a[u].w));
        st4<CS>(po, e, r);
      }
    }
  }
}

__global__ void copy(const float4* __restrict__ a, float4* __restrict__ b,
                     long long n4) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * blockDim.x)
    b[i] = a[i];
}

float *P, *M, *G, *LR, *PO, *MO;

template <typename F>
float time_ms(F go) {
  for (int i = 0; i < 5; ++i) go();
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int i = 0; i < 50; ++i) go();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0;
  cudaEventElapsedTime(&ms, a, b);
  return ms / 50;
}

void report(const char* form, const char* name, int blocks, float ms,
            double bytes) {
  printf("%-5s %-36s blocks %6d  %.4f ms  %.3f TB/s  %.1f%% of 3.35 TB/s\n",
         form, name, blocks, ms, bytes / ms / 1e9,
         100.0 * bytes / 3.35e9 / ms);
}

template <int FORM, int T, int U, bool PERSIST, bool CS>
void run(const char* name) {
  const int tiles = static_cast<int>(N / (T * U * 4));
  int per_sm = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, loop<FORM, T, U, PERSIST, CS>, T, 0);
  int blocks = PERSIST ? sms * per_sm : tiles;
  if (blocks > tiles) blocks = tiles;
  const float ms = time_ms([&] {
    loop<FORM, T, U, PERSIST, CS><<<blocks, T>>>(P, M, G, LR, PO, MO, tiles);
  });
  report(FORM == 0 ? "K4" : "null", name, blocks, ms,
         N * (FORM == 0 ? 20.0 : 12.0));
}

int main() {
  for (float** a : {&P, &M, &G, &PO, &MO}) {
    cudaMalloc(a, N * 4);
    cudaMemset(*a, 0, N * 4);
  }
  cudaMalloc(&LR, 64);
  cudaMemset(LR, 0, 64);
  run<0, 256, 4, true, true>("persistent, 4 vectors, streaming");
  run<0, 256, 4, true, false>("persistent, 4 vectors");
  run<0, 256, 1, false, false>("a block a tile, 1 vector");
  run<0, 256, 2, false, false>("a block a tile, 2 vectors");
  run<0, 256, 4, false, false>("a block a tile, 4 vectors");
  run<0, 256, 8, false, false>("a block a tile, 8 vectors");
  run<0, 256, 1, false, true>("a block a tile, 1 vector, streaming");
  run<0, 256, 4, false, true>("a block a tile, 4 vectors, streaming");
  run<2, 256, 4, true, true>("persistent, 4 vectors, streaming");
  run<2, 256, 4, true, false>("persistent, 4 vectors");
  run<2, 256, 1, false, false>("a block a tile, 1 vector");
  run<2, 256, 2, false, false>("a block a tile, 2 vectors");
  run<2, 256, 4, false, false>("a block a tile, 4 vectors");
  run<2, 256, 8, false, false>("a block a tile, 8 vectors");
  run<2, 256, 1, false, true>("a block a tile, 1 vector, streaming");
  run<2, 256, 4, false, true>("a block a tile, 4 vectors, streaming");
  for (int blocks : {132 * 8, 132 * 64}) {
    const float ms = time_ms([&] {
      copy<<<blocks, 256>>>(reinterpret_cast<const float4*>(P),
                            reinterpret_cast<float4*>(PO), N / 4);
    });
    report("copy", "grid-stride 16-byte copy", blocks, ms, N * 8.0);
  }
  const cudaError_t e = cudaDeviceSynchronize();
  printf("%s\n", cudaGetErrorString(e));
  return e == cudaSuccess ? 0 : 1;
}
"""


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise SystemExit("torch_stream_variants: nvcc not found")


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        src = pathlib.Path(tmp) / "variants.cu"
        exe = pathlib.Path(tmp) / "variants"
        src.write_text(SOURCE)
        subprocess.run([nvcc(), "-std=c++17", "-O3",
                        "-gencode=arch=compute_90a,code=sm_90a", "-o",
                        str(exe), str(src)], check=True)
        return subprocess.run([str(exe)], check=False).returncode


if __name__ == "__main__":
    sys.exit(main())
