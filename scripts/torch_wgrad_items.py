"""K2's narrow route under several slice plans, on the card.

    python scripts/torch_wgrad_items.py

Needs a CUDA card. At the ring's conv1 weight gradient (8 nodes x
263,424 rows, K = 25, N = 32) and the ResNet9 stem's (16 nodes x
131,072 rows, K = 27, N = 64), bf16 seeded normal inputs, the route is
called through the binding with the plans that ``ops.gemm.wgrad_plan``
would cut for 128, 256, 512 and 1,024 work items: the mean time a call
by CUDA events (``chip_smoke.time_ms``), the profiled device time of
the sums' kernel and of the slice sum, and the largest difference from
the plain version. More items balance a persistent grid better; each
costs a reduction in the kernel and a slice in the slice sum.
"""

from __future__ import annotations

import pathlib
import sys
from unittest import mock

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from p2pfl_tpu_torch.ops import _build, gemm  # noqa: E402

SHAPES = (("conv1", (8, 336 * 784, 25, 32)),
          ("stem", (16, 128 * 1024, 27, 64)))
ITEMS = (128, 256, 512, 1024)


def plan(n, m, k, nn, items):
    """``wgrad_plan``'s cut of the narrow route with ``items`` as its
    target: (rows a slice, slices a node)."""
    with mock.patch.dict(gemm.WGRAD_TARGET_BLOCKS, narrow=items):
        gemm.wgrad_plan.cache_clear()
        p = gemm.wgrad_plan(n, m, k, nn, "narrow")
    gemm.wgrad_plan.cache_clear()
    return p.rows, p.slices


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    k = _build.kernels()
    code = gemm.WGRAD_ROUTES.index("narrow")
    gen = torch.Generator(device=dev).manual_seed(0)
    for tag, (n, m, kk, nn) in SHAPES:
        x = torch.randn((n, m, kk), generator=gen, device=dev).to(
            torch.bfloat16)
        g = torch.randn((n, m, nn), generator=gen, device=dev).to(
            torch.bfloat16)
        want = gemm.stream_wgrad_plain(x, g)
        for items in ITEMS:
            rows, slices = plan(n, m, kk, nn, items)

            def call():
                return k.stream_wgrad(x, g, code, rows, slices)

            err = float((call() - want).abs().max())
            parts = cs.device_parts(call, 10, cs.K2_KERNELS["narrow"])
            print(f"{tag}: {n * slices} items ({slices} slices of {rows} "
                  f"rows): {cs.time_ms(call):.4f} ms a call by events; "
                  + ", ".join(f"{name} {ms:.4f} ms" for name, (ms, _)
                              in parts.items())
                  + f" on the device; max |kernel - plain| {err:.3g}",
                  flush=True)
        del x, g, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
