"""The GEMM kernels and K6 timed in several checkouts, in turns.

    python scripts/torch_kernel_ab.py TREE [TREE ...]

Needs a CUDA card. Each TREE is the root of a checkout of this
repository (e.g. the parent commit unpacked with ``git archive`` into a
git-ignored directory, and ``.``); list them in the order to run, e.g.
``parent . . parent``. Each runs in a process of its own, which builds
that tree's kernels (into its own ``p2pfl_tpu_torch/ops/_build/``) and
prints the mean time a call by CUDA events (``chip_smoke.time_ms``) of:

- in bf16, K1 ``stream_gemm`` at the ring's conv1 forward (8 nodes x
  336 FEMNIST-CNN samples: M = 263,424 x K = 25 x N = 32) and at the
  ResNet9 stem's (16 nodes x 131,072 rows, K = 27, N = 64), and K2
  ``stream_wgrad`` at the same two shapes' weight gradients, each
  beside ``torch.bmm`` on the same inputs;
- in f32, K1 at the ring's conv1 and conv2 forward (65,856 x 800 x 64)
  and K2 at conv1's, conv2's and the stem's weight gradients;
- K2 in bf16 at the ring's conv1 and conv2 weight gradients (each, and
  their sum: the pair a ring step runs) and at the cross-device (8 x 20
  samples) and Byzantine (16 x 64) conv2 weight gradients beside
  ``torch.bmm``; K3 ``dense_bwd`` in f32 at dense1 (B = 336, D = 3136,
  H = 2048); seeded normal inputs;
- K6 ``fused_mlp_train_epoch`` at ``chip_smoke.py``'s headline (64
  mnist-mlp nodes, 784-256-128-10, 19 steps of 32, lr 0.05), with f32
  state and inputs and with them rounded to bf16 (10 calls each).
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from p2pfl_tpu_torch.ops import _build, fused_train, gemm

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
_build.kernels()
gen = torch.Generator(device=dev).manual_seed(0)
rand = lambda *s: torch.randn(s, generator=gen, device=dev)
n, b = cs.N_NODES, cs.BATCH
out = []
for tag, op, (nk, m, k, nn) in (
        ("K1 bf16 conv1", "gemm", (n, b * 784, 25, 32)),
        ("K1 bf16 stem", "gemm", (16, 128 * 1024, 27, 64)),
        ("K2 bf16 conv1 (ring)", "wgrad", (n, b * 784, 25, 32)),
        ("K2 bf16 stem", "wgrad", (16, 128 * 1024, 27, 64))):
    x = rand(nk, m, k).to(torch.bfloat16)
    if op == "gemm":
        w = rand(nk, k, nn).to(torch.bfloat16)
        ms = cs.time_ms(lambda: gemm.stream_gemm(x, w))
        lib = cs.time_ms(lambda: torch.bmm(x, w))
        del w
    else:
        g = rand(nk, m, nn).to(torch.bfloat16)
        xt = x.transpose(1, 2)
        ms = cs.time_ms(lambda: gemm.stream_wgrad(x, g))
        lib = cs.time_ms(lambda: torch.bmm(xt, g))
        del g, xt
    out.append(f"{tag} {ms:.4f} (bmm {lib:.4f})")
    del x
torch.cuda.empty_cache()
for tag, (m, k, nn) in (("K1 conv1", (b * 784, 25, 32)),
                        ("K1 conv2", (b * 196, 800, 64))):
    x, w = rand(n, m, k), rand(n, k, nn)
    out.append(f"{tag} {cs.time_ms(lambda: gemm.stream_gemm(x, w)):.4f}")
    del x, w
for tag, (nk, m, k, nn) in (("K2 conv1", (n, b * 784, 25, 32)),
                            ("K2 conv2", (n, b * 196, 800, 64)),
                            ("K2 stem", (16, 128 * 1024, 27, 64))):
    x, g = rand(nk, m, k), rand(nk, m, nn)
    out.append(f"{tag} {cs.time_ms(lambda: gemm.stream_wgrad(x, g)):.4f}")
    del x, g
pair = []
for tag, (m, k, nn) in (("K2 bf16 conv1", (b * 784, 25, 32)),
                        ("K2 bf16 conv2", (b * 196, 800, 64))):
    x = rand(n, m, k).to(torch.bfloat16)
    g = rand(n, m, nn).to(torch.bfloat16)
    pair.append(cs.time_ms(lambda: gemm.stream_wgrad(x, g)))
    out.append(f"{tag} {pair[-1]:.4f}")
    del x, g
out.append(f"K2 bf16 pair {sum(pair):.4f}")
for tag, (nk, m) in (("crossdev", (8, 20 * 196)), ("byzantine", (16, 64 * 196))):
    x = rand(nk, m, 800).to(torch.bfloat16)
    g = rand(nk, m, 64).to(torch.bfloat16)
    xt = x.transpose(1, 2)
    out.append(f"K2 bf16 {tag} conv2 "
               f"{cs.time_ms(lambda: gemm.stream_wgrad(x, g)):.4f} "
               f"(bmm {cs.time_ms(lambda: torch.bmm(xt, g)):.4f})")
    del x, g, xt
torch.cuda.empty_cache()
x, w, g = rand(n, b, 3136), rand(n, 3136, 2048), rand(n, b, 2048)
out.append(f"K3 dense1 {cs.time_ms(lambda: gemm.dense_bwd(x, w, g)):.4f}")
del x, w, g
torch.cuda.empty_cache()
params, mom, bx, by = cs.mlp_epoch_inputs(dev)
bf = lambda ts: tuple(t.to(torch.bfloat16) for t in ts)
for tag, p, m, x in (("K6 f32", params, mom, bx),
                     ("K6 bf16", bf(params), bf(mom), bx.to(torch.bfloat16))):
    ms = cs.time_ms(lambda: fused_train.fused_mlp_train_epoch(
        p, m, x, by, cs.MLP_LR, 0.9, batch_size=cs.MLP_BATCH), reps=10)
    out.append(f"{tag} {ms:.4f}")
print(sys.argv[1] + " (ms): " + ", ".join(out), flush=True)
"""


def main(trees: list[str]) -> int:
    if not trees:
        raise SystemExit(__doc__)
    for tree in trees:
        root = pathlib.Path(tree).resolve()
        subprocess.run([sys.executable, "-c", CHILD, str(root)], check=True,
                       cwd=root)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
