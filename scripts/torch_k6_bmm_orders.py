"""K6's sums against its plain version, one step at a time, on the card.

    python scripts/torch_k6_bmm_orders.py

Needs a CUDA card. For each (batch, classes) shape of ``SHAPES``, one
SGD step of ``fused_mlp_train_epoch`` from a zero trace at 64 mnist-mlp
nodes (784-256-128-classes; the inputs of ``chip_smoke.k6_sum_orders``)
runs through the kernel and through a copy of the plain version's step
whose products are taken two ways: ``torch.bmm`` as the plain version
takes them, and one ascending fused multiply-add chain a value, the
order the kernel states (emulated: each product of two f32 exact in
f64, added to the f32 sum in f64 and rounded to f32; a double rounding
that differs from ``fmaf`` only where the f64 sum falls on an f32
midpoint). It prints, per shape, the params and traces off the
kernel's bits under each way, and for each of the step's eight
products how many outputs ``torch.bmm`` gives off the chain's bits: a
product whose count is not zero sums in another order than the kernel.
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from p2pfl_tpu_torch.ops import fused_train  # noqa: E402

SHAPES = ((8, 7), (16, 7), (32, 10), (64, 7), (32, 62), (8, 10))
NAMES = ("w0", "b0", "w1", "b1", "w2", "b2")
LR = 0.05


def chain(a, b):
    """``a [n, r, k] @ b [n, k, c]`` as one ascending chain a value."""
    acc = torch.zeros(a.shape[0], a.shape[1], b.shape[2], device=a.device)
    for k in range(a.shape[2]):
        acc = (acc.double() + a[:, :, k:k + 1].double()
               * b[:, k:k + 1, :].double()).float()
    return acc


def step(params, x, y, matmul, counts=None):
    """The plain version's step from a zero trace (its arithmetic op for
    op) with ``matmul`` for every product; ``counts`` collects, per
    product, the outputs of ``torch.bmm`` off the chain's bits."""
    w0, b0, w1, b1, w2, b2 = (t.float() for t in params)
    b = x.shape[1]
    classes = torch.arange(w2.shape[-1], device=x.device)
    onehot = (classes == y[..., 0:1].long()).float()

    def mm(tag, u, v):
        u, v = u.contiguous(), v.contiguous()
        if counts is not None:
            counts[tag] = int((torch.bmm(u, v) != chain(u, v)).sum())
        return matmul(u, v)

    h0 = torch.relu(mm("x @ w0", x, w0) + b0)
    h1 = torch.relu(mm("h0 @ w1", h0, w1) + b1)
    z = mm("h1 @ w2", h1, w2) + b2
    z = z - z.amax(-1, keepdim=True)
    ez = torch.exp(z)
    dl = (ez / fused_train.class_sum(ez) - onehot) / b
    dh1 = mm("dl @ w2^T", dl, w2.transpose(1, 2)) * (h1 > 0)
    dh0 = mm("dh1 @ w1^T", dh1, w1.transpose(1, 2)) * (h0 > 0)
    grads = (mm("x^T @ dh0", x.transpose(1, 2), dh0),
             fused_train.batch_sum(dh0),
             mm("h0^T @ dh1", h0.transpose(1, 2), dh1),
             fused_train.batch_sum(dh1),
             mm("h1^T @ dl", h1.transpose(1, 2), dl),
             fused_train.batch_sum(dl))
    trace = [0.9 * torch.zeros_like(g) + g for g in grads]
    return [p.float() - LR * m for p, m in zip(params, trace)], trace


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for batch, c in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(23)
        shapes = [(64, 784, 256), (64, 1, 256), (64, 256, 128), (64, 1, 128),
                  (64, 128, c), (64, 1, c)]
        params = tuple(torch.randn(s, generator=gen, device=dev) * 0.05
                       for s in shapes)
        mom = tuple(torch.zeros_like(t) for t in params)
        bx = torch.randn((64, batch, 784), generator=gen, device=dev)
        by = torch.randint(0, c, (64, batch, 1), generator=gen, device=dev,
                           dtype=torch.int32)
        kp, km, _ = fused_train.fused_mlp_train_epoch(
            params, mom, bx, by, LR, 0.9, batch_size=batch)
        counts: dict = {}
        off = {}
        for way, matmul in (("torch.bmm", torch.bmm), ("chain", chain)):
            pp, pm = step(params, bx, by, matmul,
                          counts if way == "torch.bmm" else None)
            off[way] = [f"{kind} {n}" for kind, ks, ws in
                        (("params", kp, pp), ("trace", km, pm))
                        for n, a, b in zip(NAMES, ks, ws)
                        if not torch.equal(a, b)]
        print(f"batch {batch}, {c} classes: off the kernel's bits with "
              f"torch.bmm {off['torch.bmm'] or 'none'}; with every product "
              f"one ascending chain {off['chain'] or 'none'}; torch.bmm's "
              f"outputs off the chain per product {counts}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
