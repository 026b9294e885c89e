"""K6: one SGD-with-momentum epoch of a stack of 3-layer ReLU MLPs.

The counterpart of ``p2pfl_tpu/ops/fused_train.py``. For every node of
a stacked ``[n, ...]`` federation, one call runs a whole local epoch:
for each of ``steps`` batches, the forward pass, softmax cross-entropy
(mean over the batch), the backward pass, then ``m = beta * m + g`` and
``p = p - lr * m`` on every leaf, biases included. The returned loss is
each node's mean over the steps.

- ``fused_mlp_train_epoch_plain``: the epoch in plain PyTorch, batched
  over the node axis in f32; its forward products (``chain_matmul``),
  bias gradients and softmax denominator are summed in the orders the
  kernel states (``batch_sum``, ``class_sum``), its backward products
  with ``torch.bmm``.
- ``fused_mlp_train_epoch``: the wrapper. CPU tensors go to the plain
  version; CUDA tensors go to the hand-written kernel
  (``csrc/fused_train.cu``: one 8-block thread-block cluster per node,
  which holds the node's weights in shared memory for the whole epoch,
  two cluster barriers a step; widths whose state does not fit run its
  second, L2-resident instantiation) or raise. The kernel takes f32 or
  bf16 params, traces and inputs (each tensor its own) and int32 or
  int64 labels. As in the JAX kernel, bf16 is widened to f32 on entry,
  the epoch runs in f32, and the state is rounded back to its dtype once
  at the end; the plain version does the same casts. Launches with any
  bf16 operand count under ``fused_mlp_train_epoch_bf16``.

Layouts are the JAX package's: ``params`` and ``momentum_state`` are
tuples ``(w0 [n,d_in,d1], b0 [n,1,d1], w1 [n,d1,d2], b1 [n,1,d2],
w2 [n,d2,C], b2 [n,1,C])``, ``bx [n, steps*batch, d_in]`` and ``by
[n, steps*batch, 1]``. ``mlp_params_to_tuple`` and
``tuple_to_mlp_params`` bridge the port's stacked ``mnist-mlp`` tree.
The JAX package never wires this epoch into a round; neither does the
port: its path is its own entry point.
"""

from __future__ import annotations

import torch

from p2pfl_tpu_torch.ops import _build
from p2pfl_tpu_torch.ops.gemm import _on_cpu, launches

__all__ = ["fused_mlp_train_epoch", "fused_mlp_train_epoch_plain",
           "batch_sum", "chain_matmul", "class_sum",
           "mlp_params_to_tuple", "tuple_to_mlp_params"]


def _epoch_shape(rows: int, batch_size: int) -> tuple[int, int]:
    """``(steps, batch)`` for ``rows`` rows a node: a shard smaller than
    one batch is one step of all its rows; otherwise ``rows`` must be a
    multiple of ``batch_size``."""
    steps = rows // batch_size
    if steps == 0:
        steps, batch_size = 1, rows
    if rows % batch_size:
        raise ValueError(
            f"data rows ({rows}) must be a multiple of batch_size "
            f"({batch_size}) — pass the steps*batch truncation, or the "
            "epoch would silently train at a different batch size")
    return steps, batch_size


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t [n, B, d]`` summed over the batch (dim 1) into ``[n, 1, d]`` in
    the kernel's order (``csrc/fused_train.cu::batch_sum``): accumulator
    r takes the rows b = r (mod 4) in ascending b, from zero, and the
    four are added as ((a0 + a1) + a2) + a3. Elementwise adds only, so
    the bits are the same on every device."""
    n, b, d = t.shape
    acc = torch.zeros((n, 4, d), dtype=t.dtype, device=t.device)
    for b0 in range(0, b, 4):
        k = min(4, b - b0)
        acc[:, :k] = acc[:, :k] + t[:, b0:b0 + k]
    return ((acc[:, 0:1] + acc[:, 1:2]) + acc[:, 2:3]) + acc[:, 3:4]


def class_sum(t: torch.Tensor) -> torch.Tensor:
    """``t [..., C]`` summed over the classes (the last dim), keeping it,
    in the kernel's order (``csrc/fused_train.cu::class_sum``): lane l
    (0-3) is the sum over k = l (mod 8) plus the sum over k = l + 4
    (mod 8), each in ascending k from zero, and the lanes meet as
    (l0 + l2) + (l1 + l3). Elementwise adds only."""
    c = t.shape[-1]
    acc = torch.zeros(t.shape[:-1] + (8,), dtype=t.dtype, device=t.device)
    for k0 in range(0, c, 8):
        k = min(8, c - k0)
        acc[..., :k] = acc[..., :k] + t[..., k0:k0 + k]
    lane = acc[..., 0:4] + acc[..., 4:8]
    return (lane[..., 0:1] + lane[..., 2:3]) + (lane[..., 1:2]
                                                + lane[..., 3:4])


def chain_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [n, r, k] @ b [n, k, c]`` in f32 as one ascending chain a
    value, the kernel's order for its forward products
    (``csrc/fused_train.cu``: one fmaf chain from zero over k). Emulated
    in f64: each product of two f32 values is exact there, is added to
    the f32 sum in f64 and the sum rounded to f32 at each term (a double
    rounding that differs from ``fmaf`` only where the f64 sum falls on
    an f32 midpoint). Elementwise ops only, so the bits are the same on
    every device; ``torch.bmm`` sums in an order of its own (at 8 rows
    cuBLAS's is not this chain)."""
    a64, b64 = a.double(), b.double()
    acc = torch.zeros(a.shape[0], a.shape[1], b.shape[2],
                      dtype=torch.float32, device=a.device)
    for k in range(a.shape[2]):
        acc = torch.addcmul(acc.double(), a64[:, :, k:k + 1],
                            b64[:, k:k + 1, :]).float()
    return acc


def fused_mlp_train_epoch_plain(params, momentum_state, bx, by, lr: float,
                                momentum: float = 0.9,
                                batch_size: int = 32):
    """The epoch in plain PyTorch (f32 products and sums, bf16 inputs
    widened on entry); returns ``(params', momentum', loss [n])``, each
    leaf rounded once to its input dtype. The forward products, the
    bias gradients and the softmax denominator are summed in the
    kernel's stated orders (:func:`chain_matmul`, :func:`batch_sum`,
    :func:`class_sum`), not in ``torch.bmm``'s and ``torch.sum``'s,
    which change with the shape and the device. The backward products
    stay ``torch.bmm``: at every shape read on the card, their sums
    agree with the kernel's."""
    n, rows, _ = bx.shape
    steps, b = _epoch_shape(rows, int(batch_size))
    lr, beta = float(lr), float(momentum)
    p = [t.float() for t in params]
    m = [t.float() for t in momentum_state]
    n_classes = p[4].shape[-1]
    classes = torch.arange(n_classes, device=bx.device)
    x_all, y_all = bx.float(), by[..., 0].long()
    loss_sum = torch.zeros(n, dtype=torch.float32, device=bx.device)
    for s in range(steps):
        x = x_all[:, s * b:(s + 1) * b]
        onehot = (classes == y_all[:, s * b:(s + 1) * b, None]).float()
        w0, b0, w1, b1, w2, b2 = p
        h0 = torch.relu(chain_matmul(x, w0) + b0)
        h1 = torch.relu(chain_matmul(h0, w1) + b1)
        z = chain_matmul(h1, w2) + b2
        z = z - z.amax(-1, keepdim=True)
        ez = torch.exp(z)
        se = class_sum(ez)
        logp = z - torch.log(se)
        loss_sum = loss_sum + -(onehot * logp).sum((1, 2)) / b
        dlogits = (ez / se - onehot) / b
        dh1 = torch.bmm(dlogits, w2.transpose(1, 2)) * (h1 > 0)
        dh0 = torch.bmm(dh1, w1.transpose(1, 2)) * (h0 > 0)
        grads = (torch.bmm(x.transpose(1, 2), dh0), batch_sum(dh0),
                 torch.bmm(h0.transpose(1, 2), dh1), batch_sum(dh1),
                 torch.bmm(h1.transpose(1, 2), dlogits),
                 batch_sum(dlogits))
        m = [beta * mi + gi for mi, gi in zip(m, grads)]
        p = [pi - lr * mi for pi, mi in zip(p, m)]
    return (tuple(a.to(t.dtype) for a, t in zip(p, params)),
            tuple(a.to(t.dtype) for a, t in zip(m, momentum_state)),
            loss_sum / steps)


def _check_kernel_operands(params, momentum_state, bx, by) -> None:
    if len(params) != 6 or len(momentum_state) != 6:
        raise ValueError("params and momentum_state are 6-tuples "
                         "(w0, b0, w1, b1, w2, b2)")
    for t in (*params, *momentum_state, bx):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(
                f"the fused epoch kernel takes float32 or bfloat16 params, "
                f"trace and inputs, got {t.dtype} (other dtypes: ROADMAP.md "
                "queue A, item A19)")
    if by.dtype not in (torch.int32, torch.int64):
        raise ValueError(
            f"the fused epoch kernel takes int32 or int64 labels, got "
            f"{by.dtype} (ROADMAP.md queue A, item A19)")


def fused_mlp_train_epoch(params, momentum_state, bx, by, lr: float,
                          momentum: float = 0.9, batch_size: int = 32):
    """K6 (``csrc/fused_train.cu``): one SGD-with-momentum epoch per
    node; returns ``(params', momentum', loss [n])``. The inputs are
    not modified: the kernel trains copies of them in place."""
    if _on_cpu(*params, *momentum_state, bx, by):
        return fused_mlp_train_epoch_plain(params, momentum_state, bx, by,
                                           lr, momentum, batch_size)
    _check_kernel_operands(params, momentum_state, bx, by)
    _, rows, _ = bx.shape
    _, b = _epoch_shape(rows, int(batch_size))
    state = [torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)
             for t in (*params, *momentum_state)]
    loss = _build.kernels().fused_mlp_train_epoch(
        state, bx.contiguous(), by.contiguous(), b, float(lr),
        float(momentum))
    bf16 = any(t.dtype == torch.bfloat16 for t in (*state, bx))
    launches["fused_mlp_train_epoch_bf16" if bf16
             else "fused_mlp_train_epoch"] += 1
    return tuple(state[:6]), tuple(state[6:]), loss


def mlp_params_to_tuple(stacked_params):
    """The port's stacked 3-Dense tree (``{"params": {"Dense_i":
    {"kernel", "bias"}}}``, leading node axis) -> ``(w0, b0, w1, b1,
    w2, b2)`` with biases ``[n, 1, d]`` (views, no copies)."""
    p = stacked_params["params"]
    out = []
    for i in range(3):
        d = p[f"Dense_{i}"]
        out += [d["kernel"], d["bias"][:, None, :]]
    return tuple(out)


def tuple_to_mlp_params(t):
    """Inverse of :func:`mlp_params_to_tuple`."""
    return {"params": {f"Dense_{i}": {"kernel": t[2 * i],
                                      "bias": t[2 * i + 1][:, 0, :]}
                       for i in range(3)}}
