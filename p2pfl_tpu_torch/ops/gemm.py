"""The training path's kernels: wrappers, plain versions, autograd.

The counterpart of ``p2pfl_tpu/ops/pallas_gemm.py``. Five hand-written
Hopper kernels (CUDA C++ for ``sm_90a``, sources in ``ops/csrc/``, built
on first use by ``ops/_build.py``) replace the five Pallas kernels the
FEMNIST-CNN rounds run:

- ``stream_gemm`` (K1, replaces ``_stream_gemm``): ``[n,M,K] @ [n,K,N]``
  in bf16 with f32 accumulation — conv1 and conv2 forward.
- ``stream_wgrad`` (K2, replaces ``_stream_wgrad``): ``[n,M,K]^T @
  [n,M,N]`` summed in f32 — conv1 and conv2 weight gradients, in slices
  of rows that :func:`wgrad_plan` cuts from the shape alone.
- ``dense_bwd`` (K3, replaces ``_dense_bwd``): ``dx = g @ w^T`` and
  ``dw = x^T @ g`` in one launch — the dense1 backward.
- ``sgd_accum_many`` (K4, replaces ``_sgd``): one SGD-with-momentum
  step over every leaf of a training step in one launch.
- ``sgd_accum_many(accs=, weight=)`` and ``fedavg_accum_many`` (K5,
  replaces ``_sgd_acc``): K4 plus the weighted FedAvg accumulate
  ``acc + w[slot] * p'``, and its null form ``acc + w[slot] * p`` — the
  cross-device round's per-step accumulate, one launch for all leaves.
  ``sgd_accum`` and ``fedavg_accum`` are their one-leaf cases, with the
  signatures of the JAX package's ``pallas_gemm.sgd_accum`` and
  ``fedavg_accum``.

K1-K3 run in the operands' dtype: bf16 (the kernels above) or float32
(the model's ``compute_dtype`` float32), with f32 sums either way. In
float32, K1 and K3 (``csrc/gemm_f32_tc.cu``) take 3xTF32 on ``wgmma``
(each operand split into two TF32 halves, three products, every 32-deep
block's sum added to the total in round-to-nearest f32) and K1 at a
depth of 32 or less exact f32 FMA chains; K2 (the same file) takes
3xTF32 on ``wgmma`` at K >= 33 and exact f32 FMA chains over
``cp.async`` row spans at K <= 32 (and over 32 rows or fewer). The
launches of the f32 instantiations count under their own keys
(``stream_gemm_f32`` ...). K4 and K5 take f32 or bf16 params and
traces; of K4's launches
(``sgd_accum``), those with bf16 params are counted again under
``sgd_accum_bf16``.

Every kernel takes the node axis as its leading dimension; the JAX
package's ``vmap`` over nodes is that axis written out. Beside each
wrapper is its plain PyTorch version (``*_plain``, the same f32
arithmetic written out). A wrapper takes the plain version only for a
tensor that lies on the CPU; for a CUDA tensor it launches its kernel
or raises. There is no gate and no fallback: the JAX package's measured
``choose()`` is not ported, and the question it answered — does the
kernel beat the library? — is answered by the library-call column of
``PERF.md``. ``launches`` counts kernel launches per wrapper, so a run
can show that it went through the kernels.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from p2pfl_tpu_torch.ops import _build

__all__ = [
    "stream_gemm", "stream_gemm_plain", "stream_gemm_branch",
    "STREAM_GEMM_BRANCHES",
    "stream_wgrad", "stream_wgrad_plain", "wgrad_plan", "wgrad_route",
    "wgrad_call_plan", "WgradPlan", "WGRAD_ROUTES",
    "dense_bwd", "dense_bwd_plain",
    "sgd_accum", "sgd_accum_plain",
    "sgd_accum_many", "sgd_accum_many_plain",
    "fedavg_accum", "fedavg_accum_plain",
    "fedavg_accum_many", "fedavg_accum_many_plain",
    "patches_matmul", "conv2_matmul", "dense_matmul",
    "launches", "reset_launches",
]

#: kernel launches per wrapper since the last reset_launches()
launches: dict[str, int] = {
    "stream_gemm": 0, "stream_wgrad": 0, "dense_bwd": 0,
    "stream_gemm_f32": 0, "stream_wgrad_f32": 0, "dense_bwd_f32": 0,
    "sgd_accum": 0, "sgd_accum_bf16": 0,  # all K4; those with bf16 p
    "sgd_accum_acc": 0,
    "fedavg_accum": 0,
    # K6, ops/fused_train.py: f32 state, and bf16 state or inputs
    "fused_mlp_train_epoch": 0, "fused_mlp_train_epoch_bf16": 0,
}


def _key(name: str, t: torch.Tensor) -> str:
    """The launch-count key of a K1-K3 instantiation: the bf16 one keeps
    the kernel's name, the f32 one adds ``_f32``."""
    return name + "_f32" if t.dtype == torch.float32 else name


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _on_cpu(*ts: torch.Tensor) -> bool:
    """True when every operand lies on the CPU (the plain version's
    only use); False when all lie on a CUDA device. Anything else
    raises: the kernels run on CUDA tensors and nowhere else."""
    if all(t.is_cpu for t in ts):
        return True
    if all(t.is_cuda for t in ts):
        return False
    kinds = sorted({t.device.type for t in ts})
    raise ValueError(f"operands must all be on CPU or all on CUDA: {kinds}")


# ---------------------------------------------------------------------------
# K1 stream_gemm: [n, M, K] @ [n, K, N]
# ---------------------------------------------------------------------------


def stream_gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [n,M,K] @ w [n,K,N]``: f32 products and sums, one cast to
    x's dtype."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def stream_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K1 (``csrc/stream_gemm.cu``; f32: ``csrc/gemm_f32_tc.cu``):
    ``[n,M,K] @ [n,K,N]`` in x's dtype, bf16 or f32."""
    if _on_cpu(x, w):
        return stream_gemm_plain(x, w)
    out = _build.kernels().stream_gemm(x, w)
    launches[_key("stream_gemm", x)] += 1
    return out


#: K1's branches, in the order of the binding's branch codes
#: (``csrc/kernels.h``, ``GemmBranch``): bf16 "narrow_tma" (K <= 32,
#: N <= 64: bulk-copied row runs, mma.sync, tiles stored by 2-D TMA at
#: N = 32 and 64), "narrow_staged" (the same with a staged copy-out),
#: "wide" (TMA + wgmma, N = 64), "tiles" (guarded tiles, any other
#: width); float32 "f32_ffma" (K <= 32, exact FFMA) and "f32_tc"
#: (3xTF32 on wgmma)
STREAM_GEMM_BRANCHES = ("narrow_tma", "narrow_staged", "wide", "tiles",
                        "f32_ffma", "f32_tc")


def stream_gemm_branch() -> str:
    """The branch K1's launcher took at its last launch on the card (one
    of :data:`STREAM_GEMM_BRANCHES`), as the launcher decided it."""
    return STREAM_GEMM_BRANCHES[_build.kernels().stream_gemm_last_branch()]


# ---------------------------------------------------------------------------
# K2 stream_wgrad: [n, M, K]^T @ [n, M, N] -> [n, K, N] f32
# ---------------------------------------------------------------------------


def stream_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``x [n,M,K]^T @ g [n,M,N] -> [n,K,N]`` in f32."""
    return torch.matmul(x.float().transpose(1, 2), g.float())


#: K2's routes, in the order of the binding's route codes
#: (``csrc/kernels.h``; a new route is appended): bf16 "general"
#: (cp.async + mma.sync, any width), "wide" (TMA + wgmma, K and N
#: multiples of 8) and "narrow" (K <= 32 and N <= 64 a multiple of 8: a
#: slice's whole output a work item, x's rows by 1-D bulk copy and g's by
#: TMA, mma.sync); float32 "f32_tc" (3xTF32 on wgmma) and "f32_narrow"
#: (exact FFMA over cp.async row spans), the second at K <= 32 and
#: wherever M <= WGRAD_F32_TC_MIN_M - 1: 3xTF32 drops up to about 3 x
#: 2**-22 of each product (lo.lo, and what lo leaves of each operand), an
#: error that only a sum of several rows averages under the f32 limits
WGRAD_ROUTES = ("general", "wide", "f32_tc", "f32_narrow", "narrow")
WGRAD_F32_TC_MIN_M = 33
#: rows a route's slice is a multiple of: the general route's stage, the
#: wide route's and f32_tc's box (the rows one accumulator takes before
#: its sum is added to the total to nearest), f32_narrow's cp.async
#: chunk, the narrow route's stage
WGRAD_ROUTE_ROWS = {"general": 256, "wide": 64, "f32_tc": 32,
                    "f32_narrow": 64, "narrow": 128}
#: work items (blocks, or (tile, slice) items of a persistent grid) the
#: slice plan aims for on each route, and the fewest rows it gives a
#: slice where M allows: constants, never the card's SM count, so the
#: plan and the sums' order are the same on every card. The f32 routes
#: run persistent grids, whose last round is full only when the items
#: are many; f32_narrow's slices may be shorter, its partials being 800
#: to 1,728 floats a slice. The narrow route's persistent grid (one block
#: an SM) takes 128 items: every further item a block costs its
#: reduction and, in the slice sum, one more slice, more than the
#: balance it buys (conv1 and the stem on the card, ``PERF.md``)
WGRAD_TARGET_BLOCKS = {"wide": 512, "general": 256, "f32_tc": 2048,
                       "f32_narrow": 4096, "narrow": 128}
WGRAD_MIN_SLICE_ROWS = 1024
WGRAD_NARROW_MIN_SLICE_ROWS = 512


class WgradPlan(NamedTuple):
    """How K2 cuts one call: ``route`` (one of :data:`WGRAD_ROUTES`);
    ``tiles`` output tiles a slice (general and wide: blocks; narrow: 1,
    the whole output; f32_tc: 128 x 64 tiles; f32_narrow: 32 x 64
    tiles); ``rows`` rows a
    slice (a multiple of the route's ``WGRAD_ROUTE_ROWS``); ``slices``
    slices a node, whose f32 sums a second kernel adds in slice order
    when there are two or more."""
    route: str
    tiles: int
    rows: int
    slices: int


def wgrad_route(M: int, K: int, N: int, f32: bool = False) -> str:
    """The route K2 takes at this shape: bf16 "narrow" when K <= 32 and N
    <= 64 is a multiple of 8, else "wide" when K and N are multiples of
    8, else "general"; float32 "f32_tc" when K >= 33 and M >=
    ``WGRAD_F32_TC_MIN_M``, else "f32_narrow"."""
    if f32:
        tc = K > 32 and M >= WGRAD_F32_TC_MIN_M
        return "f32_tc" if tc else "f32_narrow"
    if K <= 32 and N <= 64 and N % 8 == 0:
        return "narrow"
    return "wide" if K % 8 == 0 and N % 8 == 0 else "general"


@functools.cache
def wgrad_plan(n: int, M: int, K: int, N: int,
               route: str | None = None) -> WgradPlan:
    """K2's slice plan, a function of the shape (and the route) only:
    about ``WGRAD_TARGET_BLOCKS[route]`` work items over ``n`` nodes,
    and no slice shorter than ``WGRAD_MIN_SLICE_ROWS`` rows
    (f32_narrow: ``WGRAD_NARROW_MIN_SLICE_ROWS``) where ``M`` allows.
    ``route`` defaults to the bf16 shape's (:func:`wgrad_route`)."""
    if route is None:
        route = wgrad_route(M, K, N)
    if route == "wide":
        tiles = -(-K // 256) * -(-N // 64)
    elif route == "general":
        tiles = -(-K // 32) * -(-N // 32)
    elif route == "f32_tc":
        tiles = -(-K // 128) * -(-N // 64)
    elif route == "f32_narrow":
        tiles = -(-K // 32) * -(-N // 64)
    elif route == "narrow":
        tiles = 1
    else:
        raise ValueError(f"unknown K2 route {route!r}")
    unit = WGRAD_ROUTE_ROWS[route]
    least = (WGRAD_NARROW_MIN_SLICE_ROWS if route == "f32_narrow"
             else WGRAD_MIN_SLICE_ROWS)
    M = max(M, 1)
    want = -(-WGRAD_TARGET_BLOCKS[route] // max(n * tiles, 1))
    slices = max(1, min(want, -(-M // least)))
    rows = -(-(-(-M // slices)) // unit) * unit
    return WgradPlan(route, tiles, rows, -(-M // rows))


def wgrad_call_plan(x: torch.Tensor, g: torch.Tensor) -> WgradPlan:
    """The plan :func:`stream_wgrad` takes for these operands: the
    shape's (:func:`wgrad_route`), or "general" where a TMA map cannot
    start at an operand's base (16 bytes): x's or g's on the wide route,
    g's on the narrow one (x's rows there go by 1-D bulk copies whose
    unaligned edges are copied by hand, as in K1's narrow branch; g's
    node bases are 16-byte multiples at any M, N being one of 8)."""
    n, M, K = x.shape
    N = g.shape[-1]
    plan = wgrad_plan(n, M, K, N,
                      wgrad_route(M, K, N, x.dtype == torch.float32))
    if (plan.route == "wide" and (x.data_ptr() % 16 or g.data_ptr() % 16)
            or plan.route == "narrow" and g.data_ptr() % 16):
        plan = wgrad_plan(n, M, K, N, "general")
    return plan


def stream_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K2 (bf16: ``csrc/stream_wgrad.cu``; f32: ``csrc/gemm_f32_tc.cu``):
    slices of rows summed per block or work item in a fixed order, then
    in slice order (:func:`wgrad_plan`, :func:`wgrad_call_plan`)."""
    if _on_cpu(x, g):
        return stream_wgrad_plain(x, g)
    plan = wgrad_call_plan(x, g)
    out = _build.kernels().stream_wgrad(
        x, g, WGRAD_ROUTES.index(plan.route), plan.rows, plan.slices)
    launches[_key("stream_wgrad", x)] += 1
    return out


# ---------------------------------------------------------------------------
# K3 dense_bwd: dx = g @ w^T, dw = x^T @ g
# ---------------------------------------------------------------------------


def dense_bwd_plain(x: torch.Tensor, w: torch.Tensor,
                    g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Backward of ``y = x @ w`` for x ``[n,B,D]``, w ``[n,D,H]``, g
    ``[n,B,H]``: ``(dx, dw)`` in x's and w's dtypes, f32 sums."""
    gf = g.float()
    dx = torch.matmul(gf, w.float().transpose(1, 2)).to(x.dtype)
    dw = torch.matmul(x.float().transpose(1, 2), gf).to(w.dtype)
    return dx, dw


def dense_bwd(x: torch.Tensor, w: torch.Tensor,
              g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 (``csrc/dense_bwd.cu``; f32: ``csrc/gemm_f32_tc.cu``): dx and
    dw from one launch."""
    if _on_cpu(x, w, g):
        return dense_bwd_plain(x, w, g)
    dx, dw = _build.kernels().dense_bwd(x, w, g)
    launches[_key("dense_bwd", x)] += 1
    return dx, dw


# ---------------------------------------------------------------------------
# K4 sgd_accum: one SGD-with-momentum step over a stacked leaf
# K5 sgd_accum(acc=, weight=) / fedavg_accum: plus acc + w[slot] * p
# ---------------------------------------------------------------------------


@functools.cache
def _decay(momentum: float, trace_dtype: torch.dtype) -> float:
    # optax multiplies the trace by the momentum in the trace's dtype
    return float(torch.tensor(momentum, dtype=trace_dtype))


def _per_slot(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def sgd_accum_plain(p: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
                    lr: torch.Tensor, *, momentum: float,
                    acc: torch.Tensor | None = None,
                    weight: torch.Tensor | None = None):
    """``optax.sgd`` term by term over a leaf with a leading slot axis:
    ``m' = g + round_to(m.dtype, decay * m)`` in f32 (the Pallas kernel
    evaluates in f32 and rounds only the decayed trace and its outputs);
    ``p' = p + m' * -lr`` with ``lr [n]`` (learning rate x update gate),
    rounded to p's dtype; stored ``m'`` cast to the trace dtype. Returns ``(p', m')``; with ``acc`` (f32, p's shape) and
    ``weight [n]`` f32 also ``acc' = acc + weight[slot] * f32(p')``."""
    if (acc is None) != (weight is None):
        raise ValueError("acc and weight go together")
    decay = torch.tensor(_decay(momentum, m.dtype), dtype=torch.float32,
                         device=m.device)
    dec = (decay * m.float()).to(m.dtype).float()
    m_new = g.float() + dec
    p_new = (p + m_new * _per_slot(-lr, p)).to(p.dtype)
    if acc is None:
        return p_new, m_new.to(m.dtype)
    acc_new = acc + _per_slot(weight, p) * p_new.float()
    return p_new, m_new.to(m.dtype), acc_new


def sgd_accum_many_plain(ps: list, ms: list, gs: list, lr: torch.Tensor, *,
                         momentum: float, accs: list | None = None,
                         weight: torch.Tensor | None = None):
    """:func:`sgd_accum_plain` leaf by leaf over lists of leaves that
    share ``lr`` (and ``weight``): lists ``(ps', ms')``, with ``accs``
    and ``weight`` also ``accs'``."""
    _check_step_lists(ps, ms, gs, accs, weight)
    if accs is None:
        out = [sgd_accum_plain(p, m, g, lr, momentum=momentum)
               for p, m, g in zip(ps, ms, gs)]
    else:
        out = [sgd_accum_plain(p, m, g, lr, momentum=momentum, acc=a,
                               weight=weight)
               for p, m, g, a in zip(ps, ms, gs, accs)]
    width = 2 if accs is None else 3
    return tuple([o[k] for o in out] for k in range(width))


def sgd_accum_many(ps: list, ms: list, gs: list, lr: torch.Tensor, *,
                   momentum: float, accs: list | None = None,
                   weight: torch.Tensor | None = None):
    """K4 (``csrc/sgd.cu``): the step of :func:`sgd_accum_many_plain`
    over every leaf in one launch (one per 48 leaves). Each leaf is a
    parameter stacked over the slots of ``lr [n]`` f32; p and g f32 or
    bf16, the trace f32 or bf16, one dtype combination a list. With
    ``accs`` and ``weight [n]``, K5 (``csrc/sgd_accum.cu``): the step
    and the accumulate in one pass. At lr 0 (update gate 0) p comes
    back bit-exact. New tensors are returned, nothing is updated in
    place; on the card each kind of output is one allocation that the
    leaves' outputs view."""
    _check_step_lists(ps, ms, gs, accs, weight)
    if not ps or ps[0].is_cpu:
        extra = () if accs is None else (*accs, weight)
        _on_cpu(*ps, *ms, *gs, lr, *extra)  # raises for a mix
        return sgd_accum_many_plain(ps, ms, gs, lr, momentum=momentum,
                                    accs=accs, weight=weight)
    # the binding checks that every operand lies on p's CUDA device
    decay = _decay(momentum, ms[0].dtype)
    if accs is None:
        p_new, m_new, _, n = _build.kernels().sgd(ps, ms, gs, lr, decay)
        launches["sgd_accum"] += n
        if ps[0].dtype == torch.bfloat16:
            launches["sgd_accum_bf16"] += n
        return p_new, m_new
    p_new, m_new, acc_new, n = _build.kernels().sgd_accum(
        ps, ms, gs, lr, accs, weight, decay)
    launches["sgd_accum_acc"] += n
    return p_new, m_new, acc_new


def sgd_accum(p: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
              lr: torch.Tensor, *, momentum: float,
              acc: torch.Tensor | None = None,
              weight: torch.Tensor | None = None):
    """K4 (``csrc/sgd.cu``) over one leaf: :func:`sgd_accum_plain`'s
    step, the one-leaf case of :func:`sgd_accum_many`. With ``acc`` and
    ``weight``, K5 (``csrc/sgd_accum.cu``): the step and the accumulate
    in one pass. At lr 0 (update gate 0) p comes back bit-exact."""
    out = sgd_accum_many([p], [m], [g], lr, momentum=momentum,
                         accs=None if acc is None else [acc], weight=weight)
    return tuple(leaves[0] for leaves in out)


def fedavg_accum_plain(p: torch.Tensor, acc: torch.Tensor,
                       weight: torch.Tensor) -> torch.Tensor:
    """``acc + weight[slot] * f32(p)``: the JAX package's null
    ``sgd_accum`` step (g = 0, momentum 0, lr 0), whose optimizer half
    passes p through unchanged."""
    return acc + _per_slot(weight, p) * p.float()


def fedavg_accum_many_plain(ps: list, accs: list,
                            weight: torch.Tensor) -> list:
    """:func:`fedavg_accum_plain` leaf by leaf."""
    _same_lengths(ps, accs)
    return [fedavg_accum_plain(p, a, weight) for p, a in zip(ps, accs)]


def fedavg_accum_many(ps: list, accs: list, weight: torch.Tensor) -> list:
    """K5's null form (``csrc/sgd_accum.cu``): ``acc' = acc +
    weight[slot] * f32(p)`` for every leaf in one launch (one per 48
    leaves); p f32 or bf16 (one dtype a list), acc f32 of p's shape,
    weight ``[n]`` f32. Returns the new accumulators."""
    _same_lengths(ps, accs)
    if not ps or ps[0].is_cpu:
        _on_cpu(*ps, *accs, weight)  # raises for a mix
        return fedavg_accum_many_plain(ps, accs, weight)
    _, _, acc_new, n = _build.kernels().fedavg_accum(ps, accs, weight)
    launches["fedavg_accum"] += n
    return acc_new


def fedavg_accum(p: torch.Tensor, acc: torch.Tensor,
                 weight: torch.Tensor) -> torch.Tensor:
    """K5's null form over one leaf, the one-leaf case of
    :func:`fedavg_accum_many`: ``acc' = acc + weight[slot] * f32(p)``;
    p f32 or bf16, acc f32 of p's shape, weight ``[n]`` f32."""
    return fedavg_accum_many([p], [acc], weight)[0]


def _same_lengths(*lists) -> None:
    lengths = [len(x) for x in lists]
    if len(set(lengths)) != 1:
        raise ValueError(f"leaf lists of unequal lengths {lengths}")


def _check_step_lists(ps, ms, gs, accs, weight) -> None:
    if (accs is None) != (weight is None):
        raise ValueError("acc and weight go together")
    _same_lengths(ps, ms, gs, *(() if accs is None else (accs,)))


# ---------------------------------------------------------------------------
# autograd around the kernels
# ---------------------------------------------------------------------------


class _PatchesMatmul(torch.autograd.Function):
    """conv1: forward K1, dx K1 on ``w^T``, dw K2."""

    @staticmethod
    def forward(ctx, x, w):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        return stream_gemm(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        # never true for conv1, whose patches come from the image —
        # JAX's dead-code elimination of the same dgrad
        if ctx.needs_input_grad[0]:
            dx = stream_gemm(g, w.transpose(1, 2).contiguous()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = stream_wgrad(x, g).to(w.dtype)
        return dx, dw


class _Conv2Matmul(torch.autograd.Function):
    """conv2: forward K1, dw K2, dx a plain f32-accumulated matmul (the
    JAX package leaves conv2's dgrad to XLA)."""

    @staticmethod
    def forward(ctx, x, w):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        return stream_gemm(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(g.float(), w.float().transpose(1, 2)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = stream_wgrad(x, g).to(w.dtype)
        return dx, dw


class _DenseMatmul(torch.autograd.Function):
    """dense1: plain forward, fused K3 backward."""

    @staticmethod
    def forward(ctx, x, w):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        return torch.matmul(x.float(), w.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = dense_bwd(x, w, g.to(x.dtype).contiguous())
        return dx, dw


def patches_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [n,M,K] @ w [n,K,N]`` with kernel forward, dgrad and wgrad."""
    _check_3d(x, w)
    return _PatchesMatmul.apply(x, w)


def conv2_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [n,M,K] @ w [n,K,N]``: kernel forward and wgrad, plain dgrad."""
    _check_3d(x, w)
    return _Conv2Matmul.apply(x, w)


def dense_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [n,B,D] @ w [n,D,H]``: plain forward, kernel backward."""
    _check_3d(x, w)
    return _DenseMatmul.apply(x, w)


def _check_3d(x, w):
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(
            f"[n, rows, k] @ [n, k, cols] operands required, got "
            f"{tuple(x.shape)} @ {tuple(w.shape)}")
