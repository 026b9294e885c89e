"""Adapter-only federation (LoRA): the counterpart of
``p2pfl_tpu/learning/lora.py``. The unit of federation becomes the
adapter tree instead of the full parameter tree.

:class:`LoraModel` has the surface ``make_step_fns`` uses: ``init
(generator, sample_x)`` returns one node's adapter tree ``{site:
{"A", "B"}}`` and ``forward(adapters, x)`` takes a stacked one, so the
train state, the optimizer state (K4's leaves under SGD), the mix, the
robust aggregators, the wire cast, the staged buffer and checkpoints
all hold adapters and nothing else. The frozen base is one node's tree
held once on the device for every node, with no gradient and no
optimizer state. Per target kernel ``W`` the effective weight is

    ``W_eff = W + (alpha / rank) * A @ B``

with ``A ~ N(0, 1/d_in)`` and ``B = 0``, so the merged model equals the
base bit for bit at adapter init (``W + 0.0 == W``).

A target kernel is viewed as ``lead`` axes + ``[d_in]`` axes + ``[d_out]``
axes; ``lead`` (the scanned ViT's depth axis) broadcasts, one A/B pair a
layer in one batched product. The per-target ``(out_axes, base_ndim)``
split is model metadata registered beside the model
(``models.base.register_lora_targets``); anything unregistered takes the
plain 2-D view ``(..., d_in, d_out)``. Adapters carry the stacked
trees' node axis in front of ``lead``.

The port draws A from a ``torch.Generator`` (one normal draw a site, in
site order), where the JAX package draws from
``jax.random.fold_in(key, i)``: the values differ, so a parity test
carries the adapters across with ``convert.params_from_jax``
(``ROADMAP.md``, stated departures).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from p2pfl_tpu_torch.core.pytree import Params
from p2pfl_tpu_torch.models.base import default_lora_targets, lora_axis_specs

# the combined-tree keys ``split_adapters``/``merge_adapters`` pivot on
BASE_KEY = "base"
ADAPTERS_KEY = "adapters"

# joins a tree path into the flat adapter-tree key; "/" cannot appear
# in flax module or parameter names
_SEP = "/"


@dataclasses.dataclass(frozen=True)
class AdapterSite:
    """One target kernel: where it lives and its factorization view."""

    key: str  # _SEP-joined path, the adapter tree's dict key
    shape: tuple[int, ...]  # one node's full kernel shape
    lead: tuple[int, ...]  # broadcast axes (scan depth, ...)
    d_in: int
    d_out: int


def _flatten(tree: Params, path: tuple[str, ...] = ()):
    """``(path, leaf)`` pairs in sorted key order (the JAX package's
    ``tree_flatten_with_path`` order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (str(k),))
    else:
        yield path, tree


def find_adapter_sites(
    params: Params, targets: tuple[str, ...],
    specs: dict[str, tuple[int, int]] | None = None,
) -> tuple[AdapterSite, ...]:
    """Resolve target patterns against one node's param tree.

    A leaf qualifies when its last key is ``"kernel"`` and any key on
    its path contains a target pattern as a substring. Every pattern
    must match a kernel: a typo'd target adapting nothing would report
    a fine-tune that never ran, so this raises naming the tree's
    kernels."""
    if not targets:
        raise ValueError("lora targets must not be empty")
    specs = specs or {}
    sites: list[AdapterSite] = []
    matched: set[str] = set()
    kernels: list[str] = []
    for keys, leaf in _flatten(params):
        if not keys or keys[-1] != "kernel":
            continue
        key = _SEP.join(keys)
        kernels.append(key)
        hits = [t for t in targets if any(t in k for k in keys[:-1])]
        if not hits:
            continue
        matched.update(hits)
        out_axes, base_ndim = specs.get(hits[0], (1, 2))
        shape = tuple(leaf.shape)
        n_lead = len(shape) - base_ndim
        if n_lead < 0 or out_axes >= base_ndim:
            raise ValueError(
                f"lora target {hits[0]!r} spec (out_axes={out_axes}, "
                f"base_ndim={base_ndim}) does not fit kernel {key} "
                f"of shape {shape}")
        sites.append(AdapterSite(
            key=key, shape=shape, lead=shape[:n_lead],
            d_in=math.prod(shape[n_lead:len(shape) - out_axes]),
            d_out=math.prod(shape[len(shape) - out_axes:])))
    missing = [t for t in targets if t not in matched]
    if missing:
        raise ValueError(
            f"lora targets {missing} match no kernel; tree has {kernels}")
    return tuple(sites)


def init_adapters(sites: tuple[AdapterSite, ...], rank: int,
                  generator: torch.Generator) -> dict:
    """Fresh A/B leaves per site (one node, f32, on the CPU): ``A ~
    N(0, 1/d_in)``, ``B = 0``, the zero B that makes the merged model
    the base bit for bit."""
    if rank < 1:
        raise ValueError(f"lora rank must be >= 1, got {rank}")
    adapters: dict[str, dict[str, torch.Tensor]] = {}
    for site in sites:
        a = torch.randn(site.lead + (site.d_in, rank), generator=generator)
        adapters[site.key] = {
            "A": a * (1.0 / math.sqrt(site.d_in)),
            "B": torch.zeros(site.lead + (rank, site.d_out))}
    return adapters


def adapter_deltas(adapters: dict, sites: tuple[AdapterSite, ...],
                   rank: int, alpha: float | None) -> dict:
    """``(alpha / rank) * A @ B`` per site in f32, reshaped to the
    kernel's shape; adapters with a leading node axis give deltas with
    it (``[n, *shape]``)."""
    scale = (alpha if alpha is not None else float(rank)) / float(rank)
    out = {}
    for site in sites:
        ab = adapters[site.key]
        delta = torch.matmul(ab["A"], ab["B"]) * scale
        extra = delta.shape[:delta.dim() - len(site.lead) - 2]
        out[site.key] = delta.reshape(tuple(extra) + site.shape)
    return out


def split_adapters(tree: dict) -> tuple[Any, dict]:
    """``{"base": ..., "adapters": ...} -> (base, adapters)``: the
    structural split of one lora tree, the inverse of
    :func:`merge_adapters`."""
    try:
        return tree[BASE_KEY], tree[ADAPTERS_KEY]
    except (KeyError, TypeError) as e:
        raise ValueError(
            f"not a lora tree: expected dict with {BASE_KEY!r}/"
            f"{ADAPTERS_KEY!r} keys, got {type(tree).__name__}") from e


def merge_adapters(base: Any, adapters: dict) -> dict:
    """``(base, adapters) -> {"base": ..., "adapters": ...}``, the
    inverse of :func:`split_adapters` (no materialization: see
    :meth:`LoraModel.materialize`)."""
    return {BASE_KEY: base, ADAPTERS_KEY: adapters}


def lora_init(params: Params, rank: int, targets: tuple[str, ...], *,
              alpha: float | None = None,
              generator: torch.Generator | None = None,
              specs: dict[str, tuple[int, int]] | None = None) -> dict:
    """The frozen-base and adapter split of one node's param tree: one
    combined tree ``{"base": params, "adapters": {site: {A, B}}}``
    (take it apart with :func:`split_adapters`). ``alpha`` is kept for
    the JAX signature; it scales at materialization, not here."""
    del alpha
    sites = find_adapter_sites(params, tuple(targets), specs)
    generator = generator or torch.Generator().manual_seed(0)
    return merge_adapters(params, init_adapters(sites, rank, generator))


def _map_with_path(fn, tree: Params, path: tuple[str, ...] = ()) -> Params:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


class LoraModel(nn.Module):
    """Adapter-only view of a model of ``p2pfl_tpu_torch.models``.

    ``base`` is one node's tree (no node axis), held on its device once
    for all nodes; ``init`` returns one node's adapter tree and
    ``forward(adapters, x)`` takes a stacked one ``[n, ...]`` and runs
    the inner model on :meth:`materialize`'s weights."""

    def __init__(self, model: nn.Module, base: Params, rank: int,
                 targets: tuple[str, ...], alpha: float | None = None,
                 specs: dict[str, tuple[int, int]] | None = None):
        super().__init__()
        self.inner = model
        self.rank = int(rank)
        self.alpha = alpha
        self.targets = tuple(targets)
        self.base = _map_with_path(lambda _, t: t.detach(), base)
        self.sites = find_adapter_sites(self.base, self.targets, specs)
        if self.rank < 1:
            raise ValueError(f"lora rank must be >= 1, got {rank}")

    # -- the make_step_fns surface --------------------------------------
    def init(self, generator: torch.Generator, sample_x) -> dict:
        del sample_x  # the base fixes every shape
        return init_adapters(self.sites, self.rank, generator)

    def forward(self, adapters: dict, x: torch.Tensor) -> torch.Tensor:
        return self.inner(self.materialize(adapters), x)

    # -- the merge -------------------------------------------------------
    def materialize(self, adapters: dict) -> Params:
        """Every node's effective weights: ``base + (alpha/rank) * A @
        B`` (the delta cast to the kernel's dtype) at each site, ``[n,
        *shape]``; every other leaf is the base's own tensor expanded
        over the ``n`` nodes of ``adapters`` (a view, no copy)."""
        deltas = adapter_deltas(adapters, self.sites, self.rank,
                                self.alpha)
        n = next(iter(deltas.values())).shape[0]

        def leaf(path, w):
            d = deltas.get(_SEP.join(path))
            if d is None:
                return w.expand((n,) + tuple(w.shape))
            return w + d.to(w.dtype)

        return _map_with_path(leaf, self.base)

    def adapter_param_count(self) -> int:
        return sum(math.prod(s.lead) * self.rank * (s.d_in + s.d_out)
                   for s in self.sites)


def base_params_for(model: nn.Module, seed: int, sample_x) -> Params:
    """The frozen base every run derives from its config: the model's
    init from ``torch.Generator().manual_seed(seed)`` on ``sample_x``,
    the draw ``init_federation`` makes for the full-weight federation,
    so a lora federation's merged round-0 model equals the full-weight
    federation's round-0 model bit for bit. Depends only on the
    sample's shape, not its values."""
    return model.init(torch.Generator().manual_seed(seed),
                      torch.as_tensor(sample_x).cpu())


def wrap_model(model: nn.Module, model_name: str, rank: int, *,
               targets: tuple[str, ...] = (), alpha: float | None = None,
               base: Params | None = None, seed: int = 0, sample_x=None,
               device: torch.device | str = "cpu") -> LoraModel:
    """A :class:`LoraModel` from the registry's metadata: empty
    ``targets`` take the model's registered defaults, the axis specs
    come from the same registry, and a missing ``base`` is derived by
    :func:`base_params_for`; the base is moved to ``device``."""
    targets = tuple(targets) or default_lora_targets(model_name)
    specs = lora_axis_specs(model_name)
    if base is None:
        if sample_x is None:
            raise ValueError("wrap_model needs base= or sample_x=")
        base = base_params_for(model, seed, sample_x)
    base = _map_with_path(lambda _, t: t.to(device), base)
    return LoraModel(model, base, rank=rank, targets=targets, alpha=alpha,
                     specs=specs)


def maybe_wrap_lora(model: nn.Module, cfg, sample_x, *,
                    base: Params | None = None,
                    device: torch.device | str = "cpu"):
    """The scenario's seam: ``model`` unchanged when ``cfg.lora`` is
    off, else the :class:`LoraModel` the federation trains through,
    over ``base`` if given (one node's tree) or the base derived from
    ``(cfg.model, cfg.seed)``."""
    if not cfg.lora.active:
        return model
    return wrap_model(model, cfg.model.model, cfg.lora.rank,
                      targets=tuple(cfg.lora.targets), alpha=cfg.lora.alpha,
                      base=base, seed=cfg.seed, sample_x=sample_x,
                      device=device)
