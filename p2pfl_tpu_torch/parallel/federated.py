"""The federated rounds over the node axis, on one device.

The counterpart of ``p2pfl_tpu/parallel/federated.py`` for the dense
round (FedAvg, the robust aggregators, attack injection, DP
privatization and trust observations; the host's staleness scale; the
staged, one-round-stale exchange) and the cross-device round (``build_round_fn_cross_device``,
``build_cross_device_stream_fns``, below). The dense round: every node
trains its local epochs (one ``train_epochs`` call over the stacked
``[n, ...]`` state); with FedAvg each node's aggregate is then row
``i`` of ``W @ params`` with ``W`` the row-normalised product of
the round plan's mixing matrix, the sample counts and the alive and
training masks — one ``[n, n] @ [n, d]`` matmul per leaf, a plain
PyTorch op as it was an XLA dot. Round plans are the JAX package's:
DFL mixes over adjacency plus self loops and adopts its own row;
CFL/SDFL mix everything at the leader and adopt the leader's row.

The mix runs in f32 with TF32 off: callers on CUDA keep
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default,
which ``Scenario`` sets explicitly). With ``exchange_dtype=bf16`` the
weights and parameters are rounded to bf16 and the products summed in
f32, as the JAX package's ``preferred_element_type=f32`` dot does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from p2pfl_tpu_torch.adversary.attacks import AttackSpec, poison_stacked
from p2pfl_tpu_torch.adversary.reputation import spmd_trust_obs
from p2pfl_tpu_torch.core.aggregators import Aggregator, FedAvg
from p2pfl_tpu_torch.core.pytree import (
    Params,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from p2pfl_tpu_torch.learning.learner import StepFns, TrainState
from p2pfl_tpu_torch.ops import gemm
from p2pfl_tpu_torch.privacy.dp import DPSpec, privatize_stacked
from p2pfl_tpu_torch.topology.topology import Topology


@dataclasses.dataclass
class FederatedState:
    """Whole-federation state: every tensor has a leading ``[n]`` axis.

    ``stale`` is the double buffer of ``exchange_overlap="staged"``: the
    previous round's post-fit params stack and its contribution weights
    ``[n]`` f32 (what this round ships to the neighbours); ``None``
    wherever the mode is off. ``rng_slot`` is the checkpoint's ``[n, 2]``
    uint32 rng words that ``states.rng`` was last seeded from
    (``federation/checkpoint.py``), or ``None``."""

    states: TrainState
    alive: torch.Tensor  # [n] bool
    round: int = 0
    stale: tuple | None = None  # (params stack, weights [n]) | None
    rng_slot: np.ndarray | None = None


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """Host-computed per-round schedule (see the JAX package)."""

    mix: np.ndarray  # [n, n] f32
    adopt: np.ndarray  # [n] int32
    trains: np.ndarray  # [n] bool


def make_round_plan(topology: Topology, roles: list[str],
                    federation: str = "DFL", leader: int = 0) -> RoundPlan:
    n = topology.n
    trains = np.array([r in ("trainer", "aggregator", "server") for r in roles])
    if federation == "DFL":
        mix = topology.adjacency.astype(np.float32) + np.eye(n, dtype=np.float32)
        adopt = np.arange(n, dtype=np.int32)
    elif federation in ("CFL", "SDFL"):
        mix = np.zeros((n, n), np.float32)
        mix[leader] = 1.0  # leader aggregates everyone (incl. itself)
        adopt = np.full((n,), leader, np.int32)
    else:
        raise ValueError(f"unknown federation {federation!r}")
    return RoundPlan(mix=mix, adopt=adopt.astype(np.int32), trains=trains)


def staleness_scale(staleness, beta: float) -> np.ndarray:
    """The staleness discount ``1 / (1 + s)^beta`` in f32 on the host
    (the JAX package's formula, bit for bit): ``staleness`` in rounds
    behind, negative values clamp to fresh, ``beta=0`` is the identity.
    The stacked plane applies it as a column scale on the mixing
    matrix."""
    s = np.maximum(np.asarray(staleness, np.float32), 0.0)
    if beta == 0.0:
        return np.ones_like(s)
    return (1.0 / np.power(1.0 + s, np.float32(beta))).astype(np.float32)


def _where_node(cond: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    return torch.where(cond.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


def _train_and_select(fns: StepFns, states: TrainState, alive, trains,
                      x, y, smask, epochs: int):
    """Local epochs on every node with the update gate ``trains &
    alive``: gated-off nodes keep their params bit-exact (the gate rides
    into the SGD step); their step count is kept explicitly."""
    sel = torch.logical_and(trains, alive)
    new_states, metrics = fns.train_epochs(states, x, y, smask, epochs,
                                           sel.float())
    new_states = dataclasses.replace(
        new_states, step=torch.where(sel, new_states.step, states.step))
    return new_states, metrics


def init_federation(fns: StepFns, sample_x: torch.Tensor, n_nodes: int,
                    seed: int = 0,
                    device: torch.device | str = "cpu") -> FederatedState:
    """Stacked init: every node starts from one draw (the reference's
    initial-model diffusion). Parameters are drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed``, so every device gets the
    same numbers; the shuffle stream is a generator on ``device``."""
    one = fns.init(torch.Generator().manual_seed(seed), sample_x.cpu())
    params = tree_map(lambda p: p.to(device).unsqueeze(0).repeat(
        (n_nodes,) + (1,) * p.dim()), one)
    rng = torch.Generator(device=device).manual_seed(seed + 1)
    states = TrainState(
        params=params,
        opt_state=fns.init_opt_state(params),
        rng=rng,
        step=torch.zeros(n_nodes, dtype=torch.int64, device=device),
    )
    return FederatedState(
        states=states,
        alive=torch.ones(n_nodes, dtype=torch.bool, device=device),
    )


def reseed_params(fed: FederatedState, fns: StepFns,
                  params: Params) -> FederatedState:
    """Restart a federation from ONE parameter tree: every node adopts
    ``params`` with a fresh (zero) optimizer state; rng, step, alive and
    round are kept."""
    n = fed.alive.shape[0]
    dev = fed.alive.device
    stack = tree_map(
        lambda p: p.to(dev).unsqueeze(0).repeat((n,) + (1,) * p.dim()),
        params)
    states = dataclasses.replace(fed.states, params=stack,
                                 opt_state=fns.init_opt_state(stack))
    return dataclasses.replace(fed, states=states)


def with_staged_buffer(fed: FederatedState) -> FederatedState:
    """Seed the staged exchange's double buffer: a copy of the current
    params at zero contribution weight, so the first staged round mixes
    nothing from the neighbours and is pure local training."""
    return dataclasses.replace(fed, stale=(
        tree_map(torch.clone, fed.states.params),
        torch.zeros(fed.alive.shape[0], dtype=torch.float32,
                    device=fed.alive.device)))


def build_round_fn(
    fns: StepFns,
    aggregator: Aggregator | None = None,
    epochs: int = 1,
    exchange_dtype: torch.dtype | None = None,
    shared_aggregate: bool = False,
    identity_adopt: bool = False,
    attack: AttackSpec | None = None,
    malicious: np.ndarray | None = None,
    update_stats: bool = False,
    exchange_overlap: str = "off",
    dp: DPSpec | None = None,
    dp_mask: np.ndarray | None = None,
) -> Callable:
    """Build ``round_fn(fed, x, y, mask, n_samples, mix, adopt, trains)
    -> (fed, metrics)``.

    FedAvg takes the fast path: per leaf, row ``i`` of ``W @ params``.
    ``exchange_dtype`` (bf16) rounds the weights and the parameters
    entering the mix; the sums stay f32. ``identity_adopt=True`` is the
    caller's promise that every plan adopts its own row (DFL): the adopt
    gather is skipped.

    A robust aggregator (Krum, FedMedian, TrimmedMean) aggregates the
    stack at the exchange dtype, weighted by the sample counts, over the
    rows each mixing row lets in (``row_w > 0``): once per row, or, with
    ``shared_aggregate=True`` (every aggregating row identical: fully
    connected DFL, CFL, SDFL), once over the union of the rows and
    handed to every node.

    ``attack`` and ``malicious`` (a host ``[n]`` bool mask) poison the
    malicious rows' trained params against their round-start params
    before any mix, their own row included (``poison_stacked``, keyed by
    ``fed.round``). ``update_stats=True`` adds ``metrics["trust_obs"]``:
    each node's score of its post-attack delta over the contributing
    cohort, for the host's ``ReputationMonitor``.

    ``dp`` and ``dp_mask`` (a host ``[n]`` bool mask) privatize the
    masked rows' updates after any poisoning and before any mix:
    ``privatize_stacked`` against the round-start params, keyed by
    ``fed.round``, on the FedAvg and the robust path alike, so the clip
    also bounds what a malicious row injects.

    ``exchange_overlap="staged"`` mixes one round stale: the
    off-diagonal terms read the previous round's post-fit params
    (``fed.stale``, seeded by :func:`with_staged_buffer`) at their then
    weights, the diagonal this round's fit; the new buffer is this
    round's post-DP fit and weights. ``wn_off @ stale`` is taken in the
    exchange dtype with f32 sums, plus ``diag(wn) * fresh`` in f32 with
    the fresh params rounded to the exchange dtype. FedAvg only, with no
    attack and no trust scoring (both are defined on what a node ships
    this round), as in the JAX package.
    """
    aggregator = aggregator or FedAvg()
    fedavg_fast = type(aggregator) is FedAvg
    attack_active = (attack is not None and malicious is not None
                     and bool(np.any(malicious)) and attack.poisons_updates)
    dp_active = (dp is not None and dp_mask is not None
                 and bool(np.any(dp_mask)))
    if exchange_overlap not in ("off", "staged"):
        raise ValueError(f"unknown exchange_overlap {exchange_overlap!r}; "
                         "have ('off', 'staged')")
    staged = exchange_overlap == "staged"
    if staged and not fedavg_fast:
        raise ValueError(
            "exchange_overlap='staged' requires the FedAvg fast path — "
            "robust aggregators score THIS round's updates")
    if staged and (attack_active or update_stats):
        raise ValueError(
            "exchange_overlap='staged' composes with neither attack "
            "injection nor trust scoring: both are defined on the fresh "
            "update a node ships this round")

    def wire(t: torch.Tensor) -> torch.Tensor:
        """``t`` rounded to the exchange dtype, as f32."""
        return t.float() if exchange_dtype is None else t.to(
            exchange_dtype).float()

    def mixed(wn: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        flat = p.reshape(p.shape[0], -1)
        out = torch.matmul(wire(wn), wire(flat))  # [n,n]@[n,d], f32
        return out.reshape(p.shape).to(p.dtype)

    def mixed_staged(wn_off: torch.Tensor, wn_diag: torch.Tensor,
                     p: torch.Tensor, ps: torch.Tensor) -> torch.Tensor:
        out = torch.matmul(wire(wn_off), wire(ps.reshape(ps.shape[0], -1)))
        out = out + wn_diag[:, None] * wire(p.reshape(p.shape[0], -1))
        return out.reshape(p.shape).to(p.dtype)

    def robust(params: Params, w: torch.Tensor,
               n_samples: torch.Tensor) -> Params:
        """Per-row (or shared) robust aggregates, in params' dtypes."""
        stack_ex = params if exchange_dtype is None else tree_map(
            lambda p: p.to(exchange_dtype), params)
        counts = n_samples.float()
        if shared_aggregate:
            out = aggregator.aggregate(stack_ex, counts,
                                       mask=w.amax(0) > 0)
            return tree_map(lambda o, p: o.to(p.dtype)[None].expand(p.shape),
                            out, params)
        rows = [aggregator.aggregate(stack_ex, counts, mask=row_w > 0)
                for row_w in w]
        return tree_map(
            lambda p, *os: torch.stack([o.to(p.dtype) for o in os]),
            params, *rows)

    def round_fn(fed: FederatedState, x, y, smask, n_samples, mix, adopt,
                 trains):
        alive = fed.alive
        ref_params = fed.states.params  # round-start params (delta ref)
        states, train_metrics = _train_and_select(
            fns, fed.states, alive, trains, x, y, smask, epochs)
        if attack_active:
            states = dataclasses.replace(states, params=poison_stacked(
                states.params, ref_params, malicious, fed.round, attack))
        if dp_active:
            states = dataclasses.replace(states, params=privatize_stacked(
                states.params, ref_params, dp_mask, fed.round, dp))
        contrib = torch.logical_and(trains, alive)
        w_fresh = n_samples.float() * contrib.float()
        new_stale = fed.stale
        if staged:
            # off-diagonal terms weigh the previous round's fit at its
            # then weights (zero after with_staged_buffer, or for a node
            # dead last round); only the diagonal reads this round's fit
            stale_params, stale_w = fed.stale
            eye = torch.eye(alive.shape[0], dtype=torch.float32,
                            device=alive.device)
            w = mix * ((1.0 - eye) * stale_w[None, :]
                       + eye * w_fresh[None, :])
            new_stale = (states.params, w_fresh)
        else:
            w = mix * w_fresh[None, :]
        got_any = w.sum(1) > 0
        if fedavg_fast:
            wn = w / w.sum(1, keepdim=True).clamp(min=1e-9)
            if staged:
                wn_off, wn_diag = wn * (1.0 - eye), torch.diagonal(wn)
            keep = torch.logical_and(
                alive, got_any if identity_adopt else got_any[adopt])

            def leaf(p, ps=None):
                a = (mixed(wn, p) if ps is None
                     else mixed_staged(wn_off, wn_diag, p, ps))
                return _where_node(keep, a if identity_adopt else a[adopt],
                                   p)

            params = (tree_map(leaf, states.params, stale_params) if staged
                      else tree_map(leaf, states.params))
        else:
            agg = robust(states.params, w, n_samples)
            if identity_adopt:
                keep = torch.logical_and(alive, got_any)
            else:
                if not shared_aggregate:  # shared rows are identical
                    agg = tree_map(lambda a: a[adopt], agg)
                keep = torch.logical_and(alive, got_any[adopt])
            params = tree_map(lambda a, p: _where_node(keep, a, p), agg,
                              states.params)
        metrics = {"train_loss": train_metrics["loss"], "alive": alive}
        if update_stats:
            # scored on the post-attack params: what each node sent
            metrics["trust_obs"] = spmd_trust_obs(states.params, ref_params,
                                                  contrib)
        fed = FederatedState(
            states=dataclasses.replace(states, params=params),
            alive=alive,
            round=fed.round + 1,
            stale=new_stale,
        )
        return fed, metrics

    return round_fn


# ---------------------------------------------------------------------------
# the cross-device round: a scan over sampled cohorts through n_slots slots
# ---------------------------------------------------------------------------


def cross_device_wn(c_sizes: torch.Tensor, c_alive: torch.Tensor):
    """FedAvg weights normalized over all ``C x n_slots`` sampled clients
    (``[C, n_slots]`` f32), and the flag that any client carries weight.
    Every arm (materialized, chunked, streamed) takes its weights from
    here, so their aggregates cannot drift apart."""
    w = c_sizes.float() * c_alive.float()
    total = w.sum()
    return w / total.clamp(min=1e-9), total > 0


def _cross_device_plan(params0: Params, fused_accumulate: bool) -> Params:
    """Per leaf: True sends the per-step accumulate through K5
    (``gemm.fedavg_accum_many``, per-slot f32 accumulators). Under the
    fused layout that is every leaf with a per-slot axis (ndim >= 2) — on
    the card always, as the JAX package's route with
    ``P2PFL_PALLAS_GEMM=on``; a per-slot scalar takes the row product. The unfused layout is the
    reference product and never takes K5."""
    return tree_map(lambda p: fused_accumulate and p.dim() >= 2, params0)


def _cross_device_acc0(params0: Params, fused_accumulate: bool,
                       plan: Params) -> Params:
    """Zero f32 accumulators in the layout each route wants: K5 leaves
    one per slot (p's shape), row-product leaves one ``[1, d]`` row, the
    unfused reference the full ``[n_slots, d]``."""

    def leaf0(p, use_k5):
        if use_k5:
            return torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device)
        rows = 1 if fused_accumulate else p.shape[0]
        return torch.zeros((rows, p[0].numel()), dtype=torch.float32,
                           device=p.device)

    return tree_map(leaf0, params0, plan)


def _cross_device_body(fns: StepFns, epochs: int,
                       mix_dtype: torch.dtype | None,
                       fused_accumulate: bool, params0: Params,
                       plan: Params) -> Callable:
    """One cohort step: train the cohort from the round-start
    ``params0`` (the carried optimizer state, generator and step), then
    fold its weighted parameters into the accumulators. The materialized,
    chunked and streamed arms all run this function."""

    def cast(p):
        return p if mix_dtype is None else p.to(mix_dtype)

    k5 = tree_leaves(plan)  # per leaf, in tree_leaves order: K5 or not
    k5_idx = [i for i, use_k5 in enumerate(k5) if use_k5]

    def body(carry, x_t, y_t, m_t, alive_t, wn_t):
        opt_state, rng, step, acc = carry
        n_slots = alive_t.shape[0]
        states_t = TrainState(params=params0, opt_state=opt_state, rng=rng,
                              step=step)
        trains = torch.ones(n_slots, dtype=torch.bool, device=alive_t.device)
        states_t, tm = _train_and_select(fns, states_t, alive_t, trains,
                                         x_t, y_t, m_t, epochs)
        # the weight operand of the row products, rounded to the wire
        # dtype as the JAX package's [n, n] weight matrix is
        w_row = cast(wn_t).float()

        def row_acc(a, p):
            flat = cast(p.reshape(n_slots, -1)).float()
            if fused_accumulate:
                return a + torch.matmul(w_row[None, :], flat)  # [1,n]@[n,d]
            w_t = w_row[None, :].expand(n_slots, n_slots)
            return a + torch.matmul(w_t, flat)  # [n,n]@[n,d], f32

        ps, accs = tree_leaves(states_t.params), tree_leaves(acc)
        new = [a if use_k5 else row_acc(a, p)
               for a, p, use_k5 in zip(accs, ps, k5)]
        if k5_idx:
            # acc[s] += wn[s] * p[s] for every K5 leaf in one launch (the
            # weights stay f32)
            for i, a in zip(k5_idx, gemm.fedavg_accum_many(
                    [cast(ps[i]) for i in k5_idx],
                    [accs[i] for i in k5_idx], wn_t)):
                new[i] = a
        acc = tree_unflatten(acc, new)
        carry = (states_t.opt_state, states_t.rng, states_t.step, acc)
        return carry, tm["loss"]

    return body


def _slot_sum(a: torch.Tensor) -> torch.Tensor:
    """``a[0] + a[1] + ...`` in slot order: the same bits on every
    device (a reduction kernel's order is its own)."""
    total = a[0]
    for s in range(1, a.shape[0]):
        total = total + a[s]
    return total


def _cross_device_leaf_out(keep: torch.Tensor, fused_accumulate: bool):
    """Round end, per leaf: collapse the accumulator to the ``[n_slots,
    ...]`` parameter stack, keeping the round-start params where the
    round was empty or the slot dead."""

    def leaf_out(a, p, use_k5):
        if use_k5:
            # the slot sum is the sum over all C x n_slots clients: the
            # weights were normalized globally up front
            out = _slot_sum(a).to(p.dtype).expand(p.shape)
        elif fused_accumulate:
            out = a.reshape(p.shape[1:]).to(p.dtype).expand(p.shape)
        else:
            out = a.reshape(p.shape).to(p.dtype)
        return _where_node(keep, out, p)

    return leaf_out


def _ordered_chunk_sum(parts: list) -> Any:
    """Sum per-chunk accumulator trees chunk 0 first."""
    total = parts[0]
    for part in parts[1:]:
        total = tree_map(lambda a, b: a + b, total, part)
    return total


def _clone_generator(g: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=g.device)
    out.set_state(g.get_state())
    return out


def _finish_round(fed: FederatedState, params0: Params, carry, got_any,
                  fused_accumulate: bool) -> FederatedState:
    opt_state, rng, step, acc = carry
    plan = _cross_device_plan(params0, fused_accumulate)
    # an empty round (every sampled client dead) keeps the global model
    keep = torch.logical_and(fed.alive, got_any)
    params = tree_map(_cross_device_leaf_out(keep, fused_accumulate), acc,
                      params0, plan)
    return FederatedState(
        states=TrainState(params=params, opt_state=opt_state, rng=rng,
                          step=step),
        alive=fed.alive,
        round=fed.round + 1,
    )


def build_round_fn_cross_device(
    fns: StepFns,
    epochs: int = 1,
    exchange_dtype: torch.dtype | None = None,
    fused_accumulate: bool = True,
    cohort_shards: int = 1,
) -> Callable:
    """The cross-device round: ``round_fn(fed, cx, cy, cmask, c_sizes,
    c_alive) -> (fed, metrics)`` over cohort-stacked data ``cx [C,
    n_slots, S, ...]``, ``cy/cmask [C, n_slots, S]``, ``c_sizes/c_alive
    [C, n_slots]``. ``fed`` holds the global model on every slot.

    Each of the C cohort steps trains its cohort from the round-start
    params; the optimizer state, the shuffle generator and the step
    count carry from step to step and persist into the next round. The
    FedAvg aggregate sums all ``C x n_slots`` clients against the
    globally normalized weights ``wn = w / max(sum(w), 1e-9)``:

    - ``fused_accumulate=True``: per leaf and step, K5's null form
      ``acc[s] += wn[s] * p[s]`` into per-slot f32 accumulators, summed
      over slots in slot order at round end. This re-associates the
      reference's contraction (slots, then steps), so it agrees with it
      to f32 rounding, not bit for bit.
    - ``fused_accumulate=False``: the reference, ``acc += W_t @ flat_t``
      with ``W_t`` the step's weights on every row, one f32 matmul.

    A sampled-but-dead client trains nothing (update gate 0: its params
    stay ``params0``, its momentum decays, its step is kept) and
    carries zero weight. ``exchange_dtype`` (bf16) rounds each slot's
    params entering the accumulate.

    ``cohort_shards = D > 1`` splits the C steps into D contiguous
    chunks, each run from the same round-start carry (a copy of the
    generator's state included); the final optimizer state, generator
    and step are the last chunk's, and the chunks' accumulators are
    summed chunk 0 first. The chunks run one after another on the one
    device (the JAX package's single-device arm); sharding them over
    several cards is ROADMAP item A24.
    """
    if cohort_shards < 1:
        raise ValueError(f"cohort_shards must be >= 1, got {cohort_shards}")

    def round_fn(fed: FederatedState, cx, cy, cmask, c_sizes, c_alive):
        params0 = fed.states.params
        wn, got_any = cross_device_wn(c_sizes, c_alive)
        plan = _cross_device_plan(params0, fused_accumulate)
        body = _cross_device_body(fns, epochs, exchange_dtype,
                                  fused_accumulate, params0, plan)
        n_cohorts = cx.shape[0]
        if n_cohorts % cohort_shards:
            raise ValueError(
                f"cohort_size {n_cohorts} not divisible by "
                f"cohort_shards {cohort_shards}")
        per = n_cohorts // cohort_shards
        opt0, rng0, step0 = (fed.states.opt_state, fed.states.rng,
                             fed.states.step)
        carries, losses = [], []
        for chunk in range(cohort_shards):
            rng = rng0 if cohort_shards == 1 else _clone_generator(rng0)
            carry = (opt0, rng, step0,
                     _cross_device_acc0(params0, fused_accumulate, plan))
            for t in range(chunk * per, (chunk + 1) * per):
                carry, loss = body(carry, cx[t], cy[t], cmask[t],
                                   c_alive[t], wn[t])
                losses.append(loss)
            carries.append(carry)
        acc = _ordered_chunk_sum([c[3] for c in carries])
        final = carries[-1][:3] + (acc,)
        fed = _finish_round(fed, params0, final, got_any, fused_accumulate)
        return fed, {"train_loss": torch.stack(losses), "alive": fed.alive}

    return round_fn


def build_cross_device_stream_fns(
    fns: StepFns,
    epochs: int = 1,
    exchange_dtype: torch.dtype | None = None,
    fused_accumulate: bool = True,
) -> tuple[Callable, Callable, Callable]:
    """The cross-device round unrolled for streamed client data:
    ``(init_carry, step, finalize)``, so the host can fill cohort t+1
    while the device trains cohort t.

    ``step(params0, carry, x_t, y_t, m_t, alive_t, wn_t) -> (carry,
    loss)`` is one step of the same body the materialized round runs,
    with ``wn_t`` a row of :func:`cross_device_wn` over the whole round,
    so a streamed round equals ``build_round_fn_cross_device`` at
    ``cohort_shards=1`` bit for bit. ``finalize(fed, carry, got_any)``
    runs the round-end epilogue and advances the round counter.
    """

    def init_carry(fed: FederatedState):
        params0 = fed.states.params
        plan = _cross_device_plan(params0, fused_accumulate)
        return (fed.states.opt_state, fed.states.rng, fed.states.step,
                _cross_device_acc0(params0, fused_accumulate, plan))

    def step(params0, carry, x_t, y_t, m_t, alive_t, wn_t):
        plan = _cross_device_plan(params0, fused_accumulate)
        body = _cross_device_body(fns, epochs, exchange_dtype,
                                  fused_accumulate, params0, plan)
        return body(carry, x_t, y_t, m_t, alive_t, wn_t)

    def finalize(fed: FederatedState, carry, got_any):
        return _finish_round(fed, fed.states.params, carry, got_any,
                             fused_accumulate)

    return init_carry, step, finalize


def build_eval_fn(fns: StepFns) -> Callable:
    """Evaluate every node's model on the shared test set: per-node
    ``{loss: [n], accuracy: [n]}``."""

    def eval_fn(fed: FederatedState, x_test, y_test):
        mask = torch.ones(x_test.shape[0], dtype=torch.bool,
                          device=x_test.device)
        return fns.evaluate(fed.states.params, x_test, y_test, mask)

    return eval_fn
