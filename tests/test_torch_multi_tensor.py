"""K4 and K5 over lists of leaves on the CPU: ``sgd_accum_many`` and
``fedavg_accum_many`` (their plain versions here) against the JAX
package's Pallas kernels in interpret mode, against the port's per-leaf
versions, and wired into the learner step and the cross-device cohort
step.

Inputs are drawn with numpy from a seed: the narrow FEMNIST CNN's leaves
(channels 4 and 8, hidden 16, 62 classes) plus leaves of 10 and 1
values a slot, at 2 slots against JAX (which runs slot by slot, as its
``vmap`` does) and 3 nodes for the steps.

Tolerances. Against JAX: XLA:CPU contracts each multiply-add of the
interpreted kernel into an FMA, where the port rounds the product first.
For one multiply-add the two sides then differ by at most half an f32
ulp of the product (the rounding the FMA skips) plus one ulp, in the
output's dtype, of the result (each side rounds its own sum, half an ulp
each), plus the allowance of the operand it carries from the step before
(``p'`` carries ``lr`` times ``m'``'s, ``acc'`` carries ``w`` times
``p'``'s). ``test_torch_sgd_accum.py`` allows one ulp of the largest
term instead, which a few elements of these larger leaves exceed (by up
to 15%): there the two sides' roundings of the sum and the product's
skipped rounding add up to more than one ulp. At lr 0 the params come back
bit for bit on both sides. Against the port's per-leaf versions, and for
the learner and cohort steps against the per-leaf path they replace: the
same bits.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from p2pfl_tpu.ops import pallas_gemm
from p2pfl_tpu_torch.core.pytree import tree_leaves, tree_map, tree_unflatten
from p2pfl_tpu_torch.learning.learner import TrainState, make_step_fns
from p2pfl_tpu_torch.learning.objectives import get_objective
from p2pfl_tpu_torch.models.cnn import SmallCNN
from p2pfl_tpu_torch.ops import gemm
from p2pfl_tpu_torch.parallel import federated

_LEAVES = [(5, 5, 1, 4), (4,), (5, 5, 4, 8), (8,), (392, 16), (16,),
           (16, 62), (62,), (10,), (1,)]
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}
_LR = np.array([0.1, 0.0], np.float32)  # slot 1 gated off
_W = np.array([0.3, 0.7], np.float32)
_CNN = dict(channels=(4, 8), kernel=5, hidden=16, num_classes=62)


def _draw(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pairs(seed, dt, n=2):
    """Per leaf: the JAX array and the torch tensor of one draw."""
    jd, td = _DT[dt]
    out = []
    for i, s in enumerate(_LEAVES):
        a = _draw(seed * 100 + i, (n,) + s)
        out.append((jnp.asarray(a, jd), torch.from_numpy(a).to(td)))
    return out


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _ulp(dt, *terms):
    """One ulp, in dtype ``dt``, of the largest of ``terms``."""
    big = np.max(np.abs(np.stack([np.asarray(t, np.float32)
                                  for t in terms])), axis=0)
    f32 = np.spacing(big.astype(np.float32))
    return f32 * 2.0 ** 16 if dt == "bf16" else f32


def _fma_tol(dt, got, want, product, carried=0.0):
    """The bound above: one ulp in ``dt`` of the result on either side,
    half an f32 ulp of the product, and the carried allowance."""
    return _ulp(dt, _np(got), _np(want)) + 0.5 * _ulp("f32", product) + (
        carried)


def _within(got, want, tol):
    d = np.abs(_np(got) - _np(want))
    assert np.all(d <= tol), float((d - tol).max())


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("trace", ["f32", "bf16"])
@pytest.mark.parametrize("pdt", ["f32", "bf16"])
def test_sgd_accum_many_plain_matches_pallas(pdt, trace, with_acc):
    p, m, g = _pairs(1, pdt), _pairs(2, trace), _pairs(3, pdt)
    a = _pairs(4, "f32")
    lr, w = torch.from_numpy(_LR), torch.from_numpy(_W)
    kw = dict(accs=[t for _, t in a], weight=w) if with_acc else {}
    got = gemm.sgd_accum_many_plain([t for _, t in p], [t for _, t in m],
                                    [t for _, t in g], lr, momentum=0.9,
                                    **kw)
    assert len(got) == (3 if with_acc else 2)
    decay = float(jnp.asarray(0.9, _DT[trace][0]))
    for leaf in range(len(_LEAVES)):
        (pj, pt), (mj, mt), (gj, _) = p[leaf], m[leaf], g[leaf]
        assert got[0][leaf].dtype == pt.dtype
        assert got[1][leaf].dtype == mt.dtype
        for i in range(2):
            akw = (dict(acc=a[leaf][0][i], weight=jnp.float32(_W[i]))
                   if with_acc else {})
            want = pallas_gemm.sgd_accum(
                pj[i], mj[i], gj[i], jnp.float32(_LR[i]), momentum=0.9,
                block_m=16, interpret=True, **akw)
            tol_m = _fma_tol(trace, got[1][leaf][i], want[1],
                             decay * _np(mj[i]))
            _within(got[1][leaf][i], want[1], tol_m)
            tol_p = _fma_tol(pdt, got[0][leaf][i], want[0],
                             _np(want[1]) * _LR[i], _LR[i] * tol_m)
            _within(got[0][leaf][i], want[0], tol_p)
            if with_acc:
                tol_a = _fma_tol("f32", got[2][leaf][i], want[2],
                                 _W[i] * _np(want[0]), _W[i] * tol_p)
                _within(got[2][leaf][i], want[2], tol_a)
        # lr 0: the params bit for bit, on both sides
        assert torch.equal(got[0][leaf][1], pt[1])
        assert np.array_equal(_np(want[0]), _np(pt[1]))


@pytest.mark.parametrize("pdt", ["f32", "bf16"])
def test_fedavg_accum_many_plain_matches_pallas(pdt):
    p, a = _pairs(5, pdt), _pairs(6, "f32")
    got = gemm.fedavg_accum_many_plain([t for _, t in p], [t for _, t in a],
                                       torch.from_numpy(_W))
    for leaf, ((pj, _), (aj, at)) in enumerate(zip(p, a)):
        assert got[leaf].dtype == torch.float32
        assert got[leaf].shape == at.shape
        for i in range(2):
            want = pallas_gemm.fedavg_accum(pj[i], aj[i], jnp.float32(_W[i]),
                                            block_m=16, interpret=True)
            _within(got[leaf][i], want,
                    _fma_tol("f32", got[leaf][i], want, _W[i] * _np(pj[i])))


@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("trace", ["f32", "bf16"])
def test_many_wrappers_equal_the_per_leaf_wrappers(trace, with_acc):
    """On CPU tensors the list wrappers take the plain versions: the same
    bits as the one-leaf wrappers leaf by leaf, and no launch."""
    p = [t for _, t in _pairs(7, "f32", n=3)]
    m = [t for _, t in _pairs(8, trace, n=3)]
    g = [t for _, t in _pairs(9, "f32", n=3)]
    a = [t for _, t in _pairs(10, "f32", n=3)]
    lr = torch.tensor([0.05, 0.0, 0.1])
    w = torch.tensor([0.2, 0.3, 0.5])
    gemm.reset_launches()
    if with_acc:
        got = gemm.sgd_accum_many(p, m, g, lr, momentum=0.9, accs=a,
                                  weight=w)
        want = [gemm.sgd_accum(*x, lr, momentum=0.9, acc=y, weight=w)
                for x, y in zip(zip(p, m, g), a)]
    else:
        got = gemm.sgd_accum_many(p, m, g, lr, momentum=0.9)
        want = [gemm.sgd_accum(*x, lr, momentum=0.9) for x in zip(p, m, g)]
    for k, out in enumerate(got):
        _same(out, [o[k] for o in want])
    _same(gemm.fedavg_accum_many(p, a, w),
          [gemm.fedavg_accum(x, y, w) for x, y in zip(p, a)])
    assert all(v == 0 for v in gemm.launches.values())


# ---------------------------------------------------------------------------
# the learner step and the cross-device cohort step
# ---------------------------------------------------------------------------


def _state(model, n, momentum_dtype):
    trees = [model.init(torch.Generator().manual_seed(s),
                        torch.zeros(1, 28, 28, 1)) for s in range(n)]
    params = tree_map(lambda *leaves: torch.stack(leaves), *trees)
    tdt = torch.bfloat16 if momentum_dtype == "bf16" else torch.float32
    # a non-zero trace, so the decayed momentum takes part
    opt = tree_map(lambda p: (0.01 * torch.from_numpy(
        _draw(p.numel(), tuple(p.shape)))).to(tdt), params)
    return TrainState(params=params, opt_state=opt,
                      rng=torch.Generator().manual_seed(7),
                      step=torch.zeros(n, dtype=torch.int64))


def _batch(n, rows, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((n, rows, 28, 28, 1), np.float32))
    y = torch.from_numpy(rng.integers(0, 62, (n, rows)).astype(np.int64))
    return x, y, torch.ones(n, rows)


def _per_leaf_step(model, state, bx, by, bm, gate, lr, momentum, wd):
    """The learner step as it ran before the list wrappers: the same
    gradient, then one ``gemm.sgd_accum`` a leaf."""
    loss_fn = get_objective("classification")
    leaves = [p.detach().requires_grad_(True)
              for p in tree_leaves(state.params)]
    with torch.enable_grad():
        loss = loss_fn(model(tree_unflatten(state.params, leaves), bx), by,
                       bm)
        grads = torch.autograd.grad(loss.sum(), leaves)
    grads = tree_unflatten(state.params, list(grads))
    if wd:
        grads = tree_map(lambda g, p: g + wd * p, grads, state.params)
    n = bx.shape[0]
    lrv = torch.full((n,), lr, dtype=torch.float32)
    if gate is not None:
        on = gate > 0
        grads = tree_map(lambda g: torch.where(
            on.reshape((-1,) + (1,) * (g.dim() - 1)), g,
            torch.zeros_like(g)), grads)
        lrv = lrv * gate
    out = tree_map(lambda p, m, g: gemm.sgd_accum(p, m, g, lrv,
                                                  momentum=momentum),
                   state.params, state.opt_state, grads)
    return (tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out),
            loss.detach())


@pytest.mark.parametrize("gate", [None, [1.0, 0.0, 1.0]])
@pytest.mark.parametrize("momentum_dtype", [None, "bf16"])
def test_learner_step_is_one_list_call_and_the_per_leaf_bits(
        momentum_dtype, gate, monkeypatch):
    model = SmallCNN(**_CNN)
    fns = make_step_fns(model, learning_rate=0.05, momentum=0.9,
                        weight_decay=1e-3, momentum_dtype=momentum_dtype,
                        batch_size=4)
    state = _state(model, 3, momentum_dtype)
    bx, by, bm = _batch(3, 4, 11)
    gate_t = None if gate is None else torch.tensor(gate)
    calls = []
    many = gemm.sgd_accum_many
    monkeypatch.setattr(gemm, "sgd_accum_many",
                        lambda *a, **k: calls.append(1) or many(*a, **k))
    new, loss = fns.train_step(state, bx, by, bm, gate_t)
    assert len(calls) == 1
    want_p, want_m, want_loss = _per_leaf_step(model, state, bx, by, bm,
                                               gate_t, 0.05, 0.9, 1e-3)
    _same(tree_leaves(new.params), tree_leaves(want_p))
    _same(tree_leaves(new.opt_state), tree_leaves(want_m))
    assert torch.equal(loss, want_loss)
    if gate is not None:  # the gated-off node keeps its params
        for p0, p1 in zip(tree_leaves(state.params),
                          tree_leaves(new.params)):
            assert torch.equal(p1[1], p0[1])


def _per_leaf_body(fns, epochs, mix_dtype, fused, params0, plan):
    """The cohort step as it ran before the list wrappers: one
    ``gemm.fedavg_accum`` a K5 leaf."""

    def cast(p):
        return p if mix_dtype is None else p.to(mix_dtype)

    def body(carry, x_t, y_t, m_t, alive_t, wn_t):
        opt_state, rng, step, acc = carry
        n_slots = alive_t.shape[0]
        states_t = TrainState(params=params0, opt_state=opt_state, rng=rng,
                              step=step)
        trains = torch.ones(n_slots, dtype=torch.bool)
        states_t, _ = federated._train_and_select(
            fns, states_t, alive_t, trains, x_t, y_t, m_t, epochs)
        w_row = cast(wn_t).float()

        def leaf_acc(a, p, use_k5):
            if use_k5:
                return gemm.fedavg_accum(cast(p), a, wn_t)
            flat = cast(p.reshape(n_slots, -1)).float()
            if fused:
                return a + torch.matmul(w_row[None, :], flat)
            w_t = w_row[None, :].expand(n_slots, n_slots)
            return a + torch.matmul(w_t, flat)

        acc = tree_map(leaf_acc, acc, states_t.params, plan)
        return (states_t.opt_state, states_t.rng, states_t.step, acc)

    return body


@pytest.mark.parametrize("mix_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("fused", [True, False])
def test_cohort_step_is_one_list_call_and_the_per_leaf_bits(
        fused, mix_dtype, monkeypatch):
    model = SmallCNN(**_CNN)
    fns = make_step_fns(model, learning_rate=0.05, momentum=0.9,
                        batch_size=4)
    state = _state(model, 3, None)
    params0 = state.params
    plan = federated._cross_device_plan(params0, fused)
    x, y, mask = _batch(3, 4, 12)
    alive = torch.tensor([True, False, True])
    wn = torch.tensor([0.25, 0.0, 0.5])

    def carry():
        return (state.opt_state, torch.Generator().manual_seed(5),
                state.step, federated._cross_device_acc0(params0, fused,
                                                         plan))

    calls = []
    many = gemm.fedavg_accum_many
    monkeypatch.setattr(gemm, "fedavg_accum_many",
                        lambda *a, **k: calls.append(len(a[0]))
                        or many(*a, **k))
    new, _ = federated._cross_device_body(fns, 1, mix_dtype, fused,
                                          params0, plan)(
        carry(), x, y, mask, alive, wn)
    # every leaf has a slot axis: all go through one K5 call when fused
    assert calls == ([len(tree_leaves(params0))] if fused else [])
    want = _per_leaf_body(fns, 1, mix_dtype, fused, params0, plan)(
        carry(), x, y, mask, alive, wn)
    _same(tree_leaves(new[3]), tree_leaves(want[3]))
    _same(tree_leaves(new[0]), tree_leaves(want[0]))
    assert torch.equal(new[2], want[2])


# ---------------------------------------------------------------------------
# refusals and empty lists
# ---------------------------------------------------------------------------


def test_many_wrappers_refuse_bad_lists():
    p = torch.zeros(2, 3)
    lr, w = torch.ones(2), torch.ones(2)
    with pytest.raises(ValueError, match="unequal lengths"):
        gemm.sgd_accum_many([p, p], [p], [p, p], lr, momentum=0.9)
    with pytest.raises(ValueError, match="unequal lengths"):
        gemm.sgd_accum_many([p], [p], [p], lr, momentum=0.9, accs=[p, p],
                            weight=w)
    with pytest.raises(ValueError, match="unequal lengths"):
        gemm.fedavg_accum_many([p, p], [p], w)
    with pytest.raises(ValueError, match="go together"):
        gemm.sgd_accum_many([p], [p], [p], lr, momentum=0.9, accs=[p])
    with pytest.raises(ValueError, match="go together"):
        gemm.sgd_accum_many([p], [p], [p], lr, momentum=0.9, weight=w)
    meta = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        gemm.sgd_accum_many([p], [meta], [p], lr, momentum=0.9)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        gemm.fedavg_accum_many([p], [p], torch.ones(2, device="meta"))
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        gemm.sgd_accum_many([p], [p], [p], lr, momentum=0.9, accs=[meta],
                            weight=w)


def test_many_wrappers_take_empty_lists_and_leaves():
    lr, w = torch.ones(2), torch.ones(2)
    assert gemm.sgd_accum_many([], [], [], lr, momentum=0.9) == ([], [])
    assert gemm.sgd_accum_many([], [], [], lr, momentum=0.9, accs=[],
                               weight=w) == ([], [], [])
    assert gemm.fedavg_accum_many([], [], w) == []
    e = torch.zeros(2, 0, 3)
    p_new, m_new = gemm.sgd_accum_many([e], [e], [e], lr, momentum=0.9)
    assert p_new[0].shape == m_new[0].shape == e.shape
    assert gemm.fedavg_accum_many([e], [e], w)[0].shape == e.shape
