"""The private and elastic federation as a whole: the port's scenarios
against the JAX package's on one scenario JSON, from the JAX package's
initial weights, in the f32 tier of ``test_torch_federation.py`` (f32
compute and f32 wire, one batch an epoch, so the JAX package's threefry
permutation only reorders rows inside the one batch).

Every round: the alive mask, the leader and the event sequences (the
scenario's and the membership's, without the wall times) equal; train
losses within rtol 1e-5; parameters within relative L2 1e-5 per leaf.
A dead node's parameters keep their bits on both sides for as long as
it is dead. The scenarios (mnist-mlp, 784-256-128-10, 4 nodes, 18
samples a node):

- DFL ring, node 2 crashes at round 1 and joins at round 2 under the
  default 4 s / 20 s heartbeat clock (the JAX package's
  ``tests/test_elastic.py`` SPMD config, async staleness on with half
  the nodes 3x stragglers): the crashed node is never timed out, and the
  join copies the leader's row into its row;
- DFL ring, node 3 crashes at round 1 and joins at round 3 under a
  4 s / 3 s clock: dead in rounds 1 and 2;
- CFL star, the server crashes at round 0: the leader fails over to
  node 1;
- SDFL, node 1 dead from round 0: it is never drawn as leader;
- DP at noise 0 with a binding clip (0.05), fully connected (XLA fuses
  the privatized update's multiply-add, eager PyTorch rounds twice: a
  few ulps a round, inside the tolerance);
- ``CrossDeviceScenario`` with client faults (64 clients, 16 a round in
  4 cohorts; 20 clients crash at round 0, 10 of them join at round 2):
  the sampled clients and their alive mask equal every round, train
  losses and parameters within the f32 cross-device tolerance
  (rtol 1e-5 / atol 1e-6).

And the port alone: a heavily noised DP scenario (the JAX package's
``tests/test_privacy.py`` config: 8 nodes, clip 0.5, noise 2.0) ends
below the clean one.
"""

from __future__ import annotations

import json

import numpy as np
import torch

import jax

from p2pfl_tpu.config import schema as jschema
from p2pfl_tpu.federation.scenario import CrossDeviceScenario as JCross
from p2pfl_tpu.federation.scenario import Scenario as JScenario
from p2pfl_tpu_torch.config.schema import ScenarioConfig
from p2pfl_tpu_torch.convert import params_from_jax, params_to_numpy
from p2pfl_tpu_torch.federation import CrossDeviceScenario, Events, Scenario
from p2pfl_tpu_torch.parallel.federated import reseed_params

N = 4
F32_RTOL = 1e-5
CROSS_TOL = dict(rtol=1e-5, atol=1e-6)
FAST_CLOCK = dict(heartbeat_period_s=4.0, node_timeout_s=3.0)


def _jax_cfg(**kw) -> jschema.ScenarioConfig:
    base = dict(
        name="elastic-parity", n_nodes=N, topology="ring",
        data=jschema.DataConfig(dataset="mnist", samples_per_node=20,
                                batch_size=18, synthetic_train=2000,
                                synthetic_test=128),
        model=jschema.ModelConfig(model="mlp", compute_dtype="float32"),
        training=jschema.TrainingConfig(rounds=4, epochs_per_round=1,
                                        learning_rate=0.05, eval_every=1),
        transport="dense", wire_dtype="f32")
    base.update(kw)
    return jschema.ScenarioConfig(**base)


def _port_cfg(jcfg) -> ScenarioConfig:
    return ScenarioConfig.from_dict(json.loads(jcfg.to_json()))


def _recorder(obs) -> list:
    events = []

    def rec(ev, payload):
        payload = {k: v for k, v in (payload or {}).items()
                   if k != "time_s"}
        events.append((ev.value, json.dumps(payload, sort_keys=True,
                                            default=int)))

    obs.add_observer(rec)
    return events


def _leaves(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(k.key for k in path)] = np.asarray(leaf, np.float32)
    return out


def _port_leaves(params) -> dict:
    out = {}

    def walk(t, pre):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, pre + (k,))
        else:
            out[pre] = t
    walk(params_to_numpy(params), ())
    return out


def _run_pair(jcfg, rounds: int | None = None):
    """Both scenarios round by round; yields (round, JAX scenario, port
    scenario, the port's history record) after each round, having
    checked alive, leader, events, losses and params."""
    js = JScenario(jcfg)
    ts = Scenario(_port_cfg(jcfg), device="cpu")
    recs = [(_recorder(js), _recorder(ts)),
            (_recorder(js.membership), _recorder(ts.membership))]
    p0 = jax.tree.map(lambda a: np.asarray(a)[0], js.fed.states.params)
    ts.fed = reseed_params(ts.fed, ts.fns, params_from_jax(p0))
    dead_since: dict[int, dict] = {}
    for r in range(rounds or jcfg.training.rounds):
        jres, tres = js.run(rounds=1), ts.run(rounds=1)
        rec = tres.history[0]
        alive = np.asarray(js.fed.alive)
        assert rec["alive"] == alive.tolist(), r
        assert ts.leader == js.leader == rec["leader"], r
        for j_ev, t_ev in recs:
            assert t_ev == j_ev, r
        jl = np.zeros(N)
        for h in jres.history:
            if h.get("round") == r and "Train/loss" in h:
                jl[h["node"]] = h["Train/loss"]
        np.testing.assert_allclose(rec["train_loss"], jl, rtol=F32_RTOL)
        jp, tp = _leaves(js.fed.states.params), _port_leaves(
            ts.fed.states.params)
        for k, j in jp.items():
            rel = np.linalg.norm(tp[k] - j) / np.linalg.norm(j)
            assert rel < F32_RTOL, (r, k, rel)
        # a dead row keeps its bits on both sides while it is dead
        for i in range(N):
            if alive[i]:
                dead_since.pop(i, None)
                continue
            snap = dead_since.setdefault(
                i, {k: (jp[k][i].copy(), tp[k][i].copy()) for k in jp})
            for k, (j0, t0) in snap.items():
                assert np.array_equal(jp[k][i], j0), (r, i, k)
                assert np.array_equal(tp[k][i], t0), (r, i, k)
        yield r, js, ts, rec


def test_dfl_ring_crash_then_join_with_staleness():
    jcfg = _jax_cfg(
        elastic=jschema.ElasticConfig(async_aggregation=True,
                                      staleness_beta=0.5,
                                      straggler_fraction=0.5,
                                      straggler_factor=3.0),
        faults=[jschema.FaultEvent(node=2, round=1, kind="crash"),
                jschema.FaultEvent(node=2, round=2, kind="join")])
    joined = []

    def on_join(ts, ev, payload):
        # right after the copy: the joiner's row and its source's
        if ev is Events.NODE_JOINED:
            rows = ts.fed.states.params["params"]
            joined.append([(v[payload["node"]].clone(), v[ts.leader].clone())
                           for layer in rows.values()
                           for v in layer.values()])

    for r, js, ts, rec in _run_pair(jcfg):
        if r == 0:
            np.testing.assert_array_equal(ts._stale_scale, js._stale_scale)
            assert ts._stale_scale is not None
            ts.add_observer(lambda ev, p, ts=ts: on_join(ts, ev, p))
        assert all(rec["alive"])  # the 20 s timeout never fires
    assert len(joined) == 1
    assert all(torch.equal(a, b) for a, b in joined[0])


def test_dfl_ring_node_dead_for_two_rounds():
    jcfg = _jax_cfg(
        protocol=jschema.ProtocolConfig(**FAST_CLOCK),
        faults=[jschema.FaultEvent(node=3, round=1, kind="crash"),
                jschema.FaultEvent(node=3, round=3, kind="join")])
    masks = [rec["alive"] for _, _, _, rec in _run_pair(jcfg)]
    assert masks == [[True] * 4, [True, True, True, False],
                     [True, True, True, False], [True] * 4]


def test_cfl_star_server_crash_fails_over():
    jcfg = _jax_cfg(
        federation="CFL", topology="star",
        protocol=jschema.ProtocolConfig(**FAST_CLOCK),
        faults=[jschema.FaultEvent(node=0, round=0, kind="crash")],
        training=jschema.TrainingConfig(rounds=3, epochs_per_round=1,
                                        learning_rate=0.05))
    leaders = [rec["leader"] for _, _, _, rec in _run_pair(jcfg)]
    assert leaders == [1, 1, 1]


def test_sdfl_never_draws_a_dead_leader():
    jcfg = _jax_cfg(
        federation="SDFL", topology="fully",
        protocol=jschema.ProtocolConfig(**FAST_CLOCK),
        faults=[jschema.FaultEvent(node=1, round=0, kind="crash")],
        training=jschema.TrainingConfig(rounds=4, epochs_per_round=1,
                                        learning_rate=0.05))
    leaders = [rec["leader"] for _, _, _, rec in _run_pair(jcfg)]
    assert 1 not in leaders


def test_dp_at_zero_noise_with_a_binding_clip():
    jcfg = _jax_cfg(
        topology="fully",
        privacy=jschema.PrivacyConfig(dp=True, clip_norm=0.05,
                                      noise_multiplier=0.0),
        training=jschema.TrainingConfig(rounds=3, epochs_per_round=1,
                                        learning_rate=0.05))
    for r, js, ts, _ in _run_pair(jcfg):
        assert ts.accountant.steps == js.accountant.steps == r + 1
        assert ts.accountant.epsilon == js.accountant.epsilon
    np.testing.assert_array_equal(ts.dp_mask, js.dp_mask)


def test_cross_device_with_client_faults_matches_jax():
    faults = ([{"node": i, "round": 0, "kind": "crash"}
               for i in range(0, 40, 2)]
              + [{"node": i, "round": 2, "kind": "join"}
                 for i in range(0, 20, 2)])
    jcfg = jschema.ScenarioConfig.from_dict({
        "name": "crossdev-faults", "n_nodes": 4,
        "data": {"dataset": "mnist", "synthetic_train": 2000,
                 "synthetic_test": 96, "samples_per_node": 8,
                 "batch_size": 8},
        "model": {"model": "mlp", "compute_dtype": "float32"},
        "training": {"rounds": 3, "epochs_per_round": 2,
                     "learning_rate": 0.1, "eval_every": 0},
        "cross_device": {"n_clients": 64, "clients_per_round": 16,
                         "cohort_size": 4, "seed": 1},
        "protocol": FAST_CLOCK, "faults": faults, "wire_dtype": "f32"})
    js = JCross(jcfg)
    ts = CrossDeviceScenario(_port_cfg(jcfg), device="cpu")
    recs = [(_recorder(js), _recorder(ts)),
            (_recorder(js.membership), _recorder(ts.membership))]
    p0 = jax.tree.map(lambda a: np.asarray(a)[0], js.fed.states.params)
    ts.fed = reseed_params(ts.fed, ts.fns, params_from_jax(p0))
    dead_drawn = 0
    for r in range(3):
        jres, tres = js.run(rounds=1), ts.run(rounds=1)
        assert np.array_equal(ts.last_sampled, js.last_sampled)
        np.testing.assert_array_equal(ts.last_cohort_alive,
                                      js.last_cohort_alive)
        dead_drawn += int((~ts.last_cohort_alive).sum())
        assert (tres.history[0]["CrossDev/clients_alive"]
                == int(ts.last_cohort_alive.sum()))
        for j_ev, t_ev in recs:
            assert t_ev == j_ev, r
        jl = [h["Train/loss"] for h in jres.history if "Train/loss" in h]
        np.testing.assert_allclose(tres.history[0]["Train/loss"], jl[-1],
                                   **CROSS_TOL)
        jp, tp = _leaves(js.fed.states.params), _port_leaves(
            ts.fed.states.params)
        for k in jp:
            np.testing.assert_allclose(tp[k], jp[k], **CROSS_TOL)
    assert dead_drawn > 0
    assert ts.membership.alive[0:20:2].all()
    assert not ts.membership.alive[20:40:2].any()
    assert ts.membership.get_nodes() == js.membership.get_nodes()


def test_heavy_noise_ends_below_clean():
    def cfg(privacy=None):
        d = {"name": "dp-port", "n_nodes": 8, "topology": "fully",
             "data": {"dataset": "mnist", "batch_size": 16,
                      "samples_per_node": 64},
             "model": {"model": "mlp"},
             "training": {"rounds": 4, "eval_every": 0}}
        if privacy:
            d["privacy"] = privacy
        return ScenarioConfig.from_dict(d)

    clean = Scenario(cfg(), device="cpu").run()
    sc = Scenario(cfg({"dp": True, "clip_norm": 0.5,
                       "noise_multiplier": 2.0}), device="cpu")
    noisy = sc.run()
    assert noisy.final_accuracy < clean.final_accuracy
    assert sc.accountant.steps == 4 and np.isfinite(sc.accountant.epsilon)
