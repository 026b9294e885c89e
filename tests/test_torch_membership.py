"""The membership clock and the elastic config against the JAX
package's, on the CPU. Everything here is numpy and standard-library
code copied into the port, so every comparison is exact:

- ``Membership`` on seeded random scripts of all six fault kinds, with
  explicit beats, the probe machine driven to eviction, and amnesty,
  at n in {4, 3550} and two protocols (the default 4 s / 20 s clock and
  a 4 s / 3 s one): the alive mask, ``last_seen``, the probe state and
  the event sequence equal after every step, and ``probe_failed``,
  ``probes_due``, ``evict`` and ``get_nodes`` give the same results;
- ``materialize_elastic``: the same fault list and ``fit_slowdown``s on
  a grid of (n, straggler fraction, churn fraction, seed, rounds), and
  the same after a JSON round trip (idempotent);
- ``staleness_scale``: the same f32 bits;
- a JAX ``ScenarioConfig`` with ``privacy``, ``faults``, ``elastic`` and
  ``protocol`` saved to JSON loads into the port with an equal
  ``to_json``; the validation of ``FaultEvent``, ``ElasticConfig`` and
  ``NodeConfig`` raises the JAX package's messages.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from p2pfl_tpu.config import schema as jschema
from p2pfl_tpu.federation.membership import Membership as JMembership
from p2pfl_tpu.parallel.federated import staleness_scale as jstale
from p2pfl_tpu_torch.config import schema as tschema
from p2pfl_tpu_torch.federation.membership import Membership
from p2pfl_tpu_torch.parallel.federated import staleness_scale

KINDS = ("crash", "recover", "join", "partition", "heal", "restart")
PROTOCOLS = [dict(), dict(heartbeat_period_s=4.0, node_timeout_s=3.0)]


def _recorder(obs):
    events = []
    obs.add_observer(lambda ev, payload: events.append(
        (ev.value, json.dumps(payload, sort_keys=True, default=int))))
    return events


def _same_state(t, j):
    np.testing.assert_array_equal(t.alive, j.alive)
    np.testing.assert_array_equal(t.last_seen, j.last_seen)
    np.testing.assert_array_equal(t.beating, j.beating)
    np.testing.assert_array_equal(t.departed, j.departed)
    np.testing.assert_array_equal(t.probe_failures, j.probe_failures)
    np.testing.assert_array_equal(t.next_probe, j.next_probe)
    assert t.clock == j.clock
    assert t.get_nodes() == j.get_nodes()


def _fault(rng, n, r, lib):
    # crashes are drawn most often, so that timeouts fire at n = 4 too
    kind = KINDS[int(rng.choice(len(KINDS),
                                p=[0.5, 0.1, 0.1, 0.1, 0.1, 0.1]))]
    groups = []
    if kind == "partition":
        cut = int(rng.integers(1, n))
        groups = [list(range(cut)), list(range(cut, n))]
    return lib.FaultEvent(node=int(rng.integers(n)), round=r, kind=kind,
                          groups=groups)


@pytest.mark.parametrize("n", [4, 3550])
@pytest.mark.parametrize("proto", PROTOCOLS)
@pytest.mark.parametrize("seed", [0, 1])
def test_membership_matches_jax_on_random_fault_scripts(n, proto, seed):
    rng = np.random.default_rng(seed)
    tp, jp = tschema.ProtocolConfig(**proto), jschema.ProtocolConfig(**proto)
    t, j = Membership(n, tp), JMembership(n, jp)
    tev, jev = _recorder(t), _recorder(j)
    period = tp.heartbeat_period_s
    for r in range(14):
        for _ in range(int(rng.integers(0, 3 if n == 4 else 40))):
            seed_state = rng.bit_generator.state
            tf = _fault(rng, n, r, tschema)
            rng.bit_generator.state = seed_state
            jf = _fault(rng, n, r, jschema)
            t.apply_fault(tf)
            j.apply_fault(jf)
        if rng.random() < 0.3:  # an explicit beat between clock ticks
            i = int(rng.integers(n))
            when = t.clock + 0.5 * period
            t.beat(i, when)
            j.beat(i, when)
        tt = (r + 1) * period
        np.testing.assert_array_equal(t.advance_to(tt), j.advance_to(tt))
        # the socket plane's probe machine, driven to eviction
        due = t.probes_due()
        assert due == j.probes_due()
        for i in due[:5]:
            gone = t.probe_failed(i)
            assert gone == j.probe_failed(i)
            if gone:
                t.evict(i)
                j.evict(i)
        if rng.random() < 0.2:
            i = int(rng.integers(n))
            t.amnesty(i)
            j.amnesty(i)
        _same_state(t, j)
        assert tev == jev
    assert any(e[0] == "node_died" for e in tev)


def test_probe_machine_and_eviction_match_jax():
    proto = dict(heartbeat_period_s=4.0, node_timeout_s=3.0)
    t = Membership(4, tschema.ProtocolConfig(**proto))
    j = JMembership(4, jschema.ProtocolConfig(**proto))
    tev, jev = _recorder(t), _recorder(j)
    for m, lib in ((t, tschema), (j, jschema)):
        m.apply_fault(lib.FaultEvent(node=2, round=0, kind="crash"))
    clock = 4.0
    np.testing.assert_array_equal(t.advance_to(clock), j.advance_to(clock))
    assert not t.alive[2]
    results = []
    while True:
        due = t.probes_due(clock)
        assert due == j.probes_due(clock)
        if due:
            a, b = t.probe_failed(2, clock), j.probe_failed(2, clock)
            assert a == b
            results.append(a)
            if a:
                t.evict(2)
                j.evict(2)
                break
        clock += 0.5
    assert results[-1] and len(results) == t.retry_limit
    # sticky against beats, cleared by a heal's amnesty, revived by a beat
    for m in (t, j):
        m.beat(2, clock)
    assert not t.alive[2] and t.departed[2]
    for m, lib in ((t, tschema), (j, jschema)):
        m.apply_fault(lib.FaultEvent(node=0, round=1, kind="heal"))
    _same_state(t, j)
    assert not t.departed[2] and not t.alive[2]
    for m in (t, j):
        m.beat(2, clock + 1)
    _same_state(t, j)
    assert t.alive[2]
    # an evict of a live node fires NODE_DIED at once
    t.evict(1)
    j.evict(1)
    _same_state(t, j)
    assert tev == jev


@pytest.mark.parametrize("n", [1, 5, 24, 64])
@pytest.mark.parametrize("strag,churn", [(0.0, 0.2), (0.25, 0.0),
                                         (0.25, 0.2), (0.5, 0.5)])
@pytest.mark.parametrize("seed,rounds", [(0, 12), (7, 3), (3, 1)])
def test_materialize_elastic_matches_jax(n, strag, churn, seed, rounds):
    kw = dict(straggler_fraction=strag, straggler_factor=4.0,
              churn_fraction=churn, async_aggregation=True, seed=seed)
    common = dict(n_nodes=n, topology="ring" if n > 2 else "fully")
    j = jschema.ScenarioConfig(
        **common, elastic=jschema.ElasticConfig(**kw),
        training=jschema.TrainingConfig(rounds=rounds))
    t = tschema.ScenarioConfig(
        **common, elastic=tschema.ElasticConfig(**kw),
        training=tschema.TrainingConfig(rounds=rounds))
    assert ([(f.node, f.round, f.kind) for f in t.faults]
            == [(f.node, f.round, f.kind) for f in j.faults])
    assert ([nc.fit_slowdown for nc in t.nodes]
            == [nc.fit_slowdown for nc in j.nodes])
    again = tschema.ScenarioConfig.from_dict(json.loads(t.to_json()))
    assert again.to_json() == t.to_json()


def test_staleness_scale_gives_the_jax_bits():
    s = np.array([-2.0, 0.0, 0.5, 1.0, 3.0, 7.0, 1e6], np.float32)
    for beta in (0.0, 0.5, 1.0, 2.3):
        got, want = staleness_scale(s, beta), jstale(s, beta)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert staleness_scale(3.0, 0.5).dtype == np.float32


def test_jax_json_with_the_new_sections_loads_into_the_port(tmp_path):
    cfg = jschema.ScenarioConfig(
        n_nodes=8, topology="ring",
        training=jschema.TrainingConfig(rounds=9),
        protocol=jschema.ProtocolConfig(heartbeat_period_s=4.0,
                                        node_timeout_s=3.0,
                                        train_set_size=0),
        privacy=jschema.PrivacyConfig(dp=True, clip_norm=0.5,
                                      noise_multiplier=0.6, delta=1e-6,
                                      epsilon_budget=8.0),
        elastic=jschema.ElasticConfig(async_aggregation=True,
                                      min_received=0.75,
                                      staleness_beta=0.5,
                                      straggler_fraction=0.25,
                                      straggler_factor=4.0,
                                      churn_fraction=0.2, seed=3),
        faults=[jschema.FaultEvent(node=3, round=1, kind="crash"),
                jschema.FaultEvent(node=3, round=3, kind="join"),
                jschema.FaultEvent(node=0, round=2, kind="partition",
                                   groups=[[0, 1, 2, 3], [4, 5, 6, 7]]),
                jschema.FaultEvent(node=0, round=4, kind="heal"),
                jschema.FaultEvent(node=5, round=4, kind="recover"),
                jschema.FaultEvent(node=6, round=5, kind="restart")],
    )
    path = tmp_path / "scenario.json"
    cfg.save(path)
    port = tschema.ScenarioConfig.load(path)
    assert port.to_json() == cfg.to_json()
    assert isinstance(port.faults[0], tschema.FaultEvent)
    assert port.privacy.dp and port.elastic.active


@pytest.mark.parametrize("cls,kw", [
    ("FaultEvent", dict(kind="explode")),
    ("FaultEvent", dict(kind="partition", groups=[[0, 1]])),
    ("ElasticConfig", dict(min_received=0.0)),
    ("ElasticConfig", dict(min_received=1.5)),
    ("ElasticConfig", dict(staleness_beta=-0.1)),
    ("ElasticConfig", dict(straggler_factor=0.5)),
    ("ElasticConfig", dict(churn_fraction=1.5)),
    ("ElasticConfig", dict(straggler_fraction=-0.1)),
    ("ElasticConfig", dict(heartbeat_retry_limit=0)),
    ("NodeConfig", dict(fit_slowdown=0.5)),
])
def test_validation_matches_jax(cls, kw):
    with pytest.raises(ValueError) as want:
        getattr(jschema, cls)(**kw)
    with pytest.raises(ValueError) as got:
        getattr(tschema, cls)(**kw)
    assert str(got.value) == str(want.value)


def test_secagg_is_refused_naming_its_item():
    """Secure aggregation runs on the socket plane (A22c): the config
    loads in both packages alike, and the stacked Scenario refuses it
    with the JAX package's message."""
    from p2pfl_tpu_torch.federation.scenario import Scenario

    raw = {"n_nodes": 2, "privacy": {"secagg": True}}
    cfg = tschema.ScenarioConfig.from_dict(raw)
    assert cfg.privacy == tschema.PrivacyConfig(secagg=True)
    with pytest.raises(ValueError, match="socket-plane feature"):
        Scenario(cfg, device="cpu")
    for kind in KINDS:  # every fault kind is accepted
        groups = [[0], [1]] if kind == "partition" else []
        tschema.ScenarioConfig.from_dict({
            "n_nodes": 2,
            "faults": [{"node": 1, "round": 0, "kind": kind,
                        "groups": groups}]})
