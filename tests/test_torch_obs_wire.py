"""The trace context on the wire and traced fleets, the port against the
JAX package on the CPU.

- ``Message`` bytes: without ``tc`` a frame keeps the bytes it always
  had, with ``tc`` it gains the header key last; both are the JAX
  package's bytes, and each package decodes the other's ``tc``.
- A traced mixed fleet (2 JAX and 2 port mnist-mlp nodes, fully
  connected, 2 rounds, both packages' tracers on): each package exports
  its file; every node's ``node.round`` of both rounds is decomposed by
  both packages' critpath over the merged trace, alike, and the port's
  ``p2p.rx`` spans carry the JAX senders' ``tx_ns`` (and the reverse).
- The flight events (kind and node) of one membership fault script
  through both packages' ``Membership``, and of one socket crash and
  live rejoin through both packages' ``run_simulation``, are equal.

Every await sits under a wide limit; no assertion is on wall time.
"""

from __future__ import annotations

import collections
import json

import pytest
import torch

from p2pfl_tpu.config.schema import FaultEvent as JFault
from p2pfl_tpu.config.schema import ProtocolConfig as JProtocol
from p2pfl_tpu.config.schema import ScenarioConfig as JScenarioConfig
from p2pfl_tpu.federation.membership import Membership as JMembership
from p2pfl_tpu.obs import critpath as j_critpath
from p2pfl_tpu.obs import flight as j_flight
from p2pfl_tpu.obs import trace as j_trace
from p2pfl_tpu.obs import traceview as j_traceview
from p2pfl_tpu.p2p.launch import run_simulation as j_run_simulation
from p2pfl_tpu.p2p.protocol import Message as JMessage
from p2pfl_tpu.p2p.protocol import MsgType as JMsgType
from p2pfl_tpu_torch.config.schema import FaultEvent, ProtocolConfig
from p2pfl_tpu_torch.config.schema import ScenarioConfig
from p2pfl_tpu_torch.federation.membership import Membership
from p2pfl_tpu_torch.obs import critpath as t_critpath
from p2pfl_tpu_torch.obs import flight as t_flight
from p2pfl_tpu_torch.obs import trace as t_trace
from p2pfl_tpu_torch.obs import traceview as t_traceview
from p2pfl_tpu_torch.p2p.launch import run_simulation
from p2pfl_tpu_torch.p2p.protocol import Message, MsgType

LIMIT = 180


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _obs_state():
    """Both packages' tracers off and reset, their recorders empty and
    undirected, after each test."""
    yield
    for mod_flight, mod_trace in ((j_flight, j_trace), (t_flight, t_trace)):
        tr = mod_trace.get_tracer()
        tr.configure(enabled=False)
        tr.reset()
        tr.export_dir = None
        rec = mod_flight.get_recorder()
        rec.dump_dir = None
        rec.clear()


# ---------------------------------------------------------------------------
# the header's tc
# ---------------------------------------------------------------------------

FRAMES = {
    "beat": ("beat", {"n": 17}, b""),
    "params": ("params", {"round": 3, "c": [0, 2], "w": 64}, b"\x01" * 300),
    "vote": ("vote_train_set", {"round": 1, "candidates": [0, 1, 3]}, b""),
    "signed": ("stop", {}, b""),
}
TC = ("a1b2c3d4", "a1b2c3d4.17", 1_700_000_000_123_456_789)


@pytest.mark.parametrize("tc", [None, TC], ids=["untraced", "traced"])
@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_frame_bytes_equal_jax_with_and_without_tc(frame, tc):
    kind, body, payload = FRAMES[frame]
    extra = ({"sig": b"s" * 64, "cert": b"c" * 40} if frame == "signed"
             else {})
    ours = Message(MsgType(kind), 5, dict(body), payload=payload,
                   msg_id="00ff00ff00ff00ff", tc=tc, **extra)
    theirs = JMessage(JMsgType(kind), 5, dict(body), payload=payload,
                      msg_id="00ff00ff00ff00ff", tc=tc, **extra)
    assert ours.encode() == theirs.encode()
    if tc is None:
        # the frame a port without tc wrote: no "tc" key at all
        assert b"tc" not in ours.encode()[:ours.wire_size()
                                           - len(payload)]
    else:
        assert ours.signing_bytes() == Message(
            MsgType(kind), 5, dict(body), payload=payload,
            msg_id="00ff00ff00ff00ff", **extra).signing_bytes()
    # each package reads the other's frame, tc included
    back = Message.decode(theirs.encode())
    assert back.tc == tc and back.body == body and back.payload == payload
    jback = JMessage.decode(ours.encode())
    assert jback.tc == tc and jback.body == body


# ---------------------------------------------------------------------------
# a traced mixed fleet
# ---------------------------------------------------------------------------

def test_a_traced_mixed_fleet_decomposes_in_both_packages(tmp_path):
    from tests.test_torch_socket import _mixed

    j_tr, t_tr = j_trace.get_tracer(), t_trace.get_tracer()
    for tr in (j_tr, t_tr):
        tr.reset()
        tr.configure(enabled=True)
    nodes = _mixed(["jax", "jax", "port", "port"], f32=True, start=0)
    assert all(nd.round == 2 for nd in nodes)
    j_tr.export(tmp_path / "jax.trace.json", process_name="jax")
    t_tr.export(tmp_path / "port.trace.json", process_name="port")
    # one process wrote both files: the second gets its own pid
    doc = json.loads((tmp_path / "port.trace.json").read_text())
    for ev in doc["traceEvents"]:
        ev["pid"] = -1
    doc["metadata"]["pid"] = -1
    (tmp_path / "port.trace.json").write_text(json.dumps(doc))
    files = sorted(tmp_path.glob("*.trace.json"))
    merged = t_traceview.merge(files)
    assert merged == j_traceview.merge(files)
    ours, theirs = t_critpath.analyze(merged), j_critpath.analyze(merged)
    assert ours == theirs
    lanes = {f"node{i}" for i in range(4)}
    for r in (0, 1):
        comps = ours["rounds"][r]["nodes"]
        assert set(comps) == lanes, (r, comps)
        for c in comps.values():
            parts = c["fit_s"] + c["wire_s"] + c["wait_s"] + c["agg_s"]
            assert c["fit_s"] > 0
            assert parts + c["other_s"] == pytest.approx(c["round_s"],
                                                          abs=1e-5)
    # the causal edges cross the packages both ways
    rx = [e for e in merged["traceEvents"]
          if e.get("ph") == "X" and e["name"] == "p2p.rx"]
    by_lane = collections.defaultdict(set)
    for e in rx:
        assert e["args"]["tx_ns"] <= e["args"]["rx_ns"] + 10**8
        by_lane[e["pid"] == -1].add(int(e["args"]["from"]))
    assert by_lane[True] & {0, 1} and by_lane[False] & {2, 3}


# ---------------------------------------------------------------------------
# flight events across the packages
# ---------------------------------------------------------------------------

def _membership_script(mod_membership, fault_cls, proto_cls):
    m = mod_membership(5, proto_cls(heartbeat_period_s=1.0,
                                    node_timeout_s=2.5),
                       retry_limit=2, backoff_base_s=0.5)
    t = 0.0
    script = {2: [fault_cls(node=1, round=2, kind="crash")],
              6: [fault_cls(node=0, round=6, kind="partition",
                            groups=[[0, 1], [2, 3, 4]])],
              7: [fault_cls(node=0, round=7, kind="heal")],
              8: [fault_cls(node=1, round=8, kind="join")],
              9: [fault_cls(node=3, round=9, kind="restart")]}
    for r in range(11):
        for f in script.get(r, []):
            m.apply_fault(f)
        t += 1.0
        m.advance_to(t)
        for node in m.probes_due(t):
            if m.probe_failed(node, t):
                m.evict(node)
    m.evict(4)
    m.amnesty(4)


def test_a_membership_fault_script_records_the_jax_events():
    t_flight.get_recorder().clear()
    j_flight.get_recorder().clear()
    _membership_script(Membership, FaultEvent, ProtocolConfig)
    _membership_script(JMembership, JFault, JProtocol)

    def seq(rec):
        return [(e["kind"], e.get("node")) for e in rec.events()]

    ours = seq(t_flight.get_recorder())
    assert ours == seq(j_flight.get_recorder())
    kinds = {k for k, _ in ours}
    assert {"membership.suspect", "membership.probe_failed",
            "membership.evict", "membership.partition", "membership.heal",
            "membership.amnesty", "membership.join", "membership.recover",
            "membership.restart"} <= kinds


CHURN = {
    "name": "obs-churn", "n_nodes": 4, "topology": "fully",
    "data": {"dataset": "mnist", "samples_per_node": 60},
    "training": {"rounds": 3, "epochs_per_round": 1, "learning_rate": 0.05},
    "protocol": {"heartbeat_period_s": 0.2, "aggregation_timeout_s": 20.0,
                 "vote_timeout_s": 5.0, "node_timeout_s": 1.0},
    "elastic": {"async_aggregation": True, "min_received": 0.5,
                "heartbeat_backoff_base_s": 0.1,
                "heartbeat_backoff_max_s": 0.5},
    "faults": [{"kind": "crash", "node": 3, "round": 1},
               {"kind": "join", "node": 3, "round": 2}],
}
#: the events of the crash and the rejoin that every run records alike;
#: suspicions and probes depend on how long the victim stays silent
JOIN_KINDS = ("node.crash", "checkpoint.state_sync_out",
              "checkpoint.state_sync_in")


def _join_events(rec):
    return collections.Counter(
        (e["kind"], e.get("node")) for e in rec.events()
        if e["kind"] in JOIN_KINDS)


def test_a_socket_crash_and_rejoin_records_the_jax_events(tmp_path):
    t_flight.get_recorder().clear()
    j_flight.get_recorder().clear()
    cfg = ScenarioConfig.from_dict(dict(CHURN, log_dir=str(tmp_path / "t")))
    nodes: list = []
    out = run_simulation(cfg, timeout=LIMIT, device="cpu", nodes_out=nodes)
    assert out["churn"]["crashes"] == out["churn"]["joined"] == [3]
    ours = _join_events(t_flight.get_recorder())
    jout = j_run_simulation(JScenarioConfig.from_dict(
        dict(CHURN, log_dir=str(tmp_path / "j"))), timeout=LIMIT)
    assert jout["churn"]["crashes"] == jout["churn"]["joined"] == [3]
    theirs = _join_events(j_flight.get_recorder())
    assert ours == theirs
    assert ours[("node.crash", 3)] == 1
    assert ours[("checkpoint.state_sync_in", 3)] >= 1
    # the crash dumped the recorder into the run's flight directory
    dumps = list((tmp_path / "t" / "obs-churn" / "flight").glob(
        "flight_*.json"))
    assert len(dumps) == 1
    doc = json.loads(dumps[0].read_text())
    assert "node3.crash" in doc["reasons"]
    assert any(e["kind"] == "node.crash" and e["node"] == 3
               for e in doc["events"])
