"""The port's observability tools against the JAX package's, on the CPU.

The same synthetic traces, status directories and recorder calls go
through ``p2pfl_tpu.obs`` and ``p2pfl_tpu_torch.obs``; the results must
be equal (floats within 1e-12):

- critpath's ``analyze`` (the five components and the longest chain),
  ``estimate_skew`` and its CLI, over the JAX tests' two-node fixture
  and seeded random multi-node rounds;
- perf_report's ``attribute`` (with and without devprof phases) and its
  CLI, the BENCH trajectory join included;
- every health rule through ``HealthEngine`` (delta rules over two
  evaluations), ``evaluate_dir`` and ``healthcheck``'s exit codes;
- ``traceview`` merging a JAX-written and a port-written trace file,
  each way, by either package;
- the Chrome trace JSON and ``flight_<pid>.json`` key for key;
- ``peak_flops`` and ``mfu`` under ``P2PFL_PEAK_FLOPS``, the H100 table;
- the disabled tracer: the shared ``NULL_SPAN`` and no counter state.

Pure Python over small inputs: the file runs in a few seconds. Recorders
and tracers are fresh instances, or the singletons restored after.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest

from p2pfl_tpu.obs import cost_model as j_cost
from p2pfl_tpu.obs import critpath as j_critpath
from p2pfl_tpu.obs import flight as j_flight
from p2pfl_tpu.obs import health as j_health
from p2pfl_tpu.obs import healthcheck as j_healthcheck
from p2pfl_tpu.obs import perf_report as j_perf
from p2pfl_tpu.obs import trace as j_trace
from p2pfl_tpu.obs import traceview as j_traceview
from p2pfl_tpu_torch.obs import cost_model as t_cost
from p2pfl_tpu_torch.obs import critpath as t_critpath
from p2pfl_tpu_torch.obs import flight as t_flight
from p2pfl_tpu_torch.obs import health as t_health
from p2pfl_tpu_torch.obs import healthcheck as t_healthcheck
from p2pfl_tpu_torch.obs import perf_report as t_perf
from p2pfl_tpu_torch.obs import trace as t_trace
from p2pfl_tpu_torch.obs import traceview as t_traceview
from p2pfl_tpu_torch.utils.monitor import publish_status

US = 1_000_000  # µs per second
TOL = 1e-12


@pytest.fixture(autouse=True)
def _singletons():
    """The process recorders and tracers of both packages, as found."""
    yield
    for mod_flight, mod_trace in ((j_flight, j_trace), (t_flight, t_trace)):
        mod_flight.get_recorder().clear()
        mod_trace.get_tracer().configure(enabled=False)
        mod_trace.get_tracer().reset()


def assert_close(a, b, path="$"):
    """Equal structures; floats within TOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            assert_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(float(a) - float(b)) <= TOL, (path, a, b)
    else:
        assert a == b, (path, a, b)


# ---------------------------------------------------------------------------
# synthetic traces
# ---------------------------------------------------------------------------

def _meta(pid, lane="node0"):
    return [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": f"proc{pid}"}},
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
         "args": {"name": lane}},
    ]


def _x(name, pid, t0_s, dur_s, args=None):
    ev = {"ph": "X", "name": name, "pid": pid, "tid": 0,
          "ts": t0_s * US, "dur": dur_s * US}
    if args is not None:
        ev["args"] = args
    return ev


def _two_node_doc():
    """The JAX critpath tests' fixture: node0 receives one PARAMS frame
    from node1 mid-round."""
    events = _meta(1, "node0") + _meta(2, "node1") + [
        _x("node.round", 1, 0, 10, {"round": 0}),
        _x("node.fit", 1, 0, 4),
        _x("learner.fit", 1, 0.5, 3),
        _x("node.wait", 1, 4, 5, {"round": 0, "kind": "gossip"}),
        _x("session.aggregate", 1, 8.5, 0.5),
        _x("p2p.rx", 1, 6, 0.1,
           {"parent": "B.1", "from": 1, "trace": "B", "round": 0,
            "tx_ns": 0, "rx_ns": 500_000_000}),
        _x("node.round", 2, 0, 8, {"round": 0}),
        _x("learner.fit", 2, 0, 5),
        _x("p2p.tx", 2, 5.5, 0.1, {"sid": "B.1", "round": 0}),
    ]
    return {"traceEvents": events, "metadata": {"files": 2}}


def _random_doc(seed: int, n: int = 4, rounds: int = 3,
                devprof: bool = False) -> dict:
    """``n`` lanes (one process each) over ``rounds`` rounds: every
    round a fit (with a nested learner.fit and, optionally, the devprof
    phases), a gossip wait holding an aggregation, one PARAMS send to
    every other lane and its receive, skewed per process."""
    rng = np.random.default_rng(seed)
    events = []
    skew_ns = [int(v) for v in rng.integers(-2_000_000, 2_000_000, n)]
    for i in range(n):
        events += _meta(10 + i, f"node{i}")
    t = 0.0
    for r in range(rounds):
        walls = rng.uniform(2.0, 4.0, n)
        for i in range(n):
            pid = 10 + i
            fit = float(rng.uniform(0.5, 1.5))
            events.append(_x("node.round", pid, t, float(walls[i]),
                             {"round": r}))
            events.append(_x("node.fit", pid, t, fit))
            events.append(_x("learner.fit", pid, t + 0.01, fit - 0.02))
            if devprof:
                cuts = np.cumsum(rng.dirichlet(np.ones(5))) * (fit - 0.02)
                start = t + 0.01
                for name, end in zip(("data", "forward", "backward",
                                      "update", "accum"), cuts):
                    events.append(_x(f"devprof.{name}", pid, start,
                                     float(t + 0.01 + end - start)))
                    start = t + 0.01 + float(end)
            w0 = t + fit + 0.05
            wdur = float(walls[i]) - fit - 0.2
            events.append(_x("node.wait", pid, w0, wdur,
                             {"round": r, "kind": "gossip"}))
            events.append(_x("session.aggregate", pid, w0 + wdur / 2,
                             float(rng.uniform(0.01, 0.1))))
            events.append(_x("p2p.tx", pid, t + fit + 0.01, 0.01,
                             {"sid": f"T{i}.{r}", "round": r}))
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                tx_s = t + 1.6 + 0.01 * i
                lat = float(rng.uniform(0.001, 0.05))
                rx_s = tx_s + lat
                events.append(_x(
                    "p2p.rx", 10 + j, rx_s, 0.002,
                    {"parent": f"T{i}.{r}", "trace": f"T{i}", "from": i,
                     "round": r,
                     "tx_ns": int(tx_s * 1e9) + skew_ns[i],
                     "rx_ns": int(rx_s * 1e9) + skew_ns[j]}))
        t += float(walls.max()) + 0.1
    return {"traceEvents": events, "metadata": {"files": n}}


DOCS = {"two_node": _two_node_doc,
        "random_0": lambda: _random_doc(0),
        "random_1": lambda: _random_doc(1, n=6, rounds=2),
        "random_devprof": lambda: _random_doc(2, devprof=True)}


@pytest.mark.parametrize("doc", sorted(DOCS))
@pytest.mark.parametrize("round_no", [None, 0, 1])
def test_critpath_analyze_matches(doc, round_no):
    d = DOCS[doc]()
    ours = t_critpath.analyze(d, round_no=round_no)
    assert_close(ours, j_critpath.analyze(d, round_no=round_no))
    for rec in ours["rounds"].values():
        for comp in rec["nodes"].values():
            total = sum(comp[k] for k in ("fit_s", "wire_s", "wait_s",
                                          "agg_s", "other_s"))
            assert total >= comp["round_s"] - 1e-5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_estimate_skew_matches(seed):
    rng = np.random.default_rng(seed)
    lanes = ["a", "b", "c", "0", "1"]
    spans = []
    for _ in range(30):
        s, r = rng.choice(lanes, 2, replace=False)
        tx = int(rng.integers(0, 10**9))
        spans.append({"name": "p2p.rx", "_lane": str(r),
                      "args": {"from": str(s), "tx_ns": tx,
                               "rx_ns": tx + int(rng.integers(10**5,
                                                             10**8))}})
    assert_close(t_critpath.estimate_skew(spans),
                 j_critpath.estimate_skew(spans))


def _write_doc(dirpath: pathlib.Path, doc: dict, wall_t0: float = 100.0):
    dirpath.mkdir(parents=True, exist_ok=True)
    pids = sorted({ev["pid"] for ev in doc["traceEvents"]})
    for pid in pids:
        evs = [ev for ev in doc["traceEvents"] if ev["pid"] == pid]
        (dirpath / f"proc{pid}.trace.json").write_text(json.dumps(
            {"traceEvents": evs,
             "metadata": {"wall_t0": wall_t0, "pid": pid,
                          "counters": {"xla/backend_compiles": pid % 3}}}))


@pytest.mark.parametrize("argv", [["--json"], ["--json", "--round", "1"],
                                  [], ["--round", "9"]])
def test_critpath_cli_matches(tmp_path, capsys, argv):
    _write_doc(tmp_path, _random_doc(3))
    rc = t_critpath.main([str(tmp_path), *argv])
    ours = capsys.readouterr()
    assert rc == j_critpath.main([str(tmp_path), *argv])
    theirs = capsys.readouterr()
    assert (ours.out, ours.err) == (theirs.out, theirs.err)


@pytest.mark.parametrize("doc", sorted(DOCS))
def test_perf_report_attribute_matches(doc):
    d = DOCS[doc]()
    d["metadata"]["counters_by_pid"] = {"10": {"xla/backend_compiles": 2}}
    ours = t_perf.attribute(d)
    assert_close(ours, j_perf.attribute(d))
    assert ours["top"] is not None
    assert_close(t_perf.devprof_phases(d), j_perf.devprof_phases(d))


def test_perf_report_cli_and_bench_join_match(tmp_path, capsys):
    _write_doc(tmp_path / "trace", _random_doc(4, devprof=True))
    hist, cand = tmp_path / "BENCH_a.json", tmp_path / "BENCH_b.json"
    hist.write_text(json.dumps({"socket_round_s_24node": 1.0, "mfu": 0.5,
                                "round_s_8node": 2.0}))
    cand.write_text(json.dumps({"socket_round_s_24node": 1.8, "mfu": 0.25,
                                "round_s_8node": 2.0}))
    for argv in ([str(tmp_path / "trace")],
                 [str(tmp_path / "trace"), "--json"],
                 [str(tmp_path / "trace"), "--bench", str(hist), str(cand)],
                 [str(tmp_path / "empty")]):
        rc = t_perf.main(argv)
        ours = capsys.readouterr()
        assert rc == j_perf.main(argv), argv
        theirs = capsys.readouterr()
        assert (ours.out, ours.err) == (theirs.out, theirs.err), argv
    assert_close(t_perf.bench_attribution([str(hist), str(cand)]),
                 j_perf.bench_attribution([str(hist), str(cand)]))


# ---------------------------------------------------------------------------
# health rules
# ---------------------------------------------------------------------------

NOW = 1_000_000.0


def _status(node, ts=NOW, **fields):
    return {"node": node, "ts": ts, **fields}


# each rule: a list of evaluations (statuses, metrics, now); the delta
# rules need two
RULE_CASES = {
    "round-stall": [([_status(i, round=r) for i, r in
                      enumerate((5, 5, 2, 5))], [], NOW)],
    "round-stall-clock": [([_status(0, round=3), _status(1, round=3)], [],
                           NOW),
                          ([_status(0, round=3, ts=NOW + 40),
                            _status(1, round=4, ts=NOW + 40)], [],
                           NOW + 40)],
    "node-dead-warn": [([_status(0), _status(1), _status(2),
                         _status(3, ts=NOW - 60)], [], NOW)],
    "node-dead-crit": [([_status(0), _status(1, ts=NOW - 60),
                         _status(2, ts=NOW - 60), _status(3, ts=NOW - 60)],
                        [], NOW)],
    "trust-collapse": [([_status(0, trust=0.9), _status(1, trust=0.05)],
                        [], NOW)],
    "byte-rate": [([_status(i, bytes_out=b) for i, b in
                    enumerate((1e6, 1.1e6, 0.9e6, 5e7))], [], NOW)],
    "recompile-storm": [([_status(0, recompiles=40),
                          _status(1, recompiles=0)], [], NOW)],
    "accuracy-divergence": [([_status(i, accuracy=a) for i, a in
                              enumerate((0.9, 0.88, 0.91, 0.5))], [], NOW)],
    "accuracy-from-metrics": [([_status(i) for i in range(3)],
                               [{"node": 0, "Test/accuracy": 0.9},
                                {"node": 1, "Test/accuracy": 0.92},
                                {"node": 2, "Test/accuracy": 0.3}], NOW)],
    "epsilon-budget": [([_status(0, dp_epsilon=0.85, dp_epsilon_budget=1.0),
                         _status(1, dp_epsilon=1.2, dp_epsilon_budget=1.0)],
                        [], NOW)],
    "partition-suspected": [
        ([_status(i, peer_bytes_in={str(j): 100 for j in range(4) if j != i},
                  peer_bytes_out={str(j): 100 for j in range(4) if j != i})
          for i in range(4)], [], NOW),
        ([_status(i, peer_bytes_in={str(j): 100 + (200 if (i < 2) == (j < 2)
                                                   else 0)
                                    for j in range(4) if j != i},
                  peer_bytes_out={str(j): 100 for j in range(4) if j != i},
                  ts=NOW + 5) for i in range(4)], [], NOW + 5)],
    "sidecar-stalled": [
        ([_status(0, aggd_desc_q_depth=2, aggd_slot_releases=10)], [], NOW),
        ([_status(0, aggd_desc_q_depth=6, aggd_slot_releases=10,
                  ts=NOW + 2)], [], NOW + 2)],
    "mfu-collapse": [
        ([_status(0, devprof_mfu=0.4), _status(1, devprof_mfu=0.01)], [],
         NOW),
        ([_status(0, devprof_mfu=0.1, ts=NOW + 2),
          _status(1, devprof_mfu=0.001, ts=NOW + 2)], [], NOW + 2)],
    "hbm-watermark": [([_status(0, devprof_hbm_peak_mb=70000.0,
                                devprof_hbm_limit_mb=80000.0),
                        _status(1, devprof_hbm_peak_mb=79000.0,
                                devprof_hbm_limit_mb=80000.0),
                        _status(2, devprof_hbm_peak_mb=100.0)], [], NOW)],
    "fire-then-clear": [([_status(0, trust=0.05), _status(1, trust=0.9)],
                         [], NOW),
                        ([_status(0, trust=0.5, ts=NOW + 1),
                          _status(1, trust=0.9, ts=NOW + 1)], [], NOW + 1)],
}


def _run_engine(mod, evaluations):
    eng = mod.HealthEngine()
    seen = []
    for statuses, metrics, now in evaluations:
        alerts = eng.evaluate(statuses, metrics, now=now)
        seen.append([a.to_dict() for a in alerts])
    return seen, eng.transitions, eng.worst()


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_health_rule_matches(case):
    ours = _run_engine(t_health, RULE_CASES[case])
    assert_close(ours, _run_engine(j_health, RULE_CASES[case]))
    if case != "fire-then-clear":
        assert ours[0][-1], case  # the case fires in its last evaluation
    # the alert transitions reach the port's flight recorder
    kinds = {e["kind"] for e in t_flight.get_recorder().events()}
    assert "health.fire" in kinds


def test_default_rules_are_the_jax_rules():
    assert ([(r.name, r.severity) for r in t_health.default_rules()]
            == [(r.name, r.severity) for r in j_health.default_rules()])
    assert (t_health.HealthConfig().__dict__
            == j_health.HealthConfig().__dict__)


def _status_dir(root: pathlib.Path, records, metrics=()):
    status = root / "status"
    for rec in records:
        rec = dict(rec)
        node = rec.pop("node")
        publish_status(status, node, rec)
    if metrics:
        (root / "metrics.jsonl").write_text(
            "".join(json.dumps(m) + "\n" for m in metrics) + '{"torn')
    return root


@pytest.mark.parametrize("case", ["healthy", "warn", "crit"])
def test_evaluate_dir_and_healthcheck_exit_codes_match(tmp_path, capsys,
                                                       case):
    import time

    now = time.time()
    recs = {
        "healthy": [_status(i, now, round=3, accuracy=0.9)
                    for i in range(3)],
        "warn": [_status(i, now, round=r, accuracy=0.9)
                 for i, r in enumerate((5, 5, 1))],
        "crit": [_status(0, now, round=3, dp_epsilon=2.0,
                         dp_epsilon_budget=1.0),
                 _status(1, now, round=3)],
    }[case]
    root = _status_dir(tmp_path / case, recs,
                       metrics=[{"node": 0, "Test/accuracy": 0.9}])
    t_alerts, _ = t_health.evaluate_dir(root, now=now + 1)
    j_alerts, _ = j_health.evaluate_dir(root, now=now + 1)
    assert_close([a.to_dict() for a in t_alerts],
                 [a.to_dict() for a in j_alerts])
    want = {"healthy": 0, "warn": 1, "crit": 2}[case]
    for argv in ([str(root)], [str(root), "--json"],
                 [str(root / "status")]):
        assert t_healthcheck.main(argv) == want
        ours = capsys.readouterr().out
        assert j_healthcheck.main(argv) == want
        theirs = capsys.readouterr().out
        if "--json" in argv:
            o, t = json.loads(ours), json.loads(theirs)
            assert o["severity"] == t["severity"]
            assert ([(a["rule"], a["node"]) for a in o["alerts"]]
                    == [(a["rule"], a["node"]) for a in t["alerts"]])
        else:
            assert ours == theirs


def test_tail_jsonl_matches(tmp_path):
    p = tmp_path / "m.jsonl"
    p.write_text("".join(json.dumps({"i": i}) + "\n" for i in range(50))
                 + "{torn")
    for window in (64, 1 << 20):
        assert (t_health.tail_jsonl(p, max_bytes=window)
                == j_health.tail_jsonl(p, max_bytes=window))


# ---------------------------------------------------------------------------
# trace files: the schema, and the merge across packages
# ---------------------------------------------------------------------------

def _drive(tracer, flight_rec=None):
    """The same recording calls on either package's objects."""
    tracer.configure(enabled=True)
    with tracer.span("node.round", lane="node0", args={"round": 0}):
        with tracer.span("node.fit", lane="node0", args={"round": 0}):
            pass
        sid = tracer.next_span_id()
        with tracer.span("p2p.tx", lane="node0",
                         args={"sid": sid, "round": 0}):
            pass
        with tracer.span("p2p.rx", lane="node1",
                         args={"parent": sid, "from": 0, "round": 0,
                               "trace": tracer.trace_id, "tx_ns": 1,
                               "rx_ns": 2}):
            pass
    tracer.count("rx_msgs/params")
    tracer.count("tx_bytes/peer1", 10)
    tracer.high_water("send_q_depth/peer1", 3)
    if flight_rec is not None:
        flight_rec.record("node.crash", node=3, round=1)
        flight_rec.record("membership.suspect", node=3, t=1.0)


def _shape(obj):
    """Keys, recursively, with the event list reduced to one key set per
    (ph, name)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()
                if k not in ("counters", "gauges")}
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return sorted({(e.get("ph", ""), e.get("name", ""),
                        tuple(sorted(e)),
                        tuple(sorted(e.get("args", {}))))
                       for e in obj})
    return type(obj).__name__


def test_chrome_trace_schema_matches(tmp_path):
    ours, theirs = t_trace.Tracer(), j_trace.Tracer()
    _drive(ours)
    _drive(theirs)
    a = json.loads(ours.export(tmp_path / "t.trace.json").read_text())
    b = json.loads(theirs.export(tmp_path / "j.trace.json").read_text())
    assert _shape(a) == _shape(b)
    assert a["metadata"]["counters"] == b["metadata"]["counters"]
    assert a["metadata"]["gauges"] == b["metadata"]["gauges"]
    assert ([k for k in a["metadata"]] == [k for k in b["metadata"]])
    assert_close({k: v for k, v in ours.summarize().items() if k != "ts"}
                 | {"spans": {}},
                 {k: v for k, v in theirs.summarize().items() if k != "ts"}
                 | {"spans": {}})
    assert set(ours.summarize()["spans"]) == set(
        theirs.summarize()["spans"])


def test_flight_file_schema_matches(tmp_path):
    ours, theirs = t_flight.FlightRecorder(), j_flight.FlightRecorder()
    ours.configure(enabled=True)
    theirs.configure(enabled=True)
    _drive(t_trace.Tracer(), ours)
    _drive(j_trace.Tracer(), theirs)
    for name, rec in (("t", ours), ("j", theirs)):
        rec.dump("first", path=tmp_path / name / "flight_1.json")
    a = json.loads(ours.dump("node3.crash",
                             path=tmp_path / "t" / "flight_1.json")
                   .read_text())
    b = json.loads(theirs.dump("node3.crash",
                               path=tmp_path / "j" / "flight_1.json")
                   .read_text())
    assert list(a) == list(b)
    assert a["reasons"] == b["reasons"] == ["first", "node3.crash"]
    assert ([(e["kind"], sorted(e)) for e in a["events"]]
            == [(e["kind"], sorted(e)) for e in b["events"]])
    # a dump with no directory lands in the process's configured dir
    ours.configure(dump_dir=tmp_path / "dir")
    path = ours.dump("again")
    assert path.parent == tmp_path / "dir"
    assert path.name.startswith("flight_") and path.suffix == ".json"


def test_flight_off_records_nothing(tmp_path):
    for mod in (t_flight, j_flight):
        rec = mod.FlightRecorder()
        rec.configure(enabled=False)
        rec.record("node.crash", node=1)
        assert len(rec) == 0 and rec.dump("x", tmp_path / "f.json") is None


def _second_process(path: pathlib.Path, pid: int, shift_s: float) -> None:
    """Rewrite a trace file as another process's, started ``shift_s``
    later."""
    doc = json.loads(path.read_text())
    for ev in doc["traceEvents"]:
        ev["pid"] = pid
    doc["metadata"]["pid"] = pid
    doc["metadata"]["wall_t0"] += shift_s
    path.write_text(json.dumps(doc))


@pytest.mark.parametrize("first", ["jax", "port"])
def test_traceview_merges_either_package_files(tmp_path, first):
    ours, theirs = t_trace.Tracer(), j_trace.Tracer()
    _drive(ours)
    _drive(theirs)
    pt = ours.export(tmp_path / "port.trace.json")
    jt = theirs.export(tmp_path / "jax.trace.json")
    _second_process(jt if first == "port" else pt, 424242, 0.25)
    files = [jt, pt] if first == "jax" else [pt, jt]
    merged = t_traceview.merge(files)
    assert_close(merged, j_traceview.merge(files))
    assert merged["metadata"]["files"] == 2
    assert len(merged["metadata"]["counters_by_pid"]) == 2
    n_spans = sum(1 for e in merged["traceEvents"] if e.get("ph") == "X")
    assert n_spans == 8
    # both packages' critpath read the merged doc alike
    assert_close(t_critpath.analyze(merged), j_critpath.analyze(merged))
    # and the CLIs merge a directory holding both
    out = tmp_path / "merged.json"
    assert t_traceview.main([str(tmp_path), "-o", str(out)]) == 0
    assert json.loads(out.read_text())["metadata"]["files"] == 2


def test_traceview_skips_torn_files(tmp_path, capsys):
    (tmp_path / "a.trace.json").write_text("")
    (tmp_path / "b.trace.json").write_text("[1, 2]")
    assert t_traceview.main([str(tmp_path), "-o",
                             str(tmp_path / "m.json")]) == 1
    assert "no readable trace files" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the tracer's two states, the peak table and the MFU arithmetic
# ---------------------------------------------------------------------------

def test_disabled_tracer_is_free():
    tr = t_trace.Tracer()
    assert not tr.enabled
    assert tr.span("node.round") is t_trace.NULL_SPAN
    assert tr.span("a", lane="x", args={"k": 1}) is tr.span("b")
    with tr.span("node.fit"):
        pass
    tr.count("rx_msgs/params")
    tr.high_water("send_q_depth/peer0", 5)
    assert tr.spans() == [] and tr.counters() == {} and tr.gauges() == {}
    assert tr.export() is None  # no directory known
    # the process singleton starts disabled
    assert t_trace.get_tracer().span("x") is t_trace.NULL_SPAN
    assert t_trace.xla_recompiles() == 0
    assert t_trace.install_xla_listener() is False


@pytest.mark.parametrize("raw,enabled,subdir", [
    ("", False, None), ("0", False, None), ("1", True, "default"),
    ("custom", True, "custom")])
def test_configure_from_env_matches(tmp_path, raw, enabled, subdir):
    env = {"P2PFL_TRACE": str(tmp_path / raw) if subdir == "custom"
           else raw}
    for mod in (t_trace, j_trace):
        tr = mod.configure_from_env(default_dir=tmp_path / "default",
                                    env=env)
        assert tr is mod.get_tracer() and tr.enabled is enabled
        if subdir is not None:
            assert tr.export_dir == tmp_path / subdir


@pytest.mark.parametrize("flops,wall,n,peak", [
    (1e12, 1.0, 1, None), (3.3e13, 0.5, 4, None), (1e9, 2.0, 1, 5e11),
    (None, 1.0, 1, None), (1e12, 0.0, 1, None)])
def test_mfu_and_peak_override_match(monkeypatch, flops, wall, n, peak):
    monkeypatch.setenv("P2PFL_PEAK_FLOPS", "2.5e14")
    assert t_cost.peak_flops() == j_cost.peak_flops() == 2.5e14
    assert t_cost.mfu(flops, wall, n, peak) == j_cost.mfu(flops, wall, n,
                                                          peak)


def test_peak_table_is_the_h100_family(monkeypatch):
    monkeypatch.delenv("P2PFL_PEAK_FLOPS", raising=False)
    assert t_cost.card_peaks("NVIDIA H100 80GB HBM3")[1] == 989e12
    assert t_cost.card_peaks("NVIDIA H100 PCIe")[1] == 756e12
    assert t_cost.card_peaks("NVIDIA H200")[0] == 4.8e12
    assert t_cost.card_peaks("NVIDIA A100-SXM4-80GB") is None
    assert t_cost.peak_flops("cpu") is None
    assert t_cost.mfu(1e12, 1.0, device="cpu") is None
    wm = t_cost.memory_watermark("cpu")
    assert wm["devprof_rss_peak_mb"] > 0
    assert "devprof_hbm_peak_mb" not in wm
