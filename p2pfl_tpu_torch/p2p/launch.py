"""The socket plane's launcher: a federation over loopback TCP.

The counterpart of ``p2pfl_tpu/p2p/launch.py``:

    python -m p2pfl_tpu_torch.p2p.launch scenario.json [--platform cpu]

spawns one fresh interpreter per group of ``--nodes-per-proc`` nodes
(never a fork of a process that holds a CUDA context), gives each the
ports of all nodes, and prints ``{"nodes": [...]}``, one result per
node, gathered from the children's ``P2PFL_RESULT`` lines.
``run_simulation(cfg)`` runs every node in one event loop instead,
sharing one model and step functions, and returns the federation's
wall time, seconds a round, mean final accuracy and wire bytes.

Nodes train on the card unless ``--platform cpu`` (children inherit
the platform) or ``device="cpu"`` asks for the CPU; every node of a
process shares its device. A child whose node fails exits non-zero and
``launch`` raises.

The scenario's transport and privacy layers reach every node: its
``network`` shaping and partition windows, ``privacy.secagg`` (pair
secrets by ECDH over the scenario's certificates where there are any,
else from the seed), ``aggregation_plane="sidecar"`` (one
``aggd.SidecarClient`` a process) and ``encrypt``: ``launch`` mints a
scenario CA and the nodes' certificates in ``tls/`` beside the config
and hands the children ``--tls-dir``; ``run_simulation`` mints them in
a temporary directory. ``--max-restarts`` and ``--resume`` are A22d, as
are faults, attacks, reputation, DP, async aggregation and node
checkpoints in the scenario.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

import torch

from p2pfl_tpu_torch.config.schema import ScenarioConfig, _unported
from p2pfl_tpu_torch.core.aggregators import get_aggregator
from p2pfl_tpu_torch.datasets.data import FederatedDataset
from p2pfl_tpu_torch.device import resolve_device
from p2pfl_tpu_torch.learning.learner import SharedTrainer, TorchLearner
from p2pfl_tpu_torch.learning.lora import maybe_wrap_lora
from p2pfl_tpu_torch.models.base import build_model
from p2pfl_tpu_torch.p2p.aggd import SidecarClient
from p2pfl_tpu_torch.p2p.node import P2PNode
from p2pfl_tpu_torch.topology.topology import generate_topology
from p2pfl_tpu_torch.utils.monitor import publish_status


def _refuse_unported(cfg: ScenarioConfig) -> None:
    """What the scenario asks of the socket plane that this port does not
    run yet."""
    adv, el = cfg.adversary, cfg.elastic
    for given, what in (
        (bool(cfg.faults), "scripted faults and churn on the socket plane"),
        (adv.active or adv.reputation,
         "attacks and reputation on the socket plane"),
        (cfg.privacy.dp, "DP-FedAvg on the socket plane"),
        (el.async_aggregation, "async aggregation on the socket plane"),
        (cfg.checkpoint_dir is not None, "node checkpoints"),
    ):
        if given:
            raise _unported(what, "A22d")


def _declares_full_mesh(cfg: ScenarioConfig) -> bool:
    """True when every pair of nodes holds a healthy direct link: a
    fully connected topology with no shaping and no partition window
    (the damped relays are the repair path of a degraded link)."""
    net = cfg.network
    return cfg.topology == "fully" and not (
        net.loss_pct or net.delay_ms or net.jitter_ms or net.rate_mbps
        or net.partitions)


def _tls_pair_secrets(tls_dir: str | None, idx: int,
                      n: int) -> dict[int, bytes] | None:
    """Secure aggregation's pair secrets by ECDH over the scenario's
    certificates, or None (the seeded secrets) without a TLS directory.
    A TLS directory without ``cryptography`` raises: TLS itself could
    not run."""
    if not tls_dir:
        return None
    from cryptography import x509
    from cryptography.hazmat.primitives import serialization

    from p2pfl_tpu_torch.privacy.secagg import pair_secrets_from_tls

    d = pathlib.Path(tls_dir)
    key_path = d / f"node{idx}.key"
    if not key_path.exists():
        return None
    private_key = serialization.load_pem_private_key(
        key_path.read_bytes(), password=None)
    peer_certs = {}
    for j in range(n):
        cert_path = d / f"node{j}.crt"
        if j != idx and cert_path.exists():
            peer_certs[j] = x509.load_pem_x509_certificate(
                cert_path.read_bytes())
    return pair_secrets_from_tls(idx, private_key, peer_certs)


def _node_layers(cfg: ScenarioConfig, idx: int,
                 tls_dir: str | None = None) -> dict:
    """Node ``idx``'s ``tls`` and ``masker`` from the config (and the
    TLS directory) alone, so every process derives the same secrets."""
    out: dict = {}
    if tls_dir:
        from p2pfl_tpu_torch.p2p.tls import load_node_credentials

        out["tls"] = load_node_credentials(tls_dir, idx)
    if cfg.privacy.secagg:
        from p2pfl_tpu_torch.privacy.secagg import PairwiseMasker

        out["masker"] = PairwiseMasker(
            idx, root_seed=cfg.seed, bits=cfg.privacy.secagg_bits,
            pair_secrets=_tls_pair_secrets(tls_dir, idx, cfg.n_nodes))
    return out


def _mint_credentials(cfg: ScenarioConfig, directory) -> str:
    """The scenario CA and one certificate a node, in ``directory``."""
    from p2pfl_tpu_torch.p2p.tls import make_scenario_credentials

    make_scenario_credentials(directory, cfg.n_nodes, name=cfg.name)
    return str(directory)


def _shared_trainer(cfg: ScenarioConfig, data: FederatedDataset,
                    device: torch.device) -> SharedTrainer:
    model = maybe_wrap_lora(build_model(cfg.model), cfg,
                            torch.from_numpy(data.nodes[0].x[:1]),
                            device=device)
    t = cfg.training
    return SharedTrainer(model, objective=cfg.model.objective,
                         optimizer=t.optimizer, learning_rate=t.learning_rate,
                         momentum=t.momentum, weight_decay=t.weight_decay,
                         momentum_dtype=t.momentum_dtype,
                         batch_size=cfg.data.batch_size)


def _node(cfg: ScenarioConfig, i: int, data: FederatedDataset,
          shared: SharedTrainer, device: torch.device, **kw) -> P2PNode:
    learner = TorchLearner(data=data.nodes[i], batch_size=cfg.data.batch_size,
                           seed=cfg.seed, trainer=shared, device=device)
    return P2PNode(
        i, learner, role=cfg.nodes[i].role, n_nodes=cfg.n_nodes,
        aggregator=get_aggregator(cfg.aggregator, **cfg.aggregator_kwargs),
        protocol=cfg.protocol, federation=cfg.federation, seed=cfg.seed,
        full_mesh=_declares_full_mesh(cfg), wire_dtype=cfg.wire_dtype,
        elastic=cfg.elastic, fit_slowdown=cfg.nodes[i].fit_slowdown,
        local_epochs=cfg.nodes[i].epochs, netem=cfg.network, **kw)


def _aggd_status(client: SidecarClient | None) -> dict:
    """The sidecar's gauges for a status record: the descriptor queue's
    depth against the slot releases (what a stalled sidecar shows), and
    the bytes landed in the arena."""
    if client is None:
        return {}
    return {
        "aggd_desc_q_depth": client.queue_depth(),
        "aggd_slot_releases": client.slot_releases,
        "aggd_bytes_ingested": client.bytes_ingested,
    }


def _status(node: P2PNode) -> dict:
    return {"role": node.role, "round": node.round,
            "peers": len(node.peers), "leader": node.leader,
            "round_p95_s": node.round_p95_s(),
            "bytes_in": node.bytes_in, "bytes_out": node.bytes_out,
            "peer_bytes_in": dict(node.peer_bytes_in),
            "peer_bytes_out": dict(node.peer_bytes_out),
            "recompiles": 0, **_aggd_status(node.sidecar)}


def _status_dir(cfg: ScenarioConfig) -> pathlib.Path | None:
    if not cfg.log_dir:
        return None
    return pathlib.Path(cfg.log_dir) / cfg.name / "status"


def _raise_failed(nodes: list[P2PNode]) -> None:
    for nd in nodes:
        if nd.error is not None:
            raise RuntimeError(f"node {nd.idx} failed") from nd.error


def _free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


async def _run_node(cfg: ScenarioConfig, idx: int, ports: list[int],
                    data: FederatedDataset, shared: SharedTrainer,
                    device: torch.device, hosts: list[str] | None = None,
                    bind: str = "127.0.0.1", tls_dir: str | None = None,
                    sidecar: SidecarClient | None = None) -> dict:
    """One node's whole life in a child process."""
    n = cfg.n_nodes
    hosts = hosts or ["127.0.0.1"] * n
    node = _node(cfg, idx, data, shared, device, host=bind, port=ports[idx],
                 sidecar=sidecar, **_node_layers(cfg, idx, tls_dir))
    learner = node.learner
    await node.start()
    topo = generate_topology(cfg.topology, n, **cfg.topology_kwargs)
    # dial the higher-index neighbours (retrying until they listen); the
    # lower-index ones dial this node
    for j in topo.neighbors(idx):
        if j < idx:
            continue
        deadline = time.monotonic() + 60
        while True:
            try:
                await node.connect_to(hosts[j], ports[j])
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                await asyncio.sleep(0.1)
    want = set(topo.neighbors(idx))
    deadline = time.monotonic() + 60
    while not want <= set(node.peers) and time.monotonic() < deadline:
        await asyncio.sleep(0.1)
    status_dir = _status_dir(cfg)
    status_task = None
    if status_dir is not None:
        async def _publish_loop():
            while True:
                publish_status(status_dir, idx, _status(node))
                await asyncio.sleep(cfg.protocol.heartbeat_period_s)

        status_task = asyncio.get_running_loop().create_task(_publish_loop())
    # the kernels and the device's handles before the round clock starts
    await asyncio.get_running_loop().run_in_executor(None, learner.warm_up)
    if cfg.nodes[idx].start:
        learner.init()
        node.set_start_learning(cfg.training.rounds,
                                cfg.training.epochs_per_round)
    try:
        await asyncio.wait_for(node.finished.wait(), timeout=600)
        _raise_failed([node])
    finally:
        if status_task is not None:
            status_task.cancel()
        await node.stop()
    metrics = {k: v for k, v in node.peer_metrics[idx].items()
               if k != "round"}
    if status_dir is not None:
        publish_status(status_dir, idx, {**_status(node), **metrics})
    result = {"node": idx, "round": node.round,
              "round_p95_s": node.round_p95_s(),
              "bytes_in": node.bytes_in, "bytes_out": node.bytes_out,
              "params_bytes_out": node.params_bytes_out, **metrics,
              "device": str(device), "device_name": _device_name(device)}
    if node.learn_t0 is not None and node.learn_t1 is not None:
        result["learn_wall_s"] = round(node.learn_t1 - node.learn_t0, 3)
    return result


def _sidecar_for(cfg: ScenarioConfig, n_local: int) -> SidecarClient | None:
    """One sidecar for the process's ``n_local`` nodes: each session
    holds up to ``n_nodes`` slots a round plus its result slot, and 8
    more for reads in flight (a full arena falls back to blob entries,
    never to other arithmetic)."""
    if cfg.aggregation_plane != "sidecar":
        return None
    return SidecarClient(n_slots=n_local * (cfg.n_nodes + 2) + 8)


def _sidecar_result(client: SidecarClient | None) -> dict:
    if client is None:
        return {}
    return {"aggd_bytes_ingested": client.bytes_ingested,
            "aggd_fused_rounds": client.fused_rounds,
            "aggd_fallbacks": client.fallbacks}


def node_main(config_path: str, idx: int | list[int], ports: list[int],
              hosts: list[str] | None = None, bind: str = "127.0.0.1",
              device: torch.device | str = "cuda",
              tls_dir: str | None = None) -> None:
    """A child process: the nodes ``idx`` (one or a list) on one event
    loop, one ``P2PFL_RESULT`` line each."""
    idxs = [idx] if isinstance(idx, int) else list(idx)
    cfg = ScenarioConfig.load(config_path)
    _refuse_unported(cfg)
    dev = resolve_device(device)
    data = FederatedDataset.make(cfg.data, cfg.n_nodes)  # the same shards
    shared = _shared_trainer(cfg, data, dev)
    sidecar = _sidecar_for(cfg, len(idxs))

    async def _run_all() -> list[dict]:
        return list(await asyncio.gather(*(
            _run_node(cfg, i, ports, data, shared, dev, hosts=hosts,
                      bind=bind, tls_dir=tls_dir, sidecar=sidecar)
            for i in idxs)))

    try:
        results = asyncio.run(_run_all())
    finally:
        if sidecar is not None:
            sidecar.close()
    for result in results:
        result.update(_sidecar_result(sidecar))
        print("P2PFL_RESULT " + json.dumps(result), flush=True)


async def _simulate(cfg: ScenarioConfig, timeout: float,
                    device: torch.device, nodes: list,
                    tls_dir: str | None,
                    sidecar: SidecarClient | None) -> dict:
    _refuse_unported(cfg)
    n = cfg.n_nodes
    data = FederatedDataset.make(cfg.data, n)
    topo = generate_topology(cfg.topology, n, **cfg.topology_kwargs)
    shared = _shared_trainer(cfg, data, device)
    nodes.extend(_node(cfg, i, data, shared, device, sidecar=sidecar,
                       **_node_layers(cfg, i, tls_dir)) for i in range(n))
    for node in nodes:
        await node.start()
    for i in range(n):
        for j in topo.neighbors(i):
            if j > i:
                await nodes[i].connect_to(nodes[j].host, nodes[j].port)
    starter = next((i for i, nc in enumerate(cfg.nodes) if nc.start), 0)
    nodes[starter].learner.init()
    # every node's kernels and handles before the clock starts
    for node in nodes:
        node.learner.warm_up()
    status_dir = _status_dir(cfg)
    status_task = None
    if status_dir is not None:
        async def _status_loop() -> None:
            while True:
                for nd in nodes:
                    publish_status(status_dir, nd.idx, _status(nd))
                await asyncio.sleep(cfg.protocol.heartbeat_period_s)

        status_task = asyncio.create_task(_status_loop())

    async def _all_finished() -> None:
        await asyncio.gather(*(nd.finished.wait() for nd in nodes))

    t0 = time.monotonic()
    nodes[starter].set_start_learning(cfg.training.rounds,
                                      cfg.training.epochs_per_round)
    try:
        await asyncio.wait_for(_all_finished(), timeout=timeout)
    finally:
        wall = time.monotonic() - t0
        if status_task is not None:
            status_task.cancel()
        for node in nodes:
            await node.stop()
    _raise_failed(nodes)
    if status_dir is not None:
        for nd in nodes:
            publish_status(status_dir, nd.idx, _status(nd))
    accs = [m.get("accuracy") for m in
            (nd.peer_metrics.get(nd.idx) or {} for nd in nodes)
            if m.get("accuracy") is not None]
    return {
        "n_nodes": n,
        "rounds": min(nd.round for nd in nodes),
        "wall_s": round(wall, 3),
        "round_s": round(wall / max(cfg.training.rounds, 1), 3),
        "mean_accuracy": round(sum(accs) / len(accs), 4) if accs else None,
        "xla_recompiles": 0,  # eager PyTorch compiles no round program
        "bytes_in": sum(nd.bytes_in for nd in nodes),
        "bytes_out": sum(nd.bytes_out for nd in nodes),
        "params_bytes_out": sum(nd.params_bytes_out for nd in nodes),
        "loop_payload_touch_bytes": sum(
            nd.loop_payload_touch_bytes for nd in nodes),
        **_sidecar_result(sidecar),
    }


def run_simulation(cfg: ScenarioConfig, timeout: float = 600,
                   device: torch.device | str = "cuda",
                   nodes_out: list | None = None,
                   sidecar_out: list | None = None) -> dict:
    """Every node of a socket federation in one process and event loop
    (loopback TCP), sharing one model and step functions, and one
    sidecar when the scenario asks for it (closed at the end; its
    counters are in the result). ``nodes_out``, a list, gets the
    ``P2PNode``s (their learners hold the final state), ``sidecar_out``
    the ``SidecarClient``."""
    nodes = nodes_out if nodes_out is not None else []
    sidecar = _sidecar_for(cfg, cfg.n_nodes)
    if sidecar is not None and sidecar_out is not None:
        sidecar_out.append(sidecar)
    try:
        with tempfile.TemporaryDirectory(prefix="p2pfl_tls_") as d:
            tls_dir = _mint_credentials(cfg, d) if cfg.encrypt else None
            return asyncio.run(_simulate(cfg, timeout, resolve_device(device),
                                         nodes, tls_dir, sidecar))
    finally:
        if sidecar is not None:
            sidecar.close()


def launch(cfg: ScenarioConfig, config_path: str | pathlib.Path,
           platform: str | None = None, nodes_per_proc: int = 1,
           max_restarts: int = 0, timeout: float = 900) -> list[dict]:
    """Spawn the node processes (``nodes_per_proc`` nodes each) and
    collect their results; raises if a child fails."""
    if max_restarts > 0:
        raise _unported("restarting node processes (--max-restarts)", "A22d")
    _refuse_unported(cfg)
    ports = _free_ports(cfg.n_nodes)
    tls_dir = None
    if cfg.encrypt:
        tls_dir = _mint_credentials(
            cfg, pathlib.Path(config_path).resolve().parent / "tls")
    k = max(int(nodes_per_proc), 1)
    groups = [list(range(i, min(i + k, cfg.n_nodes)))
              for i in range(0, cfg.n_nodes, k)]
    # the children import this package from wherever the parent did
    root = str(pathlib.Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p)}
    procs = []
    for group in groups:
        cmd = [sys.executable, "-m", "p2pfl_tpu_torch.p2p.launch",
               str(config_path), "--node", ",".join(map(str, group)),
               "--ports", ",".join(map(str, ports))]
        if platform:
            cmd += ["--platform", platform]
        if tls_dir:
            cmd += ["--tls-dir", tls_dir]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True,
                                      env=env))
    outs, failed = [], []
    try:
        for group, p in zip(groups, procs):
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            if p.returncode != 0:
                failed.append(f"nodes {group} exited {p.returncode}:\n"
                              + out[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError("socket federation failed: " + "\n".join(failed))
    results = []
    for out in outs:
        for line in out.splitlines():
            if line.startswith("P2PFL_RESULT "):
                results.append(json.loads(line[len("P2PFL_RESULT "):]))
    return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="p2pfl_tpu_torch.p2p.launch")
    ap.add_argument("config")
    ap.add_argument("--node", default=None,
                    help="node index, or comma-separated indices to run "
                         "on one event loop (child mode)")
    ap.add_argument("--nodes-per-proc", type=int, default=1,
                    help="parent mode: pack k nodes into each child")
    ap.add_argument("--ports", default=None,
                    help="comma-separated port per node (child mode)")
    ap.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                    help="run on the CPU (the card is the default); "
                         "children inherit it")
    ap.add_argument("--tls-dir", default=None,
                    help="child mode: the scenario's CA and node "
                         "certificates (mutual TLS; needs cryptography)")
    ap.add_argument("--hosts", default=None,
                    help="comma-separated per-node hostnames (child mode)")
    ap.add_argument("--bind", default="127.0.0.1",
                    help="listen address (0.0.0.0 inside containers)")
    ap.add_argument("--resume", action="store_true", help="A22d: not ported")
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="A22d: not ported")
    args = ap.parse_args(argv)
    if args.resume:
        raise _unported("resuming a node (--resume)", "A22d")
    device = args.platform or "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("p2pfl_tpu_torch.p2p.launch: no CUDA device is available; "
              "pass --platform cpu to run on the CPU", file=sys.stderr)
        return 2
    if args.node is not None:
        node_main(args.config, [int(i) for i in str(args.node).split(",")],
                  [int(p) for p in args.ports.split(",")],
                  hosts=args.hosts.split(",") if args.hosts else None,
                  bind=args.bind, device=device, tls_dir=args.tls_dir)
        return 0
    cfg = ScenarioConfig.load(args.config)
    results = launch(cfg, args.config, platform=args.platform,
                     nodes_per_proc=args.nodes_per_proc,
                     max_restarts=args.max_restarts)
    print(json.dumps({"nodes": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
