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
``launch`` raises, unless ``--max-restarts N`` makes the parent a
supervisor: a child group that exits non-zero is spawned again with
``--resume`` (each node adopts its own checkpoint, or a peer's newer
STATE_SYNC), after ``restart_backoff_s * 2^(attempt - 1)`` seconds
capped at 30, up to N times a group.

The scenario's transport and privacy layers reach every node: its
``network`` shaping and partition windows, ``privacy.secagg`` (pair
secrets by ECDH over the scenario's certificates where there are any,
else from the seed), ``aggregation_plane="sidecar"`` (one
``aggd.SidecarClient`` a process) and ``encrypt``: ``launch`` mints a
scenario CA and the nodes' certificates in ``tls/`` beside the config
and hands the children ``--tls-dir``; ``run_simulation`` mints them in
a temporary directory.

The adversarial and elastic layers reach every node from the config
alone, so every process derives the same cohort, noise and secrets:
the ``adversary`` block (the malicious cohort's attack, a label-flipped
shard, one ``ReputationMonitor`` a node), ``privacy.dp`` (a ``DPSpec``
keyed by the scenario's seed), ``elastic`` (async quorum, stragglers),
``checkpoint_dir`` / ``checkpoint_every`` (each node's own file). In
``run_simulation`` the scenario's ``faults`` drive real nodes: a crash
tears a node down without STOP, a join or recover builds a fresh node
that enters through the "jr" hello and STATE_SYNC, a restart does so
from its own checkpoint (``resume``), and partition and heal cut and
mend every live node's links. Each fires when the federation's round
front (the largest round of a live node) reaches the fault's round, not
on a clock. The result's ``churn`` holds what happened, under the JAX
package's keys; with reputation, ``trust`` and ``suspects`` hold each
node's own view.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import json
import math
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from p2pfl_tpu_torch.adversary.attacks import (
    AttackSpec,
    flip_labels,
    malicious_indices,
)
from p2pfl_tpu_torch.adversary.reputation import ReputationMonitor
from p2pfl_tpu_torch.config.schema import ScenarioConfig
from p2pfl_tpu_torch.core.aggregators import get_aggregator
from p2pfl_tpu_torch.datasets.data import FederatedDataset
from p2pfl_tpu_torch.device import resolve_device
from p2pfl_tpu_torch.learning.learner import SharedTrainer, TorchLearner
from p2pfl_tpu_torch.learning.lora import maybe_wrap_lora
from p2pfl_tpu_torch.models.base import build_model
from p2pfl_tpu_torch.p2p.aggd import SidecarClient
from p2pfl_tpu_torch.p2p.node import P2PNode
from p2pfl_tpu_torch.privacy.dp import DPSpec, epsilon_at
from p2pfl_tpu_torch.topology.topology import generate_topology
from p2pfl_tpu_torch.utils.monitor import publish_status


#: a rejoining node's dial to one neighbour, the hello's answer included
_DIAL_S = 10.0


def _adversary_setup(cfg: ScenarioConfig):
    """``(malicious mask, AttackSpec or None, reputation on)`` from the
    config alone: every process computes the same cohort."""
    adv = cfg.adversary
    if not (adv.active or adv.reputation):
        return None, None, False
    mask = (malicious_indices(cfg.n_nodes, adv.fraction, adv.seed,
                              tuple(adv.nodes))
            if adv.active else np.zeros(cfg.n_nodes, bool))
    spec = (AttackSpec(kind=adv.kind, scale=adv.scale, seed=adv.seed)
            if adv.active else None)
    return mask, spec, adv.reputation


def _poison_shard(data: FederatedDataset, idx: int) -> None:
    """Label-flip poisoning of one node's train shard (the stacked plane
    flips the same rows)."""
    nd = data.nodes[idx]
    data.nodes[idx] = dataclasses.replace(
        nd, y=flip_labels(nd.y, data.num_classes))


def _node_adversary_kwargs(cfg: ScenarioConfig, idx: int,
                           data: FederatedDataset, setup) -> dict:
    """Node ``idx``'s ``attack`` and ``reputation`` (and, for a
    label-flipper, its poisoned shard in ``data``)."""
    mask, spec, want_rep = setup
    if mask is None:
        return {}
    if spec is not None and spec.kind == "labelflip" and mask[idx]:
        _poison_shard(data, idx)
    out: dict = {"attack": spec if (spec is not None and mask[idx])
                 else None}
    if want_rep:
        # one monitor a node: trust is each node's own view
        out["reputation"] = ReputationMonitor(
            cfg.n_nodes, alpha=cfg.adversary.reputation_alpha,
            cutoff=cfg.adversary.reputation_cutoff)
    return out


def _privacy_status(cfg: ScenarioConfig, round_num: int) -> dict:
    """DP's spend for a status record: epsilon is a function of the
    config and the rounds done, the same in every process."""
    priv = cfg.privacy
    if not priv.dp:
        return {}
    eps = epsilon_at(priv.noise_multiplier, int(round_num), priv.delta)
    return {"dp_epsilon": round(eps, 4) if math.isfinite(eps) else eps,
            "dp_epsilon_budget": priv.epsilon_budget}


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
    """Node ``idx``'s ``tls``, ``dp`` and ``masker`` from the config (and
    the TLS directory) alone, so every process derives the same noise
    streams and secrets."""
    out: dict = {}
    priv = cfg.privacy
    if priv.dp:
        out["dp"] = DPSpec(clip_norm=priv.clip_norm,
                           noise_multiplier=priv.noise_multiplier,
                           seed=cfg.seed)
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
        local_epochs=cfg.nodes[i].epochs, netem=cfg.network,
        checkpoint_dir=cfg.checkpoint_dir,
        checkpoint_every=cfg.checkpoint_every, **kw)


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


def _status(cfg: ScenarioConfig, node: P2PNode) -> dict:
    out = {"role": node.role, "round": node.round,
           "peers": len(node.peers), "leader": node.leader,
           "round_p95_s": node.round_p95_s(),
           "bytes_in": node.bytes_in, "bytes_out": node.bytes_out,
           "peer_bytes_in": dict(node.peer_bytes_in),
           "peer_bytes_out": dict(node.peer_bytes_out),
           "recompiles": 0, **_privacy_status(cfg, node.round),
           **_aggd_status(node.sidecar)}
    if node.reputation is not None:
        out["trust"] = float(node.reputation.trust[node.idx])
    return out


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
                    sidecar: SidecarClient | None = None,
                    resume: bool = False) -> dict:
    """One node's whole life in a child process. ``resume`` is the
    supervisor's restart: the node adopts its own checkpoint and enters
    the running federation through the "jr" hello and STATE_SYNC."""
    n = cfg.n_nodes
    hosts = hosts or ["127.0.0.1"] * n
    node = _node(cfg, idx, data, shared, device, host=bind, port=ports[idx],
                 sidecar=sidecar, resume=resume, joiner=resume,
                 **_node_adversary_kwargs(cfg, idx, data,
                                          _adversary_setup(cfg)),
                 **_node_layers(cfg, idx, tls_dir))
    learner = node.learner
    await node.start()
    topo = generate_topology(cfg.topology, n, **cfg.topology_kwargs)
    # dial the higher-index neighbours (retrying until they listen); the
    # lower-index ones dial this node. A relaunch dials every neighbour:
    # the running nodes dialled it long ago
    for j in topo.neighbors(idx):
        if j < idx and not resume:
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
                publish_status(status_dir, idx, _status(cfg, node))
                await asyncio.sleep(cfg.protocol.heartbeat_period_s)

        status_task = asyncio.get_running_loop().create_task(_publish_loop())
    # the kernels and the device's handles before the round clock starts
    await asyncio.get_running_loop().run_in_executor(None, learner.warm_up)
    if cfg.nodes[idx].start and not resume:
        # a relaunch never starts the federation again: it joins it
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
        publish_status(status_dir, idx, {**_status(cfg, node), **metrics})
    result = {"node": idx, "round": node.round,
              "round_p95_s": node.round_p95_s(),
              "bytes_in": node.bytes_in, "bytes_out": node.bytes_out,
              "params_bytes_out": node.params_bytes_out,
              "floods_dropped": node.floods_dropped, **metrics,
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
              tls_dir: str | None = None, resume: bool = False) -> None:
    """A child process: the nodes ``idx`` (one or a list) on one event
    loop, one ``P2PFL_RESULT`` line each."""
    idxs = [idx] if isinstance(idx, int) else list(idx)
    cfg = ScenarioConfig.load(config_path)
    dev = resolve_device(device)
    data = FederatedDataset.make(cfg.data, cfg.n_nodes)  # the same shards
    shared = _shared_trainer(cfg, data, dev)
    sidecar = _sidecar_for(cfg, len(idxs))

    async def _run_all() -> list[dict]:
        return list(await asyncio.gather(*(
            _run_node(cfg, i, ports, data, shared, dev, hosts=hosts,
                      bind=bind, tls_dir=tls_dir, sidecar=sidecar,
                      resume=resume)
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
    n = cfg.n_nodes
    data = FederatedDataset.make(cfg.data, n)
    topo = generate_topology(cfg.topology, n, **cfg.topology_kwargs)
    shared = _shared_trainer(cfg, data, device)
    adv_setup = _adversary_setup(cfg)
    # a label-flipped shard is in place before its learner is built
    adv_kwargs = [_node_adversary_kwargs(cfg, i, data, adv_setup)
                  for i in range(n)]
    nodes.extend(_node(cfg, i, data, shared, device, sidecar=sidecar,
                       **adv_kwargs[i], **_node_layers(cfg, i, tls_dir))
                 for i in range(n))
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
                    if not nd._crashed:  # a dead node's record ages out
                        publish_status(status_dir, nd.idx, _status(cfg, nd))
                await asyncio.sleep(cfg.protocol.heartbeat_period_s)

        status_task = asyncio.create_task(_status_loop())

    # scripted churn: a crash kills a real node, a join, recover or
    # restart builds a fresh one in its slot that enters the running
    # federation through the "jr" hello and STATE_SYNC
    joined: list[int] = []
    restarted: list[int] = []

    async def _rejoin_node(i: int, resume: bool = False) -> None:
        nd = _node(cfg, i, data, shared, device, sidecar=sidecar,
                   joiner=True, resume=resume, **{
                       **adv_kwargs[i],
                       # a fresh masker derives the same pair streams
                       **_node_layers(cfg, i, tls_dir)})
        nodes[i] = nd
        await nd.start()
        (restarted if resume else joined).append(i)
        # off the loop: on the card it waits for the device's lock, which
        # the running nodes' fits take in turn
        await asyncio.get_running_loop().run_in_executor(
            None, nd.learner.warm_up)

        # every neighbour, a finished one too: it answers with its final
        # model and round, and a joiner late for the whole run finishes
        # at once (a crashed one refuses the dial, or never answers)
        for j in topo.neighbors(i):
            if nodes[j] is not nd:
                with contextlib.suppress(OSError, asyncio.TimeoutError):
                    await asyncio.wait_for(
                        nd.connect_to(nodes[j].host, nodes[j].port),
                        timeout=_DIAL_S)

    fault_task = None
    watch_tasks: list[asyncio.Task] = []
    # rejoins run beside the driver: a node coming back takes seconds
    # (its warm-up, a dial to each neighbour), and one after another the
    # last of a round's joins could land after the run ended
    join_tasks: list[asyncio.Task] = []
    recovery: dict = {"partitions": 0, "heals": 0}

    def _live() -> list[P2PNode]:
        return [nd for nd in nodes if not nd.finished.is_set()]

    async def _recovery_watch(t_heal: float, at_heal: dict[int, int]) -> None:
        # heal to the first round every live node began after the heal
        while True:
            live = _live()
            if not live or all(nd.round > at_heal.get(nd.idx, -1)
                               for nd in live):
                break
            await asyncio.sleep(0.05)
        recovery["recovery_s"] = round(time.monotonic() - t_heal, 3)

    async def _fault_driver() -> None:
        for f in sorted(cfg.faults, key=lambda f: (f.round, f.node)):
            # on the round front, not a clock: a fault for round r fires
            # once a live node has reached round r
            while True:
                live = _live()
                if not live:
                    return  # the federation is over
                if max(nd.round for nd in live) >= f.round:
                    break
                await asyncio.sleep(0.05)
            if f.kind == "crash":
                await nodes[f.node].crash()
            elif f.kind == "partition":
                recovery["partitions"] += 1
                for nd in _live():  # the same cut everywhere: symmetric
                    nd.apply_partition(f.groups)
            elif f.kind == "heal":
                recovery["heals"] += 1
                at_heal = {nd.idx: nd.round for nd in _live()}
                for nd in _live():
                    nd.heal_partition()
                watch_tasks.append(asyncio.create_task(
                    _recovery_watch(time.monotonic(), at_heal)))
            else:  # restart (from the node's checkpoint), join, recover
                join_tasks.append(asyncio.create_task(
                    _rejoin_node(f.node, resume=f.kind == "restart")))

    if cfg.faults:
        fault_task = asyncio.create_task(_fault_driver())

    async def _all_finished() -> None:
        # a join puts a new node in its slot: poll the list
        while not all(nd.finished.is_set() for nd in nodes):
            await asyncio.sleep(0.1)

    t0 = time.monotonic()
    nodes[starter].set_start_learning(cfg.training.rounds,
                                      cfg.training.epochs_per_round)
    try:
        await asyncio.wait_for(_all_finished(), timeout=timeout)
    finally:
        wall = time.monotonic() - t0
        for task in (fault_task, status_task, *join_tasks):
            if task is not None and not task.done():
                task.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await task
        for wt in watch_tasks:
            # one tick for a pending watch to see the finished run
            with contextlib.suppress(asyncio.TimeoutError,
                                     asyncio.CancelledError):
                await asyncio.wait_for(wt, timeout=0.5)
        for node in nodes:
            await node.stop()
    for task in (fault_task, *join_tasks):
        if (task is not None and not task.cancelled()
                and task.exception() is not None):
            raise RuntimeError("a scripted fault failed") from task.exception()
    _raise_failed(nodes)
    if status_dir is not None:
        for nd in nodes:
            publish_status(status_dir, nd.idx, _status(cfg, nd))
    accs = [m.get("accuracy") for m in
            (nd.peer_metrics.get(nd.idx) or {} for nd in nodes)
            if m.get("accuracy") is not None]
    out = {
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
        # beats and roles read loops dropped on full lanes
        "floods_dropped": sum(nd.floods_dropped for nd in nodes),
        **_sidecar_result(sidecar),
    }
    el = cfg.elastic
    if cfg.faults or el.active:
        out["churn"] = {
            "async": el.async_aggregation,
            "crashes": sorted(f.node for f in cfg.faults
                              if f.kind == "crash"),
            "joined": sorted(joined),
            "restarted": sorted(restarted),
            "stragglers": [i for i in range(n)
                           if cfg.nodes[i].fit_slowdown > 1.0],
        }
        if recovery["partitions"] or recovery["heals"]:
            out["churn"]["partitions"] = recovery["partitions"]
            out["churn"]["heals"] = recovery["heals"]
            if "recovery_s" in recovery:
                out["churn"]["recovery_s"] = recovery["recovery_s"]
    if any(nd.reputation is not None for nd in nodes):
        # each node's own trust vector, and whom any node would exclude
        out["trust"] = [
            [round(float(t), 4) for t in nd.reputation.trust]
            if nd.reputation is not None else None for nd in nodes]
        out["suspects"] = sorted({s for nd in nodes
                                  if nd.reputation is not None
                                  for s in nd.reputation.suspects()})
    out.update(_privacy_status(cfg, out["rounds"]))
    return out


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
           max_restarts: int = 0, restart_backoff_s: float = 1.0,
           timeout: float = 900) -> list[dict]:
    """Spawn the node processes (``nodes_per_proc`` nodes each) and
    collect their results; raises if a child group fails for good.
    Every group is supervised concurrently; with ``max_restarts`` > 0 a
    group that exits non-zero is spawned again with ``--resume`` after
    the capped exponential backoff (see the module doc)."""
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
    cmds = []
    for group in groups:
        cmd = [sys.executable, "-m", "p2pfl_tpu_torch.p2p.launch",
               str(config_path), "--node", ",".join(map(str, group)),
               "--ports", ",".join(map(str, ports))]
        if platform:
            cmd += ["--platform", platform]
        if tls_dir:
            cmd += ["--tls-dir", tls_dir]
        cmds.append(cmd)
    live: list[subprocess.Popen] = []

    def spawn(cmd: list[str]) -> subprocess.Popen:
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, env=env)
        live.append(p)
        return p

    procs = [spawn(cmd) for cmd in cmds]
    t_end = time.monotonic() + timeout

    def supervise(gi: int) -> tuple[str, int, int]:
        """One group to its end: (every attempt's output, the last exit
        code, the restarts taken)."""
        p, attempt, chunks = procs[gi], 0, []
        while True:
            out, _ = p.communicate(timeout=max(t_end - time.monotonic(), 1))
            chunks.append(out)
            if p.returncode == 0 or attempt >= max_restarts:
                return "".join(chunks), p.returncode, attempt
            attempt += 1
            time.sleep(restart_backoff_delay(restart_backoff_s, attempt))
            p = spawn(cmds[gi] + ["--resume"])

    try:
        # every group at once: a dead group must come back while its
        # peers are still mid-federation, and no child may block on a
        # full stdout pipe while another group is waited on
        with ThreadPoolExecutor(max_workers=len(groups)) as pool:
            done = list(pool.map(supervise, range(len(groups))))
    finally:
        for p in live:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"nodes {group} exited {rc}:\n" + out[-4000:]
              for group, (out, rc, _) in zip(groups, done) if rc != 0]
    if failed:
        raise RuntimeError("socket federation failed: " + "\n".join(failed))
    results = []
    for group, (out, _rc, restarts) in zip(groups, done):
        for line in out.splitlines():
            if line.startswith("P2PFL_RESULT "):
                result = json.loads(line[len("P2PFL_RESULT "):])
                result["restarts"] = restarts
                results.append(result)
    return results


def restart_backoff_delay(base_s: float, attempt: int) -> float:
    """The supervisor's wait before restart ``attempt`` (1, 2, ...):
    ``base_s * 2^(attempt - 1)``, capped at 30 s."""
    return min(float(base_s) * (2.0 ** (attempt - 1)), 30.0)


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
    ap.add_argument("--resume", action="store_true",
                    help="child mode: adopt each node's own checkpoint and "
                         "join the running federation (the restart path)")
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="parent mode: spawn a dead child group again with "
                         "--resume up to this many times")
    ap.add_argument("--restart-backoff-s", type=float, default=1.0,
                    help="base of the restart backoff (doubling per "
                         "attempt, capped at 30 s)")
    args = ap.parse_args(argv)
    device = args.platform or "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("p2pfl_tpu_torch.p2p.launch: no CUDA device is available; "
              "pass --platform cpu to run on the CPU", file=sys.stderr)
        return 2
    if args.node is not None:
        node_main(args.config, [int(i) for i in str(args.node).split(",")],
                  [int(p) for p in args.ports.split(",")],
                  hosts=args.hosts.split(",") if args.hosts else None,
                  bind=args.bind, device=device, tls_dir=args.tls_dir,
                  resume=args.resume)
        return 0
    cfg = ScenarioConfig.load(args.config)
    results = launch(cfg, args.config, platform=args.platform,
                     nodes_per_proc=args.nodes_per_proc,
                     max_restarts=args.max_restarts,
                     restart_backoff_s=args.restart_backoff_s)
    print(json.dumps({"nodes": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
