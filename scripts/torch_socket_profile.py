"""Where a socket-plane round's host time goes, on the card or the CPU.

    python scripts/torch_socket_profile.py [--arm socket24|ring]
        [--plane inline|sidecar] [--device cuda|cpu] [--rounds 1]
        [--top 20]

Runs one arm of ``chip_smoke.py`` phase 12 through ``run_simulation``
under ``cProfile``: ``socket24`` is ``bench.py``'s ``_socket24``
uncapped (24 mnist-mlp nodes, every node trains), ``ring`` the
FEMNIST-CNN ring over sockets with f32 wire and phase 12b's protocol.
``--plane sidecar`` runs ``socket24`` on the aggregation sidecar
(phase 13a, ``bench.py``'s ``aggd24u``): the worker process's decode
and fuse are outside the profiled thread, and the result line adds the
sidecar's counters.
It prints the wall time, the frames and bytes the nodes received, the
learners' fit time (the fits run in the loop's executor threads, which
``cProfile`` does not see; the event loop is the profiled thread), and
the loop thread's own time (``tottime``) summed by layer, then its top
functions:

- ``codec``: ``utils/msgpack_codec.py`` (frame headers and envelopes);
- ``envelope``: ``core/serialize.py`` and its CRC32;
- ``session``: ``p2p/session.py`` (FedAvg of partial aggregates) and
  numpy;
- ``node``: ``p2p/node.py`` and ``p2p/protocol.py`` (dispatch, relays,
  the send lanes);
- ``io``: asyncio, selectors and the socket calls;
- ``learner``: ``learning/``, ``models/``, ``ops/`` and torch on the
  loop thread (the fits and ``set_parameters`` run in the executor);
- ``other``.
"""

from __future__ import annotations

import argparse
import cProfile
import pathlib
import pstats
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from p2pfl_tpu_torch.learning.learner import TorchLearner  # noqa: E402
from p2pfl_tpu_torch.p2p.launch import run_simulation  # noqa: E402

LAYERS = (
    ("codec", ("msgpack_codec",)),
    ("envelope", ("core/serialize", "crc32")),
    ("session", ("p2p/session", "numpy", "astype")),
    ("node", ("p2p/node", "p2p/protocol")),
    ("io", ("asyncio", "selectors", "sendmsg", "recv", "socket",
            "bytearray")),
    ("learner", ("learning/", "models/", "ops/", "torch")),
)


def layer(key) -> str:
    where = f"{key[0]}:{key[2]}"
    for name, marks in LAYERS:
        if any(m in where for m in marks):
            return name
    return "other"


def config(arm: str, rounds: int, plane: str = "inline"):
    if arm == "socket24":
        cfg = cs.socket24_config(24, rounds=rounds)
        cfg.aggregation_plane = plane
        return cfg
    if plane != "inline":
        raise SystemExit("the sidecar runs on a full mesh: --arm socket24")
    cfg = cs.ring_config("socket-ring-f32", rounds=rounds)
    cfg.wire_dtype = "f32"
    cfg.protocol = cs.socket_protocol(0, **cs.RING_PROTOCOL)
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arm", choices=("socket24", "ring"), default="socket24")
    ap.add_argument("--plane", choices=("inline", "sidecar"),
                    default="inline")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        print(cs.subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
        from p2pfl_tpu_torch.ops import _build

        # the kernels' build (or load) before the profile: a fresh
        # machine's build would read as the loop's "other" time
        t0 = time.perf_counter()
        _build.kernels()
        print(f"kernels built or loaded in {time.perf_counter() - t0:.1f} s")
    fit_s = [0.0]
    fit = TorchLearner.fit

    def timed_fit(ln):
        t0 = time.perf_counter()
        fit(ln)
        fit_s[0] += time.perf_counter() - t0

    TorchLearner.fit = timed_fit
    nodes: list = []
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    res = run_simulation(config(args.arm, args.rounds, args.plane),
                         timeout=600,
                         device=torch.device(args.device), nodes_out=nodes)
    prof.disable()
    wall = time.perf_counter() - t0
    st = pstats.Stats(prof)
    by_layer: dict[str, float] = {}
    for key, (_, _, tt, _, _) in st.stats.items():
        by_layer[layer(key)] = by_layer.get(layer(key), 0.0) + tt
    loop_s = sum(by_layer.values())
    aggd = {k: v for k, v in res.items() if k.startswith("aggd_")}
    print(f"{args.arm} ({args.plane}) on {args.device}, {args.rounds} "
          f"round(s) under cProfile: {wall:.3f} s wall (setup included), "
          f"round_s {res['round_s']}, bytes in {res['bytes_in']}, loop "
          f"payload bytes {res['loop_payload_touch_bytes']} {aggd}, fits "
          f"{sum(len(nd.learner.train_losses) for nd in nodes)} taking "
          f"{fit_s[0]:.3f} s in the executor")
    print(f"loop thread: {loop_s:.3f} s of profiled time: " + ", ".join(
        f"{k} {v:.3f} s ({100 * v / loop_s:.1f}%)"
        for k, v in sorted(by_layer.items(), key=lambda kv: -kv[1])))
    st.sort_stats("tottime").print_stats(args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
