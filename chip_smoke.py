"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--out DIR]

Needs one CUDA card (it exits non-zero, printing no result, without
one, or when run outside a checkout of this repository). Phases:

1. Device: the card's name and power limit; the kernels are built from
   ``p2pfl_tpu_torch/ops/csrc`` (the build time is printed).
2. Kernels: each hand-written kernel (K1 stream_gemm, K2 stream_wgrad,
   K3 dense_bwd, K4 sgd_accum) at the FEMNIST-CNN shapes of 8 nodes x
   336 samples, held against its plain PyTorch version on the same
   inputs with a stated tolerance, and timed with CUDA events beside the
   plain version, one PyTorch library call, and the card's bound.
3. End to end: the port's ``Scenario`` on the full-width FEMNIST CNN,
   8 nodes on a ring, DFL, FedAvg, bf16 wire, 750 samples a node,
   batch 336, 3 rounds on the seeded synthetic surrogate. The launch
   counts are zeroed just before and read just after: every kernel must
   have run. One training step is then run through the kernels and
   through the plain versions from the same state and compared, and one
   more round is traced with ``torch.profiler`` (device time by
   operation, the device's busy share).
4. One JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true,
   "device": {...}}``. With ``--out DIR`` the per-instance kernel
   numbers and the profile are also written there as JSON.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
N_NODES, BATCH = 8, 336

# published peaks (NVIDIA data sheets, dense): bytes/s, bf16 FLOP/s,
# f32 (non-tensor) FLOP/s; the SKU is read from the card's name
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100": (3.35e12, 989e12, 67e12),  # SXM
    "H200": (4.8e12, 989e12, 67e12),
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def peaks(name: str) -> tuple[float, float, float]:
    for key in ("H100 PCIe", "H200", "H100"):
        if key in name:
            return PEAKS[key]
    return PEAKS["H100"]


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of one call, by CUDA events over ``reps`` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def within(got, want, rtol: float, atol: float) -> tuple[float, bool]:
    """(max |got - want|, all |got - want| <= atol + rtol |want|)."""
    d = (got.float() - want.float()).abs()
    ok = bool((d <= atol + rtol * want.float().abs()).all())
    return float(d.max()), ok


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_checks(dev, peak) -> dict:
    """Per-instance checks and timings; returns per-kernel aggregates."""
    import torch

    from p2pfl_tpu_torch.ops import gemm

    bw, bf16_peak, f32_peak = peak
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def bound(nbytes, flops, fpeak):
        t_b, t_f = nbytes / bw * 1e3, flops / fpeak * 1e3
        return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")

    n, b = N_NODES, BATCH
    m1, m2 = b * 28 * 28, b * 14 * 14
    rows = []

    def record(kernel, inst, err, ok, tol, ms, plain_ms, lib_ms, nbytes,
               flops, fpeak, on_path=True):
        bms, by = bound(nbytes, flops, fpeak)
        rows.append(dict(kernel=kernel, instance=inst, max_abs_err=err,
                         ok=ok, tol=tol, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bms, bound_by=by,
                         bytes=nbytes, flops=flops, on_path=on_path))
        print(f"  {kernel:13s} {inst:12s} max_abs_err={err:.3g} ({tol}) "
              f"{'ok' if ok else 'FAIL'}  kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  library {lib_ms:.4f} ms  bound "
              f"{bms:.4f} ms ({by})", flush=True)

    # K1 stream_gemm: bf16 out, one bf16 ulp of an f32 sum
    k1_tol = dict(rtol=2.0 ** -7, atol=1e-2)
    for inst, (m, k, nn_), on_path in [("conv1_fwd", (m1, 25, 32), True),
                                       ("conv1_dgrad", (m1, 32, 25), False),
                                       ("conv2_fwd", (m2, 800, 64), True)]:
        x, w = rand(n, m, k), rand(n, k, nn_)
        got = gemm.stream_gemm(x, w)
        err, ok = within(got, gemm.stream_gemm_plain(x, w), **k1_tol)
        record("stream_gemm", inst, err, ok, k1_tol,
               time_ms(lambda: gemm.stream_gemm(x, w)),
               time_ms(lambda: gemm.stream_gemm_plain(x, w)),
               time_ms(lambda: torch.bmm(x, w)),
               2 * n * (m * k + k * nn_ + m * nn_), 2 * n * m * k * nn_,
               bf16_peak, on_path)
        del x, w, got

    # K2 stream_wgrad: f32 sums over M rows in another order
    k2_tol = dict(rtol=1e-4, atol=1e-2)
    for inst, (m, k, nn_) in [("conv1_wgrad", (m1, 25, 32)),
                              ("conv2_wgrad", (m2, 800, 64))]:
        x, g = rand(n, m, k), rand(n, m, nn_)
        got = gemm.stream_wgrad(x, g)
        again = gemm.stream_wgrad(x, g)
        if not torch.equal(got, again):
            fail(f"stream_wgrad {inst} is not deterministic")
        err, ok = within(got, gemm.stream_wgrad_plain(x, g), **k2_tol)
        xt = x.transpose(1, 2)
        record("stream_wgrad", inst, err, ok, k2_tol,
               time_ms(lambda: gemm.stream_wgrad(x, g)),
               time_ms(lambda: gemm.stream_wgrad_plain(x, g)),
               time_ms(lambda: torch.bmm(xt, g)),
               2 * n * (m * k + m * nn_) + 4 * n * k * nn_,
               2 * n * m * k * nn_, bf16_peak)
        del x, g, got, again, xt

    # K3 dense_bwd: bf16 outputs, as K1
    d_in, h = 3136, 2048
    x, w, g = rand(n, b, d_in), rand(n, d_in, h), rand(n, b, h)
    dx, dw = gemm.dense_bwd(x, w, g)
    pdx, pdw = gemm.dense_bwd_plain(x, w, g)
    e1, ok1 = within(dx, pdx, **k1_tol)
    e2, ok2 = within(dw, pdw, **k1_tol)
    wt, xt = w.transpose(1, 2), x.transpose(1, 2)
    record("dense_bwd", "dense1_bwd", max(e1, e2), ok1 and ok2, k1_tol,
           time_ms(lambda: gemm.dense_bwd(x, w, g)),
           time_ms(lambda: gemm.dense_bwd_plain(x, w, g)),
           time_ms(lambda: (torch.bmm(g, wt), torch.bmm(xt, g))),
           2 * n * (2 * b * d_in + 2 * d_in * h + b * h),
           4 * n * b * d_in * h, bf16_peak)
    del x, w, g, dx, dw, pdx, pdw, wt, xt

    # K4 sgd_accum over every FEMNIST-CNN leaf, f32 trace; nodes 1, 3,
    # 5, 7 gated off (lr 0) must keep their params bit for bit
    shapes = {"Conv_0.kernel": (5, 5, 1, 32), "Conv_0.bias": (32,),
              "Conv_1.kernel": (5, 5, 32, 64), "Conv_1.bias": (64,),
              "Dense_0.kernel": (3136, 2048), "Dense_0.bias": (2048,),
              "Dense_1.kernel": (2048, 62), "Dense_1.bias": (62,)}
    lr = torch.tensor([0.05, 0.0] * (n // 2), device=dev)
    off = lr == 0
    # explicit roundings in the kernel: the same bits are expected; the
    # check allows 4 f32 ulp
    k4_tol = dict(rtol=4 * 2.0 ** -23, atol=0.0)
    for inst, shp in shapes.items():
        p, m, gr = (rand(n, *shp, dtype=torch.float32) for _ in range(3))
        kp, km = gemm.sgd_accum(p, m, gr, lr, momentum=0.9)
        pp, pm = gemm.sgd_accum_plain(p, m, gr, lr, momentum=0.9)
        e_p, ok_p = within(kp, pp, **k4_tol)
        e_m, ok_m = within(km, pm, **k4_tol)
        if not torch.equal(kp[off], p[off]):
            fail(f"sgd_accum {inst}: gate 0 changed the params")
        numel = p.numel()
        flat = [t.reshape(n, -1) for t in (p, gr, m)]
        record("sgd_accum", inst, max(e_p, e_m), ok_p and ok_m, k4_tol,
               time_ms(lambda: gemm.sgd_accum(p, m, gr, lr, momentum=0.9)),
               time_ms(lambda: gemm.sgd_accum_plain(p, m, gr, lr,
                                                    momentum=0.9)),
               time_ms(lambda: torch._fused_sgd_(
                   [flat[0]], [flat[1]], [flat[2]], weight_decay=0.0,
                   momentum=0.9, lr=0.05, dampening=0.0, nesterov=False,
                   maximize=False, is_first_step=False)),
               20 * numel, 4 * numel, f32_peak)
        del p, m, gr, kp, km, pp, pm, flat
    # the bf16 trace variant on the largest leaf
    p, gr = (rand(n, 3136, 2048, dtype=torch.float32) for _ in range(2))
    m = rand(n, 3136, 2048)
    kp, km = gemm.sgd_accum(p, m, gr, lr, momentum=0.9)
    pp, pm = gemm.sgd_accum_plain(p, m, gr, lr, momentum=0.9)
    if not (torch.equal(kp, pp) and torch.equal(km, pm)):
        fail("sgd_accum with a bf16 trace differs from its plain version")
    if not torch.equal(kp[off], p[off]):
        fail("sgd_accum (bf16 trace): gate 0 changed the params")
    del p, gr, m, kp, km, pp, pm
    torch.cuda.empty_cache()

    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail("kernels outside tolerance: " + ", ".join(
            f"{r['kernel']}/{r['instance']}" for r in bad))
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path, and one step through the plain versions
# ---------------------------------------------------------------------------


def smoke_config():
    from p2pfl_tpu_torch.config.schema import (
        DataConfig,
        ModelConfig,
        ScenarioConfig,
        TrainingConfig,
    )

    return ScenarioConfig(
        name="femnist-cnn-ring-8",
        federation="DFL",
        topology="ring",
        n_nodes=N_NODES,
        data=DataConfig(dataset="femnist", samples_per_node=750,
                        batch_size=BATCH, seed=0),
        model=ModelConfig(model="femnist-cnn"),
        training=TrainingConfig(rounds=3, epochs_per_round=1,
                                learning_rate=0.05),
        transport="dense",
        wire_dtype="bf16",
        seed=0,
    )


def plain_step(model, state, bx, by, bm, lr: float, momentum: float):
    """One SGD step of the FEMNIST CNN through the plain versions of
    the kernels, by name — the reference the kernel path is held to."""
    import torch

    from p2pfl_tpu_torch.core.pytree import tree_leaves, tree_unflatten
    from p2pfl_tpu_torch.learning.objectives import cross_entropy_loss
    from p2pfl_tpu_torch.models.base import dense, node_bias
    from p2pfl_tpu_torch.models.cnn import max_pool_2x2, patches
    from p2pfl_tpu_torch.ops import gemm

    class PlainConv(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(x, w)
            return gemm.stream_gemm_plain(x, w)

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            dx = None
            if ctx.needs_input_grad[0]:
                dx = torch.matmul(g.float(),
                                  w.float().transpose(1, 2)).to(x.dtype)
            return dx, gemm.stream_wgrad_plain(x, g).to(w.dtype)

    class PlainDense(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(x, w)
            return torch.matmul(x.float(), w.float()).to(x.dtype)

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            return gemm.dense_bwd_plain(x, w, g.to(x.dtype))

    dt = model.dtype

    def forward(params, x):
        p = params["params"]
        if x.dim() == 4:
            x = x[..., None]
        x = x.to(dt)
        for i in range(len(model.channels)):
            kern = p[f"Conv_{i}"]["kernel"]
            n, b, h, w, c = x.shape
            k, f = kern.shape[1], kern.shape[-1]
            wf = kern.to(dt).permute(0, 3, 1, 2, 4).reshape(n, c * k * k, f)
            y = PlainConv.apply(patches(x, k), wf).reshape(n, b, h, w, f)
            y = y + node_bias(p[f"Conv_{i}"]["bias"], dt, y.dim())
            x = max_pool_2x2(torch.relu(y))
        x = x.reshape(x.shape[0], x.shape[1], -1)
        d0 = p["Dense_0"]
        x = PlainDense.apply(x, d0["kernel"].to(dt))
        x = torch.relu(x + node_bias(d0["bias"], dt, x.dim()))
        return dense(x, p["Dense_1"], dt).float()

    leaves = [t.detach().requires_grad_(True)
              for t in tree_leaves(state.params)]
    params = tree_unflatten(state.params, leaves)
    loss = cross_entropy_loss(forward(params, bx), by, bm)
    grads = torch.autograd.grad(loss.sum(), leaves)
    n = leaves[0].shape[0]
    lrv = torch.full((n,), lr, device=leaves[0].device)
    new = [gemm.sgd_accum_plain(p.detach(), m, g, lrv, momentum=momentum)
           for p, m, g in zip(leaves, tree_leaves(state.opt_state), grads)]
    return loss.detach(), [pm[0] for pm in new]


def end_to_end(dev):
    import torch

    from p2pfl_tpu_torch.core.pytree import tree_leaves, tree_param_count
    from p2pfl_tpu_torch.federation.scenario import Scenario
    from p2pfl_tpu_torch.ops import gemm

    cfg = smoke_config()
    t0 = time.perf_counter()
    sc = Scenario(cfg, device=dev)
    print(f"  setup {time.perf_counter() - t0:.1f} s (data, init); "
          f"{tree_param_count(sc.fed.states.params) // N_NODES} params a node", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    gemm.reset_launches()
    res = sc.run()
    torch.cuda.synchronize(dev)
    launches = dict(gemm.launches)
    losses = [float(sum(h["train_loss"]) / len(h["train_loss"]))
              for h in res.history]
    for h, loss in zip(res.history, losses):
        print(f"  round {h['round'] + 1}: {h['round_time_s']:.3f} s wall, "
              f"mean train loss {loss:.4f}, mean test accuracy "
              f"{h['eval']['mean_accuracy']:.4f}", flush=True)
    peak_mem = torch.cuda.max_memory_allocated(dev)
    print(f"  final mean accuracy {res.final_accuracy:.4f}; "
          f"max_memory_allocated {peak_mem / 2**30:.2f} GiB; "
          f"launches {launches}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite train loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train loss did not fall: {losses}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

    # one step, kernels vs plain, from the trained state
    st = sc.fed.states
    x, y, mask, _ = sc._data_args
    bx, by, bm = x[:, :BATCH], y[:, :BATCH], mask[:, :BATCH]
    k_state, k_loss = sc.fns.train_step(st, bx, by, bm)
    p_loss, p_params = plain_step(sc.model, st, bx, by, bm,
                                  cfg.training.learning_rate,
                                  cfg.training.momentum)
    loss_err = float((k_loss - p_loss).abs().max() / p_loss.abs().max())
    upd_err = 0.0
    for p0, pk, pp in zip(tree_leaves(st.params),
                          tree_leaves(k_state.params), p_params):
        uk, up = (pk - p0).float(), (pp - p0).float()
        upd_err = max(upd_err, float((uk - up).norm() / up.norm()))
    print(f"  one step kernels vs plain: loss rel err {loss_err:.3g} "
          f"(tol 1e-2), update rel L2 err {upd_err:.3g} (tol 5e-2)",
          flush=True)
    if loss_err > 1e-2 or upd_err > 5e-2:
        fail("kernel step and plain step disagree")
    return launches, sc


def profile_round(sc, out: pathlib.Path | None) -> None:
    """One more round (and its evaluation) under ``torch.profiler``:
    device time by operation and the device's busy share of the wall
    time (the profiler's own cost inflates the wall)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sc.run(rounds=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: a CPU op's row repeats its kernels' time, and
    # CUPTI's own buffer records are no work of the program
    cupti = {"Activity Buffer Request", "Command Buffer Full",
             "Buffer Flush"}
    ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0 and e.key not in cupti),
                 key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in ops)
    print(f"  profiled round + evaluation: {wall_ms:.1f} ms wall, device "
          f"busy {busy:.1f} ms ({100 * busy / wall_ms:.1f}%)", flush=True)
    for name, ms, count in ops[:15]:
        print(f"    {ms:9.3f} ms {count:6d}x  {name[:90]}", flush=True)
    if out is not None:
        (out / "chip_smoke_profile.json").write_text(json.dumps(
            {"wall_ms": wall_ms, "busy_ms": busy, "ops": ops}, indent=1))


# ---------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="chip_smoke.py")
    parser.add_argument("--out", type=pathlib.Path, default=None,
                        help="also write the detailed numbers here")
    args = parser.parse_args(argv)
    if not (ROOT / "p2pfl_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from p2pfl_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[1] device {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.kernels()
    print(f"    kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    print("[2] kernels vs plain versions (n=8, b=336)", flush=True)
    rows = kernel_checks(dev, peaks(name))

    print("[3] end to end: FEMNIST CNN, 8 nodes, ring, DFL, 3 rounds",
          flush=True)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    launches, sc = end_to_end(dev)
    profile_round(sc, args.out)

    replaces = {
        "stream_gemm": "p2pfl_tpu/ops/pallas_gemm.py:116",
        "stream_wgrad": "p2pfl_tpu/ops/pallas_gemm.py:171",
        "dense_bwd": "p2pfl_tpu/ops/pallas_gemm.py:249",
        "sgd_accum": "p2pfl_tpu/ops/pallas_gemm.py:384",
    }
    sources = {
        "stream_gemm": "p2pfl_tpu_torch/ops/csrc/stream_gemm.cu",
        "stream_wgrad": "p2pfl_tpu_torch/ops/csrc/stream_wgrad.cu",
        "dense_bwd": "p2pfl_tpu_torch/ops/csrc/dense_bwd.cu",
        "sgd_accum": "p2pfl_tpu_torch/ops/csrc/sgd.cu",
    }
    kernels = []
    for k in replaces:
        # per training step: the sum over the instances the path runs
        mine = [r for r in rows if r["kernel"] == k and r["on_path"]]
        top = max(mine, key=lambda r: r["bound_ms"])
        kernels.append({
            "name": k, "route": "cuda", "source": sources[k],
            "replaces": replaces[k], "launches": launches[k],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "bound_by": top["bound_by"],
            "library_ms": sum(r["library_ms"] for r in mine),
        })
    if args.out is not None:
        (args.out / "chip_smoke_rows.json").write_text(
            json.dumps({"card": smi, "rows": rows}, indent=1))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
