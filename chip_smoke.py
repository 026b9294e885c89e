"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--out DIR]

Needs one CUDA card (it exits non-zero, printing no result, without
one, or when run outside a checkout of this repository). Phases:

1. Device: the card's name and power limit; the kernels are built from
   ``p2pfl_tpu_torch/ops/csrc`` (the build time is printed).
2. Kernels: each hand-written kernel (K1 stream_gemm, K2 stream_wgrad,
   K3 dense_bwd, K4 sgd_accum_many, K5 sgd_accum_many(accs=)/
   fedavg_accum_many, K6 fused_mlp_train_epoch) at the shapes of its
   path (8 nodes x 336 FEMNIST-CNN samples; K4 and K5 all 8 leaves at 8
   slots in one call, the path's instance, then each leaf alone; K6 64
   nodes of mnist-mlp at full width, 19 steps of 32 MNIST-surrogate
   rows, plus one step, a shard shorter than a batch and the
   ragged-rows refusal), held against its plain PyTorch version on the
   same inputs with a stated tolerance (K1-K6 also twice, bit for bit;
   K4 and K5 their plain versions' bits, gated-off params unchanged,
   one launch a call; K2 and K3 also at the cross-device (8 x 20) and
   Byzantine (16 x 64) shapes, K2's conv1 and conv2 apart, each with
   its slice plan), and timed with CUDA events beside the plain
   version, one PyTorch library call where there is one (for K2
   ``torch.bmm``, for K4 one ``torch._fused_sgd_`` over all leaves, for
   K5 one ``torch._foreach_addcmul``), and the card's bound, with the
   achieved TB/s and TFLOP/s and the share of the bound; for K1-K6 also
   the host's time to enqueue one call, and for K2, K4, K5 and K6 the
   kernel's own device time from a profiled run (K2's beside
   ``torch.bmm``'s). K6 prints its instantiation (on chip or
   L2-resident), the clusters the card holds at once and its waves.
   K2 in bf16 (exact products, f32 sums) is held to the f32 limits
   below, with the sum missing its plan's first slice and the plain
   version rounded to bf16 as the controls that must fail them; every
   K2 row, bf16 and f32, prints its route, its kernels' device times,
   and the kernel and the plain version against the f64 product, and
   the kernel may be no farther from it than the plain version; every
   K1 row prints its branch.
   The dtype variants: K1, K2 and K3 in f32 (``csrc/gemm_f32_tc.cu``,
   3xTF32 on ``wgmma``; K1 and K2 at K <= 32 exact FMA chains)
   at the ring's shapes, held to relative L2 and elementwise limits that
   scale with the square root of the summed length (``F32_REL_C``,
   ``F32_ELEM_C``), which two controls must fail at each shape (a TF32
   product, and the sum with one slice dropped), twice bit for bit,
   timed beside ``torch.bmm`` in f32 (TF32 off), each against two
   bounds: the least time of an f32-accurate product (three TF32
   passes or the bytes, the bound the kernels line reports) and of
   exact f32 FMA outside the tensor cores; before them the
   accumulation probe (``wgmma`` TF32 sums in one accumulator against
   ``fmaf`` chains on tf32-valued inputs: an exact sum the layout must
   give, and whether the tensor core rounds its sums to nearest or
   truncates them); K4 over the 64-node headline's bf16 leaves (bf16
   params, gradients and trace) and over the one-class SVM's
   ``[8, 17]`` and ``[8]`` leaves, the plain version's bits; K6 with
   bf16 params, trace and inputs at its headline shape: bit for bit
   the f32 kernel on the widened inputs rounded once, from one state
   within the K6 tolerance plus one bf16 ulp of its plain version, and
   over the 19 steps node by node (no node outside the flip bounds:
   ``K6_FLIP_NODES``); K6 from a zero trace at other batches and class
   counts, the leaves off the plain version's bits (``K6_ORDER_SHAPES``).
3. End to end, the stacked federation: the port's ``Scenario`` on the
   full-width FEMNIST CNN, 8 nodes on a ring, DFL, FedAvg, bf16 wire,
   750 samples a node, batch 336, 3 rounds on the seeded synthetic
   surrogate. The launch counts are zeroed just before and read just
   after: every kernel of the path must have run, K4 once a training
   step. One training step is then run through the kernels and
   through the plain versions from the same state and compared, and
   one more round is traced with
   ``torch.profiler`` (device time by operation, the device's busy
   share).
4. End to end, the cross-device round: ``CrossDeviceScenario`` on the
   full-width FEMNIST CNN, 3,550 clients (LEAF FEMNIST's writer count),
   32 sampled a round in 4 cohorts of 8 slots, 20 samples a client,
   3 rounds and an evaluation; launch counts as in phase 3, K5
   included (K4 and K5 once a cohort step); the train loss must fall.
   From the same seed, one streamed round must equal the first
   materialized round bit for bit, and one round in 2 chunks must run
   and stay finite. One more round is
   profiled. Then the JAX package's own cross-device headline shape
   (mnist-mlp, 10,000 clients, 256 a round, cohorts of 32) for 2
   rounds: the second round's wall time and clients per second.
5. The fused-epoch path: 5 epochs of ``fused_mlp_train_epoch`` at K6's
   headline shape, the launch count zeroed before and read after (it
   must be 5); the mean loss must fall below 0.8 of the first epoch's.
6. Byzantine DFL (the JAX bench's robustness configuration): the
   port's ``Scenario`` on the full-width FEMNIST CNN, 16 nodes fully
   connected, DFL, iid, 256 samples a node, batch 64, lr 0.05, bf16
   wire, 4 sign-flippers at scale 10, 3 rounds each under FedAvg (clean
   and attacked), Krum(f=4, m=8), TrimmedMean(beta=4), FedMedian and
   reputation-weighted FedAvg; K1-K4 must launch in every variant (K4
   once a training step), the
   defended params stay finite, reputation must cut off exactly the
   attackers after round 1, and the robust aggregators must reach at
   least the attacked FedAvg's accuracy. One TrimmedMean round on a
   16-node ring runs the per-row branch.
7. The private and elastic federation; every arm zeroes the launch
   counts before it runs and fails unless its path's kernels launched
   (K4 once a training step, K5 once a cohort step):
   a. DP-FedAvg at the JAX bench's ``_phase_private`` shape (FEMNIST
      CNN, 8 nodes fully connected, 256 samples a node, batch 64, lr
      0.05, bf16 wire, clip 1.0, delta 1e-5), clean and at noise 0.3,
      0.6 and 1.0, 10 rounds each: s/round, accuracy and epsilon (equal
      to ``epsilon_at``'s); ``privatize_stacked`` on the trained stack
      (noise 0: every masked row's delta within the clip, unmasked rows
      unchanged; noise 1.0: the same bits twice, mean and std within 5
      standard errors), its device time and kernels, and one profiled
      DP round beside a clean one;
   b. the phase-3 ring, node 3 crashing at round 1 and joining at round
      3 under a 4 s heartbeat and a 3 s timeout, 5 rounds: the alive
      masks the JAX rule gives, the dead row's bits kept, the joiner's
      row equal to the leader's after the copy, the survivors' loss
      falling;
   c. CFL on a star with the server dead from round 0 (leader 1 every
      round) and SDFL with node 2 dead (never the leader), 3 rounds;
   d. the JAX bench's SPMD elastic arm (mnist-mlp, 24 nodes on a ring,
      20% churn, 4x stragglers, 12 rounds), the staleness column off
      and on: rounds to 0.85 and the staleness scale's bits;
   e. the phase-4 cross-device round with clients 0-999 crashing at
      round 0 and joining at round 2: the sampled clients' alive count
      equal to the membership's every round.
8. The learning knobs; every arm zeroes the launch counts before it
   runs and fails unless its path's kernels launched:
   a. the JAX bench's headline (``_phase_headline`` through ``_build``'s
      defaults): FEMNIST CNN, 64 nodes on a ring, DFL, FedAvg, 750
      samples a node, batch 336, lr 0.05, SGD momentum 0.9, bf16 params
      and trace, 3 rounds: s/round and peak memory, K1-K4 launched, K4
      once a step with bf16 params, the loss falling, the params bf16
      and finite, one step against the plain versions;
   b. phase 3's ring with ``compute_dtype`` float32, 3 rounds: only the
      f32 K1-K3 launch; the loss of one step through the kernels against
      the plain versions'; then at three seeds' rings, initial and
      trained, every leaf's gradient through the kernels and through the
      plain f32 versions within ``F32_GRAD_TOL`` of the same step in
      f64, and the plain versions with K1 and K3 one TF32 pass outside;
   c. phase 3's ring with adam (lr 1e-3) and adamw (weight decay 1e-4),
      3 rounds each: K1-K3 launch, K4 does not, the count equals the
      steps; one adam cross-device round at phase 4's shape launches K5;
   d. ``syscall-mlp``, ``syscall-autoencoder``, ``syscall-svm`` and
      ``wadi-mlp`` on their surrogates, 8 nodes fully connected, the JAX
      defaults, 5 rounds each: K4 once a step, the test objective
      falling, accuracy 0.0 for the two objectives that have none;
   e. 5 epochs of K6 with bf16 state at phase 5's shape.
9. The CIFAR10 ResNets and MobileNets (``cifar_models``); every arm
   zeroes the launch counts before it runs and reads them after:
   a. ``bench.py``'s ``_cifar16`` (``BASELINE.json`` configs[2]):
      ResNet9 at full width, 16 nodes, random topology, Dirichlet(0.5)
      shards of the easy CIFAR10 surrogate, 1024 samples a node, batch
      128, lr 0.1, seed 3, for the JAX bench's 32 rounds (a warm-up
      round, then 31, evaluated every 8): s/round, train loss per round
      (it must fall from the first measured round to the last), the
      mean test accuracy (above ``CIFAR_ACC_GATE`` by round 32),
      training peak memory; K1 and K2 only at the stem's K = 27, N = 64
      (K1 once a step plus the evaluations' batches, K2 once a step), K4
      once a step; one step against the plain versions within phase 3's
      limits and twice bit for bit; 2 rounds each with cuDNN's
      deterministic algorithms off and on; one profiled training round
      by kernel bucket (cuDNN convs, GroupNorm's reductions and
      elementwise passes, copies, K1, K2, K4);
   b. resnet18, resnet34, resnet50, fastermobilenet and simplemobilenet
      at full width, cut to 4 nodes and 10 rounds at lr 1e-3 (the deeper
      ResNets' loss rises at 0.1, in JAX too): the loss falling from the
      first round to the last, K4 ``ceil(leaves / 48)`` launches a
      step, no K1-K3, one step against the plain versions and twice bit
      for bit;
   c. a's ResNet9 in f32 compute, one round: ``Scenario`` turns cuDNN's
      TF32 off (and determinism on) after the script turned them the
      other way; only the f32 K1 and K2 launch, at the stem; their
      output on the round's first step's own operands against the f64
      product within the f32 limits, the TF32 product outside them.
   Phase 2 holds K1 and K2 at the stem's shape too (16 nodes x 131,072
   rows, K = 27, N = 64, bf16 and f32), and K4 over ResNet9's 26 leaves
   at 16 nodes and ResNet50's 161 at 4 (one launch and four), bit for
   bit against the list plain version.
10. The round-boundary services on phase 3's ring (``round_services``;
   scratch files in the git-ignored ``.chip_smoke_phase10/``, removed
   at the end):
   a. resume, bit for bit: the ring as DFL and as SDFL with node 3
      crashing at round 1 and joining at round 3 (4 s heartbeat, 3 s
      timeout), 4 rounds with ``checkpoint_every=2``; a fresh
      ``Scenario`` on a directory holding only round 2's file resumes
      and runs 2 rounds. Every param, trace, step, alive mask, round,
      the leaders, train losses, the evaluation and round 4's file must
      equal the uninterrupted run's; the file's MB and one more save
      and load of it in seconds are printed;
   b. logs: with ``log_dir`` and ``profile_dir``, 3 rounds:
      metrics.jsonl's rows a round (``LOG_ROWS_PER_ROUND``), a status
      record an alive node with keys inside ``STATUS_KEYS``, the
      profiled round's Chrome trace naming K1-K4 by their kernels'
      symbols (``TRACE_KERNELS``), its wall time beside an unprofiled
      round's;
   c. the staged exchange, 3 rounds: round 0's params the bits of the
      fit before the mix rounded through the bf16 wire, the loss
      falling, K1-K4 launched as often as in phase 3, s/round staged
      and eager (medians of rounds 2-3).
11. ViT-Tiny and adapter-only federation (``vit_and_lora``); every arm
   zeroes the launch counts before it runs and reads them after:
   a. ``bench.py``'s ``_vit32_inprocess`` (``BASELINE.json`` configs[4]):
      ViT-Tiny at full width and depth with ``remat`` and
      ``scan_layers``, 32 nodes fully connected, DFL, Krum(f=1, m=3)
      (one shared aggregate), iid shards of the easy CIFAR10 surrogate,
      512 samples a node, batch 115, adam at 1e-3, seed 4, 20 rounds:
      s/round (median after the warm-up), training peak memory, the
      train loss per round (it must fall) and the mean test accuracy at
      rounds 10 and 20 (above ``VIT_ACC_GATE`` at 20); no kernel
      launches (adam runs in stock ops);
   b. a's configuration with SGD momentum 0.9 at ``VIT_SGD_LR``, 3
      rounds: K4 once a step and no other kernel; one step from the
      initial state twice bit for bit, K4's result the bits of
      ``sgd_accum_many_plain``'s, the loss and every gradient with and
      without ``remat`` bit for bit (each one's peak memory); one round
      in the unscanned layout (199 leaves), K4 5 times a step; one
      profiled training round by the model's ``record_function`` scopes
      (linear, attention, LayerNorm, GELU), K4 and the rest;
   c. ``bench.py``'s ``_phase_lora`` shape: 16 nodes, 256 samples a
      node, batch 64, the full-weight arm and the rank-8 q/v adapter arm
      (``lora.rank`` 8) from one base, 5 rounds each at ``LORA_LR``, K4
      once a step in both (23 leaves, and the 4 adapter leaves): the
      merged round-0 model equal to the full arm's round 0 bit for bit,
      the loss falling, s/round and bytes a round of both and their
      ratio.
   Phase 2 holds K4 over the scanned ViT's 23 leaves at 32 nodes and
   over the adapter tree's 4 at 16 too.
12. The socket plane (``socket_plane``; ``p2pfl_tpu_torch.p2p``): every
   arm zeroes the launch counts before it runs and reads them after;
   every node must finish every round with its learner's tensors on the
   card:
   a. ``bench.py``'s ``_socket24`` through ``run_simulation``: 24
      mnist-mlp nodes fully connected, 60 samples a node, 3 rounds,
      0.5 s heartbeats, 60 s aggregation and 10 s vote timeouts, gossip
      fan-out 12, ``train_set_size`` 8 and then 24: K4 once a training
      step of every fit, no K1-K3; s/round, bytes in and out, mean
      accuracy;
   b. phase 3's ring (``BASELINE.json`` configs[1]) over sockets, f32
      and bf16 wire, 3 rounds: K1-K4 launched as often a step as one
      kernel step launches them (K2-K4 as phase 3's), times the steps
      of all fits, plus the final evaluations' K1; the mean fit loss
      falling from round 1 to 3 and node 0's accuracy rising from its
      first fit's starting weights; node 0's first fit replayed from
      its recorded state through the kernels (the fit's bits) and
      through the plain versions, within ``check_step_vs_plain``'s
      tolerance;
   c. ``python -m p2pfl_tpu_torch.p2p.launch`` with 4 child processes
      on the card (mnist-mlp, 2 rounds): every child's result names the
      card; the parent's JSON is printed.
13. The socket plane's transport and privacy layers
   (``transport_layers``; ``p2p/aggd.py``, ``p2p/netem.py``,
   ``p2p/tls.py``, ``privacy/secagg.py``): every arm zeroes the launch
   counts before it runs and reads them after, and every node must
   finish every round with its learner's tensors on the card:
   a. ``bench.py``'s ``aggd24u``: 12a's uncapped ``_socket24`` on the
      aggregation sidecar (12a's uncapped run is its inline arm): no
      payload byte decoded on the loop (12a's > 0), no fallback, at
      least rounds x nodes fuses, bytes in the arena, K4 once a step and
      no K1-K3; the worker listed by no ``nvidia-smi`` compute query and
      holding no ``/dev/nvidia*`` file while it runs; the arena's name
      gone from ``/dev/shm`` after the attach and after close; node 0's
      first fuse ``fuse_numpy``'s bits on the same envelopes; s/round,
      bytes and accuracy beside 12a's;
   b. ``bench.py``'s ``private8`` (8 mnist-mlp nodes fully connected, 3
      rounds), plain and under secure aggregation (seeded pair
      secrets): every round closes, node 0's first unmasked aggregate is
      the plain weighted sum of the same quantized updates bit for bit,
      K4 once a step; s/round of both and the masking's overhead;
   c. 12b's FEMNIST-CNN ring over sockets (f32 wire, 3 rounds) on links
      of 50 ± 10 ms and 5% loss (seed 9) with a 4 s partition window
      {0-3} | {4-7} opening 0.5 s after the last node enters round 2
      (its plan clock is pinned then): every node finishes
      every round, the shapers drop to loss and on the cut, none on the
      cut after the heal, both edges inside round 2, K1-K4 as often a
      step as in 12b, the mean fit loss falling;
   d. 4 mnist-mlp nodes in one loop under mutual TLS (``encrypt``), 2
      rounds, then with secure aggregation on ECDH pair secrets: every
      round closes, nodes 0 and 2 agree within rtol 1e-4, atol 1e-5, K4
      once a step; without ``cryptography`` the arm prints ``tls: not
      run: no module named cryptography on this machine`` before the
      card's line.
14. One JSON line ``{"kernels": [...]}`` (the six kernels and the five
   dtype variants) and, last, ``{"ok": true, "device": {...}}``. With
   ``--out DIR`` the per-instance kernel numbers, the profiles and
   phases 7's to 13's numbers are also written there as JSON.

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
HEADLINE_NODES = 64  # the JAX bench's headline federation
# the kernels each main path runs
DENSE_PATH = ("stream_gemm", "stream_wgrad", "dense_bwd", "sgd_accum")
CROSS_PATH = DENSE_PATH + ("fedavg_accum",)
# K6's headline shape: 64 nodes of mnist-mlp, 19 steps of 32, lr 0.05
MLP_NODES, MLP_ROWS, MLP_BATCH, MLP_LR = 64, 608, 32, 0.05
# K6 tolerance. Exact where the two versions start from one state: at
# one step and on a short shard, every element within the JAX test's
# rtol 2e-4 / atol 2e-5 (they agree to about 1e-7). Over 19 steps a
# ReLU whose pre-activation lies within the two versions' rounding
# difference (about 1e-6) of zero takes the other gate in one of them,
# and that unit's weight column, bias and trace train on from there: at
# most 1e-3 of a leaf's elements may then lie outside rtol 2e-4 / atol
# 2e-5, none more than 1e-2 off, and each leaf within relative L2 5e-3;
# the loss stays within rtol 1e-4 / atol 1e-5.
K6_TOL = dict(rtol=2e-4, atol=2e-5)
K6_LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
K6_FLIP_FRACTION, K6_FLIP_ATOL, K6_FLIP_REL_L2 = 1e-3, 1e-2, 5e-3
# K6 with bf16 state over 19 steps is held node by node: a gate taken the
# other way moves its node's whole state apart (a flipped h1 unit's
# gradient reaches every w0 column through h0). The kernel sums in the
# plain version's orders (torch.bmm's and torch.sum's, read on the card
# with a probe kernel), so no node may leave the flip bounds
K6_FLIP_NODES = 0
# K6's sum orders beyond the probe's shape (batch 32, 10 classes): one
# step from a zero trace at 64 nodes, (batch, classes) -> the leaves
# known to leave the plain version's bits; any other leaf must keep
# them, and these stay within K6_TOL. The plain version takes its
# forward products as ascending chains (``fused_train.chain_matmul``)
# and sums its bias gradients and softmax denominator in the kernel's
# stated orders; at batch 8 torch.bmm's forward products over 8 rows
# were not one ascending chain, and every leaf differed (closed, ROADMAP
# Queue C)
K6_ORDER_SHAPES = {
    (8, 7): (), (16, 7): (), (32, 10): (),
    (64, 7): (), (32, 62): ()}
# the plain K6 epoch takes its forward products as emulated chains (a
# few thousand launches a step): phase 2 times it over fewer calls
K6_PLAIN_REPS = 3
# the ResNet9 stem's K1 and K2 problem at phase 9's step: 16 nodes x 128
# CIFAR10 images of 32 x 32 rows, contraction 27, 64 filters
STEM = (16, 128 * 32 * 32, 27, 64)
# the leaf lists phase 2 holds K4 to, as phases 9 and 11 step them:
# (model, nodes, model kwargs, lora rank); ResNet9's 26 leaves (one
# launch) and ResNet50's 161 (four), the scanned ViT-Tiny's 23 at 32
# nodes (one) and its rank-8 q/v adapters' 4 at 16 nodes (one)
VIT_KW = {"remat": True, "scan_layers": True}
K4_MODEL_LISTS = (("resnet9", 16, {}, 0), ("resnet50", 4, {}, 0),
                  ("vit-tiny", 32, VIT_KW, 0), ("vit-tiny", 16, VIT_KW, 8))
# K4 takes at most this many leaves a launch (``csrc/kernels.h``)
K4_LEAVES_A_LAUNCH = 48
FEMNIST_CNN_LEAVES = {
    "Conv_0.kernel": (5, 5, 1, 32), "Conv_0.bias": (32,),
    "Conv_1.kernel": (5, 5, 32, 64), "Conv_1.bias": (64,),
    "Dense_0.kernel": (3136, 2048), "Dense_0.bias": (2048,),
    "Dense_1.kernel": (2048, 62), "Dense_1.bias": (62,)}

# published peaks (NVIDIA data sheets, dense): bytes/s, bf16 FLOP/s,
# f32 (non-tensor) FLOP/s, TF32 FLOP/s; the SKU is read from the card's
# name
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12, 378e12),
    "H100": (3.35e12, 989e12, 67e12, 495e12),  # SXM
    "H200": (4.8e12, 989e12, 67e12, 495e12),
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def peaks(name: str) -> tuple[float, float, float, float]:
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

    bw, bf16_peak, f32_peak, tf32_peak = peak
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
               flops, fpeak, on_path=True, summed=True, passes=1):
        # passes: the products the bound counts (3 for an f32-accurate
        # product from TF32 passes)
        bms, by = bound(nbytes, passes * flops, fpeak)
        rows.append(dict(kernel=kernel, instance=inst, max_abs_err=err,
                         ok=ok, tol=tol, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bms, bound_by=by,
                         bytes=nbytes, flops=flops, on_path=on_path,
                         summed=summed))
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"  {kernel:13s} {inst:12s} max_abs_err={err:.3g} ({tol}) "
              f"{'ok' if ok else 'FAIL'}  kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  library {lib}  bound "
              f"{bms:.4f} ms ({by}); {nbytes / ms / 1e9:.3f} TB/s, "
              f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * bms / ms:.1f}% of "
              "the bound", flush=True)

    def same_bits(name, fn):
        """Two runs of a kernel on the same inputs give the same bits."""
        a, b = fn(), fn()
        a, b = (a if isinstance(a, tuple) else (a,)), (
            b if isinstance(b, tuple) else (b,))
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            fail(f"{name} is not deterministic")

    def host_us(fn, calls: int = 50) -> float:
        """Host time to enqueue one call (the device is left to catch
        up after the clock stops)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / calls * 1e6

    # K1 stream_gemm: bf16 out, one bf16 ulp of an f32 sum; two runs
    # give the same bits. The ring's conv1 and conv2 (the instances the
    # kernels line sums) and the ResNet9 stem at phase 9's step
    k1_tol = dict(rtol=2.0 ** -7, atol=1e-2)
    for inst, (nk, m, k, nn_), on_path, summed in [
            ("conv1_fwd", (n, m1, 25, 32), True, True),
            ("conv1_dgrad", (n, m1, 32, 25), False, True),
            ("conv2_fwd", (n, m2, 800, 64), True, True),
            ("resnet9_stem_fwd", STEM, True, False)]:
        x, w = rand(nk, m, k), rand(nk, k, nn_)
        got = gemm.stream_gemm(x, w)
        branch = gemm.stream_gemm_branch()
        same_bits(f"stream_gemm {inst}", lambda: gemm.stream_gemm(x, w))
        err, ok = within(got, gemm.stream_gemm_plain(x, w), **k1_tol)
        record("stream_gemm", inst, err, ok, k1_tol,
               time_ms(lambda: gemm.stream_gemm(x, w)),
               time_ms(lambda: gemm.stream_gemm_plain(x, w)),
               time_ms(lambda: torch.bmm(x, w)),
               2 * nk * (m * k + k * nn_ + m * nn_), 2 * nk * m * k * nn_,
               bf16_peak, on_path, summed)
        rows[-1].update(branch=branch)
        print(f"    branch: {rows[-1]['branch']}; host "
              f"{host_us(lambda: gemm.stream_gemm(x, w)):.1f} us a call",
              flush=True)
        del x, w, got

    # K2 stream_wgrad: f32 sums of exact bf16 products over M rows in
    # another order, so held to the f32 rows' limits (``f32_check``:
    # relative L2 and each element scaled by its products' root sum of
    # squares, with the sum missing its plan's first slice and the
    # output rounded to bf16 as controls that must fail them). conv1 and
    # conv2 at the ring step (the instances the kernels line sums), the
    # cross-device cohort step (8 slots x 20), the Byzantine step (16
    # nodes x 64) and the ResNet9 stem at phase 9's step (16 nodes x 128
    # CIFAR10 images), each with its slice plan, the host's time to
    # enqueue a call and its profiled device time beside torch.bmm's.
    # The general route, which no path's operands take: conv1's shape
    # with g a view one element into a buffer (g_off), a base that no
    # TMA map can start at
    for inst, (nk, m, k, nn_), summed, g_off in [
            ("conv1_wgrad", (n, m1, 25, 32), True, 0),
            ("conv2_wgrad", (n, m2, 800, 64), True, 0),
            ("crossdev_conv1_wgrad", (8, 20 * 784, 25, 32), False, 0),
            ("crossdev_conv2_wgrad", (8, 20 * 196, 800, 64), False, 0),
            ("byzantine_conv1_wgrad", (16, 64 * 784, 25, 32), False, 0),
            ("byzantine_conv2_wgrad", (16, 64 * 196, 800, 64), False, 0),
            ("resnet9_stem_wgrad", STEM, False, 0),
            ("conv1_wgrad_general", (n, m1, 25, 32), False, 1)]:
        x = rand(nk, m, k)
        g = rand(nk * m * nn_ + g_off)[g_off:].view(nk, m, nn_)
        plan = gemm.wgrad_call_plan(x, g)
        if (plan.route == "general") != bool(g_off):
            fail(f"stream_wgrad {inst} takes the {plan.route} route")
        got = gemm.stream_wgrad(x, g)
        same_bits(f"stream_wgrad {inst}", lambda: gemm.stream_wgrad(x, g))
        xt = x.transpose(1, 2)
        err, ok, readings = f32_check(f"stream_wgrad bf16 {inst}", got,
                                      gemm.stream_wgrad_plain(x, g), xt, g,
                                      plan.rows)
        ok = f64_gate(f"stream_wgrad bf16 {inst}", readings) and ok
        record("stream_wgrad", inst, err, ok, F32_TOL + K2_F64_TOL,
               time_ms(lambda: gemm.stream_wgrad(x, g)),
               time_ms(lambda: gemm.stream_wgrad_plain(x, g)),
               time_ms(lambda: torch.bmm(xt, g)),
               2 * nk * (m * k + m * nn_) + 4 * nk * k * nn_,
               2 * nk * m * k * nn_, bf16_peak, on_path=not g_off,
               summed=summed)
        rows[-1].update(plan=plan._asdict(), f32_readings=readings)
        print(f"    plan: {plan.route} route, {plan.slices} slices of "
              f"{plan.rows} rows a node, {plan.tiles} tiles a slice, "
              f"{nk * plan.slices * plan.tiles} blocks", flush=True)
        host_device(rows, lambda: gemm.stream_wgrad(x, g), "wgrad",
                    lib_fn=lambda: torch.bmm(xt, g))
        k2_parts(rows, lambda: gemm.stream_wgrad(x, g), plan.route)
        r = rows[-1]
        print(f"    faster than torch.bmm: by events "
              f"{r['ms'] < r['library_ms']}, on the device "
              f"{r['device_ms'] < r['library_device_ms']}", flush=True)
        del x, g, got, xt
    torch.cuda.empty_cache()

    # K3 dense_bwd: bf16 outputs, as K1. The ring step (the instance the
    # kernels line sums), the cross-device cohort step (8 slots x 20) and
    # the Byzantine step (16 nodes x 64)
    d_in, h = 3136, 2048
    for inst, (nk, bk), summed in [("dense1_bwd", (n, b), True),
                                   ("crossdev_bwd", (8, 20), False),
                                   ("byzantine_bwd", (16, 64), False)]:
        x, w, g = rand(nk, bk, d_in), rand(nk, d_in, h), rand(nk, bk, h)
        dx, dw = gemm.dense_bwd(x, w, g)
        same_bits(f"dense_bwd {inst}", lambda: gemm.dense_bwd(x, w, g))
        pdx, pdw = gemm.dense_bwd_plain(x, w, g)
        e1, ok1 = within(dx, pdx, **k1_tol)
        e2, ok2 = within(dw, pdw, **k1_tol)
        wt, xt = w.transpose(1, 2), x.transpose(1, 2)
        record("dense_bwd", inst, max(e1, e2), ok1 and ok2, k1_tol,
               time_ms(lambda: gemm.dense_bwd(x, w, g)),
               time_ms(lambda: gemm.dense_bwd_plain(x, w, g)),
               time_ms(lambda: (torch.bmm(g, wt), torch.bmm(xt, g))),
               2 * nk * (2 * bk * d_in + 2 * d_in * h + bk * h),
               4 * nk * bk * d_in * h, bf16_peak, summed=summed)
        print(f"    host {host_us(lambda: gemm.dense_bwd(x, w, g)):.1f} us "
              "a call", flush=True)
        del x, w, g, dx, dw, pdx, pdw, wt, xt
    torch.cuda.empty_cache()

    rows.append(dict(kernel="wgmma_acc_probe", instance="tf32",
                     ok=True, on_path=False, summed=False,
                     probe=acc_probe(dev)))
    f32_instances(rows, record, same_bits, rand, host_us, n, m1, m2, b,
                  (bound, f32_peak, tf32_peak))

    # K4 and K5 over the FEMNIST CNN's 8 leaves at 8 slots: first the
    # step with every leaf in one call (the path's instance, which the
    # kernels line reports), then each leaf alone (one-leaf launches of
    # the same kernel, kept so that the Dense_0.kernel comparison with
    # the library carries on). Nodes 1, 3, 5, 7 gated off (lr 0) must
    # keep their params bit for bit. Explicit roundings in the kernel:
    # the same bits as the plain versions are required of the step
    # instances; the per-leaf rows allow 4 f32 ulp.
    shapes = FEMNIST_CNN_LEAVES
    lr = torch.tensor([0.05, 0.0] * (n // 2), device=dev)
    off = lr == 0
    w = torch.rand(n, generator=gen, device=dev) / (4 * n)
    k4_tol = dict(rtol=4 * 2.0 ** -23, atol=0.0)
    step_checks(rows, record, same_bits, rand, lr, w, f32_peak)
    for inst, shp in shapes.items():
        p, m, gr = (rand(n, *shp, dtype=torch.float32) for _ in range(3))
        kp, km = gemm.sgd_accum(p, m, gr, lr, momentum=0.9)
        pp, pm = gemm.sgd_accum_plain(p, m, gr, lr, momentum=0.9)
        e_p, ok_p = within(kp, pp, **k4_tol)
        e_m, ok_m = within(km, pm, **k4_tol)
        if not torch.equal(kp[off], p[off]):
            fail(f"sgd_accum {inst}: gate 0 changed the params")
        numel = p.numel()
        flat = [t.reshape(n, -1).clone() for t in (p, gr, m)]
        record("sgd_accum", inst, max(e_p, e_m), ok_p and ok_m, k4_tol,
               time_ms(lambda: gemm.sgd_accum(p, m, gr, lr, momentum=0.9)),
               time_ms(lambda: gemm.sgd_accum_plain(p, m, gr, lr,
                                                    momentum=0.9)),
               time_ms(lambda: torch._fused_sgd_(
                   [flat[0]], [flat[1]], [flat[2]], weight_decay=0.0,
                   momentum=0.9, lr=0.05, dampening=0.0, nesterov=False,
                   maximize=False, is_first_step=False)),
               20 * numel, 4 * numel, f32_peak, summed=False)
        del p, m, gr, kp, km, pp, pm, flat
    torch.cuda.empty_cache()

    for inst, shp in shapes.items():
        for pdt in (torch.float32, torch.bfloat16):
            p = rand(n, *shp, dtype=pdt)
            acc = rand(n, *shp, dtype=torch.float32)
            got = gemm.fedavg_accum(p, acc, w)
            err, ok = within(got, gemm.fedavg_accum_plain(p, acc, w),
                             **k4_tol)
            pf, af = p.reshape(n, -1), acc.reshape(n, -1)
            wc = w.view(-1, 1)
            numel = p.numel()
            record("fedavg_accum", f"{inst}.{str(pdt)[6:]}", err, ok,
                   k4_tol,
                   time_ms(lambda: gemm.fedavg_accum(p, acc, w)),
                   time_ms(lambda: gemm.fedavg_accum_plain(p, acc, w)),
                   time_ms(lambda: torch.addcmul(af, wc, pf.float())),
                   numel * (p.element_size() + 8), 2 * numel, f32_peak,
                   on_path=pdt == torch.float32, summed=False)
            del p, acc, got, pf, af
    torch.cuda.empty_cache()

    k4_variants(rows, record, same_bits, rand, f32_peak)

    # K6 fused_mlp_train_epoch at its headline shape (f32 products: the
    # card's non-tensor f32 peak), then one step, a short shard and the
    # ragged-rows refusal on the card
    from p2pfl_tpu_torch.ops import fused_train

    params, mom, bx, by = mlp_epoch_inputs(dev)
    n6, rows6, d_in = bx.shape
    steps = rows6 // MLP_BATCH

    def epoch(fn, p=params, x=bx, y=by, batch=MLP_BATCH):
        return fn(p, mom, x, y, MLP_LR, 0.9, batch_size=batch)

    got = epoch(fused_train.fused_mlp_train_epoch)
    again = epoch(fused_train.fused_mlp_train_epoch)
    if not all(torch.equal(a, b) for a, b in zip(
            got[0] + got[1] + (got[2],), again[0] + again[1] + (again[2],))):
        fail("fused_mlp_train_epoch is not deterministic")
    err, ok, flips = k6_compare(got, epoch(
        fused_train.fused_mlp_train_epoch_plain), multi_step=True)
    print(f"  fused_mlp_train_epoch: two runs bit-identical; elements off "
          f"the elementwise tolerance per leaf {flips}", flush=True)
    for inst, x, y, batch in (
            ("one_step", bx[:, :MLP_BATCH], by[:, :MLP_BATCH], MLP_BATCH),
            ("short_shard", bx[:, :20], by[:, :20], MLP_BATCH)):
        x, y = x.contiguous(), y.contiguous()
        e, o, _ = k6_compare(
            epoch(fused_train.fused_mlp_train_epoch, x=x, y=y, batch=batch),
            epoch(fused_train.fused_mlp_train_epoch_plain, x=x, y=y,
                  batch=batch), multi_step=False)
        print(f"  fused_mlp_train_epoch {inst}: max_abs_err {e:.3g} "
              f"{'ok' if o else 'FAIL'}", flush=True)
        if not o:
            fail(f"fused_mlp_train_epoch {inst} outside tolerance")
    try:
        epoch(fused_train.fused_mlp_train_epoch, x=bx[:, :40].contiguous(),
              y=by[:, :40].contiguous())
        fail("fused_mlp_train_epoch took 40 rows at batch 32")
    except ValueError:
        pass
    n_par = sum(int(t[0].numel()) for t in params)
    d1, d2, n_cls = params[0].shape[2], params[2].shape[2], params[4].shape[2]
    flops = n6 * steps * (2 * MLP_BATCH * (2 * d_in * d1 + 3 * d1 * d2
                                           + 3 * d2 * n_cls) + 4 * n_par)
    nbytes = n6 * (4 * 4 * n_par + rows6 * (4 * d_in + 4) + 4)
    record("fused_mlp_train_epoch", "mnist_mlp_64x19x32", err, ok,
           "K6_TOL/K6_FLIP_*",
           time_ms(lambda: epoch(fused_train.fused_mlp_train_epoch), reps=10),
           time_ms(lambda: epoch(fused_train.fused_mlp_train_epoch_plain),
                   reps=K6_PLAIN_REPS, warm=1),
           None, nbytes, flops, f32_peak)
    rows[-1].update(k6_plan(n6, MLP_BATCH, d_in, d1, d2, n_cls))
    host_device(rows, lambda: epoch(fused_train.fused_mlp_train_epoch),
                "mlp_epoch", reps=5)
    r = rows[-1]
    print(f"    kernel / plain {r['ms'] / r['plain_ms']:.3f} (events)",
          flush=True)
    del got, again

    # K6 with bf16 params, trace and inputs at the same shape: widened to
    # f32 on entry, the f32 epoch, narrowed once at the end. Held (i) bit
    # for bit to the f32 kernel's result on the widened inputs rounded
    # once to bf16 (the variant's own code: the widening and narrowing
    # passes), twice; (ii) from one state (the first step at 64 nodes,
    # and a 20-row shard) to its plain version within K6_TOL plus one
    # bf16 ulp; (iii) over the 19 steps to its plain version node by
    # node (``k6_nodes_off``): at most K6_FLIP_NODES nodes outside the
    # flip bounds plus one bf16 ulp, every value finite. The same epoch
    # in f64 is printed beside it: which version took the other gate
    bf = tuple(t.to(torch.bfloat16) for t in params)
    bm = tuple(t.to(torch.bfloat16) for t in mom)
    bbx = bx.to(torch.bfloat16)

    def epoch16(fn, x=bbx, y=by, cast=lambda t: t):
        return fn(tuple(map(cast, bf)), tuple(map(cast, bm)), cast(x), y,
                  MLP_LR, 0.9, batch_size=MLP_BATCH)

    def flat(o):
        return o[0] + o[1] + (o[2],)

    got = epoch16(fused_train.fused_mlp_train_epoch)
    same_bits("fused_mlp_train_epoch bf16",
              lambda: flat(epoch16(fused_train.fused_mlp_train_epoch)))
    wide = epoch16(fused_train.fused_mlp_train_epoch,
                   cast=lambda t: t.float())
    exact = all(torch.equal(a, b.to(torch.bfloat16))
                for a, b in zip(got[0] + got[1], wide[0] + wide[1]))
    exact = exact and torch.equal(got[2], wide[2])
    ok = exact
    for inst, x, y in (("one_step", bbx[:, :MLP_BATCH], by[:, :MLP_BATCH]),
                       ("short_shard", bbx[:, :20], by[:, :20])):
        x, y = x.contiguous(), y.contiguous()
        e, o, _ = k6_compare(
            epoch16(fused_train.fused_mlp_train_epoch, x, y),
            epoch16(fused_train.fused_mlp_train_epoch_plain, x, y),
            multi_step=False)
        ok = ok and o
        print(f"  fused_mlp_train_epoch bf16 {inst}: max_abs_err {e:.3g} "
              f"{'ok' if o else 'FAIL'}", flush=True)
    plain19 = epoch16(fused_train.fused_mlp_train_epoch_plain)
    err, whole, flips = k6_compare(got, plain19, multi_step=True)
    nodes = k6_nodes_off(got, plain19)
    finite = all(bool(torch.isfinite(t).all()) for t in flat(got))
    ok = ok and finite and len(nodes) <= K6_FLIP_NODES
    f64 = epoch16(fused_train.fused_mlp_train_epoch_plain,
                  cast=lambda t: t.double())
    f64 = (tuple(t.float() for t in f64[0]), tuple(t.float() for t in f64[1]),
           f64[2].float())
    nodes64 = k6_nodes_off(wide, f64)
    plain64 = k6_nodes_off(epoch16(fused_train.fused_mlp_train_epoch_plain,
                                   cast=lambda t: t.float()), f64)
    print(f"  fused_mlp_train_epoch bf16 state: bit for bit the f32 kernel "
          f"on the widened inputs, rounded: {exact}; over 19 steps against "
          f"the plain version: max_abs_err {err:.3g}, nodes outside the "
          f"flip bounds {nodes} (at most {K6_FLIP_NODES}), finite {finite}; "
          f"whole leaves within K6_FLIP_*: {whole}, elements off per leaf "
          f"{flips}; against the f64 epoch, nodes outside: the f32 kernel "
          f"{nodes64}, the plain version {plain64}", flush=True)
    record("fused_mlp_train_epoch_bf16", "mnist_mlp_64x19x32", err, ok,
           "bits of the f32 kernel on the widened inputs, rounded; "
           "K6_TOL + one bf16 ulp from one state; over 19 steps at most "
           "K6_FLIP_NODES nodes outside K6_FLIP_* + one bf16 ulp",
           time_ms(lambda: epoch16(fused_train.fused_mlp_train_epoch),
                   reps=10),
           time_ms(lambda: epoch16(fused_train.fused_mlp_train_epoch_plain),
                   reps=K6_PLAIN_REPS, warm=1),
           None, n6 * (2 * 4 * n_par + rows6 * (2 * d_in + 4) + 4), flops,
           f32_peak)
    rows[-1].update(nodes_off=nodes, whole_leaves_within_flip=whole,
                    elements_off=flips, kernel_vs_f64_nodes_off=nodes64,
                    plain_vs_f64_nodes_off=plain64)
    host_device(rows, lambda: epoch16(fused_train.fused_mlp_train_epoch),
                "mlp_epoch", reps=5)
    cast_ms, casts = device_time(
        lambda: epoch16(fused_train.fused_mlp_train_epoch), 5, "cast_bf16")
    rows[-1].update(cast_device_ms=cast_ms, cast_launches=casts)
    print(f"    the widening and narrowing passes: {cast_ms:.4f} ms on the "
          f"device in {casts:g} launches a call", flush=True)
    del params, mom, bx, by, got, wide, plain19, f64, bf, bm, bbx
    torch.cuda.empty_cache()

    rows.append(dict(kernel="fused_mlp_train_epoch", instance="sum_orders",
                     ok=True, on_path=False, summed=False,
                     readings=k6_sum_orders(dev)))
    k4_model_lists(rows, record, same_bits, rand, f32_peak)

    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail("kernels outside tolerance: " + ", ".join(
            f"{r['kernel']}/{r['instance']}" for r in bad))
    return rows


def step_checks(rows, record, same_bits, rand, lr, w, f32_peak) -> None:
    """K4 and K5 with the FEMNIST CNN's 8 leaves at 8 slots in one call
    (``gemm.sgd_accum_many`` / ``fedavg_accum_many``): the step (f32
    and bf16 trace), the step with the accumulate (off the path) and
    the null accumulate (f32 and bf16 p). Each must give the list plain
    version's bits, leave every gated-off leaf bit for bit, launch once
    and give the same bits on two runs; each is timed by events beside
    its plain version, the list library call (K4: one
    ``torch._fused_sgd_`` over all leaves; K5 null: one
    ``torch._foreach_addcmul`` with ``[n, 1, ...]`` weight views) and
    its bound, with the host's time to enqueue a call, and profiled for
    the kernel's own device time."""
    import torch

    from p2pfl_tpu_torch.ops import gemm

    shapes = list(FEMNIST_CNN_LEAVES.values())
    n = lr.shape[0]
    off = lr == 0

    def leaves(dtype):
        return [rand(n, *s, dtype=dtype) for s in shapes]

    def check(name, got, want, ps, gated):
        for g, v in zip(got, want):
            if not all(a.dtype == b.dtype and torch.equal(a, b)
                       for a, b in zip(g, v)):
                fail(f"{name}: differs from its list plain version")
        if gated and not all(torch.equal(kp[off], p[off])
                             for kp, p in zip(got[0], ps)):
            fail(f"{name}: gate 0 changed the params")

    def launched(key, fn):
        before = gemm.launches[key]
        fn()
        torch.cuda.synchronize()
        if gemm.launches[key] != before + 1:
            fail(f"{key}: {gemm.launches[key] - before} launches for one "
                 "call over every leaf")

    def flat(out):
        """A call's outputs as one tuple (a tuple of lists, or a list)."""
        return tuple(t for o in out for t in o) if isinstance(
            out, tuple) else tuple(out)

    values = n * sum(math.prod(s) for s in shapes)
    for tdt, on_path in ((torch.float32, True), (torch.bfloat16, False)):
        ps, gs, ms = leaves(torch.float32), leaves(torch.float32), leaves(tdt)
        name = f"sgd_accum step_all_leaves.{str(tdt)[6:]}"

        def kern():
            return gemm.sgd_accum_many(ps, ms, gs, lr, momentum=0.9)

        def plain():
            return gemm.sgd_accum_many_plain(ps, ms, gs, lr, momentum=0.9)

        check(name, kern(), plain(), ps, True)
        same_bits(name, lambda: flat(kern()))
        launched("sgd_accum", kern)
        lib, lib_fn = None, None
        if tdt == torch.float32:
            # in place, on copies: the library's optimizer step
            cp, cg, cm = ([t.clone() for t in x] for x in (ps, gs, ms))

            def lib_fn():
                torch._fused_sgd_(cp, cg, cm, weight_decay=0.0,
                                  momentum=0.9, lr=0.05, dampening=0.0,
                                  nesterov=False, maximize=False,
                                  is_first_step=False)

            lib = time_ms(lib_fn)
        record("sgd_accum", f"step_all_leaves.{str(tdt)[6:]}", 0.0, True,
               "same bits", time_ms(kern), time_ms(plain), lib,
               values * (12 + 2 * ms[0].element_size()), 4 * values,
               f32_peak, on_path=on_path, summed=on_path)
        host_device(rows, kern, "stream_kernel", lib_fn=lib_fn)
        del ps, gs, ms, lib_fn
        torch.cuda.empty_cache()

    for tdt in (torch.float32, torch.bfloat16):
        ps, gs, ms = leaves(torch.float32), leaves(torch.float32), leaves(tdt)
        accs = leaves(torch.float32)
        name = f"sgd_accum_acc step_all_leaves.{str(tdt)[6:]}"

        def kern():
            return gemm.sgd_accum_many(ps, ms, gs, lr, momentum=0.9,
                                       accs=accs, weight=w)

        def plain():
            return gemm.sgd_accum_many_plain(ps, ms, gs, lr, momentum=0.9,
                                             accs=accs, weight=w)

        check(name, kern(), plain(), ps, True)
        same_bits(name, lambda: flat(kern()))
        launched("sgd_accum_acc", kern)
        record("sgd_accum_acc", f"step_all_leaves.{str(tdt)[6:]}", 0.0,
               True, "same bits", time_ms(kern), time_ms(plain), None,
               values * (20 + 2 * ms[0].element_size()), 6 * values,
               f32_peak, on_path=False, summed=False)
        host_device(rows, kern, "stream_kernel")
        del ps, gs, ms, accs
        torch.cuda.empty_cache()

    for pdt, on_path in ((torch.float32, True), (torch.bfloat16, False)):
        ps, accs = leaves(pdt), leaves(torch.float32)
        name = f"fedavg_accum step_all_leaves.{str(pdt)[6:]}"

        def kern():
            return gemm.fedavg_accum_many(ps, accs, w)

        def plain():
            return gemm.fedavg_accum_many_plain(ps, accs, w)

        check(name, (kern(),), (plain(),), ps, False)
        same_bits(name, lambda: flat(kern()))
        launched("fedavg_accum", kern)
        lib, lib_fn = None, None
        if pdt == torch.float32:
            wv = [w.view((-1,) + (1,) * (p.dim() - 1)) for p in ps]

            def lib_fn():
                return torch._foreach_addcmul(accs, wv, ps)

            if not all(torch.equal(a, b) for a, b in zip(lib_fn(), plain())):
                print("    (the library call's sums differ in bits from "
                      "the plain version's)", flush=True)
            lib = time_ms(lib_fn)
        record("fedavg_accum", f"step_all_leaves.{str(pdt)[6:]}", 0.0, True,
               "same bits", time_ms(kern), time_ms(plain), lib,
               values * (ps[0].element_size() + 8), 2 * values, f32_peak,
               on_path=on_path, summed=on_path)
        host_device(rows, kern, "stream_kernel", lib_fn=lib_fn)
        del ps, accs
        torch.cuda.empty_cache()


def k4_model_lists(rows, record, same_bits, rand, f32_peak) -> None:
    """K4 over the leaf lists of ``K4_MODEL_LISTS`` (the models' own
    trees, or the adapter tree of a lora rank, flattened as the learner
    flattens them, stacked over the nodes phases 9 and 11 run): one call
    over every leaf, f32 params, gradients
    and trace, lr 0.1 with every other node gated off. It must give the
    list plain version's bits, leave the gated nodes' params bit for bit,
    launch ``ceil(leaves / 48)`` times and give the same bits twice; a
    leaf misplaced or dropped at a chunk boundary breaks the bits."""
    import torch

    from p2pfl_tpu_torch.core.pytree import tree_leaves
    from p2pfl_tpu_torch.models.base import get_model
    from p2pfl_tpu_torch.ops import gemm

    from p2pfl_tpu_torch.learning.lora import wrap_model

    for model, n, kw, rank in K4_MODEL_LISTS:
        net = get_model(model, **kw)
        sample = torch.zeros(1, 32, 32, 3)
        tree = (wrap_model(net, model, rank, sample_x=sample)
                if rank else net).init(torch.Generator().manual_seed(0),
                                       sample)
        shapes = [tuple(t.shape) for t in tree_leaves(tree)]
        del tree, net
        if rank:
            model = f"{model}_lora{rank}"
        ps, gs, ms = ([rand(n, *s, dtype=torch.float32) for s in shapes]
                      for _ in range(3))
        lr = torch.tensor([0.1, 0.0] * (n // 2), device=ps[0].device)
        off = lr == 0
        name = f"sgd_accum {model} {len(shapes)} leaves x {n} nodes"

        def kern():
            return gemm.sgd_accum_many(ps, ms, gs, lr, momentum=0.9)

        def plain():
            return gemm.sgd_accum_many_plain(ps, ms, gs, lr, momentum=0.9)

        want = -(-len(shapes) // K4_LEAVES_A_LAUNCH)
        before = gemm.launches["sgd_accum"]
        got = kern()
        torch.cuda.synchronize()
        launched = gemm.launches["sgd_accum"] - before
        ref = plain()
        exact = all(a.dtype == b.dtype and torch.equal(a, b)
                    for g, r in zip(got, ref) for a, b in zip(g, r))
        gated = all(torch.equal(kp[off], p[off])
                    for kp, p in zip(got[0], ps))
        print(f"  {name}: {launched} launches (want {want}); the list plain "
              f"version's bits {exact}; gated nodes' params kept {gated}",
              flush=True)
        if launched != want or not exact or not gated:
            fail(f"{name}: {launched} launches, bits {exact}, gate {gated}")
        same_bits(name, lambda: tuple(t for o in kern() for t in o))
        del got, ref
        cp, cg, cm = ([t.clone() for t in x] for x in (ps, gs, ms))

        def lib_fn():
            torch._fused_sgd_(cp, cg, cm, weight_decay=0.0, momentum=0.9,
                              lr=0.1, dampening=0.0, nesterov=False,
                              maximize=False, is_first_step=False)

        values = n * sum(math.prod(s) for s in shapes)
        record("sgd_accum", f"{model}_{len(shapes)}_leaves", 0.0, True,
               "same bits", time_ms(kern, reps=10), time_ms(plain, reps=10),
               time_ms(lib_fn, reps=10), values * 20, 4 * values, f32_peak,
               summed=False)
        rows[-1].update(leaves=len(shapes), nodes=n, launches_a_call=launched)
        # the event times above read the host's enqueue time whenever the
        # host is slower than the card: the host us and profiled device
        # ms apart, as for the other K4 rows
        host_device(rows, kern, "stream_kernel", lib_fn=lib_fn)
        del ps, gs, ms, cp, cg, cm
        torch.cuda.empty_cache()


# the f32 instantiations of K1-K3 against their plain versions
# (torch.matmul in f32, TF32 off). Two f32 sums of the same L products
# in other orders differ by about u sqrt(L) relative (u = 2**-24, the
# products' signs random), each element by a few u sqrt(L) times the
# root of its products' sum of squares. Held per instance: relative L2
# <= F32_REL_C u sqrt(L), and every element <= F32_ELEM_C u sqrt(L)
# sqrt(A**2 @ B**2). Two controls must fail those limits at each shape:
# the product in TF32 (the plain version on inputs rounded to TF32, and
# torch.bmm with TF32 on wherever cuBLAS then runs TF32: at conv1's K of
# 25 and 32 it stays in f32), and the sum with one slice dropped (K2: the
# first slice of its plan; K1 and K3: the first F32_TILE_K terms, half
# of one 32-deep box of csrc/gemm_f32_tc.cu)
F32_REL_C, F32_ELEM_C, F32_TILE_K = 4.0, 8.0, 16
F32_TOL = (f"rel L2 <= {F32_REL_C:g} u sqrt(L), |d| <= {F32_ELEM_C:g} u "
           "sqrt(L) sqrt(A**2 @ B**2)")
# Every K2 row is held one step further: against the product in f64 the
# kernel is no farther than its plain version (torch.matmul in f32) in
# relative L2 (the wgmma routes, bf16 wide and f32_tc, whose tensor core
# truncates its sums, add each box's sum outside it to nearest)
K2_F64_TOL = "; rel L2 vs f64 <= the plain version's"
# the kernels a K2 call launches, by route, read on their own from a
# profiled run: the sums (f32_tc splits g in shared memory: it has no
# pre-pass), then the slice sum
K2_KERNELS = {"wide": ("wgrad_wide_kernel", "wgrad_reduce_kernel"),
              "general": ("wgrad_general_kernel", "wgrad_reduce_kernel"),
              "f32_tc": ("gemm_tc_kernel", "slice_sum_f32_kernel"),
              "f32_narrow": ("wgrad_narrow_f32_kernel",
                             "slice_sum_f32_kernel"),
              "narrow": ("wgrad_narrow_bf16_kernel", "wgrad_reduce_kernel")}
# phase 8b's f32 training step (check_f32_grads): one step with a zero
# trace, so that the new trace is the gradient and neither the momentum
# nor the params' rounding enters, at each of F32_GRAD_SEEDS' rings in
# its initial and its trained state, on the first F32_GRAD_BATCHES
# batches: every leaf's gradient of every node against the same step in
# f64 that takes the same max-pool and ReLU decisions, relative L2.
# (Near a tie a decision goes either way under any f32 sum order, and
# against the f64 step's own decisions a few flips lift either f32 step
# to about 2e-3: that reading is printed, not held.) The limit holds the
# kernel step and the plain f32 step alike; the control, the plain step
# with K1 and K3 one TF32 pass, must exceed it at every state and
# batch. It is 10x the plain f32 step's worst reading over these 12
# (4.37e-6 on an NVIDIA H100 80GB HBM3), rounded up
F32_GRAD_TOL = 5e-5
F32_GRAD_SEEDS, F32_GRAD_BATCHES = (0, 1, 2), 2


def f32_reading(got, want, a, b) -> tuple[float, float]:
    """``got - want`` for ``want = a @ b`` summed over L = a's last axis:
    (its relative L2 in units of u sqrt(L), its largest element in units
    of u sqrt(L) sqrt(a**2 @ b**2))."""
    import torch

    scale = 2.0 ** -24 * math.sqrt(a.shape[-1])
    d = (got - want).float()
    elem = scale * torch.matmul(a * a, b * b).sqrt()
    return (float(d.norm() / want.norm()) / scale,
            float((d.abs() / elem.clamp(min=1e-30)).max()))


def tf32_round(t):
    """``t`` (f32) rounded to TF32's 10 mantissa bits, to nearest."""
    import torch

    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def f32_check(tag, got, want, a, b, drop: int) -> tuple[float, bool, dict]:
    """One f32 output of K1-K3 against its plain version ``want = a @ b``
    under the F32 limits, and the controls, which must fail them: (max
    |got - want|, ok, the readings). Read too, not gated: the output and
    the plain version each against the product in f64. With bf16 ``a``
    and ``b`` (K2's bf16 instantiation: exact products, f32 sums) the
    TF32 controls are void, since TF32 holds bf16 values exactly; the
    plain version rounded to bf16 takes their place."""
    import torch

    def passes(r):
        return r[0] <= F32_REL_C and r[1] <= F32_ELEM_C

    bf16_in = a.dtype == torch.bfloat16
    a, b = a.float(), b.float()
    reading = f32_reading(got, want, a, b)
    exact = torch.matmul(a.double(), b.double())
    vs_f64 = dict(kernel=f32_reading(got, exact, a, b),
                  plain=f32_reading(want, exact, a, b))
    del exact
    cut = a.clone()
    cut[..., :drop] = 0
    controls = dict(
        drop_one_slice=f32_reading(torch.matmul(cut, b), want, a, b))
    del cut
    on_tf32 = False
    if bf16_in:
        controls["bf16_out"] = f32_reading(
            want.to(torch.bfloat16).float(), want, a, b)
    else:
        mm = torch.backends.cuda.matmul  # TF32 off here (``main``)
        f32_bmm = torch.bmm(a, b)
        mm.allow_tf32 = True
        try:
            tf32_bmm = torch.bmm(a, b)
        finally:
            mm.allow_tf32 = False
        on_tf32 = not torch.equal(tf32_bmm, f32_bmm)
        controls.update(
            tf32_rounded=f32_reading(
                torch.matmul(tf32_round(a), tf32_round(b)), want, a, b),
            bmm_tf32=f32_reading(tf32_bmm, want, a, b))
    print(f"    {tag}: rel L2 {reading[0]:.4g} u sqrt(L) (limit "
          f"{F32_REL_C:g}), largest element {reading[1]:.4g} (limit "
          f"{F32_ELEM_C:g}); controls " + ", ".join(
              f"{k} {v[0]:.4g} / {v[1]:.4g}" for k, v in controls.items())
          + f" (torch.bmm ran TF32: {on_tf32}); against the f64 product "
          + ", ".join(f"{k} {v[0]:.4g} / {v[1]:.4g}"
                      for k, v in vs_f64.items()), flush=True)
    gated = [k for k in controls if k != "bmm_tf32" or on_tf32]
    passing = [k for k in gated if passes(controls[k])]
    if passing:
        fail(f"{tag}: the controls {passing} pass the F32 limits")
    readings = dict(rel_l2_units=reading[0], elem_units=reading[1],
                    bmm_ran_tf32=on_tf32,
                    **{f"{k}_units": v for k, v in controls.items()},
                    **{f"{k}_vs_f64_units": v for k, v in vs_f64.items()})
    return float((got - want).abs().max()), passes(reading), readings


def f64_gate(tag: str, readings: dict) -> bool:
    """K2's gate against the f64 product (``K2_F64_TOL``): the kernel's
    relative L2 is at most the plain version's."""
    mine = readings["kernel_vs_f64_units"][0]
    plain = readings["plain_vs_f64_units"][0]
    ok = mine <= plain
    readings.update(f64_gated=True, f64_ok=ok)
    print(f"    {tag}: against f64, rel L2 kernel {mine:.4g} / plain "
          f"{plain:.4g} u sqrt(L) (gated: {'ok' if ok else 'FAIL'})",
          flush=True)
    return ok


def k2_parts(rows, fn, route: str) -> None:
    """K2's kernels in one call (``K2_KERNELS[route]``, each launched
    once a call): each one's device time a launch, from one profiled
    run, and the launches the profiler recorded of the 10 made."""
    parts = device_parts(fn, 10, K2_KERNELS[route])
    rows[-1].update(route=route, device_parts_ms={
        k: ms for k, (ms, _) in parts.items()}, device_parts_seen={
        k: seen for k, (_, seen) in parts.items()})
    print(f"    route {route}; device a launch (profiled): " + ", ".join(
        f"{k} {ms:.4f} ms ({seen:g} of 10 launches recorded)"
        for k, (ms, seen) in parts.items()), flush=True)


def acc_probe(dev) -> dict:
    """The accumulation probe of ``csrc/gemm_f32_tc.cu``: ``wgmma``
    m64n64k8 TF32 sums in one accumulator against one ``fmaf`` chain a
    value, on tf32-valued inputs (every product exact). (i) Small
    integers, whose sums f32 holds exactly: both must give them (the
    fragment layout's check). (ii) 1 at k = 0 and 1.5 * 2**-24 at k = 8
    (the next wgmma), times ones: the exact 1 + 0.75 ulp(1) rounds to
    1 + 2**-23 to nearest, to 1 by truncation. (iii) Normal values at
    K = 2048: the mean and root-mean-square error of each against the
    f64 sum, signed toward larger magnitude, in ulps of the exact sum."""
    import torch

    from p2pfl_tpu_torch.ops import _build

    probe = _build.kernels().wgmma_acc_probe
    gen = torch.Generator(device=dev).manual_seed(7)
    a = torch.randint(-3, 4, (64, 256), generator=gen, device=dev).float()
    bt = torch.randint(-3, 4, (64, 256), generator=gen, device=dev).float()
    tc, chain = probe(a, bt)
    exact = (a.double() @ bt.double().T).float()
    layout = torch.equal(tc, exact) and torch.equal(chain, exact)
    a = torch.zeros(64, 32, device=dev)
    a[:, 0], a[:, 8] = 1.0, 1.5 * 2.0 ** -24
    tc, chain = probe(a, torch.ones(64, 32, device=dev))
    one_tc, one_chain = float(tc[0, 0]), float(chain[0, 0])
    mode = ("truncates" if one_tc == 1.0 else "rounds to nearest"
            if one_tc == 1.0 + 2.0 ** -23 else "neither")
    a = tf32_round(torch.randn(64, 2048, generator=gen, device=dev))
    bt = tf32_round(torch.randn(64, 2048, generator=gen, device=dev))
    tc, chain = probe(a, bt)
    ex = a.double() @ bt.double().T
    ulp = torch.exp2(torch.floor(torch.log2(ex.abs())) - 23)

    def err(got):
        e = (got.double() - ex) * ex.sign() / ulp
        return float(e.mean()), float(e.square().mean().sqrt())

    res = dict(layout_exact=layout, one_plus_three_quarter_ulp=dict(
        wgmma=one_tc, fmaf_chain=one_chain), mode=mode,
        k2048_ulps=dict(wgmma=err(tc), fmaf_chain=err(chain)))
    print(f"  wgmma TF32 accumulation probe: integer sums exact {layout}; "
          f"1 + 0.75 ulp -> wgmma {one_tc!r}, fmaf chain {one_chain!r}: "
          f"the tensor core {mode}; K = 2048 normal, error toward larger "
          f"magnitude (mean, rms, ulps): wgmma {res['k2048_ulps']['wgmma']}"
          f", fmaf chain {res['k2048_ulps']['fmaf_chain']}", flush=True)
    if not layout:
        fail("wgmma_acc_probe: the TF32 fragment layout gives wrong sums")
    return res


def f32_instances(rows, record, same_bits, rand, host_us, n, m1, m2, b,
                  peak) -> None:
    """K1, K2 and K3 in f32 (``csrc/gemm_f32_tc.cu``) at the ring's
    shapes (8 x 336 FEMNIST-CNN, the f32 arm's path; conv1's dgrad off
    it) and the ResNet9 stem's: held to ``F32_TOL`` (K2 also to
    ``K2_F64_TOL``), twice bit
    for bit, timed beside ``torch.bmm`` in f32 with TF32 off and against
    two bounds: an f32-accurate product's (three TF32 passes or the
    bytes; the row's ``bound_ms``) and exact SIMT FFMA's at the f32
    non-tensor peak (``simt_bound_ms``)."""
    import torch

    from p2pfl_tpu_torch.ops import gemm

    bound, f32_peak, tf32_peak = peak

    def split_and_gemm(fn):
        """3xTF32 instances: the profiled device time a call of the
        split pre-pass and of the GEMM kernel."""
        sp, _ = device_time(fn, 10, "split_kernel")
        gm, _ = device_time(fn, 10, "gemm_tc_kernel")
        rows[-1].update(split_device_ms=sp, gemm_device_ms=gm)
        print(f"    device: split pre-pass {sp:.4f} ms, 3xTF32 GEMM "
              f"{gm:.4f} ms a call (profiled)", flush=True)

    def bounds(nbytes, flops):
        r = rows[-1]
        sb, sby = bound(nbytes, flops, f32_peak)
        r.update(simt_bound_ms=sb, simt_bound_by=sby)
        print(f"    bounds: f32-accurate (3 TF32 passes or bytes) "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), exact SIMT FFMA "
              f"{sb:.4f} ms ({sby}); kernel / torch.bmm "
              f"{r['ms'] / r['library_ms']:.3f}", flush=True)

    f32 = torch.float32
    for inst, (nk, m, k, nn_), on_path, summed in [
            ("conv1_fwd", (n, m1, 25, 32), True, True),
            ("conv1_dgrad", (n, m1, 32, 25), False, True),
            ("conv2_fwd", (n, m2, 800, 64), True, True),
            ("resnet9_stem_fwd", STEM, True, False)]:
        x, w = rand(nk, m, k, dtype=f32), rand(nk, k, nn_, dtype=f32)
        got = gemm.stream_gemm(x, w)
        branch = gemm.stream_gemm_branch()
        same_bits(f"stream_gemm f32 {inst}", lambda: gemm.stream_gemm(x, w))
        err, ok, readings = f32_check(f"stream_gemm f32 {inst}", got,
                                      gemm.stream_gemm_plain(x, w), x, w,
                                      F32_TILE_K)
        record("stream_gemm_f32", inst, err, ok, F32_TOL,
               time_ms(lambda: gemm.stream_gemm(x, w)),
               time_ms(lambda: gemm.stream_gemm_plain(x, w)),
               time_ms(lambda: torch.bmm(x, w)),
               4 * nk * (m * k + k * nn_ + m * nn_), 2 * nk * m * k * nn_,
               tf32_peak, on_path, summed, passes=3)
        rows[-1].update(f32_readings=readings, branch=branch)
        print(f"    branch: {rows[-1]['branch']}", flush=True)
        bounds(4 * nk * (m * k + k * nn_ + m * nn_), 2 * nk * m * k * nn_)
        if k > 32:
            split_and_gemm(lambda: gemm.stream_gemm(x, w))
        print(f"    host {host_us(lambda: gemm.stream_gemm(x, w)):.1f} us "
              "a call", flush=True)
        del x, w, got
    torch.cuda.empty_cache()

    for inst, (nk, m, k, nn_), summed in [
            ("conv1_wgrad", (n, m1, 25, 32), True),
            ("conv2_wgrad", (n, m2, 800, 64), True),
            ("resnet9_stem_wgrad", STEM, False)]:
        x, g = rand(nk, m, k, dtype=f32), rand(nk, m, nn_, dtype=f32)
        got = gemm.stream_wgrad(x, g)
        same_bits(f"stream_wgrad f32 {inst}",
                  lambda: gemm.stream_wgrad(x, g))
        xt = x.transpose(1, 2)
        plan = gemm.wgrad_call_plan(x, g)
        err, ok, readings = f32_check(f"stream_wgrad f32 {inst}", got,
                                      gemm.stream_wgrad_plain(x, g), xt, g,
                                      plan.rows)
        ok = f64_gate(f"stream_wgrad f32 {inst}", readings) and ok
        record("stream_wgrad_f32", inst, err, ok, F32_TOL + K2_F64_TOL,
               time_ms(lambda: gemm.stream_wgrad(x, g)),
               time_ms(lambda: gemm.stream_wgrad_plain(x, g)),
               time_ms(lambda: torch.bmm(xt, g)),
               4 * nk * (m * k + m * nn_) + 4 * nk * k * nn_,
               2 * nk * m * k * nn_, tf32_peak, summed=summed, passes=3)
        rows[-1].update(plan=plan._asdict(), f32_readings=readings)
        bounds(4 * nk * (m * k + m * nn_) + 4 * nk * k * nn_,
               2 * nk * m * k * nn_)
        print(f"    plan: {plan.route} route, {plan.slices} slices of "
              f"{plan.rows} rows a node, {plan.tiles} tiles a slice, "
              f"{nk * plan.slices * plan.tiles} blocks", flush=True)
        host_device(rows, lambda: gemm.stream_wgrad(x, g), None,
                    lib_fn=lambda: torch.bmm(xt, g))
        k2_parts(rows, lambda: gemm.stream_wgrad(x, g), plan.route)
        del x, g, got, xt
    torch.cuda.empty_cache()

    d_in, h = 3136, 2048
    x, w, g = (rand(n, b, d_in, dtype=f32), rand(n, d_in, h, dtype=f32),
               rand(n, b, h, dtype=f32))
    dx, dw = gemm.dense_bwd(x, w, g)
    same_bits("dense_bwd f32", lambda: gemm.dense_bwd(x, w, g))
    pdx, pdw = gemm.dense_bwd_plain(x, w, g)
    wt, xt = w.transpose(1, 2), x.transpose(1, 2)
    e1, ok1, r1 = f32_check("dense_bwd f32 dx", dx, pdx, g, wt, F32_TILE_K)
    e2, ok2, r2 = f32_check("dense_bwd f32 dw", dw, pdw, xt, g, F32_TILE_K)
    record("dense_bwd_f32", "dense1_bwd", max(e1, e2), ok1 and ok2, F32_TOL,
           time_ms(lambda: gemm.dense_bwd(x, w, g)),
           time_ms(lambda: gemm.dense_bwd_plain(x, w, g)),
           time_ms(lambda: (torch.bmm(g, wt), torch.bmm(xt, g))),
           4 * n * (2 * b * d_in + 2 * d_in * h + b * h),
           4 * n * b * d_in * h, tf32_peak, passes=3)
    rows[-1].update(f32_readings=dict(dx=r1, dw=r2))
    bounds(4 * n * (2 * b * d_in + 2 * d_in * h + b * h),
           4 * n * b * d_in * h)
    split_and_gemm(lambda: gemm.dense_bwd(x, w, g))
    print(f"    host {host_us(lambda: gemm.dense_bwd(x, w, g)):.1f} us a "
          "call", flush=True)
    del x, w, g, dx, dw, pdx, pdw, wt, xt
    torch.cuda.empty_cache()


def k4_variants(rows, record, same_bits, rand, f32_peak) -> None:
    """K4 on the 64-node headline's bf16 state (the FEMNIST CNN's 8
    leaves at 64 nodes, bf16 params, gradients and trace, half the nodes
    gated off; one call over every leaf, the list plain version's bits)
    and on the one-class SVM's leaves (``w [8, 17]``, ``rho [8]``: one
    value a node)."""
    import torch

    from p2pfl_tpu_torch.ops import gemm

    shapes = list(FEMNIST_CNN_LEAVES.values())
    for inst, n, shps, dt in [
            ("headline_64_bf16", HEADLINE_NODES, shapes, torch.bfloat16),
            ("ocsvm_leaves", N_NODES, [(17,), ()], torch.float32)]:
        ps, gs, ms = ([rand(n, *s, dtype=dt) for s in shps]
                      for _ in range(3))
        lr = torch.tensor([0.05, 0.0] * (n // 2), device=ps[0].device)
        off = lr == 0

        def kern():
            return gemm.sgd_accum_many(ps, ms, gs, lr, momentum=0.9)

        def plain():
            return gemm.sgd_accum_many_plain(ps, ms, gs, lr, momentum=0.9)

        got, want = kern(), plain()
        ok = all(a.dtype == v.dtype and torch.equal(a, v)
                 for g_, w_ in zip(got, want) for a, v in zip(g_, w_))
        if not all(torch.equal(kp[off], p[off]) for kp, p in zip(got[0], ps)):
            fail(f"sgd_accum {inst}: gate 0 changed the params")
        same_bits(f"sgd_accum {inst}",
                  lambda: tuple(t for o in kern() for t in o))
        lib = None
        if dt == torch.bfloat16:
            cp, cg, cm = ([t.clone() for t in x] for x in (ps, gs, ms))
            try:
                torch._fused_sgd_(cp, cg, cm, weight_decay=0.0, momentum=0.9,
                                  lr=0.05, dampening=0.0, nesterov=False,
                                  maximize=False, is_first_step=False)
                lib = time_ms(lambda: torch._fused_sgd_(
                    cp, cg, cm, weight_decay=0.0, momentum=0.9, lr=0.05,
                    dampening=0.0, nesterov=False, maximize=False,
                    is_first_step=False))
            except (RuntimeError, TypeError) as e:
                print(f"    (torch._fused_sgd_ refuses bf16 state: {e})",
                      flush=True)
            del cp, cg, cm
        values = n * sum(math.prod(s) for s in shps)
        esz = ps[0].element_size()
        record("sgd_accum_bf16" if dt == torch.bfloat16 else "sgd_accum",
               inst, 0.0, ok, "same bits", time_ms(kern), time_ms(plain),
               lib, values * 5 * esz, 4 * values, f32_peak,
               on_path=dt == torch.bfloat16, summed=dt == torch.bfloat16)
        if dt == torch.bfloat16:
            host_device(rows, kern, "stream_kernel")
        if not ok:
            fail(f"sgd_accum {inst}: differs from its list plain version")
        del ps, gs, ms, got, want
        torch.cuda.empty_cache()


def host_device(rows, kern, name: str | None, lib_fn=None,
                reps: int = 10) -> None:
    """The host's time to enqueue one call on an idle card, and a
    profiled run of ``reps`` calls: the kernel's own device time a call
    (the kernels whose name holds ``name``; None: every kernel the call
    launches) and its launches a call (and
    the library call's, where given), which the event times (host and
    device together) do not separate."""
    us, piped = enqueue_us(kern), enqueue_us(kern, idle=False)
    dev_ms, count = device_time(kern, reps, name)
    line = (f"    host {us:.1f} us a call on an idle card, {piped:.1f} us "
            f"back to back; device {dev_ms:.4f} ms a call in {count:g} "
            "launch(es) (profiled)")
    extra = dict(host_us=us, host_us_back_to_back=piped, device_ms=dev_ms,
                 device_launches=count)
    if lib_fn is not None:
        lib_ms, lib_count = device_time(lib_fn, reps, None)
        line += (f"; library device {lib_ms:.4f} ms a call in "
                 f"{lib_count:g} launch(es)")
        extra.update(library_device_ms=lib_ms, library_launches=lib_count)
    print(line, flush=True)
    rows[-1].update(extra)


def enqueue_us(fn, calls: int = 10, idle: bool = True) -> float:
    """Host time of one call: each call finding the card idle
    (synchronized before it), or ``calls`` calls back to back, as a
    training loop issues them (too few to fill the launch queue)."""
    import torch

    torch.cuda.synchronize()
    total, t0 = 0.0, time.perf_counter()
    for _ in range(calls):
        if idle:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        fn()
        if idle:
            total += time.perf_counter() - t0
    if not idle:
        total = time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / calls * 1e6


def profiled_kernels(fn, reps: int) -> list:
    """The device-side events (kernels) of ``reps`` profiled calls of
    ``fn``, after one call outside the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def device_parts(fn, reps: int, names) -> dict:
    """For each kernel whose name holds one of ``names``: (its mean device
    time (ms) a launch, the launches the profiler recorded), from one
    profiled run of ``reps`` calls. The profiler can drop records (it
    kept 0.5-0.9 of a library call's launches in some runs on an H100),
    so the mean is over the launches it kept; a second run where it kept
    none of one kernel; none in both fails."""
    for _ in range(2):
        evs = profiled_kernels(fn, reps)
        got = {}
        for n in names:
            mine = [e for e in evs if n in e.key]
            count = sum(e.count for e in mine)
            total = sum(e.self_device_time_total for e in mine)
            got[n] = (total / 1e3 / count if count else 0.0, count)
        if all(count for _, count in got.values()):
            return got
    missing = [n for n in names if not got[n][1]]
    fail(f"the profiler saw no device time for {missing}")


def device_time(fn, reps: int, name: str | None) -> tuple[float, float]:
    """Device time (ms) and kernel launches a call of ``fn`` over
    ``reps`` profiled calls: of the kernels whose name holds ``name``,
    or of every kernel when ``name`` is None (a second profiled run
    where the first saw none)."""
    for _ in range(2):
        evs = [e for e in profiled_kernels(fn, reps)
               if name is None or name in e.key]
        if evs:
            return (sum(e.self_device_time_total for e in evs) / 1e3 / reps,
                    sum(e.count for e in evs) / reps)
    fail(f"the profiler saw no device time for {name or 'the call'}")


def k6_sum_orders(dev) -> dict:
    """K6 from a zero trace, one step at 64 mnist-mlp nodes, at each of
    ``K6_ORDER_SHAPES``: the params and traces that leave the plain
    version's bits, their largest difference and the share of their
    elements that differ. Fails if a leaf outside the recorded set
    differs or one leaves ``K6_TOL``."""
    import torch

    from p2pfl_tpu_torch.ops import fused_train

    names = ("w0", "b0", "w1", "b1", "w2", "b2")
    out = {}
    for (batch, c), known in K6_ORDER_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(23)
        shapes = [(64, 784, 256), (64, 1, 256), (64, 256, 128), (64, 1, 128),
                  (64, 128, c), (64, 1, c)]
        params = tuple(torch.randn(s, generator=gen, device=dev) * 0.05
                       for s in shapes)
        mom = tuple(torch.zeros_like(t) for t in params)
        bx = torch.randn((64, batch, 784), generator=gen, device=dev)
        by = torch.randint(0, c, (64, batch, 1), generator=gen, device=dev,
                           dtype=torch.int32)
        got = fused_train.fused_mlp_train_epoch(params, mom, bx, by, MLP_LR,
                                                0.9, batch_size=batch)
        want = fused_train.fused_mlp_train_epoch_plain(
            params, mom, bx, by, MLP_LR, 0.9, batch_size=batch)
        off = {}
        for kind, ks, ws in (("params", got[0], want[0]),
                             ("trace", got[1], want[1])):
            for name, a, b in zip(names, ks, ws):
                if torch.equal(a, b):
                    continue
                d = (a - b).abs()
                _, ok = within(a, b, **K6_TOL)
                off[f"{kind} {name}"] = dict(
                    max_abs=float(d.max()),
                    share=float((d > 0).float().mean()), within_k6_tol=ok)
                if not ok or name not in known:
                    fail(f"K6 sum orders at batch {batch}, {c} classes: "
                         f"{kind} {name} {off[f'{kind} {name}']}")
        out[f"batch{batch}_classes{c}"] = off
        print(f"  K6 sum orders, one step from a zero trace, 64 nodes, "
              f"batch {batch}, {c} classes: off the plain version's bits "
              + (", ".join(f"{k} (max {v['max_abs']:.3g}, "
                           f"{100 * v['share']:.2f}% of elements)"
                           for k, v in off.items()) or "none"), flush=True)
    return out


def mlp_epoch_inputs(dev):
    """K6's headline inputs: 64 mnist-mlp nodes at full width from the
    port's init (node i from seed i) through ``mlp_params_to_tuple``,
    zero momentum, and 608 rows a node of the seeded MNIST surrogate."""
    import numpy as np
    import torch

    from p2pfl_tpu_torch.core.pytree import tree_map
    from p2pfl_tpu_torch.datasets.sources import get_dataset
    from p2pfl_tpu_torch.models.base import get_model
    from p2pfl_tpu_torch.ops.fused_train import mlp_params_to_tuple

    n, rows = MLP_NODES, MLP_ROWS
    data = get_dataset("mnist", seed=0, synthetic_sizes=(n * rows, 4000))
    bx = torch.from_numpy(data.x_train.reshape(n, rows, -1)).to(dev)
    by = torch.from_numpy(
        data.y_train.reshape(n, rows, 1).astype(np.int32)).to(dev)
    model = get_model("mnist-mlp")
    trees = [model.init(torch.Generator().manual_seed(i),
                        torch.zeros(1, 28, 28, 1)) for i in range(n)]
    stacked = tree_map(lambda *leaves: torch.stack(leaves).to(dev), *trees)
    params = tuple(t.contiguous() for t in mlp_params_to_tuple(stacked))
    return params, tuple(torch.zeros_like(t) for t in params), bx, by


def k6_plan(n: int, batch: int, d_in: int, d1: int, d2: int,
            n_cls: int) -> dict:
    """K6's instantiation at these widths, printed: on chip or
    L2-resident, its shared memory a block, the 8-block clusters the card
    holds at once and the waves n nodes take."""
    from p2pfl_tpu_torch.ops import _build

    inst, smem, clusters = _build.kernels().fused_mlp_epoch_plan(
        batch, d_in, d1, d2, n_cls)
    waves = -(-n // clusters) if clusters else None
    print(f"    K6 instantiation {inst}: {smem} B of shared memory a block, "
          f"{clusters} clusters resident, {n} nodes in {waves} waves",
          flush=True)
    return dict(instantiation=inst, smem_bytes=smem,
                clusters_resident=clusters, waves=waves)


def bf16_ulp(t):
    """One bf16 ulp at each value of ``t`` (f32)."""
    import torch

    e = torch.floor(torch.log2(t.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def k6_nodes_off(got, want) -> list[int]:
    """K6 against its plain version node by node over many steps: the
    nodes whose state leaves the flip bounds (K6_FLIP_* on the node's
    slice of each leaf, bf16 state one bf16 ulp more) or whose loss
    leaves K6_LOSS_TOL."""
    import torch

    (kp, km, kl), (pp, pm, pl) = got, want
    n = kl.shape[0]
    out = (kl - pl).abs() > K6_LOSS_TOL["atol"] + K6_LOSS_TOL["rtol"] * pl.abs()
    for a, b in zip(kp + km, pp + pm):
        bf16 = a.dtype == torch.bfloat16
        a, b = a.float().reshape(n, -1), b.float().reshape(n, -1)
        d = (a - b).abs()
        if bf16:
            d = (d - bf16_ulp(torch.maximum(a.abs(), b.abs()))).clamp(min=0.0)
        off = (d > K6_TOL["atol"] + K6_TOL["rtol"] * b.abs()).sum(1)
        rel = (a - b).norm(dim=1) / b.norm(dim=1).clamp(min=1e-30)
        out |= ((off > K6_FLIP_FRACTION * a.shape[1])
                | (d.amax(1) > K6_FLIP_ATOL) | (rel > K6_FLIP_REL_L2))
    return out.nonzero().flatten().tolist()


def k6_compare(got, want, multi_step: bool):
    """K6 against its plain version under the K6 tolerance (see K6_TOL):
    (max |error| over params and trace, ok, per-leaf count of elements
    off the elementwise tolerance). bf16 state is allowed one bf16 ulp
    more (at the larger of the two values): both versions round the f32
    epoch's state once."""
    import torch

    (kp, km, kl), (pp, pm, pl) = got, want
    err, ok, flips = 0.0, True, []
    for a, b in zip(kp + km, pp + pm):
        bf16 = a.dtype == torch.bfloat16
        a, b = a.float(), b.float()
        raw = (a - b).abs()
        err = max(err, float(raw.max()))
        d = raw
        if bf16:
            ulp = bf16_ulp(torch.maximum(a.abs(), b.abs()))
            d = (raw - ulp).clamp(min=0.0)
        off = int((d > K6_TOL["atol"] + K6_TOL["rtol"] * b.abs()).sum())
        flips.append(off)
        if not multi_step:
            ok = ok and off == 0
            continue
        rel = float((a - b).norm() / b.norm().clamp(min=1e-30))
        ok = ok and (off <= K6_FLIP_FRACTION * a.numel()
                     and float(d.max()) <= K6_FLIP_ATOL
                     and rel <= K6_FLIP_REL_L2)
    e_loss, ok_loss = within(kl, pl, **K6_LOSS_TOL)
    return max(err, e_loss), ok and ok_loss, flips


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


def plain_step(model, state, bx, by, bm, lr: float, momentum: float,
               f64: bool = False, tf32_k13: bool = False,
               kernel_fwd: bool = False, record: list | None = None,
               taken: list | None = None):
    """One SGD step of the FEMNIST CNN written out through the plain
    versions of the kernels, for ``check_f32_grads``'s replays (the
    kernel step's own check, ``check_step_vs_plain``, runs the model's
    step inside ``PlainVersions``): (loss, new params, new traces,
    gradients). ``f64``: the same step
    with every product and the loss in float64 (the update arithmetic in
    f32, as the plain K4). ``tf32_k13``: the products that K1 and K3
    take on the kernel path (the convs' forward, dense1's backward) on
    operands rounded to TF32, i.e. one TF32 pass. ``kernel_fwd``: the
    convs' forward through K1's wrapper, as the kernel path computes
    it. ``record``: a list that gets the forward's decisions in order
    (each ReLU's mask, each max-pool's argmax); ``taken``: such a list,
    whose decisions the forward takes instead of its own."""
    import torch
    import torch.nn.functional as F

    from p2pfl_tpu_torch.core.pytree import tree_leaves, tree_unflatten
    from p2pfl_tpu_torch.learning.objectives import cross_entropy_loss
    from p2pfl_tpu_torch.models.base import dense, node_bias
    from p2pfl_tpu_torch.models.cnn import max_pool_2x2, patches
    from p2pfl_tpu_torch.ops import gemm

    def mm(a, b):
        if f64:
            return torch.matmul(a.double(), b.double())
        return torch.matmul(a.float(), b.float())

    def k13(*ts):
        return tuple(tf32_round(t) for t in ts) if tf32_k13 else ts

    class PlainConv(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(x, w)
            if f64:
                return mm(x, w).to(x.dtype)
            if kernel_fwd:
                return gemm.stream_gemm(x.contiguous(), w.contiguous())
            return gemm.stream_gemm_plain(*k13(x, w))

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            dx = None
            if ctx.needs_input_grad[0]:
                dx = mm(g, w.transpose(1, 2)).to(x.dtype)
            dw = (mm(x.transpose(1, 2), g) if f64
                  else gemm.stream_wgrad_plain(x, g))
            return dx, dw.to(w.dtype)

    class PlainDense(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(x, w)
            return mm(x, w).to(x.dtype)

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            if f64:
                return (mm(g, w.transpose(1, 2)).to(x.dtype),
                        mm(x.transpose(1, 2), g).to(w.dtype))
            return gemm.dense_bwd_plain(*k13(x, w, g.to(x.dtype)))

    dt = torch.float64 if f64 else model.dtype
    given = iter(taken or ())

    def relu(y):
        if taken is not None:
            return y * next(given).to(y.dtype)
        if record is not None:
            record.append(y > 0)
        return torch.relu(y)

    def pool(y):
        if taken is None:
            if record is not None:
                n, b, h, w, c = y.shape
                record.append(F.max_pool2d(
                    y.detach().reshape(n * b, h, w, c).permute(0, 3, 1, 2),
                    2, 2, return_indices=True)[1])
            return max_pool_2x2(y)
        idx = next(given)
        n, b, h, w, c = y.shape
        t = y.reshape(n * b, h, w, c).permute(0, 3, 1, 2).flatten(2)
        z = t.gather(2, idx.flatten(2)).view(idx.shape)
        return z.permute(0, 2, 3, 1).reshape(n, b, h // 2, w // 2, c)

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
            x = pool(relu(y))
        x = x.reshape(x.shape[0], x.shape[1], -1)
        d0 = p["Dense_0"]
        x = PlainDense.apply(x, d0["kernel"].to(dt))
        x = relu(x + node_bias(d0["bias"], dt, x.dim()))
        return dense(x, p["Dense_1"], dt).to(
            torch.float64 if f64 else torch.float32)

    leaves = [(t.double() if f64 else t).detach().requires_grad_(True)
              for t in tree_leaves(state.params)]
    params = tree_unflatten(state.params, leaves)
    loss = cross_entropy_loss(forward(params, bx), by, bm)
    grads = torch.autograd.grad(loss.sum(), leaves)
    n = leaves[0].shape[0]
    lrv = torch.full((n,), lr, device=leaves[0].device)
    new = [gemm.sgd_accum_plain(p.detach(), m, g.to(m.dtype), lrv,
                                momentum=momentum)
           for p, m, g in zip(leaves, tree_leaves(state.opt_state), grads)]
    return (loss.detach(), [pm[0] for pm in new], [pm[1] for pm in new],
            list(grads))


def end_to_end(dev):
    import torch

    from p2pfl_tpu_torch.core.pytree import tree_param_count
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
    missing = [k for k in DENSE_PATH if launches[k] <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    check_k4_per_step(sc, launches, len(res.history))
    check_step_vs_plain("main path", sc, False)
    return launches, sc


def steps_of(sc, rounds: int) -> int:
    """The training steps ``rounds`` rounds of ``sc`` take."""
    cfg = sc.config
    rows = sc._data_args[0].shape[1]
    return (rounds * cfg.training.epochs_per_round
            * (rows // min(cfg.data.batch_size, rows)))


def check_k4_per_step(sc, launches, rounds: int) -> None:
    """K4 launches once a training step, over every leaf."""
    steps = steps_of(sc, rounds)
    print(f"  K4 launches {launches['sgd_accum']} for {steps} training "
          "steps", flush=True)
    if launches["sgd_accum"] != steps:
        fail(f"sgd_accum launched {launches['sgd_accum']} times in "
             f"{steps} training steps")


def profile_round(run, out: pathlib.Path | None,
                  name: str = "chip_smoke_profile",
                  what: str = "round + evaluation"):
    """``run()`` (one more round) under ``torch.profiler``: device time
    by operation and the device's busy share of the wall time (the
    profiler's own cost inflates the wall). Returns ``wall_ms``,
    ``busy_ms`` (the union of the kernels' spans), ``kernel_ms`` (their
    times summed) and ``ops`` (``(kernel, ms, count)`` by time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: a CPU op's row repeats its kernels' time,
    # CUPTI's own buffer records are no work of the program, and the
    # ViT's record_function scopes appear as device ranges over their
    # kernels
    cupti = {"Activity Buffer Request", "Command Buffer Full",
             "Buffer Flush", *VIT_SCOPES}
    ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0 and e.key not in cupti),
                 key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in ops)
    # kernels on several streams overlap (cuDNN runs a grouped conv's
    # groups side by side): the busy time is the union of their spans
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.name not in cupti)
    union, end = 0.0, -math.inf
    for a, b in spans:
        union += max(0.0, b - max(a, end))
        end = max(end, b)
    union /= 1e3
    print(f"  profiled {what}: {wall_ms:.1f} ms wall, device "
          f"busy {union:.1f} ms ({100 * union / wall_ms:.1f}%; kernel "
          f"time summed over streams {busy:.1f} ms)", flush=True)
    for op, ms, count in ops[:15]:
        print(f"    {ms:9.3f} ms {count:6d}x  {op[:90]}", flush=True)
    res = dict(wall_ms=wall_ms, busy_ms=union, kernel_ms=busy, ops=ops)
    if out is not None:
        (out / f"{name}.json").write_text(json.dumps(res, indent=1))
    return res


# ---------------------------------------------------------------------------
# phase 4: the cross-device round
# ---------------------------------------------------------------------------


def crossdev_config(**cd):
    """FEMNIST CNN at full width, 3,550 clients (LEAF FEMNIST's writer
    count), 32 a round in 4 cohorts of 8 slots, 20 samples a client in
    one batch, 1 epoch, lr 0.05, 3 rounds; ``cd`` overrides the
    cross-device knobs."""
    from p2pfl_tpu_torch.config.schema import (
        CrossDeviceConfig,
        DataConfig,
        ModelConfig,
        ScenarioConfig,
        TrainingConfig,
    )

    return ScenarioConfig(
        name="femnist-cnn-crossdev",
        data=DataConfig(dataset="femnist", partition="iid",
                        synthetic_train=71_000, samples_per_node=20,
                        batch_size=20, seed=0),
        model=ModelConfig(model="femnist-cnn"),
        training=TrainingConfig(rounds=3, epochs_per_round=1,
                                learning_rate=0.05, eval_every=0),
        cross_device=CrossDeviceConfig(
            n_clients=3550, clients_per_round=32, cohort_size=4,
            seed=0, **cd),
        seed=0,
    )


def snapshot(fed):
    from p2pfl_tpu_torch.core.pytree import tree_leaves

    return [t.clone() for t in tree_leaves(fed.states.params)
            + tree_leaves(fed.states.opt_state)]


def cross_device(dev, out: pathlib.Path | None):
    import numpy as np
    import torch

    from p2pfl_tpu_torch.core.pytree import tree_param_count
    from p2pfl_tpu_torch.federation import CrossDeviceScenario
    from p2pfl_tpu_torch.ops import gemm

    cfg = crossdev_config()
    t0 = time.perf_counter()
    sc = CrossDeviceScenario(cfg, device=dev)
    n_slots = cfg.cross_device.n_slots
    print(f"  setup {time.perf_counter() - t0:.1f} s (data, init); "
          f"{tree_param_count(sc.fed.states.params) // n_slots} params a "
          f"slot, {n_slots} slots, {cfg.cross_device.cohort_size} cohort "
          "steps a round", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    gemm.reset_launches()
    first = sc.run(rounds=1)
    round1 = snapshot(sc.fed)
    rest = sc.run(rounds=2)
    torch.cuda.synchronize(dev)
    launches = dict(gemm.launches)
    hist = first.history + rest.history
    losses = [h["Train/loss"] for h in hist]
    for h in hist:
        print(f"  round {h['round'] + 1}: {h['round_time_s']:.4f} s wall, "
              f"mean train loss {h['Train/loss']:.4f}", flush=True)
    peak_mem = torch.cuda.max_memory_allocated(dev)
    print(f"  test accuracy after 3 rounds {rest.final_accuracy:.4f}; "
          f"max_memory_allocated {peak_mem / 2**30:.2f} GiB; "
          f"launches {launches}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite cross-device train loss {losses}")
    if not losses[2] < losses[0]:
        fail(f"cross-device train loss did not fall: {losses}")
    missing = [k for k in CROSS_PATH if launches[k] <= 0]
    if missing:
        fail(f"kernels never launched on the cross-device path: {missing}")
    # one K4 launch a training step and one K5 launch a cohort step,
    # each over every leaf (a client's 20 samples are one batch)
    cohort_steps = len(hist) * cfg.cross_device.cohort_size
    if not launches["sgd_accum"] == launches["fedavg_accum"] == cohort_steps:
        fail(f"{cohort_steps} cohort steps launched K4 "
             f"{launches['sgd_accum']} and K5 {launches['fedavg_accum']} "
             "times")

    # from the same seed: a streamed round and a round in two chunks
    streamed = CrossDeviceScenario(crossdev_config(prefetch="stream"),
                                   dataset=sc.data, device=dev)
    res = streamed.run(rounds=1)
    same = all(torch.equal(a, b)
               for a, b in zip(snapshot(streamed.fed), round1))
    print(f"  streamed round: {res.round_times_s[0]:.4f} s wall, "
          f"{streamed.crossdev_last}; params and momentum equal to the "
          f"materialized round bit for bit: {same}", flush=True)
    if not same:
        fail("the streamed round differs from the materialized round")
    chunked = CrossDeviceScenario(crossdev_config(cohort_shards=2),
                                  dataset=sc.data, device=dev)
    res = chunked.run(rounds=1)
    finite = all(bool(torch.isfinite(t).all()) for t in snapshot(chunked.fed))
    print(f"  2-chunk round: {res.round_times_s[0]:.4f} s wall, loss "
          f"{res.history[0]['Train/loss']:.4f}, finite: {finite}",
          flush=True)
    if not (finite and math.isfinite(res.history[0]["Train/loss"])):
        fail("the chunked cross-device round is not finite")
    del streamed, chunked

    def one_round():
        # a round as run() drives it, without the evaluation run() ends
        # with (the same draw for the next round, every client alive)
        from p2pfl_tpu_torch.federation.sampling import sample_cohorts

        c = sc.cd
        sampled, cohorts = sample_cohorts(c.n_clients, c.clients_per_round,
                                          c.cohort_size, sc.fed.round,
                                          seed=c.seed)
        sc._run_materialized_round(sampled, np.ones(cohorts.shape, bool))

    profile_round(one_round, out, "chip_smoke_crossdev_profile",
                  "cross-device round (no evaluation)")
    return launches, sc.data


def crossdev_headline(dev) -> None:
    """The JAX package's cross-device headline shape (bench.py's
    ``_phase_cross_device``): mnist-mlp, 10,000 clients, 256 a round in
    cohorts of 32 (8 slots), 50,000 synthetic samples, batch 32, lr
    0.1; 2 rounds, the second one's wall time."""
    from p2pfl_tpu_torch.config.schema import (
        CrossDeviceConfig,
        DataConfig,
        ScenarioConfig,
        TrainingConfig,
    )
    from p2pfl_tpu_torch.federation import CrossDeviceScenario

    cfg = ScenarioConfig(
        name="crossdev-headline",
        data=DataConfig(dataset="mnist", synthetic_train=50_000,
                        synthetic_test=2000, batch_size=32),
        training=TrainingConfig(rounds=2, epochs_per_round=1,
                                learning_rate=0.1, eval_every=0),
        cross_device=CrossDeviceConfig(n_clients=10_000,
                                       clients_per_round=256,
                                       cohort_size=32, seed=0),
        seed=0,
    )
    res = CrossDeviceScenario(cfg, device=dev).run()
    dt = res.round_times_s[1]
    print(f"  mnist-mlp N=10000 K=256 cohorts of 32: round 2 {dt:.4f} s "
          f"wall, {256 / dt:.1f} clients/s, rounds {res.round_times_s}, "
          f"accuracy {res.final_accuracy:.4f}", flush=True)


# ---------------------------------------------------------------------------
# phase 5: the fused-epoch path; phase 6: Byzantine DFL
# ---------------------------------------------------------------------------


def fused_epoch_path(dev) -> int:
    """5 epochs of ``fused_mlp_train_epoch`` at K6's headline shape,
    each from the last one's params and momentum; returns the launches."""
    import torch

    from p2pfl_tpu_torch.ops import gemm
    from p2pfl_tpu_torch.ops.fused_train import fused_mlp_train_epoch

    params, mom, bx, by = mlp_epoch_inputs(dev)
    k6_plan(bx.shape[0], MLP_BATCH, bx.shape[2], params[0].shape[2],
            params[2].shape[2], params[4].shape[2])
    losses, times = [], []
    gemm.reset_launches()
    for _ in range(5):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, mom, loss = fused_mlp_train_epoch(
            params, mom, bx, by, MLP_LR, 0.9, batch_size=MLP_BATCH)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        losses.append(float(loss.mean()))
    launches = gemm.launches["fused_mlp_train_epoch"]
    print(f"  epoch wall times (s) {[round(t, 5) for t in times]}; mean "
          f"loss {[round(v, 4) for v in losses]}; launches {launches}",
          flush=True)
    if launches != 5:
        fail(f"fused_mlp_train_epoch launched {launches} times in 5 epochs")
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite fused-epoch loss {losses}")
    if not losses[-1] < 0.8 * losses[0]:
        fail(f"fused-epoch loss did not fall: {losses}")
    if not all(bool(torch.isfinite(t).all()) for t in params + mom):
        fail("fused-epoch params are not finite")
    return launches


def byzantine_config(aggregator="fedavg", aggregator_kwargs=None,
                     attack=True, reputation=False, topology="fully"):
    """The JAX bench's robustness configuration (``bench.py``'s
    ``_phase_robust``): FEMNIST CNN at full width, 16 nodes, DFL, iid,
    256 samples a node, batch 64, lr 0.05, bf16 wire, a quarter of the
    nodes sign-flipping at scale 10; every node trains every round (the
    bench's plan: no train-set vote cap); 3 rounds, evaluated at the
    end."""
    from p2pfl_tpu_torch.config.schema import (
        AdversaryConfig,
        DataConfig,
        ModelConfig,
        ProtocolConfig,
        ScenarioConfig,
        TrainingConfig,
    )

    return ScenarioConfig(
        name="femnist-cnn-byzantine-16",
        federation="DFL",
        topology=topology,
        n_nodes=16,
        data=DataConfig(dataset="femnist", partition="iid",
                        samples_per_node=256, batch_size=64, seed=0),
        model=ModelConfig(model="femnist-cnn"),
        training=TrainingConfig(rounds=3, epochs_per_round=1,
                                learning_rate=0.05, eval_every=0),
        protocol=ProtocolConfig(train_set_size=0),
        aggregator=aggregator,
        aggregator_kwargs=aggregator_kwargs or {},
        adversary=AdversaryConfig(
            fraction=0.25 if attack else 0.0,
            kind="signflip" if attack else "none", scale=10.0, seed=0,
            reputation=reputation),
        transport="dense",
        wire_dtype="bf16",
        seed=0,
    )


def byzantine(dev) -> None:
    import numpy as np
    import torch

    from p2pfl_tpu_torch.core.pytree import tree_leaves
    from p2pfl_tpu_torch.datasets.data import FederatedDataset
    from p2pfl_tpu_torch.federation.scenario import Scenario
    from p2pfl_tpu_torch.ops import gemm

    base = byzantine_config()
    data = FederatedDataset.make(base.data, base.n_nodes)
    variants = [
        ("clean_fedavg", dict(attack=False)),
        ("signflip_fedavg", {}),
        ("signflip_krum", dict(aggregator="krum",
                               aggregator_kwargs={"f": 4, "m": 8})),
        ("signflip_trimmedmean", dict(aggregator="trimmedmean",
                                      aggregator_kwargs={"beta": 4})),
        ("signflip_fedmedian", dict(aggregator="fedmedian")),
        ("signflip_repfedavg", dict(reputation=True)),
    ]
    acc = {}
    for key, kw in variants:
        cfg = byzantine_config(**kw)
        sc = Scenario(cfg, dataset=data, device=dev)
        gemm.reset_launches()
        res = sc.run()
        torch.cuda.synchronize(dev)
        launches = dict(gemm.launches)
        acc[key] = res.final_accuracy
        finite = all(bool(torch.isfinite(t).all())
                     for t in tree_leaves(sc.fed.states.params))
        print(f"  {key:22s} s/round {[round(t, 4) for t in res.round_times_s]}"
              f" test accuracy {res.final_accuracy:.4f} finite {finite} "
              f"malicious {np.flatnonzero(sc.malicious).tolist()}",
              flush=True)
        missing = [k for k in DENSE_PATH if launches[k] <= 0]
        if missing:
            fail(f"{key}: kernels never launched: {missing}")
        check_k4_per_step(sc, launches, len(res.history))
        if key != "signflip_fedavg" and not finite:
            fail(f"{key}: params are not finite")
        if cfg.adversary.reputation:
            trust = np.asarray(res.history[0]["trust"])
            cut = cfg.adversary.reputation_cutoff
            print(f"  trust after round 1 {np.round(trust, 4).tolist()} "
                  f"(cutoff {cut})", flush=True)
            if not (np.all(trust[sc.malicious] < cut)
                    and np.all(trust[~sc.malicious] > cut)):
                fail("reputation did not cut off exactly the attackers")
        del sc
        torch.cuda.empty_cache()
    for key in ("signflip_krum", "signflip_trimmedmean", "signflip_fedmedian"):
        if not acc[key] >= acc["signflip_fedavg"]:
            fail(f"{key} accuracy {acc[key]} below undefended FedAvg's "
                 f"{acc['signflip_fedavg']}")

    # the per-row branch: TrimmedMean on a 16-node ring, one round
    cfg = byzantine_config(aggregator="trimmedmean",
                           aggregator_kwargs={"beta": 4}, topology="ring")
    sc = Scenario(cfg, dataset=data, device=dev)
    res = sc.run(rounds=1)
    finite = all(bool(torch.isfinite(t).all())
                 for t in tree_leaves(sc.fed.states.params))
    print(f"  ring per-row trimmedmean: {res.round_times_s[0]:.4f} s, "
          f"finite {finite}", flush=True)
    if not finite:
        fail("the per-row TrimmedMean round is not finite")


# ---------------------------------------------------------------------------
# phase 7: the private and elastic federation
# ---------------------------------------------------------------------------

# DP-FedAvg (the JAX bench's ``_phase_private``): clip, delta, rounds
DP_NODES, DP_ROUNDS, DP_CLIP, DP_DELTA = 8, 10, 1.0, 1e-5
DP_SIGMAS = (None, 0.3, 0.6, 1.0)  # None: the clean reference
DP_SE = 5.0  # noise moments within this many standard errors
FAST_CLOCK = dict(heartbeat_period_s=4.0, node_timeout_s=3.0)


def check_path(tag: str, launches: dict, need) -> None:
    missing = [k for k in need if launches[k] <= 0]
    if missing:
        fail(f"{tag}: kernels never launched: {missing}")


def rows_of(tree, idx):
    from p2pfl_tpu_torch.core.pytree import tree_map

    return tree_map(lambda t: t[idx], tree)


def device_summary(fn) -> tuple[float, float, int]:
    """``fn()`` under ``torch.profiler``: (wall ms, device kernel ms,
    device kernel launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cupti = {"Activity Buffer Request", "Command Buffer Full",
             "Buffer Flush"}
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA
          and e.self_device_time_total > 0 and e.key not in cupti]
    return (wall_ms, sum(e.self_device_time_total for e in ev) / 1e3,
            sum(e.count for e in ev))


def dp_config(sigma):
    """The JAX bench's accuracy-against-epsilon shape (``bench.py``'s
    ``_phase_private``): FEMNIST CNN at full width, 8 nodes fully
    connected, DFL, iid, 256 samples a node, batch 64, lr 0.05, bf16
    wire, clip 1.0, delta 1e-5, 10 rounds evaluated at the end; DP on
    every node at noise multiplier ``sigma`` (None: off)."""
    from p2pfl_tpu_torch.config.schema import (
        DataConfig,
        ModelConfig,
        PrivacyConfig,
        ScenarioConfig,
        TrainingConfig,
    )

    return ScenarioConfig(
        name="femnist-cnn-dp-8", federation="DFL", topology="fully",
        n_nodes=DP_NODES,
        data=DataConfig(dataset="femnist", partition="iid",
                        samples_per_node=256, batch_size=64, seed=0),
        model=ModelConfig(model="femnist-cnn"),
        training=TrainingConfig(rounds=DP_ROUNDS, epochs_per_round=1,
                                learning_rate=0.05, eval_every=0),
        privacy=PrivacyConfig(dp=sigma is not None, clip_norm=DP_CLIP,
                              noise_multiplier=sigma or 0.0,
                              delta=DP_DELTA),
        transport="dense", wire_dtype="bf16", seed=0)


def dp_gates(trained, ref) -> dict:
    """``privatize_stacked`` on the card on a trained stack against its
    round-start params: at noise 0 (the run's clip, and a binding clip
    of half the smallest row's delta norm) every masked row's delta
    norm is within the clip and every unmasked row keeps its bits; at
    noise 1.0 two calls give the same bits and the noise has its
    moments. Returns the privatize call's profile."""
    import numpy as np
    import torch

    from p2pfl_tpu_torch.core.pytree import tree_leaves
    from p2pfl_tpu_torch.privacy import dp

    n = DP_NODES
    mask = np.ones(n, bool)
    mask[[2, 5]] = False
    on = torch.from_numpy(mask).to(tree_leaves(ref)[0].device)
    norms = [float(dp.update_norm(rows_of(trained, i), rows_of(ref, i)))
             for i in range(n)]
    binding = 0.5 * min(norms)
    for clip in (DP_CLIP, binding):
        spec = dp.DPSpec(clip_norm=clip, noise_multiplier=0.0, seed=0)
        out = dp.privatize_stacked(trained, ref, mask, DP_ROUNDS, spec)
        got = [float(dp.update_norm(rows_of(out, i), rows_of(ref, i)))
               for i in np.flatnonzero(mask)]
        kept = all(torch.equal(a[~on], b[~on]) for a, b in
                   zip(tree_leaves(out), tree_leaves(trained)))
        print(f"  privatize_stacked at noise 0, clip {clip:.4g}: masked "
              f"delta norms {[round(v, 4) for v in got]} (before "
              f"{[round(v, 4) for v in norms]}); unmasked rows kept "
              f"bit for bit: {kept}", flush=True)
        if not kept or max(got) > clip * (1 + 1e-6):
            fail(f"privatize_stacked at clip {clip}: norms {got}, "
                 f"unmasked rows kept {kept}")
    spec = dp.DPSpec(clip_norm=DP_CLIP, noise_multiplier=1.0, seed=0)
    a = dp.privatize_stacked(ref, ref, mask, DP_ROUNDS, spec)
    b = dp.privatize_stacked(ref, ref, mask, DP_ROUNDS, spec)
    same = all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    noise = torch.cat([(x[on] - r[on]).double().reshape(-1)
                       for x, r in zip(tree_leaves(a), tree_leaves(ref))])
    std = float(dp.noise_sigma(DP_CLIP, 1.0))
    count = noise.numel()
    mean, sd = float(noise.mean()), float(noise.std())
    print(f"  privatize_stacked at noise 1.0: two calls same bits {same}; "
          f"noise over {count} values: mean {mean:.3g} (bound "
          f"{DP_SE * std / math.sqrt(count):.3g}), std {sd:.6f} (want "
          f"{std} +- {DP_SE * std / math.sqrt(2 * count):.3g})", flush=True)
    if not same:
        fail("privatize_stacked gives other bits on a second call")
    if (abs(mean) > DP_SE * std / math.sqrt(count)
            or abs(sd - std) > DP_SE * std / math.sqrt(2 * count)):
        fail(f"DP noise moments off: mean {mean}, std {sd}")
    wall, busy, kernels = device_summary(
        lambda: dp.privatize_stacked(trained, ref, np.ones(n, bool),
                                     DP_ROUNDS, spec))
    print(f"  privatize_stacked over {n} rows at noise 1.0 (one round's "
          f"call): {wall:.2f} ms wall, {busy:.3f} ms device, {kernels} "
          "device kernels", flush=True)
    return {"privatize_wall_ms": wall, "privatize_device_ms": busy,
            "privatize_kernels": kernels}


def private_federation(dev) -> dict:
    """Arm a: DP-FedAvg at each noise multiplier, 10 rounds each."""
    import torch

    from p2pfl_tpu_torch.core.pytree import tree_map
    from p2pfl_tpu_torch.datasets.data import FederatedDataset
    from p2pfl_tpu_torch.federation import Events, Scenario
    from p2pfl_tpu_torch.ops import gemm
    from p2pfl_tpu_torch.privacy.dp import epsilon_at

    data = FederatedDataset.make(dp_config(None).data, DP_NODES)
    out, kept = {}, {}
    for sigma in DP_SIGMAS:
        cfg = dp_config(sigma)
        sc = Scenario(cfg, dataset=data, device=dev)
        snap = {}

        def keep_ref(ev, payload, sc=sc, snap=snap):
            if (ev is Events.ROUND_STARTED
                    and payload["round"] == DP_ROUNDS - 1):
                snap["ref"] = tree_map(torch.clone, sc.fed.states.params)

        sc.add_observer(keep_ref)
        gemm.reset_launches()
        res = sc.run()
        torch.cuda.synchronize(dev)
        launches = dict(gemm.launches)
        tag = "clean" if sigma is None else f"sigma {sigma}"
        check_path(f"DP {tag}", launches, DENSE_PATH)
        check_k4_per_step(sc, launches, len(res.history))
        warm = res.round_times_s[1:]
        eps = sc.accountant.epsilon if sc.accountant is not None else None
        print(f"  DP {tag:10s}: s/round (rounds 2-{DP_ROUNDS}) mean "
              f"{sum(warm) / len(warm):.4f} median "
              f"{sorted(warm)[len(warm) // 2]:.4f}; final accuracy "
              f"{res.final_accuracy:.4f}; epsilon {eps}; launches "
              f"{launches}", flush=True)
        if sigma is not None and eps != epsilon_at(sigma, DP_ROUNDS,
                                                   DP_DELTA):
            fail(f"DP {tag}: epsilon {eps} is not epsilon_at's")
        out[tag] = {"round_times_s": res.round_times_s,
                    "final_accuracy": res.final_accuracy, "epsilon": eps}
        if sigma is None or sigma == 1.0:
            kept[tag] = (sc, snap["ref"])
        else:
            del sc
            torch.cuda.empty_cache()
    clean, ref = kept["clean"]
    out["privatize"] = dp_gates(clean.fed.states.params, ref)
    for tag, (sc, _) in kept.items():
        wall, busy, kernels = device_summary(lambda: sc.run(rounds=1))
        print(f"  profiled {tag} round (+ evaluation): {wall:.1f} ms wall, "
              f"{busy:.1f} ms device, {kernels} device kernels",
              flush=True)
        out["privatize"][f"{tag}_round"] = [wall, busy, kernels]
    return out


def ring_faults(dev, data) -> dict:
    """Arm b: the phase-3 ring with node 3 crashing at round 1 and
    joining at round 3 under a 4 s heartbeat and a 3 s timeout, 5
    rounds."""
    import dataclasses

    import numpy as np
    import torch

    from p2pfl_tpu_torch.config.schema import FaultEvent, ProtocolConfig
    from p2pfl_tpu_torch.core.pytree import tree_leaves
    from p2pfl_tpu_torch.federation import Events, Scenario
    from p2pfl_tpu_torch.ops import gemm

    base = smoke_config()
    cfg = dataclasses.replace(
        base, name="femnist-cnn-ring-8-faults",
        training=dataclasses.replace(base.training, rounds=5),
        protocol=ProtocolConfig(**FAST_CLOCK),
        faults=[FaultEvent(node=3, round=1, kind="crash"),
                FaultEvent(node=3, round=3, kind="join")])
    sc = Scenario(cfg, dataset=data, device=dev)
    joined = []

    def on_join(ev, payload):
        if ev is Events.NODE_JOINED:
            i, src = payload["node"], sc.leader
            joined.append(all(torch.equal(t[i], t[src])
                              for t in tree_leaves(sc.fed.states.params)))

    sc.add_observer(on_join)
    # the JAX rule at one 4 s period a round and a 3 s timeout: silent
    # from round 1 (last beat at 4 s, 8 - 4 > 3), back at the join
    dead = [False, True, True, False, False]
    gemm.reset_launches()
    hist, rows = [], []
    for _ in range(cfg.training.rounds):
        res = sc.run(rounds=1)
        hist += res.history
        rows.append([t[3].clone() for t in tree_leaves(sc.fed.states.params)])
    torch.cuda.synchronize(dev)
    launches = dict(gemm.launches)
    check_path("ring faults", launches, DENSE_PATH)
    check_k4_per_step(sc, launches, len(hist))
    alive = [h["alive"] for h in hist]
    want = [[not (d and i == 3) for i in range(N_NODES)] for d in dead]
    kept = all(torch.equal(a, b) for a, b in zip(rows[0], rows[2]))
    survivors = [i for i in range(N_NODES) if i != 3]
    loss = [float(np.mean([h["train_loss"][i] for i in survivors]))
            for h in hist]
    print(f"  ring faults: s/round {[round(h['round_time_s'], 4) for h in hist]}"
          f"; alive per round {[sum(a) for a in alive]} (node 3 "
          f"{[a[3] for a in alive]}); dead row kept bit for bit over its "
          f"dead rounds: {kept}; joiner row equal to the leader's after "
          f"the copy: {joined}; survivors' mean train loss "
          f"{[round(v, 4) for v in loss]}; launches {launches}", flush=True)
    if alive != want:
        fail(f"ring faults: alive masks {alive}, want {want}")
    if not kept:
        fail("ring faults: the dead node's params moved while it was dead")
    if joined != [True]:
        fail(f"ring faults: join row copy {joined}")
    if not loss[-1] < loss[0]:
        fail(f"ring faults: survivors' train loss did not fall: {loss}")
    return {"round_times_s": [h["round_time_s"] for h in hist],
            "alive": alive, "survivor_loss": loss}


def leader_faults(dev, data) -> dict:
    """Arm c: CFL on a star with the server crashing at round 0 (the
    leader fails over to the lowest alive index), and SDFL with node 2
    dead from round 0 (never drawn as leader); 3 rounds each on the
    phase-3 data."""
    import dataclasses

    import torch

    from p2pfl_tpu_torch.config.schema import FaultEvent, ProtocolConfig
    from p2pfl_tpu_torch.federation import Scenario
    from p2pfl_tpu_torch.ops import gemm

    out = {}
    for fed, topo, node in (("CFL", "star", 0), ("SDFL", "fully", 2)):
        base = smoke_config()
        cfg = dataclasses.replace(
            base, name=f"femnist-cnn-{fed.lower()}-8-faults",
            federation=fed, topology=topo, nodes=[],
            training=dataclasses.replace(base.training, rounds=3),
            protocol=ProtocolConfig(**FAST_CLOCK),
            faults=[FaultEvent(node=node, round=0, kind="crash")])
        sc = Scenario(cfg, dataset=data, device=dev)
        gemm.reset_launches()
        res = sc.run()
        torch.cuda.synchronize(dev)
        launches = dict(gemm.launches)
        check_path(f"{fed} faults", launches, DENSE_PATH)
        check_k4_per_step(sc, launches, len(res.history))
        leaders = [h["leader"] for h in res.history]
        alive = [h["alive"] for h in res.history]
        print(f"  {fed} with node {node} dead from round 0: s/round "
              f"{[round(t, 4) for t in res.round_times_s]}; leaders "
              f"{leaders}; accuracy {res.final_accuracy:.4f}", flush=True)
        if any(a[node] for a in alive):
            fail(f"{fed}: node {node} not dead: {alive}")
        if fed == "CFL" and leaders != [1, 1, 1]:
            fail(f"CFL fail-over: leaders {leaders}, want [1, 1, 1]")
        if not all(a[ld] for a, ld in zip(alive, leaders)):
            fail(f"{fed}: a dead node led a round: {leaders}")
        out[fed] = {"round_times_s": res.round_times_s, "leaders": leaders}
        del sc
        torch.cuda.empty_cache()
    return out


def elastic(dev) -> dict:
    """Arm d: the JAX bench's SPMD elastic arm (``bench.py``'s
    ``_phase_elastic``): mnist-mlp at full width, 24 nodes on a ring,
    128 samples a node, 12 rounds, lr 0.1, 20% churn, a quarter of the
    nodes 4x stragglers, staleness beta 0.5, seed 7; the staleness
    column off, then on. The mlp has no convolution and no gated dense
    layer, so K4 is its only kernel (as in the JAX package)."""
    import numpy as np
    import torch

    from p2pfl_tpu_torch.config.schema import (
        DataConfig,
        ElasticConfig,
        ScenarioConfig,
        TrainingConfig,
    )
    from p2pfl_tpu_torch.federation import Scenario
    from p2pfl_tpu_torch.ops import gemm
    from p2pfl_tpu_torch.parallel.federated import staleness_scale

    target, out = 0.85, {}
    for weighted in (False, True):
        cfg = ScenarioConfig(
            name="elastic-spmd", n_nodes=24, topology="ring",
            data=DataConfig(dataset="mnist", samples_per_node=128),
            training=TrainingConfig(rounds=12, epochs_per_round=1,
                                    learning_rate=0.1, eval_every=1),
            elastic=ElasticConfig(async_aggregation=weighted,
                                  staleness_beta=0.5,
                                  straggler_fraction=0.25,
                                  straggler_factor=4.0,
                                  churn_fraction=0.2),
            seed=7)
        sc = Scenario(cfg, device=dev)
        gemm.reset_launches()
        res = sc.run(target_accuracy=target)
        torch.cuda.synchronize(dev)
        launches = dict(gemm.launches)
        check_path("elastic", launches, ("sgd_accum",))
        check_k4_per_step(sc, launches, len(res.history))
        slow = np.asarray([nc.fit_slowdown for nc in cfg.nodes], np.float32)
        want = staleness_scale(slow - 1.0, 0.5) if weighted else None
        ok = (sc._stale_scale is None if want is None
              else np.array_equal(sc._stale_scale, want))
        tag = "weighted" if weighted else "unweighted"
        print(f"  elastic {tag}: rounds_to_target({target}) "
              f"{res.rounds_to_target}; final accuracy "
              f"{res.final_accuracy:.4f}; s/round median "
              f"{sorted(res.round_times_s)[6]:.4f}; alive per round "
              f"{[sum(h['alive']) for h in res.history]}; stragglers "
              f"{np.flatnonzero(slow > 1).tolist()}; faults "
              f"{[(f.node, f.round, f.kind) for f in cfg.faults]}; stale "
              f"scale equal to staleness_scale: {ok}", flush=True)
        if not ok:
            fail(f"elastic {tag}: _stale_scale {sc._stale_scale} != {want}")
        out[tag] = {"rounds_to_target": res.rounds_to_target,
                    "final_accuracy": res.final_accuracy,
                    "round_times_s": res.round_times_s}
        del sc
        torch.cuda.empty_cache()
    return out


def crossdev_churn(dev, data) -> dict:
    """Arm e: the phase-4 cross-device round with clients 0-999
    crashing at round 0 and joining at round 2 (4 s heartbeat, 3 s
    timeout), 3 rounds."""
    import dataclasses

    import numpy as np
    import torch

    from p2pfl_tpu_torch.config.schema import FaultEvent, ProtocolConfig
    from p2pfl_tpu_torch.federation import CrossDeviceScenario
    from p2pfl_tpu_torch.ops import gemm

    base = crossdev_config()
    cfg = dataclasses.replace(
        base, name="femnist-cnn-crossdev-churn",
        protocol=ProtocolConfig(**FAST_CLOCK),
        faults=[FaultEvent(node=i, round=r, kind=k)
                for r, k in ((0, "crash"), (2, "join"))
                for i in range(1000)])
    sc = CrossDeviceScenario(cfg, dataset=data, device=dev)
    gemm.reset_launches()
    counts, dead_drawn, hist = [], [], []
    for r in range(cfg.training.rounds):
        res = sc.run(rounds=1)
        h = res.history[0]
        hist.append(h)
        want = (sc.last_cohorts >= 1000) if r < 2 else np.ones(
            sc.last_cohorts.shape, bool)
        if not (np.array_equal(sc.last_cohort_alive, want)
                and h["CrossDev/clients_alive"] == int(want.sum())):
            fail(f"cross-device churn round {r}: alive "
                 f"{h['CrossDev/clients_alive']}, membership mask "
                 f"{int(want.sum())}")
        counts.append(h["CrossDev/clients_alive"])
        dead_drawn.append(int((~sc.last_cohort_alive).sum()))
    torch.cuda.synchronize(dev)
    launches = dict(gemm.launches)
    check_path("cross-device churn", launches, CROSS_PATH)
    steps = len(hist) * cfg.cross_device.cohort_size
    finite = all(bool(torch.isfinite(t).all()) for t in snapshot(sc.fed))
    print(f"  cross-device churn: s/round "
          f"{[round(h['round_time_s'], 4) for h in hist]}; clients_alive "
          f"{counts} of {cfg.cross_device.clients_per_round} (dead drawn "
          f"{dead_drawn}); loss {[round(h['Train/loss'], 4) for h in hist]}"
          f"; finite {finite}; launches {launches}", flush=True)
    if not launches["sgd_accum"] == launches["fedavg_accum"] == steps:
        fail(f"cross-device churn: {steps} cohort steps launched K4 "
             f"{launches['sgd_accum']} and K5 {launches['fedavg_accum']}")
    if not (sum(dead_drawn[:2]) > 0 and finite
            and all(math.isfinite(h["Train/loss"]) for h in hist)):
        fail(f"cross-device churn: dead drawn {dead_drawn}, finite {finite}")
    return {"round_times_s": [h["round_time_s"] for h in hist],
            "clients_alive": counts, "dead_drawn": dead_drawn}


# ---------------------------------------------------------------------------
# phase 8: the learning knobs (dtypes, optimizers, objectives)
# ---------------------------------------------------------------------------

F32_PATH = ("stream_gemm_f32", "stream_wgrad_f32", "dense_bwd_f32")
BF16_GEMMS = ("stream_gemm", "stream_wgrad", "dense_bwd")


def ring_config(name: str, *, n: int = N_NODES, rounds: int = 3,
                model: dict | None = None, seed: int = 0, **training):
    """Phase 3's ring (FEMNIST CNN at full width, DFL, FedAvg, bf16
    wire, 750 samples a node, batch 336, 1 epoch a round) with
    ``model`` and ``training`` overrides, its data and init from
    ``seed``; the surrogate sized so that every node gets its 750
    samples (``bench.py``'s ``_build``)."""
    from p2pfl_tpu_torch.config.schema import (
        DataConfig,
        ModelConfig,
        ScenarioConfig,
        TrainingConfig,
    )

    kw = dict(rounds=rounds, epochs_per_round=1, learning_rate=0.05,
              eval_every=0)
    kw.update(training)
    return ScenarioConfig(
        name=name, federation="DFL", topology="ring", n_nodes=n,
        data=DataConfig(dataset="femnist", samples_per_node=750,
                        batch_size=BATCH, seed=seed,
                        synthetic_train=int(n * 750 / 0.9) + n),
        model=ModelConfig(model="femnist-cnn", **(model or {})),
        training=TrainingConfig(**kw), transport="dense", wire_dtype="bf16",
        seed=seed)


def run_arm(tag: str, sc, rounds: int | None = None) -> dict:
    """Zero the launch counts, run, read them: s/round, the training
    peak memory (read as each round's aggregation finishes, before any
    evaluation), the mean train loss of every round."""
    import torch

    from p2pfl_tpu_torch.federation.events import Events
    from p2pfl_tpu_torch.ops import gemm

    peak = [0, 0]  # training's, and with the evaluations

    def on_round(ev, payload):
        if ev == Events.AGGREGATION_FINISHED:
            peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
        elif ev == Events.ROUND_FINISHED:
            # a round's evaluation must not count as the next's training
            peak[1] = max(peak[1], torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()

    sc.add_observer(on_round)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gemm.reset_launches()
    res = sc.run(rounds)
    torch.cuda.synchronize()
    launches = dict(gemm.launches)
    losses = [float(sum(h["train_loss"]) / len(h["train_loss"]))
              for h in res.history]
    # (round, mean accuracy) of each evaluation; the run ends with one
    evals = [(h["round"] + 1, h["eval"]["mean_accuracy"])
             for h in res.history if "eval" in h]
    if "eval" not in res.history[-1]:
        evals.append((res.history[-1]["round"] + 1, res.final_accuracy))
    out = dict(round_s=res.round_times_s, losses=losses,
               peak_train_gib=peak[0] / 2 ** 30,
               peak_gib=max(peak[1], torch.cuda.max_memory_allocated())
               / 2 ** 30,
               accuracy=res.final_accuracy, evals=evals, launches=launches)
    print(f"  {tag}: rounds {[round(t, 4) for t in res.round_times_s]} s, "
          f"mean train loss {[round(v, 4) for v in losses]}, accuracy "
          f"{res.final_accuracy:.4f}, peak memory {out['peak_train_gib']:.2f}"
          f" GiB training / {out['peak_gib']:.2f} GiB with the evaluation; "
          f"launches { {k: v for k, v in launches.items() if v} }",
          flush=True)
    if not all(math.isfinite(v) for v in losses):
        fail(f"{tag}: non-finite train loss {losses}")
    return out


class PlainVersions:
    """Inside the block the wrappers of the kernels a training step runs
    (K1-K4) are their plain versions, module-wide (the autograd
    functions and the learner look them up by name): the reference
    step."""

    NAMES = {"stream_gemm": "stream_gemm_plain",
             "stream_wgrad": "stream_wgrad_plain",
             "dense_bwd": "dense_bwd_plain",
             "sgd_accum_many": "sgd_accum_many_plain"}

    def __enter__(self):
        from p2pfl_tpu_torch.ops import gemm

        self.gemm = gemm
        self.saved = {k: getattr(gemm, k) for k in self.NAMES}
        for k, plain in self.NAMES.items():
            setattr(gemm, k, getattr(gemm, plain))
        return self

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(self.gemm, k, fn)



def check_step_vs_plain(tag: str, sc, bf16_params: bool,
                        twice: bool = False) -> dict:
    """One training step from ``sc``'s state on its first batch through
    the kernels (``train_step``) and through their plain versions (the
    same step inside ``PlainVersions``). f32 params: the loss within
    1e-2 (bf16 compute) or 1e-5 (f32 compute) relative; bf16 compute:
    each leaf's update within relative L2 5e-2 of the plain step's (f32
    compute: read here, held leaf by leaf on the gradients by
    ``check_f32_grads``). bf16 params (whose updates are mostly below a
    bf16 ulp): the loss within 1e-2, the new trace (gradient plus
    decayed trace) within relative L2 5e-2 a leaf, and every param
    within one bf16 ulp (of the larger value) plus lr times the most the
    two unrounded traces can differ by (the stored traces' difference
    plus one bf16 ulp of the trace): the most two roundings of p - lr m
    can differ by. ``twice``: a second kernel step from the same state
    must give the same bits (cuDNN's deterministic algorithms, K2's
    fixed sum order)."""
    import torch

    from p2pfl_tpu_torch.core.pytree import tree_leaves

    cfg = sc.config
    f32 = sc.model.dtype == torch.float32
    st = sc.fed.states
    x, y, mask, _ = sc._data_args
    b = cfg.data.batch_size
    bx, by, bm = x[:, :b], y[:, :b], mask[:, :b]
    k_state, k_loss = sc.fns.train_step(st, bx, by, bm)
    same = None
    if twice:
        again, again_loss = sc.fns.train_step(st, bx, by, bm)
        same = torch.equal(k_loss, again_loss) and all(
            torch.equal(a, c) for a, c in zip(
                tree_leaves(k_state.params), tree_leaves(again.params)))
        del again
    with PlainVersions():
        p_state, p_loss = sc.fns.train_step(st, bx, by, bm)
    lr = cfg.training.learning_rate
    loss_err = float((k_loss - p_loss).abs().max() / p_loss.abs().max())
    loss_tol, upd_tol = (1e-5, None) if f32 else (1e-2, 5e-2)
    worst, ok = 0.0, loss_err <= loss_tol
    for p0, pk, pp, mk, mp in zip(
            tree_leaves(st.params), tree_leaves(k_state.params),
            tree_leaves(p_state.params), tree_leaves(k_state.opt_state),
            tree_leaves(p_state.opt_state)):
        if bf16_params:
            mk, mp = mk.float(), mp.float()
            worst = max(worst, float((mk - mp).norm() / mp.norm()))
            a, b = pk.float(), pp.float()
            room = (bf16_ulp(torch.maximum(a.abs(), b.abs()))
                    + lr * ((mk - mp).abs()
                            + bf16_ulp(torch.maximum(mk.abs(), mp.abs()))))
            ok = ok and bool(((a - b).abs() <= room).all())
        else:
            uk, up = (pk - p0).float(), (pp - p0).float()
            worst = max(worst, float((uk - up).norm() / up.norm()))
    if upd_tol is not None:
        ok = ok and worst <= upd_tol
    what = "trace" if bf16_params else "update"
    extra = "; params within a bf16 ulp + lr |dm|" if bf16_params else ""
    tol = (f"tol {upd_tol:g}" if upd_tol is not None
           else "held on the gradients against f64 below")
    bits = "" if same is None else f"; two kernel steps bit for bit: {same}"
    print(f"  {tag}: one step kernels vs plain: loss rel err {loss_err:.3g} "
          f"(tol {loss_tol:g}), {what} rel L2 err {worst:.3g} ({tol})"
          f"{extra}{bits}", flush=True)
    if same is False:
        fail(f"{tag}: two kernel steps from one state differ")
    if not ok:
        fail(f"{tag}: kernel step and plain step disagree")
    return dict(loss_rel_err=loss_err, rel_l2_err=worst, same_bits=same)


def initial_state(sc):
    """A copy of ``sc``'s training state, kept apart from its run."""
    import dataclasses

    import torch

    from p2pfl_tpu_torch.core.pytree import tree_map

    st = sc.fed.states
    return dataclasses.replace(st, params=tree_map(torch.clone, st.params))


def f32_grad_readings(sc, state, batch: int) -> dict:
    """One step from ``state`` with a zero trace on batch ``batch``, for
    the kernel step (its new trace), the plain f32 step and the TF32
    control: each leaf's gradient of each node against the f64 step that
    takes the same ReLU and max-pool decisions, in relative L2 (``vs
    f64``: ``{arm: [leaf][node]}``); the arm's worst leaf against the
    f64 step with its own decisions (``vs free f64``); and how many
    decisions the arm took otherwise than that f64 step (``flips``)."""
    import dataclasses

    from p2pfl_tpu_torch.core.pytree import tree_leaves

    cfg = sc.config
    zero = dataclasses.replace(state,
                               opt_state=sc.fns.init_opt_state(state.params))
    x, y, mask, _ = sc._data_args
    cut = slice(batch * BATCH, (batch + 1) * BATCH)
    bx, by, bm = x[:, cut], y[:, cut], mask[:, cut]
    args = (sc.model, zero, bx, by, bm, cfg.training.learning_rate,
            cfg.training.momentum)

    def rel(g, r):
        n = r.shape[0]
        d = (g.double() - r).reshape(n, -1).norm(dim=1)
        return (d / r.reshape(n, -1).norm(dim=1)).tolist()

    free = []
    free_grads = plain_step(*args, f64=True, record=free)[3]
    k_state, _ = sc.fns.train_step(zero, bx, by, bm)
    out = {}
    for arm, kw in (("kernel", dict(kernel_fwd=True)), ("plain_f32", {}),
                    ("tf32_control", dict(tf32_k13=True))):
        seen = []
        grads = plain_step(*args, record=seen, **kw)[3]
        if arm == "kernel":  # the decisions of its forward through K1
            grads = tree_leaves(k_state.opt_state)
        ref = plain_step(*args, f64=True, taken=seen)[3]
        out[arm] = {
            "vs f64": [rel(g, r) for g, r in zip(grads, ref)],
            "vs free f64": max(max(rel(g, r))
                               for g, r in zip(grads, free_grads)),
            "flips": sum(int((a != b).sum()) for a, b in zip(seen, free))}
    return out


def check_f32_grads(tag: str, states) -> dict:
    """f32 compute: ``f32_grad_readings`` at each ``(label, scenario,
    state)`` of ``states`` and each of the first ``F32_GRAD_BATCHES``
    batches. Every leaf of every node of the kernel step and of the plain
    f32 step within ``F32_GRAD_TOL`` of the f64 step through the same
    decisions; the TF32 control's worst leaf over it at every state and
    batch."""
    names = list(FEMNIST_CNN_LEAVES)
    runs, ok = [], True
    for label, sc, state in states:
        for batch in range(F32_GRAD_BATCHES):
            r = f32_grad_readings(sc, state, batch)
            worst = {arm: max(max(node) for node in rd["vs f64"])
                     for arm, rd in r.items()}
            print(f"    {label}, batch {batch}: worst leaf of any node " +
                  ", ".join(f"{arm} {worst[arm]:.3g} ({v['flips']} flips, "
                            f"{v['vs free f64']:.3g} against the free f64)"
                            for arm, v in r.items()), flush=True)
            ok = (ok and worst["kernel"] <= F32_GRAD_TOL
                  and worst["plain_f32"] <= F32_GRAD_TOL
                  and worst["tf32_control"] > F32_GRAD_TOL)
            runs.append(dict(state=label, batch=batch, readings=r))
    per_leaf = {arm: {name: max(max(run["readings"][arm]["vs f64"][i])
                                for run in runs)
                      for i, name in enumerate(names)}
                for arm in runs[0]["readings"]}
    control_least = min(max(max(v) for v in
                            run["readings"]["tf32_control"]["vs f64"])
                        for run in runs)
    for arm, leaves in per_leaf.items():
        print(f"  {tag}: {arm} gradient against f64, worst node and state "
              "a leaf: " + ", ".join(f"{k} {v:.3g}" for k, v in leaves.items()),
              flush=True)
    print(f"  {tag}: over {len(runs)} states and batches: kernel worst "
          f"{max(per_leaf['kernel'].values()):.4g}, plain f32 worst "
          f"{max(per_leaf['plain_f32'].values()):.4g} (limit "
          f"{F32_GRAD_TOL:g}); the TF32 control's worst leaf at its least "
          f"{control_least:.4g} (must exceed the limit)", flush=True)
    if not ok:
        fail(f"{tag}: the f32 gradients against f64 break the limit, or "
             "the TF32 control does not")
    return dict(runs=runs, per_leaf=per_leaf, control_least=control_least,
                limit=F32_GRAD_TOL)


def headline(dev) -> dict:
    """a. The JAX bench's headline (``bench.py``'s ``_phase_headline``
    through ``_build``'s defaults): FEMNIST CNN, 64 nodes, ring, DFL,
    FedAvg, 750 samples a node, batch 336, lr 0.05, SGD momentum 0.9,
    bf16 params and bf16 trace, bf16 compute and wire, 3 rounds."""
    import torch

    from p2pfl_tpu_torch.core.pytree import tree_leaves
    from p2pfl_tpu_torch.federation.scenario import Scenario

    cfg = ring_config("femnist-cnn-ring-64-bf16", n=HEADLINE_NODES,
                      model={"param_dtype": "bf16"}, momentum_dtype="bf16")
    t0 = time.perf_counter()
    sc = Scenario(cfg, device=dev)
    print(f"  setup {time.perf_counter() - t0:.1f} s (data for "
          f"{HEADLINE_NODES} x 750 samples, init)", flush=True)
    out = run_arm("headline", sc)
    ln = out["launches"]
    check_path("headline", ln, DENSE_PATH + ("sgd_accum_bf16",))
    steps = steps_of(sc, 3)
    if not ln["sgd_accum"] == ln["sgd_accum_bf16"] == steps:
        fail(f"headline: K4 launched {ln['sgd_accum']} times "
             f"({ln['sgd_accum_bf16']} with bf16 params) in {steps} steps")
    if not out["losses"][-1] < out["losses"][0]:
        fail(f"headline: train loss did not fall: {out['losses']}")
    leaves = tree_leaves(sc.fed.states.params)
    traces = tree_leaves(sc.fed.states.opt_state)
    if not all(t.dtype == torch.bfloat16 for t in leaves + traces):
        fail("headline: params or trace left bf16")
    if not all(bool(torch.isfinite(t).all()) for t in leaves):
        fail("headline: params are not finite")
    out["steps"] = steps
    out["step_vs_plain"] = check_step_vs_plain("headline", sc, True)
    del sc
    torch.cuda.empty_cache()
    return out


def f32_compute(dev) -> dict:
    """b. Phase 3's 8-node ring with ``compute_dtype`` float32, 3
    rounds: the f32 K1-K3 launch and the bf16 ones do not."""
    import torch

    from p2pfl_tpu_torch.federation.scenario import Scenario

    cfg = ring_config("femnist-cnn-ring-8-f32",
                      model={"compute_dtype": "float32"})
    sc = Scenario(cfg, device=dev)
    start = initial_state(sc)
    out = run_arm("f32 compute", sc)
    ln = out["launches"]
    check_path("f32 compute", ln, F32_PATH + ("sgd_accum",))
    if any(ln[k] for k in BF16_GEMMS):
        fail(f"f32 compute launched bf16 kernels: {ln}")
    if ln["sgd_accum"] != steps_of(sc, 3):
        fail(f"f32 compute: K4 launched {ln['sgd_accum']} times")
    if not out["losses"][-1] < out["losses"][0]:
        fail(f"f32 compute: train loss did not fall: {out['losses']}")
    out["step_vs_plain"] = check_step_vs_plain("f32 compute", sc, False)
    states, rings = [], [sc]
    for seed in F32_GRAD_SEEDS:
        if seed:
            cfg = ring_config(f"femnist-cnn-ring-8-f32-seed{seed}", seed=seed,
                              model={"compute_dtype": "float32"})
            rings.append(Scenario(cfg, device=dev))
            start = initial_state(rings[-1])
            rings[-1].run(3)
        states += [(f"seed {seed} initial", rings[-1], start),
                   (f"seed {seed} trained", rings[-1], rings[-1].fed.states)]
    out["grads_vs_f64"] = check_f32_grads("f32 compute", states)
    del sc, rings, states, start
    torch.cuda.empty_cache()
    return out


def adam_arms(dev) -> dict:
    """c. Phase 3's ring with adam (lr 1e-3, the JAX bench's adam rate)
    and adamw (weight decay 1e-4), 3 rounds each: K1-K3 launch, K4 does
    not, the count equals the steps taken; then one cross-device round
    with adam at phase 4's shape, which must launch K5 and not K4."""
    import torch

    from p2pfl_tpu_torch.federation import CrossDeviceScenario
    from p2pfl_tpu_torch.federation.scenario import Scenario
    from p2pfl_tpu_torch.ops import gemm

    out = {}
    for name, wd in (("adam", 0.0), ("adamw", 1e-4)):
        cfg = ring_config(f"femnist-cnn-ring-8-{name}", optimizer=name,
                          learning_rate=1e-3, weight_decay=wd)
        sc = Scenario(cfg, device=dev)
        arm = run_arm(name, sc)
        ln = arm["launches"]
        check_path(name, ln, BF16_GEMMS)
        if ln["sgd_accum"] or ln["sgd_accum_acc"]:
            fail(f"{name} launched K4: {ln}")
        steps = steps_of(sc, 3)
        count = sc.fed.states.opt_state.count
        if not bool((count == steps).all()):
            fail(f"{name}: count {count.tolist()} after {steps} steps")
        if not arm["losses"][-1] < arm["losses"][0]:
            fail(f"{name}: train loss did not fall: {arm['losses']}")
        arm["steps"] = steps
        out[name] = arm
        del sc
        torch.cuda.empty_cache()

    cfg = crossdev_config()
    cfg.training.optimizer = "adam"
    cfg.training.learning_rate = 1e-3
    sc = CrossDeviceScenario(cfg, device=dev)
    gemm.reset_launches()
    res = sc.run(rounds=1)
    torch.cuda.synchronize()
    ln = dict(gemm.launches)
    count = sc.fed.states.opt_state.count
    steps = cfg.cross_device.cohort_size
    print(f"  cross-device adam: {res.round_times_s[0]:.4f} s, loss "
          f"{res.history[0]['Train/loss']:.4f}, count {count.tolist()} "
          f"after {steps} cohort steps; launches "
          f"{ {k: v for k, v in ln.items() if v} }", flush=True)
    check_path("cross-device adam", ln, BF16_GEMMS + ("fedavg_accum",))
    if ln["sgd_accum"] or ln["fedavg_accum"] != steps:
        fail(f"cross-device adam: K4 {ln['sgd_accum']}, K5 "
             f"{ln['fedavg_accum']} for {steps} cohort steps")
    if not bool((count == steps).all()):
        fail(f"cross-device adam: count {count.tolist()}")
    out["crossdev_adam"] = dict(round_s=res.round_times_s[0],
                                loss=res.history[0]["Train/loss"],
                                launches=ln)
    del sc
    torch.cuda.empty_cache()
    return out


# d. the tabular family: (model, dataset, objective)
TABULAR = [("syscall-mlp", "syscall", "classification"),
           ("syscall-autoencoder", "syscall", "autoencoder"),
           ("syscall-svm", "syscall", "ocsvm"),
           ("wadi-mlp", "wadi", "classification")]


def tabular(dev) -> dict:
    """d. The tabular family on the seeded syscall and wadi surrogates:
    8 nodes fully connected, DFL, FedAvg, SGD, the JAX package's
    ``DataConfig``/``TrainingConfig`` defaults (batch 32, lr 0.1,
    momentum 0.9, 3 epochs a round), 5 rounds each. K4 once a step; the
    objective on the test set falls from its value before training and,
    but for the SVM, the mean train loss of round 5 is below round 1's;
    accuracy 0.0 where the objective has none. The SVM starts from w
    drawn from a seeded standard normal (rho 0), not from its zero
    init: the surrogate's rows are centred, so the zero init is the
    objective's minimum (0) and SGD at these rates only adds noise
    around it (on the CPU every rate left the train objective at its
    noise floor after the first round)."""
    import numpy as np
    import torch

    from p2pfl_tpu_torch.config.schema import (
        DataConfig,
        ModelConfig,
        ScenarioConfig,
        TrainingConfig,
    )
    from p2pfl_tpu_torch.federation.scenario import Scenario
    from p2pfl_tpu_torch.parallel.federated import reseed_params

    out = {}
    for model, dataset, objective in TABULAR:
        cfg = ScenarioConfig(
            name=f"{model}-fully-8", federation="DFL", topology="fully",
            n_nodes=N_NODES, data=DataConfig(dataset=dataset, seed=0),
            model=ModelConfig(model=model, objective=objective),
            training=TrainingConfig(rounds=5, eval_every=0), seed=0)
        sc = Scenario(cfg, device=dev)
        if model == "syscall-svm":
            g = torch.Generator().manual_seed(0)
            sc.fed = reseed_params(sc.fed, sc.fns, {"params": {
                "w": torch.randn(17, generator=g),
                "rho": torch.zeros(())}})
        before = float(np.mean(sc.evaluate()["per_node_loss"]))
        arm = run_arm(model, sc)
        after = float(np.mean(sc.evaluate()["per_node_loss"]))
        steps = steps_of(sc, 5)
        ln = arm["launches"]
        print(f"    {objective} on the test set {before:.4f} -> "
              f"{after:.4f}; K4 {ln['sgd_accum']} for {steps} steps",
              flush=True)
        if ln["sgd_accum"] != steps:
            fail(f"{model}: K4 launched {ln['sgd_accum']} times in "
                 f"{steps} steps")
        if not after < before:
            fail(f"{model}: the test objective did not fall")
        if model != "syscall-svm" and not arm["losses"][-1] < arm["losses"][0]:
            fail(f"{model}: train loss did not fall: {arm['losses']}")
        if objective != "classification" and arm["accuracy"] != 0.0:
            fail(f"{model}: accuracy {arm['accuracy']} for {objective}")
        arm.update(steps=steps, test_objective=(before, after))
        out[model] = arm
        del sc
    torch.cuda.empty_cache()
    return out


def fused_epoch_bf16(dev) -> dict:
    """e. 5 epochs of K6 at phase 5's shape with bf16 params, trace and
    inputs: 5 launches of the bf16 variant, the mean loss below 0.8 of
    the first epoch's, the state bf16 and finite."""
    import torch

    from p2pfl_tpu_torch.ops import gemm
    from p2pfl_tpu_torch.ops.fused_train import fused_mlp_train_epoch

    params, mom, bx, by = mlp_epoch_inputs(dev)
    params = tuple(t.to(torch.bfloat16) for t in params)
    mom = tuple(t.to(torch.bfloat16) for t in mom)
    bx = bx.to(torch.bfloat16)
    losses, times = [], []
    gemm.reset_launches()
    for _ in range(5):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, mom, loss = fused_mlp_train_epoch(
            params, mom, bx, by, MLP_LR, 0.9, batch_size=MLP_BATCH)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        losses.append(float(loss.mean()))
    launches = gemm.launches["fused_mlp_train_epoch_bf16"]
    print(f"  bf16 state: epoch wall times (s) "
          f"{[round(t, 5) for t in times]}; mean loss "
          f"{[round(v, 4) for v in losses]}; launches {launches}",
          flush=True)
    if launches != 5 or gemm.launches["fused_mlp_train_epoch"]:
        fail(f"fused epoch bf16: launches {gemm.launches}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite bf16 fused-epoch loss {losses}")
    if not losses[-1] < 0.8 * losses[0]:
        fail(f"bf16 fused-epoch loss did not fall: {losses}")
    if not all(t.dtype == torch.bfloat16 and bool(torch.isfinite(t).all())
               for t in params + mom):
        fail("bf16 fused-epoch state is not bf16 and finite")
    return dict(epoch_s=times, losses=losses, launches=launches)


# ---------------------------------------------------------------------------
# phase 9: the CIFAR10 ResNets and MobileNets
# ---------------------------------------------------------------------------

CIFAR_NODES, CIFAR_SAMPLES, CIFAR_BATCH = 16, 1024, 128  # bench _cifar16
# 9a runs the JAX bench's horizon: it counts the rounds to 80% mean
# accuracy, 32 on its TPU run (BENCH_r05.json), from a fresh federation;
# the warm-up round is the first of the 32. Evaluated every 8 rounds,
# the mean accuracy must leave chance (0.1) by round 32
CIFAR_ROUNDS, CIFAR_EVAL_EVERY, CIFAR_ACC_GATE = 32, 8, 0.5
# 9b: the other models at full width, cut to 4 nodes and 10 rounds, at lr
# 1e-3: at _cifar16's 0.1, and at 0.01, the deeper ResNets' loss rises in
# the JAX package and the port alike (resnet18 on one repeated batch of
# 64, f32: 2.74 -> 9.64 in 6 steps at 0.01; 2.74 -> 2.03 at 1e-3)
CIFAR_OTHERS = ("resnet18", "resnet34", "resnet50", "fastermobilenet",
                "simplemobilenet")
CIFAR_OTHERS_NODES, CIFAR_OTHERS_ROUNDS, CIFAR_OTHERS_LR = 4, 10, 1e-3
# the device time of a profiled round, by kernel name (first match)
PROFILE_BUCKETS = (
    ("K1 stream_gemm (stem)", ("stream_gemm_", "gemm_narrow_f32")),
    ("K2 stream_wgrad (stem)", ("wgrad_narrow", "wgrad_general",
                                "wgrad_wide", "wgrad_reduce",
                                "gemm_f32_kernel", "slice_sum_f32")),
    ("K4 sgd_accum_many", ("stream_kernel",)),
    ("max-pool", ("max_pool",)),
    # cuDNN's grouped convs, with its own channel slices and casts
    ("cuDNN convs (fprop, dgrad, wgrad)", ("cudnn", "xmma")),
    ("copies and casts (layout, pad, bf16/f32)", ("copy", "CatArray",
                                                  "pad")),
    ("reductions (GroupNorm statistics, pooling head)", ("reduce",)),
    ("elementwise (GroupNorm normalize, ReLU, adds; backward)",
     ("elementwise",)),
)


def cifar_config(name: str, *, model: str = "resnet9",
                 n: int = CIFAR_NODES, rounds: int = 3,
                 compute_dtype: str | None = None, lr: float = 0.1,
                 seed: int = 3, eval_every: int = 0):
    """``bench.py``'s ``_cifar16`` (``BASELINE.json`` configs[2]):
    CIFAR10 on the easy surrogate, sized so that every node gets its
    1024 samples, Dirichlet(0.5) shards, the random topology (seed 3),
    DFL FedAvg, bf16 wire, batch 128, lr 0.1, SGD momentum 0.9, 1 epoch
    a round; evaluation every ``eval_every`` rounds and after the
    last."""
    from p2pfl_tpu_torch.config.schema import (
        DataConfig,
        ModelConfig,
        ScenarioConfig,
        TrainingConfig,
    )

    return ScenarioConfig(
        name=name, federation="DFL", topology="random",
        topology_kwargs={"seed": seed}, n_nodes=n,
        data=DataConfig(dataset="cifar10", partition="dirichlet",
                        dirichlet_alpha=0.5, samples_per_node=CIFAR_SAMPLES,
                        batch_size=CIFAR_BATCH, seed=seed,
                        synthetic_train=int(n * CIFAR_SAMPLES / 0.9) + n,
                        surrogate_profile="easy"),
        model=ModelConfig(model=model, compute_dtype=compute_dtype),
        training=TrainingConfig(rounds=rounds, epochs_per_round=1,
                                learning_rate=lr, eval_every=eval_every),
        transport="dense", wire_dtype="bf16", seed=seed)


class GemmShapes:
    """Inside the block, record the ``(K, N, dtype)`` of every K1 and K2
    call (their wrappers wrapped by name; the launch counts are the
    wrappers' own). With ``keep``, also a copy of each wrapper's first
    operands and output (``kept[name] = (x, w_or_g, out)``)."""

    NAMES = ("stream_gemm", "stream_wgrad")

    def __init__(self, keep: bool = False):
        self.keep, self.kept = keep, {}

    def __enter__(self):
        from p2pfl_tpu_torch.ops import gemm

        self.gemm, self.seen = gemm, {k: set() for k in self.NAMES}
        self.saved = {k: getattr(gemm, k) for k in self.NAMES}

        def wrap(name, fn):
            def call(x, w):
                self.seen[name].add((x.shape[-1], w.shape[-1],
                                     str(x.dtype)[6:]))
                out = fn(x, w)
                if self.keep and name not in self.kept:
                    self.kept[name] = (x.clone(), w.clone(), out.clone())
                return out
            return call

        for k, fn in self.saved.items():
            setattr(gemm, k, wrap(k, fn))
        return self

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(self.gemm, k, fn)


def cifar_arm(tag: str, sc, rounds: int, out: dict) -> dict:
    """``run_arm`` with the K1 and K2 shapes recorded; K4 must launch
    ``ceil(leaves / 48)`` times a step. Returns the arm, with the
    failures of its gates (``failed``) for the caller to raise."""
    from p2pfl_tpu_torch.core.pytree import tree_leaves

    with GemmShapes() as shapes:
        arm = run_arm(tag, sc, rounds)
    arm["gemm_shapes"] = {k: sorted(v) for k, v in shapes.seen.items()}
    leaves = len(tree_leaves(sc.fed.states.params))
    steps = steps_of(sc, rounds)
    per_step = -(-leaves // K4_LEAVES_A_LAUNCH)
    arm.update(leaves=leaves, steps=steps, k4_per_step=per_step, failed=[])
    k4 = arm["launches"]["sgd_accum"]
    print(f"    {leaves} leaves, {steps} steps: K4 {k4} launches (want "
          f"{per_step} a step); K1/K2 (K, N, dtype) {arm['gemm_shapes']}",
          flush=True)
    if k4 != per_step * steps:
        arm["failed"].append(f"{tag}: K4 launched {k4} times in {steps} "
                             f"steps of {leaves} leaves")
    if not arm["losses"][-1] < arm["losses"][0]:
        arm["failed"].append(f"{tag}: train loss did not fall from the "
                             f"first round to the last: {arm['losses']}")
    out[tag] = arm
    return arm


def profile_buckets(ops, total: float) -> dict:
    """A profiled round's kernel time by ``PROFILE_BUCKETS``, with each
    bucket's share of ``total`` (the kernel time summed)."""
    got = {name: 0.0 for name, _ in PROFILE_BUCKETS}
    got["other"] = 0.0
    for key, ms, _ in ops:
        name = next((b for b, keys in PROFILE_BUCKETS
                     if any(k in key for k in keys)), "other")
        got[name] += ms
    for name, ms in got.items():
        print(f"    {ms:9.3f} ms ({100 * ms / total:5.1f}%)  {name}",
              flush=True)
    return got


def stem_gate(tag: str, got, a, b) -> dict:
    """Phase 9c's gate at the ResNet9 stem: ``got`` (the f32 K1 output or
    K2 weight gradient from the round's own step) against the f64 product
    ``a @ b`` within ``F32_TOL``; the product on TF32-rounded operands,
    the control, must exceed it. Fails the run otherwise."""
    import torch

    exact = torch.matmul(a.double(), b.double())
    mine = f32_reading(got, exact, a, b)
    tf32 = torch.matmul(tf32_round(a), tf32_round(b))
    control = f32_reading(tf32, exact, a, b)
    del exact, tf32

    def passes(r):
        return r[0] <= F32_REL_C and r[1] <= F32_ELEM_C

    print(f"    {tag} {tuple(a.shape)} @ {tuple(b.shape)} against f64: rel "
          f"L2 {mine[0]:.4g} u sqrt(L), largest element {mine[1]:.4g} "
          f"(limits {F32_REL_C:g} / {F32_ELEM_C:g}); TF32 control "
          f"{control[0]:.4g} / {control[1]:.4g}", flush=True)
    if not passes(mine):
        fail(f"{tag}: outside {F32_TOL} of the f64 product: {mine}")
    if passes(control):
        fail(f"{tag}: the TF32 control passes {F32_TOL}: {control}")
    return dict(kernel_units=mine, tf32_control_units=control)


def cifar_models(dev, out_dir: pathlib.Path | None) -> dict:
    """Phase 9: a. ``_cifar16``'s ResNet9 at full width (16 nodes, 1024
    samples a node, batch 128) for the bench's 32 rounds: a warm-up
    round, then 31, evaluated every 8; the loss falls from the first
    measured round to the last, the mean accuracy passes
    ``CIFAR_ACC_GATE`` by round 32; the stem on K1 and K2 at K = 27,
    N = 64 (K1 also in the evaluations), K4 once a step; the step
    against the plain versions and twice bit for bit; what cuDNN's
    deterministic algorithms cost (2 rounds each way, the second read);
    one profiled round by kernel bucket. b. resnet18, resnet34,
    resnet50, fastermobilenet and simplemobilenet at full width, cut to
    4 nodes and 10 rounds at lr 1e-3: finite loss falling from the
    first round to the last, K4 ``ceil(leaves / 48)`` launches a step,
    no K1 or K2 (their stems are plain convs), the step against the
    plain versions and twice bit for bit. c. a's ResNet9 in f32 compute, one round,
    with cuDNN TF32 on and the deterministic flag off before
    ``Scenario`` resolves the card: the flags come back off and on, only
    the f32 K1 and K2 launch, the loss is finite, and the stem's K1 and
    K2 on the first step's operands pass ``stem_gate``. The accuracy and loss
    gates of a and b are raised at the end, after every arm has run."""
    import torch

    from p2pfl_tpu_torch.federation.scenario import Scenario

    out: dict = {}
    t0 = time.perf_counter()
    sc = Scenario(cifar_config("cifar10-resnet9-16",
                               eval_every=CIFAR_EVAL_EVERY), device=dev)
    print(f"  a. setup {time.perf_counter() - t0:.1f} s (data for "
          f"{CIFAR_NODES} x {CIFAR_SAMPLES} samples, init)", flush=True)
    t0 = time.perf_counter()
    sc.run(1)
    torch.cuda.synchronize()
    print(f"  warm-up round and evaluation {time.perf_counter() - t0:.2f} s",
          flush=True)
    arm = cifar_arm("resnet9", sc, CIFAR_ROUNDS - 1, out)
    failed = list(arm["failed"])
    ln = arm["launches"]
    evals = len(arm["evals"]) * -(-int(sc._x_test.shape[0]) // 512)
    stem = [(27, 64, "bfloat16")]
    if (arm["gemm_shapes"]["stream_gemm"] != stem
            or arm["gemm_shapes"]["stream_wgrad"] != stem):
        fail(f"resnet9: K1/K2 ran at {arm['gemm_shapes']}, not the stem")
    if ln["stream_gemm"] != arm["steps"] + evals or (
            ln["stream_wgrad"] != arm["steps"]) or arm["k4_per_step"] != 1:
        fail(f"resnet9: launches {ln} for {arm['steps']} steps and {evals} "
             "evaluation batches")
    if any(ln[k] for k in ("dense_bwd",) + F32_PATH):
        fail(f"resnet9: other kernels launched: {ln}")
    times = arm["round_s"]
    print(f"  s/round: median {sorted(times)[len(times) // 2]:.4f}, first 3 "
          f"{[round(t, 4) for t in times[:3]]} (NVIDIA card, host clock "
          f"ending in torch.cuda.synchronize(), evaluation excluded); per "
          f"step K1 1 (+{evals} in the evaluations), K2 1, K4 1; mean "
          f"accuracy by round {[(r, round(a, 4)) for r, a in arm['evals']]}",
          flush=True)
    if not arm["accuracy"] > CIFAR_ACC_GATE:
        failed.append(f"resnet9: mean accuracy {arm['accuracy']:.4f} at "
                      f"round {CIFAR_ROUNDS}, not above {CIFAR_ACC_GATE}")
    arm["step_vs_plain"] = check_step_vs_plain("resnet9", sc, False,
                                               twice=True)
    det = {}
    for flag in (False, True):
        torch.backends.cudnn.deterministic = flag
        det[str(flag)] = sc.run(2).round_times_s[1]
    torch.backends.cudnn.deterministic = True
    arm["round_s_by_cudnn_deterministic"] = det
    print(f"  cuDNN deterministic off / on: {det['False']:.4f} / "
          f"{det['True']:.4f} s a round", flush=True)
    prof = profile_round(
        lambda: sc._round_fn(sc.fed, *sc._data_args, *sc._plan_args(None)),
        out_dir, name="chip_smoke_cifar16_profile",
        what="ResNet9 training round (no evaluation)")
    arm["profile"] = dict(
        wall_ms=prof["wall_ms"], busy_ms=prof["busy_ms"],
        kernel_ms=prof["kernel_ms"],
        buckets=profile_buckets(prof["ops"], prof["kernel_ms"]))
    del sc
    torch.cuda.empty_cache()

    print(f"  b. the other models, {CIFAR_OTHERS_NODES} nodes, "
          f"{CIFAR_OTHERS_ROUNDS} rounds", flush=True)
    for model in CIFAR_OTHERS:
        sc = Scenario(cifar_config(f"cifar10-{model}-{CIFAR_OTHERS_NODES}",
                                   model=model, n=CIFAR_OTHERS_NODES,
                                   rounds=CIFAR_OTHERS_ROUNDS,
                                   lr=CIFAR_OTHERS_LR), device=dev)
        other = cifar_arm(model, sc, CIFAR_OTHERS_ROUNDS, out)
        failed += other["failed"]
        if any(other["launches"][k] for k in ("stream_gemm", "stream_wgrad",
                                              "dense_bwd") + F32_PATH):
            failed.append(f"{model}: a GEMM kernel launched: "
                          f"{other['launches']}")
        other["step_vs_plain"] = check_step_vs_plain(model, sc, False,
                                                     twice=True)
        del sc
        torch.cuda.empty_cache()

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    sc = Scenario(cifar_config("cifar10-resnet9-16-f32", rounds=1,
                               compute_dtype="float32"), device=dev)
    flags = dict(cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                 cudnn_deterministic=torch.backends.cudnn.deterministic,
                 matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    print(f"  c. f32 compute: after Scenario(...) {flags}", flush=True)
    if flags != dict(cudnn_allow_tf32=False, cudnn_deterministic=True,
                     matmul_allow_tf32=False):
        fail(f"f32 ResNet9: Scenario left the flags {flags}")
    with GemmShapes(keep=True) as shapes:
        f32 = run_arm("resnet9 f32", sc, 1)
    f32.update(flags=flags, gemm_shapes={k: sorted(v)
                                         for k, v in shapes.seen.items()})
    # the stem's K1 (patches @ w) and K2 (patches^T @ upstream gradient)
    # on the operands of the round's first step, against f64
    x, w, y = shapes.kept["stream_gemm"]
    f32["stem_k1_vs_f64"] = stem_gate("K1 f32 stem (9c)", y, x, w)
    x, g, dw = shapes.kept["stream_wgrad"]
    f32["stem_k2_vs_f64"] = stem_gate("K2 f32 stem (9c)", dw,
                                      x.transpose(1, 2), g)
    del shapes, x, w, y, g, dw
    ln = f32["launches"]
    stem = [(27, 64, "float32")]
    if (f32["gemm_shapes"]["stream_gemm"] != stem
            or f32["gemm_shapes"]["stream_wgrad"] != stem
            or not (ln["stream_gemm_f32"] and ln["stream_wgrad_f32"])
            or any(ln[k] for k in BF16_GEMMS)):
        fail(f"f32 ResNet9: K1/K2 {f32['gemm_shapes']}, launches {ln}")
    out["resnet9_f32"] = f32
    del sc
    torch.cuda.empty_cache()
    if failed:
        fail("; ".join(failed))
    return out


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 10: the round-boundary services (checkpoint and resume, logs and
# status records, the profiled round, the staged exchange)
# ---------------------------------------------------------------------------

# 10b: K1-K4 by the symbols of their kernels in a Chrome trace
TRACE_KERNELS = {"K1 stream_gemm": "stream_gemm_",
                 "K2 stream_wgrad": "wgrad_",
                 "K3 dense_bwd": "dense_bwd_kernel",
                 "K4 sgd_accum_many": "stream_kernel"}
# 10b: metrics.jsonl rows a round at eval_every 1: a train row and a test
# row a node, the federation's test row, the resources row, the marker
LOG_ROWS_PER_ROUND = 2 * N_NODES + 3


def phase10_dir() -> pathlib.Path:
    """A fresh scratch directory inside the checkout (git-ignored)."""
    import shutil

    d = ROOT / ".chip_smoke_phase10"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir()
    return d


def same_state(a, b) -> list[str]:
    """The parts of two federation states whose bits differ."""
    import torch

    from p2pfl_tpu_torch.core.pytree import tree_leaves

    off = []
    for tag, x, y in (("params", a.states.params, b.states.params),
                      ("trace", a.states.opt_state, b.states.opt_state)):
        if not all(torch.equal(u, v) for u, v in zip(tree_leaves(x),
                                                      tree_leaves(y))):
            off.append(tag)
    for tag, x, y in (("step", a.states.step, b.states.step),
                      ("alive", a.alive, b.alive)):
        if not torch.equal(x, y):
            off.append(tag)
    if a.round != b.round:
        off.append("round")
    return off


def resume_arm(dev, data, federation: str, work: pathlib.Path) -> dict:
    """10a, one arm: phase 3's ring as ``federation`` with node 3
    crashing at round 1 and joining at round 3 (4 s heartbeat, 3 s
    timeout), 4 rounds uninterrupted with ``checkpoint_every=2``; then a
    fresh ``Scenario`` on a directory holding only round 2's file
    resumes and runs 2 rounds. Every param, trace, step, alive, round,
    the leader, the evaluation and round 4's file must equal the
    uninterrupted run's."""
    import dataclasses
    import hashlib
    import shutil

    import torch

    from p2pfl_tpu_torch.config.schema import FaultEvent, ProtocolConfig
    from p2pfl_tpu_torch.federation import Scenario
    from p2pfl_tpu_torch.federation.checkpoint import (
        checkpoint_path,
        load_checkpoint,
        save_checkpoint,
    )

    base = smoke_config()
    first, again = work / f"{federation}_run", work / f"{federation}_resume"
    again.mkdir()

    def config(directory):
        return dataclasses.replace(
            base, name=f"femnist-cnn-ring-8-{federation.lower()}-resume",
            federation=federation,
            training=dataclasses.replace(base.training, rounds=4),
            protocol=ProtocolConfig(**FAST_CLOCK),
            faults=[FaultEvent(node=3, round=1, kind="crash"),
                    FaultEvent(node=3, round=3, kind="join")],
            checkpoint_dir=str(directory), checkpoint_every=2)

    whole = Scenario(config(first), dataset=data, device=dev)
    res_whole = whole.run()
    shutil.copy(checkpoint_path(first, 2), again)
    resumed = Scenario(config(again), dataset=data, device=dev)
    start = resumed.fed.round
    res_resumed = resumed.run(rounds=2)
    torch.cuda.synchronize(dev)
    off = same_state(whole.fed, resumed.fed)
    digest = [hashlib.sha256(checkpoint_path(d, 4).read_bytes()).hexdigest()
              for d in (first, again)]
    files_mb = {f"{d.name}/{p.name}": p.stat().st_size / 1e6
                for d in (first, again) for p in sorted(d.iterdir())}
    hist = {k: ([h[k] for h in res_whole.history[2:]],
                [h[k] for h in res_resumed.history])
            for k in ("alive", "leader", "train_loss")}
    same_eval = (res_whole.per_node_accuracy == res_resumed.per_node_accuracy
                 and res_whole.final_accuracy == res_resumed.final_accuracy)
    # the file's cost: the final state saved and loaded once more (its
    # generator drew nothing since round 4's save: the same slot)
    timed = work / f"{federation}_timed"
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    path = save_checkpoint(timed, whole.fed)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_checkpoint(path, whole.fed)
    torch.cuda.synchronize(dev)
    load_s = time.perf_counter() - t0
    mb = path.stat().st_size / 1e6
    out = dict(start_round=start, state_off=off, files_mb=files_mb,
               same_leader_alive_loss={k: a == b for k, (a, b) in hist.items()},
               same_eval=same_eval, same_round4_file=digest[0] == digest[1],
               leaders=hist["leader"][0], file_mb=mb, save_s=save_s,
               load_s=load_s,
               round_times_s=[h["round_time_s"] for h in res_whole.history])
    print(f"  resume {federation}: resumed at round {start}; state off the "
          f"uninterrupted run's bits: {off or 'none'}; alive, leader, "
          f"train loss equal: {out['same_leader_alive_loss']} (leaders "
          f"{hist['leader'][0]}); evaluation equal: {same_eval}; round 4's "
          f"file the same bytes: {out['same_round4_file']}; files (MB) "
          f"{ {k: round(v, 1) for k, v in files_mb.items()} }; the final "
          f"state saved once more: {mb:.1f} MB, save {save_s:.3f} s, load "
          f"{load_s:.3f} s", flush=True)
    if start != 2:
        fail(f"resume {federation}: resumed at round {start}, not 2")
    if off or not all(out["same_leader_alive_loss"].values()) or not (
            same_eval and out["same_round4_file"]):
        fail(f"resume {federation}: the resumed run left the uninterrupted "
             f"run's bits: {out}")
    shutil.rmtree(work / f"{federation}_timed")
    for d in (first, again):
        shutil.rmtree(d)
    return out


def logs_arm(dev, data, work: pathlib.Path) -> dict:
    """10b: phase 3's ring with ``log_dir`` and ``profile_dir``, 3
    rounds: metrics.jsonl's rows a round, a status record an alive node
    with keys inside ``STATUS_KEYS``, the profiled round's Chrome trace
    naming K1-K4, its wall time beside an unprofiled round's."""
    import dataclasses

    from p2pfl_tpu_torch.federation import Scenario
    from p2pfl_tpu_torch.utils.monitor import STATUS_KEYS, read_statuses

    cfg = dataclasses.replace(smoke_config(), name="femnist-cnn-ring-8-logs",
                              log_dir=str(work / "logs"),
                              profile_dir=str(work / "profile"))
    sc = Scenario(cfg, dataset=data, device=dev)
    res = sc.run()
    sc.close()
    rows = [json.loads(line) for line in
            (work / "logs" / cfg.name / "metrics.jsonl").read_text()
            .splitlines()]
    per_round = [sum(r["round"] == i for r in rows) for i in range(3)]
    statuses = read_statuses(work / "logs" / cfg.name / "status")
    extra = sorted({k for st in statuses for k in st} - set(STATUS_KEYS))
    trace = json.loads(sc.profile_path.read_text())
    names = [e.get("name", "") for e in trace.get("traceEvents", [])
             if e.get("cat") == "kernel"]
    seen = {k: sum(sym in n for n in names)
            for k, sym in TRACE_KERNELS.items()}
    times = res.round_times_s
    out = dict(rows_per_round=per_round, statuses=len(statuses),
               extra_keys=extra, trace_kernels=seen,
               trace_mb=sc.profile_path.stat().st_size / 1e6,
               profiled_round_s=times[1], unprofiled_round_s=times[2],
               round_times_s=times)
    print(f"  logs: metrics.jsonl rows a round {per_round} (want "
          f"{LOG_ROWS_PER_ROUND}); status records {len(statuses)}, keys "
          f"outside STATUS_KEYS {extra or 'none'}; the profiled round's "
          f"trace ({out['trace_mb']:.1f} MB) names {seen}; round 2 "
          f"profiled {times[1]:.4f} s, round 3 unprofiled {times[2]:.4f} s",
          flush=True)
    if per_round != [LOG_ROWS_PER_ROUND] * 3:
        fail(f"logs: metrics.jsonl rows a round {per_round}")
    if len(statuses) != N_NODES or extra:
        fail(f"logs: {len(statuses)} status records, extra keys {extra}")
    if not all(seen.values()):
        fail(f"logs: the profiled round's trace misses kernels: {seen}")
    return out


def staged_arm(dev, data, ring_launches: dict) -> dict:
    """10c: phase 3's ring with ``exchange_overlap="staged"``, 3 rounds
    beside the eager ring: round 0's params the bits of the fit before
    the mix rounded through the bf16 wire, the loss falling, K1-K4
    launched as often as in phase 3, s/round of both."""
    import dataclasses

    import numpy as np
    import torch

    from p2pfl_tpu_torch.core.pytree import tree_leaves, tree_map
    from p2pfl_tpu_torch.federation import Scenario
    from p2pfl_tpu_torch.ops import gemm
    from p2pfl_tpu_torch.parallel.federated import (
        _clone_generator,
        _train_and_select,
    )

    base = smoke_config()
    cfg = dataclasses.replace(base, name="femnist-cnn-ring-8-staged",
                              exchange_overlap="staged")
    sc = Scenario(cfg, dataset=data, device=dev)
    # the fit alone, from the same state and a copy of the generator
    st = dataclasses.replace(sc.fed.states,
                             rng=_clone_generator(sc.fed.states.rng))
    x, y, smask, _ = sc._data_args
    every = torch.ones(N_NODES, dtype=torch.bool, device=dev)
    fit, _ = _train_and_select(sc.fns, st, every, every, x, y, smask,
                               cfg.training.epochs_per_round)
    want = tree_map(lambda p: p.to(torch.bfloat16).to(p.dtype), fit.params)
    del fit, st
    gemm.reset_launches()
    hist = sc.run(rounds=1).history
    round0 = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(sc.fed.states.params), tree_leaves(want)))
    hist += sc.run(rounds=2).history
    torch.cuda.synchronize(dev)
    launches = dict(gemm.launches)
    eager = Scenario(base, dataset=data, device=dev).run().history
    loss = [float(np.mean(h["train_loss"])) for h in hist]
    staged_s = float(np.median([h["round_time_s"] for h in hist[1:]]))
    eager_s = float(np.median([h["round_time_s"] for h in eager[1:]]))
    same = {k: launches[k] == ring_launches[k] for k in DENSE_PATH}
    out = dict(round0_is_bf16_fit=round0, loss=loss, launches=launches,
               launches_as_phase3=same, staged_s=staged_s, eager_s=eager_s,
               stale_weights=sc.fed.stale[1].tolist())
    print(f"  staged exchange: round 0 the bf16-rounded fit bit for bit: "
          f"{round0}; mean train loss {[round(v, 4) for v in loss]}; K1-K4 "
          f"launches as phase 3's: {same} ({launches}); s/round (median of "
          f"rounds 2-3) staged {staged_s:.4f}, eager {eager_s:.4f}",
          flush=True)
    if not round0:
        fail("staged exchange: round 0 is not the fit rounded through bf16")
    if not loss[-1] < loss[0]:
        fail(f"staged exchange: train loss did not fall: {loss}")
    if not all(same.values()):
        fail(f"staged exchange: launches {launches}, phase 3 "
             f"{ring_launches}")
    return out


def round_services(dev, ring_launches: dict) -> dict:
    """Phase 10 on phase 3's data; the scratch directory goes at the
    end."""
    import shutil

    from p2pfl_tpu_torch.datasets.data import FederatedDataset

    data = FederatedDataset.make(smoke_config().data, N_NODES)
    work = phase10_dir()
    try:
        out = {f"resume_{f.lower()}": resume_arm(dev, data, f, work)
               for f in ("DFL", "SDFL")}
        out["logs"] = logs_arm(dev, data, work)
        out["staged"] = staged_arm(dev, data, ring_launches)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 11: ViT-Tiny and adapter-only federation (LoRA)
# ---------------------------------------------------------------------------

# a. bench.py's _vit32_inprocess (BASELINE.json configs[4]): 32 nodes
# fully connected, Krum(f=1, m=3) (one shared aggregate), iid shards of
# the easy CIFAR10 surrogate, 512 samples a node, batch 115, adam at
# 1e-3, seed 4, ViT-Tiny with remat and scan_layers; 20 rounds,
# evaluated at rounds 10 and 20, the mean accuracy above VIT_ACC_GATE
# (chance is 0.1) by round 20
VIT_NODES, VIT_SAMPLES, VIT_BATCH, VIT_SEED = 32, 512, 115, 4
VIT_ROUNDS, VIT_EVAL_EVERY, VIT_ACC_GATE = 20, 10, 0.2
# b. a's configuration with SGD momentum 0.9 at VIT_SGD_LR, chosen on the
# CPU by scripts/torch_vit_lr_probe.py (full width and depth, 2 nodes x
# 128 samples, batch 32, 3 rounds): the mean train loss 2.567 -> 2.274
# -> 2.102 at 0.01; at 0.03 it rises in round 2, at 0.1 it diverges
VIT_SGD_LR, VIT_SGD_ROUNDS = 0.01, 3
# c. bench.py's _phase_lora shape: 16 nodes, 256 samples, batch 64, a
# full-weight arm and a rank-8 q/v adapter arm from one base, 5 rounds
# each, SGD momentum 0.9 (so that K4 steps the adapter leaves) at one
# LORA_LR for both, b's rate (the probe's rank-8 arm falls at 0.01,
# 0.03 and 0.1: 2.398 -> 2.366 -> 2.336 at 0.01)
LORA_NODES, LORA_SAMPLES, LORA_BATCH, LORA_RANK = 16, 256, 64, 8
LORA_ROUNDS, LORA_LR = 5, 0.01
# the record_function scopes of models/vit.py a profiled round is split by
VIT_SCOPES = ("vit.linear", "vit.attention", "vit.layer_norm", "vit.gelu")


def vit_config(name: str, *, n: int = VIT_NODES,
               samples: int = VIT_SAMPLES, batch: int = VIT_BATCH,
               rounds: int = VIT_ROUNDS, optimizer: str = "adam",
               lr: float = 1e-3, model_kw: dict | None = None,
               lora_rank: int = 0, eval_every: int = 0):
    """``bench.py``'s ``_build`` as ``_vit32_inprocess`` calls it (see
    above), with the surrogate sized so that every node gets its
    samples, bf16 wire, 1 epoch a round; ``model_kw`` defaults to
    ``VIT_KW``."""
    from p2pfl_tpu_torch.config.schema import (
        DataConfig,
        LoraConfig,
        ModelConfig,
        ScenarioConfig,
        TrainingConfig,
    )

    return ScenarioConfig(
        name=name, federation="DFL", topology="fully", n_nodes=n,
        aggregator="krum", aggregator_kwargs={"f": 1, "m": 3},
        data=DataConfig(dataset="cifar10", partition="iid",
                        samples_per_node=samples, batch_size=batch,
                        seed=VIT_SEED, synthetic_train=int(n * samples / 0.9)
                        + n, surrogate_profile="easy"),
        model=ModelConfig(model="vit-tiny",
                          kwargs=dict(VIT_KW if model_kw is None
                                      else model_kw)),
        training=TrainingConfig(rounds=rounds, epochs_per_round=1,
                                learning_rate=lr, optimizer=optimizer,
                                momentum=0.9, eval_every=eval_every),
        lora=LoraConfig(rank=lora_rank), transport="dense",
        wire_dtype="bf16", seed=VIT_SEED)


def median_after_warmup(times: list) -> float:
    rest = sorted(times[1:]) or list(times)
    return rest[len(rest) // 2]


def same_tensors(a: list, b: list) -> bool:
    import torch

    return len(a) == len(b) and all(
        u.dtype == v.dtype and torch.equal(u, v) for u, v in zip(a, b))


def vit_step_checks(sc) -> dict:
    """b's one-step gates from the SGD arm's initial state on its first
    batch: the step through K4 twice, bit for bit, and K4's result the
    bits of the step with ``sgd_accum_many_plain`` (params and traces);
    then the loss and every gradient leaf of the model with remat and
    without (the same weights, renamed) bit for bit, with each one's
    peak memory."""
    import torch

    from p2pfl_tpu_torch.core.pytree import tree_leaves, tree_unflatten
    from p2pfl_tpu_torch.learning.objectives import cross_entropy_loss
    from p2pfl_tpu_torch.models.base import get_model

    st = sc.fed.states
    x, y, mask, _ = sc._data_args
    b = sc.config.data.batch_size
    bx, by, bm = x[:, :b], y[:, :b], mask[:, :b]
    k1, loss1 = sc.fns.train_step(st, bx, by, bm)
    k2, loss2 = sc.fns.train_step(st, bx, by, bm)

    def state(s):
        return tree_leaves(s.params) + tree_leaves(s.opt_state)

    again = torch.equal(loss1, loss2) and same_tensors(state(k1), state(k2))
    del k2
    with PlainVersions():
        p, _ = sc.fns.train_step(st, bx, by, bm)
    plain = same_tensors(state(k1), state(p))
    del k1, p

    def renamed(tree):
        if isinstance(tree, dict):
            return {k.replace("CheckpointTransformerBlock",
                              "TransformerBlock"): renamed(v)
                    for k, v in tree.items()}
        return tree

    def loss_grads(model, params):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.enable_grad():
            loss = cross_entropy_loss(model(tree_unflatten(params, leaves),
                                            bx), by, bm)
            grads = torch.autograd.grad(loss.sum(), leaves)
        torch.cuda.synchronize()
        return (loss.detach(), list(grads),
                torch.cuda.max_memory_allocated() / 2 ** 30)

    plain_model = get_model("vit-tiny", **dict(sc.config.model.kwargs,
                                               remat=False))
    loss_r, g_r, peak_r = loss_grads(sc.model, st.params)
    loss_p, g_p, peak_p = loss_grads(plain_model, renamed(st.params))
    remat = torch.equal(loss_r, loss_p) and same_tensors(g_r, g_p)
    del g_r, g_p
    print(f"  one step: two K4 steps bit for bit {again}; K4 the bits of "
          f"sgd_accum_many_plain {plain}; remat on / off: loss and every "
          f"gradient bit for bit {remat}, peak {peak_r:.2f} / {peak_p:.2f} "
          "GiB", flush=True)
    return dict(repeat_bits=again, plain_bits=plain, remat_bits=remat,
                remat_peak_gib=peak_r, no_remat_peak_gib=peak_p)


def scope_of(e):
    """The ``VIT_SCOPES`` scope a profiler event lies in, or None."""
    while e is not None:
        if e.name in VIT_SCOPES:
            return e.name
        e = e.cpu_parent
    return None


def vit_buckets(prof, kernel_ms: float) -> dict:
    """A profiled round's kernel time by the ViT's ``record_function``
    scopes: a kernel counts in the scope its launching op lies in, or,
    launched in the backward, in the scope of the forward op its
    autograd node came from (the node's sequence number); K4 by its
    kernel's name; the rest (Krum, the mix, casts of the input) is
    "other"."""
    from torch.autograd import DeviceType

    events = prof.events()
    forward = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.sequence_nr >= 0:
            s = scope_of(e)
            if s is not None:
                forward.setdefault(e.sequence_nr, s)
    got = {s: 0.0 for s in VIT_SCOPES}
    got["K4 sgd_accum_many"] = sum(
        e.self_device_time_total for e in events
        if e.device_type == DeviceType.CUDA and "stream_kernel" in e.name
    ) / 1e3
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        s = scope_of(e)
        if s is None:
            a = e
            while a is not None and not a.fwd_thread:
                a = a.cpu_parent
            s = None if a is None else forward.get(a.sequence_nr)
        if s is not None:
            got[s] += sum(k.duration for k in e.kernels) / 1e3
    got["other"] = kernel_ms - sum(got.values())
    for name, ms in got.items():
        share = 100 * ms / kernel_ms if kernel_ms else 0.0
        print(f"    {ms:9.3f} ms ({share:5.1f}%)  {name}", flush=True)
    return got


def vit_profile(sc, out_dir) -> dict:
    """One SGD training round of ``sc`` (no evaluation) under the
    profiler: ``profile_round``'s wall, busy and kernel time, and the
    kernel time by ``vit_buckets``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def run():
        sc.fed, _ = sc._round_fn(sc.fed, *sc._data_args,
                                 *sc._plan_args(None))

    res = profile_round(run, out_dir, name="chip_smoke_vit_profile",
                        what="ViT-Tiny SGD training round (no evaluation)")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.events()
                if e.device_type.name == "CUDA"
                and e.name not in VIT_SCOPES) / 1e3
    print(f"  the same round again, kernel time {total:.1f} ms by the "
          "model's scopes:", flush=True)
    return dict(wall_ms=res["wall_ms"], busy_ms=res["busy_ms"],
                kernel_ms=res["kernel_ms"], scopes=vit_buckets(prof, total))


def tree_bytes(tree) -> int:
    from p2pfl_tpu_torch.core.pytree import tree_leaves

    return sum(t[0].numel() * t.element_size() for t in tree_leaves(tree))


def vit_and_lora(dev, out_dir) -> dict:
    """Phase 11: a. ``_vit32_inprocess`` with adam (no kernel); b. its
    SGD arm through K4 (one step's gates, 3 rounds, one unscanned round,
    a profiled round); c. ``_phase_lora``'s shape, the full-weight arm
    and the rank-8 adapter arm from one base. The loss, accuracy and
    launch gates are raised at the end, after every arm has run."""
    import torch

    from p2pfl_tpu_torch.core.pytree import tree_leaves
    from p2pfl_tpu_torch.federation.scenario import Scenario

    out: dict = {}
    failed: list[str] = []
    t0 = time.perf_counter()
    sc = Scenario(vit_config("cifar10-vit-tiny-32-adam",
                             eval_every=VIT_EVAL_EVERY), device=dev)
    print(f"  a. setup {time.perf_counter() - t0:.1f} s ({VIT_NODES} x "
          f"{VIT_SAMPLES} samples, {len(tree_leaves(sc.fed.states.params))}"
          " leaves)", flush=True)
    arm = run_arm("vit-tiny adam", sc, VIT_ROUNDS)
    arm["median_round_s"] = median_after_warmup(arm["round_s"])
    print(f"  s/round: median {arm['median_round_s']:.4f} after the warm-up "
          f"({arm['round_s'][0]:.3f}); mean accuracy by round "
          f"{[(r, round(a, 4)) for r, a in arm['evals']]}", flush=True)
    if any(arm["launches"].values()):
        failed.append(f"vit adam launched kernels: {arm['launches']}")
    if not arm["losses"][-1] < arm["losses"][0]:
        failed.append(f"vit adam: loss did not fall: {arm['losses']}")
    if not arm["accuracy"] > VIT_ACC_GATE:
        failed.append(f"vit adam: accuracy {arm['accuracy']:.4f} at round "
                      f"{VIT_ROUNDS}, not above {VIT_ACC_GATE}")
    out["adam"] = arm
    del sc
    torch.cuda.empty_cache()

    print(f"  b. SGD at lr {VIT_SGD_LR}, {VIT_SGD_ROUNDS} rounds", flush=True)
    sc = Scenario(vit_config("cifar10-vit-tiny-32-sgd", optimizer="sgd",
                             lr=VIT_SGD_LR, rounds=VIT_SGD_ROUNDS),
                  device=dev)
    checks = vit_step_checks(sc)
    if not all(checks[k] for k in ("repeat_bits", "plain_bits",
                                   "remat_bits")):
        failed.append(f"vit sgd one-step gates: {checks}")
    torch.cuda.empty_cache()
    sgd = run_arm("vit-tiny sgd", sc, VIT_SGD_ROUNDS)
    sgd.update(checks, median_round_s=median_after_warmup(sgd["round_s"]))
    steps = steps_of(sc, VIT_SGD_ROUNDS)
    ln = sgd["launches"]
    if ln["sgd_accum"] != steps or any(
            v for k, v in ln.items() if k != "sgd_accum"):
        failed.append(f"vit sgd: {ln} for {steps} steps (K4 once a step, "
                      "no other kernel)")
    if not sgd["losses"][-1] < sgd["losses"][0]:
        failed.append(f"vit sgd: loss did not fall: {sgd['losses']}")
    sgd["profile"] = vit_profile(sc, out_dir)
    out["sgd"] = sgd
    del sc
    torch.cuda.empty_cache()
    sc = Scenario(vit_config("cifar10-vit-tiny-32-sgd-unscanned",
                             optimizer="sgd", lr=VIT_SGD_LR, rounds=1,
                             model_kw=dict(VIT_KW, scan_layers=False)),
                  device=dev)
    leaves = len(tree_leaves(sc.fed.states.params))
    flat = run_arm("vit-tiny sgd unscanned", sc, 1)
    per_step = -(-leaves // K4_LEAVES_A_LAUNCH)
    steps = steps_of(sc, 1)
    print(f"    {leaves} leaves: K4 {flat['launches']['sgd_accum']} launches "
          f"in {steps} steps (want {per_step} a step)", flush=True)
    if flat["launches"]["sgd_accum"] != per_step * steps:
        failed.append(f"vit sgd unscanned: K4 {flat['launches']} for "
                      f"{steps} steps of {leaves} leaves")
    out["sgd_unscanned"] = flat
    del sc
    torch.cuda.empty_cache()

    print(f"  c. lora shape: {LORA_NODES} nodes, {LORA_SAMPLES} samples, "
          f"batch {LORA_BATCH}, SGD at lr {LORA_LR}, {LORA_ROUNDS} rounds "
          f"an arm", flush=True)
    arms, round0 = {}, None
    for tag, rank in (("full", 0), (f"lora{LORA_RANK}", LORA_RANK)):
        sc = Scenario(vit_config(
            f"cifar10-vit-tiny-{LORA_NODES}-{tag}", n=LORA_NODES,
            samples=LORA_SAMPLES, batch=LORA_BATCH, rounds=LORA_ROUNDS,
            optimizer="sgd", lr=LORA_LR, lora_rank=rank), device=dev)
        params = sc.fed.states.params
        if rank:
            merged = tree_leaves(sc.model.materialize(params))
            same = len(merged) == len(round0) and all(
                torch.equal(m, b) for m, b in zip(merged, round0))
            print(f"    merged round-0 model the base (the full arm's "
                  f"round 0) bit for bit: {same}", flush=True)
            if not same:
                failed.append("lora: merged round-0 model is not the base")
            del merged, round0
        else:
            round0 = [t.clone() for t in tree_leaves(params)]
        a = run_arm(f"vit-tiny {tag}", sc, LORA_ROUNDS)
        a.update(leaves=len(tree_leaves(params)),
                 bytes_a_round=LORA_NODES * tree_bytes(params),
                 median_round_s=median_after_warmup(a["round_s"]))
        steps = steps_of(sc, LORA_ROUNDS)
        if a["launches"]["sgd_accum"] != steps:
            failed.append(f"vit {tag}: K4 {a['launches']['sgd_accum']} "
                          f"launches in {steps} steps")
        if not a["losses"][-1] < a["losses"][0]:
            failed.append(f"vit {tag}: loss did not fall: {a['losses']}")
        arms[tag] = a
        del sc, params
        torch.cuda.empty_cache()
    full, ad = arms["full"], arms[f"lora{LORA_RANK}"]
    ratio = full["bytes_a_round"] / ad["bytes_a_round"]
    print(f"    s/round (median after the warm-up) full "
          f"{full['median_round_s']:.4f}, lora {ad['median_round_s']:.4f}; "
          f"bytes a round (f32 "
          f"trees, every node's) full {full['bytes_a_round']}, lora "
          f"{ad['bytes_a_round']}: {ratio:.1f}x fewer", flush=True)
    out["lora"] = dict(arms, bytes_ratio=ratio)
    if failed:
        fail("; ".join(failed))
    return out


# ---------------------------------------------------------------------------
# phase 12: the socket plane
# ---------------------------------------------------------------------------
SOCKET_NODES, SOCKET_SAMPLES = 24, 60  # bench.py's _socket24
SOCKET_CAPS = (8, 24)  # train_set_size: the capped and uncapped arms
SOCKET_ROUNDS = 3
#: 12b and 13b run 2 rounds, 12a and 13a (``_socket24``'s 24 nodes) 1,
#: cut from 3 to keep the command inside its time limit with phase 14
#: (13c keeps 3: its cut is in round 2)
PHASE12_ROUNDS = 2
SOCKET24_ROUNDS = 1
SOCKET_PROCS = 4  # 12c's child processes
K13 = ("stream_gemm", "stream_wgrad", "dense_bwd")


def socket_protocol(train_set_size: int, **kw):
    """``_socket24``'s protocol: 0.5 s heartbeats, 60 s aggregation and
    10 s vote timeouts, gossip fan-out 12 (``kw`` overrides)."""
    from p2pfl_tpu_torch.config.schema import ProtocolConfig

    return ProtocolConfig(**{
        "heartbeat_period_s": 0.5, "aggregation_timeout_s": 60.0,
        "vote_timeout_s": 10.0, "train_set_size": train_set_size,
        "gossip_fanout": 12, **kw})


#: 12b's protocol: on a ring a session's coverage stalls on partial
#: aggregates that overlap without superseding (both packages' rule), so
#: a round closes at the aggregation timeout; and a stale target gets the
#: same 26 MB partial again every retry window until the gossip's quiet
#: exit, which the ring takes after 2 s
RING_PROTOCOL = dict(aggregation_timeout_s=10.0, gossip_exit_on_equal_rounds=2)


def socket24_config(train_set_size: int, n: int = SOCKET_NODES,
                    rounds: int = SOCKET24_ROUNDS):
    """``bench.py``'s ``_socket24``: mnist-mlp, fully connected, 60
    samples a node, lr 0.05."""
    from p2pfl_tpu_torch.config.schema import (
        DataConfig,
        ScenarioConfig,
        TrainingConfig,
    )

    return ScenarioConfig(
        name=f"sock{n}", n_nodes=n, topology="fully",
        data=DataConfig(dataset="mnist", samples_per_node=SOCKET_SAMPLES),
        training=TrainingConfig(rounds=rounds, epochs_per_round=1,
                                learning_rate=0.05),
        protocol=socket_protocol(train_set_size))


def learner_on_card(ln) -> bool:
    from p2pfl_tpu_torch.core.pytree import tree_leaves

    st = ln.state
    # the shard reaches the device at a node's first fit
    tensors = (tree_leaves(st.params) + tree_leaves(st.opt_state)
               + [st.step, *(ln._xy or ())])
    return (all(t.is_cuda for t in tensors)
            and st.rng.device.type == "cuda")


class FirstFits:
    """Record node ``who``'s first fit: its state before (params, trace,
    the shuffle generator's state) and its params after."""

    def __init__(self, nodes: list, who: int = 0):
        from p2pfl_tpu_torch.learning.learner import TorchLearner

        self.cls, self.nodes, self.who = TorchLearner, nodes, who
        self.before = self.after = None

    def __enter__(self):
        import torch

        from p2pfl_tpu_torch.core.pytree import tree_map

        fit, rec = self.cls.fit, self

        def recording_fit(ln):
            first = (rec.before is None and rec.nodes
                     and ln is rec.nodes[rec.who].learner)
            if first:
                st = ln.state
                rec.before = (tree_map(torch.clone, st.params),
                              tree_map(torch.clone, st.opt_state),
                              st.rng.get_state(), st.step.clone())
            fit(ln)
            if first:
                rec.after = tree_map(torch.clone, ln.state.params)

        self.fit = fit
        self.cls.fit = recording_fit
        return self

    def __exit__(self, *exc):
        self.cls.fit = self.fit


def replay_first_fit(tag: str, ln, rec: FirstFits) -> dict:
    """Node 0's first fit replayed from its recorded state through the
    kernels (its launch counts; the fit's bits) and through the plain
    versions, held as ``check_step_vs_plain`` holds one step (bf16
    compute: the loss within 1e-2 relative, each leaf's update within
    relative L2 5e-2). ``failed`` lists the unmet gates."""
    import dataclasses

    import torch

    from p2pfl_tpu_torch.core.pytree import tree_leaves, tree_map
    from p2pfl_tpu_torch.ops import gemm

    params, trace, rng, step = rec.before
    x, y, mask = ln._train_args()

    def state():
        g = torch.Generator(device=ln.device)
        g.set_state(rng)
        return dataclasses.replace(
            ln.state, params=tree_map(torch.clone, params),
            opt_state=tree_map(torch.clone, trace), rng=g,
            step=step.clone())

    gemm.reset_launches()
    k_state, k_m = ln.fns.train_epochs(state(), x, y, mask, epochs=1)
    torch.cuda.synchronize()
    fit_launches = dict(gemm.launches)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(k_state.params), tree_leaves(rec.after)))
    with PlainVersions():
        p_state, p_m = ln.fns.train_epochs(state(), x, y, mask, epochs=1)
    loss_err = float((k_m["loss"] - p_m["loss"]).abs().max()
                     / p_m["loss"].abs().max())
    worst = max(float(((pk - p0).float() - (pp - p0).float()).norm()
                      / (pp - p0).float().norm())
                for p0, pk, pp in zip(tree_leaves(params),
                                      tree_leaves(k_state.params),
                                      tree_leaves(p_state.params)))
    print(f"  {tag}: node 0's first fit replayed: the socket fit's bits "
          f"{same}; kernels vs plain: loss rel err {loss_err:.3g} (tol "
          f"1e-2), update rel L2 err {worst:.3g} (tol 5e-2); launches of "
          f"the fit { {k: v for k, v in fit_launches.items() if v} }",
          flush=True)
    failed = []
    if not same:
        failed.append(f"{tag}: the replayed first fit is not the fit's bits")
    if not (loss_err <= 1e-2 and worst <= 5e-2):
        failed.append(f"{tag}: node 0's first fit and the plain fit disagree")
    return dict(same_bits=same, loss_rel_err=loss_err, rel_l2_err=worst,
                fit_launches=fit_launches, failed=failed)


def start_accuracy(lns, params) -> float:
    """The mean over the learners of their validation accuracy at
    ``params`` (node 0's first fit's start: the weights every node
    received from the starter)."""
    import torch

    accs = []
    for ln in lns:
        xv = torch.from_numpy(ln.data.x_val).to(ln.device)
        yv = torch.from_numpy(ln.data.y_val).to(ln.device)
        mask = torch.ones(len(xv), dtype=torch.bool, device=ln.device)
        accs.append(float(ln.fns.evaluate(params, xv, yv, mask)
                          ["accuracy"][0]))
    return sum(accs) / len(accs)


def socket_arm(tag: str, cfg, dev, record: bool = False,
               sidecar_out: list | None = None,
               nodes_ref: list | None = None):
    """``run_simulation(cfg)`` on the card with the launch counts zeroed
    before and read after; the nodes' rounds, steps and fits, and where
    their learners' tensors live. ``sidecar_out`` gets the run's
    ``SidecarClient``; ``nodes_ref``, a list, gets the nodes as the run
    makes them (a recorder may hold it)."""
    import torch

    from p2pfl_tpu_torch.ops import gemm
    from p2pfl_tpu_torch.p2p.launch import run_simulation

    nodes: list = nodes_ref if nodes_ref is not None else []
    rec = FirstFits(nodes)
    torch.cuda.synchronize()
    gemm.reset_launches()
    t0 = time.perf_counter()
    if record:
        with rec:
            res = run_simulation(cfg, timeout=300, device=dev,
                                 nodes_out=nodes, sidecar_out=sidecar_out)
    else:
        res = run_simulation(cfg, timeout=300, device=dev, nodes_out=nodes,
                             sidecar_out=sidecar_out)
    torch.cuda.synchronize()
    launches = dict(gemm.launches)
    lns = [nd.learner for nd in nodes]
    out = dict(res, launches=launches, call_s=time.perf_counter() - t0,
               steps=sum(ln.global_step for ln in lns),
               fits=sum(len(ln.train_losses) for ln in lns),
               node_rounds=[nd.round for nd in nodes],
               on_card=all(learner_on_card(ln) for ln in lns),
               first_losses=[ln.train_losses[0] for ln in lns
                             if ln.train_losses],
               last_losses=[ln.train_losses[-1] for ln in lns
                            if ln.train_losses],
               round_wall_s=[nd.round_wall_s for nd in nodes])
    print(f"  {tag}: {res['round_s']} s/round ({res['wall_s']} s for "
          f"{cfg.training.rounds} rounds), bytes in {res['bytes_in']} out "
          f"{res['bytes_out']} (params {res['params_bytes_out']}), beats "
          f"and roles dropped on full lanes {res['floods_dropped']}, mean "
          f"accuracy {res['mean_accuracy']}; rounds {set(out['node_rounds'])}"
          f", {out['fits']} fits, {out['steps']} steps, learners on the card "
          f"{out['on_card']}; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return out, nodes, rec


def socket_gates(tag: str, arm: dict, rounds: int, per_step: dict,
                 extra: dict | None = None) -> list[str]:
    """Every node finished every round, every learner on the card, and
    each kernel launched ``per_step`` times a training step (plus
    ``extra``, the evaluations' launches)."""
    failed = []
    if set(arm["node_rounds"]) != {rounds}:
        failed.append(f"{tag}: nodes finished rounds {arm['node_rounds']}")
    if not arm["on_card"]:
        failed.append(f"{tag}: a learner's tensor is off the card")
    if arm["fits"] <= 0:
        failed.append(f"{tag}: no fit ran")
    for k, v in per_step.items():
        want = v * arm["steps"] + (extra or {}).get(k, 0)
        if arm["launches"][k] != want:
            failed.append(f"{tag}: {k} launched {arm['launches'][k]} "
                          f"times, {want} expected ({v} a step x "
                          f"{arm['steps']} steps + the evaluations)")
    return failed


def socket_plane(dev, ring_launches: dict, ring_steps: int) -> dict:
    """Phase 12: a. ``_socket24`` in process, capped and uncapped; b. the
    FEMNIST-CNN ring over sockets, f32 and bf16 wire, node 0's first fit
    against the plain versions; c. the multi-process launcher on the
    card. Gates are raised at the end."""
    import tempfile

    import torch

    from p2pfl_tpu_torch.ops import gemm

    out: dict = {}
    failed: list[str] = []
    # the phase 3 ring's launches a training step (its K1 also counts
    # its evaluations, so K1's a step comes from node 0's replayed fit)
    ring_step = {k: ring_launches[k] / ring_steps for k in DENSE_PATH}
    mlp_step = {"sgd_accum": 1, **{k: 0 for k in K13}}
    for ts in SOCKET_CAPS:
        tag = f"12a socket24 train_set_size {ts}"
        arm, nodes, _ = socket_arm(tag, socket24_config(ts), dev)
        failed += socket_gates(tag, arm, SOCKET24_ROUNDS, mlp_step)
        if ring_step["sgd_accum"] != 1:
            failed.append(f"phase 3's K4 a step is {ring_step['sgd_accum']}")
        out[f"socket24_ts{ts}"] = arm
        del nodes
    for wire in ("f32", "bf16"):
        tag = f"12b ring over sockets, {wire} wire"
        cfg = ring_config(f"socket-ring-{wire}", rounds=PHASE12_ROUNDS)
        cfg.wire_dtype = wire
        cfg.protocol = socket_protocol(0, **RING_PROTOCOL)
        arm, nodes, rec = socket_arm(tag, cfg, dev, record=True)
        if rec.before is None:
            failed.append(f"{tag}: node 0's first fit was not recorded")
            continue
        ln0 = nodes[0].learner
        replay = replay_first_fit(tag, ln0, rec)
        per_fit = replay.pop("fit_launches")
        failed += replay.pop("failed")
        fit_steps = max(len(ln0.data.x) // ln0.batch_size, 1)
        step = {k: per_fit[k] / fit_steps for k in DENSE_PATH}
        # the evaluations' K1: every node's final evaluation, once more
        gemm.reset_launches()
        for nd in nodes:
            nd.learner.evaluate()
        torch.cuda.synchronize()
        evals = {k: gemm.launches[k] for k in DENSE_PATH}
        failed += socket_gates(tag, arm, PHASE12_ROUNDS, step, evals)
        for k in ("stream_wgrad", "dense_bwd", "sgd_accum"):
            if step[k] != ring_step[k]:
                failed.append(f"{tag}: {k} {step[k]} a step, phase 3's "
                              f"{ring_step[k]}")
        if any(step[k] <= 0 for k in DENSE_PATH):
            failed.append(f"{tag}: a kernel is off the fit: {step}")
        first = sum(arm["first_losses"]) / len(arm["first_losses"])
        last = sum(arm["last_losses"]) / len(arm["last_losses"])
        acc0 = start_accuracy([nd.learner for nd in nodes], rec.before[0])
        replay["start_accuracy"] = acc0
        covered = [len(nd.session.covered) for nd in nodes]
        print(f"    mean fit loss {first:.4f} (round 1) -> {last:.4f} "
              f"(round {PHASE12_ROUNDS}); mean validation accuracy "
              f"{acc0:.4f} (the starter's weights) -> "
              f"{arm['mean_accuracy']:.4f}; the last round's coverage a "
              f"node {covered}; a step: {step} (phase 3: {ring_step})",
              flush=True)
        if not last < first:
            failed.append(f"{tag}: loss did not fall ({first} -> {last})")
        if not arm["mean_accuracy"] > acc0:
            failed.append(f"{tag}: accuracy did not rise ({acc0} -> "
                          f"{arm['mean_accuracy']})")
        out[f"ring_{wire}"] = dict(arm, replay=replay, per_step=step,
                                   eval_launches=evals, coverage=covered)
        del nodes, rec, ln0
        torch.cuda.empty_cache()
    # c. the launcher: fresh interpreters, each on the card
    name = torch.cuda.get_device_name(0)
    with tempfile.TemporaryDirectory() as d:
        path = pathlib.Path(d) / "socket4.json"
        socket24_config(0, n=SOCKET_PROCS, rounds=2).save(path)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "p2pfl_tpu_torch.p2p.launch", str(path)],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        secs = time.perf_counter() - t0
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    print(f"  12c launcher, {SOCKET_PROCS} processes, mnist-mlp, 2 rounds: "
          f"exit {proc.returncode} in {secs:.1f} s; {last}", flush=True)
    if proc.returncode != 0:
        failed.append(f"12c: launcher exited {proc.returncode}: "
                      f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    else:
        results = json.loads(last)["nodes"]
        if sorted(r["node"] for r in results) != list(range(SOCKET_PROCS)):
            failed.append(f"12c: results for nodes "
                          f"{[r['node'] for r in results]}")
        for r in results:
            if (r["round"] != 2 or not r["device"].startswith("cuda")
                    or r["device_name"] != name):
                failed.append(f"12c: node {r['node']} reports {r}")
        out["launcher"] = dict(seconds=secs, nodes=results)
    if failed:
        fail("; ".join(failed))
    return out


# ---------------------------------------------------------------------------
# phase 13: the socket plane's transport and privacy layers
# ---------------------------------------------------------------------------
PRIVATE_NODES = 8  # bench.py's private8
SHAPED = dict(delay_ms=50.0, jitter_ms=10.0, loss_pct=5.0, seed=9)
CUT = [[0, 1, 2, 3], [4, 5, 6, 7]]  # 13c's partition window
CUT_S = 4.0  # the window's length
CUT_LEAD_S = 0.5  # from the last node entering round 2 to the cut
TLS_NODES, TLS_ROUNDS = 4, 2


def compute_pids() -> list[int]:
    """The pids ``nvidia-smi`` lists with a compute context (none when
    the query fails)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid",
             "--format=csv,noheader"], capture_output=True, text=True)
    except OSError:
        return []
    return [int(x) for x in out.stdout.split() if x.isdigit()]


def device_fds(pid: int) -> list[str]:
    """The ``/dev/nvidia*`` files process ``pid`` holds open (a CUDA
    context opens ``/dev/nvidiactl`` and the card's device file)."""
    fds = pathlib.Path(f"/proc/{pid}/fd")
    out = []
    for fd in fds.iterdir() if fds.is_dir() else ():
        try:
            target = str(fd.readlink())
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.append(target)
    return sorted(set(out))


class WorkerWatch:
    """While a run is in flight, poll the sidecar worker (once it
    exists): whether ``nvidia-smi`` lists its pid with a compute context,
    which ``/dev/nvidia*`` files it holds, and whether its arena's name
    is still in ``/dev/shm`` (unlinked once the worker attached)."""

    def __init__(self, clients: list, period_s: float = 1.0):
        import threading

        self.clients, self.period_s = clients, period_s
        self.polls = 0
        self.pid = None
        self.smi_pids: set[int] = set()
        self.fds: set[str] = set()
        self.name_seen_late = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        import os

        while not self._stop.wait(self.period_s):
            cl = self.clients[0] if self.clients else None
            proc = getattr(cl, "_proc", None)
            if proc is None or not proc.is_alive():
                continue
            self.pid = proc.pid
            self.smi_pids.update(compute_pids())
            self.fds.update(device_fds(proc.pid))
            if (cl.fused_rounds > 0 and cl.name
                    and os.path.exists(f"/dev/shm/{cl.name}")):
                self.name_seen_late = True
            self.polls += 1

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


class FuseRecorder:
    """Record node ``who``'s first sidecar fuse: its entries' envelopes
    (copied off the arena before the fuse releases them), their weights,
    and the session's published result."""

    def __init__(self, nodes: list, who: int = 0):
        self.nodes, self.who = nodes, who
        self.blobs = self.weights = self.result = None
        self.fused_by_worker = None

    def __enter__(self):
        from p2pfl_tpu_torch.p2p import session as sm

        orig, rec = sm.SidecarSession._fuse_and_close, self
        self.cls, self.orig = sm.SidecarSession, orig

        async def recording(ses, entries, weights, covered):
            mine = (rec.blobs is None and rec.nodes
                    and ses is rec.nodes[rec.who].session)
            if mine:
                rec.blobs = [bytes(ses.client.view(e.slot, e.length))
                             if isinstance(e, sm.SlotEntry) else bytes(e)
                             for e, _ in entries]
                rec.weights = weights.copy()
                before = ses.client.fallbacks
            await orig(ses, entries, weights, covered)
            if mine:
                rec.result = ses.result[0]
                rec.fused_by_worker = ses.client.fallbacks == before

        self.cls._fuse_and_close = recording
        return self

    def __exit__(self, *exc):
        self.cls._fuse_and_close = self.orig


def sidecar_arm(dev, inline: dict, mlp_step: dict) -> tuple[dict, list]:
    """13a: ``bench.py``'s ``aggd24u`` (phase 12a's uncapped
    ``_socket24`` on the sidecar plane); ``inline`` is 12a's uncapped
    arm, run once there."""
    import os

    import numpy as np

    from p2pfl_tpu_torch.core.serialize import (
        decode_parameters,
        tree_leaves_sorted,
    )
    from p2pfl_tpu_torch.p2p.session import fuse_numpy

    tag = "13a sidecar (aggd24u)"
    cfg = socket24_config(train_set_size=SOCKET_NODES)  # 12a's uncapped
    cfg.aggregation_plane = "sidecar"
    clients: list = []
    rec = FuseRecorder([])
    with WorkerWatch(clients) as watch, rec:
        arm, nodes, _ = socket_arm(tag, cfg, dev, sidecar_out=clients,
                                   nodes_ref=rec.nodes)
    failed = socket_gates(tag, arm, SOCKET24_ROUNDS, mlp_step)
    cl = clients[0]
    smi_pid_listed = (watch.pid in watch.smi_pids
                      if watch.pid is not None else None)
    main_listed = os.getpid() in watch.smi_pids
    residue = bool(cl.name) and os.path.exists(f"/dev/shm/{cl.name}")
    same = None
    if rec.blobs is not None and rec.result is not None:
        trees = [decode_parameters(b).release().params for b in rec.blobs]
        want = (trees[0] if len(trees) == 1
                else fuse_numpy(trees, rec.weights)[0])
        same = all(np.array_equal(np.asarray(a), np.asarray(b))
                   and np.asarray(a).dtype == np.asarray(b).dtype
                   for a, b in zip(tree_leaves_sorted(want),
                                   tree_leaves_sorted(rec.result)))
    n = SOCKET_NODES
    print(f"    sidecar: loop payload bytes {arm['loop_payload_touch_bytes']}"
          f" (12a inline {inline['loop_payload_touch_bytes']}); fused "
          f"{arm['aggd_fused_rounds']} (>= {SOCKET24_ROUNDS * n}), "
          f"fallbacks {arm['aggd_fallbacks']}, ingested "
          f"{arm['aggd_bytes_ingested']} B; worker pid {watch.pid}: "
          f"listed by nvidia-smi {smi_pid_listed} (this process listed "
          f"{main_listed}; {watch.polls} polls), /dev/nvidia* open "
          f"{sorted(watch.fds)}; arena {cl.name} in /dev/shm after close "
          f"{residue}, after the attach {watch.name_seen_late}; node 0's "
          f"first fuse ({len(rec.blobs or [])} entries) = fuse_numpy's "
          f"bits {same}", flush=True)
    print(f"    sidecar {arm['round_s']} s/round, bytes in "
          f"{arm['bytes_in']} out {arm['bytes_out']}, accuracy "
          f"{arm['mean_accuracy']}; 12a inline {inline['round_s']} s/round,"
          f" in {inline['bytes_in']} out {inline['bytes_out']}, accuracy "
          f"{inline['mean_accuracy']}", flush=True)
    if arm["loop_payload_touch_bytes"] != 0:
        failed.append(f"{tag}: the loop decoded "
                      f"{arm['loop_payload_touch_bytes']} payload bytes")
    if not inline["loop_payload_touch_bytes"] > 0:
        failed.append(f"{tag}: 12a's inline arm decoded no payload bytes")
    if arm["aggd_fallbacks"] != 0:
        failed.append(f"{tag}: {arm['aggd_fallbacks']} fuses fell back "
                      f"({cl.errors[:3]})")
    if arm["aggd_fused_rounds"] < SOCKET24_ROUNDS * n:
        failed.append(f"{tag}: {arm['aggd_fused_rounds']} fuses, "
                      f"{SOCKET24_ROUNDS * n} expected at least")
    if not arm["aggd_bytes_ingested"] > 0:
        failed.append(f"{tag}: no bytes landed in the arena")
    if watch.pid is None or watch.polls == 0:
        failed.append(f"{tag}: the worker was never seen alive")
    if smi_pid_listed or watch.fds:
        failed.append(f"{tag}: the worker holds a CUDA context "
                      f"({smi_pid_listed}, {sorted(watch.fds)})")
    if residue or watch.name_seen_late:
        failed.append(f"{tag}: the arena's name stayed in /dev/shm")
    if not same or not rec.fused_by_worker:
        failed.append(f"{tag}: the worker's fuse is not fuse_numpy's bits "
                      f"({same}, by the worker {rec.fused_by_worker})")
    arm.update(worker_pid=watch.pid, smi_listed=smi_pid_listed,
               smi_lists_this_process=main_listed, worker_fds=sorted(
                   watch.fds), arena=cl.name, arena_residue=residue,
               fuse_bits=same, polls=watch.polls)
    del nodes
    return arm, failed


def private_config(secagg: bool, rounds: int = SOCKET_ROUNDS):
    """``bench.py``'s ``private8``: 8 mnist-mlp nodes fully connected,
    60 samples, ``train_set_size`` 8, 3 rounds (13b: 2)."""
    from p2pfl_tpu_torch.config.schema import (
        DataConfig,
        PrivacyConfig,
        ProtocolConfig,
        ScenarioConfig,
        TrainingConfig,
    )

    return ScenarioConfig(
        name="private8", n_nodes=PRIVATE_NODES, topology="fully",
        data=DataConfig(dataset="mnist", samples_per_node=SOCKET_SAMPLES),
        training=TrainingConfig(rounds=rounds, epochs_per_round=1,
                                learning_rate=0.05),
        protocol=ProtocolConfig(heartbeat_period_s=0.5,
                                aggregation_timeout_s=60.0,
                                vote_timeout_s=10.0,
                                train_set_size=PRIVATE_NODES),
        privacy=PrivacyConfig(secagg=secagg))


class MaskRecorder:
    """Every node's raw update and weight as ``mask_update`` takes them,
    and node ``who``'s first unmasked session result with its covered
    set."""

    def __init__(self, nodes: list, who: int = 0):
        self.nodes, self.who = nodes, who
        self.updates: dict = {}  # (round, idx) -> (params, weight)
        self.result = None

    def __enter__(self):
        from p2pfl_tpu_torch.core.serialize import own_params
        from p2pfl_tpu_torch.p2p.session import AggregationSession
        from p2pfl_tpu_torch.privacy.secagg import PairwiseMasker

        rec = self
        self.mask, self.finish = (PairwiseMasker.mask_update,
                                  AggregationSession._finish)

        def mask_update(m, params, weight):
            rec.updates[(m.round_num, m.idx)] = (own_params(params),
                                                 int(weight))
            return rec.mask(m, params, weight)

        def finish(ses):
            rec.finish(ses)
            if (rec.result is None and rec.nodes
                    and ses is rec.nodes[rec.who].session
                    and ses.masker is not None):
                rec.result = (ses.masker.round_num, sorted(ses.covered),
                              ses.result[0], ses.reference)

        PairwiseMasker.mask_update = mask_update
        AggregationSession._finish = finish
        self.cls = (PairwiseMasker, AggregationSession)
        return self

    def __exit__(self, *exc):
        self.cls[0].mask_update = self.mask
        self.cls[1]._finish = self.finish


def secagg_arms(dev, mlp_step: dict) -> tuple[dict, list]:
    """13b: ``private8`` plain and under secure aggregation (seeded pair
    secrets); one round's unmasked aggregate against the plain weighted
    sum of the same quantized updates, at tolerance 0."""
    import numpy as np

    from p2pfl_tpu_torch.core.serialize import tree_leaves_sorted
    from p2pfl_tpu_torch.privacy.secagg import (
        DEFAULT_BITS,
        dequantize_sum,
        masked_sum,
        quantize_update,
    )

    out, failed = {}, []
    for secagg in (False, True):
        tag = f"13b private8 {'secagg' if secagg else 'plain'}"
        rec = MaskRecorder([])
        with rec:
            arm, nodes, _ = socket_arm(tag, private_config(
                secagg, PHASE12_ROUNDS), dev, nodes_ref=rec.nodes)
        failed += socket_gates(tag, arm, PHASE12_ROUNDS, mlp_step)
        if secagg:
            exact = None
            if rec.result is not None:
                rnd, covered, got, ref = rec.result
                entries = [(quantize_update(*rec.updates[(rnd, i)],
                                            DEFAULT_BITS),
                            rec.updates[(rnd, i)][1]) for i in covered]
                total, _ = masked_sum(entries)
                want = dequantize_sum(total, sum(w for _, w in entries),
                                      ref, DEFAULT_BITS)
                exact = all(np.array_equal(a, b) for a, b in zip(
                    tree_leaves_sorted(got), tree_leaves_sorted(want)))
                arm["checked_round"] = dict(round=rnd, covered=covered)
            arm["unmask_exact"] = exact
            masked_nodes = sum(nd.masker is not None for nd in nodes)
            print(f"    node 0's first unmasked aggregate (round "
                  f"{arm.get('checked_round')}) = the plain weighted sum "
                  f"of the same quantized updates, bits {exact}; maskers "
                  f"{masked_nodes}", flush=True)
            if not exact:
                failed.append(f"{tag}: the unmasked aggregate is not the "
                              f"plain sum of the quantized updates")
            if masked_nodes != PRIVATE_NODES:
                failed.append(f"{tag}: {masked_nodes} nodes masked")
        out["secagg" if secagg else "plain"] = arm
        del nodes
    plain, masked = out["plain"]["round_s"], out["secagg"]["round_s"]
    out["overhead_pct"] = 100.0 * (masked - plain) / plain
    print(f"    secagg {masked} s/round against plain {plain}: overhead "
          f"{out['overhead_pct']:.2f}%", flush=True)
    return out, failed


def shaped_ring(dev, step: dict, evals: dict) -> tuple[dict, list]:
    """13c: 12b's FEMNIST-CNN ring over sockets (f32 wire) on shaped
    links, with one partition window {0-3} | {4-7} inside round 2.

    The window is the config's ``PartitionSpec``, but its plan clock
    starts when the last node enters round 2: lost votes (a 10 s
    timeout), lost starts and the initial diffusion spread the nodes'
    round boundaries by seconds, so no start fixed before the run lies
    inside every node's round 2. Until then the window lies an hour
    ahead."""
    import asyncio

    import torch

    from p2pfl_tpu_torch.config.schema import NetworkConfig, PartitionSpec
    from p2pfl_tpu_torch.p2p.node import P2PNode

    tag = "13c shaped ring, f32 wire"
    far = 3600.0  # the window's start on a clock that is never re-pinned
    cfg = ring_config("shaped-ring", rounds=SOCKET_ROUNDS)
    cfg.wire_dtype = "f32"
    cfg.protocol = socket_protocol(0, **RING_PROTOCOL)
    cfg.network = NetworkConfig(**SHAPED, partitions=[PartitionSpec(
        start_s=far, duration_s=CUT_S, groups=CUT)])
    nodes: list = []
    edges: list = []
    entered: set = set()
    opened: list = []  # monotonic time the window opens
    on_edge, train_round = P2PNode._on_netem_transition, P2PNode._train_round

    def recording(nd, kind, groups):
        # the round in progress: ``nd.round`` counts up before the
        # round's closing barrier, ``round_wall_s`` once the round ends
        edges.append((nd.idx, kind, len(nd.round_wall_s),
                      nd.shaper.part_dropped))
        on_edge(nd, kind, groups)

    async def timed_round(nd):
        if nd.round == 1:
            entered.add(nd.idx)
            if len(entered) == len(nodes) and not opened:
                # every shaper's plan time reaches ``far`` CUT_LEAD_S
                # from now, in one step of the one loop
                now = asyncio.get_running_loop().time()
                for m in nodes:
                    m.shaper._epoch = now + CUT_LEAD_S - far
                opened.append(time.monotonic() + CUT_LEAD_S)
        return await train_round(nd)

    P2PNode._on_netem_transition = recording
    P2PNode._train_round = timed_round
    try:
        arm, nodes, _ = socket_arm(tag, cfg, dev, nodes_ref=nodes)
    finally:
        P2PNode._on_netem_transition = on_edge
        P2PNode._train_round = train_round
    failed = socket_gates(tag, arm, SOCKET_ROUNDS, step, evals)
    loss = sum(nd.shaper.dropped for nd in nodes)
    cut = sum(nd.shaper.part_dropped for nd in nodes)
    at_heal = {i: d for i, k, _, d in edges if k == "heal"}
    after = sum(nd.shaper.part_dropped - at_heal.get(nd.idx, 0)
                for nd in nodes)
    rounds_at = sorted({(k, r) for _, k, r, _ in edges})
    t0 = min(nd.learn_t0 for nd in nodes if nd.learn_t0 is not None)
    start = opened[0] - t0 if opened else None
    window = (start, start + CUT_S) if opened else None
    first = sum(arm["first_losses"]) / len(arm["first_losses"])
    last = sum(arm["last_losses"]) / len(arm["last_losses"])
    shown = f"{start:.2f}-{start + CUT_S:.2f} s" if opened else "never"
    print(f"    shaped: window {shown} after the first node began "
          f"learning; edges (kind, round in progress from 0) {rounds_at}; loss drops "
          f"{loss}, cut drops {cut}, cut drops after the heal {after}; mean "
          f"fit loss {first:.4f} -> {last:.4f}; bytes in {arm['bytes_in']} "
          f"out {arm['bytes_out']}", flush=True)
    if not opened:
        failed.append(f"{tag}: only nodes {sorted(entered)} entered round 2")
    if not loss > 0:
        failed.append(f"{tag}: the shapers dropped nothing to loss")
    if not cut > 0:
        failed.append(f"{tag}: nothing was dropped on the cut")
    if after != 0 or len(at_heal) != len(nodes):
        failed.append(f"{tag}: {after} cut drops after the heal, "
                      f"{len(at_heal)} nodes healed")
    if {r for _, r in rounds_at} != {1}:
        failed.append(f"{tag}: the window was not inside round 2: "
                      f"{rounds_at}")
    if not last < first:
        failed.append(f"{tag}: loss did not fall ({first} -> {last})")
    arm.update(window=window, loss_drops=loss, cut_drops=cut,
               cut_drops_after_heal=after, edges=rounds_at)
    del nodes
    torch.cuda.empty_cache()
    return arm, failed


def tls_arms(dev, mlp_step: dict) -> tuple[dict, list]:
    """13d: 4 mnist-mlp nodes in one loop under mutual TLS, 2 rounds,
    then again with secure aggregation on ECDH pair secrets; or, without
    ``cryptography`` here, the one line that says so."""
    import numpy as np

    from p2pfl_tpu_torch.config.schema import PrivacyConfig
    from p2pfl_tpu_torch.core.serialize import tree_leaves_sorted

    try:
        import cryptography  # noqa: F401
    except ImportError:
        return {"run": False}, []
    out, failed = {"run": True}, []
    for secagg in (False, True):
        tag = f"13d TLS{' + secagg (ECDH)' if secagg else ''}"
        cfg = socket24_config(0, n=TLS_NODES, rounds=TLS_ROUNDS)
        cfg.encrypt = True
        cfg.privacy = PrivacyConfig(secagg=secagg)
        arm, nodes, _ = socket_arm(tag, cfg, dev)
        failed += socket_gates(tag, arm, TLS_ROUNDS, mlp_step)
        w0, w2 = (tree_leaves_sorted(nodes[i].learner.get_parameters())
                  for i in (0, 2))
        agree = all(np.allclose(a, b, rtol=1e-4, atol=1e-5)
                    for a, b in zip(w0, w2))
        signed = all(nd._signer is not None for nd in nodes)
        ecdh = all(nd.masker is not None and len(nd.masker.pair_secrets)
                   == TLS_NODES - 1 for nd in nodes) if secagg else None
        print(f"    nodes 0 and 2 agree (rtol 1e-4, atol 1e-5) {agree}; "
              f"signing {signed}; ECDH pair secrets {ecdh}", flush=True)
        if not agree or not signed or ecdh is False:
            failed.append(f"{tag}: agree {agree}, signed {signed}, ECDH "
                          f"{ecdh}")
        out["secagg" if secagg else "tls"] = dict(arm, agree=agree,
                                                  ecdh=ecdh)
        del nodes
    return out, failed


def transport_layers(dev, phase12: dict) -> dict:
    """Phase 13: a. the sidecar against 12a's uncapped inline arm; b.
    secure aggregation; c. shaped links and a partition on 12b's ring;
    d. TLS. Gates are raised at the end."""
    mlp_step = {"sgd_accum": 1, **{k: 0 for k in K13}}
    ring = phase12["ring_f32"]
    out, failed = {}, []
    out["sidecar"], f = sidecar_arm(dev, phase12["socket24_ts24"], mlp_step)
    failed += f
    out["private"], f = secagg_arms(dev, mlp_step)
    failed += f
    out["shaped"], f = shaped_ring(dev, ring["per_step"],
                                   ring["eval_launches"])
    failed += f
    out["tls"], f = tls_arms(dev, mlp_step)
    failed += f
    if failed:
        fail("; ".join(failed))
    return out


# ---------------------------------------------------------------------------
# phase 14: the socket plane's adversarial and elastic layers
# ---------------------------------------------------------------------------
ELASTIC_NODES, ELASTIC_ROUNDS = 24, 4  # bench.py's elastic24
CHAOS_NODES, CHAOS_ROUNDS = 16, 6  # bench.py's chaos16
CHAOS_HALVES = [list(range(8)), list(range(8, 16))]
#: the JAX bench's acceptance, printed beside 14b's gap, not gated: on the
#: CPU neither package holds it over seeds 0-4 (scripts/chaos16_gap.py)
CHAOS_GAP = 0.05
BYZ_SOCKET_ATTACKERS = [2, 5]
DP_SOCKET = dict(clip_norm=1.0, noise_multiplier=1.0)
RESTART_NODE = 1  # 14e: the child killed in round 1


def elastic24_config(async_mode: bool):
    """``bench.py``'s ``elastic24`` (``:2418-2441``): 24 mnist-mlp nodes
    fully connected, 60 samples, 4 rounds, lr 0.05; aggregation 12 s,
    vote 5 s, node 3 s; ``train_set_size`` 24, fan-out 12; stragglers
    0.25 x 4.0, churn 0.2; the async arm closes at 0.5 with beta 0.5."""
    from p2pfl_tpu_torch.config.schema import (
        DataConfig,
        ElasticConfig,
        ProtocolConfig,
        ScenarioConfig,
        TrainingConfig,
    )

    return ScenarioConfig(
        name="elastic24", n_nodes=ELASTIC_NODES, topology="fully",
        data=DataConfig(dataset="mnist", samples_per_node=SOCKET_SAMPLES),
        training=TrainingConfig(rounds=ELASTIC_ROUNDS, epochs_per_round=1,
                                learning_rate=0.05),
        protocol=ProtocolConfig(heartbeat_period_s=0.5,
                                aggregation_timeout_s=12.0,
                                vote_timeout_s=5.0, node_timeout_s=3.0,
                                train_set_size=24, gossip_fanout=12),
        elastic=ElasticConfig(async_aggregation=async_mode,
                              min_received=0.5, staleness_beta=0.5,
                              heartbeat_backoff_base_s=0.25,
                              straggler_fraction=0.25, straggler_factor=4.0,
                              churn_fraction=0.2))


def chaos16_config(faults: list, ckpt_dir: str, seed: int = 0):
    """``bench.py``'s ``chaos16`` (``:2862-2880``): 16 mnist-mlp nodes
    fully connected, 60 samples, 6 rounds, lr 0.05; aggregation 12 s,
    vote 5 s, node 3 s, 0.5 s beats, ``train_set_size`` 16, fan-out 8;
    async at 0.4, beta 0.5; a checkpoint every round."""
    from p2pfl_tpu_torch.config.schema import (
        DataConfig,
        ElasticConfig,
        ProtocolConfig,
        ScenarioConfig,
        TrainingConfig,
    )

    return ScenarioConfig(
        name="chaos16", n_nodes=CHAOS_NODES, topology="fully", seed=seed,
        data=DataConfig(dataset="mnist", samples_per_node=SOCKET_SAMPLES,
                        seed=seed),
        training=TrainingConfig(rounds=CHAOS_ROUNDS, epochs_per_round=1,
                                learning_rate=0.05),
        protocol=ProtocolConfig(heartbeat_period_s=0.5,
                                aggregation_timeout_s=12.0,
                                vote_timeout_s=5.0, node_timeout_s=3.0,
                                train_set_size=16, gossip_fanout=8),
        elastic=ElasticConfig(async_aggregation=True, min_received=0.4,
                              staleness_beta=0.5,
                              heartbeat_backoff_base_s=0.25),
        faults=faults, checkpoint_dir=ckpt_dir, checkpoint_every=1)


def chaos16_faults():
    """Halves cut at round 2, node 11 crashed at 2, heal and restart at
    4 (``bench.py:2883-2888``)."""
    from p2pfl_tpu_torch.config.schema import FaultEvent

    return [FaultEvent(node=0, round=2, kind="partition",
                       groups=CHAOS_HALVES),
            FaultEvent(node=11, round=2, kind="crash"),
            FaultEvent(node=0, round=4, kind="heal"),
            FaultEvent(node=11, round=4, kind="restart")]


class SessionCloses:
    """Every inline session's close: (async, train set size, covered
    members of the train set, timed out)."""

    def __init__(self):
        self.closes: list[tuple[bool, int, int, bool]] = []

    def __enter__(self):
        from p2pfl_tpu_torch.p2p.session import AggregationSession

        self.cls, self.orig, rec = (AggregationSession,
                                    AggregationSession._finish, self)

        def finish(ses):
            rec.closes.append((ses.async_mode, len(ses.train_set),
                               len(ses.covered & ses.train_set),
                               ses.timed_out()))
            rec.orig(ses)

        AggregationSession._finish = finish
        return self

    def __exit__(self, *exc):
        self.cls._finish = self.orig

    def quorum_closes(self) -> int:
        """Async closes at a quorum short of the train set (not by the
        timeout)."""
        return sum(1 for a, ts, cov, late in self.closes
                   if a and cov < ts and not late)


class FitSteps:
    """The training steps of every fit any learner runs: a crashed node's
    learner leaves the nodes' list with its steps."""

    def __init__(self):
        import threading

        self.steps = 0
        self._lock = threading.Lock()

    def __enter__(self):
        from p2pfl_tpu_torch.learning.learner import TorchLearner

        self.cls, self.orig, rec = TorchLearner, TorchLearner.fit, self

        def fit(ln):
            rec.orig(ln)
            with rec._lock:
                rec.steps += ln.local_step

        TorchLearner.fit = fit
        return self

    def __exit__(self, *exc):
        self.cls.fit = self.orig


def churn_arm(tag: str, cfg, dev):
    """``socket_arm`` over every learner the run makes (a rejoined node's
    and the one it replaced): ``steps`` counts every fit's."""
    with SessionCloses() as closes, FitSteps() as fits:
        arm, nodes, _ = socket_arm(tag, cfg, dev)
    arm["steps"] = fits.steps
    return arm, nodes, closes


class OwnUpdate:
    """Node ``who``'s own-update transform in round ``rnd``: the round's
    starting params (the update's reference), the trained params and the
    transformed ones, copied on the card."""

    def __init__(self, nodes: list, who: int, rnd: int):
        self.nodes, self.who, self.rnd = nodes, who, rnd
        self.ref = self.trained = self.sent = None
        self._refs: dict = {}

    def __enter__(self):
        from p2pfl_tpu_torch.core.pytree import tree_map
        from p2pfl_tpu_torch.learning.learner import TorchLearner

        rec = self
        self.cls = TorchLearner
        self.orig = (TorchLearner.device_parameters,
                     TorchLearner.transform_parameters)

        def device_parameters(ln):
            out = rec.orig[0](ln)
            rec._refs[id(ln)] = out
            return out

        def transform_parameters(ln, fn):
            node = (rec.nodes[rec.who] if len(rec.nodes) > rec.who
                    else None)
            mine = (rec.sent is None and node is not None
                    and ln is node.learner and node.round == rec.rnd)
            if mine:
                rec.ref = rec._refs.get(id(ln))
                rec.trained = tree_map(lambda p: p[0].clone(),
                                       ln.state.params)
            rec.orig[1](ln, fn)
            if mine:
                rec.sent = tree_map(lambda p: p[0].clone(), ln.state.params)

        TorchLearner.device_parameters = device_parameters
        TorchLearner.transform_parameters = transform_parameters
        return self

    def __exit__(self, *exc):
        (self.cls.device_parameters,
         self.cls.transform_parameters) = self.orig

    def stacked_row_bits(self, n: int, row_fn) -> bool:
        """The recorded update against ``row_fn(stacked, ref_stacked)``'s
        row ``who`` on the card: the node's trained and starting params
        at row ``who`` of ``[n, ...]`` stacks, seeded rows elsewhere."""
        import torch

        from p2pfl_tpu_torch.core.pytree import tree_leaves, tree_map

        if self.sent is None:
            return False
        g = torch.Generator(device=tree_leaves(self.sent)[0].device)
        g.manual_seed(1)

        def stack(x):
            rows = [torch.randn(x.shape, generator=g, device=x.device)
                    .to(x.dtype) for _ in range(n)]
            rows[self.who] = x
            return torch.stack(rows)

        out = row_fn(tree_map(stack, self.trained), tree_map(stack, self.ref))
        return all(
            a[self.who].dtype == b.dtype and torch.equal(
                a[self.who].view(torch.int16 if b.element_size() == 2
                                 else torch.int32),
                b.view(torch.int16 if b.element_size() == 2
                       else torch.int32))
            for a, b in zip(tree_leaves(out), tree_leaves(self.sent)))


def elastic_arms(dev, mlp_step: dict, smi: str) -> tuple[dict, list]:
    """14a: ``elastic24``, sync and async."""
    out, failed = {}, []
    for mode in (False, True):
        tag = f"14a elastic24 {'async' if mode else 'sync'}"
        arm, nodes, closes = churn_arm(tag, elastic24_config(mode), dev)
        churn = arm["churn"]
        joined = churn["joined"]
        adopted = {i: list(nodes[i].adopted) for i in joined}
        quorum = closes.quorum_closes()
        print(f"    {smi}: {arm['round_s']} s/round, wall {arm['wall_s']} s, "
              f"accuracy {arm['mean_accuracy']}; crashes "
              f"{churn['crashes']}, joined {joined} (adopted {adopted}), "
              f"stragglers {churn['stragglers']}; {len(closes.closes)} "
              f"session closes, {quorum} at a quorum short of the train "
              "set", flush=True)
        failed += socket_gates(tag, arm, ELASTIC_ROUNDS, mlp_step)
        if arm["rounds"] != ELASTIC_ROUNDS:
            failed.append(f"{tag}: the federation ended at {arm['rounds']}")
        if not churn["crashes"] or churn["crashes"] != joined:
            failed.append(f"{tag}: crashes {churn['crashes']}, joined "
                          f"{joined}")
        if any("state_sync" not in a for a in adopted.values()):
            failed.append(f"{tag}: a joiner adopted no STATE_SYNC: "
                          f"{adopted}")
        if mode and quorum < 1:
            failed.append(f"{tag}: no round closed at a quorum short of "
                          "its train set")
        out["async" if mode else "sync"] = dict(
            arm, adopted=adopted, quorum_closes=quorum,
            closes=len(closes.closes))
        del nodes
    return out, failed


def chaos_arms(dev, mlp_step: dict, smi: str) -> tuple[dict, list]:
    """14b: ``chaos16`` and its fault-free twin."""
    import tempfile

    out, failed = {}, []
    with tempfile.TemporaryDirectory() as d:
        clean, nodes, _ = churn_arm("14b chaos16 fault-free twin",
                                    chaos16_config([], d + "/clean"), dev)
        del nodes
        arm, nodes, _ = churn_arm("14b chaos16", chaos16_config(
            chaos16_faults(), d + "/chaos"), dev)
    churn = arm["churn"]
    eleven = nodes[11]
    gap = (None if None in (clean["mean_accuracy"], arm["mean_accuracy"])
           else round(clean["mean_accuracy"] - arm["mean_accuracy"], 4))
    print(f"    {smi}: chaos {arm['round_s']} s/round (wall "
          f"{arm['wall_s']} s), clean {clean['round_s']} s/round; "
          f"recovery_s {churn.get('recovery_s')}; accuracy chaos "
          f"{arm['mean_accuracy']}, clean {clean['mean_accuracy']}, gap "
          f"{gap} (acceptance {CHAOS_GAP}); partitions "
          f"{churn.get('partitions')}, heals {churn.get('heals')}, "
          f"restarted {churn['restarted']}; node 11 came back through "
          f"{eleven.adopted} (resume {eleven.resume})", flush=True)
    failed += socket_gates("14b chaos16 twin", clean, CHAOS_ROUNDS, mlp_step)
    failed += socket_gates("14b chaos16", arm, CHAOS_ROUNDS, mlp_step)
    if churn["restarted"] != [11] or not eleven.resume:
        failed.append(f"14b: restarted {churn['restarted']}")
    if not eleven.adopted or eleven.adopted[0] not in ("checkpoint",
                                                       "state_sync"):
        failed.append(f"14b: node 11 came back through {eleven.adopted}, "
                      "not its checkpoint or a STATE_SYNC")
    if churn.get("partitions") != 1 or churn.get("heals") != 1:
        failed.append(f"14b: partitions {churn.get('partitions')}, heals "
                      f"{churn.get('heals')}")
    if not churn.get("recovery_s"):
        failed.append("14b: no recovery time")
    out.update(chaos=dict(arm, adopted=list(eleven.adopted)), clean=clean,
               gap=gap)
    del nodes
    return out, failed


def byzantine_sockets(dev, ring: dict, smi: str) -> tuple[dict, list]:
    """14c: phase 3's FEMNIST CNN over sockets, fully connected, nodes
    2 and 5 flipping their updates' sign, reputation off and on."""
    from p2pfl_tpu_torch.adversary.attacks import AttackSpec, poison_stacked
    from p2pfl_tpu_torch.config.schema import AdversaryConfig

    out, failed = {}, []
    per_step = {k: ring["per_step"][k] for k in K13[1:] + ("sgd_accum",)}
    for rep in (False, True):
        tag = f"14c Byzantine sockets, reputation {'on' if rep else 'off'}"
        cfg = ring_config(f"socket-byz-{int(rep)}", rounds=SOCKET_ROUNDS)
        cfg.topology = "fully"
        # 12b's timeouts: a full mesh of 13 MB partials saturates every
        # lane, and the gossip's quiet exit after 2 s ends the resends
        cfg.protocol = socket_protocol(0, **RING_PROTOCOL)
        cfg.adversary = AdversaryConfig(nodes=list(BYZ_SOCKET_ATTACKERS),
                                        kind="signflip", reputation=rep)
        nodes: list = []
        with OwnUpdate(nodes, BYZ_SOCKET_ATTACKERS[0], 1) as rec:
            arm, nodes, _ = socket_arm(tag, cfg, dev, nodes_ref=nodes)
        spec = AttackSpec(kind="signflip", scale=cfg.adversary.scale,
                          seed=cfg.adversary.seed)
        mask = [i in BYZ_SOCKET_ATTACKERS for i in range(cfg.n_nodes)]
        bits = rec.stacked_row_bits(
            cfg.n_nodes, lambda st, ref: poison_stacked(st, ref, mask, 1,
                                                        spec))
        steps = arm["steps"]
        print(f"    {smi}: {arm['round_s']} s/round, accuracy "
              f"{arm['mean_accuracy']}, beats and roles dropped on full "
              f"lanes {arm['floods_dropped']}; node 2's round-1 update has "
              f"poison_stacked's row-2 bits {bits}", flush=True)
        failed += socket_gates(tag, arm, SOCKET_ROUNDS, per_step)
        if arm["launches"]["stream_gemm"] < steps:
            failed.append(f"{tag}: K1 launched {arm['launches']} for "
                          f"{steps} steps")
        if not bits:
            failed.append(f"{tag}: node 2's update is not poison_stacked's "
                          "row")
        entry = dict(arm, poison_bits=bits)
        if rep:
            trust, suspects = arm["trust"], arm["suspects"]
            honest = [i for i in range(cfg.n_nodes)
                      if i not in BYZ_SOCKET_ATTACKERS]
            ranked = all(trust[i][a] < trust[i][j] for i in honest
                         for a in BYZ_SOCKET_ATTACKERS
                         for j in honest if j != i)
            print(f"    suspects {suspects}; every honest monitor ranks 2 "
                  f"and 5 below each honest peer {ranked}; node 0's trust "
                  f"{trust[0]}", flush=True)
            if not ranked or not set(BYZ_SOCKET_ATTACKERS) <= set(suspects):
                failed.append(f"{tag}: suspects {suspects}, trust {trust}")
        out["reputation" if rep else "undefended"] = entry
        del nodes, rec
    return out, failed


def dp_sockets(dev, mlp_step: dict, smi: str) -> tuple[dict, list]:
    """14d: ``private8`` with DP-FedAvg on every node (clip 1.0, noise
    multiplier 1.0, seed 0)."""
    import math

    from p2pfl_tpu_torch.privacy.dp import DPSpec, epsilon_at, \
        privatize_stacked

    cfg = private_config(False)
    cfg.privacy.dp = True
    cfg.privacy.clip_norm = DP_SOCKET["clip_norm"]
    cfg.privacy.noise_multiplier = DP_SOCKET["noise_multiplier"]
    tag = "14d private8 with DP"
    nodes: list = []
    with OwnUpdate(nodes, 0, 1) as rec:
        arm, nodes, _ = socket_arm(tag, cfg, dev, nodes_ref=nodes)
    spec = DPSpec(seed=cfg.seed, **DP_SOCKET)
    mask = [i == 0 for i in range(cfg.n_nodes)]
    bits = rec.stacked_row_bits(
        cfg.n_nodes, lambda st, ref: privatize_stacked(st, ref, mask, 1,
                                                       spec))
    eps = epsilon_at(spec.noise_multiplier, arm["rounds"], cfg.privacy.delta)
    want = {"dp_epsilon": round(eps, 4) if math.isfinite(eps) else eps,
            "dp_epsilon_budget": cfg.privacy.epsilon_budget}
    got = {k: arm.get(k) for k in want}
    print(f"    {smi}: {arm['round_s']} s/round, accuracy "
          f"{arm['mean_accuracy']}; node 0's round-1 update has "
          f"privatize_stacked's row-0 bits {bits}; privacy keys {got} "
          f"(epsilon_at: {want})", flush=True)
    failed = socket_gates(tag, arm, SOCKET_ROUNDS, mlp_step)
    if not bits:
        failed.append(f"{tag}: node 0's update is not privatize_stacked's "
                      "row")
    if got != want:
        failed.append(f"{tag}: privacy keys {got}, want {want}")
    del nodes, rec
    return dict(arm, dp_bits=bits, privacy=got), failed


def launcher_children(config: pathlib.Path) -> dict[int, list[str]]:
    """pid -> argv of the live launcher children running ``config``."""
    out = {}
    for d in pathlib.Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            argv = [a.decode() for a in (d / "cmdline").read_bytes()
                    .split(b"\0") if a]
        except OSError:
            continue
        if str(config) in argv and "--node" in argv:
            out[int(d.name)] = argv
    return out


def proc_state(pid: int) -> tuple[str, int] | None:
    """``(state, ppid)`` of process ``pid`` from ``/proc/<pid>/stat``
    ("Z" for a zombie), or None once it is reaped."""
    try:
        stat = pathlib.Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return None
    fields = stat[stat.rindex(")") + 2:].split()
    return fields[0], int(fields[1])


def children_of(pid: int) -> list[int]:
    """The pids whose parent is ``pid`` (a launcher child's sidecar
    worker and its resource tracker)."""
    out = []
    for d in pathlib.Path("/proc").iterdir():
        if d.name.isdigit():
            st = proc_state(int(d.name))
            if st is not None and st[1] == pid:
                out.append(int(d.name))
    return out


def mapped_arenas(pid: int) -> set[str]:
    """The sidecar arenas (``p2pfl_torch_aggd_*``) process ``pid`` maps;
    the names are unlinked once the worker attaches, so the map is where
    a run's own arenas can be seen."""
    try:
        maps = pathlib.Path(f"/proc/{pid}/maps").read_text()
    except OSError:
        return set()
    out = set()
    for line in maps.splitlines():
        i = line.find("/dev/shm/p2pfl_torch_aggd_")
        if i >= 0:
            out.add(line[i + len("/dev/shm/"):].split()[0])
    return out


def arena_holders(names: set[str]) -> list[int]:
    """The live pids that still map one of ``names``."""
    out = []
    for d in pathlib.Path("/proc").iterdir():
        if d.name.isdigit() and mapped_arenas(int(d.name)) & names:
            out.append(int(d.name))
    return out


class SupervisedRestart:
    """14e: 12c's 4 launcher processes on the aggregation sidecar (one
    worker process and one shared-memory arena each) under
    ``--max-restarts 1`` with a checkpoint a round; node 1's child is
    SIGKILLed as soon as its round-0 checkpoint exists (it is then in
    round 1, and the others' round 1 waits for it under the sync close).

    Read before the kill: the victim's arenas (from its memory map), its
    sidecar worker and its ``/dev/nvidia*`` files (held, so the probe
    sees a CUDA context). After it: the victim is reaped (no zombie), its
    orphaned worker exits and no process maps its arenas; the respawned
    child holds the card's files while it runs; at the end no child of
    this run is left, live or zombie, and none of its arenas is in
    ``/dev/shm``."""

    def __init__(self, smi: str):
        import tempfile
        import threading

        self.smi = smi
        self._dir = tempfile.TemporaryDirectory()
        d = pathlib.Path(self._dir.name)
        self.path = d / "socket4.json"
        cfg = socket24_config(0, n=SOCKET_PROCS, rounds=2)
        cfg.aggregation_plane = "sidecar"
        cfg.checkpoint_dir, cfg.checkpoint_every = str(d / "ck"), 1
        cfg.save(self.path)
        self.ckpt = d / "ck" / f"node_{RESTART_NODE:03d}.ckpt.msgpack"
        self.killed = self.respawned = None
        self.seen: set[int] = set()  # every launcher child of this run
        self.arenas: set[str] = set()  # every arena they mapped
        self.victim: dict = {}
        self.after: dict = {}
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "p2pfl_tpu_torch.p2p.launch",
             str(self.path), "--max-restarts", "1",
             "--restart-backoff-s", "1"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        self._watch = threading.Thread(target=self._kill, daemon=True)
        self._watch.start()

    def _sample(self) -> dict[int, list[str]]:
        kids = launcher_children(self.path)
        self.seen.update(kids)
        for pid in kids:
            self.arenas |= mapped_arenas(pid)
        return kids

    @staticmethod
    def _until(cond, seconds: float) -> bool:
        deadline = time.monotonic() + seconds
        while not cond():
            if time.monotonic() > deadline:
                return False
            time.sleep(0.05)
        return True

    def _kill(self) -> None:
        import os
        import signal

        deadline = time.monotonic() + 240
        while (self.killed is None and self.proc.poll() is None
               and time.monotonic() < deadline):
            kids = self._sample()
            if self.ckpt.exists():
                for pid, argv in kids.items():
                    if argv[argv.index("--node") + 1] == str(RESTART_NODE):
                        workers = children_of(pid)
                        self.victim = dict(
                            pid=pid, arenas=sorted(mapped_arenas(pid)),
                            fds=device_fds(pid), workers=workers,
                            worker_fds={w: device_fds(w) for w in workers})
                        os.kill(pid, signal.SIGKILL)
                        self.killed = pid
            time.sleep(0.01)
        if self.killed is None:
            return
        names = set(self.victim["arenas"])
        after = self.after
        # the supervisor reaps its child: no /proc entry, not even a zombie
        after["reaped"] = self._until(
            lambda: proc_state(self.killed) is None, 10)
        after["victim_state"] = proc_state(self.killed)

        def workers_gone() -> bool:
            return all((proc_state(w) or ("Z", 0))[0] == "Z"
                       for w in self.victim["workers"])

        # an orphaned worker notices its parent's death within 5 s
        after["workers_exited"] = self._until(workers_gone, 30)
        after["arena_holders"] = (
            [] if self._until(lambda: not arena_holders(names), 30)
            else arena_holders(names))
        # the respawned child, with --resume, holds the card while it runs
        def respawned() -> bool:
            for pid, argv in self._sample().items():
                if (argv[argv.index("--node") + 1] == str(RESTART_NODE)
                        and "--resume" in argv):
                    self.respawned = pid
                    return bool(device_fds(pid))
            return self.proc.poll() is not None
        self._until(respawned, 120)
        after["respawned_fds"] = (device_fds(self.respawned)
                                  if self.respawned else [])
        while self.proc.poll() is None:  # the arenas of the whole run
            self._sample()
            time.sleep(0.2)

    def result(self) -> tuple[dict, list]:
        failed: list[str] = []
        try:
            stdout, stderr = self.proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            stdout, stderr = self.proc.communicate()
        self._watch.join()
        secs = time.perf_counter() - self.t0
        left = launcher_children(self.path)
        self._dir.cleanup()
        zombies = sorted(p for p in self.seen
                         if (proc_state(p) or ("",))[0] == "Z")
        in_shm = sorted(n for n in self.arenas
                        if pathlib.Path("/dev/shm", n).exists())
        # a worker whose client closed it is gone in a moment
        holders = ([] if self._until(lambda: not arena_holders(self.arenas),
                                     10) else arena_holders(self.arenas))
        last = stdout.strip().splitlines()[-1] if stdout.strip() else ""
        results = json.loads(last)["nodes"] if self.proc.returncode == 0 \
            else []
        restarts = {r["node"]: r.get("restarts") for r in results}
        v, a = self.victim, self.after
        print(f"  14e supervised restart, {SOCKET_PROCS} processes on the "
              f"sidecar, 2 rounds ({self.smi}): node {RESTART_NODE}'s child "
              f"{self.killed} SIGKILLed after its round-0 checkpoint, "
              f"holding {v.get('fds')}, arenas {v.get('arenas')}, sidecar "
              f"workers {v.get('workers')} (their card files "
              f"{v.get('worker_fds')}); then reaped {a.get('reaped')}, "
              f"workers exited {a.get('workers_exited')}, arena holders "
              f"{a.get('arena_holders')}; the respawned child {self.respawned} "
              f"holds {a.get('respawned_fds')}; the launcher exited "
              f"{self.proc.returncode} in {secs:.1f} s; restarts {restarts}; "
              f"rounds {[r['round'] for r in results]}; of {len(self.seen)} "
              f"children and {len(self.arenas)} arenas: left {sorted(left)}, "
              f"zombies {zombies}, in /dev/shm {in_shm}, mapped by "
              f"{holders}", flush=True)
        if self.killed is None:
            failed.append("14e: node 1's child was never killed")
        if self.proc.returncode != 0:
            failed.append(f"14e: the launcher exited {self.proc.returncode}"
                          f": {stdout[-2000:]} {stderr[-2000:]}")
        elif (restarts.get(RESTART_NODE) != 1
              or any(v != 0 for k, v in restarts.items()
                     if k != RESTART_NODE)
              or sorted(restarts) != list(range(SOCKET_PROCS))
              or any(r["round"] != 2 for r in results)):
            failed.append(f"14e: results {results}")
        if self.killed is not None and not (
                v["fds"] and v["arenas"] and v["workers"]
                and not any(v["worker_fds"].values())):
            failed.append(f"14e: before the kill the victim held {v}: want "
                          "the card's files, an arena and a sidecar worker "
                          "without the card's files")
        if self.killed is not None and not (
                a["reaped"] and a["workers_exited"]
                and not a["arena_holders"] and a["respawned_fds"]):
            failed.append(f"14e: after the kill {a}")
        if left or zombies or in_shm or holders:
            failed.append(f"14e: children left {left}, zombies {zombies}, "
                          f"arenas in /dev/shm {in_shm}, mapped by {holders}")
        return dict(seconds=secs, nodes=results, victim=v,
                    after={k: a[k] for k in a}, children=len(self.seen),
                    arenas=sorted(self.arenas)), failed


def adversarial_elastic(dev, phase12: dict, smi: str) -> dict:
    """Phase 14: a. ``elastic24`` sync and async; b. ``chaos16`` and its
    twin; c. Byzantine DFL over sockets (K1-K4); d. DP on ``private8``;
    e. a supervised restart of a launcher child. Gates are raised at the
    end; the kernels' launches of a-d are in ``launches``."""
    mlp_step = {"sgd_accum": 1, **{k: 0 for k in K13}}
    out, failed = {}, []
    out["elastic"], f = elastic_arms(dev, mlp_step, smi)
    failed += f
    out["chaos"], f = chaos_arms(dev, mlp_step, smi)
    failed += f
    out["byzantine"], f = byzantine_sockets(dev, phase12["ring_f32"], smi)
    failed += f
    out["dp"], f = dp_sockets(dev, mlp_step, smi)
    failed += f
    out["restart"], f = SupervisedRestart(smi).result()
    failed += f
    arms = [out["elastic"]["sync"], out["elastic"]["async"],
            out["chaos"]["chaos"], out["chaos"]["clean"],
            out["byzantine"]["undefended"], out["byzantine"]["reputation"],
            out["dp"]]
    out["launches"] = {k: sum(a["launches"][k] for a in arms)
                       for k in DENSE_PATH}
    if failed:
        fail("; ".join(failed))
    return out


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
    t_run = time.perf_counter()
    print(f"[1] device {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.kernels()
    print(f"    kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    print("[2] kernels vs plain versions (n=8, b=336)", flush=True)
    rows = kernel_checks(dev, peaks(name))
    if args.out is not None:  # kept should a later phase fail
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke_rows.json").write_text(
            json.dumps({"card": smi, "rows": rows}, indent=1))

    print("[3] end to end: FEMNIST CNN, 8 nodes, ring, DFL, 3 rounds",
          flush=True)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    launches, sc = end_to_end(dev)
    ring_steps = steps_of(sc, len(sc.round_times_s))
    profile_round(lambda: sc.run(rounds=1), args.out)
    del sc
    torch.cuda.empty_cache()

    print("[4] end to end: cross-device FEMNIST CNN, 3550 clients, 32 a "
          "round in 4 cohorts of 8 slots, 3 rounds", flush=True)
    cross_launches, cross_data = cross_device(dev, args.out)
    torch.cuda.empty_cache()
    crossdev_headline(dev)
    launches["fedavg_accum"] = cross_launches["fedavg_accum"]
    torch.cuda.empty_cache()

    print("[5] the fused-epoch path: 5 epochs, 64 mnist-mlp nodes, 19 "
          "steps of 32", flush=True)
    launches["fused_mlp_train_epoch"] = fused_epoch_path(dev)
    torch.cuda.empty_cache()

    print("[6] Byzantine DFL: FEMNIST CNN, 16 nodes fully connected, 4 "
          "sign-flippers, 3 rounds a variant", flush=True)
    byzantine(dev)
    torch.cuda.empty_cache()

    print("[7] the private and elastic federation: DP-FedAvg (8 nodes, "
          "4 noise levels, 10 rounds each), faults on the ring, CFL and "
          "SDFL leader faults, elastic churn and stragglers (24 nodes), "
          "cross-device churn", flush=True)
    from p2pfl_tpu_torch.datasets.data import FederatedDataset

    ring_data = FederatedDataset.make(smoke_config().data, N_NODES)
    phase7 = {"private": private_federation(dev)}
    torch.cuda.empty_cache()
    phase7["ring_faults"] = ring_faults(dev, ring_data)
    phase7["leader_faults"] = leader_faults(dev, ring_data)
    torch.cuda.empty_cache()
    phase7["elastic"] = elastic(dev)
    phase7["crossdev_churn"] = crossdev_churn(dev, cross_data)
    del cross_data, ring_data
    torch.cuda.empty_cache()

    print("[8] the learning knobs: the 64-node bf16-state headline, f32 "
          "compute, adam and adamw, the tabular models, K6 with bf16 "
          "state", flush=True)
    phase8 = {"headline": headline(dev)}
    phase8["f32_compute"] = f32_compute(dev)
    phase8.update(adam_arms(dev))
    phase8["tabular"] = tabular(dev)
    phase8["fused_epoch_bf16"] = fused_epoch_bf16(dev)
    launches["sgd_accum_bf16"] = phase8["headline"]["launches"][
        "sgd_accum_bf16"]
    for k in F32_PATH:
        launches[k] = phase8["f32_compute"]["launches"][k]
    launches["fused_mlp_train_epoch_bf16"] = phase8["fused_epoch_bf16"][
        "launches"]
    torch.cuda.empty_cache()

    print("[9] the CIFAR10 ResNets and MobileNets: ResNet9 at bench.py's "
          "_cifar16 (16 nodes, random topology, Dirichlet 0.5, 1024 "
          f"samples a node, batch 128), {CIFAR_ROUNDS} rounds; "
          "resnet18/34/50 and the MobileNets on 4 nodes, "
          f"{CIFAR_OTHERS_ROUNDS} rounds; ResNet9 in f32", flush=True)
    phase9 = cifar_models(dev, args.out)
    torch.cuda.empty_cache()

    print("[10] round-boundary services on phase 3's ring: resume bit for "
          "bit (DFL and SDFL, node 3 crashing and joining), logs, status "
          "records and a profiled round, the staged exchange", flush=True)
    phase10 = round_services(dev, launches)
    torch.cuda.empty_cache()

    print(f"[11] ViT-Tiny and LoRA: bench.py's _vit32_inprocess ({VIT_NODES} "
          f"nodes, Krum, adam, {VIT_ROUNDS} rounds), its SGD arm through K4, "
          f"the _phase_lora shape ({LORA_NODES} nodes, full weights and "
          f"rank-{LORA_RANK} q/v adapters)", flush=True)
    phase11 = vit_and_lora(dev, args.out)
    torch.cuda.empty_cache()

    print(f"[12] the socket plane: bench.py's _socket24 in process "
          f"({SOCKET_NODES} mnist-mlp nodes, train_set_size "
          f"{SOCKET_CAPS}), phase 3's ring over sockets (f32 and bf16 "
          f"wire), the launcher with {SOCKET_PROCS} processes", flush=True)
    print(f"    ({time.perf_counter() - t_run:.0f} s into the command)",
          flush=True)
    phase12 = socket_plane(dev, launches, ring_steps)
    torch.cuda.empty_cache()

    print(f"[13] the socket plane's transport and privacy layers: the "
          f"sidecar on bench.py's aggd24u ({SOCKET_NODES} nodes), secure "
          f"aggregation on private8 ({PRIVATE_NODES} nodes, plain and "
          f"masked), phase 12b's ring on shaped links with a partition "
          f"window, mutual TLS ({TLS_NODES} nodes, then with ECDH secure "
          f"aggregation)", flush=True)
    phase13 = transport_layers(dev, phase12)
    torch.cuda.empty_cache()

    print(f"[14] the socket plane's adversarial and elastic layers ({smi}): "
          f"bench.py's elastic24 ({ELASTIC_NODES} nodes, sync and async), "
          f"chaos16 ({CHAOS_NODES} nodes, a cut, a crash and a restart from "
          f"its checkpoint, and its fault-free twin), phase 3's FEMNIST CNN "
          f"over sockets with 2 sign-flippers (reputation off and on), DP "
          f"on private8, a supervised restart of a launcher child",
          flush=True)
    print(f"    ({time.perf_counter() - t_run:.0f} s into the command)",
          flush=True)
    phase14 = adversarial_elastic(dev, phase12, smi)
    for k in DENSE_PATH:
        launches[k] += phase14["launches"][k]

    replaces = {
        "stream_gemm": "p2pfl_tpu/ops/pallas_gemm.py:116",
        "stream_wgrad": "p2pfl_tpu/ops/pallas_gemm.py:171",
        "dense_bwd": "p2pfl_tpu/ops/pallas_gemm.py:249",
        "sgd_accum": "p2pfl_tpu/ops/pallas_gemm.py:384",
        "fedavg_accum": "p2pfl_tpu/ops/pallas_gemm.py:408",
        "fused_mlp_train_epoch": "p2pfl_tpu/ops/fused_train.py:167",
        # the dtype instantiations of the same TPU kernels
        "stream_gemm_f32": "p2pfl_tpu/ops/pallas_gemm.py:116",
        "stream_wgrad_f32": "p2pfl_tpu/ops/pallas_gemm.py:171",
        "dense_bwd_f32": "p2pfl_tpu/ops/pallas_gemm.py:249",
        "sgd_accum_bf16": "p2pfl_tpu/ops/pallas_gemm.py:384",
        "fused_mlp_train_epoch_bf16": "p2pfl_tpu/ops/fused_train.py:167",
    }
    sources = {
        "stream_gemm": "p2pfl_tpu_torch/ops/csrc/stream_gemm.cu",
        "stream_wgrad": "p2pfl_tpu_torch/ops/csrc/stream_wgrad.cu",
        "dense_bwd": "p2pfl_tpu_torch/ops/csrc/dense_bwd.cu",
        "sgd_accum": "p2pfl_tpu_torch/ops/csrc/sgd.cu",
        "fedavg_accum": "p2pfl_tpu_torch/ops/csrc/sgd_accum.cu",
        "fused_mlp_train_epoch": "p2pfl_tpu_torch/ops/csrc/fused_train.cu",
        "stream_gemm_f32": "p2pfl_tpu_torch/ops/csrc/gemm_f32_tc.cu",
        "stream_wgrad_f32": "p2pfl_tpu_torch/ops/csrc/gemm_f32_tc.cu",
        "dense_bwd_f32": "p2pfl_tpu_torch/ops/csrc/gemm_f32_tc.cu",
        "sgd_accum_bf16": "p2pfl_tpu_torch/ops/csrc/sgd.cu",
        "fused_mlp_train_epoch_bf16":
            "p2pfl_tpu_torch/ops/csrc/fused_train.cu",
    }
    kernels = []
    for k in replaces:
        # per training step (K5: per cohort step; K6: per epoch): the sum
        # over the instances the path runs (K3: the ring step's; its
        # cross-device and Byzantine shapes are printed and kept in the
        # rows, not summed; K4 and K5: the one call over all leaves);
        # launches from the path's own
        # run (K1-K4 the stacked federation, K5 the cross-device round, K6
        # the fused-epoch path; the f32 K1-K3 phase 8b, K4 with bf16
        # params the 64-node headline, K6 with bf16 state phase 8e)
        mine = [r for r in rows
                if r["kernel"] == k and r["on_path"] and r["summed"]]
        top = max(mine, key=lambda r: r["bound_ms"])
        kernels.append({
            "name": k, "route": "cuda", "source": sources[k],
            "replaces": replaces[k], "launches": launches[k],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "bound_by": top["bound_by"],
            "library_ms": (None if any(r["library_ms"] is None
                                       for r in mine)
                           else sum(r["library_ms"] for r in mine)),
        })
    if args.out is not None:
        (args.out / "chip_smoke_rows.json").write_text(
            json.dumps({"card": smi, "rows": rows}, indent=1))
        (args.out / "chip_smoke_phase7.json").write_text(
            json.dumps({"card": smi, **phase7}, indent=1))
        (args.out / "chip_smoke_phase8.json").write_text(
            json.dumps({"card": smi, **phase8}, indent=1))
        (args.out / "chip_smoke_phase9.json").write_text(
            json.dumps({"card": smi, **phase9}, indent=1))
        (args.out / "chip_smoke_phase10.json").write_text(
            json.dumps({"card": smi, **phase10}, indent=1))
        (args.out / "chip_smoke_phase11.json").write_text(
            json.dumps({"card": smi, **phase11}, indent=1))
        (args.out / "chip_smoke_phase12.json").write_text(
            json.dumps({"card": smi, **phase12}, indent=1))
        (args.out / "chip_smoke_phase13.json").write_text(
            json.dumps({"card": smi, **phase13}, indent=1, default=str))
        (args.out / "chip_smoke_phase14.json").write_text(
            json.dumps({"card": smi, **phase14}, indent=1, default=str))
    if not phase13["tls"]["run"]:
        print("tls: not run: no module named cryptography on this machine",
              flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
