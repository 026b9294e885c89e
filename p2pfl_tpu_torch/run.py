"""Scenario runner CLI of the port: the counterpart of
``p2pfl_tpu/run.py``, with the same flags and the same JSON result line.

    python -m p2pfl_tpu_torch.run scenario.json
    python -m p2pfl_tpu_torch.run --federation DFL --topology ring \\
        --nodes 8 --dataset femnist --model femnist-cnn --rounds 3

It runs on the card (CUDA) unless ``--platform cpu`` asks for the CPU;
without a card and without that flag it exits with an error.
"""

from __future__ import annotations

import argparse
import json
import sys

from p2pfl_tpu_torch.config.schema import (
    DataConfig,
    ModelConfig,
    ScenarioConfig,
    TrainingConfig,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="p2pfl_tpu_torch.run",
        description="Run a federated learning scenario on the GPU.",
    )
    p.add_argument("config", nargs="?", help="scenario JSON (optional)")
    p.add_argument("--federation", choices=["DFL", "CFL", "SDFL"],
                   default="DFL")
    p.add_argument("--topology", choices=["fully", "ring", "random", "star"],
                   default="fully")
    p.add_argument("--nodes", type=int, default=2)
    p.add_argument("--dataset", default="mnist")
    p.add_argument("--model", default="mnist-mlp")
    p.add_argument("--partition", default="iid",
                   choices=["iid", "sorted", "dirichlet"])
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--aggregator", default="fedavg")
    p.add_argument("--samples-per-node", type=int, default=None)
    p.add_argument("--target-accuracy", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--transport", choices=["auto", "dense", "sparse"],
                   default="auto")
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--profile-dir", default=None)
    p.add_argument("--save-config", default=None,
                   help="write the effective scenario JSON here and exit")
    p.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                   help="cpu runs on the CPU; the default is the card")
    return p


def config_from_args(args: argparse.Namespace) -> ScenarioConfig:
    if args.config:
        return ScenarioConfig.load(args.config)
    return ScenarioConfig(
        name=f"{args.dataset}-{args.model}-{args.federation.lower()}",
        federation=args.federation,
        topology=args.topology,
        n_nodes=args.nodes,
        data=DataConfig(dataset=args.dataset, partition=args.partition,
                        batch_size=args.batch_size,
                        samples_per_node=args.samples_per_node,
                        seed=args.seed),
        model=ModelConfig(model=args.model),
        training=TrainingConfig(rounds=args.rounds,
                                epochs_per_round=args.epochs,
                                learning_rate=args.lr),
        aggregator=args.aggregator,
        seed=args.seed,
        log_dir=args.log_dir,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        transport=args.transport,
        tensorboard=args.tensorboard,
        wandb=args.wandb,
        profile_dir=args.profile_dir,
    )


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.save_config:
        cfg.save(args.save_config)
        print(f"wrote {args.save_config}")
        return 0
    import torch

    from p2pfl_tpu_torch.federation.scenario import Scenario

    device = args.platform or "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("p2pfl_tpu_torch.run: no CUDA device is available; pass "
              "--platform cpu to run on the CPU", file=sys.stderr)
        return 2
    scenario = Scenario(cfg, device=device)
    result = scenario.run(target_accuracy=args.target_accuracy)
    scenario.close()
    out = {
        "scenario": cfg.name,
        "federation": cfg.federation,
        "topology": cfg.topology,
        "n_nodes": cfg.n_nodes,
        "rounds": result.rounds_run,
        "final_accuracy": round(result.final_accuracy, 4),
        "min_accuracy": round(result.min_accuracy, 4),
        "mean_round_time_s": round(
            sum(result.round_times_s) / max(len(result.round_times_s), 1), 4
        ),
        "rounds_to_target": result.rounds_to_target,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
