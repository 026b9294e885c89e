"""Pick an SGD learning rate for the port's ViT-Tiny on the CPU.

    python scripts/torch_vit_lr_probe.py [--rank R] LR [LR ...]

ViT-Tiny at full width and depth (remat, scan_layers), 2 nodes fully
connected, 128 iid samples a node of the easy CIFAR10 surrogate, batch
32, SGD momentum 0.9, seed 4, 3 rounds a learning rate; ``--rank R``
federates rank-R q/v LoRA adapters instead of the full weights. Prints
one line a learning rate: the rank, the rate, the mean train loss of
each round, the final mean accuracy and the seconds it took (a few
minutes a rate on a CPU). ``chip_smoke.py`` phase 11 takes its SGD
rates from this.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="torch_vit_lr_probe.py")
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("lrs", type=float, nargs="+")
    args = parser.parse_args(argv)

    import numpy as np

    from p2pfl_tpu_torch.config.schema import (
        DataConfig,
        LoraConfig,
        ModelConfig,
        ScenarioConfig,
        TrainingConfig,
    )
    from p2pfl_tpu_torch.federation.scenario import Scenario

    for lr in args.lrs:
        cfg = ScenarioConfig(
            name="vit-lr-probe", n_nodes=2, topology="fully",
            data=DataConfig(dataset="cifar10", partition="iid",
                            samples_per_node=128, batch_size=32,
                            surrogate_profile="easy", seed=4),
            model=ModelConfig(model="vit-tiny",
                              kwargs={"remat": True, "scan_layers": True}),
            training=TrainingConfig(rounds=3, epochs_per_round=1,
                                    learning_rate=lr, optimizer="sgd",
                                    momentum=0.9),
            lora=LoraConfig(rank=args.rank), seed=4)
        t0 = time.perf_counter()
        res = Scenario(cfg, device="cpu").run()
        losses = [round(float(np.mean(h["train_loss"])), 4)
                  for h in res.history]
        print(args.rank, lr, losses, res.final_accuracy,
              round(time.perf_counter() - t0, 1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
