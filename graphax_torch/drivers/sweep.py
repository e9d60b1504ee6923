"""Hyperparameter sweep CLI (port of `graphax/drivers/sweep.py`, the
reference's `ray_tune.py` entry point without Ray).

    python -m graphax_torch.drivers.sweep --dataset Cora --num_samples 8
    python -m graphax_torch.drivers.sweep --dataset ogbn-arxiv \\
        --max_concurrent 2 --replicate_reps 1 --device cpu

ASHA-style successive halving over the dataset's search space (random or
TPE proposals), then, with ``--replicate_reps``, the winner re-run reps x
splits times with its statistics. Prints two JSON lines: the best trial,
then ``replication``. Everything runs on the card unless ``--device cpu``;
``--max_concurrent 2`` trains two trials at once, each on a CUDA stream of
its own."""

from __future__ import annotations

import argparse
import json

# the best trial's keys that the first line prints (graphax's)
REPORTED = ("lr", "decay", "hidden_dim", "heads", "time", "tol_scale",
            "block", "attention_dim", "dropout", "input_dropout")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="Cora")
    p.add_argument("--num_samples", type=int, default=8)
    p.add_argument("--max_epochs", type=int, default=32)
    p.add_argument("--grace_period", type=int, default=4)
    p.add_argument("--reduction_factor", type=int, default=4)
    p.add_argument("--replicate_reps", type=int, default=0,
                   help="re-run the winner reps x splits with CI stats")
    p.add_argument("--num_splits", type=int, default=2)
    p.add_argument("--data_dir", default="./data")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_concurrent", type=int, default=1,
                   help="trials trained at once, each in a thread on a "
                        "CUDA stream of its own, round-robin over the "
                        "visible cards (Ray-actors analog)")
    p.add_argument("--search", default="random",
                   choices=["random", "bayes"],
                   help="'bayes' proposes configs with TPE after a random "
                        "startup wave (the reference's AxSearch role)")
    p.add_argument("--checkpoint_dir", default=None,
                   help="make the sweep resumable: trial table + per-trial "
                        "model checkpoints persist here")
    p.add_argument("--max_nfe", type=int, default=1000,
                   help="the solver's NFE budget of every trial (the base "
                        "config's, graphax's 1000 by default)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    from graphax_torch.data import get_dataset
    from graphax_torch.train import Config, Trainer
    from graphax_torch.train.sweep import asha_sweep, replicate_best
    from graphax_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    # concurrent trials: round-robin over the visible cards by default,
    # else on the device asked for
    devices = None if args.device is None else [dev]
    base = Config(dataset=args.dataset, method="dopri5", tol_scale=100.0,
                  max_nfe=args.max_nfe, no_early=True, self_loop_weight=1.0)
    data = get_dataset(base, data_dir=args.data_dir, device=dev)

    out = asha_sweep(lambda cfg: Trainer(cfg, data, device=dev), base,
                     num_samples=args.num_samples,
                     max_epochs=args.max_epochs,
                     grace_period=args.grace_period,
                     reduction_factor=args.reduction_factor,
                     seed=args.seed, verbose=True,
                     max_concurrent=args.max_concurrent,
                     devices=devices, search=args.search,
                     checkpoint_dir=args.checkpoint_dir)
    print(json.dumps({"best_val": out["best_val"],
                      "best_test": out["best_test"],
                      "best_config": {k: v for k, v in
                                      out["best_config"].to_dict().items()
                                      if k in REPORTED}}))

    if args.replicate_reps > 0:
        def make_trainer(cfg, split_seed):
            d = get_dataset(cfg, data_dir=args.data_dir,
                            split_seed=12345 + split_seed, device=dev)
            return Trainer(cfg, d, device=dev)

        stats = replicate_best(make_trainer, out["best_config"],
                               reps=args.replicate_reps,
                               num_splits=args.num_splits,
                               epochs=args.max_epochs,
                               max_concurrent=args.max_concurrent,
                               devices=devices)
        out["replication"] = stats
        print(json.dumps({"replication": {"val": stats["val"],
                                          "test": stats["test"]}}))
    return out


if __name__ == "__main__":
    main()
