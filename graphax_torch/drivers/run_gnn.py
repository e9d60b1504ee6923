"""The node-classification CLI (port of `graphax/drivers/run_gnn.py`, the
twin of the reference's `src/graph_datasets/run_GNN.py`).

    python -m graphax_torch.drivers.run_gnn --dataset Cora --use_best_params
    python -m graphax_torch.drivers.run_gnn --dataset Cora \\
        --use_best_params --device cpu

argparse over the whole Config schema, the tuned preset merged under the
flags given explicitly (`merge_cmd_args`, `:190-212`), Beltrami's
positional encodings, the two-hop and GDC rewirings and the community
reorder in graphax's order, ``num_splits`` repetitions of the seeded
split protocol, and the mean, std, sem and 95 % interval of the best
validation and test accuracies. Everything runs on the card unless
``--device cpu``. The sharded route (``--mesh_shape`` above 1,
``--distributed``) is not ported yet and raises."""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

from graphax_torch.train.config import Config

SHARDED = ("the sharded model is not ported yet (ROADMAP Queue 1, "
           "item 12)")
# the flags that configure the run, not the Config
_RUN_FLAGS = ("use_best_params", "data_dir", "log_every",
              "synthetic_fallback", "distributed", "device")


def build_parser() -> argparse.ArgumentParser:
    """graphax's flags (every Config field, each defaulting to SUPPRESS so
    that only the flags given override the preset) and ``--device``."""
    p = argparse.ArgumentParser(description="graphax_torch GRAND/BLEND "
                                            "trainer")
    p.add_argument("--use_best_params", action="store_true",
                   help="merge the tuned registry config for the dataset")
    p.add_argument("--data_dir", type=str, default="./data")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--synthetic_fallback", action="store_true", default=True)
    p.add_argument("--mesh_shape", type=str, default=argparse.SUPPRESS,
                   help="comma-separated graph-axis mesh; above 1 raises: "
                        + SHARDED)
    p.add_argument("--distributed", action="store_true",
                   help="multi-host training; raises: " + SHARDED)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    for f in dataclasses.fields(Config):
        if f.name in ("mesh_shape", "mesh_axes"):
            continue
        arg = f"--{f.name}"
        if f.type == "bool" or isinstance(f.default, bool):
            p.add_argument(arg, type=lambda v: v.lower() in ("1", "true"),
                           default=argparse.SUPPRESS)
        elif isinstance(f.default, int):
            p.add_argument(arg, type=int, default=argparse.SUPPRESS)
        elif isinstance(f.default, float):
            p.add_argument(arg, type=float, default=argparse.SUPPRESS)
        else:
            p.add_argument(arg, type=str, default=argparse.SUPPRESS)
    return p


def config_from_args(args) -> Config:
    """The Config of the parsed flags: under ``--use_best_params`` the
    dataset's preset with the explicit flags over it."""
    explicit = {k: v for k, v in vars(args).items() if k not in _RUN_FLAGS}
    if isinstance(explicit.get("mesh_shape"), str):
        explicit["mesh_shape"] = tuple(
            int(s) for s in explicit["mesh_shape"].split(",") if s)
    dataset = explicit.get("dataset", "Cora")
    if args.use_best_params:
        from graphax_torch.train.presets import BEST_PARAMS

        base = dict(BEST_PARAMS.get(dataset, {}))
        base.update(explicit)          # explicit CLI wins (merge_cmd_args)
        return Config.from_dict(base)
    return Config.from_dict(explicit)


def run(cfg: Config, data_dir: str = "./data", log_every: int = 10,
        num_splits: Optional[int] = None, device=None) -> dict:
    """Train ``cfg`` on ``num_splits`` (default ``cfg.num_splits``) splits,
    split ``i`` drawn from seed ``12345 + i`` and trained from seed ``i``;
    prints a line per split and the summary as one JSON line, and returns
    ``{"val": ..., "test": ...}`` (`summarize_runs` of the best
    accuracies)."""
    import numpy as np

    from graphax_torch.data import get_dataset
    from graphax_torch.train import Trainer
    from graphax_torch.utils.device import resolve_device
    from graphax_torch.utils.stats import summarize_runs

    if int(np.prod(cfg.mesh_shape)) > 1:
        raise NotImplementedError(f"mesh_shape {cfg.mesh_shape}: {SHARDED}")
    dev = resolve_device(device)
    splits = num_splits or cfg.num_splits
    val_accs, test_accs = [], []
    for split in range(splits):
        data = get_dataset(cfg, data_dir=data_dir, split_seed=12345 + split,
                           device=dev)
        if cfg.beltrami:
            from graphax_torch.rewiring import apply_beltrami

            enc = apply_beltrami(data, cfg, cache_dir=data_dir)
            cfg = cfg.replace(pos_enc_dim=int(enc.shape[1]))
            data = data.with_pos_encoding(enc)
        if cfg.rewiring == "two_hop":
            from graphax_torch.rewiring import apply_two_hop_rewiring

            data = apply_two_hop_rewiring(data, cfg)
        elif cfg.rewiring == "gdc":
            from graphax_torch.rewiring import apply_gdc_rewiring

            data = apply_gdc_rewiring(data, cfg)
        if cfg.community_window:
            # after rewiring, so the windowed layout matches the final
            # topology
            from graphax_torch.data.reorder import community_reorder

            data = community_reorder(data, window=cfg.community_window)
        out = Trainer(cfg, data, device=dev).fit(log_every=log_every,
                                                 seed=split)
        val_accs.append(out["best"]["val_acc"])
        test_accs.append(out["best"]["test_acc"])
        print(f"split {split}: best val {val_accs[-1]:.4f} "
              f"test {test_accs[-1]:.4f}")

    summary = {"val": summarize_runs(val_accs),
               "test": summarize_runs(test_accs)}
    print(json.dumps(summary))
    return summary


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.distributed:
        raise NotImplementedError(f"--distributed: {SHARDED}")
    cfg = config_from_args(args)
    return run(cfg, data_dir=args.data_dir, log_every=args.log_every,
               device=args.device)


if __name__ == "__main__":
    main()
