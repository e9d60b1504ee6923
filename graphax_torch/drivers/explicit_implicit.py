"""Solver-comparison harness (port of `graphax/drivers/explicit_implicit.py`,
`src/run_explicit_implicit_exp.py`): the same GRAND config trained under
each integrator and step size, recording per epoch the time, loss, NFE and
accuracies, and pickling one results dict per (dataset, method, step size,
run) as the reference does (`:159-216`). The data is a dataset by name
(its files under ``data_dir``, else the shape-matched synthetic stand-in)
or a GraphData the caller passes; nothing is downloaded.

    python -m graphax_torch.drivers.explicit_implicit --dataset Cora
"""

from __future__ import annotations

import argparse
import os
import pickle

FIXED = ("euler", "rk4", "midpoint", "explicit_adams", "implicit_adams")


def run_experiment(dataset: str = "Cora",
                   methods=("euler", "rk4", "dopri5", "explicit_adams",
                            "implicit_adams"),
                   step_sizes=(1.0, 0.5, 0.25), runs: int = 1,
                   epochs: int = 20, results_dir: str = "./results",
                   data_dir: str = "./data", base_overrides=None,
                   device=None, data=None) -> dict:
    """graphax's `run_experiment`; returns ``{(method, step, run):
    record}``, each record graphax's keys."""
    from graphax_torch.data import get_dataset
    from graphax_torch.train import Config, Trainer

    os.makedirs(results_dir, exist_ok=True)
    all_results = {}
    base = dict(dataset=dataset, hidden_dim=32, block="constant",
                function="laplacian", time=3.0, self_loop_weight=1.0,
                lr=0.01, decay=5e-4, no_early=True, max_nfe=2000,
                tol_scale=100.0)
    base.update(base_overrides or {})
    if data is None:
        data = get_dataset(dataset, data_dir=data_dir, device=device)

    for method in methods:
        sizes = step_sizes if method in FIXED else (1.0,)
        for dt in sizes:
            for run in range(runs):
                cfg = Config(**base, method=method, step_size=dt)
                trainer = Trainer(cfg, data, device=device)
                out = trainer.fit(epochs=epochs, seed=run)
                hist = out["history"]
                rec = {
                    "epochs": [h["epoch"] for h in hist],
                    "times": [h["time"] for h in hist],
                    "losses": [h["loss"] for h in hist],
                    "nfes": [h["nfe"] for h in hist],
                    "train_accs": [h["train_acc"] for h in hist],
                    "val_accs": [h["val_acc"] for h in hist],
                    "test_accs": [h["test_acc"] for h in hist],
                    "best": out["best"],
                }
                fname = os.path.join(
                    results_dir,
                    f"{dataset}_{method}_stepsize_{dt}_run_{run}.pickle")
                with open(fname, "wb") as f:
                    pickle.dump(rec, f)
                all_results[(method, dt, run)] = rec
                print(f"{method} dt={dt} run={run}: best val "
                      f"{out['best']['val_acc']:.4f} "
                      f"(avg nfe {sum(rec['nfes']) / len(rec['nfes']):.0f})")
    return all_results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="Cora")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--runs", type=int, default=1)
    p.add_argument("--results_dir", default="./results")
    p.add_argument("--data_dir", default="./data")
    args = p.parse_args(argv)
    run_experiment(args.dataset, epochs=args.epochs, runs=args.runs,
                   results_dir=args.results_dir, data_dir=args.data_dir)


if __name__ == "__main__":
    main()
