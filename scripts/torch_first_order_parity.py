#!/usr/bin/env python3
"""Hold this checkout's first-order training paths to another checkout's on
one NVIDIA card: the same train steps from the same seeds, their losses,
NFE, parameters after the steps and kernel launches.

    python3 scripts/torch_first_order_parity.py --parent DIR [--steps 2]

``DIR`` holds the other checkout (a ``git archive`` unpacked under
``results/``, which git ignores). Each checkout runs in a process of its
own, in the order parent, this, this, parent, every case of
``CASES`` (the arxiv preset on its windowed layout and on CSR, the
attention block on both, GRAND-nl on CSR and windowed, the Computers
preset on its dense stand-in; none with a regulariser). Every process
runs with ``torch.use_deterministic_algorithms`` on, so that the plain
scatters (``index_add_``, ``index_put_``) sum in a fixed order; where a
path still sums by atomics two runs of one checkout need not agree to the
bit. Printed per case: whether the launches and NFE are equal, the
largest relative difference of the losses and of the parameters between
the checkouts beside the same between two runs of one checkout, and
whether each run's launches are those its own NFE give
(:func:`expected_launches`). A case passes where every run's launches
follow its NFE and the checkouts agree as far as two runs of one
checkout agree with each other: bitwise where those are bitwise; where
those take the same steps, in launches and NFE and with parameters no
further apart than the two runs of one checkout are. A case whose runs of
one checkout take different steps is reported ``unresolved``, not passed.
The last line is one JSON object with every case; the exit code is 0 when
every case passes."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    "arxiv_windowed": dict(dataset="ogbn-arxiv"),
    "arxiv_csr": dict(dataset="ogbn-arxiv", community_window=0),
    "attention_csr": dict(dataset="ogbn-arxiv", block="attention",
                          community_window=0),
    "attention_windowed": dict(dataset="ogbn-arxiv", block="attention"),
    "grand_nl_csr": dict(dataset="ogbn-arxiv", block="constant",
                         function="transformer", community_window=0),
    "grand_nl_windowed": dict(dataset="ogbn-arxiv", block="constant",
                              function="transformer"),
    "computers": dict(dataset="Computers"),
}

# the pin's kernels and the windowed blocks' densification run once a pin,
# whatever the NFE; no rule counts them but GRAND-nl's, whose attention
# projects K at every NFE
PIN_KERNELS = ("attention_kproj", "attention_pin", "windowed_densify")


def expected_launches(name: str, f: int, b: int, e: int) -> dict:
    """The launches of case ``name``'s train steps and evaluation from their
    forward (``f``), adjoint (``b``) and evaluation (``e``) NFE: an A x
    every RHS evaluation and an A^T g every adjoint NFE, on the windowed
    layout the blocks' product and the residual's; the attention block's
    pinned values' SDDMM (and on the windowed layout the blocks' gradient)
    every adjoint NFE; GRAND-nl on CSR flash every forward and evaluation
    NFE and the three training kernels every adjoint NFE, on the windowed
    layout K5's route (the K projection, gmax, attention_norm, winatt,
    attention_attspmm) every NFE of the three and the replay's products
    every adjoint NFE; the dense Computers preset none."""
    if name == "computers":
        return {}
    if name == "grand_nl_csr":
        return {"attention_kproj": f + b + e, "flash_attention": f + e,
                "attention_fwd_res": b, "attention_bwd_rows": b,
                "attention_bwd_cols": b}
    if name == "grand_nl_windowed":
        return {**{k: f + b + e for k in ("attention_kproj", "attention_gmax",
                                          "attention_norm", "winatt",
                                          "attention_attspmm")},
                "win_matmul": b, "win_bwd_slab": b, "win_bwd_dense": b}
    out = {"spmm_csr": f + 2 * b + e}
    if name.endswith("windowed"):
        out.update(win_matmul=f + b + e, win_bwd_slab=b)
    if name.startswith("attention"):
        out["sddmm"] = b
        if name.endswith("windowed"):
            out["win_bwd_dense"] = b
    return out


def follows_nfe(name: str, run: dict) -> bool:
    """Whether ``run``'s launches are those its own NFE give."""
    f = sum(fb[0] for fb in run["nfe"])
    b = sum(fb[1] for fb in run["nfe"])
    want = expected_launches(name, f, b, run["eval_nfe"])
    got = {k: v for k, v in run["launches"].items()
           if k in want or k not in PIN_KERNELS}
    return got == want


def worker(root: str, steps: int) -> dict:
    """Every case in this process on ``root``'s package: per case the
    losses, forward and backward NFE, evaluation NFE, launches and each
    parameter after the steps (saved to a file for the comparison)."""
    sys.path.insert(0, root)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch

    from graphax_torch import Trainer, best_config, get_dataset
    from graphax_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    # warn (not raise) where an op has no deterministic form; leave
    # torch.empty's memory as the program leaves it
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    _build.build_all(verbose=False)
    data = {}
    out = {}
    for name, over in CASES.items():
        over = dict(over)
        ds = over.pop("dataset")
        if ds not in data:
            data[ds] = get_dataset(ds)
        tr = Trainer(best_config(ds, **over), data[ds])
        att = getattr(tr.model.block.func, "att", None)
        if att is not None:
            gen = torch.Generator().manual_seed(11)
            with torch.no_grad():
                for lin in (att.Q, att.K):
                    lin.weight.copy_(0.3 * torch.randn(lin.weight.shape,
                                                       generator=gen))
        _build.LAUNCHES.clear()
        losses, nfe = [], []
        for _ in range(steps):
            losses.append(tr.train_step())
            nfe.append((tr.fm.get_value(), tr.bm.get_value()))
        tr.evaluate()
        torch.cuda.synchronize()
        out[name] = {"losses": losses, "nfe": nfe,
                     "eval_nfe": tr.last_eval.nfe,
                     "launches": dict(_build.LAUNCHES),
                     "params": {k: v.detach().float().cpu().tolist()
                                for k, v in tr.model.state_dict().items()
                                if v.is_floating_point()}}
        del tr
    return out


def _rel(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    scale = max(float(np.abs(b).max()) if b.size else 0.0, 1e-30)
    return float(np.abs(a - b).max()) / scale if a.size else 0.0


def compare(x: dict, y: dict) -> dict:
    """Per case: launches equal, NFE equal, the largest relative loss and
    parameter differences (each tensor's largest over its largest entry)."""
    res = {}
    for name in CASES:
        a, b = x[name], y[name]
        res[name] = {
            "launches_equal": a["launches"] == b["launches"],
            "nfe_equal": a["nfe"] == b["nfe"]
            and a["eval_nfe"] == b["eval_nfe"],
            "loss_rel": _rel(a["losses"], b["losses"]),
            "param_rel": max(_rel(a["params"][k], b["params"][k])
                             for k in b["params"]),
            "params_bitwise": all(a["params"][k] == b["params"][k]
                                  for k in b["params"]),
        }
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout's root")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        with open(args.out, "w") as f:
            json.dump(worker(args.worker, args.steps), f)
        return 0
    import tempfile

    import torch

    if not torch.cuda.is_available() or not args.parent:
        print("needs a CUDA card and --parent", file=sys.stderr)
        return 2
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, root in enumerate((args.parent, HERE, HERE, args.parent)):
            path = os.path.join(tmp, f"{i}.json")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", os.path.abspath(root), "--out", path,
                            "--steps", str(args.steps)], check=True,
                           cwd=os.path.abspath(root))
            with open(path) as f:
                runs.append(json.load(f))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    result = {"nvidia_smi": smi,
              "this_vs_parent": compare(runs[1], runs[0]),
              "this_vs_parent_2": compare(runs[2], runs[3]),
              "this_vs_this": compare(runs[1], runs[2]),
              "parent_vs_parent": compare(runs[0], runs[3]),
              "launches": {k: v["launches"] for k, v in runs[1].items()},
              "nfe": {k: (v["nfe"], v["eval_nfe"]) for k, v in
                      runs[1].items()}}
    # every run's launches follow its NFE; a case whose two runs of one
    # tree take the same steps must take them in the other tree too, with
    # parameters no further apart; one whose runs are bitwise the same must
    # be bitwise the other's; one whose runs differ cannot be decided
    verdict = {}
    for name in CASES:
        own = [result[k][name] for k in ("this_vs_this", "parent_vs_parent")]
        cross = [result[k][name] for k in ("this_vs_parent",
                                           "this_vs_parent_2")]
        per_nfe = [follows_nfe(name, run[name]) for run in runs]
        steady = all(r["launches_equal"] and r["nfe_equal"] for r in own)
        bitwise = all(r["params_bitwise"] for r in own)
        spread = max(r["param_rel"] for r in own)
        if bitwise:
            agree = all(r["params_bitwise"] for r in cross)
        elif steady:
            agree = all(r["launches_equal"] and r["nfe_equal"]
                        and r["param_rel"] <= spread for r in cross)
        else:
            agree = None
        verdict[name] = {
            "runs_repeat": "bitwise" if bitwise else
            "same steps" if steady else "differ",
            "launches_follow_nfe": per_nfe,
            "status": "fail" if not all(per_nfe) or agree is False else
            "unresolved" if agree is None else "pass"}
        verdict[name]["ok"] = verdict[name]["status"] == "pass"
    result["verdict"] = verdict
    ok = all(v["ok"] for v in verdict.values())
    result["ok"] = ok
    for name in CASES:
        print(json.dumps({"case": name, **verdict[name], **{
            key: result[key][name] for key in
            ("this_vs_parent", "this_vs_parent_2", "this_vs_this",
             "parent_vs_parent")}}))
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
