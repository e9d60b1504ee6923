#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of graphax (graphax_torch) on one NVIDIA card.

    python3 chip_smoke.py [--epochs 3]

Phases, each printed as one JSON line on stdout (any failure exits non-zero
and prints no result):

1. device: the card, its name and power limit (nvidia-smi), TF32 off;
2. build: the CUDA kernels of graphax_torch/kernels/csrc, built by nvcc;
3. kernels: every kernel against its plain PyTorch version at the slice's
   shapes (the synthetic ogbn-arxiv graph, D=162, H=2, A=32) in f32 and
   bf16, with its error beside the stated tolerance, its median time, the
   plain version's time and torch.sparse's time as a yardstick, then one
   line naming every ported kernel;
4. slice: the main path, ``Trainer(best_config("ogbn-arxiv",
   community_window=0), get_dataset("ogbn-arxiv")).fit(3 epochs)``, with
   the kernel launch counts of that run;
5. breakdown: one more train step under torch.profiler, its time by span;
6. reference: a small graph trained on the card and on the CPU from the
   same weights must agree step by step.

Then the kernels line (launches from phase 4 only), the card's nvidia-smi
line, and last ``{"ok": true, "device": {...}}``. Needs one card; builds
everything from the checkout; needs no network."""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"float32": 67e12,      # f32 outside the tensor cores
            "bfloat16": 989e12}    # bf16 tensor cores, dense
# kernel against plain version, per output dtype: f32 sums in another order
# (the plain index_add_ on the card uses atomics); bf16 outputs add one
# rounding of that sum to bf16 (2^-9 relative) that can land either side
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 8e-3)}
# f32 outputs of long dot products (sddmm: D=162 terms of size ~1)
TOL_DOT = (1e-4, 1e-5)
# the pin's f32 scores and softmax
TOL_PIN = (2e-5, 2e-4)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` launches, each timed by
    CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def compare(got, want, tol) -> dict:
    import torch

    atol, rtol = tol
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), "kernel output not finite")
    err = (got - want).abs()
    rel = float((err / want.abs().clamp(min=1e-30)).max())
    return {"max_abs_err": float(err.max()), "max_rel_err": rel,
            "atol": atol, "rtol": rtol,
            "ok": bool((err <= atol + rtol * want.abs()).all())}


def bound_ms(nbytes: float, ops: float, dtype_name: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(graph, results: dict) -> None:
    """Hold every kernel to its plain version at the slice's shapes."""
    import torch

    from graphax_torch.kernels import attention_pin as pin_mod
    from graphax_torch.kernels import spmm as spmm_mod

    n, e = graph.num_nodes, graph.num_edges
    d, heads, a = 162, 2, 32
    gen = torch.Generator(device="cuda").manual_seed(0)
    csr, csc = graph.csr, graph.csc
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        b = torch.finfo(dt).bits // 8
        x = torch.randn(n, d, generator=gen, device="cuda").to(dt)
        g = torch.randn(n, d, generator=gen, device="cuda").to(dt)
        w = graph.edge_weight.to(dt).contiguous()
        w_t = spmm_mod.transpose_values(graph, w)

        # spmm_csr: A x and A^T g
        for label, lay, vals, inp in (("A.x", csr, w, x), ("AT.g", csc, w_t, g)):
            got = spmm_mod.spmm_csr(lay, vals, inp, n)
            want = spmm_mod.spmm_csr_plain(lay, vals, inp, n)
            c = compare(got, want, TOL[name])
            ms = time_ms(lambda: spmm_mod.spmm_csr(lay, vals, inp, n))
            plain = time_ms(lambda: spmm_mod.spmm_csr_plain(lay, vals, inp, n),
                            reps=5)
            lib = None
            try:
                sp = torch.sparse_csr_tensor(lay.ptr.long(), lay.idx.long(),
                                             vals[:e], size=(n, n))
                lib = time_ms(lambda: torch.sparse.mm(sp, inp), reps=10)
            except (RuntimeError, NotImplementedError) as exc:
                lib_err = str(exc).splitlines()[0][:120]
            nbytes = 2 * n * d * b + e * (b + 4) + 4 * (n + 1)
            bms, by = bound_ms(nbytes, 2.0 * e * d, name)
            row = dict(kernel="spmm_csr", product=label, dtype=name, **c,
                       ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                       bound_by=by, bytes=nbytes,
                       gather_bytes=e * (d * b + 8) + n * d * b)
            if lib is None:
                row["library_error"] = lib_err
            emit({"phase": "kernels", **row})
            check(c["ok"], f"spmm_csr {label} {name} disagrees with plain")
            results.setdefault(("spmm_csr", name, label), row)

        # spmm autograd: the Function's backward (A^T g on CSC, dw by the
        # SDDMM) against the plain versions of the same products
        xr = x.detach().clone().requires_grad_(True)
        wr = w.detach().clone().requires_grad_(True)
        probe = torch.randn(n, d, generator=gen, device="cuda").to(dt)
        spmm_mod.spmm(graph, wr, spmm_mod.transpose_values(graph, wr),
                      xr).backward(probe)
        cx = compare(xr.grad, spmm_mod.spmm_csr_plain(csc, w_t, probe, n),
                     TOL[name])
        cw = compare(wr.grad[:e],
                     spmm_mod.sddmm_plain(csr, probe, x).to(dt),
                     TOL_DOT if dt == torch.float32 else TOL[name])
        emit({"phase": "kernels", "kernel": "spmm (autograd)", "dtype": name,
              "dx": cx, "dw": cw})
        check(cx["ok"] and cw["ok"], f"spmm gradients {name} disagree")

        # sddmm
        got = spmm_mod.sddmm(csr, g, x)
        want = spmm_mod.sddmm_plain(csr, g, x)
        c = compare(got, want, TOL_DOT)
        ms = time_ms(lambda: spmm_mod.sddmm(csr, g, x))
        plain = time_ms(lambda: spmm_mod.sddmm_plain(csr, g, x), reps=5)
        lib = None
        try:
            mask = torch.sparse_csr_tensor(csr.ptr.long(), csr.idx.long(),
                                           torch.zeros(e, dtype=dt,
                                                       device="cuda"),
                                           size=(n, n))
            lib = time_ms(lambda: torch.sparse.sampled_addmm(
                mask, g, x.t(), beta=0.0), reps=10)
        except (RuntimeError, NotImplementedError) as exc:
            lib_err = str(exc).splitlines()[0][:120]
        nbytes = 2 * n * d * b + e * 4 + 4 * (n + 1) + e * 4
        bms, by = bound_ms(nbytes, 2.0 * e * d, name)
        row = dict(kernel="sddmm", dtype=name, **c, ms=ms, plain_ms=plain,
                   library_ms=lib, bound_ms=bms, bound_by=by, bytes=nbytes)
        if lib is None:
            row["library_error"] = lib_err
        emit({"phase": "kernels", **row})
        check(c["ok"], f"sddmm {name} disagrees with plain")
        results.setdefault(("sddmm", name), row)

        # attention_pin: every score type, reweight on and off
        q = torch.randn(n, a, generator=gen, device="cuda").mul(0.3).to(dt)
        xs = torch.randn(n, d, generator=gen, device="cuda").to(dt)
        wk = torch.randn(d, a, generator=gen, device="cuda").mul(0.1).to(dt)
        bk = torch.randn(a, generator=gen, device="cuda").mul(0.1)
        ew = graph.edge_weight.float().contiguous()
        for att in ("scaled_dot", "cosine_sim", "pearson", "exp_kernel"):
            for rw in (False, True):
                args = (csr, q, xs, wk, bk, ew if rw else None, att, heads,
                        1.0, 0.5)
                got = pin_mod.attention_pin(*args)
                want = pin_mod.attention_pin_plain(*args)
                # f32 scores in either dtype (bf16 products are exact in f32)
                c = compare(got, want, TOL_PIN)
                row = dict(kernel="attention_pin", dtype=name, att_type=att,
                           reweight=rw, **c)
                if att == "scaled_dot" and not rw:
                    row["ms"] = time_ms(lambda: pin_mod.attention_pin(*args))
                    row["plain_ms"] = time_ms(
                        lambda: pin_mod.attention_pin_plain(*args), reps=5)
                    row["library_ms"] = None
                    nbytes = (n * d * b + n * a * b + d * a * b + 4 * a
                              + e * 4 + 4 * (n + 1) + e * 4)
                    ops = 2.0 * n * d * a + e * (2.0 * a + 6 * heads)
                    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops,
                                                                name)
                    row["bytes"] = nbytes
                    results.setdefault(("attention_pin", name), row)
                emit({"phase": "kernels", **row})
                check(c["ok"], f"attention_pin {att} rw={rw} {name} disagrees")
        del x, g, xs, q
        torch.cuda.empty_cache()


def phase_breakdown(trainer) -> dict:
    """One train step and one evaluation under torch.profiler: each labelled
    span's host-side and device-side duration in order, device time by
    kernel, and the device's idle share of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda_t = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        with record_function("graphax_torch.train_step"):
            trainer.train_step()
            torch.cuda.synchronize()
        with record_function("graphax_torch.evaluate"):
            trainer.evaluate()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, kernels = [], {}
    for ev in sorted(prof.events(), key=lambda e: e.time_range.start):
        ms = ev.time_range.elapsed_us() / 1e3
        if ev.name.startswith("graphax_torch."):
            spans.append({"span": ev.name, "ms": ms,
                          "side": "device" if ev.device_type == cuda_t
                          else "host"})
        elif ev.device_type == cuda_t:
            k = kernels.setdefault(ev.name[:90], {"ms": 0.0, "count": 0})
            k["ms"] += ms
            k["count"] += 1
    busy = sum(v["ms"] for v in kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:10])
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms,
            "kernel_launches": sum(v["count"] for v in kernels.values()),
            "spans": spans, "device_kernels_top": top}


def phase_reference() -> dict:
    """A small graph trained from the same weights on the card (kernels)
    and on the CPU (plain versions): losses and NFE must agree."""
    import torch

    from graphax_torch import Config, Trainer, make_sbm_dataset

    cfg = Config(dataset="smoke", block="hard_attention", function="laplacian",
                 hidden_dim=16, heads=2, attention_dim=8, batch_norm=True,
                 attention_type="scaled_dot", method="dopri5",
                 tol_scale=11353.6, time=3.0, att_samp_pct=0.8, adjoint=True,
                 adjoint_method="rk4", optimizer="rmsprop", lr=0.0055,
                 decay=0.0, input_dropout=0.0, dropout=0.0, max_nfe=500)
    out = {}
    for dev in ("cuda", "cpu"):
        data = make_sbm_dataset(num_nodes=400, num_classes=4, num_features=32,
                                seed=0, strategy="sparse", device=dev)
        tr = Trainer(cfg, data, device=dev)
        # Q = K = 1e-5 at init pins a uniform attention, whose quantile
        # threshold sits among exact ties; random Q/K separate the values
        gen = torch.Generator().manual_seed(7)
        with torch.no_grad():
            for lin in (tr.model.block.att_layer.Q, tr.model.block.att_layer.K):
                lin.weight.copy_(0.4 * torch.randn(lin.weight.shape,
                                                   generator=gen))
        out[dev] = [(tr.train_step(), tr.fm.get_value()) for _ in range(3)]
        out[dev + "_acc"] = tr.evaluate()
    for (lc, nc), (lp, np_) in zip(out["cuda"], out["cpu"]):
        check(math.isfinite(lc) and abs(lc - lp) <= 1e-4 * max(1.0, abs(lp)),
              f"reference loss cuda {lc} vs cpu {lp}")
        check(nc == np_, f"reference NFE cuda {nc} vs cpu {np_}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "graphax_torch")):
        print("chip_smoke: graphax_torch/ not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    emit({"phase": "device", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})

    # 2. build
    from graphax_torch.kernels import _build

    build_s = _build.build_all(verbose=True)
    emit({"phase": "build", "seconds": build_s})

    from graphax_torch import Trainer, best_config, get_dataset

    t0 = time.perf_counter()
    data = get_dataset("ogbn-arxiv")
    cfg = best_config("ogbn-arxiv", community_window=0)
    trainer = Trainer(cfg, data)
    torch.cuda.synchronize()
    graph = trainer.data.graph
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "num_nodes": graph.num_nodes, "num_edges": graph.num_edges,
          "edge_buffer": graph.edge_buffer_size,
          "num_features": data.num_features, "num_classes": data.num_classes,
          "state_dim": trainer.model.state_dim, "dtype": cfg.dtype})

    # 3. kernels against their plain versions
    results: dict = {}
    phase_kernels(graph, results)
    emit({"phase": "kernels",
          "ported": list(dict.fromkeys(k[0] for k in results))})

    # 4. the main path
    _build.LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fit = trainer.fit(epochs=args.epochs, use_early_stop=False)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    for h in fit["history"]:
        emit({"phase": "slice", **h})
    emit({"phase": "slice", "seconds": time.perf_counter() - t0,
          "launches": launches, "best": fit["best"],
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    for h in fit["history"]:
        check(math.isfinite(h["loss"]), f"epoch {h['epoch']}: loss not finite")
        check(bool(h["success"]), f"epoch {h['epoch']}: solver failed")
        for k in ("train_acc", "val_acc", "test_acc"):
            check(0.0 <= h[k] <= 1.0, f"epoch {h['epoch']}: {k} out of range")
    for k in ("spmm_csr", "attention_pin"):
        check(launches.get(k, 0) > 0, f"{k} never launched on the main path")

    # 5. where the time goes
    emit({"phase": "breakdown", **phase_breakdown(trainer)})

    # 6. small reference: the card against the CPU
    emit({"phase": "reference", **phase_reference()})

    # the kernels line: times from phase 3 at the slice's dtype (bf16)
    kernels = []
    specs = (("spmm_csr", ("spmm_csr", "bfloat16", "A.x"),
              "graphax_torch/kernels/csrc/spmm.cu",
              "graphax/kernels/pallas_tiled.py:79", True),
             ("sddmm", ("sddmm", "bfloat16"),
              "graphax_torch/kernels/csrc/spmm.cu",
              "graphax/kernels/pallas_tiled.py:146", False),
             ("attention_pin", ("attention_pin", "bfloat16"),
              "graphax_torch/kernels/csrc/attention_pin.cu",
              "graphax/kernels/pallas_attention.py:114", True))
    for name, key, src, repl, on_path in specs:
        r = results[key]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches.get(name, 0),
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "on_main_path": on_path, "dtype": "bfloat16"})
    kernels[2]["also_replaces"] = "graphax/kernels/pallas_attention.py:197"
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
