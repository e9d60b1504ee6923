#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of graphax (graphax_torch) on one NVIDIA card.

    python3 chip_smoke.py [--epochs 3]

Phases, each printed as one JSON line on stdout (any failure exits non-zero
and prints no result):

1. device: the card, its name and power limit (nvidia-smi), TF32 off;
2. build: the CUDA kernels of graphax_torch/kernels/csrc, built by nvcc;
3. data: the synthetic ogbn-arxiv graph, and the Trainers of both paths:
   the preset as published (``community_window=512``: community reorder and
   the windowed layout, printed) and the earlier ``community_window=0``;
   the Computers and Photo stand-ins (13,381 and 7,487 nodes, the dense
   strategy) and their presets' Trainers;
4. kernels: every kernel against its plain PyTorch version at the shapes
   its path gives it (the sparse graph for spmm_csr, sddmm and the pin,
   sddmm also with its output in the state dtype over a padded length,
   spmm_csr also on a view one value past its load boundary and the pin
   also on a small graph with empty rows, over every score type and
   reweight; the
   windowed layout, T=1323, tile 128, W=512, Wn=331, D=162, and a small odd
   shape, tile 8, W 16, D 5, for the windowed kernels and for spmm_csr on
   the layout's residual edges, as the main path calls it; GRAND-nl's K
   projection, global max and flash kernels on the arxiv CSR with the
   model's own q, Wk and bk, and on a small graph with empty rows over every
   score type, reweight and squareplus; GRAND-nl's training kernels, the
   forward with residuals and the row-side and column-side backward, on the
   arxiv CSR and CSC with the model's own q, Wk and bk and a cotangent from
   a seed, on the hub graph below (its CSR rows, which the forward and the
   row backward walk in segments, and its transpose's hub columns, which
   the column backward walks in segments), and on a small graph with
   duplicate edges, a one-edge row and
   empty rows; the training route's gradients against autograd through the
   plain per-edge path; the dense strategy's masked flash kernel,
   flash_dense, on the Computers stand-in's mask with GRAND-nl's own q and
   k at Computers' widths, N = 13,381, H = 4, dk = 16, D = 128, beside PR 4's
   CSR flash on the same graph and function, and on small graphs with
   empty rows, a hub row and an N off the tile; the three-kernel form,
   attention_norm and attention_attspmm, with attention_gmax before
   them, and the windowed attention kernel winatt (K5) on the windowed
   layout's residual CSR and in-window cells and on the arxiv CSR under
   column normalisation, with the models' own q, k and K table, each
   route timed whole, and on a small community graph over every score
   type, reweight and squareplus and a windowed graph with in-window rows
   of 33, 200 and 512 cells over every score type and reweight; spmm_csr
   (A x and A^T g), sddmm (its CSR and its transpose, f32 output and the
   output in the state dtype) and the pin on a hub graph at arxiv's N and
   E with hub rows of up to 13,000 edges, and the CSR flash,
   attention_gmax and attention_attspmm on it with the GRAND-nl model's own operands; K5,
   with gmax and attention_norm on the residual, on a windowed layout at
   arxiv's N whose in-window rows reach a whole window),
   in f32 and bf16,
   with its error beside the stated tolerance, its median device time, the
   plain version's time, its bound and a PyTorch call as a yardstick where
   one computes the same function (win_bwd_dense's and the K projection's:
   bf16 in, f32 out through ``out_dtype``; win_matmul's rows name its
   staging route; spmm_csr's rows its load width; the
   kernels that gather a row per edge, spmm_csr, the pin (K rows), the
   CSR flash, attention_attspmm, attention_gmax (K rows), K5 and the
   three training kernels, also their all-miss count: every
   gathered row from device memory); flash's bf16 output and attention_attspmm's output in x's
   dtype (after K5's f32 half on the windowed route) as the routes ask for
   them, each bit for bit its f32 output (plus the addend) cast once;
   the windowed products' rows name their staging (the f32 bodies' copy
   bytes of A and B);
   win_bwd_dense with both output dtypes, its bf16 output held to its f32
   output cast, bit for bit, and the win_matmul Function's backward with
   no cast of a [T, tile, W] block; win_bwd_slab (the layout's tiles per
   window printed) with both output dtypes, its bf16 output the f32
   output cast, bit for bit, beside ``bmm`` + ``index_add_`` (two calls),
   on a layout whose window 1 no tile maps (its rows read zero), and the
   win_matmul Function's backward with no cast of a [Wn W, D] slab or its
   [N, D] rows; the f32 K projection (the pin's on the windowed and
   dense strategies) on random operands at the arxiv widths, Computers',
   Photo's and D 400, A 120, each beside ``addmm(out_dtype=float32)``,
   and at odd D, a view one value in and N = 1,001; the f32 pin at D 400,
   A 120 on the arxiv CSR; then one line naming every ported kernel;
5. slice: the main path, ``Trainer(best_config("ogbn-arxiv"),
   get_dataset("ogbn-arxiv")).fit(3 epochs)``, with the kernel launch
   counts of that run; then the earlier ``community_window=0`` path for as
   many epochs, with its own counts, so that its kernels stay driven; then
   GRAND-nl (``block="constant", function="transformer",
   community_window=0``, random Q/K): ``Trainer.evaluate()`` three times,
   each with its NFE, seconds, ms per NFE and launch counts (flash and the
   K projection once per NFE), one RHS evaluation timed alone, and one
   evaluation of its squareplus variant (gmax once per NFE); then GRAND-nl
   trained, ``fit(3 epochs)`` (adjoint rk4; random Q/K drawn at every
   ``init_state``), each step's launches (each training kernel once per
   adjoint NFE, flash once per forward NFE), the gradients at Q and K;
   every ``fit`` with its defaults, so each epoch's evaluation is the
   early-stop one (to ``earlystopxT * T``); then ``Trainer(best_config(
   "Computers")).fit`` and the same for ``"Photo"`` on their stand-ins (the
   dense strategy, the pin, the adjoint with the [N, N] operator's a_p for
   Computers' dopri5), and GRAND-nl's dense evaluation
   (``best_config("Computers", function="transformer", block="constant")``,
   random Q/K) three times, flash_dense once per NFE; then GRAND-nl on
   the windowed strategy as published (``best_config("ogbn-arxiv",
   block="constant", function="transformer")``, random Q/K): three
   evaluations (K5, the K projection, gmax, attention_norm and
   attention_attspmm once per NFE) and ``fit(3 epochs)`` (those once per
   forward, adjoint and evaluation NFE; the replay's win_matmul,
   win_bwd_dense and win_bwd_slab once per adjoint NFE); then with
   ``community_window=0, attention_norm_idx=1``: a softmax and a squareplus
   evaluation and ``fit(2 epochs)`` through the column route; then the
   attention block: ``Trainer(best_config(ds), get_dataset(ds)).fit`` for
   Cora, Citeseer, Pubmed and CoauthorCS on their stand-ins (the dense
   strategy, the per-edge pin with autograd; per epoch the loss, seconds,
   NFE, backward NFE, evaluation NFE, best time and peak device memory),
   then ``best_config("ogbn-arxiv", block="attention")`` on CSR
   (``community_window=0``, 3 epochs) and on the windowed layout (1
   epoch): sddmm once per adjoint NFE (and win_bwd_dense on the windowed
   layout), the pin kernel once per evaluation, sddmm held to its plain
   version on the windowed residual; then the arxiv preset at the
   reference's f32 (``best_config("ogbn-arxiv", dtype="float32")``, the
   windowed layout as published: the f32 bodies of win_matmul and
   win_bwd_slab) for as many epochs, and the attention block in f32 on
   the same layout for one (win_bwd_dense's f32 body once per adjoint
   NFE), each with its first and steady epoch seconds, NFE, peak memory
   and launches as the NFE say;
6. breakdown: one more train step of the windowed path (win_bwd_slab
   once per adjoint NFE), one GRAND-nl
   evaluation and one GRAND-nl train step, one Computers train step and
   early-stop evaluation, one GRAND-nl dense evaluation, one GRAND-nl
   dense train step and early-stop evaluation (flash_dense's device ms),
   one windowed GRAND-nl train step and evaluation, one
   column-normalised train step,
   one Pubmed train step and early-stop evaluation, one f32 windowed
   train step and evaluation and one f32 attention-block step, under
   torch.profiler, time by span (forward solve, adjoint, optimizer) and by
   kernel; on the windowed GRAND-nl step, win_bwd_dense's launches (one
   per adjoint NFE) and the kernel that ran after each; on the f32 steps
   the device ms and launches of the three f32 bodies, every win_matmul
   (and in the attention block's step every win_bwd_dense) launch the
   f32 body's;
7. reference: small graphs (sparse, windowed and dense) trained from the
   same weights on the card and on the CPU must agree step by step, small
   GRAND-nl evaluations must give the same logits and NFE (on a dense
   graph above K6's gate too), a small GRAND-nl trained 3 steps the same
   losses (and in f32 NFE), and a small community graph's GRAND-nl on the
   windowed and column routes (also the column route on the windowed
   graph), the CSR flash with its replayed gradient (squareplus),
   mix_features and the dense route the same f32 logits and NFE, and over
   a train step the same loss, NFE and gradients; the Cora and Pubmed presets
   at toy width, 3 train steps, the same losses, NFE and Q gradients;
8. real_formats: Cora as Planetoid ``ind.*`` pickles (2,708 nodes),
   Computers as the shchur npz (13,752) and ogbn-arxiv as its
   ``processed_graphax.npz`` cache (169,343, OGB's time split), written
   full-size to a temporary directory from a seed (the stand-in's SBM
   recipe at the LCC's size plus components of 1-3 nodes), loaded by
   ``get_dataset(best_config(ds), data_dir=..., synthetic_fallback=False)``
   (parse, LCC and build seconds; the LCC must keep 2,485 and 13,381
   nodes) and trained: Cora 2 epochs; Computers 3 epochs, then 2 with a
   checkpoint and, on a fresh Trainer, resumed to 3 (epoch 3's NFE equal,
   its loss within TOL_RESUME); ogbn-arxiv with ``use_labels=True`` (state
   width 202) 2 epochs on the windowed layout, after the layout's kernels
   at that width are held to their plain versions; every line with the
   card's nvidia-smi line;
9. blend: BLEND at the arxiv preset's widths (features 64 + positional
   98 = 162) in graphax's driver order: DeepWalk's DW64 encodings of the
   stand-in by ``apply_beltrami`` (the skip-gram on the card; seconds,
   probe accuracy, the cache read back); the five kernels of the Beltrami
   paths in ``beltrami_exp`` (attention_pin, attention_kproj,
   flash_attention, attention_gmax under squareplus, attention_norm)
   against their plain versions at the paths' shapes, timed beside their
   bounds, the pin, flash, gmax and the norm also on the hub graph (their
   segment kernels' beltrami_exp instances); then fitted
   with fit's defaults: (a) ``best_config("ogbn-arxiv", beltrami=True,
   attention_type="exp_kernel")`` (windowed, the pin in beltrami_exp),
   (b) the same as GRAND-nl on CSR (flash in beltrami_exp, the per-edge
   gradient replayed; one evaluation under squareplus, gmax's path),
   (d) (b) with ``attention_norm_idx=1`` (the column route: gmax, the
   norm and attspmm per column in every RHS, the per-edge gradient
   replayed), after a small graph evaluated on the card and on the CPU
   from the same weights (logits within 1e-4, NFE equal), (c) (a) on CSR
   with ``rewire_KNN=True, rewire_KNN_epoch=2`` (the 64 nearest
   neighbours of the encoder's output; spmm_csr and the pin in
   beltrami_exp then held to their plain versions on that graph), edge
   sampling at epoch 2 on the Computers stand-in, and GAT
   (``function="GAT", block="constant", community_window=0``) on the
   arxiv CSR for 2 epochs (spmm_csr at every NFE, sddmm in the adjoint);
   per epoch the loss, seconds, NFE and peak memory, per path the
   launches;
10. surface: the rest of the single-graph model surface, each path after
   a small graph (400 nodes, f32) trained 2 steps on the card and on the
   CPU from the same weights (losses within 1e-4, forward and backward NFE
   equal): (a) the arxiv preset under the adaptive adjoint
   (``adjoint_method="adaptive_heun", tol_scale_adjoint=1000``, windowed,
   2 epochs; the blocks' a_p integrated, win_bwd_dense once per adjoint
   NFE, the peak memory printed); every path's forward, backward and
   evaluation solves must succeed; (b) the regularisers: the preset
   with all four (``REG4``) on CSR and windowed and the attention block
   with directional_penalty on both, 1 epoch each, every launch of
   spmm_csr, sddmm and the three windowed products as the NFE say
   (``reg_launches``), then the Functions' second derivatives at the
   arxiv shapes in bf16 and f32 against the same compositions of the
   plain versions, and sddmm on the CSC timed beside its bound; (c) Adams:
   the preset with ``explicit_adams`` and ``implicit_adams`` on a grid of
   8 steps over T (NFE 12 + 5 and 12 + 10, the evaluation's by the same
   rule), then graphax's solver comparison (``run_experiment``) on the
   Cora stand-in, 1 epoch, five methods, step 0.25; (d) the higher-order
   block (order 2) at arxiv widths on CSR, the rewire block on the Cora
   stand-in (k-hop and random edges), the hard block over the transformer
   and over GAT on the arxiv CSR, ``use_flux`` on the preset, and
   ``train_cgnn`` on the Cora and arxiv stand-ins (2 epochs each, after a
   small CGNN held card against CPU). On every path but the rewire
   block's (dense: no kernel) and CGNN's, the launches of the kernels the
   NFE decide equal what the NFE say (``first_order_launches``,
   ``reg_launches``).

11. multimodal: the multimodal family (`phase_multimodal`): (a)
   ``run_multi.main`` on MNIST's preset (synthetic digits; the dense
   [784, 784] grid, no hand-written kernel), (b) ``train_clevr_style`` as
   users run it and one epoch at the reference's widths (1024-wide
   patches, 768-wide tokens), (c) 32 questions on their own chain graphs
   (the block-diagonal union: spmm_csr once an evaluation for the batch,
   the union against per-sample solves, dopri5 with a controller per
   sample), (d) a small
   multimodal model card against CPU, (e) the ResNet-101 trunk to layer3
   card against CPU; under 60 s.
12. drivers: the experiment entry points (`phase_drivers`): (a)
   ``run_gnn.main`` as the README's Quickstart runs it (Cora's preset on
   the synthetic fallback, 2 epochs) and on the arxiv preset from its
   cache (2 splits of 2 epochs; spmm_csr, the pin, attention_kproj,
   windowed_densify, win_matmul and win_bwd_slab as the NFE say); (b)
   ``sweep.main`` on the arxiv cache's sparse strategy (4 trials, ASHA to
   4 epochs, the winner replicated on 2 splits) with one trial at a time
   and with two on two CUDA streams, under deterministic algorithms: the
   trial tables equal, each sweep's seconds and the card's busy share;
   (c) the sweep resumed from its checkpoint directory fits nothing; (d)
   one arxiv epoch under ``profile_trace``, the trace naming the
   hand-written kernels, and ``ThroughputMeter``'s edges x NFE per second.

Then the kernels line (launches summed over the paths of phases 5 and
8-12; each row's phase 12 launches as ``driver_launches``), the card's
nvidia-smi line, and last ``{"ok": true, "device":
{...}}``. Needs one card; builds everything from the checkout; needs no
network."""

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
# the sleep ahead of each timed launch: ~0.5 ms at the H100's clocks,
# longer than any wrapper's host time
SLEEP_CYCLES = 1_000_000
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
# the windowed products' f32 outputs: sums of up to W (or tile * tiles)
# exact products, in another order than the plain bmm's
TOL_WIN = (1e-4, 1e-5)
# the densified blocks hold copies (one rounding to the blocks' dtype)
TOL_EXACT = (0.0, 0.0)
# GRAND-nl's kernels: the f32 keys (sums of D exact products in another
# order); the global max (the same f32 scores up to their summation order);
# flash's output: f32 sums and exp in another order (graphax's own
# attention tolerance), and in bf16 a rounded weight can land on either side
# of a bf16 boundary (one bf16 ulp of one term)
TOL_KPROJ = (1e-4, 1e-5)
TOL_GMAX = (1e-6, 1e-6)
TOL_FLASH = {"float32": (2e-5, 2e-4), "bfloat16": (2e-3, 2e-2)}
# PR 4's CSR flash against the head mean of flash_dense on the same graph:
# in f32 the same function to rounding; in bf16 the two round at different
# points (rnd(x * rnd(e)) with the row's final max, against rnd(p) with a
# running max and each head's output rounded before the mean)
TOL_DENSE_VS_CSR = {"float32": TOL_FLASH["float32"],
                    "bfloat16": (2e-2, 2e-2)}
# the small GRAND-nl evaluation on the card against the CPU: f32 logits,
# and bf16 logits (rounded weights at the margin, through ~30 NFE)
TOL_NL_REF = {"float32": 1e-4, "bfloat16": 2e-2}
# GRAND-nl's training kernels: f32 tables, gradients and sums in another
# order (graphax's attention tolerance), in either dtype since bf16 values
# are exact in f32. Sums of products rounded to bf16 (the forward's output,
# dxv): the weight rnd(mean alpha) is rounded from an alpha whose exp and
# division differ from the plain version's by f32 rounding, so at the
# margin it lands one bf16 ulp apart and moves one term rnd(x * w) by one
# ulp of that term, whatever the size of the sum: 2e-2 relative plus two
# bf16 ulps (2^-6) of the largest term's factor (x, or the cotangent)
TOL_TRAIN = (2e-5, 2e-4)


def tol_rounded(name: str, factor) -> tuple:
    return TOL_TRAIN if name == "float32" else (
        2.0 ** -6 * float(factor.float().abs().max()), 2e-2)

# the autograd route's f32 gradients against autograd through the plain
# per-edge path: sums over up to N nodes in another order, 2e-4 relative
# plus 1e-4 of the largest gradient of that tensor (of a bias and its
# weight together)
GRAD_RTOL, GRAD_ATOL_OF_MAX = 2e-4, 1e-4
# the small GRAND-nl training on the card against the CPU: losses over 3
# steps, relative (bf16: rounded weights at the margin through each step)
TOL_NL_TRAIN_REF = {"float32": 1e-4, "bfloat16": 2e-2}


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
    """Median milliseconds of ``fn()`` on the device over ``reps`` launches,
    each timed by CUDA events. A sleep kernel queued ahead of each start
    event keeps the device busy while the host enqueues ``fn``'s work, so
    the time is the device's, not the host's wrapper and launch overhead
    (10-40 us a call, which single launches timed without the sleep
    include)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
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
    ok = bool((err <= atol + rtol * want.abs()).all())
    if torch.is_tensor(atol):   # an atol per row: its largest
        atol = float(atol.max())
    return {"max_abs_err": float(err.max()), "max_rel_err": rel,
            "atol": atol, "rtol": rtol, "ok": ok}


def bound_ms(nbytes: float, ops: float, dtype_name: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hold_to_plain(results: dict, row: dict, fn, plain, tol, nbytes: float,
                  ops: float, lib=None, timed: bool = True, tag=None,
                  miss_bytes=None):
    """Run a kernel ``fn`` and its ``plain`` version on the same inputs and
    compare them within ``tol``; when ``timed``, add the median times, the
    ``lib`` yardstick ``(label, fn)`` and the bound, and keep the row in
    ``results`` under ``(kernel, dtype[, tag])``. ``row`` names the kernel,
    the dtype and the case. A kernel that returns a tuple is compared part
    by part: ``tol`` then pairs each part with its label and tolerance, and
    the row's ``max_abs_err`` is the largest over the parts. ``miss_bytes``
    (the gathering kernels): the bytes with every gathered row read from
    device memory, printed as ``all_miss_ms`` beside the bound. Emits the
    row; fails on a disagreement."""
    import torch

    got, want = fn(), plain()
    if torch.is_tensor(got):
        row.update(compare(got, want, tol))
    else:
        cs = {label: compare(a, b, t) for (label, t), a, b in zip(tol, got,
                                                                  want)}
        row.update(parts=cs,
                   max_abs_err=max(c["max_abs_err"] for c in cs.values()),
                   ok=all(c["ok"] for c in cs.values()))
    if timed:
        row["ms"] = time_ms(fn)
        row["plain_ms"] = time_ms(plain, reps=5)
        row["library_ms"] = None
        if lib is not None:
            row["library"] = lib[0]
            try:
                row["library_ms"] = time_ms(lib[1], reps=10)
            except (RuntimeError, NotImplementedError) as exc:
                row["library_error"] = str(exc).splitlines()[0][:120]
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops, row["dtype"])
        row["bytes"], row["ops"] = nbytes, ops
        if miss_bytes is not None:
            row["all_miss_ms"] = miss_bytes / HBM_BYTES_PER_S * 1e3
        key = (row["kernel"], row["dtype"]) + (() if tag is None else (tag,))
        results.setdefault(key, row)
    emit({"phase": "kernels", **row})
    check(row["ok"], f"{row['kernel']} {tag or ''} {row['dtype']} "
          f"{row.get('layout', row.get('graph', ''))} disagrees with plain")
    return got


def block_casts(fn, *shapes) -> list:
    """The dtype casts (``aten::_to_copy``) of a tensor shaped like each of
    ``shapes`` while ``fn()`` runs, from torch.profiler's recorded shapes:
    one count per shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    seen = [list(ev.input_shapes[0]) for ev in prof.events()
            if ev.name == "aten::_to_copy" and ev.input_shapes]
    return [seen.count(list(shape)) for shape in shapes]


def spmm_shape(x) -> dict:
    """How spmm_csr takes ``x``: its gathered load's bytes."""
    from graphax_torch.kernels import fused_attention as fa

    return {"gather_width": fa.gather_width(x)}


def spmm_check(results: dict, row: dict, lay, vals, x, n: int, lib=None,
               timed: bool = True, long_rows: bool = False):
    """spmm_csr over ``lay`` against its plain version within TOL, with its
    bound (x, the CSR and its values read once, the output written once)
    and its all-miss count (``gather_bytes``: x read once per edge) when
    ``timed``. ``long_rows`` (rows of thousands of edges, whose f32 sums
    the kernel takes in segments and the plain version's index_add_ in its
    atomics' order): TOL's atol plus, per entry, 2 sqrt(deg) 2^-24
    sum|w x|. The rounding errors of a serial f32 sum of deg terms add up
    as a random walk, with a standard deviation of at most
    sqrt(deg / 9) 2^-24 sum|w x| (terms of one sign); the kernel's
    segments of 128 make its own about ten times smaller on rows of
    thousands, so the bound is about 6 of the plain sum's (the
    deterministic worst case, deg 2^-24 sum|w x|, is sqrt(deg) times
    looser). Printed: ``order_bound_max``, the largest such term, and
    ``exact_err``, the kernel's largest distance from the same rounded
    products summed in f64. Returns the kernel's output."""
    import torch

    from graphax_torch.kernels import spmm as spmm_mod

    name, e, d = row["dtype"], lay.num_slots, x.shape[1]
    b = x.element_size()
    row["gather_bytes"] = e * (d * b + 8) + n * d * b
    tol = TOL[name]
    if long_rows:
        deg = (lay.ptr[1:] - lay.ptr[:-1]).double()[:, None]
        prod = (x[lay.idx.long()] * vals[:e, None]).double()
        mag = torch.zeros(n, d, dtype=torch.float64, device=x.device)
        mag.index_add_(0, lay.seg, prod.abs())
        bound = 2 * deg.sqrt() * 2.0 ** -24 * mag
        exact = torch.zeros_like(mag).index_add_(0, lay.seg, prod)
        row["order_bound_max"] = float(bound.max())
        row["exact_err"] = float((spmm_mod.spmm_csr(lay, vals, x, n).double()
                                  - exact).abs().max())
        tol = (tol[0] + bound.float(), tol[1])
        del deg, prod, mag, bound, exact
        torch.cuda.empty_cache()
    return hold_to_plain(
        results, row, lambda: spmm_mod.spmm_csr(lay, vals, x, n),
        lambda: spmm_mod.spmm_csr_plain(lay, vals, x, n), tol,
        2 * n * d * b + e * (b + 4) + 4 * (n + 1), 2.0 * e * d, lib,
        timed=timed, tag=row["product"], miss_bytes=row["gather_bytes"])


def sddmm_check(results: dict, lay, g, x, lib=None, tag=None,
                timed: bool = True):
    """sddmm over ``lay`` against its plain version within TOL_DOT, timed
    beside its bound (g and x read once, the CSR read and one f32 value a
    slot written once) and all-miss count (x read once per slot) when
    ``timed``; then its output in x's dtype over a padded length (the
    Function's values buffer): the f32 output cast once, zeros past the
    slots, and within TOL_DOT plus one ulp of x's dtype (the two f32 sums
    can round to neighbours) of the plain version cast once."""
    import torch

    from graphax_torch.kernels import spmm as spmm_mod

    n, d = x.shape
    e, b, dt = lay.num_slots, x.element_size(), x.dtype
    name = str(dt).replace("torch.", "")
    nbytes = 2 * n * d * b + 8 * e + 4 * (n + 1)
    width = min(spmm_shape(t)["gather_width"] for t in (g, x))
    got = hold_to_plain(
        results, dict(kernel="sddmm", dtype=name, graph=tag or "arxiv CSR",
                      E=e, D=d, gather_width=width),
        lambda: spmm_mod.sddmm(lay, g, x),
        lambda: spmm_mod.sddmm_plain(lay, g, x), TOL_DOT, nbytes,
        2.0 * e * d, lib, timed=timed, tag=tag,
        miss_bytes=nbytes - n * d * b + e * d * b)
    size = e + 13
    low = spmm_mod.sddmm(lay, g, x, dt, size)
    c = compare(low[:e], spmm_mod.sddmm_plain(lay, g, x, dt),
                (TOL_DOT[0], TOL_DOT[1] + torch.finfo(dt).eps))
    c["cast_once"] = bool(torch.equal(low[:e], got.to(dt)))
    c["tail_zero"] = not bool(low[e:].any())
    emit({"phase": "kernels", "kernel": "sddmm", "dtype": name,
          "graph": tag or "arxiv CSR", "output": name, **c})
    check(c["ok"] and c["cast_once"] and c["tail_zero"],
          f"sddmm {tag or ''} {name}: the output in {name} {c}")
    return got


def pin_checks(results: dict, label: str, graph, gen, dt,
               timed: bool = True, d: int = 162, a: int = 32,
               heads: int = 2, att_types=("scaled_dot", "cosine_sim",
                                          "pearson", "exp_kernel")) -> None:
    """attention_pin against its plain version within TOL_PIN over
    ``att_types``, reweight off and on, on ``graph``'s CSR at the arxiv
    preset's widths (D 162, A 32, 2 heads; random q, x, Wk, bk) unless
    others are given; the scaled_dot case without reweight timed when
    ``timed``, beside its bound (q, x, Wk, the CSR read once, one f32
    written per edge) and its all-miss count (the K table written and one
    K row read per edge from device memory)."""
    import torch

    from graphax_torch.kernels import attention_pin as pin_mod

    n, e = graph.num_nodes, graph.num_edges
    name = str(dt).replace("torch.", "")
    b = dt.itemsize
    q = torch.randn(n, a, generator=gen, device="cuda").mul(0.3).to(dt)
    xs = torch.randn(n, d, generator=gen, device="cuda").to(dt)
    wk = torch.randn(d, a, generator=gen, device="cuda").mul(0.1).to(dt)
    bk = torch.randn(a, generator=gen, device="cuda").mul(0.1)
    ew = graph.edge_weight.float().contiguous()
    nbytes = (n * d * b + n * a * b + d * a * b + 4 * a + e * 4 + 4 * (n + 1)
              + e * 4)
    ops = 2.0 * n * d * a + e * (2.0 * a + 6 * heads)
    for att in att_types:
        for rw in (False, True):
            args = (graph.csr, q, xs, wk, bk, ew if rw else None, att, heads,
                    1.0, 0.5)
            # f32 scores in either dtype (bf16 products are exact in f32)
            hold_to_plain(
                results, dict(kernel="attention_pin", graph=label,
                              dtype=name, att_type=att, reweight=rw, D=d,
                              A=a, H=heads),
                lambda: pin_mod.attention_pin(*args),
                lambda: pin_mod.attention_pin_plain(*args), TOL_PIN, nbytes,
                ops, timed=timed and att == "scaled_dot" and not rw,
                tag=None if label == "arxiv CSR" else label,
                miss_bytes=nbytes + 4 * n * a + 4 * e * a)


def phase_kernels(graph, results: dict) -> None:
    """Hold every kernel to its plain version at the slice's shapes."""
    import torch

    from graphax_torch.kernels import spmm as spmm_mod

    n, e = graph.num_nodes, graph.num_edges
    d = 162
    gen = torch.Generator(device="cuda").manual_seed(0)
    csr, csc = graph.csr, graph.csc
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        x = torch.randn(n, d, generator=gen, device="cuda").to(dt)
        g = torch.randn(n, d, generator=gen, device="cuda").to(dt)
        w = graph.edge_weight.to(dt).contiguous()
        w_t = spmm_mod.transpose_values(graph, w)

        # spmm_csr: A x and A^T g
        for label, lay, vals, inp in (("A.x", csr, w, x), ("AT.g", csc, w_t, g)):
            lib = None
            try:
                sp = torch.sparse_csr_tensor(lay.ptr.long(), lay.idx.long(),
                                             vals[:e], size=(n, n))
                lib = ("torch.sparse.mm", lambda: torch.sparse.mm(sp, inp))
            except (RuntimeError, NotImplementedError) as exc:
                lib_err = str(exc).splitlines()[0][:120]
            row = dict(kernel="spmm_csr", product=label, dtype=name,
                       **spmm_shape(inp))
            if lib is None:
                row["library_error"] = lib_err
            spmm_check(results, row, lay, vals, inp, n, lib)

        # a view that starts one value past a load boundary: one value per
        # gathered load
        xv = torch.empty(n * d + 1, dtype=dt, device="cuda")[1:].view(n, d)
        xv.copy_(x)
        spmm_check(results, dict(kernel="spmm_csr", product="A.x view",
                                 dtype=name, **spmm_shape(xv)),
                   csr, w, xv, n, timed=False)
        del xv

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

        # sddmm, beside the sampled product of the same slots
        lib = None
        try:
            mask = torch.sparse_csr_tensor(csr.ptr.long(), csr.idx.long(),
                                           torch.zeros(e, dtype=dt,
                                                       device="cuda"),
                                           size=(n, n))
            lib = ("torch.sparse.sampled_addmm",
                   lambda: torch.sparse.sampled_addmm(mask, g, x.t(),
                                                      beta=0.0))
        except (RuntimeError, NotImplementedError):
            pass
        sddmm_check(results, csr, g, x, lib=lib)

        # attention_pin: every score type, reweight on and off, on the
        # arxiv CSR and on a small graph with empty rows
        pin_checks(results, "arxiv CSR", graph, gen, dt)
        pin_checks(results, "small", _nl_small_graph("cuda"), gen, dt,
                   timed=False)
        if dt == torch.float32:   # wide rows: the f32 K projection's range
            pin_checks(results, "D400 A120", graph, gen, dt, d=400, a=120,
                       heads=4, att_types=("scaled_dot",))
        del x, g
        torch.cuda.empty_cache()


def phase_windowed_kernels(graph, results: dict) -> None:
    """Hold the windowed layout's four kernels, and spmm_csr on its
    residual edges, to their plain versions at the slice's shapes (the
    reordered arxiv graph's layout) and at a small odd shape, in f32 and
    bf16, and the win_matmul Function's gradients."""
    import numpy as np
    import torch

    from graphax_torch.kernels import spmm as spmm_mod
    from graphax_torch.kernels import windowed_spmm as ws
    from graphax_torch.kernels.dispatch import attach_windows
    from graphax_torch.sparse.graph import Graph

    rng = np.random.RandomState(1)
    n_s = 301                       # small odd shape: tile 8, W 16, D 5
    row = rng.randint(0, n_s, 3000)
    col = np.clip(row // 16 * 16 + rng.randint(-4, 20, 3000), 0, n_s - 1)
    key = np.unique(row * n_s + col)
    small = attach_windows(Graph.from_edges(
        key // n_s, key % n_s, n_s, rng.rand(len(key)) + 0.1,
        edge_buffer_size=len(key) + 3, device="cuda"), window=16, tile=8)
    gen = torch.Generator(device="cuda").manual_seed(2)
    for shape, g, d in (("slice", graph, 162), ("small_odd", small, 5)):
        wl = g.windows
        n = g.num_nodes
        t_, tile, w_, wn = wl.num_tiles, wl.tile, wl.window, wl.num_windows
        cells = t_ * tile * w_
        per_win = (wl.win_ptr[1:] - wl.win_ptr[:-1]).float()
        emit({"phase": "kernels", "layout": shape, "T": t_, "tile": tile,
              "W": w_, "Wn": wn, "D": d, "in_window": wl.in_window_edges,
              "residual": wl.residual.num_slots,
              "tiles_per_window_max": int(per_win.max()),
              "tiles_per_window_mean": float(per_win.mean())})
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).replace("torch.", "")
            b = torch.finfo(dt).bits // 8
            timed = shape == "slice"
            x = torch.randn(n, d, generator=gen, device="cuda").to(dt)
            gr = torch.randn(n, d, generator=gen, device="cuda").to(dt)
            vals = torch.rand(g.edge_buffer_size, generator=gen,
                              device="cuda")          # f32, as the pin's

            def run(kernel, fn, plain, tol, nbytes, ops, lib=None,
                    product=None, **extra):
                row = dict(kernel=kernel, layout=shape, dtype=name, **extra)
                if product is not None:
                    row["product"] = product
                return hold_to_plain(results, row, fn, plain, tol, nbytes,
                                     ops, lib, timed=timed, tag=product)

            # spmm_csr on the residual edges, as the main path calls it:
            # their values gathered into the CSR and CSC slot orders
            vt = vals.to(dt)
            res = {}
            for label, lay, inp in (("residual A.x", wl.residual, x),
                                    ("residual AT.g", wl.residual_t, gr)):
                rv = vt[lay.perm].contiguous()
                sp = torch.sparse_csr_tensor(lay.ptr.long(), lay.idx.long(),
                                             rv, size=(n, n))
                res[label] = spmm_check(
                    results, dict(kernel="spmm_csr", layout=shape,
                                  dtype=name, product=label,
                                  **spmm_shape(inp)),
                    lay, rv, inp, n, ("torch.sparse.mm",
                                      lambda: torch.sparse.mm(sp, inp)),
                    timed=timed)
                del sp

            dense = run("windowed_densify",
                        lambda: ws.densify(wl, vals, dt),
                        lambda: ws.densify_plain(wl, vals, dt), TOL_EXACT,
                        wl.in_window_edges * 12 + cells * b, 0.0)
            flops = 2.0 * cells * d
            slab_g = ws._slab(x, wl)[wl.tile_win.long()].contiguous()
            # as the main path calls it: the residual SpMM's result added
            # in the epilogue, one rounding to the state dtype
            addend = res["residual A.x"]
            add_t = ws._tiles(addend, wl)
            run("win_matmul",
                lambda: ws.win_matmul(wl, dense, x, addend),
                lambda: ws.win_matmul_plain(wl, dense, x, addend),
                TOL_WIN if dt == torch.float32 else TOL["bfloat16"],
                cells * b + 3 * n * d * b, flops,
                ("torch.baddbmm on the pre-gathered slab",
                 lambda: torch.baddbmm(add_t, dense, slab_g)),
                staging=ws.matmul_staging(dense, x, addend))
            del add_t
            g_t = ws._tiles(gr, wl)
            # f32 output (graphax's), then bf16 (the path's: the blocks'
            # dtype, one rounding of the same f32 sums, no cast pass)
            f32_out = run(
                "win_bwd_dense", lambda: ws.win_bwd_dense(wl, gr, x),
                lambda: ws.win_bwd_dense_plain(wl, gr, x), TOL_WIN,
                2 * n * d * b + cells * 4, flops,
                ("torch.bmm out_dtype=float32 on the pre-gathered slab",
                 lambda: torch.bmm(g_t, slab_g.transpose(1, 2),
                                   out_dtype=torch.float32)),
                staging=ws.bwd_dense_staging(gr, x))
            b16_out = run(
                "win_bwd_dense",
                lambda: ws.win_bwd_dense(wl, gr, x, torch.bfloat16),
                lambda: ws.win_bwd_dense_plain(wl, gr, x, torch.bfloat16),
                TOL["bfloat16"], 2 * n * d * b + cells * 2, flops,
                ("torch.bmm on the pre-gathered slab (f32 sums, bf16 "
                 "output)", lambda: torch.bmm(g_t, slab_g.transpose(1, 2)))
                if dt == torch.bfloat16 else None, product="bf16_out",
                staging=ws.bwd_dense_staging(gr, x))
            same = bool(torch.equal(b16_out, f32_out.to(torch.bfloat16)))
            emit({"phase": "kernels", "kernel": "win_bwd_dense",
                  "layout": shape, "dtype": name,
                  "bf16_out_equals_f32_out_cast": same})
            check(same, f"win_bwd_dense {shape} {name}: the bf16 output is "
                  "not the f32 output cast")
            del f32_out, b16_out
            # f32 output, then the output in x's dtype (the path's: the
            # first N slab rows rounded once, no f32 slab, no cast pass)
            f32_out = run("win_bwd_slab",
                          lambda: ws.win_bwd_slab(wl, dense, gr),
                          lambda: ws.win_bwd_slab_plain(wl, dense, gr),
                          TOL_WIN, cells * b + n * d * b + n * d * 4, flops,
                          staging=ws.slab_staging(dense, gr))
            if dt == torch.bfloat16:
                b16_out = run(
                    "win_bwd_slab",
                    lambda: ws.win_bwd_slab(wl, dense, gr, dt),
                    lambda: ws.win_bwd_slab_plain(wl, dense, gr, dt),
                    TOL["bfloat16"], cells * b + 2 * n * d * b, flops,
                    product="bf16_out")
                same = bool(torch.equal(b16_out, f32_out.to(dt)))
                emit({"phase": "kernels", "kernel": "win_bwd_slab",
                      "layout": shape, "dtype": name,
                      "bf16_out_equals_f32_out_cast": same})
                check(same, f"win_bwd_slab {shape} {name}: the bf16 output "
                      "is not the f32 output cast")
                del b16_out
            if timed:   # the same function in two PyTorch calls
                tw = wl.tile_win.long()
                row_ = results[("win_bwd_slab", name)]
                row_["two_calls"] = "torch.bmm + index_add_ (f32 slab)"
                row_["two_calls_ms"] = time_ms(
                    lambda: torch.zeros(wn, w_, d, device="cuda").index_add_(
                        0, tw, torch.bmm(dense.transpose(1, 2), g_t,
                                         out_dtype=torch.float32)), reps=5)
            del f32_out, slab_g, g_t

            # the Function's dx and d_dense against the plain products
            dr = dense.clone().requires_grad_(True)
            xr = x.clone().requires_grad_(True)
            probe = torch.randn(n, d, generator=gen, device="cuda")
            pc = probe.to(dt)
            out_ = ws._WinMatmul.apply(dr, xr, wl, addend)
            casts, slab_casts, rows_casts = block_casts(
                lambda: out_.backward(pc), wl.block_shape, (wn * w_, d),
                (n, d))
            check(casts == 0, f"win_matmul backward {shape} {name}: "
                  f"{casts} casts of a [T, tile, W] block")
            check(slab_casts == rows_casts == 0,
                  f"win_matmul backward {shape} {name}: {slab_casts} casts "
                  f"of a [Wn W, D] slab, {rows_casts} of its [N, D] rows")
            tol = TOL_WIN if dt == torch.float32 else TOL["bfloat16"]
            cx = compare(xr.grad, ws.win_bwd_slab_plain(wl, dense, pc, dt),
                         tol)
            cd = compare(dr.grad, ws.win_bwd_dense_plain(wl, pc, x).to(dt),
                         tol)
            emit({"phase": "kernels", "kernel": "win_matmul (autograd)",
                  "layout": shape, "dtype": name, "dx": cx, "d_dense": cd,
                  "block_casts_in_backward": casts,
                  "slab_casts_in_backward": slab_casts + rows_casts})
            check(cx["ok"] and cd["ok"],
                  f"win_matmul gradients {shape} {name} disagree")
            del x, gr, dense, dr, xr, probe, addend, res
            torch.cuda.empty_cache()

    # a window that no tile maps: its slab rows read zero, in both outputs
    wl = _empty_window_graph("cuda").windows
    n, w_ = wl.num_nodes, wl.window
    check(1 not in set(wl.tile_win.tolist()), "window 1 has a tile")
    vals = torch.rand(n * 12, generator=gen, device="cuda") + 0.1
    for dt in (torch.float32, torch.bfloat16):
        dense = ws.densify(wl, vals, dt)
        gr = torch.randn(n, 162, generator=gen, device="cuda").to(dt)
        f32_out = ws.win_bwd_slab(wl, dense, gr)
        c = compare(f32_out, ws.win_bwd_slab_plain(wl, dense, gr), TOL_WIN)
        out_dt = ws.win_bwd_slab(wl, dense, gr, dt)
        zero = not (f32_out[w_:2 * w_].any() or out_dt[w_:2 * w_].any())
        same = bool(torch.equal(out_dt, f32_out.to(dt)))
        emit({"phase": "kernels", "kernel": "win_bwd_slab",
              "layout": "empty window", "dtype": str(dt)[6:], **c,
              "empty_window_zero": zero, "x_dtype_out_equals_f32_cast": same})
        check(c["ok"] and zero and same,
              f"win_bwd_slab on a layout with an empty window, {dt}")


def _empty_window_graph(device, n=301, tile=8, window=32, seed=6):
    """Communities of one window each plus random edges, except that the
    rows of window 1 take their columns from window 0: no tile maps
    window 1. N off the tile; windowed layout of tile 8, W 32."""
    import numpy as np

    from graphax_torch.kernels.dispatch import attach_windows
    from graphax_torch.sparse.graph import Graph

    rng = np.random.RandomState(seed)
    e = 10 * n
    row = rng.randint(0, n, e)
    home = np.where(row // window == 1, 0, row // window)
    col = np.clip(home * window + rng.randint(0, window, e), 0, n - 1)
    key = np.unique(row * n + col)
    return attach_windows(Graph.from_edges(
        key // n, key % n, n, rng.rand(len(key)) + 0.1,
        edge_buffer_size=n * 12, device=device), window=window, tile=tile)


def randomize_attention(att, seed: int) -> None:
    """Random Q/K at graphax's test scale (0.3 randn weights, 0.1 randn
    biases) from a seeded CPU generator: the constant 1e-5 init makes the
    attention uniform and would check nothing."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for lin in (att.Q, att.K):
            lin.weight.copy_(0.3 * torch.randn(lin.weight.shape,
                                               generator=gen))
            lin.bias.copy_(0.1 * torch.randn(lin.bias.shape, generator=gen))


def phase_kproj_kernels(dense: dict, results: dict) -> None:
    """The f32 K projection (the pin's on the windowed arxiv preset and on
    Computers and Photo) against its plain version within TOL_KPROJ on
    random x, Wk, bk from a seed: at the arxiv widths (N 169,343, D 162, A
    32), Computers' and Photo's (their stand-ins' N, the presets' hidden
    and attention widths), D 400, A 120 at arxiv's N (operations-bound),
    each timed beside its bound and ``addmm(out_dtype=float32)``; then
    untimed odd D (161), a view of x one value in, and N = 1,001 (off the
    128-row tile), each with the copy bytes it stages by."""
    import torch

    from graphax_torch.kernels import fused_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(21)
    n_ax = 169_343
    shapes = [("arxiv", n_ax, 162, 32, True)]
    for name, (d_, tr_) in dense.items():
        shapes.append((name, d_.num_nodes, tr_.cfg.hidden_dim,
                       tr_.cfg.attention_dim, True))
    shapes += [("D400 A120", n_ax, 400, 120, True),
               ("odd D", n_ax, 161, 32, False),
               ("view", n_ax, 162, 32, False),
               ("N 1001", 1001, 162, 32, False)]
    with torch.no_grad():
        for tag, n, d, a, timed in shapes:
            x = torch.randn(n, d, generator=gen, device="cuda")
            if tag == "view":
                buf = torch.empty(n * d + 1, device="cuda")
                buf[1:].copy_(x.view(-1))
                x = buf[1:].view(n, d)
            wk = torch.randn(d, a, generator=gen, device="cuda") / d ** 0.5
            bk = 0.1 * torch.randn(a, generator=gen, device="cuda")
            hold_to_plain(
                results, dict(kernel="attention_kproj", dtype="float32",
                              shape=tag, N=n, D=d, A=a,
                              route=fa.kproj_route(x.dtype, d, a),
                              copy_bytes=[fa.kproj_copy_bytes(x),
                                          fa.kproj_copy_bytes(wk)]),
                lambda: fa.attention_kproj(x, wk, bk),
                lambda: fa.attention_kproj_plain(x, wk, bk), TOL_KPROJ,
                4 * (n * d + d * a + a + n * a), 2.0 * n * d * a,
                ("torch.addmm out_dtype=float32",
                 lambda: torch.addmm(bk, x, wk, out_dtype=torch.float32)),
                timed=timed, tag=tag)
            del x, wk, bk
    torch.cuda.empty_cache()


def _nl_small_graph(device):
    """300 nodes, duplicate edges, the last 7 rows without an edge, padded
    edge buffer."""
    import numpy as np

    from graphax_torch.sparse.graph import Graph

    rng = np.random.RandomState(5)
    n, e = 300, 2500
    row, col = rng.randint(0, n - 7, e), rng.randint(0, n - 7, e)
    row[:50], col[:50] = row[50:100], col[50:100]
    order = np.lexsort((col, row))
    return Graph.from_edges(row[order], col[order], n,
                            edge_weight=rng.rand(e).astype(np.float32) + 0.1,
                            edge_buffer_size=e + 11, device=device)


def phase_flash_kernels(trainer, results: dict) -> None:
    """GRAND-nl's three kernels against their plain versions at the slice's
    shapes: the arxiv CSR and the model's own q, Wk and bk on its encoded
    state (random Q/K); kproj and softmax flash in f32 and bf16, gmax and
    squareplus flash in bf16 (the path's dtype). Then a small graph with
    empty rows over every score type, reweight and squareplus in both
    dtypes."""
    import torch

    from graphax_torch.kernels import fused_attention as fa

    g, cfg = trainer.data.graph, trainer.cfg
    att = trainer.model.block.func.att
    n, e = g.num_nodes, g.num_edges
    trainer.model.eval()
    with torch.no_grad():
        x_enc = trainer.model.encode(trainer.data.x, train=False)
    d, a, heads = x_enc.shape[1], cfg.attention_dim, cfg.heads
    emit({"phase": "kernels", "path": "grand_nl", "N": n, "E": e, "D": d,
          "A": a, "H": heads, "att_type": cfg.attention_type})
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        b = torch.finfo(dt).bits // 8
        x = x_enc.to(dt).contiguous()
        with torch.no_grad():
            p = fa.prep_inputs(cfg, att, g, x)
        q, wk, bk = p["q"], p["wk"], p["bk"]
        scal = (cfg.attention_type, heads, p["ov2"], p["inv2l2"])
        csr_bytes = 4 * e + 4 * (n + 1)

        def run(kernel, fn, plain, tol, nbytes, ops, lib=None, variant=None,
                miss_bytes=None):
            row = dict(kernel=kernel, path="grand_nl", dtype=name)
            if variant is not None:
                row["variant"] = variant
            return hold_to_plain(results, row, fn, plain, tol, nbytes, ops,
                                 lib, tag=variant, miss_bytes=miss_bytes)

        with torch.no_grad():
            kt = run("attention_kproj", lambda: fa.attention_kproj(x, wk, bk),
                     lambda: fa.attention_kproj_plain(x, wk, bk), TOL_KPROJ,
                     n * d * b + d * a * b + 4 * a + 4 * n * a,
                     2.0 * n * d * a,
                     ("torch.addmm out_dtype=float32",
                      lambda: torch.addmm(bk, x, wk,
                                          out_dtype=torch.float32)))
            # per edge: the scores (2A) and, per head, the weighted sum (2D)
            ops = e * (2.0 * a + 2.0 * heads * d)
            nbytes = (n * a * b + 4 * n * a + n * d * b + csr_bytes
                      + 4 * n * d)
            fn_bytes = (n * d * b + n * a * b + csr_bytes + n * d * b
                        + d * a * b + 4 * a)
            fn_ops = 2.0 * n * d * a + ops
            # the all-miss count: x gathered once per edge
            miss = nbytes - n * d * b + e * d * b
            variants = [None] if dt == torch.float32 else [
                None, "squareplus", "bf16_out"]
            for variant in variants:
                gshift = None
                if variant == "squareplus":
                    gshift = run(
                        "attention_gmax",
                        lambda: fa.attention_gmax(g.csr, q, kt, None, *scal),
                        lambda: fa.attention_gmax_plain(g.csr, q, kt, None,
                                                        *scal),
                        TOL_GMAX, n * a * b + 4 * n * a + csr_bytes + 4,
                        e * 2.0 * a)
                # bf16_out: the output in x's dtype, as flash_attention_ax
                # asks for it (2 bytes a value written instead of 4)
                od = dt if variant == "bf16_out" else torch.float32
                less = (4 - od.itemsize) * n * d
                got = run("flash_attention",
                          lambda: fa.flash_attention(g.csr, q, x, kt, None,
                                                     gshift, *scal,
                                                     out_dtype=od),
                          lambda: fa.flash_attention_plain(
                              g.csr, q, x, kt, None, gshift, *scal,
                              out_dtype=od),
                          TOL_FLASH[name], nbytes - less, ops,
                          variant=variant, miss_bytes=miss - less)
                if variant == "bf16_out":
                    f32 = fa.flash_attention(g.csr, q, x, kt, None, None,
                                             *scal)
                    check(torch.equal(got, f32.to(dt)),
                          "flash_attention: the bf16 output is not its f32 "
                          "output cast once")
            # the whole operator as the RHS calls it (kproj + flash, the
            # softmax config), beside the bound of that function
            fcfg = cfg.replace(square_plus=False)
            row = results[("flash_attention", name)]
            row["function_ms"] = time_ms(
                lambda: fa.flash_attention_ax(fcfg, att, g, x))
            row["function_bound_ms"], row["function_bound_by"] = bound_ms(
                fn_bytes, fn_ops, name)
            emit({"phase": "kernels", "kernel": "flash_attention_ax",
                  "dtype": name, "ms": row["function_ms"],
                  "bound_ms": row["function_bound_ms"],
                  "bound_by": row["function_bound_by"],
                  "bytes": fn_bytes, "ops": fn_ops})
            del kt, q, x
        torch.cuda.empty_cache()

    # a small graph with empty rows, every score type, reweight, squareplus
    small = _nl_small_graph("cuda")
    gen = torch.Generator(device="cuda").manual_seed(8)
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        x = torch.randn(small.num_nodes, 162, generator=gen,
                        device="cuda").to(dt)
        wk = (0.1 * torch.randn(162, 32, generator=gen, device="cuda")).to(dt)
        bk = 0.1 * torch.randn(32, generator=gen, device="cuda")
        q = (0.3 * torch.randn(small.num_nodes, 32, generator=gen,
                               device="cuda")).to(dt)
        with torch.no_grad():
            kt = fa.attention_kproj(x, wk, bk)
            for att_type in ("scaled_dot", "cosine_sim", "pearson",
                             "exp_kernel"):
                for ew in (None, small.edge_weight):
                    for sqp in (False, True):
                        scal = (att_type, 2, 1.3, 0.7)
                        gs = None
                        if sqp:
                            gs = fa.attention_gmax(small.csr, q, kt, ew, *scal)
                            cg = compare(gs, fa.attention_gmax_plain(
                                small.csr, q, kt, ew, *scal), TOL_GMAX)
                            check(cg["ok"], f"gmax small {att_type} {name}")
                        got = fa.flash_attention(small.csr, q, x, kt, ew, gs,
                                                 *scal)
                        c = compare(got, fa.flash_attention_plain(
                            small.csr, q, x, kt, ew, gs, *scal),
                            TOL_FLASH[name])
                        check(c["ok"] and bool((got[-7:] == 0).all()),
                              f"flash small {att_type} rw={ew is not None} "
                              f"sqp={sqp} {name} disagrees with plain")
                        worst[name] = max(worst.get(name, 0.0),
                                          c["max_abs_err"])
    emit({"phase": "kernels", "kernel": "flash_attention", "graph": "small",
          "cases": 32, "max_abs_err": worst, "ok": True})


def _nl_train_graph(device):
    """300 nodes: duplicate edges, one row with one edge (292), the last 7
    rows and columns without an edge, padded edge buffer."""
    import numpy as np

    from graphax_torch.sparse.graph import Graph

    rng = np.random.RandomState(6)
    n, e = 300, 2500
    row, col = rng.randint(0, n - 8, e), rng.randint(0, n - 7, e)
    row[:50], col[:50] = row[50:100], col[50:100]
    row, col = np.r_[row, n - 8], np.r_[col, 3]
    order = np.lexsort((col, row))
    return Graph.from_edges(row[order], col[order], n,
                            edge_buffer_size=e + 12, device=device)


def train_kernel_checks(results: dict, graph, q, x, kt, cot, heads: int,
                        name: str, timed: bool, label=None) -> tuple:
    """The three training kernels against their plain versions on one
    input set (the backward kernels on the kernel forward's residuals),
    with the bound of each at these inputs and its all-miss count (the row
    kernels: x and K gathered per edge; B3: g, q and the row tables
    gathered per slot). ``label`` names a graph other than the slice's, one
    with rows or columns of thousands of edges: its timed rows are kept
    under that tag, and B3's tolerances add :func:`b3_order_bound` to their
    atol. On the ``hub`` graph, whose CSR rows hold thousands of edges,
    the row backward's add :func:`rows_order_bound`; on every other graph
    it keeps TOL_TRAIN (the forward keeps TOL_TRAIN and tol_rounded
    everywhere). Returns the kernels' outputs (out, dq, dk, dxv)."""
    from graphax_torch.kernels import fused_attention as fa

    n, d = x.shape
    a, e = q.shape[1], graph.num_edges
    b = x.element_size()
    idx_bytes = 4 * e + 4 * (n + 1)
    tabs = 4 * n * heads                      # one [N, H] f32 table
    # x and K gathered once per edge instead of once
    row_miss = e * (d * b + 4 * a) - n * d * b - 4 * n * a
    row = lambda k: dict(kernel=k, path="grand_nl_train", dtype=name,
                         graph=label or ("slice" if timed else "small"))
    fr_bytes = (2 * n * d * b + n * a * b + 4 * n * a + idx_bytes
                + 4 * e * heads + 2 * tabs)
    out, sc, shift, denom = hold_to_plain(
        results, row("attention_fwd_res"),
        lambda: fa.attention_fwd_res(graph.csr, q, x, kt, heads),
        lambda: fa.attention_fwd_res_plain(graph.csr, q, x, kt, heads),
        (("out", tol_rounded(name, x)), ("scores", TOL_TRAIN),
         ("shift", TOL_TRAIN),
         ("denom", TOL_TRAIN)),
        # x, q, K, CSR in; out, scores, shift, denom out
        fr_bytes,
        # per edge: scores (2A), exp and the head mean (~4H), x * w and
        # its sum (2D)
        e * (2.0 * a + 4.0 * heads + 2.0 * d), timed=timed, tag=label,
        miss_bytes=fr_bytes + row_miss)
    # scores, shift, denom, g, x, K, CSR in; dq, rho out
    br_bytes = (4 * e * heads + 2 * tabs + 2 * n * d * b + 4 * n * a
                + idx_bytes + 4 * n * a + tabs)
    tq, tr = TOL_TRAIN, TOL_TRAIN
    if label == "hub":   # CSR rows of thousands of edges
        bq, br = rows_order_bound(graph.csr, sc, shift, denom, cot, x, kt,
                                  heads)
        tq, tr = (tq[0] + bq, tq[1]), (tr[0] + br, tr[1])
    dq, rho = hold_to_plain(
        results, row("attention_bwd_rows"),
        lambda: fa.attention_bwd_rows(graph.csr, sc, shift, denom, cot, x, kt,
                                      heads),
        lambda: fa.attention_bwd_rows_plain(graph.csr, sc, shift, denom, cot,
                                            x, kt, heads),
        (("dq", tq), ("rho", tr)), br_bytes,
        # per edge: da (2D), alpha and rho (~6H), ds and dq (~2H + 2A)
        e * (2.0 * d + 8.0 * heads + 2.0 * a), timed=timed, tag=label,
        miss_bytes=br_bytes + row_miss)
    # q, g, x, K, shift, denom, rho, CSC in; dk, dxv out
    b3_bytes = (n * a * b + 2 * n * d * b + 4 * n * a + 3 * tabs + idx_bytes
                + 4 * n * a + 4 * n * d)
    tk, tv = TOL_TRAIN, tol_rounded(name, cot)
    if label is not None:   # columns of thousands of slots
        bk, bv = b3_order_bound(graph.csc, q, cot, x, kt, shift, denom, rho,
                                heads)
        tk, tv = (tk[0] + bk, tk[1]), (tv[0] + bv, tv[1])
    dk, dxv = hold_to_plain(
        results, row("attention_bwd_cols"),
        lambda: fa.attention_bwd_cols(graph.csc, q, cot, x, kt, shift, denom,
                                      rho, heads),
        lambda: fa.attention_bwd_cols_plain(graph.csc, q, cot, x, kt, shift,
                                            denom, rho, heads),
        (("dk", tk), ("dxv", tv)), b3_bytes,
        # per slot: s (2A), alpha (~4H), da and dxv (4D), dk (~2A)
        e * (4.0 * a + 4.0 * heads + 4.0 * d), timed=timed, tag=label,
        miss_bytes=b3_bytes - n * d * b - n * a * b - 3 * tabs
        + e * (d * b + a * b + 12 * heads))
    return out, dq, dk, dxv


def rows_order_bound(csr, sc, shift, denom, g, x, kt, heads: int):
    """``(dq, rho)`` bounds [N, A], [N, H] of how far the row backward's
    f32 row sums may move with their order, as :func:`b3_order_bound`'s:
    per entry 2 sqrt(deg) 2^-24 sum|term| over the row's edges (rho's
    terms alpha da / H, dq's ds_h K), and for dq also rho's bound carried
    by ds = alpha (da / H - rho), times sum alpha |K| (from the plain
    version's alpha, da and rho). The kernel sums a long row in segments
    of 32, the plain version's index_add_ in its atomics' order."""
    import torch

    n, seg, col = csr.num_rows, csr.seg, csr.idx.long()
    e, a = csr.num_slots, kt.shape[1]
    dn = denom[seg]
    alpha = torch.exp(sc - shift[seg]) / torch.where(dn > 0, dn,
                                                     torch.ones_like(dn))
    dah = ((g.float()[seg] * x.float()[col]).sum(1) / heads)[:, None]
    scale = (2.0 * 2.0 ** -24
             * (csr.ptr[1:] - csr.ptr[:-1]).float().sqrt()[:, None])
    rows = lambda t: torch.zeros(  # noqa: E731
        (n,) + t.shape[1:], device=x.device).index_add_(0, seg, t)
    rho = rows(alpha * dah)
    b_rho = scale * rows((alpha * dah).abs())
    kh = kt[col].reshape(e, heads, a // heads)
    ds = alpha * (dah - rho[seg])
    b_dq = (scale * rows((kh * ds[:, :, None]).abs().reshape(e, a))
            + rows((kh.abs() * alpha[:, :, None]).reshape(e, a))
            * b_rho.repeat_interleave(a // heads, 1))
    return b_dq, b_rho


def b3_order_bound(csc, q, g, x, kt, shift, denom, rho, heads: int):
    """``(dk, dxv)`` bounds [N, A], [N, D] of how far B3's f32 column sums
    may move with their order, as spmm_check's long rows: per entry 2
    sqrt(deg) 2^-24 sum|term| over the column's slots (terms ds_h q[r]_h
    and rnd(g[r] w), from the plain version's alpha). The kernel sums a
    long column in segments of 32, the plain version's index_add_ in its
    atomics' order."""
    import torch

    from graphax_torch.kernels import fused_attention as fa

    n, a, d = x.shape[0], kt.shape[1], x.shape[1]
    c, r = csc.seg, csc.idx.long()
    e, dkh = csc.num_slots, a // heads
    qe = q.float()[r].reshape(e, heads, dkh)
    s = fa.score_math("scaled_dot", qe, kt[c].reshape(e, heads, dkh))
    alpha = torch.exp(s - shift[r]) / torch.where(denom[r] > 0, denom[r],
                                                  torch.ones_like(denom[r]))
    da = (g.float()[r] * x.float()[c]).sum(1)
    ds = alpha * ((da / heads)[:, None] - rho[r])
    mk = torch.zeros(n, a, device=x.device).index_add_(
        0, c, (qe * ds[:, :, None]).abs().reshape(e, a))
    w = (alpha.sum(1) / heads).to(g.dtype)
    mv = torch.zeros(n, d, device=x.device).index_add_(
        0, c, (g[r] * w[:, None]).float().abs())
    scale = 2.0 * 2.0 ** -24 * (csc.ptr[1:] - csc.ptr[:-1]).float().sqrt()
    return scale[:, None] * mk, scale[:, None] * mv


def phase_train_kernels(trainer, results: dict) -> None:
    """GRAND-nl's training kernels against their plain versions at the
    slice's shapes: the arxiv CSR and CSC, the model's own q, Wk and bk on
    its encoded state (random Q/K), a cotangent from a seed, f32 and bf16;
    the same on :func:`hub_graph` (rows of thousands of edges) and on its
    transpose (columns of thousands of slots), each under its tag.
    Then the autograd route's output and gradients of x, Q and K against
    torch.autograd through the plain per-edge path (f32), and a small graph
    with duplicate edges, a one-edge row and empty rows in both dtypes."""
    import torch

    from graphax_torch.functions.transformer import (
        multiply_attention, transformer_attention_apply,
    )
    from graphax_torch.kernels import fused_attention as fa

    g, cfg = trainer.data.graph, trainer.cfg
    att = trainer.model.block.func.att
    n, heads = g.num_nodes, cfg.heads
    trainer.model.eval()
    with torch.no_grad():
        x_enc = trainer.model.encode(trainer.data.x, train=False)
    d = x_enc.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(12)
    cot = torch.randn(n, d, generator=gen, device="cuda")
    hub_t = hub_graph("cuda", transpose=True)
    emit({"phase": "kernels", "graph": "hub transposed", "columns":
          degree_shares(hub_t.csc.ptr, (fa._BATCH,))})
    hub = hub_graph("cuda")
    emit({"phase": "kernels", "graph": "hub", "rows":
          degree_shares(hub.csr.ptr, (fa._BATCH, fa.ROW_SPLIT))})
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        x = x_enc.to(dt).contiguous()
        with torch.no_grad():
            p = fa.prep_inputs(cfg, att, g, x)
            kt = fa.attention_kproj(x, p["wk"], p["bk"])
            train_kernel_checks(results, g, p["q"], x, kt,
                                cot.to(dt).contiguous(), heads, name, True)
            # the transposed hub graph: its CSC holds columns of 2,000 to
            # 13,000 slots, which B3 walks in segments; the hub graph
            # itself: its CSR holds rows of as many edges, which the
            # forward and the row backward walk in segments
            for gg, tag in ((hub_t, "hub transposed"), (hub, "hub")):
                train_kernel_checks(results, gg, p["q"], x, kt,
                                    cot.to(dt).contiguous(), heads, name,
                                    True, label=tag)
        del x, kt, p
        torch.cuda.empty_cache()
    del hub_t, hub

    # the autograd route against autograd through the plain per-edge path
    lin = (att.Q.weight, att.Q.bias, att.K.weight, att.K.bias)
    probe = torch.randn(n, d, generator=gen, device="cuda")

    def grads(fn):
        xr = x_enc.float().clone().requires_grad_(True)
        for t in lin:
            t.grad = None
        out = fn(xr)
        (out * probe).sum().backward()
        return [out.detach(), xr.grad] + [t.grad.clone() for t in lin]

    got = grads(lambda xr: fa.fused_attention_ax(cfg, att, g, xr))

    def plain(xr):
        alpha, (v, _) = transformer_attention_apply(att, cfg, g, xr)
        return multiply_attention(att, cfg, g, xr, alpha, v)

    want = grads(plain)
    for t in lin:
        t.grad = None
    # a bias's scale is its weight's: dKb is 0 but for rounding (the
    # softmax does not see a shift of every score of a row)
    top = [float(t.abs().max()) for t in want]
    scale = top[:2] + [max(top[2:4])] * 2 + [max(top[4:])] * 2
    cs = {label: compare(a_, b_, (GRAD_ATOL_OF_MAX * sc_, GRAD_RTOL))
          for label, a_, b_, sc_ in zip(("out", "dx", "dQw", "dQb", "dKw",
                                         "dKb"), got, want, scale)}
    del got, want
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "fused_attention_ax (autograd)",
          "path": "grand_nl_train", "dtype": "float32", "against":
          "torch.autograd through transformer_attention_apply + "
          "multiply_attention", **cs})
    check(all(c["ok"] for c in cs.values()),
          "the autograd route's gradients disagree with the plain path's")

    # a small graph: duplicate edges, a one-edge row, empty rows
    small = _nl_train_graph("cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        mk = lambda *shape, s=1.0: (s * torch.randn(
            *shape, generator=gen, device="cuda")).to(dt)
        x, q, cot_s = mk(300, 162), mk(300, 32, s=0.3), mk(300, 162)
        kt = 0.3 * torch.randn(300, 32, generator=gen, device="cuda")
        outs = train_kernel_checks(results, small, q, x, kt, cot_s, 2, name,
                                   False)
        check(all(bool((t[-7:] == 0).all()) for t in outs),
              f"training kernels small {name}: an empty row is not 0")
        check(int((outs[0][292].float() != 0).sum()) > 0,
              f"training kernels small {name}: the one-edge row is 0")


def _community_graph(device, n=300, window=32, tile=8, seed=0):
    """Communities of one window (tile 8, W 32): tile 0 without a residual
    edge, rows 20 and 21 without an in-window edge, the last 3 rows without
    an edge, padded edge buffer."""
    import numpy as np

    from graphax_torch.kernels.dispatch import attach_windows
    from graphax_torch.sparse.graph import Graph

    rng = np.random.RandomState(seed)
    comm = np.arange(n) // window
    same = comm[:, None] == comm[None, :]
    hit = rng.rand(n, n) < np.where(same, 0.3, 0.02)
    hit[:tile] &= same[:tile]
    hit[20:22] &= ~same[20:22]
    hit[20, n - 9] = hit[21, 100] = True
    hit[n - 3:] = False
    row, col = np.nonzero(hit)
    g = Graph.from_edges(row, col, n,
                         edge_weight=rng.rand(len(row)).astype(np.float32)
                         + 0.2, edge_buffer_size=len(row) + 5, device=device)
    return attach_windows(g, window=window, tile=tile)


def _long_row_graph(device, n=1100, window=512, tile=8, seed=20):
    """Communities of one window of 512 (the last one short), tiles of 8:
    in-window rows of 33, 200 and 512 cells (row 7 its whole window), rows
    30 and 31 with out-of-window edges only, the last 5 rows without an
    edge, about 5 cells on the other rows; padded edge buffer."""
    import numpy as np

    from graphax_torch.kernels.dispatch import attach_windows
    from graphax_torch.sparse.graph import Graph

    rng = np.random.RandomState(seed)
    comm = np.arange(n) // window
    same = comm[:, None] == comm[None, :]
    hit = rng.rand(n, n) < np.where(same, 5.0 / window, 0.002)
    for r, cells in ((3, 33), (600, 200), (7, window)):
        hit[r] &= ~same[r]
        hit[r, comm[r] * window + rng.choice(window, cells, replace=False)] \
            = True
    hit[30:32] &= ~same[30:32]
    hit[30, 900] = hit[31, 1000] = True
    hit[n - 5:] = False
    row, col = np.nonzero(hit)
    g = Graph.from_edges(row, col, n,
                         edge_weight=rng.rand(len(row)).astype(np.float32)
                         + 0.2, edge_buffer_size=len(row) + 9, device=device)
    return attach_windows(g, window=window, tile=tile)


def long_row_windows(device, n=169_343, e=1_354_429,
                     cells=(512, 400, 300, 200, 129, 100, 64, 33), seed=7):
    """A windowed layout at ogbn-arxiv's N (windows of 512, tiles of 128,
    as the preset) whose in-window rows reach a whole window: rows of
    ``cells`` columns drawn inside their own window at random positions,
    every other row about 8 edges (geometric) to uniform columns, so it
    holds few in-window cells besides; built from a seed."""
    import numpy as np

    from graphax_torch.kernels.dispatch import attach_windows
    from graphax_torch.sparse.graph import Graph

    rng = np.random.RandomState(seed)
    deg = rng.geometric((n - len(cells)) / (e - sum(cells)), n)
    rows = rng.choice(n, len(cells), replace=False)
    deg[rows] = 0
    row = [np.repeat(np.arange(n), deg)]
    col = [rng.randint(0, n, row[0].size)]
    for r, c in zip(rows, cells):
        w0 = r // 512 * 512
        width = min(512, n - w0)
        row.append(np.full(min(c, width), r))
        col.append(w0 + rng.choice(width, min(c, width), replace=False))
    row, col = np.concatenate(row), np.concatenate(col)
    order = np.lexsort((col, row))
    g = Graph.from_edges(row[order], col[order], n, device=device)
    return attach_windows(g, window=512, tile=128)


def hub_graph(device, n=169_343, e=1_354_429,
              hubs=(13_000, 9_000, 6_000, 4_000, 3_000, 2_500, 2_000, 2_000),
              seed=3, transpose=False):
    """A graph at ogbn-arxiv's N and about its E with a few rows of
    thousands of edges and the rest short, built from a seed: ``hubs`` rows
    at random positions, every other row one edge or more (geometric, with
    the mean that makes up E, about 8), columns uniform. Its degrees are
    not a power law: about 2,100 rows have more than 32 edges, and the
    share of rows and edges above the row walk's cutovers is printed with
    it (that of the real ogbn-arxiv is not known to the repo). With
    ``transpose``, its transpose: the hub rows become hub columns."""
    import numpy as np

    from graphax_torch.sparse.graph import Graph

    rng = np.random.RandomState(seed)
    mean = (e - sum(hubs)) / (n - len(hubs))
    deg = rng.geometric(1.0 / mean, n)
    deg[rng.choice(n, len(hubs), replace=False)] = hubs
    row = np.repeat(np.arange(n), deg)
    col = rng.randint(0, n, row.size)
    if transpose:
        row, col = col, row
    order = np.lexsort((col, row))
    return Graph.from_edges(row[order], col[order], n, device=device)


def squareplus_slack(layout, q, x, kt, gshift, scal):
    """``[N, 1]``: how far squareplus's cancellation lets a row of flash's
    f32 output move. Its weight (z + sqrt(z^2 + 4)) / 2, z = s - gshift,
    cancels for z << 0: each side's roundings move a weight by up to about
    u sqrt(z^2 + 4) (u = 2^-24) whatever the last bits of z, which the
    kernels and the plain version compute in another order, so the two
    weights differ by up to |dw_e| = 2u sqrt(z^2 + 4); a row's output, a
    weighted mean, then moves by up to 2 max|x| sum_e |dw_e| / sum_e w_e,
    averaged over the heads (from the plain version's scores)."""
    import torch

    from graphax_torch.kernels import fused_attention as fa
    from graphax_torch.sparse.ops import EPS, segment_max, segment_sum

    n, seg = layout.num_rows, layout.seg
    z = fa.edge_scores_plain(layout, q, kt, None, *scal) - gshift
    root = torch.sqrt(z * z + 4.0)
    ratio = segment_sum(root, seg, n) / (
        segment_sum((z + root) / 2.0, seg, n) + EPS)
    xmax = segment_max(x[layout.idx.long()].float().abs().amax(1), seg,
                       n).clamp(min=0.0)
    return (2.0 * 2.0 ** -24 * 2.0 * xmax * ratio.mean(1))[:, None]


def degree_shares(ptr, cuts) -> dict:
    """The largest degree of a CSR ``ptr`` and, for each cutover c, the
    rows of more than c edges and their shares of the rows and edges."""
    deg = (ptr[1:] - ptr[:-1]).long().cpu()
    out = {"max_degree": int(deg.max())}
    for c in cuts:
        over = deg > c
        out[f"rows_over_{c}"] = int(over.sum())
        out[f"row_share_over_{c}"] = float(over.float().mean())
        out[f"edge_share_over_{c}"] = float(deg[over].sum() / deg.sum())
    return out


def three_kernel_checks(results: dict, path: str, graph, x, q, q_s, k, kt,
                        cfg, ew, name: str, timed: bool, ov2=1.3,
                        inv2l2=0.7) -> None:
    """The three kernels of the three-kernel form and K5 against their
    plain versions on one input set, with the bound of each at these
    inputs. ``path`` "windowed" (the residual CSR with r0, K5 on the
    in-window cells, K3 against K5's row denominators) or "colnorm" (the
    whole CSR under the global max, K3 per column)."""
    import torch

    from graphax_torch.kernels import fused_attention as fa
    from graphax_torch.kernels import winatt as wa
    from graphax_torch.kernels.attention3 import column_denominators

    n, d = x.shape
    a, heads = q.shape[1], cfg.heads
    b = x.element_size()
    scal = (cfg.attention_type, heads, ov2, inv2l2)
    sqp = bool(cfg.square_plus) and path == "colnorm"
    tabs = 4 * n * heads
    row = lambda k, tag: dict(kernel=k, path=path, dtype=name, variant=tag,
                              graph="slice" if timed else "small")
    if path == "windowed":
        wl = graph.windows
        lay, win = wl.residual, wl.in_window
        ew_res = None if ew is None else ew[lay.perm].contiguous()
    else:
        lay, ew_res = graph.csr, ew
    e_l = lay.num_slots
    idx_bytes = 4 * e_l + 4 * (n + 1)
    # q, K, CSR (and weights) in, the max out; all-miss: K per slot
    gm_bytes = (n * a * b + 4 * n * a + idx_bytes + 4
                + (4 * e_l if ew_res is not None else 0))
    g = hold_to_plain(
        results, row("attention_gmax", path),
        lambda: fa.attention_gmax(lay, q_s, kt, ew_res, *scal),
        lambda: fa.attention_gmax_plain(lay, q_s, kt, ew_res, *scal),
        TOL_GMAX, gm_bytes, e_l * 2.0 * a, timed=timed, tag=path,
        miss_bytes=gm_bytes - 4 * n * a + 4 * e_l * a)
    e, den = hold_to_plain(
        results, row("attention_norm", path),
        lambda: fa.attention_norm(lay, q_s, kt, ew_res, g, *scal,
                                  square_plus=sqp),
        lambda: fa.attention_norm_plain(lay, q_s, kt, ew_res, g, *scal,
                                        square_plus=sqp),
        (("e", TOL_TRAIN), ("den", TOL_TRAIN)),
        # q, K, CSR, shift in; e, den out; all-miss: K per slot
        n * a * b + 4 * n * a + idx_bytes + 4 + 4 * e_l * heads + tabs,
        # per slot and head: the score (2 dk) and e (~2)
        e_l * (2.0 * a + 2.0 * heads), timed=timed, tag=path,
        miss_bytes=n * a * b + 4 * e_l * a + idx_bytes + 4
        + 4 * e_l * heads + tabs)
    if path == "windowed":
        e_w = win.num_slots
        ew_win = None
        if ew is not None:
            ew_win = torch.rand(e_w, device=x.device) + 0.1
        out_win, table = hold_to_plain(
            results, row("winatt", "windowed"),
            lambda: wa.winatt(win, q, k, x, den, g, ew_win, *scal),
            lambda: wa.winatt_plain(win, q, k, x, den, g, ew_win, *scal),
            (("out", tol_rounded(name, x)), ("den", TOL_TRAIN)),
            # q, k, x, the cell CSR, d_res, r0 in; out, den out
            2 * n * a * b + n * d * b + 4 * e_w + 4 * (n + 1) + tabs + 4
            + (4 * e_w if ew_win is not None else 0) + 4 * n * d + tabs,
            # per cell: the scores (2A), e and pbar (~4H), pbar x (2D)
            e_w * (2.0 * a + 4.0 * heads + 2.0 * d), timed=timed)
        per_col = False
    else:
        table = column_denominators(graph.csc, e)
        per_col = True
    tag = "per_column" if per_col else "row"
    # e, the table, x, CSR in; out out; the all-miss count gathers x per slot
    nbytes = 4 * e_l * heads + tabs + n * d * b + idx_bytes + 4 * n * d
    miss = nbytes - n * d * b + e_l * d * b
    # per slot: the weight (~2H) and its product with x (2D)
    ops = e_l * (2.0 * heads + 2.0 * d)
    f32 = hold_to_plain(
        results, row("attention_attspmm", tag),
        lambda: fa.attention_attspmm(lay, e, table, x, per_column=per_col),
        lambda: fa.attention_attspmm_plain(lay, e, table, x, per_col),
        tol_rounded(name, x), nbytes, ops, timed=timed, tag=tag,
        miss_bytes=miss)
    # as the routes call it: in x's dtype, on the windowed route after K5's
    # f32 half (the addend); bit for bit the f32 sum cast once, after the
    # same f32 add
    add = out_win if path == "windowed" else None
    extra = (4 - b) * n * d - (0 if add is None else 4 * n * d)
    got = hold_to_plain(
        results, row("attention_attspmm", tag + " route"),
        lambda: fa.attention_attspmm(lay, e, table, x, per_column=per_col,
                                     addend=add, out_dtype=x.dtype),
        lambda: fa.attention_attspmm_plain(lay, e, table, x, per_col, add,
                                           x.dtype),
        tol_rounded(name, x), nbytes - extra, ops, timed=timed,
        tag=tag + " route", miss_bytes=miss - extra)
    want = f32 if add is None else add + f32
    check(torch.equal(got, want.to(x.dtype)),
          f"attention_attspmm {tag} {name}: the route's output is not the "
          "f32 composite cast once")


def phase_three_kernel_kernels(trainer_w, trainer_c, results: dict) -> None:
    """The three-kernel form (attention_norm, attention_attspmm) and K5
    (winatt) against their plain versions at their paths' shapes, f32 and
    bf16: the windowed arxiv layout's residual CSR and in-window cells with
    the windowed GRAND-nl model's own q, k and K table on its encoded state
    (path A), the arxiv CSR with the column-normalised model's (path B);
    then each route as the RHS calls it, timed whole; then a small
    community graph (an empty residual tile, rows without an in-window
    cell) over every score type and reweight."""
    import torch

    from graphax_torch.kernels import attention3 as a3
    from graphax_torch.kernels import fused_attention as fa
    from graphax_torch.kernels import winatt as wa
    from graphax_torch.utils.params import linear_apply

    for path, tr in (("windowed", trainer_w), ("colnorm", trainer_c)):
        g, cfg = tr.data.graph, tr.cfg
        att = tr.model.block.func.att
        tr.model.eval()
        with torch.no_grad():
            x_enc = tr.model.encode(tr.data.x, train=False)
        info = dict(phase="kernels", path=path, N=g.num_nodes,
                    E=g.num_edges, D=x_enc.shape[1], A=cfg.attention_dim,
                    H=cfg.heads)
        if path == "windowed":
            info.update(residual=g.windows.residual.num_slots,
                        in_window_cells=g.windows.in_window.num_slots)
        emit(info)
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).replace("torch.", "")
            x = x_enc.to(dt).contiguous()
            with torch.no_grad():
                p = fa.prep_inputs(cfg, att, g, x)
                q = linear_apply(att.Q, x).to(dt).contiguous()
                k = linear_apply(att.K, x).to(dt).contiguous()
                q_s = p["q"] if path == "colnorm" else (
                    q / torch.tensor(float(cfg.attention_dim // cfg.heads)
                                     ).sqrt().to(dt)).contiguous()
                kt = fa.attention_kproj(x, p["wk"], p["bk"])
                three_kernel_checks(results, path, g, x, q, q_s, k, kt, cfg,
                                    None, name, True)
                fn = (wa.windowed_attention_ax_fast if path == "windowed"
                      else a3.colnorm_attention_ax_fast)
                ms = time_ms(lambda: fn(cfg, att, g, x))
                key = ("winatt" if path == "windowed" else
                       "attention_attspmm", name) + (
                    () if path == "windowed" else ("per_column",))
                results[key]["function_ms"] = ms
                emit({"phase": "kernels", "kernel": fn.__name__,
                      "path": path, "dtype": name, "ms": ms})
            del x, q, k, q_s, kt, p
            torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(14)
    for label, small, paths in (
            ("small community", _community_graph("cuda"),
             (("windowed", False), ("colnorm", False), ("colnorm", True))),
            ("long in-window rows", _long_row_graph("cuda"),
             (("windowed", False),))):
        n = small.num_nodes
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).replace("torch.", "")
            mk = lambda *shape, s=1.0: (s * torch.randn(  # noqa: E731
                *shape, generator=gen, device="cuda")).to(dt).contiguous()
            x, q, k = mk(n, 162), mk(n, 32, s=0.5), mk(n, 32, s=0.5)
            kt = 0.5 * torch.randn(n, 32, generator=gen, device="cuda")
            for att_type in ("scaled_dot", "cosine_sim", "pearson",
                             "exp_kernel"):
                for ew in (None, small.edge_weight):
                    for path, sqp in paths:
                        cfg = trainer_w.cfg.replace(attention_type=att_type,
                                                    square_plus=sqp)
                        with torch.no_grad():
                            three_kernel_checks(results, path, small, x, q,
                                                q, k, kt, cfg, ew, name,
                                                False)
        emit({"phase": "kernels", "graph": label,
              "cases": 16 * len(paths),
              "kernels": ["attention_gmax", "attention_norm", "winatt",
                          "attention_attspmm"], "ok": True})


def phase_hub_kernels(trainer, results: dict) -> None:
    """spmm_csr (A x over the hub rows, A^T g over the hub columns; TOL
    plus the bound of a long row's f32 sum in another order, see
    :func:`spmm_check`), sddmm on its CSR (hub rows in 32-edge segments;
    the graph's rows of exactly 32 and 33 edges, its item cutover,
    counted and required) and on its transpose (:func:`sddmm_check`) and
    the pin (every score type and reweight,
    TOL_PIN) on :func:`hub_graph`, each timed beside its bound and all-miss
    count; then flash_attention
    (softmax and squareplus), attention_gmax (TOL_GMAX), attention_norm
    (TOL_TRAIN) and attention_attspmm (row and column forms) on it; then
    :func:`long_row_kernels`. The kernels walk its hub rows of thousands of edges in segments
    of ``ROW_SPLIT`` edges; flash and attspmm take the
    inputs of the arxiv checks (the GRAND-nl model's own q, Wk and bk on its
    encoded state: the graph has arxiv's N), against their plain versions
    at the tolerances of the arxiv shapes (TOL_FLASH; attspmm's
    tol_rounded), in f32 and bf16, each timed beside its bound and all-miss
    count. Squareplus's weights cancel far below the global shift, which
    this graph's scores reach: its f32 output is held to TOL_FLASH plus
    :func:`squareplus_slack`, its bf16 output to tol_rounded (two bf16 ulps
    of the largest x, since a weight that moves rounds to another bf16
    value); the parent's kernel reads the same errors (PERF.md)."""
    import torch

    from graphax_torch.kernels import fused_attention as fa
    from graphax_torch.kernels.attention3 import column_denominators

    cfg, att = trainer.cfg, trainer.model.block.func.att
    trainer.model.eval()
    with torch.no_grad():
        x_enc = trainer.model.encode(trainer.data.x, train=False)
    g = hub_graph("cuda")
    n, e = g.num_nodes, g.num_edges
    deg = g.csr.ptr[1:] - g.csr.ptr[:-1]
    cut = {f"rows_of_{k}": int((deg == k).sum()) for k in (32, 33)}
    emit({"phase": "kernels", "graph": "hub", "N": n, "E": e, **cut,
          **degree_shares(g.csr.ptr, (32, fa.ROW_SPLIT))})
    check(min(cut.values()) > 0,
          f"hub graph: no row at sddmm's cutover {cut}")
    gen = torch.Generator(device="cuda").manual_seed(21)
    d, a, heads = x_enc.shape[1], cfg.attention_dim, cfg.heads
    csr_bytes = 4 * e + 4 * (n + 1)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        b = dt.itemsize
        x = x_enc.to(dt).contiguous()
        row = lambda k, tag: dict(kernel=k, graph="hub", dtype=name,
                                  variant=tag)
        # spmm_csr: the hub rows in A x, the hub columns in A^T g
        w = (torch.rand(e, generator=gen, device="cuda") + 0.1).to(dt)
        for label, lay, vals in (("hub A.x", g.csr, w),
                                 ("hub AT.g", g.csc, w[g.csc.perm])):
            spmm_check(results, dict(kernel="spmm_csr", graph="hub",
                                     dtype=name, product=label,
                                     **spmm_shape(x)),
                       lay, vals.contiguous(), x, n, long_rows=True)
        # sddmm: the hub rows in 32-edge segments; on the transpose (the
        # CSC) hub x rows gathered by thousands of slots
        cot = torch.randn(n, d, generator=gen, device="cuda").to(dt)
        for tag, lay in (("hub", g.csr), ("hub transposed", g.csc)):
            sddmm_check(results, lay, cot, x, tag=tag)
        del cot
        pin_checks(results, "hub", g, gen, dt)
        with torch.no_grad():
            p = fa.prep_inputs(cfg, att, g, x)
            q = p["q"]
            kt = fa.attention_kproj(x, p["wk"], p["bk"])
            scal = (cfg.attention_type, heads, p["ov2"], p["inv2l2"])
            nbytes = (n * a * b + 4 * n * a + n * d * b + csr_bytes
                      + 4 * n * d)
            for sqp in (False, True):
                gs = fa.attention_gmax(g.csr, q, kt, None, *scal) \
                    if sqp else None
                tag = "hub squareplus" if sqp else "hub"
                tol = TOL_FLASH[name]
                if sqp:
                    tol = tol_rounded(name, x) if dt == torch.bfloat16 else (
                        tol[0] + squareplus_slack(g.csr, q, x, kt, gs, scal),
                        tol[1])
                hold_to_plain(
                    results, row("flash_attention", tag),
                    lambda: fa.flash_attention(g.csr, q, x, kt, None, gs,
                                               *scal),
                    lambda: fa.flash_attention_plain(g.csr, q, x, kt, None,
                                                     gs, *scal),
                    tol, nbytes, e * (2.0 * a + 2.0 * heads * d),
                    tag=tag, miss_bytes=nbytes - n * d * b + e * d * b)
            # gmax over the hub rows' slots: q, K, CSR in; K per slot
            gm_bytes = n * a * b + 4 * n * a + csr_bytes + 4
            gs = hold_to_plain(
                results, row("attention_gmax", "hub"),
                lambda: fa.attention_gmax(g.csr, q, kt, None, *scal),
                lambda: fa.attention_gmax_plain(g.csr, q, kt, None, *scal),
                TOL_GMAX, gm_bytes, e * 2.0 * a, tag="hub",
                miss_bytes=gm_bytes - 4 * n * a + 4 * e * a)
            # the norm over the hub rows' slots: q, K, CSR, shift in; e,
            # den out; all-miss: K per slot
            nm_bytes = (n * a * b + csr_bytes + 4 + 4 * e * heads
                        + 4 * n * heads)
            ev, den = hold_to_plain(
                results, row("attention_norm", "hub"),
                lambda: fa.attention_norm(g.csr, q, kt, None, gs, *scal),
                lambda: fa.attention_norm_plain(g.csr, q, kt, None, gs,
                                                *scal),
                (("e", TOL_TRAIN), ("den", TOL_TRAIN)),
                nm_bytes + 4 * n * a, e * (2.0 * a + 2.0 * heads),
                tag="hub", miss_bytes=nm_bytes + 4 * e * a)
            add = torch.randn(n, d, generator=gen, device="cuda")
            nbytes = (4 * e * heads + 4 * n * heads + n * d * b + csr_bytes
                      + 4 * n * d)
            for table, per_col in ((den, False),
                                   (column_denominators(g.csc, ev), True)):
                tag = "hub " + ("per_column" if per_col else "row")
                f32 = hold_to_plain(
                    results, row("attention_attspmm", tag),
                    lambda: fa.attention_attspmm(g.csr, ev, table, x,
                                                 per_col),
                    lambda: fa.attention_attspmm_plain(g.csr, ev, table, x,
                                                       per_col),
                    tol_rounded(name, x), nbytes, e * (2.0 * heads + 2.0 * d),
                    tag=tag, miss_bytes=nbytes - n * d * b + e * d * b)
                got = fa.attention_attspmm(g.csr, ev, table, x, per_col,
                                           addend=add, out_dtype=dt)
                check(torch.equal(got, (add + f32).to(dt)),
                      f"attention_attspmm {tag} {name}: the addend output is "
                      "not the f32 composite cast once")
        del x, q, kt, ev, den, add
    del g
    torch.cuda.empty_cache()
    long_row_kernels(trainer, x_enc, results)


def long_row_kernels(trainer, x_enc, results: dict) -> None:
    """K5 (winatt) on :func:`long_row_windows` (in-window rows of up to a
    whole window of 512 cells at arxiv's N), with gmax and attention_norm
    on its residual before it, as the windowed route runs them: the
    GRAND-nl model's own q, k and K table on its encoded state, f32 and
    bf16, against the plain versions (K5's out to tol_rounded, den and the
    residual's tables to TOL_TRAIN, gmax to TOL_GMAX), each timed beside
    its bound and all-miss count."""
    import torch

    from graphax_torch.kernels import fused_attention as fa
    from graphax_torch.kernels import winatt as wa
    from graphax_torch.utils.params import linear_apply

    cfg, att = trainer.cfg, trainer.model.block.func.att
    g = long_row_windows("cuda")
    wl = g.windows
    win, res = wl.in_window, wl.residual
    emit({"phase": "kernels", "graph": "long in-window rows",
          "N": g.num_nodes, "E": g.num_edges, "in_window_cells":
          win.num_slots, "residual": res.num_slots, "row_lanes":
          wa.LANES, **degree_shares(win.ptr, (wa.LANES, 128))})
    n, d = x_enc.shape
    a, heads = cfg.attention_dim, cfg.heads
    dk = a // heads
    scal = (cfg.attention_type, heads, 0.0, 0.0)
    e_r, e_w, tabs = res.num_slots, win.num_slots, 4 * n * heads
    for dt in (torch.float32, torch.bfloat16):
        name, b = str(dt).replace("torch.", ""), dt.itemsize
        row = lambda k, tag: dict(kernel=k, graph="long rows",  # noqa
                                  dtype=name, variant=tag)
        with torch.no_grad():
            x = x_enc.to(dt).contiguous()
            q = linear_apply(att.Q, x).to(dt).contiguous()
            k = linear_apply(att.K, x).to(dt).contiguous()
            q_s = (q / torch.sqrt(torch.tensor(dk, dtype=torch.float32))
                   .to(dt)).contiguous()
            kt = fa.attention_kproj(x, att.K.weight.t().to(dt).contiguous(),
                                    att.K.bias.float().contiguous())
            res_bytes = n * a * b + 4 * n * a + 4 * e_r + 4 * (n + 1) + 4
            r0 = hold_to_plain(
                results, row("attention_gmax", "long rows residual"),
                lambda: fa.attention_gmax(res, q_s, kt, None, *scal),
                lambda: fa.attention_gmax_plain(res, q_s, kt, None, *scal),
                TOL_GMAX, res_bytes, e_r * 2.0 * a,
                tag="long rows residual",
                miss_bytes=res_bytes - 4 * n * a + 4 * e_r * a)
            _, d_res = fa.attention_norm(res, q_s, kt, None, r0, *scal)
            # q, k, x, the cell CSR, d_res, r0 in; out, den out; all-miss:
            # k and x gathered per cell
            nbytes = (2 * n * a * b + n * d * b + 4 * e_w + 4 * (n + 1)
                      + tabs + 4 + 4 * n * d + tabs)
            hold_to_plain(
                results, row("winatt", "long rows"),
                lambda: wa.winatt(win, q, k, x, d_res, r0, None, *scal),
                lambda: wa.winatt_plain(win, q, k, x, d_res, r0, None,
                                        *scal),
                (("out", tol_rounded(name, x)), ("den", TOL_TRAIN)),
                nbytes, e_w * (2.0 * a + 4.0 * heads + 2.0 * d),
                tag="long rows",
                miss_bytes=nbytes - n * a * b - n * d * b
                + e_w * (a * b + d * b))
        del x, q, k, q_s, kt, r0, d_res
    del g
    torch.cuda.empty_cache()


def nl_trainer(cfg, data, qk_seed=11, device=None):
    """``Trainer(cfg, data)`` of GRAND-nl whose every ``init_state`` (fit
    calls it first) draws random Q/K by :func:`randomize_attention` (none
    with ``qk_seed=None``: any block), and which keeps each train step's
    kernel launches."""
    from graphax_torch import Trainer
    from graphax_torch.kernels import _build

    class SmokeTrainer(Trainer):
        def init_state(self, seed=None):
            super().init_state(seed)
            if qk_seed is not None:
                randomize_attention(self.model.block.func.att, qk_seed)

        def _step(self):
            before = dict(_build.LAUNCHES)
            out = super()._step()
            self.step_launches.append(
                {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                 if v != before.get(k, 0)})
            return out

    tr = SmokeTrainer(cfg, data, device=device)
    tr.step_launches = []
    return tr


# GRAND-nl's training kernels on CSR: (once per forward and evaluation
# NFE, once per adjoint NFE)
TRAIN_CSR = {"flash_attention": (True, False),
             "attention_kproj": (True, True),
             "attention_fwd_res": (False, True),
             "attention_bwd_rows": (False, True),
             "attention_bwd_cols": (False, True)}
# the windowed route: K5 and the three-kernel form at every RHS evaluation,
# the replay's window products at every adjoint NFE
TRAIN_WINDOWED = {k: (True, True) for k in (
    "attention_kproj", "attention_gmax", "attention_norm", "winatt",
    "attention_attspmm")}
TRAIN_WINDOWED.update({k: (False, True) for k in (
    "win_matmul", "win_bwd_dense", "win_bwd_slab")})
TRAIN_COLNORM = {k: (True, True) for k in (
    "attention_kproj", "attention_gmax", "attention_norm",
    "attention_attspmm")}
# the dense route: K6 at every RHS evaluation without a gradient (the
# adjoint's forward solve, the evaluation), none in the adjoint's backward
# (the materialised route's vjp)
TRAIN_DENSE = {"flash_dense": (True, False)}
# the CSR flash forward whose gradient replays the per-edge path
# (squareplus: its shift by attention_gmax)
TRAIN_FLASH_REPLAY = {k: (True, True) for k in (
    "flash_attention", "attention_kproj", "attention_gmax")}


def phase_grand_nl_train(trainer, epochs: int, label: str = "grand_nl_train",
                         per_nfe: dict = TRAIN_CSR,
                         exclusive: bool = False) -> dict:
    """``trainer.fit(epochs)`` of GRAND-nl with fit's defaults (the
    early-stop evaluation), the launch counts zeroed before and read after:
    per train step each kernel of ``per_nfe`` once per forward NFE and/or
    once per adjoint NFE as its flags say, and over the run once more per
    evaluation NFE where it runs in the forward; with ``exclusive``, no
    other kernel. Finite losses, solver success, nonzero gradients at Q
    and K; the run's peak device memory beside what was allocated before
    it. Returns the launches."""
    import torch

    from graphax_torch.kernels import _build

    trainer.step_launches.clear()
    _build.LAUNCHES.clear()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fit = trainer.fit(epochs=epochs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    hist, solver = fit["history"], fit["solver"]
    for h, sv, st in zip(hist, solver, trainer.step_launches):
        emit({"phase": "slice", "path": label, **h, **sv,
              "step_launches": st})
        check(math.isfinite(h["loss"]) and bool(sv["success"]),
              f"{label} epoch {h['epoch']}: loss {h['loss']}, success "
              f"{sv['success']}")
        check(sv["bwd_nfe"] > 0, f"{label} epoch {h['epoch']}: no adjoint")
        for k, (fwd, bwd) in per_nfe.items():
            want = fwd * h["nfe"] + bwd * sv["bwd_nfe"]
            check(st.get(k, 0) == want,
                  f"{label} epoch {h['epoch']}: {k} launched "
                  f"{st.get(k, 0)} times in a step of {h['nfe']} forward "
                  f"and {sv['bwd_nfe']} adjoint NFE (want {want})")
    nfe = sum(h["nfe"] for h in hist)
    bwd = sum(sv["bwd_nfe"] for sv in solver)
    ev = sum(sv["eval_nfe"] for sv in solver)
    for k, (fwd, bwd_) in per_nfe.items():
        want = fwd * (nfe + ev) + bwd_ * bwd
        check(counts.get(k, 0) == want,
              f"{label}: {k} launched {counts.get(k, 0)} times for {nfe} "
              f"forward, {bwd} adjoint and {ev} evaluation NFE")
    if exclusive:
        check(set(counts) <= set(per_nfe),
              f"{label}: launched {counts}, outside its route {per_nfe}")
    att = trainer.model.block.func.att
    gnorm = {f"{m}.{k}": float(getattr(getattr(att, m), k).grad.abs().max())
             for m in ("Q", "K") for k in ("weight", "bias")}
    check(gnorm["Q.weight"] > 0 and gnorm["K.weight"] > 0,
          f"{label}: no gradient reached Q or K ({gnorm})")
    times = [h["time"] for h in hist]
    emit({"phase": "slice", "path": label, "seconds": seconds,
          "epoch_seconds": times,
          "steady_epoch_seconds": min(times[1:]) if len(times) > 1
          else times[0],
          "forward_nfe": nfe, "adjoint_nfe": bwd, "eval_nfe": ev,
          "launches": counts, "grad_abs_max_last_step": gnorm,
          "best": fit["best"],
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "live_before_fit_gib": base})
    return counts


def phase_grand_nl_routes_train(data, computers, epochs: int) -> tuple:
    """GRAND-nl trained on the routes outside the hand-written backward,
    each ``fit`` with its defaults through :func:`phase_grand_nl_train`
    (random Q/K at every ``init_state``), its route checked first and no
    kernel outside it launched:

    - ``grand_nl_dense_train``: ``best_config("Computers",
      function="transformer", block="constant")`` on its stand-in, ``epochs``
      epochs: the dopri5 adjoint at 13,381 nodes, 4 heads, hidden 128;
      flash_dense (K6, above its gate) once per forward and evaluation NFE
      and never in the adjoint's backward (the materialised route's vjp);
    - ``grand_nl_cora_train``: Cora's preset so (column softmax under
      squareplus, below K6's gate, autograd through the dopri5 steps), 2
      epochs: no kernel, each step's replay keeping only its inputs;
    - ``grand_nl_coauthor_train``: CoauthorCS's, 1 epoch: its [4, N, N]
      scores past ``use_dense_attention``'s guard, so the column route over
      the dense graph's CSR and CSC through the dopri5 adjoint;
    - ``grand_nl_csr_squareplus_train``: the arxiv widths on CSR under
      squareplus, 1 epoch: flash, its K table and shift once per forward,
      evaluation and adjoint NFE (the replay's forward), the per-edge vjp;
    - ``grand_nl_windowed_colnorm_train``: arxiv as published (windowed)
      with column normalisation, 1 epoch: the column route over the
      windowed graph's CSR and CSC.

    Returns (the launches, the Computers Trainer for the breakdown)."""
    import torch

    from graphax_torch import best_config, get_dataset
    from graphax_torch.functions.transformer import (
        attention_route, flash_dense_gate,
    )

    nl = dict(function="transformer", block="constant")
    runs = (
        ("grand_nl_dense_train", best_config("Computers", **nl),
         lambda: computers, epochs, "dense", "dense", TRAIN_DENSE),
        ("grand_nl_cora_train", best_config("Cora", **nl),
         lambda: get_dataset("Cora"), 2, "dense", "dense", {}),
        ("grand_nl_coauthor_train", best_config("CoauthorCS", **nl),
         lambda: get_dataset("CoauthorCS"), 1, "dense", "column",
         TRAIN_COLNORM),
        ("grand_nl_csr_squareplus_train",
         best_config("ogbn-arxiv", community_window=0, square_plus=True,
                     **nl), lambda: data, 1, "sparse", "flash_replay",
         TRAIN_FLASH_REPLAY),
        ("grand_nl_windowed_colnorm_train",
         best_config("ogbn-arxiv", attention_norm_idx=1, **nl),
         lambda: data, 1, "windowed", "column", TRAIN_COLNORM))
    launches: dict = {}
    kept = None
    for label, cfg, get_data, ep, strategy, route, per_nfe in runs:
        tr = nl_trainer(cfg, get_data())
        g = tr.data.graph
        got = attention_route(cfg, g, tr.model.state_dim)
        emit({"phase": "data", "path": label, "dataset": cfg.dataset,
              "num_nodes": g.num_nodes, "num_edges": g.num_edges,
              "strategy": g.strategy, "route": got,
              "state_dim": tr.model.state_dim, "heads": cfg.heads,
              "attention_dim": cfg.attention_dim, "dtype": cfg.dtype,
              "adjoint": cfg.adjoint, "adjoint_method": cfg.adjoint_method,
              "k6_gate": flash_dense_gate(cfg, g.num_nodes)})
        check(g.strategy == strategy and got == route,
              f"{label}: route {got} on a {g.strategy} graph, not {route} "
              f"on a {strategy} one")
        if label == "grand_nl_dense_train":
            check(flash_dense_gate(cfg, g.num_nodes),
                  f"{label}: below K6's gate")
        for k, v in phase_grand_nl_train(tr, ep, label, per_nfe,
                                         exclusive=True).items():
            launches[k] = launches.get(k, 0) + v
        if label == "grand_nl_dense_train":
            kept = tr
        del tr, g
        torch.cuda.empty_cache()
    return launches, kept


def phase_grand_nl(trainer, label: str, evals: int,
                   per_nfe=("flash_attention", "attention_kproj")) -> dict:
    """``Trainer.evaluate()`` of GRAND-nl ``evals`` times, the launch counts
    zeroed before each and read after it: each kernel of ``per_nfe`` once
    per forward NFE (flash and kproj on a sparse graph, flash_dense on a
    dense one, the three-kernel form and K5 on the windowed and column
    routes), gmax once per NFE with squareplus where ``per_nfe`` does not
    name it. Then one RHS evaluation
    timed alone and the logits checked finite. Returns the launches
    summed."""
    import torch

    from graphax_torch.blocks.common import make_fstate
    from graphax_torch.functions.common import prepare_scalars
    from graphax_torch.kernels import _build

    g, cfg = trainer.data.graph, trainer.cfg
    total: dict = {}
    for i in range(evals):
        _build.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accs = trainer.evaluate()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
        res = trainer.last_eval
        emit({"phase": "grand_nl", "path": label, "eval": i + 1,
              "nfe": res.nfe, "steps": res.steps, "success": res.success,
              "seconds": sec, "ms_per_nfe": sec * 1e3 / res.nfe,
              "edges_x_nfe_per_s": g.num_edges * res.nfe / sec,
              "accuracies": accs, "launches": counts})
        check(bool(res.success), f"{label} evaluation {i + 1}: solver failed")
        check(bool(torch.isfinite(res.y).all()),
              f"{label} evaluation {i + 1}: state not finite")
        for k in per_nfe:
            check(counts.get(k, 0) == res.nfe,
                  f"{label}: {k} launched {counts.get(k, 0)} times in an "
                  f"evaluation of {res.nfe} NFE")
        if "attention_gmax" not in per_nfe:
            check(counts.get("attention_gmax", 0)
                  == (res.nfe if cfg.square_plus else 0),
                  f"{label}: attention_gmax launched "
                  f"{counts.get('attention_gmax')} times in {res.nfe} NFE")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    # one RHS evaluation alone, at the evaluation's state and dtype
    model = trainer.model
    with torch.no_grad():
        x0 = model.encode(trainer.data.x, train=False).to(
            getattr(torch, cfg.dtype))
        fs = make_fstate(g, x0, train=False, cfg=cfg)
        alpha, beta = prepare_scalars(model.block.func, cfg, x0.dtype)
        rhs_ms = time_ms(lambda: model.block.func.rhs(alpha, beta, fs, 0.0,
                                                      x0))
        logits, _ = model(g, trainer.data.x, train=False)
    check(bool(torch.isfinite(logits).all())
          and logits.shape == (g.num_nodes, trainer.data.num_classes),
          f"{label}: logits not finite or of the wrong shape")
    emit({"phase": "grand_nl", "path": label, "rhs_ms": rhs_ms,
          "rhs_edges_per_s": g.num_edges / (rhs_ms * 1e-3),
          "note": "the quantity bench.py reports for graphax on the TPU as "
                  "attention_rhs_edges_per_s_per_chip (its own graph)",
          "launches": total})
    return total


def phase_reference_nl() -> dict:
    """A small graph evaluated by GRAND-nl from the same weights on the card
    (kernels) and on the CPU (plain versions): logits within TOL_NL_REF and
    NFE equal (f32: softmax scaled_dot, and squareplus with reweight over
    cosine scores; bf16: softmax)."""
    import torch

    from graphax_torch import Config, Trainer, make_sbm_dataset

    out = []
    for dtype, over in (("float32", {}),
                        ("float32", dict(square_plus=True,
                                         reweight_attention=True,
                                         attention_type="cosine_sim",
                                         add_source=True)),
                        ("bfloat16", {})):
        cfg = Config(dataset="smoke", block="constant", function="transformer",
                     hidden_dim=32, heads=2, attention_dim=16, batch_norm=True,
                     attention_type="scaled_dot", method="dopri5",
                     tol_scale=11353.6, time=3.676, input_dropout=0.0,
                     dropout=0.0, max_nfe=500, dtype=dtype).replace(**over)
        got = {}
        for dev in ("cuda", "cpu"):
            data = make_sbm_dataset(num_nodes=400, num_classes=4,
                                    num_features=32, seed=0,
                                    strategy="sparse", device=dev)
            tr = Trainer(cfg, data, device=dev)
            randomize_attention(tr.model.block.func.att, 7)
            tr.model.eval()
            with torch.no_grad():
                logits, o = tr.model(tr.data.graph, tr.data.x, train=False)
            got[dev] = (logits.float().cpu(), o.result.nfe)
        err = float((got["cuda"][0] - got["cpu"][0]).abs().max())
        row = {"dtype": dtype, **over, "max_abs_err": err,
               "tol": TOL_NL_REF[dtype], "nfe_cuda": got["cuda"][1],
               "nfe_cpu": got["cpu"][1]}
        out.append(row)
        check(math.isfinite(err) and err <= TOL_NL_REF[dtype],
              f"GRAND-nl reference {row}: logits disagree")
        check(got["cuda"][1] == got["cpu"][1],
              f"GRAND-nl reference {row}: NFE differ")
    return {"grand_nl": out}


def phase_reference_nl_train() -> dict:
    """A small graph trained 3 steps by GRAND-nl (constant block, adjoint
    rk4, random Q/K) from the same weights on the card (kernels) and on the
    CPU (plain versions): losses within TOL_NL_TRAIN_REF, and in f32 the
    forward and backward NFE equal."""
    import torch

    from graphax_torch import Config, make_sbm_dataset

    out = []
    for dtype in ("float32", "bfloat16"):
        cfg = Config(dataset="smoke", block="constant", function="transformer",
                     hidden_dim=32, heads=2, attention_dim=16, batch_norm=True,
                     attention_type="scaled_dot", method="dopri5",
                     tol_scale=11353.6, time=3.676, adjoint=True,
                     adjoint_method="rk4", optimizer="rmsprop", lr=0.0055,
                     decay=0.0, input_dropout=0.0, dropout=0.0, max_nfe=500,
                     dtype=dtype)
        got = {}
        for dev in ("cuda", "cpu"):
            data = make_sbm_dataset(num_nodes=400, num_classes=4,
                                    num_features=32, seed=0,
                                    strategy="sparse", device=dev)
            tr = nl_trainer(cfg, data, qk_seed=7, device=dev)
            got[dev] = [(tr.train_step(), tr.fm.get_value(),
                         tr.bm.get_value()) for _ in range(3)]
        err = max(abs(c[0] - p[0]) / max(1.0, abs(p[0]))
                  for c, p in zip(got["cuda"], got["cpu"]))
        row = {"dtype": dtype, "cuda": got["cuda"], "cpu": got["cpu"],
               "max_rel_loss_err": err, "tol": TOL_NL_TRAIN_REF[dtype]}
        out.append(row)
        check(all(math.isfinite(c[0]) for c in got["cuda"])
              and err <= TOL_NL_TRAIN_REF[dtype],
              f"GRAND-nl training reference {dtype}: losses disagree {row}")
        if dtype == "float32":
            check([c[1:] for c in got["cuda"]] == [p[1:] for p in got["cpu"]],
                  f"GRAND-nl training reference: NFE differ {row}")
    return {"grand_nl_train": out}


def phase_reference_nl_routes() -> dict:
    """GRAND-nl on a small community-structured graph from the same
    weights on the card (kernels) and on the CPU (plain versions), f32: the
    windowed route (``community_window=64``, K5), the column route
    (softmax and squareplus, and over the windowed graph's CSR and CSC),
    the CSR flash forward with the per-edge gradient replayed
    (squareplus), mix_features (the per-edge path, no kernel) and the
    dense route below K6's gate (the materialised attention, its replay).
    The evaluation's logits within 1e-4 with NFE equal (dopri5); then one
    train step's loss within 1e-4 and every parameter's gradient within
    GRAD_RTOL plus GRAD_ATOL_OF_MAX of the largest gradient of its module,
    forward and backward NFE equal.

    The step solves with rk4 forward and backward: under dopri5 a
    borderline step can flip between the two devices' summation orders
    (ROADMAP Queue 3, the controller at the f32 noise floor). Gradients
    are compared, not a second step's loss: RMSprop's first step moves
    every parameter by the same size whatever its gradient, so the sign of
    a gradient that is zero but for rounding (Q's bias under column
    softmax, which the function does not see) decides a full step. The
    column softmax's adjoint drives columns ~88 or more below the global
    shift, whose weights are f32 subnormals: it holds the column
    denominators' reduce to the CPU's there."""
    import torch

    from graphax_torch import Config, make_sbm_dataset

    out = []
    for over, strategy in (
            (dict(community_window=64), "sparse"),
            (dict(attention_norm_idx=1), "sparse"),
            (dict(attention_norm_idx=1, square_plus=True), "sparse"),
            (dict(square_plus=True), "sparse"),
            (dict(community_window=64, attention_norm_idx=1), "sparse"),
            (dict(mix_features=True), "sparse"),
            ({}, "auto")):
        cfg = Config(dataset="smoke", block="constant", function="transformer",
                     hidden_dim=32, heads=2, attention_dim=16, batch_norm=True,
                     attention_type="scaled_dot", method="dopri5",
                     tol_scale=11353.6, time=3.676, adjoint=True,
                     adjoint_method="rk4", optimizer="rmsprop", lr=0.002,
                     decay=0.0, input_dropout=0.0, dropout=0.0, max_nfe=500,
                     dtype="float32").replace(**over)
        got = {}
        for dev in ("cuda", "cpu"):
            data = make_sbm_dataset(num_nodes=400, num_classes=4,
                                    num_features=32, seed=0,
                                    strategy=strategy, device=dev)
            tr = nl_trainer(cfg, data, qk_seed=7, device=dev)
            want = "windowed" if cfg.community_window else \
                "dense" if strategy == "auto" else "sparse"
            check(tr.data.graph.strategy == want,
                  f"reference graph is {tr.data.graph.strategy}, not {want}")
            tr.model.eval()
            with torch.no_grad():
                logits, o = tr.model(tr.data.graph, tr.data.x, train=False)
            tr = nl_trainer(cfg.replace(method="rk4"), data,
                            qk_seed=7, device=dev)
            step = (tr.train_step(), tr.fm.get_value(), tr.bm.get_value())
            grads = {n: p.grad.detach().cpu().clone()
                     for n, p in tr.model.named_parameters()
                     if p.grad is not None}
            got[dev] = (logits.float().cpu(), o.result.nfe, step, grads)
        err = float((got["cuda"][0] - got["cpu"][0]).abs().max())
        (lc, *nc), (lp, *np_) = got["cuda"][2], got["cpu"][2]
        gc, gp = got["cuda"][3], got["cpu"][3]
        check(set(gc) == set(gp), f"route reference {over}: gradients of "
              f"different parameters {sorted(gc)} {sorted(gp)}")
        top = {}
        for n, t in gp.items():
            mod = n.rsplit(".", 1)[0]
            top[mod] = max(top.get(mod, 0.0), float(t.abs().max()))
        gerr = {n: float(((gc[n] - t).abs() / (GRAD_RTOL * t.abs()
                          + GRAD_ATOL_OF_MAX * top[n.rsplit(".", 1)[0]]
                          + 1e-30)).max()) for n, t in gp.items()}
        row = {**over, "strategy": want, "max_abs_err": err,
               "tol": TOL_NL_REF["float32"], "nfe_cuda": got["cuda"][1],
               "nfe_cpu": got["cpu"][1], "step_cuda": got["cuda"][2],
               "step_cpu": got["cpu"][2],
               "grad_err_over_tol_max": max(gerr.values())}
        out.append(row)
        check(math.isfinite(err) and err <= TOL_NL_REF["float32"],
              f"GRAND-nl route reference {over}: logits disagree {row}")
        check(got["cuda"][1] == got["cpu"][1],
              f"GRAND-nl route reference {over}: NFE differ {row}")
        check(abs(lc - lp) <= TOL_NL_TRAIN_REF["float32"] * max(1.0, abs(lp))
              and nc == np_ and all(v <= 1.0 for v in gerr.values()),
              f"GRAND-nl route reference {over}: training disagrees {row} "
              f"{gerr}")
    return {"grand_nl_routes": out}


def phase_dense_kernels(trainer, results: dict) -> None:
    """GRAND-nl's masked flash kernel (K6) against its plain version at the
    dense evaluation's shapes: the Computers stand-in's adjacency mask
    (N = 13,381), the model's own q and k on its encoded state (random
    Q/K, H = 4, dk = 16), x of D = 128, in f32 (the preset's dtype) and
    bf16. Beside its time: the bound, the plain version's, one
    ``scaled_dot_product_attention`` with the boolean mask (a library call
    computing the same function here: the graph has self-loops, so no row
    is empty; timed, never used by the port), and PR 4's CSR
    ``flash_attention`` computing the head mean of the same function over
    the same graph. Then small graphs with empty rows, a hub row and an N
    off the tile in both dtypes."""
    import torch

    from graphax_torch.functions.transformer import _split_heads
    from graphax_torch.kernels import fused_attention as fa
    from graphax_torch.kernels.dense_path import dense_adjacency_mask
    from graphax_torch.kernels.flash_dense import (
        flash_attention_multihead, flash_attention_multihead_plain,
    )
    from graphax_torch.utils.params import linear_apply

    g, cfg = trainer.data.graph, trainer.cfg
    att = trainer.model.block.func.att
    n, heads = g.num_nodes, cfg.heads
    trainer.model.eval()
    with torch.no_grad():
        x_enc = trainer.model.encode(trainer.data.x, train=False)
        q = _split_heads(linear_apply(att.Q, x_enc), heads)
        k = _split_heads(linear_apply(att.K, x_enc), heads).contiguous()
    dk, d = q.shape[-1], x_enc.shape[1]
    q = (q / math.sqrt(dk)).contiguous()
    mask = dense_adjacency_mask(g)
    live = int(mask.sum())            # the mask's set entries
    emit({"phase": "kernels", "path": "grand_nl_dense", "N": n,
          "E": g.num_edges, "live": live, "D": d, "H": heads, "dk": dk,
          "mask_density": live / n ** 2})
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        b = torch.finfo(dt).bits // 8
        x = x_enc.to(dt).contiguous()
        # SDPA's inputs: q, k in x's dtype, x shared by the heads
        q4, k4 = (t.transpose(0, 1)[None].to(dt) for t in (q, k))
        v4 = x[None, None].expand(1, heads, n, d)
        with torch.no_grad():
            row = dict(kernel="flash_dense", path="grand_nl_dense",
                       dtype=name)
            hold_to_plain(
                results, row,
                lambda: flash_attention_multihead(q, k, x, mask),
                lambda: flash_attention_multihead_plain(q, k, x, mask),
                TOL_FLASH[name],
                # the mask, q and k (f32), x, the [H, N, D] output; the
                # function's operations are those of the set entries (q.k
                # and p.x per head), the only ones the kernel does
                n * n + 2 * 4 * n * heads * dk + n * d * b
                + heads * n * d * b,
                heads * 2.0 * live * (dk + d),
                ("torch.nn.functional.scaled_dot_product_attention with "
                 "the boolean mask",
                 lambda: torch.nn.functional.scaled_dot_product_attention(
                     q4, k4, v4, attn_mask=mask, scale=1.0)))
            # PR 4's CSR flash kernel on the same graph: the head mean of
            # the same attention, from the same q and keys
            qc = q.reshape(n, heads * dk).to(dt).contiguous()
            kc = k.reshape(n, heads * dk).contiguous()
            got = fa.flash_attention(g.csr, qc, x, kc, None, None,
                                     "scaled_dot", heads)
            ref = flash_attention_multihead(q, k, x, mask).float().mean(0)
            c = compare(got, ref, TOL_DENSE_VS_CSR[name])
            row = results[("flash_dense", name)]
            row["csr_flash_attention_ms"] = time_ms(
                lambda: fa.flash_attention(g.csr, qc, x, kc, None, None,
                                           "scaled_dot", heads))
            row["csr_flash_attention_max_abs_err"] = c["max_abs_err"]
            emit({"phase": "kernels", "kernel": "flash_attention (CSR)",
                  "path": "grand_nl_dense", "dtype": name,
                  "against": "flash_dense's head mean", **c,
                  "ms": row["csr_flash_attention_ms"]})
            check(c["ok"], f"CSR flash and flash_dense {name} disagree")
        del x, q4, k4, v4, qc, kc
        torch.cuda.empty_cache()

    # small graphs: N off the 64-key group and 16 bytes, rows without an
    # edge, a hub row with every key live (more than one list buffer)
    gen = torch.Generator(device="cuda").manual_seed(14)
    worst = {}
    for n_s, h_s, dk_s, d_s in ((300, 2, 4, 8), (1001, 4, 16, 128)):
        mask_s = torch.rand(n_s, n_s, generator=gen, device="cuda") < 6 / n_s
        mask_s.fill_diagonal_(True)
        mask_s[1] = True
        mask_s[-3:] = False
        q_s, k_s = (0.5 * torch.randn(n_s, h_s, dk_s, generator=gen,
                                      device="cuda") for _ in range(2))
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).replace("torch.", "")
            x_s = torch.randn(n_s, d_s, generator=gen, device="cuda").to(dt)
            with torch.no_grad():
                got = flash_attention_multihead(q_s, k_s, x_s, mask_s)
                c = compare(got, flash_attention_multihead_plain(
                    q_s, k_s, x_s, mask_s), TOL_FLASH[name])
            check(c["ok"] and bool((got[:, -3:] == 0).all()),
                  f"flash_dense small N={n_s} {name} disagrees with plain")
            worst[name] = max(worst.get(name, 0.0), c["max_abs_err"])
    emit({"phase": "kernels", "kernel": "flash_dense", "graph": "small",
          "cases": 4, "max_abs_err": worst, "ok": True})


def phase_dense_fit(label: str, trainer, epochs: int,
                    pin_per_epoch: int = 2, out: dict = None,
                    smi: str = None) -> dict:
    """``trainer.fit(epochs)`` of a dense-strategy preset with fit's
    defaults (the early-stop evaluation), its launches zeroed before and
    read after: per epoch the loss, seconds, NFE, backward NFE, the
    early-stop evaluation's NFE, its best time and the epoch's peak device
    memory (the process's: what earlier phases left allocated,
    ``live_before_fit_gib``, is in it); finite losses, solver success, evaluation NFE, and a backward
    NFE as graphax's meter gives it (the adjoint's own NFE, above 0; without
    the adjoint the forward's NFE again, as graphax counts the
    rematerialised steps); and the pin kernel (attention_pin, with its K
    table by attention_kproj) launched ``pin_per_epoch`` times an epoch:
    twice for the hard block (its train and evaluation forwards), none for
    a squareplus config (the per-edge route). Returns the launches; the
    fit's result goes to ``out["fit"]`` where ``out`` is given, and each
    line carries ``smi`` (the card's nvidia-smi line) where it is given."""
    import torch

    from graphax_torch.kernels import _build

    check(trainer.data.graph.strategy == "dense",
          f"{label}: the graph is {trainer.data.graph.strategy}, not dense")
    early, peaks = [], []
    evaluate_early = trainer.evaluate_early

    def recorded():
        res = evaluate_early()
        torch.cuda.synchronize()
        early.append(float(res.best_time))
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
        return res

    trainer.evaluate_early = recorded
    _build.LAUNCHES.clear()
    base = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        fit = trainer.fit(epochs=epochs)
    finally:
        del trainer.evaluate_early
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    adjoint = trainer.cfg.adjoint
    for h, sv, bt, pk in zip(fit["history"], fit["solver"], early, peaks):
        emit({"phase": "slice", "path": label, **h, **sv, "best_time": bt,
              "peak_mem_gib": pk, **({"nvidia_smi": smi} if smi else {})})
        check(math.isfinite(h["loss"]) and bool(sv["success"])
              and bool(sv["eval_success"]),
              f"{label} epoch {h['epoch']}: loss {h['loss']}, success "
              f"{sv['success']}, evaluation {sv['eval_success']}")
        check(sv["eval_nfe"] > 0, f"{label} epoch {h['epoch']}: no "
              "evaluation NFE")
        check(sv["bwd_nfe"] > 0 if adjoint else sv["bwd_nfe"] == sv["nfe"],
              f"{label} epoch {h['epoch']}: backward NFE {sv['bwd_nfe']} "
              f"(forward {sv['nfe']}, adjoint {adjoint})")
    want = pin_per_epoch * epochs
    check(counts.get("attention_pin", 0) == want
          == counts.get("attention_kproj", 0),
          f"{label}: attention_pin launched {counts.get('attention_pin', 0)}"
          f" times (attention_kproj {counts.get('attention_kproj', 0)}) in "
          f"{epochs} epochs, not {want} ({pin_per_epoch} an epoch, the K "
          "table once in each)")
    times = [h["time"] for h in fit["history"]]
    emit({"phase": "slice", "path": label, "strategy":
          trainer.data.graph.strategy, "num_nodes": trainer.data.num_nodes,
          "seconds": seconds, "epoch_seconds": times,
          "steady_epoch_seconds": min(times[1:]) if len(times) > 1
          else times[0], "launches": counts, "best": fit["best"],
          "peak_mem_gib": max(peaks), "live_before_fit_gib": base,
          **({"nvidia_smi": smi} if smi else {})})
    if out is not None:
        out["fit"] = fit
    return counts


ATTENTION_PRESETS = ("Cora", "Citeseer", "Pubmed", "CoauthorCS")


def phase_attention_presets(epochs: int, keep: str = "Pubmed") -> tuple:
    """The four presets of the attention block, each ``Trainer(best_config(
    ds), get_dataset(ds)).fit(epochs)`` with fit's defaults on its stand-in
    at the preset's full width (the dense strategy; squareplus, so the pin
    is the per-edge route and attention_pin never runs), through
    :func:`phase_dense_fit`: Cora and Citeseer train by autograd through
    the accepted steps, Pubmed and CoauthorCS through the adaptive adjoint
    with the [N, N] operator's a_p. Returns the launches and the Trainer
    of ``keep`` (for the breakdown)."""
    import torch

    from graphax_torch import Trainer, best_config, get_dataset

    launches: dict = {}
    kept = None
    for name in ATTENTION_PRESETS:
        t0 = time.perf_counter()
        data = get_dataset(name)
        cfg = best_config(name)
        check(cfg.block == "attention" and cfg.square_plus,
              f"the {name} preset moved")
        tr = Trainer(cfg, data)
        torch.cuda.synchronize()
        emit({"phase": "data", "dataset": name, "seconds":
              time.perf_counter() - t0, "num_nodes": data.num_nodes,
              "num_edges": data.graph.num_edges,
              "num_features": data.num_features,
              "num_classes": data.num_classes,
              "state_dim": tr.model.state_dim, "dtype": cfg.dtype,
              "strategy": tr.data.graph.strategy, "adjoint": cfg.adjoint,
              "adjoint_method": cfg.adjoint_method})
        for k, v in phase_dense_fit(name, tr, epochs,
                                    pin_per_epoch=0).items():
            launches[k] = launches.get(k, 0) + v
        if name == keep:
            kept = tr
        del tr, data
        torch.cuda.empty_cache()
    return launches, kept


def phase_attention_block_csr(data, results: dict, epochs: int) -> dict:
    """The attention block at the arxiv preset's widths (bf16 state, dopri5,
    rk4 adjoint) on the arxiv stand-in: ``community_window=0`` (CSR) for
    ``epochs`` epochs and the preset's windowed layout for one, each
    ``fit`` with its defaults. The pin trains through the per-edge route,
    so the values' gradient leaves each adjoint NFE through sddmm (on the
    CSR, or on the windowed residual, beside win_bwd_dense for the blocks);
    in evaluation the pin kernel runs once. Checks finite losses and
    success, sddmm launched once per adjoint NFE of the train steps on both
    routes, win_bwd_dense too on the windowed one, attention_pin once per
    evaluation; holds sddmm to its plain version on the windowed residual
    at this path's D (TOL_DOT, as the kernels phase). Returns the
    launches."""
    import torch

    from graphax_torch import Trainer, best_config
    from graphax_torch.kernels import _build

    launches: dict = {}
    for label, over, n_ep in (
            ("attention_block_csr", dict(community_window=0), epochs),
            ("attention_block_windowed", {}, 1)):
        cfg = best_config("ogbn-arxiv", block="attention", **over)
        tr = Trainer(cfg, data)
        want = "windowed" if cfg.community_window else "sparse"
        check(tr.data.graph.strategy == want,
              f"{label}: the graph is {tr.data.graph.strategy}, not {want}")
        _build.LAUNCHES.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fit = tr.fit(epochs=n_ep)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
        for h, sv in zip(fit["history"], fit["solver"]):
            emit({"phase": "slice", "path": label, **h, **sv})
            check(math.isfinite(h["loss"]) and bool(sv["success"])
                  and bool(sv["eval_success"]) and sv["bwd_nfe"] > 0,
                  f"{label} epoch {h['epoch']}: loss {h['loss']}, {sv}")
        adjoint_nfe = sum(sv["bwd_nfe"] for sv in fit["solver"])
        emit({"phase": "slice", "path": label, "strategy": want,
              "seconds": seconds,
              "epoch_seconds": [h["time"] for h in fit["history"]],
              "adjoint_nfe": adjoint_nfe, "launches": counts,
              "best": fit["best"],
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
        check(counts.get("sddmm", 0) == adjoint_nfe,
              f"{label}: sddmm launched {counts.get('sddmm', 0)} times in "
              f"{adjoint_nfe} adjoint NFE")
        check(counts.get("attention_pin", 0) == n_ep
              == counts.get("attention_kproj", 0),
              f"{label}: attention_pin {counts.get('attention_pin', 0)} "
              f"(attention_kproj {counts.get('attention_kproj', 0)}) in "
              f"{n_ep} evaluations")
        need = ("spmm_csr",) + (("windowed_densify", "win_matmul",
                                 "win_bwd_slab") if cfg.community_window
                                else ())
        for k in need:
            check(counts.get(k, 0) > 0, f"{label}: {k} never launched")
        if cfg.community_window:
            check(counts.get("win_bwd_dense", 0) == adjoint_nfe,
                  f"{label}: win_bwd_dense launched "
                  f"{counts.get('win_bwd_dense', 0)} times in {adjoint_nfe} "
                  "adjoint NFE")
            # sddmm at the windowed residual, this path's D and dtype
            n, d = tr.data.num_nodes, tr.model.state_dim
            gen = torch.Generator(device="cuda").manual_seed(3)
            g = torch.randn(n, d, generator=gen, device="cuda") \
                .to(torch.bfloat16)
            x = torch.randn(n, d, generator=gen, device="cuda") \
                .to(torch.bfloat16)
            sddmm_check(results, tr.data.graph.windows.residual, g, x,
                        tag="windowed residual")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        del tr
        torch.cuda.empty_cache()
    return launches


# the f32 windowed path: (once per forward and evaluation NFE, once per
# adjoint NFE); the attention block adds the blocks' gradient
F32_WINDOWED = {"win_matmul": (True, True), "win_bwd_slab": (False, True)}
F32_WINDOWED_ATTENTION = {**F32_WINDOWED, "win_bwd_dense": (False, True),
                          "sddmm": (False, True)}


def phase_f32_windowed(data, epochs: int) -> tuple:
    """The ogbn-arxiv preset at the reference's f32 on its windowed layout
    as published (``best_config("ogbn-arxiv", dtype="float32")``: the f32
    bodies of win_matmul and win_bwd_slab) for ``epochs`` epochs, then
    the attention block in f32 on the same layout (``block="attention"``:
    win_bwd_dense's f32 body for the blocks' gradient) for one, each
    ``fit`` with its defaults: per epoch the loss, seconds, forward,
    adjoint and evaluation NFE, the first and steady epoch seconds, the
    peak device memory. Checks finite losses and solver success, and the
    launches: per train step each kernel of ``F32_WINDOWED`` (and
    ``F32_WINDOWED_ATTENTION``) once per forward and/or adjoint NFE as its
    flags say, over the run once more per evaluation NFE where it runs in
    the forward. Returns the launches and both Trainers."""
    import torch

    from graphax_torch import best_config
    from graphax_torch.kernels import _build

    launches: dict = {}
    trainers = []
    for label, over, n_ep, per_nfe in (
            ("f32_windowed", {}, epochs, F32_WINDOWED),
            ("f32_windowed_attention", dict(block="attention"), 1,
             F32_WINDOWED_ATTENTION)):
        cfg = best_config("ogbn-arxiv", dtype="float32", **over)
        check(cfg.community_window == 512 and cfg.dtype == "float32",
              f"{label}: the config moved")
        tr = nl_trainer(cfg, data, qk_seed=None)
        check(tr.data.graph.strategy == "windowed",
              f"{label}: the graph is {tr.data.graph.strategy}")
        _build.LAUNCHES.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fit = tr.fit(epochs=n_ep)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
        hist, solver = fit["history"], fit["solver"]
        for h, sv, st in zip(hist, solver, tr.step_launches):
            emit({"phase": "slice", "path": label, **h, **sv,
                  "step_launches": st})
            check(math.isfinite(h["loss"]) and bool(sv["success"])
                  and bool(sv["eval_success"]) and sv["bwd_nfe"] > 0,
                  f"{label} epoch {h['epoch']}: loss {h['loss']}, {sv}")
            for k, (fwd, bwd) in per_nfe.items():
                want = fwd * h["nfe"] + bwd * sv["bwd_nfe"]
                check(st.get(k, 0) == want,
                      f"{label} epoch {h['epoch']}: {k} launched "
                      f"{st.get(k, 0)} times in a step of {h['nfe']} "
                      f"forward and {sv['bwd_nfe']} adjoint NFE (want "
                      f"{want})")
        nfe = sum(h["nfe"] for h in hist)
        bwd = sum(sv["bwd_nfe"] for sv in solver)
        ev = sum(sv["eval_nfe"] for sv in solver)
        for k, (fwd, bwd_) in per_nfe.items():
            want = fwd * (nfe + ev) + bwd_ * bwd
            check(counts.get(k, 0) == want,
                  f"{label}: {k} launched {counts.get(k, 0)} times for "
                  f"{nfe} forward, {bwd} adjoint and {ev} evaluation NFE")
        times = [h["time"] for h in hist]
        emit({"phase": "slice", "path": label, "dtype": cfg.dtype,
              "seconds": seconds, "epoch_seconds": times,
              "first_epoch_seconds": times[0],
              "steady_epoch_seconds": min(times[1:]) if len(times) > 1
              else None,
              "forward_nfe": nfe, "adjoint_nfe": bwd, "eval_nfe": ev,
              "launches": counts, "best": fit["best"],
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        trainers.append(tr)
    return launches, trainers


def phase_reference_dense() -> dict:
    """Small dense graphs from the same weights on the card and on the CPU:
    the Computers preset at toy width (16 hidden, 2 heads of 4, no
    dropout) trained 3 steps, losses within 1e-4; and GRAND-nl (the
    Computers config as a constant block with the transformer RHS, 4 heads
    of 4, tolerances of the arxiv preset) evaluated on a 4,200-node graph,
    above K6's gate, so that the card runs flash_dense where the CPU runs
    the materialised attention: f32 logits within TOL_NL_REF, NFE equal."""
    import torch

    from graphax_torch import Trainer, best_config, make_sbm_dataset
    from graphax_torch.kernels import _build

    out = {}
    cfg = best_config("Computers", hidden_dim=16, heads=2, attention_dim=8,
                      input_dropout=0.0, dropout=0.0)
    got = {}
    for dev in ("cuda", "cpu"):
        data = make_sbm_dataset(num_nodes=400, num_classes=4,
                                num_features=32, seed=0, device=dev)
        tr = Trainer(cfg, data, device=dev)
        check(tr.data.graph.strategy == "dense", "reference graph not dense")
        gen = torch.Generator().manual_seed(7)
        with torch.no_grad():
            for lin in (tr.model.block.att_layer.Q,
                        tr.model.block.att_layer.K):
                lin.weight.copy_(0.4 * torch.randn(lin.weight.shape,
                                                   generator=gen))
        got[dev] = [(tr.train_step(), tr.fm.get_value(), tr.bm.get_value())
                    for _ in range(3)]
    err = max(abs(c[0] - p[0]) / max(1.0, abs(p[0]))
              for c, p in zip(got["cuda"], got["cpu"]))
    out["computers"] = {"cuda": got["cuda"], "cpu": got["cpu"],
                        "max_rel_loss_err": err, "tol": 1e-4}
    check(all(math.isfinite(c[0]) for c in got["cuda"]) and err <= 1e-4,
          f"dense reference: losses disagree {out['computers']}")

    cfg = best_config("Computers", function="transformer", block="constant",
                      hidden_dim=16, heads=4, attention_dim=16,
                      input_dropout=0.0, dropout=0.0, tol_scale=11353.6)
    got = {}
    for dev in ("cuda", "cpu"):
        data = make_sbm_dataset(num_nodes=4200, num_classes=4,
                                num_features=32, seed=0, device=dev)
        tr = Trainer(cfg, data, device=dev)
        randomize_attention(tr.model.block.func.att, 7)
        tr.model.eval()
        _build.LAUNCHES.clear()
        with torch.no_grad():
            logits, o = tr.model(tr.data.graph, tr.data.x, train=False)
        got[dev] = (logits.float().cpu(), o.result.nfe,
                    _build.LAUNCHES.get("flash_dense", 0))
    err = float((got["cuda"][0] - got["cpu"][0]).abs().max())
    out["grand_nl_dense"] = {"N": 4200, "max_abs_err": err,
                             "tol": TOL_NL_REF["float32"],
                             "nfe_cuda": got["cuda"][1],
                             "nfe_cpu": got["cpu"][1],
                             "flash_dense_launches_cuda": got["cuda"][2]}
    check(math.isfinite(err) and err <= TOL_NL_REF["float32"],
          f"GRAND-nl dense reference: logits disagree {out}")
    check(got["cuda"][1] == got["cpu"][1],
          f"GRAND-nl dense reference: NFE differ {out}")
    check(got["cuda"][2] == got["cuda"][1] and got["cpu"][2] == 0,
          f"GRAND-nl dense reference: flash_dense launches {out}")
    return out


def phase_reference_attention() -> dict:
    """The attention block's presets at toy width (16 hidden, 2 heads of 4,
    no dropout; the preset's optimizer) on a 400-node SBM (the dense
    strategy), Q and K drawn from a seed, trained 3 steps on the card and
    on the CPU from the same weights: Cora (autograd through the accepted
    steps) and Pubmed (the adaptive adjoint). Per step the losses agree
    within 1e-4 relative, the forward and backward NFE are equal, and
    ``att_layer.Q.weight``'s gradient agrees within 1e-4 of its largest
    entry (plus 1e-6). Pubmed's adjoint runs its diffusion back over T =
    12.9, which amplifies the rounding of y(T): there the CPU's own
    gradient moves when m1's weights are scaled by 1 + 2^-23 (one ulp),
    and twice that spread joins the gradient's tolerance, as in
    tests/test_torch_attention_block.py."""
    import torch

    from graphax_torch import Trainer, best_config, make_sbm_dataset

    def run(cfg, dev, m1_scale=1.0):
        data = make_sbm_dataset(num_nodes=400, num_classes=4,
                                num_features=32, seed=0, device=dev)
        tr = Trainer(cfg, data, device=dev)
        check(tr.data.graph.strategy == "dense", "reference graph not dense")
        gen = torch.Generator().manual_seed(7)
        with torch.no_grad():
            for lin in (tr.model.block.att_layer.Q,
                        tr.model.block.att_layer.K):
                lin.weight.copy_(0.4 * torch.randn(lin.weight.shape,
                                                   generator=gen))
            tr.model.m1.weight.mul_(m1_scale)
        steps = []
        for _ in range(3):
            loss = tr.train_step()
            steps.append((loss, tr.fm.get_value(), tr.bm.get_value(),
                          tr.model.block.att_layer.Q.weight.grad
                          .detach().cpu().clone()))
        return steps

    out = {}
    for name in ("Cora", "Pubmed"):
        cfg = best_config(name, hidden_dim=16, heads=2, attention_dim=8,
                          input_dropout=0.0, dropout=0.0)
        got = {dev: run(cfg, dev) for dev in ("cuda", "cpu")}
        spread = [0.0] * 3
        if cfg.adjoint:
            nudged = run(cfg, "cpu", 1.0 + 2.0 ** -23)
            spread = [float((a[3] - b[3]).abs().max())
                      for a, b in zip(got["cpu"], nudged)]
        rows = []
        for i, (c, p) in enumerate(zip(got["cuda"], got["cpu"])):
            gmax = float(p[3].abs().max())
            tol = 1e-4 * gmax + 1e-6 + 2 * spread[i]
            rows.append({"loss_cuda": c[0], "loss_cpu": p[0],
                         "rel_loss_err": abs(c[0] - p[0]) / max(1.0,
                                                                abs(p[0])),
                         "nfe": (c[1], p[1]), "bwd_nfe": (c[2], p[2]),
                         "q_grad_max": gmax,
                         "q_grad_err": float((c[3] - p[3]).abs().max()),
                         "one_ulp_spread": spread[i], "q_grad_tol": tol})
        out[name] = {"adjoint": cfg.adjoint, "steps": rows,
                     "loss_tol": 1e-4}
        for i, r in enumerate(rows):
            check(math.isfinite(r["loss_cuda"]) and r["rel_loss_err"] <= 1e-4,
                  f"attention reference {name} step {i}: losses {r}")
            check(r["nfe"][0] == r["nfe"][1]
                  and r["bwd_nfe"][0] == r["bwd_nfe"][1],
                  f"attention reference {name} step {i}: NFE {r}")
            check(r["q_grad_err"] <= r["q_grad_tol"],
                  f"attention reference {name} step {i}: Q gradient {r}")
    return out


def phase_breakdown(steps, after=None, sums=()) -> dict:
    """``steps``, ``(span name, fn)`` pairs, run in order under
    torch.profiler: each labelled span's host-side and device-side duration
    in order, device time by kernel, and the device's idle share of the
    window. With ``after`` (part of a kernel's name): that kernel's device
    launches and, by name, the kernel that ran next on the device after
    each. ``sums``: parts of kernel names, each with the device ms and
    launches of the kernels whose names hold it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda_t = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        for span, fn in steps:
            with record_function(span):
                fn()
                torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, kernels, device = [], {}, []
    for ev in sorted(prof.events(), key=lambda e: e.time_range.start):
        ms = ev.time_range.elapsed_us() / 1e3
        if ev.name.startswith("graphax_torch."):
            spans.append({"span": ev.name, "ms": ms,
                          "side": "device" if ev.device_type == cuda_t
                          else "host"})
        elif ev.device_type == cuda_t:
            device.append(ev.name)
            k = kernels.setdefault(ev.name[:90], {"ms": 0.0, "count": 0})
            k["ms"] += ms
            k["count"] += 1
    busy = sum(v["ms"] for v in kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:10])
    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / wall_ms,
           "kernel_launches": sum(v["count"] for v in kernels.values()),
           "spans": spans, "device_kernels_top": top}
    out["sums"] = {part: {
        "ms": sum(v["ms"] for k, v in kernels.items() if part in k),
        "count": sum(v["count"] for k, v in kernels.items() if part in k)}
        for part in sums}
    if after is not None:
        hits = [i for i, name in enumerate(device) if after in name]
        nxt: dict = {}
        for i in hits:
            name = device[i + 1][:100] if i + 1 < len(device) else None
            nxt[name] = nxt.get(name, 0) + 1
        out["after"] = {"kernel": after, "launches": len(hits), "next": nxt}
    return out


def phase_reference(window: int = 0) -> dict:
    """A small graph trained from the same weights on the card (kernels)
    and on the CPU (plain versions): losses and NFE must agree. With
    ``window`` the Trainers reorder it onto the windowed layout."""
    import torch

    from graphax_torch import Config, Trainer, make_sbm_dataset

    cfg = Config(dataset="smoke", block="hard_attention", function="laplacian",
                 hidden_dim=16, heads=2, attention_dim=8, batch_norm=True,
                 attention_type="scaled_dot", method="dopri5",
                 tol_scale=11353.6, time=3.0, att_samp_pct=0.8, adjoint=True,
                 adjoint_method="rk4", optimizer="rmsprop", lr=0.0055,
                 decay=0.0, input_dropout=0.0, dropout=0.0, max_nfe=500,
                 community_window=window)
    out = {"community_window": window}
    for dev in ("cuda", "cpu"):
        data = make_sbm_dataset(num_nodes=400, num_classes=4, num_features=32,
                                seed=0, strategy="sparse", device=dev)
        tr = Trainer(cfg, data, device=dev)
        want = "windowed" if window else "sparse"
        check(tr.data.graph.strategy == want,
              f"reference graph is {tr.data.graph.strategy}, not {want}")
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


# ----------------------------------------------------------------------
# 8. real_formats: full-size files in the datasets' own layouts
# ----------------------------------------------------------------------

# (nodes in the file, nodes in its largest connected component)
REAL_SIZES = {"Cora": (2708, 2485), "Computers": (13_752, 13_381)}
ARXIV_SPLIT = (90_941, 29_799, 48_603)    # OGB's time split
# the resumed Computers run against the unbroken one at epoch 3: equal NFE,
# the loss within this relative distance. Not 0: the hard block's
# renormalisation sums each row's kept values by the plain index_add_,
# whose f32 atomics add in no fixed order on the card, so two runs of one
# step can differ in the last bits of the edge values (the CPU test holds
# the two runs bit for bit)
TOL_RESUME = 1e-4


def sbm_with_strays(n_total: int, n_lcc: int, num_classes: int,
                    num_features: int, seed: int):
    """A graph of ``n_total`` nodes whose largest connected component holds
    exactly ``n_lcc``: the stand-in's SBM recipe (`get_dataset`'s
    fallback) at ``n_lcc`` nodes, each of its stray components joined to
    its largest by one edge, and ``n_total - n_lcc`` more nodes in
    components of 1, 2 and 3 nodes; node ids shuffled. Returns (row, col,
    x float32, y, keep), ``keep`` the sorted ids of the component."""
    import numpy as np
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from graphax_torch.data.synthetic import sbm_arrays

    rng = np.random.RandomState(seed)
    c, n = num_classes, n_lcc
    noise = max(1.0, float(np.sqrt(num_features)) / 2.1)
    row, col, x, y = sbm_arrays(rng, n, c, num_features,
                                min(3.0 * c / n, 0.5),
                                1.0 * c / (n * max(c - 1, 1)), noise)
    _, lab = connected_components(
        coo_matrix((np.ones(len(row)), (row, col)), shape=(n, n)),
        directed=True, connection="weak")
    big = np.bincount(lab).argmax()
    main = np.flatnonzero(lab == big)
    _, first = np.unique(lab, return_index=True)
    first = first[lab[first] != big]
    rows = [row, first]
    cols = [col, main[rng.randint(0, len(main), len(first))]]
    start, k = n, 0
    while start < n_total:
        size = min(1 + k % 3, n_total - start)
        rows.append(np.arange(start, start + size - 1))
        cols.append(np.arange(start + 1, start + size))
        start, k = start + size, k + 1
    m = n_total - n
    x = np.concatenate([x, rng.randn(m, num_features)])
    y = np.concatenate([y, rng.randint(0, c, m)])
    perm = rng.permutation(n_total)                 # perm[old] = new
    row = perm[np.concatenate(rows)]
    col = perm[np.concatenate(cols)]
    xs = np.empty((n_total, num_features), np.float32)
    ys = np.empty(n_total, np.int64)
    xs[perm], ys[perm] = x, y
    return row, col, xs, ys, np.sort(perm[:n])


def write_planetoid(root: str, name: str, row, col, x, y, num_classes: int,
                    num_test: int, seed: int) -> str:
    """The eight Planetoid files ``ind.<name>.*`` under ``root/name/raw``:
    ``allx``/``ally`` the first N - num_test nodes, ``tx``/``ty`` the
    rest in the order of ``test.index`` (a shuffle of their ids), ``x``/
    ``y`` the first 20 per class of ``allx``'s count, features as scipy
    CSR, labels one-hot, ``graph`` a dict of adjacency lists."""
    import pickle

    import numpy as np
    import scipy.sparse as sp

    raw = os.path.join(root, name, "raw")
    os.makedirs(raw, exist_ok=True)
    n = len(y)
    n_all = n - num_test
    test_idx = np.random.RandomState(seed).permutation(np.arange(n_all, n))
    onehot = np.eye(num_classes, dtype=np.int64)[y]
    n_lab = min(20 * num_classes, n_all)
    adj = {i: [] for i in range(n)}
    for a, b in sorted(set(zip(row.tolist(), col.tolist()))
                       | set(zip(col.tolist(), row.tolist()))):
        adj[a].append(b)
    objs = {"x": sp.csr_matrix(x[:n_lab]), "y": onehot[:n_lab],
            "allx": sp.csr_matrix(x[:n_all]), "ally": onehot[:n_all],
            "tx": sp.csr_matrix(x[test_idx]), "ty": onehot[test_idx],
            "graph": adj}
    lname = name.lower()
    for ext, obj in objs.items():
        with open(os.path.join(raw, f"ind.{lname}.{ext}"), "wb") as f:
            pickle.dump(obj, f)
    with open(os.path.join(raw, f"ind.{lname}.test.index"), "w") as f:
        f.write("".join(f"{i}\n" for i in test_idx))
    return raw


def write_shchur_npz(root: str, name: str, row, col, x, y) -> str:
    """The shchur npz (``adj_*`` and ``attr_*`` CSR parts, ``labels``) at
    ``root/name/raw/<file>``, the adjacency symmetric as in the published
    files."""
    import numpy as np
    import scipy.sparse as sp

    from graphax_torch.data.loaders import NPZ_FILES

    n = len(y)
    r, c = np.concatenate([row, col]), np.concatenate([col, row])
    adj = sp.csr_matrix((np.ones(len(r), np.float32), (r, c)), shape=(n, n))
    adj.data[:] = 1.0
    attr = sp.csr_matrix(x)
    raw = os.path.join(root, name, "raw")
    os.makedirs(raw, exist_ok=True)
    path = os.path.join(raw, NPZ_FILES[name])
    np.savez(path, adj_data=adj.data, adj_indices=adj.indices,
             adj_indptr=adj.indptr, adj_shape=np.array(adj.shape),
             attr_data=attr.data, attr_indices=attr.indices,
             attr_indptr=attr.indptr, attr_shape=np.array(attr.shape),
             labels=y)
    return path


def write_arxiv_cache(root: str, row, col, x, y, split, seed: int) -> str:
    """ogbn-arxiv as the ``processed_graphax.npz`` cache both packages
    write after their first csv.gz parse (graphax's keys), the time split
    ``split`` (train, valid, test counts) drawn as a shuffle."""
    import numpy as np

    from graphax_torch.data.loaders import ARXIV_CACHE

    n = len(y)
    order = np.random.RandomState(seed).permutation(n)
    masks = []
    for lo, hi in ((0, split[0]), (split[0], split[0] + split[1]),
                   (split[0] + split[1], n)):
        m = np.zeros(n, bool)
        m[order[lo:hi]] = True
        masks.append(m)
    base = os.path.join(root, "ogbn_arxiv")
    os.makedirs(base, exist_ok=True)
    path = os.path.join(base, ARXIV_CACHE)
    np.savez(path, row=row, col=col, x=x, y=y, train_mask=masks[0],
             valid_mask=masks[1], test_mask=masks[2])
    return path


def write_arxiv_files(root: str, seed: int = 23) -> str:
    """ogbn-arxiv's cache under ``root`` (:func:`write_arxiv_cache`): the
    stand-in's SBM recipe at the published shape (169,343 nodes, 128
    features, 40 classes) from ``seed``, OGB's split sizes from ``seed +
    1``."""
    import numpy as np

    from graphax_torch.data.loaders import SHAPES
    from graphax_torch.data.synthetic import sbm_arrays

    s = SHAPES["ogbn-arxiv"]
    c, n = s["num_classes"], s["num_nodes"]
    row, col, x, y = sbm_arrays(
        np.random.RandomState(seed), n, c, s["num_features"],
        min(3.0 * c / n, 0.5), 1.0 * c / (n * max(c - 1, 1)),
        max(1.0, float(np.sqrt(s["num_features"])) / 2.1))
    return write_arxiv_cache(root, row, col, x.astype(np.float32), y,
                             ARXIV_SPLIT, seed + 1)


def width_checks(graph, d: int, smi: str) -> None:
    """The windowed path's kernels at the label trick's state width ``d``
    (hidden 162 + 40 classes) on the real-format arxiv's layout, against
    their plain versions: spmm_csr on the residual edges (A x and A^T g),
    windowed_densify, win_matmul with the residual's sum as its addend and
    win_bwd_slab in bf16 (the preset's state), the pin with its
    attention_kproj in both dtypes (the pin runs f32 on the windowed
    strategy). Not timed: these launches stay out of every count."""
    import torch

    from graphax_torch.kernels import windowed_spmm as ws

    wl = graph.windows
    n = graph.num_nodes
    gen = torch.Generator(device="cuda").manual_seed(5)
    dt = torch.bfloat16
    x = torch.randn(n, d, generator=gen, device="cuda").to(dt)
    gr = torch.randn(n, d, generator=gen, device="cuda").to(dt)
    vals = torch.rand(graph.edge_buffer_size, generator=gen, device="cuda")
    tag = dict(layout="real arxiv", dtype="bfloat16", D=d, nvidia_smi=smi)
    res = {}
    for label, lay, inp in (("residual A.x", wl.residual, x),
                            ("residual AT.g", wl.residual_t, gr)):
        rv = vals.to(dt)[lay.perm].contiguous()
        res[label] = spmm_check({}, dict(kernel="spmm_csr", product=label,
                                         **tag, **spmm_shape(inp)),
                                lay, rv, inp, n, timed=False)
    dense = hold_to_plain({}, dict(kernel="windowed_densify", **tag),
                          lambda: ws.densify(wl, vals, dt),
                          lambda: ws.densify_plain(wl, vals, dt), TOL_EXACT,
                          0, 0, timed=False)
    addend = res["residual A.x"]
    hold_to_plain({}, dict(kernel="win_matmul", **tag,
                           staging=ws.matmul_staging(dense, x, addend)),
                  lambda: ws.win_matmul(wl, dense, x, addend),
                  lambda: ws.win_matmul_plain(wl, dense, x, addend),
                  TOL["bfloat16"], 0, 0, timed=False)
    hold_to_plain({}, dict(kernel="win_bwd_slab", **tag,
                           staging=ws.slab_staging(dense, gr)),
                  lambda: ws.win_bwd_slab(wl, dense, gr, dt),
                  lambda: ws.win_bwd_slab_plain(wl, dense, gr, dt),
                  TOL["bfloat16"], 0, 0, timed=False)
    for pdt in (torch.float32, torch.bfloat16):
        pin_checks({}, "real arxiv D202", graph, gen, pdt, timed=False, d=d,
                   att_types=("scaled_dot",))
    del x, gr, vals, dense, addend, res
    torch.cuda.empty_cache()


def phase_real_formats(smi: str) -> dict:
    """Cora (Planetoid ``ind.*`` pickles), Computers (the shchur npz) and
    ogbn-arxiv (its ``processed_graphax.npz`` cache: the card has no
    pandas, and ``np.loadtxt`` over the full csv.gz would take minutes),
    written at full size to a temporary directory, each graph
    :func:`sbm_with_strays` at the file's size. Each is loaded with
    ``get_dataset(best_config(ds), data_dir=..., synthetic_fallback=False)``
    (its parse, LCC and build seconds printed; Cora and Computers must
    keep 2,485 and 13,381 nodes) and trained: Cora's preset 2 epochs;
    Computers' 3 epochs straight, then ``fit(2, checkpoint_path=p)`` and,
    on a fresh Trainer, ``fit(3, checkpoint_path=p)``, whose one epoch
    must give the straight run's epoch-3 NFE and loss within TOL_RESUME;
    ogbn-arxiv's preset with ``use_labels=True`` (state width 202) 2
    epochs on the windowed layout, after the layout's kernels at that
    width are held to their plain versions. Per dataset the seconds an
    epoch, NFE, peak memory and launches, and the phase's seconds, each
    line with the card's nvidia-smi line. Returns the launches of the three training runs
    (each zeroed before and read after its fit)."""
    import tempfile

    import numpy as np
    import torch

    from graphax_torch import Trainer, best_config, get_dataset
    from graphax_torch.data import loaders
    from graphax_torch.data.lcc import largest_connected_component
    from graphax_torch.kernels import _build

    launches: dict = {}
    t_phase = time.perf_counter()

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    with tempfile.TemporaryDirectory(prefix="graphax_real_") as tmp:
        t0 = time.perf_counter()
        shapes = loaders.SHAPES
        n, n_lcc = REAL_SIZES["Cora"]
        s = shapes["Cora"]
        row, col, x, y, keep_cora = sbm_with_strays(
            n, n_lcc, s["num_classes"], s["num_features"], 20)
        write_planetoid(tmp, "Cora", row, col, x, y, s["num_classes"], 1000,
                        21)
        n, n_lcc = REAL_SIZES["Computers"]
        s = shapes["Computers"]
        row, col, x, y, keep_comp = sbm_with_strays(
            n, n_lcc, s["num_classes"], s["num_features"], 22)
        write_shchur_npz(tmp, "Computers", row, col, x, y)
        write_arxiv_files(tmp)
        emit({"phase": "real_formats", "write_seconds":
              time.perf_counter() - t0, "nvidia_smi": smi})

        parse = {"Cora": lambda: loaders.load_planetoid("Cora", tmp),
                 "Computers": lambda: loaders.load_npz_dataset("Computers",
                                                               tmp),
                 "ogbn-arxiv": lambda: loaders.load_ogbn_arxiv(tmp)}
        trainers = {}
        for ds in ("Cora", "Computers", "ogbn-arxiv"):
            cfg = best_config(ds, **({"use_labels": True}
                                     if ds == "ogbn-arxiv" else {}))
            t0 = time.perf_counter()
            arrays = parse[ds]()
            parse_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            keep = None
            if ds != "ogbn-arxiv":
                keep, _, _ = largest_connected_component(
                    arrays[0], arrays[1], arrays[2].shape[0])
            lcc_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            data = get_dataset(cfg, data_dir=tmp, synthetic_fallback=False)
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            tr = Trainer(cfg, data)
            torch.cuda.synchronize()
            row = {"phase": "real_formats", "dataset": ds,
                   "file_nodes": int(arrays[2].shape[0]),
                   "num_nodes": data.num_nodes,
                   "num_edges": data.graph.num_edges,
                   "num_features": data.num_features,
                   "num_classes": data.num_classes,
                   "train_val_test": [int(m.sum()) for m in (
                       data.train_mask, data.val_mask, data.test_mask)],
                   "strategy": tr.data.graph.strategy,
                   "state_dim": tr.model.state_dim,
                   "parse_seconds": parse_s, "lcc_seconds": lcc_s,
                   "get_dataset_seconds": total_s,
                   "build_seconds": total_s - parse_s - lcc_s,
                   "trainer_seconds": time.perf_counter() - t0,
                   "nvidia_smi": smi}
            emit(row)
            if keep is not None:
                want = {"Cora": keep_cora, "Computers": keep_comp}[ds]
                check(data.num_nodes == REAL_SIZES[ds][1]
                      and np.array_equal(keep, want),
                      f"real {ds}: LCC kept {data.num_nodes} nodes, not "
                      f"{REAL_SIZES[ds][1]}")
            else:
                check(data.num_nodes == 169_343 and row["train_val_test"]
                      == list(ARXIV_SPLIT), f"real arxiv: {row}")
            del arrays
            trainers[ds] = (cfg, data, tr)

        # Cora: the attention block, squareplus (the per-edge pin)
        _, _, tr = trainers.pop("Cora")
        add(phase_dense_fit("real_Cora", tr, 2, pin_per_epoch=0, smi=smi))
        del tr

        # Computers: straight, then broken by a checkpoint and resumed
        cfg, data, tr = trainers.pop("Computers")
        out: dict = {}
        add(phase_dense_fit("real_Computers", tr, 3, out=out, smi=smi))
        straight = out["fit"]["history"][2]
        p = os.path.join(tmp, "computers_ckpt")
        t0 = time.perf_counter()
        Trainer(cfg, data).fit(epochs=2, checkpoint_path=p)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed_tr = Trainer(cfg, data)
        resumed = resumed_tr.fit(epochs=3, checkpoint_path=p)["history"]
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        check(len(resumed) == 1 and resumed[0]["epoch"] == 3,
              f"real Computers: the resumed fit ran {resumed}")
        res = resumed[0]
        rel = abs(res["loss"] - straight["loss"]) / abs(straight["loss"])
        emit({"phase": "real_formats", "dataset": "Computers",
              "checkpoint": p + ".npz",
              "checkpoint_mib": os.path.getsize(p + ".npz") / 2 ** 20,
              "straight_epoch3": {k: straight[k] for k in
                                  ("loss", "nfe", "val_acc")},
              "resumed_epoch3": {k: res[k] for k in
                                 ("loss", "nfe", "val_acc")},
              "loss_rel_diff": rel, "tol": TOL_RESUME,
              "fit2_seconds": first_s, "resume_fit_seconds": resume_s,
              "nvidia_smi": smi})
        check(res["nfe"] == straight["nfe"] and rel <= TOL_RESUME,
              f"real Computers: the resumed epoch 3 {res} against the "
              f"straight run's {straight}")
        del tr, resumed_tr, data

        # ogbn-arxiv with the label trick: the windowed kernels at D 202
        cfg, data, tr = trainers.pop("ogbn-arxiv")
        graph = tr.data.graph
        check(graph.strategy == "windowed" and tr.model.state_dim == 202,
              f"real arxiv: {graph.strategy}, state {tr.model.state_dim}")
        width_checks(graph, tr.model.state_dim, smi)
        _build.LAUNCHES.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fit = tr.fit(epochs=2)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        for h, sv in zip(fit["history"], fit["solver"]):
            emit({"phase": "real_formats", "dataset": "ogbn-arxiv", **h,
                  **sv, "nvidia_smi": smi})
            check(math.isfinite(h["loss"]) and bool(sv["success"])
                  and bool(sv["eval_success"]),
                  f"real arxiv epoch {h['epoch']}: {h} {sv}")
        emit({"phase": "real_formats", "dataset": "ogbn-arxiv",
              "use_labels": True, "label_rate": cfg.label_rate,
              "seconds": time.perf_counter() - t0,
              "epoch_seconds": [h["time"] for h in fit["history"]],
              "launches": counts, "best": fit["best"],
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "nvidia_smi": smi})
        for k in ("windowed_densify", "win_matmul", "win_bwd_slab",
                  "spmm_csr", "attention_pin"):
            check(counts.get(k, 0) > 0,
                  f"{k} never launched on the real arxiv path")
        check(counts.get("attention_kproj", 0) == counts["attention_pin"],
              "real arxiv: attention_kproj against attention_pin "
              f"{counts}")
        add(counts)
        del tr, data, fit
        torch.cuda.empty_cache()
    emit({"phase": "real_formats", "seconds": time.perf_counter() - t_phase,
          "nvidia_smi": smi})
    return launches


# the Beltrami kernels' random weights: a scale for which the Gaussian
# kernels' exponents spread over a few units at the arxiv widths (0.3
# randn weights underflow every score to 0, which checks nothing), and
# scalars away from 1
BELTRAMI_SCALARS = {"output_var_x": 1.2, "lengthscale_x": 1.5,
                    "output_var_p": 0.9, "lengthscale_p": 1.1}


def randomize_beltrami(att, seed: int) -> None:
    """Random Qx/Kx/Qp/Kp (randn / sqrt(in) / 2 weights, 0.1 randn biases)
    and the kernels' scalars of :data:`BELTRAMI_SCALARS`, from a seeded CPU
    generator."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name in ("Qx", "Kx", "Qp", "Kp"):
            lin = getattr(att, name)
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen)
                             / (2.0 * lin.in_features ** 0.5))
            lin.bias.copy_(0.1 * torch.randn(lin.bias.shape, generator=gen))
        for name, v in BELTRAMI_SCALARS.items():
            getattr(att, name).fill_(v)


def blend_pin_check(results: dict, label: str, lay, q, x, wk, bk, scal,
                    bel, tag: str) -> None:
    """attention_pin in ``beltrami_exp`` over ``lay`` against its plain
    version within TOL_PIN, timed beside its bound (x, q, Wk, bk and the
    CSR read once, one f32 written per edge) and its all-miss count (the K
    table written and one K row read per edge from device memory)."""
    from graphax_torch.kernels import attention_pin as pin_mod
    from graphax_torch.kernels import fused_attention as fa

    (n, d), a, heads = x.shape, q.shape[1], scal[1]
    e, b = lay.num_slots, x.element_size()
    args = (lay, q, x, wk, bk, None, *scal)
    nbytes = (n * d * b + n * a * b + d * a * b + 4 * a + 4 * e
              + 4 * (n + 1) + 4 * e)
    # per edge the two squared distances (3 operations a value of 2A) and
    # two exps a head; the K projection
    ops = 2.0 * n * d * a + e * (3.0 * a + 8 * heads)
    hold_to_plain(
        results, dict(kernel="attention_pin", path=f"blend {label}",
                      graph=tag, dtype=str(x.dtype)[6:],
                      att_type="beltrami_exp", N=n, E=e, D=d, A=a, H=heads,
                      kvec=int(fa._vec_unit(a, heads, scal[0]) % 4 == 0),
                      **bel),
        lambda: pin_mod.attention_pin(*args, **bel),
        lambda: pin_mod.attention_pin_plain(*args, **bel), TOL_PIN, nbytes,
        ops, tag=tag, miss_bytes=nbytes + 4 * n * a + 4 * e * a)


def blend_norm_check(results: dict, lay, q, kt, scal, bel, name: str,
                     tag: str) -> None:
    """attention_norm in ``beltrami_exp`` under attention_gmax's shift (the
    column route's) over ``lay`` against its plain version (e and den
    within TOL_TRAIN), timed beside its bound (q, the K table, the CSR and
    the shift read once; e [E, H] and den [N, H] written once) and its
    all-miss count (a K row read per slot)."""
    from graphax_torch.kernels import fused_attention as fa

    (n, a), heads, b = q.shape, scal[1], q.element_size()
    e = lay.num_slots
    gs = fa.attention_gmax(lay, q, kt, None, *scal, **bel)
    tabs = 4 * e * heads + 4 * n * heads
    idx_bytes = 4 * e + 4 * (n + 1)
    hold_to_plain(
        results, dict(kernel="attention_norm", path="blend d", graph=tag,
                      dtype=name, att_type="beltrami_exp", N=n, E=e, A=a,
                      H=heads, kvec=fa.score_vec(q, kt, heads, scal[0]),
                      **bel),
        lambda: fa.attention_norm(lay, q, kt, None, gs, *scal, **bel),
        lambda: fa.attention_norm_plain(lay, q, kt, None, gs, *scal, **bel),
        (("e", TOL_TRAIN), ("den", TOL_TRAIN)),
        n * a * b + 4 * n * a + idx_bytes + 4 + tabs,
        # per slot and head the score (3 operations a value, two exps), e
        # and its sum
        e * (3.0 * a + 8 * heads) + e * 2.0 * heads, tag=tag,
        miss_bytes=n * a * b + 4 * e * a + idx_bytes + 4 + tabs)


def blend_kernel_checks(tr_a, tr_b, results: dict) -> None:
    """The five kernels of the Beltrami paths in ``beltrami_exp`` against
    their plain versions, at the paths' shapes (arxiv's N and E, D 162, the
    K table 2 x 32 wide, 2 heads), each timed beside its bound: the pin on
    path (a)'s graph and on :func:`hub_graph` (rows of up to 13,000 edges:
    the segment kernels' instances) with its hard block's attention layer
    (random weights) in f32 (the windowed strategy's, as the path runs it)
    and bf16 (the CSR strategy's, path (c)), within TOL_PIN
    (:func:`blend_pin_check`); the K projection at [162, 64] in both
    dtypes within TOL_KPROJ; flash on path (b)'s CSR with its RHS's
    attention layer (random weights) in both dtypes within TOL_FLASH,
    attention_norm under attention_gmax's shift (path (d)'s column route)
    within TOL_TRAIN (:func:`blend_norm_check`), and under squareplus
    attention_gmax (TOL_GMAX) then flash with its shift, in bf16; then
    flash, the norm and gmax the same on the hub graph with path (b)'s
    operands."""
    import torch

    from graphax_torch.kernels import fused_attention as fa

    hub = None
    for label, tr, att in (("a", tr_a, tr_a.model.block.att_layer),
                           ("b", tr_b, tr_b.model.block.func.att)):
        randomize_beltrami(att, 31)
        g, cfg = tr.data.graph, tr.cfg
        n, e = g.num_nodes, g.num_edges
        tr.model.eval()
        with torch.no_grad():
            x_enc = tr.model.encode(tr.data.x, train=False,
                                    pos_encoding=tr.data.pos_encoding)
        d, heads = x_enc.shape[1], cfg.heads
        a = fa.score_width(cfg)
        if hub is None:
            hub = hub_graph(x_enc.device)
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).replace("torch.", "")
            b = dt.itemsize
            x = x_enc.to(dt).contiguous()
            with torch.no_grad():
                p = fa.prep_inputs(cfg, att, g, x)
                scal, bel = fa.score_args(p)
                check(scal[0] == "beltrami_exp" and p["q"].shape == (n, a),
                      f"blend {label}: operands {scal} {tuple(p['q'].shape)}")
                q, wk, bk = p["q"], p["wk"], p["bk"]

                def row(kernel, **kw):
                    return dict(dict(kernel=kernel, path=f"blend {label}",
                                     dtype=name, att_type="beltrami_exp",
                                     N=n, E=e, D=d, A=a, H=heads, **bel),
                                **kw)

                kt = hold_to_plain(
                    results, row("attention_kproj",
                                 route=fa.kproj_route(dt, d, a)),
                    lambda: fa.attention_kproj(x, wk, bk),
                    lambda: fa.attention_kproj_plain(x, wk, bk), TOL_KPROJ,
                    n * d * b + d * a * b + 4 * a + 4 * n * a,
                    2.0 * n * d * a,
                    ("torch.addmm out_dtype=float32",
                     lambda: torch.addmm(bk, x, wk, out_dtype=torch.float32)),
                    tag=f"beltrami {label}")
                if label == "a":
                    for lay, tag in ((g.csr, "beltrami"),
                                     (hub.csr, "beltrami hub")):
                        blend_pin_check(results, label, lay, q, x, wk, bk,
                                        scal, bel, tag)
                    continue
                # path (b)'s CSR, then the hub graph with the same operands
                # (its long rows in the segment kernels' instances)
                for lay, tag in ((g.csr, "beltrami"),
                                 (hub.csr, "beltrami hub")):
                    ge = lay.num_slots
                    lay_bytes = 4 * ge + 4 * (n + 1)
                    score_ops = ge * (3.0 * a + 8 * heads)
                    ops = score_ops + ge * 2.0 * heads * d
                    nbytes = (n * a * b + 4 * n * a + n * d * b + lay_bytes
                              + 4 * n * d)
                    miss = nbytes - n * d * b + ge * d * b
                    hold_to_plain(
                        results, row("flash_attention", graph=tag, E=ge),
                        lambda: fa.flash_attention(lay, q, x, kt, None, None,
                                                   *scal, **bel),
                        lambda: fa.flash_attention_plain(lay, q, x, kt, None,
                                                         None, *scal, **bel),
                        TOL_FLASH[name], nbytes, ops, tag=tag,
                        miss_bytes=miss)
                    blend_norm_check(results, lay, q, kt, scal, bel, name,
                                     tag)
                    if dt != torch.bfloat16:
                        continue
                    gshift = hold_to_plain(
                        results, row("attention_gmax", square_plus=True,
                                     graph=tag, E=ge),
                        lambda: fa.attention_gmax(lay, q, kt, None, *scal,
                                                  **bel),
                        lambda: fa.attention_gmax_plain(lay, q, kt, None,
                                                        *scal, **bel),
                        TOL_GMAX, n * a * b + 4 * n * a + lay_bytes + 4,
                        score_ops, tag=tag,
                        miss_bytes=n * a * b + 4 * ge * a + lay_bytes)
                    hold_to_plain(
                        results, row("flash_attention", square_plus=True,
                                     graph=tag, E=ge),
                        lambda: fa.flash_attention(lay, q, x, kt, None,
                                                   gshift, *scal, **bel),
                        lambda: fa.flash_attention_plain(
                            lay, q, x, kt, None, gshift, *scal, **bel),
                        TOL_FLASH[name], nbytes, ops,
                        tag=tag + " squareplus", miss_bytes=miss)
                del kt
            del x, q, wk, bk
        torch.cuda.empty_cache()
    del hub


def blend_knn_pin_checks(tr_c, results: dict) -> None:
    """The pin in ``beltrami_exp`` on path (c)'s kNN graph (every row of
    64 edges or more, so all of it in the segment kernels' instances) with
    its hard block's attention layer (random weights), bf16 (the CSR
    strategy's) and f32, within TOL_PIN (:func:`blend_pin_check`)."""
    import torch

    from graphax_torch.kernels import fused_attention as fa

    att = tr_c.model.block.att_layer
    randomize_beltrami(att, 31)
    g = tr_c.data.graph
    tr_c.model.eval()
    with torch.no_grad():
        x_enc = tr_c.model.encode(tr_c.data.x, train=False,
                                  pos_encoding=tr_c.data.pos_encoding)
        for dt in (torch.bfloat16, torch.float32):
            x = x_enc.to(dt).contiguous()
            p = fa.prep_inputs(tr_c.cfg, att, g, x)
            scal, bel = fa.score_args(p)
            blend_pin_check(results, "c", g.csr, p["q"], x, p["wk"],
                            p["bk"], scal, bel, "beltrami kNN")
            del x, p
    torch.cuda.empty_cache()


def blend_reference_column(seed: int = 13) -> dict:
    """Path (d)'s route on a small graph from the same weights on the card
    (kernels) and on the CPU (plain versions), f32: Beltrami GRAND-nl
    under column normalisation on a 400-node SBM with positional encodings
    from a seed, at narrow widths (features 16 + positional 8, the K table
    2 x 16 wide, 2 heads); the evaluation's logits within TOL_NL_REF and
    NFE equal (dopri5)."""
    import numpy as np
    import torch

    from graphax_torch import Config, Trainer, make_sbm_dataset
    from graphax_torch.functions.transformer import attention_route

    cfg = Config(dataset="smoke", block="constant", function="transformer",
                 hidden_dim=24, heads=2, attention_dim=16, batch_norm=True,
                 beltrami=True, attention_type="exp_kernel",
                 feat_hidden_dim=16, pos_enc_hidden_dim=8, pos_enc_dim=8,
                 attention_norm_idx=1, method="dopri5", tol_scale=11353.6,
                 time=3.676, input_dropout=0.0, dropout=0.0, max_nfe=500,
                 dtype="float32")
    pos = np.random.RandomState(seed).randn(400, 8).astype(np.float32)
    got = {}
    for dev in ("cuda", "cpu"):
        data = make_sbm_dataset(num_nodes=400, num_classes=4,
                                num_features=32, seed=0, strategy="sparse",
                                device=dev).with_pos_encoding(pos)
        tr = Trainer(cfg, data, device=dev)
        check(attention_route(cfg, tr.data.graph, tr.model.state_dim)
              == "column", "blend d reference: not the column route")
        randomize_beltrami(tr.model.block.func.att, seed)
        tr.model.eval()
        with torch.no_grad():
            logits, o = tr.model(tr.data.graph, tr.data.x, train=False,
                                 pos_encoding=tr.data.pos_encoding)
        got[dev] = (logits.float().cpu(), o.result.nfe)
    err = float((got["cuda"][0] - got["cpu"][0]).abs().max())
    row = {"max_abs_err": err, "tol": TOL_NL_REF["float32"],
           "nfe_cuda": got["cuda"][1], "nfe_cpu": got["cpu"][1]}
    check(math.isfinite(err) and err <= TOL_NL_REF["float32"],
          f"blend d reference: logits disagree {row}")
    check(got["cuda"][1] == got["cpu"][1],
          f"blend d reference: NFE differ {row}")
    return row


def blend_fit(label: str, tr, epochs: int, need, smi: str) -> dict:
    """``tr.fit(epochs)`` with fit's defaults, the launches zeroed before
    and read after: per epoch the loss, seconds, NFE, backward and
    evaluation NFE and the epoch's peak device memory; finite losses,
    solver success, and every kernel of ``need`` launched. Returns
    (the launches, the fit)."""
    import torch

    from graphax_torch.kernels import _build

    peaks = []
    step = tr._step

    def recorded():
        out = step()
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
        return out

    tr._step = recorded
    _build.LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        fit = tr.fit(epochs=epochs)
    finally:
        del tr._step
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    for h, sv, pk in zip(fit["history"], fit["solver"], peaks):
        emit({"phase": "blend", "path": label, **h, **sv,
              "peak_mem_gib_step": pk})
        check(math.isfinite(h["loss"]) and bool(sv["success"])
              and bool(sv["eval_success"]),
              f"blend {label} epoch {h['epoch']}: loss {h['loss']}, "
              f"success {sv['success']}, evaluation {sv['eval_success']}")
    times = [h["time"] for h in fit["history"]]
    emit({"phase": "blend", "path": label, "seconds":
          time.perf_counter() - t0, "epoch_seconds": times,
          "strategy": tr.data.graph.strategy,
          "num_edges": tr.data.graph.num_edges, "launches": counts,
          "best": fit["best"], "peak_mem_gib": max(peaks),
          "nvidia_smi": smi})
    for k in need:
        check(counts.get(k, 0) > 0, f"{k} never launched on the blend "
              f"{label} path ({counts})")
    return counts, fit


def phase_blend(data, smi: str, results: dict, epochs: int) -> dict:
    """BLEND at the ogbn-arxiv preset's widths (``feat_hidden_dim`` 64 +
    ``pos_enc_hidden_dim`` 98 = the state's 162), graphax's driver order:
    DeepWalk's DW64 encodings of the stand-in (``apply_beltrami``: the
    walks, the skip-gram on the card, the probe; its seconds and accuracy,
    then the cache read back), then

    (a) ``best_config("ogbn-arxiv", beltrami=True,
        attention_type="exp_kernel")``: the windowed layout, the pin in
        ``beltrami_exp``;
    (b) the same as GRAND-nl (``function="transformer",
        block="constant", community_window=0``): the CSR flash in
        ``beltrami_exp``, its gradient replayed; then one evaluation of
        it under squareplus (attention_gmax in ``beltrami_exp`` once per
        NFE);
    (c) (a) with ``community_window=0, rewire_KNN=True,
        rewire_KNN_epoch=2``: the graph rebuilt at epoch 2 from the
        encoder's 64 nearest neighbours, spmm_csr then held to its plain
        version on it;

    (d) (b) with ``attention_norm_idx=1``: the column route
        (attention_gmax, attention_norm and attention_attspmm per column
        in ``beltrami_exp``, once per forward, adjoint and evaluation
        NFE), after the same route on a small graph held to the CPU
        (:func:`blend_reference_column`);

    each after the five kernels' checks (:func:`blend_kernel_checks`),
    fitted ``epochs`` epochs, and on (c)'s kNN graph the pin
    (:func:`blend_knn_pin_checks`); then edge sampling at epoch 2 on the
    Computers stand-in, and GAT on the arxiv CSR for 2 epochs. Returns the
    launches of the fits."""
    import pickle
    import tempfile

    import numpy as np
    import torch

    from graphax_torch import Trainer, best_config, get_dataset
    from graphax_torch.functions.transformer import attention_route
    from graphax_torch.kernels import _build
    from graphax_torch.rewiring import apply_beltrami

    launches: dict = {}
    t_phase = time.perf_counter()

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    cfg_a = best_config("ogbn-arxiv", beltrami=True,
                        attention_type="exp_kernel")
    with tempfile.TemporaryDirectory(prefix="graphax_blend_") as tmp:
        t0 = time.perf_counter()
        enc = apply_beltrami(data, cfg_a, cache_dir=tmp)
        dw_s = time.perf_counter() - t0
        path = os.path.join(tmp, "pos_encodings", "ogbn-arxiv_DW64.pkl")
        with open(path, "rb") as f:
            acc = pickle.load(f)["acc"]
        t0 = time.perf_counter()
        again = apply_beltrami(data, cfg_a, cache_dir=tmp)
        cache_s = time.perf_counter() - t0
    emit({"phase": "blend", "step": "DW64", "seconds": dw_s,
          "probe_accuracy": acc, "cache_read_seconds": cache_s,
          "shape": list(enc.shape), "nvidia_smi": smi})
    check(enc.shape == (data.num_nodes, 64) and bool(np.isfinite(enc).all())
          and 0.0 <= acc <= 1.0 and np.array_equal(enc, again),
          f"DW64: shape {enc.shape}, accuracy {acc}")
    cfg_a = cfg_a.replace(pos_enc_dim=int(enc.shape[1]))
    data_p = data.with_pos_encoding(enc)
    cfg_b = cfg_a.replace(function="transformer", block="constant",
                          community_window=0)
    cfg_c = cfg_a.replace(community_window=0, rewire_KNN=True,
                          rewire_KNN_epoch=2)

    cfg_d = cfg_b.replace(attention_norm_idx=1)

    tr_a = Trainer(cfg_a, data_p)
    tr_b = Trainer(cfg_b, data_p)
    check(tr_a.data.graph.strategy == "windowed"
          and tr_a.model.state_dim == 162
          and tr_b.data.graph.strategy == "sparse"
          and attention_route(cfg_b, tr_b.data.graph, 162) == "flash_replay"
          and attention_route(cfg_d, tr_b.data.graph, 162) == "column",
          "blend: the paths' layouts or routes moved")
    blend_kernel_checks(tr_a, tr_b, results)

    counts, _ = blend_fit("a pinned", tr_a, epochs,
                          ("attention_pin", "attention_kproj", "spmm_csr",
                           "win_matmul", "win_bwd_slab", "windowed_densify"),
                          smi)
    check(counts["attention_kproj"] == counts["attention_pin"],
          f"blend a: attention_kproj against attention_pin {counts}")
    add(counts)
    del tr_a
    counts, _ = blend_fit("b GRAND-nl", tr_b, epochs,
                          ("flash_attention", "attention_kproj"), smi)
    add(counts)
    del tr_b
    # (b) under squareplus, one evaluation: its shift by attention_gmax in
    # beltrami_exp once per NFE
    tr_sp = Trainer(cfg_b.replace(square_plus=True), data_p)
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    accs = tr_sp.evaluate()
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    nfe = tr_sp.last_eval.nfe
    emit({"phase": "blend", "path": "b GRAND-nl squareplus evaluation",
          "seconds": time.perf_counter() - t0, "accuracies": accs,
          "nfe": nfe, "success": bool(tr_sp.last_eval.success),
          "launches": counts})
    check(counts.get("attention_gmax", 0) == counts.get("flash_attention", 0)
          == nfe > 0 and bool(tr_sp.last_eval.success),
          f"blend b squareplus: {counts}, {nfe} NFE")
    add(counts)
    del tr_sp
    torch.cuda.empty_cache()

    # (d): (b) under column normalisation, the column route in
    # beltrami_exp, after the same route on a small graph against the CPU
    emit({"phase": "blend", "path": "d column reference",
          **blend_reference_column()})
    tr_d = Trainer(cfg_d, data_p)
    column = ("attention_kproj", "attention_gmax", "attention_norm",
              "attention_attspmm")
    counts, fit = blend_fit("d column", tr_d, epochs, column, smi)
    nfe = (sum(h["nfe"] for h in fit["history"])
           + sum(sv["bwd_nfe"] + sv["eval_nfe"] for sv in fit["solver"]))
    check(all(counts[k] == nfe for k in column)
          and "flash_attention" not in counts,
          f"blend d: {counts} against {nfe} forward, adjoint and evaluation "
          "NFE")
    add(counts)
    del tr_d
    torch.cuda.empty_cache()

    tr_c = Trainer(cfg_c, data_p)
    e0 = tr_c.data.graph.num_edges
    counts, _ = blend_fit("c kNN", tr_c, epochs,
                          ("attention_pin", "spmm_csr"), smi)
    add(counts)
    g = tr_c.data.graph
    n = g.num_nodes
    emit({"phase": "blend", "path": "c kNN", "edges_before": e0,
          "edges_after": g.num_edges,
          "knn_edges": n * cfg_c.rewire_KNN_k})
    check(g.num_edges != e0 and g.num_edges >= n * cfg_c.rewire_KNN_k // 2,
          f"blend c: {e0} -> {g.num_edges} edges")
    blend_knn_pin_checks(tr_c, results)
    gen = torch.Generator(device="cuda").manual_seed(41)
    x = torch.randn(n, 162, generator=gen, device="cuda").bfloat16()
    vals = g.edge_weight.bfloat16().contiguous()
    spmm_check(results, dict(kernel="spmm_csr", product="kNN A.x",
                             dtype="bfloat16", graph="kNN",
                             E=g.num_edges, **spmm_shape(x)),
               g.csr, vals, x, n)
    del tr_c, g, x, vals
    torch.cuda.empty_cache()

    comp = get_dataset("Computers")
    tr_s = Trainer(best_config("Computers", edge_sampling=True,
                               edge_sampling_epoch=2), comp)
    e0 = tr_s.data.graph.num_edges
    counts, _ = blend_fit("edge sampling Computers", tr_s, epochs,
                          ("attention_pin",), smi)
    add(counts)
    emit({"phase": "blend", "path": "edge sampling Computers",
          "edges_before": e0, "edges_after": tr_s.data.graph.num_edges})
    check(tr_s.data.graph.num_edges != e0, "edge sampling left the graph")
    del tr_s, comp

    tr_g = Trainer(best_config("ogbn-arxiv", function="GAT",
                               block="constant", community_window=0), data)
    counts, _ = blend_fit("GAT", tr_g, 2, ("spmm_csr", "sddmm"), smi)
    add(counts)
    del tr_g
    torch.cuda.empty_cache()
    emit({"phase": "blend", "seconds": time.perf_counter() - t_phase,
          "nvidia_smi": smi})
    return launches


# ----------------------------------------------------------------------
# 10. surface: the windowed adaptive adjoint, the regularisers' second
# derivatives, Adams, and the higher-order, rewire, hard-block and CGNN
# models
# ----------------------------------------------------------------------

# the four regularisers (the hard block's runs) at a coefficient that keeps
# the loss the cross-entropy's order
REG4 = dict(kinetic_energy=0.01, jacobian_norm2=0.01,
            directional_penalty=0.01, total_deriv=0.01)
# a second derivative against the same composition with the plain versions:
# f32 sums in another order through two derivatives, 1e-4 relative plus
# 1e-4 of the largest entry; bf16 roundings of those sums (one ulp of an
# intermediate moves the terms after it) 2e-2 relative plus two bf16 ulps
# (2^-6) of the largest entry
TOL_SECOND = {"float32": (1e-4, 1e-4), "bfloat16": (2.0 ** -6, 2e-2)}
# the small graphs on the card against the CPU (f32): losses, relative
TOL_SURFACE_REF = 1e-4
WIN_SECOND = "win_matmul+win_bwd_slab+win_bwd_dense"
REF_DEVICES = ("cuda", "cpu")


def reg_launches(block: str, strategy: str, d: int, f: int, b: int,
                 e: int) -> dict:
    """The launches of the Functions' kernels in one regularised epoch: a
    train step of ``f`` forward and ``b`` adjoint NFE (the rk4 adjoint) and
    an evaluation of ``e`` NFE, at state width ``d``. The hard block with
    the four regularisers: each forward NFE the product and D + 1 vjps
    (jacobian_norm2's basis vectors, one ``J^T f``); each adjoint NFE those
    with their graph and their derivatives. The attention block with
    directional_penalty alone: its pinned values' gradient adds sddmm and,
    on the windowed layout, win_bwd_dense. The same counts hold on the CPU
    (tests/test_torch_surface_launches.py counts the wrapper calls)."""
    if block == "hard_attention":
        out = {"spmm_csr": (d + 2) * f + (2 * d + 4) * b + e}
        if strategy == "windowed":
            out.update(win_matmul=f + (d + 2) * b + e,
                       win_bwd_slab=(d + 1) * f + (d + 2) * b)
        return out
    out = {"spmm_csr": 2 * f + 4 * b + e, "sddmm": 3 * b}
    if strategy == "windowed":
        out.update(win_matmul=f + 2 * b + e, win_bwd_slab=f + 2 * b,
                   win_bwd_dense=3 * b)
    return out


def first_order_launches(kind: str, strategy: str, fit) -> dict:
    """The launches a ``fit`` of first-order steps (the rk4 or an adaptive
    adjoint) makes, summed over its epochs from each epoch's forward (F),
    adjoint (B) and evaluation (E) NFE. ``kind`` "laplacian" (the pin's
    kernels aside): an A x every RHS evaluation, an A^T g every adjoint
    NFE, on the windowed layout the blocks' product and the residual's,
    under an adaptive adjoint also the blocks' and the residual values'
    gradients; "GAT": A x every evaluation, A^T g and the attention
    values' SDDMM every adjoint NFE; "transformer" (CSR): flash every
    forward and evaluation NFE, the three training kernels every adjoint
    NFE."""
    f = sum(sv["nfe"] for sv in fit["solver"])
    b = sum(sv["bwd_nfe"] for sv in fit["solver"])
    e = sum(sv["eval_nfe"] for sv in fit["solver"])
    if kind == "transformer":
        return {"flash_attention": f + e, "attention_fwd_res": b,
                "attention_bwd_rows": b, "attention_bwd_cols": b}
    out = {"spmm_csr": f + 2 * b + e}
    if kind == "GAT":
        out["sddmm"] = b
    elif strategy.startswith("windowed"):
        out.update(win_matmul=f + b + e, win_bwd_slab=b)
        if strategy == "windowed_adaptive":
            out.update(win_bwd_dense=b, sddmm=b)
    return out


class plain_kernels:
    """Within it, the autograd Functions of the SpMM and the windowed
    products run the plain versions of their kernels on any device (the
    wrappers' module names swapped), so that a composition of them, a
    second derivative, is held to the same composition of the plain
    versions on the same inputs."""

    def __enter__(self):
        from graphax_torch.kernels import spmm as sm
        from graphax_torch.kernels import windowed_spmm as ws

        self.saved = []
        for mod, name, plain in ((sm, "spmm_csr", sm.spmm_csr_plain),
                                 (sm, "sddmm", sm.sddmm_plain),
                                 (ws, "win_matmul", ws.win_matmul_plain),
                                 (ws, "win_bwd_slab", ws.win_bwd_slab_plain),
                                 (ws, "win_bwd_dense",
                                  ws.win_bwd_dense_plain)):
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, plain)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def second_order_spmm(graph, wb, x, v, u, c):
    """``d/d(wb, x, v)`` of ``<A^T v, u> + <dA(v, x), c>``: the SpMM's
    backward (spmm_csr on the CSC, sddmm) differentiated again (spmm_csr on
    both layouts, sddmm on the CSC)."""
    import torch

    from graphax_torch.kernels.spmm import _SpMM, transpose_values

    y = _SpMM.apply(wb, transpose_values(graph, wb.detach()), x, graph.csr,
                    graph.csc)
    gx, gw = torch.autograd.grad(y, (x, wb), v, create_graph=True)
    s = (gx.float() * u).sum() + (gw.float() * c).sum()
    return torch.autograd.grad(s, (wb, x, v))


def second_order_windowed(wl, dense, x, v, u, c):
    """``d/d(blocks, x, v)`` of ``<B^T v, u> + <dB(v, x), c>``: the
    windowed product's backward (win_bwd_slab, win_bwd_dense)
    differentiated again (all three windowed kernels)."""
    import torch

    from graphax_torch.kernels.windowed_spmm import _WinMatmul

    y = _WinMatmul.apply(dense, x, wl, torch.zeros_like(x))
    gx, gd = torch.autograd.grad(y, (x, dense), v, create_graph=True)
    s = (gx.float() * u).sum() + (gd.float() * c).sum()
    return torch.autograd.grad(s, (dense, x, v))


def second_order_checks(results: dict, graph_csr, graph_win) -> dict:
    """Each Function's second derivative at the path's shapes (the arxiv
    CSR and its windowed layout, D 162), bf16 and f32, against the same
    composition with the plain versions: the launches of each kernel in
    one composition, both compositions' ms; sddmm on the CSC (its new
    layout) timed beside its bound. Returns the rows."""
    import torch

    from graphax_torch.kernels import _build
    from graphax_torch.kernels import spmm as sm
    from graphax_torch.kernels.windowed_spmm import densify_windows

    out = {}
    n, d, dev = graph_csr.num_nodes, 162, graph_csr.device
    gen = torch.Generator(device=dev).manual_seed(5)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    for dt in ("bfloat16", "float32"):
        tdt = getattr(torch, dt)
        atol_of_max, rtol = TOL_SECOND[dt]
        cases = []
        # a copy: requires_grad_ below must not reach the graph's weights
        wb = graph_csr.edge_weight.to(tdt).detach().clone()
        x, v, u = rnd(n, d).to(tdt), rnd(n, d).to(tdt), rnd(n, d)
        c = rnd(graph_csr.edge_buffer_size)
        cases.append(("spmm_csr+sddmm", lambda: second_order_spmm(
            graph_csr, wb.requires_grad_(True), x.requires_grad_(True),
            v.requires_grad_(True), u, c)))
        wl = graph_win.windows
        blocks = densify_windows(graph_win.edge_weight, wl, tdt).detach()
        xw, vw, uw = rnd(n, d).to(tdt), rnd(n, d).to(tdt), rnd(n, d)
        cw = rnd(*wl.block_shape)
        cases.append((WIN_SECOND, lambda: second_order_windowed(
            wl, blocks.requires_grad_(True), xw.requires_grad_(True),
            vw.requires_grad_(True), uw, cw)))
        for name, fn in cases:
            _build.LAUNCHES.clear()
            got = fn()
            launched = dict(_build.LAUNCHES)
            with plain_kernels():
                want = fn()
            parts = {}
            for label, a, b in zip(("d_values", "d_x", "d_cotangent"), got,
                                   want):
                tol = (atol_of_max * float(b.float().abs().max()), rtol)
                parts[label] = compare(a, b, tol)
            row = {"phase": "surface", "second_order": name, "dtype": dt,
                   "launches": launched, "parts": parts,
                   "max_abs_err": max(p["max_abs_err"]
                                      for p in parts.values()),
                   "ms": time_ms(fn, reps=5, warmup=1)}
            with plain_kernels():
                row["plain_ms"] = time_ms(fn, reps=3, warmup=1)
            emit(row)
            check(all(p["ok"] for p in parts.values()),
                  f"second derivative {name} {dt} disagrees with plain")
            for k in name.split("+"):
                check(launched.get(k, 0) > 0,
                      f"{name} {dt}: {k} not launched ({launched})")
            out[(name, dt)] = row
        # sddmm on the CSC (the second derivative's new layout): timed
        g_, x_ = rnd(n, d).to(tdt), rnd(n, d).to(tdt)
        csc = graph_csr.csc
        e, isz = csc.num_slots, 2 if dt == "bfloat16" else 4
        nbytes = 2 * n * d * isz + e * 8 + (n + 1) * 4 + e * isz
        hold_to_plain(results, {"kernel": "sddmm", "dtype": dt,
                                "layout": "arxiv CSC (second order)"},
                      lambda: sm.sddmm(csc, g_, x_, tdt),
                      lambda: sm.sddmm_plain(csc, g_, x_, tdt),
                      TOL_DOT if dt == "float32" else TOL["bfloat16"],
                      nbytes, 2.0 * e * d, tag="csc second order",
                      miss_bytes=nbytes + e * d * isz)
    return out


def surface_fit(label: str, tr, epochs: int, smi: str, need=(),
                expect=None, **fit_kw) -> tuple:
    """``tr.fit(epochs)`` with the launches zeroed before and read after:
    per epoch the loss, seconds, NFE, backward and evaluation NFE, solver
    success and the step's peak device memory; finite losses and the
    success of the forward, backward and evaluation solves checked, every
    kernel of ``need`` launched, and, where ``expect(fit)``
    gives counts, the launches equal to them. Returns (launches, fit)."""
    import torch

    from graphax_torch.kernels import _build

    peaks = []
    step = tr._step

    def recorded():
        res = step()
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
        return res

    tr._step = recorded
    _build.LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        fit = tr.fit(epochs=epochs, **fit_kw)
    finally:
        del tr._step
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    for h, sv, pk in zip(fit["history"], fit["solver"], peaks):
        emit({"phase": "surface", "path": label, **h, **sv,
              "peak_mem_gib_step": pk})
        check(math.isfinite(h["loss"]) and bool(sv["success"])
              and bool(sv["bwd_success"]) and bool(sv["eval_success"]),
              f"surface {label} epoch {h['epoch']}: loss {h['loss']}, "
              f"success {sv['success']}, backward {sv['bwd_success']}, "
              f"evaluation {sv['eval_success']}")
    want = expect(fit) if expect is not None else {}
    emit({"phase": "surface", "path": label,
          "seconds": time.perf_counter() - t0,
          "epoch_seconds": [h["time"] for h in fit["history"]],
          "strategy": tr.data.graph.strategy, "launches": counts,
          "expected_launches": want, "best": fit["best"],
          "peak_mem_gib": max(peaks), "nvidia_smi": smi})
    for k in need:
        check(counts.get(k, 0) > 0,
              f"{k} never launched on the surface {label} path ({counts})")
    for k, v in want.items():
        check(counts.get(k, 0) == v, f"surface {label}: {k} launched "
              f"{counts.get(k, 0)} times, the NFE say {v}")
    return counts, fit


def _randomize_all_attention(model, seed: int) -> None:
    """Random Q/K in every transformer attention layer of ``model`` (a
    uniform attention would put the hard block's threshold among ties)."""
    from graphax_torch.functions.transformer import TransformerAttention

    for m in model.modules():
        if isinstance(m, TransformerAttention) and hasattr(m, "Q"):
            randomize_attention(m, seed)


def surface_trainer(cfg, data, swap=None, qk_seed=7, device=None):
    """A Trainer whose every ``init_state`` draws random Q/K in its
    attention layers; ``swap(model)`` replaces its block first (the
    higher-order block, which no config selects)."""
    from graphax_torch import Trainer

    class SurfaceTrainer(Trainer):
        def init_state(self, seed=None):
            if swap is not None and not getattr(self, "_swapped", False):
                swap(self.model)
                self._swapped = True
            super().init_state(seed)
            if qk_seed is not None:
                _randomize_all_attention(self.model, qk_seed)

    return SurfaceTrainer(cfg, data, device=device)


def higher_order_swap(model) -> None:
    from graphax_torch.blocks import make_higher_order_block

    model.block = make_higher_order_block(model.cfg, model.state_dim, 2) \
        .to(next(model.parameters()).device)


def surface_reference(label: str, cfg, strategy: str = "sparse",
                      swap=None, steps: int = 2) -> dict:
    """A small graph (400 nodes, f32) trained ``steps`` steps from the same
    weights on the card and on the CPU: losses within TOL_SURFACE_REF,
    forward and backward NFE equal."""
    from graphax_torch import make_sbm_dataset

    out = {"phase": "surface", "reference": label}
    runs = {}
    for dev in REF_DEVICES:
        data = make_sbm_dataset(num_nodes=400, num_classes=4, num_features=32,
                                seed=0, strategy=strategy, device=dev)
        tr = surface_trainer(cfg, data, swap=swap, device=dev)
        tr.init_state()
        runs[dev] = [(tr.train_step(), tr.fm.get_value(), tr.bm.get_value())
                     for _ in range(steps)]
        out[dev + "_strategy"] = tr.data.graph.strategy
    card, host = (runs[d] for d in REF_DEVICES)
    out.update(card=card, host=host)
    emit(out)
    for (lc, fc, bc), (lp, fp, bp) in zip(card, host):
        check(math.isfinite(lc) and abs(lc - lp) <= TOL_SURFACE_REF
              * max(1.0, abs(lp)), f"surface {label}: loss cuda {lc} vs "
              f"cpu {lp}")
        check(fc == fp and bc == bp, f"surface {label}: NFE cuda {fc}/{bc} "
              f"vs cpu {fp}/{bp}")
    return out


SMALL = dict(dataset="smoke", function="laplacian", hidden_dim=16, heads=2,
             attention_dim=8, attention_type="scaled_dot", method="dopri5",
             tol_scale=11353.6, time=3.0, att_samp_pct=0.8, adjoint=True,
             adjoint_method="rk4", optimizer="rmsprop", lr=0.0055, decay=0.0,
             input_dropout=0.0, dropout=0.0, max_nfe=500, batch_norm=True,
             block="hard_attention")


def cgnn_reference(label: str) -> dict:
    """The CGNN on a small graph from the same weights on the card and on
    the CPU: logits within 1e-4, NFE equal, a train step's gradients."""
    import torch

    from graphax_torch import Config, make_sbm_dataset
    from graphax_torch.models import make_cgnn, normalize_for_cgnn

    cfg = Config(hidden_dim=16, time=1.0, method="dopri5", tol_scale=100.0,
                 input_dropout=0.0, dropout=0.0)
    res = {}
    for dev in REF_DEVICES:
        data = make_sbm_dataset(num_nodes=400, num_classes=4, num_features=32,
                                seed=0, strategy="sparse", device=dev)
        m = make_cgnn(cfg, 32, 4).to(dev)
        m.init_for_graph(data.graph, torch.Generator().manual_seed(0))
        logits, aux = m(normalize_for_cgnn(data.graph), data.x, train=True)
        (logits ** 2).sum().backward()
        res[dev] = (logits.detach().cpu(), aux["nfe"],
                    m.alpha_train.grad.detach().cpu())
    card, host = (res[d] for d in REF_DEVICES)
    err = float((card[0] - host[0]).abs().max())
    gerr = float((card[2] - host[2]).abs().max()
                 / host[2].abs().max().clamp(min=1e-30))
    out = {"phase": "surface", "reference": label, "max_abs_err": err,
           "alpha_grad_rel_err": gerr, "nfe": (card[1], host[1])}
    emit(out)
    check(err <= TOL_SURFACE_REF * max(1.0, float(host[0].abs().max()))
          and gerr <= 1e-3 and card[1] == host[1],
          f"surface {label}: {out}")
    return out


def phase_surface(trainer, trainer0, smi: str, results: dict) -> dict:
    """(a) the arxiv preset under the adaptive adjoint on its windowed
    layout, (b) the regularisers on CSR and windowed with the kernels'
    second derivatives, (c) Adams, (d) the higher-order, rewire, hard-block
    (transformer, GAT, flux) and CGNN models; each after its small graph
    on the card against the CPU. Returns the launches summed over its
    paths."""
    import tempfile

    import torch

    from graphax_torch import Config, best_config, get_dataset
    from graphax_torch.drivers.explicit_implicit import run_experiment
    from graphax_torch.drivers.run_cgnn import train_cgnn
    from graphax_torch.kernels import _build
    from graphax_torch.ode.solvers import _fixed_grid

    launches: dict = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    t_phase = time.perf_counter()
    data_w, data_s = trainer.data, trainer0.data
    d = trainer.model.state_dim

    # (a) the windowed strategy under the adaptive adjoint: the blocks' a_p
    # integrated, win_bwd_dense at every adjoint NFE. The adjoint tolerance
    # is raised 1000-fold (rtol 1e-6, atol 1e-4), within the other presets'
    # range (443-16324): the preset's own (rtol 1e-9, atol 1e-7, set for
    # its rk4 adjoint) lies below f32 and bf16 rounding, where the backward
    # spends max_nfe without reaching t0
    adaptive = dict(adjoint_method="adaptive_heun", tol_scale_adjoint=1000.0)
    surface_reference("a_windowed_adaptive", Config(
        **dict(SMALL, community_window=64, **adaptive)))
    tr = surface_trainer(best_config("ogbn-arxiv", **adaptive), data_w)
    counts, fit = surface_fit(
        "a_windowed_adaptive", tr, 2, smi, expect=lambda fit:
        first_order_launches("laplacian", "windowed_adaptive", fit))
    bwd = sum(sv["bwd_nfe"] for sv in fit["solver"])
    check(counts["win_bwd_dense"] == bwd,
          f"(a): win_bwd_dense {counts['win_bwd_dense']} launches, "
          f"{bwd} adjoint NFE")
    add(counts)
    del tr

    # (b) the regularisers: the hard block with all four (CSR and windowed),
    # the attention block with directional_penalty (its values' gradient);
    # the second-order launches as the NFE say; the kernels' second
    # derivatives held to their plain versions
    for block, regs in (("hard_attention", REG4),
                        ("attention", dict(directional_penalty=0.01))):
        for strategy, window, base in (("sparse", 0, data_s),
                                       ("windowed", 512, data_w)):
            label = f"b_{block}_{strategy}"
            surface_reference(label, Config(**dict(
                SMALL, block=block, community_window=window // 8,
                **regs)))
            cfg = best_config("ogbn-arxiv", block=block,
                              community_window=window, **regs)
            tr = surface_trainer(cfg, base)
            check(tr.data.graph.strategy == strategy, f"{label}: strategy")

            def expect(fit, block=block, strategy=strategy):
                sv = fit["solver"][0]
                return reg_launches(block, strategy, d, sv["nfe"],
                                    sv["bwd_nfe"], sv["eval_nfe"])

            counts, _ = surface_fit(label, tr, 1, smi, expect=expect)
            add(counts)
            del tr
    second = second_order_checks(results, data_s.graph, data_w.graph)

    # (c) Adams on a fixed grid of 8 steps over T; the solver comparison
    # on the Cora stand-in
    cfg0 = best_config("ogbn-arxiv")
    for method in ("explicit_adams", "implicit_adams"):
        surface_reference(f"c_{method}", Config(
            **dict(SMALL, method=method, step_size=0.375)))
        cfg = best_config("ogbn-arxiv", method=method,
                          step_size=cfg0.time / 8)
        tr = surface_trainer(cfg, data_w)
        counts, fit = surface_fit(
            f"c_{method}", tr, 1, smi, expect=lambda fit:
            first_order_launches("laplacian", "windowed", fit))
        k = 2 if method == "implicit_adams" else 1
        n_eval = len(_fixed_grid(0.0, cfg.earlystopxT * cfg.time,
                                 cfg.step_size)) - 1
        sv = fit["solver"][0]
        check(sv["nfe"] == 12 + 5 * k and
              sv["eval_nfe"] == 12 + (n_eval - 3) * k,
              f"(c) {method}: NFE {sv['nfe']}, evaluation {sv['eval_nfe']}")
        add(counts)
        del tr
    cora = get_dataset("Cora")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        exp = run_experiment("Cora", step_sizes=(0.25,), epochs=1,
                             results_dir=tmp, data=cora)
    nfe = {m: rec["nfes"][0] for (m, _, _), rec in exp.items()}
    emit({"phase": "surface", "path": "c_explicit_implicit",
          "seconds": time.perf_counter() - t0, "nfe": nfe,
          "losses": {m: rec["losses"][0] for (m, _, _), rec in exp.items()},
          "best_val": {m: rec["best"]["val_acc"]
                       for (m, _, _), rec in exp.items()}})
    check(nfe.get("euler") == 12 and nfe.get("rk4") == 48
          and nfe.get("explicit_adams") == 21
          and nfe.get("implicit_adams") == 30 and "dopri5" in nfe
          and all(math.isfinite(rec["losses"][0]) for rec in exp.values()),
          f"(c) the solver comparison: {nfe}")

    # (d) the new blocks and models
    surface_reference("d_higher_order", Config(**dict(SMALL, block="constant")),
                      swap=higher_order_swap)
    tr = surface_trainer(best_config("ogbn-arxiv", block="constant",
                                     community_window=0), data_s,
                         swap=higher_order_swap)
    counts, _ = surface_fit(
        "d_higher_order", tr, 1, smi, use_early_stop=False,
        expect=lambda fit: first_order_launches("laplacian", "sparse", fit))
    add(counts)
    del tr
    for new_edges in ("k_hop_att", "random"):
        label = f"d_rewire_{new_edges}"
        surface_reference(label, Config(**dict(
            SMALL, block="rewire_attention", new_edges=new_edges)),
            strategy="dense")
        tr = surface_trainer(best_config("Cora", block="rewire_attention",
                                         new_edges=new_edges), cora)
        counts, _ = surface_fit(label, tr, 1, smi)
        add(counts)
        del tr
    for function in ("transformer", "GAT"):
        label = f"d_hard_{function}"
        surface_reference(label, Config(**dict(SMALL, function=function)))
        tr = surface_trainer(best_config("ogbn-arxiv", function=function,
                                         community_window=0), data_s)
        counts, _ = surface_fit(
            label, tr, 1, smi, need=("attention_pin",) * (
                function == "transformer"),
            expect=lambda fit, k=function: first_order_launches(
                k, "sparse", fit))
        add(counts)
        del tr
    surface_reference("d_use_flux", Config(**dict(SMALL, use_flux=True,
                                                  community_window=64)))
    tr = surface_trainer(best_config("ogbn-arxiv", use_flux=True), data_w)
    counts, _ = surface_fit(
        "d_use_flux", tr, 1, smi, need=("attention_pin",),
        expect=lambda fit: first_order_launches("laplacian", "windowed", fit))
    add(counts)
    del tr
    cgnn_reference("d_cgnn")
    for name, dset in (("Cora", cora), ("ogbn-arxiv", data_s)):
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        out = train_cgnn(name, epochs=2, log_every=0, data=dset)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        emit({"phase": "surface", "path": f"d_cgnn_{name}",
              "seconds": time.perf_counter() - t0,
              "history": out["history"], "launches": counts,
              "val_acc": out["val_acc"], "nvidia_smi": smi})
        # one A x per NFE; autograd through the accepted steps adds one
        # A^T g per stage that reached the result
        nfe = sum(h["nfe"] + h["eval_nfe"] for h in out["history"])
        check(all(math.isfinite(h["loss"]) and h["success"]
                  and h["eval_success"] for h in out["history"]),
              f"CGNN {name}: {out['history']}")
        check(nfe < counts.get("spmm_csr", 0) <= nfe + sum(
            h["nfe"] for h in out["history"]),
              f"CGNN {name}: spmm_csr {counts.get('spmm_csr', 0)}, NFE "
              f"{nfe}")
        add(counts)
    emit({"phase": "surface", "seconds": time.perf_counter() - t_phase,
          "launches": launches})
    return launches, second


# ----------------------------------------------------------------------
# 11. the multimodal family

# the union's logits against per-sample solves (graphax's own tolerance
# for its batched graphs, tests/test_batched_graphs.py:77-80)
TOL_UNION = (1e-5, 1e-6)
# the small multimodal model on the card against the CPU (f32 logits)
TOL_MM_REF = 1e-4
# (c)'s union on the card against the same model on the CPU (the kernels'
# plain versions): each parameter's gradient of one train step within this
# fraction of its largest entry (of 1 where that is smaller; f32 sums in
# another order through 16 evaluations and their backward)
TOL_MM_GRAD = 1e-4
# the ResNet-101 trunk to layer3 on the card against the CPU, relative to
# the largest feature (f32 convolutions in another order, 30 blocks deep;
# graphax's trunk tolerance)
TOL_TRUNK = 2e-4


def _random_resnet101(seed: int = 0, out_stage: int = 3) -> dict:
    """A torchvision-layout ResNet-101 state dict through ``out_stage``
    stages at its published widths, random from a seed: convolutions
    scaled by 1 / sqrt(fan in), batch-norm statistics near the identity."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[name + ".weight"] = torch.from_numpy(
            (rng.randn(o, i, k, k) / math.sqrt(i * k * k)).astype("f4"))

    def bn(name, c):
        for leaf, val in (("weight", 1 + 0.1 * rng.randn(c)),
                          ("bias", 0.1 * rng.randn(c)),
                          ("running_mean", 0.1 * rng.randn(c)),
                          ("running_var", 1 + 0.1 * rng.rand(c))):
            sd[f"{name}.{leaf}"] = torch.from_numpy(val.astype("f4"))

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    c_in = 64
    for s, blocks in enumerate((3, 4, 23, 3)[:out_stage]):
        planes = 64 * 2 ** s
        for i in range(blocks):
            p = f"layer{s + 1}.{i}"
            conv(p + ".conv1", planes, c_in, 1)
            bn(p + ".bn1", planes)
            conv(p + ".conv2", planes, planes, 3)
            bn(p + ".bn2", planes)
            conv(p + ".conv3", planes * 4, planes, 1)
            bn(p + ".bn3", planes * 4)
            if i == 0:
                conv(p + ".downsample.0", planes * 4, c_in, 1)
                bn(p + ".downsample.1", planes * 4)
            c_in = planes * 4
    return sd


def _counted(fn):
    """``fn()`` with the launches zeroed before and read after: (its
    result, the launches, seconds ending in a device sync, the peak
    device GiB)."""
    import torch

    from graphax_torch.kernels import _build

    _build.LAUNCHES.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, dict(_build.LAUNCHES), time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def _mm_chain_model(block: str, method: str, d: int, classes: int, device,
                    seed: int = 3, tol_scale: float = 1.0):
    import torch

    from graphax_torch.models.multimodal import MultimodalGNN
    from graphax_torch.train import Config

    cfg = Config(block=block, method=method, step_size=0.25, time=1.0,
                 input_dropout=0.0, dropout=0.0, heads=2, attention_dim=16,
                 self_loop_weight=1.0, lr=0.005, tol_scale=tol_scale)
    model = MultimodalGNN(cfg, 16, d, classes).to(device)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def phase_multimodal(smi: str) -> dict:
    """The multimodal family (`graphax_torch.models.multimodal`,
    `graphax_torch.drivers.run_multi`): (a) ``run_multi.main`` on MNIST's
    preset (28 x 28 grid with diagonals, 784 nodes, 1 channel, euler 0.25,
    T 1) on the synthetic digits, 2 epochs at batch 4, train 32, test
    512; (b) ``train_clevr_style`` as users run it (grid 14, feat 64,
    text 32, 16 tokens, 28 classes, euler 0.5, 2 epochs of 32 samples at
    batch 4), then one epoch at the reference's widths (ResNet-101
    layer3's 14 x 14 x 1024 patches, BERT-base's 768-wide tokens; 256
    samples, batch 32); (c) 32 questions of 8-16 tokens on their own chain
    graphs through the constant and the attention block, 3 adam steps and
    an evaluation under rk4 (one solve on the block-diagonal union:
    spmm_csr once an evaluation for the batch, the pin once an
    evaluation forward, sddmm once an evaluation in the attention block's
    backward), the union against per-sample solves, and the first train
    step's loss and gradients and the evaluation's logits against the same
    model on the CPU (the kernels' plain versions: spmm_csr, sddmm, the
    pin and its attention_kproj held at the union's shapes), then the
    constant block's evaluation under dopri5 (one solve with a controller
    per sample: each sample's NFE its own solve's, spmm_csr launched the
    slowest sample's NFE times), also against the CPU; (d)
    a small multimodal model on the card against the CPU; (e)
    ``resnet_trunk`` to layer3 on a random ResNet-101 at 224 x 224, batch
    8, against the CPU. Returns the launches summed over (a)-(d). The
    dopri5 solves of (c) and (d) run at ``tol_scale=1000``, above the f32
    noise floor."""
    import contextlib
    import io

    import numpy as np
    import torch

    from graphax_torch.data.extractors import resnet_trunk
    from graphax_torch.data.multimodal import (
        batched_chain_graphs, build_clevr_style_dataset,
    )
    from graphax_torch.drivers import run_multi
    from graphax_torch.models.multimodal import MultimodalGNN
    from graphax_torch.train.optimizers import get_optimizer

    cuda = torch.device("cuda")
    t_phase = time.perf_counter()
    launches: dict = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # (a) the README's command at MNIST's preset
    buf = io.StringIO()
    argv = ["--im_dataset", "MNIST", "--epoch", "2", "--batch_size", "4",
            "--train_size", "32", "--test_size", "512", "--data_dir",
            os.path.join(HERE, "no-mnist-files")]
    with contextlib.redirect_stdout(buf):
        out, counts, secs, peak = _counted(lambda: run_multi.main(argv))
    hist = json.loads(buf.getvalue().strip().splitlines()[-1])["history"]
    cfg = out["model"].cfg
    emit({"phase": "multimodal", "path": "a_mnist", "argv": argv,
          "history": hist, "epoch_seconds": [h["time"] for h in hist],
          "nodes": out["model"].num_nodes, "method": cfg.method,
          "step_size": cfg.step_size, "time": cfg.time, "seconds": secs,
          "peak_mem_gib": peak, "launches": counts, "nvidia_smi": smi})
    check(len(hist) == 2 and all(math.isfinite(h["loss"]) for h in hist)
          and 0.0 <= hist[-1]["test_acc"] <= 1.0,
          f"multimodal (a): history {hist}")
    check(out["model"].num_nodes == 784 and cfg.method == "euler",
          "multimodal (a): not MNIST's preset")
    add(counts)

    # (b) CLEVR-style as users run it, then the reference's widths
    for label, kw in (("b_clevr", dict(epochs=2, batch_size=4,
                                       num_samples=32)),
                      ("b_clevr_reference_widths",
                       dict(epochs=1, batch_size=32, num_samples=256,
                            build_kwargs=dict(feat_dim=1024,
                                              text_dim=768)))):
        out, counts, secs, peak = _counted(
            lambda kw=kw: run_multi.train_clevr_style(log=False, **kw))
        hist = out["history"]
        m = out["model"]
        emit({"phase": "multimodal", "path": label, "history": hist,
              "epoch_seconds": [h["time"] for h in hist],
              "nodes": m.num_nodes, "features": m.m2.in_features
              // m.num_nodes, "second_modality_dim":
              m.cfg.second_modality_dim, "seconds": secs,
              "peak_mem_gib": peak, "launches": counts, "nvidia_smi": smi})
        check(all(math.isfinite(h["loss"]) for h in hist),
              f"multimodal {label}: losses {hist}")
        add(counts)

    # (c) per-sample chain graphs
    ds = build_clevr_style_dataset(num_samples=32, max_question_len=16,
                                   text_dim=32, seed=5, device=cuda)
    lens = ds.question_lengths
    check(lens.min() >= 8 and lens.max() <= 16 and len(set(lens)) > 1,
          f"multimodal (c): question lengths {lens}")
    sel = np.arange(32)
    graphs = ds.text_graphs_for(sel)
    xs = torch.as_tensor(ds.questions, device=cuda)
    ys = torch.as_tensor(ds.answers, device=cuda)
    b = len(sel)
    # the same data and models on the CPU, where every wrapper takes its
    # kernel's plain version
    cpu = torch.device("cpu")
    graphs_c = build_clevr_style_dataset(
        num_samples=32, max_question_len=16, text_dim=32, seed=5,
        device=cpu).text_graphs_for(sel)
    xs_c, ys_c = xs.cpu(), ys.cpu()

    def cpu_twin(model, method, **kw):
        ref = _mm_chain_model(model.cfg.block, method, 32, ds.num_classes,
                              cpu, **kw)
        ref.load_state_dict({k: v.cpu()
                             for k, v in model.state_dict().items()})
        return ref

    for block in ("constant", "attention"):
        model = _mm_chain_model(block, "rk4", 32, ds.num_classes, cuda)
        ref = cpu_twin(model, "rk4")
        ref_loss = run_multi.batch_loss(ref, None, xs_c, ys_c, train=True,
                                        graphs=graphs_c)
        ref_loss.backward()
        opt = get_optimizer("adam", model.parameters(), 0.005)
        steps = []
        for _ in range(3):
            loss, counts, secs, peak = _counted(
                lambda: run_multi.train_step(model, opt, None, xs, ys,
                                             graphs=graphs))
            steps.append({"loss": float(loss), "seconds": secs,
                          "peak_mem_gib": peak, "launches": counts})
            add(counts)
            if len(steps) == 1:
                # the first step's gradients (the optimizer leaves .grad)
                grad_err = {}
                for (name, p), (_, q) in zip(model.named_parameters(),
                                             ref.named_parameters()):
                    check((p.grad is None) == (q.grad is None),
                          f"multimodal (c) {block}: {name}'s gradient "
                          "on one side only")
                    if q.grad is not None:
                        scale = max(1.0, float(q.grad.abs().max()))
                        grad_err[name] = float(
                            (p.grad.cpu() - q.grad).abs().max()) / scale
        with torch.no_grad():
            (logits, aux), counts, secs, peak = _counted(
                lambda: model.forward_batched(None, xs, graphs=graphs))
            add(counts)
            single = torch.stack([model(graphs.sample(i), xs[i])[0]
                                  for i in range(b)])
            ref.load_state_dict({k: v.cpu()
                                 for k, v in model.state_dict().items()})
            ref_logits, ref_aux = ref.forward_batched(None, xs_c,
                                                      graphs=graphs_c)
        nfe = aux["nfe"][0]
        err = float((logits - single).abs().max())
        ok = torch.allclose(logits, single, rtol=TOL_UNION[0],
                            atol=TOL_UNION[1])
        cpu_err = float((logits.cpu() - ref_logits).abs().max())
        loss_err = abs(steps[0]["loss"] - float(ref_loss.detach()))
        emit({"phase": "multimodal", "path": f"c_chains_{block}",
              "questions": b, "lengths": lens.tolist(),
              "union_nodes": graphs.union().num_nodes,
              "union_edges": graphs.union().num_edges, "train": steps,
              "eval_nfe": aux["nfe"], "eval_seconds": secs,
              "eval_launches": counts, "union_vs_per_sample_err": err,
              "tol": TOL_UNION, "card_vs_cpu": {
                  "logits_max_abs_err": cpu_err, "loss_abs_err": loss_err,
                  "grad_rel_err": grad_err, "tol_logits": TOL_MM_REF,
                  "tol_grad": TOL_MM_GRAD, "nfe_cpu": ref_aux["nfe"]},
              "nvidia_smi": smi})
        check(all(math.isfinite(s["loss"]) for s in steps),
              f"multimodal (c) {block}: losses {steps}")
        check(ok, f"multimodal (c) {block}: union against per-sample "
              f"solves {err}")
        check(cpu_err <= TOL_MM_REF and loss_err <= TOL_MM_REF
              and ref_aux["nfe"] == aux["nfe"],
              f"multimodal (c) {block}: card against CPU, logits {cpu_err}, "
              f"loss {loss_err}, NFE {ref_aux['nfe']}")
        check(bool(grad_err) and max(grad_err.values()) <= TOL_MM_GRAD,
              f"multimodal (c) {block}: card against CPU gradients "
              f"{grad_err}")
        check(counts.get("spmm_csr", 0) == nfe == 16,
              f"multimodal (c) {block}: spmm_csr {counts} for NFE {nfe} "
              f"(B x NFE = {b * nfe})")
        check(counts.get("attention_pin", 0)
              == (1 if block == "attention" else 0),
              f"multimodal (c) {block}: the pin {counts}")
        # a train step: A x at each of the NFE, A^T g at each but the
        # first (whose x is the data), and in the attention block the
        # pinned values' gradient (sddmm) at each
        for s in steps:
            c = s["launches"]
            check(c.get("spmm_csr", 0) == 2 * nfe - 1 and c.get("sddmm", 0)
                  == (nfe if block == "attention" else 0),
                  f"multimodal (c) {block} train step: {c}, NFE {nfe}")
    # dopri5 above the f32 noise floor, as (d)'s
    model = _mm_chain_model("constant", "dopri5", 32, ds.num_classes, cuda,
                            tol_scale=1000.0)
    ref = cpu_twin(model, "dopri5", tol_scale=1000.0)
    with torch.no_grad():
        (logits, aux), counts, secs, peak = _counted(
            lambda: model.forward_batched(None, xs, graphs=graphs))
        add(counts)
        singles = [model(graphs.sample(i), xs[i]) for i in range(b)]
        ref_logits, ref_aux = ref.forward_batched(None, xs_c,
                                                  graphs=graphs_c)
    err = float((logits - torch.stack([s[0] for s in singles])).abs().max())
    cpu_err = float((logits.cpu() - ref_logits).abs().max())
    emit({"phase": "multimodal", "path": "c_chains_dopri5",
          "eval_nfe": aux["nfe"], "eval_seconds": secs,
          "eval_launches": counts, "union_vs_per_sample_err": err,
          "card_vs_cpu": {"logits_max_abs_err": cpu_err,
                          "tol_logits": TOL_MM_REF,
                          "nfe_cpu": ref_aux["nfe"]},
          "nvidia_smi": smi})
    check(cpu_err <= TOL_MM_REF and ref_aux["nfe"] == aux["nfe"],
          f"multimodal (c) dopri5: card against CPU, logits {cpu_err}, "
          f"NFE {ref_aux['nfe']} against {aux['nfe']}")
    # one solve, a controller per sample: each sample's NFE its own solve's,
    # the evaluations (and launches) the slowest sample's, not their sum
    check(aux["nfe"] == [s[1]["nfe"] for s in singles]
          and counts.get("spmm_csr", 0) == max(aux["nfe"])
          and err <= TOL_UNION[1] + TOL_UNION[0] * float(logits.abs().max()),
          f"multimodal (c) dopri5: NFE {aux['nfe']}, launches {counts}, "
          f"err {err}")

    # (d) a small multimodal model on the card against the CPU
    refs = []
    for label, block, method, chains in (
            ("grid_dopri5", "constant", "dopri5", False),
            ("chains_attention_rk4", "attention", "rk4", True)):
        got = {}
        for dev in (cuda, torch.device("cpu")):
            small = build_clevr_style_dataset(
                num_samples=6, grid=4, feat_dim=8, text_dim=6,
                max_question_len=8, num_classes=5, seed=7, device=dev)
            # chains: the questions on their graphs against the images;
            # the grid: the images against the questions
            feats, second = (small.questions, small.images) if chains \
                else (small.images, small.questions)
            # dopri5 above the f32 noise floor (graphax's default atol
            # 1e-7 and rtol 1e-9 sit on it, where a borderline accept can
            # flip between the card and the CPU: ROADMAP Queue 3)
            cfg = run_multi.clevr_config(second.shape[-1]).replace(
                block=block, method=method, heads=2, attention_dim=8,
                input_dropout=0.0, dropout=0.0, tol_scale=1000.0)
            m = MultimodalGNN(cfg, feats.shape[1], feats.shape[-1],
                              5).to(dev)
            m.reset_parameters(torch.Generator().manual_seed(9))
            gen = torch.Generator().manual_seed(10)
            with torch.no_grad():
                for lin in (m.block.func.cross.Q2, m.block.func.cross.K2):
                    lin.weight.copy_(0.3 * torch.randn(lin.weight.shape,
                                                       generator=gen))
                lg, ax = m.forward_batched(
                    small.image_graph, torch.as_tensor(feats, device=dev),
                    x2s=torch.as_tensor(second, device=dev),
                    graphs=small.text_graphs_for(np.arange(6)) if chains
                    else None)
            got[dev.type] = (lg.cpu(), ax["nfe"])
        err = float((got["cuda"][0] - got["cpu"][0]).abs().max())
        refs.append({"case": label, "max_abs_err": err, "tol": TOL_MM_REF,
                     "nfe_cuda": got["cuda"][1], "nfe_cpu": got["cpu"][1]})
        check(err <= TOL_MM_REF and got["cuda"][1] == got["cpu"][1],
              f"multimodal (d) {refs[-1]}")
    emit({"phase": "multimodal", "reference": refs})

    # (e) the ResNet-101 trunk to layer3
    sd = _random_resnet101()
    x = torch.rand(8, 224, 224, 3, generator=torch.Generator().manual_seed(1))
    params = {k: v.to(cuda) for k, v in sd.items()}
    xc = x.to(cuda)
    with torch.no_grad():
        feats = resnet_trunk(xc, params)
        torch.cuda.synchronize()
        ms = time_ms(lambda: resnet_trunk(xc, params), reps=5, warmup=1)
        t0 = time.perf_counter()
        want = resnet_trunk(x, sd)
        cpu_s = time.perf_counter() - t0
    scale = float(want.abs().max())
    err = float((feats.cpu() - want).abs().max())
    emit({"phase": "multimodal", "path": "e_resnet_trunk",
          "shape": list(feats.shape), "ms": ms, "cpu_seconds": cpu_s,
          "max_abs_err": err, "scale": scale, "tol": TOL_TRUNK,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32,
          "nvidia_smi": smi})
    check(tuple(feats.shape) == (8, 14, 14, 1024),
          f"multimodal (e): trunk shape {tuple(feats.shape)}")
    check(err <= TOL_TRUNK * scale, f"multimodal (e): trunk {err} of {scale}")

    import importlib.util

    emit({"phase": "multimodal", "not_on_card": {
        "routes": ["the HDF5 cache (h5py)", "real CLEVR ingestion (PIL, "
                   "h5py)", "text checkpoints (transformers)",
                   "checkpoint weights (none in the repo)"],
        "importable_here": {m: importlib.util.find_spec(m) is not None
                            for m in ("h5py", "PIL", "transformers")}}})
    seconds = time.perf_counter() - t_phase
    emit({"phase": "multimodal", "seconds": seconds, "launches": launches,
          "nvidia_smi": smi})
    check(seconds < 60.0, f"multimodal phase took {seconds:.1f} s")
    return launches


# the drivers phase's sweeps: the trials' solver budget. The sweep CLI's
# base takes graphax's 1000 NFE; its trials train through the dopri5 steps
# (no adjoint), whose autograd keeps about two [N, hidden] f32 tensors an
# NFE, 0.17 GB at arxiv's N and hidden 128, so 1000 NFE would not hold two
# trials at once in 80 GB: the phase gives them 64 (``--max_nfe``)
SWEEP_MAX_NFE = 64
# the kernels the arxiv preset's run_gnn must launch (PERF.md rows 1, 3,
# 6, 11, 12, 14), and the sweep's trials on the sparse strategy (rows 1-3)
DRIVER_KERNELS = ("spmm_csr", "attention_pin", "attention_kproj",
                  "windowed_densify", "win_matmul", "win_bwd_slab")
SWEEP_KERNELS = ("spmm_csr", "sddmm", "attention_pin")


class recorded_fits:
    """Within it, every ``Trainer.fit`` (from any thread) appends to
    ``fits`` its Trainer's config, the result, and the graph's strategy,
    node count and train nodes."""

    def __enter__(self):
        import threading

        from graphax_torch.train import loop

        self.fits = []
        self.fit = loop.Trainer.fit
        lock = threading.Lock()
        fit = self.fit

        def recorded(tr, *a, **k):
            out = fit(tr, *a, **k)
            with lock:
                self.fits.append(dict(
                    cfg=tr.cfg, fit=out, strategy=tr.data.graph.strategy,
                    num_nodes=tr.data.num_nodes,
                    train=int(tr.data.train_mask.sum())))
            return out

        loop.Trainer.fit = recorded
        return self

    def __exit__(self, *exc):
        from graphax_torch.train import loop

        loop.Trainer.fit = self.fit
        return False


class busy_share:
    """The card's busy share while the body runs: nvidia-smi's
    ``utilization.gpu`` (the share of its sample period in which a kernel
    ran), read every 0.25 s by a thread; ``mean`` is their mean as a
    fraction, or None where no sample came back."""

    def __enter__(self):
        import threading

        self.samples = []
        self.stop = threading.Event()

        def sample():
            while not self.stop.wait(0.25):
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=utilization.gpu",
                     "--format=csv,noheader,nounits", "--id=0"],
                    capture_output=True, text=True, timeout=30).stdout
                vals = [v.strip() for v in out.splitlines()]
                if vals and vals[0].isdigit():
                    self.samples.append(int(vals[0]) / 100.0)

        self.thread = threading.Thread(target=sample, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self.mean = (sum(self.samples) / len(self.samples)
                     if self.samples else None)
        return False


def sweep_table(out: dict) -> list:
    """A sweep's trial table as compared: each trial's id, config, epochs
    reached (its promotions) and best accuracies, then the replication's
    raw accuracies where it ran."""
    rows = [(t["id"], t["cfg"].to_dict(), t["epochs_done"], t["val_acc"],
             t["test_acc"]) for t in out["trials"]]
    rep = out.get("replication")
    if rep is not None:
        rows.append(("replication", rep["raw_val"], rep["raw_test"]))
    return rows


def run_quiet(fn):
    """``fn()`` with its standard output captured: (result, the output's
    lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


def phase_drivers(smi: str) -> dict:
    """The experiment entry points on the card (`graphax_torch.drivers`,
    `graphax_torch.train.sweep`, `graphax_torch.utils.profiling`), on a
    temporary directory holding ogbn-arxiv's cache from a seed
    (:func:`write_arxiv_files`):

    (a) the README's Quickstart twin, ``run_gnn.main(["--dataset", "Cora",
    "--use_best_params", "--epoch", "2", "--num_splits", "1"])`` on the
    synthetic fallback, then the arxiv preset as published (windowed,
    169,343 nodes, hidden 162, bf16, dopri5, rk4 adjoint) over 2 splits of
    2 epochs: the summary and each split's epoch seconds; finite
    accuracies, n = 2, every fit's solves successful, the launches of
    :data:`DRIVER_KERNELS` nonzero and those the NFE decide as the NFE say
    (:func:`first_order_launches`, the pin and its K table twice an
    epoch);

    (b) ``sweep.main`` on the arxiv cache (the sparse strategy) with 4
    samples, 4 epochs, grace 2, reduction 2, the winner replicated once on
    2 splits, trials at ``--max_nfe`` :data:`SWEEP_MAX_NFE`, once with one
    trial at a time and once with two (two CUDA streams on the card),
    under ``torch.use_deterministic_algorithms`` (the plain scatters sum
    in a fixed order); the two trial tables (configs, promotions, best
    accuracies, the replication's) must be equal, and where they are not
    a second sequential run shows whether one trial order already differs
    from itself; each sweep's wall seconds and the card's busy share
    (:class:`busy_share`); :data:`SWEEP_KERNELS` launched;

    (c) the sequential sweep again with ``--checkpoint_dir`` (no
    replication), then once more on the same directory: the second run
    fits nothing and returns the same best;

    (d) one arxiv epoch (the preset, fit's defaults) under
    ``profile_trace``: the Chrome trace must exist and name ``spmm_walk``
    and ``win_matmul_tc_kernel``; the epoch's edges x NFE per second by
    ``ThroughputMeter``, the device synchronised before the meter's exit.

    Every line carries the card's nvidia-smi line. Returns the launches of
    (a)-(d)."""
    import tempfile

    import numpy as np
    import torch

    from graphax_torch import Trainer, best_config, get_dataset
    from graphax_torch.data.loaders import SHAPES
    from graphax_torch.drivers import run_gnn
    from graphax_torch.drivers import sweep as sweep_cli
    from graphax_torch.kernels import _build
    from graphax_torch.utils.profiling import ThroughputMeter, profile_trace

    t_phase = time.perf_counter()
    launches: dict = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    with tempfile.TemporaryDirectory(prefix="graphax_drivers_") as tmp:
        t0 = time.perf_counter()
        write_arxiv_files(tmp)
        empty = os.path.join(tmp, "no-files")
        os.makedirs(empty)
        emit({"phase": "drivers", "write_seconds": time.perf_counter() - t0,
              "nvidia_smi": smi})

        # (a) run_gnn: the README's command on Cora, then the arxiv preset
        for label, splits, argv in (
                ("a_cora", 1, ["--dataset", "Cora", "--use_best_params",
                               "--epoch", "2", "--num_splits", "1",
                               "--data_dir", empty]),
                ("a_arxiv", 2, ["--dataset", "ogbn-arxiv",
                                "--use_best_params", "--epoch", "2",
                                "--num_splits", "2", "--data_dir", tmp])):
            with recorded_fits() as rec:
                (summary, lines), counts, secs, peak = _counted(
                    lambda: run_quiet(lambda: run_gnn.main(argv)))
            fits = rec.fits
            emit({"phase": "drivers", "path": label, "argv": argv,
                  "stdout": lines, "summary": summary, "seconds": secs,
                  "epoch_seconds": [[h["time"] for h in r["fit"]["history"]]
                                    for r in fits],
                  "solver": [r["fit"]["solver"] for r in fits],
                  "graphs": [{k: r[k] for k in ("strategy", "num_nodes",
                                                "train")} for r in fits],
                  "launches": counts, "peak_mem_gib": peak,
                  "nvidia_smi": smi})
            check(len(fits) == splits and json.loads(lines[-1]) == summary,
                  f"drivers {label}: {len(fits)} fits, summary line "
                  f"{lines[-1]}")
            for part in ("val", "test"):
                check(summary[part]["n"] == splits and all(
                    math.isfinite(v) for v in summary[part].values()),
                      f"drivers {label}: {part} {summary[part]}")
            for r in fits:
                for h, sv in zip(r["fit"]["history"], r["fit"]["solver"]):
                    check(math.isfinite(h["loss"]) and bool(sv["success"])
                          and bool(sv["eval_success"]),
                          f"drivers {label} epoch {h['epoch']}: {h} {sv}")
            add(counts)
        for r in fits:
            cfg = r["cfg"]
            check(r["strategy"] == "windowed"
                  and r["num_nodes"] == SHAPES["ogbn-arxiv"]["num_nodes"]
                  and r["train"] == ARXIV_SPLIT[0]
                  and cfg.hidden_dim == 162 and cfg.dtype == "bfloat16",
                  f"drivers a_arxiv: not the preset on the cache: {r}")
        want = {}
        for r in fits:
            for k, v in first_order_launches("laplacian", "windowed",
                                             r["fit"]).items():
                want[k] = want.get(k, 0) + v
        # the pin (with its K table) in each epoch's train step and
        # evaluation
        want["attention_pin"] = want["attention_kproj"] = 2 * 2 * len(fits)
        emit({"phase": "drivers", "path": "a_arxiv", "launches": counts,
              "expected_launches": want, "nvidia_smi": smi})
        for k in DRIVER_KERNELS:
            check(counts.get(k, 0) > 0,
                  f"{k} never launched on run_gnn's arxiv path ({counts})")
        for k, v in want.items():
            check(counts.get(k, 0) == v, f"drivers a_arxiv: {k} launched "
                  f"{counts.get(k, 0)} times, the NFE say {v}")

        # (b) the sweep, one trial at a time and two at once
        argv = ["--dataset", "ogbn-arxiv", "--data_dir", tmp,
                "--num_samples", "4", "--max_epochs", "4",
                "--grace_period", "2", "--reduction_factor", "2",
                "--num_splits", "2", "--max_nfe", str(SWEEP_MAX_NFE)]
        fill = torch.utils.deterministic.fill_uninitialized_memory
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = False
        try:
            sweeps, walls = {}, {}
            for label, extra in (("b_sequential", ["--max_concurrent", "1"]),
                                 ("b_two_streams",
                                  ["--max_concurrent", "2"])):
                extra = ["--replicate_reps", "1"] + extra
                with recorded_fits() as rec, busy_share() as busy:
                    (out, lines), counts, secs, peak = _counted(
                        lambda: run_quiet(lambda: sweep_cli.main(
                            argv + extra)))
                sweeps[label] = out
                walls[label] = {"seconds": secs, "busy_share": busy.mean}
                emit({"phase": "drivers", "path": label,
                      "argv": argv + extra, "stdout": lines,
                      "seconds": secs, "busy_share": busy.mean,
                      "busy_samples": len(busy.samples),
                      "fits": len(rec.fits),
                      "trials": [{**{k: v for k, v in t.items()
                                     if k != "cfg"},
                                  **{k: v for k, v in t["cfg"].to_dict()
                                     .items() if k in sweep_cli.REPORTED}}
                                 for t in out["trials"]],
                      "replication": out["replication"],
                      "launches": counts, "peak_mem_gib": peak,
                      "nvidia_smi": smi})
                for k in SWEEP_KERNELS:
                    check(counts.get(k, 0) > 0,
                          f"{k} never launched in the {label} sweep "
                          f"({counts})")
                add(counts)
            seq, conc = (sweep_table(sweeps[k])
                         for k in ("b_sequential", "b_two_streams"))
            if seq != conc:
                again, _ = run_quiet(lambda: sweep_cli.main(
                    argv + ["--replicate_reps", "1", "--max_concurrent",
                            "1"]))
                again = sweep_table(again)
                emit({"phase": "drivers", "path": "b_differ",
                      "rows_two_streams_differ": [
                          i for i, (a, b) in enumerate(zip(seq, conc))
                          if a != b],
                      "rows_sequential_repeat_differ": [
                          i for i, (a, b) in enumerate(zip(seq, again))
                          if a != b], "nvidia_smi": smi})
                check(False, "drivers (b): the sweep with two streams "
                      "differs from the sequential one" + (
                          "; so does a second sequential run" if again !=
                          seq else ", which repeats bit for bit"))
            emit({"phase": "drivers", "path": "b_compare",
                  "tables_equal": True, "trials": len(seq) - 1,
                  **walls, "nvidia_smi": smi})

            # (c) resume: the sequential sweep with a checkpoint directory,
            # twice
            ckpt = os.path.join(tmp, "sweep_ckpt")
            argv_c = argv + ["--max_concurrent", "1", "--checkpoint_dir",
                             ckpt]
            runs = []
            for _ in range(2):
                with recorded_fits() as rec:
                    (out, lines), counts, secs, _ = _counted(
                        lambda: run_quiet(lambda: sweep_cli.main(argv_c)))
                runs.append((out, len(rec.fits), secs))
                add(counts)
            (first, fits1, s1), (second, fits2, s2) = runs
            emit({"phase": "drivers", "path": "c_resume", "argv": argv_c,
                  "fits": [fits1, fits2], "seconds": [s1, s2],
                  "best_val": [first["best_val"], second["best_val"]],
                  "files": sorted(os.listdir(ckpt)), "nvidia_smi": smi})
            check(fits1 > 0 and fits2 == 0,
                  f"drivers (c): the resumed sweep ran {fits2} fits")
            best = [{k: v for k, v in r["best_config"].to_dict().items()
                     if k in sweep_cli.REPORTED} for r in (first, second)]
            check(second["best_val"] == first["best_val"]
                  and second["best_test"] == first["best_test"]
                  and best[0] == best[1],
                  f"drivers (c): the resumed sweep's best moved: {best}")
        finally:
            torch.use_deterministic_algorithms(False)
            torch.utils.deterministic.fill_uninitialized_memory = fill

        # (d) one arxiv epoch under the profiler, and its edges x NFE / s
        cfg = best_config("ogbn-arxiv")
        tr = Trainer(cfg, get_dataset(cfg, data_dir=tmp,
                                      synthetic_fallback=False))
        graph = tr.data.graph
        trace_dir = os.path.join(tmp, "trace")
        meter = ThroughputMeter(units_per_call=0.0)
        _build.LAUNCHES.clear()
        torch.cuda.synchronize()
        with profile_trace(trace_dir):
            with meter:
                fit = tr.fit(epochs=1)
                torch.cuda.synchronize()
                sv = fit["solver"][0]
                nfe = sv["nfe"] + sv["bwd_nfe"] + sv["eval_nfe"]
                meter.units = float(graph.num_edges) * nfe
        counts = dict(_build.LAUNCHES)
        trace = os.path.join(trace_dir, "trace.json")
        check(os.path.exists(trace), "drivers (d): no trace file")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        kernels = {}
        for ev in events:
            if ev.get("cat") == "kernel":
                for name in ("spmm_walk", "win_matmul_tc_kernel"):
                    if name in ev.get("name", ""):
                        kernels[name] = kernels.get(name, 0) + 1
        emit({"phase": "drivers", "path": "d_profile",
              "trace_mib": os.path.getsize(trace) / 2 ** 20,
              "events": len(events), "kernel_events": kernels,
              "epoch_seconds": fit["history"][0]["time"],
              "meter_seconds": meter.total_time, "edges": graph.num_edges,
              "nfe": [sv["nfe"], sv["bwd_nfe"], sv["eval_nfe"]],
              "edges_nfe_per_s": meter.rate, "launches": counts,
              "nvidia_smi": smi})
        for name in ("spmm_walk", "win_matmul_tc_kernel"):
            check(kernels.get(name, 0) > 0,
                  f"drivers (d): the trace names no {name} kernel")
        add(counts)
        del tr, graph, fit
        torch.cuda.empty_cache()
    emit({"phase": "drivers", "seconds": time.perf_counter() - t_phase,
          "launches": launches, "nvidia_smi": smi})
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=3,
                    help="epochs of each path")
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

    # 3. data, and the Trainers of both paths
    t0 = time.perf_counter()
    data = get_dataset("ogbn-arxiv")
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    cfg = best_config("ogbn-arxiv")
    check(cfg.community_window == 512, "the preset's community_window moved")
    trainer = Trainer(cfg, data)
    torch.cuda.synchronize()
    graph = trainer.data.graph
    wl = graph.windows
    check(graph.strategy == "windowed" and wl is not None,
          f"the preset's graph is {graph.strategy}, not windowed")
    emit({"phase": "data", "seconds": data_s,
          "num_nodes": graph.num_nodes, "num_edges": graph.num_edges,
          "edge_buffer": graph.edge_buffer_size,
          "num_features": data.num_features, "num_classes": data.num_classes,
          "state_dim": trainer.model.state_dim, "dtype": cfg.dtype})
    emit({"phase": "layout", "strategy": graph.strategy,
          "community_window": cfg.community_window,
          "in_window_edges": wl.in_window_edges,
          "residual_edges": wl.residual.num_slots, "T": wl.num_tiles,
          "tile": wl.tile, "W": wl.window, "Wn": wl.num_windows, "hub": None,
          "reorder_seconds": trainer.reorder_seconds})
    for k in ("in_window_edges", "num_tiles", "num_windows"):
        check(getattr(wl, k) > 0, f"windowed layout: {k} is 0")
    cfg0 = best_config("ogbn-arxiv", community_window=0)
    trainer0 = Trainer(cfg0, data)
    check(trainer0.data.graph.strategy == "sparse",
          "the community_window=0 graph is not sparse")
    # GRAND-nl at the preset's widths (constant block, transformer RHS,
    # sparse strategy), one Trainer evaluated and one trained, both from
    # the same random Q/K
    cfg_nl = best_config("ogbn-arxiv", block="constant",
                         function="transformer", community_window=0)
    trainer_nl = Trainer(cfg_nl, data)
    check(trainer_nl.data.graph.strategy == "sparse",
          "the GRAND-nl graph is not sparse")
    randomize_attention(trainer_nl.model.block.func.att, 11)
    trainer_nlt = nl_trainer(cfg_nl, data)
    # GRAND-nl on the preset's windowed strategy as published (K5's route),
    # and with column normalisation on CSR (the three-kernel route)
    cfg_nlw = best_config("ogbn-arxiv", block="constant",
                          function="transformer")
    check(cfg_nlw.community_window == 512, "the preset's window moved")
    trainer_nlw = nl_trainer(cfg_nlw, data)
    check(trainer_nlw.data.graph.strategy == "windowed",
          "the windowed GRAND-nl graph is not windowed")
    cfg_nlc = best_config("ogbn-arxiv", block="constant",
                          function="transformer", community_window=0,
                          attention_norm_idx=1)
    trainer_nlc = nl_trainer(cfg_nlc, data)
    # the dense strategy: Computers and Photo as published, and GRAND-nl
    # evaluated at Computers' widths (constant block, transformer RHS)
    dense = {}
    for name in ("Computers", "Photo"):
        t0 = time.perf_counter()
        d_ = get_dataset(name)
        tr_ = Trainer(best_config(name), d_)
        torch.cuda.synchronize()
        check(tr_.data.graph.strategy == "dense",
              f"the {name} graph is {tr_.data.graph.strategy}, not dense")
        emit({"phase": "data", "dataset": name, "seconds":
              time.perf_counter() - t0, "num_nodes": d_.num_nodes,
              "num_edges": d_.graph.num_edges,
              "num_features": d_.num_features,
              "num_classes": d_.num_classes,
              "state_dim": tr_.model.state_dim, "dtype": tr_.cfg.dtype,
              "strategy": "dense"})
        dense[name] = (d_, tr_)
    trainer_nld = Trainer(best_config("Computers", function="transformer",
                                      block="constant"), dense["Computers"][0])
    randomize_attention(trainer_nld.model.block.func.att, 11)

    # 4. kernels against their plain versions
    results: dict = {}
    phase_kernels(trainer0.data.graph, results)
    phase_windowed_kernels(graph, results)
    phase_flash_kernels(trainer_nl, results)
    phase_kproj_kernels(dense, results)
    phase_train_kernels(trainer_nl, results)
    phase_three_kernel_kernels(trainer_nlw, trainer_nlc, results)
    phase_hub_kernels(trainer_nl, results)
    phase_dense_kernels(trainer_nld, results)
    emit({"phase": "kernels",
          "ported": list(dict.fromkeys(k[0] for k in results))})

    # 5. the main path, then the earlier community_window=0 path
    launches = {}
    epoch_s = {}
    for label, tr in (("windowed", trainer), ("sparse", trainer0)):
        _build.LAUNCHES.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fit = tr.fit(epochs=args.epochs)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        for h, sv in zip(fit["history"], fit["solver"]):
            emit({"phase": "slice", "path": label, **h, **sv})
        epoch_s[label] = [h["time"] for h in fit["history"]]
        emit({"phase": "slice", "path": label,
              "community_window": tr.cfg.community_window,
              "seconds": time.perf_counter() - t0, "launches": counts,
              "best": fit["best"],
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
        for h, sv in zip(fit["history"], fit["solver"]):
            check(math.isfinite(h["loss"]),
                  f"{label} epoch {h['epoch']}: loss not finite")
            check(bool(sv["success"]),
                  f"{label} epoch {h['epoch']}: solver failed")
            for k in ("train_acc", "val_acc", "test_acc"):
                check(0.0 <= h[k] <= 1.0,
                      f"{label} epoch {h['epoch']}: {k} out of range")
        need = ("windowed_densify", "win_matmul", "win_bwd_slab", "spmm_csr",
                "attention_pin") if label == "windowed" \
            else ("spmm_csr", "attention_pin")
        for k in need:
            check(counts.get(k, 0) > 0,
                  f"{k} never launched on the {label} path")
        check(counts.get("attention_kproj", 0) == counts["attention_pin"],
              f"{label}: the pin launched attention_kproj "
              f"{counts.get('attention_kproj', 0)} times in "
              f"{counts['attention_pin']} calls")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    steady = {k: min(v[1:]) if len(v) > 1 else v[0]
              for k, v in epoch_s.items()}
    emit({"phase": "slice", "epoch_seconds": epoch_s,
          "steady_epoch_seconds": steady,
          "windowed_over_sparse": steady["windowed"] / steady["sparse"]})
    # GRAND-nl's evaluation: the preset's softmax three times, then the
    # squareplus variant (the gmax kernel's path) once
    trainer_sp = Trainer(cfg_nl.replace(square_plus=True), data)
    randomize_attention(trainer_sp.model.block.func.att, 11)
    for label, tr, evals in (("grand_nl", trainer_nl, 3),
                             ("grand_nl_squareplus", trainer_sp, 1)):
        for k, v in phase_grand_nl(tr, label, evals).items():
            launches[k] = launches.get(k, 0) + v
    del trainer_sp
    # GRAND-nl trained: fit, adjoint rk4 through the training kernels
    for k, v in phase_grand_nl_train(trainer_nlt, args.epochs).items():
        launches[k] = launches.get(k, 0) + v
    # GRAND-nl on the windowed strategy: three evaluations, then fit (rk4
    # adjoint through the replay of the plain twin)
    per_w = ("attention_kproj", "attention_gmax", "attention_norm", "winatt",
             "attention_attspmm")
    for k, v in phase_grand_nl(trainer_nlw, "grand_nl_windowed", 3,
                               per_nfe=per_w).items():
        launches[k] = launches.get(k, 0) + v
    for k, v in phase_grand_nl_train(trainer_nlw, args.epochs,
                                     "grand_nl_windowed_train",
                                     TRAIN_WINDOWED).items():
        launches[k] = launches.get(k, 0) + v
    # column normalisation: a softmax and a squareplus evaluation, then fit
    per_c = ("attention_kproj", "attention_gmax", "attention_norm",
             "attention_attspmm")
    trainer_nlcs = nl_trainer(cfg_nlc.replace(square_plus=True), data)
    for label, tr in (("grand_nl_colnorm", trainer_nlc),
                      ("grand_nl_colnorm_squareplus", trainer_nlcs)):
        for k, v in phase_grand_nl(tr, label, 1, per_nfe=per_c).items():
            launches[k] = launches.get(k, 0) + v
    del trainer_nlcs
    for k, v in phase_grand_nl_train(trainer_nlc, 2, "grand_nl_colnorm_train",
                                     TRAIN_COLNORM).items():
        launches[k] = launches.get(k, 0) + v
    # the dense strategy: Computers and Photo through fit's defaults, then
    # GRAND-nl's dense evaluation through flash_dense
    for name, (_, tr_) in dense.items():
        for k, v in phase_dense_fit(name, tr_, args.epochs).items():
            launches[k] = launches.get(k, 0) + v
    for k, v in phase_grand_nl(trainer_nld, "grand_nl_dense", 3,
                               per_nfe=("flash_dense",)).items():
        launches[k] = launches.get(k, 0) + v
    # GRAND-nl trained outside the hand-written backward: the dense route
    # (K6 in the forward solve and the evaluation), Cora's autograd
    # through the steps, CoauthorCS past the dense guard, squareplus on CSR
    # and column normalisation on the windowed graph
    routes_launches, trainer_nldt = phase_grand_nl_routes_train(
        data, dense["Computers"][0], args.epochs)
    for k, v in routes_launches.items():
        launches[k] = launches.get(k, 0) + v
    # the attention block: the four presets on their stand-ins (dense),
    # then at the arxiv widths on CSR and on the windowed layout (sddmm
    # once per adjoint NFE)
    counts, trainer_pub = phase_attention_presets(args.epochs)
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    for k, v in phase_attention_block_csr(data, results,
                                          args.epochs).items():
        launches[k] = launches.get(k, 0) + v
    # the preset at the reference's f32 on its windowed layout, and the
    # attention block in f32 there: the f32 bodies of the windowed products
    f32_launches, (tr_f32, tr_f32a) = phase_f32_windowed(data, args.epochs)
    for k, v in f32_launches.items():
        launches[k] = launches.get(k, 0) + v

    # 6. where the time goes, on the windowed path: win_bwd_slab once per
    # adjoint NFE, dx in x's dtype straight from it
    _build.LAUNCHES.clear()
    bd = phase_breakdown([("graphax_torch.train_step", trainer.train_step),
                          ("graphax_torch.evaluate", trainer.evaluate)],
                         after="win_bwd_slab")
    bd["after"]["adjoint_nfe"] = trainer.bm.get_value()
    emit({"phase": "breakdown", "path": "windowed", **bd})
    check(bd["after"]["launches"] == _build.LAUNCHES["win_bwd_slab"]
          == bd["after"]["adjoint_nfe"] > 0,
          f"the windowed profile: win_bwd_slab {bd['after']} against "
          f"{_build.LAUNCHES['win_bwd_slab']} launches")
    emit({"phase": "breakdown", "path": "grand_nl",
          **phase_breakdown([("graphax_torch.evaluate", trainer_nl.evaluate)])})
    emit({"phase": "breakdown", "path": "grand_nl_train",
          **phase_breakdown([("graphax_torch.train_step",
                              trainer_nlt.train_step)])})
    # path A: win_bwd_dense once per adjoint NFE, its bf16 blocks handed
    # on as they are (no cast kernel of its own after it)
    _build.LAUNCHES.clear()
    bd = phase_breakdown([("graphax_torch.train_step",
                           trainer_nlw.train_step),
                          ("graphax_torch.evaluate", trainer_nlw.evaluate)],
                         after="win_bwd_dense")
    bd["after"]["adjoint_nfe"] = trainer_nlw.bm.get_value()
    emit({"phase": "breakdown", "path": "grand_nl_windowed_train", **bd})
    check(bd["after"]["launches"] == _build.LAUNCHES["win_bwd_dense"]
          == bd["after"]["adjoint_nfe"] > 0,
          f"path A's profile: win_bwd_dense {bd['after']} against "
          f"{_build.LAUNCHES['win_bwd_dense']} launches")
    emit({"phase": "breakdown", "path": "grand_nl_colnorm_train",
          **phase_breakdown([("graphax_torch.train_step",
                              trainer_nlc.train_step)])})
    tr_c = dense["Computers"][1]
    emit({"phase": "breakdown", "path": "Computers",
          **phase_breakdown([("graphax_torch.train_step", tr_c.train_step),
                             ("graphax_torch.evaluate",
                              tr_c.evaluate_early)])})
    emit({"phase": "breakdown", "path": "grand_nl_dense",
          **phase_breakdown([("graphax_torch.evaluate",
                              trainer_nld.evaluate)])})
    emit({"phase": "breakdown", "path": "grand_nl_dense_train",
          **phase_breakdown([("graphax_torch.train_step",
                              trainer_nldt.train_step),
                             ("graphax_torch.evaluate",
                              trainer_nldt.evaluate_early)],
                            sums=("flash_dense",))})
    del trainer_nldt
    emit({"phase": "breakdown", "path": "Pubmed",
          **phase_breakdown([("graphax_torch.train_step",
                              trainer_pub.train_step),
                             ("graphax_torch.evaluate",
                              trainer_pub.evaluate_early)])})
    del trainer_pub
    # the f32 windowed path: the f32 bodies' device ms, each launch of
    # win_matmul (and in the attention block's step, of win_bwd_dense) the
    # f32 body's
    f32_bodies = ("win_matmul_f32", "win_bwd_dense_f32", "win_bwd_slab_f32")
    for label, tr_, steps, kernel in (
            ("f32_windowed", tr_f32,
             [("graphax_torch.train_step", tr_f32.train_step),
              ("graphax_torch.evaluate", tr_f32.evaluate)], "win_matmul"),
            ("f32_windowed_attention", tr_f32a,
             [("graphax_torch.train_step", tr_f32a.train_step)],
             "win_bwd_dense")):
        _build.LAUNCHES.clear()
        bd = phase_breakdown(steps, after=kernel + "_f32", sums=f32_bodies)
        bd["after"]["adjoint_nfe"] = tr_.bm.get_value()
        emit({"phase": "breakdown", "path": label, **bd})
        check(bd["after"]["launches"] == _build.LAUNCHES[kernel] > 0,
              f"the {label} profile: {kernel}'s f32 body {bd['after']} "
              f"against {_build.LAUNCHES[kernel]} launches")
    del tr_f32, tr_f32a, tr_

    # 7. small references: the card against the CPU
    emit({"phase": "reference", **phase_reference()})
    emit({"phase": "reference", **phase_reference(window=64)})
    emit({"phase": "reference", **phase_reference_nl()})
    emit({"phase": "reference", **phase_reference_nl_train()})
    emit({"phase": "reference", **phase_reference_dense()})
    emit({"phase": "reference", "block": "attention",
          **phase_reference_attention()})
    emit({"phase": "reference", **phase_reference_nl_routes()})

    # 8. the real dataset formats: Cora, Computers and ogbn-arxiv from
    # full-size files, a checkpoint resumed, the label trick at D 202
    for k, v in phase_real_formats(smi).items():
        launches[k] = launches.get(k, 0) + v

    # 9. BLEND: DeepWalk's encodings, the Beltrami pin and flash, kNN and
    # edge-sampling rewiring, GAT
    blend_launches = phase_blend(data, smi, results, args.epochs)
    for k, v in blend_launches.items():
        launches[k] = launches.get(k, 0) + v

    # 10. the rest of the single-graph model surface: the windowed adaptive
    # adjoint, the regularisers through the kernels' second derivatives,
    # Adams, the higher-order, rewire, hard-block and CGNN models
    surface_launches, second = phase_surface(trainer, trainer0, smi, results)
    for k, v in surface_launches.items():
        launches[k] = launches.get(k, 0) + v

    # 11. the multimodal family: run_multi on MNIST's preset and the
    # CLEVR-style data, per-sample chain graphs on their union, card
    # against CPU, the ResNet-101 trunk
    mm_launches = phase_multimodal(smi)
    for k, v in mm_launches.items():
        launches[k] = launches.get(k, 0) + v

    # 12. the experiment entry points: run_gnn (the README's Quickstart) on
    # Cora and the arxiv preset, the sweep with one trial at a time and
    # two on two streams, its resume, one arxiv epoch under the profiler
    drv_launches = phase_drivers(smi)
    for k, v in drv_launches.items():
        launches[k] = launches.get(k, 0) + v

    # the kernels line (launches summed over the paths of phases 5 and
    # 8-12):
    # times from phase 4 at the main path's shapes and
    # dtype (bf16); spmm_csr's at the residual edges, with its whole-graph
    # numbers (the community_window=0 path), the hub graph's and f32's
    # beside them; the pin's f32 (the windowed and dense strategies') and
    # hub graph's beside its bf16 (CSR)
    kernels = []
    specs = (("spmm_csr", ("spmm_csr", "bfloat16", "residual A.x"),
              "graphax_torch/kernels/csrc/spmm.cu",
              "graphax/kernels/pallas_tiled.py:79"),
             ("sddmm", ("sddmm", "bfloat16"),
              "graphax_torch/kernels/csrc/spmm.cu",
              "graphax/kernels/pallas_tiled.py:146"),
             ("attention_pin", ("attention_pin", "bfloat16"),
              "graphax_torch/kernels/csrc/attention_pin.cu",
              "graphax/kernels/pallas_attention.py:114"),
             ("windowed_densify", ("windowed_densify", "bfloat16"),
              "graphax_torch/kernels/csrc/windowed_spmm.cu",
              "graphax/kernels/pallas_windows.py:57"),
             ("win_matmul", ("win_matmul", "bfloat16"),
              "graphax_torch/kernels/csrc/windowed_spmm.cu",
              "graphax/kernels/pallas_windows.py:185"),
             ("win_bwd_dense", ("win_bwd_dense", "bfloat16", "bf16_out"),
              "graphax_torch/kernels/csrc/windowed_spmm.cu",
              "graphax/kernels/pallas_windows.py:214"),
             ("win_bwd_slab", ("win_bwd_slab", "bfloat16", "bf16_out"),
              "graphax_torch/kernels/csrc/windowed_spmm.cu",
              "graphax/kernels/pallas_windows.py:243"),
             ("flash_attention", ("flash_attention", "bfloat16"),
              "graphax_torch/kernels/csrc/fused_attention.cu",
              "graphax/kernels/pallas_attention.py:359"),
             ("attention_gmax", ("attention_gmax", "bfloat16"),
              "graphax_torch/kernels/csrc/fused_attention.cu",
              "graphax/kernels/pallas_attention.py:481"),
             ("attention_kproj", ("attention_kproj", "bfloat16"),
              "graphax_torch/kernels/csrc/fused_attention.cu",
              "graphax/kernels/pallas_attention.py:382"),
             ("attention_fwd_res", ("attention_fwd_res", "bfloat16"),
              "graphax_torch/kernels/csrc/fused_attention.cu",
              "graphax/kernels/pallas_attention.py:266"),
             ("attention_bwd_rows", ("attention_bwd_rows", "bfloat16"),
              "graphax_torch/kernels/csrc/fused_attention.cu",
              "graphax/kernels/pallas_attention.py:576"),
             ("attention_bwd_cols", ("attention_bwd_cols", "bfloat16"),
              "graphax_torch/kernels/csrc/fused_attention.cu",
              "graphax/kernels/pallas_attention.py:727"),
             ("flash_dense", ("flash_dense", "float32"),
              "graphax_torch/kernels/csrc/flash_dense.cu",
              "graphax/kernels/pallas_ops.py:27"),
             ("attention_norm", ("attention_norm", "bfloat16", "windowed"),
              "graphax_torch/kernels/csrc/fused_attention.cu",
              "graphax/kernels/pallas_attention.py:197"),
             ("attention_attspmm", ("attention_attspmm", "bfloat16", "row"),
              "graphax_torch/kernels/csrc/fused_attention.cu",
              "graphax/kernels/pallas_attention.py:266"),
             ("winatt", ("winatt", "bfloat16"),
              "graphax_torch/kernels/csrc/winatt.cu",
              "graphax/kernels/pallas_winatt.py:43"))
    for name, key, src, repl in specs:
        r = results[key]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches.get(name, 0),
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "library": r.get("library"), "dtype": key[1]})
    walked = ("max_abs_err", "ms", "plain_ms", "bound_ms", "all_miss_ms")
    numbers = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")
    spmm = kernels[0]
    spmm["all_miss_ms"] = results[("spmm_csr", "bfloat16",
                                   "residual A.x")]["all_miss_ms"]
    for tag in ("residual AT.g", "A.x", "AT.g", "hub A.x", "hub AT.g"):
        r = results[("spmm_csr", "bfloat16", tag)]
        spmm[tag.replace(" ", "_").replace(".", "")] = {
            k: r.get(k) for k in walked + ("library_ms",)}
    spmm["float32"] = {
        tag.replace(" ", "_").replace(".", ""): {
            k: results[("spmm_csr", "float32", tag)].get(k)
            for k in walked}
        for tag in ("residual A.x", "A.x", "hub A.x")}
    spmm["launches_count"] = (
        "wrapper calls: each runs spmm_walk, and where a row has more than "
        "ROW_SPLIT edges spmm_seg_sum and seg_combine")
    sd = kernels[1]
    sd["all_miss_ms"] = results[("sddmm", "bfloat16")]["all_miss_ms"]
    sd["windowed_residual"] = {
        k: results[("sddmm", "bfloat16", "windowed residual")].get(k)
        for k in numbers}
    for tag in ("hub", "hub transposed"):
        sd[tag.replace(" ", "_")] = {
            k: results[("sddmm", "bfloat16", tag)].get(k) for k in walked}
    sd["float32"] = {k: results[("sddmm", "float32")].get(k)
                     for k in walked + ("library_ms",)}
    sd["launches_count"] = (
        "wrapper calls: one per adjoint NFE of the attention block's train "
        "steps (the pinned values' gradient) on the CSR and the windowed "
        "residual")
    pin = kernels[2]
    pin["also_replaces"] = "graphax/kernels/pallas_attention.py:197"
    pin["all_miss_ms"] = results[("attention_pin", "bfloat16")]["all_miss_ms"]
    pin["float32"] = {k: results[("attention_pin", "float32")].get(k)
                      for k in walked}
    pin["hub"] = {k: results[("attention_pin", "bfloat16", "hub")].get(k)
                  for k in walked}
    pin["launches_count"] = (
        "wrapper calls: each runs attention_kproj (kproj_tc_kernel in bf16, "
        "kproj_kernel in f32; counted under attention_kproj too) and "
        "pin_kernel, and where a row has more than 32 edges pin_seg_stats "
        "and pin_seg_write")
    kernels[5]["variant"] = ("bf16 in, bf16 out (the blocks' dtype, as path "
                             "A runs it); f32_out: graphax's f32 output")
    kernels[5]["f32_out"] = {
        k: results[("win_bwd_dense", "bfloat16")][k]
        for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms")}
    kernels[4]["variant"] = ("with the residual SpMM's result added in the "
                             "epilogue, as the main path calls it")
    # the f32 bodies (the preset at the reference's f32, and the attention
    # block's blocks' gradient in f32): their numbers and their launches
    # on that path
    for i, name, tags in ((4, "win_matmul", ((), )),
                          (5, "win_bwd_dense", ((), ("bf16_out",))),
                          (6, "win_bwd_slab", ((), ))):
        kernels[i]["float32"] = {
            "_".join(("f32_in",) + tag) if tag else "f32_in": {
                k: results[(name, "float32") + tag].get(k)
                for k in numbers + ("staging",)}
            for tag in tags}
        kernels[i]["float32_launches"] = f32_launches.get(name, 0)
    slab = results[("win_bwd_slab", "bfloat16")]
    kernels[6]["variant"] = ("bf16 in, bf16 out (x's dtype, as the main path "
                             "runs it); f32_out: graphax's f32 sums")
    kernels[6]["f32_out"] = {k: slab[k] for k in numbers}
    kernels[6]["two_calls"] = slab["two_calls"]
    kernels[6]["two_calls_ms"] = slab["two_calls_ms"]
    kproj = kernels[9]
    for tag in ("arxiv", "Computers", "Photo", "D400 A120"):
        r = results[("attention_kproj", "float32", tag)]
        kproj["float32 " + tag] = {k: r[k] for k in numbers}
    kproj["float32_launches"] = (
        "the pin's: once per attention_pin call (f32 on the windowed arxiv "
        "preset, Computers and Photo), counted under attention_kproj")
    pin["float32 D400 A120"] = {
        k: results[("attention_pin", "float32", "D400 A120")].get(k)
        for k in walked}
    flash = results[("flash_attention", "bfloat16")]
    kernels[7]["all_miss_ms"] = flash["all_miss_ms"]
    kernels[7]["function_ms"] = flash["function_ms"]
    kernels[7]["function_bound_ms"] = flash["function_bound_ms"]
    for tag in ("squareplus", "bf16_out", "hub", "hub squareplus"):
        kernels[7][tag.replace(" ", "_")] = {
            k: results[("flash_attention", "bfloat16", tag)].get(k)
            for k in walked}
    kernels[7]["launches_count"] = (
        "wrapper calls: each runs flash_kernel, and where a row has more "
        "than 32 edges flash_seg_stats, flash_seg_sum and seg_combine")
    kernels[9]["also_replaces"] = ("the K projection inside "
                                   "graphax/kernels/pallas_attention.py:481 "
                                   "(:496)")
    kernels[10]["also_replaces"] = [
        "graphax/kernels/pallas_attention.py:114",
        "graphax/kernels/pallas_attention.py:197"]
    kernels[10]["variant"] = ("K1 + K2 + K3 with residuals: the training "
                              "forward, scores/shift/denominator kept")
    kernels[11]["also_replaces"] = "graphax/kernels/pallas_attention.py:659"
    for i, k in ((10, "attention_fwd_res"), (11, "attention_bwd_rows")):
        kernels[i]["all_miss_ms"] = results[(k, "bfloat16")]["all_miss_ms"]
        kernels[i]["float32"] = {
            t: results[(k, "float32")].get(t) for t in walked}
        for tag in ("hub", "hub transposed"):
            kernels[i][tag.replace(" ", "_")] = {
                t: results[(k, "bfloat16", tag)].get(t) for t in walked}
    kernels[10]["launches_count"] = (
        "wrapper calls: each runs fwd_res_kernel, and where a row has more "
        "than 32 edges flash_seg_stats, flash_seg_sum and seg_combine")
    kernels[11]["launches_count"] = (
        "wrapper calls: each runs bwd_rows_kernel, and where a row has more "
        "than 32 edges bwd_rows_seg_dq and seg_combine")
    kernels[12]["all_miss_ms"] = results[
        ("attention_bwd_cols", "bfloat16")]["all_miss_ms"]
    kernels[12]["float32"] = {k: results[("attention_bwd_cols",
                                          "float32")].get(k) for k in walked}
    kernels[12]["hub_transposed"] = {
        k: results[("attention_bwd_cols", "bfloat16", "hub transposed")].get(k)
        for k in walked}
    kernels[12]["launches_count"] = (
        "wrapper calls: each runs bwd_cols_kernel, and where a column has "
        "more than 32 slots seg_combine for dk and for dxv")
    fd = results[("flash_dense", "bfloat16")]
    kernels[13]["library"] = results[("flash_dense", "float32")].get(
        "library")
    kernels[13]["csr_flash_attention_ms"] = results[
        ("flash_dense", "float32")]["csr_flash_attention_ms"]
    kernels[13]["bfloat16"] = {
        k: fd.get(k) for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms",
                               "csr_flash_attention_ms")}
    kernels[14]["also_replaces"] = "graphax/kernels/pallas_attention.py:114"
    kernels[14]["variant"] = ("K1 + K2 under one shift for every row: the "
                              "windowed residual under r0")
    kernels[14]["all_miss_ms"] = results[
        ("attention_norm", "bfloat16", "windowed")]["all_miss_ms"]
    kernels[14]["colnorm"] = {k: results[("attention_norm", "bfloat16",
                                          "colnorm")][k] for k in numbers}
    kernels[14]["hub"] = {k: results[("attention_norm", "bfloat16",
                                      "hub")].get(k) for k in walked}
    kernels[14]["launches_count"] = (
        "wrapper calls: each runs norm_kernel, and where a row has more "
        "than NORM_CUT slots seg_combine")
    kernels[15]["variant"] = ("K3 against K5's row denominators on the "
                              "windowed residual")
    kernels[15]["all_miss_ms"] = results[
        ("attention_attspmm", "bfloat16", "row")]["all_miss_ms"]
    pc = results[("attention_attspmm", "bfloat16", "per_column")]
    kernels[15]["per_column"] = {k: pc[k] for k in numbers + ("all_miss_ms",)}
    kernels[15]["per_column"]["function_ms"] = pc["function_ms"]
    for tag in ("row route", "per_column route", "hub row",
                "hub per_column"):
        kernels[15][tag.replace(" ", "_")] = {
            k: results[("attention_attspmm", "bfloat16", tag)].get(k)
            for k in walked}
    kernels[15]["launches_count"] = (
        "wrapper calls: each runs attspmm_kernel, and where a row has more "
        "than ROW_SPLIT edges attspmm_seg_sum and seg_combine")
    kernels[16]["function_ms"] = results[("winatt", "bfloat16")][
        "function_ms"]
    kernels[16]["long_rows"] = {k: results[
        ("winatt", "bfloat16", "long rows")].get(k) for k in walked}
    kernels[8]["variant"] = "the whole arxiv CSR (squareplus's shift)"
    for tag in ("windowed", "colnorm", "hub", "long rows residual"):
        kernels[8][tag.replace(" ", "_")] = {
            k: results[("attention_gmax", "bfloat16", tag)].get(k)
            for k in walked}
    # beltrami_exp (phase 9): the pin, the norm, flash, gmax and the K
    # projection at the Beltrami paths' shapes, and their launches there
    for i, kernel, tags in ((2, "attention_pin",
                             ("beltrami", "beltrami hub", "beltrami kNN")),
                            (14, "attention_norm",
                             ("beltrami", "beltrami hub")),
                            (7, "flash_attention",
                             ("beltrami", "beltrami squareplus",
                              "beltrami hub", "beltrami hub squareplus")),
                            (8, "attention_gmax", ("beltrami",
                                                   "beltrami hub")),
                            (9, "attention_kproj",
                             ("beltrami a", "beltrami b"))):
        for tag in tags:
            for dt in ("bfloat16", "float32"):
                r = results.get((kernel, dt, tag))
                if r is not None:
                    kernels[i][f"{tag.replace(' ', '_')}_{dt}"] = {
                        k: r.get(k) for k in numbers + ("all_miss_ms",)}
        kernels[i]["blend_launches"] = blend_launches.get(kernel, 0)
    kernels[0]["kNN"] = {k: results[("spmm_csr", "bfloat16", "kNN A.x")].get(k)
                         for k in walked + ("library_ms",)}
    kernels[0]["blend_launches"] = blend_launches.get("spmm_csr", 0)
    kernels[1]["blend_launches"] = blend_launches.get("sddmm", 0)
    kernels[15]["blend_launches"] = blend_launches.get("attention_attspmm", 0)
    # phase 10: the launches on the surface's paths, and the second
    # derivatives (each composition against its plain versions, its ms)
    for i, name, comp in ((0, "spmm_csr", "spmm_csr+sddmm"),
                          (1, "sddmm", "spmm_csr+sddmm"),
                          (4, "win_matmul", WIN_SECOND),
                          (5, "win_bwd_dense", WIN_SECOND),
                          (6, "win_bwd_slab", WIN_SECOND)):
        kernels[i]["surface_launches"] = surface_launches.get(name, 0)
        kernels[i]["second_order"] = {
            dt: {k: second[(comp, dt)][k] for k in
                 ("max_abs_err", "ms", "plain_ms", "launches")}
            for dt in ("bfloat16", "float32")}
        kernels[i]["second_order"]["composition"] = comp
    # phase 11: the launches on the multimodal paths (the union's A x and
    # A^T g, the attention block's pinned values' gradient and its pin,
    # which runs attention_kproj)
    for i in (0, 1, 2, 9):
        kernels[i]["multimodal_launches"] = mm_launches.get(
            kernels[i]["name"], 0)
    # phase 12: the launches on the drivers' paths (run_gnn's arxiv preset,
    # the sweeps' trials on the sparse strategy, the profiled epoch)
    for row in kernels:
        row["driver_launches"] = drv_launches.get(row["name"], 0)
    kernels[1]["csc_second_order"] = {
        k: results[("sddmm", "bfloat16", "csc second order")].get(k)
        for k in numbers + ("all_miss_ms",)}
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
