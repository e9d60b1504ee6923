"""The redesigned kernels on the card, at their main paths' shapes, for one
or two checkouts of the repo: win_bwd_dense, attention_kproj and win_matmul
at the ogbn-arxiv preset's, flash_dense at Computers'; the CSR
flash_attention and attention_attspmm at GRAND-nl's arxiv shapes, on a
hub graph and on a power-law graph; spmm_csr, the pin, win_bwd_slab; K5
(winatt) and attention_gmax at path A's shapes; attention_bwd_cols,
attention_norm, attention_fwd_res and attention_bwd_rows at GRAND-nl's;
sddmm at the attention block's.

For each checkout (``--root``, default this one; ``--parent DIR`` adds a
second, run in turns parent, this, this, parent, each in its own process):
the windowed layout of the arxiv stand-in as published (T = 1323 tiles of
128 rows, W = 512, D = 162), GRAND-nl's K projection widths (N =
169,343, D = 162, A = 32) and GRAND-nl's dense evaluation at Computers'
widths (the stand-in's mask, N = 13,381, H = 4, dk = 16, D = 128, the
model's own q and k); each kernel's median ms over 20 launches (CUDA
events), its largest error against its plain version, its bound (bytes
over 3.35 TB/s or operations over the dtype's peak, as chip_smoke's
``bound_ms``) and the same-function PyTorch call's ms:

- win_bwd_dense, bf16 in and f32 in: f32 out, and bf16 out (a checkout
  whose wrapper has no ``out_dtype`` is timed with the f32 output and the
  ``.to`` cast that its autograd Function ran after it);
- attention_kproj, bf16 and f32;
- win_matmul with the addend, bf16 and f32 (``baddbmm`` on the
  pre-gathered slab beside it);
- win_bwd_slab's f32 body, f32 and bf16 out (its bf16 body: ``slab``);
- the windowed arxiv preset's steady epoch (the fastest of 3 after the
  first, ``fit`` with its defaults), the same preset in f32
  (``dtype="float32"``: the f32 bodies of win_matmul and win_bwd_slab) with
  each epoch's NFE, and the attention block in f32 on the windowed layout
  (``block="attention", dtype="float32"``: win_bwd_dense's f32 body once
  per adjoint NFE): three train steps by the host clock, then one
  profiled (device busy ms, adjoint ms, and the launches and device ms
  of win_bwd_dense, win_matmul, win_bwd_slab and sddmm);
- path A's train step (GRAND-nl windowed, the arxiv preset as published):
  host ms per step, its adjoint NFE, and from one profiled step the
  device's busy ms, the adjoint span's device ms, win_bwd_dense's device
  ms and the casts of a [T, tile, W] block per adjoint NFE;
- flash_dense, f32 and bf16 (``scaled_dot_product_attention`` with the
  boolean mask beside it), and GRAND-nl's dense evaluation (Computers'
  preset with ``function="transformer", block="constant"``, random Q/K):
  three evaluations, their NFE and ms per NFE;
- (``attention``) GRAND-nl at the arxiv preset's widths (random Q/K as
  chip_smoke draws them, the encoded state in bf16): flash_attention on
  the CSR, softmax and squareplus, f32 and bf16 out; attention_attspmm in
  its row form on the windowed residual (path A's inputs: K5's
  denominators, its f32 half as the addend) and per column on the CSR
  (path B's), without and with an addend, f32 and bf16 out; the same on
  ``chip_smoke.hub_graph`` (rows of up to 13,000 edges) and on
  :func:`pareto_graph` (degrees of a power law), with the CSR GRAND-nl
  model's own operands as chip_smoke takes them, each graph's (and the
  arxiv CSR's) shares of rows and edges over 32 and over ``ROW_SPLIT``
  edges, and in a checkout
  with ``ROW_SPLIT`` set to segment lengths of 64 to 512 edges; a
  checkout whose wrappers have no ``out_dtype`` is timed with the cast
  (and the add) its routes ran after the kernel. Each with its bound and
  the all-miss count (x read once per edge instead of once). On both
  graphs, flash's f32 output (softmax and squareplus, f32 and bf16 x)
  against flash_attention_plain: the largest error, the largest ratio of
  error to chip_smoke's TOL_FLASH (and for squareplus to TOL_FLASH plus
  ``chip_smoke.squareplus_slack``), and the degree of the row where it
  lies. Then flash_attention_ax and the column and windowed routes whole,
  three GRAND-nl evaluations each on CSR, path A and path B (NFE, ms per
  NFE), and one profiled GRAND-nl train step on CSR (device busy ms, the
  flash kernels' device ms, and the device ms of each kernel of the row
  walk by name). First, in a checkout with ``beltrami_exp``: flash in
  ``beltrami_exp`` at BLEND path (b)'s shapes (:func:`blend_operands`) on
  the arxiv CSR and the hub graph (:func:`blend_flash`) and path (b)'s
  3-epoch fit, and flash and gmax for the other four score types on the
  arxiv CSR and the power-law graph (:func:`other_types`);
- (``spmm``) spmm_csr, A x and A^T g, bf16 and f32, on the arxiv CSR
  (the ``community_window=0`` preset's graph), the windowed preset's
  residual, ``chip_smoke.hub_graph`` and :func:`pareto_graph`, each with
  its bound, all-miss count (x read once per edge) and, on the arxiv CSR,
  ``torch.sparse.mm``; then the steady epochs of the arxiv preset on both
  layouts (``fit`` with its defaults, the fastest of 3 after the first);
- (``pin``) the pin in ``beltrami_exp`` at BLEND paths (a)'s and (c)'s
  shapes (path (b)'s operands, :func:`blend_operands`: the K table 2 x 32
  wide), bf16 and f32, on the arxiv CSR, the hub graph and
  :func:`regular_graph` (every row 64 edges: the kNN graph's shape); the
  pin at the arxiv preset's widths (random q, x, Wk as chip_smoke draws
  them; bf16 as on CSR, f32 as on the windowed layout) on the arxiv CSR,
  in bf16 for cosine_sim, pearson and exp_kernel too, on the hub graph
  and the power-law graph, and at Computers' and Photo's widths in f32 on
  their stand-ins' graphs; each with its largest error against its plain
  version, its bound and all-miss count (K written, one K row read per
  edge), the K projection's time alone and the walk's alone on the same
  K table (``walk_ms``; in ``beltrami_exp`` whether its one-value route
  gives the same bits); then the steady epochs of Computers and Photo;
- (``kproj``) the f32 attention_kproj (the pin's on the windowed arxiv
  preset, Computers and Photo) on random x, Wk, bk from a seed at the
  arxiv widths (N 169,343, D 162, A 32), Computers' and Photo's (their
  stand-ins' N, the presets' widths) and D 400, A 120 at arxiv's N (a
  checkout whose projection refuses that shape says so), each with its
  error against the plain version, its bound and
  ``addmm(out_dtype=float32)``; the f32 pin on the arxiv CSR; then the
  steady epochs of Computers and Photo (6 epochs each, with their NFE);
- (``slab``) win_bwd_slab with bf16 blocks and g at the windowed arxiv
  shapes: the f32 output and the output in x's dtype as the win_matmul
  Function's backward asks for it (a checkout whose wrapper has no
  ``out_dtype`` is timed with the ``[:N].to`` slice and cast its Function
  ran after it), each with its bound, beside ``bmm`` + ``index_add_``
  (two calls, the plain version's); the tiles per window; then the steady
  epochs of the arxiv preset on both layouts and path A's train step.

- (``winatt``) K5 on path A's inputs at the arxiv preset's shapes (the
  windowed GRAND-nl model's own q, k and x in bf16 and f32, r0 and d_res
  from the residual), with its error against the plain version and its
  ratio to chip_smoke's tolerances, its bound and all-miss count (k and x
  gathered per cell);
  the in-window cells' degree shares; path A's RHS alone
  (``windowed_attention_ax_fast``, device and host ms); three path A
  evaluations per NFE; K5 on chip_smoke's ``long_row_windows`` (in-window
  rows of up to 512 cells), with the parent's kernel on the same inputs
  when ``--against`` is given;
- (``gmax``) attention_gmax on the windowed residual (path A's pre-scaled
  q and K table), the arxiv CSR, the hub and the power-law graphs (the
  CSR model's operands), bf16 and f32: its value, error against the plain
  version, bound and all-miss count (K gathered per slot), beside the
  same kernel with a fresh zeroed state each call; in a checkout with
  ``beltrami_exp`` first the same in ``beltrami_exp`` on path (b)'s
  operands (:func:`blend_operands`) over the arxiv CSR and the hub graph;
  three squareplus (gmax once per NFE) and three softmax CSR evaluations
  per NFE;
- (``ptxas``, this checkout then the parent, once each) each instance of
  ``csrc/fused_attention.cu``, ``attention_pin.cu`` and ``winatt.cu``
  with its registers and spill bytes.

- (``bwd_cols``) attention_bwd_cols (B3) on the CSR GRAND-nl model's own
  operands (its encoded state, q, the K table, the training forward's
  tables and rho from attention_bwd_rows, a cotangent from a seed), bf16
  and f32: on the arxiv CSC, and on the transposes of
  ``chip_smoke.hub_graph`` and :func:`pareto_graph` (their hub rows become
  hub columns), each with its errors against the plain version and their
  ratios to chip_smoke's tolerances, its bound and all-miss count (g, q
  and the row tables gathered per slot); then one profiled CSR GRAND-nl
  train step (its adjoint's device ms, B3's launches and device ms);
- (``norm``) in a checkout with the norm's ``beltrami_exp`` first
  attention_norm in it at BLEND path (d)'s shapes (path (b)'s operands,
  :func:`blend_operands`) on the arxiv CSR (softmax and squareplus) and
  the hub graph, bf16 and f32 (whether its one-value route gives the same
  bits), and path (d)'s RHS alone; then attention_norm on the windowed
  residual (path A's pre-scaled q and K table under r0), the arxiv CSR
  (the column-normalised model's operands, softmax and squareplus) and
  the hub graph, bf16 and f32, and for cosine_sim, pearson and exp_kernel
  on the arxiv CSR (bf16, q and K from a seed); each with its errors,
  bound and all-miss count (K gathered per slot); path A's and path B's
  RHS alone (``windowed_attention_ax_fast``,
  ``colnorm_attention_ax_fast``; device and host ms); three evaluations of
  each path per NFE.

- (``fwd_res``, ``bwd_rows``) attention_fwd_res, or attention_bwd_rows on
  its residuals, on the CSR GRAND-nl model's own operands (its encoded
  state, q, the K table, a cotangent from a seed), bf16 and f32: on the
  arxiv CSR, ``chip_smoke.hub_graph``'s CSR and :func:`pareto_graph`'s
  (their hub rows walked in segments), each graph's shares of rows and
  edges over 32 and 128 edges, each with its errors against the plain
  version and their ratios to chip_smoke's tolerances (fwd_res: whether
  the shift is the plain version's exactly), its bound and all-miss count
  (x and K gathered per edge); then one profiled CSR GRAND-nl train step
  (its adjoint's device ms, and the launches and device ms of the
  training kernels).

- (``sddmm``) sddmm on g and x from a seed at the attention block's
  arxiv width (D 162), bf16 and f32: on the arxiv CSR, the windowed
  residual, ``chip_smoke.hub_graph``, its transpose (hub columns: hub x
  rows gathered thousands of times) and :func:`pareto_graph`, each
  graph's share of rows and edges over 32 edges; each case's f32 output
  and its output in the values' dtype at the length of the Function's
  values buffer (a checkout whose wrapper has no ``out_dtype`` is timed
  with the zeros, cast and slice copy its Function ran), its error
  against the plain version and its ratio to chip_smoke's TOL_DOT, its
  bound and all-miss count (x gathered per slot), and on the arxiv CSR
  ``torch.sparse.sampled_addmm``; then the attention block's train steps
  at arxiv widths on CSR and windowed (bf16) and windowed in f32: three
  by the host clock with their NFE, then one profiled (device busy ms,
  the adjoint's device ms, and the launches and device ms of sddmm,
  spmm_walk, win_bwd_dense and win_matmul).

With ``--parent``, this checkout's ``windowed``, ``attention`` (its
``beltrami_exp`` and other-type cases), ``pin``, ``winatt``, ``gmax``,
``bwd_cols``, ``norm`` (the score types the parent's norm takes),
``fwd_res``, ``bwd_rows`` and ``sddmm`` runs also
call the parent's kernels (built by the parent's ``_build``) on the same inputs:
whether the f32 bodies' outputs (win_matmul, win_bwd_dense and
win_bwd_slab with both outputs; ``parent_equal``, ``parent_ms``), the
pin's (its walk on the same K table: ``parent_walk_ms``), K5's out
and den, gmax's value, B3's dk and dxv, the norm's e and den, fwd_res's
out, scores, shift and denom and bwd_rows' dq and rho are equal bit for
bit, the largest difference, the rows that differ and the shortest of
them (of a score: its row's length); sddmm's largest difference and the
parent kernel's ms; gmax's and flash's ms in ``parent_ms`` too.

One JSON line per measurement, then the card's nvidia-smi line. Run from
the root of the repo: ``python3 scripts/torch_kernel_redesign.py [--parent
DIR] [--only windowed|attention|spmm|pin|kproj|slab|winatt|gmax|bwd_cols|
norm|fwd_res|bwd_rows|sddmm|ptxas]``; a parent is a
``git
archive`` of another commit unpacked in a directory that ``.gitignore``
lists.
"""

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_ms(fn, reps: int = 20) -> float:
    """The median of single launches timed by CUDA events with the host's
    enqueue inside (chip_smoke's time_ms without its sleep)."""
    import torch

    for _ in range(3):
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
    return sorted(times)[reps // 2]


def this_chip_smoke():
    """This checkout's chip_smoke module, for its device timing (a sleep
    ahead of each start event) whichever checkout is measured."""
    if "chip_smoke_here" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules["chip_smoke_here"] = mod
    return sys.modules["chip_smoke_here"]


def pareto_graph(device, n=169_343, alpha=2.5, kmin=3, seed=4):
    """A graph at ogbn-arxiv's N whose degrees follow a power law, P(deg >
    k) = (k / kmin)^-(alpha - 1), floored (mean about 8.5, the largest
    thousands of edges), columns uniform, built from a seed. The exponent
    is a choice, not a fit to ogbn-arxiv."""
    import numpy as np

    from graphax_torch.sparse.graph import Graph

    rng = np.random.RandomState(seed)
    deg = np.minimum(np.floor(kmin * rng.random_sample(n) ** (
        -1.0 / (alpha - 1.0))), n - 1).astype(np.int64)
    row = np.repeat(np.arange(n), deg)
    col = rng.randint(0, n, row.size)
    order = np.lexsort((col, row))
    return Graph.from_edges(row[order], col[order], n, device=device)


def measure(root: str, only=None, against=None) -> None:
    sys.path.insert(0, root)

    def emit(**row):
        print(json.dumps({"root": root, **row}), flush=True)

    if only in (None, "windowed"):
        windowed(emit, against)
    if only in (None, "attention"):
        attention(emit, against)
    if only == "ptxas":
        ptxas(emit, root)
    if only in (None, "spmm"):
        spmm(emit)
    if only in (None, "pin"):
        pin(emit, against)
    if only in (None, "kproj"):
        kproj(emit)
    if only in (None, "slab"):
        slab(emit)
    if only in (None, "winatt"):
        winatt(emit, against)
    if only in (None, "gmax"):
        gmax(emit, against)
    if only in (None, "bwd_cols"):
        bwd_cols(emit, against)
    if only in (None, "norm"):
        norm(emit, against)
    for which in ("fwd_res", "bwd_rows"):
        if only in (None, which):
            row_kernels(emit, which, against)
    if only in (None, "sddmm"):
        sddmm(emit, against)


def blend_operands(data, dtypes):
    """Path (b)'s beltrami_exp operands (chip_smoke's ``blend`` phase): the
    BLEND GRAND-nl preset (``beltrami=True, attention_type="exp_kernel",
    function="transformer", block="constant", community_window=0``) on the
    arxiv stand-in's CSR, its attention layer's random weights as
    chip_smoke draws them (``randomize_beltrami``), with positional
    encodings of DW64's width drawn from a seed in place of DeepWalk's
    (the kernels' work does not depend on their values). Returns the
    Trainer and, for each dtype of ``dtypes``, q, x, the K weight and
    bias and the K table, the score arguments and ``beltrami_exp``'s
    keywords."""
    import numpy as np
    import torch

    from graphax_torch import Trainer, best_config
    from graphax_torch.kernels import fused_attention as fa

    here = this_chip_smoke()
    enc = np.random.RandomState(22).randn(data.num_nodes, 64).astype(
        np.float32)
    cfg = best_config("ogbn-arxiv", beltrami=True,
                      attention_type="exp_kernel", function="transformer",
                      block="constant", community_window=0, pos_enc_dim=64)
    tr = Trainer(cfg, data.with_pos_encoding(enc))
    att = tr.model.block.func.att
    here.randomize_beltrami(att, 31)
    tr.model.eval()
    out = {}
    with torch.no_grad():
        x_enc = tr.model.encode(tr.data.x, train=False,
                                pos_encoding=tr.data.pos_encoding)
        g = tr.data.graph
        for dt in dtypes:
            x = x_enc.to(dt).contiguous()
            p = fa.prep_inputs(tr.cfg, att, g, x)
            scal, bel = fa.score_args(p)
            kt = fa.attention_kproj(x, p["wk"], p["bk"])
            out[dt] = dict(q=p["q"], x=x, kt=kt, wk=p["wk"], bk=p["bk"],
                           scal=scal, bel=bel)
    return tr, out


def flash_call(fn, lay, q, x, kt, gs, scal, bel, out, kvec=None):
    """``gx_flash_attention`` of a checkout's library (this one's or a
    parent's, one whose C signature takes beltrami_exp's two scalars) on
    ``lay`` without reweight, into ``out``; ``kvec`` None: the parent's
    host rule (a head slice of a multiple of 4 values, kt on 16 bytes)."""
    import torch

    from graphax_torch.kernels import _build
    from graphax_torch.kernels import fused_attention as fa

    n, d = x.shape
    a, heads = q.shape[1], scal[1]
    if kvec is None:
        kvec = int((a // heads) % 4 == 0 and kt.data_ptr() % 16 == 0)
    plan, nlong, nseg = fa._row_plan(lay, fa._BATCH, fa.ROW_SPLIT)
    flash_call.keep = (torch.empty((nseg, 2 * heads), device=x.device),
                       torch.empty((nseg, d), device=x.device))
    # warps a block at beltrami_exp's padded warp stride, which fits the
    # unpadded one too (so any checkout's flash kernels take it)
    wpb = fa.flash_warps(a, heads, "beltrami_exp")
    return fn(lay.ptr.data_ptr(), lay.idx.data_ptr(), q.data_ptr(),
              x.data_ptr(), kt.data_ptr(), None,
              gs.data_ptr() if gs is not None else None, plan.data_ptr(),
              flash_call.keep[0].data_ptr(), flash_call.keep[1].data_ptr(),
              out.data_ptr(), n, d, a, heads, fa.ATT_TYPES[scal[0]], 0,
              int(gs is not None), float(scal[2]), float(scal[3]),
              float(bel.get("ov2p", 1.0)), float(bel.get("inv2l2p", 0.5)),
              fa._DTYPES[x.dtype], fa._DTYPES[out.dtype], fa.gather_width(x),
              kvec, wpb, fa.ROW_SPLIT, nlong, nseg, _build.stream_ptr(x))


def against_parent_flash(row, plib, lay, q, x, kt, gs, scal, bel, got):
    """The parent's flash kernel on the same inputs: its output against
    ``got`` bit for bit (``parent_equal``, the largest difference) and its
    ms in this process."""
    import torch

    from graphax_torch.kernels import _build

    here = this_chip_smoke()
    old = torch.empty_like(got)
    fn = plib.gx_flash_attention
    _build.check(flash_call(fn, lay, q, x, kt, gs, scal, bel, old),
                 "parent flash")
    row.update(parent_equal=bool(torch.equal(got, old)),
               parent_max_diff=float((got.float() - old.float()).abs().max()),
               parent_ms=here.time_ms(lambda: flash_call(
                   fn, lay, q, x, kt, gs, scal, bel, old)))


def blend_flash(emit, data, parent=None) -> None:
    """flash_attention in beltrami_exp at path (b)'s shapes (N 169,343, D
    162, the K table 2 x 32 wide, 2 heads) on the arxiv CSR and on
    ``chip_smoke.hub_graph``, bf16 and f32, softmax and squareplus (the
    shift from attention_gmax), f32 out and x's dtype out (the path's):
    ms, the error against flash_attention_plain, the bound and the
    all-miss count as chip_smoke counts them; with a parent, its output's
    bits and its ms on the same inputs. Then path (b) itself,
    ``fit(epochs=3)`` with fit's defaults as chip_smoke's ``blend`` phase
    runs it: each epoch's seconds and NFE."""
    import torch

    from graphax_torch.kernels import fused_attention as fa

    here = this_chip_smoke()
    plib = parent_library(parent, "fused_attention") if parent else None
    dts = (torch.bfloat16, torch.float32)
    tr, ops = blend_operands(data, dts)
    g = tr.data.graph
    graphs = (("arxiv CSR", g.csr), ("hub", here.hub_graph("cuda").csr))
    with torch.no_grad():
        for dt in dts:
            o = ops[dt]
            q, x, kt, scal, bel = o["q"], o["x"], o["kt"], o["scal"], o["bel"]
            n, d = x.shape
            a, heads, b = q.shape[1], scal[1], dt.itemsize
            name = str(dt)[6:]
            for label, lay in graphs:
                e = lay.num_slots
                for variant in ("softmax", "squareplus"):
                    gs = fa.attention_gmax(lay, q, kt, None, *scal, **bel) \
                        if variant == "squareplus" else None
                    ref = fa.flash_attention_plain(lay, q, x, kt, None, gs,
                                                   *scal, **bel)
                    for od in dict.fromkeys((torch.float32, dt)):
                        fn = lambda od=od: fa.flash_attention(  # noqa: E731
                            lay, q, x, kt, None, gs, *scal, out_dtype=od,
                            **bel)
                        got = fn()
                        atol, rtol = here.TOL_FLASH[name]
                        want = ref.to(od).float()
                        err = (got.float() - want).abs()
                        nbytes = (n * a * b + 4 * n * a + n * d * b
                                  + 4 * e + 4 * (n + 1) + n * d * od.itemsize)
                        ops_ = e * (3.0 * a + 8 * heads) + e * 2.0 * heads * d
                        bms, by = here.bound_ms(nbytes, ops_, name)
                        row = dict(kernel="flash_attention",
                                   att_type="beltrami_exp", graph=label,
                                   E=e, dtype=name, variant=variant,
                                   out=str(od)[6:], ms=here.time_ms(fn),
                                   max_abs_err=float(err.max()),
                                   tol_flash=[atol, rtol],
                                   within_tol=bool((err <= atol + rtol
                                                    * want.abs()).all()),
                                   bound_ms=bms, bound_by=by,
                                   all_miss_ms=(nbytes - n * d * b
                                                + e * d * b)
                                   / here.HBM_BYTES_PER_S * 1e3)
                        if hasattr(fa, "flash_kvec"):
                            row["kvec"] = fa.flash_kvec(kt, heads, scal[0])
                        if plib is not None:
                            against_parent_flash(row, plib, lay, q, x, kt, gs,
                                                 scal, bel, got)
                        emit(**row)
            del o, q, x, kt
    del g, ops, graphs
    torch.cuda.empty_cache()
    fit = tr.fit(epochs=3)
    torch.cuda.synchronize()
    emit(path="blend b GRAND-nl", epoch_seconds=[h["time"]
                                                 for h in fit["history"]],
         solver=[{k: v for k, v in sv.items()
                  if isinstance(v, (int, float, bool))}
                 for sv in fit["solver"]])


def other_types(emit, data, parent=None) -> None:
    """flash_attention (softmax and squareplus, bf16 out) and
    attention_gmax for scaled_dot, cosine_sim, pearson and exp_kernel at
    GRAND-nl's arxiv widths (q and the K table of A 32, 2 heads, D 162,
    bf16, from a seed) on the arxiv CSR and :func:`pareto_graph`: ms, and
    with a parent its output's bits and its ms on the same inputs (the
    instances the beltrami_exp flag left alone)."""
    import torch

    from graphax_torch import best_config
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import fused_attention as fa

    import chip_smoke as cs

    here = this_chip_smoke()
    plib = parent_library(parent, "fused_attention") if parent else None
    bf = torch.bfloat16
    g = cs.nl_trainer(best_config("ogbn-arxiv", community_window=0,
                                  block="constant", function="transformer"),
                      data, qk_seed=None).data.graph
    graphs = (("arxiv CSR", g.csr), ("pareto", pareto_graph("cuda").csr))
    n, d, a, heads = g.num_nodes, 162, 32, 2
    gen = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn(n, d, generator=gen, device="cuda").to(bf)
    q = (0.3 * torch.randn(n, a, generator=gen, device="cuda")).to(bf)
    wk = (0.3 / d ** 0.5 * torch.randn(d, a, generator=gen,
                                       device="cuda")).to(bf)
    bk = 0.1 * torch.randn(a, generator=gen, device="cuda")
    with torch.no_grad():
        kt = fa.attention_kproj(x, wk, bk)
        for att_type in ("scaled_dot", "cosine_sim", "pearson",
                         "exp_kernel"):
            scal = (att_type, heads, 1.3, 0.7)
            for label, lay in graphs:
                fn = lambda: fa.attention_gmax(lay, q, kt, None,  # noqa
                                               *scal)
                gs = fn()
                row = dict(kernel="attention_gmax", att_type=att_type,
                           graph=label, dtype="bfloat16", ms=here.time_ms(fn))
                if plib is not None:
                    old = torch.empty((), device="cuda")
                    st = torch.zeros(2, dtype=torch.int32, device="cuda")
                    call = lambda: gmax_call(  # noqa: E731
                        plib.gx_attention_gmax, lay, q, kt, st, old, heads,
                        scal, bf)
                    _build.check(call(), "parent gmax")
                    row.update(parent_equal=bool(torch.equal(gs, old)),
                               parent_ms=here.time_ms(call))
                emit(**row)
                for variant, shift in (("softmax", None),
                                       ("squareplus", gs)):
                    fn = lambda s=shift: fa.flash_attention(  # noqa: E731
                        lay, q, x, kt, None, s, *scal, out_dtype=bf)
                    got = fn()
                    row = dict(kernel="flash_attention", att_type=att_type,
                               graph=label, dtype="bfloat16", out="bfloat16",
                               variant=variant, ms=here.time_ms(fn))
                    if plib is not None:
                        against_parent_flash(row, plib, lay, q, x, kt, shift,
                                             scal, {}, got)
                    emit(**row)


def ptxas(emit, root: str) -> None:
    """The scoring kernels' sources of the checkout at ``root``
    (``csrc/fused_attention.cu``, ``attention_pin.cu`` and ``winatt.cu``)
    compiled as ``_build`` compiles them, with ``-Xptxas=-v``: each kernel
    instance's registers and spill bytes (one line each, the name
    demangled, its source beside it)."""
    import re
    import shutil
    import tempfile

    from graphax_torch.kernels import _build

    filt = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    if not os.path.exists(filt):
        filt = shutil.which("cu++filt") or "c++filt"
    for name in ("fused_attention", "attention_pin", "winatt"):
        src = os.path.join(root, "graphax_torch", "kernels", "csrc",
                           name + ".cu")
        with tempfile.TemporaryDirectory() as tmp:
            proc = subprocess.run(
                [_build._nvcc(), "-Xptxas=-v", _build.ARCH, "-std=c++17",
                 "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                 os.path.join(tmp, "lib.so"), src],
                capture_output=True, text=True, check=True)
        text = proc.stdout + proc.stderr
        found, cur = {}, None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = m.group(1)
                continue
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                cur = m.group(1)
                continue
            m = re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and cur:
                found.setdefault(cur, {}).update(
                    spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur:
                found.setdefault(cur, {})["registers"] = int(m.group(1))
        names = subprocess.run([filt], input="\n".join(found), text=True,
                               capture_output=True,
                               check=True).stdout.split("\n")
        for mangled, demangled in zip(found, names):
            if "registers" in found[mangled]:
                emit(ptxas=demangled.strip(), source=name, **found[mangled])


def parent_f32_runs(t, extent: int, run: int) -> int:
    """The run length that a checkout from before the f32 FMA core gives
    its f32 bodies' staged loads along rows of ``extent`` values of ``t``
    (its wrappers' ``_run``): ``run`` where the extent divides by it and
    ``t`` starts on ``run`` values, else 1. At the arxiv shapes these are
    also the copy widths a checkout on the core would choose."""
    ok = extent % run == 0 and t.data_ptr() % (4 * run) == 0
    return run if ok else 1


def windowed(emit, against=None) -> None:
    """The measurements of the module's docstring before ``attention``;
    with ``against`` (a parent checkout), its f32 win_matmul,
    win_bwd_dense and win_bwd_slab on the same inputs."""
    import torch

    import chip_smoke as cs

    here = this_chip_smoke()
    from graphax_torch import Trainer, best_config, get_dataset
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import fused_attention as fa
    from graphax_torch.kernels import windowed_spmm as ws

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    plib = None if against is None else parent_library(against,
                                                       "windowed_spmm")
    data = get_dataset("ogbn-arxiv")
    tr = Trainer(best_config("ogbn-arxiv"), data)
    wl = tr.data.graph.windows
    n, d, a = wl.num_nodes, 162, 32
    t_, tile, w = wl.block_shape
    cells = t_ * tile * w
    gen = torch.Generator(device="cuda").manual_seed(0)
    has_out = "out_dtype" in inspect.signature(ws.win_bwd_dense).parameters
    s = _build.stream_ptr

    def against_parent(row, got, call):
        """The parent's f32 body on the same inputs: whether its output is
        this one's bit for bit, the largest difference, its time."""
        old = torch.empty_like(got)
        _build.check(call(old), "parent " + row["kernel"])
        torch.cuda.synchronize()
        row.update(parent_equal=bool(torch.equal(got, old)),
                   parent_max_abs_diff=float(
                       (got.float() - old.float()).abs().max()),
                   parent_ms=here.time_ms(lambda: call(old)))

    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).replace("torch.", "")
        b = torch.finfo(dt).bits // 8
        with_parent = dt == torch.float32 and plib is not None
        x = torch.randn(n, d, generator=gen, device="cuda").to(dt)
        g = torch.randn(n, d, generator=gen, device="cuda").to(dt)
        slab_g = ws._slab(x, wl)[wl.tile_win.long()].contiguous()
        g_t = ws._tiles(g, wl)
        ref = ws.win_bwd_dense_plain(wl, g, x)
        for od in (torch.float32, torch.bfloat16):
            oname = str(od).replace("torch.", "")
            if has_out:
                fn = lambda: ws.win_bwd_dense(wl, g, x, od)  # noqa: E731
            else:
                fn = lambda: ws.win_bwd_dense(wl, g, x).to(od)  # noqa: E731
            got = fn()
            err = float((got.float() - ref.to(od).float()).abs().max())
            ob = torch.finfo(od).bits // 8
            lib = None
            if dt == torch.bfloat16 or od == torch.float32:
                lib = ("bmm out_dtype=" + oname, lambda: torch.bmm(
                    g_t, slab_g.transpose(1, 2), out_dtype=od))
            bms, by = cs.bound_ms(2 * n * d * b + cells * ob,
                                  2.0 * cells * d, name)
            row = dict(kernel="win_bwd_dense", dtype=name, out=oname,
                       ms=here.time_ms(fn), ms_with_enqueue=host_ms(fn),
                       max_abs_err=err, bound_ms=bms, bound_by=by,
                       library=lib and lib[0],
                       library_ms=lib and here.time_ms(lib[1], reps=10),
                       with_cast=not has_out and od != torch.float32)
            if with_parent:
                against_parent(row, got, lambda out, od=od: (
                    plib.gx_win_bwd_dense(
                        g.data_ptr(), x.data_ptr(), wl.tile_win.data_ptr(),
                        out.data_ptr(), t_, tile, w, n, d, 0,
                        int(od == torch.bfloat16),
                        parent_f32_runs(g, d, 2), parent_f32_runs(x, d, 2),
                        s(x))))
            emit(**row)
            del got
        del slab_g, g_t, ref
        wk = (0.3 * torch.randn(d, a, generator=gen, device="cuda")).to(dt)
        bk = 0.1 * torch.randn(a, generator=gen, device="cuda")
        with torch.no_grad():
            got = fa.attention_kproj(x, wk, bk)
            err = float((got - fa.attention_kproj_plain(x, wk, bk))
                        .abs().max())
            lib = ("addmm out_dtype=float32", lambda: torch.addmm(
                bk, x, wk, out_dtype=torch.float32))
            bms, by = cs.bound_ms(n * d * b + d * a * b + 4 * a + 4 * n * a,
                                  2.0 * n * d * a, name)
            fn = lambda: fa.attention_kproj(x, wk, bk)  # noqa: E731
            emit(kernel="attention_kproj", dtype=name,
                 ms=here.time_ms(fn), ms_with_enqueue=host_ms(fn),
                 max_abs_err=err, bound_ms=bms, bound_by=by, library=lib[0],
                 library_ms=here.time_ms(lib[1], reps=10))
        # win_matmul with the addend, as the windowed path calls it
        vals = torch.rand(tr.data.graph.edge_buffer_size, generator=gen,
                          device="cuda")
        dense = ws.densify(wl, vals, dt)
        add = torch.randn(n, d, generator=gen, device="cuda").to(dt)
        fn = lambda: ws.win_matmul(wl, dense, x, add)  # noqa: E731
        got = fn()
        err = float((got.float() - ws.win_matmul_plain(wl, dense, x, add)
                     .float()).abs().max())
        slab_g = ws._slab(x, wl)[wl.tile_win.long()].contiguous()
        add_t = ws._tiles(add, wl)
        bms, by = cs.bound_ms(cells * b + 3 * n * d * b, 2.0 * cells * d,
                              name)
        row = dict(kernel="win_matmul", dtype=name, ms=here.time_ms(fn),
                   ms_with_enqueue=host_ms(fn), max_abs_err=err,
                   bound_ms=bms, bound_by=by,
                   library="baddbmm on the pre-gathered slab",
                   library_ms=here.time_ms(
                       lambda: torch.baddbmm(add_t, dense, slab_g), reps=10))
        if with_parent:
            against_parent(row, got, lambda out: plib.gx_win_matmul(
                dense.data_ptr(), x.data_ptr(), wl.tile_win.data_ptr(),
                add.data_ptr(), out.data_ptr(), t_, tile, w, n, d, 0,
                parent_f32_runs(dense, w, 4), parent_f32_runs(x, d, 2),
                s(x)))
        emit(**row)
        del got, add, slab_g, add_t
        if dt == torch.float32:
            # win_bwd_slab's f32 body (the bf16 one: ``slab``)
            want = ws.win_bwd_slab_plain(wl, dense, g)
            for od in (torch.float32, torch.bfloat16):
                fn = lambda od=od: ws.win_bwd_slab(  # noqa: E731
                    wl, dense, g, od)
                got = fn()
                row = dict(kernel="win_bwd_slab", dtype=name,
                           out=str(od)[6:], ms=here.time_ms(fn),
                           max_abs_err=float((got.float() - want.to(od)
                                              .float()).abs().max()),
                           bound_ms=cs.bound_ms(
                               cells * 4 + n * d * 4 + n * d * od.itemsize,
                               2.0 * cells * d, name)[0])
                if with_parent:
                    against_parent(row, got, lambda out, od=od: (
                        plib.gx_win_bwd_slab(
                            dense.data_ptr(), g.data_ptr(),
                            wl.win_ptr.data_ptr(), wl.win_tiles.data_ptr(),
                            out.data_ptr(), wl.num_windows, tile, w, n, d,
                            0, int(od == torch.bfloat16),
                            parent_f32_runs(dense, w, 4),
                            parent_f32_runs(g, d, 2), s(g))))
                emit(**row)
                del got
            del want
        del x, g, dense
        torch.cuda.empty_cache()
    fit = tr.fit(epochs=3)
    torch.cuda.synchronize()
    times = [h["time"] for h in fit["history"]]
    emit(path="windowed arxiv", epoch_seconds=times,
         steady_epoch_seconds=min(times[1:]))
    del tr
    # the preset at the reference's f32 (win_matmul and win_bwd_slab's f32
    # bodies), then the attention block in f32 on the windowed layout
    # (win_bwd_dense's f32 body once per adjoint NFE)
    tr = Trainer(best_config("ogbn-arxiv", dtype="float32"), data)
    steady_epochs(emit, "windowed arxiv f32", tr)
    del tr
    tr = Trainer(best_config("ogbn-arxiv", block="attention",
                             dtype="float32"), data)
    timed_steps(emit, tr, "attention block f32 windowed")
    profiled_train_step(emit, tr, "attention block f32 windowed",
                        ("win_bwd_dense", "win_matmul", "win_bwd_slab",
                         "sddmm"))
    del tr
    torch.cuda.empty_cache()
    train_steps(data, emit)
    del data
    torch.cuda.empty_cache()
    dense_nl(emit)


def timed_steps(emit, tr, label, steps: int = 3) -> None:
    """``steps`` train steps after a warm-up one, each timed by the host
    clock around a device sync, with its forward and adjoint NFE."""
    import time

    import torch

    tr.train_step()
    torch.cuda.synchronize()
    for i in range(steps):
        t0 = time.perf_counter()
        tr.train_step()
        torch.cuda.synchronize()
        emit(path=label, step=i + 1,
             ms=(time.perf_counter() - t0) * 1e3,
             forward_nfe=tr.fm.get_value(), adjoint_nfe=tr.bm.get_value())


def train_steps(data, emit) -> None:
    """Path A (GRAND-nl on the windowed strategy as published, random Q/K
    as chip_smoke draws them): after one warm-up step, two train steps
    timed by the host clock around a device sync, then one under
    torch.profiler: its device busy ms, win_bwd_dense's and win_bwd_slab's
    launches and device ms, and the dtype casts (``aten::_to_copy``) of a
    [T, tile, W] block, per adjoint NFE."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from graphax_torch import best_config

    cfg = best_config("ogbn-arxiv", block="constant", function="transformer")
    tr = cs.nl_trainer(cfg, data)
    shape = list(tr.data.graph.windows.block_shape)
    tr.train_step()
    torch.cuda.synchronize()
    host = []
    for _ in range(2):
        t0 = time.perf_counter()
        tr.train_step()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        tr.train_step()
        torch.cuda.synchronize()
    cuda_t = torch.autograd.DeviceType.CUDA
    busy = bwd_ms = slab_ms = adjoint_ms = 0.0
    bwd_n = slab_n = casts = 0
    for ev in prof.events():
        if ev.name == "graphax_torch.adjoint" and ev.device_type == cuda_t:
            adjoint_ms += ev.time_range.elapsed_us() / 1e3
        elif ev.device_type == cuda_t:
            ms = ev.time_range.elapsed_us() / 1e3
            busy += ms
            if "win_bwd_dense" in ev.name:
                bwd_ms += ms
                bwd_n += 1
            if "win_bwd_slab" in ev.name:
                slab_ms += ms
                slab_n += 1
        elif (ev.name == "aten::_to_copy" and ev.input_shapes
              and list(ev.input_shapes[0]) == shape):
            casts += 1
    nfe = tr.bm.get_value()
    emit(path="A", train_step_host_ms=host, forward_nfe=tr.fm.get_value(),
         adjoint_nfe=nfe, profiled_device_busy_ms=busy,
         adjoint_device_ms=adjoint_ms, adjoint_ms_per_nfe=adjoint_ms / nfe,
         win_bwd_dense_launches=bwd_n, win_bwd_dense_device_ms=bwd_ms,
         win_bwd_slab_launches=slab_n, win_bwd_slab_device_ms=slab_ms,
         block_casts=casts, block_casts_per_adjoint_nfe=casts / nfe)


def dense_nl(emit) -> None:
    """flash_dense at Computers' widths (the stand-in's mask, GRAND-nl's own
    q and k on the encoded state, as chip_smoke's dense kernel phase), then
    GRAND-nl's dense evaluation three times: NFE, seconds, ms per NFE (host
    clock around a device sync) and flash_dense's launches."""
    import math
    import time

    import torch

    import chip_smoke as cs
    from graphax_torch import Trainer, best_config, get_dataset
    from graphax_torch.functions.transformer import _split_heads
    from graphax_torch.kernels import _build
    from graphax_torch.kernels.dense_path import dense_adjacency_mask
    from graphax_torch.kernels.flash_dense import (
        flash_attention_multihead, flash_attention_multihead_plain,
    )
    from graphax_torch.utils.params import linear_apply

    here = this_chip_smoke()
    tr = Trainer(best_config("Computers", function="transformer",
                             block="constant"), get_dataset("Computers"))
    cs.randomize_attention(tr.model.block.func.att, 11)
    g, att, heads = tr.data.graph, tr.model.block.func.att, tr.cfg.heads
    tr.model.eval()
    with torch.no_grad():
        x_enc = tr.model.encode(tr.data.x, train=False)
        q = _split_heads(linear_apply(att.Q, x_enc), heads)
        k = _split_heads(linear_apply(att.K, x_enc), heads).contiguous()
        dk, n, d = q.shape[-1], g.num_nodes, x_enc.shape[1]
        q = (q / math.sqrt(dk)).contiguous()
        mask = dense_adjacency_mask(g)
        live = int(mask.sum())
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).replace("torch.", "")
            b = torch.finfo(dt).bits // 8
            x = x_enc.to(dt).contiguous()
            fn = lambda: flash_attention_multihead(q, k, x, mask)  # noqa
            err = float((fn().float() - flash_attention_multihead_plain(
                q, k, x, mask).float()).abs().max())
            q4, k4 = (t.transpose(0, 1)[None].to(dt) for t in (q, k))
            v4 = x[None, None].expand(1, heads, n, d)
            bms, by = cs.bound_ms(n * n + 2 * 4 * n * heads * dk + n * d * b
                                  + heads * n * d * b,
                                  heads * 2.0 * live * (dk + d), name)
            emit(kernel="flash_dense", dtype=name, N=n, live=live,
                 ms=here.time_ms(fn), ms_with_enqueue=host_ms(fn),
                 max_abs_err=err, bound_ms=bms, bound_by=by,
                 library="scaled_dot_product_attention, boolean mask",
                 library_ms=here.time_ms(
                     lambda: torch.nn.functional.scaled_dot_product_attention(
                         q4, k4, v4, attn_mask=mask, scale=1.0), reps=10))
            del x, q4, k4, v4
    for i in range(3):
        _build.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.evaluate()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        nfe = tr.last_eval.nfe
        emit(path="GRAND-nl dense evaluation", eval=i + 1, nfe=nfe,
             seconds=sec, ms_per_nfe=sec * 1e3 / nfe,
             flash_dense_launches=_build.LAUNCHES["flash_dense"])


def attention(emit, parent=None) -> None:
    """The ``attention`` measurements of the module's docstring."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from graphax_torch import best_config, get_dataset
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import attention3 as a3
    from graphax_torch.kernels import fused_attention as fa
    from graphax_torch.kernels import winatt as wa
    from graphax_torch.utils.params import linear_apply

    here = this_chip_smoke()
    new = "out_dtype" in inspect.signature(fa.flash_attention).parameters
    bf = torch.bfloat16
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    data = get_dataset("ogbn-arxiv")
    if hasattr(fa, "score_args"):   # a checkout with beltrami_exp
        blend_flash(emit, data, parent)
        other_types(emit, data, parent)
    base = dict(block="constant", function="transformer")
    trs = {"CSR": dict(community_window=0), "A": {},
           "B": dict(community_window=0, attention_norm_idx=1)}
    trs = {k: cs.nl_trainer(best_config("ogbn-arxiv", **base, **kw), data)
           for k, kw in trs.items()}

    def timed(kernel, fn, want, nbytes, miss_bytes, **row):
        err = float((fn().float() - want.float()).abs().max())
        emit(kernel=kernel, ms=here.time_ms(fn), max_abs_err=err,
             bound_ms=nbytes / here.HBM_BYTES_PER_S * 1e3,
             all_miss_ms=miss_bytes / here.HBM_BYTES_PER_S * 1e3, **row)

    def flash_cases(label, lay, q, x, kt, scal):
        n, d = x.shape
        e, a = lay.num_slots, q.shape[1]
        for variant in ("softmax", "squareplus"):
            gs = fa.attention_gmax(lay, q, kt, None, *scal) \
                if variant == "squareplus" else None
            ref = fa.flash_attention_plain(lay, q, x, kt, None, gs, *scal)
            for od in (torch.float32, bf):
                if new:
                    fn = lambda od=od: fa.flash_attention(  # noqa: E731
                        lay, q, x, kt, None, gs, *scal, out_dtype=od)
                else:
                    fn = lambda od=od: fa.flash_attention(  # noqa: E731
                        lay, q, x, kt, None, gs, *scal).to(od)
                # q, K, the CSR and the output, and x once or per edge
                tables = (2 * n * a + 4 * n * a + 4 * e + 4 * (n + 1)
                          + n * d * od.itemsize)
                timed("flash_attention", fn, ref.to(od), tables + 2 * n * d,
                      tables + 2 * e * d, graph=label, variant=variant,
                      out=str(od)[6:],
                      row_split=fa.ROW_SPLIT if new else None,
                      with_cast=not new and od != torch.float32)

    def attspmm_cases(label, lay, e, den, x, per_col, add):
        n, d = x.shape
        es, h = lay.num_slots, den.shape[1]
        ref = fa.attention_attspmm_plain(lay, e, den, x, per_col)
        for addend, od in ((None, torch.float32), (None, bf), (add, bf)):
            if new:
                fn = lambda a=addend, od=od: fa.attention_attspmm(  # noqa
                    lay, e, den, x, per_col, addend=a, out_dtype=od)
            elif addend is None:
                fn = lambda od=od: fa.attention_attspmm(  # noqa: E731
                    lay, e, den, x, per_col).to(od)
            else:
                fn = lambda a=addend, od=od: (a + fa.attention_attspmm(  # noqa
                    lay, e, den, x, per_col)).to(od)
            want = (ref if addend is None else addend + ref).to(od)
            # e, the table, the CSR, the addend and the output, and x once
            # or per edge
            tables = (4 * es * h + 4 * n * h + 4 * es + 4 * (n + 1)
                      + n * d * od.itemsize
                      + (4 * n * d if addend is not None else 0))
            timed("attention_attspmm", fn, want, tables + 2 * n * d,
                  tables + 2 * es * d, graph=label,
                  form="per_column" if per_col else "row",
                  addend=addend is not None, out=str(od)[6:],
                  row_split=fa.ROW_SPLIT if new else None,
                  with_cast=not new and (od != torch.float32
                                         or addend is not None))

    def accuracy(label, gr, cfg, att, x_enc):
        """flash's f32 output against the plain version on chip_smoke's
        operands, beside TOL_FLASH."""
        lay = gr.csr
        deg = (lay.ptr[1:] - lay.ptr[:-1]).cpu()
        for dt in (torch.float32, bf):
            name = str(dt)[6:]
            atol, rtol = here.TOL_FLASH[name]
            x = x_enc.to(dt).contiguous()
            p = fa.prep_inputs(cfg, att, gr, x)
            kt = fa.attention_kproj(x, p["wk"], p["bk"])
            scal = (cfg.attention_type, cfg.heads, p["ov2"], p["inv2l2"])
            for variant in ("softmax", "squareplus"):
                gs = fa.attention_gmax(lay, p["q"], kt, None, *scal) \
                    if variant == "squareplus" else None
                got = fa.flash_attention(lay, p["q"], x, kt, None, gs, *scal)
                want = fa.flash_attention_plain(lay, p["q"], x, kt, None, gs,
                                                *scal)
                err = (got - want).abs()
                ratio = err / (atol + rtol * want.abs())
                worst = int(ratio.argmax()) // want.shape[1]
                slack = here.squareplus_slack(lay, p["q"], x, kt, gs, scal) \
                    if variant == "squareplus" else 0.0
                held = err / (atol + slack + rtol * want.abs())
                emit(kernel="flash_attention", graph=label, check="accuracy",
                     x=name, variant=variant, max_abs_err=float(err.max()),
                     tol_flash=[atol, rtol], tol_ratio=float(ratio.max()),
                     worst_row_degree=int(deg[worst]),
                     rows_over_tol=int((ratio > 1).any(1).sum()),
                     tol_ratio_with_slack=float(held.max()),
                     slack_max=float(torch.as_tensor(slack).max()),
                     out_abs_median=float(want.abs().median()),
                     out_abs_max=float(want.abs().max()),
                     rounded_atol=2.0 ** -6 * float(x.float().abs().max()))

    routes = {}
    with torch.no_grad():
        # the CSR flash at the arxiv shapes (the CSR GRAND-nl model's q, Wk)
        tr = trs["CSR"]
        g, cfg, att = tr.data.graph, tr.cfg, tr.model.block.func.att
        tr.model.eval()
        x = tr.model.encode(tr.data.x, train=False).to(bf).contiguous()
        p = fa.prep_inputs(cfg, att, g, x)
        kt = fa.attention_kproj(x, p["wk"], p["bk"])
        scal = (cfg.attention_type, cfg.heads, p["ov2"], p["inv2l2"])
        cuts = (32, getattr(fa, "ROW_SPLIT", 128))
        emit(graph="arxiv CSR", N=g.num_nodes, E=g.csr.num_slots,
             **here.degree_shares(g.csr.ptr, cuts))
        flash_cases("arxiv CSR", g.csr, p["q"], x, kt, scal)
        routes["flash_attention_ax"] = (fa.flash_attention_ax, cfg, att, g, x)
        # the row form on path A's windowed residual, K5's half the addend
        tr = trs["A"]
        g, cfg, att = tr.data.graph, tr.cfg, tr.model.block.func.att
        tr.model.eval()
        x = tr.model.encode(tr.data.x, train=False).to(bf).contiguous()
        wl = g.windows
        q = linear_apply(att.Q, x).to(bf).contiguous()
        k = linear_apply(att.K, x).to(bf).contiguous()
        dk = cfg.attention_dim // cfg.heads
        q_s = (q / torch.sqrt(torch.tensor(dk, dtype=torch.float32)).to(bf)
               ).contiguous()
        kt = fa.attention_kproj(x, att.K.weight.t().to(bf).contiguous(),
                                att.K.bias.float().contiguous())
        scal = (cfg.attention_type, cfg.heads, 0.0, 0.0)
        r0 = fa.attention_gmax(wl.residual, q_s, kt, None, *scal)
        e, d_res = fa.attention_norm(wl.residual, q_s, kt, None, r0, *scal)
        out_win, den = wa.winatt(wl.in_window, q, k, x, d_res, r0, None,
                                 *scal)
        attspmm_cases("windowed residual", wl.residual, e, den, x, False,
                      out_win)
        routes["windowed_attention_ax_fast"] = (
            wa.windowed_attention_ax_fast, cfg, att, g, x)
        # per column on path B's CSR
        tr = trs["B"]
        g, cfg, att = tr.data.graph, tr.cfg, tr.model.block.func.att
        tr.model.eval()
        x = tr.model.encode(tr.data.x, train=False).to(bf).contiguous()
        p = fa.prep_inputs(cfg, att, g, x)
        kt = fa.attention_kproj(x, p["wk"], p["bk"])
        scal = (cfg.attention_type, cfg.heads, p["ov2"], p["inv2l2"])
        gs = fa.attention_gmax(g.csr, p["q"], kt, None, *scal)
        e, _ = fa.attention_norm(g.csr, p["q"], kt, None, gs, *scal)
        attspmm_cases("arxiv CSR", g.csr, e,
                      a3.column_denominators(g.csc, e), x, True,
                      torch.randn(x.shape, device="cuda"))
        routes["colnorm_attention_ax_fast"] = (
            a3.colnorm_attention_ax_fast, cfg, att, g, x)
        for name, (fn, *args) in routes.items():
            emit(route=name, ms=here.time_ms(lambda: fn(*args)))
        del routes, x, q, k, q_s, kt, e, den, out_win, d_res
        # the hub graph and the power-law graph, with the CSR GRAND-nl
        # model's own operands on its encoded state (chip_smoke's)
        tr = trs["CSR"]
        cfg, att = tr.cfg, tr.model.block.func.att
        tr.model.eval()
        x_enc = tr.model.encode(tr.data.x, train=False)
        gen = torch.Generator(device="cuda").manual_seed(2)
        for label, gr in (("hub", here.hub_graph("cuda")),
                          ("pareto", pareto_graph("cuda"))):
            emit(graph=label, N=gr.num_nodes, E=gr.num_edges,
                 **here.degree_shares(gr.csr.ptr, cuts))
            accuracy(label, gr, cfg, att, x_enc)
            x = x_enc.to(bf).contiguous()
            p = fa.prep_inputs(cfg, att, gr, x)
            kt = fa.attention_kproj(x, p["wk"], p["bk"])
            scal = (cfg.attention_type, cfg.heads, p["ov2"], p["inv2l2"])
            flash_cases(label, gr.csr, p["q"], x, kt, scal)
            gs = fa.attention_gmax(gr.csr, p["q"], kt, None, *scal)
            e, den = fa.attention_norm(gr.csr, p["q"], kt, None, gs, *scal)
            add = torch.randn(x.shape, generator=gen, device="cuda")
            dc = a3.column_denominators(gr.csc, e)
            attspmm_cases(label, gr.csr, e, den, x, False, add)
            attspmm_cases(label, gr.csr, e, dc, x, True, add)
            if new and label == "hub":  # the segment length
                for split in (64, 128, 256, 512):
                    fa.ROW_SPLIT = split
                    emit(graph=label, row_split=split, out="bfloat16",
                         flash_ms=here.time_ms(lambda: fa.flash_attention(
                             gr.csr, p["q"], x, kt, None, None, *scal,
                             out_dtype=bf)),
                         attspmm_row_ms=here.time_ms(
                             lambda: fa.attention_attspmm(
                                 gr.csr, e, den, x, out_dtype=bf)),
                         attspmm_per_column_ms=here.time_ms(
                             lambda: fa.attention_attspmm(
                                 gr.csr, e, dc, x, True, out_dtype=bf)))
                fa.ROW_SPLIT = cuts[1]
            del gr, x, p, kt, e, den, dc, add
    torch.cuda.empty_cache()
    # GRAND-nl's evaluation per NFE on the three routes
    for lab, tr in trs.items():
        tr.evaluate()
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.evaluate()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            nfe = tr.last_eval.nfe
            emit(path=f"GRAND-nl evaluation, {lab}", eval=i + 1, nfe=nfe,
                 seconds=sec, ms_per_nfe=sec * 1e3 / nfe)
    # one GRAND-nl train step on CSR, profiled
    tr = trs["CSR"]
    tr.train_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train_step()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
    cuda_t = torch.autograd.DeviceType.CUDA
    busy = flash_ms = 0.0
    flash_n = 0
    walk = {}   # the row walk's kernels by name: [launches, device ms]
    for ev in prof.events():
        if ev.device_type == cuda_t and not ev.name.startswith(
                "graphax_torch."):
            ms = ev.time_range.elapsed_us() / 1e3
            busy += ms
            if "flash" in ev.name or "seg_" in ev.name:
                flash_ms += ms
                flash_n += 1
            for k in ("flash_kernel", "flash_seg_stats", "flash_seg_sum",
                      "seg_combine", "attspmm_kernel", "attspmm_seg_sum"):
                if k in ev.name:
                    walk.setdefault(k, [0, 0.0])
                    walk[k][0] += 1
                    walk[k][1] += ms
    emit(path="GRAND-nl train step, CSR", host_ms=host,
         forward_nfe=tr.fm.get_value(), adjoint_nfe=tr.bm.get_value(),
         device_busy_ms=busy, flash_device_ms=flash_ms,
         flash_launches=flash_n, walk_kernels=walk)


def steady_epochs(emit, label, trainer, epochs: int = 3) -> None:
    """``trainer.fit(epochs)`` with its defaults: each epoch's seconds and
    forward, adjoint and evaluation NFE, and the fastest epoch after the
    first."""
    import torch

    fit = trainer.fit(epochs=epochs)
    torch.cuda.synchronize()
    times = [h["time"] for h in fit["history"]]
    emit(path=label, epoch_seconds=times, steady_epoch_seconds=min(times[1:]),
         nfe=[[sv.get(k) for k in ("nfe", "bwd_nfe", "eval_nfe")]
              for sv in fit["solver"]])


def spmm(emit) -> None:
    """The ``spmm`` measurements of the module's docstring."""
    import torch

    from graphax_torch import Trainer, best_config, get_dataset
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import spmm as spmm_mod

    here = this_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    data = get_dataset("ogbn-arxiv")
    trs = {"windowed": Trainer(best_config("ogbn-arxiv"), data),
           "CSR": Trainer(best_config("ogbn-arxiv", community_window=0),
                          data)}
    g = trs["CSR"].data.graph
    gw = trs["windowed"].data.graph
    gen = torch.Generator(device="cuda").manual_seed(0)
    # (label, CSR, CSC, f32 values per position of the edge buffer that
    # the layouts' perms index; a CSR without a perm holds its prefix)
    graphs = [("arxiv CSR", g.csr, g.csc, g.edge_weight),
              ("windowed residual", gw.windows.residual,
               gw.windows.residual_t,
               torch.rand(gw.edge_buffer_size, generator=gen, device="cuda")
               + 0.1)]
    for label, gr in (("hub", here.hub_graph("cuda")),
                      ("pareto", pareto_graph("cuda"))):
        graphs.append((label, gr.csr, gr.csc,
                       torch.rand(gr.edge_buffer_size, generator=gen,
                                  device="cuda") + 0.1))
    n, d = g.num_nodes, 162
    for dt in (torch.bfloat16, torch.float32):
        name, b = str(dt)[6:], dt.itemsize
        x = torch.randn(n, d, generator=gen, device="cuda").to(dt)
        for label, csr, csc, w in graphs:
            w = w.to(dt)
            vals = (w[:csr.num_slots] if csr.perm is None
                    else w[csr.perm]).contiguous()
            vals_t = w[csc.perm].contiguous()
            e = csr.num_slots
            for prod, lay, v in (("A.x", csr, vals), ("AT.g", csc, vals_t)):
                fn = lambda lay=lay, v=v: spmm_mod.spmm_csr(  # noqa: E731
                    lay, v, x, n)
                want = spmm_mod.spmm_csr_plain(lay, v, x, n)
                err = float((fn().float() - want.float()).abs().max())
                nbytes = 2 * n * d * b + e * (b + 4) + 4 * (n + 1)
                miss = e * (d * b + 8) + n * d * b
                row = dict(kernel="spmm_csr", graph=label, product=prod,
                           dtype=name, E=e, ms=here.time_ms(fn),
                           max_abs_err=err,
                           bound_ms=nbytes / here.HBM_BYTES_PER_S * 1e3,
                           all_miss_ms=miss / here.HBM_BYTES_PER_S * 1e3)
                if label == "arxiv CSR":
                    sp = torch.sparse_csr_tensor(lay.ptr.long(),
                                                 lay.idx.long(), v[:e],
                                                 size=(n, n))
                    row["library"] = "torch.sparse.mm"
                    row["library_ms"] = here.time_ms(
                        lambda: torch.sparse.mm(sp, x), reps=10)
                    del sp
                emit(**row)
        del x
        torch.cuda.empty_cache()
    for label, tr in trs.items():
        steady_epochs(emit, f"arxiv {label}", tr)


def pin_call(fn, lay, q, kt, ew, scal, bel, out, kvec, wpb):
    """``gx_attention_pin`` of a checkout's library (this one's or a
    parent's whose C signature takes beltrami_exp's two scalars) on the K
    table ``kt`` into ``out``, with the host's ``kvec`` and warps a block
    given."""
    import torch

    from graphax_torch.kernels import _build
    from graphax_torch.kernels import fused_attention as fa

    n, a = q.shape
    heads = scal[1]
    plan, nlong, nseg = fa._row_plan(lay, fa._BATCH, fa.ROW_SPLIT)
    pin_call.keep = torch.empty((nseg, 2 * heads), device=q.device)
    return fn(lay.ptr.data_ptr(), lay.idx.data_ptr(), q.data_ptr(),
              kt.data_ptr(), ew.data_ptr() if ew is not None else None,
              plan.data_ptr(), pin_call.keep.data_ptr(), out.data_ptr(), n,
              a, heads, fa.ATT_TYPES[scal[0]], float(scal[2]),
              float(scal[3]), float(bel.get("ov2p", 1.0)),
              float(bel.get("inv2l2p", 0.5)), fa._DTYPES[q.dtype], kvec, wpb,
              fa.ROW_SPLIT, nlong, nseg, _build.stream_ptr(q))


def regular_graph(device, n=169_343, k=64, seed=9):
    """A graph at ogbn-arxiv's N whose every row has ``k`` edges to
    distinct random columns: the shape of BLEND path (c)'s kNN graph (k
    64, every row over 32 edges, so the pin walks all of it in its segment
    kernels), built from a seed without the encoder."""
    import numpy as np

    from graphax_torch.sparse.graph import Graph

    rng = np.random.RandomState(seed)
    # k + 8 draws a row, sorted; repeats pushed past the end; the first k
    cand = np.sort(rng.randint(0, n, (n, k + 8)), axis=1)
    cand[:, 1:][cand[:, 1:] == cand[:, :-1]] = n
    col = np.sort(cand, axis=1)[:, :k]
    assert (col < n).all()
    return Graph.from_edges(np.repeat(np.arange(n), k), col.reshape(-1), n,
                            device=device)


def pin(emit, parent=None) -> None:
    """The ``pin`` measurements of the module's docstring."""
    import torch

    from graphax_torch import Trainer, best_config, get_dataset
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import attention_pin as pin_mod
    from graphax_torch.kernels import fused_attention as fa

    here = this_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    plib = parent_library(parent, "attention_pin") if parent else None
    gen = torch.Generator(device="cuda").manual_seed(0)

    def row_of(label, lay, q, x, wk, bk, scal, bel):
        """The wrapper's ms, error and bound; its walk alone on the same K
        table (this checkout's host rule, and with a parent the parent's
        kernel by the parent's rule: ``parent_equal``, ``parent_walk_ms``;
        in beltrami_exp the one-value route's bits)."""
        (n, d), a, heads = x.shape, q.shape[1], scal[1]
        e, b, name = lay.num_slots, x.element_size(), str(x.dtype)[6:]
        args = (lay, q, x, wk, bk, None, *scal)
        fn = lambda: pin_mod.attention_pin(*args, **bel)  # noqa: E731
        got = fn()
        err = float((got - pin_mod.attention_pin_plain(*args, **bel))
                    .abs().max())
        nbytes = (n * d * b + n * a * b + d * a * b + 4 * a + 4 * e
                  + 4 * (n + 1) + 4 * e)
        per_value = 3.0 if scal[0] == "beltrami_exp" else 2.0
        bms, by = here.bound_ms(nbytes, 2.0 * n * d * a + e * (
            per_value * a + (8 if per_value == 3.0 else 6) * heads), name)
        kt = fa.attention_kproj(x, wk, bk)
        out = torch.empty_like(got)
        kvec = fa.flash_kvec(kt, heads, scal[0])
        wpb = fa.flash_warps(a, heads, scal[0])
        walk = lambda: pin_call(  # noqa: E731
            _build.library("attention_pin").gx_attention_pin, lay, q, kt,
            None, scal, bel, out, kvec, wpb)
        _build.check(walk(), "attention_pin")
        row = dict(kernel="attention_pin", att_type=scal[0], graph=label,
                   dtype=name, N=n, E=e, D=d, A=a, H=heads, kvec=kvec,
                   wpb=wpb, ms=here.time_ms(fn), max_abs_err=err,
                   walk_ms=here.time_ms(walk),
                   walk_equal=bool(torch.equal(out, got)),
                   bound_ms=bms, bound_by=by,
                   all_miss_ms=(nbytes + 4 * n * a + 4 * e * a)
                   / here.HBM_BYTES_PER_S * 1e3,
                   kproj_ms=here.time_ms(
                       lambda: fa.attention_kproj(x, wk, bk)))
        if scal[0] == "beltrami_exp" and kvec:
            one = torch.empty_like(got)
            _build.check(pin_call(
                _build.library("attention_pin").gx_attention_pin, lay, q, kt,
                None, scal, bel, one, 0, wpb), "attention_pin")
            row["one_value_equal"] = bool(torch.equal(one, got))
        if plib is not None:   # the parent's walk by the parent's rule
            old = torch.empty_like(got)
            pkvec = int((a // heads) % 4 == 0 and kt.data_ptr() % 16 == 0)
            pwalk = lambda: pin_call(  # noqa: E731
                plib.gx_attention_pin, lay, q, kt, None, scal, bel, old,
                pkvec, fa.flash_warps(a, heads))
            _build.check(pwalk(), "parent attention_pin")
            row.update(parent_equal=bool(torch.equal(got, old)),
                       parent_max_diff=float((got - old).abs().max()),
                       parent_walk_ms=here.time_ms(pwalk))
        emit(**row)

    def case(label, graph, dt, d, a, heads, att_type="scaled_dot"):
        n = graph.num_nodes
        q = torch.randn(n, a, generator=gen, device="cuda").mul(0.3).to(dt)
        x = torch.randn(n, d, generator=gen, device="cuda").to(dt)
        wk = torch.randn(d, a, generator=gen, device="cuda").mul(0.1).to(dt)
        bk = torch.randn(a, generator=gen, device="cuda").mul(0.1)
        with torch.no_grad():
            row_of(label, graph.csr, q, x, wk, bk,
                   (att_type, heads, 1.3, 0.7), {})

    data = get_dataset("ogbn-arxiv")
    g = Trainer(best_config("ogbn-arxiv", community_window=0),
                data).data.graph
    hub = here.hub_graph("cuda")
    # beltrami_exp at path (a)'s and (c)'s shapes: path (b)'s operands
    # (the same K table 2 x 32 wide), on the arxiv CSR, the hub graph and
    # the kNN graph's shape
    dts = (torch.bfloat16, torch.float32)
    tr, ops = blend_operands(data, dts)
    knn = regular_graph("cuda")
    with torch.no_grad():
        for dt in dts:
            o = ops[dt]
            for label, gr in (("arxiv CSR", g), ("hub", hub),
                              ("64-regular", knn)):
                row_of(label, gr.csr, o["q"], o["x"], o["wk"], o["bk"],
                       o["scal"], o["bel"])
    del tr, ops, knn
    torch.cuda.empty_cache()
    for dt in dts:
        case("arxiv CSR", g, dt, 162, 32, 2)
    for att_type in ("cosine_sim", "pearson", "exp_kernel"):
        case("arxiv CSR", g, torch.bfloat16, 162, 32, 2, att_type)
    for label, gr in (("hub", hub), ("pareto", pareto_graph("cuda"))):
        case(label, gr, torch.bfloat16, 162, 32, 2)
    del data, g, hub
    torch.cuda.empty_cache()
    for ds in ("Computers", "Photo"):
        cfg = best_config(ds)
        tr = Trainer(cfg, get_dataset(ds))
        case(ds, tr.data.graph, torch.float32, cfg.hidden_dim,
             cfg.attention_dim, cfg.heads)
        steady_epochs(emit, ds, tr)
        del tr
        torch.cuda.empty_cache()


def kproj(emit) -> None:
    """The ``kproj`` measurements of the module's docstring."""
    import torch

    from graphax_torch import Trainer, best_config, get_dataset
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import attention_pin as pin_mod
    from graphax_torch.kernels import fused_attention as fa

    here = this_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(21)
    trs = {ds: Trainer(best_config(ds), get_dataset(ds))
           for ds in ("Computers", "Photo")}
    shapes = [("arxiv", 169_343, 162, 32)] + [
        (ds, tr.data.num_nodes, tr.cfg.hidden_dim, tr.cfg.attention_dim)
        for ds, tr in trs.items()] + [("D400 A120", 169_343, 400, 120)]
    with torch.no_grad():
        for label, n, d, a in shapes:
            x = torch.randn(n, d, generator=gen, device="cuda")
            wk = torch.randn(d, a, generator=gen, device="cuda") / d ** 0.5
            bk = 0.1 * torch.randn(a, generator=gen, device="cuda")
            bms, by = here.bound_ms(4 * (n * d + d * a + a + n * a),
                                    2.0 * n * d * a, "float32")
            row = dict(kernel="attention_kproj", dtype="float32",
                       shape=label, N=n, D=d, A=a, bound_ms=bms, bound_by=by,
                       library="addmm out_dtype=float32",
                       library_ms=here.time_ms(lambda: torch.addmm(
                           bk, x, wk, out_dtype=torch.float32), reps=10))
            fn = lambda: fa.attention_kproj(x, wk, bk)  # noqa: E731
            try:
                got = fn()
            except ValueError as exc:   # the parent's shared-memory gate
                emit(**row, refused=str(exc))
                continue
            emit(**row, ms=here.time_ms(fn), max_abs_err=float(
                (got - fa.attention_kproj_plain(x, wk, bk)).abs().max()))
            del x, wk, bk, got
        g = Trainer(best_config("ogbn-arxiv", community_window=0),
                    get_dataset("ogbn-arxiv")).data.graph
        n, e, d, a, heads = g.num_nodes, g.num_edges, 162, 32, 2
        q = torch.randn(n, a, generator=gen, device="cuda").mul(0.3)
        x = torch.randn(n, d, generator=gen, device="cuda")
        wk = torch.randn(d, a, generator=gen, device="cuda").mul(0.1)
        bk = torch.randn(a, generator=gen, device="cuda").mul(0.1)
        args = (g.csr, q, x, wk, bk, None, "scaled_dot", heads)
        fn = lambda: pin_mod.attention_pin(*args)  # noqa: E731
        emit(kernel="attention_pin", graph="arxiv CSR", dtype="float32",
             ms=here.time_ms(fn), max_abs_err=float(
                 (fn() - pin_mod.attention_pin_plain(*args)).abs().max()),
             kproj_ms=here.time_ms(lambda: fa.attention_kproj(x, wk, bk)))
        del g, q, x, wk, bk
    torch.cuda.empty_cache()
    for ds, tr in trs.items():
        steady_epochs(emit, ds, tr, epochs=6)


def slab(emit) -> None:
    """The ``slab`` measurements of the module's docstring."""
    import torch

    from graphax_torch import Trainer, best_config, get_dataset
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import windowed_spmm as ws

    here = this_chip_smoke()
    new = "out_dtype" in inspect.signature(ws.win_bwd_slab).parameters
    bf = torch.bfloat16
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    data = get_dataset("ogbn-arxiv")
    trs = {"windowed": Trainer(best_config("ogbn-arxiv"), data),
           "CSR": Trainer(best_config("ogbn-arxiv", community_window=0),
                          data)}
    wl = trs["windowed"].data.graph.windows
    n, d, wn, w = wl.num_nodes, 162, wl.num_windows, wl.window
    cells = wl.num_tiles * wl.tile * w
    per_win = (wl.win_ptr[1:] - wl.win_ptr[:-1]).float()
    emit(layout="windowed arxiv", T=wl.num_tiles, Wn=wn, W=w,
         tiles_per_window_max=int(per_win.max()),
         tiles_per_window_mean=float(per_win.mean()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    vals = torch.rand(trs["windowed"].data.graph.edge_buffer_size,
                      generator=gen, device="cuda")
    dense = ws.densify(wl, vals, bf)
    g = torch.randn(n, d, generator=gen, device="cuda").to(bf)
    ref = ws._tiles(g.float(), wl)
    want = torch.zeros(wn, w, d, device="cuda").index_add_(
        0, wl.tile_win.long(), torch.bmm(dense.float().transpose(1, 2), ref)
    ).reshape(wn * w, d)[:n]
    del ref
    g_t = ws._tiles(g, wl)
    tw = wl.tile_win.long()
    for od in (torch.float32, bf):
        if new:
            fn = lambda od=od: ws.win_bwd_slab(wl, dense, g, od)  # noqa
        elif od == torch.float32:
            fn = lambda: ws.win_bwd_slab(wl, dense, g)[:n]  # noqa: E731
        else:
            fn = lambda: ws.win_bwd_slab(wl, dense, g)[:n].to(bf)  # noqa
        err = float((fn().float() - want.to(od).float()).abs().max())
        bms, by = here.bound_ms(cells * 2 + n * d * 2 + n * d * od.itemsize,
                                2.0 * cells * d, "bfloat16")
        emit(kernel="win_bwd_slab", dtype="bfloat16", out=str(od)[6:],
             ms=here.time_ms(fn), max_abs_err=err, bound_ms=bms, bound_by=by,
             with_cast=not new and od != torch.float32,
             two_calls="bmm out_dtype=float32 + index_add_",
             two_calls_ms=here.time_ms(
                 lambda: torch.zeros(wn, w, d, device="cuda").index_add_(
                     0, tw, torch.bmm(dense.transpose(1, 2), g_t,
                                      out_dtype=torch.float32)), reps=5))
    del dense, g, g_t, want
    torch.cuda.empty_cache()
    for label, tr in trs.items():
        steady_epochs(emit, f"arxiv {label}", tr)
    del trs
    torch.cuda.empty_cache()
    train_steps(data, emit)


def parent_library(parent: str, name: str):
    """The parent checkout's library ``csrc/<name>.cu``, built by its own
    ``_build`` into its own build directory and loaded with its own C
    signatures, for calls beside this checkout's kernel on the same
    inputs."""
    key = "parent_build"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(parent, "graphax_torch", "kernels", "_build.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key].library(name)


def gmax_call(fn, lay, q, kt, state, out, heads, scal, dt, bel=None):
    """``gx_attention_gmax`` of a checkout's library on ``lay`` without
    reweight, by the C signature it has: PR 12's (16 arguments: the row
    pointer and N), PR 13's (17: each slot's row and E) or PR 21's (19:
    beltrami_exp's two scalars, ``bel``'s, after exp_kernel's)."""
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import fused_attention as fa

    n, a = q.shape
    att, ov2, inv2l2 = fa.ATT_TYPES[scal[0]], scal[2], scal[3]
    stream = _build.stream_ptr(q)
    ptrs = (q.data_ptr(), kt.data_ptr(), None, state.data_ptr(),
            out.data_ptr())
    if len(fn.argtypes) == 16:
        return fn(lay.ptr.data_ptr(), lay.idx.data_ptr(), *ptrs, n, a, heads,
                  att, 0, ov2, inv2l2, fa._DTYPES[dt], stream)
    bel = bel or {}
    extra = (bel.get("ov2p", 1.0), bel.get("inv2l2p", 0.5)) \
        if len(fn.argtypes) == 19 else ()
    qvec = fa.score_vec(q, kt, heads, scal[0])
    return fn(lay.seg.data_ptr(), lay.idx.data_ptr(), *ptrs, lay.num_slots,
              a, heads, att, 0, ov2, inv2l2, *extra,
              fa._DTYPES[dt], qvec, stream)


def path_a_inputs(tr, dt):
    """Path A's operands of K5 and of the residual as
    ``windowed_attention_ax_fast`` makes them, from the windowed GRAND-nl
    model's encoded state in ``dt``."""
    import torch

    from graphax_torch.kernels import fused_attention as fa
    from graphax_torch.utils.params import linear_apply

    g, cfg, att = tr.data.graph, tr.cfg, tr.model.block.func.att
    tr.model.eval()
    with torch.no_grad():
        x = tr.model.encode(tr.data.x, train=False).to(dt).contiguous()
        q = linear_apply(att.Q, x).to(dt).contiguous()
        k = linear_apply(att.K, x).to(dt).contiguous()
        dk = cfg.attention_dim // cfg.heads
        q_s = (q / torch.sqrt(torch.tensor(dk, dtype=torch.float32)).to(dt)
               ).contiguous()
        kt = fa.attention_kproj(x, att.K.weight.t().to(dt).contiguous(),
                                att.K.bias.float().contiguous())
    return dict(g=g, cfg=cfg, att=att, x=x, q=q, k=k, q_s=q_s, kt=kt,
                scal=(cfg.attention_type, cfg.heads, 0.0, 0.0))


def winatt(emit, parent=None) -> None:
    """The ``winatt`` measurements of the module's docstring."""
    import time

    import torch

    import chip_smoke as cs
    from graphax_torch import best_config, get_dataset
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import fused_attention as fa
    from graphax_torch.kernels import winatt as wa

    here = this_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    data = get_dataset("ogbn-arxiv")
    tr = cs.nl_trainer(best_config("ogbn-arxiv", block="constant",
                                   function="transformer"), data)
    win = tr.data.graph.windows.in_window
    res = tr.data.graph.windows.residual
    emit(layout="in-window cells", N=win.num_rows, E=win.num_slots,
         **here.degree_shares(win.ptr, (8, 16, 32, 128)))
    long_g = here.long_row_windows("cuda")
    for dt in (torch.bfloat16, torch.float32):
        name, b = str(dt)[6:], dt.itemsize
        p = path_a_inputs(tr, dt)
        x, q, k, scal = p["x"], p["q"], p["k"], p["scal"]
        long_rows(emit, here, parent, long_g, p, dt)
        n, d = x.shape
        a, heads = q.shape[1], scal[1]
        with torch.no_grad():
            r0 = fa.attention_gmax(res, p["q_s"], p["kt"], None, *scal)
            _, d_res = fa.attention_norm(res, p["q_s"], p["kt"], None, r0,
                                         *scal)
            ref_out, ref_den = wa.winatt_plain(win, q, k, x, d_res, r0, None,
                                               *scal)
            old = None
            if parent is not None:   # the parent's kernel, same inputs
                lib = parent_library(parent, "winatt")
                sc = torch.empty(win.num_slots, heads, device="cuda")
                old = (torch.empty(n, d, device="cuda"),
                       torch.empty(n, heads, device="cuda"))
                _build.check(lib.gx_winatt(
                    win.ptr.data_ptr(), win.idx.data_ptr(), q.data_ptr(),
                    k.data_ptr(), x.data_ptr(), None, d_res.data_ptr(),
                    r0.data_ptr(), sc.data_ptr(), old[0].data_ptr(),
                    old[1].data_ptr(), n, d, a, heads, fa.ATT_TYPES[scal[0]],
                    0, scal[2], scal[3], fa._DTYPES[dt],
                    _build.stream_ptr(x)), "parent winatt")
                del sc
            e_w = win.num_slots
            tabs = 4 * n * heads
            nbytes = (2 * n * a * b + n * d * b + 4 * e_w + 4 * (n + 1)
                      + tabs + 4 + 4 * n * d + tabs)
            miss = nbytes - n * a * b - n * d * b + e_w * (a * b + d * b)
            bms, by = here.bound_ms(nbytes, e_w * (2.0 * a + 4.0 * heads
                                                  + 2.0 * d), name)
            atol, rtol = here.tol_rounded(name, x)
            fn = lambda: wa.winatt(win, q, k, x, d_res, r0,  # noqa
                                   None, *scal)
            out, den = fn()
            row = dict(kernel="winatt", dtype=name,
                       lanes=getattr(wa, "LANES", None),
                       ms=here.time_ms(fn), bound_ms=bms, bound_by=by,
                       all_miss_ms=miss / here.HBM_BYTES_PER_S * 1e3,
                       max_abs_err=max(
                           float((out - ref_out).abs().max()),
                           float((den - ref_den).abs().max())),
                       out_tol_ratio=float(((out - ref_out).abs() / (
                           atol + rtol * ref_out.abs())).max()),
                       den_tol_ratio=float(((den - ref_den).abs() / (
                           2e-5 + 2e-4 * ref_den.abs())).max()))
            if old is not None:
                deg = (win.ptr[1:] - win.ptr[:-1]).long()
                rows = ((out != old[0]).any(1) | (den != old[1]).any(1))
                row.update(
                    parent_out_equal=bool(torch.equal(out, old[0])),
                    parent_den_equal=bool(torch.equal(den, old[1])),
                    parent_max_abs_diff=max(
                        float((out - old[0]).abs().max()),
                        float((den - old[1]).abs().max())),
                    parent_rows_differing=int(rows.sum()),
                    parent_shortest_differing_row=int(
                        deg[rows].min()) if bool(rows.any()) else None)
            emit(**row)
            # the route as the RHS calls it: path A's RHS alone
            emit(route="windowed_attention_ax_fast", dtype=name,
                 ms=here.time_ms(lambda: wa.windowed_attention_ax_fast(
                     p["cfg"], p["att"], p["g"], x)),
                 host_ms=host_ms(lambda: wa.windowed_attention_ax_fast(
                     p["cfg"], p["att"], p["g"], x)))
        del p, x, q, k, r0, d_res, ref_out, ref_den, old
        torch.cuda.empty_cache()
    # path A's evaluation per NFE
    tr.evaluate()
    for i in range(3):
        _build.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.evaluate()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        emit(path="GRAND-nl evaluation, A", eval=i + 1,
             nfe=tr.last_eval.nfe, seconds=sec,
             ms_per_nfe=sec * 1e3 / tr.last_eval.nfe,
             winatt_launches=_build.LAUNCHES["winatt"])


def long_rows(emit, here, parent, g, p, dt) -> None:
    """K5 on chip_smoke's ``long_row_windows`` (in-window rows of up to a
    whole window of 512 cells at arxiv's N) with path A's q, k and x, r0
    and d_res from its residual; with ``parent``, the parent's kernel on
    the same inputs."""
    import torch

    from graphax_torch.kernels import _build
    from graphax_torch.kernels import fused_attention as fa
    from graphax_torch.kernels import winatt as wa

    win, res = g.windows.in_window, g.windows.residual
    x, q, k, scal = p["x"], p["q"], p["k"], p["scal"]
    n, d = x.shape
    a, heads = q.shape[1], scal[1]
    with torch.no_grad():
        r0 = fa.attention_gmax(res, p["q_s"], p["kt"], None, *scal)
        _, d_res = fa.attention_norm(res, p["q_s"], p["kt"], None, r0, *scal)
        fn = lambda: wa.winatt(win, q, k, x, d_res, r0, None,  # noqa: E731
                               *scal)
        out, den = fn()
        want = wa.winatt_plain(win, q, k, x, d_res, r0, None, *scal)
        row = dict(kernel="winatt", graph="long rows", dtype=str(dt)[6:],
                   E=win.num_slots, ms=here.time_ms(fn),
                   plain_ms=here.time_ms(lambda: wa.winatt_plain(
                       win, q, k, x, d_res, r0, None, *scal), reps=5),
                   max_abs_err=max(float((out - want[0]).abs().max()),
                                   float((den - want[1]).abs().max())))
        if parent is not None:
            lib = parent_library(parent, "winatt")
            sc = torch.empty(win.num_slots, heads, device="cuda")
            old = (torch.empty(n, d, device="cuda"),
                   torch.empty(n, heads, device="cuda"))
            args = (win.ptr.data_ptr(), win.idx.data_ptr(), q.data_ptr(),
                    k.data_ptr(), x.data_ptr(), None, d_res.data_ptr(),
                    r0.data_ptr(), sc.data_ptr(), old[0].data_ptr(),
                    old[1].data_ptr(), n, d, a, heads,
                    fa.ATT_TYPES[scal[0]], 0, scal[2], scal[3],
                    fa._DTYPES[dt], _build.stream_ptr(x))
            _build.check(lib.gx_winatt(*args), "parent winatt")
            row.update(parent_ms=here.time_ms(lambda: lib.gx_winatt(*args)),
                       parent_max_abs_diff=max(
                           float((out - old[0]).abs().max()),
                           float((den - old[1]).abs().max())))
        emit(**row)


def gmax(emit, parent=None) -> None:
    """The ``gmax`` measurements of the module's docstring."""
    import time

    import torch

    import chip_smoke as cs
    from graphax_torch import best_config, get_dataset
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import fused_attention as fa

    here = this_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    new = hasattr(fa, "score_vec")
    data = get_dataset("ogbn-arxiv")
    base = dict(block="constant", function="transformer")
    tr_a = cs.nl_trainer(best_config("ogbn-arxiv", **base), data)
    tr_c = cs.nl_trainer(best_config("ogbn-arxiv", community_window=0,
                                     **base), data)
    plib = parent_library(parent, "fused_attention") if parent else None

    def case(label, lay, q, kt, scal, dt, bel=None):
        n, a = q.shape
        e, heads, b = lay.num_slots, scal[1], dt.itemsize
        bel = bel or {}
        fn = lambda: fa.attention_gmax(lay, q, kt, None, *scal,  # noqa
                                       **bel)
        got = fn()
        want = fa.attention_gmax_plain(lay, q, kt, None, *scal, **bel)
        nbytes = n * a * b + 4 * n * a + 4 * e + 4 * (n + 1)
        # beltrami_exp: per slot the two squared distances (3 operations a
        # value) and two exps a head, as chip_smoke counts them
        ops = e * (3.0 * a + 8 * heads) if bel else e * 2.0 * a
        bms, by = here.bound_ms(nbytes, ops, str(dt)[6:])
        row = dict(kernel="attention_gmax", graph=label, dtype=str(dt)[6:],
                   att_type=scal[0], E=e, ms=here.time_ms(fn),
                   value=float(got),
                   max_abs_err=float((got - want).abs()), bound_ms=bms,
                   bound_by=by, all_miss_ms=(nbytes - 4 * n * a + 4 * e * a)
                   / here.HBM_BYTES_PER_S * 1e3)
        if new:   # the same kernel with a fresh zeroed state each call
            out = torch.empty((), device="cuda")
            lib = _build.library("fused_attention")

            def fresh():
                st = torch.zeros(2, dtype=torch.int32, device="cuda")
                gmax_call(lib.gx_attention_gmax, lay, q, kt, st, out, heads,
                          scal, dt, bel)
            row["fresh_state_ms"] = here.time_ms(fresh)
            if hasattr(fa, "flash_kvec"):
                row["qvec"] = fa.score_vec(q, kt, heads, scal[0])
        if plib is not None:
            old = torch.empty((), device="cuda")
            st = torch.zeros(2, dtype=torch.int32, device="cuda")
            call = lambda: gmax_call(  # noqa: E731
                plib.gx_attention_gmax, lay, q, kt, st, old, heads, scal, dt,
                bel)
            _build.check(call(), "parent gmax")
            row.update(parent_value=float(old),
                       parent_equal=bool(torch.equal(got, old)),
                       parent_ms=here.time_ms(call))
        emit(**row)

    if hasattr(fa, "score_args"):   # a checkout with beltrami_exp: path (b)
        dts = (torch.bfloat16, torch.float32)
        btr, ops = blend_operands(data, dts)
        g = btr.data.graph
        hub = here.hub_graph("cuda")
        with torch.no_grad():
            for dt in dts:
                o = ops[dt]
                for label, lay in (("blend b CSR", g.csr),
                                   ("blend b hub", hub.csr)):
                    case(label, lay, o["q"], o["kt"], o["scal"], dt,
                         o["bel"])
        del btr, g, ops, hub, o
        torch.cuda.empty_cache()

    with torch.no_grad():
        for dt in (torch.bfloat16, torch.float32):
            p = path_a_inputs(tr_a, dt)
            case("windowed residual", p["g"].windows.residual, p["q_s"],
                 p["kt"], p["scal"], dt)
            del p
            # the CSR model's operands, as chip_smoke takes them
            cfg, att = tr_c.cfg, tr_c.model.block.func.att
            tr_c.model.eval()
            x_enc = tr_c.model.encode(tr_c.data.x, train=False)
            for label, gr in (("arxiv CSR", tr_c.data.graph),
                              ("hub", here.hub_graph("cuda")),
                              ("pareto", pareto_graph("cuda"))):
                x = x_enc.to(dt).contiguous()
                ops = fa.prep_inputs(cfg, att, gr, x)
                kt = fa.attention_kproj(x, ops["wk"], ops["bk"])
                case(label, gr.csr, ops["q"], kt,
                     (cfg.attention_type, cfg.heads, ops["ov2"],
                      ops["inv2l2"]), dt)
                del gr, x, ops, kt
            torch.cuda.empty_cache()
    # a squareplus evaluation on CSR (gmax once per NFE) and the softmax
    # one (no gmax), per NFE
    sq = cs.nl_trainer(best_config("ogbn-arxiv", community_window=0,
                                   square_plus=True, **base), data)
    for label, t in (("GRAND-nl squareplus evaluation, CSR", sq),
                     ("GRAND-nl evaluation, CSR", tr_c)):
        t.evaluate()
        for i in range(3):
            _build.LAUNCHES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.evaluate()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            emit(path=label, eval=i + 1, nfe=t.last_eval.nfe, seconds=sec,
                 ms_per_nfe=sec * 1e3 / t.last_eval.nfe,
                 gmax_launches=_build.LAUNCHES["attention_gmax"])


def profiled_train_step(emit, tr, label, kernels) -> None:
    """One ``tr.train_step()`` after a warm-up one, under torch.profiler:
    the host ms, forward and adjoint NFE, the device's busy ms, the
    adjoint span's device ms, and the launches and device ms of each of
    ``kernels`` (parts of kernel names)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    tr.train_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train_step()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
    cuda_t = torch.autograd.DeviceType.CUDA
    busy = adjoint_ms = 0.0
    by = {k: [0, 0.0] for k in kernels}
    for ev in prof.events():
        if ev.device_type != cuda_t:
            continue
        ms = ev.time_range.elapsed_us() / 1e3
        if ev.name == "graphax_torch.adjoint":
            adjoint_ms += ms
        elif not ev.name.startswith("graphax_torch."):
            busy += ms
            for k in kernels:
                if k in ev.name:
                    by[k][0] += 1
                    by[k][1] += ms
    emit(path=label, host_ms=host, forward_nfe=tr.fm.get_value(),
         adjoint_nfe=tr.bm.get_value(), device_busy_ms=busy,
         adjoint_device_ms=adjoint_ms, kernels=by)


def evaluations(emit, tr, label, evals: int = 3) -> None:
    """``evals`` evaluations of ``tr`` after a warm-up one: NFE, seconds
    and ms per NFE (host clock around a device sync)."""
    import time

    import torch

    tr.evaluate()
    for i in range(evals):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.evaluate()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        emit(path=label, eval=i + 1, nfe=tr.last_eval.nfe, seconds=sec,
             ms_per_nfe=sec * 1e3 / tr.last_eval.nfe)


def differ(got, old, lengths) -> dict:
    """How ``got`` and the parent's ``old`` (per-node rows) differ: equal
    bit for bit, the largest difference, the rows that differ and the
    shortest of them (``lengths``: each row's slots)."""
    import torch

    rows = (got != old).reshape(got.shape[0], -1).any(1)
    return dict(equal=bool(torch.equal(got, old)),
                max_abs_diff=float((got - old).abs().max()),
                rows_differing=int(rows.sum()),
                shortest_differing=int(lengths[rows].min())
                if bool(rows.any()) else None)


def bwd_cols(emit, parent=None) -> None:
    """The ``bwd_cols`` measurements of the module's docstring."""
    import torch

    import chip_smoke as cs
    from graphax_torch import best_config, get_dataset
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import fused_attention as fa

    here = this_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    data = get_dataset("ogbn-arxiv")
    tr = cs.nl_trainer(best_config("ogbn-arxiv", community_window=0,
                                   block="constant", function="transformer"),
                       data)
    plib = parent_library(parent, "fused_attention") if parent else None
    cfg, att, g = tr.cfg, tr.model.block.func.att, tr.data.graph
    heads = cfg.heads
    tr.model.eval()
    with torch.no_grad():
        x_enc = tr.model.encode(tr.data.x, train=False)
    n, d = x_enc.shape
    gen = torch.Generator(device="cuda").manual_seed(12)
    cot = torch.randn(n, d, generator=gen, device="cuda")
    # (label, the rows' CSR, the columns' CSC): the transposed graphs' CSC
    # is the graph's CSR, so their hub rows become hub columns
    hub, par = here.hub_graph("cuda"), pareto_graph("cuda")
    cases = (("arxiv CSR", g.csr, g.csc), ("hub transposed", hub.csc, hub.csr),
             ("pareto transposed", par.csc, par.csr))
    for label, rows, cols in cases[1:]:
        emit(graph=label, N=cols.num_rows, E=cols.num_slots,
             columns=here.degree_shares(cols.ptr, (32, 128)))
    for dt in (torch.bfloat16, torch.float32):
        name, b = str(dt)[6:], dt.itemsize
        x = x_enc.to(dt).contiguous()
        c = cot.to(dt).contiguous()
        with torch.no_grad():
            p = fa.prep_inputs(cfg, att, g, x)
            q = p["q"]
            kt = fa.attention_kproj(x, p["wk"], p["bk"])
            a = q.shape[1]
            for label, rows, cols in cases:
                _, sc, shift, denom = fa.attention_fwd_res(rows, q, x, kt,
                                                           heads)
                _, rho = fa.attention_bwd_rows(rows, sc, shift, denom, c, x,
                                               kt, heads)
                del sc
                args = (cols, q, c, x, kt, shift, denom, rho, heads)
                fn = lambda: fa.attention_bwd_cols(*args)  # noqa: E731
                dk, dxv = fn()
                w_dk, w_dxv = fa.attention_bwd_cols_plain(*args)
                e = cols.num_slots
                tabs = 4 * n * heads
                nbytes = (n * a * b + 2 * n * d * b + 4 * n * a + 3 * tabs
                          + 4 * e + 4 * (n + 1) + 4 * n * a + 4 * n * d)
                # g, q and the three tables gathered per slot
                miss = (nbytes - n * d * b - n * a * b - 3 * tabs
                        + e * (d * b + a * b + 12 * heads))
                bms, by = here.bound_ms(nbytes, e * (4.0 * a + 4.0 * heads
                                                     + 4.0 * d), name)
                tk, tv = here.TOL_TRAIN, here.tol_rounded(name, c)
                row = dict(
                    kernel="attention_bwd_cols", graph=label, dtype=name,
                    E=e, ms=here.time_ms(fn),
                    plain_ms=here.time_ms(
                        lambda: fa.attention_bwd_cols_plain(*args), reps=5),
                    bound_ms=bms, bound_by=by,
                    all_miss_ms=miss / here.HBM_BYTES_PER_S * 1e3,
                    dk_max_abs_err=float((dk - w_dk).abs().max()),
                    dxv_max_abs_err=float((dxv - w_dxv).abs().max()),
                    dk_tol_ratio=float(((dk - w_dk).abs() / (
                        tk[0] + tk[1] * w_dk.abs())).max()),
                    dxv_tol_ratio=float(((dxv - w_dxv).abs() / (
                        tv[0] + tv[1] * w_dxv.abs())).max()))
                if plib is not None:   # the parent's kernel, same inputs
                    old = (torch.empty_like(dk), torch.empty_like(dxv))
                    pargs = (cols.ptr.data_ptr(), cols.idx.data_ptr(),
                             q.data_ptr(), c.data_ptr(), x.data_ptr(),
                             kt.data_ptr(), shift.data_ptr(),
                             denom.data_ptr(), rho.data_ptr(),
                             old[0].data_ptr(), old[1].data_ptr(), n, d, a,
                             heads, fa._DTYPES[dt], _build.stream_ptr(x))
                    _build.check(plib.gx_attention_bwd_cols(*pargs),
                                 "parent attention_bwd_cols")
                    deg = (cols.ptr[1:] - cols.ptr[:-1]).long()
                    row.update(
                        parent_ms=here.time_ms(
                            lambda: plib.gx_attention_bwd_cols(*pargs)),
                        parent_dxv=differ(dxv, old[1], deg),
                        parent_dk=differ(dk, old[0], deg),
                        parent_dk_tol_ratio=float(((dk - old[0]).abs() / (
                            tk[0] + tk[1] * old[0].abs())).max()))
                    del old
                emit(**row)
                del shift, denom, rho, dk, dxv, w_dk, w_dxv
            del x, c, p, q, kt
        torch.cuda.empty_cache()
    del hub, par
    torch.cuda.empty_cache()
    # the CSR GRAND-nl train step: its adjoint runs B3 once per NFE
    profiled_train_step(emit, tr, "GRAND-nl train step, CSR",
                        ("bwd_cols_kernel", "bwd_rows_kernel",
                         "fwd_res_kernel", "seg_combine"))


def row_kernels(emit, which: str, parent=None) -> None:
    """The ``fwd_res`` or ``bwd_rows`` measurements of the module's
    docstring (``which``)."""
    import torch

    import chip_smoke as cs
    from graphax_torch import best_config, get_dataset
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import fused_attention as fa

    here = this_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    data = get_dataset("ogbn-arxiv")
    tr = cs.nl_trainer(best_config("ogbn-arxiv", community_window=0,
                                   block="constant", function="transformer"),
                       data)
    plib = parent_library(parent, "fused_attention") if parent else None
    cfg, att, g = tr.cfg, tr.model.block.func.att, tr.data.graph
    heads = cfg.heads
    tr.model.eval()
    with torch.no_grad():
        x_enc = tr.model.encode(tr.data.x, train=False)
    n, d = x_enc.shape
    gen = torch.Generator(device="cuda").manual_seed(12)
    cot = torch.randn(n, d, generator=gen, device="cuda")
    hub, par = here.hub_graph("cuda"), pareto_graph("cuda")
    cases = (("arxiv CSR", g.csr), ("hub CSR", hub.csr),
             ("pareto CSR", par.csr))
    for label, lay in cases:
        emit(graph=label, N=lay.num_rows, E=lay.num_slots,
             rows=here.degree_shares(lay.ptr, (32, 128)))
    tt = here.TOL_TRAIN

    def ratio(got, want, tol):
        return float(((got.float() - want.float()).abs() / (
            tol[0] + tol[1] * want.float().abs())).max())

    for dt in (torch.bfloat16, torch.float32):
        name, b = str(dt)[6:], dt.itemsize
        x = x_enc.to(dt).contiguous()
        c = cot.to(dt).contiguous()
        with torch.no_grad():
            p = fa.prep_inputs(cfg, att, g, x)
            q = p["q"]
            kt = fa.attention_kproj(x, p["wk"], p["bk"])
            a = q.shape[1]
            to = here.tol_rounded(name, x)
            for label, lay in cases:
                e, tabs = lay.num_slots, 4 * n * heads
                idx_bytes = 4 * e + 4 * (n + 1)
                deg = (lay.ptr[1:] - lay.ptr[:-1]).long()
                # x and K gathered once per edge instead of once
                miss = e * (d * b + 4 * a) - n * d * b - 4 * n * a
                res = fa.attention_fwd_res(lay, q, x, kt, heads)
                out, sc, shift, denom = res
                if which == "fwd_res":
                    fn = lambda: fa.attention_fwd_res(  # noqa: E731
                        lay, q, x, kt, heads)
                    plain = lambda: fa.attention_fwd_res_plain(  # noqa
                        lay, q, x, kt, heads)
                    want = plain()
                    nbytes = (2 * n * d * b + n * a * b + 4 * n * a
                              + idx_bytes + 4 * e * heads + 2 * tabs)
                    ops = e * (2.0 * a + 4.0 * heads + 2.0 * d)
                    errs = dict(
                        out_max_abs_err=float(
                            (out.float() - want[0].float()).abs().max()),
                        out_tol_ratio=ratio(out, want[0], to),
                        table_tol_ratio=max(ratio(u, v, tt) for u, v in zip(
                            res[1:], want[1:])),
                        shift_equal=bool(torch.equal(shift, want[2])))
                else:
                    args = (lay, sc, shift, denom, c, x, kt, heads)
                    fn = lambda: fa.attention_bwd_rows(*args)  # noqa: E731
                    plain = lambda: fa.attention_bwd_rows_plain(  # noqa
                        *args)
                    got, want = fn(), plain()
                    nbytes = (4 * e * heads + 2 * tabs + 2 * n * d * b
                              + 4 * n * a + idx_bytes + 4 * n * a + tabs)
                    ops = e * (2.0 * d + 8.0 * heads + 2.0 * a)
                    errs = dict(
                        dq_max_abs_err=float((got[0] - want[0]).abs().max()),
                        dq_tol_ratio=ratio(got[0], want[0], tt),
                        rho_tol_ratio=ratio(got[1], want[1], tt))
                bms, by = here.bound_ms(nbytes, ops, name)
                row = dict(kernel="attention_" + which, graph=label,
                           dtype=name, E=e, ms=here.time_ms(fn),
                           plain_ms=here.time_ms(plain, reps=5),
                           bound_ms=bms, bound_by=by,
                           all_miss_ms=(nbytes + miss)
                           / here.HBM_BYTES_PER_S * 1e3, **errs)
                # the parent's kernels through the C interface of PR 15's
                # bodies, with the scratch and plans this checkout's
                # wrappers give them
                if plib is not None and which == "fwd_res":
                    old = [torch.empty_like(t) for t in res]
                    plan, nlong, nseg = fa._row_plan(lay, fa._BATCH,
                                                     fa.ROW_SPLIT)
                    st = torch.empty(nseg, 2 * heads, device="cuda")
                    part = torch.empty(nseg, d, device="cuda")
                    pargs = (lay.ptr.data_ptr(), lay.idx.data_ptr(),
                             q.data_ptr(), x.data_ptr(), kt.data_ptr(),
                             plan.data_ptr(), st.data_ptr(), part.data_ptr(),
                             old[1].data_ptr(), old[2].data_ptr(),
                             old[3].data_ptr(), old[0].data_ptr(), n, d, a,
                             heads, fa._DTYPES[dt], fa.gather_width(x),
                             fa.score_vec(q, kt, heads, "scaled_dot"),
                             fa.flash_warps(a, heads), fa.ROW_SPLIT, nlong,
                             nseg, _build.stream_ptr(x))
                    _build.check(plib.gx_attention_fwd_res(*pargs),
                                 "parent attention_fwd_res")
                    row.update(parent_ms=here.time_ms(
                        lambda: plib.gx_attention_fwd_res(*pargs)))
                    for k, nm in enumerate(("out", "sc", "shift", "denom")):
                        row["parent_" + nm] = differ(
                            res[k], old[k], deg[lay.seg] if nm == "sc"
                            else deg)
                elif plib is not None:
                    old = (torch.empty_like(got[0]), torch.empty_like(got[1]))
                    plan, nlong, nseg = fa._row_plan(lay, fa._BATCH,
                                                     fa._BATCH)
                    scratch = [torch.empty(nseg, k, device="cuda")
                               for k in (fa._BATCH, heads, a)]
                    pargs = (lay.ptr.data_ptr(), lay.idx.data_ptr(),
                             sc.data_ptr(), shift.data_ptr(),
                             denom.data_ptr(), c.data_ptr(), x.data_ptr(),
                             kt.data_ptr(), plan.data_ptr(),
                             *(t.data_ptr() for t in scratch),
                             old[0].data_ptr(), old[1].data_ptr(), n, d, a,
                             heads, fa._DTYPES[dt],
                             min(fa.gather_width(c), fa.gather_width(x)),
                             fa.batch_warps(heads), nlong, nseg,
                             _build.stream_ptr(x))
                    _build.check(plib.gx_attention_bwd_rows(*pargs),
                                 "parent attention_bwd_rows")
                    row.update(
                        parent_ms=here.time_ms(
                            lambda: plib.gx_attention_bwd_rows(*pargs)),
                        parent_dq=differ(got[0], old[0], deg),
                        parent_rho=differ(got[1], old[1], deg),
                        parent_dq_tol_ratio=ratio(got[0], old[0], tt),
                        parent_rho_tol_ratio=ratio(got[1], old[1], tt))
                    del scratch
                emit(**row)
                del res, out, sc, shift, denom, want
            del x, c, p, q, kt
        torch.cuda.empty_cache()
    del hub, par
    torch.cuda.empty_cache()
    # the CSR GRAND-nl train step: its adjoint runs both kernels once per
    # NFE
    profiled_train_step(emit, tr, "GRAND-nl train step, CSR",
                        ("fwd_res_kernel", "flash_seg", "bwd_rows_kernel",
                         "bwd_rows_seg", "bwd_cols_kernel", "seg_combine"))


def sddmm(emit, parent=None) -> None:
    """The ``sddmm`` measurements of the module's docstring."""
    import inspect

    import torch

    from graphax_torch import Trainer, best_config, get_dataset
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import spmm as spmm_mod

    here = this_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    plib = parent_library(parent, "spmm") if parent else None
    has_out = "out_dtype" in inspect.signature(spmm_mod.sddmm).parameters
    data = get_dataset("ogbn-arxiv")
    trs = {"CSR": Trainer(best_config("ogbn-arxiv", block="attention",
                                      community_window=0), data),
           "windowed": Trainer(best_config("ogbn-arxiv", block="attention"),
                               data)}
    g0, gw = trs["CSR"].data.graph, trs["windowed"].data.graph
    n, d = g0.num_nodes, trs["CSR"].model.state_dim
    hub, hub_t = here.hub_graph("cuda"), here.hub_graph("cuda",
                                                       transpose=True)
    par = pareto_graph("cuda")
    # (label, layout, the length of the values' buffer the Function's
    # backward fills)
    cases = (("arxiv CSR", g0.csr, g0.edge_buffer_size),
             ("windowed residual", gw.windows.residual,
              gw.windows.residual.num_slots),
             ("hub", hub.csr, hub.edge_buffer_size),
             ("hub transposed", hub_t.csr, hub_t.edge_buffer_size),
             ("pareto", par.csr, par.edge_buffer_size))
    for label, lay, _ in cases:
        emit(graph=label, N=lay.num_rows, E=lay.num_slots,
             rows=here.degree_shares(lay.ptr, (32,)))
    gen = torch.Generator(device="cuda").manual_seed(18)
    tol = here.TOL_DOT
    for dt in (torch.bfloat16, torch.float32):
        name, b = str(dt)[6:], dt.itemsize
        g = torch.randn(n, d, generator=gen, device="cuda").to(dt)
        x = torch.randn(n, d, generator=gen, device="cuda").to(dt)
        for label, lay, length in cases:
            e = lay.num_slots
            fn = lambda lay=lay: spmm_mod.sddmm(lay, g, x)  # noqa: E731
            if has_out:
                low = lambda lay=lay, ln=length: spmm_mod.sddmm(  # noqa
                    lay, g, x, dt, ln)
            else:   # the parent Function's zeros, cast and slice copy
                def low(lay=lay, ln=length):
                    out = torch.zeros(ln, dtype=dt, device="cuda")
                    out[:lay.num_slots] = spmm_mod.sddmm(lay, g, x).to(dt)
                    return out
            got = fn()
            want = spmm_mod.sddmm_plain(lay, g, x)
            c = here.compare(got, want, tol)
            nbytes = 2 * n * d * b + 4 * e + 4 * (n + 1) + 4 * e
            bms, by = here.bound_ms(nbytes, 2.0 * e * d, name)
            row = dict(kernel="sddmm", graph=label, dtype=name, E=e, D=d,
                       ms=here.time_ms(fn), values_dtype_ms=here.time_ms(low),
                       plain_ms=here.time_ms(lambda: spmm_mod.sddmm_plain(
                           lay, g, x), reps=5),
                       max_abs_err=c["max_abs_err"], ok=c["ok"],
                       tol_ratio=float(((got - want).abs() / (
                           tol[0] + tol[1] * want.abs())).max()),
                       bound_ms=bms, bound_by=by,
                       all_miss_ms=(nbytes - n * d * b + e * d * b)
                       / here.HBM_BYTES_PER_S * 1e3)
            if label == "arxiv CSR":
                mask = torch.sparse_csr_tensor(
                    lay.ptr.long(), lay.idx.long(),
                    torch.zeros(e, dtype=dt, device="cuda"), size=(n, n))
                row["library"] = "torch.sparse.sampled_addmm"
                try:
                    row["library_ms"] = here.time_ms(
                        lambda: torch.sparse.sampled_addmm(
                            mask, g, x.t(), beta=0.0), reps=10)
                except (RuntimeError, NotImplementedError) as exc:
                    row["library_error"] = str(exc).splitlines()[0][:120]
                del mask
            if plib is not None:
                old = torch.empty(e, device="cuda")
                vec = 2 if d % 2 == 0 and all(
                    t.data_ptr() % (2 * b) == 0 for t in (g, x)) else 1
                pargs = (lay.ptr.data_ptr(), lay.idx.data_ptr(),
                         g.data_ptr(), x.data_ptr(), old.data_ptr(),
                         lay.num_rows, d, spmm_mod._DTYPES[dt], vec,
                         _build.stream_ptr(x))
                _build.check(plib.gx_sddmm_csr(*pargs), "parent sddmm")
                row.update(parent_ms=here.time_ms(
                    lambda: plib.gx_sddmm_csr(*pargs)),
                    parent_max_abs_diff=float((got - old).abs().max()))
                del old
            emit(**row)
            del got, want
        del g, x
        torch.cuda.empty_cache()
    del hub, hub_t, par
    torch.cuda.empty_cache()
    # the attention block's train steps at arxiv widths: sddmm once per
    # adjoint NFE (and win_bwd_dense on the windowed layout), then the same
    # block in f32 on the windowed layout
    kernels = ("sddmm", "spmm_walk", "win_bwd_dense", "win_matmul")
    for label, tr in trs.items():
        timed_steps(emit, tr, f"attention block {label}")
        profiled_train_step(emit, tr, f"attention block {label}", kernels)
    del trs
    torch.cuda.empty_cache()
    tr = Trainer(best_config("ogbn-arxiv", block="attention",
                             dtype="float32"), data)
    timed_steps(emit, tr, "attention block f32 windowed")
    profiled_train_step(emit, tr, "attention block f32 windowed", kernels)


def norm_call(fn, lay, q, kt, gs, scal, bel, e, den, sqp, kvec):
    """``gx_attention_norm`` of a checkout's library by the C signature it
    has: without the positional pair (23 arguments) or with it (25:
    beltrami_exp's ``ov2p``, ``inv2l2p`` after exp_kernel's), without
    reweight, into ``e`` and ``den``."""
    import torch

    from graphax_torch.kernels import _build
    from graphax_torch.kernels import fused_attention as fa

    n, a = q.shape
    heads = scal[1]
    plan, nlong, nseg = fa._row_plan(lay, fa.NORM_CUT, fa.NORM_SEG)
    norm_call.keep = torch.empty((nseg, heads), device=q.device)
    pair = (float(bel.get("ov2p", 1.0)), float(bel.get("inv2l2p", 0.5))) \
        if len(fn.argtypes) == 25 else ()
    return fn(lay.ptr.data_ptr(), lay.idx.data_ptr(), q.data_ptr(),
              kt.data_ptr(), None, gs.data_ptr(), plan.data_ptr(),
              norm_call.keep.data_ptr(), e.data_ptr(), den.data_ptr(), n, a,
              heads, fa.ATT_TYPES[scal[0]], 0, int(sqp), float(scal[2]),
              float(scal[3]), *pair, fa._DTYPES[q.dtype], kvec, nlong, nseg,
              _build.stream_ptr(q))


def norm(emit, parent=None) -> None:
    """The ``norm`` measurements of the module's docstring."""
    import torch

    import chip_smoke as cs
    from graphax_torch import best_config, get_dataset
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import attention3 as a3
    from graphax_torch.kernels import fused_attention as fa
    from graphax_torch.kernels import winatt as wa

    here = this_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    data = get_dataset("ogbn-arxiv")
    base = dict(block="constant", function="transformer")
    tr_a = cs.nl_trainer(best_config("ogbn-arxiv", **base), data)
    tr_b = cs.nl_trainer(best_config("ogbn-arxiv", community_window=0,
                                     attention_norm_idx=1, **base), data)
    plib = parent_library(parent, "fused_attention") if parent else None
    # beltrami_exp in this checkout's norm (an earlier one refuses it)
    has_bel = "ov2p" in inspect.signature(fa.attention_norm).parameters

    def case(label, lay, q, kt, scal, dt, sqp=False, bel=None):
        n, a = q.shape
        e, heads, b = lay.num_slots, scal[1], dt.itemsize
        bel = bel or {}
        gs = fa.attention_gmax(lay, q, kt, None, *scal, **bel)
        args = (lay, q, kt, None, gs, *scal)
        fn = lambda: fa.attention_norm(*args, square_plus=sqp,  # noqa
                                       **bel)
        ev, den = fn()
        w_e, w_den = fa.attention_norm_plain(*args, square_plus=sqp, **bel)
        # q, K, CSR, shift in; e, den out; all-miss: K per slot
        nbytes = (n * a * b + 4 * n * a + 4 * e + 4 * (n + 1) + 4
                  + 4 * e * heads + 4 * n * heads)
        ops = e * (2.0 * a + 2.0 * heads) if not bel else \
            e * (3.0 * a + 8 * heads) + e * 2.0 * heads
        bms, by = here.bound_ms(nbytes, ops, str(dt)[6:])
        tol = here.TOL_TRAIN
        kvec = fa.score_vec(q, kt, heads, scal[0])
        row = dict(kernel="attention_norm", graph=label, dtype=str(dt)[6:],
                   att_type=scal[0], squareplus=sqp, E=e, kvec=kvec,
                   ms=here.time_ms(fn),
                   plain_ms=here.time_ms(lambda: fa.attention_norm_plain(
                       *args, square_plus=sqp, **bel), reps=5),
                   bound_ms=bms, bound_by=by,
                   all_miss_ms=(nbytes - 4 * n * a + 4 * e * a)
                   / here.HBM_BYTES_PER_S * 1e3,
                   e_max_abs_err=float((ev - w_e).abs().max()),
                   den_max_abs_err=float((den - w_den).abs().max()),
                   den_tol_ratio=float(((den - w_den).abs() / (
                       tol[0] + tol[1] * w_den.abs())).max()))
        if bel and kvec:   # the one-value route of the same instance
            one = (torch.empty_like(ev), torch.empty_like(den))
            _build.check(norm_call(
                _build.library("fused_attention").gx_attention_norm, lay, q,
                kt, gs, scal, bel, *one, sqp, 0), "attention_norm")
            row["one_value_equal"] = bool(torch.equal(one[0], ev)
                                          and torch.equal(one[1], den))
        if plib is not None and not bel:   # the parent's kernel
            old = (torch.empty_like(ev), torch.empty_like(den))
            call = lambda: norm_call(  # noqa: E731
                plib.gx_attention_norm, lay, q, kt, gs, scal, {}, *old, sqp,
                kvec)
            _build.check(call(), "parent attention_norm")
            deg = (lay.ptr[1:] - lay.ptr[:-1]).long()
            row.update(parent_ms=here.time_ms(call),
                       parent_e_equal=bool(torch.equal(ev, old[0])),
                       parent_e_max_abs_diff=float((ev - old[0]).abs().max()),
                       parent_den=differ(den, old[1], deg))
        emit(**row)

    hub = here.hub_graph("cuda")
    with torch.no_grad():
        if has_bel:
            # beltrami_exp at path (d)'s shapes: path (b)'s operands (the
            # column route's q and K table, 2 x 32 wide)
            dts = (torch.bfloat16, torch.float32)
            tr, ops = blend_operands(data, dts)
            for dt in dts:
                o = ops[dt]
                for label, lay in (("arxiv CSR", tr.data.graph.csr),
                                   ("hub", hub.csr)):
                    case(label, lay, o["q"], o["kt"], o["scal"], dt,
                         bel=o["bel"])
                case("arxiv CSR", tr.data.graph.csr, o["q"], o["kt"],
                     o["scal"], dt, sqp=True, bel=o["bel"])
            # path (d)'s RHS alone (colnorm_attention_ax_fast)
            cfg_d = tr.cfg.replace(attention_norm_idx=1)
            att = tr.model.block.func.att
            for dt in dts:
                x = ops[dt]["x"]
                fn = lambda: a3.colnorm_attention_ax_fast(  # noqa: E731
                    cfg_d, att, tr.data.graph, x)
                emit(route="colnorm_attention_ax_fast", path="blend d",
                     dtype=str(dt)[6:], ms=here.time_ms(fn),
                     host_ms=host_ms(fn))
            del tr, ops
            torch.cuda.empty_cache()
        for dt in (torch.bfloat16, torch.float32):
            p = path_a_inputs(tr_a, dt)
            res = p["g"].windows.residual
            emit(layout="windowed residual", N=res.num_rows, E=res.num_slots,
                 **here.degree_shares(res.ptr, (16, 32)))
            case("windowed residual", res, p["q_s"], p["kt"], p["scal"], dt)
            del p
            # the CSR model's operands, as chip_smoke takes them
            cfg, att = tr_b.cfg, tr_b.model.block.func.att
            tr_b.model.eval()
            x_enc = tr_b.model.encode(tr_b.data.x, train=False)
            for label, gr in (("arxiv CSR", tr_b.data.graph), ("hub", hub)):
                if dt == torch.bfloat16:
                    emit(layout=label, N=gr.num_nodes, E=gr.num_edges,
                         **here.degree_shares(gr.csr.ptr, (16, 32)))
                x = x_enc.to(dt).contiguous()
                ops = fa.prep_inputs(cfg, att, gr, x)
                kt = fa.attention_kproj(x, ops["wk"], ops["bk"])
                scal = (cfg.attention_type, cfg.heads, ops["ov2"],
                        ops["inv2l2"])
                case(label, gr.csr, ops["q"], kt, scal, dt)
                if label == "arxiv CSR":
                    case(label, gr.csr, ops["q"], kt, scal, dt, sqp=True)
                del x, ops, kt
            torch.cuda.empty_cache()
        # the other score types on the arxiv CSR (bf16, q and K from a
        # seed), beside the parent's kernel
        g = tr_b.data.graph
        n = g.num_nodes
        gen = torch.Generator(device="cuda").manual_seed(23)
        q = (0.3 * torch.randn(n, 32, generator=gen, device="cuda")).to(
            torch.bfloat16)
        kt = 0.3 * torch.randn(n, 32, generator=gen, device="cuda")
        for att_type in ("cosine_sim", "pearson", "exp_kernel"):
            case("arxiv CSR", g.csr, q, kt, (att_type, 2, 1.3, 0.7),
                 torch.bfloat16)
        del q, kt
        # the routes that run the norm once per RHS, alone
        for path, tr, fn in (("A", tr_a, wa.windowed_attention_ax_fast),
                             ("B", tr_b, a3.colnorm_attention_ax_fast)):
            g, cfg, att = tr.data.graph, tr.cfg, tr.model.block.func.att
            tr.model.eval()
            for dt in (torch.bfloat16, torch.float32):
                x = tr.model.encode(tr.data.x, train=False).to(dt)
                x = x.contiguous()
                emit(route=fn.__name__, path=path, dtype=str(dt)[6:],
                     ms=here.time_ms(lambda: fn(cfg, att, g, x)),
                     host_ms=host_ms(lambda: fn(cfg, att, g, x)))
                del x
    for path, tr in (("A", tr_a), ("B", tr_b)):
        evaluations(emit, tr, f"GRAND-nl evaluation, {path}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="measure this checkout in this process")
    ap.add_argument("--parent", default=None,
                    help="a second checkout, measured in turns")
    ap.add_argument("--only", choices=("windowed", "attention", "spmm",
                                       "pin", "kproj", "slab", "winatt",
                                       "gmax", "bwd_cols", "norm", "fwd_res",
                                       "bwd_rows", "sddmm", "ptxas"),
                    default=None, help="one group of measurements")
    ap.add_argument("--against", default=None,
                    help="a parent checkout whose kernels run beside this "
                    "one's on the same inputs (windowed, pin, winatt, gmax, "
                    "bwd_cols, norm, fwd_res, bwd_rows, sddmm)")
    args = ap.parse_args()
    if args.root is not None:
        measure(os.path.abspath(args.root), args.only,
                None if args.against is None
                else os.path.abspath(args.against))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    order = [HERE] if args.parent is None else [
        os.path.abspath(args.parent), HERE, HERE,
        os.path.abspath(args.parent)]
    if args.only == "ptxas":   # compiler output: once per checkout
        order = order[:2]
    only = [] if args.only is None else ["--only", args.only]
    for root in order:
        against = [] if args.parent is None or root != HERE else [
            "--against", os.path.abspath(args.parent)]
        rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                              "--root", root] + only + against, cwd=root)
        if rc != 0:
            return rc
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
