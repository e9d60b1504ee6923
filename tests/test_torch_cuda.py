"""The CUDA kernels against their plain PyTorch versions, on the card.

This file imports torch and graphax_torch only (no JAX), so it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Here, without a card, every case skips (the kernels have no CPU mode).
Tolerances: f32 outputs 1e-5 (sums in another order); bf16 outputs one bf16
ulp (2^-7 relative); the pin's f32 scores 2e-4 relative / 2e-5 absolute;
the SDDMM's f32 dot products of D terms 1e-4 absolute; the windowed
products' f32 outputs of up to W (or tile) terms 1e-5 relative / 1e-4
absolute, and the densified blocks exactly; the flash kernel's f32 output
2e-4 relative / 2e-5 absolute (graphax's own attention tolerance: f32 sums
and exp in another order), its bf16 products one bf16 ulp apart at the
margin (the rounded weight can land either side: 2e-2 / 2e-3). The
training kernels: their f32 tables and gradients at graphax's attention
tolerance; their sums of products rounded to bf16 2e-2 relative plus two
bf16 ulps of the largest factor (stated at `_check_train_kernels`). The
three-kernel form (attention_norm, attention_attspmm) and the windowed
attention kernel (winatt): f32 tables at graphax's attention tolerance,
sums of rounded products as the training kernels' (stated at
`_check_norm_attspmm` and `_check_winatt`); the routes' autograd Functions
against autograd through their plain twins at the training route's
tolerance."""

import os

import numpy as np
import pytest
import torch

from graphax_torch.kernels import attention_pin as pin_mod
from graphax_torch.kernels import fused_attention as fa
from graphax_torch.kernels import spmm as spmm_mod
from graphax_torch.kernels import windowed_spmm as ws
from graphax_torch.kernels.dispatch import attach_windows
from graphax_torch.sparse.graph import Graph

pytestmark = pytest.mark.cuda

BF16_RTOL = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# ----------------------------------------------------------------------

def _cuda_graph(device, n=300, e=2500, seed=0):
    rng = np.random.RandomState(seed)
    row = rng.randint(0, n - 7, e)
    col = rng.randint(0, n - 7, e)
    order = np.lexsort((col, row))
    w = rng.rand(e).astype(np.float32) + 0.1
    return Graph.from_edges(row[order], col[order], n, edge_weight=w[order],
                            edge_buffer_size=e + 13, device=device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [162, 7, 300])
def test_cuda_spmm_and_sddmm_match_plain(cuda, dtype, d):
    g = _cuda_graph(cuda)
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(g.num_nodes, d, generator=gen, device=cuda).to(tdt)
    w = g.edge_weight.to(tdt)
    wt = spmm_mod.transpose_values(g, w)
    rtol = 1e-5 if dtype == "float32" else BF16_RTOL
    for lay, vals in ((g.csr, w), (g.csc, wt)):
        got = spmm_mod.spmm_csr(lay, vals, x, g.num_nodes)
        want = spmm_mod.spmm_csr_plain(lay, vals, x, g.num_nodes)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=1e-5)
    got = spmm_mod.sddmm(g.csr, x, x)
    want = spmm_mod.sddmm_plain(g.csr, x, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("att_type", ["scaled_dot", "cosine_sim", "pearson",
                                      "exp_kernel"])
def test_cuda_pin_matches_plain(cuda, dtype, att_type):
    g = _cuda_graph(cuda)
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(1)
    n, d, a = g.num_nodes, 162, 32
    q = (0.3 * torch.randn(n, a, generator=gen, device=cuda)).to(tdt)
    x = torch.randn(n, d, generator=gen, device=cuda).to(tdt)
    wk = (0.1 * torch.randn(d, a, generator=gen, device=cuda)).to(tdt)
    bk = 0.1 * torch.randn(a, generator=gen, device=cuda)
    for ew in (None, g.edge_weight):
        args = (g.csr, q, x, wk, bk, ew, att_type, 2, 1.3, 0.7)
        torch.testing.assert_close(pin_mod.attention_pin(*args),
                                   pin_mod.attention_pin_plain(*args),
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_spmm_autograd_matches_plain(cuda, dtype):
    """The autograd Function's forward, its dx (A^T g on the CSC layout) and
    its dw (the SDDMM) against the plain versions of the same products on
    the same inputs: each product rounded to the state dtype, f32 sums, one
    rounding of the result (one bf16 ulp apart at most)."""
    g = _cuda_graph(cuda, seed=2)
    n, tdt = g.num_nodes, getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(n, 162, generator=gen, device=cuda).to(tdt)
    probe = torch.randn(n, 162, generator=gen, device=cuda).to(tdt)
    w = g.edge_weight.to(tdt)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = spmm_mod.spmm(g, wr, spmm_mod.transpose_values(g, wr), xr)
    y.backward(probe)
    rtol = 1e-5 if dtype == "float32" else BF16_RTOL
    want_y = spmm_mod.spmm_csr_plain(g.csr, w, x, n)
    want_dx = spmm_mod.spmm_csr_plain(g.csc, spmm_mod.transpose_values(g, w),
                                      probe, n)
    want_dw = spmm_mod.sddmm_plain(g.csr, probe, x).to(tdt)
    torch.testing.assert_close(y.detach().float(), want_y.float(), rtol=rtol,
                               atol=1e-5)
    torch.testing.assert_close(xr.grad.float(), want_dx.float(), rtol=rtol,
                               atol=1e-5)
    e = g.num_edges
    torch.testing.assert_close(wr.grad[:e].float(), want_dw.float(),
                               rtol=rtol, atol=1e-4)
    assert torch.all(wr.grad[e:] == 0)


def test_cuda_wrappers_reject_bad_operands(cuda):
    g = _cuda_graph(cuda)
    x = torch.randn(g.num_nodes, 8, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        spmm_mod.spmm_csr(g.csr, g.edge_weight.double(), x, g.num_nodes)
    with pytest.raises(ValueError, match="contiguous"):
        spmm_mod.spmm_csr(g.csr, g.edge_weight, x.t(), g.num_nodes)
    with pytest.raises(TypeError):
        spmm_mod.spmm_csr(g.csr, g.edge_weight.half(), x.half(), g.num_nodes)


# ----------------------------------------------------------------------
# the windowed layout's kernels

def _windowed_graph(device, n, tile, window, seed=3):
    """Communities of one window each, ids in order, plus random edges; a
    few windows at the end get no tile (n is not a multiple of window)."""
    rng = np.random.RandomState(seed)
    e = 12 * n
    row = rng.randint(0, n, e)
    col = np.clip(row // window * window + rng.randint(0, window, e), 0, n - 1)
    far = rng.rand(e) < 0.3
    col[far] = rng.randint(0, n, far.sum())
    key = np.unique(row * n + col)
    row, col = key // n, key % n
    w = rng.rand(len(row)).astype(np.float32) + 0.1
    g = Graph.from_edges(row, col, n, edge_weight=w,
                         edge_buffer_size=len(row) + 7, device=device)
    return attach_windows(g, window=window, tile=tile)


# (N, tile, W, D): the slice's tile, W and D; a small odd shape; one
# whose W and D take the kernels' one-value runs (W not a multiple of 16
# bytes, D odd); a wide one, D = 300 (two column chunks of the forward)
# with N off the tile; and a deep one, D = 461 (the bf16 win_bwd_dense's
# K chunks)
SHAPES = {"small_odd": (301, 8, 16, 5), "slice": (3000, 128, 512, 162),
          "unaligned": (203, 6, 18, 7), "wide": (1001, 128, 256, 300),
          "deep": (301, 8, 16, 461)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cuda_windowed_kernels_match_plain(cuda, dtype, shape):
    n, tile, window, d = SHAPES[shape]
    g = _windowed_graph(cuda, n, tile, window)
    wl, tdt = g.windows, getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(n, d, generator=gen, device=cuda).to(tdt)
    gr = torch.randn(n, d, generator=gen, device=cuda).to(tdt)
    dense = ws.densify(wl, g.edge_weight, tdt)
    assert torch.equal(dense, ws.densify_plain(wl, g.edge_weight, tdt))
    tol = dict(rtol=1e-5, atol=1e-4)
    # the f32 product plus the addend (the residual on the main path),
    # rounded once to the state dtype
    got = ws.win_matmul(wl, dense, x, gr)
    assert got.dtype == tdt
    torch.testing.assert_close(
        got.float(), ws.win_matmul_plain(wl, dense, x, gr).float(),
        **(tol if dtype == "float32" else dict(rtol=BF16_RTOL, atol=1e-2)))
    torch.testing.assert_close(ws.win_bwd_dense(wl, gr, x),
                               ws.win_bwd_dense_plain(wl, gr, x), **tol)
    torch.testing.assert_close(ws.win_bwd_slab(wl, dense, gr),
                               ws.win_bwd_slab_plain(wl, dense, gr), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_windowed_autograd_matches_plain(cuda, dtype):
    """The win_matmul Function's dx and d_dense against the plain versions
    of the same products (cotangent cast to the state dtype, results cast
    to the blocks' and x's dtype: one bf16 ulp apart at most)."""
    n, tile, window, d = SHAPES["slice"]
    g = _windowed_graph(cuda, n, tile, window, seed=5)
    wl, tdt = g.windows, getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(n, d, generator=gen, device=cuda).to(tdt)
    probe = torch.randn(n, d, generator=gen, device=cuda)
    dense = ws.densify(wl, g.edge_weight, tdt)
    add = torch.randn(n, d, generator=gen, device=cuda).to(tdt)
    dr, xr = dense.clone().requires_grad_(True), x.clone().requires_grad_(True)
    ar = add.clone().requires_grad_(True)
    out = ws._WinMatmul.apply(dr, xr, wl, ar)
    assert out.dtype == tdt
    pc = probe.to(tdt)
    out.backward(pc)
    want_dx = ws.win_bwd_slab_plain(wl, dense, pc)[:n].to(tdt)
    want_dd = ws.win_bwd_dense_plain(wl, pc, x).to(tdt)
    rtol = 1e-5 if dtype == "float32" else BF16_RTOL
    torch.testing.assert_close(xr.grad.float(), want_dx.float(), rtol=rtol,
                               atol=1e-4)
    torch.testing.assert_close(dr.grad.float(), want_dd.float(), rtol=rtol,
                               atol=1e-4)
    # the addend's gradient is the cotangent itself
    torch.testing.assert_close(ar.grad, pc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cuda_win_bwd_dense_output_dtypes(cuda, dtype, shape):
    """win_bwd_dense with each output dtype: the f32 output against the
    plain version (sums in another order: the windowed products'
    tolerance); the bf16 output the f32 output's bits cast, exactly (one
    rounding, to nearest even, of the same f32 sums); a misaligned view
    (``x[1:]``, ``g[1:]``: element staging) the same bits as the aligned
    call."""
    n, tile, window, d = SHAPES[shape]
    g = _windowed_graph(cuda, n, tile, window, seed=9)
    wl, tdt = g.windows, getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(9)
    xb = torch.randn(n + 1, d, generator=gen, device=cuda).to(tdt)
    gb = torch.randn(n + 1, d, generator=gen, device=cuda).to(tdt)
    x, gr = xb[:n].clone(), gb[:n].clone()
    f32 = ws.win_bwd_dense(wl, gr, x)
    assert f32.dtype == torch.float32
    torch.testing.assert_close(f32, ws.win_bwd_dense_plain(wl, gr, x),
                               rtol=1e-5, atol=1e-4)
    b16 = ws.win_bwd_dense(wl, gr, x, torch.bfloat16)
    assert b16.dtype == torch.bfloat16
    assert torch.equal(b16, f32.to(torch.bfloat16))
    xm, gm = xb[1:], gb[1:]
    assert xm.is_contiguous() and xm.shape == x.shape
    for od in (torch.float32, torch.bfloat16):
        want = ws.win_bwd_dense(wl, gm.clone(), xm.clone(), od)
        assert torch.equal(ws.win_bwd_dense(wl, gm, xm, od), want)


# ----------------------------------------------------------------------
# the f32 bodies on their FMA core: exact sums, copy widths, views

@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cuda_f32_bodies_exact_on_small_integers(cuda, shape):
    """Small integers, so that every product and every f32 sum is exact
    in any order: each f32 body gives the plain version's bits, which are
    those of the f32 core's walk (modelled in plain PyTorch by
    tests/test_torch_redesign17.py): win_matmul with its addend,
    win_bwd_dense and win_bwd_slab with f32 and bf16 outputs (one
    rounding of the exact sum)."""
    n, tile, window, d = SHAPES[shape]
    g = _windowed_graph(cuda, n, tile, window, seed=21)
    wl = g.windows
    gen = torch.Generator(device=cuda).manual_seed(22)

    def ints(bound, *size):
        return torch.randint(-bound, bound + 1, size, generator=gen,
                             device=cuda).float()

    dense = ws.densify(wl, ints(4, g.edge_buffer_size), torch.float32)
    x, gr, add = ints(8, n, d), ints(8, n, d), ints(64, n, d)
    assert torch.equal(ws.win_matmul(wl, dense, x, add),
                       ws.win_matmul_plain(wl, dense, x, add))
    for od in (torch.float32, torch.bfloat16):
        got = ws.win_bwd_dense(wl, gr, x, od)
        assert got.dtype == od
        assert torch.equal(got, ws.win_bwd_dense_plain(wl, gr, x, od))
        got = ws.win_bwd_slab(wl, dense, gr, od)
        assert got.dtype == od
        assert torch.equal(got, ws.win_bwd_slab_plain(wl, dense, gr, od))


@pytest.mark.parametrize("d", [160, 162, 7])
def test_cuda_f32_bodies_copy_widths_and_views(cuda, d):
    """The f32 bodies' copy widths (16 bytes of x's and g's rows at D 160,
    8 at 162, 4 at odd D) and views whose rows start one value past their
    storage (4-byte copies; for the blocks of win_bwd_slab too) give the
    same bits, on random values, and agree with the plain versions within
    the windowed products' tolerance."""
    n, tile, window = 1001, 128, 256
    g = _windowed_graph(cuda, n, tile, window, seed=23)
    wl = g.windows
    gen = torch.Generator(device=cuda).manual_seed(24)
    dense = ws.densify(wl, g.edge_weight, torch.float32)
    x, gr, add = (torch.randn(n, d, generator=gen, device=cuda)
                  for _ in range(3))
    v = 4 if d % 4 == 0 else 2 if d % 2 == 0 else 1
    assert ws.matmul_staging(dense, x, add) == f"fma cp.async 4/{4 * v}"
    assert ws.slab_staging(dense, gr) == f"fma cp.async 16/{4 * v}"
    assert ws.bwd_dense_staging(gr, x) == "fma cp.async 4/4"
    tol = dict(rtol=1e-5, atol=1e-4)
    out = ws.win_matmul(wl, dense, x, add)
    torch.testing.assert_close(out, ws.win_matmul_plain(wl, dense, x, add),
                               **tol)
    slab = ws.win_bwd_slab(wl, dense, gr)
    torch.testing.assert_close(slab, ws.win_bwd_slab_plain(wl, dense, gr),
                               **tol)
    bd = ws.win_bwd_dense(wl, gr, x)
    xm, gm, am, dm = (_off_word(t) for t in (x, gr, add, dense))
    assert ws.matmul_staging(dense, xm, add) == "fma cp.async 4/4"
    assert ws.matmul_staging(dense, x, am) == "fma cp.async 4/4"
    assert ws.slab_staging(dm, gm) == "fma cp.async 4/4"
    assert torch.equal(ws.win_matmul(wl, dense, xm, add), out)
    assert torch.equal(ws.win_matmul(wl, dense, x, am), out)
    assert torch.equal(ws.win_bwd_slab(wl, dm, gr), slab)
    assert torch.equal(ws.win_bwd_slab(wl, dense, gm), slab)
    assert torch.equal(ws.win_bwd_dense(wl, gm, xm), bd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,a", [(7, 12), (128, 64), (162, 32), (300, 12),
                                 (80, 128)])
def test_cuda_kproj_shapes_and_views(cuda, dtype, d, a):
    """attention_kproj at the widths of its paths and at odd ones (odd D,
    A not a multiple of 8, A over one 64-column chunk), N = 1,037 (the last
    64-row tile ragged): f32 sums of exact products in another order,
    1e-5 relative / 1e-4 absolute; a misaligned view (``x[1:]``) the same
    bits as the aligned call."""
    tdt = getattr(torch, dtype)
    n = 1037
    gen = torch.Generator(device=cuda).manual_seed(d * 1000 + a)
    xb = torch.randn(n + 1, d, generator=gen, device=cuda).to(tdt)
    wk = (0.3 * torch.randn(d, a, generator=gen, device=cuda)).to(tdt)
    bk = 0.1 * torch.randn(a, generator=gen, device=cuda)
    x = xb[:n].clone()
    kt = fa.attention_kproj(x, wk, bk)
    torch.testing.assert_close(kt, fa.attention_kproj_plain(x, wk, bk),
                               rtol=1e-5, atol=1e-4)
    xm = xb[1:]
    assert torch.equal(fa.attention_kproj(xm, wk, bk),
                       fa.attention_kproj(xm.clone(), wk, bk))


# ----------------------------------------------------------------------
# graph flash attention

def _flash_inputs(g, dtype, d, a, seed):
    gen = torch.Generator(device=g.device).manual_seed(seed)
    n, tdt = g.num_nodes, getattr(torch, dtype)
    q = (0.3 * torch.randn(n, a, generator=gen, device=g.device)).to(tdt)
    x = torch.randn(n, d, generator=gen, device=g.device).to(tdt)
    wk = (0.3 * torch.randn(d, a, generator=gen, device=g.device)).to(tdt)
    bk = 0.1 * torch.randn(a, generator=gen, device=g.device)
    return q, x, wk, bk


def _one_edge_graph(device):
    return Graph.from_edges(np.array([2]), np.array([4]), 6,
                            edge_weight=np.array([0.7], np.float32),
                            edge_buffer_size=3, device=device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("att_type", ["scaled_dot", "cosine_sim", "pearson",
                                      "exp_kernel"])
@pytest.mark.parametrize("square_plus", [False, True])
def test_cuda_flash_and_gmax_match_plain(cuda, dtype, att_type, square_plus):
    """Random graph (duplicate edges, the last 7 rows empty, padding) at
    D = 162, A = 32, H = 2 and at an odd D = 300 > 256 (two column chunks),
    A = 12, H = 3; reweight on and off."""
    rows = [(_cuda_graph(cuda), 162, 32, 2), (_cuda_graph(cuda, seed=7), 300,
                                              12, 3)]
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-3)
    for i, (g, d, a, heads) in enumerate(rows):
        q, x, wk, bk = _flash_inputs(g, dtype, d, a, seed=i)
        kt = fa.attention_kproj(x, wk, bk)
        torch.testing.assert_close(kt, fa.attention_kproj_plain(x, wk, bk),
                                   rtol=1e-5, atol=1e-4)
        for ew in (None, g.edge_weight):
            scal = (att_type, heads, 1.3, 0.7)
            gshift = None
            if square_plus:
                gshift = fa.attention_gmax(g.csr, q, kt, ew, *scal)
                torch.testing.assert_close(
                    gshift, fa.attention_gmax_plain(g.csr, q, kt, ew, *scal),
                    rtol=1e-6, atol=1e-6)
            got = fa.flash_attention(g.csr, q, x, kt, ew, gshift, *scal)
            want = fa.flash_attention_plain(g.csr, q, x, kt, ew, gshift,
                                            *scal)
            torch.testing.assert_close(got, want, **tol)
            assert torch.all(got[-7:] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_one_edge_and_empty_graph(cuda, dtype):
    g = _one_edge_graph(cuda)
    q, x, wk, bk = _flash_inputs(g, dtype, 5, 4, seed=3)
    kt = fa.attention_kproj(x, wk, bk)
    for gs in (None, fa.attention_gmax(g.csr, q, kt, g.edge_weight,
                                       "scaled_dot", 2)):
        got = fa.flash_attention(g.csr, q, x, kt, g.edge_weight, gs,
                                 "scaled_dot", 2)
        want = fa.flash_attention_plain(g.csr, q, x, kt, g.edge_weight, gs,
                                        "scaled_dot", 2)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
        assert torch.count_nonzero(got.abs().sum(1)) == 1
    empty = Graph.from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64), 6,
                             edge_buffer_size=2, device=cuda)
    assert float(fa.attention_gmax(empty.csr, q, kt, None, "pearson", 2)) \
        == 0.0
    assert torch.equal(fa.flash_attention(empty.csr, q, x, kt, None, None,
                                          "pearson", 2),
                       torch.zeros(6, 5, device=cuda))


def test_cuda_flash_counts_launches_and_refuses_gradients(cuda):
    from graphax_torch.kernels import LAUNCHES

    g = _cuda_graph(cuda)
    q, x, wk, bk = _flash_inputs(g, "float32", 16, 8, seed=4)
    LAUNCHES.clear()
    kt = fa.attention_kproj(x, wk, bk)
    gs = fa.attention_gmax(g.csr, q, kt, None, "scaled_dot", 2)
    fa.flash_attention(g.csr, q, x, kt, None, gs, "scaled_dot", 2)
    assert dict(LAUNCHES) == {"attention_kproj": 1, "attention_gmax": 1,
                              "flash_attention": 1}
    with pytest.raises(RuntimeError, match="not differentiable"):
        fa.flash_attention(g.csr, q, x.requires_grad_(True), kt, None, None,
                           "scaled_dot", 2)


# ----------------------------------------------------------------------
# GRAND-nl training: the forward with residuals and the two backward kernels

def _train_case(g, dtype, d, a, heads, seed):
    gen = torch.Generator(device=g.device).manual_seed(seed)
    n, tdt = g.num_nodes, getattr(torch, dtype)
    q = (0.3 * torch.randn(n, a, generator=gen, device=g.device)).to(tdt)
    x = torch.randn(n, d, generator=gen, device=g.device).to(tdt)
    kt = 0.3 * torch.randn(n, a, generator=gen, device=g.device)
    cot = torch.randn(n, d, generator=gen, device=g.device).to(tdt)
    return q, x, kt, cot


def _rounded(dtype, factor):
    """f32: graphax's attention tolerance. bf16 sums of rounded products:
    2e-2 relative plus two bf16 ulps (2^-6) of the largest factor (a
    weight rounded at the margin moves one term by one ulp)."""
    return dict(rtol=2e-4, atol=2e-5) if dtype == "float32" else dict(
        rtol=2e-2, atol=2.0 ** -6 * float(factor.float().abs().max()))


def _check_train_kernels(g, dtype, d, a, heads, seed):
    """Each training kernel against its plain version on the same inputs
    (the backward kernels on the kernel forward's residuals). f32 tables
    and gradients: graphax's attention tolerance (f32 sums and exp in
    another order), in either dtype since bf16 values are exact in f32.
    Sums of products rounded to bf16 (the forward's output, dxv): a rounded
    weight at the margin moves one term by one bf16 ulp of that term,
    whatever the sum: 2e-2 relative plus two ulps (2^-6) of the largest
    factor (x, or the cotangent)."""
    q, x, kt, cot = _train_case(g, dtype, d, a, heads, seed)
    f32 = dict(rtol=2e-4, atol=2e-5)
    rounded = lambda factor: _rounded(dtype, factor)
    out, sc, shift, denom = fa.attention_fwd_res(g.csr, q, x, kt, heads)
    w_out, w_sc, w_shift, w_denom = fa.attention_fwd_res_plain(g.csr, q, x,
                                                               kt, heads)
    assert out.dtype == x.dtype
    torch.testing.assert_close(out.float(), w_out.float(), **rounded(x))
    for got, want in ((sc, w_sc), (shift, w_shift), (denom, w_denom)):
        torch.testing.assert_close(got, want, **f32)
    dq, rho = fa.attention_bwd_rows(g.csr, sc, shift, denom, cot, x, kt,
                                    heads)
    w_dq, w_rho = fa.attention_bwd_rows_plain(g.csr, sc, shift, denom, cot,
                                              x, kt, heads)
    torch.testing.assert_close(dq, w_dq, **f32)
    torch.testing.assert_close(rho, w_rho, **f32)
    dk, dxv = fa.attention_bwd_cols(g.csc, q, cot, x, kt, shift, denom, rho,
                                    heads)
    w_dk, w_dxv = fa.attention_bwd_cols_plain(g.csc, q, cot, x, kt, shift,
                                              denom, rho, heads)
    torch.testing.assert_close(dk, w_dk, **f32)
    torch.testing.assert_close(dxv, w_dxv, **rounded(cot))
    return out, dq, dk, dxv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_train_kernels_match_plain(cuda, dtype):
    """Random graph (duplicate edges, the last 7 rows and columns empty,
    padding) at D = 162, A = 32, H = 2 and at an odd D = 300 > 256, A = 12,
    H = 3."""
    for i, (g, d, a, heads) in enumerate(((_cuda_graph(cuda), 162, 32, 2),
                                          (_cuda_graph(cuda, seed=7), 300, 12,
                                           3))):
        out, dq, dk, dxv = _check_train_kernels(g, dtype, d, a, heads, i)
        for t in (out, dq, dk, dxv):
            assert torch.all(t[-7:] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_train_kernels_one_edge_and_empty_graph(cuda, dtype):
    out, dq, dk, dxv = _check_train_kernels(_one_edge_graph(cuda), dtype, 5,
                                            4, 2, 3)
    assert torch.count_nonzero(out.float().abs().sum(1)) == 1
    assert torch.count_nonzero(dxv.abs().sum(1)) == 1
    empty = Graph.from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64), 6,
                             edge_buffer_size=2, device=cuda)
    out, dq, dk, dxv = _check_train_kernels(empty, dtype, 5, 4, 2, 4)
    assert not (out.any() or dq.any() or dk.any() or dxv.any())


def test_cuda_train_function_matches_autograd_through_plain_path(cuda):
    """The autograd route's output and the gradients of x, Q and K against
    torch.autograd through the plain per-edge path (the attention's segment
    softmax and the attention SpMM) in f32; each training kernel launched
    once, flash not at all. Tolerance: f32 sums of up to N terms in another
    order, 2e-4 relative plus 1e-4 of the tensor's largest value (a bias's
    with its weight's: dK's bias is 0 but for rounding, as the softmax does
    not see a shift of a row's every score)."""
    from graphax_torch.functions.transformer import (
        TransformerAttention, multiply_attention, transformer_attention_apply,
    )
    from graphax_torch.kernels import LAUNCHES
    from graphax_torch.train import Config

    g = _cuda_graph(cuda, seed=9)
    cfg = Config(function="transformer", heads=2, attention_dim=32,
                 hidden_dim=162)
    gen = torch.Generator().manual_seed(10)
    att = TransformerAttention(cfg, 162)
    with torch.no_grad():
        for lin in (att.Q, att.K):
            lin.weight.copy_(0.3 * torch.randn(lin.weight.shape,
                                               generator=gen))
            lin.bias.copy_(0.1 * torch.randn(lin.bias.shape, generator=gen))
    att = att.to(cuda)
    x = torch.randn(g.num_nodes, 162, generator=gen).to(cuda)
    probe = torch.randn(g.num_nodes, 162, generator=gen).to(cuda)
    lin = (att.Q.weight, att.Q.bias, att.K.weight, att.K.bias)

    def grads(fn):
        xr = x.clone().requires_grad_(True)
        for t in lin:
            t.grad = None
        out = fn(xr)
        (out * probe).sum().backward()
        return [out.detach(), xr.grad] + [t.grad.clone() for t in lin]

    LAUNCHES.clear()
    got = grads(lambda xr: fa.fused_attention_ax(cfg, att, g, xr))
    assert dict(LAUNCHES) == {"attention_kproj": 1, "attention_fwd_res": 1,
                              "attention_bwd_rows": 1,
                              "attention_bwd_cols": 1}

    def plain(xr):
        alpha, (v, _) = transformer_attention_apply(att, cfg, g, xr)
        return multiply_attention(att, cfg, g, xr, alpha, v)

    want = grads(plain)
    top = [float(t.abs().max()) for t in want]
    scale = top[:2] + [max(top[2:4])] * 2 + [max(top[4:])] * 2
    for name, a_, b_, sc_ in zip(("out", "x", "Qw", "Qb", "Kw", "Kb"), got,
                                 want, scale):
        torch.testing.assert_close(a_, b_, rtol=2e-4, atol=1e-4 * sc_,
                                   msg=name)


# ----------------------------------------------------------------------
# the three-kernel form under one global shift, and the windowed kernel K5

def _check_norm_attspmm(g, dtype, d, a, heads, att_type, ew, sqp, seed):
    """attention_norm (e, row sums) and attention_attspmm in both forms
    against their plain versions; e and the sums f32 at graphax's
    attention tolerance."""
    from graphax_torch.kernels.attention3 import column_denominators

    q, x, kt, _ = _train_case(g, dtype, d, a, heads, seed)
    f32 = dict(rtol=2e-4, atol=2e-5)
    scal = (att_type, heads, 1.3, 0.7)
    gs = fa.attention_gmax(g.csr, q, kt, ew, *scal)
    e, den = fa.attention_norm(g.csr, q, kt, ew, gs, *scal, square_plus=sqp)
    w_e, w_den = fa.attention_norm_plain(g.csr, q, kt, ew, gs, *scal,
                                         square_plus=sqp)
    torch.testing.assert_close(e, w_e, **f32)
    torch.testing.assert_close(den, w_den, **f32)
    col = column_denominators(g.csc, e)
    outs = []
    for table, per_col in ((den, False), (col, True)):
        got = fa.attention_attspmm(g.csr, e, table, x, per_column=per_col)
        want = fa.attention_attspmm_plain(g.csr, e, table, x, per_col)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, **_rounded(dtype, x))
        outs.append(got)
    return outs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("att_type", ["scaled_dot", "cosine_sim", "pearson",
                                      "exp_kernel"])
def test_cuda_norm_and_attspmm_match_plain(cuda, dtype, att_type):
    """Random graph (the last 7 rows and columns empty, padding), softmax
    and squareplus, reweight on and off, D = 162 and an odd D = 300."""
    for i, (g, d, a, heads) in enumerate(((_cuda_graph(cuda), 162, 32, 2),
                                          (_cuda_graph(cuda, seed=7), 300, 12,
                                           3))):
        for ew in (None, g.edge_weight):
            for sqp in (False, True):
                for out in _check_norm_attspmm(g, dtype, d, a, heads,
                                               att_type, ew, sqp, i):
                    assert torch.all(out[-7:] == 0)


def test_cuda_norm_and_attspmm_one_edge_and_empty_graph(cuda):
    outs = _check_norm_attspmm(_one_edge_graph(cuda), "float32", 5, 4, 2,
                               "scaled_dot", None, False, 3)
    assert all(torch.count_nonzero(o.abs().sum(1)) == 1 for o in outs)
    empty = Graph.from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64), 6,
                             edge_buffer_size=2, device=cuda)
    outs = _check_norm_attspmm(empty, "bfloat16", 5, 4, 2, "scaled_dot",
                               None, True, 4)
    assert not any(o.any() for o in outs)


def test_cuda_norm_keeps_subnormal_weights(cuda):
    """attention_norm's e for scores 95 and 100 below the shift: the f32
    subnormals torch gives on the CPU, bit for bit (the column route's
    weights at the far end of its one global shift)."""
    g = Graph.from_edges(np.array([0, 0]), np.array([0, 1]), 2, device=cuda)
    q = torch.tensor([[1.0, 0.0], [0.0, 0.0]], device=cuda)
    kt = torch.tensor([[-95.0, 0.0], [-100.0, 0.0]], device=cuda)
    e, _ = fa.attention_norm(g.csr, q, kt, None,
                             torch.zeros((), device=cuda), "scaled_dot", 1)
    want = torch.exp(torch.tensor([-95.0, -100.0]))
    assert want.min() > 0 and torch.equal(e.flatten().cpu(), want)


def _long_graph(device, n=400, seed=11):
    """Columns 3 and 4 of 32 and 33 slots (B3's cutover: one batch, two
    segments) and column 5 of 300 (ten segments); rows 6 and 7 of NORM_CUT
    and NORM_CUT + 1 slots, row 8 of 500 and row 9 of one slot; the rest
    random; the last 5 nodes without an edge either way; padding."""
    rng = np.random.RandomState(seed)
    free = np.setdiff1d(np.arange(n - 5), np.arange(3, 10))
    row, col = [rng.choice(free, 2000)], [rng.choice(free, 2000)]
    for c, cnt in ((3, 32), (4, 33), (5, 300)):
        row.append(rng.choice(free, cnt))
        col.append(np.full(cnt, c))
    for r, cnt in ((6, fa.NORM_CUT), (7, fa.NORM_CUT + 1), (8, 500), (9, 1)):
        row.append(np.full(cnt, r))
        col.append(rng.choice(free, cnt))
    row, col = np.concatenate(row), np.concatenate(col)
    order = np.lexsort((col, row))
    w = rng.rand(row.size).astype(np.float32) + 0.1
    return Graph.from_edges(row[order], col[order], n, edge_weight=w[order],
                            edge_buffer_size=row.size + 9, device=device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bwd_cols_long_and_empty_columns(cuda, dtype):
    """B3 on columns of 32 slots (one batch), 33 and 300 (segments of 32,
    summed in order) and of none, at D = 162, A = 32, H = 2 and at D = 300,
    A = 12, H = 3, on the kernel forward's residuals and rho: dk at
    graphax's attention tolerance, dxv at the rounded products' (as
    `_check_train_kernels`)."""
    g = _long_graph(cuda)
    deg = (g.csc.ptr[1:] - g.csc.ptr[:-1]).cpu()
    assert deg[3:6].tolist() == [32, 33, 300] and not deg[-5:].any()
    for i, (d, a, heads) in enumerate(((162, 32, 2), (300, 12, 3))):
        q, x, kt, cot = _train_case(g, dtype, d, a, heads, 20 + i)
        _, sc, shift, denom = fa.attention_fwd_res(g.csr, q, x, kt, heads)
        _, rho = fa.attention_bwd_rows(g.csr, sc, shift, denom, cot, x, kt,
                                       heads)
        args = (g.csc, q, cot, x, kt, shift, denom, rho, heads)
        dk, dxv = fa.attention_bwd_cols(*args)
        w_dk, w_dxv = fa.attention_bwd_cols_plain(*args)
        torch.testing.assert_close(dk, w_dk, rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(dxv, w_dxv, **_rounded(dtype, cot))
        assert not (dk[-5:].any() or dxv[-5:].any())
        assert dk[5].abs().sum() > 0 and dxv[5].abs().sum() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_train_row_kernels_long_rows_empty_rows_and_views(cuda, dtype):
    """attention_fwd_res and attention_bwd_rows on rows of 0, 1, 31, 32
    (one batch), 33, 700 and 3,000 edges (segments: ROW_SPLIT edges in the
    forward, 32 in the backward), at D = 162, A = 32, H = 2, at D = 300,
    A = 12, H = 3, at D = 7, A = 4, H = 1, and on x and g views that start
    off their vector size: against the plain versions at
    `_check_train_kernels`' tolerances, the forward's shift exactly the
    row's max of its scores (0 for a row with no edge) however the row is
    walked."""
    from graphax_torch.sparse.ops import segment_max

    g = _walk_graph(cuda)
    deg = (g.csr.ptr[1:] - g.csr.ptr[:-1]).cpu()
    assert deg[:7].tolist() == [0, 1, 31, 32, 33, 700, 3000]
    f32 = dict(rtol=2e-4, atol=2e-5)
    for i, (d, a, heads, view) in enumerate(((162, 32, 2, False),
                                             (300, 12, 3, False),
                                             (7, 4, 1, False),
                                             (162, 32, 2, True))):
        q, x, kt, cot = _train_case(g, dtype, d, a, heads, 30 + i)
        if view:
            x, cot = _off_word(x), _off_word(cot)
        out, sc, shift, denom = fa.attention_fwd_res(g.csr, q, x, kt, heads)
        w_out, w_sc, w_shift, w_denom = fa.attention_fwd_res_plain(
            g.csr, q, x, kt, heads)
        torch.testing.assert_close(out.float(), w_out.float(),
                                   **_rounded(dtype, x))
        torch.testing.assert_close(sc, w_sc, **f32)
        torch.testing.assert_close(denom, w_denom, **f32)
        m = segment_max(sc, g.csr.seg, g.num_nodes)
        assert torch.equal(shift, torch.where(torch.isfinite(m), m,
                                              torch.zeros_like(m)))
        torch.testing.assert_close(shift, w_shift, **f32)
        args = (g.csr, sc, shift, denom, cot, x, kt, heads)
        dq, rho = fa.attention_bwd_rows(*args)
        w_dq, w_rho = fa.attention_bwd_rows_plain(*args)
        torch.testing.assert_close(dq, w_dq, **f32)
        torch.testing.assert_close(rho, w_rho, **f32)
        for t in (out, dq, rho, shift, denom):
            assert not (t[0].any() or t[-3:].any())
        assert dq[6].abs().sum() > 0 and out[6].float().abs().sum() > 0


@pytest.mark.parametrize("att_type", ["scaled_dot", "cosine_sim", "pearson",
                                      "exp_kernel"])
def test_cuda_norm_long_rows_and_a_one_slot_row(cuda, att_type):
    """attention_norm on rows of NORM_CUT slots (walked by their group),
    NORM_CUT + 1 and 500 (segments, summed in order), one slot (den is its
    e) and none, with and without reweight, softmax and squareplus, f32
    and bf16: e and den at graphax's attention tolerance."""
    g = _long_graph(cuda)
    slot9 = int(g.csr.ptr[9])
    for dtype in ("float32", "bfloat16"):
        q, _, kt, _ = _train_case(g, dtype, 8, 32, 2, 30)
        for ew in (None, g.edge_weight):
            for sqp in (False, True):
                scal = (att_type, 2, 1.3, 0.7)
                gs = fa.attention_gmax(g.csr, q, kt, ew, *scal)
                e, den = fa.attention_norm(g.csr, q, kt, ew, gs, *scal,
                                           square_plus=sqp)
                w_e, w_den = fa.attention_norm_plain(g.csr, q, kt, ew, gs,
                                                     *scal, square_plus=sqp)
                torch.testing.assert_close(e, w_e, rtol=2e-4, atol=2e-5)
                torch.testing.assert_close(den, w_den, rtol=2e-4, atol=2e-5)
                assert torch.equal(den[9], e[slot9])
                assert not den[-5:].any()


def test_cuda_column_denominators_keep_subnormal_sums(cuda):
    """The column route's denominators of weights that are all f32
    subnormals: the CPU's sums bit for bit (sums of subnormals are exact),
    where an f32 atomic add on the card would flush them to 0 and K3's
    zero-select would then drop the column's softmax."""
    from graphax_torch.kernels.attention3 import column_denominators

    row = np.array([0, 0, 1, 1, 2])
    col = np.array([0, 1, 0, 1, 0])
    e = torch.exp(-torch.tensor([[95.0, 96.0], [97.0, 98.0], [99.0, 100.0],
                                 [101.0, 102.0], [0.0, 103.0]]))
    g_cpu = Graph.from_edges(row, col, 3)
    g_card = Graph.from_edges(row, col, 3, device=cuda)
    want = column_denominators(g_cpu.csc, e)
    got = column_denominators(g_card.csc, e.to(cuda)).cpu()
    assert (want[1] > 0).all() and (want[1] < torch.finfo().tiny).all()
    assert torch.equal(got, want)


def _community_graph(device, n=200, window=32, tile=8, seed=0):
    """Communities of one window; tile 0 without a residual edge, rows 20
    and 21 without an in-window edge, the last 3 rows without an edge."""
    rng = np.random.RandomState(seed)
    comm = np.arange(n) // window
    same = comm[:, None] == comm[None, :]
    hit = rng.rand(n, n) < np.where(same, 0.3, 0.02)
    hit[:tile] &= same[:tile]
    hit[20:22] &= ~same[20:22]
    hit[20, n - 9] = hit[21, 100] = True
    hit[n - 3:] = False
    row, col = np.nonzero(hit)
    w = (rng.rand(len(row)) + 0.2).astype(np.float32)
    g = Graph.from_edges(row, col, n, edge_weight=w,
                         edge_buffer_size=len(row) + 5, device=device)
    return attach_windows(g, window=window, tile=tile)


def _check_winatt(wl, dtype, d, a, heads, att_type, ew, seed):
    """K5 against its plain version: den (f32) at graphax's attention
    tolerance, the f32 output of rounded weights times x as the training
    kernels' sums."""
    from graphax_torch.kernels import winatt as wa

    n = wl.num_nodes
    gen = torch.Generator(device=wl.tile_win.device).manual_seed(seed)
    dev, tdt = wl.tile_win.device, getattr(torch, dtype)
    q = (0.5 * torch.randn(n, a, generator=gen, device=dev)).to(tdt)
    k = (0.5 * torch.randn(n, a, generator=gen, device=dev)).to(tdt)
    x = torch.randn(n, d, generator=gen, device=dev).to(tdt)
    d_res = torch.rand(n, heads, generator=gen, device=dev)
    d_res[:8] = 0.0
    r0 = torch.tensor(0.7, device=dev)
    scal = (att_type, heads, 1.3, 0.7)
    out, den = wa.winatt(wl.in_window, q, k, x, d_res, r0, ew, *scal)
    w_out, w_den = wa.winatt_plain(wl.in_window, q, k, x, d_res, r0, ew,
                                   *scal)
    torch.testing.assert_close(den, w_den, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(out, w_out, **_rounded(dtype, x))
    return out, den


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("att_type", ["scaled_dot", "cosine_sim", "pearson",
                                      "exp_kernel"])
def test_cuda_winatt_matches_plain(cuda, dtype, att_type):
    """A windowed graph with an empty residual tile and rows without an
    in-window cell, reweight on and off, D = 162 and D = 300, H = 2 and
    3."""
    g = _community_graph(cuda)
    wl = g.windows
    cell_w = g.edge_weight[:wl.in_window.num_slots].contiguous()
    for i, (d, a, heads) in enumerate(((162, 32, 2), (300, 12, 3))):
        for ew in (None, cell_w):
            out, den = _check_winatt(wl, dtype, d, a, heads, att_type, ew, i)
            for r in (20, 21, g.num_nodes - 1):
                assert torch.all(out[r] == 0)


def _grads(fn, x, params, probe):
    xr = x.clone().requires_grad_(True)
    for t in params:
        t.grad = None
    out = fn(xr)
    (out.float() * probe).sum().backward()
    return [out.detach().float(), xr.grad] + [t.grad.clone() for t in params]


@pytest.mark.parametrize("route", ["windowed", "column"])
def test_cuda_replay_functions_match_autograd_through_plain_twins(cuda,
                                                                  route):
    """The windowed route (K5 and the residual kernels forward, the plain
    twin's replay backward through win_matmul's Function) and the column
    route (the three-kernel forward, the per-edge replay) against
    torch.autograd through their plain twins, f32: out and the gradients of
    x, Q and K at the training route's tolerance. Each forward kernel is
    launched once; the windowed replay launches win_matmul, win_bwd_dense
    and win_bwd_slab once each."""
    from graphax_torch.functions.transformer import (
        TransformerAttention, attention_ax, edge_ax_plain,
    )
    from graphax_torch.kernels import LAUNCHES
    from graphax_torch.kernels.windowed_attention import \
        windowed_attention_ax_plain
    from graphax_torch.train import Config

    if route == "windowed":
        g = _community_graph(cuda, seed=3)
        cfg = Config(function="transformer", heads=2, attention_dim=32,
                     hidden_dim=162)
        plain = windowed_attention_ax_plain
        launched = {"attention_kproj": 1, "attention_gmax": 1,
                    "attention_norm": 1, "winatt": 1, "attention_attspmm": 1,
                    "win_matmul": 1, "win_bwd_dense": 1, "win_bwd_slab": 1}
    else:
        g = _cuda_graph(cuda, seed=11)
        cfg = Config(function="transformer", heads=2, attention_dim=32,
                     hidden_dim=162, attention_norm_idx=1)
        plain = edge_ax_plain
        launched = {"attention_kproj": 1, "attention_gmax": 1,
                    "attention_norm": 1, "attention_attspmm": 1}
    gen = torch.Generator().manual_seed(12)
    att = TransformerAttention(cfg, 162)
    with torch.no_grad():
        for lin in (att.Q, att.K):
            lin.weight.copy_(0.3 * torch.randn(lin.weight.shape,
                                               generator=gen))
            lin.bias.copy_(0.1 * torch.randn(lin.bias.shape, generator=gen))
    att = att.to(cuda)
    x = torch.randn(g.num_nodes, 162, generator=gen).to(cuda)
    probe = torch.randn(g.num_nodes, 162, generator=gen).to(cuda)
    params = (att.Q.weight, att.Q.bias, att.K.weight, att.K.bias)
    LAUNCHES.clear()
    got = _grads(lambda xr: attention_ax(cfg, att, g, xr), x, params, probe)
    assert dict(LAUNCHES) == launched, dict(LAUNCHES)
    want = _grads(lambda xr: plain(cfg, att, g, xr), x, params, probe)
    top = [float(t.abs().max()) for t in want]
    scale = top[:2] + [max(top[2:4])] * 2 + [max(top[4:])] * 2
    for name, a_, b_, sc_ in zip(("out", "x", "Qw", "Qb", "Kw", "Kb"), got,
                                 want, scale):
        torch.testing.assert_close(a_, b_, rtol=2e-4, atol=1e-4 * sc_,
                                   msg=name)


# GRAND-nl's training routes outside the hand-written backward: (the
# graph's maker, its strategy, the config's overrides, the route, the
# kernels its forward launches once)
NL_ROUTES = {
    "dense_k6": ("cuda", "dense", {}, "dense", {"flash_dense": 1}),
    "dense_k6_vjp_now": ("cuda", "dense", {}, "dense", {}),
    "csr_squareplus": ("cuda", "sparse", dict(square_plus=True),
                       "flash_replay", {"attention_kproj": 1,
                                        "attention_gmax": 1,
                                        "flash_attention": 1}),
    "csr_cosine_reweight": ("cuda", "sparse",
                            dict(attention_type="cosine_sim",
                                 reweight_attention=True),
                            "flash_replay", {"attention_kproj": 1,
                                             "flash_attention": 1}),
    "windowed_column": ("community", "windowed",
                        dict(attention_norm_idx=1), "column",
                        {"attention_kproj": 1, "attention_gmax": 1,
                         "attention_norm": 1, "attention_attspmm": 1}),
    "dense_past_guard_column": ("cuda", "dense",
                                dict(attention_norm_idx=1, square_plus=True),
                                "column",
                                {"attention_kproj": 1, "attention_gmax": 1,
                                 "attention_norm": 1,
                                 "attention_attspmm": 1}),
    "mix_features": ("cuda", "sparse", dict(mix_features=True), "edge", {}),
}


@pytest.mark.parametrize("name", sorted(NL_ROUTES))
def test_cuda_grand_nl_training_routes_match_cpu(cuda, monkeypatch, name):
    """GRAND-nl's RHS with a gradient on the card against the same route on
    the CPU (the kernels' plain versions), f32, from the same weights: out
    and the gradients of x and every attention tensor at the training
    route's tolerance (2e-4 relative plus 1e-4 of the largest entry of
    its kind), under squareplus plus its cancellation's bound (below).
    The dense route's forward runs K6 (its gate forced at this size) and
    its backward the materialised route's vjp; with ``vjp_now`` (the
    adjoint's backward) only the materialised route runs. Past the dense
    guard (forced) a dense graph takes the column route over its CSR and
    CSC.

    Squareplus's weight (z + sqrt(z^2 + 4)) / 2, z the score less the
    global max, cancels for z << 0 (ROADMAP Queue 3): scores that differ
    in their last bits (sums in another order on each device) move each
    side's rounding of the weight by up to 2u sqrt(z^2 + 4), u = 2^-24,
    and so every output and gradient by up to ``sp`` = max over the edges
    of 2u sqrt(z^2 + 4) / w relative (4.5e-4 here, at z = -61); its
    derivative cancels alike."""
    import dataclasses

    from graphax_torch.functions import transformer as tf
    from graphax_torch.kernels import LAUNCHES
    from graphax_torch.train import Config

    maker, strategy, over, route, launched = NL_ROUTES[name]
    if name.startswith("dense_k6"):
        monkeypatch.setattr(tf, "flash_dense_gate", lambda *a: True)
    if name == "dense_past_guard_column":
        monkeypatch.setattr(tf, "use_dense_attention", lambda *a: False)
    cfg = Config(function="transformer", heads=2, attention_dim=32,
                 hidden_dim=64, **over)
    got, sp = {}, 0.0
    for dev in (cuda, torch.device("cpu")):
        g = _community_graph(dev, seed=3) if maker == "community" \
            else _cuda_graph(dev, seed=11)
        g = dataclasses.replace(g, strategy=strategy)
        assert tf.attention_route(cfg, g, 64) == route
        gen = torch.Generator().manual_seed(12)
        att = tf.TransformerAttention(cfg, 64)
        with torch.no_grad():
            for lin in (att.Q, att.K, att.V, att.Wout):
                lin.weight.copy_(0.3 * torch.randn(lin.weight.shape,
                                                   generator=gen))
                lin.bias.copy_(0.1 * torch.randn(lin.bias.shape,
                                                 generator=gen))
        att = att.to(dev)
        x = torch.randn(g.num_nodes, 64, generator=gen).to(dev)
        probe = torch.randn(g.num_nodes, 64, generator=gen).to(dev)
        params = tf._Att.flatten(cfg, att)
        if cfg.square_plus and dev.type == "cpu":
            with torch.no_grad():
                s_ = tf.edge_attention(att, cfg, g, x)[1][:g.num_edges]
            z = s_ - s_.max()
            root = torch.sqrt(z * z + 4.0)
            sp = float((2.0 ** -23 * root / ((z + root) / 2.0)).max())
        LAUNCHES.clear()
        got[dev.type] = _grads(
            lambda xr: tf.attention_ax(cfg, att, g, xr,
                                       vjp_now=name.endswith("vjp_now")),
            x, params, probe)
        if dev.type == "cuda":
            assert dict(LAUNCHES) == launched, dict(LAUNCHES)
    # a weight and its bias share a scale: a bias the function does not
    # see (K's under row softmax) has a gradient of rounding noise
    top = [float(t.abs().max()) for t in got["cpu"]]
    scale = top[:2] + [max(top[i & ~1], top[i | 1])
                       for i in range(2, len(top))]
    for i, (a_, b_) in enumerate(zip(got["cuda"], got["cpu"])):
        torch.testing.assert_close(a_.cpu(), b_, rtol=2e-4 + sp,
                                   atol=(1e-4 + sp) * scale[i],
                                   msg=f"{name}: tensor {i} (sp {sp})")


# ----------------------------------------------------------------------
# the dense strategy's masked flash attention (K6)

def _dense_flash_inputs(device, n, heads, dk, d, seed):
    """q, k, v and a mask with self-loops, a few random edges per row and
    the last 3 rows empty, from a seeded generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q = 0.5 * torch.randn(n, heads, dk, generator=gen, device=device)
    k = 0.5 * torch.randn(n, heads, dk, generator=gen, device=device)
    v = torch.randn(n, d, generator=gen, device=device)
    mask = torch.rand(n, n, generator=gen, device=device) < 6.0 / n
    mask.fill_diagonal_(True)
    mask[-3:] = False
    return q, k, v, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,heads,dk,d", [(300, 2, 4, 8), (700, 3, 16, 100),
                                          (1000, 4, 16, 128),
                                          (97, 1, 64, 256)])
def test_cuda_flash_dense_matches_plain(cuda, dtype, n, heads, dk, d):
    """The kernel against its plain version (the same 64-key tiles of the
    running max): f32 2e-5 absolute / 2e-4 relative (sums and exp in
    another order); bf16 outputs one bf16 ulp apart at the margin (a p
    rounded to bf16 at the edge of a rounding step moves one term), 2e-3 /
    2e-2. Rows without an edge are exactly 0; N is off the 64-row tile."""
    from graphax_torch.kernels import LAUNCHES
    from graphax_torch.kernels import flash_dense as fd

    q, k, v, mask = _dense_flash_inputs(cuda, n, heads, dk, d, seed=n)
    v = v.to(getattr(torch, dtype))
    LAUNCHES.clear()
    got = fd.flash_attention_multihead(q, k, v, mask)
    assert LAUNCHES["flash_dense"] == 1
    want = fd.flash_attention_multihead_plain(q, k, v, mask)
    assert got.dtype == v.dtype and got.shape == (heads, n, d)
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-3)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.all(got[:, -3:] == 0)
    # int8 mask and bf16 q, k give the same function
    got8 = fd.flash_attention_multihead(q.bfloat16(), k.bfloat16(), v,
                                        mask.to(torch.int8))
    want8 = fd.flash_attention_multihead_plain(q.bfloat16(), k.bfloat16(), v,
                                               mask)
    torch.testing.assert_close(got8.float(), want8.float(), **tol)


def test_cuda_flash_dense_rejects_bad_operands(cuda):
    from graphax_torch.kernels import flash_dense as fd

    q, k, v, mask = _dense_flash_inputs(cuda, 50, 2, 4, 8, seed=1)
    with pytest.raises(ValueError, match="not covered"):
        fd.flash_attention_multihead(q, k, torch.randn(50, 300, device=cuda),
                                     mask)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fd.flash_attention_multihead(q, k, v.half(), mask)
    with pytest.raises(ValueError, match="mask"):
        fd.flash_attention_multihead(q, k, v, mask[:49])
    with pytest.raises(RuntimeError, match="not differentiable"):
        fd.flash_attention_multihead(q.requires_grad_(True), k, v, mask)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_dense_rhs_k6_route_matches_materialised(cuda, dtype):
    """GRAND-nl's dense RHS on the card: the K6 route (one flash_dense
    launch) against the materialised route on the same graph and weights:
    f32 2e-4 / 2e-5 (the K6 route divides the summed products by max(l,
    1e-16), the materialised one each weight by its denominator + 1e-16);
    bf16 2e-2 / 2e-2 (p rounded to bf16 against a running max)."""
    import dataclasses

    from graphax_torch.functions.transformer import (
        TransformerAttention, dense_rhs_ax,
    )
    from graphax_torch.kernels import LAUNCHES
    from graphax_torch.train import Config

    g = dataclasses.replace(_cuda_graph(cuda, seed=11), strategy="dense")
    cfg = Config(function="transformer", heads=4, attention_dim=64,
                 hidden_dim=128)
    gen = torch.Generator().manual_seed(11)
    att = TransformerAttention(cfg, 128)
    with torch.no_grad():
        for lin in (att.Q, att.K):
            lin.weight.copy_(0.3 * torch.randn(lin.weight.shape,
                                               generator=gen))
            lin.bias.copy_(0.1 * torch.randn(lin.bias.shape, generator=gen))
    att = att.to(cuda)
    x = torch.randn(g.num_nodes, 128, generator=gen).to(cuda) \
        .to(getattr(torch, dtype))
    LAUNCHES.clear()
    with torch.no_grad():
        k6 = dense_rhs_ax(att, cfg, g, x, use_flash=True)
        mat = dense_rhs_ax(att, cfg, g, x, use_flash=False)
    assert dict(LAUNCHES) == {"flash_dense": 1}
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(k6.float(), mat.float(), **tol)
    assert torch.all(k6[-7:] == 0)                  # rows without an edge


# ----------------------------------------------------------------------
# flash_dense walks only the mask's live keys: hub rows, rows longer than
# one list buffer (576 keys), empty rows, every width it covers

def _walk_mask(device, n, seed):
    """Self-loops and ~6 random keys a row; row 1 a hub (every key live),
    row 2 every other key, row 3 a run of keys across the first span's end
    (columns 480-600: a 64-key group split between two spans); the last 3
    rows empty where n leaves room."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mask = torch.rand(n, n, generator=gen, device=device) < 6.0 / n
    mask.fill_diagonal_(True)
    if n > 7:
        mask[1] = True
        mask[2, ::2] = True
        mask[3, 480:600] = True
        mask[-3:] = False
    return mask


def _check_flash_dense(q, k, v, mask, route):
    """The kernel (one launch) against its plain version: f32 2e-5 / 2e-4
    (sums and exp in another order), bf16 2e-3 / 2e-2 (a p rounded to
    bf16 at the edge of a rounding step moves one term); rows without a
    live key exactly 0."""
    from graphax_torch.kernels import LAUNCHES
    from graphax_torch.kernels import flash_dense as fd

    assert fd.key_loads(q, k) == route
    LAUNCHES.clear()
    got = fd.flash_attention_multihead(q, k, v, mask)
    assert LAUNCHES["flash_dense"] == 1
    want = fd.flash_attention_multihead_plain(q, k, v, mask)
    assert got.dtype == v.dtype and got.shape == want.shape
    tol = dict(rtol=2e-4, atol=2e-5) if v.dtype == torch.float32 else \
        dict(rtol=2e-2, atol=2e-3)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    empty = ~mask.any(1)
    assert torch.all(got[:, empty] == 0)
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("dk", [1, 16, 64])
@pytest.mark.parametrize("d", [1, 128, 256])
def test_cuda_flash_dense_widths(cuda, dtype, heads, dk, d):
    """Every width the kernel covers, on N = 1001 (off every tile, rows
    off 16 bytes) with a hub row of 1001 live keys (more than one list
    buffer), a row of 501, a run across a span's end and empty rows."""
    gen = torch.Generator(device=cuda).manual_seed(dk * d + heads)
    n = 1001
    q, k = (0.5 * torch.randn(n, heads, dk, generator=gen, device=cuda)
            for _ in range(2))
    v = torch.randn(n, d, generator=gen, device=cuda).to(getattr(torch,
                                                                 dtype))
    mask = _walk_mask(cuda, n, seed=dk + d)
    _check_flash_dense(q, k, v, mask, "float4" if dk % 4 == 0 else "scalar")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 63, 1001, 3001])
def test_cuda_flash_dense_sizes_and_views(cuda, dtype, n):
    """N = 1 (one live key, then none), 63, 1001, 3001 (rows of 1500 and
    3001 live keys, several list buffers each) at Computers' widths; q and
    k as views that start mid-vector read as scalars, with the same bits."""
    from graphax_torch.kernels import flash_dense as fd

    heads, dk, d = 4, 16, 128
    gen = torch.Generator(device=cuda).manual_seed(n)
    qb, kb = (0.5 * torch.randn(n * heads * dk + 1, generator=gen,
                                device=cuda) for _ in range(2))
    q, k = (t[:-1].view(n, heads, dk) for t in (qb, kb))
    v = torch.randn(n, d, generator=gen, device=cuda).to(getattr(torch,
                                                                 dtype))
    mask = _walk_mask(cuda, n, seed=n)
    got = _check_flash_dense(q, k, v, mask, "float4")
    qm, km = (torch.empty(n * heads * dk + 1, device=cuda)[1:]
              .view(n, heads, dk) for _ in range(2))
    qm.copy_(q)
    km.copy_(k)
    with torch.no_grad():
        assert fd.key_loads(qm, km) == "scalar"
        assert torch.equal(fd.flash_attention_multihead(qm, km, v, mask),
                           got)
    if n == 1:
        assert torch.all(_check_flash_dense(
            q, k, v, torch.zeros_like(mask), "float4") == 0)


# ----------------------------------------------------------------------
# win_matmul in bf16 on the tensor cores: its staging routes

# (N, tile, W, D, route): the slice's tile, W and D; D = 8; odd D (the
# element route); D = 256 (two CTAs of 176 columns); tile 64; tile 8 with
# W = 16. Every N is off the tile and the last window runs past N.
MATMUL = {"slice": (3000, 128, 512, 162, "cp.async"),
          "d8": (1001, 128, 256, 8, "cp.async"),
          "odd": (1001, 128, 256, 7, "elements"),
          "d256": (1001, 128, 256, 256, "cp.async"),
          "tile64": (1001, 64, 256, 162, "cp.async"),
          "tile8": (301, 8, 16, 162, "cp.async")}


@pytest.mark.parametrize("shape", sorted(MATMUL))
def test_cuda_win_matmul_bf16_routes(cuda, shape):
    """Small integers (exact in bf16, every product and f32 sum exact): the
    output is the exact sum plus the addend rounded once, the plain
    version's bits. Random values: within one bf16 ulp. A view of x that
    starts mid-pair takes the element route and gives the same bits."""
    n, tile, window, d, route = MATMUL[shape]
    g = _windowed_graph(cuda, n, tile, window, seed=12)
    wl, bf = g.windows, torch.bfloat16
    assert n % tile and wl.num_windows * window > n
    gen = torch.Generator(device=cuda).manual_seed(13)
    vals = torch.randint(-4, 5, (g.edge_buffer_size,), generator=gen,
                         device=cuda).float()
    dense = ws.densify(wl, vals, bf)
    x = torch.randint(-8, 9, (n, d), generator=gen, device=cuda).to(bf)
    add = torch.randint(-64, 65, (n, d), generator=gen, device=cuda).to(bf)
    assert ws.matmul_staging(dense, x, add) == route
    got = ws.win_matmul(wl, dense, x, add)
    assert got.dtype == bf and torch.equal(
        got, ws.win_matmul_plain(wl, dense, x, add))
    xb = torch.empty(n * d + 1, dtype=bf, device=cuda)
    xm = xb[1:].view(n, d)
    xm.copy_(x)
    assert ws.matmul_staging(dense, xm, add) == "elements"
    assert torch.equal(ws.win_matmul(wl, dense, xm, add), got)
    dense = ws.densify(wl, g.edge_weight, bf)
    x = torch.randn(n, d, generator=gen, device=cuda).to(bf)
    add = torch.randn(n, d, generator=gen, device=cuda).to(bf)
    torch.testing.assert_close(
        ws.win_matmul(wl, dense, x, add).float(),
        ws.win_matmul_plain(wl, dense, x, add).float(), rtol=BF16_RTOL,
        atol=1e-2)


# ----------------------------------------------------------------------
# the row walk of flash_attention and attention_attspmm: output dtypes,
# the addend, load widths, long rows

def _walk_graph(device, n=400, seed=11):
    """Rows of 0, 1, 31, 32, 33, 700 and 3,000 edges (the last two walked
    in segments of ROW_SPLIT), the rest 0-8 edges, duplicate edges, the
    last 3 rows empty, padding."""
    rng = np.random.RandomState(seed)
    deg = np.r_[0, 1, 31, 32, 33, 700, 3000, rng.randint(0, 9, n - 10), 0,
                0, 0]
    row = np.repeat(np.arange(n), deg)
    col = rng.randint(0, n - 3, row.size)
    order = np.lexsort((col, row))
    w = (rng.rand(row.size) + 0.1).astype(np.float32)
    return Graph.from_edges(row[order], col[order], n, edge_weight=w,
                            edge_buffer_size=row.size + 9, device=device)


def _off_word(x):
    """A contiguous copy of ``x`` that starts one value past its storage's
    start (off every vector size of the walk's loads)."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [162, 7, 64, 300])
def test_cuda_flash_walk_outputs_widths_and_long_rows(cuda, dtype, d):
    """Flash on a graph with hub rows, softmax and squareplus, reweight:
    within the flash tolerance of the plain version; the output in x's
    dtype bit for bit its own f32 output cast once; an x view off its
    vector size (another load width) bit for bit the aligned result."""
    from graphax_torch.kernels import LAUNCHES

    g = _walk_graph(cuda)
    tdt = getattr(torch, dtype)
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-3)
    q, x, wk, bk = _flash_inputs(g, dtype, d, 32, seed=d)
    kt = fa.attention_kproj(x, wk, bk)
    xo = _off_word(x)
    assert fa.gather_width(xo) == x.element_size()
    assert d % 2 or fa.gather_width(x) > x.element_size()
    for att_type, sqp in (("scaled_dot", False), ("pearson", True),
                          ("exp_kernel", False)):
        scal = (att_type, 2, 1.3, 0.7)
        gs = fa.attention_gmax(g.csr, q, kt, g.edge_weight, *scal) \
            if sqp else None
        LAUNCHES.clear()
        got = fa.flash_attention(g.csr, q, x, kt, g.edge_weight, gs, *scal)
        assert LAUNCHES["flash_attention"] == 1
        want = fa.flash_attention_plain(g.csr, q, x, kt, g.edge_weight, gs,
                                        *scal)
        torch.testing.assert_close(got, want, **tol)
        assert torch.all(got[[0, -3, -2, -1]] == 0)
        low = fa.flash_attention(g.csr, q, x, kt, g.edge_weight, gs, *scal,
                                 out_dtype=tdt)
        assert low.dtype == tdt and torch.equal(low, got.to(tdt))
        assert torch.equal(fa.flash_attention(g.csr, q, xo, kt,
                                              g.edge_weight, gs, *scal), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [162, 7, 300])
def test_cuda_attspmm_walk_addend_outputs_and_long_rows(cuda, dtype, d):
    """attention_attspmm, row and column forms, on a graph with hub rows:
    within its tolerance of the plain version; the output in x's dtype bit
    for bit its f32 output cast once; with an f32 addend bit for bit
    ``(addend + f32 output).to(dtype)`` (an empty row gives the addend),
    with the addend or x off their vector size too."""
    from graphax_torch.kernels.attention3 import column_denominators

    g = _walk_graph(cuda, seed=12)
    tdt = getattr(torch, dtype)
    q, x, kt, _ = _train_case(g, dtype, d, 32, 2, seed=d)
    gs = fa.attention_gmax(g.csr, q, kt, None, "scaled_dot", 2)
    e, den = fa.attention_norm(g.csr, q, kt, None, gs, "scaled_dot", 2)
    add = torch.randn(g.num_nodes, d, device=cuda)
    for table, per_col in ((den, False),
                           (column_denominators(g.csc, e), True)):
        got = fa.attention_attspmm(g.csr, e, table, x, per_col)
        want = fa.attention_attspmm_plain(g.csr, e, table, x, per_col)
        torch.testing.assert_close(got, want, **_rounded(dtype, x))
        low = fa.attention_attspmm(g.csr, e, table, x, per_col,
                                   out_dtype=tdt)
        assert low.dtype == tdt and torch.equal(low, got.to(tdt))
        for xs, adds in ((x, add), (_off_word(x), add), (x, _off_word(add))):
            summed = fa.attention_attspmm(g.csr, e, table, xs, per_col,
                                          addend=adds, out_dtype=tdt)
            assert torch.equal(summed, (add + got).to(tdt))
        assert torch.equal(summed[-3:], add[-3:].to(tdt))


def test_cuda_walk_rejects_bad_outputs(cuda):
    g = _walk_graph(cuda)
    q, x, kt, _ = _train_case(g, "bfloat16", 16, 8, 2, seed=1)
    gs = fa.attention_gmax(g.csr, q, kt, None, "scaled_dot", 2)
    e, den = fa.attention_norm(g.csr, q, kt, None, gs, "scaled_dot", 2)
    with pytest.raises(ValueError, match="out_dtype"):
        fa.flash_attention(g.csr, q, x, kt, None, None, "scaled_dot", 2,
                           out_dtype=torch.float16)
    with pytest.raises(ValueError, match="addend"):
        fa.attention_attspmm(g.csr, e, den, x,
                             addend=torch.zeros(g.num_nodes, 16,
                                                dtype=torch.bfloat16,
                                                device=cuda))


# ----------------------------------------------------------------------
# spmm_csr's row walk and segments, the pin's row walk

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [162, 5, 64, 300])
def test_cuda_spmm_widths_views_and_long_rows(cuda, dtype, d):
    """spmm_csr on a graph with rows and columns over ROW_SPLIT, empty rows
    and duplicate edges, A x and A^T g: within its tolerance of the plain
    version, and bit for bit the same result whatever the load width (a
    view one value in takes single values; each column's f32 sum runs over
    the same edges in the same order). Tolerance: one rounding of the
    output (1e-5 f32, 2^-7 bf16, relative) plus, per entry, two f32 sums of
    deg terms in different orders (the kernel's segments, index_add_'s
    atomics), 2 sqrt(deg) 2^-24 sum|w x| (rows of 700 and 3,000 terms
    with cancellation)."""
    from graphax_torch.kernels import LAUNCHES

    g = _walk_graph(cuda, seed=13)
    n, tdt = g.num_nodes, getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn(n, d, generator=gen, device=cuda).to(tdt)
    w = g.edge_weight.to(tdt)
    rtol = 1e-5 if dtype == "float32" else BF16_RTOL
    xo = _off_word(x)
    assert fa.gather_width(xo) == x.element_size()
    for lay, vals in ((g.csr, w), (g.csc, spmm_mod.transpose_values(g, w))):
        want = spmm_mod.spmm_csr_plain(lay, vals, x, n).float()
        deg = (lay.ptr[1:] - lay.ptr[:-1]).float()[:, None]
        tol = rtol * want.abs() + 2 * deg.sqrt() * 2.0 ** -24 \
            * spmm_mod.spmm_csr_plain(lay, vals.abs(), x.abs(), n).float()
        LAUNCHES.clear()
        got = spmm_mod.spmm_csr(lay, vals, x, n)
        assert LAUNCHES["spmm_csr"] == 1
        assert bool(((got.float() - want).abs() <= tol).all())
        assert torch.all(got[-3:] == 0)
        assert torch.equal(spmm_mod.spmm_csr(lay, vals, xo, n), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("att_type", ["scaled_dot", "cosine_sim", "pearson",
                                      "exp_kernel"])
def test_cuda_pin_long_rows_and_empty_rows(cuda, dtype, att_type):
    """The pin on a graph with rows of 0, 1, 31, 32, 33, 700 and 3,000
    edges (those over 32 in segments), reweight off and on, at Computers'
    widths (D 128, A 64, 4 heads): within the pin's tolerance of the plain
    version; one wrapper call, one K projection."""
    from graphax_torch.kernels import LAUNCHES

    g = _walk_graph(cuda, seed=14)
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(3)
    n, d, a = g.num_nodes, 128, 64
    q = (0.3 * torch.randn(n, a, generator=gen, device=cuda)).to(tdt)
    x = torch.randn(n, d, generator=gen, device=cuda).to(tdt)
    wk = (0.1 * torch.randn(d, a, generator=gen, device=cuda)).to(tdt)
    bk = 0.1 * torch.randn(a, generator=gen, device=cuda)
    for ew in (None, g.edge_weight):
        args = (g.csr, q, x, wk, bk, ew, att_type, 4, 1.3, 0.7)
        LAUNCHES.clear()
        got = pin_mod.attention_pin(*args)
        assert LAUNCHES["attention_pin"] == LAUNCHES["attention_kproj"] == 1
        torch.testing.assert_close(got, pin_mod.attention_pin_plain(*args),
                                   rtol=2e-4, atol=2e-5)


def test_cuda_pin_wide_rows_follow_the_k_projection(cuda):
    """The pin at D 400, A 120, 4 heads, in both dtypes (bf16's K table on
    the tensor cores, f32's on the CUDA-core projection, which streams Wk
    with x along D): within the pin's tolerance of the plain version, one
    wrapper call, one K projection."""
    from graphax_torch.kernels import LAUNCHES

    g = _walk_graph(cuda, seed=15)
    gen = torch.Generator(device=cuda).manual_seed(5)
    n, d, a = g.num_nodes, 400, 120
    for tdt in (torch.bfloat16, torch.float32):
        q = (0.3 * torch.randn(n, a, generator=gen, device=cuda)).to(tdt)
        x = torch.randn(n, d, generator=gen, device=cuda).to(tdt)
        wk = (0.05 * torch.randn(d, a, generator=gen, device=cuda)).to(tdt)
        bk = 0.1 * torch.randn(a, generator=gen, device=cuda)
        args = (g.csr, q, x, wk, bk, g.edge_weight, "scaled_dot", 4)
        LAUNCHES.clear()
        got = pin_mod.attention_pin(*args)
        assert LAUNCHES["attention_pin"] == LAUNCHES["attention_kproj"] == 1
        torch.testing.assert_close(got, pin_mod.attention_pin_plain(*args),
                                   rtol=2e-4, atol=2e-5)


# ----------------------------------------------------------------------
# the SDDMM's work items (rows of at most 32 edges, 32-edge segments of
# the longer ones), load widths and output dtype

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [162, 1, 7, 300])
def test_cuda_sddmm_long_rows_views_and_out_dtype(cuda, dtype, d):
    """sddmm on a graph with rows of 0, 1, 31, 32, 33, 700 and 3,000 edges
    and padding: within TOL_DOT (1e-4 absolute, 1e-5 relative: f32 dot
    products of D terms in another order) of the plain version, one launch
    a call; g and x views one value in (loads of one value) within it too;
    the output in the state dtype with a padded length the f32 result cast
    once, zeros past the slots."""
    from graphax_torch.kernels import LAUNCHES

    gr = _walk_graph(cuda, seed=16)
    lay, e, n = gr.csr, gr.num_edges, gr.num_nodes
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(d)
    g = torch.randn(n, d, generator=gen, device=cuda).to(tdt)
    x = torch.randn(n, d, generator=gen, device=cuda).to(tdt)
    want = spmm_mod.sddmm_plain(lay, g, x)
    LAUNCHES.clear()
    got = spmm_mod.sddmm(lay, g, x)
    assert LAUNCHES["sddmm"] == 1 and got.shape == (e,)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    go, xo = _off_word(g), _off_word(x)
    assert fa.gather_width(xo) == x.element_size()
    torch.testing.assert_close(spmm_mod.sddmm(lay, go, xo), want, rtol=1e-5,
                               atol=1e-4)
    size = gr.edge_buffer_size
    low = spmm_mod.sddmm(lay, g, x, tdt, size)
    assert low.dtype == tdt and low.shape == (size,)
    assert torch.equal(low[:e], got.to(tdt))
    assert torch.equal(low[e:], torch.zeros(size - e, dtype=tdt,
                                            device=cuda))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_sddmm_autograd_dw_in_values_dtype(cuda, dtype):
    """The autograd Function's value gradient on the graph with hub rows:
    in wb's dtype, zero on the edge buffer's padding, the plain SDDMM of
    the same cotangent cast once (one bf16 ulp apart at the margin), one
    SDDMM launch."""
    from graphax_torch.kernels import LAUNCHES

    gr = _walk_graph(cuda, seed=17)
    n, e, tdt = gr.num_nodes, gr.num_edges, getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(n, 162, generator=gen, device=cuda).to(tdt)
    probe = torch.randn(n, 162, generator=gen, device=cuda).to(tdt)
    wr = gr.edge_weight.to(tdt).requires_grad_(True)
    y = spmm_mod.spmm(gr, wr, spmm_mod.transpose_values(gr, wr.detach()), x)
    LAUNCHES.clear()
    y.backward(probe)
    assert LAUNCHES["sddmm"] == 1
    assert wr.grad.dtype == tdt and wr.grad.shape == (gr.edge_buffer_size,)
    assert torch.all(wr.grad[e:] == 0)
    want = spmm_mod.sddmm_plain(gr.csr, probe, x)
    rtol = 1e-5 if dtype == "float32" else BF16_RTOL
    torch.testing.assert_close(wr.grad[:e].float(), want.to(tdt).float(),
                               rtol=rtol, atol=1e-4)


# ----------------------------------------------------------------------
# the CUDA-core K projection (f32, and bf16 where the tensor-core kernel
# does not fit)

def _kproj_cuda_core(x, wk, bk):
    """The CUDA-core kernel whatever the route (the wrapper sends bf16
    there only where the tensor-core kernel does not fit)."""
    from graphax_torch.kernels import _build

    n, d = x.shape
    kt = torch.empty((n, wk.shape[1]), dtype=torch.float32, device=x.device)
    err = _build.library("fused_attention").gx_attention_kproj(
        x.data_ptr(), wk.data_ptr(), bk.data_ptr(), kt.data_ptr(), n, d,
        wk.shape[1], fa._DTYPES[x.dtype], fa.kproj_copy_bytes(x),
        fa.kproj_copy_bytes(wk), _build.stream_ptr(x))
    _build.check(err, "attention_kproj")
    return kt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1, 7, 162, 400, 1000])
@pytest.mark.parametrize("a", [1, 32, 64, 120, 512])
def test_cuda_kproj_cuda_core_widths_sizes_and_views(cuda, dtype, d, a):
    """The CUDA-core K projection at N = 1, 127 (one ragged tile) and 1001
    (several tiles over few CTAs' turns): f32 sums of exact products in
    D's order, within TOL_KPROJ (1e-5 relative, 1e-4 absolute) of the
    plain version; a view of x one value in (8-byte copies in f32, element
    copies in bf16) and a view of Wk one value in give the same bits as
    the aligned call. Through the wrapper where it routes there (every f32
    shape), the same bits as the kernel called directly."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(d * 1000 + a)
    wk = (torch.randn(d, a, generator=gen, device=cuda)
          / d ** 0.5).to(tdt)
    bk = 0.1 * torch.randn(a, generator=gen, device=cuda)
    for n in (1, 127, 1001):
        x = torch.randn(n, d, generator=gen, device=cuda).to(tdt)
        kt = _kproj_cuda_core(x, wk, bk)
        torch.testing.assert_close(kt, fa.attention_kproj_plain(x, wk, bk),
                                   rtol=1e-5, atol=1e-4)
        xm, wm = _off_word(x), _off_word(wk)
        assert torch.equal(_kproj_cuda_core(xm, wm, bk), kt)
        if fa.kproj_route(tdt, d, a) == "cuda_core":
            with torch.no_grad():
                assert torch.equal(fa.attention_kproj(xm, wm, bk), kt)


# ----------------------------------------------------------------------
# win_bwd_slab in bf16 on the tensor cores: output dtypes, routes, empty
# windows

def _slab_graph(device, n, tile, window, seed):
    """Communities of one window each plus random edges, except that the
    rows of window 1 take their columns from window 0, so every tile of
    window 1 maps window 0 and no tile maps window 1; n off the tile."""
    rng = np.random.RandomState(seed)
    e = 10 * n
    row = rng.randint(0, n, e)
    home = np.where(row // window == 1, 0, row // window)
    col = np.clip(home * window + rng.randint(0, window, e), 0, n - 1)
    far = rng.rand(e) < 0.2
    col[far] = rng.randint(0, n, far.sum())
    key = np.unique(row * n + col)
    row, col = key // n, key % n
    w = rng.rand(len(row)).astype(np.float32) + 0.1
    g = Graph.from_edges(row, col, n, edge_weight=w,
                         edge_buffer_size=len(row) + 5, device=device)
    return attach_windows(g, window=window, tile=tile)


# (N, tile, W, D, route): the slice's tile and D over W = 256, D = 8, odd
# D (the element route), D = 256 (two CTAs of 176 columns), tile 64, tile
# 8 with W = 32 (one chunk of 32 rows holds a whole tile); every N off the
# tile
SLAB = {"d162": (1001, 128, 256, 162, "cp.async"),
        "d8": (1001, 128, 256, 8, "cp.async"),
        "odd": (1001, 128, 256, 7, "elements"),
        "d256": (1001, 128, 256, 256, "cp.async"),
        "tile64": (1001, 64, 128, 162, "cp.async"),
        "tile8": (301, 8, 32, 162, "cp.async")}


@pytest.mark.parametrize("shape", sorted(SLAB))
def test_cuda_win_bwd_slab_bf16_outputs_routes_and_empty_windows(cuda,
                                                                 shape):
    """bf16 win_bwd_slab: its f32 output within the windowed products'
    tolerance (1e-5 relative, 1e-4 absolute: f32 sums of up to 4 tiles'
    rows in another order) of the plain version; its bf16 output the f32
    output's bits cast, exactly (one rounding of the same f32 sums), and
    within one bf16 ulp of the plain bf16 output; zeros for the rows of
    the window that no tile maps; a view of g or of the blocks that
    starts mid-pair takes the element route and gives the same bits."""
    n, tile, window, d, route = SLAB[shape]
    g = _slab_graph(cuda, n, tile, window, seed=16)
    wl, bf = g.windows, torch.bfloat16
    assert 1 not in set(wl.tile_win.tolist()) and n % tile
    gen = torch.Generator(device=cuda).manual_seed(17)
    dense = ws.densify(wl, g.edge_weight, bf)
    gr = torch.randn(n, d, generator=gen, device=cuda).to(bf)
    assert ws.slab_staging(dense, gr) == route
    f32 = ws.win_bwd_slab(wl, dense, gr)
    assert f32.dtype == torch.float32 and f32.shape == (n, d)
    torch.testing.assert_close(f32, ws.win_bwd_slab_plain(wl, dense, gr),
                               rtol=1e-5, atol=1e-4)
    b16 = ws.win_bwd_slab(wl, dense, gr, bf)
    assert b16.dtype == bf and torch.equal(b16, f32.to(bf))
    torch.testing.assert_close(
        b16.float(), ws.win_bwd_slab_plain(wl, dense, gr, bf).float(),
        rtol=BF16_RTOL, atol=1e-4)
    assert not f32[window:2 * window].any()
    gm, dm = _off_word(gr), _off_word(dense)
    assert ws.slab_staging(dense, gm) == "elements"
    assert ws.slab_staging(dm, gr) == "elements"
    for od, want in ((torch.float32, f32), (bf, b16)):
        assert torch.equal(ws.win_bwd_slab(wl, dense, gm, od), want)
        assert torch.equal(ws.win_bwd_slab(wl, dm, gr, od), want)


def test_cuda_win_matmul_backward_makes_dx_in_x_dtype(cuda):
    """The win_matmul Function's backward on bf16: dx comes from one
    win_bwd_slab launch in x's dtype, the bits of win_bwd_slab's bf16
    output; no cast kernel of an [N, D] or [Wn W, D] tensor runs."""
    from torch.profiler import ProfilerActivity, profile

    from graphax_torch.kernels import LAUNCHES

    n, tile, window, d, _ = SLAB["d162"]
    g = _slab_graph(cuda, n, tile, window, seed=18)
    wl, bf = g.windows, torch.bfloat16
    gen = torch.Generator(device=cuda).manual_seed(19)
    dense = ws.densify(wl, g.edge_weight, bf)
    x = torch.randn(n, d, generator=gen, device=cuda).to(bf)
    add = torch.randn(n, d, generator=gen, device=cuda).to(bf)
    probe = torch.randn(n, d, generator=gen, device=cuda).to(bf)
    xr = x.clone().requires_grad_(True)
    out = ws._WinMatmul.apply(dense, xr, wl, add)
    LAUNCHES.clear()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        out.backward(probe)
        torch.cuda.synchronize()
    assert LAUNCHES["win_bwd_slab"] == 1
    shapes = ([n, d], [wl.num_windows * window, d])
    assert not [ev for ev in prof.events() if ev.name == "aten::_to_copy"
                and ev.input_shapes and list(ev.input_shapes[0]) in shapes]
    assert xr.grad.dtype == bf
    assert torch.equal(xr.grad, ws.win_bwd_slab(wl, dense, probe, bf))


# ----------------------------------------------------------------------
# K5 (winatt) and attention_gmax as redesigned: K5's row groups and long
# rows, gmax's flat walk over (slot, head) pairs

def _long_row_graph(device, n=1100, window=512, tile=8, seed=20):
    """Communities of one window of 512 (the last one short), tiles of 8:
    in-window rows of 33, 200 and 512 cells (row 7 its whole window), rows
    30 and 31 with out-of-window edges only, the last 5 rows without an
    edge; about 5 cells on the other rows."""
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
    w = (rng.rand(len(row)) + 0.2).astype(np.float32)
    g = Graph.from_edges(row, col, n, edge_weight=w,
                         edge_buffer_size=len(row) + 9, device=device)
    g = attach_windows(g, window=window, tile=tile)
    deg = (g.windows.in_window.ptr[1:] - g.windows.in_window.ptr[:-1]).cpu()
    assert (int(deg[3]), int(deg[600]), int(deg[7])) == (33, 200, window)
    assert int(deg[30]) == int(deg[31]) == 0 and not bool(deg[-5:].any())
    return g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_winatt_long_rows_empty_rows_and_widths(cuda, dtype):
    """K5 against its plain version (den at graphax's attention tolerance,
    out as the training kernels' sums, `_check_winatt`) on in-window rows
    of 33, 200 and 512 cells (past the kernel's 16 lanes a row: its
    segment kernels) and on empty rows, at D = 162 and at odd D = 97 (bf16:
    2-byte loads), A = 32, H = 2 (16-byte score loads) and A = 12, H = 3,
    reweight on and off; one launch a call."""
    from graphax_torch.kernels import LAUNCHES

    g = _long_row_graph(cuda)
    wl = g.windows
    cell_w = (torch.rand(wl.in_window.num_slots, device=cuda,
                         generator=torch.Generator(device=cuda)
                         .manual_seed(21)) + 0.2)
    for i, (d, a, heads) in enumerate(((162, 32, 2), (97, 12, 3))):
        for ew in (None, cell_w):
            LAUNCHES.clear()
            out, _ = _check_winatt(wl, dtype, d, a, heads, "scaled_dot", ew,
                                   30 + i)
            assert LAUNCHES["winatt"] == 1
            for r in (30, 31, g.num_nodes - 1):
                assert torch.all(out[r] == 0)
    out, den = _check_winatt(wl, dtype, 162, 32, 2, "exp_kernel", cell_w, 33)


def _gmax_operands(g, dtype, a, seed, sign=None):
    gen = torch.Generator(device=g.device).manual_seed(seed)
    n, tdt = g.num_nodes, getattr(torch, dtype)
    q = 0.3 * torch.randn(n, a, generator=gen, device=g.device)
    kt = 0.3 * torch.randn(n, a, generator=gen, device=g.device)
    if sign is not None:        # every scaled_dot score below zero
        q, kt = q.abs() + 0.01, -(kt.abs() + 0.01)
    return q.to(tdt), kt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_gmax_max_at_the_last_slot_and_block_and_negative(cuda, dtype):
    """The flat walk against the plain version on N = 301 rows (pairs not a
    multiple of the 256-thread block): the largest score planted at the
    last (slot, head) pair, at the first pair of the last block and at
    pair 0; every score negative (the max is returned, not 0); reweight on
    and off; A = 32, H = 2 (16-byte loads) and A = 12, H = 3. One launch a
    call; a call after a larger max is not held by it (the kernel leaves
    its state as zeros)."""
    from graphax_torch.kernels import LAUNCHES

    g = _cuda_graph(cuda, n=301, e=2499, seed=22)
    lay, e = g.csr, g.csr.num_slots
    for a, heads in ((32, 2), (12, 3)):
        dk, pairs = a // heads, e * heads
        assert pairs % 256
        for p in (pairs - 1, 256 * ((pairs - 1) // 256), 0):
            q, kt = _gmax_operands(g, dtype, a, seed=p)
            slot, hh = p // heads, p % heads
            r, c = int(lay.seg[slot]), int(lay.idx[slot])
            q[r, hh * dk:(hh + 1) * dk] = 2.0
            kt[c, hh * dk:(hh + 1) * dk] = 2.0
            planted = g.edge_weight.clone()
            planted[slot] = 2.0         # above every other weight
            for ew in (None, planted):
                scal = ("scaled_dot", heads)
                s = fa.edge_scores_plain(lay, q, kt, ew, *scal).reshape(-1)
                assert s[p] == s.max()
                LAUNCHES.clear()
                got = fa.attention_gmax(lay, q, kt, ew, *scal)
                assert LAUNCHES["attention_gmax"] == 1
                torch.testing.assert_close(
                    got, fa.attention_gmax_plain(lay, q, kt, ew, *scal),
                    rtol=1e-6, atol=1e-6)
        q, kt = _gmax_operands(g, dtype, a, seed=23, sign=-1)
        got = fa.attention_gmax(lay, q, kt, None, "scaled_dot", heads)
        want = fa.attention_gmax_plain(lay, q, kt, None, "scaled_dot", heads)
        assert float(want) < 0
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_cuda_gmax_every_slot_padded_and_the_state_after_a_call(cuda):
    """A graph whose edge buffer holds padding only (no slot): 0, in either
    dtype and type; and each call's result is its own after calls with
    larger maxima (the reused state is left as zeros)."""
    empty = Graph.from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64),
                             301, edge_buffer_size=7, device=cuda)
    g = _cuda_graph(cuda, seed=24)
    for dtype in ("float32", "bfloat16"):
        q, kt = _gmax_operands(empty, dtype, 32, seed=25)
        for att_type in ("scaled_dot", "exp_kernel"):
            assert float(fa.attention_gmax(empty.csr, q, kt, None, att_type,
                                           2)) == 0.0
        q, kt = _gmax_operands(g, dtype, 32, seed=26)
        seen = []
        for scale in (4.0, 1.0, 0.25, 2.0):
            got = fa.attention_gmax(g.csr, q, kt * scale, None, "scaled_dot",
                                    2)
            want = fa.attention_gmax_plain(g.csr, q, kt * scale, None,
                                           "scaled_dot", 2)
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
            seen.append(float(got))
        assert seen[0] > seen[3] > seen[1] > seen[2] > 0


def test_cuda_gmax_on_two_streams_at_once(cuda):
    """Launches on two streams, each queued behind work that keeps it in
    flight while the other runs: each stream's result is its own (each
    stream has its own state), and calls after them on either stream and
    on the default stream are right (every state left as zeros)."""
    g = _cuda_graph(cuda, seed=27)
    q, kt = _gmax_operands(g, "bfloat16", 32, seed=28)
    scal = ("scaled_dot", 2)
    want = [fa.attention_gmax_plain(g.csr, q, kt * s, None, *scal)
            for s in (4.0, 0.25)]
    ops = [kt * 4.0, kt * 0.25]
    busy = [torch.randn(2048, 2048, device=cuda) / 2048 ** 0.25
            for _ in range(2)]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize()
    for _ in range(3):
        got = []
        for st, k2, b in zip(streams, ops, busy):
            with torch.cuda.stream(st):
                for _ in range(4):
                    b = b @ b
                got.append(fa.attention_gmax(g.csr, q, k2, None, *scal))
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    for st, k2, b in zip(streams + [torch.cuda.current_stream(cuda)],
                         ops + [kt], want + [fa.attention_gmax_plain(
                             g.csr, q, kt, None, *scal)]):
        with torch.cuda.stream(st):
            got = fa.attention_gmax(g.csr, q, k2, None, *scal)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, b, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------
# the label trick's state width: hidden 162 + 40 classes on ogbn-arxiv

LABEL_D = 202
LABEL_KERNELS = ("spmm_csr", "windowed_densify", "win_matmul",
                 "win_bwd_slab", "attention_kproj", "attention_pin")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", LABEL_KERNELS)
def test_cuda_label_width_kernels_match_plain(cuda, dtype, kernel):
    """The arxiv preset's kernels at D = 202 (``use_labels=True``), on a
    windowed layout at the preset's tile and W, against their plain
    versions at the tolerances above: spmm_csr on the residual edges (A x
    and A^T g), the blocks exactly, win_matmul with the residual's sum as
    its addend, win_bwd_slab with its output in the state dtype, the K
    projection on its route at A = 32 and the pin over it, each counted
    once per call."""
    from graphax_torch.kernels import LAUNCHES

    g = _windowed_graph(cuda, 3000, 128, 512)
    wl, n, tdt = g.windows, g.num_nodes, getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(202)
    x = torch.randn(n, LABEL_D, generator=gen, device=cuda).to(tdt)
    gr = torch.randn(n, LABEL_D, generator=gen, device=cuda).to(tdt)
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == "float32" \
        else dict(rtol=BF16_RTOL, atol=1e-2)
    dense = ws.densify_plain(wl, g.edge_weight, tdt)
    addend = spmm_mod.spmm_csr_plain(
        wl.residual, g.edge_weight.to(tdt)[wl.residual.perm].contiguous(),
        x, n)
    LAUNCHES.clear()
    if kernel == "spmm_csr":
        for lay, inp in ((wl.residual, x), (wl.residual_t, gr)):
            vals = g.edge_weight.to(tdt)[lay.perm].contiguous()
            torch.testing.assert_close(
                spmm_mod.spmm_csr(lay, vals, inp, n).float(),
                spmm_mod.spmm_csr_plain(lay, vals, inp, n).float(), **tol)
        want = 2
    elif kernel == "windowed_densify":
        assert torch.equal(ws.densify(wl, g.edge_weight, tdt), dense)
        want = 1
    elif kernel == "win_matmul":
        got = ws.win_matmul(wl, dense, x, addend)
        assert got.dtype == tdt
        torch.testing.assert_close(
            got.float(), ws.win_matmul_plain(wl, dense, x, addend).float(),
            **tol)
        want = 1
    elif kernel == "win_bwd_slab":
        got = ws.win_bwd_slab(wl, dense, gr, tdt)
        assert got.dtype == tdt and got.shape == (n, LABEL_D)
        torch.testing.assert_close(
            got.float(), ws.win_bwd_slab_plain(wl, dense, gr, tdt).float(),
            **tol)
        want = 1
    else:
        a = 32
        wk = (0.1 * torch.randn(LABEL_D, a, generator=gen,
                                device=cuda)).to(tdt)
        bk = 0.1 * torch.randn(a, generator=gen, device=cuda)
        if kernel == "attention_kproj":
            torch.testing.assert_close(fa.attention_kproj(x, wk, bk),
                                       fa.attention_kproj_plain(x, wk, bk),
                                       rtol=1e-5, atol=1e-4)
        else:
            q = (0.3 * torch.randn(n, a, generator=gen, device=cuda)).to(tdt)
            args = (g.csr, q, x, wk, bk, g.edge_weight, "scaled_dot", 2,
                    1.0, 0.5)
            torch.testing.assert_close(pin_mod.attention_pin(*args),
                                       pin_mod.attention_pin_plain(*args),
                                       rtol=2e-4, atol=2e-5)
        want = 1
    assert LAUNCHES[kernel] == want


def test_cuda_checkpoint_round_trip(cuda, tmp_path):
    """``fit(3)`` against ``fit(1, checkpoint_path=p)`` and, on a fresh
    Trainer, ``fit(3, checkpoint_path=p)`` on the card, with the label
    trick, dropout, batch-norm and adam: the optimizer's state and the
    batch-norm statistics come back on the device, the dropout generator
    is the card's with its state restored, and the two runs' epochs agree
    (NFE equal, losses and weights 1e-6 relative: the same launches on
    the same inputs)."""
    from graphax_torch import Trainer, make_sbm_dataset
    from graphax_torch.train import Config

    cfg = Config(block="constant", hidden_dim=16, use_labels=True,
                 batch_norm=True, use_mlp=True, dropout=0.3,
                 input_dropout=0.2, method="rk4", step_size=0.5, time=1.5,
                 no_early=True, optimizer="adam", lr=0.01)
    data = make_sbm_dataset(num_nodes=300, num_classes=4, num_features=16,
                            seed=2, device=cuda)
    straight_tr = Trainer(cfg, data, device=cuda)
    straight = straight_tr.fit(epochs=3)["history"]
    p = str(tmp_path / "ck")
    Trainer(cfg, data, device=cuda).fit(epochs=1, checkpoint_path=p)
    tr = Trainer(cfg, data, device=cuda)
    info = tr.load_checkpoint(p)
    assert info["epoch"] == 1
    assert tr.generator.device.type == "cuda"
    for prm in tr.model.parameters():
        st = tr.optimizer.state[prm]
        assert st["mu"].device == prm.device == st["nu"].device
        assert st["count"] == 1
    assert all(b.device.type == "cuda" for b in tr.model.buffers())
    resumed = Trainer(cfg, data, device=cuda).fit(epochs=3,
                                                  checkpoint_path=p)
    got = resumed["history"]
    assert [h["epoch"] for h in got] == [2, 3]
    assert [h["nfe"] for h in got] == [h["nfe"] for h in straight[1:]]
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in straight[1:]], rtol=1e-6)


# ----------------------------------------------------------------------
# BLEND: the beltrami_exp score in the pin, flash and gmax kernels, the
# kNN sweep and the GAT RHS

def _beltrami_inputs(g, dtype, d, a, heads, seed):
    """q [N, 2A] and the K weight [D, 2A] in the kernels' Beltrami layout
    (head h's feature slice, then its positional slice), at a scale whose
    squared distances spread over a few units (0.3 randn weights would
    underflow every score)."""
    gen = torch.Generator(device=g.device).manual_seed(seed)
    n, tdt = g.num_nodes, getattr(torch, dtype)
    x = torch.randn(n, d, generator=gen, device=g.device).to(tdt)
    q = (0.3 * torch.randn(n, 2 * a, generator=gen,
                           device=g.device)).to(tdt)
    wk = (0.3 / d ** 0.5 * torch.randn(d, 2 * a, generator=gen,
                                       device=g.device)).to(tdt)
    bk = 0.1 * torch.randn(2 * a, generator=gen, device=g.device)
    return q, x, wk, bk


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,a,heads", [(162, 32, 2), (64, 8, 4)])
def test_cuda_beltrami_kernels_match_plain(cuda, dtype, d, a, heads):
    """attention_kproj, attention_pin, attention_gmax and flash_attention
    in beltrami_exp against their plain versions on a graph with rows of
    0, 1, 31-33, 700 and 3,000 edges (over one batch and over ROW_SPLIT),
    reweight on and off, softmax and squareplus: the pin within its f32
    tolerance, gmax within 1e-6, flash within its tolerance in each
    dtype."""
    from graphax_torch.kernels import LAUNCHES

    g = _walk_graph(cuda)
    deg = (g.csr.ptr[1:] - g.csr.ptr[:-1]).max()
    assert int(deg) > fa.ROW_SPLIT
    q, x, wk, bk = _beltrami_inputs(g, dtype, d, a, heads, seed=d)
    kt = fa.attention_kproj(x, wk, bk)
    torch.testing.assert_close(kt, fa.attention_kproj_plain(x, wk, bk),
                               rtol=1e-5, atol=1e-4)
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-3)
    scal = ("beltrami_exp", heads, 1.3, 0.7)
    bel = dict(ov2p=0.8, inv2l2p=0.4)
    for ew in (None, g.edge_weight):
        args = (g.csr, q, x, wk, bk, ew) + scal
        LAUNCHES.clear()
        got = pin_mod.attention_pin(*args, **bel)
        assert LAUNCHES["attention_pin"] == 1
        torch.testing.assert_close(
            got, pin_mod.attention_pin_plain(*args, **bel), rtol=2e-4,
            atol=2e-5)
        for sqp in (False, True):
            gs = None
            if sqp:
                gs = fa.attention_gmax(g.csr, q, kt, ew, *scal, **bel)
                torch.testing.assert_close(
                    gs, fa.attention_gmax_plain(g.csr, q, kt, ew, *scal,
                                                **bel), rtol=1e-6, atol=1e-6)
            got = fa.flash_attention(g.csr, q, x, kt, ew, gs, *scal, **bel)
            want = fa.flash_attention_plain(g.csr, q, x, kt, ew, gs, *scal,
                                            **bel)
            torch.testing.assert_close(got, want, **tol)
            assert torch.all(got[[0, -3, -2, -1]] == 0)


def test_cuda_beltrami_scalars_reach_the_kernels(cuda):
    """Each of the four scalars moves the kernels' scores as it moves the
    plain version's (none is dropped on the way to the device)."""
    g = _cuda_graph(cuda)
    q, x, wk, bk = _beltrami_inputs(g, "float32", 40, 8, 2, seed=3)
    kt = fa.attention_kproj(x, wk, bk)
    base = dict(ov2=1.3, inv2l2=0.7, ov2p=0.8, inv2l2p=0.4)
    for key in base:
        s = dict(base, **{key: base[key] * 1.7})
        pos = ("beltrami_exp", 2, s["ov2"], s["inv2l2"])
        kw = dict(ov2p=s["ov2p"], inv2l2p=s["inv2l2p"])
        got = fa.attention_gmax(g.csr, q, kt, None, *pos, **kw)
        torch.testing.assert_close(
            got, fa.attention_gmax_plain(g.csr, q, kt, None, *pos, **kw),
            rtol=1e-6, atol=1e-6)
        args = (g.csr, q, x, wk, bk, None) + pos
        torch.testing.assert_close(pin_mod.attention_pin(*args, **kw),
                                   pin_mod.attention_pin_plain(*args, **kw),
                                   rtol=2e-4, atol=2e-5)



def _bel_flash_raw(lay, q, x, kt, ew, gs, heads, scal, kvec):
    """gx_flash_attention in beltrami_exp with the K table's 16-byte route
    forced on (kvec 1) or off (0): f32 out."""
    from graphax_torch.kernels import _build

    n, d = x.shape
    a = q.shape[1]
    plan, nlong, nseg = fa._row_plan(lay, fa._BATCH, fa.ROW_SPLIT)
    st = torch.empty((nseg, 2 * heads), device=x.device)
    part = torch.empty((nseg, d), device=x.device)
    out = torch.empty((n, d), device=x.device)
    err = _build.library("fused_attention").gx_flash_attention(
        lay.ptr.data_ptr(), lay.idx.data_ptr(), q.data_ptr(), x.data_ptr(),
        kt.data_ptr(), ew.data_ptr() if ew is not None else None,
        gs.data_ptr() if gs is not None else None, plan.data_ptr(),
        st.data_ptr(), part.data_ptr(), out.data_ptr(), n, d, a, heads,
        fa.ATT_TYPES["beltrami_exp"], int(ew is not None),
        int(gs is not None), *scal, fa._DTYPES[x.dtype], 0,
        fa.gather_width(x), kvec, fa.flash_warps(a, heads, "beltrami_exp"),
        fa.ROW_SPLIT, nlong, nseg, _build.stream_ptr(x))
    _build.check(err, "flash_attention")
    return out


def _bel_gmax_raw(lay, q, kt, ew, heads, scal, qvec):
    """gx_attention_gmax in beltrami_exp with its 16-byte route forced on
    (qvec 1) or off (0), on a fresh zeroed state."""
    from graphax_torch.kernels import _build

    out = torch.empty((), device=q.device)
    state = torch.zeros(2, dtype=torch.int32, device=q.device)
    err = _build.library("fused_attention").gx_attention_gmax(
        lay.seg.data_ptr(), lay.idx.data_ptr(), q.data_ptr(), kt.data_ptr(),
        ew.data_ptr() if ew is not None else None, state.data_ptr(),
        out.data_ptr(), lay.num_slots, q.shape[1], heads,
        fa.ATT_TYPES["beltrami_exp"], int(ew is not None), *scal,
        fa._DTYPES[q.dtype], qvec, _build.stream_ptr(q))
    _build.check(err, "attention_gmax")
    assert torch.all(state == 0)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("a,heads", [(32, 2), (16, 2), (24, 1), (6, 2)])
def test_cuda_beltrami_instances_match_plain_and_routes_agree(cuda, dtype,
                                                              a, heads):
    """flash's and gmax's beltrami_exp instances (halves of 16, 8 and 24
    values on the 16-byte route, 3 on the one-value route) against their
    plain versions within TOL_FLASH and TOL_GMAX, on rows of 0, 1, 31-33,
    700 and 3,000 edges (one batch, the segment kernels), reweight on and
    off, softmax and squareplus, and on views off 16 bytes; the 16-byte
    route against the one-value route of the same instance, bit for bit
    (flash's out, gmax's max)."""
    g = _walk_graph(cuda)
    q, x, wk, bk = _beltrami_inputs(g, dtype, 162, a, heads, seed=a + heads)
    kt = fa.attention_kproj(x, wk, bk)
    hk = a // heads
    assert fa.flash_kvec(kt, heads, "beltrami_exp") == int(hk % 4 == 0)
    qvec = fa.score_vec(q, kt, heads, "beltrami_exp")
    assert qvec == int((hk * q.element_size()) % 16 == 0)
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-3)
    pos = ("beltrami_exp", heads, 1.3, 0.7)
    bel = dict(ov2p=0.8, inv2l2p=0.4)
    scal = (1.3, 0.7, 0.8, 0.4)
    for ew in (None, g.edge_weight):
        gs = fa.attention_gmax(g.csr, q, kt, ew, *pos, **bel)
        torch.testing.assert_close(
            gs, fa.attention_gmax_plain(g.csr, q, kt, ew, *pos, **bel),
            rtol=1e-6, atol=1e-6)
        # the wrapper's route (16-byte where qvec) against the one-value one
        assert torch.equal(_bel_gmax_raw(g.csr, q, kt, ew, heads, scal, 0),
                           gs)
        for shift in (None, gs):
            got = fa.flash_attention(g.csr, q, x, kt, ew, shift, *pos, **bel)
            want = fa.flash_attention_plain(g.csr, q, x, kt, ew, shift, *pos,
                                            **bel)
            torch.testing.assert_close(got, want, **tol)
            assert torch.all(got[[0, -3, -2, -1]] == 0)
            assert torch.equal(
                _bel_flash_raw(g.csr, q, x, kt, ew, shift, heads, scal, 0),
                got)
    # q and the K table one value off 16 bytes: the one-value route
    q_off, kt_off = _off_word(q), _off_word(kt)
    assert fa.score_vec(q_off, kt_off, heads, "beltrami_exp") == 0
    assert fa.flash_kvec(kt_off, heads, "beltrami_exp") == 0
    gs = fa.attention_gmax(g.csr, q_off, kt_off, None, *pos, **bel)
    assert torch.equal(gs, fa.attention_gmax(g.csr, q, kt, None, *pos,
                                             **bel))
    got = fa.flash_attention(g.csr, q_off, x, kt_off, None, gs, *pos, **bel)
    assert torch.equal(got, fa.flash_attention(g.csr, q, x, kt, None, gs,
                                               *pos, **bel))


def test_cuda_beltrami_instances_leave_other_types_alone(cuda):
    """The other score types still reach their own instances: each type's
    flash and gmax against its plain version on the long-row graph at a
    head slice of 16 (scaled_dot's 16-byte route), so a dispatch that sent
    them to the beltrami_exp instance shows."""
    g = _walk_graph(cuda)
    q, x, wk, bk = _flash_inputs(g, "float32", 40, 32, seed=4)
    kt = fa.attention_kproj(x, wk, bk)
    ew = g.edge_weight
    for att_type in ("scaled_dot", "cosine_sim", "pearson", "exp_kernel"):
        scal = (att_type, 2, 1.3, 0.7)
        gs = fa.attention_gmax(g.csr, q, kt, ew, *scal)
        torch.testing.assert_close(
            gs, fa.attention_gmax_plain(g.csr, q, kt, ew, *scal), rtol=1e-6,
            atol=1e-6)
        for shift in (None, gs):
            got = fa.flash_attention(g.csr, q, x, kt, ew, shift, *scal)
            torch.testing.assert_close(
                got, fa.flash_attention_plain(g.csr, q, x, kt, ew, shift,
                                              *scal), rtol=2e-4, atol=2e-5)

def _norm_raw(lay, q, kt, gs, heads, att_type, kvec, ew=None,
              scal=(1.3, 0.7, 0.8, 0.4)):
    """gx_attention_norm with its kvec argument forced: (the return code,
    e, den)."""
    from graphax_torch.kernels import _build

    n = q.shape[0]
    plan, nlong, nseg = fa._row_plan(lay, fa.NORM_CUT, fa.NORM_SEG)
    part = torch.empty((nseg, heads), device=q.device)
    e = torch.empty((lay.num_slots, heads), device=q.device)
    den = torch.empty((n, heads), device=q.device)
    err = _build.library("fused_attention").gx_attention_norm(
        lay.ptr.data_ptr(), lay.idx.data_ptr(), q.data_ptr(), kt.data_ptr(),
        ew.data_ptr() if ew is not None else None, gs.data_ptr(),
        plan.data_ptr(), part.data_ptr(), e.data_ptr(), den.data_ptr(), n,
        q.shape[1], heads, fa.ATT_TYPES[att_type], int(ew is not None), 0,
        *scal, fa._DTYPES[q.dtype], kvec, nlong, nseg, _build.stream_ptr(q))
    torch.cuda.synchronize()
    return err, e, den


def test_cuda_norm_reads_kvec_for_scaled_dot_only(cuda):
    """gx_attention_norm's 16-byte instances score scaled_dot and
    beltrami_exp only: with kvec 1 each other type gives its own plain
    scores, bit for bit its kvec 0 output; beltrami_exp (att_type 4, with
    its positional pair) reaches its own instance with either kvec, each
    within graphax's attention tolerance of the plain version and the two
    bit for bit each other, so no type is scored as another."""
    g = _walk_graph(cuda)
    q, x, wk, bk = _flash_inputs(g, "float32", 40, 32, seed=6)
    kt = fa.attention_kproj(x, wk, bk)
    f32 = dict(rtol=2e-4, atol=2e-5)
    for att_type in ("scaled_dot", "cosine_sim", "pearson", "exp_kernel",
                     "beltrami_exp"):
        scal = (att_type, 2, 1.3, 0.7)
        bel = dict(ov2p=0.8, inv2l2p=0.4)
        gs = fa.attention_gmax(g.csr, q, kt, None, *scal, **bel)
        w_e, w_den = fa.attention_norm_plain(g.csr, q, kt, None, gs, *scal,
                                             **bel)
        err1, e1, den1 = _norm_raw(g.csr, q, kt, gs, 2, att_type, 1)
        err0, e0, den0 = _norm_raw(g.csr, q, kt, gs, 2, att_type, 0)
        assert err1 == 0 and err0 == 0
        torch.testing.assert_close(e1, w_e, **f32)
        torch.testing.assert_close(den1, w_den, **f32)
        if att_type != "scaled_dot":
            assert torch.equal(e1, e0) and torch.equal(den1, den0)


def _bel_pin_raw(lay, q, kt, ew, heads, scal, kvec):
    """gx_attention_pin in beltrami_exp on the K table ``kt`` with the
    16-byte route forced on (kvec 1) or off (0)."""
    from graphax_torch.kernels import _build

    n, a = q.shape
    plan, nlong, nseg = fa._row_plan(lay, fa._BATCH, fa.ROW_SPLIT)
    st = torch.empty((nseg, 2 * heads), device=q.device)
    out = torch.empty(lay.num_slots, device=q.device)
    err = _build.library("attention_pin").gx_attention_pin(
        lay.ptr.data_ptr(), lay.idx.data_ptr(), q.data_ptr(), kt.data_ptr(),
        ew.data_ptr() if ew is not None else None, plan.data_ptr(),
        st.data_ptr(), out.data_ptr(), n, a, heads,
        fa.ATT_TYPES["beltrami_exp"], *scal, fa._DTYPES[q.dtype], kvec,
        fa.flash_warps(a, heads, "beltrami_exp"), fa.ROW_SPLIT, nlong, nseg,
        _build.stream_ptr(q))
    _build.check(err, "attention_pin")
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("a,heads", [(32, 2), (16, 2), (24, 1), (6, 2),
                                     (12, 2)])
def test_cuda_pin_and_norm_beltrami_instances_match_plain(cuda, dtype, a,
                                                          heads):
    """The pin's and the norm's beltrami_exp instances (halves of 16, 8
    and 24 values on the 16-byte route; 3, odd, and 6, not a multiple of
    4, on the one-value route) against their plain versions on rows of 0,
    1, 31-33, 700 and 3,000 edges (one batch or group, the segment
    kernels), reweight off and on, the norm under softmax and squareplus:
    the pin within its f32 tolerance (2e-4 / 2e-5), e and den at graphax's
    attention tolerance (2e-4 / 2e-5); the 16-byte route bit for bit the
    one-value route of the same instance; empty rows without e."""
    from graphax_torch.kernels import LAUNCHES

    g = _walk_graph(cuda, seed=17)
    q, x, wk, bk = _beltrami_inputs(g, dtype, 162, a, heads, seed=a + heads)
    kt = fa.attention_kproj(x, wk, bk)
    hk = a // heads
    assert fa.flash_kvec(kt, heads, "beltrami_exp") == int(hk % 4 == 0)
    qvec = fa.score_vec(q, kt, heads, "beltrami_exp")
    assert qvec == int((hk * q.element_size()) % 16 == 0)
    pos = ("beltrami_exp", heads, 1.3, 0.7)
    bel = dict(ov2p=0.8, inv2l2p=0.4)
    scal = (1.3, 0.7, 0.8, 0.4)
    f32 = dict(rtol=2e-4, atol=2e-5)
    empty = [0, -3, -2, -1]
    for ew in (None, g.edge_weight):
        args = (g.csr, q, x, wk, bk, ew) + pos
        LAUNCHES.clear()
        got = pin_mod.attention_pin(*args, **bel)
        assert LAUNCHES["attention_pin"] == LAUNCHES["attention_kproj"] == 1
        torch.testing.assert_close(
            got, pin_mod.attention_pin_plain(*args, **bel), **f32)
        for kvec in (0, 1) if hk % 4 == 0 else (0,):
            assert torch.equal(
                _bel_pin_raw(g.csr, q, kt, ew, heads, scal, kvec), got)
        gs = fa.attention_gmax(g.csr, q, kt, ew, *pos, **bel)
        for sqp in (False, True):
            e, den = fa.attention_norm(g.csr, q, kt, ew, gs, *pos,
                                       square_plus=sqp, **bel)
            w_e, w_den = fa.attention_norm_plain(g.csr, q, kt, ew, gs, *pos,
                                                 sqp, **bel)
            torch.testing.assert_close(e, w_e, **f32)
            torch.testing.assert_close(den, w_den, **f32)
            assert not den[empty].any()
            if sqp:
                continue
            for kvec in (0, 1) if qvec else (0,):
                err, e_k, den_k = _norm_raw(g.csr, q, kt, gs, heads,
                                            "beltrami_exp", kvec, ew, scal)
                assert err == 0 and torch.equal(e_k, e) \
                    and torch.equal(den_k, den)
    # q and the K table one value off 16 bytes: the one-value routes
    q_off, kt_off = _off_word(q), _off_word(kt)
    assert fa.score_vec(q_off, kt_off, heads, "beltrami_exp") == 0
    assert fa.flash_kvec(kt_off, heads, "beltrami_exp") == 0
    gs = fa.attention_gmax(g.csr, q, kt, None, *pos, **bel)
    e, den = fa.attention_norm(g.csr, q, kt, None, gs, *pos, **bel)
    e_off, den_off = fa.attention_norm(g.csr, q_off, kt_off, None, gs, *pos,
                                       **bel)
    assert torch.equal(e_off, e) and torch.equal(den_off, den)


def _doubled_row_layouts(device, n=300, seed=19):
    """Two CSR layouts over the same nodes: in the first, row 0 has 32
    edges (one batch: pin_kernel's); in the second, row 0 has the same 32
    columns twice in the same order, 64 edges (one segment of two batches:
    pin_seg_stats', pin_seg_write's); the other rows random, the same in
    both."""
    from graphax_torch.sparse.graph import Layout

    rng = np.random.RandomState(seed)
    cols = rng.choice(np.arange(1, n), 32, replace=False)
    deg = np.r_[0, rng.randint(0, 9, n - 1)]
    col = rng.randint(0, n, int(deg.sum()))
    out = []
    for times in (1, 2):
        d = np.r_[32 * times, deg[1:]]
        row = np.repeat(np.arange(n), d)
        out.append(Layout(
            ptr=torch.as_tensor(np.r_[0, np.cumsum(d)], dtype=torch.int32,
                                device=device),
            seg=torch.as_tensor(row, dtype=torch.int64, device=device),
            idx=torch.as_tensor(np.r_[np.tile(cols, times), col],
                                dtype=torch.int32, device=device),
            perm=None))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("att_type", ["beltrami_exp", "scaled_dot",
                                      "cosine_sim", "pearson", "exp_kernel"])
def test_cuda_pin_segment_scores_are_the_batch_kernels(cuda, dtype, att_type):
    """pin_seg_write recomputes its batches' scores: on a row of 32
    columns taken twice (two batches of one segment) they are pin_kernel's
    bits on the same row of 32. The segment's max is the batch's and its
    denominator exactly twice the batch's, so each of the 64 edges gets
    exactly half the one-batch edge's mean, and both copies the same."""
    one_lay, two_lay = _doubled_row_layouts(cuda)
    g = _cuda_graph(cuda)       # 300 nodes: the inputs' shapes
    if att_type == "beltrami_exp":
        q, x, wk, bk = _beltrami_inputs(g, dtype, 40, 16, 2, seed=5)
        kw = dict(ov2p=0.8, inv2l2p=0.4)
    else:
        q, x, wk, bk = _flash_inputs(g, dtype, 40, 32, seed=5)
        kw = {}
    args = (q, x, wk, bk, None, att_type, 2, 1.3, 0.7)
    one = pin_mod.attention_pin(one_lay, *args, **kw)
    two = pin_mod.attention_pin(two_lay, *args, **kw)
    torch.testing.assert_close(two, pin_mod.attention_pin_plain(
        two_lay, *args, **kw), rtol=2e-4, atol=2e-5)
    assert torch.equal(two[:32], two[32:64])
    assert torch.equal(2 * two[:32], one[:32])
    assert torch.equal(two[64:], one[32:])          # the other rows


# the other score types' pin and norm outputs on the inputs of
# `_other_type_outputs`, as the kernels gave them before the beltrami_exp
# instances of the pin and the norm (digests of their bytes, recorded on
# an NVIDIA H100 80GB HBM3 from the kernels of the tree before them)
OTHER_TYPE_DIGESTS = {
    "norm den cosine_sim bfloat16": "e7e4f84b585b8715",
    "norm den cosine_sim float32": "ea1d7567877397d8",
    "norm den exp_kernel bfloat16": "12e8c82052620be6",
    "norm den exp_kernel float32": "0c4e1699d82d6df9",
    "norm den pearson bfloat16": "e2759ec07ad3fa7f",
    "norm den pearson float32": "93e08542c66cafaf",
    "norm den scaled_dot bfloat16": "a0ac944eab6393d7",
    "norm den scaled_dot float32": "666a1fb2321c9efc",
    "norm e cosine_sim bfloat16": "08dfbdf6484c54dd",
    "norm e cosine_sim float32": "380607eaebd5e79d",
    "norm e exp_kernel bfloat16": "55f968db43a1a3c6",
    "norm e exp_kernel float32": "40c100cd9d87ccb5",
    "norm e pearson bfloat16": "49f71b4603db2366",
    "norm e pearson float32": "0730cfc00602d541",
    "norm e scaled_dot bfloat16": "6da34c494b863bf0",
    "norm e scaled_dot float32": "5b9b367088d52050",
    "pin cosine_sim bfloat16": "f3da91d4e5f896ae",
    "pin cosine_sim float32": "335a41bde4866135",
    "pin exp_kernel bfloat16": "b8b3b7fcd37a6e01",
    "pin exp_kernel float32": "c1fc87445195026d",
    "pin pearson bfloat16": "80d05ed755f3e791",
    "pin pearson float32": "5e0762692c35d71a",
    "pin scaled_dot bfloat16": "5b2e533399040b29",
    "pin scaled_dot float32": "8b685c2018c8973f",
}


def _other_type_outputs(device):
    """The pin's per-slot means and the norm's e and den for scaled_dot,
    cosine_sim, pearson and exp_kernel, f32 and bf16, reweight on, on
    `_walk_graph` with q, x, Wk and bk from a numpy seed (the card's own
    generator plays no part): ``{case: sha256 of the output's bytes, first
    16 hex digits}``."""
    import hashlib

    g = _walk_graph(device)
    rng = np.random.RandomState(21)
    n, d, a, heads = g.num_nodes, 40, 32, 2
    base = [torch.from_numpy(t.astype(np.float32)).to(device) for t in (
        0.3 * rng.randn(n, a), rng.randn(n, d), 0.3 * rng.randn(d, a))]
    bk = torch.from_numpy((0.1 * rng.randn(a)).astype(np.float32)).to(device)
    digest = lambda t: hashlib.sha256(  # noqa: E731
        t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, x, wk = (t.to(dtype) for t in base)
        kt = fa.attention_kproj(x, wk, bk)
        for att_type in ("scaled_dot", "cosine_sim", "pearson",
                         "exp_kernel"):
            scal = (att_type, heads, 1.3, 0.7)
            tag = f"{att_type} {str(dtype)[6:]}"
            out["pin " + tag] = digest(pin_mod.attention_pin(
                g.csr, q, x, wk, bk, g.edge_weight, *scal))
            gs = fa.attention_gmax(g.csr, q, kt, g.edge_weight, *scal)
            e, den = fa.attention_norm(g.csr, q, kt, g.edge_weight, gs,
                                       *scal)
            out["norm e " + tag] = digest(e)
            out["norm den " + tag] = digest(den)
    return out


def test_cuda_pin_and_norm_other_types_keep_their_bits(cuda):
    """The beltrami_exp instances of the pin and the norm left the other
    score types' instances alone: their outputs on a fixed input are bit
    for bit those the kernels gave before (OTHER_TYPE_DIGESTS)."""
    assert _other_type_outputs(cuda) == OTHER_TYPE_DIGESTS


def _knn_rows_agree(d_got, i_got, d_want, i_want, d_all, k):
    """The chosen distances within f32 rounding on every row, and the
    neighbour sets equal on the rows whose k-th and (k+1)-th distances are
    apart by more than that rounding."""
    np.testing.assert_allclose(d_got, d_want, rtol=1e-4, atol=1e-3)
    srt = np.sort(d_all, axis=1)
    gap = srt[:, k] - srt[:, k - 1] > 1e-3 + 1e-4 * np.abs(srt[:, k])
    assert gap.mean() > 0.5
    for r in np.nonzero(gap)[0]:
        assert set(i_got[r]) == set(i_want[r])


def test_cuda_knn_graph_matches_cpu(cuda):
    """`knn_distances` on the card against the CPU on 700 rows of 24
    features (a zero row among them), in blocks of 256 rows: the distances
    each row keeps, and its neighbour set where no tie straddles the k-th
    place."""
    from graphax_torch.rewiring.knn import knn_distances, knn_graph

    rng = np.random.RandomState(4)
    x = rng.randn(700, 24).astype(np.float32)
    x[9] = 0.0
    k = 12
    dc, ic = knn_distances(torch.from_numpy(x), k, block_size=256)
    dg, ig = knn_distances(torch.from_numpy(x).to(cuda), k, block_size=256)
    xt = torch.from_numpy(x)
    d_all = ((xt[:, None] - xt[None]) ** 2).sum(-1).numpy()
    d_all[9, :] = np.inf
    d_all[:, 9] = np.inf
    live = np.ones(700, bool)
    live[9] = False
    _knn_rows_agree(dg.cpu().numpy()[live], ig.cpu().numpy()[live],
                    dc.numpy()[live], ic.numpy()[live], d_all[live], k)
    row, col = knn_graph(torch.from_numpy(x).to(cuda), k)
    assert row.shape == col.shape == (700 * k,)
    assert 9 not in set(col[row != 9].tolist())


@pytest.mark.parametrize("mix", [False, True])
def test_cuda_gat_rhs_matches_cpu(cuda, mix):
    """The GAT RHS (its A x through spmm_csr) and its gradients on the card
    against the CPU from the same weights, f32: the value and the gradients
    of x, W, a and Wout within 1e-4 plus 1e-3 relative (sums in another
    order)."""
    from graphax_torch.functions.gat import GATFunction
    from graphax_torch.functions.common import FuncState, prepare_scalars
    from graphax_torch.kernels import LAUNCHES
    from graphax_torch.train import Config

    cfg = Config(function="GAT", heads=2, attention_dim=8,
                 mix_features=mix, add_source=True)
    outs = {}
    for dev in ("cpu", cuda):
        g = _cuda_graph(dev)
        f = GATFunction(cfg, 12).to(dev)
        f.reset_parameters(torch.Generator().manual_seed(0))
        with torch.no_grad():
            f.alpha_train.fill_(0.3)
        x = torch.randn(g.num_nodes, 12,
                        generator=torch.Generator().manual_seed(1)) \
            .to(dev).requires_grad_(True)
        alpha, beta = prepare_scalars(f, cfg, x.dtype)
        LAUNCHES.clear()
        y = f.rhs(alpha, beta, FuncState(graph=g, x0=x.detach()), 0.0, x)
        y.square().sum().backward()
        if dev != "cpu" and not mix:
            assert LAUNCHES["spmm_csr"] >= 2 and LAUNCHES["sddmm"] == 1
        outs[str(dev)] = [t.detach().cpu() for t in (
            y, x.grad, f.att.W.grad, f.att.a.grad, f.att.Wout.grad
            if mix else torch.zeros(()))]
    for got, want in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


# ----------------------------------------------------------------------
# second derivatives through the Functions, and Adams, on the card
# ----------------------------------------------------------------------

# (N, tile, W, D): a small odd shape and the arxiv preset's (169,343 nodes
# on 1,323 tiles of 128 rows, windows of 512, D 162)
SECOND_SHAPES = {"small_odd": (301, 8, 16, 5),
                 "arxiv": (169_343, 128, 512, 162)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SECOND_SHAPES))
@pytest.mark.parametrize("which", ["spmm", "windowed"])
def test_cuda_second_derivatives_match_plain(cuda, dtype, shape, which):
    """Each Function's backward differentiated again (`_SpMM` with
    `_SDDMM`; `_WinMatmul` with `_WinBwdSlab` and `_WinBwdDense`) against
    the same composition with the plain versions (chip_smoke's
    ``plain_kernels``), at chip_smoke's tolerance ``TOL_SECOND``: f32 1e-4
    relative plus 1e-4 of the largest entry; bf16 2e-2 relative plus two
    bf16 ulps of the largest entry. Every kernel of the composition
    launches."""
    import chip_smoke
    from graphax_torch.kernels import LAUNCHES

    n, tile, window, d = SECOND_SHAPES[shape]
    g = _windowed_graph(cuda, n, tile, window)
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(7)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=cuda)
    x, v, u = rnd(n, d).to(tdt), rnd(n, d).to(tdt), rnd(n, d)
    if which == "spmm":
        wb = g.edge_weight.to(tdt).detach().clone()
        c = rnd(g.edge_buffer_size)
        fn = lambda: chip_smoke.second_order_spmm(
            g, wb.requires_grad_(True), x.requires_grad_(True),
            v.requires_grad_(True), u, c)
        kernels = ("spmm_csr", "sddmm")
    else:
        wl = g.windows
        blocks = ws.densify_plain(wl, g.edge_weight, tdt)
        c = rnd(*wl.block_shape)
        fn = lambda: chip_smoke.second_order_windowed(
            wl, blocks.requires_grad_(True), x.requires_grad_(True),
            v.requires_grad_(True), u, c)
        kernels = ("win_matmul", "win_bwd_slab", "win_bwd_dense")
    LAUNCHES.clear()
    got = fn()
    for k in kernels:
        assert LAUNCHES[k] > 0, k
    with chip_smoke.plain_kernels():
        want = fn()
    atol_of_max, rtol = chip_smoke.TOL_SECOND[dtype]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(
            a.float(), b.float(), rtol=rtol,
            atol=atol_of_max * float(b.float().abs().max()))


@pytest.mark.parametrize("method", ["explicit_adams", "implicit_adams"])
def test_cuda_adams_matches_cpu(cuda, method):
    """Adams on the card against the CPU, f32: a tuple state's solve
    (values within 1e-5, NFE equal) and a train step of the laplacian
    model from the same weights (loss within 1e-4, forward NFE equal)."""
    from graphax_torch import Config, Trainer, make_sbm_dataset
    from graphax_torch.ode import odeint

    a = torch.randn(6, 6, generator=torch.Generator().manual_seed(0)) * 0.3
    out = {}
    for dev in ("cpu", cuda):
        am = a.to(dev)
        res = odeint(lambda t, y: (torch.tanh(y[0] @ am.T) - 0.5 * y[0],
                                   -y[1]),
                     (torch.ones(6, device=dev), torch.ones(3, device=dev)),
                     0.0, 2.0, method=method, step_size=0.1)
        data = make_sbm_dataset(num_nodes=400, num_classes=4,
                                num_features=32, seed=0, strategy="sparse",
                                device=dev)
        cfg = Config(block="constant", hidden_dim=16, method=method,
                     step_size=0.25, time=2.0, input_dropout=0.0,
                     dropout=0.0, no_early=True)
        tr = Trainer(cfg, data, device=dev)
        out[str(dev)] = (res, tr.train_step(), tr.fm.get_value())
    (rc, lc, fc), (rp, lp, fp) = out["cuda"], out["cpu"]
    assert rc.nfe == rp.nfe and fc == fp
    for yc, yp in zip(rc.y, rp.y):
        torch.testing.assert_close(yc.cpu(), yp, rtol=1e-5, atol=1e-6)
    assert abs(lc - lp) <= 1e-4 * max(1.0, abs(lp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_union_spmm_matches_per_sample_plain(cuda, dtype):
    """The block-diagonal union of per-sample chain graphs (the multimodal
    model's batched route): one `spmm_csr` launch for the whole batch,
    each sample's rows against the plain version on that sample's graph
    alone (f32 1e-5; bf16 one ulp)."""
    from graphax_torch.data.multimodal import batched_chain_graphs
    from graphax_torch.kernels import LAUNCHES

    tdt = getattr(torch, dtype)
    lengths, max_len, d = [8, 16, 11, 9, 16], 16, 64
    batch = batched_chain_graphs(lengths, max_len, device=cuda)
    u = batch.union()
    gen = torch.Generator(device=cuda).manual_seed(21)
    x = torch.randn(u.num_nodes, d, generator=gen, device=cuda).to(tdt)
    w = (torch.rand(u.num_edges, generator=gen, device=cuda) + 0.1).to(tdt)
    before = LAUNCHES["spmm_csr"]
    y = spmm_mod.spmm_csr(u.csr, w, x, u.num_nodes)
    assert LAUNCHES["spmm_csr"] == before + 1
    off = 0
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=BF16_RTOL, atol=BF16_RTOL))
    for i in range(len(lengths)):
        g = batch.sample(i).to("cpu")
        e = g.num_edges
        rows = slice(i * max_len, (i + 1) * max_len)
        want = spmm_mod.spmm_csr_plain(g.csr, w[off:off + e].cpu(),
                                       x[rows].cpu(), max_len)
        torch.testing.assert_close(y[rows].cpu(), want, **tol)
        off += e


@pytest.mark.parametrize("block", ["constant", "attention"])
def test_cuda_multimodal_union_launches_once_per_evaluation(cuda, block):
    """`MultimodalGNN.forward_batched` on per-sample chain graphs under
    rk4: `spmm_csr` once an evaluation for the batch (the NFE, not B
    times it), the attention block's pin once a forward; the logits
    against per-sample forwards on the card (1e-5) and against the CPU
    (1e-4)."""
    from graphax_torch.data.multimodal import batched_chain_graphs
    from graphax_torch.kernels import LAUNCHES
    from graphax_torch.models.multimodal import MultimodalGNN
    from graphax_torch.train import Config

    cfg = Config(block=block, method="rk4", step_size=0.25, time=1.0,
                 input_dropout=0.0, dropout=0.0, heads=2, attention_dim=8)
    lengths, max_len, d = [8, 16, 11, 12], 16, 32
    logits = {}
    for dev in (cuda, torch.device("cpu")):
        model = MultimodalGNN(cfg, max_len, d, 5).to(dev)
        model.reset_parameters(torch.Generator().manual_seed(3))
        batch = batched_chain_graphs(lengths, max_len, device=dev)
        xs = torch.randn(len(lengths), max_len, d,
                         generator=torch.Generator().manual_seed(4)).to(dev)
        counts = dict(LAUNCHES)
        with torch.no_grad():
            out, aux = model.forward_batched(None, xs, graphs=batch)
        if dev.type == "cuda":
            assert LAUNCHES["spmm_csr"] - counts.get("spmm_csr", 0) == \
                aux["nfe"][0] == 16
            assert LAUNCHES["attention_pin"] \
                - counts.get("attention_pin", 0) == \
                (1 if block == "attention" else 0)
            for i in range(len(lengths)):
                with torch.no_grad():
                    one, _ = model(batch.sample(i), xs[i])
                torch.testing.assert_close(out[i], one, rtol=1e-5,
                                           atol=1e-5)
        logits[dev.type] = out.cpu()
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=1e-4,
                               atol=1e-4)


def test_cuda_multimodal_union_grand_nl_once_per_evaluation(cuda):
    """GRAND-nl (row softmax) on the block-diagonal union of per-sample
    chain graphs under rk4: `flash_attention` and `attention_kproj` once an
    evaluation for the whole batch (the NFE, not B times it); the logits
    against per-sample forwards on the card (1e-5) and against the CPU
    (1e-4)."""
    from graphax_torch.data.multimodal import batched_chain_graphs
    from graphax_torch.kernels import LAUNCHES
    from graphax_torch.models.multimodal import MultimodalGNN, one_solve
    from graphax_torch.train import Config

    cfg = Config(block="constant", function="transformer", method="rk4",
                 step_size=0.25, time=1.0, input_dropout=0.0, dropout=0.0,
                 heads=2, attention_dim=8)
    assert one_solve(cfg, False, False)
    lengths, max_len, d = [8, 16, 11, 12], 16, 32
    logits = {}
    for dev in (cuda, torch.device("cpu")):
        model = MultimodalGNN(cfg, max_len, d, 5).to(dev)
        model.reset_parameters(torch.Generator().manual_seed(3))
        with torch.no_grad():
            for lin in (model.block.func.att.Q, model.block.func.att.K):
                lin.weight.copy_(0.3 * torch.randn(
                    lin.weight.shape,
                    generator=torch.Generator().manual_seed(5)))
        batch = batched_chain_graphs(lengths, max_len, device=dev)
        xs = torch.randn(len(lengths), max_len, d,
                         generator=torch.Generator().manual_seed(4)).to(dev)
        counts = dict(LAUNCHES)
        with torch.no_grad():
            out, aux = model.forward_batched(None, xs, graphs=batch)
        if dev.type == "cuda":
            for name in ("flash_attention", "attention_kproj"):
                assert LAUNCHES[name] - counts.get(name, 0) == \
                    aux["nfe"][0] == 16, name
            for i in range(len(lengths)):
                with torch.no_grad():
                    one, _ = model(batch.sample(i), xs[i])
                torch.testing.assert_close(out[i], one, rtol=1e-5,
                                           atol=1e-5)
        logits[dev.type] = out.cpu()
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=1e-4,
                               atol=1e-4)


# ----------------------------------------------------------------------
# Two threads on two streams: the sweep's concurrent trials share one
# dataset, so its layouts and the caches built from them

def _hub_graph(device, n=600, seed=12):
    """Random edges plus two hub rows (200 and 140 edges) and a hub column,
    so the row-split plans and the long-row segments are taken."""
    rng = np.random.RandomState(seed)
    row = np.concatenate([rng.randint(0, n, 3000), np.full(200, 3),
                          np.full(140, 17), rng.randint(0, n, 150)])
    col = np.concatenate([rng.randint(0, n, 3000), rng.randint(0, n, 200),
                          rng.randint(0, n, 140), np.full(150, 5)])
    key = np.unique(row * n + col)
    row, col = key // n, key % n
    w = rng.rand(len(row)).astype(np.float32) + 0.1
    return Graph.from_edges(row, col, n, edge_weight=w,
                            edge_buffer_size=len(row) + 9, device=device)


def _stream_case(device):
    g = _hub_graph(device)
    wg = _windowed_graph(device, 3000, 128, 512)
    gen = torch.Generator(device=device).manual_seed(13)
    tdt, n, d, a = torch.bfloat16, g.num_nodes, 162, 32
    ops = dict(
        x=torch.randn(n, d, generator=gen, device=device).to(tdt),
        gr=torch.randn(n, d, generator=gen, device=device).to(tdt),
        q=(0.3 * torch.randn(n, a, generator=gen, device=device)).to(tdt),
        wk=(0.1 * torch.randn(d, a, generator=gen, device=device)).to(tdt),
        bk=0.1 * torch.randn(a, generator=gen, device=device),
        xw=torch.randn(3000, d, generator=gen, device=device).to(tdt),
        aw=torch.randn(3000, d, generator=gen, device=device).to(tdt))
    return g, wg, ops


def _stream_run(g, wg, o):
    """spmm_csr (A x, A^T g), sddmm, the pin and win_matmul on the shared
    layouts, and the caches they build: the row-split plans, the CSR/CSC
    slot map, the windowed layout's in-window CSR."""
    tdt = o["x"].dtype
    w = g.edge_weight.to(tdt)
    wt = spmm_mod.transpose_values(g, w)
    wl = wg.windows
    dense = ws.densify(wl, wg.edge_weight, tdt)
    return {
        "A.x": spmm_mod.spmm_csr(g.csr, w, o["x"], g.num_nodes),
        "AT.g": spmm_mod.spmm_csr(g.csc, wt, o["gr"], g.num_nodes),
        "sddmm": spmm_mod.sddmm(g.csr, o["gr"], o["x"]),
        "slots": spmm_mod._transpose_slots(g.csr, g.csc),
        "pin": pin_mod.attention_pin(g.csr, o["q"], o["x"], o["wk"],
                                     o["bk"], g.edge_weight, "scaled_dot",
                                     2, 1.0, 0.5),
        "win_matmul": ws.win_matmul(wl, dense, o["xw"], o["aw"]),
        "in_window": wl.in_window.idx,
    }


def test_cuda_kernels_on_two_streams_equal_one_stream(cuda):
    """Two threads, each on a stream of its own (the sweep's `on_device`),
    run the kernels on layouts no call has touched yet, so the first
    thread's plans and slot maps are made on one stream while the other
    reads them; both results are bit for bit those of the same calls on
    one stream, on the same layouts afterwards and on fresh ones."""
    import threading

    from graphax_torch.train.sweep import on_device

    g, wg, ops = _stream_case(cuda)
    torch.cuda.synchronize()
    results, errors = [None, None], []
    barrier = threading.Barrier(2)

    def worker(i):
        try:
            with on_device(cuda):
                assert torch.cuda.current_stream() != \
                    torch.cuda.default_stream()
                barrier.wait()
                results[i] = {k: v.clone() for k, v in
                              _stream_run(g, wg, ops).items()}
        except BaseException as e:          # reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    fresh_g, fresh_wg, _ = _stream_case(cuda)
    for want in (_stream_run(g, wg, ops), _stream_run(fresh_g, fresh_wg,
                                                      ops)):
        for got in results:
            for k, v in want.items():
                assert torch.equal(got[k], v), k


def test_cuda_launches_lose_no_count_under_two_threads(cuda):
    import threading

    from graphax_torch.kernels import LAUNCHES
    from graphax_torch.train.sweep import on_device

    g = _hub_graph(cuda)
    x = torch.randn(g.num_nodes, 16, device=cuda)
    spmm_mod.spmm_csr(g.csr, g.edge_weight, x, g.num_nodes)
    before = LAUNCHES["spmm_csr"]
    barrier = threading.Barrier(2)

    def worker():
        with on_device(cuda):
            barrier.wait()
            for _ in range(2000):
                spmm_mod.spmm_csr(g.csr, g.edge_weight, x, g.num_nodes)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert LAUNCHES["spmm_csr"] - before == 4000


def test_cuda_build_all_from_two_threads_builds_once(cuda, monkeypatch,
                                                     tmp_path):
    """``build_all`` entered from two threads at once on an empty build
    directory: nvcc runs once for the source, both threads return with the
    library loaded, and its kernel matches the plain version."""
    import subprocess
    import threading

    from graphax_torch.kernels import _build

    calls = []
    popen = subprocess.Popen

    def counted(cmd, **kw):
        calls.append(cmd)
        return popen(cmd, **kw)

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "SIGNATURES",
                        {"spmm": _build.SIGNATURES["spmm"]})
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build.subprocess, "Popen", counted)
    barrier = threading.Barrier(2)
    errors = []

    def worker():
        try:
            barrier.wait()
            _build.build_all()
        except BaseException as e:          # reported below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(calls) == 1 and set(_build._LIBS) == {"spmm"}
    assert os.listdir(tmp_path) == [os.path.basename(_build._target(
        "spmm")[1])]
    g = _hub_graph(cuda)
    x = torch.randn(g.num_nodes, 16, device=cuda)
    torch.testing.assert_close(
        spmm_mod.spmm_csr(g.csr, g.edge_weight, x, g.num_nodes),
        spmm_mod.spmm_csr_plain(g.csr, g.edge_weight, x, g.num_nodes),
        rtol=1e-5, atol=1e-5)
