"""The port's kernel modules against graphax's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; graphax
runs its Pallas kernels in interpret mode (as tests/test_pallas_tiled.py
and tests/test_pallas_attention.py do). Inputs are made with numpy from a
seed and transplanted into both packages.

Tolerances: f32 results agree to 1e-5 (sums in another order); bf16 results
round the same bf16 products and f32 sums, so they agree to one bf16 ulp of
the output (2^-7 relative); the pin's scores are f32 in both dtypes and
agree to 2e-4 relative / 2e-5 absolute, as graphax's own pin test states.

The CUDA kernels against their plain versions are in
tests/test_torch_cuda.py, which imports no JAX so that it runs on the
machine with the card."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.blocks.common import make_fstate as gx_make_fstate
from graphax.functions import get_function as gx_get_function
from graphax.functions.common import prepare_scalars as gx_prepare_scalars
from graphax.functions.transformer import (
    attention_edge_means as gx_attention_edge_means,
    transformer_attention_init,
)
from graphax.kernels import pallas_tiled
from graphax.kernels.dispatch import attach_tiles
from graphax.kernels.pallas_attention import attention_edge_means_pallas
from graphax.kernels.pallas_tiled import blocked_values, spmm_pallas
from graphax.sparse import Graph as GxGraph
from graphax.train import Config as GxConfig

from graphax_torch.functions.laplacian import laplacian_rhs
from graphax_torch.functions.transformer import (
    TransformerAttention, attention_edge_means,
)
from graphax_torch.kernels import attention_pin as pin_mod
from graphax_torch.kernels import spmm as spmm_mod
from graphax_torch.sparse.graph import Graph
from graphax_torch.train import Config
from graphax_torch.utils.transplant import load_graphax_params

BF16_RTOL = 2.0 ** -7


def make_graphs(n=37, e=140, seed=0, isolated=True, dup=True, pad=0):
    rng = np.random.RandomState(seed)
    hi = n - 5 if isolated else n          # the last nodes own no edge
    row = rng.randint(0, hi, e)
    col = rng.randint(0, hi, e)
    if dup:
        row[:12], col[:12] = row[12:24], col[12:24]
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    w = (rng.rand(e) + 0.1).astype(np.float32)
    gx = GxGraph.from_edges(row, col, n, edge_weight=w,
                            edge_buffer_size=e + pad)
    gx = dataclasses.replace(attach_tiles(gx, tile=8, block_edges=16),
                             strategy="tiled")
    pt = Graph.from_edges(row, col, n, edge_weight=w, edge_buffer_size=e + pad)
    return gx, pt


def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


# ----------------------------------------------------------------------
# SpMM
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("isolated,pad", [(False, 0), (True, 9)])
def test_spmm_forward_matches_pallas(dtype, isolated, pad):
    gx, pt = make_graphs(isolated=isolated, pad=pad)
    x = np.random.RandomState(1).randn(gx.num_nodes, 6).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    wb = blocked_values(gx.edge_weight, gx.tiles)
    wb_t = blocked_values(gx.edge_weight, gx.tiles_t)
    want = spmm_pallas(wb, wb_t, xj, gx.tiles, gx.tiles_t)

    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    w = pt.edge_weight.to(xt.dtype)
    got = spmm_mod.spmm(pt, w, spmm_mod.transpose_values(pt, w), xt)
    assert got.dtype == xt.dtype
    rtol = 1e-5 if dtype == "float32" else BF16_RTOL
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=rtol,
                               atol=1e-5)
    if isolated:
        assert np.all(got[-5:].float().numpy() == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_gradients_match_pallas(dtype):
    gx, pt = make_graphs(n=41, e=200, seed=2, pad=7)
    rng = np.random.RandomState(3)
    x = rng.randn(41, 6).astype(np.float32)
    probe = rng.randn(41, 6).astype(np.float32)
    jdt = jnp.dtype(dtype)

    def loss_gx(ev, xx):
        wb = blocked_values(ev, gx.tiles).astype(jdt)
        wb_t = blocked_values(ev, gx.tiles_t).astype(jdt)
        y = spmm_pallas(wb, wb_t, xx, gx.tiles, gx.tiles_t)
        return jnp.sum(y.astype(jnp.float32) * probe)

    gw, gxx = jax.grad(loss_gx, argnums=(0, 1))(
        gx.edge_weight, jnp.asarray(x).astype(jdt))

    tdt = getattr(torch, dtype)
    ev = pt.edge_weight.clone().requires_grad_(True)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    wb = ev.to(tdt)
    y = spmm_mod.spmm(pt, wb, spmm_mod.transpose_values(pt, wb), xt)
    (y.float() * torch.from_numpy(probe)).sum().backward()
    rtol = 1e-5 if dtype == "float32" else BF16_RTOL
    np.testing.assert_allclose(xt.grad.float().numpy(), _np(gxx), rtol=rtol,
                               atol=1e-4)
    e = pt.num_edges
    np.testing.assert_allclose(ev.grad[:e].numpy(), _np(gw)[:e], rtol=rtol,
                               atol=1e-4)
    assert np.all(ev.grad[e:].numpy() == 0)


def test_spmm_duplicate_edges_and_padding():
    row = np.array([0, 0, 0, 1, 2, 2])
    col = np.array([1, 1, 2, 0, 1, 1])
    w = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], np.float32)
    g = Graph.from_edges(row, col, 3, edge_weight=w, edge_buffer_size=8)
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 1
    dense = np.zeros((3, 3), np.float32)
    np.add.at(dense, (row, col), w)
    wb = g.edge_weight
    got = spmm_mod.spmm(g, wb, spmm_mod.transpose_values(g, wb), x)
    np.testing.assert_allclose(got.numpy(), dense @ x.numpy(), rtol=1e-6)
    gt = spmm_mod.spmm_csr(g.csc, spmm_mod.transpose_values(g, wb), x, 3)
    np.testing.assert_allclose(gt.numpy(), dense.T @ x.numpy(), rtol=1e-6)


@pytest.mark.parametrize("add_source", [False, True])
def test_laplacian_rhs_matches_pallas_route(monkeypatch, add_source):
    """graphax's laplacian RHS through its Pallas SpMM (FORCE routes
    make_fstate to it, interpreted) against the port's RHS."""
    monkeypatch.setattr(pallas_tiled, "FORCE", True)
    gx, pt = make_graphs(n=33, e=120, seed=5)
    gcfg = GxConfig(function="laplacian", hidden_dim=4, add_source=add_source)
    f = gx_get_function(gcfg, 4)
    params = f.init(jax.random.PRNGKey(0))
    params["alpha_train"] = jnp.asarray(0.4)
    params["beta_train"] = jnp.asarray(-0.3)
    pp = gx_prepare_scalars(params, gcfg, jnp.float32)
    x = np.random.RandomState(7).randn(33, 4).astype(np.float32)
    fs = gx_make_fstate(gx, jnp.asarray(x))
    assert fs.wb is not None
    want = f.rhs(pp, fs, 0.0, jnp.asarray(x))

    cfg = Config(function="laplacian", hidden_dim=4, add_source=add_source)
    xt = torch.from_numpy(x)
    alpha = torch.sigmoid(torch.tensor(0.4))
    w = pt.edge_weight
    got = laplacian_rhs(cfg, pt, alpha, torch.tensor(-0.3), xt, w,
                        spmm_mod.transpose_values(pt, w), xt)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# Attention pin
# ----------------------------------------------------------------------

def pin_setup(att_type, reweight, d=6, seed=1):
    gx, pt = make_graphs(n=29, e=120, seed=0, pad=5)
    gcfg = GxConfig(function="transformer", heads=2, attention_dim=8,
                    hidden_dim=d, attention_type=att_type,
                    reweight_attention=reweight)
    cfg = Config(function="transformer", heads=2, attention_dim=8,
                 hidden_dim=d, attention_type=att_type,
                 reweight_attention=reweight)
    p = transformer_attention_init(jax.random.PRNGKey(0), gcfg, d)
    rng = np.random.RandomState(seed)
    for name in ("Q", "K"):
        p[name] = {"w": jnp.asarray(rng.randn(d, 8) * 0.3, jnp.float32),
                   "b": jnp.asarray(rng.randn(8) * 0.1, jnp.float32)}
    if att_type == "exp_kernel":
        p["output_var"] = jnp.asarray(1.3)
        p["lengthscale"] = jnp.asarray(0.8)
    att = TransformerAttention(cfg, d)
    load_graphax_params(att, jax.tree_util.tree_map(np.asarray, p))
    x = np.random.RandomState(3).randn(29, d).astype(np.float32)
    return gx, pt, gcfg, cfg, p, att, x


@pytest.mark.parametrize("att_type", ["scaled_dot", "cosine_sim", "pearson",
                                      "exp_kernel"])
@pytest.mark.parametrize("reweight", [False, True])
def test_pin_matches_pallas(att_type, reweight):
    gx, pt, gcfg, cfg, p, att, x = pin_setup(att_type, reweight)
    want = attention_edge_means_pallas(gcfg, p, gx.tiles, jnp.asarray(x),
                                       int(gx.edge_buffer_size),
                                       edge_weight=gx.edge_weight)
    with torch.no_grad():
        got = attention_edge_means(att, cfg, pt, torch.from_numpy(x),
                                   differentiable=False)
    assert got.shape == (pt.edge_buffer_size,)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-4, atol=2e-5)
    assert np.all(got[pt.num_edges:].numpy() == 0)


@pytest.mark.parametrize("att_type", ["scaled_dot", "pearson"])
def test_pin_bf16_matches_pallas(att_type):
    """bf16 state: q and Wk rounded to bf16, scores in f32, the result cast
    to bf16 (graphax's `transformer.py:187`): one bf16 ulp apart at most."""
    gx, pt, gcfg, cfg, p, att, x = pin_setup(att_type, True)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = attention_edge_means_pallas(gcfg, p, gx.tiles, xj,
                                       int(gx.edge_buffer_size),
                                       edge_weight=gx.edge_weight) \
        .astype(jnp.bfloat16)
    with torch.no_grad():
        got = attention_edge_means(att, cfg, pt,
                                   torch.from_numpy(x).to(torch.bfloat16),
                                   differentiable=False)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               rtol=BF16_RTOL, atol=1e-6)


def test_pin_refuses_gradients_and_unsupported_configs():
    """The kernel refuses gradients and a beltrami_exp head slice of odd
    width (its feature and positional halves); the configs outside its
    gate (squareplus, column normalisation) take graphax's per-edge route
    in `attention_edge_means`, and match graphax's pin there."""
    gx, pt, gcfg, cfg, p, att, x = pin_setup("scaled_dot", False)
    xt = torch.from_numpy(x)
    with pytest.raises(RuntimeError, match="not differentiable"):
        pin_mod.attention_pin(pt.csr, xt.requires_grad_(True)[:, :8], xt,
                              torch.zeros(6, 8), torch.zeros(8), None,
                              "scaled_dot", 2)
    with pytest.raises(ValueError, match="beltrami"):
        pin_mod.attention_pin(pt.csr, xt[:, :6], xt, torch.zeros(6, 6),
                              torch.zeros(6), None, "beltrami_exp", 2)
    for other in (dict(square_plus=True), dict(attention_norm_idx=1)):
        want = gx_attention_edge_means(p, gcfg.replace(**other), gx,
                                       jnp.asarray(x), differentiable=False)
        with torch.no_grad():
            got = attention_edge_means(att, cfg.replace(**other), pt,
                                       xt.detach(), differentiable=False)
        assert got.shape == (pt.edge_buffer_size,)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-4,
                                   atol=2e-5)
