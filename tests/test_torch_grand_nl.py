"""GRAND-nl's evaluation forward in the port against graphax, on the CPU.

The port's wrappers run their plain versions here; graphax runs its Pallas
flash and gmax kernels in interpret mode (as tests/test_pallas_attention.py
does) on row-tiled graphs of tile 8 and 16-slot blocks, with duplicate
edges, rows without edges and padded edge buffers. Inputs come from numpy
seeds; weights go through `load_graphax_params`.

Tolerances:
- f32: rtol 2e-4 / atol 2e-5 (graphax's own, tests/test_pallas_attention.py),
  logits of the whole evaluation 1e-4 with equal NFE.
- bf16 kernel level: the port rounds ``e = exp(s - final row max)`` to bf16
  where graphax's online recurrence rounds ``exp(s - running max)`` and
  rescales in f32, so the weights differ by a bf16 rounding and outputs by
  a few: 2e-2 relative, 2e-2 absolute on outputs of size ~1 (7.8e-3 seen).
- bf16 evaluation: graphax's CPU route is its XLA block path
  (`graphax/kernels/fused_attention.py:145-224`), which rounds k to bf16
  and shifts by the global max; logits agree to 1e-2 absolute (3.0e-3
  seen on logits of size ~0.5), NFE within one dopri5 step (6; equal
  seen) (ROADMAP Queue 3)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.blocks.common import make_fstate as gx_make_fstate
from graphax.data.synthetic import make_sbm_dataset as gx_make_sbm
from graphax.functions import get_function as gx_get_function
from graphax.functions.common import prepare_scalars as gx_prepare_scalars
from graphax.functions.transformer import (
    multiply_attention as gx_multiply_attention,
    transformer_attention_apply as gx_attention_apply,
    transformer_attention_init,
)
from graphax.kernels import pallas_tiled
from graphax.kernels.dispatch import attach_tiles
from graphax.kernels.pallas_attention import (
    _gmax_call, _prep_inputs, fused_attention_ax_pallas,
)
from graphax.models.gnn import make_gnn
from graphax.sparse import Graph as GxGraph
from graphax.train import Config as GxConfig

from graphax_torch import Trainer, make_sbm_dataset
from graphax_torch.blocks.common import make_fstate
from graphax_torch.functions import get_function
from graphax_torch.functions.common import prepare_scalars
from graphax_torch.functions.transformer import (
    TransformerAttention, multiply_attention, transformer_attention_apply,
)
from graphax_torch.kernels import fused_attention as fa
from graphax_torch.models import GNN
from graphax_torch.sparse.graph import Graph
from graphax_torch.train import Config
from graphax_torch.utils.transplant import load_graphax_params

ATT_TYPES = ["scaled_dot", "cosine_sim", "pearson", "exp_kernel"]
F32 = dict(rtol=2e-4, atol=2e-5)


def make_graphs(n=29, e=120, seed=0, pad=5):
    """The same edges in both packages: the last 4 nodes own no edge, 12
    edges are duplicates, the buffer has ``pad`` padded slots."""
    rng = np.random.RandomState(seed)
    row = rng.randint(0, n - 4, e)
    col = rng.randint(0, n - 4, e)
    row[:12], col[:12] = row[12:24], col[12:24]
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    w = (rng.rand(e) + 0.2).astype(np.float32)
    gx = GxGraph.from_edges(row, col, n, edge_weight=w,
                            edge_buffer_size=e + pad)
    gx = dataclasses.replace(attach_tiles(gx, tile=8, block_edges=16),
                             strategy="tiled")
    pt = Graph.from_edges(row, col, n, edge_weight=w, edge_buffer_size=e + pad)
    return gx, pt


def _cfgs(**kw):
    base = dict(function="transformer", heads=2, attention_dim=8)
    base.update(kw)
    return GxConfig(**base), Config(**base)


def random_attention(gcfg, cfg, d, seed=1):
    """graphax's attention tree with random Q/K at graphax's test scale
    (0.3 randn weights, 0.1 randn biases), and the port's layer loaded from
    it."""
    p = transformer_attention_init(jax.random.PRNGKey(0), gcfg, d)
    rng = np.random.RandomState(seed)
    for name in ("Q", "K"):
        p[name] = {
            "w": jnp.asarray(rng.randn(*p[name]["w"].shape) * 0.3,
                             jnp.float32),
            "b": jnp.asarray(rng.randn(*p[name]["b"].shape) * 0.1,
                             jnp.float32)}
    if gcfg.attention_type == "exp_kernel":
        p["output_var"] = jnp.asarray(1.3)
        p["lengthscale"] = jnp.asarray(0.8)
    att = TransformerAttention(cfg, d)
    load_graphax_params(att, jax.tree_util.tree_map(np.asarray, p))
    return p, att


def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


# ----------------------------------------------------------------------
# the kernels' plain versions against graphax's interpreted Pallas kernels
# ----------------------------------------------------------------------

@pytest.mark.parametrize("att_type", ATT_TYPES)
@pytest.mark.parametrize("square_plus", [False, True])
@pytest.mark.parametrize("reweight", [False, True])
def test_flash_matches_pallas(att_type, square_plus, reweight):
    gx, pt = make_graphs(seed=3)
    d = 6
    gcfg, cfg = _cfgs(hidden_dim=d, attention_type=att_type,
                      square_plus=square_plus, reweight_attention=reweight)
    p, att = random_attention(gcfg, cfg, d)
    x = np.random.RandomState(2).randn(gx.num_nodes, d).astype(np.float32)
    want = fused_attention_ax_pallas(gcfg, p, gx.tiles, jnp.asarray(x),
                                     edge_weight=gx.edge_weight)
    with torch.no_grad():
        got = fa.flash_attention_ax(cfg, att, pt, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    assert np.all(got[-4:].numpy() == 0)          # rows with no edge


@pytest.mark.parametrize("att_type,square_plus", [
    ("scaled_dot", False), ("pearson", False), ("exp_kernel", True)])
def test_flash_bf16_tracks_pallas(att_type, square_plus):
    gx, pt = make_graphs(seed=4)
    d = 6
    gcfg, cfg = _cfgs(hidden_dim=d, attention_type=att_type,
                      square_plus=square_plus, reweight_attention=True)
    p, att = random_attention(gcfg, cfg, d, seed=5)
    x = np.random.RandomState(6).randn(gx.num_nodes, d).astype(np.float32)
    want = fused_attention_ax_pallas(gcfg, p, gx.tiles,
                                     jnp.asarray(x).astype(jnp.bfloat16),
                                     edge_weight=gx.edge_weight)
    with torch.no_grad():
        got = fa.flash_attention_ax(cfg, att, pt,
                                    torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("att_type", ATT_TYPES)
@pytest.mark.parametrize("reweight", [False, True])
def test_gmax_matches_pallas(att_type, reweight):
    gx, pt = make_graphs(seed=7)
    d = 5
    gcfg, cfg = _cfgs(hidden_dim=d, attention_type=att_type, square_plus=True,
                      reweight_attention=reweight)
    p, att = random_attention(gcfg, cfg, d, seed=8)
    x = np.random.RandomState(9).randn(gx.num_nodes, d).astype(np.float32)
    t = gx.tiles
    q_tiles, xg, wk, bk, wb, scal = _prep_inputs(
        gcfg, p, jnp.asarray(x), jnp.asarray(x), gx.edge_weight,
        t.edge_slot, t.slot_mask, t.col, t.num_tiles, t.tile)
    want = _gmax_call(att_type, reweight, gcfg.heads, q_tiles, xg, wk, bk, wb,
                      t.local_row, t.tile_idx, scal, t.num_tiles, t.tile)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        ops = fa.prep_inputs(cfg, att, pt, xt)
        kt = fa.attention_kproj(xt, ops["wk"], ops["bk"])
        got = fa.attention_gmax(pt.csr, ops["q"], kt, ops["edge_w"],
                                att_type, cfg.heads, ops["ov2"],
                                ops["inv2l2"])
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), **F32)


def test_gmax_of_a_graph_without_edges_is_zero():
    pt = Graph.from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64), 5,
                          edge_buffer_size=3)
    q = torch.randn(5, 4)
    got = fa.attention_gmax(pt.csr, q, torch.randn(5, 4), None, "scaled_dot",
                            2)
    assert float(got) == 0.0
    out = fa.flash_attention(pt.csr, q, torch.randn(5, 3), torch.randn(5, 4),
                             None, None, "scaled_dot", 2)
    assert torch.equal(out, torch.zeros(5, 3))


def test_kproj_matches_the_projection_graphax_gathers():
    rng = np.random.RandomState(10)
    x = rng.randn(17, 9).astype(np.float32)
    wk = rng.randn(9, 8).astype(np.float32)
    bk = rng.randn(8).astype(np.float32)
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                         (torch.bfloat16, jnp.bfloat16, 1e-5)):
        got = fa.attention_kproj(torch.from_numpy(x).to(dt),
                                 torch.from_numpy(wk).to(dt),
                                 torch.from_numpy(bk))
        want = jax.lax.dot_general(
            jnp.asarray(x).astype(jdt), jnp.asarray(wk).astype(jdt),
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32) + jnp.asarray(bk)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=tol,
                                   atol=tol)


# ----------------------------------------------------------------------
# the plain per-edge path
# ----------------------------------------------------------------------

@pytest.mark.parametrize("att_type", ATT_TYPES)
@pytest.mark.parametrize("square_plus", [False, True])
@pytest.mark.parametrize("norm_idx", [0, 1])
def test_attention_apply_matches_graphax(att_type, square_plus, norm_idx):
    gx, pt = make_graphs(seed=11)
    d = 6
    for reweight in (False, True):
        gcfg, cfg = _cfgs(hidden_dim=d, attention_type=att_type,
                          square_plus=square_plus, attention_norm_idx=norm_idx,
                          reweight_attention=reweight)
        p, att = random_attention(gcfg, cfg, d, seed=12)
        x = np.random.RandomState(13).randn(gx.num_nodes, d) \
            .astype(np.float32)
        want, (wv, wprods) = gx_attention_apply(p, gcfg, gx, jnp.asarray(x))
        want_ax = gx_multiply_attention(p, gcfg, gx, jnp.asarray(x), want, wv)
        xt = torch.from_numpy(x)
        with torch.no_grad():
            got, (v, prods) = transformer_attention_apply(att, cfg, pt, xt)
            got_ax = multiply_attention(att, cfg, pt, xt, got, v)
        e = pt.num_edges
        np.testing.assert_allclose(prods[:e].numpy(), _np(wprods)[:e], **F32)
        np.testing.assert_allclose(got.numpy(), _np(want), **F32)
        np.testing.assert_allclose(v.numpy(), _np(wv), **F32)
        np.testing.assert_allclose(got_ax.numpy(), _np(want_ax), **F32)
        assert np.all(got[e:].numpy() == 0)


# ----------------------------------------------------------------------
# the RHS and the slice
# ----------------------------------------------------------------------

@pytest.mark.parametrize("att_type,square_plus,add_source", [
    ("scaled_dot", False, False), ("scaled_dot", False, True),
    ("cosine_sim", True, True)])
def test_rhs_matches_graphax_fast_route(monkeypatch, att_type, square_plus,
                                        add_source):
    """graphax's RHS under an eval fstate with FORCE (its Pallas flash,
    interpreted) against the port's."""
    monkeypatch.setattr(pallas_tiled, "FORCE", True)
    gx, pt = make_graphs(seed=14)
    d = 6
    gcfg, cfg = _cfgs(hidden_dim=d, attention_type=att_type,
                      square_plus=square_plus, add_source=add_source)
    f = gx_get_function(gcfg, d)
    params = f.init(jax.random.PRNGKey(1))
    params["att"], _ = random_attention(gcfg, cfg, d, seed=15)
    params["alpha_train"] = jnp.asarray(0.4)
    params["beta_train"] = jnp.asarray(-0.3)
    x = np.random.RandomState(16).randn(gx.num_nodes, d).astype(np.float32)
    fs = gx_make_fstate(gx, jnp.asarray(x), train=False, cfg=gcfg)
    assert fs.fast_attention
    want = f.rhs(gx_prepare_scalars(params, gcfg, jnp.float32), fs, 0.0,
                 jnp.asarray(x))

    func = get_function(cfg, d)
    load_graphax_params(func, jax.tree_util.tree_map(np.asarray, params))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        fst = make_fstate(pt, xt, train=False)
        assert fst.fast_attention
        alpha, beta = prepare_scalars(func, cfg, xt.dtype)
        got = func.rhs(alpha, beta, fst, 0.0, xt)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


SLICE = dict(dataset="sbm", block="constant", function="transformer",
             hidden_dim=16, heads=2, attention_dim=8,
             attention_type="scaled_dot", method="dopri5",
             tol_scale=11353.558848254957, time=3.6760155951687636,
             batch_norm=True, input_dropout=0.0, dropout=0.0, max_nfe=500,
             no_early=True)


def eval_both(dtype: str, **over):
    kw = dict(SLICE, dtype=dtype, **over)
    gcfg, cfg = GxConfig(**kw), Config(**kw)
    gdata = gx_make_sbm(num_nodes=400, num_classes=4, num_features=32, seed=0)
    graph = dataclasses.replace(attach_tiles(gdata.graph), strategy="tiled")
    model = make_gnn(gcfg, gdata.num_features, gdata.num_classes)
    params, state = model.init(jax.random.PRNGKey(3))
    params["block"]["func"]["att"], _ = random_attention(
        gcfg, cfg, model.state_dim, seed=17)
    params["block"]["func"]["alpha_train"] = jnp.asarray(0.7)
    logits, _, aux = model.apply(params, state, graph, gdata.x, train=False)

    data = make_sbm_dataset(num_nodes=400, num_classes=4, num_features=32,
                            seed=0, strategy="sparse", device="cpu")
    net = GNN(cfg, data.num_features, data.num_classes)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    load_graphax_params(net, to_np(params), to_np(state))
    net.eval()
    with torch.no_grad():
        got, out = net(data.graph, data.x, train=False)
    return got.numpy(), _np(logits), out.result, aux


def test_f32_eval_logits_and_nfe_match():
    got, want, res, aux = eval_both("float32")
    assert res.success and bool(aux["success"])
    assert res.nfe == int(aux["nfe"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_f32_eval_squareplus_reweight_matches():
    got, want, res, aux = eval_both("float32", square_plus=True,
                                    reweight_attention=True,
                                    attention_type="cosine_sim",
                                    add_source=True)
    assert res.nfe == int(aux["nfe"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bf16_eval_tracks_graphax():
    got, want, res, aux = eval_both("bfloat16")
    assert res.success
    assert abs(res.nfe - int(aux["nfe"])) <= 6, (res.nfe, aux["nfe"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)


def test_eval_launch_count_is_the_nfe(monkeypatch):
    """One flash evaluation per solver NFE (the card's counter counts the
    same calls)."""
    calls = []
    real = fa.flash_attention

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(fa, "flash_attention", counting)
    data = make_sbm_dataset(num_nodes=120, num_features=8, seed=2,
                            strategy="sparse", device="cpu")
    cfg = Config(**dict(SLICE, hidden_dim=8))
    net = GNN(cfg, data.num_features, data.num_classes)
    net.reset_parameters(torch.Generator().manual_seed(0))
    net.eval()
    with torch.no_grad():
        _, out = net(data.graph, data.x, train=False)
    assert len(calls) == out.result.nfe > 0


# ----------------------------------------------------------------------
# what raises
# ----------------------------------------------------------------------

def _small_trainer(**over):
    data = make_sbm_dataset(num_nodes=60, num_classes=3, num_features=8,
                            seed=1, strategy="sparse", device="cpu")
    cfg = Config(**dict(SLICE, hidden_dim=8, **over))
    return Trainer(cfg, data, device="cpu")


@pytest.mark.parametrize("adjoint", [False, True])
def test_training_raises(adjoint):
    tr = _small_trainer(adjoint=adjoint, adjoint_method="rk4")
    assert all(0.0 <= a <= 1.0 for a in tr.evaluate())
    with pytest.raises(NotImplementedError, match="Queue 2b"):
        tr.train_step()


@pytest.mark.parametrize("over,err", [
    (dict(attention_norm_idx=1), "column normalisation"),
    (dict(community_window=16), "K5"),
])
def test_unported_eval_routes_raise(over, err):
    tr = _small_trainer(**over)
    with pytest.raises(NotImplementedError, match=err):
        tr.evaluate()


@pytest.mark.parametrize("over", [dict(mix_features=True),
                                  dict(multi_modal=True)])
def test_unported_transformer_options_raise(over):
    with pytest.raises(NotImplementedError, match="M6"):
        _small_trainer(**over)


def test_transplant_carries_the_transformer_tree():
    gcfg, cfg = _cfgs(hidden_dim=6, attention_type="exp_kernel")
    f = gx_get_function(gcfg, 6)
    params = f.init(jax.random.PRNGKey(2))
    params["att"], _ = random_attention(gcfg, cfg, 6, seed=18)
    tree = jax.tree_util.tree_map(np.asarray, params)
    func = get_function(cfg, 6)
    load_graphax_params(func, tree)
    np.testing.assert_array_equal(func.att.K.weight.detach().numpy(),
                                  tree["att"]["K"]["w"].T)
    assert float(func.att.output_var.detach()) == pytest.approx(1.3)
    assert set(func.state_dict()) == {
        "alpha_train", "beta_train", "att.output_var", "att.lengthscale",
        *(f"att.{m}.{k}" for m in ("Q", "K", "V", "Wout")
          for k in ("weight", "bias"))}
    del tree["att"]["lengthscale"]
    with pytest.raises(KeyError, match="missing"):
        load_graphax_params(func, tree)
    tree["att"]["lengthscale"] = np.ones(())
    tree["att"]["extra"] = np.ones(())
    with pytest.raises(KeyError, match="extra"):
        load_graphax_params(func, tree)
