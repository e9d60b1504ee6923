"""GAT attention diffusion (``function="GAT"``) in the port against
graphax, on the CPU: the attention invariants of graphax's
tests/test_attention.py, the attention and the GNN forward from
transplanted weights, and one train step (autograd through the steps and
the rk4 adjoint), with ``mix_features`` off and on.

Tolerances: attention and ``W x`` 1e-6 (the same f32 arithmetic); logits
1e-5 absolute with NFE equal; a train step's loss 1e-5 relative and every
parameter's gradient 1e-5 absolute plus 1e-4 relative (f32 sums in another
order through the solve), NFE equal."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.data.synthetic import make_sbm_dataset as gx_make_sbm
from graphax.functions import gat_attention_apply as gx_gat_apply
from graphax.functions import gat_attention_init
from graphax.models.gnn import make_gnn
from graphax.sparse import Graph as GxGraph
from graphax.train import Config as GxConfig
from graphax.train.loop import Trainer as GxTrainer

from graphax_torch import Trainer, make_sbm_dataset
from graphax_torch.functions.gat import GATAttention, gat_attention_apply
from graphax_torch.models import GNN
from graphax_torch.sparse.graph import Graph
from graphax_torch.train import Config
from graphax_torch.utils.transplant import (
    graphax_to_state_dict, load_graphax_params,
)

# graphax's tests/test_attention.py graphs, sorted by (row, col) as the
# port's Graph keeps them
EDGE = np.array([[0, 1, 2, 2], [1, 2, 0, 1]])
EDGE1 = np.array([[0, 0, 1, 1, 2, 2], [1, 2, 0, 2, 0, 1]])
X = np.array([[1., 2.], [3., 2.], [4., 5.]], np.float32)
N = 3
SBM = dict(num_nodes=60, num_classes=3, num_features=8, seed=1, p_in=0.15,
           p_out=0.02)
to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)


def base_cfgs(**kw):
    d = dict(hidden_dim=2, heads=2, attention_dim=4, attention_norm_idx=0,
             leaky_relu_slope=0.2, self_loop_weight=1.0, function="GAT")
    d.update(kw)
    return GxConfig(**d), Config(**d)


def _att(gcfg, cfg, in_dim, seed):
    p = gat_attention_init(jax.random.PRNGKey(seed), gcfg, in_dim)
    att = GATAttention(cfg, in_dim)
    load_graphax_params(att, to_np(p))
    return p, att


def test_gat_attention_invariants():
    """Shapes, per-row sums 1, padding inert."""
    _, cfg = base_cfgs()
    att = GATAttention(cfg, 2)
    att.reset_parameters(torch.Generator().manual_seed(2))
    g = Graph.from_edges(EDGE[0], EDGE[1], N, edge_buffer_size=8)
    with torch.no_grad():
        a, wx = gat_attention_apply(att, cfg, g, torch.from_numpy(X))
    assert a.shape == (8, 2) and wx.shape == (N, 4)
    sums = torch.zeros(N, 2).index_add_(0, g.row, a)
    for s in np.unique(EDGE[0]):
        np.testing.assert_allclose(sums[s].numpy(), np.ones(2), rtol=1e-5)
    assert float(a[4:].abs().max()) == 0.0


def test_gat_symmetric_uniform():
    """Uniform features on a symmetric complete graph give 0.5 each."""
    _, cfg = base_cfgs()
    att = GATAttention(cfg, 2)
    att.reset_parameters(torch.Generator().manual_seed(3))
    g = Graph.from_edges(EDGE1[0], EDGE1[1], N)
    with torch.no_grad():
        a, _ = gat_attention_apply(att, cfg, g, torch.ones(3, 2))
    np.testing.assert_allclose(a.numpy(), 0.5 * np.ones((6, 2)), rtol=1e-5)


def test_gat_init_scales_as_xavier():
    """``W``, ``Wout`` and ``a`` drawn as torch's xavier_normal with gain
    1.414 (``a`` with the fans of its [1, 2dk, 1, 1] shape)."""
    _, cfg = base_cfgs(attention_dim=64, heads=4)
    att = GATAttention(cfg, 200)
    att.reset_parameters(torch.Generator().manual_seed(0))
    for t, fans in ((att.W, 264), (att.Wout, 264), (att.a, 33)):
        want = 1.414 * np.sqrt(2.0 / fans)
        assert abs(float(t.std()) / want - 1) < 0.1, (t.shape, fans)


@pytest.mark.parametrize("norm_idx", [0, 1])
def test_gat_attention_matches_graphax(norm_idx):
    gcfg, cfg = base_cfgs(attention_norm_idx=norm_idx, heads=2,
                          attention_dim=8)
    rng = np.random.RandomState(0)
    n, e = 29, 120
    row, col = rng.randint(0, n - 4, e), rng.randint(0, n - 4, e)
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    gx = GxGraph.from_edges(row, col, n, edge_buffer_size=e + 5)
    pt = Graph.from_edges(row, col, n, edge_buffer_size=e + 5)
    x = rng.randn(n, 6).astype(np.float32)
    p, att = _att(gcfg, cfg, 6, 4)
    want, wwx = gx_gat_apply(p, gcfg, gx, jnp.asarray(x))
    with torch.no_grad():
        got, wx = gat_attention_apply(att, cfg, pt, torch.from_numpy(x))
    np.testing.assert_allclose(wx.numpy(), np.asarray(wwx), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _sbm(strategy):
    gd = gx_make_sbm(**SBM)
    if strategy == "sparse":
        gd = dataclasses.replace(gd, graph=dataclasses.replace(
            gd.graph, strategy="sparse"))
    return gd, make_sbm_dataset(**SBM, strategy=strategy, device="cpu")


@pytest.mark.parametrize("strategy", ["sparse", "auto"])
@pytest.mark.parametrize("mix", [False, True])
def test_gat_forward_matches_graphax(strategy, mix):
    """The GNN with the GAT RHS (its A x through the CSR SpMM, or under
    mix_features each head's product through Wout) on the sparse and the
    dense strategy: logits to 1e-5, NFE equal."""
    over = dict(block="constant", function="GAT", hidden_dim=8, heads=2,
                attention_dim=8, mix_features=mix, method="dopri5", time=1.5,
                input_dropout=0.0, dropout=0.0, add_source=True,
                dtype="float32")
    gd, pd = _sbm(strategy)
    gm = make_gnn(GxConfig(**over), 8, 3)
    params, state = gm.init(jax.random.PRNGKey(0))
    params["block"]["func"]["alpha_train"] = jnp.asarray(0.4)
    model = GNN(Config(**over), 8, 3)
    load_graphax_params(model, to_np(params), to_np(state))
    want, _, aux = gm.apply(params, state, gd.graph, gd.x, train=False)
    model.eval()
    with torch.no_grad():
        got, out = model(pd.graph, pd.x, train=False)
    assert pd.graph.strategy == ("dense" if strategy == "auto" else "sparse")
    assert out.result.nfe == int(aux["nfe"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("adjoint,mix", [(False, False), (True, False),
                                         (True, True)])
def test_gat_train_step_matches_graphax(adjoint, mix):
    """One train step from the same weights (SGD at lr 1: graphax's
    parameter change is its gradient): the loss, forward and backward NFE,
    and every parameter's gradient; under the rk4 adjoint the GAT tensors
    W and a (and Wout under mix_features) in the adjoint state."""
    over = dict(block="constant", function="GAT", hidden_dim=8, heads=2,
                attention_dim=8, mix_features=mix, method="dopri5", time=1.5,
                tol_scale=1000.0, adjoint=adjoint, adjoint_method="rk4",
                adjoint_step_size=0.5, input_dropout=0.0, dropout=0.0,
                batch_norm=False, optimizer="sgd", lr=1.0, decay=0.0,
                add_source=True, no_early=True, dtype="float32")
    gd, pd = _sbm("sparse")
    gtr = GxTrainer(GxConfig(**over), gd)
    st = gtr.init_state()
    st.params["block"]["func"]["alpha_train"] = jnp.asarray(0.4)
    st.params["block"]["func"]["beta_train"] = jnp.asarray(-0.3)
    tr = Trainer(Config(**over), pd, device="cpu")
    load_graphax_params(tr.model, to_np(st.params), to_np(st.model_state))
    before = graphax_to_state_dict(to_np(st.params), to_np(st.model_state))
    st, gx_loss = gtr.train_step(st)
    loss = tr.train_step()
    after = graphax_to_state_dict(to_np(st.params), to_np(st.model_state))
    np.testing.assert_allclose(loss, float(gx_loss), rtol=1e-5)
    assert tr.fm.get_value() == gtr.fm.get_value()
    assert tr.bm.get_value() == gtr.bm.get_value()
    grads = {k: p.grad.numpy() for k, p in tr.model.named_parameters()
             if p.grad is not None}
    assert {"block.func.att.W", "block.func.att.a",
            "block.func.alpha_train"} <= set(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g, before[k] - after[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
