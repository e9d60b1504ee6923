"""The multimodal family in the port against graphax, on the CPU: the
cross-modal attention in each diffusion function and route, and the
`MultimodalGNN` (one sample, and batches on a shared grid and on
per-sample chain graphs, through the one-solve route or per-sample
solves), with transplanted weights. graphax's own oracles of
tests/test_batched_graphs.py are re-run against the port.

Tolerances: the RHS and its vjp 1e-5 relative plus 1e-6 (f32 products in
another order); logits and states 1e-5 relative plus 1e-6 (graphax's own
for its batched graphs, tests/test_batched_graphs.py:77-80), with each
sample's NFE equal to graphax's vmapped ``aux["nfe"]``; the union against
per-sample solves of the port itself the same."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from graphax.blocks.common import make_fstate as gx_make_fstate
from graphax.blocks.common import normalize_graph as gx_normalize
from graphax.data.multimodal import \
    batched_chain_graphs as gx_batched_chains
from graphax.data.multimodal import \
    build_clevr_style_dataset as gx_build_clevr
from graphax.functions import get_function as gx_get_function
from graphax.functions.common import cross_modal_apply as gx_cross
from graphax.functions.common import cross_modal_init
from graphax.functions.common import prepare_scalars as gx_prepare_scalars
from graphax.models import make_multimodal_gnn
from graphax.sparse import build as gx_build
from graphax.train import Config as GxConfig

from graphax_torch.blocks.common import make_fstate, normalize_graph
from graphax_torch.data.grids import grid_edge_index
from graphax_torch.data.multimodal import (
    GraphBatch, batched_chain_graphs, build_clevr_style_dataset,
)
from graphax_torch.functions import get_function
from graphax_torch.functions.common import (
    CrossModal, cross_modal_apply, prepare_scalars,
)
from graphax_torch.functions.transformer import attention_route
from graphax_torch.kernels import spmm as spmm_mod
from graphax_torch.models.multimodal import MultimodalGNN, one_solve
from graphax_torch.sparse.build import build_graph
from graphax_torch.train import Config
from graphax_torch.train.optimizers import get_optimizer
from graphax_torch.utils.transplant import load_graphax_params

TOL = dict(rtol=1e-5, atol=1e-6)
MAX_LEN, FEAT, CLASSES, TEXT, TOKENS = 8, 6, 4, 5, 3
to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread (the suite runs six workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomize(tree, rng, scale=0.3):
    """Random weights for every ``w`` of the cross-attention, Q/K and
    GAT's ``a`` (graphax's constant 1e-5 init makes attention uniform)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            if "w" in v and k in ("Q", "K", "Qx", "Kx", "Qp", "Kp", "Q2",
                                  "K2", "V2"):
                v["w"] = jnp.asarray(scale * rng.randn(*v["w"].shape),
                                     jnp.float32)
            else:
                _randomize(v, rng, scale)
        elif k == "a":
            tree[k] = jnp.asarray(rng.randn(*v.shape), jnp.float32)


def _edges(n, e, seed):
    rng = np.random.RandomState(seed)
    row, col = rng.randint(0, n, e), rng.randint(0, n, e)
    keep = row != col
    return np.r_[row[keep], col[keep]], np.r_[col[keep], row[keep]]


# ----------------------------------------------------------------------
# the cross-modal attention


def test_cross_modal_apply_matches_graphax_and_batches():
    """One sample against graphax's; a batch ``[B, N, D]`` and a union
    ``[B N, D]`` against each sample alone."""
    n, d, m, d2, b = 7, 6, 4, 5, 3
    p = jax.jit(cross_modal_init, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), d, d2)
    _randomize({"c": p}, np.random.RandomState(1))
    cross = CrossModal(d, d2)
    load_graphax_params(cross, to_np(p))
    rng = np.random.RandomState(2)
    x = rng.randn(b, n, d).astype(np.float32)
    y = rng.randn(b, m, d2).astype(np.float32)
    with torch.no_grad():
        one = cross_modal_apply(cross, torch.from_numpy(x[0]),
                                torch.from_numpy(y[0]))
        batch = cross_modal_apply(cross, torch.from_numpy(x),
                                  torch.from_numpy(y))
        union = cross_modal_apply(cross, torch.from_numpy(x.reshape(-1, d)),
                                  torch.from_numpy(y))
    np.testing.assert_allclose(one.numpy(), np.asarray(gx_cross(
        p, jnp.asarray(x[0]), jnp.asarray(y[0]))), **TOL)
    for i in range(b):
        with torch.no_grad():
            alone = cross_modal_apply(cross, torch.from_numpy(x[i]),
                                      torch.from_numpy(y[i]))
        np.testing.assert_allclose(batch[i].numpy(), alone.numpy(), **TOL)
        np.testing.assert_allclose(union.reshape(b, n, d)[i].numpy(),
                                   alone.numpy(), **TOL)


# (function, strategy, extra config, the port's transformer route)
FUNCTION_CASES = {
    "laplacian_dense": ("laplacian", "dense", {}, None),
    "laplacian_csr": ("laplacian", "sparse", {}, None),
    "transformer_edge": ("transformer", "sparse", {}, "edge"),
    "transformer_dense": ("transformer", "dense", {}, "dense"),
    "transformer_dense_mix": ("transformer", "dense",
                              dict(mix_features=True), "dense"),
    "beltrami_split": ("transformer", "sparse",
                       dict(beltrami=True, attention_type="exp_kernel",
                            feat_hidden_dim=4, pos_enc_hidden_dim=3,
                            pos_enc_dim=3), "edge"),
    "gat": ("GAT", "sparse", {}, None),
}


@pytest.mark.parametrize("case", sorted(FUNCTION_CASES))
def test_function_rhs_with_second_modality(case):
    """Each function's RHS with ``y`` (and its vjp with respect to the
    state and the cross-attention's Q2 and K2) against graphax's, on its
    route: the Laplacian on a dense and a CSR graph, GRAND-nl per edge,
    dense (``dense_rhs_ax``: q and k from the cross-attention, the values
    x) with and without mix_features, Beltrami's ``cross``/``cross_p``
    split, GAT."""
    function, strategy, extra, route = FUNCTION_CASES[case]
    n, d, m = 12, 7, 4
    kw = dict(function=function, multi_modal=True, second_modality_dim=TEXT,
              heads=2, attention_dim=4, add_source=True,
              self_loop_weight=1.0, **extra)
    gcfg, cfg = GxConfig(**kw), Config(**kw)
    row, col = _edges(n, 30, 3)
    gx_g = gx_normalize(gcfg, gx_build.build_graph(
        row, col, n, self_loop_weight=1.0,
        strategy="dense" if strategy == "dense" else "edge"))
    pt_g = normalize_graph(cfg, build_graph(
        row, col, n, self_loop_weight=1.0, strategy=strategy, device="cpu"))
    f = gx_get_function(gcfg, d)
    params = jax.jit(f.init)(jax.random.PRNGKey(4))
    _randomize(params, np.random.RandomState(5))
    params["alpha_train"], params["beta_train"] = (jnp.float32(0.3),
                                                   jnp.float32(-0.4))
    func = get_function(cfg, d)
    load_graphax_params(func, to_np(params))
    if route is not None:
        assert attention_route(cfg, pt_g, d) == route
    rng = np.random.RandomState(6)
    x = rng.randn(n, d).astype(np.float32)
    y = rng.randn(m, TEXT).astype(np.float32)
    cot = rng.randn(n, d).astype(np.float32)

    def gx_rhs(p, xx):
        fs = gx_make_fstate(gx_g, jnp.asarray(x), y=jnp.asarray(y),
                            train=False, cfg=gcfg)
        return f.rhs(gx_prepare_scalars(p, gcfg, jnp.float32), fs, 0.0, xx)

    want, vjp = jax.vjp(jax.jit(gx_rhs), params, jnp.asarray(x))
    gp, gxx = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    fs = make_fstate(pt_g, torch.from_numpy(x), train=False, cfg=cfg,
                     y=torch.from_numpy(y))
    alpha, beta = prepare_scalars(func, cfg, torch.float32)
    got = func.rhs(alpha, beta, fs, 0.0, xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    cross = func.cross if function == "laplacian" else func.att.cross
    gcross = gp["cross"] if function == "laplacian" \
        else gp["att"]["cross"]
    grads = torch.autograd.grad(got, (xt, cross.Q2.weight, cross.K2.weight),
                                torch.from_numpy(cot))
    for g, w in zip(grads, (gxx, gcross["Q2"]["w"].T, gcross["K2"]["w"].T)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# ----------------------------------------------------------------------
# the model


def _models(kw, num_nodes, seed=0):
    gcfg, cfg = GxConfig(**kw), Config(**kw)
    gm = make_multimodal_gnn(gcfg, num_nodes=num_nodes, num_features=FEAT,
                             num_classes=CLASSES)
    params = jax.jit(gm.init)(jax.random.PRNGKey(seed))
    _randomize(params, np.random.RandomState(seed + 10))
    model = MultimodalGNN(cfg, num_nodes, FEAT, CLASSES)
    load_graphax_params(model, to_np(params))
    return gm, params, model


def _features(lengths, seed=0, n=MAX_LEN):
    rng = np.random.RandomState(seed)
    xs = rng.randn(len(lengths), n, FEAT).astype(np.float32)
    for i, ln in enumerate(lengths):
        xs[i, ln:] = 0.0
    return xs


def _base(**kw):
    base = dict(block="constant", function="laplacian", method="rk4",
                step_size=0.5, time=1.0, self_loop_weight=1.0,
                input_dropout=0.0, dropout=0.0, heads=2, attention_dim=4)
    base.update(kw)
    return base


class _Calls:
    """Counts calls of a module attribute (the kernels' plain versions
    stand in for their launches on the CPU)."""

    def __init__(self, monkeypatch, module, name):
        self.n = 0
        fn = getattr(module, name)

        def counted(*a, **k):
            self.n += 1
            return fn(*a, **k)

        monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("block,function,method,modal", [
    ("constant", "laplacian", "rk4", False),
    ("attention", "laplacian", "rk4", False),
    ("constant", "laplacian", "dopri5", True),
    ("attention", "laplacian", "dopri5", False),
    ("attention", "laplacian", "rk4", True),
    ("constant", "transformer", "rk4", True),
    ("constant", "transformer", "dopri5", False),
    ("constant", "GAT", "dopri5", True)])
def test_per_sample_graphs_match_graphax(monkeypatch, block, function,
                                         method, modal):
    """`forward_batched` on per-sample chain graphs against graphax's
    vmapped ``apply_batched``: logits and each sample's NFE. One solve on
    the block-diagonal union: the RHS (the Laplacian's ``spmm_csr``)
    runs once an evaluation for the whole batch, not once a sample (under
    dopri5 each sample keeps its own controller, so the evaluations are
    the slowest sample's NFE); GAT's and GRAND-nl's row softmax is each
    sample's. The union also against the port's own per-sample
    forwards. GAT's dopri5 runs at ``tol_scale=1000``: at the default
    rtol 1e-9 its third sample's accepts sit on the f32 noise floor,
    where graphax's own vmapped NFE is 44 eager and 56 under jit."""
    lengths = [3, 5, 8]
    kw = _base(block=block, function=function, method=method,
               **(dict(multi_modal=True, second_modality_dim=TEXT)
                  if modal else {}),
               **(dict(tol_scale=1000.0) if function == "GAT" else {}))
    gm, params, model = _models(kw, MAX_LEN)
    xs = _features(lengths, seed=1)
    x2s = np.random.RandomState(2).randn(3, TOKENS, TEXT).astype(
        np.float32) if modal else None
    want, aux = jax.jit(lambda p, g, x, x2: gm.apply_batched(
        p, None, x, graphs=g, x2s=x2))(
            params, gx_batched_chains(lengths, MAX_LEN), jnp.asarray(xs),
            None if x2s is None else jnp.asarray(x2s))
    graphs = batched_chain_graphs(lengths, MAX_LEN, device="cpu")
    assert one_solve(model.cfg, False, False)
    calls = _Calls(monkeypatch, spmm_mod, "spmm_csr_plain")
    evals = []
    rhs = model.block.func.rhs
    model.block.func.rhs = lambda *a: evals.append(1) or rhs(*a)
    x2t = None if x2s is None else torch.from_numpy(x2s)
    with torch.no_grad():
        got, paux = model.forward_batched(None, torch.from_numpy(xs),
                                          graphs=graphs, x2s=x2t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert paux["nfe"] == [int(v) for v in np.asarray(aux["nfe"])]
    assert len(evals) == max(paux["nfe"])
    if function == "laplacian":
        assert calls.n == max(paux["nfe"])
    if method == "rk4":
        assert paux["nfe"] == [4 * 2] * 3
    for i in range(3):
        with torch.no_grad():
            one, _ = model(graphs.sample(i), torch.from_numpy(xs[i]),
                           x2=None if x2t is None else x2t[i])
        np.testing.assert_allclose(got[i].numpy(), one.numpy(), **TOL)


def test_batched_chain_graphs_shapes_and_masks():
    """graphax's oracle (tests/test_batched_graphs.py:42-56) on the port's
    `GraphBatch`, and its arrays equal to graphax's stacked Graph's."""
    lengths = [3, 5, 8]
    graphs = batched_chain_graphs(lengths, MAX_LEN, device="cpu")
    gx = gx_batched_chains(lengths, MAX_LEN)
    assert graphs.row.shape == (3, 2 * (MAX_LEN - 1) + MAX_LEN)
    for name in ("row", "col", "edge_weight", "num_edges"):
        got = getattr(graphs, name)
        got = got.numpy() if torch.is_tensor(got) else got
        np.testing.assert_array_equal(got, np.asarray(getattr(gx, name)))
    for i, ln in enumerate(lengths):
        assert int(graphs.num_edges[i]) == 2 * (ln - 1) + MAX_LEN
        g = graphs.sample(i)
        r = g.row[g.edge_mask].numpy()
        c = g.col[g.edge_mask].numpy()
        off = r != c
        assert off.sum() == 2 * (ln - 1)
        assert r[off].max() < ln and c[off].max() < ln
    u = graphs.union()
    assert (u.num_nodes, u.num_edges, u.strategy) == (
        3 * MAX_LEN, int(graphs.num_edges.sum()), "sparse")


def test_union_matches_single_forwards_and_topology_matters():
    """graphax's oracle (tests/test_batched_graphs.py:59-92) on the port:
    the one-solve union against each sample's forward, and a shorter
    question differs from its full-length counterpart."""
    lengths = [3, 5, 8]
    _, _, model = _models(_base(), MAX_LEN)
    graphs = batched_chain_graphs(lengths, MAX_LEN, device="cpu")
    xs = torch.from_numpy(_features(lengths))
    with torch.no_grad():
        logits_b, _ = model.forward_batched(None, xs, graphs=graphs)
        assert logits_b.shape == (3, CLASSES)
        for i in range(3):
            one, _ = model(graphs.sample(i), xs[i])
            np.testing.assert_allclose(logits_b[i].numpy(), one.numpy(),
                                       **TOL)
        full = batched_chain_graphs([MAX_LEN], MAX_LEN, device="cpu")
        full_logits, _ = model(full.sample(0), xs[0])
    assert not np.allclose(logits_b[0].numpy(), full_logits.numpy(),
                           atol=1e-5)


@pytest.mark.parametrize("method,modal", [("rk4", True), ("dopri5", False),
                                          ("euler", False)])
def test_shared_grid_matches_graphax(method, modal):
    """One dense grid shared by the batch: the ``[B, N, D]`` state against
    one ``[N, N]`` operator (the cross-attention batched; under dopri5 a
    controller per sample); logits and each sample's NFE against graphax's
    vmapped forward."""
    h = 4
    row, col = grid_edge_index(h, h, diagonals=True)
    kw = _base(method=method, self_loop_weight=0.555,
               **(dict(multi_modal=True, second_modality_dim=TEXT)
                  if modal else {}))
    gm, params, model = _models(kw, h * h, seed=3)
    gx_g = gx_build.build_graph(row, col, h * h, self_loop_weight=0.555)
    pt_g = build_graph(row, col, h * h, self_loop_weight=0.555,
                       device="cpu")
    assert pt_g.strategy == gx_g.strategy == "dense"
    rng = np.random.RandomState(4)
    xs = rng.randn(3, h * h, FEAT).astype(np.float32)
    x2s = rng.randn(3, TOKENS, TEXT).astype(np.float32) if modal else None
    want, aux = jax.jit(lambda p, x, x2: gm.apply_batched(
        p, gx_g, x, x2s=x2))(params, jnp.asarray(xs),
                             None if x2s is None else jnp.asarray(x2s))
    with torch.no_grad():
        got, paux = model.forward_batched(
            pt_g, torch.from_numpy(xs),
            x2s=None if x2s is None else torch.from_numpy(x2s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert paux["nfe"] == [int(v) for v in np.asarray(aux["nfe"])]


def test_plot_paths_match_graphax():
    """`forward_plot_path` (successive [0, T] solves) and `forward_plot_t`
    (one trajectory in pieces) against graphax's, with a second
    modality."""
    h = 3
    row, col = grid_edge_index(h, h)
    kw = _base(multi_modal=True, second_modality_dim=TEXT,
               method="dopri5")
    gm, params, model = _models(kw, h * h, seed=5)
    gx_g = gx_build.build_graph(row, col, h * h, self_loop_weight=1.0)
    pt_g = build_graph(row, col, h * h, self_loop_weight=1.0, device="cpu")
    rng = np.random.RandomState(6)
    x = rng.randn(h * h, FEAT).astype(np.float32)
    y = rng.randn(TOKENS, TEXT).astype(np.float32)
    for gx_fn, fn in ((gm.forward_plot_path, model.forward_plot_path),
                      (gm.forward_plot_t, model.forward_plot_t)):
        want = gx_fn(params, gx_g, jnp.asarray(x), 3, x2=jnp.asarray(y))
        got = fn(pt_g, torch.from_numpy(x), 3, x2=torch.from_numpy(y))
        assert got.shape == (4, h * h, FEAT)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_heterogeneous_question_batch_trains_as_graphax():
    """graphax's oracle (tests/test_batched_graphs.py:113-144): a
    CLEVR-style batch of questions of several lengths trains through the
    per-sample chain graphs (the union, one solve a step); here each of the
    five adam steps' losses against graphax's (1e-5 relative)."""
    ds = build_clevr_style_dataset(num_samples=8, grid=4, feat_dim=6,
                                   text_dim=FEAT, max_question_len=MAX_LEN,
                                   num_classes=CLASSES, seed=0,
                                   device="cpu")
    gds = gx_build_clevr(num_samples=8, grid=4, feat_dim=6, text_dim=FEAT,
                         max_question_len=MAX_LEN, num_classes=CLASSES,
                         seed=0)
    assert len(set(ds.question_lengths.tolist())) > 1
    kw = _base(method="euler", step_size=0.25)
    gm, params, model = _models(kw, MAX_LEN, seed=2)
    sel = np.arange(4)
    graphs = ds.text_graphs_for(sel)
    qs, ys = ds.questions[sel], ds.answers[sel] % CLASSES
    tx = optax.adam(0.01)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            logits, _ = gm.apply_batched(p, None, jnp.asarray(qs),
                                         graphs=gds.text_graphs_for(sel))
            logp = jax.nn.log_softmax(logits)
            return -jnp.mean(logp[jnp.arange(len(ys)), ys])

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    from graphax_torch.drivers.run_multi import train_step

    opt = get_optimizer("adam", model.parameters(), 0.01)
    want, got = [], []
    for _ in range(5):
        params, opt_state, loss = step(params, opt_state)
        want.append(float(loss))
        got.append(float(train_step(model, opt, None, torch.from_numpy(qs),
                                    torch.from_numpy(ys), graphs=graphs)))
    assert np.isfinite(got).all() and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_shared_sparse_graph_runs_as_one_union(monkeypatch):
    """A shared graph on the CSR strategy takes the union of B copies: one
    ``spmm_csr`` an evaluation for the batch, each sample as alone."""
    row, col = _edges(10, 25, 7)
    g = build_graph(row, col, 10, self_loop_weight=1.0, strategy="sparse",
                    device="cpu")
    _, _, model = _models(_base(), 10, seed=8)
    xs = torch.from_numpy(np.random.RandomState(9).randn(
        3, 10, FEAT).astype(np.float32))
    calls = _Calls(monkeypatch, spmm_mod, "spmm_csr_plain")
    with torch.no_grad():
        got, aux = model.forward_batched(g, xs)
        assert calls.n == aux["nfe"][0] == 8
        for i in range(3):
            one, _ = model(g, xs[i])
            np.testing.assert_allclose(got[i].numpy(), one.numpy(), **TOL)
    assert isinstance(GraphBatch.repeated(g, 3).union().num_nodes, int)


@pytest.mark.parametrize("case", ["attention_union", "adjoint_grid"])
def test_batched_train_gradients_match_graphax(case):
    """The batch loss's gradient with respect to every parameter against
    ``jax.grad`` of graphax's vmapped loss (1e-4 relative plus 1e-6):
    the attention block trained on the union of per-sample chain graphs
    with a second modality (its pin per edge, differentiable), and the
    constant block on a shared grid under the dopri5 forward and the
    adaptive_heun adjoint (each sample alone; the second modality a leaf
    of the adjoint's state, as in graphax's)."""
    lengths = [4, 8, 6]
    modal = dict(multi_modal=True, second_modality_dim=TEXT)
    if case == "attention_union":
        kw = _base(block="attention", **modal)
        n, gx_g, pt_g = MAX_LEN, None, None
        graphs = batched_chain_graphs(lengths, MAX_LEN, device="cpu")
        gx_graphs = gx_batched_chains(lengths, MAX_LEN)
    else:
        kw = _base(method="dopri5", adjoint=True,
                   adjoint_method="adaptive_heun", tol_scale=100.0,
                   tol_scale_adjoint=100.0, add_source=True, **modal)
        h = 3
        row, col = grid_edge_index(h, h)
        n, graphs, gx_graphs = h * h, None, None
        gx_g = gx_build.build_graph(row, col, n, self_loop_weight=1.0)
        pt_g = build_graph(row, col, n, self_loop_weight=1.0, device="cpu")
    gm, params, model = _models(kw, n, seed=11)
    assert one_solve(model.cfg, True, case != "attention_union") == (
        case == "attention_union")
    rng = np.random.RandomState(12)
    xs = _features(lengths, seed=13, n=n)
    x2s = rng.randn(3, TOKENS, TEXT).astype(np.float32)
    ys = np.array([0, 3, 1])

    def gx_loss(p):
        logits, _ = gm.apply_batched(p, gx_g, jnp.asarray(xs), train=True,
                                     x2s=jnp.asarray(x2s), graphs=gx_graphs)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(logp[jnp.arange(3), ys])

    want, grads = jax.jit(jax.value_and_grad(gx_loss))(params)
    from graphax_torch.drivers.run_multi import batch_loss
    from graphax_torch.utils.transplant import graphax_to_state_dict

    loss = batch_loss(model, pt_g, torch.from_numpy(xs), torch.from_numpy(ys),
                      train=True, x2s=torch.from_numpy(x2s), graphs=graphs)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    want_g = graphax_to_state_dict(to_np(grads))
    for k, p in model.named_parameters():
        g = np.zeros(tuple(p.shape), np.float32) if p.grad is None \
            else p.grad.numpy()
        np.testing.assert_allclose(g, want_g[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("method", ["dopri5", "adaptive_heun", "rk4"])
def test_odeint_per_sample_controllers_match_each_sample_alone(method):
    """`odeint` with ``samples=3`` on three samples whose stiffness differs
    (so their controllers take different steps) against `odeint` on each
    alone:
    states 1e-6 relative, each sample's NFE, accepted steps and success
    equal; the whole solve's evaluations the slowest sample's NFE; a
    budget that stops one sample early stops only that one."""
    from graphax_torch.ode import odeint

    n, d = 5, 3
    rates = torch.tensor([0.5, 4.0, 20.0])
    rng = np.random.RandomState(14)
    y0 = torch.from_numpy(rng.randn(3 * n, d).astype(np.float32))
    w = torch.from_numpy(0.3 * rng.randn(d, d).astype(np.float32))
    evals = []

    def f(t, y, r):
        evals.append(1)
        return -r * y + torch.tanh(y @ w)

    rows = rates.repeat_interleave(n)[:, None]
    kw = dict(method=method, rtol=1e-4, atol=1e-5, step_size=0.1)
    res = odeint(lambda t, y: f(t, y, rows), y0, 0.0, 2.0, samples=3, **kw)
    assert res.nfe == len(evals) == max(res.sample_nfe)
    for i in range(3):
        one = odeint(lambda t, y: f(t, y, rates[i]), y0[i * n:(i + 1) * n],
                     0.0, 2.0, **kw)
        np.testing.assert_allclose(res.y[i * n:(i + 1) * n].numpy(),
                                   one.y.numpy(), rtol=1e-6, atol=1e-7)
        assert (res.sample_nfe[i], res.sample_steps[i],
                res.sample_success[i]) == (one.nfe, one.steps, one.success)
    if method == "rk4":
        return
    assert len(set(res.sample_nfe)) == 3
    budget = sorted(res.sample_nfe)[1]
    cut = odeint(lambda t, y: f(t, y, rows), y0, 0.0, 2.0, samples=3,
                 max_nfe=budget, **kw)
    for i in range(3):
        one = odeint(lambda t, y: f(t, y, rates[i]), y0[i * n:(i + 1) * n],
                     0.0, 2.0, max_nfe=budget, **kw)
        assert (cut.sample_nfe[i], cut.sample_success[i]) == (one.nfe,
                                                              one.success)
        np.testing.assert_allclose(cut.y[i * n:(i + 1) * n].numpy(),
                                   one.y.numpy(), rtol=1e-6, atol=1e-7)
    assert cut.sample_success.count(False) >= 1


def test_batched_solve_refuses_the_adjoint_and_regularisers():
    """A batch in one solve keeps its controller per sample only on the
    plain path: the adjoint (whose backward controller would be the
    batch's) and the regularisers raise there, and `forward_batched`
    sends such configs to per-sample solves, as graphax's vmap."""
    lengths = [3, 8]
    graphs = batched_chain_graphs(lengths, MAX_LEN, device="cpu")
    xs = torch.from_numpy(_features(lengths))
    for over in (dict(adjoint=True), dict(kinetic_energy=0.1)):
        _, _, model = _models(_base(method="dopri5", **over), MAX_LEN)
        assert not one_solve(model.cfg, True, False)
        with pytest.raises(ValueError, match="sample|regulariser"):
            model.block(graphs.union(), xs.reshape(-1, FEAT), train=True,
                        samples=2)
        logits, aux = model.forward_batched(None, xs, graphs=graphs,
                                            train=True)
        assert logits.shape == (2, CLASSES) and len(aux["nfe"]) == 2


@pytest.mark.parametrize("block", ["constant", "attention"])
def test_adjoint_ignores_y_without_multi_modal(block):
    """A second modality handed to a config without ``multi_modal`` is
    unused on the adjoint path too, as in graphax: the Laplacian adjoint
    carries no cross tensors and no y, so the train forward and its
    gradients equal those without y."""
    g = batched_chain_graphs([6], MAX_LEN, device="cpu").sample(0)
    _, _, model = _models(_base(block=block, method="dopri5", adjoint=True,
                                adjoint_method="rk4"), MAX_LEN, seed=3)
    x = torch.from_numpy(_features([6], seed=7)[0])
    y = torch.randn(TOKENS, TEXT, generator=torch.Generator().manual_seed(8))
    outs = []
    for yy in (None, y):
        model.zero_grad(set_to_none=True)
        z = model.block(g, x, train=True, y=yy).z
        z.square().sum().backward()
        outs.append((z.detach(), [p.grad.clone() for p in
                                  model.block.parameters()
                                  if p.grad is not None]))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0, atol=0)
    assert len(outs[1][1]) == len(outs[0][1]) > 0
    for a, b in zip(outs[1][1], outs[0][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
