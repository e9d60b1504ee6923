"""Structural checks of the port: what it imports, where it runs, and what it
refuses."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import graphax_torch
from graphax_torch import Trainer, best_config, build_graph, get_dataset
from graphax_torch.data import make_sbm_dataset
from graphax_torch.models import GNN
from graphax_torch.train import Config
from graphax_torch.utils.transplant import load_graphax_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "graphax")
PORT_FILES = sorted((ROOT / "graphax_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_graphax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_every_module_has_a_reference_module():
    for path in (ROOT / "graphax_torch").rglob("*.py"):
        rel = path.relative_to(ROOT / "graphax_torch")
        if rel.name.startswith("_") and rel.name != "__init__.py":
            continue
        if rel.parts[0] == "kernels" or rel.parts == ("utils", "device.py") \
                or rel.parts == ("utils", "transplant.py"):
            continue            # kernels and port-only helpers
        assert (ROOT / "graphax" / rel).exists(), rel


def _small_data(device="cpu"):
    return make_sbm_dataset(num_nodes=60, num_classes=3, num_features=8,
                            seed=1, strategy="sparse", device=device)


def _cuda_absent():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")


def test_trainer_defaults_to_the_card():
    _cuda_absent()
    data = _small_data()
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(Config(block="constant", no_early=True), data)


def test_graph_and_data_entry_points_default_to_the_card():
    _cuda_absent()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_graph(np.array([0, 1]), np.array([1, 0]), 30_000)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_sbm_dataset(num_nodes=60, strategy="sparse")


@pytest.mark.parametrize("overrides,err", [
    (dict(multi_modal=True), "M9"),
    (dict(function="transformer", beltrami=True, attention_type="exp_kernel",
          multi_modal=True, pos_enc_dim=4, feat_hidden_dim=4,
          pos_enc_hidden_dim=4), "M9"),
])
def test_unported_configs_raise(overrides, err):
    """The two configs once refused here (``err``: ROADMAP's M9, the
    multimodal family) now build and train a step as graphax's Trainer
    does with no second modality (y=None): the cross-attention's tensors
    exist and stay unused, their gradient zero. One SGD step at lr 1 from
    transplanted weights (graphax's parameter change is its gradient):
    the loss 1e-5 relative, every gradient 1e-4 relative plus 1e-6,
    forward NFE equal."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from graphax.data.synthetic import make_sbm_dataset as gx_make_sbm
    from graphax.train import Config as GxConfig
    from graphax.train.loop import Trainer as GxTrainer
    from graphax_torch.utils.transplant import graphax_to_state_dict

    assert err == "M9" and overrides["multi_modal"]
    kw = dict(block="hard_attention", heads=2, attention_dim=8,
              hidden_dim=8, no_early=True, method="rk4", step_size=0.5,
              input_dropout=0.0, dropout=0.0, optimizer="sgd", lr=1.0,
              decay=0.0, add_source=True, **overrides)
    sbm = dict(num_nodes=60, num_classes=3, num_features=8, seed=1)
    gd = gx_make_sbm(**sbm)
    gd = dataclasses.replace(gd, graph=dataclasses.replace(
        gd.graph, strategy="sparse"))
    pd = _small_data()
    if kw.get("beltrami"):
        pos = np.random.RandomState(4).randn(60, 4).astype(np.float32)
        gd, pd = gd.with_pos_encoding(jnp.asarray(pos)), \
            pd.with_pos_encoding(pos)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    gtr = GxTrainer(GxConfig(**kw), gd)
    st = gtr.init_state()
    tr = Trainer(Config(**kw), pd, device="cpu")
    load_graphax_params(tr.model, to_np(st.params), to_np(st.model_state))
    before = graphax_to_state_dict(to_np(st.params), to_np(st.model_state))
    st, gx_loss = gtr.train_step(st)
    loss = tr.train_step()
    after = graphax_to_state_dict(to_np(st.params), to_np(st.model_state))
    np.testing.assert_allclose(loss, float(gx_loss), rtol=1e-5)
    assert tr.fm.get_value() == gtr.fm.get_value()
    cross = [k for k in before if ".cross" in k]
    assert cross
    for k, p in tr.model.named_parameters():
        g = np.zeros(tuple(p.shape), np.float32) if p.grad is None \
            else p.grad.numpy()
        np.testing.assert_allclose(g, before[k] - after[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
        if k in cross:
            assert not np.any(g)


def test_community_window_trains_on_graphax_node_order():
    """The ogbn-arxiv preset as published (community_window=512) builds the
    windowed layout on the CPU as graphax does: the same node order (its
    community_order on the stand-in's edges) and the same in-window edge
    set (its build_window_tiles), with no hub layout."""
    from graphax.kernels.windows import build_window_tiles as gx_build
    from graphax.kernels.windows import community_order as gx_order

    data = get_dataset("ogbn-arxiv", device="cpu")
    tr = Trainer(best_config("ogbn-arxiv"), data, device="cpu")
    g = tr.data.graph
    wl = g.windows
    assert g.strategy == "windowed"
    assert (wl.in_window_edges, wl.num_tiles, wl.num_windows, wl.tile) == \
        (575_621, 1_323, 331, 128)
    e = data.graph.num_edges
    row, col = data.graph.row[:e].numpy(), data.graph.col[:e].numpy()
    inv = np.argsort(gx_order(row, col, data.num_nodes, window=512))
    np.testing.assert_array_equal(tr.data.y.numpy(), data.y.numpy()[inv])
    np.testing.assert_array_equal(tr.data.x.numpy(), data.x.numpy()[inv])
    wt = gx_build(g.row[:e].numpy(), g.col[:e].numpy(), g.num_nodes,
                  tile=128, window=512, hubs=False)
    gx_in = np.asarray(wt.edge_slot)[np.asarray(wt.slot_mask)]
    np.testing.assert_array_equal(np.sort(wl.win_edge.numpy()),
                                  np.sort(gx_in))


def test_early_stop_evaluation_is_not_ported():
    """Once a refusal; the early-stop evaluation is ported now: fit runs it
    by default (no_early False) and integrates to earlystopxT * T."""
    cfg = Config(block="constant", hidden_dim=8)
    tr = Trainer(cfg, _small_data(), device="cpu")
    early = tr.fit(epochs=1)
    plain = tr.fit(epochs=1, use_early_stop=False)
    for fit in (early, plain):
        assert fit["solver"][0]["success"] and fit["solver"][0]["eval_success"]
    assert early["solver"][0]["eval_nfe"] > plain["solver"][0]["eval_nfe"]
    best = plain["best"]
    assert best["best_time"] == (cfg.time if best["epoch"] else 0.0)


def test_get_dataset_refuses_real_files_it_cannot_parse(tmp_path):
    """A raw file that is there but cannot be parsed (an empty edge.csv.gz
    and no other file) raises, as graphax's parser does, rather than
    quietly training on the synthetic stand-in."""
    raw = tmp_path / "ogbn_arxiv" / "raw"
    raw.mkdir(parents=True)
    (raw / "edge.csv.gz").write_bytes(b"")
    with pytest.raises((ValueError, OSError)):
        get_dataset("ogbn-arxiv", data_dir=str(tmp_path), device="cpu")


def test_arxiv_preset_shapes():
    cfg = best_config("ogbn-arxiv", community_window=0)
    assert (cfg.hidden_dim, cfg.heads, cfg.attention_dim, cfg.dtype) == \
        (162, 2, 32, "bfloat16")
    assert cfg.block == "hard_attention" and cfg.adjoint_method == "rk4"
    assert graphax_torch.data.SHAPES["ogbn-arxiv"]["num_nodes"] == 169343


def test_transplant_fails_loudly():
    cfg = Config(block="hard_attention", heads=2, attention_dim=8,
                 hidden_dim=8, batch_norm=True)
    model = GNN(cfg, 8, 3)
    good = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    tree = {}
    for key, val in good.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        leaf = {"weight": "w", "bias": "b"}.get(leaf, leaf) \
            if path and path[-1] not in ("bn_in", "bn_out") else leaf
        node[leaf] = val.T if leaf == "w" else val
    load_graphax_params(model, tree)
    tree["m1"]["extra"] = np.zeros(1)
    with pytest.raises(KeyError, match="extra"):
        load_graphax_params(model, tree)
    del tree["m1"]["extra"]
    del tree["m2"]["b"]
    with pytest.raises(KeyError, match="missing"):
        load_graphax_params(model, tree)
