"""The slice end to end: graphax_torch's Trainer against graphax's on a small
ogbn-arxiv-shaped config (hard attention, laplacian, dopri5 forward with the
rk4 continuous adjoint, batch-norm, RMSprop, sparse/tiled strategy) on a
400-node SBM, from transplanted weights, for 3 train steps.

Tolerances (f32): the per-step loss agrees to 1e-5 relative and the forward
NFE is equal; parameters after 3 steps agree to 2e-5 absolute (RMSprop's
first steps move each weight by about lr * sign(g), so a last-bit gradient
difference is all they can amplify); evaluation accuracies are equal.

bf16 state: graphax on the CPU pins attention through its XLA path (f32 q
and k, f32 pin) while the port follows graphax's kernel path (q and Wk in
bf16, pin cast to bf16), so the thresholded edge sets can differ at the
margin: losses agree to 2e-2 relative and the forward NFE within one dopri5
step (6)."""

import dataclasses

import numpy as np
import pytest

import jax

from graphax.data.synthetic import make_sbm_dataset as gx_make_sbm
from graphax.kernels.dispatch import attach_tiles
from graphax.train import Config as GxConfig
from graphax.train.loop import Trainer as GxTrainer

from graphax_torch import Trainer, make_sbm_dataset
from graphax_torch.train import Config
from graphax_torch.utils.transplant import (
    graphax_to_state_dict, load_graphax_params,
)

SLICE = dict(dataset="sbm", block="hard_attention", function="laplacian",
             hidden_dim=16, heads=2, attention_dim=8,
             attention_type="scaled_dot", att_samp_pct=0.8,
             method="dopri5", tol_scale=11353.558848254957, time=3.0,
             adjoint=True, adjoint_method="rk4", adjoint_step_size=1.0,
             batch_norm=True, optimizer="rmsprop", lr=0.005451476553977102,
             decay=0.0, input_dropout=0.0, dropout=0.0, max_nfe=500,
             no_early=True)


def run_both(dtype: str, steps: int = 3):
    gcfg = GxConfig(**SLICE, dtype=dtype)
    cfg = Config(**SLICE, dtype=dtype)
    gdata = gx_make_sbm(num_nodes=400, num_classes=4, num_features=32, seed=0)
    gdata = dataclasses.replace(gdata, graph=dataclasses.replace(
        attach_tiles(gdata.graph), strategy="tiled"))
    gtr = GxTrainer(gcfg, gdata)
    state = gtr.init_state()
    # Q = K = 1e-5 at init makes the pinned attention uniform, so the
    # quantile threshold would sit among exact ties that rounding decides;
    # random Q/K separate the values (as test_training_parity_families does)
    att = state.params["block"]["att_layer"]
    rng = np.random.RandomState(7)
    for name in ("Q", "K"):
        att[name]["w"] = jax.numpy.asarray(
            0.4 * rng.randn(*att[name]["w"].shape), jax.numpy.float32)

    data = make_sbm_dataset(num_nodes=400, num_classes=4, num_features=32,
                            seed=0, strategy="sparse", device="cpu")
    tr = Trainer(cfg, data, device="cpu")
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    load_graphax_params(tr.model, to_np(state.params),
                        to_np(state.model_state))

    out = {"gx_loss": [], "pt_loss": [], "gx_nfe": [], "pt_nfe": [],
           "gx_bwd": [], "pt_bwd": []}
    for _ in range(steps):
        state, loss = gtr.train_step(state)
        out["gx_loss"].append(loss)
        out["gx_nfe"].append(gtr.fm.get_value())
        out["gx_bwd"].append(gtr.bm.get_value())
        out["pt_loss"].append(tr.train_step())
        out["pt_nfe"].append(tr.fm.get_value())
        out["pt_bwd"].append(tr.bm.get_value())
    out["gx_params"] = graphax_to_state_dict(to_np(state.params),
                                             to_np(state.model_state))
    out["pt_params"] = {k: v.float().numpy()
                        for k, v in tr.model.state_dict().items()}
    out["gx_acc"] = gtr.evaluate(state)
    out["pt_acc"] = tr.evaluate()
    return out


@pytest.fixture(scope="module")
def f32_run():
    return run_both("float32")


def test_data_matches_graphax():
    g = gx_make_sbm(num_nodes=400, num_classes=4, num_features=32, seed=0)
    p = make_sbm_dataset(num_nodes=400, num_classes=4, num_features=32,
                         seed=0, strategy="sparse", device="cpu")
    np.testing.assert_array_equal(p.graph.row.numpy(), np.asarray(g.graph.row))
    np.testing.assert_array_equal(p.graph.col.numpy(), np.asarray(g.graph.col))
    np.testing.assert_array_equal(p.x.numpy(), np.asarray(g.x))
    np.testing.assert_array_equal(p.y.numpy(), np.asarray(g.y))
    for a, b in ((p.train_mask, g.train_mask), (p.val_mask, g.val_mask),
                 (p.test_mask, g.test_mask)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_f32_losses_and_nfe_match(f32_run):
    r = f32_run
    np.testing.assert_allclose(r["pt_loss"], r["gx_loss"], rtol=1e-5)
    assert r["pt_nfe"] == r["gx_nfe"]
    assert r["pt_bwd"] == r["gx_bwd"]
    assert r["pt_loss"][-1] < r["pt_loss"][0]


def test_f32_params_after_three_steps_match(f32_run):
    gx, pt = f32_run["gx_params"], f32_run["pt_params"]
    assert set(gx) == set(pt)
    for k in sorted(gx):
        np.testing.assert_allclose(pt[k], gx[k], rtol=1e-5, atol=2e-5,
                                   err_msg=k)


def test_f32_eval_accuracies_match(f32_run):
    np.testing.assert_allclose(f32_run["pt_acc"],
                               [float(a) for a in f32_run["gx_acc"]],
                               atol=1e-6)


def test_bf16_state_tracks_graphax():
    r = run_both("bfloat16")
    np.testing.assert_allclose(r["pt_loss"], r["gx_loss"], rtol=2e-2)
    for a, b in zip(r["pt_nfe"], r["gx_nfe"]):
        assert abs(a - b) <= 6, (r["pt_nfe"], r["gx_nfe"])
    assert r["pt_loss"][-1] < r["pt_loss"][0]
