"""The early-stop evaluation in the port against graphax, on the CPU.

- The solver's Observer: the carry and NFE of an observer that counts the
  accepted steps, keeps the largest time and sums a time-weighted norm of
  the state equal graphax's under dopri5, rk4 and adaptive_heun, with and
  without a cap on the adaptive loop's attempts (mirrors
  tests/test_ode_solvers.py): counts and NFE exactly, times 1e-6 and the
  norm sum 1e-5 relative (f32 rounding of the same steps).
- `evaluate_early_stop` on a small SBM (graphax's make_sbm_dataset, the
  dense strategy in both packages), constant and hard-attention blocks,
  the same three methods, weights transplanted with `load_graphax_params`:
  logits 1e-4 absolute (f32 through ~100 NFE), the best accuracies equal,
  the best time 1e-4 relative (dopri5's step sizes, stated at the test),
  NFE equal.
- `Trainer.fit`: the keys of ``best`` and ``history`` equal graphax's for
  the same call (checkpoints: tests/test_torch_labels_checkpoint.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.data.synthetic import make_sbm_dataset as gx_make_sbm
from graphax.ode import Observer as GxObserver
from graphax.ode import odeint as gx_odeint
from graphax.train import Config as GxConfig
from graphax.train.loop import Trainer as GxTrainer

from graphax_torch import Trainer, make_sbm_dataset
from graphax_torch.ode import Observer, odeint
from graphax_torch.train import Config
from graphax_torch.utils.transplant import load_graphax_params

METHODS = ["dopri5", "rk4", "adaptive_heun"]
SBM = dict(num_nodes=200, num_classes=4, num_features=16, seed=3)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("max_steps", [None, 5])
def test_observer_carry_and_nfe_match_graphax(method, max_steps):
    y0 = np.random.RandomState(0).randn(6).astype(np.float32)
    # tolerances where dopri5's error estimate stands well above f32
    # rounding (ROADMAP Queue 3, the controller at the noise floor), so
    # both packages accept the same steps at the same times to f32 rounding
    kw = dict(method=method, rtol=1e-2, atol=1e-3, step_size=0.25,
              max_steps=max_steps)

    def gx_rhs(t, y):
        return -4.0 * y + 2.0 * jnp.sin(2.0 * t) * y[::-1]

    gx_obs = GxObserver(
        init={"count": jnp.asarray(0), "max_t": jnp.asarray(0.0),
              "norm": jnp.asarray(0.0)},
        update=lambda c, t, y: {"count": c["count"] + 1,
                                "max_t": jnp.maximum(c["max_t"], t),
                                "norm": c["norm"] + t * jnp.sum(y * y)})
    want = gx_odeint(gx_rhs, jnp.asarray(y0), 0.0, 2.0, observer=gx_obs,
                     differentiable=False, **kw)

    def rhs(t, y):
        return -4.0 * y + 2.0 * torch.sin(2.0 * t) * y.flip(0)

    obs = Observer(
        init={"count": 0, "max_t": torch.tensor(0.0),
              "norm": torch.tensor(0.0)},
        update=lambda c, t, y: {"count": c["count"] + 1,
                                "max_t": torch.maximum(c["max_t"], t),
                                "norm": c["norm"] + t * torch.sum(y * y)})
    got = odeint(rhs, torch.as_tensor(y0), 0.0, 2.0, observer=obs, **kw)
    assert got.nfe == int(want.nfe)
    assert got.steps == int(want.steps)
    assert got.observer["count"] == int(want.observer["count"])
    np.testing.assert_allclose(float(got.observer["max_t"]),
                               float(want.observer["max_t"]), rtol=1e-6)
    np.testing.assert_allclose(float(got.observer["norm"]),
                               float(want.observer["norm"]), rtol=1e-5)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), rtol=1e-5,
                               atol=1e-6)
    if max_steps is not None and method != "rk4":
        assert not got.success and got.steps <= max_steps


def test_observer_sees_monotone_time():
    obs = Observer(init={"count": 0, "max_t": torch.tensor(0.0)},
                   update=lambda c, t, y: {
                       "count": c["count"] + 1,
                       "max_t": torch.maximum(c["max_t"], t)})
    res = odeint(lambda t, y: -y, torch.ones(2), 0.0, 1.0, method="rk4",
                 step_size=0.25, observer=obs)
    assert res.observer["count"] == 4
    np.testing.assert_allclose(float(res.observer["max_t"]), 1.0, rtol=1e-6)


def _pair(block, method, **over):
    """graphax's Trainer and state, and the port's Trainer loaded from the
    same weights (random Q/K in the hard block's attention layer)."""
    kw = dict(dataset="sbm", block=block, function="laplacian",
              hidden_dim=16, heads=2, attention_dim=8, att_samp_pct=0.8,
              method=method, step_size=0.5, tol_scale=1e4, time=2.0,
              earlystopxT=3.0, max_test_steps=40, input_dropout=0.0,
              dropout=0.0, add_source=True, max_nfe=2000)
    kw.update(over)
    gtr = GxTrainer(GxConfig(**kw), gx_make_sbm(**SBM))
    state = gtr.init_state()
    params = state.params
    if block == "hard_attention":
        rng = np.random.RandomState(7)
        for name in ("Q", "K"):
            w = params["block"]["att_layer"][name]["w"]
            params["block"]["att_layer"][name]["w"] = jnp.asarray(
                0.4 * rng.randn(*w.shape), jnp.float32)
    params["block"]["func"]["alpha_train"] = jnp.asarray(0.3)
    params["block"]["func"]["beta_train"] = jnp.asarray(-0.4)
    state = state._replace(params=params)
    tr = Trainer(Config(**kw), make_sbm_dataset(**SBM, device="cpu"),
                 device="cpu")
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    load_graphax_params(tr.model, to_np(state.params),
                        to_np(state.model_state))
    return gtr, state, tr


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("block", ["constant", "hard_attention"])
def test_evaluate_early_stop_matches_graphax(block, method):
    gtr, state, tr = _pair(block, method)
    assert tr.data.graph.strategy == gtr.data.graph.strategy == "dense"
    want = gtr.evaluate_early(state)
    got = tr.evaluate_early()
    assert got.nfe == int(want.nfe)
    assert got.nfe > (12 if method == "rk4" else 20)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=1e-4, rtol=0)
    for k in ("best_train", "best_val", "best_test"):
        assert float(getattr(got, k)) == float(getattr(want, k)), k
    # the accepted times: dopri5's error estimate cancels across its seven
    # stages, so its step sizes carry the f32 rounding of the pin (the
    # kernel's order against graphax's XLA) at up to 1e-4 (6e-5 seen)
    np.testing.assert_allclose(float(got.best_time), float(want.best_time),
                               rtol=1e-4)
    assert 0.0 <= float(got.best_time) <= 6.0 + 1e-6
    assert got.result is tr.last_eval


@pytest.mark.parametrize("use_early_stop", [False, True])
def test_fit_keys_match_graphax(use_early_stop):
    gtr, _, tr = _pair("constant", "dopri5", epoch=2)
    want = gtr.fit(epochs=2, use_early_stop=use_early_stop, seed=1)
    got = tr.fit(epochs=2, use_early_stop=use_early_stop, seed=1)
    assert set(got["best"]) == set(want["best"])
    assert [set(h) for h in got["history"]] == \
        [set(h) for h in want["history"]]
    if not use_early_stop and got["best"]["epoch"]:
        assert got["best"]["best_time"] == tr.cfg.time
    assert [s["eval_nfe"] > 0 and s["success"] for s in got["solver"]] == \
        [True, True]

