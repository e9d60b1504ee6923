"""The label trick and checkpoints in the port against graphax, on the CPU.

- `add_labels` equals graphax's; `get_label_masks` splits the train mask
  into two disjoint parts from its generator.
- A ``use_labels=True`` train step with the same explicit label mask (both
  packages' `get_label_masks` replaced by one that returns it),
  transplanted weights and dropout 0: the loss within 1e-5 relative and
  the next step's too (the update went through the same labels); the
  plain evaluation's logits within 1e-4 absolute and its accuracies
  equal; the early-stop evaluation's logits within 1e-4, its accuracies
  equal, NFE equal (f32 through the same rk4 steps).
- ``fit(4)`` equals ``fit(2, checkpoint_path=p)`` and then, on a fresh
  Trainer, ``fit(4, checkpoint_path=p)`` bit for bit (losses,
  accuracies, weights, optimizer state), with dropout, batch-norm and the
  label trick on, so the generator's, the statistics' and the optimizer's
  state all have to come back.
- ``checkpoint_every`` saves every k epochs and once at the end with
  ``epoch = epochs``; the ``.npz`` suffix rule is graphax's.
- A checkpoint written by graphax's ``fit(epochs=2, checkpoint_path=p)``,
  loaded by `Trainer.load_graphax_checkpoint`: the port's next two steps
  give graphax's epoch-3 and epoch-4 losses within 1e-5 relative (f32
  rounding of the same step), for adam and for rmsprop with decay (the
  optimizer state, mapped from optax's, acts in the epoch-4 update).
- The leaves of graphax's file are numbered in jax's sorted-key order:
  the port reads a dict that was not inserted sorted right, where
  graphax's own reader without ``like`` swaps its leaves."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphax.data.synthetic import make_sbm_dataset as gx_make_sbm
from graphax.train import Config as GxConfig
from graphax.train import checkpoint as gx_ckpt
from graphax.train import loop as gx_loop
from graphax.train.loop import Trainer as GxTrainer

from graphax_torch import Trainer, make_sbm_dataset
from graphax_torch.train import Config, checkpoint, loop
from graphax_torch.utils.transplant import load_graphax_params

SBM = dict(num_nodes=160, num_classes=4, num_features=12, seed=3)
BASE = dict(dataset="sbm", block="constant", function="laplacian",
            hidden_dim=10, method="rk4", step_size=0.5, time=1.5,
            earlystopxT=2.0, max_test_steps=20, input_dropout=0.0,
            dropout=0.0, add_source=True, batch_norm=True, use_mlp=True,
            no_early=True, optimizer="adam", lr=0.01)

to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)


def _port(**over):
    return Trainer(Config(**{**BASE, **over}),
                   make_sbm_dataset(**SBM, device="cpu"), device="cpu")


def _graphax(**over):
    return GxTrainer(GxConfig(**{**BASE, **over}), gx_make_sbm(**SBM))


def test_add_labels_matches_graphax():
    rng = np.random.RandomState(0)
    feat = rng.randn(30, 5).astype(np.float32)
    labels = rng.randint(0, 4, 30)
    mask = rng.rand(30) < 0.4
    got = loop.add_labels(torch.as_tensor(feat), torch.as_tensor(labels),
                          torch.as_tensor(mask), 4)
    want = gx_loop.add_labels(jnp.asarray(feat), jnp.asarray(labels),
                              jnp.asarray(mask), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rate", [0.0, 0.2196, 0.5, 1.0])
def test_get_label_masks_partition_the_train_mask(rate):
    train = torch.as_tensor(np.random.RandomState(1).rand(5000) < 0.6)
    gen = torch.Generator().manual_seed(4)
    label, pred = loop.get_label_masks(gen, train, rate)
    assert not bool((label & pred).any())
    assert torch.equal(label | pred, train)
    share = float(label.sum()) / float(train.sum())
    assert abs(share - rate) < 0.03
    again = loop.get_label_masks(torch.Generator().manual_seed(4), train,
                                 rate)
    assert torch.equal(again[0], label)


def _label_pair(monkeypatch, **over):
    """graphax's Trainer, state and fixed label mask, and the port's
    Trainer from the same weights, both drawing that mask."""
    kw = dict(use_labels=True, label_rate=0.3, **over)
    gtr = _graphax(**kw)
    state = gtr.init_state()
    if kw.get("block") == "hard_attention":
        # random Q/K: the initial ones give near-uniform attention, whose
        # ties make the kept quantile of edges an arbitrary choice
        params = state.params
        rng = np.random.RandomState(7)
        for name in ("Q", "K"):
            w = params["block"]["att_layer"][name]["w"]
            params["block"]["att_layer"][name]["w"] = jnp.asarray(
                0.4 * rng.randn(*w.shape), jnp.float32)
        state = state._replace(params=params)
    tr = _port(**kw)
    load_graphax_params(tr.model, to_np(state.params),
                        to_np(state.model_state))
    train = np.asarray(gtr.data.train_mask)
    label = train & (np.random.RandomState(9).rand(len(train)) < 0.3)
    assert 0 < label.sum() < train.sum()
    monkeypatch.setattr(gx_loop, "get_label_masks",
                        lambda rng, m, r: (jnp.asarray(label),
                                           jnp.asarray(train & ~label)))
    lt = torch.as_tensor(label)
    monkeypatch.setattr(loop, "get_label_masks",
                        lambda g, m, r: (lt, m & ~lt))
    return gtr, state, tr


@pytest.mark.parametrize("over", [{}, dict(block="hard_attention", heads=2,
                                           attention_dim=8,
                                           att_samp_pct=0.8)])
def test_use_labels_train_step_matches_graphax(monkeypatch, over):
    gtr, state, tr = _label_pair(monkeypatch, **over)
    assert tr.model.state_dim == 10 + 4
    losses = []
    for _ in range(2):
        state, loss, _ = gtr._train_step(state, gtr.data)
        losses.append(float(loss))
    got = [tr.train_step() for _ in range(2)]
    np.testing.assert_allclose(got, losses, rtol=1e-5)

    # the plain evaluation: every train node carries its label
    feat, _ = gtr._prepare_features(None, False)
    want_logits, _, _ = gtr.model.apply(state.params, state.model_state,
                                        gtr.data.graph, feat, train=False)
    d = tr.data
    tr.model.eval()
    with torch.no_grad():
        logits, _ = tr.model(d.graph, tr._prepare_features(False)[0],
                             train=False)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-4, rtol=0)
    assert tr.evaluate() == tuple(float(a) for a in gtr.evaluate(state))

    # the early-stop evaluation
    want = gtr.evaluate_early(state)
    res = tr.evaluate_early()
    assert res.nfe == int(want.nfe)
    np.testing.assert_allclose(res.logits.numpy(), np.asarray(want.logits),
                               atol=1e-4, rtol=0)
    for k in ("best_train", "best_val", "best_test"):
        assert float(getattr(res, k)) == float(getattr(want, k)), k


def test_labels_change_what_the_model_sees():
    """The label columns reach the state: evaluation logits move when the
    train nodes' labels are shuffled (a model without them would not)."""
    tr = _port(use_labels=True)
    tr.fit(epochs=2)
    before = tr.evaluate()
    d = tr.data
    y = d.y.clone()
    y[d.train_mask] = y[d.train_mask].roll(1)
    import dataclasses
    tr.data = dataclasses.replace(d, y=y)
    tr.model.eval()
    with torch.no_grad():
        a, _ = tr.model(d.graph, tr._prepare_features(False)[0], train=False)
        tr.data = d
        b, _ = tr.model(d.graph, tr._prepare_features(False)[0], train=False)
    assert not torch.equal(a, b)
    assert before == tr.evaluate()


def _fit_state(tr):
    return {k: v.clone() for k, v in tr.model.state_dict().items()}


@pytest.mark.parametrize("optimizer", ["adam", "rmsprop", "adagrad"])
def test_resumed_fit_equals_unbroken_fit_bit_for_bit(tmp_path, optimizer):
    over = dict(use_labels=True, dropout=0.3, input_dropout=0.2,
                optimizer=optimizer, decay=0.01)
    straight_tr = _port(**over)
    straight = straight_tr.fit(epochs=4)
    p = str(tmp_path / "run")
    first = _port(**over).fit(epochs=2, checkpoint_path=p)
    assert os.path.exists(p + ".npz")
    resumed_tr = _port(**over)
    resumed = resumed_tr.fit(epochs=4, checkpoint_path=p)
    assert [h["epoch"] for h in resumed["history"]] == [3, 4]
    keys = ("loss", "train_acc", "val_acc", "test_acc", "nfe")
    for h, w in zip(first["history"] + resumed["history"],
                    straight["history"]):
        assert {k: h[k] for k in keys} == {k: w[k] for k in keys}
    assert resumed["best"] == straight["best"]
    a, b = _fit_state(resumed_tr), _fit_state(straight_tr)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for p_a, p_b in zip(resumed_tr.model.parameters(),
                        straight_tr.model.parameters()):
        sa, sb = resumed_tr.optimizer.state[p_a], \
            straight_tr.optimizer.state[p_b]
        assert sa.keys() == sb.keys()
        for k in sa:
            assert (torch.equal(sa[k], sb[k]) if torch.is_tensor(sa[k])
                    else sa[k] == sb[k])
    assert torch.equal(resumed_tr.generator.get_state(),
                       straight_tr.generator.get_state())


def test_checkpoint_every_and_the_final_save(tmp_path, monkeypatch):
    tr = _port()
    saved = []
    real_save = Trainer.save_checkpoint

    def spy(self, path, epoch, best):
        saved.append(epoch)
        return real_save(self, path, epoch, best)

    monkeypatch.setattr(Trainer, "save_checkpoint", spy)
    p = str(tmp_path / "ck.npz")
    tr.fit(epochs=5, checkpoint_path=p, checkpoint_every=2)
    assert saved == [2, 4, 5]
    arrays = checkpoint.load_checkpoint(p)
    assert int(arrays["epoch"]) == 5 and not os.path.exists(p + ".npz")
    assert {k.split("/")[0] for k in arrays} == {
        "model", "optimizer", "generator", "best", "epoch"}
    # resumed past its end: no epoch runs, the final save still happens
    saved.clear()
    fit = _port().fit(epochs=5, checkpoint_path=p, checkpoint_every=2)
    assert fit["history"] == [] and saved == [5]
    # the default: every 10 epochs, and at the end
    saved.clear()
    _port().fit(epochs=3, checkpoint_path=str(tmp_path / "other"))
    assert saved == [3] and os.path.exists(tmp_path / "other.npz")
    assert checkpoint.npz_path("a") == "a.npz"
    assert checkpoint.npz_path("a.npz") == "a.npz"


@pytest.mark.parametrize("optimizer,decay", [("adam", 0.0),
                                             ("rmsprop", 0.004)])
def test_graphax_checkpoint_continues_in_the_port(tmp_path, optimizer,
                                                  decay):
    over = dict(optimizer=optimizer, decay=decay)
    p = str(tmp_path / "gx")
    _graphax(**over).fit(epochs=2, checkpoint_path=p, use_early_stop=False)
    shutil.copy(p + ".npz", tmp_path / "gx_epoch2.npz")
    want = _graphax(**over).fit(epochs=4, checkpoint_path=p,
                                use_early_stop=False)["history"]
    assert [h["epoch"] for h in want] == [3, 4]

    tr = _port(**over)
    info = tr.load_graphax_checkpoint(str(tmp_path / "gx_epoch2"))
    assert info["epoch"] == 2
    assert set(info["best"]) == {"val_acc", "test_acc", "train_acc",
                                 "epoch", "best_time"}
    got = [tr.train_step() for _ in range(2)]
    np.testing.assert_allclose(got, [h["loss"] for h in want], rtol=1e-5)

    # moved into the port's own format, fit resumes from it at epoch 3
    tr2 = _port(**over)
    info = tr2.load_graphax_checkpoint(str(tmp_path / "gx_epoch2.npz"))
    q = tr2.save_checkpoint(str(tmp_path / "port"), info["epoch"],
                            info["best"])
    fit = _port(**over).fit(epochs=4, checkpoint_path=q,
                            use_early_stop=False)
    np.testing.assert_allclose([h["loss"] for h in fit["history"]], got,
                               rtol=0)


def test_graphax_checkpoint_leaves_follow_jax_sorted_keys(tmp_path):
    tree = {"best": {"val_acc": np.float32(0.5), "test_acc": np.float32(0.25),
                     "epoch": np.int32(7)},
            "z": [np.arange(3), (np.ones(2),)], "a": np.float64(-1.0)}
    p = gx_ckpt.save_checkpoint(str(tmp_path / "t"), tree)
    got = checkpoint.load_graphax_checkpoint(p)
    assert float(got["best"]["val_acc"]) == 0.5
    assert float(got["best"]["test_acc"]) == 0.25
    assert int(got["best"]["epoch"]) == 7
    np.testing.assert_array_equal(got["z"][0], np.arange(3))
    assert isinstance(got["z"], list) and isinstance(got["z"][1], tuple)
    assert float(got["a"]) == -1.0
    # graphax's own reader without ``like`` follows the insertion order
    # (ROADMAP Queue 3, graphax side)
    best = {"val_acc": np.float32(0.5), "test_acc": np.float32(0.25),
            "epoch": np.int32(7)}
    p = gx_ckpt.save_checkpoint(str(tmp_path / "b"), {"best": best})
    swapped = gx_ckpt.load_checkpoint(p)["best"]
    assert (float(swapped["val_acc"]), float(swapped["epoch"])) == (7, 0.5)
    got = checkpoint.load_graphax_checkpoint(p)["best"]
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in best.items()}
    with pytest.raises(ValueError, match="not a graphax checkpoint"):
        checkpoint.load_graphax_checkpoint(
            checkpoint.save_checkpoint(str(tmp_path / "mine"),
                                       {"a": np.ones(1)}))
