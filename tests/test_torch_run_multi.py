"""`graphax_torch.drivers.run_multi` on the CPU: graphax's driver oracles
(tests/test_drivers.py:52,62: the MNIST-style run's losses fall, the
CLEVR-style run writes and reads its HDF5 cache), one optimizer step of
each driver's loop against graphax's (rmsprop on the pixel grid, adam on
the CLEVR-style batch with its second modality) at dropout 0 from
transplanted weights, and the command line.

Tolerances: a step's loss 1e-5 relative and its gradients 1e-4 relative
plus 1e-6 (f32 sums in another order); the optimizer's step from
graphax's gradients against optax's 1e-6 relative plus 1e-7 (rmsprop's
and adam's first steps divide a gradient by its own magnitude, so a
gradient that is zero but for rounding, the K2 bias's under a softmax,
takes a full step of its rounding: the port's steps are held on
graphax's gradients)."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from graphax.data.multimodal import build_clevr_style_dataset as gx_clevr
from graphax.data.multimodal import get_image_dataset as gx_images
from graphax.data.multimodal import multimodal_config as gx_config
from graphax.models import make_multimodal_gnn

from graphax_torch.data.multimodal import (
    build_clevr_style_dataset, get_image_dataset, multimodal_config,
)
from graphax_torch.drivers import run_multi
from graphax_torch.models.multimodal import MultimodalGNN
from graphax_torch.train.optimizers import get_optimizer
from graphax_torch.utils.transplant import (
    graphax_to_state_dict, load_graphax_params,
)

to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_multimodal_mnist_style():
    """graphax's oracle (tests/test_drivers.py:52): two epochs on the
    synthetic digits, finite losses that fall."""
    out = run_multi.train_image_dataset(
        "MNIST", epochs=2, batch_size=4, train_size=16, test_size=8,
        log=False, data_dir="/tmp/definitely-missing", device="cpu")
    losses = [h["loss"] for h in out["history"]]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert 0.0 <= out["final_test_acc"] <= 1.0


def test_clevr_style_with_cache(tmp_path):
    """graphax's oracle (tests/test_drivers.py:62): the run writes the
    HDF5 cache, a second run reads it."""
    cache = str(tmp_path / "clevr.h5")
    out = run_multi.train_clevr_style(epochs=2, batch_size=4, num_samples=8,
                                      cache_path=cache, log=False,
                                      device="cpu",
                                      build_kwargs=dict(grid=4, feat_dim=8,
                                                        text_dim=6))
    assert os.path.exists(cache)
    assert np.isfinite([h["loss"] for h in out["history"]]).all()
    out2 = run_multi.train_clevr_style(epochs=1, batch_size=4,
                                       num_samples=8, cache_path=cache,
                                       log=False, device="cpu",
                                       build_kwargs=dict(grid=4))
    assert np.isfinite(out2["history"][0]["loss"])


def _step_against_graphax(gcfg, cfg, num_nodes, feat, classes, tx, opt_name,
                          graph, gx_graph, xb, yb, qb=None):
    """graphax's driver step (`graphax/drivers/run_multi.py:71-81`) and the
    port's `train_step` from the same weights: loss and parameters."""
    gm = make_multimodal_gnn(gcfg, num_nodes=num_nodes, num_features=feat,
                             num_classes=classes)
    params = jax.jit(gm.init)(jax.random.PRNGKey(0))
    cross = params["block"]["func"].get("cross", {})
    rng = np.random.RandomState(2)
    for layer in cross.values():     # off the uniform attention of 1e-5
        layer["w"] = jnp.asarray(0.3 * rng.randn(*layer["w"].shape),
                                 jnp.float32)
    model = MultimodalGNN(cfg, num_nodes, feat, classes)
    load_graphax_params(model, to_np(params))
    opt_state = tx.init(params)

    def loss_fn(p):
        logits, _ = gm.apply_batched(p, gx_graph, jnp.asarray(xb),
                                     train=True, rng=jax.random.PRNGKey(1),
                                     x2s=None if qb is None
                                     else jnp.asarray(qb))
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(logp[jnp.arange(len(yb)), yb])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    updates, _ = tx.update(grads, opt_state)
    after = graphax_to_state_dict(to_np(optax.apply_updates(params,
                                                            updates)))
    want_g = graphax_to_state_dict(to_np(grads))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = get_optimizer(opt_name, model.parameters(), cfg.lr)
    got = run_multi.train_step(
        model, opt, graph, torch.from_numpy(xb), torch.from_numpy(yb),
        torch.Generator().manual_seed(0),
        x2s=None if qb is None else torch.from_numpy(qb))
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-5)
    for k, p in model.named_parameters():
        g = np.zeros(tuple(p.shape), np.float32) if p.grad is None \
            else p.grad.numpy()            # unused (beta without a source)
        np.testing.assert_allclose(g, want_g[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    # the optimizer on graphax's gradients against optax's update
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(before[k])
            p.grad = torch.from_numpy(np.array(want_g[k]))
    get_optimizer(opt_name, model.parameters(), cfg.lr).step()
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), after[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_image_step_matches_graphax():
    """The MNIST preset (euler at 0.25, the 28 x 28 grid with diagonals)
    at dropout 0: one rmsprop step (decay 0.99, eps inside the root)."""
    over = dict(method="euler", step_size=0.25, input_dropout=0.0)
    gcfg, _ = gx_config("MNIST", **over)
    cfg, _ = multimodal_config("MNIST", **over)
    ds = get_image_dataset("MNIST", data_dir="/nonexistent", size=4,
                           self_loop_weight=cfg.self_loop_weight,
                           device="cpu")
    gds = gx_images("MNIST", data_dir="/nonexistent", size=4,
                    self_loop_weight=gcfg.self_loop_weight)
    _step_against_graphax(gcfg, cfg, 784, 1, 10,
                          optax.rmsprop(gcfg.lr, decay=0.99), "rmsprop",
                          ds.graph, gds.graph, ds.x, ds.y)


def test_clevr_step_matches_graphax():
    """`train_clevr_style`'s config at dropout 0 on a CLEVR-style batch
    with its questions as the second modality (the cross-attention's
    weights random, off its uniform init): one adam step."""
    ds = build_clevr_style_dataset(num_samples=4, grid=4, feat_dim=6,
                                   text_dim=5, max_question_len=6,
                                   num_classes=5, device="cpu")
    gds = gx_clevr(num_samples=4, grid=4, feat_dim=6, text_dim=5,
                   max_question_len=6, num_classes=5)
    cfg = run_multi.clevr_config(5).replace(input_dropout=0.0, dropout=0.0)
    from graphax.train.config import Config as GxConfig

    gcfg = GxConfig(**cfg.to_dict())
    _step_against_graphax(gcfg, cfg, 16, 6, 5, optax.adam(cfg.lr), "adam",
                          ds.image_graph, gds.image_graph, ds.images,
                          ds.answers, qb=ds.questions)


def test_main_prints_history_and_refuses_dp(capsys):
    out = run_multi.main(["--im_dataset", "CLEVR", "--epoch", "1",
                          "--train_size", "4", "--device", "cpu",
                          "--data_dir", "/nonexistent"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["history"][0]["epoch"] == 1
    assert len(out["history"]) == 1
    with pytest.raises(NotImplementedError, match="item 12"):
        run_multi.main(["--dp_devices", "2", "--device", "cpu"])
