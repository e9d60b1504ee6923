"""The port's hand-written optimizers against graphax's optax chains.

Both step the same parameters on the same gradients (numpy, from a seed) for
several steps, with and without the coupled weight decay. Tolerance 1e-6
relative: the same f32 formulas, with rsqrt/pow computed by another
library."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from graphax.train.optimizers import get_optimizer as gx_get_optimizer

from graphax_torch.train.optimizers import get_optimizer

SHAPES = [(5, 3), (3,), ()]


@pytest.mark.parametrize("name", ["sgd", "rmsprop", "adagrad", "adam",
                                  "adamax"])
@pytest.mark.parametrize("decay", [0.0, 0.01])
def test_updates_match_optax(name, decay):
    rng = np.random.RandomState(0)
    p0 = [np.asarray(rng.randn(*s), np.float32) for s in SHAPES]
    grads = [[np.asarray(rng.randn(*s) * 10.0 ** rng.randint(-4, 1),
                         np.float32) for s in SHAPES] for _ in range(5)]
    grads[1][2] = np.zeros((), np.float32)      # a zero gradient

    tx = gx_get_optimizer(name, 0.01, decay)
    pj = [jnp.asarray(p) for p in p0]
    st = tx.init(pj)

    pt = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = get_optimizer(name, pt, 0.01, decay)
    for g in grads:
        upd, st = tx.update([jnp.asarray(x) for x in g], st, pj)
        pj = [a + u for a, u in zip(pj, upd)]
        for p, x in zip(pt, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-6, atol=1e-7)


def test_rmsprop_puts_eps_inside_the_root():
    """optax's rmsprop scales by rsqrt(nu + eps); torch.optim.RMSprop by
    1/(sqrt(nu) + eps). At a tiny gradient the two differ."""
    p = torch.nn.Parameter(torch.zeros(1))
    opt = get_optimizer("rmsprop", [p], 1.0)
    g = 1e-5
    p.grad = torch.tensor([g])
    opt.step()
    nu = 0.01 * g * g
    got = float(p.detach())
    np.testing.assert_allclose(got, -g / np.sqrt(nu + 1e-8), rtol=1e-5)
    assert abs(got - (-g / (np.sqrt(nu) + 1e-8))) > 1e-3


def test_missing_gradient_counts_as_zero():
    """Every leaf of a JAX gradient tree exists, so an unused parameter
    still decays under weight decay."""
    p = torch.nn.Parameter(torch.ones(2))
    opt = get_optimizer("sgd", [p], 0.5, weight_decay=0.1)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), [0.95, 0.95], rtol=1e-7)
