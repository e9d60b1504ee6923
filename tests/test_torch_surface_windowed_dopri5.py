"""The windowed strategy under the dopri5 adjoint against graphax (the
adaptive_heun half and the zero-leaf accounting:
tests/test_torch_surface_windowed_adjoint.py), and the transformer
reweight's edge weights as a carried adjoint leaf on the CSR and dense
strategies. One SGD step each: loss rtol 1e-6, forward and backward NFE
equal, gradients rtol 1e-4 / atol 1e-6."""

import pytest

from torch_surface_helpers import (  # noqa: F401 (one_torch_thread)
    BASE, WINDOWED_CASES, force, one_torch_thread, step_both,
    windowed_adaptive_step,
)


@pytest.mark.parametrize("case", sorted(WINDOWED_CASES))
def test_windowed_dopri5_adjoint_equals_graphax(case):
    windowed_adaptive_step(case, "dopri5")


@pytest.mark.parametrize("strategy", ["sparse", "dense"])
def test_reweight_adjoint_carries_the_edge_weights(strategy):
    """The transformer's reweight reads the edge weights at every
    evaluation, so their a_p is graphax's on every graph, not zero."""
    kw = dict(BASE, function="transformer", reweight_attention=True,
              method="dopri5", time=2.0, adjoint=True,
              adjoint_method="adaptive_heun")
    with force(False):
        tr = step_both(kw, strategy, qk_scale=0.3)
    assert tr.bm.get_value() > 8
