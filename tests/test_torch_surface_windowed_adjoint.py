"""The windowed strategy under an adaptive adjoint, against graphax.

graphax's adjoint state ravels the windowed operator it builds once per
forward (`graphax/blocks/common.py:71-97`, :143-164): the dense
``[T, tile, W]`` blocks, the blocked residual values and their transpose,
beside the edge weights and any pinned attention. Its adaptive error norm
runs over all of them, so the port integrates the blocks' a_p (their vjp
at every backward NFE is `_WinMatmul`'s ``d_dense`` branch, `win_bwd_dense`)
and counts the rest as zero leaves: the residual tables' padding and
transpose (`WindowLayout.graphax_residual_slots`), the unread edge weights
and pinned attention, and, where the RHS does not read them, the blocks.

graphax runs its windowed kernels as tests/test_torch_windows.py runs them
(FORCE, Pallas in interpret mode). One SGD step under adaptive_heun (here)
and dopri5 (tests/test_torch_surface_windowed_dopri5.py) for the
constant, hard-attention and attention blocks and the transformer
function (with and without the reweight that reads the blocks): loss
rtol 1e-6, forward and backward NFE equal, gradients rtol 1e-4 / atol
1e-6."""

import pytest

from graphax_torch.kernels.windows import tiled_slots

from torch_surface_helpers import (  # noqa: F401 (one_torch_thread)
    WINDOWED_CASES, one_torch_thread, windowed_adaptive_step,
)


@pytest.mark.parametrize("case", sorted(WINDOWED_CASES))
def test_windowed_adaptive_adjoint_equals_graphax(case):
    windowed_adaptive_step(case, "adaptive_heun")


def test_tiled_slots_equal_graphax_block_tables():
    """The residual tables' slots, padding included, as graphax builds
    them (its cost model's block size, at least one block)."""
    from graphax.kernels.dispatch import attach_windows as gx_attach
    from graphax.sparse import Graph as GxGraph

    from graphax_torch.kernels.dispatch import attach_windows
    from graphax_torch.sparse.graph import Graph

    import numpy as np

    rng = np.random.RandomState(0)
    n = 700
    comm = np.arange(n) // 64
    hit = rng.rand(n, n) < np.where(comm[:, None] == comm[None, :], 0.08,
                                    0.01)
    row, col = np.nonzero(hit)
    gx = gx_attach(GxGraph.from_edges(row, col, n), window=64, tile=32,
                   hubs=False)
    pt = attach_windows(Graph.from_edges(row, col, n), window=64, tile=32)
    res, res_t = pt.windows.graphax_residual_slots
    assert res == gx.windows.residual.edge_slot.size
    assert res_t == gx.windows.residual_t.edge_slot.size
    assert tiled_slots(pt.windows.residual, n, 32) == res
