"""The redesigned win_bwd_dense and attention_kproj, on the CPU.

- win_bwd_dense's plain route with an output dtype against graphax's
  `_win_bwd_dense_call` (Pallas, interpret mode) followed by ``.astype``,
  bit for bit, on a ragged layout (N off the tile, the last window past
  N). The inputs are small integers in bf16, so every f32 sum is exact in
  any order and the one rounding to the output dtype is the only one:
  both sides must give the same bits.
- attention_kproj's gate and routes: `kproj_fits` (the gate of every
  route that needs the K table) holds for the widths of every preset and
  of graphax's attention tests, and the bf16 ones take the tensor-core
  kernel; shapes that gate admits and the tensor-core kernel's shared
  memory does not take go to the CUDA-core kernel.
- the wrappers name how they stage a misaligned view.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from graphax.kernels import pallas_windows
from graphax_torch.kernels import fused_attention as fa
from graphax_torch.kernels import windowed_spmm as ws
from graphax_torch.kernels.dispatch import attach_windows
from graphax_torch.sparse.graph import Graph
from graphax_torch.train import BEST_PARAMS, best_config


def _ragged_layout(n=203, window=16, tile=8, seed=0):
    """Community-like edges; N = 203 is off the tile (8) and the window
    (16), so the last tile and the last window's slab run past N."""
    rng = np.random.RandomState(seed)
    e = 6 * n
    row = rng.randint(0, n, e)
    col = np.clip(row // window * window + rng.randint(0, window, e), 0,
                  n - 1)
    key = np.unique(row * n + col)
    g = Graph.from_edges(key // n, key % n, n,
                         edge_weight=rng.rand(len(key)).astype(np.float32),
                         edge_buffer_size=len(key) + 5, device="cpu")
    return attach_windows(g, window=window, tile=tile).windows


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [5, 162])
def test_win_bwd_dense_plain_matches_graphax_bitwise(out_dtype, d):
    wl = _ragged_layout()
    n = wl.num_nodes
    assert n % wl.tile and wl.num_windows * wl.window > n
    rng = np.random.RandomState(d)
    # integers in [-8, 8]: exact in bf16, products and f32 sums exact
    g = rng.randint(-8, 9, (n, d)).astype(np.float32)
    x = rng.randint(-8, 9, (n, d)).astype(np.float32)
    got = ws.win_bwd_dense(wl, torch.from_numpy(g).to(torch.bfloat16),
                           torch.from_numpy(x).to(torch.bfloat16),
                           getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    assert tuple(got.shape) == wl.block_shape

    t, tile, w, wn = wl.num_tiles, wl.tile, wl.window, wl.num_windows
    gp = jnp.pad(jnp.asarray(g, jnp.bfloat16), ((0, t * tile - n), (0, 0)))
    slab = pallas_windows._slab(jnp.asarray(x, jnp.bfloat16), wn, w)
    want = pallas_windows._win_bwd_dense_call(
        gp.reshape(t, tile, d), slab,
        jnp.asarray(wl.tile_win.numpy(), jnp.int32))
    want = np.asarray(want.astype(getattr(jnp, out_dtype)).astype(
        jnp.float32))
    assert np.array_equal(got.float().numpy(), want)
    # the rounding to bf16 is hit: some sums are not bf16 values
    if out_dtype == "bfloat16" and d == 162:
        exact = ws.win_bwd_dense(wl, torch.from_numpy(g), torch.from_numpy(x))
        assert not torch.equal(exact, got.float())


def _widths():
    """(D, A) of every preset (D the state width GRAND-nl's attention
    reads: hidden_dim) and of graphax's attention tests."""
    out = {(best_config(ds).hidden_dim, best_config(ds).attention_dim)
           for ds in BEST_PARAMS}
    for d in (4, 8, 16, 32, 64):
        for a in (4, 8, 16, 128):
            out.add((d, a))
    return sorted(out)


@pytest.mark.parametrize("d,a", _widths())
def test_kproj_fits_and_takes_the_tensor_cores_at_every_width(d, a):
    assert fa.kproj_fits(d, a)
    assert fa.kproj_route(torch.bfloat16, d, a) == "tensor_core"
    assert fa.kproj_route(torch.float32, d, a) == "cuda_core"


def test_kproj_route_wide_rows():
    # widest rows the gate admits with one key: one tile of x does not fit
    # the tensor-core kernel's shared memory there, so the CUDA-core
    # kernel takes them
    d = fa._SMEM_LIMIT // (4 * 33)
    assert fa.kproj_fits(d, 1) and not fa.kproj_fits(d + 1, 1)
    assert fa.kproj_route(torch.bfloat16, d, 1) == "cuda_core"
    # every width the gate admits has a kernel whose shared memory fits
    for d in range(1, 2000, 37):
        for a in (1, 12, 32, 64, 130, 512):
            if fa.kproj_fits(d, a):
                assert (fa.kproj_route(torch.bfloat16, d, a) == "cuda_core"
                        or fa._kproj_tc_smem(d, a) <= fa._SMEM_LIMIT)


def test_wrappers_name_the_staging_of_a_misaligned_view():
    base = torch.zeros(11, 162, dtype=torch.bfloat16)
    assert base.data_ptr() % 16 == 0
    assert fa.kproj_staging(base) == "cp.async"
    assert fa.kproj_staging(base[1:]) == "elements"     # 324 bytes in
    assert fa.kproj_staging(torch.zeros(8, 7, dtype=torch.bfloat16)) \
        == "elements"
    assert ws.bwd_dense_staging(base, base) == "cp.async"
    assert ws.bwd_dense_staging(base, base[1:]) == "elements"
    assert ws.bwd_dense_staging(base[1:], base) == "elements"
