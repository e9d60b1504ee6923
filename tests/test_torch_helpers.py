"""The helpers no training path of the port calls yet, each against
graphax's function on the same numpy inputs on the CPU: `segment_mean`
and `attention_spmm` (`graphax/sparse/ops.py`), `remove_self_loops` and
`dense_to_edges` (`graphax/sparse/build.py`), and
`rewiring.deepwalk.pick_best_embeddings`. Tolerances: the host-built edge
lists are equal; the f32 segment means and products agree to 1e-6
relative plus 1e-6 absolute (sums in another order)."""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphax.rewiring.deepwalk import pick_best_embeddings as gx_pick
from graphax.sparse import build as gx_build
from graphax.sparse import ops as gx_ops

from graphax_torch.rewiring import pick_best_embeddings
from graphax_torch.sparse import build, ops

RTOL = ATOL = 1e-6


def _edges(n=29, e=140, seed=0, isolated=4):
    rng = np.random.RandomState(seed)
    row = rng.randint(0, n - isolated, e)
    col = rng.randint(0, n - isolated, e)
    row[:8], col[:8] = np.arange(8), np.arange(8)     # self loops
    return row, col, rng.rand(e) + 0.1


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("width", [None, 3])
def test_segment_mean(masked, width):
    n = 29
    row, _, _ = _edges(n)
    rng = np.random.RandomState(1)
    shape = (len(row),) if width is None else (len(row), width)
    data = rng.randn(*shape).astype(np.float32)
    mask = rng.rand(len(row)) < 0.7 if masked else None
    want = gx_ops.segment_mean(jnp.asarray(data), jnp.asarray(row), n,
                               None if mask is None else jnp.asarray(mask))
    got = ops.segment_mean(torch.from_numpy(data), torch.from_numpy(row), n,
                           None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert got.shape == tuple(np.asarray(want).shape)


@pytest.mark.parametrize("masked", [False, True])
def test_attention_spmm(masked):
    n, h, d = 29, 3, 5
    row, col, _ = _edges(n)
    rng = np.random.RandomState(2)
    att = rng.rand(len(row), h).astype(np.float32)
    x = rng.randn(n, d).astype(np.float32)
    mask = rng.rand(len(row)) < 0.8 if masked else None
    want = gx_ops.attention_spmm(
        jnp.asarray(row), jnp.asarray(col), jnp.asarray(att), jnp.asarray(x),
        n, None if mask is None else jnp.asarray(mask))
    got = ops.attention_spmm(
        torch.from_numpy(row), torch.from_numpy(col), torch.from_numpy(att),
        torch.from_numpy(x), n,
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_remove_self_loops(weighted):
    row, col, w = _edges()
    w = w if weighted else None
    for got, want in zip(build.remove_self_loops(row, col, w),
                         gx_build.remove_self_loops(row, col, w)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.int64, bool])
def test_dense_to_edges(dtype):
    rng = np.random.RandomState(3)
    adj = (rng.rand(11, 11) * (rng.rand(11, 11) < 0.3) * 4).astype(dtype)
    for got, want in zip(build.dense_to_edges(adj),
                         gx_build.dense_to_edges(adj)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _write_candidates(root, cands):
    pos = os.path.join(root, "pos_encodings")
    os.makedirs(pos, exist_ok=True)
    for tag, acc in cands:
        with open(os.path.join(pos, f"Cora_DW16_{tag}.pkl"), "wb") as f:
            pickle.dump({"data": np.ones((4, 16)) * acc, "acc": acc}, f)


def test_pick_best_embeddings(tmp_path):
    """graphax's case (`tests/test_data_extras.py:100-108`): of two
    candidates the one of accuracy 0.9 becomes the canonical pickle, in
    both packages, each in its own cache directory; a dataset without
    candidates gives None."""
    picked = []
    for name, pick in (("port", pick_best_embeddings), ("graphax", gx_pick)):
        root = str(tmp_path / name)
        _write_candidates(root, (("a", 0.3), ("b", 0.9)))
        path = pick(root, "Cora", 16)
        assert path is not None and os.path.exists(path)
        with open(path, "rb") as f:
            obj = pickle.load(f)
        assert obj["acc"] == 0.9 and np.allclose(obj["data"], 0.9)
        picked.append((os.path.relpath(path, root), os.readlink(path)))
        assert pick(root, "Citeseer", 16) is None
    assert picked[0] == picked[1] == (
        os.path.join("pos_encodings", "Cora_DW16.pkl"), "Cora_DW16_b.pkl")


def test_pick_best_embeddings_replaces_the_link(tmp_path):
    """A better candidate written later takes over the canonical link, in
    both packages alike; a missing cache directory gives None."""
    links = []
    for name, pick in (("port", pick_best_embeddings), ("graphax", gx_pick)):
        root = str(tmp_path / name)
        assert pick(root, "Cora", 16) is None
        _write_candidates(root, (("a", 0.3),))
        first = os.readlink(pick(root, "Cora", 16))
        _write_candidates(root, (("c", 0.95),))
        links.append((first, os.readlink(pick(root, "Cora", 16))))
    assert links[0] == links[1] == ("Cora_DW16_a.pkl", "Cora_DW16_c.pkl")
