"""The port's dataset loaders, LCC and splits against graphax's, on the CPU.

- Each parser (Planetoid ``ind.*`` pickles, the shchur npz, OGB's csv.gz
  and its npz cache, the geom-gcn text files) returns graphax's arrays
  bit for bit on the committed 20-node fixtures and on files written
  into ``tmp_path``.
- ``get_dataset(..., synthetic_fallback=False)`` returns graphax's graph
  (row, col, weights, strategy), features, labels, masks and class count
  exactly, with and without the LCC, under ``planetoid_split`` and the
  geom-gcn fixed splits.
- The LCC keeps graphax's nodes (its native union-find and its scipy
  route) on seeded multi-component graphs, on a tie and on one component.
- The fallback: ``DatasetNotAvailable`` with it off, graphax's stand-in
  with it on, and graphax's ``use_lcc`` defaults.
- chip_smoke's writers of the real layouts, at small sizes: both
  packages parse their files to the same arrays, and the LCC keeps the
  nodes the writer says."""

import os
import shutil

import numpy as np
import pytest

from graphax import native as gx_native
from graphax.data import heterophilic as gx_het
from graphax.data import lcc as gx_lcc
from graphax.data import loaders as gx_loaders
from graphax.train import Config as GxConfig

import chip_smoke as cs
from graphax_torch.data import heterophilic, lcc, loaders
from graphax_torch.data.splits import planetoid_split_masks
from graphax_torch.train import Config

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "datasets")


def _assert_same_data(got, want):
    """The port's GraphData equals graphax's exactly."""
    g, w = got.graph, want.graph
    e = g.num_edges
    assert e == int(w.num_edges) and got.num_nodes == want.num_nodes
    assert g.strategy == w.strategy
    assert g.edge_buffer_size == int(w.row.shape[0])
    np.testing.assert_array_equal(g.row.numpy(), np.asarray(w.row))
    np.testing.assert_array_equal(g.col.numpy(), np.asarray(w.col))
    np.testing.assert_array_equal(g.edge_weight.numpy(),
                                  np.asarray(w.edge_weight))
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))
    for m in ("train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(got, m).numpy(),
                                      np.asarray(getattr(want, m)), m)
    assert got.num_classes == want.num_classes


def _assert_same_arrays(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, tuple):
            _assert_same_arrays(a, b)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("name", ["Cora", "Citeseer"])
def test_planetoid_parser_matches_graphax(name):
    _assert_same_arrays(loaders.load_planetoid(name, FIXTURES),
                        gx_loaders.load_planetoid(name, FIXTURES))


@pytest.mark.parametrize("name", ["Computers", "CoauthorCS"])
def test_npz_parser_matches_graphax(name):
    _assert_same_arrays(loaders.load_npz_dataset(name, FIXTURES),
                        gx_loaders.load_npz_dataset(name, FIXTURES))


def test_ogbn_arxiv_csv_gz_and_cache_match_graphax(tmp_path):
    """The csv.gz parse and the cache it writes, on copies of the fixture:
    the port's first parse writes the cache graphax then reads (and the
    other way round), each equal to the other's arrays."""
    for who in ("port", "graphax"):
        shutil.copytree(os.path.join(FIXTURES, "ogbn_arxiv"),
                        tmp_path / who / "ogbn_arxiv")
    want = gx_loaders.load_ogbn_arxiv(str(tmp_path / "graphax"))
    got = loaders.load_ogbn_arxiv(str(tmp_path / "port"))
    _assert_same_arrays(got, want)
    for who in ("port", "graphax"):
        cache = tmp_path / who / "ogbn_arxiv" / loaders.ARXIV_CACHE
        assert cache.exists()
        os.remove(tmp_path / who / "ogbn_arxiv" / "raw" / "edge.csv.gz")
    # each package rereads the other's cache
    _assert_same_arrays(loaders.load_ogbn_arxiv(str(tmp_path / "graphax")),
                        want)
    _assert_same_arrays(gx_loaders.load_ogbn_arxiv(str(tmp_path / "port")),
                        want)


@pytest.mark.parametrize("name", ["Cora", "Citeseer", "Computers",
                                  "CoauthorCS"])
@pytest.mark.parametrize("use_lcc", [None, True, False])
def test_get_dataset_on_fixtures_matches_graphax(name, use_lcc):
    got = loaders.get_dataset(name, data_dir=FIXTURES, use_lcc=use_lcc,
                              synthetic_fallback=False, device="cpu")
    want = gx_loaders.get_dataset(name, data_dir=FIXTURES, use_lcc=use_lcc,
                                  synthetic_fallback=False)
    _assert_same_data(got, want)


def test_get_dataset_ogbn_arxiv_matches_graphax(tmp_path):
    shutil.copytree(os.path.join(FIXTURES, "ogbn_arxiv"),
                    tmp_path / "ogbn_arxiv")
    want = gx_loaders.get_dataset("ogbn-arxiv", data_dir=str(tmp_path),
                                  synthetic_fallback=False)
    # arxiv never takes the LCC, whatever the caller asks
    for kw in ({}, {"use_lcc": True}):
        got = loaders.get_dataset("ogbn-arxiv", data_dir=str(tmp_path),
                                  synthetic_fallback=False, device="cpu",
                                  **kw)
        _assert_same_data(got, want)
    cfg = Config(dataset="ogbn-arxiv", self_loop_weight=0.5)
    _assert_same_data(
        loaders.get_dataset(cfg, data_dir=str(tmp_path),
                            synthetic_fallback=False, device="cpu"),
        gx_loaders.get_dataset(GxConfig(dataset="ogbn-arxiv",
                                        self_loop_weight=0.5),
                               data_dir=str(tmp_path),
                               synthetic_fallback=False))


def _gx_lcc_both_routes(row, col, n, monkeypatch):
    """graphax's LCC through its native union-find and its scipy route."""
    assert gx_native.available()
    native = gx_lcc.largest_connected_component(row, col, n)
    with monkeypatch.context() as m:
        m.setattr(gx_native, "available", lambda: False)
        fallback = gx_lcc.largest_connected_component(row, col, n)
    return native, fallback


def _components(sizes, rng, extra_edges=2):
    """Disjoint random trees (plus a few chords) of the given sizes on
    shuffled node ids."""
    rows, cols, start = [], [], 0
    for s in sizes:
        nodes = np.arange(start, start + s)
        for i in range(1, s):
            rows.append(nodes[i])
            cols.append(nodes[rng.randint(0, i)])
        for _ in range(extra_edges if s > 2 else 0):
            a, b = rng.choice(nodes, 2, replace=False)
            rows.append(a)
            cols.append(b)
        start += s
    perm = rng.permutation(start)
    return (perm[np.asarray(rows, np.int64)],
            perm[np.asarray(cols, np.int64)], start, perm)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lcc_matches_graphax_on_multi_component_graphs(seed, monkeypatch):
    rng = np.random.RandomState(seed)
    sizes = list(rng.randint(1, 30, 12)) + [60]
    row, col, n, _ = _components(sizes, rng)
    got = lcc.largest_connected_component(row, col, n)
    assert len(got[0]) == 60
    for want in _gx_lcc_both_routes(row, col, n, monkeypatch):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lcc_tie_keeps_the_component_of_the_lowest_node(seed, monkeypatch):
    """Two largest components of equal size: graphax's native union-find
    and its scipy route keep the one holding the lowest node id, and so
    does the port."""
    rng = np.random.RandomState(10 + seed)
    row, col, n, perm = _components([25, 7, 25, 3], rng)
    first, second = perm[:25], perm[32:57]
    want_keep = np.sort(first if first.min() < second.min() else second)
    got = lcc.largest_connected_component(row, col, n)
    np.testing.assert_array_equal(got[0], want_keep)
    for want in _gx_lcc_both_routes(row, col, n, monkeypatch):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_lcc_one_component_returns_the_graph_untouched(monkeypatch):
    rng = np.random.RandomState(4)
    row, col, n, _ = _components([40], rng)
    keep, r, c = lcc.largest_connected_component(row, col, n)
    np.testing.assert_array_equal(keep, np.arange(n))
    np.testing.assert_array_equal(r, row)
    np.testing.assert_array_equal(c, col)
    for want in _gx_lcc_both_routes(row, col, n, monkeypatch):
        np.testing.assert_array_equal(want[0], keep)


def _write_geom_gcn(root, name, n, dim, seed, actor=False):
    """The geom-gcn layout of ``name`` under ``root/<name>/raw``: dense
    features, or Actor's lists of nonzero indices, two components so that
    the LCC drops nodes, and 2 fixed splits."""
    rng = np.random.RandomState(seed)
    lname = "film" if name == "Actor" else name
    raw = root / lname / "raw"
    raw.mkdir(parents=True)
    y = rng.randint(0, 5, n)
    y[:5] = np.arange(5)
    lines = ["node_id\tfeature\tlabel"]
    for i in rng.permutation(n):
        if actor:
            feat = ",".join(str(v) for v in sorted(
                rng.choice(dim, rng.randint(1, 5), replace=False)))
        else:
            feat = ",".join(str(int(v)) for v in rng.randint(0, 2, dim))
        lines.append(f"{i}\t{feat}\t{y[i]}")
    (raw / "out1_node_feature_label.txt").write_text("\n".join(lines) + "\n")
    big = n - 6
    edges = [(i, rng.randint(0, i)) for i in range(1, big)]
    edges += [(big + i, big + (i + 1) % 6) for i in range(6)]
    (raw / "out1_graph_edges.txt").write_text(
        "node_id\tnode_id\n" + "".join(f"{a}\t{b}\n" for a, b in edges))
    for k in range(2):
        order = rng.permutation(n)
        masks = [np.isin(np.arange(n), order[a:b]) for a, b in
                 ((0, n // 2), (n // 2, 3 * n // 4), (3 * n // 4, n))]
        np.savez(raw / f"{lname}_split_0.6_0.2_{k}.npz",
                 train_mask=masks[0].astype(np.uint8),
                 val_mask=masks[1].astype(np.uint8),
                 test_mask=masks[2].astype(np.uint8))


@pytest.mark.parametrize("name,actor", [("texas", False), ("Actor", True)])
def test_heterophilic_layouts_and_fixed_splits_match_graphax(tmp_path, name,
                                                             actor):
    _write_geom_gcn(tmp_path, name, 40, 12, 5, actor)
    got = heterophilic.load_heterophilic(name, str(tmp_path))
    _assert_same_arrays(got, gx_het.load_heterophilic(name, str(tmp_path)))
    assert got[2].shape == (40, 12 if not actor else got[2].shape[1])
    if actor:
        assert set(np.unique(got[2])) <= {0.0, 1.0}
    _assert_same_arrays(
        heterophilic.get_fixed_splits(name, str(tmp_path), 1, 40),
        gx_het.get_fixed_splits(name, str(tmp_path), 1, 40))
    assert heterophilic.get_fixed_splits(name, str(tmp_path), 7, 40) is None
    for kw in (dict(geom_gcn_splits=True), dict(geom_gcn_splits=False),
               dict(not_lcc=False, geom_gcn_splits=True)):
        got = loaders.get_dataset(Config(dataset=name, **kw),
                                  data_dir=str(tmp_path),
                                  geom_gcn_split_idx=1,
                                  synthetic_fallback=False, device="cpu")
        want = gx_loaders.get_dataset(GxConfig(dataset=name, **kw),
                                      data_dir=str(tmp_path),
                                      geom_gcn_split_idx=1,
                                      synthetic_fallback=False)
        _assert_same_data(got, want)
        assert got.num_nodes == (40 if kw.get("not_lcc") is False else 34)


def test_planetoid_split_matches_graphax_on_a_fixture():
    from graphax.data.splits import planetoid_split_masks as gx_split

    _, _, _, y, nc = loaders.load_planetoid("Cora", FIXTURES)
    for kw in ({}, dict(num_test=4, num_val=3)):
        _assert_same_arrays(planetoid_split_masks(len(y), nc, y, **kw),
                            gx_split(len(y), nc, y, **kw))
    cfg = dict(dataset="Cora", planetoid_split=True)
    _assert_same_data(
        loaders.get_dataset(Config(**cfg), data_dir=FIXTURES,
                            synthetic_fallback=False, device="cpu"),
        gx_loaders.get_dataset(GxConfig(**cfg), data_dir=FIXTURES,
                               synthetic_fallback=False))


@pytest.mark.parametrize("name", ["Cora", "Photo", "ogbn-arxiv", "cornell",
                                  "unknown"])
def test_missing_files_raise_without_the_fallback(tmp_path, name):
    with pytest.raises(loaders.DatasetNotAvailable):
        loaders.get_dataset(name, data_dir=str(tmp_path),
                            synthetic_fallback=False, device="cpu")
    with pytest.raises(gx_loaders.DatasetNotAvailable):
        gx_loaders.get_dataset(name, data_dir=str(tmp_path),
                               synthetic_fallback=False)


@pytest.mark.parametrize("name", ["Cora", "cornell", "unknown"])
def test_fallback_is_graphax_stand_in(tmp_path, name):
    got = loaders.get_dataset(name, data_dir=str(tmp_path), device="cpu")
    want = gx_loaders.get_dataset(name, data_dir=str(tmp_path))
    _assert_same_data(got, want)


def test_use_lcc_defaults_follow_graphax(tmp_path):
    """By config ``not_lcc`` (True: the LCC), by name all but ogbn-arxiv;
    a Planetoid file with a stray pair shows which was taken."""
    row, col, x, y, keep = cs.sbm_with_strays(60, 50, 3, 8, 0)
    cs.write_planetoid(str(tmp_path), "Cora", row, col, x, y, 3, 10, 1)
    for arg in ("Cora", Config(dataset="Cora"),
                Config(dataset="Cora", not_lcc=False)):
        got = loaders.get_dataset(arg, data_dir=str(tmp_path),
                                  synthetic_fallback=False, device="cpu")
        gx_arg = arg if isinstance(arg, str) else GxConfig(
            dataset="Cora", not_lcc=arg.not_lcc)
        want = gx_loaders.get_dataset(gx_arg, data_dir=str(tmp_path),
                                      synthetic_fallback=False)
        _assert_same_data(got, want)
        lcc_on = isinstance(arg, str) or arg.not_lcc
        assert got.num_nodes == (50 if lcc_on else 60)


@pytest.mark.parametrize("n_total,n_lcc,classes,feats,seed", [
    (300, 260, 4, 16, 0), (120, 111, 7, 9, 3)])
def test_chip_smoke_planetoid_and_npz_writers(tmp_path, n_total, n_lcc,
                                              classes, feats, seed):
    """chip_smoke's full-size recipe at small sizes: both packages parse
    the written Planetoid and shchur files to the same arrays, whose nodes
    and labels are the writer's, and the LCC keeps exactly ``n_lcc``."""
    row, col, x, y, keep = cs.sbm_with_strays(n_total, n_lcc, classes,
                                              feats, seed)
    assert len(keep) == n_lcc and x.shape == (n_total, feats)
    cs.write_planetoid(str(tmp_path), "Cora", row, col, x, y, classes,
                       n_total // 3, seed + 1)
    cs.write_shchur_npz(str(tmp_path), "Computers", row, col, x, y)
    for name, parse, gx_parse in (
            ("Cora", loaders.load_planetoid, gx_loaders.load_planetoid),
            ("Computers", loaders.load_npz_dataset,
             gx_loaders.load_npz_dataset)):
        got = parse(name, str(tmp_path))
        _assert_same_arrays(got, gx_parse(name, str(tmp_path)))
        np.testing.assert_array_equal(got[2], x)
        np.testing.assert_array_equal(got[3], y)
        k, _, _ = lcc.largest_connected_component(got[0], got[1], n_total)
        np.testing.assert_array_equal(k, keep)
        data = loaders.get_dataset(name, data_dir=str(tmp_path),
                                   synthetic_fallback=False, device="cpu")
        _assert_same_data(data, gx_loaders.get_dataset(
            name, data_dir=str(tmp_path), synthetic_fallback=False))
        assert data.num_nodes == n_lcc


def test_chip_smoke_arxiv_cache_writer(tmp_path):
    row, col, x, y, _ = cs.sbm_with_strays(500, 500, 5, 6, 2)
    cs.write_arxiv_cache(str(tmp_path), row, col, x, y, (300, 80, 120), 3)
    got = loaders.load_ogbn_arxiv(str(tmp_path))
    _assert_same_arrays(got, gx_loaders.load_ogbn_arxiv(str(tmp_path)))
    masks = got[5]
    assert [int(m.sum()) for m in masks] == [300, 80, 120]
    assert not np.any(masks[0] & masks[1]) and not np.any(masks[1] & masks[2])
    data = loaders.get_dataset("ogbn-arxiv", data_dir=str(tmp_path),
                               synthetic_fallback=False, device="cpu")
    assert data.num_nodes == 500
    np.testing.assert_array_equal(data.train_mask.numpy(), masks[0])
