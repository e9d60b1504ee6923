"""The multimodal family's data in the port against graphax, on the CPU:
the grid and chain graphs, the pixel-grid and CLEVR-style datasets (their
arrays equal to graphax's for the same seed, the HDF5 cache), the real
CLEVR ingestion (graphax's tests/test_clevr_ingestion.py re-run on the
port), the DIGL datasets (tests/test_data_extras.py:78) and the feature
extractors (tests/test_data_extras.py:275-330): ``resnet_trunk`` within
2e-4 of graphax's."""

import json
import os

import numpy as np
import pytest

import torch

from graphax.data import clevr as gx_clevr
from graphax.data import grids as gx_grids
from graphax.data import multimodal as gx_mm
from graphax.data.digl import digl_split as gx_digl_split
from graphax.data.digl import heat_dataset as gx_heat
from graphax.data.digl import ppr_dataset as gx_ppr
from graphax.data.extractors import resnet_trunk as gx_trunk
from graphax.data.synthetic import make_sbm_dataset as gx_make_sbm

from graphax_torch.data import clevr, grids
from graphax_torch.data import multimodal as mm
from graphax_torch.data.digl import digl_split, heat_dataset, ppr_dataset
from graphax_torch.data.extractors import (
    ImageFeatureExtractor, TextFeatureExtractor, load_torch_state_dict,
    resnet_trunk,
)
from graphax_torch.data.synthetic import make_sbm_dataset

h5py = pytest.importorskip("h5py")
PIL = pytest.importorskip("PIL")

from PIL import Image

GRID, FEAT, TEXT, QLEN = 4, 6, 8, 12
QUESTIONS = [
    {"image_index": 0, "question": "What color is the large cube?",
     "answer": "red", "image_filename": "CLEVR_train_000000.png"},
    {"image_index": 0, "question": "How many spheres are there?",
     "answer": "2", "image_filename": "CLEVR_train_000000.png"},
    {"image_index": 1, "question": "Is the cylinder shiny?",
     "answer": "yes", "image_filename": "CLEVR_train_000001.png"},
    {"image_index": 2, "question": "What color is the small sphere?",
     "answer": "blue", "image_filename": "CLEVR_train_000002.png"},
    {"image_index": 3, "question": "How many cubes are red?",
     "answer": "2", "image_filename": "CLEVR_train_000003.png"},
]
KW = dict(grid=GRID, feat_dim=FEAT, text_dim=TEXT, max_question_len=QLEN,
          batch_size=2)


def _edges_of(g):
    e = g.num_edges
    return (np.asarray(g.row)[:e], np.asarray(g.col)[:e],
            np.asarray(g.edge_weight)[:e])


def _same_graph(pt, gx):
    assert pt.num_nodes == gx.num_nodes and pt.num_edges == int(gx.num_edges)
    for a, b in zip(_edges_of(pt), _edges_of(gx)):
        np.testing.assert_array_equal(np.asarray(a), b)


# ----------------------------------------------------------------------
# graphs and datasets


@pytest.mark.parametrize("h,w,diag", [(3, 4, False), (5, 5, True)])
def test_grids_equal_graphax(h, w, diag):
    for a, b in zip(grids.grid_edge_index(h, w, diag),
                    gx_grids.grid_edge_index(h, w, diag)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(grids.chain_edge_index(w), gx_grids.chain_edge_index(w)):
        np.testing.assert_array_equal(a, b)
    imgs = np.random.RandomState(0).rand(2, 4, 4, 3).astype(np.float32)
    np.testing.assert_array_equal(grids.image_to_grid_features(imgs, 2),
                                  gx_grids.image_to_grid_features(imgs, 2))


def test_image_dataset_equals_graphax():
    """The synthetic digits (no MNIST files), the grid graph with its
    diagonals, the batches; the presets and the config split."""
    ds = mm.get_image_dataset("MNIST", data_dir="/nonexistent", size=24,
                              seed=3, device="cpu")
    gx = gx_mm.get_image_dataset("MNIST", data_dir="/nonexistent", size=24,
                                 seed=3)
    np.testing.assert_array_equal(ds.x, gx.x)
    np.testing.assert_array_equal(ds.y, gx.y)
    assert ds.graph.strategy == gx.graph.strategy == "dense"
    _same_graph(ds.graph, gx.graph)
    for (xa, ya), (xb, yb) in zip(ds.batches(4, seed=2),
                                  gx.batches(4, seed=2)):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    cfg, extra = mm.multimodal_config("MNIST", method="euler")
    gcfg, gextra = gx_mm.multimodal_config("MNIST", method="euler")
    assert extra == gextra and cfg.to_dict() == gcfg.to_dict()


def test_mnist_idx_files_are_read(tmp_path):
    import gzip
    import struct

    raw = tmp_path / "MNIST" / "raw"
    raw.mkdir(parents=True)
    imgs = np.random.RandomState(0).randint(0, 255, (5, 28, 28), np.uint8)
    with gzip.open(raw / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + imgs.tobytes())
    with gzip.open(raw / "train-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + bytes([1, 2, 3, 4, 5]))
    ds = mm.get_image_dataset("MNIST", data_dir=str(tmp_path), device="cpu")
    gx = gx_mm.get_image_dataset("MNIST", data_dir=str(tmp_path))
    np.testing.assert_array_equal(ds.x, gx.x)
    assert ds.y.tolist() == [1, 2, 3, 4, 5]


def test_clevr_style_dataset_equals_graphax_and_caches(tmp_path):
    """The arrays (images, questions, answers, question lengths) equal to
    graphax's for the same seed; the HDF5 cache written once and read
    back; the item contract; the per-sample chain graphs of a batch."""
    kw = dict(num_samples=10, grid=3, feat_dim=5, text_dim=4,
              max_question_len=6, num_classes=7, seed=2)
    cache = str(tmp_path / "c.h5")
    ds = mm.build_clevr_style_dataset(cache_path=cache, device="cpu", **kw)
    gx = gx_mm.build_clevr_style_dataset(**kw)
    for name in ("images", "questions", "answers", "question_lengths"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(gx, name))
    _same_graph(ds.image_graph, gx.image_graph)
    _same_graph(ds.text_graph, gx.text_graph)
    again = mm.build_clevr_style_dataset(cache_path=cache, device="cpu",
                                         **dict(kw, seed=9))
    np.testing.assert_array_equal(again.images, ds.images)
    item = ds[3]
    np.testing.assert_array_equal(item["modality_data"][1], ds.questions[3])
    tg = item["modality_graphs"][1]
    gtg = gx[3]["modality_graphs"][1]
    np.testing.assert_array_equal(tg.row.numpy(), np.asarray(gtg.row))
    (xb, qb, yb, sel), (gxb, gqb, gyb, gsel) = next(ds.batches(4, seed=1)), \
        next(gx.batches(4, seed=1))
    np.testing.assert_array_equal(sel, gsel)
    batch = ds.text_graphs_for(sel)
    gbatch = gx.text_graphs_for(sel)
    np.testing.assert_array_equal(batch.num_edges,
                                  np.asarray(gbatch.num_edges))
    np.testing.assert_array_equal(batch.row.numpy(), np.asarray(gbatch.row))


# ----------------------------------------------------------------------
# real CLEVR ingestion (graphax's tests/test_clevr_ingestion.py)


def _stage_mini_clevr(root, split="train", n_img=4):
    img_dir = os.path.join(root, "CLEVR_v1.0", "images", split)
    q_dir = os.path.join(root, "CLEVR_v1.0", "questions")
    os.makedirs(img_dir)
    os.makedirs(q_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(n_img):
        arr = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(
            os.path.join(img_dir, f"CLEVR_{split}_{i:06d}.png"))
    _stage_questions(root, split)


def _stage_questions(root, split, answers=None):
    q_dir = os.path.join(root, "CLEVR_v1.0", "questions")
    os.makedirs(q_dir, exist_ok=True)
    keep = split == "train" if answers is None else answers
    qs = QUESTIONS if keep else [
        {k: v for k, v in q.items() if k != "answer"} for q in QUESTIONS]
    with open(os.path.join(q_dir, f"CLEVR_{split}_questions.json"),
              "w") as f:
        json.dump({"questions": qs}, f)


def test_tokenizer_and_vocabs():
    assert clevr.tokenize("What color is the cube?") == \
        ["what", "color", "is", "the", "cube", "?"]
    vocab = clevr.build_token_vocab(QUESTIONS)
    assert vocab == gx_clevr.build_token_vocab(QUESTIONS)
    assert 0 not in vocab.values()
    assert clevr.build_answer_vocab(QUESTIONS) == ["2", "blue", "red",
                                                    "yes"]


def test_build_and_load_roundtrip_equals_graphax(tmp_path):
    """The port's HDF5 against graphax's (built from the same staged
    split, in another directory): every dataset and attribute equal; the
    build reused; `load_clevr`'s arrays, items and batches."""
    root, gx_root = str(tmp_path / "a"), str(tmp_path / "b")
    _stage_mini_clevr(root)
    _stage_mini_clevr(gx_root)
    path = clevr.build_clevr_hdf5(root, "train", **KW)
    gx_path = gx_clevr.build_clevr_hdf5(gx_root, "train", **KW)
    assert path == clevr.h5_path(root, "train")
    with h5py.File(path, "r") as f, h5py.File(gx_path, "r") as g:
        assert set(f) == set(g)
        for k in f:
            np.testing.assert_array_equal(f[k][:], g[k][:])
        assert dict(f.attrs) == dict(g.attrs)
        assert f["images"].shape == (4, GRID * GRID, FEAT)
        assert list(f["answers"][:]) == [2, 0, 3, 1, 0]
    assert clevr.build_clevr_hdf5(root, "train", **KW) == path
    ds = clevr.load_clevr(root, "train", build_kwargs=KW, device="cpu")
    assert len(ds) == 5 and ds.num_classes == 4
    item0, item1 = ds[0], ds[1]
    np.testing.assert_array_equal(item0["modality_data"][0],
                                  item1["modality_data"][0])
    xb, qb, yb, sel = next(ds.batches(4, seed=0))
    assert xb.shape == (4, GRID * GRID, FEAT) and qb.shape == (4, QLEN, TEXT)


def test_val_split_reuses_train_vocab(tmp_path):
    root = str(tmp_path)
    _stage_mini_clevr(root, "train")
    _stage_mini_clevr(root, "val")
    clevr.build_clevr_hdf5(root, "train", **KW)
    clevr.build_clevr_hdf5(root, "val", **KW)
    with open(clevr.h5_path(root, "train") + ".vocab.json") as f:
        train_voc = json.load(f)
    with h5py.File(clevr.h5_path(root, "val"), "r") as f:
        assert f.attrs["num_classes"] == len(train_voc["answers"])
        assert "answers" not in f


def test_real_clevr_training_epoch(tmp_path):
    from graphax_torch.drivers.run_multi import train_clevr_style

    root = str(tmp_path)
    _stage_mini_clevr(root)
    out = train_clevr_style(epochs=2, batch_size=2, data_dir=root,
                            real_clevr=True, build_kwargs=KW, log=False,
                            device="cpu")
    assert np.isfinite([h["loss"] for h in out["history"]]).all()


def test_getitem_beyond_image_count_and_lazy(tmp_path):
    root = str(tmp_path)
    _stage_mini_clevr(root, n_img=2)   # 5 questions share 2 images
    kw = dict(max_images=2, **KW)
    ds = clevr.load_clevr(root, "train", build_kwargs=kw, device="cpu")
    assert len(ds) == 3
    item_last = ds[len(ds) - 1]
    np.testing.assert_array_equal(
        item_last["modality_data"][0],
        ds.images[int(ds.image_indices[len(ds) - 1])])
    lazy = clevr.load_clevr(root, "train", lazy=True, build_kwargs=kw,
                            device="cpu")
    assert not isinstance(lazy.images, np.ndarray)
    xb_l, qb_l, _, sel_l = next(lazy.batches(3, seed=1))
    xb_e, qb_e, _, sel_e = next(ds.batches(3, seed=1))
    np.testing.assert_array_equal(sel_l, sel_e)
    np.testing.assert_allclose(xb_l, xb_e)
    np.testing.assert_allclose(qb_l, qb_e)
    np.testing.assert_allclose(lazy[len(lazy) - 1]["modality_data"][0],
                               item_last["modality_data"][0])


def test_val_build_without_train_h5_uses_train_vocab(tmp_path):
    import shutil

    root = str(tmp_path)
    _stage_mini_clevr(root, "train")
    _stage_mini_clevr(root, "val")
    clevr.build_clevr_hdf5(root, "val", **KW)
    with h5py.File(clevr.h5_path(root, "val"), "r") as f:
        assert f.attrs["num_classes"] == 4
    shutil.rmtree(os.path.join(root, "CLEVR_v1.0", "questions"))
    os.remove(clevr.h5_path(root, "val"))
    _stage_questions(root, "val", answers=False)
    with pytest.raises(FileNotFoundError, match="train"):
        clevr.build_clevr_hdf5(root, "val", **KW)


def test_empty_image_dir_raises(tmp_path):
    root = str(tmp_path)
    _stage_mini_clevr(root)
    with pytest.raises(FileNotFoundError, match="no .png images"):
        clevr.build_clevr_hdf5(root, "train", max_images=0, **KW)


# ----------------------------------------------------------------------
# DIGL and the extractors


def test_digl_datasets_equal_graphax():
    """graphax's oracle (tests/test_data_extras.py:78) on the port, the
    diffused graphs' edges and weights and the split equal to graphax's."""
    d = make_sbm_dataset(num_nodes=40, seed=0, device="cpu")
    gd = gx_make_sbm(num_nodes=40, seed=0)
    d_ppr, g_ppr = ppr_dataset(d, alpha=0.1, k=6), gx_ppr(gd, alpha=0.1,
                                                           k=6)
    dense = np.zeros((40, 40))
    e = d_ppr.graph.num_edges
    dense[d_ppr.graph.row[:e].numpy(), d_ppr.graph.col[:e].numpy()] = 1
    assert ((dense > 0).sum(axis=0) <= 6).all()
    for pt, gx in ((d_ppr, g_ppr), (heat_dataset(d, t=1.0, k=6),
                                    gx_heat(gd, t=1.0, k=6))):
        assert pt.graph.num_edges > 0
        for a, b in zip(_edges_of(pt.graph), _edges_of(gx.graph)):
            np.testing.assert_allclose(np.asarray(a), b, rtol=1e-6)
    s, gs = digl_split(d, seed=3), gx_digl_split(gd, seed=3)
    assert bool(s.train_mask.sum() > 0)
    for m in ("train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(s, m).numpy(),
                                      np.asarray(getattr(gs, m)))


def _tiny_resnet_state_dict(stages=(1, 1), width=4, seed=0):
    """A torchvision-layout ResNet state dict at toy width (random
    weights, running statistics away from 0 and 1)."""
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[name + ".weight"] = torch.from_numpy(
            (rng.randn(o, i, k, k) / np.sqrt(i * k * k)).astype(np.float32))

    def bn(name, c):
        sd[name + ".weight"] = torch.from_numpy(
            (1 + 0.1 * rng.randn(c)).astype(np.float32))
        sd[name + ".bias"] = torch.from_numpy(
            (0.1 * rng.randn(c)).astype(np.float32))
        sd[name + ".running_mean"] = torch.from_numpy(
            (0.1 * rng.randn(c)).astype(np.float32))
        sd[name + ".running_var"] = torch.from_numpy(
            (1 + 0.1 * rng.rand(c)).astype(np.float32))

    conv("conv1", width, 3, 7)
    bn("bn1", width)
    c_in = width
    for s, blocks in enumerate(stages):
        planes = width * 2 ** s
        for i in range(blocks):
            p = f"layer{s + 1}.{i}"
            conv(p + ".conv1", planes, c_in, 1)
            bn(p + ".bn1", planes)
            conv(p + ".conv2", planes, planes, 3)
            bn(p + ".bn2", planes)
            conv(p + ".conv3", planes * 4, planes, 1)
            bn(p + ".bn3", planes * 4)
            if i == 0:
                conv(p + ".downsample.0", planes * 4, c_in, 1)
                bn(p + ".downsample.1", planes * 4)
            c_in = planes * 4
    return sd


def test_resnet_trunk_matches_graphax(tmp_path):
    """The trunk (NCHW convs, torch padding, BN eps, max-pool) on a random
    toy state dict loaded from a ``.pth``, against graphax's NHWC trunk:
    2e-4."""
    stages = (1, 1)
    sd = _tiny_resnet_state_dict(stages)
    path = str(tmp_path / "resnet101-tiny.pth")
    torch.save(sd, path)
    params = load_torch_state_dict(path)
    x = np.random.RandomState(1).rand(2, 32, 32, 3).astype(np.float32)
    want = np.asarray(gx_trunk(x, params, stages=stages, out_stage=2))
    got = resnet_trunk(torch.from_numpy(x), params, stages=stages,
                       out_stage=2)
    assert got.shape == want.shape == (2, 4, 4, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_extractors_route_and_stand_ins_equal_graphax(tmp_path):
    """The image extractor finds a staged resnet101 ``.pth`` as graphax's
    does (the trunk it then runs is held by the test above); without one,
    both extractors' seeded stand-ins equal graphax's."""
    from graphax.data.extractors import (
        ImageFeatureExtractor as GxImage, TextFeatureExtractor as GxText,
    )

    ck = tmp_path / "checkpoints"
    ck.mkdir()
    torch.save(_tiny_resnet_state_dict(), str(ck / "resnet101-tiny.pth"))
    ex = ImageFeatureExtractor(8, data_dir=str(tmp_path), device="cpu")
    assert ex.using_real_weights and ex.checkpoint == \
        GxImage(8, data_dir=str(tmp_path)).checkpoint
    ex2 = ImageFeatureExtractor(8, seed=0)
    assert not ex2.using_real_weights
    raw = np.random.RandomState(0).rand(3, 14, 14, 3).astype(np.float32)
    out = ex2(raw)
    assert out.shape == (3, 196, 8)
    np.testing.assert_array_equal(out, GxImage(8, seed=0)(raw))
    ids = np.array([[1, 2, 3], [4, 5, 49]])
    a = TextFeatureExtractor(16, vocab_size=50, seed=3)(ids)
    assert a.shape == (2, 3, 16)
    np.testing.assert_array_equal(a, GxText(16, vocab_size=50, seed=3)(ids))
