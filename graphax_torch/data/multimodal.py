"""Multimodal / image-grid datasets and loaders (port of
`graphax/data/multimodal.py`).

Twin of `src/data_multi.py` + the presets in `src/run_multi.py:19-66`:
MNIST/CIFAR pixel-grid diffusion datasets and a CLEVR-style multimodal
dataset (image grid graph + question chain graph + answer labels) with an
HDF5 precompute cache. MNIST parses the standard idx files when present
under ``data_dir`` and falls back to synthetic digits; the CLEVR feature
extractors (ResNet-101 patches, BERT token embeddings,
`src/data_multi.py:201-284`) take staged checkpoints or graphax's seeded
stand-ins (`graphax_torch.data.extractors`). Every array is made by numpy
from the same seeds as graphax's, so the datasets are equal to its.

The per-question chain graphs (the reference's ``[B, 2, E]`` edge lists)
are a :class:`GraphBatch`: one Graph a sample, in one buffer shape, and
their block-diagonal union (`GraphBatch.union`), the graph the batched
model route solves on (`graphax_torch.models.multimodal`)."""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from graphax_torch.data.grids import chain_edge_index, grid_edge_index
from graphax_torch.sparse.build import build_graph
from graphax_torch.sparse.graph import Graph
from graphax_torch.utils.device import resolve_device


# ----------------------------------------------------------------------
# Presets (`run_multi.py:19-66`)
# ----------------------------------------------------------------------

MULTIMODAL_PRESETS = {
    "MNIST": dict(im_width=28, im_height=28, im_chan=1, hidden_dim=1,
                  num_class=10, input_dropout=0.5, dropout=0.0,
                  optimizer="rmsprop", lr=0.0047, decay=5e-4,
                  self_loop_weight=0.555, time=1.0, batch_size=4,
                  train_size=32, test_size=512, diags=True),
    "CIFAR": dict(im_width=32, im_height=32, im_chan=3, hidden_dim=3,
                  num_class=10, input_dropout=0.5, dropout=0.0,
                  optimizer="rmsprop", lr=0.0047, decay=5e-4,
                  self_loop_weight=0.555, time=1.0, batch_size=4,
                  train_size=32, test_size=512, diags=True),
    "CLEVR": dict(grid=14, feat_dim=64, text_dim=32, max_question_len=16,
                  num_class=28, batch_size=4, time=1.0,
                  self_loop_weight=1.0),
}


def multimodal_config(name: str, **overrides):
    """(the port's Config of the preset's Config fields, the rest)."""
    from graphax_torch.train.config import Config

    p = dict(MULTIMODAL_PRESETS[name])
    p.update(overrides)
    cfg_keys = {f.name for f in dataclasses.fields(Config)}
    return (Config(**{k: v for k, v in p.items() if k in cfg_keys}),
            {k: v for k, v in p.items() if k not in cfg_keys})


# ----------------------------------------------------------------------
# Per-sample graphs
# ----------------------------------------------------------------------

class GraphBatch:
    """B graphs of ``num_nodes`` nodes each with edge buffers of one
    capacity: graphax's Graph stacked on a leading batch axis
    (``row``, ``col``, ``edge_weight`` ``[B, E_cap]``, ``num_edges [B]``),
    with each sample's Graph (`sample`) and their block-diagonal union
    (`union`)."""

    def __init__(self, graphs: Sequence[Graph]):
        self.graphs = tuple(graphs)
        g0 = self.graphs[0]
        for g in self.graphs:
            if (g.num_nodes, g.edge_buffer_size) != (g0.num_nodes,
                                                     g0.edge_buffer_size):
                raise ValueError("GraphBatch: the graphs must share their "
                                 "node count and edge capacity")
        self.num_nodes = g0.num_nodes
        self._union = None

    @classmethod
    def repeated(cls, graph: Graph, batch: int) -> "GraphBatch":
        """One shared graph as a batch of ``batch`` samples."""
        return cls((graph,) * batch)

    def __len__(self) -> int:
        return len(self.graphs)

    @property
    def device(self) -> torch.device:
        return self.graphs[0].device

    @property
    def row(self) -> torch.Tensor:
        return torch.stack([g.row for g in self.graphs])

    @property
    def col(self) -> torch.Tensor:
        return torch.stack([g.col for g in self.graphs])

    @property
    def edge_weight(self) -> torch.Tensor:
        return torch.stack([g.edge_weight for g in self.graphs])

    @property
    def num_edges(self) -> np.ndarray:
        return np.array([g.num_edges for g in self.graphs], np.int64)

    def sample(self, i: int) -> Graph:
        return self.graphs[i]

    def union(self) -> Graph:
        """The block-diagonal union on the CSR strategy, built once:
        sample i's nodes are ``i N .. (i + 1) N - 1``, its real edges (the
        buffer's masked prefix) in its order, so the union stays sorted by
        (row, col). A state ``[B, N, D]`` reshaped to ``[B N, D]`` runs
        every sample through one product; each row's edges, and so its
        sums, are its sample's."""
        if self._union is None:
            n = self.num_nodes
            rows, cols, ws = [], [], []
            for i, g in enumerate(self.graphs):
                e = g.num_edges
                rows.append(g.row[:e].cpu().numpy() + i * n)
                cols.append(g.col[:e].cpu().numpy() + i * n)
                ws.append(g.edge_weight[:e].cpu().numpy())
            self._union = dataclasses.replace(Graph.from_edges(
                np.concatenate(rows), np.concatenate(cols), n * len(self),
                np.concatenate(ws), device=self.device), strategy="sparse")
        return self._union


def batched_chain_graphs(lengths, max_len: int,
                         self_loop_weight: float = 1.0,
                         device=None) -> GraphBatch:
    """Per-sample chain graphs in one buffer shape (graphax
    `batched_chain_graphs`): sample s has chain edges over its first
    ``lengths[s]`` tokens and self-loops on ALL ``max_len`` nodes, and
    every sample the capacity ``2 (max_len - 1) + max_len``, its padded
    slots weight 0 past ``num_edges`` (`graphax/data/multimodal.py:
    236-246`). On ``device`` (the card unless asked otherwise)."""
    dev = resolve_device(device)
    lengths = np.atleast_1d(np.asarray(lengths, np.int64))
    graphs = []
    for ln in lengths:
        ln = int(max(min(ln, max_len), 1))
        src, dst = chain_edge_index(ln)
        graphs.append(build_graph(src, dst, max_len,
                                  self_loop_weight=self_loop_weight,
                                  pad_multiple=1, strategy="edge",
                                  extra_edge_capacity=2 * (max_len - ln),
                                  device=dev))
    return GraphBatch(graphs)


# ----------------------------------------------------------------------
# Image datasets
# ----------------------------------------------------------------------

def _load_mnist_raw(data_dir: str):
    """Parse the standard idx-format MNIST files if present."""
    def read_images(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            _, n, h, w = struct.unpack(">IIII", f.read(16))
            return np.frombuffer(f.read(), np.uint8).reshape(n, h, w)

    def read_labels(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            _, n = struct.unpack(">II", f.read(8))
            return np.frombuffer(f.read(), np.uint8)

    for sub in ("MNIST/raw", "mnist", "."):
        base = os.path.join(data_dir, sub)
        for ext in ("", ".gz"):
            p = os.path.join(base, "train-images-idx3-ubyte" + ext)
            if os.path.exists(p):
                xs = read_images(p)
                ys = read_labels(os.path.join(
                    base, "train-labels-idx1-ubyte" + ext))
                return xs, ys
    return None


def _synthetic_digits(n: int, h: int, w: int, chan: int, num_class: int,
                      seed: int):
    """Class-conditional blob images: a MNIST/CIFAR stand-in whose
    classification requires reading the pixels (graphax's, from the same
    numpy RandomState)."""
    rng = np.random.RandomState(seed)
    ys = rng.randint(0, num_class, n)
    yy, xx = np.mgrid[0:h, 0:w]
    xs = np.zeros((n, h, w, chan), np.float32)
    for i, c in enumerate(ys):
        cx = (c + 1) / (num_class + 1) * w
        cy = h / 2 + (c % 2) * h / 6 - h / 12
        blob = np.exp(-(((xx - cx) ** 2) + (yy - cy) ** 2)
                      / (2 * (w / 8) ** 2))
        xs[i] = blob[..., None] + 0.1 * rng.randn(h, w, chan)
    return xs, ys


@dataclasses.dataclass(frozen=True)
class PixelGraphDataset:
    """Images as grid-graph node features: x ``[B, N_pixels, C]`` (numpy),
    the grid a Graph on the dataset's device."""

    graph: Graph
    x: np.ndarray
    y: np.ndarray
    num_classes: int
    height: int
    width: int

    def batches(self, batch_size: int, seed: int = 0, train: bool = True
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = np.arange(len(self.y))
        if train:
            np.random.RandomState(seed).shuffle(idx)
        for s in range(0, len(idx) - batch_size + 1, batch_size):
            sel = idx[s:s + batch_size]
            yield self.x[sel], self.y[sel]


def get_image_dataset(name: str, data_dir: str = "./data",
                      size: Optional[int] = None, diags: bool = True,
                      self_loop_weight: float = 0.555, seed: int = 0,
                      device=None) -> PixelGraphDataset:
    """MNIST/CIFAR as pixel-grid diffusion data (`run_multi.py` pipeline);
    the grid graph on ``device`` (the card unless asked otherwise)."""
    preset = MULTIMODAL_PRESETS[name]
    h, w, chan = preset["im_height"], preset["im_width"], preset["im_chan"]
    nc = preset["num_class"]
    raw = _load_mnist_raw(data_dir) if name == "MNIST" else None
    if raw is not None:
        xs, ys = raw
        xs = xs[..., None].astype(np.float32) / 255.0
    else:
        xs, ys = _synthetic_digits(size or 1024, h, w, chan, nc, seed)
    if size is not None:
        xs, ys = xs[:size], ys[:size]
    row, col = grid_edge_index(h, w, diagonals=diags)
    graph = build_graph(row, col, h * w, self_loop_weight=self_loop_weight,
                        device=device)
    x = xs.reshape(xs.shape[0], h * w, chan)
    return PixelGraphDataset(graph=graph, x=x.astype(np.float32),
                             y=ys.astype(np.int64), num_classes=nc,
                             height=h, width=w)


# ----------------------------------------------------------------------
# CLEVR-style multimodal dataset with HDF5 precompute
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MultimodalGraphDataset:
    """CLEVR-style VQA: image grid features + question chain features.

    ``__getitem__`` follows the reference CLEVR_v1 (`src/data_multi.py:
    326-428`): per sample a dict with the modalities' data (image grid
    features, question token features), the two graphs, and the answer
    label."""

    image_graph: Graph
    text_graph: Graph
    images: np.ndarray      # [B, g^2, feat_dim]
    questions: np.ndarray   # [B, L, text_dim]
    answers: np.ndarray     # [B]
    num_classes: int
    # per-sample real question lengths (one chain graph per question,
    # `src/data_multi.py:376`); None: every chain is max length
    question_lengths: Optional[np.ndarray] = None

    def __len__(self):
        return len(self.answers)

    def _text_graph(self, i) -> Graph:
        if self.question_lengths is None:
            return self.text_graph
        return batched_chain_graphs(self.question_lengths[i:i + 1],
                                    self.questions.shape[1],
                                    device=self.text_graph.device).sample(0)

    def __getitem__(self, i):
        return {
            "modality_data": [self.images[i], self.questions[i]],
            "modality_graphs": [self.image_graph, self._text_graph(i)],
            "additional_data": None,
            "labels": self.answers[i],
        }

    def batches(self, batch_size: int, seed: int = 0):
        idx = np.random.RandomState(seed).permutation(len(self))
        for s in range(0, len(self) - batch_size + 1, batch_size):
            sel = idx[s:s + batch_size]
            yield (self.images[sel], self.questions[sel],
                   self.answers[sel], sel)

    def text_graphs_for(self, sel) -> GraphBatch:
        """The per-sample chain graphs of a batch's index array (the
        reference's ``[B, 2, E]`` per-question edge lists)."""
        if self.question_lengths is None:
            lens = np.full(len(np.atleast_1d(sel)),
                           self.questions.shape[1], np.int64)
        else:
            lens = self.question_lengths[sel]
        return batched_chain_graphs(lens, self.questions.shape[1],
                                    device=self.text_graph.device)


def build_clevr_style_dataset(num_samples: int = 64, grid: int = 14,
                              feat_dim: int = 64, text_dim: int = 32,
                              max_question_len: int = 16,
                              num_classes: int = 28,
                              cache_path: Optional[str] = None,
                              data_dir: Optional[str] = None,
                              seed: int = 0,
                              device=None) -> MultimodalGraphDataset:
    """Build (or load) the precomputed image-grid features, question
    features and answers (graphax `build_clevr_style_dataset`: the
    reference's CLEVR precompute layout, ``images [N, g^2, feat]``). With
    real extractor checkpoints staged under ``data_dir`` the features come
    from them, else from the seeded stand-ins. ``h5py`` is imported only
    where a ``cache_path`` is given (graphax imports it always); the graphs
    go on ``device`` (the card unless asked otherwise)."""
    from graphax_torch.data.extractors import (ImageFeatureExtractor,
                                               TextFeatureExtractor)

    if cache_path and os.path.exists(cache_path):
        import h5py

        with h5py.File(cache_path, "r") as f:
            images = f["images"][:]
            questions = f["questions"][:]
            answers = f["answers"][:]
            q_lens = (f["question_lengths"][:]
                      if "question_lengths" in f else None)
    else:
        rng = np.random.RandomState(seed)
        img_ex = ImageFeatureExtractor(feat_dim, grid=grid,
                                       data_dir=data_dir, seed=seed,
                                       device=device)
        txt_ex = TextFeatureExtractor(text_dim, vocab_size=100,
                                      data_dir=data_dir, seed=seed)
        if img_ex.using_real_weights:
            # the ResNet trunk downsamples 16x to reach the g x g patch grid
            raw_imgs = rng.rand(num_samples, grid * 16, grid * 16, 3) \
                .astype(np.float32)
        else:
            raw_imgs = rng.rand(num_samples, grid, grid, 3).astype(np.float32)
        images = img_ex(raw_imgs)
        # variable question lengths (one chain graph per question); token
        # positions past a question's length are zero padding
        q_lens = rng.randint(max(max_question_len // 2, 2),
                             max_question_len + 1, num_samples)
        token_ids = rng.randint(0, 100, (num_samples, max_question_len))
        questions = txt_ex(token_ids)
        pad = np.arange(max_question_len)[None, :] >= q_lens[:, None]
        questions = np.where(pad[:, :, None], 0.0, questions)
        # answers depend on both modalities so VQA training is meaningful
        answers = ((raw_imgs.mean(axis=(1, 2, 3)) * 10).astype(np.int64)
                   + token_ids[:, 0] // 10) % num_classes
        if cache_path:
            import h5py

            os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
            with h5py.File(cache_path, "w") as f:
                f.create_dataset("images", data=images,
                                 chunks=(min(16, num_samples),
                                         grid * grid, feat_dim))
                f.create_dataset("questions", data=questions)
                f.create_dataset("answers", data=answers)
                f.create_dataset("question_lengths", data=q_lens)

    return MultimodalGraphDataset(
        image_graph=image_grid_graph(grid, device),
        text_graph=text_chain_graph(max_question_len, device),
        images=np.asarray(images, np.float32),
        questions=np.asarray(questions, np.float32),
        answers=np.asarray(answers, np.int64), num_classes=num_classes,
        question_lengths=(np.asarray(q_lens, np.int64)
                          if q_lens is not None else None))


def image_grid_graph(grid: int, device=None) -> Graph:
    """The CLEVR patch grid: 4-neighbour, self-loops of weight 1."""
    row, col = grid_edge_index(grid, grid, diagonals=False)
    return build_graph(row, col, grid * grid, self_loop_weight=1.0,
                       device=device)


def text_chain_graph(max_len: int, device=None) -> Graph:
    """The full-length question chain, self-loops of weight 1."""
    row, col = chain_edge_index(max_len)
    return build_graph(row, col, max_len, self_loop_weight=1.0,
                       device=device)
