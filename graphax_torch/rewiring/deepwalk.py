"""DeepWalk node embeddings, Beltrami's positional encodings DW64/DW128/DW256
(port of `graphax/rewiring/deepwalk.py`).

Uniform random walks on the host (numpy, bit for bit graphax's), a
skip-gram with negative sampling trained by the port's optax-exact adam on
the card (or the CPU when asked), and a ridge-classifier probe for the
accuracy the cache keeps beside the embeddings (numpy, graphax's).

The (center, context) pairs and every batch's negatives come from one numpy
``RandomState(seed)`` stream in graphax's order, so a run reads the same
pairs and negatives as graphax's. JAX's PRNG has no torch counterpart: the
initial embedding is ``0.1 * randn`` from a ``torch.Generator`` seeded with
``seed``, or the caller's ``init`` (the parity tests pass graphax's)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from graphax_torch.train.optimizers import get_optimizer
from graphax_torch.utils.device import resolve_device

# batches whose negatives are drawn in one call: the legacy RandomState
# draws the same values one batch at a time or many at once
_NEG_GROUP = 64


def random_walks(row, col, num_nodes: int, walk_length: int = 20,
                 walks_per_node: int = 10, seed: int = 0) -> np.ndarray:
    """Uniform random walks ``[num_nodes * walks_per_node, walk_length]``
    int64; a node without out-edges stays put."""
    rng = np.random.RandomState(seed)
    order = np.argsort(row, kind="stable")
    row_s, col_s = np.asarray(row)[order], np.asarray(col)[order]
    ptr = np.searchsorted(row_s, np.arange(num_nodes + 1))
    deg = np.diff(ptr)

    starts = np.tile(np.arange(num_nodes), walks_per_node)
    walks = np.empty((len(starts), walk_length), np.int64)
    walks[:, 0] = starts
    cur = starts.copy()
    for t in range(1, walk_length):
        r = rng.rand(len(cur))
        has_nbrs = deg[cur] > 0
        offset = (r * np.maximum(deg[cur], 1)).astype(np.int64)
        nxt = col_s[ptr[cur] + np.minimum(offset, np.maximum(deg[cur] - 1, 0))]
        cur = np.where(has_nbrs, nxt, cur)
        walks[:, t] = cur
    return walks


def context_pairs(walks: np.ndarray, window: int,
                  rng: np.random.RandomState) -> np.ndarray:
    """``[P, 2]`` (center, context) pairs at offsets 1..window, in the order
    ``rng.shuffle(pairs)`` leaves them, as graphax. The shuffle's swaps
    depend on ``rng``'s draws alone, and a 1-D array takes them in C where
    numpy walks a 2-D one row by row in Python (minutes at arxiv's 144 M
    pairs): so an index array is shuffled with the same draws, and the
    pairs gathered by it."""
    l = walks.shape[1]
    pairs = np.concatenate(
        [np.stack([walks[:, :l - off].reshape(-1),
                   walks[:, off:].reshape(-1)], axis=1)
         for off in range(1, window + 1)], axis=0)
    order = np.arange(len(pairs))
    rng.shuffle(order)
    return pairs[order]


def skipgram_loss(emb, ctx, centers, contexts, negs):
    """``-(mean log sigmoid(e_c . c_o) + mean log sigmoid(-e_c . c_neg))``."""
    ce = emb[centers]                                         # [B, D]
    pos = (ce * ctx[contexts]).sum(-1)
    neg = torch.einsum("bd,bkd->bk", ce, ctx[negs])
    return -(torch.nn.functional.logsigmoid(pos).mean()
             + torch.nn.functional.logsigmoid(-neg).mean())


def skipgram_train(walks: np.ndarray, num_nodes: int, dim: int,
                   window: int = 5, negatives: int = 5, epochs: int = 3,
                   lr: float = 0.025, batch: int = 8192, seed: int = 0,
                   device=None, init: Optional[np.ndarray] = None
                   ) -> np.ndarray:
    """Skip-gram with negative sampling over the walks' context pairs:
    adam on ``emb`` and ``ctx`` (zeros), one step a full batch of pairs,
    the trailing partial batch dropped, as graphax. Returns ``emb [N, dim]``
    f32."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    pairs = context_pairs(walks, window, rng)
    if init is None:
        emb0 = 0.1 * torch.randn((num_nodes, dim),
                                 generator=torch.Generator().manual_seed(seed))
    else:
        emb0 = torch.tensor(np.array(init, dtype=np.float32))
    emb = emb0.to(dev).requires_grad_(True)
    ctx = torch.zeros((num_nodes, dim), device=dev, requires_grad=True)
    opt = get_optimizer("adam", [emb, ctx], lr)
    pairs_d = torch.as_tensor(pairs, device=dev)
    starts = range(0, len(pairs) - batch + 1, batch)
    for _ in range(epochs):
        for g0 in range(0, len(starts), _NEG_GROUP):
            group = starts[g0:g0 + _NEG_GROUP]
            negs = torch.as_tensor(
                rng.randint(0, num_nodes, size=(len(group) * batch,
                                                negatives)), device=dev)
            for i, s in enumerate(group):
                chunk = pairs_d[s:s + batch]
                opt.zero_grad(set_to_none=True)
                skipgram_loss(emb, ctx, chunk[:, 0], chunk[:, 1],
                              negs[i * batch:(i + 1) * batch]).backward()
                opt.step()
    return emb.detach().cpu().numpy().astype(np.float32)


def probe_accuracy(emb, labels, seed=0) -> float:
    """Ridge-classifier probe (the reference's logistic-regression stand-in)
    on a random 70/30 split."""
    rng = np.random.RandomState(seed)
    n = emb.shape[0]
    idx = rng.permutation(n)
    split = int(0.7 * n)
    tr, te = idx[:split], idx[split:]
    y_oh = np.eye(int(labels.max()) + 1)[labels]
    x_tr = np.concatenate([emb[tr], np.ones((len(tr), 1))], axis=1)
    x_te = np.concatenate([emb[te], np.ones((len(te), 1))], axis=1)
    w, *_ = np.linalg.lstsq(x_tr.T @ x_tr + 1e-3 * np.eye(x_tr.shape[1]),
                            x_tr.T @ y_oh[tr], rcond=None)
    pred = (x_te @ w).argmax(axis=1)
    return float((pred == labels[te]).mean())


def deepwalk_embeddings(row, col, num_nodes: int, dim: int = 64,
                        labels: Optional[np.ndarray] = None,
                        walk_length: int = 20, walks_per_node: int = 10,
                        epochs: int = 2, seed: int = 0, device=None,
                        init: Optional[np.ndarray] = None
                        ) -> Tuple[np.ndarray, float]:
    """(embeddings ``[N, dim]`` f32, probe accuracy or nan without labels),
    the pair the cache pickles."""
    walks = random_walks(row, col, num_nodes, walk_length, walks_per_node,
                         seed)
    emb = skipgram_train(walks, num_nodes, dim, epochs=epochs, seed=seed,
                         device=device, init=init)
    acc = probe_accuracy(emb, np.asarray(labels), seed) \
        if labels is not None else float("nan")
    return emb, acc


def pick_best_embeddings(cache_dir: str, dataset: str, dim: int):
    """Among the DeepWalk pickles ``{cache_dir}/pos_encodings/{dataset}_
    DW{dim}*.pkl``, link the one of best probe accuracy (its ``acc``) to
    the canonical ``{dataset}_DW{dim}.pkl`` name that `apply_beltrami`
    reads (the capability of the reference's `deepwalk_gen_symlinks.py`,
    `:24-47`). Returns the canonical path, or None where there is no
    candidate."""
    import os
    import pickle

    pos_dir = os.path.join(cache_dir, "pos_encodings")
    if not os.path.isdir(pos_dir):
        return None
    best, best_acc = None, -1.0
    for fname in os.listdir(pos_dir):
        if fname.startswith(f"{dataset}_DW{dim}") and fname.endswith(".pkl"):
            with open(os.path.join(pos_dir, fname), "rb") as f:
                obj = pickle.load(f)
            acc = obj.get("acc", 0.0) if isinstance(obj, dict) else 0.0
            if acc > best_acc:
                best, best_acc = fname, acc
    if best is None:
        return None
    canonical = os.path.join(pos_dir, f"{dataset}_DW{dim}.pkl")
    src = os.path.join(pos_dir, best)
    if os.path.abspath(src) != os.path.abspath(canonical):
        if os.path.lexists(canonical):
            os.remove(canonical)
        os.symlink(os.path.basename(src), canonical)
    return canonical
