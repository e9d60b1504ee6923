"""Checkpoint save/restore (port of `graphax/train/checkpoint.py`).

The port's checkpoint is one ``.npz`` of named arrays (no pickle), written
and read by :func:`save_checkpoint` and :func:`load_checkpoint`; a path
without the suffix gets ``.npz`` appended, as graphax's. The Trainer's
names are ``model/<state_dict key>``, ``optimizer/<parameter>/<state
key>``, ``generator``, ``best/<key>`` and ``epoch``.

:func:`load_graphax_checkpoint` reads a checkpoint written by graphax's
`Trainer.fit` (``leaf_<i>`` arrays and a ``__treedef__`` JSON of nested
dicts, lists and tuples) into nested dicts, lists and tuples of numpy
arrays. graphax numbers the leaves in `jax.tree_util.tree_flatten`'s
order, which visits a dict's keys sorted, while its JSON keeps the dicts'
insertion order; so the leaves are matched to the JSON's places with each
dict's keys sorted, as jax flattened them. (graphax's own
``load_checkpoint(path)`` without ``like`` follows the insertion order and
swaps the leaves of any dict not inserted sorted.)"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch


def npz_path(path: str) -> str:
    """``path`` with graphax's suffix rule: ``.npz`` appended unless there."""
    return path if path.endswith(".npz") else path + ".npz"


def _existing(path: str) -> str:
    """``path``, or ``path + ".npz"`` where only that exists."""
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        return path + ".npz"
    return path


def _as_numpy(v) -> np.ndarray:
    if torch.is_tensor(v):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.numpy()
    return np.asarray(v)


def save_checkpoint(path: str, arrays: Mapping[str, Any]) -> str:
    """Save named tensors or arrays to one ``.npz``. Returns the path
    written."""
    path = npz_path(os.path.abspath(path))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: _as_numpy(v) for k, v in arrays.items()})
    return path


def load_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """The named arrays of a checkpoint (``path`` or ``path + ".npz"``)."""
    with np.load(_existing(path), allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def load_graphax_checkpoint(path: str) -> Any:
    """The tree that graphax's `save_checkpoint` wrote, its leaves numbered
    as jax flattened them (each dict's keys sorted). Raises if the leaves
    and the structure disagree in number."""
    path = _existing(path)
    with np.load(path, allow_pickle=False) as f:
        if "__treedef__" not in f.files:
            raise ValueError(f"{path} is not a graphax checkpoint "
                             "(no __treedef__)")
        spec = json.loads(bytes(f["__treedef__"]).decode())
        n = len([k for k in f.files if k.startswith("leaf_")])
        leaves = [f[f"leaf_{i}"] for i in range(n)]
    it = iter(leaves)
    tree = _rebuild_sorted(spec, it)
    if next(it, None) is not None:
        raise ValueError(f"{path}: more leaves than its structure holds")
    return tree


def _rebuild_sorted(spec, leaves) -> Any:
    kind = spec["__kind__"]
    if kind == "leaf":
        try:
            return next(leaves)
        except StopIteration:
            raise ValueError("graphax checkpoint: fewer leaves than its "
                             "structure holds") from None
    if kind == "dict":
        items = spec["items"]
        return {k: _rebuild_sorted(items[k], leaves) for k in sorted(items)}
    seq = [_rebuild_sorted(v, leaves) for v in spec["items"]]
    return seq if kind == "list" else tuple(seq)
