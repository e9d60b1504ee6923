"""Training and evaluation loop (port of `graphax/train/loop.py`).

The twin of the reference training script
(`src/graph_datasets/run_GNN.py:62-275`): a train step with cross-entropy, the forward and backward NFE meters, per-
epoch train/val/test accuracy and best-val tracking. The Trainer owns the
model, the optimizer and the dropout generator (PyTorch idiom) instead of
threading a functional TrainState.

Not ported here (ROADMAP): graphax's 3-jit `split_step` (a TPU compiler
workaround with no output change), kNN/edge-sampling rewiring, checkpoints,
the label trick and the early-stop evaluation (`models/early.py`). GRAND-nl
(the transformer RHS) trains where the hand-written attention backward
covers its config (`kernels.fused_attention.train_supported`); other
transformer configs raise `NotImplementedError` in the train step."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import torch
from torch.profiler import record_function

from graphax_torch.blocks.common import normalize_graph
from graphax_torch.data.container import GraphData
from graphax_torch.data.reorder import community_reorder
from graphax_torch.models.gnn import GNN
from graphax_torch.train.optimizers import get_optimizer
from graphax_torch.utils.device import resolve_device


class Meter:
    """Forward/backward NFE accumulator (`src/utils.py:281-302`)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val, self.sum, self.cnt = None, 0, 0

    def update(self, val):
        self.val = val
        self.sum += val
        self.cnt += 1

    def get_value(self):
        return self.val


def cross_entropy_loss(logits, labels, mask):
    """Mean cross-entropy over the masked nodes (the arxiv path's
    log_softmax + nll is the same number)."""
    logp = torch.log_softmax(logits, dim=-1)
    per_node = -logp.gather(1, labels[:, None])[:, 0]
    per_node = torch.where(mask, per_node, torch.zeros_like(per_node))
    return per_node.sum() / torch.clamp(mask.sum(), min=1)


def masked_accuracy(logits, labels, mask):
    correct = (logits.argmax(-1) == labels) & mask
    return correct.sum() / torch.clamp(mask.sum(), min=1)


_UNPORTED = {
    "rewire_KNN": "kNN rewiring (ROADMAP Queue 1, M8)",
    "fa_layer": "the fa-layer model (ROADMAP Queue 1, M8)",
    "edge_sampling": "edge-sampling rewiring (ROADMAP Queue 1, M8)",
    "rewiring": "graph rewiring (ROADMAP Queue 1, M8)",
}


class Trainer:
    """Train ``cfg``'s model on ``data`` on ``device`` (the card unless the
    caller asks for the CPU; CUDA requested but absent raises)."""

    def __init__(self, cfg, data: GraphData, device=None):
        for field, what in _UNPORTED.items():
            if getattr(cfg, field):
                raise NotImplementedError(f"{field}: {what} is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        data = data.to(self.device)
        self.reorder_seconds = 0.0
        if cfg.community_window and data.graph.strategy != "windowed":
            # the windowed layout on community-ordered node ids, as graphax
            # (`graphax/train/loop.py:95-103`); below 35 % of the edges
            # in-window the ids stay reordered on the plain CSR strategy
            t0 = time.perf_counter()
            data = community_reorder(data, window=cfg.community_window,
                                     min_in_window_frac=0.35)
            self.reorder_seconds = time.perf_counter() - t0
        # the per-forward weight normalisation hoisted to init: weights are
        # static between topology changes
        graph = dataclasses.replace(normalize_graph(cfg, data.graph),
                                    pre_normalized=True)
        self.data = dataclasses.replace(data, graph=graph)
        self.model = GNN(cfg, data.num_features, data.num_classes) \
            .to(self.device)
        self.fm, self.bm = Meter(), Meter()
        self.last_eval = None
        self.init_state()

    def init_state(self, seed: Optional[int] = None) -> None:
        """Fresh weights from ``seed`` (cfg.seed by default), a fresh
        optimizer and a fresh dropout generator."""
        seed = self.cfg.seed if seed is None else int(seed)
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.optimizer = get_optimizer(self.cfg.optimizer,
                                       self.model.parameters(), self.cfg.lr,
                                       self.cfg.decay)
        self.generator = torch.Generator(device=self.device) \
            .manual_seed(seed + 1)

    def train_step(self) -> float:
        """One optimizer step; returns the loss and updates the NFE meters."""
        return self._step()[0]

    def _step(self):
        d = self.data
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        logits, out = self.model(d.graph, d.x, train=True,
                                 generator=self.generator)
        loss = cross_entropy_loss(logits, d.y, d.train_mask)
        loss.backward()
        with record_function("graphax_torch.optimizer"):
            self.optimizer.step()
        res = out.result
        # bm semantics (`run_GNN.py:90-95`): the adjoint's own backward NFE,
        # else the forward's (autograd replays each accepted step once)
        bwd = res.adjoint.nfe if res.adjoint is not None else res.nfe
        self.fm.update(res.nfe)
        self.bm.update(bwd)
        return float(loss.detach()), {"nfe": res.nfe, "bwd_nfe": bwd,
                                      "steps": res.steps,
                                      "success": res.success}

    @torch.no_grad()
    def evaluate(self):
        """(train, val, test) accuracy with running batch-norm statistics
        and all edges. The solve's result (NFE, success) is kept as
        ``last_eval``."""
        d = self.data
        self.model.eval()
        logits, out = self.model(d.graph, d.x, train=False)
        self.last_eval = out.result
        return tuple(float(masked_accuracy(logits, d.y, m))
                     for m in (d.train_mask, d.val_mask, d.test_mask))

    def fit(self, epochs: Optional[int] = None,
            use_early_stop: Optional[bool] = None) -> Dict[str, Any]:
        """The reference epoch loop: train, evaluate, track best val/test.
        The early-stop evaluation is not ported: ``use_early_stop`` must be
        False (or ``cfg.no_early``)."""
        cfg = self.cfg
        epochs = cfg.epoch if epochs is None else epochs
        if use_early_stop is None:
            use_early_stop = not cfg.no_early
        if use_early_stop:
            raise NotImplementedError("early-stop evaluation (models/early.py) "
                                      "is not ported yet (ROADMAP Queue 1, M6)")
        self.init_state()
        best = {"val_acc": 0.0, "test_acc": 0.0, "train_acc": 0.0,
                "epoch": 0}
        history = []
        for epoch in range(1, epochs + 1):
            t0 = time.perf_counter()
            loss, aux = self._step()
            train_acc, val_acc, test_acc = self.evaluate()
            seconds = time.perf_counter() - t0
            if val_acc > best["val_acc"]:
                best.update(val_acc=val_acc, test_acc=test_acc,
                            train_acc=train_acc, epoch=epoch)
            history.append(dict(epoch=epoch, loss=loss, train_acc=train_acc,
                                val_acc=val_acc, test_acc=test_acc,
                                time=seconds, nfe=aux["nfe"],
                                bwd_nfe=aux["bwd_nfe"],
                                success=aux["success"]))
        return {"best": best, "history": history}
