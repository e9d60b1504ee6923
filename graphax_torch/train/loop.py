"""Training and evaluation loop (port of `graphax/train/loop.py`).

The twin of the reference training script
(`src/graph_datasets/run_GNN.py:62-275`): a train step with cross-entropy, the forward and backward NFE meters, per-
epoch train/val/test accuracy and best-val tracking. The Trainer owns the
model, the optimizer and the dropout generator (PyTorch idiom) instead of
threading a functional TrainState.

``fit`` evaluates each epoch as graphax's does: by default (``no_early``
False) with the early-stop evaluation (`graphax_torch.models.early`), whose
observer keeps the best validation accuracy along a solve to
``earlystopxT * T``, else with a plain evaluation at T.

Not ported here (ROADMAP): graphax's 3-jit `split_step` (a TPU compiler
workaround with no output change), kNN/edge-sampling rewiring, checkpoints
and the label trick. GRAND-nl (the transformer RHS) trains on a sparse
graph where the hand-written attention backward covers its config
(`kernels.fused_attention.train_supported`) or under column normalisation
(`kernels.attention3`), and on a windowed graph with row normalisation
(`kernels.winatt`); other transformer configs, and any on a dense graph,
raise `NotImplementedError` in the train step."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import torch
from torch.profiler import record_function

from graphax_torch.blocks.common import normalize_graph
from graphax_torch.data.container import GraphData
from graphax_torch.data.reorder import community_reorder
from graphax_torch.models.early import (
    EarlyStopResult, evaluate_early_stop, masked_accuracy,
)
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

    def evaluate_early(self) -> EarlyStopResult:
        """The early-stop evaluation (graphax's `evaluate_early`): the best
        validation accuracy, with its train and test accuracy and time,
        along a solve to ``earlystopxT * T``. The solve's result is kept as
        ``last_eval``."""
        d = self.data
        res = evaluate_early_stop(self.cfg, self.model, d.graph, d.x, d.y,
                                  d.train_mask, d.val_mask, d.test_mask)
        self.last_eval = res.result
        return res

    def fit(self, epochs: Optional[int] = None, log_every: int = 0,
            use_early_stop: Optional[bool] = None, seed: Optional[int] = None,
            checkpoint_path: Optional[str] = None,
            checkpoint_every: Optional[int] = None) -> Dict[str, Any]:
        """The reference epoch loop (`run_GNN.py:249-275`; graphax's `fit`,
        `graphax/train/loop.py:355-425`): fresh weights from ``seed``, then
        per epoch a train step and an evaluation, the early-stop one unless
        ``use_early_stop`` is False (default: ``not cfg.no_early``), and the
        best validation epoch. ``best`` and ``history`` carry graphax's
        keys; ``best_time`` is ``cfg.time`` without early stopping, the
        observer's time with it. ``solver`` holds per epoch the train
        step's NFE, backward NFE and success and the evaluation's NFE and
        success. It takes the place of graphax's ``state``: the Trainer
        owns its weights, and ``fm``, ``bm`` and ``last_eval`` keep only the
        last epoch's solve, so ``solver`` is the one record by which a
        caller holds every epoch's solves to success without adding keys
        to graphax's ``history``. Checkpoints are not ported (ROADMAP
        Queue 1, item 5):
        ``checkpoint_path`` or ``checkpoint_every`` raises."""
        if checkpoint_path is not None or checkpoint_every is not None:
            raise NotImplementedError("fit's checkpoint_path and "
                                      "checkpoint_every: checkpoints are not "
                                      "ported yet (ROADMAP Queue 1, item 5)")
        cfg = self.cfg
        epochs = cfg.epoch if epochs is None else epochs
        if use_early_stop is None:
            use_early_stop = not cfg.no_early
        self.init_state(seed)
        best = {"val_acc": 0.0, "test_acc": 0.0, "train_acc": 0.0,
                "epoch": 0, "best_time": 0.0}
        history, solver = [], []
        for epoch in range(1, epochs + 1):
            t0 = time.perf_counter()
            loss, aux = self._step()
            if use_early_stop:
                res = self.evaluate_early()
                train_acc, val_acc, test_acc, best_time = (
                    float(v) for v in (res.best_train, res.best_val,
                                       res.best_test, res.best_time))
            else:
                train_acc, val_acc, test_acc = self.evaluate()
                best_time = cfg.time
            if val_acc > best["val_acc"]:
                best.update(val_acc=val_acc, test_acc=test_acc,
                            train_acc=train_acc, epoch=epoch,
                            best_time=best_time)
            history.append(dict(epoch=epoch, loss=loss, train_acc=train_acc,
                                val_acc=val_acc, test_acc=test_acc,
                                time=time.perf_counter() - t0,
                                nfe=aux["nfe"]))
            solver.append(dict(nfe=aux["nfe"], bwd_nfe=aux["bwd_nfe"],
                               success=aux["success"],
                               eval_nfe=self.last_eval.nfe,
                               eval_success=self.last_eval.success))
            if log_every and epoch % log_every == 0:
                h = history[-1]
                print(f"Epoch {epoch:4d} | time {h['time']:.3f}s | loss "
                      f"{loss:.4f} | nfe {h['nfe']} | train {train_acc:.4f} "
                      f"| val {val_acc:.4f} | test {test_acc:.4f} | best "
                      f"val {best['val_acc']:.4f}")
        return {"best": best, "history": history, "solver": solver}
