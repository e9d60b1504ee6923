"""Training and evaluation loop (port of `graphax/train/loop.py`).

The twin of the reference training script
(`src/graph_datasets/run_GNN.py:62-275`): a train step with cross-entropy,
the label trick (`add_labels`, `get_label_masks`, `:39-59`), the forward and
backward NFE meters, per-epoch train/val/test accuracy and best-val
tracking, and checkpoints that ``fit`` saves and resumes from. The Trainer
owns the model, the optimizer and the dropout generator (PyTorch idiom)
instead of threading a functional TrainState.

``fit`` evaluates each epoch as graphax's does: by default (``no_early``
False) with the early-stop evaluation (`graphax_torch.models.early`), whose
observer keeps the best validation accuracy along a solve to
``earlystopxT * T``, else with a plain evaluation at T.

kNN and edge-sampling rewiring run at the start of every
``rewire_KNN_epoch``-th / ``edge_sampling_epoch``-th epoch, as graphax's
(`graphax/train/loop.py:381-384`): the new topology is normalised again and
its CSR/CSC layouts are built with it (:meth:`Trainer._swap_graph`).
``cfg.rewiring`` (two-hop, GDC) is not read here, as in graphax: it is
applied to the dataset before the Trainer is built
(`graphax_torch.rewiring.apply_gdc_rewiring`,
`apply_two_hop_rewiring`), like Beltrami's positional encodings
(`graphax_torch.rewiring.apply_beltrami`, then
``data.with_pos_encoding``), which the model reads from
``data.pos_encoding``.

The loss adds ``coeff * mean(reg_state)`` for each regulariser of
``cfg.reg_coeffs()`` (`graphax/train/loop.py:181-182`), the states the
block integrated beside x (`graphax_torch.functions.regularizers`).
``cfg.cgnn`` is not read here, as graphax's Trainer does not read it: the
CGNN baseline has its own model and driver (`graphax_torch.models.cgnn`,
`graphax_torch.drivers.run_cgnn`). Not ported (no output change):
graphax's 3-jit `split_step`, a TPU compiler workaround. GRAND-nl (the transformer RHS) trains on every graph graphax
trains it on, by the route
`graphax_torch.functions.transformer.attention_route` names."""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from graphax_torch.blocks.common import normalize_graph
from graphax_torch.data.container import GraphData
from graphax_torch.data.reorder import community_reorder
from graphax_torch.models.early import (
    EarlyStopResult, evaluate_early_stop, masked_accuracy,
)
from graphax_torch.models.gnn import GNN
from graphax_torch.models.gnn_knn import GNNKNN
from graphax_torch.rewiring import apply_edge_sampling, apply_knn
from graphax_torch.train import checkpoint as ckpt
from graphax_torch.train.optimizers import get_optimizer
from graphax_torch.utils.device import resolve_device
from graphax_torch.utils.transplant import (
    graphax_to_state_dict, load_graphax_params,
)


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


def add_labels(feat, labels, mask, num_classes: int):
    """Append one-hot labels for the masked nodes, zeros elsewhere
    (`run_GNN.py:39-45`)."""
    onehot = torch.nn.functional.one_hot(labels, num_classes).to(feat.dtype)
    return torch.cat([feat, onehot * mask[:, None].to(feat.dtype)], dim=-1)


def get_label_masks(generator: torch.Generator, train_mask,
                    label_rate: float = 0.5):
    """Split the train nodes into label-carrying and prediction nodes by a
    coin from ``generator`` per node (`run_GNN.py:48-59`). Returns
    (label_mask, pred_mask)."""
    coin = torch.rand(train_mask.shape, generator=generator,
                      device=train_mask.device) < label_rate
    return train_mask & coin, train_mask & ~coin


def cross_entropy_loss(logits, labels, mask):
    """Mean cross-entropy over the masked nodes (the arxiv path's
    log_softmax + nll is the same number)."""
    logp = torch.log_softmax(logits, dim=-1)
    per_node = -logp.gather(1, labels[:, None])[:, 0]
    per_node = torch.where(mask, per_node, torch.zeros_like(per_node))
    return per_node.sum() / torch.clamp(mask.sum(), min=1)


# optax's state of each optimizer (`graphax/train/optimizers.py:12-26`):
# the fields of its first transform's state, in order, under the names the
# port's OptaxOptimizer keeps per parameter
_OPTAX_FIELDS = {"sgd": (), "rmsprop": ("nu",), "adagrad": ("sum_of_squares",),
                 "adam": ("count", "mu", "nu"),
                 "adamax": ("count", "mu", "nu")}


class Trainer:
    """Train ``cfg``'s model on ``data`` on ``device`` (the card unless the
    caller asks for the CPU; CUDA requested but absent raises)."""

    def __init__(self, cfg, data: GraphData, device=None):
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
        self.data = data
        self._swap_graph(data.graph)
        # the kNN/fa-layer model where those flags are set, as graphax
        # (`graphax/train/loop.py:117-119`)
        maker = GNNKNN if (cfg.rewire_KNN or cfg.fa_layer) else GNN
        self.model = maker(cfg, data.num_features, data.num_classes) \
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

    def _prepare_features(self, train: bool):
        """The model's input and the loss mask (graphax's
        `_prepare_features`). Under ``use_labels`` the one-hot labels of
        the label-carrying nodes join the features: in training a fresh
        coin per train node from the dropout generator, in evaluation every
        train node. The loss keeps the full train mask, the reference's
        quirk (`run_GNN.py:75-80`), which graphax keeps."""
        d, cfg = self.data, self.cfg
        feat = d.x
        if cfg.use_labels:
            label_mask = get_label_masks(self.generator, d.train_mask,
                                         cfg.label_rate)[0] if train \
                else d.train_mask
            feat = add_labels(feat, d.y, label_mask, d.num_classes)
        return feat, d.train_mask

    def _swap_graph(self, graph) -> None:
        """Put ``graph`` in the dataset with the per-forward weight
        normalisation hoisted (graphax's `_swap_graph`): the weights are
        static between topology changes. A rewired graph comes with its
        CSR/CSC layouts built (`rewire_graph_with_edges`)."""
        graph = dataclasses.replace(normalize_graph(self.cfg, graph),
                                    pre_normalized=True)
        self.data = dataclasses.replace(self.data, graph=graph)

    def rewire_knn(self) -> None:
        """kNN-rewire the dataset's graph from the current weights
        (`graphax_torch.rewiring.apply_knn`)."""
        self._swap_graph(apply_knn(self.cfg, self.model, self.data))

    def rewire_edge_sampling(self) -> None:
        """Edge-sampling rewiring from the current weights
        (`graphax_torch.rewiring.apply_edge_sampling`)."""
        self._swap_graph(apply_edge_sampling(self.cfg, self.model,
                                             self.data))

    def train_step(self) -> float:
        """One optimizer step; returns the loss and updates the NFE meters."""
        return self._step()[0]

    def _step(self):
        d = self.data
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        feat, loss_mask = self._prepare_features(train=True)
        logits, out = self.model(d.graph, feat, train=True,
                                 generator=self.generator,
                                 pos_encoding=d.pos_encoding)
        loss = cross_entropy_loss(logits, d.y, loss_mask)
        for rs, (_, coeff) in zip(out.reg_states, self.cfg.reg_coeffs()):
            loss = loss + coeff * torch.mean(rs)
        loss.backward()
        with record_function("graphax_torch.optimizer"):
            self.optimizer.step()
        res = out.result
        # bm semantics (`run_GNN.py:90-95`): the adjoint's own backward NFE,
        # else the forward's (autograd replays each accepted step once)
        bwd = res.adjoint.nfe if res.adjoint is not None else res.nfe
        self.fm.update(res.nfe)
        self.bm.update(bwd)
        return float(loss.detach()), {
            "nfe": res.nfe, "bwd_nfe": bwd, "steps": res.steps,
            "success": res.success,
            "bwd_success": res.adjoint.success if res.adjoint is not None
            else res.success}

    @torch.no_grad()
    def evaluate(self):
        """(train, val, test) accuracy with running batch-norm statistics
        and all edges. The solve's result (NFE, success) is kept as
        ``last_eval``."""
        d = self.data
        self.model.eval()
        logits, out = self.model(d.graph, self._prepare_features(False)[0],
                                 train=False, pos_encoding=d.pos_encoding)
        self.last_eval = out.result
        return tuple(float(masked_accuracy(logits, d.y, m))
                     for m in (d.train_mask, d.val_mask, d.test_mask))

    def evaluate_early(self) -> EarlyStopResult:
        """The early-stop evaluation (graphax's `evaluate_early`): the best
        validation accuracy, with its train and test accuracy and time,
        along a solve to ``earlystopxT * T``. The solve's result is kept as
        ``last_eval``."""
        d = self.data
        res = evaluate_early_stop(self.cfg, self.model, d.graph,
                                  self._prepare_features(False)[0], d.y,
                                  d.train_mask, d.val_mask, d.test_mask,
                                  pos_encoding=d.pos_encoding)
        self.last_eval = res.result
        return res

    def fit(self, epochs: Optional[int] = None, log_every: int = 0,
            use_early_stop: Optional[bool] = None, seed: Optional[int] = None,
            checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 10) -> Dict[str, Any]:
        """The reference epoch loop (`run_GNN.py:249-275`; graphax's `fit`,
        `graphax/train/loop.py:355-460`): fresh weights from ``seed``, then
        per epoch a train step and an evaluation, the early-stop one unless
        ``use_early_stop`` is False (default: ``not cfg.no_early``), and the
        best validation epoch. ``best`` and ``history`` carry graphax's
        keys; ``best_time`` is ``cfg.time`` without early stopping, the
        observer's time with it. ``solver`` holds per epoch the train
        step's NFE, backward NFE, success and backward success (the
        adjoint's backward solve reached t0 within ``max_nfe``) and the
        evaluation's NFE and success. It takes the place of graphax's
        ``state``: the Trainer owns its weights, and ``fm``, ``bm`` and
        ``last_eval`` keep only the last epoch's solve, so ``solver`` is
        the one record by which a caller holds every epoch's solves to
        success without adding keys to graphax's ``history``.

        ``checkpoint_path``, as graphax's: where ``npz_path(path)`` exists,
        the weights, batch-norm statistics, optimizer state, dropout
        generator, ``best`` and epoch come from it and the loop resumes at
        its epoch + 1 (else it starts fresh); the checkpoint is saved every
        ``checkpoint_every`` epochs and once at the end with ``epoch =
        epochs``. ``history`` and ``solver`` cover the epochs this call
        ran."""
        cfg = self.cfg
        epochs = cfg.epoch if epochs is None else epochs
        if use_early_stop is None:
            use_early_stop = not cfg.no_early
        self.init_state(seed)
        best = {"val_acc": 0.0, "test_acc": 0.0, "train_acc": 0.0,
                "epoch": 0, "best_time": 0.0}
        start_epoch = 1
        if checkpoint_path is not None and \
                os.path.exists(ckpt.npz_path(checkpoint_path)):
            resumed = self.load_checkpoint(ckpt.npz_path(checkpoint_path))
            best, start_epoch = resumed["best"], resumed["epoch"] + 1
        history, solver = [], []
        for epoch in range(start_epoch, epochs + 1):
            t0 = time.perf_counter()
            if cfg.rewire_KNN and epoch % cfg.rewire_KNN_epoch == 0:
                self.rewire_knn()
            if cfg.edge_sampling and epoch % cfg.edge_sampling_epoch == 0:
                self.rewire_edge_sampling()
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
                               bwd_success=aux["bwd_success"],
                               eval_nfe=self.last_eval.nfe,
                               eval_success=self.last_eval.success))
            if log_every and epoch % log_every == 0:
                h = history[-1]
                print(f"Epoch {epoch:4d} | time {h['time']:.3f}s | loss "
                      f"{loss:.4f} | nfe {h['nfe']} | train {train_acc:.4f} "
                      f"| val {val_acc:.4f} | test {test_acc:.4f} | best "
                      f"val {best['val_acc']:.4f}")
            if checkpoint_path is not None and epoch % checkpoint_every == 0:
                self.save_checkpoint(checkpoint_path, epoch, best)
        if checkpoint_path is not None:
            self.save_checkpoint(checkpoint_path, epochs, best)
        return {"best": best, "history": history, "solver": solver}

    # -- checkpoints ---------------------------------------------------

    def save_checkpoint(self, path: str, epoch: int, best: dict) -> str:
        """Save the model's ``state_dict`` (parameters and batch-norm
        statistics), the optimizer's state of every parameter, the dropout
        generator's state, ``best`` and ``epoch`` to ``npz_path(path)``
        (`graphax_torch.train.checkpoint`). Returns the path written."""
        arrays = {f"model/{k}": v for k, v in self.model.state_dict().items()}
        names = {id(p): n for n, p in self.model.named_parameters()}
        for p, st in self.optimizer.state.items():
            for k, v in st.items():
                arrays[f"optimizer/{names[id(p)]}/{k}"] = \
                    v if torch.is_tensor(v) else np.asarray(v, np.int64)
        arrays["generator"] = self.generator.get_state()
        for k, v in best.items():
            arrays[f"best/{k}"] = np.asarray(v)
        arrays["epoch"] = np.asarray(epoch, np.int64)
        return ckpt.save_checkpoint(path, arrays)

    def load_checkpoint(self, path: str) -> dict:
        """Restore what :meth:`save_checkpoint` saved, on this Trainer's
        device. Returns ``{"epoch": int, "best": dict}``."""
        arrays = ckpt.load_checkpoint(path)
        self.model.load_state_dict(
            {k[6:]: torch.from_numpy(v) for k, v in arrays.items()
             if k.startswith("model/")})
        params = dict(self.model.named_parameters())
        self.optimizer.state.clear()
        for k, v in arrays.items():
            if k.startswith("optimizer/"):
                _, name, key = k.split("/", 2)
                p = params[name]
                self.optimizer.state[p][key] = int(v) if key == "count" \
                    else torch.from_numpy(v).to(p.device, p.dtype)
        self.generator.set_state(torch.from_numpy(arrays["generator"]))
        best = {k[5:]: float(v) for k, v in arrays.items()
                if k.startswith("best/")}
        best["epoch"] = int(best["epoch"])
        return {"epoch": int(arrays["epoch"]), "best": best}

    def load_graphax_checkpoint(self, path: str) -> dict:
        """Restore a checkpoint that graphax's `Trainer.fit` wrote for the
        same config and data: the parameters and model state through
        `load_graphax_params`, and optax's state (the chain's
        ``add_decayed_weights`` state aside, which is empty) as the
        OptaxOptimizer's state of each parameter. Returns ``{"epoch": int,
        "best": dict}``; :meth:`save_checkpoint` with them writes a
        checkpoint that ``fit(checkpoint_path=...)`` resumes from.

        A JAX PRNG key has no torch counterpart: the dropout generator is
        seeded with the key's two uint32 words as one 64-bit integer
        (``(k0 << 32 | k1) % 2**63``), so a load is reproducible, but its
        dropout and label masks are not graphax's."""
        tree = ckpt.load_graphax_checkpoint(path)
        load_graphax_params(self.model, tree["params"], tree["model_state"])
        opt = tree["opt_state"]
        core = (opt[1] if self.cfg.decay else opt)[0]
        fields = _OPTAX_FIELDS[self.cfg.optimizer]
        if len(core) != len(fields):
            raise ValueError(f"load_graphax_checkpoint: {self.cfg.optimizer}"
                             f"'s state has {len(fields)} fields, the file "
                             f"{len(core)}")
        params = dict(self.model.named_parameters())
        self.optimizer.state.clear()
        for key, val in zip(fields, core):
            if key == "count":
                for p in params.values():
                    self.optimizer.state[p]["count"] = int(val)
                continue
            flat = graphax_to_state_dict(val)
            if set(flat) != set(params):
                raise KeyError(f"load_graphax_checkpoint: {key} holds "
                               f"{sorted(flat)}, the model "
                               f"{sorted(params)}")
            for name, arr in flat.items():
                p = params[name]
                self.optimizer.state[p][key] = torch.as_tensor(
                    np.array(arr), dtype=p.dtype, device=p.device)
        k0, k1 = (int(w) for w in np.asarray(tree["rng"], np.uint32)
                  .ravel()[:2])
        self.generator.manual_seed((k0 << 32 | k1) % 2 ** 63)
        best = {k: float(v) for k, v in tree["best"].items()}
        best["epoch"] = int(best["epoch"])
        return {"epoch": int(tree["epoch"]), "best": best}
