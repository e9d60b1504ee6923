"""Early-stop evaluation: observe accuracy along the test solve and keep the
best-validation snapshot (port of `graphax/models/early.py`).

The reference subclasses torchdiffeq's RK solvers (`EarlyStopDopri5` /
`EarlyStopRK4`, `src/early_stop_solver.py:71-128`): after each accepted
step it applies relu and a detached copy of the decoder m2, computes the
train/val/test accuracy, and keeps the best validation accuracy with its
train and test accuracy and its time, integrating to ``earlystopxT * T``
capped at ``max_test_steps``. Here, as in graphax, that is a solver
:class:`~graphax_torch.ode.Observer`; its carry stays on the state's device
(no host sync per step)."""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from graphax_torch.ode import ODEResult, Observer


def masked_accuracy(logits, labels, mask):
    correct = (logits.argmax(-1) == labels) & mask
    return correct.sum() / torch.clamp(mask.sum(), min=1)


def make_accuracy_observer(cfg, m2: nn.Linear, labels, train_mask, val_mask,
                           test_mask, base_dim: int) -> Observer:
    """Observer carrying ``best_train``, ``best_val``, ``best_test`` and
    ``best_time`` (graphax `:34-61`). ``m2`` is the decoder, detached as the
    reference copies `m2.weight.data.detach()` (`src/GNN_early.py:28-30`).
    A step replaces the carry only when its validation accuracy is strictly
    higher."""
    w, b = m2.weight.detach(), m2.bias.detach()
    dev = labels.device

    def update(carry, t, z):
        if cfg.augment:
            z = z[..., :base_dim]
        logits = nn.functional.linear(torch.relu(z).to(w.dtype), w, b)
        tr, va, te = (masked_accuracy(logits, labels, m)
                      for m in (train_mask, val_mask, test_mask))
        better = va > carry["best_val"]
        new = {"best_train": tr, "best_val": va, "best_test": te,
               "best_time": t.to(device=dev, dtype=torch.float32)}
        return {k: torch.where(better, new[k], carry[k]) for k in carry}

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return Observer(init={k: zero for k in ("best_train", "best_val",
                                            "best_test", "best_time")},
                    update=update)


class EarlyStopResult(NamedTuple):
    logits: torch.Tensor   # logits at the terminal time earlystopxT * T
    best_train: torch.Tensor
    best_val: torch.Tensor
    best_test: torch.Tensor
    best_time: torch.Tensor
    nfe: int
    result: ODEResult      # the solve (NFE, accepted steps, success)


@torch.no_grad()
def evaluate_early_stop(cfg, model, graph, x, labels, train_mask, val_mask,
                        test_mask, *, pos_encoding=None) -> EarlyStopResult:
    """The `GNNEarly` evaluation forward (graphax `:78-96`): integrate to
    ``earlystopxT * T`` with the accuracy observer, the adaptive loop's
    attempts capped at ``max_test_steps`` (`src/early_stop_solver.py:78,
    253`). ``pos_encoding``: Beltrami's, as the model's forward takes
    it."""
    base_dim = model.state_dim // 2 if cfg.augment else model.state_dim
    observer = make_accuracy_observer(cfg, model.m2, labels, train_mask,
                                      val_mask, test_mask, base_dim)
    model.eval()
    logits, out = model(graph, x, train=False,
                        t1=cfg.earlystopxT * cfg.time, observer=observer,
                        max_steps=cfg.max_test_steps,
                        pos_encoding=pos_encoding)
    best = out.result.observer
    return EarlyStopResult(
        logits=logits, best_train=best["best_train"],
        best_val=best["best_val"], best_test=best["best_test"],
        best_time=best["best_time"], nfe=out.result.nfe, result=out.result)
