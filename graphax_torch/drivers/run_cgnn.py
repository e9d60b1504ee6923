"""CGNN (ICML'20) baseline driver (port of `graphax/drivers/run_cgnn.py`,
`src/CGNN.py`'s main, train and test loop).

    python -m graphax_torch.drivers.run_cgnn --dataset Cora --epoch 50
"""

from __future__ import annotations

import argparse
import json
from time import perf_counter


def train_cgnn(dataset: str = "Cora", epochs: int = 50, data_dir="./data",
               hidden_dim: int = 16, time: float = 1.0, lr: float = 0.01,
               log_every: int = 10, seed: int = 0, device=None,
               data=None) -> dict:
    """graphax's `train_cgnn`: Adam on the masked cross-entropy, an
    evaluation each epoch, the best validation epoch. ``data`` (a
    GraphData) stands in for the dataset by name where given. Returns
    graphax's ``best`` (``val_acc``, ``test_acc``, ``epoch``) with
    ``history``: each epoch's loss, seconds and the train and evaluation
    solves' NFE and success."""
    import torch

    from graphax_torch.data import get_dataset
    from graphax_torch.models.cgnn import make_cgnn, normalize_for_cgnn
    from graphax_torch.models.early import masked_accuracy
    from graphax_torch.train import Config
    from graphax_torch.train.loop import cross_entropy_loss
    from graphax_torch.train.optimizers import get_optimizer
    from graphax_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = Config(dataset=dataset, hidden_dim=hidden_dim, time=time,
                 method="dopri5", tol_scale=100.0, lr=lr,
                 input_dropout=0.5, dropout=0.0)
    if data is None:
        data = get_dataset(cfg, data_dir=data_dir, device=dev)
    data = data.to(dev)
    model = make_cgnn(cfg, data.num_features, data.num_classes).to(dev)
    model.init_for_graph(data.graph, torch.Generator().manual_seed(seed))
    g = normalize_for_cgnn(data.graph)
    opt = get_optimizer("adam", model.parameters(), cfg.lr)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    best = {"val_acc": 0.0, "test_acc": 0.0}
    history = []
    for epoch in range(1, epochs + 1):
        t0 = perf_counter()
        model.train()
        opt.zero_grad(set_to_none=True)
        logits, aux = model(g, data.x, train=True, generator=gen)
        loss = cross_entropy_loss(logits, data.y, data.train_mask)
        loss.backward()
        opt.step()
        with torch.no_grad():
            logits, ev = model(g, data.x, train=False)
            tr, va, te = (float(masked_accuracy(logits, data.y, m)) for m in
                          (data.train_mask, data.val_mask, data.test_mask))
        history.append(dict(epoch=epoch, loss=float(loss.detach()),
                            seconds=perf_counter() - t0,
                            nfe=aux["nfe"], success=aux["success"],
                            eval_nfe=ev["nfe"], eval_success=ev["success"]))
        if va > best["val_acc"]:
            best.update(val_acc=va, test_acc=te, epoch=epoch)
        if log_every and epoch % log_every == 0:
            print(f"[CGNN] epoch {epoch} loss {float(loss):.4f} "
                  f"val {va:.4f} test {te:.4f}")
    return dict(best, history=history)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="Cora")
    p.add_argument("--epoch", type=int, default=50)
    p.add_argument("--hidden_dim", type=int, default=16)
    p.add_argument("--time", type=float, default=1.0)
    p.add_argument("--data_dir", default="./data")
    args = p.parse_args(argv)
    out = train_cgnn(args.dataset, epochs=args.epoch,
                     hidden_dim=args.hidden_dim, time=args.time,
                     data_dir=args.data_dir)
    out.pop("history")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
