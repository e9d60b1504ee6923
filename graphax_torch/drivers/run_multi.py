"""Multimodal / pixel-grid training driver (port of
`graphax/drivers/run_multi.py`, the twin of `src/run_multi.py`).

    python -m graphax_torch.drivers.run_multi --im_dataset MNIST
    python -m graphax_torch.drivers.run_multi --im_dataset CLEVR \\
        --device cpu

MNIST/CIFAR images become grid graphs and diffuse under the
`MultimodalGNN` (`src/GNN_multi.py`); the CLEVR-style path trains VQA
with cross-modal attention (the question features as the second modality
inside the ODE function). A batch runs through the model's batched route
(`MultimodalGNN.forward_batched`). The optimizers are the port's optax
twins: rmsprop (``decay=0.99``, eps inside the root) and adam; the
presets' ``decay`` (weight decay) is not applied, as graphax's driver does
not apply it. Everything runs on the card unless ``device="cpu"``
(``--device cpu``)."""

from __future__ import annotations

import argparse
import json
import time


def batch_loss(model, graph, xb, yb, *, train: bool, generator=None,
               x2s=None, graphs=None):
    """The driver's loss: the mean negative log-softmax of the true
    classes over the batch (graphax's ``loss_fn``)."""
    import torch

    logits, _ = model.forward_batched(graph, xb, train=train,
                                      generator=generator, x2s=x2s,
                                      graphs=graphs)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp[torch.arange(len(yb), device=logp.device), yb].mean()


def train_step(model, opt, graph, xb, yb, generator=None, x2s=None,
               graphs=None):
    """One optimizer step on a batch; returns the loss (a device scalar,
    detached: reading it would sync the host every step)."""
    opt.zero_grad(set_to_none=True)
    loss = batch_loss(model, graph, xb, yb, train=True, generator=generator,
                      x2s=x2s, graphs=graphs)
    loss.backward()
    opt.step()
    return loss.detach()


def train_image_dataset(name: str = "MNIST", epochs: int = 2,
                        batch_size: int = 4, train_size: int = 32,
                        test_size: int = 16, data_dir: str = "./data",
                        log: bool = True, seed: int = 0,
                        dp_devices: int = 0, device=None) -> dict:
    """graphax's `train_image_dataset`: the preset under euler at step
    0.25, rmsprop; each epoch trains ``train_size`` samples in batches
    drawn from the whole shuffled dataset (as graphax's), then the test
    accuracy over the last ``test_size`` samples in one batch. Returns
    ``history`` (epoch, loss, test_acc, time: the epoch's seconds ending in
    a device sync), ``model`` and ``final_test_acc``."""
    import numpy as np
    import torch

    from graphax_torch.data.multimodal import (get_image_dataset,
                                               multimodal_config)
    from graphax_torch.models.multimodal import MultimodalGNN
    from graphax_torch.train.optimizers import get_optimizer
    from graphax_torch.utils.device import resolve_device

    if dp_devices:
        raise NotImplementedError(
            "dp_devices > 0: data parallelism needs the sharded model, not "
            "ported yet (ROADMAP Queue 1, item 12)")
    dev = resolve_device(device)
    cfg, extra = multimodal_config(name, method="euler", step_size=0.25)
    ds = get_image_dataset(name, data_dir=data_dir,
                           size=train_size + test_size,
                           diags=extra.get("diags", True),
                           self_loop_weight=cfg.self_loop_weight, seed=seed,
                           device=dev)
    chan = ds.x.shape[-1]
    model = MultimodalGNN(cfg, num_nodes=ds.height * ds.width,
                          num_features=chan,
                          num_classes=ds.num_classes).to(dev)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    opt = get_optimizer("rmsprop", model.parameters(), cfg.lr)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    as_t = lambda a: torch.as_tensor(a, device=dev)
    xs_test, ys_test = as_t(ds.x[train_size:]), as_t(ds.y[train_size:])
    graph = ds.graph

    history = []
    for epoch in range(1, epochs + 1):
        t0 = time.perf_counter()
        losses = []
        for xb, yb in ds.batches(batch_size, seed=epoch):
            if len(losses) * batch_size >= train_size:
                break
            losses.append(train_step(model, opt, graph, as_t(xb), as_t(yb),
                                     gen))
        with torch.no_grad():
            logits, _ = model.forward_batched(graph, xs_test, train=False)
            acc = float((logits.argmax(-1) == ys_test).float().mean())
        loss = float(np.mean([float(v) for v in losses]))
        history.append(dict(epoch=epoch, loss=loss, test_acc=acc,
                            time=time.perf_counter() - t0))
        if log:
            print(f"[{name}] epoch {epoch} loss {loss:.4f} test_acc "
                  f"{acc:.4f} ({history[-1]['time']:.1f}s)")
    return {"history": history, "model": model,
            "final_test_acc": history[-1]["test_acc"]}


def clevr_config(text_dim: int):
    """`train_clevr_style`'s config (graphax :142-145)."""
    from graphax_torch.train.config import Config

    return Config(multi_modal=True, second_modality_dim=text_dim,
                  method="euler", step_size=0.5, time=1.0,
                  self_loop_weight=1.0, input_dropout=0.1, dropout=0.1,
                  lr=0.005)


def train_clevr_style(epochs: int = 2, batch_size: int = 4,
                      num_samples: int = 32, cache_path=None,
                      data_dir=None, log: bool = True, seed: int = 0,
                      real_clevr: bool = False, split: str = "train",
                      build_kwargs=None, device=None) -> dict:
    """CLEVR-style VQA (graphax's `train_clevr_style`): grid-graph
    diffusion over image features with cross-modal attention against the
    question tokens, adam. ``real_clevr=True`` trains on the staged
    CLEVR_v1.0 split (`graphax_torch.data.clevr`), ``build_kwargs`` going
    to its HDF5 build; otherwise the synthetic stand-in, where
    ``build_kwargs`` (grid, feat_dim, text_dim, max_question_len,
    num_classes) go to `build_clevr_style_dataset`. Returns ``history``
    (epoch, loss, time) and ``model``."""
    import numpy as np
    import torch

    from graphax_torch.data.multimodal import build_clevr_style_dataset
    from graphax_torch.models.multimodal import MultimodalGNN
    from graphax_torch.train.optimizers import get_optimizer
    from graphax_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if real_clevr:
        from graphax_torch.data.clevr import load_clevr

        ds = load_clevr(data_dir, split=split, build_kwargs=build_kwargs,
                        device=dev)
    else:
        ds = build_clevr_style_dataset(num_samples=num_samples,
                                       cache_path=cache_path,
                                       data_dir=data_dir, seed=seed,
                                       device=dev, **(build_kwargs or {}))
    cfg = clevr_config(ds.questions.shape[-1])
    model = MultimodalGNN(cfg, num_nodes=ds.images.shape[1],
                          num_features=ds.images.shape[-1],
                          num_classes=ds.num_classes).to(dev)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    opt = get_optimizer("adam", model.parameters(), cfg.lr)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    as_t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    graph = ds.image_graph

    history = []
    for epoch in range(1, epochs + 1):
        t0 = time.perf_counter()
        losses = [train_step(model, opt, graph, as_t(xb), as_t(yb), gen,
                             x2s=as_t(qb))
                  for xb, qb, yb, _sel in ds.batches(batch_size, seed=epoch)]
        loss = float(np.mean([float(v) for v in losses]))
        history.append(dict(epoch=epoch, loss=loss,
                            time=time.perf_counter() - t0))
        if log:
            print(f"[CLEVR-style] epoch {epoch} loss {loss:.4f}")
    return {"history": history, "model": model}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--im_dataset", default="MNIST",
                   choices=["MNIST", "CIFAR", "CLEVR"])
    p.add_argument("--epoch", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--train_size", type=int, default=32)
    p.add_argument("--test_size", type=int, default=16)
    p.add_argument("--data_dir", default="./data")
    p.add_argument("--dp_devices", type=int, default=0)
    p.add_argument("--real_clevr", action="store_true",
                   help="train on the staged CLEVR_v1.0 raw data "
                        "(scripts/fetch_data.py --only clevr) instead of "
                        "the synthetic stand-in")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    if args.im_dataset == "CLEVR":
        out = train_clevr_style(epochs=args.epoch,
                                batch_size=args.batch_size,
                                num_samples=args.train_size,
                                data_dir=args.data_dir,
                                real_clevr=args.real_clevr,
                                device=args.device)
    else:
        out = train_image_dataset(args.im_dataset, epochs=args.epoch,
                                  batch_size=args.batch_size,
                                  train_size=args.train_size,
                                  test_size=args.test_size,
                                  data_dir=args.data_dir,
                                  dp_devices=args.dp_devices,
                                  device=args.device)
    print(json.dumps({"history": out["history"]}))
    return out


if __name__ == "__main__":
    main()
