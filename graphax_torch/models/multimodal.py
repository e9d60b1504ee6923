"""Multimodal / image-grid GNN classifier, `GNN_multimodal`
(`src/GNN_multi.py`; port of `graphax/models/multimodal.py`).

Forward (`:27-49`): dropout -> ODE block (with the cross-modal attention
against a second modality inside the RHS) -> relu -> dropout -> flatten
all node features -> one linear layer to the class logits. Used for
MNIST/CIFAR pixel-grid diffusion and CLEVR VQA
(`graphax_torch.drivers.run_multi`). Parameters are named after graphax's
tree ``{block, m2}``, so `load_graphax_params` fills the model.

graphax batches by ``jax.vmap`` over one graph forward. Here
:meth:`MultimodalGNN.forward_batched` runs the batch through ONE solve
where that equals the per-sample solves (:func:`one_solve`):

- one dense graph shared by the batch (the pixel grids), the constant
  block on the Laplacian RHS: the state is ``[B, N, D]`` against one
  ``[N, N]`` operator, one product an evaluation, the cross-modal
  attention batched;
- per-sample graphs (a `GraphBatch`, the question chains) or a shared
  sparse graph: their block-diagonal union (`GraphBatch.union`) with the
  state ``[B N, D]``, so ``spmm_csr`` (or GRAND-nl's flash kernels) runs
  once an evaluation for the whole batch and the attention block's pin
  once a forward. The constant and attention blocks on the Laplacian,
  GAT and row-normalised GRAND-nl RHS take it: each row's softmax is its
  sample's.

What vmap takes per sample stays per sample. An adaptive method's error
ratio, step size, budget and NFE: one solve keeps them per sample
(`graphax_torch.ode.odeint`'s ``samples``), every evaluation on the
whole batch, so the kernels launch as often as the slowest sample's NFE
says. Squareplus's global shift, the hard block's quantile and the column
route's ``attention_gmax``: the configs that reach one of them, the
adjoint and the regularisers in training, and the rest (the other
blocks, and every RHS but the constant block's Laplacian on a dense
grid) solve each sample alone, B solves an evaluation, so a batch-global
value never enters a result. Dropout draws from an explicit
``torch.Generator``: the input mask for the whole batch, then the output
mask, on either route."""

from __future__ import annotations

import torch
from torch import nn

from graphax_torch.blocks import get_block
from graphax_torch.data.multimodal import GraphBatch
from graphax_torch.models.layers import dropout
from graphax_torch.utils.params import linear_apply, linear_init


def one_solve(cfg, train: bool, dense: bool) -> bool:
    """Whether a batch runs through one solve (the rest solve each sample
    alone): no regulariser or adjoint in training (the adjoint's backward
    controller would be the batch's), the constant or the attention block,
    and on one dense graph (``dense``) the constant block's Laplacian RHS;
    on a union the Laplacian, GAT or row-normalised GRAND-nl RHS (each
    row's softmax is its sample's; the column route's shift is
    ``attention_gmax``'s over every edge), with no squareplus where
    attention is taken (its shift is the max over every edge)."""
    if train and (cfg.reg_coeffs() or cfg.adjoint):
        return False
    if cfg.block not in ("constant", "attention"):
        return False
    if dense:
        return cfg.block == "constant" and cfg.function == "laplacian"
    if cfg.square_plus and (cfg.block == "attention"
                            or cfg.function == "transformer"):
        return False
    return cfg.function in ("laplacian", "GAT") or (
        cfg.function == "transformer" and cfg.attention_norm_idx == 0)


class MultimodalGNN(nn.Module):
    """``num_nodes`` is fixed (grid and chain graphs have one size)
    because the decoder flattens every node's features (`:46-48`)."""

    def __init__(self, cfg, num_nodes: int, num_features: int,
                 num_classes: int):
        super().__init__()
        self.cfg = cfg
        self.num_nodes = num_nodes
        self.block = get_block(cfg, num_features)
        self.m2 = nn.Linear(num_nodes * num_features, num_classes)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.block.reset_parameters(generator)
        linear_init(self.m2, generator)

    def _decode(self, z, train: bool, generator):
        """relu -> dropout -> m2 over the flattened nodes (the leading axes
        kept)."""
        z = dropout(torch.relu(z), self.cfg.dropout, train, generator)
        return linear_apply(self.m2, z.reshape(*z.shape[:-2], -1))

    def forward(self, graph, x, *, train: bool = False, generator=None,
                x2=None):
        """One sample: ``x [N, D]``, ``x2 [M, D2]`` the second modality.
        Returns (logits ``[C]``, aux: ``nfe``, ``reg_states``,
        ``success``)."""
        x = dropout(x, self.cfg.input_dropout, train, generator)
        out = self.block(graph, x, train=train, y=x2)
        aux = {"nfe": out.result.nfe, "reg_states": out.reg_states,
               "success": out.result.success}
        return self._decode(out.z, train, generator), aux

    def forward_batched(self, graph, xs, *, train: bool = False,
                        generator=None, x2s=None, graphs=None):
        """Batch forward: ``xs [B, N, D]``, ``x2s [B, M, D2]``. ``graph``
        is one topology shared by every sample (pixel grids); ``graphs``, a
        `GraphBatch`, gives each sample its own (the reference's ``[B, 2,
        E]`` edge lists, `src/GNN_multi.py:27-49`). Returns (logits ``[B,
        C]``, aux with ``nfe`` and ``success`` per sample and
        ``reg_states`` stacked on a leading batch axis)."""
        cfg = self.cfg
        b, n, d = xs.shape
        x = dropout(xs, cfg.input_dropout, train, generator)
        dense = graphs is None and graph.strategy == "dense"
        if one_solve(cfg, train, dense):
            if dense:
                out = self.block(graph, x, train=train, y=x2s, samples=b)
                z = out.z
            else:
                batch = graphs if graphs is not None \
                    else GraphBatch.repeated(graph, b)
                out = self.block(batch.union(), x.reshape(b * n, d),
                                 train=train, y=x2s, samples=b)
                z = out.z.reshape(b, n, d)
            aux = {"nfe": out.result.sample_nfe,
                   "success": out.result.sample_success, "reg_states": ()}
        else:
            outs = [self.block(graph if graphs is None else graphs.sample(i),
                               x[i], train=train,
                               y=None if x2s is None else x2s[i])
                    for i in range(b)]
            z = torch.stack([o.z for o in outs])
            aux = {"nfe": [o.result.nfe for o in outs],
                   "success": [o.result.success for o in outs],
                   "reg_states": tuple(
                       torch.stack([o.reg_states[j] for o in outs])
                       for j in range(len(outs[0].reg_states)))}
        return self._decode(z, train, generator), aux

    @torch.no_grad()
    def forward_plot_path(self, graph, x, frames: int, *, x2=None):
        """States after each of ``frames`` successive [0, T] solves
        (`forward_plot_path`, `:51-100`), x first: ``[frames + 1, N,
        D]``."""
        path = [x]
        for _ in range(frames):
            path.append(self.block(graph, path[-1], train=False, y=x2).z)
        return torch.stack(path)

    @torch.no_grad()
    def forward_plot_t(self, graph, x, frames: int, *, x2=None):
        """States at ``frames`` evenly spaced times of ONE [0, T]
        trajectory (`forward_plot_T`, `:51-72`), solved piecewise so frame k
        is x(k T / frames), x first."""
        seg = self.cfg.time / frames
        path = [x]
        for _ in range(frames):
            path.append(self.block(graph, path[-1], train=False, y=x2,
                                   t1=seg).z)
        return torch.stack(path)
