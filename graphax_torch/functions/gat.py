"""GAT-style attention diffusion (port of `graphax/functions/gat.py`, the
twin of `SpGraphAttentionLayer` + `ODEFuncAtt`,
`src/function_GAT_attention.py`).

A shared projection ``W`` into ``attention_dim``, per-edge scores
``LeakyReLU(a . [h_src | h_dst])`` with one ``a`` vector shared by every
head, a softmax over the ``attention_norm_idx`` endpoint, then the RHS
``alpha (A x - x) [+ beta x0]``: A the head mean of the attention, or under
``mix_features`` each head's A over the whole ``W x``, their mean through
``Wout``.

``A x`` is the CSR SpMM of `graphax_torch.kernels.spmm` (the `spmm_csr`
kernel on the card, its CSC transpose and `sddmm` in the backward for x
and the attention values), the port's counterpart of graphax's tiled
SpMM; every graph carries the CSR layout, so it serves each strategy.
The scores, the softmax and the ``mix_features`` product are plain
PyTorch, as graphax leaves them to XLA. Parameters as graphax's tree:
``att.W [in, A]``, ``att.Wout [A, in]``, ``att.a [2 A / H]``,
``alpha_train``, ``beta_train``."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from graphax_torch.functions.common import apply_alpha_beta, init_alpha_beta
from graphax_torch.kernels.dispatch import (
    segment_softmax_auto, spmm_multihead_auto,
)
from graphax_torch.kernels.spmm import spmm, transpose_values


def xavier_normal_(t: torch.Tensor, generator: torch.Generator,
                   gain: float = 1.0) -> torch.Tensor:
    """torch's ``xavier_normal_`` from ``generator`` (graphax's
    `xavier_normal`: the fans of a shape of more than two dims count its
    receptive field)."""
    shape = t.shape
    rf = math.prod(shape[2:]) if len(shape) > 2 else 1
    fan_in, fan_out = (shape[1] * rf, shape[0] * rf) if len(shape) >= 2 \
        else (shape[0], shape[0])
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.copy_(std * torch.randn(shape, generator=generator,
                                  device=generator.device).to(t.device))
    return t


class GATAttention(nn.Module):
    def __init__(self, cfg, in_dim: int):
        super().__init__()
        if cfg.multi_modal:
            raise NotImplementedError("multimodal cross-attention is not "
                                      "ported yet (ROADMAP Queue 1, item 10)")
        att = cfg.attention_dim
        self.cfg = cfg
        self.W = nn.Parameter(torch.empty(in_dim, att))
        self.Wout = nn.Parameter(torch.empty(att, in_dim))
        self.a = nn.Parameter(torch.empty(2 * (att // cfg.heads)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        xavier_normal_(self.W, generator, 1.414)
        xavier_normal_(self.Wout, generator, 1.414)
        dk2 = self.a.shape[0]
        a = xavier_normal_(torch.empty(1, dk2, 1, 1), generator, 1.414)
        with torch.no_grad():
            self.a.copy_(a.reshape(dk2))


def gat_attention_apply(att, cfg, graph, x):
    """(attention ``[E_pad, H]`` normalised over the real edges of each row
    or column, ``W x [N, A]``), graphax's `gat_attention_apply`."""
    wx = x.to(att.W.dtype) @ att.W
    dk = cfg.attention_dim // cfg.heads
    h = wx.reshape(x.shape[0], cfg.heads, dk)
    scores = h[graph.row] @ att.a[:dk] + h[graph.col] @ att.a[dk:]
    scores = nn.functional.leaky_relu(scores, cfg.leaky_relu_slope)
    attention = segment_softmax_auto(graph, scores,
                                     cfg.attention_norm_idx == 0,
                                     graph.edge_mask)
    return attention, wx


def gat_ax(cfg, att, graph, x):
    """``A(x) x`` of the GAT RHS, in x's dtype (under ``mix_features`` in
    Wout's)."""
    attention, wx = gat_attention_apply(att, cfg, graph, x)
    mask = graph.edge_mask
    if cfg.mix_features:
        att_m = attention * mask[:, None]
        wx_h = wx[:, None, :].expand(wx.shape[0], cfg.heads, wx.shape[1])
        return spmm_multihead_auto(graph, att_m, wx_h).mean(1) @ att.Wout
    mean = torch.where(mask, attention.mean(1), torch.zeros_like(
        attention[:, 0]))
    wb = mean.to(x.dtype).contiguous()
    return spmm(graph, wb, transpose_values(graph, wb), x)


class _GATTensors(NamedTuple):
    """The attention tensors the adjoint hands `gat_rhs`."""
    W: torch.Tensor
    a: torch.Tensor
    Wout: torch.Tensor | None


def gat_rhs(cfg, graph, p, x):
    """``alpha (A(x) x - x) [+ beta x0]`` as a function of its tensors ``p =
    (alpha, beta, x0, W, a[, Wout])`` (the adjoint differentiates it with
    respect to each)."""
    alpha, beta, x0, w, a, *rest = p
    att = _GATTensors(w, a, rest[0] if rest else None)
    return apply_alpha_beta(cfg, alpha, beta, gat_ax(cfg, att, graph, x), x,
                            x0)


class GATFunction(nn.Module):
    """``f = alpha (A(x) x - x) [+ beta x0]`` with A the GAT attention of
    the current state, recomputed at every solver evaluation (graphax
    `make_gat`)."""

    def __init__(self, cfg, in_dim: int):
        super().__init__()
        self.cfg = cfg
        init_alpha_beta(self)
        self.att = GATAttention(cfg, in_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.alpha_train)
        nn.init.zeros_(self.beta_train)
        self.att.reset_parameters(generator)

    def adjoint_tensors(self) -> tuple:
        """The attention tensors `gat_rhs` reads after alpha, beta and x0."""
        att = self.att
        return (att.W, att.a) + ((att.Wout,) if self.cfg.mix_features
                                 else ())

    def rhs(self, alpha, beta, fstate, t, x):
        return apply_alpha_beta(self.cfg, alpha, beta,
                                gat_ax(self.cfg, self.att, fstate.graph, x),
                                x, fstate.x0)
