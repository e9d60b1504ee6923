"""Transformer attention, as far as the attention pin needs it.

Port of the parts of `graphax/functions/transformer.py` the hard-attention
block uses: the attention layer's parameters (`transformer_attention_init`,
constant 1e-5 weights so Q = K and attention is uniform at init) and
`attention_edge_means` (:162-189), which pins the head-mean row-softmax
attention per edge through the `attention_pin` kernel. The Q projection is
a dense matmul here, as graphax leaves it to XLA.

The per-NFE transformer RHS (GRAND-nl), Beltrami and column/squareplus
normalisation are not ported yet (ROADMAP Queue 2, K2/K3)."""

from __future__ import annotations

import torch
from torch import nn

from graphax_torch.kernels.attention_pin import attention_pin
from graphax_torch.utils.params import linear_apply, linear_init


class TransformerAttention(nn.Module):
    """Q/K/V projections into ``attention_dim`` over ``heads``, plus Wout and
    (exp_kernel) the Gaussian kernel's output_var and lengthscale."""

    def __init__(self, cfg, in_dim: int):
        super().__init__()
        if cfg.beltrami:
            raise NotImplementedError("Beltrami attention is not ported yet "
                                      "(ROADMAP Queue 1, M6)")
        att = cfg.attention_dim
        self.cfg = cfg
        self.Q = nn.Linear(in_dim, att)
        self.K = nn.Linear(in_dim, att)
        self.V = nn.Linear(in_dim, att)
        if cfg.attention_type == "exp_kernel":
            self.output_var = nn.Parameter(torch.ones(()))
            self.lengthscale = nn.Parameter(torch.ones(()))
        self.Wout = nn.Linear(att // cfg.heads, in_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in (self.Q, self.K, self.V, self.Wout):
            linear_init(layer, generator, "const", 1e-5)
        if self.cfg.attention_type == "exp_kernel":
            nn.init.ones_(self.output_var)
            nn.init.ones_(self.lengthscale)


def attention_means_supported(cfg) -> bool:
    """Configs the pin covers (graphax `attention_means_supported`)."""
    return (cfg.attention_norm_idx == 0 and not cfg.square_plus
            and not cfg.mix_features and not cfg.multi_modal
            and not cfg.beltrami)


def attention_edge_means(att: TransformerAttention, cfg, graph, x
                         ) -> torch.Tensor:
    """Head-mean normalised attention per edge, ``[E_pad]`` (0 on padding).
    Not differentiable: callers run it under no_grad.

    On the sparse strategy it follows graphax's kernel path: q, x and Wk in
    the state dtype, the result cast to it. graphax takes that path only on
    its tiled strategy (`graphax/functions/transformer.py:175-187`); on a
    windowed graph it pins through XLA, where ``x @ w`` promotes a bf16 x to
    f32, so there q, x and Wk go to the kernel in f32 and the result stays
    f32."""
    if not attention_means_supported(cfg):
        raise NotImplementedError(
            "the pin covers row softmax only; column or squareplus "
            "normalisation is ROADMAP Queue 2, K2")
    heads = cfg.heads
    dtype = x.dtype
    if graph.strategy == "windowed":
        dtype = torch.promote_types(dtype, torch.float32)
        x = x.to(dtype)
    q = linear_apply(att.Q, x)                              # f32
    if cfg.attention_type == "scaled_dot":
        q = q / torch.sqrt(torch.tensor(cfg.attention_dim // heads,
                                        dtype=torch.float32, device=q.device))
    q = q.to(dtype).contiguous()
    wk = att.K.weight.t().to(dtype).contiguous()            # [D, A]
    bk = att.K.bias.to(torch.float32).contiguous()
    ov2 = inv2l2 = 0.0
    if cfg.attention_type == "exp_kernel":
        ov2 = float(att.output_var ** 2)
        inv2l2 = float(1.0 / (2.0 * att.lengthscale ** 2))
    edge_w = graph.edge_weight.float().contiguous() \
        if cfg.reweight_attention else None
    mean = attention_pin(graph.csr, q, x.detach().contiguous(), wk, bk,
                         edge_w, cfg.attention_type, heads, ov2, inv2l2)
    out = torch.zeros(graph.edge_buffer_size, dtype=torch.float32,
                      device=x.device)
    out[:graph.num_edges] = mean
    return out.to(dtype)
