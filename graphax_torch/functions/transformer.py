"""GRAND-nl: transformer attention diffusion (port of
`graphax/functions/transformer.py`).

- The attention layer's parameters (`transformer_attention_init`: constant
  1e-5 weights, so Q = K and attention is uniform at init).
- `transformer_attention_apply` (:112-155) and `multiply_attention`
  (:192-198): the plain per-edge path, every score type, row or column
  normalisation, softmax or squareplus, reweighting. It is the oracle the
  tests hold the kernels to, and the replay behind the column route's
  gradient.
- `attention_edge_means` (:162-189): the blocks' per-edge pin, through
  the `attention_pin` kernel where no gradient is needed and the kernel
  covers the config, else through the plain per-edge path with autograd.
- `TransformerFunction`, the twin of `make_transformer` (:259-314), and
  `transformer_rhs`, its RHS as a function of its tensors (the adjoint
  hands it detached copies). Its routes, as graphax's dispatch
  (:270-313), through :func:`attention_ax`:
  - the dense strategy's evaluation through `dense_rhs_ax` (:201-243), the
    masked flash kernel (K6, `graphax_torch.kernels.flash_dense`) on the
    card where graphax's gate holds, else the materialised
    `dense_transformer_attention`;
  - the windowed strategy (row normalisation): softmax through the
    windowed attention kernel K5 and the three-kernel form on the residual
    (`graphax_torch.kernels.winatt`), its gradient the replay of the plain
    twin of graphax's `windowed_attention_ax`
    (`graphax_torch.kernels.windowed_attention`); squareplus through that
    twin itself, as graphax takes its XLA function there;
  - the sparse strategy with column normalisation: the three-kernel form
    with the column denominators (`graphax_torch.kernels.attention3`), its
    gradient the replay of the plain per-edge path;
  - the sparse strategy with row normalisation through
    `graphax_torch.kernels.fused_attention.fused_attention_ax`: the flash
    kernels for an evaluation, the training kernels (forward with
    residuals, row-side and column-side backward) where a gradient is
    needed.

The Q and K projections are dense matmuls here, as graphax leaves them to
XLA. Not ported yet, and raising: row-normalised training on CSR outside
the hand-written backward (graphax's XLA fused_attention_ax autodiff),
column normalisation on the windowed strategy, training on the dense
strategy (below K6's gate the materialised route, ROADMAP Queue 1 item 3b;
above it graphax has no gradient through K6), and Beltrami, mix_features
and multi_modal (ROADMAP Queue 1 M6/M9, Queue 3)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from graphax_torch.functions.common import apply_alpha_beta, init_alpha_beta
from graphax_torch.kernels.attention_pin import attention_pin
from graphax_torch.kernels.dense_path import (
    dense_adjacency_mask, dense_matmul, dense_transformer_attention,
    use_dense_attention,
)
from graphax_torch.kernels.attention3 import (
    ReplayAttention, colnorm_attention_ax_fast, colnorm_supported,
)
from graphax_torch.kernels.dispatch import (
    attention_spmm_auto, segment_softmax_auto, squareplus_auto,
)
from graphax_torch.kernels.flash_dense import flash_attention_multihead
from graphax_torch.kernels.fused_attention import (
    COS_EPS, flash_supported, fused_attention_ax, prep_inputs,
)
from graphax_torch.kernels.windowed_attention import \
    windowed_attention_ax_plain
from graphax_torch.kernels.winatt import windowed_attention_ax_fast
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


def attention_edge_means(att: TransformerAttention, cfg, graph, x, *,
                         differentiable: bool) -> torch.Tensor:
    """Head-mean normalised attention per edge, ``[E_pad]`` (0 on padding):
    the blocks' pin (graphax `attention_edge_means`, :162-189).

    Without ``differentiable``, for a config that
    :func:`attention_means_supported` covers, the `attention_pin` kernel,
    outside autograd. On the sparse strategy it follows graphax's kernel
    path: q, x and Wk in the state dtype, the result cast to it. graphax
    takes that path only on its tiled strategy (:175-187); on a windowed or
    dense graph it pins through XLA, where ``x @ w`` promotes a bf16 x to
    f32, so there q, x and Wk go to the kernel in f32 and the result stays
    f32 (the kernel's scores against graphax's: f32 sums in another order).

    Otherwise graphax's per-edge route (:188-189): ``edge_attention``'s
    head mean, with autograd, in the dtype the projections promote x to
    (f32 for a bf16 state). The attention and mixed blocks take it for
    training, where the gradient reaches their attention layer through the
    pinned operator, and every config outside the kernel's gate (column
    normalisation, squareplus) takes it in evaluation too."""
    if differentiable or not attention_means_supported(cfg):
        return edge_attention(att, cfg, graph, x)[0].mean(1)
    if graph.strategy != "sparse":
        x = x.to(torch.promote_types(x.dtype, torch.float32))
    with torch.no_grad():
        x = x.detach().contiguous()
        p = prep_inputs(cfg, att, graph, x)
        mean = attention_pin(graph.csr, p["q"], x, p["wk"], p["bk"],
                             p["edge_w"], p["att_type"], p["heads"],
                             p["ov2"], p["inv2l2"])
        out = torch.zeros(graph.edge_buffer_size, dtype=torch.float32,
                          device=x.device)
        out[:graph.num_edges] = mean
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# the plain per-edge path
# ----------------------------------------------------------------------

def _split_heads(z, heads: int):
    """``[N, A] -> [N, H, A / H]``, head-major (`:78-82`)."""
    return z.reshape(z.shape[0], heads, z.shape[1] // heads)


def _cosine(a, b):
    na = torch.clamp(torch.linalg.vector_norm(a, dim=-1), min=COS_EPS)
    nb = torch.clamp(torch.linalg.vector_norm(b, dim=-1), min=COS_EPS)
    return (a * b).sum(-1) / (na * nb)


def _edge_scores(cfg, att, q_src, k_dst):
    """``[E, H, Dh]`` gathered q[row] and k[col] -> ``[E, H]`` (`:85-103`)."""
    d_k = q_src.shape[-1]
    if cfg.attention_type == "scaled_dot":
        return (q_src * (k_dst / math.sqrt(d_k))).sum(-1)
    if cfg.attention_type == "cosine_sim":
        return _cosine(q_src, k_dst)
    if cfg.attention_type == "pearson":
        return _cosine(q_src - q_src.mean(-1, keepdim=True),
                       k_dst - k_dst.mean(-1, keepdim=True))
    if cfg.attention_type == "exp_kernel":
        sq = ((q_src - k_dst) ** 2).sum(-1)
        return att.output_var ** 2 * torch.exp(
            -sq / (2 * att.lengthscale ** 2))
    raise ValueError(f"unknown attention_type {cfg.attention_type!r}")


def edge_attention(att, cfg, graph, x):
    """(attention ``[E_pad, H]`` normalised over the real edges of each row
    (``attention_norm_idx=0``) or column, the raw scores ``[E_pad, H]``):
    the part of `transformer_attention_apply` that reads only Q and K."""
    if cfg.multi_modal:
        raise NotImplementedError("multimodal cross-attention is not ported "
                                  "yet (ROADMAP Queue 1, M9)")
    heads = cfg.heads
    q = _split_heads(linear_apply(att.Q, x), heads)
    k = _split_heads(linear_apply(att.K, x), heads)
    prods = _edge_scores(cfg, att, q[graph.row], k[graph.col])
    if cfg.reweight_attention:
        prods = prods * graph.edge_weight[:, None]
    is_row = cfg.attention_norm_idx == 0
    mask = graph.edge_mask
    if cfg.square_plus:
        attention = squareplus_auto(graph, prods, is_row, mask)
    else:
        attention = segment_softmax_auto(graph, prods, is_row, mask)
    return attention, prods


def transformer_attention_apply(att: TransformerAttention, cfg, graph, x):
    """(attention ``[E_pad, H]`` normalised over the real edges of each row
    (``attention_norm_idx=0``) or column, (v ``[N, H, Dh]``, the raw scores
    ``[E_pad, H]``))."""
    attention, prods = edge_attention(att, cfg, graph, x)
    v = _split_heads(linear_apply(att.V, x), cfg.heads)
    return attention, (v, prods)


def multiply_attention(att: TransformerAttention, cfg, graph, x, attention,
                       v):
    """`ODEFuncTransformerAtt.multiply_attention` without mix_features:
    ``A x`` with the head-mean attention as A's values."""
    if cfg.mix_features:
        raise NotImplementedError("mix_features is not ported yet (ROADMAP "
                                  "Queue 1, M6)")
    return attention_spmm_auto(graph, attention, x, mask=graph.edge_mask)


# ----------------------------------------------------------------------
# the RHS
# ----------------------------------------------------------------------

_UNPORTED_RHS = "GRAND-nl {}: not ported yet (ROADMAP {})"


class _Linear(NamedTuple):
    weight: torch.Tensor
    bias: torch.Tensor


class _Att(NamedTuple):
    """The attention layer's Q and K (and exp_kernel's output_var and
    lengthscale) as plain tensors, for the routes of :func:`attention_ax`.
    :meth:`flatten` and :meth:`from_flat` hold their one flat layout, that
    of the adjoint's tensors and of :class:`ReplayAttention`'s: ``(Wq, bq,
    Wk, bk[, output_var, lengthscale])``."""
    Q: _Linear
    K: _Linear
    output_var: torch.Tensor | None = None
    lengthscale: torch.Tensor | None = None

    @staticmethod
    def flatten(cfg, att) -> tuple:
        """``att``'s tensors (of an `_Att` or the layer) in the flat
        layout."""
        out = (att.Q.weight, att.Q.bias, att.K.weight, att.K.bias)
        if cfg.attention_type == "exp_kernel":
            out += (att.output_var, att.lengthscale)
        return out

    @classmethod
    def from_flat(cls, cfg, flat) -> tuple:
        """(the `_Att` at the front of ``flat``, the tensors after it)."""
        qw, qb, kw, kb, *rest = flat
        ov = ls = None
        if cfg.attention_type == "exp_kernel":
            ov, ls, *rest = rest
        return cls(_Linear(qw, qb), _Linear(kw, kb), ov, ls), tuple(rest)


def flash_dense_gate(cfg, n: int) -> bool:
    """graphax's gate for K6 (`:218-223`, with the card in place of its
    TPU): scaled_dot, row softmax, no squareplus, mix_features or
    reweight, and ``[H, N, N]`` f32 scores above 2^28 bytes."""
    return (cfg.attention_type == "scaled_dot"
            and cfg.attention_norm_idx == 0
            and not cfg.square_plus and not cfg.mix_features
            and not cfg.reweight_attention
            and n * n * cfg.heads * 4 > (1 << 28))


def dense_rhs_ax(att: TransformerAttention, cfg, graph, x, mask=None,
                 use_flash=None) -> torch.Tensor:
    """``A(x) x`` on a dense graph (graphax `dense_rhs_ax`, :201-243), in
    x's dtype. Where ``use_flash`` (default: x on the card and
    :func:`flash_dense_gate`), the masked flash kernel per head on q
    pre-scaled by ``1 / sqrt(dk)`` (computed in x's dtype, as graphax), then
    the head mean in f32; else the materialised ``[H, N, N]`` attention's
    head mean times x, f32 sums. ``mask`` is the graph's adjacency mask if
    the caller has it."""
    q = _split_heads(linear_apply(att.Q, x), cfg.heads)
    k = _split_heads(linear_apply(att.K, x), cfg.heads)
    if use_flash is None:
        use_flash = x.is_cuda and flash_dense_gate(cfg, graph.num_nodes)
    if mask is None:
        mask = dense_adjacency_mask(graph)
    if use_flash:
        d_k = cfg.attention_dim // cfg.heads
        scale = 1.0 / torch.sqrt(torch.tensor(d_k, dtype=x.dtype))
        out = flash_attention_multihead(q * scale, k, x, mask)  # [H, N, D]
        return out.float().mean(0).to(x.dtype)
    att_w, _ = dense_transformer_attention(att, cfg, graph, q, k, mask=mask)
    return dense_matmul(att_w.mean(0), x)


def colnorm_ax_plain(cfg, att, graph, x):
    """``A(x) x`` under column normalisation through the plain per-edge
    path (`edge_attention` + `multiply_attention`): the replay of the
    column route's gradient."""
    attention, _ = edge_attention(att, cfg, graph, x)
    return multiply_attention(att, cfg, graph, x, attention, None)


def _replayed(cfg, att, graph, x, fast, plain, **tensor_kw) -> torch.Tensor:
    """``fast(cfg, att, graph, x, **tensor_kw)`` when no gradient is
    needed, else the same through :class:`ReplayAttention`, whose backward
    replays ``plain``'s vjp with respect to x, Q, K (and exp_kernel's two
    scalars) and the tensors of ``tensor_kw`` (the windowed reweight's
    dense weights)."""
    tensors = (x, *_Att.flatten(cfg, att), *tensor_kw.values())
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        return fast(cfg, att, graph, x, **tensor_kw)

    def bind(fn):
        def call(x, *flat):
            a, rest = _Att.from_flat(cfg, flat)
            return fn(cfg, a, graph, x, **dict(zip(tensor_kw, rest)))
        return call

    return ReplayAttention.apply(bind(fast), bind(plain), *tensors)


def attention_ax(cfg, att, graph, x, dense=None) -> torch.Tensor:
    """``A(x) x`` of the GRAND-nl RHS on a sparse or windowed graph, in x's
    dtype, by graphax's dispatch (:281-306): on the windowed strategy K5's
    route (softmax) or the plain twin (squareplus); on the sparse strategy
    the column route (``attention_norm_idx=1``) or `fused_attention_ax`.
    ``dense``: the windowed graph's ``[T, tile, W]`` densified weights
    (reweight only)."""
    if graph.strategy == "windowed":
        if cfg.square_plus:
            return windowed_attention_ax_plain(cfg, att, graph, x, dense)
        kw = {} if dense is None else {"dense_weight": dense}
        return _replayed(cfg, att, graph, x, windowed_attention_ax_fast,
                         windowed_attention_ax_plain, **kw)
    if cfg.attention_norm_idx != 0:
        return _replayed(cfg, att, graph, x, colnorm_attention_ax_fast,
                         colnorm_ax_plain)
    return fused_attention_ax(cfg, att, graph, x)


def transformer_rhs(cfg, graph, p, x):
    """``alpha (A(x) x - x) [+ beta x0]`` as a function of its tensors ``p
    = (alpha, beta, x0, Wq, bq, Wk, bk[, output_var, lengthscale][,
    dense])``: the Q/K weights (``[A, D]``, ``[A]``), exp_kernel's two
    scalars, and the windowed graph's densified weights under reweight (the
    adjoint differentiates it with respect to each)."""
    alpha, beta, x0, *flat = p
    att, rest = _Att.from_flat(cfg, flat)
    ax = attention_ax(cfg, att, graph, x, rest[0] if rest else None)
    return apply_alpha_beta(cfg, alpha, beta, ax, x, x0)


class TransformerFunction(nn.Module):
    """``f = alpha (A(x) x - x) [+ beta x0]`` with A the head-mean
    transformer attention of the current state, recomputed at every solver
    evaluation (graphax `make_transformer`). Parameters: ``att`` (the
    attention layer) and ``alpha_train``/``beta_train``, as graphax's tree
    ``{alpha_train, beta_train, att}``."""

    def __init__(self, cfg, in_dim: int):
        super().__init__()
        if cfg.mix_features or cfg.multi_modal:
            raise NotImplementedError("mix_features and multi_modal are not "
                                      "ported yet (ROADMAP Queue 1, M6/M9)")
        self.cfg = cfg
        init_alpha_beta(self)
        self.att = TransformerAttention(cfg, in_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.alpha_train)
        nn.init.zeros_(self.beta_train)
        self.att.reset_parameters(generator)

    def adjoint_tensors(self) -> tuple:
        """The attention tensors `transformer_rhs` reads after alpha, beta
        and x0: Q's and K's weights and biases, and exp_kernel's
        output_var and lengthscale."""
        return _Att.flatten(self.cfg, self.att)

    def check_route(self, fstate, x) -> None:
        """Raise on the routes of graphax's dispatch (`:270-313`) that the
        port has not ported. Ported: the dense strategy's evaluation within
        ``use_dense_attention``'s guard; the windowed strategy with row
        normalisation (K5's route, or the plain twin under squareplus); the
        sparse strategy with ``fast_attention`` (set for evaluation, and
        for training where the hand-written backward covers the config or
        the column route serves it)."""
        cfg = self.cfg
        g = fstate.graph
        if g.strategy == "dense":
            if not fstate.fast_attention:
                raise NotImplementedError(
                    "GRAND-nl training on the dense strategy: below K6's "
                    "gate through the differentiable materialised "
                    "attention (ROADMAP Queue 1, item 3b); above it graphax "
                    "has no gradient through its dense flash kernel K6 "
                    "(ROADMAP Queue 3, 'GRAND-nl training above K6's "
                    "gate')")
            if not use_dense_attention(g, cfg.heads):
                raise NotImplementedError(
                    "GRAND-nl on a dense graph beyond use_dense_attention's "
                    "memory guard (graphax's per-edge XLA route): not ported "
                    "yet (ROADMAP Queue 1, item 6)")
            return
        if g.strategy == "windowed":
            if cfg.attention_norm_idx != 0:
                raise NotImplementedError(_UNPORTED_RHS.format(
                    "with column normalisation on the windowed strategy "
                    "(graphax leaves the windowed layout for its tiled "
                    "fused path there)", "Queue 3, 'windowed GRAND-nl with "
                    "column normalisation'"))
            if not fstate.fast_attention:
                raise NotImplementedError(_UNPORTED_RHS.format(
                    "on the windowed strategy beyond the windowed attention "
                    "kernel's gate (winatt_supported: the four score types, "
                    "a 2-D state, shared memory for D and A)",
                    "Queue 1, item 6"))
            return
        if not fstate.fast_attention:
            raise NotImplementedError(_UNPORTED_RHS.format(
                "training outside the hand-written backward's configs "
                "(scaled_dot, row softmax, no squareplus, no reweight; "
                "graphax's XLA fused_attention_ax autodiff)",
                "Queue 1, item 6"))
        if cfg.attention_norm_idx != 0:
            if not colnorm_supported(cfg, x.shape[1]):
                raise NotImplementedError(
                    "GRAND-nl with column normalisation beyond the column "
                    "route's gate (colnorm_supported: shared memory for D "
                    "and A): not ported yet (ROADMAP Queue 1, item 6)")
            return
        if not flash_supported(cfg, x.shape[1]):
            raise NotImplementedError(
                "GRAND-nl beyond the flash kernels' gate (flash_supported: "
                "shared memory for D and A): not ported yet (ROADMAP Queue "
                "1, item 6)")

    def rhs(self, alpha, beta, fstate, t, x):
        """graphax's dense route on a dense graph (:277-279), evaluation
        only; else :func:`attention_ax`'s routes; every other route
        raises."""
        self.check_route(fstate, x)
        g = fstate.graph
        if g.strategy == "dense":
            ax = dense_rhs_ax(self.att, self.cfg, g, x, mask=fstate.mask)
        else:
            ax = attention_ax(self.cfg, self.att, g, x, fstate.dense)
        return apply_alpha_beta(self.cfg, alpha, beta, ax, x, fstate.x0)
