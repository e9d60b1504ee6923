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
  hands it detached copies). :func:`attention_ax` takes graphax's dispatch
  (:270-311) on the route :func:`attention_route` names from the config,
  the graph and the state's width, in evaluation and training alike:
  - a dense graph within ``use_dense_attention``'s guard: `dense_rhs_ax`
    (:201-243), the masked flash kernel (K6,
    `graphax_torch.kernels.flash_dense`) on the card where graphax's gate
    holds, else the materialised `dense_transformer_attention`; its
    gradient the materialised route's, as graphax differentiates it on
    every backend but the TPU (K6 serves the evaluations without one);
  - the windowed strategy with row normalisation: softmax through the
    windowed attention kernel K5 and the three-kernel form on the residual
    (`graphax_torch.kernels.winatt`), its gradient the replay of the plain
    twin of graphax's `windowed_attention_ax`
    (`graphax_torch.kernels.windowed_attention`); squareplus, and shapes
    past K5's gate, through that twin itself;
  - column normalisation on any other graph (the windowed graph's and a
    dense graph's CSR and CSC too): the three-kernel form with the column
    denominators (`graphax_torch.kernels.attention3`), its gradient the
    replay of the plain per-edge path;
  - row normalisation over CSR: the configs of the hand-written backward
    through `graphax_torch.kernels.fused_attention.fused_attention_ax`
    (the flash kernels without a gradient, the training kernels with
    one); the others' flash forward with the per-edge path's gradient
    replayed (graphax's XLA `fused_attention_ax` autodiff);
  - everything past the kernels' gates, and mix_features: the plain
    per-edge path with autograd, graphax's own route there.

Beltrami with exp_kernel (`fused_attention.beltrami_exp`) splits the state
into its features and its positional encodings, each with its own Q/K/V
projections and Gaussian kernel, the score their product (graphax
:45-60, 118-137). It takes graphax's routes: never the dense route
(:276-279; the per-edge path on a dense graph), the windowed twin on the
windowed strategy (graphax's winatt kernel gates it out), the flash kernel
in ``beltrami_exp`` mode on CSR with the per-edge gradient replayed
(``pallas_bwd_supported`` excludes it). Beltrami on the column route
raises (ROADMAP Queue 1, item 9).

Under ``multi_modal`` with the second modality ``y``, the Q/K (and V)
projections read the state's cross-modal attention over ``y`` in place of
the state (Beltrami: each half through its own, ``cross`` and
``cross_p``), and ``A`` multiplies the state itself (graphax :124-126,
139-140, 210-211). The pin, flash, K5 and the column route exclude it, as
graphax's gates do: it takes the dense route (K6 keeps graphax's gate) or
the per-edge path.

The Q, K and V projections are dense matmuls here, as graphax leaves them
to XLA."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from graphax_torch.functions.common import (
    CrossModal, CrossTensors, _Linear, apply_alpha_beta, cross_modal_apply,
    init_alpha_beta,
)
from graphax_torch.kernels.attention_pin import attention_pin
from graphax_torch.kernels.dense_path import (
    dense_adjacency_mask, dense_matmul, dense_transformer_attention,
    use_dense_attention,
)
from graphax_torch.kernels.attention3 import (
    ReplayAttention, colnorm_attention_ax_fast, colnorm_supported,
)
from graphax_torch.kernels.dispatch import (
    attention_spmm_auto, segment_softmax_auto, spmm_multihead_auto,
    squareplus_auto,
)
from graphax_torch.kernels.flash_dense import flash_attention_multihead
from graphax_torch.kernels.fused_attention import (
    COS_EPS, beltrami_exp, beltrami_kernels, beltrami_split,
    flash_attention_ax, flash_supported, fused_attention_ax, prep_inputs,
    score_args, train_supported,
)
from graphax_torch.kernels.windowed_attention import \
    windowed_attention_ax_plain
from graphax_torch.kernels.winatt import (
    windowed_attention_ax_fast, winatt_supported,
)
from graphax_torch.utils.params import linear_apply, linear_init


_BELTRAMI_SCALARS = ("output_var_x", "lengthscale_x", "output_var_p",
                     "lengthscale_p")


class TransformerAttention(nn.Module):
    """Q/K/V projections into ``attention_dim`` over ``heads``, plus Wout and
    (exp_kernel) the Gaussian kernel's output_var and lengthscale. Under
    :func:`beltrami_exp`, Qx/Kx/Vx on the features (the state less its
    ``pos_enc_hidden_dim`` positional columns), Qp/Kp/Vp on the positional
    columns, and each kernel's output_var and lengthscale (graphax
    :45-60). Under ``multi_modal`` the cross-attention ``cross`` (on the
    features under Beltrami, with ``cross_p`` on the positional
    columns)."""

    def __init__(self, cfg, in_dim: int):
        super().__init__()
        att = cfg.attention_dim
        self.cfg = cfg
        if beltrami_exp(cfg):
            feat_in = in_dim - cfg.pos_enc_hidden_dim
            for name in ("Qx", "Kx", "Vx"):
                setattr(self, name, nn.Linear(feat_in, att))
            for name in ("Qp", "Kp", "Vp"):
                setattr(self, name, nn.Linear(cfg.pos_enc_hidden_dim, att))
            for name in _BELTRAMI_SCALARS:
                setattr(self, name, nn.Parameter(torch.ones(())))
            if cfg.multi_modal:
                self.cross = CrossModal(feat_in, cfg.second_modality_dim)
                self.cross_p = CrossModal(cfg.pos_enc_hidden_dim,
                                          cfg.second_modality_dim)
        else:
            self.Q = nn.Linear(in_dim, att)
            self.K = nn.Linear(in_dim, att)
            self.V = nn.Linear(in_dim, att)
            if cfg.attention_type == "exp_kernel":
                self.output_var = nn.Parameter(torch.ones(()))
                self.lengthscale = nn.Parameter(torch.ones(()))
            if cfg.multi_modal:
                self.cross = CrossModal(in_dim, cfg.second_modality_dim)
        self.Wout = nn.Linear(att // cfg.heads, in_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.children():
            if isinstance(layer, CrossModal):
                layer.reset_parameters(generator)
            else:
                linear_init(layer, generator, "const", 1e-5)
        for p in self.parameters(recurse=False):
            nn.init.ones_(p)


def attention_means_supported(cfg) -> bool:
    """Configs the pin covers (graphax `attention_means_supported`)."""
    return (cfg.attention_norm_idx == 0 and not cfg.square_plus
            and not cfg.mix_features and not cfg.multi_modal)


def attention_edge_means(att: TransformerAttention, cfg, graph, x, *,
                         differentiable: bool, y=None) -> torch.Tensor:
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
    normalisation, squareplus, multi_modal) takes it in evaluation too;
    ``y`` is the second modality there."""
    if differentiable or not attention_means_supported(cfg):
        return edge_attention(att, cfg, graph, x, y)[0].mean(1)
    if graph.strategy != "sparse":
        x = x.to(torch.promote_types(x.dtype, torch.float32))
    with torch.no_grad():
        x = x.detach().contiguous()
        p = prep_inputs(cfg, att, graph, x)
        scal, bel = score_args(p)
        mean = attention_pin(graph.csr, p["q"], x, p["wk"], p["bk"],
                             p["edge_w"], *scal, **bel)
        out = torch.zeros(graph.edge_buffer_size, dtype=torch.float32,
                          device=x.device)
        out[:graph.num_edges] = mean
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# the plain per-edge path
# ----------------------------------------------------------------------

def _crossed(att, cfg, x, y):
    """The state the projections read: its cross-modal attention over
    ``y`` under ``multi_modal`` with a ``y`` (graphax :139-140), else x."""
    if cfg.multi_modal and y is not None:
        return cross_modal_apply(att.cross, x, y)
    return x


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


def _beltrami_edge_scores(cfg, att, graph, x, y=None):
    """``[E_pad, H]`` Beltrami scores (graphax :118-137): the product of
    the feature and positional Gaussian kernels of each edge; under
    ``multi_modal`` with a ``y`` each half first through its own
    cross-attention (:124-126)."""
    heads = cfg.heads
    feat, pos = beltrami_split(cfg, x)
    if cfg.multi_modal and y is not None:
        feat = cross_modal_apply(att.cross, feat, y)
        pos = cross_modal_apply(att.cross_p, pos, y)

    def sq(lq, lk, z):
        q = _split_heads(linear_apply(lq, z), heads)
        k = _split_heads(linear_apply(lk, z), heads)
        return ((q[graph.row] - k[graph.col]) ** 2).sum(-1)

    return beltrami_kernels(att, sq(att.Qx, att.Kx, feat),
                            sq(att.Qp, att.Kp, pos))


def edge_attention(att, cfg, graph, x, y=None):
    """(attention ``[E_pad, H]`` normalised over the real edges of each row
    (``attention_norm_idx=0``) or column, the raw scores ``[E_pad, H]``):
    the part of `transformer_attention_apply` that reads only Q and K (and
    the cross-attention over ``y``)."""
    heads = cfg.heads
    if beltrami_exp(cfg):
        prods = _beltrami_edge_scores(cfg, att, graph, x, y)
    else:
        x = _crossed(att, cfg, x, y)
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


def transformer_attention_apply(att: TransformerAttention, cfg, graph, x,
                                y=None):
    """(attention ``[E_pad, H]`` normalised over the real edges of each row
    (``attention_norm_idx=0``) or column, (v ``[N, H, Dh]``, the raw scores
    ``[E_pad, H]``)); v is None under Beltrami, as graphax's. Under
    ``multi_modal`` with a ``y``, q, k and v read the state's
    cross-attention over ``y``."""
    if not beltrami_exp(cfg):
        x, y = _crossed(att, cfg, x, y), None
    attention, prods = edge_attention(att, cfg, graph, x, y)
    v = None if beltrami_exp(cfg) else \
        _split_heads(linear_apply(att.V, x), cfg.heads)
    return attention, (v, prods)


def multiply_attention(att: TransformerAttention, cfg, graph, x, attention,
                       v):
    """`ODEFuncTransformerAtt.multiply_attention` (graphax :192-198): ``A
    x`` with the head-mean attention as A's values; under mix_features
    each head's ``A_h v_h``, their mean over heads through Wout."""
    if cfg.mix_features:
        vx = spmm_multihead_auto(graph, attention * graph.edge_mask[:, None],
                                 v).mean(1)                      # [N, Dh]
        return linear_apply(att.Wout, vx)
    return attention_spmm_auto(graph, attention, x, mask=graph.edge_mask)


# ----------------------------------------------------------------------
# the RHS
# ----------------------------------------------------------------------

class _Att(NamedTuple):
    """The attention layer's tensors that the RHS reads, as plain tensors,
    for the routes of :func:`attention_ax`: Q and K, exp_kernel's
    output_var and lengthscale, under mix_features V and Wout, and under
    multi_modal the cross-attention. :meth:`flatten` and :meth:`from_flat`
    hold their one flat layout, that of the adjoint's tensors and of
    :class:`ReplayAttention`'s: ``(Wq, bq, Wk, bk[, output_var,
    lengthscale][, Wv, bv, Wout, bout][, <CrossTensors>])``."""
    Q: _Linear
    K: _Linear
    output_var: torch.Tensor | None = None
    lengthscale: torch.Tensor | None = None
    V: _Linear | None = None
    Wout: _Linear | None = None
    cross: CrossTensors | None = None

    @staticmethod
    def flatten(cfg, att) -> tuple:
        """``att``'s tensors (of an `_Att` or the layer) in the flat
        layout."""
        out = (att.Q.weight, att.Q.bias, att.K.weight, att.K.bias)
        if cfg.attention_type == "exp_kernel":
            out += (att.output_var, att.lengthscale)
        if cfg.mix_features:
            out += (att.V.weight, att.V.bias, att.Wout.weight, att.Wout.bias)
        if cfg.multi_modal:
            out += CrossTensors.flatten(att.cross)
        return out

    @classmethod
    def from_flat(cls, cfg, flat) -> tuple:
        """(the `_Att` at the front of ``flat``, the tensors after it)."""
        qw, qb, kw, kb, *rest = flat
        ov = ls = v = wout = cross = None
        if cfg.attention_type == "exp_kernel":
            ov, ls, *rest = rest
        if cfg.mix_features:
            vw, vb, ow, ob, *rest = rest
            v, wout = _Linear(vw, vb), _Linear(ow, ob)
        if cfg.multi_modal:
            cross, rest = CrossTensors.from_flat(rest[:6]), rest[6:]
        return (cls(_Linear(qw, qb), _Linear(kw, kb), ov, ls, v, wout,
                    cross), tuple(rest))


class _BeltramiAtt(NamedTuple):
    """`_Att`'s counterpart under :func:`beltrami_exp`: the tensors its
    scores read, in the flat layout ``(Wqx, bqx, Wkx, bkx, Wqp, bqp, Wkp,
    bkp, output_var_x, lengthscale_x, output_var_p, lengthscale_p[,
    <cross's CrossTensors>, <cross_p's>])``."""
    Qx: _Linear
    Kx: _Linear
    Qp: _Linear
    Kp: _Linear
    output_var_x: torch.Tensor
    lengthscale_x: torch.Tensor
    output_var_p: torch.Tensor
    lengthscale_p: torch.Tensor
    cross: CrossTensors | None = None
    cross_p: CrossTensors | None = None

    @staticmethod
    def flatten(cfg, att) -> tuple:
        out = ()
        for name in ("Qx", "Kx", "Qp", "Kp"):
            layer = getattr(att, name)
            out += (layer.weight, layer.bias)
        out += tuple(getattr(att, n) for n in _BELTRAMI_SCALARS)
        if cfg.multi_modal:
            out += CrossTensors.flatten(att.cross) \
                + CrossTensors.flatten(att.cross_p)
        return out

    @classmethod
    def from_flat(cls, cfg, flat) -> tuple:
        lin = [_Linear(flat[i], flat[i + 1]) for i in range(0, 8, 2)]
        if not cfg.multi_modal:
            return cls(*lin, *flat[8:12]), tuple(flat[12:])
        return (cls(*lin, *flat[8:12], CrossTensors.from_flat(flat[12:18]),
                    CrossTensors.from_flat(flat[18:24])), tuple(flat[24:]))


def _att_tensors(cfg):
    """The flat layout of ``cfg``'s attention tensors: `_Att` or
    `_BeltramiAtt`."""
    return _BeltramiAtt if beltrami_exp(cfg) else _Att


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
                 use_flash=None, y=None) -> torch.Tensor:
    """``A(x) x`` on a dense graph (graphax `dense_rhs_ax`, :201-243), in
    x's dtype. Where ``use_flash`` (default: x on the card and
    :func:`flash_dense_gate`), the masked flash kernel per head on q
    pre-scaled by ``1 / sqrt(dk)`` (computed in x's dtype, as graphax), then
    the head mean in f32; else the materialised ``[H, N, N]`` attention's
    head mean times x, f32 sums, or under mix_features its heads times v's
    (f32 sums, the head mean in x's dtype) through Wout. ``mask`` is the
    graph's adjacency mask if the caller has it. Under multi_modal with a
    ``y``, q, k (and v) come from the state's cross-attention over ``y``,
    the values multiplied stay x (graphax :210-211)."""
    x_att = _crossed(att, cfg, x, y)
    q = _split_heads(linear_apply(att.Q, x_att), cfg.heads)
    k = _split_heads(linear_apply(att.K, x_att), cfg.heads)
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
    if cfg.mix_features:
        v = _split_heads(linear_apply(att.V, x_att),
                         cfg.heads).transpose(0, 1)
        vx = torch.einsum("hnm,hmd->hnd", att_w.float(), v.float())
        return linear_apply(att.Wout, vx.mean(0).to(x.dtype))
    return dense_matmul(att_w.mean(0), x)


def _dense_ax(cfg, att, graph, x, mask, y=None):
    return dense_rhs_ax(att, cfg, graph, x, mask=mask, y=y)


def _dense_ax_plain(cfg, att, graph, x, mask, y=None):
    return dense_rhs_ax(att, cfg, graph, x, mask=mask, use_flash=False, y=y)


def edge_ax_plain(cfg, att, graph, x, y=None):
    """``A(x) x`` through the plain per-edge path (`edge_attention` +
    `multiply_attention`, v under mix_features), with autograd: graphax's
    route past the kernels' gates, and the replay behind the gradient of
    the column route and of the CSR flash forward."""
    attention, _ = edge_attention(att, cfg, graph, x, y)
    v = _split_heads(linear_apply(att.V, _crossed(att, cfg, x, y)),
                     cfg.heads) if cfg.mix_features else None
    return multiply_attention(att, cfg, graph, x, attention, v)


def _replayed(cfg, att, graph, x, fast, plain, replay=True,
              **tensor_kw) -> torch.Tensor:
    """``fast(cfg, att, graph, x, **tensor_kw)`` when no gradient is
    needed, else the same through :class:`ReplayAttention`, whose backward
    replays ``plain``'s vjp with respect to x, the `_Att` tensors, the
    tensors of ``tensor_kw`` (the windowed reweight's dense weights, the
    dense graph's mask) and, under reweight, the graph's edge weights where
    they need a gradient (the adaptive adjoint's a_p); without ``replay``,
    ``plain`` itself with autograd."""
    ew = (graph.edge_weight,) if (cfg.reweight_attention and
                                  graph.edge_weight.requires_grad) else ()
    tensors = (x, *_att_tensors(cfg).flatten(cfg, att),
               *tensor_kw.values(), *ew)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        return fast(cfg, att, graph, x, **tensor_kw)
    if not replay:
        return plain(cfg, att, graph, x, **tensor_kw)

    def bind(fn):
        def call(x, *flat):
            g = graph
            if ew:
                flat, g = flat[:-1], graph.with_weights(flat[-1])
            a, rest = _att_tensors(cfg).from_flat(cfg, flat)
            return fn(cfg, a, g, x, **dict(zip(tensor_kw, rest)))
        return call

    return ReplayAttention.apply(bind(fast), bind(plain), *tensors)


def attention_route(cfg, graph, d: int, second_order: bool = False) -> str:
    """The route of :func:`attention_ax` for ``cfg`` on ``graph`` with a
    ``[N, d]`` state, graphax's dispatch (:276-311) with the port's kernel
    gates: ``"dense"``, ``"windowed"`` (K5's route), ``"windowed_plain"``
    (the windowed twin with autograd), ``"column"`` (the three-kernel
    column route), ``"flash"`` (the flash kernels, the hand-written
    backward), ``"flash_replay"`` (the flash kernels, the per-edge path's
    gradient replayed) or ``"edge"`` (the per-edge path with autograd).
    Beltrami's split score never takes the dense route: on a dense graph
    within its guard it takes the per-edge path, as graphax's (:276-279);
    under column normalisation elsewhere it takes the column route as the
    other types do, graphax's tiled route (its windowed route is row
    normalisation's only, :246-256).

    ``second_order``: a regulariser takes the RHS's vjp inside the RHS in
    training (``FuncState.second_order``), and the loss is differentiated
    through it. The kernel routes' backwards
    are hand-written kernels with no derivative of their own, so the route
    is one whose backward is autograd's, in the forward and the backward
    solve alike: "windowed_plain" where the windowed route applies (it
    reads the reweight's blocks as K5's route does), else "edge", graphax's
    XLA route off the TPU. Under kinetic_energy alone the routes are the
    usual ones."""
    bel = beltrami_exp(cfg)
    row_norm = cfg.attention_norm_idx == 0
    windowed = graph.strategy == "windowed" and row_norm \
        and not cfg.mix_features and not cfg.multi_modal
    if second_order:
        return "windowed_plain" if windowed else "edge"
    if use_dense_attention(graph, cfg.heads):
        return "edge" if bel else "dense"
    if windowed:
        return "windowed" if winatt_supported(cfg, d) else "windowed_plain"
    if not row_norm:
        return "column" if colnorm_supported(cfg, d) else "edge"
    if not flash_supported(cfg, d):
        return "edge"
    return "flash" if train_supported(cfg, d) else "flash_replay"


def attention_ax(cfg, att, graph, x, dense=None, mask=None, *,
                 vjp_now: bool = False, second_order: bool = False, y=None
                 ) -> torch.Tensor:
    """``A(x) x`` of the GRAND-nl RHS, in x's dtype, on the route of
    :func:`attention_route`. ``dense``: the windowed graph's ``[T, tile,
    W]`` densified weights (K5's route under reweight); ``mask``: a dense
    graph's adjacency mask, if the caller has it. ``vjp_now``: the caller
    takes the vjp at once (the adjoint's backward), so the dense route
    differentiates its materialised route directly rather than computing
    the value first (K6 included) and replaying it; the kernel routes keep
    their backward, as graphax's custom VJPs run their forward there
    too. ``second_order``: :func:`attention_route`'s. ``y``: the second
    modality under multi_modal (the dense route or the per-edge path)."""
    route = attention_route(cfg, graph, x.shape[1], second_order)
    kw = {"y": y} if cfg.multi_modal and y is not None else {}
    if route == "dense":
        if mask is None:
            mask = dense_adjacency_mask(graph)
        return _replayed(cfg, att, graph, x, _dense_ax, _dense_ax_plain,
                         replay=not vjp_now, mask=mask, **kw)
    if route == "windowed":
        kw = {} if dense is None else {"dense_weight": dense}
        return _replayed(cfg, att, graph, x, windowed_attention_ax_fast,
                         windowed_attention_ax_plain, **kw)
    if route == "windowed_plain":
        return windowed_attention_ax_plain(cfg, att, graph, x, dense)
    if route == "column":
        return _replayed(cfg, att, graph, x, colnorm_attention_ax_fast,
                         edge_ax_plain)
    if route == "flash":
        return fused_attention_ax(cfg, att, graph, x)
    if route == "flash_replay":
        return _replayed(cfg, att, graph, x, flash_attention_ax,
                         edge_ax_plain)
    return edge_ax_plain(cfg, att, graph, x, **kw)


def transformer_rhs(cfg, graph, p, x, mask=None, second_order=False, y=None):
    """``alpha (A(x) x - x) [+ beta x0]`` as a function of its tensors ``p
    = (alpha, beta, x0, <the `_Att` flat layout>[, dense])``: the Q/K (and
    under mix_features V/Wout) weights and biases, exp_kernel's two
    scalars, and the windowed graph's densified weights under reweight (the
    adjoint differentiates it with respect to each); ``mask``, a dense
    graph's adjacency mask; ``second_order``, :func:`attention_route`'s;
    ``y``, the second modality."""
    alpha, beta, x0, *flat = p
    att, rest = _att_tensors(cfg).from_flat(cfg, flat)
    ax = attention_ax(cfg, att, graph, x, rest[0] if rest else None, mask,
                      vjp_now=True, second_order=second_order, y=y)
    return apply_alpha_beta(cfg, alpha, beta, ax, x, x0)


class TransformerFunction(nn.Module):
    """``f = alpha (A(x) x - x) [+ beta x0]`` with A the head-mean
    transformer attention of the current state, recomputed at every solver
    evaluation (graphax `make_transformer`). Parameters: ``att`` (the
    attention layer) and ``alpha_train``/``beta_train``, as graphax's tree
    ``{alpha_train, beta_train, att}``."""

    def __init__(self, cfg, in_dim: int):
        super().__init__()
        self.cfg = cfg
        init_alpha_beta(self)
        self.att = TransformerAttention(cfg, in_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.alpha_train)
        nn.init.zeros_(self.beta_train)
        self.att.reset_parameters(generator)

    def adjoint_tensors(self) -> tuple:
        """The attention tensors `transformer_rhs` reads after alpha, beta
        and x0, in the `_Att` flat layout."""
        return _att_tensors(self.cfg).flatten(self.cfg, self.att)

    def rhs(self, alpha, beta, fstate, t, x):
        ax = attention_ax(self.cfg, self.att, fstate.graph, x, fstate.dense,
                          fstate.mask, second_order=fstate.second_order,
                          y=fstate.y)
        return apply_alpha_beta(self.cfg, alpha, beta, ax, x, fstate.x0)
