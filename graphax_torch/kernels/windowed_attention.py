"""GRAND-nl's attention RHS on the windowed layout in plain PyTorch: the
twin of graphax's XLA `windowed_attention_ax`
(`graphax/kernels/windowed_attention.py:172-277`), differentiable by
autograd.

It is three things in the port:

- the route of the configs graphax's windowed attention kernel gates out
  (squareplus: `pallas_winatt_ok`, `graphax/kernels/pallas_winatt.py:
  290-295`), on either device, as graphax takes its XLA function there;
- the replay whose vjp is the backward of the kernel route
  (`graphax_torch.kernels.winatt.windowed_attention_ax_fast`), as
  graphax's custom VJP replays `windowed_attention_ax`
  (`pallas_winatt.py:249-267`);
- an oracle for the tests.

The in-window scores are dense ``[T, tile, W]`` blocks per head, masked by
the layout's occupancy (`WindowLayout.dense_mask`); the out-of-window
(residual) edges walk the residual CSR with segment sums. ``P̄ x`` goes
through the windowed product's autograd Function (`windowed_spmm.
_WinMatmul`), so on the card the replay launches `win_matmul` forward and
`win_bwd_dense` and `win_bwd_slab` backward, as graphax's replay runs its
Pallas window vjp.

Rounding points as graphax's function: q and k projected in f32 and
rounded to the state dtype; the residual k of each gathered row projected
in f32 from the state-dtype weight, rounded, plus the bias in the state
dtype; scores in f32; ``P̄ / H`` rounded. Two differences:

- softmax: graphax shifts the residual scores by r0, their global max,
  and each row's dense cells by the row's own max floored at r0 - 70,
  then rescales the residual sum into the row's frame. The twin shifts
  both by the row's max over its cells and residual edges: the same
  function (a softmax does not see the shift), where graphax's r0-frame
  quotients carry f32 subnormals for a row whose scores sit ~88 or more
  below r0, and their gradient overflows to inf (NaN gradients in the
  first train step of the ogbn-arxiv preset's GRAND-nl with random Q/K).
  The residual ``e`` is rounded to the state dtype
  before its row sums, as graphax's; its weights ``e / d`` are rounded
  once. Squareplus, whose one shift is the global max, keeps graphax's
  form and rounding points (``e`` and the denominators in the state
  dtype);
- graphax adds the two f32 halves and rounds once, the port rounds the
  residual half to the state dtype first (`win_matmul` adds it in its
  epilogue): one more bf16 rounding, none in f32."""

from __future__ import annotations

import math

import torch

from graphax_torch.kernels.fused_attention import (
    COS_EPS, NEG, beltrami_exp, beltrami_kernels, beltrami_split,
)
from graphax_torch.kernels.windowed_spmm import _WinMatmul, _slab, _tiles
from graphax_torch.sparse.ops import segment_max, segment_sum
from graphax_torch.utils.params import linear_apply


def _center(z):
    return z - z.mean(-1, keepdim=True)


def _unit(z):
    zf = z.float()
    n = torch.clamp(torch.linalg.vector_norm(zf, dim=-1, keepdim=True),
                    min=COS_EPS)
    return zf / n


def _exp_kernel(att, sq):
    return att.output_var ** 2 * torch.exp(-sq / (2 * att.lengthscale ** 2))


def _sq_dense(q_h, k_h):
    qf, kf = q_h.float(), k_h.float()
    return ((qf * qf).sum(-1)[:, :, None] + (kf * kf).sum(-1)[:, None, :]
            - 2.0 * torch.bmm(qf, kf.transpose(1, 2)))


def _pair_scores(cfg, att, q_h, k_h):
    """``[E, H, dk]`` gathered q and k in the state dtype -> ``[E, H]`` f32
    (graphax's `_residual_scores`, `:102-152`)."""
    t = cfg.attention_type
    if t == "scaled_dot":
        return (q_h.float() * k_h.float()).sum(-1) / math.sqrt(q_h.shape[-1])
    if t in ("cosine_sim", "pearson"):
        if t == "pearson":
            q_h, k_h = _center(q_h), _center(k_h)
        return (_unit(q_h) * _unit(k_h)).sum(-1)
    if t == "exp_kernel":
        return _exp_kernel(att, ((q_h.float() - k_h.float()) ** 2).sum(-1))
    raise ValueError(f"unknown attention_type {t!r}")


def _dense_scores(cfg, att, q_h, k_h):
    """One head's dense scores ``[T, tile, W]`` f32 from ``q_h [T, tile,
    dk]`` and ``k_h [T, W, dk]`` in the state dtype, the mask not applied
    (graphax's `_dense_scores_head`, `:62-99`)."""
    t = cfg.attention_type
    if t == "scaled_dot":
        return torch.bmm(q_h.float(), k_h.float().transpose(1, 2)) \
            / math.sqrt(q_h.shape[-1])
    if t in ("cosine_sim", "pearson"):
        if t == "pearson":
            q_h, k_h = _center(q_h), _center(k_h)
        return torch.bmm(_unit(q_h), _unit(k_h).transpose(1, 2))
    if t == "exp_kernel":
        return _exp_kernel(att, _sq_dense(q_h, k_h))
    raise ValueError(f"unknown attention_type {t!r}")


def _projections(cfg, att, x):
    """(q, k, the residual's per-node k) in x's dtype, each ``[N, A]``, or
    under Beltrami ``[N, 2A]`` laid out ``[feature A | positional A]``
    (graphax's `windowed_attention_ax`, `:184-191`, and
    `_beltrami_scores`): q and k projected in f32 and rounded; the
    residual's k of each row projected in f32 from the weight in x's
    dtype, rounded, plus the bias in x's dtype."""
    dt = x.dtype

    def res_k(layer, z):
        return (z.float() @ layer.weight.t().to(dt).float()).to(dt) \
            + layer.bias.to(dt)

    if beltrami_exp(cfg):
        feat, pos = beltrami_split(cfg, x)
        q = torch.cat([linear_apply(att.Qx, feat),
                       linear_apply(att.Qp, pos)], -1).to(dt)
        k = torch.cat([linear_apply(att.Kx, feat),
                       linear_apply(att.Kp, pos)], -1).to(dt)
        k_nodes = torch.cat([res_k(att.Kx, feat), res_k(att.Kp, pos)], -1)
        return q, k, k_nodes
    return (linear_apply(att.Q, x).to(dt), linear_apply(att.K, x).to(dt),
            res_k(att.K, x))


def _transform(z, square_plus: bool):
    return (z + torch.sqrt(z * z + 4.0)) / 2.0 if square_plus \
        else torch.exp(z)


def windowed_attention_ax_plain(cfg, att, graph, x: torch.Tensor,
                                dense_weight=None) -> torch.Tensor:
    """``mean_h(softmax_row(scores)) x`` (or squareplus) on the windowed
    layout of ``graph``, in x's dtype, as graphax's `windowed_attention_ax`.
    ``att`` carries ``Q`` and ``K`` (``weight [A, D]``, ``bias``) and, for
    exp_kernel, ``output_var`` and ``lengthscale``; under Beltrami ``Qx``,
    ``Kx``, ``Qp``, ``Kp`` and each kernel's two scalars (graphax's
    Beltrami branch, `:85-94, 125-130, 184-191`); ``dense_weight`` the
    ``[T, tile, W]`` densified edge weights, read only with
    ``reweight_attention``."""
    wl = graph.windows
    heads, dt, n = cfg.heads, x.dtype, x.shape[0]
    a = cfg.attention_dim
    dk = a // heads
    sqp = bool(cfg.square_plus)
    bel = beltrami_exp(cfg)
    q, k, k_nodes = _projections(cfg, att, x)                 # [N, A(+A)]
    qt = _tiles(q, wl)                                        # [T, tile, A]
    kt = _slab(k, wl)[wl.tile_win.long()]                     # [T, W, A]

    # the residual edges' scores
    res = wl.residual
    seg, col = res.seg, res.idx.long()
    e_r = res.num_slots
    if bel:
        def sq_half(lo):
            qh = q[seg, lo:lo + a].reshape(e_r, heads, dk).float()
            kh = k_nodes[col, lo:lo + a].reshape(e_r, heads, dk).float()
            return ((qh - kh) ** 2).sum(-1)

        s_res = beltrami_kernels(att, sq_half(0), sq_half(a))
    else:
        s_res = _pair_scores(cfg, att, q[seg].reshape(e_r, heads, dk),
                             k_nodes[col].reshape(e_r, heads, dk))  # [E_r, H]
    if cfg.reweight_attention:
        s_res = s_res * graph.edge_weight[res.perm][:, None]
    dmask = wl.dense_mask

    def masked(s_h):
        if cfg.reweight_attention and dense_weight is not None:
            s_h = s_h * dense_weight.to(s_h.dtype)
        return torch.where(dmask, s_h, torch.full_like(s_h, NEG))

    def scores(h):
        sl = slice(h * dk, (h + 1) * dk)
        if bel:
            sp = slice(a + h * dk, a + (h + 1) * dk)
            return masked(beltrami_kernels(
                att, _sq_dense(qt[..., sl], kt[..., sl]),
                _sq_dense(qt[..., sp], kt[..., sp])))
        return masked(_dense_scores(cfg, att, qt[..., sl], kt[..., sl]))

    pbar = torch.zeros(wl.block_shape, dtype=torch.float32, device=x.device)
    if sqp:
        # squareplus is shifted by the global max over every score
        # (graphax's r0 frame, its rounding of e and the denominators)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        gmax = s_res.max() if e_r else torch.full((), NEG, device=x.device)
        for h in range(heads):
            gmax = torch.maximum(gmax, scores(h).max())
        gmax = torch.where(gmax <= NEG / 2, zero, gmax)
        e_res = _transform(s_res - gmax, True).to(dt)         # [E_r, H]
        d_res_t = _tiles(segment_sum(e_res.float(), seg, n), wl)
        dens = []
        for h in range(heads):
            e_h = torch.where(dmask, _transform(scores(h) - gmax, True),
                              torch.zeros_like(pbar))
            d_h = e_h.sum(2) + d_res_t[:, :, h]
            d_h = torch.where(d_h > 0, d_h, torch.ones_like(d_h))
            pbar = pbar + e_h / d_h[:, :, None]
            dens.append(d_h)
        den_e = torch.stack(dens, -1).reshape(-1, heads)[:n][seg]
        w_res = (e_res / den_e.to(dt)).mean(-1)
    else:
        # a row softmax over the row's cells and residual edges, shifted by
        # the row's max over both (detached: the softmax does not see it)
        res_max = segment_max(s_res.detach(), seg, n)         # [N, H]
        w_res = 0.0
        for h in range(heads):
            s_h = scores(h)
            m = torch.maximum(s_h.detach().amax(2),
                              _tiles(res_max[:, h:h + 1], wl)[..., 0])
            m = torch.where(m <= NEG / 2, torch.zeros_like(m), m)
            e_h = torch.where(dmask, torch.exp(s_h - m[:, :, None]),
                              torch.zeros_like(s_h))
            m_e = m.reshape(-1)[:n][seg]
            e_r = torch.exp(s_res[:, h] - m_e).to(dt)          # [E_r]
            d_h = e_h.sum(2) + _tiles(segment_sum(e_r.float()[:, None], seg,
                                                  n), wl)[..., 0]
            d_h = torch.where(d_h > 0, d_h, torch.ones_like(d_h))
            pbar = pbar + e_h / d_h[:, :, None]
            w_res = w_res + e_r.float() / d_h.reshape(-1)[:n][seg]
        w_res = (w_res / heads).to(dt)
    pbar = (pbar / heads).to(dt)
    out_res = segment_sum((x[col] * w_res[:, None]).float(), seg, n)
    return _WinMatmul.apply(pbar, x.contiguous(), wl,
                            out_res.to(dt).contiguous())
