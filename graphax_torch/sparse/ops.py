"""Plain PyTorch sparse graph ops (index_select / index_add_ / scatter_reduce).

Port of `graphax/sparse/ops.py`. These are the plain versions the kernels
in `graphax_torch.kernels` are held against, and the ops the slice runs
outside the kernels (normalisations, segment sums). All take raw tensors,
not the Graph container."""

from __future__ import annotations

import torch

EPS = 1e-16  # denominator guard, matching reference softmax/squareplus


def _expand(mask, like):
    """Broadcast a [E] mask against [E, ...] data."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


def segment_sum(data, segment_ids, num_segments: int):
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids, data)


def segment_max(data, segment_ids, num_segments: int):
    """Max per segment; empty segments hold -inf (jax.ops.segment_max)."""
    out = torch.full((num_segments,) + tuple(data.shape[1:]), float("-inf"),
                     dtype=data.dtype, device=data.device)
    idx = segment_ids.reshape(segment_ids.shape + (1,) * (data.dim() - 1))
    return out.scatter_reduce_(0, idx.expand_as(data), data, reduce="amax",
                               include_self=True)


def segment_mean(data, segment_ids, num_segments: int, mask=None):
    """Mean per segment over the unmasked rows of ``data``; an empty
    segment holds 0 (its count is taken as 1)."""
    if mask is not None:
        ones = mask.to(torch.float32)
        data = torch.where(_expand(mask, data), data,
                           torch.zeros_like(data))
    else:
        ones = torch.ones(data.shape[0], dtype=torch.float32,
                          device=data.device)
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_sum(ones, segment_ids, num_segments)
    return total / torch.clamp(count, min=1.0).reshape(
        (-1,) + (1,) * (data.dim() - 1))


def segment_softmax(scores, segment_ids, num_segments: int, mask=None):
    """Softmax over edge segments: shift by the segment max, exponentiate,
    divide by the segment sum + 1e-16. Masked edges get 0."""
    neg = torch.tensor(-1e30, dtype=scores.dtype, device=scores.device)
    s = scores if mask is None else torch.where(_expand(mask, scores),
                                                scores, neg)
    seg_max = segment_max(s, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    e = torch.exp(s - seg_max[segment_ids])
    if mask is not None:
        e = torch.where(_expand(mask, e), e, torch.zeros_like(e))
    denom = segment_sum(e, segment_ids, num_segments)[segment_ids]
    return e / (denom + EPS)


def squareplus_norm(scores, segment_ids, num_segments: int, mask=None):
    """Square-plus normalisation (`src/utils.py:129-140`): shift by the
    GLOBAL max over real edges, map through (x + sqrt(x^2 + 4)) / 2, divide
    by the segment sum + 1e-16. Masked edges get 0."""
    neg = torch.tensor(-1e30, dtype=scores.dtype, device=scores.device)
    s = scores if mask is None else torch.where(_expand(mask, scores),
                                                scores, neg)
    gmax = s.max() if s.numel() else torch.zeros((), dtype=s.dtype,
                                                  device=s.device)
    gmax = torch.where(torch.isfinite(gmax), gmax, torch.zeros_like(gmax))
    out = s - gmax
    out = (out + torch.sqrt(out * out + 4.0)) / 2.0
    if mask is not None:
        out = torch.where(_expand(mask, out), out, torch.zeros_like(out))
    denom = segment_sum(out, segment_ids, num_segments)[segment_ids]
    return out / (denom + EPS)


def spmm(row, col, weight, x, num_nodes: int):
    """``y = A @ x`` with A in COO form; padded edges must carry weight 0."""
    gathered = x[col] * weight.to(x.dtype)[:, None]
    return segment_sum(gathered, row, num_nodes)


def attention_spmm(row, col, attention, x, num_nodes: int, mask=None):
    """Head-mean attention SpMM: ``attention [E, H]``, ``x [N, D]``; the
    non-mix_features path of the reference's `multiply_attention`
    (`src/function_transformer_attention.py:33-41`). Masked edges get 0."""
    mean_att = attention.mean(dim=1)
    if mask is not None:
        mean_att = torch.where(mask, mean_att, torch.zeros_like(mean_att))
    return spmm(row, col, mean_att, x, num_nodes)


def spmm_multihead(row, col, att, v, num_nodes: int):
    """Per-head SpMM: ``att [E, H]``, ``v [N, H, Dh] -> [N, H, Dh]``, the
    mix_features path of the reference's `multiply_attention`; padded edges
    must carry weight 0."""
    gathered = v[col] * att[:, :, None]
    return segment_sum(gathered, row, num_nodes)


def sddmm_dot(row, col, q, k):
    """Per-edge per-head dot products: ``q, k [N, H, Dh] -> [E, H]``."""
    return (q[row] * k[col]).sum(-1)


def rw_norm_weights(row, col, weight, num_nodes: int, norm_dim: int = 1,
                    mask=None):
    """Random-walk normalisation: weights scaled by 1/degree of the ``row``
    (norm_dim=0) or ``col`` (norm_dim=1) endpoint; zero degrees stay 0."""
    w = weight if mask is None else torch.where(mask, weight,
                                                torch.zeros_like(weight))
    idx = row if norm_dim == 0 else col
    deg = segment_sum(w, idx, num_nodes)
    safe = torch.where(deg > 0, deg, torch.ones_like(deg))
    deg_inv = torch.where(deg > 0, 1.0 / safe, torch.zeros_like(deg))
    return w * deg_inv[idx]


def gcn_norm_weights(row, col, weight, num_nodes: int, mask=None):
    """Symmetric ``D^{-1/2} A D^{-1/2}`` with the degree over ``col``."""
    w = weight if mask is None else torch.where(mask, weight,
                                                torch.zeros_like(weight))
    deg = segment_sum(w, col, num_nodes)
    safe = torch.where(deg > 0, deg, torch.ones_like(deg))
    dis = torch.where(deg > 0, torch.rsqrt(safe), torch.zeros_like(deg))
    return dis[row] * w * dis[col]
