"""The dense strategy's operators (port of `graphax/kernels/dense_path.py`).

At N <= 20k nodes `build_graph("auto")` picks the dense strategy: each
forward densifies its edge values once into an ``[N, N]`` operator, and
every RHS evaluation is then a ``[N, N] x [N, D]`` product. graphax computes
all of this in XLA on every backend (no Pallas kernel), so these are plain
PyTorch on either device, graphax's own route (ROADMAP convention 4): the
products go to ``torch.matmul`` (cuBLAS on the card). The one hand-written
kernel of this strategy is the masked flash attention of
`graphax_torch.kernels.flash_dense` (graphax's K6).

Numerics follow graphax and the edge-space path: a masked softmax shifted
by each row's (or column's) max with a ``+1e-16`` denominator, squareplus
shifted by the global max, and a row or column without an edge gives 0."""

from __future__ import annotations

import math

import torch

EPS = 1e-16
NEG = -1e30

DENSE_ATT_MAX_BYTES = 2 << 30


def densify(graph, edge_values: torch.Tensor) -> torch.Tensor:
    """``[N, N]`` operator from per-edge values, in their dtype: duplicate
    edges sum, padding adds nothing."""
    n = graph.num_nodes
    v = torch.where(graph.edge_mask, edge_values,
                    torch.zeros_like(edge_values))
    dense = torch.zeros((n, n), dtype=v.dtype, device=v.device)
    return dense.index_put_((graph.row, graph.col), v, accumulate=True)


def dense_adjacency_mask(graph) -> torch.Tensor:
    """``[N, N]`` bool mask of the real edges (one byte per entry)."""
    n, e = graph.num_nodes, graph.num_edges
    mask = torch.zeros((n, n), dtype=torch.bool, device=graph.device)
    mask[graph.row[:e], graph.col[:e]] = True
    return mask


def masked_softmax(scores, mask, axis: int):
    """Softmax over ``axis`` of the masked entries (max shift, +1e-16, an
    empty row or column gives 0), as `segment_softmax`."""
    s = torch.where(mask, scores, torch.full_like(scores, NEG))
    smax = s.amax(dim=axis, keepdim=True)
    smax = torch.where(smax <= NEG / 2, torch.zeros_like(smax), smax)
    e = torch.where(mask, torch.exp(s - smax), torch.zeros_like(s))
    return e / (e.sum(dim=axis, keepdim=True) + EPS)


def masked_squareplus(scores, mask, axis: int):
    """Squareplus normalisation over ``axis``, shifted by the global max of
    the masked scores (0 when there is none)."""
    s = torch.where(mask, scores, torch.full_like(scores, NEG))
    gmax = s.max()
    gmax = torch.where(torch.isfinite(gmax), gmax, torch.zeros_like(gmax))
    z = s - gmax
    out = torch.where(mask, (z + torch.sqrt(z * z + 4.0)) / 2.0,
                      torch.zeros_like(z))
    return out / (out.sum(dim=axis, keepdim=True) + EPS)


def use_dense_attention(graph, heads: int) -> bool:
    """The transformer RHS runs dense on a dense graph whose ``[H, N, N]``
    bf16-sized scores fit 2 GiB (graphax `:70-73`)."""
    n = graph.num_nodes
    return (graph.strategy == "dense"
            and n * n * heads * 2 <= DENSE_ATT_MAX_BYTES)


def dense_transformer_attention(att, cfg, graph, q, k, mask=None):
    """Dense per-head attention ``[H, N, N]`` from head-split ``q, k
    [N, H, Dh]`` over the four score types, row or column normalisation,
    softmax or squareplus, and reweighting (graphax `:76-114`). ``att`` is
    the `TransformerAttention` (exp_kernel's output_var and lengthscale);
    ``mask`` is the graph's adjacency mask if the caller has it. Returns
    (attention in q's dtype, the bool mask)."""
    if mask is None:
        mask = dense_adjacency_mask(graph)
    d_k = q.shape[-1]
    qt, kt = q.transpose(0, 1).float(), k.transpose(0, 1).float()
    if cfg.attention_type == "scaled_dot":
        scores = torch.einsum("hnd,hmd->hnm", qt, kt) / math.sqrt(d_k)
    elif cfg.attention_type in ("cosine_sim", "pearson"):
        if cfg.attention_type == "pearson":
            qt = qt - qt.mean(-1, keepdim=True)
            kt = kt - kt.mean(-1, keepdim=True)
        qn = qt / torch.clamp(torch.linalg.vector_norm(qt, dim=-1,
                                                       keepdim=True), min=1e-5)
        kn = kt / torch.clamp(torch.linalg.vector_norm(kt, dim=-1,
                                                       keepdim=True), min=1e-5)
        scores = torch.einsum("hnd,hmd->hnm", qn, kn)
    elif cfg.attention_type == "exp_kernel":
        # |q_n - k_m|^2 = |q|^2 + |k|^2 - 2 q.k
        sq = ((qt * qt).sum(-1)[:, :, None] + (kt * kt).sum(-1)[:, None, :]
              - 2 * torch.einsum("hnd,hmd->hnm", qt, kt))
        scores = att.output_var ** 2 * torch.exp(
            -sq / (2 * att.lengthscale ** 2))
    else:
        raise ValueError(f"unknown attention_type {cfg.attention_type!r}")
    if cfg.reweight_attention:
        scores = scores * densify(graph, graph.edge_weight)[None]
    axis = 2 if cfg.attention_norm_idx == 0 else 1
    norm = masked_squareplus if cfg.square_plus else masked_softmax
    return norm(scores.to(q.dtype), mask[None], axis), mask


def dense_matmul(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a @ x`` in x's dtype with ``a`` rounded to x's dtype and f32 sums,
    as graphax's ``matmul(a.astype(x.dtype), x,
    preferred_element_type=f32)``. A bf16 state is multiplied in f32 (the
    products of bf16 values are exact there), so cuBLAS's reduced-precision
    bf16 reduction never applies; that costs an ``[N, N]`` f32 copy of
    ``a`` per call."""
    if x.dtype == torch.float32:
        return torch.matmul(a.float(), x)
    return torch.matmul(a.to(x.dtype).float(), x.float()).to(x.dtype)


def dense_edge_values(graph, dense_mat: torch.Tensor) -> torch.Tensor:
    """Per-edge values ``[E_pad]`` read from a dense matrix (0 on padding)."""
    vals = dense_mat[graph.row, graph.col]
    return torch.where(graph.edge_mask, vals, torch.zeros_like(vals))
