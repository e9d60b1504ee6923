"""Histogram-bisection quantile over a masked edge buffer.

Port of `graphax/sparse/quantile.py:30-76`: ``torch.quantile`` semantics
(linear interpolation between the bracketing order statistics) located by
``rounds`` histogram passes of ``bins`` bins instead of a sort. The
hard-attention block thresholds on it, so the port keeps the algorithm
exactly: a different quantile routine flips kept edges at the threshold.
Everything stays on the tensor's device; no value is pulled to the host."""

from __future__ import annotations

import torch


def _acc_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)


def _order_stat(values, mask, k, rounds: int, bins: int):
    """The k-th (0-indexed) smallest masked value to bin resolution; ``k``
    is an int32 0-dim tensor. Returns the final bin centre."""
    acc = _acc_dtype(values.dtype)
    v = values.to(acc)
    big = torch.tensor(torch.finfo(acc).max, dtype=acc, device=v.device)
    lo = torch.where(mask, v, big).min()
    hi = torch.maximum(torch.where(mask, v, -big).max(), lo)
    below = torch.zeros((), dtype=acc, device=v.device)
    one = torch.ones((), dtype=acc, device=v.device)
    for _ in range(rounds):
        width = (hi - lo) / bins
        safe_w = torch.where(width > 0, width, one)
        idx = ((v - lo) / safe_w).to(torch.int32).clamp(0, bins - 1)
        in_range = mask & (v >= lo) & (v <= hi)
        hist = torch.zeros(bins, dtype=acc, device=v.device).index_add_(
            0, idx.long(), in_range.to(acc))
        cum = torch.cumsum(hist, 0)
        target = (k.to(acc) + 1.0) - below
        b = torch.argmax((cum >= target).to(torch.int32))
        prev = torch.where(b > 0, cum[(b - 1).clamp(min=0)],
                           torch.zeros_like(below))
        new_lo = lo + b.to(acc) * width
        new_hi = new_lo + width
        degenerate = width <= 0
        below = torch.where(degenerate, below, below + prev)
        lo = torch.where(degenerate, lo, new_lo)
        hi = torch.where(degenerate, hi, new_hi)
    return (lo + hi) * 0.5


def refined_masked_quantile(values, mask, q: float, rounds: int = 2,
                            bins: int = 1024):
    """``values [E]``, ``mask [E]`` bool, ``q`` a Python float in [0, 1]."""
    acc = _acc_dtype(values.dtype)
    n = mask.sum()
    pos = torch.tensor(q, dtype=acc, device=values.device) \
        * torch.clamp(n - 1, min=0).to(acc)
    k_lo = torch.floor(pos).to(torch.int32)
    k_hi = torch.ceil(pos).to(torch.int32)
    frac = pos - k_lo.to(acc)
    v_lo = _order_stat(values, mask, k_lo, rounds, bins)
    v_hi = torch.where(k_hi == k_lo, v_lo,
                       _order_stat(values, mask, k_hi, rounds, bins))
    return (v_lo * (1 - frac) + v_hi * frac).to(values.dtype)


def masked_quantile(values, mask, q: float):
    """``torch.quantile`` (linear interpolation) over the masked entries by
    a full sort (graphax's `masked_quantile`,
    `graphax/blocks/hard_attention.py:28-38`; the rewire-attention block
    thresholds on it)."""
    big = torch.where(mask, values, torch.full_like(values, float("inf")))
    sorted_vals = torch.sort(big).values
    n = mask.sum()
    pos = q * torch.clamp(n - 1, min=0).to(values.dtype)
    lo = torch.floor(pos).long()
    hi = torch.ceil(pos).long()
    frac = pos - lo.to(values.dtype)
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac
