"""Masked flash attention over a dense adjacency: per head,
``softmax_row(q kᵀ masked) v``, the GRAND-nl RHS of the dense strategy.

Replaces graphax's K6, `_flash_kernel` (`graphax/kernels/pallas_ops.py:27`)
with its entry points `flash_masked_attention` (:60) and
`flash_attention_multihead` (:111). The CUDA source is
`csrc/flash_dense.cu`: one warp per query row and group of up to 4 heads
streams the row's int8 mask once, compacts its live keys, and does the
arithmetic for those keys only, with the running max, denominator and
accumulator of every head in registers.

The function, as graphax's: q, k ``[N, H, dk]`` (q pre-scaled by
1/sqrt(dk)), v ``[N, D]`` shared by every head, mask ``[N, N]`` (nonzero =
edge) -> ``[H, N, D]`` in v's dtype. Scores, the running max ``m`` and
denominator ``l`` are f32; each key tile updates them once (``m' = max(m,
tile max)``, ``p = exp(s - m')``, ``l = l exp(m - m') + sum p``), ``p`` is
rounded to v's dtype before the product (:50-51), the products are summed
in f32, and ``out = acc / max(l, 1e-16)`` (:56-57). A row without an edge
gives exactly 0. graphax's key blocks hold 512 keys, the kernel's 64 (a
block without a live key leaves the state exactly as it was, so the kernel
visits only blocks with live keys): in f32 the two agree to rounding, in
bf16 a ``p`` rounded against another running max can land one bf16 ulp
apart.

:func:`flash_attention_multihead` takes CUDA tensors to the kernel and CPU
tensors to :func:`flash_attention_multihead_plain`, and counts its
launches in ``_build.LAUNCHES["flash_dense"]``. It is not differentiable
(graphax gives K6 no VJP)."""

from __future__ import annotations

import torch

from graphax_torch.kernels import _build

NEG = -1e30
KEY_TILE = 64        # keys per group of the running max in csrc/flash_dense.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DK = 64
_MAX_D = 256


def flash_attention_multihead_plain(q, k, v, mask, block_k: int = KEY_TILE):
    """The kernel's function in plain PyTorch, its running max updated
    once per block of ``block_k`` keys (the kernel's tile by default,
    graphax's 512 with ``block_k=512``)."""
    n, d = v.shape
    qf = q.float().transpose(0, 1)                      # [H, N, dk]
    kf = k.float().transpose(0, 1)
    live_all = mask != 0
    h = qf.shape[0]
    m = torch.full((h, n, 1), NEG, dtype=torch.float32, device=v.device)
    l = torch.zeros((h, n, 1), dtype=torch.float32, device=v.device)
    acc = torch.zeros((h, n, d), dtype=torch.float32, device=v.device)
    for j0 in range(0, n, block_k):
        j1 = min(j0 + block_k, n)
        live = live_all[None, :, j0:j1]
        s = torch.where(live, qf @ kf[:, j0:j1].transpose(1, 2),
                        torch.full((), NEG, device=v.device))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(live, torch.exp(s - m_new), torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ v[j0:j1].float()
        m = m_new
    return (acc / torch.clamp(l, min=1e-16)).to(v.dtype)


def key_loads(q: torch.Tensor, k: torch.Tensor) -> str:
    """How the kernel reads the f32 q and k rows it scores: ``"float4"``
    where dk is a multiple of 4 and both tables start on 16 bytes, else
    ``"scalar"`` (dk = 1, 2, 3, 5, ..., or a view that starts mid-vector).
    Either gives the same values."""
    ok = (q.shape[-1] % 4 == 0 and q.data_ptr() % 16 == 0
          and k.data_ptr() % 16 == 0)
    return "float4" if ok else "scalar"


def flash_attention_multihead(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, mask: torch.Tensor
                              ) -> torch.Tensor:
    """Per-head masked flash attention on shared values: q, k ``[N, H,
    dk]`` (q pre-scaled; any float dtype, read as f32), v ``[N, D]``
    float32 or bfloat16, mask ``[N, N]`` bool or 8-bit -> ``[H, N, D]`` in
    v's dtype."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention_multihead is not differentiable "
                           "(graphax gives K6 no VJP); call it under "
                           "torch.no_grad()")
    if q.dim() != 3 or k.shape != q.shape or v.dim() != 2 \
            or v.shape[0] != q.shape[0] \
            or tuple(mask.shape) != (q.shape[0], q.shape[0]):
        raise ValueError("flash_attention_multihead: q, k [N, H, dk], "
                         "v [N, D] and mask [N, N] required")
    if not v.is_cuda:
        return flash_attention_multihead_plain(q, k, v, mask)
    n, h, dk = q.shape
    d = v.shape[1]
    if v.dtype not in _DTYPES:
        raise TypeError("flash_attention_multihead: v must be float32 or "
                        "bfloat16")
    if mask.dtype not in (torch.bool, torch.int8, torch.uint8):
        raise TypeError("flash_attention_multihead: mask must be bool or "
                        "8-bit")
    if not (1 <= dk <= _MAX_DK and 1 <= d <= _MAX_D):
        raise ValueError(f"flash_attention_multihead: dk {dk} > {_MAX_DK} "
                         f"or D {d} > {_MAX_D} is not covered")
    qf, kf = q.float().contiguous(), k.float().contiguous()
    v, mask = v.contiguous(), mask.contiguous()
    for t in (qf, kf, mask):
        if t.device != v.device:
            raise ValueError("flash_attention_multihead: operands must be on "
                             f"{v.device}")
    out = torch.empty((h, n, d), dtype=v.dtype, device=v.device)
    vec4 = int(key_loads(qf, kf) == "float4")
    lib = _build.library("flash_dense")
    err = lib.gx_flash_dense(qf.data_ptr(), kf.data_ptr(), v.data_ptr(),
                             mask.view(torch.uint8).data_ptr(),
                             out.data_ptr(), n, h, dk, d, _DTYPES[v.dtype],
                             vec4, _build.stream_ptr(v))
    _build.check(err, "flash_dense")
    _build.count_launch("flash_dense")
    return out
