"""GRAND-nl's attention RHS, ``A(x) x`` with A the head-mean of the
row-normalised transformer attention over the CSR layout, and its gradient.

Replaces graphax's `_make_flash_kernel` and `_make_gmax_kernel`
(`graphax/kernels/pallas_attention.py:359, 481`) with the forward of
`_make_fused` (`:1046-1112`, ``allow_flash=True``) around them, and the
custom VJP of its Pallas-backward route (`:1200-1283`): K1/K2/K3 with
residuals (`:114, 197, 266`), B1/B2 (`:576, 659`) and B3 (`:727`). The CUDA
source is `csrc/fused_attention.cu`. Evaluation runs three kernels, each
with its plain PyTorch version beside it:

- ``attention_kproj``: the keys ``K = x Wk + bk [N, A]`` in f32, once per
  node (graphax projects each gathered source row inside its kernels; the
  values are the same f32 sums of exact state-dtype products), bf16 on the
  tensor cores, f32 on CUDA-core FMAs (:func:`kproj_route`);
- ``attention_gmax``: the global max of the scores, squareplus's shift
  (0 when no edge is real);
- ``flash_attention``: per row and head the scores, the shift (the row's
  max for softmax, the global one for squareplus), ``e``, the denominator
  ``d`` in f32, ``acc = sum rnd(x[col] * rnd(e))`` with ``rnd`` the state
  dtype's rounding (`:435`), and ``out = mean_h acc / (d + 1e-16)`` in f32
  (`:442`, ``+EPS``, not K3's zero-select), rounded once to the output
  dtype the caller asks for. A row with no edge gives 0.

The flash kernel and ``attention_attspmm`` walk a CSR row the same way
(`csrc/fused_attention.cu`): a warp per row, batches of 32 edges with
their indices and weights first, then several gathered x rows in flight
per warp, loaded :func:`gather_width` bytes at a time. Long rows are
walked in segments of ``ROW_SPLIT`` edges by a warp each and summed in
segment order (:func:`row_split_plan`), so a hub row does not set the
launch's length: flash's rows of more than one batch, attspmm's of more
than ``ROW_SPLIT`` edges. The training forward walks a row as flash
does (rows over one batch in segments of ``ROW_SPLIT``), the row backward
as attspmm does (rows over one batch in segments of one batch),
``attention_bwd_cols`` a CSC column so (the g rows gathered, longer
columns in segments of one batch), and ``attention_norm`` a row with a
group of 8 lanes.

Softmax shifts by each row's final max: graphax's online recurrence over
its 128-row tiles gives the same values to f32 rounding, and bf16 ``e``
that differ by a bf16 rounding of their own.

Training (scaled_dot, row softmax, no squareplus or reweight:
:func:`train_supported`) runs three more:

- ``attention_fwd_res``: the forward with K3's weights ``rnd(mean_h e /
  (d or 1))`` (zero-select, the head mean before the rounding), keeping the
  scores [E, H], the shift and the denominator [N, H] for the backward;
- ``attention_bwd_rows``: B1 + B2 per CSR row, dq̃ and rho;
- ``attention_bwd_cols``: B3 per CSC column, dk and the value term dxv.

:func:`fused_attention_ax` is the entry of the configs the training
kernels cover: flash when no gradient is needed, else the autograd
Functions around the training kernels. The other row-normalised configs
take :func:`flash_attention_ax` with the per-edge path's gradient replayed
(`graphax_torch.functions.transformer.attention_ax`). No kernel is
differentiable itself. The wrappers take CUDA tensors
to their kernels and CPU tensors to the plain versions and count their
launches in ``_build.LAUNCHES``."""

from __future__ import annotations

import weakref

import numpy as np
import torch

from graphax_torch.kernels import _build
from graphax_torch.sparse.graph import Layout
from graphax_torch.sparse.ops import EPS, segment_max, segment_sum
from graphax_torch.utils.params import linear_apply

ATT_TYPES = {"scaled_dot": 0, "cosine_sim": 1, "pearson": 2, "exp_kernel": 3,
             "beltrami_exp": 4}
COS_EPS = 1e-5
NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_WPB = 8            # warps per block in every kernel of fused_attention.cu
_BATCH = 32         # edges a warp of the row walk holds at once
ROW_SPLIT = 128     # the row walk's segment length: longer rows go in
                    # segments of it
NORM_CUT = 32       # attention_norm's rows of more slots go to segments of
NORM_SEG = 32       # NORM_SEG slots (the source's NM_CUT and NM_SEG)
_SMEM_LIMIT = 232_448     # dynamic shared memory a block may opt into
_SMEM_STATIC = 49_152     # without opting in (the flash kernel's q, shifts)


def beltrami_exp(cfg) -> bool:
    """Beltrami's split score: graphax's ``beltrami_exp`` mode of
    `_score_math`, which only ``attention_type="exp_kernel"`` takes
    (Beltrami with another score type projects the whole state)."""
    return bool(cfg.beltrami) and cfg.attention_type == "exp_kernel"


def score_width(cfg) -> int:
    """The width of q and of the K table the kernels read: attention_dim,
    or twice it under :func:`beltrami_exp` (a feature and a positional
    projection)."""
    return cfg.attention_dim * (2 if beltrami_exp(cfg) else 1)


def beltrami_columns(a: int, heads: int) -> torch.Tensor:
    """The column order of the kernels' Beltrami layout from graphax's
    ``[feature A | positional A]``: head h's feature slice, then its
    positional slice, so each head reads one contiguous slice of ``2 A /
    heads`` values."""
    dk = a // heads
    return torch.cat([torch.cat([torch.arange(h * dk, (h + 1) * dk),
                                 a + torch.arange(h * dk, (h + 1) * dk)])
                      for h in range(heads)])


def score_math(att_type: str, q, k, ov2: float = 1.0, inv2l2: float = 0.5,
               *, ov2p: float = 1.0, inv2l2p: float = 0.5):
    """graphax's `_score_math` (`:73-107`): ``q, k [E, H, Dh]`` f32 ->
    ``[E, H]`` scores, as ``csrc/attention_score.cuh`` computes them.
    ``beltrami_exp``: each head's slice holds its feature half, then its
    positional half (:func:`beltrami_columns`); ``ov2 exp(-|qx - kx|^2
    inv2l2) ov2p exp(-|qp - kp|^2 inv2l2p)``, graphax's order."""
    if att_type == "scaled_dot":
        return (q * k).sum(-1)
    if att_type in ("cosine_sim", "pearson"):
        if att_type == "pearson":
            q = q - q.mean(-1, keepdim=True)
            k = k - k.mean(-1, keepdim=True)
        qn = torch.clamp(torch.sqrt((q * q).sum(-1)), min=COS_EPS)
        kn = torch.clamp(torch.sqrt((k * k).sum(-1)), min=COS_EPS)
        return (q * k).sum(-1) / (qn * kn)
    if att_type == "exp_kernel":
        sq = ((q - k) ** 2).sum(-1)
        return ov2 * torch.exp(-sq * inv2l2)
    if att_type == "beltrami_exp":
        hk = q.shape[-1] // 2
        sx = ((q[..., :hk] - k[..., :hk]) ** 2).sum(-1)
        sp = ((q[..., hk:] - k[..., hk:]) ** 2).sum(-1)
        return ov2 * torch.exp(-sx * inv2l2) * ov2p * torch.exp(-sp * inv2l2p)
    raise ValueError(f"unsupported att_type {att_type!r}")


def _no_grad(what: str, *ts) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ts):
        raise RuntimeError(f"{what} is not differentiable; call it under "
                           "torch.no_grad()")


def _check_operands(what: str, ref: torch.Tensor, *ts) -> None:
    for t in ts:
        if t is None:
            continue
        if t.device != ref.device or not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous and on "
                             f"{ref.device}")


def _check_layout(what: str, layout: Layout, n: int, edge_w) -> None:
    for name, t in (("ptr", layout.ptr), ("idx", layout.idx)):
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: layout.{name} must be int32")
    if layout.num_rows != n:
        raise ValueError(f"{what}: layout and q disagree on N")
    if edge_w is not None and (edge_w.dtype != torch.float32
                               or edge_w.dim() != 1
                               or edge_w.shape[0] < layout.num_slots):
        raise ValueError(f"{what}: edge_w must be f32 with one value per "
                         "slot")


def _check_scores(what: str, q, kt, heads: int, att_type: str) -> None:
    if att_type not in ATT_TYPES:
        raise ValueError(f"{what}: unsupported att_type {att_type!r}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: q must be float32 or bfloat16")
    if q.dim() != 2 or kt.shape != q.shape or kt.dtype != torch.float32:
        raise ValueError(f"{what}: q [N, A] and kt [N, A] f32 required")
    if heads < 1 or q.shape[1] % heads:
        raise ValueError(f"{what}: heads must divide A")
    if att_type == "beltrami_exp" and (q.shape[1] // heads) % 2:
        raise ValueError(f"{what}: beltrami_exp needs an even head slice")


# ----------------------------------------------------------------------
# K projection
# ----------------------------------------------------------------------

def attention_kproj_plain(x, wk, bk):
    """``x Wk + bk`` in f32 from x and Wk in the state dtype."""
    return x.float() @ wk.float() + bk.float()


# kproj_tc_kernel's x tile rows, output column chunk and ring depth
_KP_ROWS, _KP_NC, _KP_STAGES = 128, 64, 1


def _kproj_tc_smem(d: int, a: int) -> int:
    """Shared bytes of the tensor-core K projection (`kproj_tc_smem` in
    the source): WkT and the ring of x tiles."""
    nc = min(a, _KP_NC)
    pk = (d + 15) // 16 * 16 + 8
    return 2 * ((nc + 15) // 16 * 16 * pk
                + _KP_STAGES * _KP_ROWS * (d + d % 2) + 16)


def kproj_route(dtype: torch.dtype, d: int, a: int) -> str:
    """The kernel that projects ``x [N, d]`` of ``dtype`` onto ``a`` keys:
    ``"tensor_core"`` for bf16 where its shared memory fits, else
    ``"cuda_core"`` (the FMA kernel, which keeps f32 exact and streams Wk
    with x along D, so it takes every shape)."""
    if dtype == torch.bfloat16 and _kproj_tc_smem(d, a) <= _SMEM_LIMIT:
        return "tensor_core"
    return "cuda_core"


def kproj_supported(dtype: torch.dtype, d: int, a: int) -> bool:
    """A K projection takes ``x [N, d]`` of ``dtype`` onto ``a`` keys: every
    ``d, a >= 1`` in either dtype (:func:`kproj_route` names the kernel)."""
    return dtype in _DTYPES and d >= 1 and a >= 1


def kproj_copy_bytes(t: torch.Tensor) -> int:
    """The bytes of each cp.async copy with which the CUDA-core K
    projection stages ``t`` (x or Wk) chunk by chunk: the widest of 16, 8
    and 4 that divides a row's bytes and t's start, else 0 (one value per
    copy: a bf16 row of odd width, or a view that starts mid-pair)."""
    row = t.shape[1] * t.element_size()
    for vb in (16, 8, 4):
        if row % vb == 0 and t.data_ptr() % vb == 0:
            return vb
    return 0


def kproj_staging(x: torch.Tensor) -> str:
    """How the tensor-core kernel stages x: ``"cp.async"`` (16-byte
    copies of whole tiles) where x starts on 16 bytes and its rows hold an
    even count of values, else ``"elements"`` (one value per copy: odd D,
    or a view such as ``x[1:]`` that starts mid-row). The CUDA-core kernel
    stages by :func:`kproj_copy_bytes`."""
    ok = x.shape[1] % 2 == 0 and x.data_ptr() % 16 == 0
    return "cp.async" if ok else "elements"


def attention_kproj(x: torch.Tensor, wk: torch.Tensor, bk: torch.Tensor
                    ) -> torch.Tensor:
    """``[N, A]`` float32 keys of every node: ``x [N, D]`` and ``wk
    [D, A]`` in one dtype, ``bk [A]`` f32. On the card, bf16 goes to the
    tensor-core kernel where it fits and f32 to the CUDA-core one
    (:func:`kproj_route`)."""
    _no_grad("attention_kproj", x, wk, bk)
    if not x.is_cuda:
        return attention_kproj_plain(x, wk, bk)
    n, d = x.shape
    a = wk.shape[1]
    if x.dtype not in _DTYPES or wk.dtype != x.dtype:
        raise TypeError("attention_kproj: x and wk must share a float32 or "
                        "bfloat16 dtype")
    if wk.shape != (d, a) or bk.shape != (a,) or bk.dtype != torch.float32:
        raise ValueError("attention_kproj: shapes x [N, D], wk [D, A], bk [A] "
                         "f32 required")
    if d < 1 or a < 1:
        raise ValueError("attention_kproj: D and A must be at least 1")
    _check_operands("attention_kproj", x, x, wk, bk)
    kt = torch.empty((n, a), dtype=torch.float32, device=x.device)
    lib = _build.library("fused_attention")
    if kproj_route(x.dtype, d, a) == "tensor_core":
        err = lib.gx_attention_kproj_tc(
            x.data_ptr(), wk.data_ptr(), bk.data_ptr(), kt.data_ptr(), n, d,
            a, int(kproj_staging(x) == "cp.async"), _build.stream_ptr(x))
    else:
        err = lib.gx_attention_kproj(
            x.data_ptr(), wk.data_ptr(), bk.data_ptr(), kt.data_ptr(), n, d,
            a, _DTYPES[x.dtype], kproj_copy_bytes(x), kproj_copy_bytes(wk),
            _build.stream_ptr(x))
    _build.check(err, "attention_kproj")
    _build.count_launch("attention_kproj")
    return kt


# ----------------------------------------------------------------------
# scores and their global max
# ----------------------------------------------------------------------

def edge_scores_plain(layout: Layout, q, kt, edge_w, att_type: str,
                      heads: int, ov2: float = 1.0, inv2l2: float = 0.5, *,
                      ov2p: float = 1.0, inv2l2p: float = 0.5):
    """``[layout.num_slots, H]`` f32 scores of ``_score_math``, times the
    slot's reweight value when ``edge_w`` is given."""
    e, dk = layout.num_slots, q.shape[1] // heads
    qe = q.float()[layout.seg].reshape(e, heads, dk)
    ke = kt[layout.idx.long()].reshape(e, heads, dk)
    s = score_math(att_type, qe, ke, ov2, inv2l2, ov2p=ov2p, inv2l2p=inv2l2p)
    if edge_w is not None:
        s = s * edge_w[:e, None]
    return s


def attention_gmax_plain(layout: Layout, q, kt, edge_w, att_type: str,
                         heads: int, ov2: float = 1.0, inv2l2: float = 0.5,
                         *, ov2p: float = 1.0, inv2l2p: float = 0.5):
    """The max score over every slot and head, 0 when there is none (or
    when it is at or below NEG/2, graphax's rule, `:533-534`)."""
    s = edge_scores_plain(layout, q, kt, edge_w, att_type, heads, ov2,
                          inv2l2, ov2p=ov2p, inv2l2p=inv2l2p)
    if s.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=q.device)
    g = s.max()
    return torch.where(g <= NEG / 2, torch.zeros_like(g), g)


def _vec_unit(a: int, heads: int, att_type: str) -> int:
    """The values the 16-byte score loads take from one place: scaled_dot's
    head slice of ``a / heads``, or beltrami_exp's half of it (each half
    starts at its own offset); 0 for the types scored one value at a
    time."""
    dk = a // heads
    return {"scaled_dot": dk, "beltrami_exp": dk // 2}.get(att_type, 0)


def score_vec(q: torch.Tensor, k: torch.Tensor, heads: int,
              att_type: str) -> int:
    """1 where attention_gmax, attention_norm and K5 read q and k (k in
    q's dtype or the
    f32 K table) by 16-byte loads: scaled_dot's head slices, or each half
    of beltrami_exp's (:func:`_vec_unit`), when a unit's bytes of q are a
    multiple of 16 (so of its row and of an f32 unit too) and both tensors
    sit on 16 bytes; else 0 (one value at a time)."""
    unit = _vec_unit(q.shape[1], heads, att_type)
    return int(unit > 0 and (unit * q.element_size()) % 16 == 0
               and q.data_ptr() % 16 == 0 and k.data_ptr() % 16 == 0)


def flash_kvec(kt: torch.Tensor, heads: int, att_type: str) -> int:
    """1 where the flash kernels read the K table by 16-byte loads:
    scaled_dot's head slices or beltrami_exp's halves (:func:`_vec_unit`)
    a multiple of 4 values and ``kt`` on 16 bytes (q comes from each warp's
    f32 row in shared memory, which beltrami_exp's instances keep on 16
    bytes); else 0."""
    unit = _vec_unit(kt.shape[1], heads, att_type)
    return int(unit > 0 and unit % 4 == 0 and kt.data_ptr() % 16 == 0)


_GMAX_STATE: dict = {}


def _gmax_state(device, stream: int) -> torch.Tensor:
    """The gmax kernel's two-word state for launches on ``stream`` (a CUDA
    stream handle) of ``device``: zeros, made once on that stream; each
    launch leaves it as zeros again (its last block resets it), so no fill
    runs per call. Launches on one stream run one after another, so no two
    share a state; launches on two streams each have their own."""
    key = (device, stream)
    st = _GMAX_STATE.get(key)
    if st is None:
        st = torch.zeros(2, dtype=torch.int32, device=device)
        _GMAX_STATE[key] = st
    return st


def attention_gmax(layout: Layout, q: torch.Tensor, kt: torch.Tensor,
                   edge_w, att_type: str, heads: int, ov2: float = 1.0,
                   inv2l2: float = 0.5, *, ov2p: float = 1.0,
                   inv2l2p: float = 0.5) -> torch.Tensor:
    """0-d float32 global max of the scores. ``q [N, A]`` in the state
    dtype (pre-scaled for scaled_dot), ``kt [N, A]`` f32 from
    :func:`attention_kproj`, ``edge_w [>= E]`` f32 or None; ``ov2p`` and
    ``inv2l2p``: beltrami_exp's positional pair."""
    _check_scores("attention_gmax", q, kt, heads, att_type)
    _no_grad("attention_gmax", q, kt, edge_w)
    if not q.is_cuda:
        return attention_gmax_plain(layout, q, kt, edge_w, att_type, heads,
                                    ov2, inv2l2, ov2p=ov2p, inv2l2p=inv2l2p)
    n, a = q.shape
    if n == 0:
        raise ValueError("attention_gmax: empty graph")
    _check_layout("attention_gmax", layout, n, edge_w)
    if layout.seg.dtype != torch.int64:
        raise TypeError("attention_gmax: layout.seg must be int64")
    _check_operands("attention_gmax", q, layout.seg, layout.idx, q, kt,
                    edge_w)
    out = torch.empty((), dtype=torch.float32, device=q.device)
    lib = _build.library("fused_attention")
    stream = _build.stream_ptr(q)
    err = lib.gx_attention_gmax(
        layout.seg.data_ptr(), layout.idx.data_ptr(), q.data_ptr(),
        kt.data_ptr(), edge_w.data_ptr() if edge_w is not None else None,
        _gmax_state(q.device, stream).data_ptr(), out.data_ptr(),
        layout.num_slots, a, heads, ATT_TYPES[att_type],
        int(edge_w is not None), float(ov2), float(inv2l2), float(ov2p),
        float(inv2l2p), _DTYPES[q.dtype], score_vec(q, kt, heads, att_type),
        stream)
    _build.check(err, "attention_gmax")
    _build.count_launch("attention_gmax")
    return out


# ----------------------------------------------------------------------
# flash
# ----------------------------------------------------------------------

def gather_width(x: torch.Tensor, *f32_views) -> int:
    """Bytes of one load of an ``x [N, D]`` row in the row walk: the widest
    of 8 and 4 bytes that divides a row's bytes and x's offset, and for
    which every f32 tensor of ``f32_views`` (the addend; None is skipped)
    starts on as many values; else one value (bf16 rows of odd D, views
    that start mid-word)."""
    elem = x.element_size()
    row = x.shape[1] * elem
    for vb in (8, 4):
        if vb >= elem and row % vb == 0 and x.data_ptr() % vb == 0 and all(
                t.data_ptr() % (4 * vb // elem) == 0
                for t in f32_views if t is not None):
            return vb
    return elem


def flash_warps(a: int, heads: int, att_type: str = "scaled_dot") -> int:
    """Warps per block of the flash and pin kernels: up to 8, each with q,
    two per-head tables and a batch's 32 x H scores in shared memory
    (beltrami_exp's instances round a warp's floats up to 4, the source's
    ``gx_att::warp_stride``) within one block's limit; 0 where not even
    one fits."""
    floats = a + 2 * heads + _BATCH * heads
    if att_type == "beltrami_exp":
        floats = -(-floats // 4) * 4
    return min(_WPB, _SMEM_LIMIT // (4 * floats))


def batch_warps(heads: int) -> int:
    """Warps per block of the two backward kernels: up to 8, each with a
    batch's 32 x H weights in shared memory within one block's limit; 0
    where not even one fits."""
    return min(_WPB, _SMEM_LIMIT // (4 * _BATCH * heads))


def row_split_plan(ptr: np.ndarray, longer_than: int, seg: int) -> tuple:
    """The segments of the rows of more than ``longer_than`` edges, as
    the kernels read them: ``(plan, nlong, nseg)`` with
    ``plan`` int32 ``[long rows (nlong) | each one's first segment, then
    nseg (nlong + 1) | each segment's long row (nseg)]``; a long row's
    segments cover its edges in order, ``seg`` each, the last one the
    rest."""
    deg = np.diff(np.asarray(ptr, np.int64))
    rows = np.nonzero(deg > longer_than)[0]
    count = (deg[rows] + seg - 1) // seg
    first = np.concatenate([[0], np.cumsum(count)])
    plan = np.concatenate([rows, first, np.repeat(np.arange(rows.size), count)])
    return plan.astype(np.int32), int(rows.size), int(first[-1])


_PLANS: dict = {}


def _row_plan(layout: Layout, longer_than: int, seg: int) -> tuple:
    """:func:`row_split_plan` of ``layout`` on its device, made once per
    layout and arguments (one copy of ``ptr`` to the host) and kept while
    ``layout.ptr`` lives; its copy to the device finished before any
    stream reads it (``_build.publish``)."""
    key = (id(layout.ptr), longer_than, seg)
    hit = _PLANS.get(key)
    if hit is not None and hit[0]() is layout.ptr:
        return hit[1]
    plan, nlong, nseg = row_split_plan(layout.ptr.cpu().numpy(), longer_than,
                                       seg)
    found = (_build.publish(torch.as_tensor(plan, device=layout.ptr.device)),
             nlong, nseg)
    _PLANS[key] = (weakref.ref(layout.ptr,
                               lambda _, k=key: _PLANS.pop(k, None)), found)
    return found


def _out_dtype(what: str, x: torch.Tensor, out_dtype) -> None:
    if out_dtype not in (torch.float32, x.dtype):
        raise ValueError(f"{what}: out_dtype must be float32 or x's dtype")


def flash_attention_plain(layout: Layout, q, x, kt, edge_w, gshift,
                          att_type: str, heads: int, ov2: float = 1.0,
                          inv2l2: float = 0.5, out_dtype=torch.float32, *,
                          ov2p: float = 1.0, inv2l2p: float = 0.5):
    """The flash kernel's function in plain PyTorch: ``[N, D]`` f32, cast
    once to ``out_dtype``. ``gshift`` None: row softmax; else squareplus
    shifted by it."""
    n = layout.num_rows
    seg = layout.seg
    s = edge_scores_plain(layout, q, kt, edge_w, att_type, heads, ov2,
                          inv2l2, ov2p=ov2p, inv2l2p=inv2l2p)  # [E, H]
    if gshift is None:
        ex = torch.exp(s - segment_max(s, seg, n)[seg])
    else:
        z = s - gshift
        ex = (z + torch.sqrt(z * z + 4.0)) / 2.0
    den = segment_sum(ex, seg, n)                              # [N, H] f32
    wt = ex.to(x.dtype)
    xs = x[layout.idx.long()]                                  # [E, D]
    out = torch.zeros((n, x.shape[1]), dtype=torch.float32, device=x.device)
    for h in range(heads):
        acc = torch.zeros_like(out).index_add_(
            0, seg, (xs * wt[:, h:h + 1]).float())
        out += acc / (den[:, h:h + 1] + EPS)
    return (out / heads).to(out_dtype)


def flash_attention(layout: Layout, q: torch.Tensor, x: torch.Tensor,
                    kt: torch.Tensor, edge_w, gshift, att_type: str,
                    heads: int, ov2: float = 1.0, inv2l2: float = 0.5,
                    out_dtype=torch.float32, *, ov2p: float = 1.0,
                    inv2l2p: float = 0.5) -> torch.Tensor:
    """``[N, D]`` head-mean attention aggregation over ``layout``, summed
    in f32 and rounded once to ``out_dtype`` (float32 or x's dtype).

    ``q [N, A]`` (pre-scaled for scaled_dot) and ``x [N, D]`` in one dtype;
    ``kt [N, A]`` f32 keys; ``edge_w [>= E]`` f32 or None; ``gshift`` a 0-d
    f32 tensor (squareplus) or None (row softmax); ``ov2p`` and
    ``inv2l2p``: beltrami_exp's positional pair."""
    _check_scores("flash_attention", q, kt, heads, att_type)
    _no_grad("flash_attention", q, x, kt, edge_w)
    _out_dtype("flash_attention", x, out_dtype)
    if not x.is_cuda:
        return flash_attention_plain(layout, q, x, kt, edge_w, gshift,
                                     att_type, heads, ov2, inv2l2, out_dtype,
                                     ov2p=ov2p, inv2l2p=inv2l2p)
    n, d = x.shape
    a = q.shape[1]
    if x.dtype != q.dtype or q.shape[0] != n:
        raise ValueError("flash_attention: q [N, A] and x [N, D] must share "
                         "N and dtype")
    _check_layout("flash_attention", layout, n, edge_w)
    if gshift is not None and (gshift.dtype != torch.float32
                               or gshift.numel() != 1):
        raise ValueError("flash_attention: gshift must be one f32 value")
    _check_operands("flash_attention", x, layout.ptr, layout.idx, q, x, kt,
                    edge_w, gshift)
    wpb = flash_warps(a, heads, att_type)
    if wpb < 1:
        raise ValueError(f"flash_attention: A={a}, H={heads} exceed one "
                         "block's shared memory")
    # rows of more than one batch of edges are walked in segments
    plan, nlong, nseg = _row_plan(layout, _BATCH, ROW_SPLIT)
    st = torch.empty((nseg, 2 * heads), dtype=torch.float32, device=x.device)
    part = torch.empty((nseg, d), dtype=torch.float32, device=x.device)
    out = torch.empty((n, d), dtype=out_dtype, device=x.device)
    kvec = flash_kvec(kt, heads, att_type)
    lib = _build.library("fused_attention")
    err = lib.gx_flash_attention(
        layout.ptr.data_ptr(), layout.idx.data_ptr(), q.data_ptr(),
        x.data_ptr(), kt.data_ptr(),
        edge_w.data_ptr() if edge_w is not None else None,
        gshift.data_ptr() if gshift is not None else None, plan.data_ptr(),
        st.data_ptr(), part.data_ptr(), out.data_ptr(), n, d, a, heads,
        ATT_TYPES[att_type], int(edge_w is not None), int(gshift is not None),
        float(ov2), float(inv2l2), float(ov2p), float(inv2l2p),
        _DTYPES[x.dtype], _DTYPES[out_dtype],
        gather_width(x), kvec, wpb, ROW_SPLIT, nlong, nseg,
        _build.stream_ptr(x))
    _build.check(err, "flash_attention")
    _build.count_launch("flash_attention")
    return out


# ----------------------------------------------------------------------
# the three-kernel form: one global shift, denominators outside K3
# ----------------------------------------------------------------------

def attention_norm_plain(layout: Layout, q, kt, edge_w, shift,
                         att_type: str, heads: int, ov2: float = 1.0,
                         inv2l2: float = 0.5, square_plus: bool = False, *,
                         ov2p: float = 1.0, inv2l2p: float = 0.5):
    """K1 + K2 under one shift in plain PyTorch: (e [E, H] f32, unrounded;
    the row sums of e [N, H] f32)."""
    s = edge_scores_plain(layout, q, kt, edge_w, att_type, heads, ov2,
                          inv2l2, ov2p=ov2p, inv2l2p=inv2l2p)
    z = s - shift
    e = (z + torch.sqrt(z * z + 4.0)) / 2.0 if square_plus else torch.exp(z)
    return e, segment_sum(e, layout.seg, layout.num_rows)


def attention_norm(layout: Layout, q: torch.Tensor, kt: torch.Tensor,
                   edge_w, shift: torch.Tensor, att_type: str, heads: int,
                   ov2: float = 1.0, inv2l2: float = 0.5,
                   square_plus: bool = False, *, ov2p: float = 1.0,
                   inv2l2p: float = 0.5):
    """graphax's K1 + K2 (`_scores_call`, `_norm_call`, `:114, 197`) with
    ONE shift for every row, as its column-normalised route (`:1078-1087`)
    and its windowed residual (`pallas_winatt.py:199-207`) run them: ``(e,
    den)`` as the plain version. ``q [N, A]`` in the state dtype
    (pre-scaled for scaled_dot), ``kt [N, A]`` f32, ``edge_w`` f32 per slot
    of ``layout`` or None, ``shift`` a 0-d f32 tensor (from
    :func:`attention_gmax`); ``ov2p`` and ``inv2l2p``: beltrami_exp's
    positional pair. The kernel gives each row a group of 8 lanes, one slot
    a lane (beltrami_exp both halves of the slot's score on its lane, by
    16-byte loads of each half where :func:`score_vec` allows); rows of
    more than ``NORM_CUT`` slots go in segments of ``NORM_SEG``
    (:func:`row_split_plan`), their sums added in order."""
    _check_scores("attention_norm", q, kt, heads, att_type)
    _no_grad("attention_norm", q, kt, edge_w)
    if not q.is_cuda:
        return attention_norm_plain(layout, q, kt, edge_w, shift, att_type,
                                    heads, ov2, inv2l2, square_plus,
                                    ov2p=ov2p, inv2l2p=inv2l2p)
    n = q.shape[0]
    _check_layout("attention_norm", layout, n, edge_w)
    if shift.dtype != torch.float32 or shift.numel() != 1:
        raise ValueError("attention_norm: shift must be one f32 value")
    _check_operands("attention_norm", q, layout.ptr, layout.idx, q, kt,
                    edge_w, shift)
    e = torch.empty((layout.num_slots, heads), dtype=torch.float32,
                    device=q.device)
    den = torch.empty((n, heads), dtype=torch.float32, device=q.device)
    plan, nlong, nseg = _row_plan(layout, NORM_CUT, NORM_SEG)
    part = torch.empty((nseg, heads), dtype=torch.float32, device=q.device)
    lib = _build.library("fused_attention")
    err = lib.gx_attention_norm(
        layout.ptr.data_ptr(), layout.idx.data_ptr(), q.data_ptr(),
        kt.data_ptr(), edge_w.data_ptr() if edge_w is not None else None,
        shift.data_ptr(), plan.data_ptr(), part.data_ptr(), e.data_ptr(),
        den.data_ptr(), n, q.shape[1], heads, ATT_TYPES[att_type],
        int(edge_w is not None), int(square_plus), float(ov2), float(inv2l2),
        float(ov2p), float(inv2l2p), _DTYPES[q.dtype],
        score_vec(q, kt, heads, att_type), nlong, nseg, _build.stream_ptr(q))
    _build.check(err, "attention_norm")
    _build.count_launch("attention_norm")
    return e, den


def attention_attspmm_plain(layout: Layout, e, den, x,
                            per_column: bool = False, addend=None,
                            out_dtype=torch.float32):
    """K3 against outside denominators in plain PyTorch: ``[N, D]``, ``(addend
    + sum rnd(x[col] * rnd(mean_h e / (den or 1))))`` in f32 with ``den``
    read at each slot's row, or at its column when ``per_column``, cast once
    to ``out_dtype``."""
    seg, col = layout.seg, layout.idx.long()
    de = _zero_select(den)[col if per_column else seg]
    w = (e / de).sum(1) / e.shape[1]
    vals = (x[col] * w.to(x.dtype)[:, None]).float()
    out = torch.zeros((layout.num_rows, x.shape[1]), dtype=torch.float32,
                      device=x.device).index_add_(0, seg, vals)
    if addend is not None:
        out = addend + out
    return out.to(out_dtype)


def attention_attspmm(layout: Layout, e: torch.Tensor, den: torch.Tensor,
                      x: torch.Tensor, per_column: bool = False,
                      addend=None, out_dtype=torch.float32) -> torch.Tensor:
    """graphax's K3 (`_make_attspmm_kernel`, `:266`) with its denominators
    handed to it: ``[N, D]`` as the plain version. ``e [E, H]`` f32 from
    :func:`attention_norm` in ``layout``'s slot order; ``den [N, H]`` f32, a
    row table (``per_column`` False: K3's row form, the windowed residual
    against K5's combined denominators) or a column table read at each
    edge's column (``per_column``: its ``per_edge_denom`` form under column
    normalisation); ``x [N, D]`` in the state dtype; ``addend [N, D]`` f32
    or None, added to the f32 sum before its one rounding to ``out_dtype``
    (float32 or x's dtype)."""
    _no_grad("attention_attspmm", e, den, x, addend)
    _out_dtype("attention_attspmm", x, out_dtype)
    if not x.is_cuda:
        return attention_attspmm_plain(layout, e, den, x, per_column, addend,
                                       out_dtype)
    n, d = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError("attention_attspmm: x must be float32 or bfloat16")
    heads = den.shape[1] if den.dim() == 2 else 0
    if (e.dtype != torch.float32 or den.dtype != torch.float32
            or heads < 1 or den.shape[0] != n
            or e.shape != (layout.num_slots, heads)):
        raise ValueError("attention_attspmm: e [E, H] and den [N, H] f32 "
                         "required")
    if addend is not None and (addend.dtype != torch.float32
                               or addend.shape != (n, d)):
        raise ValueError("attention_attspmm: addend must be [N, D] f32")
    _check_layout("attention_attspmm", layout, n, None)
    _check_operands("attention_attspmm", x, layout.ptr, layout.idx, e, den,
                    x, addend)
    plan, nlong, nseg = _row_plan(layout, ROW_SPLIT, ROW_SPLIT)
    part = torch.empty((nseg, d), dtype=torch.float32, device=x.device)
    out = torch.empty((n, d), dtype=out_dtype, device=x.device)
    lib = _build.library("fused_attention")
    err = lib.gx_attention_attspmm(
        layout.ptr.data_ptr(), layout.idx.data_ptr(), e.data_ptr(),
        den.data_ptr(), x.data_ptr(),
        addend.data_ptr() if addend is not None else None, plan.data_ptr(),
        part.data_ptr(), out.data_ptr(), n, d, heads, int(per_column),
        _DTYPES[x.dtype], _DTYPES[out_dtype], gather_width(x, addend),
        ROW_SPLIT, nlong, nseg, _build.stream_ptr(x))
    _build.check(err, "attention_attspmm")
    _build.count_launch("attention_attspmm")
    return out


# ----------------------------------------------------------------------
# the RHS's attention product
# ----------------------------------------------------------------------

def kproj_fits(d: int, a: int) -> bool:
    """The shape gate of the flash, windowed (K5) and column routes:
    ``4 (D A + 32 D)`` bytes within one block's shared memory, the bound of
    the K projection those routes were first held to graphax under (its
    first CUDA-core body kept f32 Wk and 32 staged rows in shared memory).
    The projection itself now takes every shape (:func:`kproj_supported`),
    so the gate can widen, route by route, with parity tests of its own."""
    return 4 * (d * a + 32 * d) <= _SMEM_LIMIT


def flash_supported(cfg, d: int) -> bool:
    """The port's gate for the flash path (graphax's is
    `flash_applicable`, `:542-553`, a VMEM estimate): row normalisation, the
    four `_score_math` types and Beltrami's ``beltrami_exp``, head-mean
    aggregation, widths within :func:`kproj_fits` (and the flash kernel's q
    rows and per-head shifts within the default 48 KB), both at the K
    table's width (:func:`score_width`). The flash
    kernel keeps no per-head accumulators (each head's weight folds into
    one f32 sum per column), so any head count that divides attention_dim
    runs."""
    a = score_width(cfg)
    return (cfg.attention_norm_idx == 0
            and cfg.attention_type in ATT_TYPES
            and not cfg.mix_features and not cfg.multi_modal
            and cfg.attention_dim % cfg.heads == 0 and kproj_fits(d, a)
            and 4 * _WPB * (a + 2 * cfg.heads) <= _SMEM_STATIC)


def _query(cfg, att, x: torch.Tensor) -> torch.Tensor:
    """q through ``att.Q`` in f32, pre-scaled by 1/sqrt(d_k) for
    scaled_dot (graphax's `_prep_inputs`, `:917-920`)."""
    q = linear_apply(att.Q, x)
    if cfg.attention_type == "scaled_dot":
        q = q / torch.sqrt(torch.tensor(cfg.attention_dim // cfg.heads,
                                        dtype=torch.float32, device=q.device))
    return q


def beltrami_split(cfg, z: torch.Tensor) -> tuple:
    """(features, positional) of a state laid out ``[features | positional
    | labels]``: the labels join the features (`graphax/kernels/
    fused_attention.py:67-72`)."""
    fh, ph = cfg.feat_hidden_dim, cfg.pos_enc_hidden_dim
    return torch.cat([z[..., :fh], z[..., fh + ph:]], -1), z[..., fh:fh + ph]


def beltrami_kernels(att, sq_x, sq_p):
    """Beltrami's score from each half's squared distances: the product of
    the feature and positional Gaussian kernels in graphax's order
    (`graphax/functions/transformer.py:133-137`); ``att`` carries
    ``output_var_x``, ``lengthscale_x``, ``output_var_p`` and
    ``lengthscale_p``."""
    return (att.output_var_x ** 2
            * torch.exp(-sq_x / (2 * att.lengthscale_x ** 2))
            * att.output_var_p ** 2
            * torch.exp(-sq_p / (2 * att.lengthscale_p ** 2)))


def _beltrami_inputs(cfg, att, x: torch.Tensor) -> dict:
    """graphax's combined-weight trick (`:893-915`) in the kernels'
    layout (:func:`beltrami_columns`): q ``[feat Qx | pos Qp]`` projected
    in f32, one ``[D, 2A]`` K weight with Kx on the feature rows and Kp on
    the positional rows (in x's dtype), the bias ``[bKx | bKp]`` in f32,
    and the four scalars ov2, 1/(2 l^2) of each kernel."""
    a, heads, (n, d) = cfg.attention_dim, cfg.heads, x.shape
    fh, ph = cfg.feat_hidden_dim, cfg.pos_enc_hidden_dim
    feat, pos = beltrami_split(cfg, x)
    qx = linear_apply(att.Qx, feat).reshape(n, heads, a // heads)
    qp = linear_apply(att.Qp, pos).reshape(n, heads, a // heads)
    q = torch.cat([qx, qp], -1).reshape(n, 2 * a)
    wkx = att.Kx.weight.t().to(x.dtype)
    wk = torch.zeros((d, 2 * a), dtype=x.dtype, device=x.device)
    wk[:fh, :a] = wkx[:fh]
    wk[fh + ph:, :a] = wkx[fh:]
    wk[fh:fh + ph, a:] = att.Kp.weight.t().to(x.dtype)
    cols = beltrami_columns(a, heads).to(x.device)
    bk = torch.cat([att.Kx.bias, att.Kp.bias]).float()
    ovx, lx = att.output_var_x, att.lengthscale_x
    ovp, lp = att.output_var_p, att.lengthscale_p
    return dict(q=q, wk=wk[:, cols], bk=bk[cols], att_type="beltrami_exp",
                ov2=float(ovx ** 2), inv2l2=float(1.0 / (2.0 * lx ** 2)),
                ov2p=float(ovp ** 2), inv2l2p=float(1.0 / (2.0 * lp ** 2)))


def prep_inputs(cfg, att, graph, x: torch.Tensor) -> dict:
    """The kernels' operands, as graphax's `_prep_inputs` (`:887-939`): q
    of :func:`_query` cast to x's dtype; Wk in x's dtype; bk and the
    reweight values in f32; exp_kernel's two scalars (``ov2p`` and
    ``inv2l2p`` unused), or under :func:`beltrami_exp` the operands of
    ``beltrami_exp`` (:func:`_beltrami_inputs`). ``att`` is a
    `graphax_torch.functions.transformer.TransformerAttention`."""
    if beltrami_exp(cfg):
        p = _beltrami_inputs(cfg, att, x)
    else:
        ov2 = inv2l2 = 0.0
        if cfg.attention_type == "exp_kernel":
            ov2 = float(att.output_var ** 2)
            inv2l2 = float(1.0 / (2.0 * att.lengthscale ** 2))
        p = dict(q=_query(cfg, att, x), wk=att.K.weight.t().to(x.dtype),
                 bk=att.K.bias.to(torch.float32), att_type=cfg.attention_type,
                 ov2=ov2, inv2l2=inv2l2, ov2p=1.0, inv2l2p=0.5)
    p.update(q=p["q"].to(x.dtype).contiguous(), wk=p["wk"].contiguous(),
             bk=p["bk"].contiguous(), heads=cfg.heads,
             edge_w=graph.edge_weight.float().contiguous()
             if cfg.reweight_attention else None)
    return p


def score_args(p: dict) -> tuple:
    """(the positional score arguments ``(att_type, heads, ov2, inv2l2)``,
    the keywords ``ov2p``, ``inv2l2p``) of the operands ``p``."""
    return ((p["att_type"], p["heads"], p["ov2"], p["inv2l2"]),
            dict(ov2p=p["ov2p"], inv2l2p=p["inv2l2p"]))


def flash_attention_ax(cfg, att, graph, x: torch.Tensor) -> torch.Tensor:
    """``A(x) x`` of the GRAND-nl RHS on a sparse graph, in x's dtype: the
    operands of :func:`prep_inputs`, the K projection, the global shift
    (squareplus only) and the flash kernel, which writes x's dtype."""
    x = x.contiguous()
    p = prep_inputs(cfg, att, graph, x)
    scal, bel = score_args(p)
    kt = attention_kproj(x, p["wk"], p["bk"])
    gshift = None
    if cfg.square_plus:
        gshift = attention_gmax(graph.csr, p["q"], kt, p["edge_w"], *scal,
                                **bel)
    return flash_attention(graph.csr, p["q"], x, kt, p["edge_w"], gshift,
                           *scal, out_dtype=x.dtype, **bel)


# ----------------------------------------------------------------------
# training: the forward with residuals and the two backward kernels
# ----------------------------------------------------------------------

def train_supported(cfg, d: int) -> bool:
    """The twin of graphax's `pallas_bwd_supported` (`:841-849`): the
    configs whose RHS trains through the hand-written backward (scaled_dot,
    row softmax, no squareplus, no reweight, no mix_features), within the
    flash gate (the evaluation forward of the same solve) and the bound
    that the first backward kernels' staged rows set, ``4 WPB (2 D + 3 A +
    H)`` bytes within one block's shared memory. The kernels now stage
    only a batch's weights (:func:`batch_warps`), so the gate can widen
    with parity tests of its own (ROADMAP Queue 1, item 6)."""
    a, h = cfg.attention_dim, cfg.heads
    return (cfg.attention_type == "scaled_dot"
            and cfg.attention_norm_idx == 0
            and not cfg.square_plus
            and not cfg.mix_features
            and not cfg.reweight_attention
            and flash_supported(cfg, d)
            and 4 * _WPB * (2 * d + 3 * a + h) <= _SMEM_LIMIT)


def _check_train(what: str, layout: Layout, x, kt, heads: int, *tables):
    """x [N, D] float32 or bfloat16, kt [N, A] f32, ``tables`` the [N, H]
    f32 per-row tables, all contiguous on x's device."""
    n = x.shape[0]
    if x.dtype not in _DTYPES or x.dim() != 2:
        raise TypeError(f"{what}: x must be [N, D] float32 or bfloat16")
    if kt.dtype != torch.float32 or kt.dim() != 2 or kt.shape[0] != n:
        raise ValueError(f"{what}: kt must be [N, A] f32")
    if heads < 1 or kt.shape[1] % heads:
        raise ValueError(f"{what}: heads must divide A")
    _check_layout(what, layout, n, None)
    for t in tables:
        if t.dtype != torch.float32 or t.shape != (n, heads):
            raise ValueError(f"{what}: per-row tables must be [N, H] f32")
    _check_operands(what, x, layout.ptr, layout.idx, x, kt, *tables)


def _zero_select(denom):
    return torch.where(denom > 0, denom, torch.ones_like(denom))


def attention_fwd_res_plain(layout: Layout, q, x, kt, heads: int):
    """The training forward in plain PyTorch: (out [N, D] in x's dtype,
    scores [E, H], shift [N, H], denom [N, H], all f32)."""
    n, seg = layout.num_rows, layout.seg
    s = edge_scores_plain(layout, q, kt, None, "scaled_dot", heads)
    shift = segment_max(s, seg, n)
    shift = torch.where(torch.isfinite(shift), shift, torch.zeros_like(shift))
    ex = torch.exp(s - shift[seg])
    den = segment_sum(ex, seg, n)
    alpha = ex / _zero_select(den)[seg]
    w = (alpha.sum(1) / heads).to(x.dtype)
    out = torch.zeros((n, x.shape[1]), dtype=torch.float32, device=x.device)
    out.index_add_(0, seg, (x[layout.idx.long()] * w[:, None]).float())
    return out.to(x.dtype), s, shift, den


def attention_fwd_res(layout: Layout, q: torch.Tensor, x: torch.Tensor,
                      kt: torch.Tensor, heads: int):
    """graphax's K1 + K2 + K3 with residuals (`_forward(...,
    want_residuals=True)`, `:1070-1109`) for scaled_dot scores under a row
    softmax: ``(out, scores, shift, denom)`` as the plain version. ``q [N,
    A]`` (pre-scaled) and ``x [N, D]`` in one dtype, ``kt [N, A]`` f32.
    The weights are K3's: ``rnd(mean_h e / (denom or 1))``, not flash's.
    The kernel gives a warp each row of at most 32 edges, one edge a lane,
    the scores as flash takes them; longer rows go in segments of
    ``ROW_SPLIT`` edges through flash's segment kernels
    (:func:`row_split_plan`: each one's scores, max and sum, then its
    partial sums, added in order)."""
    _check_scores("attention_fwd_res", q, kt, heads, "scaled_dot")
    _no_grad("attention_fwd_res", q, x, kt)
    if not x.is_cuda:
        return attention_fwd_res_plain(layout, q, x, kt, heads)
    n, d = x.shape
    if q.dtype != x.dtype or q.shape[0] != n:
        raise ValueError("attention_fwd_res: q [N, A] and x [N, D] must share "
                         "N and dtype")
    _check_train("attention_fwd_res", layout, x, kt, heads)
    _check_operands("attention_fwd_res", x, q)
    a = q.shape[1]
    wpb = flash_warps(a, heads)
    if wpb < 1:
        raise ValueError(f"attention_fwd_res: A={a}, H={heads} exceed one "
                         "block's shared memory")
    sc = torch.empty((layout.num_slots, heads), dtype=torch.float32,
                     device=x.device)
    shift = torch.empty((n, heads), dtype=torch.float32, device=x.device)
    denom = torch.empty_like(shift)
    out = torch.empty_like(x)
    # rows of more than one batch of edges are walked in segments
    plan, nlong, nseg = _row_plan(layout, _BATCH, ROW_SPLIT)
    st = torch.empty((nseg, 2 * heads), dtype=torch.float32, device=x.device)
    part = torch.empty((nseg, d), dtype=torch.float32, device=x.device)
    lib = _build.library("fused_attention")
    err = lib.gx_attention_fwd_res(
        layout.ptr.data_ptr(), layout.idx.data_ptr(), q.data_ptr(),
        x.data_ptr(), kt.data_ptr(), plan.data_ptr(), st.data_ptr(),
        part.data_ptr(), sc.data_ptr(), shift.data_ptr(), denom.data_ptr(),
        out.data_ptr(), n, d, a, heads, _DTYPES[x.dtype], gather_width(x),
        score_vec(q, kt, heads, "scaled_dot"), wpb, ROW_SPLIT, nlong, nseg,
        _build.stream_ptr(x))
    _build.check(err, "attention_fwd_res")
    _build.count_launch("attention_fwd_res")
    return out, sc, shift, denom


def attention_bwd_rows_plain(layout: Layout, sc, shift, denom, g, x, kt,
                             heads: int):
    """B1 + B2 in plain PyTorch: (dq [N, A], rho [N, H]), f32; dq not yet
    scaled by 1/sqrt(d_k)."""
    n, seg, col = layout.num_rows, layout.seg, layout.idx.long()
    e = layout.num_slots
    alpha = torch.exp(sc - shift[seg]) / _zero_select(denom)[seg]
    dah = ((g.float()[seg] * x.float()[col]).sum(1) / heads)[:, None]
    rho = segment_sum(alpha * dah, seg, n)
    ds = alpha * (dah - rho[seg])
    a = kt.shape[1]
    m = (kt[col].reshape(e, heads, a // heads) * ds[:, :, None]).reshape(e, a)
    dq = torch.zeros((n, kt.shape[1]), dtype=torch.float32, device=x.device)
    return dq.index_add_(0, seg, m), rho


def attention_bwd_rows(layout: Layout, sc: torch.Tensor, shift: torch.Tensor,
                       denom: torch.Tensor, g: torch.Tensor, x: torch.Tensor,
                       kt: torch.Tensor, heads: int):
    """graphax's B1 + B2 (`_bwd1_kernel` :576, `_make_bwd2_kernel` :659)
    over the CSR ``layout``: ``(dq, rho)`` as the plain version. ``sc``,
    ``shift``, ``denom`` from :func:`attention_fwd_res`; the cotangent ``g``
    and ``x`` [N, D] in one dtype; ``kt`` [N, A] f32. The kernel gives a
    warp each row of at most 32 edges, one edge a lane (the x rows
    gathered two at a time, da by a warp sum an edge); longer rows go
    in segments of 32 (:func:`row_split_plan`: da and the rho partials,
    then ds and the dq partials, added in order)."""
    _no_grad("attention_bwd_rows", g, x, kt)
    if not x.is_cuda:
        return attention_bwd_rows_plain(layout, sc, shift, denom, g, x, kt,
                                        heads)
    n, d = x.shape
    _check_train("attention_bwd_rows", layout, x, kt, heads, shift, denom)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError("attention_bwd_rows: g must match x")
    if sc.dtype != torch.float32 or sc.shape != (layout.num_slots, heads):
        raise ValueError("attention_bwd_rows: scores must be [E, H] f32")
    _check_operands("attention_bwd_rows", x, g, sc)
    wpb = batch_warps(heads)
    if wpb < 1:
        raise ValueError(f"attention_bwd_rows: H={heads} exceeds one "
                         "block's shared memory")
    a = kt.shape[1]
    # rows of more than one batch of edges are walked in segments of one
    plan, nlong, nseg = _row_plan(layout, _BATCH, _BATCH)
    dab = torch.empty((nseg, _BATCH), dtype=torch.float32, device=x.device)
    pr = torch.empty((nseg, heads), dtype=torch.float32, device=x.device)
    pq = torch.empty((nseg, a), dtype=torch.float32, device=x.device)
    dq = torch.empty_like(kt)
    rho = torch.empty_like(shift)
    lib = _build.library("fused_attention")
    err = lib.gx_attention_bwd_rows(
        layout.ptr.data_ptr(), layout.idx.data_ptr(), sc.data_ptr(),
        shift.data_ptr(), denom.data_ptr(), g.data_ptr(), x.data_ptr(),
        kt.data_ptr(), plan.data_ptr(), dab.data_ptr(), pr.data_ptr(),
        pq.data_ptr(), dq.data_ptr(), rho.data_ptr(), n, d, a, heads,
        _DTYPES[x.dtype], min(gather_width(g), gather_width(x)), wpb, nlong,
        nseg, _build.stream_ptr(x))
    _build.check(err, "attention_bwd_rows")
    _build.count_launch("attention_bwd_rows")
    return dq, rho


def attention_bwd_cols_plain(layout: Layout, q, g, x, kt, shift, denom, rho,
                             heads: int):
    """B3 in plain PyTorch over the CSC ``layout`` (``seg`` the column,
    ``idx`` the row of each slot): (dk [N, A], dxv [N, D]), f32."""
    n, c, r = layout.num_rows, layout.seg, layout.idx.long()
    e, dkh = layout.num_slots, kt.shape[1] // heads
    qe = q.float()[r].reshape(e, heads, dkh)
    s = score_math("scaled_dot", qe, kt[c].reshape(e, heads, dkh))
    alpha = torch.exp(s - shift[r]) / _zero_select(denom)[r]
    da = (g.float()[r] * x.float()[c]).sum(1)
    ds = alpha * ((da / heads)[:, None] - rho[r])
    dk = torch.zeros((n, kt.shape[1]), dtype=torch.float32, device=x.device)
    dk.index_add_(0, c, (qe * ds[:, :, None]).reshape(e, kt.shape[1]))
    w = (alpha.sum(1) / heads).to(g.dtype)
    dxv = torch.zeros((n, x.shape[1]), dtype=torch.float32, device=x.device)
    return dk, dxv.index_add_(0, c, (g[r] * w[:, None]).float())


def attention_bwd_cols(layout: Layout, q: torch.Tensor, g: torch.Tensor,
                       x: torch.Tensor, kt: torch.Tensor, shift: torch.Tensor,
                       denom: torch.Tensor, rho: torch.Tensor, heads: int):
    """graphax's B3 (`_make_bwd3_kernel` :727) over the CSC ``layout``:
    ``(dk, dxv)`` as the plain version. ``q`` (pre-scaled), ``g`` and ``x``
    in one dtype; ``kt`` [N, A] f32; ``shift``, ``denom``, ``rho`` the
    [N, H] per-row tables of the forward and :func:`attention_bwd_rows`.
    The kernel walks a column's slots as the row walk does, a batch of 32,
    one a lane; longer columns go in segments of 32
    (:func:`row_split_plan`), their f32 partials added in order."""
    _no_grad("attention_bwd_cols", q, g, x, kt)
    if not x.is_cuda:
        return attention_bwd_cols_plain(layout, q, g, x, kt, shift, denom,
                                        rho, heads)
    n, d = x.shape
    _check_train("attention_bwd_cols", layout, x, kt, heads, shift, denom,
                 rho)
    if g.shape != x.shape or g.dtype != x.dtype or q.dtype != x.dtype \
            or q.shape != kt.shape:
        raise ValueError("attention_bwd_cols: q [N, A] and g [N, D] must "
                         "share x's dtype")
    _check_operands("attention_bwd_cols", x, q, g)
    wpb = batch_warps(heads)
    if wpb < 1:
        raise ValueError(f"attention_bwd_cols: H={heads} exceeds one "
                         "block's shared memory")
    a = kt.shape[1]
    # columns of more than one batch of slots are walked in segments of one
    plan, nlong, nseg = _row_plan(layout, _BATCH, _BATCH)
    pk = torch.empty((nseg, a), dtype=torch.float32, device=x.device)
    pv = torch.empty((nseg, d), dtype=torch.float32, device=x.device)
    dk = torch.empty_like(kt)
    dxv = torch.empty((n, d), dtype=torch.float32, device=x.device)
    lib = _build.library("fused_attention")
    err = lib.gx_attention_bwd_cols(
        layout.ptr.data_ptr(), layout.idx.data_ptr(), q.data_ptr(),
        g.data_ptr(), x.data_ptr(), kt.data_ptr(), shift.data_ptr(),
        denom.data_ptr(), rho.data_ptr(), plan.data_ptr(), pk.data_ptr(),
        pv.data_ptr(), dk.data_ptr(), dxv.data_ptr(), n, d, a, heads,
        _DTYPES[x.dtype], min(gather_width(g), gather_width(x)),
        score_vec(q, kt, heads, "scaled_dot"), wpb, nlong, nseg,
        _build.stream_ptr(x))
    _build.check(err, "attention_bwd_cols")
    _build.count_launch("attention_bwd_cols")
    return dk, dxv


class _KProj(torch.autograd.Function):
    """``K = x Wk + bk`` in f32 through :func:`attention_kproj` (Wk cast to
    x's dtype, as graphax's kernels take it); its backward is graphax's
    dense products (`:1264-1268`): ``dWk = dkᵀ x``, ``dbk = Σ dk``,
    ``dx = dk Wk`` in f32 from the f32 weight."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return attention_kproj(x, weight.t().to(x.dtype).contiguous(),
                               bias.float().contiguous())

    @staticmethod
    def backward(ctx, dk):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        return (dk @ weight.float() if need_x else None,
                dk.t() @ x.float() if need_w else None,
                dk.sum(0) if need_b else None)


class _TrainAttention(torch.autograd.Function):
    """graphax's custom VJP on the route its Pallas backward covers
    (`_make_fused`, `:1200-1283`): the forward with residuals keeps the
    scores, shift and denominator; the backward runs the row-side kernel
    (dq, rho) and the column-side kernel over the CSC layout (dk, dxv).
    Inputs: ``q`` [N, A] f32 (pre-scaled; cast to x's dtype for the
    kernels, its gradient stays f32), ``x`` [N, D], ``kt`` [N, A] f32."""

    @staticmethod
    def forward(ctx, q, x, kt, graph, heads: int):
        qs = q.to(x.dtype).contiguous()
        out, sc, shift, denom = attention_fwd_res(graph.csr, qs, x, kt, heads)
        ctx.save_for_backward(qs, x, kt, sc, shift, denom)
        ctx.graph, ctx.heads = graph, heads
        return out

    @staticmethod
    def backward(ctx, g):
        qs, x, kt, sc, shift, denom = ctx.saved_tensors
        graph, heads = ctx.graph, ctx.heads
        g = g.to(x.dtype).contiguous()
        dq, rho = attention_bwd_rows(graph.csr, sc, shift, denom, g, x, kt,
                                     heads)
        dk, dxv = attention_bwd_cols(graph.csc, qs, g, x, kt, shift, denom,
                                     rho, heads)
        return dq, dxv, dk, None, None


def fused_attention_ax(cfg, att, graph, x: torch.Tensor) -> torch.Tensor:
    """``A(x) x`` of the GRAND-nl RHS on a sparse graph, in x's dtype, as
    graphax's `fused_attention_ax_pallas` with its Pallas backward
    (`:1290-1329`): the flash kernels when no gradient is needed (jax
    custom_vjp's ``f``), else the differentiable route (its ``fwd`` and
    ``bwd``): the Q projection and its gradients as dense products, the K
    projection through :class:`_KProj`, the attention through
    :class:`_TrainAttention`. ``att`` carries ``Q`` and ``K`` (``weight``
    [A, D], ``bias`` [A]), as the attention layer does."""
    lin = (att.Q.weight, att.Q.bias, att.K.weight, att.K.bias)
    if not (torch.is_grad_enabled()
            and (x.requires_grad or any(t.requires_grad for t in lin))):
        return flash_attention_ax(cfg, att, graph, x)
    if not train_supported(cfg, x.shape[1]):
        raise ValueError(
            "fused_attention_ax: gradients only for the hand-written "
            "backward's configs (train_supported); attention_ax routes the "
            "others")
    x = x.contiguous()
    kt = _KProj.apply(x, att.K.weight, att.K.bias)
    return _TrainAttention.apply(_query(cfg, att, x), x, kt, graph,
                                 cfg.heads)
