"""The redesigned flash_dense and win_matmul, on the CPU.

- flash_dense walks only the mask's live keys: the kernel's walk written
  out in plain PyTorch (per row, the live keys in ascending order, one
  update of the running max per 64-column group that holds a live key;
  groups without one are skipped) against the plain version with the same
  64-key groups, f32 1e-5 / 1e-6 and bf16 one bf16 ulp (2^-7 relative,
  1e-3 absolute: the same rounding points, sums in another order), and
  against graphax's `flash_attention_multihead` (Pallas, interpret mode,
  512-key blocks) at the kernel's tolerances, f32 2e-4 / 2e-5 and bf16
  2e-2 / 2e-2 (p rounded to bf16 against another running max); on masks
  with a hub row (every key live), a row of every other key, a run across
  the kernel's first 512-column span and empty rows.
- the host-side routes: `matmul_staging` (win_matmul's bf16 staging) and
  `key_loads` (flash_dense's reads of q and k) at the widths of every
  preset, and on views that start off their vector size.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from graphax.kernels.pallas_ops import (
    flash_attention_multihead as gx_flash_multihead,
)
from graphax_torch.kernels import flash_dense as fd
from graphax_torch.kernels import windowed_spmm as ws
from graphax_torch.train import BEST_PARAMS, best_config


def _walk(q, k, v, mask, group=fd.KEY_TILE):
    """The kernel's walk: per row, the live keys of each 64-column group
    that holds one, the running max, denominator and accumulator of every
    head updated once per such group."""
    n, h, _ = q.shape
    out = torch.zeros(h, n, v.shape[1], dtype=v.dtype)
    for r in range(n):
        keys = torch.nonzero(mask[r]).flatten()
        m = torch.full((h,), fd.NEG)
        l = torch.zeros(h)
        acc = torch.zeros(h, v.shape[1])
        for g in torch.unique(keys // group):
            j = keys[keys // group == g]
            s = torch.einsum("hc,jhc->hj", q[r].float(), k[j].float())
            m_new = torch.maximum(m, s.amax(1))
            p = torch.exp(s - m_new[:, None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(1)
            acc = acc * alpha[:, None] + p.to(v.dtype).float() @ v[j].float()
            m = m_new
        out[:, r] = (acc / torch.clamp(l, min=1e-16)[:, None]).to(v.dtype)
    return out


def _inputs(n, heads, dk, d, seed):
    rng = np.random.RandomState(seed)
    q = (0.5 * rng.randn(n, heads, dk)).astype(np.float32)
    k = (0.5 * rng.randn(n, heads, dk)).astype(np.float32)
    v = rng.randn(n, d).astype(np.float32)
    mask = rng.rand(n, n) < 6.0 / n
    mask[np.arange(n), np.arange(n)] = True
    mask[1] = True                      # a hub row
    mask[2, ::2] = True                 # every other key
    mask[3, 480:600] = True             # a run across the first span's end
    mask[-3:] = False                   # rows without a live key
    return q, k, v, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [300, 700])
def test_live_key_walk_matches_plain_and_graphax(dtype, n):
    q, k, v, mask = _inputs(n, 2, 4, 8, seed=n + 9)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    args = (torch.from_numpy(q), torch.from_numpy(k),
            torch.from_numpy(v).to(tdt), torch.from_numpy(mask))
    walk = _walk(*args)
    plain = fd.flash_attention_multihead_plain(*args)
    assert walk.dtype == tdt and walk.shape == plain.shape == (2, n, 8)
    assert torch.all(walk[:, -3:] == 0) and torch.all(plain[:, -3:] == 0)
    want = np.asarray(gx_flash_multihead(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v).astype(jdt),
        jnp.asarray(mask), interpret=True).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(walk.numpy(), plain.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(walk.numpy(), want, rtol=2e-4, atol=2e-5)
    else:
        np.testing.assert_allclose(walk.float().numpy(),
                                   plain.float().numpy(), rtol=2.0 ** -7,
                                   atol=1e-3)
        np.testing.assert_allclose(walk.float().numpy(), want, rtol=2e-2,
                                   atol=2e-2)


def test_groups_without_a_live_key_change_nothing():
    """The plain version with 64-key groups over a mask whose live keys
    sit in a few groups equals, bit for bit, the same version run on the
    keys of those groups alone (the skipped groups' update is the
    identity), in f32 and bf16."""
    n = 256
    q, k, v, _ = _inputs(n, 2, 4, 8, seed=5)
    mask = np.zeros((n, n), bool)
    mask[:, 64:128] = np.random.RandomState(6).rand(n, 64) < 0.2
    mask[:, 64] = True
    keep = np.r_[64:128]
    for dt in (torch.float32, torch.bfloat16):
        full = fd.flash_attention_multihead_plain(
            torch.from_numpy(q), torch.from_numpy(k),
            torch.from_numpy(v).to(dt), torch.from_numpy(mask))
        # the keys of group 1 alone, against every query row
        qs = torch.from_numpy(q)
        ks = torch.zeros_like(qs)
        ks[:64] = torch.from_numpy(k[keep])
        vs = torch.zeros(n, 8, dtype=dt)
        vs[:64] = torch.from_numpy(v[keep]).to(dt)
        ms = torch.zeros(n, n, dtype=torch.bool)
        ms[:, :64] = torch.from_numpy(mask[:, keep])
        alone = fd.flash_attention_multihead_plain(qs, ks, vs, ms)
        assert torch.equal(full, alone)


def _preset_widths():
    return sorted({(best_config(ds).hidden_dim,
                    best_config(ds).community_window or 512)
                   for ds in BEST_PARAMS})


@pytest.mark.parametrize("d,w", _preset_widths())
def test_matmul_staging_at_every_preset(d, w):
    dense = torch.zeros(3, 8, w, dtype=torch.bfloat16)
    x = torch.zeros(40, d, dtype=torch.bfloat16)
    add = torch.zeros(40, d, dtype=torch.bfloat16)
    assert dense.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
    assert d % 2 == 0 and w % 8 == 0
    assert ws.matmul_staging(dense, x, add) == "cp.async"
    # a view one row in (2 D bytes: 4-byte aligned for even D) keeps it,
    # one that starts mid-pair does not
    assert ws.matmul_staging(dense, x[1:], add[1:]) == "cp.async"
    assert ws.matmul_staging(dense[1:], x, add) == "cp.async"
    mid = x.reshape(-1)[1:1 + 39 * d].view(39, d)
    assert ws.matmul_staging(dense, mid, add[:39]) == "elements"
    assert ws.matmul_staging(dense, x[:39], mid) == "elements"


def test_matmul_staging_odd_shapes():
    x = torch.zeros(40, 7, dtype=torch.bfloat16)
    assert ws.matmul_staging(torch.zeros(3, 8, 16, dtype=torch.bfloat16),
                             x, x) == "elements"             # odd D
    x = torch.zeros(40, 8, dtype=torch.bfloat16)
    assert ws.matmul_staging(torch.zeros(3, 6, 18, dtype=torch.bfloat16),
                             x, x) == "elements"             # W off 8
    flat = torch.zeros(3 * 8 * 16 + 8, dtype=torch.bfloat16)
    assert ws.matmul_staging(flat[4:4 + 384].view(3, 8, 16), x, x) \
        == "elements"                                       # blocks off 16 B
    assert ws.matmul_staging(flat[8:8 + 384].view(3, 8, 16), x, x) \
        == "cp.async"


def _head_widths():
    return sorted({(best_config(ds).heads,
                    best_config(ds).attention_dim // best_config(ds).heads)
                   for ds in BEST_PARAMS})


@pytest.mark.parametrize("heads,dk", _head_widths())
def test_key_loads_at_every_preset(heads, dk):
    q = torch.zeros(30, heads, dk)
    k = torch.zeros(30, heads, dk)
    assert fd.key_loads(q, k) == ("float4" if dk % 4 == 0 else "scalar")
    flat = torch.zeros(30 * heads * dk + 1)
    view = flat[1:].view(30, heads, dk)                      # 4 bytes in
    assert fd.key_loads(view, k) == "scalar"
    assert fd.key_loads(q, view) == "scalar"
