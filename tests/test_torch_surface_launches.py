"""The launch counts chip_smoke's surface phase holds the card to, on the
CPU: each wrapper of the SpMM's and the windowed products' autograd
Functions called as `chip_smoke.reg_launches` says for one regularised
epoch (a train step under the rk4 adjoint and the early-stop evaluation)
of the arxiv preset's hard block with the four regularisers and of the
attention block with directional_penalty, on CSR and windowed graphs, at
two state widths. On the CPU the wrappers run their plain versions and
count nothing, so the calls are counted here around them."""

import collections

import pytest

import chip_smoke
from graphax_torch import Trainer, best_config, make_sbm_dataset
from graphax_torch.kernels import spmm as sm
from graphax_torch.kernels import windowed_spmm as ws

from torch_surface_helpers import one_torch_thread  # noqa: F401 (autouse)

KERNELS = ((sm, ("spmm_csr", "sddmm")),
           (ws, ("win_matmul", "win_bwd_slab", "win_bwd_dense")))


@pytest.fixture
def calls(monkeypatch):
    counts = collections.Counter()
    for mod, names in KERNELS:
        for name in names:
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, _name=name, **k):
                counts[_name] += 1
                return _fn(*a, **k)

            monkeypatch.setattr(mod, name, counted)
    return counts


@pytest.mark.parametrize("hidden", [6, 10])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("block,regs", [
    ("hard_attention", chip_smoke.REG4),
    ("attention", dict(directional_penalty=0.01))])
def test_reg_launches(calls, block, regs, window, hidden):
    data = make_sbm_dataset(num_nodes=400, num_classes=4, num_features=16,
                            seed=0, strategy="sparse", device="cpu")
    cfg = best_config("ogbn-arxiv", block=block, hidden_dim=hidden,
                      community_window=window, **regs)
    tr = Trainer(cfg, data, device="cpu")
    strategy = "windowed" if window else "sparse"
    assert tr.data.graph.strategy == strategy
    fit = tr.fit(epochs=1)
    sv = fit["solver"][0]
    want = chip_smoke.reg_launches(block, strategy, tr.model.state_dim,
                                   sv["nfe"], sv["bwd_nfe"], sv["eval_nfe"])
    assert {k: v for k, v in calls.items() if v} == want
