"""The port's sweeps (`graphax_torch/train/sweep.py`, the CLI
`graphax_torch/drivers/sweep.py`), profiling helpers and figures against
graphax's on the CPU.

Sampling and TPE are numpy in both packages, so the same seed gives the
same configs and proposals, compared for equality. `asha_sweep` and
`replicate_best` run on a deterministic stand-in trainer (its accuracy a
fixed function of the config, the epochs and the seed) and must give
graphax's trial table, promotions and ``sweep_state.json`` exactly,
sequentially, with two trials at once on CPU devices, and under
``search="bayes"``. Then graphax's own oracles (`tests/test_drivers.py`)
on the port's Trainer, the concurrent sweep on the port's Trainer equal
to the sequential one, the launch counter and the kernel build under
threads."""

import ast
import json
import math
import os
import pathlib
import threading
import time

import jax
import numpy as np
import pytest
import torch

from graphax.train import Config as GxConfig
from graphax.train import sweep as gx_sweep

import graphax_torch.data
from graphax_torch.data import make_sbm_dataset
from graphax_torch.drivers import sweep as sweep_cli
from graphax_torch.kernels import _build
from graphax_torch.train import Config, Trainer
from graphax_torch.train import sweep
from graphax_torch.utils.profiling import ThroughputMeter, profile_trace

from torch_surface_helpers import one_torch_thread  # noqa: F401 (autouse)

CPU2 = [torch.device("cpu")] * 2


class StandIn:
    """A trainer whose best accuracies are a fixed function of the config,
    the epochs and the seed; it writes the checkpoint file the sweep
    names."""

    def __init__(self, cfg, split=0):
        self.cfg, self.split = cfg, split

    def fit(self, epochs=None, seed=None, checkpoint_path=None,
            checkpoint_every=10):
        c = self.cfg
        z = math.log(c.lr) * 3.1 + c.hidden_dim / 37.0 + c.time / 11.0 \
            + c.dropout + 0.3 * (c.block == "attention") + 0.01 * self.split \
            + 0.001 * (seed or 0)
        val = (0.5 + 0.4 * math.sin(z)) * (1.0 - 1.0 / (epochs + 1.0))
        if checkpoint_path is not None:
            with open(checkpoint_path + ".npz", "w") as f:
                f.write(str(epochs))
        return {"best": {"val_acc": val, "test_acc": 0.9 * val}}


def _table(trials):
    return [{**{k: v for k, v in t.items() if k != "device"},
             "cfg": t["cfg"].to_dict()} for t in trials]


def _state(path):
    with open(os.path.join(path, "sweep_state.json")) as f:
        state = json.load(f)
    for t in state["trials"]:
        t.pop("device", None)
    return state


def test_sample_config_kwargs_and_tpe_match_graphax():
    space = sweep.SEARCH_SPACES["Cora"]
    assert space == gx_sweep.SEARCH_SPACES["Cora"]
    ours, theirs = np.random.RandomState(7), np.random.RandomState(7)
    draws = [sweep.sample_config_kwargs(space, ours) for _ in range(50)]
    assert draws == [gx_sweep.sample_config_kwargs(space, theirs)
                     for _ in range(50)]
    obs = [(kw, 0.3 + 0.5 * math.sin(i)) for i, kw in enumerate(draws[:12])]
    p_ours = sweep.TPEProposer(space, seed=3)
    p_theirs = gx_sweep.TPEProposer(space, seed=3)
    props = [p_ours.propose(obs[:2 + i % 10]) for i in range(50)]
    assert props == [p_theirs.propose(obs[:2 + i % 10]) for i in range(50)]
    for kw in draws + props:
        assert sweep._apply_kwargs(Config(), kw).to_dict() \
            == gx_sweep._apply_kwargs(GxConfig(), kw).to_dict()


def test_sample_config_consistency():
    rng = np.random.RandomState(0)
    for _ in range(20):
        cfg = sweep.sample_config(Config(), sweep.SEARCH_SPACES["Cora"], rng)
        assert cfg.attention_dim % cfg.heads == 0


SWEEPS = {
    "sequential": dict(),
    "concurrent": dict(max_concurrent=2),
    "bayes": dict(search="bayes", num_samples=7),
    "bayes_concurrent": dict(search="bayes", num_samples=7,
                             max_concurrent=2),
    "resumable": dict(checkpoint=True),
}


@pytest.mark.parametrize("case", list(SWEEPS))
def test_asha_sweep_matches_graphax(case, tmp_path):
    kw = dict(num_samples=6, max_epochs=8, grace_period=2,
              reduction_factor=2, seed=5)
    kw.update(SWEEPS[case])
    ckpt = kw.pop("checkpoint", False)
    conc = kw.get("max_concurrent")
    base = Config(dataset="Cora", hidden_dim=8)
    gx_base = GxConfig(dataset="Cora", hidden_dim=8)
    dirs = {k: str(tmp_path / k) for k in ("port", "graphax")}
    ours = sweep.asha_sweep(
        StandIn, base, devices=CPU2 if conc else None,
        checkpoint_dir=dirs["port"] if ckpt or conc else None, **kw)
    theirs = gx_sweep.asha_sweep(
        StandIn, gx_base, devices=jax.devices("cpu")[:2] if conc else None,
        checkpoint_dir=dirs["graphax"] if ckpt or conc else None, **kw)
    assert _table(ours["trials"]) == _table(theirs["trials"])
    assert ours["best_config"].to_dict() == theirs["best_config"].to_dict()
    assert (ours["best_val"], ours["best_test"]) \
        == (theirs["best_val"], theirs["best_test"])
    if conc:
        assert {t["device"] for t in ours["trials"]} == {"cpu"}
    if ckpt or conc:
        assert _state(dirs["port"]) == _state(dirs["graphax"])
        assert sorted(os.listdir(dirs["port"])) \
            == sorted(os.listdir(dirs["graphax"]))


@pytest.mark.parametrize("conc", [None, 2])
def test_replicate_best_matches_graphax(conc):
    cfg = Config(dataset="Cora", lr=0.02, hidden_dim=16)
    ours = sweep.replicate_best(StandIn, cfg, reps=2, num_splits=3,
                                epochs=4, max_concurrent=conc,
                                devices=CPU2 if conc else None)
    theirs = gx_sweep.replicate_best(
        StandIn, GxConfig(dataset="Cora", lr=0.02, hidden_dim=16), reps=2,
        num_splits=3, epochs=4, max_concurrent=conc,
        devices=jax.devices("cpu")[:2] if conc else None)
    assert ours == theirs


def _sbm(seed=0):
    return make_sbm_dataset(num_nodes=80, num_features=8, num_classes=3,
                            p_in=0.15, p_out=0.01, seed=seed, device="cpu")


SMALL = Config(hidden_dim=8, block="constant", function="laplacian",
               method="euler", step_size=1.0, time=1.0, no_early=True,
               self_loop_weight=1.0, input_dropout=0.1, dropout=0.1)


def test_replicate_best_stats():
    base = SMALL.replace(epoch=3)

    def make_trainer(cfg, split_seed):
        return Trainer(cfg, _sbm(split_seed), device="cpu")

    out = sweep.replicate_best(make_trainer, base, reps=2, num_splits=2,
                               epochs=3)
    assert out["val"]["n"] == 4
    assert "ci95" in out["val"] and out["val"]["ci95"] >= 0


def test_asha_sweep_checkpoint_resume(tmp_path):
    """A sweep restarted on its checkpoint directory trains no trial again
    and returns the same result."""
    data = _sbm()
    base = SMALL.replace(input_dropout=0.0, dropout=0.0)
    space = {"lr": ("loguniform", 1e-3, 1e-1)}
    calls = []

    def make(cfg):
        calls.append(cfg.lr)
        return Trainer(cfg, data, device="cpu")

    td = str(tmp_path)
    out1 = sweep.asha_sweep(make, base, space, num_samples=3, max_epochs=4,
                            grace_period=2, reduction_factor=2,
                            checkpoint_dir=td)
    n_fits = len(calls)
    assert os.path.exists(os.path.join(td, "sweep_state.json"))
    assert os.path.exists(os.path.join(td, "trial_0.ckpt.npz"))
    out2 = sweep.asha_sweep(make, base, space, num_samples=3, max_epochs=4,
                            grace_period=2, reduction_factor=2,
                            checkpoint_dir=td)
    assert len(calls) == n_fits          # no trial re-trained
    assert out2["best_val"] == out1["best_val"]
    assert abs(out2["best_config"].lr - out1["best_config"].lr) < 1e-12


def test_concurrent_sweep_equals_sequential_on_the_port_trainer():
    """Two trials at once in threads (CPU devices) give the sequential
    sweep's table, accuracies equal, and leave the shared dataset's
    tensors as they were."""
    data = _sbm()
    before = {k: v.clone() for k, v in (("x", data.x), ("y", data.y),
                                        ("w", data.graph.edge_weight))}
    space = {"lr": ("loguniform", 1e-3, 1e-1), "block":
             ("choice", ["constant", "attention"])}
    make = lambda cfg: Trainer(cfg, data, device="cpu")
    kw = dict(num_samples=4, max_epochs=4, grace_period=2,
              reduction_factor=2, seed=1)
    seq = sweep.asha_sweep(make, SMALL, space, **kw)
    conc = sweep.asha_sweep(make, SMALL, space, max_concurrent=2,
                            devices=CPU2, **kw)
    assert _table(seq["trials"]) == _table(conc["trials"])
    for k, v in before.items():
        now = {"x": data.x, "y": data.y, "w": data.graph.edge_weight}[k]
        assert torch.equal(v, now), k


def test_sweep_cli_prints_best_and_replication(monkeypatch, capsys):
    sbm = lambda cfg, data_dir="./data", split_seed=12345, device=None, **_: \
        make_sbm_dataset(num_nodes=80, num_features=8, num_classes=3,
                         p_in=0.15, p_out=0.01, seed=split_seed % 7,
                         device=device)
    monkeypatch.setattr(graphax_torch.data, "get_dataset", sbm)
    out = sweep_cli.main(["--dataset", "toy", "--num_samples", "2",
                          "--max_epochs", "2", "--grace_period", "1",
                          "--reduction_factor", "2", "--replicate_reps", "1",
                          "--num_splits", "2", "--max_nfe", "40",
                          "--device", "cpu"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert lines[0]["best_val"] == out["best_val"]
    assert set(lines[0]["best_config"]) == set(sweep_cli.REPORTED)
    assert lines[1]["replication"]["val"]["n"] == 2
    assert all(t["cfg"].max_nfe == 40 for t in out["trials"])


def test_visualizations(tmp_path):
    from graphax_torch.drivers.visualize import (
        animate_diffusion, draw_attention_graph, plot_attention_heatmap,
        plot_image_diffusion,
    )

    data = make_sbm_dataset(num_nodes=40, seed=0, device="cpu")
    g = data.graph
    att = torch.from_numpy(np.random.RandomState(0).rand(g.edge_buffer_size))
    p1 = draw_attention_graph(g, att, out_path=str(tmp_path / "g.png"))
    p2 = plot_attention_heatmap(g, att, out_path=str(tmp_path / "h.png"))
    x0 = np.random.rand(2, 28 * 28)
    p3 = plot_image_diffusion(x0, torch.from_numpy(x0 * 0.5), 28, 28,
                              out_path=str(tmp_path / "d.png"),
                              num_images=2)
    p4 = animate_diffusion([torch.from_numpy(x0[0] * s) for s in (1, .5)],
                           28, 28, out_path=str(tmp_path / "a.gif"))
    for p in (p1, p2, p3, p4):
        assert os.path.exists(p) and os.path.getsize(p) > 0


def test_visualize_is_off_the_training_path():
    """No module of the port imports matplotlib or networkx when it is
    imported: only the figure functions do, inside their bodies."""
    root = pathlib.Path(__file__).resolve().parents[1] / "graphax_torch"
    for path in root.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in tree.body:
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            assert not [n for n in names if n.split(".")[0] in
                        ("matplotlib", "networkx")], path


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    with profile_trace(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not os.path.exists(tmp_path / "off")


def test_throughput_meter():
    meter = ThroughputMeter(units_per_call=1000.0)
    for _ in range(3):
        with meter:
            time.sleep(0.01)
    assert meter.total_units == 3000.0 and meter.total_time >= 0.03
    assert 0 < meter.rate <= 3000.0 / 0.03
    assert ThroughputMeter(5.0).rate == 0.0


def test_count_launch_loses_no_count_under_threads(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", type(_build.LAUNCHES)())

    def work():
        for _ in range(20_000):
            _build.count_launch("spmm_csr")

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert _build.LAUNCHES["spmm_csr"] == 80_000


def test_build_all_from_two_threads_builds_each_library_once(
        monkeypatch, tmp_path):
    """Two threads entering ``build_all`` together: one compiles each
    source once (here a stand-in compiler that writes its output after a
    pause), the other waits and finds every library loaded; no temporary
    file is left."""
    calls = []

    class Compiler:
        def __init__(self, cmd, **kw):
            calls.append(cmd[cmd.index("-o") + 1])
            self.out, self.returncode = cmd[cmd.index("-o") + 1], 0

        def communicate(self):
            time.sleep(0.2)
            with open(self.out, "w") as f:
                f.write("so")
            return b"", None

    loaded = []
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Compiler)

    def load(name):
        if name not in _build._LIBS:
            loaded.append(name)
            _build._LIBS[name] = name
        return _build._LIBS[name]

    monkeypatch.setattr(_build, "_load", load)
    threads = [threading.Thread(target=_build.build_all) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == len(_build.SIGNATURES) == len(set(calls))
    assert sorted(loaded) == sorted(_build.SIGNATURES)
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(_build._target(n)[1]) for n in _build.SIGNATURES)
