"""The port's `run_gnn` CLI (`graphax_torch/drivers/run_gnn.py`) and run
statistics (`graphax_torch/utils/stats.py`) against graphax's on the CPU:
the parser's flags, the Config of each argument list, the summary
statistics (to 1e-12), the split of each repetition, the sharded route's
refusal, graphax's CLI oracles (`tests/test_drivers.py`), a 2-split `run`
held to the same fits made by hand, and the README's Quickstart command on
the Cora stand-in."""

import json

import numpy as np
import pytest

from graphax.data import get_dataset as gx_get_dataset
from graphax.drivers import run_gnn as gx_run_gnn
from graphax.train import Config as GxConfig
from graphax.utils import stats as gx_stats

import graphax_torch.data
from graphax_torch.data import get_dataset, make_sbm_dataset
from graphax_torch.drivers import run_gnn, run_gnn_main
from graphax_torch.train import Config, Trainer
from graphax_torch.utils import stats
from graphax_torch.utils.stats import summarize_runs

from torch_surface_helpers import one_torch_thread  # noqa: F401 (autouse)

FIXTURES = "tests/fixtures/datasets"

ARGVS = [
    ["--dataset", "Cora", "--use_best_params", "--lr", "0.5"],
    ["--dataset", "Citeseer", "--hidden_dim", "24", "--adjoint", "true"],
    ["--dataset", "ogbn-arxiv", "--use_best_params", "--epoch", "2",
     "--num_splits", "2", "--community_window", "0"],
    ["--dataset", "Pubmed", "--use_best_params", "--beltrami", "1",
     "--attention_type", "exp_kernel", "--tol_scale", "3.5",
     "--jacobian_norm2", "0.01", "--rewiring", "gdc"],
    ["--dataset", "Computers", "--use_best_params", "--mesh_shape", "2,1",
     "--no_early", "false", "--data_dir", "/nowhere", "--log_every", "3"],
    ["--dataset", "Photo", "--block", "hard_attention", "--att_samp_pct",
     "0.5", "--method", "rk4", "--step_size", "0.25", "--dtype",
     "bfloat16"],
    [],
]


def _flags(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_parser_takes_graphax_flags_and_device():
    ours = _flags(run_gnn.build_parser())
    theirs = _flags(gx_run_gnn.build_parser())
    assert ours == theirs | {"--device"}


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "none")
def test_config_from_args_matches_graphax(argv):
    ours = run_gnn.build_parser().parse_args(argv)
    theirs = gx_run_gnn.build_parser().parse_args(argv)
    assert ours.device is None
    assert run_gnn.config_from_args(ours).to_dict() \
        == gx_run_gnn.config_from_args(theirs).to_dict()


def test_cli_best_params_precedence():
    args = run_gnn.build_parser().parse_args(
        ["--dataset", "Cora", "--use_best_params", "--lr", "0.5"])
    cfg = run_gnn.config_from_args(args)
    assert cfg.block == "attention"         # from best params
    assert abs(cfg.lr - 0.5) < 1e-9         # explicit CLI wins
    assert abs(cfg.time - 18.294754260552843) < 1e-9


def test_cli_plain_config():
    args = run_gnn.build_parser().parse_args(["--dataset", "Citeseer",
                                              "--hidden_dim", "24",
                                              "--adjoint", "true"])
    cfg = run_gnn.config_from_args(args)
    assert cfg.hidden_dim == 24 and cfg.adjoint and cfg.dataset == "Citeseer"


@pytest.mark.parametrize("values", [
    [], [0.5], [0.7, 0.7], [0.81, 0.79, 0.8342, 0.7766],
    list(np.random.RandomState(0).rand(9))])
def test_summarize_runs_matches_graphax(values):
    ours, theirs = summarize_runs(values), gx_stats.summarize_runs(values)
    assert set(ours) == set(theirs) == {"mean", "std", "sem", "ci95", "n"}
    assert ours["n"] == theirs["n"]
    for k in ("mean", "std", "sem", "ci95"):
        if np.isnan(theirs[k]):
            assert np.isnan(ours[k])
        else:
            assert abs(ours[k] - theirs[k]) <= 1e-12, k
    assert stats.get_sem(values) == gx_stats.get_sem(values)
    assert stats.mean_confidence_interval(values, 0.9) \
        == gx_stats.mean_confidence_interval(values, 0.9)


@pytest.mark.parametrize("name,data_dir,over", [
    ("Cora", "/nonexistent-graphax-data", {}),
    ("Cora", FIXTURES, {}),
    ("Cora", FIXTURES, dict(planetoid_split=True)),
    ("Citeseer", FIXTURES, {}),
    ("Computers", FIXTURES, {}),
])
def test_split_masks_match_graphax(name, data_dir, over):
    """The data of run_gnn's splits 0 and 1 (``split_seed = 12345 +
    split``): the largest connected component, labels and the three masks
    equal graphax's; the two splits' train masks differ where the split is
    drawn."""
    masks = []
    for split in (0, 1):
        ours = get_dataset(Config(dataset=name, **over), data_dir=data_dir,
                           split_seed=12345 + split, device="cpu")
        theirs = gx_get_dataset(GxConfig(dataset=name, **over),
                                data_dir=data_dir, split_seed=12345 + split)
        assert ours.num_nodes == theirs.num_nodes
        for m in ("train_mask", "val_mask", "test_mask", "y"):
            np.testing.assert_array_equal(getattr(ours, m).numpy(),
                                          np.asarray(getattr(theirs, m)))
        np.testing.assert_array_equal(ours.x.numpy(), np.asarray(theirs.x))
        masks.append(ours.train_mask.numpy())
    if not over.get("planetoid_split"):
        assert not np.array_equal(*masks)


@pytest.mark.parametrize("argv", [["--distributed"], ["--mesh_shape", "4"],
                                  ["--mesh_shape", "2,2"]])
def test_sharded_route_names_item_12(argv):
    with pytest.raises(NotImplementedError, match="Queue 1, item 12"):
        run_gnn_main(["--dataset", "Cora", "--device", "cpu"] + argv)


SMALL = Config(dataset="sbm80", hidden_dim=8, block="constant",
               function="laplacian", method="euler", step_size=1.0,
               time=2.0, epoch=3, lr=0.02, no_early=True,
               self_loop_weight=1.0, num_splits=2, input_dropout=0.2,
               dropout=0.2)


def _sbm80(cfg_or_name, data_dir="./data", split_seed=12345, device=None,
           **_):
    return make_sbm_dataset(num_nodes=80, num_features=8, num_classes=3,
                            p_in=0.15, p_out=0.01, seed=split_seed,
                            device=device)


def test_run_two_splits_on_the_port_trainer(monkeypatch, capsys):
    """A 2-split run on an 80-node SBM: a line per split and the summary
    line, equal to the same fits made by hand (split i's data from seed
    12345 + i, trained from seed i)."""
    monkeypatch.setattr(graphax_torch.data, "get_dataset", _sbm80)
    summary = run_gnn.run(SMALL, log_every=0, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert [line.split(":")[0] for line in out[:2]] == ["split 0", "split 1"]
    assert json.loads(out[2]) == summary
    fits = [Trainer(SMALL, _sbm80(SMALL, split_seed=12345 + s, device="cpu"),
                    device="cpu").fit(seed=s)["best"] for s in (0, 1)]
    assert summary == {k: summarize_runs([f[k + "_acc"] for f in fits])
                       for k in ("val", "test")}
    assert summary["test"]["n"] == 2 and summary["test"]["sem"] >= 0.0


def test_quickstart_command_on_the_cora_stand_in(capsys):
    """The README's Quickstart twin, ``run_gnn --dataset Cora
    --use_best_params`` on the CPU and the synthetic fallback, cut to one
    epoch: graphax's summary line."""
    summary = run_gnn_main(["--dataset", "Cora", "--use_best_params",
                            "--device", "cpu", "--epoch", "1",
                            "--num_splits", "1",
                            "--data_dir", "/nonexistent-graphax-data"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == summary
    for part in ("val", "test"):
        assert set(last[part]) == {"mean", "std", "sem", "ci95", "n"}
        assert last[part]["n"] == 1 and 0.0 <= last[part]["mean"] <= 1.0
