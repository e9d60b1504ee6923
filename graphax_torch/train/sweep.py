"""Hyperparameter sweeps without Ray (port of `graphax/train/sweep.py`).

The reference drives its sweeps through Ray Tune with an ASHA scheduler
(`src/ray_tune.py:359-394`, `src/graph_datasets/ray_tune.py:547-586`) and
replicates the best trial with mean, sem and 95 % interval
(`src/run_best_ray.py`). Here, as in graphax: the same per-dataset search
spaces, an in-process successive-halving runner (ASHA-style) whose trial
table and per-trial checkpoints make it resumable, `replicate_best` for
the reps x splits statistics, and a Tree-structured Parzen Estimator
(``search="bayes"``, the role of the reference's AxSearch). Sampling and
TPE are numpy only: the same seed and observations give graphax's configs
and proposals bit for bit.

**Concurrent trials** (``max_concurrent > 1``, Ray's parallel actors):
each in-flight trial runs in a thread of its own, on a device of
``devices`` (round-robin; default: every visible card) under
``torch.cuda.device`` and on a CUDA stream of its own, so trials overlap
on one card as on several. The stream first waits for the work queued
before it (the shared dataset's), and is synchronised when the trial
ends. A CPU caller passes CPU devices, and its ``make_trainer`` builds on
the CPU. Configs are sampled up front and a rung's promotion waits for
the whole rung, so the result is the sequential run's."""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from graphax_torch.train.config import Config
from graphax_torch.utils.device import resolve_device
from graphax_torch.utils.stats import summarize_runs


# -- search spaces (`set_cora_search_space` et al., ray_tune.py:187-345) ----

def loguniform(lo, hi):
    return ("loguniform", lo, hi)


def uniform(lo, hi):
    return ("uniform", lo, hi)


def choice(*opts):
    return ("choice", list(opts))


SEARCH_SPACES = {
    "Cora": {
        "decay": loguniform(1e-3, 1e-1),
        "lr": loguniform(5e-3, 5e-2),
        "dropout": uniform(0.0, 0.8),
        "input_dropout": uniform(0.2, 0.8),
        "hidden_dim": choice(32, 64, 80, 128),
        "heads": choice(1, 2, 4, 8),
        "time": uniform(2.0, 30.0),
        "tol_scale": loguniform(1.0, 1e4),
        "attention_dim": choice(16, 32, 64, 128),
        "block": choice("constant", "attention"),
    },
}
SEARCH_SPACES["Citeseer"] = SEARCH_SPACES["Cora"]
SEARCH_SPACES["Pubmed"] = SEARCH_SPACES["Cora"]
SEARCH_SPACES["default"] = SEARCH_SPACES["Cora"]


def sample_config(base: Config, space: Dict[str, Any],
                  rng: np.random.RandomState) -> Config:
    return _apply_kwargs(base, sample_config_kwargs(space, rng))


# -- TPE proposer (model-based search, `src/ray_tune.py:359-394` role) ------

def _to_unit(spec, val):
    """Map a sampled value into [0, 1] (log space for loguniform)."""
    kind = spec[0]
    if kind == "loguniform":
        lo, hi = math.log(spec[1]), math.log(spec[2])
        return (math.log(val) - lo) / (hi - lo)
    if kind == "uniform":
        return (val - spec[1]) / (spec[2] - spec[1])
    raise ValueError(kind)


def _from_unit(spec, u):
    u = min(max(u, 0.0), 1.0)
    if spec[0] == "loguniform":
        lo, hi = math.log(spec[1]), math.log(spec[2])
        return float(math.exp(lo + u * (hi - lo)))
    return float(spec[1] + u * (spec[2] - spec[1]))


class TPEProposer:
    """Independent-dimension Tree-structured Parzen Estimator (graphax's).

    Observations are split at the ``gamma`` quantile of the score into a
    good and a bad set; each numeric dimension gets a Parzen (Gaussian
    mixture) density per set in unit space, with a uniform prior component,
    each categorical dimension a smoothed histogram. Candidates are drawn
    from the good density and the one maximising l(x)/g(x) is proposed."""

    def __init__(self, space: Dict[str, Any], seed: int = 0,
                 gamma: float = 0.25, n_candidates: int = 24):
        self.space = space
        self.rng = np.random.RandomState(seed)
        self.gamma = gamma
        self.n_candidates = n_candidates

    @staticmethod
    def _parzen_logpdf(u, centers, prior_weight=1.0):
        """log density at ``u`` of Gaussians at ``centers`` (unit space)
        plus a uniform-[0, 1] prior component."""
        n = len(centers)
        sigma = max(0.5 * n ** -0.5, 0.08)
        comps = np.exp(-0.5 * ((u - np.asarray(centers)) / sigma) ** 2) \
            / (sigma * math.sqrt(2 * math.pi))
        total = (prior_weight + comps.sum()) / (prior_weight + n)
        return math.log(max(total, 1e-300))

    @staticmethod
    def _cat_logpmf(idx, observed_idx, n_opts):
        counts = np.bincount(observed_idx, minlength=n_opts).astype(float)
        probs = (counts + 1.0) / (counts.sum() + n_opts)
        return math.log(probs[idx])

    def _split(self, observations):
        scores = np.asarray([s for _, s in observations])
        n_good = max(1, int(math.ceil(self.gamma * len(scores))))
        order = np.argsort(-scores)          # maximise the score (val_acc)
        good = [observations[i][0] for i in order[:n_good]]
        bad = [observations[i][0] for i in order[n_good:]]
        return good, bad

    def propose(self, observations: List) -> Dict[str, Any]:
        """``observations``: ``(kwargs, score)`` pairs; returns a new
        kwargs dict over the search space."""
        if len(observations) < 2:
            return sample_config_kwargs(self.space, self.rng)
        good, bad = self._split(observations)
        best_kw, best_ratio = None, -math.inf
        for _ in range(self.n_candidates):
            kw, ratio = {}, 0.0
            for name, spec in self.space.items():
                if spec[0] == "choice":
                    opts = spec[1]
                    g_idx = [opts.index(o[name]) for o in good
                             if o[name] in opts]
                    b_idx = [opts.index(o[name]) for o in bad
                             if o[name] in opts]
                    counts = np.bincount(g_idx, minlength=len(opts)) + 1.0
                    i = self.rng.choice(len(opts), p=counts / counts.sum())
                    kw[name] = opts[i]
                    ratio += self._cat_logpmf(i, g_idx, len(opts)) \
                        - self._cat_logpmf(i, b_idx, len(opts))
                else:
                    g_u = [_to_unit(spec, o[name]) for o in good]
                    b_u = [_to_unit(spec, o[name]) for o in bad]
                    # draw from the good mixture (or the prior)
                    if self.rng.rand() < 1.0 / (len(g_u) + 1):
                        u = self.rng.rand()
                    else:
                        c = g_u[self.rng.randint(len(g_u))]
                        u = min(max(self.rng.normal(
                            c, max(0.5 * len(g_u) ** -0.5, 0.08)), 0.0), 1.0)
                    kw[name] = _from_unit(spec, u)
                    ratio += self._parzen_logpdf(u, g_u) \
                        - self._parzen_logpdf(u, b_u)
            if ratio > best_ratio:
                best_kw, best_ratio = kw, ratio
        return best_kw


def sample_config_kwargs(space: Dict[str, Any],
                         rng: np.random.RandomState) -> Dict[str, Any]:
    kw = {}
    for name, spec in space.items():
        kind = spec[0]
        if kind == "loguniform":
            kw[name] = float(np.exp(rng.uniform(np.log(spec[1]),
                                                np.log(spec[2]))))
        elif kind == "uniform":
            kw[name] = float(rng.uniform(spec[1], spec[2]))
        elif kind == "choice":
            kw[name] = spec[1][rng.randint(len(spec[1]))]
    return kw


def _apply_kwargs(base: Config, kw: Dict[str, Any]) -> Config:
    """``base`` with ``kw``, attention_dim rounded down to a multiple of
    heads (at least heads)."""
    kw = dict(kw)
    if "heads" in kw and "attention_dim" in kw:
        if kw["attention_dim"] % kw["heads"] != 0:
            kw["attention_dim"] = kw["heads"] * max(
                kw["attention_dim"] // kw["heads"], 1)
    return base.replace(**kw)


# -- concurrent trial execution (Ray actors, ray_tune.py:568-586) -----------

def default_devices() -> list:
    """Every visible card; raises where there is none (a CPU caller passes
    CPU devices)."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@contextlib.contextmanager
def on_device(dev):
    """Run the body on ``dev``: a card's body under ``torch.cuda.device``
    on a stream of its own that first waits for the card's current stream
    (the shared dataset's work), and is synchronised at the end, so the
    trial's work is finished and none of its memory is still in use when
    it returns. A CPU device (or None) runs the body as it is."""
    if dev is None or torch.device(dev).type != "cuda":
        yield
        return
    dev = torch.device(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(stream):
                yield
        finally:
            stream.synchronize()


def _in_threads(n: int, max_concurrent: int, devices, run_one) -> None:
    """``run_one(i, device)`` for i < n, ``max_concurrent`` at a time in
    threads, job i on ``devices[i % len(devices)]``; the first error
    raises."""
    from concurrent.futures import ThreadPoolExecutor

    devs = list(devices) if devices is not None else default_devices()
    with ThreadPoolExecutor(max_workers=min(max_concurrent, n)) as ex:
        futs = [ex.submit(run_one, i, devs[i % len(devs)]) for i in range(n)]
        for f in futs:
            f.result()


def _run_trials(todo, rung, make_trainer, checkpoint_dir, on_done,
                max_concurrent=None, devices=None):
    """Train every trial in ``todo`` to ``rung`` epochs; concurrently when
    ``max_concurrent > 1`` (a thread per in-flight trial, on a device of
    ``devices`` round-robin, on a stream of its own). ``on_done(t)`` runs
    under a lock."""
    import os

    lock = threading.Lock()

    def run_one(t, dev):
        with on_device(dev):
            trainer = make_trainer(t["cfg"])
            fit_kwargs = {}
            if checkpoint_dir is not None:
                fit_kwargs = dict(
                    checkpoint_path=os.path.join(checkpoint_dir,
                                                 f"trial_{t['id']}.ckpt"),
                    checkpoint_every=1)
            result = trainer.fit(epochs=rung, **fit_kwargs)
        with lock:
            t["epochs_done"] = rung
            t["val_acc"] = result["best"]["val_acc"]
            t["test_acc"] = result["best"]["test_acc"]
            t["device"] = str(dev) if dev is not None else None
            on_done(t)

    if not todo:
        return
    if max_concurrent is None or max_concurrent <= 1:
        for t in todo:
            run_one(t, None)
        return
    _in_threads(len(todo), max_concurrent, devices,
                lambda i, dev: run_one(todo[i], dev))


def _save_sweep_state(path: str, trials, rung: int, alive_ids) -> None:
    import dataclasses
    import json
    import os

    payload = {
        "rung": rung,
        "alive_ids": list(alive_ids),
        "trials": [{**t, "cfg": dataclasses.asdict(t["cfg"])}
                   for t in trials],
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def _load_sweep_state(path: str):
    import json
    import os

    if not os.path.exists(path):
        return None
    with open(path) as f:
        payload = json.load(f)
    for t in payload["trials"]:
        t["cfg"] = Config(**t["cfg"])
    return payload


def asha_sweep(make_trainer: Callable[[Config], Any], base: Config,
               space: Optional[Dict[str, Any]] = None, num_samples: int = 16,
               max_epochs: int = 64, grace_period: int = 4,
               reduction_factor: int = 4, seed: int = 0,
               verbose: bool = False,
               checkpoint_dir: Optional[str] = None,
               max_concurrent: Optional[int] = None,
               devices: Optional[List] = None,
               search: str = "random") -> Dict[str, Any]:
    """Successive halving, run rung by rung (graphax's `asha_sweep`):
    every surviving trial trains to the rung's epochs and the top
    1/reduction_factor go on. ``make_trainer(cfg)`` returns an object with
    ``fit(epochs) -> {'best': {'val_acc': ..., 'test_acc': ...}}``.

    ``checkpoint_dir`` makes the sweep resumable (the reference's
    per-epoch Ray trial checkpoints, `src/graph_datasets/ray_tune.py:
    167-197`): the trial table goes to ``sweep_state.json`` after every
    trial's rung, each trial's model and optimizer to ``trial_{id}.ckpt``
    (``Trainer.fit(checkpoint_path=, checkpoint_every=1)``), so a later
    rung continues a trial and a killed sweep resumes where it stopped.

    ``max_concurrent > 1`` trains that many trials of a rung at once (the
    module's docstring); the result is the sequential run's.

    ``search="bayes"``: after a random start-up wave, the first rung's
    results feed a TPE proposer and the remaining trials are proposed wave
    by wave."""
    import os

    space = space or SEARCH_SPACES.get(base.dataset,
                                       SEARCH_SPACES["default"])
    state_path = None
    saved = None
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        state_path = os.path.join(checkpoint_dir, "sweep_state.json")
        saved = _load_sweep_state(state_path)

    if saved is not None:
        trials = saved["trials"]
        rung = saved["rung"]
        alive = [t for t in trials if t["id"] in set(saved["alive_ids"])]
    else:
        rng = np.random.RandomState(seed)
        if search == "bayes":
            trials = []     # proposed wave by wave below
        else:
            trials = [
                {"cfg": sample_config(base, space, rng), "epochs_done": 0,
                 "val_acc": 0.0, "test_acc": 0.0, "id": i}
                for i in range(num_samples)
            ]
        rung = grace_period
        alive = list(trials)

    def on_done(t):
        if verbose:
            print(f"trial {t['id']:3d} @ {t['epochs_done']:3d}ep: "
                  f"val {t['val_acc']:.4f}")
        if state_path is not None:
            _save_sweep_state(state_path, trials, rung,
                              [a["id"] for a in alive])

    # -- bayes population fill: waves of TPE proposals at the grace rung --
    if search == "bayes" and len(trials) < num_samples \
            and rung == grace_period:
        # reseed past whatever a resumed sweep already consumed
        rng = np.random.RandomState(seed + 1000 * len(trials))
        wave = max(1, max_concurrent or 1)
        startup = min(num_samples, max(4, wave))
        proposer = TPEProposer(space, seed=seed)
        while True:
            # a resumed sweep first finishes the trials already made that
            # are short of the grace rung (else it could propose nothing
            # new and spin: graphax's progress guarantee)
            pending = [t for t in trials
                       if t["epochs_done"] < grace_period]
            if pending:
                alive = list(trials)
                _run_trials(pending, grace_period, make_trainer,
                            checkpoint_dir, on_done, max_concurrent,
                            devices)
                continue
            if len(trials) >= num_samples:
                break
            done = [t for t in trials if t["epochs_done"] >= grace_period]
            if len(done) < startup:
                kws = [sample_config_kwargs(space, rng)
                       for _ in range(startup - len(done))]
            else:
                obs = [(t["kw"], t["val_acc"]) for t in done if "kw" in t]
                kws = [proposer.propose(obs)
                       for _ in range(min(wave, num_samples - len(trials)))]
            kws = kws[:num_samples - len(trials)]
            new = [{"cfg": _apply_kwargs(base, kw), "kw": kw,
                    "epochs_done": 0, "val_acc": 0.0, "test_acc": 0.0,
                    "id": len(trials) + i} for i, kw in enumerate(kws)]
            trials.extend(new)
            alive = list(trials)
            _run_trials(new, grace_period, make_trainer, checkpoint_dir,
                        on_done, max_concurrent, devices)
        alive = list(trials)

    while alive:
        todo = [t for t in alive if t["epochs_done"] < rung]
        _run_trials(todo, rung, make_trainer, checkpoint_dir, on_done,
                    max_concurrent, devices)
        if rung >= max_epochs:
            break
        alive.sort(key=lambda t: -t["val_acc"])
        keep = max(len(alive) // reduction_factor, 1)
        alive = alive[:keep]
        rung = min(rung * reduction_factor, max_epochs)
        if state_path is not None:
            _save_sweep_state(state_path, trials, rung,
                              [a["id"] for a in alive])

    best = max(trials, key=lambda t: t["val_acc"])
    return {"best_config": best["cfg"], "best_val": best["val_acc"],
            "best_test": best["test_acc"], "trials": trials}


def replicate_best(make_trainer: Callable[[Config, int], Any], cfg: Config,
                   reps: int = 3, num_splits: int = 2,
                   epochs: Optional[int] = None,
                   max_concurrent: Optional[int] = None,
                   devices: Optional[List] = None) -> Dict[str, Any]:
    """Re-run ``cfg`` reps x splits times and report mean, std, sem and 95 %
    interval (`src/run_best_ray.py:56-74`). ``make_trainer(cfg,
    split_seed)``; replica ``(split, rep)`` trains from seed ``rep * 1000 +
    split``. ``max_concurrent > 1`` runs replicas at once, as the sweep's
    concurrent trials."""
    jobs = [(split, rep) for split in range(num_splits)
            for rep in range(reps)]
    results = [None] * len(jobs)

    def run_one(i, dev):
        split, rep = jobs[i]
        with on_device(dev):
            trainer = make_trainer(cfg, split)
            out = trainer.fit(epochs=epochs, seed=rep * 1000 + split)
        results[i] = (out["best"]["val_acc"], out["best"]["test_acc"])

    if max_concurrent is None or max_concurrent <= 1:
        for i in range(len(jobs)):
            run_one(i, None)
    else:
        _in_threads(len(jobs), max_concurrent, devices, run_one)
    vals = [v for v, _ in results]
    tests = [t for _, t in results]
    return {"val": summarize_runs(vals), "test": summarize_runs(tests),
            "raw_val": vals, "raw_test": tests}
