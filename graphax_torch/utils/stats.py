"""Run statistics: mean, std, sem and the 95 % t-interval over repeated runs
(port of `graphax/utils/stats.py`, the twin of the reference's
`src/utils.py:236-268` and the reporting of `src/run_best_ray.py:69-74`).
numpy only; scipy's t distribution is imported inside the one function that
needs it, as graphax does."""

from __future__ import annotations

import numpy as np


def get_sem(vec) -> float:
    """Standard error of the mean (`src/utils.py:258-268`)."""
    a = np.asarray(vec, dtype=np.float64)
    if a.size <= 1:
        return 0.0
    return float(a.std(ddof=1) / np.sqrt(a.size))


def mean_confidence_interval(data, confidence: float = 0.95) -> float:
    """Half-width of the t-distribution interval (`src/utils.py:236-249`)."""
    a = np.asarray(data, dtype=np.float64)
    n = a.size
    if n < 2:
        return 0.0
    from scipy import stats

    se = a.std(ddof=1) / np.sqrt(n)
    return float(se * stats.t.ppf((1 + confidence) / 2.0, n - 1))


def summarize_runs(values) -> dict:
    """``mean``, ``std`` (ddof 1), ``sem``, ``ci95`` and ``n`` of
    ``values``."""
    a = np.asarray(values, dtype=np.float64)
    return {
        "mean": float(a.mean()) if a.size else float("nan"),
        "std": float(a.std(ddof=1)) if a.size > 1 else 0.0,
        "sem": get_sem(a),
        "ci95": mean_confidence_interval(a),
        "n": int(a.size),
    }
