"""Explicit Runge–Kutta Butcher tableaus (port of `graphax/ode/tableaus.py`).

Coefficient sets for the solver families the reference exposes through
`torchdiffeq` (`--method` / `--adjoint_method` flags,
`src/graph_datasets/run_GNN.py:330-346`): euler, midpoint, rk4 (torchdiffeq's
"rk4" is the 3/8-rule `rk4_alt_step_func`, which the reference's early-stop
RK4 also uses — `src/early_stop_solver.py:137-227`), adaptive_heun, bosh3,
and dopri5 (the Dormand–Prince 5(4) pair, `src/early_stop_solver.py:30-33`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np


class Tableau(NamedTuple):
    """Explicit RK tableau. ``b_err`` (solution minus embedded weights) is
    present only for adaptive pairs; ``order`` is the order used for step-size
    control exponents."""

    a: Tuple[Tuple[float, ...], ...]   # strictly lower-triangular stage coeffs
    b: Tuple[float, ...]               # solution weights
    c: Tuple[float, ...]               # stage times
    order: int
    b_err: Optional[Tuple[float, ...]] = None
    fsal: bool = False                 # first-same-as-last property


EULER = Tableau(a=((),), b=(1.0,), c=(0.0,), order=1)

MIDPOINT = Tableau(
    a=((), (0.5,)),
    b=(0.0, 1.0),
    c=(0.0, 0.5),
    order=2,
)

# torchdiffeq's fixed "rk4" — Kutta's 3/8 rule.
RK4_38 = Tableau(
    a=((),
       (1.0 / 3.0,),
       (-1.0 / 3.0, 1.0),
       (1.0, -1.0, 1.0)),
    b=(1.0 / 8.0, 3.0 / 8.0, 3.0 / 8.0, 1.0 / 8.0),
    c=(0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0),
    order=4,
)

# Classic RK4 kept for completeness / cross-checks.
RK4_CLASSIC = Tableau(
    a=((),
       (0.5,),
       (0.0, 0.5),
       (0.0, 0.0, 1.0)),
    b=(1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0),
    c=(0.0, 0.5, 0.5, 1.0),
    order=4,
)

# Adaptive Heun 2(1): trapezoidal solution with Euler embedded.
ADAPTIVE_HEUN = Tableau(
    a=((), (1.0,)),
    b=(0.5, 0.5),
    c=(0.0, 1.0),
    order=2,
    b_err=(0.5 - 1.0, 0.5 - 0.0),
    fsal=False,
)

# Bogacki–Shampine 3(2).
BOSH3 = Tableau(
    a=((),
       (0.5,),
       (0.0, 0.75),
       (2.0 / 9.0, 1.0 / 3.0, 4.0 / 9.0)),
    b=(2.0 / 9.0, 1.0 / 3.0, 4.0 / 9.0, 0.0),
    c=(0.0, 0.5, 0.75, 1.0),
    order=3,
    b_err=(2.0 / 9.0 - 7.0 / 24.0, 1.0 / 3.0 - 0.25,
           4.0 / 9.0 - 1.0 / 3.0, 0.0 - 0.125),
    fsal=True,
)

# Dormand–Prince 5(4) — the `dopri5` the reference uses everywhere.
_DOPRI5_B = (35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0,
             -2187.0 / 6784.0, 11.0 / 84.0, 0.0)
_DOPRI5_B_STAR = (5179.0 / 57600.0, 0.0, 7571.0 / 16695.0, 393.0 / 640.0,
                  -92097.0 / 339200.0, 187.0 / 2100.0, 1.0 / 40.0)
DOPRI5 = Tableau(
    a=((),
       (1.0 / 5.0,),
       (3.0 / 40.0, 9.0 / 40.0),
       (44.0 / 45.0, -56.0 / 15.0, 32.0 / 9.0),
       (19372.0 / 6561.0, -25360.0 / 2187.0, 64448.0 / 6561.0, -212.0 / 729.0),
       (9017.0 / 3168.0, -355.0 / 33.0, 46732.0 / 5247.0, 49.0 / 176.0,
        -5103.0 / 18656.0),
       _DOPRI5_B[:6]),
    b=_DOPRI5_B,
    c=(0.0, 0.2, 0.3, 0.8, 8.0 / 9.0, 1.0, 1.0),
    order=5,
    b_err=tuple(b - bs for b, bs in zip(_DOPRI5_B, _DOPRI5_B_STAR)),
    fsal=True,
)


TABLEAUS = {
    "euler": EULER,
    "midpoint": MIDPOINT,
    "rk4": RK4_38,
    "rk4_classic": RK4_CLASSIC,
    "adaptive_heun": ADAPTIVE_HEUN,
    "bosh3": BOSH3,
    "dopri5": DOPRI5,
}


def stacked(tab: Tableau):
    """Return (A [s,s], b [s], c [s], b_err [s] or None) as float64 numpy for
    embedding as compile-time constants."""
    s = len(tab.c)
    a = np.zeros((s, s), dtype=np.float64)
    for i, rowi in enumerate(tab.a):
        a[i, : len(rowi)] = rowi
    b = np.asarray(tab.b, dtype=np.float64)
    c = np.asarray(tab.c, dtype=np.float64)
    e = None if tab.b_err is None else np.asarray(tab.b_err, dtype=np.float64)
    return a, b, c, e
