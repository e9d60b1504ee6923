"""ODE integrators (fixed-grid RK, adaptive RK, continuous adjoint)."""

from graphax_torch.ode.solvers import (
    ADAPTIVE_METHODS, FIXED_STEP_METHODS, AdjointRecord, ODEResult, Observer,
    odeint, odeint_adjoint,
)
from graphax_torch.ode.tableaus import TABLEAUS

__all__ = ["ADAPTIVE_METHODS", "FIXED_STEP_METHODS", "AdjointRecord",
           "ODEResult", "Observer", "TABLEAUS", "odeint", "odeint_adjoint"]
