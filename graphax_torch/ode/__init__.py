"""ODE integrators (fixed-grid RK, Adams, adaptive RK, continuous
adjoint)."""

from graphax_torch.ode.solvers import (
    ADAMS_METHODS, ADAPTIVE_METHODS, FIXED_STEP_METHODS, AdjointRecord,
    ODEResult, Observer, odeint, odeint_adjoint,
)
from graphax_torch.ode.tableaus import TABLEAUS

__all__ = ["ADAMS_METHODS", "ADAPTIVE_METHODS", "FIXED_STEP_METHODS",
           "AdjointRecord", "ODEResult", "Observer", "TABLEAUS", "odeint",
           "odeint_adjoint"]
