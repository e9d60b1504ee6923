"""Experiment drivers: the solver comparison (`explicit_implicit`) and the
CGNN baseline (`run_cgnn`), ports of `graphax/drivers/`."""
