"""Parameter helpers, run statistics, profiling and meters, weight
transplant from graphax, device resolution."""

from graphax_torch.utils.device import resolve_device
from graphax_torch.utils.params import linear_apply, linear_init
from graphax_torch.utils.profiling import ThroughputMeter, profile_trace
from graphax_torch.utils.stats import (
    get_sem, mean_confidence_interval, summarize_runs,
)
from graphax_torch.utils.transplant import load_graphax_params

__all__ = ["ThroughputMeter", "get_sem", "linear_apply", "linear_init",
           "load_graphax_params", "mean_confidence_interval",
           "profile_trace", "resolve_device", "summarize_runs"]
