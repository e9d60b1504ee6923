"""Parameter helpers, weight transplant from graphax, device resolution."""

from graphax_torch.utils.device import resolve_device
from graphax_torch.utils.params import linear_apply, linear_init
from graphax_torch.utils.transplant import load_graphax_params

__all__ = ["linear_apply", "linear_init", "load_graphax_params",
           "resolve_device"]
