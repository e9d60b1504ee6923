"""Device resolution for the port's entry points.

Entry points default to the card. They run on the CPU only when the caller
asks for it (``device="cpu"``, as the tests do); asking for CUDA where there
is none raises instead of carrying on quietly on the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "graphax_torch: CUDA was requested (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev
