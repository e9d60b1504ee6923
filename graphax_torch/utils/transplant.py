"""Load graphax's parameter tree and model state into the port's modules.

graphax keeps parameters in nested dicts with linear layers as
``{'w': [in, out], 'b': [out]}``; the port keeps them in ``nn.Module``s with
``nn.Linear`` weights ``[out, in]``. Every other leaf (scalars, batch-norm
``scale``/``bias`` and its ``mean``/``var``/``count`` state, the transformer
RHS's ``alpha_train``/``beta_train`` and exp_kernel's ``output_var``/
``lengthscale``) keeps its name and shape, so ``block.func.att.{Q,K,V,Wout}``
map onto `TransformerFunction.att`. Any missing or extra leaf, or a shape
that disagrees, raises."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def graphax_to_state_dict(params_np: Mapping, state_np: Mapping | None = None
                          ) -> dict:
    """graphax leaves under the port's ``state_dict`` names (weights
    transposed to ``[out, in]``)."""
    flat = _flatten(params_np)
    if state_np:
        flat.update(_flatten(state_np))
    out = {}
    for key, val in flat.items():
        head, _, leaf = key.rpartition(".")
        if leaf == "w":
            out[f"{head}.weight"] = val.T
        elif leaf == "b":
            out[f"{head}.bias"] = val
        else:
            out[key] = val
    return out


def load_graphax_params(model: nn.Module, params_np: Mapping,
                        state_np: Mapping | None = None) -> nn.Module:
    """Fill ``model`` (parameters and buffers) from graphax's param tree and
    model state given as numpy arrays. Raises on any missing or extra leaf
    and on any shape mismatch."""
    incoming = graphax_to_state_dict(params_np, state_np)
    target = model.state_dict()
    missing = sorted(set(target) - set(incoming))
    extra = sorted(set(incoming) - set(target))
    if missing or extra:
        raise KeyError(f"load_graphax_params: missing {missing}, extra {extra}")
    for key, val in incoming.items():
        t = target[key]
        if tuple(t.shape) != tuple(val.shape):
            raise ValueError(f"load_graphax_params: {key} has shape "
                             f"{tuple(val.shape)}, the model {tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(torch.as_tensor(np.array(val), dtype=t.dtype))
    return model
