"""The GRAND/BLEND node classifier: encoder -> ODE block -> decoder (port
of `graphax/models/gnn.py`).

encode: [strip labels] -> dropout -> m1 (or, Beltrami, mx on the features
        and mp on the positional encodings, each after its own dropout,
        concatenated ``[features | positional]``) -> [residual MLP m11/m12]
        -> [re-append labels] -> [batch-norm] -> [ANODE augmentation:
        append zeros]
solve:  block over [0, T] with the state in ``cfg.dtype`` (bf16 halves the
        solver's memory traffic; the encoder and decoder stay f32)
decode: [truncate augmentation] -> relu -> [fc -> relu] -> dropout -> m2

Module and parameter names follow graphax's param tree, so
`graphax_torch.utils.transplant.load_graphax_params` maps one onto the
other."""

from __future__ import annotations

import torch
from torch import nn

from graphax_torch.blocks import get_block
from graphax_torch.models.layers import BatchNorm, dropout
from graphax_torch.utils.params import linear_apply, linear_init


class GNN(nn.Module):
    def __init__(self, cfg, num_features: int, num_classes: int):
        super().__init__()
        self.cfg = cfg
        self.num_classes = num_classes
        self.state_dim = cfg.state_dim(num_features, num_classes)
        base = self.state_dim // 2 if cfg.augment else self.state_dim
        if cfg.beltrami:
            if cfg.pos_enc_dim <= 0:
                raise ValueError("beltrami requires cfg.pos_enc_dim (the "
                                 "positional encodings' width)")
            self.mx = nn.Linear(num_features, cfg.feat_hidden_dim)
            self.mp = nn.Linear(cfg.pos_enc_dim, cfg.pos_enc_hidden_dim)
            hidden = cfg.feat_hidden_dim + cfg.pos_enc_hidden_dim
        else:
            hidden = cfg.hidden_dim
            self.m1 = nn.Linear(num_features, hidden)
        if cfg.use_mlp:
            self.m11 = nn.Linear(hidden, hidden)
            self.m12 = nn.Linear(hidden, hidden)
        if cfg.fc_out:
            self.fc = nn.Linear(base, base)
        self.m2 = nn.Linear(base, num_classes)
        if cfg.batch_norm:
            self.bn_in = BatchNorm(base)
            self.bn_out = BatchNorm(base)  # allocated but unused, as in graphax
        self.block = get_block(cfg, self.state_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("m1", "mx", "mp", "m11", "m12", "fc", "m2"):
            if hasattr(self, name):
                linear_init(getattr(self, name), generator)
        for name in ("bn_in", "bn_out"):
            if hasattr(self, name):
                getattr(self, name).reset_parameters()
        self.block.reset_parameters(generator)

    def encode(self, x, *, train: bool, generator=None, pos_encoding=None):
        """``x``: the features, and under ``use_labels`` the label columns
        last (`graphax_torch.train.loop.add_labels`), which skip the input
        dropout and the MLP and join the state before the batch-norm.
        ``pos_encoding [N, P]``: Beltrami's positional encodings."""
        cfg = self.cfg
        if cfg.use_labels:
            labels = x[..., -self.num_classes:]
            x = x[..., :-self.num_classes]
        if cfg.beltrami:
            if pos_encoding is None:
                raise ValueError("beltrami needs the positional encodings "
                                 "(data.pos_encoding)")
            x = linear_apply(self.mx, dropout(x, cfg.input_dropout, train,
                                              generator))
            p = linear_apply(self.mp, dropout(pos_encoding,
                                              cfg.input_dropout, train,
                                              generator))
            x = torch.cat([x, p], dim=-1)
        else:
            x = dropout(x, cfg.input_dropout, train, generator)
            x = linear_apply(self.m1, x)
        if cfg.use_mlp:
            x = dropout(x, cfg.dropout, train, generator)
            x = dropout(x + linear_apply(self.m11, torch.relu(x)),
                        cfg.dropout, train, generator)
            x = dropout(x + linear_apply(self.m12, torch.relu(x)),
                        cfg.dropout, train, generator)
        if cfg.use_labels:
            x = torch.cat([x, labels], dim=-1)
        if cfg.batch_norm:
            x = self.bn_in(x, train)
        if cfg.augment:
            x = torch.cat([x, torch.zeros_like(x)], dim=-1)
        return x

    def decode(self, z, *, train: bool, generator=None):
        cfg = self.cfg
        if cfg.augment:
            z = z[..., : z.shape[-1] // 2]
        z = torch.relu(z)
        if cfg.fc_out:
            z = torch.relu(linear_apply(self.fc, z))
        z = dropout(z, cfg.dropout, train, generator)
        return linear_apply(self.m2, z)

    def forward_ode(self, graph, x, *, train: bool, generator=None, t1=None,
                    observer=None, max_steps=None, pos_encoding=None):
        """Encode and solve, no decode (graphax's `forward_ode`). Returns
        (z in the encoder's dtype, BlockOutput)."""
        x0 = self.encode(x, train=train, generator=generator,
                         pos_encoding=pos_encoding)
        ode_dtype = getattr(torch, self.cfg.dtype)
        out = self.block(graph, x0.to(ode_dtype), train=train, t1=t1,
                         observer=observer, max_steps=max_steps)
        return out.z.to(x0.dtype), out

    def forward(self, graph, x, *, train: bool, generator=None, t1=None,
                observer=None, max_steps=None, pos_encoding=None):
        """Returns (logits, BlockOutput). ``t1``, ``observer`` and
        ``max_steps`` go to the solve (the early-stop evaluation's)."""
        z, out = self.forward_ode(graph, x, train=train, generator=generator,
                                  t1=t1, observer=observer,
                                  max_steps=max_steps,
                                  pos_encoding=pos_encoding)
        return self.decode(z, train=train, generator=generator), out
