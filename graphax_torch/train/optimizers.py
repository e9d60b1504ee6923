"""Optimizers with optax's math, written out (port of
`graphax/train/optimizers.py`).

graphax builds sgd / rmsprop / adagrad / adam / adamax from optax 0.2.6 with
coupled weight decay (``add_decayed_weights`` before the update, as
``torch.optim.*(weight_decay=...)`` does). ``torch.optim`` differs in places
that change early updates: optax's rmsprop puts eps INSIDE the square root
(``rsqrt(nu + eps)``), its adagrad starts the accumulator at 0.1 with eps
inside the root. So the update rules are written here to optax's formulas:

- rmsprop: nu = (1-d) g^2 + d nu;          u = g * rsqrt(nu + eps)
- adagrad: s = g^2 + s (s0 = 0.1);         u = g * where(s > 0, rsqrt(s + eps), 0)
- adam:    m, v EMAs, bias-corrected;      u = m_hat / (sqrt(v_hat) + eps)
- adamax:  m EMA, v = max(|g| + eps, b2 v); u = m_hat / v
- sgd:     u = g
and then ``p <- p - lr * u``. A parameter without a gradient counts as a
zero gradient, as every leaf of a JAX gradient tree exists."""

from __future__ import annotations

import torch

HYPER = {
    "sgd": {},
    "rmsprop": dict(decay=0.99, eps=1e-8),
    "adagrad": dict(initial=0.1, eps=1e-10),
    "adam": dict(b1=0.9, b2=0.999, eps=1e-8),
    "adamax": dict(b1=0.9, b2=0.999, eps=1e-8),
}


class OptaxOptimizer(torch.optim.Optimizer):
    def __init__(self, params, name: str, lr: float, weight_decay: float = 0.0):
        if name not in HYPER:
            raise ValueError(f"unknown optimizer {name!r}")
        self.name = name
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      **HYPER[name]))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, wd = group["lr"], group["weight_decay"]
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if wd:
                    g = g + wd * p
                p.add_(-lr * self._direction(self.state[p], group, g))

    def _direction(self, st, group, g):
        name = self.name
        if name == "sgd":
            return g
        if name == "rmsprop":
            d = group["decay"]
            nu = st.get("nu", torch.zeros_like(g))
            nu = (1 - d) * (g ** 2) + d * nu
            st["nu"] = nu
            return torch.rsqrt(nu + group["eps"]) * g
        if name == "adagrad":
            s = st.get("sum_of_squares",
                       torch.full_like(g, group["initial"]))
            s = g ** 2 + s
            st["sum_of_squares"] = s
            inv = torch.where(s > 0, torch.rsqrt(s + group["eps"]),
                              torch.zeros_like(s))
            return inv * g
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        count = st.get("count", 0) + 1
        st["count"] = count
        mu = st.get("mu", torch.zeros_like(g))
        mu = (1 - b1) * g + b1 * mu
        st["mu"] = mu
        c1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
        mu_hat = mu / c1.to(mu.dtype).item()
        if name == "adam":
            nu = st.get("nu", torch.zeros_like(g))
            nu = (1 - b2) * (g ** 2) + b2 * nu
            st["nu"] = nu
            c2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count
            nu_hat = nu / c2.to(nu.dtype).item()
            return mu_hat / (torch.sqrt(nu_hat) + eps)
        nu = st.get("nu", torch.zeros_like(g))
        nu = torch.maximum(g.abs() + eps, b2 * nu)
        st["nu"] = nu
        return mu_hat / nu


def get_optimizer(name: str, params, lr: float, weight_decay: float = 0.0
                  ) -> OptaxOptimizer:
    return OptaxOptimizer(params, name, lr, weight_decay)
