"""FFJORD/RNODE-style regularisers as ODE state augmentation (port of
`graphax/functions/regularizers.py`, the twin of
`src/regularized_ODE_function.py`).

The solver state becomes ``(x, *reg_states)``: each reg state ``[N]``
integrates a per-node rate alongside the diffusion, and the training loss
adds ``sum of coeff * mean(reg_state(T))`` (`src/graph_datasets/
run_GNN.py:81-88`). graphax nests the reg states in a tuple, ``(x,
(r_1, ...))``; it ravels to the same vector as the port's flat tuple.

Rates (per node):

- kinetic_energy:      ``1/2 mean_d(f^2)``
- jacobian_norm2:      the exact divergence by D basis-vector vjps
  (graphax's and the reference's `divergence_bf`), or a Hutchinson
  estimator
- directional_penalty: ``1/2 mean_d((J^T f)^2)``, the vjp ``f^T J``
- total_deriv:         ``1/2 mean_d((f^T J + df/dt)^2)``

The vjps are ``torch.autograd.grad`` of the RHS inside the RHS, with
``create_graph`` wherever gradients are being recorded (the loss is then
differentiated through them: a second derivative through the hand-written
kernels, whose backwards are themselves differentiable,
`graphax_torch.kernels.spmm._SpMM`, `graphax_torch.kernels.windowed_spmm.
_WinMatmul`). ``df/dt`` is a double vjp: the vjp with respect to t of a
cotangent ``u`` is linear in ``u``, and its gradient with respect to ``u``
is the jvp along ``dt = 1``; the RHS is evaluated once for both. An
autonomous RHS gives 0, as graphax's ``jax.jvp``.

``J^T f`` is taken once per evaluation where both directional_penalty and
total_deriv need it (graphax takes it twice; the values are the same)."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

REGULARIZER_NAMES = ("kinetic_energy", "jacobian_norm2", "total_deriv",
                     "directional_penalty")


def _vjp(dx, x, v, create_graph: bool):
    (g,) = torch.autograd.grad(dx, x, v, create_graph=create_graph,
                               retain_graph=True)
    return g


def _exact_divergence(dx, x, create_graph: bool = False):
    """``sum_i [v_i^T J]_i`` per node with ``v_i`` the i-th basis vector at
    every node: D vjps of ``dx = f(x)`` (`divergence_bf`,
    `src/regularized_ODE_function.py:72-81`)."""
    div = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        basis = torch.zeros_like(x)
        basis[..., i] = 1.0
        div = div + _vjp(dx, x, basis, create_graph)[..., i]
    return div


def _hutchinson_divergence(dx, x, *, generator: Optional[torch.Generator] =
                          None, eps: Optional[torch.Tensor] = None,
                          samples: int = 1, create_graph: bool = False):
    """``E[eps^T J eps]`` over Rademacher ``eps`` (``samples`` of them from
    ``generator``, or the ``[samples, *x.shape]`` signs ``eps`` given): the
    estimator for feature widths where D vjps cost too much. graphax's
    training never reaches it (``exact_divergence=True``)."""
    if eps is None:
        if generator is None:
            raise ValueError("hutchinson_divergence: pass a generator or eps")
        bits = torch.randint(0, 2, (samples,) + tuple(x.shape),
                             generator=generator, device=generator.device)
        eps = (2 * bits - 1).to(x.dtype).to(x.device)
    est = [torch.sum(_vjp(dx, x, e, create_graph) * e, dim=-1) for e in eps]
    return torch.stack(est).mean(0)


def _time_derivative(dx, t, create_graph: bool):
    """``df/dt`` by a double vjp; zeros where f does not read t."""
    if not (torch.is_tensor(t) and t.requires_grad):
        return torch.zeros_like(dx)
    u = torch.zeros_like(dx, requires_grad=True)
    (s,) = torch.autograd.grad(dx, t, u, create_graph=True,
                               retain_graph=True, allow_unused=True)
    if s is None or not s.requires_grad:
        return torch.zeros_like(dx)
    (d,) = torch.autograd.grad(s, u, torch.ones_like(s),
                               create_graph=create_graph, retain_graph=True,
                               allow_unused=True)
    return torch.zeros_like(dx) if d is None else d


def make_regularized_rhs(base_rhs: Callable, reg_names: Sequence[str],
                         exact_divergence: bool = True,
                         generator: Optional[torch.Generator] = None
                         ) -> Callable:
    """Wrap ``base_rhs(t, x) -> dx`` into an RHS on ``(x, *reg_states)``
    returning ``(dx, *rates)``, one rate per name in ``reg_names``.
    ``exact_divergence=False`` takes jacobian_norm2 by Hutchinson's
    estimator with signs from ``generator``."""
    reg_names = tuple(reg_names)
    for name in reg_names:
        if name not in REGULARIZER_NAMES:
            raise ValueError(f"unknown regularizer {name!r}")
    needs_vjp = any(n != "kinetic_energy" for n in reg_names)
    needs_t = "total_deriv" in reg_names

    def aug_rhs(t, state):
        x = state[0]
        if not needs_vjp:
            dx = base_rhs(t, x)
            return (dx, *[0.5 * torch.mean(dx * dx, dim=-1)
                          for _ in reg_names])
        # gradients being recorded: the rates are differentiated again
        create = torch.is_grad_enabled()
        with torch.enable_grad():
            # the vjp is with respect to the RHS's argument alone, as
            # graphax's: a fresh node, so that no other path from the same
            # tensor (a pin taken from x(0)) joins it
            x = x.view_as(x) if x.requires_grad \
                else x.detach().requires_grad_(True)
            if needs_t:
                t = torch.as_tensor(t, dtype=torch.float32).detach() \
                    .requires_grad_(True)
            dx = base_rhs(t, x)
            jtf = None
            rates = []
            for name in reg_names:
                if name == "kinetic_energy":
                    rates.append(0.5 * torch.mean(dx * dx, dim=-1))
                elif name == "jacobian_norm2":
                    if exact_divergence:
                        rates.append(_exact_divergence(dx, x, create))
                    else:
                        rates.append(_hutchinson_divergence(
                            dx, x, generator=generator,
                            create_graph=create))
                else:
                    if jtf is None:
                        jtf = _vjp(dx, x, dx, create)
                    if name == "directional_penalty":
                        rates.append(0.5 * torch.mean(jtf * jtf, dim=-1))
                    else:
                        total = jtf + _time_derivative(dx, t, create)
                        rates.append(0.5 * torch.mean(total * total,
                                                      dim=-1))
        if not create:
            return (dx.detach(), *[r.detach() for r in rates])
        return (dx, *rates)

    return aug_rhs


def init_reg_states(num_nodes: int, reg_names: Sequence[str],
                    dtype=torch.float32, device=None) -> tuple:
    """Zero initial accumulators, one ``[N]`` per name
    (`src/block_constant.py:29-31`)."""
    return tuple(torch.zeros((num_nodes,), dtype=dtype, device=device)
                 for _ in reg_names)


def regularization_loss(reg_states, coeffs: Sequence[float]):
    """``sum of coeff * mean(state)`` (`src/graph_datasets/run_GNN.py:
    81-88`)."""
    total = 0.0
    for state, coeff in zip(reg_states, coeffs):
        total = total + coeff * torch.mean(state)
    return total
