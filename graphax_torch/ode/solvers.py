"""ODE integrators: fixed-grid RK, adaptive RK with torchdiffeq's step-size
controller, and the continuous adjoint.

Port of `graphax/ode/solvers.py`. The adaptive loop is a plain Python loop;
gradients flow through the accepted RK stages by autograd (the step-size
controller runs detached, as graphax stop_gradients it), or through
:func:`odeint_adjoint`, whose backward integrates ``(y, a_y, a_p)`` and takes
the vector-Jacobian products from ``torch.autograd.grad``.

Numerics follow graphax:

- the state may be a tensor or a tuple of tensors; it is carried in the
  promoted dtype of its leaves (graphax ravels the pytree into one vector)
  and each leaf is cast back to its own dtype where the RHS sees it;
- stage combinations, error estimates, time and step size never drop below
  f32 (a bf16 state does not quantise the grid);
- the controller scalars are f32 values computed on the host, so the
  accept/reject sequence, NFE and step counts match graphax's;
- the ``max_nfe`` budget halts stepping and reports ``success=False``;
- an :class:`Observer` sees every accepted step (`graphax/ode/solvers.py:
  48`): after each step of the fixed grid, and in the adaptive loop at t0
  and after every accepted step; ``max_steps`` caps the adaptive loop's
  attempts (the early-stop evaluation's ``max_test_steps``);
- ``norm_fn`` replaces the RMS error norm of the adaptive controller (it
  takes the state's leaves raveled into one vector, as graphax's);
- explicit and implicit Adams (graphax's `_odeint_adams`) run AB4, or an
  AB4 predictor and one AM4 corrector (PECE), on the fixed grid, after
  three classic-RK4 steps that fill the derivative history (kept in f32)
  and reuse each step's first derivative as the RK4's first stage."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from graphax_torch.ode.tableaus import TABLEAUS, stacked

FIXED_STEP_METHODS = ("euler", "midpoint", "rk4", "rk4_classic")
ADAMS_METHODS = ("explicit_adams", "implicit_adams")
ADAPTIVE_METHODS = ("dopri5", "adaptive_heun", "bosh3")

SAFETY, IFACTOR, DFACTOR = 0.9, 10.0, 0.2
F32 = torch.float32


class Observer(NamedTuple):
    """Per-accepted-step observation hook: ``update(carry, t, y) -> carry``
    with ``t`` an f32 scalar tensor and ``y`` the state in its own
    structure and dtypes (graphax's `Observer`)."""

    init: Any
    update: Callable[[Any, torch.Tensor, Any], Any]


@dataclasses.dataclass
class AdjointRecord:
    """Filled by the adjoint's backward: the NFE of the backward solve (the
    reference's `bm` meter) and whether it reached t0 within ``max_nfe``
    (graphax reports neither: a budget its backward exhausts goes
    unseen)."""

    nfe: int = 0
    success: bool = True


@dataclasses.dataclass
class ODEResult:
    y: Any               # final state, same structure as y0
    nfe: int             # RHS evaluations
    steps: int           # accepted steps
    success: bool        # False iff the max_nfe or max_steps budget ran out
    adjoint: Optional[AdjointRecord] = None
    observer: Any = None  # the observer's final carry (None without one)


def _scalar(v) -> torch.Tensor:
    """An f32 host scalar (the controller's arithmetic type)."""
    return torch.tensor(v, dtype=F32)


class _State:
    """Flatten/unflatten a tensor or tuple-of-tensors state."""

    def __init__(self, y0):
        self.single = torch.is_tensor(y0)
        leaves = (y0,) if self.single else tuple(y0)
        self.dtypes = tuple(t.dtype for t in leaves)
        flat = leaves[0].dtype
        for t in leaves[1:]:
            flat = torch.promote_types(flat, t.dtype)
        self.flat = flat
        self.acc = torch.promote_types(flat, F32)

    def leaves(self, y):
        return (y,) if torch.is_tensor(y) else tuple(y)

    def carry(self, y):
        return tuple(t.to(self.flat) for t in self.leaves(y))

    def unravel(self, carry):
        out = tuple(t.to(dt) for t, dt in zip(carry, self.dtypes))
        return out[0] if self.single else out


def _rms(leaves, pad: int = 0) -> torch.Tensor:
    """RMS over all leaves jointly and ``pad`` further zeros (leaves of the
    reference's state that are identically zero), as an f32 host scalar."""
    tot = sum(torch.sum(torch.square(t)) for t in leaves)
    cnt = sum(t.numel() for t in leaves) + pad
    return _scalar(float(torch.sqrt(tot / cnt)))


def _norm(leaves, pad: int, norm_fn) -> torch.Tensor:
    """The controller's norm of ``leaves``: the RMS over them and ``pad``
    zeros, or ``norm_fn`` of them raveled into one vector (the zeros
    appended), as an f32 host scalar."""
    if norm_fn is None:
        return _rms(leaves, pad)
    flat = [t.reshape(-1) for t in leaves]
    if pad:
        flat.append(torch.zeros(pad, dtype=flat[0].dtype,
                                device=flat[0].device))
    return _scalar(float(norm_fn(torch.cat(flat))))


def _rk_step(call, st: _State, tab_name: str, t, y, h, f0=None):
    """One explicit RK step on the carried state. Returns (y1, f1 or None,
    err or None, nfe)."""
    tab = TABLEAUS[tab_name]
    a, b, c, e = stacked(tab)
    acc = st.acc
    s = len(c)
    ks = []
    nfe = 0
    for i in range(s):
        if i == 0 and f0 is not None:
            ki = f0
        else:
            yi = [t_.to(acc) for t_ in y]
            for j in range(i):
                if a[i, j] != 0.0:
                    coef = float(h * float(a[i, j]))
                    yi = [u + coef * k.to(acc) for u, k in zip(yi, ks[j])]
            ki = call(t + float(c[i]) * h, tuple(u.to(st.flat) for u in yi))
            nfe += 1
        ks.append(ki)
    y1 = [t_.to(acc) for t_ in y]
    for i in range(s):
        if b[i] != 0.0:
            coef = float(h * float(b[i]))
            y1 = [u + coef * k.to(acc) for u, k in zip(y1, ks[i])]
    y1 = tuple(u.to(st.flat) for u in y1)
    err = None
    if e is not None:
        with torch.no_grad():
            err = [torch.zeros(t_.shape, dtype=acc, device=t_.device) for t_ in y]
            for i in range(s):
                if e[i] != 0.0:
                    coef = float(h * float(e[i]))
                    err = [u + coef * k.detach().to(acc)
                           for u, k in zip(err, ks[i])]
    f1 = ks[-1] if tab.fsal else None
    return y1, f1, err, nfe


def _error_ratio(st: _State, err, y0, y1, rtol, atol, pad,
                 norm_fn=None) -> torch.Tensor:
    with torch.no_grad():
        scaled = []
        for e_, a_, b_ in zip(err, y0, y1):
            scale = atol + rtol * torch.maximum(a_.detach().to(st.acc).abs(),
                                                b_.detach().to(st.acc).abs())
            scaled.append(e_.to(st.acc) / scale)
        return _norm(scaled, pad, norm_fn)


def _optimal_step(h, ratio, order):
    """torchdiffeq `_optimal_step_size`: grow by <= IFACTOR, shrink by >=
    DFACTOR."""
    ratio = torch.maximum(ratio, _scalar(1e-10))
    factor = torch.clamp(SAFETY * ratio ** (-1.0 / order), DFACTOR, IFACTOR)
    return h * factor


def _initial_step(call, st: _State, t0, y0, f0, order, rtol, atol, pad,
                  norm_fn=None):
    """Hairer/Wanner initial step (torchdiffeq `_select_initial_step`).
    Costs one RHS evaluation."""
    with torch.no_grad():
        acc = st.acc
        y0a = [t_.detach().to(acc) for t_ in y0]
        f0a = [t_.detach().to(acc) for t_ in f0]
        scale = [atol + t_.abs() * rtol for t_ in y0a]
        d0 = _norm([u / s_ for u, s_ in zip(y0a, scale)], pad, norm_fn)
        d1 = _norm([u / s_ for u, s_ in zip(f0a, scale)], pad, norm_fn)
        if bool((d0 < 1e-5) | (d1 < 1e-5)):
            h0 = _scalar(1e-6)
        else:
            h0 = 0.01 * d0 / d1
        y1 = tuple((u + float(h0) * f).to(st.flat) for u, f in zip(y0a, f0a))
        f1 = call(t0 + h0, y1)
        d2 = _norm([(f.to(acc) - u) / s_
                    for f, u, s_ in zip(f1, f0a, scale)], pad, norm_fn) / h0
        dmax = torch.maximum(d1, d2)
        if bool(dmax <= 1e-15):
            h1 = torch.maximum(_scalar(1e-6), h0 * 1e-3)
        else:
            h1 = (0.01 / dmax) ** (1.0 / (order + 1))
        return torch.minimum(100.0 * h0, h1)


def _fixed_grid(t0: float, t1: float, step_size: float) -> np.ndarray:
    """Uniform steps of ``step_size`` from t0 with a final clamp onto t1
    (torchdiffeq's grid constructor)."""
    t0, t1, dt = float(t0), float(t1), float(step_size)
    n_full = max(int(np.floor((t1 - t0) / dt + 1e-9)), 0)
    ts = [t0 + i * dt for i in range(n_full + 1)]
    if ts[-1] < t1 - 1e-9 * max(1.0, abs(t1)):
        ts.append(t1)
    else:
        ts[-1] = t1
    return np.asarray(ts, dtype=np.float64)


_AB4 = (55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0)  # f_n..f_{n-3}
_AM4 = (9.0 / 24.0, 19.0 / 24.0, -5.0 / 24.0, 1.0 / 24.0)     # f_{n+1}..f_{n-2}


def _adams_update(st: _State, y, h, terms):
    """``y + h * sum(c * f)`` per leaf: the sum in f32 in the order graphax
    adds it, rounded to the state dtype, the update in f32 at least and
    rounded to the state dtype."""
    terms = list(terms)
    out = []
    for j, yj in enumerate(y):
        incr = 0
        for c, f in terms:
            incr = incr + c * f[j]
        out.append((yj.to(st.acc) + h * incr.to(yj.dtype).to(st.acc))
                   .to(st.flat))
    return tuple(out)


def _odeint_adams(call, st: _State, y, t0, t1, method, step_size, observer,
                  obs, corrector_iters: int = 1):
    """graphax's `_odeint_adams`: the first min(3, n) steps of the fixed
    grid by classic RK4 (each step's f_i is the RK4's first stage and joins
    the history), then AB4, or for ``implicit_adams`` an AB4 predictor and
    ``corrector_iters`` AM4 corrections. NFE: 4 per prologue step, 1 (+
    the corrections) per multistep step."""
    ts = _fixed_grid(t0, t1, step_size)
    starts = torch.tensor(ts[:-1], dtype=F32)
    hs = torch.tensor(np.diff(ts), dtype=F32)
    n_steps = len(ts) - 1
    implicit = method == "implicit_adams"
    fdt = st.acc

    def deriv(t, y):
        return [f.to(fdt) for f in call(t, y)]

    hist = []                                   # f_{n-1}, f_{n-2}, f_{n-3}
    n_boot = min(3, n_steps)
    nfe = 0
    for i in range(n_boot):
        f_i = deriv(starts[i], y)
        hist = [f_i] + hist[:2]
        y, _, _, n_extra = _rk_step(call, st, "rk4_classic", starts[i], y,
                                    hs[i], f0=tuple(f.to(st.flat)
                                                    for f in f_i))
        nfe += 1 + n_extra
        if observer is not None:
            obs = observer.update(obs, starts[i] + hs[i], st.unravel(y))
    for i in range(n_boot, n_steps):
        t, h = starts[i], hs[i]
        hist4 = [deriv(t, y)] + hist            # f_n..f_{n-3}
        y_next = _adams_update(st, y, h, zip(_AB4, hist4))
        nfe += 1
        if implicit:
            for _ in range(corrector_iters):    # PECE, fixed iterations
                f_pred = deriv(t + h, y_next)
                y_next = _adams_update(
                    st, y, h, zip(_AM4, [f_pred] + hist4[:3]))
                nfe += 1
        y, hist = y_next, hist4[:3]
        if observer is not None:
            obs = observer.update(obs, t + h, st.unravel(y))
    return ODEResult(y=st.unravel(y), nfe=nfe, steps=n_steps, success=True,
                     observer=obs)


def odeint(func: Callable, y0, t0: float, t1: float, *,
           method: str = "dopri5", rtol: float = 1e-9, atol: float = 1e-7,
           step_size: float = 1.0, max_nfe: int = 1000,
           max_steps: Optional[int] = None,
           observer: Optional[Observer] = None,
           norm_pad: int = 0, norm_fn: Optional[Callable] = None
           ) -> ODEResult:
    """Integrate ``dy/dt = func(t, y)`` from t0 to t1 (t1 > t0). ``y0`` is a
    tensor or a tuple of tensors; ``func`` returns the same structure.
    ``max_steps`` caps the adaptive loop's attempts (accepted and rejected;
    default from ``max_nfe``, as graphax's). ``observer`` sees every
    accepted step; its final carry is ``result.observer``. ``norm_pad``
    zeros join every error norm of the adaptive controller (the adjoint's
    count of the reference's identically-zero leaves). ``norm_fn(vector)
    -> scalar`` overrides the controller's RMS norm, over the state's
    leaves raveled into one vector (graphax's ``norm_fn``). ``method`` may
    also be ``"explicit_adams"`` or ``"implicit_adams"``, on the fixed grid
    of ``step_size``."""
    st = _State(y0)
    obs = observer.init if observer is not None else None

    def call(t, carry):
        out = func(t, st.unravel(carry))
        return st.leaves(out)

    y = st.carry(y0)
    if method in FIXED_STEP_METHODS:
        ts = _fixed_grid(t0, t1, step_size)
        starts = torch.tensor(ts[:-1], dtype=F32)
        hs = torch.tensor(np.diff(ts), dtype=F32)
        for i in range(len(ts) - 1):
            y, _, _, _ = _rk_step(call, st, method, starts[i], y, hs[i])
            if observer is not None:
                obs = observer.update(obs, starts[i] + hs[i], st.unravel(y))
        n = len(ts) - 1
        return ODEResult(y=st.unravel(y), nfe=n * len(TABLEAUS[method].c),
                         steps=n, success=True, observer=obs)
    if method in ADAMS_METHODS:
        return _odeint_adams(call, st, y, t0, t1, method, step_size,
                             observer, obs)
    if method not in ADAPTIVE_METHODS:
        raise ValueError(f"unknown method {method!r}")
    tab = TABLEAUS[method]
    order = tab.order
    nfe_per_step = len(tab.c) - (1 if tab.fsal else 0)
    if max_steps is None:
        max_steps = max(int(max_nfe) // nfe_per_step + 1, 4)
    t = _scalar(t0)
    t1a = _scalar(t1)
    span = t1a - t
    f = call(t, y)
    h = torch.minimum(_initial_step(call, st, t, y, f, order, rtol, atol,
                                    norm_pad, norm_fn), span)
    nfe = 2
    if observer is not None:
        obs = observer.update(obs, t, st.unravel(y))
    steps = attempts = 0
    done = bool(span <= 0)
    end = t1a - 1e-12 * torch.maximum(_scalar(1.0), t1a.abs())
    while (not done) and nfe + nfe_per_step <= max_nfe \
            and attempts < max_steps:
        h = torch.minimum(h, t1a - t)
        y_prop, f_prop, err, _ = _rk_step(call, st, method, t, y, h,
                                          f if tab.fsal else None)
        ratio = _error_ratio(st, err, y, y_prop, rtol, atol, norm_pad,
                             norm_fn)
        accept = bool(ratio <= 1.0)
        h_next = _optimal_step(h, ratio, order)
        if accept:
            t = t + h
            y = y_prop
            if tab.fsal:
                f = f_prop
            if observer is not None:
                obs = observer.update(obs, t, st.unravel(y))
        done = bool(t >= end)
        nfe += nfe_per_step
        steps += int(accept)
        attempts += 1
        h = h_next
    return ODEResult(y=st.unravel(y), nfe=nfe, steps=steps, success=done,
                     observer=obs)


# ----------------------------------------------------------------------
# Continuous adjoint
# ----------------------------------------------------------------------

@dataclasses.dataclass
class _AdjointSpec:
    func: Callable
    single: bool
    t0: float
    t1: float
    solve_kwargs: dict
    adj_kwargs: dict
    track: tuple
    zero_leaves: int
    result: Optional[ODEResult] = None
    record: AdjointRecord = dataclasses.field(default_factory=AdjointRecord)


class _Adjoint(torch.autograd.Function):

    @staticmethod
    def forward(ctx, spec: _AdjointSpec, n_y: int, *args):
        y0, params = args[:n_y], args[n_y:]
        # detached: an RHS that differentiates itself (a regulariser's
        # vjp) takes no derivative with respect to them in this solve
        fixed = tuple(p.detach() for p in params)
        res = odeint(lambda t, y: spec.func(fixed, t, y),
                     y0[0] if spec.single else y0, spec.t0, spec.t1,
                     **spec.solve_kwargs)
        spec.result = res
        ctx.spec = spec
        y1 = (res.y,) if spec.single else tuple(res.y)
        ctx.n_y = len(y1)
        ctx.save_for_backward(*y1, *params)
        return y1

    @staticmethod
    def backward(ctx, *g_y1):
        saved = ctx.saved_tensors
        n = ctx.n_y
        y1, params = saved[:n], saved[n:]
        spec = ctx.spec
        needs = [bool(ctx.needs_input_grad[2 + n + i])
                 for i in range(len(params))]
        # The a_p leaves never feed back into y or a_y, so a fixed grid
        # carries only those with a gradient. An adaptive method's error
        # norm reads the whole state: there the tracked leaves (those the
        # reference integrates although their gradient is discarded) are
        # integrated too, and its zero leaves are counted.
        adaptive = spec.adj_kwargs["method"] in ADAPTIVE_METHODS
        carried = [nd or (adaptive and tr)
                   for nd, tr in zip(needs, spec.track)]
        p_in = [p.detach().requires_grad_(c) for p, c in zip(params, carried)]
        wanted = [p for p, c in zip(p_in, carried) if c]
        t1 = _scalar(spec.t1)

        # augmented state z(s) = (y(t), a_y(t), a_p(t)) with s = t1 - t:
        # dy/ds = -f, da_y/ds = a^T df/dy, da_p/ds = a^T df/dp
        def aug(s, z):
            y, a = z[:n], z[n:2 * n]
            with torch.enable_grad():
                y_ = [t.detach().requires_grad_(True) for t in y]
                f = spec.func(p_in, t1 - s, y_[0] if spec.single
                              else tuple(y_))
                f = (f,) if torch.is_tensor(f) else tuple(f)
                live = [i for i, fi in enumerate(f) if fi.requires_grad]
                grads = torch.autograd.grad(
                    [f[i] for i in live], y_ + wanted, [a[i] for i in live],
                    allow_unused=True) if live else (None,) * (n + len(wanted))
            vy = [torch.zeros_like(t) if v is None else v
                  for v, t in zip(grads[:n], y)]
            vp = [torch.zeros_like(p) if v is None else v
                  for v, p in zip(grads[n:], wanted)]
            return (*[-fi.detach() for fi in f], *vy, *vp)

        # a_p in f32 at least, as the reference's raveled parameter vector
        z0 = (*y1, *[torch.zeros_like(y) if g is None else g.to(y.dtype)
                     for g, y in zip(g_y1, y1)],
              *[torch.zeros(p.shape, dtype=torch.promote_types(p.dtype, F32),
                            device=p.device) for p in wanted])
        with record_function("graphax_torch.adjoint"):
            res = odeint(aug, z0, 0.0, float(spec.t1 - spec.t0),
                         norm_pad=spec.zero_leaves if adaptive else 0,
                         **spec.adj_kwargs)
        spec.record.nfe = res.nfe
        spec.record.success = res.success
        a0, ap = res.y[n:2 * n], res.y[2 * n:]
        it = iter(ap)
        grads = [next(it) if c else None for c in carried]
        return (None, None, *a0, *[v.to(p.dtype) if nd else None
                                   for v, p, nd in zip(grads, params, needs)])


def odeint_adjoint(func: Callable, params, y0, t0: float,
                   t1: float, *, method: str = "dopri5", rtol: float = 1e-9,
                   atol: float = 1e-7, step_size: float = 1.0,
                   max_nfe: int = 1000, max_steps: Optional[int] = None,
                   adjoint_method: str = "adaptive_heun",
                   adjoint_rtol: float = 1e-9, adjoint_atol: float = 1e-7,
                   adjoint_step_size: float = 1.0, track=None,
                   zero_leaves: int = 0, norm_fn: Optional[Callable] = None,
                   adjoint_norm_fn: Optional[Callable] = None) -> ODEResult:
    """O(1)-memory gradients through the solve by the continuous adjoint,
    with its own method and tolerances. ``func(params, t, y) -> dy`` where
    ``params`` is a sequence of tensors and ``y`` a tensor or a tuple of
    tensors (the structure of ``y0``); gradients flow to the params that
    require grad and to ``y0``. ``norm_fn`` and ``adjoint_norm_fn``
    override the error norms of the forward and the backward controllers
    (:func:`odeint`'s ``norm_fn``).

    The adjoint state holds ``y``, ``a_y`` and the ``a_p`` of every param
    that requires grad. Under an adaptive ``adjoint_method`` it also holds
    the ``a_p`` of the params flagged in ``track`` (one bool each), and its
    error norm counts ``zero_leaves`` further zeros: that is how a caller
    makes the norm run over the same leaves as the reference's adjoint
    state (graphax ravels every parameter and per-forward tensor into it,
    `graphax/ode/solvers.py:566-607`) without materialising zero leaves.

    ``result.adjoint.nfe`` holds the backward solve's NFE once backward has
    run."""
    params = tuple(params)
    single = torch.is_tensor(y0)
    y0 = (y0,) if single else tuple(y0)
    spec = _AdjointSpec(
        func=func, single=single, t0=float(t0), t1=float(t1),
        solve_kwargs=dict(method=method, rtol=rtol, atol=atol,
                          step_size=step_size, max_nfe=max_nfe,
                          max_steps=max_steps, norm_fn=norm_fn),
        adj_kwargs=dict(method=adjoint_method, rtol=adjoint_rtol,
                        atol=adjoint_atol, step_size=adjoint_step_size,
                        max_nfe=max_nfe, norm_fn=adjoint_norm_fn),
        track=tuple(track) if track is not None else (False,) * len(params),
        zero_leaves=int(zero_leaves))
    y1 = _Adjoint.apply(spec, len(y0), *y0, *params)
    res = spec.result
    return ODEResult(y=y1[0] if single else tuple(y1), nfe=res.nfe, steps=res.steps, success=res.success,
                     adjoint=spec.record)
