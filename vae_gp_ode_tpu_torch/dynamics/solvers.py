"""Numerical ODE solvers (port of `vae_gp_ode_tpu/dynamics/solvers.py`).

The same methods, step rules and fn-eval counts as the JAX package:

  * fixed-step euler, midpoint and rk4 with `dense` substeps per output
    interval, 4-step explicit/fixed (PECE) Adams with an RK4 bootstrap,
    and BDF2 with a fixed-iteration damped Newton whose per-row (D, D)
    Jacobians come from the right-hand side's `jacobian` (the flows': one
    VJP kernel launch each) or else from D vector-Jacobian products;
  * adaptive dopri5 (Hairer initial step, Lund-stabilised PI controller,
    Shampine's dense output at the requested times) and `adams` (VCABM,
    variable step and order), each a bounded loop of `max_steps`
    candidate steps with masked accept/reject, as the JAX package's scan.

Batched problems: with `batched=True` the leading dim of z0 indexes
independent problems (the L Monte-Carlo draws of a flow, as the JAX
package's vmap over draws): each has its own adaptive controller (time,
step size, error norm over its own state, accept, order, done). Once
every problem is done the remaining candidate steps would change no value
and no gradient, so the loop stops early; it reads `done` on the host
once every `DONE_CHECK_EVERY` candidate steps (one sync each). The
fixed-step solvers never read a device value on the host.

`remat` wraps each output interval (fixed-step) or candidate step
(adaptive) in `torch.utils.checkpoint`, as the JAX package's
`jax.checkpoint`: reverse mode then recomputes those steps' RHS
evaluations instead of storing their intermediates. Values do not depend
on it.

All solvers take `f(t, z) -> dz` (t a 0-d tensor for the fixed-step
methods, a (B,) tensor of per-problem times for the adaptive ones) and
integrate from ts[0] through ts[-1], returning the states at each
requested time (the first row is z0).
"""

import contextlib
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
from torch.utils.checkpoint import checkpoint

from vae_gp_ode_tpu_torch.core import linalg

FIXED_STEP_SOLVERS = (
    'euler', 'midpoint', 'rk4', 'explicit_adams', 'fixed_adams', 'bdf',
)
ADAPTIVE_SOLVERS = ('dopri5', 'adams')
SOLVERS = FIXED_STEP_SOLVERS + ADAPTIVE_SOLVERS

#: candidate steps between the adaptive loops' host checks that every
#: problem is done
DONE_CHECK_EVERY = 16


class ODESolution(NamedTuple):
    zs: torch.Tensor     # (T, *z0.shape) states at the requested times
    nfe: object          # RHS evaluations, summed over the batch of problems


def _f32(x):
    """A constant as the f32 value JAX's f32 arrays hold."""
    return float(np.float32(x))


def _no_grad():
    """`torch.no_grad()`, or no context where grad mode is off already: a
    program traced under no_grad (`torch.export`, the serving artifact)
    then holds no grad-mode switches, each of which the export splits its
    graph at."""
    if torch.is_grad_enabled():
        return torch.no_grad()
    return contextlib.nullcontext()


def _remat(fn, remat):
    """fn under torch.utils.checkpoint when `remat` and grad mode are on."""
    if not remat:
        return fn

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return wrapped


def _bc(v, like):
    """A per-problem (B,) or (T, B) tensor shaped to broadcast against the
    state `like` (B, ...) or (T, B, ...)."""
    return v.reshape(tuple(v.shape) + (1,) * (like.dim() - v.dim()))


def _rms(x, scale):
    """Per-problem root mean square of x / scale over all but the leading
    dim (the JAX package's mean over one problem's state)."""
    r = (x / scale) ** 2
    return torch.sqrt(r.reshape(r.shape[0], -1).mean(dim=1) + 1e-30)


# ---------------------------------------------------------------------------
# single-step integrators (t, z, dt) -> z_next and their evals per step
# ---------------------------------------------------------------------------

def _euler_step(f, t, z, dt):
    return z + dt * f(t, z)


def _midpoint_step(f, t, z, dt):
    k1 = f(t, z)
    k2 = f(t + 0.5 * dt, z + 0.5 * dt * k1)
    return z + dt * k2


def _rk4_step(f, t, z, dt):
    k1 = f(t, z)
    k2 = f(t + 0.5 * dt, z + 0.5 * dt * k1)
    k3 = f(t + 0.5 * dt, z + 0.5 * dt * k2)
    k4 = f(t + dt, z + dt * k3)
    return z + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


_ONESTEP = {'euler': (_euler_step, 1), 'midpoint': (_midpoint_step, 2),
            'rk4': (_rk4_step, 4)}


def row_jacobian(g, z):
    """Per-row Jacobians (..., D, D) of a function g that maps each row of
    z (..., D) on its own: D vector-Jacobian products, the j-th with a
    one-hot cotangent on every row at once, give row j of every row's
    Jacobian. Not differentiated further (the result is detached). bdf
    takes it for a right-hand side without its own `jacobian` (the flows'
    have one, `dynamics.flow.make_ode_rhs`), and the bdf adjoint for its
    linear step.

    While `torch.export` traces it, D forward-mode products give the
    columns instead (the same matrix): a traced reverse pass loses the
    outputs that exp and tanh save. No operator of `ops.library` takes a
    tangent, so the trace differentiates the per-step evals' plain
    versions, and only a trace on the CPU can: on the card it raises."""
    D = z.shape[-1]
    eye = torch.eye(D, dtype=z.dtype, device=z.device)
    if torch.compiler.is_exporting():
        if z.device.type != 'cpu':
            raise RuntimeError(
                'a traced per-row Jacobian of a right-hand side without '
                'its own `jacobian` (the Newton iterations of bdf) '
                'differentiates the per-step evals in forward mode, which '
                'the kernels do not take: such a program is traced and '
                'served on the CPU only')
        cols = []
        for j in range(D):
            with fwAD.dual_level():
                r = g(fwAD.make_dual(z.detach(),
                                     eye[j].expand_as(z).contiguous()))
                cols.append(fwAD.unpack_dual(r).tangent)
        return torch.stack(cols, dim=-1)
    # identity saved-tensor hooks: inside a checkpointed step this small
    # graph keeps its own tensors instead of the checkpoint's placeholders
    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
            lambda t: t, lambda t: t):
        zd = z.detach().requires_grad_()
        r = g(zd)
        rows = [torch.autograd.grad(r, zd, eye[j].expand_as(r),
                                    retain_graph=j < D - 1)[0]
                for j in range(D)]
    return torch.stack(rows, dim=-2)


def _newton_solve(g, z, iters=6, jacobian=None):
    """Solve g(z) = 0 for rows z (..., D) with damped per-row Newton: each
    iterate is taken only where it lowers that row's residual norm (step
    fractions 1, 1/2, 1/4, else keep), as the JAX package does. The
    per-row Jacobians of g come from `jacobian(z)` where given, else from
    `row_jacobian`. The Jacobian is a constant of each iteration for
    reverse mode: at convergence the gradient is the implicit-function one
    either way."""
    for _ in range(iters):
        r = g(z)
        J = row_jacobian(g, z) if jacobian is None else jacobian(z)
        dz = linalg.solve(J, r[..., None])[..., 0]
        best_z = z
        best_rn = torch.sum(r * r, dim=-1)
        for alpha in (1.0, 0.5, 0.25):
            z_try = z - alpha * dz
            rt = g(z_try)
            rtn = torch.sum(rt * rt, dim=-1)
            better = rtn < best_rn
            best_z = torch.where(better[..., None], z_try, best_z)
            best_rn = torch.where(better, rtn, best_rn)
        z = best_z
    return z


# ---------------------------------------------------------------------------
# fixed-step integration loops
# ---------------------------------------------------------------------------

def _fixed_singlestep(f, z0, ts, method, dense, remat):
    step_fn, evals_per_step = _ONESTEP[method]

    def interval(z, t0, t1):
        h = (t1 - t0) / dense
        for i in range(dense):
            z = step_fn(f, t0 + i * h, z, h)
        return z

    interval = _remat(interval, remat)
    zs = [z0]
    for i in range(ts.shape[0] - 1):
        zs.append(interval(zs[-1], ts[i], ts[i + 1]))
    nfe = (ts.shape[0] - 1) * dense * evals_per_step
    return torch.stack(zs), nfe


def _fixed_adams_family(f, z0, ts, method, dense, remat):
    """4-step Adams on the dense substep grid: explicit_adams is
    Adams-Bashforth-4, fixed_adams an AB4 predictor with an
    Adams-Moulton-4 corrector (PECE). The first three substeps bootstrap
    with RK4."""
    corrector = method == 'fixed_adams'
    T = ts.shape[0]
    total = (T - 1) * dense
    h_int = (ts[1:] - ts[:-1]) / dense                       # (T-1,)
    t_start = (ts[:-1, None] + h_int[:, None] * torch.arange(
        dense, dtype=ts.dtype, device=ts.device)).reshape(-1)
    hs = h_int[:, None].expand(T - 1, dense).reshape(-1)     # (total,)

    nboot = min(3, total)
    z = z0
    states, fhist = [], []
    for i in range(nboot):
        t0, h = t_start[i], hs[i]
        k1 = f(t0, z)
        k2 = f(t0 + 0.5 * h, z + 0.5 * h * k1)
        k3 = f(t0 + 0.5 * h, z + 0.5 * h * k2)
        k4 = f(t0 + h, z + h * k3)
        fhist.append(k1)
        z = z + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        states.append(z)

    def substep(zt, f1, f2, f3, t0, h):
        fc = f(t0, zt)                 # f_n; f3 = f_{n-1} ... f1 = f_{n-3}
        z_pred = zt + (h / 24.0) * (55.0 * fc - 59.0 * f3
                                    + 37.0 * f2 - 9.0 * f1)
        if not corrector:
            return z_pred, fc
        f_pred = f(t0 + h, z_pred)
        return zt + (h / 24.0) * (9.0 * f_pred + 19.0 * fc
                                  - 5.0 * f3 + f2), fc

    substep = _remat(substep, remat)
    if total > nboot:
        f1, f2, f3 = fhist
        for i in range(nboot, total):
            z, fc = substep(z, f1, f2, f3, t_start[i], hs[i])
            f1, f2, f3 = f2, f3, fc
            states.append(z)
    zs = torch.stack([z0] + states[dense - 1::dense])
    per = 2 if corrector else 1
    nfe = nboot * 4 + max(total - nboot, 0) * per
    return zs, nfe


def _fixed_bdf2(f, z0, ts, dense, remat, newton_iters=6):
    """Fixed-step BDF2 with batched Newton; the first substep is backward
    Euler. Variable-step-ratio coefficients (w = h / h_prev):

        z_{n+1} = ((1+w)^2 z_n - w^2 z_{n-1}) / (1 + 2w)
                  + h (1+w)/(1+2w) f(t_{n+1}, z_{n+1})

    Where f has per-row Jacobians (`f.jacobian(t, z)`, as
    `dynamics.flow.make_ode_rhs` gives them) the Newton iterations take
    I - c_f h J_f (c_f = 1 for backward Euler); otherwise `row_jacobian`
    differentiates g.
    """
    f_jacobian = getattr(f, 'jacobian', None)

    def interval(z, z_prev, h_prev, t0, t1, have_prev):
        h = (t1 - t0) / dense
        zt, zp, hp, hpv = z, z_prev, have_prev, h_prev
        for i in range(dense):
            t1s = t0 + (i + 1) * h
            if hp:
                w = h / hpv
                c_zt = (1.0 + w) ** 2 / (1.0 + 2.0 * w)
                c_zp = w * w / (1.0 + 2.0 * w)
                c_f = (1.0 + w) / (1.0 + 2.0 * w)

                def g(zn, zt=zt, zp=zp, c_zt=c_zt, c_zp=c_zp, c_f=c_f,
                      t1s=t1s):
                    return zn - c_zt * zt + c_zp * zp - c_f * h * f(t1s, zn)
            else:
                c_f = 1.0

                def g(zn, zt=zt, t1s=t1s):
                    return zn - zt - h * f(t1s, zn)
            jacobian = None
            if f_jacobian is not None:
                def jacobian(zn, c=c_f * h, t1s=t1s):
                    J = f_jacobian(t1s, zn)
                    eye = torch.eye(J.shape[-1], dtype=J.dtype,
                                    device=J.device)
                    return eye - c * J
            z_new = _newton_solve(g, zt + h * f(t0 + i * h, zt),
                                  iters=newton_iters, jacobian=jacobian)
            zt, zp, hp, hpv = z_new, zt, True, h
        return zt, zp, hpv

    interval = _remat(interval, remat)
    zs = [z0]
    z, z_prev, h_prev = z0, z0, torch.zeros((), dtype=z0.dtype,
                                            device=z0.device)
    for i in range(ts.shape[0] - 1):
        z, z_prev, h_prev = interval(z, z_prev, h_prev, ts[i], ts[i + 1],
                                     i > 0)
        zs.append(z)
    # per substep: 1 predictor eval + newton_iters * (residual + Jacobian
    # + 3 backtracking residuals); the Jacobian is accounted as 1
    nfe = (ts.shape[0] - 1) * dense * (1 + 5 * newton_iters)
    return torch.stack(zs), nfe


# ---------------------------------------------------------------------------
# adaptive dopri5 (Dormand-Prince RK45), bounded masked stepping
# ---------------------------------------------------------------------------

_DP_C = [_f32(c) for c in (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)]
_DP_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DP_B5 = [_f32(b) for b in (35 / 384, 0.0, 500 / 1113, 125 / 192,
                            -2187 / 6784, 11 / 84, 0.0)]
_DP_B4 = [_f32(b) for b in (5179 / 57600, 0.0, 7571 / 16695, 393 / 640,
                            -92097 / 339200, 187 / 2100, 1 / 40)]
# Shampine's quartic dense-output interpolant (scipy's RK45.P):
#   z(t + theta*dt) = z + dt * sum_i k_i * sum_j P[i,j] theta^{j+1}
_DP_P = np.array([
    [1.0, -8048581381 / 2820520608, 8663915743 / 2820520608,
     -12715105075 / 11282082432],
    [0.0, 0.0, 0.0, 0.0],
    [0.0, 131558114200 / 32700410799, -68118460800 / 10900136933,
     87487479700 / 32700410799],
    [0.0, -1754552775 / 470086768, 14199869525 / 1410260304,
     -10690763975 / 1880347072],
    [0.0, 127303824393 / 49829197408, -318862633887 / 49829197408,
     701980252875 / 199316789632],
    [0.0, -282668133 / 205662961, 2019193451 / 616988883,
     -1453857185 / 822651844],
    [0.0, 40617522 / 29380423, -110615467 / 29380423,
     69997945 / 29380423]], dtype=np.float32)

# Lund-stabilised PI step controller constants (Hairer's dopri5.f)
_PI_SAFE = 0.9
_PI_BETA = 0.04
_PI_EXPO1 = 0.2 - _PI_BETA * 0.75
_PI_FAC_MIN = 0.1
_PI_FAC_MAX = 5.0


def _dp_stages(f, t, z, dt, k1):
    """The 7 DP stages from k1 (FSAL); t, dt per problem (B,)."""
    ks = [k1]
    for i in range(1, 7):
        acc = torch.zeros_like(z)
        for j, a in enumerate(_DP_A[i]):
            acc = acc + a * ks[j]
        ks.append(f(t + _DP_C[i] * dt, z + _bc(dt, z) * acc))
    return ks


def _hairer_initial_step(f, t0, z0, f0, rtol, atol, order=4):
    """Per-problem automatic initial step (Hairer, Norsett & Wanner I,
    sec. II.4; scipy's _select_initial_step). One extra RHS eval; no
    gradient flows through it."""
    with _no_grad():
        scale = atol + torch.abs(z0) * rtol
        d0 = _rms(z0, scale)
        d1 = _rms(f0, scale)
        h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5),
                         torch.full_like(d0, 1e-6), 0.01 * d0 / d1)
        f1 = f(t0 + h0, z0 + _bc(h0, z0) * f0)
        d2 = _rms(f1 - f0, scale) / h0
        dmax = torch.maximum(d1, d2)
        h1 = torch.where(dmax <= 1e-15,
                         torch.clamp(h0 * 1e-3, min=1e-6),
                         (0.01 / dmax) ** (1.0 / (order + 1.0)))
        return torch.minimum(100.0 * h0, h1)


def _bounded_loop(step, carry, done_at, max_steps, remat, early_stop):
    """Run `step` over `carry` for max_steps candidate steps, or until
    every problem is done (checked on the host every DONE_CHECK_EVERY
    steps when `early_stop`). While `torch.export` traces the loop there
    is no value to check: the trace takes all max_steps steps, which give
    the same values, as the JAX package's bounded loop does."""
    step = _remat(step, remat)
    early_stop = early_stop and not torch.compiler.is_exporting()
    for i in range(max_steps):
        if early_stop and i and i % DONE_CHECK_EVERY == 0 and bool(
                carry[done_at].all()):
            break
        carry = step(*carry)
    return carry


def _dopri5(f, z0, ts, rtol, atol, max_steps, remat, early_stop):
    T = ts.shape[0]
    B = z0.shape[0]
    dtype, dev = z0.dtype, z0.device
    t0 = ts[0].expand(B)
    t_end = ts[-1]
    dt_floor = 8.0 * torch.finfo(dtype).eps * torch.clamp(
        torch.max(torch.abs(ts)), min=1.0)
    P = torch.as_tensor(_DP_P, device=dev)

    f0 = f(t0, z0)
    dt0 = torch.minimum(_hairer_initial_step(f, t0, z0, f0, rtol, atol),
                        torch.abs(t_end - ts[0]))
    zs0 = torch.cat([z0[None], torch.zeros((T - 1,) + z0.shape, dtype=dtype,
                                           device=dev)])
    filled0 = (torch.arange(T, device=dev) == 0)[:, None].expand(T, B)

    def step(t, z, k1, dt, facold, zs, filled, nfe, done):
        ks = _dp_stages(f, t, z, dt, k1)
        z5 = z + _bc(dt, z) * sum(b * k for b, k in zip(_DP_B5, ks))
        with _no_grad():
            # step-size control is a discrete decision: no gradient
            z4 = z + _bc(dt, z) * sum(b * k for b, k in zip(_DP_B4, ks))
            scale = atol + rtol * torch.maximum(torch.abs(z), torch.abs(z5))
            err_norm = _rms(z5 - z4, scale)
            accept = err_norm <= 1.0
            t_new = t + dt
            in_window = ((ts[:, None] > t) & (ts[:, None] <= t_new) & ~filled
                         & accept & ~done)                      # (T, B)
            theta = torch.clamp((ts[:, None] - t) / dt, 0.0, 1.0)
            tpow = torch.stack([theta, theta ** 2, theta ** 3, theta ** 4],
                               dim=-1)                          # (T, B, 4)
            w = tpow @ P.T                                      # (T, B, 7)
        kst = torch.stack(ks, dim=1).reshape(B, 7, -1)          # (B, 7, F)
        interp = (z[None] + _bc(dt, z)[None] * torch.bmm(
            w.transpose(0, 1), kst).transpose(0, 1).reshape(zs.shape))
        zs = torch.where(_bc(in_window, zs), interp, zs)
        with _no_grad():
            filled = filled | in_window
            fac11 = (err_norm + 1e-30) ** _PI_EXPO1
            fac_acc = torch.clamp(fac11 / (facold ** _PI_BETA) / _PI_SAFE,
                                  _PI_FAC_MIN, _PI_FAC_MAX)
            fac_rej = torch.clamp(fac11 / _PI_SAFE, max=_PI_FAC_MAX)
            dt_new = torch.where(accept, dt / fac_acc,
                                 dt / torch.clamp(fac_rej, min=1.0))
            facold = torch.where(accept, torch.clamp(err_norm, min=1e-4),
                                 facold)
            active = ~done
            take = accept & active
            t_next = torch.where(take, t_new, t)
            dt_next = torch.where(active, torch.minimum(
                dt_new, t_end - t_next + 1e-30), dt)
            dt_next = torch.maximum(dt_next, dt_floor)
            done = done | (t_next >= t_end - 1e-12)
            nfe = nfe + torch.where(active, 6, 0)
        z = torch.where(_bc(take, z), z5, z)
        k1 = torch.where(_bc(take, z), ks[6], ks[0])
        return t_next, z, k1, dt_next, facold, zs, filled, nfe, done

    carry = (t0, z0, f0, dt0, torch.full((B,), 1e-4, dtype=dtype, device=dev),
             zs0, filled0, torch.full((B,), 2, device=dev),
             torch.zeros((B,), dtype=torch.bool, device=dev))
    _, zf, _, _, _, zs, filled, nfe, _ = _bounded_loop(
        step, carry, 8, max_steps, remat, early_stop)
    # outputs left unfilled when max_steps ran out: the final state
    zs = torch.where(_bc(filled, zs), zs, zf[None])
    return zs, nfe.sum()


# ---------------------------------------------------------------------------
# VCABM: variable-coefficient, variable-step, variable-order Adams (the
# JAX package's `adams`; Shampine & Gordon's divided-difference form)
# ---------------------------------------------------------------------------

_VCABM_MAX_ORDER = 12
_VCABM_GSTAR = [_f32(g) for g in (
    1.0, -1 / 2, -1 / 12, -1 / 24, -19 / 720, -3 / 160, -863 / 60480,
    -275 / 24192, -33953 / 3628800, -0.00789255, -0.00678585, -0.00592406,
    -0.00523669)]


def _take(arr, i):
    """arr[b, i[b]] per problem, the index clamped into range (JAX's
    dynamic_index_in_dim clamps)."""
    i = torch.clamp(i, 0, arr.shape[1] - 1)
    return arr[torch.arange(arr.shape[0], device=arr.device), i]


def _vcabm_g_beta(prev_t, next_t, k, width):
    """Per-problem coefficient tables for one candidate step: prev_t
    (B, width-1) accepted step times, most recent first; returns g
    (B, width) and beta (B, width)."""
    B = prev_t.shape[0]
    dtype, dev = prev_t.dtype, prev_t.device
    dt = next_t - prev_t[:, 0]
    j_idx = torch.arange(1, width, device=dev)
    # the last index runs past the history; it is masked out below
    prev_pad = torch.cat([prev_t, prev_t[:, -1:]], dim=1)
    num = next_t[:, None] - prev_t[:, j_idx - 1]
    den = prev_t[:, :1] - prev_pad[:, j_idx]
    live = j_idx[None, :] <= (k - 1)[:, None]
    den = torch.where(live & (den != 0), den, torch.ones_like(den))
    ratios = torch.where(live, num / den, torch.ones_like(num))
    beta = torch.cat([torch.ones((B, 1), dtype=dtype, device=dev),
                      torch.cumprod(ratios, dim=1)], dim=1)

    c = (1.0 / torch.arange(1, width + 2, dtype=dtype, device=dev)).expand(
        B, width + 1)
    cols = [torch.ones((B,), dtype=dtype, device=dev)]
    zero = torch.zeros((B, 1), dtype=dtype, device=dev)
    for j in range(1, width):
        if j == 1:
            fac = torch.ones_like(dt)
        else:
            denom = next_t - prev_t[:, j - 1]
            fac = dt / torch.where(denom != 0, denom, torch.ones_like(denom))
        c_new = c - torch.cat([c[:, 1:], zero], dim=1) * fac[:, None]
        c = torch.where((j <= k)[:, None], c_new, c)
        cols.append(c[:, 0])
    g = torch.stack(cols, dim=1)
    g = torch.where(torch.arange(width, device=dev)[None, :] <= k[:, None],
                    g, torch.zeros_like(g))
    return g, beta


def _vcabm(f, z0, ts, rtol, atol, max_steps, remat, early_stop):
    T = ts.shape[0]
    B = z0.shape[0]
    dtype, dev = z0.dtype, z0.device
    W = _VCABM_MAX_ORDER + 2
    MAX = _VCABM_MAX_ORDER
    t0 = ts[0].expand(B)
    gstar = torch.tensor(_VCABM_GSTAR, dtype=dtype, device=dev).expand(
        B, len(_VCABM_GSTAR))
    t_floor = 8.0 * torch.finfo(dtype).eps * torch.clamp(
        torch.max(torch.abs(ts)), min=1.0)

    f0 = f(t0, z0)
    dt0 = torch.minimum(
        _hairer_initial_step(f, t0, z0, f0, rtol, atol, order=1),
        torch.abs(ts[1] - ts[0]))

    def wsum(coef, tab):
        """sum_j coef[b, j] tab[b, j] over the table dim."""
        return torch.bmm(coef[:, None, :], tab.reshape(B, W, -1)).reshape(
            (B,) + tab.shape[2:])

    def step(y, prev_t, phi, order, n_acc, next_t, tgt, zs, nfe, done):
        final_t = ts[torch.clamp(tgt, max=T - 1)]
        t_next = torch.where(next_t >= final_t - t_floor, final_t, next_t)
        dt = t_next - prev_t[:, 0]
        g, beta = _vcabm_g_beta(prev_t, t_next, order, W)
        ex_phi = phi * _bc(beta, phi)                       # (B, W, ...)

        jmask = (torch.arange(W, device=dev)[None, :]
                 <= (order - 2)[:, None]).to(dtype)
        dtb = _bc(dt, y)
        p = y + dtb * wsum(g * jmask, ex_phi)
        f_p = f(t_next, p)
        cs = torch.cumsum(ex_phi, dim=1)
        phi_p = torch.cat([f_p[:, None], f_p[:, None] - cs[:, :-1]], dim=1)
        y_next = p + _bc(dt * _take(g, order - 1), y) * _take(phi_p,
                                                                order - 1)
        f_c = f(t_next, y_next)
        phi_next = torch.cat([f_c[:, None], f_c[:, None] - cs[:, :-1]],
                             dim=1)

        with _no_grad():
            scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(p))
            g0, g1, g2, g3 = (_take(g, order + o) for o in (0, -1, -2, -3))
            err_k = _rms(_bc(dt * (g0 - g1), y) * _take(phi_p, order)
                         + _bc(dt * g1, y) * (f_c - f_p), scale)
            accept = err_k <= 1.0
            err_km1 = _rms(_bc(dt * (g1 - g2), y) * _take(phi_p, order - 1),
                           scale)
            err_km2 = _rms(_bc(dt * (g2 - g3), y) * _take(phi_p, order - 2),
                           scale)
            err_kp1 = _rms(_bc(dt * _take(gstar, order + 1), y)
                           * _take(phi_next, order + 1), scale)
            young = (n_acc + 1 <= 4) | (order < 3)
            ord_up = torch.clamp(order + 1, max=min(3, MAX))
            dec = torch.minimum(err_km1, err_km2) < err_k
            inc = (order < MAX) & (err_kp1 < err_k)
            ord_mature = torch.where(dec, order - 1,
                                     torch.where(inc, order + 1, order))
            next_order = torch.clamp(torch.where(young, ord_up, ord_mature),
                                     1, MAX)
            expo = 1.0 / (order.to(dtype) + 1.0)
            fac = torch.clamp(0.9 * err_k ** (-expo), 0.2, 10.0)
            dt_acc = torch.where(next_order > order, dt, dt * fac)
            dt_rej = dt * torch.clamp(fac, max=1.0)
            dt_new = torch.maximum(torch.where(accept, dt_acc, dt_rej),
                                   t_floor)
            active = ~done
            hit = accept & active & (t_next >= final_t)
            at = ((torch.arange(T, device=dev)[:, None] == tgt[None, :])
                  & hit[None, :])                               # (T, B)
            tgt = tgt + hit.to(tgt.dtype)
            done = done | (tgt >= T)
            acc = accept & active
        zs = torch.where(_bc(at, zs), y_next[None], zs)
        y = torch.where(_bc(acc, y), y_next, y)
        phi = torch.where(_bc(acc, phi), phi_next, phi)
        with _no_grad():
            prev_t = torch.where(acc[:, None], torch.cat(
                [t_next[:, None], prev_t[:, :-1]], dim=1), prev_t)
            order = torch.where(acc, next_order, order)
            n_acc = n_acc + acc.to(n_acc.dtype)
            next_t = torch.where(active, prev_t[:, 0] + dt_new, next_t)
            nfe = nfe + torch.where(active, 2, 0)
        return y, prev_t, phi, order, n_acc, next_t, tgt, zs, nfe, done

    ones = torch.ones((B,), dtype=torch.int64, device=dev)
    carry = (
        z0, t0[:, None].expand(B, W - 1).contiguous(),
        torch.cat([f0[:, None], torch.zeros((B, W - 1) + z0.shape[1:],
                                            dtype=dtype, device=dev)], dim=1),
        ones, 0 * ones, t0 + dt0, ones,
        torch.cat([z0[None], torch.zeros((T - 1,) + z0.shape, dtype=dtype,
                                         device=dev)]),
        2 * ones, torch.full((B,), T <= 1, device=dev))
    yf, _, _, _, _, _, tgt, zs, nfe, _ = _bounded_loop(
        step, carry, 9, max_steps, remat, early_stop)
    # outputs left unfilled when max_steps ran out: the final state
    filled = (torch.arange(T, device=dev)[:, None]
              < torch.clamp(tgt, min=1)[None, :])
    zs = torch.where(_bc(filled, zs), zs, yf[None])
    return zs, nfe.sum()


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------

def odeint(f, z0, ts, method='euler', dense=1, rtol=1e-6, atol=1e-6,
           max_steps=256, remat=True, batched=False, early_stop=True):
    """Integrate dz/dt = f(t, z) from ts[0] through ts[-1].

    @param f: RHS callable (t, z) -> dz
    @param z0: initial state; with `batched`, its leading dim indexes
        independent problems, each with its own adaptive controller
    @param ts: (T,) requested output times, ts[0] is t0
    @param method: one of SOLVERS
    @param dense: substeps per output interval for fixed-step methods
    @param rtol, atol: adaptive tolerances
    @param max_steps: bound on adaptive candidate steps
    @param remat: rematerialise step bodies in reverse mode
    @param early_stop: end the adaptive loop once every problem is done
        (the same values and gradients as running all max_steps)
    @return: ODESolution(zs=(T, *z0.shape), nfe): nfe summed over the
        problems, a Python int for the fixed-step methods and a 0-d int64
        tensor on z0's device for the adaptive ones
    """
    ts = torch.as_tensor(ts, dtype=z0.dtype, device=z0.device)
    B = z0.shape[0] if batched else 1
    if method in _ONESTEP:
        zs, nfe = _fixed_singlestep(f, z0, ts, method, dense, remat)
    elif method in ('explicit_adams', 'fixed_adams'):
        zs, nfe = _fixed_adams_family(f, z0, ts, method, dense, remat)
    elif method == 'bdf':
        zs, nfe = _fixed_bdf2(f, z0, ts, dense, remat)
    elif method in ADAPTIVE_SOLVERS:
        solve = _dopri5 if method == 'dopri5' else _vcabm
        if batched:
            zs, nfe = solve(f, z0, ts, rtol, atol, max_steps, remat,
                            early_stop)
        else:
            zs, nfe = solve(lambda t, z: f(t[0], z[0])[None], z0[None], ts,
                            rtol, atol, max_steps, remat, early_stop)
        return ODESolution(zs=zs if batched else zs[:, 0], nfe=nfe)
    else:
        raise ValueError(f'unknown solver {method!r}; choose from {SOLVERS}')
    return ODESolution(zs=zs, nfe=nfe * B)
