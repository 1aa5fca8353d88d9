"""Continuous adjoint-sensitivity reverse mode for the ODE solvers (port of
`vae_gp_ode_tpu/dynamics/adjoint.py`).

The forward solve keeps no graph; the backward integrates the augmented
system over each output interval in reversed time s = t1 - t:

    dz/ds   = -f(theta, t, z)
    da/ds   =  a^T df/dz          (a vector-Jacobian product)
    dgth/ds =  a^T df/dtheta      (a vector-Jacobian product)

with a += cotangent(z_i) injected at each saved output time. On the GPU
every product goes through the per-step kernels that the card's dispatch
rule names (`ops.pathwise_tiled`, `ops.df_pathwise_tiled`).

Three backward integrators, as in the JAX package:
  * euler/midpoint/rk4: fixed steps over the augmented state;
  * bdf: semi-implicit BDF2 (Newton on z, a per-row (D, D) linear solve
    for a, trapezoidal quadrature for gth);
  * everything else (dopri5, adams, the fixed Adams family): the
    augmented state ravelled per problem and integrated with the same
    solver.

theta is a tuple of tensors with a leading dim of B problems (the draws):
each problem has its own parameter cotangent, so the ravelled state of a
draw holds what the JAX package's vmapped ravel holds and an adaptive
backward solve takes the same steps. Gradients with respect to ts are
zero.
"""

import torch

from vae_gp_ode_tpu_torch.core import linalg
from vae_gp_ode_tpu_torch.core.device import check_device, resolve_device
from vae_gp_ode_tpu_torch.core.transforms import softplus
from vae_gp_ode_tpu_torch.dynamics.solvers import (
    SOLVERS, _newton_solve, odeint, row_jacobian,
)

_FIXED = ('euler', 'midpoint', 'rk4')


def _axpy(a, x, y):
    """y + a * x over tuples of tensors."""
    return tuple(yi + a * xi for xi, yi in zip(x, y))


def _step_tree(method, rhs, t, state, h):
    if method == 'euler':
        return _axpy(h, rhs(t, state), state)
    if method == 'midpoint':
        k1 = rhs(t, state)
        k2 = rhs(t + 0.5 * h, _axpy(0.5 * h, k1, state))
        return _axpy(h, k2, state)
    k1 = rhs(t, state)
    k2 = rhs(t + 0.5 * h, _axpy(0.5 * h, k1, state))
    k3 = rhs(t + 0.5 * h, _axpy(0.5 * h, k2, state))
    k4 = rhs(t + h, _axpy(h, k3, state))
    acc = tuple(a + 2 * b + 2 * c + d for a, b, c, d in zip(k1, k2, k3, k4))
    return _axpy(h / 6.0, acc, state)


def _vjp(f, theta, t, z, a, wrt_z=True):
    """f(theta, t, z) and the cotangents a^T df/dtheta (one per leaf, zeros
    for leaves f does not read) and, with wrt_z, a^T df/dz."""
    with torch.enable_grad():
        th = [x.detach().requires_grad_() for x in theta]
        zz = z.detach().requires_grad_(wrt_z)
        fz = f(th, t, zz)
        grads = torch.autograd.grad(fz, th + ([zz] if wrt_z else []), a,
                                    allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(th + [zz], grads)]
    return fz.detach(), grads[len(th):], grads[:len(th)]


def _adjoint_backward(f, cfg, theta, zs, ts, zs_bar):
    """Cotangents (gth, a0bar) of theta and z0 from zs_bar (T, B, ...)."""
    method, dense, rtol, atol, max_steps = cfg

    def aug_rhs(t, aug):
        z, a, *_ = aug
        fz, (a_dot,), gth_dot = _vjp(f, theta, t, z, a)
        return (-fz, a_dot, *gth_dot)

    if method in _FIXED:
        def solve_interval(aug, t0, t1):
            h = (t1 - t0) / dense
            for i in range(dense):
                # integrate in s = t1 - t, so stages at s + c h evaluate the
                # RHS at t1 - s - c h, moving toward t0
                aug = _step_tree(method, lambda s_, a_: aug_rhs(t1 - s_, a_),
                                 i * h, aug, h)
            return aug
    elif method == 'bdf':
        def solve_interval(aug, t0, t1):
            z0_, a0_, *gth0_ = aug
            h = (t1 - t0) / dense
            eye = torch.eye(z0_.shape[-1], dtype=z0_.dtype, device=z0_.device)

            def fwd_f(t, zz):
                return f([x.detach() for x in theta], t, zz)

            def q_theta(t, zz, aa):
                return _vjp(f, theta, t, zz, aa, wrt_z=False)[2]

            z, a, gth, z_prev, a_prev, hp = z0_, a0_, gth0_, z0_, a0_, False
            for i in range(dense):
                t_old, t_new = t1 - i * h, t1 - (i + 1.0) * h
                c_f = 2.0 / 3.0 if hp else 1.0
                if hp:
                    def g(zn, z=z, z_prev=z_prev, t_new=t_new):
                        fn_ = -fwd_f(t_new, zn)              # dz/ds = -f
                        return (zn - (4.0 / 3.0) * z + (1.0 / 3.0) * z_prev
                                - (2.0 / 3.0) * h * fn_)
                else:
                    def g(zn, z=z, t_new=t_new):
                        return zn - z - h * -fwd_f(t_new, zn)
                z_new = _newton_solve(g, z - h * fwd_f(t_old, z))
                # linear implicit step for a: (I - c_f h J^T) a_new = rhs
                J = row_jacobian(lambda zz: fwd_f(t_new, zz), z_new)
                Mat = eye - c_f * h * J.transpose(-1, -2)
                rhs_a = (4.0 / 3.0) * a - (1.0 / 3.0) * a_prev if hp else a
                a_new = linalg.solve(Mat, rhs_a[..., None])[..., 0]
                # trapezoidal quadrature for the parameter cotangent
                q0 = q_theta(t_old, z, a)
                q1 = q_theta(t_new, z_new, a_new)
                gth = [g_ + 0.5 * h * (q0_ + q1_)
                       for g_, q0_, q1_ in zip(gth, q0, q1)]
                z, a, z_prev, a_prev, hp = z_new, a_new, z, a, True
            return (z, a, *gth)
    else:
        def solve_interval(aug, t0, t1):
            B = aug[0].shape[0]
            shapes = [x.shape for x in aug]
            sizes = [x[0].numel() for x in aug]

            def ravel(parts):
                return torch.cat([x.reshape(B, -1) for x in parts], dim=1)

            def unravel(y):
                return tuple(p.reshape(s) for p, s in zip(
                    y.split(sizes, dim=1), shapes))

            def rhs_flat(s_, y):
                return ravel(aug_rhs(t1 - s_, unravel(y)))

            span = torch.stack([torch.zeros_like(t1), t1 - t0])
            sol = odeint(rhs_flat, ravel(aug), span, method=method,
                         dense=dense, rtol=rtol, atol=atol,
                         max_steps=max_steps, remat=False, batched=True)
            return unravel(sol.zs[-1])

    a = torch.zeros_like(zs[0])
    gth = [torch.zeros_like(x) for x in theta]
    for i in reversed(range(ts.shape[0] - 1)):
        a = a + zs_bar[i + 1]
        _, a, *gth = solve_interval((zs[i + 1], a, *gth), ts[i], ts[i + 1])
    return gth, a + zs_bar[0]


class _OdeintAdjoint(torch.autograd.Function):
    """odeint forward without a graph; reverse mode by the adjoint ODE."""

    @staticmethod
    def forward(ctx, f, cfg, out, z0, ts, *theta):
        method, dense, rtol, atol, max_steps = cfg
        sol = odeint(lambda t, z: f(theta, t, z), z0, ts, method=method,
                     dense=dense, rtol=rtol, atol=atol, max_steps=max_steps,
                     remat=False, batched=True)
        out['nfe'] = sol.nfe
        ctx.f, ctx.cfg = f, cfg
        ctx.save_for_backward(sol.zs, ts, *theta)
        return sol.zs

    @staticmethod
    def backward(ctx, zs_bar):
        zs, ts, *theta = ctx.saved_tensors
        gth, z0_bar = _adjoint_backward(ctx.f, ctx.cfg, theta, zs, ts,
                                        zs_bar)
        ts_bar = torch.zeros_like(ts) if ctx.needs_input_grad[4] else None
        return (None, None, None, z0_bar, ts_bar, *gth)


def odeint_adjoint(f, theta, z0, ts, method='euler', dense=1, rtol=1e-6,
                   atol=1e-6, max_steps=256):
    """Integrate dz/dt = f(theta, t, z) for B problems (the leading dim of
    z0 and of every tensor of the tuple theta); reverse mode via the
    adjoint ODE with the same method.

    @return: (zs (T, *z0.shape), nfe): nfe is the forward solve's RHS
        evaluations over the problems (no gradient)
    """
    if method not in SOLVERS:
        raise ValueError(f'unknown solver {method!r}; choose from {SOLVERS}')
    out = {}
    zs = _OdeintAdjoint.apply(f, (method, dense, rtol, atol, max_steps), out,
                              z0, ts, *theta)
    return zs, out['nfe']


def flow_forward_adjoint(gp, sample, z0, ts, order=1, solver='euler',
                         dense=1, rtol=1e-6, atol=1e-6, max_steps=256,
                         device='cuda'):
    """`dynamics.flow.flow_forward` with the continuous adjoint: gradients
    with respect to the GP leaves and the sample flow through the backward
    ODE solve; the sample's own construction (Cholesky etc.) is
    differentiated by the outer graph. Works with every solver.

    theta is every leaf of (gp, sample), as the JAX package's pytree:
    unconstrained lengthscales and variance, inducing locations, Um and
    Us_sqrt (which f does not read: zero cotangents), omega, phase,
    weights and nu, and for the DF kernel its contraction df_G (whose
    weights f then does not read), each with the leading dim of draws.
    f is the per-step eval of the GP's kernel through the card's dispatch
    rule (`ops.pathwise_tiled.pathwise_eval`,
    `ops.df_pathwise_tiled.df_pathwise_eval`).
    Returns (zs (..., N, T, D), nfe) as flow_forward does.
    """
    from vae_gp_ode_tpu_torch.ops import df_pathwise_tiled, pathwise_tiled
    from vae_gp_ode_tpu_torch.ops.df_pathwise import pack_df_operands
    dev = resolve_device(device)
    check_device(z0, dev, 'z0')
    if order not in (1, 2):
        raise ValueError(f'ODE order must be 1 or 2, got {order}')
    if gp.kernel_name == 'DF' and order != 1:
        raise ValueError('DF kernel flows are first order (D_in == D_out)')
    if ts.shape[0] < 2:
        raise ValueError(f'need at least 2 time points, got {ts.shape[0]}')
    lead = sample.lead
    L = lead[0] if lead else 1
    df = gp.kernel_name == 'DF'

    def per_draw(x, nd):
        return x if x.dim() > nd else x.expand((L,) + tuple(x.shape))

    shared = (gp.kernel.unconstrained_lengthscales,
              gp.kernel.unconstrained_variance, gp.inducing_loc, gp.Um,
              gp.Us_sqrt)
    draws = ((sample.rff.omega, 3), (sample.rff.phase, 3),
             (sample.rff.weights, 2), (sample.nu, 2 if df else 3))
    if df:
        draws += ((sample.df_G, 2),)
    theta = tuple(x.expand((L,) + tuple(x.shape)) for x in shared) + tuple(
        per_draw(x, nd) for x, nd in draws)

    def f(th, t, z):
        uls, uvar, Z, _, _, omega, phase, weights, nu = th[:9]
        if df:
            fz = df_pathwise_tiled.df_pathwise_eval(z, *pack_df_operands(
                omega, phase, th[9], Z, nu, softplus(uls), softplus(uvar)))
        else:
            fz = pathwise_tiled.pathwise_eval(z, omega, phase, weights, Z,
                                              nu[..., 0], softplus(uls),
                                              softplus(uvar))
        if order == 2:
            q = z.shape[-1] // 2
            fz = torch.cat([z[..., q:], fz], dim=-1)
        return fz

    z = per_draw(z0, 2)
    zs, nfe = odeint_adjoint(f, theta, z, ts, method=solver, dense=dense,
                             rtol=rtol, atol=atol, max_steps=max_steps)
    zs = zs.movedim(0, -2)
    return (zs if lead else zs[0]), nfe
