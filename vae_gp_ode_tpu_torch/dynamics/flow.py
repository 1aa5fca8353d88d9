"""ODE flow over a sampled GP vector field (port of
`vae_gp_ode_tpu/dynamics/flow.py`).

First-order euler at dense=1 (the main configuration) runs the whole
trajectory of all the draws of a batched `FnSample` in one kernel, with
its discrete adjoint in another, wherever that pair takes the shapes
(`use_fused_pair`): `ops.flow_fused` for the RBF kernel (orders 1 and 2;
a shared-lengthscale sample on the dimwise operands it broadcasts to,
`ops.pathwise.rbf_fused_operands`), `ops.df_flow_fused` for the
divergence-free kernel (order 1).
Every other solver, dense output, and the shapes the pair refuses
integrate with `dynamics.solvers.odeint` over `gp.svgp.fn_eval`, whose
per-step evaluation and its VJP are, on the GPU, the kernels that the
card's dispatch rule names: the single-block pair of `ops.pathwise` (RBF)
or `ops.df_pathwise` (DF), or the grid-tiled pair of `ops.pathwise_tiled`
or `ops.df_pathwise_tiled`.
"""

import torch

from vae_gp_ode_tpu_torch.core.device import check_device, resolve_device
from vae_gp_ode_tpu_torch.dynamics.solvers import SOLVERS, odeint
from vae_gp_ode_tpu_torch.gp.svgp import (
    SVGPParams, FnSample, fn_eval, fn_jacobian, svgp_kl,
)


def make_ode_rhs(gp: SVGPParams, sample: FnSample, order: int):
    """Build the RHS f(t, z) for a 1st- or 2nd-order latent ODE.

    order 1: dz = f(z)
    order 2: z = (s, v); d(s, v) = (v, f(s, v))

    `rhs.jacobian(t, z)` gives its per-row Jacobians (..., D, D), a
    constant of reverse mode (`gp.svgp.fn_jacobian`), which bdf's Newton
    iterations take: order 1 J_f, order 2 the blocks [[0, I], [J_f]].
    """
    if order == 1:
        def rhs(t, z):
            return fn_eval(gp, sample, z)

        def jacobian(t, z):
            return fn_jacobian(gp, sample, z)
    elif order == 2:
        def rhs(t, z):
            q = z.shape[-1] // 2
            return torch.cat([z[..., q:], fn_eval(gp, sample, z)], dim=-1)

        def jacobian(t, z):
            J = fn_jacobian(gp, sample, z)                 # (..., q, 2q)
            q = z.shape[-1] // 2
            top = torch.eye(2 * q, dtype=J.dtype, device=J.device)[q:]
            return torch.cat([top.expand(J.shape), J], dim=-2)
    else:
        raise ValueError(f'ODE order must be 1 or 2, got {order}')
    rhs.jacobian = jacobian
    return rhs


def use_fused_pair(gp: SVGPParams, sample: FnSample, z0, T, order):
    """Whether the euler flow runs the fused trajectory kernel and its
    adjoint: decided from the shapes alone, before any launch. On the GPU
    the adjoint kernel must take the state dim and fit its block's shared
    memory (`ops.flow_fused.fused_pair_fits`, or for the DF kernel
    `ops.df_flow_fused.df_fused_pair_fits`); on the CPU the pair's plain
    versions take every shape."""
    if z0.device.type != 'cuda':
        return True
    D = z0.shape[-1]
    if gp.kernel_name == 'DF':
        S = sample.rff.omega.shape[-2]
        from vae_gp_ode_tpu_torch.ops.df_flow_fused import df_fused_pair_fits
        return df_fused_pair_fits(D, S * D, gp.M, z0.device)
    from vae_gp_ode_tpu_torch.ops.flow_fused import fused_pair_fits
    S = sample.rff.weights.shape[-2]
    return fused_pair_fits(D, D // order, S, gp.M, T, z0.device)


def flow_forward(gp: SVGPParams, sample: FnSample, z0, ts, order=1,
                 solver='euler', dense=1, rtol=1e-6, atol=1e-6,
                 max_steps=256, remat=True, device='cuda'):
    """Integrate z0 (N, D) over ts (T,) under the sample(s).

    Returns (zs, nfe): zs (..., N, T, D) where `...` is the sample's batch
    of draws, and nfe the number of RHS evaluations over all draws (a
    Python int, or a 0-d device tensor for the adaptive solvers, whose
    draws each take their own steps). The tensors must lie on `device`
    (default the GPU, where the kernels run; 'cpu' computes their plain
    versions).
    """
    dev = resolve_device(device)
    check_device(z0, dev, 'z0')
    if order not in (1, 2):
        raise ValueError(f'ODE order must be 1 or 2, got {order}')
    if gp.kernel_name == 'DF' and order != 1:
        raise ValueError('DF kernel flows are first order (D_in == D_out)')
    if solver not in SOLVERS:
        raise ValueError(f'unknown solver {solver!r}; choose from {SOLVERS}')
    T = ts.shape[0]
    if T < 2:
        raise ValueError(f'need at least 2 time points, got {T}')
    if solver == 'euler' and dense == 1 and use_fused_pair(gp, sample, z0,
                                                           T, order):
        if gp.kernel_name == 'DF':
            from vae_gp_ode_tpu_torch.ops.df_flow_fused import (
                packed_df_euler_flow)
            from vae_gp_ode_tpu_torch.ops.df_pathwise import (
                df_fused_operands)
            zs = packed_df_euler_flow(z0, *df_fused_operands(gp, sample),
                                      torch.diff(ts), T)
        else:
            from vae_gp_ode_tpu_torch.ops.flow_fused import fused_euler_flow
            from vae_gp_ode_tpu_torch.ops.pathwise import rbf_fused_operands
            zs = fused_euler_flow(z0, *rbf_fused_operands(gp, sample),
                                  torch.diff(ts), T, order)
        draws = zs[..., 0, 0, 0].numel()
        return zs.transpose(-3, -2), (T - 1) * draws
    lead = sample.lead
    z = z0.expand(lead + tuple(z0.shape[-2:])) if lead else z0
    sol = odeint(make_ode_rhs(gp, sample, order), z, ts, method=solver,
                 dense=dense, rtol=rtol, atol=atol, max_steps=max_steps,
                 remat=remat, batched=bool(lead))
    return sol.zs.movedim(0, -2), sol.nfe


def flow_kl(gp: SVGPParams):
    """Inducing-posterior KL, KL(q(u) || p(u)) (JAX `dynamics.flow_kl`)."""
    return svgp_kl(gp)
