"""ODE flow over a sampled GP vector field (port of
`vae_gp_ode_tpu/dynamics/flow.py`).

This slice integrates with first- or second-order euler at dense=1 (the
main configuration) through the fused trajectory kernel
(ops.flow_fused): one launch for all the draws of a batched `FnSample`.
Other solvers and dense output are not ported yet and raise.
"""

import torch

from vae_gp_ode_tpu_torch.core.device import check_device, resolve_device
from vae_gp_ode_tpu_torch.gp.svgp import SVGPParams, FnSample, fn_eval

_SOLVERS_TODO = ('solvers other than euler, and dense > 1, are not ported '
                 'yet (ROADMAP Queue A item 11)')


def make_ode_rhs(gp: SVGPParams, sample: FnSample, order: int):
    """Build the RHS f(t, z) for a 1st- or 2nd-order latent ODE.

    order 1: dz = f(z)
    order 2: z = (s, v); d(s, v) = (v, f(s, v))
    """
    if order == 1:
        def rhs(t, z):
            return fn_eval(gp, sample, z)
    elif order == 2:
        def rhs(t, z):
            q = z.shape[-1] // 2
            return torch.cat([z[..., q:], fn_eval(gp, sample, z)], dim=-1)
    else:
        raise ValueError(f'ODE order must be 1 or 2, got {order}')
    return rhs


def flow_forward(gp: SVGPParams, sample: FnSample, z0, ts, order=1,
                 solver='euler', dense=1, device='cuda'):
    """Integrate z0 (N, D) over ts (T,) under the sample(s).

    Returns (zs, nfe): zs (..., N, T, D) where `...` is the sample's batch
    of draws, and nfe the number of RHS evaluations over all draws. The
    tensors must lie on `device` (default the GPU, where the fused kernel
    runs; 'cpu' computes its plain version).
    """
    dev = resolve_device(device)
    check_device(z0, dev, 'z0')
    if order not in (1, 2):
        raise ValueError(f'ODE order must be 1 or 2, got {order}')
    if solver != 'euler' or dense != 1:
        raise NotImplementedError(f'solver={solver!r}, dense={dense}: '
                                  + _SOLVERS_TODO)
    T = ts.shape[0]
    if T < 2:
        raise ValueError(f'need at least 2 time points, got {T}')
    from vae_gp_ode_tpu_torch.ops.flow_fused import fused_euler_flow
    from vae_gp_ode_tpu_torch.ops.pathwise import rbf_fused_operands
    zs = fused_euler_flow(z0, *rbf_fused_operands(gp, sample),
                          torch.diff(ts), T, order)
    draws = zs[..., 0, 0, 0].numel()
    return zs.transpose(-3, -2), (T - 1) * draws
