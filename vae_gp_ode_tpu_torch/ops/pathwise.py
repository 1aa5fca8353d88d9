"""Plain pathwise GP evaluation and the shared kernel-operand block (port
of the reference half of `vae_gp_ode_tpu/ops/pathwise.py`).

The per-step Pallas kernel of that module (`_pathwise_kernel`) is not in
this slice; it is queued in ROADMAP Queue B.
"""

import torch

from vae_gp_ode_tpu_torch.kernels.rbf import rbf_lengthscales, rbf_variance


def pathwise_eval_reference(x, omega, phase, weights, Z, nu, ls, var):
    """Dimwise-RBF prior + pathwise update.

    Shapes: x (..., N, D), omega (..., D, S, K), phase (..., 1, S, K),
    weights (..., S, K), Z (M, D), nu (..., K, M), ls (K, D), var (K,).
    Returns (..., N, K). Keeps the sqrt(var/S) prior scaling quirk.
    """
    D, S, K = omega.shape[-3:]
    xo = x @ omega.reshape(omega.shape[:-3] + (D, S * K))
    xo = xo.reshape(xo.shape[:-1] + (S, K))                 # (..., N, S, K)
    phi = torch.cos(xo + phase) * torch.sqrt(var / S)
    f_prior = torch.sum(phi * weights[..., None, :, :], dim=-2)

    Xd = x[..., None, :, :] / ls[:, None, :]                # (..., K, N, D)
    Zd = Z[None, :, :] / ls[:, None, :]                     # (K, M, D)
    xn = torch.sum(Xd * Xd, dim=-1)                         # (..., K, N)
    zn = torch.sum(Zd * Zd, dim=-1)                         # (K, M)
    cross = Zd @ Xd.transpose(-1, -2)                       # (..., K, M, N)
    sq = zn[:, :, None] + xn[..., None, :] - 2.0 * cross
    Kuf = var[:, None, None] * torch.exp(-0.5 * sq)         # (..., K, M, N)
    f_up = (nu[..., None, :] @ Kuf)[..., 0, :]              # (..., K, N)
    return f_prior + f_up.transpose(-1, -2)


def rbf_fused_operands(gp, sample):
    """The fused-RBF operand block (omega, phase, weights, Z, nu, ls, var)
    shared by the per-step eval and the whole-trajectory flow; draw
    operands keep the sample's leading batch of draws."""
    return (sample.rff.omega, sample.rff.phase, sample.rff.weights,
            gp.inducing_loc, sample.nu[..., 0],
            rbf_lengthscales(gp.kernel), rbf_variance(gp.kernel))
