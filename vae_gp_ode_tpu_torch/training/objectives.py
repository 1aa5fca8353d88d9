"""ELBO objective with the reference's scaling (port of
`vae_gp_ode_tpu/training/objectives.py`):

  loss = -(lhood * Ndata - kl_reg * Ndata - kl_u)

lhood and kl_reg are per-sequence means (MC-averaged over L); kl_u is the
whitened inducing KL, not scaled by Ndata (reference quirk).
"""

import torch

from vae_gp_ode_tpu_torch.gp.svgp import SVGPParams, svgp_kl
from vae_gp_ode_tpu_torch.models.vae import (
    bernoulli_log_prob, gaussian_kl_standard,
)


def elbo_terms(X, Xrec, s_stats, v_stats, gp: SVGPParams,
               eps_guard: bool = False):
    """(lhood, kl_reg, kl_u), each a scalar. X (N, T, 1, d, d),
    Xrec (L, N, T, 1, d, d)."""
    s0_mu, s0_logv = s_stats
    v0_mu, v0_logv = v_stats
    if v0_mu is not None:
        mu = torch.cat([s0_mu, v0_mu], dim=1)
        logv = torch.cat([s0_logv, v0_logv], dim=1)
    else:
        mu, logv = s0_mu, s0_logv
    kl_reg = torch.mean(gaussian_kl_standard(mu, logv))
    lp = bernoulli_log_prob(X[None], Xrec, eps_guard=eps_guard)
    # sum over (T, c, h, w), average over L, then over N
    lhood = torch.mean(torch.mean(torch.sum(lp, dim=(2, 3, 4, 5)), dim=0))
    return lhood, kl_reg, svgp_kl(gp)


def compute_loss(X, Xrec, s_stats, v_stats, gp: SVGPParams,
                 num_observations: float, eps_guard: bool = False):
    """loss = -(lhood*N - kl_reg*N - kl_u); returns (loss, nll, kl_reg, kl_u)."""
    lhood, kl_reg, kl_u = elbo_terms(X, Xrec, s_stats, v_stats, gp,
                                     eps_guard=eps_guard)
    loss = -(lhood * num_observations - kl_reg * num_observations - kl_u)
    return loss, -lhood, kl_reg, kl_u


def compute_test_error(X, Xrec):
    """Mean squared reconstruction error."""
    if X.shape != Xrec.shape:
        raise ValueError(f'incorrect shapes X: {tuple(X.shape)}, '
                         f'Xrec: {tuple(Xrec.shape)}')
    return torch.mean((Xrec - X) ** 2)
