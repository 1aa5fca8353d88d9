"""Divergence-free matrix-valued kernel, the "informative prior" (port of
`vae_gp_ode_tpu/kernels/divfree.py`).

An RBF envelope times a Hessian-structure term
(d d^T / l^2 + ((D-1) - r^2/l^2) I), whose sampled vector fields have zero
divergence; operator-valued random Fourier features (B(w) = |w| I -
w w^T / |w|, cos and sin blocks, 2S weights); one (M*D, M*D) Cholesky for
the pathwise update.

The JAX module's quirks are kept:
  * unscaled squared distances with an explicit 1/(2 l^2) envelope, l^2
    the full (D, D) lengthscale matrix of the dimwise RBF layout
    (lengthscales (D, D), variance (D,)) broadcast over output-dim pairs;
  * `df_orff_B` takes |w| per (feature, output column) and w w^T over the
    transposes exactly as the JAX code does;
  * cos and sin blocks share B(w) with independent weights (2S, D), and
    sqrt(var / S) is indexed by the output dim;
  * nu is in points-major (m * D + d) order.

Every function that takes a function draw also takes a leading batch of
draws, as `kernels.rbf` does; the gram depends on the GP only.
"""

import math
from typing import Optional

import torch

from vae_gp_ode_tpu_torch.core.settings import JITTER
from vae_gp_ode_tpu_torch.core.linalg import cholesky, solve_triangular
from vae_gp_ode_tpu_torch.kernels.rbf import (
    RBFParams, RFFState, rbf_lengthscales, rbf_variance,
)


def _df_blocks(p: RBFParams, X, X2=None):
    """K(X, X2) as (..., N, M, D, D) blocks [n, m, a, b]."""
    D = X.shape[-1]
    ls = rbf_lengthscales(p)
    var = rbf_variance(p)
    ls2 = ls * ls                                         # (D, D)
    X2_ = X if X2 is None else X2
    xn = torch.sum(X * X, dim=-1)
    x2n = torch.sum(X2_ * X2_, dim=-1)
    sq = -2.0 * (X @ X2_.transpose(-1, -2)) + xn[..., :, None] \
        + x2n[..., None, :]                               # (..., N, M)
    sq4 = sq[..., None, None]
    rbf_term = var * torch.exp(-sq4 / (2.0 * ls2))        # (..., N, M, D, D)
    diff = X2_[..., None, :, :] - X[..., :, None, :]      # (..., N, M, D)
    term1 = diff[..., :, None] * diff[..., None, :] / ls2
    eye = torch.eye(D, dtype=X.dtype, device=X.device)
    term2 = ((D - 1.0) - sq4 / ls2) * eye
    return rbf_term * (term1 + term2) / ls2


def df_gram(p: RBFParams, X, X2=None):
    """Matrix-valued gram K(X, X2) -> (..., N*D, M*D), output dims
    interleaved with points (index n*D + a, m*D + b)."""
    K = _df_blocks(p, X, X2)
    N, M, D = K.shape[-4], K.shape[-3], K.shape[-1]
    return K.transpose(-3, -2).reshape(K.shape[:-4] + (N * D, M * D))


def df_gram_diag(p: RBFParams, X):
    """Diagonal of `df_gram(p, X)`, (N*D,): var[d] (D-1) / ls2[d, d] for
    every point, in the gram's points-major layout."""
    D = X.shape[-1]
    ls2 = rbf_lengthscales(p) ** 2
    kdiag = rbf_variance(p) * (D - 1.0) / torch.diagonal(ls2)
    return kdiag.repeat(X.shape[-2])


def df_sample_rff(p: RBFParams, generator, S, D_in, D_out,
                  noise: Optional[dict] = None, L=None) -> RFFState:
    """Draw operator-valued RFF parameters: omega (..., D, S, D) scaled by
    the dimwise lengthscales, phase (..., 1, S, D), weights (..., 2S, D)
    (cos and sin blocks). `noise` injects the raw draws {omega, phase_u,
    weights}; otherwise `generator` draws them, with a leading batch of
    `L` when `L` is given."""
    ls = rbf_lengthscales(p)
    if noise is None:
        lead = () if L is None else (L,)
        kw = dict(generator=generator, dtype=ls.dtype, device=ls.device)
        omega_raw = torch.randn(lead + (D_in, S, D_out), **kw)
        phase_u = torch.rand(lead + (1, S, D_out), **kw)
        weights = torch.randn(lead + (2 * S, D_out), **kw)
    else:
        omega_raw = noise['omega']
        phase_u = noise['phase_u']
        weights = noise['weights']
    omega = omega_raw / ls.T[:, None, :]
    phase = phase_u * (2.0 * math.pi)
    return RFFState(omega=omega, phase=phase, weights=weights)


def df_orff_B(rff: RFFState):
    """B(w) = |w| I - w w^T / |w| per feature -> (..., 2S, D, D), cos and
    sin blocks sharing B, with the JAX code's index order."""
    D = rff.omega.shape[-3]
    om1 = rff.omega.transpose(-3, -2)                      # (..., S, D, D)
    ww = om1 @ om1.transpose(-1, -2)                       # (..., S, D, D)
    norm = torch.sqrt(torch.sum(rff.omega ** 2, dim=-3))[..., :, None, :]
    eye = torch.eye(D, dtype=rff.omega.dtype, device=rff.omega.device)
    b_omega = norm * eye - ww / norm
    return torch.cat([b_omega, b_omega], dim=-3)


def df_orff_contraction(p: RBFParams, rff: RFFState):
    """The per-draw ORFF contraction matrix G (..., 2S*D, D):

        f(n, d) = sum_{j,i} trig(n, j, i) w(j, i) B(j, i, d) sqrt(var_d / S)
                = [trig flat (N, 2S*D)] @ G

    B, w and var are fixed for a draw, so the per-step prior eval is trig
    features and one contraction."""
    S = rff.omega.shape[-2]
    var = rbf_variance(p)
    G = df_orff_B(rff) * rff.weights[..., :, :, None]     # (..., 2S, D, D)
    G = G * torch.sqrt(var / S)
    return G.reshape(G.shape[:-3] + (G.shape[-3] * G.shape[-2], G.shape[-1]))


def df_rff_eval(p: RBFParams, rff: RFFState, x, G=None):
    """The operator-valued RFF prior draw(s) at x: (..., N, D) ->
    (..., N, D). With `G` (from `df_orff_contraction`) trig features and
    one product; without it the direct computation through B."""
    D, S = rff.omega.shape[-3], rff.omega.shape[-2]
    xo = x @ rff.omega.reshape(rff.omega.shape[:-3] + (D, S * D))
    xo = xo.reshape(xo.shape[:-1] + (S, D)) + rff.phase   # (..., N, S, D)
    trig = torch.cat([torch.cos(xo), torch.sin(xo)], dim=-2)
    if G is not None:
        return trig.reshape(trig.shape[:-2] + (2 * S * D,)) @ G
    B = df_orff_B(rff)                                    # (..., 2S, D, D)
    phi = trig[..., None] * B[..., None, :, :, :] * torch.sqrt(
        rbf_variance(p) / S)
    return torch.sum(phi * rff.weights[..., None, :, :, None], dim=(-3, -2))


def df_compute_nu(p: RBFParams, Ku, u_prior, u):
    """Pathwise-update coefficients: one (M*D, M*D) Cholesky, shared by
    the draws, and two triangular solves. Ku (M*D, M*D); u_prior, u
    (..., M, D). Returns (..., M*D, 1)."""
    MD = Ku.shape[-1]
    eye = torch.eye(MD, dtype=Ku.dtype, device=Ku.device)
    Lu = cholesky(Ku + eye * JITTER)
    up = u_prior.reshape(u_prior.shape[:-2] + (MD, 1))
    uu = u.reshape(u.shape[:-2] + (MD, 1))
    a = solve_triangular(Lu, up, lower=True)
    return solve_triangular(Lu.transpose(-1, -2), uu - a, lower=False)


def df_f_update(p: RBFParams, nu, x, Z):
    """Pathwise update K(x, Z) nu -> (..., N, D); nu (..., M*D, 1)."""
    Kuf = df_gram(p, Z, x)                                # (..., MD, ND)
    return (Kuf.transpose(-1, -2) @ nu).reshape(
        nu.shape[:-2] + tuple(x.shape[-2:]))
