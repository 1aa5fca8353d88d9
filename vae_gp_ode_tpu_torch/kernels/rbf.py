"""Squared-exponential (RBF) kernel as functions over a params dataclass
(port of `vae_gp_ode_tpu/kernels/rbf.py`).

Only the dimwise kernel (per-output-dim lengthscales and variances, the
main configuration's) is ported; shared lengthscales raise.

Every function that takes a function draw (an `RFFState`, `nu`) also
takes a leading batch of draws: the L Monte-Carlo draws of one forward
are one batched call, not a Python loop. Randomness is an explicit
`torch.Generator` or injected raw noise.
"""

import dataclasses
import math
from typing import Optional

import torch

from vae_gp_ode_tpu_torch.core.settings import JITTER
from vae_gp_ode_tpu_torch.core.transforms import softplus, invsoftplus
from vae_gp_ode_tpu_torch.core.linalg import cholesky, solve_triangular


@dataclasses.dataclass
class RBFParams:
    """Unconstrained dimwise kernel hyperparameters: lengthscales
    (D_out, D_in), variance (D_out,)."""

    unconstrained_lengthscales: torch.Tensor
    unconstrained_variance: torch.Tensor

    def __post_init__(self):
        if self.unconstrained_lengthscales.dim() != 2:
            raise NotImplementedError(
                'only the dimwise RBF kernel is ported (shared lengthscales: '
                'ROADMAP Queue A item 2)')

    def to(self, device):
        return dataclasses.replace(
            self,
            unconstrained_lengthscales=self.unconstrained_lengthscales.to(
                device),
            unconstrained_variance=self.unconstrained_variance.to(device))


@dataclasses.dataclass
class RFFState:
    """Random-Fourier-feature parameters of one (or a batch of) prior
    function draw(s); `...` is the optional leading batch of draws.

    omega:   (..., D_in, S, D_out)
    phase:   (..., 1, S, D_out)
    weights: (..., S, D_out)
    """

    omega: torch.Tensor
    phase: torch.Tensor
    weights: torch.Tensor


def init_rbf_params(D_in, D_out=None, lengthscale=0.2, variance=0.1,
                    dtype=torch.float32, device='cpu'):
    """Constant-initialised params."""
    D_out = D_in if D_out is None else D_out
    ls = invsoftplus(torch.tensor(lengthscale, dtype=dtype))
    var = invsoftplus(torch.tensor(variance, dtype=dtype))
    return RBFParams(
        unconstrained_lengthscales=torch.full((D_out, D_in), float(ls),
                                              dtype=dtype, device=device),
        unconstrained_variance=torch.full((D_out,), float(var), dtype=dtype,
                                          device=device))


def rbf_lengthscales(p: RBFParams):
    return softplus(p.unconstrained_lengthscales)


def rbf_variance(p: RBFParams):
    return softplus(p.unconstrained_variance)


def _sqdist_dimwise(X, X2, ls):
    """Scaled squared distance per output dim -> (..., D_out, N, M)."""
    Xd = X[..., None, :, :] / ls[:, None, :]          # (..., D, N, D_in)
    X2d = Xd if X2 is None else X2[..., None, :, :] / ls[:, None, :]
    xn = torch.sum(Xd * Xd, dim=-1)                   # (..., D, N)
    x2n = xn if X2 is None else torch.sum(X2d * X2d, dim=-1)
    cross = Xd @ X2d.transpose(-1, -2)
    return -2.0 * cross + xn[..., :, None] + x2n[..., None, :]


def rbf_gram(p: RBFParams, X, X2=None):
    """K(X, X2): (..., D_out, N, M)."""
    var = rbf_variance(p)
    return var[:, None, None] * torch.exp(
        -0.5 * _sqdist_dimwise(X, X2, rbf_lengthscales(p)))


def rbf_sample_rff(p: RBFParams, generator, S, D_in, D_out,
                   noise: Optional[dict] = None, L=None) -> RFFState:
    """Draw RFF parameters: omega ~ N(0, diag(1/ls^2)), phase ~ U[0, 2pi),
    weights ~ N(0, I).

    `noise` injects the raw draws {omega, phase_u, weights} (their leading
    dims, if any, are the batch of draws); otherwise `generator` draws
    them, with a leading batch of `L` draws when `L` is given.
    """
    ls = rbf_lengthscales(p)
    if noise is None:
        lead = () if L is None else (L,)
        kw = dict(generator=generator, dtype=ls.dtype, device=ls.device)
        omega_raw = torch.randn(lead + (D_in, S, D_out), **kw)
        phase_u = torch.rand(lead + (1, S, D_out), **kw)
        weights = torch.randn(lead + (S, D_out), **kw)
    else:
        omega_raw = noise['omega']
        phase_u = noise['phase_u']
        weights = noise['weights']
    omega = omega_raw / ls.T[:, None, :]
    phase = phase_u * (2.0 * math.pi)
    return RFFState(omega=omega, phase=phase, weights=weights)


def rbf_rff_eval(p: RBFParams, rff: RFFState, x):
    """Evaluate the RFF prior draw(s) at x: (..., N, D_in) -> (..., N, D_out).

    phi(x) = cos(x @ omega + phase) * sqrt(var / S);  f = phi @ w

    Parity quirk kept from the reference: with cos-only features and a
    uniform phase this scaling gives a prior covariance of K/2, not K.
    """
    var = rbf_variance(p)
    D_in, S, K = rff.omega.shape[-3:]
    xo = x @ rff.omega.reshape(rff.omega.shape[:-3] + (D_in, S * K))
    xo = xo.reshape(xo.shape[:-1] + (S, K))             # (..., N, S, K)
    phi = torch.cos(xo + rff.phase) * torch.sqrt(var / S)
    return torch.sum(phi * rff.weights[..., None, :, :], dim=-2)


def rbf_compute_nu(p: RBFParams, Ku, u_prior, u):
    """Pathwise-update coefficients nu = K(Z,Z)^{-1}(u - f(Z)), whitened
    form with the reference's order of operations:
        a  = L^{-1} f(Z);   nu = L^{-T} (u - a)

    Ku (D_out, M, M) does not depend on the draw, so its Cholesky factor
    is computed once and the triangular solves broadcast over the draws'
    batch dims. Returns (..., D_out, M, 1).
    """
    M = Ku.shape[-1]
    eye = torch.eye(M, dtype=Ku.dtype, device=Ku.device)
    Lu = cholesky(Ku + eye * JITTER)
    up = u_prior.transpose(-1, -2)[..., None]         # (..., D, M, 1)
    uu = u.transpose(-1, -2)[..., None]
    a = solve_triangular(Lu, up, lower=True)
    return solve_triangular(Lu.transpose(-1, -2), uu - a, lower=False)


def rbf_f_update(p: RBFParams, nu, x, Z):
    """Pathwise update K(x, Z) nu -> (..., N, D_out)."""
    Kuf = rbf_gram(p, Z, x)                           # (..., D, M, N)
    f = nu.transpose(-1, -2) @ Kuf                    # (..., D, 1, N)
    return f[..., 0, :].transpose(-1, -2)
