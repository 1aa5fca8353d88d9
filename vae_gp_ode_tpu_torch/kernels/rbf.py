"""Squared-exponential (RBF) kernel as functions over a params dataclass
(port of `vae_gp_ode_tpu/kernels/rbf.py`).

Two layouts, told apart by the lengthscales' rank (`RBFParams.dimwise`):
the dimwise kernel (per-output-dim lengthscales and variances, the main
configuration's) and the shared one (one lengthscale vector and one
variance for every output dim, `--dimwise False`).

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
    """Unconstrained kernel hyperparameters.

    dimwise: lengthscales (D_out, D_in), variance (D_out,)
    shared:  lengthscales (D_in,),       variance (1,)
    """

    unconstrained_lengthscales: torch.Tensor
    unconstrained_variance: torch.Tensor

    @property
    def dimwise(self):
        """The layout, read from the lengthscales' rank, so that leaves
        and layout cannot disagree."""
        return self.unconstrained_lengthscales.dim() == 2

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

    omega:   (..., D_in, S, D_out) dimwise, (..., D_in, S) shared
    phase:   (..., 1, S, D_out)    dimwise, (..., 1, S) shared
    weights: (..., S, D_out)  [the DF kernel's: (..., 2S, D_out)]
    """

    omega: torch.Tensor
    phase: torch.Tensor
    weights: torch.Tensor


def init_rbf_params(D_in, D_out=None, dimwise=True, lengthscale=0.2,
                    variance=0.1, dtype=torch.float32, device='cpu'):
    """Constant-initialised params of either layout."""
    D_out = D_in if D_out is None else D_out
    ls = invsoftplus(torch.tensor(lengthscale, dtype=dtype))
    var = invsoftplus(torch.tensor(variance, dtype=dtype))
    return RBFParams(
        unconstrained_lengthscales=torch.full(
            (D_out, D_in) if dimwise else (D_in,), float(ls), dtype=dtype,
            device=device),
        unconstrained_variance=torch.full(
            (D_out,) if dimwise else (1,), float(var), dtype=dtype,
            device=device))


def rbf_lengthscales(p: RBFParams):
    return softplus(p.unconstrained_lengthscales)


def rbf_variance(p: RBFParams):
    return softplus(p.unconstrained_variance)


def _sqdist_shared(X, X2, ls):
    """Scaled squared distance, shared lengthscales -> (..., N, M)."""
    Xs = X / ls
    X2s = Xs if X2 is None else X2 / ls
    xn = torch.sum(Xs * Xs, dim=-1)
    x2n = xn if X2 is None else torch.sum(X2s * X2s, dim=-1)
    cross = Xs @ X2s.transpose(-1, -2)
    return -2.0 * cross + xn[..., :, None] + x2n[..., None, :]


def _sqdist_dimwise(X, X2, ls):
    """Scaled squared distance per output dim -> (..., D_out, N, M)."""
    Xd = X[..., None, :, :] / ls[:, None, :]          # (..., D, N, D_in)
    X2d = Xd if X2 is None else X2[..., None, :, :] / ls[:, None, :]
    xn = torch.sum(Xd * Xd, dim=-1)                   # (..., D, N)
    x2n = xn if X2 is None else torch.sum(X2d * X2d, dim=-1)
    cross = Xd @ X2d.transpose(-1, -2)
    return -2.0 * cross + xn[..., :, None] + x2n[..., None, :]


def rbf_gram(p: RBFParams, X, X2=None):
    """K(X, X2): (..., D_out, N, M) dimwise, (..., N, M) shared."""
    var = rbf_variance(p)
    if p.dimwise:
        return var[:, None, None] * torch.exp(
            -0.5 * _sqdist_dimwise(X, X2, rbf_lengthscales(p)))
    return var * torch.exp(-0.5 * _sqdist_shared(X, X2, rbf_lengthscales(p)))


def rbf_sample_rff(p: RBFParams, generator, S, D_in, D_out,
                   noise: Optional[dict] = None, L=None) -> RFFState:
    """Draw RFF parameters: omega ~ N(0, diag(1/ls^2)), phase ~ U[0, 2pi),
    weights ~ N(0, I).

    `noise` injects the raw draws {omega, phase_u, weights} (their leading
    dims, if any, are the batch of draws); otherwise `generator` draws
    them, with a leading batch of `L` draws when `L` is given.
    """
    ls = rbf_lengthscales(p)
    per_dim = (D_out,) if p.dimwise else ()
    if noise is None:
        lead = () if L is None else (L,)
        kw = dict(generator=generator, dtype=ls.dtype, device=ls.device)
        omega_raw = torch.randn(lead + (D_in, S) + per_dim, **kw)
        phase_u = torch.rand(lead + (1, S) + per_dim, **kw)
        weights = torch.randn(lead + (S, D_out), **kw)
    else:
        omega_raw = noise['omega']
        phase_u = noise['phase_u']
        weights = noise['weights']
    omega = omega_raw / (ls.T[:, None, :] if p.dimwise else ls[:, None])
    phase = phase_u * (2.0 * math.pi)
    return RFFState(omega=omega, phase=phase, weights=weights)


def rbf_rff_eval(p: RBFParams, rff: RFFState, x):
    """Evaluate the RFF prior draw(s) at x: (..., N, D_in) -> (..., N, D_out).

    phi(x) = cos(x @ omega + phase) * sqrt(var / S);  f = phi @ w

    Parity quirk kept from the reference: with cos-only features and a
    uniform phase this scaling gives a prior covariance of K/2, not K.
    """
    var = rbf_variance(p)
    if not p.dimwise:
        S = rff.omega.shape[-1]
        phi = torch.cos(x @ rff.omega + rff.phase) * torch.sqrt(var / S)
        return phi @ rff.weights
    D_in, S, K = rff.omega.shape[-3:]
    xo = x @ rff.omega.reshape(rff.omega.shape[:-3] + (D_in, S * K))
    xo = xo.reshape(xo.shape[:-1] + (S, K))             # (..., N, S, K)
    phi = torch.cos(xo + rff.phase) * torch.sqrt(var / S)
    return torch.sum(phi * rff.weights[..., None, :, :], dim=-2)


def rbf_compute_nu(p: RBFParams, Ku, u_prior, u):
    """Pathwise-update coefficients nu = K(Z,Z)^{-1}(u - f(Z)), whitened
    form with the reference's order of operations:
        a  = L^{-1} f(Z);   nu = L^{-T} (u - a)

    Ku (D_out, M, M) dimwise or (M, M) shared does not depend on the
    draw, so its Cholesky factor is computed once and the triangular
    solves broadcast over the draws' batch dims. Returns (..., D_out, M,
    1) dimwise, (..., M, D_out) shared.
    """
    M = Ku.shape[-1]
    eye = torch.eye(M, dtype=Ku.dtype, device=Ku.device)
    Lu = cholesky(Ku + eye * JITTER)
    if not p.dimwise:
        a = solve_triangular(Lu, u_prior, lower=True)
        return solve_triangular(Lu.transpose(-1, -2), u - a, lower=False)
    up = u_prior.transpose(-1, -2)[..., None]         # (..., D, M, 1)
    uu = u.transpose(-1, -2)[..., None]
    a = solve_triangular(Lu, up, lower=True)
    return solve_triangular(Lu.transpose(-1, -2), uu - a, lower=False)


def rbf_f_update(p: RBFParams, nu, x, Z):
    """Pathwise update K(x, Z) nu -> (..., N, D_out)."""
    if not p.dimwise:
        Kuf = rbf_gram(p, Z, x)                       # (..., M, N)
        return Kuf.transpose(-1, -2) @ nu             # (..., N, D)
    Kuf = rbf_gram(p, Z, x)                           # (..., D, M, N)
    f = nu.transpose(-1, -2) @ Kuf                    # (..., D, 1, N)
    return f[..., 0, :].transpose(-1, -2)
