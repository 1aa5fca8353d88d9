"""Sparse variational GP with decoupled pathwise posterior sampling (port
of `vae_gp_ode_tpu/gp/svgp.py`: the RBF kernel with dimwise or shared
lengthscales, and the divergence-free (DF) kernel).

  * whitened variational posterior q(u) = N(m, L L^T), full-Cholesky
    (packed lower-tri vectors) or diagonal,
  * `draw_fn_sample`: a pathwise posterior function sample, optionally a
    leading batch of L draws in one call,
  * closed-form whitened KL(q(u) || N(0, I)),
  * `svgp_conditional`: the exact conditional q(f(x)), for eval and
    diagnostics.

f(x) = Phi(x) w + K(x, Z) nu,  nu = K(Z,Z)^{-1}(u - f_prior(Z)).
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from vae_gp_ode_tpu_torch.core.linalg import cholesky, solve_triangular
from vae_gp_ode_tpu_torch.core.settings import JITTER
from vae_gp_ode_tpu_torch.core.transforms import (
    softplus, invsoftplus, unpack_tril, pack_tril,
)
from vae_gp_ode_tpu_torch.kernels import divfree as dfk
from vae_gp_ode_tpu_torch.kernels import rbf as rbfk
from vae_gp_ode_tpu_torch.ops import (
    df_pathwise, df_pathwise_tiled, pathwise, pathwise_tiled,
)

@dataclasses.dataclass
class SVGPParams:
    """SVGP state.

    kernel:        RBFParams, dimwise or shared (the DF kernel reuses the
                   dimwise layout)
    inducing_loc:  (M, D_in)
    Um:            (M, D_out) variational mean (whitened)
    Us_sqrt:       packed scale: (D_out, M(M+1)/2) full-Cholesky, or
                   (M, D_out) unconstrained diag (softplus-constrained)
    q_diag, kernel_name ('RBF' or 'DF'): static, not leaves
    """

    kernel: rbfk.RBFParams
    inducing_loc: torch.Tensor
    Um: torch.Tensor
    Us_sqrt: torch.Tensor
    q_diag: bool = False
    kernel_name: str = 'RBF'

    @property
    def M(self):
        return self.inducing_loc.shape[0]

    @property
    def D_in(self):
        return self.inducing_loc.shape[1]

    @property
    def D_out(self):
        return self.Um.shape[1]

    def to(self, device):
        return dataclasses.replace(
            self, kernel=self.kernel.to(device),
            inducing_loc=self.inducing_loc.to(device),
            Um=self.Um.to(device), Us_sqrt=self.Us_sqrt.to(device))

    #: leaf names in the JAX pytree's leaf order
    LEAVES = ('kernel.unconstrained_lengthscales',
              'kernel.unconstrained_variance', 'inducing_loc', 'Um',
              'Us_sqrt')

    def parameters(self):
        """The trainable leaves in the JAX pytree's leaf order (`LEAVES`),
        so optimiser and checkpoint order are fixed."""
        return [self.kernel.unconstrained_lengthscales,
                self.kernel.unconstrained_variance, self.inducing_loc,
                self.Um, self.Us_sqrt]

    def named_parameters(self):
        return list(zip(self.LEAVES, self.parameters()))

    def detach(self):
        """A copy whose leaves are detached clones (new leaf tensors)."""
        return dataclasses.replace(
            self, kernel=dataclasses.replace(
                self.kernel,
                unconstrained_lengthscales=(
                    self.kernel.unconstrained_lengthscales.detach().clone()),
                unconstrained_variance=(
                    self.kernel.unconstrained_variance.detach().clone())),
            inducing_loc=self.inducing_loc.detach().clone(),
            Um=self.Um.detach().clone(),
            Us_sqrt=self.Us_sqrt.detach().clone())

    def requires_grad_(self, requires_grad=True):
        """Set requires_grad on every leaf in place; returns self."""
        for p in self.parameters():
            p.requires_grad_(requires_grad)
        return self


@dataclasses.dataclass
class FnSample:
    """Pathwise posterior function sample(s): RFF draw + update
    coefficients nu, (..., D_out, M, 1) for the dimwise RBF kernel,
    (..., M, D_out) for the shared one and (..., M*D, 1) for DF; `...` is
    the batch of draws. df_G: the DF kernel's per-draw ORFF contraction
    (..., 2S*D, D), None for RBF."""

    rff: rbfk.RFFState
    nu: torch.Tensor
    df_G: Optional[torch.Tensor] = None

    @property
    def lead(self):
        """The batch of draws: () or (L,)."""
        return tuple(self.rff.weights.shape[:-2])


def init_svgp_params(rng, D_in, D_out, M, kernel='RBF', q_diag=False,
                     dimwise=True, lengthscale=0.2, variance=0.1,
                     dtype=torch.float32, device='cpu') -> SVGPParams:
    """Random initialisation at the reference's scales, drawn with the
    numpy Generator `rng`: inducing_loc ~ N(0,1), Um ~ N(0,1)*0.1,
    Us_sqrt = I*1e-3 (packed), or a softplus-1e-3 diagonal for q_diag.
    `dimwise` picks the RBF kernel's layout. The DF kernel takes the
    dimwise layout whatever `dimwise` says and needs D_in == D_out (its
    gram and B(w) are square), so 2nd-order ODEs need the RBF kernel."""
    if kernel not in ('RBF', 'DF'):
        raise ValueError(f'Invalid kernel selection: {kernel!r}')
    if kernel == 'DF' and D_in != D_out:
        raise ValueError(
            f'DF kernel requires D_in == D_out, got {D_in} != {D_out}')
    kern = rbfk.init_rbf_params(D_in, D_out,
                                dimwise=dimwise or kernel == 'DF',
                                lengthscale=lengthscale,
                                variance=variance, dtype=dtype,
                                device=device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    inducing_loc = t(rng.standard_normal((M, D_in)))
    Um = t(rng.standard_normal((M, D_out)) * 0.1)
    if q_diag:
        Us_sqrt = torch.full((M, D_out),
                             float(invsoftplus(torch.tensor(1e-3, dtype=dtype))),
                             dtype=dtype, device=device)
    else:
        eye = torch.eye(M, dtype=dtype, device=device) * 1e-3
        Us_sqrt = pack_tril(eye.expand(D_out, M, M))
    return SVGPParams(kernel=kern, inducing_loc=inducing_loc, Um=Um,
                      Us_sqrt=Us_sqrt, q_diag=q_diag, kernel_name=kernel)


def _scale_tril(p: SVGPParams):
    """Constrained scale of q(u): (D_out, M, M) lower-tri."""
    return unpack_tril(p.Us_sqrt, p.M)


def sample_inducing(p: SVGPParams, generator=None, epsilon=None, L=None):
    """Draw u ~ q(u) = N(m, L L^T) (whitened): (..., M, D_out).

    `epsilon` (..., M, D_out) injects the standard-normal draw; otherwise
    `generator` draws it, with a leading batch of `L` when `L` is given.
    """
    if epsilon is None:
        lead = () if L is None else (L,)
        epsilon = torch.randn(lead + (p.M, p.D_out), generator=generator,
                              dtype=p.Um.dtype, device=p.Um.device)
    if p.q_diag:
        ZS = softplus(p.Us_sqrt) * epsilon
    else:
        e = epsilon.transpose(-1, -2)[..., None]         # (..., D, M, 1)
        ZS = (_scale_tril(p) @ e)[..., 0].transpose(-1, -2)
    return ZS + p.Um


def draw_fn_sample(p: SVGPParams, generator, S,
                   noise: Optional[dict] = None, L=None) -> FnSample:
    """Draw pathwise posterior sample(s):

    1. RFF parameters (omega, phase, weights),
    2. u ~ q(u),
    3. nu = K(Z,Z)^{-1}(u - f_prior(Z)) via Cholesky + triangular solves
       (one factor shared by the draws: (D_out, M, M) for the dimwise
       RBF kernel, one (M, M) for the shared one, one (M*D, M*D) for DF).

    `noise` injects the raw draws {omega, phase_u, weights, epsilon}, whose
    leading dims (if any) batch the draws. Otherwise `generator` draws
    them: one sample, or a leading batch of `L` samples in one call.
    """
    eps = None if noise is None else noise['epsilon']
    Z = p.inducing_loc
    if p.kernel_name == 'DF':
        rff = dfk.df_sample_rff(p.kernel, generator, S, p.D_in, p.D_out,
                                noise=noise, L=L)
        G = dfk.df_orff_contraction(p.kernel, rff)
        u = sample_inducing(p, generator, epsilon=eps, L=L)
        Ku = dfk.df_gram(p.kernel, Z)
        u_prior = dfk.df_rff_eval(p.kernel, rff, Z, G=G)
        nu = dfk.df_compute_nu(p.kernel, Ku, u_prior, u)
        return FnSample(rff=rff, nu=nu, df_G=G)
    rff = rbfk.rbf_sample_rff(p.kernel, generator, S, p.D_in, p.D_out,
                              noise=noise, L=L)
    u = sample_inducing(p, generator, epsilon=eps, L=L)
    Ku = rbfk.rbf_gram(p.kernel, Z)
    u_prior = rbfk.rbf_rff_eval(p.kernel, rff, Z)
    nu = rbfk.rbf_compute_nu(p.kernel, Ku, u_prior, u)
    return FnSample(rff=rff, nu=nu)


def fn_eval(p: SVGPParams, s: FnSample, x):
    """Evaluate the sampled posterior function(s): prior + update.

    x (..., N, D_in) with the sample's batch of draws -> (..., N, D_out).
    On CUDA tensors the card's dispatch rule picks, from the shapes and
    before any launch, the forward kernel and the VJP kernel of the GP's
    kernel family: for RBF `ops.pathwise_tiled.pathwise_eval` chooses
    between the single-block pair (`csrc/pathwise_fwd.cu`,
    `csrc/pathwise_bwd.cu`) and the grid-tiled pair
    (`csrc/pathwise_tiled_fwd.cu`, `csrc/pathwise_tiled_bwd.cu`) by
    `use_tiled`; for DF `ops.df_pathwise_tiled.df_pathwise_eval` between
    `csrc/df_pathwise_fwd.cu` / `df_pathwise_bwd.cu` and
    `csrc/df_pathwise_tiled_fwd.cu` / `df_pathwise_tiled_bwd.cu` by
    `use_df_tiled`. On CPU tensors both take their plain versions. A
    shared-lengthscale RBF sample takes the same kernels, on the dimwise
    operand block that `ops.pathwise.rbf_fused_operands` broadcasts it to.
    """
    if p.kernel_name == 'DF':
        return df_pathwise_tiled.df_pathwise_eval(
            x, *df_pathwise.df_fused_operands(p, s))
    return pathwise_tiled.pathwise_eval(
        x, *pathwise.rbf_fused_operands(p, s))


def svgp_kl(p: SVGPParams):
    """Whitened KL(q(u) || N(0, I)) in closed form."""
    alpha = p.Um                                         # (M, D)
    if p.q_diag:
        Lq_diag = softplus(p.Us_sqrt)                    # (M, D)
        trace = torch.sum(Lq_diag ** 2, dim=0)           # (D,)
    else:
        Lq = _scale_tril(p)                              # (D, M, M)
        Lq_diag = torch.diagonal(Lq, dim1=1, dim2=2).T   # (M, D)
        trace = torch.sum(Lq ** 2, dim=(1, 2))           # (D,)
    mahalanobis = torch.sum(alpha ** 2, dim=0)           # (D,)
    logdet_qcov = torch.sum(torch.log(Lq_diag ** 2), dim=0)
    twoKL = -logdet_qcov + mahalanobis + trace - float(p.M)
    return 0.5 * torch.sum(twoKL)


def svgp_conditional(p: SVGPParams, x, full_cov=False):
    """Exact conditional q(f(x)) = N(m(x), Sigma(x)) at x (N, D_in), in
    the whitened form mean = A^T m, Sigma = Kff + A^T (S - I) A with
    A = Lu^{-1} Kuf and S = L L^T (a diagonal q(u): diag(s^2)).

    Returns (mean (N, D), var (N, D)), or with full_cov (mean, (D, N, N))
    for the RBF kernels; the DF kernel's full_cov covariance is the full
    (N*D, N*D) one (`_svgp_conditional_df`).
    """
    if p.kernel_name == 'DF':
        return _svgp_conditional_df(p, x, full_cov)
    dimwise = p.kernel.dimwise
    Z = p.inducing_loc
    Ku = rbfk.rbf_gram(p.kernel, Z)                       # (M,M) or (D,M,M)
    eye = torch.eye(p.M, dtype=Ku.dtype, device=Ku.device)
    Lu = cholesky(Ku + eye * JITTER)
    A = solve_triangular(Lu, rbfk.rbf_gram(p.kernel, Z, x), lower=True)
    if p.q_diag:
        s = softplus(p.Us_sqrt).T                         # (D, M)
        SK = torch.diag_embed(s * s) - eye                # (D, M, M)
    else:
        Ls = _scale_tril(p)                               # (D, M, M)
        SK = Ls @ Ls.transpose(-1, -2) - eye
    A_b = A if dimwise else A[None]                       # (D or 1, M, N)
    B = SK @ A_b                                          # (D, M, N)
    if full_cov:
        Kff = rbfk.rbf_gram(p.kernel, x)
        var = (Kff if dimwise else Kff[None]) + A_b.transpose(-1, -2) @ B
    else:
        # k(x, x) of the SE kernel is its variance
        var_k = rbfk.rbf_variance(p.kernel)               # (D,) or (1,)
        var = (var_k[:, None] + torch.sum(A_b * B, dim=1)).T
    mean = torch.einsum('dmn,md->nd' if dimwise else 'mn,md->nd', A, p.Um)
    return mean, var


def _svgp_conditional_df(p: SVGPParams, x, full_cov=False):
    """The exact conditional for the matrix-valued DF kernel: one
    (M*D, M*D) Cholesky solve, with q(u)'s covariance block-diagonal over
    output dims d (blocks L_d L_d^T) on the flattened inducing vector
    u[m*D + d], the layout of `df_gram`. Returns (mean (N, D), var (N,
    D)), the diagonal from `df_gram_diag`; with full_cov the full
    (N*D, N*D) covariance."""
    M, D = p.M, p.D_out
    MD, N = M * D, x.shape[0]
    Ku = dfk.df_gram(p.kernel, p.inducing_loc)           # (MD, MD)
    Lu = cholesky(Ku + torch.eye(MD, dtype=Ku.dtype, device=Ku.device)
                  * JITTER)
    A = solve_triangular(Lu, dfk.df_gram(p.kernel, p.inducing_loc, x),
                         lower=True)                     # (MD, N*D)
    if p.q_diag:
        s2 = (softplus(p.Us_sqrt) ** 2).reshape(MD)      # at m*D + d
        B = (s2 - 1.0)[:, None] * A                      # (S - I) A
    else:
        Ls = _scale_tril(p)                              # (D, M, M)
        Ad = A.reshape(M, D, -1).transpose(0, 1)         # (D, M, N*D)
        SdA = Ls @ (Ls.transpose(-1, -2) @ Ad)           # L_d L_d^T A_d
        B = (SdA - Ad).transpose(0, 1).reshape(MD, -1)
    mean = (A.T @ p.Um.reshape(MD)[:, None]).reshape(N, D)
    if full_cov:
        return mean, dfk.df_gram(p.kernel, x) + A.T @ B  # (ND, ND)
    var = dfk.df_gram_diag(p.kernel, x) + torch.sum(A * B, dim=0)
    return mean, var.reshape(N, D)
