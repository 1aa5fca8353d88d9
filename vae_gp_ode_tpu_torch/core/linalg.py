"""The dense linear algebra of the port (port of the native path of
`vae_gp_ode_tpu/core/linalg.py`).

The JAX module's portable-lowering mode works around a JAX export bug and
has no counterpart here. Nothing here synchronises with the host:
`cholesky` uses `cholesky_ex` and `solve` uses `solve_ex`, which report
failures in a device tensor instead of raising.
"""

import torch


def cholesky(A):
    """Lower Cholesky factor of (A + A^T) / 2, batched over leading dims,
    as `jnp.linalg.cholesky` (which symmetrizes its input) computes it:
    the divergence-free gram is not symmetric (its lengthscales differ by
    output-dim pair), and factoring its lower triangle alone gives another
    factor. A batch entry that is not positive definite gives NaN on and
    below its diagonal, as `jnp.linalg.cholesky` does (`cholesky_ex` alone
    would return a finite partial factor), so a loss computed from it is
    NaN and a NaN guard discards the step."""
    L, info = torch.linalg.cholesky_ex((A + A.transpose(-1, -2)) / 2)
    return torch.where((info == 0)[..., None, None], L, float('nan')).tril()


def solve_triangular(T, b, lower=True):
    """Solve T x = b for triangular T; batch dims broadcast."""
    return torch.linalg.solve_triangular(T, b, upper=not lower)


def solve(A, b):
    """General square solve A x = b, batched like `jnp.linalg.solve`, plus
    the batched-vector form b (..., M) with A (..., M, M) (a stack of 1-D
    solves), as the JAX package's `solve` takes it. Used for the small
    (D, D) systems of the BDF solver's Newton step and of its adjoint."""
    if b.dim() == A.dim() - 1 and A.dim() > 2:
        return solve(A, b[..., None])[..., 0]
    return torch.linalg.solve_ex(A, b)[0]
