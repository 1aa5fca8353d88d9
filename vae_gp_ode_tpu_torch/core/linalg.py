"""The dense linear algebra the RBF pathwise update needs (port of the
native path of `vae_gp_ode_tpu/core/linalg.py`).

The JAX module's portable-lowering mode works around a JAX export bug and
has no counterpart here. `cholesky` uses `cholesky_ex`, which neither
raises nor synchronises with the host on a non-positive-definite input.
"""

import torch


def cholesky(A):
    """Lower Cholesky factor, batched over leading dims."""
    L, _ = torch.linalg.cholesky_ex(A)
    return L


def solve_triangular(T, b, lower=True):
    """Solve T x = b for triangular T; batch dims broadcast."""
    return torch.linalg.solve_triangular(T, b, upper=not lower)
