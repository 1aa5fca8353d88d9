"""Constrained <-> unconstrained parameter transforms (port of
`vae_gp_ode_tpu/core/transforms.py`)."""

import torch

from vae_gp_ode_tpu_torch.core.settings import SOFTPLUS_LOWER


def softplus(x):
    """Positive constraint: softplus(x) + 1e-12 (log(1 + e^x), exact for
    every x like `jax.nn.softplus`, without torch's linear threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x)) + SOFTPLUS_LOWER


def invsoftplus(y):
    """Inverse of :func:`softplus`."""
    y = torch.as_tensor(y)
    eps = torch.finfo(y.dtype).eps
    ys = torch.clamp(y - SOFTPLUS_LOWER, min=eps)
    return ys + torch.log(-torch.expm1(-ys))


def tril_indices(n, device=None):
    """Row/col indices of the lower triangle, `np.tril_indices` row-major
    order (the packing order of the reference and the JAX package), made
    on `device` (no copy from the host)."""
    rows, cols = torch.tril_indices(n, n, device=device)
    return rows, cols


def unpack_tril(v, n):
    """Unpack `(..., n(n+1)/2)` packed vectors into `(..., n, n)`
    lower-triangular matrices."""
    rows, cols = tril_indices(n, v.device)
    out = v.new_zeros(v.shape[:-1] + (n, n))
    out[..., rows, cols] = v
    return out


def pack_tril(m):
    """Pack `(..., n, n)` lower-triangular matrices into `(..., n(n+1)/2)`."""
    rows, cols = tril_indices(m.shape[-1], m.device)
    return m[..., rows, cols]
