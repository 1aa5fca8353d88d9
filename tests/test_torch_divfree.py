"""Parity of the port's divergence-free kernel (kernels.divfree) with the
JAX package, on the CPU at small sizes (D=3, S=16-33, M=8-13, N=5-7).

The same numpy inputs and raw noise go to both packages. Tolerances:
every function 1e-6 elementwise (f32 products and sums of a few terms in
another order); nu, and what is computed from it, 1e-5 of its largest
entry (a Cholesky solve of a jittered (M*D, M*D) gram).

The DF gram is a valid (positive definite) kernel for a common
lengthscale; with lengthscales and variances that differ by output-dim
pair it need not be (random (D, D) lengthscales in 0.5..1.2 made it
indefinite for about half of the inducing sets tried, in both packages).
So the functions that factor the gram get lengthscales within 2% of one
value in 0.5..1.2; the others take independent lengthscales.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vae_gp_ode_tpu.kernels import divfree as jdf
from vae_gp_ode_tpu.kernels import rbf as jrbf

from vae_gp_ode_tpu_torch.core.transforms import invsoftplus
from vae_gp_ode_tpu_torch.kernels import divfree as tdf
from vae_gp_ode_tpu_torch.kernels import rbf as trbf
import torch_threads  # noqa: F401

D, S, M, N, L = 3, 16, 8, 5, 2
TIGHT = dict(rtol=1e-6, atol=1e-6)
NU_TOL = 1e-5


def _kernel_pair(rng, common=False):
    """The same dimwise kernel parameters in both packages: independent
    lengthscales in 0.5..1.2 and variances in 0.3..1, or with `common`
    lengthscales and variances within 2% of one value each."""
    if common:
        ls = rng.uniform(0.5, 1.2) * (1 + 0.02 * rng.uniform(-1, 1, (D, D)))
        var = rng.uniform(0.3, 1.0) * (1 + 0.02 * rng.uniform(-1, 1, D))
    else:
        ls = rng.uniform(0.5, 1.2, (D, D))
        var = rng.uniform(0.3, 1.0, D)
    uls = invsoftplus(torch.as_tensor(ls, dtype=torch.float32))
    uvar = invsoftplus(torch.as_tensor(var, dtype=torch.float32))
    return (jrbf.RBFParams(jnp.asarray(uls.numpy()), jnp.asarray(uvar.numpy())),
            trbf.RBFParams(uls, uvar))


def _noise(rng, lead=(), s=S):
    f = np.float32
    return {'omega': rng.standard_normal(lead + (D, s, D)).astype(f),
            'phase_u': rng.random(lead + (1, s, D)).astype(f),
            'weights': rng.standard_normal(lead + (2 * s, D)).astype(f)}


def _rff_pair(jk, tk, noise, s=S):
    jr = jdf.df_sample_rff(jk, None, s, D, D,
                           noise={k: jnp.asarray(v) for k, v in noise.items()})
    tr = tdf.df_sample_rff(tk, None, s, D, D,
                           noise={k: torch.as_tensor(v)
                                  for k, v in noise.items()})
    return jr, tr


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a)
                                          else a), np.asarray(b),
                               **(tol or TIGHT))


def test_gram_and_its_diagonal_match():
    rng = np.random.default_rng(0)
    jk, tk = _kernel_pair(rng)
    X = rng.standard_normal((N, D)).astype(np.float32)
    X2 = rng.standard_normal((M, D)).astype(np.float32)
    _close(tdf.df_gram(tk, torch.as_tensor(X)), jdf.df_gram(jk, X))
    _close(tdf.df_gram(tk, torch.as_tensor(X), torch.as_tensor(X2)),
           jdf.df_gram(jk, X, X2))
    _close(tdf.df_gram_diag(tk, torch.as_tensor(X)),
           jdf.df_gram_diag(jk, X))
    np.testing.assert_allclose(
        tdf.df_gram_diag(tk, torch.as_tensor(X)).numpy(),
        np.diagonal(tdf.df_gram(tk, torch.as_tensor(X)).numpy()), rtol=1e-6)


@pytest.mark.parametrize('s', [16, 33])
def test_rff_draw_B_and_contraction_match(s):
    """df_sample_rff, df_orff_B (the JAX index order: |w| per (feature,
    output column), w w^T over the transposes) and df_orff_contraction;
    a batch of L draws against the JAX function per draw."""
    rng = np.random.default_rng(s)
    jk, tk = _kernel_pair(rng)
    noise = _noise(rng, (L,), s)
    tr = tdf.df_sample_rff(tk, None, s, D, D, noise={
        k: torch.as_tensor(v) for k, v in noise.items()})
    tB = tdf.df_orff_B(tr)
    tG = tdf.df_orff_contraction(tk, tr)
    assert tB.shape == (L, 2 * s, D, D) and tG.shape == (L, 2 * s * D, D)
    for l in range(L):
        jr, _ = _rff_pair(jk, tk, {k: v[l] for k, v in noise.items()}, s)
        for a, b in zip((tr.omega[l], tr.phase[l], tr.weights[l]),
                        (jr.omega, jr.phase, jr.weights)):
            _close(a, b)
        _close(tB[l], jdf.df_orff_B(jr))
        _close(tG[l], jdf.df_orff_contraction(jk, jr))


def test_rff_eval_with_and_without_G_matches():
    rng = np.random.default_rng(2)
    jk, tk = _kernel_pair(rng)
    noise = _noise(rng, (L,))
    tr = tdf.df_sample_rff(tk, None, S, D, D, noise={
        k: torch.as_tensor(v) for k, v in noise.items()})
    tG = tdf.df_orff_contraction(tk, tr)
    x = rng.standard_normal((L, N, D)).astype(np.float32)
    with_G = tdf.df_rff_eval(tk, tr, torch.as_tensor(x), G=tG)
    direct = tdf.df_rff_eval(tk, tr, torch.as_tensor(x))
    for l in range(L):
        jr, _ = _rff_pair(jk, tk, {k: v[l] for k, v in noise.items()})
        jG = jdf.df_orff_contraction(jk, jr)
        _close(with_G[l], jdf.df_rff_eval(jk, jr, x[l], G=jG))
        _close(direct[l], jdf.df_rff_eval(jk, jr, x[l]))
    # the two forms are one function (associativity only)
    np.testing.assert_allclose(with_G.numpy(), direct.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('m', [8, 13])
def test_nu_and_update_match(m):
    """df_compute_nu (one (M*D, M*D) factor shared by the draws; nu
    points-major) and df_f_update, against the JAX functions per draw."""
    rng = np.random.default_rng(m)
    jk, tk = _kernel_pair(rng, common=True)
    Z = rng.standard_normal((m, D)).astype(np.float32)
    noise = _noise(rng, (L,))
    u = rng.standard_normal((L, m, D)).astype(np.float32) * 0.3
    x = rng.standard_normal((L, N, D)).astype(np.float32)
    tr = tdf.df_sample_rff(tk, None, S, D, D, noise={
        k: torch.as_tensor(v) for k, v in noise.items()})
    tZ = torch.as_tensor(Z)
    tKu = tdf.df_gram(tk, tZ)
    t_up = tdf.df_rff_eval(tk, tr, tZ, G=tdf.df_orff_contraction(tk, tr))
    tnu = tdf.df_compute_nu(tk, tKu, t_up, torch.as_tensor(u))
    tf = tdf.df_f_update(tk, tnu, torch.as_tensor(x), tZ)
    assert tnu.shape == (L, m * D, 1) and tf.shape == (L, N, D)
    for l in range(L):
        jr, _ = _rff_pair(jk, tk, {k: v[l] for k, v in noise.items()})
        j_up = jdf.df_rff_eval(jk, jr, Z, G=jdf.df_orff_contraction(jk, jr))
        jnu = jdf.df_compute_nu(jk, jdf.df_gram(jk, Z), j_up, u[l])
        ref = np.array(jnu)
        np.testing.assert_allclose(tnu[l].numpy(), ref, rtol=NU_TOL,
                                   atol=NU_TOL * np.abs(ref).max())
        # the update from the same nu isolates df_f_update: a sum over M*D
        # terms of nu, held like nu
        jf = np.asarray(jdf.df_f_update(jk, jnu, x[l], Z))
        for got in (tdf.df_f_update(tk, torch.as_tensor(ref),
                                    torch.as_tensor(x[l]), tZ), tf[l]):
            np.testing.assert_allclose(got.numpy(), jf, rtol=NU_TOL,
                                       atol=NU_TOL * np.abs(jf).max())
