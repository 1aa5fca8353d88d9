"""Parity of the PyTorch port's core, RBF kernel and SVGP modules with the
JAX package, on the CPU at small sizes.

The same numpy inputs and raw noise go to both packages (the
`noise=` / `epsilon=` hooks), and the outputs are compared:
transforms and RBF functions to 1e-6 elementwise; the pathwise
coefficients nu, and what is computed from them, to 1e-5 of the largest
entry (they come out of a Cholesky solve of a jittered M x M gram, whose
conditioning amplifies f32 rounding differences in small entries).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vae_gp_ode_tpu.core import transforms as jtr
from vae_gp_ode_tpu.gp import svgp as jsvgp
from vae_gp_ode_tpu.kernels import rbf as jrbf
from vae_gp_ode_tpu.dynamics import flow as jflow

from vae_gp_ode_tpu_torch.core import transforms as ttr
from vae_gp_ode_tpu_torch.gp import svgp as tsvgp
from vae_gp_ode_tpu_torch.kernels import rbf as trbf
from vae_gp_ode_tpu_torch.dynamics import flow as tflow
from vae_gp_ode_tpu_torch.utils.jax_import import gp_from_jax
import torch_threads  # noqa: F401

Q, S, M, N, L = 3, 32, 16, 5, 2
TIGHT = dict(rtol=1e-6, atol=1e-6)    # elementwise and small reductions
NU_TOL = 1e-5                         # through the Cholesky solve


def _np(x):
    return np.asarray(x)


def assert_close_scaled(actual, desired, tol=NU_TOL):
    """|actual - desired| <= tol * (|desired| + max|desired|)."""
    desired = _np(desired)
    np.testing.assert_allclose(_np(actual), desired, rtol=tol,
                               atol=tol * float(np.abs(desired).max()))


def _gp_pair(rng, D_in=Q, D_out=Q, q_diag=False):
    """The same random SVGP in both packages (lengthscales 0.5..1.2,
    variances 0.3..1, a random full-rank q(u) scale).

    The lengthscales keep the jittered M x M gram's condition number near
    1e3 or below. At 1e4 and more (lengthscales of 2 over 16 points in
    3-D) both packages' f32 solves land ~5e-5 from an f64 solution, about
    as far from each other as from it (measured on the CPU), which is
    f32 conditioning and not a difference between the packages."""
    ls = rng.uniform(0.5, 1.2, (D_out, D_in)).astype(np.float32)
    var = rng.uniform(0.3, 1.0, (D_out,)).astype(np.float32)
    if q_diag:
        Us = rng.standard_normal((M, D_out)).astype(np.float32)
    else:
        tril = np.tril(rng.standard_normal((D_out, M, M)) * 0.1)
        tril += np.eye(M) * rng.uniform(0.2, 1.0, (D_out, 1, M))
        Us = np.asarray(jtr.pack_tril(jnp.asarray(tril.astype(np.float32))))
    leaves = {
        'kernel': {'unconstrained_lengthscales':
                   _np(jtr.invsoftplus(jnp.asarray(ls))),
                   'unconstrained_variance':
                   _np(jtr.invsoftplus(jnp.asarray(var)))},
        'inducing_loc': rng.standard_normal((M, D_in)).astype(np.float32),
        'Um': (rng.standard_normal((M, D_out)) * 0.3).astype(np.float32),
        'Us_sqrt': Us,
    }
    jgp = jsvgp.SVGPParams(
        kernel=jrbf.RBFParams(
            unconstrained_lengthscales=jnp.asarray(
                leaves['kernel']['unconstrained_lengthscales']),
            unconstrained_variance=jnp.asarray(
                leaves['kernel']['unconstrained_variance'])),
        inducing_loc=jnp.asarray(leaves['inducing_loc']),
        Um=jnp.asarray(leaves['Um']), Us_sqrt=jnp.asarray(Us),
        q_diag=q_diag)
    tgp = gp_from_jax(leaves)
    assert tgp.q_diag == q_diag
    return jgp, tgp


def _noise(rng, D_in, D_out, lead=()):
    f = np.float32
    return {'omega': rng.standard_normal(lead + (D_in, S, D_out)).astype(f),
            'phase_u': rng.random(lead + (1, S, D_out)).astype(f),
            'weights': rng.standard_normal(lead + (S, D_out)).astype(f),
            'epsilon': rng.standard_normal(lead + (M, D_out)).astype(f)}


def _t(noise):
    return {k: torch.as_tensor(v) for k, v in noise.items()}


def _j(noise):
    return {k: jnp.asarray(v) for k, v in noise.items()}


def test_transforms_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(64).astype(np.float32) * 8
    np.testing.assert_allclose(
        ttr.softplus(torch.as_tensor(x)).numpy(), _np(jtr.softplus(x)),
        **TIGHT)
    y = rng.uniform(1e-3, 5.0, 64).astype(np.float32)
    np.testing.assert_allclose(
        ttr.invsoftplus(torch.as_tensor(y)).numpy(), _np(jtr.invsoftplus(y)),
        rtol=1e-5, atol=1e-6)     # log(-expm1(-y)) for small y: 1e-5 rel
    v = rng.standard_normal((2, 3, 10)).astype(np.float32)
    m = ttr.unpack_tril(torch.as_tensor(v), 4)
    np.testing.assert_array_equal(m.numpy(), _np(jtr.unpack_tril(v, 4)))
    np.testing.assert_array_equal(ttr.pack_tril(m).numpy(), v)


def test_rbf_functions_match():
    rng = np.random.default_rng(1)
    jgp, tgp = _gp_pair(rng)
    X = rng.standard_normal((N, Q)).astype(np.float32)
    Z = rng.standard_normal((M, Q)).astype(np.float32)
    np.testing.assert_allclose(
        trbf.rbf_lengthscales(tgp.kernel).numpy(),
        _np(jrbf.rbf_lengthscales(jgp.kernel)), **TIGHT)
    np.testing.assert_allclose(
        trbf.rbf_variance(tgp.kernel).numpy(),
        _np(jrbf.rbf_variance(jgp.kernel)), **TIGHT)
    for X2 in (None, Z):
        np.testing.assert_allclose(
            trbf.rbf_gram(tgp.kernel, torch.as_tensor(X),
                          None if X2 is None else torch.as_tensor(X2)
                          ).numpy(),
            _np(jrbf.rbf_gram(jgp.kernel, X, X2)), **TIGHT)
    nz = _noise(rng, Q, Q)
    jr = jrbf.rbf_sample_rff(jgp.kernel, None, S, Q, Q, noise=_j(nz))
    tr = trbf.rbf_sample_rff(tgp.kernel, None, S, Q, Q, noise=_t(nz))
    for a, b in ((tr.omega, jr.omega), (tr.phase, jr.phase),
                 (tr.weights, jr.weights)):
        np.testing.assert_allclose(a.numpy(), _np(b), **TIGHT)
    np.testing.assert_allclose(
        trbf.rbf_rff_eval(tgp.kernel, tr, torch.as_tensor(X)).numpy(),
        _np(jrbf.rbf_rff_eval(jgp.kernel, jr, X)), **TIGHT)
    nu = rng.standard_normal((Q, M, 1)).astype(np.float32)
    np.testing.assert_allclose(
        trbf.rbf_f_update(tgp.kernel, torch.as_tensor(nu),
                          torch.as_tensor(X), torch.as_tensor(Z)).numpy(),
        _np(jrbf.rbf_f_update(jgp.kernel, nu, X, Z)), **TIGHT)


@pytest.mark.parametrize('q_diag', [False, True])
def test_draw_fn_sample_nu_matches(q_diag):
    rng = np.random.default_rng(2)
    jgp, tgp = _gp_pair(rng, q_diag=q_diag)
    nz = _noise(rng, Q, Q)
    js = jsvgp.draw_fn_sample(jgp, None, S, noise=_j(nz))
    ts = tsvgp.draw_fn_sample(tgp, None, S, noise=_t(nz))
    assert_close_scaled(ts.nu.numpy(), js.nu)
    np.testing.assert_allclose(
        tsvgp.sample_inducing(tgp, epsilon=torch.as_tensor(
            nz['epsilon'])).numpy(),
        _np(jsvgp.sample_inducing(jgp, epsilon=nz['epsilon'])), **TIGHT)
    np.testing.assert_allclose(float(tsvgp.svgp_kl(tgp)),
                               float(jsvgp.svgp_kl(jgp)), rtol=1e-5)


def test_batched_draws_equal_single_draws():
    """A leading batch of L draws gives, draw by draw, what L single
    draws give (one batched Cholesky solve instead of a loop)."""
    rng = np.random.default_rng(3)
    jgp, tgp = _gp_pair(rng)
    nz = _noise(rng, Q, Q, lead=(L,))
    batched = tsvgp.draw_fn_sample(tgp, None, S, noise=_t(nz))
    assert batched.nu.shape == (L, Q, M, 1)
    X = torch.as_tensor(rng.standard_normal((N, Q)).astype(np.float32))
    fb = tsvgp.fn_eval(tgp, batched, X)
    assert fb.shape == (L, N, Q)
    for l in range(L):
        one = {k: v[l] for k, v in nz.items()}
        js = jsvgp.draw_fn_sample(jgp, None, S, noise=_j(one))
        assert_close_scaled(batched.nu[l].numpy(), js.nu)
        assert_close_scaled(fb[l].numpy(), jsvgp.fn_eval(jgp, js, X.numpy()))


@pytest.mark.parametrize('order', [1, 2])
def test_ode_rhs_matches(order):
    rng = np.random.default_rng(4)
    jgp, tgp = _gp_pair(rng, D_in=Q * order, D_out=Q)
    nz = _noise(rng, Q * order, Q)
    js = jsvgp.draw_fn_sample(jgp, None, S, noise=_j(nz))
    ts = tsvgp.draw_fn_sample(tgp, None, S, noise=_t(nz))
    z = rng.standard_normal((N, Q * order)).astype(np.float32)
    out = tflow.make_ode_rhs(tgp, ts, order)(0.0, torch.as_tensor(z))
    ref = jflow.make_ode_rhs(jgp, js, order)(0.0, jnp.asarray(z))
    assert_close_scaled(out.numpy(), ref)


def test_unported_kernels_and_bad_order_raise():
    rng = np.random.default_rng(5)
    # shared lengthscales are ported: their params build, dimwise False
    assert not trbf.RBFParams(torch.zeros(Q), torch.zeros(1)).dimwise
    with pytest.raises(ValueError):
        tsvgp.init_svgp_params(rng, Q, Q, M, kernel='nope')
    _, tgp = _gp_pair(rng)
    with pytest.raises(ValueError):
        tflow.make_ode_rhs(tgp, None, 3)


# -- a Cholesky that fails gives NaN, as in the JAX package ------------------

def test_failed_cholesky_gives_nan_in_both_packages():
    """A (2, 4, 4) gram whose second block is not positive definite: the
    JAX package's Cholesky is all NaN there, and so is the port's (the
    info of `cholesky_ex` masks it); the first block's factor and the nu
    computed through it agree."""
    from vae_gp_ode_tpu.core import linalg as jlinalg
    from vae_gp_ode_tpu_torch.core import linalg as tlinalg
    A = np.stack([np.eye(4) * 2.0 + 0.5,
                  [[1, 2, 0, 0], [2, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]]
                 ).astype(np.float32)
    mine = tlinalg.cholesky(torch.as_tensor(A)).numpy()
    ref = np.asarray(jlinalg.cholesky(jnp.asarray(A)))
    assert np.isnan(ref[1][np.tril_indices(4)]).all()
    np.testing.assert_array_equal(mine[1], ref[1])      # NaN where JAX's is
    np.testing.assert_allclose(mine[0], ref[0], **TIGHT)

    p = trbf.init_rbf_params(3, 2, lengthscale=0.8, variance=0.6)
    rng = np.random.default_rng(9)
    u_prior = rng.standard_normal((4, 2)).astype(np.float32)
    u = rng.standard_normal((4, 2)).astype(np.float32)
    jp = jrbf.init_rbf_params(3, 2, dimwise=True, lengthscale=0.8,
                              variance=0.6)
    nu = trbf.rbf_compute_nu(p, torch.as_tensor(A) - 1e-5 * torch.eye(4),
                             torch.as_tensor(u_prior), torch.as_tensor(u))
    jnu = jrbf.rbf_compute_nu(jp, jnp.asarray(A) - 1e-5 * jnp.eye(4),
                              jnp.asarray(u_prior), jnp.asarray(u))
    assert np.isnan(np.asarray(jnu)[1]).all() and torch.isnan(nu[1]).all()
    assert_close_scaled(nu[0], np.asarray(jnu)[0])


def _non_pd_gp(gp):
    """Every inducing point at the origin and kernel variances of 1e4 for
    output dims 1.. : their jittered grams var * ones + 1e-5 I round to the
    rank-one var * ones in f32, which both packages' Cholesky refuse."""
    with torch.no_grad():
        gp.inducing_loc.zero_()
        gp.kernel.unconstrained_variance[1:] = 1e4
    return gp


def test_train_step_with_a_failed_cholesky_is_discarded():
    """A train step whose GP draw meets a gram that is not positive
    definite: nu is NaN in both packages for those output dims, the loss
    is NaN, and the NaN guard leaves parameters, BatchNorm statistics,
    Adam's state and the step count as they were (the JAX package's
    guard)."""
    from vae_gp_ode_tpu_torch.models.odegpvae import init_model
    from vae_gp_ode_tpu_torch.training import trainer
    model, gp = init_model(0, latent_dim=Q, n_filt=4, num_features=S,
                           num_inducing=M, device='cpu')
    gp = _non_pd_gp(gp)
    state = trainer.create_train_state(model, gp)
    sample = tsvgp.draw_fn_sample(gp, torch.Generator().manual_seed(0), S,
                                  L=1)
    assert torch.isnan(sample.nu[:, 1:]).all()
    assert torch.isfinite(sample.nu[:, 0]).all()
    jgp = jsvgp.SVGPParams(
        kernel=jrbf.RBFParams(*(jnp.asarray(x.detach().numpy()) for x in (
            gp.kernel.unconstrained_lengthscales,
            gp.kernel.unconstrained_variance))),
        inducing_loc=jnp.asarray(gp.inducing_loc.detach().numpy()),
        Um=jnp.asarray(gp.Um.detach().numpy()),
        Us_sqrt=jnp.asarray(gp.Us_sqrt.detach().numpy()))
    js = jsvgp.draw_fn_sample(jgp, None, S, noise=_j(_noise(
        np.random.default_rng(1), Q, Q)))
    assert np.isnan(np.asarray(js.nu)[1:]).all()

    before = {n: p.detach().clone() for n, p in
              zip(state.param_names(), state.params())}
    buffers = {n: b.clone() for n, b in state.model.named_buffers()}
    X = torch.as_tensor(np.random.default_rng(2).random(
        (3, 5, 1, 28, 28)).astype(np.float32))
    metrics = trainer.make_train_step(360.0, eps_guard=True)(
        state, X, 1, torch.Generator().manual_seed(3))
    assert not torch.isfinite(metrics['loss'])
    for n, p in zip(state.param_names(), state.params()):
        assert torch.equal(p, before[n]), n
    for n, b in state.model.named_buffers():
        assert torch.equal(b, buffers[n]), n
    assert int(state.step) == 0 and int(state.optimizer.count) == 0
    assert not state.optimizer.mu.any()
