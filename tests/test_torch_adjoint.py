"""Parity of the port's continuous adjoint (dynamics.adjoint) with the JAX
package, on the CPU at small sizes (q=3, S=16, M=8, N=4, T=5, L=2 draws).

The same GP leaves and raw noise go to both packages; the gradient of a
fixed random functional of the trajectories with respect to z0 and every
GP leaf (lengthscales, variance, inducing locations, Um, Us_sqrt) through
`flow_forward_adjoint` is compared, per draw in JAX and as one batch of
draws in the port. Tolerance 1e-4 of each leaf's largest gradient: f32
through the backward solve of the augmented system, whose sums the two
packages take in different orders. The adaptive solvers run at
rtol = atol = 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_gp_ode_tpu.dynamics import adjoint as jadj
from vae_gp_ode_tpu.gp import svgp as jsvgp
from vae_gp_ode_tpu.kernels import rbf as jrbf

from vae_gp_ode_tpu_torch import ops
from vae_gp_ode_tpu_torch.dynamics import adjoint as tadj
from vae_gp_ode_tpu_torch.dynamics import flow as tflow
from vae_gp_ode_tpu_torch.gp import svgp as tsvgp
from vae_gp_ode_tpu_torch.utils.jax_import import gp_from_jax
import torch_threads  # noqa: F401

Q, S, M, N, T, L = 3, 16, 8, 4, 5, 2
GRAD_REL = 1e-4
TOLS = dict(rtol=1e-5, atol=1e-5)


def _case(seed, order):
    rng = np.random.default_rng(seed)
    D = Q * order
    leaves = {'kernel': {
        'unconstrained_lengthscales':
            rng.uniform(0.0, 1.0, (Q, D)).astype(np.float32),
        'unconstrained_variance':
            rng.uniform(-1.0, 0.0, (Q,)).astype(np.float32)},
        'inducing_loc': rng.standard_normal((M, D)).astype(np.float32),
        'Um': (rng.standard_normal((M, Q)) * 0.3).astype(np.float32),
        'Us_sqrt': np.asarray(jsvgp.init_svgp_params(
            jax.random.PRNGKey(0), D, Q, M).Us_sqrt)}
    jgp = jsvgp.SVGPParams(
        kernel=jrbf.RBFParams(*(jnp.asarray(leaves['kernel'][k]) for k in (
            'unconstrained_lengthscales', 'unconstrained_variance'))),
        inducing_loc=jnp.asarray(leaves['inducing_loc']),
        Um=jnp.asarray(leaves['Um']), Us_sqrt=jnp.asarray(leaves['Us_sqrt']))
    noise = {'omega': rng.standard_normal((L, D, S, Q)),
             'phase_u': rng.random((L, 1, S, Q)),
             'weights': rng.standard_normal((L, S, Q)),
             'epsilon': rng.standard_normal((L, M, Q))}
    noise = {k: v.astype(np.float32) for k, v in noise.items()}
    z0 = (rng.standard_normal((N, D)) * 0.5).astype(np.float32)
    w = rng.standard_normal((L, N, T, D)).astype(np.float32)
    return jgp, gp_from_jax(leaves), noise, z0, w


def _jax_grads(jgp, noise, z0, w, ts, order, solver, dense):
    def loss(gp, z0):
        tot = 0.0
        for l in range(L):
            s = jsvgp.draw_fn_sample(gp, None, S, noise={
                k: jnp.asarray(v[l]) for k, v in noise.items()})
            zs, _ = jadj.flow_forward_adjoint(
                gp, s, z0, jnp.asarray(ts), order=order, solver=solver,
                dense=dense, **TOLS)
            tot = tot + jnp.sum(zs * w[l])
        return tot
    gp_bar, z0_bar = jax.grad(loss, argnums=(0, 1))(jgp, jnp.asarray(z0))
    return [np.asarray(z0_bar)] + [np.asarray(x) for x in (
        gp_bar.kernel.unconstrained_lengthscales,
        gp_bar.kernel.unconstrained_variance, gp_bar.inducing_loc,
        gp_bar.Um, gp_bar.Us_sqrt)]


def _port(tgp, noise, z0, w, ts, order, solver, dense, adjoint=True,
          **kw):
    gp = tgp.detach().requires_grad_()
    z = torch.as_tensor(z0).requires_grad_()
    sample = tsvgp.draw_fn_sample(gp, None, S, noise={
        k: torch.as_tensor(v) for k, v in noise.items()})
    fwd = tadj.flow_forward_adjoint if adjoint else tflow.flow_forward
    zs, nfe = fwd(gp, sample, z, torch.as_tensor(ts), order=order,
                  solver=solver, dense=dense, device='cpu', **TOLS, **kw)
    loss = (zs * torch.as_tensor(w)).sum()
    grads = torch.autograd.grad(loss, [z] + gp.parameters())
    return zs.detach(), nfe, [g.numpy() for g in grads]


def _assert_grads(mine, ref, rel=GRAD_REL):
    names = ('z0',) + tsvgp.SVGPParams.LEAVES
    for name, a, b in zip(names, mine, ref):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        err = np.abs(a - b).max()
        tol = rel * max(np.abs(b).max(), 1e-30)
        assert err <= tol, f'{name}: max err {err:.3e} > {tol:.3e}'


@pytest.mark.parametrize('solver,order,dense', [
    ('euler', 1, 1), ('euler', 1, 2), ('rk4', 1, 1), ('rk4', 2, 1),
    ('bdf', 1, 1), ('dopri5', 1, 1)])
def test_adjoint_gradients_match_jax(solver, order, dense):
    jgp, tgp, noise, z0, w = _case(10 * order + dense, order)
    ts = (0.1 * np.arange(T)).astype(np.float32)
    before = dict(ops.LAUNCHES)
    zs, nfe, mine = _port(tgp, noise, z0, w, ts, order, solver, dense)
    assert ops.LAUNCHES == before           # CPU tensors: plain versions
    assert zs.shape == (L, N, T, Q * order)
    _assert_grads(mine, _jax_grads(jgp, noise, z0, w, ts, order, solver,
                                   dense))
    # the forward is the solve of flow_forward (an adaptive solve's steps
    # follow the rounding of its error norms, which the two RHS
    # compositions round differently: values to its tolerance)
    ref, ref_nfe, _ = _port(tgp, noise, z0, w, ts, order, solver, dense,
                            adjoint=False)
    if solver == 'dopri5':
        np.testing.assert_allclose(zs.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-4)
    else:
        np.testing.assert_allclose(zs.numpy(), ref.numpy(), rtol=1e-6,
                                   atol=1e-6)
        assert int(nfe) == int(ref_nfe)


@pytest.mark.parametrize('solver', ['rk4', 'adams'])
def test_adjoint_matches_backprop(solver):
    """The continuous adjoint and reverse mode through the solve agree to
    the solver's accuracy (rk4 at dt/2 substeps, adams at 1e-5)."""
    _, tgp, noise, z0, w = _case(40, 1)
    ts = (0.1 * np.arange(T)).astype(np.float32)
    _, _, adj = _port(tgp, noise, z0, w, ts, 1, solver, 2)
    _, _, bp = _port(tgp, noise, z0, w, ts, 1, solver, 2, adjoint=False)
    _assert_grads(adj, bp, rel=1e-3)


def test_adjoint_ts_gradient_is_zero_and_theta_is_per_draw():
    """ts gets a zero cotangent; each draw's parameter cotangent comes out
    per draw (summed over the draws by the expand of the shared leaves)."""
    _, tgp, noise, z0, _ = _case(50, 1)
    ts = torch.as_tensor((0.1 * np.arange(T)).astype(np.float32))

    def f(th, t, z):
        return th[0][:, None, :] * z

    theta = (torch.ones(L, Q).requires_grad_(),)
    tsr = ts.clone().requires_grad_()
    z = torch.as_tensor(np.stack([z0] * L))
    zs, nfe = tadj.odeint_adjoint(f, theta, z, tsr, method='rk4')
    g_theta, g_ts = torch.autograd.grad(zs.sum(), [theta[0], tsr])
    assert torch.equal(g_ts, torch.zeros_like(ts))
    assert g_theta.shape == (L, Q) and nfe == L * (T - 1) * 4
    # dz/dt = a z: d/da sum_t z(t) = sum_t t z0 exp(a t) per draw
    want = (ts[:, None, None] * torch.as_tensor(z0)[None] * torch.exp(
        ts)[:, None, None]).sum(dim=(0, 1))
    torch.testing.assert_close(g_theta[0], want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match='unknown solver'):
        tadj.odeint_adjoint(f, theta, z, ts, method='rk45')
