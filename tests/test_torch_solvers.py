"""Parity of the port's ODE solvers (dynamics.solvers, and the flow through
them) with the JAX package, on the CPU at small sizes.

Every method integrates the same GP right-hand side (a pathwise sample,
N=4 states, q=3, S=16 features, M=8 inducing points) in both packages.
Tolerances: fixed-step solvers 1e-5 relative (plus 1e-6 absolute: f32
through 4-14 steps of O(1) states); the adaptive dopri5 and adams 1e-4
with equal nfe. The adaptive solves run at rtol 1e-6, atol 1e-2
(`ADAPTIVE_KW`): at atol = rtol = 1e-6 the error norm of the first step
is f32 rounding noise (z5 - z4 cancels to a few ulps of z), which differs
between XLA's fused arithmetic and PyTorch's, so the two packages' step
sequences drift apart and take different numbers of steps on about half
of the problems (values still agree to 2e-5). With atol 1e-2 over O(0.5)
states the rounding noise is about 1% of each error norm and the
decisions are the same. Gradients 1e-4 of each leaf's largest. The
scipy oracles are those of tests/test_solvers.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_gp_ode_tpu.dynamics import flow as jflow
from vae_gp_ode_tpu.dynamics import solvers as jsolvers
from vae_gp_ode_tpu.gp import svgp as jsvgp
from vae_gp_ode_tpu.kernels import rbf as jrbf
from vae_gp_ode_tpu.ops import pathwise as jpw

from vae_gp_ode_tpu_torch import ops
from vae_gp_ode_tpu_torch.dynamics import flow as tflow
from vae_gp_ode_tpu_torch.dynamics import solvers as tsolvers
from vae_gp_ode_tpu_torch.gp import svgp as tsvgp
from vae_gp_ode_tpu_torch.ops import pathwise as tpw
from vae_gp_ode_tpu_torch.utils.jax_import import gp_from_jax
import torch_threads  # noqa: F401

Q, S, M, N, T = 3, 16, 8, 4, 6
FIXED_TOL = dict(rtol=1e-5, atol=1e-6)
ADAPTIVE_TOL = dict(rtol=1e-4, atol=1e-4)
ADAPTIVE_KW = dict(rtol=1e-6, atol=1e-2)
GRAD_REL = 1e-4


def _gp_operands(rng, order, lead=()):
    """A pathwise sample's operands (omega, phase, weights, Z, nu, ls,
    var) at well-conditioned scales."""
    D = Q * order
    f = np.float32
    return (rng.standard_normal(lead + (D, S, Q)).astype(f),
            rng.uniform(0, 2 * np.pi, lead + (1, S, Q)).astype(f),
            rng.standard_normal(lead + (S, Q)).astype(f) * 0.5,
            rng.standard_normal((M, D)).astype(f),
            rng.standard_normal(lead + (Q, M)).astype(f) * 0.3,
            rng.uniform(0.8, 2.0, (Q, D)).astype(f),
            rng.uniform(0.3, 1.0, (Q,)).astype(f))


def _rhs(pkg, operands, order):
    """The GP RHS of an order-1 or order-2 flow in either package."""
    if pkg == 'jax':
        ev, cat = jpw.pathwise_eval_reference, jnp.concatenate
        operands = [jnp.asarray(o) for o in operands]
        kw = {'axis': -1}
    else:
        ev, cat = tpw.pathwise_eval_reference, torch.cat
        operands = [torch.as_tensor(o) for o in operands]
        kw = {'dim': -1}

    def f(t, z):
        out = ev(z, *operands)
        if order == 2:
            out = cat([z[..., Q:], out], **kw)
        return out
    return f


def _case(seed, order):
    rng = np.random.default_rng(seed)
    operands = _gp_operands(rng, order)
    z0 = (rng.standard_normal((N, Q * order)) * 0.5).astype(np.float32)
    ts = (0.1 * np.arange(T)).astype(np.float32)
    return operands, z0, ts


@pytest.mark.parametrize('order', [1, 2])
@pytest.mark.parametrize('dense', [1, 2])
@pytest.mark.parametrize('method', list(tsolvers.SOLVERS))
def test_odeint_matches_jax(method, dense, order):
    operands, z0, ts = _case(7 * order + dense, order)
    sol = tsolvers.odeint(_rhs('torch', operands, order), torch.as_tensor(z0),
                          torch.as_tensor(ts), method=method, dense=dense,
                          **ADAPTIVE_KW)
    ref = jsolvers.odeint(_rhs('jax', operands, order), jnp.asarray(z0),
                          jnp.asarray(ts), method=method, dense=dense,
                          **ADAPTIVE_KW)
    assert sol.zs.shape == (T, N, Q * order)
    tol = ADAPTIVE_TOL if method in tsolvers.ADAPTIVE_SOLVERS else FIXED_TOL
    np.testing.assert_allclose(sol.zs.numpy(), np.asarray(ref.zs), **tol)
    assert int(sol.nfe) == int(ref.nfe)


def test_solver_surface_matches_jax():
    assert tsolvers.SOLVERS == jsolvers.SOLVERS
    assert tsolvers.ADAPTIVE_SOLVERS == jsolvers.ADAPTIVE_SOLVERS
    np.testing.assert_allclose(np.asarray(tsolvers._DP_P),
                               np.asarray(jsolvers._DP_P), rtol=0, atol=0)
    with pytest.raises(ValueError, match='unknown solver'):
        tsolvers.odeint(lambda t, z: z, torch.zeros(2), torch.arange(3.0),
                        method='rk45')


# -- batched problems: one controller per draw --------------------------------

@pytest.mark.parametrize('method', ['dopri5', 'adams'])
def test_batched_draws_equal_single_solves_and_jax(method):
    """L=3 draws in one batched solve (each its own step sizes: their
    fields differ in scale) equal three one-draw solves, and each equals
    the JAX solve of that draw; nfe is the sum over the draws."""
    L = 3
    rng = np.random.default_rng(70)
    operands = _gp_operands(rng, 1, lead=(L,))
    scale = np.array([0.3, 1.0, 2.5], np.float32)
    operands = [o * scale.reshape((L,) + (1,) * (o.ndim - 1))
                if i == 4 else o for i, o in enumerate(operands)]
    z0 = (rng.standard_normal((L, N, Q)) * 0.5).astype(np.float32)
    ts = (0.1 * np.arange(T)).astype(np.float32)
    sol = tsolvers.odeint(_rhs('torch', operands, 1), torch.as_tensor(z0),
                          torch.as_tensor(ts), method=method, batched=True,
                          **ADAPTIVE_KW)
    assert sol.zs.shape == (T, L, N, Q)
    nfe = 0
    for l in range(L):
        one = [o[l] if i in (0, 1, 2, 4) else o
               for i, o in enumerate(operands)]
        single = tsolvers.odeint(_rhs('torch', one, 1),
                                 torch.as_tensor(z0[l]), torch.as_tensor(ts),
                                 method=method, **ADAPTIVE_KW)
        np.testing.assert_allclose(sol.zs[:, l].numpy(), single.zs.numpy(),
                                   rtol=1e-6, atol=1e-6)
        ref = jsolvers.odeint(_rhs('jax', one, 1), jnp.asarray(z0[l]),
                              jnp.asarray(ts), method=method, **ADAPTIVE_KW)
        np.testing.assert_allclose(sol.zs[:, l].numpy(), np.asarray(ref.zs),
                                   **ADAPTIVE_TOL)
        assert int(single.nfe) == int(ref.nfe)
        nfe += int(ref.nfe)
    assert int(sol.nfe) == nfe


def _grads(method, operands, z0, ts, **kw):
    """zs and the gradients of a fixed random functional of zs with
    respect to z0 and every operand."""
    inputs = [torch.as_tensor(a).requires_grad_() for a in [z0] + list(operands)]
    sol = tsolvers.odeint(_rhs('torch', inputs[1:], 1), inputs[0],
                          torch.as_tensor(ts), method=method, **kw)
    w = torch.as_tensor(np.random.default_rng(0).standard_normal(
        sol.zs.shape).astype(np.float32))
    grads = torch.autograd.grad((sol.zs * w).sum(), inputs)
    return sol, grads


@pytest.mark.parametrize('method', ['dopri5', 'adams'])
def test_early_stop_equals_the_full_bounded_loop(method):
    """Stopping once every draw is done gives the same zs, nfe and
    gradients as running all max_steps masked candidate steps."""
    L = 2
    rng = np.random.default_rng(80)
    operands = _gp_operands(rng, 1, lead=(L,))
    z0 = (rng.standard_normal((L, N, Q)) * 0.5).astype(np.float32)
    ts = (0.1 * np.arange(T)).astype(np.float32)
    kw = dict(batched=True, max_steps=48, remat=False)
    early, g_early = _grads(method, operands, z0, ts, early_stop=True, **kw)
    full, g_full = _grads(method, operands, z0, ts, early_stop=False, **kw)
    assert int(early.nfe) < 2 * 48 * L        # the loop did stop early
    assert torch.equal(early.zs, full.zs)
    assert int(early.nfe) == int(full.nfe)
    for a, b in zip(g_early, g_full):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize('method', ['rk4', 'fixed_adams', 'bdf', 'dopri5',
                                    'adams'])
def test_remat_gives_the_same_gradients(method):
    rng = np.random.default_rng(90)
    operands = _gp_operands(rng, 1)
    z0 = (rng.standard_normal((N, Q)) * 0.5).astype(np.float32)
    ts = (0.1 * np.arange(T)).astype(np.float32)
    on, g_on = _grads(method, operands, z0, ts, remat=True, dense=2)
    off, g_off = _grads(method, operands, z0, ts, remat=False, dense=2)
    assert torch.equal(on.zs, off.zs) and int(on.nfe) == int(off.nfe)
    for a, b in zip(g_on, g_off):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('method', ['rk4', 'explicit_adams', 'bdf', 'dopri5'])
def test_gradients_through_odeint_match_jax(method):
    """Reverse mode through the solve (backprop, remat on) against
    jax.grad through the JAX solve, for z0 and every operand."""
    rng = np.random.default_rng(100)
    operands = _gp_operands(rng, 1)
    z0 = (rng.standard_normal((N, Q)) * 0.5).astype(np.float32)
    ts = (0.1 * np.arange(T)).astype(np.float32)
    sol, grads = _grads(method, operands, z0, ts)
    w = np.random.default_rng(0).standard_normal(sol.zs.shape).astype(
        np.float32)

    def jloss(*args):
        zs = jsolvers.odeint(_rhs('jax', args[1:], 1), args[0],
                             jnp.asarray(ts), method=method).zs
        return jnp.sum(zs * w)

    ref = jax.grad(jloss, argnums=tuple(range(8)))(
        *map(jnp.asarray, [z0] + list(operands)))
    for a, b in zip(grads, ref):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).max()
        assert err <= GRAD_REL * np.abs(b).max(), (method, err)


# -- the port's own accuracy: the scipy oracles of tests/test_solvers.py -----

def _oscillator():
    def rhs_np(t, y):
        x, v = y[::2], y[1::2]
        out = np.empty_like(y)
        out[::2] = v
        out[1::2] = -x - 0.1 * v - 0.5 * x ** 3
        return out

    def rhs_t(t, z):
        x, v = z[..., 0], z[..., 1]
        return torch.stack([v, -x - 0.1 * v - 0.5 * x ** 3], dim=-1)
    z0 = np.random.RandomState(0).randn(4, 2).astype(np.float32)
    return rhs_np, rhs_t, z0


@pytest.mark.parametrize('method,scipy_method,cases', [
    ('dopri5', 'RK45', ((1e-5, 1e-4), (1e-6, 3e-5))),
    ('adams', 'LSODA', ((1e-5, 1e-3), (1e-6, 1e-4)))])
def test_adaptive_solvers_against_scipy(method, scipy_method, cases):
    """Trajectories at matched tolerances against scipy's solve_ivp, and
    comparable work (nfe within 1.2x of scipy's)."""
    from scipy.integrate import solve_ivp
    rhs_np, rhs_t, z0 = _oscillator()
    ts = np.linspace(0.0, 5.0, 11)
    for tol, max_err in cases:
        sol = tsolvers.odeint(rhs_t, torch.as_tensor(z0),
                              torch.as_tensor(ts, dtype=torch.float32),
                              method=method, rtol=tol, atol=tol,
                              max_steps=4096)
        ref = solve_ivp(rhs_np, (0.0, 5.0), z0.reshape(-1).astype(np.float64),
                        method=scipy_method, t_eval=ts, rtol=tol, atol=tol)
        err = np.abs(sol.zs.numpy() - ref.y.T.reshape(len(ts), *z0.shape))
        assert err.max() < max_err, (tol, err.max())
        assert int(sol.nfe) < 1.2 * ref.nfev, (tol, int(sol.nfe), ref.nfev)


def test_bdf2_second_order_on_nonuniform_grid():
    """BDF2 keeps its 2nd-order rate on a non-uniform grid: refining it 2x
    cuts the error ~4x (tests/test_solvers.py's oracle)."""
    z0 = torch.as_tensor(np.random.RandomState(0).randn(4, 2), dtype=torch.float32)
    base = np.array([0.0, 0.07, 0.21, 0.45, 0.8, 1.0, 1.3, 1.5])
    errs = []
    g = base
    for _ in range(2):
        g = np.sort(np.concatenate([g, (g[:-1] + g[1:]) / 2]))
        sol = tsolvers.odeint(lambda t, z: -z, z0, torch.as_tensor(
            g, dtype=torch.float32), method='bdf')
        errs.append(float((sol.zs[-1] - z0 * np.exp(-g[-1])).abs().max()))
    assert np.log2(errs[0] / errs[1]) > 1.6, errs


def test_row_jacobian_is_the_per_row_jacobian():
    rng = np.random.default_rng(110)
    operands = _gp_operands(rng, 1)
    f = _rhs('torch', operands, 1)
    z = torch.as_tensor(rng.standard_normal((2, N, Q)).astype(np.float32))
    J = tsolvers.row_jacobian(lambda zz: f(None, zz), z)
    assert J.shape == (2, N, Q, Q)
    for l in range(2):
        for n in range(N):
            ref = torch.autograd.functional.jacobian(
                lambda r: f(None, r[None])[0], z[l, n])
            torch.testing.assert_close(J[l, n], ref, rtol=1e-6, atol=1e-6)


# -- the flow and the train step ----------------------------------------------

def _gp_pair(rng, order):
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
    return jgp, gp_from_jax(leaves)


@pytest.mark.parametrize('solver,dense', [('rk4', 1), ('euler', 2),
                                          ('dopri5', 1), ('fixed_adams', 2)])
def test_flow_forward_with_solvers_matches_jax(solver, dense):
    """dynamics.flow.flow_forward over a batch of L=2 draws from one GP
    against the JAX flow_forward per draw (fn_eval through the scan
    solvers); no launches on the CPU."""
    L = 2
    rng = np.random.default_rng(120)
    jgp, tgp = _gp_pair(rng, 1)
    noise = {'omega': rng.standard_normal((L, Q, S, Q)),
             'phase_u': rng.random((L, 1, S, Q)),
             'weights': rng.standard_normal((L, S, Q)),
             'epsilon': rng.standard_normal((L, M, Q))}
    noise = {k: v.astype(np.float32) for k, v in noise.items()}
    z0 = (rng.standard_normal((N, Q)) * 0.5).astype(np.float32)
    ts = (0.1 * np.arange(T)).astype(np.float32)
    sample = tsvgp.draw_fn_sample(
        tgp, None, S, noise={k: torch.as_tensor(v) for k, v in noise.items()})
    before = dict(ops.LAUNCHES)
    zs, nfe = tflow.flow_forward(tgp, sample, torch.as_tensor(z0),
                                 torch.as_tensor(ts), solver=solver,
                                 dense=dense, device='cpu', **ADAPTIVE_KW)
    assert ops.LAUNCHES == before
    assert zs.shape == (L, N, T, Q)
    jnfe = 0
    for l in range(L):
        js = jsvgp.draw_fn_sample(jgp, None, S, noise={
            k: jnp.asarray(v[l]) for k, v in noise.items()})
        ref, n = jflow.flow_forward(jgp, js, jnp.asarray(z0),
                                    jnp.asarray(ts), solver=solver,
                                    dense=dense, **ADAPTIVE_KW)
        np.testing.assert_allclose(zs[l].numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)
        jnfe += int(n)
    assert int(nfe) == jnfe

