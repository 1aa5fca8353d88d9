"""The per-step evals' Jacobian operators (`ops.library`
`pathwise_eval_jac`, `df_pathwise_eval_jac`, through `gp.svgp.fn_jacobian`)
and bdf's Newton iterations through them, against the JAX package on the
CPU at small sizes (q=3, S=16, M=8, N=5).

The same numpy-seeded leaves and raw noise (`draw_fn_sample(noise=...)`)
go to both packages. Tolerances: the Jacobians 1e-5 (relative, and
absolute of the largest entry: they hold nu, which comes out of a
Cholesky solve, `tests/test_torch_gp.py`) against JAX's
`vmap(jacrev(fn_eval))`; bdf through the operators against bdf through
`row_jacobian` (D reverse-mode products of the same evals) 1e-6, and
against JAX's bdf at `tests/test_torch_solvers.py`'s flow tolerance
(rtol 1e-4, atol 1e-5). DF lengthscales lie within 2% of one value,
which keeps its gram definite (ROADMAP Queue C notes).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_gp_ode_tpu.core import transforms as jtr
from vae_gp_ode_tpu.dynamics import flow as jflow
from vae_gp_ode_tpu.gp import svgp as jsvgp
from vae_gp_ode_tpu.kernels import rbf as jrbf

from vae_gp_ode_tpu_torch.dynamics import flow as tflow
from vae_gp_ode_tpu_torch.dynamics import solvers as tsolvers
from vae_gp_ode_tpu_torch.gp import svgp as tsvgp
from vae_gp_ode_tpu_torch.ops import df_pathwise, library, pathwise
from vae_gp_ode_tpu_torch.utils.jax_import import gp_from_jax
import torch_threads  # noqa: F401

Q, S, M, N, T = 3, 16, 8, 5, 6
JAC_TOL = 1e-5
ROUTE_TOL = dict(rtol=1e-6, atol=1e-6)
FLOW_TOL = dict(rtol=1e-4, atol=1e-5)
KINDS = ('dimwise', 'shared', 'DF')


def _gp_pair(rng, kind, D_in=Q):
    """The same SVGP in both packages: RBF lengthscales 0.5..1.2
    (dimwise (Q, D_in), shared (D_in,)), DF ones within 2% of 1.1."""
    f = np.float32
    if kind == 'DF':
        ls = rng.uniform(0.98, 1.02, (Q, D_in)) * 1.1
        var = rng.uniform(0.5, 1.0, (Q,))
    elif kind == 'dimwise':
        ls = rng.uniform(0.5, 1.2, (Q, D_in))
        var = rng.uniform(0.3, 1.0, (Q,))
    else:
        ls = rng.uniform(0.5, 1.2, (D_in,))
        var = rng.uniform(0.3, 1.0, (1,))
    tril = np.tril(rng.standard_normal((Q, M, M)) * 0.1)
    tril += np.eye(M) * rng.uniform(0.2, 1.0, (Q, 1, M))
    lv = {'kernel': {
        'unconstrained_lengthscales': np.asarray(
            jtr.invsoftplus(jnp.asarray(ls.astype(f)))),
        'unconstrained_variance': np.asarray(
            jtr.invsoftplus(jnp.asarray(var.astype(f))))},
        'inducing_loc': rng.standard_normal((M, D_in)).astype(f),
        'Um': (rng.standard_normal((M, Q)) * 0.3).astype(f),
        'Us_sqrt': np.asarray(jtr.pack_tril(jnp.asarray(tril.astype(f))))}
    name = 'DF' if kind == 'DF' else 'RBF'
    jgp = jsvgp.SVGPParams(
        kernel=jrbf.RBFParams(
            jnp.asarray(lv['kernel']['unconstrained_lengthscales']),
            jnp.asarray(lv['kernel']['unconstrained_variance']),
            dimwise=kind != 'shared'),
        inducing_loc=jnp.asarray(lv['inducing_loc']),
        Um=jnp.asarray(lv['Um']), Us_sqrt=jnp.asarray(lv['Us_sqrt']),
        kernel_name=name)
    return jgp, gp_from_jax(lv, name)


def _noise(rng, kind, D_in=Q, lead=()):
    """Raw draws in the layout of `kind` (`serving.noise_spec`'s)."""
    per_dim = () if kind == 'shared' else (Q,)
    f = np.float32
    return {'omega': rng.standard_normal(lead + (D_in, S) + per_dim
                                         ).astype(f),
            'phase_u': rng.random(lead + (1, S) + per_dim).astype(f),
            'weights': rng.standard_normal(
                lead + ((2 * S if kind == 'DF' else S), Q)).astype(f),
            'epsilon': rng.standard_normal(lead + (M, Q)).astype(f)}


def _samples(jgp, tgp, noise, lead):
    """The port's sample (with the draw dim of `lead`) and JAX's, one per
    draw."""
    ts = tsvgp.draw_fn_sample(tgp, None, S, noise={
        k: torch.as_tensor(v) for k, v in noise.items()})
    draws = [noise] if not lead else [
        {k: v[l] for k, v in noise.items()} for l in range(lead[0])]
    draw = jax.jit(lambda nz: jsvgp.draw_fn_sample(jgp, None, S, noise=nz))
    return ts, [draw({k: jnp.asarray(v) for k, v in d.items()})
                for d in draws]


def _close(actual, desired, tol=JAC_TOL):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=tol,
                               atol=tol * float(np.abs(desired).max()))


# -- the operators against JAX's vmap(jacrev(fn_eval)) ------------------------

@pytest.mark.parametrize('lead', [(), (1,), (3,)],
                         ids=['no_draw_dim', 'L1', 'L3'])
@pytest.mark.parametrize('kind', KINDS)
def test_jacobian_operators_match_jax(kind, lead):
    """fn_jacobian (N, K, D) per draw against JAX's per-row jacrev of
    fn_eval; x is shared by the draws at L=1 and one per draw at L=3."""
    rng = np.random.default_rng(10 + KINDS.index(kind) * 3 + len(lead)
                                + (lead[0] if lead else 0))
    jgp, tgp = _gp_pair(rng, kind)
    ts, jss = _samples(jgp, tgp, _noise(rng, kind, lead=lead), lead)
    x_lead = (3,) if lead == (3,) else ()
    x = rng.standard_normal(x_lead + (N, Q)).astype(np.float32)
    J = tsvgp.fn_jacobian(tgp, ts, torch.as_tensor(x))
    assert J.shape == lead + (N, Q, Q) and not J.requires_grad
    for l, js in enumerate(jss):
        xl = x[l] if x_lead else x
        ref = jax.jit(jax.vmap(jax.jacrev(
            lambda xi, js=js: jsvgp.fn_eval(jgp, js, xi[None])[0])))(
                jnp.asarray(xl))
        _close((J[l] if lead else J).numpy(), ref)


@pytest.mark.parametrize('n', [1, N])
@pytest.mark.parametrize('kind', ['RBF', 'DF'])
def test_launch_jacobian_takes_one_vjp(kind, n):
    """The card's route, `ops.pathwise.launch_jacobian`, with the plain
    VJP in the kernel's place: one call on contiguous (L, n*K, D) rows and
    cotangents (as the kernels read them, also at n = 1) gives the plain
    Jacobian, with shared operands and per-draw ones."""
    rng = np.random.default_rng(30)
    jgp, tgp = _gp_pair(rng, 'DF' if kind == 'DF' else 'dimwise')
    ts, _ = _samples(jgp, tgp, _noise(rng, 'DF' if kind == 'DF'
                                      else 'dimwise', lead=(2,)), (2,))
    x = torch.as_tensor(rng.standard_normal((2, n, Q)).astype(np.float32))
    if kind == 'DF':
        operands = df_pathwise.df_fused_operands(tgp, ts)
        vjp = df_pathwise.df_pathwise_vjp_reference
        ref = df_pathwise.df_pathwise_jacobian_reference(x, *operands)
    else:
        operands = pathwise.rbf_fused_operands(tgp, ts)
        vjp = pathwise.pathwise_vjp_reference
        ref = pathwise.pathwise_jacobian_reference(x, *operands)
    calls = []

    def launch_bwd(xr, ops, g):
        calls.append((tuple(xr.shape), tuple(g.shape), xr.is_contiguous(),
                      g.is_contiguous()))
        return vjp(xr, *ops, g)

    operands = [t.detach() for t in operands]
    J = pathwise.launch_jacobian(launch_bwd, x, operands, Q)
    assert calls == [((2, n * Q, Q), (2, n * Q, Q), True, True)]
    torch.testing.assert_close(J, ref, rtol=0, atol=0)


# -- bdf's Newton iterations through the operators ----------------------------

@pytest.mark.parametrize('kind, order', [('dimwise', 1), ('dimwise', 2),
                                         ('DF', 1)],
                         ids=['order1', 'order2', 'DF'])
def test_bdf_through_the_jacobian_operators(kind, order, monkeypatch):
    """bdf over L=2 draws whose Newton Jacobians come from the operator
    (one call per iteration) against the same flow through
    `row_jacobian` (an rhs without `jacobian`) and against JAX's bdf per
    draw."""
    L = 2
    rng = np.random.default_rng(40 + order + 2 * (kind == 'DF'))
    jgp, tgp = _gp_pair(rng, kind, D_in=Q * order)
    ts, jss = _samples(jgp, tgp, _noise(rng, kind, D_in=Q * order,
                                        lead=(L,)), (L,))
    z0 = (rng.standard_normal((N, Q * order)) * 0.5).astype(np.float32)
    tt = (0.1 * np.arange(T)).astype(np.float32)
    op = 'df_pathwise_eval_jac' if kind == 'DF' else 'pathwise_eval_jac'
    calls = []
    real = getattr(library, op)

    def counted(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(library, op, counted)
    rhs = tflow.make_ode_rhs(tgp, ts, order)
    z = torch.as_tensor(z0).expand(L, N, Q * order)
    sol = tsolvers.odeint(rhs, z, torch.as_tensor(tt), method='bdf',
                          batched=True)
    assert calls == [(L, N, Q * order)] * (6 * (T - 1))
    plain = tsolvers.odeint(lambda t, zz: rhs(t, zz), z,
                            torch.as_tensor(tt), method='bdf', batched=True)
    assert len(calls) == 6 * (T - 1)
    np.testing.assert_allclose(sol.zs.numpy(), plain.zs.numpy(),
                               **ROUTE_TOL)
    zs, nfe = tflow.flow_forward(tgp, ts, torch.as_tensor(z0),
                                 torch.as_tensor(tt), order=order,
                                 solver='bdf', device='cpu')
    np.testing.assert_array_equal(zs.numpy(),
                                  sol.zs.permute(1, 2, 0, 3).numpy())
    jnfe = 0
    for l, js in enumerate(jss):
        ref, n = jax.jit(lambda js: jflow.flow_forward(
            jgp, js, jnp.asarray(z0), jnp.asarray(tt), order=order,
            solver='bdf'))(js)
        np.testing.assert_allclose(zs[l].numpy(), np.asarray(ref),
                                   **FLOW_TOL)
        jnfe += int(n)
    assert nfe == jnfe


def test_traced_row_jacobian_on_the_cpu():
    """`row_jacobian`, which bdf takes for a right-hand side without its
    own `jacobian`: traced by `torch.export` on the CPU (forward mode) it
    gives the per-row Jacobians of its eager form."""
    rng = np.random.default_rng(50)
    W = torch.as_tensor(rng.standard_normal((Q, Q)).astype(np.float32))

    def g(z):
        return torch.tanh(z @ W) * z

    class RowJacobian(torch.nn.Module):
        def forward(self, z):
            return tsolvers.row_jacobian(g, z)

    z = torch.as_tensor(rng.standard_normal((2, N, Q)).astype(np.float32))
    with torch.no_grad():
        traced = torch.export.export(RowJacobian(), (z,)).module()(z)
    np.testing.assert_allclose(traced.numpy(),
                               tsolvers.row_jacobian(g, z).numpy(),
                               **ROUTE_TOL)
