"""Parity of the port's divergence-free (DF) path with the JAX package, on
the CPU at small sizes (q = D = 3, S = 16-33, M = 8-13, N = 5-7, T = 6,
L = 2; the train steps at tests/test_torch_train.py's sizes).

On the CPU the port's wrappers compute the kernels' plain versions; they
are held against the JAX Pallas kernels run in interpret mode: the
per-step eval and its VJP (`fused_df_pathwise_eval`, kernels #5/#6) and
the euler trajectory and its discrete adjoint (`packed_df_euler_flow`,
#7/#8). Then the DF sample and `fn_eval`, the flow, the train step at
L=1 and L=5, an rk4 step and an rk4 continuous-adjoint step, the pair's
dispatch rule, and the shipped checkpoint `checkpoints/df_5000ep`.

Tolerances: kernel outputs 1e-5 (rtol and atol; f32 sums over up to 198
feature columns, 13 inducing points and D^2 = 9 pairs in another order),
each cotangent 1e-5 of its largest entry; the trajectory 1e-5 through 5
steps. The sample's nu and what comes from it 1e-5 of the largest entry.
Train steps as in tests/test_torch_train.py: ELBO terms 1e-4 relative,
gradients 1e-4 of each leaf's largest. The DF gram factors only for
lengthscales close to one common value (tests/test_torch_divfree.py), so
the GPs here take lengthscales within 2% of one value.
"""

import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_gp_ode_tpu.dynamics import flow as jflow
from vae_gp_ode_tpu.gp import svgp as jsvgp
from vae_gp_ode_tpu.kernels.rbf import RBFParams
from vae_gp_ode_tpu.models.odegpvae import init_model as jinit_model
from vae_gp_ode_tpu.ops import df_flow_fused as jdff
from vae_gp_ode_tpu.ops import df_pathwise as jdpw
from vae_gp_ode_tpu.training import trainer as jtrainer
from vae_gp_ode_tpu.training.objectives import compute_loss as jcompute_loss

from vae_gp_ode_tpu_torch import ops
from vae_gp_ode_tpu_torch.core.transforms import invsoftplus
from vae_gp_ode_tpu_torch.dynamics import flow as tflow
from vae_gp_ode_tpu_torch.gp import svgp as tsvgp
from vae_gp_ode_tpu_torch.ops import df_flow_fused as tdff
from vae_gp_ode_tpu_torch.ops import df_pathwise as tdpw
from vae_gp_ode_tpu_torch.training import checkpoint, trainer
from vae_gp_ode_tpu_torch.utils.jax_import import (
    gp_from_jax, train_state_from_jax,
)

import test_torch_train as ttr
import torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
VJP_REL = 1e-5
NAMES = ('x',) + tdpw.NAMES
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, 'checkpoints', 'df_5000ep')


def _operands(rng, N=7, D=3, S=33, M=13, lead=()):
    """(x, omf, phf, G, Z, nur, ls2, var) with the draw operands and x
    under `lead` (values at the scales of a sample: G ~ sqrt(var/S))."""
    f = np.float32
    SD = S * D
    return (rng.standard_normal(lead + (N, D)).astype(f) * 0.7,
            rng.standard_normal(lead + (D, SD)).astype(f),
            rng.uniform(0, 2 * np.pi, lead + (1, SD)).astype(f),
            (rng.standard_normal(lead + (2 * SD, D)) / np.sqrt(S)).astype(f),
            rng.standard_normal((M, D)).astype(f),
            rng.standard_normal(lead + (M, D)).astype(f) * 0.3,
            rng.uniform(0.25, 1.44, (D, D)).astype(f),
            rng.uniform(0.3, 1.0, (D,)).astype(f))


def _t(args):
    return [torch.as_tensor(a) for a in args]


def _assert_cotangents(mine, ref, names, rel=VJP_REL):
    assert len(mine) == len(ref) == len(names)
    for name, a, b in zip(names, mine, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        err = np.abs(a - b).max()
        tol = rel * max(np.abs(b).max(), 1e-30)
        assert err <= tol, f'{name}: max err {err:.3e} > {tol:.3e}'


# -- kernels #5/#6: the per-step eval and its VJP -----------------------------

@pytest.mark.parametrize('shape', [dict(), dict(N=5, S=16, M=8),
                                   dict(N=1, D=2, S=1, M=1)])
def test_plain_eval_and_vjp_match_jax_kernel(shape):
    """Kernel #5's output and #6's cotangents. (At D=1 the update term is
    identically 0, so its cotangents are rounding noise in both packages:
    the smallest shape is D=2.)"""
    rng = np.random.default_rng(len(shape))
    args = _operands(rng, **shape)
    before = dict(ops.LAUNCHES)
    out = tdpw.fused_df_pathwise_eval(*_t(args))
    assert ops.LAUNCHES == before            # CPU tensors: plain version
    ref = jdpw.fused_df_pathwise_eval(*map(jnp.asarray, args),
                                      interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    g = rng.standard_normal(out.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jdpw.fused_df_pathwise_eval(
        *a, interpret=True), *map(jnp.asarray, args))
    inputs = [t.requires_grad_() for t in _t(args)]
    mine = torch.autograd.grad(tdpw.fused_df_pathwise_eval(*inputs), inputs,
                               torch.as_tensor(g))
    _assert_cotangents([m.numpy() for m in mine], vjp(jnp.asarray(g)), NAMES)
    ref_vjp = tdpw.df_pathwise_vjp_reference(*_t(args), torch.as_tensor(g))
    _assert_cotangents([m.numpy() for m in ref_vjp],
                       [m.numpy() for m in mine], NAMES, rel=1e-6)


def test_plain_eval_batches_draws_and_shares_gp_operands():
    """A leading dim of L draws on x and the draw operands (Z, ls2, var
    shared), against the JAX kernel per draw; the cotangents of the
    shared operands are the draws' sum."""
    rng = np.random.default_rng(3)
    L = 2
    args = _operands(rng, lead=(L,))
    inputs = [t.requires_grad_() for t in _t(args)]
    out = tdpw.fused_df_pathwise_eval(*inputs)
    g = rng.standard_normal(out.shape).astype(np.float32)
    mine = torch.autograd.grad(out, inputs, torch.as_tensor(g))
    sums = [0.0] * 3
    for l in range(L):
        one = [a[l] for a in args[:4]] + list(args[4:5]) + [args[5][l]] + \
            list(args[6:])
        ref = jdpw.fused_df_pathwise_eval(*map(jnp.asarray, one),
                                          interpret=True)
        np.testing.assert_allclose(out[l].detach().numpy(), np.asarray(ref),
                                   **TOL)
        _, vjp = jax.vjp(lambda *a: jdpw.fused_df_pathwise_eval(
            *a, interpret=True), *map(jnp.asarray, one))
        rv = vjp(jnp.asarray(g[l]))
        per_draw = [0, 1, 2, 3, 5]
        _assert_cotangents([mine[i][l].numpy() for i in per_draw],
                           [rv[i] for i in per_draw],
                           [NAMES[i] for i in per_draw])
        for k, i in enumerate((4, 6, 7)):
            sums[k] = sums[k] + np.asarray(rv[i])
    _assert_cotangents([mine[i].numpy() for i in (4, 6, 7)], sums,
                       ('Z', 'ls2', 'var'))


# -- kernels #7/#8: the trajectory and its discrete adjoint -------------------

@pytest.mark.parametrize('uniform', [True, False])
def test_plain_flow_and_adjoint_match_jax_kernel(uniform):
    """packed_df_euler_flow (T=6) and the cotangents of z0, omf, phf, G,
    Z, nur, ls2, var and dts against JAX's in interpret mode."""
    rng = np.random.default_rng(10 + uniform)
    T = 6
    z0, *operands = _operands(rng, N=6, S=16, M=8)
    dts = (np.full(T - 1, 0.1) if uniform
           else rng.uniform(0.05, 0.2, T - 1)).astype(np.float32)
    args = [z0] + operands + [dts]
    inputs = [t.requires_grad_() for t in _t(args)]
    before = dict(ops.LAUNCHES)
    zs = tdff.packed_df_euler_flow(*inputs, T)
    assert ops.LAUNCHES == before
    ref = jdff.packed_df_euler_flow(*map(jnp.asarray, args), T,
                                    interpret=True)
    np.testing.assert_allclose(zs.detach().numpy(), np.asarray(ref), **TOL)
    zsbar = rng.standard_normal(zs.shape).astype(np.float32)
    mine = torch.autograd.grad(zs, inputs, torch.as_tensor(zsbar))
    _, vjp = jax.vjp(lambda *a: jdff.packed_df_euler_flow(
        *a, T, interpret=True), *map(jnp.asarray, args))
    names = ('z0',) + tdpw.NAMES + ('dts',)
    _assert_cotangents([m.numpy() for m in mine], vjp(jnp.asarray(zsbar)),
                       names)
    # the backward as a function (what the adjoint kernel computes)
    fn = tdff.df_flow_vjp(zs.detach(), torch.as_tensor(zsbar),
                          *_t(args[1:]), T)
    _assert_cotangents([m.numpy() for m in fn], [m.numpy() for m in mine],
                       names, rel=1e-6)


@pytest.mark.parametrize('what', ['eval', 'flow'])
def test_plain_versions_match_jax_at_state_dim_20(what):
    """Above D = 16 the card runs the DF path through the tiled pair's
    wide instance (#11/#12), held on the card to the plain versions that
    the CPU runs; here those plain versions, the per-step eval and the
    euler flow, forward and every cotangent, against JAX's references
    (`df_pathwise_reference`, `df_euler_flow_reference`, plain jnp as the
    JAX package's tests run them) at D = 20 on the same numpy inputs:
    forward 1e-5, each cotangent 1e-4 of its largest entry."""
    rng = np.random.default_rng(20)
    T = 5
    args = _operands(rng, N=5, D=20, S=8, M=6)
    if what == 'eval':
        tfn, jfn = tdpw.df_pathwise_reference, jdpw.df_pathwise_reference
        names = NAMES
    else:
        args = args + (rng.uniform(0.05, 0.15, T - 1).astype(np.float32),)
        tfn = lambda *a: tdff.df_euler_flow_reference(*a, T)
        jfn = lambda *a: jdff.df_euler_flow_reference(*a, T)
        names = ('z0',) + tdpw.NAMES + ('dts',)
    inputs = [t.requires_grad_() for t in _t(args)]
    out = tfn(*inputs)
    ref, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    g = rng.standard_normal(out.shape).astype(np.float32)
    mine = torch.autograd.grad(out, inputs, torch.as_tensor(g))
    _assert_cotangents([m.numpy() for m in mine], vjp(jnp.asarray(g)),
                       names, rel=1e-4)


def test_plain_eval_matches_jax_at_state_dim_64():
    """At D = 64 the card runs the per-step eval through the tiled pair's
    wide kernels (#11/#12), held on the card to the plain version that the
    CPU runs; here the plain version's forward and every cotangent
    against JAX's `df_pathwise_reference` and autograd through it (plain
    jnp, as the JAX package's tests run it) on the same numpy inputs, S =
    16, M = 8, N = 4: forward 1e-5 of its largest entry (an entry sums
    1,024 prior terms of up to ~15 that cancel, so f32 rounding in two
    summation orders reaches 1.7e-5 on an entry of 0.5), each cotangent
    1e-4 of its largest entry. The lengthscales are scaled up 40 times, so
    that the squared distances of 64-dimensional points (~95) do not put
    the update's envelopes at 0."""
    rng = np.random.default_rng(64)
    args = list(_operands(rng, N=4, D=64, S=16, M=8))
    args[6] = args[6] * np.float32(40.0)
    inputs = [t.requires_grad_() for t in _t(args)]
    out = tdpw.df_pathwise_reference(*inputs)
    ref, vjp = jax.vjp(jdpw.df_pathwise_reference, *map(jnp.asarray, args))
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    g = rng.standard_normal(out.shape).astype(np.float32)
    mine = torch.autograd.grad(out, inputs, torch.as_tensor(g))
    _assert_cotangents([m.numpy() for m in mine], vjp(jnp.asarray(g)), NAMES,
                       rel=1e-4)


# -- the DF sample, fn_eval and the flow ---------------------------------------

Q, S, M, N, L = 3, 16, 8, 5, 2


def _gp_pair(rng, m=M):
    """The same DF GP in both packages: lengthscales and variances within
    2% of one value each, a random q(u)."""
    ls = rng.uniform(0.5, 1.2) * (1 + 0.02 * rng.uniform(-1, 1, (Q, Q)))
    var = rng.uniform(0.3, 1.0) * (1 + 0.02 * rng.uniform(-1, 1, Q))
    tril = np.tril(rng.standard_normal((Q, m, m)) * 0.1)
    tril += np.eye(m) * rng.uniform(0.2, 1.0, (Q, 1, m))
    jgp = jsvgp.init_svgp_params(jax.random.PRNGKey(0), Q, Q, m,
                                 kernel='DF')
    f = np.float32
    gp_np = {'kernel': {
        'unconstrained_lengthscales': invsoftplus(torch.as_tensor(
            ls, dtype=torch.float32)).numpy(),
        'unconstrained_variance': invsoftplus(torch.as_tensor(
            var, dtype=torch.float32)).numpy()},
        'inducing_loc': rng.standard_normal((m, Q)).astype(f),
        'Um': (rng.standard_normal((m, Q)) * 0.3).astype(f),
        'Us_sqrt': np.asarray(jsvgp.pack_tril(jnp.asarray(tril, f)))}
    jgp = jgp.replace(
        kernel=RBFParams(jnp.asarray(gp_np['kernel'][
            'unconstrained_lengthscales']), jnp.asarray(gp_np['kernel'][
                'unconstrained_variance'])),
        inducing_loc=jnp.asarray(gp_np['inducing_loc']),
        Um=jnp.asarray(gp_np['Um']), Us_sqrt=jnp.asarray(gp_np['Us_sqrt']))
    return jgp, gp_from_jax(gp_np, 'DF')


def _sample_noise(rng, lead=(), m=M):
    f = np.float32
    return {'omega': rng.standard_normal(lead + (Q, S, Q)).astype(f),
            'phase_u': rng.random(lead + (1, S, Q)).astype(f),
            'weights': rng.standard_normal(lead + (2 * S, Q)).astype(f),
            'epsilon': rng.standard_normal(lead + (m, Q)).astype(f)}


def _scaled(actual, desired, tol=1e-5):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=tol,
                               atol=tol * float(np.abs(desired).max()))


@pytest.mark.parametrize('m', [8, 13])
def test_sample_and_fn_eval_match(m):
    """draw_fn_sample (L draws in one call, injected noise) and fn_eval
    against the JAX package per draw."""
    rng = np.random.default_rng(20 + m)
    jgp, tgp = _gp_pair(rng, m)
    noise = _sample_noise(rng, (L,), m)
    ts = tsvgp.draw_fn_sample(tgp, None, S, noise={
        k: torch.as_tensor(v) for k, v in noise.items()})
    assert ts.lead == (L,) and ts.nu.shape == (L, m * Q, 1)
    assert ts.df_G.shape == (L, 2 * S * Q, Q)
    x = (rng.standard_normal((L, N, Q)) * 0.7).astype(np.float32)
    f = tsvgp.fn_eval(tgp, ts, torch.as_tensor(x))
    for l in range(L):
        js = jsvgp.draw_fn_sample(jgp, None, S, noise={
            k: jnp.asarray(v[l]) for k, v in noise.items()})
        np.testing.assert_allclose(ts.df_G[l].numpy(), np.asarray(js.df_G),
                                   rtol=1e-6, atol=1e-6)
        _scaled(ts.nu[l].numpy(), js.nu)
        _scaled(f[l].detach().numpy(),
                jsvgp.fn_eval(jgp, js, jnp.asarray(x[l])))


@pytest.mark.parametrize('solver', ['euler', 'rk4'])
def test_flow_forward_matches(solver, monkeypatch):
    """The DF flow (euler: the fused pair's plain version, and the euler
    scan over fn_eval that the pair's refusals take; rk4: odeint over
    fn_eval) against JAX's flow_forward per draw, nfe included."""
    rng = np.random.default_rng(30)
    jgp, tgp = _gp_pair(rng)
    noise = _sample_noise(rng, (L,))
    ts_ = tsvgp.draw_fn_sample(tgp, None, S, noise={
        k: torch.as_tensor(v) for k, v in noise.items()})
    z0 = (rng.standard_normal((N, Q)) * 0.5).astype(np.float32)
    T = 6
    tgrid = (0.1 * np.arange(T)).astype(np.float32)
    runs = [True, False] if solver == 'euler' else [True]
    for fused in runs:
        monkeypatch.setattr(tflow, 'use_fused_pair',
                            lambda *a, fused=fused: fused)
        zs, nfe = tflow.flow_forward(tgp, ts_, torch.as_tensor(z0),
                                     torch.as_tensor(tgrid), solver=solver,
                                     device='cpu')
        assert zs.shape == (L, N, T, Q)
        assert int(nfe) == L * (T - 1) * (4 if solver == 'rk4' else 1)
        for l in range(L):
            js = jsvgp.draw_fn_sample(jgp, None, S, noise={
                k: jnp.asarray(v[l]) for k, v in noise.items()})
            ref, jnfe = jflow.flow_forward(jgp, js, jnp.asarray(z0),
                                           jnp.asarray(tgrid), solver=solver)
            assert int(jnfe) * L == int(nfe)
            _scaled(zs[l].detach().numpy(), ref)


# -- the pair's dispatch rule ---------------------------------------------------

def _df_bwd_smem_bytes(D, S, M):
    """csrc/df_flow_fused_bwd.cu's df_flow_fused_bwd_smem_bytes, transcribed (its export is held to this on the GPU in
    tests/test_torch_cuda.py):
    one block of an 8-block cluster at the most rows per cluster (4 up to
    D = 8, else 2) holds 2 (3D + 1) floats for each item of its share
    (ceil(S D / 8) feature columns and ceil(M / 8) points of D items
    each), the rows' g, z_t and zsbar, 1/ls2 | var and its ls2 | var sums,
    and the warps' and the block's partial sums of R D + 1 values."""
    R = 4 if D <= 8 else 2
    IB = -(-S * D // 8) + -(-M // 8) * D
    RD, V = R * D, R * D + 1
    return 4 * (2 * (3 * D + 1) * IB + 3 * RD + 2 * (D * D + D) + 8 * V
                + 2 * V)


def _df_fwd_smem_bytes(D):
    """csrc/df_flow_fused.cu's df_flow_fused_fwd_smem_bytes, transcribed:
    one block of the trajectory kernel at the most rows per cluster (4 up
    to D = 8, else 2) holds the tile's state, 1/ls2 | var, the warps'
    partial sums of R D values and the block's, double-buffered."""
    RD = (4 if D <= 8 else 2) * D
    return 4 * (RD + D * D + D + 8 * RD + 2 * RD)


H100_SMEM_OPTIN = 232448      # bytes per block, cudaDevAttrMaxSharedMemoryPerBlockOptin


@pytest.mark.parametrize('D,S,fits', [
    (6, 256, True),            # the default DF run: 42,664 bytes
    (6, 512, True),            # refused before the adjoint's clusters
    (6, 1024, True),
    (6, 2048, False),          # 246,952 bytes
    (12, 256, True),           # refused before the adjoint's clusters
    (16, 256, False),
    (12, 1024, False),
    (3, 1024, True),
    (17, 16, False)])          # D > 16: only the tiled pair takes it
def test_df_pair_rule_on_the_refused_shapes(D, S, fits):
    """The rule sends the shapes the DF pair refuses to the euler scan over
    the per-step kernels, before any launch: it takes a flow where the
    larger of its two kernels' blocks fits the opt-in limit. The
    trajectory kernel's block (the tile's state and sums: 1,224 bytes at
    D = 6) is the smaller at every shape, so the boundary is the
    adjoint's: its block grows with its share of the columns and points
    of an 8-block cluster, so the pair takes S up to ~1900 at D = 6 and D
    up to 14 at S = 256."""
    need = max(_df_fwd_smem_bytes(D), _df_bwd_smem_bytes(D, S, 100))
    assert _df_fwd_smem_bytes(D) < _df_bwd_smem_bytes(D, S, 100)
    assert _df_fwd_smem_bytes(6) == 1224
    assert tdff.df_pair_fits(D, need, H100_SMEM_OPTIN) == fits
    assert not tdff.df_pair_fits(6, 1024, -1)   # an unreadable limit refuses


def test_df_flow_refuses_order_two():
    """A DF GP is square (D_in == D_out), so its flows are first order:
    order 2 raises in both flows instead of integrating an order-1 field,
    and a DF GP for an order-2 model cannot be built."""
    from vae_gp_ode_tpu_torch.dynamics.adjoint import flow_forward_adjoint
    rng = np.random.default_rng(31)
    _, tgp = _gp_pair(rng)
    ts_ = torch.arange(6, dtype=torch.float32) * 0.1
    for fn in (tflow.flow_forward, flow_forward_adjoint):
        with pytest.raises(ValueError, match='first order'):
            fn(tgp, None, torch.zeros(N, Q), ts_, order=2, device='cpu')
    with pytest.raises(ValueError, match='D_in == D_out'):
        tsvgp.init_svgp_params(rng, 2 * Q, Q, M, kernel='DF')


# -- train steps against JAX ---------------------------------------------------

def _jax_df_state(seed):
    """A JAX TrainState of a DF model at tests/test_torch_train.py's sizes
    with random BatchNorm statistics, lengthscales and variances within 2%
    of one value each, and a random q(u)."""
    model, variables, gp = jinit_model(
        jax.random.PRNGKey(seed), latent_dim=ttr.Q, n_filt=ttr.NF,
        num_features=ttr.S, num_inducing=ttr.M, kernel='DF', batch=2,
        T=ttr.T)
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(np.asarray, variables['batch_stats'])
    stats = {name: {bn: {'mean': 0.2 * rng.standard_normal(
        s['mean'].shape).astype(np.float32),
        'var': rng.uniform(0.5, 1.5, s['var'].shape).astype(np.float32)}
        for bn, s in sub.items()} for name, sub in stats.items()}
    q = ttr.Q
    ls = rng.uniform(0.6, 1.0) * (1 + 0.02 * rng.uniform(-1, 1, (q, q)))
    var = rng.uniform(0.3, 0.8) * (1 + 0.02 * rng.uniform(-1, 1, q))
    gp = gp.replace(
        kernel=RBFParams(jnp.asarray(np.log(np.expm1(ls)), jnp.float32),
                         jnp.asarray(np.log(np.expm1(var)), jnp.float32)),
        Um=jnp.asarray(rng.standard_normal((ttr.M, q)) * 0.3, jnp.float32),
        Us_sqrt=gp.Us_sqrt * 50.0)
    variables = {'params': variables['params'], 'batch_stats': stats}
    state, tx = jtrainer.create_train_state(model, variables, gp, lr=1e-3)
    return model, state, tx


def _jax_df_noise(key, L_, n=ttr.N):
    """The raw draws the JAX DF forward takes from `key` (as
    test_torch_train._jax_noise, with the DF kernel's 2S weights)."""
    k_enc, k_traj = jax.random.split(key)
    k_s, _ = jax.random.split(k_enc)
    noise = {'z0': jax.random.normal(k_s, (n, ttr.Q))}
    draws = []
    for k in jax.random.split(k_traj, L_):
        k_rff, k_u = jax.random.split(k)
        k_om, k_ph, k_w = jax.random.split(k_rff, 3)
        draws.append({
            'omega': jax.random.normal(k_om, (ttr.Q, ttr.S, ttr.Q)),
            'phase_u': jax.random.uniform(k_ph, (1, ttr.S, ttr.Q)),
            'weights': jax.random.normal(k_w, (2 * ttr.S, ttr.Q)),
            'epsilon': jax.random.normal(k_u, (ttr.M, ttr.Q), jnp.float32)})
    for name in draws[0]:
        noise[name] = jnp.stack([d[name] for d in draws])
    return {k: torch.as_tensor(np.array(v)) for k, v in noise.items()}


def _step_matches(L_, seed, **fields):
    """One full DF train step (loss, ELBO terms, nfe, every gradient)
    against JAX from one state with the same noise; `fields` set the
    models' solver settings."""
    model, jstate, _ = _jax_df_state(seed)
    model = model.clone(**fields)
    X = ttr._X(seed)
    key = jax.random.PRNGKey(seed + 1)

    def jloss(params):
        vae_params, gp = params
        (Xrec, s, v, nfe), _ = model.apply(
            {'params': vae_params, 'batch_stats': jstate.batch_stats},
            jnp.asarray(X), gp, key, L=L_, train=True,
            mutable=['batch_stats'])
        loss, nll, kl_reg, kl_u = jcompute_loss(
            jnp.asarray(X), Xrec, s, v, gp, ttr.NDATA, eps_guard=True)
        return loss, (nll, kl_reg, kl_u, nfe)

    (jl, jterms), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        (jstate.vae_params, jstate.gp))
    tstate = train_state_from_jax(ttr._np_state(jstate), latent_dim=ttr.Q,
                                  n_filt=ttr.NF, num_features=ttr.S,
                                  kernel='DF', device='cpu', **fields)
    assert tstate.gp.kernel_name == 'DF'
    tstate.model.train()
    before = dict(ops.LAUNCHES)
    loss, terms = trainer.loss_fn(tstate, torch.as_tensor(X), L_,
                                  ttr.NDATA, True,
                                  noise=_jax_df_noise(key, L_))
    loss.backward()
    assert ops.LAUNCHES == before
    for a, b in zip((loss,) + terms[:3], (jl,) + jterms[:3]):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-4)
    assert int(terms[3]) == int(jterms[3])
    ref = ttr._named(*jg)
    names = tstate.param_names()
    assert sorted(names) == sorted(ref)
    scale = ttr._grad_scales(names, ref, tstate.model)
    for name, p in zip(names, tstate.params()):
        err = np.abs(p.grad.numpy() - ref[name]).max()
        assert err <= ttr.GRAD_REL * scale[name], (name, err, scale[name])


@pytest.mark.parametrize('L_', [1, 5])
def test_df_train_step_matches_jax(L_):
    """The default DF step (euler: the fused pair's plain version)."""
    _step_matches(L_, 40 + L_)


@pytest.mark.parametrize('adjoint', [False, True])
def test_df_rk4_train_step_matches_jax(adjoint):
    """rk4 over fn_eval (the per-step kernels' plain version), by backprop
    and by the continuous adjoint (theta includes df_G).

    The seeds of these step tests give states where no decoder ReLU input
    lies within f32 rounding of 0 in one package and not in the other: at
    such a unit the two packages take different branches and the gradients
    move by 1e-3..2e-2 of a leaf's largest entry (PERF.md section 6;
    on the CPU at L=2, seeds 46 and 51 of `_jax_df_state` do so with rk4,
    51 in the adjoint too, and 50 and 55 with euler)."""
    _step_matches(2, 50 + 2 * adjoint, solver='rk4', use_adjoint=adjoint)


# -- the shipped checkpoint ------------------------------------------------------

def _ckpt_model():
    with open(os.path.join(CKPT, 'args.json')) as f:
        ta = types.SimpleNamespace(**__import__('json').load(f))
    from vae_gp_ode_tpu_torch.models.odegpvae import init_model
    model, gp = init_model(0, latent_dim=ta.latent_dim, n_filt=ta.n_filt,
                           num_features=ta.num_features,
                           num_inducing=ta.num_inducing, kernel=ta.kernel,
                           device='cpu')
    return ta, trainer.create_train_state(model, gp)


def test_shipped_df_checkpoint_restores_and_forecasts_as_jax():
    """checkpoints/df_5000ep read by restore_jax_checkpoint (numpy only)
    equals the JAX package's load_run_dir carried over by
    train_state_from_jax, leaf by leaf; then a 2-sequence, L=1, T=16
    eval-mode forecast in both packages with the same noise.

    Tolerances of the forecast, from what the CPU measured: the frames
    at t = 0 (the VAE alone) 1e-4 (measured 1.2e-5); every frame 0.05
    absolute and the mean 5e-4 (measured 0.0151 and 9.0e-5; pixels in
    [0, 1]). The trained (600, 600) gram is near-singular: its jittered,
    symmetrized condition number is 3.4e6 (float64), so each package's f32
    nu lies 1.3% / 2.0% (of its largest entry) from the float64 solution
    and 1.5% from the other's, f(x) 0.3% apart, and one euler step moves
    the frames by up to 0.002 (ROADMAP Queue C)."""
    from vae_gp_ode_tpu.serving import load_run_dir
    ta, state = _ckpt_model()
    checkpoint.restore_jax_checkpoint(
        os.path.join(CKPT, 'odegpvae_mnist.ckpt'), state)
    jmodel, jstate, _ = load_run_dir(CKPT)
    carried = train_state_from_jax(
        ttr._np_state(jstate), latent_dim=ta.latent_dim, n_filt=ta.n_filt,
        num_features=ta.num_features, kernel='DF', device='cpu')
    assert int(state.step) == int(carried.step) == int(jstate.step) > 0
    assert int(state.optimizer.count) == int(carried.optimizer.count)
    for (name, a), b in zip(zip(state.param_names(), state.params()),
                            carried.params()):
        assert torch.equal(a, b), name
    for a, b in zip(state.model.buffers(), carried.model.buffers()):
        assert torch.equal(a, b)
    assert torch.equal(state.optimizer.mu, carried.optimizer.mu)
    assert torch.equal(state.optimizer.nu, carried.optimizer.nu)

    X = ttr._X(60, n=2)
    X = np.concatenate([X, X], axis=1)[:, :16]         # T = 16
    key = jax.random.PRNGKey(61)
    jXrec = jmodel.apply({'params': jstate.vae_params,
                          'batch_stats': jstate.batch_stats},
                         jnp.asarray(X), jstate.gp, key, L=1,
                         train=False)[0]
    k_enc, k_traj = jax.random.split(key)
    k_s, _ = jax.random.split(k_enc)
    (k,) = jax.random.split(k_traj, 1)
    k_rff, k_u = jax.random.split(k)
    k_om, k_ph, k_w = jax.random.split(k_rff, 3)
    S_, M_, q = ta.num_features, ta.num_inducing, ta.latent_dim
    noise = {'z0': jax.random.normal(k_s, (2, q)),
             'omega': jax.random.normal(k_om, (1, q, S_, q)),
             'phase_u': jax.random.uniform(k_ph, (1, 1, S_, q)),
             'weights': jax.random.normal(k_w, (1, 2 * S_, q)),
             'epsilon': jax.random.normal(k_u, (1, M_, q), jnp.float32)}
    model = state.model.eval()
    with torch.no_grad():
        Xrec = model(torch.as_tensor(X), state.gp, L=1, noise={
            k: torch.as_tensor(np.array(v)) for k, v in noise.items()})[0]
    assert Xrec.shape == (1, 2, 16, 1, 28, 28)
    assert torch.isfinite(Xrec).all()
    err = np.abs(Xrec.numpy() - np.asarray(jXrec))
    assert err[:, :, 0].max() <= 1e-4      # t = 0: the VAE alone
    assert err.max() <= 0.05 and err.mean() <= 5e-4


def test_restore_jax_checkpoint_refuses_another_model():
    """The shipped DF checkpoint does not load into an RBF state (the
    treedef's kernel name) nor into an order-2 model (the leaf count), and
    nothing is copied before the check."""
    from vae_gp_ode_tpu_torch.models.odegpvae import init_model
    path = os.path.join(CKPT, 'odegpvae_mnist.ckpt')
    for kw, match in ((dict(), 'kernel'), (dict(order=2), 'leaves')):
        model, gp = init_model(0, device='cpu', **kw)
        state = trainer.create_train_state(model, gp)
        before = [p.detach().clone() for p in state.params()]
        with pytest.raises(ValueError, match=match):
            checkpoint.restore_jax_checkpoint(path, state)
        assert all(torch.equal(a, b) for a, b in zip(before, state.params()))
