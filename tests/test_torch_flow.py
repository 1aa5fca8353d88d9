"""Parity of the port's fused euler trajectory (ops.flow_fused) and
dynamics.flow with the JAX package, on the CPU at small sizes.

On the CPU the port's wrapper computes its kernel's plain version; it is
held against the JAX Pallas kernel run in interpret mode and against the
JAX `packed_flow_reference`, at orders 1 and 2, with uniform and
non-uniform step sizes. Tolerance 1e-5 (rtol and atol): f32 over 7 euler
steps of O(1) states.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_gp_ode_tpu.dynamics import flow as jflow
from vae_gp_ode_tpu.gp import svgp as jsvgp
from vae_gp_ode_tpu.kernels import rbf as jrbf
from vae_gp_ode_tpu.ops import flow_fused as jff

from vae_gp_ode_tpu_torch import ops
from vae_gp_ode_tpu_torch.dynamics import flow as tflow
from vae_gp_ode_tpu_torch.gp import svgp as tsvgp
from vae_gp_ode_tpu_torch.kernels.rbf import RBFParams
from vae_gp_ode_tpu_torch.ops import flow_fused as tff
from vae_gp_ode_tpu_torch.utils.jax_import import gp_from_jax

Q, S, M, N, T, L = 3, 32, 16, 5, 8, 2
TOL = dict(rtol=1e-5, atol=1e-5)


def _operands(rng, order, lead=()):
    """Raw flow operands (z0, omega, phase, weights, Z, nu, ls, var)."""
    D = Q * order
    f = np.float32
    return (rng.standard_normal((N, D)).astype(f) * 0.5,
            rng.standard_normal(lead + (D, S, Q)).astype(f),
            rng.uniform(0, 2 * np.pi, lead + (1, S, Q)).astype(f),
            rng.standard_normal(lead + (S, Q)).astype(f),
            rng.standard_normal((M, D)).astype(f),
            rng.standard_normal(lead + (Q, M)).astype(f) * 0.1,
            rng.uniform(0.8, 2.0, (Q, D)).astype(f),
            rng.uniform(0.3, 1.0, (Q,)).astype(f))


def _dts(rng, uniform):
    if uniform:
        return np.full(T - 1, 0.1, np.float32)
    return rng.uniform(0.03, 0.2, T - 1).astype(np.float32)


def _t(args):
    return [torch.as_tensor(a) for a in args]


@pytest.mark.parametrize('order', [1, 2])
@pytest.mark.parametrize('uniform', [True, False])
def test_flow_plain_matches_jax(order, uniform):
    rng = np.random.default_rng(10 * order + uniform)
    args = _operands(rng, order)
    dts = _dts(rng, uniform)
    before = dict(ops.LAUNCHES)
    out = tff.fused_euler_flow(*_t(args), torch.as_tensor(dts), T, order)
    assert ops.LAUNCHES == before           # CPU tensors: plain version
    assert out.shape == (T, N, Q * order)
    pallas = jff.fused_euler_flow(*map(jnp.asarray, args), jnp.asarray(dts),
                                  T, order, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **TOL)
    jpacked = jff._pack_operands(*map(jnp.asarray, args[1:]))
    ref = jff.packed_flow_reference(jnp.asarray(args[0]), *jpacked,
                                    jnp.asarray(dts), T, order)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # the port's own reference composition agrees too
    eref = tff.euler_flow_reference(*_t(args), torch.as_tensor(dts), T,
                                    order)
    np.testing.assert_allclose(out.numpy(), eref.numpy(), **TOL)


@pytest.mark.parametrize('order', [1, 2])
def test_pack_operands_match_jax(order):
    rng = np.random.default_rng(20 + order)
    args = _operands(rng, order)
    mine = tff._pack_operands(*_t(args[1:]))
    ref = jff._pack_operands(*map(jnp.asarray, args[1:]))
    for a, b in zip(mine, ref):
        assert a.is_contiguous()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize('order', [1, 2])
def test_batched_draws_match_per_draw_jax(order):
    """One call over a leading batch of L draws (shared z0 and GP
    operands) equals L single-draw JAX kernel runs."""
    rng = np.random.default_rng(30 + order)
    args = _operands(rng, order, lead=(L,))
    dts = _dts(rng, False)
    out = tff.fused_euler_flow(*_t(args), torch.as_tensor(dts), T, order)
    assert out.shape == (L, T, N, Q * order)
    for l in range(L):
        one = [a[l] if i in (1, 2, 3, 5) else a for i, a in enumerate(args)]
        ref = jff.fused_euler_flow(*map(jnp.asarray, one), jnp.asarray(dts),
                                   T, order, True)
        np.testing.assert_allclose(out[l].numpy(), np.asarray(ref), **TOL)


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


@pytest.mark.parametrize('order', [1, 2])
def test_flow_forward_matches_jax(order):
    rng = np.random.default_rng(40 + order)
    jgp, tgp = _gp_pair(rng, order)
    D = Q * order
    noise = {'omega': rng.standard_normal((L, D, S, Q)),
             'phase_u': rng.random((L, 1, S, Q)),
             'weights': rng.standard_normal((L, S, Q)),
             'epsilon': rng.standard_normal((L, M, Q))}
    noise = {k: v.astype(np.float32) for k, v in noise.items()}
    z0 = (rng.standard_normal((N, D)) * 0.5).astype(np.float32)
    ts = 0.1 * np.arange(T, dtype=np.float32)
    sample = tsvgp.draw_fn_sample(
        tgp, None, S, noise={k: torch.as_tensor(v) for k, v in noise.items()})
    zs, nfe = tflow.flow_forward(tgp, sample, torch.as_tensor(z0),
                                 torch.as_tensor(ts), order=order,
                                 device='cpu')
    assert zs.shape == (L, N, T, D) and nfe == L * (T - 1)
    for l in range(L):
        js = jsvgp.draw_fn_sample(
            jgp, None, S, noise={k: jnp.asarray(v[l])
                                 for k, v in noise.items()})
        ref, jnfe = jflow.flow_forward(jgp, js, jnp.asarray(z0),
                                       jnp.asarray(ts), order=order)
        assert int(jnfe) == T - 1
        np.testing.assert_allclose(zs[l].numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)


def test_flow_forward_rejects_what_is_not_ported():
    """What the flow still refuses: an unknown solver, order 3 and fewer
    than 2 time points. Every solver of dynamics.solvers and dense output
    are ported (tests/test_torch_solvers.py), the DF kernel
    (tests/test_torch_df.py) and the shared-lengthscale RBF kernel, whose
    params now build (tests/test_torch_shared_rbf.py)."""
    rng = np.random.default_rng(50)
    _, tgp = _gp_pair(rng, 1)
    z0 = torch.zeros(N, Q)
    ts = torch.arange(T, dtype=torch.float32) * 0.1
    assert not RBFParams(torch.zeros(Q), torch.zeros(1)).dimwise
    with pytest.raises(ValueError, match='unknown solver'):
        tflow.flow_forward(tgp, None, z0, ts, solver='rk45', device='cpu')
    with pytest.raises(ValueError):
        tflow.flow_forward(tgp, None, z0, ts, order=3, device='cpu')
    with pytest.raises(ValueError, match='2 time points'):
        tflow.flow_forward(tgp, None, z0, ts[:1], device='cpu')


# -- the dispatch rule for the fused pair (kernels #1 and #2) ---------------

def _bwd_smem_bytes(D, K, S, M, T):
    """The bound of the fused pair's rule, as csrc/flow_fused_bwd.cu's
    `flow_fused_bwd_smem_bytes` computes it (`rule_bytes`; the export is
    held to this in tests/test_torch_cuda_emulated_flow.py and on the GPU
    in tests/test_torch_cuda.py): the shared memory one block of the
    adjoint's parent design took (512 threads, 4 rows and the whole slab
    of cotangents), or the redesigned adjoint's block of an 8-block
    cluster where that were more (it never is)."""
    KS, KM = K * S, K * M
    slab = D * KS + 2 * KS + 2 * D * KM + 2 * KM + (T - 1)
    parent = 4 * (slab + 3 * 4 * D + 16 * (4 * D + 1))
    R = 4 if D <= 8 else 2
    items = -(-KS // 8) + -(-KM // 8)
    V = R * D + 1
    block8 = 4 * (2 * (2 * D + 2) * items + 3 * R * D + 8 * V + 2 * V)
    return max(parent, block8)


H100_SMEM_OPTIN = 232448      # bytes per block, cudaDevAttrMaxSharedMemoryPerBlockOptin


@pytest.mark.parametrize('order,q,S,fits', [
    (1, 6, 256, True),         # the default run
    (1, 6, 1024, True),        # 232,156 bytes
    (2, 6, 256, True),         # D = 12
    (1, 6, 2048, False),       # 428,764 bytes
    (1, 12, 256, False),       # 300,604 bytes
    (1, 12, 1024, False),      # the wide shape, 816,700 bytes
    (2, 8, 256, False),        # D = 16, 261,244 bytes
    (2, 9, 16, False)])        # D = 18 > 16
def test_fused_pair_rule_on_the_refused_shapes(order, q, S, fits):
    """The shapes of the adjoint kernel's refusals (ROADMAP Queue C #2):
    the rule sends them to the solvers before any launch."""
    from vae_gp_ode_tpu_torch.ops.flow_fused import pair_fits
    D = q * order
    assert pair_fits(D, _bwd_smem_bytes(D, q, S, 100, 16),
                     H100_SMEM_OPTIN) == fits
    assert not pair_fits(D, 1024, -1)      # an unreadable limit refuses


def test_euler_fallback_runs_the_solver_scan(monkeypatch):
    """Where the pair does not fit, euler at dense=1 integrates with the
    euler scan of dynamics.solvers over fn_eval: the same trajectory, nfe
    and gradients as the fused pair's plain version."""
    rng = np.random.default_rng(53)
    _, tgp = _gp_pair(rng, 1)
    noise = {'omega': rng.standard_normal((L, Q, S, Q)),
             'phase_u': rng.random((L, 1, S, Q)),
             'weights': rng.standard_normal((L, S, Q)),
             'epsilon': rng.standard_normal((L, M, Q))}
    z0 = torch.as_tensor((rng.standard_normal((N, Q)) * 0.5).astype(
        np.float32))
    ts = torch.as_tensor((0.1 * np.arange(T)).astype(np.float32))
    out = {}
    for fused in (True, False):
        monkeypatch.setattr(tflow, 'use_fused_pair',
                            lambda *a, fused=fused: fused)
        gp = tgp.detach().requires_grad_()
        sample = tsvgp.draw_fn_sample(gp, None, S, noise={
            k: torch.as_tensor(v, dtype=torch.float32)
            for k, v in noise.items()})
        zs, nfe = tflow.flow_forward(gp, sample, z0, ts, device='cpu')
        grads = torch.autograd.grad((zs * zs).sum(), gp.parameters()[:3])
        out[fused] = (zs.detach(), nfe, grads)
    np.testing.assert_allclose(out[False][0].numpy(), out[True][0].numpy(),
                               **TOL)
    assert out[False][1] == out[True][1] == L * (T - 1)
    for a, b in zip(out[False][2], out[True][2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


def test_cuda_default_raises_without_a_gpu(monkeypatch):
    """The entry point defaults to the GPU; with none present it raises
    instead of silently computing on the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    rng = np.random.default_rng(51)
    _, tgp = _gp_pair(rng, 1)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tflow.flow_forward(tgp, None, torch.zeros(N, Q),
                           torch.arange(T, dtype=torch.float32))


def test_packed_wrapper_rejects_mixed_devices():
    rng = np.random.default_rng(52)
    args = _operands(rng, 1)
    packed = tff._pack_operands(*_t(args[1:]))
    dts = torch.full((T - 1,), 0.1)
    meta = torch.zeros(N, Q, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        tff.packed_euler_flow(meta, *packed, dts, T, 1)


# -- the backward: the port's plain adjoint against the JAX Pallas kernel #2
# (interpret mode); tolerance 1e-5 of each cotangent's largest entry: f32
# sums over N rows, 7 steps and K*S columns taken in different orders

_VJP_NAMES = ('z0', 'omf', 'phf', 'ws', 'Zb', 'zn', 'il2', 'nus', 'dts')


def _assert_cotangents(mine, ref, rel=1e-5):
    assert len(mine) == len(ref) == len(_VJP_NAMES)
    for name, a, b in zip(_VJP_NAMES, mine, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        tol = rel * max(np.abs(b).max(), 1e-30)
        err = np.abs(a - b).max()
        assert err <= tol, f'{name}: max err {err:.3e} > {tol:.3e}'


def _packed_case(seed, order, uniform, lead=()):
    rng = np.random.default_rng(seed)
    args = _operands(rng, order, lead=lead)
    dts = _dts(rng, uniform)
    packed = [p.numpy() for p in tff._pack_operands(*_t(args[1:]))]
    return rng, args[0], packed, dts


def _jax_vjp(z0, packed, dts, zsbar, order):
    _, vjp = jax.vjp(
        lambda *a: jff.packed_euler_flow(*a, T, order, True),
        *map(jnp.asarray, [z0] + list(packed) + [dts]))
    return vjp(jnp.asarray(zsbar))


@pytest.mark.parametrize('order', [1, 2])
@pytest.mark.parametrize('uniform', [True, False])
def test_flow_vjp_reference_matches_jax_kernel(order, uniform):
    rng, z0, packed, dts = _packed_case(60 + 10 * order + uniform, order,
                                        uniform)
    zs = tff.packed_flow_reference(*_t([z0] + packed + [dts]), T, order)
    zsbar = rng.standard_normal(zs.shape).astype(np.float32)
    mine = tff.packed_flow_vjp_reference(
        zs, torch.as_tensor(zsbar), *_t(packed + [dts]), T, order)
    _assert_cotangents(mine, _jax_vjp(z0, packed, dts, zsbar, order))


@pytest.mark.parametrize('order', [1, 2])
def test_flow_vjp_reference_matches_jax_tiled_slabs(order, monkeypatch):
    """The JAX kernel's grid-tiled variant (one cotangent slab per batch
    tile, summed by its wrapper; N=5 in tiles of 2 with a padded row)."""
    monkeypatch.setattr(jff, '_SINGLE_BLOCK_N', 2)
    monkeypatch.setattr(jff, '_TILE_N', 2)
    rng, z0, packed, dts = _packed_case(80 + order, order, False)
    zs = tff.packed_flow_reference(*_t([z0] + packed + [dts]), T, order)
    zsbar = rng.standard_normal(zs.shape).astype(np.float32)
    mine = tff.packed_flow_vjp_reference(
        zs, torch.as_tensor(zsbar), *_t(packed + [dts]), T, order)
    _assert_cotangents(mine, _jax_vjp(z0, packed, dts, zsbar, order))


def test_flow_vjp_over_draws_sums_shared_operands():
    """L draws in one call: per-draw operands get per-draw cotangents, the
    operands all draws share (Zb, zn, il2, dts) get the sum of the
    per-draw JAX cotangents, and z0bar comes out per draw."""
    order = 1
    rng, z0, packed, dts = _packed_case(90, order, False, lead=(L,))
    zs = tff.packed_flow_reference(*_t([z0] + packed + [dts]), T, order)
    assert zs.shape == (L, T, N, Q)
    zsbar = rng.standard_normal(zs.shape).astype(np.float32)
    mine = tff.packed_flow_vjp_reference(
        zs, torch.as_tensor(zsbar), *_t(packed + [dts]), T, order)
    per_draw = [_jax_vjp(z0, [p[l] if p.ndim == 3 else p for p in packed],
                         dts, zsbar[l], order) for l in range(L)]
    ref = []
    for i, name in enumerate(_VJP_NAMES):
        if name in ('z0', 'omf', 'phf', 'ws', 'nus'):
            ref.append(np.stack([np.asarray(c[i]) for c in per_draw]))
        else:
            ref.append(sum(np.asarray(c[i]) for c in per_draw))
    _assert_cotangents(mine, ref)


def test_cpu_autograd_and_vjp_take_the_plain_version():
    """On CPU tensors, autograd through packed_euler_flow and
    packed_flow_vjp both give packed_flow_vjp_reference, launching
    nothing."""
    order = 1
    rng, z0, packed, dts = _packed_case(97, order, True, lead=(L,))
    inputs = [torch.as_tensor(x).requires_grad_()
              for x in [z0] + packed + [dts]]
    before = dict(ops.LAUNCHES)
    zs = tff.packed_euler_flow(*inputs, T, order)
    zsbar = torch.as_tensor(rng.standard_normal(zs.shape).astype(np.float32))
    grads = torch.autograd.grad(zs, inputs, zsbar)
    vjp = tff.packed_flow_vjp(zs.detach(), zsbar, *_t(packed + [dts]), T,
                              order)
    assert ops.LAUNCHES == before
    ref = tff.packed_flow_vjp_reference(zs.detach(), zsbar,
                                        *_t(packed + [dts]), T, order)
    # z0 is shared by the draws: its cotangent is their sum
    _assert_cotangents(grads, (ref[0].sum(0),) + tuple(ref[1:]), rel=1e-6)
    for a, b in zip(vjp, ref):
        assert torch.equal(a, b)
