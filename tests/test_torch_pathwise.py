"""Parity of the port's per-step pathwise evaluation (ops.pathwise) with
the JAX package, on the CPU at small sizes.

On the CPU the port's wrappers compute the kernels' plain versions; they
are held against the JAX Pallas kernels run in interpret mode (forward
`_pathwise_kernel`, VJP `_pathwise_bwd_kernel` through
`fused_pathwise_eval`). Tolerances: outputs 1e-5 (rtol and atol), each
cotangent 1e-5 of its largest entry: f32 sums over up to 33 features,
13 inducing points and 7 rows in different orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_gp_ode_tpu.ops import pathwise as jpw

from vae_gp_ode_tpu_torch import ops
from vae_gp_ode_tpu_torch.gp import svgp as tsvgp
from vae_gp_ode_tpu_torch.ops import pathwise as tpw
import torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
VJP_REL = 1e-5
NAMES = ('x',) + tpw.NAMES


def _operands(rng, N=7, D=4, S=33, M=13, K=3, lead=()):
    """(x, omega, phase, weights, Z, nu, ls, var) with draw operands and x
    under `lead`."""
    f = np.float32
    return (rng.standard_normal(lead + (N, D)).astype(f) * 0.7,
            rng.standard_normal(lead + (D, S, K)).astype(f),
            rng.uniform(0, 2 * np.pi, lead + (1, S, K)).astype(f),
            rng.standard_normal(lead + (S, K)).astype(f),
            rng.standard_normal((M, D)).astype(f),
            rng.standard_normal(lead + (K, M)).astype(f) * 0.3,
            rng.uniform(0.5, 2.0, (K, D)).astype(f),
            rng.uniform(0.3, 1.0, (K,)).astype(f))


def _t(args):
    return [torch.as_tensor(a) for a in args]


def _assert_cotangents(mine, ref, rel=VJP_REL):
    assert len(mine) == len(ref) == len(NAMES)
    for name, a, b in zip(NAMES, mine, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        err = np.abs(a - b).max()
        tol = rel * max(np.abs(b).max(), 1e-30)
        assert err <= tol, f'{name}: max err {err:.3e} > {tol:.3e}'


def _jax_vjp(args, g):
    _, vjp = jax.vjp(lambda *a: jpw.fused_pathwise_eval(*a, interpret=True),
                     *map(jnp.asarray, args))
    return vjp(jnp.asarray(g))


@pytest.mark.parametrize('shape', [dict(), dict(N=20, D=6, S=64, M=16, K=6),
                                   dict(N=1, D=1, S=1, M=1, K=1)])
def test_plain_eval_matches_jax_kernel(shape):
    rng = np.random.default_rng(len(shape))
    args = _operands(rng, **shape)
    before = dict(ops.LAUNCHES)
    out = tpw.fused_pathwise_eval(*_t(args))
    assert ops.LAUNCHES == before            # CPU tensors: plain version
    ref = jpw.fused_pathwise_eval(*map(jnp.asarray, args), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jpw.pathwise_eval_reference(
            *map(jnp.asarray, args))), **TOL)


@pytest.mark.parametrize('shape', [dict(), dict(N=20, D=6, S=64, M=16, K=6)])
def test_plain_vjp_matches_jax_kernel(shape):
    """Autograd through the plain version against the JAX custom VJP,
    whose backward is the Pallas kernel `_pathwise_bwd_kernel`."""
    rng = np.random.default_rng(10 + len(shape))
    args = _operands(rng, **shape)
    g = rng.standard_normal((args[0].shape[0], args[-1].shape[0])).astype(
        np.float32)
    mine = tpw.pathwise_vjp_reference(*_t(args), torch.as_tensor(g))
    _assert_cotangents(mine, _jax_vjp(args, g))
    # the wrapper's own backward on CPU tensors is the same computation
    inputs = [t.requires_grad_() for t in _t(args)]
    grads = torch.autograd.grad(tpw.fused_pathwise_eval(*inputs), inputs,
                                torch.as_tensor(g))
    _assert_cotangents(grads, mine, rel=1e-6)


def test_batched_draws_match_per_draw_jax():
    """One call over L draws (shared Z, ls, var) equals L single-draw JAX
    kernel runs, forward and VJP: the draw operands' cotangents per draw,
    the shared operands' the sum over the draws."""
    L = 3
    rng = np.random.default_rng(20)
    args = _operands(rng, lead=(L,))
    out = tpw.fused_pathwise_eval(*_t(args))
    g = rng.standard_normal(out.shape).astype(np.float32)
    mine = tpw.pathwise_vjp_reference(*_t(args), torch.as_tensor(g))
    per_draw = []
    for l in range(L):
        one = [a[l] if i in (0, 1, 2, 3, 5) else a
               for i, a in enumerate(args)]
        ref = jpw.fused_pathwise_eval(*map(jnp.asarray, one), interpret=True)
        np.testing.assert_allclose(out[l].numpy(), np.asarray(ref), **TOL)
        per_draw.append(_jax_vjp(one, g[l]))
    ref = []
    for i in range(len(NAMES)):
        parts = [np.asarray(c[i]) for c in per_draw]
        ref.append(np.stack(parts) if i in (0, 1, 2, 3, 5) else sum(parts))
    _assert_cotangents(mine, ref)


def test_per_draw_gp_operands_match_shared():
    """Z, ls and var with a leading dim of draws (as the continuous
    adjoint passes them) give the shared-operand values, and per-draw
    cotangents that sum to the shared ones."""
    L = 2
    rng = np.random.default_rng(30)
    args = _t(_operands(rng, lead=(L,)))
    per = list(args)
    for i in (4, 6, 7):
        per[i] = args[i].expand((L,) + tuple(args[i].shape)).contiguous()
    out = tpw.pathwise_eval_reference(*args)
    np.testing.assert_allclose(tpw.pathwise_eval_reference(*per).numpy(),
                               out.numpy(), rtol=1e-6, atol=1e-6)
    g = torch.as_tensor(rng.standard_normal(out.shape).astype(np.float32))
    shared = tpw.pathwise_vjp_reference(*args, g)
    mine = tpw.pathwise_vjp_reference(*per, g)
    for i in (4, 6, 7):
        assert mine[i].shape == per[i].shape
        np.testing.assert_allclose(mine[i].sum(0).numpy(),
                                   shared[i].numpy(), rtol=1e-5, atol=1e-6)


def test_fn_eval_on_the_cpu_is_the_plain_composition():
    """gp.svgp.fn_eval on CPU tensors is the plain pathwise eval on the
    fused operand block, with a batch of draws, launches nothing, and
    equals the composition of the RBF functions of kernels.rbf."""
    from vae_gp_ode_tpu_torch.kernels.rbf import (
        init_rbf_params, rbf_f_update, rbf_rff_eval)
    rng = np.random.default_rng(50)
    gp = tsvgp.init_svgp_params(rng, 4, 3, 8, lengthscale=1.2,
                                variance=0.8)
    gp.kernel = init_rbf_params(4, 3, lengthscale=1.1, variance=0.7)
    sample = tsvgp.draw_fn_sample(gp, torch.Generator().manual_seed(0), 16,
                                  L=2)
    x = torch.as_tensor(rng.standard_normal((2, 5, 4)).astype(np.float32))
    before = dict(ops.LAUNCHES)
    out = tsvgp.fn_eval(gp, sample, x)
    assert ops.LAUNCHES == before
    ref = tpw.pathwise_eval_reference(x, *tpw.rbf_fused_operands(gp, sample))
    assert torch.equal(out, ref)
    comp = (rbf_rff_eval(gp.kernel, sample.rff, x)
            + rbf_f_update(gp.kernel, sample.nu, x, gp.inducing_loc))
    np.testing.assert_allclose(out.numpy(), comp.numpy(), rtol=2e-5,
                               atol=2e-6)


def test_wrapper_checks_draws_and_devices():
    rng = np.random.default_rng(60)
    args = _t(_operands(rng, lead=(2,)))
    with pytest.raises(ValueError, match='one leading dim'):
        tpw._draws(args[0][None], args[1:])
    bad = list(args)
    bad[5] = bad[5][:1].expand(3, *bad[5].shape[1:])
    with pytest.raises(ValueError, match='one leading dim'):
        tpw._draws(bad[0], bad[1:])
    assert tpw._draws(args[0], args[1:]) == 2
    assert tpw._draws(args[0][0], [a[0] if a.dim() > nd else a for a, nd in
                                   zip(args[1:], tpw._BASE_DIMS)]) is None
    meta = torch.zeros(args[0].shape, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        tpw.fused_pathwise_eval(meta, *args[1:])
    with pytest.raises(ValueError, match='expected'):
        tpw._check(args[0], [args[1][..., :2]] + args[2:])
