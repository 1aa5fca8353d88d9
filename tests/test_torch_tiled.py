"""Parity of the port's grid-tiled per-step evaluations (ops.pathwise_tiled,
kernels #9/#10; ops.df_pathwise_tiled, kernels #11/#12) and of the wide
path (q = D = 12) with the JAX package, on the CPU at small sizes.

On the CPU the port's tiled wrappers compute their plain versions
(`pathwise_eval_reference`, `df_pathwise_reference`); they are held
against the JAX package's tiled Pallas kernels run in interpret mode with
several feature chunks (`tiled_pathwise_eval(..., s_tile=)`,
`tiled_df_pathwise_eval(..., sd_tile=)`), at the JAX tests' shapes
(tests/test_ops_pallas.py) and with draws that share the GP operands.
Tolerances, the JAX tests' own for kernel against reference: outputs
2e-5 abs + 2e-4 rel; cotangents 1e-5 abs + 1e-3 rel (RBF), 2e-3 rel (DF).
The RBF tiled VJP takes a while in interpret mode (the JAX package marks
its own test slow): its case here is the smallest shape with two feature
chunks.

The card's dispatch rule is checked at the sweep's shapes with the card's
properties stubbed (132 SMs, 232,448 bytes of shared memory per block).
Then one train step of the wide path at a narrow size (q = D_in = D_out =
12, S = 64, M = 16, batch 4, n_filt 4), RBF and DF, against the JAX
package's step with the same noise, with the euler flow sent through
`fn_eval` as on the card (the fused pairs refuse q = 12 there): ELBO
terms 1e-4 relative, gradients 1e-4 of each leaf's largest, as in
tests/test_torch_train.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_gp_ode_tpu.kernels.rbf import RBFParams
from vae_gp_ode_tpu.models.odegpvae import init_model as jinit_model
from vae_gp_ode_tpu.ops.df_pathwise_tiled import (
    tiled_df_pathwise_eval as jax_tiled_df)
from vae_gp_ode_tpu.ops.pathwise_tiled import (
    tiled_pathwise_eval as jax_tiled_rbf)
from vae_gp_ode_tpu.training import trainer as jtrainer
from vae_gp_ode_tpu.training.objectives import compute_loss as jcompute_loss

from vae_gp_ode_tpu_torch import ops
from vae_gp_ode_tpu_torch.dynamics import flow as tflow
from vae_gp_ode_tpu_torch.ops import _build
from vae_gp_ode_tpu_torch.ops import df_pathwise
from vae_gp_ode_tpu_torch.ops import df_pathwise_tiled as tdpt
from vae_gp_ode_tpu_torch.ops import pathwise as tpw
from vae_gp_ode_tpu_torch.ops import pathwise_tiled as tpt
from vae_gp_ode_tpu_torch.training import trainer
from vae_gp_ode_tpu_torch.utils.jax_import import train_state_from_jax

import test_torch_train as ttr
from emulated_df_common import VJP_PLANS

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
RBF_VJP_TOL = dict(rtol=1e-3, atol=1e-5)
DF_VJP_TOL = dict(rtol=2e-3, atol=1e-5)
RBF_NAMES = ('x',) + tpw.NAMES
DF_NAMES = ('x',) + tdpt.NAMES
#: the card's properties the rule is checked with (an H100 SXM)
SMS, OPTIN = 132, 232448


def _rbf_operands(rng, N, S, M, D, K, lead=()):
    """(x, omega, phase, weights, Z, nu, ls, var) as the JAX tests draw
    them; the draw operands and x under `lead`, Z, ls and var shared."""
    f = np.float32
    return (rng.standard_normal(lead + (N, D)).astype(f),
            rng.standard_normal(lead + (D, S, K)).astype(f),
            (rng.random(lead + (1, S, K)) * 2 * np.pi).astype(f),
            rng.standard_normal(lead + (S, K)).astype(f),
            rng.standard_normal((M, D)).astype(f),
            rng.standard_normal(lead + (K, M)).astype(f),
            rng.uniform(0.5, 2.0, (K, D)).astype(f),
            rng.uniform(0.3, 1.0, (K,)).astype(f))


def _df_operands(rng, N, S, M, D, lead=()):
    """(x, omf, phf, G, Z, nur, ls2, var) as the JAX tests draw them."""
    f = np.float32
    SD = S * D
    return ((rng.standard_normal(lead + (N, D)) * 0.5).astype(f),
            rng.standard_normal(lead + (D, SD)).astype(f),
            (rng.random(lead + (1, SD)) * 6.28).astype(f),
            (rng.standard_normal(lead + (2 * SD, D)) * 0.3).astype(f),
            rng.standard_normal((M, D)).astype(f),
            (rng.standard_normal(lead + (M, D)) * 0.1).astype(f),
            rng.uniform(0.8, 3.0, (D, D)).astype(f),
            rng.uniform(0.3, 1.0, (D,)).astype(f))


def _t(args):
    return [torch.as_tensor(a) for a in args]


def _jax_draws(fn, args, lead):
    """fn over a leading dim of draws of x and the draw operands (Z, ls or
    ls2 and var shared), as the port's one call over L draws."""
    if not lead:
        return fn(*map(jnp.asarray, args))
    axes = (0, 0, 0, 0, None, 0, None, None)
    return jax.vmap(fn, in_axes=axes)(*map(jnp.asarray, args))


@pytest.mark.parametrize('shape,s_tile,lead', [
    (dict(N=6, S=16, M=8, D=4, K=4), None, ()),
    (dict(N=5, S=96, M=9, D=3, K=3), 32, ()),          # 3 chunks
    (dict(N=4, S=64, M=7, D=12, K=12), None, ()),      # q = 12
    (dict(N=5, S=64, M=9, D=12, K=12), 32, (3,))])     # draws, 2 chunks
def test_rbf_plain_matches_jax_tiled_kernel(shape, s_tile, lead):
    args = _rbf_operands(np.random.default_rng(11), lead=lead, **shape)
    before = dict(ops.LAUNCHES)
    out = tpt.tiled_pathwise_eval(*_t(args))
    routed = tpt.pathwise_eval(*_t(args))
    assert ops.LAUNCHES == before             # CPU tensors: plain version
    ref = _jax_draws(lambda *a: jax_tiled_rbf(*a, interpret=True,
                                              s_tile=s_tile), args, lead)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD_TOL)
    np.testing.assert_array_equal(routed.numpy(), out.numpy())


@pytest.mark.parametrize('shape,sd_tile,lead', [
    (dict(N=5, S=8, M=7, D=4), None, ()),
    (dict(N=5, S=24, M=7, D=4), 32, ()),               # 3 chunks
    (dict(N=4, S=16, M=9, D=12), None, ()),            # D = 12
    (dict(N=4, S=16, M=9, D=12), 96, (3,))])           # draws, 2 chunks
def test_df_plain_matches_jax_tiled_kernel(shape, sd_tile, lead):
    args = _df_operands(np.random.default_rng(14), lead=lead, **shape)
    before = dict(ops.LAUNCHES)
    out = tdpt.tiled_df_pathwise_eval(*_t(args))
    routed = tdpt.df_pathwise_eval(*_t(args))
    assert ops.LAUNCHES == before
    ref = _jax_draws(lambda *a: jax_tiled_df(*a, interpret=True,
                                             sd_tile=sd_tile), args, lead)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD_TOL)
    np.testing.assert_array_equal(routed.numpy(), out.numpy())


def _assert_vjp_matches(tiled, jax_fn, args, names, tol):
    """Every cotangent of the JAX tiled kernel's VJP (interpret mode)
    against autograd through the port's plain version, for the cotangent
    the JAX tests use (out weighted by its flat index)."""
    inputs = [t.requires_grad_() for t in _t(args)]
    out = tiled(*inputs)
    g = np.arange(out.numel(), dtype=np.float32).reshape(tuple(out.shape))
    mine = torch.autograd.grad(out, inputs, torch.as_tensor(g))
    _, vjp = jax.vjp(jax_fn, *map(jnp.asarray, args))
    for name, a, b in zip(names, mine, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **tol)


def test_rbf_plain_vjp_matches_jax_tiled_kernel():
    """Two feature chunks of 16 (S = 32), K = 5 output dims."""
    args = _rbf_operands(np.random.default_rng(12), N=6, S=32, M=8, D=4,
                         K=5)
    _assert_vjp_matches(tpt.tiled_pathwise_eval, lambda *a: jax_tiled_rbf(
        *a, interpret=True, s_tile=16), args, RBF_NAMES, RBF_VJP_TOL)


def test_df_plain_vjp_matches_jax_tiled_kernel():
    """Three ORFF chunks of 32 (S*D = 96)."""
    args = _df_operands(np.random.default_rng(15), N=5, S=24, M=7, D=4)
    _assert_vjp_matches(tdpt.tiled_df_pathwise_eval, lambda *a: jax_tiled_df(
        *a, interpret=True, sd_tile=32), args, DF_NAMES, DF_VJP_TOL)


# -- the card's dispatch rule ----------------------------------------------------

# (D, K, S) -> {(L, N): (forward tiled, VJP tiled)} on an H100: refit to
# the redesigned #3/#10 from the sweep in chip_smoke.py phase 6d (PERF.md
# section 6): the VJP tiled wherever #10's block fits, the forward tiled
# for S + M > 768 from L*N*K*(S + M) = 8e6
RBF_RULE = {
    (6, 6, 256): {(1, 20): (False, True), (5, 20): (False, True),
                  (1, 600): (False, True), (5, 600): (False, True)},
    (12, 12, 256): {(1, 20): (False, True), (5, 20): (False, True),
                    (1, 600): (False, True), (5, 600): (False, True)},
    (6, 6, 1024): {(1, 20): (False, True), (5, 20): (False, True),
                   (1, 600): (False, True), (5, 600): (True, True)},
    (6, 6, 2048): {(1, 20): (False, True), (5, 20): (False, True),
                   (1, 600): (False, True), (5, 600): (True, True)},
    (12, 12, 1024): {(1, 20): (False, True), (5, 20): (False, True),
                     (1, 600): (True, True), (5, 600): (True, True)}}
# (D, S) -> {(L, N): (forward tiled, VJP tiled)}: refit to the redesigned
# #11/#12 (PERF.md section 6); the forward at D <= 8 checked again against
# the redesigned #5 (the sweep kept it at every D <= 8 shape); the VJP
# refit to the redesigned #6, which also takes (6, 512) at L=1, N=600
# (0.12 against #12's 0.23 ms per call in the sweep)
DF_RULE = {
    (6, 256): {(1, 20): (False, True), (5, 20): (False, True),
               (1, 600): (False, False), (5, 600): (False, True)},
    (6, 512): {(1, 20): (False, True), (5, 20): (False, True),
               (1, 600): (False, False), (5, 600): (False, True)},
    (12, 256): {(1, 20): (True, True), (5, 20): (True, True),
                (1, 600): (True, True), (5, 600): (True, True)},
    (12, 1024): {(1, 20): (True, True), (5, 20): (True, True),
                 (1, 600): (True, True), (5, 600): (True, True)}}


@pytest.mark.parametrize('D,K,S', sorted(RBF_RULE))
def test_rbf_rule_at_the_sweep_shapes(D, K, S):
    got = {LN: tpt.pick(*LN, D, K, S, 100, OPTIN)
           for LN in RBF_RULE[D, K, S]}
    assert got == RBF_RULE[D, K, S]


def _pick_df(L, N, D, SD, M):
    """`pick_df` on an H100 (132 SMs) with #6's plan there (None above
    D = 16, where only the tiled pair takes the shape)."""
    return tdpt.pick_df(L, N, D, SD, M, SMS, VJP_PLANS.get((L, N, D, SD, M)))


@pytest.mark.parametrize('D,S', sorted(DF_RULE))
def test_df_rule_at_the_sweep_shapes(D, S):
    got = {LN: _pick_df(*LN, D, S * D, 100) for LN in DF_RULE[D, S]}
    assert got == DF_RULE[D, S]


def test_rule_at_the_rows_of_the_smoke_paths():
    """The kernels chip_smoke.py's paths rely on: the wide configuration
    (q = 12, S = 1024) at batch 20 takes #3 and #10 (RBF), #11 and #12
    (DF); a wide request of 400 sequences takes #9 (RBF) and #11 (DF);
    rk4 steps of 160 sequences at the main widths (q = 6, S = 256) take
    #3/#10 (RBF) and, at L = 5, #5/#12 (DF; at L = 1 the redesigned #6
    takes the VJP: ~26 us modelled against #12's ~54), and at batch 20
    #3/#10 and #5/#12; RBF rk4 steps at q = 72, wider than #10's block
    holds, take #3/#4; DF rk4 steps at L = 1 with 600 sequences take
    #5/#6."""
    for L in (1, 5):
        assert tpt.pick(L, 20, 12, 12, 1024, 100, OPTIN) == (False, True)
        assert _pick_df(L, 20, 12, 12288, 100) == (True, True)
        assert tpt.pick(L, 160, 6, 6, 256, 100, OPTIN) == (False, True)
        assert _pick_df(L, 160, 6, 1536, 100) == (False, L == 5)
        assert tpt.pick(L, 20, 6, 6, 256, 100, OPTIN) == (False, True)
        assert _pick_df(L, 20, 6, 1536, 100) == (False, True)
        assert tpt.pick(L, 20, 72, 72, 256, 100, OPTIN) == (False, False)
    assert tpt.pick(5, 400, 12, 12, 1024, 100, OPTIN)[0]
    assert _pick_df(5, 400, 12, 12288, 100)[0]
    assert _pick_df(1, 600, 6, 1536, 100) == (False, False)


def test_rule_kernels_name_the_picked_pair(monkeypatch):
    """`rule_kernels` turns each rule's choice into the kernels' names,
    from the card properties `ops.card_properties` reads and #6's plans
    (both stubbed)."""
    from vae_gp_ode_tpu_torch import ops
    monkeypatch.setattr(ops, '_properties', lambda index: (SMS, OPTIN))
    monkeypatch.setattr(df_pathwise, 'bwd_plan',
                        lambda L, N, D, SD, M, device: VJP_PLANS[
                            L, N, D, SD, M])
    dev = torch.device('cuda', 0)
    assert tpt.rule_kernels(5, 20, 12, 12, 1024, 100, dev) == (
        'pathwise_fwd', 'pathwise_tiled_bwd')
    assert tpt.rule_kernels(5, 400, 12, 12, 1024, 100, dev) == (
        'pathwise_tiled_fwd', 'pathwise_tiled_bwd')
    assert tpt.rule_kernels(5, 160, 6, 6, 256, 100, dev) == (
        'pathwise_fwd', 'pathwise_tiled_bwd')
    assert tpt.rule_kernels(5, 20, 72, 72, 256, 100, dev) == (
        'pathwise_fwd', 'pathwise_bwd')
    assert tdpt.rule_kernels(5, 20, 12, 12288, 100, dev) == (
        'df_pathwise_tiled_fwd', 'df_pathwise_tiled_bwd')
    assert tdpt.rule_kernels(5, 400, 12, 12288, 100, dev) == (
        'df_pathwise_tiled_fwd', 'df_pathwise_tiled_bwd')
    assert tdpt.rule_kernels(5, 160, 6, 1536, 100, dev) == (
        'df_pathwise_fwd', 'df_pathwise_tiled_bwd')
    assert tdpt.rule_kernels(1, 600, 6, 1536, 100, dev) == (
        'df_pathwise_fwd', 'df_pathwise_bwd')


def test_rbf_rule_keeps_the_single_block_vjp_where_the_tiled_block_is_too_big():
    """#10's inducing-point block holds its rows, Z, the tile's per-row
    terms, its points' dZ, dls and dnu sums and the warps' dx terms in
    shared memory
    (`tiled_bwd_smem_bytes`, csrc/pathwise_tiled_bwd.cu): a state dim
    whose block exceeds the opt-in limit goes to #4."""
    assert tpt.tiled_bwd_smem_bytes(12) == 4 * (
        240 + 12 + 864 + 1344 + 4 * 25 * 64 + 3072)
    D = 66
    assert tpt.tiled_bwd_smem_bytes(D) > OPTIN >= tpt.tiled_bwd_smem_bytes(
        D - 1)
    assert tpt.pick(5, 20, D - 1, 12, 1024, 100, OPTIN)[1]
    assert not tpt.pick(5, 20, D, 12, 1024, 100, OPTIN)[1]


# -- the CPU path ----------------------------------------------------------------

def _no_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f'the CPU path loaded lib{name}.so')
    monkeypatch.setattr(_build, 'load', refuse)


def test_cpu_path_never_touches_a_library(monkeypatch):
    """Forward and reverse mode on CPU tensors through every entry of the
    two modules load no kernel and count no launch."""
    _no_library(monkeypatch)
    rng = np.random.default_rng(3)
    before = dict(ops.LAUNCHES)
    for fn, args in (
            (tpt.tiled_pathwise_eval, _rbf_operands(rng, 4, 16, 5, 3, 3)),
            (tpt.pathwise_eval, _rbf_operands(rng, 4, 16, 5, 3, 3, (2,))),
            (tdpt.tiled_df_pathwise_eval, _df_operands(rng, 4, 8, 5, 3)),
            (tdpt.df_pathwise_eval, _df_operands(rng, 4, 8, 5, 3, (2,)))):
        inputs = [t.requires_grad_() for t in _t(args)]
        out = fn(*inputs)
        grads = torch.autograd.grad(out.sum(), inputs)
        assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert ops.LAUNCHES == before


def test_df_wrappers_take_state_dims_above_48(monkeypatch):
    """The tiled DF kernels (#11/#12) take any state dim: at D = 49 and 64
    each wrapper passes its checks and calls its library's launcher with
    that D (a stub library here, recording the call; the kernels
    themselves run under tests/test_torch_cuda_emulated.py and on the
    card) and counts one launch, raising no NotImplementedError. The VJP
    refuses D = 2049 (a feature column's threads), naming the limit. The
    single-block pair still refuses D = 17, naming its limit, before it
    loads a library; the plain version takes any D."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            def fn(*args):
                calls.append((name, args))
                return 0
            fn.argtypes = fn.restype = None
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, 'load', lambda name: Lib())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: type('S', (), {'cuda_stream': 0}))
    for D in (49, 64):
        args = _t(_df_operands(np.random.default_rng(D), 3, 2, 4, D, (1,)))
        x, operands = args[0], tuple(args[1:])
        before = dict(ops.LAUNCHES)
        del calls[:]
        out = tdpt._launch(x, operands)
        bars = tdpt._launch_bwd(x, operands, torch.zeros_like(x))
        assert out.shape == x.shape and len(bars) == 8
        launched = [(name, args) for name, args in calls
                    if name in (tdpt.KERNEL, tdpt.BWD_KERNEL)]
        assert [name for name, _ in launched] == [tdpt.KERNEL,
                                                  tdpt.BWD_KERNEL]
        # L, N, D, SD, M after the pointers, the layout or the slots
        assert launched[0][1][-7:-2] == (1, 3, D, 2 * D, 4)
        assert launched[1][1][-7:-2] == (1, 3, D, 2 * D, 4)
        assert {k: ops.LAUNCHES[k] - before[k] for k in before
                if ops.LAUNCHES[k] != before[k]} == {
            tdpt.KERNEL: 1, tdpt.BWD_KERNEL: 1}
        assert tdpt.df_pathwise_eval(x, *operands).shape == x.shape  # plain
    # a feature column of the VJP takes at most a block's 256 threads of
    # 8 dims: above D = 2048 it refuses, naming the limit
    args = _t(_df_operands(np.random.default_rng(5), 1, 1, 1, 2049, (1,)))
    with pytest.raises(RuntimeError, match='up to 2048'):
        tdpt._launch_bwd(args[0], tuple(args[1:]), torch.zeros_like(args[0]))
    _no_library(monkeypatch)
    args = _t(_df_operands(np.random.default_rng(4), 3, 2, 4, 17, (1,)))
    x, operands = args[0], tuple(args[1:])
    with pytest.raises(NotImplementedError, match='up to 16'):
        df_pathwise._launch(x, operands)
    with pytest.raises(NotImplementedError, match='up to 16'):
        df_pathwise._launch_bwd(x, operands, torch.zeros_like(x))


def test_df_rule_takes_the_tiled_pair_above_16(monkeypatch):
    """Above D = 16 the single-block pair refuses, so the rule names #11
    and #12 for the forward and the VJP at every L and N (the latent
    widths 20 and 64 of chip_smoke.py's DF steps among them), at any D."""
    from vae_gp_ode_tpu_torch import ops
    monkeypatch.setattr(ops, '_properties', lambda index: (SMS, OPTIN))
    dev = torch.device('cuda', 0)
    for D in (17, 20, 48, 49, 64, 300):
        for L, N in ((1, 20), (5, 20), (1, 600), (5, 600)):
            assert _pick_df(L, N, D, 256 * D, 100) == (True, True)
    assert tdpt.rule_kernels(5, 20, 20, 20 * 256, 100, dev) == (
        'df_pathwise_tiled_fwd', 'df_pathwise_tiled_bwd')
    assert tdpt.rule_kernels(1, 20, 20, 20 * 256, 100, dev) == (
        'df_pathwise_tiled_fwd', 'df_pathwise_tiled_bwd')
    assert tdpt.rule_kernels(5, 20, 64, 64 * 256, 100, dev) == (
        'df_pathwise_tiled_fwd', 'df_pathwise_tiled_bwd')


def test_wrappers_refuse_other_devices():
    args = _t(_rbf_operands(np.random.default_rng(5), 3, 8, 4, 2, 2))
    meta = [a.to('meta') for a in args]
    for fn in (tpt.tiled_pathwise_eval, tpt.pathwise_eval):
        with pytest.raises(ValueError, match='unsupported device'):
            fn(*meta)


# -- one train step of the wide path against JAX ---------------------------------

Q, NF, S, M, N, T = 12, 4, 64, 16, 4, 8


def _jax_wide_state(seed, kernel, q=Q, s=S, m=M):
    """A JAX TrainState at q = 12 with random BatchNorm statistics, a
    random q(u) and well-conditioned grams: RBF lengthscales 0.7..1.3; DF
    lengthscales (1.5..2.5; main.py's default is 2) and variances
    (0.1..0.3) within 2% of one value each (the DF gram is indefinite for
    lengthscales that differ much by pair). At DF lengthscales below 1 the
    12-dimensional field's ((D - 1) - r^2 / ls2) diagonal term makes the
    gradients reach 1e6 and f32 rounding moved them by 1e-3..3e-2 of a
    leaf's largest in both packages on two seeds of three. q, s, m: the
    latent width, features and inducing points (q = 12, S = 64, M = 16)."""
    model, variables, gp = jinit_model(
        jax.random.PRNGKey(seed), latent_dim=q, n_filt=NF, num_features=s,
        num_inducing=m, kernel=kernel, batch=2, T=T)
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(np.asarray, variables['batch_stats'])
    stats = {name: {bn: {'mean': 0.2 * rng.standard_normal(
        s['mean'].shape).astype(np.float32),
        'var': rng.uniform(0.5, 1.5, s['var'].shape).astype(np.float32)}
        for bn, s in sub.items()} for name, sub in stats.items()}
    if kernel == 'DF':
        ls = rng.uniform(1.5, 2.5) * (1 + 0.02 * rng.uniform(-1, 1, (q, q)))
        var = rng.uniform(0.1, 0.3) * (1 + 0.02 * rng.uniform(-1, 1, q))
        kern = RBFParams(jnp.asarray(np.log(np.expm1(ls)), jnp.float32),
                         jnp.asarray(np.log(np.expm1(var)), jnp.float32))
    else:
        kern = RBFParams(
            jnp.asarray(rng.uniform(0.0, 1.0, (Q, Q)), jnp.float32),
            jnp.asarray(rng.uniform(-1.0, 0.0, (Q,)), jnp.float32))
    gp = gp.replace(
        kernel=kern,
        Um=jnp.asarray(rng.standard_normal((m, q)) * 0.3, jnp.float32),
        Us_sqrt=gp.Us_sqrt * 50.0)
    variables = {'params': variables['params'], 'batch_stats': stats}
    state, _ = jtrainer.create_train_state(model, variables, gp, lr=1e-3)
    return model, state


def _jax_wide_noise(key, L_, kernel, q=Q, s=S, m=M):
    """The raw draws the JAX forward takes from `key` (the key splits of
    ODEGPVAE.__call__, encode, sample_trajectories, draw_fn_sample and the
    RFF draws), at latent width q (the DF kernel draws 2S weights)."""
    k_enc, k_traj = jax.random.split(key)
    k_s, _ = jax.random.split(k_enc)
    noise = {'z0': jax.random.normal(k_s, (N, q))}
    draws = []
    for k in jax.random.split(k_traj, L_):
        k_rff, k_u = jax.random.split(k)
        k_om, k_ph, k_w = jax.random.split(k_rff, 3)
        draws.append({
            'omega': jax.random.normal(k_om, (q, s, q)),
            'phase_u': jax.random.uniform(k_ph, (1, s, q)),
            'weights': jax.random.normal(
                k_w, ((2 * s if kernel == 'DF' else s), q)),
            'epsilon': jax.random.normal(k_u, (m, q), jnp.float32)})
    for name in draws[0]:
        noise[name] = jnp.stack([d[name] for d in draws])
    return {k: torch.as_tensor(np.array(v)) for k, v in noise.items()}


def _jax_step(model, jstate, X, key, L_):
    """JAX's train step from `jstate` on X (L_ draws from `key`): loss,
    (nll, kl_reg, kl_u), nfe and the gradients by the port's names."""
    def jloss(params):
        vae_params, gp = params
        (Xrec, s_, v, nfe), _ = model.apply(
            {'params': vae_params, 'batch_stats': jstate.batch_stats},
            jnp.asarray(X), gp, key, L=L_, train=True,
            mutable=['batch_stats'])
        loss, nll, kl_reg, kl_u = jcompute_loss(
            jnp.asarray(X), Xrec, s_, v, gp, ttr.NDATA, eps_guard=True)
        return loss, (nll, kl_reg, kl_u, nfe)

    (jl, jterms), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        (jstate.vae_params, jstate.gp))
    return (float(jl), [float(t) for t in jterms[:3]], int(jterms[3]),
            ttr._named(*jg))


def _f32_draw(draw):
    """`draw` (jax.random.normal or uniform) in f32, cast to float64: under
    x64 the JAX step takes the same noise as its f32 run."""
    def f32(key, shape=(), dtype=None, *args, **kwargs):
        return draw(key, shape, jnp.float32, *args, **kwargs).astype(
            jnp.float64)
    return f32


def _jax_step_x64(model, jstate, X, key, L_, monkeypatch):
    """`_jax_step` in float64 (jax.enable_x64, as tests/test_x64_kernels.py
    runs the JAX package), from the same state and noise."""
    def cast(tree):
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64) if (
            jnp.issubdtype(a.dtype, jnp.floating)) else a, tree)

    with jax.enable_x64(), monkeypatch.context() as mp:
        for name in ('normal', 'uniform'):
            mp.setattr(jax.random, name, _f32_draw(getattr(jax.random, name)))
        state = jstate.replace(vae_params=cast(jstate.vae_params),
                               gp=cast(jstate.gp),
                               batch_stats=cast(jstate.batch_stats))
        return _jax_step(model, state, X.astype(np.float64), key, L_)


def _port_step(jstate, X, noise, L_, q, s, kernel, dtype=torch.float32,
               relu_in=None, relu_pin=None):
    """The port's train step (plain path, CPU) from `jstate` in `dtype`:
    loss, (nll, kl_reg, kl_u), nfe and the gradients by name, and the
    state. `relu_in` (a dict) receives each ReLU's input; `relu_pin` (such
    a dict from another run) makes each ReLU take that run's branch."""
    st = train_state_from_jax(ttr._np_state(jstate), latent_dim=q,
                              n_filt=NF, num_features=s, kernel=kernel,
                              device='cpu')
    gp = st.gp.detach()
    st = trainer.TrainState(
        model=st.model.to(dtype).train(), optimizer=None, step=None,
        gp=dataclasses.replace(gp, kernel=dataclasses.replace(gp.kernel, **{
            k: getattr(gp.kernel, k).to(dtype) for k in (
                'unconstrained_lengthscales', 'unconstrained_variance')}),
            **{k: getattr(gp, k).to(dtype) for k in (
                'inducing_loc', 'Um', 'Us_sqrt')}).requires_grad_())

    def relu_hook(name, inp):
        if relu_in is not None:
            assert name not in relu_in, f'{name} ran twice in one step'
            relu_in[name] = inp[0].detach().double()
        if relu_pin is not None:
            return inp[0] * (relu_pin[name] > 0).to(inp[0].dtype)
        return None

    for name, mod in st.model.named_modules():
        if isinstance(mod, torch.nn.ReLU):
            mod.register_forward_hook(
                lambda mod, inp, out, name=name: relu_hook(name, inp))
    before = dict(ops.LAUNCHES)
    loss, terms = trainer.loss_fn(
        st, torch.as_tensor(X, dtype=dtype), L_, ttr.NDATA, True,
        noise={k: v.to(dtype) for k, v in noise.items()})
    loss.backward()
    assert ops.LAUNCHES == before
    grads = {n: p.grad.double().numpy()
             for n, p in zip(st.param_names(), st.params())}
    return (float(loss.detach()), [float(t.detach()) for t in terms[:3]],
            int(terms[3]), grads, st)


def _wide_step_matches(kernel, seed, q=Q, s=S, m=M):
    """Loss, ELBO terms, nfe and every gradient of one train step (L=2)
    with the euler flow through fn_eval against JAX's, from one state and
    the same noise, at latent width q, s features and m inducing points."""
    L_ = 2
    model, jstate = _jax_wide_state(seed, kernel, q, s, m)
    X = ttr._X(seed, n=N)[:, :T]
    key = jax.random.PRNGKey(seed + 1)
    jl, jterms, jnfe, ref = _jax_step(model, jstate, X, key, L_)
    loss, terms, nfe, grads, st = _port_step(
        jstate, X, _jax_wide_noise(key, L_, kernel, q, s, m), L_, q, s,
        kernel)
    np.testing.assert_allclose([loss] + terms, [jl] + jterms, rtol=1e-4)
    assert nfe == jnfe == L_ * (T - 1)
    assert sorted(grads) == sorted(ref)
    scale = ttr._grad_scales(list(grads), ref, st.model)
    for name, g in grads.items():
        err = np.abs(g - ref[name]).max()
        assert err <= ttr.GRAD_REL * scale[name], (name, err, scale[name])


@pytest.mark.parametrize('kernel', ['RBF', 'DF'])
def test_wide_train_step_matches_jax(kernel, monkeypatch):
    """Loss, ELBO terms, nfe and every gradient of one train step (L=2) at
    q = 12 with the euler flow through fn_eval, the per-step eval that the
    dispatch rule routes on the card."""
    monkeypatch.setattr(tflow, 'use_fused_pair', lambda *a: False)
    _wide_step_matches(kernel, 60 + (kernel == 'DF'))


# a ReLU unit whose branch the f32 and the float64 step disagree on must
# have a float64 input within this share of its layer's largest |input|
# (chip_smoke.py RELU_FLIP)
RELU_FLIP = 1e-4
# where the two packages' f32 gradients disagree, the port's may be at
# most this many times as far from JAX's float64 gradient as JAX's own f32
# one (chip_smoke.py F64_NOISE)
F64_NOISE = 2.0


@pytest.mark.parametrize('seed', range(64, 72))
def test_df_train_step_matches_jax_at_latent_dim_64(seed, monkeypatch):
    """A DF train step at latent_dim 64 (S = 16, M = 8, N = 4, L = 2),
    which the card runs through the tiled pair's wide kernels (#11/#12)
    and the JAX package through its plain scan: the port's plain path
    against JAX's, same state and noise, on eight random states.

    In float64 the two packages compute the same step: loss and ELBO terms
    within 1e-9 relative, every gradient within 1e-9 of its leaf's
    largest (two float64 runs that sum in other orders). In f32 the loss
    and ELBO terms are within 1e-4 relative of JAX's, and every gradient
    within 1e-4 of its leaf's largest of JAX's f32 gradient or, where the
    two f32 steps disagree by more, no farther from JAX's float64 gradient
    than 1e-4 or F64_NOISE times JAX's own f32 gradient: at this width
    (gradients up to 2e5) f32 rounding in either package moves a leaf by
    1e-4..3e-3 of its largest (JAX's f32 step on seed 64, the decoder
    weights, 2.9e-3 from float64 where the port's is 1.2e-6; on seed 69
    both packages' f32 steps 1.2e-4 from float64 at the inducing points).
    The port's f32 step takes its float64 run's branch of every ReLU
    unit, each unit on which the two runs' own inputs disagree being
    within RELU_FLIP of 0 (on seed 69 one unit of the decoder, 7.9e-8 of
    its layer's largest, whose other branch moved a decoder weight's
    gradient by 4e-3)."""
    monkeypatch.setattr(tflow, 'use_fused_pair', lambda *a: False)
    q, s, m, L_ = 64, 16, 8, 2
    model, jstate = _jax_wide_state(seed, 'DF', q, s, m)
    X = ttr._X(seed, n=N)[:, :T]
    key = jax.random.PRNGKey(seed + 1)
    noise = _jax_wide_noise(key, L_, 'DF', q, s, m)
    jl, jterms, jnfe, ref = _jax_step(model, jstate, X, key, L_)
    jl64, jterms64, _, ref64 = _jax_step_x64(model, jstate, X, key, L_,
                                             monkeypatch)
    relu64, relu32 = {}, {}
    loss64, terms64, _, grads64, st = _port_step(
        jstate, X, noise, L_, q, s, 'DF', torch.float64, relu_in=relu64)
    loss, terms, nfe, grads, _ = _port_step(
        jstate, X, noise, L_, q, s, 'DF', relu_in=relu32, relu_pin=relu64)
    assert sorted(grads) == sorted(ref) == sorted(ref64)
    scale = ttr._grad_scales(list(grads), ref64, st.model)
    np.testing.assert_allclose([loss64] + terms64, [jl64] + jterms64,
                               rtol=1e-9)
    for name, g in grads64.items():
        err = np.abs(g - ref64[name]).max()
        assert err <= 1e-9 * scale[name], ('float64', name, err)
    np.testing.assert_allclose([loss] + terms, [jl] + jterms, rtol=1e-4)
    assert nfe == jnfe == L_ * (T - 1)
    for name, a in relu32.items():
        b = relu64[name]
        flip = (a > 0) != (b > 0)
        assert not flip.any() or float(
            b[flip].abs().max()) <= RELU_FLIP * float(b.abs().max()), name
    for name, g in grads.items():
        err = np.abs(g - ref[name]).max()
        if err > ttr.GRAD_REL * scale[name]:
            err = np.abs(g - ref64[name]).max()
            noise = np.abs(ref[name] - ref64[name]).max()
            assert err <= max(ttr.GRAD_REL * scale[name], F64_NOISE * noise), (
                name, err, noise, scale[name])
