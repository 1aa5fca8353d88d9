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
from vae_gp_ode_tpu_torch.ops import df_pathwise_tiled as tdpt
from vae_gp_ode_tpu_torch.ops import pathwise as tpw
from vae_gp_ode_tpu_torch.ops import pathwise_tiled as tpt
from vae_gp_ode_tpu_torch.training import trainer
from vae_gp_ode_tpu_torch.utils.jax_import import train_state_from_jax

import test_torch_train as ttr

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

# (D, K, S) -> {(L, N): (forward tiled, VJP tiled)} on an H100: the
# crossover of the sweep in chip_smoke.py phase 6d (PERF.md section 6)
RBF_RULE = {
    (6, 6, 256): {(1, 20): (False, True), (5, 20): (False, True),
                  (1, 600): (False, False), (5, 600): (False, False)},
    (12, 12, 256): {(1, 20): (False, True), (5, 20): (False, True),
                    (1, 600): (False, False), (5, 600): (False, False)},
    (6, 6, 1024): {(1, 20): (False, True), (5, 20): (False, True),
                   (1, 600): (False, False), (5, 600): (False, True)},
    (6, 6, 2048): {(1, 20): (False, True), (5, 20): (False, True),
                   (1, 600): (False, True), (5, 600): (True, True)},
    (12, 12, 1024): {(1, 20): (False, True), (5, 20): (False, True),
                     (1, 600): (False, True), (5, 600): (True, True)}}
# (D, S) -> {(L, N): (forward tiled, VJP tiled)}: refit to the redesigned
# #11/#12 (PERF.md section 6)
DF_RULE = {
    (6, 256): {(1, 20): (False, True), (5, 20): (False, True),
               (1, 600): (False, False), (5, 600): (False, True)},
    (6, 512): {(1, 20): (False, True), (5, 20): (False, True),
               (1, 600): (False, True), (5, 600): (False, True)},
    (12, 256): {(1, 20): (True, True), (5, 20): (True, True),
                (1, 600): (True, True), (5, 600): (True, True)},
    (12, 1024): {(1, 20): (True, True), (5, 20): (True, True),
                 (1, 600): (True, True), (5, 600): (True, True)}}


@pytest.mark.parametrize('D,K,S', sorted(RBF_RULE))
def test_rbf_rule_at_the_sweep_shapes(D, K, S):
    got = {LN: tpt.pick(*LN, D, K, S, 100, SMS, OPTIN)
           for LN in RBF_RULE[D, K, S]}
    assert got == RBF_RULE[D, K, S]


@pytest.mark.parametrize('D,S', sorted(DF_RULE))
def test_df_rule_at_the_sweep_shapes(D, S):
    got = {LN: tdpt.pick_df(*LN, D, S * D, 100, SMS)
           for LN in DF_RULE[D, S]}
    assert got == DF_RULE[D, S]


def test_rule_at_the_rows_of_the_smoke_paths():
    """The kernels chip_smoke.py's paths rely on: the wide configuration
    (q = 12, S = 1024) at batch 20 takes #3 and #10 (RBF), #11 and #12
    (DF); a wide request of 400 sequences takes #9 (RBF) and #11 (DF);
    rk4 steps of 160 sequences at the main widths (q = 6, S = 256) take
    #3/#4 (RBF) and #5/#12 (DF), and at batch 20 #3/#10 and #5/#12; DF rk4
    steps at L = 1 with 600 sequences take #5/#6."""
    for L in (1, 5):
        assert tpt.pick(L, 20, 12, 12, 1024, 100, SMS, OPTIN) == (False, True)
        assert tdpt.pick_df(L, 20, 12, 12288, 100, SMS) == (True, True)
        assert tpt.pick(L, 160, 6, 6, 256, 100, SMS, OPTIN) == (False, False)
        assert tdpt.pick_df(L, 160, 6, 1536, 100, SMS) == (False, True)
        assert tpt.pick(L, 20, 6, 6, 256, 100, SMS, OPTIN) == (False, True)
        assert tdpt.pick_df(L, 20, 6, 1536, 100, SMS) == (False, True)
    assert tpt.pick(5, 400, 12, 12, 1024, 100, SMS, OPTIN)[0]
    assert tdpt.pick_df(5, 400, 12, 12288, 100, SMS)[0]
    assert tdpt.pick_df(1, 600, 6, 1536, 100, SMS) == (False, False)


def test_rule_kernels_name_the_picked_pair(monkeypatch):
    """`rule_kernels` turns each rule's choice into the kernels' names,
    from the card properties `ops.card_properties` reads (stubbed)."""
    from vae_gp_ode_tpu_torch import ops
    monkeypatch.setattr(ops, '_properties', lambda index: (SMS, OPTIN))
    dev = torch.device('cuda', 0)
    assert tpt.rule_kernels(5, 20, 12, 12, 1024, 100, dev) == (
        'pathwise_fwd', 'pathwise_tiled_bwd')
    assert tpt.rule_kernels(5, 400, 12, 12, 1024, 100, dev) == (
        'pathwise_tiled_fwd', 'pathwise_tiled_bwd')
    assert tpt.rule_kernels(5, 160, 6, 6, 256, 100, dev) == (
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
    """#10's block holds the chunk's omega and domega in shared memory
    (`tiled_bwd_smem_bytes`, csrc/pathwise_tiled_bwd.cu): a state dim
    whose block exceeds the opt-in limit goes to #4."""
    assert tpt.tiled_bwd_smem_bytes(12) == 4 * (192 + 8 + 12 + 1024 + 3072)
    D = 210
    assert tpt.tiled_bwd_smem_bytes(D) > OPTIN >= tpt.tiled_bwd_smem_bytes(
        D - 1)
    assert tpt.pick(5, 20, D - 1, 12, 1024, 100, SMS, OPTIN)[1]
    assert not tpt.pick(5, 20, D, 12, 1024, 100, SMS, OPTIN)[1]


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


def test_df_wrappers_refuse_state_dims_above_16(monkeypatch):
    """The tiled DF kernels take D <= 16 (csrc/df_common.cuh kMaxD): the
    wrappers raise before they load a library or launch."""
    _no_library(monkeypatch)
    args = _t(_df_operands(np.random.default_rng(4), 3, 2, 4, 17, (1,)))
    x, operands = args[0], tuple(args[1:])
    with pytest.raises(NotImplementedError, match='up to 16'):
        tdpt._launch(x, operands)
    with pytest.raises(NotImplementedError, match='up to 16'):
        tdpt._launch_bwd(x, operands, torch.zeros_like(x))
    assert tdpt.df_pathwise_eval(x, *operands).shape == x.shape  # plain


def test_wrappers_refuse_other_devices():
    args = _t(_rbf_operands(np.random.default_rng(5), 3, 8, 4, 2, 2))
    meta = [a.to('meta') for a in args]
    for fn in (tpt.tiled_pathwise_eval, tpt.pathwise_eval):
        with pytest.raises(ValueError, match='unsupported device'):
            fn(*meta)


# -- one train step of the wide path against JAX ---------------------------------

Q, NF, S, M, N, T = 12, 4, 64, 16, 4, 8


def _jax_wide_state(seed, kernel):
    """A JAX TrainState at q = 12 with random BatchNorm statistics, a
    random q(u) and well-conditioned grams: RBF lengthscales 0.7..1.3; DF
    lengthscales (1.5..2.5; main.py's default is 2) and variances
    (0.1..0.3) within 2% of one value each (the DF gram is indefinite for
    lengthscales that differ much by pair). At DF lengthscales below 1 the
    12-dimensional field's ((D - 1) - r^2 / ls2) diagonal term makes the
    gradients reach 1e6 and f32 rounding moved them by 1e-3..3e-2 of a
    leaf's largest in both packages on two seeds of three."""
    model, variables, gp = jinit_model(
        jax.random.PRNGKey(seed), latent_dim=Q, n_filt=NF, num_features=S,
        num_inducing=M, kernel=kernel, batch=2, T=T)
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(np.asarray, variables['batch_stats'])
    stats = {name: {bn: {'mean': 0.2 * rng.standard_normal(
        s['mean'].shape).astype(np.float32),
        'var': rng.uniform(0.5, 1.5, s['var'].shape).astype(np.float32)}
        for bn, s in sub.items()} for name, sub in stats.items()}
    if kernel == 'DF':
        ls = rng.uniform(1.5, 2.5) * (1 + 0.02 * rng.uniform(-1, 1, (Q, Q)))
        var = rng.uniform(0.1, 0.3) * (1 + 0.02 * rng.uniform(-1, 1, Q))
        kern = RBFParams(jnp.asarray(np.log(np.expm1(ls)), jnp.float32),
                         jnp.asarray(np.log(np.expm1(var)), jnp.float32))
    else:
        kern = RBFParams(
            jnp.asarray(rng.uniform(0.0, 1.0, (Q, Q)), jnp.float32),
            jnp.asarray(rng.uniform(-1.0, 0.0, (Q,)), jnp.float32))
    gp = gp.replace(
        kernel=kern,
        Um=jnp.asarray(rng.standard_normal((M, Q)) * 0.3, jnp.float32),
        Us_sqrt=gp.Us_sqrt * 50.0)
    variables = {'params': variables['params'], 'batch_stats': stats}
    state, _ = jtrainer.create_train_state(model, variables, gp, lr=1e-3)
    return model, state


def _jax_wide_noise(key, L_, kernel):
    """The raw draws the JAX forward takes from `key` (the key splits of
    ODEGPVAE.__call__, encode, sample_trajectories, draw_fn_sample and the
    RFF draws), at q = 12 (the DF kernel draws 2S weights)."""
    k_enc, k_traj = jax.random.split(key)
    k_s, _ = jax.random.split(k_enc)
    noise = {'z0': jax.random.normal(k_s, (N, Q))}
    draws = []
    for k in jax.random.split(k_traj, L_):
        k_rff, k_u = jax.random.split(k)
        k_om, k_ph, k_w = jax.random.split(k_rff, 3)
        draws.append({
            'omega': jax.random.normal(k_om, (Q, S, Q)),
            'phase_u': jax.random.uniform(k_ph, (1, S, Q)),
            'weights': jax.random.normal(
                k_w, ((2 * S if kernel == 'DF' else S), Q)),
            'epsilon': jax.random.normal(k_u, (M, Q), jnp.float32)})
    for name in draws[0]:
        noise[name] = jnp.stack([d[name] for d in draws])
    return {k: torch.as_tensor(np.array(v)) for k, v in noise.items()}


@pytest.mark.parametrize('kernel', ['RBF', 'DF'])
def test_wide_train_step_matches_jax(kernel, monkeypatch):
    """Loss, ELBO terms, nfe and every gradient of one train step (L=2) at
    q = 12 with the euler flow through fn_eval, the per-step eval that the
    dispatch rule routes on the card."""
    monkeypatch.setattr(tflow, 'use_fused_pair', lambda *a: False)
    L_, seed = 2, 60 + (kernel == 'DF')
    model, jstate = _jax_wide_state(seed, kernel)
    X = ttr._X(seed, n=N)[:, :T]
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
    tstate = train_state_from_jax(ttr._np_state(jstate), latent_dim=Q,
                                  n_filt=NF, num_features=S, kernel=kernel,
                                  device='cpu')
    tstate.model.train()
    before = dict(ops.LAUNCHES)
    loss, terms = trainer.loss_fn(tstate, torch.as_tensor(X), L_,
                                  ttr.NDATA, True,
                                  noise=_jax_wide_noise(key, L_, kernel))
    loss.backward()
    assert ops.LAUNCHES == before
    for a, b in zip((loss,) + terms[:3], (jl,) + jterms[:3]):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-4)
    assert int(terms[3]) == int(jterms[3]) == L_ * (T - 1)
    ref = ttr._named(*jg)
    names = tstate.param_names()
    assert sorted(names) == sorted(ref)
    scale = ttr._grad_scales(names, ref, tstate.model)
    for name, p in zip(names, tstate.params()):
        err = np.abs(p.grad.numpy() - ref[name]).max()
        assert err <= ttr.GRAD_REL * scale[name], (name, err, scale[name])
