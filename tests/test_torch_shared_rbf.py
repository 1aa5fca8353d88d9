"""Parity of the port's shared-lengthscale RBF kernel (`--dimwise False`)
and of `svgp_conditional` with the JAX package, on the CPU at small sizes
(q=3, M=16, S=32, n_filt 4, T=6, L=2).

The same numpy-seeded inputs and raw noise go to both packages. The port
runs a shared sample through the dimwise kernels' plain versions, on the
operand block `ops.pathwise.rbf_fused_operands` broadcasts it to; the JAX
package runs its plain shared formula.

Tolerances: kernel functions 1e-6 elementwise; nu and what is computed
from it 1e-5 of the largest entry (a Cholesky solve of a jittered M x M
gram); the flow and the broadcast eval 1e-5; ELBO terms 1e-4 relative;
gradients 1e-4 of each leaf's largest JAX gradient (the conv biases before
a train-mode BatchNorm against their weight's); the exact conditional
1e-4 of each output's largest |value|. Lengthscales 0.5-1.2 keep the
grams well conditioned (ROADMAP Queue C notes).
"""

import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_gp_ode_tpu.core import transforms as jtr
from vae_gp_ode_tpu.dynamics import flow as jflow
from vae_gp_ode_tpu.gp import svgp as jsvgp
from vae_gp_ode_tpu.kernels import rbf as jrbf
from vae_gp_ode_tpu.models.odegpvae import ODEGPVAE as JODEGPVAE
from vae_gp_ode_tpu.training import checkpoint as jckpt
from vae_gp_ode_tpu.training import trainer as jtrainer
from vae_gp_ode_tpu.training.objectives import compute_loss as jcompute_loss

from vae_gp_ode_tpu_torch import main as tmain
from vae_gp_ode_tpu_torch import ops
from vae_gp_ode_tpu_torch.dynamics import flow as tflow
from vae_gp_ode_tpu_torch.gp import svgp as tsvgp
from vae_gp_ode_tpu_torch.kernels import rbf as trbf
from vae_gp_ode_tpu_torch.models.odegpvae import init_model
from vae_gp_ode_tpu_torch.ops import pathwise
from vae_gp_ode_tpu_torch.serving import load_run_dir, make_forecast_fn
from vae_gp_ode_tpu_torch.training import trainer
from vae_gp_ode_tpu_torch.utils import torch_import
from vae_gp_ode_tpu_torch.utils.jax_import import gp_from_jax

from test_torch_train import (
    NDATA, NF, _X, _cli_args, _grad_scales, _named, _np_state, _port_state,
)
import torch_threads  # noqa: F401

Q, S, M, N, T, L = 3, 32, 16, 5, 6, 2
TIGHT = dict(rtol=1e-6, atol=1e-6)
NU_TOL = 1e-5
COND_TOL = 1e-4


def _np(x):
    return np.asarray(x)


def assert_close_scaled(actual, desired, tol=NU_TOL):
    """|actual - desired| <= tol * (|desired| + max |desired|)."""
    desired = _np(desired)
    np.testing.assert_allclose(_np(actual), desired, rtol=tol,
                               atol=tol * float(np.abs(desired).max()))


def _leaves(rng, D_in, D_out, dimwise, q_diag, kernel='RBF'):
    """SVGP leaves as numpy: lengthscales 0.5..1.2 (for DF within 2% of
    one value, which keeps its gram positive definite), a random q(u)."""
    if kernel == 'DF':
        ls = rng.uniform(0.98, 1.02, (D_out, D_in)) * 1.1
        var = rng.uniform(0.5, 1.0, (D_out,))
    elif dimwise:
        ls = rng.uniform(0.5, 1.2, (D_out, D_in))
        var = rng.uniform(0.3, 1.0, (D_out,))
    else:
        ls = rng.uniform(0.5, 1.2, (D_in,))
        var = rng.uniform(0.3, 1.0, (1,))
    if q_diag:
        Us = rng.standard_normal((M, D_out)).astype(np.float32)
    else:
        tril = np.tril(rng.standard_normal((D_out, M, M)) * 0.1)
        tril += np.eye(M) * rng.uniform(0.2, 1.0, (D_out, 1, M))
        Us = _np(jtr.pack_tril(jnp.asarray(tril.astype(np.float32))))
    f = np.float32
    return {'kernel': {
        'unconstrained_lengthscales': _np(jtr.invsoftplus(
            jnp.asarray(ls.astype(f)))),
        'unconstrained_variance': _np(jtr.invsoftplus(
            jnp.asarray(var.astype(f))))},
        'inducing_loc': rng.standard_normal((M, D_in)).astype(f),
        'Um': (rng.standard_normal((M, D_out)) * 0.3).astype(f),
        'Us_sqrt': Us}


def _gp_pair(rng, D_in=Q, D_out=Q, dimwise=False, q_diag=False,
             kernel='RBF'):
    """The same SVGP in both packages."""
    lv = _leaves(rng, D_in, D_out, dimwise, q_diag, kernel)
    jgp = jsvgp.SVGPParams(
        kernel=jrbf.RBFParams(
            jnp.asarray(lv['kernel']['unconstrained_lengthscales']),
            jnp.asarray(lv['kernel']['unconstrained_variance']),
            dimwise=dimwise or kernel == 'DF'),
        inducing_loc=jnp.asarray(lv['inducing_loc']),
        Um=jnp.asarray(lv['Um']), Us_sqrt=jnp.asarray(lv['Us_sqrt']),
        q_diag=q_diag, kernel_name=kernel)
    tgp = gp_from_jax(lv, kernel)
    assert tgp.kernel.dimwise == jgp.kernel.dimwise and tgp.q_diag == q_diag
    return jgp, tgp


def _noise(rng, D_in, D_out, lead=()):
    """Raw draws of the shared layout: omega (D_in, S), phase (1, S)."""
    f = np.float32
    return {'omega': rng.standard_normal(lead + (D_in, S)).astype(f),
            'phase_u': rng.random(lead + (1, S)).astype(f),
            'weights': rng.standard_normal(lead + (S, D_out)).astype(f),
            'epsilon': rng.standard_normal(lead + (M, D_out)).astype(f)}


def _t(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


# -- the kernel, function by function ----------------------------------------

def test_shared_params_layout():
    """init_rbf_params / init_svgp_params / init_model with dimwise=False
    give the JAX package's shapes; the layout is read from the leaves."""
    kern = trbf.init_rbf_params(4, 3, dimwise=False, lengthscale=0.7)
    jk = jrbf.init_rbf_params(4, 3, dimwise=False, lengthscale=0.7)
    assert not kern.dimwise
    for a, b in ((kern.unconstrained_lengthscales,
                  jk.unconstrained_lengthscales),
                 (kern.unconstrained_variance, jk.unconstrained_variance)):
        np.testing.assert_allclose(a.numpy(), _np(b), **TIGHT)
    gp = tsvgp.init_svgp_params(np.random.default_rng(0), 4, 3, M,
                                dimwise=False)
    assert gp.kernel.unconstrained_lengthscales.shape == (4,)
    df = tsvgp.init_svgp_params(np.random.default_rng(0), 3, 3, M,
                                kernel='DF', dimwise=False)
    assert df.kernel.dimwise          # DF keeps the dimwise layout
    _, g = init_model(0, latent_dim=Q, n_filt=NF, order=2, dimwise=False,
                      device='cpu')
    assert g.kernel.unconstrained_lengthscales.shape == (2 * Q,)
    assert g.kernel.unconstrained_variance.shape == (1,)


@pytest.mark.parametrize('order', [1, 2])
def test_shared_kernel_functions_match(order):
    """gram, the RFF draw and its eval, compute_nu and f_update."""
    rng = np.random.default_rng(10 + order)
    D_in = Q * order
    jgp, tgp = _gp_pair(rng, D_in=D_in)
    X = rng.standard_normal((N, D_in)).astype(np.float32)
    Z = _np(jgp.inducing_loc)
    for X2 in (None, Z):
        np.testing.assert_allclose(
            trbf.rbf_gram(tgp.kernel, torch.as_tensor(X),
                          None if X2 is None else torch.as_tensor(X2)
                          ).numpy(),
            _np(jrbf.rbf_gram(jgp.kernel, X, X2)), **TIGHT)
    nz = _noise(rng, D_in, Q)
    jr = jrbf.rbf_sample_rff(jgp.kernel, None, S, D_in, Q, noise=_j(nz))
    tr = trbf.rbf_sample_rff(tgp.kernel, None, S, D_in, Q, noise=_t(nz))
    for a, b in ((tr.omega, jr.omega), (tr.phase, jr.phase),
                 (tr.weights, jr.weights)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), _np(b), **TIGHT)
    fz = trbf.rbf_rff_eval(tgp.kernel, tr, torch.as_tensor(Z))
    jfz = jrbf.rbf_rff_eval(jgp.kernel, jr, Z)
    np.testing.assert_allclose(fz.numpy(), _np(jfz), **TIGHT)
    Ku = trbf.rbf_gram(tgp.kernel, torch.as_tensor(Z))
    u = torch.as_tensor(rng.standard_normal((M, Q)).astype(np.float32))
    nu = trbf.rbf_compute_nu(tgp.kernel, Ku, fz, u)
    jnu = jrbf.rbf_compute_nu(jgp.kernel, jrbf.rbf_gram(jgp.kernel, Z), jfz,
                              u.numpy())
    assert nu.shape == jnu.shape == (M, Q)
    assert_close_scaled(nu.numpy(), jnu)
    np.testing.assert_allclose(
        trbf.rbf_f_update(tgp.kernel, nu, torch.as_tensor(X),
                          torch.as_tensor(Z)).numpy(),
        _np(jrbf.rbf_f_update(jgp.kernel, nu.numpy(), X, Z)), **TIGHT)


@pytest.mark.parametrize('lead', [(), (L,)])
def test_shared_draw_fn_sample_matches(lead):
    """The sample leaf for leaf (omega (..., D_in, S), phase (..., 1, S),
    nu (..., M, D_out)), a leading batch of draws draw by draw; the RFF
    eval of the batch too."""
    rng = np.random.default_rng(20 + len(lead))
    jgp, tgp = _gp_pair(rng)
    nz = _noise(rng, Q, Q, lead)
    ts = tsvgp.draw_fn_sample(tgp, None, S, noise=_t(nz))
    assert ts.lead == lead and ts.nu.shape == lead + (M, Q)
    X = rng.standard_normal((N, Q)).astype(np.float32)
    prior = trbf.rbf_rff_eval(tgp.kernel, ts.rff, torch.as_tensor(X))
    for i in range(L if lead else 1):
        one = {k: v[i] if lead else v for k, v in nz.items()}
        js = jsvgp.draw_fn_sample(jgp, None, S, noise=_j(one))
        pick = (lambda t: t[i]) if lead else (lambda t: t)
        for a, b in ((ts.rff.omega, js.rff.omega), (ts.rff.phase,
                                                     js.rff.phase),
                     (ts.rff.weights, js.rff.weights)):
            np.testing.assert_allclose(pick(a).numpy(), _np(b), **TIGHT)
        assert_close_scaled(pick(ts.nu).numpy(), js.nu)
        np.testing.assert_allclose(
            pick(prior).numpy(), _np(jrbf.rbf_rff_eval(jgp.kernel, js.rff,
                                                       X)), **TIGHT)


@pytest.mark.parametrize('order', [1, 2])
def test_shared_fn_eval_and_flow_through_the_broadcast_block(order):
    """fn_eval and the euler flow (the fused pair's plain version) take a
    shared sample on the broadcast dimwise block, against the JAX plain
    shared formula; the block itself has the dimwise shapes and sums its
    copies' cotangents back to the shared leaves."""
    rng = np.random.default_rng(30 + order)
    D_in = Q * order
    jgp, tgp = _gp_pair(rng, D_in=D_in)
    nz = _noise(rng, D_in, Q, (L,))
    ts = tsvgp.draw_fn_sample(tgp, None, S, noise=_t(nz))
    block = pathwise.rbf_fused_operands(tgp, ts)
    shapes = [tuple(t.shape) for t in block]
    assert shapes == [(L, D_in, S, Q), (L, 1, S, Q), (L, S, Q), (M, D_in),
                      (L, Q, M), (Q, D_in), (Q,)]
    assert all(t.is_contiguous() for t in block)
    x = rng.standard_normal((L, N, D_in)).astype(np.float32)
    out = tsvgp.fn_eval(tgp, ts, torch.as_tensor(x))
    z0 = rng.standard_normal((N, D_in)).astype(np.float32)
    ts_t = 0.1 * torch.arange(T, dtype=torch.float32)
    zs, nfe = tflow.flow_forward(tgp, ts, torch.as_tensor(z0), ts_t,
                                 order=order, device='cpu')
    assert zs.shape == (L, N, T, D_in) and nfe == L * (T - 1)
    for i in range(L):
        js = jsvgp.draw_fn_sample(jgp, None, S,
                                  noise=_j({k: v[i] for k, v in nz.items()}))
        assert_close_scaled(out[i].numpy(), jsvgp.fn_eval(jgp, js, x[i]))
        jzs, _ = jflow.flow_forward(jgp, js, jnp.asarray(z0),
                                    jnp.asarray(ts_t.numpy()), order=order)
        assert_close_scaled(zs[i].numpy(), jzs)
    # the broadcast's backward: the cotangents of the shared leaves are
    # the sums of their K copies' (autograd against the plain shared
    # formula on the same leaves)
    leaves = [t.detach().clone().requires_grad_() for t in (
        ts.rff.omega, ts.rff.phase, ts.nu,
        tgp.kernel.unconstrained_lengthscales,
        tgp.kernel.unconstrained_variance)]
    kern = trbf.RBFParams(leaves[3], leaves[4])
    rff = trbf.RFFState(leaves[0], leaves[1], ts.rff.weights)
    xt = torch.as_tensor(x)
    g = torch.as_tensor(rng.standard_normal((L, N, Q)).astype(np.float32))
    got = torch.autograd.grad(pathwise.pathwise_eval_reference(
        xt, *pathwise.dimwise_block(
            leaves[0], leaves[1], ts.rff.weights, tgp.inducing_loc,
            leaves[2], trbf.rbf_lengthscales(kern), trbf.rbf_variance(kern),
            False)), leaves, g)
    want = torch.autograd.grad(
        trbf.rbf_rff_eval(kern, rff, xt) + trbf.rbf_f_update(
            kern, leaves[2], xt, tgp.inducing_loc), leaves, g)
    for a, b in zip(got, want):
        assert_close_scaled(a.numpy(), b.numpy())


def test_shared_adjoint_flow_matches_backprop():
    """The rk4 continuous adjoint takes a shared sample (its theta keeps
    the shared leaves' own shapes) and gives backprop's gradients."""
    from vae_gp_ode_tpu_torch.dynamics.adjoint import flow_forward_adjoint
    rng = np.random.default_rng(40)
    _, tgp = _gp_pair(rng)
    tgp.requires_grad_()
    nz = _t(_noise(rng, Q, Q, (L,)))
    z0 = torch.as_tensor(rng.standard_normal((N, Q)).astype(np.float32))
    ts_t = 0.1 * torch.arange(T, dtype=torch.float32)
    grads = []
    for fn in (tflow.flow_forward, flow_forward_adjoint):
        s = tsvgp.draw_fn_sample(tgp, None, S, noise=nz)
        zs, _ = fn(tgp, s, z0, ts_t, solver='rk4', device='cpu')
        grads.append(torch.autograd.grad(zs.square().sum(),
                                         tgp.parameters()[:4]))
    for a, b in zip(*grads):
        assert_close_scaled(b.numpy(), a.numpy(), tol=1e-4)


# -- one train step against the JAX package ----------------------------------

@functools.lru_cache(maxsize=None)
def _jax_shared_state(seed):
    """A JAX TrainState with a shared-lengthscale GP (lengthscales
    0.5..1.2, a random q(u)), random BatchNorm statistics: the JAX
    `init_model` with dimwise=False, its flax init jitted."""
    model = JODEGPVAE(latent_dim=Q, n_filt=NF, num_features=S)
    k_gp, k_vae, k_fwd = jax.random.split(jax.random.PRNGKey(seed), 3)
    gp = jsvgp.init_svgp_params(k_gp, D_in=Q, D_out=Q, M=M, dimwise=False)
    variables = jax.jit(lambda k, x, g: model.init(
        k, x, g, k_fwd, L=1, train=True))(
            k_vae, jnp.zeros((2, 2, 1, 28, 28)), gp)
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(np.asarray, variables['batch_stats'])
    stats = {name: {bn: {'mean': 0.2 * rng.standard_normal(
        s['mean'].shape).astype(np.float32),
        'var': rng.uniform(0.5, 1.5, s['var'].shape).astype(np.float32)}
        for bn, s in sub.items()} for name, sub in stats.items()}
    gp = gp.replace(
        kernel=jrbf.RBFParams(
            jnp.asarray(rng.uniform(0.0, 1.0, (Q,)), jnp.float32),
            jnp.asarray(rng.uniform(-1.0, 0.0, (1,)), jnp.float32),
            dimwise=False),
        Um=jnp.asarray(rng.standard_normal((M, Q)) * 0.3, jnp.float32),
        Us_sqrt=gp.Us_sqrt * 50.0)
    variables = {'params': variables['params'], 'batch_stats': stats}
    state, tx = jtrainer.create_train_state(model, variables, gp, lr=1e-3)
    return model, state, tx


def _jax_noise_shared(key, n=N):
    """The raw draws the JAX forward takes from `key` with a shared GP:
    the key splits of ODEGPVAE.__call__, encode, sample_trajectories,
    draw_fn_sample and rbf_sample_rff, omega (Q, S) and phase (1, S)."""
    k_enc, k_traj = jax.random.split(key)
    k_s, _ = jax.random.split(k_enc)
    noise = {'z0': jax.random.normal(k_s, (n, Q))}
    draws = []
    for k in jax.random.split(k_traj, L):
        k_rff, k_u = jax.random.split(k)
        k_om, k_ph, k_w = jax.random.split(k_rff, 3)
        draws.append({
            'omega': jax.random.normal(k_om, (Q, S)),
            'phase_u': jax.random.uniform(k_ph, (1, S)),
            'weights': jax.random.normal(k_w, (S, Q)),
            'epsilon': jax.random.normal(k_u, (M, Q), jnp.float32)})
    for name in draws[0]:
        noise[name] = jnp.stack([d[name] for d in draws])
    return {k: torch.as_tensor(np.array(v)) for k, v in noise.items()}


def test_shared_train_step_matches_jax():
    """One train step from one state: the loss terms and the gradient of
    every VAE and GP leaf against jax.value_and_grad of the loss that the
    JAX package's make_train_step differentiates (dimwise=False), and
    the port's whole step's metrics.

    The state is seed 2's. At seed 1 (and at seed 3 with T=8) the JAX f32
    gradients sit 5.9e-3 (6.3e-3) of `decoder.decnn.4.weight`'s largest
    from a float64 step of the port, while the port's f32 step sits
    3.8e-6 (5.8e-5) from it: a comparison there measures the reference's
    f32 rounding (ROADMAP Queue C notes), not the port."""
    model, jstate, _ = _jax_shared_state(2)
    X = _X(2)[:, :T]
    key = jax.random.PRNGKey(7)

    def jloss(params):
        vae_params, gp = params
        (Xrec, s, v, _), _ = model.apply(
            {'params': vae_params, 'batch_stats': jstate.batch_stats},
            jnp.asarray(X), gp, key, L=L, train=True,
            mutable=['batch_stats'])
        loss, *terms = jcompute_loss(jnp.asarray(X), Xrec, s, v, gp, NDATA,
                                     eps_guard=True)
        return loss, terms

    (jl, jterms), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        (jstate.vae_params, jstate.gp))
    jm = dict(zip(('loss', 'nll', 'kl_reg', 'kl_u'), (jl, *jterms)))

    noise = _jax_noise_shared(key)
    tstate = _port_state(jstate, 1)
    assert not tstate.gp.kernel.dimwise
    tstate.model.train()
    loss, _ = trainer.loss_fn(tstate, torch.as_tensor(X), L, NDATA, True,
                              noise=noise)
    loss.backward()
    ref = _named(*jg)
    names = tstate.param_names()
    scale = _grad_scales(names, ref, tstate.model)
    for name, p in zip(names, tstate.params()):
        err = np.abs(p.grad.numpy() - ref[name]).max()
        assert err <= 1e-4 * scale[name], (name, err, scale[name])

    tstate = _port_state(jstate, 1)
    tm = trainer.make_train_step(NDATA, eps_guard=True)(
        tstate, torch.as_tensor(X), L, noise=noise)
    for k in ('loss', 'nll', 'kl_reg', 'kl_u'):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    assert tm['kernel_var'].shape == (1,) and int(tstate.step) == 1


# -- the exact conditional ---------------------------------------------------

@pytest.mark.parametrize('full_cov', [False, True])
@pytest.mark.parametrize('q_diag', [False, True])
@pytest.mark.parametrize('kind', ['dimwise', 'shared', 'DF'])
def test_svgp_conditional_matches_jax(kind, q_diag, full_cov):
    """Mean and (co)variance of q(f(x)) against JAX svgp_conditional: RBF
    (D, N, N) per output or DF (N*D, N*D) with full_cov, (N, D) else;
    each output within 1e-4 of its largest |value|."""
    rng = np.random.default_rng(50 + 4 * ['dimwise', 'shared', 'DF'].index(
        kind) + 2 * q_diag + full_cov)
    jgp, tgp = _gp_pair(rng, dimwise=kind == 'dimwise', q_diag=q_diag,
                        kernel='DF' if kind == 'DF' else 'RBF')
    x = rng.standard_normal((N, Q)).astype(np.float32)
    mean, var = tsvgp.svgp_conditional(tgp, torch.as_tensor(x), full_cov)
    jmean, jvar = jsvgp.svgp_conditional(jgp, jnp.asarray(x), full_cov)
    assert mean.shape == jmean.shape and var.shape == jvar.shape
    if full_cov:
        assert var.shape == ((N * Q, N * Q) if kind == 'DF' else (Q, N, N))
    for a, b in ((mean, jmean), (var, jvar)):
        b = _np(b)
        assert np.abs(a.numpy() - b).max() <= COND_TOL * np.abs(b).max()


# -- state: JAX checkpoints, reference state dicts, the CLI ------------------

def test_jax_shared_checkpoint_loads_through_load_run_dir(tmp_path):
    """A dimwise=False JAX TrainState written by the JAX package's
    save_checkpoint restores through load_run_dir (args.json says
    --dimwise False) leaf for leaf, and not into a dimwise state."""
    _, jstate, _ = _jax_shared_state(2)
    run = tmp_path / 'run'
    jckpt.save_checkpoint(jstate, str(run / 'odegpvae_mnist.ckpt'))
    args = vars(tmain.make_parser().parse_args([
        '--latent_dim', str(Q), '--D_in', str(Q), '--D_out', str(Q),
        '--n_filt', str(NF), '--num_features', str(S), '--num_inducing',
        str(M), '--dimwise', 'False', '--device', 'tpu']))
    (run / 'args.json').write_text(json.dumps(args))
    model, state, ta = load_run_dir(str(run), device='cpu')
    assert ta.dimwise is False and not state.gp.kernel.dimwise
    want = _np_state(jstate)
    for name, p in state.gp.named_parameters():
        node = want['gp']
        for part in name.split('.'):
            node = node[part]
        np.testing.assert_array_equal(p.detach().numpy(), node)
    ref = _port_state(jstate, 1)
    for (n, a), b in zip(model.state_dict().items(),
                         ref.model.state_dict().values()):
        assert torch.equal(a, b), n
    fn = make_forecast_fn(model, None, state.gp, L=L, device='cpu')
    assert torch.isfinite(fn(_X(5, n=2), 0)).all()

    args['dimwise'] = True
    (run / 'args.json').write_text(json.dumps(args))
    with pytest.raises(ValueError, match='dimwise'):
        load_run_dir(str(run), device='cpu')


def test_reference_state_dict_with_shared_lengthscales_loads():
    """A reference-format `odegpvae_mnist.pth` state dict whose
    `kern.unconstrained_lengthscales` is (D_in,) loads into a shared GP,
    and into a dimwise GP raises naming the tensor."""
    model, gp = init_model(1, latent_dim=Q, n_filt=NF, num_features=S,
                           num_inducing=M, dimwise=False, device='cpu')
    rng = np.random.default_rng(6)
    prefix = 'flow.odefunc.diffeq.'
    sd = {f'vae.{k}': v.clone() for k, v in model.state_dict().items()}
    leaves = {}
    for name, p in gp.named_parameters():
        leaves[name] = torch.as_tensor(
            rng.standard_normal(tuple(p.shape)).astype(np.float32))
        sd[prefix + torch_import._GP_KEYS[name]] = leaves[name]
    assert sd[prefix + 'kern.unconstrained_lengthscales'].shape == (Q,)
    m2, g2 = init_model(2, latent_dim=Q, n_filt=NF, num_features=S,
                        num_inducing=M, dimwise=False, device='cpu')
    torch_import.odegpvae_from_torch(sd, m2, g2)
    for name, p in g2.named_parameters():
        assert torch.equal(p, leaves[name]), name
    for (n, a), b in zip(m2.state_dict().items(),
                         model.state_dict().values()):
        assert torch.equal(a, b), n
    _, g3 = init_model(2, latent_dim=Q, n_filt=NF, num_features=S,
                       num_inducing=M, device='cpu')
    with pytest.raises(ValueError, match='kern.unconstrained_lengthscales'):
        torch_import.odegpvae_from_torch(sd, m2, g3)


def test_cli_trains_the_shared_kernel(tmp_path):
    """run() with --dimwise False (once refused): two epochs at a tiny
    size, the GP's lengthscales (q,) and variance (1,), finite losses,
    no kernel launch on the CPU, and the run directory serves."""
    before = dict(ops.LAUNCHES)
    result = tmain.run(_cli_args(tmp_path, '--dimwise', 'False'))
    assert ops.LAUNCHES == before
    gp = result['state'].gp
    assert gp.kernel.unconstrained_lengthscales.shape == (Q,)
    assert gp.kernel.unconstrained_variance.shape == (1,)
    assert result['bailout'] is None and int(result['state'].step) == 6
    assert all(np.isfinite(e['loss']).all() and e['kernel_var'].shape == (
        3, 1) for e in result['epochs'])
    model, state, _ = load_run_dir(result['save'], device='cpu')
    assert not state.gp.kernel.dimwise
    fn = make_forecast_fn(model, None, state.gp, L=L, device='cpu')
    assert torch.isfinite(fn(_X(6, n=2)[:, :6], 0)).all()
