"""Parity of the port's training (training.trainer, checkpoint, meters,
utils.jax_import.train_state_from_jax and the training CLI) with the JAX
package, on the CPU at small sizes (q=3, n_filt=4, S=32, M=16, N=5, T=8,
L=2).

Both packages start from the same state: a JAX TrainState carried over by
`train_state_from_jax`. The JAX forward draws its noise from a PRNG key;
`_jax_noise` derives the same raw draws from that key (as in
tests/test_torch_model.py) and the port takes them through `noise=`.

Tolerances: gradients 1e-4 of each leaf's largest JAX gradient (f32
through the decoder, the GP draw and 7 euler steps, summed in other
orders), except the convolution biases that feed a train-mode BatchNorm,
whose exact gradient is 0: they are held to 1e-4 of their layer's weight
gradient. BatchNorm running statistics 1e-6 of each buffer's largest
entry. Adam from the same state and gradients 1e-6 (relative; the
arithmetic is optax's, op for op). Forward outputs 1e-5, ELBO terms 1e-4
relative.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from vae_gp_ode_tpu.kernels.rbf import RBFParams
from vae_gp_ode_tpu.models.odegpvae import init_model as jinit_model
from vae_gp_ode_tpu.training import meters as jmeters
from vae_gp_ode_tpu.training import trainer as jtrainer
from vae_gp_ode_tpu.training.objectives import compute_loss as jcompute_loss

from vae_gp_ode_tpu_torch import main as tmain
from vae_gp_ode_tpu_torch import ops
from vae_gp_ode_tpu_torch.data.mnist import Loader
from vae_gp_ode_tpu_torch.models import vae as tvae
from vae_gp_ode_tpu_torch.models.odegpvae import init_model
from vae_gp_ode_tpu_torch.training import checkpoint, meters, trainer
from vae_gp_ode_tpu_torch.training.objectives import compute_test_error
from vae_gp_ode_tpu_torch.utils.jax_import import (
    _vae_from_jax, gp_from_jax, train_state_from_jax,
)
import torch_threads  # noqa: F401

Q, NF, S, M, N, T, L = 3, 4, 32, 16, 5, 8, 2
NDATA = 360.0
GRAD_REL = 1e-4
BN_REL = 1e-6


# -- the same state in both packages ----------------------------------------

def _jax_state(order, seed=0, fix_kernel=False):
    """A JAX TrainState with flax-initialised weights, random BatchNorm
    running statistics and a GP with lengthscales 0.5..1.2 (well
    conditioned grams) and a random q(u)."""
    model, variables, gp = jinit_model(
        jax.random.PRNGKey(seed), latent_dim=Q, n_filt=NF, order=order,
        num_features=S, num_inducing=M, batch=2, T=T)
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(np.asarray, variables['batch_stats'])
    stats = {name: {bn: {'mean': 0.2 * rng.standard_normal(
        s['mean'].shape).astype(np.float32),
        'var': rng.uniform(0.5, 1.5, s['var'].shape).astype(np.float32)}
        for bn, s in sub.items()} for name, sub in stats.items()}
    D_in = Q * order
    gp = gp.replace(
        kernel=RBFParams(
            jnp.asarray(rng.uniform(0.0, 1.0, (Q, D_in)), jnp.float32),
            jnp.asarray(rng.uniform(-1.0, 0.0, (Q,)), jnp.float32)),
        Um=jnp.asarray(rng.standard_normal((M, Q)) * 0.3, jnp.float32),
        Us_sqrt=gp.Us_sqrt * 50.0)
    variables = {'params': variables['params'], 'batch_stats': stats}
    state, tx = jtrainer.create_train_state(model, variables, gp, lr=1e-3,
                                            fix_kernel=fix_kernel)
    return model, state, tx


def _gp_np(gp):
    kern = gp.kernel
    return {'kernel': {
        'unconstrained_lengthscales':
            np.asarray(kern.unconstrained_lengthscales),
        'unconstrained_variance': np.asarray(kern.unconstrained_variance)},
        'inducing_loc': np.asarray(gp.inducing_loc),
        'Um': np.asarray(gp.Um), 'Us_sqrt': np.asarray(gp.Us_sqrt)}


def _adam(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]


def _np_state(state):
    """A JAX TrainState as the nested numpy dicts train_state_from_jax
    takes."""
    adam = _adam(state.opt_state)
    tree = lambda t: jax.tree.map(np.asarray, t)           # noqa: E731
    return {'step': int(state.step),
            'variables': {'params': tree(state.vae_params),
                          'batch_stats': tree(state.batch_stats)},
            'gp': _gp_np(state.gp),
            'adam': {'count': int(adam.count),
                     'mu': {'params': tree(adam.mu[0]),
                            'gp': _gp_np(adam.mu[1])},
                     'nu': {'params': tree(adam.nu[0]),
                            'gp': _gp_np(adam.nu[1])}}}


def _port_state(jstate, order, fix_kernel=False):
    return train_state_from_jax(_np_state(jstate), latent_dim=Q, n_filt=NF,
                                order=order, num_features=S,
                                fix_kernel=fix_kernel, device='cpu')


def _named(vae_tree, gp):
    """JAX (vae params, SVGP) leaves by the port's parameter names."""
    out = {k: v.numpy() for k, v in _vae_from_jax(
        jax.tree.map(np.asarray, vae_tree), None).items()}
    out.update({f'gp.{k}': v.numpy() for k, v in
                gp_from_jax(_gp_np(gp)).named_parameters()})
    return out


def _bn_named(batch_stats, vae_params):
    """JAX batch_stats by the port's running_mean/running_var names."""
    sd = _vae_from_jax(jax.tree.map(np.asarray, vae_params),
                       jax.tree.map(np.asarray, batch_stats))
    return {k: v.numpy() for k, v in sd.items()
            if k.endswith(('running_mean', 'running_var'))}


def _jax_noise(key, order, n=N):
    """The raw draws the JAX ODEGPVAE forward takes from `key` (the key
    splits of ODEGPVAE.__call__, encode, sample_trajectories,
    draw_fn_sample and rbf_sample_rff)."""
    k_enc, k_traj = jax.random.split(key)
    k_s, k_v = jax.random.split(k_enc)
    noise = {'z0': jax.random.normal(k_s, (n, Q))}
    if order == 2:
        noise['v0'] = jax.random.normal(k_v, (n, Q))
    draws = []
    for k in jax.random.split(k_traj, L):
        k_rff, k_u = jax.random.split(k)
        k_om, k_ph, k_w = jax.random.split(k_rff, 3)
        draws.append({
            'omega': jax.random.normal(k_om, (Q * order, S, Q)),
            'phase_u': jax.random.uniform(k_ph, (1, S, Q)),
            'weights': jax.random.normal(k_w, (S, Q)),
            'epsilon': jax.random.normal(k_u, (M, Q), jnp.float32)})
    for name in draws[0]:
        noise[name] = jnp.stack([d[name] for d in draws])
    return {k: torch.as_tensor(np.array(v)) for k, v in noise.items()}


@functools.partial(jax.jit, static_argnums=(0, 5, 6))
def jax_loss_and_grads(model, params, batch_stats, X, key, ndata, L_):
    """jax.value_and_grad of the JAX train step's loss_fn at `params`
    (vae params, SVGP): (loss, (nll, kl_reg, kl_u, nfe, new batch_stats)),
    grads. One compilation per model, batch shape, dtype and L, whatever
    the state, data and key (tests/test_torch_tiled.py calls it for eight
    states of one shape, in f32 and in float64)."""
    def jloss(params):
        vae_params, gp = params
        (Xrec, s, v, nfe), upd = model.apply(
            {'params': vae_params, 'batch_stats': batch_stats}, X, gp, key,
            L=L_, train=True, mutable=['batch_stats'])
        loss, nll, kl_reg, kl_u = jcompute_loss(X, Xrec, s, v, gp, ndata,
                                                eps_guard=True)
        return loss, (nll, kl_reg, kl_u, nfe, upd['batch_stats'])

    return jax.value_and_grad(jloss, has_aux=True)(params)


def _X(seed, n=N):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, T, 1, 28, 28)) - 0.1307) / 0.3081
            ).astype(np.float32)


def _grad_scales(names, ref, model):
    scale = {n: np.abs(ref[n]).max() for n in names}
    for n in trainer.bias_before_batchnorm(model):
        scale[n] = scale[n[:-len('bias')] + 'weight']
    return scale


def _assert_bn(model, ref):
    buffers = dict(model.named_buffers())
    for name, want in ref.items():
        got = buffers[name].detach().numpy()
        err = np.abs(got - want).max()
        assert err <= BN_REL * np.abs(want).max(), (name, err)


# -- gradients, BatchNorm and Adam -------------------------------------------

@pytest.mark.parametrize('order', [1, 2])
def test_train_step_gradients_match_jax(order):
    """The ELBO and its gradient for every VAE and GP leaf against
    jax.value_and_grad of the JAX train step's loss_fn, from one state."""
    model, jstate, _ = _jax_state(order, seed=order)
    X = _X(order)
    key = jax.random.PRNGKey(5)

    def jloss(params):                       # the JAX step's loss_fn
        vae_params, gp = params
        (Xrec, s, v, _), upd = model.apply(
            {'params': vae_params, 'batch_stats': jstate.batch_stats},
            jnp.asarray(X), gp, key, L=L, train=True,
            mutable=['batch_stats'])
        loss, _, _, _ = jcompute_loss(jnp.asarray(X), Xrec, s, v, gp, NDATA,
                                      eps_guard=True)
        return loss, upd['batch_stats']

    (jl, new_bs), jg = jax.value_and_grad(jloss, has_aux=True)(
        (jstate.vae_params, jstate.gp))

    tstate = _port_state(jstate, order)
    tstate.model.train()
    loss, _ = trainer.loss_fn(tstate, torch.as_tensor(X), L, NDATA, True,
                              noise=_jax_noise(key, order))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
    ref = _named(*jg)
    names = tstate.param_names()
    assert sorted(names) == sorted(ref)
    scale = _grad_scales(names, ref, tstate.model)
    for name, p in zip(names, tstate.params()):
        err = np.abs(p.grad.numpy() - ref[name]).max()
        assert err <= GRAD_REL * scale[name], (name, err, scale[name])
    _assert_bn(tstate.model, _bn_named(new_bs, jstate.vae_params))


def test_batchnorm_running_stats_after_a_step_match_flax(monkeypatch):
    """After one train step the running statistics are flax's (biased
    batch variance); torch's own BatchNorm2d update (unbiased variance)
    misses the same tolerance."""
    model, jstate, tx = _jax_state(1, seed=3)
    X = _X(3)
    key = jax.random.PRNGKey(8)
    step = jtrainer.make_train_step(model, tx, NDATA, eps_guard=True)
    jnew, _ = step(jstate, jnp.asarray(X), key, L)
    ref = _bn_named(jnew.batch_stats, jnew.vae_params)

    tstep = trainer.make_train_step(NDATA, eps_guard=True)
    tstate = _port_state(jstate, 1)
    tstep(tstate, torch.as_tensor(X), L, noise=_jax_noise(key, 1))
    _assert_bn(tstate.model, ref)

    monkeypatch.setattr(tvae.BatchNorm2d, 'forward',
                        torch.nn.BatchNorm2d.forward)
    tstate = _port_state(jstate, 1)
    tstep(tstate, torch.as_tensor(X), L, noise=_jax_noise(key, 1))
    with pytest.raises(AssertionError):
        _assert_bn(tstate.model, ref)


@pytest.mark.parametrize('fix_kernel', [False, True])
def test_two_adam_steps_match_optax(fix_kernel):
    """Two updates from the same state and the same gradients: the port's
    Adam against the tx of the JAX train state (optax.adam, masked for
    fix_kernel), parameters and moments."""
    _, jstate, tx = _jax_state(1, seed=4, fix_kernel=fix_kernel)
    tstate = _port_state(jstate, 1, fix_kernel=fix_kernel)
    rng = np.random.default_rng(4)
    params, opt = (jstate.vae_params, jstate.gp), jstate.opt_state
    names = tstate.param_names()
    for _ in range(2):
        grads = jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape) * 10.0 ** rng.uniform(
                -4, 4, x.shape), jnp.float32), params)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        named = _named(*grads)
        for name, p in zip(names, tstate.params()):
            p.grad = torch.as_tensor(named[name])
        trainer.apply_gradients(tstate)
    want = _named(*params)
    adam = _adam(opt)
    mu, nu = _named(*adam.mu), _named(*adam.nu)
    tmu, tnu = tstate.optimizer.moments()
    for i, (name, p) in enumerate(zip(names, tstate.params())):
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   rtol=1e-6, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(tmu[i].numpy(), mu[name], rtol=1e-6,
                                   atol=1e-12, err_msg=name)
        np.testing.assert_allclose(tnu[i].numpy(), nu[name], rtol=1e-6,
                                   atol=1e-12, err_msg=name)
    assert int(tstate.optimizer.count) == int(adam.count) == 2
    assert int(tstate.step) == 2
    if fix_kernel:
        for i, name in enumerate(names):
            if name.startswith('gp.kernel.'):
                assert not tmu[i].any() and not tnu[i].any()
                assert torch.equal(tstate.params()[i], torch.as_tensor(
                    _named(jstate.vae_params, jstate.gp)[name]))


def test_first_adam_step_keeps_the_q_u_diagonal_off_zero():
    """optax's f32 bias corrections leave a 1e-3 leaf moved by lr at
    ~6.6e-9, not at 0 (torch.optim.Adam's arithmetic gives 0 or 1e-10,
    where the inducing KL's log-diagonal is -inf)."""
    p = torch.full((4,), 1e-3, requires_grad=True)
    adam = trainer.Adam([p])
    adam.step(torch.tensor([5.0, 1234.5, 0.37, 2e4]), torch.tensor(True))
    tx = optax.adam(1e-3)
    jp = jnp.full((4,), 1e-3, jnp.float32)
    u, _ = tx.update(jnp.asarray([5.0, 1234.5, 0.37, 2e4]), tx.init(jp), jp)
    want = np.asarray(optax.apply_updates(jp, u))
    assert (want > 1e-9).all()
    np.testing.assert_array_equal(p.detach().numpy(), want)


# -- the step's guard, the epoch and the eval steps --------------------------

def _snapshot(state):
    out = {f'p.{n}': p.detach().clone() for n, p in
           zip(state.param_names(), state.params())}
    out.update({f'b.{n}': b.clone() for n, b in
                state.model.named_buffers()})
    out.update(mu=state.optimizer.mu.clone(), nu=state.optimizer.nu.clone(),
               count=state.optimizer.count.clone(), step=state.step.clone())
    return out


def test_nan_guard_keeps_the_state():
    _, jstate, _ = _jax_state(1, seed=5)
    tstate = _port_state(jstate, 1)
    step = trainer.make_train_step(NDATA, eps_guard=True)
    gen = torch.Generator().manual_seed(0)
    step(tstate, torch.as_tensor(_X(5)), L, gen)        # non-zero moments
    before = _snapshot(tstate)
    bad = torch.as_tensor(_X(6))
    bad[0, 0, 0, 0, 0] = float('nan')
    metrics = step(tstate, bad, L, gen)
    assert not torch.isfinite(metrics['loss'])
    after = _snapshot(tstate)
    for k, v in before.items():
        assert torch.equal(v, after[k]), k
    step(tstate, torch.as_tensor(_X(6)), L, gen)
    assert int(tstate.step) == 2
    assert not torch.equal(tstate.optimizer.mu, before['mu'])


def test_epoch_with_ragged_tail_sees_every_sequence():
    """7 sequences in batches of 3: two steps and a tail step of one, as a
    step-by-step loop over the same batches with the same draws."""
    loader = Loader(_X(7, n=7), 3, seed=1, device='cpu')
    batches, tail = loader.epoch_batches_with_tail()
    assert batches.shape[:2] == (2, 3) and tail.shape[0] == 1
    assert sorted(torch.cat([batches.reshape((6,) + batches.shape[2:]),
                             tail]).sum(dim=(1, 2, 3, 4)).tolist()) == \
        sorted(loader.X.sum(dim=(1, 2, 3, 4)).tolist())
    step = trainer.make_train_step(NDATA, eps_guard=True)
    states = []
    for _ in range(2):
        model, gp = init_model(0, latent_dim=Q, n_filt=NF, num_features=S,
                               num_inducing=M, device='cpu')
        states.append(trainer.create_train_state(model, gp))
    metrics = trainer.run_epoch_with_tail(
        step, states[0], batches, tail, L, torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(2)
    losses = [float(step(states[1], b, L, gen)['loss'])
              for b in list(batches) + [tail]]
    assert metrics['loss'].shape == (3,) and set(metrics) == {
        'loss', 'nll', 'kl_reg', 'kl_u', 'nfe', 'kernel_var'}
    assert metrics['loss'].tolist() == losses
    assert metrics['kernel_var'].shape == (3, Q)
    for a, b in zip(*(s.params() for s in states)):
        assert torch.equal(a, b)
    assert int(states[0].step) == 3


def test_eval_steps_match_jax():
    """make_eval_step (eval-mode BatchNorm) and make_epoch_eval_step (train
    mode, running statistics updated) against the JAX steps."""
    model, jstate, _ = _jax_state(1, seed=6)
    tstate = _port_state(jstate, 1)
    X = _X(8)
    key = jax.random.PRNGKey(9)
    jX, jmse = jtrainer.make_eval_step(model)(jstate, jnp.asarray(X), key, L)
    tX, tmse = trainer.make_eval_step()(tstate, torch.as_tensor(X), L,
                                        noise=_jax_noise(key, 1))
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(tmse), float(jmse), rtol=1e-4)
    assert not tstate.model.training

    jX, jmse, jbs = jtrainer.make_epoch_eval_step(model)(
        jstate, jnp.asarray(X), key, L)
    tX, tmse = trainer.make_epoch_eval_step()(tstate, torch.as_tensor(X), L,
                                              noise=_jax_noise(key, 1))
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(tmse), float(jmse), rtol=1e-4)
    _assert_bn(tstate.model, _bn_named(jbs, jstate.vae_params))
    roll, zero = trainer.make_eval_step(T_custom=2 * T)(
        tstate, torch.as_tensor(X), 1, noise={
            k: v[:1] if k != 'z0' else v
            for k, v in _jax_noise(key, 1).items()})
    assert roll.shape == (1, N, 2 * T, 1, 28, 28) and float(zero) == 0.0


def test_train_state_from_jax_continues_the_jax_run():
    """A JAX TrainState after one JAX step (non-zero Adam moments) carries
    over exactly, and the next step's loss agrees."""
    model, jstate, tx = _jax_state(1, seed=7)
    step = jtrainer.make_train_step(model, tx, NDATA, eps_guard=True)
    X = jnp.asarray(_X(9))
    jstate, _ = step(jstate, X, jax.random.PRNGKey(1), L)
    tstate = _port_state(jstate, 1)
    adam = _adam(jstate.opt_state)
    mu, nu = _named(*adam.mu), _named(*adam.nu)
    tmu, tnu = tstate.optimizer.moments()
    for i, name in enumerate(tstate.param_names()):
        np.testing.assert_array_equal(tmu[i].numpy(), mu[name])
        np.testing.assert_array_equal(tnu[i].numpy(), nu[name])
    assert int(tstate.optimizer.count) == 1 and int(tstate.step) == 1
    key = jax.random.PRNGKey(2)
    _, jm = step(jstate, X, key, L)
    tm = trainer.make_train_step(NDATA, eps_guard=True)(
        tstate, torch.as_tensor(np.array(X)), L, noise=_jax_noise(key, 1))
    for k in ('loss', 'nll', 'kl_reg', 'kl_u'):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    assert int(tm['nfe']) == int(jm['nfe'])
    np.testing.assert_allclose(tm['kernel_var'].numpy(),
                               np.asarray(jm['kernel_var']), rtol=1e-5)


def test_two_train_steps_follow_the_jax_steps():
    """The slice as a whole: two train steps (L=2, then L=1) of the port
    and of the JAX package's make_train_step from one state with the same
    noise give the same metrics, the second from the updated state.

    Not more: Adam moves every entry by about lr whatever its gradient's
    size, so entries whose gradient is at the rounding level (the biases
    before a BatchNorm, a few weights) take lr-sized steps in different
    directions in the two packages; from the third step the encoder's
    KL term drifts by ~4e-4 relative."""
    model, jstate, tx = _jax_state(1, seed=12)
    jstep = jtrainer.make_train_step(model, tx, NDATA, eps_guard=True)
    tstate = _port_state(jstate, 1)
    tstep = trainer.make_train_step(NDATA, eps_guard=True)
    for i, L_ in enumerate((L, 1)):
        X = _X(20 + i)
        key = jax.random.PRNGKey(30 + i)
        jstate, jm = jstep(jstate, jnp.asarray(X), key, L_)
        noise = {k: v[:L_] if k != 'z0' else v
                 for k, v in _jax_noise(key, 1).items()}
        tm = tstep(tstate, torch.as_tensor(X), L_, noise=noise)
        for k in ('loss', 'nll', 'kl_reg', 'kl_u'):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=f'step {i} {k}')
        np.testing.assert_allclose(tm['kernel_var'].numpy(),
                                   np.asarray(jm['kernel_var']), rtol=1e-5)
    assert int(tstate.step) == int(jstate.step) == 2


# -- checkpoints, init, meters, the CLI --------------------------------------

def _fresh_state(seed=0, n_filt=NF):
    model, gp = init_model(seed, latent_dim=Q, n_filt=n_filt,
                           num_features=S, num_inducing=M, device='cpu')
    return trainer.create_train_state(model, gp)


def test_checkpoint_round_trip_with_adam_state(tmp_path):
    state = _fresh_state(0)
    step = trainer.make_train_step(NDATA, eps_guard=True)
    gen = torch.Generator().manual_seed(0)
    for i in range(2):
        step(state, torch.as_tensor(_X(10 + i)), L, gen)
    path = str(tmp_path / 'ckpt' / 'odegpvae_mnist.ckpt')
    checkpoint.save_checkpoint(state, path)
    assert os.listdir(tmp_path / 'ckpt') == ['odegpvae_mnist.ckpt']
    fresh = checkpoint.restore_checkpoint(path, _fresh_state(1))
    a, b = _snapshot(state), _snapshot(fresh)
    for k, v in a.items():
        assert torch.equal(v, b[k]), k
    X = torch.as_tensor(_X(12))
    la = step(state, X, L, torch.Generator().manual_seed(3))['loss']
    lb = step(fresh, X, L, torch.Generator().manual_seed(3))['loss']
    assert torch.equal(la, lb)
    with pytest.raises(ValueError, match='mismatch'):
        checkpoint.restore_checkpoint(path, _fresh_state(0, n_filt=2))


def test_init_model_uses_flax_initialisers():
    model, gp = init_model(3, latent_dim=6, n_filt=8, device='cpu')
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            assert torch.equal(mod.weight, torch.ones_like(mod.weight))
            assert not mod.bias.any() and not mod.running_mean.any()
            assert torch.equal(mod.running_var,
                               torch.ones_like(mod.running_var))
        elif isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                              torch.nn.Linear)):
            assert not mod.bias.any(), name
            w = mod.weight.detach().numpy()
            std = 1.0 / np.sqrt(
                w.shape[0] * w[0, 0].size if isinstance(
                    mod, torch.nn.ConvTranspose2d) else w[0].size)
            # truncated at 2 sigma of the untruncated normal
            assert np.abs(w).max() <= 2.0 * std / 0.87962566103423978
            if w.size >= 1000:
                assert abs(w.std() / std - 1.0) < 0.1, name
    np.testing.assert_allclose(gp.kernel.unconstrained_lengthscales.numpy(),
                               np.log(np.expm1(0.2)), rtol=1e-5)
    assert gp.Us_sqrt.max() == pytest.approx(1e-3)
    bn = init_model(3, latent_dim=6, n_filt=8, random_bn=True,
                    device='cpu')[0].encoder.cnn[1]
    assert bn.running_mean.any() and not torch.equal(
        bn.running_var, torch.ones_like(bn.running_var))


def test_gp_leaves_follow_the_jax_leaf_order():
    _, jstate, _ = _jax_state(2, seed=8)
    tstate = _port_state(jstate, 2)
    jleaves = jax.tree_util.tree_leaves(jstate.gp)
    assert [tuple(p.shape) for p in tstate.gp.parameters()] == \
        [x.shape for x in jleaves]
    for p, x in zip(tstate.gp.parameters(), jleaves):
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(x))
    assert all(p.requires_grad for p in tstate.gp.parameters())
    tstate.gp.requires_grad_(False)
    assert not any(p.requires_grad for p in tstate.gp.parameters())


def test_meters_match_jax():
    rng = np.random.default_rng(11)
    vals = rng.standard_normal(25).tolist()
    for mine, ref in ((meters.CachedRunningAverageMeter(10),
                       jmeters.CachedRunningAverageMeter(10)),
                      (meters.CachedAverageMeter(),
                       jmeters.CachedAverageMeter())):
        for i, v in enumerate(vals):
            mine.update(v, i)
            ref.update(v, i)
            assert mine.val == ref.val and mine.avg == ref.avg
    h, jh = meters.CachedHyperparams(), jmeters.CachedHyperparams()
    h.update([1.0, 2.0], 0)
    jh.update([1.0, 2.0], 0)
    np.testing.assert_array_equal(h.vals[0], jh.vals[0])


def test_compute_test_error_checks_shapes():
    X = torch.as_tensor(_X(13))
    assert float(compute_test_error(X, X)) == 0.0
    with pytest.raises(ValueError, match='incorrect shapes'):
        compute_test_error(X, X[:, :-1])


def _cli_args(tmp_path, *extra):
    return tmain.make_parser().parse_args([
        '--device', 'cpu', '--Nepoch', '2', '--batch', '4', '--Ndata', '10',
        '--Ntest', '4', '--num_inducing', str(M), '--num_features', str(S),
        '--n_filt', str(NF), '--latent_dim', str(Q), '--D_in', str(Q),
        '--D_out', str(Q), '--T', '6', '--log_freq', '1', '--seed', '3',
        '--save', str(tmp_path / 'run'), *extra])


#: what JAX main.py writes into its run directory (main(), final_plots),
#: for an order-1 run
RUN_FILES = ['args.json', 'elbo.npy', 'inducingkl.npy', 'logs', 'nll.npy',
             'odegpvae_mnist.ckpt', 'plots', 'zkl.npy']
RUN_PLOTS = ['data.png', 'dynamics_test_state.png',
             'dynamics_train_state.png', 'hyperparams.png',
             'optimization_trace.png', 'rollout.png', 'rollout_original.png',
             'rot_mnist.png']


def test_cli_run_trains_and_checkpoints(tmp_path):
    """run() at a tiny size on the CPU: two epochs (L=1, then L=5) of 3
    steps each (two batches of 4 and a tail of 2), finite metrics, a
    checkpoint that restores, and no kernel launches."""
    seen = []
    before = dict(ops.LAUNCHES)
    result = tmain.run(_cli_args(tmp_path), on_step=lambda ep, L_:
                       seen.append((ep, L_)))
    assert ops.LAUNCHES == before
    assert seen == [(0, 1)] * 3 + [(1, 5)] * 3
    assert result['bailout'] is None and len(result['epochs']) == 2
    for row in result['epochs']:
        assert row['loss'].shape == (3,) and np.isfinite(row['loss']).all()
        assert np.isfinite(row['mse'])
    assert int(result['state'].step) == 6
    assert sorted(os.listdir(result['save'])) == RUN_FILES
    assert sorted(os.listdir(os.path.join(result['save'], 'plots'))) == \
        RUN_PLOTS
    restored = checkpoint.restore_checkpoint(
        result['ckpt'], trainer.create_train_state(*init_model(
            0, latent_dim=Q, n_filt=NF, num_features=S, num_inducing=M,
            device='cpu')))
    assert int(restored.step) == 6


@pytest.mark.parametrize('flag', [['--data_parallel', 'True']])
def test_cli_refuses_paths_not_ported(tmp_path, flag):
    """No path is refused any more (the solver flags, --kernel DF,
    --pretrained, --dimwise False and --epochs_per_dispatch:
    test_cli_runs_the_solver_flags, test_cli_trains_from_a_pretrained_vae,
    tests/test_torch_shared_rbf.py, tests/test_torch_segment.py; the last,
    --data_parallel, here): --data_parallel True at world size 1 runs the
    single-device path, bit for bit (2 ranks under torchrun:
    tests/test_torch_parallel.py)."""
    ran = tmain.run(_cli_args(tmp_path, *flag))
    ref = tmain.run(_cli_args(tmp_path / 'ref'))
    assert ran['parallel'] == (1, 0, None)
    for a, b in zip(ran['epochs'], ref['epochs']):
        for k in ('loss', 'nll', 'kl_reg', 'kl_u', 'mse'):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for a, b in zip(ran['state'].params(), ref['state'].params()):
        assert torch.equal(a, b)


def test_cli_trains_from_a_pretrained_vae(tmp_path):
    """--pretrained True --vae_path DIR: the encoder and decoder of DIR
    (save_vae_weights' files) load, stay bit for bit as loaded with their
    BatchNorm statistics while the GP trains, and Adam holds the GP
    leaves alone."""
    model, _ = init_model(5, latent_dim=Q, n_filt=NF, random_bn=True,
                          device='cpu')
    vae_dir = tmp_path / 'MNIST-VAE'
    checkpoint.save_vae_weights(model.encoder, model.decoder,
                                str(vae_dir / 'encoder.ckpt'),
                                str(vae_dir / 'decoder.ckpt'))
    result = tmain.run(_cli_args(tmp_path, '--pretrained', 'True',
                                 '--vae_path', str(vae_dir)))
    state = result['state']
    assert result['bailout'] is None and int(state.step) == 6
    assert state.freeze_vae and state.param_names() == [
        f'gp.{n}' for n in state.gp.LEAVES]
    for part in ('encoder', 'decoder'):
        for (n, a), b in zip(getattr(state.model, part).state_dict().items(),
                             getattr(model, part).state_dict().values()):
            assert torch.equal(a, b), (part, n)
    assert all(np.isfinite(e['loss']).all() for e in result['epochs'])


def test_cli_pretrained_without_vae_files_raises(tmp_path):
    """--pretrained True with a --vae_path that holds no encoder/decoder
    files raises FileNotFoundError naming the file, before the run
    directory is made."""
    with pytest.raises(FileNotFoundError, match='encoder.ckpt'):
        tmain.run(_cli_args(tmp_path, '--pretrained', 'True', '--vae_path',
                            ''))
    assert not os.path.exists(tmp_path / 'run')


@pytest.mark.parametrize('flag', [
    ['--solver', 'rk4'], ['--solver', 'euler', '--ts_dense_scale', '2'],
    ['--solver', 'rk4', '--use_adjoint', 'True'],
    ['--kernel', 'DF', '--lengthscale', '1.0', '--variance', '0.7'],
    ['--kernel', 'DF', '--solver', 'rk4', '--dimwise', 'False']])
def test_cli_runs_the_solver_flags(tmp_path, flag):
    """--solver, --ts_dense_scale, --use_adjoint and --kernel DF reach the
    model and the GP and train (one epoch, finite losses, the plain
    versions on the CPU). DF takes the dimwise layout whatever --dimwise
    says, as in the JAX package."""
    args = _cli_args(tmp_path, *flag)
    args.Nepoch = 1
    before = dict(ops.LAUNCHES)
    result = tmain.run(args)
    assert ops.LAUNCHES == before
    model = result['state'].model
    assert (model.solver, model.dense, model.use_adjoint) == (
        args.solver, args.ts_dense_scale, args.use_adjoint)
    gp = result['state'].gp
    assert gp.kernel_name == args.kernel
    assert gp.kernel.unconstrained_lengthscales.shape == (Q, Q)
    assert result['bailout'] is None
    assert np.isfinite(result['epochs'][0]['loss']).all()


def test_cli_refuses_df_with_a_second_order_ode(tmp_path):
    """--kernel DF needs D_in == D_out, so --ode 2 raises ValueError before
    the run starts, as the JAX package's init_svgp_params does."""
    with pytest.raises(ValueError, match='D_in == D_out'):
        tmain.run(_cli_args(tmp_path, '--kernel', 'DF', '--ode', '2',
                            '--D_in', str(2 * Q)))
    assert not os.path.exists(tmp_path / 'run')


def test_cli_defaults_and_device(tmp_path, monkeypatch):
    args = tmain.make_parser().parse_args([])
    assert (args.device, args.Nepoch, args.batch, args.latent_dim,
            args.num_features, args.num_inducing, args.solver, args.dt,
            args.lr, args.eps_guard) == ('cuda', 5000, 20, 6, 256, 100,
                                         'euler', 0.1, 1e-3, True)
    assert args.save.startswith('results/')
    with pytest.raises(ValueError, match='D_in'):
        tmain.run(_cli_args(tmp_path, '--ode', '2'))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tmain.run(_cli_args(tmp_path, '--device', 'cuda'))
