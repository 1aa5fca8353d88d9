"""The port's standalone VAE (`models.vae.VAE`) and `dynamics.flow_kl`
against the JAX package's on the CPU, with the JAX weights carried over
by `utils.jax_import.vae_from_jax` (random BatchNorm statistics, so that
eval mode is not the identity): the forward in train mode
(reconstruction, mu and logvar 1e-5, the running statistics after it
1e-6 of each buffer's largest entry), `encode_velocity` (order 2) and
`test` (eval mode) at 1e-5, and `flow_kl` at 1e-5 relative."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_gp_ode_tpu.dynamics import flow_kl as jflow_kl
from vae_gp_ode_tpu.models.vae import VAE as JVAE

from vae_gp_ode_tpu_torch import main_vae
from vae_gp_ode_tpu_torch.dynamics import flow_kl
from vae_gp_ode_tpu_torch.models.vae import VAE
from vae_gp_ode_tpu_torch.utils.jax_import import vae_from_jax

import test_torch_gp as tgp
import torch_threads  # noqa: F401

Q, NF, FRAMES, B = 3, 4, 3, 5
TOL = dict(rtol=1e-5, atol=1e-5)


def _nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def _nchw(y):
    return np.transpose(np.asarray(y), (0, 3, 1, 2))


def _pair(order, seed):
    """The JAX VAE's variables (encoder_v initialised too for order 2,
    random BatchNorm statistics) and the port's VAE with them."""
    jvae = JVAE(latent_dim=Q, n_filt=NF, frames=FRAMES, order=order)
    x = jnp.zeros((2, 28, 28, 1))
    xv = jnp.zeros((2, 28, 28, FRAMES))
    key = jax.random.PRNGKey(seed)

    def both(m, x, xv, key):
        out = m(x, key, train=False)
        if m.order == 2:
            out = (out, m.encode_velocity(xv, train=False))
        return out

    variables = jax.tree.map(np.asarray, jax.jit(functools.partial(
        jvae.init, method=both))(key, x, xv, key))
    rng = np.random.default_rng(seed)
    variables['batch_stats'] = jax.tree.map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.min() == 1.0
                   else 0.2 * rng.standard_normal(a.shape)).astype(
            np.float32), variables['batch_stats'])
    vae = VAE(latent_dim=Q, n_filt=NF, frames=FRAMES, order=order)
    vae.load_state_dict(vae_from_jax(variables))
    return jvae, variables, vae


def _frames(seed, c=1):
    return np.random.default_rng(seed).random((B, c, 28, 28)).astype(
        np.float32)


def test_forward_matches_jax_in_train_mode():
    jvae, variables, vae = _pair(1, 0)
    x = _frames(1)
    key = jax.random.PRNGKey(2)
    (jy, jmu, jlv), upd = jax.jit(functools.partial(
        jvae.apply, train=True, mutable=['batch_stats']))(
        variables, _nhwc(x), key)
    eps = np.array(jax.random.normal(key, jmu.shape))
    y, mu, lv = vae.train()(torch.as_tensor(x), noise=torch.as_tensor(eps))
    np.testing.assert_allclose(mu.detach().numpy(), np.asarray(jmu), **TOL)
    np.testing.assert_allclose(lv.detach().numpy(), np.asarray(jlv), **TOL)
    np.testing.assert_allclose(y.detach().numpy(), _nchw(jy), **TOL)
    want = vae_from_jax({'params': variables['params'],
                         'batch_stats': jax.tree.map(np.asarray,
                                                     upd['batch_stats'])})
    got = vae.state_dict()
    for name, w in want.items():
        if name.endswith(('running_mean', 'running_var')):
            err = float((got[name] - w).abs().max())
            assert err <= 1e-6 * float(w.abs().max()), name
    # a generator draws the noise where none is given
    g = torch.Generator().manual_seed(0)
    assert vae(torch.as_tensor(x), g)[0].shape == (B, 1, 28, 28)


def test_encode_velocity_and_test_match_jax():
    jvae, variables, vae = _pair(2, 3)
    xv = _frames(4, FRAMES)
    jmu, jlv = jvae.apply(variables, _nhwc(xv), train=False,
                          method=JVAE.encode_velocity)
    mu, lv = vae.eval().encode_velocity(torch.as_tensor(xv))
    np.testing.assert_allclose(mu.detach().numpy(), np.asarray(jmu), **TOL)
    np.testing.assert_allclose(lv.detach().numpy(), np.asarray(jlv), **TOL)

    x = _frames(5)
    key = jax.random.PRNGKey(6)
    jy = jax.jit(functools.partial(jvae.apply, method=JVAE.test))(
        variables, _nhwc(x), key)
    jmu, _ = jvae.apply(variables, _nhwc(x), train=False,
                        method=lambda m, x, train: m.encoder(x, train))
    eps = np.array(jax.random.normal(key, jmu.shape))
    vae.train()
    with torch.no_grad():
        y = vae.test(torch.as_tensor(x), noise=torch.as_tensor(eps))
    assert vae.training                      # the mode is restored
    np.testing.assert_allclose(y.numpy(), _nchw(jy), **TOL)


def test_encode_velocity_needs_order_2():
    with pytest.raises(ValueError, match='order=2'):
        VAE(latent_dim=Q, n_filt=NF).encode_velocity(
            torch.zeros(1, 1, 28, 28))


def test_make_vae_is_the_standalone_vae():
    """main_vae.make_vae returns the VAE with the state-dict keys of
    `encoder.ckpt`/`decoder.ckpt` (encoder.*, decoder.*)."""
    vae = main_vae.make_vae(Q, NF, device='cpu')
    assert isinstance(vae, VAE) and not hasattr(vae, 'encoder_v')
    assert {k.split('.')[0] for k in vae.state_dict()} == {'encoder',
                                                           'decoder'}


@pytest.mark.parametrize('q_diag', [False, True])
def test_flow_kl_matches_jax(q_diag):
    jgp, gp = tgp._gp_pair(np.random.default_rng(7), q_diag=q_diag)
    np.testing.assert_allclose(float(flow_kl(gp)), float(jflow_kl(jgp)),
                               rtol=1e-5)
