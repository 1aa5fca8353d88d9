"""Parity of the port's VAE, ODEGPVAE eval forward, ELBO and forecaster
with the JAX package, on the CPU at small sizes (q=3, n_filt=4, S=32,
M=16, N=5, T=8, L=2).

The JAX model's weights (with randomised BatchNorm statistics) move to
the port with `utils.jax_import.from_jax`. The JAX forward draws its
noise from a PRNG key; `_jax_noise` derives the same raw draws from that
key (mirroring the key splits of `ODEGPVAE.__call__`, `encode`,
`sample_trajectories`, `draw_fn_sample` and `rbf_sample_rff`) and the
port takes them through its `noise=` hook. If the derivation drifted
from the JAX code, the comparisons below would fail, not pass.

Tolerances: encoder/decoder outputs and Xrec 1e-5 (rtol and atol), ELBO
terms 1e-4 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_gp_ode_tpu.gp.svgp import SVGPParams
from vae_gp_ode_tpu.kernels.rbf import RBFParams
from vae_gp_ode_tpu.models import vae as jvae
from vae_gp_ode_tpu.models.odegpvae import init_model as jinit_model
from vae_gp_ode_tpu.serving import make_forecast_fn as jmake_forecast_fn
from vae_gp_ode_tpu.training.objectives import elbo_terms as jelbo_terms

from vae_gp_ode_tpu_torch import ops
from vae_gp_ode_tpu_torch.models import vae as tvae
from vae_gp_ode_tpu_torch.models.odegpvae import ODEGPVAE, init_model
from vae_gp_ode_tpu_torch.serving import make_forecast_fn
from vae_gp_ode_tpu_torch.training.objectives import (
    compute_loss, compute_test_error, elbo_terms,
)
from vae_gp_ode_tpu_torch.utils.jax_import import from_jax
import torch_threads  # noqa: F401

Q, NF, S, M, N, T, L = 3, 4, 32, 16, 5, 8, 2
TOL = dict(rtol=1e-5, atol=1e-5)
ELBO_RTOL = 1e-4


def _randomise(tree, rng, kind):
    """Random values for BatchNorm leaves (scale ~1, bias/mean ~0,
    var 0.5..1.5) so eval-mode BatchNorm is not the identity."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomise(v, rng, k if k.startswith('BatchNorm')
                                else kind)
        elif kind is not None and kind.startswith('BatchNorm'):
            shape = np.shape(v)
            out[k] = {'scale': 1.0 + 0.2 * rng.standard_normal(shape),
                      'bias': 0.2 * rng.standard_normal(shape),
                      'mean': 0.2 * rng.standard_normal(shape),
                      'var': rng.uniform(0.5, 1.5, shape)
                      }[k].astype(np.float32)
        else:
            out[k] = np.array(v)
    return out


def _jax_model(order, seed=0):
    model, variables, gp = jinit_model(
        jax.random.PRNGKey(seed), latent_dim=Q, n_filt=NF, order=order,
        num_features=S, num_inducing=M, batch=2, T=T)
    rng = np.random.default_rng(seed)
    variables = _randomise(jax.tree.map(np.asarray, dict(variables)), rng,
                           None)
    D_in = Q * order
    leaves = {'kernel': {
        'unconstrained_lengthscales':
            rng.uniform(0.0, 1.0, (Q, D_in)).astype(np.float32),
        'unconstrained_variance':
            rng.uniform(-1.0, 0.0, (Q,)).astype(np.float32)},
        'inducing_loc': np.asarray(gp.inducing_loc),
        'Um': np.asarray(gp.Um), 'Us_sqrt': np.asarray(gp.Us_sqrt)}
    gp = SVGPParams(
        kernel=RBFParams(*(jnp.asarray(leaves['kernel'][k]) for k in (
            'unconstrained_lengthscales', 'unconstrained_variance'))),
        inducing_loc=gp.inducing_loc, Um=gp.Um, Us_sqrt=gp.Us_sqrt)
    return model, variables, gp, leaves


def _port_model(variables, leaves, order):
    sd, gp = from_jax(variables, leaves)
    model = ODEGPVAE(latent_dim=Q, n_filt=NF, order=order, num_features=S,
                     device='cpu')
    model.load_state_dict(sd)
    return model.eval(), gp


def _jax_noise(key, order):
    """The raw draws the JAX ODEGPVAE forward takes from `key`."""
    k_enc, k_traj = jax.random.split(key)
    k_s, k_v = jax.random.split(k_enc)
    noise = {'z0': jax.random.normal(k_s, (N, Q))}
    if order == 2:
        noise['v0'] = jax.random.normal(k_v, (N, Q))
    D_in = Q * order
    draws = []
    for k in jax.random.split(k_traj, L):
        k_rff, k_u = jax.random.split(k)
        k_om, k_ph, k_w = jax.random.split(k_rff, 3)
        draws.append({
            'omega': jax.random.normal(k_om, (D_in, S, Q)),
            'phase_u': jax.random.uniform(k_ph, (1, S, Q)),
            'weights': jax.random.normal(k_w, (S, Q)),
            'epsilon': jax.random.normal(k_u, (M, Q), jnp.float32)})
    for name in draws[0]:
        noise[name] = jnp.stack([d[name] for d in draws])
    return {k: torch.as_tensor(np.array(v)) for k, v in noise.items()}


def _X(seed, T_in=T):
    rng = np.random.default_rng(seed)
    return ((rng.random((N, T_in, 1, 28, 28)) - 0.1307) / 0.3081
            ).astype(np.float32)


def test_encoder_decoder_eval_match():
    model, variables, _, leaves = _jax_model(1)
    tmodel, _ = _port_model(variables, leaves, 1)
    p, s = variables['params'], variables['batch_stats']
    x = _X(1)[:, 0]                                      # (N, 1, 28, 28)
    jmu, jlv = jvae.Encoder(Q, NF).apply(
        {'params': p['encoder'], 'batch_stats': s['encoder']},
        jnp.transpose(x, (0, 2, 3, 1)), train=False)
    with torch.no_grad():
        tmu, tlv = tmodel.encoder(torch.as_tensor(x))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), **TOL)
    np.testing.assert_allclose(tlv.numpy(), np.asarray(jlv), **TOL)
    z = np.random.default_rng(2).standard_normal((7, Q)).astype(np.float32)
    jimg = jvae.Decoder(Q, NF).apply(
        {'params': p['decoder'], 'batch_stats': s['decoder']}, z,
        train=False)
    with torch.no_grad():
        timg = tmodel.decoder(torch.as_tensor(z))
    assert timg.shape == (7, 1, 28, 28)
    np.testing.assert_allclose(timg.numpy(),
                               np.asarray(jnp.transpose(jimg, (0, 3, 1, 2))),
                               **TOL)


def test_likelihood_terms_match():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 10)).astype(np.float32)
    z = rng.uniform(0.01, 0.99, (4, 10)).astype(np.float32)
    for guard in (False, True):
        np.testing.assert_allclose(
            tvae.bernoulli_log_prob(torch.as_tensor(x), torch.as_tensor(z),
                                    guard).numpy(),
            np.asarray(jvae.bernoulli_log_prob(x, z, guard)), **TOL)
    np.testing.assert_allclose(
        tvae.gaussian_kl_standard(torch.as_tensor(x), torch.as_tensor(z)
                                  ).numpy(),
        np.asarray(jvae.gaussian_kl_standard(x, z)), **TOL)


@pytest.mark.parametrize('order', [1, 2])
def test_eval_forward_and_elbo_match(order):
    model, variables, gp, leaves = _jax_model(order, seed=order)
    tmodel, tgp = _port_model(variables, leaves, order)
    X = _X(10 + order)
    key = jax.random.PRNGKey(7)
    Xj, sj, vj, nfej = model.apply(variables, jnp.asarray(X), gp, key, L=L,
                                   train=False)
    noise = _jax_noise(key, order)
    with torch.no_grad():
        Xt, st, vt, nfet = tmodel(torch.as_tensor(X), tgp, L=L, noise=noise)
    assert Xt.shape == (L, N, T, 1, 28, 28) and nfet == int(nfej)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), **TOL)
    for a, b in zip(st + (vt if order == 2 else ()),
                    sj + (vj if order == 2 else ())):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    jterms = jelbo_terms(jnp.asarray(X), Xj, sj, vj, gp, eps_guard=True)
    tterms = elbo_terms(torch.as_tensor(X), Xt, st, vt, tgp, eps_guard=True)
    for a, b in zip(tterms, jterms):
        np.testing.assert_allclose(float(a), float(b), rtol=ELBO_RTOL)
    loss = compute_loss(torch.as_tensor(X), Xt, st, vt, tgp, 360.0,
                        eps_guard=True)
    assert np.isfinite(float(loss[0]))
    mse = compute_test_error(torch.as_tensor(X), Xt.mean(0))
    np.testing.assert_allclose(
        float(mse), float(jnp.mean((jnp.mean(Xj, 0) - X) ** 2)),
        rtol=ELBO_RTOL)


@pytest.mark.parametrize('mc_reduce', ['none', 'mean'])
def test_forecast_fn_matches_jax(mc_reduce):
    """make_forecast_fn with a T_custom rollout and input normalisation,
    against the JAX forecaster at the same seed's draws."""
    model, variables, gp, leaves = _jax_model(1, seed=3)
    tmodel, tgp = _port_model(variables, leaves, 1)
    raw = np.random.default_rng(4).random((N, T, 1, 28, 28)).astype(
        np.float32)
    T_out, seed = 2 * T, 11
    jfn = jmake_forecast_fn(model, variables, gp, L=L, T_custom=T_out,
                            mc_reduce=mc_reduce, normalize_input=True)
    ref = np.asarray(jfn(jnp.asarray(raw), seed))
    sd, _ = from_jax(variables, leaves)
    fn = make_forecast_fn(tmodel, sd, tgp, L=L, T_custom=T_out,
                          mc_reduce=mc_reduce, normalize_input=True,
                          device='cpu')
    before = dict(ops.LAUNCHES)
    out = fn(raw, seed, noise=_jax_noise(jax.random.PRNGKey(seed), 1))
    assert ops.LAUNCHES == before
    shape = (N, T_out, 1, 28, 28)
    assert out.shape == (shape if mc_reduce == 'mean' else (L,) + shape)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_forecast_fn_seeded_draws():
    """Without injected noise the seed drives a torch.Generator: the same
    seed repeats the forecast, another seed changes it."""
    model, gp = init_model(0, latent_dim=Q, n_filt=NF, num_features=S,
                           num_inducing=M, device='cpu')
    fn = make_forecast_fn(model, None, gp, L=L, device='cpu')
    X = _X(5)
    a, b, c = fn(X, 1), fn(X, 1), fn(X, 2)
    assert a.shape == (L, N, T, 1, 28, 28) and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not model.training


def test_bad_arguments_and_missing_gpu_raise(monkeypatch):
    with pytest.raises(ValueError, match='order'):
        ODEGPVAE(order=3, device='cpu')
    with pytest.raises(ValueError, match='mc_reduce'):
        make_forecast_fn(None, None, None, mc_reduce='median', device='cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        ODEGPVAE()
