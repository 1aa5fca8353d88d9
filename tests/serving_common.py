"""Helpers of the serving tests (`test_torch_serving.py`,
`test_torch_serving_variants.py`): one model's weights in both packages,
the JAX forward's raw noise in the port's noise spec, JAX's live
forecaster as one compiled program.

The JAX forward draws its noise from a PRNG key; `jax_noise` derives the
same raw draws (the key splits of `ODEGPVAE.__call__`, `encode`,
`sample_trajectories`, `draw_fn_sample` and the RFF draws) in the shapes
of the port's `noise_spec`, so a spec whose shapes or order drifted from
the JAX model would fail the comparisons.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from vae_gp_ode_tpu import serving as jserving
from vae_gp_ode_tpu.models.odegpvae import init_model as jinit_model

from vae_gp_ode_tpu_torch.gp.svgp import init_svgp_params
from vae_gp_ode_tpu_torch.models.odegpvae import ODEGPVAE
from vae_gp_ode_tpu_torch.utils.jax_import import from_jax

Q, NF, S, M, T, L, N = 3, 4, 16, 8, 4, 2, 3
TOL = dict(rtol=1e-5, atol=1e-5)


def fill(tree, rng, kind=None):
    """Weights for a flax variable tree of shapes: kernels N(0, 1/fan_in),
    biases N(0, 0.1^2), and random BatchNorm leaves (scale ~1, bias and
    mean ~0, var 0.5..1.5), so that eval-mode BatchNorm is not the
    identity."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = fill(v, rng, k if k.startswith('BatchNorm') else kind)
            continue
        shape = tuple(v.shape)
        if kind is not None:
            x = {'scale': 1.0 + 0.2 * rng.standard_normal(shape),
                 'bias': 0.2 * rng.standard_normal(shape),
                 'mean': 0.2 * rng.standard_normal(shape),
                 'var': rng.uniform(0.5, 1.5, shape)}[k]
        elif k == 'kernel':
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            x = 0.1 * rng.standard_normal(shape)
        out[k] = x.astype(np.float32)
    return out


def models(seed=0, order=1, frames=5, kernel='RBF', dimwise=True):
    """(JAX model, variables, gp) and the port's (model, gp) with the same
    weights: JAX's variable tree traced (`jax.eval_shape`, nothing
    compiled) and filled by `fill`, the GP from the port's initialiser
    (RBF lengthscales and variances drawn; the DF ones at their common
    value, which keeps its gram definite)."""
    box = {}

    def init(key):
        box['model'], variables, gp = jinit_model(
            key, latent_dim=Q, n_filt=NF, order=order, frames=frames,
            num_features=S, num_inducing=M, kernel=kernel, dimwise=dimwise,
            batch=2, T=T)
        return variables, gp

    shapes, jgp = jax.eval_shape(init, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    variables = fill(jax.tree.map(lambda x: x, dict(shapes)), rng)
    pgp = init_svgp_params(rng, Q * order, Q, M, kernel=kernel,
                           dimwise=dimwise)
    leaves = {name.split('.')[-1]: t.numpy()
              for name, t in pgp.named_parameters()}
    if kernel == 'RBF':
        for name, lo, hi in (('unconstrained_lengthscales', 0.0, 1.0),
                             ('unconstrained_variance', -1.0, 0.0)):
            leaves[name] = rng.uniform(lo, hi, leaves[name].shape).astype(
                np.float32)
    gp = dataclasses.replace(
        jgp, inducing_loc=jnp.asarray(leaves['inducing_loc']),
        Um=jnp.asarray(leaves['Um']), Us_sqrt=jnp.asarray(leaves['Us_sqrt']),
        kernel=dataclasses.replace(
            jgp.kernel, unconstrained_lengthscales=jnp.asarray(
                leaves['unconstrained_lengthscales']),
            unconstrained_variance=jnp.asarray(
                leaves['unconstrained_variance'])))
    sd, tgp = from_jax(variables, {
        'kernel': {k: leaves[k] for k in ('unconstrained_lengthscales',
                                          'unconstrained_variance')},
        **{k: leaves[k] for k in ('inducing_loc', 'Um', 'Us_sqrt')}},
        kernel=kernel)
    tmodel = ODEGPVAE(latent_dim=Q, n_filt=NF, order=order, frames=frames,
                      num_features=S, device='cpu')
    tmodel.load_state_dict(sd)
    return box['model'], variables, gp, tmodel.eval(), tgp


def live(model, variables, gp, X, seed, **kw):
    """JAX's live forecaster on X at `seed`, as one compiled program."""
    fn = jax.jit(jserving.make_forecast_fn(model, variables, gp, **kw))
    return np.asarray(fn(jnp.asarray(X), seed))


def jax_noise(key, spec, n):
    """The raw draws the JAX forward takes from `key`, in the shapes of
    the port's noise spec (draw dim L first for the GP draws)."""
    shapes = {name: tuple(n if d is None else d for d in shape)
              for name, shape, _ in spec}
    k_enc, k_traj = jax.random.split(key)
    k_s, k_v = jax.random.split(k_enc)
    noise = {'z0': jax.random.normal(k_s, shapes['z0'])}
    if 'v0' in shapes:
        noise['v0'] = jax.random.normal(k_v, shapes['v0'])
    draws = []
    for k in jax.random.split(k_traj, shapes['omega'][0]):
        k_rff, k_u = jax.random.split(k)
        k_om, k_ph, k_w = jax.random.split(k_rff, 3)
        draws.append({
            'omega': jax.random.normal(k_om, shapes['omega'][1:]),
            'phase_u': jax.random.uniform(k_ph, shapes['phase_u'][1:]),
            'weights': jax.random.normal(k_w, shapes['weights'][1:]),
            'epsilon': jax.random.normal(k_u, shapes['epsilon'][1:],
                                         jnp.float32)})
    for name in draws[0]:
        noise[name] = jnp.stack([d[name] for d in draws])
    return {k: torch.as_tensor(np.array(v)) for k, v in noise.items()}


def raw(seed, n=N, T_in=T):
    """Raw [0, 1) pixels."""
    return np.random.default_rng(seed).random(
        (n, T_in, 1, 28, 28)).astype(np.float32)
