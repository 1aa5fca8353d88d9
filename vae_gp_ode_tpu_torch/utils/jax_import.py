"""Carry weights and train states of the JAX package over to the port.

`from_jax` takes the JAX model's `variables` (params + batch_stats) and
its `SVGPParams` leaves as nested dicts of numpy arrays and returns the
port's state dict and `SVGPParams`; `train_state_from_jax` carries a
whole JAX `TrainState` (with optax's Adam moments) into the port's
`TrainState`, so both packages can continue from the same state. Layout
rules (the reverse of `vae_gp_ode_tpu/utils/torch_import.py`; Adam's
moments follow their parameters' rules):

  flax Conv kernel (kH, kW, I, O)                -> (O, I, kH, kW)
  flax ConvTranspose kernel (kH, kW, I, O),
      spatially flipped                          -> (I, O, kH, kW)
  flax Dense kernel (in, out)                    -> (out, in), with the
      channel-minor (h, w, c) <-> channel-major (c, h, w) flatten
      permutation at the conv/dense boundary
  BatchNorm scale/bias + batch_stats mean/var    -> weight/bias/running_*
  SVGP leaves                                    -> unchanged
"""

import numpy as np
import torch

from vae_gp_ode_tpu_torch.gp.svgp import SVGPParams
from vae_gp_ode_tpu_torch.kernels.rbf import RBFParams


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


def _conv(k):
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _convT(k):
    return _t(np.transpose(np.asarray(k)[::-1, ::-1], (2, 3, 0, 1)))


def _bn(sd, prefix, p, s):
    sd[f'{prefix}.weight'] = _t(p['scale'])
    sd[f'{prefix}.bias'] = _t(p['bias'])
    if s is not None:
        sd[f'{prefix}.running_mean'] = _t(s['mean'])
        sd[f'{prefix}.running_var'] = _t(s['var'])
        sd[f'{prefix}.num_batches_tracked'] = torch.tensor(0)


def encoder_from_jax(params, stats, prefix):
    """flax Encoder (Conv_0..2, BatchNorm_0..1, Dense_0) -> the port's
    `cnn.{0,1,3,4,6}` / `fc` keys under `prefix` (parameters only when
    `stats` is None)."""
    sd = {}
    for i, (ci, bi) in enumerate([(0, 1), (3, 4)]):
        sd[f'{prefix}.cnn.{ci}.weight'] = _conv(params[f'Conv_{i}']['kernel'])
        sd[f'{prefix}.cnn.{ci}.bias'] = _t(params[f'Conv_{i}']['bias'])
        _bn(sd, f'{prefix}.cnn.{bi}', params[f'BatchNorm_{i}'],
            None if stats is None else stats[f'BatchNorm_{i}'])
    sd[f'{prefix}.cnn.6.weight'] = _conv(params['Conv_2']['kernel'])
    sd[f'{prefix}.cnn.6.bias'] = _t(params['Conv_2']['bias'])
    K = np.asarray(params['Dense_0']['kernel'])          # (16*C, 2q), (h,w,c)
    C = K.shape[0] // 16
    W = K.T.reshape(-1, 4, 4, C).transpose(0, 3, 1, 2).reshape(K.shape[1], -1)
    sd[f'{prefix}.fc.weight'] = _t(W)
    sd[f'{prefix}.fc.bias'] = _t(params['Dense_0']['bias'])
    return sd


def decoder_from_jax(params, stats, prefix):
    """flax Decoder (Dense_0, ConvTranspose_0..3, BatchNorm_0..2) -> the
    port's `fc` / `decnn.{1,2,4,5,7,8,10}` keys under `prefix`
    (parameters only when `stats` is None)."""
    sd = {}
    K = np.asarray(params['Dense_0']['kernel'])          # (q, 16*C), (h,w,c)
    b = np.asarray(params['Dense_0']['bias'])
    C = K.shape[1] // 16
    W = K.T.reshape(4, 4, C, -1).transpose(2, 0, 1, 3).reshape(16 * C, -1)
    sd[f'{prefix}.fc.weight'] = _t(W)
    sd[f'{prefix}.fc.bias'] = _t(b.reshape(4, 4, C).transpose(2, 0, 1)
                                  .reshape(-1))
    for i, ci in enumerate([1, 4, 7, 10]):
        sd[f'{prefix}.decnn.{ci}.weight'] = _convT(
            params[f'ConvTranspose_{i}']['kernel'])
        sd[f'{prefix}.decnn.{ci}.bias'] = _t(
            params[f'ConvTranspose_{i}']['bias'])
    for i, bi in enumerate([2, 5, 8]):
        _bn(sd, f'{prefix}.decnn.{bi}', params[f'BatchNorm_{i}'],
            None if stats is None else stats[f'BatchNorm_{i}'])
    return sd


def gp_from_jax(gp_np, kernel='RBF'):
    """SVGPParams from a nested dict of the JAX SVGPParams leaves
    ({'kernel': {'unconstrained_lengthscales', 'unconstrained_variance'},
    'inducing_loc', 'Um', 'Us_sqrt'}); `kernel` is its static
    `kernel_name` ('RBF' or 'DF'), which the leaves do not carry. The
    lengthscales' rank tells the RBF layout (`RBFParams.dimwise`: (D_out,
    D_in) dimwise, (D_in,) shared). A full-Cholesky q(u) scale is packed as
    (D_out, M(M+1)/2), a diagonal one is (M, D_out): the shape tells
    q_diag (for M > 1)."""
    kern = gp_np['kernel']
    Um = _t(gp_np['Um'])
    Us = _t(gp_np['Us_sqrt'])
    M, D_out = Um.shape
    return SVGPParams(
        kernel=RBFParams(
            unconstrained_lengthscales=_t(kern['unconstrained_lengthscales']),
            unconstrained_variance=_t(kern['unconstrained_variance'])),
        inducing_loc=_t(gp_np['inducing_loc']), Um=Um, Us_sqrt=Us,
        q_diag=tuple(Us.shape) != (D_out, M * (M + 1) // 2),
        kernel_name=kernel)


def _vae_from_jax(params, stats):
    sd = {}
    for name, conv in (('encoder', encoder_from_jax),
                       ('decoder', decoder_from_jax),
                       ('encoder_v', encoder_from_jax)):
        if name in params:
            sd.update(conv(params[name],
                           None if stats is None else stats[name], name))
    return sd


def vae_from_jax(variables_np):
    """The state dict of the standalone `models.vae.VAE` from the JAX
    `VAE`'s `variables` (params, and batch_stats where present) as nested
    dicts of numpy arrays: its encoder, decoder and, for order 2,
    encoder_v (CPU tensors out)."""
    return _vae_from_jax(variables_np['params'],
                         variables_np.get('batch_stats'))


def from_jax(variables_np, gp_np, kernel='RBF'):
    """(model_state_dict, gp) for `models.odegpvae.ODEGPVAE` from the JAX
    ODEGPVAE `variables` and SVGP leaves, as nested dicts of numpy
    arrays (CPU tensors out); `kernel` is the GP's `kernel_name`."""
    sd = _vae_from_jax(variables_np['params'],
                       variables_np.get('batch_stats', {}))
    return sd, gp_from_jax(gp_np, kernel)


def train_state_from_jax(state_np, *, latent_dim=6, n_filt=8, order=1,
                         frames=5, dt=0.1, num_features=256, lr=1e-3,
                         fix_kernel=False, freeze_vae=False,
                         solver='euler', dense=1,
                         rtol=1e-6, atol=1e-6, max_steps=256,
                         use_adjoint=False, remat=True, kernel='RBF',
                         device='cuda'):
    """The port's `training.trainer.TrainState` from a JAX `TrainState`
    given as nested dicts of numpy arrays:

        {'step': int,
         'variables': {'params': ..., 'batch_stats': ...},
         'gp': SVGP leaves (as for `gp_from_jax`),
         'adam': {'count': int,            # optax ScaleByAdamState
                  'mu': {'params': ..., 'gp': SVGP leaves},
                  'nu': {'params': ..., 'gp': SVGP leaves}}}

    (with `freeze_vae`, a frozen-VAE state: mu and nu hold 'gp' alone).

    The model is built at the given widths and solver settings (the JAX
    ODEGPVAE's fields) on `device`; `kernel` is the GP's static
    `kernel_name` ('RBF' or 'DF')."""
    from vae_gp_ode_tpu_torch.models.odegpvae import ODEGPVAE
    from vae_gp_ode_tpu_torch.training.trainer import create_train_state
    _, gp = from_jax(state_np['variables'], state_np['gp'], kernel)
    model = ODEGPVAE(latent_dim=latent_dim, n_filt=n_filt, order=order,
                     frames=frames, dt=dt, solver=solver, dense=dense,
                     rtol=rtol, atol=atol, max_steps=max_steps,
                     num_features=num_features, use_adjoint=use_adjoint,
                     remat=remat, device=device)
    state = create_train_state(model, gp.to(model.device), lr=lr,
                               fix_kernel=fix_kernel, freeze_vae=freeze_vae)
    return load_train_state(state, state_np)


def _check_shapes(got, want, where):
    if set(got) != set(want):
        raise ValueError(f'{where}: names {sorted(set(got) ^ set(want))} '
                         f'are in only one of the JAX state and the port\'s')
    for name, t in want.items():
        if tuple(got[name].shape) != tuple(t.shape):
            raise ValueError(f'{where}: {name} has shape '
                             f'{tuple(got[name].shape)} in the JAX state, '
                             f'{tuple(t.shape)} in the port\'s')


def load_train_state(state, state_np):
    """Copy a JAX `TrainState` given as nested dicts of numpy arrays (the
    layout `train_state_from_jax` takes; a frozen-VAE state's Adam moments
    hold 'gp' alone) into the port's TrainState `state`, in place, after
    checking every name and shape against it; returns `state`."""
    sd, gp = from_jax(state_np['variables'], state_np['gp'],
                      state.gp.kernel_name)
    _check_shapes(sd, state.model.state_dict(), 'model')
    _check_shapes(dict(gp.named_parameters()),
                  dict(state.gp.named_parameters()), 'gp')
    if gp.q_diag != state.gp.q_diag:
        raise ValueError(f'q_diag is {gp.q_diag} in the JAX state, '
                         f'{state.gp.q_diag} in the port\'s')
    adam = state_np['adam']
    params = dict(zip(state.param_names(), state.params()))
    moments = {}
    for k in ('mu', 'nu'):
        named = (_vae_from_jax(adam[k]['params'], None)
                 if 'params' in adam[k] else {})
        named.update({f'gp.{n}': v for n, v in gp_from_jax(
            adam[k]['gp']).named_parameters()})
        _check_shapes(named, params, f'adam.{k}')
        moments[k] = named
    with torch.no_grad():
        state.model.load_state_dict(sd)
        for (_, p), (_, v) in zip(state.gp.named_parameters(),
                                  gp.named_parameters()):
            p.copy_(v)
        for k, views in zip(('mu', 'nu'), state.optimizer.moments()):
            for name, view in zip(state.param_names(), views):
                view.copy_(moments[k][name])
        state.optimizer.count.fill_(int(adam['count']))
        state.step.fill_(int(state_np['step']))
    return state
