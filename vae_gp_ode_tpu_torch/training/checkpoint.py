"""Checkpoints of the whole train state (port of
`vae_gp_ode_tpu/training/checkpoint.py`).

A checkpoint holds the VAE parameters and BatchNorm statistics, the GP
leaves by name, Adam's count and moments by leaf name, and the global
step, written with `torch.save` (to a temporary file renamed into place).
Restoring reads it with `weights_only=True` (no code runs) and checks
every name and shape against the target state before it copies anything:
a checkpoint whose structure drifted raises instead of filling the wrong
tensors.

`restore_jax_checkpoint` reads the JAX package's own npz checkpoint (a
trained run of `main.py`) into the port's TrainState with numpy alone.
"""

import os

import numpy as np
import torch

from vae_gp_ode_tpu_torch.training.trainer import TrainState


def _contents(state: TrainState):
    adam = state.optimizer
    names = state.param_names()
    mu, nu = adam.moments()
    return {
        'step': state.step,
        'model': state.model.state_dict(),
        'gp': dict(state.gp.named_parameters()),
        'adam': {'count': adam.count, 'mu': dict(zip(names, mu)),
                 'nu': dict(zip(names, nu))},
    }


def save_checkpoint(state: TrainState, path):
    """Write the train state to `path`."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    torch.save(_contents(state), tmp)
    os.replace(tmp, path)


def _check_like(saved, like, where):
    if isinstance(like, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f'checkpoint/state mismatch at {where}: '
                             f'checkpoint holds {type(saved).__name__}')
        if saved.shape != like.shape or saved.dtype != like.dtype:
            raise ValueError(
                f'checkpoint/state mismatch at {where}: checkpoint '
                f'{tuple(saved.shape)} {saved.dtype} vs state '
                f'{tuple(like.shape)} {like.dtype}')
        return
    if isinstance(like, dict):
        keys = list(like)
        if not isinstance(saved, dict) or list(saved) != keys:
            got = list(saved) if isinstance(saved, dict) else saved
            raise ValueError(f'checkpoint/state mismatch at {where}: '
                             f'checkpoint keys {got} vs state keys {keys}')
        for k in keys:
            _check_like(saved[k], like[k], f'{where}.{k}')
        return
    raise TypeError(f'unexpected {type(like).__name__} at {where}')


def restore_checkpoint(path, like: TrainState):
    """Load the checkpoint at `path` into the train state `like` (in
    place, onto its device) after checking every name and shape; returns
    `like`."""
    saved = torch.load(path, map_location=like.step.device,
                       weights_only=True)
    target = _contents(like)
    _check_like(saved, target, 'checkpoint')
    with torch.no_grad():
        like.model.load_state_dict(saved['model'])
        for name, p in like.gp.named_parameters():
            p.copy_(saved['gp'][name])
        for k in ('mu', 'nu'):
            for name, view in target['adam'][k].items():
                view.copy_(saved['adam'][k][name])
        like.optimizer.count.copy_(saved['adam']['count'])
        like.step.copy_(saved['step'])
    return like


# flax module names of the JAX ODEGPVAE's VAE, in pytree (sorted) order
_JAX_ENCODER = ('BatchNorm_0', 'BatchNorm_1', 'Conv_0', 'Conv_1', 'Conv_2',
                'Dense_0')
_JAX_DECODER = ('BatchNorm_0', 'BatchNorm_1', 'BatchNorm_2',
                'ConvTranspose_0', 'ConvTranspose_1', 'ConvTranspose_2',
                'ConvTranspose_3', 'Dense_0')


def _jax_vae_names(order):
    """[(module, layer)] of the JAX VAE in its leaf order."""
    mods = [('decoder', _JAX_DECODER), ('encoder', _JAX_ENCODER)]
    if order == 2:
        mods.append(('encoder_v', _JAX_ENCODER))
    return [(m, layer) for m, layers in mods for layer in layers]


def _take_tree(leaves, order, stats):
    """Nested dict of the VAE's params (or, with `stats`, its BatchNorm
    statistics) from the iterator `leaves`, in the JAX leaf order."""
    tree = {}
    for mod, layer in _jax_vae_names(order):
        if layer.startswith('BatchNorm'):
            keys = ('mean', 'var') if stats else ('bias', 'scale')
        elif stats:
            continue
        else:
            keys = ('bias', 'kernel')
        tree.setdefault(mod, {})[layer] = {k: next(leaves) for k in keys}
    return tree


def _take_gp(leaves):
    ls, var, Z, Um, Us = (next(leaves) for _ in range(5))
    return {'kernel': {'unconstrained_lengthscales': ls,
                       'unconstrained_variance': var},
            'inducing_loc': Z, 'Um': Um, 'Us_sqrt': Us}


def restore_jax_checkpoint(path, like: TrainState):
    """Load a checkpoint of the JAX package's train state into the train
    state `like` (in place, onto its device); returns `like`.

    The file is `vae_gp_ode_tpu/training/checkpoint.py`'s npz format:
    the TrainState's leaves as `leaf_0, leaf_1, ...` in pytree order (step,
    VAE params, BatchNorm statistics, SVGP leaves, Adam's count, mu and
    nu) and its treedef as text (`__treedef__`). It is read with numpy
    (no pickle, nothing of JAX); the leaf count, the SVGP's static q_diag
    and kernel name in the treedef, and every name and shape are checked
    against `like` before anything is copied.
    """
    from vae_gp_ode_tpu_torch.utils.jax_import import load_train_state
    with np.load(path, allow_pickle=False) as data:
        n = sum(1 for k in data.files if k.startswith('leaf_'))
        leaves = [data[f'leaf_{i}'] for i in range(n)]
        treedef = str(data['__treedef__']) if '__treedef__' in data.files \
            else ''
    order = like.model.order
    n_params = 2 * len(_jax_vae_names(order))
    n_stats = sum(2 for _, layer in _jax_vae_names(order)
                  if layer.startswith('BatchNorm'))
    want = 1 + n_params + n_stats + 5 + 1 + 2 * (n_params + 5)
    if n != want:
        raise ValueError(f'{path} holds {n} leaves; a JAX TrainState of '
                         f'this model (order {order}) has {want}')
    tag = f"SVGPParams[({like.gp.q_diag}, '{like.gp.kernel_name}')]"
    if tag not in treedef:
        raise ValueError(f'{path} is not a checkpoint of a GP with '
                         f'q_diag={like.gp.q_diag} and kernel '
                         f'{like.gp.kernel_name!r} (no {tag} in its treedef)')
    it = iter(leaves)
    state_np = {'step': next(it)}
    state_np['variables'] = {'params': _take_tree(it, order, False),
                             'batch_stats': _take_tree(it, order, True)}
    state_np['gp'] = _take_gp(it)
    adam = {'count': next(it)}
    for k in ('mu', 'nu'):
        adam[k] = {'params': _take_tree(it, order, False),
                   'gp': _take_gp(it)}
    state_np['adam'] = adam
    return load_train_state(like, state_np)
