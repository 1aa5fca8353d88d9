"""Checkpoints of the whole train state (port of
`vae_gp_ode_tpu/training/checkpoint.py`).

A checkpoint holds the VAE parameters and BatchNorm statistics, the GP
leaves by name, Adam's count and moments by leaf name, and the global
step, written with `torch.save` (to a temporary file renamed into place).
Restoring reads it with `weights_only=True` (no code runs) and checks
every name and shape against the target state before it copies anything:
a checkpoint whose structure drifted raises instead of filling the wrong
tensors.
"""

import os

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
