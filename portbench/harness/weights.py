"""The inputs both sides are given: a configuration's parameters, made on
the device from the seed (flax-default scales: weights N(0, 1/fan_in),
zero biases, BatchNorm scale 1 and shift 0 with running mean 0 and
variance 1; inducing points N(0, 1), variational mean 0.1 N(0, 1), scale
1e-3 I; the kernel at the configuration's lengthscale and variance;
Adam's state empty), or read with numpy from a trained run's
checkpoint."""

import math
import os

import torch

from portbench.reference.checkpoint import read_train_state
from portbench.reference.model import trainable, vae_leaves


def invsoftplus(y):
    y = torch.as_tensor(y, dtype=torch.float32) - 1e-12
    return y + torch.log(-torch.expm1(-y))


def random_state(cfg, gen, device):
    """{'step', 'params', 'adam'} of a fresh model, drawn in two calls."""
    q, M = cfg['latent_dim'], cfg['num_inducing']
    leaves = vae_leaves(q, cfg['n_filt'])
    sizes = [math.prod(s) for _, s, kind, _ in leaves if kind == 'w']
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    gp_flat = torch.randn(2 * M * q, generator=gen, device=device)
    P, off = {}, 0
    for name, shape, kind, fan_in in leaves:
        if kind == 'w':
            n = math.prod(shape)
            P[name] = flat[off:off + n].reshape(shape) / math.sqrt(fan_in)
            off += n
        else:
            fill = 1.0 if kind in ('bn_w', 'bn_var') else 0.0
            P[name] = torch.full(shape, fill, device=device)
    ls_shape = (q, q)
    P['gp.kernel.unconstrained_lengthscales'] = torch.full(
        ls_shape, float(invsoftplus(cfg['lengthscale'])), device=device)
    P['gp.kernel.unconstrained_variance'] = torch.full(
        (q,), float(invsoftplus(cfg['variance'])), device=device)
    P['gp.inducing_loc'] = gp_flat[:M * q].reshape(M, q).clone()
    P['gp.Um'] = 0.1 * gp_flat[M * q:].reshape(M, q)
    rows, cols = torch.tril_indices(M, M, device=device)
    P['gp.Us_sqrt'] = (1e-3 * (rows == cols).float()).expand(
        q, rows.numel()).contiguous()
    zeros = {n: torch.zeros_like(P[n]) for n in trainable(P)}
    return {'step': 0, 'params': P,
            'adam': {'count': 0, 'mu': zeros,
                     'nu': {n: t.clone() for n, t in zeros.items()}}}


def checkpoint_state(path, device):
    """The train state of the checkpoint at `path` as device tensors."""
    st = read_train_state(path)

    def dev(d):
        return {n: torch.as_tensor(a, device=device) for n, a in d.items()}
    return {'step': st['step'], 'params': dev(st['params']),
            'adam': {'count': st['adam']['count'], 'mu': dev(st['adam']['mu']),
                     'nu': dev(st['adam']['nu'])}}


def initial_state(cfg, root, gen, device):
    """The configuration's initial state: from the seed's generator, or
    from its checkpoint (a path relative to the checkout's root)."""
    if cfg['weights'] == 'checkpoint':
        return checkpoint_state(os.path.join(root, cfg['run_dir'],
                                             'odegpvae_mnist.ckpt'), device)
    return random_state(cfg, gen, device)

