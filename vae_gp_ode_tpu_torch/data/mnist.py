"""Rotating-MNIST sequences for coupled training (port of the sequence
half of `vae_gp_ode_tpu/data/mnist.py`).

`load_mnist_data` reads `<data_root>/rot_mnist/rot-mnist.mat` (X (N, 16,
784), filtered to one digit) when it exists, else draws synthetic rotating
glyphs of the same shapes (`data.synthetic`); splits train/valid/test,
normalises with the MNIST mean/std (a reference quirk kept for parity) and
moves each split to the device once. `Loader` batches by indexing that
device tensor with a per-epoch permutation drawn on the host from the same
`np.random.RandomState` stream as the JAX package, so both packages see
the same batches for the same seed.
"""

import os

import numpy as np
import torch

from vae_gp_ode_tpu_torch.core.device import resolve_device
from vae_gp_ode_tpu_torch.data import synthetic

MNIST_MEAN = 0.1307
MNIST_STD = 0.3081


class Loader:
    """Epoch iterator over a tensor on the device that yields every
    sequence once per epoch, the last batch short when the batch size
    does not divide the data (the reference DataLoader's drop_last=False).
    Each epoch's permutation goes to the device once; batches are
    gathered there."""

    def __init__(self, X, batch_size, shuffle=True, seed=0, device='cuda'):
        self.X = torch.as_tensor(np.asarray(X), device=resolve_device(device))
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return -(-self.X.shape[0] // self.batch_size)

    def _permutation(self):
        n = self.X.shape[0]
        idx = self._rng.permutation(n) if self.shuffle else np.arange(n)
        return torch.as_tensor(idx, device=self.X.device)

    def __iter__(self):
        idx = self._permutation()
        for i in range(len(self)):
            yield self.X[idx[i * self.batch_size:(i + 1) * self.batch_size]]

    def first(self):
        """The first batch of a fresh epoch (draws one permutation)."""
        return next(iter(self))

    def epoch_batches_with_tail(self):
        """(stacked (I, B, ...), tail (N % B, ...) or None) from one epoch
        permutation: the batches the reference DataLoader yields, with the
        short final batch apart."""
        n = self.X.shape[0]
        I = n // self.batch_size
        idx = self._permutation()
        stacked = self.X[idx[:I * self.batch_size]].reshape(
            (I, self.batch_size) + tuple(self.X.shape[1:]))
        tail = self.X[idx[I * self.batch_size:]] if n % self.batch_size \
            else None
        return stacked, tail


def rot_start(X, T, seed=None):
    """Re-phase each sequence to a random initial rotation angle: frames
    [s:] followed by frames [1:s+1] (the reference's active code, with its
    one-frame phase jump at the wrap kept for parity)."""
    rng = np.random.RandomState(seed)
    N = X.shape[0]
    start = rng.randint(0, T, N)
    out = np.empty_like(X)
    for n in range(N):
        s = start[n]
        out[n] = np.concatenate([X[n, s:], X[n, 1:s + 1]], axis=0)
    return out


def _read_mat(matpath, digit=None):
    """rot-mnist.mat -> float32 X, optionally filtered to `digit`."""
    import scipy.io as sio
    d = sio.loadmat(matpath)
    X = np.squeeze(d['X'])
    if digit is not None:
        Y = np.squeeze(d['Y'])
        X = X[Y == digit]
    return X.astype(np.float32)


def _load_raw_sequences(data_root, Ntotal, T, digit=3, seed=0,
                        n_glyphs=0):
    """Raw (N, T, 784) in [0, 1]: the .mat file if present, else
    synthetic. Returns (X, source)."""
    matpath = os.path.join(data_root, 'rot_mnist', 'rot-mnist.mat')
    if os.path.exists(matpath):
        return _read_mat(matpath, digit), 'mat'
    X = synthetic.make_rotating_sequences(Ntotal, T=T, seed=seed,
                                          n_glyphs=n_glyphs)
    return X, 'synthetic'


def load_mnist_data(data_root='data/', batch_size=20, T=16, Ndata=360,
                    Nvalid=40, Ntest=40, digit=3, rotrand=False, seed=0,
                    n_glyphs=0, device='cuda'):
    """Train/valid/test Loaders of (B, T, 1, 28, 28) sequences on
    `device`: the first Ndata sequences train, the next Nvalid validate,
    the next Ntest test (the JAX package's split and seeds)."""
    Ntotal = Ndata + Nvalid + Ntest
    X, source = _load_raw_sequences(data_root, Ntotal, T, digit, seed,
                                    n_glyphs=n_glyphs)
    if source == 'mat' and X.shape[1] != T * 28 * 28 and X.shape[1] != T:
        raw_T = X.shape[1] if X.ndim == 3 else X.shape[1] // (28 * 28)
        raise ValueError(
            f'rot-mnist.mat sequences have T={raw_T} frames but --T={T} '
            f'was requested; use --T {raw_T} with the .mat dataset')
    X = X[:Ntotal].reshape(-1, T, 1, 28, 28).astype(np.float32)
    if rotrand:
        X = rot_start(X, T, seed=seed)
    X = (X - MNIST_MEAN) / MNIST_STD

    splits = (X[:Ndata], X[Ndata:Ndata + Nvalid], X[Ndata + Nvalid:Ntotal])
    loaders = [Loader(x, batch_size, shuffle=True, seed=seed + i,
                      device=device) for i, x in enumerate(splits)]
    for loader in loaders:
        loader.source = source
    return tuple(loaders)


def load_data(args, device='cuda'):
    """(trainset, testset) for task 'mnist', from the CLI's arguments (the
    JAX package's `load_data`)."""
    task = getattr(args, 'task', 'mnist')
    if task != 'mnist':
        raise ValueError(f'Unknown task {task!r}')
    train, _, test = load_mnist_data(
        data_root=getattr(args, 'data_root', 'data/'),
        batch_size=getattr(args, 'batch', 20),
        T=getattr(args, 'T', 16),
        Ndata=getattr(args, 'Ndata', 360),
        Ntest=getattr(args, 'Ntest', 40),
        digit=getattr(args, 'value', 3),
        rotrand=getattr(args, 'rotrand', False) and
        getattr(args, 'rotrand_active', False),
        seed=getattr(args, 'seed', 0),
        n_glyphs=getattr(args, 'n_glyphs', 0),
        device=device,
    )
    return train, test
