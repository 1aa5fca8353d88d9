"""Parity of the port's data pipeline (data.synthetic, data.mnist) with
the JAX package's, on the CPU.

The synthetic sequences agree to 1e-5 (the JAX package rotates with its
native C++ bilinear kernel when a compiler is present, else with scipy;
the two agree to 1e-5, tests/test_native.py); batches, the rot_start
reshuffle and the train/valid/test splits are identical for the same
seed.
"""

import os

import numpy as np
import pytest
import torch

from vae_gp_ode_tpu.data import mnist as jmnist
from vae_gp_ode_tpu.data import synthetic as jsynthetic

from vae_gp_ode_tpu_torch.data import mnist as tmnist
from vae_gp_ode_tpu_torch.data import synthetic as tsynthetic
import torch_threads  # noqa: F401


@pytest.mark.parametrize('kw', [
    dict(n_sequences=3, T=8, seed=5),
    dict(n_sequences=4, T=6, seed=6, n_glyphs=2),
    dict(n_sequences=2, T=5, seed=7, start_angle_zero=False)])
def test_rotating_sequences_match_jax(kw):
    mine = tsynthetic.make_rotating_sequences(**kw)
    ref = jsynthetic.make_rotating_sequences(**kw)
    assert mine.shape == ref.shape == (kw['n_sequences'], kw['T'], 784)
    assert mine.dtype == np.float32
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-5)
    assert mine.min() >= 0.0 and mine.max() <= 1.0


def _np(x):
    return np.asarray(x)


def test_loader_batches_match_jax():
    """Two epochs of batches (a ragged tail of 2), a first() and an
    iteration, from the same seed's permutation stream."""
    X = np.random.default_rng(0).standard_normal((11, 2, 3)).astype(
        np.float32)
    mine = tmnist.Loader(X, 3, seed=4, device='cpu')
    ref = jmnist.Loader(X, 3, seed=4)
    assert len(mine) == len(ref) == 4
    for _ in range(2):
        a, ta = mine.epoch_batches_with_tail()
        b, tb = ref.epoch_batches_with_tail()
        np.testing.assert_array_equal(a.numpy(), _np(b))
        np.testing.assert_array_equal(ta.numpy(), _np(tb))
    np.testing.assert_array_equal(mine.first().numpy(), _np(ref.first()))
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    even = tmnist.Loader(X[:9], 3, seed=4, device='cpu')
    assert even.epoch_batches_with_tail()[1] is None
    unshuffled = tmnist.Loader(X, 5, shuffle=False, device='cpu')
    assert [len(b) for b in unshuffled] == [5, 5, 1]
    np.testing.assert_array_equal(torch.cat(list(unshuffled)).numpy(), X)


def test_rot_start_matches_jax():
    X = np.random.default_rng(1).standard_normal((6, 8, 1, 2, 2)).astype(
        np.float32)
    np.testing.assert_array_equal(tmnist.rot_start(X, 8, seed=3),
                                  jmnist.rot_start(X, 8, seed=3))


def _args(**kw):
    import argparse
    base = dict(data_root='/nonexistent', batch=4, T=6, Ndata=9, Ntest=4,
                value=3, rotrand=True, rotrand_active=False, seed=2,
                n_glyphs=0, task='mnist')
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize('rotrand_active', [False, True])
def test_load_data_matches_jax(rotrand_active):
    args = _args(rotrand_active=rotrand_active)
    mine = tmnist.load_data(args, device='cpu')
    ref = jmnist.load_data(args)
    for a, b in zip(mine, ref):
        assert a.source == b.source == 'synthetic'
        np.testing.assert_allclose(a.X.numpy(), _np(b.X), rtol=0,
                                   atol=1e-5 / 0.3081)
        np.testing.assert_array_equal(a._rng.permutation(5),
                                      b._rng.permutation(5))
    assert mine[0].X.shape == (9, 6, 1, 28, 28)
    assert mine[1].X.shape == (4, 6, 1, 28, 28)
    with pytest.raises(ValueError, match='Unknown task'):
        tmnist.load_data(_args(task='cifar'), device='cpu')


def test_load_mnist_data_splits_and_normalisation_match_jax(tmp_path):
    """The .mat branch: a rot-mnist.mat in data_root is read, filtered to
    the digit, split and normalised as the JAX package does."""
    import scipy.io as sio
    rng = np.random.default_rng(3)
    X = rng.random((30, 6, 784)).astype(np.float32)
    Y = np.arange(30) % 3
    os.makedirs(tmp_path / 'rot_mnist')
    sio.savemat(tmp_path / 'rot_mnist' / 'rot-mnist.mat', {'X': X, 'Y': Y})
    kw = dict(data_root=str(tmp_path), batch_size=2, T=6, Ndata=5,
              Nvalid=2, Ntest=3, digit=1, seed=9)
    mine = tmnist.load_mnist_data(**kw, device='cpu')
    ref = jmnist.load_mnist_data(**kw)
    want = (X[Y == 1].reshape(-1, 6, 1, 28, 28) - 0.1307) / 0.3081
    for a, b, lo, hi in zip(mine, ref, (0, 5, 7), (5, 7, 10)):
        assert a.source == b.source == 'mat'
        np.testing.assert_array_equal(a.X.numpy(), _np(b.X))
        np.testing.assert_allclose(a.X.numpy(), want[lo:hi], rtol=1e-6)
    with pytest.raises(ValueError, match='--T'):
        tmnist.load_mnist_data(**dict(kw, T=4), device='cpu')
