"""The port's native rotation library (`vae_gp_ode_tpu_torch/native`, its
own copy of rotate.cpp, built with g++ at first use) against the JAX
package's native library and scipy at 1e-5, as tests/test_native.py
holds the JAX one; the synthetic data generator through it; the scipy
fall back, logged, where it does not build."""

import contextlib
import logging

import numpy as np
import pytest

from vae_gp_ode_tpu import native as jnative
from vae_gp_ode_tpu.data import synthetic as jsynthetic

from vae_gp_ode_tpu_torch import native
from vae_gp_ode_tpu_torch.data import synthetic
from vae_gp_ode_tpu_torch.native import build
import torch_threads  # noqa: F401

scipy_ndimage = pytest.importorskip('scipy.ndimage')

ANGLES = (0.0, 22.5, 45.0, 90.0, 135.7, 180.0, 270.0, 359.0, -60.0)


@pytest.fixture
def both():
    if not native.native_available():
        pytest.skip('no C++ compiler: the port builds no native library')
    if not jnative.native_available():
        pytest.skip('no C++ compiler: the JAX package builds none')


@contextlib.contextmanager
def records(logger):
    """The messages `logger` emits inside the block (a handler of its own:
    the CLIs' logger above it may not propagate to the root)."""
    got = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda record: got.append(record.getMessage())
    old = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield got
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old)


def _scipy_rot(img, ang):
    return np.clip(scipy_ndimage.rotate(img, ang, reshape=False, order=1),
                   0.0, 1.0)


def test_rotate_matches_jax_and_scipy(both):
    img = np.random.RandomState(0).rand(28, 28).astype(np.float32)
    for ang in ANGLES:
        a = native.rotate_bilinear(img, ang)
        np.testing.assert_allclose(a, jnative.rotate_bilinear(img, ang),
                                   atol=1e-5, err_msg=f'angle {ang}')
        np.testing.assert_allclose(a, _scipy_rot(img, ang), atol=1e-5,
                                   err_msg=f'angle {ang}')


def test_sequences_and_batches_match_jax_and_scipy(both):
    rng = np.random.RandomState(1)
    bases = rng.rand(3, 28, 28).astype(np.float32)
    offs = np.array([0.0, 10.0, 77.0], np.float32)
    out = native.make_rot_sequences(bases, 8, offs)
    assert out.shape == (3, 8, 28, 28)
    np.testing.assert_allclose(out, jnative.make_rot_sequences(bases, 8,
                                                               offs),
                               atol=1e-5)
    for i in range(3):
        for t in range(8):
            np.testing.assert_allclose(
                out[i, t], _scipy_rot(bases[i], t * 45.0 + offs[i]),
                atol=1e-5)
    angs = rng.uniform(0, 360, 3).astype(np.float32)
    out = native.rotate_batch(bases, angs)
    np.testing.assert_allclose(out, jnative.rotate_batch(bases, angs),
                               atol=1e-5)
    for i in range(3):
        np.testing.assert_allclose(out[i], _scipy_rot(bases[i], angs[i]),
                                   atol=1e-5)
    with pytest.raises(ValueError, match='offsets'):
        native.make_rot_sequences(bases, 8, offs[:2])


def test_generators_use_it_as_jax_does(both, monkeypatch):
    """Sequences and frames from the same seed: the port's (native) and
    JAX's (native) agree, and the scipy fall back (logged) within 1e-5."""
    kw = dict(n_sequences=3, T=8, seed=5, start_angle_zero=False)
    X = synthetic.make_rotating_sequences(**kw)
    np.testing.assert_allclose(X, jsynthetic.make_rotating_sequences(**kw),
                               atol=1e-5)
    F = synthetic.make_rotating_frames(2, 5, seed=6)
    np.testing.assert_allclose(F, jsynthetic.make_rotating_frames(2, 5,
                                                                  seed=6),
                               atol=1e-5)
    monkeypatch.setattr(native, 'native_available', lambda: False)
    with records(synthetic.logger) as got:
        X_scipy = synthetic.make_rotating_sequences(**kw)
        F_scipy = synthetic.make_rotating_frames(2, 5, seed=6)
    assert sum('rotating with scipy' in m for m in got) == 2
    np.testing.assert_allclose(X_scipy, X, atol=1e-5)
    np.testing.assert_allclose(F_scipy, F, atol=1e-5)


def test_library_builds_at_first_use_and_logs_a_failed_build(
        tmp_path, monkeypatch):
    """The library is keyed by the source's hash and the host and built
    into its build directory at the first load (not at import); where g++
    fails, load_library logs why and returns None, and the rotations
    raise."""
    path = build.library_path()
    assert path.startswith(build.BUILD_DIR) and 'librotate_' in path
    monkeypatch.setattr(build, 'BUILD_DIR', str(tmp_path / 'native'))
    monkeypatch.setattr(build, '_lib', None)
    monkeypatch.setattr(build, '_tried', False)
    monkeypatch.setattr(build, 'SRC', str(tmp_path / 'missing.cpp'))
    (tmp_path / 'missing.cpp').write_text('this is not C++\n')
    with records(build.logger) as got:
        assert build.load_library() is None
    assert len(got) == 1 and 'rotating with scipy' in got[0]
    assert not build.native_available()
    with pytest.raises(RuntimeError, match='unavailable'):
        build.rotate_bilinear(np.zeros((4, 4), np.float32), 10.0)
    assert not any(p.suffix == '.so' for p in (tmp_path / 'native').iterdir())
