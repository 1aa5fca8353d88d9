"""The port's serving artifact for every model variant and in bf16,
against the JAX package's live forecaster at its raw noise, on the CPU at
small sizes (`serving_common.py`): order 2, dopri5, adams, bdf (also with
a symbolic batch at orders 1 and 2 and with the DF kernel, its Newton
Jacobians through the Jacobian operators), the DF kernel and the shared
RBF (rtol = atol = 1e-5); bf16 within 0.05 on
sigmoid frames: a few bf16 ulps (2^-8) of drift through the decoder, and
the JAX package's CPU backend rounds its bf16 convolutions otherwise than
PyTorch's.
"""

import copy
import json

import numpy as np
import pytest
import torch

import jax

from serving_common import N, T, TOL, jax_noise, live, models, raw
from vae_gp_ode_tpu_torch import serving
import torch_threads  # noqa: F401

BF16_TOL = 0.05


@pytest.fixture(scope='module')
def tiny():
    """The main-config family at test size, in both packages."""
    return models(seed=3)


# -- the model variants -------------------------------------------------------

@pytest.mark.parametrize('kwargs, op', [
    (dict(order=2, frames=3), 'flow_fused_fwd'),
    (dict(solver='dopri5', max_steps=4), 'pathwise_eval_fwd'),
    (dict(solver='adams', max_steps=12, T=3), 'pathwise_eval_fwd'),
    (dict(solver='bdf', T=3), 'pathwise_eval_fwd'),
    (dict(kernel='DF'), 'df_flow_fused_fwd'),
    (dict(dimwise=False), 'flow_fused_fwd'),
], ids=['order2', 'dopri5', 'adams', 'bdf', 'DF', 'shared'])
def test_export_model_variants(tiny, kwargs, op):
    """Each configuration exports at a fixed batch and serves the JAX live
    forecaster's frames at its noise, through its operator. The solvers
    are model fields: their variants are the main one's model with the
    field set. The trace unrolls an adaptive solver's max_steps candidate
    steps and bdf's Newton iterations, so these run at T=3 where that
    shortens them, with max_steps above the candidate steps they take
    here (dopri5 2, adams 9): a loop cut short ends at a state that
    rounding moves in either package."""
    kwargs = dict(kwargs)
    T_in = kwargs.pop('T', T)
    solver = {k: kwargs.pop(k) for k in ('solver', 'max_steps')
              if k in kwargs}
    if kwargs:
        jm, jv, jgp, tm, tgp = models(seed=1, **kwargs)
    else:
        jm, jv, jgp, tm, tgp = tiny
        jm, tm = jm.clone(**solver), copy.deepcopy(tm)
        for name, value in solver.items():
            setattr(tm, name, value)
    fc = serving.export_forecaster(tm, None, tgp, T=T_in, batch=2, L=1,
                                   device='cpu')
    assert f'vae_gp_ode_torch.{op}.default' in {
        str(n.target) for n in fc.program.graph.nodes}
    assert fc.meta['plain_evals'] is False
    X = (raw(2, 2, T_in) - serving.MNIST_MEAN) / serving.MNIST_STD
    out = fc.call(X, jax_noise(jax.random.PRNGKey(1),
                                fc.meta['noise_spec'], 2))
    np.testing.assert_allclose(out.numpy(), live(jm, jv, jgp, X, 1, L=1),
                               **TOL)


# -- bdf: Newton Jacobians through the Jacobian operators ---------------------

BDF_T = 3


@pytest.fixture(scope='module')
def bdf_main(tiny):
    """The main-config family with bdf, exported once with a symbolic
    batch for the CPU and the card: (JAX model, variables, gp, artifact)."""
    jm, jv, jgp, tm, tgp = tiny
    tm = copy.deepcopy(tm)
    tm.solver = 'bdf'
    fc = serving.export_forecaster(tm, None, tgp, T=BDF_T, L=1,
                                   platforms=('cpu', 'cuda'), device='cpu')
    return jm.clone(solver='bdf'), jv, jgp, fc


@pytest.mark.parametrize('variant', ['order1', 'order2', 'DF'])
def test_bdf_artifact_with_a_symbolic_batch(bdf_main, variant):
    """bdf exported with batch=None: its Newton Jacobians are the
    Jacobian operator of its kernel family, no plain per-step eval is
    traced (meta 'plain_evals' false), and it serves N = 1, 2 and 5
    sequences: the frames of JAX's live bdf forecaster for 5 sequences at
    its noise, row by row (each sequence's Newton iterations are its
    own)."""
    if variant == 'order1':
        jm, jv, jgp, fc = bdf_main
    else:
        kw = dict(order=2, frames=3) if variant == 'order2' else dict(
            kernel='DF')
        jm, jv, jgp, tm, tgp = models(seed=1, **kw)
        jm, tm = jm.clone(solver='bdf'), copy.deepcopy(tm)
        tm.solver = 'bdf'
        fc = serving.export_forecaster(tm, None, tgp, T=BDF_T, L=1,
                                       device='cpu')
    fam = 'df_pathwise' if variant == 'DF' else 'pathwise'
    targets = {str(n.target) for n in fc.program.graph.nodes}
    assert {f'vae_gp_ode_torch.{fam}_eval_jac.default',
            f'vae_gp_ode_torch.{fam}_eval_fwd.default'} <= targets
    assert fc.meta['plain_evals'] is False and fc.input_shape[0] == 'b'
    X = (raw(5, 5, BDF_T) - serving.MNIST_MEAN) / serving.MNIST_STD
    noise = jax_noise(jax.random.PRNGKey(4), fc.meta['noise_spec'], 5)
    ref = live(jm, jv, jgp, X, 4, L=1)
    for n in (1, 2, 5):
        rows = {k: np.asarray(v)[:n] if k in ('z0', 'v0') else v
                for k, v in noise.items()}
        out = fc.call(X[:n], rows)
        assert out.shape == (1, n, BDF_T, 1, 28, 28)
        np.testing.assert_allclose(out.numpy(), ref[:, :n], **TOL)


def test_bdf_exports_for_the_card(bdf_main, tmp_path):
    """A bdf export on the CPU for the CPU and the card succeeds (its
    Jacobians are operators, which launch the VJP kernels on the card),
    and its manifest names both platforms."""
    fc = bdf_main[3]
    path = str(tmp_path / 'bdf.pt2')
    serving.save_forecaster(fc, path)
    with open(f'{path}.manifest.json') as f:
        manifest = json.load(f)
    assert manifest['platforms'] == ['cpu', 'cuda']
    assert manifest['solver'] == 'bdf' and not manifest['plain_evals']


def test_artifact_with_plain_evals_refuses_the_card(bdf_main, tmp_path,
                                                    monkeypatch):
    """An artifact whose meta says its trace holds plain per-step evals (a
    bdf forecaster traced before its Jacobians were operators): a load on
    the card (as `resolve_device` would answer there) raises naming the
    solver, before the program moves."""
    fc = bdf_main[3]
    old = serving.Forecaster(fc.program, dict(fc.meta, plain_evals=True))
    path = str(tmp_path / 'bdf_plain.pt2')
    serving.save_forecaster(old, path)
    monkeypatch.setattr(serving, 'resolve_device',
                        lambda device: torch.device('cuda'))
    with pytest.raises(RuntimeError, match='bdf solver.*CPU only'):
        serving.load_forecaster(path)


def test_bf16_artifact(tiny):
    """dtype='bf16': float32 frames within BF16_TOL of the f32 artifact
    and of JAX's bf16 forecaster at the same noise, not equal to the f32
    frames, with bf16 convolutions in the program."""
    jm, jv, jgp, tm, tgp = tiny
    f32 = serving.export_forecaster(tm, None, tgp, T=T, batch=N, L=1,
                                    device='cpu')
    b16 = serving.export_forecaster(tm, None, tgp, T=T, batch=N, L=1,
                                    dtype='bf16', device='cpu')
    X = (raw(8) - serving.MNIST_MEAN) / serving.MNIST_STD
    noise = jax_noise(jax.random.PRNGKey(3), b16.meta['noise_spec'], N)
    yf, yb = f32.call(X, noise), b16.call(X, noise)
    assert yb.dtype == torch.float32 and bool(torch.isfinite(yb).all())
    diff = float((yf - yb).abs().max())
    assert 0.0 < diff < BF16_TOL, diff
    assert b16.meta['dtype'] == 'bf16'
    assert any(n.op == 'call_function' and 'conv' in str(n.target)
               and n.meta['val'].dtype == torch.bfloat16
               for n in b16.program.graph.nodes)
    jref = live(jm, jv, jgp, X, 3, L=1, dtype='bf16')
    assert float(np.abs(yb.numpy() - jref).max()) < BF16_TOL
    with pytest.raises(ValueError, match='dtype'):
        serving.make_forecast_fn(tm, None, tgp, dtype='fp8', device='cpu')
