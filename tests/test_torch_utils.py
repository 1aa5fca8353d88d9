"""The port's run-directory, summary and plotting utilities
(`utils/io.py`, `utils/summary.py`, `utils/plotting.py`) against the JAX
package's on the CPU, and the CLIs' figures with and without matplotlib:

  * `save_args` writes JAX's JSON (the same filter of argument types);
    `get_logger` JAX's handlers;
  * `summarize`'s per-tensor counts and totals equal JAX's for the same
    VAE and GP (the VAE's tensors in another order and layout: the same
    counts);
  * `_pca2` equals JAX's (the same numpy), `plot_trace`'s .npy dumps are
    JAX's bit for bit, `visualize_output`'s MSE equals JAX's (1e-7
    relative; float32 means in numpy in both);
  * every public function writes its PNG where matplotlib imports;
  * with matplotlib's import made to fail, the three CLIs (main, main_vae,
    evaluate) still run to the end at a tiny size, write every .npy and
    no PNG, and log one line naming the figures left out.
"""

import argparse
import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

import jax

from vae_gp_ode_tpu.models.odegpvae import init_model as jinit_model
from vae_gp_ode_tpu.training import meters as jmeters
from vae_gp_ode_tpu.utils import io as jio
from vae_gp_ode_tpu.utils import plotting as jplotting
from vae_gp_ode_tpu.utils import summary as jsummary

from vae_gp_ode_tpu_torch import evaluate, main_vae
from vae_gp_ode_tpu_torch import main as tmain
from vae_gp_ode_tpu_torch.models.odegpvae import init_model
from vae_gp_ode_tpu_torch.training import meters
from vae_gp_ode_tpu_torch.utils import io, plotting, summary

import test_torch_train as ttr
import torch_threads  # noqa: F401


def test_save_args_and_logger_match_jax(tmp_path):
    args = argparse.Namespace(b=True, a=3, lr=1e-3, name='x', none=None,
                              shape=[1, 2], dtype=torch.float32,
                              pair=(1, 2), table={'k': 1})
    io.save_args(args, tmp_path / 'mine.json')
    jio.save_args(args, tmp_path / 'jax.json')
    assert (tmp_path / 'mine.json').read_text() == \
        (tmp_path / 'jax.json').read_text()
    assert list(json.loads((tmp_path / 'mine.json').read_text())) == [
        'a', 'b', 'lr', 'name', 'none', 'shape']
    assert io.makedirs(str(tmp_path / 'a' / 'b')) == str(tmp_path / 'a' /
                                                          'b')
    log = io.get_logger(str(tmp_path / 'logs'), name='test_torch_utils')
    assert [type(h) for h in log.handlers] == [logging.FileHandler,
                                               logging.StreamHandler]
    log.info('hello')
    log.handlers[0].flush()
    assert (tmp_path / 'logs').read_text().endswith(' hello\n')
    assert not io.get_logger(None, name='test_torch_utils',
                             displaying=False).handlers


def _counts(text):
    """{'<first path part>': [counts]} and the TOTAL of a summary."""
    per, total = {}, None
    for line in text.splitlines()[1:]:
        path, n = line.split()[0], int(line.split()[-1].replace(',', ''))
        if path == 'TOTAL':
            total = n
        else:
            per.setdefault(path.split('/')[0], []).append(n)
    return per, total


@pytest.mark.parametrize('order,kernel', [(2, 'RBF'), (1, 'DF')])
def test_summaries_match_jax(order, kernel):
    q, nf = 3, 4
    jmodel, variables, jgp = jinit_model(
        jax.random.PRNGKey(0), latent_dim=q, n_filt=nf, order=order,
        frames=3, num_features=16, num_inducing=8, kernel=kernel, batch=2,
        T=4)
    model, gp = init_model(0, latent_dim=q, n_filt=nf, order=order,
                           frames=3, num_features=16, num_inducing=8,
                           kernel=kernel, device='cpu')
    mine, ref = _counts(summary.summarize(model, 'vae params')), _counts(
        jsummary.summarize(variables['params'], 'vae params'))
    assert mine[1] == ref[1] == summary.param_count(model) == \
        jsummary.param_count(variables['params'])
    assert {k: sorted(v) for k, v in mine[0].items()} == {
        k: sorted(v) for k, v in ref[0].items()}
    mine, ref = _counts(summary.summarize(gp, 'gp params')), _counts(
        jsummary.summarize(jgp, 'gp params'))
    assert mine == ref
    lines = []
    summary.print_summary(model, gp, log=lines.append)
    assert [s.splitlines()[0] for s in lines] == ['--- vae params ---',
                                                  '--- gp params ---']
    assert summary.param_count({'a': torch.zeros(2, 3)}) == 6


def _meters(mod, seed):
    rng = np.random.default_rng(seed)
    ms = [mod.CachedRunningAverageMeter(10) for _ in range(4)]
    hyp = mod.CachedHyperparams()
    for it in range(12):
        for m in ms:
            m.update(float(rng.standard_normal()), it)
        hyp.update(rng.uniform(0.5, 1.0, 3).astype(np.float32), it)
    return ms, hyp


def test_plot_functions_match_jax_and_write_their_pngs(tmp_path):
    rng = np.random.default_rng(1)
    Z = rng.standard_normal((40, 5))
    np.testing.assert_array_equal(plotting._pca2(Z), jplotting._pca2(Z))
    for d in ('mine', 'jax'):
        os.makedirs(tmp_path / d / 'plots')
    (ms, hyp), (jms, _) = _meters(meters, 2), _meters(jmeters, 2)
    plotting.plot_trace(*ms, str(tmp_path / 'mine'))
    jplotting.plot_trace(*jms, str(tmp_path / 'jax'), make_plot=False)
    for name in ('elbo', 'nll', 'zkl', 'inducingkl'):
        np.testing.assert_array_equal(
            np.load(tmp_path / 'mine' / f'{name}.npy'),
            np.load(tmp_path / 'jax' / f'{name}.npy'))
    x = rng.random((20, 28, 28)).astype(np.float32)
    y = rng.random((20, 28, 28)).astype(np.float32)
    out = str(tmp_path / 'mine')
    mse = plotting.visualize_output(x, y, out)
    np.testing.assert_allclose(mse, jplotting.visualize_output(
        x, y, str(tmp_path / 'jax')), rtol=1e-7)
    X = rng.random((4, 3, 1, 28, 28)).astype(np.float32)
    zt = rng.standard_normal((1, 4, 3, 6))
    mus, labels = rng.standard_normal((30, 3)), rng.integers(0, 4, 30)
    plotting.plot_params(hyp, out)
    plotting.plot_rot_mnist(X, X, fname=os.path.join(out, 'rot.png'))
    plotting.plot_rollout(X[None], fname=os.path.join(out, 'roll.png'))
    plotting.plot_rand_rot_mnist(X.reshape(-1, 1, 28, 28),
                                 X.reshape(-1, 1, 28, 28),
                                 fname=os.path.join(out, 'rand.png'))
    plotting.plot_data(X, fname=os.path.join(out, 'data.png'))
    plotting.plot_latent_dynamics(zt, order=2,
                                  fname=os.path.join(out, 'dyn'))
    plotting.plot_vae_embeddings(mus, labels, 4, out)
    plotting.visualize_embeddings(mus, labels, 4, out)
    plotting.plot_trace_vae(*ms[:3], out)
    assert plotting.available()
    assert sorted(os.listdir(out)) == sorted([
        'data.png', 'dyn_state.png', 'dyn_velocity.png', 'elbo.npy',
        'inducingkl.npy', 'nll.npy', 'plots', 'rand.png', 'roll.png',
        'rot.png', 'vae_embeddings_pca.png', 'vae_embeddings_tsne.png',
        'vae_reconstructions.png', 'zkl.npy'])
    assert sorted(os.listdir(os.path.join(out, 'plots'))) == [
        'hyperparams.png', 'optimization_trace.png', 'vae_trace.png']


def _pngs(root):
    return [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
            if f.endswith('.png')]


def _left_out(log_path):
    with open(log_path) as f:
        lines = [ln for ln in f if 'figures left out' in ln]
    assert len(lines) == 1, lines
    return sorted(lines[0].split('figures left out: ')[1].strip().split(
        ', '))


def test_clis_without_matplotlib(tmp_path, monkeypatch):
    """matplotlib's import fails: main, main_vae and evaluate run to the
    end, write their .npy files and checkpoints and no PNG, and each logs
    one line naming the figures it left out."""
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    assert not plotting.available()
    result = tmain.run(ttr._cli_args(tmp_path))
    save = result['save']
    assert _pngs(save) == []
    assert sorted(os.listdir(save)) == ttr.RUN_FILES
    assert os.listdir(os.path.join(save, 'plots')) == []
    assert _left_out(os.path.join(save, 'logs')) == ttr.RUN_PLOTS
    assert set(result['plots']) == {'dynamics_train', 'dynamics_test',
                                    'rollout_original', 'rollout'}
    assert result['plots']['rollout'].shape == (1, 3, 12, 1, 28, 28)

    res = main_vae.run(main_vae.make_parser().parse_args([
        '--device', 'cpu', '--vae_epochs', '1', '--n_train', '2',
        '--n_test', '2', '--n_angle', '4', '--batch', '5', '--n_filt',
        str(ttr.NF), '--latent_dim', str(ttr.Q), '--output_path',
        str(tmp_path / 'vae'), '--save', str(tmp_path / 'frames')]))
    assert _pngs(res['output_path']) == [] and np.isfinite(res['test_mse'])
    assert _left_out(os.path.join(res['output_path'], 'logs')) == [
        'vae_embeddings_pca.png', 'vae_embeddings_tsne.png',
        'vae_reconstructions.png', 'vae_trace.png']
    assert res['embeddings'][0].shape == (8, ttr.Q)

    logger = logging.getLogger(evaluate.logger.name)
    handler = logging.FileHandler(tmp_path / 'eval.log')
    logger.addHandler(handler)
    try:
        evaluate.main(['--model_path', save, '--device', 'cpu', '--L', '1'])
    finally:
        logger.removeHandler(handler)
        handler.close()
    assert sorted(os.listdir(os.path.join(save, 'eval'))) == [
        'rollout.npy', 'rollout_original.npy']
    assert _left_out(tmp_path / 'eval.log') == ['rollout.png',
                                                'rollout_original.png']


def test_main_vae_writes_the_jax_figures(tmp_path):
    """With matplotlib, main_vae's run directory holds JAX main_vae.py's
    files."""
    res = main_vae.run(main_vae.make_parser().parse_args([
        '--device', 'cpu', '--vae_epochs', '1', '--n_train', '2',
        '--n_test', '2', '--n_angle', '4', '--batch', '5', '--n_filt',
        str(ttr.NF), '--latent_dim', str(ttr.Q), '--output_path',
        str(tmp_path / 'vae'), '--save', str(tmp_path / 'frames')]))
    assert sorted(os.listdir(res['output_path'])) == [
        'MNIST-VAE', 'args.json', 'logs', 'plots', 'vae_embeddings_pca.png',
        'vae_embeddings_tsne.png', 'vae_reconstructions.png']
    assert os.listdir(os.path.join(res['output_path'], 'plots')) == [
        'vae_trace.png']
