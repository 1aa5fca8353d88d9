"""The port's evaluation (`vae_gp_ode_tpu_torch.evaluate`) against the
repository's `evaluate.py`, and the pretrained workflow as a whole
(`main_vae` -> `main --pretrained` -> `evaluate`), on the CPU at small
sizes.

Tolerances: `compute_mse_std` on the same reconstructions 1e-6 relative
(the port sums in float64, the JAX script in float32), on a small RBF
state with the same draws 1e-5 relative (f32 reconstructions through the
decoder, the GP draw and 7 euler steps); `sigmoid_floor_mse` 1e-6
relative.
"""

import ast
import inspect
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

import evaluate as jevaluate
from vae_gp_ode_tpu.training import trainer as jtrainer

from vae_gp_ode_tpu_torch import evaluate, main as tmain, main_vae
from vae_gp_ode_tpu_torch.serving import load_run_dir
from vae_gp_ode_tpu_torch.training import checkpoint, trainer

from test_torch_train import (
    L, M, NF, Q, S, _X, _jax_noise, _jax_state, _port_state)
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DF_RUN = os.path.join(ROOT, 'checkpoints', 'df_5000ep')


def _jax_keys():
    """The keys of the dict the JAX script's evaluate_one returns."""
    tree = ast.parse(inspect.getsource(jevaluate.evaluate_one))
    ret = [n for n in ast.walk(tree) if isinstance(n, ast.Return)][-1]
    return [k.value for k in ret.value.keys]


def test_compute_mse_std_matches_the_jax_script(monkeypatch):
    """The same fake reconstructions through both compute_mse_std: the
    squared error of every MC sample over the full test set, ddof-1 std
    (not the MC mean's error, which is smaller here)."""
    rng = np.random.RandomState(0)
    batches = [rng.rand(4, 5, 1, 8, 8).astype(np.float32) for _ in range(3)]
    recs = [rng.randn(3, 4, 5, 1, 8, 8).astype(np.float32)
            for _ in range(3)]

    def fake(recs_of):
        calls = iter(recs_of)
        return lambda *a, **k: (lambda *a, **k: (next(calls), None))

    monkeypatch.setattr(jtrainer, 'make_eval_step', fake(recs))
    want = jevaluate.compute_mse_std(None, None, batches, 3,
                                     jax.random.PRNGKey(0))
    monkeypatch.setattr(trainer, 'make_eval_step',
                        fake([torch.as_tensor(r) for r in recs]))
    got = evaluate.compute_mse_std(
        None, [torch.as_tensor(b) for b in batches], 3)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    mc_mean = np.mean([((r.mean(0) - b) ** 2).mean()
                       for r, b in zip(recs, batches)])
    assert got[0] > 1.5 * mc_mean


def test_sigmoid_floor_mse_matches_the_jax_script():
    X = (np.random.default_rng(1).random((6, 4, 1, 28, 28)) - 0.1307) \
        / 0.3081
    np.testing.assert_allclose(evaluate.sigmoid_floor_mse(X),
                               jevaluate.sigmoid_floor_mse(X), rtol=1e-6)
    assert evaluate.sigmoid_floor_mse(np.full((3, 3), 0.5)) == (0.0, 0.0)


def test_compute_mse_std_on_an_rbf_state_matches_the_jax_script():
    """Both compute_mse_std from one small RBF state (eval-mode BatchNorm)
    over two test batches, the port given the draws of the JAX script's
    per-batch keys through the noise hook."""
    model, jstate, _ = _jax_state(1, seed=2)
    tstate = _port_state(jstate, 1)
    batches = [_X(3), _X(4, n=3)]
    key = jax.random.PRNGKey(5)
    want = jevaluate.compute_mse_std(model, jstate, batches, L, key)
    keys = []
    for _ in batches:
        key, k = jax.random.split(key)
        keys.append(k)
    got = evaluate.compute_mse_std(
        tstate, [torch.as_tensor(b) for b in batches], L,
        noise=lambda i, b: _jax_noise(keys[i], 1, n=b.shape[0]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert not tstate.model.training


def _df_copy(tmp_path):
    """checkpoints/df_5000ep without its plots (evaluate writes into the
    run directory)."""
    dst = str(tmp_path / 'df_5000ep')
    shutil.copytree(DF_RUN, dst, ignore=shutil.ignore_patterns('eval'))
    return dst


def test_evaluate_the_shipped_df_checkpoint(tmp_path, capsys):
    """`evaluate --model_path` on the JAX package's npz run directory
    (args.json says device tpu): one JSON line with the JAX script's
    keys, finite errors above the data's floor, and the rollout."""
    run = _df_copy(tmp_path)
    assert checkpoint.checkpoint_format(
        os.path.join(run, 'odegpvae_mnist.ckpt')) == 'npz'
    assert evaluate.main(['--model_path', run, '--device', 'cpu', '--L',
                          '1', '--Troll', '1', '--batch', '25']) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert list(out) == _jax_keys()
    assert (out['kernel'], out['ode'], out['L'], out['rollout_T']) == (
        'DF', 1, 1, 16)
    assert np.isfinite(out['mse_mean']) and out['mse_excess'] > 0
    assert np.load(os.path.join(run, 'eval', 'rollout.npy')).shape == (
        1, 3, 16, 1, 28, 28)
    assert np.load(os.path.join(run, 'eval', 'rollout_original.npy')
                   ).shape == (3, 16, 1, 28, 28)


def test_pretrained_workflow_end_to_end(tmp_path, capsys):
    """main_vae -> main --pretrained -> evaluate --model_paths at a tiny
    size on the CPU: the run reads the pretrained encoder and decoder,
    trains the GP alone (the VAE and its encoder's and decoder's
    statistics bit for bit as pretrained), writes a frozen checkpoint
    that load_run_dir restores, and evaluate prints the table and a JSON
    list with the JAX script's keys."""
    vargs = main_vae.make_parser().parse_args([
        '--device', 'cpu', '--vae_epochs', '1', '--n_train', '2',
        '--n_test', '2', '--n_angle', '4', '--batch', '4', '--n_filt',
        str(NF), '--latent_dim', str(Q), '--output_path',
        str(tmp_path / 'vae'), '--save', str(tmp_path / 'frames')])
    pre = main_vae.run(vargs)
    args = tmain.make_parser().parse_args([
        '--device', 'cpu', '--Nepoch', '2', '--batch', '4', '--Ndata', '6',
        '--Ntest', '4', '--num_inducing', str(M), '--num_features', str(S),
        '--n_filt', str(NF), '--latent_dim', str(Q), '--D_in', str(Q),
        '--D_out', str(Q), '--T', '6', '--save', str(tmp_path / 'run'),
        '--pretrained', 'True', '--vae_path', pre['model_dir']])
    result = tmain.run(args)
    state = result['state']
    assert result['bailout'] is None and int(state.step) == 4
    assert state.freeze_vae and not state.model.training
    for part in ('encoder', 'decoder'):
        for (n, a), b in zip(getattr(state.model, part).state_dict().items(),
                             getattr(pre['vae'], part).state_dict()
                             .values()):
            assert torch.equal(a, b), (part, n)
    model, restored, ta = load_run_dir(result['save'], device='cpu')
    assert restored.freeze_vae and ta.pretrained
    assert torch.equal(restored.optimizer.mu, state.optimizer.mu)

    capsys.readouterr()
    evaluate.main(['--model_paths', result['save'], '--device', 'cpu',
                   '--L', '2'])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split() == ['model', 'kernel', 'ode', 'mse_mean',
                                'mse_std']
    assert lines[1].split()[:3] == [os.path.basename(result['save']), 'RBF',
                                    '1']
    (row,) = json.loads(lines[2])
    assert list(row) == _jax_keys() and np.isfinite(row['mse_mean'])
    assert sorted(os.listdir(os.path.join(result['save'], 'eval'))) == [
        'rollout.npy', 'rollout.png', 'rollout_original.npy',
        'rollout_original.png']


def test_evaluate_needs_a_run():
    with pytest.raises(SystemExit):
        evaluate.main(['--device', 'cpu'])
