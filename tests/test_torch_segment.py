"""Multi-epoch segments of the port's training CLI (`--epochs_per_dispatch`)
against the per-epoch path and the JAX package, on the CPU at a tiny size
(q=3, n_filt 4, S=32, M=16, T=6).

A segment runs E epochs (train steps, ragged tail, monitoring eval) from
index tensors drawn from the loaders' permutation streams and takes the
generator's draws in the per-epoch order, so eager PyTorch gives the
per-epoch run's bits: the comparisons here are exact.
"""

import os

import numpy as np
import pytest
import torch

from vae_gp_ode_tpu.data.mnist import Loader as JLoader

from vae_gp_ode_tpu_torch import main as tmain
from vae_gp_ode_tpu_torch.data.mnist import Loader
from vae_gp_ode_tpu_torch.models.odegpvae import init_model
from vae_gp_ode_tpu_torch.training import checkpoint

from test_torch_train import _cli_args
import torch_threads  # noqa: F401

Q, NF = 3, 4


def _jax_segment_length(ep, Nepoch, plot_freq, E):
    """The JAX `main.py`'s scheduling (its epoch loop, `multi_ok` on the
    single-device path): a segment starts at ep when ep is no artifact
    epoch and the distance to the next epoch that must run singly is at
    least E, transcribed line for line."""
    if not (ep % plot_freq == 0 or ep == Nepoch - 1):
        nxt = Nepoch - 1
        half = Nepoch // 2
        if ep < half:
            nxt = min(nxt, half)
        nxt = min(nxt, ((ep // plot_freq) + 1) * plot_freq)
        if nxt - ep >= E:
            return E
    return 1


def _schedule(length, Nepoch, plot_freq, E):
    """[(first epoch, epochs)] of a run under the rule `length`."""
    out, ep = [], 0
    while ep < Nepoch:
        n = length(ep, Nepoch, plot_freq, E) if E > 1 else 1
        out.append((ep, n))
        ep += n
    return out


@pytest.mark.parametrize('Nepoch,plot_freq,E', [
    (10, 100, 3), (24, 100, 10), (12, 100, 4), (30, 7, 3), (9, 2, 2),
    (5, 100, 1), (40, 10, 4)])
def test_segment_length_follows_the_jax_rule(Nepoch, plot_freq, E):
    got = _schedule(tmain.segment_length, Nepoch, plot_freq, E)
    assert got == _schedule(_jax_segment_length, Nepoch, plot_freq, E)
    assert sum(n for _, n in got) == Nepoch


@pytest.mark.parametrize('n', [12, 14])
def test_index_loaders_match_jax(n):
    """epoch_index_batches / first_index give the JAX Loader's indices from
    the same seed (with and without a ragged tail), and the batches that
    as many epoch_batches_with_tail() / first() calls give."""
    X = np.arange(n, dtype=np.float32)[:, None] * np.ones((1, 2), np.float32)
    mine, ref = Loader(X, 4, seed=3, device='cpu'), JLoader(X, 4, seed=3)
    heads, tails = mine.epoch_index_batches(3)
    jh, jt = ref.epoch_index_batches(3)
    assert heads.dtype == torch.int64 and heads.shape == (3, n // 4, 4)
    np.testing.assert_array_equal(heads.numpy(), np.asarray(jh))
    assert (tails is None) == (jt is None) == (n % 4 == 0)
    if tails is not None:
        np.testing.assert_array_equal(tails.numpy(), np.asarray(jt))
    first = mine.first_index(2)
    np.testing.assert_array_equal(first.numpy(),
                                  np.asarray(ref.first_index(2)))
    again = Loader(X, 4, seed=3, device='cpu')
    for e in range(3):
        batches, tail = again.epoch_batches_with_tail()
        assert torch.equal(batches, mine.X[heads[e]])
        assert (tail is None and tails is None) or torch.equal(
            tail, mine.X[tails[e]])
    for e in range(2):
        assert torch.equal(again.first(), mine.X[first[e]])


@pytest.fixture(autouse=True)
def _one_thread():
    """The runs' ops are tiny: one intra-op thread keeps them fast when
    the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(tmp_path, name, *flags, Nepoch=10, Ndata=14):
    args = _cli_args(tmp_path, '--Nepoch', str(Nepoch), '--Ndata',
                     str(Ndata), '--Ntest', '6', '--plot_freq', '100',
                     '--log_freq', '1000', *flags)
    args.save = str(tmp_path / name)
    seen = []
    result = tmain.run(args, on_step=lambda ep, L: seen.append((ep, L)))
    return result, seen


def test_segments_give_the_per_epoch_bits(tmp_path):
    """The 10-epoch case of the JAX package's tests/test_cli.py (batch 4,
    Ndata 14, Ntest 6, --plot_freq 100): --epochs_per_dispatch 3 runs
    epochs 1-3 and 5-7 as segments, as the JAX rule schedules them, and
    gives the per-step metrics, monitoring mses, (epoch, L) of every step,
    checkpoint epochs and final state (parameters, BatchNorm statistics,
    Adam) of --epochs_per_dispatch 1 bit for bit."""
    one, seen_one = _run(tmp_path, 'e1')
    three, seen_three = _run(tmp_path, 'e3', '--epochs_per_dispatch', '3')
    assert three['segments'] == [(1, 3), (5, 3)] == [
        s for s in _schedule(_jax_segment_length, 10, 100, 3) if s[1] > 1]
    assert one['segments'] == []
    assert seen_three == seen_one == [
        (ep, 1 if ep < 5 else 5) for ep in range(10) for _ in range(4)]
    assert one['ckpt_epochs'] == three['ckpt_epochs'] == [0, 9]
    assert [r['ep'] for r in three['epochs']] == list(range(10))
    for a, b in zip(one['epochs'], three['epochs']):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), (a['ep'], k)
    sa, sb = one['state'], three['state']
    for x, y in zip(sa.params(), sb.params()):
        assert torch.equal(x, y)
    for (n, x), y in zip(sa.model.named_buffers(), sb.model.buffers()):
        assert torch.equal(x, y), n
    for x, y in ((sa.optimizer.mu, sb.optimizer.mu),
                 (sa.optimizer.nu, sb.optimizer.nu), (sa.step, sb.step)):
        assert torch.equal(x, y)
    assert int(sb.step) == 40
    restored = checkpoint.restore_checkpoint(
        three['ckpt'], checkpoint_state())
    assert torch.equal(restored.step, sb.step)


def checkpoint_state():
    from vae_gp_ode_tpu_torch.training import trainer
    return trainer.create_train_state(*init_model(
        0, latent_dim=Q, n_filt=NF, num_features=32, num_inducing=16,
        device='cpu'))


def test_pretrained_segments_check_the_frozen_vae_once_each(tmp_path):
    """--pretrained with --epochs_per_dispatch 2 over 6 epochs: epochs 1-2
    and 3-4 run as segments, the frozen weights are checked once per
    segment and once per single epoch (4 times), and stay as loaded."""
    model, _ = init_model(5, latent_dim=Q, n_filt=NF, random_bn=True,
                          device='cpu')
    vae_dir = tmp_path / 'MNIST-VAE'
    checkpoint.save_vae_weights(model.encoder, model.decoder,
                                str(vae_dir / 'encoder.ckpt'),
                                str(vae_dir / 'decoder.ckpt'))
    result, seen = _run(tmp_path, 'pre', '--pretrained', 'True',
                        '--vae_path', str(vae_dir), '--epochs_per_dispatch',
                        '2', Nepoch=6, Ndata=6)
    assert result['segments'] == [(1, 2), (3, 2)]
    assert result['frozen_checks'] == 4 and len(seen) == 12
    for part in ('encoder', 'decoder'):
        for (n, a), b in zip(
                getattr(result['state'].model, part).state_dict().items(),
                getattr(model, part).state_dict().values()):
            assert torch.equal(a, b), (part, n)


def test_plot_freq_1_warns_that_segments_never_engage(tmp_path):
    result, _ = _run(tmp_path, 'pf1', '--plot_freq', '1',
                     '--epochs_per_dispatch', '2', Nepoch=2, Ndata=6)
    log = open(os.path.join(result['save'], 'logs')).read()
    assert 'have no effect at --plot_freq 1' in log
    assert result['segments'] == [] and result['ckpt_epochs'] == [0, 1]
