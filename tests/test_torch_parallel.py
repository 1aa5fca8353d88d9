"""The port's data and feature parallelism (`vae_gp_ode_tpu_torch/parallel`)
on the CPU: gloo process groups of 2 and 4 ranks, each a process of
tests/parallel_workers.py (a `file://` rendezvous under the test's
tmp_path, a time limit of its own), against the JAX package.

  * One per-rank train step (RBF, and DF) over a global batch of N = 8 at
    the noise of a JAX key (each rank slices its rows of the encoder
    draws, every rank takes the same GP draws) against the JAX
    single-device step's loss_fn and gradients from the same state: ELBO
    terms 1e-4 relative, every averaged gradient 1e-4 of its leaf's
    largest JAX gradient (a bias before a BatchNorm, whose exact gradient
    is 0: of its layer's weight gradient, as tests/test_torch_train.py
    holds it), the global-batch BatchNorm statistics 1e-6 of each
    buffer's largest entry; the same on every rank. The seed gives a
    state where no ReLU input lies within f32 rounding of 0 in one package
    and not in the other: at N = 8, seeds 61, 63, 67 and 69 have such a
    unit already in the single-device port step against JAX (gradients
    2e-4..3e-2 of a leaf's largest; PERF.md section 6).
  * The epoch (`make_parallel_train_epoch`, two batches and a tail) and
    a two-epoch segment (`make_shardmap_train_segment`, with the
    monitoring eval), RBF and DF, from one generator state against the
    port's single-device epoch and segment (held to JAX by
    test_torch_train.py and test_torch_segment.py): metrics 1e-4
    relative, the encoder's KL term 1e-3 (`LOOP_RTOL`).
  * `data_parallel`'s `shard_batch`, `shard_epoch` and `replicate`.
  * Feature parallelism: `fp_fn_eval` and `fp_flow_forward` of a sample
    split over the ranks against JAX `fn_eval` and `flow_forward` of the
    same draws (1e-5 of the largest entry), the replicated draw against
    the one-rank draw at the same generator state, and the shard-local
    draw against an oracle that replays its rank generators.
  * `main --data_parallel True` under torchrun with 2 ranks, and at world
    size 1 (tests/test_torch_train.py): the run directory and the first
    step's ELBO of the single-device run.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_gp_ode_tpu.dynamics import flow as jflow
from vae_gp_ode_tpu.gp import svgp as jsvgp

from vae_gp_ode_tpu_torch.gp import svgp as tsvgp
from vae_gp_ode_tpu_torch.kernels import rbf as trbf
from vae_gp_ode_tpu_torch.parallel import fp_draw_fn_sample
from vae_gp_ode_tpu_torch.training import trainer
from vae_gp_ode_tpu_torch.utils.jax_import import train_state_from_jax

import test_torch_df as tdf
import test_torch_gp as tgp
import test_torch_train as ttr
from parallel_workers import ROOT, run_ranks
import torch_threads  # noqa: F401

N = 8                       # global batch: 4 or 2 rows a rank
WORLDS = (2, 4)
KERNELS = ('RBF', 'DF')
SEED = 65


def _config(kernel):
    return dict(latent_dim=ttr.Q, n_filt=ttr.NF, num_features=ttr.S,
                kernel=kernel)


def _step_case(kernel):
    """(job, reference): a JAX state, data and key, and the JAX step's
    loss_fn terms, gradients and BatchNorm statistics there."""
    if kernel == 'RBF':
        model, jstate, _ = ttr._jax_state(1, seed=SEED)
        key = jax.random.PRNGKey(SEED + 1)
        noise = ttr._jax_noise(key, 1, n=N)
    else:
        model, jstate, _ = tdf._jax_df_state(SEED)
        key = jax.random.PRNGKey(SEED + 1)
        noise = tdf._jax_df_noise(key, ttr.L, n=N)
    X = ttr._X(SEED, n=N)
    (jl, (nll, kl_reg, kl_u, nfe, new_bs)), jg = ttr.jax_loss_and_grads(
        model, (jstate.vae_params, jstate.gp), jstate.batch_stats,
        jnp.asarray(X), key, ttr.NDATA, ttr.L)
    job = ('step', dict(np_state=ttr._np_state(jstate),
                        config=_config(kernel), X=X,
                        noise={k: v.numpy() for k, v in noise.items()},
                        L=ttr.L, ndata=ttr.NDATA))
    ref = {'terms': [float(t) for t in (jl, nll, kl_reg, kl_u)],
           'nfe': int(nfe), 'grads': ttr._named(*jg),
           'bn': ttr._bn_named(new_bs, jstate.vae_params),
           'model': train_state_from_jax(
               ttr._np_state(jstate), device='cpu',
               **_config(kernel)).model}
    return job, ref


def _loop_case(kernel):
    """(epoch job, segment job, references): the port's single-device
    epoch and segment from one state and generator seed."""
    if kernel == 'RBF':
        _, jstate, _ = ttr._jax_state(1, seed=SEED + 2)
    else:
        _, jstate, _ = tdf._jax_df_state(SEED + 2)
    np_state = ttr._np_state(jstate)
    rng = np.random.default_rng(SEED)
    X = ttr._X(SEED + 2, n=2 * N + 4)
    batches, tail = X[:2 * N].reshape((2, N) + X.shape[1:]), X[2 * N:]
    Xte = ttr._X(SEED + 3, n=N)
    heads = np.stack([rng.permutation(2 * N + 4)[:2 * N].reshape(2, N)
                      for _ in range(2)])
    tails = np.stack([np.setdiff1d(np.arange(2 * N + 4), h.ravel())
                      for h in heads])
    test_idx = np.stack([rng.permutation(N) for _ in range(2)])

    def fresh():
        return train_state_from_jax(np_state, device='cpu',
                                    **_config(kernel))

    t = torch.as_tensor
    step = trainer.make_train_step(ttr.NDATA, eps_guard=True)
    epoch = trainer.run_epoch_with_tail(
        step, fresh(), t(batches), t(tail), ttr.L,
        torch.Generator().manual_seed(SEED))
    seg_m, seg_mses = trainer.make_train_segment(ttr.NDATA, True)(
        fresh(), t(X), t(heads), t(tails), t(Xte), t(test_idx), 1,
        torch.Generator().manual_seed(SEED + 1))
    jobs = [('epoch', dict(np_state=np_state, config=_config(kernel),
                           batches=batches, tail=tail, L=ttr.L, seed=SEED,
                           ndata=ttr.NDATA)),
            ('segment', dict(np_state=np_state, config=_config(kernel),
                             X=X, heads=heads, tails=tails, Xte=Xte,
                             test_idx=test_idx, L=1, seed=SEED + 1,
                             ndata=ttr.NDATA))]
    refs = ({k: v.numpy() for k, v in epoch.items()},
            ({k: v.numpy() for k, v in seg_m.items()}, seg_mses.numpy()))
    return jobs, refs


def _feature_case():
    rng = np.random.default_rng(SEED)
    jgp, gp = tgp._gp_pair(rng)
    leaves = {'kernel': {
        'unconstrained_lengthscales':
            gp.kernel.unconstrained_lengthscales.numpy(),
        'unconstrained_variance': gp.kernel.unconstrained_variance.numpy()},
        'inducing_loc': gp.inducing_loc.numpy(), 'Um': gp.Um.numpy(),
        'Us_sqrt': gp.Us_sqrt.numpy()}
    nz = tgp._noise(rng, tgp.Q, tgp.Q)
    x = rng.standard_normal((tgp.N, tgp.Q)).astype(np.float32)
    z0 = rng.standard_normal((tgp.N, tgp.Q)).astype(np.float32)
    ts = (0.1 * np.arange(6)).astype(np.float32)
    js = jsvgp.draw_fn_sample(jgp, None, tgp.S, noise=tgp._j(nz))
    jzs, jnfe = jflow.flow_forward(jgp, js, jnp.asarray(z0),
                                   jnp.asarray(ts), order=1)
    refs = {'eval': np.asarray(jsvgp.fn_eval(jgp, js, jnp.asarray(x))),
            'flow': np.asarray(jzs), 'nfe': int(jnfe), 'gp': gp, 'x': x}
    job = ('feature', dict(gp_leaves=leaves, noise=nz, x=x, z0=z0, ts=ts,
                           S=tgp.S, order=1, seed=SEED))
    return job, refs


@pytest.fixture(scope='module')
def cases():
    jobs, refs = [], {}
    for kernel in KERNELS:
        job, refs[kernel] = _step_case(kernel)
        jobs.append(job)
    for kernel in KERNELS:
        loop_jobs, (refs[f'epoch {kernel}'],
                    refs[f'segment {kernel}']) = _loop_case(kernel)
        jobs += loop_jobs
    job, refs['feature'] = _feature_case()
    np_state = loop_jobs[0][1]['np_state']           # DF's
    jobs += [job, ('placement', dict(np_state=np_state, config=_config(
        'DF'), n=N))]
    refs['placement'] = train_state_from_jax(np_state, device='cpu',
                                             **_config('DF'))
    return jobs, refs


@pytest.fixture(scope='module', params=WORLDS)
def ranks(request, cases, tmp_path_factory):
    """Every job on `world` ranks: (world, [per rank {job: result}],
    references)."""
    jobs, refs = cases
    world = request.param
    out = run_ranks(world, jobs, tmp_path_factory.mktemp(f'world{world}'))
    names = list(KERNELS) + [f'{loop} {k}' for k in KERNELS
                             for loop in ('epoch', 'segment')] + [
        'feature', 'placement']
    return world, [dict(zip(names, r)) for r in out], refs


@pytest.mark.parametrize('kernel', KERNELS)
def test_step_matches_the_jax_single_device_step(ranks, kernel):
    world, results, refs = ranks
    ref = refs[kernel]
    scale = ttr._grad_scales(list(ref['grads']), ref['grads'], ref['model'])
    for rank, res in enumerate(results):
        r = res[kernel]
        m = r['metrics']
        np.testing.assert_allclose(
            [float(m[k]) for k in ('loss', 'nll', 'kl_reg', 'kl_u')],
            ref['terms'], rtol=1e-4, err_msg=f'rank {rank}')
        assert int(m['nfe']) == ref['nfe']
        assert sorted(r['grads']) == sorted(ref['grads'])
        for name, g in r['grads'].items():
            err = np.abs(g - ref['grads'][name]).max()
            assert err <= ttr.GRAD_REL * scale[name], (rank, name, err)
        for name, want in ref['bn'].items():
            err = np.abs(r['buffers'][name] - want).max()
            assert err <= ttr.BN_REL * np.abs(want).max(), (rank, name)
        for name, g in r['grads'].items():      # replicated
            np.testing.assert_array_equal(g, results[0][kernel]['grads'][
                name])


def _assert_metrics(got, want, where):
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=LOOP_RTOL.get(k, 1e-4),
                                   err_msg=f'{where} {k}')


# From the second step on, Adam moves the entries whose gradient is at the
# rounding level (the biases before a BatchNorm) by +-lr in either run,
# and the encoder's KL term, ~0.4, follows by up to ~1e-4 (2.8e-4
# relative on the third step at 4 ranks; tests/test_torch_train.py sees
# the same between the port and JAX)
LOOP_RTOL = {'kl_reg': 1e-3}


@pytest.mark.parametrize('kernel', KERNELS)
def test_epoch_and_segment_match_the_single_device_ones(ranks, kernel):
    world, results, refs = ranks
    for rank, res in enumerate(results):
        epoch, segment = res[f'epoch {kernel}'], res[f'segment {kernel}']
        assert epoch['step'] == 3
        _assert_metrics(epoch['metrics'], refs[f'epoch {kernel}'],
                        f'epoch, rank {rank}')
        want_m, want_mses = refs[f'segment {kernel}']
        assert segment['step'] == 6
        _assert_metrics(segment['metrics'], want_m, f'segment, rank {rank}')
        np.testing.assert_allclose(segment['mses'], want_mses, rtol=1e-4)


def test_feature_parallel_matches_jax(ranks):
    world, results, refs = ranks
    ref = refs['feature']
    gp, x = ref['gp'], torch.as_tensor(ref['x'])
    one = tsvgp.fn_eval(gp, tsvgp.draw_fn_sample(
        gp, torch.Generator().manual_seed(SEED), tgp.S), x).numpy()
    # the shard-local draw's oracle: its seed and rank generators replayed
    g = torch.Generator().manual_seed(SEED)
    seed = int(torch.randint(0, 2 ** 62, (), generator=g))
    parts = [trbf.rbf_sample_rff(gp.kernel, torch.Generator().manual_seed(
        seed + r), tgp.S // world, gp.D_in, gp.D_out) for r in range(world)]
    rff = trbf.RFFState(*(torch.cat([getattr(p, f) for p in parts], dim=d)
                          for f, d in (('omega', 1), ('phase', 1),
                                       ('weights', 0))))
    u = tsvgp.sample_inducing(gp, g)
    nu = trbf.rbf_compute_nu(gp.kernel, trbf.rbf_gram(gp.kernel,
                                                      gp.inducing_loc),
                             trbf.rbf_rff_eval(gp.kernel, rff,
                                               gp.inducing_loc), u)
    oracle = tsvgp.fn_eval(gp, tsvgp.FnSample(rff=rff, nu=nu), x).numpy()
    for res in results:
        r = res['feature']
        assert r['cols'] == tgp.S // world
        tgp.assert_close_scaled(r['eval'], ref['eval'])
        tgp.assert_close_scaled(r['flow'], ref['flow'])
        assert r['nfe'] == ref['nfe']
        tgp.assert_close_scaled(r['draw_False'], one)
        tgp.assert_close_scaled(r['draw_True'], oracle)
        np.testing.assert_array_equal(r['nu_True'], results[0]['feature'][
            'nu_True'])


def test_placement_and_replicate(ranks):
    """shard_batch and shard_epoch give each rank its rows, in rank
    order; replicate broadcasts rank 0's state (every rank moved its own
    by its rank first)."""
    world, results, refs = ranks
    n = N // world
    want = refs['placement']
    for rank, res in enumerate(results):
        r = res['placement']
        np.testing.assert_array_equal(r['batch'], np.arange(
            rank * n, (rank + 1) * n))
        np.testing.assert_array_equal(r['epoch'], np.stack([
            r['batch'], r['batch'] + N]))
        for got, p in zip(r['params'], want.params()):
            np.testing.assert_array_equal(got, p.detach().numpy())
        np.testing.assert_array_equal(r['mu'], want.optimizer.mu.numpy())


def test_feature_parallel_refuses_the_df_kernel():
    gp = tsvgp.init_svgp_params(np.random.default_rng(0), 3, 3, 4,
                                kernel='DF')
    with pytest.raises(ValueError, match='RBF kernel only'):
        fp_draw_fn_sample(gp, torch.Generator(), 8)


def test_cli_under_torchrun_with_two_ranks(tmp_path):
    """`torchrun --nproc_per_node 2 -m vae_gp_ode_tpu_torch.main
    --data_parallel True` on the CPU (gloo): rank 0's run directory holds
    the single-device run's files, the log names the backend, and the
    first step's ELBO is the single-device run's (1e-4 relative)."""
    from vae_gp_ode_tpu_torch import main as tmain
    args = ['--device', 'cpu', '--Nepoch', '2', '--batch', '4', '--Ndata',
            '10', '--Ntest', '4', '--num_inducing', str(ttr.M),
            '--num_features', str(ttr.S), '--n_filt', str(ttr.NF),
            '--latent_dim', str(ttr.Q), '--D_in', str(ttr.Q), '--D_out',
            str(ttr.Q), '--T', '6', '--seed', '3']
    env = dict(os.environ, OMP_NUM_THREADS='1', PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc_per_node', '2', '-m', 'vae_gp_ode_tpu_torch.main',
         '--data_parallel', 'True', '--save', str(tmp_path / 'dp'), *args],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    (dp,) = [p for p in tmp_path.iterdir() if p.name.startswith('dp_')]
    with open(dp / 'logs') as f:
        log = f.read()
    assert 'Data-parallel over 2 ranks (rank 0, gloo backend)' in log
    one = tmain.run(tmain.make_parser().parse_args(
        args + ['--save', str(tmp_path / 'one')]))
    assert sorted(os.listdir(dp)) == sorted(os.listdir(one['save']))
    assert sorted(os.listdir(dp / 'plots')) == sorted(
        os.listdir(os.path.join(one['save'], 'plots')))
    elbo = np.load(dp / 'elbo.npy')
    assert elbo.shape == (6,) and np.isfinite(elbo).all()
    np.testing.assert_allclose(elbo[0], np.load(os.path.join(
        one['save'], 'elbo.npy'))[0], rtol=1e-4)
    with open(dp / 'args.json') as f:
        assert json.load(f)['data_parallel'] is True
