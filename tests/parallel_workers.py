"""The ranks of the port's data- and feature-parallel tests
(tests/test_torch_parallel.py): `run_ranks` starts R processes of this
module on the CPU, which join a gloo process group through a `file://`
rendezvous, run the jobs the test wrote (numpy inputs, pickled), and each
write their results back. The module imports no JAX, so a rank starts in
about the time torch takes to import."""

import os
import pickle
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def run_ranks(world, jobs, tmp_path, timeout=240):
    """Run `jobs` ([(name, kwargs)]) on `world` ranks; returns each rank's
    list of results. A rank that fails or outlives `timeout` seconds fails
    the caller, with its output; every rank is stopped before this
    returns."""
    tmp_path = str(tmp_path)
    job_file = os.path.join(tmp_path, 'jobs.pkl')
    with open(job_file, 'wb') as f:
        pickle.dump(jobs, f)
    init = 'file://' + os.path.join(tmp_path, 'rendezvous')
    env = dict(os.environ, OMP_NUM_THREADS='1',
               PYTHONPATH=os.pathsep.join([ROOT, HERE]))
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'parallel_workers', init, str(world),
         str(rank), job_file], cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {rank} failed:\n{out[-4000:]}'
    results = []
    for rank in range(world):
        with open(os.path.join(tmp_path, f'rank{rank}.pkl'), 'rb') as f:
            results.append(pickle.load(f))
    return results


# -- jobs (run on every rank) --------------------------------------------------

def _state(np_state, config):
    from vae_gp_ode_tpu_torch.utils.jax_import import train_state_from_jax
    return train_state_from_jax(np_state, device='cpu', **config)


def _t(noise):
    import torch
    return {k: torch.as_tensor(v) for k, v in noise.items()}


def _metrics(m):
    return {k: np.asarray(v.detach().cpu().numpy()) for k, v in m.items()}


def job_step(np_state, config, X, noise, L, ndata):
    """One per-rank train step at the global batch's noise: the metrics,
    the averaged gradient of every optimised leaf (by the port's names)
    and the BatchNorm running statistics after the step."""
    import torch
    from vae_gp_ode_tpu_torch.parallel import make_shardmap_train_step
    from vae_gp_ode_tpu_torch import ops
    state = _state(np_state, config)
    before = dict(ops.LAUNCHES)
    m = make_shardmap_train_step(ndata, eps_guard=True)(
        state, torch.as_tensor(X), L, noise=_t(noise))
    assert ops.LAUNCHES == before
    return {'metrics': _metrics(m),
            'grads': {n: p.grad.numpy().copy() for n, p in zip(
                state.param_names(), state.params())},
            'buffers': {n: b.numpy().copy() for n, b in
                        state.model.named_buffers()}}


def job_epoch(np_state, config, batches, tail, L, seed, ndata):
    """`make_parallel_train_epoch` (data_parallel's entry) over the global
    batches with the generator at `seed` on every rank."""
    import torch
    from vae_gp_ode_tpu_torch.parallel import make_parallel_train_epoch
    state = _state(np_state, config)
    gen = torch.Generator().manual_seed(seed)
    m = make_parallel_train_epoch(ndata, eps_guard=True)(
        state, torch.as_tensor(batches),
        None if tail is None else torch.as_tensor(tail), L, gen)
    return {'metrics': _metrics(m), 'step': int(state.step)}


def job_segment(np_state, config, X, heads, tails, Xte, test_idx, L, seed,
                ndata):
    """`make_shardmap_train_segment` over E epochs with the generator at
    `seed` on every rank."""
    import torch
    from vae_gp_ode_tpu_torch.parallel import make_shardmap_train_segment
    state = _state(np_state, config)
    gen = torch.Generator().manual_seed(seed)
    t = torch.as_tensor
    m, mses = make_shardmap_train_segment(ndata, eps_guard=True)(
        state, t(X), t(heads), None if tails is None else t(tails), t(Xte),
        t(test_idx), L, gen)
    return {'metrics': _metrics(m), 'mses': mses.numpy(),
            'step': int(state.step)}


def job_feature(gp_leaves, noise, x, z0, ts, S, order, seed):
    """The feature-parallel eval and flow of the sample drawn from `noise`
    (split over the ranks by `shard_sample`), the draw with
    local_draws=False (the same bits as `draw_fn_sample` at `seed`) and
    the shard-local draw at `seed`, each evaluated at x."""
    import torch
    from vae_gp_ode_tpu_torch.gp.svgp import draw_fn_sample
    from vae_gp_ode_tpu_torch.parallel import (
        fp_draw_fn_sample, fp_flow_forward, fp_fn_eval, shard_sample)
    from vae_gp_ode_tpu_torch.utils.jax_import import gp_from_jax
    gp = gp_from_jax(gp_leaves)
    x, z0, ts = (torch.as_tensor(a) for a in (x, z0, ts))
    sample = shard_sample(draw_fn_sample(gp, None, S, noise=_t(noise)))
    out = {'cols': sample.rff.weights.shape[0],
           'eval': fp_fn_eval(gp, sample, x).numpy()}
    zs, nfe = fp_flow_forward(gp, sample, z0, ts, order=order)
    out['flow'], out['nfe'] = zs.numpy(), nfe
    for local in (False, True):
        s = fp_draw_fn_sample(gp, torch.Generator().manual_seed(seed), S,
                              local_draws=local)
        out[f'draw_{local}'] = fp_fn_eval(gp, s, x).numpy()
        out[f'nu_{local}'] = s.nu.numpy()
    return out


def job_placement(np_state, config, n):
    """`data_parallel`'s placement: this rank's rows of a batch and of a
    stacked epoch, and a state whose leaves each rank moved by its rank,
    after `replicate` (rank 0's everywhere)."""
    import torch
    import torch.distributed as dist
    from vae_gp_ode_tpu_torch.parallel import (replicate, shard_batch,
                                               shard_epoch)
    state = _state(np_state, config)
    with torch.no_grad():
        for t in state.params() + [state.optimizer.mu]:
            t.add_(dist.get_rank())
    replicate(state)
    x = torch.arange(n)
    return {'batch': shard_batch(x).numpy(),
            'epoch': shard_epoch(torch.stack([x, x + n])).numpy(),
            'params': [p.detach().numpy().copy() for p in state.params()],
            'mu': state.optimizer.mu.numpy().copy()}


JOBS = {'step': job_step, 'epoch': job_epoch, 'segment': job_segment,
        'feature': job_feature, 'placement': job_placement}


def main(init, world, rank, job_file):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=init, world_size=world,
                            rank=rank)
    try:
        with open(job_file, 'rb') as f:
            jobs = pickle.load(f)
        results = [JOBS[name](**kw) for name, kw in jobs]
    finally:
        dist.destroy_process_group()
    out = os.path.join(os.path.dirname(job_file), f'rank{rank}.pkl')
    with open(out + '.tmp', 'wb') as f:
        pickle.dump(results, f)
    os.replace(out + '.tmp', out)


if __name__ == '__main__':
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
