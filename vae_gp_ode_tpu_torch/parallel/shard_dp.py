"""Data-parallel training over a `torch.distributed` process group (port of
`vae_gp_ode_tpu/parallel/shard_dp.py`): the per-rank step, which keeps
the port's kernels on every rank.

The process group takes the place of JAX's device mesh: every rank runs
this module's step on its own device (the GPU, or the CPU with gloo), on
its equal share of the global batch, with the state replicated (the same
on every rank, `data_parallel.replicate`). The cross-rank semantics are
JAX's, point by point:

  * The encoder's reparameterisation noise is drawn for the GLOBAL batch
    (N, q) on every rank, from the same generator state, and each rank
    slices its rows (the model's `noise=` hook): the draws a single
    device would take for the whole batch.
  * Every rank draws the same L GP function samples, as one device would.
  * BatchNorm statistics are the global batch's (`models.vae.BatchNorm2d`
    with the group: a differentiable all-reduce of the statistics).
  * The rank's ELBO is averaged over the ranks (differentiable) before
    backward, and the gradients after it; with equal shares the mean is
    the global batch's gradient. Every rank then applies the same Adam
    update (and the same NaN guard: the averaged loss is one value).

So one step over R ranks is the single-device step on the whole batch at
the same noise, up to f32 rounding (tests/test_torch_parallel.py; on the
card, chip_smoke.py phase 6i). On the GPU each rank launches the fused
trajectory kernel and its adjoint (#1/#2 for RBF, #7/#8 for DF) on its
rows, as the single-device step does on all of them.
"""

import contextlib

import torch
import torch.distributed as dist

from vae_gp_ode_tpu_torch.core.collectives import all_reduce_mean
from vae_gp_ode_tpu_torch.kernels.rbf import rbf_variance
from vae_gp_ode_tpu_torch.models.vae import BatchNorm2d
from vae_gp_ode_tpu_torch.training.trainer import (
    _bn_stats, apply_gradients, loss_fn, run_epoch_with_tail, segment_of,
    set_train_mode,
)


def rank_rows(n_global, group=None):
    """This rank's rows [start, stop) of a global batch of `n_global`;
    raises unless the ranks' shares are equal."""
    world = dist.get_world_size(group)
    if n_global % world:
        raise ValueError(f'a batch of {n_global} sequences does not split '
                         f'evenly over {world} ranks')
    n = n_global // world
    r = dist.get_rank(group)
    return r * n, (r + 1) * n


@contextlib.contextmanager
def batchnorm_group(model, group):
    """The model's BatchNorm layers take their statistics over `group`
    inside the block."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.group = group
    try:
        yield
    finally:
        for m in bns:
            m.group = None


def _global_noise(state, n_global, L, generator):
    from vae_gp_ode_tpu_torch.serving import forecast_noise
    return forecast_noise(state.gp, state.model, n_global, L, generator)


def _make_sharded_step(num_observations, eps_guard, group):
    group = dist.group.WORLD if group is None else group

    def sharded_step(state, batch, L: int, generator=None, noise=None):
        n_global = batch.shape[0]
        lo, hi = rank_rows(n_global, group)
        if noise is None:
            noise = _global_noise(state, n_global, L, generator)
        local = dict(noise)
        for k in ('z0', 'v0'):
            if k in local:
                local[k] = local[k][lo:hi]
        model = set_train_mode(state)
        bn = _bn_stats(model)
        saved = [b.clone() for b in bn]
        for p in state.params():
            p.grad = None
        with batchnorm_group(model, group):
            loss, (nll, kl_reg, kl_u, nfe) = loss_fn(
                state, batch[lo:hi], L, num_observations, eps_guard,
                noise=local)
            loss = all_reduce_mean(loss, group)
            loss.backward()
        grads = [p.grad for p in state.params()]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat /= dist.get_world_size(group)
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(
            flat.split([g.numel() for g in grads]), grads)])
        ok = torch.isfinite(loss)
        apply_gradients(state, ok)
        with torch.no_grad():
            for b, old in zip(bn, saved):
                torch.where(ok, b, old, out=b)
            terms = torch.stack([nll.detach(), kl_reg.detach()])
            dist.all_reduce(terms, group=group)
            terms /= dist.get_world_size(group)
            return {'loss': loss.detach(), 'nll': terms[0],
                    'kl_reg': terms[1], 'kl_u': kl_u.detach(),
                    'nfe': (nfe.detach() if torch.is_tensor(nfe) else
                            torch.full((), nfe, device=loss.device)),
                    'kernel_var': rbf_variance(state.gp.kernel)}

    return sharded_step


def make_shardmap_train_step(num_observations: float,
                             eps_guard: bool = False, group=None):
    """Returns train_step(state, batch, L, generator=None, noise=None) ->
    metrics, with `training.trainer.make_train_step`'s signature and
    semantics: `batch` is the GLOBAL batch (every rank holds it, as every
    rank loads the same data), of which this rank trains on its share of
    rows (the batch must split evenly); `noise`, the global batch's raw
    draws, or `generator` (the same state on every rank) draws them. The
    metrics are the global batch's, the same on every rank. A state with a
    frozen VAE takes the frozen step (eval-mode encoder and decoder, whose
    statistics no rank moves)."""
    return _make_sharded_step(num_observations, eps_guard, group)


def make_shardmap_train_epoch(num_observations: float,
                              eps_guard: bool = False, group=None):
    """Returns epoch(state, batches, tail, L, generator=None) -> metrics
    stacked per step: the per-rank step over each global batch of
    `batches` (I, B, ...) and the ragged tail (or None), as
    `training.trainer.run_epoch_with_tail`; B and the tail must split
    evenly over the ranks."""
    step = make_shardmap_train_step(num_observations, eps_guard, group)

    def epoch(state, batches, tail, L: int, generator=None):
        return run_epoch_with_tail(step, state, batches, tail, L, generator)

    return epoch


def make_shardmap_train_segment(num_observations: float,
                                eps_guard: bool = False, group=None):
    """`training.trainer.make_train_segment` over the per-rank step: E
    epochs of data-parallel steps, each followed by the monitoring eval,
    which every rank runs on the whole first test batch (replicated, as
    JAX's data-parallel segment does). X and Xte are the global data on
    every rank; each step's global batch is split over the ranks."""
    return segment_of(make_shardmap_train_step(num_observations, eps_guard,
                                               group))
