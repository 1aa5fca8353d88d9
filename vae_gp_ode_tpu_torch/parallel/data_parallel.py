"""Data-parallel entry points with the JAX package's names (port of
`vae_gp_ode_tpu/parallel/data_parallel.py`).

JAX's GSPMD path shards the batch by annotation and lets XLA insert the
collectives; torch has no counterpart, so these are thin entries over the
one per-rank step of `parallel.shard_dp` (the step JAX's shard_map path
runs), not a second implementation: `make_parallel_train_step` is
`make_shardmap_train_step`. `replicate`, `shard_batch` and `shard_epoch`
place a state and data as the step expects them.
"""

import torch
import torch.distributed as dist

from vae_gp_ode_tpu_torch.parallel.shard_dp import (
    make_shardmap_train_epoch, make_shardmap_train_step, rank_rows,
)


def replicate(state, group=None, src=0):
    """Broadcast the train state (VAE parameters and BatchNorm statistics,
    GP leaves, Adam's moments and count, the step) from rank `src` to
    every rank of `group`, in place; returns `state`."""
    tensors = (list(state.model.state_dict().values()) + state.gp.parameters()
               + [state.optimizer.mu, state.optimizer.nu,
                  state.optimizer.count, state.step])
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=src, group=group)
    return state


def shard_batch(batch, group=None):
    """This rank's rows of a global batch (B, ...) (B must split evenly
    over the ranks)."""
    lo, hi = rank_rows(batch.shape[0], group)
    return batch[lo:hi]


def shard_epoch(batches, group=None):
    """This rank's rows of each batch of a stacked epoch (I, B, ...)."""
    lo, hi = rank_rows(batches.shape[1], group)
    return batches[:, lo:hi]


def make_parallel_train_step(num_observations: float,
                             eps_guard: bool = False, group=None):
    """The data-parallel train step: `shard_dp.make_shardmap_train_step`."""
    return make_shardmap_train_step(num_observations, eps_guard, group)


def make_parallel_train_epoch(num_observations: float,
                              eps_guard: bool = False, group=None):
    """The data-parallel epoch: `shard_dp.make_shardmap_train_epoch`."""
    return make_shardmap_train_epoch(num_observations, eps_guard, group)
