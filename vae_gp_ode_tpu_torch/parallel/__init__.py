"""Data and feature parallelism over `torch.distributed` process groups
(port of `vae_gp_ode_tpu/parallel`; the process group takes the place of
JAX's device mesh)."""

from vae_gp_ode_tpu_torch.parallel.data_parallel import (  # noqa: F401
    make_parallel_train_step, make_parallel_train_epoch, shard_batch,
    shard_epoch, replicate,
)
from vae_gp_ode_tpu_torch.parallel.feature_parallel import (  # noqa: F401
    fp_draw_fn_sample, fp_fn_eval, fp_flow_forward, ShardedSample, shard_sample,
)
from vae_gp_ode_tpu_torch.parallel.shard_dp import (  # noqa: F401
    make_shardmap_train_step, make_shardmap_train_epoch,
    make_shardmap_train_segment,
)
