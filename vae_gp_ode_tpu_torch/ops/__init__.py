"""Hopper kernels of the port and their plain PyTorch versions.

`LAUNCHES` counts, per kernel, the launches its wrapper made: each wrapper
adds one (`count`) where it launches its CUDA kernel and nowhere else, so a
run can show that its path went through the kernels; `SHAPES` splits the
same launches by the shape key the wrapper gives (the per-step kernels:
(L, N, D, K, S, M) for RBF, (L, N, D, S*D, M) for DF; the trajectory
kernels add T). `card_properties` gives the card's figures that the
per-step dispatch rules read.
"""

import collections
import functools

import torch

LAUNCHES = {'flow_fused_fwd': 0, 'flow_fused_bwd': 0, 'pathwise_fwd': 0,
            'pathwise_bwd': 0, 'df_flow_fused_fwd': 0, 'df_flow_fused_bwd': 0,
            'df_pathwise_fwd': 0, 'df_pathwise_bwd': 0,
            'pathwise_tiled_fwd': 0, 'pathwise_tiled_bwd': 0,
            'df_pathwise_tiled_fwd': 0, 'df_pathwise_tiled_bwd': 0}


SHAPES = collections.Counter()


def count(name, shape):
    """One launch of kernel `name` at the shape key `shape`."""
    LAUNCHES[name] += 1
    SHAPES[name, shape] += 1


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SHAPES.clear()


@functools.lru_cache(maxsize=None)
def _properties(index):
    p = torch.cuda.get_device_properties(index)
    return p.multi_processor_count, p.shared_memory_per_block_optin


def device_index(device):
    """The index of `device`: for a CUDA device that names none, the
    current device's."""
    if device.index is None and device.type == 'cuda':
        return torch.cuda.current_device()
    return device.index


def card_properties(device):
    """(SM count, shared-memory opt-in bytes per block) of CUDA `device`."""
    return _properties(device_index(device))
