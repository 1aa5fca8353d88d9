"""Hopper kernels of the port and their plain PyTorch versions.

`LAUNCHES` counts, per kernel, the launches its wrapper made: each wrapper
adds one where it launches its CUDA kernel and nowhere else, so a run can
show that its path went through the kernels.
"""

LAUNCHES = {'flow_fused_fwd': 0, 'flow_fused_bwd': 0, 'pathwise_fwd': 0,
            'pathwise_bwd': 0, 'df_flow_fused_fwd': 0, 'df_flow_fused_bwd': 0,
            'df_pathwise_fwd': 0, 'df_pathwise_bwd': 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
