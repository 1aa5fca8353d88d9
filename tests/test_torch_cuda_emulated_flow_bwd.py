"""The RBF euler pair's discrete adjoint #2 and its summing kernel
(`csrc/flow_fused_bwd.cu`) under the CPU emulation, on the cases, the
libraries and the helpers of tests/test_torch_cuda_emulated_flow.py
(which holds the trajectory #1): per-draw cotangents for per-draw
operands, sums over the draws for shared ones and for a shared z0,
against autograd through `packed_flow_reference` at chip_smoke.py's
tolerance (1e-4 (1 + max |plain|)), the plan pinned, two launches the
same bits. The module skips without a C++20 g++.
"""

import numpy as np
import pytest
import torch

from vae_gp_ode_tpu_torch.ops import flow_fused

from test_torch_cuda_emulated import TOL
from test_torch_cuda_emulated_flow import (  # noqa: F401
    CASES, DEV0, _case, emulated, libs, optin)


def _assert_cotangents(bars, refs):
    for a, b in zip(bars, refs):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= TOL * (1 + float(
            b.abs().max())), float((a - b).abs().max())


@pytest.mark.parametrize(
    'L,N,K,S,M,T,order,gp_per_draw,draws_shared,z0_shared,limit,plan', CASES)
def test_adjoint_matches_plain(emulated, optin, L, N, K, S, M, T, order,
                               gp_per_draw, draws_shared, z0_shared, limit,
                               plan):
    """The adjoint and its summing kernel: per-draw cotangents for
    per-draw operands, sums over the draws for shared ones and, where
    `z0_shared`, for z0."""
    z0, packed, dts = _case(200 + K + N, L, N, K, S, M, T, order,
                            gp_per_draw, draws_shared, z0_shared)
    optin(limit)
    D = K * order
    with torch.no_grad():
        zs = flow_fused.packed_flow_reference(z0, *packed, dts, T, order)
    zs = zs.reshape((L, T, N, D)).contiguous()
    zsbar = torch.as_tensor(np.random.default_rng(300 + K).standard_normal(
        zs.shape).astype(np.float32))
    assert flow_fused.bwd_plan(L, N, D, K, S, M, order, DEV0) == plan
    bars = flow_fused._launch_bwd(zs, zsbar, packed, dts, T, order,
                                  z0_shared)
    ref = list(flow_fused.packed_flow_vjp_reference(zs, zsbar, *packed, dts,
                                                    T, order))
    if z0_shared:
        ref[0] = ref[0].sum(0)
    _assert_cotangents(bars, ref)
    again = flow_fused._launch_bwd(zs, zsbar, packed, dts, T, order,
                                   z0_shared)
    assert all(torch.equal(a, b) for a, b in zip(again, bars))
