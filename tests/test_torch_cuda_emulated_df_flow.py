"""The DF euler trajectory #7 and its discrete adjoint #8 with its summing
kernel, run from their own CUDA source (`csrc/df_flow_fused.cu`,
`csrc/df_flow_fused_bwd.cu`) on the CPU as in
tests/test_torch_cuda_emulated_df.py (which holds the per-step pair
#5/#6), and the plans of all four cluster kernels. Held against
`df_euler_flow_reference` and `df_flow_vjp_reference` with chip_smoke.py's
tolerances (abs 1e-4 + rel 1e-4 for outputs; cotangents 1e-4 (1 + max
|plain|)), at D = 1, 6, 12 and 16, with feature columns, inducing points
and rows that leave ragged shares and tiles, clusters of 1 to 8 blocks
reached through shapes for which the kernels' own plans pick them, GP
operands per draw and shared, z0 per draw and shared, and two launches
for the same bits; the plans at the paths' shapes, the pair's
shared-memory exports, and a copy with df_pathwise_probe.py's --plans
edit. The module skips without a C++20 g++.
"""

import types

import numpy as np
import pytest
import torch

from vae_gp_ode_tpu_torch.ops import _build, df_flow_fused, df_pathwise

from emulated_df_common import (
    DEV0, VJP_PLANS, _assert_cotangents, _fwd_plan, _operands,
    emulated)  # noqa: F401
from test_torch_cuda_emulated import TOL, build_emulated

NAMES = ('df_pathwise_fwd', 'df_pathwise_bwd', 'df_flow_fused',
         'df_flow_fused_bwd')


@pytest.fixture(scope='module')
def libs(tmp_path_factory):
    """#5-#8 built for the CPU emulation, {name: library}."""
    return build_emulated(NAMES, tmp_path_factory.mktemp('emulated_df_flow'))


# (L, N, D, S, M, T, GP operands per draw, z0 shared by the draws, #5's
# plan, which #7 takes: rows and blocks per cluster)
FLOW_CASES = [
    (2, 5, 6, 40, 7, 4, False, True, (1, 3)),
    (1, 3, 1, 20, 5, 3, False, False, (1, 1)),
    (2, 4, 12, 70, 9, 3, True, False, (1, 8)),
    (1, 3, 16, 8, 4, 3, False, True, (1, 2)),
    (3, 21, 12, 10, 5, 3, True, True, (2, 2)),
    (3, 45, 6, 9, 11, 2, True, False, (4, 1))]


@pytest.mark.parametrize('L,N,D,S,M,T,per_draw,z0_shared,plan', FLOW_CASES)
def test_trajectory_matches_plain(emulated, L, N, D, S, M, T, per_draw,
                                  z0_shared, plan):
    x, *ops_ = _operands(600 + D + N, L, N, D, S, M, per_draw)
    rng = np.random.default_rng(700 + D)
    dts = torch.as_tensor(rng.uniform(0.05, 0.2, T - 1).astype(np.float32))
    z0 = x[0] if z0_shared else x
    assert _fwd_plan(L, N, D, S * D, M) == plan
    zs = df_flow_fused._launch(z0, ops_, dts, T)
    ref = df_flow_fused.df_euler_flow_reference(z0, *ops_, dts, T)
    ref = ref.expand(zs.shape)
    assert bool(((zs - ref).abs() <= TOL + TOL * ref.abs()).all()), float(
        (zs - ref).abs().max())
    assert torch.equal(df_flow_fused._launch(z0, ops_, dts, T), zs)


# (L, N, D, S, M, T, GP operands per draw, z0 shared by the draws, the
# plan: rows and blocks per cluster, row tiles per draw)
BWD_CASES = [
    (2, 5, 6, 40, 7, 4, False, True, (1, 3, 5)),
    (1, 3, 1, 20, 5, 3, False, False, (1, 1, 3)),
    (2, 4, 12, 70, 9, 3, True, False, (1, 8, 4)),
    (1, 3, 16, 8, 4, 3, False, True, (1, 2, 3)),
    (3, 2, 6, 40, 30, 5, False, True, (1, 4, 2)),
    (3, 21, 12, 10, 5, 2, True, True, (2, 2, 11)),
    (3, 45, 6, 9, 11, 2, True, True, (4, 1, 12)),
    (2, 17, 6, 8, 7, 3, True, False, (1, 1, 17)),
    (1, 133, 6, 20, 15, 2, False, False, (4, 2, 34))]


@pytest.mark.parametrize('L,N,D,S,M,T,per_draw,z0_shared,plan', BWD_CASES)
def test_adjoint_matches_plain(emulated, L, N, D, S, M, T, per_draw,
                               z0_shared, plan):
    x, *ops_ = _operands(200 + D + N, L, N, D, S, M, per_draw)
    rng = np.random.default_rng(300 + D)
    dts = torch.as_tensor(rng.uniform(0.05, 0.2, T - 1).astype(np.float32))
    z0 = x[0] if z0_shared else x
    with torch.no_grad():
        zs = df_flow_fused.df_euler_flow_reference(z0, *ops_, dts, T)
    zsbar = torch.as_tensor(rng.standard_normal(zs.shape).astype(np.float32))
    assert df_flow_fused.bwd_plan(L, N, D, S * D, M, T, DEV0) == plan
    bars = df_flow_fused._launch_bwd(zs, zsbar, ops_, dts, T, z0_shared)
    ref = list(df_flow_fused.df_flow_vjp_reference(zs, zsbar, *ops_, dts,
                                                   T))
    if z0_shared:
        ref[0] = ref[0].sum(0)
    _assert_cotangents(bars, ref)
    again = df_flow_fused._launch_bwd(zs, zsbar, ops_, dts, T, z0_shared)
    assert all(torch.equal(a, b) for a, b in zip(again, bars))


def test_plans_and_shape_rule(emulated):
    """The kernels' own plans at the paths' shapes on an H100's 132 SMs
    (the emulation's card), as the card's sweep fitted them: 4-block
    clusters of 2 rows at L=5, N=20, 8-block clusters of one row at L=1,
    N=20; one-block clusters at L=1, N=600, where the row tiles alone fill
    the card; #7 takes #5's plan. #6 walks tiles of rows in 8-block
    clusters: 30 tiles of 20 rows at L=1, N=600, 5 tiles of 4 rows a draw
    at L=5, N=20, one-row tiles at L=1, N=20, each block's 270 items in
    one chunk. The pair's rule: the adjoint's block of an 8-block cluster
    at D=6, S=256 takes 2 (3D + 1) floats per item of its 192 columns and
    13 points (78 items) and the rows' buffers, the trajectory kernel's
    block the tile's state, 1/ls2, var and its sums; a state dim the
    kernels do not take is refused."""
    plan8 = df_flow_fused.bwd_plan
    assert _fwd_plan(5, 20, 6, 1536, 100) == (2, 4)
    assert _fwd_plan(1, 20, 6, 1536, 100) == (1, 8)
    assert _fwd_plan(1, 20, 6, 3072, 100) == (1, 8)
    assert _fwd_plan(1, 600, 6, 1536, 100) == (4, 1)
    assert plan8(5, 20, 6, 1536, 100, 16, DEV0) == (2, 4, 10)
    assert plan8(1, 20, 6, 1536, 100, 16, DEV0) == (1, 8, 20)
    plan6 = df_pathwise.bwd_plan
    assert plan6(1, 600, 6, 1536, 100, DEV0) == (4, 8, 20, 30, 270)
    assert plan6(5, 20, 6, 1536, 100, DEV0) == (4, 8, 4, 5, 270)
    assert plan6(1, 20, 6, 1536, 100, DEV0) == (1, 8, 1, 20, 270)
    # the plans the dispatch rule's tests price #6 from
    for shape, plan in VJP_PLANS.items():
        assert plan6(*shape, DEV0)[:4] == plan, shape
    assert df_flow_fused._lib().df_flow_fused_fwd_smem_bytes(6) == 4 * (
        11 * 4 * 6 + 6 * 6 + 6)
    lib = df_flow_fused._bwd_lib()
    RD, V = 4 * 6, 4 * 6 + 1
    assert lib.df_flow_fused_bwd_smem_bytes(6, 1536, 100) == 4 * (
        2 * 19 * (192 + 13 * 6) + 3 * RD + 2 * 42 + 8 * V + 2 * V)
    with pytest.raises(RuntimeError, match='CUDA error'):
        _fwd_plan(5, 20, 17, 17 * 16, 100)
    with pytest.raises(RuntimeError, match='takes no plan'):
        plan8(5, 20, 17, 17 * 16, 100, 16, DEV0)
    with pytest.raises(RuntimeError, match='takes no plan'):
        plan6(5, 20, 17, 17 * 16, 100, DEV0)


def test_probe_plans_reach_the_kernels(tmp_path, monkeypatch):
    """df_pathwise_probe.py --plans: a copy whose cluster.cuh carries
    the probe's edits for plan 2,3 launches #5 and #8 in 3-block clusters
    of 2 rows where their own plan takes 1-row clusters of 3 blocks
    (L=2, N=5, D=6, S=40, M=7), and both still match their plain
    versions."""
    import importlib.util
    import os
    import shutil
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        'df_pathwise_probe', os.path.join(root, 'df_pathwise_probe.py'))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    csrc = tmp_path / 'csrc'
    shutil.copytree(_build.CSRC, csrc)
    path = csrc / probe.PLAN_SOURCE
    path.write_text(probe.edit(path.read_text(), '2,3'))
    monkeypatch.setattr(_build, 'CSRC', str(csrc))
    (tmp_path / 'out').mkdir()
    libs = build_emulated(NAMES, tmp_path / 'out')
    monkeypatch.setattr(_build, 'load', lambda name: libs[name])
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda device=None:
                        types.SimpleNamespace(cuda_stream=0))
    L, N, D, S, M, T = 2, 5, 6, 40, 7, 3
    assert _fwd_plan(L, N, D, S * D, M) == (2, 3)
    assert df_flow_fused.bwd_plan(L, N, D, S * D, M, T, DEV0) == (2, 3, 3)
    x, *ops_ = _operands(7, L, N, D, S, M, True)
    out = df_pathwise._launch(x, ops_)
    ref = df_pathwise.df_pathwise_reference(x, *ops_)
    assert bool(((out - ref).abs() <= TOL + TOL * ref.abs()).all())
    dts = torch.full((T - 1,), 0.1)
    with torch.no_grad():
        zs = df_flow_fused.df_euler_flow_reference(x, *ops_, dts, T)
    zsbar = torch.as_tensor(np.random.default_rng(8).standard_normal(
        zs.shape).astype(np.float32))
    _assert_cotangents(
        df_flow_fused._launch_bwd(zs, zsbar, ops_, dts, T),
        df_flow_fused.df_flow_vjp_reference(zs, zsbar, *ops_, dts, T))
