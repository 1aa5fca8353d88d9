"""The DF cluster kernels, the per-step eval #5 and its VJP #6, the DF
euler trajectory #7 and its discrete adjoint #8, run from their own CUDA
source (`csrc/df_pathwise_fwd.cu`, `csrc/df_pathwise_bwd.cu` and
`csrc/df_flow_fused_bwd.cu` with their summing kernels,
`csrc/df_flow_fused.cu`) on the CPU. g++ compiles it against tests/cuda_emulation/ (one
thread per CUDA thread, barriers for __syncthreads and the warp shuffles,
each block's dynamic shared memory filled with NaN, a cluster's blocks run
together, each reading the others' shared memory), and the port's
wrappers launch it through ctypes as they do on the card. Held against
`df_pathwise_reference`, `df_pathwise_vjp_reference`,
`df_euler_flow_reference` and `df_flow_vjp_reference` with
chip_smoke.py's tolerances (abs 1e-4 + rel 1e-4 for outputs; cotangents
1e-4 (1 + max |plain|)), at D = 1, 6, 12 and 16, with feature columns,
inducing points and rows that leave ragged shares and tiles (blocks of a
cluster with no point at all among them), each instance (1, 2 and 4
rows) in clusters of one block and of 2 up to 8, all reached through
shapes for which the kernels' own plans pick them (#6: tiles of one pass
and of several, and a block whose items take two chunks of its shared
memory), GP operands per draw and shared, z0 per draw and shared, and
two launches for the same bits. The module
skips without a C++20 g++. It shows the kernels' block logic, not what
nvcc makes of it: registers, times and the card's memory model are for
chip_smoke.py and df_pathwise_probe.py.
"""

import ctypes
import types

import numpy as np
import pytest
import torch

from vae_gp_ode_tpu_torch.ops import _build, df_flow_fused, df_pathwise

from test_torch_cuda_emulated import TOL, build_emulated

NAMES = ('df_pathwise_fwd', 'df_pathwise_bwd', 'df_flow_fused',
         'df_flow_fused_bwd')
DEV0 = types.SimpleNamespace(index=0)


@pytest.fixture(scope='module')
def libs(tmp_path_factory):
    """#5-#8 built for the CPU emulation, {name: library}."""
    return build_emulated(NAMES, tmp_path_factory.mktemp('emulated_df'))


@pytest.fixture
def emulated(libs, monkeypatch):
    monkeypatch.setattr(_build, 'load', lambda name: libs[name])
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda device=None:
                        types.SimpleNamespace(cuda_stream=0))


def _operands(seed, L, N, D, S, M, per_draw):
    """x (L, N, D) and the DF operands: omf, phf, G and nur per draw; Z,
    ls2 and var per draw too where `per_draw`, else shared."""
    f = np.float32
    rng = np.random.default_rng(seed)
    gp = (L,) if per_draw else ()
    SD = S * D
    return [torch.as_tensor(a) for a in (
        (rng.standard_normal((L, N, D)) * 0.7).astype(f),
        rng.standard_normal((L, D, SD)).astype(f),
        rng.uniform(0, 2 * np.pi, (L, 1, SD)).astype(f),
        (rng.standard_normal((L, 2 * SD, D)) / np.sqrt(S)).astype(f),
        rng.standard_normal(gp + (M, D)).astype(f),
        (rng.standard_normal((L, M, D)) * 0.3).astype(f),
        rng.uniform(0.5, 2.0, gp + (D, D)).astype(f),
        rng.uniform(0.3, 1.0, gp + (D,)).astype(f))]


def _assert_cotangents(bars, refs):
    for a, b in zip(bars, refs):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= TOL * (1 + float(
            b.abs().max())), float((a - b).abs().max())


def _fwd_plan(L, N, D, SD, M):
    """(rows, blocks) per cluster of #5's launch, from its library's plan
    export (the port's wrapper does not need it)."""
    fn = df_pathwise._lib().df_pathwise_fwd_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    rc = fn(L, N, D, SD, M, 0, out)
    if rc:
        raise RuntimeError(f'df_pathwise_fwd_plan: CUDA error {rc}')
    return tuple(out)


# (L, N, D, S, M, GP operands per draw, the plan that csrc/df_cluster.cuh
# plan_for picks on the emulation's 132 SMs: rows, blocks per cluster):
# columns, points and rows that leave ragged shares and tiles; at (2, 4,
# 12, 70, 9) the 8 blocks hold 2, 2, 2, 2, 1, 0, 0 and 0 points
FWD_CASES = [
    (2, 5, 6, 40, 7, False, (1, 3)),
    (1, 3, 1, 20, 5, False, (1, 1)),
    (2, 4, 12, 70, 9, True, (1, 8)),
    (1, 3, 16, 8, 4, False, (1, 2)),
    (3, 2, 6, 40, 30, True, (1, 4)),
    (3, 21, 12, 10, 5, True, (2, 2)),
    (3, 45, 6, 9, 11, False, (4, 1)),
    (1, 133, 6, 20, 15, False, (4, 2))]


@pytest.mark.parametrize('L,N,D,S,M,per_draw,plan', FWD_CASES)
def test_fwd_matches_plain(emulated, L, N, D, S, M, per_draw, plan):
    x, *ops_ = _operands(100 + D + N, L, N, D, S, M, per_draw)
    assert _fwd_plan(L, N, D, S * D, M) == plan
    out = df_pathwise._launch(x, ops_)
    ref = df_pathwise.df_pathwise_reference(x, *ops_)
    assert out.shape == ref.shape
    assert bool(((out - ref).abs() <= TOL + TOL * ref.abs()).all()), float(
        (out - ref).abs().max())
    assert torch.equal(df_pathwise._launch(x, ops_), out)


# (L, N, D, S, M, GP operands per draw, the plan that csrc/df_cluster.cuh
# walk_plan_for picks on the emulation's 132 SMs: rows per pass, blocks
# per cluster, rows per tile, row tiles per draw, items per chunk): one
# pass per tile, and two (8-row tiles of 4-row passes, the last tile of
# 5 rows)
VJP_CASES = [
    (2, 5, 6, 40, 7, False, (1, 2, 1, 5, 144)),
    (1, 3, 1, 20, 5, False, (1, 1, 1, 3, 25)),
    (2, 4, 12, 70, 9, True, (1, 4, 1, 4, 246)),
    (3, 21, 12, 10, 5, True, (1, 1, 1, 21, 180)),
    (1, 3, 16, 100, 20, False, (1, 8, 1, 3, 248)),
    (2, 9, 6, 100, 10, True, (1, 3, 1, 9, 224)),
    (1, 597, 6, 40, 7, True, (4, 2, 8, 75, 144))]


@pytest.mark.parametrize('L,N,D,S,M,per_draw,plan', VJP_CASES)
def test_vjp_matches_plain(emulated, L, N, D, S, M, per_draw, plan):
    x, *ops_ = _operands(400 + D + N, L, N, D, S, M, per_draw)
    g = torch.as_tensor(np.random.default_rng(500 + D).standard_normal(
        (L, N, D)).astype(np.float32))
    assert df_pathwise.bwd_plan(L, N, D, S * D, M, DEV0) == plan
    bars = df_pathwise._launch_bwd(x, ops_, g)
    _assert_cotangents(bars, df_pathwise.df_pathwise_vjp_reference(
        x, *ops_, g))
    again = df_pathwise._launch_bwd(x, ops_, g)
    assert all(torch.equal(a, b) for a, b in zip(again, bars))


@pytest.mark.parametrize('optin,chunk', [(8192, 99), (10504, 130)])
def test_vjp_in_chunks(libs, emulated, optin, chunk):
    """Where a block's items do not fit the opt-in shared memory, #6 walks
    the tile once per chunk that does (a point's D items never split):
    with the emulated device's limit lowered, the 144 items of a block
    at (1, 3, 6, 40, 7) (120 columns, 4 points) take chunks of 99 (a
    chunk of columns, then columns and points) and of 130 (columns and a
    point, then points)."""
    L, N, D, S, M = 1, 3, 6, 40, 7
    x, *ops_ = _operands(800 + chunk, L, N, D, S, M, False)
    g = torch.as_tensor(np.random.default_rng(801).standard_normal(
        (L, N, D)).astype(np.float32))
    set_optin = libs['df_pathwise_bwd'].emu_set_optin
    set_optin.argtypes, set_optin.restype = [ctypes.c_int], None
    set_optin(optin)
    try:
        assert df_pathwise.bwd_plan(L, N, D, S * D, M, DEV0) == (
            1, 2, 1, 3, chunk)
        bars = df_pathwise._launch_bwd(x, ops_, g)
    finally:
        set_optin(232448)
    _assert_cotangents(bars, df_pathwise.df_pathwise_vjp_reference(
        x, *ops_, g))
    assert df_pathwise.bwd_plan(L, N, D, S * D, M, DEV0)[4] == 144


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


# #6's plans (rows per pass, blocks per cluster, rows per tile, row tiles
# per draw) on an H100's 132 SMs at the shapes (L, N, D, SD, M) of the DF
# dispatch rule's tests (tests/test_torch_tiled.py, which prices #6 from
# them in place of the card's library); checked against csrc/
# df_cluster.cuh `walk_plan_for` below
VJP_PLANS = {
    (1, 20, 6, 1536, 100): (1, 8, 1, 20),
    (1, 20, 6, 3072, 100): (1, 8, 1, 20),
    (1, 20, 12, 3072, 100): (1, 8, 1, 20),
    (1, 20, 12, 12288, 100): (1, 8, 1, 20),
    (1, 160, 6, 1536, 100): (4, 8, 8, 20),
    (1, 600, 6, 1536, 100): (4, 8, 20, 30),
    (1, 600, 6, 3072, 100): (4, 8, 20, 30),
    (1, 600, 12, 3072, 100): (2, 8, 20, 30),
    (1, 600, 12, 12288, 100): (2, 8, 20, 30),
    (5, 20, 6, 1536, 100): (4, 8, 4, 5),
    (5, 20, 6, 3072, 100): (4, 8, 4, 5),
    (5, 20, 12, 3072, 100): (2, 8, 4, 5),
    (5, 20, 12, 12288, 100): (2, 8, 4, 5),
    (5, 160, 6, 1536, 100): (4, 8, 24, 7),
    (5, 400, 12, 12288, 100): (2, 8, 58, 7),
    (5, 600, 6, 1536, 100): (4, 8, 88, 7),
    (5, 600, 6, 3072, 100): (4, 8, 88, 7),
    (5, 600, 12, 3072, 100): (2, 8, 86, 7),
    (5, 600, 12, 12288, 100): (2, 8, 86, 7)}


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
    """df_pathwise_probe.py --plans: a copy whose df_cluster.cuh carries
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
    path = csrc / 'df_cluster.cuh'
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
