"""The DF per-step cluster kernels, the eval #5 and its VJP #6 with its
summing kernel, run from their own CUDA source (`csrc/df_pathwise_fwd.cu`,
`csrc/df_pathwise_bwd.cu`) on the CPU. g++ compiles it against
tests/cuda_emulation/ (one thread per CUDA thread, barriers for
__syncthreads and the warp shuffles, each block's dynamic shared memory
filled with NaN, a cluster's blocks run together, each reading the
others' shared memory), and the port's wrappers launch it through ctypes
as they do on the card. Held against `df_pathwise_reference` and
`df_pathwise_vjp_reference` with chip_smoke.py's tolerances (abs 1e-4 +
rel 1e-4 for outputs; cotangents 1e-4 (1 + max |plain|)), at D = 1, 6, 12
and 16, with feature columns, inducing points and rows that leave ragged
shares and tiles (blocks of a cluster with no point at all among them),
each instance (1, 2 and 4 rows) in clusters of one block and of 2 up to
8, all reached through shapes for which the kernels' own plans pick them
(#6: tiles of one pass and of several, and a block whose items take two
chunks of its shared memory), GP operands per draw and shared, and two
launches for the same bits. The trajectory pair #7/#8 and the plans are
in tests/test_torch_cuda_emulated_df_flow.py; the helpers both share in
tests/emulated_df_common.py. The module skips without a C++20 g++. It
shows the kernels' block logic, not what nvcc makes of it: registers,
times and the card's memory model are for chip_smoke.py and
df_pathwise_probe.py.
"""

import ctypes

import numpy as np
import pytest
import torch

from vae_gp_ode_tpu_torch.ops import df_pathwise

from emulated_df_common import (
    DEV0, _assert_cotangents, _fwd_plan, _operands, emulated)  # noqa: F401
from test_torch_cuda_emulated import TOL, build_emulated
import torch_threads  # noqa: F401

NAMES = ('df_pathwise_fwd', 'df_pathwise_bwd')


@pytest.fixture(scope='module')
def libs(tmp_path_factory):
    """#5 and #6 built for the CPU emulation, {name: library}."""
    return build_emulated(NAMES, tmp_path_factory.mktemp('emulated_df'))


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
