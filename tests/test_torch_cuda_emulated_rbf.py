"""The RBF per-step eval #3 and the grid-tiled VJP #10's own CUDA source
(`csrc/pathwise_fwd.cu`, `csrc/pathwise_tiled_bwd.cu`) run on the CPU. g++
compiles it against tests/cuda_emulation/ (one thread per CUDA thread,
barriers for __syncthreads and the warp shuffles, the dynamic shared
memory of each block filled with NaN, a cluster's blocks run together,
cp.async a plain copy), and the port's wrappers
launch it through ctypes as they do on the card (#10's library call: its
main kernel and the kernel that sums its slabs). Held against
`pathwise_eval_reference` and autograd through it with chip_smoke.py's
tolerances (abs 1e-4 + rel 1e-4; cotangents 1e-4 (1 + max |plain|)), at
D = 1, 6, 7, 12 and 17, K other than D, feature columns and inducing points
that leave ragged last chunks, N = 1, 20 and 33 (past one row tile), L = 1
and 5, GP operands per draw and shared, no draw dim, and two launches for
the same bits. The module skips without a C++20 g++. It shows the
kernels' block logic, not what nvcc makes of it: registers, times and the
card's memory model are for tests/test_torch_cuda.py and chip_smoke.py.
"""

import ctypes
import types

import numpy as np
import pytest
import torch

from vae_gp_ode_tpu_torch.ops import _build
from vae_gp_ode_tpu_torch.ops import pathwise as tpw
from vae_gp_ode_tpu_torch.ops import pathwise_tiled as tpt

from test_torch_cuda_emulated import TOL, build_emulated

NAMES = ('pathwise_fwd', 'pathwise_tiled_bwd')


@pytest.fixture(scope='module')
def libs(tmp_path_factory):
    """#3 and #10 built for the CPU emulation, {name: library}."""
    return build_emulated(NAMES, tmp_path_factory.mktemp('emulated_rbf'))


@pytest.fixture
def emulated(libs, monkeypatch):
    monkeypatch.setattr(_build, 'load', lambda name: libs[name])
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda device=None:
                        types.SimpleNamespace(cuda_stream=0))


def _operands(seed, L, N, D, K, S, M, per_draw):
    """x (L, N, D) and the operands, omega, phase, weights and nu per draw;
    Z, ls and var per draw too where `per_draw`, else shared."""
    f = np.float32
    rng = np.random.default_rng(seed)
    gp = (L,) if per_draw else ()
    return [torch.as_tensor(a) for a in (
        rng.standard_normal((L, N, D)).astype(f),
        (rng.standard_normal((L, D, S, K)) * 0.5).astype(f),
        (rng.random((L, 1, S, K)) * 6.28).astype(f),
        rng.standard_normal((L, S, K)).astype(f),
        rng.standard_normal(gp + (M, D)).astype(f),
        rng.standard_normal((L, K, M)).astype(f),
        rng.uniform(0.8, 3.0, gp + (K, D)).astype(f),
        rng.uniform(0.3, 1.0, gp + (K,)).astype(f))]


def _assert_close(out, ref):
    assert out.shape == ref.shape
    assert bool(((out - ref).abs() <= TOL + TOL * ref.abs()).all()), float(
        (out - ref).abs().max())


def _assert_cotangents(bars, refs):
    for a, b in zip(bars, refs):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= TOL * (1 + float(
            b.abs().max())), float((a - b).abs().max())


# (L, N, D, K, S, M, GP operands per draw): S*K and M that leave ragged
# last chunks of #10's 64 columns and points and of #3's rounds and
# clusters, N past one of #10's 20-row tiles and #3's 4- and 8-row ones, K other
# than D; D = 17 past the operands #3 keeps in registers; the last with
# clusters of #3 whose blocks stage two rounds each
@pytest.mark.parametrize('L,N,D,K,S,M,per_draw', [
    (1, 1, 1, 1, 3, 2, False), (5, 20, 6, 6, 40, 70, False),
    (2, 33, 7, 5, 30, 17, True), (1, 20, 12, 12, 20, 100, False),
    (2, 3, 4, 12, 11, 65, True), (1, 33, 6, 3, 200, 9, False),
    (1, 9, 17, 3, 20, 10, False), (1, 21, 7, 5, 830, 40, False)])
def test_kernels_match_plain(emulated, L, N, D, K, S, M, per_draw):
    x, *ops_ = _operands(90 + D + N, L, N, D, K, S, M, per_draw)
    g = torch.as_tensor(np.random.default_rng(91 + D).standard_normal(
        (L, N, K)).astype(np.float32))
    out = tpw._launch(x, ops_)
    _assert_close(out, tpw.pathwise_eval_reference(x, *ops_))
    bars = tpt._launch_bwd(x, ops_, g)
    _assert_cotangents(bars, tpw.pathwise_vjp_reference(x, *ops_, g))
    assert torch.equal(tpw._launch(x, ops_), out)
    assert all(torch.equal(a, b)
               for a, b in zip(tpt._launch_bwd(x, ops_, g), bars))


def test_no_draw_dim_through_autograd(emulated):
    """The routed eval with #3 forward and #10 VJP on operands without a
    draw dim: out (N, K), and autograd's cotangents in the operands'
    shapes."""
    x, *ops_ = _operands(5, 1, 20, 6, 6, 40, 70, False)
    x, ops_ = x[0], [t[0] if t.dim() > nd else t
                     for t, nd in zip(ops_, tpw._BASE_DIMS)]
    inputs = [t.clone().requires_grad_() for t in [x] + ops_]
    out = tpw.apply_routed(tpw._launch, tpt._launch_bwd, inputs[0],
                           tuple(inputs[1:]), tpw._BASE_DIMS)
    _assert_close(out.detach(), tpw.pathwise_eval_reference(x, *ops_))
    g = torch.as_tensor(np.random.default_rng(6).standard_normal(
        tuple(out.shape)).astype(np.float32))
    _assert_cotangents(torch.autograd.grad(out, inputs, g),
                       tpw.pathwise_vjp_reference(x, *ops_, g))


def test_library_layout_is_the_wrappers(emulated):
    """#10's exported shared-memory need is the rule's formula, its
    workspace grows by the per-draw buffers of shared operands, and its
    launcher refuses a workspace off by one before any block runs; #3's
    shared-memory need follows its plan."""
    lib = tpt._bwd_lib()
    for D in (1, 6, 12, 65, 66):
        assert lib.pathwise_tiled_bwd_smem_bytes(D) == \
            tpt.tiled_bwd_smem_bytes(D)
    # omega, phase, weights, nu per draw (stride 1) or shared (0): the
    # shared ones' per-draw cotangents (L D S K, L S K, L S K, L K M) join
    # the slabs
    L, N, D, K, S, M = 5, 20, 6, 6, 256, 100
    per = lib.pathwise_tiled_bwd_workspace(L, N, D, K, S, M, 1, 1, 1, 1)
    assert lib.pathwise_tiled_bwd_workspace(L, N, D, K, S, M, 0, 0, 0, 0) \
        == per + L * (D * S * K + 2 * S * K + K * M)
    # x, omega, phase, weights and nu per draw; Z, ls and var shared
    null = [None, 1] * 4 + [None, 0, None, 1] + [None, 0] * 2
    assert lib.pathwise_tiled_bwd(*null, None, None, per + 1, *[None] * 8,
                                  L, N, D, K, S, M, 0, None) != 0
    fwd = tpw._lib()
    fwd.pathwise_fwd_smem_bytes.argtypes = [ctypes.c_int] * 7
    fwd.pathwise_fwd_smem_bytes.restype = ctypes.c_longlong
    # rows (D x R), 1/ls (D x Kc), the warps' and the block's row sums,
    # and the rounds staged ahead (omega, phase, w of SP items x Kp output
    # dims, Z of SP points each). The main widths: blocks of one output dim
    # and 4 rows that load their 356 items themselves (no staging); the
    # wide ones: clusters of 8 blocks of 8 rows and all 12 output dims,
    # 141 items each in 5 rounds of SP = 32, Kp = 13, all staged ahead
    assert fwd.pathwise_fwd_smem_bytes(5, 20, 6, 6, 256, 100, 132) == 4 * (
        6 * 4 + 6 * 1 + 12 * 4 + 4 * 1)
    assert fwd.pathwise_fwd_smem_bytes(5, 20, 12, 12, 1024, 100, 132) == \
        4 * (12 * 8 + 12 * 12 + 12 * 8 + 8 * 12 + 5 * (14 * 32 * 13
                                                       + 12 * 33))
    assert fwd.pathwise_fwd_empty(0, None) == 0


# (L, N, D, K, S, M) at which plan_for (on the emulated 132 SMs, as on an
# H100) picks each instance: a block that loads its own items (direct, 4
# rows); one block of 4 rows staging two rounds; one block of 8 rows; and
# clusters of 3 and 8 blocks of 4 rows, and of 3 blocks of 8 rows
FWD_PLANS = {
    'direct': (2, 37, 6, 5, 90, 30), 'staged_4_rows': (1, 20, 6, 1, 400, 100),
    'staged_8_rows': (2, 60, 6, 5, 90, 30),
    'cluster_3_of_4_rows': (1, 20, 6, 1, 800, 100),
    'cluster_8_of_4_rows': (1, 20, 6, 12, 700, 100),
    'cluster_3_of_8_rows': (2, 60, 6, 1, 700, 100)}


@pytest.mark.parametrize('plan', sorted(FWD_PLANS))
def test_fwd_plans_match_plain(emulated, plan):
    """#3 at shapes where its launcher picks each instance of rows per
    block (4, 8), direct or staged, with and without a cluster."""
    L, N, D, K, S, M = FWD_PLANS[plan]
    x, *ops_ = _operands(7, L, N, D, K, S, M, False)
    _assert_close(tpw._launch(x, ops_), tpw.pathwise_eval_reference(x, *ops_))


def test_probe_ablations_apply_to_the_sources():
    """rbf_pathwise_probe.py's --ablate and --fwd-plans edits each find
    their text in the kernel source exactly once, so that every ablation
    removes what it names and every plan replaces the launcher's."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        'rbf_pathwise_probe', os.path.join(root, 'rbf_pathwise_probe.py'))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    for name, (source, edits) in list(probe.ABLATIONS.items()) + [
            ('plan 8,2,3', probe.plan_edits('8,2,3'))]:
        with open(os.path.join(_build.CSRC, source)) as f:
            text = f.read()
        assert all(text.count(old) == 1 for old, _ in edits), name
