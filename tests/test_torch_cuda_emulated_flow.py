"""The dimwise-RBF euler pair, the trajectory #1 and its discrete adjoint
#2 with its summing kernel, run from their own CUDA source
(`csrc/flow_fused.cu`, `csrc/flow_fused_bwd.cu`) on the CPU: here #1 and
the pair's plans and rule bound, in tests/test_torch_cuda_emulated_flow_bwd.py
#2 on the same cases. g++ compiles the source against
tests/cuda_emulation/ (one thread per CUDA thread, barriers for
__syncthreads and the warp shuffles, each block's dynamic shared memory
filled with NaN, a cluster's blocks run together, each reading the
others' shared memory), and the port's wrappers launch it through ctypes
as they do on the card. Held against `packed_flow_reference` and
autograd through it (`packed_flow_vjp_reference`) with chip_smoke.py's
tolerances (abs 1e-4 + rel 1e-4 for the trajectory; cotangents 1e-4 (1 +
max |plain|)), at orders 1 and 2, L = 1, 2, 3 and 5, draw and GP
operands per draw and shared, z0 per draw and shared, non-uniform step
sizes, with columns, points and rows that leave ragged shares and tiles
(a block of an 8-block cluster with no inducing column, reached with the
emulated device's opt-in limit lowered; clusters of 1-3 blocks from the
kernels' own plan; 1, 2 and 4 rows per cluster, more than one row tile
and a last tile with rows past N), the plan each case takes pinned, and
two launches for the same bits. The module skips without a C++20 g++.
It shows the kernels' block logic, not what nvcc makes of it:
registers, times and the card's memory model are for chip_smoke.py and
rbf_pathwise_probe.py.
"""

import ctypes
import types

import numpy as np
import pytest
import torch

from vae_gp_ode_tpu_torch.ops import _build, flow_fused

from test_torch_cuda_emulated import TOL, build_emulated
from test_torch_flow import H100_SMEM_OPTIN, _bwd_smem_bytes
import torch_threads  # noqa: F401

NAMES = ('flow_fused', 'flow_fused_bwd')
DEV0 = types.SimpleNamespace(index=0, type='cuda')


@pytest.fixture(scope='module')
def libs(tmp_path_factory):
    """#1 and #2 built for the CPU emulation, {name: library}."""
    return build_emulated(NAMES, tmp_path_factory.mktemp('emulated_flow'))


@pytest.fixture
def emulated(libs, monkeypatch):
    monkeypatch.setattr(_build, 'load', lambda name: libs[name])
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda device=None:
                        types.SimpleNamespace(cuda_stream=0))


def _case(seed, L, N, K, S, M, T, order, gp_per_draw, draws_shared,
          z0_shared):
    """z0, the packed operands and dts (T-1,) drawn from `seed`: the draw
    operands (omf, phf, ws, nus) per draw unless `draws_shared` (then
    without a draw dim), the GP operands (Zb, zn, il2) per draw where
    `gp_per_draw` (each draw its own Z and lengthscales), else shared."""
    f = np.float32
    rng = np.random.default_rng(seed)
    D = K * order
    lead = () if draws_shared else (L,)
    t = torch.as_tensor
    omega = t((rng.standard_normal(lead + (D, S, K)) * 0.5).astype(f))
    phase = t(rng.uniform(0, 2 * np.pi, lead + (1, S, K)).astype(f))
    weights = t(rng.standard_normal(lead + (S, K)).astype(f))
    nu = t((rng.standard_normal(lead + (K, M)) * 0.3).astype(f))
    var = t(rng.uniform(0.3, 1.0, (K,)).astype(f))

    def gp():
        return (t(rng.standard_normal((M, D)).astype(f)),
                t(rng.uniform(0.8, 2.0, (K, D)).astype(f)))

    Z, ls = gp()
    packed = list(flow_fused._pack_operands(omega, phase, weights, Z, nu,
                                            ls, var))
    if gp_per_draw:
        per = []
        for _ in range(L):
            Zl, lsl = gp()
            per.append(flow_fused._pack_operands(omega, phase, weights, Zl,
                                                 nu, lsl, var)[3:6])
        packed[3:6] = [torch.stack(x).contiguous() for x in zip(*per)]
    z0 = t((rng.standard_normal(((N, D) if z0_shared else (L, N, D))) *
            0.7).astype(f))
    dts = t(rng.uniform(0.05, 0.2, T - 1).astype(f))
    return z0, packed, dts


def _assert_close(out, ref):
    assert out.shape == ref.shape
    assert bool(((out - ref).abs() <= TOL + TOL * ref.abs()).all()), float(
        (out - ref).abs().max())


# (L, N, K, S, M, T, order, GP operands per draw, draw operands shared, z0
# shared by the draws, the emulated opt-in limit (None: an H100's), the
# plan both kernels take on the emulation's 132 SMs: rows and blocks per
# cluster, row tiles per draw). At (2, 4, 6, 15, 7, order 2) a limit of
# 4,500 bytes takes 8-block clusters (a block of 7 would need 4,616): 12
# feature and 6 inducing columns a block, and rank 7 6 columns and none;
# (3, 45) ends in a tile of one row of 4, (3, 21) in one of one row of 2
CASES = [
    (2, 5, 6, 16, 8, 4, 1, False, False, True, None, (1, 2, 5)),
    (1, 3, 1, 5, 3, 3, 1, False, True, False, None, (1, 1, 3)),
    (2, 4, 6, 15, 7, 3, 2, True, False, False, 4500, (1, 8, 4)),
    (3, 45, 6, 12, 7, 3, 1, False, False, True, None, (4, 1, 12)),
    (3, 21, 6, 10, 5, 3, 2, True, False, True, None, (2, 1, 11)),
    (2, 3, 16, 16, 8, 3, 1, True, False, False, None, (1, 3, 3)),
    (1, 7, 3, 16, 8, 5, 1, False, True, True, None, (1, 1, 7)),
    (2, 9, 4, 16, 8, 4, 2, False, True, False, None, (1, 1, 9)),
    (5, 20, 6, 16, 8, 2, 1, False, False, True, None, (2, 2, 10))]


@pytest.fixture
def optin(libs):
    """Sets the emulated device's opt-in limit for a test and puts back
    an H100's after it."""
    fns = []
    for lib in libs.values():
        fn = lib.emu_set_optin
        fn.argtypes, fn.restype = [ctypes.c_int], None
        fns.append(fn)

    def set_to(nbytes):
        for fn in fns:
            fn(H100_SMEM_OPTIN if nbytes is None else nbytes)

    yield set_to
    set_to(None)


@pytest.mark.parametrize(
    'L,N,K,S,M,T,order,gp_per_draw,draws_shared,z0_shared,limit,plan', CASES)
def test_trajectory_matches_plain(emulated, optin, L, N, K, S, M, T, order,
                                  gp_per_draw, draws_shared, z0_shared,
                                  limit, plan):
    z0, packed, dts = _case(600 + K + N, L, N, K, S, M, T, order,
                            gp_per_draw, draws_shared, z0_shared)
    optin(limit)
    D = K * order
    assert flow_fused.fwd_plan(L, N, D, K, S, M, order, DEV0) == plan
    zs = flow_fused._launch(z0, *packed, dts, T, order)
    ref = flow_fused.packed_flow_reference(z0, *packed, dts, T, order)
    _assert_close(zs, ref.reshape(zs.shape))
    assert torch.equal(flow_fused._launch(z0, *packed, dts, T, order), zs)


def test_plans_and_rule_bound(emulated):
    """The pair's plan at the paths' shapes on an H100's 132 SMs (the
    emulation's card): 4-block clusters of 2 rows at L=5, N=20 (50
    clusters), 8-block clusters of one row at L=1, N=20; both kernels take
    the same plan. The bound of the pair's rule is the library's export,
    which the CPU tests of the rule transcribe, and it admits every shape
    whose adjoint block of an 8-block cluster fits; a state dim above 16
    and a shape whose 8-block cluster does not fit are refused."""
    assert flow_fused.bwd_plan(5, 20, 6, 6, 256, 100, 1, DEV0) == (2, 4, 10)
    assert flow_fused.bwd_plan(1, 20, 6, 6, 256, 100, 1, DEV0) == (1, 8, 20)
    assert flow_fused.bwd_plan(5, 20, 12, 6, 256, 100, 2, DEV0) == (
        2, 4, 10)
    assert flow_fused.bwd_plan(5, 300, 6, 6, 256, 100, 1, DEV0) == (
        4, 2, 75)
    assert flow_fused.bwd_plan(5, 20, 6, 6, 1024, 100, 1, DEV0) == (
        2, 4, 10)
    for shape in ((5, 20, 6, 6, 256, 100, 1), (1, 20, 6, 6, 256, 100, 1),
                  (5, 300, 6, 6, 256, 100, 1), (5, 20, 12, 6, 256, 100, 2)):
        assert flow_fused.fwd_plan(*shape, DEV0) == flow_fused.bwd_plan(
            *shape, DEV0)
    lib = flow_fused._bwd_lib()
    for D, K, S in ((6, 6, 256), (6, 6, 1024), (12, 6, 256), (6, 6, 2048),
                    (12, 12, 256), (16, 8, 256), (12, 12, 1024), (1, 1, 5),
                    (16, 16, 16)):
        assert lib.flow_fused_bwd_smem_bytes(D, K, S, 100, 16) == \
            _bwd_smem_bytes(D, K, S, 100, 16), (D, K, S)
    assert lib.flow_fused_bwd_smem_bytes(6, 6, 256, 100, 16) == 84700
    assert flow_fused.fused_pair_fits(6, 6, 1024, 100, 16, DEV0)
    assert not flow_fused.fused_pair_fits(12, 12, 1024, 100, 16, DEV0)
    with pytest.raises(RuntimeError, match='takes no plan'):
        flow_fused.bwd_plan(5, 20, 18, 9, 16, 100, 2, DEV0)
    with pytest.raises(RuntimeError, match='takes no plan'):
        flow_fused.fwd_plan(5, 20, 12, 12, 1024, 100, 1, DEV0)
