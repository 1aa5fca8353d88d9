"""What the emulated tests of the DF cluster kernels share
(tests/test_torch_cuda_emulated_df.py: the per-step pair #5/#6;
tests/test_torch_cuda_emulated_df_flow.py: the trajectory pair #7/#8 and
the plans): the fixture that points the port's wrappers at the g++-built
libraries, the operands, the cotangent check, #5's plan export, and #6's
plans at the dispatch rule's shapes (which tests/test_torch_tiled.py
prices #6 from). A test module defines `libs`, its libraries built with
`test_torch_cuda_emulated.build_emulated`, and imports `emulated`.
"""

import ctypes
import types

import numpy as np
import pytest
import torch

from vae_gp_ode_tpu_torch.ops import _build, df_pathwise

from test_torch_cuda_emulated import TOL

DEV0 = types.SimpleNamespace(index=0)


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


# #6's plans (rows per pass, blocks per cluster, rows per tile, row tiles
# per draw) on an H100's 132 SMs at the shapes (L, N, D, SD, M) of the DF
# dispatch rule's tests (tests/test_torch_tiled.py, which prices #6 from
# them in place of the card's library); checked against csrc/
# df_cluster.cuh `walk_plan_for` in test_torch_cuda_emulated_df_flow.py
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
