"""The RBF VJP #4 and the grid-tiled RBF eval #9's own CUDA source
(`csrc/pathwise_bwd.cu`, `csrc/pathwise_tiled_fwd.cu`) run on the CPU. g++
compiles it against tests/cuda_emulation/ (one thread per CUDA thread,
barriers for __syncthreads and the warp shuffles, the dynamic shared
memory of each block filled with NaN), and the port's wrappers launch it
through ctypes as they do on the card (each library call its main kernel
and the kernel that sums its blocks' terms). Held against
`pathwise_eval_reference` and autograd through it with chip_smoke.py's
tolerances (abs 1e-4 + rel 1e-4; cotangents 1e-4 max |plain|, each held to
its own size, which is the stricter where it is below 1), at D
past one of #4's 16-dim sub-tiles and one above 65 (where #10's block does
not fit), D = 40 with two row tiles (#4's passes of 32 dims over the
tiles), #9's output-dim chunks of 32 with a last one of one dim, feature
columns and inducing points that leave ragged last blocks and ranges, N =
1, 20, 21 and 33, L = 1, 2 and 5, GP operands per draw and shared, no draw
dim, and two launches for the same bits. The lengthscales grow with
sqrt(D), so that the inducing update's envelopes exp(-0.5 |(x - z) / ls|^2)
stay near those of D = 6 and its cotangents (dZ, dls, dnu and the update's
share of dx and dvar) are not near zero at the wide D. The module skips
without a C++20
g++. It shows the kernels' block logic, not what nvcc makes of it:
registers, times and the card's memory model are for
tests/test_torch_cuda.py and chip_smoke.py.
"""

import types

import numpy as np
import pytest
import torch

from vae_gp_ode_tpu_torch import ops
from vae_gp_ode_tpu_torch.ops import _build
from vae_gp_ode_tpu_torch.ops import pathwise as tpw
from vae_gp_ode_tpu_torch.ops import pathwise_tiled as tpt

from test_torch_cuda_emulated import build_emulated
from test_torch_cuda_emulated_rbf import TOL, _assert_close, _operands
import torch_threads  # noqa: F401

NAMES = ('pathwise_bwd', 'pathwise_tiled_fwd')


@pytest.fixture(scope='module')
def libs(tmp_path_factory):
    """#4 and #9 built for the CPU emulation, {name: library}."""
    return build_emulated(NAMES, tmp_path_factory.mktemp('emulated_rbf_wide'))


@pytest.fixture
def emulated(libs, monkeypatch):
    monkeypatch.setattr(_build, 'load', lambda name: libs[name])
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda device=None:
                        types.SimpleNamespace(cuda_stream=0))
    # the emulated card's SM count and opt-in limit
    monkeypatch.setattr(ops, '_properties', lambda index: (SMS, 232448))


SMS = 132


def _wide_operands(seed, L, N, D, K, S, M, per_draw):
    """`_operands` with the lengthscales times sqrt(D / 6) past D = 6: the
    update's exponent, about -0.4 D at lengthscales in [0.8, 3], stays
    near its -2.4 at D = 6 (near -27 and e^-27 envelopes at D = 68
    otherwise)."""
    x, *ops_ = _operands(seed, L, N, D, K, S, M, per_draw)
    ops_[5] = ops_[5] * max(1.0, D / 6) ** 0.5
    return [x] + ops_


def _assert_cotangents(bars, refs):
    """Each cotangent within TOL of its own largest plain entry."""
    for a, b in zip(bars, refs):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= TOL * float(
            b.abs().max()), (float((a - b).abs().max()),
                             float(b.abs().max()))


# (L, N, D, K, S, M, GP operands per draw): an edge; the main widths at
# L = 5 with a ragged feature block; N = 33, two row tiles; D = K = 68, five
# sub-tiles of #4 and #9 chunks of 32, 32 and 4 output dims; D = 40 over two
# row tiles, #4's passes of 32 dims, M = 130 past one block of #4's points;
# K = 33, a last #9 chunk of one output dim (256 items a round)
@pytest.mark.parametrize('L,N,D,K,S,M,per_draw', [
    (1, 1, 1, 1, 3, 2, False), (5, 20, 6, 6, 40, 70, False),
    (2, 33, 7, 5, 30, 17, True), (1, 20, 68, 68, 8, 5, False),
    (2, 21, 40, 3, 50, 130, True), (1, 33, 17, 33, 20, 130, False)])
def test_kernels_match_plain(emulated, L, N, D, K, S, M, per_draw):
    x, *ops_ = _wide_operands(70 + D + N, L, N, D, K, S, M, per_draw)
    g = torch.as_tensor(np.random.default_rng(71 + D).standard_normal(
        (L, N, K)).astype(np.float32))
    out = tpt._launch(x, ops_)
    _assert_close(out, tpw.pathwise_eval_reference(x, *ops_))
    bars = tpw._launch_bwd(x, ops_, g)
    refs = tpw.pathwise_vjp_reference(x, *ops_, g)
    # the update's cotangents are not rounding noise beside the prior's
    assert min(float(refs[i].abs().max()) for i in (4, 5, 6)) > 1e-3 * max(
        float(r.abs().max()) for r in refs)
    _assert_cotangents(bars, refs)
    assert torch.equal(tpt._launch(x, ops_), out)
    assert all(torch.equal(a, b)
               for a, b in zip(tpw._launch_bwd(x, ops_, g), bars))


def test_no_draw_dim_through_autograd(emulated):
    """The routed eval with #9 forward and #4 VJP on operands without a
    draw dim: out (N, K), and autograd's cotangents in the operands'
    shapes."""
    x, *ops_ = _wide_operands(8, 1, 20, 6, 6, 40, 70, False)
    x, ops_ = x[0], [t[0] if t.dim() > nd else t
                     for t, nd in zip(ops_, tpw._BASE_DIMS)]
    inputs = [t.clone().requires_grad_() for t in [x] + ops_]
    out = tpw.apply_routed(tpt._launch, tpw._launch_bwd, inputs[0],
                           tuple(inputs[1:]), tpw._BASE_DIMS)
    assert out.shape == (20, 6)
    _assert_close(out.detach(), tpw.pathwise_eval_reference(x, *ops_))
    g = torch.as_tensor(np.random.default_rng(9).standard_normal(
        tuple(out.shape)).astype(np.float32))
    _assert_cotangents(torch.autograd.grad(out, inputs, g),
                       tpw.pathwise_vjp_reference(x, *ops_, g))


def test_libraries_refuse_what_they_do_not_take(emulated):
    """Each launcher refuses a workspace off by one before any block runs,
    #9's also one sized for another SM count than its card's, and each
    library's widest state dim is what the wrapper's error names, past
    which its workspace size is 0."""
    L, N, D, K, S, M = 5, 20, 6, 6, 256, 100
    bwd = tpw._bwd_lib()
    # omega, phase, weights and nu per draw: their per-draw cotangents are
    # the outputs; shared, the workspace holds them
    per = bwd.pathwise_bwd_workspace(L, N, D, K, S, M, 1, 1, 1, 1)
    assert bwd.pathwise_bwd_workspace(L, N, D, K, S, M, 0, 0, 0, 0) == \
        per + L * (D * S * K + 2 * S * K + K * M)
    null = [None, 1] * 4 + [None, 0, None, 1] + [None, 0] * 2
    assert bwd.pathwise_bwd(*null, None, None, per + 1, *[None] * 8,
                            L, N, D, K, S, M, 0, None) != 0
    limit = bwd.pathwise_bwd_max_dim()
    assert limit == 1024
    assert bwd.pathwise_bwd_workspace(1, N, limit + 1, 1, 1, 1, 1, 1, 1,
                                      1) == 0
    fwd = tpt._lib()
    need = fwd.pathwise_tiled_fwd_workspace(L, N, D, K, S, M, SMS)
    assert need > 0 and fwd.pathwise_tiled_fwd(
        *null, None, need - 1, None, L, N, D, K, S, M, 0, None) != 0
    # one SM: slots of four rounds, fewer partials than the card's layout
    one = fwd.pathwise_tiled_fwd_workspace(L, N, D, K, S, M, 1)
    assert 0 < one < need and fwd.pathwise_tiled_fwd(
        *null, None, one, None, L, N, D, K, S, M, 0, None) != 0
    assert fwd.pathwise_tiled_fwd_workspace(
        1, N, fwd.pathwise_tiled_fwd_max_dim() + 1, 1, 1, 1, SMS) == 0
    x, *ops_ = _operands(3, 1, 2, limit + 1, 1, 1, 1, False)
    with pytest.raises(ValueError, match=f'state dims up to {limit}'):
        tpw._launch_bwd(x, ops_, torch.zeros((1, 2, 1)))
    limit = fwd.pathwise_tiled_fwd_max_dim()
    assert limit == 2048
    x, *ops_ = _operands(4, 1, 2, limit + 1, 1, 1, 1, False)
    with pytest.raises(ValueError, match=f'state dims up to {limit}'):
        tpt._launch(x, ops_)
