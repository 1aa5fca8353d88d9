"""The grid-tiled DF kernels' own CUDA source (#11/#12,
`csrc/df_pathwise_tiled_fwd.cu` / `df_pathwise_tiled_bwd.cu`) run on the
CPU. g++ compiles it against tests/cuda_emulation/cuda_runtime.h (one
thread per CUDA thread, barriers for __syncthreads and the warp shuffles),
and the port's wrappers launch it through ctypes as they do on the card
(each library call a main kernel and the kernel that sums its slabs).
Held against `df_pathwise_reference` and autograd
through it with chip_smoke.py's tolerances (abs 1e-4 + rel 1e-4;
cotangents 1e-4 (1 + max |plain|)), at D = 1, 4, 6, 7, 12 and 16 (the
VJP's D = 6 and D = 12 instances and its generic one) and at D = 20, 48,
49 and 64 (the wide kernels of both, which take any D above 16), with
ragged feature, inducing-point and row chunks, GP operands per draw, and
two launches for the same bits; and with the emulated device's opt-in
limit lowered, the wide kernels' paths that read 1/ls2 through L2 where
it would not fit (above D = 256, which the g++ emulation is too slow for,
chip_smoke.py checks the kernels on the card). The module skips without a C++20 g++. It
shows the kernels' block logic, not what nvcc makes of it: registers,
times and the card's memory model are for tests/test_torch_cuda.py and
chip_smoke.py.
"""

import ctypes
import os
import re
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from vae_gp_ode_tpu_torch.ops import _build, df_pathwise
from vae_gp_ode_tpu_torch.ops import df_pathwise_tiled as tdpt
import torch_threads  # noqa: F401

SHIM = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    'cuda_emulation')
TOL = 1e-4
NAMES = ('df_pathwise_tiled_fwd', 'df_pathwise_tiled_bwd')


class _Fn:
    """A library function that takes None (a CPU tensor's device index)
    as 0."""

    def __init__(self, fn):
        self.fn, self.argtypes, self.restype = fn, None, None

    def __call__(self, *args):
        self.fn.argtypes, self.fn.restype = self.argtypes, self.restype
        return self.fn(*(0 if a is None else a for a in args))


class _Lib:
    def __init__(self, path):
        self._lib = ctypes.CDLL(path)

    def __getattr__(self, name):
        fn = _Fn(getattr(self._lib, name))
        setattr(self, name, fn)
        return fn


def _gxx(args, cwd):
    return subprocess.run(args, capture_output=True, text=True, timeout=600,
                          cwd=cwd)


def _launch(m):
    """`kernel<<<blocks, threads, smem, stream>>>(args)` as the shim's
    emu_launch_smem(kernel, blocks, threads, smem, args)."""
    blocks, threads, smem, _ = (p.strip() for p in m.group(2).split(','))
    args = m.group(3).strip()
    return (f'emu_launch_smem({m.group(1)}, {blocks}, {threads}, {smem}'
            + (f', {args})' if args else ')'))


def build_emulated(names, out):
    """Compile each `csrc/<name>.cu` with g++ against the shim into `out`
    (a pathlib.Path), the launches and the dynamic shared memory
    rewritten for it; {name: library}. Skips the caller without a C++20
    g++."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++')
    flags = ['-std=c++20', '-pthread', '-I', SHIM, '-I', str(out)]
    (out / 'probe.cpp').write_text('#include <barrier>\nint main() {}\n')
    if _gxx([gxx, *flags, '-o', 'probe', 'probe.cpp'], out).returncode:
        pytest.skip('needs a g++ with C++20 <barrier>')
    for fn in os.listdir(_build.CSRC):
        if fn.endswith('.cuh'):
            shutil.copy(os.path.join(_build.CSRC, fn), out)
    built, procs = {}, {}
    for name in names:
        with open(os.path.join(_build.CSRC, name + '.cu')) as f:
            src = re.sub(r'(\w+(?:<[\w, ]+>)?)<<<(.*?)>>>\((.*?)\)', _launch,
                         f.read(), flags=re.S)
        src = re.sub(r'extern __shared__ float (\w+)\[\];',
                     r'float* \1 = emu_dyn_smem;', src)
        (out / (name + '.cpp')).write_text(src)
        procs[name] = subprocess.Popen(
            [gxx, *flags, '-O1', '-shared', '-fPIC', '-o', f'lib{name}.so',
             name + '.cpp'], cwd=out, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        built[name] = _Lib(str(out / f'lib{name}.so'))
    return built


@pytest.fixture(scope='module')
def libs(tmp_path_factory):
    """The two kernels built for the CPU emulation, {name: library}."""
    return build_emulated(NAMES, tmp_path_factory.mktemp('emulated'))


@pytest.fixture
def emulated(libs, monkeypatch):
    monkeypatch.setattr(_build, 'load', lambda name: libs[name])
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda device=None:
                        types.SimpleNamespace(cuda_stream=0))


def _operands(seed, L, N, S, M, D, per_draw):
    f = np.float32
    rng = np.random.default_rng(seed)
    gp = (L,) if per_draw else ()
    return [torch.as_tensor(a) for a in (
        (rng.standard_normal((L, N, D)) * 0.5).astype(f),
        rng.standard_normal((L, D, S * D)).astype(f),
        (rng.random((L, 1, S * D)) * 6.28).astype(f),
        (rng.standard_normal((L, 2 * S * D, D)) * 0.3).astype(f),
        rng.standard_normal(gp + (M, D)).astype(f),
        (rng.standard_normal((L, M, D)) * 0.1).astype(f),
        rng.uniform(0.8, 3.0, gp + (D, D)).astype(f),
        rng.uniform(0.3, 1.0, gp + (D,)).astype(f))]


# (L, N, S, M, D, per-draw GP operands): S*D past one 256-column chunk,
# M past one point chunk of each kernel, N past one row tile of each
@pytest.mark.parametrize('L,N,S,M,D,per_draw', [
    (2, 5, 8, 7, 4, False), (1, 1, 300, 17, 1, False),
    (2, 9, 45, 50, 6, False), (3, 20, 24, 23, 12, True),
    (1, 13, 40, 37, 7, False), (2, 6, 17, 20, 16, False),
    (2, 9, 14, 30, 20, True), (1, 10, 6, 11, 48, False),
    (2, 9, 5, 20, 49, True), (1, 11, 6, 18, 64, False)])
def test_kernels_match_plain(emulated, L, N, S, M, D, per_draw):
    x, *ops_ = _operands(70 + D, L, N, S, M, D, per_draw)
    g = torch.as_tensor(np.random.default_rng(80 + D).standard_normal(
        (L, N, D)).astype(np.float32))
    out = tdpt._launch(x, ops_)
    ref = df_pathwise.df_pathwise_reference(x, *ops_)
    assert bool(((out - ref).abs() <= TOL + TOL * ref.abs()).all())
    bars = tdpt._launch_bwd(x, ops_, g)
    for a, b in zip(bars, df_pathwise.df_pathwise_vjp_reference(x, *ops_, g)):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= TOL * (1 + float(b.abs().max()))
    assert torch.equal(tdpt._launch(x, ops_), out)
    assert all(torch.equal(a, b)
               for a, b in zip(tdpt._launch_bwd(x, ops_, g), bars))


def test_wide_tables_through_l2(libs, emulated):
    """The wide kernels keep 1/ls2 | var in shared memory where they fit
    the opt-in limit, else read ls2 and var through L2: with the limit
    lowered, the forward at D = 80 (27,500 bytes: its 6,480 floats of
    1/ls2 | var do not fit beside the rows and a chunk's trig table) and
    the VJP at D = 33 (42,000 bytes: 1,122 floats beside the update
    block's 10,004) take that path and still match the plain version;
    below what their rows need the launchers refuse."""
    fwd, bwd = libs['df_pathwise_tiled_fwd'], libs['df_pathwise_tiled_bwd']
    for lib in (fwd, bwd):
        lib.emu_set_optin.argtypes = [ctypes.c_int]
        lib.emu_set_optin.restype = None
    try:
        fwd.emu_set_optin(27500)
        x, *ops_ = _operands(90, 1, 3, 1, 3, 80, False)
        out = tdpt._launch(x, ops_)
        ref = df_pathwise.df_pathwise_reference(x, *ops_)
        assert bool(((out - ref).abs() <= TOL + TOL * ref.abs()).all())
        bwd.emu_set_optin(42000)
        x, *ops_ = _operands(91, 2, 5, 3, 5, 33, True)
        g = torch.as_tensor(np.random.default_rng(92).standard_normal(
            x.shape).astype(np.float32))
        bars = tdpt._launch_bwd(x, ops_, g)
        for a, b in zip(bars, df_pathwise.df_pathwise_vjp_reference(
                x, *ops_, g)):
            assert float((a - b).abs().max()) <= TOL * (
                1 + float(b.abs().max()))
        bwd.emu_set_optin(20000)
        with pytest.raises(RuntimeError, match="exceed the card's limits"):
            tdpt._launch_bwd(x, ops_, g)
    finally:
        for lib in (fwd, bwd):
            lib.emu_set_optin(232448)


def test_launchers_refuse_a_wrong_layout(emulated):
    """The C launchers check the slab layout the wrapper sized; a layout
    that is off by one is refused before any block runs."""
    lib = _build.load('df_pathwise_tiled_bwd')
    tdpt._bwd_lib()
    lay = (ctypes.c_int * 3)()
    lib.df_pathwise_tiled_bwd_layout(20, 12, 12288, 100, lay)
    assert tuple(lay) == tdpt.bwd_layout(20, 12, 12288, 100)
    null = [None, 0] * 8 + [None] * 11
    n_chunks, n_mc, n_rt = tuple(lay)
    assert lib.df_pathwise_tiled_bwd(*null, n_chunks, n_mc + 1, n_rt, 1, 20,
                                     12, 12288, 100, 0, None) != 0
    fwd = _build.load('df_pathwise_tiled_fwd')
    tdpt._lib()
    for D in (12, 20, 64, 300):
        assert fwd.df_pathwise_tiled_fwd_slots(12288, 100, D) == \
            tdpt.fwd_slots(12288, 100, D)
    assert fwd.df_pathwise_tiled_fwd(*([None, 0] * 8 + [None, None]),
                                     tdpt.fwd_slots(12288, 100, 12) - 1, 1,
                                     20, 12, 12288, 100, 0, None) != 0
