"""The port stands alone: it imports neither JAX nor the JAX package, its
CUDA sources are plain C++ built with nvcc, and its wrappers compute the
plain version only for CPU tensors. CPU-only checks."""

import ast
import os
import subprocess
import sys

import pytest
import torch
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'vae_gp_ode_tpu_torch')
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'vae_gp_ode_tpu')
#: the port's scripts at the repository root
SCRIPTS = ['chip_smoke', 'grad_precision_probe', 'df_state_probe',
           'rbf_pathwise_probe', 'df_pathwise_probe', 'df_tiled_probe']


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for fn in sorted(files):
            if fn.endswith('.py'):
                rel = os.path.relpath(os.path.join(dirpath, fn), ROOT)
                mod = rel[:-3].replace(os.sep, '.')
                mods.append(mod[:-len('.__init__')]
                            if mod.endswith('.__init__') else mod)
    return sorted(mods)


def _python_sources():
    paths = [os.path.join(ROOT, f'{name}.py') for name in SCRIPTS]
    for dirpath, _, files in os.walk(PKG):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith('.py')]
    return paths


def test_no_forbidden_import_statements():
    for path in _python_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or '']
            else:
                continue
            for name in names:
                top = name.split('.')[0]
                assert top not in FORBIDDEN, f'{path} imports {name}'


def test_every_module_imports_with_jax_blocked():
    """Import every module of the port and chip_smoke.py in a fresh
    interpreter where importing jax, flax or the JAX package fails."""
    for mod in ('main', 'data.mnist', 'data.synthetic', 'training.trainer',
                'training.checkpoint', 'training.meters', 'ops.flow_fused',
                'ops.pathwise', 'ops.df_pathwise', 'ops.df_flow_fused',
                'ops.pathwise_tiled', 'ops.df_pathwise_tiled',
                'kernels.divfree', 'dynamics.solvers', 'dynamics.adjoint',
                'utils.jax_import', 'utils.torch_import', 'evaluate',
                'main_vae', 'serving', 'serve_http', 'ops.library',
                'utils.io', 'utils.summary', 'utils.plotting', 'native',
                'native.build', 'parallel', 'parallel.shard_dp',
                'parallel.data_parallel', 'parallel.feature_parallel',
                'core.collectives'):
        assert f'vae_gp_ode_tpu_torch.{mod}' in _port_modules()
    code = (
        'import sys\n'
        f'for name in {FORBIDDEN!r}:\n'
        '    sys.modules[name] = None\n'
        'import importlib\n'
        f'for mod in {_port_modules() + SCRIPTS!r}:\n'
        '    importlib.import_module(mod)\n'
        'bad = [m for m in sys.modules if sys.modules[m] is not None and\n'
        f'       m.split(".")[0] in {FORBIDDEN!r}]\n'
        'assert not bad, bad\n'
        'print("OK", len(sys.modules))\n')
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith('OK')


def test_cuda_sources_are_plain_cuda():
    """Route (b): nvcc into a plain-C shared library loaded with ctypes.
    No source includes PyTorch's headers, every `.cu` exports a plain C
    interface (the `.cuh` headers hold shared device code), and nothing
    uses torch.utils.cpp_extension."""
    csrc = os.path.join(PKG, 'csrc')
    sources = [f for f in os.listdir(csrc) if f.endswith(('.cu', '.cuh'))]
    assert {'flow_fused.cu', 'flow_fused_bwd.cu', 'pathwise_fwd.cu',
            'pathwise_bwd.cu', 'df_pathwise_fwd.cu', 'df_pathwise_bwd.cu',
            'df_flow_fused.cu', 'df_flow_fused_bwd.cu',
            'pathwise_tiled_fwd.cu', 'pathwise_tiled_bwd.cu',
            'df_pathwise_tiled_fwd.cu', 'df_pathwise_tiled_bwd.cu',
            'df_common.cuh'} <= set(sources)
    for fn in sources:
        with open(os.path.join(csrc, fn)) as f:
            text = f.read()
        assert 'torch/' not in text and 'ATen' not in text
        assert fn.endswith('.cuh') or 'extern "C"' in text
    for path in _python_sources():
        with open(path) as f:
            text = f.read()
        assert 'cpp_extension' not in text, path
        assert 'load_inline' not in text, path


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from vae_gp_ode_tpu_torch.ops import _build
    monkeypatch.setenv('NVCC', str(tmp_path / 'missing-nvcc'))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setattr(_build, 'BUILD_ROOT', str(tmp_path / 'build'))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.build(['flow_fused'])
    assert not os.path.exists(tmp_path / 'build') or not any(
        f.endswith('.so') for _, _, fs in os.walk(tmp_path / 'build')
        for f in fs)


def test_build_failure_reports_nvcc_stderr(monkeypatch, tmp_path):
    """A failing compiler raises with its stderr and leaves no library
    (a stand-in script plays nvcc)."""
    from vae_gp_ode_tpu_torch.ops import _build
    fake = tmp_path / 'nvcc'
    fake.write_text('#!/bin/sh\necho "error: no card here" >&2\nexit 3\n')
    fake.chmod(0o755)
    monkeypatch.setenv('NVCC', str(fake))
    monkeypatch.setattr(_build, 'BUILD_ROOT', str(tmp_path / 'build'))
    with pytest.raises(RuntimeError, match='no card here'):
        _build.build(['flow_fused'])
    leftovers = [f for _, _, fs in os.walk(tmp_path / 'build') for f in fs]
    assert leftovers == []


def test_build_is_atomic_and_cached(monkeypatch, tmp_path):
    """A successful build renames its temporary file into place; a second
    build of unchanged sources runs no compiler."""
    from vae_gp_ode_tpu_torch.ops import _build
    log = tmp_path / 'calls'
    fake = tmp_path / 'nvcc'
    fake.write_text('#!/bin/sh\necho x >> ' + str(log) + '\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'echo lib > "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setenv('NVCC', str(fake))
    monkeypatch.setattr(_build, 'BUILD_ROOT', str(tmp_path / 'build'))
    paths = _build.build(['flow_fused'])
    assert open(paths['flow_fused']).read() == 'lib\n'
    assert os.listdir(os.path.dirname(paths['flow_fused'])) == [
        'libflow_fused.so']
    _build.build(['flow_fused'])
    assert open(log).read().count('x') == 1


def test_cpu_tensors_take_the_plain_version():
    from vae_gp_ode_tpu_torch import ops
    from vae_gp_ode_tpu_torch.ops import flow_fused
    g = torch.Generator().manual_seed(0)
    N, D, S, M, T = 3, 2, 8, 4, 4
    args = (torch.randn(N, D, generator=g), torch.randn(D, S, D, generator=g),
            torch.rand(1, S, D, generator=g), torch.randn(S, D, generator=g),
            torch.randn(M, D, generator=g), torch.randn(D, M, generator=g),
            torch.rand(D, D, generator=g) + 0.5, torch.rand(D, generator=g))
    before = ops.LAUNCHES[flow_fused.KERNEL]
    out = flow_fused.fused_euler_flow(*args, 0.1, T)
    assert out.shape == (T, N, D) and torch.isfinite(out).all()
    assert ops.LAUNCHES[flow_fused.KERNEL] == before
