"""Nothing the benchmark runs loads JAX or the JAX package: the check of
loaded module names, compared whole up to the first dot, and the
benchmark's own sources."""

import ast
import os
import subprocess
import sys

from portbench.tests import small  # noqa: F401
from portbench.harness import runner, spec


def test_forbidden_names_compared_whole():
    names = ['jax', 'jax.numpy', 'jaxlib.xla_client', 'flax.linen',
             'vae_gp_ode_tpu', 'vae_gp_ode_tpu.ops.flow_fused',
             'vae_gp_ode_tpu_torch', 'vae_gp_ode_tpu_torch.utils.jax_import',
             'jaxtyping', 'flaxen', 'torch']
    assert runner.forbidden_modules(names) == [
        'flax', 'jax', 'jaxlib', 'vae_gp_ode_tpu']
    assert runner.forbidden_modules(['vae_gp_ode_tpu_torch.serving']) == []


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax():
    top = os.path.join(spec.ROOT, 'portbench')
    for base, _, files in os.walk(top):
        for f in files:
            if not f.endswith('.py'):
                continue
            path = os.path.join(base, f)
            mods = list(_imports(path))
            assert runner.forbidden_modules(mods) == [], path
            if os.sep + 'reference' + os.sep in path:
                assert not [m for m in mods if m.split('.')[0] not in
                            ('torch', 'numpy', 'math', 'portbench')], path


def test_the_port_loads_no_jax():
    code = ('import sys; sys.path.insert(0, %r); '
            'from portbench.harness import program, runner; program.load(); '
            'import vae_gp_ode_tpu_torch.main; '
            'print(runner.forbidden_modules())' % spec.ROOT)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == '[]'
