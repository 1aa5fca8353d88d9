"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles on first use into a plain-C shared library,
`build/vae_gp_ode_tpu_torch/<hash>/lib<name>.so` under the repository
root, where <hash> covers every source in `csrc/` and the flags. No
source includes PyTorch's headers, so a build takes seconds. All pending
sources compile at once, one nvcc process each. A build writes a
temporary file and renames it into place, so a cut-off build never
leaves a half-written library; nothing takes or waits on a lock. nvcc's
`-Xptxas -v` report (registers, spills, shared memory per kernel) is kept
for `ptxas_usage`, in `build/vae_gp_ode_tpu_torch/ptxas/<hash>/<name>.txt`.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), 'build',
                          'vae_gp_ode_tpu_torch')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
BUILD_TIMEOUT_S = 300

_libs = {}


def nvcc_path():
    """The nvcc to build with: $NVCC, $CUDA_HOME/bin/nvcc, /usr/local/cuda,
    or nvcc on PATH."""
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    for cand in (os.environ.get('NVCC'), os.path.join(home, 'bin', 'nvcc'),
                 shutil.which('nvcc')):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError('nvcc not found (set NVCC or CUDA_HOME); the CUDA '
                       'kernels of vae_gp_ode_tpu_torch cannot be built')


def library_path(name):
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith(('.cu', '.cuh', '.h')):
            h.update(fn.encode())
            with open(os.path.join(CSRC, fn), 'rb') as f:
                h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], f'lib{name}.so')


def ptxas_path(name):
    lib = library_path(name)
    return os.path.join(os.path.dirname(os.path.dirname(lib)), 'ptxas',
                        os.path.basename(os.path.dirname(lib)), f'{name}.txt')


def build(names):
    """Compile each `csrc/<name>.cu` that is not built yet, all at once.

    Prints each nvcc command and its `-Xptxas -v` report. Raises with
    nvcc's stderr if nvcc is missing, fails or runs past the time limit.
    Returns {name: library path}.
    """
    paths = {name: library_path(name) for name in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    try:
        for name in todo:
            out = paths[name]
            os.makedirs(os.path.dirname(out), exist_ok=True)
            tmp = f'{out}.{os.getpid()}.tmp'
            cmd = [nvcc, *NVCC_FLAGS, '-o', tmp,
                   os.path.join(CSRC, f'{name}.cu')]
            print('nvcc:', ' '.join(cmd), flush=True)
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True), tmp, time.perf_counter())
        deadline = time.perf_counter() + BUILD_TIMEOUT_S
        errors = []
        for name, (proc, tmp, t0) in procs.items():
            try:
                stdout, stderr = proc.communicate(
                    timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                errors.append(f'nvcc for {name} ran past '
                              f'{BUILD_TIMEOUT_S} s')
                continue
            if proc.returncode != 0:
                errors.append(f'nvcc failed for {name} '
                              f'(exit {proc.returncode}):\n{stderr}')
                continue
            os.makedirs(os.path.dirname(ptxas_path(name)), exist_ok=True)
            with open(ptxas_path(name), 'w') as f:
                f.write(stdout + stderr)
            os.replace(tmp, paths[name])
            report = ' | '.join(
                ln.strip() for ln in (stdout + stderr).splitlines()
                if ln.strip())
            print(f'built lib{name}.so in {time.perf_counter() - t0:.1f} s; '
                  f'ptxas: {report}', flush=True)
        if errors:
            raise RuntimeError('\n'.join(errors))
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths


def ptxas_usage(name):
    """{kernel symbol: (registers, spill store bytes, spill load bytes)} of
    each kernel in lib<name>.so, from the `-Xptxas -v` report of its
    build."""
    with open(ptxas_path(name)) as f:
        text = f.read()
    usage = {}
    for block in text.split('Compiling entry function')[1:]:
        sym = re.search(r"'([^']+)'", block).group(1)
        spills = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill '
                           r'loads', block)
        regs = re.search(r'Used (\d+) registers', block)
        usage[sym] = (int(regs.group(1)), int(spills.group(1)),
                      int(spills.group(2)))
    return usage


def load(name):
    """The ctypes library of `csrc/<name>.cu`, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name])
        _libs[name] = lib
    return lib
