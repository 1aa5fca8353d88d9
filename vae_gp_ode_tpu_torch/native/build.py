"""Build and ctypes bindings of the native rotation library (port of
`vae_gp_ode_tpu/native/build.py`).

`rotate.cpp` compiles with `g++ -O3 -march=native` at first use into
`build/vae_gp_ode_tpu_torch/native/librotate_<source hash>-<host>.so`
under the repository root (ignored by git), keyed by the source's hash and
the host (a -march=native build runs only where its instruction set
does). A build writes a temporary file and renames it into place, so
concurrent first uses never load a half-written library. Where no build
succeeds, `load_library` logs why once and returns None, and
`native_available()` is False: `data.synthetic` then rotates with scipy
and logs that it fell back.
"""

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, 'native', 'rotate.cpp')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build',
                         'vae_gp_ode_tpu_torch', 'native')
BUILD_TIMEOUT_S = 120

logger = logging.getLogger(__name__)
_lock = threading.Lock()
_lib = None
_tried = False


def library_path():
    """The shared library's path for this source and host."""
    with open(SRC, 'rb') as f:
        src_hash = hashlib.sha256(f.read()).hexdigest()[:16]
    host = hashlib.sha256(
        f'{platform.machine()}-{platform.processor()}-'
        f'{platform.node()}'.encode()).hexdigest()[:8]
    return os.path.join(BUILD_DIR, f'librotate_{src_hash}-{host}.so')


def _compile(so_path):
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    tmp = f'{so_path}.{os.getpid()}.tmp'
    try:
        subprocess.run(['g++', '-O3', '-march=native', '-shared', '-fPIC',
                        SRC, '-o', tmp], check=True, capture_output=True,
                       timeout=BUILD_TIMEOUT_S)
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_library():
    """Compile (if needed) and load the shared library; None (logged once)
    where it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so_path = library_path()
        try:
            if not os.path.exists(so_path):
                _compile(so_path)
            lib = ctypes.CDLL(so_path)
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, 'stderr', None) or b''
            logger.warning('native rotation library not built (%s%s); '
                           'rotating with scipy', e,
                           f': {detail.decode(errors="replace")[-400:]}'
                           if detail else '')
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.rotate_bilinear.argtypes = [f32p, f32p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_float]
        lib.make_rot_sequences.argtypes = [
            f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, f32p]
        lib.rotate_batch.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, f32p]
        for fn in (lib.rotate_bilinear, lib.make_rot_sequences,
                   lib.rotate_batch):
            fn.restype = None
        _lib = lib
        return _lib


def native_available():
    return load_library() is not None


def _require_library():
    lib = load_library()
    if lib is None:
        raise RuntimeError(
            'native rotation library unavailable (no C++ compiler, or the '
            'build failed); guard calls with native_available() or use '
            'data.synthetic.rotate_image (scipy)')
    return lib


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def rotate_bilinear(img, angle_deg):
    """Rotate an (h, w) float32 image by `angle_deg` (scipy.ndimage.rotate
    reshape=False, order=1 semantics)."""
    lib = _require_library()
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 2:
        raise ValueError(f'img has shape {img.shape}, expected (h, w)')
    out = np.empty_like(img)
    lib.rotate_bilinear(_fp(img), _fp(out), img.shape[0], img.shape[1],
                        float(angle_deg))
    return out


def make_rot_sequences(bases, T, offsets=None):
    """(n, h, w) base images -> (n, T, h, w) full-turn rotation sequences
    (frame t at t * 360 / T + offsets[n] degrees), clipped to [0, 1]."""
    lib = _require_library()
    bases = np.ascontiguousarray(bases, np.float32)
    if bases.ndim != 3:
        raise ValueError(f'bases has shape {bases.shape}, expected '
                         f'(n, h, w)')
    n, h, w = bases.shape
    if offsets is None:
        offsets = np.zeros(n, np.float32)
    offsets = np.ascontiguousarray(offsets, np.float32)
    if offsets.shape != (n,):
        raise ValueError(f'offsets has shape {offsets.shape}, expected '
                         f'({n},)')
    out = np.empty((n, T, h, w), np.float32)
    lib.make_rot_sequences(_fp(bases), _fp(out), n, T, h, w, _fp(offsets))
    return out


def rotate_batch(imgs, angles):
    """(n, h, w) images rotated by per-image angles, clipped to [0, 1]."""
    lib = _require_library()
    imgs = np.ascontiguousarray(imgs, np.float32)
    if imgs.ndim != 3:
        raise ValueError(f'imgs has shape {imgs.shape}, expected (n, h, w)')
    n, h, w = imgs.shape
    angles = np.ascontiguousarray(angles, np.float32)
    if angles.shape != (n,):
        raise ValueError(f'angles has shape {angles.shape}, expected '
                         f'({n},)')
    out = np.empty_like(imgs)
    lib.rotate_batch(_fp(imgs), _fp(out), n, h, w, _fp(angles))
    return out
