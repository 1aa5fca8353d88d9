"""Grid-tiled per-step pathwise evaluation of the dimwise-RBF GP sample for
wide shapes: one CUDA kernel for the forward and one for its VJP (port of
`vae_gp_ode_tpu/ops/pathwise_tiled.py`), and the card's dispatch rule
between them and the single-block pair of `ops.pathwise`.

Both pairs compute the same function, `ops.pathwise.pathwise_eval_reference`
(imported here as the plain version). They split the work differently:

* `csrc/pathwise_fwd.cu` (#3): one launch; a thread-block cluster per
  (draw, row tile, chunk of output dims) whose blocks share out the
  features and inducing points and sum their partials through
  distributed shared memory (clusters of 8 for long feature lists, of one
  block that loads its own items for short ones).
* `csrc/pathwise_bwd.cu` (#4): one block per (draw, row tile) that walks
  all K*S feature columns.
* `csrc/pathwise_tiled_fwd.cu` (#9): a grid over (draw, output dim k,
  feature chunk), with the inducing update in a slot of its own; per-block
  partials go to a slab that the wrapper sums, without atomics.
* `csrc/pathwise_tiled_bwd.cu` (#10): blocks of 64 contiguous feature
  columns of omega's (D, S*K) layout beside blocks of 64 inducing points
  of one output dim, all rows per block in tiles of 20; per-block partials
  go to slabs that a second kernel of the same library call sums in a
  fixed order (and over the draws of a shared operand), so the wrapper
  runs no reduction; the library exports the size of its workspace, and
  its launcher checks the buffer it is given.

`pathwise_eval` is the per-step eval that `gp.svgp.fn_eval` calls: CPU
tensors take the plain version; CUDA tensors take the kernels that
`use_tiled` names for the shapes, decided before any launch.
"""

import ctypes
import itertools
import math

import torch

from vae_gp_ode_tpu_torch import ops
from vae_gp_ode_tpu_torch.ops import _build
from vae_gp_ode_tpu_torch.ops import pathwise
from vae_gp_ode_tpu_torch.ops.pathwise import (
    NAMES, _check, _check_tensors, _draws, _flat, apply_routed,
    pathwise_eval_reference,
)

KERNEL = 'pathwise_tiled_fwd'
SOURCE = 'vae_gp_ode_tpu_torch/csrc/pathwise_tiled_fwd.cu'
#: the TPU kernel this one replaces
REPLACES = 'vae_gp_ode_tpu/ops/pathwise_tiled.py:69'

BWD_KERNEL = 'pathwise_tiled_bwd'
BWD_SOURCE = 'vae_gp_ode_tpu_torch/csrc/pathwise_tiled_bwd.cu'
BWD_REPLACES = 'vae_gp_ode_tpu/ops/pathwise_tiled.py:150'

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_ARGTYPES = [_P, _LL] * 8 + [_P] + [_I] * 7 + [_P]
_BWD_ARGTYPES = [_P, _LL] * 8 + [_P, _P, _LL] + [_P] * 8 + [_I] * 7 + [_P]
# -- the kernels --------------------------------------------------------------

def _lib():
    lib = _build.load('pathwise_tiled_fwd')
    if lib.pathwise_tiled_fwd.argtypes is None:
        lib.pathwise_tiled_fwd.argtypes = _ARGTYPES
        lib.pathwise_tiled_fwd.restype = ctypes.c_int
        lib.pathwise_tiled_fwd_chunk.argtypes = []
        lib.pathwise_tiled_fwd_chunk.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = _build.load('pathwise_tiled_bwd')
    if lib.pathwise_tiled_bwd.argtypes is None:
        lib.pathwise_tiled_bwd.argtypes = _BWD_ARGTYPES
        lib.pathwise_tiled_bwd.restype = ctypes.c_int
        lib.pathwise_tiled_bwd_workspace.argtypes = [_I] * 6 + [_LL] * 4
        lib.pathwise_tiled_bwd_workspace.restype = ctypes.c_longlong
        lib.pathwise_tiled_bwd_smem_bytes.argtypes = [_I]
        lib.pathwise_tiled_bwd_smem_bytes.restype = ctypes.c_longlong
        lib.pathwise_tiled_bwd_smem_optin.argtypes = [_I]
        lib.pathwise_tiled_bwd_smem_optin.restype = ctypes.c_int
    return lib


def _launch(x, operands):
    """Launch the tiled forward kernel; returns (L, N, K), the sum of its
    per-slot partials."""
    _check_tensors(x.device, zip(('x',) + NAMES, (x,) + tuple(operands)))
    L, N, D, K, S, M, strides = _check(x, operands)
    lib = _lib()
    n_slots = -(-S // lib.pathwise_tiled_fwd_chunk()) + 1
    part = torch.empty((L, n_slots, N, K), dtype=torch.float32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.pathwise_tiled_fwd(*_flat(x, operands, strides),
                                part.data_ptr(), L, N, D, K, S, M,
                                x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f'{KERNEL} launch failed: CUDA error {rc} '
                           f'(L={L} N={N} D={D} K={K} S={S} M={M})')
    ops.count(KERNEL, (L, N, D, K, S, M))
    return part.sum(dim=1)


def _launch_bwd(x, operands, g):
    """Launch the tiled VJP kernel and its sums for the cotangent g (L, N,
    K). Returns dx (L, N, D) and the operands' cotangents, each in its
    operand's shape (summed by the library over the draws an operand is
    shared by)."""
    _check_tensors(x.device, zip(('x',) + NAMES + ('g',),
                                 (x,) + tuple(operands) + (g,)))
    L, N, D, K, S, M, strides = _check(x, operands)
    if tuple(g.shape) != (L, N, K):
        raise ValueError(f'g has shape {tuple(g.shape)}, expected '
                         f'({L}, {N}, {K})')
    lib = _bwd_lib()
    om, ph, w, _, nu, _, _ = strides
    n_ws = lib.pathwise_tiled_bwd_workspace(L, N, D, K, S, M, om, ph, w, nu)
    workspace = torch.empty(n_ws, dtype=torch.float32, device=x.device)
    shapes = [(L, N, D)] + [tuple(t.shape) for t in operands]
    sizes = [math.prod(shape) for shape in shapes]
    out = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    offsets = itertools.accumulate([0] + sizes[:-1])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.pathwise_tiled_bwd(
        *_flat(x, operands, strides), g.data_ptr(), workspace.data_ptr(),
        n_ws, *(out.data_ptr() + 4 * o for o in offsets), L, N, D, K, S, M,
        x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f'{BWD_KERNEL} launch failed: CUDA error {rc} '
                           f'(L={L} N={N} D={D} K={K} S={S} M={M})')
    ops.count(BWD_KERNEL, (L, N, D, K, S, M))
    return tuple(part.view(shape)
                 for part, shape in zip(out.split(sizes), shapes))


def tiled_pathwise_eval(x, omega, phase, weights, Z, nu, ls, var):
    """Per-step pathwise eval through the tiled pair (#9, and #10 in
    reverse mode); same arguments and result as
    :func:`pathwise_eval_reference` with at most one leading dim of L
    draws. CPU tensors take the plain version; anything but CUDA or CPU
    tensors raises."""
    operands = (omega, phase, weights, Z, nu, ls, var)
    if all(t.device.type == 'cpu' for t in (x,) + operands):
        return pathwise_eval_reference(x, *operands)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    return apply_routed(_launch, _launch_bwd, x, operands,
                        pathwise._BASE_DIMS)


# -- the card's dispatch rule -------------------------------------------------

def tiled_bwd_smem_bytes(D):
    """Shared memory of one #10 block at state dim D (csrc/
    pathwise_tiled_bwd.cu smem_bytes: the larger kind, an inducing-point
    block of 64 points, 4 row groups and 20-row tiles, its rows (D padded
    to whole float4s), 1/ls, Z,
    the tile's dq, its points' sums and the warps' dx terms)."""
    return 4 * (20 * -(-D // 4) * 4 + D + 72 * D + 64 * 21
                + 4 * (2 * D + 1) * 64 + 8 * 32 * D)


def pick(L, N, D, K, S, M, optin):
    """Which pair takes the per-step eval on a card with `optin` bytes of
    shared memory per block: (forward tiled, VJP tiled),
    each True for the tiled kernel (#9, #10) and False for the
    single-block one (#3, #4). Decided from the shapes alone, from the
    sweep per call that `chip_smoke.py` phase 6d measures on an H100 and
    the device time per launch of both pairs (PERF.md section 6).

    The VJP: #10 takes every shape whose block fits the shared memory
    (`tiled_bwd_smem_bytes`, D <= 65 at the H100's opt-in): it was the
    faster call at all 20 shapes of the sweep, by 1.3-8x, and the faster
    kernel on the device at every measured shape. #4 remains for wider
    states.

    The forward: both kernels are one call's host issue (~40-70 us on
    the sweep's host) plus a few to a few hundred microseconds of device
    time, and #9's partials need a second launch. #3 takes a short
    feature list (S + M <= 768) in clusters of one block at any row
    count. A long list takes clusters of 8 blocks per (draw, row tile),
    which cost more than #9's grid once there are many rows: #9 takes
    S + M > 768 from L*N*K*(S + M) >= 8e6 row-feature products, where the
    sweep's calls favour it (1.4-2x at N = 600).
    """
    fwd = S + M > 768 and L * N * K * (S + M) >= 8e6
    bwd = tiled_bwd_smem_bytes(D) <= optin
    return fwd, bwd


def use_tiled(L, N, D, K, S, M, device):
    """`pick` on CUDA `device` from its own shared-memory opt-in limit."""
    return pick(L, N, D, K, S, M, ops.card_properties(device)[1])


def rule_kernels(L, N, D, K, S, M, device):
    """The names of the (forward, VJP) kernels that `use_tiled` picks."""
    fwd, bwd = use_tiled(L, N, D, K, S, M, device)
    return (KERNEL if fwd else pathwise.KERNEL,
            BWD_KERNEL if bwd else pathwise.BWD_KERNEL)


def pathwise_eval(x, omega, phase, weights, Z, nu, ls, var):
    """The per-step pathwise eval of `gp.svgp.fn_eval`: same arguments and
    result as :func:`pathwise_eval_reference` with at most one leading dim
    of L draws. CPU tensors take the plain version (and autograd through
    it); CUDA tensors launch the forward kernel that `use_tiled` names for
    the shapes and, in reverse mode, the VJP kernel it names."""
    operands = (omega, phase, weights, Z, nu, ls, var)
    if all(t.device.type == 'cpu' for t in (x,) + operands):
        return pathwise_eval_reference(x, *operands)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    L = _draws(x, operands)
    D, (S, K), M = x.shape[-1], omega.shape[-2:], Z.shape[-2]
    fwd, bwd = use_tiled(L or 1, x.shape[-2], D, K, S, M, x.device)
    return apply_routed(_launch if fwd else pathwise._launch,
                        _launch_bwd if bwd else pathwise._launch_bwd, x,
                        operands, pathwise._BASE_DIMS)
