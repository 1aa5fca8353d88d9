"""Grid-tiled per-step pathwise evaluation of the dimwise-RBF GP sample for
wide shapes: one CUDA kernel for the forward and one for its VJP (port of
`vae_gp_ode_tpu/ops/pathwise_tiled.py`), and the card's dispatch rule
between them and the single-block pair of `ops.pathwise`.

Both pairs compute the same function, `ops.pathwise.pathwise_eval_reference`
(imported here as the plain version). They split the work differently:

* `csrc/pathwise_fwd.cu` / `pathwise_bwd.cu` (#3/#4): one block per
  (draw, row tile[, output dim]); the VJP's blocks each walk all K*S
  feature columns.
* `csrc/pathwise_tiled_fwd.cu` / `pathwise_tiled_bwd.cu` (#9/#10): a grid
  over (draw, output dim k, feature chunk), with the inducing update in a
  slot of its own; per-block partials go to slabs that the wrapper sums,
  without atomics.

`pathwise_eval` is the per-step eval that `gp.svgp.fn_eval` calls: CPU
tensors take the plain version; CUDA tensors take the kernels that
`use_tiled` names for the shapes, decided before any launch.
"""

import ctypes

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
_BWD_ARGTYPES = [_P, _LL] * 8 + [_P] * 9 + [_I] * 7 + [_P]


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
        lib.pathwise_tiled_bwd_chunk.argtypes = []
        lib.pathwise_tiled_bwd_chunk.restype = ctypes.c_int
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
    """Launch the tiled VJP kernel for the cotangent g (L, N, K). Returns dx
    (L, N, D) and the operands' cotangents, each in its operand's shape
    (summed over the draws an operand is shared by)."""
    _check_tensors(x.device, zip(('x',) + NAMES + ('g',),
                                 (x,) + tuple(operands) + (g,)))
    L, N, D, K, S, M, strides = _check(x, operands)
    if tuple(g.shape) != (L, N, K):
        raise ValueError(f'g has shape {tuple(g.shape)}, expected '
                         f'({L}, {N}, {K})')
    lib = _bwd_lib()
    n_slots = -(-S // lib.pathwise_tiled_bwd_chunk()) + 1

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x.device)
    dx_slab, dvar_slab = empty(L, n_slots, K, N, D), empty(L, n_slots, K)
    dom, dph, dw = empty(L, D, S, K), empty(L, 1, S, K), empty(L, S, K)
    dz_slab, dnu, dls = empty(L, K, M, D), empty(L, K, M), empty(L, K, D)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.pathwise_tiled_bwd(
        *_flat(x, operands, strides), g.data_ptr(), dx_slab.data_ptr(),
        dvar_slab.data_ptr(), dom.data_ptr(), dph.data_ptr(), dw.data_ptr(),
        dz_slab.data_ptr(), dnu.data_ptr(), dls.data_ptr(), L, N, D, K, S, M,
        x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f'{BWD_KERNEL} launch failed: CUDA error {rc} '
                           f'(L={L} N={N} D={D} K={K} S={S} M={M})')
    ops.count(BWD_KERNEL, (L, N, D, K, S, M))
    per_draw = (dom, dph, dw, dz_slab.sum(dim=1), dnu, dls,
                dvar_slab.sum(dim=1))
    return (dx_slab.sum(dim=(1, 2)),) + tuple(
        bar if t.dim() == bar.dim() else bar.sum(dim=0)
        for t, bar in zip(operands, per_draw))


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
    pathwise_tiled_bwd.cu smem_bytes: 8 rows, 128 threads)."""
    return 4 * (2 * 8 * D + 8 + D + 8 * 128 + 2 * 128 * D)


def pick(L, N, D, K, S, M, sms, optin):
    """Which pair takes the per-step eval on a card with `sms` SMs and
    `optin` bytes of shared memory per block: (forward tiled, VJP tiled),
    each True for the tiled kernel (#9, #10) and False for the
    single-block one (#3, #4). Decided from the shapes alone, as the
    crossover of the sweep that `chip_smoke.py` phase 6d measures on an
    H100 (PERF.md section 6).

    The VJP: #4's blocks each walk K*(ceil(S/128) + ceil(M/128)) chunks of
    128 columns (8 rows at a time), #10's each walk ceil(N/8) row tiles
    (times ceil(M/128) in the update slot). #10 is taken where #4's chain
    is the longer one, or more than 0.6 of #10's once #4's L*ceil(N/8)
    blocks no longer fit one wave on the SMs, and where #10's block fits
    the shared memory. The forward: both are bound by the host's issue
    time (~35-70 us a call) up to L*N*K*S ~ 2e7, where #3's device time
    takes over; below it the tiled forward's extra summation launch makes
    it the slower one.
    """
    chain4 = K * (-(-S // 128) + -(-M // 128))
    chain10 = -(-N // 8) * -(-M // 128)
    share = 0.6 if L * -(-N // 8) > sms else 1.0
    bwd = (chain4 > share * chain10
           and tiled_bwd_smem_bytes(D) <= optin)
    fwd = L * N * K * S >= 2e7
    return fwd, bwd


def use_tiled(L, N, D, K, S, M, device):
    """`pick` on CUDA `device` from its own SM count and shared-memory
    opt-in limit."""
    return pick(L, N, D, K, S, M, *ops.card_properties(device))


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
