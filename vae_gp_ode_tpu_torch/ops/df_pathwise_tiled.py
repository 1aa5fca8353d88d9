"""Grid-tiled per-step pathwise evaluation of the divergence-free (DF) GP
sample for wide shapes: one CUDA kernel for the forward and one for its
VJP (port of `vae_gp_ode_tpu/ops/df_pathwise_tiled.py`), and the card's
dispatch rule between them and the single-block pair of
`ops.df_pathwise`.

Both pairs compute the same function, `ops.df_pathwise.
df_pathwise_reference` (imported here as the plain version):

* `csrc/df_pathwise_fwd.cu` / `df_pathwise_bwd.cu` (#5/#6): one block per
  (draw, R rows) that walks all S*D feature columns and D^2 output-dim
  pairs.
* `csrc/df_pathwise_tiled_fwd.cu` / `df_pathwise_tiled_bwd.cu` (#11/#12):
  the forward over (draw, output column i, feature chunk) with the update
  of column i in a slot of its own; the VJP over (draw, feature chunk)
  with i a loop inside the block, plus one update block per (draw, i).
  Per-block partials go to slabs that the wrapper sums, without atomics.

`df_pathwise_eval` is the per-step eval that `gp.svgp.fn_eval` calls for
the DF kernel: CPU tensors take the plain version; CUDA tensors take the
kernels that `use_df_tiled` names for the shapes, decided before any
launch. State dims above 16 raise NotImplementedError on the card.
"""

import ctypes

import torch

from vae_gp_ode_tpu_torch import ops
from vae_gp_ode_tpu_torch.ops import _build
from vae_gp_ode_tpu_torch.ops import df_pathwise
from vae_gp_ode_tpu_torch.ops.df_pathwise import (
    BASE_DIMS, MAX_D, NAMES, _check_x, check_operands,
    df_pathwise_reference,
)
from vae_gp_ode_tpu_torch.ops.pathwise import (
    _check_tensors, _draws, _flat, apply_routed,
)

KERNEL = 'df_pathwise_tiled_fwd'
SOURCE = 'vae_gp_ode_tpu_torch/csrc/df_pathwise_tiled_fwd.cu'
#: the TPU kernel this one replaces
REPLACES = 'vae_gp_ode_tpu/ops/df_pathwise_tiled.py:58'

BWD_KERNEL = 'df_pathwise_tiled_bwd'
BWD_SOURCE = 'vae_gp_ode_tpu_torch/csrc/df_pathwise_tiled_bwd.cu'
BWD_REPLACES = 'vae_gp_ode_tpu/ops/df_pathwise_tiled.py:154'

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_ARGTYPES = [_P, _LL] * 8 + [_P] + [_I] * 6 + [_P]
_BWD_ARGTYPES = [_P, _LL] * 8 + [_P] * 9 + [_I] * 6 + [_P]


# -- the kernels --------------------------------------------------------------

def _lib():
    lib = _build.load('df_pathwise_tiled_fwd')
    if lib.df_pathwise_tiled_fwd.argtypes is None:
        lib.df_pathwise_tiled_fwd.argtypes = _ARGTYPES
        lib.df_pathwise_tiled_fwd.restype = ctypes.c_int
        lib.df_pathwise_tiled_fwd_chunk.argtypes = []
        lib.df_pathwise_tiled_fwd_chunk.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = _build.load('df_pathwise_tiled_bwd')
    if lib.df_pathwise_tiled_bwd.argtypes is None:
        lib.df_pathwise_tiled_bwd.argtypes = _BWD_ARGTYPES
        lib.df_pathwise_tiled_bwd.restype = ctypes.c_int
        lib.df_pathwise_tiled_bwd_chunk.argtypes = []
        lib.df_pathwise_tiled_bwd_chunk.restype = ctypes.c_int
    return lib


def _launch(x, operands):
    """Launch the tiled forward kernel; returns (L, N, D), the sum of its
    per-slot partials."""
    _check_tensors(x.device, zip(('x',) + NAMES, (x,) + tuple(operands)))
    L, N, D = _check_x(x)
    SD, M, strides = check_operands(L, D, operands)
    lib = _lib()
    n_slots = -(-SD // lib.df_pathwise_tiled_fwd_chunk()) + 1
    part = torch.empty((L, n_slots, N, D), dtype=torch.float32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.df_pathwise_tiled_fwd(*_flat(x, operands, strides),
                                   part.data_ptr(), L, N, D, SD, M,
                                   x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f'{KERNEL} launch failed: CUDA error {rc} '
                           f'(L={L} N={N} D={D} SD={SD} M={M})')
    ops.LAUNCHES[KERNEL] += 1
    return part.sum(dim=1)


def _launch_bwd(x, operands, g):
    """Launch the tiled VJP kernel for the cotangent g (L, N, D). Returns dx
    (L, N, D) and the operands' cotangents, each in its operand's shape
    (summed over the draws an operand is shared by)."""
    _check_tensors(x.device, zip(('x',) + NAMES + ('g',),
                                 (x,) + tuple(operands) + (g,)))
    L, N, D = _check_x(x)
    SD, M, strides = check_operands(L, D, operands)
    if tuple(g.shape) != (L, N, D):
        raise ValueError(f'g has shape {tuple(g.shape)}, expected '
                         f'({L}, {N}, {D})')
    lib = _bwd_lib()
    n_slots = -(-SD // lib.df_pathwise_tiled_bwd_chunk()) + D

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x.device)
    dx_slab = empty(L, n_slots, N, D)
    domf, dphf, dG = empty(L, D, SD), empty(L, 1, SD), empty(L, 2 * SD, D)
    dz_slab, dnur_slab = empty(L, D, M, D), empty(L, D, M, D)
    dls2, dvar = empty(L, D, D), empty(L, D)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.df_pathwise_tiled_bwd(
        *_flat(x, operands, strides), g.data_ptr(), dx_slab.data_ptr(),
        domf.data_ptr(), dphf.data_ptr(), dG.data_ptr(), dz_slab.data_ptr(),
        dnur_slab.data_ptr(), dls2.data_ptr(), dvar.data_ptr(), L, N, D, SD,
        M, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f'{BWD_KERNEL} launch failed: CUDA error {rc} '
                           f'(L={L} N={N} D={D} SD={SD} M={M})')
    ops.LAUNCHES[BWD_KERNEL] += 1
    per_draw = (domf, dphf, dG, dz_slab.sum(dim=1), dnur_slab.sum(dim=1),
                dls2, dvar)
    return (dx_slab.sum(dim=1),) + tuple(
        bar if t.dim() == bar.dim() else bar.sum(dim=0)
        for t, bar in zip(operands, per_draw))


def tiled_df_pathwise_eval(x, omf, phf, G, Z, nur, ls2, var):
    """Per-step DF eval through the tiled pair (#11, and #12 in reverse
    mode); same arguments and result as :func:`df_pathwise_reference`
    with at most one leading dim of L draws. CPU tensors take the plain
    version; anything but CUDA or CPU tensors raises, and so does a state
    dim above 16 on the card."""
    operands = (omf, phf, G, Z, nur, ls2, var)
    if all(t.device.type == 'cpu' for t in (x,) + operands):
        return df_pathwise_reference(x, *operands)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    return apply_routed(_launch, _launch_bwd, x, operands, BASE_DIMS)


# -- the card's dispatch rule -------------------------------------------------

def pick_df(L, N, D, SD, M, sms):
    """Which pair takes the DF per-step eval on a card with `sms` SMs:
    (forward tiled, VJP tiled), each True for the tiled kernel (#11, #12)
    and False for the single-block one (#5, #6). Decided from the shapes
    alone (D is at most 16: both pairs refuse more), as the crossover of
    the sweep that `chip_smoke.py` phase 6d measures on an H100 (PERF.md
    section 6).

    The VJP: #6 runs L*ceil(N/R) blocks (R = 4 rows up to D = 8, else 2)
    that each walk the SD feature columns for D outputs and the M inducing
    points for D^2 pairs, W = SD*D + M*D^2 steps, one block per SM; #12
    runs L*(ceil(SD/256) + D) blocks that each walk the ceil(N/R) row
    tiles with a block reduction per tile, ~1300 of #6's steps each on
    the sweep. #12 is taken where its tiles times its waves of blocks cost
    less than #6's steps times its waves. The forward: #11 recomputes the
    trig once per output column, so it wins only where #5's grid leaves
    SMs idle and its blocks walk at least 32768 column-output pairs
    (SD*D), that is at D = 12 with N = 20.
    """
    R = 4 if D <= 8 else 2
    tiles = -(-N // R)
    waves6 = -(-L * tiles // sms)
    waves12 = -(-L * (-(-SD // 256) + D) // sms)
    bwd = (SD * D + M * D * D) * waves6 > 1300 * tiles * waves12
    fwd = L * tiles < sms and SD * D >= 32768
    return fwd, bwd


def use_df_tiled(L, N, D, SD, M, device):
    """`pick_df` on CUDA `device` from its own SM count."""
    return pick_df(L, N, D, SD, M, ops.card_properties(device)[0])


def rule_kernels(L, N, D, SD, M, device):
    """The names of the (forward, VJP) kernels that `use_df_tiled`
    picks."""
    fwd, bwd = use_df_tiled(L, N, D, SD, M, device)
    return (KERNEL if fwd else df_pathwise.KERNEL,
            BWD_KERNEL if bwd else df_pathwise.BWD_KERNEL)


def df_pathwise_eval(x, omf, phf, G, Z, nur, ls2, var):
    """The per-step DF eval of `gp.svgp.fn_eval`: same arguments and result
    as :func:`df_pathwise_reference` with at most one leading dim of L
    draws. CPU tensors take the plain version (and autograd through it);
    CUDA tensors launch the forward kernel that `use_df_tiled` names for
    the shapes and, in reverse mode, the VJP kernel it names. A state dim
    above 16 raises NotImplementedError on the card."""
    operands = (omf, phf, G, Z, nur, ls2, var)
    if all(t.device.type == 'cpu' for t in (x,) + operands):
        return df_pathwise_reference(x, *operands)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    D = x.shape[-1]
    if D > MAX_D:
        raise NotImplementedError(
            f'the DF kernels take state dims up to {MAX_D}, got {D}')
    L = _draws(x, operands, BASE_DIMS)
    fwd, bwd = use_df_tiled(L or 1, x.shape[-2], D, omf.shape[-1],
                            Z.shape[-2], x.device)
    return apply_routed(_launch if fwd else df_pathwise._launch,
                        _launch_bwd if bwd else df_pathwise._launch_bwd, x,
                        operands, BASE_DIMS)
