"""Grid-tiled per-step pathwise evaluation of the divergence-free (DF) GP
sample for wide shapes: one CUDA kernel for the forward and one for its
VJP (port of `vae_gp_ode_tpu/ops/df_pathwise_tiled.py`), and the card's
dispatch rule between them and the single-block pair of
`ops.df_pathwise`.

Both pairs compute the same function, `ops.df_pathwise.
df_pathwise_reference` (imported here as the plain version):

* `csrc/df_pathwise_fwd.cu` / `df_pathwise_bwd.cu` (#5/#6): a cluster
  of blocks per (draw, tile of rows) that shares out the S*D feature
  columns and the inducing points' (point, output) items
  (`csrc/df_cluster.cuh`).
* `csrc/df_pathwise_tiled_fwd.cu` / `df_pathwise_tiled_bwd.cu` (#11/#12):
  blocks of feature columns, each with one sincos per (row, column) for
  all D output columns, beside blocks of inducing points for the
  matrix-valued update (the lowest block indices, so they start first):
  the forward per (draw, 8 rows), the VJP's prior per draw for all rows
  and its update per (draw, 4 rows). Per-block partials go to slabs,
  summed in a fixed order without atomics by a second kernel of the same
  library call, so a call costs the host one library call; the layouts
  are `fwd_slots` and `bwd_layout`, which the C launchers check.

`df_pathwise_eval` is the per-step eval that `gp.svgp.fn_eval` calls for
the DF kernel: CPU tensors take the plain version; CUDA tensors take the
kernels that `use_df_tiled` names for the shapes, decided before any
launch. The tiled pair takes every state dim (above 16 through its wide
kernels, whose per-thread arrays run over output-dim tiles of a fixed
width and whose tables sit in shared memory sized at launch, or in L2
where they would not fit; the VJP up to D = 2,048, a feature column's
threads), the single-block pair up to 16; a shape is refused only for
the card's limits (the grid, a block's rows, the threads of a block), in
an error that says so.
"""

import ctypes
import itertools
import math

import torch

from vae_gp_ode_tpu_torch import ops
from vae_gp_ode_tpu_torch.ops import _build, library
from vae_gp_ode_tpu_torch.ops import df_pathwise
from vae_gp_ode_tpu_torch.ops.df_pathwise import (
    BASE_DIMS, MAX_D, NAMES, _check_x, check_operands,
    df_pathwise_reference,
)
from vae_gp_ode_tpu_torch.ops.pathwise import (
    _check_tensors, _draws, _flat, apply_routed, launch_jacobian,
    library_eval,
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
_ARGTYPES = [_P, _LL] * 8 + [_P, _P] + [_I] * 7 + [_P]
_BWD_ARGTYPES = [_P, _LL] * 8 + [_P] * 11 + [_I] * 9 + [_P]

#: csrc/df_pathwise_tiled_fwd.cu: inducing points per update block (up to
#: D = 16; above, THREADS // D, at least one) and feature columns per
#: chunk block
FWD_UPD_M, FWD_CHUNK = 16, 256
#: csrc/df_pathwise_tiled_bwd.cu: threads per block (the update blocks take
#: THREADS // D inducing points, one above D = THREADS), feature columns
#: per chunk block, rows per update block
THREADS, BWD_CHUNK, BWD_UPD_ROWS = 256, 256, 4


def fwd_slots(SD, M, D):
    """Slots of the forward's slab part (L, slots, N, D): one per chunk of
    inducing points, then one per chunk of feature columns
    (`df_pathwise_tiled_fwd_slots`)."""
    points = FWD_UPD_M if D <= MAX_D else max(1, THREADS // D)
    return -(-M // points) + -(-SD // FWD_CHUNK)


#: csrc/df_pathwise_tiled_bwd.cu kW: above D = 16 a feature column takes
#: ceil(D / WIDE_DIMS) threads of a chunk block, so the VJP takes D up to
#: THREADS * WIDE_DIMS
WIDE_DIMS = 8


def bwd_layout(N, D, SD, M):
    """(n_chunks, n_mc, n_rt) of the VJP's slabs: chunks of feature
    columns (BWD_CHUNK, above D = 16 THREADS // ceil(D / WIDE_DIMS)),
    chunks of THREADS // D inducing points (at least one) and update
    tiles of BWD_UPD_ROWS rows (`df_pathwise_tiled_bwd_layout`)."""
    chunk = BWD_CHUNK if D <= MAX_D else THREADS // -(-D // WIDE_DIMS)
    return (-(-SD // chunk), -(-M // max(1, THREADS // D)),
            -(-N // BWD_UPD_ROWS))


# -- the kernels --------------------------------------------------------------

#: what a launcher's cudaErrorInvalidValue (1) means for a shape that
#: passed the wrapper's checks
_LIMITS = ('; error 1: the grid (at most 2**31 - 1 blocks) or a block\'s '
           'rows of state dim D exceed the card\'s limits (its shared '
           'memory opt-in per block)')


def _lib():
    lib = _build.load('df_pathwise_tiled_fwd')
    if lib.df_pathwise_tiled_fwd.argtypes is None:
        lib.df_pathwise_tiled_fwd.argtypes = _ARGTYPES
        lib.df_pathwise_tiled_fwd.restype = ctypes.c_int
        lib.df_pathwise_tiled_fwd_slots.argtypes = [_I] * 3
        lib.df_pathwise_tiled_fwd_slots.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = _build.load('df_pathwise_tiled_bwd')
    if lib.df_pathwise_tiled_bwd.argtypes is None:
        lib.df_pathwise_tiled_bwd.argtypes = _BWD_ARGTYPES
        lib.df_pathwise_tiled_bwd.restype = ctypes.c_int
        lib.df_pathwise_tiled_bwd_layout.argtypes = [_I] * 4 + [_P]
        lib.df_pathwise_tiled_bwd_layout.restype = None
    return lib


def _launch(x, operands):
    """Launch the tiled forward kernel; returns (L, N, D), the sum of its
    per-slot partials (summed by the library's second kernel)."""
    _check_tensors(x.device, zip(('x',) + NAMES, (x,) + tuple(operands)))
    L, N, D = _check_x(x)
    SD, M, strides = check_operands(L, D, operands, max_d=None)
    lib = _lib()
    n_slots = fwd_slots(SD, M, D)
    part = torch.empty((L, n_slots, N, D), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((L, N, D), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.df_pathwise_tiled_fwd(*_flat(x, operands, strides),
                                   part.data_ptr(), out.data_ptr(), n_slots,
                                   L, N, D, SD, M, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f'{KERNEL} launch failed: CUDA error {rc} '
                           f'(L={L} N={N} D={D} SD={SD} M={M}){_LIMITS}')
    ops.count(KERNEL, (L, N, D, SD, M))
    return out


def _launch_bwd(x, operands, g):
    """Launch the tiled VJP kernel for the cotangent g (L, N, D). Returns dx
    (L, N, D) and the operands' cotangents, each in its operand's shape
    (summed over the draws an operand is shared by: by the library for Z,
    nur, ls2 and var, here for omf, phf and G)."""
    _check_tensors(x.device, zip(('x',) + NAMES + ('g',),
                                 (x,) + tuple(operands) + (g,)))
    L, N, D = _check_x(x)
    SD, M, strides = check_operands(L, D, operands, max_d=None)
    if D > THREADS * WIDE_DIMS:
        raise RuntimeError(
            f'{BWD_KERNEL} takes state dims up to {THREADS * WIDE_DIMS} (a '
            f'feature column gets at most a block\'s {THREADS} threads, '
            f'{WIDE_DIMS} dims each), got {D}')
    if tuple(g.shape) != (L, N, D):
        raise ValueError(f'g has shape {tuple(g.shape)}, expected '
                         f'({L}, {N}, {D})')
    lib = _bwd_lib()
    n_chunks, n_mc, n_rt = bwd_layout(N, D, SD, M)
    # workspace: dx_slab (L, n_mc + n_chunks, N, D), then upd (L, n_rt,
    # 2 M D + n_mc (D^2 + D)); out: dx, domf, dphf, dG per draw, then the
    # library's finished dZ, dnur, dls2, dvar in their operands' shapes
    n_dx = L * (n_mc + n_chunks) * N * D
    workspace = torch.empty(
        n_dx + L * n_rt * (2 * M * D + n_mc * (D * D + D)),
        dtype=torch.float32, device=x.device)
    shapes = [(L, N, D), (L, D, SD), (L, 1, SD), (L, 2 * SD, D)] + [
        tuple(t.shape) for t in operands[3:]]
    sizes = [math.prod(shape) for shape in shapes]
    out = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    offsets = itertools.accumulate([0] + sizes[:-1])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.df_pathwise_tiled_bwd(
        *_flat(x, operands, strides), g.data_ptr(), workspace.data_ptr(),
        workspace.data_ptr() + 4 * n_dx,
        *(out.data_ptr() + 4 * o for o in offsets), n_chunks, n_mc, n_rt, L,
        N, D, SD, M, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f'{BWD_KERNEL} launch failed: CUDA error {rc} '
                           f'(L={L} N={N} D={D} SD={SD} M={M}){_LIMITS}')
    ops.count(BWD_KERNEL, (L, N, D, SD, M))
    dx, domf, dphf, dG, *upd = [
        part.view(shape) for part, shape in zip(out.split(sizes), shapes)]
    return (dx,) + tuple(
        bar if bar.shape == t.shape else bar.sum(dim=0)
        for t, bar in zip(operands[:3], (domf, dphf, dG))) + tuple(upd)


def tiled_df_pathwise_eval(x, omf, phf, G, Z, nur, ls2, var):
    """Per-step DF eval through the tiled pair (#11, and #12 in reverse
    mode); same arguments and result as :func:`df_pathwise_reference`
    with at most one leading dim of L draws. CPU tensors take the plain
    version; anything but CUDA or CPU tensors raises."""
    operands = (omf, phf, G, Z, nur, ls2, var)
    if all(t.device.type == 'cpu' for t in (x,) + operands):
        return df_pathwise_reference(x, *operands)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    return apply_routed(_launch, _launch_bwd, x, operands, BASE_DIMS)


# -- the card's dispatch rule -------------------------------------------------

def pick_df(L, N, D, SD, M, sms, plan):
    """Which pair takes the DF per-step eval on a card with `sms` SMs:
    (forward tiled, VJP tiled), each True for the tiled kernel (#11, #12)
    and False for the single-block one (#5, #6). Decided from the shapes
    and #6's plan there (`df_pathwise.bwd_plan`: rows per pass, blocks per
    cluster, rows per tile, row tiles per draw, ...; None above MAX_D),
    from the device times of both pairs and the sweep per call that
    `chip_smoke.py` phase 6d measures on an H100 (PERF.md section 6).
    Above D = 16 (MAX_D) only the tiled pair takes the shape, at any D.

    The forward: #11 is taken for D > 8, where #5 runs its two-row
    instance and took 1.8-8x #11's device time at every measured shape
    before its redesign (49 against 14 us at L=5, N=20, D=12, S=256; 670
    against 376 at N=600, S=1024). At D <= 8 #5 is taken: checked
    against the redesigned #5 (clusters of blocks; 8.5 us at L=5, N=20,
    S=256 against #11's 7.1), it made the faster call at all 8 D <= 8
    shapes of the sweep in two runs, 5-48% ahead (host issue included:
    both calls are host-bound at small N, #5's by one kernel and one
    allocation less).

    The VJP: #6 (clusters walking tiles of rows, `plan`) is priced
    from its work per block (a column item ~7D + 40 operations a row, a
    (point, output) item ~45 D), its waves of blocks (two per SM up to
    D = 8) and its slabs (L tiles x (3 SD D + SD + 2 M D + D^2 + D)
    floats written and summed), fitted to its device time at 8 shapes
    (device us, 16 at L=1, N=20, D=6, S=256; 60 at N=600; 279 at L=5,
    N=20, D=12, S=1024; within 20%); #12's chunk blocks (L ceil(SD/256)
    of them) each walk all N rows, ~(0.25 + 0.015 D) us per row while
    they fit on the SMs. #12 is taken where that is the shorter time:
    everywhere but few draws with many rows (L=1, N=600, D=6: #6 60 us
    against #12's ~205 at S=256, 0.12 against 0.23 ms per call at
    S=512).
    """
    if D > MAX_D:
        return True, True
    _, C, RT, tiles = plan[:4]
    waves = -(-L * tiles * C // ((2 if D <= 8 else 1) * sms))
    work = RT * (-(-SD // C) * (7 * D + 40) + -(-M // C) * 45 * D * D) / 256
    slab = L * tiles * (3 * SD * D + SD + 2 * M * D + D * D + D)
    t6 = 1.5 + 0.0142 * waves * work + 1.32e-5 * slab
    t12 = N * (0.25 + 0.015 * D) * max(1.0, L * -(-SD // 256) / sms)
    return D > 8, t12 < t6


def use_df_tiled(L, N, D, SD, M, device):
    """`pick_df` on CUDA `device` from its own SM count and #6's plan
    there (which raises for shapes #6 refuses)."""
    plan = (df_pathwise.bwd_plan(L, N, D, SD, M, device) if D <= MAX_D
            else None)
    return pick_df(L, N, D, SD, M, ops.card_properties(device)[0], plan)


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
    the shapes and, in reverse mode, the VJP kernel it names, at any state
    dim. Where no input needs a gradient the call is the registered
    operator `vae_gp_ode_torch::df_pathwise_eval_fwd` (`ops.library`),
    which applies the rule's forward choice on the shapes it is called
    with."""
    operands = (omf, phf, G, Z, nur, ls2, var)
    if not library.needs_grad((x,) + operands):
        return library_eval(library.df_pathwise_eval_fwd, x, operands,
                            BASE_DIMS)
    if all(t.device.type == 'cpu' for t in (x,) + operands):
        return df_pathwise_reference(x, *operands)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    L = _draws(x, operands, BASE_DIMS)
    fwd, bwd = use_df_tiled(L or 1, x.shape[-2], x.shape[-1], omf.shape[-1],
                            Z.shape[-2], x.device)
    return apply_routed(_launch if fwd else df_pathwise._launch,
                        _launch_bwd if bwd else df_pathwise._launch_bwd, x,
                        operands, BASE_DIMS)


def df_pathwise_jacobian(x, omf, phf, G, Z, nur, ls2, var):
    """Per-row Jacobians (L, N, D, D) of the DF per-step eval at x (L, N,
    D), operands as :func:`df_pathwise_reference`'s with at most one
    leading dim of L draws. CPU tensors take the plain version
    (`df_pathwise.df_pathwise_jacobian_reference`); CUDA tensors launch
    the VJP kernel that `use_df_tiled` names for the rows the Jacobian
    takes, (L, N*D, D): #12 or #6, once (`pathwise.launch_jacobian`).
    Anything else raises."""
    operands = (omf, phf, G, Z, nur, ls2, var)
    if all(t.device.type == 'cpu' for t in (x,) + operands):
        return df_pathwise.df_pathwise_jacobian_reference(x, *operands)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    L, N, D = x.shape
    _, bwd = use_df_tiled(L, N * D, D, omf.shape[-1], Z.shape[-2], x.device)
    return launch_jacobian(_launch_bwd if bwd else df_pathwise._launch_bwd,
                           x, operands, D)
