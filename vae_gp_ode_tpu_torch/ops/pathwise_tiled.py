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
* `csrc/pathwise_bwd.cu` (#4): blocks of 128 contiguous feature columns
  of omega's (D, S*K) layout beside blocks of 128 inducing points of one
  output dim, a column or point per thread with 20 rows in registers, D in
  sub-tiles of 16, so that it takes any D up to 1,024 (#10's block holds
  D <= 65).
* `csrc/pathwise_tiled_fwd.cu` (#9): blocks of 20 rows, up to 32 output
  dims and a range of features (or of inducing points), each thread a
  20-row register tile of one output dim over contiguous columns; the
  blocks' partials are summed by a second kernel of the same library call.
* `csrc/pathwise_tiled_bwd.cu` (#10): blocks of 64 contiguous feature
  columns beside blocks of 64 inducing points of one output dim, all rows
  per block in tiles of 20, every D of an item in shared memory (D <= 65).

#4, #9 and #10 each sum what crosses their blocks in a second kernel of
the same library call, in a fixed order (the VJPs also over the draws of
a shared operand), without atomics, so the wrappers run no reduction;
each library exports the size of its workspace, and its launcher checks
the buffer it is given.

`pathwise_eval` is the per-step eval that `gp.svgp.fn_eval` calls: CPU
tensors take the plain version; CUDA tensors take the kernels that
`use_tiled` names for the shapes, decided before any launch.
"""

import ctypes

import torch

from vae_gp_ode_tpu_torch import ops
from vae_gp_ode_tpu_torch.ops import _build, library
from vae_gp_ode_tpu_torch.ops import pathwise
from vae_gp_ode_tpu_torch.ops.pathwise import (
    NAMES, VJP_ARGTYPES, VJP_WORKSPACE_ARGTYPES, _check, _check_tensors,
    _draws, _flat, apply_routed, launch_vjp, library_eval,
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
_ARGTYPES = [_P, _LL] * 8 + [_P, _LL, _P] + [_I] * 7 + [_P]
# -- the kernels --------------------------------------------------------------

def _lib():
    lib = _build.load('pathwise_tiled_fwd')
    if lib.pathwise_tiled_fwd.argtypes is None:
        lib.pathwise_tiled_fwd.argtypes = _ARGTYPES
        lib.pathwise_tiled_fwd.restype = ctypes.c_int
        lib.pathwise_tiled_fwd_workspace.argtypes = [_I] * 7
        lib.pathwise_tiled_fwd_workspace.restype = ctypes.c_longlong
        lib.pathwise_tiled_fwd_max_dim.argtypes = []
        lib.pathwise_tiled_fwd_max_dim.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = _build.load('pathwise_tiled_bwd')
    if lib.pathwise_tiled_bwd.argtypes is None:
        lib.pathwise_tiled_bwd.argtypes = VJP_ARGTYPES
        lib.pathwise_tiled_bwd.restype = ctypes.c_int
        lib.pathwise_tiled_bwd_workspace.argtypes = VJP_WORKSPACE_ARGTYPES
        lib.pathwise_tiled_bwd_workspace.restype = ctypes.c_longlong
        lib.pathwise_tiled_bwd_smem_bytes.argtypes = [_I]
        lib.pathwise_tiled_bwd_smem_bytes.restype = ctypes.c_longlong
        lib.pathwise_tiled_bwd_smem_optin.argtypes = [_I]
        lib.pathwise_tiled_bwd_smem_optin.restype = ctypes.c_int
    return lib


def _launch(x, operands):
    """Launch the tiled forward kernel and its sum; returns (L, N, K), the
    library's own output. Raises for a state dim D past the library's
    limit (`pathwise_tiled_fwd_max_dim`)."""
    _check_tensors(x.device, zip(('x',) + NAMES, (x,) + tuple(operands)))
    L, N, D, K, S, M, strides = _check(x, operands)
    lib = _lib()
    limit = lib.pathwise_tiled_fwd_max_dim()
    if D > limit:
        raise ValueError(f'{KERNEL} takes state dims up to {limit}, got '
                         f'D={D}')
    # the grid's layout, and so the partials' size, follows the SM count
    n_ws = lib.pathwise_tiled_fwd_workspace(
        L, N, D, K, S, M, ops.card_properties(x.device)[0])
    workspace = torch.empty(n_ws, dtype=torch.float32, device=x.device)
    out = torch.empty((L, N, K), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.pathwise_tiled_fwd(*_flat(x, operands, strides),
                                workspace.data_ptr(), n_ws, out.data_ptr(),
                                L, N, D, K, S, M, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f'{KERNEL} launch failed: CUDA error {rc} '
                           f'(L={L} N={N} D={D} K={K} S={S} M={M})')
    ops.count(KERNEL, (L, N, D, K, S, M))
    return out


def _launch_bwd(x, operands, g):
    """Launch the tiled VJP kernel #10 and its sums for the cotangent g
    (L, N, K); see `pathwise.launch_vjp`."""
    lib = _bwd_lib()
    return launch_vjp(BWD_KERNEL, lib.pathwise_tiled_bwd,
                      lib.pathwise_tiled_bwd_workspace, x, operands, g)


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

    The forward: both kernels are one call's host issue (~60-90 us on
    the sweep's host, #9's ~15 us more) plus a few to a few hundred
    microseconds of device time, #9 with the second kernel of its
    library call. Up to 16 state dims (the dims #3 keeps in registers)
    #3 takes a short feature list (S + M <= 768) in clusters of one
    block at any row count; a long list takes clusters of 8 blocks per
    (draw, row tile), which cost more than #9's grid once there are many
    rows: #9 takes S + M > 768 from L*N*K*(S + M) >= 8e6 row-feature
    products, where the sweep's calls favour it (1.4-2.2x at N = 600).
    Past 16 dims #3's time grows faster than D (0.07 ms a call at L=5,
    N=20 up to D = 32, 0.11 at 48, 0.54 at 72), and #9 takes the shapes
    with L*N*K*(S + M)*D^2 >= 2.5e9: in the sweep at D = 20, 24, 28, 32,
    48 and 72 (S = 256) that splits the cells #3 wins (N = 20 up to
    D = 48 at L = 1 and D = 32 at L = 5; N = 600 at L = 1 up to D = 20,
    0.065 against 0.080 ms) from those #9 wins (N = 600 at L = 5 from
    D = 20 and at L = 1 from D = 28; D = 48 at L = 5; D = 72), but for
    one near tie (D = 24, L = 1, N = 600: 0.073 against 0.075 ms).

    The VJP: #10 takes every shape whose block fits the shared memory
    (`tiled_bwd_smem_bytes`, D <= 65 at the H100's opt-in) up to 28
    state dims, and at one draw above: at N = 600 it was the faster call
    at L = 1 at every width the sweep has and at L = 5 up to D = 28 (11%
    at 28). #4 takes the rest: every state #10's block does not fit, and
    D > 28 at L > 1, where the sweep's calls favour it at N = 600 (35% at
    D = 32, 12% at 48). The N = 20 calls are host-bound, within 0-22%
    either way. Between 28 and 32 nothing is measured; the boundary sits
    at the last width where #10 won.
    """
    work = L * N * K * (S + M)
    if D > 16:
        fwd = work * D * D >= 2.5e9
    else:
        fwd = S + M > 768 and work >= 8e6
    bwd = tiled_bwd_smem_bytes(D) <= optin and (D <= 28 or L == 1)
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
    the shapes and, in reverse mode, the VJP kernel it names. Where no
    input needs a gradient the call is the registered operator
    `vae_gp_ode_torch::pathwise_eval_fwd` (`ops.library`), which applies
    the rule's forward choice on the shapes it is called with."""
    operands = (omega, phase, weights, Z, nu, ls, var)
    if not library.needs_grad((x,) + operands):
        return library_eval(library.pathwise_eval_fwd, x, operands,
                            pathwise._BASE_DIMS)
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


def pathwise_jacobian(x, omega, phase, weights, Z, nu, ls, var):
    """Per-row Jacobians (L, N, K, D) of the per-step eval at x (L, N, D),
    operands as :func:`pathwise_eval_reference`'s with at most one leading
    dim of L draws. CPU tensors take the plain version
    (`pathwise_jacobian_reference`); CUDA tensors launch the VJP kernel
    that `use_tiled` names for the rows the Jacobian takes, (L, N*K, D):
    #10, or #4, which raises for a D past `pathwise_bwd_max_dim`; once
    (`pathwise.launch_jacobian`). Anything else raises."""
    operands = (omega, phase, weights, Z, nu, ls, var)
    if all(t.device.type == 'cpu' for t in (x,) + operands):
        return pathwise.pathwise_jacobian_reference(x, *operands)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    L, N, D = x.shape
    (S, K), M = omega.shape[-2:], Z.shape[-2]
    _, bwd = use_tiled(L, N * K, D, K, S, M, x.device)
    return pathwise.launch_jacobian(
        _launch_bwd if bwd else pathwise._launch_bwd, x, operands, K)
