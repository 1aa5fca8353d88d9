"""Per-step pathwise evaluation of the divergence-free (DF) GP sample: one
CUDA kernel for the forward and one for its VJP (port of
`vae_gp_ode_tpu/ops/df_pathwise.py`).

    f(x) = [cos | sin](x @ omf + phf) @ G + K(x, Z) nu

with K the matrix-valued gram: for every output-dim pair (j, i) an RBF
envelope exp(-r^2 / (2 ls2[j, i])) times a Hessian-structure term
(`kernels.divfree.df_gram`). It is the right-hand side of every solver
but the fused euler trajectory with `--kernel DF` (`dynamics.solvers`,
through `gp.svgp.fn_eval`), and of the continuous adjoint's
vector-Jacobian products (`dynamics.adjoint`).

`fused_df_pathwise_eval` launches `csrc/df_pathwise_fwd.cu` (a cluster
of blocks per (draw, row tile), `csrc/df_cluster.cuh`) for CUDA tensors
inside a `torch.autograd.Function` whose backward launches
`csrc/df_pathwise_bwd.cu` (a cluster per (draw, tile of rows) that walks
its rows, and a second kernel of the same library call that sums the
per-tile slabs); CPU tensors take the plain version,
`df_pathwise_reference`, and autograd through it. Every operand may carry
a leading dim of L draws or be shared by all draws (one launch for all L);
cotangents of shared operands are summed over the draws by the library,
without atomics and without a PyTorch reduction after the call.
"""

import ctypes
import math

import torch

from vae_gp_ode_tpu_torch import ops
from vae_gp_ode_tpu_torch.ops import _build
from vae_gp_ode_tpu_torch.ops.pathwise import (
    _check_tensors, _flat, apply_routed,
)
from vae_gp_ode_tpu_torch.kernels.rbf import rbf_lengthscales, rbf_variance

KERNEL = 'df_pathwise_fwd'
SOURCE = 'vae_gp_ode_tpu_torch/csrc/df_pathwise_fwd.cu'
#: the TPU kernel this one replaces
REPLACES = 'vae_gp_ode_tpu/ops/df_pathwise.py:125'

BWD_KERNEL = 'df_pathwise_bwd'
BWD_SOURCE = 'vae_gp_ode_tpu_torch/csrc/df_pathwise_bwd.cu'
BWD_REPLACES = 'vae_gp_ode_tpu/ops/df_pathwise.py:273'

#: the widest state dim of the single-block pair and of the trajectory pair
#: (csrc/df_common.cuh kMaxD); the grid-tiled pair of
#: `ops.df_pathwise_tiled` takes any
MAX_D = 16

#: operand names after x, and the number of trailing (non-draw) dims of each
NAMES = ('omf', 'phf', 'G', 'Z', 'nur', 'ls2', 'var')
BASE_DIMS = (2, 2, 2, 2, 2, 2, 1)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_ARGTYPES = [_P, _LL] * 8 + [_P] + [_I] * 6 + [_P]
_BWD_ARGTYPES = [_P, _LL] * 8 + [_P] * 4 + [_I] * 6 + [_P]


def df_pathwise_reference(x, omf, phf, G, Z, nur, ls2, var):
    """DF prior + matrix-valued pathwise update, the plain version.

    x (..., N, D); omf (..., D, S*D) = omega reshaped; phf (..., 1, S*D);
    G (..., 2*S*D, D) from `df_orff_contraction`; Z (..., M, D); nur
    (..., M, D) = nu reshaped points-major; ls2 (..., D, D) =
    lengthscales**2; var (..., D). The leading dims (draws) broadcast.
    Returns (..., N, D), as `kernels.divfree.df_rff_eval(..., G=G) +
    df_f_update(...)`.
    """
    D = x.shape[-1]
    xo = x @ omf + phf                                    # (..., N, SD)
    trig = torch.cat([torch.cos(xo), torch.sin(xo)], dim=-1)
    f_prior = trig @ G                                    # (..., N, D)

    sq = (torch.sum(x * x, dim=-1)[..., :, None]
          + torch.sum(Z * Z, dim=-1)[..., None, :]
          - 2.0 * x @ Z.transpose(-1, -2))                # (..., N, M)
    d = (x[..., :, None, :] - Z[..., None, :, :]).movedim(-1, -3)
    inv = 1.0 / ls2                                       # (..., D, D) [j, i]
    inv4 = inv[..., :, :, None, None]
    sq4 = sq[..., None, None, :, :]
    E = torch.exp(-0.5 * sq4 * inv4)                      # (..., D, D, N, M)
    eye = torch.eye(D, dtype=x.dtype, device=x.device)[:, :, None, None]
    base = (d[..., :, None, :, :] * d[..., None, :, :, :] * inv4
            + ((D - 1.0) - sq4 * inv4) * eye)
    coef = (var[..., None, :] * inv)[..., :, :, None, None]
    nu_j = nur.transpose(-1, -2)[..., :, None, None, :]   # (..., D, 1, 1, M)
    f_up = torch.sum(E * base * coef * nu_j, dim=(-4, -1))  # (..., D_i, N)
    return f_prior + f_up.transpose(-1, -2)


def df_pathwise_vjp_reference(x, omf, phf, G, Z, nur, ls2, var, g):
    """Plain version of the backward kernel: autograd through
    :func:`df_pathwise_reference` with cotangent g. Returns the cotangents
    of (x, omf, phf, G, Z, nur, ls2, var), each in its operand's shape."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (
            x, omf, phf, G, Z, nur, ls2, var)]
        out = df_pathwise_reference(*inputs)
        return torch.autograd.grad(out, inputs, g)


def pack_df_operands(omega, phase, G, Z, nu, ls, var):
    """The DF kernels' operand block (omf, phf, G, Z, nur, ls2, var) from a
    sample's omega (..., D, S, D), phase (..., 1, S, D), G, nu (..., M*D, 1)
    and the GP's Z, lengthscales and variances: the (S, D) ORFF axes
    flattened to (D, S*D) / (1, S*D), nu points-major (M, D), ls squared.
    Leading dims (draws) are kept."""
    D, S = omega.shape[-3], omega.shape[-2]
    return (omega.reshape(omega.shape[:-3] + (D, S * D)),
            phase.reshape(phase.shape[:-3] + (1, S * D)), G, Z,
            nu.reshape(nu.shape[:-2] + (-1, D)), ls * ls, var)


def df_fused_operands(gp, sample):
    """`pack_df_operands` of a DF GP and its sample(s), the operands of the
    per-step eval and of the whole-trajectory flow."""
    return pack_df_operands(sample.rff.omega, sample.rff.phase, sample.df_G,
                            gp.inducing_loc, sample.nu,
                            rbf_lengthscales(gp.kernel),
                            rbf_variance(gp.kernel))


# -- the kernels --------------------------------------------------------------

def check_operands(L, D, operands, max_d=MAX_D):
    """Validate the DF operands, each (base shape) or (L, base shape),
    against L draws and state dim D, at most `max_d` (the widest the
    kernel takes; None for any). Returns (SD, M, draw strides)."""
    SD = operands[0].shape[-1]
    M = operands[3].shape[-2]
    base = ((D, SD), (1, SD), (2 * SD, D), (M, D), (M, D), (D, D), (D,))
    strides = []
    for name, t, shape, nd in zip(NAMES, operands, base, BASE_DIMS):
        if tuple(t.shape[-nd:]) != shape or t.dim() not in (nd, nd + 1) or (
                t.dim() == nd + 1 and t.shape[0] != L):
            raise ValueError(f'{name} has shape {tuple(t.shape)}, expected '
                             f'([{L},] {", ".join(map(str, shape))})')
        strides.append(t[0].numel() if t.dim() == nd + 1 else 0)
    if max_d is not None and D > max_d:
        raise NotImplementedError(
            f'this DF kernel takes state dims up to {max_d}, got {D}')
    return SD, M, strides


def _lib():
    lib = _build.load('df_pathwise_fwd')
    if lib.df_pathwise_fwd.argtypes is None:
        lib.df_pathwise_fwd.argtypes = _ARGTYPES
        lib.df_pathwise_fwd.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = _build.load('df_pathwise_bwd')
    if lib.df_pathwise_bwd.argtypes is None:
        lib.df_pathwise_bwd.argtypes = _BWD_ARGTYPES
        lib.df_pathwise_bwd.restype = ctypes.c_int
        lib.df_pathwise_bwd_slab_floats.argtypes = [_I] * 3
        lib.df_pathwise_bwd_slab_floats.restype = ctypes.c_longlong
        lib.df_pathwise_bwd_plan.argtypes = [_I] * 6 + [_P]
        lib.df_pathwise_bwd_plan.restype = ctypes.c_int
    return lib


def bwd_plan(L, N, D, SD, M, device):
    """(rows per pass, blocks per cluster, rows per tile, row tiles per
    draw, items per chunk) of the VJP kernel at these shapes on `device`
    (csrc/df_cluster.cuh `walk_plan_for`, and the items of a block that
    its shared memory holds at once). Raises for shapes it refuses."""
    out = (ctypes.c_int * 5)()
    rc = _bwd_lib().df_pathwise_bwd_plan(L, N, D, SD, M,
                                         ops.device_index(device), out)
    if rc != 0:
        raise RuntimeError(f'{BWD_KERNEL} takes no plan at L={L} N={N} '
                           f'D={D} SD={SD} M={M}: CUDA error {rc}')
    return tuple(out)


def _check_x(x):
    if x.dim() != 3:
        raise ValueError(f'x has shape {tuple(x.shape)}, expected (L, N, D)')
    return x.shape


def _launch(x, operands):
    """Launch the forward kernel; returns (L, N, D)."""
    _check_tensors(x.device, zip(('x',) + NAMES, (x,) + tuple(operands)))
    L, N, D = _check_x(x)
    SD, M, strides = check_operands(L, D, operands)
    out = torch.empty((L, N, D), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().df_pathwise_fwd(*_flat(x, operands, strides),
                                out.data_ptr(), L, N, D, SD, M,
                                x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f'{KERNEL} launch failed: CUDA error {rc} '
                           f'(L={L} N={N} D={D} SD={SD} M={M})')
    ops.count(KERNEL, (L, N, D, SD, M))
    return out


def _launch_bwd(x, operands, g):
    """Launch the VJP kernel for the cotangent g (L, N, D). Returns dx
    (L, N, D) and the operands' cotangents, each in its operand's shape,
    all finished by the library's second kernel."""
    _check_tensors(x.device, zip(('x',) + NAMES + ('g',),
                                 (x,) + tuple(operands) + (g,)))
    L, N, D = _check_x(x)
    SD, M, strides = check_operands(L, D, operands)
    if tuple(g.shape) != (L, N, D):
        raise ValueError(f'g has shape {tuple(g.shape)}, expected '
                         f'({L}, {N}, {D})')
    lib = _bwd_lib()
    n_tiles = bwd_plan(L, N, D, SD, M, x.device)[3]   # raises if refused
    P = lib.df_pathwise_bwd_slab_floats(D, SD, M)
    dx = torch.empty((L, N, D), dtype=torch.float32, device=x.device)
    work = torch.empty(L * n_tiles * P, dtype=torch.float32,
                       device=x.device)
    shapes = [tuple(t.shape) for t in operands]
    sizes = [math.prod(shape) for shape in shapes]
    out = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.df_pathwise_bwd(*_flat(x, operands, strides), g.data_ptr(),
                             dx.data_ptr(), work.data_ptr(), out.data_ptr(),
                             L, N, D, SD, M, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f'{BWD_KERNEL} launch failed: CUDA error {rc} '
                           f'(L={L} N={N} D={D} SD={SD} M={M})')
    ops.count(BWD_KERNEL, (L, N, D, SD, M))
    return (dx,) + tuple(part.view(shape)
                         for part, shape in zip(out.split(sizes), shapes))


def fused_df_pathwise_eval(x, omf, phf, G, Z, nur, ls2, var):
    """Per-step DF eval; same arguments and result as
    :func:`df_pathwise_reference` with at most one leading dim of L draws.
    Differentiable in every argument.

    CUDA tensors launch the forward kernel, and reverse mode launches the
    VJP kernel; CPU tensors take the plain version and autograd through
    it. Anything else raises.
    """
    operands = (omf, phf, G, Z, nur, ls2, var)
    if all(t.device.type == 'cpu' for t in (x,) + operands):
        return df_pathwise_reference(x, *operands)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    return apply_routed(_launch, _launch_bwd, x, operands, BASE_DIMS)
