"""Per-step pathwise GP evaluation of the dimwise-RBF sample: one CUDA
kernel for the forward and one for its VJP (port of
`vae_gp_ode_tpu/ops/pathwise.py`).

    f_k(x) = sqrt(var_k/S) sum_s cos(x . omega[:, s, k] + phase[s, k]) w[s, k]
           + var_k sum_m exp(-0.5 |(x - Z_m) / ls_k|^2) nu[k, m]

It is the right-hand side of every solver but the fused euler trajectory
(`dynamics.solvers`, through `gp.svgp.fn_eval`) and of the continuous
adjoint's vector-Jacobian products (`dynamics.adjoint`).

`fused_pathwise_eval` launches `csrc/pathwise_fwd.cu` for CUDA tensors
inside a `torch.autograd.Function` whose backward launches
`csrc/pathwise_bwd.cu`; CPU tensors take the plain version,
`pathwise_eval_reference`, and autograd through it. Every operand may
carry a leading dim of L draws or be shared by all draws (one launch for
all L, as the JAX package's vmap over `pallas_call`); the forward's
blocks sum their partials within a thread-block cluster, and the VJP's
library call sums its blocks' terms (and the cotangents of shared
operands over the draws) in a second kernel, both in a fixed order,
without atomics, so the wrapper runs no reduction.

The per-row Jacobians of bdf's Newton iterations come from one launch of
a VJP kernel on rows repeated once per output and one-hot cotangents
(`jacobian_rows`, `launch_jacobian`; the operators `pathwise_eval_jac`
and `df_pathwise_eval_jac` of `ops.library`).
"""

import ctypes
import itertools
import math

import torch

from vae_gp_ode_tpu_torch import ops
from vae_gp_ode_tpu_torch.ops import _build, library
from vae_gp_ode_tpu_torch.kernels.rbf import rbf_lengthscales, rbf_variance

KERNEL = 'pathwise_fwd'
SOURCE = 'vae_gp_ode_tpu_torch/csrc/pathwise_fwd.cu'
#: the TPU kernel this one replaces
REPLACES = 'vae_gp_ode_tpu/ops/pathwise.py:51'

BWD_KERNEL = 'pathwise_bwd'
BWD_SOURCE = 'vae_gp_ode_tpu_torch/csrc/pathwise_bwd.cu'
BWD_REPLACES = 'vae_gp_ode_tpu/ops/pathwise.py:132'

#: operand names after x, and the number of trailing (non-draw) dims of each
NAMES = ('omega', 'phase', 'weights', 'Z', 'nu', 'ls', 'var')
_BASE_DIMS = (3, 3, 2, 2, 2, 2, 1)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_ARGTYPES = [_P, _LL] * 8 + [_P] + [_I] * 7 + [_P]
#: a VJP library's launcher: operands, g, workspace and its size, the eight
#: outputs, the shapes, device and stream
VJP_ARGTYPES = [_P, _LL] * 8 + [_P, _P, _LL] + [_P] * 8 + [_I] * 7 + [_P]
#: a VJP library's workspace size: shapes, then the draw strides of omega,
#: phase, weights and nu
VJP_WORKSPACE_ARGTYPES = [_I] * 6 + [_LL] * 4


def pathwise_eval_reference(x, omega, phase, weights, Z, nu, ls, var):
    """Dimwise-RBF prior + pathwise update, the plain version.

    Shapes: x (..., N, D), omega (..., D, S, K), phase (..., 1, S, K),
    weights (..., S, K), Z (..., M, D), nu (..., K, M), ls (..., K, D),
    var (..., K); the leading dims (draws) broadcast, and Z, ls and var
    are usually shared by all draws. Returns (..., N, K). Keeps the
    sqrt(var/S) prior scaling quirk.
    """
    D, S, K = omega.shape[-3:]
    xo = x @ omega.reshape(omega.shape[:-3] + (D, S * K))
    xo = xo.reshape(xo.shape[:-1] + (S, K))                 # (..., N, S, K)
    phi = torch.cos(xo + phase) * torch.sqrt(var / S)[..., None, None, :]
    f_prior = torch.sum(phi * weights[..., None, :, :], dim=-2)

    Xd = x[..., None, :, :] / ls[..., :, None, :]           # (..., K, N, D)
    Zd = Z[..., None, :, :] / ls[..., :, None, :]           # (..., K, M, D)
    xn = torch.sum(Xd * Xd, dim=-1)                         # (..., K, N)
    zn = torch.sum(Zd * Zd, dim=-1)                         # (..., K, M)
    cross = Zd @ Xd.transpose(-1, -2)                       # (..., K, M, N)
    sq = zn[..., :, :, None] + xn[..., None, :] - 2.0 * cross
    Kuf = var[..., :, None, None] * torch.exp(-0.5 * sq)    # (..., K, M, N)
    f_up = (nu[..., None, :] @ Kuf)[..., 0, :]              # (..., K, N)
    return f_prior + f_up.transpose(-1, -2)


def pathwise_vjp_reference(x, omega, phase, weights, Z, nu, ls, var, g):
    """Plain version of the backward kernel: autograd through
    :func:`pathwise_eval_reference` with cotangent g. Returns the
    cotangents of (x, omega, phase, weights, Z, nu, ls, var), each in its
    operand's shape (summed over the draws an operand is shared by)."""
    # identity saved-tensor hooks: inside a checkpointed step (bdf's
    # Newton Jacobians on the CPU) this graph keeps its own tensors
    # instead of the checkpoint's placeholders
    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
            lambda t: t, lambda t: t):
        inputs = [t.detach().requires_grad_() for t in (
            x, omega, phase, weights, Z, nu, ls, var)]
        out = pathwise_eval_reference(*inputs)
        return torch.autograd.grad(out, inputs, g)


def jacobian_rows(x, K):
    """The rows and cotangents that turn one VJP of an eval with K outputs
    into its per-row Jacobians, as the JAX package's vmap(jacrev) does:
    x (..., N, D) -> x' (..., N*K, D), each row repeated K times, and g'
    (..., N*K, K), whose row (n, k) is the unit vector e_k; both
    contiguous, as the kernels read them (at N = 1 the reshape alone would
    be a view with a zero stride)."""
    lead, (N, D) = tuple(x.shape[:-2]), x.shape[-2:]
    xr = x[..., None, :].expand(lead + (N, K, D)).reshape(
        lead + (N * K, D)).contiguous()
    g = torch.eye(K, dtype=x.dtype, device=x.device).repeat(N, 1)
    return xr, g.expand(lead + (N * K, K)).contiguous()


def pathwise_jacobian_reference(x, omega, phase, weights, Z, nu, ls, var):
    """Plain version of the Jacobian operator: the per-row Jacobians
    (..., N, K, D), [n, k, j] = d f_k(x_n) / d x_nj, of
    :func:`pathwise_eval_reference`, from one :func:`pathwise_vjp_reference`
    on the rows and cotangents of `jacobian_rows`."""
    K, (N, D) = omega.shape[-1], x.shape[-2:]
    xr, g = jacobian_rows(x, K)
    dx = pathwise_vjp_reference(xr, omega, phase, weights, Z, nu, ls, var,
                                g)[0]
    return dx.reshape(tuple(dx.shape[:-2]) + (N, K, D))


def rbf_fused_operands(gp, sample):
    """The fused-RBF operand block (omega, phase, weights, Z, nu, ls, var)
    shared by the per-step eval and the whole-trajectory flow; draw
    operands keep the sample's leading batch of draws. A shared-
    lengthscale sample becomes the dimwise block here (`dimwise_block`)."""
    return dimwise_block(
        sample.rff.omega, sample.rff.phase, sample.rff.weights,
        gp.inducing_loc, sample.nu, rbf_lengthscales(gp.kernel),
        rbf_variance(gp.kernel), gp.kernel.dimwise)


def dimwise_block(omega, phase, weights, Z, nu, ls, var, dimwise):
    """The kernels' operand block from a sample's leaves and the
    constrained lengthscales and variance, each with or without a leading
    dim of draws. Dimwise leaves pass through (nu (..., K, M, 1) loses its
    last dim). A shared-lengthscale sample is a dimwise one whose K output
    dims share one set of frequencies, one phase row, one lengthscale
    vector and one variance, so these are repeated over K:

        omega (..., D, S) -> (..., D, S, K)    nu (..., M, K) -> (..., K, M)
        phase (..., 1, S) -> (..., 1, S, K)    ls (..., D)    -> (..., K, D)
        var (..., 1)      -> (..., K)

    as contiguous copies (the kernels read dense operands); autograd sums
    the copies' cotangents back over K."""
    if dimwise:
        return omega, phase, weights, Z, nu[..., 0], ls, var
    K = weights.shape[-1]

    def over_k(t):
        return t[..., None].expand(t.shape + (K,)).contiguous()

    return (over_k(omega), over_k(phase), weights, Z,
            nu.transpose(-1, -2).contiguous(),
            over_k(ls).transpose(-1, -2).contiguous(),
            var.expand(var.shape[:-1] + (K,)).contiguous())


# -- the kernels --------------------------------------------------------------

def _check(x, operands):
    """Validate x (L, N, D) and the operands, each (base shape) or
    (L, base shape). Returns (L, N, D, K, S, M, draw strides)."""
    if x.dim() != 3:
        raise ValueError(f'x has shape {tuple(x.shape)}, expected (L, N, D)')
    L, N, D = x.shape
    omega = operands[0]
    S, K = omega.shape[-2:]
    M = operands[3].shape[-2]
    base = ((D, S, K), (1, S, K), (S, K), (M, D), (K, M), (K, D), (K,))
    strides = []
    for name, t, shape, nd in zip(NAMES, operands, base, _BASE_DIMS):
        if tuple(t.shape[-nd:]) != shape or t.dim() not in (nd, nd + 1) or (
                t.dim() == nd + 1 and t.shape[0] != L):
            raise ValueError(f'{name} has shape {tuple(t.shape)}, expected '
                             f'([{L},] {", ".join(map(str, shape))})')
        strides.append(t[0].numel() if t.dim() == nd + 1 else 0)
    return L, N, D, K, S, M, strides


def _check_tensors(device, named):
    for name, t in named:
        if t.device != device:
            raise ValueError(f'{name} is on {t.device}, x on {device}')
        if t.dtype != torch.float32:
            raise TypeError(f'{name} must be float32, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')


def _lib():
    lib = _build.load('pathwise_fwd')
    if lib.pathwise_fwd.argtypes is None:
        lib.pathwise_fwd.argtypes = _ARGTYPES
        lib.pathwise_fwd.restype = ctypes.c_int
        lib.pathwise_fwd_empty.argtypes = [_I, _P]
        lib.pathwise_fwd_empty.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = _build.load('pathwise_bwd')
    if lib.pathwise_bwd.argtypes is None:
        lib.pathwise_bwd.argtypes = VJP_ARGTYPES
        lib.pathwise_bwd.restype = ctypes.c_int
        lib.pathwise_bwd_workspace.argtypes = VJP_WORKSPACE_ARGTYPES
        lib.pathwise_bwd_workspace.restype = ctypes.c_longlong
        lib.pathwise_bwd_max_dim.argtypes = []
        lib.pathwise_bwd_max_dim.restype = ctypes.c_int
    return lib


def _flat(x, operands, strides):
    flat = [x.data_ptr(), x[0].numel()]
    for t, ls in zip(operands, strides):
        flat += [t.data_ptr(), ls]
    return flat


def _launch(x, operands):
    """Launch the forward kernel; returns (L, N, K)."""
    _check_tensors(x.device, zip(('x',) + NAMES, (x,) + tuple(operands)))
    L, N, D, K, S, M, strides = _check(x, operands)
    out = torch.empty((L, N, K), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().pathwise_fwd(*_flat(x, operands, strides), out.data_ptr(),
                             L, N, D, K, S, M, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f'{KERNEL} launch failed: CUDA error {rc} '
                           f'(L={L} N={N} D={D} K={K} S={S} M={M})')
    ops.count(KERNEL, (L, N, D, K, S, M))
    return out


def launch_vjp(name, launcher, workspace_floats, x, operands, g):
    """Launch a VJP library call (`launcher`, sized by `workspace_floats`:
    #4 or #10) for the cotangent g (L, N, K) and count it as kernel `name`.
    Returns dx (L, N, D) and the operands' cotangents, each in its
    operand's shape (summed by the library over the draws an operand is
    shared by): the library's own outputs, with no reduction after it."""
    _check_tensors(x.device, zip(('x',) + NAMES + ('g',),
                                 (x,) + tuple(operands) + (g,)))
    L, N, D, K, S, M, strides = _check(x, operands)
    if tuple(g.shape) != (L, N, K):
        raise ValueError(f'g has shape {tuple(g.shape)}, expected '
                         f'({L}, {N}, {K})')
    om, ph, w, _, nu, _, _ = strides
    n_ws = workspace_floats(L, N, D, K, S, M, om, ph, w, nu)
    workspace = torch.empty(n_ws, dtype=torch.float32, device=x.device)
    shapes = [(L, N, D)] + [tuple(t.shape) for t in operands]
    sizes = [math.prod(shape) for shape in shapes]
    out = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    offsets = itertools.accumulate([0] + sizes[:-1])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = launcher(*_flat(x, operands, strides), g.data_ptr(),
                  workspace.data_ptr(), n_ws,
                  *(out.data_ptr() + 4 * o for o in offsets), L, N, D, K, S,
                  M, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f'{name} launch failed: CUDA error {rc} '
                           f'(L={L} N={N} D={D} K={K} S={S} M={M})')
    ops.count(name, (L, N, D, K, S, M))
    return tuple(part.view(shape)
                 for part, shape in zip(out.split(sizes), shapes))


def launch_jacobian(launch_bwd, x, operands, K):
    """Per-row Jacobians (L, N, K, D) of a per-step eval with K outputs at
    x (L, N, D) from one launch of a VJP kernel (`launch_bwd`, a family's
    `_launch_bwd`: #4, #6, #10 or #12) on the rows and cotangents of
    `jacobian_rows`: its dx (L, N*K, D) holds row n's d f_k / d x at row
    (n, k). The operands' cotangents, which the launch sums as well, are
    dropped."""
    L, N, D = x.shape
    xr, g = jacobian_rows(x, K)
    return launch_bwd(xr, operands, g)[0].view(L, N, K, D)


def _launch_bwd(x, operands, g):
    """Launch the VJP kernel #4 and its sums for the cotangent g (L, N,
    K); see `launch_vjp`. Raises for a state dim D past the library's
    limit (`pathwise_bwd_max_dim`)."""
    lib = _bwd_lib()
    limit = lib.pathwise_bwd_max_dim()
    if x.shape[-1] > limit:
        raise ValueError(f'{BWD_KERNEL} takes state dims up to {limit}, got '
                         f'D={x.shape[-1]}')
    return launch_vjp(BWD_KERNEL, lib.pathwise_bwd, lib.pathwise_bwd_workspace,
                      x, operands, g)


def _draws(x, operands, base_dims=_BASE_DIMS):
    """The number of draws L of a call (None when no tensor has a draw
    dim); raises unless every tensor has no draw dim or one of size L."""
    leads = [tuple(x.shape[:-2])] + [
        tuple(t.shape[:-nd]) for t, nd in zip(operands, base_dims)]
    sizes = {lead for lead in leads if lead}
    if any(len(lead) > 1 for lead in sizes) or len(sizes) > 1:
        raise ValueError(f'the kernel takes one leading dim of draws, shared '
                         f'by all operands that have one; got {leads}')
    return sizes.pop()[0] if sizes else None


def fused_pathwise_eval(x, omega, phase, weights, Z, nu, ls, var):
    """Per-step pathwise eval; same arguments and result as
    :func:`pathwise_eval_reference` with at most one leading dim of L
    draws. Differentiable in every argument.

    CUDA tensors launch the forward kernel, and reverse mode launches the
    VJP kernel; CPU tensors take the plain version and autograd through
    it. Anything else raises.
    """
    operands = (omega, phase, weights, Z, nu, ls, var)
    if all(t.device.type == 'cpu' for t in (x,) + operands):
        return pathwise_eval_reference(x, *operands)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    return apply_routed(_launch, _launch_bwd, x, operands, _BASE_DIMS)


class RoutedEval(torch.autograd.Function):
    """A per-step eval whose forward is `launch(x, operands)` and whose
    backward is `launch_bwd(x, operands, g)`: any forward kernel of a
    family with any VJP kernel of it (the single-block pair here, the
    grid-tiled one of `ops.pathwise_tiled`), since they compute the same
    function."""

    @staticmethod
    def forward(ctx, launch, launch_bwd, x, *operands):
        out = launch(x, operands)
        ctx.launch_bwd = launch_bwd
        ctx.save_for_backward(x, *operands)
        return out

    @staticmethod
    def backward(ctx, g):
        x, *operands = ctx.saved_tensors
        grads = ctx.launch_bwd(x, operands, g.contiguous())
        return (None, None) + tuple(
            gr if need else None
            for gr, need in zip(grads, ctx.needs_input_grad[2:]))


def library_eval(op, x, operands, base_dims):
    """The forward-only operator `op` of `ops.library` (a per-step eval)
    on x (..., N, D) and operands with at most one leading dim of L draws,
    broadcast and dropped as `apply_routed` does."""
    library.check_devices((x,) + tuple(operands))
    L = _draws(x, operands, base_dims)
    x3 = x.expand((L or 1,) + tuple(x.shape[-2:])).contiguous()
    out = op(x3, *(t.contiguous() for t in operands))
    return out if L is not None else out[0]


def library_jacobian(op, x, operands, base_dims):
    """`library_eval` of a Jacobian operator of `ops.library` on x and
    operands detached: the Newton iterations' Jacobian is a constant of
    reverse mode."""
    return library_eval(op, x.detach(), [t.detach() for t in operands],
                        base_dims)


def apply_routed(launch, launch_bwd, x, operands, base_dims):
    """RoutedEval on x (..., N, D) and operands with at most one leading
    dim of L draws (`base_dims`: each operand's trailing dims): x is
    broadcast to (L, N, D), and the draw dim dropped again where no tensor
    had one."""
    L = _draws(x, operands, base_dims)
    x3 = x.expand((L or 1,) + tuple(x.shape[-2:])).contiguous()
    out = RoutedEval.apply(launch, launch_bwd, x3,
                           *(t.contiguous() for t in operands))
    return out if L is not None else out[0]

