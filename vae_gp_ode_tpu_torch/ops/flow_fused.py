"""Whole euler trajectory of the dimwise-RBF pathwise GP sample in one
CUDA kernel, and its discrete adjoint in another (port of
`vae_gp_ode_tpu/ops/flow_fused.py`).

The per-output-dim operands are packed k-major (`_pack_operands`) so each
euler step is five products on flat operands:

    xo    = z @ omf                          (N, K*S)  feature projection
    f1    = block-sum_S(cos(xo + phf) * ws)  (N, K)
    cross = z @ Zb                           (N, K*M)
    xn    = (z*z) @ il2                      (N, K*M)
    f2    = block-sum_M(exp(-0.5 (xn + zn - 2 cross)) * nus)   (N, K)

Orders 1 (dz = f(z)) and 2 (d(s, v) = (v, f(s, v))) and per-interval step
sizes dts (T-1,) are supported. Every operand may carry a leading dim of
L draws (or be shared by all draws): one launch integrates all L
Monte-Carlo trajectories, as the JAX package's vmap over `pallas_call`
does.

`packed_euler_flow` launches `csrc/flow_fused.cu` (a cluster of blocks
per (draw, row tile) that walks the T-1 steps, one cluster sum of f a
step) for CUDA tensors inside a `torch.autograd.Function` whose backward
launches `csrc/flow_fused_bwd.cu` (`packed_flow_vjp`): a cluster of
blocks per (draw, row tile) on the same plan, each block with its share
of the feature and inducing columns and their cotangents in shared
memory, and a second kernel of the same library call that sums the slabs
into the finished cotangents (no PyTorch reduction after the call). Both
share `csrc/flow_cluster.cuh`. CPU tensors take the plain versions,
`packed_flow_reference` and autograd through it
(`packed_flow_vjp_reference`). `fused_pair_fits` decides from the shapes,
before any launch, whether the pair takes a flow.
"""

import ctypes
import math

import torch

from vae_gp_ode_tpu_torch import ops
from vae_gp_ode_tpu_torch.ops import _build
from vae_gp_ode_tpu_torch.ops.pathwise import pathwise_eval_reference

KERNEL = 'flow_fused_fwd'
SOURCE = 'vae_gp_ode_tpu_torch/csrc/flow_fused.cu'
#: the TPU kernel this one replaces
REPLACES = 'vae_gp_ode_tpu/ops/flow_fused.py:116'

BWD_KERNEL = 'flow_fused_bwd'
BWD_SOURCE = 'vae_gp_ode_tpu_torch/csrc/flow_fused_bwd.cu'
BWD_REPLACES = 'vae_gp_ode_tpu/ops/flow_fused.py:284'
#: both kernels keep per-row partials in registers up to this D
BWD_MAX_D = 16

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_ARGTYPES = ([_P, _LL] * 8 + [_P, _P] + [_I] * 9 + [_P])
_BWD_ARGTYPES = ([_P, _P] + [_P, _LL] * 7 + [_P, _P, _P] + [_I] * 10
                 + [_P])

_NAMES = ('omf', 'phf', 'ws', 'Zb', 'zn', 'il2', 'nus')


def euler_flow_reference(z0, omega, phase, weights, Z, nu, ls, var, dt,
                         T, order=1):
    """Plain euler trajectory through the dimwise-RBF pathwise sample(s).

    Returns zs (..., T, N, D) with zs[..., 0, :, :] = z0.
    """
    q = var.shape[0]

    def rhs(z):
        f = pathwise_eval_reference(z, omega, phase, weights, Z, nu, ls,
                                    var)
        if order == 2:
            return torch.cat([z[..., q:], f], dim=-1)
        return f

    dts = torch.as_tensor(dt, dtype=z0.dtype,
                          device=z0.device).expand(T - 1)
    zs = [z0]
    for t in range(T - 1):
        zs.append(zs[-1] + dts[t] * rhs(zs[-1]))
    lead = torch.broadcast_shapes(*(z.shape[:-2] for z in zs))
    return torch.stack([z.expand(lead + z0.shape[-2:]) for z in zs], dim=-3)


def _pack_operands(omega, phase, weights, Z, nu, ls, var):
    """Flatten the per-output-dim operands k-major. Draw operands keep
    their leading dims; Zb, zn and il2 depend on the GP only and are
    shared by all draws. Every output is contiguous."""
    D, S, K = omega.shape[-3:]
    M = Z.shape[0]
    # column k*S+s <- omega[:, s, k]
    omf = omega.transpose(-1, -2).reshape(omega.shape[:-3] + (D, K * S))
    phf = phase[..., 0, :, :].transpose(-1, -2).reshape(
        phase.shape[:-3] + (1, K * S))
    # sqrt(var_k/S) folded into the feature weights
    ws = (weights * torch.sqrt(var / S)).transpose(-1, -2).reshape(
        weights.shape[:-2] + (1, K * S))
    # column k*M+m <- Z[m, :] / ls[k, :]^2
    inv_ls2 = 1.0 / (ls * ls)                                     # (K, D)
    Zb = (Z[None, :, :] * inv_ls2[:, None, :]).reshape(K * M, D).T
    zn = torch.sum((Z[None, :, :] / ls[:, None, :]) ** 2,
                   dim=2).reshape(1, K * M)
    il2 = inv_ls2[:, None, :].expand(K, M, D).reshape(K * M, D).T  # (D, KM)
    nus = (nu * var[:, None]).reshape(nu.shape[:-2] + (1, K * M))
    return tuple(x.contiguous() for x in (omf, phf, ws, Zb, zn, il2, nus))


def packed_flow_reference(z0, omf, phf, ws, Zb, zn, il2, nus, dts, T,
                          order=1):
    """Plain PyTorch version of the trajectory kernel: a loop over steps.

    Operands as in :func:`packed_euler_flow`; returns zs (..., T, N, D).
    """
    D = z0.shape[-1]
    K = D // 2 if order == 2 else D
    S = ws.shape[-1] // K
    M = nus.shape[-1] // K

    def feval(z):
        xo = z @ omf
        phi = torch.cos(xo + phf) * ws
        f1 = phi.reshape(phi.shape[:-1] + (K, S)).sum(dim=-1)
        cross = z @ Zb
        xn = (z * z) @ il2
        G = torch.exp(-0.5 * (xn + zn - 2.0 * cross)) * nus
        f2 = G.reshape(G.shape[:-1] + (K, M)).sum(dim=-1)
        return f1 + f2

    def rhs(z):
        f = feval(z)
        if order == 2:
            return torch.cat([z[..., K:], f], dim=-1)
        return f

    lead = torch.broadcast_shapes(*(x.shape[:-2] for x in (
        z0, omf, phf, ws, Zb, zn, il2, nus)))
    z = z0.expand(lead + z0.shape[-2:])
    dts = torch.as_tensor(dts, dtype=z0.dtype,
                          device=z0.device).expand(T - 1)
    zs = [z]
    for t in range(T - 1):
        z = z + dts[t] * rhs(z)
        zs.append(z)
    return torch.stack(zs, dim=-3)


def packed_flow_vjp_reference(zs, zsbar, omf, phf, ws, Zb, zn, il2, nus,
                              dts, T, order=1):
    """Plain version of the backward kernel: autograd through
    :func:`packed_flow_reference` from z0 = zs[..., 0, :, :].

    Returns (z0bar, omfbar, phfbar, wsbar, Zbbar, znbar, il2bar, nusbar,
    dtsbar): z0bar in zs[..., 0, :, :]'s shape (one per draw), the others
    in their operands' shapes (summed over the draws an operand is shared
    by).
    """
    with torch.enable_grad():
        z0 = zs[..., 0, :, :].detach().requires_grad_()
        inputs = [z0] + [x.detach().requires_grad_() for x in (
            omf, phf, ws, Zb, zn, il2, nus, dts)]
        out = packed_flow_reference(*inputs, T, order)
        return torch.autograd.grad(out, inputs, zsbar)


def _check(z0_shape, operands, dts, T, order):
    """Validate packed operands against a state of shape z0_shape
    (..., N, D). Returns (L, N, D, K, S, M, draw strides)."""
    if order not in (1, 2):
        raise ValueError(f'ODE order must be 1 or 2, got {order}')
    N, D = z0_shape[-2:]
    K = D // order
    if K * order != D:
        raise ValueError(f'order {order} needs an even state dim, got {D}')
    omf, phf, ws, Zb, zn, il2, nus = operands
    if ws.shape[-1] % K or nus.shape[-1] % K:
        raise ValueError('ws/nus widths must be multiples of K')
    S, M = ws.shape[-1] // K, nus.shape[-1] // K
    base = {'omf': (D, K * S), 'phf': (1, K * S), 'ws': (1, K * S),
            'Zb': (D, K * M), 'zn': (1, K * M), 'il2': (D, K * M),
            'nus': (1, K * M)}
    lead = [x.shape[0] for x in operands if x.dim() == 3]
    L = max(lead + ([z0_shape[0]] if len(z0_shape) == 3 else []), default=1)
    strides = []
    for name, x in zip(_NAMES, operands):
        shape = tuple(x.shape[-2:])
        if shape != base[name] or x.dim() not in (2, 3) or (
                x.dim() == 3 and x.shape[0] not in (1, L)):
            raise ValueError(f'{name} has shape {tuple(x.shape)}, expected '
                             f'([L or 1,] {base[name][0]}, {base[name][1]})')
        strides.append(x[0].numel() if x.dim() == 3 and x.shape[0] == L
                       and L > 1 else 0)
    if tuple(dts.shape) != (T - 1,):
        raise ValueError(f'dts has shape {tuple(dts.shape)}, expected '
                         f'({T - 1},)')
    return L, N, D, K, S, M, strides


def _check_tensors(device, named):
    for name, x in named:
        if x.device != device:
            raise ValueError(f'{name} is on {x.device}, z0 on {device}')
        if x.dtype != torch.float32:
            raise TypeError(f'{name} must be float32, got {x.dtype}')
        if not x.is_contiguous():
            raise ValueError(f'{name} must be contiguous')


def _lib():
    lib = _build.load('flow_fused')
    if lib.flow_fused_fwd.argtypes is None:
        lib.flow_fused_fwd.argtypes = _ARGTYPES
        lib.flow_fused_fwd.restype = ctypes.c_int
        lib.flow_fused_fwd_plan.argtypes = [_I] * 8 + [_P]
        lib.flow_fused_fwd_plan.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = _build.load('flow_fused_bwd')
    if lib.flow_fused_bwd.argtypes is None:
        lib.flow_fused_bwd.argtypes = _BWD_ARGTYPES
        lib.flow_fused_bwd.restype = ctypes.c_int
        lib.flow_fused_bwd_slab_floats.argtypes = [_I] * 5
        lib.flow_fused_bwd_slab_floats.restype = ctypes.c_longlong
        lib.flow_fused_bwd_plan.argtypes = [_I] * 8 + [_P]
        lib.flow_fused_bwd_plan.restype = ctypes.c_int
        lib.flow_fused_bwd_smem_bytes.argtypes = [_I] * 5
        lib.flow_fused_bwd_smem_bytes.restype = ctypes.c_longlong
        lib.flow_fused_bwd_smem_optin.argtypes = [_I]
        lib.flow_fused_bwd_smem_optin.restype = ctypes.c_int
    return lib


def pair_fits(D, need_bytes, optin):
    """The dispatch rule of the fused pair: the trajectory kernel and its
    adjoint take a flow when the state dim is at most BWD_MAX_D and the
    rule's bound (`need_bytes`, csrc/flow_fused_bwd.cu
    `flow_fused_bwd_smem_bytes`) fits the device's opt-in shared memory
    per block (`optin`; negative when it could not be read).

    The bound is the shared memory one block of the adjoint's parent
    design took (512 threads, 4 rows and the whole slab of cotangents:
    4 (D K S + 2 K S + 2 D K M + 2 K M + T - 1 + 12 D + 16 (4 D + 1))
    bytes), kept until a sweep of the pair against the per-step kernels
    moves it (ROADMAP Queue B); it is never below the need of the new
    adjoint's block of an 8-block cluster, so the kernels take every shape
    it admits. On an H100 (232,448 bytes) it admits q = 6 up to S = 1024
    (the default run's S = 256: 84,700 bytes) and order 2 at q = 6, S =
    256; not S = 2048, q = 12 or D = 16 at S = 256."""
    return D <= BWD_MAX_D and 0 <= need_bytes <= optin


def fused_pair_fits(D, K, S, M, T, device):
    """`pair_fits` on `device` (a CUDA device), from the adjoint library's
    exported bound and the device's opt-in limit: decided from the shapes
    alone, before any launch."""
    lib = _bwd_lib()
    return pair_fits(D, lib.flow_fused_bwd_smem_bytes(D, K, S, M, T),
                     lib.flow_fused_bwd_smem_optin(ops.device_index(device)))


def _plan(lib, export, L, N, D, K, S, M, order, device):
    out = (ctypes.c_int * 3)()
    rc = getattr(lib, export)(L, N, D, K, S, M, order,
                              ops.device_index(device), out)
    if rc != 0:
        raise RuntimeError(f'{export} takes no plan at L={L} N={N} D={D} '
                           f'K={K} S={S} M={M}: CUDA error {rc}')
    return tuple(out)


def fwd_plan(L, N, D, K, S, M, order, device):
    """(rows per cluster, blocks per cluster, row tiles per draw) of the
    trajectory kernel at these shapes on `device`: the adjoint's plan
    (csrc/flow_cluster.cuh `plan_on`). Raises for shapes it refuses."""
    return _plan(_lib(), 'flow_fused_fwd_plan', L, N, D, K, S, M, order,
                 device)


def bwd_plan(L, N, D, K, S, M, order, device):
    """(rows per cluster, blocks per cluster, row tiles per draw) of the
    adjoint kernel at these shapes on `device` (csrc/flow_cluster.cuh
    `plan_on`: csrc/cluster.cuh `plan_for`, with more blocks per cluster
    where a block would not fit the opt-in shared memory). Raises for
    shapes the kernel refuses."""
    return _plan(_bwd_lib(), 'flow_fused_bwd_plan', L, N, D, K, S, M,
                 order, device)


def _launch(z0, omf, phf, ws, Zb, zn, il2, nus, dts, T, order):
    """Launch the trajectory kernel; returns zs (L, T, N, D)."""
    operands = (omf, phf, ws, Zb, zn, il2, nus)
    _check_tensors(z0.device, zip(('z0',) + _NAMES + ('dts',),
                                  (z0,) + operands + (dts,)))
    L, N, D, K, S, M, strides = _check(z0.shape, operands, dts, T, order)
    if z0.dim() not in (2, 3) or (z0.dim() == 3 and z0.shape[0] not in (1,
                                                                        L)):
        raise ValueError(f'z0 has shape {tuple(z0.shape)}, expected '
                         f'([L or 1,] {N}, {D})')
    z0_ls = N * D if z0.dim() == 3 and z0.shape[0] == L and L > 1 else 0

    zs = torch.empty((L, T, N, D), dtype=torch.float32, device=z0.device)
    flat = [z0.data_ptr(), z0_ls]
    for x, ls in zip(operands, strides):
        flat += [x.data_ptr(), ls]
    stream = torch.cuda.current_stream(z0.device).cuda_stream
    rc = _lib().flow_fused_fwd(*flat, dts.data_ptr(), zs.data_ptr(), L, N,
                               D, K, S, M, T, order, z0.device.index,
                               stream)
    if rc != 0:
        raise RuntimeError(f'{KERNEL} launch failed: CUDA error {rc} '
                           f'(L={L} N={N} D={D} K={K} S={S} M={M} T={T})')
    ops.count(KERNEL, (L, N, D, K, S, M, T))
    return zs


def _launch_bwd(zs, zsbar, operands, dts, T, order, z0_shared=False):
    """Launch the adjoint kernel on zs, zsbar (L, T, N, D). Returns z0bar
    ((N, D) summed over the draws if `z0_shared`, else (L, N, D)) and the
    cotangents of `operands` and dts, each in its operand's shape, all
    finished by the library's second kernel."""
    device = zs.device
    _check_tensors(device, zip(('zs', 'zsbar') + _NAMES + ('dts',),
                               (zs, zsbar) + tuple(operands) + (dts,)))
    L, N, D, K, S, M, strides = _check(zs.shape[:1] + zs.shape[2:],
                                       operands, dts, T, order)
    if zs.shape != (L, T, N, D) or zsbar.shape != zs.shape:
        raise ValueError(f'zs {tuple(zs.shape)} and zsbar '
                         f'{tuple(zsbar.shape)} must be ({L}, {T}, {N}, '
                         f'{D})')
    if D > BWD_MAX_D:
        raise NotImplementedError(
            f'the backward kernel takes state dims up to {BWD_MAX_D}, got '
            f'{D}')

    lib = _bwd_lib()
    n_tiles = bwd_plan(L, N, D, K, S, M, order, device)[2]  # raises if
    P = lib.flow_fused_bwd_slab_floats(D, K, S, M, T)         # refused
    work = torch.empty(L * N * D + L * n_tiles * P, dtype=torch.float32,
                       device=device)
    shapes = [(N, D) if z0_shared else (L, N, D)] + [
        tuple(x.shape) for x in operands] + [(T - 1,)]
    sizes = [math.prod(shape) for shape in shapes]
    out = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    flat = [zs.data_ptr(), zsbar.data_ptr()]
    for x, ls in zip(operands, strides):
        flat += [x.data_ptr(), ls]
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.flow_fused_bwd(*flat, dts.data_ptr(), work.data_ptr(),
                            out.data_ptr(), L, N, D, K, S, M, T, order,
                            int(z0_shared), device.index, stream)
    if rc != 0:
        raise RuntimeError(f'{BWD_KERNEL} launch failed: CUDA error {rc} '
                           f'(L={L} N={N} D={D} K={K} S={S} M={M} T={T})')
    ops.count(BWD_KERNEL, (L, N, D, K, S, M, T))
    return tuple(part.view(shape)
                 for part, shape in zip(out.split(sizes), shapes))


class _PackedEulerFlow(torch.autograd.Function):
    """The trajectory kernel with the adjoint kernel as its backward."""

    @staticmethod
    def forward(ctx, z0, omf, phf, ws, Zb, zn, il2, nus, dts, T, order):
        zs = _launch(z0, omf, phf, ws, Zb, zn, il2, nus, dts, T, order)
        ctx.save_for_backward(zs, omf, phf, ws, Zb, zn, il2, nus, dts)
        ctx.T, ctx.order, ctx.z0_shape = T, order, z0.shape
        lead = z0.dim() == 3 or any(
            x.dim() == 3 for x in (omf, phf, ws, Zb, zn, il2, nus))
        ctx.lead = lead
        return zs if lead else zs[0]

    @staticmethod
    def backward(ctx, zsbar):
        zs, *operands, dts = ctx.saved_tensors
        zsbar = zsbar.reshape(zs.shape).contiguous()
        # z0 shared by the draws: the library sums its cotangent
        z0bar, *bars = _launch_bwd(
            zs, zsbar, operands, dts, ctx.T, ctx.order,
            z0_shared=tuple(ctx.z0_shape) != tuple(zs.shape[:1] +
                                                   zs.shape[2:]))
        grads = [z0bar.reshape(ctx.z0_shape)] + bars
        grads = [g if need else None
                 for g, need in zip(grads, ctx.needs_input_grad)]
        return (*grads, None, None)


def packed_euler_flow(z0, omf, phf, ws, Zb, zn, il2, nus, dts, T, order=1):
    """Euler GP-ODE flow over packed operands, per-interval step sizes
    dts (T-1,). Returns zs (L, T, N, D), or (T, N, D) when no operand has
    a leading dim of draws.

    CUDA tensors launch the trajectory kernel, and reverse mode launches
    the adjoint kernel; CPU tensors take the plain version and autograd
    through it. Anything else raises.
    """
    tensors = (z0, omf, phf, ws, Zb, zn, il2, nus, dts)
    if all(x.device.type == 'cpu' for x in tensors):
        return packed_flow_reference(z0, omf, phf, ws, Zb, zn, il2, nus,
                                     dts, T, order)
    if z0.device.type != 'cuda':
        raise ValueError(f'unsupported device {z0.device}')
    return _PackedEulerFlow.apply(z0, omf, phf, ws, Zb, zn, il2, nus, dts,
                                  T, order)


def packed_flow_vjp(zs, zsbar, omf, phf, ws, Zb, zn, il2, nus, dts, T,
                    order=1):
    """The backward of :func:`packed_euler_flow` as a function: the
    cotangents of :func:`packed_flow_vjp_reference` (same arguments, same
    outputs). CUDA tensors launch the adjoint kernel; CPU tensors take
    the plain version."""
    tensors = (zs, zsbar, omf, phf, ws, Zb, zn, il2, nus, dts)
    if all(x.device.type == 'cpu' for x in tensors):
        return packed_flow_vjp_reference(zs, zsbar, omf, phf, ws, Zb, zn,
                                         il2, nus, dts, T, order)
    if zs.device.type != 'cuda':
        raise ValueError(f'unsupported device {zs.device}')
    lead = zs.dim() == 4
    zs4 = zs if lead else zs[None]
    z0bar, *bars = _launch_bwd(zs4, zsbar.reshape(zs4.shape), (
        omf, phf, ws, Zb, zn, il2, nus), dts, T, order)
    return (z0bar if lead else z0bar[0],) + tuple(bars)


def fused_euler_flow(z0, omega, phase, weights, Z, nu, ls, var, dt, T,
                     order=1):
    """One-kernel euler GP-ODE trajectory. Returns zs (..., T, N, D).

    z0 (N, D) or (L, N, D); draw operands omega (..., D, S, K), phase
    (..., 1, S, K), weights (..., S, K), nu (..., K, M); GP operands
    Z (M, D), ls (K, D), var (K,); dt a scalar or (T-1,) step sizes.
    Differentiable in every tensor argument.
    """
    packed = _pack_operands(omega, phase, weights, Z, nu, ls, var)
    dts = torch.as_tensor(dt, dtype=z0.dtype, device=z0.device)
    dts = dts.expand(T - 1).contiguous()
    return packed_euler_flow(z0, *packed, dts, T, order)
