"""Whole euler trajectory of the dimwise-RBF pathwise GP sample in one
CUDA kernel (port of the forward of `vae_gp_ode_tpu/ops/flow_fused.py`).

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

`packed_euler_flow` launches `csrc/flow_fused.cu` for CUDA tensors and
computes `packed_flow_reference`, its plain PyTorch version, for CPU
tensors. It has no backward yet (the discrete-adjoint kernel is ROADMAP
Queue B): on CUDA it refuses inputs that require grad.
"""

import ctypes

import torch

from vae_gp_ode_tpu_torch import ops
from vae_gp_ode_tpu_torch.ops import _build
from vae_gp_ode_tpu_torch.ops.pathwise import pathwise_eval_reference

KERNEL = 'flow_fused_fwd'
SOURCE = 'vae_gp_ode_tpu_torch/csrc/flow_fused.cu'
#: the TPU kernel this one replaces
REPLACES = 'vae_gp_ode_tpu/ops/flow_fused.py:116'

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_ARGTYPES = ([_P, _LL] * 8 + [_P, _P] + [_I] * 9 + [_P])


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
    il2 = torch.repeat_interleave(inv_ls2, M, dim=0).T             # (D, K*M)
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


def _kernel():
    fn = _build.load('flow_fused').flow_fused_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _launch(z0, omf, phf, ws, Zb, zn, il2, nus, dts, T, order):
    args = (z0, omf, phf, ws, Zb, zn, il2, nus)
    names = ('z0', 'omf', 'phf', 'ws', 'Zb', 'zn', 'il2', 'nus')
    device = z0.device
    for name, x in zip(names + ('dts',), args + (dts,)):
        if x.device != device:
            raise ValueError(f'{name} is on {x.device}, z0 on {device}')
        if x.dtype != torch.float32:
            raise TypeError(f'{name} must be float32, got {x.dtype}')
        if not x.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in args + (dts,)):
        raise NotImplementedError(
            'the backward of the fused trajectory kernel is not ported yet '
            '(ROADMAP Queue B, kernel #2); run it under torch.no_grad()')
    if order not in (1, 2):
        raise ValueError(f'ODE order must be 1 or 2, got {order}')

    N, D = z0.shape[-2:]
    K = D // order
    if K * order != D:
        raise ValueError(f'order {order} needs an even state dim, got {D}')
    if ws.shape[-1] % K or nus.shape[-1] % K:
        raise ValueError('ws/nus widths must be multiples of K')
    S, M = ws.shape[-1] // K, nus.shape[-1] // K
    base = {'z0': (N, D), 'omf': (D, K * S), 'phf': (1, K * S),
            'ws': (1, K * S), 'Zb': (D, K * M), 'zn': (1, K * M),
            'il2': (D, K * M), 'nus': (1, K * M)}
    lead = [x.shape[0] for x in args if x.dim() == 3]
    L = max(lead, default=1)
    strides = []
    for name, x in zip(names, args):
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

    fn = _kernel()
    zs = torch.empty((L, T, N, D), dtype=torch.float32, device=device)
    flat = []
    for x, ls in zip(args, strides):
        flat += [x.data_ptr(), ls]
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*flat, dts.data_ptr(), zs.data_ptr(), L, N, D, K, S, M, T,
            order, device.index, stream)
    if rc != 0:
        raise RuntimeError(f'{KERNEL} launch failed: CUDA error {rc}')
    ops.LAUNCHES[KERNEL] += 1
    return zs if lead else zs[0]


def packed_euler_flow(z0, omf, phf, ws, Zb, zn, il2, nus, dts, T, order=1):
    """Euler GP-ODE flow over packed operands, per-interval step sizes
    dts (T-1,). Returns zs (L, T, N, D), or (T, N, D) when no operand has
    a leading dim of draws.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    Anything else raises.
    """
    tensors = (z0, omf, phf, ws, Zb, zn, il2, nus, dts)
    if all(x.device.type == 'cpu' for x in tensors):
        return packed_flow_reference(z0, omf, phf, ws, Zb, zn, il2, nus,
                                     dts, T, order)
    if z0.device.type != 'cuda':
        raise ValueError(f'unsupported device {z0.device}')
    return _launch(z0, omf, phf, ws, Zb, zn, il2, nus, dts, T, order)


def fused_euler_flow(z0, omega, phase, weights, Z, nu, ls, var, dt, T,
                     order=1):
    """One-kernel euler GP-ODE trajectory. Returns zs (..., T, N, D).

    z0 (N, D) or (L, N, D); draw operands omega (..., D, S, K), phase
    (..., 1, S, K), weights (..., S, K), nu (..., K, M); GP operands
    Z (M, D), ls (K, D), var (K,); dt a scalar or (T-1,) step sizes.
    """
    packed = _pack_operands(omega, phase, weights, Z, nu, ls, var)
    dts = torch.as_tensor(dt, dtype=z0.dtype, device=z0.device)
    dts = dts.expand(T - 1).contiguous()
    return packed_euler_flow(z0, *packed, dts, T, order)
