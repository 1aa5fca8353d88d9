"""Whole euler trajectory of the divergence-free (DF) pathwise GP sample in
one CUDA kernel, and its discrete adjoint in another (port of
`vae_gp_ode_tpu/ops/df_flow_fused.py`).

    forward:   z_{t+1} = z_t + dts[t] f(z_t),  zs[0] = z0
    backward:  g_t = zsbar[t] + g_{t+1} + (d f / d z_t)^T (dts[t] g_{t+1})
               param_bar += (d f / d param)^T (dts[t] g_{t+1})
               dtsbar[t] = <g_{t+1}, f(z_t)>

with f the DF evaluation of `ops.df_pathwise` on its operands (omf, phf,
G, Z, nur, ls2, var); both kernels share its device routines and its
split of the work (`csrc/df_common.cuh`, `csrc/df_cluster.cuh`). DF
flows are first order only (D_in == D_out).
Every operand may carry a leading dim of L draws or be shared by all
draws: one launch integrates all L Monte-Carlo trajectories.

`packed_df_euler_flow` launches `csrc/df_flow_fused.cu` (a cluster of
blocks per (draw, row tile) that walks the T-1 steps, one cluster sum of
f a step) for CUDA tensors inside a `torch.autograd.Function` whose
backward launches `csrc/df_flow_fused_bwd.cu` (`df_flow_vjp`): a cluster
of blocks per (draw, row tile), each block with its share of the feature
columns and inducing points and their cotangents in shared memory, and a
second kernel of the same library call that sums the slabs into the finished
cotangents (no PyTorch reduction after the call). CPU tensors take the
plain versions, `df_euler_flow_reference` and autograd through it
(`df_flow_vjp_reference`). `df_fused_pair_fits` decides from the shapes,
before any launch, whether the pair takes a flow.
"""

import ctypes
import math

import torch

from vae_gp_ode_tpu_torch import ops
from vae_gp_ode_tpu_torch.ops import _build
from vae_gp_ode_tpu_torch.ops.df_pathwise import (
    BASE_DIMS, MAX_D, NAMES, check_operands, df_pathwise_reference,
)
from vae_gp_ode_tpu_torch.ops.pathwise import _check_tensors

KERNEL = 'df_flow_fused_fwd'
SOURCE = 'vae_gp_ode_tpu_torch/csrc/df_flow_fused.cu'
#: the TPU kernel this one replaces
REPLACES = 'vae_gp_ode_tpu/ops/df_flow_fused.py:72'

BWD_KERNEL = 'df_flow_fused_bwd'
BWD_SOURCE = 'vae_gp_ode_tpu_torch/csrc/df_flow_fused_bwd.cu'
BWD_REPLACES = 'vae_gp_ode_tpu/ops/df_flow_fused.py:100'

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_ARGTYPES = [_P, _LL] * 8 + [_P, _P] + [_I] * 7 + [_P]
_BWD_ARGTYPES = [_P, _P] + [_P, _LL] * 7 + [_P, _P, _P] + [_I] * 8 + [_P]


def df_euler_flow_reference(z0, omf, phf, G, Z, nur, ls2, var, dts, T):
    """Plain euler trajectory through the DF pathwise sample(s): a loop
    over steps. dts a scalar or (T-1,) step sizes. Returns zs
    (..., T, N, D) with zs[..., 0, :, :] = z0."""
    dts = torch.as_tensor(dts, dtype=z0.dtype,
                          device=z0.device).expand(T - 1)
    zs = [z0]
    for t in range(T - 1):
        zs.append(zs[-1] + dts[t] * df_pathwise_reference(
            zs[-1], omf, phf, G, Z, nur, ls2, var))
    lead = torch.broadcast_shapes(*(z.shape[:-2] for z in zs))
    return torch.stack([z.expand(lead + z0.shape[-2:]) for z in zs], dim=-3)


def df_flow_vjp_reference(zs, zsbar, omf, phf, G, Z, nur, ls2, var, dts,
                          T):
    """Plain version of the backward kernel: autograd through
    :func:`df_euler_flow_reference` from z0 = zs[..., 0, :, :].

    Returns (z0bar, omf, phf, G, Z, nur, ls2, var and dts cotangents):
    z0bar in zs[..., 0, :, :]'s shape (one per draw), the others in their
    operands' shapes (summed over the draws an operand is shared by).
    """
    with torch.enable_grad():
        z0 = zs[..., 0, :, :].detach().requires_grad_()
        inputs = [z0] + [x.detach().requires_grad_() for x in (
            omf, phf, G, Z, nur, ls2, var, dts)]
        out = df_euler_flow_reference(*inputs, T)
        return torch.autograd.grad(out, inputs, zsbar)


def _lib():
    lib = _build.load('df_flow_fused')
    if lib.df_flow_fused_fwd.argtypes is None:
        lib.df_flow_fused_fwd.argtypes = _ARGTYPES
        lib.df_flow_fused_fwd.restype = ctypes.c_int
        lib.df_flow_fused_fwd_smem_bytes.argtypes = [_I]
        lib.df_flow_fused_fwd_smem_bytes.restype = ctypes.c_longlong
    return lib


def _bwd_lib():
    lib = _build.load('df_flow_fused_bwd')
    if lib.df_flow_fused_bwd.argtypes is None:
        lib.df_flow_fused_bwd.argtypes = _BWD_ARGTYPES
        lib.df_flow_fused_bwd.restype = ctypes.c_int
        lib.df_flow_fused_bwd_slab_floats.argtypes = [_I] * 4
        lib.df_flow_fused_bwd_slab_floats.restype = ctypes.c_longlong
        lib.df_flow_fused_bwd_plan.argtypes = [_I] * 7 + [_P]
        lib.df_flow_fused_bwd_plan.restype = ctypes.c_int
        lib.df_flow_fused_bwd_smem_bytes.argtypes = [_I] * 3
        lib.df_flow_fused_bwd_smem_bytes.restype = ctypes.c_longlong
        lib.df_flow_fused_bwd_smem_optin.argtypes = [_I]
        lib.df_flow_fused_bwd_smem_optin.restype = ctypes.c_int
    return lib


def df_pair_fits(D, smem_bytes, optin):
    """The dispatch rule of the DF pair: the trajectory kernel and its
    adjoint take a flow when the state dim is at most MAX_D and the larger
    of the two kernels' blocks (`smem_bytes`) fits the device's opt-in
    limit per block (`optin`; negative when it could not be read). The
    larger is the adjoint's block of an 8-block cluster
    (csrc/df_flow_fused_bwd.cu `df_flow_fused_bwd_smem_bytes`: 2 (3D + 1)
    floats per feature column or (point, output) item of its share, S*D/8
    columns and M/8 points); the trajectory kernel's block holds only the
    tile's state, 1/ls2, var and its sums (`df_flow_fused_fwd_smem_bytes`:
    1,224 bytes at D = 6, 2,496 at D = 16). On an H100 (232,448 bytes)
    that is S up to 1920 at D = 6 (the default run's S = 256 takes 42,664
    bytes) and D up to 14 at S = 256; not D = 12 at S = 1024."""
    return D <= MAX_D and 0 <= smem_bytes <= optin


def df_fused_pair_fits(D, SD, M, device):
    """`df_pair_fits` on `device` (a CUDA device), from both kernels' own
    shared-memory exports and the device's opt-in limit: decided from the
    shapes alone, before any launch."""
    if D > MAX_D:
        return False
    lib = _bwd_lib()
    need = max(_lib().df_flow_fused_fwd_smem_bytes(D),
               lib.df_flow_fused_bwd_smem_bytes(D, SD, M))
    return df_pair_fits(D, need, lib.df_flow_fused_bwd_smem_optin(
        ops.device_index(device)))


def bwd_plan(L, N, D, SD, M, T, device):
    """(rows per cluster, blocks per cluster, row tiles per draw) of the
    adjoint kernel at these shapes on `device` (csrc/df_cluster.cuh
    `plan_for`, with more blocks per cluster where a block would not fit
    the opt-in shared memory). Raises for shapes the kernel refuses."""
    out = (ctypes.c_int * 3)()
    rc = _bwd_lib().df_flow_fused_bwd_plan(L, N, D, SD, M, T,
                                           ops.device_index(device), out)
    if rc != 0:
        raise RuntimeError(f'{BWD_KERNEL} takes no plan at L={L} N={N} '
                           f'D={D} SD={SD} M={M} T={T}: CUDA error {rc}')
    return tuple(out)


def _num_draws(z0, operands):
    """L: the leading dim of z0 (L, N, D) and of the per-draw operands,
    which must agree; 1 when no tensor has one."""
    leads = {t.shape[0] for t, nd in zip(operands, BASE_DIMS)
             if t.dim() == nd + 1}
    if z0.dim() == 3:
        leads.add(z0.shape[0])
    if len(leads) > 1 or z0.dim() not in (2, 3):
        raise ValueError(f'z0 {tuple(z0.shape)} and the operands disagree '
                         f'on the number of draws: {sorted(leads)}')
    return leads.pop() if leads else 1


def _launch(z0, operands, dts, T):
    """Launch the trajectory kernel; returns zs (L, T, N, D)."""
    _check_tensors(z0.device, zip(('z0',) + NAMES + ('dts',),
                                  (z0,) + tuple(operands) + (dts,)))
    L = _num_draws(z0, operands)
    N, D = z0.shape[-2:]
    SD, M, strides = check_operands(L, D, operands)
    z0_ls = N * D if z0.dim() == 3 else 0
    if tuple(dts.shape) != (T - 1,):
        raise ValueError(f'dts has shape {tuple(dts.shape)}, expected '
                         f'({T - 1},)')
    zs = torch.empty((L, T, N, D), dtype=torch.float32, device=z0.device)
    flat = [z0.data_ptr(), z0_ls]
    for t, ls in zip(operands, strides):
        flat += [t.data_ptr(), ls]
    stream = torch.cuda.current_stream(z0.device).cuda_stream
    rc = _lib().df_flow_fused_fwd(*flat, dts.data_ptr(), zs.data_ptr(), L, N,
                                  D, SD, M, T, z0.device.index, stream)
    if rc != 0:
        raise RuntimeError(f'{KERNEL} launch failed: CUDA error {rc} '
                           f'(L={L} N={N} D={D} SD={SD} M={M} T={T})')
    ops.count(KERNEL, (L, N, D, SD, M, T))
    return zs


def _launch_bwd(zs, zsbar, operands, dts, T, z0_shared=False):
    """Launch the adjoint kernel on zs, zsbar (L, T, N, D). Returns z0bar
    ((N, D) summed over the draws if `z0_shared`, else (L, N, D)) and the
    cotangents of `operands` and dts, each in its operand's shape, all
    finished by the library's second kernel."""
    device = zs.device
    _check_tensors(device, zip(('zs', 'zsbar') + NAMES + ('dts',),
                               (zs, zsbar) + tuple(operands) + (dts,)))
    if zs.dim() != 4 or zsbar.shape != zs.shape or zs.shape[1] != T:
        raise ValueError(f'zs {tuple(zs.shape)} and zsbar '
                         f'{tuple(zsbar.shape)} must be (L, {T}, N, D)')
    L, _, N, D = zs.shape
    SD, M, strides = check_operands(L, D, operands)
    if tuple(dts.shape) != (T - 1,):
        raise ValueError(f'dts has shape {tuple(dts.shape)}, expected '
                         f'({T - 1},)')
    lib = _bwd_lib()
    n_tiles = bwd_plan(L, N, D, SD, M, T, device)[2]  # raises if refused
    P = lib.df_flow_fused_bwd_slab_floats(D, SD, M, T)
    work = torch.empty(L * N * D + L * n_tiles * P, dtype=torch.float32,
                       device=device)
    shapes = [(N, D) if z0_shared else (L, N, D)] + [
        tuple(t.shape) for t in operands] + [(T - 1,)]
    sizes = [math.prod(shape) for shape in shapes]
    out = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    flat = [zs.data_ptr(), zsbar.data_ptr()]
    for t, ls in zip(operands, strides):
        flat += [t.data_ptr(), ls]
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.df_flow_fused_bwd(*flat, dts.data_ptr(), work.data_ptr(),
                               out.data_ptr(), L, N, D, SD, M, T,
                               int(z0_shared), device.index, stream)
    if rc != 0:
        raise RuntimeError(f'{BWD_KERNEL} launch failed: CUDA error {rc} '
                           f'(L={L} N={N} D={D} SD={SD} M={M} T={T})')
    ops.count(BWD_KERNEL, (L, N, D, SD, M, T))
    return tuple(part.view(shape)
                 for part, shape in zip(out.split(sizes), shapes))


class _PackedDfEulerFlow(torch.autograd.Function):
    """The trajectory kernel with the adjoint kernel as its backward."""

    @staticmethod
    def forward(ctx, z0, omf, phf, G, Z, nur, ls2, var, dts, T):
        operands = (omf, phf, G, Z, nur, ls2, var)
        zs = _launch(z0, operands, dts, T)
        ctx.save_for_backward(zs, *operands, dts)
        ctx.T, ctx.z0_shape = T, z0.shape
        ctx.lead = z0.dim() == 3 or any(
            t.dim() == nd + 1 for t, nd in zip(operands, BASE_DIMS))
        return zs if ctx.lead else zs[0]

    @staticmethod
    def backward(ctx, zsbar):
        zs, *operands, dts = ctx.saved_tensors
        zsbar = zsbar.reshape(zs.shape).contiguous()
        # z0 (N, D) is shared by the draws: the library sums its cotangent
        z0bar, *bars = _launch_bwd(zs, zsbar, operands, dts, ctx.T,
                                   z0_shared=len(ctx.z0_shape) == 2)
        grads = [z0bar] + bars
        grads = [g if need else None
                 for g, need in zip(grads, ctx.needs_input_grad)]
        return (*grads, None)


def packed_df_euler_flow(z0, omf, phf, G, Z, nur, ls2, var, dts, T):
    """Euler DF-GP-ODE flow over the operands of
    `ops.df_pathwise.df_fused_operands`, per-interval step sizes dts
    (T-1,). Returns zs (L, T, N, D), or (T, N, D) when no tensor has a
    leading dim of draws. Differentiable in every tensor argument (the
    cotangents of z0, omf, phf, G, Z, nur, ls2, var and dts).

    CUDA tensors launch the trajectory kernel, and reverse mode launches
    the adjoint kernel; CPU tensors take the plain version and autograd
    through it. Anything else raises.
    """
    tensors = (z0, omf, phf, G, Z, nur, ls2, var, dts)
    if all(t.device.type == 'cpu' for t in tensors):
        return df_euler_flow_reference(*tensors, T)
    if z0.device.type != 'cuda':
        raise ValueError(f'unsupported device {z0.device}')
    return _PackedDfEulerFlow.apply(*(t.contiguous() for t in tensors), T)


def df_flow_vjp(zs, zsbar, omf, phf, G, Z, nur, ls2, var, dts, T):
    """The backward of :func:`packed_df_euler_flow` as a function: the
    cotangents of :func:`df_flow_vjp_reference` (same arguments, same
    outputs). CUDA tensors launch the adjoint kernel; CPU tensors take the
    plain version."""
    tensors = (zs, zsbar, omf, phf, G, Z, nur, ls2, var, dts)
    if all(t.device.type == 'cpu' for t in tensors):
        return df_flow_vjp_reference(*tensors, T)
    if zs.device.type != 'cuda':
        raise ValueError(f'unsupported device {zs.device}')
    lead = zs.dim() == 4
    zs4 = zs if lead else zs[None]
    operands = (omf, phf, G, Z, nur, ls2, var)
    z0bar, *bars = _launch_bwd(zs4, zsbar.reshape(zs4.shape), operands, dts,
                               T)
    return (z0bar if lead else z0bar[0],) + tuple(bars)
