"""The forward kernels as registered PyTorch operators, so that a traced
program (`torch.export`, the serving artifact of `serving.py`) launches
them.

A kernel launched through ctypes with `data_ptr()` cannot be traced; an
operator of the dispatcher can. Six operators, in the namespace
`vae_gp_ode_torch`:

* `flow_fused_fwd` (#1): the RBF euler trajectory of `ops.flow_fused`,
  (L, T, N, D);
* `df_flow_fused_fwd` (#7): the DF euler trajectory of
  `ops.df_flow_fused`, (L, T, N, D);
* `pathwise_eval_fwd`: the RBF per-step eval, #3 or #9 as
  `ops.pathwise_tiled.use_tiled` picks on the real shapes, (L, N, K);
* `df_pathwise_eval_fwd`: the DF per-step eval, #5 or #11 as
  `ops.df_pathwise_tiled.use_df_tiled` picks, (L, N, D);
* `pathwise_eval_jac` and `df_pathwise_eval_jac`: the per-row Jacobians
  of those evals, (L, N, K, D) and (L, N, D, D), from one launch of a VJP
  kernel (#4 or #10, #6 or #12, as the rules pick on the N*K rows the
  Jacobian takes): bdf's Newton iterations.

Each has three implementations: for CUDA tensors the existing launcher
(which counts its launch in `ops.LAUNCHES` and raises on a failed build or
launch), for CPU tensors the kernel's plain version, and for fake tensors
(tracing) an empty tensor of the output's shape, which launches nothing.
The dispatcher raises for any other device. The per-step choice between
the single-block and the grid-tiled kernel is made inside the CUDA
implementation, so that a program traced with a symbolic batch keeps it
for the batch it is served.

The operators are forward-only: the wrappers (`packed_euler_flow`,
`packed_df_euler_flow`, `pathwise_eval`, `df_pathwise_eval`) call them
when no input needs a gradient and keep their `torch.autograd.Function`s,
whose backward launches the VJP kernels, otherwise; the Jacobian
operators take detached inputs (`gp.svgp.fn_jacobian`). The CUDA and CPU
implementations import the wrappers' modules when called, so importing
this module registers the operators and loads nothing else.
"""

import torch
import torch.autograd.forward_ad as fwAD

NAMESPACE = 'vae_gp_ode_torch'

# The operators are defined through a `torch.library.Library` with one
# Python kernel for each device, not `torch.library.custom_op`, whose
# Python autograd layer adds host time to every call on the eager path.
_LIB = torch.library.Library(NAMESPACE, 'DEF')


def _define(name, schema, cuda, cpu, fake):
    """Define operator `name` with `schema` and its CUDA, CPU and fake
    implementations; returns its overload, the callable."""
    _LIB.define(name + schema)
    _LIB.impl(name, cuda, 'CUDA')
    _LIB.impl(name, cpu, 'CPU')
    torch.library.register_fake(f'{NAMESPACE}::{name}', fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def check_devices(tensors):
    """Raise unless every tensor lies on the CPU or on a CUDA device: the
    operators' fake implementation would take a meta tensor."""
    for t in tensors:
        if t.device.type not in ('cpu', 'cuda'):
            raise ValueError(
                f'unsupported device {t.device}: the {NAMESPACE} operators '
                f'run on CUDA tensors (the kernels) or CPU tensors (their '
                f'plain versions)')


def _num_draws(z0, operands, base_dims):
    """L: the leading dim of the tensors that have one (z0 (L, N, D) and
    the operands with one dim more than `base_dims`), or 1."""
    leads = [t.shape[0] for t, nd in zip(operands, base_dims)
             if t.dim() == nd + 1]
    if z0.dim() == 3:
        leads.append(z0.shape[0])
    return max(leads, default=1)


def _as_draws(zs):
    """A plain trajectory (..., T, N, D) as (L, T, N, D)."""
    return zs.reshape((-1,) + tuple(zs.shape[-3:]))


_FLOW_DIMS = (2,) * 7
_DF_DIMS = (2, 2, 2, 2, 2, 2, 1)


# -- #1: the RBF euler trajectory ---------------------------------------------

def _flow_cuda(z0, omf, phf, ws, Zb, zn, il2, nus, dts, T, order):
    from vae_gp_ode_tpu_torch.ops import flow_fused
    return flow_fused._launch(z0, omf, phf, ws, Zb, zn, il2, nus, dts, T,
                              order)


def _flow_cpu(z0, omf, phf, ws, Zb, zn, il2, nus, dts, T, order):
    from vae_gp_ode_tpu_torch.ops import flow_fused
    return _as_draws(flow_fused.packed_flow_reference(
        z0, omf, phf, ws, Zb, zn, il2, nus, dts, T, order))


def _flow_fake(z0, omf, phf, ws, Zb, zn, il2, nus, dts, T, order):
    L = _num_draws(z0, (omf, phf, ws, Zb, zn, il2, nus), _FLOW_DIMS)
    return z0.new_empty((L, T) + tuple(z0.shape[-2:]))


#: the euler trajectory of `ops.flow_fused.packed_euler_flow` over packed
#: operands: zs (L, T, N, D), L = 1 where no tensor has a draw dim
flow_fused_fwd = _define(
    'flow_fused_fwd', '(Tensor z0, Tensor omf, Tensor phf, Tensor ws, '
    'Tensor Zb, Tensor zn, Tensor il2, Tensor nus, Tensor dts, int T, '
    'int order) -> Tensor', _flow_cuda, _flow_cpu, _flow_fake)


# -- #7: the DF euler trajectory ----------------------------------------------

def _df_flow_cuda(z0, omf, phf, G, Z, nur, ls2, var, dts, T):
    from vae_gp_ode_tpu_torch.ops import df_flow_fused
    return df_flow_fused._launch(z0, (omf, phf, G, Z, nur, ls2, var), dts,
                                 T)


def _df_flow_cpu(z0, omf, phf, G, Z, nur, ls2, var, dts, T):
    from vae_gp_ode_tpu_torch.ops import df_flow_fused
    return _as_draws(df_flow_fused.df_euler_flow_reference(
        z0, omf, phf, G, Z, nur, ls2, var, dts, T))


def _df_flow_fake(z0, omf, phf, G, Z, nur, ls2, var, dts, T):
    L = _num_draws(z0, (omf, phf, G, Z, nur, ls2, var), _DF_DIMS)
    return z0.new_empty((L, T) + tuple(z0.shape[-2:]))


#: the euler trajectory of `ops.df_flow_fused.packed_df_euler_flow`:
#: zs (L, T, N, D), L = 1 where no tensor has a draw dim
df_flow_fused_fwd = _define(
    'df_flow_fused_fwd', '(Tensor z0, Tensor omf, Tensor phf, Tensor G, '
    'Tensor Z, Tensor nur, Tensor ls2, Tensor var, Tensor dts, int T) -> '
    'Tensor', _df_flow_cuda, _df_flow_cpu, _df_flow_fake)


def pair_refusal(node, device):
    """For a traced call (an fx node) of `flow_fused_fwd` or
    `df_flow_fused_fwd`: its shapes as text where the fused euler pair
    refuses them on CUDA `device` (`dynamics.flow.use_fused_pair`; a trace
    on the CPU takes the pair at every shape), else None. None for any
    other node."""
    from vae_gp_ode_tpu_torch.ops import df_flow_fused, flow_fused
    refusal = {flow_fused_fwd: flow_fused.pair_refusal,
               df_flow_fused_fwd: df_flow_fused.pair_refusal}.get(
                   node.target)
    if refusal is None:
        return None
    args = [a.meta['val'] if isinstance(a, torch.fx.Node) else a
            for a in node.args]
    return refusal(*args, device=device)


# -- #3 / #9: the RBF per-step eval -------------------------------------------

def _pathwise_cuda(x, omega, phase, weights, Z, nu, ls, var):
    from vae_gp_ode_tpu_torch.ops import pathwise, pathwise_tiled
    L, N, D = x.shape
    (S, K), M = omega.shape[-2:], Z.shape[-2]
    tiled, _ = pathwise_tiled.use_tiled(L, N, D, K, S, M, x.device)
    launch = pathwise_tiled._launch if tiled else pathwise._launch
    return launch(x, (omega, phase, weights, Z, nu, ls, var))


def _pathwise_cpu(x, omega, phase, weights, Z, nu, ls, var):
    from vae_gp_ode_tpu_torch.ops import pathwise
    return pathwise.pathwise_eval_reference(x, omega, phase, weights, Z, nu,
                                            ls, var)


def _pathwise_fake(x, omega, phase, weights, Z, nu, ls, var):
    return x.new_empty(tuple(x.shape[:-1]) + (omega.shape[-1],))


#: the per-step eval of `ops.pathwise_tiled.pathwise_eval` at x (L, N, D):
#: (L, N, K)
pathwise_eval_fwd = _define(
    'pathwise_eval_fwd', '(Tensor x, Tensor omega, Tensor phase, Tensor '
    'weights, Tensor Z, Tensor nu, Tensor ls, Tensor var) -> Tensor',
    _pathwise_cuda, _pathwise_cpu, _pathwise_fake)


# -- #5 / #11: the DF per-step eval -------------------------------------------

def _df_pathwise_cuda(x, omf, phf, G, Z, nur, ls2, var):
    from vae_gp_ode_tpu_torch.ops import df_pathwise, df_pathwise_tiled
    L, N, D = x.shape
    tiled, _ = df_pathwise_tiled.use_df_tiled(L, N, D, omf.shape[-1],
                                              Z.shape[-2], x.device)
    launch = df_pathwise_tiled._launch if tiled else df_pathwise._launch
    return launch(x, (omf, phf, G, Z, nur, ls2, var))


def _df_pathwise_cpu(x, omf, phf, G, Z, nur, ls2, var):
    from vae_gp_ode_tpu_torch.ops import df_pathwise
    return df_pathwise.df_pathwise_reference(x, omf, phf, G, Z, nur, ls2,
                                             var)


def _df_pathwise_fake(x, omf, phf, G, Z, nur, ls2, var):
    return x.new_empty(x.shape)


#: the per-step eval of `ops.df_pathwise_tiled.df_pathwise_eval` at x
#: (L, N, D): (L, N, D)
df_pathwise_eval_fwd = _define(
    'df_pathwise_eval_fwd', '(Tensor x, Tensor omf, Tensor phf, Tensor G, '
    'Tensor Z, Tensor nur, Tensor ls2, Tensor var) -> Tensor',
    _df_pathwise_cuda, _df_pathwise_cpu, _df_pathwise_fake)


# -- #4 / #10: the RBF per-step eval's per-row Jacobians ----------------------

def _pathwise_jac_cuda(x, omega, phase, weights, Z, nu, ls, var):
    from vae_gp_ode_tpu_torch.ops import pathwise_tiled
    return pathwise_tiled.pathwise_jacobian(x, omega, phase, weights, Z, nu,
                                            ls, var)


def _pathwise_jac_cpu(x, omega, phase, weights, Z, nu, ls, var):
    from vae_gp_ode_tpu_torch.ops import pathwise
    return pathwise.pathwise_jacobian_reference(x, omega, phase, weights, Z,
                                                nu, ls, var)


def _pathwise_jac_fake(x, omega, phase, weights, Z, nu, ls, var):
    return x.new_empty(tuple(x.shape[:-1]) + (omega.shape[-1], x.shape[-1]))


#: the per-row Jacobians of `pathwise_eval_fwd` at x (L, N, D): (L, N, K,
#: D), one launch of #4 or #10 (`ops.pathwise_tiled.pathwise_jacobian`)
pathwise_eval_jac = _define(
    'pathwise_eval_jac', '(Tensor x, Tensor omega, Tensor phase, Tensor '
    'weights, Tensor Z, Tensor nu, Tensor ls, Tensor var) -> Tensor',
    _pathwise_jac_cuda, _pathwise_jac_cpu, _pathwise_jac_fake)


# -- #6 / #12: the DF per-step eval's per-row Jacobians -----------------------

def _df_pathwise_jac_cuda(x, omf, phf, G, Z, nur, ls2, var):
    from vae_gp_ode_tpu_torch.ops import df_pathwise_tiled
    return df_pathwise_tiled.df_pathwise_jacobian(x, omf, phf, G, Z, nur, ls2,
                                                  var)


def _df_pathwise_jac_cpu(x, omf, phf, G, Z, nur, ls2, var):
    from vae_gp_ode_tpu_torch.ops import df_pathwise
    return df_pathwise.df_pathwise_jacobian_reference(x, omf, phf, G, Z, nur,
                                                      ls2, var)


def _df_pathwise_jac_fake(x, omf, phf, G, Z, nur, ls2, var):
    return x.new_empty(tuple(x.shape) + (x.shape[-1],))


#: the per-row Jacobians of `df_pathwise_eval_fwd` at x (L, N, D): (L, N,
#: D, D), one launch of #6 or #12
#: (`ops.df_pathwise_tiled.df_pathwise_jacobian`)
df_pathwise_eval_jac = _define(
    'df_pathwise_eval_jac', '(Tensor x, Tensor omf, Tensor phf, Tensor G, '
    'Tensor Z, Tensor nur, Tensor ls2, Tensor var) -> Tensor',
    _df_pathwise_jac_cuda, _df_pathwise_jac_cpu, _df_pathwise_jac_fake)


def needs_grad(tensors):
    """Whether autograd records a call on `tensors`, in reverse mode or in
    forward mode (a tangent, which an operator would drop): then the
    wrappers take their `torch.autograd.Function`s (or, on the CPU,
    autograd through the plain version) instead of the forward-only
    operators."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return True
    return fwAD._current_level >= 0 and any(
        fwAD.unpack_dual(t).tangent is not None for t in tensors)
