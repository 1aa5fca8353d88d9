"""Feature-parallel GP evaluation over a `torch.distributed` process group
(port of `vae_gp_ode_tpu/parallel/feature_parallel.py`).

The posterior sample is f(x) = Phi(x) w + K(x, Z) nu. The prior term is
a sum over the S Fourier features, so the features split over the ranks:
each rank holds and evaluates its S / R feature columns, and one
all-reduce of the partial sums gives the full prior term. The pathwise
update (M inducing points, small) is replicated. RBF kernels only, as in
JAX: the DF kernel's (M*D, M*D) coupling does not split over features
without a distributed Cholesky.

JAX computes this in plain jnp with no Pallas kernel; these torch ops are
the module itself, on whatever device the tensors are.
"""

import dataclasses

import torch
import torch.distributed as dist

from vae_gp_ode_tpu_torch.core.collectives import all_reduce_sum
from vae_gp_ode_tpu_torch.dynamics.solvers import odeint
from vae_gp_ode_tpu_torch.gp.svgp import (SVGPParams, draw_fn_sample,
                                          sample_inducing)
from vae_gp_ode_tpu_torch.kernels import rbf as rbfk


@dataclasses.dataclass
class ShardedSample:
    """One pathwise sample whose RFF state is this rank's feature columns
    (`rff`: omega (D_in, S/R[, D_out]), phase (1, S/R[, D_out]), weights
    (S/R, D_out)); `nu` is replicated and `S` is the global feature
    count, which the prior's sqrt(var / S) scaling takes."""

    rff: rbfk.RFFState
    nu: torch.Tensor
    S: int


def _check_rbf(gp: SVGPParams):
    if gp.kernel_name != 'RBF':
        raise ValueError(
            f'feature parallelism supports the RBF kernel only (got '
            f'{gp.kernel_name!r}): the DF kernel couples outputs through '
            f'its (M*D, M*D) gram and ORFF weights, which do not split '
            f'over the feature axis without a distributed Cholesky')


def _features(S, group):
    world = dist.get_world_size(group)
    if S % world:
        raise ValueError(f'S={S} features do not split evenly over {world} '
                         f'ranks')
    n = S // world
    r = dist.get_rank(group)
    return slice(r * n, (r + 1) * n)


def _prior_partial(kernel, omega, phase, weights, xs, S_global):
    """This rank's partial prior term Phi_shard(xs) w_shard, scaled by
    sqrt(var / S_global) (the global count: the sum of the partials is
    the full-S eval)."""
    var = rbfk.rbf_variance(kernel)
    if kernel.dimwise:
        xo = torch.einsum('nd,dfk->nfk', xs, omega)
        phi = torch.cos(xo + phase) * torch.sqrt(var / S_global)
        return torch.einsum('nfk,fk->nk', phi, weights)
    phi = torch.cos(xs @ omega + phase) * torch.sqrt(var / S_global)
    return phi @ weights


def _slice_rff(rff, cols):
    """The feature columns `cols` of an RFF state (omega, phase: axis 1)."""
    return rbfk.RFFState(omega=rff.omega[:, cols], phase=rff.phase[:, cols],
                         weights=rff.weights[cols])


def shard_sample(sample, group=None):
    """This rank's feature columns of a whole one-draw pathwise sample
    (`gp.svgp.FnSample`), the layout `fp_fn_eval` takes."""
    S = sample.rff.weights.shape[0]
    return ShardedSample(rff=_slice_rff(sample.rff, _features(S, group)),
                         nu=sample.nu, S=S)


def fp_draw_fn_sample(gp: SVGPParams, generator, S, group=None,
                      local_draws=True):
    """Draw a pathwise sample whose RFF state is split over the ranks'
    feature columns; `generator` must be in the same state on every rank.

    With `local_draws` (default) each rank draws only its S / R columns,
    from a generator seeded by one draw of `generator` and its rank, so no
    rank holds all S columns: iid N(0, diag(1/ls^2)) like the one-rank
    draw, the same distribution but not the same bits. u ~ q(u) is drawn
    from `generator` on every rank (the same draw), the prior at Z is the
    all-reduced sum of the ranks' partials, and nu is solved replicated.

    `local_draws=False` draws the whole sample with `generator`, as
    `draw_fn_sample` does (the same bits), and keeps this rank's columns.
    Returns a `ShardedSample`.
    """
    _check_rbf(gp)
    cols = _features(S, group)
    if not local_draws:
        return shard_sample(draw_fn_sample(gp, generator, S), group)
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))
    rank_gen = torch.Generator(device=generator.device)
    rank_gen.manual_seed(seed + dist.get_rank(group))
    rff = rbfk.rbf_sample_rff(gp.kernel, rank_gen, cols.stop - cols.start,
                              gp.D_in, gp.D_out)
    Z = gp.inducing_loc
    u_prior = _prior_partial(gp.kernel, rff.omega, rff.phase, rff.weights,
                             Z, S)
    dist.all_reduce(u_prior, group=group)
    u = sample_inducing(gp, generator)
    nu = rbfk.rbf_compute_nu(gp.kernel, rbfk.rbf_gram(gp.kernel, Z), u_prior,
                             u)
    return ShardedSample(rff=rff, nu=nu, S=S)


def fp_fn_eval(gp: SVGPParams, sample: ShardedSample, x, group=None):
    """f(x) for x (N, D_in) with the feature columns split over the ranks:
    this rank's partial prior term, one all-reduce, and the replicated
    pathwise update. The all-reduce is differentiable."""
    part = _prior_partial(gp.kernel, sample.rff.omega, sample.rff.phase,
                          sample.rff.weights, x, sample.S)
    return all_reduce_sum(part, group) + rbfk.rbf_f_update(
        gp.kernel, sample.nu, x, gp.inducing_loc)


def fp_flow_forward(gp: SVGPParams, sample: ShardedSample, z0, ts,
                    group=None, order=1, solver='euler', dense=1, rtol=1e-6,
                    atol=1e-6, max_steps=256):
    """Integrate z0 (N, D) over ts (T,) with every RHS evaluation
    feature-parallel (one all-reduce per evaluation): `dynamics.flow`'s
    flow_forward semantics, without rematerialisation (recomputing a step
    in the backward pass would issue its collectives again). Returns
    (zs (N, T, D), nfe)."""
    if order == 2:
        def rhs(t, z):
            q = z.shape[-1] // 2
            return torch.cat([z[..., q:], fp_fn_eval(gp, sample, z, group)],
                             dim=-1)
    elif order == 1:
        def rhs(t, z):
            return fp_fn_eval(gp, sample, z, group)
    else:
        raise ValueError(f'ODE order must be 1 or 2, got {order}')
    sol = odeint(rhs, z0, ts, method=solver, dense=dense, rtol=rtol,
                 atol=atol, max_steps=max_steps, remat=False)
    return sol.zs.transpose(0, 1), sol.nfe
