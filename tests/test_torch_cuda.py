"""Tests of the port's CUDA kernels; they need an NVIDIA GPU and nvcc and
skip without them. Run on a GPU machine from the repository root with

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

The file imports no JAX (the GPU machine has none): each kernel is held
against its plain PyTorch version on the card. Tolerances: the trajectory
abs 1e-4 + rel 1e-4, f32 through up to 15 euler steps summed in another
order; each adjoint cotangent 1e-4 (1 + its largest plain entry), sums
over up to 300 rows, 15 steps and 1536 columns in another order. The
per-step eval and its VJP: the same two tolerances (sums over up to 600
rows and 12288 feature columns). The divergence-free kernels #5-#8: the
same two tolerances (sums over up to 6144 feature columns, 100 inducing
points and 36 output-dim pairs). The grid-tiled kernels #9-#12: the same
two tolerances (sums over up to 12288 feature columns, in per-block
partials summed by the wrapper).
"""

import ctypes

import numpy as np
import pytest
import torch

from vae_gp_ode_tpu_torch import ops
from vae_gp_ode_tpu_torch.core.transforms import invsoftplus
from vae_gp_ode_tpu_torch.gp.svgp import draw_fn_sample, init_svgp_params
from vae_gp_ode_tpu_torch.models.odegpvae import init_model
from vae_gp_ode_tpu_torch.ops import (
    df_flow_fused, df_pathwise, df_pathwise_tiled, flow_fused, pathwise,
    pathwise_tiled,
)
from vae_gp_ode_tpu_torch.ops.pathwise import rbf_fused_operands
from vae_gp_ode_tpu_torch.serving import make_forecast_fn
from vae_gp_ode_tpu_torch.training import trainer

pytestmark = pytest.mark.gpu

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    return torch.device('cuda')


def _packed(dev, q, order, N, L, S=256, M=100, seed=0):
    rng = np.random.default_rng(seed)
    gp = init_svgp_params(rng, q * order, q, M, lengthscale=2.0,
                          variance=0.7, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sample = draw_fn_sample(gp, gen, S, L=L)
    packed = flow_fused._pack_operands(*rbf_fused_operands(gp, sample))
    z0 = torch.randn(N, q * order, generator=gen, device=dev)
    return z0, packed, gen


@pytest.mark.parametrize('order,N,L', [(1, 20, 5), (2, 20, 5), (1, 300, 2),
                                       (1, 3, 1)])
def test_kernel_matches_plain(cuda, order, N, L):
    """The trajectory kernel against its plain version; two launches give
    the same bits, and it takes the adjoint's plan (4-block clusters of 2
    rows at N=20, L=5 on an H100's 132 SMs)."""
    T = 16
    z0, packed, gen = _packed(cuda, 6, order, N, L)
    dts = torch.rand(T - 1, generator=gen, device=cuda) * 0.15 + 0.05
    with torch.no_grad():
        out = flow_fused.packed_euler_flow(z0, *packed, dts, T, order)
        again = flow_fused.packed_euler_flow(z0, *packed, dts, T, order)
        ref = flow_fused.packed_flow_reference(z0, *packed, dts, T, order)
    torch.cuda.synchronize()
    assert out.shape == (L, T, N, 6 * order)
    torch.testing.assert_close(out, ref, **TOL)
    assert torch.equal(out, again)
    shape = (L, N, 6 * order, 6, 256, 100, order)
    plan = flow_fused.fwd_plan(*shape, cuda)
    assert plan == flow_fused.bwd_plan(*shape, cuda)
    if (N, L) == (20, 5) and torch.cuda.get_device_properties(
            cuda).multi_processor_count == 132:
        assert plan == (2, 4, 10)


def test_kernel_single_draw_and_shared_operands(cuda):
    """Operands without a leading draw dim give (T, N, D)."""
    T = 8
    z0, packed, gen = _packed(cuda, 6, 1, 20, 1)
    packed = tuple(p[0] if p.dim() == 3 else p for p in packed)
    dts = torch.full((T - 1,), 0.1, device=cuda)
    with torch.no_grad():
        out = flow_fused.packed_euler_flow(z0, *packed, dts, T, 1)
        ref = flow_fused.packed_flow_reference(z0, *packed, dts, T, 1)
    assert out.shape == (T, 20, 6)
    torch.testing.assert_close(out, ref, **TOL)


def test_kernel_counts_launches_and_rejects_bad_inputs(cuda):
    T = 8
    z0, packed, _ = _packed(cuda, 6, 1, 20, 2)
    dts = torch.full((T - 1,), 0.1, device=cuda)
    before = ops.LAUNCHES['flow_fused_fwd']
    with torch.no_grad():
        flow_fused.packed_euler_flow(z0, *packed, dts, T, 1)
    assert ops.LAUNCHES['flow_fused_fwd'] == before + 1
    with pytest.raises(TypeError, match='float32'):
        flow_fused.packed_euler_flow(z0.double(), *packed, dts, T, 1)
    with pytest.raises(ValueError, match='contiguous'):
        flow_fused.packed_euler_flow(z0.T.contiguous().T, *packed, dts, T, 1)
    with pytest.raises(ValueError, match='dts'):
        flow_fused.packed_euler_flow(z0, *packed, dts[:-1], T, 1)
    with pytest.raises(ValueError, match='z0 on'):
        flow_fused.packed_euler_flow(z0, *packed, dts.cpu(), T, 1)
    assert ops.LAUNCHES['flow_fused_fwd'] == before + 1
    # inputs that require grad: the forward kernel, and reverse mode
    # through the adjoint kernel, once each
    inputs = [x.clone().requires_grad_() for x in (z0, *packed)]
    bwd = ops.LAUNCHES['flow_fused_bwd']
    zs = flow_fused.packed_euler_flow(*inputs, dts, T, 1)
    grads = torch.autograd.grad(zs.sum(), inputs)
    assert ops.LAUNCHES['flow_fused_fwd'] == before + 2
    assert ops.LAUNCHES['flow_fused_bwd'] == bwd + 1
    ref = flow_fused.packed_flow_vjp_reference(
        zs.detach(), torch.ones_like(zs), *packed, dts, T, 1)
    _assert_cotangents(grads, (ref[0].sum(0),) + tuple(ref[1:-1]))


def _assert_cotangents(out, ref):
    for i, (a, b) in enumerate(zip(out, ref)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        err = float((a - b).abs().max())
        assert err <= 1e-4 * (1.0 + float(b.abs().max())), (i, err)


@pytest.mark.parametrize('order,N,L,uniform,z0_per_draw', [
    (1, 20, 1, True, False), (1, 20, 5, True, False),
    (1, 20, 5, True, True), (2, 20, 5, False, False),
    (1, 300, 5, True, False)])
def test_adjoint_kernel_matches_plain(cuda, order, N, L, uniform,
                                      z0_per_draw):
    """The adjoint kernel, through the autograd Function as the train step
    runs it, against autograd through the plain version, at the shapes of
    chip_smoke.py's kernel phase (z0 shared by the draws gets their
    sum)."""
    T = 16
    z0, packed, gen = _packed(cuda, 6, order, N, L)
    if z0_per_draw:
        z0 = torch.randn((L,) + z0.shape, generator=gen, device=cuda)
    dts = (torch.full((T - 1,), 0.1, device=cuda) if uniform else
           torch.rand(T - 1, generator=gen, device=cuda) * 0.15 + 0.05)
    inputs = [x.clone().requires_grad_() for x in (z0, *packed, dts)]
    before = ops.LAUNCHES['flow_fused_bwd']
    zs = flow_fused.packed_euler_flow(*inputs, T, order)
    zsbar = torch.randn(zs.shape, generator=gen, device=cuda)
    out = torch.autograd.grad(zs, inputs, zsbar)
    torch.cuda.synchronize()
    assert ops.LAUNCHES['flow_fused_bwd'] == before + 1
    ref = list(flow_fused.packed_flow_vjp_reference(
        zs.detach(), zsbar, *packed, dts, T, order))
    if not z0_per_draw:
        ref[0] = ref[0].sum(0)
    _assert_cotangents(out, ref)
    # two launches (the adjoint and its summing kernel) give the same bits
    again = torch.autograd.grad(flow_fused.packed_euler_flow(
        *inputs, T, order), inputs, zsbar)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    # the kernel's own wrapper, same arguments as the plain version
    vjp = flow_fused.packed_flow_vjp(zs.detach(), zsbar, *packed, dts, T,
                                     order)
    _assert_cotangents(vjp, flow_fused.packed_flow_vjp_reference(
        zs.detach(), zsbar, *packed, dts, T, order))


def test_train_step_launches_each_kernel_once(cuda):
    """One full-width train step (q=6, n_filt=8, S=256, M=100, batch 20,
    T=16, L=5): one trajectory launch, one adjoint launch, finite
    metrics."""
    model, gp = init_model(0, device='cuda')
    with torch.no_grad():       # main.py's --lengthscale 2.0 --variance 0.7
        gp.kernel.unconstrained_lengthscales.fill_(
            float(invsoftplus(torch.tensor(2.0))))
        gp.kernel.unconstrained_variance.fill_(
            float(invsoftplus(torch.tensor(0.7))))
    state = trainer.create_train_state(model, gp)
    step = trainer.make_train_step(360.0, eps_guard=True)
    X = (torch.rand(20, 16, 1, 28, 28, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda) - 0.1307) / 0.3081
    before = dict(ops.LAUNCHES)
    metrics = step(state, X, 5)
    torch.cuda.synchronize()
    assert ops.LAUNCHES['flow_fused_fwd'] == before['flow_fused_fwd'] + 1
    assert ops.LAUNCHES['flow_fused_bwd'] == before['flow_fused_bwd'] + 1
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    assert int(state.step) == 1 and int(metrics['nfe']) == 5 * 15


def test_forecaster_runs_through_the_kernel(cuda):
    model, gp = init_model(0, device='cuda', lengthscale=2.0, variance=0.7)
    fn = make_forecast_fn(model, None, gp, L=5, T_custom=32,
                          normalize_input=True, device='cuda')
    X = np.random.default_rng(1).random((20, 16, 1, 28, 28)).astype(
        np.float32)
    before = ops.LAUNCHES['flow_fused_fwd']
    out = fn(X, 0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES['flow_fused_fwd'] == before + 1
    assert out.shape == (5, 20, 32, 1, 28, 28)
    assert torch.isfinite(out).all()
    # the same forward on the CPU, plain version, same noise
    cpu_fn = make_forecast_fn(model, None, gp, L=5, T_custom=32,
                              normalize_input=True, device='cpu')
    rng = np.random.default_rng(2)
    noise = {'z0': rng.standard_normal((20, 6)),
             'omega': rng.standard_normal((5, 6, 256, 6)),
             'phase_u': rng.random((5, 1, 256, 6)),
             'weights': rng.standard_normal((5, 256, 6)),
             'epsilon': rng.standard_normal((5, 100, 6))}
    noise = {k: torch.as_tensor(v, dtype=torch.float32)
             for k, v in noise.items()}
    cpu_out = cpu_fn(X, 0, noise=noise)
    fn = make_forecast_fn(model, None, gp, L=5, T_custom=32,
                          normalize_input=True, device='cuda')
    gpu_out = fn(X, 0, noise={k: v.to(cuda) for k, v in noise.items()})
    torch.testing.assert_close(gpu_out.cpu(), cpu_out, **TOL)


# -- the per-step eval (kernel #3) and its VJP (kernel #4) -------------------

def _pathwise_operands(dev, L, N, D, K, S, M=100, seed=0):
    rng = np.random.default_rng(seed)
    gp = init_svgp_params(rng, D, K, M, lengthscale=2.0, variance=0.7,
                          device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        operands = rbf_fused_operands(gp, draw_fn_sample(gp, gen, S, L=L))
    return torch.randn((L, N, D), generator=gen, device=dev), operands, gen


@pytest.mark.parametrize('L,N,D,K,S', [
    (1, 20, 6, 6, 256), (5, 20, 6, 6, 256), (5, 20, 12, 6, 256),
    (5, 600, 6, 6, 256), (5, 20, 6, 6, 2048), (5, 20, 12, 12, 256),
    (2, 3, 1, 1, 1), (2, 33, 7, 5, 30), (1, 1, 12, 12, 1024)])
def test_pathwise_kernels_match_plain(cuda, L, N, D, K, S):
    """#3 and #4 against the plain version, among them N = 33 (past a row
    tile), K other than D, D = 1, 7, short item lists (#3's blocks of
    their own) and long ones (#3's clusters); two launches of #3 on the
    same inputs give the same bits."""
    x, operands, gen = _pathwise_operands(cuda, L, N, D, K, S)
    before = dict(ops.LAUNCHES)
    with torch.no_grad():
        out = pathwise.fused_pathwise_eval(x, *operands)
        again = pathwise.fused_pathwise_eval(x, *operands)
        ref = pathwise.pathwise_eval_reference(x, *operands)
    torch.cuda.synchronize()
    assert ops.LAUNCHES['pathwise_fwd'] == before['pathwise_fwd'] + 2
    torch.testing.assert_close(out, ref, **TOL)
    assert torch.equal(out, again)
    inputs = [t.clone().requires_grad_() for t in (x,) + operands]
    out = pathwise.fused_pathwise_eval(*inputs)
    g = torch.randn(out.shape, generator=gen, device=cuda)
    grads = torch.autograd.grad(out, inputs, g)
    torch.cuda.synchronize()
    assert ops.LAUNCHES['pathwise_bwd'] == before['pathwise_bwd'] + 1
    _assert_cotangents(grads, pathwise.pathwise_vjp_reference(
        x, *operands, g))


# (L, N, D, K, S) at which #3's launcher picks each instance on an H100
# (132 SMs, M = 100): direct; one block of 4 rows staging two rounds; one
# block of 8 rows; clusters of 3 and 8 blocks of 4 rows, of 3 of 8 rows
@pytest.mark.parametrize('plan', [
    (2, 37, 6, 5, 90), (1, 20, 6, 1, 400), (2, 60, 6, 5, 90),
    (1, 20, 6, 1, 800), (1, 20, 6, 12, 700), (2, 60, 6, 1, 700)])
def test_pathwise_fwd_plans_on_the_card(cuda, plan):
    """#3 at shapes where its launcher picks each instance, staged and
    direct, with and without a cluster, against the plain version."""
    x, operands, _ = _pathwise_operands(cuda, *plan)
    with torch.no_grad():
        out = pathwise.fused_pathwise_eval(x, *operands)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, pathwise.pathwise_eval_reference(
        x, *operands), **TOL)


def test_pathwise_kernels_per_draw_gp_operands_and_no_draw_dim(cuda):
    """Z, ls and var per draw (the continuous adjoint's layout) give
    per-draw cotangents; operands without a draw dim give (N, K)."""
    L = 3
    x, operands, gen = _pathwise_operands(cuda, L, 20, 6, 6, 256)
    per = list(operands)
    for i in (3, 5, 6):
        per[i] = (operands[i].expand((L,) + tuple(operands[i].shape))
                  * (1.0 + 0.1 * torch.arange(L, device=cuda).reshape(
                      (L,) + (1,) * operands[i].dim()))).contiguous()
    g = torch.randn((L, 20, 6), generator=gen, device=cuda)
    inputs = [t.clone().requires_grad_() for t in [x] + per]
    got = torch.autograd.grad(pathwise.fused_pathwise_eval(*inputs), inputs,
                              g)
    assert got[4].shape == per[3].shape and got[7].shape == per[6].shape
    _assert_cotangents(got, pathwise.pathwise_vjp_reference(x, *per, g))
    one = [t[0] if t.dim() > nd else t for t, nd in zip(
        operands, pathwise._BASE_DIMS)]
    with torch.no_grad():
        out = pathwise.fused_pathwise_eval(x[0], *one)
    assert out.shape == (20, 6)
    torch.testing.assert_close(out, pathwise.pathwise_eval_reference(
        x[0], *one), **TOL)
    with pytest.raises(TypeError, match='float32'):
        pathwise.fused_pathwise_eval(x.double(), *operands)


def _bwd_smem_bytes(D, K, S, M, T):
    """The bound of the fused pair's rule, csrc/flow_fused_bwd.cu's
    `rule_bytes`, transcribed (as in tests/test_torch_flow.py): the parent
    adjoint block's shared memory, or a block of the new adjoint's 8-block
    cluster where that were more."""
    KS, KM = K * S, K * M
    slab = D * KS + 2 * KS + 2 * D * KM + 2 * KM + (T - 1)
    parent = 4 * (slab + 3 * 4 * D + 16 * (4 * D + 1))
    R = 4 if D <= 8 else 2
    items = -(-KS // 8) + -(-KM // 8)
    V = R * D + 1
    block8 = 4 * (2 * (2 * D + 2) * items + 3 * R * D + 8 * V + 2 * V)
    return max(parent, block8)


@pytest.mark.parametrize('order,q,S,fits', [
    (1, 6, 256, True), (1, 6, 1024, True), (1, 6, 2048, False),
    (1, 12, 256, False), (2, 8, 256, False), (1, 12, 1024, False)])
def test_fused_pair_rule_on_the_card(cuda, order, q, S, fits):
    """The adjoint library's exported bound is the formula the CPU tests
    hold the rule to, and the rule decides as they do on an H100 (232,448
    bytes of opt-in shared memory per block)."""
    lib = flow_fused._bwd_lib()
    D = q * order
    assert lib.flow_fused_bwd_smem_bytes(D, q, S, 100, 16) == \
        _bwd_smem_bytes(D, q, S, 100, 16)
    assert flow_fused.fused_pair_fits(D, q, S, 100, 16, cuda) == fits


def test_rk4_and_wide_train_steps_take_the_per_step_kernels(cuda):
    """A full-width train step with solver='rk4', and one at S=2048 with
    euler (which the fused pair refuses), launch the per-step kernels that
    the dispatch rule names and never the fused pair; losses finite."""
    for kw in (dict(solver='rk4'), dict(num_features=2048)):
        model, gp = init_model(0, device='cuda', lengthscale=2.0,
                               variance=0.7, **kw)
        state = trainer.create_train_state(model, gp)
        step = trainer.make_train_step(360.0, eps_guard=True)
        X = (torch.rand(20, 16, 1, 28, 28, generator=torch.Generator(
            device=cuda).manual_seed(0), device=cuda) - 0.1307) / 0.3081
        before = dict(ops.LAUNCHES)
        metrics = step(state, X, 5)
        torch.cuda.synchronize()
        d = {k: ops.LAUNCHES[k] - before[k] for k in before}
        assert d['flow_fused_fwd'] == d['flow_fused_bwd'] == 0, (kw, d)
        fwd, bwd = pathwise_tiled.rule_kernels(
            5, 20, 6, 6, kw.get('num_features', 256), 100, cuda)
        assert d[fwd] > 0 and d[bwd] > 0, (kw, d)
        assert sum(d.values()) == d[fwd] + d[bwd], (kw, d)
        assert all(bool(torch.isfinite(v).all()) for v in metrics.values())


# -- the divergence-free kernels #5-#8 ---------------------------------------

def _df_operands(dev, L, N, q=6, S=256, M=100, seed=0, ls=2.0):
    """A DF GP at main.py's --lengthscale/--variance and L draws of its
    sample: (x (L, N, q), the operands of df_fused_operands, gen)."""
    rng = np.random.default_rng(seed)
    gp = init_svgp_params(rng, q, q, M, kernel='DF', lengthscale=ls,
                          variance=0.7, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        operands = df_pathwise.df_fused_operands(
            gp, draw_fn_sample(gp, gen, S, L=L))
    return torch.randn((L, N, q), generator=gen, device=dev), operands, gen


@pytest.mark.parametrize('L,N,q,S,ls', [
    (1, 20, 6, 256, 2.0), (5, 20, 6, 256, 2.0), (5, 600, 6, 256, 2.0),
    (5, 20, 3, 256, 0.5), (5, 20, 6, 1024, 2.0), (2, 20, 12, 64, 2.0),
    (2, 3, 3, 1, 0.5)])
def test_df_pathwise_kernels_match_plain(cuda, L, N, q, S, ls):
    """Kernels #5/#6 against the plain version and autograd through it,
    one launch each; D = 12 takes the 2-row, DMAX = 16 instantiation. At
    q = 3 the lengthscale is 0.5: at 2.0 the gram of 100 inducing points
    in 3-D is so ill-conditioned that |nu| reaches 7e4 and f is a sum of
    terms 1e4 times larger than itself, in any summation order."""
    x, operands, gen = _df_operands(cuda, L, N, q, S, ls=ls)
    assert not any(bool(torch.isnan(t).any()) for t in operands)
    before = dict(ops.LAUNCHES)
    with torch.no_grad():
        out = df_pathwise.fused_df_pathwise_eval(x, *operands)
        ref = df_pathwise.df_pathwise_reference(x, *operands)
    torch.cuda.synchronize()
    assert ops.LAUNCHES['df_pathwise_fwd'] == before['df_pathwise_fwd'] + 1
    torch.testing.assert_close(out, ref, **TOL)
    inputs = [t.clone().requires_grad_() for t in (x,) + operands]
    out = df_pathwise.fused_df_pathwise_eval(*inputs)
    g = torch.randn(out.shape, generator=gen, device=cuda)
    grads = torch.autograd.grad(out, inputs, g)
    torch.cuda.synchronize()
    assert ops.LAUNCHES['df_pathwise_bwd'] == before['df_pathwise_bwd'] + 1
    _assert_cotangents(grads, df_pathwise.df_pathwise_vjp_reference(
        x, *operands, g))


def test_df_pathwise_kernels_per_draw_gp_operands_and_no_draw_dim(cuda):
    """Z, ls2 and var per draw (the continuous adjoint's layout) give
    per-draw cotangents; operands without a draw dim give (N, D)."""
    L = 3
    x, operands, gen = _df_operands(cuda, L, 20)
    per = list(operands)
    for i in (3, 5, 6):
        per[i] = (operands[i].expand((L,) + tuple(operands[i].shape))
                  * (1.0 + 0.1 * torch.arange(L, device=cuda).reshape(
                      (L,) + (1,) * operands[i].dim()))).contiguous()
    g = torch.randn((L, 20, 6), generator=gen, device=cuda)
    inputs = [t.clone().requires_grad_() for t in [x] + per]
    got = torch.autograd.grad(df_pathwise.fused_df_pathwise_eval(*inputs),
                              inputs, g)
    assert got[4].shape == per[3].shape and got[7].shape == per[6].shape
    _assert_cotangents(got, df_pathwise.df_pathwise_vjp_reference(
        x, *per, g))
    one = [t[0] if t.dim() > nd else t for t, nd in zip(
        operands, df_pathwise.BASE_DIMS)]
    with torch.no_grad():
        out = df_pathwise.fused_df_pathwise_eval(x[0], *one)
    assert out.shape == (20, 6)
    torch.testing.assert_close(out, df_pathwise.df_pathwise_reference(
        x[0], *one), **TOL)
    with pytest.raises(TypeError, match='float32'):
        df_pathwise.fused_df_pathwise_eval(x.double(), *operands)


@pytest.mark.parametrize('N,L,q,S,uniform,z0_per_draw', [
    (20, 1, 6, 256, True, False), (20, 5, 6, 256, True, False),
    (20, 5, 6, 256, False, True), (300, 5, 6, 256, True, False),
    (20, 2, 12, 64, False, False)])
def test_df_flow_kernels_match_plain(cuda, N, L, q, S, uniform,
                                     z0_per_draw):
    """Kernels #7/#8 through the autograd Function (as the train step runs
    them) against the plain version and autograd through it, at T=16;
    z0 shared by the draws gets their sum; q = 12 at S = 64 runs the
    adjoint's two-row instances."""
    T = 16
    z0, operands, gen = _df_operands(cuda, L, N, q, S)
    z0 = z0 if z0_per_draw else z0[0]
    dts = (torch.full((T - 1,), 0.1, device=cuda) if uniform else
           torch.rand(T - 1, generator=gen, device=cuda) * 0.15 + 0.05)
    before = dict(ops.LAUNCHES)
    with torch.no_grad():
        zs = df_flow_fused.packed_df_euler_flow(z0, *operands, dts, T)
        ref = df_flow_fused.df_euler_flow_reference(z0, *operands, dts, T)
    torch.cuda.synchronize()
    assert zs.shape == (L, T, N, q)
    torch.testing.assert_close(zs, ref, **TOL)
    inputs = [t.clone().requires_grad_() for t in (z0, *operands, dts)]
    zs = df_flow_fused.packed_df_euler_flow(*inputs, T)
    zsbar = torch.randn(zs.shape, generator=gen, device=cuda)
    out = torch.autograd.grad(zs, inputs, zsbar)
    torch.cuda.synchronize()
    assert ops.LAUNCHES['df_flow_fused_fwd'] == \
        before['df_flow_fused_fwd'] + 2
    assert ops.LAUNCHES['df_flow_fused_bwd'] == \
        before['df_flow_fused_bwd'] + 1
    ref = list(df_flow_fused.df_flow_vjp_reference(
        zs.detach(), zsbar, *operands, dts, T))
    if not z0_per_draw:
        ref[0] = ref[0].sum(0)
    _assert_cotangents(out, ref)
    vjp = df_flow_fused.df_flow_vjp(zs.detach(), zsbar, *operands, dts, T)
    _assert_cotangents(vjp, df_flow_fused.df_flow_vjp_reference(
        zs.detach(), zsbar, *operands, dts, T))


def _df_bwd_smem_bytes(D, S, M):
    """csrc/df_flow_fused_bwd.cu's df_flow_fused_bwd_smem_bytes, transcribed (as in
    tests/test_torch_df.py):
    one block of an 8-block cluster at the most rows per cluster (4 up to
    D = 8, else 2) holds 2 (3D + 1) floats for each item of its share
    (ceil(S D / 8) feature columns and ceil(M / 8) points of D items
    each), the rows' g, z_t and zsbar, 1/ls2 | var and its ls2 | var sums,
    and the warps' and the block's partial sums of R D + 1 values."""
    R = 4 if D <= 8 else 2
    IB = -(-S * D // 8) + -(-M // 8) * D
    RD, V = R * D, R * D + 1
    return 4 * (2 * (3 * D + 1) * IB + 3 * RD + 2 * (D * D + D) + 8 * V
                + 2 * V)


@pytest.mark.parametrize('D,S,fits', [(6, 256, True), (6, 512, True),
                                      (6, 2048, False), (12, 256, True),
                                      (16, 256, False), (3, 1024, True)])
def test_df_pair_rule_on_the_card(cuda, D, S, fits):
    """The DF pair's exported shared-memory needs (the trajectory kernel's
    and the adjoint's) are the formulas the CPU tests hold the rule to,
    and the rule decides as they do on an H100."""
    lib = df_flow_fused._bwd_lib()
    assert lib.df_flow_fused_bwd_smem_bytes(D, S * D, 100) == \
        _df_bwd_smem_bytes(D, S, 100)
    RD = (4 if D <= 8 else 2) * D
    assert df_flow_fused._lib().df_flow_fused_fwd_smem_bytes(D) == 4 * (
        11 * RD + D * D + D)
    assert df_flow_fused.df_fused_pair_fits(D, S * D, 100, cuda) == fits


def test_df_train_steps_launch_their_kernels(cuda):
    """Full-width DF train steps (q=6, S=256, M=100, batch 20, T=16, L=5):
    euler launches #7 and #8 once and nothing else; rk4, and euler at
    S=2048 (which the pair refuses), go through the per-step kernels that
    the dispatch rule names and never #7/#8; losses finite."""
    X = (torch.rand(20, 16, 1, 28, 28, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda) - 0.1307) / 0.3081
    for kw, pair in ((dict(), True), (dict(solver='rk4'), False),
                     (dict(num_features=2048), False)):
        model, gp = init_model(0, device='cuda', kernel='DF',
                               lengthscale=2.0, variance=0.7, **kw)
        state = trainer.create_train_state(model, gp)
        step = trainer.make_train_step(360.0, eps_guard=True)
        before = dict(ops.LAUNCHES)
        metrics = step(state, X, 5)
        torch.cuda.synchronize()
        d = {k: ops.LAUNCHES[k] - before[k] for k in before}
        if pair:
            assert d == {k: int(k in ('df_flow_fused_fwd',
                                      'df_flow_fused_bwd')) for k in d}, d
        else:
            fwd, bwd = df_pathwise_tiled.rule_kernels(
                5, 20, 6, 6 * kw.get('num_features', 256), 100, cuda)
            assert d[fwd] > 0 and d[bwd] > 0, (kw, d)
            assert sum(d.values()) == d[fwd] + d[bwd], (kw, d)
        assert all(bool(torch.isfinite(v).all()) for v in metrics.values())


# -- the grid-tiled kernels #9-#12 and the dispatch rule ----------------

@pytest.mark.parametrize('L,N,D,K,S', [
    (5, 20, 12, 12, 1024), (1, 600, 6, 6, 1000), (5, 20, 6, 6, 256),
    (2, 33, 7, 5, 30), (1, 1, 1, 1, 3), (5, 160, 6, 6, 256)])
def test_tiled_pathwise_kernels_match_plain(cuda, L, N, D, K, S):
    """#9 and #10 against the plain version (S=1000 and 30: ragged last
    chunks; N = 33 past one of #10's 32-row tiles, K other than D, D = 1
    and 7); two launches of #10 on the same inputs give the same bits."""
    x, operands, gen = _pathwise_operands(cuda, L, N, D, K, S)
    before = dict(ops.LAUNCHES)
    with torch.no_grad():
        out = pathwise_tiled.tiled_pathwise_eval(x, *operands)
    torch.cuda.synchronize()
    assert ops.LAUNCHES['pathwise_tiled_fwd'] == \
        before['pathwise_tiled_fwd'] + 1
    torch.testing.assert_close(out, pathwise.pathwise_eval_reference(
        x, *operands), **TOL)
    inputs = [t.clone().requires_grad_() for t in (x,) + operands]
    out = pathwise_tiled.tiled_pathwise_eval(*inputs)
    g = torch.randn(out.shape, generator=gen, device=cuda)
    grads = torch.autograd.grad(out, inputs, g)
    torch.cuda.synchronize()
    assert ops.LAUNCHES['pathwise_tiled_bwd'] == \
        before['pathwise_tiled_bwd'] + 1
    _assert_cotangents(grads, pathwise.pathwise_vjp_reference(
        x, *operands, g))
    again = torch.autograd.grad(pathwise_tiled.tiled_pathwise_eval(
        *inputs), inputs, g)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def test_tiled_pathwise_vjp_per_draw_gp_operands_and_layouts(cuda):
    """#10 with Z, ls and var per draw gives per-draw cotangents, and
    without a draw dim the operands' own shapes."""
    L = 3
    x, operands, gen = _pathwise_operands(cuda, L, 20, 6, 6, 256)
    per = list(operands)
    for i in (3, 5, 6):
        per[i] = (operands[i].expand((L,) + tuple(operands[i].shape))
                  * (1.0 + 0.1 * torch.arange(L, device=cuda).reshape(
                      (L,) + (1,) * operands[i].dim()))).contiguous()
    g = torch.randn((L, 20, 6), generator=gen, device=cuda)
    inputs = [t.clone().requires_grad_() for t in [x] + per]
    got = torch.autograd.grad(pathwise_tiled.tiled_pathwise_eval(*inputs),
                              inputs, g)
    assert got[4].shape == per[3].shape and got[7].shape == per[6].shape
    _assert_cotangents(got, pathwise.pathwise_vjp_reference(x, *per, g))
    one = [t[0] if t.dim() > nd else t for t, nd in zip(
        operands, pathwise._BASE_DIMS)]
    inputs = [t.clone().requires_grad_() for t in [x[0]] + one]
    out = pathwise_tiled.tiled_pathwise_eval(*inputs)
    assert out.shape == (20, 6)
    got = torch.autograd.grad(out, inputs, g[0])
    _assert_cotangents(got, pathwise.pathwise_vjp_reference(x[0], *one,
                                                            g[0]))


@pytest.mark.parametrize('L,N,q,S,ls', [
    (5, 20, 12, 1024, 2.0), (1, 600, 6, 100, 2.0), (5, 20, 16, 64, 2.0),
    (3, 7, 7, 40, 2.0), (1, 1, 6, 45, 2.0), (2, 21, 12, 23, 2.0),
    (2, 5, 3, 9, 0.5)])
def test_tiled_df_pathwise_kernels_match_plain(cuda, L, N, q, S, ls):
    """#11 and #12 against the plain version, one launch each: the wide
    shape, N = 600 (one ragged feature chunk), D = 16 and D = 7 and 3 (the
    generic instance of #12; D = 6 and 12 have their own), N = 1, and
    feature columns, inducing points and rows that leave ragged last
    chunks; two launches on the same inputs give the same bits."""
    x, operands, gen = _df_operands(cuda, L, N, q=q, S=S, ls=ls)
    before = dict(ops.LAUNCHES)
    with torch.no_grad():
        out = df_pathwise_tiled.tiled_df_pathwise_eval(x, *operands)
        again = df_pathwise_tiled.tiled_df_pathwise_eval(x, *operands)
    torch.cuda.synchronize()
    assert ops.LAUNCHES['df_pathwise_tiled_fwd'] == \
        before['df_pathwise_tiled_fwd'] + 2
    torch.testing.assert_close(out, df_pathwise.df_pathwise_reference(
        x, *operands), **TOL)
    assert torch.equal(out, again)
    inputs = [t.clone().requires_grad_() for t in (x,) + operands]
    out = df_pathwise_tiled.tiled_df_pathwise_eval(*inputs)
    g = torch.randn(out.shape, generator=gen, device=cuda)
    grads = torch.autograd.grad(out, inputs, g)
    torch.cuda.synchronize()
    assert ops.LAUNCHES['df_pathwise_tiled_bwd'] == \
        before['df_pathwise_tiled_bwd'] + 1
    _assert_cotangents(grads, df_pathwise.df_pathwise_vjp_reference(
        x, *operands, g))
    again = torch.autograd.grad(df_pathwise_tiled.tiled_df_pathwise_eval(
        *inputs), inputs, g)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def test_tiled_df_kernels_per_draw_gp_operands_and_layouts(cuda):
    """#11/#12 with Z, ls2 and var per draw give per-draw cotangents; the
    slab layouts the wrapper sizes are the ones the C launchers compute
    (they refuse any other)."""
    L = 3
    x, operands, gen = _df_operands(cuda, L, 20, q=12, S=64)
    per = list(operands)
    for i in (3, 5, 6):
        per[i] = (operands[i].expand((L,) + tuple(operands[i].shape))
                  * (1.0 + 0.05 * torch.arange(L, device=cuda).reshape(
                      (L,) + (1,) * operands[i].dim()))).contiguous()
    g = torch.randn((L, 20, 12), generator=gen, device=cuda)
    inputs = [t.clone().requires_grad_() for t in [x] + per]
    got = torch.autograd.grad(
        df_pathwise_tiled.tiled_df_pathwise_eval(*inputs), inputs, g)
    assert got[4].shape == per[3].shape and got[7].shape == per[6].shape
    _assert_cotangents(got, df_pathwise.df_pathwise_vjp_reference(
        x, *per, g))
    fwd, bwd = df_pathwise_tiled._lib(), df_pathwise_tiled._bwd_lib()
    lay = (ctypes.c_int * 3)()
    for N, D, SD, M in ((20, 12, 12288, 100), (20, 6, 1536, 100),
                        (1, 1, 1, 1), (600, 16, 272, 17), (7, 7, 280, 37),
                        (20, 20, 5120, 100), (20, 64, 16384, 100),
                        (3, 260, 1040, 10)):
        assert fwd.df_pathwise_tiled_fwd_slots(SD, M, D) == \
            df_pathwise_tiled.fwd_slots(SD, M, D)
        bwd.df_pathwise_tiled_bwd_layout(N, D, SD, M, lay)
        assert tuple(lay) == df_pathwise_tiled.bwd_layout(N, D, SD, M)


def test_rule_at_the_wide_shapes_on_the_card(cuda):
    """The card's own SM count and shared-memory opt-in give the choices
    the rule was fixed with, and #10's exported shared-memory need is the
    formula the rule uses; at the wide configuration (q=12, S=1024, batch
    20) a train step launches #3 and #10 (RBF) or #11 and #12 (DF): the
    VJP once per euler step (15), the forward twice (the solver's remat
    evaluates each step again in the backward pass)."""
    assert ops.card_properties(cuda) == (132, 232448)
    lib = pathwise_tiled._bwd_lib()
    assert lib.pathwise_tiled_bwd_smem_optin(cuda.index or 0) == 232448
    for D in (6, 12, 65, 66):
        assert lib.pathwise_tiled_bwd_smem_bytes(D) == \
            pathwise_tiled.tiled_bwd_smem_bytes(D)
    X = (torch.rand(20, 16, 1, 28, 28, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda) - 0.1307) / 0.3081
    for kernel, want in (('RBF', ('pathwise_fwd', 'pathwise_tiled_bwd')),
                         ('DF', ('df_pathwise_tiled_fwd',
                                 'df_pathwise_tiled_bwd'))):
        assert (df_pathwise_tiled.rule_kernels(5, 20, 12, 12288, 100, cuda)
                if kernel == 'DF' else pathwise_tiled.rule_kernels(
                    5, 20, 12, 12, 1024, 100, cuda)) == want
        model, gp = init_model(0, device='cuda', kernel=kernel,
                               latent_dim=12, num_features=1024,
                               lengthscale=2.0, variance=0.7)
        state = trainer.create_train_state(model, gp)
        step = trainer.make_train_step(360.0, eps_guard=True)
        before = dict(ops.LAUNCHES)
        metrics = step(state, X, 5)
        torch.cuda.synchronize()
        d = {k: ops.LAUNCHES[k] - before[k] for k in before if
             ops.LAUNCHES[k] != before[k]}
        assert d == {want[0]: 30, want[1]: 15}, (kernel, d)
        assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
