#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vae_gp_ode_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--seed 0]

1. prints the card's name and power limit, builds every CUDA kernel of the
   paths with nvcc (all at once) and prints the build time;
2. builds the eval-mode forecaster at the main configuration's full width
   (rot-MNIST 28x28, q=6, n_filt=8, dimwise RBF with S=256 features and
   M=100 inducing points, euler dt=0.1, L=5 draws) with random weights
   and a random GP drawn from --seed;
3. holds each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and beside them (order 2, more than one row
   tile, a non-uniform grid; for the adjoint also L=1 and L=5, and z0
   per draw or shared by all draws), within the stated tolerances;
4. drives the forecaster path - three forecast requests of 20 sequences
   at T=16, one rollout at T=32 and one eval step with the ELBO - with
   every launch count set to 0 just before, and checks shapes,
   finiteness and that each request launched the trajectory kernel
   exactly once;
5. checks the GPU forward against the port's CPU forward on a small input
   with the same injected noise;
6. drives the training path: the training CLI's `run()` in-process at the
   default configuration of `main.py` (synthetic rot-MNIST, Ndata 360,
   batch 20, T=16, Adam lr 1e-3) for 2 epochs - 18 steps at L=1, 18 at
   L=5, the per-epoch monitoring eval - with the counts set to 0 just
   before, and checks that every step launched the trajectory kernel and
   its adjoint exactly once and that every loss is finite; then a
   checkpoint round trip (one more step from the restored and from the
   original state gives the same loss), two steps under
   `torch.cuda.set_sync_debug_mode('error')`, and one step's gradients on
   the GPU against the port's CPU step with the same noise;
7. times kernels, requests and train steps with CUDA events, and traces
   one request and one L=5 train step with torch.profiler (device kernels
   by time, the device's idle share);
8. prints one JSON line on the kernels and, as the last line,
   {"ok": true, "device": {...}}.

Any failure raises and the script exits non-zero without the last line;
a watchdog ends a hung run with a traceback. It needs CUDA and the rest
of the repository; it imports nothing of JAX.
"""

import argparse
import copy
import faulthandler
import json
import os
import subprocess
import sys
import time

WATCHDOG_S = 600
# kernel vs plain version, f32, through up to 31 euler steps: the two sum
# in different orders; measured differences are recorded in PERF.md
TOL_ABS = 1e-4
TOL_REL = 1e-4
# GPU vs CPU whole forward (cuDNN vs CPU convolutions, both full f32)
TOL_FORWARD = 1e-4
# adjoint kernel vs autograd through the plain version, per cotangent:
# |kernel - plain| <= TOL_BWD (1 + max |plain|); both sum over up to 300
# rows, 15 steps and 1536 columns in different orders
TOL_BWD = 1e-4
# GPU vs CPU train-step gradients, per leaf: |gpu - cpu| <= TOL_GRAD max
# |cpu| (cuDNN's f32 convolution gradients sum in another order)
TOL_GRAD = 1e-3
TRAIN_EPOCHS = 2

CONFIG = dict(latent_dim=6, n_filt=8, num_features=256, num_inducing=100,
              dt=0.1, lengthscale=2.0, variance=0.7)
L, BATCH, T, TROLL = 5, 20, 16, 2
H100_FP32_FLOPS = 67e12     # dense f32 outside the tensor cores (SXM)
H100_BYTES_PER_S = 3.35e12


def log(msg):
    print(msg, flush=True)


def require(ok, what):
    """Raise AssertionError(what) unless ok (kept under python -O)."""
    if not ok:
        raise AssertionError(what)


def nvidia_smi():
    res = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=3):
    """Mean milliseconds of fn() on the card, CUDA events over `reps`."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(out, ref, what):
    """max abs / rel error; raises if |out-ref| > TOL_ABS + TOL_REL |ref|."""
    import torch
    err = (out - ref).abs()
    max_abs = float(err.max())
    max_rel = float((err / (ref.abs() + TOL_ABS)).max())
    ok = bool(torch.isfinite(out).all()) and bool(
        (err <= TOL_ABS + TOL_REL * ref.abs()).all())
    log(f'  {what}: max abs err {max_abs:.3e}, max rel err {max_rel:.3e} '
        f'(tol abs {TOL_ABS:g} + rel {TOL_REL:g}) '
        f'{"ok" if ok else "FAILED"}')
    if not ok:
        raise AssertionError(f'{what}: kernel disagrees with its plain '
                             f'version (max abs err {max_abs:.3e})')
    return max_abs


def profile(fn, what):
    """Trace one call of fn() with torch.profiler: the device's kernels by
    self time, and the device's busy share of the span from its first
    kernel's start to its last kernel's end."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f'profile of {what}: the trace holds no device events')
        return
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels))
    log(f'profile of {what}: {len(kernels)} device kernels, busy '
        f'{busy_us / 1e3:.3f} ms of a {span_us / 1e3:.3f} ms span '
        f'(idle share {1 - busy_us / span_us:.3f})')
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f'  {t / 1e3:9.4f} ms  {n:4d}x  {name[:90]}')


def flow_bound(L_, N, D, K, S, M, T_):
    """Least time (ms) on an H100 for one trajectory launch: the larger of
    its f32 operations over the f32 peak and its bytes (each input read
    once, the output written once) over the memory rate."""
    per_row_step = K * S * (2 * D + 4) + K * M * (4 * D + 7) + 2 * D
    flops = L_ * N * (T_ - 1) * per_row_step
    draw_bytes = 4 * (D * K * S + 2 * K * S + K * M)       # omf, phf, ws, nus
    shared_bytes = 4 * (N * D + 2 * D * K * M + K * M + (T_ - 1))
    out_bytes = 4 * L_ * T_ * N * D
    nbytes = L_ * draw_bytes + shared_bytes + out_bytes
    t_ops = flops / H100_FP32_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')


def flow_bwd_bound(L_, N, D, K, S, M, T_, tensors):
    """Least time (ms) on an H100 for one adjoint launch: the larger of
    its f32 operations (recompute + VJP, per row and step
    K*S*(6D+12) + K*M*(12D+16)) over the f32 peak and the bytes of
    `tensors` (its inputs, each read once, and its outputs, each written
    once) over the memory rate."""
    per_row_step = K * S * (6 * D + 12) + K * M * (12 * D + 16)
    flops = L_ * N * (T_ - 1) * per_row_step
    nbytes = sum(4 * x.numel() for x in tensors)
    t_ops = flops / H100_FP32_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')


def compare_bwd(out, ref, what):
    """Per-cotangent max |kernel - plain| against TOL_BWD (1 + max
    |plain|); raises on a miss. Returns the largest error."""
    import torch
    names = ('z0', 'omf', 'phf', 'ws', 'Zb', 'zn', 'il2', 'nus', 'dts')
    parts, worst, ok = [], 0.0, True
    for name, a, b in zip(names, out, ref):
        if a.shape != b.shape:
            raise AssertionError(f'{what}: {name} cotangent has shape '
                                 f'{tuple(a.shape)}, expected '
                                 f'{tuple(b.shape)}')
        err = float((a - b).abs().max())
        lim = TOL_BWD * (1.0 + float(b.abs().max()))
        good = bool(torch.isfinite(a).all()) and err <= lim
        ok &= good
        worst = max(worst, err)
        parts.append(f'{name} {err:.2e}/{lim:.1e}{"" if good else " FAILED"}')
    log(f'  {what}: max |kernel - plain| / tol: ' + ', '.join(parts)
        + (' ok' if ok else ''))
    if not ok:
        raise AssertionError(f'{what}: the adjoint kernel disagrees with '
                             f'its plain version')
    return worst


def train_args(save):
    """The training CLI's arguments at the defaults of main.py, for
    TRAIN_EPOCHS epochs, writing under `save`."""
    from vae_gp_ode_tpu_torch.main import make_parser
    return make_parser().parse_args([
        '--Nepoch', str(TRAIN_EPOCHS), '--save', save, '--device', 'cuda'])


def main():
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available; this script needs a GPU',
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vae_gp_ode_tpu_torch import ops
    from vae_gp_ode_tpu_torch.gp.svgp import draw_fn_sample, init_svgp_params
    from vae_gp_ode_tpu_torch.models.odegpvae import init_model
    from vae_gp_ode_tpu_torch.ops import _build, flow_fused
    from vae_gp_ode_tpu_torch.ops.pathwise import rbf_fused_operands
    from vae_gp_ode_tpu_torch.serving import (
        MNIST_MEAN, MNIST_STD, make_forecast_fn)
    from vae_gp_ode_tpu_torch.training.objectives import (
        compute_test_error, elbo_terms)
    from vae_gp_ode_tpu_torch import main as train_cli
    from vae_gp_ode_tpu_torch.data.mnist import load_data
    from vae_gp_ode_tpu_torch.training import checkpoint, trainer

    # -- 1. card and build -------------------------------------------------
    card = nvidia_smi()
    log(f'card: {card}')
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'device {torch.cuda.get_device_name(0)}')
    t0 = time.perf_counter()
    _build.build(['flow_fused', 'flow_fused_bwd'])
    flow_fused._kernel()
    flow_fused._bwd_lib()
    log(f'build: {time.perf_counter() - t0:.1f} s')

    # -- 2. the forecaster at full width ---------------------------------
    dev = torch.device('cuda')
    model, gp = init_model(args.seed, device='cuda', random_bn=True,
                           **CONFIG)
    rng = np.random.default_rng(args.seed + 1)
    raw = [rng.random((BATCH, T, 1, 28, 28)).astype(np.float32)
           for _ in range(3)]
    log(f'model: q={CONFIG["latent_dim"]} n_filt={CONFIG["n_filt"]} '
        f'S={CONFIG["num_features"]} M={CONFIG["num_inducing"]} L={L} '
        f'batch={BATCH} T={T} rollout T={T * TROLL}; '
        f'{sum(p.numel() for p in model.parameters())} VAE parameters')

    # -- 3. kernel vs plain version --------------------------------------
    log('kernel flow_fused_fwd vs packed_flow_reference on the card:')
    S, q = CONFIG['num_features'], CONFIG['latent_dim']
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    gp2 = init_svgp_params(rng, 2 * q, q, CONFIG['num_inducing'],
                           lengthscale=2.0, variance=0.7, device='cuda')
    cases = []
    with torch.no_grad():
        for name, g, N_, T_, D_, uniform in (
                ('order 1, main path (L=5, N=20, T=16)', gp, BATCH, T, q,
                 True),
                ('order 1, rollout (T=32)', gp, BATCH, T * TROLL, q, True),
                ('order 2 (D=12), non-uniform dts', gp2, BATCH, T, 2 * q,
                 False),
                ('order 1, N=300 (75 row tiles)', gp, 300, T, q, True)):
            sample = draw_fn_sample(g, gen, S, L=L)
            packed = flow_fused._pack_operands(*rbf_fused_operands(g, sample))
            z0 = torch.randn(N_, D_, generator=gen, device=dev)
            if uniform:
                dts = torch.diff(CONFIG['dt'] * torch.arange(
                    T_, dtype=torch.float32, device=dev))
            else:
                dts = torch.rand(T_ - 1, generator=gen, device=dev) * 0.15 \
                    + 0.05
            order = D_ // q
            out = flow_fused.packed_euler_flow(z0, *packed, dts, T_, order)
            ref = flow_fused.packed_flow_reference(z0, *packed, dts, T_,
                                                   order)
            torch.cuda.synchronize()
            require(out.shape == (L, T_, N_, D_), f'shape {out.shape}')
            cases.append(compare(out, ref, name))
            if name.startswith('order 1, main'):
                main_operands = (z0, *packed, dts, T_, order)
    max_abs_err = max(cases)

    log('kernel flow_fused_bwd vs packed_flow_vjp_reference on the card:')
    bwd_cases, bwd_operands = [], {}
    for name, g, N_, L_, D_, uniform, z0_per_draw in (
            ('order 1, main path L=1 (N=20, T=16)', gp, BATCH, 1, q, True,
             False),
            ('order 1, main path L=5', gp, BATCH, L, q, True, False),
            ('order 1, L=5, z0 per draw', gp, BATCH, L, q, True, True),
            ('order 2 (D=12), L=5, non-uniform dts', gp2, BATCH, L, 2 * q,
             False, False),
            ('order 1, N=300 (75 row tiles), L=5', gp, 300, L, q, True,
             False)):
        with torch.no_grad():
            sample = draw_fn_sample(g, gen, S, L=L_)
            packed = flow_fused._pack_operands(*rbf_fused_operands(g, sample))
        lead = (L_,) if z0_per_draw else ()
        z0 = torch.randn(lead + (N_, D_), generator=gen, device=dev)
        if uniform:
            dts = torch.full((T - 1,), CONFIG['dt'], device=dev)
        else:
            dts = torch.rand(T - 1, generator=gen, device=dev) * 0.15 + 0.05
        order = D_ // q
        # through the autograd Function, as the train step runs it: z0
        # shared by all draws gets the draws' sum
        inputs = [x.clone().requires_grad_() for x in
                  (z0, *packed, dts)]
        zs = flow_fused.packed_euler_flow(*inputs, T, order)
        zsbar = torch.randn(zs.shape, generator=gen, device=dev)
        out = torch.autograd.grad(zs, inputs, zsbar)
        zs4 = zs.detach().reshape((-1, T, N_, D_))
        ref = list(flow_fused.packed_flow_vjp_reference(
            zs4, zsbar.reshape(zs4.shape), *packed, dts, T, order))
        if not z0_per_draw:
            ref[0] = ref[0].sum(0)
        torch.cuda.synchronize()
        bwd_cases.append(compare_bwd(out, ref, name))
        if name.startswith('order 1, main path'):
            bwd_operands[L_] = (zs4, zsbar.reshape(zs4.shape), *packed, dts,
                                T, order)
    bwd_max_abs_err = max(bwd_cases)

    # -- 4. the main path ------------------------------------------------
    fn = make_forecast_fn(model, None, gp, L=L, normalize_input=True,
                          device='cuda')
    fn_roll = make_forecast_fn(model, None, gp, L=L, T_custom=T * TROLL,
                               normalize_input=True, device='cuda')
    fn(raw[0], args.seed)                                     # warm-up
    fn_roll(raw[0], args.seed)
    torch.cuda.synchronize()

    log('forecaster path:')
    request_ms = []
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ops.reset_launches()
    for i, (f, X, Tout) in enumerate(
            [(fn, raw[0], T), (fn, raw[1], T), (fn, raw[2], T),
             (fn_roll, raw[0], T * TROLL)]):
        before = ops.LAUNCHES['flow_fused_fwd']
        ev0.record()
        Xrec = f(X, args.seed + i)
        ev1.record()
        torch.cuda.synchronize()
        ms = ev0.elapsed_time(ev1)
        request_ms.append(ms)
        require(Xrec.shape == (L, BATCH, Tout, 1, 28, 28),
                f'forecast shape {tuple(Xrec.shape)}')
        require(bool(torch.isfinite(Xrec).all()), 'non-finite forecast')
        launched = ops.LAUNCHES['flow_fused_fwd'] - before
        require(launched == 1,
                f'request {i} launched the kernel {launched}x')
        log(f'  request {i}: Xrec {tuple(Xrec.shape)} in {ms:.3f} ms, '
            f'range [{float(Xrec.min()):.4f}, {float(Xrec.max()):.4f}], '
            f'kernel launches 1')
    # eval step on batch 0: forward + ELBO terms + MSE of the MC mean
    before = ops.LAUNCHES['flow_fused_fwd']
    Xn = (torch.as_tensor(raw[0], device=dev) - MNIST_MEAN) / MNIST_STD
    with torch.no_grad():
        Xrec, s_stats, v_stats, nfe = model(
            Xn, gp, L=L,
            generator=torch.Generator(device=dev).manual_seed(args.seed))
        lhood, kl_reg, kl_u = elbo_terms(Xn, Xrec, s_stats, v_stats, gp,
                                         eps_guard=True)
        mse = compute_test_error(Xn, Xrec.mean(0))
    torch.cuda.synchronize()
    require(ops.LAUNCHES['flow_fused_fwd'] - before == 1,
            'the eval step did not launch the trajectory kernel once')
    require(nfe == L * (T - 1), f'nfe {nfe}')
    terms = [float(x) for x in (lhood, kl_reg, kl_u, mse)]
    require(all(np.isfinite(terms)), f'non-finite ELBO terms {terms}')
    serve_launches = dict(ops.LAUNCHES)
    log(f'  eval step: lhood {terms[0]:.6f} kl_reg {terms[1]:.6f} '
        f'kl_u {terms[2]:.6f} mse(MC mean) {terms[3]:.6f} nfe {nfe}')
    log(f'  launches on the forecaster path: {serve_launches}')
    require(serve_launches[flow_fused.KERNEL] > 0,
            'the trajectory kernel was never launched on the forecaster path')

    # -- 5. GPU forward vs the port's CPU forward, same noise -------------
    n_small, L_small = 4, 2
    rs = np.random.default_rng(args.seed + 2)
    f32 = np.float32
    noise_np = {
        'z0': rs.standard_normal((n_small, q)).astype(f32),
        'omega': rs.standard_normal((L_small, q, S, q)).astype(f32),
        'phase_u': rs.random((L_small, 1, S, q)).astype(f32),
        'weights': rs.standard_normal((L_small, S, q)).astype(f32),
        'epsilon': rs.standard_normal(
            (L_small, CONFIG['num_inducing'], q)).astype(f32)}
    Xs = (raw[1][:n_small] - MNIST_MEAN) / MNIST_STD
    cpu_model = copy.deepcopy(model).to('cpu')
    with torch.no_grad():
        gpu_out = model(torch.as_tensor(Xs, device=dev), gp, L=L_small,
                        noise={k: torch.as_tensor(v, device=dev)
                               for k, v in noise_np.items()})[0]
        cpu_out = cpu_model(torch.as_tensor(Xs), gp.to('cpu'), L=L_small,
                            noise={k: torch.as_tensor(v)
                                   for k, v in noise_np.items()})[0]
    fwd_err = float((gpu_out.cpu() - cpu_out).abs().max())
    log(f'GPU forward vs CPU forward ({n_small} sequences, L={L_small}, '
        f'same noise): max abs err {fwd_err:.3e} (tol {TOL_FORWARD:g})')
    if not fwd_err <= TOL_FORWARD:
        raise AssertionError(f'GPU forward disagrees with the CPU forward '
                             f'({fwd_err:.3e})')

    # -- 6. the training path: the CLI's run() at main.py's defaults -----
    save = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                        'chip_smoke', 'mnist')
    targs = train_args(save)
    steps = []                 # (epoch, L, launch deltas) per train step
    seen = {}

    def on_step(ep, L_):
        now = dict(ops.LAUNCHES)
        steps.append((ep, L_, {k: now[k] - seen.get(k, 0) for k in now}))
        seen.update(now)

    log(f'training path: run() for {TRAIN_EPOCHS} epochs at main.py\'s '
        f'defaults (Ndata {targs.Ndata}, batch {targs.batch}, T {targs.T}, '
        f'q {targs.latent_dim}, S {targs.num_features}, M '
        f'{targs.num_inducing}, L=1 then L=5)')
    t0 = time.perf_counter()
    ops.reset_launches()
    result = train_cli.run(targs, on_step=on_step)
    torch.cuda.synchronize()
    train_launches = dict(ops.LAUNCHES)
    train_s = time.perf_counter() - t0
    if result['bailout'] is not None:
        raise AssertionError(f'NaN bailout at epoch {result["bailout"]}')
    per_epoch = targs.Ndata // targs.batch + bool(targs.Ndata % targs.batch)
    require(len(steps) == TRAIN_EPOCHS * per_epoch, f'{len(steps)} steps')
    for i, (ep, L_, d) in enumerate(steps):
        # the first step of a later epoch also counts the previous
        # epoch's monitoring eval (one forward launch)
        evals = 1 if i % per_epoch == 0 and ep > 0 else 0
        if d[flow_fused.BWD_KERNEL] != 1 or d[flow_fused.KERNEL] != 1 + evals:
            raise AssertionError(f'train step {i} (epoch {ep}, L={L_}) '
                                 f'launched {d}')
    require([L_ for _, L_, _ in steps] == [1] * per_epoch + [L] * per_epoch,
            'the L schedule is not L=1 then L=5')
    losses = np.concatenate([e['loss'] for e in result['epochs']])
    require(len(result['epochs']) == TRAIN_EPOCHS and losses.size == len(
        steps) and np.isfinite(losses).all(), f'losses {losses}')
    mses = [float(e['mse']) for e in result['epochs']]
    require(np.isfinite(mses).all(), f'monitoring mse {mses}')
    log(f'  {len(steps)} train steps + {TRAIN_EPOCHS} monitoring evals in '
        f'{train_s:.1f} s (data, model and first-call set-up included); '
        f'every step launched {flow_fused.KERNEL} and '
        f'{flow_fused.BWD_KERNEL} once; launches {train_launches}')
    log(f'  losses finite: first {losses[0]:.2f}, end of epoch 0 '
        f'{losses[per_epoch - 1]:.2f}, last {losses[-1]:.2f}; monitoring '
        f'mse {", ".join(f"{m:.4f}" for m in mses)}')

    # checkpoint round trip: one more step from the trained state and
    # from a fresh state restored from its checkpoint
    state = result['state']
    _, testset = load_data(targs, device=dev)
    batch = testset.first()
    fresh_model, fresh_gp = init_model(
        args.seed + 7, latent_dim=targs.latent_dim, n_filt=targs.n_filt,
        num_features=targs.num_features, num_inducing=targs.num_inducing,
        device='cuda')
    fresh = checkpoint.restore_checkpoint(
        result['ckpt'], trainer.create_train_state(fresh_model, fresh_gp,
                                                   lr=targs.lr))
    step = trainer.make_train_step(targs.Ndata, eps_guard=targs.eps_guard)
    a = step(state, batch, L,
             torch.Generator(device=dev).manual_seed(args.seed))
    b = step(fresh, batch, L,
             torch.Generator(device=dev).manual_seed(args.seed))
    la, lb = float(a['loss']), float(b['loss'])
    log(f'checkpoint round trip: next step loss {la:.6f} (trained state) vs '
        f'{lb:.6f} (restored), step {int(state.step)} vs {int(fresh.step)}')
    if not (abs(la - lb) <= 1e-6 * abs(la) and int(state.step) == int(
            fresh.step)):
        raise AssertionError('the restored state does not continue as the '
                             'trained one')

    # no step waits for the card
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        for _ in range(2):
            step(state, batch, L)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log('sync check: 2 train steps (L=5, batch on the card) under '
        'set_sync_debug_mode("error"): no synchronising operation')

    # one step's gradients on the GPU against the port's CPU step
    rs = np.random.default_rng(args.seed + 3)
    M_ = targs.num_inducing
    noise_np = {'z0': rs.standard_normal((BATCH, q)),
                'omega': rs.standard_normal((1, q, S, q)),
                'phase_u': rs.random((1, 1, S, q)),
                'weights': rs.standard_normal((1, S, q)),
                'epsilon': rs.standard_normal((1, M_, q))}
    grads = {}
    for where in ('cuda', 'cpu'):
        st = trainer.TrainState(
            model=copy.deepcopy(state.model).to(where).train(),
            gp=state.gp.detach().to(where).requires_grad_(),
            optimizer=None, step=None)
        for p in st.model.parameters():
            p.grad = None
        noise = {k: torch.as_tensor(v, dtype=torch.float32, device=where)
                 for k, v in noise_np.items()}
        loss, _ = trainer.loss_fn(st, batch.to(where), 1, targs.Ndata,
                                  targs.eps_guard, noise=noise)
        loss.backward()
        grads[where] = dict(zip(st.param_names(),
                                (p.grad.cpu() for p in st.params())))
    # a convolution bias that feeds a train-mode BatchNorm has gradient 0
    # (the normalisation removes it): both sides are rounding noise there,
    # held to the scale of the same layer's weight gradient instead
    scale = {n: float(g.abs().max()) for n, g in grads['cpu'].items()}
    for n in trainer.bias_before_batchnorm(state.model):
        scale[n] = scale[n[:-len('bias')] + 'weight']
    worst, worst_name = 0.0, None
    for n, gc in grads['cpu'].items():
        rel = float((grads['cuda'][n] - gc).abs().max()) / max(scale[n],
                                                               1e-30)
        if rel > worst:
            worst, worst_name = rel, n
    log(f'GPU vs CPU train-step gradients ({len(scale)} leaves, L=1, same '
        f'noise): max over leaves of max |gpu - cpu| / max |cpu| = '
        f'{worst:.3e} at {worst_name} (tol {TOL_GRAD:g}; the '
        f'{len(trainer.bias_before_batchnorm(state.model))} conv biases '
        f'before a BatchNorm against their weight gradient)')
    if not worst <= TOL_GRAD:
        raise AssertionError('GPU gradients disagree with the CPU step')

    # -- 7. timings --------------------------------------------------------
    with torch.no_grad():
        ms_kernel = cuda_ms(
            lambda: flow_fused.packed_euler_flow(*main_operands), 200)
        ms_plain = cuda_ms(
            lambda: flow_fused.packed_flow_reference(*main_operands), 50)
    bound_ms, bound_by = flow_bound(L, BATCH, q, q, S,
                                    CONFIG['num_inducing'], T)
    log(f'flow_fused_fwd at the main path shapes: kernel {ms_kernel:.4f} ms, '
        f'plain version {ms_plain:.4f} ms, bound {bound_ms:.5f} ms '
        f'({bound_by}); card {card}')
    bwd_ms = {}
    for L_, operands in sorted(bwd_operands.items()):
        ms_b = cuda_ms(lambda: flow_fused.packed_flow_vjp(*operands), 100)
        ms_bp = cuda_ms(
            lambda: flow_fused.packed_flow_vjp_reference(*operands), 10)
        outs = flow_fused.packed_flow_vjp(*operands)
        bound_b, by_b = flow_bwd_bound(
            L_, BATCH, q, q, S, CONFIG['num_inducing'], T,
            list(operands[:-2]) + list(outs))
        bwd_ms[L_] = (ms_b, ms_bp, bound_b, by_b)
        log(f'flow_fused_bwd at the train step shapes L={L_}: kernel '
            f'{ms_b:.4f} ms (launch + slab sums), plain version '
            f'{ms_bp:.4f} ms, bound {bound_b:.5f} ms ({by_b}); card {card}')
    log(f'requests (CUDA events): T={T}: '
        + ', '.join(f'{m:.3f}' for m in request_ms[:3])
        + f' ms; rollout T={T * TROLL}: {request_ms[3]:.3f} ms')

    step_ms = {}
    for L_ in (1, L):
        for _ in range(3):
            step(state, batch, L_)
        step_ms[L_] = cuda_ms(lambda: step(state, batch, L_), 20, warmup=0)
    log('train step (CUDA events over 20 steps, batch on the card): '
        + ', '.join(f'L={k}: {v:.3f} ms ({1e3 / v:.1f} steps/s)'
                    for k, v in step_ms.items()) + f'; card {card}')

    profile(lambda: fn(raw[1], args.seed), 'one T=16 request')
    profile(lambda: step(state, batch, L), f'one L={L} train step')

    ms_b, ms_bp, bound_b, by_b = bwd_ms[L]
    log(json.dumps({'kernels': [{
        'name': flow_fused.KERNEL, 'route': 'cuda',
        'source': flow_fused.SOURCE, 'replaces': flow_fused.REPLACES,
        'launches': (serve_launches[flow_fused.KERNEL]
                     + train_launches[flow_fused.KERNEL]),
        'max_abs_err': max_abs_err, 'ms': ms_kernel, 'plain_ms': ms_plain,
        'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': None}, {
        'name': flow_fused.BWD_KERNEL, 'route': 'cuda',
        'source': flow_fused.BWD_SOURCE,
        'replaces': flow_fused.BWD_REPLACES,
        'launches': (serve_launches[flow_fused.BWD_KERNEL]
                     + train_launches[flow_fused.BWD_KERNEL]),
        'max_abs_err': bwd_max_abs_err, 'ms': ms_b, 'plain_ms': ms_bp,
        'bound_ms': bound_b, 'bound_by': by_b, 'library_ms': None}]}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == '__main__':
    sys.exit(main())
