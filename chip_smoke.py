#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vae_gp_ode_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--seed 0]

1. prints the card's name and power limit, builds every CUDA kernel of the
   path with nvcc (all at once) and prints the build time;
2. builds the eval-mode forecaster at the main configuration's full width
   (rot-MNIST 28x28, q=6, n_filt=8, dimwise RBF with S=256 features and
   M=100 inducing points, euler dt=0.1, L=5 draws) with random weights
   and a random GP drawn from --seed;
3. holds each kernel against its plain PyTorch version on the card, at
   the main path's shapes and beside them (order 2, more than one row
   tile, a non-uniform grid), within the stated tolerance;
4. drives the main path - three forecast requests of 20 sequences at
   T=16, one rollout at T=32 and one eval step with the ELBO - with every
   launch count set to 0 just before, and checks shapes, finiteness and
   that each request launched the trajectory kernel exactly once;
5. checks the GPU forward against the port's CPU forward on a small input
   with the same injected noise, times kernels and requests with CUDA
   events, and traces one request with torch.profiler (device kernels by
   time, the device's idle share);
6. prints one JSON line on the kernels and, as the last line,
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

CONFIG = dict(latent_dim=6, n_filt=8, num_features=256, num_inducing=100,
              dt=0.1, lengthscale=2.0, variance=0.7)
L, BATCH, T, TROLL = 5, 20, 16, 2
H100_FP32_FLOPS = 67e12     # dense f32 outside the tensor cores (SXM)
H100_BYTES_PER_S = 3.35e12


def log(msg):
    print(msg, flush=True)


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


def profile_request(fn, X, seed):
    """Trace one request with torch.profiler: the device's kernels by
    self time, and the device's busy share of the span from its first
    kernel's start to its last kernel's end."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(X, seed)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log('profile: the trace holds no device events')
        return
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels))
    log(f'profile of one request: {len(kernels)} device kernels, busy '
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

    # -- 1. card and build -------------------------------------------------
    card = nvidia_smi()
    log(f'card: {card}')
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'device {torch.cuda.get_device_name(0)}')
    t0 = time.perf_counter()
    _build.build(['flow_fused'])
    flow_fused._kernel()
    log(f'build: {time.perf_counter() - t0:.1f} s')

    # -- 2. the forecaster at full width ---------------------------------
    dev = torch.device('cuda')
    model, gp = init_model(args.seed, device='cuda', **CONFIG)
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
            assert out.shape == (L, T_, N_, D_), out.shape
            cases.append(compare(out, ref, name))
            if name.startswith('order 1, main'):
                main_operands = (z0, *packed, dts, T_, order)
    max_abs_err = max(cases)

    # -- 4. the main path ------------------------------------------------
    fn = make_forecast_fn(model, None, gp, L=L, normalize_input=True,
                          device='cuda')
    fn_roll = make_forecast_fn(model, None, gp, L=L, T_custom=T * TROLL,
                               normalize_input=True, device='cuda')
    fn(raw[0], args.seed)                                     # warm-up
    fn_roll(raw[0], args.seed)
    torch.cuda.synchronize()

    log('main path:')
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
        assert Xrec.shape == (L, BATCH, Tout, 1, 28, 28), Xrec.shape
        assert bool(torch.isfinite(Xrec).all()), 'non-finite forecast'
        launched = ops.LAUNCHES['flow_fused_fwd'] - before
        assert launched == 1, f'request {i} launched the kernel {launched}x'
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
    assert ops.LAUNCHES['flow_fused_fwd'] - before == 1
    assert nfe == L * (T - 1), nfe
    terms = [float(x) for x in (lhood, kl_reg, kl_u, mse)]
    assert all(np.isfinite(terms)), terms
    launches = dict(ops.LAUNCHES)
    log(f'  eval step: lhood {terms[0]:.6f} kl_reg {terms[1]:.6f} '
        f'kl_u {terms[2]:.6f} mse(MC mean) {terms[3]:.6f} nfe {nfe}')
    log(f'  launches on the main path: {launches}')
    for name, n in launches.items():
        assert n > 0, f'kernel {name} was never launched on the main path'

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

    # -- 6. timings --------------------------------------------------------
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
    log(f'requests (CUDA events): T={T}: '
        + ', '.join(f'{m:.3f}' for m in request_ms[:3])
        + f' ms; rollout T={T * TROLL}: {request_ms[3]:.3f} ms')

    profile_request(fn, raw[1], args.seed)

    log(json.dumps({'kernels': [{
        'name': flow_fused.KERNEL, 'route': 'cuda',
        'source': flow_fused.SOURCE, 'replaces': flow_fused.REPLACES,
        'launches': launches[flow_fused.KERNEL],
        'max_abs_err': max_abs_err, 'ms': ms_kernel, 'plain_ms': ms_plain,
        'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': None}]}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == '__main__':
    sys.exit(main())
