#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vae_gp_ode_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--seed 0]

1. prints the card's name and power limit, builds every CUDA kernel of the
   paths with nvcc (all at once) and prints the build time and each kernel
   instance's registers and spills (`-Xptxas -v`; the tiled DF pair's
   kernels and the RBF per-step kernels #3, #4, #9 and #10 must not
   spill);
2. builds the eval-mode forecaster at the main configuration's full width
   (rot-MNIST 28x28, q=6, n_filt=8, dimwise RBF with S=256 features and
   M=100 inducing points, euler dt=0.1, L=5 draws) with random weights
   and a random GP drawn from --seed;
3. holds each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and beside them (order 2, more than one row
   tile, a non-uniform grid; for the adjoint also L=1 and L=5, and z0
   per draw or shared by all draws), within the stated tolerances; the
   trajectory kernel and its adjoint (with its summing kernel) launched
   twice for the same bits, each with the plan it takes;
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
   the GPU against the port's CPU step in float64 with the same noise
   and the GPU run's ReLU branches (each leaf within 1e-3 of its largest
   entry; RELU_FLIP);
6b. the solvers' paths, each run with the counts set to 0 just before
   and read just after: the per-step kernel and its VJP against their
   plain versions (L=1 and 5, N=20 and 600, D=6, 12 and K=12, S=256 and
   2048); the two repairs (cuSOLVER's Cholesky of a gram that is not
   positive definite gives NaN; the fused pair's dispatch rule at the
   shapes the adjoint kernel refuses, and one train step at order 1,
   q=6, S=2048 through the per-step kernels against autograd through
   the plain version on the card, both sharing cuSOLVER's factor, and
   against the CPU step in float64); the training CLI's run() with --solver rk4 for 2 epochs
   (every step through the per-step kernels and never the fused pair,
   GPU vs CPU gradients, a sync check, step times); three train steps
   each with dopri5 and with the rk4 continuous adjoint (whose gradients
   are held to rk4 backprop); one dopri5 forecast request;
6c. the divergence-free (DF) kernel's paths, each run with the counts set
   to 0 just before and read just after: kernels #5-#8 (the per-step eval
   and its VJP, the euler trajectory and its adjoint) against their plain
   versions (L=1 and 5, N=20 and 600, D=6, 3 and 12, non-uniform dts, GP
   operands per draw, z0 per draw, S=512), all four launched twice for
   the same bits (#6 and #8 with their summing kernels); #8 in the chaotic D=3 field
   also held to a float64 plain version (no farther from it than
   F64_NOISE times the f32 plain version), there on a second draw too;
   the pair's rule (its boundary since #8's clusters) and one train step
   at S=2048, which it refuses, through the per-step kernels against the
   plain version on the card; the training CLI's run() with --kernel DF
   for 2 epochs (every step launches #7 and #8 once and no other kernel; GPU vs
   CPU float64 gradients); 3 steps with --solver rk4 through #5/#6 (GPU vs
   CPU gradients) and one rk4-adjoint step held to rk4 backprop; three DF
   requests and a T=32 rollout with random weights (one #7 launch each);
   one request from the shipped checkpoint checkpoints/df_5000ep (read
   with restore_jax_checkpoint) against the port's CPU forward; kernel
   times with bounds, DF train steps at L=1 and 5;
6d. the wide shapes (q=12, S=1024: the JAX package's grid-tiled
   corner), each run with the counts set to 0 just before and read just
   after: both per-step pairs of each family, the single-block #3-#6
   and the grid-tiled #9-#12, against their plain versions at every shape
   of the dispatch rule's sweep (RBF (D, K, S) and DF (D, S) at L=1 and 5,
   N=20 and 600; RBF widths past 12 at lengthscale `rbf_lengthscale`,
   their cotangents each within TOL_BWD of its own largest entry; at the
   RBF width 72 the tiled forward alone, #10 does not fit), a ragged
   last chunk, GP operands per draw, no draw dim
   and the rows of the paths below (400 and 160; the RBF single-block pair
   also at the latent width 72 of the rk4 steps below), with both RBF
   pairs and both DF pairs launched twice on the same inputs for the
   same bits; #4 at that width and #9 at 400 rows held to the float64
   plain version too (per output or cotangent, its error over its
   largest float64 entry no more than F64_NOISE times the f32 plain
   version's); the sweep itself
   (both pairs, forward and VJP, per call with CUDA events, the median of
   three rounds in turns, and device time per launch at the wide shapes)
   beside the pair the rule picks,
   and how often each family's rule took the faster one; the training
   CLI's run() at
   `--latent_dim 12 --D_in 12 --D_out 12 --num_features 1024` for 2
   epochs, RBF and then --kernel DF (every step launches the kernels the
   rule names and nothing else; GPU vs CPU float64 gradients; step times
   at L=1 and 5); three requests, a T=32 rollout and a request of 400
   sequences per kernel with random weights; rk4 steps at the main widths
   by the rule and by the single-block pair in turns (six rounds each,
   medians), RBF rk4 steps of 160 sequences (L=5) and at latent_dim 72
   (L=5), wider than the tiled VJP's block holds (one step's trace: each
   #9/#4 call its main kernel, then its summing kernel; one train step at
   `rbf_lengthscale(72)` against autograd through the plain version on
   the card, TOL_GRAD), and, for DF, at L=1 with 600 sequences;
6e. DF above state dim 16, where only the tiled pair's wide kernels run:
   #11/#12 against their plain versions at D = 20, 48, 49, 64 (the
   latent_dim-64 steps' shape, L=1 and 5, S=256) and 260 (above the
   block's 256 threads, its tables through L2), two launches for the
   same bits, and one DF euler and one DF rk4 train step each at
   latent_dim 20 and 64 (L=5) through #11/#12 against autograd through
   the plain version on the card (TOL_GRAD, RELU_FLIP; at 64 from
   lengthscale DF_WIDEST_LS, where the field does not amplify f32
   rounding);
6f. the pretrained workflow, each path run with the counts set to 0 just
   before and read just after: `main_vae` for 2 epochs at its defaults
   (2880 frames, batch 64; finite losses, no kernel of the twelve), the
   training CLI's run() with --pretrained from the encoder and decoder it
   wrote for 2 epochs at main.py's defaults (every step launches #1 and #2
   once and no other kernel; the VAE's weights and the encoder's and
   decoder's BatchNorm statistics bit for bit as pretrained), one frozen
   step's GP-leaf gradients against the CPU float64 step (TOL_GRAD,
   RELU_FLIP) and one under set_sync_debug_mode('error'), frozen step
   times at L=1 and L=5 (CUDA events) with their device busy time and
   idle share (torch.profiler); then `evaluate` on that run and on
   checkpoints/df_5000ep (a copy under build/; each test batch and the
   T=32 rollout launch #1 or #7 once and nothing else; finite mse_mean and
   mse_std; wall time), and its first test batch on the card against the
   CPU with the same noise (frames and compute_mse_std: TOL_FORWARD for
   the RBF run, DF_CKPT_FRAMES and DF_CKPT_MSE_REL for the
   ill-conditioned DF checkpoint);
6g. the shared-lengthscale RBF kernel (`--dimwise False`) and multi-epoch
   segments, each path run with the counts set to 0 just before and read
   just after: the RBF kernels on shared operands from --seed broadcast
   over the output dims (`ops.pathwise.dimwise_block`) against the port's
   plain shared formula (`rbf_rff_eval` + `rbf_f_update`, autograd) -
   #1/#2 and #3/#4 at orders 1 and 2, L=1 and 5, N=20, #9/#10 at q=12,
   S=1024, N=400 - the output within TOL_FORWARD and the cotangent of
   every shared leaf within TOL_BWD, each launched twice for the same
   bits; the training CLI's run() with --dimwise False for 2 epochs at
   main.py's defaults (every step launches #1 and #2 once and no other
   kernel, finite losses), one step's gradients against the CPU float64
   step (TOL_GRAD, RELU_FLIP), one step under set_sync_debug_mode('error'),
   step times at L=1 and 5 with their device busy time and idle share, an
   rk4 step's gradients against the CPU and 3 rk4 steps through the
   rule's per-step pair alone, three requests and a T=32 rollout from
   `load_run_dir` (#1 once each) and `evaluate` on the run (as in 6f);
   run() at --Nepoch 24 --plot_freq 100 with --epochs_per_dispatch 10
   (epochs 1-10 and 12-21 as segments) and 1, and at --pretrained from
   6f's files with --Nepoch 12 and 4 and 1, under cuDNN's deterministic
   algorithms: every step launches #1 and #2 once, per-step metrics,
   monitoring mses, checkpoint epochs and final state bit for bit, the
   frozen check once per segment, each run's host synchronisations
   (set_sync_debug_mode('warn')) and wall time; the A/B of one L=5 shared
   flow forward and backward (N=20, T=16) through #1/#2 on the broadcast
   operands and through the plain shared formula, in turns, device busy
   time per round (torch.profiler), median of 5;
6h. the serving artifact (`serving.export_forecaster`, `torch.export`):
   the main forecaster (L=5, symbolic batch), its T=32 rollout,
   checkpoints/df_5000ep and a dopri5 forecaster (max_steps 64, batch
   20), each exported on the card, saved, loaded and serving three
   requests of 20 sequences with the counts set to 0 just before each
   (#1 once a RBF euler request, #7 once a DF one, #3 or #9 on the
   dopri5 one, no VJP kernel), its frames against the eager forecaster
   at the same seed (TOL_ARTIFACT) and against the same file served on
   the CPU at the same noise; an artifact exported on the CPU served on
   the card, a CPU trace at S=ART_REFUSED_S that the load on the card
   refuses; the Jacobian operators against their plain versions (main
   widths and q=12, S=1024: the rule's VJP kernel and each of #4, #10,
   #6, #12 through `launch_jacobian`) and a bdf forecaster exported on
   the card with a symbolic batch (no plain per-step eval in its graph),
   serving 1, 20 and 400 sequences (a VJP kernel NEWTON_ITERS times a
   substep) against the eager bdf forecaster at the same noise
   (TOL_ARTIFACT), its export s, bytes, max_batch and request and busy
   ms in turns, and the eager request's VJP launches through the
   Jacobian operator against `row_jacobian`'s; and the
   bf16 artifact against the f32 one (BF16_FRAMES); export and load
   seconds, bytes, request ms and host ms to issue it in turns and busy
   ms with idle share against the eager forecaster; the eager T=16 and
   dopri5 requests through each route of the forward wrappers
   (`eager_route`: the operators, the direct launch, `custom_op`), in
   turns;
6i. plots, summaries, the native rotation and data parallelism: the run
   directory of step 6's run() (its figures, written where matplotlib
   imports and else named in one log line; the loss-trace .npy files;
   the model summaries in its log; final_plots' arrays), final_plots'
   latent trajectories and T=32 rollout on the card against the CPU path
   at the same noise (#1 once each), main_vae for 1 epoch at its
   defaults and evaluate on step 6's run with their figures, the native
   rotation library built with g++ and held to scipy (1e-5), and the
   per-rank data-parallel step (`parallel.shard_dp`) of RBF and DF models
   at main.py's defaults: at world size 1 over NCCL in this process and
   on 2 ranks of gloo on cuda:0 (subprocesses of this script,
   --dp-worker), every rank's loss and averaged gradients against the
   single-device step at the same noise on the single-device run's ReLU
   branches (TOL_GRAD, RELU_FLIP) and #1/#2 (#7/#8 for DF) launched once
   on every rank; the per-rank and single-device L=5 step times, busy ms
   and idle share; then main.py --data_parallel True at world size 1 (the
   single-device path, #1/#2 once a step);
7. times kernels, requests and train steps with CUDA events (#1's
   wrapper also through each of 6h's routes, in turns), and traces
   one request, one L=5 train step, one L=5 rk4 train step, one DF
   request, DF L=5, L=1 and rk4 train steps and one wide L=5 train step
   per kernel with torch.profiler (device kernels by time, the device's
   idle share), the device time per launch of an empty kernel (the floor)
   and of every kernel (the tiled RBF VJP's summing kernel apart), and
   the per-shape split: every kernel's launches on the paths at each
   shape (trajectory kernels included), its device time per launch there
   (timed again where the profiler recorded none; a shape without a
   reading fails the run), its CUDA-event time per call and its bound;
8. prints one JSON line on the twelve kernels and, as the last line,
   {"ok": true, "device": {...}}.

Any failure raises and the script exits non-zero without the last line;
a watchdog ends a hung run with a traceback. It needs CUDA and the rest
of the repository; it imports nothing of JAX.
"""

import argparse
import collections
import contextlib
import copy
import dataclasses
import faulthandler
import functools
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import time

WATCHDOG_S = 1100
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
# |cpu| with the CPU step in float64 (cuDNN's f32 convolution gradients
# sum in another order); the same tolerance holds the rk4 adjoint to rk4
# backprop and the S=2048 step to the plain version, both on the card
TOL_GRAD = 1e-3
TRAIN_EPOCHS = 2
# RELU_FLIP: a ReLU's derivative jumps at 0, so where a unit's input is
# within rounding of 0 the f32 and the float64 step can take different
# branches, and one such unit moves a decoder weight's gradient by
# 1e-3..2e-2 of its largest entry on any device (PERF.md, PR 6). Each
# gradient comparison therefore gives the reference run the tested run's
# branch of every ReLU, and requires every unit whose branch the two
# runs' own inputs disagree on to have a reference input within
# RELU_FLIP of its layer's largest |input|.
RELU_FLIP = 1e-4

# a kernel's distance from a float64 plain version may be at most this
# many times the f32 plain version's, per output or cotangent: #8 in the
# chaotic DF trajectory check (D=3, lengthscale 0.5; on an H100 it sat at
# 0.09-0.31 times; PERF.md), #4 at latent width 72 and #9 at 400 rows
F64_NOISE = 2.0

CONFIG = dict(latent_dim=6, n_filt=8, num_features=256, num_inducing=100,
              dt=0.1, lengthscale=2.0, variance=0.7)
L, BATCH, T, TROLL = 5, 20, 16, 2
H100_FP32_FLOPS = 67e12     # dense f32 outside the tensor cores (SXM)
H100_BYTES_PER_S = 3.35e12
# launches per (kernel, shape key) on the paths, each path run's counts
# (`ops.SHAPES`) read just after it: the per-shape split of section 7
PATH_SHAPES = collections.Counter()


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


def count_path(fn, launches):
    """Run one path on the card with every launch count set to 0 just
    before and read just after: returns (fn's result, the path's launches
    by kernel), adds them to `launches` and the path's shapes to
    PATH_SHAPES."""
    import torch
    from vae_gp_ode_tpu_torch import ops
    ops.reset_launches()
    res = fn()
    torch.cuda.synchronize()
    d = dict(ops.LAUNCHES)
    for k in launches:
        launches[k] += d[k]
    PATH_SHAPES.update(ops.SHAPES)
    return res, d


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


def device_events(fn):
    """The device kernels of one call of fn() (torch.profiler's CUDA
    events), in the order they started."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sorted(ev, key=lambda e: e.time_range.start)


def busy_ms(fn):
    """(device busy ms, device kernels) of one call of fn(), from
    torch.profiler: the sum of its kernels' device times."""
    ev = device_events(fn)
    return sum(e.time_range.elapsed_us() for e in ev) / 1e3, len(ev)


def kernel_sequence(fn):
    """The names of the device kernels of one call of fn(), in the order
    they started (torch.profiler)."""
    return [e.name for e in device_events(fn)]


def profile(fn, what):
    """Trace one call of fn() with torch.profiler: the device's kernels by
    self time, and the device's busy share of the span from its first
    kernel's start to its last kernel's end. Returns (busy ms, idle
    share), or None where the trace holds no device events."""
    kernels = device_events(fn)
    if not kernels:
        log(f'profile of {what}: the trace holds no device events')
        return None
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
    return busy_us / 1e3, 1 - busy_us / span_us


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
    """Least time (ms) on an H100 for one call of the adjoint's library
    (the adjoint kernel and the kernel that sums its slabs): the larger
    of its f32 operations (recompute + VJP, per row and step
    K*S*(6D+12) + K*M*(12D+16)) over the f32 peak and the bytes of
    `tensors` (the call's inputs, each read once, and its finished
    cotangents, each written once; the slabs between its two kernels are
    its own) over the memory rate."""
    per_row_step = K * S * (6 * D + 12) + K * M * (12 * D + 16)
    flops = L_ * N * (T_ - 1) * per_row_step
    nbytes = sum(4 * x.numel() for x in tensors)
    t_ops = flops / H100_FP32_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')


def compare_bwd(out, ref, what, names=('z0', 'omf', 'phf', 'ws', 'Zb', 'zn',
                                        'il2', 'nus', 'dts'),
                own_scale=False):
    """Per-cotangent max |kernel - plain| against TOL_BWD (1 + max
    |plain|), or with `own_scale` TOL_BWD max |plain| (each cotangent held
    to its own size, the stricter where that is below 1); raises on a
    miss. Returns the largest error."""
    import torch
    parts, worst, ok = [], 0.0, True
    for name, a, b in zip(names, out, ref):
        if a.shape != b.shape:
            raise AssertionError(f'{what}: {name} cotangent has shape '
                                 f'{tuple(a.shape)}, expected '
                                 f'{tuple(b.shape)}')
        err = float((a - b).abs().max())
        lim = TOL_BWD * ((0.0 if own_scale else 1.0) + float(b.abs().max()))
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


def step_noise(seed, q, S, M, L_=1, batch=None, order=1, df=False,
               shared=False):
    """Raw draws for one train step (z0 and L_ GP draws) from a numpy
    seed, the same for the GPU and the CPU step (`df`: the divergence-free
    kernel's 2S weights; `shared`: the shared-lengthscale RBF kernel's
    one set of frequencies and phases)."""
    import numpy as np
    rs = np.random.default_rng(seed)
    per_dim = () if shared else (q,)
    return {'z0': rs.standard_normal((batch or BATCH, q)),
            'omega': rs.standard_normal((L_, q * order, S) + per_dim),
            'phase_u': rs.random((L_, 1, S) + per_dim),
            'weights': rs.standard_normal((L_, 2 * S if df else S, q)),
            'epsilon': rs.standard_normal((L_, M, q))}


def step_grads(model, gp, batch, noise_np, ndata, eps_guard, where,
               L_=1, dtype=None, relu_in=None, relu_pin=None,
               freeze_vae=False):
    """Loss and gradients (by name, as f32 on the CPU) of one train step's
    loss on `where` for copies of model and gp, with the injected noise;
    in `dtype` (float64 for a CPU reference) or the model's own f32; with
    `freeze_vae` the frozen-VAE step's (the GP leaves' gradients alone,
    its BatchNorm modes).
    `relu_in` (a dict) receives each ReLU's input, on the CPU in float64;
    `relu_pin` (such a dict from another run) makes each ReLU pass its
    input where the pinned input was > 0 and give 0 elsewhere, that is
    take that run's branch (RELU_FLIP)."""
    import torch
    from torch import nn
    from vae_gp_ode_tpu_torch.training import trainer
    dtype = dtype or torch.float32
    g = gp.detach()
    g = dataclasses.replace(
        g, kernel=dataclasses.replace(g.kernel, **{
            k: getattr(g.kernel, k).to(where, dtype) for k in (
                'unconstrained_lengthscales', 'unconstrained_variance')}),
        **{k: getattr(g, k).to(where, dtype) for k in (
            'inducing_loc', 'Um', 'Us_sqrt')})
    st = trainer.TrainState(
        model=copy.deepcopy(model).to(where, dtype),
        gp=g.requires_grad_(), optimizer=None, step=None,
        freeze_vae=freeze_vae)
    trainer.set_train_mode(st)
    for p in st.model.parameters():
        p.grad = None

    def relu_hook(name, mod, inp, out):
        x = inp[0]
        if relu_in is not None:
            if name in relu_in:
                raise AssertionError(f'{name} ran twice in one step')
            relu_in[name] = x.detach().to('cpu', torch.float64)
        if relu_pin is not None:
            return x * (relu_pin[name] > 0).to(x.device, x.dtype)
        return None

    for name, mod in st.model.named_modules():
        if isinstance(mod, nn.ReLU):
            mod.register_forward_hook(
                lambda mod, inp, out, name=name: relu_hook(name, mod, inp,
                                                           out))
    noise = {k: torch.as_tensor(v, dtype=dtype, device=where)
             for k, v in noise_np.items()}
    loss, aux = trainer.loss_fn(st, batch.to(where, dtype), L_, ndata,
                                eps_guard, noise=noise)
    loss.backward()
    return loss.detach().cpu(), aux, st, dict(zip(
        st.param_names(), (p.grad.float().cpu() for p in st.params())))


def relu_flips(tested, ref):
    """Units whose ReLU branch differs between two runs' inputs: (their
    count, the largest |reference input| among them relative to its
    layer's largest |reference input|)."""
    count, worst = 0, 0.0
    for name, a in tested.items():
        b = ref[name]
        flip = (a > 0) != (b > 0)
        count += int(flip.sum())
        if flip.any():
            worst = max(worst, float(b[flip].abs().max() / b.abs().max()))
    return count, worst


def worst_grad_error(grads, ref, model):
    """max over leaves of max |grads - ref| / max |ref|; a convolution
    bias that feeds a train-mode BatchNorm has gradient 0 (the
    normalisation removes it): both sides are rounding noise there, held
    to the scale of the same layer's weight gradient instead."""
    from vae_gp_ode_tpu_torch.training import trainer
    scale = {n: float(g.abs().max()) for n, g in ref.items()}
    for n in trainer.bias_before_batchnorm(model):
        if n in scale:
            scale[n] = scale[n[:-len('bias')] + 'weight']
    worst, worst_name = 0.0, None
    for n, gr in ref.items():
        rel = float((grads[n] - gr).abs().max()) / max(scale[n], 1e-30)
        if rel > worst:
            worst, worst_name = rel, n
    return worst, worst_name


def pinned_grads(model, gp, batch, noise_np, ndata, eps_guard, tested,
                 reference, L_=1, ref_model=None, freeze_vae=False):
    """One train step's gradients by `tested` and by `reference` (each
    (device, dtype) for step_grads; `freeze_vae` for the frozen-VAE step)
    with the same noise, the reference (with `ref_model` in place of
    `model` where given) on the tested run's ReLU branches (RELU_FLIP).
    Returns (the tested
    run's loss, the reference's, the worst leaf's max error relative to
    its largest entry, that leaf, the ReLU units whose branch the two
    runs' own inputs disagree on, the largest relative input among
    them)."""
    relu_t, relu_r = {}, {}
    loss_t, _, _, g_t = step_grads(model, gp, batch, noise_np, ndata,
                                   eps_guard, tested[0], L_, tested[1],
                                   relu_in=relu_t, freeze_vae=freeze_vae)
    loss_r, _, _, g_r = step_grads(ref_model or model, gp, batch, noise_np,
                                   ndata, eps_guard, reference[0], L_,
                                   reference[1], relu_in=relu_r,
                                   relu_pin=relu_t, freeze_vae=freeze_vae)
    worst, name = worst_grad_error(g_t, g_r, model)
    flips, flip_at = relu_flips(relu_t, relu_r)
    return float(loss_t), float(loss_r), worst, name, flips, flip_at


def check_grads(what, res):
    """Log and hold a pinned_grads result: every leaf within TOL_GRAD of
    its largest entry, every flipped ReLU unit within RELU_FLIP of 0."""
    loss_t, loss_r, worst, name, flips, flip_at = res
    rel = abs(loss_t - loss_r) / abs(loss_r)
    log(f'{what}: loss {loss_t:.6f} vs {loss_r:.6f} (rel {rel:.2e}); '
        f'gradients max |err| / max |ref| {worst:.3e} at {name} (tol '
        f'{TOL_GRAD:g}, conv biases before a BatchNorm against their '
        f'weight gradient); ReLU units on the other branch in the '
        f'reference\'s own run: {flips}, largest |input| {flip_at:.2e} of '
        f'the layer\'s largest (tol {RELU_FLIP:g})')
    require(rel <= 1e-4 and worst <= TOL_GRAD and flip_at <= RELU_FLIP,
            f'{what}: the gradients disagree')


def pathwise_bound(tensors, rows, D, K, S, M, bwd=False):
    """Least time (ms) on an H100 for one per-step eval launch (or its VJP
    with bwd): the larger of its f32 operations (per row K*S*(2D+4) +
    K*M*(4D+4) forward, K*S*(6D+10) + K*M*(12D+10) for recompute and VJP)
    over the f32 peak and the bytes of `tensors` (its inputs, each read
    once, and its outputs, each written once) over the memory rate."""
    if bwd:
        per_row = K * S * (6 * D + 10) + K * M * (12 * D + 10)
    else:
        per_row = K * S * (2 * D + 4) + K * M * (4 * D + 4)
    t_ops = rows * per_row / H100_FP32_FLOPS * 1e3
    t_bytes = sum(4 * t.numel() for t in tensors) / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms, for two GPU runs that are compared
    with each other: their difference is then the one under test, not
    cuDNN's summation order."""
    import torch
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def deltas(before, after):
    return {k: after[k] - before.get(k, 0) for k in after}


def rule_names(kernel, L_, N_, D_, S_, M_):
    """The (forward, VJP) kernels that the card's dispatch rule names for
    the per-step eval of a first-order GP with `kernel` ('RBF' or 'DF') at
    L_ draws, N_ rows, state dim D_, S_ features and M_ inducing points."""
    import torch
    from vae_gp_ode_tpu_torch.ops import df_pathwise_tiled, pathwise_tiled
    dev = torch.device('cuda')
    if kernel == 'DF':
        return df_pathwise_tiled.rule_kernels(L_, N_, D_, S_ * D_, M_, dev)
    return pathwise_tiled.rule_kernels(L_, N_, D_, D_, S_, M_, dev)


def solver_paths(args, card, batch, targs, slice_launches):
    """The paths of this slice: kernels #3/#4 against their plain
    versions, the two repairs, training with rk4, dopri5 and the rk4
    adjoint, and the dopri5 forecaster. Adds each path run's launches to
    `slice_launches` (counts set to 0 just before it, read just after)
    and returns what the summary line needs."""
    import numpy as np
    import torch
    from vae_gp_ode_tpu_torch import main as train_cli
    from vae_gp_ode_tpu_torch import ops
    from vae_gp_ode_tpu_torch.core import linalg
    from vae_gp_ode_tpu_torch.core.settings import JITTER
    from vae_gp_ode_tpu_torch.gp.svgp import draw_fn_sample, init_svgp_params
    from vae_gp_ode_tpu_torch.kernels.rbf import rbf_gram
    from vae_gp_ode_tpu_torch.models.odegpvae import init_model
    from vae_gp_ode_tpu_torch.ops import flow_fused, pathwise, pathwise_tiled
    from vae_gp_ode_tpu_torch.serving import make_forecast_fn
    from vae_gp_ode_tpu_torch.training import trainer

    dev = torch.device('cuda')
    q, S, M = CONFIG['latent_dim'], CONFIG['num_features'], \
        CONFIG['num_inducing']
    gen = torch.Generator(device=dev).manual_seed(args.seed + 11)
    rng = np.random.default_rng(args.seed + 11)
    out = {}

    run_path = functools.partial(count_path, launches=slice_launches)

    # -- kernels #3 and #4 against their plain versions ------------------
    log('kernels pathwise_fwd / pathwise_bwd vs pathwise_eval_reference '
        '(and autograd through it) on the card:')
    gps = {}
    fwd_errs, bwd_errs, main_ops = [], [], {}
    for name, L_, N_, D_, K_, S_ in (
            ('L=1, N=20, D=K=6 (main, order 1)', 1, BATCH, q, q, S),
            ('L=5, N=20, D=K=6 (main, order 1)', L, BATCH, q, q, S),
            ('L=5, N=20, D=12, K=6 (order 2)', L, BATCH, 2 * q, q, S),
            ('L=5, N=600', L, 600, q, q, S),
            ('L=5, S=2048', L, BATCH, q, q, 2048),
            ('L=5, q=12 (D=K=12)', L, BATCH, 12, 12, S)):
        if (D_, K_) not in gps:
            gps[D_, K_] = init_svgp_params(rng, D_, K_, M, lengthscale=2.0,
                                           variance=0.7, device='cuda')
        g = gps[D_, K_]
        with torch.no_grad():
            operands = pathwise.rbf_fused_operands(
                g, draw_fn_sample(g, gen, S_, L=L_))
        x = torch.randn((L_, N_, D_), generator=gen, device=dev)
        with torch.no_grad():
            o = pathwise.fused_pathwise_eval(x, *operands)
            r = pathwise.pathwise_eval_reference(x, *operands)
        torch.cuda.synchronize()
        require(o.shape == (L_, N_, K_), f'shape {o.shape}')
        fwd_errs.append(compare(o, r, 'fwd ' + name))
        inputs = [t.clone().requires_grad_() for t in (x,) + operands]
        o = pathwise.fused_pathwise_eval(*inputs)
        gbar = torch.randn(o.shape, generator=gen, device=dev)
        bars = torch.autograd.grad(o, inputs, gbar)
        ref = pathwise.pathwise_vjp_reference(x, *operands, gbar)
        torch.cuda.synchronize()
        bwd_errs.append(compare_bwd(bars, ref, 'bwd ' + name,
                                    ('x',) + pathwise.NAMES))
        if name.startswith('L=') and 'main' in name:
            main_ops[L_] = (x, operands, gbar)
    out['pathwise_err'] = (max(fwd_errs), max(bwd_errs))

    # -- the two repairs ---------------------------------------------------
    A = torch.tensor([[[2.5, 0.5, 0.5, 0.5], [0.5, 2.5, 0.5, 0.5],
                       [0.5, 0.5, 2.5, 0.5], [0.5, 0.5, 0.5, 2.5]],
                      [[1., 2., 0., 0.], [2., 1., 0., 0.], [0., 0., 1., 0.],
                       [0., 0., 0., 1.]]], device=dev)
    Lc = linalg.cholesky(A)
    lower = torch.tril(torch.ones(4, 4, dtype=torch.bool, device=dev))
    require(bool(torch.isnan(Lc[1][lower]).all()) and not bool(
        torch.isnan(Lc[0]).any()) and not bool((Lc[1][~lower] != 0).any()),
        f'the non-PD block did not give NaN on the card: {Lc}')
    log('repair 1: cuSOLVER Cholesky of a (2,4,4) gram whose second block '
        'is not positive definite: NaN on and below its diagonal, the '
        'first block finite')
    lib = flow_fused._bwd_lib()
    optin = lib.flow_fused_bwd_smem_optin(0)
    for (order, q_, S_), fits in (((1, 6, 256), True), ((1, 6, 1024), True),
                                  ((1, 6, 2048), False),
                                  ((1, 12, 256), False),
                                  ((2, 8, 256), False),
                                  ((1, 12, 1024), False)):
        D_ = q_ * order
        nbytes = lib.flow_fused_bwd_smem_bytes(D_, q_, S_, M, T)
        got = flow_fused.fused_pair_fits(D_, q_, S_, M, T, dev)
        require(got == fits, f'rule at order {order} q={q_} S={S_}: {got}')
        log(f'  rule: order {order}, q={q_}, S={S_}: the rule\'s bound (the '
            f'parent adjoint block\'s shared memory) {nbytes} B of {optin} B '
            f'opt-in -> {"fused pair" if got else "per-step kernels"}')
    # one train step at order 1, q=6, S=2048: the per-step kernels
    wide, wide_gp = init_model(args.seed + 5, device='cuda',
                               **dict(CONFIG, num_features=2048))
    noise = step_noise(args.seed + 6, q, 2048, M)
    relu_k = {}
    with cudnn_deterministic():
        (loss_g, _, _, g_gpu), d = run_path(lambda: step_grads(
            wide, wide_gp, batch, noise, targs.Ndata, targs.eps_guard,
            'cuda', relu_in=relu_k))
    fk, bk = rule_names('RBF', 1, BATCH, q, 2048, M)
    require(d[fk] > 0 and d[bk] > 0 and d['flow_fused_fwd'] == 0 and
            d['flow_fused_bwd'] == 0, f'the S=2048 step launched {d}, the '
            f'rule names {fk} and {bk}')
    # the same step with autograd through the plain version on the card
    # (the per-step eval's wrapper swapped for pathwise_eval_reference),
    # so that both sides share cuSOLVER's factor of the untrained GP's
    # gram
    kernel_eval = pathwise_tiled.pathwise_eval
    pathwise_tiled.pathwise_eval = pathwise.pathwise_eval_reference
    relu_p = {}
    try:
        with cudnn_deterministic():
            (loss_p, _, _, g_plain), dp = run_path(lambda: step_grads(
                wide, wide_gp, batch, noise, targs.Ndata, targs.eps_guard,
                'cuda', relu_in=relu_p, relu_pin=relu_k))
    finally:
        pathwise_tiled.pathwise_eval = kernel_eval
    require(not any(dp.values()), f'the plain S=2048 step launched {dp}')
    worst, name = worst_grad_error(g_gpu, g_plain, wide)
    check_grads(f'repair 2: one train step at order 1, q=6, S=2048 (L=1), '
                f'launches {d}, against autograd through the plain version '
                f'on the card', (float(loss_g), float(loss_p), worst, name,
                                 *relu_flips(relu_k, relu_p)))
    # and against the CPU step in float64 on the kernel run's ReLU
    # branches, held like the other GPU-vs-CPU checks; the CPU's own f32
    # step on the same branches and the condition number of the untrained
    # GP's gram (both f32 steps factor it: cuSOLVER, LAPACK) beside it
    relu_64 = {}
    loss_64, _, _, g64 = step_grads(wide, wide_gp, batch, noise,
                                    targs.Ndata, targs.eps_guard, 'cpu', 1,
                                    torch.float64, relu_in=relu_64,
                                    relu_pin=relu_k)
    check_grads('  the same step against the CPU step in float64', (
        float(loss_g), float(loss_64), *worst_grad_error(g_gpu, g64, wide),
        *relu_flips(relu_k, relu_64)))
    g32 = step_grads(wide, wide_gp, batch, noise, targs.Ndata,
                     targs.eps_guard, 'cpu', relu_pin=relu_k)[3]
    with torch.no_grad():
        Ku = rbf_gram(wide_gp.kernel, wide_gp.inducing_loc).to(
            'cpu', torch.float64)
        cond = float(torch.linalg.cond(
            Ku + JITTER * torch.eye(M, dtype=torch.float64)).max())
    w32, n32 = worst_grad_error(g32, g64, wide)
    log(f'  the CPU f32 step against the float64 one on the same branches: '
        f'{w32:.3e} at {n32}; condition number of K(Z,Z) + jitter (largest '
        f'over output dims) {cond:.3e}')
    del wide, wide_gp

    # -- training with rk4: the CLI's run() -------------------------------
    save = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                        'chip_smoke', 'rk4')
    rargs = train_args(save, '--solver', 'rk4')
    steps, seen = [], {}

    def on_step(ep, L_):
        now = dict(ops.LAUNCHES)
        steps.append((ep, L_, deltas(seen, now)))
        seen.update(now)

    t0 = time.perf_counter()
    result, d = run_path(lambda: train_cli.run(rargs, on_step=on_step))
    train_s = time.perf_counter() - t0
    require(result['bailout'] is None, 'NaN bailout in the rk4 run')
    losses = np.concatenate([e['loss'] for e in result['epochs']])
    require(np.isfinite(losses).all(), f'rk4 losses {losses}')
    per_step = {}
    for i, (ep, L_, dd) in enumerate(steps):
        fk, bk = rule_names('RBF', L_, BATCH, q, S, M)
        require(dd[fk] > 0 and dd[bk] > 0 and
                dd['flow_fused_fwd'] == 0 and dd['flow_fused_bwd'] == 0,
                f'rk4 train step {i} launched {dd}, the rule names {fk} '
                f'and {bk}')
        if i % 18 != 0:             # not counting a monitoring eval
            per_step[L_] = (fk, dd[fk], bk, dd[bk])
    log(f'training path, --solver rk4: run() for {TRAIN_EPOCHS} epochs, '
        f'{len(steps)} steps in {train_s:.1f} s; launches {d}; per step '
        f'(fwd, bwd): ' + ', '.join(f'L={k}: {v}' for k, v in
                                    sorted(per_step.items()))
        + f'; losses first {losses[0]:.2f} last {losses[-1]:.2f}')
    out['rk4_per_step'] = per_step
    rstate = result['state']
    rstep = trainer.make_train_step(rargs.Ndata, eps_guard=rargs.eps_guard)
    # GPU vs CPU (float64) gradients, same noise: at the initial state of
    # seed + 7 and at the trained state
    init7 = init_model(args.seed + 7, device='cuda',
                       **dict(CONFIG, solver='rk4'))
    for label, (m, g) in (('initial state (seed + 7)', init7),
                          ('trained state', (rstate.model, rstate.gp))):
        check_grads(f'rk4: GPU vs CPU (float64) train-step gradients, '
                    f'{label} (L=1, same noise)', pinned_grads(
                        m, g, batch, step_noise(args.seed + 7, q, S, M),
                        rargs.Ndata, rargs.eps_guard, ('cuda', None),
                        ('cpu', torch.float64)))
    del init7
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        rstep(rstate, batch, L)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log('rk4 sync check: 1 train step (L=5) under set_sync_debug_mode('
        '"error"): no synchronising operation')
    out['rk4_step_ms'] = {}
    for L_ in (1, L):
        for _ in range(2):
            rstep(rstate, batch, L_)
        out['rk4_step_ms'][L_] = cuda_ms(lambda: rstep(rstate, batch, L_),
                                         10, warmup=0)
    log('rk4 train step (CUDA events over 10 steps): ' + ', '.join(
        f'L={k}: {v:.3f} ms' for k, v in out['rk4_step_ms'].items())
        + f'; card {card}')
    out['rk4'] = (rstate, rstep)

    # the per-step path against the fused pair: euler at the default shape
    # with the dispatch rule forced to the solvers
    from vae_gp_ode_tpu_torch.dynamics import flow as flow_mod
    est = trainer.create_train_state(*init_model(args.seed, device='cuda',
                                                 **CONFIG), lr=targs.lr)
    estep = trainer.make_train_step(targs.Ndata, eps_guard=targs.eps_guard)
    rule = flow_mod.use_fused_pair
    out['euler_ms'] = {}
    for fused in (True, False, False, True):
        flow_mod.use_fused_pair = rule if fused else (lambda *a: False)
        try:
            for L_ in (1, L):
                estep(est, batch, L_)
                ms = cuda_ms(lambda: estep(est, batch, L_), 10, warmup=1)
                out['euler_ms'].setdefault((fused, L_), []).append(ms)
        finally:
            flow_mod.use_fused_pair = rule
    log('euler train step, fused pair vs per-step kernels (CUDA events over '
        '10 steps, runs fused, per-step, per-step, fused): ' + '; '.join(
            f'{"fused" if f else "per-step"} L={L_}: '
            + ', '.join(f'{m:.3f}' for m in v) + ' ms'
            for (f, L_), v in sorted(out['euler_ms'].items()))
        + f'; card {card}')

    # -- dopri5 and the continuous adjoint: a few train steps ----------
    def state_for(**kw):
        m, g = init_model(args.seed, device='cuda', **dict(CONFIG, **kw))
        return trainer.create_train_state(m, g, lr=targs.lr)

    out['adaptive'] = {}
    for label, kw in (('dopri5', dict(solver='dopri5')),
                      ('rk4 adjoint', dict(solver='rk4', use_adjoint=True))):
        st = state_for(**kw)
        stp = trainer.make_train_step(targs.Ndata, eps_guard=targs.eps_guard)
        stp(st, batch, L)                            # warm-up
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)

        def few(st=st, stp=stp):
            ev0.record()
            ms = [stp(st, batch, L) for _ in range(3)]
            ev1.record()
            return ms
        mets, d = run_path(few)
        ms = ev0.elapsed_time(ev1) / 3
        lossv = [float(m['loss']) for m in mets]
        nfe = [int(m['nfe']) for m in mets]
        require(np.isfinite(lossv).all(), f'{label} losses {lossv}')
        fk, bk = rule_names('RBF', L, BATCH, q, S, M)
        require(d[fk] > 0 and d[bk] > 0 and d['flow_fused_fwd'] == 0,
                f'{label} launched {d}, the rule names {fk} and {bk}')
        log(f'{label}: 3 train steps (L=5) {ms:.3f} ms each (CUDA events); '
            f'losses {lossv}; nfe {nfe}; launches {d}; card {card}')
        out['adaptive'][label] = (ms, nfe, d)
    # the rk4 adjoint's gradients against rk4 backprop, same state + noise
    st = state_for(solver='rk4')
    noise = step_noise(args.seed + 8, q, S, M, L_=L)
    adjoint = copy.deepcopy(st.model)
    adjoint.use_adjoint = True
    with cudnn_deterministic():
        res = pinned_grads(adjoint, st.gp, batch, noise, targs.Ndata,
                           targs.eps_guard, ('cuda', None), ('cuda', None), L,
                           ref_model=st.model)
    check_grads('rk4 adjoint vs rk4 backprop on the card (L=5, same noise)',
                res)

    # -- the forecaster with dopri5 ---------------------------------------
    fm, fgp = init_model(args.seed, device='cuda', random_bn=True, **CONFIG)
    X = np.random.default_rng(args.seed + 9).random(
        (BATCH, T, 1, 28, 28)).astype(np.float32)
    fn = make_forecast_fn(fm, None, fgp, L=L, normalize_input=True,
                          solver='dopri5', device='cuda')
    fn(X, args.seed)                                          # warm-up
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)

    def request():
        ev0.record()
        y = fn(X, args.seed + 1)
        ev1.record()
        return y
    Xrec, d = run_path(request)
    require(Xrec.shape == (L, BATCH, T, 1, 28, 28) and bool(
        torch.isfinite(Xrec).all()), 'dopri5 forecast')
    fk = rule_names('RBF', L, BATCH, q, S, M)[0]
    require(d[fk] > 0 and d['flow_fused_fwd'] == 0,
            f'the dopri5 request launched {d}, the rule names {fk}')
    with torch.no_grad():
        Xn = (torch.as_tensor(X, device=dev) - 0.1307) / 0.3081
        nfe = int(fm(Xn, fgp, L=L, generator=torch.Generator(
            device=dev).manual_seed(args.seed))[3])
    out['forecast_dopri5'] = (ev0.elapsed_time(ev1), nfe, d)
    log(f'forecaster, dopri5 (default rtol/atol), one T={T} request at '
        f'L={L}: {out["forecast_dopri5"][0]:.3f} ms, nfe {nfe} over the '
        f'draws; launches {d}; card {card}')

    # -- kernel times at the main shapes ---------------------------------
    out['pathwise_ms'] = {}
    for L_, (x, operands, gbar) in sorted(main_ops.items()):
        with torch.no_grad():
            kf = cuda_ms(lambda: pathwise.fused_pathwise_eval(x, *operands),
                         200)
            pf = cuda_ms(lambda: pathwise.pathwise_eval_reference(
                x, *operands), 50)
        # the VJP kernel through autograd over the forward's graph, as the
        # solvers and the adjoint reach it (the graph kept between calls)
        inputs = [t.clone().requires_grad_() for t in (x,) + operands]
        o = pathwise.fused_pathwise_eval(*inputs)
        kb = cuda_ms(lambda: torch.autograd.grad(o, inputs, gbar,
                                                 retain_graph=True), 200)
        pb = cuda_ms(lambda: pathwise.pathwise_vjp_reference(
            x, *operands, gbar), 50)
        bars = torch.autograd.grad(o, inputs, gbar)
        D_, K_ = x.shape[-1], o.shape[-1]
        rows = x.shape[0] * x.shape[1]
        bf = pathwise_bound((x,) + operands + (o,), rows, D_, K_, S, M)
        bb = pathwise_bound((x,) + operands + (gbar,) + tuple(bars), rows,
                            D_, K_, S, M, bwd=True)
        out['pathwise_ms'][L_] = (kf, pf, bf, kb, pb, bb)
        out['calls'] = {  # the timed calls, for device time per launch
            pathwise.KERNEL: lambda x=x, ops_=operands:
                pathwise.fused_pathwise_eval(x, *ops_),
            pathwise.BWD_KERNEL: lambda inputs=inputs, gbar=gbar:
                torch.autograd.grad(pathwise.fused_pathwise_eval(*inputs),
                                    inputs, gbar)}
        log(f'pathwise kernels at the main shapes L={L_} (N=20, D=K=6, '
            f'S=256, M=100): fwd {kf:.4f} ms (plain {pf:.4f}, bound '
            f'{bf[0]:.5f} {bf[1]}), bwd {kb:.4f} ms through autograd, its '
            f'summing kernel included (plain '
            f'{pb:.4f}, bound {bb[0]:.5f} {bb[1]}); card {card}')
    out['rk4_profile'] = lambda: rstep(rstate, batch, L)
    return out


def df_eval_flops(D, SD, M):
    """f32 operations of one DF evaluation per row, counted from
    csrc/df_cluster.cuh `eval_items`: per feature column the dot product
    and phase (2D + 1), sin and cos (2) and the G contraction (4D); per
    inducing point the distance (3D) and per output-dim pair the envelope,
    the Hessian term and the accumulation (~12)."""
    return SD * (6 * D + 3) + M * (3 * D + 12 * D * D)


def df_vjp_flops(D, SD, M):
    """f32 operations of one DF evaluation's recompute and VJP per row,
    counted from the item loop of csrc/df_pathwise_bwd.cu: per feature column
    SD * (17 D + 6), per inducing point M * (8 D + 42 D^2)."""
    return SD * (17 * D + 6) + M * (8 * D + 42 * D * D)


def roofline(flops, tensors):
    """Least time (ms) on an H100: the larger of `flops` over the f32 peak
    and the bytes of `tensors` (inputs read once, outputs written once)
    over the memory rate; and which of the two bounds it."""
    nbytes = sum(4 * t.numel() for t in tensors)
    t_ops = flops / H100_FP32_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')


def to_device(obj, device, dtype=None):
    """A copy of an SVGPParams or FnSample (dataclasses of tensors, nested)
    with every tensor moved to `device` (and `dtype`)."""
    import torch
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if torch.is_tensor(v):
            kw[f.name] = v.to(device, dtype)
        elif dataclasses.is_dataclass(v):
            kw[f.name] = to_device(v, device, dtype)
    return dataclasses.replace(obj, **kw)


# a DF width at q=6 whose adjoint block of an 8-block cluster exceeds the
# H100's opt-in shared memory: the pair refuses it (df_pair_fits)
DF_REFUSED_S = 2048


def df_paths(args, card, batch, slice_launches):
    """The divergence-free (DF) paths of this slice: kernels #5-#8 against
    their plain versions, the training CLI's run() with --kernel DF, DF
    with rk4 and the rk4 adjoint, the DF forecaster with random weights
    and from the shipped checkpoint checkpoints/df_5000ep, and the DF
    timings. Adds each path run's launches to `slice_launches` (counts set
    to 0 just before it, read just after) and returns what the summary
    line needs."""
    import numpy as np
    import torch
    from vae_gp_ode_tpu_torch import main as train_cli
    from vae_gp_ode_tpu_torch import ops
    from vae_gp_ode_tpu_torch.dynamics.flow import flow_forward
    from vae_gp_ode_tpu_torch.gp.svgp import draw_fn_sample, init_svgp_params
    from vae_gp_ode_tpu_torch.kernels import divfree
    from vae_gp_ode_tpu_torch.models.odegpvae import init_model
    from vae_gp_ode_tpu_torch.ops import (
        df_flow_fused, df_pathwise, df_pathwise_tiled)
    from vae_gp_ode_tpu_torch.serving import make_forecast_fn
    from vae_gp_ode_tpu_torch.training import checkpoint, trainer

    dev = torch.device('cuda')
    q, S, M = CONFIG['latent_dim'], CONFIG['num_features'], \
        CONFIG['num_inducing']
    DFC = dict(CONFIG, kernel='DF')
    gen = torch.Generator(device=dev).manual_seed(args.seed + 21)
    rng = np.random.default_rng(args.seed + 21)
    out = {}

    run_path = functools.partial(count_path, launches=slice_launches)

    def df_ops(L_, N_, q_=q, S_=S, ls=2.0):
        g = init_svgp_params(rng, q_, q_, M, kernel='DF', lengthscale=ls,
                             variance=0.7, device='cuda')
        with torch.no_grad():
            operands = df_pathwise.df_fused_operands(
                g, draw_fn_sample(g, gen, S_, L=L_))
        require(all(bool(torch.isfinite(t).all()) for t in operands),
                f'non-finite DF sample at q={q_} S={S_}')
        return torch.randn((L_, N_, q_), generator=gen, device=dev), operands

    # -- kernels #5 and #6 against their plain versions -------------------
    log('kernels df_pathwise_fwd / df_pathwise_bwd vs df_pathwise_reference '
        '(and autograd through it) on the card:')
    fwd_errs, bwd_errs, main5 = [], [], {}
    for name, L_, N_, q_, S_, ls, per_draw in (
            ('L=1, N=20, D=6 (main)', 1, BATCH, q, S, 2.0, False),
            ('L=5, N=20, D=6 (main)', L, BATCH, q, S, 2.0, False),
            ('L=5, N=600', L, 600, q, S, 2.0, False),
            ('L=5, D=3 (ls 0.5)', L, BATCH, 3, S, 0.5, False),
            ('L=5, Z, ls2, var per draw', L, BATCH, q, S, 2.0, True),
            ('L=5, S=512', L, BATCH, q, 512, 2.0, False)):
        x, operands = df_ops(L_, N_, q_, S_, ls)
        if per_draw:
            operands = list(operands)
            for i in (3, 5, 6):
                operands[i] = (operands[i].expand(
                    (L_,) + tuple(operands[i].shape)) * (
                    1.0 + 0.05 * torch.arange(L_, device=dev).reshape(
                        (L_,) + (1,) * operands[i].dim()))).contiguous()
            operands = tuple(operands)
        with torch.no_grad():
            o = df_pathwise.fused_df_pathwise_eval(x, *operands)
            o2 = df_pathwise.fused_df_pathwise_eval(x, *operands)
            r = df_pathwise.df_pathwise_reference(x, *operands)
        torch.cuda.synchronize()
        require(o.shape == (L_, N_, q_), f'shape {o.shape}')
        fwd_errs.append(compare(o, r, 'fwd ' + name))
        # #5 sums fixed partials in a fixed order over its cluster
        require(torch.equal(o, o2), f'{name}: two launches of '
                                    f'df_pathwise_fwd differ')
        inputs = [t.clone().requires_grad_() for t in (x,) + operands]
        o = df_pathwise.fused_df_pathwise_eval(*inputs)
        gbar = torch.randn(o.shape, generator=gen, device=dev)
        bars = torch.autograd.grad(o, inputs, gbar)
        ref = df_pathwise.df_pathwise_vjp_reference(x, *operands, gbar)
        torch.cuda.synchronize()
        bwd_errs.append(compare_bwd(bars, ref, 'bwd ' + name,
                                    ('x',) + df_pathwise.NAMES))
        # #6 and its summing kernel add fixed partials in a fixed order
        again = torch.autograd.grad(
            df_pathwise.fused_df_pathwise_eval(*inputs), inputs, gbar)
        require(all(torch.equal(a, b) for a, b in zip(bars, again)),
                f'{name}: two launches of df_pathwise_bwd differ')
        if 'main' in name:
            main5[L_] = (x, operands, gbar)
    out['pathwise_err'] = (max(fwd_errs), max(bwd_errs))

    # -- kernels #7 and #8 against their plain versions -------------------
    log('kernels df_flow_fused_fwd / df_flow_fused_bwd vs '
        'df_euler_flow_reference (and autograd through it) on the card:')
    # D=3 runs 3 steps: its field (|f| ~ 20 at lengthscale 0.5) triples an
    # f32 rounding difference every step, so at T=16 the f32 and float64
    # trajectories of the plain version already differ by 2.2 (CPU)
    flow_cases = (
        ('L=1, N=20, T=16 (main)', 1, BATCH, q, S, 2.0, T, True, False,
         False),
        ('L=5, N=20, T=16 (main)', L, BATCH, q, S, 2.0, T, True, False,
         False),
        ('L=5, N=600', L, 600, q, S, 2.0, T, True, False, False),
        ('L=5, D=3 (ls 0.5), T=4, non-uniform dts', L, BATCH, 3, S, 0.5,
         4, False, False, False),
        ('L=5, z0 per draw', L, BATCH, q, S, 2.0, T, True, True, False),
        ('L=5, Z, ls2, var per draw', L, BATCH, q, S, 2.0, T, True,
         False, True),
        ('L=5, S=512 (taken since the adjoint\'s clusters)', L, BATCH, q,
         512, 2.0, T, True, False, False),
        ('L=1, D=12 (two-row instances; taken since the clusters)', 1,
         BATCH, 12, S, 2.0, T, True, False, False))

    def flow_inputs(L_, N_, q_, S_, ls, T_, uniform, z0_per_draw,
                    per_draw):
        """z0, the operands, dts and the cotangent zsbar of a trajectory
        case, drawn in this order from gen and rng."""
        x, operands = df_ops(L_, N_, q_, S_, ls)
        if per_draw:
            operands = list(operands)
            for i in (3, 5, 6):
                operands[i] = (operands[i].expand(
                    (L_,) + tuple(operands[i].shape)) * (
                    1.0 + 0.05 * torch.arange(L_, device=dev).reshape(
                        (L_,) + (1,) * operands[i].dim()))).contiguous()
            operands = tuple(operands)
        dts = (torch.full((T_ - 1,), CONFIG['dt'], device=dev) if uniform
               else torch.rand(T_ - 1, generator=gen, device=dev) * 0.15
               + 0.05)
        zsbar = torch.randn((L_, T_, N_, q_), generator=gen, device=dev)
        return x if z0_per_draw else x[0], operands, dts, zsbar

    def plain64(zs, zsbar, operands, dts, T_, z0_per_draw):
        """The float64 plain version's cotangents from z0 = zs[:, 0]."""
        r64 = list(df_flow_fused.df_flow_vjp_reference(
            zs.double(), zsbar.double(), *(t.double() for t in operands),
            dts.double(), T_))
        if not z0_per_draw:
            r64[0] = r64[0].sum(0)
        return r64

    def f64_errors(bars, ref, zs, zsbar, operands, dts, T_, z0_per_draw):
        """Per cotangent, max |kernel - float64 plain| and max |f32 plain
        - float64 plain|, the float64 plain version on the same zs."""
        return [(float((a.double() - c).abs().max()),
                 float((b.double() - c).abs().max()))
                for a, b, c in zip(bars, ref, plain64(
                    zs, zsbar, operands, dts, T_, z0_per_draw))]

    def within_f32_noise(name, errs):
        """Logs the float64 errors of a chaotic case and requires the
        kernel to be no farther from float64 than F64_NOISE times the f32
        plain version, per cotangent."""
        log('  ' + name + ', float64 plain version: max |kernel - f64| / '
            'max |f32 plain - f64| per cotangent: ' + ', '.join(
                f'{k:.2e} / {p:.2e}' for k, p in errs))
        require(all(k <= F64_NOISE * p for k, p in errs),
                f'{name}: #8 is farther from float64 than {F64_NOISE} '
                f'times the f32 plain version: {errs}')

    fwd_errs, bwd_errs, main7 = [], [], {}
    # the draws' state before the trajectory checks, for the D=3 case on
    # the inputs that an earlier order of the checks gave it (below)
    before_flows = (gen.get_state(), rng.bit_generator.state)
    for case in flow_cases:
        name, L_, N_, q_, S_, ls, T_, uniform, z0_per_draw, per_draw = case
        z0, operands, dts, zsbar = flow_inputs(*case[1:])
        with torch.no_grad():
            zs = df_flow_fused.packed_df_euler_flow(z0, *operands, dts, T_)
            zs2 = df_flow_fused.packed_df_euler_flow(z0, *operands, dts, T_)
            ref = df_flow_fused.df_euler_flow_reference(z0, *operands, dts,
                                                        T_)
        torch.cuda.synchronize()
        require(zs.shape == (L_, T_, N_, q_), f'shape {zs.shape}')
        fwd_errs.append(compare(zs, ref, 'fwd ' + name))
        # every block of #7's clusters adds the same partials in the same
        # order
        require(torch.equal(zs, zs2), f'{name}: two launches of '
                                      f'df_flow_fused_fwd differ')
        inputs = [t.clone().requires_grad_() for t in (z0, *operands, dts)]
        zs = df_flow_fused.packed_df_euler_flow(*inputs, T_)
        bars = torch.autograd.grad(zs, inputs, zsbar)
        ref = list(df_flow_fused.df_flow_vjp_reference(
            zs.detach(), zsbar, *operands, dts, T_))
        if not z0_per_draw:
            ref[0] = ref[0].sum(0)
        torch.cuda.synchronize()
        if q_ == 3:
            within_f32_noise(name, f64_errors(bars, ref, zs.detach(), zsbar,
                                              operands, dts, T_,
                                              z0_per_draw))
        # The adjoint walks the kernel's trajectory, the f32 plain version
        # its own: their f32 rounding differs, and a field that amplifies
        # it puts the f32 plain version itself outside the tolerance of
        # float64 (at S=512 on an H100 its ls2 cotangent sat 1.2 times the
        # tolerance from float64, the kernels' 0.56 times; PERF.md section
        # 6). So #7 and #8 are held to the float64 plain version at the
        # same tolerance, and the f32 comparison is logged.
        names = ('z0',) + df_pathwise.NAMES + ('dts',)
        bwd_errs.append(compare_bwd(
            bars, plain64(zs.detach(), zsbar, operands, dts, T_,
                          z0_per_draw),
            f'bwd {name}, against the float64 plain version', names))
        try:
            compare_bwd(bars, ref, f'bwd {name}, against the f32 plain '
                                   f'version', names)
        except AssertionError:
            log(f'  {name}: outside the tolerance of the f32 plain version, '
                f'within that of the float64 one')
        # #8 and its summing kernel add fixed partials in a fixed order
        again = torch.autograd.grad(
            df_flow_fused.packed_df_euler_flow(*inputs, T_), inputs, zsbar)
        require(all(torch.equal(a, b) for a, b in zip(bars, again)),
                f'{name}: two launches of df_flow_fused_bwd differ')
        if 'main' in name:
            main7[L_] = (z0, operands, dts, zs.detach(), zsbar)
    out['flow_err'] = (max(fwd_errs), max(bwd_errs))

    # #5 and #6 at D=12 (their two-row instances)
    d12 = (1, BATCH, 12, 512, 2.0)
    x, operands = df_ops(*d12)
    name = 'L=1, S=512, D=12 (two-row instances)'
    with torch.no_grad():
        o = df_pathwise.fused_df_pathwise_eval(x, *operands)
        o2 = df_pathwise.fused_df_pathwise_eval(x, *operands)
        r = df_pathwise.df_pathwise_reference(x, *operands)
    torch.cuda.synchronize()
    errs5 = [compare(o, r, 'fwd ' + name)]
    require(torch.equal(o, o2), f'{name}: two launches of df_pathwise_fwd '
                                f'differ')
    inputs = [t.clone().requires_grad_() for t in (x,) + operands]
    gbar = torch.randn(o.shape, generator=gen, device=dev)
    bars = torch.autograd.grad(df_pathwise.fused_df_pathwise_eval(*inputs),
                               inputs, gbar)
    ref = df_pathwise.df_pathwise_vjp_reference(x, *operands, gbar)
    torch.cuda.synchronize()
    errs6 = [compare_bwd(bars, ref, 'bwd ' + name,
                         ('x',) + df_pathwise.NAMES)]
    out['pathwise_err'] = (max(out['pathwise_err'][0], *errs5),
                           max(out['pathwise_err'][1], *errs6))

    # The chaotic D=3 case again, on the inputs it drew when the D=12 case
    # above ran before the trajectory checks: there #8 against the f32
    # plain version missed the tolerance (PERF.md section 7), while both
    # sit at f32 noise from float64. Held to float64 as above; the f32
    # comparison is logged. The draws go on from where they were.
    after = (gen.get_state(), rng.bit_generator.state)
    gen.set_state(before_flows[0])
    rng.bit_generator.state = before_flows[1]
    df_ops(*d12)
    torch.randn((1, BATCH, 12), generator=gen, device=dev)
    for case in flow_cases[:3]:
        flow_inputs(*case[1:])
    case = flow_cases[3]
    name, L_, N_, q_, S_, ls, T_, uniform, z0_per_draw, per_draw = case
    name += ', the inputs of the earlier order'
    z0, operands, dts, zsbar = flow_inputs(*case[1:])
    gen.set_state(after[0])
    rng.bit_generator.state = after[1]
    inputs = [t.clone().requires_grad_() for t in (z0, *operands, dts)]
    zs = df_flow_fused.packed_df_euler_flow(*inputs, T_)
    with torch.no_grad():
        fwd_ref = df_flow_fused.df_euler_flow_reference(z0, *operands, dts,
                                                        T_)
    compare(zs.detach(), fwd_ref, 'fwd ' + name)
    bars = torch.autograd.grad(zs, inputs, zsbar)
    ref = list(df_flow_fused.df_flow_vjp_reference(
        zs.detach(), zsbar, *operands, dts, T_))
    ref[0] = ref[0].sum(0)
    torch.cuda.synchronize()
    within_f32_noise(name, f64_errors(bars, ref, zs.detach(), zsbar,
                                      operands, dts, T_, z0_per_draw))
    try:
        compare_bwd(bars, ref, 'bwd ' + name,
                    ('z0',) + df_pathwise.NAMES + ('dts',))
    except AssertionError:
        log(f'  {name}: outside the f32 tolerance of the f32 plain '
            f'version, within the float64 noise check above')

    # -- the pair's rule, and a step at a shape it refuses -----------------
    lib = df_flow_fused._bwd_lib()
    optin = lib.df_flow_fused_bwd_smem_optin(0)
    for (q_, S_), fits in (((6, 256), True), ((6, 512), True),
                           ((12, 256), True), ((6, 2048), False),
                           ((16, 256), False)):
        nbytes = lib.df_flow_fused_bwd_smem_bytes(q_, S_ * q_, M)
        got = df_flow_fused.df_fused_pair_fits(q_, S_ * q_, M, dev)
        require(got == fits, f'DF rule at q={q_} S={S_}: {got}')
        log(f'  DF rule: q={q_}, S={S_}: adjoint block {nbytes} B of '
            f'{optin} B opt-in -> {"fused pair" if got else "per-step"}')
    wide, wide_gp = init_model(args.seed + 22, device='cuda',
                               **dict(DFC, num_features=DF_REFUSED_S))
    noise = step_noise(args.seed + 23, q, DF_REFUSED_S, M, df=True)
    relu_k = {}
    with cudnn_deterministic():
        (loss_g, _, _, g_gpu), d = run_path(lambda: step_grads(
            wide, wide_gp, batch, noise, 360.0, True, 'cuda',
            relu_in=relu_k))
    fk, bk = rule_names('DF', 1, BATCH, q, DF_REFUSED_S, M)
    require(d[fk] > 0 and d[bk] > 0 and d['df_flow_fused_fwd'] == 0 and
            d['df_flow_fused_bwd'] == 0, f'the DF S={DF_REFUSED_S} step '
            f'launched {d}, the rule names {fk} and {bk}')
    kernel_eval = df_pathwise_tiled.df_pathwise_eval
    df_pathwise_tiled.df_pathwise_eval = df_pathwise.df_pathwise_reference
    relu_p = {}
    try:
        with cudnn_deterministic():
            (loss_p, _, _, g_plain), dp = run_path(lambda: step_grads(
                wide, wide_gp, batch, noise, 360.0, True, 'cuda',
                relu_in=relu_p, relu_pin=relu_k))
    finally:
        df_pathwise_tiled.df_pathwise_eval = kernel_eval
    require(not any(dp.values()), f'the plain DF S={DF_REFUSED_S} step '
                                  f'launched {dp}')
    check_grads(f'DF, one train step at S={DF_REFUSED_S} (the pair refuses '
                f'it; L=1), '
                f'launches {d}, against autograd through the plain version '
                f'on the card', (float(loss_g), float(loss_p),
                                 *worst_grad_error(g_gpu, g_plain, wide),
                                 *relu_flips(relu_k, relu_p)))
    del wide, wide_gp

    # -- the default DF training run: the CLI's run() ----------------------
    save = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                        'chip_smoke', 'df')
    dargs = train_args(save, '--kernel', 'DF', '--lengthscale', '2.0',
                       '--variance', '0.7')
    steps, seen = [], {}

    def on_step(ep, L_):
        now = dict(ops.LAUNCHES)
        steps.append((ep, L_, deltas(seen, now)))
        seen.update(now)

    t0 = time.perf_counter()
    result, d = run_path(lambda: train_cli.run(dargs, on_step=on_step))
    train_s = time.perf_counter() - t0
    require(result['bailout'] is None, 'NaN bailout in the DF run')
    per_epoch = dargs.Ndata // dargs.batch + bool(dargs.Ndata % dargs.batch)
    require(len(steps) == TRAIN_EPOCHS * per_epoch, f'{len(steps)} steps')
    for i, (ep, L_, dd) in enumerate(steps):
        evals = 1 if i % per_epoch == 0 and ep > 0 else 0
        others = {k: v for k, v in dd.items() if not k.startswith('df_flow')}
        require(dd['df_flow_fused_fwd'] == 1 + evals and
                dd['df_flow_fused_bwd'] == 1 and not any(others.values()),
                f'DF train step {i} (epoch {ep}, L={L_}) launched {dd}')
    losses = np.concatenate([e['loss'] for e in result['epochs']])
    require(np.isfinite(losses).all() and losses.size == len(steps),
            f'DF losses {losses}')
    mses = [float(e['mse']) for e in result['epochs']]
    require(np.isfinite(mses).all(), f'DF monitoring mse {mses}')
    log(f'training path, --kernel DF: run() for {TRAIN_EPOCHS} epochs, '
        f'{len(steps)} steps in {train_s:.1f} s; every step launched '
        f'df_flow_fused_fwd and df_flow_fused_bwd once and no other kernel; '
        f'launches {d}; losses first {losses[0]:.2f} last {losses[-1]:.2f}; '
        f'monitoring mse {", ".join(f"{m:.4f}" for m in mses)}')
    dstate = result['state']
    dstep = trainer.make_train_step(dargs.Ndata, eps_guard=dargs.eps_guard)
    check_grads('DF: GPU vs CPU (float64) train-step gradients at the '
                'trained state (L=1, same noise)', pinned_grads(
                    dstate.model, dstate.gp, batch,
                    step_noise(args.seed + 24, q, S, M, df=True),
                    dargs.Ndata, dargs.eps_guard, ('cuda', None),
                    ('cpu', torch.float64)))

    # -- DF with rk4, and the rk4 continuous adjoint -----------------------
    rm, rgp = init_model(args.seed + 25, device='cuda',
                         **dict(DFC, solver='rk4'))
    rst = trainer.create_train_state(rm, rgp, lr=dargs.lr)
    rstep = trainer.make_train_step(dargs.Ndata, eps_guard=dargs.eps_guard)
    rstep(rst, batch, L)                                     # warm-up
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)

    def few():
        ev0.record()
        ms = [rstep(rst, batch, L) for _ in range(3)]
        ev1.record()
        return ms
    mets, d = run_path(few)
    lossv = [float(m['loss']) for m in mets]
    require(np.isfinite(lossv).all(), f'DF rk4 losses {lossv}')
    fk, bk = rule_names('DF', L, BATCH, q, S, M)
    require(d[fk] > 0 and d[bk] > 0 and d['df_flow_fused_fwd'] == 0 and
            d['df_flow_fused_bwd'] == 0 and d['pathwise_fwd'] == 0,
            f'DF rk4 launched {d}, the rule names {fk} and {bk}')
    out['rk4_ms'] = ev0.elapsed_time(ev1) / 3
    log(f'DF --solver rk4: 3 train steps (L=5) {out["rk4_ms"]:.3f} ms each '
        f'(CUDA events); losses {lossv}; launches {d}; card {card}')
    check_grads('DF rk4: GPU vs CPU (float64) train-step gradients (L=1, '
                'same noise)', pinned_grads(
                    rst.model, rst.gp, batch,
                    step_noise(args.seed + 26, q, S, M, df=True),
                    dargs.Ndata, dargs.eps_guard, ('cuda', None),
                    ('cpu', torch.float64)))
    adjoint = copy.deepcopy(rst.model)
    adjoint.use_adjoint = True
    noise = step_noise(args.seed + 27, q, S, M, L_=L, df=True)
    with cudnn_deterministic():
        res, d = run_path(lambda: pinned_grads(
            adjoint, rst.gp, batch, noise, dargs.Ndata, dargs.eps_guard,
            ('cuda', None), ('cuda', None), L, ref_model=rst.model))
    bk = rule_names('DF', L, BATCH, q, S, M)[1]
    require(d[bk] > 0 and d['df_flow_fused_fwd'] == 0,
            f'DF rk4 adjoint launched {d}, the rule names {bk}')
    check_grads('DF rk4 adjoint vs rk4 backprop on the card (L=5, same '
                'noise)', res)
    out['rk4_profile'] = lambda: rstep(rst, batch, L)

    # -- the DF forecaster: random weights, then the shipped checkpoint ---
    fm, fgp = init_model(args.seed + 28, device='cuda', random_bn=True,
                         **DFC)
    fn = make_forecast_fn(fm, None, fgp, L=L, normalize_input=True,
                          device='cuda')
    fn_roll = make_forecast_fn(fm, None, fgp, L=L, T_custom=T * TROLL,
                               normalize_input=True, device='cuda')
    raw = [np.random.default_rng(args.seed + 29 + i).random(
        (BATCH, T, 1, 28, 28)).astype(np.float32) for i in range(3)]
    fn(raw[0], args.seed)                                    # warm-up
    fn_roll(raw[0], args.seed)
    torch.cuda.synchronize()
    out['request_ms'] = []
    for i, (f, X, Tout) in enumerate([(fn, raw[0], T), (fn, raw[1], T),
                                      (fn, raw[2], T),
                                      (fn_roll, raw[0], T * TROLL)]):
        ev0.record()
        Xrec, d = run_path(lambda: f(X, args.seed + i))
        ev1.record()
        torch.cuda.synchronize()
        out['request_ms'].append(ev0.elapsed_time(ev1))
        require(Xrec.shape == (L, BATCH, Tout, 1, 28, 28) and bool(
            torch.isfinite(Xrec).all()), f'DF forecast {i}')
        require(d['df_flow_fused_fwd'] == 1 and sum(d.values()) == 1,
                f'DF request {i} launched {d}')
    log(f'DF forecaster (random weights, L={L}): requests T={T} '
        + ', '.join(f'{m:.3f}' for m in out['request_ms'][:3])
        + f' ms, rollout T={T * TROLL} {out["request_ms"][3]:.3f} ms (CUDA '
        f'events, host work included), one df_flow_fused_fwd launch each; '
        f'card {card}')

    # GPU forward vs the port's CPU forward, same noise (as for RBF)
    n_small, L_small = 4, 2
    fnoise = {k: torch.as_tensor(v[:n_small] if k == 'z0' else v,
                                 dtype=torch.float32) for k, v in step_noise(
        args.seed + 31, q, S, M, L_=L_small, df=True).items()}
    Xs = (torch.as_tensor(raw[1][:n_small]) - 0.1307) / 0.3081
    with torch.no_grad():
        gpu_out = fm.eval()(Xs.to(dev), fgp, L=L_small, noise={
            k: v.to(dev) for k, v in fnoise.items()})[0]
        cpu_out = copy.deepcopy(fm).to('cpu').eval()(
            Xs, fgp.to('cpu'), L=L_small, noise=fnoise)[0]
    fwd_err = float((gpu_out.cpu() - cpu_out).abs().max())
    log(f'DF: GPU forward vs CPU forward ({n_small} sequences, L={L_small}, '
        f'same noise, random weights): max abs err {fwd_err:.3e} (tol '
        f'{TOL_FORWARD:g})')
    require(fwd_err <= TOL_FORWARD, 'the DF GPU forward disagrees with the '
            'CPU forward')
    out['forward_err'] = fwd_err

    # the shipped checkpoint (a trained DF run of the JAX package), read
    # with numpy alone
    ckdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         'checkpoints', 'df_5000ep')
    with open(os.path.join(ckdir, 'args.json')) as fh:
        ta = json.load(fh)
    cm, cgp = init_model(0, latent_dim=ta['latent_dim'],
                         n_filt=ta['n_filt'], dt=ta['dt'],
                         num_features=ta['num_features'],
                         num_inducing=ta['num_inducing'],
                         kernel=ta['kernel'], device='cuda')
    cst = checkpoint.restore_jax_checkpoint(
        os.path.join(ckdir, 'odegpvae_mnist.ckpt'),
        trainer.create_train_state(cm, cgp))
    with torch.no_grad():
        Ku = divfree.df_gram(cst.gp.kernel, cst.gp.inducing_loc).to(
            'cpu', torch.float64)
        Ku = (Ku + Ku.T) / 2 + 1e-5 * torch.eye(Ku.shape[0],
                                               dtype=torch.float64)
        cond = float(torch.linalg.cond(Ku))
    cfn = make_forecast_fn(cst.model, None, cst.gp, L=L,
                           normalize_input=True, device='cuda')
    cnoise = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
              for k, v in step_noise(args.seed + 30, q, ta['num_features'],
                                     ta['num_inducing'], L_=L,
                                     df=True).items()}
    Xc, d = run_path(lambda: cfn(raw[1], 0, noise=cnoise))
    require(Xc.shape == (L, BATCH, T, 1, 28, 28) and bool(
        torch.isfinite(Xc).all()), 'the checkpoint forecast is not finite')
    require(d['df_flow_fused_fwd'] == 1, f'checkpoint request launched {d}')
    cpu_model = copy.deepcopy(cst.model).to('cpu').eval()
    cpu_gp = cst.gp.to('cpu')
    Xn = (torch.as_tensor(raw[1]) - 0.1307) / 0.3081
    cpu_noise = {k: v.cpu() for k, v in cnoise.items()}
    ts = CONFIG['dt'] * torch.arange(T, dtype=torch.float32)
    with torch.no_grad():
        Xcpu = cpu_model(Xn, cpu_gp, L=L, noise=cpu_noise)[0]
        gsample = draw_fn_sample(cst.gp, None, ta['num_features'],
                                 noise=cnoise)
        # the trajectory of one sample (the CPU's) on the card (kernel #7),
        # by the plain version on the CPU in f32, and in float64
        smp = draw_fn_sample(cpu_gp, None, ta['num_features'],
                             noise=cpu_noise)
        z0c = cpu_model.encode(Xn, reparam_noise=(cpu_noise['z0'], None))[0]
        zs_gpu, dd = run_path(lambda: flow_forward(
            cst.gp, to_device(smp, dev), z0c.to(dev), ts.to(dev))[0])
        zs_32 = flow_forward(cpu_gp, smp, z0c, ts, device='cpu')[0]
        zs_64 = flow_forward(to_device(cpu_gp, 'cpu', torch.float64),
                             to_device(smp, 'cpu', torch.float64),
                             z0c.double(), ts.double(), device='cpu')[0]
    require(dd['df_flow_fused_fwd'] == 1, f'checkpoint flow launched {dd}')
    nu_rel = float((gsample.nu.cpu() - smp.nu).abs().max()
                   / smp.nu.abs().max())
    err_req = float((Xc.cpu() - Xcpu).abs().max())
    err_gpu = float((zs_gpu.cpu().double() - zs_64).abs().max())
    err_32 = float((zs_32.double() - zs_64).abs().max())
    log(f'forecaster from checkpoints/df_5000ep (restore_jax_checkpoint; '
        f'step {int(cst.step)}), L={L}, 20 sequences, T={T}: frames '
        f'finite, one df_flow_fused_fwd launch; the trained (600, 600) '
        f'gram + jitter has condition number {cond:.3e} (float64), so '
        f'cuSOLVER\'s and LAPACK\'s f32 nu differ by {nu_rel:.3e} of the '
        f'largest and the request\'s frames by {err_req:.3e} from the CPU '
        f'forward with the same noise; one sample\'s latent trajectory '
        f'against float64 on the CPU: kernel {err_gpu:.3e}, the plain '
        f'version in f32 {err_32:.3e} (max |z| '
        f'{float(zs_64.abs().max()):.3f})')
    require(err_gpu <= 4.0 * err_32 + TOL_ABS, 'the DF trajectory kernel is '
            'less accurate than its plain version on the trained model')
    require(err_req <= 0.1, 'the checkpoint forecast moved further from the '
            'CPU forward than the gram\'s conditioning explains')
    out['ckpt'] = (cond, nu_rel, err_req, err_gpu, err_32)

    # -- times ---------------------------------------------------------------
    out['kernel_ms'] = {}
    for L_ in (1, L):
        x, operands, gbar = main5[L_]
        rows = x.shape[0] * x.shape[1]
        SD = operands[0].shape[-1]
        with torch.no_grad():
            o = df_pathwise.fused_df_pathwise_eval(x, *operands)
            k5 = cuda_ms(lambda: df_pathwise.fused_df_pathwise_eval(
                x, *operands), 200)
            p5 = cuda_ms(lambda: df_pathwise.df_pathwise_reference(
                x, *operands), 20)
        b5 = roofline(rows * df_eval_flops(q, SD, M), (x,) + operands + (o,))
        inputs = [t.clone().requires_grad_() for t in (x,) + operands]
        oo = df_pathwise.fused_df_pathwise_eval(*inputs)
        k6 = cuda_ms(lambda: torch.autograd.grad(oo, inputs, gbar,
                                                 retain_graph=True), 200)
        p6 = cuda_ms(lambda: df_pathwise.df_pathwise_vjp_reference(
            x, *operands, gbar), 20)
        bars = torch.autograd.grad(oo, inputs, gbar)
        b6 = roofline(rows * df_vjp_flops(q, SD, M),
                      (x,) + operands + (gbar,) + tuple(bars))
        z0, ops7, dts, zs, zsbar = main7[L_]
        with torch.no_grad():
            k7 = cuda_ms(lambda: df_flow_fused.packed_df_euler_flow(
                z0, *ops7, dts, T), 100)
            p7 = cuda_ms(lambda: df_flow_fused.df_euler_flow_reference(
                z0, *ops7, dts, T), 5)
        rows7 = L_ * BATCH * (T - 1)
        b7 = roofline(rows7 * (df_eval_flops(q, SD, M) + 2 * q),
                      (z0,) + ops7 + (dts, zs))
        k8 = cuda_ms(lambda: df_flow_fused.df_flow_vjp(
            zs, zsbar, *ops7, dts, T), 100)
        p8 = cuda_ms(lambda: df_flow_fused.df_flow_vjp_reference(
            zs, zsbar, *ops7, dts, T), 5)
        outs8 = df_flow_fused.df_flow_vjp(zs, zsbar, *ops7, dts, T)
        b8 = roofline(rows7 * df_vjp_flops(q, SD, M),
                      (zs, zsbar) + ops7 + (dts,) + tuple(outs8))
        out['calls'] = {  # the timed calls, for device time per launch
            'df_pathwise_fwd': lambda x=x, ops_=operands:
                df_pathwise.fused_df_pathwise_eval(x, *ops_),
            'df_pathwise_bwd': lambda inputs=inputs, gbar=gbar:
                torch.autograd.grad(df_pathwise.fused_df_pathwise_eval(
                    *inputs), inputs, gbar),
            'df_flow_fused_fwd': lambda z0=z0, ops7=ops7, dts=dts:
                df_flow_fused.packed_df_euler_flow(z0, *ops7, dts, T),
            'df_flow_fused_bwd': lambda zs=zs, zsbar=zsbar, ops7=ops7,
                dts=dts: df_flow_fused.df_flow_vjp(zs, zsbar, *ops7, dts, T)}
        out['kernel_ms'][L_] = {'df_pathwise_fwd': (k5, p5, b5),
                                'df_pathwise_bwd': (k6, p6, b6),
                                'df_flow_fused_fwd': (k7, p7, b7),
                                'df_flow_fused_bwd': (k8, p8, b8)}
        log(f'DF kernels at the main shapes L={L_} (N=20, D=6, S=256, '
            f'M=100, T=16), ms (plain; bound): ' + '; '.join(
                f'{k} {v[0]:.4f} ({v[1]:.4f}; {v[2][0]:.5f} {v[2][1]})'
                for k, v in out['kernel_ms'][L_].items())
            + f'; #6 through torch.autograd.grad, #6/#8 with slab sums; '
            f'card {card}')
    out['step_ms'] = {}
    for L_ in (1, L):
        for _ in range(2):
            dstep(dstate, batch, L_)
        out['step_ms'][L_] = cuda_ms(lambda: dstep(dstate, batch, L_), 20,
                                     warmup=0)
    log('DF train step (CUDA events over 20 steps, batch on the card): '
        + ', '.join(f'L={k}: {v:.3f} ms' for k, v in out['step_ms'].items())
        + f'; card {card}')
    out['step_profile'] = lambda: dstep(dstate, batch, L)
    out['step1_profile'] = lambda: dstep(dstate, batch, 1)
    out['request_profile'] = lambda: fn(raw[1], args.seed)
    return out


# the DF state widths of phase 6e: above the 16 of the single-block pair
# (#5/#6) and of the trajectory pair (#7/#8), so only the tiled pair's
# wide kernels (#11/#12) take them
DF_WIDE_Q = 20
DF_WIDEST_Q = 64
# the lengthscale of the DF steps at latent_dim DF_WIDEST_Q: the DF field's
# Jacobian is ~(D - 1) var / ls2, 11 at CONFIG's lengthscale 2, and a
# trajectory through such a field amplifies f32 rounding, so that two f32
# runs that sum in other orders (the kernels and the plain version) differ
# by more than TOL_GRAD (on an H100 2.0e-2 of a conv bias's largest
# gradient, with 4,709 ReLU units on the other branch; PERF.md); at 8 it
# is 0.69
DF_WIDEST_LS = 8.0


def df_wide_state(args, card, batch, slice_launches):
    """DF above state dim 16 (phase 6e): the tiled pair #11/#12 against
    its plain version on the card at D = DF_WIDE_Q, 48, 49, DF_WIDEST_Q
    and 260 (its wide kernels; L = 1 and 5, two launches for the same
    bits), and one DF euler and one DF rk4 train step each at latent_dim
    DF_WIDE_Q and DF_WIDEST_Q (L=5) through the kernels the rule names
    against autograd through the plain version on the card, same noise
    (TOL_GRAD, RELU_FLIP). Adds each path run's launches to
    `slice_launches` (counts set to 0 just before it, read just after)
    and returns the largest kernel errors."""
    import numpy as np
    import torch
    from vae_gp_ode_tpu_torch.gp.svgp import draw_fn_sample, init_svgp_params
    from vae_gp_ode_tpu_torch.models.odegpvae import init_model
    from vae_gp_ode_tpu_torch.ops import df_pathwise, df_pathwise_tiled

    dev = torch.device('cuda')
    S, M = CONFIG['num_features'], CONFIG['num_inducing']
    gen = torch.Generator(device=dev).manual_seed(args.seed + 71)
    rng = np.random.default_rng(args.seed + 71)
    out = {'fwd': [], 'bwd': []}

    run_path = functools.partial(count_path, launches=slice_launches)

    log(f'DF above state dim 16: df_pathwise_tiled_fwd / '
        f'df_pathwise_tiled_bwd (their wide kernels) vs '
        f'df_pathwise_reference (and autograd through it) on the card:')
    tiled = df_pathwise_tiled.tiled_df_pathwise_eval
    # (L, D, S, N, M, lengthscale): at D = 260 the lengthscale keeps the
    # update's envelopes of 260-dimensional distances away from 0, and 10
    # inducing points keep the sample's (M D)^2 gram small
    for L_, D_, S_, N_, M_, ls in ((1, DF_WIDE_Q, S, BATCH, M, 2.0),
                                   (L, DF_WIDE_Q, S, BATCH, M, 2.0),
                                   (L, 48, 64, BATCH, M, 2.0),
                                   (L, 49, 64, BATCH, M, 2.0),
                                   (1, DF_WIDEST_Q, S, BATCH, M, 2.0),
                                   (L, DF_WIDEST_Q, S, BATCH, M, 2.0),
                                   (1, 260, 4, 3, 10, 8.0)):
        g = init_svgp_params(rng, D_, D_, M_, kernel='DF', lengthscale=ls,
                             variance=0.7, device='cuda')
        with torch.no_grad():
            operands = df_pathwise.df_fused_operands(
                g, draw_fn_sample(g, gen, S_, L=L_))
        require(all(bool(torch.isfinite(t).all()) for t in operands),
                f'non-finite DF sample at D={D_} S={S_} M={M_}')
        x = torch.randn((L_, N_, D_), generator=gen, device=dev)
        name = f'L={L_} N={N_} D={D_} S={S_} M={M_}'
        with torch.no_grad():
            o = tiled(x, *operands)
            o2 = tiled(x, *operands)
            r = df_pathwise.df_pathwise_reference(x, *operands)
        torch.cuda.synchronize()
        out['fwd'].append(compare(o, r, f'fwd {name}'))
        gbar = torch.randn(r.shape, generator=gen, device=dev)
        inputs = [t.clone().requires_grad_() for t in (x,) + operands]
        bars = torch.autograd.grad(tiled(*inputs), inputs, gbar)
        bars2 = torch.autograd.grad(tiled(*inputs), inputs, gbar)
        ref = df_pathwise.df_pathwise_vjp_reference(x, *operands, gbar)
        torch.cuda.synchronize()
        out['bwd'].append(compare_bwd(bars, ref, f'bwd {name}',
                                      ('x',) + df_pathwise.NAMES))
        require(torch.equal(o, o2) and all(
            torch.equal(a, b) for a, b in zip(bars, bars2)),
            f'{name}: two launches of the tiled DF pair differ')
        del operands, inputs, bars, bars2, ref

    kernel_eval = df_pathwise_tiled.df_pathwise_eval

    def plain_step(m, gp, noise, relu_in, relu_pin):
        """The train step through the plain version on the card."""
        df_pathwise_tiled.df_pathwise_eval = df_pathwise.df_pathwise_reference
        try:
            with cudnn_deterministic():
                return run_path(lambda: step_grads(
                    m, gp, batch, noise, 360.0, True, 'cuda', L,
                    relu_in=relu_in, relu_pin=relu_pin))
        finally:
            df_pathwise_tiled.df_pathwise_eval = kernel_eval

    for q_, ls in ((DF_WIDE_Q, CONFIG['lengthscale']),
                   (DF_WIDEST_Q, DF_WIDEST_LS)):
        for solver in ('euler', 'rk4'):
            m, gp = init_model(args.seed + 72, device='cuda', **dict(
                CONFIG, kernel='DF', latent_dim=q_, solver=solver,
                lengthscale=ls))
            noise = step_noise(args.seed + 73, q_, S, M, L_=L, df=True)
            relu_k, relu_p = {}, {}
            with cudnn_deterministic():
                (loss_k, _, _, g_gpu), d = run_path(lambda: step_grads(
                    m, gp, batch, noise, 360.0, True, 'cuda', L,
                    relu_in=relu_k))
            fk, bk = rule_names('DF', L, BATCH, q_, S, M)
            got = {k: v for k, v in d.items() if v}
            require((fk, bk) == (df_pathwise_tiled.KERNEL,
                                 df_pathwise_tiled.BWD_KERNEL) and
                    set(got) == {fk, bk}, f'the DF {solver} step at '
                    f'latent_dim {q_} launched {got}, the rule names {fk} '
                    f'and {bk}')
            (loss_p, _, _, g_plain), dp = plain_step(m, gp, noise, relu_p,
                                                     relu_k)
            require(not any(dp.values()), f'the plain step launched {dp}')
            check_grads(
                f'DF {solver}, one train step at latent_dim {q_}, '
                f'lengthscale {ls:g} (L={L}; launches {got}) against '
                f'autograd through the plain version on the card',
                (float(loss_k), float(loss_p),
                 *worst_grad_error(g_gpu, g_plain, m),
                 *relu_flips(relu_k, relu_p)))
            del m, gp
            torch.cuda.empty_cache()
    return out


# the wide configuration: main.py's defaults but for these flags
WIDE_FLAGS = ('--latent_dim', '12', '--D_in', '12', '--D_out', '12',
              '--num_features', '1024')
WIDE = dict(CONFIG, latent_dim=12, num_features=1024)
# the dispatch rule's sweep: RBF (D, K, S) and DF (D, S), each at L = 1, 5
# and N = 20, 600, M = 100; the RBF widths 20 to 72 (72: the rk4 steps at
# latent_dim RBF_WIDE_Q) are past the 16 dims #3 keeps in registers, 20
# to 32 close around where the rule's choices change, and at 72 the tiled
# VJP #10 does not fit (its VJP column is empty there)
RBF_SWEEP = ((6, 6, 256), (12, 12, 256), (6, 6, 1024), (6, 6, 2048),
             (12, 12, 1024), (20, 20, 256), (24, 24, 256), (28, 28, 256),
             (32, 32, 256), (48, 48, 256), (72, 72, 256))
DF_SWEEP = ((6, 256), (6, 512), (12, 256), (12, 1024))
# shapes at which the rule takes another kernel: a wide request of
# WIDE_BATCH sequences (L*N*K*(S+M) >= 2.4e7: #9), RBF rk4 steps of
# BIG_BATCH sequences at the main widths (#3 in blocks of 8 rows), RBF
# rk4 steps at latent_dim RBF_WIDE_Q, wider than #10's block holds (#9
# and #4),
# and DF rk4 steps at L=1 (the first half of a run's epochs) with
# DF_BIG_BATCH sequences (#6)
WIDE_BATCH, BIG_BATCH, DF_BIG_BATCH, RBF_WIDE_Q = 400, 160, 600, 72


def rbf_lengthscale(D):
    """The RBF lengthscale of the kernel checks at state dim D: 2 up to
    D = 12, then 2 sqrt(D / 12). For standard-normal x and z the update's
    envelope exp(-0.5 |(x - z) / ls|^2) has an exponent near -D / ls^2, so
    it stays near the e^-3 of D = 12; at lengthscale 2 and D = 72 it is
    near e^-18, and the update's cotangents (dZ, dls, dnu) near 0."""
    return 2.0 * max(1.0, D / 12) ** 0.5


def device_us(fn, names, reps=10):
    """{name: (device microseconds per launch, launches)} of the CUDA
    kernels `<name>_kernel` over `reps` calls of fn(), from torch.profiler
    (one warm-up call first); beside each, every other kernel of its
    library that the trace held (`<name>_<suffix>`, such as the kernel
    that sums a VJP's slabs), under its own name without `_kernel`."""
    import re
    fn()
    cuda = device_events(lambda: [fn() for _ in range(reps)])
    out = {}
    for name in names:
        pat = re.compile(r'(?<![A-Za-z_])(' + name + r'_\w+)')
        found = {}
        for e in cuda:
            m = pat.search(e.name)
            if m:
                key = re.sub(r'_kernel$', '', m.group(1))
                found.setdefault(key, []).append(e.time_range.elapsed_us())
        out[name] = (0.0, 0)
        for key, ev in found.items():
            out[key] = (sum(ev) / len(ev), len(ev))
    return out


def floor_us():
    """Device microseconds per launch of an empty kernel (one warp) built
    into the library of pathwise_fwd.cu (`pathwise_fwd_empty`;
    torch.profiler over 10 launches, as `device_us`): the floor under every
    kernel's device time on this card. None where the trace held none of
    its launches."""
    import torch
    from vae_gp_ode_tpu_torch.ops import pathwise
    lib = pathwise._lib()

    def launch():
        rc = lib.pathwise_fwd_empty(torch.cuda.current_device(),
                                    torch.cuda.current_stream().cuda_stream)
        require(rc == 0, f'the empty kernel failed to launch: CUDA error '
                         f'{rc}')
    us, seen = device_us(launch, ['empty'])['empty']
    return us if seen else None


def per_launch(v):
    """A device_us entry as text: 'not measured' where the trace held
    none of the kernel's launches (torch.profiler drops some events)."""
    return f'{v[0]:.1f} us ({v[1]})' if v[1] else 'not measured'


def wide_kernels(args, card):
    """Both per-step pairs of each family, the single-block #3-#6 and the
    grid-tiled #9-#12, against their plain versions on the card at every
    shape of the sweep and beside them (a ragged last chunk, GP operands
    per draw, no draw dim, the rows of the wide request and of the
    batch-160 rk4 steps), and the sweep that fixed the dispatch rule: each
    family's single-block and tiled forward and VJP timed with CUDA events
    (the wrappers' launches with their slab sums) beside the pair the rule
    picks. Returns what the summary line needs."""
    import numpy as np
    import torch
    from vae_gp_ode_tpu_torch.gp.svgp import draw_fn_sample, init_svgp_params
    from vae_gp_ode_tpu_torch.ops import (
        df_pathwise, df_pathwise_tiled, pathwise, pathwise_tiled)

    dev = torch.device('cuda')
    M = CONFIG['num_inducing']
    gen = torch.Generator(device=dev).manual_seed(args.seed + 41)
    rng = np.random.default_rng(args.seed + 41)
    out = {'errs': {}, 'sweep': [], 'ops': {},
           'repeats': {'rbf': 0, 'df': 0}}

    def rbf_ops(L_, N_, D_, S_):
        g = init_svgp_params(rng, D_, D_, M, lengthscale=rbf_lengthscale(D_),
                             variance=0.7, device='cuda')
        with torch.no_grad():
            operands = pathwise.rbf_fused_operands(
                g, draw_fn_sample(g, gen, S_, L=L_))
        return torch.randn((L_, N_, D_), generator=gen, device=dev), operands

    def df_ops(L_, N_, D_, S_):
        g = init_svgp_params(rng, D_, D_, M, kernel='DF', lengthscale=2.0,
                             variance=0.7, device='cuda')
        with torch.no_grad():
            operands = df_pathwise.df_fused_operands(
                g, draw_fn_sample(g, gen, S_, L=L_))
        require(all(bool(torch.isfinite(t).all()) for t in operands),
                f'non-finite DF sample at D={D_} S={S_}')
        return torch.randn((L_, N_, D_), generator=gen, device=dev), operands

    def per_draw(operands, L_):
        """Z, ls (ls2) and var given a draw dim, each draw a scaled copy."""
        operands = list(operands)
        for i in (3, 5, 6):
            operands[i] = (operands[i].expand(
                (L_,) + tuple(operands[i].shape)) * (
                1.0 + 0.05 * torch.arange(L_, device=dev).reshape(
                    (L_,) + (1,) * operands[i].dim()))).contiguous()
        return tuple(operands)

    def tiled_vjp_fits(fam, D_):
        """Whether the family's tiled VJP takes state dim D_ on this card
        (the RBF #10 holds every D of its items in shared memory)."""
        return fam != 'rbf' or pathwise_tiled.use_tiled(
            1, 1, D_, 1, 1, 1, dev)[1]

    def check(fam, name, x, operands, single_only=False):
        """Both pairs of the family (the single-block one alone where
        `single_only`; the tiled pair's forward alone where its VJP does
        not fit), each wrapper forward and every cotangent through
        torch.autograd.grad, against the plain version: the tiled pair's
        errors go to out['errs'][fam + '_fwd'/'_bwd'], the single-block
        pair's to fam + '_fwd_single'/'_bwd_single'."""
        if fam == 'rbf':
            pairs = (('single', pathwise.fused_pathwise_eval),
                     ('tiled', pathwise_tiled.tiled_pathwise_eval))
            plain, vjp_ref = (pathwise.pathwise_eval_reference,
                              pathwise.pathwise_vjp_reference)
            names = ('x',) + pathwise.NAMES
        else:
            pairs = (('single', df_pathwise.fused_df_pathwise_eval),
                     ('tiled', df_pathwise_tiled.tiled_df_pathwise_eval))
            plain, vjp_ref = (df_pathwise.df_pathwise_reference,
                              df_pathwise.df_pathwise_vjp_reference)
            names = ('x',) + df_pathwise.NAMES
        with torch.no_grad():
            r = plain(x, *operands)
        gbar = torch.randn(r.shape, generator=gen, device=dev)
        ref = vjp_ref(x, *operands, gbar)
        for pair, wrapper in pairs[:1] if single_only else pairs:
            key = fam + ('_single' if pair == 'single' else '')
            with torch.no_grad():
                o = wrapper(x, *operands)
            torch.cuda.synchronize()
            require(o.shape == r.shape, f'{name}: shape {tuple(o.shape)}')
            out['errs'].setdefault(key + '_fwd', []).append(
                compare(o, r, f'fwd {fam} {pair} {name}'))
            if pair == 'tiled' and not tiled_vjp_fits(fam, x.shape[-1]):
                with torch.no_grad():
                    require(torch.equal(o, wrapper(x, *operands)),
                            f'{name}: two launches of the tiled {fam} '
                            f'forward on the same inputs differ')
                log(f'  bwd {fam} tiled {name}: the tiled VJP does not fit '
                    f'this state dim (not run)')
                continue
            inputs = [t.clone().requires_grad_() for t in (x,) + operands]
            bars = torch.autograd.grad(wrapper(*inputs), inputs, gbar)
            torch.cuda.synchronize()
            # past D = 12 every RBF cotangent is held to its own size: the
            # update's (dZ, dls, dnu) are far below 1 there
            out['errs'].setdefault(key + '_bwd', []).append(compare_bwd(
                bars, ref, f'bwd {fam} {pair} {name}', names,
                own_scale=fam == 'rbf' and x.shape[-1] > 12))
            # every pair sums fixed partials in a fixed order: a second
            # launch on the same inputs gives the same bits
            with torch.no_grad():
                o2 = wrapper(x, *operands)
            bars2 = torch.autograd.grad(wrapper(*inputs), inputs, gbar)
            require(torch.equal(o, o2) and all(
                torch.equal(a, b) for a, b in zip(bars, bars2)),
                f'{name}: two launches of the {pair} {fam} pair on the '
                f'same inputs differ')
            out['repeats'][fam] += 1
        return gbar

    log('wide shapes: both pairs of each family (single-block '
        'pathwise_fwd / pathwise_bwd and df_pathwise_fwd / df_pathwise_bwd, '
        'tiled pathwise_tiled_fwd / pathwise_tiled_bwd and '
        'df_pathwise_tiled_fwd / df_pathwise_tiled_bwd) vs '
        'pathwise_eval_reference and df_pathwise_reference (and autograd '
        'through them) on the card at every shape of the sweep of the '
        'dispatch rule, then the sweep itself '
        '(ms per call, CUDA events, each wrapper\'s launch with its slab '
        f'sums; card {card}):')
    for fam, shapes in (('rbf', RBF_SWEEP), ('df', DF_SWEEP)):
        for shape in shapes:
            for L_ in (1, L):
                for N_ in (BATCH, 600):
                    if fam == 'rbf':
                        D_, K_, S_ = shape
                        x, operands = rbf_ops(L_, N_, D_, S_)
                        name = f'L={L_} N={N_} D={D_} K={K_} S={S_}'
                        mods = (pathwise, pathwise_tiled)
                        pick = pathwise_tiled.use_tiled(L_, N_, D_, K_, S_,
                                                        M, dev)
                    else:
                        D_, S_ = shape
                        x, operands = df_ops(L_, N_, D_, S_)
                        name = f'L={L_} N={N_} D={D_} S={S_}'
                        mods = (df_pathwise, df_pathwise_tiled)
                        pick = df_pathwise_tiled.use_df_tiled(
                            L_, N_, D_, S_ * D_, M, dev)
                    gbar = check(fam, name, x, operands)
                    # ms per call of each pair's forward and VJP: three
                    # rounds in turns, the median of each (the host's
                    # jitter moves a single reading by ~10%); no tiled VJP
                    # where it does not fit
                    reps = 20 if N_ > BATCH else 50
                    fns = [lambda m=m: m._launch(x, operands)
                           for m in mods] + [
                        lambda m=m: m._launch_bwd(x, operands, gbar)
                        for m in mods]
                    if not tiled_vjp_fits(fam, D_):
                        fns[3] = None
                    rounds = [[] for _ in fns]
                    with torch.no_grad():
                        for _ in range(3):
                            for fn, r in zip(fns, rounds):
                                if fn is not None:
                                    r.append(cuda_ms(fn, reps))
                    t = [sorted(r)[1] if r else None for r in rounds]
                    out['sweep'].append((fam, shape, L_, N_, t, pick))
                    log(f'  sweep {fam} {name}: fwd single {t[0]:.4f} '
                        f'tiled {t[1]:.4f}; vjp single {t[2]:.4f} tiled '
                        + ('-' if t[3] is None else f'{t[3]:.4f}')
                        + f' ms; rule -> fwd '
                        f'{"tiled" if pick[0] else "single"}, vjp '
                        f'{"tiled" if pick[1] else "single"}')
                    if (L_, N_) == (L, BATCH) and shape in ((12, 12, 1024),
                                                            (12, 1024)):
                        out['ops'][fam] = (x, operands, gbar)
    # beside the sweep: a ragged last chunk, GP operands per draw, no draw
    # dim (an operand shared by all draws gets the draws' sum), the rows
    # of the wide requests of WIDE_BATCH sequences and of the rk4 steps of
    # BIG_BATCH sequences, and (RBF, single-block pair: #10 refuses it) the
    # state
    # width of the RBF_WIDE_Q rk4 steps
    for fam in ('rbf', 'df'):
        make = rbf_ops if fam == 'rbf' else df_ops
        check(fam, 'L=5 N=20 D=12 S=1000 (ragged last chunk)',
              *make(L, BATCH, 12, 1000))
        x, operands, _ = out['ops'][fam]
        check(fam, 'L=5 N=20 D=12 S=1024, Z, ls, var per draw', x,
              per_draw(operands, L))
        base = pathwise._BASE_DIMS if fam == 'rbf' else df_pathwise.BASE_DIMS
        check(fam, 'N=20 D=12 S=1024, no draw dim', x[0], tuple(
            t[0] if t.dim() > nd else t for t, nd in zip(operands, base)))
        check(fam, f'L=5 N={WIDE_BATCH} D=12 S=1024 (the wide request)',
              *make(L, WIDE_BATCH, 12, 1024))
        check(fam, f'L=5 N={BIG_BATCH} D=6 S=256 (the batch-{BIG_BATCH} '
                   f'rk4 steps)', *make(L, BIG_BATCH, 6, 256))
    check('rbf', f'L=5 N=20 D={RBF_WIDE_Q} S=256 (the rk4 steps at '
                 f'latent_dim {RBF_WIDE_Q})',
          *rbf_ops(L, BATCH, RBF_WIDE_Q, 256), single_only=True)
    # #4 and #9 at the shapes their paths launch them at, against the
    # float64 plain version, as rbf_pathwise_probe.py --flows holds #1/#2:
    # per output or cotangent, max |error| over max |float64| (its own
    # size), the kernel's no more than F64_NOISE times the f32 plain
    # version's
    out['f64'] = {}
    for name, (x, operands), role in (
            (f'pathwise_bwd (#4) at L=5 N=20 D={RBF_WIDE_Q} S=256',
             rbf_ops(L, BATCH, RBF_WIDE_Q, 256), 'bwd'),
            (f'pathwise_tiled_fwd (#9) at L=5 N={WIDE_BATCH} D=12 S=1024',
             rbf_ops(L, WIDE_BATCH, 12, 1024), 'fwd')):
        x64, ops64 = x.double(), [t.double() for t in operands]
        with torch.no_grad():
            if role == 'fwd':
                got = (pathwise_tiled._launch(x, operands),)
                plain = (pathwise.pathwise_eval_reference(x, *operands),)
                ref = (pathwise.pathwise_eval_reference(x64, *ops64),)
                names = ('f',)
            else:
                gbar = torch.randn((L, BATCH, RBF_WIDE_Q), generator=gen,
                                   device=dev)
                got = pathwise._launch_bwd(x, operands, gbar)
                plain = pathwise.pathwise_vjp_reference(x, *operands, gbar)
                ref = pathwise.pathwise_vjp_reference(x64, *ops64,
                                                      gbar.double())
                names = ('x',) + pathwise.NAMES
        torch.cuda.synchronize()
        errs = {n: tuple(float((v.double() - c).abs().max())
                         / float(c.abs().max()) for v in (a, b))
                for n, a, b, c in zip(names, got, plain, ref)}
        out['f64'][name] = errs
        log(f'  {name}, float64 plain version: max |kernel - f64| / max '
            f'|f32 plain - f64|, each over max |f64|: ' + ', '.join(
                f'{n} {k:.2e} / {p:.2e}' for n, (k, p) in errs.items()))
        bad = [n for n, (k, p) in errs.items() if k > F64_NOISE * p]
        require(not bad, f'{name}: {bad} farther from float64 than '
                f'{F64_NOISE} times the f32 plain version: {errs}')
    log(f'two launches on the same inputs gave the same bits: both RBF '
        f'pairs (pathwise_fwd / pathwise_bwd, pathwise_tiled_fwd / '
        f'pathwise_tiled_bwd) at all {out["repeats"]["rbf"]} of their '
        f'checks above, both DF pairs (df_pathwise_fwd / df_pathwise_bwd, '
        f'df_pathwise_tiled_fwd / df_pathwise_tiled_bwd) at all '
        f'{out["repeats"]["df"]} of theirs')
    # the rule against the sweep: the faster kernel of each pair per call,
    # tallied per family
    out['rule_hits'] = {}
    for fam_ in ('rbf', 'df'):
        hits, misses = 0, []
        for fam, shape, L_, N_, t, pick in out['sweep']:
            if fam != fam_:
                continue
            for role, single, tiled, chose in (
                    ('fwd', t[0], t[1], pick[0]),
                    ('vjp', t[2], t[3], pick[1])):
                if tiled is None:   # no choice: the tiled VJP does not fit
                    continue
                took, other = (tiled, single) if chose else (single, tiled)
                if took <= other:
                    hits += 1
                else:
                    misses.append(f'{shape} L={L_} N={N_} {role} '
                                  f'+{100 * (took / other - 1):.0f}%')
        out['rule_hits'][fam_] = (hits, hits + len(misses))
        log(f'the {fam_.upper()} rule took the faster kernel in {hits} of '
            f'{hits + len(misses)} choices of this sweep; the others (time '
            f'over the faster one): ' + (', '.join(misses) or 'none'))
    # device time per launch of both pairs at the wide shapes
    out['device_us'] = {}
    for fam, mods in (('rbf', (pathwise, pathwise_tiled)),
                      ('df', (df_pathwise, df_pathwise_tiled))):
        x, operands, gbar = out['ops'][fam]
        with torch.no_grad():
            for m in mods:
                out['device_us'].update(device_us(
                    lambda m=m: m._launch(x, operands), [m.KERNEL]))
                out['device_us'].update(device_us(
                    lambda m=m: m._launch_bwd(x, operands, gbar),
                    [m.BWD_KERNEL]))
    log('device time per launch at the wide shapes (L=5, N=20, D=12, '
        'S=1024, M=100; torch.profiler over 10 launches): ' + ', '.join(
            f'{k} {per_launch(v)}' for k, v in
            out['device_us'].items()) + f'; card {card}')
    return out


def wide_paths(args, card, slice_launches, kern):
    """The wide configuration end to end (main.py's defaults with
    WIDE_FLAGS, RBF and then --kernel DF): the training CLI's run() for
    TRAIN_EPOCHS epochs with every ODE step through the kernels the
    dispatch rule names (never the fused pairs), GPU vs CPU float64
    gradients, step times at L=1 and 5; three requests and a T=32 rollout
    with random weights; the tiled kernels' times at the wide shapes. Adds
    each path run's launches to `slice_launches` (counts set to 0 just
    before it, read just after) and returns what the summary line needs."""
    import numpy as np
    import torch
    from vae_gp_ode_tpu_torch import main as train_cli
    from vae_gp_ode_tpu_torch import ops
    from vae_gp_ode_tpu_torch.data.mnist import load_data
    from vae_gp_ode_tpu_torch.models.odegpvae import init_model
    from vae_gp_ode_tpu_torch.ops import (
        df_pathwise, df_pathwise_tiled, pathwise, pathwise_tiled)
    from vae_gp_ode_tpu_torch.serving import make_forecast_fn
    from vae_gp_ode_tpu_torch.training import trainer

    dev = torch.device('cuda')
    q, S, M = WIDE['latent_dim'], WIDE['num_features'], WIDE['num_inducing']
    out = {'step_ms': {}, 'request_ms': {}, 'profiles': {}}

    run_path = functools.partial(count_path, launches=slice_launches)

    for kernel in ('RBF', 'DF'):
        tag = 'wide' + ('_df' if kernel == 'DF' else '')
        save = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            'build', 'chip_smoke', tag)
        wargs = train_args(save, *WIDE_FLAGS, '--kernel', kernel)
        steps, seen = [], {}

        def on_step(ep, L_):
            now = dict(ops.LAUNCHES)
            steps.append((ep, L_, deltas(seen, now)))
            seen.update(now)

        t0 = time.perf_counter()
        result, d = run_path(lambda: train_cli.run(wargs, on_step=on_step))
        train_s = time.perf_counter() - t0
        require(result['bailout'] is None, f'NaN bailout in the wide '
                                           f'{kernel} run')
        _, testset = load_data(wargs, device=dev)
        batch = testset.first()
        per_epoch = wargs.Ndata // wargs.batch + bool(wargs.Ndata %
                                                      wargs.batch)
        require(len(steps) == TRAIN_EPOCHS * per_epoch, f'{len(steps)} steps')
        for i, (ep, L_, dd) in enumerate(steps):
            # per euler step one VJP, and the forward twice: the solver's
            # remat evaluates each step again in the backward pass
            want = {}
            fwd, bwd = rule_names(kernel, L_, wargs.batch, q, S, M)
            want[fwd] = 2 * (T - 1)
            want[bwd] = T - 1
            if i % per_epoch == 0 and ep > 0:   # the monitoring eval, L=1
                efwd = rule_names(kernel, 1, batch.shape[0], q, S, M)[0]
                want[efwd] = want.get(efwd, 0) + T - 1
            got = {k: v for k, v in dd.items() if v}
            require(got == want, f'wide {kernel} train step {i} (epoch '
                                 f'{ep}, L={L_}) launched {got}, the rule '
                                 f'names {want}')
        losses = np.concatenate([e['loss'] for e in result['epochs']])
        require(np.isfinite(losses).all() and losses.size == len(steps),
                f'wide {kernel} losses {losses}')
        mses = [float(e['mse']) for e in result['epochs']]
        require(np.isfinite(mses).all(), f'wide {kernel} mse {mses}')
        picked = ', '.join(
            f'L={L_}: {rule_names(kernel, L_, wargs.batch, q, S, M)}'
            for L_ in (1, L))
        log(f'wide training path (q=12, S=1024, --kernel {kernel}): run() '
            f'for {TRAIN_EPOCHS} epochs, {len(steps)} steps in '
            f'{train_s:.1f} s; every step launched the rule\'s kernels '
            f'({picked}; '
            f'{2 * (T - 1)} and {T - 1}) and nothing else; launches {d}; '
            f'losses first '
            f'{losses[0]:.2f} last {losses[-1]:.2f}; monitoring mse '
            f'{", ".join(f"{m:.4f}" for m in mses)}')
        state = result['state']
        step = trainer.make_train_step(wargs.Ndata,
                                       eps_guard=wargs.eps_guard)
        check_grads(f'wide {kernel}: GPU vs CPU (float64) train-step '
                    f'gradients at the trained state (L=1, same noise)',
                    pinned_grads(state.model, state.gp, batch,
                                 step_noise(args.seed + 42, q, S, M,
                                            df=kernel == 'DF'),
                                 wargs.Ndata, wargs.eps_guard,
                                 ('cuda', None), ('cpu', torch.float64)))
        out['step_ms'][kernel] = {}
        for L_ in (1, L):
            for _ in range(2):
                step(state, batch, L_)
            out['step_ms'][kernel][L_] = cuda_ms(
                lambda: step(state, batch, L_), 10, warmup=0)
        log(f'wide {kernel} train step (CUDA events over 10 steps, batch on '
            f'the card): ' + ', '.join(
                f'L={k}: {v:.3f} ms' for k, v in
                out['step_ms'][kernel].items()) + f'; card {card}')
        out['profiles'][kernel] = (lambda st=state, sp=step: sp(st, batch,
                                                                L))

        # the forecaster: random weights, three requests and a rollout
        fm, fgp = init_model(args.seed + 43, device='cuda', random_bn=True,
                             **dict(WIDE, kernel=kernel))
        fn = make_forecast_fn(fm, None, fgp, L=L, normalize_input=True,
                              device='cuda')
        fn_roll = make_forecast_fn(fm, None, fgp, L=L, T_custom=T * TROLL,
                                   normalize_input=True, device='cuda')
        raw = [np.random.default_rng(args.seed + 44 + i).random(
            (BATCH, T, 1, 28, 28)).astype(np.float32) for i in range(3)]
        fn(raw[0], args.seed)                                # warm-up
        fn_roll(raw[0], args.seed)
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ms = []
        fwd = rule_names(kernel, L, BATCH, q, S, M)[0]
        for i, (f, X, Tout) in enumerate([(fn, raw[0], T), (fn, raw[1], T),
                                          (fn, raw[2], T),
                                          (fn_roll, raw[0], T * TROLL)]):
            ev0.record()
            Xrec, d = run_path(lambda: f(X, args.seed + i))
            ev1.record()
            torch.cuda.synchronize()
            ms.append(ev0.elapsed_time(ev1))
            require(Xrec.shape == (L, BATCH, Tout, 1, 28, 28) and bool(
                torch.isfinite(Xrec).all()), f'wide {kernel} forecast {i}')
            got = {k: v for k, v in d.items() if v}
            require(got == {fwd: Tout - 1}, f'wide {kernel} request {i} '
                                            f'launched {got}')
        # a request of WIDE_BATCH sequences: the rows at which the rule
        # takes another forward kernel
        Xb = np.random.default_rng(args.seed + 47).random(
            (WIDE_BATCH, T, 1, 28, 28)).astype(np.float32)
        fn(Xb, args.seed)                                    # warm-up
        bfwd = rule_names(kernel, L, WIDE_BATCH, q, S, M)[0]
        ev0.record()
        Xrec, d = run_path(lambda: fn(Xb, args.seed + 5))
        ev1.record()
        torch.cuda.synchronize()
        ms.append(ev0.elapsed_time(ev1))
        got = {k: v for k, v in d.items() if v}
        require(Xrec.shape == (L, WIDE_BATCH, T, 1, 28, 28) and bool(
            torch.isfinite(Xrec).all()) and got == {bfwd: T - 1},
            f'wide {kernel} request of {WIDE_BATCH} sequences launched '
            f'{got}')
        out['request_ms'][kernel] = ms
        log(f'wide {kernel} forecaster (random weights, L={L}): requests '
            f'T={T} ' + ', '.join(f'{m:.3f}' for m in ms[:3])
            + f' ms, rollout T={T * TROLL} {ms[3]:.3f} ms, {fwd} '
            f'{T - 1} / {T * TROLL - 1} launches each; a request of '
            f'{WIDE_BATCH} sequences {ms[4]:.3f} ms, {bfwd} {T - 1} launches '
            f'(CUDA events, host work included); card {card}')
        del state, result, fm, fgp

    # the main configuration's rk4 steps: at the default batch the rule
    # sends the VJP to the tiled kernel (before and after, in turns); at a
    # batch of BIG_BATCH sequences (RBF, L=5) the rule's pair again (#3
    # with 8-row blocks, #10), and at latent_dim RBF_WIDE_Q (RBF, L=5) or
    # a batch of DF_BIG_BATCH sequences at L=1 (DF) the single-block VJP
    out['rk4_rule_ms'], out['big_ms'] = {}, {}
    q6, S6 = CONFIG['latent_dim'], CONFIG['num_features']
    X20 = (torch.rand((BATCH, T, 1, 28, 28), generator=torch.Generator(
        device=dev).manual_seed(args.seed + 48), device=dev) - 0.1307) / 0.3081
    bigs = {'RBF': ((BIG_BATCH, L, q6), (BATCH, L, RBF_WIDE_Q)),
            'DF': ((DF_BIG_BATCH, 1, q6),)}
    for kernel in ('RBF', 'DF'):
        m, g = init_model(args.seed + 50, device='cuda',
                          **dict(CONFIG, solver='rk4', kernel=kernel))
        st = trainer.create_train_state(m, g)
        stp = trainer.make_train_step(360.0, eps_guard=True)
        mod = df_pathwise_tiled if kernel == 'DF' else pathwise_tiled
        rule = mod.use_df_tiled if kernel == 'DF' else mod.use_tiled
        # six rounds of each in turns: the steps are host-bound, and the
        # host's time moves by tens of percent between rounds
        for use_rule in (True, False, False, True) * 3:
            if not use_rule:
                setattr(mod, rule.__name__, lambda *a: (False, False))
            try:
                stp(st, X20, L)
                ms = cuda_ms(lambda: stp(st, X20, L), 5, warmup=0)
            finally:
                setattr(mod, rule.__name__, rule)
            out['rk4_rule_ms'].setdefault((kernel, use_rule), []).append(ms)
        med = {u: statistics.median(out['rk4_rule_ms'][kernel, u])
               for u in (True, False)}
        log(f'{kernel} rk4 train step at the main widths (L={L}), CUDA '
            f'events over 5 steps, batch {BATCH} by the rule (VJP '
            f'{rule_names(kernel, L, BATCH, q6, S6, M)[1]}) '
            f'vs the single-block pair, in turns: rule ' + ', '.join(
                f'{v:.3f}' for v in out['rk4_rule_ms'][kernel, True])
            + ' ms, single ' + ', '.join(
                f'{v:.3f}' for v in out['rk4_rule_ms'][kernel, False])
            + f' ms; medians: rule {med[True]:.3f}, single '
            f'{med[False]:.3f} ms; card {card}')
        del st, m, g
        for nbig, Lbig, qbig in bigs[kernel]:
            # these steps start from a fresh state, with seeded draws: the
            # steps above train `st` on random pixels, which can carry the
            # DF gram to a smallest eigenvalue below 0, through the kernels
            # and through the plain version alike; every later step is
            # then NaN and the guard drops it (df_state_probe.py, PERF.md)
            Xbig = (torch.rand((nbig, T, 1, 28, 28),
                               generator=torch.Generator(device=dev)
                               .manual_seed(args.seed + 49), device=dev)
                    - 0.1307) / 0.3081
            big = trainer.create_train_state(*init_model(
                args.seed + 51, device='cuda',
                **dict(CONFIG, solver='rk4', kernel=kernel,
                       latent_dim=qbig)))
            gbig = torch.Generator(device=dev).manual_seed(args.seed + 52)
            stp(big, Xbig, Lbig, gbig)                       # warm-up
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)

            def two(big=big, gbig=gbig, Xbig=Xbig, Lbig=Lbig):
                ev0.record()
                mets = [stp(big, Xbig, Lbig, gbig) for _ in range(2)]
                ev1.record()
                return mets
            mets, d = run_path(two)
            fk, bk = rule_names(kernel, Lbig, nbig, qbig, S6, M)
            got = {k: v for k, v in d.items() if v}
            bad = [(k, float(v.float().max())) for mt in mets
                   for k, v in mt.items()
                   if not bool(torch.isfinite(v).all())]
            require(set(got) == {fk, bk} and not bad,
                    f'{kernel} rk4 steps at batch {nbig}, L={Lbig}, '
                    f'q={qbig} launched {got}, the rule names {fk} and '
                    f'{bk}; non-finite metrics {bad}')
            out['big_ms'][kernel, nbig, qbig] = ev0.elapsed_time(ev1) / 2
            log(f'{kernel} rk4 train step at batch {nbig}, L={Lbig}, '
                f'q={qbig} (CUDA events over 2 steps): '
                f'{out["big_ms"][kernel, nbig, qbig]:.3f} ms a step, '
                f'launches {got}; card {card}')
            if qbig == RBF_WIDE_Q:
                # the trace of one step: each of the rule's library calls
                # is its main kernel and then its summing kernel, with no
                # PyTorch reduction of its outputs in between (the
                # profiler drops some events, so the pairs are counted)
                seq = kernel_sequence(lambda: stp(big, Xbig, Lbig, gbig))
                after = collections.Counter()
                pairs = {}
                for name in (fk, bk):
                    at = [i for i, n in enumerate(seq)
                          if f'{name}_kernel' in n]
                    paired = [i for i in at if i + 1 < len(seq)
                              and f'{name}_sum_kernel' in seq[i + 1]]
                    pairs[name] = (len(paired), len(at))
                    after.update(seq[i + 2][:70] for i in paired
                                 if i + 2 < len(seq))
                    require(paired, f'rk4 step at q={qbig}: no launch of '
                            f'{name} followed by its summing kernel')
                log(f'  trace of one such step: {len(seq)} device kernels; '
                    'main kernels followed by their summing kernel: '
                    + ', '.join(f'{n} {p} of {a}' for n, (p, a) in
                                pairs.items())
                    + '; the kernels after a summing kernel: '
                    + ', '.join(f'{n} ({c})' for n, c in after.most_common(6)))
                # one rk4 train step at this width through the rule's
                # kernels against autograd through the plain version on
                # the card, same noise (TOL_GRAD, RELU_FLIP), at the
                # kernel checks' lengthscale for this width: at 2 the
                # update's envelopes are near e^-18 and the gradients of
                # the inducing locations, lengthscales and q(u) near 0
                ls_q = rbf_lengthscale(qbig)
                mq, gq = init_model(args.seed + 53, device='cuda', **dict(
                    CONFIG, solver='rk4', latent_dim=qbig, lengthscale=ls_q))
                noise = step_noise(args.seed + 54, qbig, S6, M, L_=Lbig)
                relu_k, relu_p = {}, {}
                with cudnn_deterministic():
                    (loss_k, _, _, g_k), d = run_path(lambda: step_grads(
                        mq, gq, Xbig, noise, 360.0, True, 'cuda', Lbig,
                        relu_in=relu_k))
                got = {k: v for k, v in d.items() if v}
                require(set(got) == {fk, bk}, f'the RBF rk4 step at '
                        f'latent_dim {qbig} launched {got}, the rule names '
                        f'{fk} and {bk}')
                kernel_eval = pathwise_tiled.pathwise_eval
                pathwise_tiled.pathwise_eval = pathwise.pathwise_eval_reference
                try:
                    with cudnn_deterministic():
                        (loss_p, _, _, g_p), dp = run_path(
                            lambda: step_grads(
                                mq, gq, Xbig, noise, 360.0, True, 'cuda',
                                Lbig, relu_in=relu_p, relu_pin=relu_k))
                finally:
                    pathwise_tiled.pathwise_eval = kernel_eval
                require(not any(dp.values()), f'the plain step launched '
                        f'{dp}')
                check_grads(
                    f'RBF rk4, one train step at latent_dim {qbig}, '
                    f'lengthscale {ls_q:.4f} (L={Lbig}, batch {nbig}; '
                    f'launches {got}) against autograd through the plain '
                    f'version on the card',
                    (float(loss_k), float(loss_p),
                     *worst_grad_error(g_k, g_p, mq),
                     *relu_flips(relu_k, relu_p)))
                del mq, gq
            del big

    # the tiled kernels' times at the wide shapes (L=5, N=20)
    out['kernel_ms'] = {}
    for fam, mod, plain, vjp_ref in (
            ('rbf', pathwise_tiled, pathwise.pathwise_eval_reference,
             pathwise.pathwise_vjp_reference),
            ('df', df_pathwise_tiled, df_pathwise.df_pathwise_reference,
             df_pathwise.df_pathwise_vjp_reference)):
        x, operands, gbar = kern['ops'][fam]
        tiled = (pathwise_tiled.tiled_pathwise_eval if fam == 'rbf' else
                 df_pathwise_tiled.tiled_df_pathwise_eval)
        rows = x.shape[0] * x.shape[1]
        with torch.no_grad():
            o = tiled(x, *operands)
            kf = cuda_ms(lambda: tiled(x, *operands), 200)
            pf = cuda_ms(lambda: plain(x, *operands), 20)
        inputs = [t.clone().requires_grad_() for t in (x,) + operands]
        oo = tiled(*inputs)
        kb = cuda_ms(lambda: torch.autograd.grad(oo, inputs, gbar,
                                                 retain_graph=True), 200)
        pb = cuda_ms(lambda: vjp_ref(x, *operands, gbar), 20)
        bars = torch.autograd.grad(oo, inputs, gbar)
        if fam == 'rbf':
            bf = pathwise_bound((x,) + operands + (o,), rows, q, q, S, M)
            bb = pathwise_bound((x,) + operands + (gbar,) + tuple(bars),
                                rows, q, q, S, M, bwd=True)
        else:
            bf = roofline(rows * df_eval_flops(q, S * q, M),
                          (x,) + operands + (o,))
            bb = roofline(rows * df_vjp_flops(q, S * q, M),
                          (x,) + operands + (gbar,) + tuple(bars))
        out['kernel_ms'][mod.KERNEL] = (kf, pf, bf)
        out['kernel_ms'][mod.BWD_KERNEL] = (kb, pb, bb)
        out.setdefault('calls', {}).update({
            mod.KERNEL: lambda tiled=tiled, x=x, ops_=operands:
                tiled(x, *ops_),
            mod.BWD_KERNEL: lambda tiled=tiled, inputs=inputs, gbar=gbar:
                torch.autograd.grad(tiled(*inputs), inputs, gbar)})
        log(f'{fam} tiled kernels at the wide shapes (L=5, N=20, D=12, '
            f'S=1024, M=100): fwd {kf:.4f} ms (plain {pf:.4f}, bound '
            f'{bf[0]:.5f} {bf[1]}), bwd {kb:.4f} ms through autograd, its '
            f'summing kernel included (plain {pb:.4f}, bound {bb[0]:.5f} '
            f'{bb[1]}); card {card}')
    return out


def trajectory_call(name, shape, rng, gen):
    """A call of trajectory kernel `name` (#1, #2, #7 or #8) at the shape
    key its wrapper counts (RBF (L, N, D, K, S, M, T), DF (L, N, D, S*D,
    M, T)) on operands drawn there (z0 shared by the draws, dt = 0.1 as
    main.py's), and the tensors and operations that bound one launch:
    (call, bound ms)."""
    import torch
    from vae_gp_ode_tpu_torch.gp.svgp import draw_fn_sample, init_svgp_params
    from vae_gp_ode_tpu_torch.ops import (
        df_flow_fused, df_pathwise, flow_fused, pathwise)
    dev = torch.device('cuda')
    df = name.startswith('df_')
    if df:
        L_, N_, D_, SD_, M_, T_ = shape
        K_, S_, order = D_, SD_ // D_, 1
    else:
        L_, N_, D_, K_, S_, M_, T_ = shape
        order = D_ // K_
    g = init_svgp_params(rng, D_, K_, M_, kernel='DF' if df else 'RBF',
                         lengthscale=2.0, variance=0.7, device='cuda')
    z0 = torch.randn((N_, D_), generator=gen, device=dev)
    dts = torch.full((T_ - 1,), CONFIG['dt'], device=dev)
    with torch.no_grad():
        sample = draw_fn_sample(g, gen, S_, L=L_)
        if df:
            ops_ = df_pathwise.df_fused_operands(g, sample)
            fwd = lambda: df_flow_fused.packed_df_euler_flow(z0, *ops_, dts,
                                                             T_)
        else:
            ops_ = flow_fused._pack_operands(
                *pathwise.rbf_fused_operands(g, sample))
            fwd = lambda: flow_fused.packed_euler_flow(z0, *ops_, dts, T_,
                                                       order)
        zs = fwd().reshape((L_, T_, N_, D_))
    if not name.endswith('_bwd'):
        if df:
            bound = roofline(L_ * N_ * (T_ - 1) * (
                df_eval_flops(D_, SD_, M_) + 2 * D_), (z0,) + ops_ + (
                dts, zs))[0]
        else:
            bound = flow_bound(L_, N_, D_, K_, S_, M_, T_)[0]
        return fwd, bound
    zsbar = torch.randn(zs.shape, generator=gen, device=dev)
    if df:
        bwd = lambda: df_flow_fused.df_flow_vjp(zs, zsbar, *ops_, dts, T_)
        outs = bwd()
        bound = roofline(L_ * N_ * (T_ - 1) * df_vjp_flops(D_, SD_, M_),
                         (zs, zsbar) + ops_ + (dts,) + tuple(outs))[0]
    else:
        bwd = lambda: flow_fused.packed_flow_vjp(zs, zsbar, *ops_, dts, T_,
                                                 order)
        outs = bwd()
        bound = flow_bwd_bound(L_, N_, D_, K_, S_, M_, T_, [zs, zsbar] +
                               list(ops_) + [dts] + list(outs))[0]
    return bwd, bound


def per_shape_split(card):
    """Launches and device time per launch of every kernel at every shape
    the paths launched it at (PATH_SHAPES), each timed on operands drawn
    at that shape, beside its bound there: the per-step kernels (#3-#6,
    #9-#12) and the trajectory kernels (#1, #2, #7, #8) alike. A shape
    whose launches torch.profiler dropped is timed again, with more
    launches, up to three times, and a shape without a reading fails the
    run. Beside each device time, the CUDA-event time per call of the
    same call (host issue and the library's second kernel included): a
    device time far under it is a reading to doubt. Per kernel the sum of
    launches x (device time - bound), the redesign order of ROADMAP Queue
    B. Returns {kernel: [(shape, launches, us, bound us)]}."""
    import numpy as np
    import torch
    from vae_gp_ode_tpu_torch.gp.svgp import draw_fn_sample, init_svgp_params
    from vae_gp_ode_tpu_torch.ops import (
        df_flow_fused, df_pathwise, df_pathwise_tiled, flow_fused, pathwise,
        pathwise_tiled)
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(61)
    rng = np.random.default_rng(61)
    mods = {}
    for m in (pathwise, pathwise_tiled, df_pathwise, df_pathwise_tiled):
        mods[m.KERNEL], mods[m.BWD_KERNEL] = (m, False), (m, True)
    trajectories = (flow_fused.KERNEL, flow_fused.BWD_KERNEL,
                    df_flow_fused.KERNEL, df_flow_fused.BWD_KERNEL)
    drawn, out = {}, {}
    log('per-shape split of the paths\' launches (shape key: RBF (L, N, D, '
        'K, S, M), DF (L, N, D, S*D, M), trajectories with T; device us per '
        'launch, torch.profiler over 10 launches on operands drawn at the '
        'shape, again over 20 and 40 where it recorded none; CUDA-event us '
        f'per call; bound us from the same operands; card {card}):')
    for (name, shape), n in sorted(PATH_SHAPES.items()):
        if name in trajectories:
            call, bound = trajectory_call(name, shape, rng, gen)
        else:
            require(name in mods, f'{name}: a kernel the split does not know')
            mod, bwd = mods[name]
            df = mod in (df_pathwise, df_pathwise_tiled)
            if df:
                L_, N_, D_, SD_, M_ = shape
                K_, S_ = D_, SD_ // D_
            else:
                L_, N_, D_, K_, S_, M_ = shape
            if (df, shape) not in drawn:
                g = init_svgp_params(rng, D_, K_, M_,
                                     kernel='DF' if df else 'RBF',
                                     lengthscale=2.0, variance=0.7,
                                     device='cuda')
                with torch.no_grad():
                    sample = draw_fn_sample(g, gen, S_, L=L_)
                    operands = (df_pathwise.df_fused_operands if df else
                                pathwise.rbf_fused_operands)(g, sample)
                drawn[df, shape] = (
                    torch.randn((L_, N_, D_), generator=gen, device=dev),
                    operands,
                    torch.randn((L_, N_, K_), generator=gen, device=dev))
            x, operands, gbar = drawn[df, shape]
            with torch.no_grad():
                if bwd:
                    call = (lambda m=mod, x=x, o=operands, g=gbar:
                            m._launch_bwd(x, o, g))
                    tensors = (x,) + operands + (gbar,) + tuple(call())
                else:
                    call = lambda m=mod, x=x, o=operands: m._launch(x, o)
                    tensors = (x,) + operands + (call(),)
            if df:
                flops = L_ * N_ * (df_vjp_flops if bwd else df_eval_flops)(
                    D_, SD_, M_)
                bound = roofline(flops, tensors)[0]
            else:
                bound = pathwise_bound(tensors, L_ * N_, D_, K_, S_, M_,
                                       bwd)[0]
        with torch.no_grad():
            for reps in (10, 20, 40):
                timed = device_us(call, [name], reps)
                us, seen = timed.pop(name)
                if seen:
                    break
            call_us = 1e3 * cuda_ms(call, 20)
        require(seen, f'{name} {shape}: torch.profiler recorded none of its '
                      f'launches in three tries')
        out.setdefault(name, []).append((shape, n, us, bound * 1e3))
        log(f'  {name} {shape}: {n} launches, '
            f'{per_launch((us, seen))}, {call_us:.1f} us per call, bound '
            f'{bound * 1e3:.2f} us' + ''.join(
                f'; {k} {per_launch(v)}' for k, v in timed.items()))
    for name, rows in sorted(out.items(), key=lambda kv: -sum(
            n * (us - b) for _, n, us, b in kv[1])):
        lost = sum(n * (us - b) for _, n, us, b in rows) / 1e3
        log(f'  {name}: sum of launches x (us - bound) = {lost:.2f} ms')
    return out


# the DF checkpoint's trained (600, 600) gram has condition number 3.3e6:
# its frames differ between card and CPU by up to 0.036 on a request of
# random pixels and 0.047 on the first test batch (on an H100; ROADMAP
# Queue C item 3), held to 0.1 as the checkpoint request of 6c is; the
# mean and std of its squared errors to 1e-2 relative
DF_CKPT_FRAMES = 0.1
DF_CKPT_MSE_REL = 1e-2


def pretrained_workflow(args, card, slice_launches):
    """Phase 6f, the paper's workflow: `main_vae` for TRAIN_EPOCHS epochs
    at its defaults, the training CLI's run() with --pretrained from what
    it wrote (every step launches #1 and #2 once and no other kernel; the
    VAE and the encoder's and decoder's statistics bit for bit as
    pretrained), one frozen step's GP gradients against the CPU float64
    step (TOL_GRAD, RELU_FLIP) and under set_sync_debug_mode('error'),
    frozen step times at L=1 and L=5 with their device busy time and idle
    share, and `evaluate` on that run and on checkpoints/df_5000ep (each
    test batch and the rollout launch #1 or #7 once), its first test
    batch against the CPU with the same noise."""
    import numpy as np
    import torch
    from vae_gp_ode_tpu_torch import main as train_cli, main_vae
    from vae_gp_ode_tpu_torch.data.mnist import load_data
    from vae_gp_ode_tpu_torch.ops import flow_fused
    from vae_gp_ode_tpu_torch.training import checkpoint, trainer
    run_path = functools.partial(count_path, launches=slice_launches)
    dev = torch.device('cuda')
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, 'build', 'chip_smoke', 'pretrained')
    shutil.rmtree(work, ignore_errors=True)

    # -- VAE pretraining at main_vae.py's defaults ---------------------------
    vargs = main_vae.make_parser().parse_args([
        '--vae_epochs', str(TRAIN_EPOCHS), '--device', 'cuda',
        '--output_path', os.path.join(work, 'vae'),
        '--save', os.path.join(work, 'frames')])
    t0 = time.perf_counter()
    pre, d = run_path(lambda: main_vae.run(vargs))
    pre_s = time.perf_counter() - t0
    require(not any(d.values()), f'VAE pretraining launched {d}')
    frames = vargs.n_train * vargs.n_angle
    per_epoch = -(-frames // vargs.batch)
    rows = [e['rows'] for e in pre['epochs']]
    require(len(rows) == TRAIN_EPOCHS and all(
        r.shape == (per_epoch, 3) and np.isfinite(r).all() for r in rows),
        'VAE pretraining: a loss is not finite')
    require(np.isfinite(pre['test_mse']), 'VAE test MSE is not finite')
    log(f'VAE pretraining (main_vae at its defaults: {frames} frames of '
        f'{vargs.n_train} digits x {vargs.n_angle} angles, batch '
        f'{vargs.batch}, q {vargs.latent_dim}, n_filt {vargs.n_filt}): '
        f'{TRAIN_EPOCHS} epochs of {per_epoch} steps, losses finite '
        f'(first {rows[0][0, 0]:.2f}, last {rows[-1][-1, 0]:.2f}), test '
        f'reconstruction MSE {pre["test_mse"]:.4f}; epoch times '
        + ', '.join(f'{e["seconds"]:.3f}' for e in pre['epochs'])
        + f' s (the first with cuDNN\'s first calls), {pre_s:.1f} s with '
        f'the dataset; no kernel of the twelve launched; card {card}')

    # -- training on the frozen VAE: the CLI's run() -------------------------
    save = os.path.join(work, 'mnist')
    targs = train_args(save, '--pretrained', 'True', '--vae_path',
                       pre['model_dir'])
    steps, seen = [], {}

    def on_step(ep, L_):
        from vae_gp_ode_tpu_torch import ops
        now = dict(ops.LAUNCHES)
        steps.append((ep, L_, {k: now[k] - seen.get(k, 0) for k in now}))
        seen.update(now)

    t0 = time.perf_counter()
    result, launched = run_path(lambda: train_cli.run(targs,
                                                      on_step=on_step))
    train_s = time.perf_counter() - t0
    require(result['bailout'] is None, 'NaN bailout in the frozen run')
    per_run = targs.Ndata // targs.batch + bool(targs.Ndata % targs.batch)
    require(len(steps) == TRAIN_EPOCHS * per_run, f'{len(steps)} steps')
    for i, (ep, L_, d) in enumerate(steps):
        # the first step of a later epoch also counts the previous epoch's
        # monitoring eval (one forward launch)
        evals = 1 if i % per_run == 0 and ep > 0 else 0
        if d[flow_fused.BWD_KERNEL] != 1 or d[flow_fused.KERNEL] != (
                1 + evals) or any(v for k, v in d.items()
                                  if not k.startswith('flow_fused')):
            raise AssertionError(f'frozen train step {i} (epoch {ep}, '
                                 f'L={L_}) launched {d}')
    losses = np.concatenate([e['loss'] for e in result['epochs']])
    require(losses.size == len(steps) and np.isfinite(losses).all(),
            f'frozen losses {losses}')
    state = result['state']
    require(state.freeze_vae and int(state.step) == len(steps),
            'the run did not train a frozen state')
    pretrained = checkpoint.load_vae_weights(
        *train_cli.pretrained_vae_files(pre['model_dir']))
    for part, sd in zip(('encoder', 'decoder'), pretrained):
        for name, t in getattr(state.model, part).state_dict().items():
            require(torch.equal(t.cpu(), sd[name]),
                    f'{part}.{name} changed in the frozen run')
    log(f'training on the frozen VAE: run() --pretrained True for '
        f'{TRAIN_EPOCHS} epochs at main.py\'s defaults, {len(steps)} steps '
        f'in {train_s:.1f} s (data and first calls included); every step '
        f'launched {flow_fused.KERNEL} and {flow_fused.BWD_KERNEL} once '
        f'and no other kernel; launches {launched}; losses finite (first '
        f'{losses[0]:.2f}, last {losses[-1]:.2f}); the encoder\'s and '
        f'decoder\'s weights and BatchNorm statistics bit for bit as '
        f'pretrained')

    _, testset = load_data(targs, device=dev)
    batch = testset.first()
    q, S, M = targs.latent_dim, targs.num_features, targs.num_inducing
    check_grads('frozen step: GPU vs CPU (float64) GP-leaf gradients (L=1, '
                'same noise)', pinned_grads(
                    state.model, state.gp, batch,
                    step_noise(args.seed + 41, q, S, M), targs.Ndata,
                    targs.eps_guard, ('cuda', None), ('cpu', torch.float64),
                    freeze_vae=True))
    step = trainer.make_train_step(targs.Ndata, eps_guard=targs.eps_guard)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        step(state, batch, L)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log('sync check: a frozen train step (L=5) under '
        'set_sync_debug_mode("error"): no synchronising operation')
    times = []
    for L_ in (1, L):
        for _ in range(3):
            step(state, batch, L_)
        ms = cuda_ms(lambda: step(state, batch, L_), 20, warmup=0)
        busy = profile(lambda: step(state, batch, L_),
                       f'one frozen L={L_} train step')
        require(busy is not None,
                'the profiler recorded no device time of a frozen step')
        times.append(f'L={L_}: {ms:.3f} ms, device busy {busy[0]:.3f} ms, '
                     f'idle share {busy[1]:.3f}')
    log('frozen train step (CUDA events over 20 steps, batch on the card): '
        + '; '.join(times) + f'; card {card}')

    # -- evaluate: the frozen run and the shipped DF checkpoint ---------------
    df_run = os.path.join(work, 'df_5000ep')
    shutil.copytree(os.path.join(root, 'checkpoints', 'df_5000ep'), df_run,
                    ignore=shutil.ignore_patterns('eval'))
    evaluate_runs(args, card, (('RBF', result['save']), ('DF', df_run)),
                  batch, len(testset), slice_launches)
    return pre['model_dir']


def evaluate_runs(args, card, runs, batch, n_batches, slice_launches):
    """`evaluate` on the card for each (kernel, run directory) of `runs`
    (the directory gets its eval/): each of the n_batches test batches and
    the rollout launch the kernel's trajectory kernel once and no other
    kernel, finite errors; then the first test batch `batch` on the card
    and on the CPU with the same noise (frames and compute_mse_std)."""
    import numpy as np
    import torch
    from vae_gp_ode_tpu_torch import evaluate
    from vae_gp_ode_tpu_torch.ops import df_flow_fused, flow_fused
    from vae_gp_ode_tpu_torch.serving import load_run_dir
    from vae_gp_ode_tpu_torch.training import trainer
    run_path = functools.partial(count_path, launches=slice_launches)
    eargs = evaluate.make_parser().parse_args(['--device', 'cuda'])
    for kernel, run_dir in runs:
        name = flow_fused.KERNEL if kernel == 'RBF' else df_flow_fused.KERNEL
        t0 = time.perf_counter()
        res, d = run_path(lambda: evaluate.evaluate_one(eargs, run_dir))
        seconds = time.perf_counter() - t0
        # a forward cannot skip its trajectory, so n_batches + 1 calls
        # with n_batches + 1 launches launched it once each
        require(d[name] == n_batches + 1 and sum(d.values()) == d[name],
                f'evaluate ({kernel}) launched {d}')
        require(np.isfinite(res['mse_mean']) and np.isfinite(res['mse_std']),
                f'evaluate ({kernel}): {res}')
        roll = np.load(os.path.join(run_dir, 'eval', 'rollout.npy'))
        require(roll.shape == (1, 3, TROLL * T, 1, 28, 28) and np.isfinite(
            roll).all(), f'rollout {roll.shape}')
        log(f'evaluate ({kernel}, {os.path.basename(run_dir)}): '
            f'{json.dumps(res)}; {n_batches} test batches and the '
            f'T={TROLL * T} rollout launched {name} once each, no other '
            f'kernel; {seconds:.2f} s wall (data included); card {card}')

        # the first test batch on the card and on the CPU, same noise
        got = []
        for where in (batch.device, torch.device('cpu')):
            _, st, ta = load_run_dir(run_dir, device=where)
            noise = {k: torch.as_tensor(v, dtype=torch.float32, device=where)
                     for k, v in step_noise(
                         args.seed + 42, ta.latent_dim, ta.num_features,
                         ta.num_inducing, L_=L, batch=batch.shape[0],
                         df=kernel == 'DF',
                         shared=not st.gp.kernel.dimwise).items()}
            X = batch.to(where)
            Xrec, _ = trainer.make_eval_step()(st, X, L, noise=noise)
            got.append((Xrec.cpu(), evaluate.compute_mse_std(
                st, [X], L, noise=lambda i, b: noise)))
        (card_rec, card_mse), (cpu_rec, cpu_mse) = got
        frame_err = float((card_rec - cpu_rec).abs().max())
        mse_rel = max(abs(a - b) / abs(b) for a, b in zip(card_mse, cpu_mse))
        lim = (TOL_FORWARD, TOL_FORWARD) if kernel == 'RBF' else (
            DF_CKPT_FRAMES, DF_CKPT_MSE_REL)
        log(f'  first test batch, card vs CPU with the same noise (L={L}): '
            f'frames max abs err {frame_err:.3e} (tol {lim[0]:g}); '
            f'compute_mse_std {card_mse[0]:.6f} / {card_mse[1]:.6f} vs '
            f'{cpu_mse[0]:.6f} / {cpu_mse[1]:.6f}, max rel err '
            f'{mse_rel:.3e} (tol {lim[1]:g})')
        require(frame_err <= lim[0] and mse_rel <= lim[1],
                f'evaluate ({kernel}): the card disagrees with the CPU')


def shared_leaves(g, sample):
    """The leaves of a shared-lengthscale RBF sample and its GP as fresh
    tensors that require gradients: omega (L, D, S), phase (L, 1, S),
    weights (L, S, K), Z (M, D), nu (L, M, K), the unconstrained
    lengthscales (D,) and variance (1,)."""
    return [t.detach().clone().requires_grad_() for t in (
        sample.rff.omega, sample.rff.phase, sample.rff.weights,
        g.inducing_loc, sample.nu, g.kernel.unconstrained_lengthscales,
        g.kernel.unconstrained_variance)]


SHARED_NAMES = ('omega', 'phase', 'weights', 'Z', 'nu', 'ls', 'var')


def shared_plain_eval(x, omega, phase, weights, Z, nu, uls, uvar):
    """The port's plain shared formula: `rbf_rff_eval` + `rbf_f_update`."""
    from vae_gp_ode_tpu_torch.kernels import rbf as rbfk
    kern = rbfk.RBFParams(uls, uvar)
    return (rbfk.rbf_rff_eval(kern, rbfk.RFFState(omega, phase, weights), x)
            + rbfk.rbf_f_update(kern, nu, x, Z))


def shared_block(omega, phase, weights, Z, nu, uls, uvar):
    """The dimwise operand block the kernels take, broadcast from the
    shared leaves (`ops.pathwise.dimwise_block`)."""
    from vae_gp_ode_tpu_torch.core.transforms import softplus
    from vae_gp_ode_tpu_torch.ops.pathwise import dimwise_block
    return dimwise_block(omega, phase, weights, Z, nu, softplus(uls),
                         softplus(uvar), False)


def shared_plain_flow(z0, leaves, T_, order):
    """Euler (dt = CONFIG's) through the plain shared formula, autograd:
    zs (L, T, N, D)."""
    import torch
    K = leaves[2].shape[-1]
    zs = [z0.expand(leaves[0].shape[:-2] + tuple(z0.shape))]
    for _ in range(T_ - 1):
        z = zs[-1]
        f = shared_plain_eval(z, *leaves)
        if order == 2:
            f = torch.cat([z[..., K:], f], dim=-1)
        zs.append(z + CONFIG['dt'] * f)
    return torch.stack(zs, dim=-3)


def shared_kernel_flow(z0, leaves, T_, order):
    """The same trajectory through #1 (and #2 in reverse mode) on the
    broadcast operands."""
    from vae_gp_ode_tpu_torch.ops import flow_fused
    return flow_fused.fused_euler_flow(z0, *shared_block(*leaves),
                                       CONFIG['dt'], T_, order)


def hold_shared(what, route, plain, inputs, names, gen):
    """Run `route` and `plain` on the same leaves (forward and the VJP of
    one random cotangent): `route` twice for the same bits, its output
    within TOL_FORWARD of the plain one's and each cotangent within
    TOL_BWD (1 + max |plain|). Returns (forward err, largest cotangent
    err)."""
    import torch
    outs = []
    for _ in range(2):
        out = route(*inputs)
        g = torch.randn(out.shape, generator=torch.Generator(
            device=out.device).manual_seed(7), device=out.device)
        outs.append((out.detach(), torch.autograd.grad(out, inputs, g)))
    (out, grads), (out2, grads2) = outs
    require(torch.equal(out, out2) and all(
        torch.equal(a, b) for a, b in zip(grads, grads2)),
        f'{what}: two launches gave different bits')
    ref = plain(*inputs)
    ref_grads = torch.autograd.grad(ref, inputs, g)
    fwd = float((out - ref.detach()).abs().max())
    log(f'  {what}: forward max abs err {fwd:.3e} (tol {TOL_FORWARD:g}); '
        f'same bits twice')
    require(bool(torch.isfinite(out).all()) and fwd <= TOL_FORWARD,
            f'{what}: the kernels disagree with the plain shared formula')
    return fwd, compare_bwd(grads, ref_grads, what, names=names)


def shared_rbf(args, card, batch, slice_launches, vae_dir):
    """Phase 6g, the shared-lengthscale RBF kernel (`--dimwise False`) and
    multi-epoch segments: (i) the kernels on broadcast shared operands
    against the plain shared formula; (ii) the training CLI's run() with
    --dimwise False (every step #1/#2 once), gradients, a sync check, step
    times, rk4 steps, requests and `evaluate`; (iii) segment runs against
    per-epoch runs, bit for bit, with their host synchronisations; (iv)
    the A/B of the shared flow through #1/#2 against the plain shared
    formula. Returns what the summary line needs."""
    import warnings
    import numpy as np
    import torch
    from vae_gp_ode_tpu_torch import main as train_cli
    from vae_gp_ode_tpu_torch.gp.svgp import draw_fn_sample, init_svgp_params
    from vae_gp_ode_tpu_torch.models.odegpvae import init_model
    from vae_gp_ode_tpu_torch.ops import flow_fused, pathwise, pathwise_tiled
    from vae_gp_ode_tpu_torch.serving import load_run_dir, make_forecast_fn
    from vae_gp_ode_tpu_torch.training import trainer
    run_path = functools.partial(count_path, launches=slice_launches)
    dev = torch.device('cuda')
    q, S, M = CONFIG['latent_dim'], CONFIG['num_features'], \
        CONFIG['num_inducing']
    gen = torch.Generator(device=dev).manual_seed(args.seed + 61)
    rng = np.random.default_rng(args.seed + 61)
    errs = {k: [] for k in ('flow_fwd', 'flow_bwd', 'step_fwd', 'step_bwd',
                            'tiled_fwd', 'tiled_bwd')}
    out = {'errs': errs}

    def shared_sample(D_in, K, S_, L_):
        g = init_svgp_params(rng, D_in, K, M, dimwise=False,
                             lengthscale=CONFIG['lengthscale'],
                             variance=CONFIG['variance'], device='cuda')
        with torch.no_grad():
            return g, draw_fn_sample(g, gen, S_, L=L_)

    # -- 6g-i: the kernels on shared operands against the plain formula -----
    log('phase 6g: the shared-lengthscale RBF kernel on broadcast operands '
        'against the plain shared formula on the card:')
    for order in (1, 2):
        for L_ in (1, L):
            g, sample = shared_sample(q * order, q, S, L_)
            leaves = shared_leaves(g, sample)
            z0 = torch.randn(BATCH, q * order, generator=gen, device=dev)
            x = torch.randn(L_, BATCH, q * order, generator=gen, device=dev)
            tag = f'order {order}, L={L_}, N={BATCH}'
            f, b = hold_shared(
                f'#1/#2 {tag}, T={T}',
                lambda *lv: shared_kernel_flow(z0, lv, T, order),
                lambda *lv: shared_plain_flow(z0, lv, T, order), leaves,
                SHARED_NAMES, gen)
            errs['flow_fwd'].append(f)
            errs['flow_bwd'].append(b)
            f, b = hold_shared(
                f'#3/#4 {tag}',
                lambda x_, *lv: pathwise.fused_pathwise_eval(
                    x_, *shared_block(*lv)),
                shared_plain_eval, [x.requires_grad_()] + leaves,
                ('x',) + SHARED_NAMES, gen)
            errs['step_fwd'].append(f)
            errs['step_bwd'].append(b)
    g, sample = shared_sample(12, 12, 1024, L)
    x = torch.randn(L, 400, 12, generator=gen, device=dev,
                    requires_grad=True)
    f, b = hold_shared(
        f'#9/#10 order 1, L={L}, N=400, q=12, S=1024',
        lambda x_, *lv: pathwise_tiled.tiled_pathwise_eval(
            x_, *shared_block(*lv)),
        shared_plain_eval, [x] + shared_leaves(g, sample),
        ('x',) + SHARED_NAMES, gen)
    errs['tiled_fwd'].append(f)
    errs['tiled_bwd'].append(b)

    # -- 6g-ii: training with --dimwise False: the CLI's run() -------------
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, 'build', 'chip_smoke', 'shared')
    shutil.rmtree(work, ignore_errors=True)
    targs = train_args(os.path.join(work, 'mnist'), '--dimwise', 'False')
    steps, seen = [], {}

    def on_step(ep, L_):
        from vae_gp_ode_tpu_torch import ops
        now = dict(ops.LAUNCHES)
        steps.append((ep, L_, deltas(seen, now)))
        seen.update(now)

    def per_step_launches(what, steps, per_epoch):
        """Every step launched #1 and #2 once and no other kernel (the
        first step of a later epoch also counts the previous epoch's
        monitoring eval, one #1 launch)."""
        for i, (ep, L_, d) in enumerate(steps):
            evals = 1 if i % per_epoch == 0 and ep > 0 else 0
            if d[flow_fused.BWD_KERNEL] != 1 or d[flow_fused.KERNEL] != (
                    1 + evals) or any(v for k, v in d.items()
                                      if not k.startswith('flow_fused')):
                raise AssertionError(f'{what}: train step {i} (epoch {ep}, '
                                     f'L={L_}) launched {d}')

    t0 = time.perf_counter()
    result, launched = run_path(lambda: train_cli.run(targs,
                                                      on_step=on_step))
    train_s = time.perf_counter() - t0
    require(result['bailout'] is None, 'NaN bailout in the shared run')
    per_epoch = targs.Ndata // targs.batch + bool(targs.Ndata % targs.batch)
    require(len(steps) == TRAIN_EPOCHS * per_epoch, f'{len(steps)} steps')
    per_step_launches('--dimwise False', steps, per_epoch)
    losses = np.concatenate([e['loss'] for e in result['epochs']])
    require(losses.size == len(steps) and np.isfinite(losses).all(),
            f'shared losses {losses}')
    state = result['state']
    require(tuple(state.gp.kernel.unconstrained_lengthscales.shape) == (q,),
            'the run did not train a shared kernel')
    log(f'training with --dimwise False: run() for {TRAIN_EPOCHS} epochs '
        f'at main.py\'s defaults, {len(steps)} steps in {train_s:.1f} s; '
        f'every step launched {flow_fused.KERNEL} and '
        f'{flow_fused.BWD_KERNEL} once and no other kernel; launches '
        f'{launched}; losses finite (first {losses[0]:.2f}, last '
        f'{losses[-1]:.2f})')
    check_grads('shared step: GPU vs CPU (float64) train-step gradients '
                '(L=1, same noise)', pinned_grads(
                    state.model, state.gp, batch,
                    step_noise(args.seed + 62, q, S, M, shared=True),
                    targs.Ndata, targs.eps_guard, ('cuda', None),
                    ('cpu', torch.float64)))
    step = trainer.make_train_step(targs.Ndata, eps_guard=targs.eps_guard)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        step(state, batch, L)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log('sync check: a shared train step (L=5) under '
        'set_sync_debug_mode("error"): no synchronising operation')
    out['step'] = {}
    times = []
    for L_ in (1, L):
        for _ in range(3):
            step(state, batch, L_)
        ms = cuda_ms(lambda: step(state, batch, L_), 20, warmup=0)
        busy = profile(lambda: step(state, batch, L_),
                       f'one shared L={L_} train step')
        require(busy is not None,
                'the profiler recorded no device time of a shared step')
        out['step'][L_] = (ms, busy)
        times.append(f'L={L_}: {ms:.3f} ms, device busy {busy[0]:.3f} ms, '
                     f'idle share {busy[1]:.3f}')
    log('shared train step (CUDA events over 20 steps, batch on the card): '
        + '; '.join(times) + f'; card {card}')
    # the L=5 step's device busy time beside the dimwise step's, in turns
    dstate = trainer.create_train_state(*init_model(
        args.seed, device='cuda', **CONFIG), lr=targs.lr)
    for _ in range(3):
        step(dstate, batch, L)
    pair = {'shared': [], 'dimwise': []}
    for _ in range(3):
        for k, st_ in (('shared', state), ('dimwise', dstate)):
            # a trace the profiler recorded nothing of is taken again
            for _ in range(3):
                reading = busy_ms(lambda: step(st_, batch, L))
                if reading[0] > 0:
                    pair[k].append(reading)
                    break
    require(all(pair.values()),
            'the profiler recorded no device time of an L=5 step')
    out['busy_pair'] = {k: (statistics.median(b for b, _ in v), v[0][1])
                        for k, v in pair.items()}
    log(f'L={L} train step, shared against dimwise, in turns, device busy '
        f'ms (torch.profiler): ' + '; '.join(
            f'{k}: ' + ', '.join(f'{b:.3f}' for b, _ in v) + f' (median '
            f'{out["busy_pair"][k][0]:.3f}, {v[0][1]} kernels)'
            for k, v in pair.items()) + f'; card {card}')

    # rk4 through the rule's per-step pair, GPU vs CPU gradients
    rm, rg = init_model(args.seed + 63, device='cuda', dimwise=False,
                        **dict(CONFIG, solver='rk4'))
    check_grads('shared rk4 step: GPU vs CPU (float64) train-step '
                'gradients (L=1, same noise)', pinned_grads(
                    rm, rg, batch,
                    step_noise(args.seed + 63, q, S, M, shared=True),
                    targs.Ndata, targs.eps_guard, ('cuda', None),
                    ('cpu', torch.float64)))
    rstate = trainer.create_train_state(rm, rg, lr=targs.lr)
    metrics, d = run_path(lambda: [step(rstate, batch, L)
                                   for _ in range(3)])
    fk, bk = rule_names('RBF', L, BATCH, q, S, M)
    require(d[fk] > 0 and d[bk] > 0 and sum(d.values()) == d[fk] + d[bk]
            and all(bool(torch.isfinite(m['loss'])) for m in metrics),
            f'shared rk4 steps launched {d}; the rule names {fk}, {bk}')
    log(f'shared rk4: 3 train steps (L={L}) through the rule\'s pair '
        f'{fk}/{bk} alone: launches {d}; losses finite')

    # the run directory serves: 3 requests and a rollout, one #1 each
    model, st, _ = load_run_dir(result['save'], device='cuda')
    rng_px = np.random.default_rng(args.seed + 64)
    fns = (make_forecast_fn(model, None, st.gp, L=L, normalize_input=True,
                            device='cuda'),
           make_forecast_fn(model, None, st.gp, L=L, T_custom=T * TROLL,
                            normalize_input=True, device='cuda'))
    for i, (fn_, Tout) in enumerate(((fns[0], T),) * 3 + ((fns[1],
                                                            T * TROLL),)):
        X = rng_px.random((BATCH, T, 1, 28, 28)).astype(np.float32)
        Xrec, d = run_path(lambda: fn_(X, args.seed + i))
        require(tuple(Xrec.shape) == (L, BATCH, Tout, 1, 28, 28) and bool(
            torch.isfinite(Xrec).all()) and d[flow_fused.KERNEL] == 1 and
            sum(d.values()) == 1, f'shared request {i}: {d}')
    log(f'shared run directory (load_run_dir): 3 requests of {BATCH} '
        f'sequences and a T={T * TROLL} rollout, {flow_fused.KERNEL} once '
        f'each and no other kernel, finite')
    from vae_gp_ode_tpu_torch.data.mnist import load_data
    _, testset = load_data(targs, device=dev)
    evaluate_runs(args, card, (('RBF', result['save']),), batch,
                  len(testset), slice_launches)

    # -- 6g-iii: segments against per-epoch runs, bit for bit ----------------
    def counted_run(what, targs, n_epochs, segments):
        steps.clear()
        seen.clear()           # run_path sets the counts to 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode('warn')
            try:
                t0 = time.perf_counter()
                res, d = run_path(lambda: train_cli.run(targs,
                                                        on_step=on_step))
                secs = time.perf_counter() - t0
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = sum('synchroniz' in str(w.message) for w in caught)
        require(res['bailout'] is None and res['segments'] == segments,
                f'{what}: segments {res["segments"]}, expected {segments}')
        per_step_launches(what, steps, per_epoch)
        require(len(steps) == n_epochs * per_epoch, f'{what}: {len(steps)} '
                f'steps')
        log(f'  {what}: segments {res["segments"]}, {len(steps)} steps, '
            f'{syncs} host synchronisations (set_sync_debug_mode("warn")), '
            f'{secs:.2f} s wall (data and set-up included), frozen checks '
            f'{res["frozen_checks"]}; every step launched '
            f'{flow_fused.KERNEL} and {flow_fused.BWD_KERNEL} once; '
            f'launches {d}')
        return res, syncs, secs

    def same_bits(what, a, b):
        require(len(a['epochs']) == len(b['epochs']) and all(
            ra.keys() == rb.keys() and all(
                np.array_equal(ra[k], rb[k]) for k in ra)
            for ra, rb in zip(a['epochs'], b['epochs'])),
            f'{what}: per-step metrics or mses differ')
        sa, sb = a['state'], b['state']
        require(all(torch.equal(x, y) for x, y in zip(sa.params(),
                                                      sb.params())) and all(
            torch.equal(x, y) for x, y in zip(sa.model.buffers(),
                                              sb.model.buffers())) and
            torch.equal(sa.optimizer.mu, sb.optimizer.mu) and
            torch.equal(sa.optimizer.nu, sb.optimizer.nu) and
            a['ckpt_epochs'] == b['ckpt_epochs'],
            f'{what}: the final states differ')
        log(f'  {what}: per-step losses and metrics, monitoring mses, '
            f'checkpoint epochs {a["ckpt_epochs"]} and the final parameters, '
            f'BatchNorm statistics and Adam moments bit for bit')

    log('phase 6g segments (cudnn deterministic):')
    out['segments'] = {}
    with cudnn_deterministic():
        for what, extra, n_ep, segs in (
                ('main.py defaults', (), 24, [(1, 10), (12, 10)]),
                ('--pretrained', ('--pretrained', 'True', '--vae_path',
                                  vae_dir), 12, [(1, 4), (6, 4)])):
            E = segs[0][1]
            runs = {}
            for e in (E, 1):
                a = train_args(os.path.join(work, f'seg{e}_{len(extra)}'),
                               '--Nepoch', str(n_ep), '--plot_freq', '100',
                               '--epochs_per_dispatch', str(e), *extra)
                runs[e] = counted_run(
                    f'{what}, --Nepoch {n_ep} --epochs_per_dispatch {e}', a,
                    n_ep, segs if e > 1 else [])
            same_bits(f'{what}: E={E} against E=1', runs[E][0], runs[1][0])
            if extra:
                require(runs[E][0]['frozen_checks'] == n_ep - sum(
                    n - 1 for _, n in segs), 'frozen checks')
            out['segments'][what] = {e: r[1:] + (r[0]['frozen_checks'],)
                                     for e, r in runs.items()}

    # -- 6g-iv: A/B of the shared flow, kernels against the plain formula ---
    g, sample = shared_sample(q, q, S, L)
    leaves = shared_leaves(g, sample)
    z0 = torch.randn(BATCH, q, generator=gen, device=dev)
    zsbar = torch.randn(L, T, BATCH, q, generator=gen, device=dev)
    calls = {
        'kernels': lambda: torch.autograd.grad(
            shared_kernel_flow(z0, leaves, T, 1), leaves, zsbar),
        'plain': lambda: torch.autograd.grad(
            shared_plain_flow(z0, leaves, T, 1), leaves, zsbar)}
    busy = {k: [] for k in calls}
    for fn_ in calls.values():
        fn_()
    for _ in range(5):
        for k, fn_ in calls.items():
            busy[k].append(busy_ms(fn_))
    ms = {k: cuda_ms(fn_, 10) for k, fn_ in calls.items()}
    med = {k: statistics.median(b for b, _ in v) for k, v in busy.items()}
    out['ab'] = (med, ms, {k: v[0][1] for k, v in busy.items()})
    log(f'A/B, one L={L} shared flow forward + backward (N={BATCH}, T={T}, '
        f'q={q}, S={S}, M={M}, order 1), in turns, device busy ms per '
        f'round (torch.profiler): ' + '; '.join(
            f'{k}: ' + ', '.join(f'{b:.4f}' for b, _ in v) + f' (median '
            f'{med[k]:.4f}, {v[0][1]} kernels)' for k, v in busy.items())
        + '; CUDA events per call: ' + ', '.join(
            f'{k} {v:.4f} ms' for k, v in ms.items()) + f'; card {card}')
    log(f'phase 6g launches on its paths (counts set to 0 before each): '
        f'{ {k: v for k, v in slice_launches.items() if v} }')
    return out


# tolerance of a served artifact against the eager forecaster on the card
# at the same seed, and of a CPU-exported artifact on the card against
# the card-exported one: the same operations on the same inputs
TOL_ARTIFACT = 1e-5
#: the bf16 artifact against the f32 one at the same noise: sigmoid
#: frames, a few bf16 ulps (2^-8) of drift through the decoder
BF16_FRAMES = 0.05
#: a feature count the fused euler pair refuses at q = 6 on an H100
#: (`ops.flow_fused.pair_fits`), for an artifact traced on the CPU
ART_REFUSED_S = 2048


#: the input horizon of 6h's bdf forecaster: 8, since its export at T=16
#: took 82 s on an H100 (over a minute; PERF.md section 6), as the
#: trace unrolls every Newton iteration of every substep
BDF_T = 8
#: the sequences of 6h's bdf requests
BDF_BATCHES = (1, BATCH, 400)
#: bdf's Newton iterations per substep (`dynamics.solvers._fixed_bdf2`)
NEWTON_ITERS = 6
#: the routes of a wrapper call where no input needs a gradient
#: (`eager_route`)
ROUTES = ('op', 'direct', 'custom_op')
_CUSTOM_OPS = {}


@contextlib.contextmanager
def eager_route(route):
    """Where no input needs a gradient, the forward wrappers (#1, #7 and
    the per-step rule) call: 'op', the operators of `ops.library` (as the
    package ships); 'direct', their `torch.autograd.Function`s, which
    launch through ctypes with no operator between (the route before the
    operators); 'custom_op', the operators' own CUDA implementations
    registered again through `torch.library.custom_op` (namespace
    `chip_smoke_ab`), whose Python autograd layer the package avoids.
    The same kernels on the same inputs: only host time differs."""
    from vae_gp_ode_tpu_torch.ops import library
    names = ('flow_fused_fwd', 'df_flow_fused_fwd', 'pathwise_eval_fwd',
             'df_pathwise_eval_fwd')
    if route == 'op':
        yield
        return
    if route == 'direct':
        patch = {'needs_grad': lambda tensors: True}
    else:
        import torch
        if not _CUSTOM_OPS:
            impls = dict(zip(names, (library._flow_cuda,
                                     library._df_flow_cuda,
                                     library._pathwise_cuda,
                                     library._df_pathwise_cuda)))
            for name in names:
                schema = str(getattr(library, name)._schema)
                _CUSTOM_OPS[name] = torch.library.custom_op(
                    f'chip_smoke_ab::{name}', impls[name], mutates_args=(),
                    device_types='cuda', schema=schema[schema.index('('):])
        patch = dict(_CUSTOM_OPS)
    saved = {k: getattr(library, k) for k in patch}
    for k, v in patch.items():
        setattr(library, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(library, k, v)


def routed(fn, route):
    """fn(*args) under `eager_route(route)`."""
    def call(*a):
        with eager_route(route):
            return fn(*a)
    return call


def turns(fns, X, seed, rounds=5, host=None):
    """Median request ms (CUDA events) of each fn, in turns; with a
    dict `host`, also each fn's median host ms: from the call to its
    return, the card idle before it (the time the host takes to issue
    the request, which the card's queue may hide)."""
    import torch
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ms = {k: [] for k in fns}
    issue = {k: [] for k in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(rounds):
        for k in order:
            torch.cuda.synchronize()
            ev0.record()
            t0 = time.perf_counter()
            fns[k](X, seed)
            issue[k].append((time.perf_counter() - t0) * 1e3)
            ev1.record()
            torch.cuda.synchronize()
            ms[k].append(ev0.elapsed_time(ev1))
    if host is not None:
        host.update({k: statistics.median(v) for k, v in issue.items()})
    return {k: statistics.median(v) for k, v in ms.items()}


@contextlib.contextmanager
def row_jacobian_route():
    """bdf's Newton Jacobians through `dynamics.solvers.row_jacobian` (D
    reverse-mode products, each a VJP kernel launch), the route before
    the Jacobian operators: the flows' right-hand sides without their
    `jacobian`."""
    from vae_gp_ode_tpu_torch.dynamics import flow
    make = flow.make_ode_rhs

    def without(*a):
        rhs = make(*a)
        return lambda t, z: rhs(t, z)

    flow.make_ode_rhs = without
    try:
        yield
    finally:
        flow.make_ode_rhs = make


def plain_eval_nodes(program):
    """The nodes of a traced program that compute a per-step eval's plain
    version: cos or sin of a tensor with the symbolic batch in its shape
    (the GP draw's cos runs at the inducing points, and the VAE computes
    neither)."""
    import torch
    trig = (torch.ops.aten.cos.default, torch.ops.aten.sin.default)
    return [n for n in program.graph.nodes if n.target in trig and any(
        not isinstance(d, int) for d in n.meta['val'].shape)]


def jacobian_operators(args, card):
    """6h: the Jacobian operators (`ops.library` `pathwise_eval_jac`,
    `df_pathwise_eval_jac`) against their plain versions on the card at
    the main widths (q=6, S=256, M=100, L=5, N=20) and a wide shape (q=12,
    S=1024, N=100): the operator (one launch of the VJP kernel its rule
    names for the N*q rows) and each VJP kernel of its family through
    `ops.pathwise.launch_jacobian` (#4 and #10, #6 and #12), TOL_ABS +
    TOL_REL. Returns the largest error."""
    import numpy as np
    import torch
    from vae_gp_ode_tpu_torch import ops
    from vae_gp_ode_tpu_torch.gp.svgp import draw_fn_sample, init_svgp_params
    from vae_gp_ode_tpu_torch.ops import (
        df_pathwise, df_pathwise_tiled, library, pathwise, pathwise_tiled)
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(args.seed + 71)
    rng = np.random.default_rng(args.seed + 71)
    M = CONFIG['num_inducing']
    errs = []
    for kernel in ('RBF', 'DF'):
        df = kernel == 'DF'
        op = library.df_pathwise_eval_jac if df else library.pathwise_eval_jac
        plain = (df_pathwise.df_pathwise_jacobian_reference if df
                 else pathwise.pathwise_jacobian_reference)
        kernels = ((df_pathwise, df_pathwise_tiled) if df
                   else (pathwise, pathwise_tiled))
        for D_, S_, N_ in ((CONFIG['latent_dim'], CONFIG['num_features'],
                            BATCH), (12, 1024, 100)):
            g = init_svgp_params(rng, D_, D_, M, kernel=kernel,
                                 lengthscale=2.0 if df else
                                 rbf_lengthscale(D_), variance=0.7,
                                 device='cuda')
            with torch.no_grad():
                operands = tuple(t.contiguous() for t in (
                    df_pathwise.df_fused_operands if df else
                    pathwise.rbf_fused_operands)(
                        g, draw_fn_sample(g, gen, S_, L=L)))
            x = torch.randn((L, N_, D_), generator=gen, device=dev)
            ref = plain(x, *operands)
            what = f'{kernel} L={L} N={N_} q={D_} S={S_}'
            ops.reset_launches()
            J = op(x, *operands)
            torch.cuda.synchronize()
            ran = {k: v for k, v in ops.LAUNCHES.items() if v}
            require(len(ran) == 1 and sum(ran.values()) == 1 and next(
                iter(ran)) in [m.BWD_KERNEL for m in kernels],
                f'Jacobian operator {what}: launched {ran}')
            require(J.shape == (L, N_, D_, D_), f'{what}: {tuple(J.shape)}')
            errs.append(compare(J, ref, f'{op} {what} through '
                                        f'{next(iter(ran))} (the rule)'))
            for m in kernels:
                J = pathwise.launch_jacobian(m._launch_bwd, x, operands, D_)
                errs.append(compare(J, ref, f'Jacobian {what} through '
                                            f'{m.BWD_KERNEL}'))
    log(f'Jacobian operators against their plain versions: largest error '
        f'{max(errs):.3e} (tol abs {TOL_ABS:g} + rel {TOL_REL:g}); card '
        f'{card}')
    return max(errs)


def bdf_forecaster(args, card, launches, work, model, gp, euler_max_batch):
    """6h: a bdf forecaster at the main widths exported on the card with a
    symbolic batch (BDF_T frames), its Newton Jacobians the Jacobian
    operator: no plain per-step eval in its graph (`plain_eval_nodes`),
    NEWTON_ITERS Jacobian calls a substep; saved, loaded and serving
    BDF_BATCHES sequences with the counts at 0 just before each request
    (a VJP kernel, #10 or #4, NEWTON_ITERS times a substep, the per-step
    forward kernels, nothing else), its frames against the eager bdf
    forecaster at the same noise (TOL_ARTIFACT). Export s, bytes,
    max_batch, load s; the request ms and busy ms of the artifact and the
    eager forecaster in turns (median of 5); the eager request's VJP
    launches through the Jacobian operator and through `row_jacobian`
    (`row_jacobian_route`: q per Newton iteration), and its frames both
    ways; an eager DF bdf request (random weights) both ways, #6 or #12
    once per Newton iteration through the operator; one Jacobian at the request's rows, device µs by kernel, and the
    share of its VJP's work that the dropped operand cotangents take."""
    import numpy as np
    import torch
    from vae_gp_ode_tpu_torch import serving
    from vae_gp_ode_tpu_torch.gp.svgp import draw_fn_sample, fn_jacobian
    from vae_gp_ode_tpu_torch.models.odegpvae import init_model
    from vae_gp_ode_tpu_torch.ops import (
        df_pathwise, df_pathwise_tiled, pathwise, pathwise_tiled)
    dev = torch.device('cuda')
    q = CONFIG['latent_dim']
    bm = copy.deepcopy(model)
    bm.solver = 'bdf'
    t0 = time.perf_counter()
    fc = serving.export_forecaster(bm, None, gp, T=BDF_T, L=L,
                                   normalize_input=True, device='cuda')
    export_s = time.perf_counter() - t0
    targets = collections.Counter(str(n.target)
                                  for n in fc.program.graph.nodes)
    n_jac = targets['vae_gp_ode_torch.pathwise_eval_jac.default']
    plain = plain_eval_nodes(fc.program)
    require(fc.input_shape[0] == 'b' and not fc.meta['plain_evals'],
            f'bdf artifact: input {fc.input_shape}, meta {fc.meta}')
    require(n_jac == NEWTON_ITERS * (BDF_T - 1) and not plain,
            f'bdf artifact: {n_jac} Jacobian operator calls, plain evals '
            f'{[n.name for n in plain[:5]]}')
    path = os.path.join(work, 'bdf.pt2')
    nbytes = serving.save_forecaster(fc, path)
    t0 = time.perf_counter()
    art = serving.load_forecaster(path)
    load_s = time.perf_counter() - t0
    log(f'bdf artifact T={BDF_T}: exported on the card in {export_s:.2f} s, '
        f'{nbytes} bytes, loaded in {load_s:.2f} s')
    eager = serving.make_forecast_fn(bm, None, gp, L=L, normalize_input=True,
                                     device='cuda')
    vjp = (pathwise.BWD_KERNEL, pathwise_tiled.BWD_KERNEL)
    fwd = (pathwise.KERNEL, pathwise_tiled.KERNEL)
    per_request = NEWTON_ITERS * (BDF_T - 1)
    rng = np.random.default_rng(args.seed + 72)
    inputs = {}
    for n in BDF_BATCHES:
        X = rng.random((n, BDF_T, 1, 28, 28)).astype(np.float32)
        noise = serving.draw_noise(
            fc.meta['noise_spec'], n,
            torch.Generator(device=dev).manual_seed(args.seed + n), dev)
        inputs[n] = (X, noise)
        art.call(X, noise)
        Xa, d = count_path(lambda: art.call(X, noise), launches)
        require(sum(d[k] for k in vjp) == per_request and sum(
            d[k] for k in fwd) > 0 and not any(
                v for k, v in d.items() if k not in vjp + fwd),
            f'bdf artifact, {n} sequences: launched {d}')
        require(Xa.shape == (L, n, BDF_T, 1, 28, 28) and bool(
            torch.isfinite(Xa).all()), f'bdf artifact, {n} sequences: '
            f'frames {tuple(Xa.shape)}')
        err = float((Xa - eager(X, 0, noise=noise)).abs().max())
        require(err <= TOL_ARTIFACT, f'bdf artifact, {n} sequences: against '
                f'the eager forecaster {err:.3e}')
        log(f'bdf artifact, {n} sequences: launches {d}; frames against '
            f'the eager bdf forecaster at the same noise {err:.3e} (tol '
            f'{TOL_ARTIFACT:g})')
    X, noise = inputs[BATCH]
    after, d_after = count_path(lambda: eager(X, 0, noise=noise), launches)
    with row_jacobian_route():
        before, d_before = count_path(lambda: eager(X, 0, noise=noise),
                                      launches)
    n_after = sum(d_after[k] for k in vjp)
    n_before = sum(d_before[k] for k in vjp)
    require(n_after == per_request and n_before == q * per_request,
            f'eager bdf request: VJP launches {n_after} through the '
            f'operator, {n_before} through row_jacobian')
    routes_err = float((after - before).abs().max())
    # the DF kernel's Jacobian operator on the eager bdf path: a request of
    # BATCH sequences with random weights, against the row_jacobian route
    dm, dg = init_model(args.seed, device='cuda', random_bn=True,
                        kernel='DF', solver='bdf', **CONFIG)
    deager = serving.make_forecast_fn(dm, None, dg, L=L,
                                      normalize_input=True, device='cuda')
    dnoise = serving.forecast_noise(
        dg, dm, BATCH, L, torch.Generator(device=dev).manual_seed(args.seed))
    dvjp = (df_pathwise.BWD_KERNEL, df_pathwise_tiled.BWD_KERNEL)
    dafter, dd = count_path(lambda: deager(X, 0, noise=dnoise), launches)
    with row_jacobian_route():
        dbefore, ddb = count_path(lambda: deager(X, 0, noise=dnoise),
                                  launches)
    df_err = float((dafter - dbefore).abs().max())
    require(sum(dd[k] for k in dvjp) == per_request and sum(
        ddb[k] for k in dvjp) == q * per_request and bool(
            torch.isfinite(dafter).all()) and df_err <= TOL_ARTIFACT,
        f'eager DF bdf request: VJP launches {dd} through the operator, '
        f'{ddb} through row_jacobian, frames both ways {df_err:.3e}')
    log(f'eager DF bdf request of {BATCH}: launches {dd} through the '
        f'Jacobian operator, VJP {sum(ddb[k] for k in dvjp)} through '
        f'row_jacobian; frames both ways {df_err:.3e} (tol '
        f'{TOL_ARTIFACT:g})')
    ms = turns({'artifact': art, 'eager': eager}, X, args.seed)
    busy = {'artifact': [], 'eager': []}
    for _ in range(5):
        for k, f in (('artifact', art), ('eager', eager)):
            busy[k].append(busy_ms(lambda f=f: f(X, args.seed))[0])
    busy = {k: statistics.median(v) for k, v in busy.items()}
    idle = {k: profile(lambda f=f: f(X, args.seed),
                       f'one bdf request of {BATCH}, {k}')
            for k, f in (('artifact', art), ('eager', eager))}
    # one Jacobian at the request's rows: its VJP kernel's device time, the
    # kernel that sums the operands' cotangents (which the Jacobian drops)
    # apart, and the share of the VJP's operations and bytes written that
    # those cotangents take (`pathwise_bound`'s counts: per row K S (6D +
    # 10) + K M (12D + 10) for the VJP, K S (2D + 4) + K M (4D + 4) for
    # dx alone, an eval's)
    S, M = CONFIG['num_features'], CONFIG['num_inducing']
    name = pathwise_tiled.rule_kernels(L, BATCH * q, q, q, S, M, dev)[1]
    gen = torch.Generator(device=dev).manual_seed(args.seed + 73)
    with torch.no_grad():
        sample = draw_fn_sample(gp, gen, S, L=L)
    z = torch.randn((L, BATCH, q), generator=gen, device=dev)
    jac_us = device_us(lambda: fn_jacobian(gp, sample, z), [name])
    operands = pathwise.rbf_fused_operands(gp, sample)
    param_bytes = sum(4 * t.numel() for t in operands)
    dx_bytes = 4 * L * BATCH * q * q
    ops_share = 1 - (q * S * (2 * q + 4) + q * M * (4 * q + 4)) / (
        q * S * (6 * q + 10) + q * M * (12 * q + 10))
    log(f'one Jacobian of the bdf request ({L} draws x {BATCH * q} rows, '
        f'{name}; torch.profiler over 10 calls): '
        + ', '.join(f'{k} {per_launch(v)}' for k, v in jac_us.items())
        + f'; the operands\' cotangents it drops: {param_bytes} of '
        f'{param_bytes + dx_bytes} bytes written and {ops_share:.3f} of '
        f'its operations (counted from the shapes); card {card}')
    log(f'artifact RBF bdf T={BDF_T}: exported on the card in '
        f'{export_s:.2f} s (symbolic batch, {n_jac} Jacobian operator '
        f'calls, no plain per-step eval), {nbytes} bytes, loaded in '
        f'{load_s:.2f} s, at most {art.meta["max_batch"]} sequences (the '
        f'euler artifact: {euler_max_batch}); request of {BATCH} '
        f'sequences (CUDA events, median of 5 in turns) artifact '
        f'{ms["artifact"]:.4f} ms, eager {ms["eager"]:.4f} ms; busy '
        f'(torch.profiler, median of 5 in turns) artifact '
        f'{busy["artifact"]:.4f} ms, eager {busy["eager"]:.4f} ms'
        + ''.join(f'; {k} idle share {v[1]:.3f}' for k, v in idle.items()
                  if v)
        + f'; the eager request\'s VJP launches {n_before} through '
        f'row_jacobian ({q} per Newton iteration), {n_after} through the '
        f'Jacobian operator (1), frames both ways {routes_err:.3e}; card '
        f'{card}')
    return dict(export_s=export_s, nbytes=nbytes, load_s=load_s, ms=ms,
                busy=busy, vjp_before=n_before, vjp_after=n_after,
                max_batch=art.meta['max_batch'], jac_us=jac_us)


def serving_artifacts(args, card, launches):
    """Phase 6h, the serving artifact: `torch.export` forecasters saved,
    loaded and served on the card, their forward kernels running as the
    registered operators of `ops.library`. At full width: the main
    configuration's RBF euler forecaster (L=5, symbolic batch), its T=32
    rollout, checkpoints/df_5000ep (L=5, symbolic batch) and a dopri5
    forecaster (max_steps 64, batch 20), each exported on the card (export
    seconds, bytes, load seconds), loaded there, and three requests of 20
    sequences served with the counts set to 0 just before each: #1 once a
    RBF euler request, #7 once a DF request, #3 or #9 on the dopri5 one,
    no VJP kernel; the frames against the eager forecaster at the same
    seed (TOL_ARTIFACT) and against the same file served on the CPU at the
    same noise (TOL_FORWARD; the DF checkpoint DF_CKPT_FRAMES). An
    artifact exported on the CPU and served on the card (#1 once a
    request, TOL_ARTIFACT against the card-exported one), one traced on
    the CPU at a shape the fused pair refuses (S = ART_REFUSED_S: the load
    on the card raises naming it), the Jacobian operators
    (`jacobian_operators`) and a bdf forecaster with a symbolic batch
    (`bdf_forecaster`), and the bf16 artifact against the f32 one
    (BF16_FRAMES). Request ms with CUDA events and the host's ms
    to issue it (median of 5 rounds in turns: artifact, eager, eager,
    artifact), the device busy time and idle share of one request of each
    (torch.profiler), and the eager T=16 and dopri5 requests through each
    of ROUTES in turns."""
    import numpy as np
    import torch
    from vae_gp_ode_tpu_torch import serving
    from vae_gp_ode_tpu_torch.models.odegpvae import init_model
    dev = torch.device('cuda')
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, 'build', 'chip_smoke', 'serving')
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(args.seed + 70)
    raw = [rng.random((BATCH, T, 1, 28, 28)).astype(np.float32)
           for _ in range(3)]
    model, gp = init_model(args.seed, device='cuda', random_bn=True,
                           **CONFIG)
    dmodel, dgp = init_model(args.seed, device='cuda', random_bn=True,
                             solver='dopri5', max_steps=64, **CONFIG)
    cmodel, cst, _ = serving.load_run_dir(
        os.path.join(root, 'checkpoints', 'df_5000ep'), device='cuda')
    rbf_k, df_k = ('flow_fused_fwd',), ('df_flow_fused_fwd',)
    cases = (  # key, what, model, gp, T_custom, batch, kernels, per request
        ('rbf', f'RBF euler T={T}', model, gp, None, None, rbf_k, 1),
        ('rbf_roll', f'RBF euler T={T * TROLL} rollout', model, gp,
         T * TROLL, None, rbf_k, 1),
        ('df', 'DF euler, checkpoints/df_5000ep', cmodel, cst.gp, None,
         None, df_k, 1),
        ('dopri5', 'RBF dopri5, max_steps 64', dmodel, dgp, None, BATCH,
         ('pathwise_fwd', 'pathwise_tiled_fwd'), None))

    def noise_for(fc, seed):
        return serving.draw_noise(
            fc.meta['noise_spec'], BATCH,
            torch.Generator(device=dev).manual_seed(seed), dev)

    def serve(what, art, kernels, per_request, Tout):
        """Three requests with the counts at 0 just before each; returns
        their frames."""
        frames = []
        for i in range(3):
            Xa, d = count_path(lambda: art(raw[i], args.seed + i), launches)
            n = sum(d[k] for k in kernels)
            require(n == per_request if per_request else n > 0,
                    f'{what}: request {i} launched {d}')
            require(not any(v for k, v in d.items()
                            if k not in kernels), f'{what}: request {i} '
                    f'launched kernels besides {kernels}: {d}')
            require(Xa.shape == (L, BATCH, Tout, 1, 28, 28) and bool(
                torch.isfinite(Xa).all()), f'{what}: request {i} frames')
            frames.append(Xa)
        return frames, d

    out = {}
    for key, what, m, g, T_custom, batch, kernels, per_request in cases:
        Tout = T_custom or T
        t0 = time.perf_counter()
        fc = serving.export_forecaster(
            m, None, g, T=T, batch=batch, L=L, T_custom=T_custom,
            normalize_input=True, platforms=('cuda', 'cpu'), device='cuda')
        export_s = time.perf_counter() - t0
        path = os.path.join(work, f'{key}.pt2')
        nbytes = serving.save_forecaster(fc, path)
        t0 = time.perf_counter()
        art = serving.load_forecaster(path)
        load_s = time.perf_counter() - t0
        require(art.input_shape[0] == ('b' if batch is None else batch),
                f'{what}: input shape {art.input_shape}')
        eager = serving.make_forecast_fn(m, None, g, L=L, T_custom=T_custom,
                                         normalize_input=True, device='cuda')
        art(raw[0], 0)
        eager(raw[0], 0)
        frames, d = serve(what, art, kernels, per_request, Tout)
        err_eager = max(float((Xa - eager(raw[i], args.seed + i)).abs().max())
                        for i, Xa in enumerate(frames))
        require(err_eager <= TOL_ARTIFACT, f'{what}: artifact vs eager '
                f'{err_eager:.3e}')
        cpu_art = serving.load_forecaster(path, device='cpu')
        noise = noise_for(art, args.seed + 5)
        Xa = art.call(raw[1], noise)
        Xc = cpu_art.call(raw[1], {k: v.cpu() for k, v in noise.items()})
        err_cpu = float((Xa.cpu() - Xc).abs().max())
        tol_cpu = DF_CKPT_FRAMES if key == 'df' else TOL_FORWARD
        require(err_cpu <= tol_cpu, f'{what}: card vs CPU {err_cpu:.3e}')
        host = {}
        ms = turns({'artifact': art, 'eager': eager}, raw[1], args.seed,
                   host=host)
        nodes = collections.Counter(n.op for n in art._module.graph.nodes)
        if key in ('rbf', 'dopri5'):
            # the eager request through each route of the wrappers, in
            # turns: the same kernels, counted as before
            for route in ROUTES[1:]:
                _, dr = count_path(lambda: routed(eager, route)(
                    raw[0], args.seed), launches)
                require(sum(dr[k] for k in kernels) > 0, f'{what}: the '
                        f'eager request through {route} launched {dr}')
            ms_routes = turns({r: routed(eager, r) for r in ROUTES},
                              raw[1], args.seed)
            log(f'eager {what} request by route (CUDA events, median of '
                f'5 in turns): ' + ', '.join(
                    f'{r} {v:.4f} ms' for r, v in ms_routes.items())
                + f'; card {card}')
        busy = {k: profile(lambda f=f: f(raw[1], args.seed),
                           f'one {what} request, {k}')
                for k, f in (('artifact', art), ('eager', eager))}
        out[key] = dict(export_s=export_s, nbytes=nbytes, load_s=load_s,
                        max_batch=art.meta['max_batch'],
                        err_eager=err_eager, err_cpu=err_cpu, ms=ms,
                        busy=busy, launches=d, host=host,
                        ms_routes=ms_routes if key in ('rbf', 'dopri5')
                        else None)
        log(f'artifact {what}: exported on the card in {export_s:.2f} s, '
            f'{nbytes} bytes, loaded in {load_s:.2f} s, batch '
            f'{art.input_shape[0]} (at most {art.meta["max_batch"]}); 3 '
            f'requests of '
            f'{BATCH} sequences, launches per request {d}; frames against '
            f'the eager forecaster {err_eager:.3e} (tol {TOL_ARTIFACT:g}), '
            f'against the file served on the CPU {err_cpu:.3e} (tol '
            f'{tol_cpu:g}); request ms (CUDA events, median of 5 in turns) '
            f'artifact {ms["artifact"]:.4f}, eager {ms["eager"]:.4f}; host '
            f'ms to issue a request (median of 5 in turns) artifact '
            f'{host["artifact"]:.4f}, eager {host["eager"]:.4f}, the graph '
            f'{nodes["call_function"]} calls and {nodes["get_attr"]} '
            f'attribute reads; busy '
            + ', '.join(f'{k} {v[0]:.4f} ms (idle share {v[1]:.3f})'
                        for k, v in busy.items() if v)
            + f'; card {card}')
        if key == 'rbf':
            primary = (m, g, fc, art, eager)

    # the main configuration exported on the CPU, served on the card
    m, g, fc, art, eager = primary
    t0 = time.perf_counter()
    cfc = serving.export_forecaster(
        copy.deepcopy(m).to('cpu'), None, g.to('cpu'), T=T, L=L,
        normalize_input=True, platforms=('cpu', 'cuda'), device='cpu')
    cexport_s = time.perf_counter() - t0
    cpath = os.path.join(work, 'rbf_cpu.pt2')
    serving.save_forecaster(cfc, cpath)
    cart = serving.load_forecaster(cpath)
    cart(raw[0], 0)
    frames, d = serve('CPU-exported RBF euler', cart, rbf_k, 1, T)
    noise = noise_for(cart, args.seed + 6)
    err_moved = float((cart.call(raw[2], noise)
                       - art.call(raw[2], noise)).abs().max())
    require(err_moved <= TOL_ARTIFACT, f'the CPU-exported artifact on the '
            f'card vs the card-exported one: {err_moved:.3e}')
    log(f'artifact RBF euler T={T} exported on the CPU ({cexport_s:.2f} s) '
        f'and served on the card: launches per request {d}; frames against '
        f'the card-exported artifact at the same noise {err_moved:.3e} '
        f'(tol {TOL_ARTIFACT:g}); card {card}')

    # a CPU trace at a shape the fused pair refuses on the card
    wm, wg = init_model(args.seed, device='cpu',
                        **dict(CONFIG, num_features=ART_REFUSED_S))
    wfc = serving.export_forecaster(wm, None, wg, T=T, L=L, device='cpu',
                                    platforms=('cpu', 'cuda'))
    wpath = os.path.join(work, 'refused.pt2')
    serving.save_forecaster(wfc, wpath)
    try:
        serving.load_forecaster(wpath)
    except RuntimeError as e:
        refused = str(e)
    else:
        raise AssertionError(f'an artifact traced on the CPU at S='
                             f'{ART_REFUSED_S} loaded on the card')
    require(f'S={ART_REFUSED_S}' in refused, f'refusal: {refused}')
    log(f'artifact traced on the CPU at S={ART_REFUSED_S}: the load on the '
        f'card refuses it: {refused}')

    # bdf: its Newton Jacobians through the Jacobian operators
    jacobian_operators(args, card)
    out['bdf'] = bdf_forecaster(args, card, launches, work, m, g,
                                out['rbf']['max_batch'])

    # bf16 against f32
    t0 = time.perf_counter()
    bfc = serving.export_forecaster(m, None, g, T=T, L=L,
                                    normalize_input=True, dtype='bf16',
                                    device='cuda')
    bexport_s = time.perf_counter() - t0
    bpath = os.path.join(work, 'rbf_bf16.pt2')
    bbytes = serving.save_forecaster(bfc, bpath)
    bart = serving.load_forecaster(bpath)
    bart(raw[0], 0)
    bframes, bd = serve('bf16 RBF euler', bart, rbf_k, 1, T)
    noise = noise_for(bart, args.seed + 7)
    yb = bart.call(raw[1], noise)
    diff = float((yb - art.call(raw[1], noise)).abs().max())
    require(yb.dtype == torch.float32 and 0.0 < diff < BF16_FRAMES,
            f'bf16 against f32 artifact: {diff:.3e}')
    bms = turns({'bf16 artifact': bart, 'f32 artifact': art}, raw[1],
                args.seed)
    bbusy = {k: profile(lambda f=f: f(raw[1], args.seed),
                        f'one RBF euler request, {k}')
             for k, f in (('bf16 artifact', bart), ('f32 artifact', art))}
    out['bf16'] = dict(export_s=bexport_s, nbytes=bbytes, diff=diff, ms=bms,
                       busy=bbusy)
    log(f'artifact bf16 RBF euler T={T}: exported in {bexport_s:.2f} s, '
        f'{bbytes} bytes; launches per request {bd}; frames against the '
        f'f32 artifact at the same noise {diff:.3e} (0 < diff < '
        f'{BF16_FRAMES:g}); request ms (median of 5 in turns) '
        + ', '.join(f'{k} {v:.4f}' for k, v in bms.items()) + '; busy '
        + ', '.join(f'{k} {v[0]:.4f} ms (idle share {v[1]:.3f})'
                    for k, v in bbusy.items() if v) + f'; card {card}')
    log(f'phase 6h launches on its paths (counts set to 0 before each): '
        f'{ {k: v for k, v in launches.items() if v} }')
    return out


# -- 6i: plots, summaries, the native rotation, data parallelism ------------

#: what main.py writes beside its figures (final_plots' loss traces)
TRACE_NPY = ['elbo.npy', 'inducingkl.npy', 'nll.npy', 'zkl.npy']
#: the figures of main.py's run directory (order 1), main_vae's and
#: evaluate's (JAX main.py, main_vae.py and evaluate.py)
RUN_PNG = ['plots/data.png', 'plots/dynamics_test_state.png',
           'plots/dynamics_train_state.png', 'plots/hyperparams.png',
           'plots/optimization_trace.png', 'plots/rollout.png',
           'plots/rollout_original.png', 'plots/rot_mnist.png']
VAE_PNG = ['plots/vae_trace.png', 'vae_embeddings_pca.png',
           'vae_embeddings_tsne.png', 'vae_reconstructions.png']
EVAL_PNG = ['eval/rollout.png', 'eval/rollout_original.png']
#: the ranks of the data-parallel check on one card (gloo)
DP_WORLD = 2


def run_files(root):
    """(PNG, .npy) files under `root`, relative paths, sorted."""
    found = {'.png': [], '.npy': []}
    for d, _, fs in os.walk(root):
        for f in fs:
            ext = os.path.splitext(f)[1]
            if ext in found:
                found[ext].append(os.path.relpath(os.path.join(d, f), root))
    return sorted(found['.png']), sorted(found['.npy'])


def left_out_line(log_path):
    """The run log's line naming the figures left out, or None."""
    with open(log_path) as f:
        lines = [ln.strip() for ln in f if 'figures left out' in ln]
    require(len(lines) <= 1, f'{log_path}: {len(lines)} left-out lines')
    return lines[0] if lines else None


def check_figures(what, root, pngs, log_path):
    """The figures `pngs` under `root` were written where matplotlib
    imports; else none was and the log names them in one line."""
    from vae_gp_ode_tpu_torch.utils import plotting
    got, npys = run_files(root)
    got = [f for f in got if f in pngs]
    line = left_out_line(log_path)
    if plotting.available():
        require(got == sorted(pngs) and line is None,
                f'{what}: PNGs {got}, left-out line {line}')
    else:
        require(got == [] and line is not None and all(
            os.path.basename(f) in line for f in pngs),
            f'{what}: PNGs {got}, left-out line {line}')
    log(f'  {what}: PNGs written {got or "none"}; .npy files {npys}'
        + (f'; log: {line[line.index("matplotlib"):]}' if line else ''))
    return npys


def relu_rows(ref, lo, hi, L_, N):
    """A single-device step's ReLU inputs (by module name) at the rows of
    a rank that trains on sequences lo:hi: the encoder's rows, and the
    decoder's frames (L, N, T) of those sequences."""
    out = {}
    for name, x in ref.items():
        if name.startswith('decoder'):
            y = x.reshape((L_, N, -1) + tuple(x.shape[1:]))[:, lo:hi]
            out[name] = y.reshape((-1,) + tuple(x.shape[1:]))
        else:
            out[name] = x[lo:hi]
    return out


def dp_model(seed, kernel):
    """The data-parallel check's model and GP: main.py's defaults
    (CONFIG) with `kernel`, drawn from the numpy seed, on the card."""
    from vae_gp_ode_tpu_torch.models.odegpvae import init_model
    return init_model(seed, device='cuda', kernel=kernel, **CONFIG)


def dp_step(model, gp, batch, noise_np, L_, relu_ref, ndata):
    """One per-rank train step (`parallel.shard_dp`) of copies of model
    and gp over `batch` (this rank's rows of it) with the global noise,
    each ReLU on the branch of the single-device reference run whose
    inputs `relu_ref` holds (RELU_FLIP). Returns (loss, the averaged
    gradients by name as f32 on the CPU, the step's launches, the ReLU
    units on which this run's own inputs take the other branch and the
    largest relative |reference input| among them)."""
    import torch
    from torch import nn
    from vae_gp_ode_tpu_torch import ops
    from vae_gp_ode_tpu_torch.parallel import make_shardmap_train_step
    from vae_gp_ode_tpu_torch.parallel.shard_dp import rank_rows
    from vae_gp_ode_tpu_torch.training import trainer
    lo, hi = rank_rows(batch.shape[0])
    pin = relu_rows(relu_ref, lo, hi, L_, batch.shape[0])
    own = {}
    state = trainer.create_train_state(copy.deepcopy(model),
                                       copy.deepcopy(gp))

    def hook(name, x):
        own[name] = x.detach().to('cpu', torch.float64)
        return x * (pin[name] > 0).to(x.device, x.dtype)

    for name, mod in state.model.named_modules():
        if isinstance(mod, nn.ReLU):
            mod.register_forward_hook(
                lambda mod, inp, out, name=name: hook(name, inp[0]))
    noise = {k: torch.as_tensor(v, dtype=torch.float32, device=batch.device)
             for k, v in noise_np.items()}
    step = make_shardmap_train_step(ndata, eps_guard=True)
    torch.cuda.synchronize()
    before = dict(ops.LAUNCHES)
    m = step(state, batch, L_, noise=noise)
    torch.cuda.synchronize()
    launched = deltas(before, dict(ops.LAUNCHES))
    grads = {n: p.grad.float().cpu() for n, p in zip(state.param_names(),
                                                    state.params())}
    return (float(m['loss']), grads, launched) + relu_flips(own, pin)


def dp_jobs(args, batch, ndata):
    """The data-parallel check's cases: per kernel, the single-device
    step's loss, gradients and ReLU inputs on the card (the reference),
    and what a rank needs to rebuild the same step."""
    import numpy as np
    q, S, M = CONFIG['latent_dim'], CONFIG['num_features'], \
        CONFIG['num_inducing']
    jobs = []
    for i, kernel in enumerate(('RBF', 'DF')):
        seed = args.seed + 60 + i
        model, gp = dp_model(seed, kernel)
        noise = step_noise(seed, q, S, M, L_=1, batch=batch.shape[0],
                           df=kernel == 'DF')
        relu = {}
        loss, _, _, grads = step_grads(model, gp, batch, noise, ndata, True,
                                       'cuda', 1, relu_in=relu)
        jobs.append({'kernel': kernel, 'seed': seed, 'noise': noise,
                     'batch': batch.cpu().numpy(), 'ndata': ndata,
                     'relu': {k: v.numpy() for k, v in relu.items()},
                     'ref': (float(loss), grads), 'model': model, 'gp': gp})
    return jobs


def hold_dp(what, job, loss, grads, launched, flips, flip_at):
    """Hold one rank's step against the single-device step: loss 1e-4
    relative, every averaged gradient within TOL_GRAD of its leaf's
    largest (biases before a BatchNorm: of their weight's), every ReLU
    unit on the other branch within RELU_FLIP of 0, and the fused pair of
    the kernel (#1/#2 or #7/#8) launched once each and nothing else."""
    import torch
    from vae_gp_ode_tpu_torch.ops import df_flow_fused, flow_fused
    ref_loss, ref_grads = job['ref']
    mod = flow_fused if job['kernel'] == 'RBF' else df_flow_fused
    worst, name = worst_grad_error(
        {k: torch.as_tensor(v) for k, v in grads.items()}, ref_grads,
        job['model'])
    rel = abs(loss - ref_loss) / abs(ref_loss)
    others = {k: v for k, v in launched.items()
              if v and k not in (mod.KERNEL, mod.BWD_KERNEL)}
    log(f'  {what} ({job["kernel"]}): loss {loss:.6f} vs {ref_loss:.6f} '
        f'(rel {rel:.2e}); gradients max |err| / max |ref| {worst:.3e} at '
        f'{name} (tol {TOL_GRAD:g}); ReLU units on the other branch {flips}, '
        f'largest |input| {flip_at:.2e} (tol {RELU_FLIP:g}); launches '
        f'{ {k: v for k, v in launched.items() if v} }')
    require(rel <= 1e-4 and worst <= TOL_GRAD and flip_at <= RELU_FLIP,
            f'{what} ({job["kernel"]}): the step disagrees with the '
            f'single-device one')
    require(launched[mod.KERNEL] == 1 and launched[mod.BWD_KERNEL] == 1
            and not others, f'{what} ({job["kernel"]}) launched {launched}')


def dp_worker(init, world, rank, job_path):
    """One rank of phase 6i's gloo check on cuda:0 (chip_smoke.py
    --dp-worker INIT WORLD RANK JOBS): the per-rank step of each job, held
    by the parent, and the step's wall ms (median of 5, host clock around
    the step and a synchronize: gloo's all-reduces pass through the
    host)."""
    import pickle
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vae_gp_ode_tpu_torch.parallel import make_shardmap_train_step
    from vae_gp_ode_tpu_torch.training import trainer
    torch.cuda.set_device(0)
    dist.init_process_group('gloo', init_method=init, world_size=world,
                            rank=rank)
    with open(job_path, 'rb') as f:
        jobs = pickle.load(f)
    out = []
    try:
        for job in jobs:
            model, gp = dp_model(job['seed'], job['kernel'])
            batch = torch.as_tensor(job['batch'], device='cuda')
            relu = {k: torch.as_tensor(v) for k, v in job['relu'].items()}
            loss, grads, launched, flips, flip_at = dp_step(
                model, gp, batch, job['noise'], 1, relu, job['ndata'])
            state = trainer.create_train_state(model, gp)
            step = make_shardmap_train_step(job['ndata'], eps_guard=True)
            gen = torch.Generator(device='cuda').manual_seed(job['seed'])
            times = []
            for i in range(7):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(state, batch, L, gen)
                torch.cuda.synchronize()
                if i >= 2:
                    times.append((time.perf_counter() - t0) * 1e3)
            out.append({'loss': loss, 'grads': {k: v.numpy() for k, v in
                                                grads.items()},
                        'launched': launched, 'flips': (flips, flip_at),
                        'ms': statistics.median(times)})
    finally:
        dist.destroy_process_group()
    with open(f'{job_path}.rank{rank}', 'wb') as f:
        pickle.dump(out, f)
    return 0


def plots_native_parallel(args, card, batch, run6, launches):
    """Phase 6i (the last slice): the run directory of phase 6's run()
    (main.py for 2 epochs with its figures), final_plots' trajectories and
    rollout on the card against the CPU path at the same noise, main_vae
    and evaluate with their figures, the native rotation library built and
    held to scipy, the model summaries, and the per-rank data-parallel
    step on the card: at world size 1 over NCCL in this process and over
    DP_WORLD ranks of gloo on cuda:0 in subprocesses, each against the
    single-device step at the same noise, then main.py --data_parallel
    True at world size 1. Each path's launches are counted with the
    counts set to 0 just before it."""
    import pickle
    import numpy as np
    import torch
    import torch.distributed as dist
    from vae_gp_ode_tpu_torch import evaluate, main as train_cli, main_vae
    from vae_gp_ode_tpu_torch import native
    from vae_gp_ode_tpu_torch.ops import flow_fused
    from vae_gp_ode_tpu_torch.parallel import make_shardmap_train_step
    from vae_gp_ode_tpu_torch.training import trainer
    from vae_gp_ode_tpu_torch.utils.summary import param_count, summarize
    run_path = functools.partial(count_path, launches=launches)
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                        'chip_smoke', '6i')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    q, S, M = CONFIG['latent_dim'], CONFIG['num_features'], \
        CONFIG['num_inducing']
    log('phase 6i: plots, the native rotation and data parallelism')

    # -- the training run's figures (phase 6's run of main.py) ------------
    save = run6['save']
    npys = check_figures('main.py, 2 epochs', save, RUN_PNG,
                         os.path.join(save, 'logs'))
    require(all(f in npys for f in TRACE_NPY), f'main.py .npy: {npys}')
    for f in TRACE_NPY:
        vals = np.load(os.path.join(save, f))
        require(vals.shape == (36,) and np.isfinite(vals).all(),
                f'{f}: {vals.shape}')
    plots = run6['plots']
    require(plots['dynamics_train'].shape == (1, BATCH, T, q) and
            plots['rollout'].shape == (1, 3, TROLL * T, 1, 28, 28) and all(
                np.isfinite(v).all() for v in plots.values()),
            f'final_plots {[v.shape for v in plots.values()]}')
    with open(os.path.join(save, 'logs')) as f:
        text = f.read()
    require('--- vae params ---' in text and '--- gp params ---' in text,
            'main.py logged no model summary')
    state = run6['state']
    log(f'  summaries: VAE {param_count(state.model)} parameters, GP '
        f'{param_count(state.gp)}; ' + summarize(state.gp, 'gp params')
        .splitlines()[-1].split()[-1] + ' GP total in the table')

    # final_plots' latent trajectories and rollout, card vs CPU
    cpu = dataclasses.replace(state, model=copy.deepcopy(state.model).cpu(),
                              gp=state.gp.to('cpu'))
    noise = step_noise(args.seed + 50, q, S, M, L_=1, batch=BATCH)
    roll_noise = dict(noise, z0=noise['z0'][:3])
    roll = trainer.make_eval_step(T_custom=TROLL * T)
    errs = []
    for what, fn in (
            ('latent trajectories', lambda st, X, nz: train_cli
             .latent_trajectories(st, X, noise=nz)),
            (f'T={TROLL * T} rollout', lambda st, X, nz: roll(
                st, X[:3], 1, noise=nz)[0])):
        nz_np = noise if what.startswith('latent') else roll_noise
        got, d = run_path(lambda: fn(state, batch, {
            k: torch.as_tensor(v, dtype=torch.float32, device=batch.device)
            for k, v in nz_np.items()}))
        ref = fn(cpu, batch.cpu(), {k: torch.as_tensor(
            v, dtype=torch.float32) for k, v in nz_np.items()})
        err = float((got.cpu() - ref).abs().max())
        errs.append(err)
        require(d[flow_fused.KERNEL] == 1 and sum(d.values()) == 1,
                f'final_plots {what} launched {d}')
        log(f'  final_plots {what} {tuple(got.shape)}: card vs CPU with the '
            f'same noise, max abs err {err:.3e} (tol {TOL_FORWARD:g}); '
            f'launched {flow_fused.KERNEL} once')
        require(err <= TOL_FORWARD, f'final_plots {what}: card vs CPU')
    del cpu

    # -- main_vae and evaluate with their figures --------------------------
    vargs = main_vae.make_parser().parse_args([
        '--vae_epochs', '1', '--output_path', os.path.join(work, 'vae'),
        '--save', os.path.join(work, 'frames')])
    t0 = time.perf_counter()
    res, d = run_path(lambda: main_vae.run(vargs))
    require(np.isfinite(res['test_mse']) and not any(d.values()),
            f'main_vae: mse {res["test_mse"]}, launches {d}')
    require(res['embeddings'][0].shape == (1024, q),
            f'embeddings {res["embeddings"][0].shape}')
    log(f'  main_vae, 1 epoch at its defaults: {time.perf_counter() - t0:.1f}'
        f' s, reconstruction MSE {res["test_mse"]:.4f}, embeddings of '
        f'{res["embeddings"][0].shape[0]} test frames')
    check_figures('main_vae', res['output_path'], VAE_PNG,
                  os.path.join(res['output_path'], 'logs'))
    eval_log = os.path.join(work, 'evaluate.log')
    handler = logging.FileHandler(eval_log)
    logging.getLogger(evaluate.logger.name).addHandler(handler)
    try:
        res, d = run_path(lambda: evaluate.evaluate_one(
            evaluate.make_parser().parse_args(['--model_path', save]), save))
    finally:
        logging.getLogger(evaluate.logger.name).removeHandler(handler)
        handler.close()
    require(np.isfinite(res['mse_mean']) and d[flow_fused.KERNEL] == 3,
            f'evaluate: {res}, launches {d}')
    npys = check_figures('evaluate', save, EVAL_PNG, eval_log)
    require('eval/rollout.npy' in npys and 'eval/rollout_original.npy' in
            npys, f'evaluate .npy: {npys}')

    # -- the native rotation library ----------------------------------------
    from scipy.ndimage import rotate as nd_rotate
    t0 = time.perf_counter()
    require(native.native_available(), 'the native rotation library did '
            'not build on the card\'s machine')
    built = time.perf_counter() - t0
    img = np.random.default_rng(args.seed).random((28, 28)).astype(
        np.float32)
    angles = (0.0, 22.5, 90.0, 135.7, 270.0, -60.0)
    rot_err = max(float(np.abs(native.rotate_bilinear(img, a) - np.clip(
        nd_rotate(img, a, reshape=False, order=1), 0, 1)).max())
        for a in angles)
    seqs = native.make_rot_sequences(img[None], 8)
    seq_err = max(float(np.abs(seqs[0, t] - np.clip(nd_rotate(
        img, 45.0 * t, reshape=False, order=1), 0, 1)).max())
        for t in range(8))
    log(f'  native rotation: built and loaded in {built:.2f} s '
        f'({os.path.basename(native.build.library_path())}); against scipy '
        f'max abs err {rot_err:.2e} at {len(angles)} angles, {seq_err:.2e} '
        f'over an 8-frame sequence (tol 1e-5)')
    require(rot_err <= 1e-5 and seq_err <= 1e-5, 'native rotation vs scipy')

    # -- data parallelism ----------------------------------------------------
    jobs = dp_jobs(args, batch, 360.0)
    dist.init_process_group('nccl', init_method='file://' + os.path.join(
        work, 'nccl'), world_size=1, rank=0,
        device_id=torch.device('cuda', 0))
    dp_ms = {}
    try:
        for job in jobs:
            res, d = run_path(lambda: dp_step(
                job['model'], job['gp'], batch, job['noise'], 1,
                {k: torch.as_tensor(v) for k, v in job['relu'].items()},
                job['ndata']))
            hold_dp('world size 1, NCCL', job, *res)
        model, gp = dp_model(args.seed + 60, 'RBF')
        st = trainer.create_train_state(model, gp)
        step = make_shardmap_train_step(360.0, eps_guard=True)
        single = trainer.make_train_step(360.0, eps_guard=True)
        st1 = trainer.create_train_state(*dp_model(args.seed + 60, 'RBF'))
        gen = torch.Generator(device='cuda').manual_seed(args.seed)
        for name, fn in (('per-rank (NCCL, world size 1)',
                          lambda: step(st, batch, L, gen)),
                         ('single-device', lambda: single(st1, batch, L,
                                                          gen))):
            ms = cuda_ms(fn, 20)
            prof = profile(fn, f'one {name} L={L} train step')
            dp_ms[name] = f'{ms:.3f} ms, ' + (
                f'busy {prof[0]:.3f} ms, idle share {prof[1]:.3f}' if prof
                else 'busy not measured')
    finally:
        dist.destroy_process_group()
    log(f'  train step, L={L}, batch {BATCH} (CUDA events over 20 steps; '
        f'busy ms and idle share from torch.profiler): ' + '; '.join(
            f'{k} {v}' for k, v in dp_ms.items()) + f'; card {card}')

    job_path = os.path.join(work, 'dp_jobs.pkl')
    with open(job_path, 'wb') as f:
        pickle.dump([{k: v for k, v in j.items()
                      if k not in ('ref', 'model', 'gp')} for j in jobs], f)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--dp-worker',
         'file://' + os.path.join(work, 'gloo'), str(DP_WORLD), str(r),
         job_path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(DP_WORLD)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, f'data-parallel rank {r} failed:\n'
                f'{out[-3000:]}')
    log(f'  {DP_WORLD} ranks of gloo on cuda:0 (subprocesses): '
        f'{time.perf_counter() - t0:.1f} s wall, start-up included')
    for r in range(DP_WORLD):
        with open(f'{job_path}.rank{r}', 'rb') as f:
            res = pickle.load(f)
        for job, out in zip(jobs, res):
            hold_dp(f'rank {r} of {DP_WORLD}, gloo', job, out['loss'],
                    out['grads'], out['launched'], *out['flips'])
            for k, v in out['launched'].items():
                launches[k] += v
            log(f'    rank {r} ({job["kernel"]}): L={L} step {out["ms"]:.3f}'
                f' ms wall (median of 5, host clock); card {card}')

    # main.py --data_parallel True at world size 1: the single-device path
    steps, seen = [], {}

    def on_step(ep, L_):
        from vae_gp_ode_tpu_torch import ops
        now = dict(ops.LAUNCHES)
        steps.append((ep, L_, deltas(seen, now)))
        seen.update(now)

    t0 = time.perf_counter()
    res, d = run_path(lambda: train_cli.run(train_args(
        os.path.join(work, 'dp1'), '--data_parallel', 'True'),
        on_step=on_step))
    require(res['bailout'] is None and res['parallel'] == (1, 0, None) and
            len(steps) == 36, f'--data_parallel True: {res["parallel"]}, '
            f'{len(steps)} steps')
    for i, (ep, L_, dd) in enumerate(steps):
        evals = 1 if i % 18 == 0 and ep > 0 else 0
        require(dd[flow_fused.BWD_KERNEL] == 1 and dd[flow_fused.KERNEL] ==
                1 + evals and not any(v for k, v in dd.items()
                                      if not k.startswith('flow_fused')),
                f'--data_parallel True step {i} launched {dd}')
    log(f'  main.py --data_parallel True at world size 1: the single-device '
        f'path, {len(steps)} steps in {time.perf_counter() - t0:.1f} s, '
        f'every step launched {flow_fused.KERNEL} and '
        f'{flow_fused.BWD_KERNEL} once; launches {d}')
    log(f'phase 6i launches on its paths (counts set to 0 before each): '
        f'{ {k: v for k, v in launches.items() if v} }')
    return dp_ms


def train_args(save, *extra):
    """The training CLI's arguments at the defaults of main.py, for
    TRAIN_EPOCHS epochs, writing under `save`, with `extra` flags."""
    from vae_gp_ode_tpu_torch.main import make_parser
    return make_parser().parse_args([
        '--Nepoch', str(TRAIN_EPOCHS), '--save', save, '--device', 'cuda',
        *extra])


def main():
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--dp-worker', nargs=4, default=None,
                    metavar=('INIT', 'WORLD', 'RANK', 'JOBS'),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dp_worker:
        init, world, rank, jobs = args.dp_worker
        return dp_worker(init, int(world), int(rank), jobs)

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
    from vae_gp_ode_tpu_torch.ops import (
        _build, df_flow_fused, df_pathwise, df_pathwise_tiled, flow_fused,
        pathwise, pathwise_tiled)
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
    sources = ['flow_fused', 'flow_fused_bwd', 'pathwise_fwd', 'pathwise_bwd',
               'df_pathwise_fwd', 'df_pathwise_bwd', 'df_flow_fused',
               'df_flow_fused_bwd', 'pathwise_tiled_fwd',
               'pathwise_tiled_bwd', 'df_pathwise_tiled_fwd',
               'df_pathwise_tiled_bwd']
    _build.build(sources)
    flow_fused._lib()
    flow_fused._bwd_lib()
    pathwise._lib()
    pathwise._bwd_lib()
    df_pathwise._lib()
    df_pathwise._bwd_lib()
    df_flow_fused._lib()
    df_flow_fused._bwd_lib()
    pathwise_tiled._lib()
    pathwise_tiled._bwd_lib()
    df_pathwise_tiled._lib()
    df_pathwise_tiled._bwd_lib()
    log(f'build: {time.perf_counter() - t0:.1f} s')
    # registers and spills of every kernel instance (nvcc -Xptxas -v); the
    # tiled DF pair (#11/#12) and the RBF kernels #3, #4, #9 and #10 keep
    # their per-thread arrays in registers
    for name in sources:
        for sym, (regs, st, ld) in sorted(_build.ptxas_usage(name).items()):
            log(f'ptxas {name}: {sym}: {regs} registers, spill stores {st} '
                f'bytes, spill loads {ld} bytes')
            # the tiled DF pair's kernels (their wide ones for D above 16
            # too: per-thread arrays of a fixed 8 output dims) and the
            # per-step RBF kernels
            if name.startswith('df_pathwise_tiled') or name in (
                    'pathwise_fwd', 'pathwise_bwd', 'pathwise_tiled_fwd',
                    'pathwise_tiled_bwd'):
                require(st == 0 and ld == 0, f'{sym} spills registers')

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
    M_fl = CONFIG['num_inducing']
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    gp2 = init_svgp_params(rng, 2 * q, q, M_fl,
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
            again = flow_fused.packed_euler_flow(z0, *packed, dts, T_,
                                                 order)
            ref = flow_fused.packed_flow_reference(z0, *packed, dts, T_,
                                                   order)
            torch.cuda.synchronize()
            require(out.shape == (L, T_, N_, D_), f'shape {out.shape}')
            cases.append(compare(out, ref, name))
            require(torch.equal(out, again), f'{name}: two launches of '
                    f'flow_fused_fwd gave different bits')
            plan = flow_fused.fwd_plan(L, N_, D_, q, S, M_fl, order, dev)
            log(f'  same bits twice; plan (rows, blocks per cluster, row '
                f'tiles) {plan}')
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
        again = torch.autograd.grad(flow_fused.packed_euler_flow(
            *inputs, T, order), inputs, zsbar)
        require(all(torch.equal(a, b) for a, b in zip(out, again)),
                f'{name}: two launches of flow_fused_bwd and its summing '
                f'kernel gave different bits')
        zs4 = zs.detach().reshape((-1, T, N_, D_))
        ref = list(flow_fused.packed_flow_vjp_reference(
            zs4, zsbar.reshape(zs4.shape), *packed, dts, T, order))
        if not z0_per_draw:
            ref[0] = ref[0].sum(0)
        torch.cuda.synchronize()
        bwd_cases.append(compare_bwd(out, ref, name))
        log(f'  same bits twice; plan (rows, blocks per cluster, row tiles) '
            f'{flow_fused.bwd_plan(L_, N_, D_, q, S, M_fl, order, dev)}')
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
    PATH_SHAPES.update(ops.SHAPES)
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
    PATH_SHAPES.update(ops.SHAPES)
    train_s = time.perf_counter() - t0
    if result['bailout'] is not None:
        raise AssertionError(f'NaN bailout at epoch {result["bailout"]}')
    per_epoch = targs.Ndata // targs.batch + bool(targs.Ndata % targs.batch)
    require(len(steps) == TRAIN_EPOCHS * per_epoch, f'{len(steps)} steps')
    for i, (ep, L_, d) in enumerate(steps):
        # the first step of a later epoch also counts the previous
        # epoch's monitoring eval (one forward launch)
        evals = 1 if i % per_epoch == 0 and ep > 0 else 0
        if d[flow_fused.BWD_KERNEL] != 1 or d[flow_fused.KERNEL] != (
                1 + evals) or any(v for k, v in d.items()
                                  if not k.startswith('flow_fused')):
            raise AssertionError(f'train step {i} (epoch {ep}, L={L_}) '
                                 f'launched {d}')
    require([L_ for _, L_, _ in steps] == [1] * per_epoch + [L] * per_epoch,
            'the L schedule is not L=1 then L=5')
    losses = np.concatenate([e['loss'] for e in result['epochs']])
    require(len(result['epochs']) == TRAIN_EPOCHS and losses.size == len(
        steps) and np.isfinite(losses).all(), f'losses {losses}')
    mses = [float(e['mse']) for e in result['epochs']]
    require(np.isfinite(mses).all(), f'monitoring mse {mses}')
    # after the steps and evals, final_plots' two latent trajectories and
    # rollout launch the trajectory kernel once each
    require(train_launches[flow_fused.KERNEL] == len(steps) + TRAIN_EPOCHS
            + 3, f'run() launched {train_launches}')
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

    # one step's gradients on the GPU against the port's CPU step (f64)
    check_grads('GPU vs CPU (float64) train-step gradients (L=1, same '
                'noise)', pinned_grads(
                    state.model, state.gp, batch,
                    step_noise(args.seed + 3, q, S, targs.num_inducing),
                    targs.Ndata, targs.eps_guard, ('cuda', None),
                    ('cpu', torch.float64)))

    # -- 6b. this slice: the per-step kernels and the solvers -------------
    slice_launches = {k: 0 for k in ops.LAUNCHES}
    path = solver_paths(args, card, batch, targs, slice_launches)

    # -- 6c. the divergence-free kernel: kernels #5-#8 -----------------------
    df_launches = {k: 0 for k in ops.LAUNCHES}
    dfp = df_paths(args, card, batch, df_launches)

    # -- 6d. the wide shapes: kernels #9-#12 and the dispatch rule ----------
    wide_launches = {k: 0 for k in ops.LAUNCHES}
    kern = wide_kernels(args, card)
    wide = wide_paths(args, card, wide_launches, kern)

    # -- 6e. DF above state dim 16: the tiled pair's wide kernels -----------
    dfw_launches = {k: 0 for k in ops.LAUNCHES}
    dfw = df_wide_state(args, card, batch, dfw_launches)

    # -- 6f. the pretrained workflow: main_vae, --pretrained, evaluate ------
    pre_launches = {k: 0 for k in ops.LAUNCHES}
    vae_dir = pretrained_workflow(args, card, pre_launches)

    # -- 6g. the shared-lengthscale RBF kernel and multi-epoch segments -----
    shared_launches = {k: 0 for k in ops.LAUNCHES}
    shared = shared_rbf(args, card, batch, shared_launches, vae_dir)

    # -- 6h. the serving artifact: torch.export forecasters on the card ----
    art_launches = {k: 0 for k in ops.LAUNCHES}
    serving_artifacts(args, card, art_launches)

    # -- 6i. plots, the native rotation and data parallelism ---------------
    dp_launches = {k: 0 for k in ops.LAUNCHES}
    plots_native_parallel(args, card, batch, result, dp_launches)

    # -- 7. timings --------------------------------------------------------
    with torch.no_grad():
        ms_kernel = cuda_ms(
            lambda: flow_fused.packed_euler_flow(*main_operands), 200)
        ms_plain = cuda_ms(
            lambda: flow_fused.packed_flow_reference(*main_operands), 50)
        # #1's wrapper by route (`eager_route`), in turns, medians of 5
        ms_route = {r: [] for r in ROUTES}
        for _ in range(5):
            for r in ROUTES + ROUTES[::-1]:
                ms_route[r].append(cuda_ms(routed(
                    lambda: flow_fused.packed_euler_flow(*main_operands),
                    r), 100))
    log('flow_fused_fwd wrapper by route (mean of 100 calls, median of 5 '
        'in turns): ' + ', '.join(f'{r} {statistics.median(v):.4f} ms'
                                  for r, v in ms_route.items())
        + f'; card {card}')
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
            f'{ms_b:.4f} ms (the adjoint and its summing kernel), plain '
            f'version '
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
    profile(path['rk4_profile'], f'one L={L} rk4 train step')
    profile(dfp['request_profile'], 'one DF T=16 request')
    profile(dfp['step_profile'], f'one DF L={L} train step')
    profile(dfp['step1_profile'], 'one DF L=1 train step')
    profile(dfp['rk4_profile'], f'one DF L={L} rk4 train step')
    for kernel, fn_step in wide['profiles'].items():
        profile(fn_step, f'one wide (q=12, S=1024) {kernel} L={L} train step')

    ms_b, ms_bp, bound_b, by_b = bwd_ms[L]
    kf, pf, bf, kb, pb, bb = path['pathwise_ms'][L]
    # launches: each path run's, counts set to 0 just before it
    runs = (serve_launches, train_launches, slice_launches, df_launches,
            wide_launches, dfw_launches, pre_launches, shared_launches,
            art_launches, dp_launches)
    total = {k: sum(d[k] for d in runs) for k in ops.LAUNCHES}
    # #3-#6: the largest error of phases 6b/6c and of 6d's sweep shapes
    errs = kern['errs']
    # 6g's shared-operand checks join the RBF kernels' errors
    serr = shared['errs']
    timed = {  # name: (ms, plain ms, (bound ms, bound by), max abs err)
        flow_fused.KERNEL: (ms_kernel, ms_plain, (bound_ms, bound_by),
                            max(max_abs_err, *serr['flow_fwd'])),
        flow_fused.BWD_KERNEL: (ms_b, ms_bp, (bound_b, by_b),
                                max(bwd_max_abs_err, *serr['flow_bwd'])),
        pathwise.KERNEL: (kf, pf, bf, max(path['pathwise_err'][0],
                                          *errs['rbf_single_fwd'],
                                          *serr['step_fwd'])),
        pathwise.BWD_KERNEL: (kb, pb, bb, max(path['pathwise_err'][1],
                                              *errs['rbf_single_bwd'],
                                              *serr['step_bwd']))}
    for mod, bwd, err in ((df_pathwise, False, max(
                              dfp['pathwise_err'][0], *errs['df_single_fwd'])),
                          (df_pathwise, True, max(
                              dfp['pathwise_err'][1], *errs['df_single_bwd'])),
                          (df_flow_fused, False, dfp['flow_err'][0]),
                          (df_flow_fused, True, dfp['flow_err'][1])):
        name = mod.BWD_KERNEL if bwd else mod.KERNEL
        timed[name] = dfp['kernel_ms'][L][name] + (err,)
    for mod, fam in ((pathwise_tiled, 'rbf'), (df_pathwise_tiled, 'df')):
        wider = dfw if fam == 'df' else {'fwd': serr['tiled_fwd'],
                                         'bwd': serr['tiled_bwd']}
        timed[mod.KERNEL] = wide['kernel_ms'][mod.KERNEL] + (
            max(errs[fam + '_fwd'] + wider['fwd']),)
        timed[mod.BWD_KERNEL] = wide['kernel_ms'][mod.BWD_KERNEL] + (
            max(errs[fam + '_bwd'] + wider['bwd']),)
    entries = []
    for mod in (flow_fused, pathwise, df_pathwise, df_flow_fused,
                pathwise_tiled, df_pathwise_tiled):
        for name, source, replaces in (
                (mod.KERNEL, mod.SOURCE, mod.REPLACES),
                (mod.BWD_KERNEL, mod.BWD_SOURCE, mod.BWD_REPLACES)):
            require(total[name] > 0, f'{name} was never launched on the '
                                     f'paths of chip_smoke.py')
            k_ms, p_ms, (b_ms, b_by), err = timed[name]
            entries.append({
                'name': name, 'route': 'cuda', 'source': source,
                'replaces': replaces, 'launches': total[name],
                'max_abs_err': err, 'ms': k_ms, 'plain_ms': p_ms,
                'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None})
    require(len(entries) == 12, f'{len(entries)} kernels')
    # device time per launch at the shapes each kernel was timed at
    calls = {flow_fused.KERNEL: lambda: flow_fused.packed_euler_flow(
                 *main_operands),
             flow_fused.BWD_KERNEL: lambda: flow_fused.packed_flow_vjp(
                 *bwd_operands[L])}
    for part in (path, dfp, wide):
        calls.update(part['calls'])
    dev_us = {}
    for name, fn_k in calls.items():
        dev_us.update(device_us(fn_k, [name]))
    floor = floor_us()
    log('device time per launch of an empty kernel (pathwise_fwd_empty, '
        'the floor under every kernel\'s device time; torch.profiler over '
        '10 launches): ' + (f'{floor:.2f} us' if floor is not None else
                            'not measured') + f'; card {card}')
    log('device time per launch at the timed shapes (torch.profiler over '
        '10 calls; L=5, the main widths for #1-#8, the wide ones for '
        '#9-#12; a library\'s second kernel apart): ' + ', '.join(
            f'{k} {per_launch(v)}' for k, v in dev_us.items())
        + f'; card {card}')
    per_shape_split(card)
    log(json.dumps({'kernels': entries}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == '__main__':
    sys.exit(main())
