#!/usr/bin/env python3
"""Where the port's f32 train-step gradients leave float64, on one GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 grad_precision_probe.py

At 20 (state, noise) pairs of the default configuration (the initial
states of seeds 7 and 0 with rk4 and euler, and the states after
`chip_smoke.py`'s 2-epoch training run with euler and rk4 at seeds 0-2;
the step noise of seeds 3 and 7), it computes one train step's gradients
on the GPU in f32 (with cuDNN's default algorithms, with its
deterministic ones, and without cuDNN), on the CPU in f32, and on the
CPU in float64 twice: on its own ReLU branches and on the GPU run's
(chip_smoke.RELU_FLIP). Each printed JSON line gives, per pair, the
worst leaf's max error relative to its largest entry, and its leaf, for
each f32 step against the float64 references, and the count of ReLU
units whose branch each f32 run's input disagrees with float64 on, with
the largest float64 input among them relative to its layer's largest.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402
from vae_gp_ode_tpu_torch import main as train_cli  # noqa: E402
from vae_gp_ode_tpu_torch.data.mnist import load_data  # noqa: E402
from vae_gp_ode_tpu_torch.models.odegpvae import init_model  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print('grad_precision_probe: needs a GPU', file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), torch.__version__, flush=True)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                        'grad_precision_probe')
    targs = cs.train_args(os.path.join(root, 'data'))
    batch = load_data(targs, device='cuda')[1].first()
    states = []
    for seed in (7, 0):
        for solver in ('rk4', 'euler'):
            states.append((f'initial, seed {seed}, {solver}', *init_model(
                seed, device='cuda', **dict(cs.CONFIG, solver=solver))))
    for seed in range(3):
        for solver in ('euler', 'rk4'):
            st = train_cli.run(cs.train_args(
                os.path.join(root, f'{solver}{seed}'), '--solver', solver,
                '--seed', str(seed)))['state']
            states.append((f'trained, seed {seed}, {solver}', st.model,
                           st.gp))
    q, S, M = (cs.CONFIG[k] for k in ('latent_dim', 'num_features',
                                      'num_inducing'))
    for name, model, gp in states:
        for nseed in (3, 7):
            args = (model, gp, batch, cs.step_noise(nseed, q, S, M),
                    targs.Ndata, targs.eps_guard)
            r_gpu, r_cpu, r64, r64p = {}, {}, {}, {}
            g_gpu = cs.step_grads(*args, 'cuda', relu_in=r_gpu)[3]
            g_cpu = cs.step_grads(*args, 'cpu', relu_in=r_cpu)[3]
            g64 = cs.step_grads(*args, 'cpu', 1, torch.float64,
                                relu_in=r64)[3]
            g64p = cs.step_grads(*args, 'cpu', 1, torch.float64,
                                 relu_in=r64p, relu_pin=r_gpu)[3]
            with cs.cudnn_deterministic():
                g_det = cs.step_grads(*args, 'cuda')[3]
            with torch.backends.cudnn.flags(enabled=False):
                g_off = cs.step_grads(*args, 'cuda')[3]
            print(json.dumps({
                'state': name, 'noise seed': nseed,
                'gpu vs f64, own branches': cs.worst_grad_error(
                    g_gpu, g64, model),
                'gpu vs f64, gpu branches': cs.worst_grad_error(
                    g_gpu, g64p, model),
                'gpu, deterministic cuDNN, vs f64, own branches':
                    cs.worst_grad_error(g_det, g64, model),
                'gpu, no cuDNN, vs f64, own branches': cs.worst_grad_error(
                    g_off, g64, model),
                'cpu f32 vs f64, own branches': cs.worst_grad_error(
                    g_cpu, g64, model),
                'relu flips gpu/f64': cs.relu_flips(r_gpu, r64),
                'relu flips cpu f32/f64': cs.relu_flips(r_cpu, r64)}),
                flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
