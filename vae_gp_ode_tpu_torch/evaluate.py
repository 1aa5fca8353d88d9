"""Evaluation of a trained run (the port's counterpart of the repository's
`evaluate.py`): the reference notebooks' protocol, from which every
published number comes.

    python -m vae_gp_ode_tpu_torch.evaluate --model_path RUN_DIR [--L 5]
        [--Troll 2] [--batch 0] [--device cuda]
    python -m vae_gp_ode_tpu_torch.evaluate --model_paths RUN_DIR ...

A run directory holds `args.json` and `odegpvae_mnist.ckpt` (the port's
own, or the JAX package's npz checkpoint, such as `checkpoints/df_5000ep`).
One run prints one JSON line (`mse_mean`/`mse_std`: the full test set's MC
reconstruction error, `compute_mse_std`; `mse_floor`, the data's floor of
that metric, `sigmoid_floor_mse`; the keys of the JAX script); several
print a comparison table and one JSON list. The --Troll x T rollout of the
first three test sequences is written as `<run>/eval/rollout.npy` (L=1,
(1, 3, Troll T, 1, 28, 28)) beside `rollout_original.npy`, and drawn as
JAX `evaluate.py` draws it, `rollout.png` and `rollout_original.png`
(left out, with one log line naming them, where matplotlib does not
import).
"""

import argparse
import json
import logging
import os
import sys

import numpy as np

logger = logging.getLogger('vae_gp_ode_tpu_torch.evaluate')


def make_parser():
    p = argparse.ArgumentParser(
        'Evaluate a trained VAE-GP-ODE run (PyTorch/CUDA port)')
    p.add_argument('--model_path', type=str, default=None,
                   help='run dir with odegpvae_mnist.ckpt + args.json')
    p.add_argument('--model_paths', type=str, nargs='*', default=None,
                   help='several run dirs: a comparison table and a JSON '
                        'list')
    p.add_argument('--L', type=int, default=5,
                   help='MC samples (the notebooks use 5)')
    p.add_argument('--Troll', type=int, default=2,
                   help='rollout horizon multiplier')
    p.add_argument('--batch', type=int, default=0,
                   help='eval batch size (0: the run\'s training batch)')
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' (default) or 'cpu' (the kernels' plain "
                        "versions)")
    return p


def sigmoid_floor_mse(X_norm):
    """The floor of the reference metric on this data: the decoder's
    sigmoid outputs lie in (0, 1) and are compared with mean/std
    normalised pixels, so no model beats the pointwise optimum
    clip(x, 0, 1). Returns (mean((X - clip(X, 0, 1))^2), the ddof-1 std of
    those residuals); `mse_mean - floor` is the model's own error."""
    X_norm = np.asarray(X_norm)
    resid = (X_norm - np.clip(X_norm, 0.0, 1.0)) ** 2
    return float(resid.mean()), float(resid.ravel().std(ddof=1))


def compute_mse_std(state, loader, L, generator=None, noise=None):
    """The full test set's MC reconstruction error, the reference
    notebook's protocol: with eval-mode BatchNorm, the squared error of
    every MC sample, (Xrec - batch)^2 over (batches, L, N, T, 1, d, d),
    NOT that of the MC mean; returns its mean and its ddof-1 std (as
    torch.std). The errors stay on the device until the end (one host
    read); `noise(i, batch)` gives the model's raw draws for batch i (the
    noise dict of `ODEGPVAE`), else `generator` draws them."""
    import torch
    from vae_gp_ode_tpu_torch.training.trainer import make_eval_step

    ev = make_eval_step()
    sq = []
    for i, batch in enumerate(loader):
        Xrec, _ = ev(state, batch, L, generator,
                     noise=None if noise is None else noise(i, batch))
        sq.append(((Xrec - batch[None]) ** 2).reshape(-1))
    allsq = torch.cat(sq).double()
    return float(allsq.mean()), float(allsq.std())


def evaluate_one(args, model_path, noise=None):
    """Evaluate the run in `model_path` on the test split its flags make:
    `compute_mse_std` at --L draws (eval batch --batch, or the run's), the
    --Troll x T rollout of the first three test sequences (written under
    `<model_path>/eval/`) and the data's floor. Returns the JAX script's
    dict. `noise` goes to `compute_mse_std`."""
    import torch
    from vae_gp_ode_tpu_torch.data.mnist import load_data
    from vae_gp_ode_tpu_torch.serving import load_run_dir
    from vae_gp_ode_tpu_torch.training.trainer import make_eval_step
    from vae_gp_ode_tpu_torch.utils import plotting

    model, state, ta = load_run_dir(model_path, device=args.device)
    _, testset = load_data(ta, device=state.step.device)
    if args.batch:
        testset.batch_size = args.batch
    generator = torch.Generator(device=state.step.device)
    generator.manual_seed(ta.seed + 1)
    mse_mean, mse_std = compute_mse_std(state, testset, args.L, generator,
                                        noise)

    # the 2x-horizon rollout of the notebooks (create_plots.py)
    roll = make_eval_step(T_custom=args.Troll * ta.T)
    test_batch = testset.first()[:3]
    Xroll, _ = roll(state, test_batch, 1, generator)
    out_dir = os.path.join(model_path, 'eval')
    os.makedirs(out_dir, exist_ok=True)
    original, rollout = test_batch.cpu().numpy(), Xroll.cpu().numpy()
    np.save(os.path.join(out_dir, 'rollout_original.npy'), original)
    np.save(os.path.join(out_dir, 'rollout.npy'), rollout)
    figures = [os.path.join(out_dir, f) for f in ('rollout_original.png',
                                                  'rollout.png')]
    plotting.plot_data(original, fname=figures[0], size=3)
    plotting.plot_rollout(rollout, fname=figures[1])
    logger.info('rollout written to %s/rollout.npy', out_dir)
    plotting.log_left_out(logger, figures)

    floor_mean, floor_std = sigmoid_floor_mse(testset.X.cpu().numpy())
    return {
        'metric': 'test_recon_mse',
        'mse_mean': round(mse_mean, 6),
        'mse_std': round(mse_std, 6),
        'mse_floor': round(floor_mean, 6),
        'mse_floor_std': round(floor_std, 6),
        'mse_excess': round(mse_mean - floor_mean, 6),
        'L': args.L,
        'rollout_T': args.Troll * ta.T,
        'kernel': ta.kernel,
        'ode': ta.ode,
        'model_path': model_path,
    }


def main(argv=None):
    parser = make_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format='%(asctime)s %(message)s')
    if args.model_paths:
        results = [evaluate_one(args, p) for p in args.model_paths]
        print(f"{'model':48s} {'kernel':6s} {'ode':3s} "
              f"{'mse_mean':>10s} {'mse_std':>10s}")
        for r in results:
            print(f"{os.path.basename(r['model_path'].rstrip('/')):48s} "
                  f"{r['kernel']:6s} {r['ode']:<3d} "
                  f"{r['mse_mean']:>10.6f} {r['mse_std']:>10.6f}")
        print(json.dumps(results))
    elif args.model_path:
        print(json.dumps(evaluate_one(args, args.model_path)))
    else:
        parser.error('provide --model_path or --model_paths')
    return 0


if __name__ == '__main__':
    sys.exit(main())
