"""Coupled VAE-GP-ODE training on the GPU (the port's counterpart of the
repository's `main.py`, with its flags and defaults).

    python -m vae_gp_ode_tpu_torch.main [flags]            # on the GPU
    python -m vae_gp_ode_tpu_torch.main --device cpu ...   # plain versions

The run: data (rot-MNIST, or synthetic rotating glyphs when
`<data_root>/rot_mnist/rot-mnist.mat` is absent) -> `init_model` -> the
kernel hyperparameters set to --lengthscale/--variance (the reference
initialises them twice) -> Adam -> epochs of train steps (L=1 for the
first half of the epochs, then L=5) -> the per-epoch monitoring eval on
the first test batch (train-mode BatchNorm) -> meters and log lines ->
a checkpoint every --plot_freq epochs and after the last, in
`<save>_<timestamp>/odegpvae_mnist.ckpt`.

Metrics stay on the device until a flush (every --epochs_per_fetch epochs
and before each checkpoint), where the NaN policy reads them. Flags of
paths the port does not have yet raise NotImplementedError naming their
ROADMAP item when set away from their defaults. Plots are not ported.
`run(args)` runs in-process and returns what it did.
"""

import argparse
import json
import logging
import os
import sys
import time
from datetime import datetime, timedelta

import numpy as np

SOLVERS = ["dopri5", "bdf", "rk4", "midpoint", "adams", "explicit_adams",
           "fixed_adams", "euler"]
KERNELS = ['RBF', 'DF']


def make_parser():
    p = argparse.ArgumentParser(
        'Learning latent dynamics with VAE-GP-ODE (PyTorch/CUDA port)')
    a = p.add_argument
    # data
    a('--data_root', type=str, default='data/')
    a('--task', type=str, default='mnist')
    a('--mask', type=eval, default=True)
    a('--value', type=int, default=3, help='digit filter')
    a('--data_seqlen', type=int, default=100)
    a('--batch', type=int, default=20)
    a('--T', type=int, default=16)
    a('--Ndata', type=int, default=360)
    a('--Ntest', type=int, default=40)
    a('--rotrand', type=eval, default=True,
      help='no-op unless --rotrand_active (reference quirk)')
    a('--rotrand_active', type=eval, default=False)
    a('--n_glyphs', type=int, default=0,
      help='synthetic data only: 0 = fresh glyph per sequence')
    # vae
    a('--latent_dim', type=int, default=6)
    a('--n_filt', type=int, default=8)
    a('--frames', type=int, default=5)
    a('--pretrained', type=eval, default=False)
    a('--vae_path', type=str, default='')
    # gp
    a('--kernel', type=str, default='RBF', choices=KERNELS)
    a('--num_features', type=int, default=256)
    a('--num_inducing', type=int, default=100)
    a('--dimwise', type=eval, default=True)
    a('--variance', type=float, default=0.7)
    a('--lengthscale', type=float, default=2.0)
    a('--q_diag', type=eval, default=False)
    a('--fix_kernel', type=eval, default=False,
      help='freeze the kernel lengthscales and variance')
    # ode solver
    a('--ode', type=int, default=1)
    a('--D_in', type=int, default=6)
    a('--D_out', type=int, default=6)
    a('--solver', type=str, default='euler', choices=SOLVERS)
    a('--ts_dense_scale', type=int, default=1)
    a('--use_adjoint', type=eval, default=False)
    a('--dt', type=float, default=0.1)
    # training
    a('--Nepoch', type=int, default=5000)
    a('--lr', type=float, default=0.001)
    a('--eval_sample_size', type=int, default=128)
    a('--save', type=str, default='results/mnist_torch',
      help='run directory prefix (results/ is not committed)')
    a('--seed', type=int, default=121)
    a('--log_freq', type=int, default=5)
    a('--device', type=str, default='cuda',
      help="'cuda' (default) or 'cpu' (the kernels' plain versions)")
    a('--continue_training', type=eval, default=False)
    a('--model_path', type=str, default='None')
    a('--eps_guard', type=eval, default=True,
      help='epsilon-guarded Bernoulli log-prob (the JAX default)')
    a('--nan_policy', type=str, default='bailout',
      choices=['bailout', 'skip'])
    a('--plot_freq', type=int, default=10,
      help='epochs between checkpoints (plots are not ported)')
    a('--data_parallel', type=eval, default=False)
    a('--dp_impl', type=str, default='auto',
      choices=['auto', 'shardmap', 'gspmd'])
    a('--fast_epoch', type=eval, default=True,
      help='a dispatch knob of the JAX main.py; no counterpart here')
    a('--epochs_per_dispatch', type=int, default=1)
    a('--epochs_per_fetch', type=int, default=10,
      help='epochs between host reads of the metrics')
    a('--Troll', type=int, default=2)
    a('--profile', type=eval, default=False,
      help='a profiling knob of the JAX main.py; no counterpart here')
    return p


#: flags of paths not ported yet: (flag, default test, ROADMAP item)
_NOT_PORTED = (
    ('--pretrained', lambda a: not a.pretrained,
     'Queue A item 9 (pretrained VAE, freeze_vae)'),
    ('--data_parallel', lambda a: not a.data_parallel,
     'Queue A item 13 (data parallel)'),
    ('--dimwise False', lambda a: a.dimwise or a.kernel == 'DF',
     'Queue A item 2 (shared-lengthscale RBF)'),
    ('--epochs_per_dispatch', lambda a: a.epochs_per_dispatch == 1,
     'Queue A item 7 (multi-epoch segments)'),
)


def check_supported(args):
    """Raise NotImplementedError for a flag of a path the port does not
    have, set away from its default, and ValueError for flags that do not
    fit together."""
    for flag, is_default, item in _NOT_PORTED:
        if not is_default(args):
            raise NotImplementedError(
                f'{flag} is not ported yet (ROADMAP {item})')
    if args.kernel == 'DF' and (args.ode != 1 or args.D_in != args.D_out):
        raise ValueError(
            f'DF kernel requires D_in == D_out (a first-order ODE), got '
            f'--ode {args.ode} --D_in {args.D_in} --D_out {args.D_out}')
    if args.D_in != args.latent_dim * args.ode or \
            args.D_out != args.latent_dim:
        raise ValueError(
            f'the GP maps latent_dim*ode -> latent_dim: expected --D_in '
            f'{args.latent_dim * args.ode} --D_out {args.latent_dim}, got '
            f'{args.D_in} {args.D_out}')


def _logger(logpath):
    logger = logging.getLogger('vae_gp_ode_tpu_torch')
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter('%(asctime)s %(message)s')
    for h in (logging.FileHandler(logpath), logging.StreamHandler()):
        h.setFormatter(fmt)
        logger.addHandler(h)
    logger.propagate = False
    return logger


def run(args, on_step=None):
    """Train as the flags say. `on_step(epoch, L)` is called after each
    train step (a hook for callers that count or time steps).

    Returns a dict: 'state' (the final TrainState), 'save' (the run
    directory), 'ckpt' (the checkpoint path), 'epochs' (one dict of host
    numpy metrics per finished epoch: loss, nll, kl_reg, kl_u, kernel_var
    per step and the monitoring mse) and 'bailout' (the epoch of a NaN
    bailout, or None).
    """
    import torch
    from vae_gp_ode_tpu_torch.core.device import resolve_device
    from vae_gp_ode_tpu_torch.core.transforms import invsoftplus
    from vae_gp_ode_tpu_torch.data.mnist import load_data
    from vae_gp_ode_tpu_torch.kernels.rbf import (
        rbf_lengthscales, rbf_variance)
    from vae_gp_ode_tpu_torch.models.odegpvae import init_model
    from vae_gp_ode_tpu_torch.training import checkpoint as ckpt
    from vae_gp_ode_tpu_torch.training.meters import (
        CachedAverageMeter, CachedHyperparams, CachedRunningAverageMeter)
    from vae_gp_ode_tpu_torch.training.trainer import (
        create_train_state, make_epoch_eval_step, make_train_step,
        run_epoch_with_tail)

    check_supported(args)
    dev = resolve_device(args.device)
    stamp = datetime.now().strftime('_%d_%m_%Y-%H:%M:%S')
    save = os.path.abspath(args.save + stamp)
    os.makedirs(save, exist_ok=True)
    logger = _logger(os.path.join(save, 'logs'))
    logger.info('Results stored in %s', save)
    with open(os.path.join(save, 'args.json'), 'w') as f:
        json.dump(vars(args), f, indent=2, sort_keys=True)
    logger.info('device: %s%s', dev, f' ({torch.cuda.get_device_name(dev)})'
                if dev.type == 'cuda' else '')
    logger.info('plots are not ported (ROADMAP Queue A item 12): this run '
                'writes logs and checkpoints only')
    for flag in ('fast_epoch', 'profile'):
        if getattr(args, flag) != make_parser().get_default(flag):
            logger.info('--%s is a knob of the JAX main.py and has no '
                        'counterpart here; ignored', flag)

    trainset, testset = load_data(args, device=dev)
    logger.info('Data source: %s | train %s | test %s', trainset.source,
                tuple(trainset.X.shape), tuple(testset.X.shape))

    model, gp = init_model(
        args.seed, latent_dim=args.latent_dim, n_filt=args.n_filt,
        order=args.ode, frames=args.frames, dt=args.dt, solver=args.solver,
        dense=args.ts_dense_scale, num_features=args.num_features,
        num_inducing=args.num_inducing, kernel=args.kernel,
        q_diag=args.q_diag, use_adjoint=args.use_adjoint, device=dev)
    # kernel hyperparameters initialised twice, as the reference does
    # (every entry: (q, q*ode) dimwise-RBF or (q, q) DF lengthscales)
    with torch.no_grad():
        gp.kernel.unconstrained_lengthscales.fill_(
            float(invsoftplus(torch.tensor(args.lengthscale))))
        gp.kernel.unconstrained_variance.fill_(
            float(invsoftplus(torch.tensor(args.variance))))
    state = create_train_state(model, gp, lr=args.lr,
                               fix_kernel=args.fix_kernel)
    logger.info('VAE parameters %d | GP leaves %d',
                sum(p.numel() for p in model.parameters()),
                sum(p.numel() for p in gp.parameters()))
    logger.info(
        'Model parameters: num features %d | num inducing %d | num epochs '
        '%d | lr %g | ode %d | D_in %d | D_out %d | dt %g | kernel %s | '
        'latent_dim %d | variance %g | lengthscale %g | rotrand %s | '
        'solver %s | dense %d | adjoint %s',
        args.num_features, args.num_inducing, args.Nepoch, args.lr,
        args.ode, args.D_in, args.D_out, args.dt, args.kernel,
        args.latent_dim, args.variance, args.lengthscale, args.rotrand,
        args.solver, args.ts_dense_scale, args.use_adjoint)

    ckpt_path = os.path.join(save, 'odegpvae_mnist.ckpt')
    if args.continue_training and args.model_path != 'None':
        prev = os.path.join(args.model_path, 'odegpvae_mnist.ckpt')
        ckpt.restore_checkpoint(prev, state)
        logger.info('Resume training from %s (step %d, optimizer state '
                    'included)', prev, int(state.step))

    elbo_m = CachedRunningAverageMeter(10)
    nll_m = CachedRunningAverageMeter(10)
    reg_kl_m = CachedRunningAverageMeter(10)
    kl_u_m = CachedRunningAverageMeter(10)
    mse_m = CachedAverageMeter()
    time_m = CachedAverageMeter()
    hyp_m = CachedHyperparams()

    train_step = make_train_step(num_observations=args.Ndata,
                                 eps_guard=args.eps_guard)
    epoch_eval = make_epoch_eval_step()
    generator = torch.Generator(device=dev)
    generator.manual_seed(args.seed)
    result = {'state': state, 'save': save, 'ckpt': ckpt_path,
              'epochs': [], 'bailout': None}
    begin = time.time()
    global_itr = 0
    pending = []

    def host_epoch(row):
        """NaN policy, meters and log lines for one fetched epoch; False
        when a NaN bailout ends the run."""
        nonlocal global_itr
        ep = row['ep']
        finite = np.isfinite(row['loss'])
        if not finite.all():
            if args.nan_policy == 'bailout':
                logger.info('*** NaN loss at epoch %d/%d: reloading the '
                            'last checkpoint ***', ep, args.Nepoch)
                if os.path.exists(ckpt_path):
                    ckpt.restore_checkpoint(ckpt_path, state)
                result['bailout'] = ep
                return False
            logger.warning('epoch %d: %d/%d steps produced a non-finite '
                           'loss; their updates were discarded '
                           '(--nan_policy skip)', ep,
                           int((~finite).sum()), len(finite))
        for itr in np.flatnonzero(finite):
            elbo_m.update(float(row['loss'][itr]), global_itr)
            nll_m.update(float(row['nll'][itr]), global_itr)
            reg_kl_m.update(float(row['kl_reg'][itr]), global_itr)
            kl_u_m.update(float(row['kl_u'][itr]), global_itr)
            time_m.update(time.time() - begin, global_itr)
            hyp_m.update(row['kernel_var'][itr], global_itr)
            global_itr += 1
            if itr % args.log_freq == 0:
                logger.info(
                    'Iter:%-3d | Time %s | elbo %8.2f(%8.2f) | '
                    'nlhood:%8.2f(%8.2f) | kl_reg:%-8.2f(%-8.2f) | '
                    'kl_u:%8.5f(%8.5f)', itr,
                    timedelta(seconds=int(time_m.val)), elbo_m.val,
                    elbo_m.avg, nll_m.val, nll_m.avg, reg_kl_m.val,
                    reg_kl_m.avg, kl_u_m.val, kl_u_m.avg)
        mse_m.reset()
        mse_m.update(float(row['mse']), 0)
        logger.info('Epoch:%4d/%4d| tr_elbo:%8.2f(%8.2f) | '
                    'test_mse:%5.3f(%5.3f)\n', ep, args.Nepoch,
                    elbo_m.val if elbo_m.val is not None else float('nan'),
                    elbo_m.avg, mse_m.val, mse_m.avg)
        result['epochs'].append(row)
        return True

    def flush():
        """Read every queued epoch's metrics from the device, in order."""
        rows = [{k: (v if k == 'ep' else v.cpu().numpy())
                 for k, v in r.items()} for r in pending]
        pending.clear()
        return all(host_epoch(r) for r in rows)

    def step(st, batch, L, gen):
        metrics = train_step(st, batch, L, gen)
        if on_step is not None:
            on_step(ep, L)
        return metrics

    logger.info('********** Started Training **********')
    for ep in range(args.Nepoch):
        L = 1 if ep < args.Nepoch // 2 else 5
        batches, tail = trainset.epoch_batches_with_tail()
        metrics = run_epoch_with_tail(step, state, batches, tail, L,
                                      generator)
        _, mse = epoch_eval(state, testset.first(), 1, generator)
        pending.append(dict(metrics, mse=mse, ep=ep))
        artifacts = ep % args.plot_freq == 0 or ep == args.Nepoch - 1
        if artifacts or len(pending) >= max(args.epochs_per_fetch, 1):
            # before the checkpoint, so a bailout reloads the previous one
            if not flush():
                break
        if artifacts:
            ckpt.save_checkpoint(state, ckpt_path)

    if result['bailout'] is None:
        logger.info('********** Optimization completed **********')
    logger.info('Kernel lengthscales %s',
                rbf_lengthscales(state.gp.kernel).detach().cpu().numpy())
    logger.info('Kernel variance %s',
                rbf_variance(state.gp.kernel).detach().cpu().numpy())
    return result


def main(argv=None):
    run(make_parser().parse_args(argv))
    return 0


if __name__ == '__main__':
    sys.exit(main())
