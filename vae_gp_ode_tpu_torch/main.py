"""Coupled VAE-GP-ODE training on the GPU (the port's counterpart of the
repository's `main.py`, with its flags and defaults).

    python -m vae_gp_ode_tpu_torch.main [flags]            # on the GPU
    python -m vae_gp_ode_tpu_torch.main --device cpu ...   # plain versions

The run: data (rot-MNIST, or synthetic rotating glyphs when
`<data_root>/rot_mnist/rot-mnist.mat` is absent) -> `init_model` -> the
kernel hyperparameters set to --lengthscale/--variance (the reference
initialises them twice) -> with --pretrained, the encoder and decoder
from --vae_path (`encoder.pt`/`decoder.pt` of the reference, else
`encoder.ckpt`/`decoder.ckpt` of `main_vae` or of the JAX package's
pretraining), frozen -> Adam (over the GP leaves alone when frozen) ->
epochs of train steps (L=1 for the first half of the epochs, then L=5) ->
the per-epoch monitoring eval on the first test batch (train-mode
BatchNorm; eval mode with a frozen VAE, whose weights are then checked
bit for bit once per epoch or segment) -> meters and log lines -> a
checkpoint every --plot_freq epochs and after the last, in
`<save>_<timestamp>/odegpvae_mnist.ckpt`.

Epochs run as segments (`training.trainer.make_train_segment`): one
epoch each, or with --epochs_per_dispatch E > 1, E epochs where no
checkpoint epoch or the L switch falls inside them (`segment_length`),
with the bits of E single epochs. Metrics stay on the device until a
flush (once at least max(E, --epochs_per_fetch) epochs wait, and before
each checkpoint), where the NaN policy reads them.

The run directory holds JAX `main.py`'s files: `args.json`, `logs`, the
checkpoint, `plots/data.png` (the first training batch),
`plots/rot_mnist.png` (the monitoring eval's reconstructions, at every
checkpoint), and at the end (`final_plots`, also after a NaN bailout) the
loss traces `elbo.npy`, `nll.npy`, `zkl.npy`, `inducingkl.npy` with
`plots/optimization_trace.png`, `plots/hyperparams.png`, the latent PCA
`plots/dynamics_{train,test}_state.png` (and `_velocity` for order 2) and
the --Troll x T rollout of three test sequences,
`plots/rollout_original.png` and `plots/rollout.png`. Where matplotlib
does not import, the PNGs are left out, the rest is written, and the log
names the figures left out in one line.

--data_parallel True under `torchrun --nproc_per_node R` (world size R >
1) trains with the per-rank step of `parallel.shard_dp`: every rank loads
the same data and state, trains on its share of each batch and applies
the same update; rank 0 writes the run directory. The process group is
NCCL where each rank has a GPU of its own, else gloo (ranks sharing one
GPU, or the CPU). At world size 1 the flag runs the single-device path,
as JAX's does on one device. `run(args)` runs in-process and returns what
it did.
"""

import argparse
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
      help='epochs between checkpoints and reconstruction plots')
    a('--data_parallel', type=eval, default=False)
    a('--dp_impl', type=str, default='auto',
      choices=['auto', 'shardmap', 'gspmd'],
      help='JAX main.py\'s choice of data-parallel step; the port has one '
           '(parallel.shard_dp), which every value runs')
    a('--fast_epoch', type=eval, default=True,
      help='a dispatch knob of the JAX main.py; no counterpart here')
    a('--epochs_per_dispatch', type=int, default=1)
    a('--epochs_per_fetch', type=int, default=10,
      help='epochs between host reads of the metrics')
    a('--Troll', type=int, default=2)
    a('--profile', type=eval, default=False,
      help='a profiling knob of the JAX main.py; no counterpart here')
    return p


def check_supported(args):
    """Raise ValueError for flags that do not fit together."""
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


def segment_length(ep, Nepoch, plot_freq, epochs_per_dispatch):
    """How many epochs from `ep` on run as one segment (the JAX `main.py`'s
    rule): E = `epochs_per_dispatch` where `ep` is no artifact epoch
    (ep % plot_freq == 0, or the final one) and the next artifact epoch,
    and before the switch to L=5 the switch at Nepoch // 2, is at least E
    epochs away; else 1."""
    E = max(epochs_per_dispatch, 1)
    if E == 1 or ep % plot_freq == 0 or ep == Nepoch - 1:
        return 1
    nxt = Nepoch - 1
    if ep < Nepoch // 2:
        nxt = min(nxt, Nepoch // 2)
    nxt = min(nxt, (ep // plot_freq + 1) * plot_freq)
    return E if nxt - ep >= E else 1


def pretrained_vae_files(vae_path):
    """(encoder, decoder) files of a pretrained VAE in `vae_path`: the
    reference's `encoder.pt`/`decoder.pt` where `encoder.pt` exists, else
    `encoder.ckpt`/`decoder.ckpt`; raises FileNotFoundError naming a
    missing one."""
    ext = 'pt' if os.path.exists(os.path.join(vae_path, 'encoder.pt')) \
        else 'ckpt'
    paths = tuple(os.path.join(vae_path, f'{name}.{ext}')
                  for name in ('encoder', 'decoder'))
    for path in paths:
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f'--pretrained: {path} does not exist (--vae_path '
                f'{vae_path!r} holds neither encoder.pt/decoder.pt nor '
                f'encoder.ckpt/decoder.ckpt)')
    return paths


def load_pretrained_vae(model, vae_path):
    """Load the encoder and decoder of `pretrained_vae_files(vae_path)`
    into `model`, in place, after checking every name and shape."""
    from vae_gp_ode_tpu_torch.training.checkpoint import load_vae_weights
    from vae_gp_ode_tpu_torch.utils import torch_import
    enc, dec = pretrained_vae_files(vae_path)
    if enc.endswith('.pt'):
        sds = (torch_import.load_torch_checkpoint(enc),
               torch_import.load_torch_checkpoint(dec))
    else:
        sds = load_vae_weights(enc, dec)
    return torch_import.vae_from_torch(model, *sds)


def data_parallel_group(args, dev):
    """With --data_parallel True under torchrun (WORLD_SIZE > 1): join the
    process group (NCCL where every rank has a GPU of its own, else gloo)
    and return (world size, rank, this rank's device, backend); else
    (1, 0, dev, None). A rank on the GPU takes cuda:<LOCAL_RANK modulo the
    GPUs>."""
    import torch
    import torch.distributed as dist
    world = int(os.environ.get('WORLD_SIZE', '1'))
    if not args.data_parallel or world == 1:
        return 1, 0, dev, None
    if dev.type == 'cuda':
        n_gpu = torch.cuda.device_count()
        dev = torch.device('cuda', int(os.environ.get('LOCAL_RANK', '0'))
                           % n_gpu)
        torch.cuda.set_device(dev)
        backend = 'nccl' if n_gpu >= world else 'gloo'
    else:
        backend = 'gloo'
    if not dist.is_initialized():
        dist.init_process_group(backend, device_id=(
            dev if backend == 'nccl' else None))
    return dist.get_world_size(), dist.get_rank(), dev, dist.get_backend()


def latent_trajectories(state, batch, generator=None, noise=None):
    """Encode with eval-mode BatchNorm and integrate one GP draw, no
    decode: the latent trajectories (1, N, T, D) of the latent-dynamics
    plots. `noise` (the model's raw draws) or `generator` gives the
    draws."""
    import torch
    model = state.model.eval()
    with torch.no_grad():
        reparam = None if noise is None else (noise['z0'], noise.get('v0'))
        z0, _, _ = model.encode(batch, generator, reparam_noise=reparam)
        ztL, _ = model.sample_trajectories(state.gp, z0, batch.shape[1], 1,
                                           generator, noise=noise)
    return ztL


def final_plots(logger, args, save, state, trainset, testset, meters,
                generator):
    """The end-of-run figures of JAX `main.py`: the loss traces (and
    their .npy dumps), the GP variance trace, the latent PCA of the first
    train and test batch, and the --Troll x T rollout of three test
    sequences (L=1). Returns the arrays it plotted: 'dynamics_train',
    'dynamics_test' (1, N, T, D), 'rollout_original' (3, T, 1, d, d) and
    'rollout' (1, 3, Troll T, 1, d, d), as host numpy, and 'figures', the
    PNG paths it asked for."""
    from vae_gp_ode_tpu_torch.training.trainer import make_eval_step
    from vae_gp_ode_tpu_torch.utils import plotting
    elbo_m, nll_m, zkl_m, ukl_m, hyp_m = meters
    plots = os.path.join(save, 'plots')
    plotting.plot_trace(elbo_m, nll_m, zkl_m, ukl_m, save)
    plotting.plot_params(hyp_m, save)
    out = {'figures': [os.path.join(plots, 'optimization_trace.png'),
                       os.path.join(plots, 'hyperparams.png')]}
    parts = ['state'] + (['velocity'] if args.ode == 2 else [])
    for name, loader in (('train', trainset), ('test', testset)):
        ztL = latent_trajectories(state, loader.first(), generator)
        out[f'dynamics_{name}'] = ztL.cpu().numpy()
        fname = os.path.join(plots, f'dynamics_{name}')
        plotting.plot_latent_dynamics(out[f'dynamics_{name}'], order=args.ode,
                                      fname=fname)
        out['figures'] += [f'{fname}_{p}.png' for p in parts]
    test_batch = testset.first()[:3]
    out['rollout_original'] = test_batch.cpu().numpy()
    plotting.plot_data(out['rollout_original'], size=3,
                       fname=os.path.join(plots, 'rollout_original.png'))
    Xroll, _ = make_eval_step(T_custom=args.Troll * args.T)(
        state, test_batch, 1, generator)
    out['rollout'] = Xroll.cpu().numpy()
    plotting.plot_rollout(out['rollout'],
                          fname=os.path.join(plots, 'rollout.png'))
    out['figures'] += [os.path.join(plots, f) for f in (
        'rollout_original.png', 'rollout.png')]
    logger.info('Final plots written to %s', plots)
    return out


def run(args, on_step=None):
    """Train as the flags say. `on_step(epoch, L)` is called after each
    train step (a hook for callers that count or time steps).

    Returns a dict: 'state' (the final TrainState), 'save' (the run
    directory), 'ckpt' (the checkpoint path), 'epochs' (one dict of host
    numpy metrics per finished epoch: loss, nll, kl_reg, kl_u, kernel_var
    per step and the monitoring mse), 'segments' ((first epoch, epochs)
    of every segment run), 'ckpt_epochs' (the epochs after which a
    checkpoint was written), 'frozen_checks' (how often the frozen VAE's
    weights were checked), 'bailout' (the epoch of a NaN bailout, or
    None), 'plots' (what `final_plots` returned), 'figures' (every PNG
    path the run asked for) and 'parallel' ((world size, rank, backend);
    backend None at world size 1). Under data parallelism every rank
    trains, and only rank 0 writes the run directory.
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
    from vae_gp_ode_tpu_torch.parallel import (
        make_shardmap_train_segment, replicate)
    from vae_gp_ode_tpu_torch.training.trainer import (
        create_train_state, make_train_segment)
    from vae_gp_ode_tpu_torch.utils import io as io_utils
    from vae_gp_ode_tpu_torch.utils import plotting
    from vae_gp_ode_tpu_torch.utils.summary import param_count, summarize

    check_supported(args)
    if args.pretrained:
        pretrained_vae_files(args.vae_path)    # before the run directory
    dev = resolve_device(args.device)
    world, rank, dev, backend = data_parallel_group(args, dev)
    if world > 1 and args.batch % world:
        raise ValueError(f'--data_parallel: --batch {args.batch} does not '
                         f'split evenly over {world} ranks')
    stamp = datetime.now().strftime('_%d_%m_%Y-%H:%M:%S')
    save = os.path.abspath(args.save + stamp)
    writer = rank == 0
    if world > 1:
        import torch.distributed as dist
        box = [save]
        dist.broadcast_object_list(box, src=0)     # rank 0's stamp
        save = box[0]
    if writer:
        io_utils.makedirs(os.path.join(save, 'plots'))
    logger = io_utils.get_logger(os.path.join(save, 'logs'),
                                 displaying=writer, saving=writer)
    logger.info('Results stored in %s', save)
    if writer:
        io_utils.save_args(args, os.path.join(save, 'args.json'))
    logger.info('device: %s%s', dev, f' ({torch.cuda.get_device_name(dev)})'
                if dev.type == 'cuda' else '')
    if world > 1:
        logger.info('Data-parallel over %d ranks (rank %d, %s backend): '
                    'the per-rank step of parallel.shard_dp (--dp_impl %s; '
                    'the port has one implementation)', world, rank, backend,
                    args.dp_impl)
    elif args.data_parallel:
        logger.info('--data_parallel True at world size 1: the '
                    'single-device path')
    for flag in ('fast_epoch', 'profile'):
        if getattr(args, flag) != make_parser().get_default(flag):
            logger.info('--%s is a knob of the JAX main.py and has no '
                        'counterpart here; ignored', flag)

    trainset, testset = load_data(args, device=dev)
    logger.info('Data source: %s | train %s | test %s', trainset.source,
                tuple(trainset.X.shape), tuple(testset.X.shape))
    figures = [os.path.join(save, 'plots', 'data.png')]
    first = trainset.first().cpu().numpy()    # draws a permutation, as JAX
    if writer:
        plotting.plot_data(first, fname=figures[0])

    model, gp = init_model(
        args.seed, latent_dim=args.latent_dim, n_filt=args.n_filt,
        order=args.ode, frames=args.frames, dt=args.dt, solver=args.solver,
        dense=args.ts_dense_scale, num_features=args.num_features,
        num_inducing=args.num_inducing, kernel=args.kernel,
        q_diag=args.q_diag, dimwise=args.dimwise,
        use_adjoint=args.use_adjoint, device=dev)
    # kernel hyperparameters initialised twice, as the reference does
    # (every entry: (q, q*ode) dimwise-RBF, (q*ode,) shared-RBF or (q, q)
    # DF lengthscales)
    with torch.no_grad():
        gp.kernel.unconstrained_lengthscales.fill_(
            float(invsoftplus(torch.tensor(args.lengthscale))))
        gp.kernel.unconstrained_variance.fill_(
            float(invsoftplus(torch.tensor(args.variance))))
    if args.pretrained:
        load_pretrained_vae(model, args.vae_path)
        logger.info('***** Loaded pretrained VAE from %s (frozen) *****',
                    args.vae_path)
    state = create_train_state(model, gp, lr=args.lr,
                               fix_kernel=args.fix_kernel,
                               freeze_vae=args.pretrained)
    if world > 1:
        replicate(state)
    logger.info('\n%s\n%s', summarize(model, 'vae params'),
                summarize(gp, 'gp params'))
    logger.info('VAE parameters %d%s | GP leaves %d', param_count(model),
                ' (frozen)' if args.pretrained else '', param_count(gp))
    if args.pretrained:
        frozen = [p.detach().clone() for p in model.parameters()]

        def vae_unchanged():
            """The VAE weights bit for bit as loaded: compared on the
            device, one host read."""
            return bool(torch.stack([
                (a.view(torch.int32) == b.view(torch.int32)).all()
                for a, b in zip(model.parameters(), frozen)]).all())
    logger.info(
        'Model parameters: num features %d | num inducing %d | num epochs '
        '%d | lr %g | ode %d | D_in %d | D_out %d | dt %g | kernel %s | '
        'latent_dim %d | variance %g | lengthscale %g | rotrand %s | '
        'solver %s | dense %d | adjoint %s | dimwise %s',
        args.num_features, args.num_inducing, args.Nepoch, args.lr,
        args.ode, args.D_in, args.D_out, args.dt, args.kernel,
        args.latent_dim, args.variance, args.lengthscale, args.rotrand,
        args.solver, args.ts_dense_scale, args.use_adjoint,
        state.gp.kernel.dimwise)

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

    # a single epoch is a segment of one: the same steps, draws and
    # monitoring eval (eval mode for a frozen VAE, which the reference
    # eval()s)
    if world > 1:
        train_segment = make_shardmap_train_segment(
            num_observations=args.Ndata, eps_guard=args.eps_guard)
    else:
        train_segment = make_train_segment(num_observations=args.Ndata,
                                           eps_guard=args.eps_guard)
    generator = torch.Generator(device=dev)
    generator.manual_seed(args.seed)
    result = {'state': state, 'save': save, 'ckpt': ckpt_path,
              'epochs': [], 'segments': [], 'ckpt_epochs': [],
              'frozen_checks': 0, 'bailout': None, 'figures': figures,
              'parallel': (world, rank, backend)}
    rot_mnist = os.path.join(save, 'plots', 'rot_mnist.png')
    evals = {}                 # the last monitoring eval's reconstructions
    tail_dropped = False
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
        """Read every queued segment's metrics (the epoch axis leading)
        from the device and run the host's bookkeeping epoch by epoch, in
        order."""
        rows = [{k: (v if k == 'eps' else v.cpu().numpy())
                 for k, v in r.items()} for r in pending]
        pending.clear()
        return all(host_epoch(dict({k: v[i] for k, v in r.items()
                                    if k != 'eps'}, ep=ep_r))
                   for r in rows for i, ep_r in enumerate(r['eps']))

    def check_frozen(ep):
        """Once per epoch or segment: weights change only through
        updates, so the last epoch's weights speak for all of them."""
        if args.pretrained:
            result['frozen_checks'] += 1
            if not vae_unchanged():
                raise RuntimeError(f'epoch {ep}: the frozen VAE weights '
                                   f'changed')

    E = max(args.epochs_per_dispatch, 1)
    fetch_every = max(E, args.epochs_per_fetch, 1)
    if args.plot_freq == 1 and (E > 1 or args.epochs_per_fetch > 1):
        # every epoch then checkpoints, and a checkpoint flushes first
        logger.warning(
            '--epochs_per_dispatch/--epochs_per_fetch > 1 have no effect '
            'at --plot_freq 1 (every epoch checkpoints, forcing a '
            'per-epoch flush); raise --plot_freq to engage them')
    logger.info('********** Started Training **********')
    ep = 0
    while ep < args.Nepoch:
        L = 1 if ep < args.Nepoch // 2 else 5
        n = segment_length(ep, args.Nepoch, args.plot_freq, E)
        heads, tails = trainset.epoch_index_batches(n)
        if tails is not None and tails.shape[1] % world:
            if not tail_dropped:
                logger.warning('data-parallel: dropping the ragged tail '
                               'batch of %d sequences (not divisible by %d '
                               'ranks), as JAX main.py does', tails.shape[1],
                               world)
            tail_dropped = True
            tails = None
        test_idx = testset.first_index(n)
        metrics, mses = train_segment(
            state, trainset.X, heads, tails, testset.X, test_idx, L,
            generator,
            on_step=None if on_step is None else (
                lambda e, ep0=ep, L=L: on_step(ep0 + e, L)),
            on_eval=lambda e, Xrec: evals.update(Xrec=Xrec))
        check_frozen(ep + n - 1)
        pending.append(dict(metrics, mse=mses, eps=list(range(ep, ep + n))))
        if n > 1:
            result['segments'].append((ep, n))
        ep += n
        last = ep - 1
        artifacts = last % args.plot_freq == 0 or last == args.Nepoch - 1
        waiting = sum(len(r['eps']) for r in pending)
        if artifacts or waiting >= fetch_every:
            # before the checkpoint, so a bailout reloads the previous one
            if not flush():
                break
        if artifacts:
            if writer:
                plotting.plot_rot_mnist(
                    testset.X[test_idx[-1]].cpu().numpy(),
                    evals['Xrec'][0].cpu().numpy(), False, fname=rot_mnist)
                ckpt.save_checkpoint(state, ckpt_path)
            figures.append(rot_mnist)
            result['ckpt_epochs'].append(last)

    if result['bailout'] is None:
        logger.info('********** Optimization completed **********')
    logger.info('Kernel lengthscales %s',
                rbf_lengthscales(state.gp.kernel).detach().cpu().numpy())
    logger.info('Kernel variance %s',
                rbf_variance(state.gp.kernel).detach().cpu().numpy())
    if writer:
        result['plots'] = final_plots(
            logger, args, save, state, trainset, testset,
            (elbo_m, nll_m, reg_kl_m, kl_u_m, hyp_m), generator)
        figures += result['plots'].pop('figures')
        plotting.log_left_out(logger, figures)
    return result


def main(argv=None):
    run(make_parser().parse_args(argv))
    return 0


if __name__ == '__main__':
    sys.exit(main())
