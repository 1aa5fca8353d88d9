"""VAE pretraining on the GPU (the port's counterpart of the repository's
`main_vae.py`, with its flags and defaults).

    python -m vae_gp_ode_tpu_torch.main_vae [flags]            # on the GPU
    python -m vae_gp_ode_tpu_torch.main_vae --device cpu ...   # on the CPU

The run: create (or load, from --save) a dataset of rotating glyph frames
(--n_train and --n_test digits, --n_angle angles each, [0, 1] pixels) ->
an encoder and a decoder with flax-default weights from --seed -> epochs
of ELBO steps (KL(q(z) || N(0, I)) - Bernoulli log-likelihood of the
frames, train-mode BatchNorm, the port's Adam) over every frame, a short
last batch included -> meters and log lines -> the encoder and decoder in
`<output_path>_<timestamp>/MNIST-VAE/encoder.ckpt` and `decoder.ckpt`,
which `main --pretrained True --vae_path .../MNIST-VAE` reads -> the
reconstruction MSE of the first 16 frames of a test batch (eval-mode
BatchNorm). The plots (reconstructions, t-SNE, PCA, traces) are not
ported (ROADMAP Queue A [A12]). `run(args)` runs in-process and returns
what it did.
"""

import argparse
import json
import os
import sys
import time
from datetime import datetime, timedelta

import numpy as np


def make_parser():
    p = argparse.ArgumentParser(
        'Learning Latent Encoding with VAE (PyTorch/CUDA port)')
    a = p.add_argument
    # data
    a('--digit', type=int, default=3)
    a('--n_angle', type=int, default=16)
    a('--n_train', type=int, default=180)
    a('--n_test', type=int, default=121)
    a('--batch', type=int, default=64)
    # vae
    a('--latent_dim', type=int, default=6)
    a('--n_filt', type=int, default=8)
    # training
    a('--device', type=str, default='cuda',
      help="'cuda' (default) or 'cpu'")
    a('--lr', type=float, default=0.001)
    a('--seed', type=int, default=121)
    a('--vae_epochs', type=int, default=300)
    # misc
    a('--output_path', type=str, default='results/vae')
    a('--save', type=str, default='data/moving_mnist',
      help='directory of the frame dataset (created when absent)')
    a('--log_freq', type=int, default=20)
    a('--eps_guard', type=eval, default=True,
      help='epsilon-guarded Bernoulli log-prob (the JAX default)')
    a('--fast_epoch', type=eval, default=True,
      help='a dispatch knob of the JAX main_vae.py; no counterpart here')
    return p


def make_vae(latent_dim=6, n_filt=8, seed=0, device='cuda'):
    """`nn.ModuleDict` of an encoder and a decoder of `models.vae` (frames
    -> q(z) -> frames; `vae.encoder`, `vae.decoder`) with flax-default
    weights drawn from the numpy seed `seed`, on `device`."""
    from torch import nn
    from vae_gp_ode_tpu_torch.core.device import resolve_device
    from vae_gp_ode_tpu_torch.models.odegpvae import init_weights
    from vae_gp_ode_tpu_torch.models.vae import Decoder, Encoder
    vae = nn.ModuleDict({'encoder': Encoder(latent_dim, n_filt),
                         'decoder': Decoder(latent_dim, n_filt)})
    init_weights(vae, np.random.default_rng(seed))
    return vae.to(resolve_device(device))


def vae_loss(vae, x, eps_guard=True, generator=None, noise=None):
    """The pretraining ELBO of frames x (B, 1, 28, 28) in [0, 1] with the
    modules' BatchNorm mode: (loss, lhood, kl_reg), loss = kl_reg - lhood,
    kl_reg the batch mean of KL(q(z|x) || N(0, I)), lhood the batch mean
    of the frames' summed Bernoulli log-likelihood. `noise` injects the
    standard-normal reparameterisation draws (B, latent_dim), else
    `generator` draws them."""
    import torch
    from vae_gp_ode_tpu_torch.models.vae import (
        bernoulli_log_prob, gaussian_kl_standard, reparam_sample)
    mu, logv = vae.encoder(x)
    z = reparam_sample(generator, mu, logv, noise)
    y = vae.decoder(z)
    kl_reg = torch.mean(gaussian_kl_standard(mu, logv))
    lhood = torch.mean(torch.sum(bernoulli_log_prob(x, y, eps_guard),
                                 dim=(1, 2, 3)))
    return kl_reg - lhood, lhood, kl_reg


def make_vae_step(adam, eps_guard=True):
    """Returns step(vae, x, generator=None, noise=None) -> (3,) device
    tensor (loss, lhood, kl_reg): the ELBO in train mode (the BatchNorm
    statistics move), `backward()`, one update of `adam` (the port's
    optax-arithmetic Adam over `vae.parameters()`: the encoder's, then
    the decoder's). Nothing reads the device."""
    import torch
    ok = torch.ones((), dtype=torch.bool, device=adam.mu.device)

    def step(vae, x, generator=None, noise=None):
        vae.train()
        params = list(vae.parameters())
        for p in params:
            p.grad = None
        loss, lhood, kl_reg = vae_loss(vae, x, eps_guard, generator, noise)
        loss.backward()
        adam.step(torch.cat([p.grad.reshape(-1) for p in params]), ok)
        return torch.stack([loss, lhood, kl_reg]).detach()

    return step


def frame_paths(args):
    """The train and test .npy of the frame dataset under --save."""
    return tuple(os.path.join(
        args.save, f'rotating_mnist_{split}_{args.digit}_{args.n_angle}_'
                   f'angles.npy') for split in ('train', 'test'))


def run(args):
    """Pretrain as the flags say. Returns a dict: 'output_path' (the run
    directory), 'model_dir' (its MNIST-VAE directory), 'vae' (the trained
    `make_vae` modules), 'epochs' (per epoch: 'rows', its steps' (loss,
    lhood, kl_reg) as host numpy, and 'seconds', from its first step to
    its metrics on the host) and 'test_mse' (the reconstruction MSE)."""
    import torch
    from vae_gp_ode_tpu_torch.core.device import resolve_device
    from vae_gp_ode_tpu_torch.data import mnist as dm
    from vae_gp_ode_tpu_torch.main import run_logger
    from vae_gp_ode_tpu_torch.models.vae import reparam_sample
    from vae_gp_ode_tpu_torch.training.checkpoint import save_vae_weights
    from vae_gp_ode_tpu_torch.training.meters import (
        CachedAverageMeter, CachedRunningAverageMeter)
    from vae_gp_ode_tpu_torch.training.trainer import Adam

    dev = resolve_device(args.device)
    stamp = datetime.now().strftime('_%d_%m_%Y-%H:%M:%S')
    output_path = os.path.abspath(args.output_path + stamp)
    os.makedirs(output_path, exist_ok=True)
    logger = run_logger(os.path.join(output_path, 'logs'))
    logger.info('Results stored in %s', output_path)
    with open(os.path.join(output_path, 'args.json'), 'w') as f:
        json.dump(vars(args), f, indent=2, sort_keys=True)
    logger.info('device: %s%s', dev, f' ({torch.cuda.get_device_name(dev)})'
                if dev.type == 'cuda' else '')
    if args.fast_epoch != make_parser().get_default('fast_epoch'):
        logger.info('--fast_epoch is a knob of the JAX main_vae.py and has '
                    'no counterpart here; ignored')

    train_path, test_path = frame_paths(args)
    if not (os.path.exists(train_path) and os.path.exists(test_path)):
        os.makedirs(args.save, exist_ok=True)
        train_arr, test_arr = dm.create_rotating_dataset(
            digit=args.digit, train_n=args.n_train, test_n=args.n_test,
            n_angles=args.n_angle, seed=args.seed)
        np.save(train_path, train_arr)
        np.save(test_path, test_arr)
    train_loader = dm.load_rotating_mnist_data(
        train_path, args.n_angle, args.batch, seed=args.seed, device=dev)
    logger.info('Model parameters: num epochs %d | lr %g | latent_dim %d '
                '| n_angles %d | frames %d', args.vae_epochs, args.lr,
                args.latent_dim, args.n_angle, train_loader.X.shape[0])

    vae = make_vae(args.latent_dim, args.n_filt, seed=args.seed, device=dev)
    adam = Adam(vae.parameters(), lr=args.lr)
    step = make_vae_step(adam, eps_guard=args.eps_guard)
    generator = torch.Generator(device=dev)
    generator.manual_seed(args.seed)

    elbo_m = CachedRunningAverageMeter(10)
    nll_m = CachedRunningAverageMeter(10)
    reg_kl_m = CachedRunningAverageMeter(10)
    time_m = CachedAverageMeter()
    result = {'output_path': output_path, 'vae': vae, 'epochs': []}
    logger.info('--------------- VAE Train ---------------')
    begin = time.time()
    global_itr = 0
    for ep in range(args.vae_epochs):
        t0 = time.perf_counter()
        batches, tail = train_loader.epoch_batches_with_tail()
        rows = [step(vae, x, generator) for x in batches]
        if tail is not None:
            rows.append(step(vae, tail, generator))
        rows = torch.stack(rows).cpu().numpy()       # the epoch's one read
        result['epochs'].append({'rows': rows,
                                 'seconds': time.perf_counter() - t0})
        for itr, (loss, lhood, kl_reg) in enumerate(rows):
            elbo_m.update(float(loss), global_itr)
            nll_m.update(-float(lhood), global_itr)
            reg_kl_m.update(float(kl_reg), global_itr)
            time_m.update(time.time() - begin, global_itr)
            global_itr += 1
            if itr % args.log_freq == 0:
                logger.info(
                    'Iter:%-3d | Time %s | elbo %8.2f(%8.2f) | '
                    'nlhood:%8.2f(%8.2f) | kl_reg:%-8.2f(%-8.2f)', itr,
                    timedelta(seconds=int(time_m.val)), elbo_m.val,
                    elbo_m.avg, nll_m.val, nll_m.avg, reg_kl_m.val,
                    reg_kl_m.avg)
        logger.info('Epoch:%4d/%4d| tr_elbo:%8.2f(%8.2f)\n', ep,
                    args.vae_epochs, elbo_m.val, elbo_m.avg)

    model_dir = os.path.join(output_path, 'MNIST-VAE')
    save_vae_weights(vae.encoder, vae.decoder,
                     os.path.join(model_dir, 'encoder.ckpt'),
                     os.path.join(model_dir, 'decoder.ckpt'))
    logger.info('Saved encoder/decoder to %s', model_dir)
    result['model_dir'] = model_dir

    # the reconstructions' MSE of the reference's visualize_output: the
    # first 16 frames of a test batch, eval-mode BatchNorm
    test_loader = dm.load_rotating_mnist_data(
        test_path, args.n_angle, args.batch, seed=args.seed, device=dev)
    x, _ = test_loader.first()
    vae.eval()
    with torch.no_grad():
        mu, logv = vae.encoder(x)
        y = vae.decoder(reparam_sample(generator, mu, logv))
        mse = float(torch.mean((x[:16, 0] - y[:16, 0]) ** 2))
    result['test_mse'] = mse
    logger.info('VAE test reconstruction MSE: %.4f', mse)
    logger.info('plots are not ported (ROADMAP Queue A [A12]): this run '
                'writes logs and the encoder/decoder only')
    return result


def main(argv=None):
    run(make_parser().parse_args(argv))
    return 0


if __name__ == '__main__':
    sys.exit(main())
