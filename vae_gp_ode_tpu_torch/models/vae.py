"""Convolutional VAE encoder/decoder and the standalone `VAE` pair (port of
`vae_gp_ode_tpu/models/vae.py`).

The topology and parameter names are the reference's PyTorch ones
(`cnn.*`, `decnn.*`, `fc`), NCHW:

Encoder: 3x Conv 5x5 stride 2 pad 2 (frames -> nf -> 2nf -> 4nf),
BatchNorm+ReLU after the first two, ReLU after the third, flatten to
nf*4^3 features, Linear -> 2*latent_dim, chunked into (mu, logvar).
28 -> 14 -> 7 -> 4 spatial.

Decoder: Linear latent -> nf*4^3, unflatten to (4nf, 4, 4),
ConvT(8nf, k3, s1, p0) -> 6, ConvT(4nf, k5, s2, p1) -> 13,
ConvT(2nf, k5, s2, p1, output_padding 1) -> 28, ConvT(1, k5, s1, p2) -> 28,
sigmoid; BatchNorm+ReLU between the deconvolutions.

BatchNorm (`BatchNorm2d` below): flax's `nn.BatchNorm(momentum=0.9,
epsilon=1e-5)`. Train mode normalises with the batch's biased variance and
moves the running statistics 0.1 of the way to the batch mean and the
biased batch variance (torch's own BatchNorm2d puts the unbiased variance
there); eval mode (`module.eval()`) normalises with the running
statistics.
"""

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from vae_gp_ode_tpu_torch.core.collectives import all_reduce_sum
from vae_gp_ode_tpu_torch.core.settings import BERNOULLI_EPS


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` (same parameters, buffers and eval mode) whose
    train mode updates `running_var` with the biased batch variance, as
    flax does. The update runs in place under no_grad, also for
    `torch.no_grad()` callers (the per-epoch monitoring eval).
    `num_batches_tracked` stays 0: with a fixed momentum nothing reads it,
    and flax keeps no such count.

    `group`: a `torch.distributed` process group whose ranks each hold an
    equal share of the batch (None: the batch is all here). In train mode
    the statistics are then the global batch's, summed over the group
    through a differentiable all-reduce (flax's `BatchNorm(axis_name=)`),
    so every rank normalises and updates its running statistics as one
    device with the whole batch would. `nn.SyncBatchNorm` is not used: it
    takes CUDA tensors only, and the data-parallel step runs on the CPU
    too."""

    def __init__(self, num_features):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.group is not None:
            return self._group_forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return y

    def _group_forward(self, x):
        n = x.numel() // x.shape[1] * dist.get_world_size(self.group)
        mean = all_reduce_sum(x.sum(dim=(0, 2, 3)), self.group) / n
        xc = x - mean[:, None, None]
        var = all_reduce_sum((xc * xc).sum(dim=(0, 2, 3)), self.group) / n
        y = (xc * torch.rsqrt(var + self.eps)[:, None, None]
             * self.weight[:, None, None] + self.bias[:, None, None])
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return y


def _layer(mod, x, dtype):
    """One layer of the VAE computing in `dtype` as flax's `dtype=` does:
    a convolution or linear layer casts its input, weight and bias to
    `dtype` at use and computes in it (the weights stay float32);
    BatchNorm normalises in float32, its statistics' type, and rounds its
    output to `dtype`; activations and reshapes keep their input's type."""
    if isinstance(mod, nn.Conv2d):
        return mod._conv_forward(x.to(dtype), mod.weight.to(dtype),
                                 mod.bias.to(dtype))
    if isinstance(mod, nn.ConvTranspose2d):
        return F.conv_transpose2d(
            x.to(dtype), mod.weight.to(dtype), mod.bias.to(dtype),
            mod.stride, mod.padding, mod.output_padding, mod.groups,
            mod.dilation)
    if isinstance(mod, nn.Linear):
        return F.linear(x.to(dtype), mod.weight.to(dtype),
                        mod.bias.to(dtype))
    if isinstance(mod, nn.BatchNorm2d):
        return mod(x.float()).to(dtype)
    return mod(x)


def _run(layers, x, dtype):
    """`layers` in turn on x, computing in `dtype` (None: the weights'
    own type, float32, as the modules compute by themselves)."""
    for mod in layers:
        x = mod(x) if dtype is None else _layer(mod, x, dtype)
    return x


class Encoder(nn.Module):
    """`dtype`: the compute type of the layers (None for float32; JAX
    `models/vae.py` `Encoder.dtype`); the outputs are in it."""

    def __init__(self, latent_dim=16, n_filt=8, frames=1, dtype=None):
        super().__init__()
        nf = n_filt
        self.dtype = dtype
        self.cnn = nn.Sequential(
            nn.Conv2d(frames, nf, 5, 2, 2), BatchNorm2d(nf), nn.ReLU(),
            nn.Conv2d(nf, nf * 2, 5, 2, 2), BatchNorm2d(nf * 2),
            nn.ReLU(),
            nn.Conv2d(nf * 2, nf * 4, 5, 2, 2), nn.ReLU(), nn.Flatten())
        self.fc = nn.Linear(nf * 4 ** 3, 2 * latent_dim)

    def forward(self, x):
        """x: (N, frames, 28, 28) -> (mu, logvar), each (N, latent_dim)."""
        h = _run(list(self.cnn) + [self.fc], x, self.dtype)
        mu, logvar = h.chunk(2, dim=-1)
        return mu, logvar


class Decoder(nn.Module):
    """`dtype`: the compute type of the layers, as `Encoder`'s; the
    frames are in it."""

    def __init__(self, latent_dim=16, n_filt=8, dtype=None):
        super().__init__()
        nf = n_filt
        self.dtype = dtype
        self.fc = nn.Linear(latent_dim, nf * 4 ** 3)
        self.decnn = nn.Sequential(
            nn.Unflatten(1, (nf * 4, 4, 4)),
            nn.ConvTranspose2d(nf * 4, nf * 8, 3, 1, 0),
            BatchNorm2d(nf * 8), nn.ReLU(),
            nn.ConvTranspose2d(nf * 8, nf * 4, 5, 2, 1),
            BatchNorm2d(nf * 4), nn.ReLU(),
            nn.ConvTranspose2d(nf * 4, nf * 2, 5, 2, 1, output_padding=1),
            BatchNorm2d(nf * 2), nn.ReLU(),
            nn.ConvTranspose2d(nf * 2, 1, 5, 1, 2), nn.Sigmoid())

    def forward(self, z):
        """z: (B, latent_dim) -> (B, 1, 28, 28) sigmoid images."""
        return _run([self.fc] + list(self.decnn), z, self.dtype)


def bernoulli_log_prob(x, xrec, eps_guard: bool = False):
    """Elementwise Bernoulli log-likelihood log(z)x + log(1-z)(1-x), with the
    reference's (dead) eps branch when `eps_guard`."""
    if eps_guard:
        return (torch.log(BERNOULLI_EPS + xrec) * x
                + torch.log(BERNOULLI_EPS + 1.0 - xrec) * (1.0 - x))
    return torch.log(xrec) * x + torch.log(1.0 - xrec) * (1.0 - x)


def gaussian_kl_standard(mu, logvar):
    """KL(N(mu, exp(0.5 logvar)^2) || N(0, I)) summed over the last axis."""
    var = torch.exp(logvar)
    return 0.5 * torch.sum(var + mu ** 2 - 1.0 - logvar, dim=-1)


def reparam_sample(generator, mu, logvar, noise=None):
    """z = mu + exp(0.5 logvar) * eps, eps injected or drawn."""
    if noise is None:
        noise = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                            device=mu.device)
    return mu + torch.exp(0.5 * logvar) * noise


class VAE(nn.Module):
    """Standalone encoder/decoder pair (JAX `models/vae.py` `VAE`): the
    pretraining workflow's model (`main_vae.make_vae`), with the
    reference's `test` convenience. `order=2` adds the velocity encoder
    `encoder_v` over `frames` stacked frames; pretraining never trains it
    and `training.checkpoint.save_vae_weights` leaves it out (the trained
    velocity encoder lives in `ODEGPVAE`). BatchNorm follows the module's
    mode (train() or eval()), JAX's `train` flag."""

    def __init__(self, latent_dim=8, n_filt=8, frames=1, order=1):
        super().__init__()
        self.latent_dim = latent_dim
        self.order = order
        self.encoder = Encoder(latent_dim, n_filt, frames=1)
        self.decoder = Decoder(latent_dim, n_filt)
        if order == 2:
            self.encoder_v = Encoder(latent_dim, n_filt, frames=frames)

    def forward(self, x, generator=None, noise=None):
        """Encode frames x (N, 1, 28, 28) -> sample -> decode; returns
        (xrec, mu, logvar). `noise` injects the standard-normal draws
        (N, latent_dim), else `generator` draws them."""
        mu, logvar = self.encoder(x)
        z = reparam_sample(generator, mu, logvar, noise)
        return self.decoder(z), mu, logvar

    def encode_velocity(self, xv):
        """Velocity-encoder statistics (mu, logvar) over `frames` stacked
        frames (N, frames, 28, 28); order 2 only."""
        if self.order != 2:
            raise ValueError('encode_velocity requires order=2')
        return self.encoder_v(xv)

    def test(self, x, generator=None, noise=None):
        """Eval-mode encode, one latent sample, decode: the
        reconstruction of x (N, 1, 28, 28). The module's mode is restored
        afterwards."""
        was = self.training
        self.eval()
        try:
            xrec, _, _ = self(x, generator, noise)
        finally:
            self.train(was)
        return xrec
