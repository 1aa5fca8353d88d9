"""Convolutional VAE encoder/decoder (port of `vae_gp_ode_tpu/models/vae.py`).

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
from torch import nn
from torch.nn import functional as F

from vae_gp_ode_tpu_torch.core.settings import BERNOULLI_EPS


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` (same parameters, buffers and eval mode) whose
    train mode updates `running_var` with the biased batch variance, as
    flax does. The update runs in place under no_grad, also for
    `torch.no_grad()` callers (the per-epoch monitoring eval).
    `num_batches_tracked` stays 0: with a fixed momentum nothing reads it,
    and flax keeps no such count."""

    def __init__(self, num_features):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
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
