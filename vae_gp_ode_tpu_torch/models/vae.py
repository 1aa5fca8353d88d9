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

BatchNorm: torch momentum 0.1 (flax 0.9), eps 1e-5. Eval mode
(`module.eval()`) normalises with the running statistics.
"""

import torch
from torch import nn

from vae_gp_ode_tpu_torch.core.settings import BERNOULLI_EPS


class Encoder(nn.Module):
    def __init__(self, latent_dim=16, n_filt=8, frames=1):
        super().__init__()
        nf = n_filt
        self.cnn = nn.Sequential(
            nn.Conv2d(frames, nf, 5, 2, 2), nn.BatchNorm2d(nf), nn.ReLU(),
            nn.Conv2d(nf, nf * 2, 5, 2, 2), nn.BatchNorm2d(nf * 2),
            nn.ReLU(),
            nn.Conv2d(nf * 2, nf * 4, 5, 2, 2), nn.ReLU(), nn.Flatten())
        self.fc = nn.Linear(nf * 4 ** 3, 2 * latent_dim)

    def forward(self, x):
        """x: (N, frames, 28, 28) -> (mu, logvar), each (N, latent_dim)."""
        mu, logvar = self.fc(self.cnn(x)).chunk(2, dim=-1)
        return mu, logvar


class Decoder(nn.Module):
    def __init__(self, latent_dim=16, n_filt=8):
        super().__init__()
        nf = n_filt
        self.fc = nn.Linear(latent_dim, nf * 4 ** 3)
        self.decnn = nn.Sequential(
            nn.Unflatten(1, (nf * 4, 4, 4)),
            nn.ConvTranspose2d(nf * 4, nf * 8, 3, 1, 0),
            nn.BatchNorm2d(nf * 8), nn.ReLU(),
            nn.ConvTranspose2d(nf * 8, nf * 4, 5, 2, 1),
            nn.BatchNorm2d(nf * 4), nn.ReLU(),
            nn.ConvTranspose2d(nf * 4, nf * 2, 5, 2, 1, output_padding=1),
            nn.BatchNorm2d(nf * 2), nn.ReLU(),
            nn.ConvTranspose2d(nf * 2, 1, 5, 1, 2), nn.Sigmoid())

    def forward(self, z):
        """z: (B, latent_dim) -> (B, 1, 28, 28) sigmoid images."""
        return self.decnn(self.fc(z))


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
