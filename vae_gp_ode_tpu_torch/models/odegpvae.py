"""ODEGPVAE: the top-level sequence model (port of
`vae_gp_ode_tpu/models/odegpvae.py`).

  1. encode frame 0 into q(z0) and reparameterise (plus a velocity encoder
     over the first `frames` frames for 2nd-order ODEs),
  2. draw L pathwise GP samples as one batch of draws and integrate the L
     latent trajectories in one fused-kernel launch,
  3. decode all L*N*T latent states in one batched decoder call.

Sequences are (N, T, 1, d, d), NCHW frames. Randomness comes from a
`torch.Generator` or from an injected noise dict with the raw draws
{'z0', 'v0' (order 2), 'omega', 'phase_u', 'weights', 'epsilon'}, the
GP draws with a leading dim of L.
"""

from typing import Optional

import numpy as np
import torch
from torch import nn

from vae_gp_ode_tpu_torch.core.device import resolve_device
from vae_gp_ode_tpu_torch.dynamics.flow import flow_forward
from vae_gp_ode_tpu_torch.gp.svgp import (
    SVGPParams, draw_fn_sample, init_svgp_params,
)
from vae_gp_ode_tpu_torch.models.vae import Encoder, Decoder, reparam_sample

_GP_NOISE = ('omega', 'phase_u', 'weights', 'epsilon')


class ODEGPVAE(nn.Module):
    """The VAE is this module's parameters; the GP parameters are a
    separate `SVGPParams` passed to `forward`."""

    def __init__(self, latent_dim=6, n_filt=8, order=1, frames=5, dt=0.1,
                 num_features=256, device='cuda'):
        super().__init__()
        dev = resolve_device(device)
        if order not in (1, 2):
            raise ValueError(f'ODE order must be 1 or 2, got {order}')
        self.latent_dim = latent_dim
        self.n_filt = n_filt
        self.order = order
        self.frames = frames
        self.dt = dt
        self.num_features = num_features
        self.encoder = Encoder(latent_dim, n_filt, frames=1)
        self.decoder = Decoder(latent_dim, n_filt)
        if order == 2:
            self.encoder_v = Encoder(latent_dim, n_filt, frames=frames)
        self.to(dev)

    @property
    def device(self):
        return self.decoder.fc.weight.device

    def encode(self, X, generator=None, reparam_noise=None):
        """Encode sequences (N, T, 1, d, d) into z0 (N, q or 2q).

        `reparam_noise` = (noise_s, noise_v) injects the standard-normal
        reparameterisation draws (noise_v only for order 2).
        """
        s0_mu, s0_logv = self.encoder(X[:, 0])
        noise_s, noise_v = (reparam_noise if reparam_noise is not None
                            else (None, None))
        z0 = reparam_sample(generator, s0_mu, s0_logv, noise_s)
        v0_mu = v0_logv = None
        if self.order == 2:
            # first `frames` frames stacked as channels
            v0_mu, v0_logv = self.encoder_v(X[:, :self.frames, 0])
            v0 = reparam_sample(generator, v0_mu, v0_logv, noise_v)
            z0 = torch.cat([z0, v0], dim=1)
        return z0, (s0_mu, s0_logv), (v0_mu, v0_logv)

    def sample_trajectories(self, gp: SVGPParams, z0, T: int, L: int,
                            generator=None, noise: Optional[dict] = None):
        """Integrate L trajectories, each under a fresh GP function draw;
        the L draws are one batch. Returns ztL (L, N, T, D) and the total
        number of RHS evaluations."""
        ts = self.dt * torch.arange(T, dtype=z0.dtype, device=z0.device)
        if noise is not None:
            noise = {k: noise[k] for k in _GP_NOISE}
            for k, v in noise.items():
                if v.shape[0] != L:
                    raise ValueError(f'noise[{k!r}] has {v.shape[0]} draws, '
                                     f'expected L={L}')
        sample = draw_fn_sample(gp, generator, self.num_features,
                                noise=noise, L=L)
        return flow_forward(gp, sample, z0, ts, order=self.order,
                            device=z0.device)

    def decode(self, ztL):
        """Decode latent trajectories (L, N, T, D) -> (L, N, T, 1, d, d);
        2nd order decodes only the position half."""
        L, N, T = ztL.shape[:3]
        if self.order == 2:
            ztL = ztL[..., :self.latent_dim]
        imgs = self.decoder(ztL.reshape(L * N * T, ztL.shape[-1]))
        return imgs.reshape((L, N, T) + imgs.shape[1:])

    def forward(self, X, gp: SVGPParams, L: int = 1,
                T_custom: Optional[int] = None, generator=None,
                noise: Optional[dict] = None):
        """Full forward pass. BatchNorm follows the module's mode (train()
        or eval()).

        @return: Xrec (L, N, T, 1, d, d), (s0_mu, s0_logv),
                 (v0_mu, v0_logv), nfe
        """
        T = X.shape[1] if T_custom is None else T_custom
        reparam = None
        if noise is not None:
            reparam = (noise['z0'], noise.get('v0'))
        z0, s_stats, v_stats = self.encode(X, generator,
                                           reparam_noise=reparam)
        ztL, nfe = self.sample_trajectories(gp, z0, T, L, generator,
                                            noise=noise)
        return self.decode(ztL), s_stats, v_stats, nfe


def _init_weights(model, rng):
    """Overwrite every parameter and BatchNorm statistic with draws from
    the numpy Generator `rng`, at scales that keep activations O(1)."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = mod.weight
            fan_in = w[0].numel()
            if isinstance(mod, nn.ConvTranspose2d):
                fan_in = w.shape[0] * w[0, 0].numel() / mod.stride[0] ** 2
            with torch.no_grad():
                w.copy_(torch.as_tensor(
                    rng.standard_normal(w.shape) / np.sqrt(fan_in)))
                mod.bias.copy_(torch.as_tensor(
                    rng.standard_normal(mod.bias.shape) * 0.1))
        elif isinstance(mod, nn.BatchNorm2d):
            C = mod.num_features
            with torch.no_grad():
                mod.weight.copy_(torch.as_tensor(
                    1.0 + 0.1 * rng.standard_normal(C)))
                mod.bias.copy_(torch.as_tensor(0.1 * rng.standard_normal(C)))
                mod.running_mean.copy_(torch.as_tensor(
                    0.1 * rng.standard_normal(C)))
                mod.running_var.copy_(torch.as_tensor(
                    rng.uniform(0.5, 1.5, C)))


def init_model(seed=0, *, latent_dim=6, n_filt=8, order=1, frames=5,
               dt=0.1, num_features=256, num_inducing=100, q_diag=False,
               lengthscale=0.2, variance=0.1, device='cuda'):
    """Build (model, gp) at the given widths with random weights and a
    random dimwise-RBF GP drawn from numpy with `seed`, wired as the
    reference wires it: the GP maps q*order inputs to q outputs.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    model = ODEGPVAE(latent_dim=latent_dim, n_filt=n_filt, order=order,
                     frames=frames, dt=dt, num_features=num_features,
                     device='cpu')
    _init_weights(model, rng)
    gp = init_svgp_params(rng, latent_dim * order, latent_dim, num_inducing,
                          q_diag=q_diag, lengthscale=lengthscale,
                          variance=variance)
    return model.to(dev), gp.to(dev)
