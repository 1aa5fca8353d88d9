"""ODEGPVAE: the top-level sequence model (port of
`vae_gp_ode_tpu/models/odegpvae.py`).

  1. encode frame 0 into q(z0) and reparameterise (plus a velocity encoder
     over the first `frames` frames for 2nd-order ODEs),
  2. draw L pathwise GP samples as one batch of draws and integrate the L
     latent trajectories as one batch (`solver`, `dense`, `rtol`, `atol`,
     `max_steps`, `remat`; `use_adjoint` for the continuous adjoint),
  3. decode all L*N*T latent states in one batched decoder call.

Sequences are (N, T, 1, d, d), NCHW frames. Randomness comes from a
`torch.Generator` or from an injected noise dict with the raw draws
{'z0', 'v0' (order 2), 'omega', 'phase_u', 'weights', 'epsilon'}, the
GP draws with a leading dim of L.
"""

import copy
from typing import Optional

import numpy as np
import torch
from torch import nn

from vae_gp_ode_tpu_torch.core.device import resolve_device
from vae_gp_ode_tpu_torch.dynamics.adjoint import flow_forward_adjoint
from vae_gp_ode_tpu_torch.dynamics.flow import flow_forward
from vae_gp_ode_tpu_torch.dynamics.solvers import SOLVERS
from vae_gp_ode_tpu_torch.gp.svgp import (
    SVGPParams, draw_fn_sample, init_svgp_params,
)
from vae_gp_ode_tpu_torch.models.vae import Encoder, Decoder, reparam_sample

_GP_NOISE = ('omega', 'phase_u', 'weights', 'epsilon')


class ODEGPVAE(nn.Module):
    """The VAE is this module's parameters; the GP parameters are a
    separate `SVGPParams` passed to `forward`.

    `dtype`: the VAE's compute type (JAX `models/odegpvae.py`
    `ODEGPVAE.dtype`): None computes in float32; torch.bfloat16 runs the
    encoders and the decoder in bf16 (the weights stay float32), while
    `encode` upcasts the latent statistics to float32 before the
    reparameterisation, so z0, the GP, the ODE and the trajectories stay
    float32, and the frames come out in bf16."""

    def __init__(self, latent_dim=6, n_filt=8, order=1, frames=5, dt=0.1,
                 solver='euler', dense=1, rtol=1e-6, atol=1e-6,
                 max_steps=256, num_features=256, use_adjoint=False,
                 remat=True, dtype=None, device='cuda'):
        super().__init__()
        dev = resolve_device(device)
        if order not in (1, 2):
            raise ValueError(f'ODE order must be 1 or 2, got {order}')
        if solver not in SOLVERS:
            raise ValueError(f'unknown solver {solver!r}; choose from '
                             f'{SOLVERS}')
        self.latent_dim = latent_dim
        self.n_filt = n_filt
        self.order = order
        self.frames = frames
        self.dt = dt
        self.solver = solver
        self.dense = dense
        self.rtol = rtol
        self.atol = atol
        self.max_steps = max_steps
        self.num_features = num_features
        self.use_adjoint = use_adjoint    # continuous adjoint vs backprop
        self.remat = remat                # rematerialise solver steps
        self.dtype = dtype
        self.encoder = Encoder(latent_dim, n_filt, frames=1, dtype=dtype)
        self.decoder = Decoder(latent_dim, n_filt, dtype=dtype)
        if order == 2:
            self.encoder_v = Encoder(latent_dim, n_filt, frames=frames,
                                     dtype=dtype)
        self.to(dev)

    @property
    def device(self):
        return self.decoder.fc.weight.device

    def with_dtype(self, dtype):
        """A copy of the model whose VAE computes in `dtype` (flax's
        `clone(dtype=)`); its weights are copies of this model's."""
        twin = copy.deepcopy(self)
        twin.dtype = dtype
        for vae in (twin.encoder, twin.decoder,
                    getattr(twin, 'encoder_v', None)):
            if vae is not None:
                vae.dtype = dtype
        return twin

    def _dynamics_type(self, stats):
        """Latent statistics in float32 where the VAE computes in another
        type (`dtype`), as they come otherwise."""
        return stats if self.dtype is None else tuple(t.float()
                                                      for t in stats)

    def encode(self, X, generator=None, reparam_noise=None):
        """Encode sequences (N, T, 1, d, d) into z0 (N, q or 2q).

        `reparam_noise` = (noise_s, noise_v) injects the standard-normal
        reparameterisation draws (noise_v only for order 2).
        """
        s0_mu, s0_logv = self._dynamics_type(self.encoder(X[:, 0]))
        noise_s, noise_v = (reparam_noise if reparam_noise is not None
                            else (None, None))
        z0 = reparam_sample(generator, s0_mu, s0_logv, noise_s)
        v0_mu = v0_logv = None
        if self.order == 2:
            # first `frames` frames stacked as channels
            v0_mu, v0_logv = self._dynamics_type(
                self.encoder_v(X[:, :self.frames, 0]))
            v0 = reparam_sample(generator, v0_mu, v0_logv, noise_v)
            z0 = torch.cat([z0, v0], dim=1)
        return z0, (s0_mu, s0_logv), (v0_mu, v0_logv)

    def sample_trajectories(self, gp: SVGPParams, z0, T: int, L: int,
                            generator=None, noise: Optional[dict] = None):
        """Integrate L trajectories, each under a fresh GP function draw;
        the L draws are one batch. Returns ztL (L, N, T, D) and the total
        number of RHS evaluations (a device tensor for the adaptive
        solvers)."""
        ts = self.dt * torch.arange(T, dtype=z0.dtype, device=z0.device)
        if noise is not None:
            noise = {k: noise[k] for k in _GP_NOISE}
            for k, v in noise.items():
                if v.shape[0] != L:
                    raise ValueError(f'noise[{k!r}] has {v.shape[0]} draws, '
                                     f'expected L={L}')
        sample = draw_fn_sample(gp, generator, self.num_features,
                                noise=noise, L=L)
        kw = dict(order=self.order, solver=self.solver, dense=self.dense,
                  rtol=self.rtol, atol=self.atol, max_steps=self.max_steps,
                  device=z0.device)
        if self.use_adjoint:
            return flow_forward_adjoint(gp, sample, z0, ts, **kw)
        return flow_forward(gp, sample, z0, ts, remat=self.remat, **kw)

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


#: std of a standard normal truncated to [-2, 2] (flax's lecun_normal
#: divides by it so the truncated draw keeps variance 1/fan_in)
_TRUNC_STD = 0.87962566103423978


def _truncated_normal(rng, shape, std):
    """Normal(0, std^2) draws truncated to two standard deviations and
    rescaled to keep std (jax.nn.initializers.variance_scaling with
    'truncated_normal')."""
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2.0
    return x * (std / _TRUNC_STD)


def _fan_in(mod):
    """Fan-in of the flax kernel that `mod` stands for: flax Conv and
    ConvTranspose kernels are (kH, kW, in, out), Dense (in, out)."""
    w = mod.weight
    if isinstance(mod, nn.ConvTranspose2d):          # (in, out, kH, kW)
        return w.shape[0] * w.shape[2] * w.shape[3]
    return w[0].numel()                              # (out, in[, kH, kW])


def init_weights(model, rng, random_bn=False):
    """Initialise the VAE as flax's defaults do: lecun_normal kernels
    (truncated normal, variance 1/fan_in), zero biases, BatchNorm scale 1,
    bias 0, running mean 0 and variance 1. With `random_bn`, BatchNorm
    scale, bias and running statistics are drawn instead (scale ~1, bias
    and mean ~0, variance 0.5..1.5), so eval-mode BatchNorm is not the
    identity. Draws come from the numpy Generator `rng`."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = mod.weight
            with torch.no_grad():
                w.copy_(torch.as_tensor(_truncated_normal(
                    rng, tuple(w.shape), 1.0 / np.sqrt(_fan_in(mod)))))
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            C = mod.num_features
            with torch.no_grad():
                if random_bn:
                    mod.weight.copy_(torch.as_tensor(
                        1.0 + 0.1 * rng.standard_normal(C)))
                    mod.bias.copy_(torch.as_tensor(
                        0.1 * rng.standard_normal(C)))
                    mod.running_mean.copy_(torch.as_tensor(
                        0.1 * rng.standard_normal(C)))
                    mod.running_var.copy_(torch.as_tensor(
                        rng.uniform(0.5, 1.5, C)))
                else:
                    mod.reset_parameters()


def init_model(seed=0, *, latent_dim=6, n_filt=8, order=1, frames=5,
               dt=0.1, solver='euler', dense=1, rtol=1e-6, atol=1e-6,
               max_steps=256, num_features=256, num_inducing=100,
               kernel='RBF', q_diag=False, dimwise=True, lengthscale=0.2,
               variance=0.1, random_bn=False, use_adjoint=False, remat=True,
               device='cuda'):
    """Build (model, gp) as the JAX package's `init_model` does, from the
    numpy seed `seed`: flax-default VAE initialisers (see `init_weights`;
    `random_bn=True` draws non-trivial BatchNorm statistics), and a GP
    (`kernel` 'RBF' with dimwise or, `dimwise=False`, shared
    lengthscales, or 'DF', which takes the dimwise layout and needs order
    1, since its inputs and outputs have one width) that maps q*order
    inputs to q outputs with
    inducing_loc ~ N(0, 1), Um ~ 0.1 N(0, 1), Us_sqrt = 1e-3 I and the
    kernel at `lengthscale`/`variance` (the JAX package's 0.2/0.1; the
    training CLI then sets its own, as `main.py` does). The solver
    settings are the model's fields (`ODEGPVAE`).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    model = ODEGPVAE(latent_dim=latent_dim, n_filt=n_filt, order=order,
                     frames=frames, dt=dt, solver=solver, dense=dense,
                     rtol=rtol, atol=atol, max_steps=max_steps,
                     num_features=num_features, use_adjoint=use_adjoint,
                     remat=remat, device='cpu')
    init_weights(model, rng, random_bn=random_bn)
    gp = init_svgp_params(rng, latent_dim * order, latent_dim, num_inducing,
                          kernel=kernel, q_diag=q_diag, dimwise=dimwise,
                          lengthscale=lengthscale, variance=variance)
    return model.to(dev), gp.to(dev)
