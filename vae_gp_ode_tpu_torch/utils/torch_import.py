"""Read the reference's own PyTorch checkpoints into the port (port of
`vae_gp_ode_tpu/utils/torch_import.py`).

The reference saves its pretrained encoder and decoder as `encoder.pt` and
`decoder.pt` (their modules' state dicts) and a trained model as
`odegpvae_mnist.pth`. The port's `models.vae` keeps the reference's module
names (`cnn.*`, `decnn.*`, `fc`) and PyTorch's layouts, so the VAE's
tensors load as they are, after a check of every name and shape
(`training.checkpoint.load_state_checked`). The GP's leaves are the
reference's `flow.odefunc.diffeq.*` parameters: `kern.*` and the `optvar`
of `inducing_loc`, `Um` and `Us_sqrt`, whose LowerTriangular packing of
q(u)'s scale (row-major `tril_indices`) is the port's own. Files are read
with `weights_only=True`: no code in them runs.
"""

import torch

from vae_gp_ode_tpu_torch.training.checkpoint import load_state_checked

#: the reference's GP parameter names under `flow.odefunc.diffeq.`, by the
#: port's `SVGPParams.LEAVES`
_GP_KEYS = {
    'kernel.unconstrained_lengthscales': 'kern.unconstrained_lengthscales',
    'kernel.unconstrained_variance': 'kern.unconstrained_variance',
    'inducing_loc': 'inducing_loc.optvar', 'Um': 'Um.optvar',
    'Us_sqrt': 'Us_sqrt.optvar'}


def load_torch_checkpoint(path):
    """A .pt/.pth state dict, as CPU tensors (`weights_only=True`)."""
    return torch.load(path, map_location='cpu', weights_only=True)


def vae_from_torch(model, encoder_sd, decoder_sd):
    """Load the reference's encoder and decoder state dicts (its
    `encoder.pt`/`decoder.pt`) into `model.encoder` and `model.decoder`,
    in place, after checking every name and shape; returns `model`."""
    load_state_checked(model.encoder, encoder_sd, 'encoder')
    load_state_checked(model.decoder, decoder_sd, 'decoder')
    return model


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


def odegpvae_from_torch(sd, model, gp, prefix='flow.odefunc.diffeq'):
    """Load a reference `odegpvae_mnist.pth` state dict into `model` (an
    `ODEGPVAE`: `vae.encoder.*`, `vae.decoder.*` and, for an order-2
    model where the file has them, `vae.encoder_v.*`) and `gp` (its
    `SVGPParams`: the GP leaves under `prefix`), in place, after checking
    every name and shape; other keys are ignored. Returns (model, gp)."""
    leaves = {}
    for name, p in gp.named_parameters():
        key = f'{prefix}.{_GP_KEYS[name]}'
        if key not in sd:
            raise ValueError(f'the state dict has no {key}')
        t = torch.as_tensor(sd[key])
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f'{key} has shape {tuple(t.shape)} in the file, '
                             f'{tuple(p.shape)} in the GP')
        leaves[name] = t
    vae_from_torch(model, _sub(sd, 'vae.encoder.'), _sub(sd, 'vae.decoder.'))
    velocity = _sub(sd, 'vae.encoder_v.')
    if model.order == 2 and velocity:
        load_state_checked(model.encoder_v, velocity, 'encoder_v')
    with torch.no_grad():
        for name, p in gp.named_parameters():
            p.copy_(leaves[name])
    return model, gp
