"""Serving: the eval-mode forecaster and a trained run's state (port of
`make_forecast_fn` and `load_run_dir` of `vae_gp_ode_tpu/serving.py`; the
artifact export is not ported yet, ROADMAP Queue A [A14]).
"""

import json
import os
import types

import torch

from vae_gp_ode_tpu_torch.core.device import resolve_device

#: rot-MNIST normalisation (reference data/utils.py)
MNIST_MEAN = 0.1307
MNIST_STD = 0.3081


def make_forecast_fn(model, params, gp, *, L=1, T_custom=None,
                     mc_reduce='none', normalize_input=False, solver=None,
                     dense=None, rtol=None, atol=None, max_steps=None,
                     device='cuda'):
    """Close a trained (model, params, gp) over ``fn(X, seed) -> Xrec``.

    params: a state dict for `model` (e.g. from utils.jax_import.from_jax),
    or None to keep the model's own weights. gp: the SVGP of either kernel
    (RBF with dimwise or shared lengthscales, or DF as in a run restored by
    `training.checkpoint.restore_jax_checkpoint`). The model and gp move to
    `device` (default the GPU; raises if it is absent) and the model is
    put in eval mode: BatchNorm uses its running statistics.

    X: (N, T, 1, d, d) sequences in the model's input normalisation, or
    raw [0, 1] pixels with normalize_input=True, which applies
    ``(x - 0.1307) / 0.3081`` first.
    seed: an int; seeds the `torch.Generator` on the device that draws the
    z0 reparameterisation and the L pathwise GP functions. `noise=` (the
    model's noise dict) replaces those draws, for parity tests.

    mc_reduce: 'none' -> Xrec (L, N, T, 1, d, d), all MC samples;
               'mean' -> Xrec (N, T, 1, d, d), their mean.

    solver, dense, rtol, atol, max_steps: the ODE solver settings of the
    forecast (None keeps the model's own), as the JAX package's
    `make_forecast_fn` takes them; the model's fields are set to them.
    """
    if mc_reduce not in ('none', 'mean'):
        raise ValueError(f'mc_reduce must be none|mean, got {mc_reduce!r}')
    dev = resolve_device(device)
    if params is not None:
        model.load_state_dict(params)
    for name, value in (('solver', solver), ('dense', dense),
                        ('rtol', rtol), ('atol', atol),
                        ('max_steps', max_steps)):
        if value is not None:
            setattr(model, name, value)
    model.to(dev).eval()
    gp = gp.to(dev)

    def fn(X, seed, noise=None):
        X = torch.as_tensor(X, dtype=torch.float32, device=dev)
        if normalize_input:
            X = (X - MNIST_MEAN) / MNIST_STD
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(seed))
        with torch.no_grad():
            Xrec, _, _, _ = model(X, gp, L=L, T_custom=T_custom,
                                  generator=generator, noise=noise)
        if mc_reduce == 'mean':
            Xrec = torch.mean(Xrec, dim=0)
        return Xrec

    return fn


def load_run_dir(model_path, device='cuda'):
    """(model, state, args) of a training run directory: `args.json` (the
    run's flags; `dimwise` shapes the GP, `pretrained` and `fix_kernel`
    the train state) and
    `odegpvae_mnist.ckpt`, the port's own checkpoint or the JAX package's
    npz one (such as `checkpoints/df_5000ep`; the `device` its flags name
    is not read), on `device` (default the GPU; raises if it is absent).
    The dataset is not touched."""
    from vae_gp_ode_tpu_torch.models.odegpvae import init_model
    from vae_gp_ode_tpu_torch.training import checkpoint as ckpt
    from vae_gp_ode_tpu_torch.training.trainer import create_train_state

    with open(os.path.join(model_path, 'args.json')) as f:
        ta = types.SimpleNamespace(**json.load(f))
    model, gp = init_model(
        0, latent_dim=ta.latent_dim, n_filt=ta.n_filt, order=ta.ode,
        frames=ta.frames, dt=ta.dt, solver=ta.solver,
        dense=getattr(ta, 'ts_dense_scale', 1),
        num_features=ta.num_features, num_inducing=ta.num_inducing,
        kernel=ta.kernel, q_diag=ta.q_diag,
        dimwise=getattr(ta, 'dimwise', True),
        use_adjoint=getattr(ta, 'use_adjoint', False), device=device)
    state = create_train_state(
        model, gp, lr=ta.lr, fix_kernel=bool(getattr(ta, 'fix_kernel', False)),
        freeze_vae=bool(getattr(ta, 'pretrained', False)))
    path = os.path.join(model_path, 'odegpvae_mnist.ckpt')
    if ckpt.checkpoint_format(path) == 'torch':
        ckpt.restore_checkpoint(path, state)
    else:
        ckpt.restore_jax_checkpoint(path, state)
    return state.model, state, ta
