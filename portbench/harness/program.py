"""The system under test: the port's train state, train segment and
forecaster, built on the inputs the benchmark made, as the port's entry
points build them (`main.run()` for training, `serving.make_forecast_fn`
for forecasts). Nothing else of the port is used here but its launch
counters."""

import os

import torch

def load():
    """Import the port's modules that the modes drive."""
    import vae_gp_ode_tpu_torch.serving  # noqa: F401
    import vae_gp_ode_tpu_torch.training.trainer  # noqa: F401


def _model(cfg, device):
    from vae_gp_ode_tpu_torch.models.odegpvae import ODEGPVAE
    return ODEGPVAE(latent_dim=cfg['latent_dim'], n_filt=cfg['n_filt'],
                    order=cfg['ode'], dt=cfg['dt'], solver=cfg['solver'],
                    dense=cfg['ts_dense_scale'],
                    num_features=cfg['num_features'], device=device)


def _load_vae(model, P):
    """Copy the benchmark's VAE leaves into the model, name by name; every
    name of the model's state but BatchNorm's unused counters must be
    given."""
    own = model.state_dict()
    need = {n for n in own if not n.endswith('num_batches_tracked')}
    have = {n for n in P if not n.startswith('gp.')}
    if need != have:
        raise ValueError(f'the model and the benchmark disagree on the VAE '
                         f'leaves: {sorted(need ^ have)}')
    with torch.no_grad():
        for n in need:
            own[n].copy_(P[n])


def _gp(cfg, P):
    from vae_gp_ode_tpu_torch.gp.svgp import SVGPParams
    from vae_gp_ode_tpu_torch.kernels.rbf import RBFParams
    return SVGPParams(
        kernel=RBFParams(
            unconstrained_lengthscales=P[
                'gp.kernel.unconstrained_lengthscales'].clone(),
            unconstrained_variance=P['gp.kernel.unconstrained_variance']
            .clone()),
        inducing_loc=P['gp.inducing_loc'].clone(), Um=P['gp.Um'].clone(),
        Us_sqrt=P['gp.Us_sqrt'].clone(), q_diag=False,
        kernel_name=cfg['kernel'])


def train_state(cfg, root, state, device):
    """The port's TrainState: from the benchmark's leaves for a fresh
    model, or through the port's own reader of the run's checkpoint."""
    from vae_gp_ode_tpu_torch.training import trainer
    if cfg['weights'] == 'checkpoint':
        from vae_gp_ode_tpu_torch.models.odegpvae import init_model
        from vae_gp_ode_tpu_torch.training.checkpoint import (
            restore_jax_checkpoint)
        model, gp = init_model(
            0, latent_dim=cfg['latent_dim'], n_filt=cfg['n_filt'],
            order=cfg['ode'], dt=cfg['dt'], solver=cfg['solver'],
            dense=cfg['ts_dense_scale'], num_features=cfg['num_features'],
            num_inducing=cfg['num_inducing'], kernel=cfg['kernel'],
            lengthscale=cfg['lengthscale'], variance=cfg['variance'],
            device=device)
        st = trainer.create_train_state(model, gp, lr=cfg['lr'])
        return restore_jax_checkpoint(
            os.path.join(root, cfg['run_dir'], 'odegpvae_mnist.ckpt'), st)
    model = _model(cfg, device)
    _load_vae(model, state['params'])
    return trainer.create_train_state(model, _gp(cfg, state['params']),
                                      lr=cfg['lr'])


def train_segment(cfg):
    """`make_train_segment` as `main.run()` makes it."""
    from vae_gp_ode_tpu_torch.training.trainer import make_train_segment
    return make_train_segment(num_observations=cfg['Ndata'],
                              eps_guard=cfg['eps_guard'])


def leaves(st):
    """{name: tensor} of the optimised leaves of a TrainState, and of
    Adam's first moments by the same names."""
    names = st.param_names()
    mu, _ = st.optimizer.moments()
    return dict(zip(names, st.params())), dict(zip(names, mu))


def forecaster(cfg, root, state, L, device):
    """`make_forecast_fn` of the configuration's model: a trained run
    through `serving.load_run_dir`, else the benchmark's leaves."""
    from vae_gp_ode_tpu_torch import serving
    if cfg['weights'] == 'checkpoint':
        model, st, _ = serving.load_run_dir(os.path.join(root, cfg['run_dir']),
                                            device=device)
        gp = st.gp
    else:
        model = _model(cfg, device)
        _load_vae(model, state['params'])
        gp = _gp(cfg, state['params'])
    return serving.make_forecast_fn(model, None, gp, L=L, mc_reduce='none',
                                    device=device)


def launches():
    """The port's kernel launch counters."""
    from vae_gp_ode_tpu_torch.ops import LAUNCHES
    return dict(LAUNCHES)
