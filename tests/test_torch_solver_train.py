"""One full train step of the port with an ODE solver other than the
fused euler trajectory, against the JAX package on the CPU at the small
sizes of tests/test_torch_train.py (q=3, n_filt=4, S=32, M=16, N=5, T=8,
L=2), from one state with the same noise.

Tolerances as in tests/test_torch_train.py: loss and ELBO terms 1e-4
relative, gradients 1e-4 of each leaf's largest JAX gradient (the
convolution biases before a BatchNorm against their layer's weight
gradient).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from vae_gp_ode_tpu.training.objectives import compute_loss

from vae_gp_ode_tpu_torch.training import trainer
from vae_gp_ode_tpu_torch.utils.jax_import import train_state_from_jax

import test_torch_train as ttr
import torch_threads  # noqa: F401

GRAD_REL = 1e-4


def test_rk4_train_step_matches_jax():
    """One full train step's loss, ELBO terms and gradients with
    `solver='rk4'` against the JAX package's (from one state, with the
    same noise; the set-up of tests/test_torch_train.py): ELBO terms 1e-4
    relative, gradients 1e-4 of each leaf's largest."""
    model, jstate, _ = ttr._jax_state(1, seed=11)
    model = model.clone(solver='rk4')
    X = ttr._X(11)
    key = jax.random.PRNGKey(12)

    def jloss(params):
        vae_params, gp = params
        (Xrec, s, v, nfe), _ = model.apply(
            {'params': vae_params, 'batch_stats': jstate.batch_stats},
            jnp.asarray(X), gp, key, L=ttr.L, train=True,
            mutable=['batch_stats'])
        loss, nll, kl_reg, kl_u = compute_loss(
            jnp.asarray(X), Xrec, s, v, gp, ttr.NDATA, eps_guard=True)
        return loss, (nll, kl_reg, kl_u, nfe)

    (jl, jterms), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        (jstate.vae_params, jstate.gp))
    tstate = train_state_from_jax(ttr._np_state(jstate), latent_dim=ttr.Q,
                                  n_filt=ttr.NF, num_features=ttr.S,
                                  solver='rk4', device='cpu')
    assert tstate.model.solver == 'rk4' and tstate.model.remat
    tstate.model.train()
    loss, terms = trainer.loss_fn(tstate, torch.as_tensor(X), ttr.L,
                                  ttr.NDATA, True,
                                  noise=ttr._jax_noise(key, 1))
    loss.backward()
    for a, b in zip((loss,) + terms[:3], (jl,) + jterms[:3]):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-4)
    assert int(terms[3]) == int(jterms[3]) == ttr.L * (ttr.T - 1) * 4
    ref = ttr._named(*jg)
    names = tstate.param_names()
    scale = ttr._grad_scales(names, ref, tstate.model)
    for name, p in zip(names, tstate.params()):
        err = np.abs(p.grad.numpy() - ref[name]).max()
        assert err <= GRAD_REL * scale[name], (name, err, scale[name])
