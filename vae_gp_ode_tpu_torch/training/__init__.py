from vae_gp_ode_tpu_torch.training.objectives import (  # noqa: F401
    elbo_terms, compute_loss, compute_test_error,
)
