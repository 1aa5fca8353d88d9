from vae_gp_ode_tpu_torch.dynamics.flow import (  # noqa: F401
    make_ode_rhs, flow_forward,
)
