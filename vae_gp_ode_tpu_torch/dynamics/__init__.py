from vae_gp_ode_tpu_torch.dynamics.solvers import (  # noqa: F401
    odeint, ODESolution, FIXED_STEP_SOLVERS, ADAPTIVE_SOLVERS, SOLVERS,
)
from vae_gp_ode_tpu_torch.dynamics.flow import (  # noqa: F401
    make_ode_rhs, flow_forward, flow_kl,
)
from vae_gp_ode_tpu_torch.dynamics.adjoint import (  # noqa: F401
    odeint_adjoint, flow_forward_adjoint,
)
