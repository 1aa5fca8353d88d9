"""Global numeric settings (port of `vae_gp_ode_tpu/core/settings.py`)."""

#: jitter added to gram diagonals before Cholesky
JITTER = 1e-5

#: lower bound added by the softplus constraint
SOFTPLUS_LOWER = 1e-12

#: epsilon used in the guarded Bernoulli log-prob
BERNOULLI_EPS = 1e-3
