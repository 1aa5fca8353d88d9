from vae_gp_ode_tpu_torch.models.vae import (  # noqa: F401
    Encoder, Decoder, VAE, bernoulli_log_prob,
)
from vae_gp_ode_tpu_torch.models.odegpvae import (  # noqa: F401
    ODEGPVAE, init_model,
)
