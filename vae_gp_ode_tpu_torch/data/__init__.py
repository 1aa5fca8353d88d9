from vae_gp_ode_tpu_torch.data.mnist import (  # noqa: F401
    Loader, rot_start, load_mnist_data, load_data,
)
