from vae_gp_ode_tpu_torch.native.build import (  # noqa: F401
    load_library, native_available, rotate_bilinear, make_rot_sequences,
    rotate_batch,
)
