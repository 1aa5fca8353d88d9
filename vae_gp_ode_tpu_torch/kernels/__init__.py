from vae_gp_ode_tpu_torch.kernels.rbf import (  # noqa: F401
    RBFParams,
    RFFState,
    init_rbf_params,
    rbf_lengthscales,
    rbf_variance,
    rbf_gram,
    rbf_sample_rff,
    rbf_rff_eval,
    rbf_compute_nu,
    rbf_f_update,
)
