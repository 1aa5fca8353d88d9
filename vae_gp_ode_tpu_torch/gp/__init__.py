from vae_gp_ode_tpu_torch.gp.svgp import (  # noqa: F401
    SVGPParams,
    FnSample,
    init_svgp_params,
    sample_inducing,
    draw_fn_sample,
    fn_eval,
    fn_jacobian,
    svgp_kl,
    svgp_conditional,
)
