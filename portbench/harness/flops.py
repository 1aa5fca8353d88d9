"""The yardstick's arithmetic: the H100's published peaks, the
operations and bytes of the flow kernels, and the float32 operations of
a train step and a forecast counted from their shapes.

The flow kernels' counts are copies of the port's own arithmetic
(`chip_smoke.py` `flow_bound`, `flow_bwd_bound`, `df_eval_flops`,
`df_vjp_flops`, `roofline`), kept here so that the yardstick does not
move with the program; bytes count each input read once and each output
written once, from the shapes of the kernels' operand blocks.
"""

#: NVIDIA H100 SXM data sheet: dense float32 outside the tensor cores
#: (the port turns TF32 off), and HBM3 bandwidth, at the 700 W limit
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def roofline_s(flops, nbytes):
    """Least time (s): the larger of flops over the float32 peak and
    bytes over the memory rate."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def _rbf_operand_elems(L, D, K, S, M):
    """Elements of the RBF kernels' packed operands (omf, phf, ws per
    draw; Zb, zn, il2 shared; nus per draw)."""
    return L * (D * K * S + 2 * K * S + K * M) + 2 * D * K * M + K * M


def _df_operand_elems(L, D, S, M):
    """Elements of the DF kernels' operands (omf, phf, G, nur per draw;
    Z, ls2, var shared), SD = S * D feature columns."""
    SD = S * D
    return L * (D * SD + SD + 2 * SD * D + M * D) + M * D + D * D + D


def rbf_flow_fwd(L, N, D, K, S, M, T):
    """(flops, bytes) of one launch of the RBF euler trajectory kernel."""
    per_row_step = K * S * (2 * D + 4) + K * M * (4 * D + 7) + 2 * D
    flops = L * N * (T - 1) * per_row_step
    nbytes = 4 * (_rbf_operand_elems(L, D, K, S, M) + N * D + (T - 1)
                  + L * T * N * D)
    return flops, nbytes


def rbf_flow_bwd(L, N, D, K, S, M, T):
    """(flops, bytes) of one call of the RBF trajectory's adjoint (its
    kernel and the kernel that sums its slabs): recompute and VJP per row
    and step K*S*(6D+12) + K*M*(12D+16); reads the trajectory, its
    cotangent and the operands, writes the cotangents of z0 and of the
    operands."""
    per_row_step = K * S * (6 * D + 12) + K * M * (12 * D + 16)
    flops = L * N * (T - 1) * per_row_step
    ops = _rbf_operand_elems(L, D, K, S, M)
    nbytes = 4 * (2 * L * T * N * D + 2 * ops + (T - 1) + L * N * D)
    return flops, nbytes


def df_eval_flops(D, SD, M):
    """float32 operations of one DF evaluation per row: per feature
    column the dot product and phase (2D + 1), sin and cos (2) and the G
    contraction (4D); per inducing point the distance (3D) and per
    output-dim pair the envelope, the Hessian term and the accumulation
    (~12)."""
    return SD * (6 * D + 3) + M * (3 * D + 12 * D * D)


def df_vjp_flops(D, SD, M):
    """float32 operations of one DF evaluation's recompute and VJP per
    row: per feature column SD * (17 D + 6), per inducing point
    M * (8 D + 42 D^2)."""
    return SD * (17 * D + 6) + M * (8 * D + 42 * D * D)


def df_flow_fwd(L, N, D, S, M, T):
    flops = L * N * (T - 1) * (df_eval_flops(D, S * D, M) + 2 * D)
    nbytes = 4 * (_df_operand_elems(L, D, S, M) + N * D + (T - 1)
                  + L * T * N * D)
    return flops, nbytes


def df_flow_bwd(L, N, D, S, M, T):
    flops = L * N * (T - 1) * df_vjp_flops(D, S * D, M)
    ops = _df_operand_elems(L, D, S, M)
    nbytes = 4 * (2 * L * T * N * D + 2 * ops + (T - 1) + L * N * D)
    return flops, nbytes


def flow_fwd(cfg, L, N, T):
    D, S, M = cfg['latent_dim'], cfg['num_features'], cfg['num_inducing']
    if cfg['kernel'] == 'DF':
        return df_flow_fwd(L, N, D, S, M, T)
    return rbf_flow_fwd(L, N, D, D, S, M, T)


def flow_bwd(cfg, L, N, T):
    D, S, M = cfg['latent_dim'], cfg['num_features'], cfg['num_inducing']
    if cfg['kernel'] == 'DF':
        return df_flow_bwd(L, N, D, S, M, T)
    return rbf_flow_bwd(L, N, D, D, S, M, T)


# -- the whole step ----------------------------------------------------------

def _conv(cin, cout, k, hout):
    return 2 * cin * cout * k * k * hout * hout


def _conv_t(cin, cout, k, hin):
    return 2 * cin * cout * k * k * hin * hin


def encoder_flops(nf, q):
    """Forward float32 operations of the encoder per frame (28 -> 14 ->
    7 -> 4, then the dense layer)."""
    return (_conv(1, nf, 5, 14) + _conv(nf, 2 * nf, 5, 7)
            + _conv(2 * nf, 4 * nf, 5, 4) + 2 * 4 * nf * 16 * 2 * q)


def decoder_flops(nf, q):
    """Forward float32 operations of the decoder per frame (dense, then
    transposed convolutions 4 -> 6 -> 13 -> 28 -> 28)."""
    return (2 * q * 4 * nf * 16 + _conv_t(4 * nf, 8 * nf, 3, 4)
            + _conv_t(8 * nf, 4 * nf, 5, 6) + _conv_t(4 * nf, 2 * nf, 5, 13)
            + _conv_t(2 * nf, 1, 5, 28))


def gp_draw_flops(cfg, L):
    """float32 operations of the L pathwise draws: the gram's Cholesky
    (per output dim for RBF, one (M D)^2 for DF), two triangular solves
    per draw and the prior at the inducing points."""
    D, S, M = cfg['latent_dim'], cfg['num_features'], cfg['num_inducing']
    n = M * D if cfg['kernel'] == 'DF' else M
    chol = (n ** 3 / 3) * (1 if cfg['kernel'] == 'DF' else D)
    solves = 2 * L * n * n * (1 if cfg['kernel'] == 'DF' else D)
    feats = 2 * S * D if cfg['kernel'] == 'DF' else S * D
    prior = L * M * feats * (2 * D + 4)
    return chol + solves + prior


def forward_flops(cfg, L, N, T):
    """float32 operations of one forward pass over N sequences of T
    frames with L draws: encoder on the first frames, the draws, the
    flow and the decoder over L N T frames."""
    nf, q = cfg['n_filt'], cfg['latent_dim']
    return (N * encoder_flops(nf, q) + gp_draw_flops(cfg, L)
            + flow_fwd(cfg, L, N, T)[0] + L * N * T * decoder_flops(nf, q))


def train_step_flops(cfg, L, N, T):
    """float32 operations of one train step: the forward pass, the
    backward pass (data and weight gradients of every convolution and
    dense layer, twice their forward; the flow's adjoint by its own
    count; the draws' backward twice their forward), and the Bernoulli
    likelihood (~10 operations a pixel)."""
    nf, q = cfg['n_filt'], cfg['latent_dim']
    vae = N * encoder_flops(nf, q) + L * N * T * decoder_flops(nf, q)
    return (3 * vae + 3 * gp_draw_flops(cfg, L) + flow_fwd(cfg, L, N, T)[0]
            + flow_bwd(cfg, L, N, T)[0] + 10 * L * N * T * 28 * 28)


# -- the work a call records ---------------------------------------------------

def work_flops(cfg, work):
    """float32 operations of one call that did `work`, a list of
    {'kind': 'train_step' or 'forward', 'L', 'N', 'T', 'count'}."""
    f = {'train_step': train_step_flops, 'forward': forward_flops}
    return sum(w['count'] * f[w['kind']](cfg, w['L'], w['N'], w['T'])
               for w in work)


def work_flow_bound_s(cfg, work):
    """Least time (s) of the flow kernels' launches of one call that did
    `work`: each forward pass launches the euler trajectory kernel once,
    each train step that and its adjoint."""
    total = 0.0
    for w in work:
        parts = [flow_fwd] + ([flow_bwd] if w['kind'] == 'train_step' else [])
        total += w['count'] * sum(
            roofline_s(*f(cfg, w['L'], w['N'], w['T'])) for f in parts)
    return total
