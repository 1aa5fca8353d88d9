#!/usr/bin/env python3
"""Where a divergence-free (DF) rk4 train step turns non-finite after a few
steps on random pixels, on one GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 df_state_probe.py [--seeds 8]

For each seed it builds the DF model at main.py's widths with rk4, as
`chip_smoke.py`'s rk4 steps at the main widths do (`init_model(seed +
50)`), and trains it for 24 steps at L=5 on 20 sequences of random pixels
in that script's pattern (6 steps by the dispatch rule, 12 through the
single-block pair, 6 by the rule), then takes two steps at a batch of 160
sequences. It does so twice from the same state with the same draws:
through the kernels, and through the plain version on the card (autograd
through `ops.df_pathwise.df_pathwise_reference`, no kernel launched).
Before every step it records the matrix that `df_compute_nu` factors,
(K + K^T) / 2 + jitter I of the inducing points' DF gram: whether
cuSOLVER's f32 Cholesky of it succeeds on the card, and its smallest and
largest eigenvalue in float64 on the CPU; and the ratio of the largest to
the smallest DF lengthscale. After every step it records which metrics
were non-finite (the NaN guard then drops the step). One JSON line per
seed and path, then one line that counts the non-finite steps of each
path and how many of them had a gram whose f32 Cholesky failed.
"""

import argparse
import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402
from vae_gp_ode_tpu_torch import ops  # noqa: E402
from vae_gp_ode_tpu_torch.core.settings import JITTER  # noqa: E402
from vae_gp_ode_tpu_torch.kernels import divfree as dfk  # noqa: E402
from vae_gp_ode_tpu_torch.kernels.rbf import rbf_lengthscales  # noqa: E402
from vae_gp_ode_tpu_torch.models.odegpvae import init_model  # noqa: E402
from vae_gp_ode_tpu_torch.ops import df_pathwise, df_pathwise_tiled  # noqa
from vae_gp_ode_tpu_torch.training import trainer  # noqa: E402

STEPS = ((True, 6), (False, 12), (True, 6))  # (by the rule, steps)


def gram_stats(gp):
    """The factored matrix's f32 Cholesky on the card, its float64
    eigenvalue range on the CPU, and the lengthscales' spread."""
    k = gp.kernel
    with torch.no_grad():
        out = {}
        for where, dtype in (('cuda', torch.float32), ('cpu', torch.float64)):
            kk = dataclasses.replace(k, **{
                n: getattr(k, n).to(where, dtype) for n in (
                    'unconstrained_lengthscales', 'unconstrained_variance')})
            Ku = dfk.df_gram(kk, gp.inducing_loc.to(where, dtype))
            A = (Ku + Ku.T) / 2 + JITTER * torch.eye(
                Ku.shape[-1], dtype=dtype, device=where)
            if dtype == torch.float32:
                out['chol_f32_ok'] = int(torch.linalg.cholesky_ex(A)[1]) == 0
            else:
                ev = torch.linalg.eigvalsh(A)
                out['eig_min_f64'] = float(ev[0])
                out['eig_max_f64'] = float(ev[-1])
        ls = rbf_lengthscales(k)
        out['ls_spread'] = float(ls.max() / ls.min())
    return out


def run(seed, plain, X20, Xbig):
    """24 steps at batch 20 and 2 at batch 160 from seed's initial state;
    per step the gram's statistics before it and its non-finite metrics."""
    model, gp = init_model(seed + 50, device='cuda', **dict(
        cs.CONFIG, solver='rk4', kernel='DF'))
    st = trainer.create_train_state(model, gp)
    stp = trainer.make_train_step(360.0, eps_guard=True)
    gen = torch.Generator(device='cuda').manual_seed(seed + 52)
    rule = df_pathwise_tiled.use_df_tiled
    evals = df_pathwise_tiled.df_pathwise_eval
    if plain:
        df_pathwise_tiled.df_pathwise_eval = df_pathwise.df_pathwise_reference
    rows = []
    ops.reset_launches()
    try:
        plan = [(by_rule, X20) for by_rule, n in STEPS for _ in range(n)]
        for by_rule, X in plan + [(True, Xbig)] * 2:
            if not by_rule:
                df_pathwise_tiled.use_df_tiled = lambda *a: (False, False)
            try:
                row = dict(gram_stats(st.gp), batch=X.shape[0])
                mets = stp(st, X, cs.L, gen)
            finally:
                df_pathwise_tiled.use_df_tiled = rule
            row['non_finite'] = [k for k, v in mets.items()
                                 if not bool(torch.isfinite(v).all())]
            rows.append(row)
    finally:
        df_pathwise_tiled.df_pathwise_eval = evals
    launched = sum(ops.LAUNCHES.values())
    if (launched > 0) == plain:
        raise AssertionError(f'the {"plain" if plain else "kernel"} path '
                             f'launched {dict(ops.LAUNCHES)}')
    return rows, rbf_lengthscales(st.gp.kernel).detach().cpu()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seeds', type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('df_state_probe: needs a GPU', file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), torch.__version__, flush=True)
    dev = torch.device('cuda')

    def pixels(n, seed):
        return (torch.rand((n, cs.T, 1, 28, 28), generator=torch.Generator(
            device=dev).manual_seed(seed), device=dev) - 0.1307) / 0.3081
    X20, Xbig = pixels(cs.BATCH, 48), pixels(160, 49)
    total = {p: {'steps': 0, 'non_finite': 0, 'non_finite_chol_failed': 0,
                 'chol_failed': 0, 'eig_min_below_0': 0}
             for p in ('kernels', 'plain')}
    for seed in range(args.seeds):
        ends = {}
        for path in ('kernels', 'plain'):
            rows, ends[path] = run(seed, path == 'plain', X20, Xbig)
            t = total[path]
            for r in rows:
                t['steps'] += 1
                t['non_finite'] += bool(r['non_finite'])
                t['non_finite_chol_failed'] += bool(
                    r['non_finite']) and not r['chol_f32_ok']
                t['chol_failed'] += not r['chol_f32_ok']
                t['eig_min_below_0'] += r['eig_min_f64'] < 0
            print(json.dumps({'seed': seed, 'path': path, 'steps': [
                {k: (f'{v:.6g}' if isinstance(v, float) else v)
                 for k, v in r.items()} for r in rows]}), flush=True)
        diff = float((ends['kernels'] - ends['plain']).abs().max())
        print(json.dumps({'seed': seed, 'end_lengthscales_max_abs_diff':
                          diff}), flush=True)
    print(json.dumps({'totals': total}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
