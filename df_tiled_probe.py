#!/usr/bin/env python3
"""The grid-tiled DF pair alone on one GPU: kernel #11
(`df_pathwise_tiled_fwd`) and #12 (`df_pathwise_tiled_bwd`), built,
checked and timed, beside the single-block pair #5/#6 at the same shapes.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 df_tiled_probe.py [--repo DIR] [--reps 20] [--shapes L,N,D,S ...]

--repo takes the kernels and wrappers of another checkout (a parent commit
unpacked with `git archive` into chip_archive/, say), so that two versions
are timed in one call on one card. The script prints the card, then per
shape (L, N, D, S; M = 100, a DF sample drawn from a seed) one JSON line:
the largest error of each pair's forward and of every cotangent against
`df_pathwise_reference` and autograd through it (chip_smoke.py's
tolerances: abs 1e-4 + rel 1e-4; cotangents 1e-4 (1 + max |plain|)),
whether two launches gave the same bits, ms per call (CUDA events around
--reps calls of the wrapper with its slab sums; the median of three rounds
taken in turns, single-block then tiled) and device us per launch
(torch.profiler over --reps launches) of each kernel. It exits non-zero
if a kernel disagrees with the plain version.
"""

import argparse
import json
import os
import sys

import chip_smoke as cs

# (L, N, D, S): the wide shape and the main DF width first, then the
# sweep's other shapes, the rows of the smoke paths and edge widths
SHAPES = ((5, 20, 12, 1024), (5, 20, 6, 256), (1, 20, 12, 1024),
          (1, 20, 6, 256), (5, 20, 12, 256), (5, 20, 6, 512),
          (5, 600, 12, 1024), (5, 600, 6, 256), (5, 400, 12, 1024),
          (5, 160, 6, 256), (5, 20, 16, 64), (3, 7, 7, 40), (2, 5, 3, 9))
M = 100
TOL = 1e-4


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--repo', default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--shapes', nargs='*', default=None,
                    help='L,N,D,S of each shape (default: SHAPES)')
    args = ap.parse_args()
    shapes = ([tuple(map(int, a.split(','))) for a in args.shapes]
              if args.shapes else SHAPES)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('df_tiled_probe: needs a CUDA GPU', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.repo))
    from vae_gp_ode_tpu_torch.gp.svgp import draw_fn_sample, init_svgp_params
    from vae_gp_ode_tpu_torch.ops import _build, df_pathwise
    from vae_gp_ode_tpu_torch.ops import df_pathwise_tiled as tiled

    card = cs.nvidia_smi()
    print(f'card: {card}; repo {os.path.abspath(args.repo)}', flush=True)
    _build.build(['df_pathwise_fwd', 'df_pathwise_bwd',
                  'df_pathwise_tiled_fwd', 'df_pathwise_tiled_bwd'])
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)

    def device_us(fn, name, reps):
        us, seen = cs.device_us(fn, [name], reps)[name]
        return us if seen else None

    failed = []
    for L, N, D, S in shapes:
        ls = 2.0 if D > 3 else 0.5
        gp = init_svgp_params(rng, D, D, M, kernel='DF', lengthscale=ls,
                              variance=0.7, device='cuda')
        with torch.no_grad():
            ops_ = df_pathwise.df_fused_operands(
                gp, draw_fn_sample(gp, gen, S, L=L))
        x = torch.randn((L, N, D), generator=gen, device=dev)
        g = torch.randn((L, N, D), generator=gen, device=dev)
        with torch.no_grad():
            ref = df_pathwise.df_pathwise_reference(x, *ops_)
        refb = df_pathwise.df_pathwise_vjp_reference(x, *ops_, g)
        row = {'L': L, 'N': N, 'D': D, 'S': S, 'M': M}
        pairs = (('single', df_pathwise), ('tiled', tiled))
        for tag, mod in pairs:
            with torch.no_grad():
                o1 = mod._launch(x, ops_)
                o2 = mod._launch(x, ops_)
                b1 = mod._launch_bwd(x, ops_, g)
                b2 = mod._launch_bwd(x, ops_, g)
            torch.cuda.synchronize()
            err = (o1 - ref).abs()
            ok = bool(torch.isfinite(o1).all()) and bool(
                (err <= TOL + TOL * ref.abs()).all())
            berr = 0.0
            for a, b in zip(b1, refb):
                e = float((a - b).abs().max())
                lim = TOL * (1 + float(b.abs().max()))
                ok = ok and e <= lim and bool(torch.isfinite(a).all())
                berr = max(berr, e / (1 + float(b.abs().max())))
            same = torch.equal(o1, o2) and all(
                torch.equal(a, b) for a, b in zip(b1, b2))
            if not ok:
                failed.append(f'{tag} {row}')
            reps = args.reps if N <= 160 else max(3, args.reps // 4)
            with torch.no_grad():
                row[tag] = {
                    'fwd_err': float(err.max()), 'bwd_rel_err': berr,
                    'ok': ok, 'bitwise_repeat': same,
                    'fwd_us': device_us(lambda: mod._launch(x, ops_),
                                        mod.KERNEL, reps),
                    'bwd_us': device_us(lambda: mod._launch_bwd(x, ops_, g),
                                        mod.BWD_KERNEL, reps)}
        # ms per call: three rounds in turns, the median of each
        reps = args.reps if N <= 160 else max(3, args.reps // 4)
        rounds = {(tag, role): [] for tag, _ in pairs
                  for role in ('fwd', 'bwd')}
        with torch.no_grad():
            for _ in range(3):
                for role in ('fwd', 'bwd'):
                    for tag, mod in pairs:
                        fn = ((lambda: mod._launch(x, ops_)) if role == 'fwd'
                              else (lambda: mod._launch_bwd(x, ops_, g)))
                        rounds[tag, role].append(cs.cuda_ms(fn, reps))
        for (tag, role), t in rounds.items():
            row[tag][role + '_ms'] = sorted(t)[1]
        print(json.dumps(row), flush=True)
    print(json.dumps({'card': card, 'failed': failed}))
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
