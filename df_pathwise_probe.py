#!/usr/bin/env python3
"""The single-block DF per-step pair #5/#6 (`df_pathwise_fwd`,
`df_pathwise_bwd`) and the DF euler trajectory pair #7/#8
(`df_flow_fused_fwd`, `df_flow_fused_bwd`) alone on one GPU: built,
checked and timed at the shapes the paths launch them at, and the busy
time of whole DF train steps.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 df_pathwise_probe.py [--repo DIR] [--reps 20] [--steps L,N,D,S ...]
        [--flows L,N,D,S,T ...] [--kernels 5 6 7 8] [--tiled L,N,D,S ...]
        [--no-train-steps] [--big-rk4]

--repo takes the kernels and wrappers of another checkout (a parent commit
unpacked with `git archive` into chip_archive/, say), so that two versions
are timed in one call on one card: run it for each checkout in turns. The
script prints the card, then one JSON line per per-step shape (L, N, D, S;
M = 100, a DF sample drawn from a seed; key "step") and per trajectory
shape (L, N, D, S, T; key "flow"): the largest error of the forward and of
every cotangent against `df_pathwise_reference` / `df_euler_flow_reference`
and autograd through them in float64 (beside a trajectory's, the f32
plain version's forward error; chip_smoke.py's tolerances: abs 1e-4
+ rel 1e-4; cotangents 1e-4 (1 + max |plain|); against the f32 plain
version the parent's #8 misses them at N = 600, where both sum 600 rows
and 15 steps in different orders), whether two launches gave the
same bits, ms per call (CUDA events around --reps calls of the wrapper,
the median of three rounds), device us per launch (torch.profiler over
--reps launches) of each kernel and of a library's second kernel (the
summing kernels of #6 and #8), and the plan (rows per cluster, blocks
per cluster) #5 and #8 take there, where the checkout's kernels report
one. --kernels times only the kernels named (every shape is still
checked): `--kernels 6 7` times #6 with its summing kernel and #7.
--tiled times the grid-tiled pair #11/#12 (with their summing kernels)
at the shapes given, checked the same way (key "tiled"; `--tiled
5,20,64,256` is the latent_dim-64 step's shape). Unless
--no-train-steps, it then prints the device busy ms and kernel count of
one DF euler train step at L=1 and one DF euler and one DF rk4 train
step at L=5 at the main widths (torch.profiler, the median of three
steps), and with --big-rk4 of one DF rk4 train step at L=1 with 600
sequences (the step that takes #6). It exits non-zero if a kernel
disagrees with its plain version.

    python3 df_pathwise_probe.py --plans R,C ... [--steps ...] [--flows ...]

copies the kernels' package into build/df_pathwise_probe/ once per plan,
with csrc/cluster.cuh `plan_for` (the plan #5 and #8 share) edited to
take R rows per cluster (1, 2, or 4 at D <= 8) and C blocks per cluster
(1-8) in place of its own choice (plan_edits below; 0 keeps the choice,
so 0,0 times the kernels' own plan beside the others), and times each
copy as --repo does, without the train steps: the sweep that fits
`plan_for`.
"""

import argparse
import json
import os
import statistics
import sys

import chip_smoke as cs

# (L, N, D, S): the DF paths' per-step shapes (#5 and #6 where the rule
# takes them) first, then edges
STEP_SHAPES = ((5, 20, 6, 256), (1, 20, 6, 256), (1, 600, 6, 256),
               (1, 20, 6, 512), (5, 160, 6, 256), (1, 20, 6, 2048),
               (5, 20, 12, 256), (2, 7, 3, 33))
# (L, N, D, S, T): the trajectories of the DF train steps and requests
FLOW_SHAPES = ((5, 20, 6, 256, 16), (1, 20, 6, 256, 16),
               (5, 20, 6, 256, 32), (5, 600, 6, 256, 16),
               (5, 20, 12, 256, 16))
M = 100
TOL = 1e-4

# --plans: where the plan of #5 and #8 (csrc/df_cluster.cuh plan_for, the
# family-neutral plan_for of csrc/cluster.cuh) fixes the rows and where it
# splits the tile over the cluster; a copy edited there also takes the
# plan for the RBF euler pair, which this probe does not run
PLAN_SOURCE = 'cluster.cuh'
_ROWS_AT = '  p.n_tiles = (N + p.R - 1) / p.R;'
_CLUSTER_AT = '  return split(p, (int)c, n1, n2);'


def plan_edits(plan):
    """The edits of csrc/cluster.cuh for a copy whose `plan_for` takes
    `plan`, 'R,C' (rows per cluster, blocks per cluster; 0 keeps its
    choice)."""
    rows, cluster = (int(v) for v in plan.split(','))
    if rows not in (0, 1, 2, 4) or not 0 <= cluster <= 8:
        raise ValueError(f'plan {plan}: R must be 0, 1, 2 or 4, C 0-8')
    edits = []
    if rows:
        edits.append((_ROWS_AT, f'  p.R = {rows};\n' + _ROWS_AT))
    if cluster:
        edits.append((_CLUSTER_AT, f'  c = {cluster};\n' + _CLUSTER_AT))
    return edits


def edit(text, plan):
    """`text` (csrc/cluster.cuh) with `plan_edits(plan)` made; raises
    where an edit's text is not in it once."""
    for old, new in plan_edits(plan):
        if text.count(old) != 1:
            raise RuntimeError(f'plan {plan}: {old!r} is not in '
                               f'{PLAN_SOURCE} once')
        text = text.replace(old, new)
    return text


def run_copies(args, plans):
    """Times a copy of the kernels' package per plan through a child run of
    this script (--repo the copy, no train steps); prints the child's rows
    with the plan added."""
    import shutil
    import subprocess
    here = os.path.dirname(os.path.abspath(__file__))
    for plan in plans:
        root = os.path.join(here, 'build', 'df_pathwise_probe',
                            plan.replace(',', '_'))
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(os.path.join(here, 'vae_gp_ode_tpu_torch'),
                        os.path.join(root, 'vae_gp_ode_tpu_torch'),
                        ignore=shutil.ignore_patterns('__pycache__'))
        path = os.path.join(root, 'vae_gp_ode_tpu_torch', 'csrc',
                            PLAN_SOURCE)
        with open(path) as f:
            text = edit(f.read(), plan)
        with open(path, 'w') as f:
            f.write(text)
        cmd = [sys.executable, os.path.abspath(__file__), '--repo', root,
               '--reps', str(args.reps), '--no-train-steps']
        if args.steps is not None:
            cmd += ['--steps', *args.steps]
        if args.flows is not None:
            cmd += ['--flows', *args.flows]
        run = subprocess.run(cmd, capture_output=True, text=True)
        rows = [json.loads(line) for line in run.stdout.splitlines()
                if line.startswith('{"step"') or line.startswith('{"flow"')]
        for row in rows:
            print(json.dumps({'plan_edit': plan, **row}), flush=True)
        if not rows:   # the copy did not build or run
            print(json.dumps({'plan_edit': plan, 'rc': run.returncode,
                              'stderr': run.stderr[-2000:]}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--repo', default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--steps', nargs='*', default=None,
                    help='L,N,D,S of each per-step shape (default: '
                         'STEP_SHAPES)')
    ap.add_argument('--flows', nargs='*', default=None,
                    help='L,N,D,S,T of each trajectory shape (default: '
                         'FLOW_SHAPES)')
    ap.add_argument('--kernels', nargs='*', type=int, default=[5, 6, 7, 8],
                    help='time only these of #5-#8 (all are checked)')
    ap.add_argument('--tiled', nargs='*', default=[],
                    help='L,N,D,S of each shape to check and time the '
                         'tiled pair #11/#12 at')
    ap.add_argument('--no-train-steps', action='store_true',
                    help='skip the DF train steps')
    ap.add_argument('--big-rk4', action='store_true',
                    help='also the DF rk4 train step at L=1 with 600 '
                         'sequences (#6)')
    ap.add_argument('--plans', nargs='*', default=[],
                    help='time copies whose plan_for takes these plans '
                         '(R,C; 0 keeps its choice), and exit')
    args = ap.parse_args()
    steps = ([tuple(map(int, a.split(','))) for a in args.steps]
             if args.steps is not None else STEP_SHAPES)
    flows = ([tuple(map(int, a.split(','))) for a in args.flows]
             if args.flows is not None else FLOW_SHAPES)
    import ctypes
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('df_pathwise_probe: needs a CUDA GPU', file=sys.stderr)
        return 2
    if args.plans:
        run_copies(args, args.plans)
        return 0
    sys.path.insert(0, os.path.abspath(args.repo))
    from vae_gp_ode_tpu_torch.gp.svgp import draw_fn_sample, init_svgp_params
    from vae_gp_ode_tpu_torch.ops import _build, df_flow_fused, df_pathwise
    from vae_gp_ode_tpu_torch.ops import df_pathwise_tiled

    card = cs.nvidia_smi()
    print(f'card: {card}; repo {os.path.abspath(args.repo)}', flush=True)
    _build.build(['df_pathwise_fwd', 'df_pathwise_bwd', 'df_flow_fused',
                  'df_flow_fused_bwd', 'df_pathwise_tiled_fwd',
                  'df_pathwise_tiled_bwd'])
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    failed = []

    def plan_of(lib, export, *shape):
        """(rows, blocks) per cluster from the library's plan export, or
        None where the checkout's kernel has none or refuses the shape."""
        fn = getattr(lib, export, None)
        if fn is None:
            return None
        fn.argtypes = [ctypes.c_int] * (len(shape) + 1) + [ctypes.c_void_p]
        out = (ctypes.c_int * 8)()
        return None if fn(*shape, 0, out) else [out[0], out[1]]

    def draw(L, D, S):
        gp = init_svgp_params(rng, D, D, M, kernel='DF',
                              lengthscale=2.0 if D > 3 else 0.5,
                              variance=0.7, device='cuda')
        with torch.no_grad():
            return df_pathwise.df_fused_operands(
                gp, draw_fn_sample(gp, gen, S, L=L))

    def timing(fn, name, reps):
        """ms per call (median of three rounds) and device us per launch
        of `name` and its library's other kernels."""
        with torch.no_grad():
            ms = sorted(cs.cuda_ms(fn, reps) for _ in range(3))[1]
            us = cs.device_us(fn, [name], reps)
        return {'ms': ms, 'us': {k: v[0] if v[1] else None
                                 for k, v in us.items()}}

    def f64(ts):
        return [t.double() for t in ts]

    def close(out, ref):
        err = (out.double() - ref).abs()
        return float(err.max()), bool(torch.isfinite(out).all()) and bool(
            (err <= TOL + TOL * ref.abs()).all())

    def close_bwd(bars, refs):
        worst, ok = 0.0, True
        for a, b in zip(bars, refs):
            e = float((a.double() - b).abs().max())
            lim = TOL * (1 + float(b.abs().max()))
            ok = ok and e <= lim and bool(torch.isfinite(a).all())
            worst = max(worst, e / (1 + float(b.abs().max())))
        return worst, ok

    for L, N, D, S in steps:
        ops_ = draw(L, D, S)
        x = torch.randn((L, N, D), generator=gen, device=dev)
        g = torch.randn((L, N, D), generator=gen, device=dev)
        with torch.no_grad():
            ref = df_pathwise.df_pathwise_reference(*f64((x,) + ops_))
            o1 = df_pathwise._launch(x, ops_)
            o2 = df_pathwise._launch(x, ops_)
            b1 = df_pathwise._launch_bwd(x, ops_, g)
            b2 = df_pathwise._launch_bwd(x, ops_, g)
        refb = df_pathwise.df_pathwise_vjp_reference(*f64((x,) + ops_ + (g,)))
        ferr, fok = close(o1, ref)
        berr, bok = close_bwd(b1, refb)
        row = {'step': [L, N, D, S], 'fwd_err': ferr, 'bwd_rel_err': berr,
               'ok': fok and bok, 'bitwise_repeat': torch.equal(o1, o2) and
               all(torch.equal(a, b) for a, b in zip(b1, b2)),
               'plan': plan_of(df_pathwise._lib(), 'df_pathwise_fwd_plan',
                               L, N, D, S * D, M)}
        if not row['ok']:
            failed.append(row['step'])
        reps = args.reps if N <= 160 else max(3, args.reps // 4)
        if 5 in args.kernels:
            row['fwd'] = timing(lambda: df_pathwise._launch(x, ops_),
                                df_pathwise.KERNEL, reps)
        if 6 in args.kernels:
            row['bwd'] = timing(lambda: df_pathwise._launch_bwd(x, ops_, g),
                                df_pathwise.BWD_KERNEL, reps)
        print(json.dumps(row), flush=True)

    for L, N, D, S in (tuple(map(int, a.split(','))) for a in args.tiled):
        ops_ = draw(L, D, S)
        x = torch.randn((L, N, D), generator=gen, device=dev)
        g = torch.randn((L, N, D), generator=gen, device=dev)
        mod = df_pathwise_tiled
        with torch.no_grad():
            ref = df_pathwise.df_pathwise_reference(*f64((x,) + ops_))
            o1 = mod._launch(x, ops_)
            o2 = mod._launch(x, ops_)
            b1 = mod._launch_bwd(x, ops_, g)
            b2 = mod._launch_bwd(x, ops_, g)
        refb = df_pathwise.df_pathwise_vjp_reference(*f64((x,) + ops_ + (g,)))
        ferr, fok = close(o1, ref)
        berr, bok = close_bwd(b1, refb)
        row = {'tiled': [L, N, D, S], 'fwd_err': ferr, 'bwd_rel_err': berr,
               'ok': fok and bok, 'bitwise_repeat': torch.equal(o1, o2) and
               all(torch.equal(a, b) for a, b in zip(b1, b2))}
        if not row['ok']:
            failed.append(row['tiled'])
        reps = args.reps if N <= 160 else max(3, args.reps // 4)
        row['fwd'] = timing(lambda: mod._launch(x, ops_), mod.KERNEL, reps)
        row['bwd'] = timing(lambda: mod._launch_bwd(x, ops_, g),
                            mod.BWD_KERNEL, reps)
        print(json.dumps(row), flush=True)
        del ops_, ref, refb

    for L, N, D, S, T in flows:
        ops_ = draw(L, D, S)
        if not df_flow_fused.df_fused_pair_fits(D, S * D, M, dev):
            print(json.dumps({'flow': [L, N, D, S, T], 'refused': True}),
                  flush=True)
            continue
        z0 = torch.randn((N, D), generator=gen, device=dev)
        dts = torch.full((T - 1,), cs.CONFIG['dt'], device=dev)
        with torch.no_grad():
            zs = df_flow_fused.packed_df_euler_flow(z0, *ops_, dts, T)
            zs2 = df_flow_fused.packed_df_euler_flow(z0, *ops_, dts, T)
            ref = df_flow_fused.df_euler_flow_reference(
                *f64((z0,) + ops_ + (dts,)), T)
        zsbar = torch.randn(zs.shape, generator=gen, device=dev)
        b1 = df_flow_fused.df_flow_vjp(zs, zsbar, *ops_, dts, T)
        b2 = df_flow_fused.df_flow_vjp(zs, zsbar, *ops_, dts, T)
        refb = df_flow_fused.df_flow_vjp_reference(
            *f64((zs, zsbar) + ops_ + (dts,)), T)
        ferr, fok = close(zs, ref)
        berr, bok = close_bwd(b1, refb)
        with torch.no_grad():   # the f32 plain version's distance from f64
            plain = df_flow_fused.df_euler_flow_reference(z0, *ops_, dts, T)
        row = {'flow': [L, N, D, S, T], 'fwd_err': ferr,
               'fwd_err_f32_plain': close(plain, ref)[0],
               'bwd_rel_err': berr,
               'ok': fok and bok, 'bitwise_repeat': torch.equal(zs, zs2) and
               all(torch.equal(a, b) for a, b in zip(b1, b2)),
               'plan': plan_of(df_flow_fused._bwd_lib(),
                               'df_flow_fused_bwd_plan', L, N, D, S * D, M,
                               T)}
        if not row['ok']:
            failed.append(row['flow'])
        reps = args.reps if N <= 160 else max(3, args.reps // 4)
        if 7 in args.kernels:
            row['fwd'] = timing(lambda: df_flow_fused.packed_df_euler_flow(
                z0, *ops_, dts, T), df_flow_fused.KERNEL, reps)
        if 8 in args.kernels:
            row['bwd'] = timing(lambda: df_flow_fused.df_flow_vjp(
                zs, zsbar, *ops_, dts, T), df_flow_fused.BWD_KERNEL, reps)
        print(json.dumps(row), flush=True)

    if not args.no_train_steps:
        train_steps(args, gen)
    print(json.dumps({'card': card, 'failed': failed}))
    return 1 if failed else 0


def train_steps(args, gen):
    """Device busy ms and kernel count of one DF euler train step at L=1,
    one DF euler and one DF rk4 train step at L=5 and, with --big-rk4,
    one DF rk4 train step at L=1 with 600 sequences, at the main widths,
    the median of three steps."""
    import torch
    from vae_gp_ode_tpu_torch.models.odegpvae import init_model
    from vae_gp_ode_tpu_torch.training import trainer
    dev = torch.device('cuda')
    steps = [('euler', 1, cs.BATCH), ('euler', cs.L, cs.BATCH),
             ('rk4', cs.L, cs.BATCH)]
    if args.big_rk4:
        steps.append(('rk4', 1, cs.DF_BIG_BATCH))
    for solver, L, n in steps:
        X = (torch.rand((n, cs.T, 1, 28, 28), generator=gen,
                        device=dev) - 0.1307) / 0.3081
        model, gp = init_model(args.seed + 1, device='cuda', **dict(
            cs.CONFIG, kernel='DF', solver=solver))
        state = trainer.create_train_state(model, gp)
        step = trainer.make_train_step(360.0, eps_guard=True)
        step(state, X, L)
        runs = [cs.busy_ms(lambda: step(state, X, L)) for _ in range(3)]
        busy, count = [b for b, _ in runs], runs[-1][1]
        print(json.dumps({'train_step': f'DF {solver} L={L} N={n}',
                          'busy_ms': statistics.median(busy),
                          'busy_ms_all': busy, 'kernels': count}),
              flush=True)


if __name__ == '__main__':
    sys.exit(main())
