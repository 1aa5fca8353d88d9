#!/usr/bin/env python3
"""The RBF kernels alone on one GPU: the single-block per-step pair #3/#4
(`pathwise_fwd`, `pathwise_bwd`), the grid-tiled pair #9/#10
(`pathwise_tiled_fwd`, `pathwise_tiled_bwd`) and, with --flows, the euler
pair #1/#2 (`flow_fused_fwd`, `flow_fused_bwd`), built, checked and timed
at the shapes the paths launch them at.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 rbf_pathwise_probe.py [--repo DIR] [--reps 20] [--shapes L,N,D,K,S ...]

--repo takes the kernels and wrappers of another checkout (a parent commit
unpacked with `git archive` into chip_archive/, say), so that two versions
are timed in one call on one card. The script prints the card, the device
time of an empty kernel built with this checkout's kernels (the floor
under every kernel's device time; none for a --repo checkout), then per
shape (L, N, D, K, S; M = 100, an RBF sample drawn from a seed at
chip_smoke.py's `rbf_lengthscale(D)`) one JSON line: the largest error of
each pair's forward and of every cotangent against
`pathwise_eval_reference` and autograd through it (chip_smoke.py's
tolerances: abs 1e-4 + rel 1e-4; cotangents 1e-4 (1 + max |plain|)), each
output's and cotangent's max |error| over its max |float64| against the
float64 plain version, for each pair (`f64`) and for the f32 plain
version (`f64_plain`), whether two launches gave the same
bits, ms per call (CUDA events around --reps calls of the wrapper; the
median of three rounds taken in turns, single-block then tiled) and
device us per launch (torch.profiler over --reps launches) of each kernel,
the second kernel of its library call, which sums its blocks' terms,
apart (`fwd_sum_us`, `bwd_sum_us`; null where the checkout has none: a
parent whose wrapper sums in PyTorch), and the device us per call of all
the call's kernels together (`fwd_call_us`, `bwd_call_us`: the library's
or the parent's PyTorch sums included). Where #10's block does not fit the
card (D above 65) the tiled VJP is skipped (null). It exits non-zero if a
kernel disagrees with the plain version.

    python3 rbf_pathwise_probe.py --flows [L,N,D,K,S,T ...] [--repo DIR]
        [--no-train-steps]

checks and times the RBF euler pair instead, the trajectory #1
(`flow_fused_fwd`) and its discrete adjoint #2 (`flow_fused_bwd` and the
kernel that sums its slabs, `flow_fused_bwd_finish`), at the shapes given
(default FLOW_SHAPES: those of the default run's train steps and
requests; D = K * order): per shape one JSON line (key "flow") with the
largest error of the trajectory against `packed_flow_reference` in f32
and in float64 and of every cotangent of `packed_flow_vjp` against
autograd through it in f32 and in float64 (chip_smoke.py's tolerances,
against f32), whether two launches gave the same bits, ms per call (CUDA
events around --reps calls of `packed_euler_flow` / `packed_flow_vjp`,
the median of three rounds; for a parent whose adjoint's slabs are summed
in PyTorch those sums are in the call) and device us per launch
(torch.profiler) of each kernel and of the summing kernel apart, and the
plan (rows per cluster, blocks per cluster, row tiles) where the
checkout's library exports one; then, unless --no-train-steps, the
device busy ms and kernel count of one RBF euler train step at L=1 and
one at L=5 at the main widths (torch.profiler, the median of three
steps). With --repo it takes another checkout's kernels and wrappers, so
that parent and change are timed in turns in one call.

    python3 rbf_pathwise_probe.py --calibrate

builds a few kernels that do a fraction of #3's work each (CALIBRATION
below) and prints their device us per launch on a grid of 150 blocks of
384 threads (#3's at the main widths), with and without a thread-block
cluster: what a launch, a load, eight cosf, asynchronous copies and a
cluster's two barriers cost on this card.

    python3 rbf_pathwise_probe.py --ablate NAME ... [--shapes ...] [--flows ...]

copies the kernels' package into build/rbf_pathwise_probe/NAME with one
part of #3, #10 or (the flow_fwd_* names, with --flows) #1 removed
(ABLATIONS below; the results are wrong on purpose) and times that copy
as --repo does: what each part costs.

    python3 rbf_pathwise_probe.py --fwd-plans R,KC,C ... [--shapes ...]

does the same for copies whose #3 launcher takes the plan given in place
of its own choice (plan_edits below): R rows per block (1-8), KC
output-dim chunks, C blocks per cluster (1-8); 0 keeps the launcher's
choice, so 0,0,0 times the launcher's own plan beside the others.
"""

import argparse
import ctypes
import json
import os
import sys

import chip_smoke as cs

# (L, N, D, K, S): the main widths and the wide shape at L = 5 and 1 first,
# then the other rows and widths the paths launch the pairs at (the rk4
# steps at latent_dim 72, where #10 does not fit, take #9 and #4), and an
# edge
SHAPES = ((5, 20, 6, 6, 256), (1, 20, 6, 6, 256), (5, 20, 12, 12, 1024),
          (1, 20, 12, 12, 1024), (5, 160, 6, 6, 256), (1, 20, 6, 6, 2048),
          (5, 400, 12, 12, 1024), (5, 600, 6, 6, 256), (5, 20, 72, 72, 256),
          (2, 33, 7, 5, 30))
# (L, N, D, K, S, T): the RBF euler pair at the default run's train steps
# (L = 1 and 5, T = 16) and its requests (L = 5, T = 16 and the T = 32
# rollout), then chip_smoke.py's order-2 and 75-row-tile checks
FLOW_SHAPES = ((5, 20, 6, 6, 256, 16), (1, 20, 6, 6, 256, 16),
               (5, 20, 6, 6, 256, 32), (5, 20, 12, 6, 256, 16),
               (5, 300, 6, 6, 256, 16))
M = 100
TOL = 1e-4

# Kernels for --calibrate: each thread of c_load loads 8 floats (one
# coalesced round trip) and writes their sum, c_cos also takes 8 cosf,
# c_copy stages its 8 floats with cp.async first, c_cluster writes shared
# memory, passes a cluster barrier, reads one float of every block of its
# cluster and passes a second one; c_block does the same within its block.
CALIBRATION = r"""
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
__global__ void c_empty_kernel(const float* in, float* out) {}
__global__ void c_load_kernel(const float* in, float* out) {
  const float* p = in + (long long)blockIdx.x * 8 * blockDim.x + threadIdx.x;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += p[i * blockDim.x];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void c_cos_kernel(const float* in, float* out) {
  const float* p = in + (long long)blockIdx.x * 8 * blockDim.x + threadIdx.x;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += cosf(3.f * p[i * blockDim.x]);
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void c_copy_kernel(const float* in, float* out) {
  extern __shared__ float sm[];
  const float* p = in + (long long)blockIdx.x * 8 * blockDim.x;
  for (int i = 0; i < 8; ++i)
    __pipeline_memcpy_async(sm + i * blockDim.x + threadIdx.x,
                            p + i * blockDim.x + threadIdx.x, 4);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < 8; ++i)
    s += sm[i * blockDim.x + (threadIdx.x + 1) % blockDim.x];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void c_cluster_kernel(const float* in, float* out) {
  extern __shared__ float sm[];
  cg::cluster_group cl = cg::this_cluster();
  sm[threadIdx.x] = threadIdx.x;
  cl.sync();
  float s = 0.f;
  if (threadIdx.x < 32)
    for (int r = 0; r < (int)cl.num_blocks(); ++r)
      s += cl.map_shared_rank(sm, r)[threadIdx.x];
  cl.sync();
  if (threadIdx.x < 32) out[blockIdx.x * 32 + threadIdx.x] = s;
}
__global__ void c_block_kernel(const float* in, float* out) {
  extern __shared__ float sm[];
  sm[threadIdx.x] = threadIdx.x;
  __syncthreads();
  if (threadIdx.x < 32) out[blockIdx.x * 32 + threadIdx.x] = sm[threadIdx.x + 1];
}
typedef void (*Kernel)(const float*, float*);
extern "C" int calibrate(int which, int blocks, int threads, int smem,
                         int cluster, const float* in, float* out,
                         void* stream) {
  const Kernel ks[] = {c_empty_kernel, c_load_kernel, c_cos_kernel,
                       c_copy_kernel, c_cluster_kernel, c_block_kernel};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = cluster > 0 ? 1 : 0;
  cudaLaunchKernelEx(&cfg, ks[which], in, out);
  return (int)cudaGetLastError();
}
"""


# --ablate: (source, [(text, replacement), ...]) per name; each removes
# one part of a kernel's work and keeps the rest
_FWD_TRIG = [
    ('acc[r] = fmaf(coef, cosf(u[r]), acc[r]);',
     'acc[r] = fmaf(coef, u[r], acc[r]);'),
    ('acc[r] = fmaf(coef, expf(-0.5f * u[r]), acc[r]);',
     'acc[r] = fmaf(coef, -0.5f * u[r], acc[r]);')]
_FWD_REDUCTION = [
    ('  const float v = transpose_sum<R>(acc);',
     '  if (tid < R * Kc)\n'
     '    a.out[(l * N + r0) * K + k0 + tid % max(nk, 1)] = acc[0];\n'
     '  if (R > 0) return;\n'
     '  const float v = transpose_sum<R>(acc);')]
_FWD_LOADS = [
    ('  if (Direct && kk < nk && i0 + sl < i1) {',
     '  if (Direct && kk < nk && i0 + sl < i1 && D < 0) {')]
# #1 (flow_fused.cu, --flows): what a step of the trajectory is made of
_FLOW_ITEMS = [('    for (int it = tid; it < items; it += blockDim.x) {\n'
                '      float v[R];',
                '    for (int it = tid; it < items && D < 0; it += blockDim.x) {\n'
                '      float v[R];')]
_FLOW_TRIG = [
    ('v[r] = cosf(xo + ph) * wv;', 'v[r] = (xo + ph) * wv;'),
    ('v[r] = expf(-0.5f * (xn + znc - 2.f * cr)) * nuc;',
     'v[r] = -0.5f * (xn + znc - 2.f * cr) * nuc;')]
_FLOW_DSMEM = [('const float f = cl::cluster_sum(mine, C, tid);',
                'const float f = mine[tid];')]
_FLOW_BARRIER = [('    if (C > 1)\n      cluster.sync();\n    else\n'
                  '      __syncthreads();',
                  '    __syncthreads();')]
ABLATIONS = {
    'flow_fwd_no_items': ('flow_fused.cu', _FLOW_ITEMS),
    'flow_fwd_no_trig': ('flow_fused.cu', _FLOW_TRIG),
    'flow_fwd_no_dsmem': ('flow_fused.cu', _FLOW_DSMEM),
    'flow_fwd_no_cluster_barrier': ('flow_fused.cu', _FLOW_DSMEM +
                                    _FLOW_BARRIER),
    'fwd_no_trig': ('pathwise_fwd.cu', _FWD_TRIG),
    'fwd_no_reduction': ('pathwise_fwd.cu', _FWD_REDUCTION),
    'fwd_no_item_loads': ('pathwise_fwd.cu', _FWD_LOADS),
    'fwd_none_of_these': ('pathwise_fwd.cu',
                          _FWD_TRIG + _FWD_REDUCTION + _FWD_LOADS),
    'bwd_no_trig': ('pathwise_tiled_bwd.cu', [
        ('sincosf(u[j], &sn, &cs);', 'sn = u[j];\n      cs = 1.f - u[j];'),
        ('const float kx = vk * expf(-0.5f * q[j]);',
         'const float kx = vk * (-0.5f * q[j]);')]),
    'bwd_no_dx_product': ('pathwise_tiled_bwd.cu', [
        ('    dx_product<true>(', '    if (D < 0) dx_product<true>('),
        ('    dx_product<false>(', '    if (D < 0) dx_product<false>(')]),
    'bwd_no_epilogue': ('pathwise_tiled_bwd.cu', [
        ('  acc[(rg * V + 2 * D) * kItems + i] = dnu;',
         '  if (D > 0) return;\n  acc[(rg * V + 2 * D) * kItems + i] = dnu;'),
        ('  acc[(rg * V + D) * kItems + i] = dphv;',
         '  if (D > 0) return;\n  acc[(rg * V + D) * kItems + i] = dphv;')]),
}


# --fwd-plans: the plan's choices, set in plan_for just before it splits
# the work
_PLAN_AT = '  auto split = [&](bool staged) {'


def plan_edits(plan):
    """(source, edits) of a copy whose #3 launcher takes `plan`, 'R,KC,C'
    (rows per block, output-dim chunks, blocks per cluster; 0 keeps the
    launcher's choice)."""
    rb, kc, c = (int(v) for v in plan.split(','))
    if not (0 <= rb <= 8 and kc >= 0 and 0 <= c <= 8):
        raise ValueError(f'plan {plan}: R and C must be 0-8, KC >= 0')
    lines = ((f'  rb = {rb};\n' if rb else '')
             + (f'  n_kc = {kc} < K ? {kc} : K;\n' if kc else '')
             + (f'  C = {c};\n' if c else ''))
    return 'pathwise_fwd.cu', [(_PLAN_AT, lines + _PLAN_AT)]


def run_copies(args, copies):
    """Times each copy, (tag, (source, edits)), through a child run of this
    script on a copy of the kernels' package with the edits made; prints
    the child's rows with the tag added."""
    import shutil
    import subprocess
    here = os.path.dirname(os.path.abspath(__file__))
    for tag, (source, edits) in copies:
        name = '_'.join(map(str, tag.values())).replace(',', '_')
        root = os.path.join(here, 'build', 'rbf_pathwise_probe', name)
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(os.path.join(here, 'vae_gp_ode_tpu_torch'),
                        os.path.join(root, 'vae_gp_ode_tpu_torch'),
                        ignore=shutil.ignore_patterns('__pycache__'))
        path = os.path.join(root, 'vae_gp_ode_tpu_torch', 'csrc', source)
        with open(path) as f:
            text = f.read()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f'{name}: {old!r} is not in {source} '
                                   f'once')
            text = text.replace(old, new)
        with open(path, 'w') as f:
            f.write(text)
        cmd = [sys.executable, os.path.abspath(__file__), '--repo', root,
               '--reps', str(args.reps)]
        if args.shapes:
            cmd += ['--shapes', *args.shapes]
        if args.flows is not None:
            cmd += ['--flows', *args.flows, '--no-train-steps']
        run = subprocess.run(cmd, capture_output=True, text=True)
        rows = [json.loads(line) for line in run.stdout.splitlines()
                if line.startswith('{') and ('"single"' in line or
                                             line.startswith('{"flow"'))]
        for row in rows:
            print(json.dumps({**tag, **row}), flush=True)
        if not rows:   # the copy did not build or run
            print(json.dumps({**tag, 'rc': run.returncode,
                              'stderr': run.stderr[-2000:]}), flush=True)


def calibrate(card):
    """Device us per launch of the CALIBRATION kernels, one JSON line."""
    import subprocess
    import torch
    from vae_gp_ode_tpu_torch.ops import _build
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           'build', 'rbf_pathwise_probe')
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = (os.path.join(out_dir, f)
                     for f in ('calibrate.cu', 'libcalibrate.so'))
    with open(src, 'w') as f:
        f.write(CALIBRATION)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, '-o', lib_path,
                    src], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.calibrate.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    inp = torch.rand(150 * 384 * 8, device='cuda')
    out = torch.empty_like(inp)
    names = ('c_empty', 'c_load', 'c_cos', 'c_copy', 'c_cluster', 'c_block')
    cases = ((0, 0), (1, 0), (2, 0), (3, 0), (5, 0), (4, 1), (4, 6))
    row = {'card': card, 'blocks': 150, 'threads': 384}
    for which, cluster in cases:
        def launch():
            rc = lib.calibrate(which, 150, 384, 8 * 384 * 4, cluster,
                               inp.data_ptr(), out.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f'{names[which]}: CUDA error {rc}')
        us, seen = cs.device_us(launch, [names[which]], 20)[names[which]]
        row[names[which] + (f'_cluster{cluster}' if which == 4 else '')] = (
            us if seen else None)
    print(json.dumps(row), flush=True)


def flows(args, card):
    """--flows: #1 and #2 checked and timed per shape, then the train
    steps; returns the shapes that failed."""
    import numpy as np
    import torch
    from vae_gp_ode_tpu_torch.gp.svgp import draw_fn_sample, init_svgp_params
    from vae_gp_ode_tpu_torch.ops import _build, flow_fused
    from vae_gp_ode_tpu_torch.ops.pathwise import rbf_fused_operands
    _build.build(['flow_fused', 'flow_fused_bwd'])
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    shapes = ([tuple(map(int, a.split(','))) for a in args.flows]
              if args.flows else FLOW_SHAPES)

    def timing(fn, name):
        with torch.no_grad():
            ms = sorted(cs.cuda_ms(fn, args.reps) for _ in range(3))[1]
            us = cs.device_us(fn, [name], args.reps)
        return {'ms': ms, 'us': {k: v[0] if v[1] else None
                                 for k, v in us.items()}}

    def worst(outs, refs):
        """The largest |out - ref| / (1 + max |ref|) over the outputs."""
        return max(float((a.double() - b.double()).abs().max())
                   / (1 + float(b.double().abs().max()))
                   for a, b in zip(outs, refs))

    failed = []
    for L, N, D, K, S, T in shapes:
        order = D // K
        gp = init_svgp_params(rng, D, K, M, lengthscale=2.0, variance=0.7,
                              device='cuda')
        with torch.no_grad():
            packed = flow_fused._pack_operands(*rbf_fused_operands(
                gp, draw_fn_sample(gp, gen, S, L=L)))
        z0 = torch.randn((N, D), generator=gen, device=dev)
        dts = torch.full((T - 1,), cs.CONFIG['dt'], device=dev)
        with torch.no_grad():
            zs = flow_fused.packed_euler_flow(z0, *packed, dts, T, order)
            zs2 = flow_fused.packed_euler_flow(z0, *packed, dts, T, order)
            ref = flow_fused.packed_flow_reference(z0, *packed, dts, T,
                                                   order)
            ref64 = flow_fused.packed_flow_reference(
                *(t.double() for t in (z0,) + packed + (dts,)), T, order)
        zsbar = torch.randn(zs.shape, generator=gen, device=dev)
        b1 = flow_fused.packed_flow_vjp(zs, zsbar, *packed, dts, T, order)
        b2 = flow_fused.packed_flow_vjp(zs, zsbar, *packed, dts, T, order)
        refb = flow_fused.packed_flow_vjp_reference(zs, zsbar, *packed, dts,
                                                    T, order)
        refb64 = flow_fused.packed_flow_vjp_reference(
            *(t.double() for t in (zs, zsbar) + packed + (dts,)), T, order)
        fok = bool(torch.isfinite(zs).all()) and bool(
            ((zs - ref).abs() <= TOL + TOL * ref.abs()).all())
        bok = all(float((a - b).abs().max()) <= TOL * (
            1 + float(b.abs().max())) and bool(torch.isfinite(a).all())
            for a, b in zip(b1, refb))
        plan = None
        if hasattr(flow_fused, 'bwd_plan'):
            plan = list(flow_fused.bwd_plan(L, N, D, K, S, M, order, dev))
        row = {'flow': [L, N, D, K, S, T], 'ok': fok and bok,
               'fwd_err': float((zs - ref).abs().max()),
               'fwd_err_f64': float((zs.double() - ref64).abs().max()),
               'fwd_err_f32_plain_f64': float(
                   (ref.double() - ref64).abs().max()),
               'bwd_rel_err': worst(b1, refb),
               'bwd_rel_err_f64': worst(b1, refb64),
               'bwd_rel_err_f32_plain_f64': worst(refb, refb64),
               'bitwise_repeat': torch.equal(zs, zs2) and all(
                   torch.equal(a, b) for a, b in zip(b1, b2)),
               'plan': plan}
        if not row['ok']:
            failed.append(row['flow'])
        row['fwd'] = timing(lambda: flow_fused.packed_euler_flow(
            z0, *packed, dts, T, order), flow_fused.KERNEL)
        row['bwd'] = timing(lambda: flow_fused.packed_flow_vjp(
            zs, zsbar, *packed, dts, T, order), flow_fused.BWD_KERNEL)
        print(json.dumps(row), flush=True)
        del packed, zs, zs2, ref, ref64, b1, b2, refb, refb64
    if not args.no_train_steps:
        train_steps(args, gen)
    return failed


def train_steps(args, gen):
    """Device busy ms and kernel count of one RBF euler train step at L=1
    and one at L=5 at the main widths, the median of three steps."""
    import statistics
    import torch
    from vae_gp_ode_tpu_torch.models.odegpvae import init_model
    from vae_gp_ode_tpu_torch.training import trainer
    dev = torch.device('cuda')
    X = (torch.rand((cs.BATCH, cs.T, 1, 28, 28), generator=gen,
                    device=dev) - 0.1307) / 0.3081
    model, gp = init_model(args.seed + 1, device='cuda', **cs.CONFIG)
    state = trainer.create_train_state(model, gp)
    step = trainer.make_train_step(360.0, eps_guard=True)
    for L in (1, cs.L):
        step(state, X, L)
        runs = [cs.busy_ms(lambda: step(state, X, L)) for _ in range(3)]
        busy, count = [b for b, _ in runs], runs[-1][1]
        print(json.dumps({'train_step': f'RBF euler L={L} N={cs.BATCH}',
                          'busy_ms': statistics.median(busy),
                          'busy_ms_all': busy, 'kernels': count}),
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--repo', default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--shapes', nargs='*', default=None,
                    help='L,N,D,K,S of each shape (default: SHAPES)')
    ap.add_argument('--flows', nargs='*', default=None,
                    help='check and time the RBF euler pair at these '
                         'L,N,D,K,S,T (none given: FLOW_SHAPES) and exit')
    ap.add_argument('--no-train-steps', action='store_true',
                    help='with --flows: skip the RBF euler train steps')
    ap.add_argument('--calibrate', action='store_true',
                    help='time the CALIBRATION kernels and exit')
    ap.add_argument('--ablate', nargs='*', default=[],
                    choices=sorted(ABLATIONS),
                    help='time copies with one part removed and exit')
    ap.add_argument('--fwd-plans', nargs='*', default=[],
                    help="time copies whose #3 takes these plans in place "
                         "of the launcher's: rows per block, output-dim "
                         'chunks, blocks per cluster (R,KC,C; 0 keeps the '
                         'choice), and exit')
    args = ap.parse_args()
    shapes = ([tuple(map(int, a.split(','))) for a in args.shapes]
              if args.shapes else SHAPES)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('rbf_pathwise_probe: needs a CUDA GPU', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.repo))
    from vae_gp_ode_tpu_torch.gp.svgp import draw_fn_sample, init_svgp_params
    from vae_gp_ode_tpu_torch import ops
    from vae_gp_ode_tpu_torch.ops import _build, pathwise
    from vae_gp_ode_tpu_torch.ops import pathwise_tiled as tiled

    card = cs.nvidia_smi()
    if args.calibrate:
        calibrate(card)
        return 0
    if args.ablate or args.fwd_plans:
        run_copies(args, [({'ablation': name}, ABLATIONS[name])
                          for name in args.ablate]
                   + [({'plan': plan}, plan_edits(plan))
                      for plan in args.fwd_plans])
        return 0
    print(f'card: {card}; repo {os.path.abspath(args.repo)}', flush=True)
    if args.flows is not None:
        failed = flows(args, card)
        print(json.dumps({'card': card, 'failed': failed}))
        return 1 if failed else 0
    _build.build(['pathwise_fwd', 'pathwise_bwd', 'pathwise_tiled_fwd',
                  'pathwise_tiled_bwd'])
    # the empty kernel of this checkout's build (a --repo checkout's may
    # have none)
    floor = None
    if os.path.abspath(args.repo) == os.path.dirname(os.path.abspath(
            __file__)):
        floor = cs.floor_us()
    print(json.dumps({'card': card, 'empty_kernel_us': floor}), flush=True)
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    def call_us(fn, reps):
        """Device us per call of fn(), all of its kernels together (a
        parent's PyTorch reductions included; torch.profiler)."""
        fn()
        ev = cs.device_events(lambda: [fn() for _ in range(reps)])
        return sum(e.time_range.elapsed_us() for e in ev) / reps if ev \
            else None

    def device_us(fn, name, reps):
        """Device us per launch of kernel `name` and of the other kernels
        of its library call together (each None where the trace held
        none)."""
        got = cs.device_us(fn, [name], reps)
        us, seen = got.pop(name)
        rest = [v for v, n in got.values() if n]
        return us if seen else None, sum(rest) if rest else None

    failed = []
    for L, N, D, K, S in shapes:
        gp = init_svgp_params(rng, D, K, M, lengthscale=cs.rbf_lengthscale(D),
                              variance=0.7, device='cuda')
        with torch.no_grad():
            ops_ = pathwise.rbf_fused_operands(
                gp, draw_fn_sample(gp, gen, S, L=L))
        x = torch.randn((L, N, D), generator=gen, device=dev)
        g = torch.randn((L, N, K), generator=gen, device=dev)
        with torch.no_grad():
            ref = pathwise.pathwise_eval_reference(x, *ops_)
        refb = pathwise.pathwise_vjp_reference(x, *ops_, g)
        # the float64 plain version: each output's or cotangent's max
        # |error| over its own max |float64|
        x64, ops64 = x.double(), [t.double() for t in ops_]
        with torch.no_grad():
            ref64 = pathwise.pathwise_eval_reference(x64, *ops64)
        refb64 = pathwise.pathwise_vjp_reference(x64, *ops64, g.double())
        names = ('f', 'x') + pathwise.NAMES

        def f64_errs(outs):
            return {n: float((a.double() - b).abs().max())
                    / float(b.abs().max())
                    for n, a, b in zip(names, outs, (ref64,) + refb64)}
        row = {'L': L, 'N': N, 'D': D, 'K': K, 'S': S, 'M': M,
               'lengthscale': cs.rbf_lengthscale(D),
               'f64_plain': f64_errs((ref,) + refb)}
        pairs = (('single', pathwise), ('tiled', tiled))
        # #10's block holds every D of its items: it does not fit past D=65
        tiled_vjp = tiled.tiled_bwd_smem_bytes(D) <= ops.card_properties(
            dev)[1]
        reps = args.reps if N <= 160 else max(3, args.reps // 4)
        for tag, mod in pairs:
            vjp = mod is pathwise or tiled_vjp
            with torch.no_grad():
                o1 = mod._launch(x, ops_)
                o2 = mod._launch(x, ops_)
                b1 = mod._launch_bwd(x, ops_, g) if vjp else ()
                b2 = mod._launch_bwd(x, ops_, g) if vjp else ()
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
            with torch.no_grad():
                fwd_us, fwd_sum_us = device_us(
                    lambda: mod._launch(x, ops_), mod.KERNEL, reps)
                bwd_us, bwd_sum_us = device_us(
                    lambda: mod._launch_bwd(x, ops_, g), mod.BWD_KERNEL,
                    reps) if vjp else (None, None)
                fwd_call = call_us(lambda: mod._launch(x, ops_), reps)
                bwd_call = call_us(lambda: mod._launch_bwd(x, ops_, g),
                                   reps) if vjp else None
            row[tag] = {'fwd_err': float(err.max()),
                        'bwd_rel_err': berr if vjp else None,
                        'f64': f64_errs((o1,) + tuple(b1)), 'ok': ok,
                        'bitwise_repeat': same, 'fwd_us': fwd_us,
                        'fwd_sum_us': fwd_sum_us, 'bwd_us': bwd_us,
                        'bwd_sum_us': bwd_sum_us,
                        'fwd_call_us': fwd_call, 'bwd_call_us': bwd_call}
        # ms per call: three rounds in turns, the median of each
        rounds = {(tag, role): [] for tag, mod in pairs
                  for role in ('fwd', 'bwd')
                  if role == 'fwd' or mod is pathwise or tiled_vjp}
        with torch.no_grad():
            for _ in range(3):
                for role in ('fwd', 'bwd'):
                    for tag, mod in pairs:
                        if (tag, role) not in rounds:
                            continue
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
