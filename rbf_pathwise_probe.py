#!/usr/bin/env python3
"""The RBF per-step kernels alone on one GPU: the single-block pair #3/#4
(`pathwise_fwd`, `pathwise_bwd`) and the grid-tiled pair #9/#10
(`pathwise_tiled_fwd`, `pathwise_tiled_bwd`), built, checked and timed at
the shapes the paths launch them at.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 rbf_pathwise_probe.py [--repo DIR] [--reps 20] [--shapes L,N,D,K,S ...]

--repo takes the kernels and wrappers of another checkout (a parent commit
unpacked with `git archive` into chip_archive/, say), so that two versions
are timed in one call on one card. The script prints the card, the device
time of an empty kernel built with this checkout's kernels (the floor
under every kernel's device time; none for a --repo checkout), then per
shape (L, N, D, K, S; M = 100,
an RBF sample drawn from a seed) one JSON line: the largest error of each
pair's forward and of every cotangent against `pathwise_eval_reference`
and autograd through it (chip_smoke.py's tolerances: abs 1e-4 + rel 1e-4;
cotangents 1e-4 (1 + max |plain|)), whether two launches gave the same
bits, ms per call (CUDA events around --reps calls of the wrapper; the
median of three rounds taken in turns, single-block then tiled) and
device us per launch (torch.profiler over --reps launches) of each kernel,
#10's second kernel, which sums its slabs, apart (null where the checkout
has none). It exits non-zero if a kernel disagrees with the plain
version.

    python3 rbf_pathwise_probe.py --calibrate

builds a few kernels that do a fraction of #3's work each (CALIBRATION
below) and prints their device us per launch on a grid of 150 blocks of
384 threads (#3's at the main widths), with and without a thread-block
cluster: what a launch, a load, eight cosf, asynchronous copies and a
cluster's two barriers cost on this card.

    python3 rbf_pathwise_probe.py --ablate NAME ... [--shapes ...]

copies the kernels' package into build/rbf_pathwise_probe/NAME with one
part of #3 or #10 removed (ABLATIONS below; the results are wrong on
purpose) and times that copy as --repo does: what each part costs.

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
# then the other rows and widths the paths launch the pair at, and an edge
SHAPES = ((5, 20, 6, 6, 256), (1, 20, 6, 6, 256), (5, 20, 12, 12, 1024),
          (1, 20, 12, 12, 1024), (5, 160, 6, 6, 256), (1, 20, 6, 6, 2048),
          (5, 400, 12, 12, 1024), (5, 600, 6, 6, 256), (2, 33, 7, 5, 30))
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
ABLATIONS = {
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
        run = subprocess.run(cmd, capture_output=True, text=True)
        rows = [json.loads(line) for line in run.stdout.splitlines()
                if line.startswith('{') and '"single"' in line]
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--repo', default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--shapes', nargs='*', default=None,
                    help='L,N,D,K,S of each shape (default: SHAPES)')
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
        gp = init_svgp_params(rng, D, K, M, lengthscale=2.0, variance=0.7,
                              device='cuda')
        with torch.no_grad():
            ops_ = pathwise.rbf_fused_operands(
                gp, draw_fn_sample(gp, gen, S, L=L))
        x = torch.randn((L, N, D), generator=gen, device=dev)
        g = torch.randn((L, N, K), generator=gen, device=dev)
        with torch.no_grad():
            ref = pathwise.pathwise_eval_reference(x, *ops_)
        refb = pathwise.pathwise_vjp_reference(x, *ops_, g)
        row = {'L': L, 'N': N, 'D': D, 'K': K, 'S': S, 'M': M}
        pairs = (('single', pathwise), ('tiled', tiled))
        reps = args.reps if N <= 160 else max(3, args.reps // 4)
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
            with torch.no_grad():
                fwd_us, _ = device_us(lambda: mod._launch(x, ops_),
                                      mod.KERNEL, reps)
                bwd_us, sum_us = device_us(
                    lambda: mod._launch_bwd(x, ops_, g), mod.BWD_KERNEL,
                    reps)
            row[tag] = {'fwd_err': float(err.max()), 'bwd_rel_err': berr,
                        'ok': ok, 'bitwise_repeat': same, 'fwd_us': fwd_us,
                        'bwd_us': bwd_us}
            if mod is tiled:
                row[tag]['bwd_sum_us'] = sum_us
        # ms per call: three rounds in turns, the median of each
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
