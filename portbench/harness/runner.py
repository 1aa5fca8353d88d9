"""One run of one cell: set-up, the measured window, the check of what
the timed path produced against the plain reference, and the result.

    run(workload, seed, seconds, trace) -> result dict

The result's last line on standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with a trace `breakdown`, and
last `checks`: each compared number beside its limit); standard error
carries the set-up phases, the port's kernel launches and, as its last
lines, the same checks.
"""

import gc
import json
import math
import os
import sys
import time
import types

from portbench.harness import spec

#: top-level module names that may not be loaded: JAX and the JAX package
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'vae_gp_ode_tpu')


class RunError(Exception):
    """A run that prints no result (exit code 1)."""


def forbidden_modules(names=None):
    """The forbidden top-level names among `names` (default: the loaded
    modules), each module's name compared whole up to its first dot."""
    names = sys.modules if names is None else names
    return sorted({n.split('.')[0] for n in names} & set(FORBIDDEN))


def process_age_s():
    """Seconds since this process started (its start time in
    /proc/self/stat against the boot clock)."""
    with open('/proc/self/stat') as f:
        fields = f.read().rsplit(')', 1)[1].split()
    start = int(fields[19]) / os.sysconf('SC_CLK_TCK')
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


class Context:
    """What the modes read: the cell's names, configuration, traffic, the
    seed, the device, whether this run traces, and `phase`, which prints
    each set-up phase's seconds on standard error."""

    def __init__(self, root, workload, cfg, traffic, seed, device, trace,
                 err):
        self.root, self.workload, self.cfg, self.traffic = (
            root, workload, cfg, traffic)
        self.seed, self.device, self.trace, self.err = (
            seed, device, trace, err)
        self._t = time.perf_counter()

    def phase(self, name):
        now = time.perf_counter()
        print(f'setup {name}: {now - self._t:.3f} s', file=self.err,
              flush=True)
        self._t = now


def _device(cell, device):
    import torch
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RunError('no CUDA device: torch.cuda.is_available() is false')
    if torch.cuda.device_count() < cell['chips']:
        raise RunError(f'the cell needs {cell["chips"]} cards, '
                       f'{torch.cuda.device_count()} are visible')
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    torch.cuda.init()
    return dev


def run(workload, seed, seconds, trace, device=None, judge=True,
        control=False, overrides=None, out=None, err=None):
    """Run one cell once and print its result. `device` None is the card
    (and the run fails without one); 'cpu' runs the port's plain
    versions, for tests. `overrides` ({'config': {...}, 'traffic':
    {...}}) replaces entries of the cell's files, for tests at small
    sizes. `judge=False` skips the limits, `control=True` adds the
    numbers of the control, of the faults planted in the reference and of
    any witness (the mode's `readings()`, for setting the limits).
    Returns the result with the compared numbers (`numbers`) and those
    (`control`)."""
    out = sys.stdout if out is None else out
    err = sys.stderr if err is None else err
    overrides = overrides or {}
    bench = spec.benchmark()
    cell = spec.cell(bench, workload)
    cfg = dict(spec.config(bench, cell['config']), **overrides.get(
        'config', {}))
    traffic = dict(spec.traffic(cell['traffic']), **overrides.get(
        'traffic', {}))
    limits = spec.limits(workload) if judge else None
    readers = {m['name']: (m['unit'], spec.reader(m['name']))
               for m in spec.metrics(bench, workload, trace)}
    os.environ.setdefault('TRITON_CACHE_DIR',
                          os.path.join(spec.ROOT, 'build', 'triton'))

    ctx = Context(spec.ROOT, workload, cfg, traffic, seed, None, trace, err)
    import torch
    dev = ctx.device = _device(cell, device)
    from portbench.harness import compare, program
    Mode = spec.mode(traffic['mode'])
    program.load()
    ctx.phase('import')
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    mode = Mode(ctx)
    setup_s = process_age_s()
    launches0 = program.launches()
    rec = mode.window(seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda' else 0
    launches = {k: v - launches0[k] for k, v in program.launches().items()
                if v != launches0[k]}
    print(f'kernel launches in the window: {launches}', file=err)

    mode.free()
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    numbers = mode.program_numbers()
    ctl = mode.readings() if control else None
    print(f'reference: {time.perf_counter() - t:.3f} s', file=err)
    if judge:
        correct, checks = compare.judge(numbers, limits)
    else:
        correct, checks = None, {k: [v, None] for k, v in numbers.items()
                                 if isinstance(v, float)}

    found = forbidden_modules()
    if found:
        print(f'forbidden modules loaded: {found}', file=err)
        raise RunError(f'forbidden modules loaded: {found}')

    runrec = types.SimpleNamespace(setup_s=setup_s, **rec)
    metrics = {}
    for name, (unit, read) in readers.items():
        v = read(runrec)
        if v is not None:
            metrics[name] = {'value': v, 'unit': unit}
    device_info = {'platform': 'gpu' if dev.type == 'cuda' else dev.type,
                   'kind': (torch.cuda.get_device_name(dev)
                            if dev.type == 'cuda' else 'cpu'),
                   'count': 1, 'memory_peak_bytes': int(peak)}
    result = {'correct': correct, 'attempted': rec['attempted'],
              'failed': rec['failed'], 'metrics': metrics,
              'device': device_info}
    tr = rec['trace']
    if trace and tr is not None:
        device_info['busy_s'] = tr.busy_s()
        device_info['window_s'] = tr.window_s
        result['breakdown'] = {'device_ops': tr.top_ops(),
                               'idle_gaps': tr.idle_gaps()}
    result['checks'] = checks
    print(f'numbers: {json.dumps(jsonable(numbers))}', file=err)
    for k, (v, lim) in checks.items():
        print(f'check {k} {v!r} limit {lim!r}', file=err)
    print(json.dumps(jsonable(result), allow_nan=False), file=out, flush=True)
    return dict(result, numbers=numbers, control=ctl)


def jsonable(x):
    """x with every non-finite float as its name ('inf', 'nan'), which
    JSON cannot hold as a number."""
    if isinstance(x, dict):
        return {k: jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x
