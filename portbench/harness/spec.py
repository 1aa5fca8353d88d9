"""Find everything of a cell by name: its entry in `BENCHMARK.json`, its
configuration's file, its traffic file (`traffic/<traffic>.json`), the
mode that file names (`modes/<mode>.py`, a class `Mode(ctx)`), the
reader of each metric it reports (`metrics/<metric>.py`, a function
`read(run)` that returns a number or None) and its limits
(`limits/<cell>.json`). Nothing here changes when a cell, a
configuration, a traffic mix, a mode or a metric is added: each is a
file."""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


class SpecError(Exception):
    """A name the benchmark's files do not define."""


def _json(path):
    if not os.path.isfile(path):
        raise SpecError(f'{os.path.relpath(path, ROOT)} does not exist')
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return _json(os.path.join(root, 'BENCHMARK.json'))


def _named(entries, name, what):
    for e in entries:
        if e['name'] == name:
            return e
    raise SpecError(f'no {what} named {name!r} in BENCHMARK.json')


def cell(bench, name):
    return _named(bench['workloads'], name, 'workload')


def config(bench, name, root=ROOT):
    entry = _named(bench['configs'], name, 'configuration')
    return _json(os.path.join(root, entry['file']))


def traffic(name):
    return _json(os.path.join(HERE, 'traffic', f'{name}.json'))


def limits(cell_name):
    return _json(os.path.join(HERE, 'limits', f'{cell_name}.json'))


def metrics(bench, cell_name, traced):
    """The metrics a run of the cell reports: its end-to-end metrics with
    --trace 0, its per-layer metrics with --trace 1."""
    e2e = [m for m in bench['end_to_end']
           if cell_name in m.get('workloads', [cell_name])]
    if not traced:
        return e2e
    moves = {m['name'] for m in e2e}
    return [m for m in bench['per_layer']
            if (cell_name in m['workloads'] if 'workloads' in m
                else m['moves'] in moves)]


def _module(kind, name):
    """The module of file `<kind>s/<name>.py`."""
    path = os.path.join(HERE, f'{kind}s', f'{name}.py')
    if not os.path.isfile(path):
        raise SpecError(f'{kind} {name!r} has no file {path}')
    tag = name.replace('.', '_').replace('-', '_')
    spec = importlib.util.spec_from_file_location(
        f'portbench_{kind}_{tag}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name):
    """`read(run)` of metric `name`, from metrics/<name>.py."""
    return _module('metric', name).read


def mode(name):
    """The class `Mode` of traffic mode `name`, from modes/<name>.py."""
    return _module('mode', name).Mode
