"""The harness finds every cell, configuration, traffic mix, metric and
limit by name, and BENCHMARK.json keeps to the contract's shape."""

import json
import os
import re

import pytest

from portbench.tests import small  # noqa: F401  (puts the root on sys.path)
from portbench.harness import spec

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
BENCH = spec.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['command'] == ['python3', 'portbench/run.py']
    assert BENCH['paths'] == ['portbench']
    assert 1 <= BENCH['run_seconds'] <= 51


def test_names_units_and_keys():
    names = set()
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and c['name'] not in names
        names.add(c['name'])
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and NAME.match(w['traffic'])
        assert w['chips'] == 1 and len(w['why']) <= 200
    metrics = BENCH['end_to_end'] + BENCH['per_layer']
    assert len({m['name'] for m in metrics}) == len(metrics)
    for m in BENCH['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in BENCH['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['moves'] in {e['name'] for e in BENCH['end_to_end']}
    for m in metrics:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
    assert 'setup_s' in {m['name'] for m in BENCH['end_to_end']}


@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_cell_parts_found_by_name(cell):
    w = spec.cell(BENCH, cell)
    cfg = spec.config(BENCH, w['config'])
    assert cfg['kernel'] in ('RBF', 'DF')
    tr = spec.traffic(w['traffic'])
    assert callable(spec.mode(tr['mode']))
    limits = spec.limits(cell)
    assert limits and all('limit' in v for v in limits.values())
    for traced in (False, True):
        ms = spec.metrics(BENCH, cell, traced)
        assert ms
        for m in ms:
            assert callable(spec.reader(m['name']))
    e2e = {m['name'] for m in spec.metrics(BENCH, cell, False)}
    assert 'setup_s' in e2e and len(e2e) >= 2


def test_every_config_used_and_files_under_paths():
    used = {w['config'] for w in BENCH['workloads']}
    assert used == {c['name'] for c in BENCH['configs']}
    for c in BENCH['configs']:
        assert c['file'].startswith('portbench/')
        with open(os.path.join(spec.ROOT, c['file'])) as f:
            assert json.load(f)['reduced'] == c['reduced']


def test_unknown_names_raise():
    with pytest.raises(spec.SpecError):
        spec.cell(BENCH, 'no-such-cell')
    with pytest.raises(spec.SpecError):
        spec.reader('no_such_metric')
    with pytest.raises(spec.SpecError):
        spec.mode('no_such_mode')
