"""A run's last line holds exactly the contract's keys (with `breakdown`
on a traced run, and `checks` last), and each mode reports the metrics
BENCHMARK.json names for its cells."""

import json

import pytest

from portbench.tests import small
from portbench.harness import spec

BENCH = spec.benchmark()
KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']


@pytest.mark.parametrize('cell', ['rbf-q6.train-b20',
                                  'rbf-q6.forecast-b128'])
@pytest.mark.parametrize('trace', [False, True])
def test_last_line(cell, trace):
    _, line = small.run(cell, trace=trace, seconds=1.0)
    d = json.loads(line)
    want = KEYS + (['breakdown'] if trace else []) + ['checks']
    assert list(d) == want
    assert isinstance(d['correct'], bool)
    assert d['attempted'] > 0 and d['failed'] == 0
    assert set(d['checks']) == set(spec.limits(cell))
    assert d['device']['platform'] == 'cpu' and d['device']['count'] == 1
    names = {m['name'] for m in spec.metrics(BENCH, cell, trace)}
    assert set(d['metrics']) <= names
    for m in d['metrics'].values():
        assert set(m) == {'value', 'unit'}
    if not trace:
        # every end-to-end metric is read on the CPU too
        assert set(d['metrics']) == names
    else:
        # no device trace on the CPU: the trace's readers return nothing
        assert {'busy_s', 'window_s'} <= set(d['device'])
        assert set(d['breakdown']) == {'device_ops', 'idle_gaps'}
