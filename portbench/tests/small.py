"""Small sizes at which the tests drive the harness on the CPU, where
the port computes its kernels' plain versions."""

import io
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

TRAIN = {'batch': 4, 'n_train': 12, 'n_test': 4, 'L': 2, 'max_epochs': 64,
         'trace_epochs': 1}
FORECAST = {'batch': 4, 'pool': 16, 'L': 2, 'max_requests': 64,
            'sample_span': 4, 'sample_requests': 2, 'trace_requests': 2}
CELLS = ('rbf-q6.train-b20', 'df-q6.train-b20', 'rbf-q6.forecast-b128',
         'df-q6.forecast-b128')


def overrides(cell):
    """Narrow RBF widths (the DF checkpoint keeps its own) and small
    traffic."""
    cfg = ({'num_features': 32, 'num_inducing': 16} if cell.startswith('rbf')
           else {})
    return {'config': cfg,
            'traffic': TRAIN if '.train' in cell else FORECAST}


def run(cell, seed=12345678901, seconds=0.3, trace=False, judge=True,
        control=False):
    """One run of `cell` on the CPU at the small sizes: (result, the
    printed last line)."""
    from portbench.harness import runner
    out, err = io.StringIO(), io.StringIO()
    res = runner.run(cell, seed, seconds, trace, device='cpu', judge=judge,
                     control=control, overrides=overrides(cell), out=out,
                     err=err)
    return res, out.getvalue().strip().splitlines()[-1]
