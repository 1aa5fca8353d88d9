"""Training meters keeping full histories (a copy of
`vae_gp_ode_tpu/training/meters.py`, which the port does not import).

CachedRunningAverageMeter computes a weighted moving average over the last
`period` values (linearly decaying weights), CachedAverageMeter a plain
running mean, CachedHyperparams stores raw traces.
"""

import numpy as np


class CachedRunningAverageMeter:
    """Weighted-moving-average meter."""

    def __init__(self, period=10):
        self.period = period
        norm = (period * (period + 1)) // 2
        self.weights = np.array([period - t for t in range(period)]) / norm
        self.reset()

    def reset(self):
        self.val = None
        self.avg = 0.0
        self.vals = []
        self.iters = []

    def update(self, val, it):
        if self.val is None:
            self.avg = val
        elif len(self.vals) < self.period:
            self.avg = float(np.mean(self.vals))
        else:
            self.avg = float(np.average(
                np.flip(np.asarray(self.vals[-self.period:])),
                weights=self.weights))
        self.val = val
        self.vals.append(val)
        self.iters.append(it)


class CachedAverageMeter:
    """Running-mean meter."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0
        self.vals = []
        self.iters = []

    def update(self, val, it, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
        self.vals.append(val)
        self.iters.append(it)


class CachedHyperparams:
    """Raw hyperparameter trace."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.vals = []
        self.iters = []

    def update(self, val, it):
        self.vals.append(np.asarray(val))
        self.iters.append(it)
