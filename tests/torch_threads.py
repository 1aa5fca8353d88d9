"""Torch's CPU thread pool sized for the test workers.

pytest-xdist runs the suite in several worker processes (six in the
tier-1 command), and each would start torch's intra-op pool with a thread
per core, whose threads spin in OpenMP barriers while the other workers
hold the cores: on an 8-core host under the full suite, a train step of
the port's plain path at latent_dim 64 (tests/test_torch_tiled.py) took
48 s with the default pool and 0.6 s with one thread. Importing this
module (every port test module does) gives each worker its share of the
cores; outside xdist the pool is left as it is.
"""

import os

import torch


def worker_threads():
    """The cores this process may use, shared among the xdist workers."""
    workers = int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))
    return max(1, len(os.sched_getaffinity(0)) // max(workers, 1))


if 'PYTEST_XDIST_WORKER_COUNT' in os.environ:
    torch.set_num_threads(worker_threads())
