"""gp_draw_device_ms.train: device time per train step of the Cholesky
and triangular-solve kernels of the GP draw in the traced slice."""

from portbench.harness import kernels


def read(run):
    if run.mode != 'train' or run.trace is None or not run.trace.units:
        return None
    t = run.trace.device_s(kernels.gp_draw)
    return t / run.trace.units * 1e3 if t > 0 else None
