"""idle_share.forecast: the share of the traced slice's wall time in which no
operation ran on the card (union of the device intervals of the
torch.profiler trace)."""


def read(run):
    if run.mode != 'forecast' or run.trace is None or not run.trace.kernels:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
