"""flow_roofline.forecast: the least time of the traced slice's
the euler trajectory launches (#1, #7), from the copied arithmetic of
their operations and bytes (`harness.flops`, from the shapes of the work
each call recorded) and the H100's float32 peak, over their device time
in the trace."""

from portbench.harness import flops, kernels


def read(run):
    if run.mode != 'forecast' or run.trace is None:
        return None
    t = run.trace.device_s(kernels.flow)
    if t <= 0:
        return None
    bound = run.trace.calls * flops.work_flow_bound_s(run.cfg, run.work)
    return 100.0 * bound / t
