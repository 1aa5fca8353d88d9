"""mfu.train: the float32 operations of the window's calls before the
traced slice, counted from the shapes of the work each call recorded
(`harness.flops`), over that span's wall time (ending in a synchronize)
and the H100's float32 peak."""

from portbench.harness import flops


def read(run):
    if run.mode != 'train' or not run.wall_before_trace_s:
        return None
    ops = run.calls_before_trace * flops.work_flops(run.cfg, run.work)
    return 100.0 * ops / (run.wall_before_trace_s * flops.PEAK_F32_FLOPS)
