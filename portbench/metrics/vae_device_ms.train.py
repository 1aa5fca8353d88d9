"""vae_device_ms.train: device time per train step of cuDNN's
convolution and BatchNorm kernels (the conv VAE) in the traced slice;
the monitoring evals' share is spread over the steps."""

from portbench.harness import kernels


def read(run):
    if run.mode != 'train' or run.trace is None or not run.trace.units:
        return None
    t = run.trace.device_s(kernels.vae)
    return t / run.trace.units * 1e3 if t > 0 else None
