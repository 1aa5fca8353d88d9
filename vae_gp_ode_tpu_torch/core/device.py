"""Device selection for the port's entry points.

Entry points take `device=` and default to the GPU. A missing GPU is an
error unless the caller asked for the CPU: nothing silently drops to the
CPU or to a kernel's plain version.
"""

import torch


def resolve_device(device='cuda'):
    """`torch.device` for `device`; raises if CUDA is asked for and absent.

    Also pins float32 matmuls and cuDNN convolutions to full float32 (no
    TF32): the reference computes at f32 `Precision.HIGHEST`.
    """
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {device!r} requested but CUDA is not available; '
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {device!r}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def check_device(t, device, what):
    """Raise unless tensor `t` lies on `device` (type and index)."""
    dev = torch.device(device)
    if t.device.type != dev.type or (
            dev.index is not None and t.device.index != dev.index):
        raise ValueError(f'{what} is on {t.device}, expected {dev}')
