"""Device choice and numerics of the port's entry points.

The entry points run on the card unless the caller asks for the CPU.
Asking for ``cuda`` on a host without a card raises: nothing degrades
quietly to the CPU.  On the card every float32 product runs in full
float32: TF32 is switched off for matmuls and cuDNN, because the port is
held against the JAX package at float32 tolerances.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """The torch device for ``device`` ('cuda', 'cuda:N' or 'cpu')."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is available "
                "(torch.cuda.is_available() is False); pass device='cpu' to run "
                "the plain PyTorch versions on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev


def barrier(value):
    """The host waits for the device when ``value`` (a tensor, or a tuple
    whose first item is one) lies on a card; a no-op on the CPU.  Returns
    ``value``."""
    t = value[0] if isinstance(value, tuple) else value
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return value
