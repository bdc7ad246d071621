"""Shared plumbing of the HGNN models (the counterpart of
``repro.models.hgnn.common``; the serving slice needs only ``glorot``)."""
from __future__ import annotations

import math

import torch


def glorot(gen: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
    """Glorot-uniform float32 weights drawn from ``gen`` (a CPU generator,
    so the values do not depend on the device they are later moved to)."""
    fan_in, fan_out = shape[0], shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=torch.float32).uniform_(-lim, lim, generator=gen)
