"""Shared LM building blocks: parameter specs and their logical axes, the
activations, RMS and layer norms, RoPE, M-RoPE and sinusoidal positions.

The counterpart of ``repro/models/lm/layers.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ...tree import tree_map


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype string ("bfloat16", "float32")."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------------
# Spec-driven parameters: one source of truth for shape and initializer.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class P:
    """Parameter spec: shape, logical sharding axes, initializer."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones
    scale: float | None = None  # stddev; default fan-in

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in length")


def is_spec(x: Any) -> bool:
    return isinstance(x, P)


DRAW_ELEMENTS = 1 << 30  # the largest float32 draw of one leaf (4 GiB)


def init_from_specs(specs, generator: torch.Generator, param_dtype=torch.float32,
                    device: torch.device | str | None = None):
    """A tree of tensors of ``specs``' structure (nested dicts and lists
    of :class:`P`).  ``normal`` leaves are drawn from ``generator`` on its
    device, in float32, times the spec's scale or 1/sqrt(fan-in), then cast
    to ``param_dtype``; ``zeros`` and ``ones`` are constant.  A leaf of more
    than ``DRAW_ELEMENTS`` is drawn one slice of its leading axis at a time,
    so its float32 draw never exists whole (a stacked expert tensor of
    dbrx-132b at 8 layers would take 34 GB).  The tensors
    land on ``device`` (default: the generator's).  The draws are not
    JAX's: parity tests carry the reference's weights across instead
    (``convert.lm_params_from_numpy``)."""
    device = torch.device(device) if device is not None else generator.device

    def normal(shape: tuple[int, ...], std: float) -> torch.Tensor:
        if np.prod(shape) <= DRAW_ELEMENTS or len(shape) < 2:
            x = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=generator.device)
            return (x * std).to(device=device, dtype=param_dtype)
        out = torch.empty(shape, dtype=param_dtype, device=device)
        for i in range(shape[0]):
            out[i] = normal(shape[1:], std)
        return out

    def mk(spec: P):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=param_dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=param_dtype, device=device)
        if spec.init != "normal":
            raise ValueError(f"unknown initializer {spec.init!r}")
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale if spec.scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
        return normal(spec.shape, std)

    return tree_map(mk, specs)


def abstract_from_specs(specs, param_dtype=torch.float32, device="meta"):
    """The counterpart of the reference's (a ``jax.ShapeDtypeStruct`` a
    leaf): a tree of ``specs``' structure whose leaves are tensors of each
    spec's shape in ``param_dtype`` (a torch dtype or a config's dtype
    string) that hold no data: on the ``meta`` device, or, under a
    ``FakeTensorMode`` with a real ``device``, fake tensors of it (a dry
    run's)."""
    dt = torch_dtype(param_dtype) if isinstance(param_dtype, str) else param_dtype
    return tree_map(lambda s: torch.empty(s.shape, dtype=dt, device=device), specs)


def axes_from_specs(specs):
    """The tree of logical axes (one tuple of axis names a leaf) of
    ``specs``' structure: what ``dist.param_shardings`` maps to placements."""
    return tree_map(lambda s: s.axes, specs)


# ---------------------------------------------------------------------------
# Activations, with jax.nn's roundings
# ---------------------------------------------------------------------------
# In a dtype narrower than float32 XLA rounds after every primitive of
# jax.nn's expressions, constants included; one fused torch op rounds once
# and differs from it in a third of bf16 elements.  So the narrow forms run
# the reference's primitives one torch op at a time.  In float32 XLA fuses
# them, and the single torch ops are the nearer.

def _narrow(x: torch.Tensor) -> bool:
    return torch.finfo(x.dtype).bits < 32


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * logistic(x)``.  Narrow dtypes take its four
    roundings, ``exp(-x)``, ``+ 1``, the reciprocal and the product."""
    if not _narrow(x):
        return x * torch.sigmoid(x)
    return x * (1 / (1 + torch.exp(-x)))


_GELU_C = 0.044715
_GELU_S = math.sqrt(2 / math.pi)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation).  Narrow dtypes take its
    eight roundings: ``x·x·x``, ``× c``, ``+ x``, ``× sqrt(2/π)``, tanh,
    ``+ 1``, ``× 0.5`` and ``x ×``, the constants cast to the dtype first
    (in bf16 ``4.4678e-2`` and ``0.796875``)."""
    if not _narrow(x):
        return torch.nn.functional.gelu(x, approximate="tanh")
    c = torch.tensor(_GELU_C, dtype=x.dtype, device=x.device)
    s = torch.tensor(_GELU_S, dtype=x.dtype, device=x.device)
    inner = s * (x + c * (x * x * x))
    return x * (0.5 * (1 + torch.tanh(inner)))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32, cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm with float32 statistics, cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * scale + bias).to(dt)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------

def _inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    """``1 / theta ** (i / half)`` for the ``half = head_dim // 2`` slots, in
    float32 with the reference's bits: the float32 exponent, the power
    taken in float64 and rounded once (XLA's float32 power is correctly
    rounded where ``torch.pow`` in float32 can be an ulp off), then the
    float32 reciprocal."""
    half = head_dim // 2
    expo = torch.arange(0, half, dtype=torch.float32, device=device) / half
    base = torch.tensor(theta, dtype=torch.float32, device=device).double()
    return 1.0 / torch.pow(base, expo.double()).float()


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """positions [..., S] -> angles [..., S, head_dim//2] (float32)."""
    return positions.float()[..., None] * _inv_freq(head_dim, theta, positions.device)


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: positions ``[..., S, 3]`` (t, h, w) ->
    angles ``[..., S, head_dim//2]`` (float32).  The frequency slots are
    split into (temporal, height, width) sections, each driven by its own
    position component; text tokens carry t == h == w, which reduces to
    :func:`rope_angles`."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"m_rope sections {tuple(sections)} must sum to head_dim // 2 = {half}")
    inv_freq = _inv_freq(head_dim, theta, positions.device)
    sec_id = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)],
                          device=positions.device)
    pos = positions.float()[..., sec_id]  # [..., S, half]: slot j reads component sec_id[j]
    return pos * inv_freq


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, Dh]; angles [B, S, Dh//2] -> rotated x (llama-style
    rotate-half layout).  cos and sin are cast to ``x``'s dtype before the
    products, as in the reference."""
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def sinusoidal_positions(n: int, d: int) -> torch.Tensor:
    """Whisper-style fixed positional embeddings ``[n, d]`` (float32), built
    in float64 and then cast, as the reference builds them in numpy."""
    pos = np.arange(n)[:, None]
    idx = np.arange(d // 2)[None, :]
    angle = pos / (10000 ** (idx / max(d // 2 - 1, 1)))
    out = np.concatenate([np.sin(angle), np.cos(angle)], axis=1)
    return torch.from_numpy(out.astype(np.float32))
