"""Dense MLP blocks (SwiGLU / plain), the counterpart of
``repro/models/lm/mlp.py``.

Under the ``model`` mesh axis (``ms``, a ``dist.ModelSplit``) the block
holds the ``tp`` posture's pieces: the column blocks of ``w_gate``/``w_up``
(and ``b_up``) and the row block of ``w_down``; one all-reduce of the
partial sums follows ``w_down``, and ``b_down`` is added once, after it."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import LMConfig
from .layers import P, gelu_tanh, silu


def mlp_specs(cfg: LMConfig, *, layers: int | None = None) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    lead = () if layers is None else (layers,)
    lax = () if layers is None else ("layers",)
    if cfg.mlp_gated:
        return {
            "w_gate": P(lead + (d, ff), lax + ("embed", "mlp")),
            "w_up": P(lead + (d, ff), lax + ("embed", "mlp")),
            "w_down": P(lead + (ff, d), lax + ("mlp", "embed")),
        }
    return {
        "w_up": P(lead + (d, ff), lax + ("embed", "mlp")),
        "b_up": P(lead + (ff,), lax + ("mlp",), init="zeros"),
        "w_down": P(lead + (ff, d), lax + ("mlp", "embed")),
        "b_down": P(lead + (d,), lax + (None,), init="zeros"),
    }


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {
        "silu": silu,
        "gelu": gelu_tanh,
        "relu": F.relu,
        "relu2": lambda x: torch.square(F.relu(x)),  # nemotron/minitron
    }[name]


def mlp_forward(params: dict, x: torch.Tensor, cfg: LMConfig, ms=None) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D]; ``ms``: the params are this rank's pieces."""
    act = _act(cfg.act)
    dt = x.dtype
    if ms is not None:
        x = ms.cotangent(x)
    if cfg.mlp_gated:
        h = act(x @ params["w_gate"].to(dt)) * (x @ params["w_up"].to(dt))
        y = h @ params["w_down"].to(dt)
        return y if ms is None else ms.sum(y)
    h = act(x @ params["w_up"].to(dt) + params["b_up"].to(dt))
    y = h @ params["w_down"].to(dt)
    return (y if ms is None else ms.sum(y)) + params["b_down"].to(dt)
