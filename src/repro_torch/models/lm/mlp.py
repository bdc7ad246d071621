"""Dense MLP blocks (SwiGLU / plain), the counterpart of
``repro/models/lm/mlp.py``."""
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


def mlp_forward(params: dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D]."""
    act = _act(cfg.act)
    dt = x.dtype
    if cfg.mlp_gated:
        h = act(x @ params["w_gate"].to(dt)) * (x @ params["w_up"].to(dt))
        return h @ params["w_down"].to(dt)
    h = act(x @ params["w_up"].to(dt) + params["b_up"].to(dt))
    return h @ params["w_down"].to(dt) + params["b_down"].to(dt)
