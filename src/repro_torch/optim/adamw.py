"""AdamW with a global-norm clip (the counterpart of ``repro.optim.adamw``,
its non-factored mode).

The state keeps the reference's layout, so a checkpoint of either package
restores into the other: ``m`` and ``v`` mirror the params, ``master`` holds
None for each param (the port's params are float32, which need no float32
master copy) and ``count`` is an int32 step counter.  Params are flat dicts
of tensors, as HAN's are.  The factored (Adafactor-style) mode serves the
LM side and is not ported yet (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(params: dict, cfg: AdamWConfig) -> dict:
    for k, p in params.items():
        if p.dtype != torch.float32:
            raise TypeError(f"param {k!r} is {p.dtype}: the port's AdamW takes float32 params")
    dev = next(iter(params.values())).device
    return {
        "m": {k: torch.zeros_like(p) for k, p in params.items()},
        "v": {k: torch.zeros_like(p) for k, p in params.items()},
        "master": {k: None for k in params},
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(tree[k])) for k in sorted(tree)))


def apply_updates(params: dict, grads: dict, state: dict, cfg: AdamWConfig, lr):
    """One optimizer step.  Returns (params, state, grad_norm); the inputs
    are not modified."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = state["count"] + 1
    cf = count.float()
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=cf.device), cf)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=cf.device), cf)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k] * scale
        new_m[k] = cfg.b1 * state["m"][k] + (1 - cfg.b1) * g
        new_v[k] = cfg.b2 * state["v"][k] + (1 - cfg.b2) * g * g
        step = (new_m[k] / c1) / (torch.sqrt(new_v[k] / c2) + cfg.eps) + cfg.weight_decay * p
        new_p[k] = p - lr * step
    return new_p, {"m": new_m, "v": new_v, "master": dict(state["master"]), "count": count}, gnorm
