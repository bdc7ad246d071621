"""AdamW with a global-norm clip (the counterpart of ``repro.optim.adamw``,
its non-factored mode).

The state keeps the reference's layout, so a checkpoint of either package
restores into the other: ``m`` and ``v`` mirror the params, ``master`` holds
None for each param (the port's params are float32, which need no float32
master copy) and ``count`` is an int32 step counter.  Params are trees of
nested dicts and lists of tensors (``repro_torch.tree``): HAN's are one
flat dict, R-GAT's nest by layer and relation.  The factored
(Adafactor-style) mode serves the LM side and is not ported yet (ROADMAP
Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses

import torch

from ..tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    leaves = tree_leaves(params)
    for p in leaves:
        if p.dtype != torch.float32:
            raise TypeError(f"a param is {p.dtype}: the port's AdamW takes float32 params")
    return {
        "m": tree_map(torch.zeros_like, params),
        "v": tree_map(torch.zeros_like, params),
        "master": tree_map(lambda _: None, params),
        "count": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares, leaf by leaf in JAX's ``tree_leaves``
    order (dict keys sorted, lists in order), as the reference sums them."""
    return torch.sqrt(sum(torch.sum(torch.square(x)) for x in tree_leaves(tree)))


def apply_updates(params, grads, state: dict, cfg: AdamWConfig, lr):
    """One optimizer step.  Returns (params, state, grad_norm); the inputs
    are not modified."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = state["count"] + 1
    cf = count.float()
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=cf.device), cf)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=cf.device), cf)

    def upd(p, g, m, v):
        g = g * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) + cfg.weight_decay * p
        return p - lr * step, m, v

    out = tree_map(upd, params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda _, o: o[i], params, out)  # noqa: E731
    new_state = {"m": pick(1), "v": pick(2), "master": tree_map(lambda _: None, params),
                 "count": count}
    return pick(0), new_state, gnorm
