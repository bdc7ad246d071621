"""AdamW with a global-norm clip (the counterpart of ``repro.optim.adamw``,
its non-factored mode).

The state keeps the reference's layout, so a checkpoint of either package
restores into the other: ``m`` and ``v`` mirror the params, ``master`` holds
None for each param (the port's params are float32, which need no float32
master copy) and ``count`` is an int32 step counter.  Params are trees of
nested dicts and lists of tensors (``repro_torch.tree``): HAN's are one
flat dict, R-GAT's nest by layer and relation.  The factored
(Adafactor-style) mode serves the LM side and is not ported yet (ROADMAP
Queue 1 item 7h).

Under a model axis (``dist.sharding``) a leaf may be this rank's piece of
the logical one: :func:`global_norm` and :func:`apply_updates` then take
the leaves' placements and the mesh, and sum the squares of each sharded
leaf over the ranks that share it, so that every rank clips by the same
norm of the whole gradient.  The update itself is elementwise.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from ..dist.sharding import map_axes, placement_leaves
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


def opt_state_axes(param_axes, cfg: AdamWConfig, params_abstract=None) -> dict:
    """Logical axes of the optimizer state (the reference's non-factored
    form): ``m`` and ``v`` mirror the params' axes, ``count`` is a scalar,
    ``master`` mirrors them too, or, given the params, holds None for each
    (the port's params are float32 and keep no master copy)."""
    same = map_axes(lambda a: a, param_axes)
    master = same if params_abstract is None else map_axes(lambda _: None, param_axes)
    return {"m": same, "v": same, "master": master, "count": ()}


def _sum_over_shards(squares: list, placements, mesh) -> list:
    """Each leaf's sum of squares over the ranks that hold pieces of it:
    one all-reduce a mesh dimension that shards some leaf, of the sums of
    the leaves it shards (a replicated leaf is counted once)."""
    per_leaf = placement_leaves(placements)
    if len(per_leaf) != len(squares):
        raise ValueError(f"{len(per_leaf)} placements for {len(squares)} leaves")
    squares = list(squares)
    for d in range(mesh.ndim):
        on = [i for i, p in enumerate(per_leaf) if isinstance(p[d], Shard)]
        if mesh.size(d) == 1 or not on:
            continue
        part = torch.stack([squares[i] for i in on])
        dist.all_reduce(part, op=dist.ReduceOp.SUM, group=mesh.get_group(d))
        for i, v in zip(on, part.unbind()):
            squares[i] = v
    return squares


def global_norm(tree, *, placements=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares, leaf by leaf in JAX's ``tree_leaves``
    order (dict keys sorted, lists in order), as the reference sums them.
    With ``placements`` (``dist.param_shardings`` of ``tree``) and ``mesh``,
    the leaves are pieces and the norm is the whole tree's
    (:func:`_sum_over_shards`), the same on every rank."""
    squares = [torch.sum(torch.square(x)) for x in tree_leaves(tree)]
    if placements is not None and mesh is not None:
        squares = _sum_over_shards(squares, placements, mesh)
    return torch.sqrt(sum(squares))


def apply_updates(params, grads, state: dict, cfg: AdamWConfig, lr, *, placements=None,
                  mesh=None):
    """One optimizer step.  Returns (params, state, grad_norm); the inputs
    are not modified.  ``placements``/``mesh``: the leaves are pieces
    (:func:`global_norm`)."""
    gnorm = global_norm(grads, placements=placements, mesh=mesh)
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
