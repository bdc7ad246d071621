"""AdamW with a global-norm clip, the counterpart of ``repro.optim.adamw``.

The state keeps the reference's layout, so a checkpoint of either package
restores into the other.  Params are trees of nested dicts and lists of
tensors (``repro_torch.tree``): HAN's are one flat dict, R-GAT's nest by
layer and relation, an LM's by block.

* ``m`` and ``v`` mirror the params, in ``moment_dtype`` (bfloat16 halves
  their memory); ``count`` is an int32 step counter.
* A param narrower than float32 (bf16) keeps a float32 ``master`` copy
  (``master_fp32``); its working copy is re-derived from the master each
  step.  Every other param holds None there.
* ``factored=True`` is the Adafactor-style memory mode: no first moment,
  the second moment of each param of two or more dims factored over its
  last two (``v_row``, ``v_col``: row and column means), the rest kept
  whole (``v_full``).

:func:`apply_updates` returns new trees and leaves its inputs as they are
(the HGNN trainers rely on it); :func:`apply_updates_` writes the same
bits into the state it is given, a slice of each leaf at a time, so that
an LM step over 50 GB of state needs no second copy of it.  Both run the
reference's operations in its order.

On the card both take one route by what their inputs show: the unfactored
update of a tree whose leaves lie on a CUDA device, none sharded, runs as
one kernel pair over the whole tree (``kernels/fused_adamw.py``): no
clone, no host loop over the leaves, no scalar copied to the card.  The
kernels raise on operands they do not take (a dtype other than float32
or bfloat16, an ``lr`` that is not a float32 tensor on the card).  They
sum the norm in another order, so that route agrees with the loop to
float32 rounding.  CPU leaves, the factored mode and sharded leaves keep
the loop.

Under a model axis (``dist.sharding``) a leaf may be this rank's piece of
the logical one: :func:`global_norm` and the updates then take the
leaves' placements and the mesh, and sum the squares of each sharded leaf
over the ranks that share it, so that every rank clips by the same norm
of the whole gradient.  The unfactored update is elementwise; the
factored one takes its row and column means over the logical leaf: on a
piece, a mean over a sharded dim is the sum all-reduced over the mesh
dimensions that shard it, divided by the logical size (:func:`_piece_means`).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from ..dist.sharding import map_axes, placement_leaves
from ..kernels.fused_adamw import fused_adamw, on_card
from ..tree import tree_leaves, tree_leaves_at, tree_map, tree_unflatten

CHUNK = 1 << 26  # elements an update step takes of a leaf at a time (256 MiB in float32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    master_fp32: bool = True  # keep a float32 master when params are low-precision
    # Adafactor-style memory mode: no first moment, second moment factored
    # over the last two dims (row and column means)
    factored: bool = False


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _needs_master(p, cfg: AdamWConfig) -> bool:
    return cfg.master_fp32 and p.dtype != torch.float32


def _factorable(p) -> bool:
    return len(p.shape) >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    """The zero state of ``params`` in ``cfg``'s mode, on the params' device."""
    leaves = tree_leaves(params)
    master = tree_map(lambda p: p.float() if _needs_master(p, cfg) else None, params)
    count = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
    f32 = dict(dtype=torch.float32)
    if cfg.factored:
        return {
            "v_row": tree_map(lambda p: p.new_zeros(p.shape[:-1], **f32)
                              if _factorable(p) else None, params),
            "v_col": tree_map(lambda p: p.new_zeros(p.shape[:-2] + p.shape[-1:], **f32)
                              if _factorable(p) else None, params),
            "v_full": tree_map(lambda p: None if _factorable(p) else p.new_zeros(p.shape, **f32),
                               params),
            "master": master,
            "count": count,
        }
    mdt = _dtype(cfg.moment_dtype)
    return {
        "m": tree_map(lambda p: p.new_zeros(p.shape, dtype=mdt), params),
        "v": tree_map(lambda p: p.new_zeros(p.shape, dtype=mdt), params),
        "master": master,
        "count": count,
    }


def opt_state_axes(param_axes, cfg: AdamWConfig, params_abstract=None) -> dict:
    """Logical axes of the optimizer state, mirroring the params'.
    ``params_abstract`` (the params, or anything with their ``shape`` and
    ``dtype``) puts None where a leaf is absent: ``master`` of a float32
    param, and the factored slots a param does not use; the factored mode
    needs it."""
    same = map_axes(lambda a: a, param_axes)
    master = same
    if params_abstract is not None:
        master = map_axes(lambda a, p: a if _needs_master(p, cfg) else None,
                          param_axes, params_abstract)
    if cfg.factored:
        if params_abstract is None:
            raise ValueError("factored axes need the params' shapes (params_abstract)")
        row = map_axes(lambda a, p: tuple(a[:-1]) if _factorable(p) else None,
                       param_axes, params_abstract)
        col = map_axes(lambda a, p: tuple(a[:-2]) + (a[-1],) if _factorable(p) else None,
                       param_axes, params_abstract)
        full = map_axes(lambda a, p: None if _factorable(p) else a, param_axes, params_abstract)
        return {"v_row": row, "v_col": col, "v_full": full, "master": master, "count": ()}
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
    """sqrt of the sum of squares in float32, leaf by leaf in JAX's
    ``tree_leaves`` order (dict keys sorted, lists in order), as the
    reference sums them.  With ``placements`` (``dist.param_shardings`` of
    ``tree``) and ``mesh``, the leaves are pieces and the norm is the whole
    tree's (:func:`_sum_over_shards`), the same on every rank."""
    squares = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if placements is not None and mesh is not None:
        squares = _sum_over_shards(squares, placements, mesh)
    return torch.sqrt(sum(squares))


def _flat_chunks(*ts):
    """Matching flat slices of at most CHUNK elements of same-shaped
    tensors (None stays None)."""
    n = ts[0].numel()
    flat = [None if t is None else t.view(-1) for t in ts]
    for i in range(0, n, CHUNK):
        yield [None if f is None else f[i:i + CHUNK] for f in flat]


def _adamw_leaf(cfg: AdamWConfig, lr, scale, c1, c2, mdt, p, g, m, v, master):
    """One slice of a leaf: the reference's ``upd``, in its order."""
    g = g.float() * scale
    m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
    v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
    mhat = m32 / c1
    vhat = v32 / c2
    base = master if master is not None else p.float()
    step = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * base
    new_base = base - lr * step
    return new_base.to(p.dtype), m32.to(mdt), v32.to(mdt), new_base


def _mean(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.mean(dim=dim)


def _piece_means(placement, mesh, ndim: int):
    """(mean over the rows, mean over the columns) of a piece of a logical
    leaf of ``ndim`` dims that ``placement`` places on ``mesh``: each a
    ``mean(x, dim)`` that takes ``x``'s dim ``dim`` (holding the leaf's rows,
    resp. columns) as a block of the logical one.  A dim that no mesh
    dimension of more than one rank shards takes the plain mean."""
    def over(leaf_dim: int):
        groups = [(mesh.get_group(d), mesh.size(d)) for d, q in enumerate(placement)
                  if isinstance(q, Shard) and q.dim % ndim == leaf_dim and mesh.size(d) > 1]
        if not groups:
            return _mean

        def mean(x: torch.Tensor, dim: int) -> torch.Tensor:
            total = x.sum(dim=dim)
            n = x.shape[dim]
            for group, ranks in groups:
                dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
                n *= ranks
            return total / n

        return mean

    return over(ndim - 2), over(ndim - 1)


def _factored_leaf(cfg: AdamWConfig, lr, scale, p, g, vr, vc, vf, master, means=(_mean, _mean)):
    """One slice of a leaf: the reference's factored ``upd``, in its
    order.  A factorable slice is ``[n, rows, cols]`` with ``vr [n, rows]``
    and ``vc [n, cols]``; ``means``: the (rows, columns) means of a piece
    (:func:`_piece_means`)."""
    b2 = cfg.b2
    row_mean, col_mean = means
    g = g.float() * scale
    g2 = g * g + 1e-30
    if vr is not None:
        vr = b2 * vr + (1 - b2) * col_mean(g2, -1)
        vc = b2 * vc + (1 - b2) * row_mean(g2, -2)
        # V ≈ (R C) / mean(R): rank-1 reconstruction (Shazeer & Stern '18)
        denom = row_mean(vr, -1)[..., None]
        vhat = (vr / torch.clamp(denom, min=1e-30))[..., None] * vc[..., None, :]
    else:
        vf = b2 * vf + (1 - b2) * g2
        vhat = vf
    base = master if master is not None else p.float()
    step = g * torch.rsqrt(vhat + cfg.eps) + cfg.weight_decay * base
    new_base = base - lr * step
    return new_base.to(p.dtype), vr, vc, vf, new_base


def _factored_chunks(p, g, vr, vc, vf, master):
    """Matching slices of one leaf's tensors for :func:`_factored_leaf`:
    a factorable leaf as ``[n, rows, cols]`` cut along n (the means run
    over the last two dims, so a slice of whole matrices is exact), any
    other leaf elementwise."""
    if vr is None:
        yield from _flat_chunks(p, g, None, None, vf, master)
        return
    r, c = p.shape[-2], p.shape[-1]
    as3 = lambda t: None if t is None else t.view(-1, r, c)  # noqa: E731
    p3, g3, m3 = as3(p), as3(g), as3(master)
    vr2, vc2 = vr.view(-1, r), vc.view(-1, c)
    step = max(1, CHUNK // (r * c))
    for i in range(0, p3.shape[0], step):
        s = slice(i, i + step)
        yield [p3[s], g3[s], vr2[s], vc2[s], None, None if m3 is None else m3[s]]


def _write(dst, src) -> None:
    if dst is not None:
        dst.copy_(src)


def _clip_scale(cfg: AdamWConfig, gnorm: torch.Tensor) -> torch.Tensor:
    return torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)


def update_leaves_(cfg: AdamWConfig, lr, gnorm, params, grads, m, v, master, count) -> None:
    """The unfactored step of leaves (lists in ``tree_leaves`` order, None
    in ``master`` where a param keeps none) whose gradient norm is
    ``gnorm``, written in place (``count`` too): the reference's ``upd``,
    leaf by leaf, a slice at a time."""
    scale = _clip_scale(cfg, gnorm)
    count.add_(1)
    cf = count.float()
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=cf.device), cf)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=cf.device), cf)
    mdt = _dtype(cfg.moment_dtype)
    for p, g, mi, vi, ma in zip(params, grads, m, v, master):
        for cp, cg, cm, cv, cma in _flat_chunks(p, g.contiguous(), mi, vi, ma):
            out = _adamw_leaf(cfg, lr, scale, c1, c2, mdt, cp, cg, cm, cv, cma)
            for dst, src in zip((cp, cm, cv, cma), out):
                _write(dst, src)


def _leaves(params, grads, state: dict) -> tuple[list, ...]:
    """(params, grads, m, v, master) at the params' leaves."""
    flat = lambda t: tree_leaves_at(params, t)  # noqa: E731
    return (tree_leaves(params), flat(grads), flat(state["m"]), flat(state["v"]),
            flat(state["master"]))


def _fused(flat_params, placements, mesh) -> bool:
    """Whether the unfactored step of leaves ``flat_params`` takes the
    kernels (``kernels/fused_adamw.py``): leaves on a CUDA device, none
    sharded."""
    if placements is not None and mesh is not None and any(
            isinstance(q, Shard) for pl in placement_leaves(placements) for q in pl):
        return False
    return on_card(flat_params)


def apply_updates_(params, grads, state: dict, cfg: AdamWConfig, lr, *, placements=None,
                   mesh=None):
    """One optimizer step written into ``params`` and ``state`` (their
    tensors are updated in place, ``count`` too).  Returns (params, state,
    grad_norm).  On the loop each leaf is updated a slice at a time, so the
    step needs a few slices of scratch on top of the state; the kernels
    need none.  ``placements``/``mesh``: the leaves are pieces
    (:func:`global_norm`, :func:`_piece_means`)."""
    with torch.no_grad():
        count = state["count"]
        if not cfg.factored:
            leaves = _leaves(params, grads, state)
            if _fused(leaves[0], placements, mesh):
                gnorm = fused_adamw(cfg, lr, *leaves, count, in_place=True)[-1]
            else:
                gnorm = global_norm(grads, placements=placements, mesh=mesh)
                update_leaves_(cfg, lr, gnorm, *leaves, count)
            return params, state, gnorm
        gnorm = global_norm(grads, placements=placements, mesh=mesh)
        scale = _clip_scale(cfg, gnorm)
        count.add_(1)
        flat_p = tree_leaves(params)
        flat = lambda t: tree_leaves_at(params, t)  # noqa: E731
        pls = [None] * len(flat_p) if placements is None or mesh is None else \
            placement_leaves(placements)
        for p, g, vr, vc, vf, ma, pl in zip(flat_p, flat(grads), flat(state["v_row"]),
                                            flat(state["v_col"]), flat(state["v_full"]),
                                            flat(state["master"]), pls):
            means = (_mean, _mean) if pl is None else _piece_means(pl, mesh, p.dim())
            for cp, cg, cvr, cvc, cvf, cma in _factored_chunks(p, g.contiguous(), vr, vc, vf, ma):
                out = _factored_leaf(cfg, lr, scale, cp, cg, cvr, cvc, cvf, cma, means)
                for dst, src in zip((cp, cvr, cvc, cvf, cma), out):
                    _write(dst, src)
    return params, state, gnorm


def apply_updates(params, grads, state: dict, cfg: AdamWConfig, lr, *, placements=None,
                  mesh=None):
    """One optimizer step.  Returns (params, state, grad_norm), new trees;
    the inputs are not modified.  The bits are :func:`apply_updates_`'s.
    ``placements``/``mesh``: the leaves are pieces (:func:`global_norm`).
    On the kernels' route nothing is cloned: they read the old state and
    write fresh tensors, one a leaf."""
    if not cfg.factored:
        leaves = _leaves(params, grads, state)
        if _fused(leaves[0], placements, mesh):
            with torch.no_grad():
                p, m, v, master, count, gnorm = fused_adamw(cfg, lr, *leaves, state["count"],
                                                            in_place=False)
            tree = lambda xs: tree_unflatten(params, xs)  # noqa: E731
            new = dict(state, m=tree(m), v=tree(v), master=tree(master), count=count)
            return tree(p), new, gnorm
    clone = lambda t: tree_map(torch.clone, t)  # noqa: E731
    state = {k: clone(v) for k, v in state.items()}
    return apply_updates_(clone(params), grads, state, cfg, lr, placements=placements, mesh=mesh)
