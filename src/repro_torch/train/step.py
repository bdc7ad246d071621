"""The train state the trainers share and the LM train step, the
counterpart of ``repro.train.step``.

The step runs eagerly, one microbatch at a time:

* ``lm_loss``: next-token cross-entropy in float32, the padded vocab
  masked out of the softmax, the MoE balance loss folded in at 0.01;
* microbatch accumulation in float32 in the reference's order (0 + g₁ +
  g₂ …, then ÷ n), each microbatch's grads rounded to ``grad_dtype``
  first when it is set;
* AdamW with the global-norm clip (``optim.apply_updates_``).

The step owns the state it is given, as a donated jitted step does: it
writes the new params and optimizer state into the same tensors and
returns them, so that llama3.2-3b's 51 GB of float32 params, grads, m and
v fit one card with no second copy.  Each param reaches the forward as a
detached leaf (a stacked ``[L, ...]`` leaf as L of them, one a layer),
whose gradient a hook adds into its slice of the accumulator as the
backward produces it and then drops.

Over a data mesh (``launch.mesh.make_data_mesh``: ``(n, 1)`` over
``("data", "model")``, every parameter replicated, the reference's
``make_rules(batch_shard=True, fsdp=False)``) each rank runs the same
microbatches on its share of each one's rows (:func:`data_rows`), under
the data group (``dist.use_data_group``: the MoE balance loss averages
over it); after the loop the accumulated grads are summed over the group
and divided by n, one all-reduce a leaf, and every rank applies the same
update, so the replicas stay bitwise equal.

Over a ``(data, model)`` mesh with the ``tp`` posture's placements
(``dist.param_shardings`` of :func:`train_state_axes` under
``make_rules(fsdp=cfg.fsdp)``; ``placements=``) the state holds this
rank's pieces and the forward computes on them (``transformer.forward``
with the mesh).  The loss takes the logits split by vocab over ``model``
(:func:`vocab_split_nll`).  A leaf that ``fsdp`` shards over the data axes
is gathered in the forward and its grad reduce-scattered in the backward
(``dist.gather_fsdp``), so it is already summed over the data ranks and
:func:`reduce_over_data` only divides it; every other leaf is all-reduced
over data as before.  The clip's norm goes over the pieces
(``optim.global_norm``), and the factored update takes its means over the
logical leaf (``optim.adamw``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..dist.sharding import data_sharded, model_split, placement_leaves, use_data_group
from ..models.lm.api import LMApi
from ..models.lm.layers import torch_dtype
from ..optim import AdamWConfig, apply_updates_, init_opt_state, opt_state_axes
from ..optim.schedules import warmup_cosine
from ..runtime import resolve_device
from ..tree import tree_leaves, tree_map

BATCH_KEYS = ("frames", "positions", "visual_embeds")  # forwarded to api.forward when present
STACKED = ("scan", "encoder", "decoder")  # the params' subtrees stacked on a layer axis


@dataclasses.dataclass
class TrainState:
    params: Any          # a tree of tensors (repro_torch.tree)
    opt: Any             # the optimizer state (optim.adamw layout)
    step: torch.Tensor   # int32 scalar


def init_train_state(api: LMApi, generator: torch.Generator, opt_cfg: AdamWConfig,
                     device: str | torch.device = "cuda") -> TrainState:
    """Random params from ``generator`` (``api.init``) and a zero optimizer
    state, on ``device``."""
    dev = resolve_device(device)
    params = api.init(generator, device=dev)
    return TrainState(params=params, opt=init_opt_state(params, opt_cfg),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def train_state_axes(api: LMApi, opt_cfg: AdamWConfig, params_abstract=None) -> TrainState:
    """The logical axes of the train state (``dist.param_shardings`` maps
    them to placements); ``params_abstract``: see ``optim.opt_state_axes``."""
    pax = api.axes()
    return TrainState(params=pax, opt=opt_state_axes(pax, opt_cfg, params_abstract), step=())


def vocab_split_nll(logits: torch.Tensor, targets: torch.Tensor, vocab_size: int,
                    ms) -> torch.Tensor:
    """The next-token NLL ``[B, S]`` from logits split by vocab over the
    ``model`` ranks (``ms``; this rank's block ``[B, S, V_pad/m]``): the
    padded slots (global index ``>= vocab_size``) masked out, the max, the
    log-sum-exp and the target's logit (on the one rank whose block holds
    it) each taken over the ranks.  The same on every rank."""
    n = logits.shape[-1]
    lo = ms.rank * n
    logits = logits.float()
    pad = torch.arange(lo, lo + n, device=logits.device) >= vocab_size
    logits = torch.where(pad, -1e30, logits)
    top = ms.max(logits.amax(dim=-1, keepdim=True))
    lse = top[..., 0] + torch.log(ms.sum(torch.exp(logits - top).sum(dim=-1)))
    t = targets.long() - lo
    inside = (t >= 0) & (t < n)
    picked = logits.gather(-1, t.clamp(0, n - 1)[..., None])[..., 0]
    return lse - ms.sum(torch.where(inside, picked, 0.0))


def lm_loss(api: LMApi, params, batch: dict, *, mesh=None,
            placements=None) -> tuple[torch.Tensor, dict]:
    """Next-token CE with the vocab padding masked; returns (loss + 0.01 ·
    aux, {"loss", "aux_loss"}).  ``batch["tokens"]`` is ``[B, S+1]``; the
    keys of ``BATCH_KEYS`` go to the forward.  ``mesh``/``placements``:
    the params are this rank's pieces (``transformer.forward``), and under
    a model split the logits stay split by vocab (:func:`vocab_split_nll`)."""
    cfg = api.cfg
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    kw = {k: batch[k] for k in BATCH_KEYS if k in batch}
    ms = model_split(mesh)
    if placements is not None:
        kw.update(mesh=mesh, placements=placements, split_logits=True)
    logits, aux = api.forward(params, inputs, **kw)
    if ms is not None:
        loss = vocab_split_nll(logits, targets, cfg.vocab_size, ms).mean()
        return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux}
    vp = logits.shape[-1]
    logits = logits.float()
    if vp > cfg.vocab_size:  # mask padded vocab slots out of the softmax
        pad = torch.arange(vp, device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad, -1e30, logits)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    loss = nll.mean()
    return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux}


class _PerLayer:
    """A stacked leaf handed to the forward as one autograd leaf a layer
    (``transformer._layer`` indexes it).  Indexing the stacked tensor
    itself would make the backward build a full-size gradient for every
    layer (``select``'s backward) and sum them."""

    def __init__(self, parts: list):
        self.parts = parts

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.parts[i]


def _backward_leaves(params, grads, *, accumulate: bool, gdt):
    """(params as detached autograd leaves, hook handles).  Each leaf's
    hook takes its gradient as the backward produces it, rounded to
    ``gdt`` when set, into its slice of ``grads``: added with
    ``accumulate``, else copied; then drops it."""
    handles = []

    def attach(part: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
        def hook(t: torch.Tensor) -> None:
            g = t.grad if gdt is None else t.grad.to(gdt)
            t.grad = None
            if accumulate:
                acc.add_(g)
            else:
                acc.copy_(g)

        part = part.detach().requires_grad_()
        handles.append(part.register_post_accumulate_grad_hook(hook))
        return part

    def per_layer(p, acc):
        return _PerLayer([attach(p[i], acc[i]) for i in range(p.shape[0])])

    leaves = {k: tree_map(per_layer if k in STACKED else attach, v, grads[k])
              for k, v in params.items()}
    return leaves, handles


def data_rows(batch: dict, microbatches: int, ranks: int, rank: int) -> dict:
    """The rows of a global batch ``[B, ...]`` that rank ``rank`` of a data
    group of ``ranks`` takes: of each microbatch i, rows ``[i·B/m +
    rank·B/(m·n), i·B/m + (rank+1)·B/(m·n))``, the microbatches in order.
    The reference reshapes the batch into ``[m, B/m, ...]`` and shards each
    microbatch over ``data``, so a rank's share of a microbatch is a block
    of it, not a contiguous n-th of the global batch."""
    b = batch["tokens"].shape[0]
    if b % (microbatches * ranks):
        raise ValueError(f"global batch {b} does not split into {microbatches} microbatches "
                         f"over {ranks} data ranks")
    k = b // (microbatches * ranks)

    def take(v: torch.Tensor) -> torch.Tensor:
        rest = tuple(v.shape[1:])
        return v.reshape((microbatches, ranks, k) + rest)[:, rank].reshape((microbatches * k,)
                                                                          + rest)

    return {key: take(v) for key, v in batch.items()}


def data_group(mesh):
    """(group, ranks, rank) of ``mesh``'s data axes: every dimension but
    ``model`` (``data``; ``("pod", "data")`` flattened into one group on a
    multi-pod mesh, the pod major, as the reference's compound axis)."""
    names = mesh.mesh_dim_names
    if "data" not in names:
        raise ValueError(f"the LM step splits its batch over a 'data' mesh dimension; the mesh "
                         f"has {names}")
    axes = tuple(n for n in names if n != "model")
    if len(axes) == 1:
        d = names.index("data")
        return mesh.get_group(d), mesh.size(d), mesh.get_local_rank(d)
    flat = mesh[axes]._flatten()
    return flat.get_group(), flat.size(), flat.get_local_rank()


def reduce_over_data(grads, metrics: dict, group, *, wire_dtype=None, summed=None) -> dict:
    """Sum each grad leaf over the data group in place and divide it by the
    group's size (one all-reduce a leaf; the leaf goes on the wire in
    ``wire_dtype`` when set, and comes back into its own dtype); returns
    the group's means of the metrics.  Every rank ends with the same
    bits.  ``summed`` (a bool a leaf, ``tree_leaves`` order): the leaves
    whose grads the backward already summed over the group (``fsdp``
    leaves, :func:`dist.gather_fsdp`), which are only divided."""
    n = dist.get_world_size(group)
    leaves = tree_leaves(grads)
    for g, done in zip(leaves, summed or [False] * len(leaves)):
        if done:
            pass
        elif wire_dtype is not None and g.dtype != wire_dtype:
            w = g.to(wire_dtype)
            dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
            g.copy_(w)
        else:
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        g.div_(n)
    keys = sorted(metrics)
    m = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(m, op=dist.ReduceOp.SUM, group=group)
    return dict(zip(keys, m / n))


def loss_and_grads(api: LMApi, params, batch: dict, *, microbatches: int = 1,
                   grad_dtype: str | None = None, mesh=None,
                   placements=None) -> tuple[Any, dict]:
    """(grads, {"loss", "aux_loss"}) of ``batch`` (on the params' device),
    one forward and backward a microbatch, in the reference's order.

    With one microbatch the grads keep the params' dtype (``grad_dtype``
    when set), as ``jax.grad``'s do; with more they accumulate in float32,
    0 + g₁ + g₂ …, then ÷ n, and so do the metrics.
    ``grad_dtype="bfloat16"`` rounds each microbatch's grads to bf16 before
    they are added (the reference's compressed gradient all-reduce; with
    no mesh, only the rounding).

    With a ``mesh`` the batch is still the global one: this rank runs its
    rows of each microbatch (:func:`data_rows`; the ranks of a model group
    take the same rows) under the data group, then :func:`reduce_over_data`
    sums the grads over the group (in ``grad_dtype`` on the wire when set)
    and divides them by its size: the grads and metrics of the global
    batch, the same on every rank of a data group.  ``placements``
    (``dist.param_shardings`` of the params' axes; needed where the mesh
    splits ``model`` or ``fsdp`` shards a leaf): the params and grads are
    this rank's pieces."""
    gdt = torch_dtype(grad_dtype) if grad_dtype else None
    group, summed = None, None
    if mesh is not None:
        if model_split(mesh) is not None and placements is None:
            raise ValueError("a model split needs the params' placements")
        group, ranks, rank = data_group(mesh)
        batch = data_rows(batch, microbatches, ranks, rank)
        if placements is not None:
            summed = [data_sharded(pl, mesh) for pl in placement_leaves(placements)]
    b = batch["tokens"].shape[0]
    if b % microbatches:
        raise ValueError(f"global batch {b} does not split into {microbatches} microbatches")
    n = b // microbatches
    accumulate = microbatches > 1
    grads = tree_map(lambda p: torch.zeros(p.shape, device=p.device, dtype=torch.float32
                                           if accumulate else gdt or p.dtype), params)
    dev = batch["tokens"].device
    loss_sum = aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
    with use_data_group(group):
        for i in range(microbatches):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            leaves, handles = _backward_leaves(params, grads, accumulate=accumulate, gdt=gdt)
            try:
                total, mx = lm_loss(api, leaves, mb, mesh=mesh, placements=placements)
                total.backward()
            finally:
                for h in handles:
                    h.remove()
            loss, aux = mx["loss"].detach(), mx["aux_loss"].detach()
            loss_sum, aux_sum = loss_sum + loss, aux_sum + aux
            del leaves, total, mx
    if accumulate:
        for g in tree_leaves(grads):
            g.div_(microbatches)
        loss, aux = loss_sum / microbatches, aux_sum / microbatches
    metrics = {"loss": loss, "aux_loss": aux}
    if group is not None:
        metrics = reduce_over_data(grads, metrics, group, wire_dtype=gdt, summed=summed)
    return grads, metrics


def make_train_step(
    api: LMApi,
    opt_cfg: AdamWConfig,
    *,
    microbatches: int = 1,
    lr_schedule: Callable[[torch.Tensor], torch.Tensor] | None = None,
    grad_dtype: str | None = None,
    mesh=None,
    placements=None,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Build the train step: ``step(state, batch) -> (state, metrics)``,
    batch leaves ``[B_global, ...]`` (moved to the state's device), the
    state updated in place.  Metrics (0-d tensors): ``loss``, ``aux_loss``,
    ``grad_norm`` and ``lr``.  ``microbatches``, ``grad_dtype`` and the
    ``mesh`` (``launch.mesh.make_data_mesh`` or a ``(data, model)`` mesh;
    None: one process): see :func:`loss_and_grads`.  ``placements``: the
    :class:`TrainState`'s (``dist.param_shardings`` of
    :func:`train_state_axes`), its leaves this rank's pieces.  Over a mesh
    the metrics are the data group's, the same on every rank, and so is
    the update of every piece."""
    sched = lr_schedule or (lambda s: warmup_cosine(s, peak_lr=opt_cfg.lr))
    ppl = None if placements is None else placements.params

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        dev = state.step.device
        batch = {k: v.to(dev) for k, v in batch.items()}
        grads, metrics = loss_and_grads(api, state.params, batch, microbatches=microbatches,
                                        grad_dtype=grad_dtype, mesh=mesh, placements=ppl)
        lr = torch.as_tensor(sched(state.step), dtype=torch.float32, device=dev)
        params, opt, gnorm = apply_updates_(state.params, grads, state.opt, opt_cfg, lr,
                                            placements=ppl, mesh=None if ppl is None else mesh)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return TrainState(params=params, opt=opt, step=state.step + 1), metrics

    return train_step
