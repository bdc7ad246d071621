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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

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


def lm_loss(api: LMApi, params, batch: dict) -> tuple[torch.Tensor, dict]:
    """Next-token CE with the vocab padding masked; returns (loss + 0.01 ·
    aux, {"loss", "aux_loss"}).  ``batch["tokens"]`` is ``[B, S+1]``; the
    keys of ``BATCH_KEYS`` go to the forward."""
    cfg = api.cfg
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    kw = {k: batch[k] for k in BATCH_KEYS if k in batch}
    logits, aux = api.forward(params, inputs, **kw)
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


def loss_and_grads(api: LMApi, params, batch: dict, *, microbatches: int = 1,
                   grad_dtype: str | None = None) -> tuple[Any, dict]:
    """(grads, {"loss", "aux_loss"}) of ``batch`` (on the params' device),
    one forward and backward a microbatch, in the reference's order.

    With one microbatch the grads keep the params' dtype (``grad_dtype``
    when set), as ``jax.grad``'s do; with more they accumulate in float32,
    0 + g₁ + g₂ …, then ÷ n, and so do the metrics.
    ``grad_dtype="bfloat16"`` rounds each microbatch's grads to bf16 before
    they are added (the reference's compressed gradient all-reduce; with
    no mesh, only the rounding)."""
    gdt = torch_dtype(grad_dtype) if grad_dtype else None
    b = batch["tokens"].shape[0]
    if b % microbatches:
        raise ValueError(f"global batch {b} does not split into {microbatches} microbatches")
    n = b // microbatches
    accumulate = microbatches > 1
    grads = tree_map(lambda p: torch.zeros(p.shape, device=p.device, dtype=torch.float32
                                           if accumulate else gdt or p.dtype), params)
    dev = batch["tokens"].device
    loss_sum = aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(microbatches):
        mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        leaves, handles = _backward_leaves(params, grads, accumulate=accumulate, gdt=gdt)
        try:
            total, mx = lm_loss(api, leaves, mb)
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
    return grads, {"loss": loss, "aux_loss": aux}


def make_train_step(
    api: LMApi,
    opt_cfg: AdamWConfig,
    *,
    microbatches: int = 1,
    lr_schedule: Callable[[torch.Tensor], torch.Tensor] | None = None,
    grad_dtype: str | None = None,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Build the train step: ``step(state, batch) -> (state, metrics)``,
    batch leaves ``[B_global, ...]`` (moved to the state's device), the
    state updated in place.  Metrics (0-d tensors): ``loss``, ``aux_loss``,
    ``grad_norm`` and ``lr``.  ``microbatches`` and ``grad_dtype``: see
    :func:`loss_and_grads`."""
    sched = lr_schedule or (lambda s: warmup_cosine(s, peak_lr=opt_cfg.lr))

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        dev = state.step.device
        batch = {k: v.to(dev) for k, v in batch.items()}
        grads, metrics = loss_and_grads(api, state.params, batch, microbatches=microbatches,
                                        grad_dtype=grad_dtype)
        lr = torch.as_tensor(sched(state.step), dtype=torch.float32, device=dev)
        params, opt, gnorm = apply_updates_(state.params, grads, state.opt, opt_cfg, lr)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return TrainState(params=params, opt=opt, step=state.step + 1), metrics

    return train_step
