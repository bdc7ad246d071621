"""Train-step builder for the HGNN models (the counterpart of
``repro.train.hgnn``).

HGNNs train transductively: the forward runs over the whole resident graph
every step and the step's minibatch ``idx`` selects the labeled target
vertices whose cross-entropy is optimized.  The step runs eagerly: a
forward, one ``torch.autograd.grad`` (the NA backward is one launch of
kernel #2 or #4 on the kernel backends), then AdamW.

The minibatch loss is written so that its backward is elementwise and the
whole step is bitwise repeatable on the card: a per-vertex weight (the
count of the vertex in ``idx`` over ``len(idx)``) multiplies the full-graph
NLL, in place of ``logits[idx]``, whose backward would scatter with atomics.
It equals the reference's mean NLL over ``idx`` up to the order of the sum.

Under a model axis the state holds this rank's pieces of the sharded
leaves (``dist.sharding``, placed by :func:`hgnn_train_state_axes`
through ``param_shardings``): the step takes the placements and the mesh,
so that the gradient clip sees the whole gradient.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F

from ..models.hgnn.common import HGNNData, HGNNModel
from ..obs.trace import trace_span
from ..optim import AdamWConfig, apply_updates, init_opt_state, opt_state_axes
from ..tree import tree_leaves, tree_map, tree_unflatten
from .step import TrainState

# Logical parameter axes by leaf name (the reference's table): the lanes
# rules map "mlp"/"heads" onto the model axis and replicate the rest.
# Unknown names replicate.
_HGNN_PARAM_AXES: dict[str, tuple[str | None, ...]] = {
    "w_fp": ("embed", "mlp"),
    "b_fp": ("mlp",),
    "a_src": ("act_graph", "heads", None),
    "a_dst": ("act_graph", "heads", None),
    "w_src": ("embed", "mlp"),
    "w_dst": ("embed", "mlp"),
    "w_g": ("mlp", None),
    "w_out": ("mlp", None),
}


def hgnn_param_axes(params) -> Any:
    """Logical-axes tree of an HGNN params tree (the same structure): a
    leaf's axes are keyed by its last dict key; anything not in the table,
    or of another rank, replicates (``(None,) * ndim``)."""

    def axes(tree, name):
        if isinstance(tree, dict):
            return {k: axes(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(axes(v, None) for v in tree)
        ax = _HGNN_PARAM_AXES.get(name)
        return tuple(ax) if ax is not None and len(ax) == tree.dim() else (None,) * tree.dim()

    return axes(params, None)


def hgnn_train_state_axes(state: TrainState, opt_cfg: AdamWConfig) -> TrainState:
    """Logical-axes TrainState for ``dist.param_shardings``: an elastic
    restart derives the placements from this against whatever mesh the new
    run has (checkpoint leaves are logical)."""
    pax = hgnn_param_axes(state.params)
    return TrainState(params=pax, opt=opt_state_axes(pax, opt_cfg, state.params), step=())


def init_hgnn_train_state(
    model: HGNNModel, gen: torch.Generator, data: HGNNData, opt_cfg: AdamWConfig, **init_kw
) -> TrainState:
    params = model.init(gen, data, **init_kw)
    dev = data.features[data.target_type].device
    return TrainState(params=params, opt=init_opt_state(params, opt_cfg),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def hgnn_loss_and_grads(forward_fn: Callable[[Any], torch.Tensor], params, data: HGNNData,
                        idx: torch.Tensor):
    """(loss, acc, grads) of the minibatch ``idx``: one forward and one
    ``torch.autograd.grad``.  ``grads`` has the structure of ``params`` (a
    tree); a param the loss does not reach gets zeros, as under
    ``jax.grad``.

    Spans (DESIGN.md §12): ``step/forward``, ``step/backward`` (the grad
    and the zero fills) and ``step/loss`` twice, the weights before the
    forward (their host bincount and copy come first, while the card is
    idle anyway) and the NLL and accuracy after it."""
    labels = data.labels
    with trace_span("step/loss"):
        # the count of each vertex in idx over len(idx): the minibatch mean as an
        # elementwise weight on the full-graph NLL
        counts = torch.bincount(idx.detach().cpu().long(), minlength=labels.shape[0])
        weight = (counts.float() / idx.numel()).to(labels.device)
    with trace_span("step/forward"):
        params = tree_map(lambda p: p.detach().requires_grad_(), params)
        logits = forward_fn(params)
    with trace_span("step/loss"):
        logp = torch.log_softmax(logits.float(), dim=-1)
        onehot = F.one_hot(labels, data.num_classes).float()
        loss = -(weight * (logp * onehot).sum(dim=-1)).sum()
        with torch.no_grad():
            acc = (weight * (logp.argmax(dim=-1) == labels).float()).sum()
    with trace_span("step/backward"):
        leaves = tree_leaves(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree_unflatten(params, [torch.zeros_like(p) if g is None else g
                                        for p, g in zip(leaves, grads)])
    return loss.detach(), acc, grads


def make_hgnn_train_step(
    forward_fn: Callable[[Any], torch.Tensor],
    data: HGNNData,
    opt_cfg: AdamWConfig,
    *,
    lr_schedule: Callable[[torch.Tensor], torch.Tensor] | None = None,
    placements=None,
    mesh=None,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Build the HGNN train step.

    ``forward_fn(params) -> logits [N_target, C]`` runs the full-graph
    forward; ``batch["idx"]`` selects the step's labeled minibatch.
    Metrics (0-d tensors): ``loss``, minibatch accuracy ``acc``,
    ``grad_norm`` and ``lr``.  ``placements`` (``dist.param_shardings`` of
    the params) and ``mesh``: the params are this rank's pieces, and the
    gradient norm is the whole gradient's (``optim.apply_updates``).
    """
    if data.labels is None:
        raise ValueError("training needs labels in HGNNData")
    dev = data.labels.device
    if lr_schedule is None:  # one copy to the card here, none a step
        lr_const = torch.tensor(opt_cfg.lr, dtype=torch.float32, device=dev)
        lr_schedule = lambda s: lr_const  # noqa: E731

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        loss, acc, grads = hgnn_loss_and_grads(forward_fn, state.params, data, batch["idx"])
        with torch.no_grad(), trace_span("step/optimizer"):
            lr = lr_schedule(state.step)
            new_params, new_opt, gnorm = apply_updates(state.params, grads, state.opt, opt_cfg, lr,
                                                       placements=placements, mesh=mesh)
            new_step = state.step + 1
        metrics = {"loss": loss, "acc": acc, "grad_norm": gnorm, "lr": lr}
        return TrainState(params=new_params, opt=new_opt, step=new_step), metrics

    return train_step
