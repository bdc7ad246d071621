"""Mixture-of-Experts with capacity-based sorted dispatch, the counterpart
of ``repro/models/lm/moe.py``.

HiHGNN's ideas on the LM side (DESIGN.md §5): experts play the part of the
semantic graphs, the router-weighted combine the part of GSF, and the
capacity drop the part of the overflow-workload bound — copies beyond an
expert's capacity go to the residual path.

As PyTorch ops.  Under the LM step's data group
(``dist.use_data_group``) each rank holds its share of a microbatch's
rows, and the balance loss's ``me`` and ``ce`` are averaged over the
group first (``dist.mean_over_data``), as the reference's means over the
global rows; routing and capacity are per row and need nothing.  The routing is the reference's,
decision for decision:

  * top-k by a stable descending sort, so equal probabilities go to the
    lower expert, as ``jax.lax.top_k`` gives them (``torch.topk`` on CUDA
    promises no order among ties);
  * per batch row, the flat (token, slot) copies in token-major order,
    sorted stably by expert: a copy's rank inside its expert is its
    arrival order, and copies of rank >= capacity are dropped.

The reference scatters the kept copies into an ``[E, cap]`` table and
sends dropped ones to slot (0, 0) with a ``max``/``+0`` guard, its way round
a dynamic shape; here the table is *gathered* from the sorted copies (slot
r of expert e is sorted copy ``start[e] + r``), and the combine gathers
each token's kept copies and sums them in top-k slot order.  Neither uses
a scatter-add, so the result is deterministic on the card.  The expert
FFNs run over all ``E · cap`` slots, empty ones too (zeros in, zeros out),
as the reference's einsums do.

Under the ``model`` mesh axis (``ms``, a ``dist.ModelSplit``) the router
stays whole on every rank, so every rank routes alike, and the layer holds
the ``tp`` posture's pieces of the experts: with ``cfg.ep_shard`` (dbrx's
16 experts) a block of whole experts, each rank running the FFNs of its
own over their capacity slots; without it (grok's 8) every expert with its
FFN split over ``mlp`` (column blocks of ``w_gate``/``w_up``, a row block
of ``w_down``).  Either way a rank's combine sums the kept copies it
computed, in slot order, and one all-reduce adds the ranks' partial sums;
the gates' gradient sums the ranks' parts (``ms.cotangent``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ...dist.sharding import mean_over_data
from .attention import _promoted
from .config import LMConfig
from .layers import P, silu


def moe_specs(cfg: LMConfig, *, layers: int | None = None) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = () if layers is None else (layers,)
    lax_ = () if layers is None else ("layers",)
    # experts shard on the model axis where they divide it (dbrx's 16);
    # otherwise they replicate and the FFN dim is tensor-parallel (grok's 8)
    ex = "experts" if cfg.ep_shard else None
    return {
        "router": P(lead + (d, e), lax_ + ("embed", None)),
        "w_gate": P(lead + (e, d, ff), lax_ + (ex, "embed", "mlp")),
        "w_up": P(lead + (e, d, ff), lax_ + (ex, "embed", "mlp")),
        "w_down": P(lead + (e, ff, d), lax_ + (ex, "mlp", "embed")),
    }


def _capacity(cfg: LMConfig, seq: int) -> int:
    c = int(seq * cfg.experts_per_tok * cfg.moe_capacity_factor / cfg.num_experts)
    return max(8, ((c + 7) // 8) * 8)


@dataclasses.dataclass
class Routing:
    """One MoE layer's routing of x [B, S, D]."""

    probs: torch.Tensor       # [B, S, E] float32 router softmax
    expert_ids: torch.Tensor  # [B, S, k] int64, best first
    gates: torch.Tensor       # [B, S, k] float32, renormalised over the k
    rank: torch.Tensor        # [B, S, k] int64: the copy's arrival order in its expert
    keep: torch.Tensor        # [B, S, k] bool: rank < capacity
    table: torch.Tensor       # [B, E, cap] int64 token of each expert slot, -1 empty
    gap: torch.Tensor         # [B, S] float32 logit of the k-th less the (k+1)-th (inf at k = E)


def route(params: dict, x: torch.Tensor, cfg: LMConfig) -> Routing:
    """The router, top-k and the per-row dispatch tables of ``x``."""
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.experts_per_tok
    cap = _capacity(cfg, s)
    dev = x.device
    # jnp promotes a float32 router under bf16 compute and never casts it down
    logits = torch.matmul(*_promoted(x, params["router"])).float()
    probs = torch.softmax(logits, dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = ranked[..., :k], order[..., :k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    if k < e:
        edge = logits.gather(-1, order[..., k - 1:k + 1])
        gap = edge[..., 0] - edge[..., 1]
    else:
        gap = torch.full((b, s), float("inf"), device=dev)

    n = s * k
    by_expert, perm = torch.sort(ids.reshape(b, n), dim=-1, stable=True)
    experts = torch.arange(e, device=dev).expand(b, e).contiguous()
    start = torch.searchsorted(by_expert, experts)                     # [B, E]
    count = torch.searchsorted(by_expert, experts, right=True) - start
    rank_sorted = torch.arange(n, device=dev) - start.gather(1, by_expert)
    rank = torch.empty_like(rank_sorted).scatter_(1, perm, rank_sorted)  # perm is a permutation
    slot = torch.arange(cap, device=dev)
    copy = perm.gather(1, (start[..., None] + slot).clamp_max(n - 1).reshape(b, e * cap))
    table = torch.where(slot < count[..., None], copy.reshape(b, e, cap) // k, -1)
    rank = rank.reshape(b, s, k)
    return Routing(probs=probs, expert_ids=ids, gates=gates, rank=rank, keep=rank < cap,
                   table=table, gap=gap)


# Two correct runs (flash and xla attention, the card and the CPU, two
# frameworks' bf16 roundings) may send a token whose k-th and (k+1)-th
# experts nearly tie to different experts.  Such a flip is explained when
# the two experts' router logits lie within NEAR_TIE of the compute dtype
# of each other in both runs (the logit gap is log p_k - log p_{k+1}, so
# it bounds the probability gap by p_k times itself): 1e-4 in float32; in
# bfloat16, whose logits carry 8 significant bits, 2^-5, one rounding
# step of a logit below 8 in magnitude.
NEAR_TIE = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -5}


def route_flips(ids_a: torch.Tensor, gap_a: torch.Tensor, ids_b: torch.Tensor,
                gap_b: torch.Tensor, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Two runs' routings of the same tokens (``expert_ids`` [..., k] and
    ``gap`` [...] of :class:`Routing`, any leading axes): the masks
    (flipped, unexplained) [...] of the tokens whose expert sets differ,
    and of those among them that are no near-tie in one of the runs."""
    flipped = (ids_a.sort(-1).values != ids_b.sort(-1).values).any(-1)
    return flipped, flipped & (torch.maximum(gap_a, gap_b) >= NEAR_TIE[dtype])


def moe_forward(
    params: dict, x: torch.Tensor, cfg: LMConfig, *, routes: list | None = None, ms=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D], aux_loss float32 scalar).

    Each batch row routes its S tokens independently.  ``routes``, when
    given, receives this layer's :class:`Routing`.  ``ms``: the expert
    weights are this rank's pieces (module docstring)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_tok
    r = route(params, x, cfg)
    if routes is not None:
        routes.append(r)
    cap = r.table.shape[-1]

    # load-balancing auxiliary loss (Switch-style), dropped copies counted too;
    # over the data group, the means of the whole microbatch's rows
    me = mean_over_data(r.probs.mean(dim=(0, 1)))
    ce = mean_over_data(F.one_hot(r.expert_ids, e).sum(dim=2).float().mean(dim=(0, 1)) / k)
    aux = e * torch.sum(me * ce)

    ids, keep, gates, table = r.expert_ids, r.keep, r.gates, r.table
    if ms is not None:
        x, gates = ms.cotangent(x), ms.cotangent(gates)
        if cfg.ep_shard:  # this rank's experts [e0, e1) and the copies routed to them
            e0, e1 = ms.block(e)
            keep = keep & (ids >= e0) & (ids < e1)
            ids, table, e = (ids - e0).clamp(0, e1 - e0 - 1), table[:, e0:e1], e1 - e0

    # xin [E, B·cap, D]: each expert's slots of every row; empty slots read a zero row
    rows = torch.where(table >= 0, table + s * torch.arange(b, device=x.device)[:, None, None],
                       b * s)
    xin = torch.cat([x.reshape(b * s, d), x.new_zeros(1, d)])[rows.transpose(0, 1).reshape(e, -1)]
    dt = x.dtype
    h = silu(torch.bmm(xin, params["w_gate"].to(dt))) * torch.bmm(xin, params["w_up"].to(dt))
    y = torch.bmm(h, params["w_down"].to(dt))  # [E, B·cap, D]

    # combine: each token's kept copies, gate cast to y's dtype, summed in slot order
    at = (ids * b + torch.arange(b, device=x.device)[:, None, None]) * cap \
        + r.rank.clamp_max(cap - 1)
    c = y.reshape(e * b * cap, d)[at.reshape(-1)].reshape(b, s, k, d)
    c = c * gates.to(y.dtype)[..., None]
    c = torch.where(keep[..., None], c, 0)  # dropped copies take the residual path
    out = c[:, :, 0]
    for j in range(1, k):
        out = out + c[:, :, j]
    if ms is not None:
        out = ms.sum(out)
    return out.to(x.dtype), aux.float()
