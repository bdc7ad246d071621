"""Shared plumbing of the HGNN models (the counterpart of
``repro.models.hgnn.common``).

Models are (params, pure function) pairs as in the reference: ``init(gen,
data, **kw) -> params`` (a tree of nested dicts and lists of float32
tensors, the reference's names and layout, drawn from an explicit
``torch.Generator`` in place of ``split_keys``) and ``forward(params, data,
*, backend) -> logits``.  Parameters are plain tensors; a train step makes
them require grad for its own forward.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

from ...core.fusion import JointGraph, NABackend, SemanticGraphBatch, batch_semantic_graph
from ...core.multilane import MultiLanePlan, build_multilane_plan
from ...graphs.hetgraph import HetGraph, SemanticGraph
from ...runtime import resolve_device


@dataclasses.dataclass
class HGNNData:
    """Device-resident inputs for one HGNN forward pass."""

    features: dict[str, torch.Tensor]        # type -> [N_t, D_t]
    graphs: list[SemanticGraphBatch]
    target_type: str
    num_classes: int
    labels: torch.Tensor | None = None       # int64 [N_target]
    joint: JointGraph | None = None          # every relation over one table (Simple-HGN)
    _plan: tuple | None = dataclasses.field(default=None, init=False, repr=False,
                                            compare=False)

    @property
    def feature_dims(self) -> dict[str, int]:
        return {t: int(x.shape[1]) for t, x in self.features.items()}

    def plan(self) -> MultiLanePlan:
        """The one-lane plan of ``graphs`` (``core.multilane``), which HAN's
        MULTIGRAPH and FUSED_FP backends run over: it and the unit tables
        and kernel indexes it keeps are built on first use and kept while
        ``graphs`` holds the same batches, since the topology is the same
        in every step."""
        if self._plan is None or len(self._plan[0]) != len(self.graphs) or any(
                a is not b for a, b in zip(self._plan[0], self.graphs)):
            self._plan = (tuple(self.graphs), build_multilane_plan(self.graphs, 1))
        return self._plan[1]


def prepare_data(
    g: HetGraph,
    sgs: Sequence[SemanticGraph],
    target_type: str,
    num_classes: int,
    labels: np.ndarray | None = None,
    *,
    block: int = 16,
    device: str | torch.device = "cuda",
) -> HGNNData:
    """Move a graph and its semantic graphs to ``device`` (the card unless
    the caller asks for the CPU; raises on a host without a card): each
    graph's block CSR now, its padded edge list when SEGMENT or mean NA
    first reads it."""
    device = resolve_device(device)
    return HGNNData(
        features={t: torch.as_tensor(x, device=device) for t, x in g.features.items()},
        graphs=[batch_semantic_graph(s, block=block, device=device) for s in sgs],
        target_type=target_type,
        num_classes=num_classes,
        labels=None if labels is None else torch.as_tensor(labels, device=device).long(),
    )


def live_relations(graphs: Sequence[SemanticGraphBatch], target_type: str,
                   layers: int) -> list[tuple[tuple[int, ...], frozenset[str]]]:
    """Per layer, the relation passes whose output reaches the logits:
    ``(indexes of the live graphs, the types whose new h is built)``.

    From the last layer down: the last layer builds the target type alone;
    a relation is live in a layer when its destination type is built
    there; the layer before builds every type a live relation reads (its
    source, and its destination for θ_dst) and every built type that no
    relation enters (it takes its ``self`` product of the layer before).
    It reads only the relations' endpoint types: where every relation
    reaches the target, every pass is live."""
    entered = {g.dst_type for g in graphs}
    need = {target_type}
    schedule = []
    for _ in range(layers):
        live = tuple(i for i, g in enumerate(graphs) if g.dst_type in need)
        schedule.append((live, frozenset(need)))
        need = {t for i in live for t in (graphs[i].src_type, graphs[i].dst_type)} | (
            need - entered)
    return schedule[::-1]


def glorot(gen: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
    """Glorot-uniform float32 weights drawn from ``gen`` (a CPU generator,
    so the values do not depend on the device they are later moved to)."""
    fan_in, fan_out = shape[0], shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=torch.float32).uniform_(-lim, lim, generator=gen)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[:, None])[:, 0].mean()


ForwardFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class HGNNModel:
    name: str
    init: Callable[..., dict]
    forward: ForwardFn  # (params, data, *, backend) -> logits

    def loss_fn(self, params, data: HGNNData, *, backend: NABackend = NABackend.SEGMENT):
        logits = self.forward(params, data, backend=backend)
        return cross_entropy(logits, data.labels)
