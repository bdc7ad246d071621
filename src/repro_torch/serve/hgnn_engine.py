"""HGNN serving engine: stepped graph-request execution over a resident
HetGraph with a cross-request FP cache and similarity-aware admission
(the counterpart of ``repro.serve.hgnn_engine``).

This is the paper's inter-semantic-graph data reusability (§4.3) at the
serving tier.  Concurrent requests — each a set of metapaths whose
endpoints are the resident target type — occupy a fixed-slot batch.  Each
engine step executes ONE semantic graph per occupied slot:

1. **FP** — the projected tables of every vertex type on the step's
   metapaths go through the shared :class:`FPCache`: blocks left behind by
   earlier requests (or co-batched slots) are reused, the rest computed.
2. **NA** — attention coefficients from the target-type table, then ONE
   multigraph kernel launch for all slots' semantic graphs
   (``fusion.neighbor_aggregate_multi``).  With ``FUSED_FP`` the FP of the
   target type happens inside the launch instead, unless the cache
   already holds the whole target table (then the projected path runs).
3. **ELU, LSF, GSF** — per-graph semantic importances accumulate on the
   slot; when a request's last metapath completes, global semantic fusion
   produces its embedding and the slot is freed for the queue.

Admission is similarity-aware by default: the queue is ordered by the
shortest Hamilton path over ``core/scheduling.py:similarity_matrix`` on
the *request* mix, anchored at the end that overlaps the cache's resident
types most.  ``admission="fifo"`` is the ablation baseline.

The engine runs on the card unless the caller asks for the CPU
(``device="cpu"``, where the kernels' plain versions run).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import Counter
from typing import Sequence

import torch
import torch.nn.functional as F

from ..core import stages
from ..core.fusion import (
    _FUSED_TO_MULTIGRAPH,
    FusedFPInputs,
    NABackend,
    SemanticGraphBatch,
    batch_semantic_graph,
    neighbor_aggregate_multi,
)
from ..core.reuse import FPTraffic, fp_buffer_traffic
from ..core.scheduling import shortest_hamilton_path, similarity_matrix
from ..graphs.hetgraph import HetGraph
from ..graphs.sgb import build_semantic_graph
from ..models.hgnn.common import glorot
from ..obs.metrics import MetricsRegistry
from ..obs.trace import trace_span
from ..runtime import resolve_device
from .fp_cache import FPCache


@dataclasses.dataclass
class GraphRequest:
    """A vertex-type-tagged subgraph query: run the given metapaths (all
    endpoints = the engine's target type) and return the fused embedding."""

    rid: int
    metapaths: list[tuple[str, ...]]
    submitted_step: int = -1
    admitted_step: int = -1
    finished_step: int = -1
    result: torch.Tensor | None = None   # [N_target, H*Dh] on finish
    beta: torch.Tensor | None = None     # [G] semantic attention on finish
    _progress: int = 0
    _z: list = dataclasses.field(default_factory=list, repr=False)
    _w: list = dataclasses.field(default_factory=list, repr=False)

    @property
    def path_types(self) -> tuple[str, ...]:
        """Stable-unique union of vertex types across the metapaths — the
        request's FP working set (what similarity admission scores)."""
        seen: dict[str, None] = {}
        for mp in self.metapaths:
            for t in mp:
                seen.setdefault(t)
        return tuple(seen)

    @property
    def done(self) -> bool:
        return self._progress >= len(self.metapaths)


def _stable_seed(name: str) -> int:
    return int.from_bytes(hashlib.blake2b(name.encode(), digest_size=4).digest(), "big")


class HGNNEngine:
    """Fixed-slot stepped HGNN inference over a resident HetGraph.

    ``params``/``metapath_params`` (e.g. from ``repro_torch.convert``)
    replace the engine's own initialisation, which draws from
    ``torch.Generator``s seeded by ``seed``."""

    def __init__(
        self,
        graph: HetGraph,
        *,
        target_type: str,
        hidden: int = 8,
        heads: int = 2,
        att_dim: int = 16,
        num_slots: int = 2,
        cache_bytes: int = 1 << 20,
        cache_block_rows: int = 128,
        cache_policy: str = "lru",
        admission: str = "similarity",
        backend: NABackend = NABackend.MULTIGRAPH,
        block: int = 16,
        max_edges: int | None = 20_000,
        seed: int = 0,
        registry: MetricsRegistry | None = None,
        device: str | torch.device = "cuda",
        params: dict | None = None,
        metapath_params: dict | None = None,
    ):
        if admission not in ("similarity", "fifo"):
            raise ValueError(f"unknown admission {admission!r}")
        if target_type not in graph.vertex_counts:
            raise ValueError(f"unknown target type {target_type!r}")
        self.device = resolve_device(device)
        self.graph = graph
        self.target_type = target_type
        self.hidden, self.heads, self.att_dim = hidden, heads, att_dim
        self.num_slots = num_slots
        self.admission = admission
        self.backend = backend
        self.block = block
        self.max_edges = max_edges
        self.seed = seed
        self.n_target = graph.num_vertices(target_type)

        self.features = {
            t: torch.as_tensor(x, device=self.device) for t, x in graph.features.items()
        }
        self.cache = FPCache(cache_bytes, block_rows=cache_block_rows, policy=cache_policy)
        self.params = params if params is not None else self._init_params(seed)
        self._mp_params: dict[tuple[str, ...], tuple[torch.Tensor, torch.Tensor]] = dict(
            metapath_params or {}
        )
        self._batches: dict[tuple[str, ...], SemanticGraphBatch] = {}

        self.queue: list[GraphRequest] = []
        self.slots: list[GraphRequest | None] = [None] * num_slots
        self.finished: list[GraphRequest] = []
        self.steps_run = 0
        self.na_launches = 0
        self.fp_rows_naive = 0  # rows a recompute-per-request FP stage would project
        self.fused_steps = 0           # steps served by the FP+NA megakernel
        self.fused_cache_bypasses = 0  # fused steps downgraded: table already cached

        # Observability (DESIGN.md §12): a private registry by default so two
        # engines in one process never mix series.  ``_executed`` records,
        # per step, the vertex types projected through the cache — the input
        # the analytical FP-traffic model replays in ``fp_model_drift``.
        self.registry = registry if registry is not None else MetricsRegistry()
        self._executed: list[tuple[str, ...]] = []
        for k in sorted(self._COUNTER_KEYS):  # series exist from step zero
            self.registry.counter(f"serve.{k}")

    # -- parameters ---------------------------------------------------------

    def _init_params(self, seed: int) -> dict:
        gen = torch.Generator().manual_seed(seed)
        out_dim = self.heads * self.hidden
        dev = self.device
        w_g = glorot(gen, (out_dim, self.att_dim))
        q = glorot(gen, (self.att_dim, 1))[:, 0]
        w_fp = {
            t: glorot(gen, (self.graph.feature_dim(t), out_dim)).to(dev)
            for t in sorted(self.graph.vertex_counts)
        }
        return {
            "w_fp": w_fp,
            "b_fp": {t: torch.zeros(out_dim, device=dev) for t in self.graph.vertex_counts},
            "w_g": w_g.to(dev),
            "b_g": torch.zeros(self.att_dim, device=dev),
            "q": q.to(dev),
        }

    def _metapath_params(self, mp: tuple[str, ...]) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-metapath GAT vectors, deterministic in the metapath name so
        identical metapaths share parameters across requests and engines."""
        if mp not in self._mp_params:
            gen = torch.Generator().manual_seed(
                ((self.seed + 1) << 32) | _stable_seed("/".join(mp))
            )
            self._mp_params[mp] = (
                glorot(gen, (self.heads, self.hidden)).to(self.device),
                glorot(gen, (self.heads, self.hidden)).to(self.device),
            )
        return self._mp_params[mp]

    def _batch(self, mp: tuple[str, ...]) -> SemanticGraphBatch:
        """Device-resident semantic graph for a metapath (host-built once,
        memoized — SGB is preprocessing, as in the paper)."""
        if mp not in self._batches:
            sg = build_semantic_graph(
                self.graph, mp, max_edges=self.max_edges, seed=_stable_seed("/".join(mp))
            )
            self._batches[mp] = batch_semantic_graph(sg, block=self.block, device=self.device)
        return self._batches[mp]

    # -- request lifecycle --------------------------------------------------

    def submit(self, req: GraphRequest) -> None:
        if not req.metapaths:
            raise ValueError("empty request")
        for mp in req.metapaths:
            if mp[0] != self.target_type or mp[-1] != self.target_type:
                raise ValueError(
                    f"metapath {mp} endpoints must be the resident target type "
                    f"{self.target_type!r} (shared dst space for the fused launch)"
                )
            for t in mp:
                if t not in self.graph.vertex_counts:
                    raise ValueError(f"metapath {mp}: unknown vertex type {t!r}")
        req.submitted_step = self.steps_run
        self.queue.append(req)

    def _admission_order(self) -> list[int]:
        n = len(self.queue)
        if self.admission == "fifo" or n <= 1:
            return list(range(n))
        w = similarity_matrix(self.queue, self.graph.vertex_counts)
        if n <= 12:
            order, _ = shortest_hamilton_path(w)
        else:
            # greedy nearest-neighbor chain (Held-Karp is 2^n)
            order = [0]
            rest = set(range(1, n))
            while rest:
                last = order[-1]
                order.append(min(rest, key=lambda j: w[last, j]))
                rest.remove(order[-1])
        # anchor the chain at the end overlapping the resident cache most
        resident = self.cache.resident_types()

        def overlap(i: int) -> int:
            return sum(
                self.graph.vertex_counts[t]
                for t in set(self.queue[i].path_types) & resident
            )

        if overlap(order[-1]) > overlap(order[0]):
            order.reverse()
        return order

    def _admit(self) -> None:
        if self.queue:
            order = self._admission_order()
            self.queue = [self.queue[i] for i in order]
            for s in range(self.num_slots):
                if self.slots[s] is None and self.queue:
                    req = self.queue.pop(0)
                    req.admitted_step = self.steps_run
                    self.slots[s] = req
        # refresh eviction demand: FP types still wanted by waiting +
        # in-flight work (similarity-weighted policy only reads this)
        demand: Counter[str] = Counter()
        for req in self.queue:
            demand.update(req.path_types)
        for req in self.slots:
            if req is not None:
                for mp in req.metapaths[req._progress :]:
                    demand.update(set(mp))
        self.cache.set_demand(demand)

    # -- execution ----------------------------------------------------------

    def _fp_tables(
        self, active: list[tuple[int, GraphRequest]], skip: set[str] = frozenset()
    ) -> dict[str, torch.Tensor]:
        """Projected tables for the step's metapath types via the cache.
        ``skip`` types still count toward the naive-FP baseline but are
        neither projected nor admitted — the fused path projects the
        target type inside the NA launch instead."""
        tables: dict[str, torch.Tensor] = {}
        with trace_span("serve/fp", stage="FP", step=self.steps_run) as sp:
            for _, req in active:
                mp = req.metapaths[req._progress]
                for t in dict.fromkeys(mp):
                    self.fp_rows_naive += self.graph.num_vertices(t)
                    if t not in tables and t not in skip:
                        tables[t] = sp.sync(
                            self.cache.project(
                                t,
                                self.features[t],
                                self.params["w_fp"][t],
                                self.params["b_fp"][t],
                            )
                        )
            sp.annotate(types=list(tables))
        self._executed.append(tuple(tables))
        return tables

    def step(self) -> int:
        """One engine step: admit, then execute one semantic graph per
        occupied slot (single NA launch).  Returns #active slots.  On the
        card the step ends when its results are on the device, so
        ``serve.step_ms`` is the step's latency, not its enqueue time."""
        self._admit()
        active = [(s, r) for s, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        t0 = time.perf_counter()
        with trace_span("serve/step", step=self.steps_run, slots=len(active)):
            self._step_body(active)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.registry.histogram("serve.step_ms").observe(
            (time.perf_counter() - t0) * 1e3
        )
        self._sync_registry()
        return len(active)

    def _step_body(self, active: list[tuple[int, GraphRequest]]) -> None:
        # Bound-aware dispatch for the fused-FP backend: if the cache
        # already holds the target type's whole projected table, FP is a
        # sunk cost — take the projected (multigraph) path and serve the
        # hit.  On a miss, the megakernel projects raw features on chip
        # and h' never goes to device memory (nothing is admitted).
        backend = self.backend
        fused = backend is NABackend.FUSED_FP
        if fused and self.cache.table_coverage(self.target_type, self.n_target) >= 1.0:
            backend = _FUSED_TO_MULTIGRAPH[backend]
            fused = False
            self.fused_cache_bypasses += 1
            self.registry.counter("serve.fused_cache_bypasses").inc()

        graph_names = ["/".join(r.metapaths[r._progress]) for _, r in active]
        if fused:
            self._fp_tables(active, skip={self.target_type})
            batches, a_s, a_d = [], [], []
            for _, req in active:
                mp = req.metapaths[req._progress]
                a_src, a_dst = self._metapath_params(mp)
                batches.append(self._batch(mp))
                a_s.append(a_src)
                a_d.append(a_dst)
            fp = FusedFPInputs.shared(
                self.features[self.target_type],
                self.params["w_fp"][self.target_type],
                self.params["b_fp"][self.target_type],
                torch.stack(a_s),
                torch.stack(a_d),
            )
            with trace_span(
                "serve/na", stage="NA", backend=backend.value,
                graphs=len(active), graph_names=graph_names, fused_fp=True,
            ) as sp:
                z_all = sp.sync(
                    neighbor_aggregate_multi(
                        batches, None, None, None, backend=backend, fp=fp
                    )
                )  # [G_active, N, H, Dh]
            self.fused_steps += 1
            self.registry.counter("serve.fused_steps").inc()
        else:
            tables = self._fp_tables(active)
            hh = tables[self.target_type].reshape(self.n_target, self.heads, self.hidden)

            batches, th_s, th_d = [], [], []
            with trace_span("serve/theta", stage="theta", graphs=len(active)) as sp:
                for _, req in active:
                    mp = req.metapaths[req._progress]
                    a_src, a_dst = self._metapath_params(mp)
                    ts, td = stages.attention_coefficients(hh, a_src, a_dst)
                    batches.append(self._batch(mp))
                    th_s.append(sp.sync(ts))
                    th_d.append(sp.sync(td))
            with trace_span(
                "serve/na", stage="NA", backend=backend.value,
                graphs=len(active), graph_names=graph_names,
            ) as sp:
                z_all = sp.sync(
                    neighbor_aggregate_multi(
                        batches, torch.stack(th_s), torch.stack(th_d), hh, backend=backend
                    )
                )  # [G_active, N, H, Dh]
        self.na_launches += 1
        self.registry.counter("serve.na_launches").inc()

        valid = torch.ones((self.n_target,), dtype=torch.bool, device=self.device)
        for i, (s, req) in enumerate(active):
            with trace_span(
                f"serve/fa/slot{s}", stage="FA", lane=f"slot{s}",
                rid=req.rid, graph=graph_names[i],
            ) as sp:
                z = F.elu(z_all[i].reshape(self.n_target, -1))
                w_p = sp.sync(
                    stages.local_semantic_fusion(
                        z, self.params["w_g"], self.params["b_g"], self.params["q"], valid
                    )
                )
                req._z.append(z)
                req._w.append(w_p)
                req._progress += 1
                if req.done:
                    fused_z, beta = stages.global_semantic_fusion(
                        torch.stack(req._w), torch.stack(req._z)
                    )
                    req.result, req.beta = sp.sync(fused_z), beta
                    req._z, req._w = [], []
                    req.finished_step = self.steps_run
                    self.finished.append(req)
                    self.slots[s] = None
                    self.registry.counter("serve.requests_finished").inc()
        self.steps_run += 1
        self.registry.counter("serve.steps").inc()

    def run(self, max_steps: int = 10_000) -> list[GraphRequest]:
        steps = 0
        while (self.queue or any(r is not None for r in self.slots)) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    # -- coherence ----------------------------------------------------------

    def update_features(self, vtype: str, x) -> None:
        """Install new raw features for ``vtype``.  Coherence rule
        (DESIGN.md §9): the cache version for the type is bumped and its
        blocks dropped, so no request ever reads a stale projection."""
        x = torch.as_tensor(x, device=self.device)
        if tuple(x.shape) != (self.graph.num_vertices(vtype), self.graph.feature_dim(vtype)):
            raise ValueError(f"{vtype}: features of shape {tuple(x.shape)} do not fit the graph")
        self.features[vtype] = x
        self.cache.invalidate(vtype)

    # -- metrics ------------------------------------------------------------

    def traffic(self) -> FPTraffic:
        """Measured FP traffic in ``core/reuse.py``'s own accounting type."""
        return self.cache.stats.traffic()

    def fp_model_drift(self) -> dict:
        """Predicted-vs-measured FP traffic: replay the executed per-step
        type sets through ``core/reuse.py:fp_buffer_traffic`` (LRU buffer
        = this cache's capacity) and compare fetched bytes against what the
        block-granular cache actually fetched (``drift`` = measured/model)."""
        out_bytes = self.heads * self.hidden * 4  # f32 projected row

        class _Step:
            def __init__(self, pt):
                self.path_types = pt

        sgs = [_Step(pt) for pt in self._executed]
        model = fp_buffer_traffic(
            list(range(len(sgs))),
            sgs,
            self.graph.vertex_counts,
            bytes_per_vertex={t: out_bytes for t in self.graph.vertex_counts},
            fpbuf_bytes=self.cache.capacity_bytes,
        )
        measured = self.traffic()
        return dict(
            fp_model_fetched_bytes=model.fetched_bytes,
            fp_model_reused_bytes=model.reused_bytes,
            fp_measured_fetched_bytes=measured.fetched_bytes,
            fp_model_drift=measured.fetched_bytes / max(model.fetched_bytes, 1),
        )

    # counters maintained monotonically at event sites in step(); every
    # other metrics() key is mirrored into the registry as a gauge.
    _COUNTER_KEYS = frozenset(
        ("steps", "na_launches", "requests_finished", "fused_steps",
         "fused_cache_bypasses")
    )

    def _sync_registry(self) -> None:
        for k, v in self.metrics().items():
            if k not in self._COUNTER_KEYS:
                self.registry.gauge(f"serve.{k}").set(float(v))

    def metrics(self) -> dict:
        st = self.cache.stats
        return dict(
            steps=self.steps_run,
            na_launches=self.na_launches,
            requests_finished=len(self.finished),
            requests_waiting=len(self.queue),
            cache_hits=st.hits,
            cache_misses=st.misses,
            cache_hit_rate=st.hit_rate,
            reused_bytes=st.reused_bytes,
            fetched_bytes=st.fetched_bytes,
            reuse_fraction=st.reuse_fraction,
            evicted_bytes=st.evicted_bytes,
            fp_rows_computed=st.rows_computed,
            fp_rows_reused=st.rows_reused,
            fp_rows_naive=self.fp_rows_naive,
            fp_compute_reduction=self.fp_rows_naive / max(st.rows_computed, 1),
            fused_steps=self.fused_steps,
            fused_cache_bypasses=self.fused_cache_bypasses,
            cache_resident_bytes=self.cache.resident_bytes,
            cache_capacity_bytes=self.cache.capacity_bytes,
            **self.fp_model_drift(),
        )


def make_request_mix(
    rid_start: int,
    clusters: Sequence[Sequence[tuple[str, ...]]],
    repeats: int,
    *,
    interleave: bool = True,
) -> list[GraphRequest]:
    """``repeats`` requests per metapath cluster, interleaved round-robin
    (the adversarial arrival order for FIFO admission) or grouped."""
    reqs: list[GraphRequest] = []
    rid = rid_start
    if interleave:
        for _ in range(repeats):
            for cl in clusters:
                reqs.append(GraphRequest(rid=rid, metapaths=[tuple(m) for m in cl]))
                rid += 1
    else:
        for cl in clusters:
            for _ in range(repeats):
                reqs.append(GraphRequest(rid=rid, metapaths=[tuple(m) for m in cl]))
                rid += 1
    return reqs
