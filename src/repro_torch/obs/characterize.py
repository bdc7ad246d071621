"""Live per-stage HGNN characterization (paper §3, Fig. 2 — measured), the
counterpart of ``repro.obs.characterize``.

HiHGNN's bound-aware fusion and lane scheduling were derived from a GPU
characterization of per-stage execution: FP and theta dense/compute-
bound, NA sparse/memory-bound, semantic fusion (FA) small but barrier-
prone.  ``core/stages.py`` carries that as an *analytical* model; this
module measures it on the live program: each stage runs on its own and
ends in a device synchronise, one trace lane per semantic graph so the
per-graph NA cost spread (the lane-balance problem) is visible in the
exported timeline.

On a CUDA tensor every stage ends in ``torch.cuda.synchronize()`` whether
tracing is on or off, so a direct call times the stages' device work,
not their launches.  The pass runs under ``torch.no_grad()``: it is a
measurement, not a training path (and KERNEL has no gradient).

The harness expects HAN-layout parameters (shared ``w_fp``/``b_fp``,
stacked per-graph ``a_src``/``a_dst``) and runs one forward worth of
work through ``core.stages`` and ``core.fusion.neighbor_aggregate``:
``backend=KERNEL`` launches kernel #5 once a graph, ``MULTIGRAPH`` kernel
#1 at G = 1.  Launchers invoke it once under ``--trace`` before the
steady state.
"""
from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from ..core import stages
from ..core.fusion import NABackend, neighbor_aggregate
from ..runtime import barrier
from .metrics import MetricsRegistry, get_registry
from .trace import trace_span

__all__ = ["characterize_hgnn"]

# span taxonomy (DESIGN.md §12): stage attr -> paper stage
STAGES = ("FP", "theta", "NA", "FA")


def _timed(name: str, stage: str, lane: str | None, fn, **attrs):
    """Run fn() under a span that closes after the device is done; return
    (value, wall µs)."""
    with trace_span(name, stage=stage, lane=lane, **attrs):
        t0 = time.perf_counter_ns()
        out = barrier(fn())
        dt_us = (time.perf_counter_ns() - t0) / 1e3
    return out, dt_us


def characterize_hgnn(
    params,
    data,
    *,
    backend: NABackend = NABackend.BLOCK,
    leaky_slope: float = 0.2,
    registry: MetricsRegistry | None = None,
) -> dict:
    """Measure one forward stage by stage.

    Returns ``{"stage_us": {FP, theta, NA, FA}, "na_us_per_graph":
    {name: µs}, "total_us": float}`` and records each stage into the
    ``char.stage_us`` histogram (labeled by stage) of ``registry``
    (default: the process-wide one).  Under an enabled tracer this emits
    one ``char/na/<graph>`` span per semantic graph on its own
    ``sg/<graph>`` lane, plus FP/theta/FA spans.
    """
    reg = registry or get_registry()
    x = data.features[data.target_type]
    heads = params["a_src"].shape[1]
    n = x.shape[0]
    stage_us = dict.fromkeys(STAGES, 0.0)
    na_per_graph: dict[str, float] = {}

    barrier(x)  # work queued before the pass is not FP's
    with torch.no_grad(), trace_span("char/forward", lane="host", graphs=len(data.graphs),
                                     backend=backend.value):
        h, dt = _timed(
            "char/fp", "FP", "host",
            lambda: stages.feature_projection(x, params["w_fp"], params["b_fp"]),
            rows=n, d_out=int(params["w_fp"].shape[1]),
        )
        stage_us["FP"] += dt
        hh = h.reshape(n, heads, -1)

        z_list, w_list = [], []
        valid = torch.ones((n,), dtype=torch.bool, device=x.device)
        for i, batch in enumerate(data.graphs):
            lane = f"sg/{batch.name}"
            (th_s, th_d), dt = _timed(
                f"char/theta/{batch.name}", "theta", lane,
                lambda i=i: stages.attention_coefficients(
                    hh, params["a_src"][i], params["a_dst"][i]
                ),
                graph=batch.name,
            )
            stage_us["theta"] += dt

            z, dt = _timed(
                f"char/na/{batch.name}", "NA", lane,
                lambda b=batch, s=th_s, d=th_d: neighbor_aggregate(
                    b, s, d, hh, backend=backend, leaky_slope=leaky_slope
                ),
                graph=batch.name, edges=batch.num_edges, backend=backend.value,
            )
            stage_us["NA"] += dt
            na_per_graph[batch.name] = dt
            z = F.elu(z.reshape(n, -1))

            w_p, dt = _timed(
                f"char/lsf/{batch.name}", "FA", lane,
                lambda z=z: stages.local_semantic_fusion(
                    z, params["w_g"], params["b_g"], params["q"], valid
                ),
                graph=batch.name,
            )
            stage_us["FA"] += dt
            z_list.append(z)
            w_list.append(w_p)

        _, dt = _timed(
            "char/gsf", "FA", "host",
            lambda: stages.global_semantic_fusion(torch.stack(w_list), torch.stack(z_list)),
        )
        stage_us["FA"] += dt

    for stg, us in stage_us.items():
        reg.histogram("char.stage_us", stage=stg).observe(us)
    return dict(
        stage_us=stage_us,
        na_us_per_graph=na_per_graph,
        total_us=sum(stage_us.values()),
    )
