"""Per-device operation statistics of one call: the port's counterpart of
``repro.launch.hlostats``.

The reference parses the optimized HLO of a compiled SPMD program.  The
port runs eagerly and has no HLO to parse, so it watches the call as it
runs (on real tensors, or on the fake tensors of a dry run) and keeps the
``HLOStats`` fields that hold a meaning in eager PyTorch:

* ``dot_flops``: the products' FLOPs, ``torch.utils.flop_counter.
  FlopCounterMode``'s count (2 · M · N · K a matmul, the batched and
  einsum forms included), with the matrix-vector and vector-vector
  products added (2 · M · K and 2 · K), which it leaves out and HLO
  counts as dots;
* ``collective_bytes`` and ``collective_count`` by kind (``all-reduce``,
  ``all-gather``, ``reduce-scatter``, ``all-to-all``, ``broadcast``, ...):
  the ``c10d`` collectives that ``torch.distributed.tensor.debug.
  CommDebugMode`` sees, each one's bytes its result's (the op's output
  tensors: the reduced tensor, the gathered whole, the scattered piece),
  as the reference counts a collective's result shape;
* ``total_collective_bytes``.

Both are per device: each rank runs its own program.  Left out: the
reference's loop-corrected and static variants and ``while_trips``.  They
correct for XLA visiting a compiled while body once; an eager call runs
every iteration of its loops and counts each, so the one count here is
the loop-corrected one, and there is no compiled loop whose trips could
be read (ROADMAP Queue 3, departures).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable

import torch
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils.flop_counter import FlopCounterMode

# c10d op name -> the reference's collective kind
_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast", "reduce_": "reduce", "gather_": "gather", "scatter_": "scatter",
}


def _mv_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0] * a_shape[1]


def _dot_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0]


_EXTRA_FLOPS = {torch.ops.aten.mv: _mv_flop, torch.ops.aten.dot: _dot_flop}


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


class CollectiveCounter(CommDebugMode):
    """``CommDebugMode`` that also adds up each collective's result bytes by
    kind (``bytes``, ``counts``): a c10d collective's first argument is its
    output tensors."""

    def __init__(self):
        super().__init__()
        self.bytes: dict[str, int] = defaultdict(int)
        self.counts: dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        packet = getattr(func, "_overloadpacket", None)
        if packet is not None and getattr(packet, "_qualified_op_name", "").startswith("c10d::"):
            kind = _KINDS.get(packet.__name__)
            if kind is not None:
                self.counts[kind] += 1
                self.bytes[kind] += _tensor_bytes(args[0] if args else ())
        return out


@dataclasses.dataclass
class OpStats:
    collective_bytes: dict[str, float]  # kind -> result bytes, per device
    collective_count: dict[str, int]
    dot_flops: float                    # per device

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def analyze(run: Callable[[], object]) -> OpStats:
    """The stats of one call of ``run()`` on this rank (a collective where
    ``run`` holds one)."""
    flops = FlopCounterMode(display=False, custom_mapping=_EXTRA_FLOPS)
    comms = CollectiveCounter()
    with flops, comms:
        run()
    return OpStats(collective_bytes={k: float(v) for k, v in comms.bytes.items()},
                   collective_count=dict(comms.counts), dot_flops=float(flops.get_total_flops()))


def span_attrs(stats: OpStats, **extra) -> dict:
    """Flatten an OpStats into span attributes (``obs/trace.py``): scalar
    totals plus per-kind collective bytes, so that a run's span in the
    exported timeline carries its communication and compute footprint."""
    attrs = dict(
        dot_flops=stats.dot_flops,
        collective_bytes=stats.total_collective_bytes,
        collective_launches=sum(stats.collective_count.values()),
    )
    for kind, b in sorted(stats.collective_bytes.items()):
        attrs[f"collective_bytes.{kind}"] = b
    attrs.update(extra)
    return attrs
