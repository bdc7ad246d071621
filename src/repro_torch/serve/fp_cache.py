"""Cross-request projected-feature (FP) block cache (the counterpart of
``repro.serve.fp_cache``, with the same keys, versions, eviction and
stats).

The paper's FP-Buf (§4.3.1) keeps projected feature tables resident so
the next semantic graph reuses them instead of re-fetching them.  This is
a capacity-bounded cache of projected-feature **row blocks**, keyed by
``(vertex_type, block_index, version)``, shared across concurrent graph
requests.  A request's FP stage projects only the blocks the cache does
not hold; ``reused_bytes`` / ``fetched_bytes`` are the *measured*
counterparts of ``core/reuse.py``'s ``FPTraffic`` accounting.

Eviction policies:

* ``lru``        — least-recently-used block first.
* ``similarity`` — evict the block whose vertex type has the least demand
  from the pending request queue (refreshed by the engine each admission
  round via :meth:`set_demand`); ties fall back to LRU order.

Coherence: :meth:`invalidate` bumps a type's version and drops its blocks
— entries under the old version can never be served again (DESIGN.md §9).

FP is a plain ``x @ w + b`` (``stages.feature_projection``, a
``torch.matmul``), the same op on the cached and uncached paths, so both
give identical bits.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Mapping

import torch

from ..core import stages
from ..core.reuse import FPTraffic


@dataclasses.dataclass
class FPCacheStats:
    """Measured counterpart of ``core/reuse.py:FPTraffic``."""

    hits: int = 0
    misses: int = 0
    reused_bytes: int = 0
    fetched_bytes: int = 0
    evicted_bytes: int = 0
    rows_reused: int = 0
    rows_computed: int = 0
    invalidations: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.hits + self.misses, 1)

    @property
    def reuse_fraction(self) -> float:
        return self.reused_bytes / max(self.reused_bytes + self.fetched_bytes, 1)

    def traffic(self) -> FPTraffic:
        """The measured FP traffic in the analytical model's own type."""
        return FPTraffic(reused_bytes=self.reused_bytes, fetched_bytes=self.fetched_bytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class FPCache:
    """Capacity-bounded cache of projected-feature row blocks."""

    def __init__(self, capacity_bytes: int, *, block_rows: int = 128, policy: str = "lru"):
        if policy not in ("lru", "similarity"):
            raise ValueError(f"unknown eviction policy {policy!r}")
        if capacity_bytes < 0 or block_rows <= 0:
            raise ValueError("capacity_bytes must be >= 0 and block_rows > 0")
        self.capacity_bytes = int(capacity_bytes)
        self.block_rows = int(block_rows)
        self.policy = policy
        # key -> block, in LRU order (oldest first)
        self._blocks: OrderedDict[tuple[str, int, int], torch.Tensor] = OrderedDict()
        self._bytes = 0
        self._version: dict[str, int] = {}
        self._demand: dict[str, float] = {}
        self.stats = FPCacheStats()

    # -- introspection ------------------------------------------------------

    @property
    def resident_bytes(self) -> int:
        return self._bytes

    @property
    def num_blocks(self) -> int:
        return len(self._blocks)

    def resident_types(self) -> set[str]:
        return {k[0] for k in self._blocks}

    def version(self, vtype: str) -> int:
        return self._version.get(vtype, 0)

    def table_coverage(self, vtype: str, num_rows: int) -> float:
        """Fraction of ``vtype``'s projected table (``num_rows`` rows)
        resident at the current version.  Coverage 1.0 means the projected
        table is already paid for, so the serving engine's fused-FP path
        takes the projected path instead."""
        ver = self.version(vtype)
        br = self.block_rows
        n_blocks = (num_rows + br - 1) // br
        if n_blocks == 0:
            return 1.0
        resident = sum(
            min(br, num_rows - bi * br)
            for bi in range(n_blocks)
            if (vtype, bi, ver) in self._blocks
        )
        return resident / num_rows

    # -- coherence ----------------------------------------------------------

    def invalidate(self, vtype: str) -> None:
        """Raw features / projection weights of ``vtype`` changed: bump the
        version (old-version keys can never match) and drop its blocks."""
        self._version[vtype] = self.version(vtype) + 1
        for key in [k for k in self._blocks if k[0] == vtype]:
            self._drop(key)
        self.stats.invalidations += 1

    # -- admission / eviction ----------------------------------------------

    def set_demand(self, demand: Mapping[str, float]) -> None:
        """Per-type demand of the pending queue (for the similarity-weighted
        eviction policy).  Refreshed by the engine each admission round."""
        self._demand = dict(demand)

    def _drop(self, key) -> None:
        nbytes = _nbytes(self._blocks.pop(key))
        self._bytes -= nbytes
        self.stats.evicted_bytes += nbytes

    def _victim(self):
        if self.policy == "lru":
            return next(iter(self._blocks))
        # least queue demand first; min() scans in LRU order, so ties
        # resolve to the oldest block
        return min(self._blocks, key=lambda k: self._demand.get(k[0], 0.0))

    def _insert(self, key, blk: torch.Tensor) -> None:
        nbytes = _nbytes(blk)
        if nbytes > self.capacity_bytes:
            return  # a single block larger than the cache streams through
        while self._bytes + nbytes > self.capacity_bytes and self._blocks:
            self._drop(self._victim())
        self._blocks[key] = blk
        self._bytes += nbytes

    # -- the FP stage -------------------------------------------------------

    def project(
        self,
        vtype: str,
        x: torch.Tensor,   # [N, Din] raw features
        w: torch.Tensor,   # [Din, H*Dh]
        b: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Projected table ``x @ w + b`` for ``vtype``, block by block:
        resident blocks are served from cache, missing blocks computed and
        admitted."""
        ver = self.version(vtype)
        n = int(x.shape[0])
        br = self.block_rows
        out = []
        for bi in range((n + br - 1) // br):
            key = (vtype, bi, ver)
            blk = self._blocks.get(key)
            rows = min(br, n - bi * br)
            if blk is not None:
                self._blocks.move_to_end(key)
                self.stats.hits += 1
                self.stats.reused_bytes += _nbytes(blk)
                self.stats.rows_reused += rows
            else:
                blk = stages.feature_projection(x[bi * br : bi * br + rows], w, b)
                self.stats.misses += 1
                self.stats.fetched_bytes += _nbytes(blk)
                self.stats.rows_computed += rows
                self._insert(key, blk)
            out.append(blk)
        return out[0] if len(out) == 1 else torch.cat(out, dim=0)
