"""Semantic Graph Build (SGB) — stage 1 of the HGNN pipeline.

Builds semantic graphs from metapaths by composing relation edge lists.
The paper runs SGB on the host CPU in preprocessing (Section 3.1); we do
the same: numpy join-based sparse composition, deduplicated, with an
optional cap to bound blow-up on hub-heavy compositions (e.g. DBLP's PVP
generating ~20M edges from 14k papers through 20 venues).
"""
from __future__ import annotations

import numpy as np

from .hetgraph import HetGraph, Relation, SemanticGraph


def _compose(
    src_a: np.ndarray,
    mid_a: np.ndarray,
    mid_b: np.ndarray,
    dst_b: np.ndarray,
    *,
    max_edges: int | None = None,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Compose edge lists (src->mid) ∘ (mid->dst) -> unique (src,dst) pairs.

    Join on the shared mid vertex: group both lists by mid id, emit the
    per-mid cross product.  Equivalent to boolean A@B on the adjacency
    matrices (property-tested against that oracle in tests/).
    """
    if src_a.size == 0 or mid_b.size == 0:
        return np.empty(0, np.int32), np.empty(0, np.int32)

    order_a = np.argsort(mid_a, kind="stable")
    order_b = np.argsort(mid_b, kind="stable")
    mid_a_s, src_a_s = mid_a[order_a], src_a[order_a]
    mid_b_s, dst_b_s = mid_b[order_b], dst_b[order_b]

    n_mid = int(max(mid_a_s[-1], mid_b_s[-1])) + 1
    cnt_a = np.bincount(mid_a_s, minlength=n_mid).astype(np.int64)
    cnt_b = np.bincount(mid_b_s, minlength=n_mid).astype(np.int64)
    start_a = np.concatenate([[0], np.cumsum(cnt_a)])
    start_b = np.concatenate([[0], np.cumsum(cnt_b)])

    pair_counts = cnt_a * cnt_b
    total = int(pair_counts.sum())
    if total == 0:
        return np.empty(0, np.int32), np.empty(0, np.int32)

    src_out = np.empty(total, np.int32)
    dst_out = np.empty(total, np.int32)
    pos = 0
    for m in np.nonzero(pair_counts)[0]:
        ca, cb = int(cnt_a[m]), int(cnt_b[m])
        block = ca * cb
        s = src_a_s[start_a[m] : start_a[m] + ca]
        d = dst_b_s[start_b[m] : start_b[m] + cb]
        src_out[pos : pos + block] = np.repeat(s, cb)
        dst_out[pos : pos + block] = np.tile(d, ca)
        pos += block

    # Dedupe (boolean semantics): unique (src, dst) pairs.
    key = src_out.astype(np.int64) * np.int64(2**31) + dst_out.astype(np.int64)
    _, idx = np.unique(key, return_index=True)
    src_out, dst_out = src_out[idx], dst_out[idx]

    if max_edges is not None and src_out.size > max_edges:
        rng = rng or np.random.default_rng(0)
        pick = rng.choice(src_out.size, size=max_edges, replace=False)
        pick.sort()
        src_out, dst_out = src_out[pick], dst_out[pick]
    return src_out, dst_out


def _find_relation(g: HetGraph, src_type: str, dst_type: str) -> Relation:
    for rel in g.relations.values():
        if rel.src_type == src_type and rel.dst_type == dst_type:
            return rel
    for rel in g.relations.values():  # fall back to a reversed relation
        if rel.src_type == dst_type and rel.dst_type == src_type:
            return rel.reversed()
    raise KeyError(f"no relation {src_type}->{dst_type}")


def build_semantic_graph(
    g: HetGraph,
    metapath: tuple[str, ...],
    *,
    max_edges: int | None = None,
    seed: int = 0,
) -> SemanticGraph:
    """Build one semantic graph from a metapath of vertex types, e.g.
    ('author','paper','author') — the APA co-author semantic graph."""
    assert len(metapath) >= 2
    rng = np.random.default_rng(seed)
    rel = _find_relation(g, metapath[0], metapath[1])
    src, dst = rel.src_ids, rel.dst_ids
    for hop in range(1, len(metapath) - 1):
        nxt = _find_relation(g, metapath[hop], metapath[hop + 1])
        src, dst = _compose(src, dst, nxt.src_ids, nxt.dst_ids, max_edges=max_edges, rng=rng)
    name = "".join(t[0].upper() for t in metapath)
    return SemanticGraph(
        name=name,
        src_type=metapath[0],
        dst_type=metapath[-1],
        src_ids=src,
        dst_ids=dst,
        num_src=g.num_vertices(metapath[0]),
        num_dst=g.num_vertices(metapath[-1]),
        path_types=tuple(metapath),
    )



def build_semantic_graphs(
    g: HetGraph,
    metapaths: list[tuple[str, ...]],
    *,
    max_edges: int | None = None,
) -> list[SemanticGraph]:
    return [build_semantic_graph(g, mp, max_edges=max_edges, seed=i) for i, mp in enumerate(metapaths)]
