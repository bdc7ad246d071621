"""Synthetic HetG generators matching the paper's Table 5 statistics.

Offline reproduction: IMDB / ACM / DBLP are regenerated as random HetGs
with the *exact* vertex counts, feature dims, per-relation edge counts and
metapath sets of Table 5.  A ``scale`` < 1 shrinks everything uniformly for
tests.  Degree distributions are skewed (Zipf-ish dst selection) to retain
the irregularity that makes the NA stage memory-bound.
"""
from __future__ import annotations

import numpy as np

from .hetgraph import HetGraph, make_relation

# Table 5 of the paper: vertices, feature dims, relations (edge counts), metapaths.
TABLE5 = {
    "imdb": {
        "vertices": {"movie": 4932, "director": 2393, "actor": 6124, "keyword": 7971},
        "features": {"movie": 3489, "director": 3341, "actor": 3341, "keyword": 64},
        "relations": {
            "AM": ("actor", "movie", 14779),
            "MA": ("movie", "actor", 14779),
            "KM": ("keyword", "movie", 23610),
            "MK": ("movie", "keyword", 23610),
            "DM": ("director", "movie", 4932),
            "MD": ("movie", "director", 4932),
        },
        "metapaths": [
            ("movie", "director", "movie"),
            ("movie", "actor", "movie"),
            ("movie", "keyword", "movie"),
        ],
        "target": "movie",
        "num_classes": 3,
    },
    "acm": {
        "vertices": {"paper": 3025, "author": 5959, "subject": 56, "term": 1902},
        "features": {"paper": 1902, "author": 1902, "subject": 1902, "term": 64},
        "relations": {
            "TP": ("term", "paper", 255619),
            "PT": ("paper", "term", 255619),
            "SP": ("subject", "paper", 3025),
            "PS": ("paper", "subject", 3025),
            "PP": ("paper", "paper", 5343),
            "AP": ("author", "paper", 9949),
            "PA": ("paper", "author", 9949),
        },
        "metapaths": [
            ("paper", "paper", "subject", "paper"),
            ("paper", "subject", "paper"),
            ("paper", "paper", "author", "paper"),
            ("paper", "author", "paper"),
        ],
        "target": "paper",
        "num_classes": 3,
    },
    "dblp": {
        "vertices": {"author": 4057, "paper": 14328, "term": 7723, "venue": 20},
        "features": {"author": 334, "paper": 4231, "term": 50, "venue": 64},
        "relations": {
            "AP": ("author", "paper", 19645),
            "PA": ("paper", "author", 19645),
            "VP": ("venue", "paper", 14328),
            "PV": ("paper", "venue", 14328),
            "TP": ("term", "paper", 85810),
            "PT": ("paper", "term", 85810),
        },
        "metapaths": [
            ("author", "paper", "author"),
            ("author", "paper", "term", "paper", "author"),
            ("author", "paper", "venue", "paper", "author"),
        ],
        "target": "author",
        "num_classes": 4,
    },
}


def _rand_edges(rng, n_src, n_dst, n_edges):
    """Random bipartite edges with Zipf-skewed dst degrees, deduped."""
    n_edges = min(n_edges, n_src * n_dst)
    # oversample then dedupe to land near the requested count
    m = int(n_edges * 1.3) + 8
    src = rng.integers(0, n_src, size=m).astype(np.int32)
    # skewed destination choice: mix uniform with a small hot set
    hot = max(1, n_dst // 16)
    pick_hot = rng.random(m) < 0.35
    dst = np.where(
        pick_hot,
        rng.integers(0, hot, size=m),
        rng.integers(0, n_dst, size=m),
    ).astype(np.int32)
    key = src.astype(np.int64) * n_dst + dst
    _, idx = np.unique(key, return_index=True)
    idx = idx[: n_edges]
    return src[idx], dst[idx]


def synthetic_hetgraph(
    name: str,
    *,
    scale: float = 1.0,
    feat_scale: float = 1.0,
    seed: int = 0,
) -> HetGraph:
    """Generate the named Table-5 dataset (scaled); deterministic in seed."""
    spec = TABLE5[name]
    rng = np.random.default_rng(seed)

    def sv(n):  # scale vertex counts, keep >= 4
        return max(4, int(round(n * scale)))

    def sf(d):  # scale feature dims, keep >= 8
        return max(8, int(round(d * feat_scale)))

    counts = {t: sv(n) for t, n in spec["vertices"].items()}
    feats = {
        t: rng.standard_normal((counts[t], sf(d))).astype(np.float32) * 0.1
        for t, d in spec["features"].items()
    }
    relations = {}
    for rname, (st, dt, ne) in spec["relations"].items():
        ne_s = max(4, int(round(ne * scale * scale))) if scale < 1.0 else ne
        if rname.endswith("_rev") or (rname[::-1] in relations and rname != rname[::-1]):
            # mirror of an already-generated relation -> exact reverse
            fwd = relations[rname[::-1]]
            relations[rname] = fwd.reversed(rname)
            continue
        s, d = _rand_edges(rng, counts[st], counts[dt], ne_s)
        relations[rname] = make_relation(rname, st, dt, s, d)

    g = HetGraph(vertex_counts=counts, features=feats, relations=relations)
    g.validate()
    return g


def dataset_metapaths(name: str) -> list[tuple[str, ...]]:
    return list(TABLE5[name]["metapaths"])


def dataset_target(name: str) -> tuple[str, int]:
    spec = TABLE5[name]
    return spec["target"], spec["num_classes"]



def synthetic_labels(g: HetGraph, name: str, seed: int = 0) -> np.ndarray:
    """Labels with planted structure: class = argmax over random projection
    of features, so models can actually fit them (loss decreases)."""
    target, ncls = dataset_target(name)
    rng = np.random.default_rng(seed + 1)
    x = g.features[target]
    w = rng.standard_normal((x.shape[1], ncls)).astype(np.float32)
    logits = x @ w + 0.1 * rng.standard_normal((x.shape[0], ncls)).astype(np.float32)
    return logits.argmax(-1).astype(np.int32)
