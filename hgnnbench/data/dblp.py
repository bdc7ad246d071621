"""Table-5 DBLP inputs: a frozen copy of the port's generator
(``repro_torch/graphs/datasets.py``: ``_rand_edges``, ``synthetic_hetgraph``
and ``synthetic_labels``), taking the dataset's counts from the
configuration file instead of a built-in table.

It makes the same arrays as the copied functions for the same seed, scale
and counts, so a cell measures the graph the port's own launcher trains
on.  It imports nothing of the port: the reference and the program get
the same plain arrays from here.

Returns a dict: ``vertex_counts``, ``features`` (type -> float32 numpy
``[N_t, D_t]``), ``relations`` (name -> (src_type, dst_type, src int32,
dst int32)), ``labels`` (int32 numpy ``[N_target]``).
"""
from __future__ import annotations

import numpy as np


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


def make(cfg: dict, seed: int, device=None) -> dict:
    """The configuration's heterogeneous graph and planted labels,
    deterministic in ``seed`` (``synthetic_hetgraph`` then
    ``synthetic_labels`` of the copied module), as host arrays whatever
    the ``device``: the port's own set-up moves them."""
    spec = cfg["graph"]
    scale, feat_scale = float(cfg["scale"]), float(cfg["feat_scale"])
    seed = int(seed) % (1 << 64)  # numpy takes no negative seed
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
    relations: dict[str, tuple] = {}
    for rname, (st, dt, ne) in spec["relations"].items():
        ne_s = max(4, int(round(ne * scale * scale))) if scale < 1.0 else ne
        if rname.endswith("_rev") or (rname[::-1] in relations and rname != rname[::-1]):
            # mirror of an already-generated relation -> exact reverse
            fst, fdt, fs, fd = relations[rname[::-1]]
            relations[rname] = (fdt, fst, fd, fs)
            continue
        s, d = _rand_edges(rng, counts[st], counts[dt], ne_s)
        relations[rname] = (st, dt, np.asarray(s, np.int32), np.asarray(d, np.int32))

    # synthetic_labels: class = argmax over a random projection of the features
    target, ncls = spec["target"], int(spec["num_classes"])
    lrng = np.random.default_rng(seed + 1)
    x = feats[target]
    w = lrng.standard_normal((x.shape[1], ncls)).astype(np.float32)
    logits = x @ w + 0.1 * lrng.standard_normal((x.shape[0], ncls)).astype(np.float32)
    labels = logits.argmax(-1).astype(np.int32)
    return {"vertex_counts": counts, "features": feats, "relations": relations,
            "labels": labels}
