"""ogbn-mag-shaped inputs (OGB, arXiv:2005.00687): the published vertex
and edge counts of the configuration, 128-wide features for every vertex
type, and planted labels on the target type.

Each relation's edges are distinct (src, dst) pairs: src uniform, dst
skewed as in the port's Table-5 generator (a hot 1/16 of the dst ids takes
35% of the draws).  Everything is drawn on ``device`` from one
``torch.Generator`` seeded with ``seed``, in a fixed order, so a seed gives
the same arrays on the same device.  Edges go to the host as int32 numpy
arrays (the port's graph layer is host-side); features and labels stay on
the device.

Returns the dict of ``data/dblp.py``: ``vertex_counts``, ``features``,
``relations`` (name -> (src_type, dst_type, src, dst)), ``labels``.
"""
from __future__ import annotations

import torch

HOT_FRACTION = 16  # the hot dst set is the first n_dst // 16 ids
HOT_SHARE = 0.35   # share of the draws that land in the hot set
OVERSAMPLE = 1.15  # draws per edge before duplicates are dropped


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def _edges(gen, n_src: int, n_dst: int, n_edges: int, device):
    m = int(n_edges * OVERSAMPLE) + 1024
    src = torch.randint(0, n_src, (m,), generator=gen, device=device)
    hot = max(1, n_dst // HOT_FRACTION)
    pick_hot = torch.rand(m, generator=gen, device=device) < HOT_SHARE
    dst = torch.where(pick_hot, torch.randint(0, hot, (m,), generator=gen, device=device),
                      torch.randint(0, n_dst, (m,), generator=gen, device=device))
    keys = torch.unique(src * n_dst + dst)  # sorted, distinct
    if keys.numel() < n_edges:
        raise ValueError(f"{n_edges} distinct edges asked of {keys.numel()} drawn")
    pick = torch.randperm(keys.numel(), generator=gen, device=device)[:n_edges]
    keys = torch.sort(keys[pick]).values
    return ((keys // n_dst).to(torch.int32).cpu().numpy(),
            (keys % n_dst).to(torch.int32).cpu().numpy())


def make(cfg: dict, seed: int, device="cuda") -> dict:
    spec = cfg["graph"]
    gen = generator(seed, device)
    counts = {t: int(n) for t, n in spec["vertices"].items()}
    relations = {}
    for name, (st, dt, ne) in spec["relations"].items():
        s, d = _edges(gen, counts[st], counts[dt], int(ne), device)
        relations[name] = (st, dt, s, d)
    width = int(spec["feature_width"])
    feats = {t: torch.randn((n, width), generator=gen, device=device) * 0.1
             for t, n in counts.items()}
    target, ncls = spec["target"], int(spec["num_classes"])
    x = feats[target]
    w = torch.randn((width, ncls), generator=gen, device=device)
    noise = torch.randn((x.shape[0], ncls), generator=gen, device=device)
    labels = (x @ w + 0.1 * noise).argmax(-1).to(torch.int32)
    return {"vertex_counts": counts, "features": feats, "relations": relations,
            "labels": labels}

