"""The input generators: deterministic in the seed, the published counts,
and the DBLP copy equal to the port's own generator."""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from hgnnbench import harness
from hgnnbench.data import dblp, ogbn_mag

TINY_MAG = {"vertices": {"paper": 300, "author": 500, "institution": 16, "field_of_study": 40},
            "feature_width": 128,
            "relations": {"writes": ["author", "paper", 1500], "cites": ["paper", "paper", 900],
                          "has_topic": ["paper", "field_of_study", 1200],
                          "affiliated_with": ["author", "institution", 400]},
            "reverse": ["writes", "has_topic", "affiliated_with"],
            "target": "paper", "num_classes": 349}
SEED = 2**31 + 12345


def _dblp_cfg(scale=0.05):
    cfg = copy.deepcopy(harness.config("han-dblp"))
    cfg["scale"] = cfg["feat_scale"] = scale
    return cfg


def _mag_cfg():
    cfg = copy.deepcopy(harness.config("rgat-mag"))
    cfg["graph"] = TINY_MAG
    return cfg


def _same(a: dict, b: dict) -> bool:
    def eq(x, y):
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        return x.shape == y.shape and np.array_equal(x, y)
    return (a["vertex_counts"] == b["vertex_counts"]
            and all(eq(a["features"][t], b["features"][t]) for t in a["features"])
            and all(eq(p, q) for r in a["relations"]
                    for p, q in zip(a["relations"][r][2:], b["relations"][r][2:]))
            and eq(a["labels"], b["labels"]))


@pytest.mark.parametrize("make", [lambda s: dblp.make(_dblp_cfg(), s),
                                  lambda s: ogbn_mag.make(_mag_cfg(), s, "cpu")],
                         ids=["dblp", "ogbn_mag"])
def test_generators_are_deterministic_in_the_seed(make):
    a, b, c = make(SEED), make(SEED), make(SEED + 1)
    assert _same(a, b)
    assert not _same(a, c)


def test_dblp_copy_equals_the_ports_generator():
    from repro_torch.graphs import synthetic_hetgraph, synthetic_labels
    ours = dblp.make(_dblp_cfg(), 7)
    g = synthetic_hetgraph("dblp", scale=0.05, feat_scale=0.05, seed=7)
    assert ours["vertex_counts"] == dict(g.vertex_counts)
    for t, x in g.features.items():
        assert np.array_equal(ours["features"][t], x)
    for name, rel in g.relations.items():
        st, dt, s, d = ours["relations"][name]
        assert (st, dt) == (rel.src_type, rel.dst_type)
        assert np.array_equal(s, rel.src_ids) and np.array_equal(d, rel.dst_ids)
    assert np.array_equal(ours["labels"], synthetic_labels(g, "dblp", seed=7))


def test_dblp_at_full_scale_keeps_table5_counts():
    cfg = harness.config("han-dblp")
    assert cfg["scale"] == 1.0 and cfg["feat_scale"] == 1.0 and cfg["max_edges"] is None
    spec = cfg["graph"]
    assert spec["vertices"] == {"author": 4057, "paper": 14328, "term": 7723, "venue": 20}
    assert spec["features"]["author"] == 334


def test_ogbn_mag_counts_distinct_edges_and_skew():
    cfg = _mag_cfg()
    d = ogbn_mag.make(cfg, SEED, "cpu")
    counts = d["vertex_counts"]
    for name, (st, dt, n) in cfg["graph"]["relations"].items():
        s_type, d_type, s, t = d["relations"][name]
        assert (s_type, d_type) == (st, dt) and len(s) == len(t) == n
        assert s.dtype == np.int32 and 0 <= s.min() and s.max() < counts[st]
        assert 0 <= t.min() and t.max() < counts[dt]
        assert len(np.unique(s.astype(np.int64) * counts[dt] + t)) == n
        hot = counts[dt] // ogbn_mag.HOT_FRACTION
        if hot >= 8:  # the hot 1/16 of the dst ids holds far more than 1/16 of the edges
            assert (t < hot).mean() > 2.0 / ogbn_mag.HOT_FRACTION
    assert all(x.shape == (counts[t], 128) for t, x in d["features"].items())
    assert d["labels"].shape == (counts["paper"],) and int(d["labels"].max()) < 349
