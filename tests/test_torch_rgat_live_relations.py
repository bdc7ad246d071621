"""R-GAT runs only the relation passes whose output reaches the logits
(``models.hgnn.common.live_relations``), on a small graph with
``rgat-mag``'s schema: papers, authors, institutions and fields, its four
relations and the three reverses the benchmark adds.

* the schedule keeps six relations in the first layer and the three into
  ``paper`` in the last, as the benchmark's work count
  (``hgnnbench.reference.rgat.work``) has them live on ``rgat-mag``;
* on SEGMENT and BLOCK the logits, the loss and every leaf's gradient match
  ``jax.grad`` of the JAX package (which computes every pass) at the R-GAT
  tolerances, and the dead passes' leaves get exact zeros;
* ``rgat_forward.relations_skipped`` counts 5 a forward there, 0 where
  every relation enters the target;
* a type the next layer reads that no relation enters takes its ``self``
  product."""
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgnnbench.reference import rgat as bench_rgat
from hgnnbench.roofline import na_backward
from repro.core import NABackend as JNA
from repro.graphs import HetGraph as JHetGraph
from repro.graphs import make_relation as jmake_relation
from repro.graphs import relation_semantic_graphs as jrelation_graphs
from repro.models.hgnn import MODELS as JMODELS
from repro.models.hgnn import cross_entropy as jcross_entropy
from repro.models.hgnn import prepare_data as jprepare_data
from repro_torch.convert import params_from_numpy
from repro_torch.core import NABackend
from repro_torch.graphs import HetGraph, make_relation, relation_semantic_graphs
from repro_torch.models.hgnn import live_relations, prepare_data, rgat_forward
from repro_torch.train import hgnn_loss_and_grads
from repro_torch.tree import tree_leaves_with_path

TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_rgat_train.py's R-GAT tolerances
WIDTH = dict(hidden=8, heads=2, layers=2)
MAG = json.loads((Path(__file__).parents[1] / "hgnnbench/configs/rgat-mag.json").read_text())
COUNTS = {"paper": 40, "author": 50, "institution": 6, "field_of_study": 12}
DIMS = {"paper": 8, "author": 6, "institution": 5, "field_of_study": 7}
BACKENDS = {NABackend.SEGMENT: JNA.SEGMENT, NABackend.BLOCK: JNA.BLOCK}


def _schema(reverse=None):
    """``rgat-mag``'s relations (``(src, dst)`` by name, the reverses after
    the forward ones, as the benchmark adds them)."""
    spec = MAG["graph"]
    rels = {n: tuple(v[:2]) for n, v in spec["relations"].items()}
    for n in spec["reverse"] if reverse is None else reverse:
        rels[f"{n}_rev"] = rels[n][::-1]
    return rels


@functools.lru_cache(maxsize=None)
def _problem(rels: tuple, target: str = "paper"):
    """The graph of ``rels`` (``((name, src, dst), ...)``) in both
    packages, with every type of ``COUNTS``: (jax data, port data)."""
    rng = np.random.default_rng(len(rels))
    edges = {n: (rng.integers(0, COUNTS[s], 3 * COUNTS[d]),
                 rng.integers(0, COUNTS[d], 3 * COUNTS[d])) for n, s, d in rels}
    feats = {t: rng.standard_normal((n, DIMS[t])).astype(np.float32) for t, n in COUNTS.items()}
    labels = rng.integers(0, 3, COUNTS[target]).astype(np.int32)
    out = []
    for graph_cls, relation, graphs, prep, kw in (
            (JHetGraph, jmake_relation, jrelation_graphs, jprepare_data, {}),
            (HetGraph, make_relation, relation_semantic_graphs, prepare_data, {"device": "cpu"})):
        g = graph_cls(vertex_counts=dict(COUNTS), features=dict(feats),
                      relations={n: relation(n, s, d, *edges[n]) for n, s, d in rels})
        out.append(prep(g, graphs(g), target, 3, labels, block=8, **kw))
    return tuple(out)


def _rels(schema: dict) -> tuple:
    return tuple((n, s, d) for n, (s, d) in schema.items())


def _names(data, schedule):
    return [[data.graphs[i].name for i in live] for live, _ in schedule]


def test_schedule_on_rgat_mag_matches_the_benchmarks_live_relations():
    _, data = _problem(_rels(_schema()))
    schedule = live_relations(data.graphs, "paper", WIDTH["layers"])
    assert _names(data, schedule) == [
        ["writes", "cites", "has_topic", "writes_rev", "has_topic_rev", "affiliated_with_rev"],
        ["writes", "cites", "has_topic_rev"]]
    assert [set(build) for _, build in schedule] == [{"paper", "author", "field_of_study"},
                                                     {"paper"}]
    # the benchmark's work count makes one backward launch a live relation
    # and layer, in layer order: on rgat-mag's own counts, whose relations
    # all differ, that sequence names its live relations
    spec, names = MAG["graph"], bench_rgat.relations(MAG)
    assert names == [b.name for b in data.graphs]
    ends = _schema()
    graph = {"x": {t: torch.empty((n, spec["feature_width"]), device="meta")
                   for t, n in spec["vertices"].items()},
             "rels": {r: (*ends[r], None, None) for r in names},
             "edges": {r: spec["relations"][r.removesuffix("_rev")][2] for r in names},
             "target": spec["target"]}
    w = MAG["widths"]
    got = bench_rgat.work(MAG, graph, "train")["kernels"]["seg_gat_agg_multigraph_bwd"]
    want = [na_backward(graph["edges"][r], spec["vertices"][ends[r][0]],
                        spec["vertices"][ends[r][1]], 1, w["heads"], w["hidden"])
            for layer in _names(data, live_relations(data.graphs, "paper", w["layers"]))
            for r in layer]
    assert got == want


@pytest.mark.parametrize("backend", list(BACKENDS), ids=lambda b: b.value)
def test_logits_loss_and_gradients_match_jax_grad(backend):
    jdata, data = _problem(_rels(_schema()))
    jparams = JMODELS["R-GAT"].init(jax.random.key(5), jdata, **WIDTH)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")

    def jloss(p):
        logits = JMODELS["R-GAT"].forward(p, jdata, backend=BACKENDS[backend])
        return jcross_entropy(logits, jdata.labels), logits

    (jl, jlogits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    with torch.no_grad():
        logits = rgat_forward(params, data, backend=backend)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    loss, _, grads = hgnn_loss_and_grads(lambda p: rgat_forward(p, data, backend=backend),
                                         params, data, torch.arange(data.labels.shape[0]))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = {"/".join(str(p) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    got = {k: v.numpy() for k, v in tree_leaves_with_path(grads)}
    assert list(got) == list(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=k, **TOL)
    schedule = live_relations(data.graphs, "paper", WIDTH["layers"])
    for layer, (live, _) in enumerate(schedule):
        for i in set(range(len(data.graphs))) - set(live):
            for leaf in grads["layers"][layer]["rel"][f"g{i}"].values():
                assert not leaf.any(), (layer, data.graphs[i].name)
        for i in live:
            assert grads["layers"][layer]["rel"][f"g{i}"]["w_src"].any()


@pytest.mark.parametrize("schema,skipped", [
    (_schema(), 5),
    (_schema(reverse=()), 4),
    ({"writes": ("author", "paper"), "cites": ("paper", "paper"),
      "has_topic_rev": ("field_of_study", "paper")}, 0),
], ids=["rgat-mag", "no-reverses", "all-into-the-target"])
def test_relations_skipped_counts_the_dead_passes(schema, skipped):
    jdata, data = _problem(_rels(schema))
    params = JMODELS["R-GAT"].init(jax.random.key(0), jdata, **WIDTH)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    rgat_forward.relations_skipped = 0
    with torch.no_grad():
        for _ in range(2):
            rgat_forward(params, data, backend=NABackend.SEGMENT)
    assert rgat_forward.relations_skipped == 2 * skipped
    schedule = live_relations(data.graphs, "paper", WIDTH["layers"])
    assert sum(len(data.graphs) - len(live) for live, _ in schedule) == skipped


@pytest.mark.parametrize("target", ["paper", "author"])
def test_a_read_type_no_relation_enters_takes_its_self_product(target):
    """No relation enters ``author``: with ``paper`` the target, the first
    layer builds ``author`` (``writes`` reads it) by its ``self`` product;
    with ``author`` the target, every layer is that product alone."""
    schema = {"writes": ("author", "paper"), "cites": ("paper", "paper"),
              "has_topic": ("paper", "field_of_study")}
    jdata, data = _problem(_rels(schema), target)
    schedule = live_relations(data.graphs, target, WIDTH["layers"])
    if target == "paper":
        assert _names(data, schedule) == [["writes", "cites"]] * 2
        assert [set(b) for _, b in schedule] == [{"author", "paper"}, {"paper"}]
    else:
        assert schedule == [((), frozenset({"author"}))] * 2
    jparams = JMODELS["R-GAT"].init(jax.random.key(2), jdata, **WIDTH)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")

    def jloss(p):
        return jnp.sum(JMODELS["R-GAT"].forward(p, jdata, backend=JNA.SEGMENT) ** 2)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    leaves = [lp["self"]["author"].requires_grad_() for lp in params["layers"]]
    loss = (rgat_forward(params, data, backend=NABackend.SEGMENT) ** 2).sum()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    built = [True, target == "author"]  # the layers whose self product of author is read
    for layer, g in enumerate(got):
        want = np.asarray(jg["layers"][layer]["self"]["author"])
        assert (g is not None) == built[layer] == bool(np.any(want)), layer
        if g is not None:
            np.testing.assert_allclose(g.numpy(), want, **TOL)
