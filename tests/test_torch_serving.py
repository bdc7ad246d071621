"""Port parity of the serving slice: the JAX ``HGNNEngine`` and the
port's, on the same imdb graph with the same weights (carried across by
``repro_torch.convert``), serve the same request mix.  Every request's
result and semantic attention match to atol=1e-5, rtol=1e-4; scheduling
(admitted/finished steps) and the integer metrics are equal."""
import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.graphs as jgraphs
import repro.serve as jserve
import repro_torch.core as tcore
import repro_torch.graphs as tgraphs
import repro_torch.serve as tserve
from repro_torch.convert import engine_params_from_numpy

MDM = ("movie", "director", "movie")
MAM = ("movie", "actor", "movie")
MKM = ("movie", "keyword", "movie")
CLUSTERS = [  # tests/test_hgnn_serving.py:CLUSTERS
    [MDM, ("movie", "director", "movie", "director", "movie")],
    [MAM, ("movie", "actor", "movie", "actor", "movie")],
    [MKM],
]
ENGINE = dict(target_type="movie", hidden=4, heads=2, num_slots=2, cache_block_rows=64,
              block=8, max_edges=2000, seed=0)
INT_METRICS = ("steps", "na_launches", "requests_finished", "cache_hits", "cache_misses",
               "fp_rows_computed", "fp_rows_reused", "fp_rows_naive", "fused_steps",
               "fused_cache_bypasses", "reused_bytes", "fetched_bytes", "evicted_bytes")


@pytest.fixture(scope="module")
def graphs():
    kw = dict(scale=0.05, feat_scale=0.02, seed=0)
    return jgraphs.synthetic_hetgraph("imdb", **kw), tgraphs.synthetic_hetgraph("imdb", **kw)


def _small_cache(g):
    """Adversarial capacity of tests/test_hgnn_serving.py: forces evictions."""
    table = {t: n * 2 * 4 * 4 for t, n in g.vertex_counts.items()}
    return table["movie"] + max(table.values()) + 64 * 2 * 4 * 4


def _engines(graphs, jbackend, tbackend, **kw):
    jg, tg = graphs
    jeng = jserve.HGNNEngine(jg, backend=jbackend, **ENGINE, **kw)
    for cl in CLUSTERS:
        for mp in cl:
            jeng._metapath_params(mp)
    conv = engine_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jeng.params),
        {mp: tuple(np.asarray(a) for a in v) for mp, v in jeng._mp_params.items()},
        device="cpu",
    )
    teng = tserve.HGNNEngine(tg, backend=tbackend, device="cpu", **ENGINE, **kw, **conv)
    return jeng, teng


def _serve(eng, serve_pkg, prewarm=False):
    if prewarm:  # the whole target table resident: FUSED_FP takes the projected path
        eng.cache.project("movie", eng.features["movie"],
                          eng.params["w_fp"]["movie"], eng.params["b_fp"]["movie"])
    for r in serve_pkg.make_request_mix(0, CLUSTERS, repeats=2):
        eng.submit(r)
    return {r.rid: r for r in eng.run()}


@pytest.mark.parametrize("name,jbackend,tbackend,kw,prewarm", [
    ("multigraph", jcore.NABackend.MULTIGRAPH_INTERPRET, tcore.NABackend.MULTIGRAPH,
     dict(), False),
    ("multigraph-fifo-evict", jcore.NABackend.MULTIGRAPH_INTERPRET, tcore.NABackend.MULTIGRAPH,
     dict(admission="fifo", cache_policy="similarity"), False),
    ("fused-fp", jcore.NABackend.FUSED_FP_INTERPRET, tcore.NABackend.FUSED_FP,
     dict(), False),
    ("fused-fp-cache-hit", jcore.NABackend.FUSED_FP_INTERPRET, tcore.NABackend.FUSED_FP,
     dict(), True),
])
def test_engine_matches_jax_engine(graphs, name, jbackend, tbackend, kw, prewarm):
    cache = _small_cache(graphs[0]) if name.endswith("evict") else 1 << 20
    jeng, teng = _engines(graphs, jbackend, tbackend, cache_bytes=cache, **kw)
    jres, tres = _serve(jeng, jserve, prewarm), _serve(teng, tserve, prewarm)
    assert sorted(jres) == sorted(tres) == list(range(6))
    for rid, jr in jres.items():
        tr = tres[rid]
        assert (tr.submitted_step, tr.admitted_step, tr.finished_step) == (
            jr.submitted_step, jr.admitted_step, jr.finished_step), rid
        assert tr.result.shape == (teng.n_target, teng.heads * teng.hidden)
        np.testing.assert_allclose(tr.result.numpy(), np.asarray(jr.result),
                                   atol=1e-5, rtol=1e-4, err_msg=f"{name} rid {rid}")
        np.testing.assert_allclose(tr.beta.numpy(), np.asarray(jr.beta),
                                   atol=1e-5, rtol=1e-4, err_msg=f"{name} rid {rid}")
    jm, tm = jeng.metrics(), teng.metrics()
    assert {k: tm[k] for k in INT_METRICS} == {k: jm[k] for k in INT_METRICS}
    if name == "fused-fp":
        assert tm["fused_steps"] == tm["steps"] > 0 and tm["fused_cache_bypasses"] == 0
    if name == "fused-fp-cache-hit":
        assert tm["fused_steps"] == 0 and tm["fused_cache_bypasses"] == tm["steps"] > 0
    if name == "multigraph-fifo-evict":
        assert tm["evicted_bytes"] > 0


def test_fifo_and_similarity_admission_bit_identical(graphs):
    tg = graphs[1]
    results = {}
    for admission in ("fifo", "similarity"):
        eng = tserve.HGNNEngine(tg, backend=tcore.NABackend.MULTIGRAPH, device="cpu",
                                admission=admission, cache_bytes=1 << 20, **ENGINE)
        results[admission] = {rid: r.result for rid, r in _serve(eng, tserve).items()}
    assert results["fifo"].keys() == results["similarity"].keys()
    for rid, res in results["fifo"].items():
        assert torch.equal(res, results["similarity"][rid]), rid


def test_fp_cache_capacity_hits_and_invalidation():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((16, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
    b = torch.zeros(8)
    blk_bytes = 4 * 8 * 4
    cache = tserve.FPCache(4 * blk_bytes, block_rows=4)
    out = cache.project("a", x, w, b)
    assert cache.stats.misses == 4 and cache.stats.hits == 0
    assert cache.resident_bytes == 4 * blk_bytes
    np.testing.assert_allclose(out.numpy(), (x @ w + b).numpy(), atol=1e-6, rtol=1e-6)
    again = cache.project("a", x, w, b)
    assert cache.stats.hits == 4 and torch.equal(out, again)
    assert torch.equal(tserve.FPCache(0, block_rows=4).project("a", x, w, b), out)

    small = tserve.FPCache(2 * blk_bytes, block_rows=4)
    small.project("a", x, w, b)
    assert small.resident_bytes <= small.capacity_bytes and small.num_blocks == 2

    cache.invalidate("a")
    assert cache.version("a") == 1 and cache.num_blocks == 0
    new = cache.project("a", x + 1.0, w, b)
    assert cache.stats.hits == 4  # no old-version block served
    np.testing.assert_allclose(new.numpy(), ((x + 1.0) @ w + b).numpy(), atol=1e-6, rtol=1e-6)


def test_engine_rejects_non_target_endpoints(graphs):
    eng = tserve.HGNNEngine(graphs[1], device="cpu", cache_bytes=0, **ENGINE)
    with pytest.raises(ValueError, match="target type"):
        eng.submit(tserve.GraphRequest(rid=0, metapaths=[("director", "movie", "director")]))
