"""Port parity of the HGNN leftovers: RAB-style reuse counters
(``core.reuse.count_reuse``) and the numpy minibatch stream
(``data.pipeline.hgnn_minibatches``) against the JAX package, exactly;
the serving launcher's backend names on the CPU; and the three
``examples_torch/`` scripts at a small size with ``--device cpu``."""
import contextlib
import dataclasses
import importlib.util
import io
import itertools
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import count_reuse as jcount_reuse
from repro.data import hgnn_minibatches as jhgnn_minibatches
from repro.graphs import build_semantic_graphs as jbuild_semantic_graphs
from repro.graphs import dataset_metapaths as jdataset_metapaths
from repro.graphs import synthetic_hetgraph as jsynthetic_hetgraph
from repro_torch.core import ReuseCounters, count_reuse
from repro_torch.data import hgnn_minibatches
from repro_torch.graphs import build_semantic_graphs, dataset_metapaths, synthetic_hetgraph
from repro_torch.launch import hgnn_serve

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("dataset", ["acm", "imdb", "dblp"])
def test_count_reuse_equals_the_reference(dataset):
    kw = dict(scale=0.05, feat_scale=0.02, seed=0)
    jg, tg = jsynthetic_hetgraph(dataset, **kw), synthetic_hetgraph(dataset, **kw)
    jsgs = jbuild_semantic_graphs(jg, jdataset_metapaths(dataset), max_edges=20_000)
    tsgs = build_semantic_graphs(tg, dataset_metapaths(dataset), max_edges=20_000)
    want = jcount_reuse(jsgs, jg.vertex_counts)
    got = count_reuse(tsgs, tg.vertex_counts)
    assert isinstance(got, ReuseCounters)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.fp_saved, got.theta_saved) == (want.fp_saved, want.theta_saved)
    assert got.fp_dedup <= got.fp_naive


def test_reuse_counters_of_nothing_save_nothing():
    c = count_reuse([], {})
    assert dataclasses.asdict(c) == dict(fp_naive=0, fp_dedup=0, theta_naive=0, theta_dedup=0)
    assert c.fp_saved == c.theta_saved == 1.0


@pytest.mark.parametrize("num_vertices,batch_size,seed",
                         [(10, 3, 0), (64, 16, 1), (1000, 128, 7), (5, 5, 3), (100, 1, 5)])
def test_hgnn_minibatches_are_the_reference_s_bit_for_bit(num_vertices, batch_size, seed):
    n = 2 * (num_vertices // batch_size) + 1  # into the third epoch
    want = list(itertools.islice(jhgnn_minibatches(num_vertices, batch_size, seed), n))
    got = list(itertools.islice(hgnn_minibatches(num_vertices, batch_size, seed), n))
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_hgnn_minibatches_cover_each_epoch_once():
    ids = list(itertools.islice(hgnn_minibatches(12, 4, seed=2), 3))
    assert sorted(np.concatenate(ids).tolist()) == list(range(12))


# -- the serving launcher's backend names ------------------------------------


def _serve(backend: str) -> tuple[dict, dict]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        outputs = hgnn_serve.main(["--device", "cpu", "--na-backend", backend, "--repeats", "2"])
    return json.loads(buf.getvalue()), outputs


@pytest.fixture(scope="module")
def served():
    return {b: _serve(b) for b in ("multigraph", "fused-fp")}


@pytest.mark.parametrize("backend", ["segment", "fused_fp", "multigraph_interpret",
                                     "fused_fp_interpret"])
def test_serve_launcher_takes_the_reference_s_backend_names(served, backend):
    metrics, outputs = _serve(backend)
    assert metrics["device"] == "cpu" and metrics["requests_finished"] == len(outputs) > 0
    fused = backend.startswith("fused")
    same = served["fused-fp" if fused else "multigraph"][1]
    assert sorted(outputs) == sorted(same)
    for rid, out in outputs.items():
        assert torch.isfinite(out).all()
        if backend == "segment":  # another NA path: the same function
            torch.testing.assert_close(out, same[rid], atol=1e-4, rtol=1e-4)
        else:  # a spelling of the same backend: the same bits
            assert torch.equal(out, same[rid])
    assert (metrics["fused_steps"] > 0) == fused


def test_serve_launcher_rejects_an_unknown_backend():
    with pytest.raises(SystemExit):
        hgnn_serve.main(["--device", "cpu", "--na-backend", "kernel"])


# -- examples_torch/ ----------------------------------------------------------


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_example_on_cpu(capsys):
    losses = _example("quickstart").main(["--device", "cpu", "--scale", "0.05", "--steps", "4"])
    out = capsys.readouterr().out
    assert "execution order:" in out and "FP work saved by dedup" in out
    assert "lane loads (edges):" in out
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_serve_hgnn_example_on_cpu(capsys):
    res = _example("serve_hgnn").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "outputs bit-identical across admission policies" in out
    assert res["similarity"]["fp_rows_computed"] <= res["fifo"]["fp_rows_computed"]
    assert res["similarity"]["na_launches"] == res["similarity"]["steps"]


def test_train_hgnn_han_example_on_cpu(tmp_path, capsys):
    _, history, meta = _example("train_hgnn_han").main([
        "--device", "cpu", "--steps", "3", "--scale", "0.05", "--ckpt", str(tmp_path / "ck")])
    assert "training complete" in capsys.readouterr().out
    assert meta["backend"] == "kernel" and meta["plan_lanes"] == 1
    assert meta["n_params"] > 2_000_000  # 8 heads of 128 on ACM's full features
    assert history[-1]["loss"] < history[0]["loss"]
    assert (tmp_path / "ck").is_dir()


def test_train_hgnn_han_example_resumes_unless_told_not_to(tmp_path, capsys):
    ex = _example("train_hgnn_han")
    argv = ["--device", "cpu", "--steps", "2", "--scale", "0.05", "--ckpt", str(tmp_path / "ck")]
    _, first, _ = ex.main(argv)
    _, resumed, _ = ex.main(argv)
    assert "nothing to train" in capsys.readouterr().out and resumed == []
    _, again, _ = ex.main(argv + ["--no-resume"])
    assert [h["step"] for h in again] == [h["step"] for h in first]
    assert [h["loss"] for h in again] == [h["loss"] for h in first]
