"""Port parity of the per-stage characterization (``obs/characterize.py``)
against the JAX package on synthetic acm at tests/test_torch_train.py's
size (scale=0.05, block=16, max_edges=20000; hidden=8, heads=2), weights
made by JAX's ``init_han`` and carried across through
``repro_torch.convert``.

Times differ between the packages and runs, so the characterization is
held by its structure: the keys of its result, the graph names, the set
of span names with their lanes and attributes in the exported Chrome
traces, and the ``char.stage_us`` labels.  The staged HAN forward
(``han_forward_staged``, rebuilt from the stage functions) equals
``han_forward`` on SEGMENT at the JAX tests' 5e-4 and the JAX staged
forward at rtol=1e-4, atol=1e-5."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.core import NABackend as JNA
from repro.launch.hgnn_train import build_problem as jbuild_problem
from repro.models.hgnn import MODELS as JMODELS
from repro.models.hgnn.han import han_forward_staged as jhan_forward_staged
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import disable_tracing as jdisable_tracing
from repro.obs import enable_tracing as jenable_tracing
from repro.obs.characterize import characterize_hgnn as jcharacterize_hgnn
from repro_torch.convert import params_from_numpy
from repro_torch.core import NABackend
from repro_torch.launch import hgnn_train
from repro_torch.models.hgnn import han_forward, han_forward_staged
from repro_torch.obs import MetricsRegistry, disable_tracing, enable_tracing
from repro_torch.obs.characterize import STAGES, characterize_hgnn

PROBLEM = dict(scale=0.05, feat_scale=0.1, block=16, max_edges=20_000)
# port backend -> the reference's backend of the same path on the CPU
BACKENDS = {
    NABackend.SEGMENT: JNA.SEGMENT,
    NABackend.BLOCK: JNA.BLOCK,
    NABackend.KERNEL: JNA.KERNEL_INTERPRET,
    NABackend.MULTIGRAPH: JNA.MULTIGRAPH_INTERPRET,
}
TOL = dict(rtol=1e-4, atol=1e-5)
CROSS = dict(rtol=5e-4, atol=5e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def problem():
    _, jdata = jbuild_problem("acm", **PROBLEM)
    _, tdata = hgnn_train.build_problem("acm", device="cpu", **PROBLEM)
    jparams = JMODELS["HAN"].init(jax.random.key(3), jdata, hidden=8, heads=2, att_dim=16)
    return jdata, tdata, jparams


def _spans(path, backend_names=None):
    """{(name, lane, attrs)} of a Chrome trace's complete events; attribute
    values that name a backend are mapped through ``backend_names``."""
    events = json.loads(path.read_text())["traceEvents"]
    lanes = {e["tid"]: e["args"]["name"] for e in events if e["name"] == "thread_name"}
    out = set()
    for e in events:
        if e["ph"] != "X":
            continue
        attrs = {k: v for k, v in e["args"].items() if k not in ("depth", "parent")}
        if backend_names and "backend" in attrs:
            attrs["backend"] = backend_names.get(attrs["backend"], attrs["backend"])
        out.add((e["name"], lanes[e["tid"]], e["args"]["parent"],
                 json.dumps(attrs, sort_keys=True)))
    return out


def _labels(snapshot: dict) -> dict:
    """kind -> name -> sorted label sets of a registry snapshot."""
    return {kind: {name: sorted(json.dumps(s["labels"], sort_keys=True) for s in series)
                   for name, series in names.items()}
            for kind, names in snapshot.items()}


@pytest.mark.parametrize("backend", list(BACKENDS), ids=lambda b: b.value)
def test_characterize_matches_the_reference(problem, backend, tmp_path):
    jdata, tdata, jparams = problem
    jreg, treg = JMetricsRegistry(), MetricsRegistry()
    tracer = jenable_tracing(sync=True)
    try:
        want = jcharacterize_hgnn(jparams, jdata, backend=BACKENDS[backend], registry=jreg)
        tracer.export_chrome_trace(str(tmp_path / "jax.json"))
    finally:
        jdisable_tracing()
    tracer = enable_tracing(sync=True)
    try:
        got = characterize_hgnn(params_from_numpy(_np(jparams), device="cpu"), tdata,
                                backend=backend, registry=treg)
        tracer.export_chrome_trace(str(tmp_path / "torch.json"))
    finally:
        disable_tracing()

    assert got.keys() == want.keys()
    assert list(got["stage_us"]) == list(want["stage_us"]) == list(STAGES)
    assert list(got["na_us_per_graph"]) == list(want["na_us_per_graph"])
    assert all(v > 0 for v in got["stage_us"].values())
    assert got["total_us"] == pytest.approx(sum(got["stage_us"].values()))
    names = {BACKENDS[backend].value: backend.value}
    spans = _spans(tmp_path / "torch.json")
    assert spans == _spans(tmp_path / "jax.json", names)
    for b in tdata.graphs:  # one NA span per semantic graph, on its own lane
        assert sum(s[0] == f"char/na/{b.name}" and s[1] == f"sg/{b.name}" for s in spans) == 1
    assert _labels(treg.snapshot()) == _labels(jreg.snapshot())
    assert [s["labels"]["stage"] for s in treg.snapshot()["histograms"]["char.stage_us"]] == \
        sorted(STAGES)


def test_characterize_without_tracing_writes_the_histogram_only(problem):
    _, tdata, jparams = problem
    reg = MetricsRegistry()
    res = characterize_hgnn(params_from_numpy(_np(jparams), device="cpu"), tdata, registry=reg)
    hist = reg.snapshot()["histograms"]["char.stage_us"]
    assert {s["labels"]["stage"]: s["value"]["sum"] for s in hist} == \
        pytest.approx(res["stage_us"])
    assert reg.snapshot()["counters"] == {} and reg.snapshot()["gauges"] == {}


def test_characterize_runs_under_no_grad(problem):
    """KERNEL has no gradient; the pass runs on parameters that require one."""
    _, tdata, jparams = problem
    params = {k: v.requires_grad_() for k, v in
              params_from_numpy(_np(jparams), device="cpu").items()}
    res = characterize_hgnn(params, tdata, backend=NABackend.KERNEL, registry=MetricsRegistry())
    assert set(res["na_us_per_graph"]) == {b.name for b in tdata.graphs}


def test_han_forward_staged_equals_han_forward(problem):
    jdata, tdata, jparams = problem
    params = params_from_numpy(_np(jparams), device="cpu")
    with torch.no_grad():
        staged = han_forward_staged(params, tdata)
        fused = han_forward(params, tdata, backend=NABackend.SEGMENT)
    torch.testing.assert_close(staged, fused, **CROSS)
    np.testing.assert_allclose(staged.numpy(), np.asarray(jhan_forward_staged(jparams, jdata)),
                               **TOL)
