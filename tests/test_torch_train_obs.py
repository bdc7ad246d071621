"""Port parity of the training side of the observability slice: the
process-wide metrics registry (``obs.get_registry``/``reset_registry``),
``train_loop``'s default to it, and the training launcher's
``--trace``/``--metrics`` against the JAX launcher's on synthetic acm at
tests/test_torch_train.py's size (scale=0.05, block=16, max_edges=20000;
hidden=8, heads=2): the metrics snapshots have the same series names and
label sets, the characterization the same keys, and the traces the same
span names and lanes, besides the spans of the port's eager step phases and
HAN stages, which the reference's jitted step has not."""
import json

import pytest
import torch

from repro.launch.hgnn_train import run_training as jrun_training
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro_torch.core import NABackend
from repro_torch.data import SyntheticHGNNData
from repro_torch.launch import hgnn_train
from repro_torch.models.hgnn import HAN, han_forward
from repro_torch.obs import MetricsRegistry, get_registry, reset_registry
from repro_torch.obs.characterize import STAGES
from repro_torch.optim import AdamWConfig
from repro_torch.train import init_hgnn_train_state, make_hgnn_train_step, train_loop

PROBLEM = dict(scale=0.05, feat_scale=0.1, block=16, max_edges=20_000)
# the spans a port's HAN step opens that the reference's jitted step cannot
PORT_STEP_SPANS = {(name, "main") for name in (
    "step/forward", "step/loss", "step/backward", "step/optimizer",
    "han/fp", "han/theta", "han/fusion", "han/classifier")}
_SILENT = lambda *_: None  # noqa: E731


def _spans(path) -> set[tuple[str, str]]:
    """{(name, lane)} of a Chrome trace's complete events."""
    events = json.loads(path.read_text())["traceEvents"]
    lanes = {e["tid"]: e["args"]["name"] for e in events if e["name"] == "thread_name"}
    return {(e["name"], lanes[e["tid"]]) for e in events if e["ph"] == "X"}


def _labels(snapshot: dict) -> dict:
    """kind -> name -> sorted label sets of a registry snapshot."""
    return {kind: {name: sorted(json.dumps(s["labels"], sort_keys=True) for s in series)
                   for name, series in names.items()}
            for kind, names in snapshot.items()}


@pytest.fixture(scope="module")
def tdata():
    return hgnn_train.build_problem("acm", device="cpu", **PROBLEM)[1]


# -- the process-wide registry -----------------------------------------------


def test_get_registry_is_one_object_and_reset_clears_it():
    reg = get_registry()
    assert get_registry() is reg and isinstance(reg, MetricsRegistry)
    reg.counter("test.events").inc(3)
    assert get_registry().value("test.events") == 3
    reset_registry()
    assert get_registry() is reg and reg.value("test.events") is None
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


def test_train_loop_without_a_registry_writes_the_process_wide_one(tdata):
    reset_registry()
    opt = AdamWConfig(lr=5e-3, weight_decay=0.0)
    state = init_hgnn_train_state(HAN, torch.Generator().manual_seed(0), tdata, opt,
                                  hidden=8, heads=2, att_dim=16)
    step = make_hgnn_train_step(lambda p: han_forward(p, tdata, backend=NABackend.BLOCK),
                                tdata, opt)
    n = tdata.labels.shape[0]
    train_loop(state=state, train_step=step, data=SyntheticHGNNData(n, n), steps=2,
               log=_SILENT)
    reg = get_registry()
    assert reg.value("train.steps") == 2
    assert reg.value("train.loss") is not None and reg.value("train.grad_norm") is not None
    assert reg.snapshot()["histograms"]["train.step_ms"][0]["value"]["count"] == 2
    own = MetricsRegistry()
    train_loop(state=state, train_step=step, data=SyntheticHGNNData(n, n), steps=1,
               log=_SILENT, registry=own)
    assert own.value("train.steps") == 1 and reg.value("train.steps") == 2
    reset_registry()


# -- the training launcher's --trace / --metrics -----------------------------

_KW = dict(dataset="acm", model_name="HAN", hidden=8, heads=2, log=_SILENT, log_every=1,
           **PROBLEM)


def test_run_training_trace_and_metrics_match_the_reference(tmp_path):
    jreg = JMetricsRegistry()
    _, _, jmeta = jrun_training(steps=3, trace=str(tmp_path / "jt.json"),
                                metrics_out=str(tmp_path / "jm.json"), registry=jreg, **_KW)
    reset_registry()  # the port's run writes the process-wide registry
    _, hist, meta = hgnn_train.run_training(steps=3, trace=str(tmp_path / "tt.json"),
                                            metrics_out=str(tmp_path / "tm.json"),
                                            device="cpu", **_KW)
    jm = json.loads((tmp_path / "jm.json").read_text())
    tm = json.loads((tmp_path / "tm.json").read_text())
    assert _labels(tm) == _labels(jm)
    assert get_registry().value("train.steps") == 3
    assert meta["characterize"].keys() == jmeta["characterize"].keys()
    for k in ("stage_us", "na_us_per_graph"):
        assert list(meta["characterize"][k]) == list(jmeta["characterize"][k])
    # span names and lanes: the reference's, but for na/multilane_sharded,
    # which the port opens only over a lane group (lanes > 1), where the
    # reference wraps its 1 x 1 mesh too; and the port's eager step opens
    # spans of its phases and of HAN's stages inside train/step, on its lane
    tspans, jspans = _spans(tmp_path / "tt.json"), _spans(tmp_path / "jt.json")
    assert tspans == {s for s in jspans if s[0] != "na/multilane_sharded"} | PORT_STEP_SPANS
    assert ("train/step", "main") in tspans
    reset_registry()


def test_launcher_trace_and_metrics_on_cpu(tmp_path, capsys):
    reset_registry()
    t, m = tmp_path / "t.json", tmp_path / "m.json"
    hgnn_train.main(["--device", "cpu", "--steps", "3", "--scale", "0.05", "--max-edges",
                     "20000", "--hidden", "8", "--heads", "2", "--trace", str(t),
                     "--metrics", str(m)])
    out = capsys.readouterr().out
    assert f"wrote {t}" in out and f"wrote {m}" in out
    spans = _spans(t)
    names = {s[0] for s in spans}
    graphs = {s[0].split("/")[-1] for s in spans if s[0].startswith("char/na/")}
    assert len(graphs) == 4  # acm's four target metapaths
    assert {"char/forward", "char/fp", "char/gsf", "train/step"} <= names
    for g in graphs:
        for stage in ("theta", "na", "lsf"):
            assert any(s[0] == f"char/{stage}/{g}" and s[1] == f"sg/{g}" for s in spans)
    snap = json.loads(m.read_text())
    assert sorted(s["labels"]["stage"] for s in snap["histograms"]["char.stage_us"]) == \
        sorted(STAGES)
    assert "train.step_ms" in snap["histograms"]
    assert "train.steps" in snap["counters"]
    assert {"train.loss", "train.grad_norm"} <= set(snap["gauges"])
    reset_registry()


def test_run_training_without_trace_characterizes_nothing():
    reg = MetricsRegistry()
    _, _, meta = hgnn_train.run_training(steps=1, registry=reg, device="cpu", **_KW)
    assert meta["characterize"] is None
    assert "char.stage_us" not in reg.snapshot()["histograms"]
    assert reg.value("train.steps") == 1
