"""The Simple-HGN cell at a tiny size on the CPU: the port against the
plain reference (logits, loss and every leaf's gradient, with residual
attention and without), the reference's joint softmax against one dense
softmax over every relation, the configuration's widths and cut, a whole
run correct and a traced one reading the cell's metrics, and the faults
and the control not correct."""
from __future__ import annotations

import copy

import pytest
import torch

from hgnnbench import check, control, harness
from hgnnbench.models.simple_hgn import Port
from hgnnbench.reference import simple_hgn as ref
from hgnnbench.reference.common import cross_entropy
from hgnnbench.tests.test_hgnnbench_faults import TRAIN_FAULTS

CELL = "simple-hgn-mag.train"
SEED = 2**31 + 4343
TINY = {"graph": {"vertices": {"paper": 40, "author": 50, "institution": 6, "field_of_study": 12},
                  "feature_width": 16,
                  "relations": {"writes": ["author", "paper", 120], "cites": ["paper", "paper", 90],
                                "has_topic": ["paper", "field_of_study", 80],
                                "affiliated_with": ["author", "institution", 40]},
                  "reverse": ["writes", "cites", "has_topic", "affiliated_with"],
                  "target": "paper", "num_classes": 349},
        "widths": {"input": 8, "hidden": 8, "heads": 2, "edge_dim": 8, "layers": 2,
                   "output_heads": 1, "beta": 0.05, "slope": 0.05}}
BENCH = harness.benchmark()


def _setup(beta: float):
    over = copy.deepcopy(TINY)
    over["widths"]["beta"] = beta
    run = harness.Run(BENCH, CELL, SEED, "cpu", over)
    inputs = harness.make_inputs(run)
    return run, inputs, Port(run.cfg, inputs, run.device, run.span, mode="train")


@pytest.mark.parametrize("beta", [0.05, 0.0])
def test_the_port_matches_the_reference_logits_loss_and_every_gradient(beta):
    run, inputs, port = _setup(beta)
    graph = ref.prepare(run.cfg, inputs, run.device)
    leaves = {k: p.clone().requires_grad_() for k, p in run.params.items()}
    want = ref.forward(run.cfg, leaves, graph)
    want_loss = cross_entropy(want, graph["labels"])
    want_g = dict(zip(leaves, torch.autograd.grad(want_loss, list(leaves.values()))))
    tree = port.to_port(run.params)
    flat = port.from_port(tree)
    for p in flat.values():
        p.requires_grad_()
    got = port.forward_fn()(tree)
    got_loss = cross_entropy(got, port.data.labels)
    got_g = dict(zip(flat, torch.autograd.grad(got_loss, list(flat.values()))))
    assert got.shape == (40, 349)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=1e-5)
    torch.testing.assert_close(got_loss, want_loss, atol=1e-6, rtol=1e-6)
    assert set(got_g) == set(want_g) == set(run.params)
    for k in want_g:
        torch.testing.assert_close(got_g[k], want_g[k], atol=1e-6, rtol=1e-4,
                                   msg=lambda m, k=k: f"{k}: {m}")
    assert float(want_g["layers.0.a_edge"].norm()) > 0  # the edge types reach the loss


def test_the_reference_softmax_is_one_dense_softmax_over_every_relation():
    gen = torch.Generator().manual_seed(0)
    n, H, T = 7, 3, 3
    src = torch.tensor([0, 1, 1, 2, 3, 3, 4, 5, 6, 1])
    dst = torch.tensor([1, 1, 1, 0, 0, 2, 2, 2, 2, 0])
    et = torch.tensor([0, 0, 1, 2, 1, 0, 2, 2, 1, 1])  # (1 <- 1) of two types
    th_s, th_d, bias = (torch.randn(n, H, generator=gen), torch.randn(n, H, generator=gen),
                        torch.randn(T, H, generator=gen))
    p = ref.attention(th_s, th_d, bias, src, dst, et, n, 0.05)
    dense = torch.full((T, n, n, H), float("-inf"))
    pre = th_d[dst] + th_s[src] + bias[et]
    dense[et, dst, src] = torch.where(pre >= 0, pre, 0.05 * pre)
    want = torch.softmax(dense.permute(1, 0, 2, 3).reshape(n, T * n, H), dim=1)
    torch.testing.assert_close(p, want.reshape(n, T, n, H)[dst, et, src])


def test_the_configuration_holds_hgbs_widths_and_states_its_cut():
    cfg = harness.config("simple-hgn-mag")
    w, g = cfg["widths"], cfg["graph"]
    assert (w["input"], w["hidden"], w["heads"], w["edge_dim"], w["layers"]) == (64, 64, 8, 64, 2)
    assert (w["beta"], w["slope"], g["num_classes"], cfg["share_of"]) == (0.05, 0.05, 349, 2)
    assert cfg["reduced"] == ["vertices", "relations"] and cfg["deployment"]
    assert {"dropout", "optimizer", "feature_width", "reverse", "attention", "bias",
            "labels"} <= set(cfg["assumed"])
    rel = sum(e for _, _, e in g["relations"].values())
    loops = sum(g["vertices"].values())
    assert cfg["edges"] == {"relations": rel, "reverses": rel, "self_loops": loops,
                            "total": 2 * rel + loops, "edge_types": 9}
    assert loops == 969_870 and 2 * rel + loops == 22_080_876
    assert len(set(ref.edge_types(cfg).values())) == 9 == 2 * len(g["relations"]) + 1
    for v, pub in cfg["published"]["vertices"].items():
        assert g["vertices"][v] == pub // 2
    assert cfg["optimizer"]["lr"] == 5e-4 and cfg["optimizer"]["weight_decay"] == 1e-4


def test_a_sound_run_is_correct_and_a_traced_run_reads_the_cells_metrics():
    line = harness.run_cell(CELL, SEED, 0.2, False, device="cpu", overrides=TINY)
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert set(line["metrics"]) == {"setup_s", "train_step_ms"}
    traced = harness.run_cell(CELL, SEED + 1, 0.2, True, device="cpu", overrides=TINY)
    allowed = {m["name"] for m in BENCH["per_layer"] if CELL in m.get("workloads", [CELL])}
    assert traced["correct"] and set(traced["metrics"]) <= allowed
    assert {"step_mfu.simple_hgn", "step.enqueue_ms.simple_hgn"} <= set(traced["metrics"])
    work = ref.work(harness.config("simple-hgn-mag"), ref.prepare(
        harness.config("simple-hgn-mag") | TINY, harness.make_inputs(
            harness.Run(BENCH, CELL, SEED, "cpu", TINY)), "cpu"), "train")
    assert [len(v) for v in work["kernels"].values()] == [3, 3] and work["flops"] > 0


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "tf32"])
def test_the_faults_and_the_control_are_not_correct(fault, monkeypatch):
    if fault == "tf32":
        (_, numbers, passes), = control.readings(CELL, [SEED], device="cpu", overrides=TINY)
        assert not passes, numbers
        return
    TRAIN_FAULTS[fault](monkeypatch)
    line = harness.run_cell(CELL, SEED, 0.2, False, device="cpu", overrides=TINY)
    assert not line["correct"] and line["failed"] >= 1, line["checks"]
    assert not check.judge({k: c["value"] for k, c in line["checks"].items()},
                           harness.config("simple-hgn-mag")["limits"]["train"])[0]
