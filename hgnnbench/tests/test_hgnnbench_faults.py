"""Every fault of the timed path a cell can have, and the control, come
out not correct: whole runs at a tiny size on the CPU (the harness's look
for a card skipped), with the port broken underneath."""
from __future__ import annotations

import pytest

from hgnnbench import check, control
from hgnnbench.modes import train as train_mode
from hgnnbench.tests.test_hgnnbench_run import SEED, TINY, _run

# -- faults of the timed path -------------------------------------------------


def _unchanged_state(make):
    def factory(*a, **kw):
        step = make(*a, **kw)
        return lambda state, batch: (state, step(state, batch)[1])
    return factory


def _altered_update(make):
    def factory(*a, **kw):
        step = make(*a, **kw)

        def broken(state, batch):
            new, metrics = step(state, batch)
            leaf = new.params["w_out"]
            new.params["w_out"] = leaf + 1e-2 * leaf.abs().max()
            return new, metrics
        return broken
    return factory


class _HalfBatch(train_mode.SyntheticHGNNData):
    """Half of the batch left out: the mean over the rest."""

    def next(self):
        idx = super().next()["idx"]
        return {"idx": idx[: max(1, idx.numel() // 2)]}


TRAIN_FAULTS = {
    "unchanged_state": lambda mp: mp.setattr(
        train_mode, "make_hgnn_train_step", _unchanged_state(train_mode.make_hgnn_train_step)),
    "half_batch": lambda mp: mp.setattr(train_mode, "SyntheticHGNNData", _HalfBatch),
    "altered_update": lambda mp: mp.setattr(
        train_mode, "make_hgnn_train_step", _altered_update(train_mode.make_hgnn_train_step)),
}


@pytest.mark.parametrize("fault", list(TRAIN_FAULTS))
@pytest.mark.parametrize("name", ["han-dblp.train", "rgat-mag.train"])
def test_a_broken_training_step_is_not_correct(name, fault, monkeypatch):
    TRAIN_FAULTS[fault](monkeypatch)
    line = _run(name)
    checks = line["checks"]
    assert not line["correct"] and line["failed"] >= 1, checks


def _broken_forward(kind):
    from hgnnbench.models import rgat

    real = rgat.Port.forward_fn

    def forward_fn(self):
        fwd = real(self)

        def broken(params):
            out = fwd(params).clone()
            if kind == "altered_answer":
                out[0, 0] += 1.0
            else:  # half of the rows left out
                out[out.shape[0] // 2:] = 0.0
            return out
        return broken
    return forward_fn


@pytest.mark.parametrize("fault", ["altered_answer", "half_batch"])
def test_a_broken_forward_is_not_correct(fault, monkeypatch):
    from hgnnbench.models import rgat
    monkeypatch.setattr(rgat.Port, "forward_fn", _broken_forward(fault))
    line = _run("rgat-mag.infer")
    checks = line["checks"]
    assert not line["correct"], checks


@pytest.mark.parametrize("name", list(TINY))
def test_the_control_is_not_correct(name):
    """The reference in TF32 (operands rounded) in the program's place."""
    for _, numbers, passes in control.readings(name, [SEED, SEED + 1], device="cpu",
                                               overrides=TINY[name]):
        assert not passes, numbers


def test_judge_fails_a_number_over_its_limit_or_not_finite():
    ok, checks, failed = check.judge({"a": 1e-6, "b": 2.0}, {"a": 1e-5, "b": 1.0})
    assert not ok and failed == 1 and checks["b"] == {"value": 2.0, "limit": 1.0}
    assert not check.judge({"a": float("nan")}, {"a": 1.0})[0]
