"""Port parity of the HAN training slice.

HAN on synthetic acm at the reference trainer tests' size
(tests/test_hgnn_train.py ``_KW``: scale=0.05, hidden=8, heads=2,
block=16, max_edges=20000), with weights made by
``repro.models.hgnn.init_han`` and carried across through
``repro_torch.convert``:

* the problem (graph order, block CSR, labels) is byte for byte the same;
* logits and every parameter's gradient agree with ``jax.grad`` on BLOCK,
  MULTIGRAPH and FUSED_FP (the JAX kernels in interpret mode) at
  rtol=1e-4, atol=1e-5;
* per-step losses over 5 AdamW steps with an injected ``idx`` stream agree
  at rtol=1e-4 (float32; the sums run in another order);
* a JAX checkpoint restores into the port and a port checkpoint into
  ``repro.checkpoint.restore_checkpoint``, bit for bit;
* crash-at-k resume is bit-identical, and the launcher runs with
  ``--device cpu``.

tests/test_torch_cuda.py runs the trainer on the card against the CPU."""
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
import repro.optim as joptim
from repro.core import NABackend as JNA
from repro.launch.hgnn_train import build_problem as jbuild_problem
from repro.models.hgnn import MODELS as JMODELS
from repro.models.hgnn import cross_entropy as jcross_entropy
from repro.models.hgnn import han_forward as jhan_forward
from repro.train import init_hgnn_train_state as jinit_state
from repro.train import make_hgnn_train_step as jmake_step
from repro_torch import checkpoint as tckpt
from repro_torch.checkpoint import reshard_to
from repro_torch import optim as toptim
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.core import NABackend
from repro_torch.data import SyntheticHGNNData
from repro_torch.launch import hgnn_train
from repro_torch.models.hgnn import cross_entropy, han_forward
from repro_torch.train import make_hgnn_train_step
from repro_torch.tree import tree_leaves_with_path

PROBLEM = dict(scale=0.05, feat_scale=0.1, block=16, max_edges=20_000)
WIDTH = dict(hidden=8, heads=2, att_dim=16)
TOL = dict(rtol=1e-4, atol=1e-5)
BACKENDS = {  # port backend -> the JAX backend of the same path, on the CPU
    NABackend.BLOCK: JNA.BLOCK,
    NABackend.MULTIGRAPH: JNA.MULTIGRAPH_INTERPRET,
    NABackend.FUSED_FP: JNA.FUSED_FP_INTERPRET,
}
OPT = dict(lr=5e-3, weight_decay=0.0)
_SILENT = lambda *_: None  # noqa: E731


@pytest.fixture(scope="module")
def problem():
    _, jdata = jbuild_problem("acm", **PROBLEM)
    _, tdata = hgnn_train.build_problem("acm", device="cpu", **PROBLEM)
    jstate = jinit_state(JMODELS["HAN"], jax.random.key(0), jdata, joptim.AdamWConfig(**OPT),
                         **WIDTH)
    return jdata, tdata, jstate


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_problem_is_the_reference_problem(problem):
    jdata, tdata, _ = problem
    assert [b.name for b in tdata.graphs] == [b.name for b in jdata.graphs]
    for jb, tb in zip(jdata.graphs, tdata.graphs):
        np.testing.assert_array_equal(tb.col_index.numpy(), np.asarray(jb.col_index))
        np.testing.assert_array_equal(tb.masks.numpy(), np.asarray(jb.masks))
    np.testing.assert_array_equal(tdata.labels.numpy(), np.asarray(jdata.labels))
    t = jdata.target_type
    np.testing.assert_array_equal(tdata.features[t].numpy(), np.asarray(jdata.features[t]))
    assert tdata.num_classes == jdata.num_classes


@pytest.mark.parametrize("backend", list(BACKENDS), ids=lambda b: b.value)
def test_han_logits_and_gradients_match_jax(problem, backend):
    jdata, tdata, jstate = problem
    jb = BACKENDS[backend]
    jparams = jstate.params

    def jloss(p):
        return jcross_entropy(jhan_forward(p, jdata, backend=jb), jdata.labels)

    j_logits = np.asarray(jax.jit(lambda p: jhan_forward(p, jdata, backend=jb))(jparams))
    j_grads = _np(jax.jit(jax.grad(jloss))(jparams))
    params = {k: v.requires_grad_() for k, v in params_from_numpy(
        _np(jparams), device="cpu").items()}
    logits = han_forward(params, tdata, backend=backend)
    np.testing.assert_allclose(logits.detach().numpy(), j_logits, **TOL)
    names = sorted(params)
    grads = torch.autograd.grad(cross_entropy(logits, tdata.labels), [params[k] for k in names])
    for k, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), j_grads[k], err_msg=k, **TOL)


def _idx_stream(n, steps=5, batch=48, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.permutation(n)[:batch].astype(np.int32) for _ in range(steps)]


@pytest.mark.parametrize("backend", [NABackend.MULTIGRAPH], ids=lambda b: b.value)
def test_five_adamw_steps_track_jax(problem, backend):
    jdata, tdata, jstate = problem
    jb = BACKENDS[backend]
    jstep = jax.jit(jmake_step(lambda p: jhan_forward(p, jdata, backend=jb), jdata,
                               joptim.AdamWConfig(**OPT)))
    tstep = make_hgnn_train_step(lambda p: han_forward(p, tdata, backend=backend), tdata,
                                 toptim.AdamWConfig(**OPT))
    js = jstate
    ts = train_state_from_numpy(_np(jstate.params), _np(jstate.opt), np.asarray(jstate.step),
                                device="cpu")
    for idx in _idx_stream(tdata.labels.shape[0]):
        js, jm = jstep(js, {"idx": jnp.asarray(idx)})
        ts, tm = tstep(ts, {"idx": torch.from_numpy(idx)})
        for k in ("loss", "acc", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    assert int(ts.step) == int(js.step) == 5
    for k, v in _np(js.params).items():
        np.testing.assert_allclose(ts.params[k].numpy(), v, rtol=1e-3, atol=1e-5, err_msg=k)


def _assert_same_leaves(tstate, jstate):
    tleaves = dict(tree_leaves_with_path(tstate))
    jleaves = {"/".join(str(p) for p in path): np.asarray(v)
               for path, v in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    assert list(tleaves) == list(jleaves)  # the same keys, in the same order
    for k, v in jleaves.items():
        assert tleaves[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(tleaves[k].numpy(), v, err_msg=k)


def test_checkpoints_cross_between_jax_and_the_port(problem, tmp_path):
    _, _, jstate = problem
    rng = np.random.default_rng(1)
    js = jax.tree_util.tree_map(  # a state with every leaf set: params, moments, count, step
        lambda a: a + (rng.standard_normal(a.shape).astype(a.dtype) if a.dtype.kind == "f" else 3),
        jstate)
    aux = {"data": {"step": 1, "seed": 0}}
    like = train_state_from_numpy(_np(jstate.params), _np(jstate.opt), 0, device="cpu")

    jckpt.save_checkpoint(str(tmp_path / "jax"), 1, js, aux=aux)
    restored, got_aux = tckpt.restore_checkpoint(str(tmp_path / "jax"), 1, like)
    assert got_aux == aux
    _assert_same_leaves(restored, js)

    tckpt.save_checkpoint(str(tmp_path / "port"), 1, restored, aux=aux)
    back, _ = jckpt.restore_checkpoint(str(tmp_path / "port"), 1, jstate)
    _assert_same_leaves(restored, back)
    manifests = [json.loads((tmp_path / d / "step_1" / "manifest.json").read_text())
                 for d in ("jax", "port")]
    assert manifests[0] == manifests[1]
    assert tckpt.latest_step(str(tmp_path / "port")) == 1


_RUN = dict(dataset="acm", hidden=8, heads=2, scale=0.05, block=16, max_edges=20_000,
            batch=32, log=_SILENT, log_every=1, device="cpu")


def test_crash_at_step_k_resume_bit_identical(tmp_path):
    kw = dict(steps=6, ckpt_every=2, **_RUN)
    ref, ref_hist, meta = hgnn_train.run_training(ckpt_dir=str(tmp_path / "ref"), **kw)
    assert meta["backend"] == "kernel" and meta["device"] == "cpu" and meta["plan_lanes"] == 1
    crashed = str(tmp_path / "crashed")
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        hgnn_train.run_training(ckpt_dir=crashed, crash_at=5, **kw)
    resumed, hist, _ = hgnn_train.run_training(ckpt_dir=crashed, **kw)
    assert hist[0]["step"] == 4  # resumed from the step-4 checkpoint
    for a, b in zip(tree_leaves_with_path(ref), tree_leaves_with_path(resumed)):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]


def test_data_pipeline_is_counter_based():
    full = SyntheticHGNNData(num_vertices=10, batch_size=10)
    assert torch.equal(full.next()["idx"], torch.arange(10))
    a = SyntheticHGNNData(num_vertices=50, batch_size=8, seed=3)
    first = [a.next()["idx"] for _ in range(3)]
    b = SyntheticHGNNData(num_vertices=50, batch_size=8, seed=3)
    b.restore({"step": 1, "seed": 3})
    assert torch.equal(b.next()["idx"], first[1])
    assert not torch.equal(first[0], first[1]) and len(set(first[2].tolist())) == 8
    with pytest.raises(ValueError, match="seed"):
        b.restore({"step": 0, "seed": 4})


def test_adamw_and_schedule_match_jax():
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in (("a", (3, 4)), ("b", (5,)))}
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip=0.5)
    jp, js = {k: jnp.asarray(v) for k, v in params.items()}, None
    js = joptim.init_opt_state(jp, joptim.AdamWConfig(**cfg))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = toptim.init_opt_state(tp, toptim.AdamWConfig(**cfg))
    for step in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        lr = joptim.warmup_cosine(jnp.asarray(step), peak_lr=1e-2, warmup_steps=2, total_steps=10)
        tlr = toptim.warmup_cosine(torch.tensor(step), peak_lr=1e-2, warmup_steps=2, total_steps=10)
        np.testing.assert_allclose(float(tlr), float(lr), rtol=1e-6)
        jp, js, jn = joptim.apply_updates(jp, {k: jnp.asarray(v) for k, v in grads.items()}, js,
                                          joptim.AdamWConfig(**cfg), lr)
        tp, ts, tn = toptim.apply_updates(tp, {k: torch.from_numpy(v) for k, v in grads.items()},
                                          ts, toptim.AdamWConfig(**cfg), tlr)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(ts["v"][k].numpy(), np.asarray(js["v"][k]), rtol=1e-5)
    assert int(ts["count"]) == int(js["count"]) == 3
    assert ts["master"] == {k: None for k in params}  # the reference's layout for float32


def test_launcher_main_on_cpu(tmp_path, capsys):
    out = tmp_path / "run.json"
    hgnn_train.main(["--device", "cpu", "--steps", "3", "--scale", "0.05", "--max-edges", "20000",
                     "--hidden", "8", "--heads", "2", "--ckpt", str(tmp_path / "ck"),
                     "--out", str(out)])
    assert "final loss" in capsys.readouterr().out
    run = json.loads(out.read_text())
    assert run["meta"]["backend"] == "kernel" and run["history"][-1]["step"] == 2
    assert tckpt.latest_step(str(tmp_path / "ck")) == 3


@pytest.mark.parametrize("argv,match", [
    # a model rank holds whole heads, R-GAT's as HAN's
    (["--model", "R-GAT", "--heads", "3", "--model-split", "2"], "multiple of model_split"),
])
def test_launcher_rejects_what_is_not_ported(argv, match):
    with pytest.raises(ValueError, match=match):
        hgnn_train.main(["--device", "cpu", "--steps", "1", *argv])


_CLI = ["--device", "cpu", "--scale", "0.05", "--max-edges", "20000", "--hidden", "8",
        "--heads", "2"]


def test_launcher_plan_lanes_gives_the_same_first_loss(tmp_path):
    """HAN over a 4-lane plan: the forward is the one-lane forward, bit for bit."""
    runs = {}
    for lanes in ("1", "4"):
        out = tmp_path / f"plan{lanes}.json"
        hgnn_train.main([*_CLI, "--steps", "2", "--plan-lanes", lanes, "--out", str(out)])
        runs[lanes] = json.loads(out.read_text())
    assert runs["4"]["meta"]["plan_lanes"] == 4 and runs["1"]["meta"]["plan_lanes"] == 1
    assert runs["4"]["history"][0]["loss"] == runs["1"]["history"][0]["loss"]
    assert runs["4"]["history"][-1]["loss"] < runs["4"]["history"][0]["loss"]


def test_launcher_lanes_without_a_process_group_names_torchrun(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        hgnn_train.main([*_CLI, "--steps", "1", "--lanes", "2"])
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        hgnn_train.main([*_CLI, "--steps", "1", "--model-split", "2"])
    with pytest.raises(ValueError, match="multiple of lanes"):
        hgnn_train.run_training(lanes=2, plan_lanes=3, device="cpu")


def test_launcher_block_defaults_to_the_papers_128():
    assert hgnn_train.parse_args([]).block == 128
    for fn in (hgnn_train.run_training, hgnn_train.build_problem):
        assert inspect.signature(fn).parameters["block"].default == 128


def test_checkpoint_restores_bitwise_at_any_plan_lane_count(tmp_path):
    """Elastic restart (reference tests/test_hgnn_train.py): a checkpoint
    written at plan lanes 2 restores bit for bit at 4 and at 1, and the run
    continued on 4 lanes tracks the uninterrupted 2-lane run at 1e-4."""
    ckpt = str(tmp_path / "ckpt")
    kw = dict(ckpt_every=3, **_RUN)
    state2, _, _ = hgnn_train.run_training(steps=6, plan_lanes=2, ckpt_dir=ckpt, **kw)
    for lanes in (4, 1):  # restore-only relaunches: every step is done
        restored, hist, meta = hgnn_train.run_training(steps=6, plan_lanes=lanes, ckpt_dir=ckpt,
                                                       **kw)
        assert hist == [] and meta["plan_lanes"] == lanes
        for a, b in zip(tree_leaves_with_path(state2), tree_leaves_with_path(restored)):
            assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]
    cont4, _, _ = hgnn_train.run_training(steps=9, plan_lanes=4, ckpt_dir=ckpt, **kw)
    ref9, _, _ = hgnn_train.run_training(steps=9, plan_lanes=2, ckpt_dir=str(tmp_path / "r9"),
                                         **kw)
    for a, b in zip(tree_leaves_with_path(ref9), tree_leaves_with_path(cont4)):
        torch.testing.assert_close(b[1], a[1], rtol=1e-4, atol=1e-4, msg=a[0])
    assert reshard_to(cont4, "cpu").step == cont4.step


def test_launcher_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hgnn_train.main(["--steps", "1"])
