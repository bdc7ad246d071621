"""Port parity of R-GAT (and S-HGN, R-GCN) training: nested parameter
trees through gradients, AdamW, checkpoints and the launcher.

Weights are made by the JAX ``init_*`` functions and carried across
through ``repro_torch.convert`` (nested dicts and lists):

* gradients of every parameter on the relation graphs of synthetic acm
  (scale=0.05, block=16, narrow widths) against ``jax.grad``: S-HGN on
  MULTIGRAPH (kernels #1/#2 at G = 1, its edge bias takes #2's d_bias;
  ``MULTIGRAPH_INTERPRET`` in JAX), R-GCN on SEGMENT; rtol=1e-4,
  atol=1e-5 (R-GAT's: tests/test_torch_rgat_grads.py);
* 5 AdamW steps of R-GAT on the launcher's problem (metapath graphs,
  layers=2) with an injected ``idx`` stream track the JAX train step;
* an R-GAT checkpoint (a tree with lists) crosses between the packages bit
  for bit, keys and manifest included;
* ``hgnn_train --model R-GAT --device cpu`` trains.

tests/test_torch_cuda.py runs R-GAT training on the card."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
import repro.optim as joptim
from repro.core import NABackend as JNA
from repro.graphs import relation_semantic_graphs as jrelation_graphs
from repro.graphs import synthetic_hetgraph as jsynthetic_hetgraph
from repro.launch.hgnn_train import build_problem as jbuild_problem
from repro.models.hgnn import MODELS as JMODELS
from repro.models.hgnn import cross_entropy as jcross_entropy
from repro.models.hgnn import prepare_data as jprepare_data
from repro.train import init_hgnn_train_state as jinit_state
from repro.train import make_hgnn_train_step as jmake_step
from repro_torch import checkpoint as tckpt
from repro_torch import optim as toptim
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.core import NABackend
from repro_torch.graphs import dataset_target, relation_semantic_graphs, synthetic_hetgraph
from repro_torch.graphs import synthetic_labels
from repro_torch.launch import hgnn_train
from repro_torch.models.hgnn import MODELS, prepare_data
from repro_torch.train import hgnn_loss_and_grads, make_hgnn_train_step
from repro_torch.tree import tree_leaves_with_path

TOL = dict(rtol=1e-4, atol=1e-5)
OPT = dict(lr=5e-3, weight_decay=0.0)
RGAT_WIDTH = dict(hidden=8, heads=2, layers=2)  # the launcher's R-GAT (layers=2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_leaves(tree):
    return {"/".join(str(p) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree):
    return {k: v.detach().numpy() for k, v in tree_leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def relation_data():
    """The relation graphs of small acm in both packages: (jax, port)."""
    graph = dict(scale=0.05, feat_scale=0.1, seed=0)
    target, ncls = dataset_target("acm")
    jg, tg = jsynthetic_hetgraph("acm", **graph), synthetic_hetgraph("acm", **graph)
    labels = synthetic_labels(tg, "acm")
    jdata = jprepare_data(jg, jrelation_graphs(jg), target, ncls, labels, block=16)
    tdata = prepare_data(tg, relation_semantic_graphs(tg), target, ncls, labels, block=16,
                         device="cpu")
    return jdata, tdata


def check_gradients(name, backend, width):
    """Loss and every parameter's gradient of model ``name`` on ``backend``
    against ``jax.grad`` on the JAX backend of the same path."""
    jdata, tdata = relation_data()
    jb = {NABackend.BLOCK: JNA.BLOCK, NABackend.MULTIGRAPH: JNA.MULTIGRAPH_INTERPRET,
          NABackend.SEGMENT: JNA.SEGMENT}[backend]
    jparams = JMODELS[name].init(jax.random.key(3), jdata, **width)

    def jloss(p):
        return jcross_entropy(JMODELS[name].forward(p, jdata, backend=jb), jdata.labels)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    n = tdata.labels.shape[0]
    loss, _, grads = hgnn_loss_and_grads(
        lambda p: MODELS[name].forward(p, tdata, backend=backend),
        params_from_numpy(_np(jparams), device="cpu"), tdata, torch.arange(n))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want, got = _jax_leaves(jg), _port_leaves(grads)
    assert list(got) == list(want)  # the same tree, leaves in the same order
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=k, **TOL)


@pytest.mark.parametrize("name,backend,width", [
    ("S-HGN", NABackend.MULTIGRAPH, dict(hidden=8, heads=2, layers=1, edge_dim=8)),
    ("R-GCN", NABackend.SEGMENT, dict(hidden=8, layers=2)),
], ids=lambda v: getattr(v, "value", v) if not isinstance(v, dict) else "")
def test_gradients_match_jax_grad(name, backend, width):
    check_gradients(name, backend, width)


PROBLEM = dict(scale=0.05, feat_scale=0.1, block=16, max_edges=20_000)


@pytest.fixture(scope="module")
def problem():
    _, jdata = jbuild_problem("acm", **PROBLEM)
    _, tdata = hgnn_train.build_problem("acm", device="cpu", **PROBLEM)
    jstate = jinit_state(JMODELS["R-GAT"], jax.random.key(0), jdata, joptim.AdamWConfig(**OPT),
                         **RGAT_WIDTH)
    return jdata, tdata, jstate


def test_five_adamw_steps_of_rgat_track_jax(problem):
    """The launcher's R-GAT step (``--backend kernel``: MULTIGRAPH per graph)."""
    jdata, tdata, jstate = problem
    jstep = jax.jit(jmake_step(
        lambda p: JMODELS["R-GAT"].forward(p, jdata, backend=JNA.MULTIGRAPH_INTERPRET), jdata,
        joptim.AdamWConfig(**OPT)))
    tstep = make_hgnn_train_step(
        lambda p: MODELS["R-GAT"].forward(p, tdata, backend=NABackend.MULTIGRAPH), tdata,
        toptim.AdamWConfig(**OPT))
    js = jstate
    ts = train_state_from_numpy(_np(jstate.params), _np(jstate.opt), np.asarray(jstate.step),
                                device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(5):
        idx = rng.permutation(tdata.labels.shape[0])[:48].astype(np.int32)
        js, jm = jstep(js, {"idx": jnp.asarray(idx)})
        ts, tm = tstep(ts, {"idx": torch.from_numpy(idx)})
        for k in ("loss", "acc", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    assert int(ts.step) == int(js.step) == 5
    want, got = _jax_leaves(js.params), _port_leaves(ts.params)
    assert list(got) == list(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-3, atol=1e-5, err_msg=k)


def test_rgat_checkpoints_cross_between_jax_and_the_port(problem, tmp_path):
    _, _, jstate = problem
    rng = np.random.default_rng(1)
    js = jax.tree_util.tree_map(  # a state with every leaf set: params, moments, count, step
        lambda a: a + (rng.standard_normal(a.shape).astype(a.dtype) if a.dtype.kind == "f" else 3),
        jstate)
    aux = {"data": {"step": 1, "seed": 0}}
    like = train_state_from_numpy(_np(jstate.params), _np(jstate.opt), 0, device="cpu")
    assert any("[0]" in k for k, _ in tree_leaves_with_path(like))  # lists in the tree

    jckpt.save_checkpoint(str(tmp_path / "jax"), 1, js, aux=aux)
    restored, got_aux = tckpt.restore_checkpoint(str(tmp_path / "jax"), 1, like)
    assert got_aux == aux
    assert isinstance(restored.params["layers"], list)
    want, got = _jax_leaves(js), _port_leaves(restored)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)

    tckpt.save_checkpoint(str(tmp_path / "port"), 1, restored, aux=aux)
    back, _ = jckpt.restore_checkpoint(str(tmp_path / "port"), 1, jstate)
    for k, w in _jax_leaves(back).items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    manifests = [json.loads((tmp_path / d / "step_1" / "manifest.json").read_text())
                 for d in ("jax", "port")]
    assert manifests[0] == manifests[1]


def test_launcher_trains_rgat_on_cpu(tmp_path, capsys):
    out = tmp_path / "run.json"
    hgnn_train.main(["--model", "R-GAT", "--device", "cpu", "--steps", "3", "--scale", "0.05",
                     "--max-edges", "20000", "--hidden", "8", "--heads", "2",
                     "--ckpt", str(tmp_path / "ck"), "--out", str(out)])
    assert "final loss" in capsys.readouterr().out
    run = json.loads(out.read_text())
    assert run["meta"]["model"] == "R-GAT" and run["meta"]["backend"] == "multigraph"
    hist = run["history"]
    assert hist[-1]["step"] == 2 and hist[-1]["loss"] < hist[0]["loss"]
    assert tckpt.latest_step(str(tmp_path / "ck")) == 3
