"""Port parity of the ``dist`` sharding rules and the HGNN axes tables.

The same logical-axes tuples go through ``repro.dist.sharding`` and
``repro_torch.dist.sharding``:

* ``Rules.spec`` entry by entry (the port's plain tuple against the
  reference's ``PartitionSpec``) for all four postures under every
  combination of ``multi_pod``, ``fsdp``, ``seq_shard`` and
  ``batch_shard``, on fixed cases (compound axes, a duplicate mesh axis
  dropped, unknown axes) and on hypothesis-drawn tuples of axis names;
* ``mesh_axes`` and ``lane_axes``; the ``use_rules`` stack (nesting, and
  restore on an exception); ``shard`` returning its input;
* ``hgnn_param_axes``, ``hgnn_train_state_axes`` and ``opt_state_axes``
  against the reference's trees for HAN and R-GAT;
* ``param_shardings`` on a (1, 1) mesh (one gloo rank): each leaf's
  placements against the reference's ``NamedSharding.spec`` on
  ``make_lane_mesh(1, 1)``, and ``local_slice``/``gather_leaf`` leaving a
  leaf whole on it.
"""
import datetime
import itertools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec

import repro.dist.sharding as jsh
import repro.optim as joptim
from repro.launch.hgnn_train import build_problem as jbuild_problem
from repro.launch.mesh import make_lane_mesh as jmake_lane_mesh
from repro.models.hgnn import MODELS as JMODELS
from repro.train import init_hgnn_train_state as jinit_state
from repro.train.hgnn import hgnn_param_axes as jparam_axes
from repro.train.hgnn import hgnn_train_state_axes as jstate_axes
from repro_torch import optim as toptim
from repro_torch.convert import params_from_numpy
from repro_torch.dist import sharding as tsh
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import TrainState, hgnn_param_axes, hgnn_train_state_axes

POSTURES = ("tp", "sp", "serve2d", "lanes")
FLAGS = ("multi_pod", "fsdp", "seq_shard", "batch_shard")
RULE_KW = [dict(zip(FLAGS, bits), parallelism=p)
           for p in POSTURES for bits in itertools.product((False, True), repeat=4)]
NAMES = sorted({k for kw in RULE_KW for k in jsh.make_rules(**kw).table}) + ["unknown_axis"]
CASES = [
    ("act_batch", None, "act_vocab"),
    ("embed", "heads"),
    ("heads", "mlp"),                 # one mesh axis twice: the second drops
    ("act_batch", "act_seq", "act_qseq"),
    ("lane", "act_lane", "act_feat"),
    ("embed", "embed"),
    ("no_such_axis", "mlp", None),
    (),
]
PROBLEM = dict(scale=0.05, feat_scale=0.1, block=16, max_edges=20_000)
INIT_KW = {"HAN": dict(hidden=8, heads=2, att_dim=16), "R-GAT": dict(hidden=8, heads=2, layers=2)}


def _kw_id(kw):
    return kw["parallelism"] + "".join(f"-{f}" for f in FLAGS if kw[f])


@pytest.mark.parametrize("kw", RULE_KW, ids=_kw_id)
def test_rules_spec_matches_the_reference(kw):
    ref, port = jsh.make_rules(**kw), tsh.make_rules(**kw)
    assert port.name == ref.name and port.table == ref.table
    for axes in CASES + [(n,) for n in NAMES]:
        assert PartitionSpec(*port.spec(axes)) == ref.spec(axes), axes
        assert port.spec(axes) == tuple(ref.spec(axes)), axes
    for n in NAMES:
        assert port.mesh_axes(n) == ref.mesh_axes(n), n


@settings(max_examples=200, deadline=None)
@given(axes=st.lists(st.sampled_from(NAMES + [None]), max_size=6),
       kw=st.sampled_from(RULE_KW))
def test_rules_spec_matches_the_reference_on_drawn_axes(axes, kw):
    axes = tuple(axes)
    assert tsh.make_rules(**kw).spec(axes) == tuple(jsh.make_rules(**kw).spec(axes))


def test_unknown_parallelism_raises_in_both():
    with pytest.raises(ValueError, match="unknown parallelism"):
        jsh.make_rules(parallelism="pp")
    with pytest.raises(ValueError, match="unknown parallelism"):
        tsh.make_rules(parallelism="pp")


def test_lane_axes():
    for multi_pod in (False, True):
        kw = dict(parallelism="lanes", multi_pod=multi_pod)
        assert tsh.lane_axes(tsh.make_rules(**kw)) == jsh.lane_axes(jsh.make_rules(**kw))
    assert tsh.lane_axes(tsh.make_rules(parallelism="lanes", multi_pod=True)) == ("pod", "lane")
    with pytest.raises(ValueError, match="lane axis"):
        tsh.lane_axes(tsh.make_rules())


def test_use_rules_nests_and_restores_on_exception():
    outer, inner = tsh.make_rules(), tsh.make_rules(parallelism="lanes")
    assert tsh.active_rules() is None
    with tsh.use_rules(outer):
        assert tsh.active_rules() is outer
        with pytest.raises(RuntimeError, match="boom"):
            with tsh.use_rules(inner):
                assert tsh.active_rules() is inner
                raise RuntimeError("boom")
        assert tsh.active_rules() is outer
    assert tsh.active_rules() is None


def test_shard_returns_its_input():
    x = torch.ones(4, 4)
    assert tsh.shard(x, "act_batch", None) is x
    with tsh.use_rules(tsh.make_rules()):
        assert tsh.shard(x, "act_batch", "act_mlp") is x


@pytest.fixture(scope="module")
def jproblem():
    return jbuild_problem("acm", **PROBLEM)[1]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("model", sorted(INIT_KW))
def test_hgnn_axes_tables_match_the_reference(jproblem, model):
    cfg = dict(lr=5e-3, weight_decay=0.0)
    jstate = jinit_state(JMODELS[model], jax.random.key(0), jproblem, joptim.AdamWConfig(**cfg),
                         **INIT_KW[model])
    params = params_from_numpy(_np(jstate.params), device="cpu")
    assert hgnn_param_axes(params) == jparam_axes(jstate.params)
    ref = jstate_axes(jstate, joptim.AdamWConfig(**cfg))
    opt = toptim.AdamWConfig(**cfg)
    port = hgnn_train_state_axes(
        TrainState(params=params, opt=toptim.init_opt_state(params, opt), step=torch.zeros(())),
        opt)
    assert port.params == ref.params and port.step == ref.step == ()
    assert port.opt == ref.opt
    pax = hgnn_param_axes(params)
    assert toptim.opt_state_axes(pax, opt) == joptim.opt_state_axes(pax, joptim.AdamWConfig(**cfg))
    if model == "HAN":
        assert pax["w_fp"] == ("embed", "mlp") and pax["q"] == (None,)


@pytest.fixture(scope="module")
def one_rank_mesh(tmp_path_factory):
    store = tmp_path_factory.mktemp("gloo1") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield make_mesh((1, 1), ("lane", "model"), device_type="cpu")
    finally:
        dist.destroy_process_group()


def _spec_of(placements, dim_names, ndim):
    """The spec a leaf's placements say: entry i names the mesh dims that Shard(i)."""
    entries = [tuple(n for n, p in zip(dim_names, placements)
                     if isinstance(p, tsh.Shard) and p.dim == i) for i in range(ndim)]
    return tuple(None if not e else e[0] if len(e) == 1 else e for e in entries)


def test_param_shardings_match_the_reference_on_a_one_rank_mesh(jproblem, one_rank_mesh):
    cfg = dict(lr=5e-3, weight_decay=0.0)
    jstate = jinit_state(JMODELS["HAN"], jax.random.key(0), jproblem, joptim.AdamWConfig(**cfg),
                         **INIT_KW["HAN"])
    params = params_from_numpy(_np(jstate.params), device="cpu")
    opt = toptim.AdamWConfig(**cfg)
    state = TrainState(params=params, opt=toptim.init_opt_state(params, opt),
                       step=torch.zeros((), dtype=torch.int32))
    axes = hgnn_train_state_axes(state, opt)
    port = tsh.param_shardings(one_rank_mesh, tsh.make_rules(parallelism="lanes"), axes)
    ref = jsh.param_shardings(jmake_lane_mesh(1, 1), jsh.make_rules(parallelism="lanes"),
                              jstate_axes(jstate, joptim.AdamWConfig(**cfg)))
    ref_leaves = jax.tree_util.tree_leaves(ref)
    port_leaves = tsh.placement_leaves(port)
    assert len(port_leaves) == len(ref_leaves) == len(jax.tree_util.tree_leaves(jstate))
    for (pl, leaf), r in zip(zip(port_leaves, jax.tree_util.tree_leaves(jstate)), ref_leaves):
        assert len(pl) == 2
        spec = _spec_of(pl, one_rank_mesh.mesh_dim_names, np.ndim(leaf))
        assert spec == tuple(r.spec) + (None,) * (np.ndim(leaf) - len(r.spec))
    assert port.params["w_fp"] == (tsh.Replicate(), tsh.Shard(1))
    assert port.opt["m"]["a_src"] == (tsh.Replicate(), tsh.Shard(1))
    # one rank a mesh dimension: every piece is the whole leaf
    for name, x in params.items():
        pl = port.params[name]
        assert tsh.local_slice(x, pl, one_rank_mesh) is x
        assert tsh.gather_leaf(x, pl, one_rank_mesh) is x
