"""Port parity of multi-lane execution (paper §4.2): ``core.multilane`` and
``han_forward_multilane`` against ``repro.core.multilane`` and
``repro.models.hgnn.han``, on the CPU.

* ``build_multilane_plan``'s tables equal the reference's byte for byte
  (synthetic DBLP at scale 0.05, B = 16, lanes 1/2/4/8, balanced and naive:
  the reference's ``dblp_setup``, tests/test_multilane.py);
* ``multilane_na`` on ``reference`` and ``kernel`` agrees with JAX's
  ``multilane_na(backend="reference")`` at 1e-5, and with the interpret-mode
  Pallas kernel (``kernel_interpret``) on a small case;
* the port's forward is bitwise the same for every lane count and plan and
  equals its MULTIGRAPH output (each unit is computed alone; the plain
  version's chunked products give the same bits at every unit count here);
* dead units (the lane padding) change no bit of the forward or of #2's
  gradients, which is why only valid units reach the kernels;
* ``fused_fp`` agrees with ``kernel`` at 1e-5;
* HAN through ``han_forward_multilane``: logits against JAX at 1e-5, loss
  and gradients against ``jax.grad`` at the port's HAN parity tolerances
  (rtol 1e-4, atol 1e-5), on the reference's ``acm_han`` shape;
* degenerate graphs (an empty graph, a single edge) give exact zeros and
  finite gradients, as tests/test_multilane.py has them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batch_semantic_graph as jbatch_semantic_graph
from repro.core.multilane import build_multilane_plan as jbuild_plan
from repro.core.multilane import multilane_na as jmultilane_na
from repro.graphs.hetgraph import SemanticGraph as JSemanticGraph
from repro.launch.hgnn_train import build_problem as jbuild_problem
from repro.models.hgnn import han_forward_multilane as jhan_forward_multilane
from repro.models.hgnn.han import init_han as jinit_han
from repro_torch.convert import params_from_numpy
from repro_torch.core import (
    NABackend,
    batch_semantic_graph,
    build_multilane_plan,
    multilane_na,
    neighbor_aggregate_multi,
    resolve_multilane_backend,
)
from repro_torch.core.fusion import FusedFPInputs
from repro_torch.graphs import build_semantic_graphs, dataset_metapaths, synthetic_hetgraph
from repro_torch.graphs.hetgraph import SemanticGraph
from repro_torch.kernels.seg_gat_agg_multigraph import seg_gat_agg_multigraph
from repro_torch.launch import hgnn_train
from repro_torch.models.hgnn import cross_entropy, han_forward, han_forward_multilane

FWD = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-5)  # the port's HAN gradient parity (tests/test_torch_train.py)
B, H, DH = 16, 2, 8
TABLES = ("col_index", "masks", "graph_id", "dst_row", "valid")


@pytest.fixture(scope="module")
def dblp():
    """The reference's ``dblp_setup``: synthetic DBLP's three metapath
    graphs at B = 16 in both packages, and random θ/h from a numpy seed."""
    from repro.graphs import build_semantic_graphs as jbuild_sgs
    from repro.graphs import synthetic_hetgraph as jsynthetic

    rng = np.random.default_rng(0)
    jsgs = jbuild_sgs(jsynthetic("dblp", scale=0.05, feat_scale=0.1), dataset_metapaths("dblp"))
    sgs = build_semantic_graphs(synthetic_hetgraph("dblp", scale=0.05, feat_scale=0.1),
                                dataset_metapaths("dblp"))
    jb = [jbatch_semantic_graph(s, block=B) for s in jsgs]
    tb = [batch_semantic_graph(s, block=B) for s in sgs]
    G, ns = len(tb), tb[0].num_src
    ns_pad, nd_pad = -(-ns // B) * B, tb[0].num_dst_pad
    hs = np.zeros((ns_pad, H, DH), np.float32)
    hs[:ns] = rng.standard_normal((ns, H, DH))
    ths = np.zeros((G, ns_pad, H), np.float32)
    thd = np.zeros((G, nd_pad, H), np.float32)
    for i in range(G):
        ths[i, :ns] = rng.standard_normal((ns, H))
        thd[i, :ns] = rng.standard_normal((ns, H))
    return jb, tb, (ths, thd, hs)


def _torch(ops):
    return [torch.from_numpy(a) for a in ops]


@pytest.mark.parametrize("balanced", [True, False], ids=["balanced", "naive"])
@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_plan_tables_equal_the_reference(dblp, lanes, balanced):
    jb, tb, _ = dblp
    jp = jbuild_plan(jb, lanes, balanced=balanced)
    tp = build_multilane_plan(tb, lanes, balanced=balanced)
    for f in TABLES:
        a, b = getattr(tp, f), np.asarray(getattr(jp, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert (tp.block, tp.num_graphs, tp.n_dst_blocks, tp.num_lanes) == (
        jp.block, jp.num_graphs, jp.n_dst_blocks, jp.num_lanes)
    for f in ("unit_graph", "unit_row", "unit_cost", "unit_lane", "lane_load"):
        np.testing.assert_array_equal(getattr(tp.lane_plan, f), getattr(jp.lane_plan, f))


_JAX_RESULTS: dict = {}  # one JAX run per (case, lanes), shared by the backends' cases


def _jax_once(key, fn):
    if key not in _JAX_RESULTS:
        _JAX_RESULTS[key] = fn()
    return _JAX_RESULTS[key]


def _jax_na(jplan, ops, **kw):
    return np.asarray(jax.jit(lambda *o: jmultilane_na(jplan, *o, **kw))(*map(jnp.asarray, ops)))


@pytest.mark.parametrize("backend", ["reference", "kernel"])
@pytest.mark.parametrize("lanes", [1, 4])
def test_multilane_na_matches_jax(dblp, lanes, backend):
    jb, tb, ops = dblp
    want = _jax_once(("dblp", lanes), lambda: _jax_na(jbuild_plan(jb, lanes), ops))
    got = multilane_na(build_multilane_plan(tb, lanes), *_torch(ops), backend=backend)
    np.testing.assert_allclose(got.numpy(), want, **FWD)


def test_forward_is_bitwise_across_plans_and_equals_multigraph(dblp):
    _, tb, ops = dblp
    ths, thd, hs = _torch(ops)
    base = neighbor_aggregate_multi(tb, ths, thd, hs, backend=NABackend.MULTIGRAPH)
    nd = tb[0].num_dst
    for lanes in (1, 2, 4, 8):
        for balanced in (True, False):
            plan = build_multilane_plan(tb, lanes, balanced=balanced)
            for backend in ("reference", "kernel", "kernel_interpret"):
                z = multilane_na(plan, ths, thd, hs, backend=backend)
                assert torch.equal(z[:, :nd], base), (lanes, balanced, backend)
                assert not z[:, nd:].any()


def test_dead_units_change_no_bit(dblp):
    """The plan's lane padding (graph 0, row 0, no live slot) through #1/#2's
    plain versions: the valid units' rows and every gradient are the same
    bits with the dead units in the tables as without them."""
    _, tb, ops = dblp
    plan = build_multilane_plan(tb, 8)
    valid = torch.from_numpy(plan.valid.reshape(-1))
    assert not valid.all()  # the plan has dead units
    full = tuple(torch.from_numpy(a.reshape(-1, *a.shape[2:])) for a in
                 (plan.col_index, plan.graph_id, plan.dst_row, plan.masks))
    lu = plan.units()
    g_rows = torch.randn(int(valid.sum()) * B, H, DH, generator=torch.Generator().manual_seed(3))
    results = []
    for tables, keep in ((full, valid), ((lu.col_index, lu.graph_id, lu.dst_row, lu.masks), None)):
        ths, thd, hs = (t.requires_grad_() for t in _torch(ops))
        out = seg_gat_agg_multigraph(*tables, ths, thd, hs).reshape(-1, B, H, DH)
        if keep is not None:
            out = out[keep]
        out = out.reshape(-1, H, DH)
        results.append((out.detach(), torch.autograd.grad((out * g_rows).sum(), (ths, thd, hs))))
    (out_a, grads_a), (out_b, grads_b) = results
    assert torch.equal(out_a, out_b)
    for a, b in zip(grads_a, grads_b):
        assert torch.equal(a, b)


def test_plan_keeps_its_unit_tables_and_indexes(dblp):
    _, tb, ops = dblp
    plan = build_multilane_plan(tb, 4)
    ths, thd, hs = (t.requires_grad_() for t in _torch(ops))
    for _ in range(2):
        z = multilane_na(plan, ths, thd, hs, backend="kernel")
        torch.autograd.grad(z.square().sum(), (ths, thd, hs))
    lu = plan.units()
    key = (3, ths.shape[1], thd.shape[1])
    assert plan.units() is lu and list(lu._topologies) == [key]
    assert all(a is b for a, b in zip(lu._topologies[key].units,
                                      (lu.col_index, lu.graph_id, lu.dst_row, lu.masks)))
    assert lu.count == 3 * plan.n_dst_blocks == int(plan.valid.sum())
    assert torch.equal(torch.sort(lu.take).values, torch.arange(lu.count))
    assert plan.nbytes() == sum(getattr(plan, f).nbytes for f in TABLES)
    assert all(isinstance(getattr(plan, f), np.ndarray) for f in TABLES)  # on the host


def test_balanced_beats_naive_on_skewed_workload(dblp):
    _, tb, _ = dblp
    plan_b = build_multilane_plan(tb, 4, balanced=True)
    plan_n = build_multilane_plan(tb, 4, balanced=False)
    assert plan_b.lane_plan.imbalance() <= plan_n.lane_plan.imbalance()
    assert plan_b.lane_plan.lane_load.max() < plan_n.lane_plan.lane_load.max()


def test_backend_names():
    assert resolve_multilane_backend("kernel_interpret") == "kernel"
    assert resolve_multilane_backend("fused_fp_interpret") == "fused_fp"
    assert resolve_multilane_backend("reference") == "reference"
    with pytest.raises(ValueError, match="backend"):
        multilane_na(None, None, None, None, backend="nope")


# -- a small case against the interpret-mode Pallas kernel; degenerate graphs --


def _graphs(pkg_sg, n: int):
    def sg(name, src, dst):
        return pkg_sg(name=name, src_type="v", dst_type="v",
                      src_ids=np.asarray(src, np.int32), dst_ids=np.asarray(dst, np.int32),
                      num_src=n, num_dst=n, path_types=("v", "v"))

    rng = np.random.default_rng(5)
    pairs = sorted(set(rng.integers(0, n * n, size=40).tolist()))
    return [sg("empty", [], []), sg("single", [n - 1], [0]),
            sg("rand", [p // n for p in pairs], [p % n for p in pairs])]


@pytest.fixture(scope="module")
def small():
    n, block = 24, 8
    rng = np.random.default_rng(11)
    ops = (rng.standard_normal((3, n, 2)).astype(np.float32),
           rng.standard_normal((3, n, 2)).astype(np.float32),
           rng.standard_normal((n, 2, 4)).astype(np.float32))
    return ([jbatch_semantic_graph(s, block=block) for s in _graphs(JSemanticGraph, n)],
            [batch_semantic_graph(s, block=block) for s in _graphs(SemanticGraph, n)], ops)


def test_kernel_backend_matches_pallas_interpret(small):
    jb, tb, ops = small
    want = _jax_na(jbuild_plan(jb, 2), ops, backend="kernel_interpret")
    got = multilane_na(build_multilane_plan(tb, 2), *_torch(ops), backend="kernel")
    np.testing.assert_allclose(got.numpy(), want, **FWD)


@pytest.mark.parametrize("lanes", [1, 3])
def test_degenerate_graphs(small, lanes):
    jb, tb, ops = small
    plan = build_multilane_plan(tb, lanes)
    jplan = jbuild_plan(jb, lanes)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda a, b, c: jnp.sum(jmultilane_na(jplan, a, b, c) ** 2), argnums=(0, 1, 2)))(
        *map(jnp.asarray, ops))
    want = _jax_na(jplan, ops)
    for backend in ("reference", "kernel"):
        leaves = [t.requires_grad_() for t in _torch(ops)]
        z = multilane_na(plan, *leaves, backend=backend)
        assert torch.isfinite(z).all() and not z[0].any()  # empty graph: exact zeros
        np.testing.assert_allclose(z.detach().numpy(), want, **FWD)
        grads = torch.autograd.grad(z.square().sum(), leaves)
        assert all(torch.isfinite(g).all() for g in grads)
        assert not grads[0][0].any() and not grads[1][0].any()  # empty graph's θ
        for g, w in zip(grads, jgrads):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# -- HAN through han_forward_multilane -------------------------------------------

PROBLEM = dict(scale=0.05, feat_scale=0.1, block=16, max_edges=20_000)  # the reference's acm_han
WIDTH = dict(hidden=8, heads=2, att_dim=16)


@pytest.fixture(scope="module")
def acm_han():
    _, jdata = jbuild_problem("acm", **PROBLEM)
    _, tdata = hgnn_train.build_problem("acm", device="cpu", **PROBLEM)
    jparams = jax.tree_util.tree_map(np.asarray, jinit_han(jax.random.key(0), jdata, **WIDTH))
    return jdata, tdata, jparams


def _jloss_and_grads(jdata, jparams, lanes):
    plan = jbuild_plan(jdata.graphs, lanes)

    def f(p):
        logits = jhan_forward_multilane(p, jdata, plan, backend="reference")
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, jdata.labels[:, None], 1).mean(), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, jparams))
    return float(loss), np.asarray(logits), jax.tree_util.tree_map(np.asarray, grads)


def _loss_and_grads(tdata, jparams, fwd):
    params = {k: v.requires_grad_() for k, v in params_from_numpy(jparams, device="cpu").items()}
    logits = fwd(params)
    loss = cross_entropy(logits, tdata.labels)
    names = sorted(params)
    return loss.detach(), logits.detach(), dict(zip(names, torch.autograd.grad(
        loss, [params[k] for k in names])))


@pytest.mark.parametrize("backend", ["reference", "kernel"])
@pytest.mark.parametrize("lanes", [1, 4])
def test_han_multilane_matches_jax(acm_han, lanes, backend):
    jdata, tdata, jparams = acm_han
    jloss, jlogits, jgrads = _jax_once(("han", lanes),
                                       lambda: _jloss_and_grads(jdata, jparams, lanes))
    plan = build_multilane_plan(tdata.graphs, lanes)
    loss, logits, grads = _loss_and_grads(
        tdata, jparams, lambda p: han_forward_multilane(p, tdata, plan, backend=backend))
    np.testing.assert_allclose(logits.numpy(), jlogits, **FWD)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[k], err_msg=k, **TOL)


def test_han_multilane_logits_and_loss_equal_multigraph_bitwise(acm_han):
    """The loss is the same bits at every lane count and on MULTIGRAPH; the
    gradients agree to float32 tolerance (the plan orders #2's sums)."""
    _, tdata, jparams = acm_han
    base_loss, base_logits, base_grads = _loss_and_grads(
        tdata, jparams, lambda p: han_forward(p, tdata, backend=NABackend.MULTIGRAPH))
    for lanes in (1, 2, 4):
        plan = build_multilane_plan(tdata.graphs, lanes)
        loss, logits, grads = _loss_and_grads(
            tdata, jparams, lambda p: han_forward_multilane(p, tdata, plan, backend="kernel"))
        assert torch.equal(logits, base_logits) and torch.equal(loss, base_loss), lanes
        for k, g in grads.items():
            torch.testing.assert_close(g, base_grads[k], rtol=0, atol=1e-8, msg=k)


def test_fused_fp_matches_kernel(acm_han):
    _, tdata, jparams = acm_han
    plan = build_multilane_plan(tdata.graphs, 4)
    runs = {backend: _loss_and_grads(
        tdata, jparams, lambda p, b=backend: han_forward_multilane(p, tdata, plan, backend=b))
        for backend in ("kernel", "fused_fp")}
    (_, lk, gk), (_, lf, gf) = runs["kernel"], runs["fused_fp"]
    np.testing.assert_allclose(lf.numpy(), lk.numpy(), **FWD)
    for k in gk:
        np.testing.assert_allclose(gf[k].numpy(), gk[k].numpy(), err_msg=k, **TOL)


def test_fused_fp_needs_its_inputs(dblp):
    _, tb, _ = dblp
    plan = build_multilane_plan(tb, 2)
    with pytest.raises(ValueError, match="FusedFPInputs"):
        multilane_na(plan, None, None, None, backend="fused_fp")
    x = torch.zeros(tb[0].num_dst, 4)
    fp = FusedFPInputs.shared(x, torch.zeros(4, H * DH), torch.zeros(H * DH),
                              torch.zeros(3, H, DH), torch.zeros(3, H, DH))
    z = multilane_na(plan, None, None, None, backend="fused_fp_interpret", fp=fp)
    assert z.shape == (3, plan.n_dst_blocks * B, H, DH)
