"""The topology side of the fused FP+NA kernels #3 and #4, on the CPU:

* the row-tile list of their projection phase names each (weight table,
  128-row tile) that a live unit reads exactly once, and no other (a
  property over random topologies: one or two tables, padding slots, an
  all-padding unit, B in {8, 16, 32});
* a topology held to another topology's operands raises (its fused index
  to another ``wsel`` or table count), and to the same topology in other
  tensors passes;
* the route rule, and that the card's cases cover both routes;
* on the card test's operands, ``SPLIT_ERROR_MAX`` passes phase P's three
  TF32 products and fails one (its numerics in plain PyTorch);
* the plain versions of #3 and #4 match the JAX package's interpret-mode
  Pallas kernel on every ``FUSED_CASES`` operand set (forward at 1e-5; the
  VJP at rtol 1e-4, atol 1e-5 in tests/test_torch_kernels_bwd.py);
* ``neighbor_aggregate_multi(..., topology=)`` built once per data set
  gives the same bits as building it in the call, forward and gradients,
  for HAN on FUSED_FP and MULTIGRAPH; HAN's one-lane plan keeps its unit
  tables, their topology and its fused index, and is rebuilt when the data
  set's graphs change.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core.fusion import (
    FusedFPInputs,
    NABackend,
    build_unit_tables,
    fused_fp_rows,
    neighbor_aggregate_multi,
    unit_topology,
)
from repro_torch.launch.hgnn_train import build_problem
from repro_torch.models.hgnn import HAN
from repro_torch.models.hgnn.han import han_forward
from repro_torch.kernels import seg_gat_agg_fused_fp_fwd
from repro_torch.kernels.topology import Topology
from test_torch_cuda import FUSED_CASES, FUSED_ROUTE_CASES, SPLIT_CASE, fused_case

ffp = importlib.import_module("repro_torch.kernels.seg_gat_agg_fused_fp")
k6 = importlib.import_module("repro_torch.kernels.fused_fp_coeff")
jfused = importlib.import_module("repro.kernels.seg_gat_agg_fused_fp")


def _topology(seed, *, B, tables, units, width, nblk):
    """Random units over ``nblk`` blocks with padding slots, unit 0 all
    padding; (col, gid, row, wsel) as int32 tensors."""
    rng = np.random.default_rng(seed)
    graphs = 3
    col = rng.integers(-1, nblk, (units, width)).astype(np.int32)
    col[0] = -1
    gid = rng.integers(0, graphs, units).astype(np.int32)
    row = rng.integers(0, nblk, units).astype(np.int32)
    wsel = rng.integers(0, tables, graphs).astype(np.int32)
    return [torch.from_numpy(a) for a in (col, gid, row, wsel)]


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2**32 - 1), st.sampled_from([8, 16, 32]), st.sampled_from([1, 2]),
       st.integers(1, 12), st.integers(1, 5), st.integers(1, 40))
def test_row_tiles_name_each_read_tile_once(seed, B, tables, units, width, nblk):
    col, gid, row, wsel = _topology(seed, B=B, tables=tables, units=units, width=width,
                                    nblk=nblk)
    n_pad = nblk * B
    per, R = ffp.ROW_TILE // B, -(-n_pad // ffp.ROW_TILE)
    want = set()
    for u in range(units):
        live = [int(c) for c in col[u] if c >= 0]
        if not live:  # a unit with no live slot reads nothing
            continue
        t = int(wsel[gid[u]])
        want.update((t, blk // per) for blk in live + [int(row[u])])
    got = ffp.row_tiles(col, gid, row, wsel, n_pad, B).tolist()
    assert got == sorted(got) and len(got) == len(set(got))  # each once, in order
    assert {(i // R, i % R) for i in got} == want
    assert all(0 <= i % R < R and 0 <= i // R < tables for i in got)


def test_fused_index_holds_the_row_tiles_and_the_backward_index():
    col, gid, row, wsel = _topology(1, B=16, tables=2, units=10, width=4, nblk=20)
    masks = torch.ones((*col.shape, 16, 16), dtype=torch.bool)
    topology = Topology(col, gid, row, masks, n_graphs=3, ns_pad=320, nd_pad=320)
    assert "pair_of" not in topology.fused_index(wsel, 2, backward=False)
    idx = topology.fused_index(wsel, 2)
    assert all(a is b for a, b in zip(idx["units"], topology.units))
    assert torch.equal(idx["tiles"], ffp.row_tiles(col, gid, row, wsel, 320, 16))
    bwd = ffp.bwd_index(col, gid, row, wsel, 3, 2, 20)
    assert idx["n_live"] == bwd["n_live"] == int((col >= 0).sum())
    assert torch.equal(idx["pair_of"], bwd["pair_of"])
    for key in ("table", "graph"):
        assert all(torch.equal(a, b) for a, b in zip(idx[key], bwd[key]))


def test_route_takes_the_tensor_cores_at_whole_column_tiles():
    """The tensor cores wherever their kernel takes H·Dh (a multiple of 8)."""
    assert ffp.route(8, 64) == "wgmma"        # HAN's width: C = 512
    assert ffp.route(2, 128) == "wgmma"
    assert ffp.route(2, 4) == "wgmma"         # the tests' tiny widths
    assert ffp.route(4, 16) == "wgmma"
    assert ffp.route(3, 3) == "cuda_cores"
    assert ffp.route(1, 12) == "cuda_cores"


def test_card_cases_cover_both_routes():
    routes = {ffp.route(*case()[8].shape[1:]) for case in FUSED_ROUTE_CASES.values()}
    assert routes == set(ffp.ROUTES)


def _fused_operands(name="T=2-B=16-subset"):
    return [torch.from_numpy(np.array(a)) for a in FUSED_CASES[name]()]


def _index(case):
    """The topology of ``case``'s units, its fused index built for its
    ``wsel`` and tables."""
    col, gid, row, wsel, masks, x, w = case[:7]
    topology = Topology(col, gid, row, masks, n_graphs=wsel.shape[0], ns_pad=x.shape[0],
                        nd_pad=x.shape[0])
    topology.fused_index(wsel, w.shape[0])
    return topology


def _other_topology(case, what):
    """The topology of ``case`` but for one thing: (topology, operands)."""
    case = list(case)
    col, gid, row, wsel, masks, x, w, b = case[:8]
    if what == "n_pad":  # one more block of rows
        case[5] = torch.cat([x, torch.zeros((masks.shape[-1], x.shape[1]))])
    elif what == "tables":
        case[6], case[7] = w[:1], b[:1]
        case[3] = torch.zeros_like(wsel)
        return _index([col, gid, row, case[3], masks, x, w, b]), case
    elif what == "col_index":
        col = col.clone()
        col[0, 0] = (col[0, 0] + 1) % (x.shape[0] // masks.shape[-1])
        case[0] = col
    elif what == "wsel":
        case[3] = 1 - wsel
    elif what == "in place":  # the topology's own graph_id, changed after it was built
        topology = _index(case)
        gid[0] = (gid[0] + 1) % 3
        return topology, case
    elif what == "units":
        case = [col[:-1], gid[:-1], row[:-1], wsel, masks[:-1], *case[5:]]
    return _index(_fused_operands()), case


@pytest.mark.parametrize("what", ["n_pad", "tables", "col_index", "wsel", "in place", "units"])
def test_an_index_of_another_topology_raises(what):
    """Phase A reads only the rows phase P wrote: a topology (or its fused
    index) held to another topology's operands must raise in both
    directions, not give other numbers."""
    topology, case = _other_topology(_fused_operands(), what)
    with pytest.raises(ValueError, match="was built for|changed in place"):
        seg_gat_agg_fused_fp_fwd(*case, topology=topology)
    out, lse = seg_gat_agg_fused_fp_fwd(*case)
    with pytest.raises(ValueError, match="was built for|changed in place"):
        ffp.seg_gat_agg_fused_fp_bwd(*case, out, lse, torch.cos(out), topology=topology)


def test_an_index_of_the_same_topology_in_other_tensors_passes():
    case = _fused_operands()
    topology = _index(case)
    same = [t.clone() for t in case]
    out, lse = seg_gat_agg_fused_fp_fwd(*same, topology=topology)
    assert all(torch.equal(a, b) for a, b in zip((out, lse), seg_gat_agg_fused_fp_fwd(*case)))
    ffp.seg_gat_agg_fused_fp_bwd(*same, out, lse, torch.cos(out), topology=topology)


def test_split_limit_separates_phase_p_three_products_from_one():
    """On the operands of tests/test_torch_cuda.py's card test of phase P's
    split error: its numerics in plain PyTorch (``tensor_core_emulation``
    on each table's listed rows, phase P's K slices) pass SPLIT_ERROR_MAX
    with three TF32 products, 10x under, and miss it with one, 10x over;
    unlisted rows of h are not read."""
    col, gid, row, wsel, masks, x, w, b, a_s = map(torch.from_numpy, fused_case(**SPLIT_CASE)[:9])
    n_pad, B, (H, Dh) = x.shape[0], masks.shape[-1], a_s.shape[1:]
    tiles = ffp.row_tiles(col, gid, row, wsel, n_pad, B)
    table, rows = ffp.tile_rows(tiles, n_pad)
    assert len(set(table.tolist())) == 2 and len(rows) < 2 * n_pad
    splits = k6.split_k(len(tiles) * ffp.ROW_TILE, x.shape[1], H * Dh)
    ones = torch.ones(H, Dh)
    errs = {}
    for split in (True, False):
        h = torch.full((w.shape[0], n_pad, H * Dh), torch.nan)
        for t in table.unique().tolist():
            r = rows[table == t]
            h[t, r] = k6.tensor_core_emulation(x[r], w[t], b[t], ones, ones, split=split,
                                               splits=splits)[0]
        errs[split] = ffp.projection_split_error(h, tiles, x, w, b)
    assert errs[True] * 10 <= k6.SPLIT_ERROR_MAX, errs
    assert errs[False] >= 10 * k6.SPLIT_ERROR_MAX, errs


@pytest.mark.parametrize("name", sorted(FUSED_CASES))
def test_fused_fp_plain_forward_matches_pallas_interpret(name):
    case = FUSED_CASES[name]()
    j_out, j_lse = jfused._fwd_call(*map(jnp.asarray, case), 0.2, True)
    t_out, t_lse = seg_gat_agg_fused_fp_fwd(*map(torch.from_numpy, case))
    U, B = case[0].shape[0], case[4].shape[-1]
    np.testing.assert_allclose(t_out.numpy().reshape(U * B, -1), np.asarray(j_out),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def han_problem():
    _, data = build_problem("acm", scale=0.05, feat_scale=0.05, block=8, max_edges=20_000,
                            device="cpu")
    params = HAN.init(torch.Generator().manual_seed(0), data, hidden=8, heads=2, att_dim=16)
    return data, params


@pytest.mark.parametrize("backend", [NABackend.FUSED_FP, NABackend.MULTIGRAPH])
def test_unit_tables_and_index_once_give_the_same_bits(han_problem, backend):
    """``topology=`` (the unit tables checked once) against building it in
    the call."""
    data, params = han_problem
    x = data.features[data.target_type]
    heads = params["a_src"].shape[1]
    leaves = {k: params[k].clone().requires_grad_() for k in ("w_fp", "b_fp", "a_src", "a_dst")}

    def na(**kw):
        if backend is NABackend.FUSED_FP:
            fp = FusedFPInputs.shared(x, leaves["w_fp"], leaves["b_fp"], leaves["a_src"],
                                      leaves["a_dst"])
            return neighbor_aggregate_multi(data.graphs, None, None, None, backend=backend,
                                            fp=fp, **kw)
        hh = (x @ leaves["w_fp"] + leaves["b_fp"]).reshape(x.shape[0], heads, -1)
        th_s = torch.einsum("nhd,ghd->gnh", hh, leaves["a_src"])
        th_d = torch.einsum("nhd,ghd->gnh", hh, leaves["a_dst"])
        return neighbor_aggregate_multi(data.graphs, th_s, th_d, hh, backend=backend, **kw)

    topology = unit_topology(data.graphs)
    runs = []
    for kw in ({}, dict(topology=topology), dict(topology=topology)):
        z = na(**kw)
        grads = torch.autograd.grad(torch.sin(z).sum(), list(leaves.values()))
        runs.append((z.detach(), *grads))
    assert all(torch.equal(a, b) for run in runs[1:] for a, b in zip(runs[0], run))


def _tables(units):
    return units.col_index, units.graph_id, units.dst_row, units.masks


def test_data_rebuilds_its_topology_when_its_graphs_change(han_problem):
    data, _ = han_problem
    plan = data.plan()
    graphs = data.graphs
    try:
        data.graphs = graphs[:1]
        sub = data.plan()
        assert sub is not plan and sub.num_graphs == 1
        assert all(torch.equal(a, b) for a, b in zip(_tables(sub.units()),
                                                      build_unit_tables(graphs[:1])))
    finally:
        data.graphs = graphs
    assert all(torch.equal(a, b) for a, b in zip(_tables(data.plan().units()),
                                                  build_unit_tables(graphs)))


def test_han_builds_the_topology_once(han_problem):
    data, params = han_problem
    logits = han_forward(params, data, backend=NABackend.FUSED_FP)
    plan = data.plan()
    units = plan.units()
    assert data.plan() is plan and plan.units() is units
    (topology,) = units._topologies.values()
    wsel = torch.zeros(len(data.graphs), dtype=torch.int32)
    index = topology.fused_index(wsel, 1)
    assert torch.equal(han_forward(params, data, backend=NABackend.FUSED_FP), logits)
    assert list(units._topologies.values()) == [topology]
    assert topology.fused_index(wsel, 1) is index
    assert torch.equal(index["tiles"], ffp.row_tiles(
        *_tables(units)[:3], wsel, fused_fp_rows(data.graphs), data.graphs[0].block))
