"""Kernels #3 and #4 (FUSED_FP) at B = 64 and 128: the topology re-blocked
to B' = 32 on the host (``seg_gat_agg_fused_fp.reblock``), which the .cu
files take.

* the re-blocked layout: sub-unit (u, i) at dst row ``n·row + i``, its
  slots the non-empty 32 × 32 sub-masks at ``n·col + k`` in (w, k) order,
  padded with -1, at least one slot;
* the plain fused version on the re-blocked topology against the same
  version on the B-unit topology, out and lse within 1e-5, and its VJP;
* against the reference's interpret-mode ``seg_gat_agg_fused_fp`` at B = 64,
  forward and VJP at rtol 1e-4, atol 1e-5;
* the topology's fused index keeping the re-blocked units and their index
  (the topology held to the masks too), and HAN's FUSED_FP at B = 64 over
  the plan's topology against MULTIGRAPH.

The card's counterparts are in tests/test_torch_cuda.py."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import NABackend
from repro_torch.launch import hgnn_train
from repro_torch.kernels.topology import Topology
from repro_torch.models.hgnn import han_forward, init_han

from test_torch_cuda import one_thread, reblock_case  # noqa: F401 (one_thread: a fixture)

ff = importlib.import_module("repro_torch.kernels.seg_gat_agg_fused_fp")
jfused = importlib.import_module("repro.kernels.seg_gat_agg_fused_fp")

pytestmark = pytest.mark.usefixtures("one_thread")  # the plain versions at B = 64 and 128
TOL = dict(rtol=1e-4, atol=1e-5)
NAMES = ("x", "w", "b", "a_src", "a_dst", "edge_bias")


def _case(B, **kw):
    return [torch.from_numpy(np.array(a)) for a in reblock_case(B, **kw)]


@pytest.mark.parametrize("B", [64, 128])
def test_reblock_layout(B):
    col, gid, row, wsel, masks = _case(B, density=0.02)[:5]
    U, W = col.shape
    n = B // 32
    col2, gid2, row2, masks2 = ff.reblock(col, gid, row, masks)
    assert col2.shape[0] == gid2.shape[0] == row2.shape[0] == masks2.shape[0] == U * n
    assert masks2.shape[-2:] == (32, 32) and col2.shape[1] >= 1
    assert col2.dtype == gid2.dtype == row2.dtype == torch.int32
    for u in range(U):
        for i in range(n):
            s = u * n + i
            assert gid2[s] == gid[u] and row2[s] == n * row[u] + i
            want = [(n * int(col[u, w]) + k, masks[u, w, 32 * i:32 * i + 32, 32 * k:32 * k + 32])
                    for w in range(W) if col[u, w] >= 0 for k in range(n)
                    if masks[u, w, 32 * i:32 * i + 32, 32 * k:32 * k + 32].any()]
            live = int((col2[s] >= 0).sum())
            assert live == len(want) and (col2[s, live:] == -1).all()
            assert not masks2[s, live:].any()
            for j, (c, m) in enumerate(want):
                assert col2[s, j] == c and torch.equal(masks2[s, j], m)
    assert (col2[2 * n:3 * n] == -1).all()  # the padding unit's sub-units read nothing


@pytest.mark.parametrize("density", [0.6, 0.02])
@pytest.mark.parametrize("B", [64, 128])
def test_reblocked_plain_matches_the_block_topology(B, density):
    case = _case(B, density=density)
    out, lse = ff.seg_gat_agg_fused_fp_plain(*case)
    sub = ff.reblock(*case[:3], case[4])
    out2, lse2 = ff.seg_gat_agg_fused_fp_plain(*sub[:3], case[3], sub[3], *case[5:])
    torch.testing.assert_close(out2, out, rtol=0, atol=1e-5)
    torch.testing.assert_close(lse2, lse, rtol=0, atol=1e-5)
    g_out = torch.cos(out)
    want = ff.seg_gat_agg_fused_fp_bwd_plain(*case, out, lse, g_out)
    got = ff.seg_gat_agg_fused_fp_bwd_plain(*sub[:3], case[3], sub[3], *case[5:], out2, lse2,
                                            g_out)
    for nm, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, w, msg=nm, **TOL)


def test_reblocked_plain_matches_the_reference_interpret_kernel_at_b64():
    case = _case(64)
    arrays = [jnp.asarray(t.numpy()) for t in case]
    fixed = arrays[:5]

    def loss(*diff):
        return jnp.sin(jfused.seg_gat_agg_fused_fp(*fixed, *diff, interpret=True)).sum()

    want_out = np.asarray(jfused.seg_gat_agg_fused_fp(*arrays, interpret=True))
    want = jax.grad(loss, argnums=tuple(range(6)))(*arrays[5:])
    sub = ff.reblock(*case[:3], case[4])
    leaves = [t.clone().requires_grad_() for t in case[5:]]
    out = ff.seg_gat_agg_fused_fp(*sub[:3], case[3], sub[3], *leaves)
    np.testing.assert_allclose(out.detach().numpy().reshape(want_out.shape), want_out, **TOL)
    got = torch.autograd.grad(torch.sin(out).sum(), leaves)
    for nm, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=nm, **TOL)


def test_fused_index_keeps_the_reblocked_topology_and_checks_the_masks():
    col, gid, row, wsel, masks = _case(128, density=0.02)[:5]
    n_pad, G = 3 * 128, wsel.shape[0]
    with pytest.raises(ValueError, match="one table"):  # #3/#4 read one table of rows
        Topology(col, gid, row, masks, n_graphs=G, ns_pad=n_pad + 128,
                 nd_pad=n_pad).fused_index(wsel, 2)
    topology = Topology(col, gid, row, masks, n_graphs=G, ns_pad=n_pad, nd_pad=n_pad)
    index = topology.fused_index(wsel, 2)
    for got, want in zip(index["units"], ff.reblock(col, gid, row, masks)):
        assert torch.equal(got, want)
    assert "pair_of" in index and index["units"][3].shape[-1] == 32
    topology.holds(col, gid, row, masks.clone(), n_graphs=G, ns_pad=n_pad, nd_pad=n_pad)
    other = masks.clone()
    other[0, 0, 0, 0] = ~other[0, 0, 0, 0]
    with pytest.raises(ValueError, match="another masks"):
        topology.holds(col, gid, row, other, n_graphs=G, ns_pad=n_pad, nd_pad=n_pad)


def test_han_fused_fp_at_b64_matches_multigraph():
    _, data = hgnn_train.build_problem("acm", device="cpu", scale=0.05, feat_scale=0.1,
                                       block=64, max_edges=20_000)
    params = init_han(torch.Generator().manual_seed(0), data, hidden=8, heads=2, att_dim=16)
    with torch.no_grad():
        fused = han_forward(params, data, backend=NABackend.FUSED_FP)
        multi = han_forward(params, data, backend=NABackend.MULTIGRAPH)
    torch.testing.assert_close(fused, multi, **TOL)
    units = data.plan().units()
    (topology,) = units._topologies.values()  # both backends' one topology
    wsel = torch.zeros(len(data.graphs), dtype=torch.int32)
    assert topology.fused_index(wsel, 1)["units"][3].shape[-1] == 32
