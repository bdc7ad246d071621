"""Port parity of kernel #5 (``seg_gat_agg``, the per-graph KERNEL backend).

On CPU tensors the port's wrapper takes its plain PyTorch version; it is
held against the JAX package's Pallas kernel run in interpret mode on the
reference tests' shapes (tests/test_kernels.py:test_seg_gat_agg_shapes),
an all-padding row, fully masked rows, B = 32 and Ns ≠ Nd, each with a
per-head edge bias, at atol=rtol=1e-5 (float32, the same online softmax in
another sum order).  The cases are tests/test_torch_cuda.py's, which holds
the CUDA kernel against the plain version on the card.  Like the JAX
kernel it has no gradient; and the SEGMENT and KERNEL backends of
``neighbor_aggregate`` agree with BLOCK."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import NABackend, batch_semantic_graph, neighbor_aggregate, neighbor_aggregate_multi
from repro_torch.graphs import build_semantic_graph, relation_semantic_graphs, synthetic_hetgraph
from repro_torch.kernels import seg_gat_agg, seg_gat_agg_multigraph_plain

from test_torch_cuda import KERNEL5_CASES

jkernel = importlib.import_module("repro.kernels.seg_gat_agg")

TOL = dict(rtol=1e-5, atol=1e-5)


def _torch(case):
    return [torch.from_numpy(np.array(a)) for a in case]


@pytest.mark.parametrize("name", sorted(KERNEL5_CASES))
def test_kernel5_plain_matches_pallas_interpret(name):
    case = KERNEL5_CASES[name]()
    col, masks, ths, thd, hs, bias = case
    want = jkernel.seg_gat_agg(*map(jnp.asarray, case[:5]), edge_bias=jnp.asarray(bias),
                               interpret=True)
    got = seg_gat_agg(*_torch(case[:5]), edge_bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    B = masks.shape[-1]
    dead = np.repeat((col < 0).all(axis=1), B)
    assert (got.numpy()[dead] == 0).all()  # an all-padding row gives exact zeros


@pytest.mark.parametrize("bias", [0.0, 0.7, "0-d"])
def test_kernel5_scalar_bias_matches_pallas_interpret(bias):
    case = KERNEL5_CASES["B8-R3-W2-H2-Dh16"]()
    jb = 0.5 if bias == "0-d" else bias
    tb = torch.tensor(0.5) if bias == "0-d" else bias
    want = jkernel.seg_gat_agg(*map(jnp.asarray, case[:5]), edge_bias=jb, interpret=True)
    got = seg_gat_agg(*_torch(case[:5]), edge_bias=tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_kernel5_is_multigraph_kernel_at_one_graph():
    """#5 computes #1's function for G = 1 (tests/test_kernels.py pins the
    identity in JAX); the card compares the two kernels too."""
    col, masks, ths, thd, hs, bias = _torch(KERNEL5_CASES["degenerate-B16"]())
    R = col.shape[0]
    got = seg_gat_agg(col, masks, ths, thd, hs, edge_bias=bias)
    want, _ = seg_gat_agg_multigraph_plain(
        col, torch.zeros(R, dtype=torch.int32), torch.arange(R, dtype=torch.int32), masks,
        ths[None], thd[None], hs, bias[None])
    torch.testing.assert_close(got, want, **TOL)


def test_kernel5_has_no_gradient_like_the_pallas_kernel():
    col, masks, ths, thd, hs, bias = KERNEL5_CASES["B8-R3-W2-H2-Dh16"]()

    def jloss(t):
        return jnp.sum(jkernel.seg_gat_agg(jnp.asarray(col), jnp.asarray(masks), t,
                                           jnp.asarray(thd), jnp.asarray(hs), interpret=True))

    with pytest.raises(NotImplementedError):
        jax.grad(jloss)(jnp.asarray(ths))
    leaves = [t.requires_grad_() for t in _torch((ths, thd, hs))]
    with pytest.raises(NotImplementedError, match="MULTIGRAPH"):
        seg_gat_agg(torch.from_numpy(col), torch.from_numpy(masks), *leaves)
    with torch.no_grad():  # inference under no_grad is fine
        assert seg_gat_agg(torch.from_numpy(col), torch.from_numpy(masks), *leaves).grad_fn is None


@pytest.mark.parametrize("what,match", [
    ("theta_dst rows", "theta_dst"),
    ("float64", "dtype"),
    ("column out of range", "col_index"),
    ("bias length", "edge_bias"),
])
def test_kernel5_checks_its_operands(what, match):
    col, masks, ths, thd, hs, bias = _torch(KERNEL5_CASES["B8-R3-W2-H2-Dh16"]())
    if what == "theta_dst rows":
        thd = thd[:-1]
    elif what == "float64":
        hs = hs.double()
    elif what == "column out of range":
        col = col.clone()
        col[0, 0] = ths.shape[0] // masks.shape[-1]
    else:
        bias = torch.zeros(bias.shape[0] + 1)
    with pytest.raises((ValueError, TypeError), match=match):
        seg_gat_agg(col, masks, ths, thd, hs, edge_bias=bias)


@pytest.mark.parametrize("backend", [NABackend.SEGMENT, NABackend.KERNEL])
def test_segment_and_kernel_backends_agree_with_block(backend):
    """Converted from the test that pinned SEGMENT and KERNEL as not ported:
    both now agree with the BLOCK oracle, on a metapath graph (shared
    vertex space) and on relation graphs (Ns ≠ Nd), one graph at a time and
    through the per-graph loop of ``neighbor_aggregate_multi``."""
    g = synthetic_hetgraph("imdb", scale=0.05, feat_scale=0.02, seed=0)
    sgs = [build_semantic_graph(g, ("movie", "director", "movie"), max_edges=2000)]
    sgs += relation_semantic_graphs(g)
    rng = np.random.default_rng(0)
    H, Dh = 2, 4
    for sg in sgs:
        batch = batch_semantic_graph(sg, block=8)
        ths = torch.from_numpy(rng.standard_normal((sg.num_src, H)).astype(np.float32))
        thd = torch.from_numpy(rng.standard_normal((sg.num_dst, H)).astype(np.float32))
        hs = torch.from_numpy(rng.standard_normal((sg.num_src, H, Dh)).astype(np.float32))
        bias = torch.from_numpy(rng.standard_normal(H).astype(np.float32))
        want = neighbor_aggregate(batch, ths, thd, hs, backend=NABackend.BLOCK, edge_bias=bias)
        got = neighbor_aggregate(batch, ths, thd, hs, backend=backend, edge_bias=bias)
        assert got.shape == (sg.num_dst, H, Dh)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        multi = neighbor_aggregate_multi([batch], ths[None], thd[None], hs, backend=backend,
                                         edge_bias=bias[None])
        torch.testing.assert_close(multi[0], got, rtol=0, atol=0)
