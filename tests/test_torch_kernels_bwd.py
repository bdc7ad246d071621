"""Port parity of the NA backward kernels #2 and #4.

On CPU tensors the port's autograd Functions take the plain VJPs; they are
held against ``jax.grad`` through the JAX package's Pallas kernels run in
interpret mode, on the reference tests' own shapes (tests/test_kernels.py
multigraph VJP, tests/test_fused_fp.py fused VJP), degenerate cases
included, at rtol=1e-4, atol=1e-5 (float32, sums in another order); and
against ``torch.autograd`` through the plain forwards.  The cases are
tests/test_torch_cuda.py's, which holds the CUDA kernels against the plain
versions on the card."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.stages as jstages
from repro_torch.core import NABackend, batch_semantic_graph, neighbor_aggregate_multi
from repro_torch.graphs import build_semantic_graph, synthetic_hetgraph
from repro_torch.kernels import (
    seg_gat_agg_fused_fp,
    seg_gat_agg_fused_fp_bwd,
    seg_gat_agg_fused_fp_bwd_plain,
    seg_gat_agg_fused_fp_fwd,
    seg_gat_agg_fused_fp_plain,
    seg_gat_agg_multigraph,
    seg_gat_agg_multigraph_bwd,
    seg_gat_agg_multigraph_bwd_plain,
    seg_gat_agg_multigraph_fwd,
    seg_gat_agg_multigraph_plain,
)

from test_torch_cuda import (  # noqa: F401 (one_thread: a fixture)
    FUSED_CASES, MULTI_CASES, fused_case, multigraph_case, one_thread, single_graph_case)

jfused = importlib.import_module("repro.kernels.seg_gat_agg_fused_fp")
jmulti = importlib.import_module("repro.kernels.seg_gat_agg_multigraph")

TOL = dict(rtol=1e-4, atol=1e-5)


def _jax_multigraph_grads(case):
    col, gid, row, masks, ths, thd, hs, bias = map(jnp.asarray, case)

    def loss(a, b, c, d):
        out = jmulti.seg_gat_agg_multigraph(col, gid, row, masks, a, b, c, d, interpret=True)
        return jnp.sum(jnp.sin(out))

    return jax.grad(loss, argnums=(0, 1, 2, 3))(ths, thd, hs, bias)


def _torch_leaves(arrays):
    return [torch.from_numpy(np.array(a)).requires_grad_() for a in arrays]


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("name", sorted(MULTI_CASES))
def test_multigraph_vjp_matches_jax_grad(name):
    case = MULTI_CASES[name]()
    want = _jax_multigraph_grads(case)
    ints = [torch.from_numpy(a) for a in case[:4]]
    leaves = _torch_leaves(case[4:])
    out = seg_gat_agg_multigraph(*ints, *leaves)
    got = torch.autograd.grad(torch.sin(out).sum(), leaves)
    for nm, g, w in zip(("theta_src", "theta_dst", "h_src", "edge_bias"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=nm, **TOL)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("name", sorted(MULTI_CASES))
def test_multigraph_vjp_matches_autograd_of_plain_forward(name):
    case = [torch.from_numpy(np.array(a)) for a in MULTI_CASES[name]()]
    leaves = [t.clone().requires_grad_() for t in case[4:]]
    out, lse = seg_gat_agg_multigraph_plain(*case[:4], *leaves)
    g_out = torch.cos(out.detach())
    want = torch.autograd.grad((out * g_out).sum(), leaves)
    got = seg_gat_agg_multigraph_bwd_plain(*case, out.detach(), lse.detach(), g_out)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


def test_multigraph_padding_and_masked_rows_give_exact_zero_gradients():
    """Cotangent only on an all-padding unit and a fully masked row: every
    gradient is exactly zero and finite."""
    case = [torch.from_numpy(np.array(a)) for a in multigraph_case(7, degenerate=True)]
    out, lse = seg_gat_agg_multigraph_fwd(*case)
    B = case[3].shape[-1]
    g_out = torch.zeros_like(out)
    g_out[B:2 * B] = 1.0   # unit 1: all padding
    g_out[2] = 1.0         # unit 0, row 2: fully masked
    for g in seg_gat_agg_multigraph_bwd(*case, out, lse, g_out):
        assert torch.isfinite(g).all() and (g == 0).all()


def test_multigraph_backward_through_neighbor_aggregate_matches_block_autograd():
    """HAN's consolidated NA: MULTIGRAPH (autograd Function, plain VJP on
    CPU) against plain autograd through the BLOCK oracle."""
    g = synthetic_hetgraph("imdb", scale=0.05, feat_scale=0.02, seed=0)
    mps = [("movie", "director", "movie"), ("movie", "actor", "movie")]
    batches = [batch_semantic_graph(build_semantic_graph(g, mp, max_edges=2000, seed=i), block=8)
               for i, mp in enumerate(mps)]
    n = batches[0].num_dst
    rng = np.random.default_rng(0)
    ops = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for s in ((2, n, 2), (2, n, 2), (n, 2, 4), (2, 2))]
    grads = {}
    for backend in (NABackend.BLOCK, NABackend.MULTIGRAPH):
        leaves = [t.clone().requires_grad_() for t in ops]
        z = neighbor_aggregate_multi(batches, *leaves[:3], backend=backend, edge_bias=leaves[3],
                                     leaky_slope=0.1)
        grads[backend] = torch.autograd.grad(torch.sin(z).sum(), leaves)
    for a, b in zip(grads[NABackend.MULTIGRAPH], grads[NABackend.BLOCK]):
        torch.testing.assert_close(a, b, **TOL)


def test_neighbor_aggregate_keeps_the_residual_only_under_autograd():
    case = [torch.from_numpy(np.array(a)) for a in multigraph_case(7)]
    g = synthetic_hetgraph("imdb", scale=0.05, feat_scale=0.02, seed=0)
    batch = batch_semantic_graph(
        build_semantic_graph(g, ("movie", "director", "movie"), max_edges=2000), block=8)
    n = batch.num_dst
    ths, thd = torch.randn(1, n, 2), torch.randn(1, n, 2)
    hs = torch.randn(n, 2, 4, requires_grad=True)
    with torch.no_grad():
        assert neighbor_aggregate_multi([batch], ths, thd, hs).grad_fn is None
    z = neighbor_aggregate_multi([batch], ths, thd, hs)
    assert z.grad_fn is not None
    assert seg_gat_agg_multigraph(*case).grad_fn is None  # no operand needs a gradient


# -- kernel #4 ------------------------------------------------------------------


_FUSED_NAMES = ("x", "w", "b", "a_src", "a_dst", "edge_bias")


@pytest.mark.parametrize("name", sorted(FUSED_CASES))
def test_fused_fp_vjp_matches_jax_grad(name):
    case = FUSED_CASES[name]()
    fixed = [jnp.asarray(a) for a in case[:5]]

    def loss(*diff):
        return jnp.sin(jfused.seg_gat_agg_fused_fp(*fixed, *diff, interpret=True)).sum()

    want = jax.grad(loss, argnums=tuple(range(6)))(*map(jnp.asarray, case[5:]))
    leaves = _torch_leaves(case[5:])
    out = seg_gat_agg_fused_fp(*[torch.from_numpy(a) for a in case[:5]], *leaves)
    got = torch.autograd.grad(torch.sin(out).sum(), leaves)
    for nm, g, w in zip(_FUSED_NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=nm, **TOL)


@pytest.mark.parametrize("name", sorted(FUSED_CASES))
def test_fused_fp_vjp_matches_autograd_of_plain_forward(name):
    case = [torch.from_numpy(np.array(a)) for a in FUSED_CASES[name]()]
    leaves = [t.clone().requires_grad_() for t in case[5:]]
    out, lse = seg_gat_agg_fused_fp_plain(*case[:5], *leaves)
    g_out = torch.cos(out.detach())
    want = torch.autograd.grad((out * g_out).sum(), leaves)
    got = seg_gat_agg_fused_fp_bwd_plain(*case, out.detach(), lse.detach(), g_out)
    for nm, g, w in zip(_FUSED_NAMES, got, want):
        torch.testing.assert_close(g, w, msg=nm, **TOL)


def test_fused_fp_dead_unit_gives_exact_zero_gradients_and_skips_dx():
    """tests/test_fused_fp.py:test_fused_fp_dead_unit_is_zero_with_zero_grads,
    and ``need_dx=False`` (HAN's x needs no gradient) returns no d_x."""
    case = [torch.from_numpy(np.array(a)) for a in fused_case(3, units=4)]
    case[0][2] = -1
    out, lse = seg_gat_agg_fused_fp_fwd(*case)
    B = case[4].shape[-1]
    assert (out[2 * B:3 * B] == 0).all()
    g_out = torch.zeros_like(out)
    g_out[2 * B:3 * B] = 1.0
    grads = seg_gat_agg_fused_fp_bwd(*case, out, lse, g_out)
    for g in grads:
        assert torch.isfinite(g).all() and (g == 0).all()
    assert seg_gat_agg_fused_fp_bwd(*case, out, lse, g_out, need_dx=False)[0] is None
    x = case[5].clone().requires_grad_()
    w = case[6].clone().requires_grad_()
    y = seg_gat_agg_fused_fp(*case[:5], x.detach(), w, *case[7:])
    (gw,) = torch.autograd.grad(y.sum(), [w])
    assert gw.shape == w.shape


def test_block_oracle_gradients_match_jax_autodiff():
    """The BLOCK backend trains by plain autograd: its gradients against
    ``jax.grad`` of ``repro.core.stages.block_softmax_aggregate``."""
    col, _, _, masks, ths, thd, hs, bias = single_graph_case()
    ths, thd, bias = ths[0], thd[0], bias[0]

    def jloss(a, b, c, d):
        return jnp.sum(jnp.sin(jstages.block_softmax_aggregate(
            jnp.asarray(col), jnp.asarray(masks), a, b, c, edge_bias=d)))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (ths, thd, hs, bias)))
    import repro_torch.core.stages as tstages

    leaves = _torch_leaves((ths, thd, hs, bias))
    out = tstages.block_softmax_aggregate(torch.from_numpy(col), torch.from_numpy(masks),
                                          *leaves[:3], edge_bias=leaves[3])
    got = torch.autograd.grad(torch.sin(out).sum(), leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
