"""Port parity of the NA kernels: the port's wrappers on CPU tensors (their
plain PyTorch versions) against the JAX package's Pallas kernels run in
interpret mode, on the reference tests' own shapes, at atol=rtol=1e-5.
Both ``out`` and the ``lse`` residual of the forward are compared."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.stages as jstages
import repro_torch.core.stages as tstages
from repro_torch.kernels import seg_gat_agg_fused_fp_fwd, seg_gat_agg_multigraph_fwd

# the modules, not the functions that ``repro.kernels`` re-exports by the same names
jfused = importlib.import_module("repro.kernels.seg_gat_agg_fused_fp")
jmulti = importlib.import_module("repro.kernels.seg_gat_agg_multigraph")

TOL = dict(atol=1e-5, rtol=1e-5)


def _multigraph_case(seed=7, B=8, U=4, W=3, G=3, H=2, Dh=8, nblk=4):
    """tests/test_kernels.py:_multigraph_case."""
    rng = np.random.default_rng(seed)
    ns_pad = nblk * B
    col = np.full((U, W), -1, np.int32)
    for u in range(U):
        k = rng.integers(1, W + 1)
        col[u, :k] = rng.choice(nblk, size=k, replace=False)
    gid = rng.integers(0, G, U).astype(np.int32)
    row = rng.integers(0, nblk, U).astype(np.int32)
    masks = rng.random((U, W, B, B)) < 0.3
    ths = rng.standard_normal((G, ns_pad, H)).astype(np.float32)
    thd = rng.standard_normal((G, ns_pad, H)).astype(np.float32)
    hs = rng.standard_normal((ns_pad, H, Dh)).astype(np.float32)
    bias = rng.standard_normal((G, H)).astype(np.float32)
    return col, gid, row, masks, ths, thd, hs, bias


def _fused_case(seed, *, units=6, width=3, nblk=5, graphs=3, tables=2, din=12, B=8, H=2, DH=4):
    """tests/test_fused_fp.py:_rand_tables."""
    rng = np.random.default_rng(seed)
    col = rng.integers(-1, nblk, (units, width)).astype(np.int32)
    col[:, 0] = np.maximum(col[:, 0], 0)
    gid = rng.integers(0, graphs, (units,)).astype(np.int32)
    row = rng.integers(0, nblk, (units,)).astype(np.int32)
    wsel = rng.integers(0, tables, (graphs,)).astype(np.int32)
    masks = rng.random((units, width, B, B)) < 0.6
    masks[:, 0, 0, 0] = True
    n = nblk * B
    x = rng.standard_normal((n, din)).astype(np.float32)
    w = (rng.standard_normal((tables, din, H * DH)) / np.sqrt(din)).astype(np.float32)
    b = rng.standard_normal((tables, H * DH)).astype(np.float32) * 0.1
    a_s = rng.standard_normal((graphs, H, DH)).astype(np.float32)
    a_d = rng.standard_normal((graphs, H, DH)).astype(np.float32)
    bias = rng.standard_normal((graphs, H)).astype(np.float32) * 0.3
    return col, gid, row, wsel, masks, x, w, b, a_s, a_d, bias


def _degenerate(col, masks):
    """Unit 1 all padding; dst row 2 of unit 0 fully masked."""
    col = col.copy()
    masks = masks.copy()
    col[1] = -1
    masks[0, :, 2, :] = False
    return col, masks


@pytest.mark.parametrize("seed,degenerate", [(7, False), (7, True), (11, True)])
def test_multigraph_matches_pallas_interpret(seed, degenerate):
    col, gid, row, masks, ths, thd, hs, bias = _multigraph_case(seed)
    if degenerate:
        col, masks = _degenerate(col, masks)
    j_out, j_lse = jmulti._fwd_call(
        jnp.asarray(col), jnp.asarray(gid), jnp.asarray(row), jnp.asarray(masks),
        jnp.asarray(ths), jnp.asarray(thd), jnp.asarray(hs), jnp.asarray(bias), 0.2, True,
    )
    t_out, t_lse = seg_gat_agg_multigraph_fwd(*map(torch.from_numpy, (
        col, gid, row, masks, ths, thd, hs, bias)))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), **TOL)
    assert np.abs(t_out.numpy()).max() > 0.0
    if degenerate:
        B = masks.shape[-1]
        assert np.all(t_out.numpy()[B:2 * B] == 0.0)   # all-padding unit
        assert np.all(t_out.numpy()[2] == 0.0)         # fully masked dst row
        assert np.isfinite(t_out.numpy()).all()


@pytest.mark.parametrize("seed,tables,degenerate", [(0, 2, False), (1, 1, True), (3, 2, True)])
def test_fused_fp_matches_pallas_interpret(seed, tables, degenerate):
    col, gid, row, wsel, masks, x, w, b, a_s, a_d, bias = _fused_case(seed, tables=tables)
    if degenerate:
        col, masks = _degenerate(col, masks)
    j_out, j_lse = jfused._fwd_call(*map(jnp.asarray, (
        col, gid, row, wsel, masks, x, w, b, a_s, a_d, bias)), 0.2, True)
    t_out, t_lse = seg_gat_agg_fused_fp_fwd(*map(torch.from_numpy, (
        col, gid, row, wsel, masks, x, w, b, a_s, a_d, bias)))
    U, B = col.shape[0], masks.shape[-1]
    np.testing.assert_allclose(t_out.numpy().reshape(U * B, -1), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), **TOL)
    if degenerate:
        assert np.all(t_out.numpy()[B:2 * B] == 0.0)
        assert np.all(t_out.numpy()[2] == 0.0)


def test_fused_fp_shared_table_2d_weights():
    """A single [Din, H·Dh] table is taken as T = 1, as in JAX."""
    col, gid, row, wsel, masks, x, w, b, a_s, a_d, bias = _fused_case(5, tables=1)
    wsel = np.zeros_like(wsel)
    ref = jfused.seg_gat_agg_fused_fp(*map(jnp.asarray, (
        col, gid, row, wsel, masks, x, w[0], b[0], a_s, a_d, bias)), interpret=True)
    out, _ = seg_gat_agg_fused_fp_fwd(*map(torch.from_numpy, (
        col, gid, row, wsel, masks, x, w[0], b[0], a_s, a_d, bias)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_block_oracle_matches_jax():
    rng = np.random.default_rng(3)
    B, R, W, H, Dh, nblk = 8, 3, 2, 2, 8, 4
    col = np.array([[0, 2], [1, -1], [-1, -1]], np.int32)
    masks = rng.random((R, W, B, B)) < 0.4
    ths = rng.standard_normal((nblk * B, H)).astype(np.float32)
    thd = rng.standard_normal((R * B, H)).astype(np.float32)
    hs = rng.standard_normal((nblk * B, H, Dh)).astype(np.float32)
    bias = rng.standard_normal((H,)).astype(np.float32)
    ref = jstages.block_softmax_aggregate(*map(jnp.asarray, (col, masks, ths, thd, hs)),
                                          edge_bias=jnp.asarray(bias))
    out = tstages.block_softmax_aggregate(*map(torch.from_numpy, (col, masks, ths, thd, hs)),
                                          edge_bias=torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert np.all(out.numpy()[2 * B:] == 0.0)


def test_wrappers_reject_bad_operands():
    col, gid, row, masks, ths, thd, hs, bias = map(torch.from_numpy, _multigraph_case())
    with pytest.raises(TypeError, match="float32"):
        seg_gat_agg_multigraph_fwd(col, gid, row, masks, ths.double(), thd, hs, bias)
    with pytest.raises(TypeError, match="int32"):
        seg_gat_agg_multigraph_fwd(col.long(), gid, row, masks, ths, thd, hs, bias)
    with pytest.raises(ValueError, match="col_index"):
        seg_gat_agg_multigraph_fwd(col + 100, gid, row, masks, ths, thd, hs, bias)
    with pytest.raises(ValueError, match="contiguous"):
        seg_gat_agg_multigraph_fwd(col, gid, row, masks, ths, thd,
                                   hs.transpose(1, 2).contiguous().transpose(1, 2), bias)
