"""Port parity of kernel #6 (``fused_fp_coeff``, the FP+θ stage of R-GAT's
and S-HGN's KERNEL backend).

On CPU tensors the port's wrapper takes its plain PyTorch version.  It is
held against the JAX package's Pallas kernel run in interpret mode on the
reference tests' shapes (tests/test_kernels.py:test_fused_fp_coeff_sweep)
plus R-GAT's head layout (H = 4, Dh = 64), in float32 at atol=rtol=1e-5
and in bfloat16 with h within one bf16 rounding (rtol 8e-3) and θ at 1e-4.
Those tolerances pin the kernel's rule that θ is taken from the float32 h
before the cast (``ref_fused_fp_coeff`` takes it from the rounded h).  A
ragged shape (N and Din no multiple of any tile) is held against
``ref_fused_fp_coeff``.  Like the JAX kernel it has no gradient; the
wrapper raises on operands it does not take; and R-GAT and S-HGN on
KERNEL run their FP+θ through #6 twice per relation and layer.

The tensor-core route's numerics (``tensor_core_emulation``: split TF32,
three products into float32 accumulators restarted every ``CHAIN_TILES``
K tiles, K slices summed in order) are
held against the Pallas kernel at the sweep's shapes in float32 at
atol=rtol=1e-5, and the limit ``SPLIT_ERROR_MAX`` is shown to pass the
three-product split and fail one TF32 product, each by at least 10x, at
Din = 3,341 and 256.  ``route`` and the split rule ``split_k`` are pinned
on the shapes the main path gives them.  tests/test_torch_cuda.py holds
both CUDA kernels against the plain version on the card."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_fp_coeff import fused_fp_coeff as jfused_fp_coeff
from repro.kernels.ref import ref_fused_fp_coeff
from repro_torch.core import NABackend, project_coefficients
from repro_torch.kernels import fused_fp_coeff
from repro_torch.models.hgnn import MODELS, live_relations

from test_torch_models import relation_problem

fusion = importlib.import_module("repro_torch.core.fusion")
k6 = importlib.import_module("repro_torch.kernels.fused_fp_coeff")

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_H = dict(rtol=8e-3, atol=1e-5)  # one bf16 rounding of h
BF16_THETA = dict(rtol=1e-4, atol=1e-4)
SHAPES = [  # (N, Din, H, Dh, block_n, block_k): the reference tests' sweep, then R-GAT's heads
    (64, 48, 2, 16, 32, 16),
    (32, 64, 1, 32, 32, 64),
    (128, 32, 4, 8, 64, 32),
    (64, 128, 4, 64, 32, 64),
]


def operands(N, Din, H, Dh, seed=None):
    """tests/test_kernels.py's operands (float32 numpy)."""
    rng = np.random.default_rng(N + Din if seed is None else seed)
    x = rng.standard_normal((N, Din)).astype(np.float32) * 0.5
    w = rng.standard_normal((Din, H * Dh)).astype(np.float32) * 0.1
    b = rng.standard_normal(H * Dh).astype(np.float32) * 0.1
    a_s = rng.standard_normal((H, Dh)).astype(np.float32)
    a_d = rng.standard_normal((H, Dh)).astype(np.float32)
    return x, w, b, a_s, a_d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,Din,H,Dh,bn,bk", SHAPES)
def test_kernel6_plain_matches_pallas_interpret(N, Din, H, Dh, bn, bk, dtype):
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) for a in operands(N, Din, H, Dh)]
    want = jfused_fp_coeff(*jargs, block_n=bn, block_k=bk, interpret=True)
    # the same (rounded) values on both sides: bf16 -> float32 is exact
    targs = [torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype)) for a in jargs]
    h, th_s, th_d = fused_fp_coeff(*targs)
    assert h.dtype == targs[0].dtype and th_s.dtype == th_d.dtype == torch.float32
    assert h.shape == (N, H * Dh) and th_s.shape == th_d.shape == (N, H)
    h_tol, th_tol = (F32, F32) if dtype == "float32" else (BF16_H, BF16_THETA)
    np.testing.assert_allclose(h.float().numpy(), np.asarray(want[0], np.float32), **h_tol)
    np.testing.assert_allclose(th_s.numpy(), np.asarray(want[1]), **th_tol)
    np.testing.assert_allclose(th_d.numpy(), np.asarray(want[2]), **th_tol)


@pytest.mark.parametrize("H,Dh", [(4, 16), (3, 8)])
def test_kernel6_plain_matches_ref_on_a_ragged_shape(H, Dh):
    """N = 50 and Din = 37 are no multiple of any tile: the port takes them
    (the reference's kernel asserts divisibility for its TPU tiling; its
    oracle does not)."""
    args = operands(50, 37, H, Dh, seed=5)
    want = ref_fused_fp_coeff(*map(jnp.asarray, args))
    got = fused_fp_coeff(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


def test_kernel6_has_no_gradient_like_the_pallas_kernel():
    args = operands(32, 16, 2, 8)

    def jloss(w):
        h, ts, td = jfused_fp_coeff(jnp.asarray(args[0]), w, *map(jnp.asarray, args[2:]),
                                    interpret=True)
        return jnp.sum(h) + jnp.sum(ts) + jnp.sum(td)

    # no custom_vjp: JAX's JVP of this pallas_call fails (an assertion inside
    # pallas_call's JVP rule in the installed JAX)
    with pytest.raises((NotImplementedError, AssertionError)):
        jax.grad(jloss)(jnp.asarray(args[1]))
    x, w, b, a_s, a_d = map(torch.from_numpy, args)
    w.requires_grad_()
    with pytest.raises(NotImplementedError, match="MULTIGRAPH"):
        fused_fp_coeff(x, w, b, a_s, a_d)
    with torch.no_grad():  # inference under no_grad is fine
        assert fused_fp_coeff(x, w, b, a_s, a_d)[0].grad_fn is None


@pytest.mark.parametrize("what,err,match", [
    ("w columns", ValueError, "H·Dh"),
    ("mixed dtypes", TypeError, "dtype"),
    ("float64", TypeError, "bfloat16"),
    ("head_dim 24", ValueError, "head_dim"),
    ("bias length", ValueError, "b:"),
    ("no rows", ValueError, "empty operand"),
    ("meta device", ValueError, "unsupported device"),
])
def test_kernel6_wrapper_rejects_what_the_kernel_does_not_take(what, err, match):
    x, w, b, a_s, a_d = map(torch.from_numpy, operands(16, 8, 2, 8))
    if what == "w columns":
        w = torch.zeros(8, 24)
    elif what == "mixed dtypes":
        w = w.to(torch.bfloat16)
    elif what == "float64":
        x, w, b, a_s, a_d = (t.double() for t in (x, w, b, a_s, a_d))
    elif what == "head_dim 24":
        w, b, a_s, a_d = torch.zeros(8, 48), torch.zeros(48), torch.zeros(2, 24), torch.zeros(2, 24)
    elif what == "bias length":
        b = torch.zeros(17)
    elif what == "no rows":
        x = x[:0]
    else:
        x, w, b, a_s, a_d = (t.to("meta") for t in (x, w, b, a_s, a_d))
    with pytest.raises(err, match=match):
        fused_fp_coeff(x, w, b, a_s, a_d)


def test_project_coefficients_kernel_route_is_the_plain_route():
    """The helper's KERNEL route (#6, a zero bias) gives the bits of the
    product and two einsums the other backends run."""
    x, w, _, a_s, a_d = map(torch.from_numpy, operands(40, 24, 4, 8))
    got = project_coefficients(x, w, a_s, a_d, backend=NABackend.KERNEL)
    want = project_coefficients(x, w, a_s, a_d, backend=NABackend.BLOCK)
    assert got[0].shape == (40, 4, 8)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


@pytest.mark.parametrize("name,width", [
    ("R-GAT", dict(hidden=8, heads=2, layers=2)),
    ("S-HGN", dict(hidden=8, heads=2, layers=2, edge_dim=8)),
])
def test_kernel_backend_runs_fp_theta_through_kernel6(monkeypatch, name, width):
    """Two calls of #6 per relation and layer (src and dst side) on KERNEL,
    over the live passes alone for R-GAT (``live_relations``), none on the
    other backends.  On the CPU the launch counter does not move, so the
    wrapper is counted through a stand-in."""
    _, tdata, _ = relation_problem()
    params = MODELS[name].init(torch.Generator().manual_seed(0), tdata, **width)
    passes = (sum(len(live) for live, _ in live_relations(tdata.graphs, tdata.target_type,
                                                          width["layers"]))
              if name == "R-GAT" else width["layers"] * len(tdata.graphs))
    calls = []

    def counted(*args):
        calls.append(args[0].shape)
        return fused_fp_coeff(*args)

    monkeypatch.setattr(fusion, "fused_fp_coeff", counted)
    with torch.no_grad():
        kernel = MODELS[name].forward(params, tdata, backend=NABackend.KERNEL)
        assert len(calls) == 2 * passes
        block = MODELS[name].forward(params, tdata, backend=NABackend.BLOCK)
    assert len(calls) == 2 * passes
    assert fused_fp_coeff.launches == 0
    torch.testing.assert_close(kernel, block, rtol=5e-4, atol=5e-4)


# -- the tensor-core route's numerics, route and split rule ----------------------------


@pytest.mark.parametrize("N,Din,H,Dh,bn,bk", SHAPES)
def test_kernel6_tensor_core_emulation_matches_pallas_interpret(N, Din, H, Dh, bn, bk):
    args = operands(N, Din, H, Dh)
    want = jfused_fp_coeff(*map(jnp.asarray, args), block_n=bn, block_k=bk, interpret=True)
    got = k6.tensor_core_emulation(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


@pytest.mark.parametrize("Din", [3341, 256])  # R-GAT's actor projection; layers 1-2
def test_split_error_limit_separates_three_products_from_one(Din):
    """At R-GAT's width (4 heads of 64) the three-product split stays 10x
    under SPLIT_ERROR_MAX and one TF32 product lands 10x over it."""
    x, w, b, a_s, a_d = map(torch.from_numpy, operands(256, Din, 4, 64, seed=Din))
    errs = {split: k6.split_error(k6.tensor_core_emulation(x, w, b, a_s, a_d, split=split)[0],
                                  x, w, b)
            for split in (True, False)}
    assert errs[True] * 10 <= k6.SPLIT_ERROR_MAX, errs
    assert errs[False] >= 10 * k6.SPLIT_ERROR_MAX, errs
    # the plain float32 product meets the limit too
    assert k6.split_error(x @ w + b, x, w, b) * 10 <= k6.SPLIT_ERROR_MAX


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh", k6.HEAD_DIMS)
def test_route_takes_float32_to_the_tensor_cores(dtype, Dh):
    want = "wgmma" if dtype == "float32" else "cuda_cores"
    assert k6.route(getattr(torch, dtype), Dh) == want


@pytest.mark.parametrize("N,Din,C,S", [
    (6124, 3341, 256, 2),   # layer 0: actor
    (4932, 3489, 256, 3),   # movie
    (2393, 3341, 256, 6),   # director
    (7971, 64, 256, 1),     # keyword
    (4932, 256, 256, 1),    # layers 1-2
    (1001, 37, 64, 1),      # ragged
    (64, 100_000, 256, 132),  # one tile: at most one wave of blocks
    (17_000, 3341, 256, 1),   # a full wave of tiles: no split
])
def test_split_k_is_a_fixed_rule_of_the_shape(N, Din, C, S):
    assert k6.split_k(N, Din, C) == S
    blocks = -(-N // k6.BLOCK_M) * -(-C // k6.BLOCK_N) * S
    assert S == 1 or blocks <= k6.SMS


@pytest.mark.parametrize("N", [1, 128, 2393, 100_000])
def test_split_k_leaves_k256_whole(N):
    assert k6.split_k(N, 256, 256) == 1


def test_emulation_sums_k_slices_in_order():
    """Two slices give the one-slice sums up to float32 rounding, and the
    slice order is fixed: the same call gives the same bits."""
    x, w, b, a_s, a_d = map(torch.from_numpy, operands(64, 1100, 2, 32, seed=3))
    one = k6.tensor_core_emulation(x, w, b, a_s, a_d, splits=1)
    two = k6.tensor_core_emulation(x, w, b, a_s, a_d, splits=2)
    assert all(torch.equal(a, b_) for a, b_ in
               zip(two, k6.tensor_core_emulation(x, w, b, a_s, a_d, splits=2)))
    for a, b_ in zip(one, two):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-5)
