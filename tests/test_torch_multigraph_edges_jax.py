"""The emulations of #1's edge walk and #2's edge passes
(tests/test_torch_multigraph_edges.py) against the JAX package's
interpret-mode Pallas kernel on the same cases: the forward at
atol=rtol=1e-5, the gradients of sum(sin(out)) against ``jax.grad`` at
rtol 1e-4, atol 1e-5 (float32 sums in another order)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_cuda import one_thread  # noqa: F401 (a fixture)
from test_torch_multigraph_edges import (
    BWD_TOL,
    EDGE_CASES,
    FWD_TOL,
    GRAD_NAMES,
    SLOPE,
    _emulate_forward,
    emulated_gradients,
)

jmulti = importlib.import_module("repro.kernels.seg_gat_agg_multigraph")
pytestmark = pytest.mark.usefixtures("one_thread")  # the plain versions at B = 64 and 128


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_forward_edge_walk_matches_pallas_interpret(name):
    case = EDGE_CASES[name]()
    want = jax.jit(jmulti._fwd_call, static_argnums=(8, 9))(*map(jnp.asarray, case), SLOPE, True)
    for g, w in zip(_emulate_forward(*case), want):
        np.testing.assert_allclose(g, np.asarray(w), **FWD_TOL)


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_backward_passes_match_jax_grad(name):
    case = EDGE_CASES[name]()

    def loss(a, b, c, d):
        o = jmulti.seg_gat_agg_multigraph(*map(jnp.asarray, case[:4]), a, b, c, d,
                                          interpret=True)
        return jnp.sum(jnp.sin(o))

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*map(jnp.asarray, case[4:]))
    got, _ = emulated_gradients(case)
    for nm, g, w in zip(GRAD_NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=nm, **BWD_TOL)
