"""Port parity of HAN on the per-graph backends of the third slice:
SEGMENT, KERNEL (kernel #5 per metapath graph) and the staged baseline
``han_forward_staged``, against the JAX package on synthetic acm
(tests/test_torch_train.py's problem: scale=0.05, block=16,
max_edges=20000; hidden=8, heads=2), weights made by JAX's ``init_han``:
logits at atol=1e-5, rtol=1e-4 against the same JAX path, and at the JAX
tests' 5e-4 against the port's BLOCK."""
import jax
import numpy as np
import pytest
import torch

from repro.core import NABackend as JNA
from repro.launch.hgnn_train import build_problem as jbuild_problem
from repro.models.hgnn import MODELS as JMODELS
from repro.models.hgnn.han import han_forward_staged as jhan_forward_staged
from repro_torch.convert import params_from_numpy
from repro_torch.core import NABackend
from repro_torch.launch import hgnn_train
from repro_torch.models.hgnn import MODELS, han_forward_staged

BACKENDS = {NABackend.SEGMENT: JNA.SEGMENT, NABackend.KERNEL: JNA.KERNEL_INTERPRET}
TOL = dict(rtol=1e-4, atol=1e-5)
CROSS = dict(rtol=5e-4, atol=5e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def metapath():
    problem = dict(scale=0.05, feat_scale=0.1, block=16, max_edges=20_000)
    _, jdata = jbuild_problem("acm", **problem)
    _, tdata = hgnn_train.build_problem("acm", device="cpu", **problem)
    jparams = JMODELS["HAN"].init(jax.random.key(5), jdata, hidden=8, heads=2, att_dim=16)
    return jdata, tdata, jparams


@pytest.mark.parametrize("backend", [NABackend.SEGMENT, NABackend.KERNEL], ids=lambda b: b.value)
def test_han_per_graph_backends_match_jax(metapath, backend):
    jdata, tdata, jparams = metapath
    jforward = jax.jit(lambda p: JMODELS["HAN"].forward(p, jdata, backend=BACKENDS[backend]))
    want = np.asarray(jforward(jparams))
    with torch.no_grad():
        got = MODELS["HAN"].forward(params_from_numpy(_np(jparams), device="cpu"), tdata,
                                    backend=backend)
        block = MODELS["HAN"].forward(params_from_numpy(_np(jparams), device="cpu"), tdata,
                                      backend=NABackend.BLOCK)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    torch.testing.assert_close(got, block, **CROSS)


def test_han_forward_staged_matches_jax(metapath):
    jdata, tdata, jparams = metapath
    want = np.asarray(jhan_forward_staged(jparams, jdata))
    with torch.no_grad():
        got = han_forward_staged(params_from_numpy(_np(jparams), device="cpu"), tdata)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
