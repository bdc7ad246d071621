"""Port parity of the Table-2 models' forward on the relation graphs:
R-GAT here, S-HGN and R-GCN in tests/test_torch_models_shgn_rgcn.py (HAN's
per-graph backends: tests/test_torch_han_backends.py).

Synthetic acm at the reference tests' small size (scale=0.05,
feat_scale=0.1, block=16) and narrow widths, weights made by the JAX
``init_*`` functions and carried across through ``repro_torch.convert``:

* the relation graphs (padded edge lists and block CSR) are byte for byte
  the JAX package's;
* each model's logits agree with the JAX model on the same backend
  (SEGMENT, BLOCK, KERNEL against ``KERNEL_INTERPRET``, MULTIGRAPH against
  ``MULTIGRAPH_INTERPRET``) at atol=1e-5, rtol=1e-4 (float32, sums in
  another order);
* across backends the port agrees with itself at the JAX tests' 5e-4.

tests/test_torch_cuda.py runs R-GAT and S-HGN on KERNEL on the card."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import NABackend as JNA
from repro.graphs import relation_semantic_graphs as jrelation_graphs
from repro.graphs import synthetic_hetgraph as jsynthetic_hetgraph
from repro.models.hgnn import MODELS as JMODELS
from repro.models.hgnn import prepare_data as jprepare_data
from repro_torch.convert import params_from_numpy
from repro_torch.core import NABackend
from repro_torch.graphs import dataset_target, relation_semantic_graphs, synthetic_hetgraph
from repro_torch.graphs import synthetic_labels
from repro_torch.models.hgnn import MODELS, prepare_data

GRAPH = dict(scale=0.05, feat_scale=0.1, seed=0)
BLOCK = 16
WIDTHS = {
    "R-GAT": dict(hidden=8, heads=2, layers=2),
    "S-HGN": dict(hidden=8, heads=2, layers=2, edge_dim=8),
    "R-GCN": dict(hidden=8, layers=2),
}
BACKENDS = {  # port backend -> the JAX backend of the same path, on the CPU
    NABackend.SEGMENT: JNA.SEGMENT,
    NABackend.BLOCK: JNA.BLOCK,
    NABackend.KERNEL: JNA.KERNEL_INTERPRET,
    NABackend.MULTIGRAPH: JNA.MULTIGRAPH_INTERPRET,
}
TOL = dict(rtol=1e-4, atol=1e-5)
CROSS = dict(rtol=5e-4, atol=5e-4)


@functools.lru_cache(maxsize=None)
def relation_problem():
    """(jax data, port data, JAX params by model) on small acm's relation graphs."""
    target, ncls = dataset_target("acm")
    jg, tg = jsynthetic_hetgraph("acm", **GRAPH), synthetic_hetgraph("acm", **GRAPH)
    labels = synthetic_labels(tg, "acm")
    jdata = jprepare_data(jg, jrelation_graphs(jg), target, ncls, labels, block=BLOCK)
    tdata = prepare_data(tg, relation_semantic_graphs(tg), target, ncls, labels, block=BLOCK,
                         device="cpu")
    params = {name: JMODELS[name].init(jax.random.key(i), jdata, **WIDTHS[name])
              for i, name in enumerate(("R-GAT", "S-HGN", "R-GCN"))}
    return jdata, tdata, params


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_logits(name, params, jdata, backend):
    return np.asarray(jax.jit(lambda p: JMODELS[name].forward(p, jdata, backend=backend))(params))


def test_relation_graphs_are_the_reference_graphs():
    jdata, tdata, _ = relation_problem()
    assert [b.name for b in tdata.graphs] == [b.name for b in jdata.graphs]
    for jb, tb in zip(jdata.graphs, tdata.graphs):
        assert (tb.src_type, tb.dst_type, tb.num_src, tb.num_dst) == (
            jb.src_type, jb.dst_type, jb.num_src, jb.num_dst)
        got = dict(zip(("src", "dst", "valid"), tb.edges), col_index=tb.col_index,
                   masks=tb.masks)
        for f, t in got.items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jb, f)),
                                          err_msg=f"{tb.name}.{f}")
    assert sorted(JMODELS) == ["HAN", "R-GAT", "R-GCN", "S-HGN"]
    # the port's models are the reference's and Simple-HGN as HGB publishes it (port only)
    assert sorted(MODELS) == sorted([*JMODELS, "Simple-HGN"])


def check_logits(name, backend):
    """Model ``name``'s logits on ``backend`` against the JAX model on the
    same path."""
    jdata, tdata, params = relation_problem()
    want = _jax_logits(name, params[name], jdata, BACKENDS[backend])
    with torch.no_grad():
        got = MODELS[name].forward(params_from_numpy(_np(params[name]), device="cpu"), tdata,
                                   backend=backend)
    assert got.shape == (tdata.features[tdata.target_type].shape[0], tdata.num_classes)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def check_backends_agree(name):
    """Model ``name`` on every backend against KERNEL, within the port."""
    _, tdata, params = relation_problem()
    p = params_from_numpy(_np(params[name]), device="cpu")
    with torch.no_grad():
        logits = {b: MODELS[name].forward(p, tdata, backend=b) for b in BACKENDS}
    for b in BACKENDS:
        torch.testing.assert_close(logits[b], logits[NABackend.KERNEL], **CROSS)


@pytest.mark.parametrize("backend", list(BACKENDS), ids=lambda b: b.value)
def test_rgat_logits_match_jax(backend):
    check_logits("R-GAT", backend)


def test_rgat_kernel_backend_agrees_with_the_others():
    check_backends_agree("R-GAT")
