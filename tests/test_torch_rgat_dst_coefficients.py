"""R-GAT's FP off KERNEL: ``project_dst_coefficients`` gives θ_dst =
<x w, a> per head as x @ fold(w, a), with no [N, H·Dh] destination table;
the source side projects hs and takes θ_src alone.

* θ against ``project_coefficients``'s θ_dst in float32 and against a
  float64 evaluation of the product-then-einsum expression; the source
  side's hs and θ_src are ``project_coefficients``'s bits;
* the gradients of x, w and a against float64 autograd of that expression;
* one R-GAT forward on MULTIGRAPH and on SEGMENT makes a product with H·Dh
  columns over the source table of each relation and layer and over none
  else (the products' output shapes, seen through a dispatch mode), and
  the counter reads the live (relation, layer) passes;
* KERNEL still runs ``project_coefficients`` (#6) on both sides, and the
  counter reads 0 there.

tests/test_torch_rgat_grads.py and tests/test_torch_rgat_train.py hold the
model's gradients and AdamW steps against ``jax.grad``."""
import collections
import functools
import importlib

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import NABackend, project_coefficients, project_dst_coefficients
from repro_torch.graphs import dataset_target, relation_semantic_graphs, synthetic_hetgraph
from repro_torch.graphs import synthetic_labels
from repro_torch.models.hgnn import init_rgat, live_relations, prepare_data, rgat_forward

rgat = importlib.import_module("repro_torch.models.hgnn.rgat")

F32 = dict(rtol=1e-5, atol=1e-5)
CASES = [(h, dh, d) for h in (1, 4, 8) for dh in (15, 64) for d in (7, 128)]
WIDTH = dict(hidden=8, heads=2, layers=2)
_PRODUCTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default}


def _operands(heads, dh, d_in, dtype=torch.float32):
    gen = torch.Generator().manual_seed(heads * 1000 + dh * 10 + d_in)
    x = torch.randn(50, d_in, generator=gen)
    w = torch.randn(d_in, heads * dh, generator=gen) / d_in ** 0.5
    a = torch.randn(heads, dh, generator=gen) / dh ** 0.5
    return x.to(dtype), w.to(dtype), a.to(dtype)


def _theta(x, w, a):
    """The product-then-einsum expression: <x w, a> per head."""
    return torch.einsum("nhd,hd->nh", (x @ w).reshape(x.shape[0], a.shape[0], -1), a)


@pytest.mark.parametrize("heads,dh,d_in", CASES, ids=lambda v: str(v))
def test_theta_is_the_projected_tables_theta(heads, dh, d_in):
    x, w, a = _operands(heads, dh, d_in)
    got = project_dst_coefficients(x, w, a)
    assert got.shape == (x.shape[0], heads) and got.dtype == torch.float32
    _, _, old = project_coefficients(x, w, torch.zeros_like(a), a, backend=NABackend.SEGMENT)
    torch.testing.assert_close(got, old, **F32)
    want = _theta(*(t.double() for t in (x, w, a)))
    torch.testing.assert_close(got.double(), want, **F32)
    hs, th_s = rgat._project_src(x, w, a)
    want_hs, want_th_s, _ = project_coefficients(x, w, a, a, backend=NABackend.SEGMENT)
    assert torch.equal(hs, want_hs) and torch.equal(th_s, want_th_s)


@pytest.mark.parametrize("heads,dh,d_in", CASES, ids=lambda v: str(v))
def test_gradients_match_float64_autograd(heads, dh, d_in):
    x, w, a = (t.requires_grad_() for t in _operands(heads, dh, d_in))
    cot = torch.randn(x.shape[0], heads, generator=torch.Generator().manual_seed(7))
    got = torch.autograd.grad((project_dst_coefficients(x, w, a) * cot).sum(), (x, w, a))
    x64, w64, a64 = (t.detach().double().requires_grad_() for t in (x, w, a))
    want = torch.autograd.grad((_theta(x64, w64, a64) * cot.double()).sum(), (x64, w64, a64))
    for name, g, w_ in zip("xwa", got, want):
        assert g.dtype == torch.float32, name
        torch.testing.assert_close(g.double(), w_, **F32, msg=name)


@functools.lru_cache(maxsize=None)
def _problem():
    graph = dict(scale=0.05, feat_scale=0.1, seed=0)
    target, ncls = dataset_target("acm")
    g = synthetic_hetgraph("acm", **graph)
    data = prepare_data(g, relation_semantic_graphs(g), target, ncls, synthetic_labels(g, "acm"),
                        block=16, device="cpu")
    return data, init_rgat(torch.Generator().manual_seed(0), data, **WIDTH)


class _Products(TorchDispatchMode):
    """Rows of every matrix product's output with ``cols`` columns."""

    def __init__(self, cols):
        super().__init__()
        self.cols, self.rows = cols, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _PRODUCTS and out.shape[-1] == self.cols:
            self.rows.append(out.shape[-2])
        return out


@pytest.mark.parametrize("backend", [NABackend.MULTIGRAPH, NABackend.SEGMENT],
                         ids=lambda b: b.value)
def test_training_forward_projects_no_destination_table(backend):
    data, params = _problem()
    c = WIDTH["heads"] * WIDTH["hidden"]
    assert data.num_classes != c
    tree = {"layers": [{"rel": {k: {n: t.clone().requires_grad_() for n, t in r.items()}
                                for k, r in lp["rel"].items()},
                        "self": lp["self"]} for lp in params["layers"]],
            "w_out": params["w_out"], "b_out": params["b_out"]}
    project_dst_coefficients.calls = 0
    with _Products(c) as spy:
        logits = rgat_forward(tree, data, backend=backend)
    graphs = data.graphs
    schedule = live_relations(graphs, data.target_type, WIDTH["layers"])
    assert project_dst_coefficients.calls == sum(len(live) for live, _ in schedule)
    entered = {b.dst_type for b in graphs}
    want = []
    for live, build in schedule:
        want += [graphs[i].num_src for i in live]
        want += [data.features[t].shape[0] for t in build - entered]
    assert collections.Counter(spy.rows) == collections.Counter(want)
    logits.sum().backward()  # w_dst and a_dst get their gradients through the fold
    live = [r for lp in tree["layers"] for r in lp["rel"].values() if r["w_src"].grad is not None]
    assert len(live) > len(graphs)  # every relation into the target, and more
    assert len(live) == project_dst_coefficients.calls  # and no dead pass
    for r in tree["layers"][-1]["rel"].values():
        assert (r["w_src"].grad is not None) == (r["w_dst"].grad is not None)
    for r in live:
        assert r["w_dst"].grad is not None and r["a_dst"].grad is not None


def test_kernel_backend_keeps_both_sides_on_project_coefficients(monkeypatch):
    data, params = _problem()
    sides = []

    def counted(x, *args, **kw):
        sides.append(x.shape[0])
        return project_coefficients(x, *args, **kw)

    monkeypatch.setattr(rgat, "project_coefficients", counted)
    project_dst_coefficients.calls = 0
    with torch.no_grad():
        rgat_forward(params, data, backend=NABackend.KERNEL)
    graphs = data.graphs
    want = [n for live, _ in live_relations(graphs, data.target_type, WIDTH["layers"])
            for i in live for n in (graphs[i].num_src, graphs[i].num_dst)]
    assert sides == want
    assert project_dst_coefficients.calls == 0
