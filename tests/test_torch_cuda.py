"""The port's card-only tests of the training and R-GAT/S-HGN slices, and
the kernel cases they share with tests/test_torch_kernels_bwd.py and
tests/test_torch_kernel5.py.  This file imports no JAX, so it runs on a
host with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Kernels #1 and #2 against their plain versions on every multigraph case
(block sizes up to 128, a Dh that is not a multiple of 4, H·Dh = 1024),
each run twice and bitwise equal, each visiting exactly the edges (the
kernels' own counts), #2 with its index passed in giving the bits of one
built in the call, and #1 equal to #5 at G = 1 bit for bit; backward
kernel #4 against its plain version (atol=rtol=1e-4, float32 sums in
another order), run twice and bitwise equal; #3 and #4 at B = 64 and 128
(re-blocked to 32) against their plain versions; #3 and
#4 on both routes of their projection phase (tensor cores at H·Dh = 8
and 256, CUDA cores at H·Dh = 9) on a ragged Din, row counts that are
not a multiple of its 128-row tile, two tables and units that read a
subset of the blocks, twice bitwise equal and counted by route, and the
tensor-core route's projection on inexact operands under
SPLIT_ERROR_MAX; kernel
#5 against its plain version for B in {8, 16, 32, 64, 128}, each (V, NK)
instantiation of its edge walk and its edge cases, visiting exactly the
edges, equal to #1 at G = 1 bit for bit, giving the same bits on operands
at unaligned addresses and refusing a B outside EDGE_BLOCKS; the
trainer (HAN and R-GAT) on the card against the CPU; kernel training
bitwise repeatable; HAN over lane plans of 1, 4 and 16 lanes equal to
MULTIGRAPH bit for bit, one #1 and one #2 launch a step, its gradients
repeatable and at 1e-4 of the CPU's, and the plans' dead units changing
no bit; R-GAT and S-HGN inference on KERNEL against the CPU;
kernel #6 against its plain version (float32, bfloat16, a ragged shape),
its tensor-core route at R-GAT's layer-0 and layer-1 shapes and on ragged
ones at the main path's operand scale (also under SPLIT_ERROR_MAX, which
is checked at a larger scale too; twice bitwise equal; launches by
route), the CUDA-core route forced on float32, and R-GAT on KERNEL
launching it twice per relation and layer, all on the tensor cores; kernel #7
on both routes (bf16 also within one rounding, atol=1e-4, rtol=8e-3; on
the wgmma route at least BITWISE_SHARE_MIN of the outputs that rounding
bitwise) and the LM decoders, dense, MoE (card against CPU, routes
equal or near-ties) and recurrent (mamba2, recurrentgemma: forward,
decode, greedy and the batcher against the CPU).
Every test carries the ``cuda`` marker and skips without a card."""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import NABackend, build_multilane_plan
from repro_torch.graphs import (
    dataset_target,
    relation_semantic_graphs,
    synthetic_hetgraph,
    synthetic_labels,
)
from repro_torch.kernels import (
    flash_attention,
    flash_attention_plain,
    fused_fp_coeff,
    fused_fp_coeff_plain,
    seg_gat_agg,
    seg_gat_agg_fused_fp_bwd,
    seg_gat_agg_fused_fp_bwd_plain,
    seg_gat_agg_fused_fp_fwd,
    seg_gat_agg_fused_fp_plain,
    seg_gat_agg_multigraph,
    seg_gat_agg_multigraph_bwd,
    seg_gat_agg_multigraph_bwd_plain,
    seg_gat_agg_multigraph_fwd,
    seg_gat_agg_multigraph_plain,
    seg_gat_agg_plain,
)
from repro_torch.kernels.flash_attention import BITWISE_SHARE_MIN
from repro_torch.kernels.topology import Topology
from repro_torch.kernels.fused_fp_coeff import SPLIT_ERROR_MAX, split_error
from repro_torch.kernels.fused_fp_coeff import launch as kernel6_launch
from repro_torch.kernels.fused_fp_coeff import route as kernel6_route
from repro_torch.kernels.flash_attention import route as flash_route
from repro_torch.launch import hgnn_train
from repro_torch.models.lm import moe
from repro_torch.models.lm.api import build as build_lm
from repro_torch.models.hgnn import (
    MODELS,
    han_forward,
    han_forward_multilane,
    han_forward_staged,
    live_relations,
    prepare_data,
)
from repro_torch.obs import MetricsRegistry, disable_tracing, enable_tracing
from repro_torch.obs.characterize import characterize_hgnn
from repro_torch.serve import ContinuousBatcher, Request
from repro_torch.serve.engine import greedy_generate, init_serve_state, make_prefill
from repro_torch.serve.engine import make_serve_step
from repro_torch.tree import tree_leaves_with_path, tree_map

# the modules, not the differentiable functions the package exports by the same names
fused_ffp = importlib.import_module("repro_torch.kernels.seg_gat_agg_fused_fp")
mg_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg_multigraph")
k5_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg")


def multigraph_case(seed=7, B=8, U=4, W=3, G=3, H=2, Dh=8, nblk=4, degenerate=False):
    """tests/test_kernels.py:_multigraph_case (random, possibly repeated,
    (graph, row) units), with an all-padding unit and a fully masked row
    when ``degenerate``."""
    rng = np.random.default_rng(seed)
    col = np.full((U, W), -1, np.int32)
    for u in range(U):
        k = rng.integers(1, W + 1)
        col[u, :k] = rng.choice(nblk, size=k, replace=False)
    gid = rng.integers(0, G, U).astype(np.int32)
    row = rng.integers(0, nblk, U).astype(np.int32)
    masks = rng.random((U, W, B, B)) < 0.3
    if degenerate:
        col[1] = -1
        masks[0, :, 2, :] = False
    ths = rng.standard_normal((G, nblk * B, H)).astype(np.float32)
    thd = rng.standard_normal((G, nblk * B, H)).astype(np.float32)
    hs = rng.standard_normal((nblk * B, H, Dh)).astype(np.float32)
    bias = rng.standard_normal((G, H)).astype(np.float32)
    return col, gid, row, masks, ths, thd, hs, bias


def single_graph_case():
    """tests/test_kernels.py:test_seg_gat_agg_multigraph_vjp_matches_block_autodiff:
    one graph, R = 3 rows in order, unique columns per row."""
    rng = np.random.default_rng(3)
    B, R, W, H, Dh, nblk = 8, 3, 2, 2, 8, 4
    col = np.stack([rng.permutation(nblk)[:W] for _ in range(R)]).astype(np.int32)
    masks = rng.random((R, W, B, B)) < 0.4
    ths = rng.standard_normal((1, nblk * B, H)).astype(np.float32)
    thd = rng.standard_normal((1, R * B, H)).astype(np.float32)
    hs = rng.standard_normal((nblk * B, H, Dh)).astype(np.float32)
    bias = rng.standard_normal((1, H)).astype(np.float32)
    return (col, np.zeros(R, np.int32), np.arange(R, dtype=np.int32), masks, ths, thd, hs, bias)


MULTI_CASES = {
    "single-graph": single_graph_case,
    "seed7": lambda: multigraph_case(7),
    "seed7-degenerate": lambda: multigraph_case(7, degenerate=True),
    "W=1": lambda: multigraph_case(5, W=1, U=3),
    "B=16-Dh=4": lambda: multigraph_case(13, B=16, U=3, W=2, Dh=4, H=3, nblk=3,
                                          degenerate=True),
    # a width whose lane groups in #1/#2 are single floats (Dh % 4 != 0),
    # and the block sizes 64 and 128, which only #1/#2 of the CUDA kernels take
    "H=3-Dh=3": lambda: multigraph_case(29, B=16, U=3, W=3, H=3, Dh=3, nblk=3),
    "B=64": lambda: multigraph_case(17, B=64, U=2, W=2, nblk=3, degenerate=True),
    "B=128": lambda: multigraph_case(19, B=128, U=2, W=2, nblk=2),
}
# units that share their (graph, dst row): #2 sums their d_theta_dst in unit order
REPEATED_UNITS = {"repeated-units": lambda: multigraph_case(31, U=6, W=2, G=1, nblk=2)}
# the card's cases of #1/#2 add a case for each of their kernels' instantiations
# (mg_mod.lane_groups) up to the widest row a warp holds (H·Dh = 1024): among them
# R-GAT's row (H·Dh = 256) and HAN's at the reference trainer's B = 128
CARD_MULTI_CASES = dict(MULTI_CASES, **REPEATED_UNITS, **{
    "H=8-Dh=128": lambda: multigraph_case(23, B=8, U=3, W=2, H=8, Dh=128),
    "H=4-Dh=64": lambda: multigraph_case(43, B=16, U=4, W=3, H=4, Dh=64, degenerate=True),
    "B=128-H=8-Dh=64": lambda: multigraph_case(47, B=128, U=3, W=2, H=8, Dh=64, nblk=3),
    "H=4-Dh=15": lambda: multigraph_case(53, B=16, U=3, W=3, H=4, Dh=15, nblk=3),
    "H=8-Dh=15": lambda: multigraph_case(59, B=8, U=4, W=2, H=8, Dh=15),
    "H=8-Dh=25": lambda: multigraph_case(61, B=32, U=3, W=2, H=8, Dh=25, nblk=3,
                                         degenerate=True)})


def fused_case(seed, *, units=6, width=3, nblk=5, graphs=3, tables=2, din=12, B=8, H=2, DH=4,
                degenerate=False, reach=None, a_scale=1.0):
    """tests/test_fused_fp.py:_rand_tables, with an all-padding unit and a
    fully masked row when ``degenerate``; the units read blocks below
    ``reach`` (default all ``nblk``) only; a_src and a_dst times
    ``a_scale``."""
    rng = np.random.default_rng(seed)
    reach = nblk if reach is None else reach
    col = rng.integers(-1, reach, (units, width)).astype(np.int32)
    col[:, 0] = np.maximum(col[:, 0], 0)
    gid = rng.integers(0, graphs, (units,)).astype(np.int32)
    row = rng.integers(0, reach, (units,)).astype(np.int32)
    wsel = rng.integers(0, tables, (graphs,)).astype(np.int32)
    masks = rng.random((units, width, B, B)) < 0.6
    masks[:, 0, 0, 0] = True
    if degenerate:
        col[1] = -1
        masks[0, :, 2, :] = False
    n = nblk * B
    x = rng.standard_normal((n, din)).astype(np.float32)
    w = (rng.standard_normal((tables, din, H * DH)) / np.sqrt(din)).astype(np.float32)
    b = rng.standard_normal((tables, H * DH)).astype(np.float32) * 0.1
    a_s = (rng.standard_normal((graphs, H, DH)) * a_scale).astype(np.float32)
    a_d = (rng.standard_normal((graphs, H, DH)) * a_scale).astype(np.float32)
    bias = rng.standard_normal((graphs, H)).astype(np.float32) * 0.3
    return col, gid, row, wsel, masks, x, w, b, a_s, a_d, bias


FUSED_CASES = {  # every N_pad here is not a multiple of the 128-row tile of phase P
    "seed2": lambda: fused_case(2),
    "seed1-one-table-degenerate": lambda: fused_case(1, tables=1, degenerate=True),
    "seed3-degenerate": lambda: fused_case(3, degenerate=True),
    "W=1-din=37": lambda: fused_case(4, units=4, width=1, din=37),
    # two tables over 3 row tiles, the units reading blocks 0..9 only: tile 2 unread
    "T=2-B=16-subset": lambda: fused_case(11, units=8, nblk=24, B=16, reach=10,
                                          degenerate=True),
    "B=32-din=37": lambda: fused_case(12, units=5, width=2, nblk=5, B=32, din=37),
    # H·Dh = 9: phase P on the CUDA cores, tiles copied by 4-byte cp.async
    "C=9-T=2-B=16-subset-din=37": lambda: fused_case(16, units=8, nblk=24, B=16, reach=10,
                                                     din=37, H=3, DH=3, degenerate=True),
    "C=9-B=32": lambda: fused_case(17, units=5, width=2, nblk=5, B=32, H=3, DH=3),
}
def reblock_case(B, *, density=0.6, seed=5, units=5, width=2, nblk=3, **kw):
    """``fused_case`` at a block #3 and #4 re-block to 32 (64, 128), masks at
    ``density``, sub-unit (1, 1) (rows 32..63 of unit 1) reading nothing and
    unit 2 padding only."""
    case = list(fused_case(seed, units=units, width=width, nblk=nblk, B=B, **kw))
    rng = np.random.default_rng(seed + 100)
    case[4] = rng.random(case[4].shape) < density
    case[4][:, 0, 0, 0] = True
    case[4][1, :, 32:64, :] = False
    case[0][2] = -1
    return case


REBLOCK_CASES = {
    "B=64": lambda: reblock_case(64),
    "B=128": lambda: reblock_case(128, seed=6, nblk=4),
    "B=128-sparse-C=256": lambda: reblock_case(128, seed=7, density=0.02, nblk=4, DH=128,
                                               din=40, a_scale=128 ** -0.5),
}


# The card's cases of #3 and #4 on both projection routes: FUSED_CASES (H·Dh = 8
# on wgmma, 9 on cuda_cores) and one whole 256-column tile (on wgmma; a at
# 1/sqrt(Dh), so that theta spreads as in the Dh = 4 cases).  Card only: its
# d_a sums cancel to ~1e-2 from terms of ~10, below what the plain version and
# the JAX interpret kernel agree on in float32 at atol 1e-5.
FUSED_ROUTE_CASES = dict(
    FUSED_CASES,
    **{"C=256": lambda: fused_case(13, nblk=12, B=16, DH=128, din=40, a_scale=128 ** -0.5)})
# Phase P's projection on inexact operands (x ~ N(0, 1)), the wgmma route at
# 4 heads of 64 and Din 256: two tables of 3 row tiles (N_pad = 320), the
# units reading blocks 0..13, so tiles 0 and 1 of each table
SPLIT_CASE = dict(seed=16, units=10, width=4, nblk=20, B=16, H=4, DH=64, din=256, reach=14)


def kernel5_case(seed, *, B=8, R=3, W=2, H=2, Dh=8, nblk_src=4, degenerate=False):
    """Single-graph operands of kernel #5 as tests/test_kernels.py makes
    them (unique columns per row, -1 padding, masks at density 0.3) with
    a per-head edge bias; ``degenerate`` adds an all-padding row and a fully
    masked dst row.  Returns (col, masks, theta_src, theta_dst, h_src, bias)."""
    rng = np.random.default_rng(seed)
    col = np.full((R, W), -1, np.int32)
    for r in range(R):
        k = rng.integers(0, min(W, nblk_src) + 1)
        col[r, :k] = rng.choice(nblk_src, size=k, replace=False)
    masks = rng.random((R, W, B, B)) < 0.3
    if degenerate:
        col[0] = -1
        col[1, 0] = max(col[1, 0], 0)
        masks[1, :, 3, :] = False
    ns = nblk_src * B
    ths = rng.standard_normal((ns, H)).astype(np.float32)
    thd = rng.standard_normal((R * B, H)).astype(np.float32)
    hs = rng.standard_normal((ns, H, Dh)).astype(np.float32)
    bias = rng.standard_normal(H).astype(np.float32)
    return col, masks, ths, thd, hs, bias


def padded_row_case():
    """tests/test_kernels.py:test_seg_gat_agg_edge_bias_and_all_padding: the
    second dst-block row is all padding and must come out as exact zeros."""
    rng = np.random.default_rng(0)
    B, R, W, H, Dh = 8, 2, 2, 2, 8
    col = np.array([[0, 1], [-1, -1]], np.int32)
    masks = rng.random((R, W, B, B)) < 0.4
    ths = rng.standard_normal((2 * B, H)).astype(np.float32)
    thd = rng.standard_normal((R * B, H)).astype(np.float32)
    hs = rng.standard_normal((2 * B, H, Dh)).astype(np.float32)
    bias = rng.standard_normal(H).astype(np.float32)
    return col, masks, ths, thd, hs, bias


KERNEL5_CASES = {  # the shapes of tests/test_kernels.py:test_seg_gat_agg_shapes, then edge cases
    "B8-R2-W1-H1-Dh8": lambda: kernel5_case(11, B=8, R=2, W=1, H=1, Dh=8),
    "B8-R3-W2-H2-Dh16": lambda: kernel5_case(13, B=8, R=3, W=2, H=2, Dh=16),
    "B16-R2-W3-H1-Dh32": lambda: kernel5_case(21, B=16, R=2, W=3, H=1, Dh=32),
    "B8-R1-W4-H4-Dh8": lambda: kernel5_case(13, B=8, R=1, W=4, H=4, Dh=8),
    "all-padding-row": padded_row_case,
    "degenerate-B16": lambda: kernel5_case(5, B=16, R=4, W=3, H=4, Dh=16, degenerate=True),
    "B32": lambda: kernel5_case(6, B=32, R=3, W=2, H=2, Dh=8, nblk_src=3, degenerate=True),
    "Ns<Nd": lambda: kernel5_case(7, B=8, R=6, W=2, H=2, Dh=8, nblk_src=2),
    "Ns>Nd": lambda: kernel5_case(8, B=8, R=1, W=5, H=3, Dh=4, nblk_src=6),
    # the block sizes 64 and 128, which the edge walk takes, and a case for
    # each (V, NK) instantiation #5 shares with #1 (mg_mod.lane_groups): among
    # them R-GAT's row (H·Dh = 256) and rows of single-float lane groups
    # (Dh % 4 != 0)
    "B64": lambda: kernel5_case(9, B=64, R=2, W=2, H=2, Dh=8, nblk_src=3, degenerate=True),
    "B128": lambda: kernel5_case(10, B=128, R=2, W=2, H=2, Dh=8, nblk_src=2),
    "B16-H4-Dh64": lambda: kernel5_case(12, B=16, R=3, W=3, H=4, Dh=64, degenerate=True),
    "B128-H8-Dh64": lambda: kernel5_case(14, B=128, R=2, W=2, H=8, Dh=64, nblk_src=3),
    "B8-H8-Dh128": lambda: kernel5_case(15, B=8, R=3, W=2, H=8, Dh=128),
    "B16-H3-Dh3": lambda: kernel5_case(16, B=16, R=3, W=3, H=3, Dh=3, nblk_src=3),
    "B16-H4-Dh15": lambda: kernel5_case(17, B=16, R=3, W=3, H=4, Dh=15, nblk_src=3,
                                        degenerate=True),
    "B8-H8-Dh15": lambda: kernel5_case(18, B=8, R=4, W=2, H=8, Dh=15),
    "B32-H8-Dh25": lambda: kernel5_case(19, B=32, R=3, W=2, H=8, Dh=25, nblk_src=3),
}


@pytest.fixture
def one_thread():
    """PyTorch on one intra-op thread.  On the CPU, torch.exp of a tensor
    large enough to be split across intra-op worker threads has been seen
    to come out within only ~1.5e-4 relative on the workers' share, in
    some processes and not others (the multigraph plain versions' p at
    B = 64 and 128); on one thread it keeps float32 accuracy, so the parity
    tests at those block sizes hold to their tolerances every run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _exact(case):
    """Fused operands on a 1/16 grid: projections and pre-activations are
    exact in float32 whatever the sum order, so the kernel and the plain
    version take the same LeakyReLU branch everywhere."""
    return [np.round(a * 16) / 16 if a.dtype == np.float32 else a for a in case]


def _live_edges(col, masks) -> int:
    return int(masks[col >= 0].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_MULTI_CASES))
def test_multigraph_fwd_kernel_matches_plain_on_cuda(cuda, name):
    """#1 twice bitwise equal, against its plain version, visiting exactly
    the set mask entries of live slots (padding slots' masks hold set bits
    here too)."""
    case = [torch.from_numpy(np.array(a)).to(cuda) for a in CARD_MULTI_CASES[name]()]
    visits = torch.zeros(1, dtype=torch.int32, device=cuda)
    col, gid, row, masks, ths, thd, hs, bias = case
    out, lse = (torch.empty((col.shape[0] * masks.shape[-1], *hs.shape[1:]), device=cuda),
                torch.empty((col.shape[0] * masks.shape[-1], hs.shape[1]), device=cuda))
    mg_mod.launch(*case, out, lse, 0.2, visits=visits)
    again = seg_gat_agg_multigraph_fwd(*case)
    want = seg_gat_agg_multigraph_plain(*case)
    torch.cuda.synchronize()
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    torch.testing.assert_close(out, want[0], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, want[1], atol=1e-4, rtol=1e-4)
    assert int(visits) == _live_edges(col, masks)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_MULTI_CASES))
def test_multigraph_bwd_passes_visit_only_the_edges_on_cuda(cuda, name):
    """The edge index #2's passes walk lists each edge once: pass A the
    unit rows' edges of every (graph, dst block), pass B the src-major
    CSR's; a topology's index gives the bits of one built in the call."""
    case = [torch.from_numpy(np.array(a)).to(cuda) for a in CARD_MULTI_CASES[name]()]
    col, gid, row, masks, ths, thd, hs, bias = case
    out, lse = seg_gat_agg_multigraph_fwd(*case)
    g_out = torch.cos(out)
    index = Topology(col, gid, row, masks, n_graphs=ths.shape[0], ns_pad=ths.shape[1],
                     nd_pad=thd.shape[1]).edge_index()
    got = mg_mod.launch_bwd(*case, g_out, lse, (g_out * out).sum(-1), index, 0.2)
    want = seg_gat_agg_multigraph_bwd(*case, out, lse, g_out)
    torch.cuda.synchronize()
    B = masks.shape[-1]
    rows = (index["gdst"][1].long()[:, None] * B + torch.arange(B, device=cuda)).reshape(-1)
    row_off = index["row_off"].long()
    assert index["E"] == _live_edges(col, masks)
    assert int((row_off[rows + 1] - row_off[rows]).sum()) == index["E"]
    assert int(index["src_off"][-1] - index["src_off"][0]) == index["E"]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(KERNEL5_CASES))
def test_kernel5_equals_the_multigraph_kernel_at_one_graph_on_cuda(cuda, name):
    """#1 walks the set entries only and still gives the bits of the dense
    online-softmax step #5 runs over whole blocks."""
    col, masks, ths, thd, hs, bias = (torch.from_numpy(np.array(a)).to(cuda)
                                      for a in KERNEL5_CASES[name]())
    R = col.shape[0]
    got = seg_gat_agg(col, masks, ths, thd, hs, edge_bias=bias)
    mg, _ = seg_gat_agg_multigraph_fwd(
        col, torch.zeros(R, dtype=torch.int32, device=cuda),
        torch.arange(R, dtype=torch.int32, device=cuda), masks, ths[None], thd[None], hs,
        bias[None].contiguous())
    assert torch.equal(got, mg)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_MULTI_CASES))
def test_multigraph_bwd_kernel_matches_plain_on_cuda(cuda, name):
    case = [torch.from_numpy(np.array(a)).to(cuda) for a in CARD_MULTI_CASES[name]()]
    out, lse = seg_gat_agg_multigraph_fwd(*case)
    g_out = torch.cos(out)
    got = seg_gat_agg_multigraph_bwd(*case, out, lse, g_out)
    again = seg_gat_agg_multigraph_bwd(*case, out, lse, g_out)
    want = seg_gat_agg_multigraph_bwd_plain(*case, out, lse, g_out)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FUSED_CASES))
def test_fused_fp_bwd_kernel_matches_plain_on_cuda(cuda, name):
    case = [torch.from_numpy(np.array(a)).to(cuda) for a in _exact(FUSED_CASES[name]())]
    out, lse = seg_gat_agg_fused_fp_fwd(*case)
    g_out = torch.cos(out)
    got = seg_gat_agg_fused_fp_bwd(*case, out, lse, g_out)
    again = seg_gat_agg_fused_fp_bwd(*case, out, lse, g_out)
    want = seg_gat_agg_fused_fp_bwd_plain(*case, out, lse, g_out)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FUSED_ROUTE_CASES))
def test_fused_fp_kernels_match_plain_on_both_routes(cuda, name):
    """#3 and #4 with phase P on the route their width takes (the cases
    cover both): against their plain versions, twice bitwise equal, one
    launch a call on that route."""
    case = [torch.from_numpy(np.array(a)).to(cuda) for a in _exact(FUSED_ROUTE_CASES[name]())]
    route = fused_ffp.route(*case[8].shape[1:])
    before = (dict(seg_gat_agg_fused_fp_fwd.launches_by_route),
              dict(seg_gat_agg_fused_fp_bwd.launches_by_route))
    got = [seg_gat_agg_fused_fp_fwd(*case) for _ in range(2)]
    want = seg_gat_agg_fused_fp_plain(*case)
    g_out = torch.cos(want[0])
    grads = [seg_gat_agg_fused_fp_bwd(*case, *want, g_out) for _ in range(2)]
    want_grads = seg_gat_agg_fused_fp_bwd_plain(*case, *want, g_out)
    torch.cuda.synchronize()
    for g, a, w in zip(*got, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    for g, a, w in zip(*grads, want_grads):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    for fn, seen in zip((seg_gat_agg_fused_fp_fwd, seg_gat_agg_fused_fp_bwd), before):
        assert {r: n - seen[r] for r, n in fn.launches_by_route.items()} == {
            r: 2 * (r == route) for r in seen}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(REBLOCK_CASES))
def test_fused_fp_kernels_at_b64_and_b128_match_plain(cuda, name):
    """#3 and #4 at a block above 32, re-blocked to 32 on the host: against
    the plain versions at B (another softmax order: atol=rtol=1e-4), twice
    bitwise equal, one launch a call, reading the re-blocked units of the
    topology's fused index when a topology is passed."""
    case = [torch.from_numpy(np.array(a)).to(cuda) for a in _exact(REBLOCK_CASES[name]())]
    col, gid, row, wsel, masks, x, w = case[:7]
    topology = Topology(col, gid, row, masks, n_graphs=wsel.shape[0], ns_pad=x.shape[0],
                        nd_pad=x.shape[0])
    assert topology.fused_index(wsel, w.shape[0])["units"][3].shape[-1] == 32
    before = (seg_gat_agg_fused_fp_fwd.launches, seg_gat_agg_fused_fp_bwd.launches)
    got = [seg_gat_agg_fused_fp_fwd(*case, topology=t) for t in (None, topology)]
    want = seg_gat_agg_fused_fp_plain(*case)
    g_out = torch.cos(want[0])
    grads = [seg_gat_agg_fused_fp_bwd(*case, *want, g_out, topology=t) for t in (None, topology)]
    want_grads = seg_gat_agg_fused_fp_bwd_plain(*case, *want, g_out)
    torch.cuda.synchronize()
    assert (seg_gat_agg_fused_fp_fwd.launches - before[0],
            seg_gat_agg_fused_fp_bwd.launches - before[1]) == (2, 2)
    for g, a, wt in zip(*got, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, wt, atol=1e-4, rtol=1e-4)
    for g, a, wt in zip(*grads, want_grads):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, wt, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_fused_fp_default_route_follows_the_width(cuda):
    """route(): the tensor cores wherever H·Dh is a multiple of 8 (8, 256),
    else the CUDA cores (9, with 4-byte tile copies); each against the
    plain version."""
    odd = fused_case(14, nblk=6, H=3, DH=3, din=20)
    for case, route in ((FUSED_ROUTE_CASES["C=256"](), "wgmma"),
                        (FUSED_ROUTE_CASES["seed2"](), "wgmma"), (odd, "cuda_cores")):
        case = [torch.from_numpy(np.array(a)).to(cuda) for a in _exact(case)]
        before = dict(seg_gat_agg_fused_fp_fwd.launches_by_route)
        got = seg_gat_agg_fused_fp_fwd(*case)
        want = seg_gat_agg_fused_fp_plain(*case)
        torch.cuda.synchronize()
        assert seg_gat_agg_fused_fp_fwd.launches_by_route[route] == before[route] + 1
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_fused_fp_projection_meets_the_split_limit(cuda):
    """Phase P on the wgmma route, on inexact operands: its workspace h over
    the listed rows under SPLIT_ERROR_MAX, which one TF32 product misses
    (tests/test_torch_fused_index.py shows both on these operands); twice
    bitwise equal.  Forward only: h is the same projection in #4."""
    case = [torch.from_numpy(np.array(a)).to(cuda) for a in fused_case(**SPLIT_CASE)]
    col, gid, row, wsel, masks, x, w, b, a_s = case[:9]
    (U, B), (H, Dh) = (col.shape[0], masks.shape[-1]), a_s.shape[1:]
    assert fused_ffp.route(H, Dh) == "wgmma"
    index = Topology(col, gid, row, masks, n_graphs=wsel.shape[0], ns_pad=x.shape[0],
                     nd_pad=x.shape[0]).fused_index(wsel, w.shape[0], backward=False)
    out, lse = torch.empty((U * B, H, Dh), device=cuda), torch.empty((U * B, H), device=cuda)
    hs = [fused_ffp.launch(*case, out, lse, 0.2, index).clone() for _ in range(2)]
    torch.cuda.synchronize()
    err = fused_ffp.projection_split_error(hs[0], index["tiles"], x, w, b)
    assert err <= SPLIT_ERROR_MAX, err
    table, rows = fused_ffp.tile_rows(index["tiles"], x.shape[0])
    assert torch.equal(hs[0][table, rows], hs[1][table, rows])


_RUN = dict(dataset="acm", hidden=8, heads=2, scale=0.05, block=16, max_edges=20_000,
            batch=32, log=lambda *_: None, log_every=1)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["kernel", "reference"])
def test_trainer_on_cuda_matches_cpu(cuda, backend):
    kw = dict(_RUN, block=8, steps=4, backend=backend)
    hist = {dev: hgnn_train.run_training(**{**kw, "device": dev})[1] for dev in ("cpu", "cuda")}
    for c, g in zip(hist["cpu"], hist["cuda"]):
        np.testing.assert_allclose(g["loss"], c["loss"], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernel_training_on_cuda_is_bitwise_repeatable(cuda):
    kw = dict(_RUN, steps=3, device="cuda")
    a, _, _ = hgnn_train.run_training(**kw)
    b, _, _ = hgnn_train.run_training(**kw)
    for (ka, va), (kb, vb) in zip(tree_leaves_with_path(a), tree_leaves_with_path(b)):
        assert ka == kb and torch.equal(va, vb), ka


@pytest.mark.cuda
def test_traced_training_on_cuda_counts_mallocs_and_keeps_the_bits(cuda):
    """The port's tracer, sync off, on the card: every ``train/step`` span
    counts the caching allocator's cudaMalloc calls, the step's phases are
    its children, and the state is the untraced run's bit for bit."""
    kw = dict(_RUN, steps=3, device="cuda")
    a, _, _ = hgnn_train.run_training(**kw)
    tracer = enable_tracing()
    try:
        b, _, _ = hgnn_train.run_training(**kw)
    finally:
        disable_tracing()
    for (ka, va), (kb, vb) in zip(tree_leaves_with_path(a), tree_leaves_with_path(b)):
        assert ka == kb and torch.equal(va, vb), ka
    steps = tracer.spans("train/step")
    assert len(steps) == 3
    assert all(type(e["attrs"]["device_mallocs"]) is int and e["attrs"]["device_mallocs"] >= 0
               for e in steps)
    ids = {e["id"] for e in steps}
    for phase in ("step/forward", "step/backward", "step/optimizer"):
        assert {e["parent_id"] for e in tracer.spans(phase)} == ids, phase


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(KERNEL5_CASES))
def test_kernel5_matches_plain_on_cuda(cuda, name):
    col, masks, ths, thd, hs, bias = (torch.from_numpy(np.array(a)).to(cuda)
                                      for a in KERNEL5_CASES[name]())
    got = seg_gat_agg(col, masks, ths, thd, hs, edge_bias=bias)
    again = seg_gat_agg(col, masks, ths, thd, hs, edge_bias=bias)
    want = seg_gat_agg_plain(col, masks, ths, thd, hs, edge_bias=bias)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    B = masks.shape[-1]
    dead = (col < 0).all(dim=1).repeat_interleave(B)
    assert (got[dead] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(KERNEL5_CASES))
def test_kernel5_visits_exactly_the_live_edges_on_cuda(cuda, name):
    """#5's warps visit the set mask entries of live slots and nothing else
    (padding slots' masks hold set bits here), counted by the kernel."""
    col, masks, ths, thd, hs, bias = (torch.from_numpy(np.array(a)).to(cuda)
                                      for a in KERNEL5_CASES[name]())
    visits = torch.zeros(1, dtype=torch.int32, device=cuda)
    out = torch.empty((thd.shape[0], *hs.shape[1:]), device=cuda)
    k5_mod.launch(col, masks, ths, thd, hs, bias, out, 0.2, visits=visits)
    want = seg_gat_agg(col, masks, ths, thd, hs, edge_bias=bias)
    torch.cuda.synchronize()
    assert int(visits) == _live_edges(col, masks)
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_kernel5_copies_operands_at_unaligned_addresses_on_cuda(cuda):
    """The walk reads h_src rows as float4 and mask rows as 8 bytes: views
    that start off a 16-byte boundary are copied to alignment, and give the
    bits of the aligned operands."""
    col, masks, ths, thd, hs, bias = (torch.from_numpy(np.array(a)).to(cuda)
                                      for a in KERNEL5_CASES["B16-H4-Dh64"]())
    want = seg_gat_agg(col, masks, ths, thd, hs, edge_bias=bias)
    hs_buf = torch.empty(hs.numel() + 1, device=cuda)
    hs_odd = hs_buf[1:].view(hs.shape)
    hs_odd.copy_(hs)
    m_buf = torch.empty(masks.numel() + 3, dtype=torch.bool, device=cuda)
    m_odd = m_buf[3:].view(masks.shape)
    m_odd.copy_(masks)
    assert hs_odd.data_ptr() % 16 and m_odd.data_ptr() % 8
    got = seg_gat_agg(col, m_odd, ths, thd, hs_odd, edge_bias=bias)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel5_refuses_a_block_size_outside_edge_blocks_on_cuda(cuda):
    col, masks, ths, thd, hs, bias = (torch.from_numpy(np.array(a)).to(cuda)
                                      for a in kernel5_case(3, B=4, R=2, W=2))
    with pytest.raises(ValueError, match="block size"):
        seg_gat_agg(col, masks, ths, thd, hs, edge_bias=bias)


def _relation_data(device, block=16):
    g = synthetic_hetgraph("acm", scale=0.05, feat_scale=0.1, seed=0)
    target, ncls = dataset_target("acm")
    return prepare_data(g, relation_semantic_graphs(g), target, ncls,
                        synthetic_labels(g, "acm"), block=block, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", [NABackend.KERNEL, NABackend.SEGMENT], ids=lambda b: b.value)
@pytest.mark.parametrize("name,kw", [
    ("R-GAT", dict(hidden=8, heads=2, layers=2)),
    ("S-HGN", dict(hidden=8, heads=2, layers=2, edge_dim=8)),
])
def test_per_graph_inference_on_cuda_matches_cpu(cuda, name, kw, backend):
    """KERNEL launches #5; SEGMENT runs the segmented reductions on the card."""
    model = MODELS[name]
    cpu, card = _relation_data("cpu"), _relation_data(cuda)
    params = model.init(torch.Generator().manual_seed(0), cpu, **kw)
    with torch.no_grad():
        want = model.forward(params, cpu, backend=backend)
        got = model.forward(tree_map(lambda t: t.to(cuda), params), card, backend=backend)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_han_staged_and_per_graph_backends_on_cuda_match_cpu(cuda):
    problem = dict(scale=0.05, feat_scale=0.1, block=16, max_edges=20_000)
    cpu = hgnn_train.build_problem("acm", device="cpu", **problem)[1]
    card = hgnn_train.build_problem("acm", device=cuda, **problem)[1]
    params = MODELS["HAN"].init(torch.Generator().manual_seed(0), cpu, hidden=8, heads=2,
                                att_dim=16)
    on_card = tree_map(lambda t: t.to(cuda), params)
    with torch.no_grad():
        want = han_forward(params, cpu, backend=NABackend.BLOCK)
        got = [han_forward_staged(on_card, card)]
        got += [han_forward(on_card, card, backend=b) for b in (NABackend.SEGMENT, NABackend.KERNEL)]
    for g in got:
        torch.testing.assert_close(g.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,counter", [(NABackend.KERNEL, "seg_gat_agg"),
                                             (NABackend.MULTIGRAPH, "multigraph")])
def test_characterize_on_cuda_launches_the_kernel_a_graph(cuda, backend, counter):
    """The per-stage pass on the card: #5 (KERNEL) or #1 at G = 1
    (MULTIGRAPH) once a semantic graph, on parameters that require a
    gradient, every stage timed and one NA span a graph on its lane."""
    problem = dict(scale=0.05, feat_scale=0.1, block=16, max_edges=20_000)
    card = hgnn_train.build_problem("acm", device=cuda, **problem)[1]
    params = {k: v.requires_grad_() for k, v in MODELS["HAN"].init(
        torch.Generator().manual_seed(0), card, hidden=8, heads=2, att_dim=16).items()}
    fn = {"seg_gat_agg": seg_gat_agg, "multigraph": seg_gat_agg_multigraph_fwd}[counter]
    fn.launches = 0
    tracer = enable_tracing(sync=True)
    try:
        res = characterize_hgnn(params, card, backend=backend, registry=MetricsRegistry())
    finally:
        disable_tracing()
    assert fn.launches == len(card.graphs)
    assert all(v > 0 for v in res["stage_us"].values())
    for b in card.graphs:
        [span] = tracer.spans(f"char/na/{b.name}")
        assert span["lane"] == f"sg/{b.name}" and span["attrs"]["backend"] == backend.value


@pytest.mark.cuda
def test_rgat_training_on_cuda_matches_cpu_and_repeats(cuda):
    kw = dict(_RUN, model_name="R-GAT", steps=3)
    cpu = hgnn_train.run_training(**{**kw, "device": "cpu"})[1]
    a, hist, meta = hgnn_train.run_training(**{**kw, "device": "cuda"})
    b, _, _ = hgnn_train.run_training(**{**kw, "device": "cuda"})
    assert meta["model"] == "R-GAT" and meta["backend"] == "multigraph"
    for c, g in zip(cpu, hist):
        np.testing.assert_allclose(g["loss"], c["loss"], rtol=1e-4, atol=1e-4)
    for (ka, va), (kb, vb) in zip(tree_leaves_with_path(a), tree_leaves_with_path(b)):
        assert ka == kb and torch.equal(va, vb), ka


# -- multi-lane execution: #1/#2 over a lane plan ------------------------------


def _han_problem(device):
    problem = dict(scale=0.05, feat_scale=0.1, block=16, max_edges=20_000)
    data = hgnn_train.build_problem("acm", device=device, **problem)[1]
    params = MODELS["HAN"].init(torch.Generator().manual_seed(0), data, hidden=8, heads=2,
                                att_dim=16)
    return data, params


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 4, 16])
def test_multilane_kernel_plan_on_cuda(cuda, lanes):
    """HAN over a lane plan on the card: the logits equal MULTIGRAPH's bit
    for bit (#1 computes each unit alone), one #1 and one #2 launch a step,
    the gradients repeat bitwise and match the CPU's plain versions of
    #1/#2 on the same plan (atol=rtol=1e-4)."""
    data, params = _han_problem(cuda)
    plan = build_multilane_plan(data.graphs, lanes)
    cpu_data, _ = _han_problem("cpu")
    cpu_plan = build_multilane_plan(cpu_data.graphs, lanes)
    with torch.no_grad():
        want = han_forward(params, data, backend=NABackend.MULTIGRAPH)
    grads = []
    fwd, bwd = mg_mod.seg_gat_agg_multigraph_fwd, mg_mod.seg_gat_agg_multigraph_bwd
    for _ in range(2):
        fwd.launches = bwd.launches = 0
        leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        logits = han_forward_multilane(leaves, data, plan, backend="kernel")
        loss = logits.square().mean()
        grads.append(torch.autograd.grad(loss, [leaves[k] for k in sorted(leaves)]))
        torch.cuda.synchronize()
        assert torch.equal(logits.detach(), want)
        assert (fwd.launches, bwd.launches) == (1, 1)
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    leaves = {k: v.detach().cpu().requires_grad_() for k, v in params.items()}
    loss = han_forward_multilane(leaves, cpu_data, cpu_plan, backend="kernel").square().mean()
    for got, w in zip(grads[0], torch.autograd.grad(loss, [leaves[k] for k in sorted(leaves)])):
        torch.testing.assert_close(got.cpu(), w, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_multilane_dead_units_change_no_bit_on_cuda(cuda):
    """The plan's lane padding through #1 and #2 on the card: the valid
    units' rows and the gradients are the same bits with the dead units in
    the tables as without them."""
    data, _ = _han_problem(cuda)
    plan = build_multilane_plan(data.graphs, 16)
    valid = torch.from_numpy(plan.valid.reshape(-1)).to(cuda)
    assert not bool(valid.all())
    B = plan.block
    n_pad = plan.n_dst_blocks * B
    g = torch.Generator(device=cuda).manual_seed(0)
    ops = (torch.randn(plan.num_graphs, n_pad, 2, generator=g, device=cuda),
           torch.randn(plan.num_graphs, n_pad, 2, generator=g, device=cuda),
           torch.randn(n_pad, 2, 8, generator=g, device=cuda))
    lu = plan.units()
    full = tuple(torch.from_numpy(a.reshape(-1, *a.shape[2:])).to(cuda) for a in
                 (plan.col_index, plan.graph_id, plan.dst_row, plan.masks))
    cot = torch.randn(lu.count * B, 2, 8, generator=g, device=cuda)
    results = []
    for tables, keep in ((full, valid), ((lu.col_index, lu.graph_id, lu.dst_row, lu.masks), None)):
        leaves = [t.clone().requires_grad_() for t in ops]
        out = seg_gat_agg_multigraph(*tables, *leaves).reshape(-1, B, 2, 8)
        out = (out if keep is None else out[keep]).reshape(-1, 2, 8)
        results.append((out.detach(), torch.autograd.grad((out * cot).sum(), leaves)))
    torch.cuda.synchronize()
    assert torch.equal(results[0][0], results[1][0])
    for a, b in zip(results[0][1], results[1][1]):
        assert torch.equal(a, b)


# -- kernel #7 and the LM decoder ---------------------------------------------

FLASH_CASES = [  # (B, Hq, Hkv, Sq, Sk, Dh, causal, window)
    (2, 4, 2, 32, 32, 16, True, None),     # tests/test_kernels.py's sweep
    (1, 4, 4, 16, 48, 16, True, None),
    (1, 2, 1, 32, 32, 16, True, 8),
    (1, 2, 2, 32, 32, 16, False, None),
    (2, 8, 2, 64, 64, 32, True, None),
    (1, 2, 1, 48, 16, 8, True, None),      # Sq > Sk: rows that see no key
    (1, 24, 8, 1024, 1024, 128, True, None),  # llama3.2-3b's heads
    (1, 4, 1, 512, 512, 256, True, 128),   # recurrentgemma's MQA local attention
    (1, 2, 2, 130, 130, 64, True, None),   # ragged tiles
]


# bf16 cases of the tensor-core route, at llama3.2-3b's heads unless said
WGMMA_CASES = [  # (B, Hq, Hkv, Sq, Sk, Dh, causal, window)
    (1, 24, 8, 130, 130, 128, True, None),    # ragged tiles
    (1, 24, 8, 300, 130, 128, True, None),    # Sq > Sk: rows that see no key
    (1, 24, 8, 130, 400, 128, True, None),    # Sq < Sk
    (1, 24, 8, 1024, 1024, 128, True, 256),   # local window
    (2, 24, 8, 257, 257, 128, False, None),   # bidirectional
    (2, 4, 2, 200, 200, 64, True, None),      # Dh = 64
    (1, 20, 20, 448, 448, 64, True, None),    # whisper's decoder: MHA, 3.5 tiles of 128
    (1, 20, 20, 1024, 1024, 64, False, None),  # whisper's encoder on flash (1,024 frames)
    (1, 28, 4, 512, 512, 128, True, None),    # qwen2-vl-7b's heads: GQA group 7
]


def _flash_check(cuda, case, dtype):
    """#7 twice on seeded operands against its plain version, on the route
    the wrapper picks: two launches there and none on the other route,
    bitwise repeatable, float32 at 1e-4 (sum order), bf16 at 3e-2 and
    within one rounding of the float32 result (atol=1e-4, rtol=8e-3); on
    the wgmma route at least BITWISE_SHARE_MIN of the outputs are that
    rounding bitwise."""
    B, Hq, Hkv, Sq, Sk, Dh, causal, window = case
    rng = np.random.default_rng(Sq + Sk + Dh)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        cuda, getattr(torch, dtype)) for s in ((B, Hq, Sq, Dh), (B, Hkv, Sk, Dh), (B, Hkv, Sk, Dh)))
    before, by_route = flash_attention.launches, dict(flash_attention.launches_by_route)
    got = flash_attention(q, k, v, causal=causal, window=window)
    again = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    route = flash_route(q.dtype, Dh)
    assert {r: n - by_route[r] for r, n in flash_attention.launches_by_route.items()} == {
        r: 2 * (r == route) for r in by_route}
    assert torch.equal(got, again)
    tol = 1e-4 if dtype == "float32" else 3e-2  # float32 sum order; one bf16 rounding
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == "bfloat16":
        torch.testing.assert_close(got.float(), want.float(), atol=1e-4, rtol=8e-3)
    if route == "wgmma":  # p split: nearly every output is the rounded float32 result
        assert float((got == want).float().mean()) >= BITWISE_SHARE_MIN
    if Sq > Sk:
        assert (got[:, :, : Sq - Sk] == 0).all()
    return route


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_kernel_matches_plain_on_cuda(cuda, case, dtype):
    _flash_check(cuda, case, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_CASES, ids=str)
def test_flash_attention_tensor_core_route_matches_plain_on_cuda(cuda, case):
    assert _flash_check(cuda, case, "bfloat16") == "wgmma"


@pytest.mark.cuda
def test_lm_forward_and_greedy_on_cuda_match_cpu(cuda):
    """llama3.2-3b's smoke config (float32): flash forward (#7 once per
    layer) and xla forward against the CPU at 1e-4, greedy tokens equal."""
    cfg = smoke_config("llama3.2-3b")
    api = build_lm(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    on_card = tree_map(lambda t: t.to(cuda), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    for impl in ("xla", "flash"):
        before = flash_attention.launches
        got, _ = api.forward(on_card, toks.to(cuda), impl=impl)
        want, _ = api.forward(params, toks, impl=impl)
        assert flash_attention.launches - before == (cfg.num_layers if impl == "flash" else 0)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    out = greedy_generate(api, on_card, toks[:, :8].to(cuda), steps=6, cache_len=15)
    assert torch.equal(out.cpu(), greedy_generate(api, params, toks[:, :8], steps=6, cache_len=15))


@pytest.mark.cuda
def test_moe_forward_on_cuda_matches_cpu(cuda):
    """dbrx-132b's smoke config (float32, 4 experts top-2) at S = 64 with
    half the default capacity (copies dropped): flash (#7 once a layer)
    and xla forwards on the card against the CPU.  Every (layer, token)
    route is the same experts or a near-tie in both runs
    (``moe.route_flips``); logits at 1e-4 on the tokens whose routes agree
    in every layer, the aux loss at 1e-5; the card's forward is bitwise
    repeatable."""
    cfg = dataclasses.replace(smoke_config("dbrx-132b"), moe_capacity_factor=0.5)
    api = build_lm(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    on_card = tree_map(lambda t: t.to(cuda), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(1))
    for impl in ("xla", "flash"):
        card, cpu, again = [], [], []
        before = flash_attention.launches
        got, aux = api.forward(on_card, toks.to(cuda), impl=impl, routes=card)
        assert flash_attention.launches - before == (cfg.num_layers if impl == "flash" else 0)
        want, want_aux = api.forward(params, toks, impl=impl, routes=cpu)
        assert not all(r.keep.all() for r in cpu)  # capacity 0.5 drops copies
        flipped, unexplained = moe.route_flips(
            torch.stack([r.expert_ids for r in card]).cpu(), torch.stack([r.gap for r in card]).cpu(),
            torch.stack([r.expert_ids for r in cpu]), torch.stack([r.gap for r in cpu]),
            torch.float32)
        assert not unexplained.any(), unexplained.nonzero().tolist()
        agree = ~flipped.any(0)
        torch.testing.assert_close(got.cpu()[agree], want[agree], atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-5, rtol=1e-5)
        got2, aux2 = api.forward(on_card, toks.to(cuda), impl=impl, routes=again)
        assert torch.equal(got, got2) and torch.equal(aux, aux2)
        assert all(torch.equal(a.table, b.table) for a, b in zip(card, again))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b"])
def test_recurrent_forward_decode_and_batcher_on_cuda_match_cpu(cuda, arch):
    """The recurrent families' smoke configs (float32) at S = 24, past
    recurrentgemma's window of 8: flash and xla forwards on the card
    against the CPU at 1e-4 (#7 once a local layer on flash, none for
    mamba2), bitwise repeatable; decode on the card against its own
    forward at 5e-4; greedy tokens and the batcher's (3 slots, 5
    requests) equal to the CPU's."""
    cfg = smoke_config(arch)
    api = build_lm(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    on_card = tree_map(lambda t: t.to(cuda), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(1))
    n_local = sum(cfg.pattern_for_layer(i) == "local" for i in range(cfg.num_layers))
    for impl in ("xla", "flash"):
        before = flash_attention.launches
        got, _ = api.forward(on_card, toks.to(cuda), impl=impl)
        assert flash_attention.launches - before == (n_local if impl == "flash" else 0)
        want, _ = api.forward(params, toks, impl=impl)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        assert torch.equal(got, api.forward(on_card, toks.to(cuda), impl=impl)[0])
    caches = api.init_caches(2, 24, torch.float32, device=cuda)
    outs = []
    for t in range(24):
        lg, caches = api.decode(on_card, toks[:, t:t + 1].to(cuda), t, caches)
        outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, 1), got, atol=5e-4, rtol=5e-4)
    out = greedy_generate(api, on_card, toks[:, :8].to(cuda), steps=6, cache_len=15)
    assert torch.equal(out.cpu(), greedy_generate(api, params, toks[:, :8], steps=6, cache_len=15))
    jobs = [(toks[i % 2, i:i + 4 + i % 3].tolist(), 3 + i % 2) for i in range(5)]
    runs = []
    for dev, p in ((cuda, on_card), ("cpu", params)):
        cb = ContinuousBatcher(api, 3, 16, p, device=dev)
        for i, (prompt, m) in enumerate(jobs):
            cb.submit(Request(rid=i, prompt=prompt, max_new=m))
        runs.append({r.rid: r.out for r in cb.run()})
    assert runs[0] == runs[1] and len(runs[0]) == len(jobs)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-large-v3"])
def test_vlm_and_encdec_forward_decode_and_batcher_on_cuda_match_cpu(cuda, arch):
    """The VLM's smoke config (M-RoPE, 4 visual slots at distinct (t, h, w)
    positions) and the encoder-decoder's (16 seeded frames), float32:
    flash and xla forwards on the card against the CPU at 1e-4 (#7 once an
    attention layer on flash: the decoder's, and the encoder's at
    causal=False), bitwise repeatable; decode on the card against its own
    forward at 5e-4 (the encoder-decoder's from prefill's cross K/V);
    greedy tokens and the batcher's (3 slots, 5 requests) equal to the
    CPU's."""
    cfg = smoke_config(arch)
    api = build_lm(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    on_card = tree_map(lambda t: t.to(cuda), params)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen)
    if cfg.is_encoder_decoder:
        kw = {"frames": torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen)}
        n_attn = cfg.encoder_layers + cfg.num_layers
    else:
        pos = torch.arange(24, dtype=torch.int32)[:, None].repeat(1, 3) - 2
        pos[:4] = torch.tensor([[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1]])  # a 2 x 2 grid
        kw = {"positions": pos.expand(2, 24, 3),
              "visual_embeds": 0.5 * torch.randn((2, 4, cfg.d_model), generator=gen)}
        n_attn = cfg.num_layers
    card_kw = {k: v.to(cuda) for k, v in kw.items()}
    for impl in ("xla", "flash"):
        before = flash_attention.launches
        got, _ = api.forward(on_card, toks.to(cuda), impl=impl, **card_kw)
        assert flash_attention.launches - before == (n_attn if impl == "flash" else 0)
        want, _ = api.forward(params, toks, impl=impl, **kw)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        assert torch.equal(got, api.forward(on_card, toks.to(cuda), impl=impl, **card_kw)[0])
    state = init_serve_state(api, 2, 24, dtype=torch.float32, device=cuda)
    if cfg.is_encoder_decoder:  # decode from prefill's cross K/V against the forward
        full, _ = api.forward(on_card, toks.to(cuda), **card_kw)
        lg, state = make_prefill(api)(on_card, state, toks[:, :1].to(cuda), card_kw["frames"])
        outs, first = [lg[:, None]], 1
    else:
        full, _ = api.forward(on_card, toks.to(cuda))
        outs, first = [], 0
    step = make_serve_step(api)
    for t in range(first, 24):
        lg, state = step(on_card, state, toks[:, t:t + 1].to(cuda))
        outs.append(lg[:, None])
    torch.testing.assert_close(torch.cat(outs, 1), full, atol=5e-4, rtol=5e-4)
    out = greedy_generate(api, on_card, toks[:, :8].to(cuda), steps=6, cache_len=15)
    assert torch.equal(out.cpu(), greedy_generate(api, params, toks[:, :8], steps=6, cache_len=15))
    jobs = [(toks[i % 2, i:i + 4 + i % 3].tolist(), 3 + i % 2) for i in range(5)]
    runs = []
    for dev, p in ((cuda, on_card), ("cpu", params)):
        cb = ContinuousBatcher(api, 3, 16, p, device=dev)
        for i, (prompt, m) in enumerate(jobs):
            cb.submit(Request(rid=i, prompt=prompt, max_new=m))
        runs.append({r.rid: r.out for r in cb.run()})
    assert runs[0] == runs[1] and len(runs[0]) == len(jobs)


# -- kernel #6, the KERNEL backend's FP+θ -----------------------------------------

KERNEL6_CASES = {  # (N, Din, H, Dh, dtype)
    "f32 R-GAT heads": (300, 517, 4, 64, "float32"),
    "bf16 Dh=128": (257, 130, 2, 128, "bfloat16"),
    "f32 ragged": (1001, 37, 4, 16, "float32"),
}


def kernel6_operands(N, Din, H, Dh, dtype, device):
    rng = np.random.default_rng(N + Din)
    return [torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32)).to(
                device, getattr(torch, dtype))
            for s, sc in (((N, Din), 0.5), ((Din, H * Dh), 0.1), ((H * Dh,), 0.1), ((H, Dh), 1.0),
                          ((H, Dh), 1.0))]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(KERNEL6_CASES))
def test_kernel6_matches_plain_on_cuda(cuda, name):
    N, Din, H, Dh, dtype = KERNEL6_CASES[name]
    x, w, b, a_s, a_d = kernel6_operands(N, Din, H, Dh, dtype, cuda)
    before = fused_fp_coeff.launches
    got = fused_fp_coeff(x, w, b, a_s, a_d)
    again = fused_fp_coeff(x, w, b, a_s, a_d)
    want = fused_fp_coeff_plain(x, w, b, a_s, a_d)
    torch.cuda.synchronize()
    assert fused_fp_coeff.launches == before + 2
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    h_tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(atol=1e-5, rtol=8e-3)
    torch.testing.assert_close(got[0].float(), want[0].float(), **h_tol)  # bf16: one rounding
    for g, w_ in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w_, atol=1e-4, rtol=1e-4)


KERNEL6_WGMMA_CASES = {  # (N, Din, H, Dh): R-GAT's layer-0 projections, layer 1, ragged ones
    "actor": (6124, 3341, 4, 64),
    "movie": (4932, 3489, 4, 64),
    "director": (2393, 3341, 4, 64),
    "keyword": (7971, 64, 4, 64),
    "layer 1": (4932, 256, 4, 64),
    "ragged Dh=16": (1001, 37, 4, 16),
    "ragged Dh=8 C=96": (130, 1030, 12, 8),
    "Dh=128 C=384": (700, 600, 3, 128),
    "a full wave, K=2048": (17_000, 2048, 4, 64),  # S = 1: two accumulator chains of 1,024
    "a full wave, K=3341": (17_000, 3341, 4, 64),  # S = 1: four chains
}


def main_path_operands(N, Din, H, Dh, device):
    """Operands at the scale R-GAT's KERNEL path gives #6: x ~ N(0, 0.1²)
    as the synthetic graphs' features, w and a Glorot-uniform as
    ``init_rgat`` draws them, and a bias ~ N(0, 0.1²)."""
    rng = np.random.default_rng(N + Din)
    lim_w, lim_a = np.sqrt(6 / (Din + H * Dh)), np.sqrt(6 / (H + Dh))
    arrays = (rng.standard_normal((N, Din)) * 0.1, rng.uniform(-lim_w, lim_w, (Din, H * Dh)),
              rng.standard_normal(H * Dh) * 0.1, rng.uniform(-lim_a, lim_a, (H, Dh)),
              rng.uniform(-lim_a, lim_a, (H, Dh)))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(KERNEL6_WGMMA_CASES))
def test_kernel6_tensor_core_route_matches_plain_on_cuda(cuda, name):
    """float32 takes the wgmma route: at the main path's operand scale the
    plain version's tolerance; twice bitwise equal; the split's error limit
    (scale-free); both launches on that route."""
    N, Din, H, Dh = KERNEL6_WGMMA_CASES[name]
    x, w, b, a_s, a_d = main_path_operands(N, Din, H, Dh, cuda)
    assert kernel6_route(x.dtype, Dh) == "wgmma"
    before = dict(fused_fp_coeff.launches_by_route)
    got = fused_fp_coeff(x, w, b, a_s, a_d)
    again = fused_fp_coeff(x, w, b, a_s, a_d)
    want = fused_fp_coeff_plain(x, w, b, a_s, a_d)
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in fused_fp_coeff.launches_by_route.items()} == {
        "wgmma": 2, "cuda_cores": 0}
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, atol=1e-4, rtol=1e-4)
    assert split_error(got[0], x, w, b) <= SPLIT_ERROR_MAX


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["actor", "layer 1", "ragged Dh=8 C=96", "a full wave, K=2048"])
def test_kernel6_split_error_holds_at_a_larger_scale_on_cuda(cuda, name):
    """x ~ N(0, 0.5²) and w ~ N(0, 0.1²) (the other kernel tests' operands):
    |h| and |θ| grow about 10x, and the normalised error stays under
    SPLIT_ERROR_MAX."""
    N, Din, H, Dh = KERNEL6_WGMMA_CASES[name]
    x, w, b, a_s, a_d = kernel6_operands(N, Din, H, Dh, "float32", cuda)
    h, _, _ = fused_fp_coeff(x, w, b, a_s, a_d)
    assert split_error(h, x, w, b) <= SPLIT_ERROR_MAX


@pytest.mark.cuda
def test_kernel6_cuda_core_route_forced_on_float32(cuda):
    x, w, b, a_s, a_d = kernel6_operands(2393, 3341, 4, 64, "float32", cuda)
    h = torch.empty(x.shape[0], 256, device=cuda)
    ts, td = torch.empty(x.shape[0], 4, device=cuda), torch.empty(x.shape[0], 4, device=cuda)
    before = dict(fused_fp_coeff.launches_by_route)
    kernel6_launch(x, w, b, a_s, a_d, h, ts, td, route_="cuda_cores")
    want = fused_fp_coeff_plain(x, w, b, a_s, a_d)
    torch.cuda.synchronize()
    assert fused_fp_coeff.launches_by_route["cuda_cores"] == before["cuda_cores"] + 1
    for g, w_ in zip((h, ts, td), want):
        torch.testing.assert_close(g, w_, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_rgat_kernel_backend_at_its_width_runs_kernel6_on_the_tensor_cores(cuda):
    """R-GAT at its own width (4 heads of 64, 3 layers): two launches of #6
    a live relation pass (``live_relations``), every one on the wgmma
    route; logits against BLOCK."""
    g = synthetic_hetgraph("imdb", scale=0.05, feat_scale=0.5, seed=0)
    data = prepare_data(g, relation_semantic_graphs(g), "movie", 3, synthetic_labels(g, "imdb"),
                        block=16, device=cuda)
    params = MODELS["R-GAT"].init(torch.Generator().manual_seed(0), data, hidden=64, heads=4,
                                  layers=3)
    params = tree_map(lambda t: t.to(cuda), params)
    before = dict(fused_fp_coeff.launches_by_route)
    with torch.no_grad():
        got = MODELS["R-GAT"].forward(params, data, backend=NABackend.KERNEL)
        ran = {r: n - before[r] for r, n in fused_fp_coeff.launches_by_route.items()}
        want = MODELS["R-GAT"].forward(params, data, backend=NABackend.BLOCK)
    passes = sum(len(live) for live, _ in live_relations(data.graphs, "movie", 3))
    assert ran == {"wgmma": 2 * passes, "cuda_cores": 0}
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_rgat_kernel_backend_launches_kernel6_per_relation_and_layer(cuda):
    """R-GAT (3 layers) on small IMDB's six relation graphs: #6 launches
    twice (src and dst side) and #5 once a live relation pass
    (``live_relations``), and the logits match the CPU."""
    g = synthetic_hetgraph("imdb", scale=0.05, feat_scale=0.02, seed=0)
    cpu, card = (prepare_data(g, relation_semantic_graphs(g), "movie", 3,
                              synthetic_labels(g, "imdb"), block=16, device=d)
                 for d in ("cpu", cuda))
    params = MODELS["R-GAT"].init(torch.Generator().manual_seed(0), cpu, hidden=8, heads=2,
                                  layers=3)
    before6, before5 = fused_fp_coeff.launches, seg_gat_agg.launches
    with torch.no_grad():
        got = MODELS["R-GAT"].forward(tree_map(lambda t: t.to(cuda), params), card,
                                      backend=NABackend.KERNEL)
        want = MODELS["R-GAT"].forward(params, cpu, backend=NABackend.KERNEL)
    assert len(card.graphs) == 6
    passes = sum(len(live) for live, _ in live_relations(card.graphs, "movie", 3))
    assert fused_fp_coeff.launches - before6 == 2 * passes
    assert seg_gat_agg.launches - before5 == passes
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
