"""AdamW as one kernel pair (``kernels/fused_adamw.py``, ``csrc/fused_adamw.cu``).

On the CPU: the dispatch in ``optim.adamw`` (CPU leaves, the factored mode
and sharded leaves keep the loop and launch nothing; leaves on the card
take the kernels, which raise on operands they do not take), the launch
plan and
the leaf table the wrapper packs, and the HGNN step's constant learning
rate, built once.  On the card (``cuda`` marker; this file imports no
JAX): five steps on HAN's 9-leaf tree and R-GAT's 66-leaf tree (the
benchmark's ``han-dblp`` and ``rgat-mag`` widths) against the loop, every
leaf within 1e-6 of its largest magnitude; the loop's bits given the
kernels' norm (float32, and bfloat16 params with a float32 master and
bfloat16 moments); two runs bitwise equal; ``apply_updates`` leaving its
inputs as they are and ``apply_updates_`` giving its bits in place; a tree
wider than one launch's parameter struct; and the HGNN trainer's
``step/optimizer`` under ``torch.cuda.set_sync_debug_mode("error")``."""
import contextlib
import dataclasses
import importlib

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch import hgnn_train
from repro_torch.models.hgnn.common import HGNNData
from repro_torch.optim import AdamWConfig, apply_updates, apply_updates_, init_opt_state
from repro_torch.optim import adamw
from repro_torch.train import hgnn as train_hgnn
from repro_torch.tree import tree_leaves, tree_leaves_at, tree_map

fa = importlib.import_module("repro_torch.kernels.fused_adamw")

# the benchmark's trees: han-dblp (334-wide authors, 8 heads of 8, three
# metapaths, semantic attention 128, 4 classes) and rgat-mag (two layers of
# 4 heads of 64 over 7 relation graphs and 4 vertex types, 128-wide
# features, 349 classes)
HAN_SHAPES = [(334, 64), (64,), (3, 8, 8), (3, 8, 8), (64, 128), (128,), (128, 1), (64, 4), (4,)]


def rgat_shapes(c=256, heads=4, hidden=64, rels=7, types=4, feat=128, classes=349):
    shapes = []
    for layer in range(2):
        d = feat if layer == 0 else c
        shapes += [(d, c), (d, c), (heads, hidden), (heads, hidden)] * rels + [(d, c)] * types
    return shapes + [(c, classes), (classes,)]


TREES = {"han-dblp": HAN_SHAPES, "rgat-mag": rgat_shapes()}
CFG = AdamWConfig(lr=5e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0, grad_clip=1.0)


def _tree(shapes, rng, dtype=torch.float32, device="cpu", scale=1.0):
    return {f"w{i:03d}": torch.from_numpy(rng.standard_normal(s).astype(np.float32) * scale)
            .to(device=device, dtype=dtype) for i, s in enumerate(shapes)}


def _state(shapes, cfg, seed=0, dtype=torch.float32, device="cpu"):
    params = _tree(shapes, np.random.default_rng(seed), dtype, device)
    return params, init_opt_state(params, cfg)


def _grads(shapes, step, dtype=torch.float32, device="cpu"):
    # norms well above the clip, so every step scales its gradient
    return _tree(shapes, np.random.default_rng(1000 + step), dtype, device, scale=0.1)


def _leaves(params, grads, state):
    return adamw._leaves(params, grads, state)


# -- on the CPU: dispatch ------------------------------------------------------


@pytest.mark.parametrize("mode", ["cpu", "factored"])
def test_cpu_leaves_and_the_factored_mode_take_the_loop(mode, monkeypatch):
    """CPU leaves keep the loop; so does the factored mode even where the
    kernels would take the operands.  No launch is counted."""
    cfg = dataclasses.replace(CFG, factored=mode == "factored")
    if mode == "factored":
        monkeypatch.setattr(adamw, "on_card", lambda flat: True)
    params, state = _state(HAN_SHAPES, cfg)
    grads = _grads(HAN_SHAPES, 0)
    before = (fa.fused_adamw.launches, fa.fused_adamw.leaves)
    lr = torch.tensor(CFG.lr)
    p1, s1, n1 = apply_updates(params, grads, state, cfg, lr)
    p2, s2, n2 = apply_updates_(params, grads, state, cfg, lr)
    assert (fa.fused_adamw.launches, fa.fused_adamw.leaves) == before
    assert torch.equal(n1, n2) and int(s2["count"]) == 1
    for a, b in zip(tree_leaves((p1, s1)), tree_leaves((p2, s2))):
        assert torch.equal(a, b)


def test_cpu_leaves_are_not_the_kernels():
    params, state = _state(HAN_SHAPES, CFG)
    leaves = _leaves(params, _grads(HAN_SHAPES, 0), state)
    assert not fa.on_card(leaves[0]) and not fa.on_card([])
    assert not adamw._fused(leaves[0], None, None)


@pytest.mark.parametrize("placement, fused", [
    (None, True), ((Replicate(),), True), ((Shard(0),), False), ((Replicate(), Shard(1)), False)])
def test_a_sharded_leaf_keeps_the_loop(placement, fused, monkeypatch):
    """With leaves on the card (``on_card`` stubbed: these lie on the
    CPU), the step takes the kernels unless a placement shards a leaf;
    replicated placements keep the kernels."""
    monkeypatch.setattr(adamw, "on_card", lambda flat: True)
    params, state = _state(HAN_SHAPES, CFG)
    leaves = _leaves(params, _grads(HAN_SHAPES, 0), state)
    placements = mesh = None
    if placement is not None:
        width = len(placement)
        placements = {k: (placement if k == "w003" else (Replicate(),) * width) for k in params}
        mesh = object()  # only its presence is read before any collective
    assert adamw._fused(leaves[0], placements, mesh) is fused
    assert adamw._fused(leaves[0], placements, None) is True


def _as_if_on_card(monkeypatch):
    """CPU leaves taken for leaves on the card, by the optimizer's dispatch
    and by the wrapper's."""
    monkeypatch.setattr(adamw, "on_card", lambda flat: True)
    monkeypatch.setattr(fa, "on_card", lambda flat: True)


@pytest.mark.parametrize("in_place", [False, True])
def test_leaves_on_the_card_take_the_kernels(in_place, monkeypatch):
    """Both updates hand leaves on the card to the kernels' launch, in
    ``tree_leaves`` order, and rebuild the trees from what it returns."""
    params, state = _state(HAN_SHAPES, CFG)
    grads = _grads(HAN_SHAPES, 0)
    lr = torch.tensor(CFG.lr)
    want_p, want_s, want_n = apply_updates(params, grads, state, CFG, lr)  # the loop
    _as_if_on_card(monkeypatch)
    calls = []

    def launch(cfg, lr, *args, in_place):
        calls.append(in_place)
        return fa.fused_adamw_plain(cfg, lr, *args, in_place=in_place)

    monkeypatch.setattr(fa, "_launch", launch)
    update = apply_updates_ if in_place else apply_updates
    got_p, got_s, got_n = update(params, grads, state, CFG, lr)
    assert calls == [in_place]
    assert (got_p is params) == in_place and torch.equal(got_n, want_n)
    for a, b in zip(tree_leaves((got_p, got_s)), tree_leaves((want_p, want_s))):
        assert torch.equal(a, b)


def _operands(fault):
    params, state = _state(HAN_SHAPES, CFG)
    grads = _grads(HAN_SHAPES, 0)
    lr = torch.tensor(CFG.lr)
    if fault == "float16 param":
        params["w002"] = params["w002"].half()
    elif fault == "float64 grad":
        grads["w004"] = grads["w004"].double()
    elif fault == "float16 moments":
        state["m"] = tree_map(lambda t: t.half(), state["m"])
        state["v"] = tree_map(lambda t: t.half(), state["v"])
    elif fault == "non-contiguous m":
        state["m"]["w000"] = state["m"]["w000"].t().contiguous().t()
    elif fault == "int64 count":
        state["count"] = state["count"].long()
    elif fault == "float64 lr":
        lr = lr.double()
    elif fault == "float lr":
        lr = CFG.lr
    return params, grads, state, lr


FAULTS = {"float16 param": "param torch.float16", "float64 grad": "grad torch.float64",
          "float16 moments": "moments in torch.float16", "non-contiguous m": "not contiguous",
          "int64 count": "count: torch.int64", "float64 lr": "lr: torch.float64",
          "float lr": "lr is a float"}


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_leaves_on_the_card_the_kernels_do_not_take_raise(fault, in_place, monkeypatch):
    """On the card an operand the kernels do not take raises; nothing
    falls back to the loop, nothing is written and nothing launches."""
    _as_if_on_card(monkeypatch)
    params, grads, state, lr = _operands(fault)
    before = [t.clone() for t in tree_leaves((params, state))]
    launches = fa.fused_adamw.launches
    update = apply_updates_ if in_place else apply_updates
    with pytest.raises(TypeError, match=FAULTS[fault]):
        update(params, grads, state, CFG, lr)
    assert fa.fused_adamw.launches == launches
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves((params, state))))


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    """``fused_adamw`` on CPU leaves is the loop, in place and out of place."""
    params, state = _state(HAN_SHAPES, CFG)
    grads = _grads(HAN_SHAPES, 0)
    leaves = _leaves(params, grads, state)
    before = [t.clone() for t in tree_leaves((params, state))]
    lr = torch.tensor(CFG.lr)
    out = fa.fused_adamw(CFG, lr, *leaves, state["count"], in_place=False)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves((params, state))))
    want_p, want_s, want_n = apply_updates(params, grads, state, CFG, lr)
    got = fa.fused_adamw(CFG, lr, *leaves, state["count"], in_place=True)
    for ps, m, v, count, n in ((out[0], out[1], out[2], out[4], out[5]),
                               (got[0], got[1], got[2], got[4], got[5])):
        assert torch.equal(n, want_n) and torch.equal(count, want_s["count"])
        for a, b in zip(ps + m + v, tree_leaves(want_p) + tree_leaves(want_s["m"])
                        + tree_leaves(want_s["v"])):
            assert torch.equal(a, b)
    assert got[0][0] is leaves[0][0]


@dataclasses.dataclass
class _Node:
    b: object
    a: object


def test_tree_leaves_at_follows_the_leaf_order():
    """The optimizer gathers each state tree at the params' leaves with
    ``tree.tree_leaves_at``: the entries in ``tree_leaves`` order, None
    where the tree holds None (a float32 param's master slot)."""
    like = {"z": [1, (2, 3)], "a": {"y": 4, "b": None}, "m": _Node(b=5, a=[6])}
    tree = {"z": ["z0", ("z1", None)], "a": {"y": "ay", "b": None}, "m": _Node(b="mb", a=["ma"])}
    assert tree_leaves(like) == [4, 5, 6, 1, 2, 3]
    assert tree_leaves_at(like, tree) == ["ay", "mb", "ma", "z0", "z1", None]
    params, state = _state(HAN_SHAPES, CFG)
    assert [t is s for t, s in zip(tree_leaves_at(params, state["m"]),
                                   tree_leaves(state["m"]))] == [True] * len(HAN_SHAPES)
    assert tree_leaves_at(params, state["master"]) == [None] * len(HAN_SHAPES)


# -- on the CPU: the launch plan and the leaf table ------------------------------


def _leaf_of(group: "fa.Group", b: int) -> int:
    """csrc/fused_adamw.cu's leaf_of: the last leaf whose first chunk is <= b."""
    lo, hi = 0, group.stop - group.start - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if group.first_chunk[mid] <= b:
            lo = mid
        else:
            hi = mid - 1
    return lo


@pytest.mark.parametrize("sizes, max_leaves", [
    ((1,), 300),
    ((0,), 300),
    ((0, 1, 0, 0, 8192, 8193, 1, 0), 3),
    ((5, 0, 0, 17, 3), 1),
    (tuple(range(0, 700)), 300),
    ((10_000_000, 1, 0, 3_000_000), 2),
    ((0, 0, 0), 2),
])
def test_plan_cuts_every_element_once_into_leaf_aligned_chunks(sizes, max_leaves):
    plan = fa.plan(sizes, max_leaves)
    assert plan.chunk >= fa.MIN_CHUNK
    assert plan.n_slots == sum(-(-n // plan.chunk) for n in sizes)
    assert plan.n_slots <= fa.TARGET_SLOTS + len(sizes)
    assert [(g.start, g.stop) for g in plan.groups] == [
        (s, min(s + max_leaves, len(sizes))) for s in range(0, len(sizes), max_leaves)]
    slot = 0
    for g in plan.groups:
        assert g.slot0 == slot and len(g.first_chunk) == g.stop - g.start
        covered = {i: [] for i in range(g.start, g.stop)}
        for b in range(g.n_chunks):  # the blocks of both passes
            k = _leaf_of(g, b)
            n = sizes[g.start + k]
            c = b - g.first_chunk[k]
            lo, hi = c * plan.chunk, min((c + 1) * plan.chunk, n)
            assert 0 <= lo < hi <= n, (b, k)
            covered[g.start + k].append((lo, hi))
        for i, spans in covered.items():  # each leaf's chunks tile it, in order
            assert [lo for lo, _ in spans] == list(range(0, sizes[i], plan.chunk))
            assert (spans[-1][1] if spans else 0) == sizes[i]
        slot += g.n_chunks
    assert slot == plan.n_slots


def test_plan_rejects_a_bad_width():
    with pytest.raises(ValueError, match="max_leaves"):
        fa.plan((1, 2), 0)
    with pytest.raises(ValueError, match="negative"):
        fa.plan((1, -2))


def test_leaf_table_holds_the_struct_words():
    """One row of twelve words a leaf: the input and output pointers (0 for
    no master), the size, the first chunk and the dtype flags."""
    p = [torch.zeros(5, dtype=torch.bfloat16), torch.zeros(0), torch.zeros(1)]
    g = [torch.zeros(5), torch.zeros(0), torch.zeros(1, dtype=torch.bfloat16)]
    m = [torch.zeros(5), torch.zeros(0), torch.zeros(1)]
    v = [torch.zeros(5), torch.zeros(0), torch.zeros(1)]
    master = [torch.zeros(5), None, None]
    outs = ([t.clone() for t in p], [t.clone() for t in m], [t.clone() for t in v],
            [master[0].clone(), None, None])
    plan = fa.plan(tuple(t.numel() for t in p))
    [group] = plan.groups
    table = fa._table(group, (p, g, m, v, master), outs)
    assert table.shape == (3, 12) and table.dtype == np.int64
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    for i in range(3):
        want = [ptr(x[i]) for x in (p, g, m, v, master, *outs)]
        assert table[i, :9].tolist() == want
    assert table[:, 9].tolist() == [5, 0, 1]
    assert table[:, 10].tolist() == list(group.first_chunk) == [0, 1, 1]
    assert table[:, 11].tolist() == [fa._PARAM_BF16 | fa._MASTER, 0, fa._GRAD_BF16]


# -- on the CPU: the HGNN step's learning rate ----------------------------------


def test_hgnn_step_builds_its_constant_lr_once(monkeypatch):
    """``make_hgnn_train_step`` without a schedule builds its lr tensor
    when it is made, not once a step (on the card, a copy to it each)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((6, 3)).astype(np.float32))
    data = HGNNData(features={"a": x}, graphs=[], target_type="a", num_classes=2,
                    labels=torch.tensor([0, 1, 1, 0, 1, 0]))
    params = {"w": torch.zeros(3, 2)}
    state = train_hgnn.TrainState(params=params, opt=init_opt_state(params, CFG),
                                  step=torch.zeros((), dtype=torch.int32))
    real, made = torch.tensor, []

    def counting(data, *a, **k):
        if isinstance(data, float) and data == CFG.lr:
            made.append(data)
        return real(data, *a, **k)

    monkeypatch.setattr(torch, "tensor", counting)
    step = train_hgnn.make_hgnn_train_step(lambda p: x @ p["w"], data, CFG)
    assert len(made) == 1
    idx = torch.arange(4)
    state, m1 = step(state, {"idx": idx})
    state, m2 = step(state, {"idx": idx})
    assert len(made) == 1 and m1["lr"] is m2["lr"]
    assert m1["lr"].dtype == torch.float32 and float(m1["lr"]) == np.float32(CFG.lr)
    assert int(state.step) == 2 and not torch.equal(state.params["w"], params["w"])


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _close(got, want, name):
    """Within 1e-6 of the leaf's largest magnitude."""
    got, want = got.float(), want.float()
    tol = 1e-6 * max(float(want.abs().max()) if want.numel() else 0.0, 1e-30)
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= tol, f"{name}: {err} > {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("tree", sorted(TREES))
def test_five_steps_match_the_loop(cuda, tree):
    shapes = TREES[tree]
    params, state = _state(shapes, CFG, device=cuda)
    ref_p, ref_s = _clone(params), _clone(state)
    lr = torch.tensor(CFG.lr, device=cuda)
    before = fa.fused_adamw.launches
    for step in range(5):
        grads = _grads(shapes, step, device=cuda)
        params, state, n = apply_updates(params, grads, state, CFG, lr)
        out = fa.fused_adamw_plain(CFG, lr, *_leaves(ref_p, grads, ref_s), ref_s["count"])
        _close(n, out[-1], f"step {step} grad_norm")
        assert int(state["count"]) == int(out[4]) == step + 1
        for key, got, want in (("params", tree_leaves(params), out[0]),
                               ("m", tree_leaves(state["m"]), out[1]),
                               ("v", tree_leaves(state["v"]), out[2])):
            for i, (a, b) in enumerate(zip(got, want)):
                _close(a, b, f"step {step} {key}[{i}]")
    torch.cuda.synchronize()
    assert fa.fused_adamw.launches == before + 2 * 5


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", ["float32", "bf16_params_bf16_moments"])
@pytest.mark.parametrize("tree", sorted(TREES))
def test_given_its_norm_the_loop_gives_the_kernels_bits(cuda, tree, dtypes):
    """The kernels repeat the loop's arithmetic operation by operation: fed
    the kernels' norm, the loop writes the same bits, five steps running."""
    bf16 = dtypes != "float32"
    cfg = dataclasses.replace(CFG, moment_dtype="bfloat16" if bf16 else "float32",
                              master_fp32=True, weight_decay=0.1)
    dt = torch.bfloat16 if bf16 else torch.float32
    shapes = TREES[tree]
    params, state = _state(shapes, cfg, dtype=dt, device=cuda)
    assert len(tree_leaves(state["master"])) == (len(shapes) if bf16 else 0)
    ref_p, ref_s = _clone(params), _clone(state)
    lr = torch.tensor(cfg.lr, device=cuda)
    for step in range(5):
        grads = _grads(shapes, step, dtype=dt, device=cuda)
        params, state, n = apply_updates_(params, grads, state, cfg, lr)
        adamw.update_leaves_(cfg, lr, n, *_leaves(ref_p, grads, ref_s), ref_s["count"])
        for a, b in zip(tree_leaves((params, state)), tree_leaves((ref_p, ref_s))):
            assert a.dtype == b.dtype and torch.equal(a, b), step


@pytest.mark.cuda
@pytest.mark.parametrize("tree", sorted(TREES))
def test_two_runs_are_bitwise_equal_and_in_place_is_out_of_place(cuda, tree):
    shapes = TREES[tree]
    params, state = _state(shapes, CFG, device=cuda)
    lr = torch.tensor(CFG.lr, device=cuda)
    runs = []
    for _ in range(2):
        p, s = _clone(params), _clone(state)
        for step in range(3):
            grads = _grads(shapes, step, device=cuda)
            before = [t.clone() for t in tree_leaves((p, s, grads))]
            p2, s2, n = apply_updates(p, grads, s, CFG, lr)
            assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves((p, s, grads))))
            ip, is_, n_ip = apply_updates_(p, grads, s, CFG, lr)
            assert ip is p and is_ is s and torch.equal(n, n_ip)
            for a, b in zip(tree_leaves((p2, s2)), tree_leaves((p, s))):
                assert torch.equal(a, b)
        runs.append(tree_leaves((p, s)) + [n])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_a_tree_wider_than_one_struct_takes_several_launch_pairs(cuda):
    rng = np.random.default_rng(5)
    sizes = [int(n) for n in rng.integers(0, 3000, 2 * fa.MAX_LEAVES + 17)]
    sizes[:4] = [0, 1, 0, 1]
    shapes = [(n,) for n in sizes]
    groups = len(fa.plan(tuple(sizes)).groups)
    assert groups == 3
    params, state = _state(shapes, CFG, device=cuda)
    ref_p, ref_s = _clone(params), _clone(state)
    lr = torch.tensor(CFG.lr, device=cuda)
    before = fa.fused_adamw.launches
    for step in range(2):
        grads = _grads(shapes, step, device=cuda)
        params, state, n = apply_updates(params, grads, state, CFG, lr)
        out = fa.fused_adamw_plain(CFG, lr, *_leaves(ref_p, grads, ref_s), ref_s["count"])
        _close(n, out[-1], "grad_norm")
        for i, (a, b) in enumerate(zip(tree_leaves(params), out[0])):
            _close(a, b, f"params[{i}]")
    torch.cuda.synchronize()
    assert fa.fused_adamw.launches == before + 2 * groups * 2


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["float16 param", "int64 count", "float lr"])
def test_operands_the_kernels_do_not_take_raise_on_the_card(cuda, fault):
    params, grads, state, lr = _operands(fault)
    to = lambda t: tree_map(lambda x: x.to(cuda), t)  # noqa: E731
    params, grads, state = to(params), to(grads), to(state)
    lr = lr.to(cuda) if isinstance(lr, torch.Tensor) else lr
    with pytest.raises(TypeError, match=FAULTS[fault]):
        apply_updates(params, grads, state, CFG, lr)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["HAN", "R-GAT"])
def test_trainer_optimizer_runs_with_no_synchronise(cuda, model, monkeypatch):
    """The HGNN trainer's whole ``step/optimizer`` under
    ``set_sync_debug_mode("error")``: no scalar copy to the card, no read of
    it; two launches a step."""
    real = train_hgnn.trace_span

    @contextlib.contextmanager
    def strict(name, *a, **k):
        with real(name, *a, **k):
            if name != "step/optimizer":
                yield
                return
            torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(train_hgnn, "trace_span", strict)
    before = fa.fused_adamw.launches
    hgnn_train.run_training(dataset="acm", hidden=8, heads=2, scale=0.05, block=16,
                            max_edges=20_000, batch=32, log=lambda *_: None, log_every=1,
                            steps=3, device="cuda", model_name=model)
    torch.cuda.synchronize()
    assert fa.fused_adamw.launches == before + 2 * 3
