"""The parts of the port's LM training slice against the JAX package's:

* the activations: bitwise ``jax.nn.silu`` and ``jax.nn.gelu`` in bf16
  (2,097,152 draws of 3·N(0, 1)), within 1e-6 in float32;
* the logical axes of the params, the optimizer state and the train
  state, leaf for leaf, for every architecture and AdamW mode;
* ``apply_updates`` in every mode (plain, bf16 moments, bf16 params with
  a float32 master, factored) on the same numpy grads, at 1e-6 (feeding
  both the same grads avoids AdamW's first step, which maps a grad's
  sign to ±lr); the in-place update bitwise the functional one, whatever
  the slice it takes a leaf in;
* the factored state's size and descent (``tests/test_perf_features.py``);
* remat none, full and dots: bitwise the same loss and grads, and the
  recompute each policy implies;
* ``SyntheticLMData``: the planted copy task and its replay."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro import optim as joptim
from repro.models.lm.api import build as jbuild
from repro.train.step import train_state_axes as jtrain_state_axes
from repro_torch import configs as tconfigs
from repro_torch import optim as toptim
from repro_torch.data import SyntheticHGNNData, SyntheticLMData
from repro_torch.models.lm import layers as tlayers
from repro_torch.models.lm.api import build as tbuild
from repro_torch.optim import adamw as tadamw
from repro_torch.train import make_train_step, train_state_axes
from repro_torch.train.step import init_train_state, loss_and_grads
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map

MODES = {
    "plain": dict(),
    "bf16_moments": dict(moment_dtype="bfloat16"),
    "bf16_params_master": dict(),
    "factored": dict(factored=True),
    "factored_bf16_params_master": dict(factored=True),
}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tests run many small steps, which
    threads only slow down when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the activations ---------------------------------------------------------

def _draws(dtype) -> np.ndarray:
    x = (3 * np.random.default_rng(1).standard_normal(2_097_152)).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_bf16_activations_are_jax_nn_s_bit_for_bit(name):
    x = _draws("bfloat16")
    want = np.asarray(jax.jit(getattr(jax.nn, name))(jnp.asarray(x))).view(np.int16)
    fn = {"silu": tlayers.silu, "gelu": tlayers.gelu_tanh}[name]
    got = fn(_to_torch(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want)


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_float32_activations_match_jax_nn(name):
    x = _draws("float32")
    want = np.asarray(jax.jit(getattr(jax.nn, name))(jnp.asarray(x)))
    got = {"silu": tlayers.silu, "gelu": tlayers.gelu_tanh}[name](torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# -- logical axes ------------------------------------------------------------

def _opt_pair(mode: str):
    kw = dict(MODES[mode], master_fp32=True)
    return joptim.AdamWConfig(**kw), toptim.AdamWConfig(**kw)


def _param_dtype(mode: str) -> dict:
    return dict(param_dtype="bfloat16") if "bf16_params" in mode else {}


@pytest.mark.parametrize("mode", ["plain", "bf16_params_master", "factored",
                                  "factored_bf16_params_master"])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_axes_match_the_reference(arch, mode):
    over = _param_dtype(mode)
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), **over)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), **over)
    japi, tapi = jbuild(jcfg), tbuild(tcfg)
    assert tapi.axes() == japi.axes()
    jopt, topt = _opt_pair(mode)
    jparams = jax.eval_shape(japi.init, jax.random.key(0))
    tparams = tapi.init(torch.Generator().manual_seed(0), device="cpu")
    want = jtrain_state_axes(japi, jopt, jparams)
    got = train_state_axes(tapi, topt, tparams)
    assert (got.params, got.opt, got.step) == (want.params, want.opt, want.step)
    assert toptim.opt_state_axes(tapi.axes(), topt, tparams) == joptim.opt_state_axes(
        japi.axes(), jopt, jparams)
    if not jopt.factored:  # without the params, master mirrors every leaf
        assert toptim.opt_state_axes(tapi.axes(), topt) == joptim.opt_state_axes(
            japi.axes(), jopt)


# -- AdamW in every mode -------------------------------------------------------

SHAPES = {"w": (3, 4, 5), "e": (6, 4), "b": (5,), "n": [(4, 1), (7,)]}


def _tree(rng, dtype):
    def draw(shape):
        return rng.standard_normal(shape).astype(np.float32).astype(dtype)

    return {k: [draw(s) for s in v] if isinstance(v, list) else draw(v) for k, v in SHAPES.items()}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("mode", MODES)
def test_apply_updates_match_the_reference(mode):
    jopt, topt = _opt_pair(mode)
    jopt = dataclasses.replace(jopt, lr=1e-2, grad_clip=0.5)
    topt = dataclasses.replace(topt, lr=1e-2, grad_clip=0.5)
    dtype = ml_dtypes.bfloat16 if "bf16_params" in mode else np.float32
    rng = np.random.default_rng(0)
    params = _tree(rng, dtype)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(_to_torch, params)
    js, ts = joptim.init_opt_state(jp, jopt), toptim.init_opt_state(tp, topt)
    assert sorted(ts) == sorted(js)
    for step in range(3):
        grads = _tree(rng, dtype)
        lr = jnp.asarray(1e-2 * (step + 1))
        jp, js, jn = joptim.apply_updates(jp, jax.tree.map(jnp.asarray, grads), js, jopt, lr)
        tp, ts, tn = toptim.apply_updates(tp, tree_map(_to_torch, grads), ts, topt,
                                          torch.tensor(1e-2 * (step + 1)))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for name, got in (("params", tp), *((k, ts[k]) for k in sorted(ts) if k != "count")):
        want = jp if name == "params" else js[name]
        jl = jax.tree_util.tree_flatten_with_path(want)[0]
        tl = tree_leaves_with_path(got)
        assert [jax.tree_util.keystr(k) for k, _ in jl] == [k.replace("/", "") for k, _ in tl]
        for (k, w), (_, g) in zip(jl, tl):
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype), (name, k)
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6, atol=1e-6, err_msg=f"{name}{k}")
    assert int(ts["count"]) == int(js["count"]) == 3
    if "master" in mode:
        assert all(m.dtype == torch.float32 for m in tree_leaves(ts["master"]))
        # the working copy is the master rounded
        for p, m in zip(tree_leaves(tp), tree_leaves(ts["master"])):
            assert torch.equal(p, m.to(p.dtype))
    else:
        assert tree_leaves(ts["master"]) == []


@pytest.mark.parametrize("mode", MODES)
def test_in_place_update_is_the_functional_one_bit_for_bit(mode, monkeypatch):
    topt = toptim.AdamWConfig(**MODES[mode])
    dtype = ml_dtypes.bfloat16 if "bf16_params" in mode else np.float32
    rng = np.random.default_rng(1)
    params = tree_map(_to_torch, _tree(rng, dtype))
    grads = tree_map(_to_torch, _tree(rng, dtype))
    state = toptim.init_opt_state(params, topt)
    before = [t.clone() for t in tree_leaves((params, state))]
    lr = torch.tensor(3e-3)
    new_p, new_s, n = toptim.apply_updates(params, grads, state, topt, lr)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves((params, state))))
    monkeypatch.setattr(tadamw, "CHUNK", 7)  # slices that cut rows and matrices
    got_p, got_s, n2 = toptim.apply_updates_(params, grads, state, topt, lr)
    assert got_p is params and got_s is state and torch.equal(n, n2)
    for a, b in zip(tree_leaves((new_p, new_s)), tree_leaves((params, state))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_factored_optimizer_state_is_small():
    tapi = tbuild(tconfigs.smoke_config("grok-1-314b"))
    params = tapi.init(torch.Generator().manual_seed(0), device="cpu")
    dense = toptim.init_opt_state(params, toptim.AdamWConfig())
    fact = toptim.init_opt_state(params, toptim.AdamWConfig(factored=True, master_fp32=False))
    nbytes = lambda t: sum(x.numel() * x.element_size() for x in tree_leaves(t))  # noqa: E731
    assert nbytes(fact) < 0.15 * nbytes(dense)
    axes = toptim.opt_state_axes(tapi.axes(), toptim.AdamWConfig(factored=True), params)
    assert sorted(axes) == sorted(fact)


def test_factored_optimizer_descends():
    cfg = tconfigs.smoke_config("grok-1-314b")
    api = tbuild(cfg)
    opt = toptim.AdamWConfig(lr=1e-2, weight_decay=0.0, factored=True, master_fp32=False)
    state = init_train_state(api, torch.Generator().manual_seed(0), opt, device="cpu")
    step = make_train_step(api, opt, lr_schedule=lambda s: torch.tensor(1e-2))
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8, seed=1)
    losses = []
    for _ in range(40):
        state, m = step(state, data.next())
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses[::8]


# -- remat -----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-7b", "recurrentgemma-9b", "whisper-large-v3",
                                  "dbrx-132b"])
def test_remat_policies_give_the_same_bits(arch):
    """``tests/test_perf_features.py:88`` holds the logits at 1e-5; the
    port's recompute is the same arithmetic, so the loss and every grad
    are bitwise equal.  What each policy keeps shows in what runs: the
    checkpointed layers keep their inputs alone for the autograd graph
    (dots keeps the weight products apart), both recompute, dots all but
    the weight products (``aten.mm``), full those too."""
    base = tconfigs.smoke_config(arch)
    params = tbuild(base).init(torch.Generator().manual_seed(0), device="cpu")
    data = SyntheticLMData(vocab_size=base.vocab_size, seq_len=16, global_batch=2, seed=2,
                           with_frames=base.frontend == "audio", frame_len=base.encoder_seq,
                           d_model=base.d_model)
    batch = data.next()
    out, kept, ops = {}, {}, {}
    for remat in ("none", "dots", "full"):
        api = tbuild(dataclasses.replace(base, remat=remat))
        saved = []

        def pack(t):
            saved.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), _OpCount() as n:
            out[remat] = loss_and_grads(api, params, batch)
        kept[remat], ops[remat] = sum(saved), n
    grads, m = out["none"]
    for remat in ("dots", "full"):
        g, mr = out[remat]
        assert torch.equal(mr["loss"], m["loss"]) and torch.equal(mr["aux_loss"], m["aux_loss"])
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g), tree_leaves(grads)))
    assert kept["full"] == kept["dots"] < kept["none"], kept
    assert ops["none"]["all"] < min(ops["dots"]["all"], ops["full"]["all"]), ops
    assert ops["none"]["mm"] == ops["dots"]["mm"] < ops["full"]["mm"], ops


class _OpCount(TorchDispatchMode):
    """Counts the aten ops that run under it, and the ``aten.mm`` among them."""

    def __enter__(self):
        self.n = {"all": 0, "mm": 0}
        super().__enter__()
        return self.n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n["all"] += 1
        self.n["mm"] += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


# -- the data pipeline -------------------------------------------------------------

def test_synthetic_lm_data_plants_a_copy_task_and_replays():
    d = SyntheticLMData(vocab_size=50, seq_len=9, global_batch=3, seed=5, with_frames=True,
                        frame_len=4, d_model=8)
    first = [d.next() for _ in range(3)]
    toks = first[0]["tokens"]
    assert toks.shape == (3, 10) and toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < 50
    assert torch.equal(toks[:, 0::2], toks[:, 1::2])  # every token emitted twice
    assert first[0]["frames"].shape == (3, 4, 8) and first[0]["frames"].dtype == torch.bfloat16
    assert 0.1 < float(first[0]["frames"].float().std()) < 0.3
    assert not torch.equal(first[0]["tokens"], first[1]["tokens"])
    e = SyntheticLMData(vocab_size=50, seq_len=9, global_batch=3, seed=5, with_frames=True,
                        frame_len=4, d_model=8)
    e.restore(d.state() | {"step": 1})
    again = e.next()
    assert torch.equal(again["tokens"], first[1]["tokens"])
    assert torch.equal(again["frames"], first[1]["frames"])
    assert d.state() == {"step": 3, "seed": 5}
    with pytest.raises(ValueError, match="seed"):
        e.restore({"step": 0, "seed": 6})
    assert "frames" not in SyntheticLMData(vocab_size=50, seq_len=4, global_batch=1).next()


def test_the_pipelines_streams_depend_on_the_seed():
    """Batch t is keyed on (seed, step): another seed, another stream (the
    generator keeps 32 bits of its seed, so the pair is hashed into them)."""
    kw = dict(vocab_size=1000, seq_len=31, global_batch=2)
    a, b = SyntheticLMData(seed=0, **kw), SyntheticLMData(seed=1, **kw)
    for _ in range(3):
        assert not torch.equal(a.next()["tokens"], b.next()["tokens"])
    h = [SyntheticHGNNData(num_vertices=1000, batch_size=16, seed=s).next()["idx"] for s in (3, 4)]
    assert not torch.equal(*h)
