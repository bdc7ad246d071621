"""The port's MoE blocks against the JAX package's: ``moe_specs``,
``_capacity`` and ``moe_forward`` on dbrx-132b's and grok-1-314b's smoke
configs (4 experts, top-2), and the MoE decoders' decode, greedy and bf16
serving paths.

The reference's own routing decisions (its top-k expert ids and its
``[E, cap]`` dispatch tables) are read off it as it computes them: the
test hands ``repro.models.lm.moe`` a stand-in for ``jax`` whose ``vmap``
and ``lax.top_k`` record their results.  Each output comparison first
asserts that both packages chose the same experts and kept the same
copies, so that a failure says where it began.

Weights come from the JAX ``init`` through ``convert.lm_params_from_numpy``;
inputs from numpy.  Tolerances: float32 1e-5 (outputs) and 1e-6 (aux,
sum order); bfloat16 3e-2 (``tests/test_kernels.py``'s bfloat16
tolerance, as the dense decoder's tests)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.lm import moe as jmoe
from repro.models.lm.layers import init_from_specs as jinit
from repro.models.lm.api import build as jbuild
from repro.serve import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.lm import moe as tmoe
from repro_torch.models.lm.api import build as tbuild
from repro_torch.serve import engine as tengine

ARCHS = ["dbrx-132b", "grok-1-314b"]
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
AUX_TOL = {"float32": dict(rtol=1e-6, atol=1e-6), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
# (batch, seq, capacity factor): one decode token, a prompt, and a prompt
# at half the default capacity, where copies are dropped
MOE_CASES = {"decode": (4, 1, 1.25), "prefill": (2, 16, 1.25), "drops": (2, 64, 0.5)}


def smoke_pair(arch: str, **over):
    return (dataclasses.replace(jconfigs.smoke_config(arch), **over),
            dataclasses.replace(tconfigs.smoke_config(arch), **over))


@functools.cache
def _moe_init(arch: str, param_dtype: str) -> dict:
    specs = jmoe.moe_specs(jconfigs.smoke_config(arch))
    return jax.tree.map(np.asarray, jinit(specs, jax.random.key(0), getattr(jnp, param_dtype)))


@functools.cache
def decoder_init(arch: str, param_dtype: str = "float32") -> dict:
    """The JAX decoder init of a smoke config, as numpy (jitted: one compile)."""
    jcfg = smoke_pair(arch, param_dtype=param_dtype)[0]
    return jax.tree.map(np.asarray, jax.jit(jbuild(jcfg).init)(jax.random.key(0)))


def moe_params(jcfg):
    """One MoE block's weights from the JAX package's init: (JAX, port)."""
    p = _moe_init(jcfg.name, jcfg.param_dtype)
    return {k: jnp.asarray(v) for k, v in p.items()}, lm_params_from_numpy(p, device="cpu")


class _Recorder:
    """Stands in for ``jax`` inside ``repro.models.lm.moe``: every name is
    jax's, but ``lax.top_k`` (the router's probabilities and expert ids)
    and the ``vmap`` of ``dispatch_row`` (the token table) also send their
    values to the host through ``jax.debug.callback``, so that the
    reference may run jitted or under its scan over layers."""

    def __init__(self):
        self.probs, self.ids, self.tables = [], [], []
        rec = self

        class Lax:
            def __getattr__(self, name):
                return getattr(jax.lax, name)

            @staticmethod
            def top_k(x, k):
                vals, ids = jax.lax.top_k(x, k)
                jax.debug.callback(
                    lambda p, i: (rec.probs.append(np.asarray(p)), rec.ids.append(np.asarray(i))),
                    x, ids)
                return vals, ids

        self.lax = Lax()

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn):
        mapped = jax.vmap(fn)

        def run(*args):
            out = mapped(*args)
            if fn.__name__ == "dispatch_row":
                jax.debug.callback(lambda t: self.tables.append(np.asarray(t)), out[1])
            return out

        return run

    def routes(self, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The recorded layers' (expert ids [L, B, S, k], logit gap [L, B,
        S]): ``Routing``'s fields, from the reference's probabilities."""
        ranked = np.log(-np.sort(-np.stack(self.probs), axis=-1))
        return (torch.from_numpy(np.stack(self.ids)).long(),
                torch.from_numpy(ranked[..., k - 1] - ranked[..., k]))


def run_recorded(monkeypatch, fn, *args):
    """``fn(*args)`` with ``repro.models.lm.moe`` reading a recorder as
    ``jax``: (result, recorder)."""
    rec = _Recorder()
    monkeypatch.setattr(jmoe, "jax", rec)
    out = fn(*args)
    jax.effects_barrier()
    monkeypatch.undo()
    return out, rec


def reference_moe(monkeypatch, params, x, cfg):
    """(out, aux, expert ids, token table) of the reference's moe_forward,
    traced afresh under the recorder."""
    (out, aux), rec = run_recorded(
        monkeypatch, jax.jit(lambda p, x: jmoe.moe_forward(p, x, cfg)), params, x)
    (ids,), (table,) = rec.ids, rec.tables
    return out, aux, ids, table


def as_np(x):
    return np.asarray(x.float()) if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def check_moe(monkeypatch, jcfg, tcfg, jp, tp, x, dtype):
    """Both packages' moe_forward on x: the same experts, the same kept
    copies, then outputs and aux at the dtype's tolerance.  Returns the
    port's routing."""
    want, jaux, jids, jtable = reference_moe(monkeypatch, jp, jnp.asarray(x, getattr(jnp, dtype)),
                                             jcfg)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got, aux = tmoe.moe_forward(tp, tx, tcfg)
    r = tmoe.route(tp, tx, tcfg)
    np.testing.assert_array_equal(r.expert_ids.numpy(), jids)
    np.testing.assert_array_equal(r.table.numpy(), jtable)
    kept = np.zeros(jids.shape, bool)  # a copy is kept where its token sits in its expert's table
    for b, s, j in np.ndindex(*jids.shape):
        kept[b, s, j] = s in jtable[b, jids[b, s, j]]
    np.testing.assert_array_equal(r.keep.numpy(), kept)
    assert got.dtype == tx.dtype and aux.dtype == torch.float32 and got.shape == tx.shape
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL[dtype])
    np.testing.assert_allclose(float(aux), float(jaux), **AUX_TOL[dtype])
    return r


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_specs_and_capacity_match_jax(arch):
    jcfg, tcfg = smoke_pair(arch)
    full_j, full_t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for jc, tc in ((jcfg, tcfg), (full_j, full_t)):
        for layers in (None, 3):
            want = {k: (p.shape, p.axes, p.init, p.scale)
                    for k, p in jmoe.moe_specs(jc, layers=layers).items()}
            got = {k: (p.shape, p.axes, p.init, p.scale)
                   for k, p in tmoe.moe_specs(tc, layers=layers).items()}
            assert got == want
        for cf in (1e-6, 0.5, 1.25, 8.0):
            for seq in (1, 7, 16, 64, 4096, 32768):
                jc2, tc2 = (dataclasses.replace(c, moe_capacity_factor=cf) for c in (jc, tc))
                assert tmoe._capacity(tc2, seq) == jmoe._capacity(jc2, seq)
    assert tmoe._capacity(full_t, 4096) == 1280  # the chip run's forward: B = 2, S = 4096


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MOE_CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_jax(monkeypatch, arch, case, dtype):
    b, s, cf = MOE_CASES[case]
    jcfg, tcfg = smoke_pair(arch, moe_capacity_factor=cf, dtype=dtype, param_dtype=dtype)
    jp, tp = moe_params(jcfg)
    x = np.random.default_rng(2).standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    r = check_moe(monkeypatch, jcfg, tcfg, jp, tp, x, dtype)
    dropped = int((~r.keep).sum())
    assert (dropped > 0) == (case == "drops"), dropped


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_router_ties_go_to_the_lower_expert(monkeypatch, arch):
    """A zero router makes every probability equal: both packages pick
    experts 0 … k-1 for every token (jax.lax.top_k's order on ties)."""
    jcfg, tcfg = smoke_pair(arch)
    jp, tp = moe_params(jcfg)
    jp["router"] = jnp.zeros_like(jp["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    x = np.random.default_rng(3).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    r = check_moe(monkeypatch, jcfg, tcfg, jp, tp, x, "float32")
    k = tcfg.experts_per_tok
    assert (r.expert_ids == torch.arange(k)).all()
    assert (r.gap == 0).all()


def test_moe_router_promotes_float32_params_under_bf16_compute(monkeypatch):
    """float32 params, bfloat16 compute: the router product is float32 in
    both packages (jnp promotes, never casts the router down)."""
    jcfg, tcfg = smoke_pair("dbrx-132b", dtype="bfloat16", param_dtype="float32")
    jp, tp = moe_params(jcfg)
    x = np.random.default_rng(4).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    r = check_moe(monkeypatch, jcfg, tcfg, jp, tp, x, "bfloat16")
    xb = torch.from_numpy(x).bfloat16()
    assert torch.equal(r.probs, torch.softmax(xb.float() @ tp["router"], dim=-1))


def test_moe_drops_every_copy_beyond_capacity_to_the_residual_path():
    """At a capacity of 8 slots for 64 copies an expert, the kept copies
    are each expert's first 8 arrivals in token order, and a token with no
    kept copy gets exactly zero."""
    _, tcfg = smoke_pair("dbrx-132b", moe_capacity_factor=1e-6)
    _, tp = moe_params(tcfg)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 32, 64)).astype(np.float32))
    r = tmoe.route(tp, x, tcfg)
    out, _ = tmoe.moe_forward(tp, x, tcfg)
    for b in range(2):
        for e in range(tcfg.num_experts):
            arrivals = [s for s in range(32) for j in range(2) if r.expert_ids[b, s, j] == e]
            assert r.table[b, e].tolist() == (arrivals[:8] + [-1] * 8)[:8]
    lost = ~r.keep.any(-1)
    assert lost.any() and (out[lost] == 0).all() and (out[~lost] != 0).any(-1).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_matches_its_forward(arch):
    """Decode == forward on the port, with ample capacity (decode routes
    each token alone, so it matches only a dropless forward, as
    tests/test_decode_equivalence.py sets it).  grok's decode applies its
    logit soft cap, which impl "flash" ignores: it matches impl "xla"."""
    cfg = dataclasses.replace(tconfigs.smoke_config(arch), moe_capacity_factor=8.0)
    api = tbuild(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    B, S = 2, 12
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1))
    caches = api.init_caches(B, S, torch.float32, device="cpu")
    outs = []
    for t in range(S):
        lg, caches = api.decode(params, toks[:, t:t + 1], t, caches)
        outs.append(lg)
    for impl in ("xla",) if cfg.logits_soft_cap else ("xla", "flash"):
        ref, aux = api.forward(params, toks, impl=impl)
        torch.testing.assert_close(torch.cat(outs, dim=1), ref, rtol=5e-4, atol=5e-4)
        assert aux.dtype == torch.float32 and float(aux) > 0


def test_grok_flash_ignores_the_soft_cap_in_both_packages():
    """impl "flash" has no logit soft cap in either package; the xla path
    applies grok's 30.0.  So grok's flash forward equals its cap-free
    config's (the port's bit for bit, the reference's at 1e-5 of the
    port's cap-free one) and differs from its xla forward."""
    jcfg, tcfg = smoke_pair("grok-1-314b")
    assert tcfg.logits_soft_cap == 30.0
    params = decoder_init("grok-1-314b")
    jp, tp = jax.tree.map(jnp.asarray, params), lm_params_from_numpy(params, device="cpu")
    # larger queries put attention logits where the cap bends them
    jp["scan"]["pos0"]["attn"]["wq"] = jp["scan"]["pos0"]["attn"]["wq"] * 8
    tp["scan"]["pos0"]["attn"]["wq"] = tp["scan"]["pos0"]["attn"]["wq"] * 8
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    t = torch.from_numpy(toks)
    capfree = dataclasses.replace(tcfg, logits_soft_cap=None)
    flash, _ = tbuild(tcfg).forward(tp, t, impl="flash")
    assert torch.equal(flash, tbuild(capfree).forward(tp, t, impl="flash")[0])
    np.testing.assert_allclose(as_np(flash), as_np(tbuild(capfree).forward(tp, t, impl="xla")[0]),
                               **TOL["float32"])
    xla, _ = tbuild(tcfg).forward(tp, t, impl="xla")
    assert float((xla - flash).abs().max()) > 1e-2
    for impl, got in (("flash_interpret", flash), ("xla", xla)):
        want, _ = jax.jit(functools.partial(jbuild(jcfg).forward, impl=impl))(jp, jnp.asarray(toks))
        np.testing.assert_allclose(as_np(got), as_np(want), **TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_greedy_tokens_equal_jax(arch):
    jcfg, tcfg = smoke_pair(arch)
    params = decoder_init(arch)
    prompt = np.random.default_rng(7).integers(0, jcfg.vocab_size, (3, 4)).astype(np.int32)
    greedy = jax.jit(jengine.greedy_generate, static_argnums=(0, 3, 4))
    want = greedy(jbuild(jcfg), jax.tree.map(jnp.asarray, params), jnp.asarray(prompt), 3, 8)
    got = tengine.greedy_generate(tbuild(tcfg), lm_params_from_numpy(params, device="cpu"),
                                  torch.from_numpy(prompt), steps=3, cache_len=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_moe_prefill_and_serve_step_with_bf16_caches_match_jax():
    """dbrx's serving path at bfloat16 params and compute (its own
    dtypes): prefill of an 8-token prompt with bfloat16 caches, then 3
    teacher-forced steps."""
    jcfg, tcfg = smoke_pair("dbrx-132b", dtype="bfloat16", param_dtype="bfloat16")
    japi, tapi = jbuild(jcfg), tbuild(tcfg)
    params = decoder_init("dbrx-132b", "bfloat16")
    jp, tp = jax.tree.map(jnp.asarray, params), lm_params_from_numpy(params, device="cpu")
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    nxt = rng.integers(0, jcfg.vocab_size, (3, 2, 1)).astype(np.int32)
    js = jengine.init_serve_state(japi, 2, 12, dtype=jnp.bfloat16)
    ts = tengine.init_serve_state(tapi, 2, 12, dtype=torch.bfloat16, device="cpu")
    jl, js = jax.jit(jengine.make_prefill(japi))(jp, js, jnp.asarray(prompt))
    tl, ts = tengine.make_prefill(tapi)(tp, ts, torch.from_numpy(prompt))
    jstep, tstep = jax.jit(jengine.make_serve_step(japi)), tengine.make_serve_step(tapi)
    for tok in [None, *nxt]:
        if tok is not None:
            jl, js = jstep(jp, js, jnp.asarray(tok))
            tl, ts = tstep(tp, ts, torch.from_numpy(tok))
        assert tl.dtype == torch.bfloat16 and tl.shape == jl.shape
        np.testing.assert_allclose(as_np(tl), np.asarray(jl, np.float32), **TOL["bfloat16"])
    assert ts.cache_pos == int(js.cache_pos) == 11
