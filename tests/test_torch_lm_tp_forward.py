"""The LM forward under the ``tp`` posture over gloo CPU ranks
(``torch.multiprocessing.spawn``) on the (1, 2) ``(data, model)`` mesh
(``test_torch_lm_tp_forward22.py``: (2, 2)), each rank holding its pieces
(``fsdp`` on), against the one-process port on the same weights (the
reference's ``init``, through ``convert``): the logits within ``REL`` of
their largest magnitude and bitwise equal on every rank, the sharded
``lm_loss`` (vocab-split) within ``REL`` of the one-process one, and each
rank's grad pieces (``loss_and_grads`` with the mesh: the rows split over
``data``) within ``REL`` of the same slices of the one-process grads'
largest magnitude.  The
dense family (llama3.2-3b, qwen2-7b's qkv bias, qwen3-8b's qk-norm,
minitron-4b's plain MLP, qwen2-vl-7b's M-RoPE and visual embeddings), both
attention routes (smoke variants with ``H % m ≠ 0`` take "replicated";
with K/V heads that do not split over the ranks, "local heads" over
gathered K/V columns; with q heads that fall across GQA groups, repeated
K/V heads) and the flash path (#7's plain version here).
``test_torch_lm_tp_forward_families*.py`` run the other families: both MoE
postures (dbrx-132b's experts over ``model``, grok-1-314b's FFN split over
``mlp``), the recurrent blocks' "replicated" route (mamba2-2.7b's SSD,
recurrentgemma-9b's RG-LRU beside its local attention) and the
encoder-decoder (whisper-large-v3: encoder, decoder and cross-attention,
both routes).
"""
import dataclasses
import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SHAPE = (1, 2)  # (data, model); test_torch_lm_tp_forward22.py: (2, 2)
SPAWN_TIMEOUT_S = 120
REL = 1e-5
B, S = 2, 16
# the smoke configs (4 heads, 2 K/V heads, head_dim 16), and variants
# that take the other branches at 2 model ranks
VARIANTS = {
    "llama3.2-3b": ("llama3.2-3b", {}),
    "replicated": ("llama3.2-3b", {"num_heads": 3, "num_kv_heads": 1}),
    "kv-gathered": ("llama3.2-3b", {"num_kv_heads": 1}),
    "kv-repeated": ("llama3.2-3b", {"num_heads": 6, "num_kv_heads": 3}),
    "qwen2-7b": ("qwen2-7b", {}),
    "qwen3-8b": ("qwen3-8b", {}),
    "qwen3-replicated": ("qwen3-8b", {"num_heads": 3, "num_kv_heads": 1}),
    "minitron-4b": ("minitron-4b", {}),
    "qwen2-vl-7b": ("qwen2-vl-7b", {}),
    "dbrx-132b": ("dbrx-132b", {}),
    "grok-1-314b": ("grok-1-314b", {}),
    "mamba2-2.7b": ("mamba2-2.7b", {}),
    "recurrentgemma-9b": ("recurrentgemma-9b", {}),
    "whisper-large-v3": ("whisper-large-v3", {}),
    "whisper-replicated": ("whisper-large-v3", {"num_heads": 3, "num_kv_heads": 3}),
}
FLASH = ("llama3.2-3b", "replicated")
# the variants of this file (test_torch_lm_tp_forward_families.py: the rest)
NAMES = ["llama3.2-3b", "replicated", "kv-gathered", "kv-repeated", "qwen2-7b", "qwen3-8b",
         "qwen3-replicated", "minitron-4b", "qwen2-vl-7b"]


def _cfg(name: str, pkg: str = "repro_torch"):
    import importlib

    arch, over = VARIANTS[name]
    cfg = importlib.import_module(f"{pkg}.configs").smoke_config(arch)
    return dataclasses.replace(cfg, **over)


def _given(names) -> dict:
    """The reference's weights of each variant of ``names`` (``init``
    jitted, key 0) and the inputs (numpy, from a seed), which the ranks
    read."""
    import jax

    from repro.models.lm.api import build as jbuild

    rng = np.random.default_rng(5)
    given = {}
    for name in names:
        cfg = _cfg(name, "repro")
        params = jax.tree.map(np.asarray, jax.jit(jbuild(cfg).init)(jax.random.key(0)))
        tokens = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
        given[name] = {"params": params, "tokens": tokens}
        if cfg.is_encoder_decoder:  # the stub frontend's frames
            given[name]["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
                np.float32)
        if cfg.m_rope:  # a 2 x 2 visual span in the first slots, then text
            pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None, :, None], (B, S, 3)).copy()
            pos[:, :4, 1] = [0, 0, 1, 1]
            pos[:, :4, 2] = [0, 1, 0, 1]
            given[name]["positions"] = pos
            given[name]["visual_embeds"] = rng.standard_normal((B, 4, cfg.d_model)).astype(
                np.float32)
    return given


def _worker(rank: int, world: int, shape, init_file: str, inputs: str,
            out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT_S))
    try:
        from repro_torch.convert import lm_params_from_numpy
        from repro_torch.dist import local_slice, make_rules, map_placements, param_shardings
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.lm.api import build
        from repro_torch.train.step import lm_loss, loss_and_grads
        from repro_torch.tree import tree_leaves

        given = torch.load(inputs, weights_only=False)
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        res = {}
        for name in given:
            api = build(_cfg(name))
            g = given[name]
            params = lm_params_from_numpy(g["params"], device="cpu")
            pl = param_shardings(mesh, make_rules(fsdp=True), api.axes())
            pieces = map_placements(lambda p, x: local_slice(x, p, mesh), pl, params)
            toks = torch.from_numpy(g["tokens"])
            kw = {k: torch.from_numpy(g[k]) for k in ("positions", "visual_embeds", "frames")
                  if k in g}
            for impl in ("xla", "flash") if name in FLASH else ("xla",):
                one, _ = api.forward(params, toks[:, :-1], impl=impl, **kw)
                got, _ = api.forward(pieces, toks[:, :-1], impl=impl, mesh=mesh, placements=pl,
                                     **kw)
                res[(name, impl)] = (one, got)
            batch = {"tokens": toks, **kw}
            res[(name, "loss")] = (float(lm_loss(api, params, batch)[1]["loss"]),
                                   float(lm_loss(api, pieces, batch, mesh=mesh,
                                                 placements=pl)[1]["loss"]))
            one = map_placements(lambda p, x: local_slice(x, p, mesh), pl,
                                 loss_and_grads(api, params, batch)[0])
            got = loss_and_grads(api, pieces, batch, mesh=mesh, placements=pl)[0]
            res[(name, "grads")] = max(
                float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                for g, w in zip(tree_leaves(got), tree_leaves(one)))
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def inputs(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("inputs") / "inputs.pt"
    torch.save(_given(request.module.NAMES), path)
    return str(path)


@pytest.fixture(scope="module")
def ranks(request, inputs, tmp_path_factory):
    shape = request.module.SHAPE
    world = shape[0] * shape[1]
    out = tmp_path_factory.mktemp(f"tp{world}")
    ctx = mp.spawn(_worker, args=(world, shape, str(out / "rendezvous"), inputs,
                                          str(out)), nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} gloo ranks did not finish in {SPAWN_TIMEOUT_S} s")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def check_forward(ranks, name: str, impl: str) -> None:
    first = ranks[0][(name, impl)][1]
    for r in ranks:
        one, got = r[(name, impl)]
        assert got.shape == one.shape
        assert float((got - one).abs().max()) <= REL * float(one.abs().max())
        assert torch.equal(got, first)


def check_loss(ranks, name: str) -> None:
    for r in ranks:
        one, got = r[(name, "loss")]
        assert abs(got - one) <= REL * abs(one)
        assert r[(name, "grads")] <= REL


@pytest.mark.parametrize("name,impl", [(n, "xla") for n in NAMES] + [(n, "flash") for n in FLASH])
def test_sharded_forward_matches_one_process(ranks, name, impl):
    check_forward(ranks, name, impl)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_loss_matches_one_process(ranks, name):
    check_loss(ranks, name)
