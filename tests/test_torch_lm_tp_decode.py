"""Decode under the ``tp`` posture over gloo CPU ranks
(``torch.multiprocessing.spawn``) on the (1, 2) and (2, 2) ``(data, model)``
meshes, against the one-process port on the same weights (the reference's
``init``, through ``convert``) and prompts (numpy, seeded): a float32
prefill of 4 tokens and 6 greedy steps, B = 4.

The caches follow the reference's heuristic (``launch.dryrun.
cache_placements``): the batch over ``data`` where it divides, a cache
length that the ``model`` ranks divide over ``model`` (sequence-sharded
KV: the owner of a slot writes it, and the ranks' partial softmaxes are
combined by their max and sums), else the whole cache on every rank.
Each rank's logits at every step within ``REL`` of the one-process
logits' largest magnitude, its greedy tokens the one-process ones, and the
logits bitwise equal on the ranks of a model group: llama3.2-3b's smoke
config (sequence-sharded, and at a cache length of 15 whole), a variant
whose attention takes route "replicated", one with a local-attention ring
of 8 slots beside its full layers, dbrx-132b's experts over ``model``, and
whisper-large-v3 (its prompt's frames encoded on the mesh, the cross K/V
whole on every model rank).
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

SHAPE = (1, 2)
SPAWN_TIMEOUT_S = 120
REL = 1e-5
B, PROMPT, STEPS = 4, 4, 6
# name: (arch, overrides, cache length)
CASES = {
    "llama3.2-3b": ("llama3.2-3b", {}, 16),
    "whole-cache": ("llama3.2-3b", {}, 15),
    "replicated": ("llama3.2-3b", {"num_heads": 3, "num_kv_heads": 1}, 16),
    "local-ring": ("llama3.2-3b", {"block_pattern": ("attn", "local"), "window": 8,
                                   "num_layers": 2}, 16),
    "dbrx-132b": ("dbrx-132b", {"moe_capacity_factor": 8.0}, 16),
    "whisper-large-v3": ("whisper-large-v3", {}, 16),
}


def _cfg(name: str, pkg: str = "repro_torch"):
    import importlib

    arch, over, _ = CASES[name]
    return dataclasses.replace(importlib.import_module(f"{pkg}.configs").smoke_config(arch),
                               **over)


def _given() -> dict:
    import jax

    from repro.models.lm.api import build as jbuild

    rng = np.random.default_rng(11)
    given = {}
    for name in CASES:
        cfg = _cfg(name, "repro")
        given[name] = dict(
            params=jax.tree.map(np.asarray, jax.jit(jbuild(cfg).init)(jax.random.key(0))),
            prompt=rng.integers(0, cfg.vocab_size, (B, PROMPT), dtype=np.int32))
        if cfg.is_encoder_decoder:  # the stub frontend's frames of each prompt
            given[name]["frames"] = rng.standard_normal(
                (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return given


def _greedy(api, params, prompt, state, frames=None, **on_mesh):
    """(tokens [rows, STEPS], logits of every step) of a float32 prefill and
    greedy steps from ``state`` (an encoder-decoder's from ``frames``);
    ``on_mesh``: the mesh, the placements and the caches'."""
    from repro_torch.serve import engine

    prefill = engine.make_prefill(api, **on_mesh)
    step = engine.make_serve_step(api, **on_mesh)
    with torch.no_grad():
        logits, state = prefill(params, state, prompt, frames)
        toks, seen = [], [logits]
        for _ in range(STEPS):
            tok = logits[:, : api.cfg.vocab_size].argmax(-1).to(torch.int32)
            toks.append(tok)
            logits, state = step(params, state, tok[:, None])
            seen.append(logits)
    return torch.stack(toks, 1), torch.stack(seen)


def _worker(rank: int, world: int, shape, init_file: str, inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT_S))
    try:
        from repro_torch.convert import lm_params_from_numpy
        from repro_torch.dist import local_slice, make_rules, map_placements, param_shardings
        from repro_torch.launch.dryrun import cache_placements
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.lm.api import build
        from repro_torch.serve.engine import ServeState, init_serve_state

        given = torch.load(inputs, weights_only=False)
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        data, drank = mesh.size(0), mesh.get_local_rank("data")
        cut = lambda pl, tree: map_placements(  # noqa: E731
            lambda p, x: local_slice(x, p, mesh), pl, tree)
        res = {"coord": tuple(mesh.get_coordinate())}
        for name in CASES:
            cfg, cache_len = _cfg(name), CASES[name][2]
            api = build(cfg)
            params = lm_params_from_numpy(given[name]["params"], device="cpu")
            prompt = torch.from_numpy(given[name]["prompt"])
            fresh = lambda: init_serve_state(api, B, cache_len, dtype=torch.float32,  # noqa: E731
                                             device="cpu")
            frames = torch.from_numpy(given[name]["frames"]) if "frames" in given[name] else None
            one = _greedy(api, params, prompt, fresh(), frames)
            pl = param_shardings(mesh, make_rules(fsdp=True), api.axes())
            split = B % data == 0  # the batch over data where it divides, as the caches'
            rows = slice(drank * B // data, (drank + 1) * B // data) if split else slice(None)
            state = fresh()
            cpl = cache_placements(mesh, state.caches, cfg, batch=B, cache_len=cache_len,
                                   data_axes=("data",) if split else None)
            state = ServeState(caches=cut(cpl, state.caches), cache_pos=state.cache_pos)
            got = _greedy(api, cut(pl, params), prompt[rows], state,
                          None if frames is None else frames[rows], mesh=mesh, placements=pl,
                          cache_placements=cpl)
            res[name] = dict(one=(one[0][rows], one[1][:, rows]), got=got,
                             split_over_model=_model_split(cpl, mesh))
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _model_split(cpl, mesh) -> bool:
    """Whether every attention cache (of the scan, or the encoder-decoder's
    stacked one) splits its slots over ``model``."""
    from repro_torch.models.lm.attention import AttnCache
    from torch.distributed.tensor import Shard

    d = mesh.mesh_dim_names.index("model")
    blocks = [cpl] if isinstance(cpl, AttnCache) else [
        c for c in cpl.get("scan", {}).values() if isinstance(c, AttnCache)]
    return bool(blocks) and all(isinstance(c.k[d], Shard) for c in blocks)


@pytest.fixture(scope="module")
def ranks(request, tmp_path_factory):
    shape = request.module.SHAPE
    world = shape[0] * shape[1]
    path = tmp_path_factory.mktemp("inputs") / "inputs.pt"
    torch.save(_given(), path)
    out = tmp_path_factory.mktemp(f"decode{world}")
    ctx = mp.spawn(_worker, args=(world, shape, str(out / "rendezvous"), str(path), str(out)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} gloo ranks did not finish in {SPAWN_TIMEOUT_S} s")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_decode_matches_one_process(ranks, name):
    for r in ranks:
        (tok1, lg1), (tok, lg) = r[name]["one"], r[name]["got"]
        assert torch.equal(tok, tok1)
        assert float((lg - lg1).abs().max()) <= REL * float(lg1.abs().max())


@pytest.mark.parametrize("name", list(CASES))
def test_logits_are_bitwise_equal_in_a_model_group(ranks, name):
    by_data = {}
    for r in ranks:
        by_data.setdefault(r["coord"][0], []).append(r[name]["got"][1])
    for group in by_data.values():
        assert all(torch.equal(g, group[0]) for g in group)


def test_the_cache_layout_follows_the_heuristic(ranks):
    r = ranks[0]
    assert r["llama3.2-3b"]["split_over_model"] and r["local-ring"]["split_over_model"]
    assert r["whisper-large-v3"]["split_over_model"]
    assert not r["whole-cache"]["split_over_model"]  # 15 slots do not split over 2 ranks
