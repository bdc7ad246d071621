"""The LM under the ``model`` mesh axis (the ``tp`` posture): placements,
the attention routes and the vocab-split cross-entropy.  The sharded
forward is in ``test_torch_lm_tp_forward*.py``, the train step in
``test_torch_lm_tp_train*.py``, decode in ``test_torch_lm_tp_decode*.py``.

* The placements ``dist.param_shardings(mesh, make_rules(fsdp=True),
  api.axes())`` give every leaf of every family are the reference's
  ``rules.spec`` of the reference's axes, on meshes (1, 2), (2, 2), the
  16 × 16 production mesh and the 2 × 16 × 16 one (``fake`` process groups
  in this process).
* ``train.step.vocab_split_nll`` over 2 and 4 gloo ranks against the
  one-process ``lm_loss`` with padded vocab slots.
"""
import contextlib
import dataclasses
import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SPAWN_TIMEOUT_S = 120
REL = 1e-5
B, S = 2, 16


@contextlib.contextmanager
def fake_group(world: int):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-7b", "qwen3-8b", "minitron-4b",
                                  "dbrx-132b", "grok-1-314b", "mamba2-2.7b",
                                  "recurrentgemma-9b", "qwen2-vl-7b", "whisper-large-v3"])
def test_placements_are_the_reference_specs(arch):
    from repro import configs as jconfigs
    from repro.dist.sharding import make_rules as jmake_rules
    from repro.models.lm.api import build as jbuild
    from repro_torch import configs as tconfigs
    from repro_torch.dist import make_rules, param_shardings
    from repro_torch.dist.sharding import map_axes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm.api import build
    from torch.distributed.tensor import Replicate, Shard

    axes = build(tconfigs.get_config(arch)).axes()
    jaxes = jbuild(jconfigs.get_config(arch)).axes()
    assert map_axes(lambda a: a, axes) == map_axes(lambda a: tuple(a), jaxes)
    for multi_pod, shape, names in ((False, (1, 2), ("data", "model")),
                                    (False, (2, 2), ("data", "model")),
                                    (False, (16, 16), ("data", "model")),
                                    (True, (2, 16, 16), ("pod", "data", "model"))):
        with fake_group(int(np.prod(shape))):
            mesh = make_mesh(shape, names, device_type="cpu")
            got = param_shardings(mesh, make_rules(multi_pod=multi_pod, fsdp=True), axes)
        jrules = jmake_rules(multi_pod=multi_pod, fsdp=True)
        checked = []

        def check(a, pl):
            spec = tuple(jrules.spec(a))
            want = []
            for n in names:
                dims = [i for i, e in enumerate(spec)
                        if e == n or (isinstance(e, tuple) and n in e)]
                want.append(Shard(dims[0]) if dims else Replicate())
            assert pl == tuple(want), (arch, shape, a, spec, pl)
            checked.append(a)

        map_axes(check, jaxes, got)
        assert checked


def test_attention_routes():
    from repro_torch.configs import smoke_config
    from repro_torch.models.lm.attention import attention_route

    cfg = smoke_config("llama3.2-3b")
    assert attention_route(cfg, 2) == "local heads"
    assert attention_route(dataclasses.replace(cfg, num_heads=3, num_kv_heads=1), 2) == \
        "replicated"
    assert attention_route(cfg, 1) == "local heads"


def _nll_worker(rank: int, world: int, init_file: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT_S))
    try:
        from repro_torch.dist import model_split
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.train.step import vocab_split_nll

        ms = model_split(make_mesh((1, world), ("data", "model"), device_type="cpu"))
        logits, targets, vocab = torch.load(os.path.join(out_dir, "nll.pt"))
        n = logits.shape[-1] // world
        nll = vocab_split_nll(logits[..., rank * n:(rank + 1) * n], targets, vocab, ms)
        torch.save(nll, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_vocab_split_nll_equals_lm_loss_with_padded_slots(world, tmp_path):
    """Logits over ``vocab_padded`` = 512 slots for a vocab of 257, the
    padded slots set far above every real logit (so that a softmax that
    kept them would be far off), targets over the whole vocab, the last
    real slot included: the split NLL over 2 and 4 ranks, each holding
    128 or 256 slots (the last rank's all padding at 4), against the
    one-process ``lm_loss``'s masked ``log_softmax``."""
    import types

    from repro_torch.train.step import lm_loss

    vocab, vp = 257, 512
    rng = np.random.default_rng(7)
    logits = torch.from_numpy(rng.standard_normal((B, S, vp)).astype(np.float32) * 3)
    logits[..., vocab:] = 50.0
    targets = torch.from_numpy(rng.integers(0, vocab, (B, S)))
    targets[0, 0] = vocab - 1
    torch.save((logits, targets, vocab), tmp_path / "nll.pt")
    ctx = mp.spawn(_nll_worker, args=(world, str(tmp_path / "rendezvous"), str(tmp_path)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        assert time.monotonic() < deadline
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]

    cfg = types.SimpleNamespace(vocab_size=vocab)
    api = types.SimpleNamespace(cfg=cfg, forward=lambda p, t: (logits, torch.zeros(())))
    tokens = torch.cat([torch.zeros((B, 1), dtype=torch.long), targets], dim=1)
    want = float(lm_loss(api, None, {"tokens": tokens})[1]["loss"])
    for nll in got:
        assert torch.equal(nll, got[0])
        assert abs(float(nll.mean()) - want) <= REL * want
