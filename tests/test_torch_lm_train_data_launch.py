"""The LM launcher over a data mesh (``repro_torch.launch.train``): the
placements of the train state on an ``(n, 1)`` data mesh, the launcher
under 2 gloo ranks (``torch.multiprocessing.spawn``, ``file://``
rendezvous), checkpoints crossing between 2 ranks and one process in both
directions, and the production mesh at 256 ranks: 16 × 16 over
``("data", "model")`` under the ``tp`` rules with the config's ``fsdp``.

Bitwise: a checkpoint restores the very state that wrote it, whatever
the number of ranks; the next step's loss then agrees with the other
run's within 1e-6 relative (the data group sums in another order).
This module imports no JAX at the top: the spawned ranks import it.
"""
import contextlib
import datetime
import os
import shutil
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SPAWN_TIMEOUT_S = 120
WORLD = 2
RUN = dict(smoke=True, device="cpu", global_batch=8, seq=16, microbatches=2, ckpt_every=2)
LOSS_REL = 1e-6
ARCH = "llama3.2-3b"


@contextlib.contextmanager
def fake_group(world: int):
    """A ``fake`` process group of ``world`` ranks in this process (rank 0)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _worker(rank: int, init_file: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=WORLD,
                            rank=rank, timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT_S))
    try:
        from repro_torch.launch import train as tl

        res = {"logs": []}
        _, res["hist"] = tl.run_training(ARCH, steps=15, log=res["logs"].append,
                                         **dict(RUN, ckpt_every=50))
        silent = lambda *_: None  # noqa: E731
        # a 2-rank checkpoint at step 4; a copy of it for the one process to resume
        two = os.path.join(out_dir, "two")
        res["state4"], _ = tl.run_training(ARCH, steps=4, ckpt=two, log=silent, **RUN)
        res["ckpts"] = sorted(os.listdir(two)) if rank == 0 else None
        if rank == 0:
            shutil.copytree(two, os.path.join(out_dir, "two_to_one"))
        dist.barrier()
        _, res["next"] = tl.run_training(ARCH, steps=5, ckpt=two, log=silent, **RUN)
        # the one process's step-4 checkpoint (written before the spawn), at 2 ranks
        one = os.path.join(out_dir, "one_to_two")
        res["from_one"], hist = tl.run_training(ARCH, steps=4, ckpt=one, log=silent, **RUN)
        assert hist == []
        _, res["from_one_next"] = tl.run_training(ARCH, steps=5, ckpt=one, log=silent, **RUN)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the one-process runs, the ranks' results)."""
    from repro_torch.launch import train as tl

    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("launch")
    silent = lambda *_: None  # noqa: E731
    one = {}
    _, one["hist"] = tl.run_training(ARCH, steps=15, log=silent, **dict(RUN, ckpt_every=50))
    one["state4"], _ = tl.run_training(ARCH, steps=4, ckpt=str(out / "one"), log=silent, **RUN)
    shutil.copytree(out / "one", out / "one_to_two")
    _, one["next"] = tl.run_training(ARCH, steps=5, ckpt=str(out / "one"), log=silent, **RUN)
    ctx = mp.spawn(_worker, args=(str(out / "rendezvous"), str(out)), nprocs=WORLD, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{WORLD} gloo ranks did not finish in {SPAWN_TIMEOUT_S} s")
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    # the 2-rank checkpoint, resumed in one process
    one["from_two"], hist = tl.run_training(ARCH, steps=4, ckpt=str(out / "two_to_one"),
                                            log=silent, **RUN)
    assert hist == []
    _, one["from_two_next"] = tl.run_training(ARCH, steps=5, ckpt=str(out / "two_to_one"),
                                              log=silent, **RUN)
    return one, ranks


def _same(a, b) -> bool:
    from repro_torch.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= LOSS_REL * abs(b)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "dbrx-132b", "mamba2-2.7b", "whisper-large-v3"])
@pytest.mark.parametrize("opt_mode", ["plain", "factored", "master"])
def test_every_leaf_is_replicated_over_data(arch, opt_mode):
    """``param_shardings`` of ``train_state_axes`` under the launcher's
    rules on a (4, 1) data mesh: ``Replicate()`` on ``data`` for every
    leaf, as the reference's specs, which name no ``data`` axis."""
    import dataclasses

    from torch.distributed.tensor import Replicate

    from repro.dist import sharding as jsh
    from repro_torch.configs import smoke_config
    from repro_torch.dist import make_rules, param_shardings, placement_leaves
    from repro_torch.dist.sharding import is_axes_leaf, map_axes
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.models.lm.api import build
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import train_state_axes

    cfg = smoke_config(arch)
    if opt_mode == "master":
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    api = build(cfg)
    opt = AdamWConfig(factored=opt_mode == "factored", master_fp32=opt_mode == "master")
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    axes = train_state_axes(api, opt, params)
    with fake_group(4):
        mesh = make_data_mesh(4, device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (4, 1)
        placements = placement_leaves(param_shardings(mesh, make_rules(batch_shard=True,
                                                                       fsdp=False), axes))
    assert placements and all(p[0] == Replicate() for p in placements)
    jrules = jsh.make_rules(batch_shard=True, fsdp=False)
    specs = []
    map_axes(lambda a: specs.append(jrules.spec(a)), axes)
    assert len(specs) == len(placements)
    assert all("data" not in [e for part in s for e in (part if isinstance(part, tuple)
                                                        else (part,))] for s in specs)
    assert is_axes_leaf(())


def test_data_rows_take_a_block_of_each_microbatch():
    from repro_torch.train.step import data_rows

    batch = {"tokens": torch.arange(16)[:, None].repeat(1, 3)}
    got = [data_rows(batch, 2, 4, r)["tokens"][:, 0].tolist() for r in range(4)]
    assert got == [[0, 1, 8, 9], [2, 3, 10, 11], [4, 5, 12, 13], [6, 7, 14, 15]]
    with pytest.raises(ValueError, match="does not split"):
        data_rows(batch, 3, 2, 0)


def test_the_production_mesh_is_the_tp_mesh():
    """At 256 ranks the launcher takes the reference's production mesh and
    the ``tp`` rules with the config's ``fsdp``: heads and vocab over
    ``model``, every weight's ``embed`` dim over ``data``; ``--smoke`` (as
    the reference's) and fewer ranks keep the data mesh."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs import get_config
    from repro_torch.dist import make_rules, param_shardings
    from repro_torch.launch import train as tl
    from repro_torch.models.lm.api import build
    from repro_torch.models.lm.layers import abstract_from_specs
    from repro_torch.models.lm.transformer import decoder_specs
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import train_state_axes

    cfg = get_config(ARCH)
    assert cfg.fsdp
    rules = tl.training_rules(256, cfg)
    assert rules == make_rules(fsdp=True)
    assert tl.training_rules(256, cfg, smoke=True) == make_rules(batch_shard=True, fsdp=False)
    with fake_group(256):
        mesh = tl.training_mesh(256, device_type="cpu")
        assert tuple(mesh.shape) == (16, 16)
        assert mesh.mesh_dim_names == ("data", "model")
        api = build(cfg)
        opt = AdamWConfig()
        params = abstract_from_specs(decoder_specs(cfg), cfg.param_dtype)
        pl = param_shardings(mesh, rules, train_state_axes(api, opt, params))
        attn = pl.params["scan"]["pos0"]["attn"]
        assert attn["wq"] == (Shard(1), Shard(2))  # [L, embed, heads]
        assert attn["wo"] == (Shard(2), Shard(1))  # [L, heads, embed]
        assert pl.params["embed"] == (Shard(1), Shard(0))  # [vocab, embed]
        assert pl.params["final_norm"] == (Replicate(), Replicate())
        assert pl.opt["m"]["scan"]["pos0"]["mlp"]["w_down"] == (Shard(2), Shard(1))
        mesh = tl.training_mesh(256, smoke=True, device_type="cpu")  # the reference's --smoke
        assert tuple(mesh.shape) == (256, 1)
    assert tl.training_mesh(1) is None


def test_the_launcher_trains_over_two_ranks_and_the_writer_alone_logs(runs):
    one, ranks = runs
    hists = [[{k: v for k, v in h.items() if k != "sec"} for h in r["hist"]] for r in ranks]
    assert hists[0] == hists[1]
    losses = [h["loss"] for h in hists[0]]
    assert losses[-1] < losses[0]
    # the same first step as one process: the global batch's loss
    assert _close(losses[0], one["hist"][0]["loss"])
    assert any(line.startswith("[train] step=") for line in ranks[0]["logs"])
    assert ranks[1]["logs"] == []


def test_a_two_rank_checkpoint_resumes_in_one_process(runs):
    one, ranks = runs
    assert ranks[0]["ckpts"] == ["step_2", "step_4"]
    assert _same(ranks[0]["state4"], ranks[1]["state4"])
    assert _same(one["from_two"], ranks[0]["state4"])
    (a,), (b,) = one["from_two_next"], ranks[0]["next"]
    assert a["step"] == b["step"] == 4 and _close(a["loss"], b["loss"])


def test_a_one_process_checkpoint_resumes_on_two_ranks(runs):
    one, ranks = runs
    for r in ranks:
        assert _same(r["from_one"], one["state4"])
        (a,), (b,) = r["from_one_next"], one["next"]
        assert a["step"] == b["step"] == 4 and _close(a["loss"], b["loss"])
