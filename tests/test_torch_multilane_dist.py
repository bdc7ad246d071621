"""The lane axis over a ``torch.distributed`` group: ``multilane_na_sharded``
and the HAN trainer on 2 and 4 CPU ranks (gloo, ``torch.multiprocessing.spawn``,
``file://`` rendezvous).  No JAX: the one-process port is the reference.

Each world size spawns once (a module fixture, bounded by a timeout);
every rank computes, on small synthetic acm (scale 0.05, B = 16, HAN
hidden 8, heads 2; four metapath graphs), against a balanced plan of 4
lanes and a naive plan of 8, whose last four lanes hold no unit, so that
some rank holds none:

* the sharded NA forward on the reference and kernel backends, which must
  equal the one-process ``multilane_na`` bit for bit (the all-reduce adds
  exact zeros);
* HAN's loss through ``han_forward_multilane(mesh=...)`` on the kernel and
  fused_fp backends, bit for bit the one-process loss, and its gradients, within 1e-8 of the one-process
  gradients (the reference's ``GRAD_ATOL``) and identical on every rank;
* ``run_training(lanes=world)``, whose loss falls, with checkpoints
  written by lane rank 0 alone, then resumed on every rank from the step
  lane rank 0 finds, with no barrier before, and again where the other
  ranks see no checkpoint directory at all (no shared file system).
"""
import datetime
import os
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

GRAD_ATOL = 1e-8  # tests/test_multilane.py: max |Δgrad| across lanes, measured ~1e-9
PLAN_LANES = 4
PLANS = {"balanced": (PLAN_LANES, True), "naive": (2 * PLAN_LANES, False)}
SPAWN_TIMEOUT_S = 180
HAN_BACKENDS = ("kernel", "fused_fp")  # fused_fp: x, w, b, a_src, a_dst replicated
PROBLEM = dict(scale=0.05, feat_scale=0.1, block=16, max_edges=20_000)
WIDTH = dict(hidden=8, heads=2, att_dim=16)


def _worker(rank: int, world: int, init_file: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT_S))
    try:
        from repro_torch.core import build_multilane_plan, multilane_na, multilane_na_sharded
        from repro_torch.launch import hgnn_train
        from repro_torch.launch.mesh import make_lane_mesh
        from repro_torch.models.hgnn import cross_entropy, han_forward_multilane, init_han

        mesh = make_lane_mesh(world, 1, device_type="cpu")
        _, data = hgnn_train.build_problem("acm", device="cpu", **PROBLEM)
        params = init_han(torch.Generator().manual_seed(0), data, **WIDTH)
        res = {}
        g = torch.Generator().manual_seed(1)
        n_pad = data.graphs[0].num_dst_pad
        G, H, Dh = len(data.graphs), WIDTH["heads"], WIDTH["hidden"]
        ths, thd = torch.randn(G, n_pad, H, generator=g), torch.randn(G, n_pad, H, generator=g)
        hs = torch.randn(n_pad, H, Dh, generator=g)
        for balanced, (lanes, is_balanced) in PLANS.items():
            plan = build_multilane_plan(data.graphs, lanes, balanced=is_balanced)
            per = lanes // world
            res[f"units/{balanced}"] = plan.units((rank * per, (rank + 1) * per)).count
            for backend in ("reference", "kernel"):
                one = multilane_na(plan, ths, thd, hs, backend=backend)
                sharded = multilane_na_sharded(plan, ths, thd, hs, mesh=mesh, backend=backend)
                res[f"na_equal/{balanced}/{backend}"] = torch.equal(one, sharded)

            leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
            names = sorted(leaves)
            for backend in HAN_BACKENDS:
                for tag, kw in (("one", {}), ("sharded", dict(mesh=mesh))):
                    loss = cross_entropy(han_forward_multilane(leaves, data, plan,
                                                               backend=backend, **kw),
                                         data.labels)
                    grads = torch.autograd.grad(loss, [leaves[k] for k in names])
                    res[f"loss/{balanced}/{backend}/{tag}"] = loss.detach()
                    res[f"grads/{balanced}/{backend}/{tag}"] = dict(zip(names, grads))

        ckpt = os.path.join(out_dir, "ckpt")
        run = dict(dataset="acm", lanes=world, plan_lanes=PLAN_LANES, hidden=8, heads=2,
                   log_every=1, log=lambda *_: None, device="cpu", ckpt_dir=ckpt,
                   ckpt_every=2, **PROBLEM)
        _, hist, meta = hgnn_train.run_training(steps=4, **run)
        res["losses"] = [h["loss"] for h in hist]
        res["meta"] = meta
        res["ckpt_steps"] = sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []
        # no barrier: lane rank 0 decides the step every rank resumes from,
        # also while the others may not see its last write yet
        _, hist, _ = hgnn_train.run_training(steps=6, **run)
        res["resumed"] = [(h["step"], h["loss"]) for h in hist]
        # no shared file system: the other ranks see no checkpoint directory
        alone = dict(run, ckpt_dir=ckpt if rank == 0 else os.path.join(out_dir, f"unseen{rank}"))
        _, hist, _ = hgnn_train.run_training(steps=8, **alone)
        res["resumed_alone"] = [(h["step"], h["loss"]) for h in hist]
        res["wrote_elsewhere"] = rank > 0 and os.path.exists(alone["ckpt_dir"])
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"{w}ranks")
def ranks(request, tmp_path_factory):
    world = request.param
    out = tmp_path_factory.mktemp(f"lanes{world}")
    ctx = mp.spawn(_worker, args=(world, str(out / "rendezvous"), str(out)), nprocs=world,
                   join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} gloo ranks did not finish in {SPAWN_TIMEOUT_S} s")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def test_sharded_forward_equals_one_process_bitwise(ranks):
    assert 0 in [res["units/naive"] for res in ranks]  # a rank with no unit takes part
    for res in ranks:
        na = {k: v for k, v in res.items() if k.startswith("na_equal/")}
        assert len(na) == 4 and all(na.values()), na


CASES = [f"{balanced}/{backend}" for balanced in PLANS for backend in HAN_BACKENDS]


def test_sharded_han_loss_equals_one_process_bitwise(ranks):
    for res in ranks:
        for case in CASES:
            assert torch.equal(res[f"loss/{case}/one"], res[f"loss/{case}/sharded"]), case


def test_sharded_gradients_match_and_agree_on_every_rank(ranks):
    for case in CASES:
        first = ranks[0][f"grads/{case}/sharded"]
        for res in ranks:
            one, sharded = res[f"grads/{case}/one"], res[f"grads/{case}/sharded"]
            for k in one:
                assert (sharded[k] - one[k]).abs().max() <= GRAD_ATOL, (case, k)
                assert torch.equal(sharded[k], first[k]), (case, k)  # the same on every rank


def test_run_training_over_the_lane_group_lowers_the_loss(ranks):
    world = len(ranks)
    for rank, res in enumerate(ranks):
        losses = res["losses"]
        assert losses[-1] < losses[0], losses
        assert losses == ranks[0]["losses"]
        assert res["meta"]["lanes"] == world and res["meta"]["plan_lanes"] == PLAN_LANES
        assert res["meta"]["backend"] == "kernel"
    # lane rank 0 wrote every checkpoint; every rank resumed from its step 4 alike
    assert ranks[0]["ckpt_steps"] == ["step_2", "step_4"]
    assert [s for s, _ in ranks[0]["resumed"]] == [4, 5]
    assert all(res["resumed"] == ranks[0]["resumed"] for res in ranks)
    assert ranks[0]["resumed"][-1][1] < ranks[0]["losses"][-1]


def test_ranks_that_see_no_checkpoint_resume_from_lane_rank_0s_step(ranks):
    assert [s for s, _ in ranks[0]["resumed_alone"]] == [6, 7]
    assert all(res["resumed_alone"] == ranks[0]["resumed_alone"] for res in ranks)
    assert not any(res["wrote_elsewhere"] for res in ranks)
