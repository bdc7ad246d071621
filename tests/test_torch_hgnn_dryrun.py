"""Item 7i's HGNN half: ``models.lm.layers.abstract_from_specs`` against the
reference's for every config, ``launch.mesh.make_production_mesh`` and
``make_lane_mesh``'s production geometry over ``fake`` process groups of
256 and 512 ranks, ``launch.opstats`` on a small call, and the shape-only
dry run ``launch.hgnn_dryrun`` at 65,536 vertices: the reference's
formulas for lanes, units a lane and dense block positions, FLOPs equal
to an analytic count of the NA's and the tail's products at those shapes,
the all-reduce that ``multilane_na_sharded`` issues, and the kernel
backends refused.  On real tensors, the aligned schedule's step on 2
gloo ranks against the reference's ``aligned_lane_step_builder`` over all
lanes, and the LSF + GSF tail against the reference's ``_sf_tail``.

``repro.launch.hgnn_dryrun`` sets ``XLA_FLAGS`` at import, so this module
does not import it: the reference's numbers here are its formulas, and
its aligned step runs in a subprocess of its own."""
import contextlib
import datetime
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

VERTICES, BLOCK, G, H, DH, W, DA = 65536, 128, 3, 8, 64, 16, 128


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
def test_abstract_from_specs_matches_the_reference(arch):
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models.lm import encdec as jencdec
    from repro.models.lm import layers as jlayers
    from repro.models.lm import transformer as jtransformer
    from repro_torch import configs as tconfigs
    from repro_torch.configs import ARCH_IDS
    from repro_torch.models.lm import encdec, layers, transformer
    from repro_torch.tree import tree_leaves_with_path

    assert arch in ARCH_IDS
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jspecs = (jencdec.encdec_specs if jcfg.is_encoder_decoder else jtransformer.decoder_specs)(jcfg)
    tspecs = (encdec.encdec_specs if tcfg.is_encoder_decoder else transformer.decoder_specs)(tcfg)
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)) for k, v in
            jax.tree_util.tree_flatten_with_path(
                jlayers.abstract_from_specs(jspecs, jnp.dtype(jcfg.param_dtype)))[0]}
    got = {k.replace("/", ""): (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in tree_leaves_with_path(layers.abstract_from_specs(tspecs, tcfg.param_dtype))}
    assert got == want
    leaf = next(iter(tree_leaves_with_path(layers.abstract_from_specs(tspecs))))[1]
    assert leaf.is_meta and leaf.dtype == torch.float32


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multi_pod"])
def test_the_production_meshes_have_the_reference_geometry(multi_pod):
    """``repro.launch.mesh``: 16 × 16 over ("data", "model"), a leading 2-pod
    axis with ``multi_pod``; ``make_lane_mesh()`` the same over ("lane",
    "model")."""
    from repro_torch.launch.mesh import make_lane_mesh, make_production_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    with fake_group(int(np.prod(shape))):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert tuple(mesh.shape) == shape
        assert mesh.mesh_dim_names == (("pod",) if multi_pod else ()) + ("data", "model")
        lane = make_lane_mesh(multi_pod=multi_pod, device_type="cpu")
        assert tuple(lane.shape) == shape
        assert lane.mesh_dim_names == (("pod",) if multi_pod else ()) + ("lane", "model")
        assert dist.get_world_size(lane.get_group("lane")) == 16
    with fake_group(8):
        assert tuple(make_lane_mesh(2, 2, multi_pod=True, device_type="cpu").shape) == (2, 2, 2)
    assert make_lane_mesh(1, 1) is None


def test_opstats_counts_products_and_collectives():
    from repro_torch.launch.opstats import analyze, span_attrs

    a, q = torch.randn(10, 8), torch.randn(8)
    x, y = torch.ones(100), torch.ones(8, 16, dtype=torch.bfloat16)

    def run():
        a @ a.T, a @ q, torch.einsum("p,pnd->nd", q[:3], torch.ones(3, 5, 7))
        dist.all_reduce(x)
        dist.all_reduce(y)
        parts = [torch.empty(10) for _ in range(4)]
        dist.all_gather(parts, torch.ones(10))
        dist.broadcast(x, src=0)

    with fake_group(4):
        stats = analyze(run)
    assert stats.dot_flops == 2 * 10 * 8 * 10 + 2 * 10 * 8 + 2 * 3 * 5 * 7
    assert stats.collective_count == {"all-reduce": 2, "all-gather": 1, "broadcast": 1}
    assert stats.collective_bytes == {"all-reduce": 400 + 256, "all-gather": 160,
                                      "broadcast": 400}
    attrs = span_attrs(stats, schedule="x")
    assert attrs["collective_bytes"] == stats.total_collective_bytes == 1216
    assert attrs["collective_launches"] == 4 and attrs["schedule"] == "x"


def _na_flops(units: int) -> int:
    """One unit's NA product: p [B, W·B] per head times h [W·B, Dh]."""
    return units * 2 * BLOCK * W * BLOCK * H * DH


@pytest.fixture(scope="module")
def dryruns(tmp_path_factory):
    from repro_torch.launch import hgnn_dryrun

    out = tmp_path_factory.mktemp("dryrun")
    res = {}
    for schedule in ("balanced", "aligned"):
        res[schedule] = hgnn_dryrun.main(["--vertices", str(VERTICES), "--schedule", schedule,
                                          "--out", str(out / f"{schedule}.json"),
                                          "--trace", str(out / f"{schedule}.trace.json")])
        assert json.loads((out / f"{schedule}.json").read_text()) == res[schedule]
    return res, out


def test_the_balanced_dry_run_counts_rank_0s_program(dryruns):
    res, _ = dryruns
    r = res["balanced"]
    lanes, rows = 256, VERTICES // BLOCK
    units = rows * G // lanes  # the reference's formulas
    assert (r["status"], r["mesh"], r["lanes"], r["units_per_lane"], r["graphs"]) == \
        ("ok", "pod16x16", lanes, units, G)
    assert r["dense_block_positions"] == lanes * units * W * BLOCK * BLOCK
    # rank 0: 16 of the 256 lanes (a lane group of 16), then the tail over every vertex:
    # LSF's tanh(z W_g) and its q product a graph, GSF's combine
    n = VERTICES
    tail = G * (2 * n * H * DH * DA + 2 * n * DA) + 2 * G * n * H * DH
    assert r["dot_flops_per_device"] == _na_flops(16 * units) + tail
    # multilane_na_sharded's one all-reduce of the [G, N, H, Dh] float32 output
    assert r["collective_count"] == {"all-reduce": 1}
    assert r["collective_bytes"] == {"all-reduce": G * n * H * DH * 4}
    assert r["compute_s"] == r["dot_flops_per_device"] / 989e12
    assert r["collective_s"] == G * n * H * DH * 4 / 450e9
    # the inputs alone: rank 0's masks, the thetas and h
    assert r["mem_per_device_gib"] * 2**30 > 16 * units * W * BLOCK * BLOCK + 2 * G * n * H * 4


def test_the_aligned_dry_run_counts_rank_0s_program(dryruns):
    res, _ = dryruns
    r = res["aligned"]
    lanes, rows = 256, VERTICES // BLOCK
    ur = rows // lanes
    assert (r["schedule"], r["lanes"], r["units_per_lane"]) == ("aligned", lanes, ur)
    assert r["dense_block_positions"] == lanes * ur * W * BLOCK * BLOCK
    rows0 = 16 * ur * BLOCK  # rank 0's dst rows, each of every graph
    tail = G * rows0 * (2 * H * DH * DA + 2 * DA) + 2 * G * rows0 * H * DH
    assert r["dot_flops_per_device"] == _na_flops(16 * ur * G) + tail
    # only the G partial importances cross lanes
    assert r["collective_count"] == {"all-reduce": 1}
    assert r["collective_bytes"] == {"all-reduce": G * 4}


def test_the_trace_carries_the_opstats(dryruns):
    res, out = dryruns
    events = json.loads((out / "balanced.trace.json").read_text())["traceEvents"]
    run = [e for e in events if e.get("name") == "dryrun/run"]
    assert len(run) == 1
    args = run[0]["args"]
    assert args["dot_flops"] == res["balanced"]["dot_flops_per_device"]
    assert args["collective_bytes.all-reduce"] == res["balanced"]["collective_bytes"]["all-reduce"]
    assert any(e.get("name") == "na/multilane_sharded" for e in events)


def test_the_multi_pod_dry_run_splits_lanes_over_pod_and_lane(tmp_path):
    from repro_torch.launch import hgnn_dryrun

    r = hgnn_dryrun.main(["--vertices", str(VERTICES), "--multi-pod", "--schedule", "aligned",
                          "--out", str(tmp_path / "mp.json")])
    lanes = 512
    assert (r["mesh"], r["lanes"], r["lane_group"]) == ("pod2x16x16", lanes, 32)
    assert r["units_per_lane"] == VERTICES // BLOCK // lanes


@pytest.mark.parametrize("backend", ["kernel", "kernel_interpret", "fused_fp",
                                     "fused_fp_interpret"])
def test_a_kernel_backend_is_refused(backend, tmp_path):
    from repro_torch.launch import hgnn_dryrun

    with pytest.raises(SystemExit, match="real CUDA tensors"):
        hgnn_dryrun.main(["--vertices", "1024", "--na-backend", backend,
                          "--out", str(tmp_path / "x.json")])
    assert not dist.is_initialized()


def test_the_reference_flag_rules_hold(tmp_path):
    from repro_torch.launch import hgnn_dryrun

    for argv in (["--schedule", "aligned", "--executor", "shard_map"],
                 ["--schedule", "aligned", "--na-backend", "kernel"]):
        with pytest.raises(SystemExit) as e:
            hgnn_dryrun.main(argv + ["--out", str(tmp_path / "x.json")])
        assert e.value.code == 2


# the aligned step and the tail on real tensors: 4 lanes of 2 dst rows, 2 graphs, W = 3,
# B = 8, H = 2, Dh = 4 (rows of 8, src blocks of 8); float32 sums in other orders
AL = dict(lanes=4, ur=2, g=2, w=3, block=8, h=2, dh=4, rows=8, da=16)
AL_RANKS, AL_TIMEOUT_S = 2, 120
AL_TOL = dict(rtol=1e-5, atol=1e-6)
REFERENCE_ALIGNED = """
import sys
import numpy as np
from repro.launch.hgnn_dryrun import aligned_lane_step_builder
d = dict(np.load(sys.argv[1]))
a = {k: int(v) for k, v in zip(d.pop("names"), d.pop("sizes"))}
step = aligned_lane_step_builder(a["g"], a["ur"], a["block"], a["h"], a["dh"],
                                 a["rows"] * a["block"])
fused, beta = step(*(d[k] for k in ("col_index", "masks", "row_ids", "th_s", "th_d",
                                    "h_src", "w_g", "q")))
np.savez(sys.argv[2], fused=np.asarray(fused), beta=np.asarray(beta))
"""


def _aligned_inputs() -> dict:
    """Random units (each block row with a live slot in its first column,
    a padded column -1 among the rest), thetas, h and the LSF params."""
    a = AL
    rng = np.random.default_rng(0)
    lead = (a["lanes"], a["ur"], a["g"])
    ns_pad = a["rows"] * a["block"]
    cols = rng.integers(-1, a["rows"], lead + (a["w"],)).astype(np.int32)
    cols[..., 0] = rng.integers(0, a["rows"], lead)
    masks = rng.random(lead + (a["w"], a["block"], a["block"])) < 0.5
    masks[..., 0, :, 0] = True
    return dict(col_index=cols, masks=masks,
                row_ids=rng.permutation(a["rows"]).reshape(a["lanes"], a["ur"]).astype(np.int32),
                th_s=rng.standard_normal((a["g"], ns_pad, a["h"]), np.float32),
                th_d=rng.standard_normal((a["g"], ns_pad, a["h"]), np.float32),
                h_src=rng.standard_normal((ns_pad, a["h"], a["dh"]), np.float32),
                w_g=(rng.standard_normal((a["h"] * a["dh"], a["da"]), np.float32) / 4),
                q=rng.standard_normal((a["da"],), np.float32))


def _aligned_rank(rank: int, world: int, init_file: str, inputs: str, out_dir: str) -> None:
    """One gloo rank: ``aligned_lane_step`` on its block of lanes."""
    from repro_torch.launch.hgnn_dryrun import aligned_lane_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=AL_TIMEOUT_S))
    try:
        d = dict(np.load(inputs))
        n = AL["lanes"] // world
        own = slice(rank * n, (rank + 1) * n)
        t = {k: torch.from_numpy(v[own] if k in ("col_index", "masks", "row_ids") else v)
             for k, v in d.items()}
        fused, beta = aligned_lane_step(t["col_index"], t["masks"], t["row_ids"], t["th_s"],
                                        t["th_d"], t["h_src"], t["w_g"], t["q"],
                                        group=dist.group.WORLD,
                                        ns_pad=AL["rows"] * AL["block"])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), fused=fused.numpy(),
                 beta=beta.numpy())
    finally:
        dist.destroy_process_group()


def test_the_aligned_step_matches_the_reference(tmp_path):
    """Each rank's fused rows and the all-reduced beta against the
    reference's step over all lanes (run in a subprocess: its module sets
    ``XLA_FLAGS`` at import)."""
    given = _aligned_inputs()
    np.savez(tmp_path / "inputs.npz", **given)
    np.savez(tmp_path / "ref_inputs.npz", **given, names=np.array(list(AL)),
             sizes=np.array(list(AL.values())))
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE_ALIGNED, str(tmp_path / "ref_inputs.npz"),
                            str(tmp_path / "ref.npz")], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        ctx = mp.spawn(_aligned_rank, args=(AL_RANKS, str(tmp_path / "rendezvous"),
                                            str(tmp_path / "inputs.npz"), str(tmp_path)),
                       nprocs=AL_RANKS, join=False)
        deadline = time.monotonic() + AL_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"{AL_RANKS} gloo ranks did not finish in {AL_TIMEOUT_S} s")
        out, _ = ref.communicate(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        ref.kill()
    assert ref.returncode == 0, out
    want = np.load(tmp_path / "ref.npz")
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(AL_RANKS)]
    for r in ranks:
        torch.testing.assert_close(torch.from_numpy(r["beta"]), torch.from_numpy(want["beta"]),
                                   **AL_TOL)
    got = np.concatenate([r["fused"] for r in ranks])
    assert got.shape == want["fused"].shape == (AL["lanes"], AL["ur"], AL["block"],
                                                AL["h"] * AL["dh"])
    torch.testing.assert_close(torch.from_numpy(got), torch.from_numpy(want["fused"]), **AL_TOL)
    assert np.abs(want["beta"] - 1 / AL["g"]).max() > 1e-3  # the graphs' weights differ


def test_the_tail_matches_the_reference():
    """``sf_tail`` against the reference's ``_sf_tail`` (LSF per graph with a
    zero bias and every vertex valid, then GSF), written with
    ``repro.core.stages``; W_g is 128 wide, as the reference's bias."""
    import jax.numpy as jnp

    from repro.core import stages as jstages
    from repro_torch.launch.hgnn_dryrun import sf_tail

    rng = np.random.default_rng(1)
    g, n, h, dh = 3, 40, 2, 4
    z = rng.standard_normal((g, n, h, dh), np.float32)
    w_g = rng.standard_normal((h * dh, 128), np.float32) / 4
    q = rng.standard_normal((128,), np.float32)

    zf = jnp.asarray(z).reshape(g, n, h * dh)
    w_p = jnp.stack([jstages.local_semantic_fusion(zf[p], jnp.asarray(w_g), jnp.zeros((128,)),
                                                   jnp.asarray(q), jnp.ones((n,), bool))
                     for p in range(g)])
    want_fused, want_beta = jstages.global_semantic_fusion(w_p, zf)
    fused, beta = sf_tail(torch.from_numpy(z), torch.from_numpy(w_g), torch.from_numpy(q))
    torch.testing.assert_close(beta, torch.tensor(np.asarray(want_beta)), **AL_TOL)
    torch.testing.assert_close(fused, torch.tensor(np.asarray(want_fused)), **AL_TOL)
    assert np.abs(np.asarray(want_beta) - 1 / g).max() > 1e-3
