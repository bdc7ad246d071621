"""The LM dry run (``repro_torch.launch.dryrun``): its helpers against the
reference's, a training cell at a cut depth under ``--microbatches``, and
the launcher's JSON, cache and exit code.  One decode cell a family on the
16 × 16 production mesh is in ``test_torch_lm_dryrun_decode.py``.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` at import, so the reference's
helpers run in a subprocess of their own: ``model_flops``, ``opt_config``,
``pick_microbatches`` and ``input_specs`` of every arch and shape, and
``_dim_heuristic_spec`` on the caches of every family at decode_32k's and
long_500k's shapes.

The cells are rank 0's program on fake tensors (shape-only CPU counts)."""
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))

REFERENCE = r"""
import json, sys
import jax.numpy as jnp
from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.launch import dryrun as d
from repro.models.lm.api import build
out = {}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    o = d.opt_config(cfg)
    out[arch] = {"opt": [o.factored, o.master_fp32], "mb": d.pick_microbatches(cfg),
                 "flops": {s: d.model_flops(cfg, SHAPES[s]) for s in SHAPES},
                 "inputs": {s: {k: [list(v.shape), str(v.dtype)]
                                for k, v in d.input_specs(cfg, SHAPES[s]).items()}
                            for s in SHAPES},
                 "caches": {}}
    for s in ("decode_32k", "long_500k"):
        b, n = SHAPES[s].global_batch, SHAPES[s].seq_len
        import jax
        caches = jax.eval_shape(lambda: build(cfg).init_caches(b, n, jnp.bfloat16))
        lens = (n,) if not cfg.window else (n, min(n, cfg.window))
        specs = [tuple(x if not isinstance(x, tuple) else list(x)
                       for x in d._dim_heuristic_spec(leaf, batch=b, lens=lens,
                                                      data_axes=("data",)))
                 for leaf in jax.tree.leaves(caches)]
        out[arch]["caches"][s] = [[list(leaf.shape), list(sp)]
                                  for leaf, sp in zip(jax.tree.leaves(caches), specs)]
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_DRYRUN_DEVICES="1",
               PYTHONPATH=os.pathsep.join([os.path.join(HERE, "..", "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", REFERENCE], check=True, env=env, timeout=300,
                         capture_output=True, text=True)
    return json.loads(out.stdout)


def test_helpers_match_the_reference(reference):
    from repro_torch.configs import ARCH_IDS, SHAPES, get_config
    from repro_torch.launch import dryrun as d

    for arch in ARCH_IDS:
        cfg, want = get_config(arch), reference[arch]
        o = d.opt_config(cfg)
        assert [o.factored, o.master_fp32] == want["opt"], arch
        assert d.pick_microbatches(cfg) == want["mb"] and d.pick_microbatches(cfg, 3) == 3
        for s, shape in SHAPES.items():
            assert d.model_flops(cfg, shape) == want["flops"][s], (arch, s)
            got = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                   for k, v in d.input_specs(cfg, shape).items()}
            assert got == want["inputs"][s], (arch, s)


def test_cache_spec_is_the_reference_heuristic(reference):
    from repro_torch.configs import ARCH_IDS, SHAPES, get_config
    from repro_torch.launch import dryrun as d

    sizes = {"data": 16, "model": 16}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for s in ("decode_32k", "long_500k"):
            b, n = SHAPES[s].global_batch, SHAPES[s].seq_len
            lens = (n,) if not cfg.window else (n, min(n, cfg.window))
            for dims, want in reference[arch]["caches"][s]:
                got = d.cache_spec(tuple(dims), batch=b, lens=lens, data_axes=("data",),
                                   sizes=sizes)
                assert [list(x) if isinstance(x, tuple) else x for x in got] == want, \
                    (arch, s, dims)


def test_long_context_cells_of_full_attention_archs_are_skipped():
    from repro_torch.launch.dryrun import run_cell

    res = run_cell("llama3.2-3b", "long_500k")
    assert res["status"] == "skipped" and "quadratic" in res["reason"]


@pytest.mark.parametrize("arch", ["llama3.2-3b", "dbrx-132b", "mamba2-2.7b"])
def test_a_training_cell_under_microbatches(arch):
    """train_4k at full width and one layer, ``--microbatches 2``: 256 rows
    over 16 data ranks in 2 microbatches of 8 rows a rank; the ``fsdp``
    leaves gathered over ``data`` in the forward and their grads
    reduce-scattered; the model's 6·N·D within the cell's FLOPs (remat's
    recompute and the replicated attention on top)."""
    from repro_torch.launch.dryrun import run_cell

    res = run_cell(arch, "train_4k", microbatches=2, layers=1)
    assert res["status"] == "ok", res.get("traceback")
    assert res["microbatches"] == 2 and res["layers"] == 1
    counts = res["op_stats"]["collective_count"]
    assert counts["reduce-scatter"] > 0 and counts["all-gather"] > 0
    ratio = res["op_stats"]["dot_flops_per_device"] * 256 / res["model_flops"]
    assert 1.0 <= ratio <= 3.0, ratio


def test_a_multi_pod_training_cell():
    """2 × 16 × 16: the data group is ``("pod", "data")`` flattened, 32 ranks
    of 8 rows each in one microbatch of 256."""
    from repro_torch.launch.dryrun import run_cell

    res = run_cell("llama3.2-3b", "train_4k", multi_pod=True, microbatches=1, layers=1)
    assert res["status"] == "ok", res.get("traceback")
    assert res["mesh"] == "pod2x16x16" and res["chips"] == 512 and res["microbatches"] == 1
    ratio = res["op_stats"]["dot_flops_per_device"] * 512 / res["model_flops"]
    assert 1.0 <= ratio <= 3.0, ratio


def test_the_launcher_writes_cells_caches_them_and_fails(tmp_path, capsys, monkeypatch):
    from repro_torch.launch import dryrun
    from repro_torch.launch.dryrun import main

    out = str(tmp_path)
    main(["--arch", "llama3.2-3b", "--shape", "long_500k", "--out", out])
    cell = json.loads((tmp_path / "llama3.2-3b__long_500k__pod16x16.json").read_text())
    assert cell["status"] == "skipped"
    main(["--arch", "llama3.2-3b", "--shape", "long_500k", "--out", out])
    assert "[skip-cached] llama3.2-3b__long_500k__pod16x16" in capsys.readouterr().out
    # a cell that fails is written with its error, never skipped as cached, and
    # the run exits non-zero
    failed = {"status": "failed", "error": "RuntimeError: a fault", "traceback": "..."}
    monkeypatch.setattr(dryrun, "run_cell", lambda *a, **k: dict(failed))
    for _ in range(2):
        with pytest.raises(SystemExit, match="1 cells failed"):
            main(["--arch", "llama3.2-3b", "--shape", "decode_32k", "--out", out])
    cell = json.loads((tmp_path / "llama3.2-3b__decode_32k__pod16x16.json").read_text())
    assert cell == failed
