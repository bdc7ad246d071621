"""Port hygiene: ``repro_torch``, ``examples_torch/`` and ``chip_smoke.py``
import neither JAX nor the JAX package; the entry points default to the
card and raise without one; and, on a host with a card, each CUDA kernel
agrees with its plain PyTorch version (those tests carry the ``cuda``
marker and skip here: a CUDA kernel has no CPU mode)."""
import ast
import importlib.util
import json
import pathlib
import re

import numpy as np
import pytest
import torch

import repro_torch.kernels.build as kbuild
from repro_torch.core import NABackend
from repro_torch.graphs import build_semantic_graph, synthetic_hetgraph
from repro_torch.kernels import (
    seg_gat_agg_fused_fp_fwd,
    seg_gat_agg_fused_fp_plain,
    seg_gat_agg_multigraph_fwd,
    seg_gat_agg_multigraph_plain,
)
from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.launch import hgnn_serve
from repro_torch.launch import serve as lm_serve
from repro_torch.launch import train as lm_train
from repro_torch.models.lm.api import build as build_lm
from repro_torch.models.hgnn import prepare_data
from repro_torch.serve import GraphRequest, HGNNEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + sorted((ROOT / "examples_torch").glob("*.py")) + [ROOT / "chip_smoke.py"])


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = synthetic_hetgraph("imdb", scale=0.05, feat_scale=0.02, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HGNNEngine(g, target_type="movie")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hgnn_serve.main(["--na-backend", "multigraph"])
    sg = build_semantic_graph(g, ("movie", "director", "movie"), max_edges=2000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_data(g, [sg], "movie", 3)


def test_lm_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_serve.main(["--arch", "llama3.2-3b", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example("serve_lm").main(["--arch", "whisper-large-v3"])
    for arch in ("llama3.2-3b", "whisper-large-v3"):
        api = build_lm(smoke_config(arch))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.init(torch.Generator().manual_seed(0))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.init_caches(1, 4)


def test_lm_training_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_train.main(["--arch", "llama3.2-3b", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example("train_lm").main(["--arch", "dbrx-132b", "--steps", "1"])
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import init_train_state

    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(build_lm(smoke_config("llama3.2-3b")), torch.Generator().manual_seed(0),
                         AdamWConfig())


def _example(name: str):
    """A script of ``examples_torch/`` as a module."""
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_lm_example_runs_every_arch_on_cpu(arch, capsys):
    """``examples_torch/serve_lm.py``, the twin of ``examples/serve_lm.py``:
    the reference's lines for each architecture's smoke config."""
    _example("serve_lm").main(["--arch", arch, "--device", "cpu", "--batch", "2",
                               "--steps", "3"])
    lines = capsys.readouterr().out.splitlines()
    cfg = smoke_config(arch)
    assert lines[0] == f"arch={cfg.name} family={cfg.family}"
    assert re.fullmatch(r"generated 6 tokens in \d+\.\d\ds \(\d+\.\d tok/s on cpu\)", lines[1])
    assert len(lines) == 4
    for i, line in enumerate(lines[2:]):
        prefix, row = line.split(": ")
        toks = json.loads(row)
        assert prefix == f"  request {i}" and len(toks) == 3
        assert all(0 <= t < cfg.vocab_size for t in toks)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kbuild.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kbuild._nvcc()


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _multigraph_operands(seed, B=16, U=12, W=5, G=3, H=8, Dh=64, nblk=6):
    rng = np.random.default_rng(seed)
    col = np.full((U, W), -1, np.int32)
    for u in range(U):
        k = rng.integers(0, W + 1)  # k = 0: an all-padding unit
        col[u, :k] = rng.choice(nblk, size=k, replace=False)
    masks = rng.random((U, W, B, B)) < 0.3
    masks[0, :, 1, :] = False  # a fully masked dst row
    return dict(
        col_index=col, graph_id=rng.integers(0, G, U).astype(np.int32),
        dst_row=rng.integers(0, nblk, U).astype(np.int32), masks=masks,
        theta_src=rng.standard_normal((G, nblk * B, H)).astype(np.float32),
        theta_dst=rng.standard_normal((G, nblk * B, H)).astype(np.float32),
        h_src=rng.standard_normal((nblk * B, H, Dh)).astype(np.float32),
        edge_bias=rng.standard_normal((G, H)).astype(np.float32),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Dh", [(8, 2, 8), (16, 8, 64), (32, 4, 32)])
def test_multigraph_kernel_matches_plain_on_cuda(cuda, B, H, Dh):
    ops = {k: torch.from_numpy(v).to(cuda)
           for k, v in _multigraph_operands(B, B=B, H=H, Dh=Dh).items()}
    out, lse = seg_gat_agg_multigraph_fwd(**ops)
    ref_out, ref_lse = seg_gat_agg_multigraph_plain(**ops)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref_out, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Dh,din,tables", [(8, 2, 4, 12, 2), (16, 8, 64, 203, 1), (16, 4, 16, 64, 2)])
def test_fused_fp_kernel_matches_plain_on_cuda(cuda, B, H, Dh, din, tables):
    mg = _multigraph_operands(din, B=B, H=H, Dh=Dh)
    rng = np.random.default_rng(din)
    G, n = mg["theta_src"].shape[0], mg["h_src"].shape[0]
    ops = dict(
        col_index=mg["col_index"], graph_id=mg["graph_id"], dst_row=mg["dst_row"],
        wsel=rng.integers(0, tables, G).astype(np.int32), masks=mg["masks"],
        x=rng.standard_normal((n, din)).astype(np.float32),
        w=(rng.standard_normal((tables, din, H * Dh)) / np.sqrt(din)).astype(np.float32),
        b=rng.standard_normal((tables, H * Dh)).astype(np.float32) * 0.1,
        a_src=rng.standard_normal((G, H, Dh)).astype(np.float32),
        a_dst=rng.standard_normal((G, H, Dh)).astype(np.float32),
        edge_bias=mg["edge_bias"],
    )
    ops = {k: torch.from_numpy(v).to(cuda) for k, v in ops.items()}
    out, lse = seg_gat_agg_fused_fp_fwd(**ops)
    ref_out, ref_lse = seg_gat_agg_fused_fp_plain(**ops)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref_out, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", [NABackend.MULTIGRAPH, NABackend.FUSED_FP])
def test_engine_on_cuda_matches_cpu(cuda, backend):
    g = synthetic_hetgraph("imdb", scale=0.05, feat_scale=0.02, seed=0)
    mps = [("movie", "director", "movie"), ("movie", "actor", "movie")]
    res = {}
    for dev in ("cpu", "cuda"):
        eng = HGNNEngine(g, target_type="movie", backend=backend, block=8, device=dev)
        eng.submit(GraphRequest(rid=0, metapaths=mps))
        res[dev] = eng.run()[0].result
    torch.testing.assert_close(res["cuda"].cpu(), res["cpu"], atol=1e-4, rtol=1e-4)
