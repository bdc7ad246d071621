"""The port's LM trainer end to end on the CPU, as ``tests/test_train.py``
holds the reference's: the loss falls, a crash at any step resumes bit for
bit, a torn checkpoint write is never picked up, checkpoints cross between
the packages in both directions (bf16 leaves, the float32 master and the
factored state's absent slots included), and the launcher
(``repro_torch.launch.train``) and ``examples_torch/train_lm.py`` run with
``--device cpu``."""
import dataclasses
import importlib.util
import json
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
from repro.configs import smoke_config as jsmoke_config
from repro.models.lm.api import build as jbuild
from repro.optim import AdamWConfig as JOpt
from repro.train.step import init_train_state as jinit_state
from repro_torch import checkpoint as tckpt
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_train_state_from_numpy
from repro_torch.data import SyntheticLMData
from repro_torch.launch import train as tlaunch
from repro_torch.models.lm.api import build
from repro_torch.optim import AdamWConfig
from repro_torch.train import make_train_step, train_loop
from repro_torch.train.step import init_train_state
from repro_torch.tree import tree_leaves, tree_leaves_with_path

ROOT = pathlib.Path(__file__).resolve().parents[1]
_SILENT = lambda *_: None  # noqa: E731


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tests run many small steps, which
    threads only slow down when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = smoke_config("llama3.2-3b")
    api = build(cfg)
    opt = AdamWConfig(lr=1e-2, weight_decay=0.0)
    step = make_train_step(api, opt, lr_schedule=lambda s: torch.tensor(1e-2))
    return cfg, api, opt, step


def _data(cfg):
    return SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=16, global_batch=16, seed=7)


def _init(api, opt):
    return init_train_state(api, torch.Generator().manual_seed(0), opt, device="cpu")


def test_loss_decreases(setup, tmp_path):
    cfg, api, opt, step = setup
    log = tmp_path / "train.jsonl"
    _, hist = train_loop(state=_init(api, opt), train_step=step, data=_data(cfg), steps=50,
                         log_every=10, log=_SILENT, log_jsonl=str(log))
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.85, [h["loss"] for h in hist]
    records = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in records] == [0, 10, 20, 30, 40, 49]
    assert all(r["event"] == "train" for r in records)


def test_crash_resume_bit_identical(setup, tmp_path):
    cfg, api, opt, step = setup
    ref, _ = train_loop(state=_init(api, opt), train_step=step, data=_data(cfg), steps=25,
                        ckpt_dir=str(tmp_path / "a"), ckpt_every=10, log=_SILENT)
    with pytest.raises(RuntimeError, match="injected failure"):
        train_loop(state=_init(api, opt), train_step=step, data=_data(cfg), steps=25,
                   ckpt_dir=str(tmp_path / "b"), ckpt_every=10, crash_at=17, log=_SILENT)
    assert tckpt.latest_step(str(tmp_path / "b")) == 10
    resumed, _ = train_loop(state=_init(api, opt), train_step=step, data=_data(cfg), steps=25,
                            ckpt_dir=str(tmp_path / "b"), ckpt_every=10, log=_SILENT)
    for x, y in zip(tree_leaves(ref), tree_leaves(resumed)):
        assert torch.equal(x, y)
    assert int(resumed.step) == 25 and int(resumed.opt["count"]) == 25


def test_checkpoint_atomicity(setup, tmp_path):
    """A leftover .tmp dir from a crashed write must not be picked up."""
    cfg, api, opt, _ = setup
    state = _init(api, opt)
    tckpt.save_checkpoint(str(tmp_path), 10, state, aux={"data": {"step": 10, "seed": 7}})
    os.makedirs(tmp_path / "step_20.tmp")  # a torn write
    assert tckpt.latest_step(str(tmp_path)) == 10
    restored, aux = tckpt.restore_checkpoint(str(tmp_path), 10, state)
    assert aux["data"]["step"] == 10
    for x, y in zip(tree_leaves(state), tree_leaves(restored)):
        assert torch.equal(x, y)


# bf16 params with a float32 master (qwen3-8b's own param dtype) and the
# factored state, whose absent slots the tree leaves out
CROSS = {"bf16_params_master": dict(), "factored_bf16_params": dict(factored=True)}


def _bits(a) -> np.ndarray:
    """The raw bytes of an array (numpy, a bf16 or V2 array, or a tensor)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 and a.dtype.kind in "Vf" else a


@pytest.mark.parametrize("mode", CROSS)
def test_checkpoints_cross_between_the_packages(mode, tmp_path):
    jcfg = dataclasses.replace(jsmoke_config("qwen3-8b"), param_dtype="bfloat16")
    tcfg = dataclasses.replace(smoke_config("qwen3-8b"), param_dtype="bfloat16")
    jstate = jinit_state(jbuild(jcfg), jax.random.key(0), JOpt(**CROSS[mode]))
    nstate = [jax.tree.map(np.asarray, t) for t in (jstate.params, jstate.opt, jstate.step)]
    want = lm_train_state_from_numpy(*nstate, device="cpu")
    assert want.params["embed"].dtype == torch.bfloat16
    assert tree_leaves(want.opt["master"])[0].dtype == torch.float32
    like = init_train_state(build(tcfg), torch.Generator().manual_seed(1),
                            AdamWConfig(**CROSS[mode]), device="cpu")
    # the reference writes, the port reads
    jckpt.save_checkpoint(str(tmp_path / "j"), 3, jstate, aux={"data": {"step": 3, "seed": 0}})
    got, aux = tckpt.restore_checkpoint(str(tmp_path / "j"), 3, like)
    assert aux == {"data": {"step": 3, "seed": 0}}
    keys = [k for k, _ in tree_leaves_with_path(want)]
    assert [k for k, _ in tree_leaves_with_path(got)] == keys
    for (k, x), y in zip(tree_leaves_with_path(got), tree_leaves(want)):
        assert x.dtype == y.dtype and torch.equal(x, y), k
    # the port writes, the reference reads: the same bytes as its own checkpoint
    tckpt.save_checkpoint(str(tmp_path / "t"), 3, want, aux={})
    mine = json.loads((tmp_path / "t" / "step_3" / "manifest.json").read_text())["leaves"]
    theirs = json.loads((tmp_path / "j" / "step_3" / "manifest.json").read_text())["leaves"]
    assert [(m["key"], m["dtype"], m["shape"]) for m in mine] == [
        (m["key"], m["dtype"], m["shape"]) for m in theirs]
    back, _ = jckpt.restore_checkpoint(str(tmp_path / "t"), 3, jstate)
    own, _ = jckpt.restore_checkpoint(str(tmp_path / "j"), 3, jstate)
    for x, y, z in zip(jax.tree.leaves(back), jax.tree.leaves(own), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(_bits(x), _bits(y))
        np.testing.assert_array_equal(_bits(x), _bits(z))


def test_launcher_smoke_on_cpu_loss_falls(capsys, tmp_path):
    tlaunch.main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
                  "--ckpt", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    last = out.strip().splitlines()[-1]
    start, final = float(last.split("start ")[1].rstrip(")")), float(last.split()[2])
    assert last.startswith("final loss") and final < start, out
    assert "[train] step=0 " in out and "[train] step=19 " in out
    assert tckpt.latest_step(str(tmp_path / "ck")) == 20


def test_launcher_crash_and_resume_is_bitwise(tmp_path):
    """The launcher's run crashed at step 3 and resumed from its step-2
    checkpoint equals an uninterrupted run (whisper's smoke config: frames
    ride in the batch)."""
    kw = dict(smoke=True, steps=6, global_batch=4, seq=8, device="cpu", log=_SILENT)
    ref, _ = tlaunch.run_training("whisper-large-v3", **kw)
    with pytest.raises(RuntimeError, match="injected failure"):
        tlaunch.run_training("whisper-large-v3", ckpt=str(tmp_path), ckpt_every=2, crash_at=3,
                             **kw)
    assert tckpt.latest_step(str(tmp_path)) == 2
    got, hist = tlaunch.run_training("whisper-large-v3", ckpt=str(tmp_path), ckpt_every=2, **kw)
    assert tckpt.latest_step(str(tmp_path)) == 6
    assert [h["step"] for h in hist] == [5]  # logged steps 0 and 5: 0 ran before the crash
    for x, y in zip(tree_leaves(ref), tree_leaves(got)):
        assert torch.equal(x, y)


def test_train_lm_example_on_cpu(capsys):
    spec = importlib.util.spec_from_file_location("examples_torch_train_lm",
                                                  ROOT / "examples_torch" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    hist = mod.main(["--device", "cpu", "--steps", "20", "--arch", "llama3.2-3b"])
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("final loss: ")
