"""The port's ``lm_loss`` and its gradients against ``jax.value_and_grad``
of the JAX package's, for the smoke config of every architecture in
``ARCH_IDS``, in float32: the decoder families here, the rest in
``test_torch_lm_train_loss_more.py``.

Weights come from the JAX ``init`` (constant leaves perturbed so that
they are exercised) and cross over through ``convert.lm_params_from_numpy``;
batches come from the reference's ``SyntheticLMData`` and cross through
numpy, with M-RoPE ``positions`` and ``visual_embeds`` for the VLM and
``frames`` for whisper.  Tolerances: the loss at rtol 1e-5, each gradient
leaf within 1e-4 of its largest magnitude (float32: the sums run in
other orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import SyntheticLMData as JData
from repro.models.lm.api import build as jbuild
from repro.train import lm_loss as jlm_loss
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.lm.api import build as tbuild
from repro_torch.train import lm_loss
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import tree_leaves_with_path

B, S = 2, 16
GRAD_REL = 1e-4
# the families split over two files, each well under 30 s
TRANSFORMER_ARCHS = ["qwen2-vl-7b", "llama3.2-3b", "qwen2-7b", "qwen3-8b", "minitron-4b"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tests run many small steps, which
    threads only slow down when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke_pair(arch: str, **over):
    return (dataclasses.replace(jconfigs.smoke_config(arch), **over),
            dataclasses.replace(tconfigs.smoke_config(arch), **over))


def shared_params(jcfg, seed=0):
    """(JAX params, numpy params): the reference's init, constant leaves
    perturbed."""
    params = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.key(seed)))
    rng = np.random.default_rng(seed)

    def perturb(a):
        if a.size and (a == a.flat[0]).all():
            a = (a.astype(np.float32) + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    params = jax.tree.map(perturb, params)
    return jax.tree.map(jnp.asarray, params), params


def batch_of(cfg, b=B, s=S, seed=3, bf16_frames=False) -> dict:
    """The reference's synthetic batch (numpy), with the family's extra
    inputs: M-RoPE positions of a 2 x 2 visual grid and visual embeddings
    (the VLM), frames (whisper: the pipeline's bf16 frames, which run the
    encoder in bf16, cast to float32 unless ``bf16_frames``)."""
    data = JData(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b, seed=seed,
                 with_frames=cfg.frontend == "audio", frame_len=cfg.encoder_seq,
                 d_model=cfg.d_model)
    batch = jax.tree.map(np.asarray, data.next())
    if "frames" in batch and not bf16_frames:
        batch["frames"] = batch["frames"].astype(np.float32)
    if cfg.m_rope:
        pos = np.zeros((s, 3), np.int32)
        pos[:4, 1], pos[:4, 2] = np.divmod(np.arange(4), 2)
        pos[4:] = (2 + np.arange(s - 4))[:, None]
        batch["positions"] = np.broadcast_to(pos, (b, s, 3)).copy()
        rng = np.random.default_rng(seed)
        batch["visual_embeds"] = rng.standard_normal((b, 4, cfg.d_model)).astype(np.float32)
    return batch


def to_torch(batch: dict) -> dict:
    return lm_params_from_numpy(batch, device="cpu")


def jvalue_and_grad(jcfg):
    """The reference's ``jax.value_and_grad(lm_loss)``, jitted."""
    api = jbuild(jcfg)
    return jax.jit(jax.value_and_grad(lambda p, b: jlm_loss(api, p, b), has_aux=True))


def assert_grads_close(got, want, rel=GRAD_REL):
    """Each leaf of ``got`` (a torch tree) within ``rel`` of the largest
    magnitude of ``want``'s (a JAX tree) leaf at the same path."""
    want = {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = {k.replace("/", ""): v.float().numpy() for k, v in tree_leaves_with_path(got)}
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(got[k] - w).max())
        assert err <= rel * scale, (k, err, scale)


def check_loss_and_grads(arch: str) -> None:
    jcfg, tcfg = smoke_pair(arch)
    jparams, nparams = shared_params(jcfg)
    batch = batch_of(jcfg)
    assert ("frames" in batch) == (arch == "whisper-large-v3")
    assert ("visual_embeds" in batch) == (arch == "qwen2-vl-7b")
    (jtotal, jm), jgrads = jvalue_and_grad(jcfg)(jparams, jax.tree.map(jnp.asarray, batch))
    tapi = tbuild(tcfg)
    tparams = lm_params_from_numpy(nparams, device="cpu")
    total, m = lm_loss(tapi, tparams, to_torch(batch))
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux_loss"]), float(jm["aux_loss"]), rtol=1e-5, atol=1e-7)
    if jcfg.is_moe:
        assert float(m["aux_loss"]) > 0
    grads, gm = loss_and_grads(tapi, tparams, to_torch(batch))
    assert float(gm["loss"]) == float(m["loss"])
    assert_grads_close(grads, jgrads)



@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_lm_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


def test_the_files_cover_every_arch():
    from test_torch_lm_train_loss_more import OTHER_ARCHS

    assert sorted(TRANSFORMER_ARCHS + OTHER_ARCHS) == sorted(jconfigs.ARCH_IDS)
