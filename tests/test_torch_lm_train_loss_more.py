"""``lm_loss`` and its gradients against ``jax.value_and_grad`` for the
smoke configs of the recurrent, encoder-decoder and MoE families (the
helpers and tolerances of ``test_torch_lm_train_loss.py``), and whisper
with the pipeline's bf16 frames."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.lm.api import build as tbuild
from repro_torch.train.step import loss_and_grads
from test_torch_lm_train_loss import (  # noqa: F401  (one_thread: an autouse fixture)
    assert_grads_close,
    batch_of,
    check_loss_and_grads,
    jvalue_and_grad,
    one_thread,
    shared_params,
    smoke_pair,
    to_torch,
)

OTHER_ARCHS = ["mamba2-2.7b", "whisper-large-v3", "recurrentgemma-9b", "dbrx-132b",
               "grok-1-314b"]


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_lm_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


def test_whisper_loss_with_the_pipelines_bf16_frames_matches_jax():
    """SyntheticLMData's frames are bf16, so both packages run whisper's
    encoder in bf16: the loss and grads agree at bf16's tolerance."""
    jcfg, tcfg = smoke_pair("whisper-large-v3")
    jparams, nparams = shared_params(jcfg)
    batch = batch_of(jcfg, bf16_frames=True)
    assert batch["frames"].dtype.name == "bfloat16"
    (_, jm), jgrads = jvalue_and_grad(jcfg)(jparams, jax.tree.map(jnp.asarray, batch))
    grads, m = loss_and_grads(tbuild(tcfg), lm_params_from_numpy(nparams, device="cpu"),
                              to_torch(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=3e-2)
    assert_grads_close(grads, jgrads, rel=3e-2)
