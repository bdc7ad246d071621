"""The ``tp`` forward checks of ``test_torch_lm_tp_forward.py`` on the
other families, on the (1, 2) mesh (``..._families22.py``: (2, 2)): both
MoE postures (dbrx-132b's experts over ``model``, grok-1-314b's FFN split
over ``mlp``), the recurrent blocks' "replicated" route (mamba2-2.7b's SSD,
recurrentgemma-9b's RG-LRU beside its local attention over gathered K/V),
and the encoder-decoder (whisper-large-v3: its encoder, decoder and
cross-attention, "local heads", and a 3-head variant on "replicated")."""
import pytest

from test_torch_lm_tp_forward import (  # noqa: F401  (the fixtures)
    SHAPE,
    check_forward,
    check_loss,
    inputs,
    one_thread,
    ranks,
)

NAMES = ["dbrx-132b", "grok-1-314b", "mamba2-2.7b", "recurrentgemma-9b", "whisper-large-v3",
         "whisper-replicated"]


@pytest.mark.parametrize("name", NAMES)
def test_sharded_forward_matches_one_process(ranks, name):
    check_forward(ranks, name, "xla")


@pytest.mark.parametrize("name", NAMES)
def test_sharded_loss_matches_one_process(ranks, name):
    check_loss(ranks, name)
