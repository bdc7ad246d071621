"""The LM dry run's MoE decode cell (dbrx-132b at decode_32k, its experts
over ``model``: the checks of ``test_torch_lm_dryrun_decode.py``), and a
prefill_32k cell at one layer of the dense and the MoE families: rank 0's
2 of the 32 rows, its logits split by vocab."""
import dataclasses

import pytest

from test_torch_lm_dryrun_decode import check_decode_cell


def test_the_moe_decode_cell():
    check_decode_cell("dbrx-132b")


@pytest.mark.parametrize("arch", ["llama3.2-3b", "dbrx-132b"])
def test_a_prefill_cell(arch):
    """A prefill_32k cell's product FLOPs over the 256 ranks are the
    model's 2·N·D (within 5%: N counts params, not the products that read
    them), and at most that plus the attention that a
    "replicated" layer runs on every model rank (4 · S² · H · Dh a row and
    layer, times 16, with the chunked online softmax's masked tiles)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import run_cell

    res = run_cell(arch, "prefill_32k", layers=1)
    assert res["status"] == "ok", res.get("traceback")
    cfg, shape = dataclasses.replace(get_config(arch), num_layers=1), SHAPES["prefill_32k"]
    attn = 4 * shape.seq_len ** 2 * cfg.num_heads * cfg.head_dim * shape.global_batch
    if res["attention_route"] == "replicated":
        attn *= 16
    flops = res["op_stats"]["dot_flops_per_device"] * 256
    model = res["model_flops"]
    assert model == 2 * cfg.active_param_count() * shape.global_batch * shape.seq_len
    assert 0.95 * model <= flops <= 1.1 * (model + attn), (flops, model, attn)
    assert res["memory"]["per_device_total"] > res["memory"]["argument_bytes"] > 0
