"""The LM dry run's encoder-decoder cells (whisper-large-v3, 20 heads: route
"replicated" at 16 model ranks): its decode_32k cell with the checks of
``test_torch_lm_dryrun_decode.py`` (the prompt's cross K/V cut by the
reference's heuristic: rows over ``data``, whole over ``model``), and a
prefill_32k cell at one decoder layer beside the whole encoder."""
import dataclasses

from test_torch_lm_dryrun_decode import check_decode_cell


def test_the_encoder_decoder_decode_cell():
    check_decode_cell("whisper-large-v3")


def test_the_encoder_decoder_prefill_cell():
    """2 of the 32 rows a rank, the 1,500 frames through 32 encoder layers,
    the decoder's 32,768 positions through one: the products over the 256
    ranks between 0.95 and 4 times the model's 2·N·D (N counts the encoder
    once a decoder token, and its 32 layers run over 1,500 frames instead;
    route "replicated" runs every attention whole on each of the 16 model
    ranks)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import run_cell

    res = run_cell("whisper-large-v3", "prefill_32k", layers=1)
    assert res["status"] == "ok", res.get("traceback")
    assert res["attention_route"] == "replicated" and res["layers"] == 1
    cfg = dataclasses.replace(get_config("whisper-large-v3"), num_layers=1)
    shape = SHAPES["prefill_32k"]
    assert res["model_flops"] == 2 * cfg.active_param_count() * shape.global_batch * shape.seq_len
    ratio = res["op_stats"]["dot_flops_per_device"] * 256 / res["model_flops"]
    assert 0.95 <= ratio <= 4.0, ratio
    assert res["memory"]["per_device_total"] > res["memory"]["argument_bytes"] > 0
