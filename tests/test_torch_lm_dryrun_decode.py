"""One decode_32k cell a family of the LM dry run
(``repro_torch.launch.dryrun.run_cell``) on the 16 × 16 production mesh:
rank 0's program on fake tensors (shape-only CPU counts), the caches
sequence-sharded over ``model`` by the reference's heuristic.

A cell's product FLOPs over all 256 ranks are held to an analytic count of
the same step, within ``BAND``: the model's 2·N_active a token, plus
attention over the cache (4 · S · H · Dh a token and layer, S the cache's
slots, a local layer's ring of ``window``: the port's decode attends over
every slot), plus, for MoE, the reference's dense expert FFNs over all
E · capacity slots (zeros in the empty ones) instead of the k routed
copies; for the encoder-decoder the decoder's products alone (its cross
K/V are the prompt's, computed once), its cross-attention over the
encoder's frames run whole on each of the 16 model ranks where the heads
take route "replicated"; the recurrent families run their core whole on
every model rank, which the count leaves out.  The MoE family's cell is in
``test_torch_lm_dryrun_moe.py``, the recurrent families' in
``test_torch_lm_dryrun_recurrent.py``, the encoder-decoder's in
``test_torch_lm_dryrun_encdec.py``."""
import pytest

BAND = 0.1  # the analytic count leaves out the norms and the vocab padding's products
# test_torch_lm_dryrun_{moe,recurrent,encdec}.py: the other families
ARCHS = ["llama3.2-3b", "qwen2-vl-7b"]
OK_KEYS = {"arch", "shape", "mesh", "kind", "params_b", "active_params_b", "status",
           "parallelism", "run_s", "memory", "op_stats", "model_flops", "chips", "roofline"}


def analytic_decode_flops(cfg, shape) -> float:
    """A decode_32k step's product FLOPs over all ranks (module docstring)."""
    tokens = shape.global_batch
    hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    slots = {"attn": shape.seq_len, "local": min(shape.seq_len, cfg.window or shape.seq_len)}
    attn = sum(4 * slots.get(cfg.pattern_for_layer(i), 0) * hq
               for i in range(cfg.num_layers)) * tokens
    if cfg.is_encoder_decoder:  # the decoder alone, its cross-attention whole on 16 ranks
        d, layers = cfg.d_model, cfg.num_layers
        layer = d * (hq + 2 * hkv) + hq * d + 2 * d * hq + 2 * d * cfg.d_ff
        cross = 4 * cfg.encoder_seq * hq * layers * tokens * (1 if cfg.num_heads % 16 == 0
                                                               else 16)
        return 2.0 * (cfg.vocab_size * d + layers * layer) * tokens + attn + cross
    dense = 2.0 * cfg.active_param_count() * tokens
    if not cfg.is_moe:
        return dense + attn
    from repro_torch.models.lm.moe import _capacity

    routed = 2.0 * cfg.num_layers * cfg.experts_per_tok * 3 * cfg.d_model * cfg.d_ff * tokens
    slots = cfg.num_experts * _capacity(cfg, 1) / cfg.experts_per_tok
    return dense + attn + routed * (slots - 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_decode_cell_a_family(arch):
    check_decode_cell(arch)


def check_decode_cell(arch: str) -> None:
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import run_cell

    res = run_cell(arch, "decode_32k")
    cfg = get_config(arch)
    assert res["status"] == "ok", res.get("traceback")
    assert OK_KEYS <= set(res) and res["mesh"] == "pod16x16" and res["chips"] == 256
    assert set(res["memory"]) == {"argument_bytes", "peak_bytes", "per_device_total"}
    assert set(res["roofline"]) == {"card", "compute_s", "memory_s_floor", "collective_s",
                                    "model_flops_utilization"}
    stats = res["op_stats"]
    ratio = stats["dot_flops_per_device"] * 256 / analytic_decode_flops(cfg,
                                                                       SHAPES["decode_32k"])
    if cfg.family in ("ssm", "hybrid"):
        # the recurrent core (the SSD's state products, the RG-LRU's rw x rw
        # gates) runs whole on each of the 16 model ranks: the analytic count
        # holds it once
        assert 1 - BAND <= ratio <= 2.5, ratio
    else:
        assert abs(ratio - 1) <= BAND, ratio
        assert res["attention_route"] == ("local heads" if cfg.num_heads % 16 == 0
                                          else "replicated")
    # the row-parallel sums (and the attention's max and sums), the gathers
    assert stats["collective_count"]["all-reduce"] >= cfg.num_layers
    assert stats["collective_count"]["all-gather"] > 0
