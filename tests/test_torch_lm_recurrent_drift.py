"""mamba2-2.7b's bfloat16 drift from its float32 forward, in both packages.

One set of weights made by the reference's ``init`` at full width
(d_model 2,560, 80 SSD heads of 64, state 128, vocab 50,280) and carried
across through ``convert.lm_params_from_numpy`` runs through each
package's forward at bfloat16 and at float32 compute, B = 1, S = 64.  The
numbers: each package's bf16 logits against its own float32 logits (the
rms of the difference and the top-1 agreement), and the two packages'
bf16 logits against each other.

The tier-1 test runs 2 layers and holds the port's bf16-versus-float32 rms
within 10% of the reference's, and the two bf16 results at 3e-2 rms.  Not
element by element: at full width the logits reach |4|, where a bfloat16
ulp is 2^-5, and the two frameworks round at other places, so a few
logits in a thousand differ by 2-3 ulps (max 0.082 at 2 layers) while
each package stays as far from its float32 forward as the other.  The
same check at more layers runs by hand (16 layers peaked at 7.4 GB of host
memory):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_lm_recurrent_drift.py --layers 16
"""
import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models.lm.api import build as jbuild
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.lm.api import build as tbuild

ARCH = "mamba2-2.7b"
B, S = 1, 64
RMS_RATIO_TOL = 0.10  # the port's drift within 10% of the reference's
BF16_RMS_TOL = 3e-2


def drift(layers: int, seed: int = 0) -> dict:
    """bf16-versus-float32 logits of both packages at ``layers`` layers."""
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH), num_layers=layers)
    tcfg = dataclasses.replace(tconfigs.get_config(ARCH), num_layers=layers)
    vocab = jcfg.vocab_size
    params = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.key(seed)))
    tparams = lm_params_from_numpy(params, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    del params
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)
    out = {}
    for dtype in ("bfloat16", "float32"):
        jc = dataclasses.replace(jcfg, dtype=dtype)
        logits, _ = jax.jit(jbuild(jc).forward)(jparams, jnp.asarray(toks))
        out[f"jax/{dtype}"] = np.asarray(logits.astype(jnp.float32))[..., :vocab]
        with torch.no_grad():
            logits, _ = tbuild(dataclasses.replace(tcfg, dtype=dtype)).forward(
                tparams, torch.from_numpy(toks))
        out[f"port/{dtype}"] = logits.float().numpy()[..., :vocab]

    def rms(a, b):
        return float(np.sqrt(np.mean(np.square(a.astype(np.float64) - b))))

    def top1(a, b):
        return float(np.mean(a.argmax(-1) == b.argmax(-1)))

    res = {"layers": layers, "batch": B, "seq": S}
    for pkg in ("jax", "port"):
        res[pkg] = dict(rms=rms(out[f"{pkg}/bfloat16"], out[f"{pkg}/float32"]),
                        top1=top1(out[f"{pkg}/bfloat16"], out[f"{pkg}/float32"]),
                        float32_logit_rms=float(np.sqrt(np.mean(np.square(
                            out[f"{pkg}/float32"].astype(np.float64))))))
    res["bf16_port_vs_jax"] = dict(
        rms=rms(out["port/bfloat16"], out["jax/bfloat16"]),
        max_abs=float(np.abs(out["port/bfloat16"] - out["jax/bfloat16"]).max()),
        top1=top1(out["port/bfloat16"], out["jax/bfloat16"]))
    res["float32_port_vs_jax_max_abs"] = float(
        np.abs(out["port/float32"] - out["jax/float32"]).max())
    res["_logits"] = out
    return res


def test_port_bf16_drift_is_the_references():
    res = drift(layers=2)
    assert abs(res["port"]["rms"] - res["jax"]["rms"]) <= RMS_RATIO_TOL * res["jax"]["rms"], res
    assert res["bf16_port_vs_jax"]["rms"] <= BF16_RMS_TOL, res
    assert res["float32_port_vs_jax_max_abs"] <= 1e-4, res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[2])
    for n in ap.parse_args().layers:
        r = drift(n)
        r.pop("_logits")
        print(json.dumps(r), flush=True)
