#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # from the root of a checkout, on a host with one card

Phases, each fatal on failure:

1. Build every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all together) and print the build seconds and the ptxas
   reports; the tensor-core kernels (#6, #7, and the projection phase of
   #3 and #4) and #5's edge walk must not spill, nor the wgmma
   instructions be serialised for want of registers (ptxas warning C7512).
   Then AdamW's kernel pair (phase 9) at the benchmark's HAN and R-GAT
   trees: one step against the loop, every leaf within 1e-6 of its own
   largest magnitude, the loop's bits given the kernels' norm, twice
   bitwise equal, two launches a step; the pair's device ms beside its
   bytes bound, and the wall ms of a step through ``apply_updates`` and
   through the loop it replaces.  Its launches on the kernels line come
   from the HAN and R-GAT training runs of phases 4b and 5.  Alone:
   ``c.adamw_alone()``.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it (full-scale synthetic IMDB, HAN at
   heads=8, hidden=64) and on edge cases (an all-padding unit, fully
   masked rows, W = 1, a Din that is not a multiple of the K tile), at
   atol=rtol=1e-4 (the float32 sum order differs); the fused kernel's
   projection phase (its workspace h, on the rows it lists) at the
   serving operands under #6's ``SPLIT_ERROR_MAX``.  Time kernel, plain
   version and, for the fused kernel, the MULTIGRAPH composition on the
   same operands (cuBLAS ``x @ W`` + the θ einsums + #1) as the yardstick
   fusion has to beat, with CUDA events; no single PyTorch call computes
   fused FP+NA, so #3's and #4's ``library_ms`` are null.
3. Serve the request mix of the three target metapaths (repeats=2) on
   full-scale IMDB with HAN at its own width (heads=8, hidden=64,
   att_dim=128), block=16, max_edges=20000, 3 slots, similarity
   admission, once with the multigraph backend and once with fused-fp.
   Launch counters are zeroed just before each run and read just after
   it; each kernel must have launched in the run of its path.  Every result must be finite, both backends
   must agree, and the card must agree with the CPU on a small graph.
4. Training (HAN at heads=8, hidden=64, att_dim=128 on full-scale IMDB,
   block=16, max_edges=400000, full batch, AdamW lr=5e-3):
   a. the backward kernels #2 and #4 (and #1, #3 once more) against their
      plain versions at the training shapes and on the edge cases (all four
      also at B = 64 and 128, #3/#4 re-blocked to 32; #1/#2 at R-GAT's row
      width H·Dh = 256 and at phase
      4f's B = 128 with HAN's width), at atol=rtol=1e-4 (the fused kernels on
      exactly representable operands, see ``exact_fused``), and #3's
      projection phase on HAN's own inexact operands under
      ``SPLIT_ERROR_MAX``; each kernel runs twice and must be bitwise
      equal; #1 and #2's two passes must visit exactly the live edges
      (entries visited / live edges = 1.0, counted by #1 and read off the
      edge index #2's passes walk) and
      one backward must allocate no more than its gradients and O(E·H)
      edge scratch (its peak memory printed); timed with CUDA events beside
      its bound (#3's and #4's, as #6's: the x·W product at the TF32
      tensor-core peak, the rest on the CUDA cores; beside it the bound
      with split TF32's three products and with all on the CUDA cores),
      #3 and #4 also beside the MULTIGRAPH composition (#2 for the VJP)
      and the flops they do: phase P's whole 128-row tiles, which must
      come to at most 1.5× the rows the function needs.  Alone:
      ``python3 -c 'import chip_smoke as c; c.fused_alone()'``;
   b. the main path: ``launch.hgnn_train.run_training`` with the kernel
      backend for 20 steps, counters zeroed just before: #1 and #2 launch
      once a step, #3 and #4 never, and the loss falls;
   c. FUSED_FP training, 3 steps from the same initial state through
      ``make_hgnn_train_step(han_forward(FUSED_FP))``: #3 and #4 launch
      once a step, their projection on the tensor cores (counted by
      route), and the first step's loss and gradients agree with
      MULTIGRAPH's at rtol=1e-3, atol=1e-5;
   d. 3 MULTIGRAPH steps twice from the same state give bitwise-equal
      states; steady steps of both backends under ``torch.profiler`` give
      the device idle share;
   e. the card against the CPU on small acm (block=8), per-step losses at
      1e-4, and the training launcher as a user runs it, with a checkpoint
      directory, resumed once;
   f. the launcher's kernel path at block=128 (the JAX launcher's default,
      which #1 and #2 take) for 5 steps: the loss falls, and every call of
      #1 and #2 in the first step matches its plain version on the same
      operands at atol=rtol=1e-4;
   g. multi-lane HAN (paper §4.2) on the same problem at block=128: lane
      plans of 1, 4 and 16 lanes (balanced) and 16 (naive), each one's
      logits and loss bitwise MULTIGRAPH's, its gradients within
      ``LANE_GRAD_REL`` of each gradient's largest magnitude of
      MULTIGRAPH's and bitwise equal on a second run, one #1 and one #2
      launch a step; the plans' imbalance and bytes; #1 and #2's passes
      visiting exactly the 16-lane plan's edges; 5 steps of
      ``run_training(plan_lanes=16, block=128)``, counters zeroed just
      before (#1/#2 once a step, the loss falls); the 16-lane step and
      MULTIGRAPH's timed in turns with CUDA events, then under the
      profiler (idle share); ``fused_fp`` over a 4-lane plan at block=16
      against ``kernel``: logits at 1e-4, one step's gradients at
      rtol=1e-3, atol=1e-5, #3 and #4 once a step.  Alone:
      ``python3 -c 'import chip_smoke as c; c.multilane_alone()'``.
      The lane-sharded path (``multilane_na_sharded``, ``--lanes`` > 1)
      needs several cards and runs apart: ``lanes_sharded()`` under
      ``torchrun`` (its docstring says how);
   h. FUSED_FP at B = 128 on the same problem (kernels #3 and #4 re-blocked
      to B' = 32 on the host): #3 and #4 on the problem's exact operands
      against their plain versions at atol=rtol=1e-4, twice bitwise
      equal, and against #1 and #2 on the MULTIGRAPH path's projection (#3
      at 1e-4; #4's gradients within 1e-4 of each one's largest magnitude
      of #2's chained through x @ W + θ by autograd); both timed with CUDA
      events beside their plain versions, the MULTIGRAPH composition and
      their bounds; 3 FUSED_FP training steps at B = 128, counters zeroed
      just before (#3 and #4 once a step, the loss falls; the first #3
      launch held against its plain version); the first step's logits at
      1e-4 and gradients (as 4g's fused_fp) against MULTIGRAPH's; then 3
      steps on a (1, 1) mesh through the ``dist`` rules (a one-rank NCCL
      group, ``param_shardings``, ``han_forward_multilane(mesh=,
      placements=)``, the placements-aware AdamW), counters zeroed just
      before (#1 and #2 once a step), bitwise today's MULTIGRAPH steps.
      The model axis over several cards (HAN, then R-GAT) runs apart:
      ``model_sharded()`` under ``torchrun`` (its docstring says how).
5. The per-graph models on full IMDB's six relation graphs (AM, MA, KM,
   MK, DM, MD), block=16, at the JAX package's ``init_*`` widths (R-GAT
   hidden 64, heads 4, layers 3; S-HGN hidden 64, heads 4, layers 2,
   edge_dim 64; R-GCN hidden 64, layers 3):
   a. kernel #5 against its plain version on every relation graph at
      R-GAT's layer-0 operands (H·Dh = 256) with a nonzero edge bias, and
      on the edge cases (an all-padding row, fully masked rows, W = 1, B =
      8, 32, 64 and 128, Dh = 15, Ns_pad < Nd_pad and Ns_pad > Nd_pad), at
      atol=rtol=1e-4; twice bitwise equal; equal to #1 at G = 1 bit for
      bit; visiting exactly the live edges (its own count); the six
      launches of one layer, and each graph's, timed with CUDA events
      beside their bound.  Alone:
      ``python3 -c 'import chip_smoke as c; c.kernel5_alone()'``;
   b. inference, under no_grad: R-GAT and S-HGN on KERNEL (per relation
      and layer #6 twice, the src and dst side's FP+θ, and #5 once: 30 and
      15 launches for R-GAT, whose last layer runs only the three
      relations into movie, 24 and 12 for S-HGN, every #6 launch on the
      wgmma route; counters zeroed just before each model's first forward
      and read just after) and R-GCN
      (mean NA, no kernel); logits against BLOCK on the card (R-GAT,
      S-HGN) or the CPU (R-GCN) at 1e-4; cold and steady forward times,
      peak memory;
   c. (run before b) kernel #6 against its plain version at each distinct
      layer-0 projection of R-GAT (actor 6,124 × 3,341, movie 4,932 ×
      3,489, director 2,393 × 3,341, keyword 7,971 × 64, each → 4 × 64,
      with a nonzero bias), layer 1's 4,932 × 256 → 256 and a ragged
      1,001 × 37 → 4 × 16 in float32 at atol=rtol=1e-4, and the actor
      case in bfloat16 (h within one bf16 rounding, θ at 1e-4); each case
      on the route the wrapper picks (float32 on wgmma, split TF32; bf16
      on cuda_cores), every float32 case also forced on cuda_cores; twice
      bitwise equal; the float32 cases' split error max |h - h64| /
      (|x|·|w| + |b|) at most ``SPLIT_ERROR_MAX`` (the plain float32
      product's printed beside); each float32 case timed with CUDA events
      on both routes beside its bounds (the product at the TF32 tensor-core
      peak or the bytes; the split's three products; the CUDA cores), the
      plain version and ``torch.addmm`` + the two einsums; the split error
      also where split-K leaves K whole (17,000 × 2,048 and × 3,341 → 4 ×
      64).  Alone:
      ``python3 -c 'import chip_smoke as c; c.kernel6_alone()'``;
   d. R-GAT training through ``run_training(model_name="R-GAT")``: the
      launcher's layers=2 on the metapath graphs at heads 4, hidden 64,
      20 steps, #1 and #2 six times a step, #6 never, and the loss falls;
      then one more step whose six calls of #1 and of #2 each match their
      plain version on the same operands at atol=rtol=1e-4;
   e. (run after b's counts were read) R-GAT and S-HGN on KERNEL at
      block=128 (the reference trainer's default): every #5 call of each
      model's first forward matches ``seg_gat_agg_plain`` on the same
      operands and the logits match BLOCK, at atol=rtol=1e-4; steady
      forward times; #5's six launches of R-GAT's layer 0 timed, visiting
      exactly the live edges.
6. The LM slice: llama3.2-3b at full width (28 layers, d_model 3072, 24/8
   heads of 128, d_ff 8192, vocab 128,256, float32 weights from a seeded
   ``torch.Generator``, bfloat16 compute):
   a. kernel #7 against its plain version at the layer's shape (B = 2,
      S = 4096) in bfloat16 (atol=rtol=3e-2, and within one rounding of
      the float32 result, atol=1e-4, rtol=8e-3) and float32 (1e-4), and
      on Sq < Sk, Sq > Sk (rows that see no key must be exact zeros), a
      2048 window with MQA at Dh = 256, ``causal=False``, dbrx's and
      grok's layer (48/8 heads of 128, a GQA group of 6), qwen2-vl-7b's
      (28/4 of 128, a group of 7) and whisper-large-v3's (MHA 20/20 of 64:
      the encoder on 1,024 frames at ``causal=False``, the decoder at 448
      positions, 3.5 tiles of 128); each case on
      the route the wrapper picks (bf16 at Dh 64 or 128 on ``wgmma``, the
      rest on ``cuda_cores``), its launches counted by route; twice
      bitwise equal; on the wgmma route at least ``BITWISE_SHARE_MIN`` of
      the bf16 outputs equal the rounded float32 result bitwise, a limit
      that the route's numerics in plain PyTorch pass with p split and
      fail with p rounded once (both read at the layer's shape); the wgmma
      route timed with CUDA events beside its bound (4·Dh flops a visible
      pair at the bf16 tensor-core peak; the split's 6·Dh printed beside
      it), the CUDA-core route on float32 operands, the plain version and
      ``scaled_dot_product_attention``; at recurrentgemma-9b's local layer
      (B = 2, 16/1 heads of 256, window 2048, bf16: cuda_cores) timed
      beside its bound, the plain version and SDPA with the window mask;
      at qwen2-vl-7b's and whisper-large-v3's shapes beside their bounds,
      the plain version and SDPA;
   b. the main path: ``LMApi.forward(impl="flash")`` at B = 2, S = 4096,
      counters zeroed just before: #7 launches 28 times, all on the wgmma
      route, nothing else;
      cold and steady times, peak memory, idle share; against impl="xla"
      in bf16 (top-1 agreement and max |d| printed) and both against the
      float32-compute forward (flash's root-mean-square distance to it at
      most xla's); at float32 compute and S = 2048 (#7 28 times on the
      cuda_cores route), flash against xla at atol=rtol=1e-3;
   c. serving: 4 prompts of 8 tokens, 16 new tokens each, through
      ``make_prefill`` + ``make_serve_step`` with bfloat16 caches;
      ``greedy_generate`` refuses the bfloat16 config (as the reference
      fails) and serves the float32-compute variant twice with the same
      tokens; a decode step twice from one state is bitwise equal; the
      prefill's last logits equal ``forward(impl="flash")``'s at 1e-3; the
      launcher's ``--smoke`` run on the card;
   d. dbrx-132b at full width (d_model 6144, 48/8 heads of 128, 16 experts
      of d_ff 10,752, top-4, vocab 100,352 untied, bf16 weights from a
      seeded ``torch.Generator`` and bf16 compute), 8 of its 40 layers (the
      weights must fit the card): ``LMApi.forward(impl="flash")`` at B = 2,
      S = 4096 (capacity 1,280 slots an expert a row), counters zeroed just
      before: #7 launches 8 times, all on the wgmma route, nothing else;
      cold and steady times, tokens/s, peak memory, idle share and top
      kernels under the profiler, the aux loss and the dropped share of
      copies; twice bitwise equal (logits, aux, dispatch tables); flash
      against xla on row 0 (each row routes alone): the routes that flip
      per layer, layer 0's all near-ties (``moe.route_flips``), top-1
      agreement and max |d| on the tokens routed alike in every layer; the
      bf16 serving path (4 prompts of 8 tokens, 16 new each) with its
      decode step beside the bound of reading every weight once; the smoke
      config (float32, capacity factor 0.5) on the card against the CPU:
      routes equal or near-ties, logits at 1e-4 on the tokens routed
      alike, aux at 1e-5;
   e. grok-1-314b the same way (8 experts of 32,768, top-2, tied
      embeddings, soft cap 30, which the flash path ignores: its xla
      comparison runs the cap-free config), 4 of its 64 layers;
   f. the continuous batcher (``serve.ContinuousBatcher``) on llama3.2-3b
      at full width, float32 compute: 4 slots, 7 requests (prompt lengths
      3-12, max_new 4-16: slots reused mid-stream), cache_len 32; tokens/s
      and steps; each request's tokens equal to its own ``greedy_generate``
      run's or first different where that run's top two logits lie within
      1e-4 (the position printed); the bf16-compute config refused; the
      launcher's ``--arch dbrx-132b --smoke`` run on the card.
      Alone: ``python3 -c 'import chip_smoke as c; c.moe_alone()'`` (d, e)
      and ``c.batcher_alone()`` (f);
   g. mamba2-2.7b at full width and depth (64 SSD layers, d_model 2560,
      80 heads of 64, state 128, tied vocab 50,432, float32 weights from a
      seeded ``torch.Generator``, bf16 compute): ``LMApi.forward(
      impl="flash")`` at B = 2, S = 4096, counters zeroed just before: no
      kernel launches; logits (2, 4096, 50432), finite, twice bitwise
      equal; cold and steady times, tokens/s, peak memory, idle share and
      top kernels; one layer's ``_ssd_chunked`` timed alone (its share of
      the forward); flash and xla bitwise equal (no attention), both
      against the float32-compute forward (printed);
      decode == forward over 64 tokens at float32 compute, atol=rtol=1e-3;
      the bf16 server (4 prompts of 8, 16 new each) with its decode step
      beside the weight-read bound; ``greedy_generate`` at bf16 compute
      (float32 caches) runs, as the reference's; the caches' bytes equal at
      4,096 and 524,288 positions; the smoke config on the card against the
      CPU at 1e-4; the launcher's ``--smoke`` run;
   h. recurrentgemma-9b the same way (38 layers: 12 × (rglru, rglru,
      local) + 2 rglru, d_model 4096, MQA 16/1 heads of 256, window 2048,
      GeGLU d_ff 12,288, tied vocab 256,000): #7 launches 12 times, all on
      the cuda_cores route, its first call held against
      ``flash_attention_plain`` as in a and, by b's rule, at most as far
      (root mean square) from that layer's float32 attention as xla's bf16
      einsums; flash and xla against the float32 forward on row 0
      (printed: both distances are the common bf16 roundings of the other
      layers);
      ``_gates`` and the doubling scan timed alone; ``greedy_generate`` at
      bf16 refused, as the reference fails; the local caches a ring of
      2,048 slots at both lengths.  Alone: ``c.mamba2_alone()``,
      ``c.recurrentgemma_alone()`` (with #7 at its layer shape);
   i. qwen2-vl-7b at full width and depth (28 layers, d_model 3584, 28/4
      heads of 128 with QKV bias, M-RoPE sections (16, 24, 24), d_ff
      18,944, vocab 152,064 untied, its bf16 weights from a seeded
      ``torch.Generator``, bf16 compute): ``LMApi.forward(impl="flash")``
      at B = 2, S = 4096, the first 1,024 slots seeded visual embeddings
      at the M-RoPE positions of a 32 x 32 grid (t = 0, h = row, w = col)
      and the text after them from 32 with t == h == w, counters zeroed
      just before: #7 launches 28 times, all on the wgmma route, nothing
      else, its first call held against its plain version and by b's rule
      on that layer; twice bitwise equal; cold and steady times, peak
      memory, the profiler; flash and xla against the float32-compute
      forward on row 0 (flash at most ``LOGITS_RULE_SLACK`` times xla's
      rms); the bf16 server (4 prompts of 8, 16 new each; no #7 in decode);
      ``greedy_generate`` at bf16 refused; the smoke config (float32) on
      the card against the CPU at 1e-4 and decode == forward at 1e-3;
   j. whisper-large-v3 at full width and depth (32 + 32 layers, d_model
      1280, 20/20 heads of 64, float32 weights, bf16 compute), B = 2,
      seeded frames, decoder S = 448: the main path is the flash forward at
      1,024 frames, counters zeroed just before: #7 launches 64 times (32
      encoder layers at causal=False, 32 decoder layers causal), all on
      wgmma, each launch held against its plain version as it returns, b's
      rule on the first; twice bitwise equal; against xla at 1,024 frames
      and both against the float32-compute forward as in i; the real 1,500
      frames on xla (times, peak memory, the profiler); the flash path at
      1,500 frames raising the reference's block precondition; the bf16
      server with 1,500 frames encoded once in prefill (the cross K/V
      carried); the smoke config as in i.  Alone: ``c.qwen2vl_alone()``,
      ``c.whisper_alone()`` (each with #7 at its layer shapes);
   k. LM training (no kernel on its path: #7 has no gradient in either
      package, training runs impl "xla"):
      a. the main path: llama3.2-3b at full width and depth (float32
         params, bf16 compute, remat full) through ``make_train_step``,
         seeded init on the card, AdamW (lr 3e-4 constant, b2 0.95, wd
         0.1, clip 1.0), global batch 4 × S = 2048 in 2 microbatches, 10
         steps, counters zeroed just before and read just after: no
         launch; the loss falls (the first batch's, re-evaluated after the
         last step, and the last three steps' mean below the first step's:
         with no warmup the fresh batches' loss first rises for about
         five steps); a second run from the seed bitwise equal
         (losses, grad norms, every param leaf's checksum); cold and
         steady step ms, tokens/s, peak memory (below 76 GiB), MFU (6 N T
         + attention over the bf16 peak; remat's recompute apart), idle
         share and top device ops of 2 more steps under the profiler; the
         flash forward at B = 2, S = 4096 with jax.nn's activations
         against ``F.silu``, in turns;
      b. dbrx-132b at full width, 1 of 40 layers, bf16 params with a
         float32 master, factored AdamW, B = 2, S = 2048, 3 steps: the
         first batch's loss falls (a fresh batch's does not in 3 steps: the
         untied head learns only the rows a batch holds), the aux loss
         finite, twice bitwise equal; step ms and
         peak memory;
      c. llama's width at 2 layers, float32 compute, microbatches 2
         against 1: loss at 1e-5, grads at tests/test_train.py's
         tolerance and within 1e-4 of each leaf's scale (bf16 printed);
      d. each of the ten smoke configs, 3 steps on the card against the
         CPU: losses and grad norms at rtol 1e-4;
      e. ``launch.train``'s smoke run crashed at step 3 and resumed
         bitwise; ``examples_torch/train_lm.py`` at its defaults.
      Alone: ``c.lm_train_alone()``.  The same training over a data mesh
      of four cards runs apart: ``lm_data_parallel()`` under ``torchrun``
      (its docstring says how).
7. Observability and the HGNN leftovers (run after 4g, on the phase-4
   problem; its launch counts are read apart from the main path's):
   a. ``obs.characterize.characterize_hgnn`` on HAN at its own width under
      ``enable_tracing(sync=True)``, on BLOCK, KERNEL (#5 once a graph)
      and MULTIGRAPH (#1 at G = 1), six passes each: the median of the
      last five passes' ``stage_us`` (FP, θ, NA, FA) and
      ``na_us_per_graph`` printed, every #5 and #1 call held against its
      plain version at atol=rtol=1e-4, one ``char/na/<g>`` span on lane
      ``sg/<g>`` a semantic graph;
   b. ``launch.hgnn_train.run_training`` at the training example's width
      (ACM scale 0.5, full features, 8 heads of 128: #1/#2's widest row,
      B = 128) for 20 steps on the kernel backend with ``trace=`` and
      ``metrics_out=``: the trace holds the ``char/*`` and ``train/step``
      spans, the metrics ``char.stage_us`` for the four stages and
      ``train.step_ms``, #1 and #2 launch once a step (the first call of
      each held against its plain version), and the loss falls;
   c. ``launch.hgnn_serve.main`` on ``--na-backend`` multigraph, segment,
      fused-fp and fused_fp at phase 3's problem and width (full IMDB,
      8 × 64, B = 16): every #1 and #3 call held against its plain version
      at atol=rtol=1e-4 as it returns, fused_fp's outputs equal fused-fp's
      bit for bit, multigraph's and fused_fp's agree with segment's at
      1e-4; then ``examples_torch/serve_hgnn.py`` (every #1 call held
      against plain) and ``quickstart.py`` at their defaults.  Alone:
      ``python3 -c 'import chip_smoke as c; c.observability_alone()'``.
8. Print the ``kernels`` JSON line (#1-#7 and AdamW's pair, #7's also at the MoE,
   recurrentgemma, qwen2-vl and whisper layer shapes; each row's ``ms_per`` says
   what its times cover and ``launches_by_path`` which runs its launches
   come from; bounds count NA work per edge, not per dense B×B block; #1's
   and #2's rows give the entries they visit an edge, #2's its peak
   memory; #5's the entries it visits an edge, its per-graph times and its
   B = 128 layer time), the
   card's name and power limit, and last ``{"ok": true, "device": {...}}``.

``edge_walk_times()`` times #1 and #5 alone with their ptxas registers, for
an A/B of two trees run in turns in one call (its docstring says how).

TF32 is off throughout (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are False): every float32 number is
float32.  Kernel #6's wgmma route reaches float32 by three TF32 products
(split TF32), held to ``SPLIT_ERROR_MAX``.
Full results go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import io
import json
import math
import re
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "chiprun_out"

ATOL = RTOL = 1e-4
PEAK_FP32_FLOPS = 67e12   # H100 SXM, float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
METAPATHS = [("movie", "director", "movie"), ("movie", "actor", "movie"),
             ("movie", "keyword", "movie")]
WIDTH = dict(heads=8, hidden=64, att_dim=128)  # HAN's own width (init_han defaults)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, got, want) -> float:
    """Max abs error of ``got`` against ``want``; fails beyond the tolerance."""
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)} or non-finite")
        err = max(err, float((g - w).abs().max()))
        torch.testing.assert_close(g, w, atol=ATOL, rtol=RTOL, msg=lambda m: f"{name}: {m}")
    log(f"[check] {name}: max_abs_err={err:.3e} (atol={ATOL}, rtol={RTOL})")
    return err


def check_ptxas(reports: dict[str, str]) -> None:
    """Write each ptxas report to chiprun_out/ptxas_<name>.txt and print its
    register and spill lines; the tensor-core kernels (#6's and #7's wgmma
    kernels) and #5's edge walk must not spill, and ptxas must not serialise
    the wgmma instructions for want of registers (warning C7512)."""
    for name, text in reports.items():
        (OUT / f"ptxas_{name}.txt").write_text(text)
        function = None
        for line in text.splitlines():
            if "Function properties for" in line:
                function = line.split("Function properties for")[-1].strip()
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {name}: {line.strip()}")
            if ("spill" in line and ("wgmma" in (function or "") or name == "seg_gat_agg")
                    and "0 bytes spill stores, 0 bytes spill loads" not in line):
                raise AssertionError(f"{name}: {function} spills registers: {line.strip()}")
            if "C7512" in line:  # wgmma serialised for want of registers
                raise AssertionError(f"{name}: {line.strip()}")


# -- phase 2: kernels against their plain versions ----------------------------


def slice_operands(eng, fusion):
    """The operands one step of the serving path hands each kernel: the three
    target metapaths batched, the engine's own weights."""
    batches = [eng._batch(mp) for mp in METAPATHS]
    col, gid, row, masks = fusion.build_unit_tables(batches)
    B, H, Dh = eng.block, eng.heads, eng.hidden
    n_pad = batches[0].num_dst_pad
    x = eng.features["movie"]
    x = torch.nn.functional.pad(x, (0, 0, 0, n_pad - x.shape[0]))
    w, b = eng.params["w_fp"]["movie"], eng.params["b_fp"]["movie"]
    a_src = torch.stack([eng._metapath_params(mp)[0] for mp in METAPATHS])
    a_dst = torch.stack([eng._metapath_params(mp)[1] for mp in METAPATHS])
    h = (x @ w + b).reshape(n_pad, H, Dh)
    bias = torch.zeros((len(METAPATHS), H), device=x.device)
    multi = dict(col_index=col, graph_id=gid, dst_row=row, masks=masks,
                 theta_src=torch.einsum("nhd,ghd->gnh", h, a_src).contiguous(),
                 theta_dst=torch.einsum("nhd,ghd->gnh", h, a_dst).contiguous(),
                 h_src=h.contiguous(), edge_bias=bias)
    fused = dict(col_index=col, graph_id=gid, dst_row=row,
                 wsel=torch.zeros(len(METAPATHS), dtype=torch.int32, device=x.device),
                 masks=masks, x=x, w=w[None].contiguous(), b=b[None].contiguous(),
                 a_src=a_src, a_dst=a_dst, edge_bias=bias)
    return multi, fused


def edge_operands(seed, dev, *, B=16, U=24, W=6, G=3, H=8, Dh=64, nblk=8, din=100, tables=2):
    """Random operands with the degenerate cases the serving path can meet."""
    rng = np.random.default_rng(seed)
    col = np.full((U, W), -1, np.int32)
    for u in range(U):
        k = rng.integers(0, W + 1)
        col[u, :k] = rng.choice(nblk, size=k, replace=False)
    col[0] = -1                      # an all-padding unit
    masks = rng.random((U, W, B, B)) < 0.3
    masks[1, :, 3, :] = False        # a fully masked dst row
    n = nblk * B
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    gid = rng.integers(0, G, U).astype(np.int32)
    row = rng.integers(0, nblk, U).astype(np.int32)
    bias = rng.standard_normal((G, H)).astype(np.float32)
    multi = dict(col_index=t(col), graph_id=t(gid), dst_row=t(row), masks=t(masks),
                 theta_src=t(rng.standard_normal((G, n, H)).astype(np.float32)),
                 theta_dst=t(rng.standard_normal((G, n, H)).astype(np.float32)),
                 h_src=t(rng.standard_normal((n, H, Dh)).astype(np.float32)),
                 edge_bias=t(bias))
    fused = dict(col_index=t(col), graph_id=t(gid), dst_row=t(row),
                 wsel=t(rng.integers(0, tables, G).astype(np.int32)), masks=t(masks),
                 x=t(rng.standard_normal((n, din)).astype(np.float32)),
                 w=t((rng.standard_normal((tables, din, H * Dh)) / np.sqrt(din)).astype(np.float32)),
                 b=t((rng.standard_normal((tables, H * Dh)) * 0.1).astype(np.float32)),
                 a_src=t(rng.standard_normal((G, H, Dh)).astype(np.float32)),
                 a_dst=t(rng.standard_normal((G, H, Dh)).astype(np.float32)),
                 edge_bias=t(bias))
    return multi, fused


def live_edges(col, masks) -> int:
    """The edges these block-CSR operands hold: set mask entries of live
    slots.  The work of NA is counted per edge, not per dense B×B block."""
    return int(masks[col >= 0].sum())


def multigraph_cost(ops):
    """(bytes, flops) the multigraph forward needs on these inputs: each input
    read once (masks of live slots only), each output written once; per edge
    and head 2·Dh for p @ h and ~8 ops for its logit."""
    col, masks, h = ops["col_index"], ops["masks"], ops["h_src"]
    U, W = col.shape
    B, (ns, H, Dh) = masks.shape[-1], h.shape
    live = int((col >= 0).sum())
    nbytes = (col.numel() * 4 + 2 * U * 4 + live * B * B
              + 4 * (ops["theta_src"].numel() + ops["theta_dst"].numel() + h.numel()
                     + ops["edge_bias"].numel())
              + 4 * U * B * H * (Dh + 1))
    flops = live_edges(col, masks) * H * (2 * Dh + 8)
    return nbytes, flops, live


def fused_projection(ops) -> dict:
    """The projection of #3/#4 on these operands: ``blocks``, the (weight
    table, block) pairs some live unit reads (the function projects each
    once); ``tiles``, phase P's 128-row tiles (the kernels project each
    whole); ``needed`` and ``done`` their flops, 2·rows·Din·H·Dh."""
    ff_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg_fused_fp")
    col, gid, row, masks, x = (ops[k] for k in ("col_index", "graph_id", "dst_row", "masks", "x"))
    U, W = col.shape
    B = masks.shape[-1]
    H, Dh = ops["a_src"].shape[1:]
    din = x.shape[1]
    nblk = x.shape[0] // B
    live_mask = col >= 0
    unit_live = live_mask.any(dim=1)
    table = ops["wsel"].long()
    g_of = gid.long()[:, None].expand(U, W)[live_mask]
    blocks = torch.unique(torch.cat([table[g_of] * nblk + col.long()[live_mask],
                                     table[gid.long()[unit_live]] * nblk
                                     + row.long()[unit_live]])).numel()
    tiles = int(ff_mod.row_tiles(col, gid, row, ops["wsel"], x.shape[0], B).numel())
    per_row = 2 * din * H * Dh
    return dict(blocks=blocks, tiles=tiles, needed=blocks * B * per_row,
                done=tiles * ff_mod.ROW_TILE * per_row,
                ratio=tiles * ff_mod.ROW_TILE / max(1, blocks * B))


def fused_cost(ops):
    """(bytes, flops, kernel_flops, projection) of the fused forward on these
    inputs.

    ``flops`` is the work the function needs: each (weight table, src or dst
    block) that some live unit reads projected once (2·B·Din·H·Dh), θs and
    θd of each (graph, block) read once (2·B·H·Dh each), then the multigraph
    work per edge.  ``kernel_flops`` is the work the kernels do: phase P's
    whole 128-row tiles, θd once per live unit and θs once per live slot,
    and NA on whole B×B blocks; it explains the kernels' time and is not
    their bound.  ``projection``: :func:`fused_projection`."""
    col, gid, row, masks, x = (ops[k] for k in ("col_index", "graph_id", "dst_row", "masks", "x"))
    U, W = col.shape
    B = masks.shape[-1]
    G, H, Dh = ops["a_src"].shape
    live_mask = col >= 0
    live = int(live_mask.sum())
    live_units = int(live_mask.any(dim=1).sum())
    nblk = x.shape[0] // B
    g_of = gid.long()[:, None].expand(U, W)[live_mask]
    src_blk = col.long()[live_mask]
    proj = fused_projection(ops)
    theta_src = torch.unique(g_of * nblk + src_blk).numel()
    theta_dst = torch.unique(gid.long() * nblk + row.long()).numel()
    na = live_edges(col, masks) * H * (2 * Dh + 8)
    na_blocks = live * B * B * H * (2 * Dh + 8)
    nbytes = (col.numel() * 4 + 2 * U * 4 + G * 4 + live * B * B
              + 4 * (x.numel() + ops["w"].numel() + ops["b"].numel() + 2 * G * H * Dh + G * H)
              + 4 * U * B * H * (Dh + 1))
    flops = proj["needed"] + (theta_src + theta_dst) * 2 * B * H * Dh + na
    kernel_flops = proj["done"] + (live + live_units) * 2 * B * H * Dh + na_blocks
    return nbytes, flops, kernel_flops, proj


PEAK_TF32_FLOPS = 494.7e12  # H100 SXM, dense TF32 tensor cores


def bound_ms(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fused_bounds(nbytes: int, flops: int, projection: int) -> dict:
    """The bounds of #3 or #4 on ``flops`` of work, ``projection`` of them
    the x·W product, as #6's row has them: ``bound_ms``, the product at
    the TF32 tensor-core peak (one product, the function's work) and the
    rest on the float32 CUDA cores, or the bytes; ``bound_split_ms``, the
    product as split TF32's three products (work of the design, not of the
    function); ``bound_cuda_cores_ms``, all of it on the CUDA cores."""
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    rest = (flops - projection) / PEAK_FP32_FLOPS * 1e3
    t_ops = projection / PEAK_TF32_FLOPS * 1e3 + rest
    t_split = 3 * projection / PEAK_TF32_FLOPS * 1e3 + rest
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_split_ms=max(t_bytes, t_split),
                bound_cuda_cores_ms=bound_ms(nbytes, flops)[0])


def phase_p_split_error(ff_mod, ops: dict, index: dict, name: str) -> float:
    """Phase P's split error on these (inexact) operands: #3 launched once,
    its workspace h read on the listed rows (``projection_split_error``)
    and held to #6's ``SPLIT_ERROR_MAX``; the plain float32 product's error
    printed beside."""
    k6_mod = importlib.import_module("repro_torch.kernels.fused_fp_coeff")
    (U, _), B, (H, Dh) = ops["col_index"].shape, ops["masks"].shape[-1], ops["a_src"].shape[1:]
    x, w, b = ops["x"], ops["w"], ops["b"]
    out = torch.empty((U * B, H, Dh), device=x.device)
    lse = torch.empty((U * B, H), device=x.device)
    h = ff_mod.launch(**ops, out=out, lse=lse, leaky_slope=0.2, index=index)
    err = ff_mod.projection_split_error(h, index["tiles"], x, w, b)
    plain = ff_mod.projection_split_error(torch.einsum("nd,tdc->tnc", x, w) + b[:, None], index["tiles"],
                                          x, w, b)
    log(f"[check] fused_fp {name}: phase P [{ff_mod.route(H, Dh)}] split error {err:.3e} (plain "
        f"float32 product {plain:.3e}; limit {k6_mod.SPLIT_ERROR_MAX})")
    if not err <= k6_mod.SPLIT_ERROR_MAX:
        raise AssertionError(f"fused_fp {name}: phase P's split error {err} above SPLIT_ERROR_MAX")
    return err


def kernel_phase(eng, fusion, mg_mod, ff_mod) -> dict:
    dev = eng.device
    slice_mg, slice_ff = slice_operands(eng, fusion)
    U, W = slice_mg["col_index"].shape
    log(f"[slice] U={U} W={W} B={eng.block} H={eng.heads} Dh={eng.hidden} "
        f"Din={slice_ff['x'].shape[1]} N_pad={slice_ff['x'].shape[0]}")
    err_mg, err_ff = 0.0, 0.0
    cases = [("slice", slice_mg, slice_ff)]
    cases.append(("edge B=16 W=6 Din=100", *edge_operands(1, dev)))
    cases.append(("edge W=1", *edge_operands(2, dev, W=1)))
    cases.append(("edge B=8 H=2 Dh=8 Din=37", *edge_operands(3, dev, B=8, H=2, Dh=8, din=37)))
    for name, mg, ff in cases:
        got = mg_mod.seg_gat_agg_multigraph_fwd(**mg)
        want = mg_mod.seg_gat_agg_multigraph_plain(**mg)
        torch.cuda.synchronize()
        err_mg = max(err_mg, compare(f"multigraph {name}", got, want))
        got = ff_mod.seg_gat_agg_fused_fp_fwd(**ff)
        want = ff_mod.seg_gat_agg_fused_fp_plain(**ff)
        torch.cuda.synchronize()
        err_ff = max(err_ff, compare(f"fused_fp {name}", got, want))
        if name.startswith("edge"):
            B = mg["masks"].shape[-1]
            if not (got[0][:B] == 0).all() or not (got[0][B + 3] == 0).all():
                raise AssertionError(f"fused_fp {name}: padding unit / masked row not zero")

    # timing at the slice's shapes, straight on the launch (no argument checks)
    B, H, Dh = eng.block, eng.heads, eng.hidden
    out = torch.empty((U * B, H, Dh), device=dev)
    lse = torch.empty((U * B, H), device=dev)
    ff_idx = ff_index(ff_mod, slice_ff, backward=False)
    ff_split_err = phase_p_split_error(ff_mod, slice_ff, ff_idx, "slice")
    mg_ms = cuda_ms(lambda: mg_mod.launch(**slice_mg, out=out, lse=lse, leaky_slope=0.2), reps=20)
    mg_plain_ms = cuda_ms(lambda: mg_mod.seg_gat_agg_multigraph_plain(**slice_mg), reps=3)
    ff_ms = cuda_ms(lambda: ff_mod.launch(**slice_ff, out=out, lse=lse, leaky_slope=0.2,
                                          index=ff_idx), reps=10)
    ff_plain_ms = cuda_ms(lambda: ff_mod.seg_gat_agg_fused_fp_plain(**slice_ff), reps=3)
    ff_mg_ms = cuda_ms(lambda: multigraph_composition(mg_mod, slice_mg, slice_ff, out, lse), reps=10)
    mg_bytes, mg_flops, live = multigraph_cost(slice_mg)
    ff_bytes, ff_flops, ff_kernel_flops, proj = fused_cost(slice_ff)
    mg_bound, mg_by = bound_ms(mg_bytes, mg_flops)
    ff_bounds = fused_bounds(ff_bytes, ff_flops, proj["needed"])
    log(f"[time] multigraph kernel {mg_ms:.4f} ms, plain {mg_plain_ms:.4f} ms, "
        f"bound {mg_bound:.4f} ms ({mg_by}); live slots {live}")
    log(f"[time] fused_fp kernel {ff_ms:.4f} ms, plain {ff_plain_ms:.4f} ms, MULTIGRAPH "
        f"composition (x@W + θ einsums + #1) {ff_mg_ms:.4f} ms, bound {ff_bounds['bound_ms']:.4f} "
        f"ms ({ff_bounds['bound_by']}; split TF32 {ff_bounds['bound_split_ms']:.4f}, CUDA cores "
        f"{ff_bounds['bound_cuda_cores_ms']:.4f}); function flops {ff_flops:.4e}, flops as the kernels do them "
        f"{ff_kernel_flops:.4e}; projection {proj['tiles']} row tiles for {proj['blocks']} "
        f"blocks, {proj['ratio']:.4f}x the needed rows")
    return {
        "multigraph": dict(max_abs_err=err_mg, ms=mg_ms, plain_ms=mg_plain_ms, library_ms=None,
                           bound_ms=mg_bound, bound_by=mg_by, bytes=mg_bytes, flops=mg_flops,
                           live_slots=live, units=U, width=W),
        "fused_fp": dict(max_abs_err=err_ff, ms=ff_ms, plain_ms=ff_plain_ms, library_ms=None,
                         multigraph_ms=ff_mg_ms, **ff_bounds, bytes=ff_bytes, flops=ff_flops,
                         kernel_flops=ff_kernel_flops, projection=proj,
                         split_error=ff_split_err, live_slots=live, units=U, width=W),
    }


def ff_topology(ops: dict):
    """The checked topology of these fused operands' units, over one table
    of ``x``'s rows."""
    from repro_torch.kernels.topology import Topology

    n_pad = ops["x"].shape[0]
    return Topology(ops["col_index"], ops["graph_id"], ops["dst_row"], ops["masks"],
                    n_graphs=ops["wsel"].shape[0], ns_pad=n_pad, nd_pad=n_pad)


def ff_index(ff_mod, ops: dict, *, backward: bool = True) -> dict:
    """#3/#4's fused index of these fused operands' topology."""
    return ff_topology(ops).fused_index(ops["wsel"], ops["w"].shape[0], backward=backward)


def multigraph_composition(mg_mod, mg, ff, out=None, lse=None):
    """What FUSED_FP has to beat: the MULTIGRAPH path on the same operands,
    cuBLAS ``x @ W + b`` and the θ einsums, then (given ``out``/``lse``)
    kernel #1.  Returns (h, θs, θd)."""
    H, Dh = ff["a_src"].shape[1:]
    h = torch.addmm(ff["b"][0], ff["x"], ff["w"][0]).reshape(ff["x"].shape[0], H, Dh)
    ths = torch.einsum("nhd,ghd->gnh", h, ff["a_src"]).contiguous()
    thd = torch.einsum("nhd,ghd->gnh", h, ff["a_dst"]).contiguous()
    if out is not None:
        mg_mod.launch(mg["col_index"], mg["graph_id"], mg["dst_row"], mg["masks"], ths, thd, h,
                      mg["edge_bias"], out, lse, leaky_slope=0.2)
    return h, ths, thd


# -- phase 4: training -------------------------------------------------------------

TRAIN = dict(dataset="imdb", scale=1.0, feat_scale=1.0, block=16, max_edges=400_000)
TRAIN_WIDTH = dict(hidden=64, heads=8)


def train_operands(data, params, fusion):
    """The operands one training step hands each kernel: all semantic graphs
    of the problem batched, the model's own weights."""
    col, gid, row, masks = fusion.build_unit_tables(data.graphs)
    b0 = data.graphs[0]
    n_pad = b0.num_dst_pad
    H, Dh = params["a_src"].shape[1:]
    x = data.features[data.target_type]
    x = torch.nn.functional.pad(x, (0, 0, 0, n_pad - x.shape[0])).contiguous()
    w, b, a_src, a_dst = (params[k] for k in ("w_fp", "b_fp", "a_src", "a_dst"))
    h = torch.addmm(b, x, w).reshape(n_pad, H, Dh)
    bias = torch.zeros((len(data.graphs), H), device=x.device)
    multi = dict(col_index=col, graph_id=gid, dst_row=row, masks=masks,
                 theta_src=torch.einsum("nhd,ghd->gnh", h, a_src).contiguous(),
                 theta_dst=torch.einsum("nhd,ghd->gnh", h, a_dst).contiguous(),
                 h_src=h.contiguous(), edge_bias=bias)
    fused = dict(col_index=col, graph_id=gid, dst_row=row,
                 wsel=torch.zeros(len(data.graphs), dtype=torch.int32, device=x.device),
                 masks=masks, x=x, w=w[None].contiguous(), b=b[None].contiguous(),
                 a_src=a_src.contiguous(), a_dst=a_dst.contiguous(), edge_bias=bias)
    return multi, fused


def multigraph_bwd_cost(ops):
    """(bytes, flops) of the multigraph backward on these inputs: its inputs
    (out, lse, g_out and the forward's operands, masks of live slots only)
    read once, its four gradients written once; per edge and head 4·Dh for
    the two products and ~10 ops for its logit."""
    col, masks, h = ops["col_index"], ops["masks"], ops["h_src"]
    U, W = col.shape
    B, (ns, H, Dh) = masks.shape[-1], h.shape
    live = int((col >= 0).sum())
    grads = ops["theta_src"].numel() + ops["theta_dst"].numel() + h.numel() + ops["edge_bias"].numel()
    nbytes = col.numel() * 4 + 2 * U * 4 + live * B * B + 4 * (2 * grads + U * B * H * (2 * Dh + 1))
    return nbytes, live_edges(col, masks) * H * (4 * Dh + 10), live


def fused_bwd_cost(ops):
    """(bytes, flops, kernel_flops, projection) of the fused backward launch
    on these inputs.  ``flops`` is the work the function needs: each
    (table, block) a live unit reads projected once, θ of each (graph,
    block) once, then the multigraph backward's work per edge.
    ``kernel_flops`` is what the kernels do: phase P's whole 128-row tiles,
    θ once per live unit and live slot, and NA on whole B×B blocks; it
    explains the kernels' time and is not their bound."""
    col, gid, row, masks, x = (ops[k] for k in ("col_index", "graph_id", "dst_row", "masks", "x"))
    U, W = col.shape
    B = masks.shape[-1]
    G, H, Dh = ops["a_src"].shape
    T, din = ops["w"].shape[:2]
    live_mask = col >= 0
    live = int(live_mask.sum())
    live_units = int(live_mask.any(dim=1).sum())
    nblk = x.shape[0] // B
    g_of = gid.long()[:, None].expand(U, W)[live_mask]
    src_blk = col.long()[live_mask]
    proj = fused_projection(ops)
    thetas = (torch.unique(g_of * nblk + src_blk).numel()
              + torch.unique(gid.long() * nblk + row.long()).numel())
    na = live_edges(col, masks) * H * (4 * Dh + 10)
    na_blocks = live * B * B * H * (4 * Dh + 10)
    nbytes = (col.numel() * 4 + 2 * U * 4 + G * 4 + live * B * B
              + 4 * (x.numel() + ops["w"].numel() + ops["b"].numel() + 2 * G * H * Dh + G * H)
              + 4 * U * B * H * (2 * Dh + 1)
              + 4 * (T * x.shape[0] * H * Dh + 2 * G * H * Dh + G * H))
    flops = proj["needed"] + thetas * 2 * B * H * Dh + na
    kernel_flops = proj["done"] + (live + live_units) * 2 * B * H * Dh + na_blocks
    return nbytes, flops, kernel_flops, proj


def check_bwd(name, fn, plain, ops, out, lse, g):
    """Kernel backward twice (bitwise equal) against its plain version."""
    got = fn(**ops, out=out, lse=lse, g_out=g)
    again = fn(**ops, out=out, lse=lse, g_out=g)
    want = plain(**ops, out=out, lse=lse, g_out=g)
    torch.cuda.synchronize()
    got, again, want = ([t for t in ts if t is not None] for ts in (got, again, want))
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}: two runs on the same inputs differ")
    return compare(name, got, want)


def recorded_launches(name: str, mod, launches: tuple[str, ...], first: int, run):
    """Runs ``run()`` with the launch functions ``launches`` of a kernel
    module recording the (arguments, result) of their first ``first``
    calls each.  Returns (run's result, {launch: [(args, result)]}); fails
    where a launch was called fewer times."""
    calls = {k: [] for k in launches}
    kernels = {k: getattr(mod, k) for k in launches}

    def recording(k):
        def call(*args):
            res = kernels[k](*args)
            if len(calls[k]) < first:
                calls[k].append((args, res))
            return res
        return call

    for k in launches:
        setattr(mod, k, recording(k))
    try:
        result = run()
    finally:
        for k, fn in kernels.items():
            setattr(mod, k, fn)
    if any(len(c) < first for c in calls.values()):
        raise AssertionError(f"{name}: fewer than {first} launches were recorded")
    return result, calls


def na_calls_to_plain(name: str, run, first: int, *, backward: bool = True):
    """Runs ``run()`` (training steps on the MULTIGRAPH path) with #1's and
    #2's launches recording their operands and results, the first ``first``
    of each, then holds each against the plain version on the same operands
    at atol=rtol=1e-4: #1 against ``seg_gat_agg_multigraph_plain``, #2
    against the plain VJP (``unit_softmax_aggregate_vjp``, given the
    launch's own delta), each gradient over its largest magnitude (a
    training step's gradients are far below the atol).  So every row width
    and block size a path runs is checked at the path's own shapes.  The
    recorded launches are the path's own; the plain versions launch no
    kernel.  ``backward=False``: a forward-only run, #1 alone.  Returns
    (run's result, the max abs error, #2's relative to each gradient's
    largest magnitude)."""
    mg_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg_multigraph")
    result, calls = recorded_launches(
        f"{name}: #1 and #2", mg_mod, ("launch", "launch_bwd") if backward else ("launch",),
        first, run)
    err = 0.0
    for n, (args, _) in enumerate(calls["launch"]):
        *ops, out, lse, slope = args
        want = mg_mod.seg_gat_agg_multigraph_plain(*ops, leaky_slope=slope)
        err = max(err, compare(f"{name} #1 launch {n}", (out, lse), want))
    for n, (args, got) in enumerate(calls.get("launch_bwd", [])):
        col, gid, row, masks, ths, thd, h, bias, g_out, lse, delta, _, slope = args
        d_ths, d_thd, d_h, _ = mg_mod.unit_softmax_aggregate_vjp(
            col, gid, row, masks, ths, thd, h[None],
            torch.zeros(ths.shape[0], dtype=torch.long, device=h.device), bias, slope, lse,
            delta, g_out)
        want = (d_ths, d_thd, d_h[0])
        scale = [float(w.abs().max()) or 1.0 for w in want]
        err = max(err, compare(f"{name} #2 launch {n} (over each gradient's largest magnitude "
                               f"{', '.join('%.3e' % c for c in scale)})",
                               [g / c for g, c in zip(got, scale)],
                               [w / c for w, c in zip(want, scale)]))
    return result, err


def exact_fused(ops: dict) -> dict:
    """The fused operands rounded to small dyadic values (x to 1/16, W and b
    to 1/64, a and the bias to 1/16, clipped) so that every projection and
    θ, and so every pre-activation, is exact in float32 whatever the order
    of the sums.  The kernel re-projects with its own K-tiled sum and the
    plain version with cuBLAS; on inexact operands a pre-activation within
    rounding of 0 takes the other LeakyReLU branch in the two versions and
    its backward derivative jumps from 1 to the slope, which no tolerance
    absorbs (the forward is continuous there)."""
    def q(t, step, lim):
        return (torch.round(t / step).clamp(-lim, lim) * step).contiguous()

    return dict(ops, x=q(ops["x"], 1 / 16, 2), w=q(ops["w"], 1 / 64, 4), b=q(ops["b"], 1 / 64, 4),
                a_src=q(ops["a_src"], 1 / 16, 8), a_dst=q(ops["a_dst"], 1 / 16, 8),
                edge_bias=q(ops["edge_bias"], 1 / 16, 8))


def mg_index(mg_mod, ops: dict) -> dict:
    """#2's edge index of these multigraph operands' topology."""
    ths, thd = ops["theta_src"], ops["theta_dst"]
    return mg_mod.Topology(ops["col_index"], ops["graph_id"], ops["dst_row"], ops["masks"],
                           n_graphs=ths.shape[0], ns_pad=ths.shape[1],
                           nd_pad=thd.shape[1]).edge_index()


def edge_visits(mg_mod, ops: dict, idx: dict, out, lse) -> dict:
    """The mask entries #1 and #2's two passes visit on these operands over
    the live edges (set mask entries of live slots), each of which must be
    1.0: #1's counted by the kernel (it takes no index); each pass of #2's
    from the edge index it walks (pass A: the edges of the unit rows of
    every (graph, dst block), pass B: the src-major CSR's).  The dense
    kernels before visited every entry of every live slot,
    ``dense_per_edge`` of them an edge."""
    edges = live_edges(ops["col_index"], ops["masks"])
    fwd = torch.zeros(1, dtype=torch.int32, device=out.device)
    mg_mod.launch(**ops, out=torch.empty_like(out), lse=torch.empty_like(lse), leaky_slope=0.2,
                  visits=fwd)
    B = ops["masks"].shape[-1]
    units = idx["gdst"][1].long()
    rows = (units[:, None] * B + torch.arange(B, device=units.device)).reshape(-1)
    row_off = idx["row_off"].long()
    pass_a = int((row_off[rows + 1] - row_off[rows]).sum())
    pass_b = int(idx["src_off"][-1] - idx["src_off"][0])
    dense = int((ops["col_index"] >= 0).sum()) * B * B
    res = dict(live_edges=edges, index_edges=idx["E"], fwd=int(fwd) / max(edges, 1),
               pass_a=pass_a / max(edges, 1), pass_b=pass_b / max(edges, 1),
               dense_per_edge=dense / max(edges, 1))
    if not (res["fwd"] == res["pass_a"] == res["pass_b"] == 1.0 and idx["E"] == edges):
        raise AssertionError(f"#1/#2 visit other entries than the edges: {res}")
    return res


def bwd_peak_memory(mg_mod, ops: dict, idx: dict, out, lse, g) -> dict:
    """Device memory one backward launch allocates at its peak, against
    what it must hold: its three gradients and its O(E·H) edge scratch.
    It must hold no per-(unit, slot) buffer (the dense kernel's partials
    were ``per_slot_bytes``)."""
    G, ns_pad, H = ops["theta_src"].shape
    nd_pad = ops["theta_dst"].shape[1]
    Dh = ops["h_src"].shape[-1]
    delta = (g * out).sum(-1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = mg_mod.launch_bwd(**ops, g_out=g, lse=lse, delta=delta, index=idx, leaky_slope=0.2)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del grads
    need = 4 * (ns_pad * H * Dh + G * (ns_pad + nd_pad) * H + 2 * idx["E"] * H)
    B = ops["masks"].shape[-1]
    res = dict(peak_bytes=peak, outputs_and_edge_scratch_bytes=need,
               per_slot_bytes=int((ops["col_index"] >= 0).sum()) * B * (H * Dh + H) * 4)
    if peak > need + (1 << 20):
        raise AssertionError(f"#2 allocates more than its gradients and edge scratch: {res}")
    return res


def train_kernel_phase(data, params, fusion, mg_mod, ff_mod) -> dict:
    dev = data.labels.device
    tr_mg, tr_ff = train_operands(data, params, fusion)
    U, W = tr_mg["col_index"].shape
    log(f"[train slice] U={U} W={W} live pairs={int((tr_mg['col_index'] >= 0).sum())} "
        f"B={data.graphs[0].block} H={params['a_src'].shape[1]} Dh={params['a_src'].shape[2]} "
        f"Din={tr_ff['x'].shape[1]} N_pad={tr_ff['x'].shape[0]} "
        f"edges={live_edges(tr_mg['col_index'], tr_mg['masks'])}")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [("train", tr_mg, tr_ff)]
    cases.append(("edge B=16 W=6 Din=100", *edge_operands(1, dev)))
    cases.append(("edge W=1", *edge_operands(2, dev, W=1)))
    cases.append(("edge B=8 H=2 Dh=8 Din=37", *edge_operands(3, dev, B=8, H=2, Dh=8, din=37)))
    # block sizes #3/#4 take re-blocked to 32
    cases.append(("edge B=64", *edge_operands(4, dev, B=64, U=12, W=4)))
    cases.append(("edge B=128 H=4 Dh=32", *edge_operands(5, dev, B=128, U=8, W=3, H=4, Dh=32)))
    # the row widths of the other paths #1/#2 run: R-GAT's (H·Dh = 256) and phase 4f's B = 128
    cases.append(("edge H=4 Dh=64", edge_operands(6, dev, H=4, Dh=64)[0], None))
    cases.append(("edge B=128 H=8 Dh=64", edge_operands(7, dev, B=128, U=8, W=3)[0], None))
    errs = dict(multigraph=0.0, multigraph_bwd=0.0, fused_fp=0.0, fused_fp_bwd=0.0)
    for name, mg, ff in cases:
        out, lse = mg_mod.seg_gat_agg_multigraph_fwd(**mg)
        again = mg_mod.seg_gat_agg_multigraph_fwd(**mg)
        want = mg_mod.seg_gat_agg_multigraph_plain(**mg)
        torch.cuda.synchronize()
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            raise AssertionError(f"multigraph {name}: two runs on the same inputs differ")
        errs["multigraph"] = max(errs["multigraph"], compare(f"multigraph {name}", (out, lse), want))
        g = torch.randn(out.shape, generator=gen, device=dev)
        errs["multigraph_bwd"] = max(errs["multigraph_bwd"], check_bwd(
            f"multigraph_bwd {name}", mg_mod.seg_gat_agg_multigraph_bwd,
            mg_mod.seg_gat_agg_multigraph_bwd_plain, mg, out, lse, g))
        if ff is None:
            continue
        ff = exact_fused(ff)
        out_f, lse_f = ff_mod.seg_gat_agg_fused_fp_fwd(**ff)
        again = ff_mod.seg_gat_agg_fused_fp_fwd(**ff)
        want = ff_mod.seg_gat_agg_fused_fp_plain(**ff)
        torch.cuda.synchronize()
        if not (torch.equal(out_f, again[0]) and torch.equal(lse_f, again[1])):
            raise AssertionError(f"fused_fp {name}: two runs on the same inputs differ")
        errs["fused_fp"] = max(errs["fused_fp"], compare(f"fused_fp {name}", (out_f, lse_f), want))
        errs["fused_fp_bwd"] = max(errs["fused_fp_bwd"], check_bwd(
            f"fused_fp_bwd {name}", ff_mod.seg_gat_agg_fused_fp_bwd,
            ff_mod.seg_gat_agg_fused_fp_bwd_plain, ff, out_f, lse_f, g))
        if name == "train":
            res = dict(out=out, lse=lse, out_f=out_f, lse_f=lse_f, g=g)

    # timing at the training shapes, straight on the launches (no argument checks)
    mg, ff = tr_mg, exact_fused(tr_ff)
    out, lse, out_f, lse_f, g = (res[k] for k in ("out", "lse", "out_f", "lse_f", "g"))
    o = torch.empty_like(out)
    lo = torch.empty_like(lse)
    t = {}
    t["multigraph"] = (cuda_ms(lambda: mg_mod.launch(**mg, out=o, lse=lo, leaky_slope=0.2), reps=20),
                       cuda_ms(lambda: mg_mod.seg_gat_agg_multigraph_plain(**mg), reps=2), None)
    idx = mg_index(mg_mod, mg)
    visits = edge_visits(mg_mod, mg, idx, out, lse)
    log(f"[check] #1/#2 entries visited / live edges at the training shape: forward "
        f"{visits['fwd']}, pass A {visits['pass_a']}, pass B {visits['pass_b']} "
        f"({visits['live_edges']} edges; the dense kernels visited {visits['dense_per_edge']:.2f} "
        f"entries an edge)")
    peak = bwd_peak_memory(mg_mod, mg, idx, out, lse, g)
    log(f"[check] #2 one backward's peak memory {peak['peak_bytes'] / 2**20:.3f} MiB (gradients "
        f"and edge scratch {peak['outputs_and_edge_scratch_bytes'] / 2**20:.3f} MiB; the dense "
        f"kernel's per-slot partials were {peak['per_slot_bytes'] / 2**30:.3f} GiB)")
    delta = (g * out).sum(-1)
    t["multigraph_bwd"] = (
        cuda_ms(lambda: mg_mod.launch_bwd(**mg, g_out=g, lse=lse, delta=delta, index=idx,
                                          leaky_slope=0.2), reps=20),
        cuda_ms(lambda: mg_mod.seg_gat_agg_multigraph_bwd_plain(**mg, out=out, lse=lse, g_out=g),
                reps=1), None)

    fidx = ff_index(ff_mod, ff)
    split_err = phase_p_split_error(ff_mod, tr_ff, fidx, "train")  # HAN's own, inexact operands
    delta_f = (g * out_f).sum(-1)

    def composition_vjp():  # x @ W + b and θ as the MULTIGRAPH path has them, then #2
        h, ths, thd = multigraph_composition(mg_mod, mg, ff)
        mg_mod.launch_bwd(mg["col_index"], mg["graph_id"], mg["dst_row"], mg["masks"], ths, thd,
                          h, mg["edge_bias"], g, lse_f, delta_f, idx, 0.2)

    t["fused_fp"] = (
        cuda_ms(lambda: ff_mod.launch(**ff, out=o, lse=lo, leaky_slope=0.2, index=fidx), reps=10),
        cuda_ms(lambda: ff_mod.seg_gat_agg_fused_fp_plain(**ff), reps=1), None,
        cuda_ms(lambda: multigraph_composition(mg_mod, mg, ff, o, lo), reps=10))
    t["fused_fp_bwd"] = (
        cuda_ms(lambda: ff_mod.launch_bwd(**ff, g_out=g, lse=lse_f, delta=delta_f, index=fidx,
                                          leaky_slope=0.2), reps=10),
        cuda_ms(lambda: ff_mod.seg_gat_agg_fused_fp_bwd_plain(**ff, out=out_f, lse=lse_f, g_out=g,
                                                               need_dx=False), reps=1), None,
        cuda_ms(composition_vjp, reps=10))
    fwd_cost, bwd_cost = fused_cost(ff), fused_bwd_cost(ff)
    costs = {"multigraph": multigraph_cost(mg)[:2], "multigraph_bwd": multigraph_bwd_cost(mg)[:2],
             "fused_fp": fwd_cost[:2], "fused_fp_bwd": bwd_cost[:2]}
    fused = {"fused_fp": fwd_cost, "fused_fp_bwd": bwd_cost}
    result = {}
    for k, (ms, plain_ms, lib_ms, *comp) in t.items():
        nbytes, flops = costs[k]
        bound, by = bound_ms(nbytes, flops)
        result[k] = dict(max_abs_err=errs[k], ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
        extra = ""
        if k in fused:
            _, _, kernel_flops, proj = fused[k]
            result[k].update(fused_bounds(nbytes, flops, proj["needed"]), multigraph_ms=comp[0],
                             kernel_flops=kernel_flops, projection=proj, split_error=split_err)
            bound, by = result[k]["bound_ms"], result[k]["bound_by"]
            extra = (f"; flops as the kernels do them {kernel_flops:.4e}, projection "
                     f"{proj['tiles']} row tiles for {proj['blocks']} blocks = "
                     f"{proj['ratio']:.4f}x the needed rows; bound with split TF32 "
                     f"{result[k]['bound_split_ms']:.4f} ms, all on the CUDA cores "
                     f"{result[k]['bound_cuda_cores_ms']:.4f} ms; MULTIGRAPH composition "
                     f"{comp[0]:.4f} ms")
            if proj["ratio"] > 1.5:
                raise AssertionError(f"{k}: phase P projects {proj['ratio']:.3f}x the rows the "
                                     "function needs (limit 1.5)")
        log(f"[train time] {k} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({by}; {nbytes:.4e} B, {flops:.4e} flops){extra}")
    result["multigraph"]["visits"] = result["multigraph_bwd"]["visits"] = visits
    result["multigraph_bwd"]["peak_memory"] = peak
    return result


def fused_alone() -> dict:
    """Phase 4a on its own (``python3 -c 'import chip_smoke as c;
    c.fused_alone()'``): builds #1-#4 and #6 (whose product #3 and #4
    share), writes their ptxas reports, runs the training-shape kernel phase
    on full IMDB and writes fused.json to the output directory."""
    from repro_torch.core import fusion
    from repro_torch.kernels import build
    from repro_torch.launch import hgnn_train
    from repro_torch.models.hgnn import HAN

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    log(card_line())
    OUT.mkdir(exist_ok=True)
    check_ptxas(build.build(("seg_gat_agg_multigraph", "seg_gat_agg_multigraph_bwd",
                             "seg_gat_agg_fused_fp", "seg_gat_agg_fused_fp_bwd",
                             "fused_fp_coeff")))
    _, tdata = hgnn_train.build_problem(device="cuda", **TRAIN)
    params0 = HAN.init(torch.Generator().manual_seed(0), tdata, **TRAIN_WIDTH,
                       att_dim=2 * TRAIN_WIDTH["hidden"])
    res = train_kernel_phase(tdata, params0, fusion,
                             importlib.import_module("repro_torch.kernels.seg_gat_agg_multigraph"),
                             importlib.import_module("repro_torch.kernels.seg_gat_agg_fused_fp"))
    res["card"] = card_line()
    (OUT / "fused.json").write_text(json.dumps(res, indent=1, default=str))
    log(res["card"])
    return res


def profiled(run, n) -> dict:
    """``run()`` ``n`` times, each timed with CUDA events, all under
    torch.profiler (device activity only); idle share = 1 - busy / wall."""
    from torch.profiler import ProfilerActivity, profile

    times = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                      if e.self_device_time_total > 0), key=lambda k: -k[1])
    busy, wall = sum(k[1] for k in kernels), sum(times)
    if busy <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return dict(steps_ms=times, device_busy_ms=busy, device_wall_ms=wall,
                device_idle_share=1.0 - busy / wall,
                nccl_ms=sum(k[1] for k in kernels if "nccl" in k[0].lower()),
                top_kernels=[dict(name=k[0][:80], device_ms=k[1], calls=k[2])
                             for k in kernels[:8]])


def profiled_steps(step_fn, state, idx, n) -> tuple[object, dict]:
    """``n`` train steps under :func:`profiled`."""
    box = [state]

    def run():
        box[0], _ = step_fn(box[0], {"idx": idx})

    res = profiled(run, n)
    return box[0], res


def training(data, counters, fusion_mod) -> dict:
    """Phases 4b-4e; returns what they measured."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch import hgnn_train
    from repro_torch.models.hgnn import HAN, han_forward
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import hgnn_loss_and_grads, init_hgnn_train_state, make_hgnn_train_step

    NAB = fusion_mod.NABackend
    res = {}
    # b. the main path, as a user runs it: counters zeroed just before, read just after
    lines = []
    adamw_fn = importlib.import_module("repro_torch.kernels.fused_adamw").fused_adamw
    torch.cuda.reset_peak_memory_stats()
    for fn in (*counters.values(), adamw_fn):
        fn.launches = 0
    t0 = time.perf_counter()
    _, hist, meta = hgnn_train.run_training(steps=20, backend="kernel", log_every=1,
                                            log=lines.append, device="cuda", **TRAIN, **TRAIN_WIDTH)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    adamw_launches = adamw_fn.launches
    res["multigraph_run"] = dict(launches=launches, adamw_launches=adamw_launches, wall_s=wall,
                                 meta=meta,
                                 peak_mem_bytes=torch.cuda.max_memory_allocated(),
                                 steps_ms=[h["sec"] * 1e3 for h in hist],
                                 loss=[h["loss"] for h in hist])
    log(f"[train multigraph] {lines[0]}")
    log(f"[train multigraph] launches={json.dumps(launches)} loss {hist[0]['loss']:.6f} -> "
        f"{hist[-1]['loss']:.6f}, step ms cold {hist[0]['sec'] * 1e3:.3f}, steady median "
        f"{float(np.median([h['sec'] for h in hist[1:]])) * 1e3:.3f}, wall {wall:.3f} s, peak mem "
        f"{res['multigraph_run']['peak_mem_bytes'] / 2**30:.3f} GiB")
    if launches != {"multigraph": 20, "multigraph_bwd": 20, "fused_fp": 0, "fused_fp_bwd": 0}:
        raise AssertionError(f"training launches per step are not 1/1/0/0 over 20 steps: {launches}")
    if adamw_launches != 2 * 20:
        raise AssertionError(f"AdamW's kernel pair launched {adamw_launches} times in 20 steps")
    if not hist[-1]["loss"] < hist[0]["loss"] or not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"the loss did not fall: {[h['loss'] for h in hist]}")

    # c. FUSED_FP training from the same initial state
    opt = AdamWConfig(lr=5e-3, weight_decay=0.0)
    width = dict(TRAIN_WIDTH, att_dim=2 * TRAIN_WIDTH["hidden"])
    state0 = init_hgnn_train_state(HAN, torch.Generator().manual_seed(0), data, opt, **width)
    idx = torch.arange(data.labels.shape[0])
    step_ff = make_hgnn_train_step(lambda p: han_forward(p, data, backend=NAB.FUSED_FP), data, opt)
    step_mg = make_hgnn_train_step(lambda p: han_forward(p, data, backend=NAB.MULTIGRAPH), data, opt)
    torch.cuda.reset_peak_memory_stats()
    fused_fns = (counters["fused_fp"], counters["fused_fp_bwd"])
    for fn in counters.values():
        fn.launches = 0
    for fn in fused_fns:
        fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)
    t0 = time.perf_counter()
    st, m0 = step_ff(state0, {"idx": idx})
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    st, prof_ff = profiled_steps(step_ff, st, idx, 2)
    launches = {k: fn.launches for k, fn in counters.items()}
    by_route = {k: dict(fn.launches_by_route) for k, fn in zip(("fused_fp", "fused_fp_bwd"), fused_fns)}
    res["fused_fp_run"] = dict(launches=launches, launches_by_route=by_route, cold_ms=cold_ms,
                               steady=prof_ff, peak_mem_bytes=torch.cuda.max_memory_allocated(),
                               first_loss=float(m0["loss"]))
    log(f"[train fused_fp] launches={json.dumps(launches)} by projection route "
        f"{json.dumps(by_route)} step ms cold {cold_ms:.3f}, steady "
        f"{['%.3f' % s for s in prof_ff['steps_ms']]}, idle share {prof_ff['device_idle_share']:.4f}, "
        f"peak mem {res['fused_fp_run']['peak_mem_bytes'] / 2**30:.3f} GiB")
    if launches != {"multigraph": 0, "multigraph_bwd": 0, "fused_fp": 3, "fused_fp_bwd": 3}:
        raise AssertionError(f"FUSED_FP training launches are not 0/0/3/3 over 3 steps: {launches}")
    if any(r["cuda_cores"] for r in by_route.values()):
        raise AssertionError(f"FUSED_FP at H·Dh = 512 projected on the CUDA cores: {by_route}")
    if abs(float(m0["loss"]) - hist[0]["loss"]) > 1e-3 * abs(hist[0]["loss"]):
        raise AssertionError(f"FUSED_FP first loss {float(m0['loss'])} vs the main path's {hist[0]['loss']}")
    grads = {}
    for nab in (NAB.MULTIGRAPH, NAB.FUSED_FP):
        loss, _, g = hgnn_loss_and_grads(lambda p: han_forward(p, data, backend=nab),
                                         state0.params, data, idx)
        grads[nab] = (loss, g)
    names = sorted(grads[NAB.MULTIGRAPH][1])
    err = 0.0
    for k in names:
        a, b = grads[NAB.FUSED_FP][1][k], grads[NAB.MULTIGRAPH][1][k]
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5, msg=lambda s: f"grad {k}: {s}")
        err = max(err, float((a - b).abs().max()))
    torch.testing.assert_close(grads[NAB.FUSED_FP][0], grads[NAB.MULTIGRAPH][0], rtol=1e-3, atol=1e-5)
    res["fused_vs_multigraph_grad_max_abs_err"] = err
    log(f"[check] first-step loss and gradients fused_fp vs multigraph: max_abs_err={err:.3e} "
        f"(rtol=1e-3, atol=1e-5)")

    # d. repeatability, then steady MULTIGRAPH steps under the profiler
    runs = []
    for _ in range(2):
        st = state0
        for _ in range(3):
            st, _ = step_mg(st, {"idx": idx})
        torch.cuda.synchronize()
        runs.append(st)
    from repro_torch.tree import tree_leaves_with_path

    for (ka, va), (kb, vb) in zip(tree_leaves_with_path(runs[0]), tree_leaves_with_path(runs[1])):
        if ka != kb or not torch.equal(va, vb):
            raise AssertionError(f"3 MULTIGRAPH steps twice from one state differ at {ka}")
    log("[check] 3 MULTIGRAPH steps, twice from the same state: bitwise equal")
    _, prof_mg = profiled_steps(step_mg, runs[0], idx, 3)
    res["multigraph_steady"] = prof_mg
    log(f"[train multigraph steady] steps_ms={['%.3f' % s for s in prof_mg['steps_ms']]} busy "
        f"{prof_mg['device_busy_ms']:.3f} ms of {prof_mg['device_wall_ms']:.3f} ms, idle share "
        f"{prof_mg['device_idle_share']:.4f}")
    for name, pr in (("multigraph", prof_mg), ("fused_fp", prof_ff)):
        for k in pr["top_kernels"][:5]:
            log(f"[train {name} steady]   {k['device_ms']:9.3f} ms x{k['calls']:<4d} {k['name']}")

    # e. the card against the CPU on a small graph; the launcher with a resume
    small = dict(dataset="acm", scale=0.05, block=8, max_edges=20_000, hidden=8, heads=2,
                 steps=3, log_every=1, log=lambda _: None)
    losses = {dev: [h["loss"] for h in hgnn_train.run_training(device=dev, **small)[1]]
              for dev in ("cpu", "cuda")}
    compare("small acm training losses cuda vs cpu",
            (torch.tensor(losses["cuda"]),), (torch.tensor(losses["cpu"]),))
    ck = OUT / "train_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    outs = []
    for steps in ("4", "6"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            hgnn_train.main(["--steps", steps, "--ckpt-every", "2", "--ckpt", str(ck)])
        outs.append(buf.getvalue())
    if "[resume] step=4" not in outs[1] or latest_step(str(ck)) != 6:
        raise AssertionError(f"launcher resume: {outs[1][-500:]}")
    shutil.rmtree(ck, ignore_errors=True)
    log(f"[launcher] hgnn_train: {outs[0].strip().splitlines()[-1]}; resumed at step 4: "
        f"{outs[1].strip().splitlines()[-1]}")
    res["small_losses"] = losses

    # f. MULTIGRAPH at the reference trainer's block size, which #1/#2 take
    lines = []
    (_, hist, _), err = na_calls_to_plain("B=128 step", lambda: hgnn_train.run_training(
        steps=5, backend="kernel", log_every=1, log=lines.append, device="cuda",
        **dict(TRAIN, block=128), **TRAIN_WIDTH), first=1)
    res["block128"] = dict(loss=[h["loss"] for h in hist], steps_ms=[h["sec"] * 1e3 for h in hist],
                           first_step_max_abs_err=err)
    log(f"[train multigraph B=128] {lines[0]}")
    log(f"[train multigraph B=128] loss {hist[0]['loss']:.6f} -> {hist[-1]['loss']:.6f} in 5 steps, "
        f"step ms {['%.3f' % t for t in res['block128']['steps_ms']]}")
    if not hist[-1]["loss"] < hist[0]["loss"] or not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"the B=128 loss did not fall: {res['block128']['loss']}")
    return res


# -- phase 4g: multi-lane HAN (paper §4.2) -----------------------------------------

LANE_PLANS = ((1, True), (4, True), (16, True), (16, False))  # (lanes, balanced) at B = 128
LANE_GRAD_REL = 1e-5  # plan vs MULTIGRAPH gradients: max |Δ| over the leaf's largest magnitude
FUSED_GRAD_TOL = dict(rtol=1e-3, atol=1e-5)  # as phase 4c's fused_fp vs multigraph
# and, on the leaves #4 computes (dW, db, da), max |Δ| over the leaf's largest
# magnitude.  The leaves after NA see #3's output only, through the semantic
# softmax, whose b_g gradient nearly cancels: the phase prints each leaf's
# distance from a float64 SEGMENT run for both backends, to show it
FUSED_GRAD_REL = 1e-4
FUSED_LEAVES = ("w_fp", "b_fp", "a_src", "a_dst")


def event_steps(step_fns: dict, states: dict, idx, n: int) -> tuple[dict, dict]:
    """``n`` train steps of each step function in turns, each timed alone
    with CUDA events (no profiler).  Returns (states, {name: [ms]})."""
    times = {k: [] for k in step_fns}
    for _ in range(n):
        for k, fn in step_fns.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            states[k], _ = fn(states[k], {"idx": idx})
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
    return states, times


def multilane_phase(tdata, counters, mg_mod) -> dict:
    """Phase 4g: HAN over lane plans (``han_forward_multilane``) on the
    phase-4 problem at B = 128, a 16-lane training run through the
    launcher, and ``fused_fp`` over a plan at B = 16 (``tdata``)."""
    from repro_torch.core import NABackend, build_multilane_plan
    from repro_torch.launch import hgnn_train
    from repro_torch.models.hgnn import HAN, han_forward, han_forward_multilane
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import hgnn_loss_and_grads, init_hgnn_train_state, make_hgnn_train_step

    res = {}
    width = dict(TRAIN_WIDTH, att_dim=2 * TRAIN_WIDTH["hidden"])
    _, data = hgnn_train.build_problem(device="cuda", **dict(TRAIN, block=128))
    params = HAN.init(torch.Generator().manual_seed(0), data, **width)
    idx = torch.arange(data.labels.shape[0], device=data.labels.device)
    fwd, bwd = counters["multigraph"], counters["multigraph_bwd"]

    def loss_and_grads(forward):
        return hgnn_loss_and_grads(forward, params, data, idx)

    with torch.no_grad():
        want = han_forward(params, data, backend=NABackend.MULTIGRAPH)
    mg_loss, _, mg_grads = loss_and_grads(lambda p: han_forward(p, data, backend=NABackend.MULTIGRAPH))
    plans = {}
    for lanes, balanced in LANE_PLANS:
        name = f"{lanes} lanes {'balanced' if balanced else 'naive'}"
        t0 = time.perf_counter()
        plan = plans[name] = build_multilane_plan(data.graphs, lanes, balanced=balanced)
        build_s = time.perf_counter() - t0
        units = plan.units()
        lp = plan.lane_plan
        forward = lambda p, plan=plan: han_forward_multilane(p, data, plan, backend="kernel")  # noqa: E731
        with torch.no_grad():
            logits = forward(params)
        if not torch.equal(logits, want):
            raise AssertionError(f"{name}: logits differ from MULTIGRAPH's at B = 128 "
                                 f"(max |d| {float((logits - want).abs().max()):.3e})")
        fwd.launches = bwd.launches = 0
        loss, _, grads = loss_and_grads(forward)
        torch.cuda.synchronize()
        launches = (fwd.launches, bwd.launches)
        if launches != (1, 1):
            raise AssertionError(f"{name}: a step launched #1, #2 {launches} times, not once each")
        if not torch.equal(loss, mg_loss):
            raise AssertionError(f"{name}: loss {float(loss)!r} vs MULTIGRAPH's {float(mg_loss)!r}")
        rel = 0.0
        for k, g in grads.items():
            scale = float(mg_grads[k].abs().max()) or 1.0
            rel = max(rel, float((g - mg_grads[k]).abs().max()) / scale)
        if rel > LANE_GRAD_REL:
            raise AssertionError(f"{name}: gradients {rel:.3e} of their scale from MULTIGRAPH's")
        _, _, again = loss_and_grads(forward)
        if not all(torch.equal(again[k], g) for k, g in grads.items()):
            raise AssertionError(f"{name}: two backward runs of one plan differ")
        res[name] = dict(lanes=lanes, balanced=balanced, imbalance=lp.imbalance(),
                         lane_load=lp.lane_load.tolist(), units=units.count,
                         units_per_lane=int(plan.col_index.shape[1]),
                         slots=int(plan.col_index.shape[2]), plan_host_bytes=plan.nbytes(),
                         unit_table_bytes=units.nbytes(), build_s=build_s,
                         grad_rel_err=rel, launches_a_step=launches)
        log(f"[multilane {name}] imbalance {lp.imbalance():.4f} (lane loads max "
            f"{lp.lane_load.max():.0f}, mean {lp.lane_load.mean():.1f}), {units.count} units, "
            f"[L, U, W] = {tuple(plan.col_index.shape)}, padded tables "
            f"{plan.nbytes() / 2**20:.1f} MiB on the host, unit tables on the card "
            f"{units.nbytes() / 2**20:.1f} MiB, built in {build_s:.2f} s; logits and "
            f"loss bitwise MULTIGRAPH's, gradients {rel:.3e} of their scale (limit "
            f"{LANE_GRAD_REL}), repeat bitwise; #1/#2 launches a step {launches}")

    # #1 and #2 on the 16-lane plan's lane-ordered units against their plain
    # versions at the plan's own operands (the lane order sets #2's src-major CSR)
    plan16 = plans["16 lanes balanced"]
    _, res["plain_err_16_lanes"] = na_calls_to_plain(
        "16 lanes balanced step",
        lambda: loss_and_grads(lambda p: han_forward_multilane(p, data, plan16, backend="kernel")),
        first=1)

    # visits: #1 and #2's passes walk exactly the edges of the 16-lane plan's units
    units = plans["16 lanes balanced"].units()
    n_pad = data.graphs[0].num_dst_pad
    H, Dh = params["a_src"].shape[1:]
    x = data.features[data.target_type]
    h = torch.nn.functional.pad(torch.addmm(params["b_fp"], x, params["w_fp"]),
                                (0, 0, 0, n_pad - x.shape[0])).reshape(n_pad, H, Dh)
    ops = dict(col_index=units.col_index, graph_id=units.graph_id, dst_row=units.dst_row,
               masks=units.masks, theta_src=torch.einsum("nhd,ghd->gnh", h, params["a_src"]).contiguous(),
               theta_dst=torch.einsum("nhd,ghd->gnh", h, params["a_dst"]).contiguous(),
               h_src=h.contiguous(), edge_bias=torch.zeros((len(data.graphs), H), device=h.device))
    out, lse = mg_mod.seg_gat_agg_multigraph_fwd(**ops)
    idx_e = units.topology(len(data.graphs), n_pad, n_pad).edge_index()
    res["visits"] = edge_visits(mg_mod, ops, idx_e, out, lse)
    log(f"[multilane 16 lanes balanced] entries visited an edge: #1 {res['visits']['fwd']}, "
        f"#2 pass A {res['visits']['pass_a']}, pass B {res['visits']['pass_b']} "
        f"({res['visits']['live_edges']} edges)")

    # the launcher over a 16-lane plan, counters zeroed just before, read just after
    lines = []
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    _, hist, meta = hgnn_train.run_training(model_name="HAN", plan_lanes=16, steps=5,
                                            log_every=1, log=lines.append, device="cuda",
                                            **dict(TRAIN, block=128), **TRAIN_WIDTH)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    res["run"] = dict(launches=launches, meta=meta, wall_s=wall, loss=[h["loss"] for h in hist],
                      steps_ms=[h["sec"] * 1e3 for h in hist])
    log(f"[multilane train] {lines[0]}")
    log(f"[multilane train] launches={json.dumps(launches)} loss {hist[0]['loss']:.6f} -> "
        f"{hist[-1]['loss']:.6f} in 5 steps, host step ms "
        f"{['%.3f' % t for t in res['run']['steps_ms']]}, wall {wall:.3f} s")
    if launches != {"multigraph": 5, "multigraph_bwd": 5, "fused_fp": 0, "fused_fp_bwd": 0}:
        raise AssertionError(f"the 16-lane run's launches are not 1/1/0/0 a step: {launches}")
    if meta["plan_lanes"] != 16 or meta["backend"] != "kernel":
        raise AssertionError(f"the 16-lane run's meta: {meta}")
    if not hist[-1]["loss"] < hist[0]["loss"] or not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"the 16-lane loss did not fall: {res['run']['loss']}")

    # step times against MULTIGRAPH's at B = 128, in turns, then under the profiler
    opt = AdamWConfig(lr=5e-3, weight_decay=0.0)
    step_fns = {
        "plan16": make_hgnn_train_step(
            lambda p: han_forward_multilane(p, data, plan16, backend="kernel"), data, opt),
        "multigraph": make_hgnn_train_step(
            lambda p: han_forward(p, data, backend=NABackend.MULTIGRAPH), data, opt)}
    states = {k: init_hgnn_train_state(HAN, torch.Generator().manual_seed(0), data, opt, **width)
              for k in step_fns}
    states, times = event_steps(step_fns, states, idx, 11)
    res["steps"] = {}
    for k, fn in step_fns.items():
        _, prof = profiled_steps(fn, states[k], idx, 3)
        med = float(np.median(times[k][1:]))
        res["steps"][k] = dict(event_ms=times[k], median_ms=med, steady=prof)
        log(f"[multilane step {k}] B=128 median {med:.3f} ms (CUDA events, 10 steps after the "
            f"first, in turns), profiled {['%.3f' % t for t in prof['steps_ms']]}, busy "
            f"{prof['device_busy_ms']:.3f} of {prof['device_wall_ms']:.3f} ms, idle share "
            f"{prof['device_idle_share']:.4f}")

    # fused_fp over a plan at B = 16 against the kernel backend
    plan = build_multilane_plan(tdata.graphs, 4)
    p16 = HAN.init(torch.Generator().manual_seed(0), tdata, **width)
    idx16 = torch.arange(tdata.labels.shape[0], device=tdata.labels.device)
    got = {}
    for backend in ("kernel", "fused_fp"):
        forward = lambda p, b=backend: han_forward_multilane(p, tdata, plan, backend=b)  # noqa: E731
        for fn in counters.values():
            fn.launches = 0
        with torch.no_grad():
            logits = forward(p16)
        loss, _, grads = hgnn_loss_and_grads(forward, p16, tdata, idx16)
        torch.cuda.synchronize()
        got[backend] = (logits, loss, grads, {k: fn.launches for k, fn in counters.items()})
    launches = got["fused_fp"][3]
    if launches != {"multigraph": 0, "multigraph_bwd": 0, "fused_fp": 2, "fused_fp_bwd": 1}:
        raise AssertionError(f"fused_fp on the plan: a forward and a step launched {launches}, "
                             "not #3 once and #3, #4 once each")
    logit_err = compare("fused_fp vs kernel on a 4-lane plan at B=16, logits",
                        (got["fused_fp"][0],), (got["kernel"][0],))
    def rel(g, w):  # max |g - w| over w's largest magnitude
        return float((g.double() - w.double()).abs().max() / (w.double().abs().max() or 1.0))

    d64 = dataclasses.replace(tdata, features={k: v.double() for k, v in tdata.features.items()})
    p64 = {k: v.double().requires_grad_() for k, v in p16.items()}
    loss64 = torch.nn.functional.cross_entropy(han_forward(p64, d64, backend=NABackend.SEGMENT),
                                               tdata.labels)
    g64 = dict(zip(p64, torch.autograd.grad(loss64, list(p64.values()))))
    err, rels, off64 = 0.0, {}, {}
    for k, g in got["fused_fp"][2].items():
        w = got["kernel"][2][k]
        torch.testing.assert_close(g, w, **FUSED_GRAD_TOL, msg=lambda m: f"grad {k}: {m}")
        err = max(err, float((g - w).abs().max()))
        rels[k] = rel(g, w)
        off64[k] = {b: rel(got[b][2][k], g64[k]) for b in got}
    worst = max(rels[k] for k in FUSED_LEAVES)
    res["fused_fp"] = dict(launches=launches, logits_max_abs_err=logit_err, grad_max_abs_err=err,
                           grad_rel_err=rels, grad_rel_from_float64=off64,
                           loss=(float(got["fused_fp"][1]), float(got["kernel"][1])))
    log(f"[check] fused_fp vs kernel on a 4-lane plan at B=16: one step's gradients "
        f"max_abs_err={err:.3e} ({FUSED_GRAD_TOL}); over each leaf's largest magnitude "
        f"{', '.join(f'{k} {v:.3e}' for k, v in rels.items())} (limit {FUSED_GRAD_REL} on "
        f"{', '.join(FUSED_LEAVES)}); launches {json.dumps(launches)} "
        "(a no-grad forward, then a step)")
    log("[multilane fused_fp] each float32 backend's gradients from a float64 SEGMENT run's, "
        "over the leaf's largest magnitude: " + ", ".join(
            f"{k} {v['fused_fp']:.3e}/{v['kernel']:.3e}" for k, v in off64.items()))
    if worst > FUSED_GRAD_REL:
        raise AssertionError(f"fused_fp on the plan: #4's gradients {worst:.3e} of their scale "
                             f"from the kernel backend's (limit {FUSED_GRAD_REL})")
    return res


def multilane_alone() -> dict:
    """Phase 4g alone: builds the kernels, runs the phase on the phase-4
    problem and writes chiprun_out/multilane.json."""
    from repro_torch.kernels import build
    from repro_torch.launch import hgnn_train

    torch.backends.cuda.matmul.allow_tf32 = False
    OUT.mkdir(exist_ok=True)
    log(card_line())
    build.build()
    mg_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg_multigraph")
    ff_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg_fused_fp")
    counters = {"multigraph": mg_mod.seg_gat_agg_multigraph_fwd,
                "multigraph_bwd": mg_mod.seg_gat_agg_multigraph_bwd,
                "fused_fp": ff_mod.seg_gat_agg_fused_fp_fwd,
                "fused_fp_bwd": ff_mod.seg_gat_agg_fused_fp_bwd}
    _, tdata = hgnn_train.build_problem(device="cuda", **TRAIN)
    res = multilane_phase(tdata, counters, mg_mod)
    (OUT / "multilane.json").write_text(json.dumps(res, indent=1, default=str))
    log(card_line())
    return res


def lanes_sharded() -> dict:
    """The lane axis over several cards, run apart, one process a card:

        torchrun --nproc-per-node 4 --no-python python3 -c 'import chip_smoke as c; c.lanes_sharded()'

    HAN at its own width on the phase-4 problem at B = 128, a 16-lane plan
    split over the lane group (NCCL): on every rank the sharded logits and
    loss equal the one-process plan's bit for bit, the gradients are within
    ``LANE_GRAD_REL`` of their scale of the one-process ones and the same
    on every rank, and a sharded step launches #1 and #2 once each on a
    rank that holds units; then
    the sharded step and the one-process step (the whole plan on each
    card) timed with CUDA events in turns.  Lane rank 0 prints the results
    and writes chiprun_out/lanes_sharded.json."""
    import torch.distributed as dist

    from repro_torch.core import build_multilane_plan
    from repro_torch.launch import hgnn_train
    from repro_torch.launch.mesh import make_lane_mesh
    from repro_torch.models.hgnn import HAN, han_forward_multilane
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import hgnn_loss_and_grads, init_hgnn_train_state, make_hgnn_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl")
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        mesh = make_lane_mesh(world, 1)
        mg_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg_multigraph")
        dev = torch.device("cuda", torch.cuda.current_device())
        width = dict(TRAIN_WIDTH, att_dim=2 * TRAIN_WIDTH["hidden"])
        _, data = hgnn_train.build_problem(device=dev, **dict(TRAIN, block=128))
        params = HAN.init(torch.Generator().manual_seed(0), data, **width)
        plan = build_multilane_plan(data.graphs, 16)
        idx = torch.arange(data.labels.shape[0], device=dev)
        forwards = {"one": lambda p: han_forward_multilane(p, data, plan, backend="kernel"),
                    "sharded": lambda p: han_forward_multilane(p, data, plan, mesh=mesh,
                                                               backend="kernel")}
        fwd, bwd = mg_mod.seg_gat_agg_multigraph_fwd, mg_mod.seg_gat_agg_multigraph_bwd
        got = {}
        for k, forward in forwards.items():
            with torch.no_grad():
                logits = forward(params)
            fwd.launches = bwd.launches = 0
            loss, _, grads = hgnn_loss_and_grads(forward, params, data, idx)
            torch.cuda.synchronize()
            got[k] = (logits, loss, grads, (fwd.launches, bwd.launches))
        per = plan.num_lanes // world
        units = [plan.units((r * per, (r + 1) * per)).count for r in range(world)]
        checks = {"logits_bitwise": torch.equal(got["one"][0], got["sharded"][0]),
                  "loss_bitwise": torch.equal(got["one"][1], got["sharded"][1]),
                  "launches_a_step": got["sharded"][3] == ((1, 1) if units[rank] else (0, 0))}
        rel, same = 0.0, True
        for name, g in got["sharded"][2].items():
            w = got["one"][2][name]
            rel = max(rel, float((g - w).abs().max()) / (float(w.abs().max()) or 1.0))
            first = g.clone(memory_format=torch.contiguous_format)  # NCCL takes contiguous
            dist.broadcast(first, src=0)
            same &= torch.equal(first, g)
        checks["grads_within_limit"] = rel <= LANE_GRAD_REL
        checks["grads_same_on_every_rank"] = bool(same)
        flags = torch.tensor([int(v) for v in checks.values()], device=dev)
        dist.all_reduce(flags, op=dist.ReduceOp.MIN)

        opt = AdamWConfig(lr=5e-3, weight_decay=0.0)
        step_fns = {k: make_hgnn_train_step(f, data, opt) for k, f in forwards.items()}
        states = {k: init_hgnn_train_state(HAN, torch.Generator().manual_seed(0), data, opt,
                                           **width) for k in step_fns}
        states, times = event_steps(step_fns, states, idx, 11)
        res = dict(card=card_line(), world=world, plan_lanes=plan.num_lanes,
                   units_per_rank=units,
                   checks=dict(zip(checks, (bool(v) for v in flags.tolist()))),
                   grad_rel_err=rel, launches_a_step=got["sharded"][3],
                   median_ms={k: float(np.median(t[1:])) for k, t in times.items()},
                   step_ms=times)
        if rank == 0:
            OUT.mkdir(exist_ok=True)
            (OUT / "lanes_sharded.json").write_text(json.dumps(res, indent=1))
            log(json.dumps(res))
        if not all(res["checks"].values()):
            raise AssertionError(f"rank {rank}: {res['checks']}")
        return res
    finally:
        dist.destroy_process_group()


# -- phase 4h: FUSED_FP at B = 128 (re-blocked to 32), the (1, 1) mesh --------------

B128_REL = 1e-4  # #4 against #2's composition: max |Δ| over each gradient's largest magnitude


def fused_calls_to_plain(name: str, run, first: int, ff_mod):
    """Runs ``run()`` with #3's first ``first`` launches recorded
    (:func:`recorded_launches`), then holds each against
    ``seg_gat_agg_fused_fp_plain`` on the same operands (the topology the
    kernel read: at B above 32 the re-blocked one) at atol=rtol=1e-4.  The
    recorded launches are the path's own.  Returns (run's result, the max
    abs error)."""
    result, calls = recorded_launches(f"{name}: #3", ff_mod, ("launch",), first, run)
    err = 0.0
    for n, (args, _) in enumerate(calls["launch"]):
        *ops, out, lse, slope, _ = args
        with torch.no_grad():  # out is the autograd Function's output, the weights its leaves
            want = ff_mod.seg_gat_agg_fused_fp_plain(*ops, leaky_slope=slope)
        err = max(err, compare(f"{name} #3 launch {n} at B={ops[4].shape[-1]}",
                               (out.detach(), lse), want))
    return result, err


def mesh_step_equals_multigraph(data, idx, counters) -> dict:
    """The (1, 1) mesh through the ``dist`` rules (a one-rank NCCL group,
    ``make_mesh``, ``param_shardings`` of ``hgnn_train_state_axes``,
    ``reshard_to``, ``han_forward_multilane(mesh=, placements=)`` and the
    placements-aware AdamW) for 3 steps, counters zeroed just before and
    read just after: bitwise today's MULTIGRAPH steps from the same state."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.checkpoint import reshard_to
    from repro_torch.core import NABackend
    from repro_torch.dist import make_rules, param_shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.hgnn import HAN, han_forward, han_forward_multilane
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import hgnn_train_state_axes, init_hgnn_train_state, make_hgnn_train_step
    from repro_torch.tree import tree_leaves_with_path

    opt = AdamWConfig(lr=5e-3, weight_decay=0.0)
    width = dict(TRAIN_WIDTH, att_dim=2 * TRAIN_WIDTH["hidden"])
    state0 = init_hgnn_train_state(HAN, torch.Generator().manual_seed(0), data, opt, **width)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", world_size=1,
                                rank=0)
        try:
            mesh = make_mesh((1, 1), ("lane", "model"))
            pl = param_shardings(mesh, make_rules(parallelism="lanes"),
                                 hgnn_train_state_axes(state0, opt))
            plan = data.plan()
            step_mesh = make_hgnn_train_step(
                lambda p: han_forward_multilane(p, data, plan, mesh=mesh, placements=pl.params,
                                                backend="kernel"),
                data, opt, placements=pl.params, mesh=mesh)
            step_mg = make_hgnn_train_step(
                lambda p: han_forward(p, data, backend=NABackend.MULTIGRAPH), data, opt)
            states = {"mesh": reshard_to(state0, mesh=mesh, placements=pl), "multigraph": state0}
            losses = {k: [] for k in states}
            launches = {}
            for k, fn in (("mesh", step_mesh), ("multigraph", step_mg)):
                for c in counters.values():
                    c.launches = 0
                for _ in range(3):
                    states[k], m = fn(states[k], {"idx": idx})
                    losses[k].append(m["loss"])
                torch.cuda.synchronize()
                launches[k] = {n: c.launches for n, c in counters.items()}
        finally:
            dist.destroy_process_group()
    same = all(ka == kb and torch.equal(va, vb) for (ka, va), (kb, vb) in
               zip(tree_leaves_with_path(states["mesh"]), tree_leaves_with_path(states["multigraph"])))
    same &= all(torch.equal(a, b) for a, b in zip(losses["mesh"], losses["multigraph"]))
    res = dict(bitwise=same, launches=launches, loss=[float(v) for v in losses["mesh"]])
    log(f"[mesh 1x1] 3 steps through the dist rules vs MULTIGRAPH: bitwise {same}; launches "
        f"{json.dumps(launches)}; loss {['%.6f' % v for v in res['loss']]}")
    if not same:
        raise AssertionError("the (1, 1) mesh's steps differ from MULTIGRAPH's")
    if launches["mesh"] != {"multigraph": 3, "multigraph_bwd": 3, "fused_fp": 0,
                            "fused_fp_bwd": 0}:
        raise AssertionError(f"the (1, 1) mesh's launches are not 1/1/0/0 a step: {launches}")
    return res


def fused_b128_phase(counters, mg_mod, ff_mod, fusion) -> dict:
    """Phase 4h: kernels #3 and #4 at B = 128 (re-blocked to 32 on the host)
    on the phase-4 problem at HAN's width, then FUSED_FP training at B = 128
    (the main path of #3/#4 at that block, counters zeroed just before),
    then the (1, 1) mesh through the ``dist`` rules."""
    from repro_torch.core import NABackend
    from repro_torch.launch import hgnn_train
    from repro_torch.models.hgnn import HAN, han_forward
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import hgnn_loss_and_grads, init_hgnn_train_state, make_hgnn_train_step

    res = {}
    width = dict(TRAIN_WIDTH, att_dim=2 * TRAIN_WIDTH["hidden"])
    _, data = hgnn_train.build_problem(device="cuda", **dict(TRAIN, block=128))
    params = HAN.init(torch.Generator().manual_seed(0), data, **width)
    idx = torch.arange(data.labels.shape[0], device=data.labels.device)

    # a. #3 and #4 at B = 128 on the problem's operands (exact, as in 4a): against
    # their plain versions, and against #1 and #2 on the MULTIGRAPH path's projection
    mg, ff = train_operands(data, params, fusion)
    ff = exact_fused(ff)
    ftop = ff_topology(ff)
    fidx = ftop.fused_index(ff["wsel"], ff["w"].shape[0])
    sub = dict(zip(("col_index", "graph_id", "dst_row", "masks"), fidx["units"]))
    log(f"[fused B=128] U={ff['col_index'].shape[0]} W={ff['col_index'].shape[1]} live slots "
        f"{int((ff['col_index'] >= 0).sum())} -> re-blocked to 32: U={sub['col_index'].shape[0]} "
        f"W={sub['col_index'].shape[1]} live slots {int((sub['col_index'] >= 0).sum())}, edges "
        f"{live_edges(ff['col_index'], ff['masks'])}")
    out_f, lse_f = ff_mod.seg_gat_agg_fused_fp_fwd(**ff, topology=ftop)
    again = ff_mod.seg_gat_agg_fused_fp_fwd(**ff, topology=ftop)
    torch.cuda.synchronize()
    if not (torch.equal(out_f, again[0]) and torch.equal(lse_f, again[1])):
        raise AssertionError("fused_fp B=128: two runs on the same inputs differ")
    err = compare("fused_fp B=128", (out_f, lse_f), ff_mod.seg_gat_agg_fused_fp_plain(**ff))
    h, ths, thd = multigraph_composition(mg_mod, mg, ff)
    mg = dict(mg, theta_src=ths, theta_dst=thd, h_src=h.contiguous())
    out_m, lse_m = mg_mod.seg_gat_agg_multigraph_fwd(**mg)
    err_mg = compare("fused_fp vs multigraph B=128", (out_f, lse_f), (out_m, lse_m))
    g = torch.randn(out_f.shape, generator=torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    err_bwd = check_bwd("fused_fp_bwd B=128", ff_mod.seg_gat_agg_fused_fp_bwd,
                        ff_mod.seg_gat_agg_fused_fp_bwd_plain, ff, out_f, lse_f, g)
    got = ff_mod.seg_gat_agg_fused_fp_bwd(**ff, out=out_f, lse=lse_f, g_out=g, need_dx=False,
                                          topology=ftop)[1:]
    leaves = [t.clone().requires_grad_() for t in (ff["w"][0], ff["b"][0], ff["a_src"],
                                                   ff["a_dst"], ff["edge_bias"])]
    H, Dh = ff["a_src"].shape[1:]
    hh = torch.addmm(leaves[1], ff["x"], leaves[0]).reshape(-1, H, Dh)
    out = mg_mod.seg_gat_agg_multigraph(
        mg["col_index"], mg["graph_id"], mg["dst_row"], mg["masks"],
        torch.einsum("nhd,ghd->gnh", hh, leaves[2]).contiguous(),
        torch.einsum("nhd,ghd->gnh", hh, leaves[3]).contiguous(), hh.contiguous(), leaves[4])
    want = torch.autograd.grad((out * g).sum(), leaves)
    scale = [float(w.abs().max()) or 1.0 for w in want]
    rel = max(float((a.reshape(w.shape) - w).abs().max()) / c for a, w, c in zip(got, want, scale))
    log(f"[check] fused_fp_bwd vs multigraph (#2 and autograd through x @ W + θ) B=128: max |d| "
        f"over each gradient's largest magnitude {rel:.3e} (limit {B128_REL}; d_w, d_b, d_a_src, "
        f"d_a_dst, d_edge_bias at scales {', '.join('%.3e' % c for c in scale)})")
    if rel > B128_REL:
        raise AssertionError(f"fused_fp_bwd B=128: {rel:.3e} of each gradient's scale from "
                             "the multigraph composition's")
    res["kernels"] = dict(fwd_max_abs_err=err, fwd_vs_multigraph_max_abs_err=err_mg,
                          bwd_max_abs_err=err_bwd, bwd_vs_multigraph_rel_err=rel,
                          units=int(ff["col_index"].shape[0]),
                          reblocked_units=int(sub["col_index"].shape[0]),
                          reblocked_width=int(sub["col_index"].shape[1]))

    # times at B = 128, straight on the launches over the re-blocked topology
    kops = dict(ff, **sub)
    o, lo = torch.empty_like(out_f), torch.empty_like(lse_f)
    delta_f = (g * out_f).sum(-1)
    idx_m = mg_index(mg_mod, mg)

    def composition_vjp():  # as phase 4a's: x @ W + b and θ, then #2
        hh, ths_, thd_ = multigraph_composition(mg_mod, mg, ff)
        mg_mod.launch_bwd(mg["col_index"], mg["graph_id"], mg["dst_row"], mg["masks"], ths_, thd_,
                          hh, mg["edge_bias"], g, lse_f, delta_f, idx_m, 0.2)

    t = {"fused_fp": (
        cuda_ms(lambda: ff_mod.launch(**kops, out=o, lse=lo, leaky_slope=0.2, index=fidx),
                reps=10),
        cuda_ms(lambda: ff_mod.seg_gat_agg_fused_fp_plain(**ff), reps=1),
        cuda_ms(lambda: multigraph_composition(mg_mod, mg, ff, o, lo), reps=10)),
        "fused_fp_bwd": (
        cuda_ms(lambda: ff_mod.launch_bwd(**kops, g_out=g, lse=lse_f, delta=delta_f,
                                          index=fidx, leaky_slope=0.2), reps=10),
        cuda_ms(lambda: ff_mod.seg_gat_agg_fused_fp_bwd_plain(**ff, out=out_f, lse=lse_f, g_out=g,
                                                               need_dx=False), reps=1),
        cuda_ms(composition_vjp, reps=10))}
    costs = {"fused_fp": fused_cost(ff), "fused_fp_bwd": fused_bwd_cost(ff)}
    for k, (ms, plain_ms, comp_ms) in t.items():
        nbytes, flops, _, proj = costs[k]
        res[k] = dict(ms=ms, plain_ms=plain_ms, multigraph_ms=comp_ms, bytes=nbytes, flops=flops,
                      **fused_bounds(nbytes, flops, proj["needed"]))
        log(f"[fused B=128 time] {k} kernel {ms:.4f} ms (re-blocked to 32), plain "
            f"{plain_ms:.4f} ms, MULTIGRAPH composition {comp_ms:.4f} ms, bound "
            f"{res[k]['bound_ms']:.4f} ms ({res[k]['bound_by']}; {nbytes:.4e} B, {flops:.4e} flops)")

    # b. the path: FUSED_FP training at B = 128, counters zeroed just before, read
    # just after, every #3 launch of the first step held against its plain version
    opt = AdamWConfig(lr=5e-3, weight_decay=0.0)
    state0 = init_hgnn_train_state(HAN, torch.Generator().manual_seed(0), data, opt, **width)
    step_ff = make_hgnn_train_step(lambda p: han_forward(p, data, backend=NABackend.FUSED_FP),
                                   data, opt)
    for fn in counters.values():
        fn.launches = 0

    def three_steps():
        st, hist = state0, []
        for _ in range(3):
            st, m = step_ff(st, {"idx": idx})
            hist.append(float(m["loss"]))
        torch.cuda.synchronize()
        return hist

    hist, call_err = fused_calls_to_plain("FUSED_FP B=128 training", three_steps, 1, ff_mod)
    launches = {k: fn.launches for k, fn in counters.items()}
    res["run"] = dict(launches=launches, loss=hist, call_max_abs_err=call_err)
    log(f"[train fused_fp B=128] launches={json.dumps(launches)} loss "
        f"{['%.6f' % v for v in hist]}")
    if launches != {"multigraph": 0, "multigraph_bwd": 0, "fused_fp": 3, "fused_fp_bwd": 3}:
        raise AssertionError(f"FUSED_FP at B=128: launches are not 0/0/3/3 over 3 steps: {launches}")
    if not hist[-1] < hist[0] or not all(math.isfinite(v) for v in hist):
        raise AssertionError(f"FUSED_FP at B=128: the loss did not fall: {hist}")

    # the first step's logits and gradients against MULTIGRAPH's at B = 128
    with torch.no_grad():
        logits = {nab: han_forward(params, data, backend=nab)
                  for nab in (NABackend.FUSED_FP, NABackend.MULTIGRAPH)}
    res["logits_max_abs_err"] = compare("HAN logits FUSED_FP vs MULTIGRAPH at B=128",
                                        (logits[NABackend.FUSED_FP],),
                                        (logits[NABackend.MULTIGRAPH],))
    grads = {nab: hgnn_loss_and_grads(lambda p, nab=nab: han_forward(p, data, backend=nab),
                                      params, data, idx)
             for nab in (NABackend.FUSED_FP, NABackend.MULTIGRAPH)}
    rels = {}
    for k, gf in grads[NABackend.FUSED_FP][2].items():
        gm = grads[NABackend.MULTIGRAPH][2][k]
        torch.testing.assert_close(gf, gm, **FUSED_GRAD_TOL, msg=lambda m: f"grad {k}: {m}")
        rels[k] = float((gf - gm).abs().max()) / (float(gm.abs().max()) or 1.0)
    worst = max(rels[k] for k in FUSED_LEAVES)
    res["grad_rel_err"] = rels
    log(f"[check] first-step gradients FUSED_FP vs MULTIGRAPH at B=128 ({FUSED_GRAD_TOL}); over "
        f"each leaf's largest magnitude {', '.join(f'{k} {v:.3e}' for k, v in rels.items())} "
        f"(limit {FUSED_GRAD_REL} on {', '.join(FUSED_LEAVES)})")
    if worst > FUSED_GRAD_REL:
        raise AssertionError(f"FUSED_FP at B=128: #4's gradients {worst:.3e} of their scale "
                             "from MULTIGRAPH's")

    # c. the (1, 1) mesh through the dist rules, bitwise today's MULTIGRAPH step
    res["mesh_1x1"] = mesh_step_equals_multigraph(data, idx, counters)
    return res


def fused_b128_alone() -> dict:
    """Phase 4h alone: builds the kernels, runs the phase on the phase-4
    problem at B = 128 and writes fused_b128.json to the output directory."""
    from repro_torch.core import fusion
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    OUT.mkdir(exist_ok=True)
    log(card_line())
    build.build()
    mg_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg_multigraph")
    ff_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg_fused_fp")
    counters = {"multigraph": mg_mod.seg_gat_agg_multigraph_fwd,
                "multigraph_bwd": mg_mod.seg_gat_agg_multigraph_bwd,
                "fused_fp": ff_mod.seg_gat_agg_fused_fp_fwd,
                "fused_fp_bwd": ff_mod.seg_gat_agg_fused_fp_bwd}
    res = fused_b128_phase(counters, mg_mod, ff_mod, fusion)
    (OUT / "fused_b128.json").write_text(json.dumps(res, indent=1, default=str))
    log(card_line())
    return res


MODEL_MESHES = ((1, 4), (2, 2), (4, 1))  # (lanes, model) over four cards
MODEL_REL = 1e-5  # sharded vs one card: max |Δ| over each leaf's (logits', loss's) largest magnitude
# A gradient that nearly cancels (b_g's: the semantic softmax's cotangent sums to
# zero over the graphs) moves by far more than MODEL_REL of its own magnitude when
# the column-split FP GEMM moves the forward's last bits.  Such a leaf is held
# against a float64 run instead: the sharded gradient no farther from it than
# FLOAT64_FACTOR times one card's float32 gradient is.
FLOAT64_FACTOR = 2.0


def model_sharded(models: tuple[str, ...] = ("HAN", "R-GAT")) -> dict:
    """The model mesh axis over four cards, run apart, one process a card:

        torchrun --nproc-per-node 4 --no-python python3 -c 'import chip_smoke as c; c.model_sharded()'

    HAN at its own width on the phase-4 problem at B = 128, a 16-lane plan,
    over (lanes, model) meshes of (1, 4), (2, 2) and (4, 1) on NCCL, each
    rank holding its slices of the params by the ``lanes`` rules
    (``param_shardings``): on the kernel and fused_fp backends the sharded
    logits, loss and gathered gradients within ``MODEL_REL`` of each one's
    largest magnitude of the one-card run's (a gradient beyond it, one that
    nearly cancels, no farther from a float64 SEGMENT run's than
    ``FLOAT64_FACTOR`` times one card's), bitwise equal across the ranks
    of each model group and on a second run, #1/#2 (#3/#4) launched once a
    step where the rank's lanes hold units; the sharded train step (the
    placements-aware AdamW) and the one-card step timed with CUDA events in
    turns, then 3 sharded steps under the profiler (rank 0's busy and idle
    share, top kernels); then R-GAT on the same meshes
    (:func:`rgat_model_sharded`); then ``run_training`` at (2, 2) for 3 steps
    with a checkpoint, resumed for a 4th on every rank from the writer's
    step.  ``models`` picks HAN's part, R-GAT's or both (the default), e.g.
    ``c.model_sharded(models=("R-GAT",))``.  Rank 0 prints the results and
    writes model_sharded.json to the output directory."""
    import os

    import torch.distributed as dist

    from repro_torch.checkpoint import reshard_to
    from repro_torch.core import NABackend, build_multilane_plan
    from repro_torch.dist import gather_leaf, local_slice, make_rules, param_shardings
    from repro_torch.launch import hgnn_train
    from repro_torch.launch.mesh import make_lane_mesh
    from repro_torch.models.hgnn import HAN, han_forward, han_forward_multilane
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (
        hgnn_loss_and_grads,
        hgnn_param_axes,
        hgnn_train_state_axes,
        init_hgnn_train_state,
        make_hgnn_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl")
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        dev = torch.device("cuda", torch.cuda.current_device())
        mg_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg_multigraph")
        ff_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg_fused_fp")
        counters = {"kernel": (mg_mod.seg_gat_agg_multigraph_fwd,
                               mg_mod.seg_gat_agg_multigraph_bwd),
                    "fused_fp": (ff_mod.seg_gat_agg_fused_fp_fwd, ff_mod.seg_gat_agg_fused_fp_bwd)}
        width = dict(TRAIN_WIDTH, att_dim=2 * TRAIN_WIDTH["hidden"])
        _, data = hgnn_train.build_problem(device=dev, **dict(TRAIN, block=128))
        params = HAN.init(torch.Generator().manual_seed(0), data, **width)
        plan = build_multilane_plan(data.graphs, 16)
        idx = torch.arange(data.labels.shape[0], device=dev)
        opt = AdamWConfig(lr=5e-3, weight_decay=0.0)
        # float64 gradients (SEGMENT, the plain per-edge softmax) for the leaves that cancel
        d64 = dataclasses.replace(data, features={k: v.double() for k, v in data.features.items()})
        p64 = {k: v.double().requires_grad_() for k, v in params.items()}
        loss64 = torch.nn.functional.cross_entropy(
            han_forward(p64, d64, backend=NABackend.SEGMENT), data.labels)
        g64 = dict(zip(p64, torch.autograd.grad(loss64, list(p64.values()))))
        del d64, p64

        def off64(grads):  # max |g - g64| over g64's largest magnitude, a leaf
            return {k: float((g.double() - g64[k]).abs().max() / g64[k].abs().max())
                    for k, g in grads.items()}

        one = {}
        for backend in counters:
            fwd = lambda p, b=backend: han_forward_multilane(p, data, plan, backend=b)  # noqa: E731
            with torch.no_grad():
                logits = fwd(params)
            one[backend] = (logits, *hgnn_loss_and_grads(fwd, params, data, idx)[::2])
        rules = make_rules(parallelism="lanes")
        res = dict(card=card_line(), world=world, plan_lanes=plan.num_lanes, meshes={})
        ok = True
        for lanes, model in MODEL_MESHES if "HAN" in models else ():
            mesh = make_lane_mesh(lanes, model)
            name = f"{lanes}x{model}"
            pl = param_shardings(mesh, rules, hgnn_param_axes(params))
            local = {k: local_slice(v, pl[k], mesh) for k, v in params.items()}
            per = plan.num_lanes // lanes
            lane = mesh.get_local_rank("lane")
            has_units = plan.units((lane * per, (lane + 1) * per)).count > 0
            model_group = mesh.get_group("model")
            cell = dict(local_shapes={k: list(v.shape) for k, v in local.items()})
            for backend, (fwd_fn, bwd_fn) in counters.items():
                fwd = lambda p, b=backend: han_forward_multilane(  # noqa: E731
                    p, data, plan, mesh=mesh, placements=pl, backend=b)
                runs = []
                for _ in range(2):
                    with torch.no_grad():
                        logits = fwd(local)
                    fwd_fn.launches = bwd_fn.launches = 0
                    loss, _, grads = hgnn_loss_and_grads(fwd, local, data, idx)
                    torch.cuda.synchronize()
                    launches = (fwd_fn.launches, bwd_fn.launches)
                    whole = {k: gather_leaf(g, pl[k], mesh) for k, g in grads.items()}
                    runs.append((logits, loss, whole, grads, launches))
                logits, loss, whole, grads, launches = runs[0]
                w_logits, w_loss, w_grads = one[backend]
                rel = {"logits": float((logits - w_logits).abs().max() / w_logits.abs().max()),
                       "loss": float((loss - w_loss).abs() / w_loss.abs())}
                grel = {k: float((g - w_grads[k]).abs().max())
                        / (float(w_grads[k].abs().max()) or 1.0) for k, g in whole.items()}
                rel.update(grel)
                e_one, e_sharded = off64(w_grads), off64(whole)
                held = all(v <= MODEL_REL or e_sharded[k] <= FLOAT64_FACTOR * e_one[k]
                           for k, v in grel.items())
                same = True  # each model group's rank 0 against the others, bit for bit
                for t in (logits, loss, *whole.values()):
                    first = t.clone(memory_format=torch.contiguous_format)
                    dist.broadcast(first, src=dist.get_global_rank(model_group, 0),
                                   group=model_group)
                    same &= torch.equal(first, t)
                again = runs[1]
                repeat = (torch.equal(again[0], logits) and torch.equal(again[1], loss)
                          and all(torch.equal(again[2][k], g) for k, g in whole.items()))
                checks = {"within_limit": max(rel["logits"], rel["loss"]) <= MODEL_REL and held,
                          "model_group_bitwise": bool(same), "repeat_bitwise": bool(repeat),
                          "launches_a_step": launches == ((1, 1) if has_units else (0, 0))}
                cell[backend] = dict(rel_err=rel, launches_a_step=launches, checks=checks,
                                     off_float64={"one": e_one, "sharded": e_sharded})
            # the train step through the placements-aware AdamW, and the one-card step
            state = init_hgnn_train_state(HAN, torch.Generator().manual_seed(0), data, opt,
                                          **width)
            spl = param_shardings(mesh, rules, hgnn_train_state_axes(state, opt))
            step_fns = {
                "one": make_hgnn_train_step(
                    lambda p: han_forward_multilane(p, data, plan, backend="kernel"), data, opt),
                "sharded": make_hgnn_train_step(
                    lambda p, m=mesh, s=spl: han_forward_multilane(
                        p, data, plan, mesh=m, placements=s.params, backend="kernel"),
                    data, opt, placements=spl.params, mesh=mesh)}
            states = {"one": state, "sharded": reshard_to(state, mesh=mesh, placements=spl)}
            states, times = event_steps(step_fns, states, idx, 11)
            cell["median_ms"] = {k: float(np.median(t[1:])) for k, t in times.items()}
            cell["step_ms"] = times
            _, cell["steady"] = profiled_steps(step_fns["sharded"], states["sharded"], idx, 3)
            flags = torch.tensor([int(v) for b in counters for v in cell[b]["checks"].values()],
                                 device=dev)
            dist.all_reduce(flags, op=dist.ReduceOp.MIN)
            cell["all_ranks_ok"] = bool(flags.min())
            ok &= cell["all_ranks_ok"]
            res["meshes"][name] = cell
            if rank == 0:
                log(f"[model_sharded {name}] " + json.dumps(
                    {k: cell[k] for k in ("all_ranks_ok", "median_ms")}
                    | {b: cell[b] for b in counters}))
                st = cell["steady"]
                log(f"[model_sharded {name}] profiled sharded steps "
                    f"{['%.3f' % t for t in st['steps_ms']]}, busy {st['device_busy_ms']:.3f} of "
                    f"{st['device_wall_ms']:.3f} ms, idle share {st['device_idle_share']:.4f}")
                for k in st["top_kernels"]:
                    log(f"[model_sharded {name}]   {k['device_ms']:9.3f} ms x{k['calls']:<4d} "
                        f"{k['name']}")

        if "R-GAT" in models:
            res["rgat"], rgat_ok = rgat_model_sharded(dev, rank)
            ok &= rgat_ok
        if "HAN" in models:
            ok &= han_run_2x2(res, rank, dev)
        if rank == 0:
            OUT.mkdir(exist_ok=True)
            (OUT / "model_sharded.json").write_text(json.dumps(res, indent=1, default=str))
            log(res["card"])
        if not ok:
            raise AssertionError(f"rank {rank}: the model axis failed a check (see "
                                 f"{OUT / 'model_sharded.json'})")
        return res
    finally:
        dist.destroy_process_group()


def han_run_2x2(res: dict, rank: int, dev) -> bool:
    """The launcher at (2, 2) inside :func:`model_sharded`: HAN for 3 steps
    with a checkpoint, then a 4th resumed from it on every rank."""
    import torch.distributed as dist

    from repro_torch.launch import hgnn_train

    ckpt = str(OUT / "model_sharded_ckpt")
    if rank == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    dist.barrier()
    run = dict(lanes=2, model_split=2, plan_lanes=16, ckpt_dir=ckpt, ckpt_every=3,
               log_every=1, log=log if rank == 0 else (lambda *_: None), device="cuda",
               **dict(TRAIN, block=128), **TRAIN_WIDTH)
    _, hist, meta = hgnn_train.run_training(model_name="HAN", steps=3, **run)
    _, resumed, _ = hgnn_train.run_training(model_name="HAN", steps=4, **run)
    res["run_2x2"] = dict(loss=[h["loss"] for h in hist],
                          resumed=[(h["step"], h["loss"]) for h in resumed],
                          steps_ms=[h["sec"] * 1e3 for h in hist], meta=meta)
    run_ok = (hist[-1]["loss"] < hist[0]["loss"] and [s for s, _ in res["run_2x2"]["resumed"]]
              == [3] and resumed[0]["loss"] < hist[-1]["loss"])
    flag = torch.tensor([int(run_ok)], device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    res["run_2x2"]["all_ranks_ok"] = bool(flag.item())
    if rank == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
        log(f"[model_sharded run 2x2] {json.dumps(res['run_2x2'], default=str)}")
    return res["run_2x2"]["all_ranks_ok"]


def rgat_model_sharded(dev, rank: int) -> tuple[dict, bool]:
    """R-GAT on the model axis, inside :func:`model_sharded`: the launcher's
    R-GAT (layers=2, MULTIGRAPH per relation and layer) at R-GAT's width
    (4 x 64) on the phase-4 problem, over the (lanes, model) meshes of
    ``MODEL_MESHES``, each rank holding its columns of every relation's
    ``w_src``/``w_dst`` and its rows of ``w_out``: the sharded logits, loss
    and gathered gradients within ``MODEL_REL`` of each one's largest
    magnitude of the one-card run's (a gradient beyond it, one that nearly
    cancels, no farther from a float64 BLOCK run's than ``FLOAT64_FACTOR``
    times one card's), bitwise equal across the ranks of each model group
    and on a second run; #1/#2 launched 6 times a step (one a relation and
    layer); the sharded train step and the one-card step timed with CUDA
    events in turns; ``run_training(model_name="R-GAT")`` at the mesh for 3
    steps, the loss falling.  Returns (results, every rank's checks held)."""
    import torch.distributed as dist

    from repro_torch.checkpoint import reshard_to
    from repro_torch.core import NABackend
    from repro_torch.dist import gather_leaf, local_slice, make_rules, map_placements
    from repro_torch.dist import param_shardings
    from repro_torch.launch import hgnn_train
    from repro_torch.launch.mesh import make_lane_mesh
    from repro_torch.models.hgnn import RGAT
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (
        hgnn_loss_and_grads,
        hgnn_param_axes,
        hgnn_train_state_axes,
        init_hgnn_train_state,
        make_hgnn_train_step,
    )
    from repro_torch.tree import tree_leaves_with_path, tree_map

    mg_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg_multigraph")
    fwd_fn, bwd_fn = mg_mod.seg_gat_agg_multigraph_fwd, mg_mod.seg_gat_agg_multigraph_bwd
    _, data = hgnn_train.build_problem(device=dev, **TRAIN)
    params = RGAT.init(torch.Generator().manual_seed(0), data, layers=2, **RGAT_TRAIN)
    idx = torch.arange(data.labels.shape[0], device=dev)
    opt = AdamWConfig(lr=5e-3, weight_decay=0.0)
    n_rel = 2 * len(data.graphs)  # #1/#2 launches a step: one a relation and layer

    def forward(p, **kw):
        return RGAT.forward(p, data, backend=NABackend.MULTIGRAPH, **kw)

    def leaves(tree):
        return dict(tree_leaves_with_path(tree))

    # float64 gradients (BLOCK, plain autograd) for the leaves that nearly cancel
    d64 = dataclasses.replace(data, features={k: v.double() for k, v in data.features.items()})
    p64 = tree_map(lambda t: t.double(), params)
    _, _, g64 = hgnn_loss_and_grads(lambda p: RGAT.forward(p, d64, backend=NABackend.BLOCK),
                                    p64, d64, idx)
    g64 = leaves(g64)
    del d64, p64
    with torch.no_grad():
        w_logits = forward(params)
    w_loss, _, w_grads = hgnn_loss_and_grads(forward, params, data, idx)
    w_grads = leaves(w_grads)
    rules = make_rules(parallelism="lanes")
    out, ok = dict(width=dict(layers=2, **RGAT_TRAIN), relations=len(data.graphs)), True
    for lanes, model in MODEL_MESHES:
        mesh = make_lane_mesh(lanes, model, device_type=dev.type)
        name = f"{lanes}x{model}"
        pl = param_shardings(mesh, rules, hgnn_param_axes(params))
        local = map_placements(lambda p, x: local_slice(x, p, mesh), pl, params)

        def sharded(p, m=mesh, s=pl):
            return forward(p, mesh=m, placements=s)

        runs = []
        for _ in range(2):
            with torch.no_grad():
                logits = sharded(local)
            fwd_fn.launches = bwd_fn.launches = 0
            loss, _, grads = hgnn_loss_and_grads(sharded, local, data, idx)
            torch.cuda.synchronize()
            launches = (fwd_fn.launches, bwd_fn.launches)
            whole = leaves(map_placements(lambda p, g: gather_leaf(g, p, mesh), pl, grads))
            runs.append((logits, loss, whole, launches))
        logits, loss, whole, launches = runs[0]
        rel = {"logits": float((logits - w_logits).abs().max() / w_logits.abs().max()),
               "loss": float((loss - w_loss).abs() / w_loss.abs())}
        grel = {k: float((g - w_grads[k]).abs().max()) / (float(w_grads[k].abs().max()) or 1.0)
                for k, g in whole.items()}
        off64 = {k: (float((w_grads[k].double() - g64[k]).abs().max()),
                     float((g.double() - g64[k]).abs().max())) for k, g in whole.items()}
        held = all(v <= MODEL_REL or off64[k][1] <= FLOAT64_FACTOR * off64[k][0]
                   for k, v in grel.items())
        model_group = mesh.get_group("model")
        same = True  # each model group's rank 0 against the others, bit for bit
        for t in (logits, loss, *whole.values()):
            first = t.clone(memory_format=torch.contiguous_format)
            dist.broadcast(first, src=dist.get_global_rank(model_group, 0), group=model_group)
            same &= torch.equal(first, t)
        again = runs[1]
        repeat = (torch.equal(again[0], logits) and torch.equal(again[1], loss)
                  and all(torch.equal(again[2][k], g) for k, g in whole.items()))
        checks = {"within_limit": max(rel["logits"], rel["loss"]) <= MODEL_REL and held,
                  "model_group_bitwise": bool(same), "repeat_bitwise": bool(repeat),
                  "launches_a_step": launches == (n_rel, n_rel)}
        cell = dict(rel_err=rel | grel, off_float64=off64, launches_a_step=launches,
                    checks=checks)
        # the train step through the placements-aware AdamW, and the one-card step
        state = init_hgnn_train_state(RGAT, torch.Generator().manual_seed(0), data, opt,
                                      layers=2, **RGAT_TRAIN)
        spl = param_shardings(mesh, rules, hgnn_train_state_axes(state, opt))
        step_fns = {"one": make_hgnn_train_step(forward, data, opt),
                    "sharded": make_hgnn_train_step(
                        lambda p, m=mesh, s=spl: forward(p, mesh=m, placements=s.params),
                        data, opt, placements=spl.params, mesh=mesh)}
        states = {"one": state, "sharded": reshard_to(state, mesh=mesh, placements=spl)}
        states, times = event_steps(step_fns, states, idx, 11)
        cell["median_ms"] = {k: float(np.median(t[1:])) for k, t in times.items()}
        cell["step_ms"] = times
        del states
        # the launcher's function at this mesh
        _, hist, meta = hgnn_train.run_training(
            model_name="R-GAT", steps=3, lanes=lanes, model_split=model, log=lambda *_: None,
            device=dev.type, **TRAIN, **RGAT_TRAIN)
        cell["run_training"] = dict(loss=[h["loss"] for h in hist], meta=meta)
        checks["run_training_loss_falls"] = hist[-1]["loss"] < hist[0]["loss"]
        flags = torch.tensor([int(v) for v in checks.values()], device=dev)
        dist.all_reduce(flags, op=dist.ReduceOp.MIN)
        cell["all_ranks_ok"] = bool(flags.min())
        ok &= cell["all_ranks_ok"]
        out[name] = cell
        if rank == 0:
            worst = max(grel, key=grel.get)
            log(f"[model_sharded R-GAT {name}] all_ranks_ok={cell['all_ranks_ok']} "
                f"checks={json.dumps(checks)} launches a step {launches}; rel err logits "
                f"{rel['logits']:.3e}, loss {rel['loss']:.3e}, largest leaf {worst} "
                f"{grel[worst]:.3e}; step ms median one card {cell['median_ms']['one']:.3f}, "
                f"sharded {cell['median_ms']['sharded']:.3f}; run_training loss "
                f"{['%.6f' % v for v in cell['run_training']['loss']]}")
    return out, ok


# -- phase 5: the per-graph models, kernels #5 and #6 --------------------------------

RELATION = dict(dataset="imdb", block=16)  # full IMDB (the graph of phase 3), its six relations
MODEL_WIDTHS = {  # the init_* defaults of the JAX package, the widths benchmarks/breakdown.py runs
    "R-GAT": dict(hidden=64, heads=4, layers=3),
    "S-HGN": dict(hidden=64, heads=4, layers=2, edge_dim=64),
    "R-GCN": dict(hidden=64, layers=3),
}
RGAT_TRAIN = dict(hidden=64, heads=4)  # the launcher's R-GAT (layers=2) at R-GAT's own width


def relation_passes(name: str, data, layers: int) -> int:
    """The (relation, layer) passes a forward of model ``name`` runs on
    ``data``: R-GAT's live ones (``live_relations``: those whose output
    reaches the logits), every one for S-HGN."""
    from repro_torch.models.hgnn import live_relations

    if name != "R-GAT":
        return layers * len(data.graphs)
    return sum(len(live) for live, _ in live_relations(data.graphs, data.target_type, layers))


def relation_data(graph, device):
    from repro_torch.graphs import relation_semantic_graphs, synthetic_labels
    from repro_torch.models.hgnn import prepare_data

    return prepare_data(graph, relation_semantic_graphs(graph), "movie", 3,
                        synthetic_labels(graph, "imdb", seed=0), block=RELATION["block"],
                        device=device)


def kernel5_operands(data, params, fusion) -> list[dict]:
    """The operands layer 0 of R-GAT hands kernel #5, one dict per relation
    graph (its own weights), with a nonzero per-head edge bias as S-HGN's
    relations carry."""
    lp = params["layers"][0]
    heads = lp["rel"]["g0"]["a_src"].shape[0]
    gen = torch.Generator(device=data.labels.device).manual_seed(5)
    ops = []
    for i, b in enumerate(data.graphs):
        rp = lp["rel"][f"g{i}"]
        hs = (data.features[b.src_type] @ rp["w_src"]).reshape(b.num_src, heads, -1)
        hd = (data.features[b.dst_type] @ rp["w_dst"]).reshape(b.num_dst, heads, -1)
        ns_pad = -(-b.num_src // b.block) * b.block
        pad = fusion._pad_rows
        ops.append(dict(
            col_index=b.col_index, masks=b.masks,
            theta_src=pad(torch.einsum("nhd,hd->nh", hs, rp["a_src"]), ns_pad).contiguous(),
            theta_dst=pad(torch.einsum("nhd,hd->nh", hd, rp["a_dst"]), b.num_dst_pad).contiguous(),
            h_src=pad(hs, ns_pad).contiguous(),
            edge_bias=torch.randn(heads, generator=gen, device=hs.device)))
    return ops


def kernel5_edge(seed, dev, *, B=16, R=12, W=5, H=4, Dh=64, nblk_src=8):
    """Random single-graph operands with an all-padding row and fully
    masked dst rows (the first row of block row 1, every row of block 2's
    first slot)."""
    rng = np.random.default_rng(seed)
    col = np.full((R, W), -1, np.int32)
    for r in range(R):
        k = rng.integers(1, min(W, nblk_src) + 1)
        col[r, :k] = rng.choice(nblk_src, size=k, replace=False)
    col[0] = -1
    masks = rng.random((R, W, B, B)) < 0.3
    masks[1, :, 0, :] = False
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    ns = nblk_src * B
    return dict(col_index=t(col), masks=t(masks),
                theta_src=t(rng.standard_normal((ns, H)).astype(np.float32)),
                theta_dst=t(rng.standard_normal((R * B, H)).astype(np.float32)),
                h_src=t(rng.standard_normal((ns, H, Dh)).astype(np.float32)),
                edge_bias=t(rng.standard_normal(H).astype(np.float32)))


def kernel5_cost(ops_list):
    """(bytes, flops) kernel #5 needs on these graphs together: each input
    read once (masks of live slots only), each output written once; per
    edge and head 2·Dh for p @ h and ~8 ops for its logit (#1's count at
    G = 1)."""
    nbytes = flops = live_total = 0
    for ops in ops_list:
        col, masks, h = ops["col_index"], ops["masks"], ops["h_src"]
        R, W = col.shape
        B, (_, H, Dh) = masks.shape[-1], h.shape
        live = int((col >= 0).sum())
        live_total += live
        nbytes += (col.numel() * 4 + live * B * B
                   + 4 * (ops["theta_src"].numel() + ops["theta_dst"].numel() + h.numel() + H)
                   + 4 * R * B * H * Dh)
        flops += live_edges(col, masks) * H * (2 * Dh + 8)
    return nbytes, flops, live_total


def kernel5_phase(data, params, fusion, k5_mod, mg_mod) -> dict:
    """#5 against its plain version on every relation graph of full IMDB at
    R-GAT's width (H·Dh = 256) and on the edge cases (B = 8 to 128, a Dh
    that is not a multiple of 4); twice bitwise equal; equal to #1 at
    G = 1 bit for bit; visiting exactly the live edges (its own count);
    timed with CUDA events beside its bound, one R-GAT layer and each
    graph."""
    dev = data.labels.device
    ops_list = kernel5_operands(data, params, fusion)
    cases = [(f"{b.name} R={b.col_index.shape[0]} W={b.col_index.shape[1]} "
              f"Ns_pad={ops['theta_src'].shape[0]} Nd_pad={ops['theta_dst'].shape[0]}", ops)
             for b, ops in zip(data.graphs, ops_list)]
    cases += [("edge B=16 (padding row, masked rows)", kernel5_edge(1, dev)),
              ("edge W=1", kernel5_edge(2, dev, W=1)),
              ("edge B=8 H=2 Dh=8", kernel5_edge(3, dev, B=8, H=2, Dh=8)),
              ("edge B=32 Dh=32", kernel5_edge(4, dev, B=32, Dh=32)),
              ("edge Ns_pad < Nd_pad", kernel5_edge(5, dev, R=20, nblk_src=3)),
              ("edge Ns_pad > Nd_pad", kernel5_edge(6, dev, R=2, W=8, nblk_src=40)),
              ("edge B=64", kernel5_edge(7, dev, B=64, R=6, W=4, nblk_src=8)),
              ("edge B=128", kernel5_edge(8, dev, B=128, R=4, W=3, nblk_src=6)),
              ("edge H=4 Dh=15 (single-float lane groups)", kernel5_edge(9, dev, Dh=15))]
    err = 0.0
    visits = torch.zeros(1, dtype=torch.int32, device=dev)
    visited = {}
    for name, ops in cases:
        got = torch.empty((ops["theta_dst"].shape[0], *ops["h_src"].shape[1:]), device=dev)
        visits.zero_()
        k5_mod.launch(ops["col_index"], ops["masks"], ops["theta_src"], ops["theta_dst"],
                      ops["h_src"], ops["edge_bias"], got, 0.2, visits=visits)
        again = k5_mod.seg_gat_agg(**ops)
        want = k5_mod.seg_gat_agg_plain(**ops)
        R = ops["col_index"].shape[0]
        mg, _ = mg_mod.seg_gat_agg_multigraph_fwd(
            ops["col_index"], torch.zeros(R, dtype=torch.int32, device=dev),
            torch.arange(R, dtype=torch.int32, device=dev), ops["masks"], ops["theta_src"][None],
            ops["theta_dst"][None], ops["h_src"], ops["edge_bias"][None].contiguous())
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"seg_gat_agg {name}: two runs on the same inputs differ")
        err = max(err, compare(f"seg_gat_agg {name}", (got,), (want,)))
        if not torch.equal(got, mg):
            raise AssertionError(f"seg_gat_agg {name}: #5 and #1 at G = 1 differ by up to "
                                 f"{float((got - mg).abs().max()):.3e}")
        B = ops["masks"].shape[-1]
        dead = (ops["col_index"] < 0).all(dim=1).repeat_interleave(B)
        if not (got[dead] == 0).all():
            raise AssertionError(f"seg_gat_agg {name}: an all-padding row is not exact zeros")
        edges = live_edges(ops["col_index"], ops["masks"])
        visited[name] = (int(visits), edges)
        log(f"[check] seg_gat_agg {name}: visited {int(visits)} entries for {edges} live edges")
        if int(visits) != edges:
            raise AssertionError(f"seg_gat_agg {name}: visited {int(visits)} entries, the case "
                                 f"has {edges} live edges")
    log("[check] seg_gat_agg: every case twice bitwise equal, equal to #1 at G = 1 bit for bit, "
        "visiting exactly the live edges")

    outs = [torch.empty((o["theta_dst"].shape[0], *o["h_src"].shape[1:]), device=dev)
            for o in ops_list]

    def one(o, out):  # one launch, straight on the kernel
        k5_mod.launch(o["col_index"], o["masks"], o["theta_src"], o["theta_dst"], o["h_src"],
                      o["edge_bias"], out, 0.2)

    ms = cuda_ms(lambda: [one(o, out) for o, out in zip(ops_list, outs)], reps=20)
    per_graph = {}
    for (name, _), b, o, out in zip(cases, data.graphs, ops_list, outs):
        col = o["col_index"]
        per_graph[b.name] = dict(
            ms=cuda_ms(lambda: one(o, out), reps=20), rows=int(col.shape[0]),
            live=int((col >= 0).sum()), max_live_per_row=int((col >= 0).sum(dim=1).max()),
            edges=visited[name][1], visited=visited[name][0])
        log(f"[time] seg_gat_agg {b.name}: {per_graph[b.name]['ms']:.4f} ms, rows "
            f"{per_graph[b.name]['rows']}, live (row, slot) pairs {per_graph[b.name]['live']}, "
            f"most live slots in one row {per_graph[b.name]['max_live_per_row']}, edges "
            f"{per_graph[b.name]['edges']}")
    plain_ms = cuda_ms(lambda: [k5_mod.seg_gat_agg_plain(**o) for o in ops_list], reps=3)
    nbytes, flops, live = kernel5_cost(ops_list)
    bound, by = bound_ms(nbytes, flops)
    n_visited = sum(g["visited"] for g in per_graph.values())
    n_edges = sum(g["edges"] for g in per_graph.values())
    log(f"[time] seg_gat_agg, the six relations of one layer: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}; {nbytes:.4e} B, {flops:.4e} flops); "
        f"live (row, slot) pairs {live}, edges {n_edges}, visited {n_visited / n_edges:.4f} an edge")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops,
                live_pairs=live, edges=n_edges, visited_per_edge=n_visited / n_edges,
                per_graph=per_graph)


def kernel5_alone() -> dict:
    """Phase 5a on its own (``python3 -c 'import chip_smoke as c;
    c.kernel5_alone()'``): builds #5 and #1 (its G = 1 twin), writes their
    ptxas reports, runs the phase on full IMDB and writes kernel5.json to
    the output directory."""
    from repro_torch.core import fusion
    from repro_torch.graphs import synthetic_hetgraph
    from repro_torch.kernels import build
    from repro_torch.models.hgnn import MODELS

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    log(card_line())
    OUT.mkdir(exist_ok=True)
    check_ptxas(build.build(("seg_gat_agg", "seg_gat_agg_multigraph")))
    graph = synthetic_hetgraph("imdb", scale=1.0, feat_scale=1.0, seed=0)
    rdata = relation_data(graph, "cuda")
    rgat0 = MODELS["R-GAT"].init(torch.Generator().manual_seed(0), rdata, **MODEL_WIDTHS["R-GAT"])
    res = kernel5_phase(rdata, rgat0, fusion,
                        importlib.import_module("repro_torch.kernels.seg_gat_agg"),
                        importlib.import_module("repro_torch.kernels.seg_gat_agg_multigraph"))
    res["card"] = card_line()
    (OUT / "kernel5.json").write_text(json.dumps(res, indent=1, default=str))
    log(res["card"])
    return res


def kernel6_cases(data, params) -> list[tuple[str, tuple]]:
    """(name, (x, w, b, a_src, a_dst)) for kernel #6: each distinct layer-0
    projection R-GAT makes on full IMDB's relations (the vertex type's own
    features and the first relation weight that projects them), the layer-1
    shape, the actor case in bfloat16 and a ragged odd shape; a nonzero
    bias (the models pass zeros) so that the bias path is checked too."""
    dev = data.labels.device
    gen = torch.Generator(device=dev).manual_seed(6)
    rnd = lambda *s, sc=1.0: sc * torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    lp0, lp1 = params["layers"][0], params["layers"][1]
    cases, seen = [], set()
    for i, b in enumerate(data.graphs):
        rp = lp0["rel"][f"g{i}"]
        for t, w in ((b.src_type, rp["w_src"]), (b.dst_type, rp["w_dst"])):
            if t in seen:
                continue
            seen.add(t)
            x = data.features[t]
            cases.append((f"layer 0 {t} {x.shape[0]}x{x.shape[1]}->{w.shape[1]}",
                          (x, w, rnd(w.shape[1], sc=0.1), rp["a_src"], rp["a_dst"])))
    rp1 = lp1["rel"]["g0"]
    n_movie, c = data.features["movie"].shape[0], rp1["w_src"].shape[1]
    cases.append((f"layer 1 movie {n_movie}x{c}->{c}",
                  (rnd(n_movie, c), rp1["w_src"], rnd(c, sc=0.1), rp1["a_src"], rp1["a_dst"])))
    actor = next(ops for name, ops in cases if " actor " in name)
    cases.append(("bf16 " + next(name for name, _ in cases if " actor " in name),
                  tuple(t.to(torch.bfloat16) for t in actor)))
    cases.append(("ragged 1001x37->4x16", (rnd(1001, 37), rnd(37, 64, sc=0.2), rnd(64, sc=0.1),
                                           rnd(4, 16), rnd(4, 16))))
    return cases


def kernel6_cost(x, w, a_src) -> dict:
    """Bytes and bounds of kernel #6 on these operands: x, w, b, a_src, a_dst
    read once, h and both thetas written once.  ``bound_ms``: the function's
    2·N·Din·C product flops at the TF32 tensor-core peak, or the bytes;
    ``bound_split_ms``: the split's three products (work of the wgmma
    design, not of the function); ``bound_cuda_cores_ms``: the product plus
    the bias and thetas (1 + 4 flops an entry of h) on the float32 CUDA
    cores, the cuda_cores route's bound."""
    (n, din), (c, (heads, _)) = x.shape, (w.shape[1], a_src.shape)
    nbytes = x.element_size() * (n * din + din * c + 3 * c + n * c) + 4 * 2 * n * heads
    product = 2 * n * din * c
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = product / PEAK_TF32_FLOPS * 1e3
    cc, cc_by = bound_ms(nbytes, product + 5 * n * c)
    return dict(bytes=nbytes, flops=product, bound_ms=max(t_bytes, t_ops),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_split_ms=max(t_bytes, 3 * t_ops), bound_cuda_cores_ms=cc,
                bound_cuda_cores_by=cc_by)


def kernel6_phase(data, params, k6_mod) -> dict:
    """#6 against its plain version at R-GAT's shapes on full IMDB, in
    bfloat16 and on a ragged shape, each case on the route the wrapper
    picks (float32 on wgmma, bfloat16 on cuda_cores) and every float32 case
    also forced on cuda_cores; twice bitwise equal; the float32 cases under
    ``SPLIT_ERROR_MAX`` (the plain float32 product's error printed beside);
    each float32 case timed with CUDA events on both routes beside its
    bounds, the plain version and ``torch.addmm`` + the two einsums; the
    actor projection's times make the table row."""
    err = 0.0
    per_case = {}
    fn = k6_mod.fused_fp_coeff
    for name, ops in kernel6_cases(data, params):
        x, w, b, a_s, a_d = ops
        n, (heads, dh) = x.shape[0], a_s.shape
        route = k6_mod.route(x.dtype, dh)
        before = dict(fn.launches_by_route)
        got = fn(*ops)
        again = fn(*ops)
        want = k6_mod.fused_fp_coeff_plain(*ops)
        torch.cuda.synchronize()
        ran = {r: k - before[r] for r, k in fn.launches_by_route.items()}
        name = f"{name} [{route}]"
        if ran != {r: 2 * (r == route) for r in ran}:
            raise AssertionError(f"fused_fp_coeff {name}: launches by route {ran}")
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"fused_fp_coeff {name}: two runs on the same inputs differ")
        if x.dtype == torch.bfloat16:  # h within one bf16 rounding; theta from the f32 h
            h_err = float((got[0].float() - want[0].float()).abs().max())
            torch.testing.assert_close(got[0].float(), want[0].float(), atol=1e-5, rtol=8e-3,
                                       msg=lambda m: f"fused_fp_coeff {name} h: {m}")
            log(f"[check] fused_fp_coeff {name} h: max_abs_err={h_err:.3e} (one bf16 rounding: "
                f"atol=1e-5, rtol=8e-3)")
            err = max(err, compare(f"fused_fp_coeff {name} theta", got[1:], want[1:]))
            continue
        err = max(err, compare(f"fused_fp_coeff {name}", got, want))
        e_kernel = k6_mod.split_error(got[0], x, w, b)
        e_plain = k6_mod.split_error(want[0], x, w, b)
        log(f"[check] fused_fp_coeff {name}: split error {e_kernel:.3e} (plain float32 product "
            f"{e_plain:.3e}; limit {k6_mod.SPLIT_ERROR_MAX})")
        if not e_kernel <= k6_mod.SPLIT_ERROR_MAX:
            raise AssertionError(f"fused_fp_coeff {name}: split error {e_kernel} above "
                                 f"SPLIT_ERROR_MAX {k6_mod.SPLIT_ERROR_MAX}")
        h = torch.empty_like(got[0])
        ts, td = torch.empty_like(got[1]), torch.empty_like(got[2])
        # the CUDA-core kernel, forced, on the same float32 operands
        outs = []
        for _ in range(2):
            k6_mod.launch(x, w, b, a_s, a_d, h, ts, td, route_="cuda_cores")
            torch.cuda.synchronize()
            outs.append((h.clone(), ts.clone(), td.clone()))
        if not all(torch.equal(g, a) for g, a in zip(*outs)):
            raise AssertionError(f"fused_fp_coeff {name} [cuda_cores]: two runs differ")
        err = max(err, compare(f"fused_fp_coeff {name} forced [cuda_cores]", outs[0], want))
        del outs

        def library():  # one PyTorch call for the product, then the coefficients
            hh = torch.addmm(b, x, w).reshape(n, heads, dh)
            return torch.einsum("nhd,hd->nh", hh, a_s), torch.einsum("nhd,hd->nh", hh, a_d)

        cost = kernel6_cost(x, w, a_s)
        t = per_case[name] = dict(
            cost, shape=f"{n} × {x.shape[1]} → {heads} × {dh}", route=route,
            split_k=k6_mod.split_k(n, x.shape[1], heads * dh),
            split_error=e_kernel, split_error_plain=e_plain,
            ms=cuda_ms(lambda: k6_mod.launch(x, w, b, a_s, a_d, h, ts, td), reps=20),
            ms_cuda_cores=cuda_ms(lambda: k6_mod.launch(x, w, b, a_s, a_d, h, ts, td,
                                                        route_="cuda_cores"), reps=20),
            plain_ms=cuda_ms(lambda: k6_mod.fused_fp_coeff_plain(x, w, b, a_s, a_d), reps=20),
            library_ms=cuda_ms(library, reps=20))
        t["ms_again"] = cuda_ms(lambda: k6_mod.launch(x, w, b, a_s, a_d, h, ts, td), reps=20)
        log(f"[time] fused_fp_coeff {name} S={t['split_k']}: kernel {t['ms']:.4f} ms (again "
            f"{t['ms_again']:.4f}), cuda_cores {t['ms_cuda_cores']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, addmm + einsums {t['library_ms']:.4f} ms; bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {t['bytes']:.4e} B, {t['flops']:.4e} "
            f"product flops at 494.7 TFLOP/s), with the split's three products "
            f"{t['bound_split_ms']:.4f} ms, CUDA cores {t['bound_cuda_cores_ms']:.4f} ms")
    log("[check] fused_fp_coeff: every case twice bitwise equal on its route and on cuda_cores")
    # the tensor cores' error grows with one accumulator's K chain, which the
    # kernel cuts every CHAIN_TILES tiles: hold it where split-K does not cut
    # K (17,000 rows fill a wave of blocks)
    deepest = {}
    gen = torch.Generator(device="cuda").manual_seed(17)
    for din in (2048, 3341):
        x = 0.1 * torch.randn(17_000, din, generator=gen, device="cuda")
        w = 0.0236 * torch.randn(din, 256, generator=gen, device="cuda")
        b, a = 0.1 * torch.randn(256, generator=gen, device="cuda"), torch.ones(4, 64, device="cuda")
        e = k6_mod.split_error(fn(x, w, b, a, a)[0], x, w, b)
        deepest[din] = dict(split_k=k6_mod.split_k(17_000, din, 256), split_error=e)
        log(f"[check] fused_fp_coeff 17000x{din}->4x64 (S={deepest[din]['split_k']}): split "
            f"error {e:.3e} (limit {k6_mod.SPLIT_ERROR_MAX})")
        if not e <= k6_mod.SPLIT_ERROR_MAX:
            raise AssertionError(f"fused_fp_coeff 17000x{din}: split error {e} above the limit")
        del x, w
    row = next(t for name, t in per_case.items() if name.startswith("layer 0 actor"))
    return dict(row, max_abs_err=err, per_case=per_case, deepest_slices=deepest)


def kernel6_alone() -> dict:
    """Phase 5c on its own (``python3 -c 'import chip_smoke as c;
    c.kernel6_alone()'``): builds #6 (and #7, which shares csrc/hopper.cuh),
    writes their ptxas reports, runs the phase on full IMDB and writes
    chiprun_out/kernel6.json."""
    from repro_torch.graphs import synthetic_hetgraph
    from repro_torch.kernels import build
    from repro_torch.models.hgnn import MODELS

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    log(card_line())
    OUT.mkdir(exist_ok=True)
    check_ptxas(build.build(("fused_fp_coeff", "flash_attention")))
    graph = synthetic_hetgraph("imdb", scale=1.0, feat_scale=1.0, seed=0)
    rdata = relation_data(graph, "cuda")
    rgat0 = MODELS["R-GAT"].init(torch.Generator().manual_seed(0), rdata, **MODEL_WIDTHS["R-GAT"])
    res = kernel6_phase(rdata, rgat0, importlib.import_module("repro_torch.kernels.fused_fp_coeff"))
    res["card"] = card_line()
    (OUT / "kernel6.json").write_text(json.dumps(res, indent=1, default=str))
    log(res["card"])
    return res


def ptxas_registers(report: str) -> dict[str, str]:
    """Each kernel's "registers, spills" from a ptxas -v report, by the
    kernel's template arguments (``<V, NK>`` of the edge kernels)."""
    regs, name = {}, None
    for line in report.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[-1].strip()
            m = re.search(r"ILi(\d+)ELi(\d+)E", fn)
            head = fn[:m.start()] if m else fn
            n = next((n for n in range(1, len(head)) if head[:-n].endswith(str(n))), len(head))
            name = head[-n:] + (f"<{m[1]},{m[2]}>" if m else "")
        elif "spill stores" in line and name:
            regs[name] = line.strip().split(", ")[1]
        elif "registers" in line and name:
            regs[name] = line.split("Used ")[-1].split(",")[0] + ", " + regs.get(name, "")
    return regs


def edge_walk_times() -> dict:
    """#1 at the HAN training shape (phase 4a's operands) and #5's six
    launches of one R-GAT layer on full IMDB (phase 5a's), each timed with
    CUDA events, beside both kernels' ptxas registers and spills; prints one
    JSON line and returns it.  It times the ``repro_torch`` beside this
    script, through calls (``launch`` of #1 and of #5) whose arguments are
    those of the tree before #5's edge walk too, so an A/B of two trees
    copies this script to each tree's root and runs it there in turns
    (``python3 -c 'import chip_smoke as c; c.edge_walk_times()'``)."""
    from repro_torch.core import fusion
    from repro_torch.graphs import synthetic_hetgraph
    from repro_torch.kernels import build
    from repro_torch.launch import hgnn_train
    from repro_torch.models.hgnn import HAN, MODELS

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    mg_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg_multigraph")
    k5_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg")
    reports = build.build(("seg_gat_agg_multigraph", "seg_gat_agg"))
    _, tdata = hgnn_train.build_problem(device="cuda", **TRAIN)
    params = HAN.init(torch.Generator().manual_seed(0), tdata, **TRAIN_WIDTH,
                      att_dim=2 * TRAIN_WIDTH["hidden"])
    mg, _ = train_operands(tdata, params, fusion)
    B, (H, Dh) = mg["masks"].shape[-1], mg["h_src"].shape[1:]
    out = torch.empty((mg["col_index"].shape[0] * B, H, Dh), device="cuda")
    lse = torch.empty(out.shape[:2], device="cuda")
    ms1 = cuda_ms(lambda: mg_mod.launch(**mg, out=out, lse=lse, leaky_slope=0.2), reps=20)
    del tdata, mg, out, lse
    graph = synthetic_hetgraph("imdb", scale=1.0, feat_scale=1.0, seed=0)
    rdata = relation_data(graph, "cuda")
    rgat = MODELS["R-GAT"].init(torch.Generator().manual_seed(0), rdata, **MODEL_WIDTHS["R-GAT"])
    ops_list = kernel5_operands(rdata, rgat, fusion)
    outs = [torch.empty((o["theta_dst"].shape[0], *o["h_src"].shape[1:]), device="cuda")
            for o in ops_list]

    def one(o, o_out):
        k5_mod.launch(o["col_index"], o["masks"], o["theta_src"], o["theta_dst"], o["h_src"],
                      o["edge_bias"], o_out, 0.2)

    ms5 = cuda_ms(lambda: [one(o, o_out) for o, o_out in zip(ops_list, outs)], reps=20)
    per_graph = {b.name: cuda_ms(lambda: one(o, o_out), reps=20)
                 for b, o, o_out in zip(rdata.graphs, ops_list, outs)}
    res = dict(card=card_line(), multigraph_ms=ms1, seg_gat_agg_layer_ms=ms5,
               seg_gat_agg_per_graph_ms=per_graph,
               registers={k: ptxas_registers(v) for k, v in reports.items()})
    print(json.dumps(res), flush=True)
    return res


def inference(graph, counters, NAB) -> dict:
    """R-GAT and S-HGN on KERNEL (#6 twice and #5 once per relation and
    layer, R-GAT's live ones alone) and R-GCN
    (mean NA) on full IMDB's relation graphs, forward under no_grad: each
    model's first forward with the counters zeroed just before and read just
    after, then steady forwards; logits against BLOCK on the card (R-GAT,
    S-HGN) or the CPU (R-GCN) at 1e-4."""
    from repro_torch.models.hgnn import MODELS
    from repro_torch.tree import tree_map

    data = relation_data(graph, "cuda")
    res = {}
    for name, width in MODEL_WIDTHS.items():
        model = MODELS[name]
        params = model.init(torch.Generator().manual_seed(0), data, **width)
        backend = NAB.SEGMENT if name == "R-GCN" else NAB.KERNEL
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        k6 = counters["fused_fp_coeff"]
        k6.launches_by_route = dict.fromkeys(k6.launches_by_route, 0)
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = model.forward(params, data, backend=backend)
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        launches = {k: fn.launches for k, fn in counters.items()}
        k6_routes = dict(k6.launches_by_route)
        steady = []
        for _ in range(5):
            t0 = time.perf_counter()
            with torch.no_grad():
                model.forward(params, data, backend=backend)
            torch.cuda.synchronize()
            steady.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        with torch.no_grad():
            prof = profiled(lambda: model.forward(params, data, backend=backend), 3)
        if logits.shape != (graph.num_vertices("movie"), 3) or not torch.isfinite(logits).all():
            raise AssertionError(f"{name}: logits {tuple(logits.shape)} or non-finite")
        with torch.no_grad():
            if name == "R-GCN":
                cpu = relation_data(graph, "cpu")
                ref = model.forward(tree_map(lambda t: t.cpu(), params), cpu).to(logits.device)
                against = "the CPU"
            else:
                ref = model.forward(params, data, backend=NAB.BLOCK)
                against = "BLOCK on the card"
        err = compare(f"{name} logits {backend.value} vs {against}", (logits,), (ref,))
        expect = {k: 0 for k in launches}
        if name != "R-GCN":  # per relation and layer: #6 on the src and dst side, #5 once
            passes = relation_passes(name, data, width["layers"])
            expect |= {"seg_gat_agg": passes, "fused_fp_coeff": 2 * passes}
        if launches != expect:
            raise AssertionError(f"{name} forward launches {launches}, expected {expect}")
        if k6_routes != {"wgmma": expect["fused_fp_coeff"], "cuda_cores": 0}:
            raise AssertionError(f"{name}: #6 launches by route {k6_routes}, expected all "
                                 f"{expect['fused_fp_coeff']} on wgmma")
        res[name] = dict(launches=launches, fused_fp_coeff_by_route=k6_routes, cold_ms=cold_ms,
                         steady_ms=steady,
                         peak_mem_bytes=peak, max_abs_err=err, profiled=prof)
        log(f"[infer {name}] {backend.value}: launches={json.dumps(launches)}, #6 by route "
            f"{json.dumps(k6_routes)}; forward ms cold "
            f"{cold_ms:.3f}, steady median {float(np.median(steady)):.3f} "
            f"({['%.3f' % s for s in steady]}), peak mem {peak / 2**30:.3f} GiB")
        log(f"[infer {name}] 3 forwards under the profiler: {['%.3f' % t for t in prof['steps_ms']]} "
            f"ms, device busy {prof['device_busy_ms']:.3f} of {prof['device_wall_ms']:.3f} ms, idle "
            f"share {prof['device_idle_share']:.4f}")
        for k in prof["top_kernels"][:4]:
            log(f"[infer {name}]   {k['device_ms']:9.3f} ms x{k['calls']:<4d} {k['name']}")
    return res


def k5_calls_to_plain(name: str, run, k5_mod):
    """Runs ``run()`` with #5's launches recording their operands, then
    holds each call's output against ``seg_gat_agg_plain`` on the same
    operands at atol=rtol=1e-4.  Returns (run's result, the calls, the
    max abs error)."""
    calls, launch = [], k5_mod.launch

    def recording(*args, **kw):
        launch(*args, **kw)
        calls.append(args)

    k5_mod.launch = recording
    try:
        result = run()
    finally:
        k5_mod.launch = launch
    err = 0.0
    for n, (col, masks, ths, thd, hs, bias, out, slope) in enumerate(calls):
        want = k5_mod.seg_gat_agg_plain(col, masks, ths, thd, hs, leaky_slope=slope,
                                        edge_bias=bias)
        err = max(err, compare(f"{name} #5 call {n}", (out,), (want,)))
    return result, calls, err


def captured(buf) -> str:
    """What a run printed into ``buf``, less the ``[check]`` lines of the
    checks made inside it, which are logged here."""
    lines = buf.getvalue().splitlines()
    for ln in lines:
        if ln.startswith("[check] "):
            log(ln)
    return "\n".join(ln for ln in lines if not ln.startswith("[check] "))


def serve_calls_to_plain(name: str, run):
    """Runs ``run()`` (a serving run) with every launch of #1 and #3 held,
    as it returns, against its plain version (``seg_gat_agg_multigraph_plain``,
    ``seg_gat_agg_fused_fp_plain``) on the same operands at atol=rtol=1e-4:
    the engine's FP cache may reuse an operand's memory after the call, so
    the check cannot wait for the run's end.  The plain versions launch no
    kernel.  Returns (run's result, calls checked by kernel, max abs err)."""
    mg_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg_multigraph")
    ff_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg_fused_fp")
    launches = {"multigraph": (mg_mod, mg_mod.launch), "fused_fp": (ff_mod, ff_mod.launch)}
    calls, err = dict.fromkeys(launches, 0), [0.0]

    def mg_call(*args):
        res = launches["multigraph"][1](*args)
        *ops, out, lse, slope = args
        want = mg_mod.seg_gat_agg_multigraph_plain(*ops, leaky_slope=slope)
        err[0] = max(err[0], compare(f"{name} #1 launch {calls['multigraph']}", (out, lse), want))
        calls["multigraph"] += 1
        return res

    def ff_call(*args):
        res = launches["fused_fp"][1](*args)
        *ops, out, lse, slope, _ = args
        want = ff_mod.seg_gat_agg_fused_fp_plain(*ops, leaky_slope=slope)
        err[0] = max(err[0], compare(f"{name} #3 launch {calls['fused_fp']}", (out, lse), want))
        calls["fused_fp"] += 1
        return res

    mg_mod.launch, ff_mod.launch = mg_call, ff_call
    try:
        result = run()
    finally:
        for mod, fn in launches.values():
            mod.launch = fn
    return result, calls, err[0]


def inference_block128(graph, k5_mod, NAB) -> dict:
    """Phase 5e: R-GAT and S-HGN inference on KERNEL at block=128 (the
    reference trainer's default, which #5's edge walk takes) on full IMDB's
    relation graphs: every #5 call of each model's first forward against
    ``seg_gat_agg_plain`` on the same operands and the logits against
    BLOCK, at atol=rtol=1e-4; steady forward times; #5's six launches of
    R-GAT's layer 0 timed with CUDA events, with the entries they visit."""
    from repro_torch.core import fusion
    from repro_torch.graphs import relation_semantic_graphs, synthetic_labels
    from repro_torch.models.hgnn import MODELS, prepare_data

    data = prepare_data(graph, relation_semantic_graphs(graph), "movie", 3,
                        synthetic_labels(graph, "imdb", seed=0), block=128, device="cuda")
    log("[B=128] " + ", ".join(f"{b.name} block CSR {tuple(b.col_index.shape)}"
                               for b in data.graphs))
    res = {}
    for name in ("R-GAT", "S-HGN"):
        model, width = MODELS[name], MODEL_WIDTHS[name]
        params = model.init(torch.Generator().manual_seed(0), data, **width)

        def forward():
            with torch.no_grad():
                return model.forward(params, data, backend=NAB.KERNEL)

        logits, calls, err = k5_calls_to_plain(f"{name} B=128", forward, k5_mod)
        passes = relation_passes(name, data, width["layers"])
        if len(calls) != passes:
            raise AssertionError(f"{name} at B=128: {len(calls)} launches of #5, expected "
                                 f"{passes}")
        with torch.no_grad():
            ref = model.forward(params, data, backend=NAB.BLOCK)
        err = max(err, compare(f"{name} B=128 logits kernel vs BLOCK", (logits,), (ref,)))
        steady = []
        for _ in range(5):
            t0 = time.perf_counter()
            with torch.no_grad():
                model.forward(params, data, backend=NAB.KERNEL)
            torch.cuda.synchronize()
            steady.append((time.perf_counter() - t0) * 1e3)
        res[name] = dict(max_abs_err=err, na_calls=len(calls), steady_ms=steady)
        log(f"[B=128 {name}] {len(calls)} calls of #5 and the logits match; steady forward ms "
            f"{['%.3f' % t for t in steady]}")
    rgat = MODELS["R-GAT"].init(torch.Generator().manual_seed(0), data, **MODEL_WIDTHS["R-GAT"])
    ops_list = kernel5_operands(data, rgat, fusion)
    outs = [torch.empty((o["theta_dst"].shape[0], *o["h_src"].shape[1:]), device="cuda")
            for o in ops_list]
    visits = torch.zeros(1, dtype=torch.int32, device="cuda")
    for o, out in zip(ops_list, outs):
        k5_mod.launch(o["col_index"], o["masks"], o["theta_src"], o["theta_dst"], o["h_src"],
                      o["edge_bias"], out, 0.2, visits=visits)
    edges = sum(live_edges(o["col_index"], o["masks"]) for o in ops_list)
    if int(visits) != edges:
        raise AssertionError(f"#5 at B=128 visited {int(visits)} entries for {edges} edges")
    ms = cuda_ms(lambda: [k5_mod.launch(o["col_index"], o["masks"], o["theta_src"],
                                        o["theta_dst"], o["h_src"], o["edge_bias"], out, 0.2)
                          for o, out in zip(ops_list, outs)], reps=20)
    nbytes, flops, _ = kernel5_cost(ops_list)
    bound, by = bound_ms(nbytes, flops)
    res["seg_gat_agg_layer"] = dict(ms=ms, bound_ms=bound, bound_by=by, edges=edges,
                                    visited_per_edge=int(visits) / edges)
    log(f"[B=128 time] seg_gat_agg, R-GAT layer 0's six launches: {ms:.4f} ms, bound "
        f"{bound:.4f} ms ({by}); visited {int(visits)} entries for {edges} edges")
    return res


def rgat_training(counters) -> dict:
    """The launcher's R-GAT (layers=2, metapath graphs, MULTIGRAPH per graph
    and layer) at R-GAT's width on full IMDB, 20 steps through
    ``run_training(model_name="R-GAT")``, counters zeroed just before: #1
    and #2 launch 6 times a step, and the loss falls."""
    from repro_torch.launch import hgnn_train

    lines = []
    adamw_fn = importlib.import_module("repro_torch.kernels.fused_adamw").fused_adamw
    torch.cuda.reset_peak_memory_stats()
    for fn in (*counters.values(), adamw_fn):
        fn.launches = 0
    t0 = time.perf_counter()
    _, hist, meta = hgnn_train.run_training(model_name="R-GAT", steps=20, backend="kernel",
                                            log_every=1, log=lines.append, device="cuda",
                                            **TRAIN, **RGAT_TRAIN)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    adamw_launches = adamw_fn.launches
    steps_ms = [h["sec"] * 1e3 for h in hist]
    res = dict(launches=launches, per_step={k: v / 20 for k, v in launches.items()},
               adamw_launches=adamw_launches, wall_s=wall,
               meta=meta, steps_ms=steps_ms, loss=[h["loss"] for h in hist],
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    log(f"[train R-GAT] {lines[0]}")
    log(f"[train R-GAT] launches={json.dumps(launches)} per step "
        f"{json.dumps(res['per_step'])}; loss {hist[0]['loss']:.6f} -> {hist[-1]['loss']:.6f}, "
        f"step ms cold {steps_ms[0]:.3f}, steady median {float(np.median(steps_ms[1:])):.3f}, "
        f"wall {wall:.3f} s, peak mem {res['peak_mem_bytes'] / 2**30:.3f} GiB")
    want = {k: 0 for k in launches} | {"multigraph": 120, "multigraph_bwd": 120}
    if launches != want:
        raise AssertionError(f"R-GAT training launches {launches}, expected {want} (6/6 a step)")
    if adamw_launches != 2 * 20:
        raise AssertionError(f"AdamW's kernel pair launched {adamw_launches} times in 20 steps")
    if not hist[-1]["loss"] < hist[0]["loss"] or not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"the R-GAT loss did not fall: {[h['loss'] for h in hist]}")

    # the same step, steady, under the profiler (after the main path's counts were read)
    from repro_torch.core import NABackend
    from repro_torch.models.hgnn import RGAT
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_hgnn_train_state, make_hgnn_train_step

    _, data = hgnn_train.build_problem(device="cuda", **TRAIN)
    opt = AdamWConfig(lr=5e-3, weight_decay=0.0)
    state = init_hgnn_train_state(RGAT, torch.Generator().manual_seed(0), data, opt,
                                  layers=2, **RGAT_TRAIN)
    step = make_hgnn_train_step(
        lambda p: RGAT.forward(p, data, backend=NABackend.MULTIGRAPH), data, opt)
    idx = torch.arange(data.labels.shape[0])
    # the first step's six calls of #1 and #2 (H·Dh = 256) against their plain versions
    (state, _), res["first_step_max_abs_err"] = na_calls_to_plain(
        "R-GAT step", lambda: step(state, {"idx": idx}), first=6)
    _, res["steady"] = profiled_steps(step, state, idx, 3)
    pr = res["steady"]
    log(f"[train R-GAT steady] steps_ms={['%.3f' % t for t in pr['steps_ms']]} busy "
        f"{pr['device_busy_ms']:.3f} ms of {pr['device_wall_ms']:.3f} ms, idle share "
        f"{pr['device_idle_share']:.4f}")
    for k in pr["top_kernels"][:5]:
        log(f"[train R-GAT steady]   {k['device_ms']:9.3f} ms x{k['calls']:<4d} {k['name']}")
    return res


# -- phase 6: the LM slice, llama3.2-3b at full width, kernel #7 -------------------

LM_ARCH = "llama3.2-3b"
LM_BATCH, LM_SEQ, LM_SEQ_F32 = 2, 4096, 2048
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores (printed beside the bound)
FLASH_MAIN = (LM_BATCH, 24, 8, LM_SEQ, LM_SEQ, 128, True, None)  # llama3.2-3b's layer
FLASH_MOE = (LM_BATCH, 48, 8, LM_SEQ, LM_SEQ, 128, True, None)  # dbrx's and grok's: GQA group 6
FLASH_RG = (LM_BATCH, 16, 1, LM_SEQ, LM_SEQ, 256, True, 2048)  # recurrentgemma-9b's local layer
FLASH_VLM = (LM_BATCH, 28, 4, LM_SEQ, LM_SEQ, 128, True, None)  # qwen2-vl-7b's: GQA group 7
WHISPER_SHAPES = {  # whisper-large-v3's: MHA, 20 heads of 64
    "whisper encoder": (LM_BATCH, 20, 20, 1024, 1024, 64, False, None),  # on flash: 1,024 frames
    "whisper decoder": (LM_BATCH, 20, 20, 448, 448, 64, True, None),     # 3.5 tiles of 128
}
FLASH_EDGES = [  # (B, Hq, Hkv, Sq, Sk, Dh, causal, window)
    (1, 24, 8, 1024, 3072, 128, True, None),   # Sq < Sk (a continuation)
    (1, 24, 8, 2048, 1024, 128, True, None),   # Sq > Sk: the first 1024 rows see no key
    (1, 16, 1, 4096, 4096, 256, True, 2048),   # recurrentgemma's MQA local attention
    (LM_BATCH, 24, 8, 1024, 1024, 128, False, None),  # bidirectional
    FLASH_MOE,
    FLASH_VLM,
    *WHISPER_SHAPES.values(),
]


def flash_cost(B, Hq, Hkv, Sq, Sk, Dh, causal, window, itemsize,
               flops_per_pair=4) -> tuple[int, int]:
    """(bytes, flops) attention needs on these shapes: q, k, v read once and
    out written once; ``flops_per_pair``·Dh flops per visible (query, key)
    pair, counted from the mask: 4 for q·k and p·v, 6 for the tensor-core
    route, whose p·v runs twice (p_hi and p_lo)."""
    qpos = np.arange(Sq) + (Sk - Sq)
    hi = np.minimum(qpos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window is not None else np.zeros(Sq, np.int64)
    visible = int(np.clip(hi - lo + 1, 0, None).sum())
    nbytes = itemsize * (2 * B * Hq * Sq * Dh + 2 * B * Hkv * Sk * Dh)
    return nbytes, flops_per_pair * B * Hq * visible * Dh


def flash_operands(case, dtype, seed=0):
    B, Hq, Hkv, Sq, Sk, Dh, _, _ = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=gen, device="cuda").to(dtype)
            for s in ((B, Hq, Sq, Dh), (B, Hkv, Sk, Dh), (B, Hkv, Sk, Dh))]


def flash_phase(fa_mod) -> dict:
    """#7 against its plain version on llama3.2-3b's layer shape (bf16 and
    float32) and the edge cases, each case on the route the wrapper picks;
    twice bitwise equal; on the wgmma route also the share of outputs equal
    to the rounded float32 result, with its controls at the main shape;
    timed with CUDA events beside its bounds, the CUDA-core route on
    float32 operands, the plain version and SDPA."""
    err = 0.0
    routes, shares = {}, {}
    for case in [FLASH_MAIN, *FLASH_EDGES]:
        B, Hq, Hkv, Sq, Sk, Dh, causal, window = case
        for dtype, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
            q, k, v = flash_operands(case, dtype)
            before = dict(fa_mod.flash_attention.launches_by_route)
            got = fa_mod.flash_attention(q, k, v, causal=causal, window=window)
            again = fa_mod.flash_attention(q, k, v, causal=causal, window=window)
            want = fa_mod.flash_attention_plain(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            route = fa_mod.route(dtype, Dh)
            name = f"flash_attention {case} {str(dtype)[6:]} [{route}]"
            ran = {r: n - before[r] for r, n in fa_mod.flash_attention.launches_by_route.items()}
            if ran != {r: 2 * (r == route) for r in ran}:
                raise AssertionError(f"{name}: launches by route {ran}")
            routes[f"{case} {str(dtype)[6:]}"] = route
            if not torch.equal(got, again):
                raise AssertionError(f"{name}: two runs on the same inputs differ")
            if Sq > Sk and causal and not (got[:, :, : Sq - Sk] == 0).all():
                raise AssertionError(f"{name}: rows that see no key are not exact zeros")
            d = float((got.float() - want.float()).abs().max())
            torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol,
                                       msg=lambda m: f"{name}: {m}")
            checks = f"atol=rtol={tol}"
            if dtype == torch.bfloat16:  # one rounding of the float32 result
                torch.testing.assert_close(got.float(), want.float(), atol=1e-4, rtol=8e-3,
                                           msg=lambda m: f"{name}, one rounding: {m}")
                checks += " and atol=1e-4, rtol=8e-3"
            if route == "wgmma":  # p split: nearly every output is that rounding itself
                share = float((got == want).float().mean())
                if share < fa_mod.BITWISE_SHARE_MIN:
                    raise AssertionError(f"{name}: {share:.6f} of the outputs equal the rounded "
                                         f"float32 result, under {fa_mod.BITWISE_SHARE_MIN}")
                checks += f"; {share:.6f} bitwise equal to it (>= {fa_mod.BITWISE_SHARE_MIN})"
                if case == FLASH_MAIN:
                    shares = dict(kernel=share, **control_shares(fa_mod, q, k, v, want, case))
            log(f"[check] {name}: max_abs_err={d:.3e} ({checks}), twice bitwise equal")
            err = max(err, d) if dtype == torch.bfloat16 and case == FLASH_MAIN else err
            del q, k, v, got, again, want
    B, Hq, Hkv, Sq, Sk, Dh, causal, window = FLASH_MAIN
    q, k, v = flash_operands(FLASH_MAIN, torch.bfloat16)
    out = torch.empty_like(q)
    scale = Dh ** -0.5

    def run(qq, kk, vv, oo):
        return lambda: fa_mod.launch(qq, kk, vv, oo, causal=True, window=None, scale=scale)

    ms = cuda_ms(run(q, k, v, out), reps=20)
    plain_ms = cuda_ms(lambda: fa_mod.flash_attention_plain(q, k, v), reps=3)
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), reps=20)
    ms2 = cuda_ms(run(q, k, v, out), reps=20)
    qf, kf, vf = q.float(), k.float(), v.float()
    ms_f32 = cuda_ms(run(qf, kf, vf, torch.empty_like(qf)), reps=5)
    nbytes, flops = flash_cost(*FLASH_MAIN, itemsize=2)
    _, flops_split = flash_cost(*FLASH_MAIN, itemsize=2, flops_per_pair=6)
    bound_f32, _ = bound_ms(nbytes, flops)
    bound = max(nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS) * 1e3
    by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_HBM_BYTES else "bytes"
    bound_split = max(nbytes / PEAK_HBM_BYTES, flops_split / PEAK_BF16_FLOPS) * 1e3
    log(f"[time] flash_attention {FLASH_MAIN} bf16: wgmma kernel {ms:.4f} ms (again after SDPA "
        f"{ms2:.4f}), float32 operands (cuda_cores) {ms_f32:.4f} ms, plain {plain_ms:.4f} ms, "
        f"SDPA {lib_ms:.4f} ms")
    log(f"[bound] flash_attention {FLASH_MAIN}: {nbytes:.4e} B, {flops:.4e} flops (4·Dh a "
        f"visible pair): bf16 tensor cores at 989 TFLOP/s {bound:.4f} ms ({by}), float32 CUDA "
        f"cores {bound_f32:.4f} ms; with the split's second p·v ({flops_split:.4e} flops, 6·Dh "
        f"a pair, work of this design, not of the function) {bound_split:.4f} ms")
    del q, k, v, out, qf, kf, vf
    q, k, v = flash_operands(FLASH_MOE, torch.bfloat16)
    moe = dict(ms=cuda_ms(run(q, k, v, torch.empty_like(q)), reps=20),
               plain_ms=cuda_ms(lambda: fa_mod.flash_attention_plain(q, k, v), reps=3),
               library_ms=cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                   q, k, v, is_causal=True, enable_gqa=True), reps=20))
    moe_bytes, moe_flops = flash_cost(*FLASH_MOE, itemsize=2)
    moe["bound_ms"] = max(moe_bytes / PEAK_HBM_BYTES, moe_flops / PEAK_BF16_FLOPS) * 1e3
    log(f"[time] flash_attention {FLASH_MOE} bf16 (dbrx's and grok's layer): wgmma kernel "
        f"{moe['ms']:.4f} ms, plain {moe['plain_ms']:.4f} ms, SDPA {moe['library_ms']:.4f} ms, "
        f"bound {moe['bound_ms']:.4f} ms ({moe_flops:.4e} flops at 989 TFLOP/s)")
    del q, k, v
    return dict(max_abs_err=err, ms=ms, ms_again=ms2, ms_float32=ms_f32, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by, bound_split_ms=bound_split,
                bound_float32_ms=bound_f32, bytes=nbytes, flops=flops, flops_split=flops_split,
                routes=routes, bitwise_shares=shares, moe_shape=moe,
                recurrentgemma_shape=flash_rg_shape(fa_mod),
                vlm_shape=flash_shape_times(fa_mod, FLASH_VLM, VLM_ARCH),
                whisper_shapes={n: flash_shape_times(fa_mod, c, n)
                                for n, c in WHISPER_SHAPES.items()})


def sdpa_windowed(q, k, v, window: int) -> tuple[float, str]:
    """(ms, backend) of ``scaled_dot_product_attention`` with ``enable_gqa``
    and the bool mask of a causal ``window``: the first backend of flash,
    memory-efficient, cuDNN and math that takes the operands."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    mask = importlib.import_module("repro_torch.kernels.flash_attention").attention_mask(
        q.shape[2], k.shape[2], True, window, q.device)

    def fn():
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                enable_gqa=True)

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        with sdpa_kernel(backend), warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # each refusing backend says why
            try:
                fn()
            except RuntimeError:
                continue
            return cuda_ms(fn, reps=10), backend.name.lower()
    raise AssertionError("no SDPA backend took the windowed operands")


def flash_rg_shape(fa_mod) -> dict:
    """#7 at recurrentgemma-9b's local layer (B = 2, S = 4096, MQA 16/1 heads
    of 256, window 2048, bf16: the cuda_cores route) timed with CUDA events
    beside its bound (4·Dh flops a visible pair of the window's mask at the
    bf16 peak; the float32 CUDA cores' beside it), the plain version and
    SDPA with the same window mask (its backend named)."""
    B, Hq, Hkv, Sq, Sk, Dh, causal, window = FLASH_RG
    q, k, v = flash_operands(FLASH_RG, torch.bfloat16)
    out = torch.empty_like(q)
    route = fa_mod.route(q.dtype, Dh)
    ms = cuda_ms(lambda: fa_mod.launch(q, k, v, out, causal=causal, window=window,
                                       scale=Dh ** -0.5), reps=10)
    plain_ms = cuda_ms(lambda: fa_mod.flash_attention_plain(q, k, v, causal=causal,
                                                            window=window), reps=3)
    lib_ms, backend = sdpa_windowed(q, k, v, window)
    nbytes, flops = flash_cost(*FLASH_RG, itemsize=2)
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    bound, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    bound_f32, _ = bound_ms(nbytes, flops)
    log(f"[time] flash_attention {FLASH_RG} bf16 (recurrentgemma-9b's local layer): {route} "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms ({backend}); bound "
        f"{bound:.4f} ms ({by}: {nbytes:.4e} B, {flops:.4e} flops at 989 TFLOP/s), on the "
        f"float32 CUDA cores {bound_f32:.4f} ms")
    return dict(shape=FLASH_RG, route=route, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_backend=backend, bound_ms=bound, bound_by=by, bound_float32_ms=bound_f32,
                bytes=nbytes, flops=flops)


def flash_shape_times(fa_mod, case, name: str) -> dict:
    """#7 at a model's layer shape (bf16, no window) timed with CUDA events
    beside its bound (4·Dh flops a visible pair at the bf16 peak, or the
    bytes), the plain version and SDPA (``enable_gqa``)."""
    B, Hq, Hkv, Sq, Sk, Dh, causal, window = case
    q, k, v = flash_operands(case, torch.bfloat16)
    out = torch.empty_like(q)
    route = fa_mod.route(q.dtype, Dh)
    ms = cuda_ms(lambda: fa_mod.launch(q, k, v, out, causal=causal, window=window,
                                       scale=Dh ** -0.5), reps=20)
    plain_ms = cuda_ms(lambda: fa_mod.flash_attention_plain(q, k, v, causal=causal), reps=3)
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True), reps=20)
    nbytes, flops = flash_cost(*case, itemsize=2)
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    bound, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    log(f"[time] flash_attention {case} bf16 ({name}): {route} kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms; bound {bound:.4f} ms ({by}: {nbytes:.4e} B, "
        f"{flops:.4e} flops at 989 TFLOP/s)")
    del q, k, v, out
    return dict(shape=case, route=route, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)


def control_shares(fa_mod, q, k, v, want, case) -> dict:
    """The bitwise check's controls on the same operands: the share of bf16
    outputs equal to the rounded float32 result for the wgmma route's
    numerics in plain PyTorch, with p split (must pass the limit) and with
    p rounded once to bf16 (must fall below it)."""
    _, _, _, _, _, _, causal, window = case
    shares = {}
    for split in (True, False):
        emu = fa_mod.tensor_core_emulation(q, k, v, causal=causal, window=window, split=split)
        shares["split" if split else "single"] = float((emu.bfloat16() == want).float().mean())
        del emu
    log(f"[check] flash_attention {case} bitwise-share controls (emulation): p split "
        f"{shares['split']:.6f}, p rounded once {shares['single']:.6f}; limit "
        f"{fa_mod.BITWISE_SHARE_MIN}")
    if not shares["split"] >= fa_mod.BITWISE_SHARE_MIN > shares["single"]:
        raise AssertionError(f"the bitwise-share limit does not separate split from single "
                             f"p: {shares}")
    return shares


def timed(fn) -> tuple[object, float]:
    """(result, host-clock ms) of ``fn()`` ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def top1_agreement(a, b, vocab) -> float:
    return float((a[..., :vocab].argmax(-1) == b[..., :vocab].argmax(-1)).float().mean())


def lm_phase(counters, fa_mod) -> dict:
    """Phases 6b and 6c: llama3.2-3b's forward with impl="flash" and its
    greedy server, at full width with random weights (seed 0)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as lm_launch
    from repro_torch.models.lm.api import build
    from repro_torch.serve import engine
    from repro_torch.tree import tree_leaves, tree_unflatten

    cfg = get_config(LM_ARCH)
    api = build(cfg)
    res = {}
    params, res["init_ms"] = timed(
        lambda: api.init(torch.Generator(device="cuda").manual_seed(0), device="cuda"))
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[lm] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads} x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"{n_params} parameters ({cfg.param_dtype}), compute {cfg.dtype}; init {res['init_ms']:.1f} ms")
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (LM_BATCH, LM_SEQ)),
                           dtype=torch.int32, device="cuda")

    # b. the main path: counters zeroed just before the forward, read just after
    by_route = fa_mod.flash_attention.launches_by_route
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    for r in by_route:
        by_route[r] = 0
    (logits, _), cold_ms = timed(lambda: api.forward(params, toks, impl="flash"))
    launches = {k: fn.launches for k, fn in counters.items()}
    routes = dict(by_route)
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in counters} | {"flash_attention": cfg.num_layers}
    if launches != want or routes != {"wgmma": cfg.num_layers, "cuda_cores": 0}:
        raise AssertionError(f"LM forward launches {launches}, by route {routes}; expected "
                             f"{want}, all {cfg.num_layers} on the wgmma route")
    if logits.shape != (LM_BATCH, LM_SEQ, 128256) or not torch.isfinite(logits).all():
        raise AssertionError(f"LM logits {tuple(logits.shape)} or non-finite")
    steady = [timed(lambda: api.forward(params, toks, impl="flash"))[1] for _ in range(3)]
    prof = profiled(lambda: api.forward(params, toks, impl="flash"), 2)
    res["forward"] = dict(launches=launches, launches_by_route=routes, cold_ms=cold_ms,
                          steady_ms=steady, peak_mem_bytes=peak, profiled=prof)
    tokens_s = LM_BATCH * LM_SEQ / (float(np.median(steady)) / 1e3)
    log(f"[lm forward] flash, B={LM_BATCH} S={LM_SEQ}: launches={json.dumps(launches)}, #7 by "
        f"route {json.dumps(routes)}; ms cold "
        f"{cold_ms:.3f}, steady median {float(np.median(steady)):.3f} "
        f"({['%.3f' % t for t in steady]}), {tokens_s:.1f} tokens/s, peak mem {peak / 2**30:.3f} GiB")
    log(f"[lm forward] 2 forwards under the profiler: {['%.3f' % t for t in prof['steps_ms']]} ms, "
        f"device busy {prof['device_busy_ms']:.3f} of {prof['device_wall_ms']:.3f} ms, idle share "
        f"{prof['device_idle_share']:.4f}")
    for k in prof["top_kernels"][:6]:
        log(f"[lm forward]   {k['device_ms']:9.3f} ms x{k['calls']:<4d} {k['name']}")
    (xla, _), xla_ms = timed(lambda: api.forward(params, toks, impl="xla"))
    agree = top1_agreement(logits, xla, cfg.vocab_size)
    dmax = float((logits.float() - xla.float()).abs().max())
    # Random weights give near-flat logits, so bf16 rounding alone moves many
    # top-1 tokens; the float32-compute forward (impl "xla", the plain path)
    # is the yardstick both bf16 paths are held against: flash's logits must
    # be at least as close to it (root-mean-square) as the plain path's.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    api32 = build(cfg32)
    exact, _ = api32.forward(params, toks, impl="xla")
    to_exact = {name: dict(top1_agreement=top1_agreement(lg, exact, cfg.vocab_size),
                           max_abs_diff=float((lg.float() - exact).abs().max()),
                           rms_diff=float((lg.float() - exact).square().mean().sqrt()))
                for name, lg in (("flash", logits), ("xla", xla))}
    res["flash_vs_xla_bf16"] = dict(top1_agreement=agree, max_abs_diff=dmax, xla_ms=xla_ms,
                                    vs_float32=to_exact)
    log(f"[check] LM forward flash vs xla, bf16: top-1 agreement {agree:.6f}, max |d| {dmax:.4e}; "
        f"xla forward {xla_ms:.3f} ms")
    for name, d in to_exact.items():
        log(f"[check] {name} (bf16) against the float32-compute forward: top-1 agreement "
            f"{d['top1_agreement']:.6f}, max |d| {d['max_abs_diff']:.4e}, rms {d['rms_diff']:.4e}")
    if not to_exact["flash"]["rms_diff"] <= to_exact["xla"]["rms_diff"]:
        raise AssertionError(f"the flash forward is further from float32 than xla's: {to_exact}")
    del logits, xla, exact

    before = dict(by_route)
    (f32, _), f32_ms = timed(lambda: api32.forward(params, toks[:, :LM_SEQ_F32], impl="flash"))
    f32_routes = {r: by_route[r] - before[r] for r in by_route}
    if f32_routes != {"wgmma": 0, "cuda_cores": cfg.num_layers}:
        raise AssertionError(f"float32 LM forward: #7 by route {f32_routes}, expected all "
                             f"{cfg.num_layers} on cuda_cores")
    x32, _ = api32.forward(params, toks[:, :LM_SEQ_F32], impl="xla")
    d32 = float((f32 - x32).abs().max())
    torch.testing.assert_close(f32, x32, atol=1e-3, rtol=1e-3,
                               msg=lambda m: f"float32 forward flash vs xla: {m}")
    res["flash_vs_xla_f32"] = dict(max_abs_diff=d32, flash_ms=f32_ms, launches_by_route=f32_routes)
    log(f"[check] LM forward flash vs xla, float32 compute, S={LM_SEQ_F32}: max |d| {d32:.4e} "
        f"(atol=rtol=1e-3); flash forward {f32_ms:.3f} ms; #7 by route {json.dumps(f32_routes)}")
    del f32, x32

    # c. serving: 4 prompts of 8 tokens, 16 new tokens each
    prompts = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 8)),
                              dtype=torch.int32, device="cuda")
    steps, cache_len = 16, 8 + 16 + 1
    before = fa_mod.flash_attention.launches
    # room for two more steps under the profiler after the 16
    state = engine.init_serve_state(api, 4, cache_len + 2, dtype=torch.bfloat16, device="cuda")
    prefill, step = engine.make_prefill(api), engine.make_serve_step(api)
    (lg, state), prefill_ms = timed(lambda: prefill(params, state, prompts))
    toks_out, step_ms = [], []
    for _ in range(steps):
        tok = lg[:, : cfg.vocab_size].argmax(-1).to(torch.int32)
        toks_out.append(tok)
        (lg, state), ms = timed(lambda: step(params, state, tok[:, None]))
        step_ms.append(ms)
    gen = torch.stack(toks_out, 1)
    if not torch.isfinite(lg).all() or gen.shape != (4, steps) or state.cache_pos != cache_len - 1:
        raise AssertionError("bf16 serving: non-finite logits or wrong shapes")
    flash_launches = fa_mod.flash_attention.launches - before
    box = [state]

    def one_step():
        box[0] = step(params, box[0], gen[:, -1:])[1]

    prof = profiled(one_step, 2)
    res["serve_bf16"] = dict(prefill_ms=prefill_ms, step_ms=step_ms,
                             tokens_s=4 * steps / (sum(step_ms) / 1e3),
                             flash_launches=flash_launches, profiled=prof, tokens=gen.tolist())
    log(f"[lm serve bf16] 4 prompts x 8 tokens, 16 new each, bf16 caches: prefill {prefill_ms:.3f} "
        f"ms, decode step median {float(np.median(step_ms)):.3f} ms, "
        f"{res['serve_bf16']['tokens_s']:.1f} tokens/s; #7 launches {flash_launches}")
    log(f"[lm serve bf16] 2 decode steps under the profiler: {['%.3f' % t for t in prof['steps_ms']]} "
        f"ms, device busy {prof['device_busy_ms']:.3f} of {prof['device_wall_ms']:.3f} ms, idle "
        f"share {prof['device_idle_share']:.4f}")
    for k in prof["top_kernels"][:4]:
        log(f"[lm serve bf16]   {k['device_ms']:9.3f} ms x{k['calls']:<4d} {k['name']}")

    try:
        engine.greedy_generate(api, params, prompts, steps=1, cache_len=10)
    except ValueError as e:
        log(f"[lm serve] greedy_generate at bf16 refuses, as the reference's fails: {str(e)[:90]}...")
    else:
        raise AssertionError("greedy_generate accepted a bfloat16-compute config")
    outs = []
    for _ in range(2):
        out, ms = timed(lambda: engine.greedy_generate(api32, params, prompts, steps=steps,
                                                       cache_len=cache_len))
        outs.append((out, ms))
    if not torch.equal(outs[0][0], outs[1][0]):
        raise AssertionError("greedy_generate (float32) twice gave different tokens")
    state = engine.init_serve_state(api32, 4, cache_len, dtype=torch.float32, device="cuda")
    (last, state), _ = timed(lambda: engine.make_prefill(api32)(params, state, prompts))
    ref, _ = api32.forward(params, prompts, impl="flash")
    ddf = float((last - ref[:, -1]).abs().max())
    torch.testing.assert_close(last, ref[:, -1], atol=1e-3, rtol=1e-3,
                               msg=lambda m: f"decode == forward (float32, full width): {m}")
    twin = engine.ServeState(tree_unflatten(state.caches, [t.clone() for t in tree_leaves(state.caches)]),
                             state.cache_pos)
    nxt = outs[0][0][:, :1]
    a, _ = engine.make_serve_step(api32)(params, state, nxt)
    b, _ = engine.make_serve_step(api32)(params, twin, nxt)
    if not torch.equal(a, b):
        raise AssertionError("a float32 decode step twice from one state differs")
    res["greedy_f32"] = dict(ms=[o[1] for o in outs], tokens_s=4 * steps / (outs[1][1] / 1e3),
                             decode_vs_forward_max_abs_diff=ddf, tokens=outs[0][0].tolist())
    log(f"[lm serve f32] greedy_generate (float32 compute, float32 caches): {outs[1][1]:.3f} ms "
        f"for 4 x {steps} tokens after an 8-token prefill, {res['greedy_f32']['tokens_s']:.1f} "
        f"tokens/s; twice the same tokens; a decode step twice from one state bitwise equal")
    log(f"[check] decode == forward, float32, full width: prefill's last logits vs forward(flash) "
        f"max |d| {ddf:.4e} (atol=rtol=1e-3)")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lm_launch.main(["--arch", LM_ARCH, "--smoke"])
    lines = buf.getvalue().splitlines()
    if not lines or not lines[0].startswith(f"{LM_ARCH}: 64 tokens in"):
        raise AssertionError(f"launcher: {lines}")
    log(f"[launcher] serve --smoke on the card: {lines[0]}")
    return res


# -- phases 6d-6f: the MoE decoders at full width, the continuous batcher -------------

# layers run of dbrx's 40 and grok's 64: their bf16 weights (54.6 and 41.0 GB)
# must fit the card's 80 GB beside a B = 2, S = 4096 forward
MOE_LAYERS = {"dbrx-132b": 8, "grok-1-314b": 4}
# (prompt length, max_new) of the batcher's 7 requests on 4 slots: slots are reused
BATCH_JOBS = [(3, 16), (12, 4), (7, 9), (5, 12), (10, 6), (4, 14), (9, 8)]
BATCH_SLOTS, BATCH_CACHE = 4, 32
GREEDY_TIE = 1e-4  # top-two logits closer than this may order either way in two runs


def kernel_counters() -> dict:
    """Every kernel wrapper's launch counter, by the main path's names."""
    mg = importlib.import_module("repro_torch.kernels.seg_gat_agg_multigraph")
    ff = importlib.import_module("repro_torch.kernels.seg_gat_agg_fused_fp")
    return {"multigraph": mg.seg_gat_agg_multigraph_fwd,
            "multigraph_bwd": mg.seg_gat_agg_multigraph_bwd,
            "fused_fp": ff.seg_gat_agg_fused_fp_fwd, "fused_fp_bwd": ff.seg_gat_agg_fused_fp_bwd,
            "seg_gat_agg": importlib.import_module("repro_torch.kernels.seg_gat_agg").seg_gat_agg,
            "fused_fp_coeff": importlib.import_module(
                "repro_torch.kernels.fused_fp_coeff").fused_fp_coeff,
            "flash_attention": importlib.import_module(
                "repro_torch.kernels.flash_attention").flash_attention}


def stacked(routes, field: str, rows=slice(None)):
    """A field of each layer's ``moe.Routing``, stacked: [L, rows, ...]."""
    return torch.stack([getattr(r, field)[rows] for r in routes])


def upstream_free(flipped: torch.Tensor) -> torch.Tensor:
    """flipped [L, S] (one row's route flips between two runs) -> the flips
    with no flip upstream: none in an earlier layer at this or an earlier
    token.  A route reads its token's hidden state, which every earlier
    layer's outputs at this and earlier tokens shape (attention is
    causal), so a flipped expert upstream moves it far beyond rounding;
    a flip with none upstream sees two hidden states that differ by the
    two attention paths' roundings alone, and must be a near-tie."""
    n_layers, seq = flipped.shape
    first = torch.where(flipped.any(1), flipped.int().argmax(1), seq)  # each layer's first flip
    upstream = torch.cat([first.new_full((1,), seq), torch.cummin(first, 0).values[:-1]])
    return flipped & (torch.arange(seq, device=flipped.device) < upstream[:, None])


def moe_smoke_card_vs_cpu(arch: str) -> dict:
    """The MoE decoder's smoke config (float32, 4 experts top-2) at S = 64 and
    half the default capacity, flash on the card against the CPU: every
    (layer, token) route the same experts or a near-tie in both runs, logits
    at 1e-4 on the tokens whose routes agree in every layer, aux at 1e-5."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.lm import moe
    from repro_torch.models.lm.api import build
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(smoke_config(arch), moe_capacity_factor=0.5)
    api = build(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(1))
    card, cpu = [], []
    got, aux = api.forward(tree_map(lambda t: t.cuda(), params), toks.cuda(), impl="flash",
                           routes=card)
    want, want_aux = api.forward(params, toks, impl="flash", routes=cpu)
    flipped, unexplained = moe.route_flips(stacked(card, "expert_ids").cpu(),
                                           stacked(card, "gap").cpu(), stacked(cpu, "expert_ids"),
                                           stacked(cpu, "gap"), torch.float32)
    if unexplained.any():
        raise AssertionError(f"{arch} smoke, card vs CPU: routes flipped beyond a near-tie at "
                             f"(layer, row, token) {unexplained.nonzero().tolist()}")
    agree = ~flipped.any(0)
    d = float((got.cpu()[agree] - want[agree]).abs().max())
    torch.testing.assert_close(got.cpu()[agree], want[agree], atol=1e-4, rtol=1e-4,
                               msg=lambda m: f"{arch} smoke, card vs CPU: {m}")
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-5, rtol=1e-5)
    dropped = float(sum(int((~r.keep).sum()) for r in cpu)) / sum(r.keep.numel() for r in cpu)
    log(f"[check] {arch} smoke (float32, S=64, capacity factor 0.5: {dropped:.4f} of copies "
        f"dropped) flash on the card vs the CPU: {int(flipped.sum())} routes flipped (near-ties), "
        f"logits max |d| {d:.3e} (atol=rtol=1e-4) on {int(agree.sum())} of {agree.numel()} "
        f"tokens, aux {float(aux):.6f} vs {float(want_aux):.6f}")
    return dict(flipped=int(flipped.sum()), max_abs_diff=d, dropped_share=dropped)


def moe_lm_phase(arch: str, counters: dict, fa_mod) -> dict:
    """Phase 6d (dbrx-132b) or 6e (grok-1-314b): the MoE decoder at full width,
    ``MOE_LAYERS[arch]`` of its layers, random bf16 weights (seed 0), bf16
    compute: the forward with impl="flash" at B = 2, S = 4096, counters
    zeroed just before; the forward twice bitwise equal; flash against xla
    on row 0 (the cap-free config: flash has no soft cap); the bf16 serving
    path; and the smoke config on the card against the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import moe
    from repro_torch.models.lm.api import build
    from repro_torch.models.lm.layers import silu
    from repro_torch.models.lm.transformer import vocab_padded
    from repro_torch.serve import engine
    from repro_torch.tree import tree_leaves

    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=MOE_LAYERS[arch])
    api = build(cfg)
    tag = f"[{arch}]"
    res = dict(layers=cfg.num_layers, of_layers=full.num_layers, batch=LM_BATCH, seq=LM_SEQ)
    torch.cuda.reset_peak_memory_stats()
    params, res["init_ms"] = timed(
        lambda: api.init(torch.Generator(device="cuda").manual_seed(0), device="cuda"))
    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in tree_leaves(tree))  # noqa: E731
    res.update(params=sum(t.numel() for t in tree_leaves(params)), weight_bytes=nbytes(params),
               expert_bytes=nbytes({k: v for k, v in params["scan"]["pos0"]["moe"].items()
                                    if k != "router"}),
               capacity=moe._capacity(cfg, LM_SEQ), init_peak_bytes=torch.cuda.max_memory_allocated())
    log(f"{tag} {cfg.num_layers} of {full.num_layers} layers (cut: the bf16 weights must fit one "
        f"card), d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} x {cfg.head_dim}, "
        f"{cfg.num_experts} experts of d_ff {cfg.d_ff}, top-{cfg.experts_per_tok}, vocab "
        f"{cfg.vocab_size} ({'tied' if cfg.tie_embeddings else 'untied'}), soft cap "
        f"{cfg.logits_soft_cap}; {res['params']} parameters ({res['weight_bytes'] / 1e9:.3f} GB "
        f"{cfg.param_dtype}, experts {res['expert_bytes'] / 1e9:.3f} GB), compute {cfg.dtype}; "
        f"capacity {res['capacity']} slots an expert a row at S={LM_SEQ}; init "
        f"{res['init_ms']:.1f} ms, peak {res['init_peak_bytes'] / 2**30:.3f} GiB")
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (LM_BATCH, LM_SEQ)),
                           dtype=torch.int32, device="cuda")

    # the main path: counters zeroed just before the forward, read just after
    by_route = fa_mod.flash_attention.launches_by_route
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    for r in by_route:
        by_route[r] = 0
    routes = []
    (logits, aux), cold_ms = timed(lambda: api.forward(params, toks, impl="flash", routes=routes))
    launches = {k: fn.launches for k, fn in counters.items()}
    launch_routes = dict(by_route)
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in counters} | {"flash_attention": cfg.num_layers}
    if launches != want or launch_routes != {"wgmma": cfg.num_layers, "cuda_cores": 0}:
        raise AssertionError(f"{arch} forward launches {launches}, by route {launch_routes}; "
                             f"expected {want}, all {cfg.num_layers} on the wgmma route")
    if (logits.shape != (LM_BATCH, LM_SEQ, vocab_padded(cfg)) or not torch.isfinite(logits).all()
            or not math.isfinite(float(aux)) or len(routes) != cfg.num_layers):
        raise AssertionError(f"{arch} logits {tuple(logits.shape)}, aux {float(aux)}, "
                             f"{len(routes)} routings")
    keep = stacked(routes, "keep")
    dropped = 1.0 - float(keep.float().mean())
    dropped_by_layer = [1.0 - float(r.keep.float().mean()) for r in routes]
    empty = 1.0 - float((stacked(routes, "table") >= 0).float().mean())
    again = []
    logits2, aux2 = api.forward(params, toks, impl="flash", routes=again)
    if not (torch.equal(logits, logits2) and torch.equal(aux, aux2) and all(
            torch.equal(a.table, b.table) for a, b in zip(routes, again))):
        raise AssertionError(f"{arch}: two forwards on the same inputs differ")
    del logits2, again
    steady = [timed(lambda: api.forward(params, toks, impl="flash"))[1] for _ in range(2)]
    prof = profiled(lambda: api.forward(params, toks, impl="flash"), 2)
    tokens_s = LM_BATCH * LM_SEQ / (float(np.median(steady)) / 1e3)
    # the expert FFNs of one layer alone (dense over all E · B·cap slots, as
    # the reference's einsums): their share of the forward, and how much of
    # it the empty slots take
    w = {k: v[0] for k, v in params["scan"]["pos0"]["moe"].items()}
    xin = torch.randn((cfg.num_experts, LM_BATCH * res["capacity"], cfg.d_model),
                      generator=torch.Generator(device="cuda").manual_seed(3), device="cuda",
                      dtype=torch.bfloat16)
    expert_ms = cuda_ms(lambda: torch.bmm(silu(torch.bmm(xin, w["w_gate"]))
                                          * torch.bmm(xin, w["w_up"]), w["w_down"]), reps=5)
    del xin, w
    expert_share = expert_ms * cfg.num_layers / float(np.median(steady))
    res["forward"] = dict(launches=launches, launches_by_route=launch_routes, cold_ms=cold_ms,
                          steady_ms=steady, tokens_s=tokens_s, peak_mem_bytes=peak,
                          profiled=prof, aux=float(aux), dropped_share=dropped,
                          dropped_share_by_layer=dropped_by_layer, empty_slot_share=empty,
                          expert_ffn_layer_ms=expert_ms, expert_ffn_share=expert_share)
    log(f"{tag} forward flash, B={LM_BATCH} S={LM_SEQ}: launches={json.dumps(launches)}, #7 by "
        f"route {json.dumps(launch_routes)}; ms cold {cold_ms:.3f}, steady median "
        f"{float(np.median(steady)):.3f} ({['%.3f' % t for t in steady]}), {tokens_s:.1f} tokens/s, "
        f"peak mem {peak / 2**30:.3f} GiB; twice bitwise equal (logits, aux, dispatch tables)")
    log(f"{tag} aux loss {float(aux):.6f} (sum of {cfg.num_layers} layers); dropped share of "
        f"copies {dropped:.6f} (by layer {['%.4f' % x for x in dropped_by_layer]}); empty "
        f"capacity slots {empty:.4f}")
    log(f"{tag} one layer's expert FFNs over all {cfg.num_experts} x {LM_BATCH * res['capacity']} "
        f"slots: {expert_ms:.3f} ms (CUDA events), x {cfg.num_layers} layers = {expert_share:.4f} "
        f"of the steady forward; the empty slots' part of it {empty * expert_share:.4f}")
    log(f"{tag} 2 forwards under the profiler: {['%.3f' % t for t in prof['steps_ms']]} ms, device "
        f"busy {prof['device_busy_ms']:.3f} of {prof['device_wall_ms']:.3f} ms, idle share "
        f"{prof['device_idle_share']:.4f}")
    for k in prof["top_kernels"][:6]:
        log(f"{tag}   {k['device_ms']:9.3f} ms x{k['calls']:<4d} {k['name']}")

    # flash against xla on row 0 (each row routes alone): the cap-free config,
    # since impl "flash" has no soft cap (ROADMAP Queue 3)
    xroutes = []
    (xla, _), xla_ms = timed(lambda: build(dataclasses.replace(cfg, logits_soft_cap=None)).forward(
        params, toks[:1], impl="xla", routes=xroutes))
    flipped, unexplained = moe.route_flips(stacked(routes, "expert_ids", slice(0, 1)),
                                           stacked(routes, "gap", slice(0, 1)),
                                           stacked(xroutes, "expert_ids"), stacked(xroutes, "gap"),
                                           torch.bfloat16)
    flipped, unexplained = flipped[:, 0], unexplained[:, 0]  # [L, S]
    free = upstream_free(flipped)
    flips, free_flips = flipped.sum(1).tolist(), free.sum(1).tolist()
    beyond, free_beyond = unexplained.sum(1).tolist(), (unexplained & free).sum(1).tolist()
    gaps = torch.maximum(stacked(routes, "gap", slice(0, 1)), stacked(xroutes, "gap"))[:, 0]
    agree = ~flipped.any(0)
    lg0, x0 = logits[0][agree][:, : cfg.vocab_size], xla[0][agree][:, : cfg.vocab_size]
    top1 = float((lg0.argmax(-1) == x0.argmax(-1)).float().mean())
    dmax = float((lg0.float() - x0.float()).abs().max())
    res["flash_vs_xla_row0"] = dict(
        flipped_by_layer=flips, beyond_near_tie_by_layer=beyond,
        upstream_free_by_layer=free_flips, upstream_free_beyond_by_layer=free_beyond,
        largest_upstream_free_gap=float(gaps[free].max()) if free.any() else 0.0,
        largest_flip_gap=float(gaps[flipped].max()) if flipped.any() else 0.0,
        tokens_agreeing=int(agree.sum()), top1_agreement=top1, max_abs_diff=dmax, xla_ms=xla_ms)
    log(f"{tag} flash vs xla (row 0, cap-free), bf16: routes flipped by layer {flips} of {LM_SEQ} "
        f"(beyond the near-tie limit, {moe.NEAR_TIE[torch.bfloat16]:.4g} in logits: {beyond}; "
        f"largest gap {res['flash_vs_xla_row0']['largest_flip_gap']:.4e}); with no flip upstream "
        f"(no earlier layer flipped this or an earlier token): {free_flips}, beyond the limit "
        f"{free_beyond}, largest gap {res['flash_vs_xla_row0']['largest_upstream_free_gap']:.4e}; "
        f"on the {int(agree.sum())} tokens routed alike in every layer top-1 agreement "
        f"{top1:.6f}, max |d| {dmax:.4e}; xla forward {xla_ms:.3f} ms")
    if any(free_beyond):
        raise AssertionError(f"{arch}: flash and xla routes with no flip upstream differ beyond "
                             f"a near-tie: {free_beyond} by layer")
    del logits, xla, lg0, x0, routes, xroutes

    # the bf16 serving path: 4 prompts of 8 tokens, 16 new each, bf16 caches
    prompts = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 8)),
                              dtype=torch.int32, device="cuda")
    steps, cache_len = 16, 8 + 16 + 1
    before = fa_mod.flash_attention.launches
    state = engine.init_serve_state(api, 4, cache_len + 2, dtype=torch.bfloat16, device="cuda")
    prefill, step = engine.make_prefill(api), engine.make_serve_step(api)
    (lg, state), prefill_ms = timed(lambda: prefill(params, state, prompts))
    toks_out, step_ms = [], []
    for _ in range(steps):
        tok = lg[:, : cfg.vocab_size].argmax(-1).to(torch.int32)
        toks_out.append(tok)
        (lg, state), ms = timed(lambda: step(params, state, tok[:, None]))
        step_ms.append(ms)
    gen = torch.stack(toks_out, 1)
    if not torch.isfinite(lg).all() or gen.shape != (4, steps) or state.cache_pos != cache_len - 1:
        raise AssertionError(f"{arch} bf16 serving: non-finite logits or wrong shapes")
    if fa_mod.flash_attention.launches != before:
        raise AssertionError(f"{arch} bf16 serving launched #7 (decode attends in plain PyTorch)")
    box = [state]

    def one_step():
        box[0] = step(params, box[0], gen[:, -1:])[1]

    dprof = profiled(one_step, 2)
    # a decode step reads every weight once (all experts: the empty capacity
    # slots are computed too), but of an untied embedding only its 4 rows
    embed = params["embed"]
    read = res["weight_bytes"] - (0 if cfg.tie_embeddings
                                  else embed.numel() * embed.element_size()
                                  - 4 * cfg.d_model * embed.element_size())
    step_med = float(np.median(step_ms))
    res["serve_bf16"] = dict(prefill_ms=prefill_ms, step_ms=step_ms, step_median_ms=step_med,
                             tokens_s=4 * steps / (sum(step_ms) / 1e3), profiled=dprof,
                             step_bytes=read, step_bound_ms=read / PEAK_HBM_BYTES * 1e3,
                             tokens=gen.tolist())
    log(f"{tag} serve bf16: 4 prompts x 8 tokens, 16 new each, bf16 caches: prefill "
        f"{prefill_ms:.3f} ms, decode step median {step_med:.3f} ms, "
        f"{res['serve_bf16']['tokens_s']:.1f} tokens/s; a step reads {read / 1e9:.3f} GB of "
        f"weights: bound {res['serve_bf16']['step_bound_ms']:.3f} ms at 3.35 TB/s")
    log(f"{tag} 2 decode steps under the profiler: {['%.3f' % t for t in dprof['steps_ms']]} ms, "
        f"device busy {dprof['device_busy_ms']:.3f} of {dprof['device_wall_ms']:.3f} ms, idle "
        f"share {dprof['device_idle_share']:.4f}")
    for k in dprof["top_kernels"][:4]:
        log(f"{tag}   {k['device_ms']:9.3f} ms x{k['calls']:<4d} {k['name']}")
    del params, state, box, lg
    res["smoke_card_vs_cpu"] = moe_smoke_card_vs_cpu(arch)
    return res


def greedy_margins(api, params, prompt, steps: int, cache_len: int) -> tuple[list, list]:
    """``greedy_generate``'s path step by step on one prompt: (tokens, the
    gap between the top two logits at each generated position)."""
    from repro_torch.serve import engine

    state = engine.init_serve_state(api, 1, cache_len, dtype=torch.float32, device="cuda")
    lg, state = engine.make_prefill(api)(params, state, prompt)
    toks, margins = [], []
    for _ in range(steps):
        top2 = lg[0, : api.cfg.vocab_size].topk(2).values
        margins.append(float(top2[0] - top2[1]))
        toks.append(int(lg[0, : api.cfg.vocab_size].argmax()))
        lg, state = engine.make_serve_step(api)(params, state, torch.tensor(
            [[toks[-1]]], dtype=torch.int32, device="cuda"))
    return toks, margins


def batcher_phase() -> dict:
    """Phase 6f: the continuous batcher on llama3.2-3b at full width with
    float32 compute (its caches are float32, as the reference's), 4 slots,
    7 requests (prompt lengths 3-12, max_new 4-16: slots reused
    mid-stream), cache_len 32; each request's tokens held against its own
    ``greedy_generate`` run: equal, or first different where that run's top
    two logits lie within GREEDY_TIE; the bf16 config refused; the
    launcher's dbrx-132b --smoke run on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as lm_launch
    from repro_torch.models.lm.api import build
    from repro_torch.serve import ContinuousBatcher, Request, engine

    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    api = build(cfg)
    params = api.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    rng = np.random.default_rng(2)
    jobs = [(rng.integers(0, cfg.vocab_size, n).tolist(), m) for n, m in BATCH_JOBS]
    cb = ContinuousBatcher(api, BATCH_SLOTS, BATCH_CACHE, params, device="cuda")
    for i, (p, m) in enumerate(jobs):
        cb.submit(Request(rid=i, prompt=p, max_new=m))
    steps, admitted = 0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while cb.queue or any(r is not None for r in cb.slot_req):
        queued = len(cb.queue)
        cb.step()
        admitted += queued - len(cb.queue)
        steps += 1
    wall = time.perf_counter() - t0
    new_tokens = sum(m for _, m in BATCH_JOBS)
    got = {r.rid: r.out for r in cb.finished}
    if sorted(got) != list(range(len(jobs))) or admitted != len(jobs):
        raise AssertionError(f"batcher: finished {sorted(got)}, admitted {admitted}")
    res = dict(steps=steps, wall_s=wall, tokens_s=new_tokens / wall, new_tokens=new_tokens,
               requests={})
    for i, (p, m) in enumerate(jobs):
        seq = engine.greedy_generate(api, params, torch.tensor([p], dtype=torch.int32,
                                                                device="cuda"),
                                     steps=m, cache_len=BATCH_CACHE)[0].tolist()
        first = next((t for t in range(m) if got[i][t] != seq[t]), None)
        entry = dict(prompt_len=len(p), max_new=m, equal=first is None)
        if first is not None:  # a near-tie of the sequential run may order either way
            toks, margins = greedy_margins(api, params, torch.tensor([p], dtype=torch.int32,
                                                                      device="cuda"), m, BATCH_CACHE)
            if toks != seq or not margins[first] < GREEDY_TIE:
                raise AssertionError(f"batcher request {i}: tokens {got[i]} first differ from "
                                     f"greedy_generate's {seq} at {first}, top-two margin "
                                     f"{margins[first]:.3e}")
            entry.update(first_difference=first, margin=margins[first])
            log(f"[batcher] request {i}: first differs from greedy_generate at position {first}, "
                f"a near-tie there (top-two logits {margins[first]:.3e} apart)")
        res["requests"][i] = entry
    n_equal = sum(e["equal"] for e in res["requests"].values())
    log(f"[batcher] {LM_ARCH} float32 at full width, {BATCH_SLOTS} slots, {len(jobs)} requests "
        f"(prompt lengths {[n for n, _ in BATCH_JOBS]}, max_new {[m for _, m in BATCH_JOBS]}), "
        f"cache_len {BATCH_CACHE}: {steps} steps, {new_tokens} new tokens in {wall:.3f} s, "
        f"{res['tokens_s']:.1f} tokens/s; {n_equal} of {len(jobs)} requests equal to their own "
        f"greedy_generate run, the rest first differ at a near-tie (< {GREEDY_TIE})")
    del cb, params
    try:
        ContinuousBatcher(build(get_config(LM_ARCH)), BATCH_SLOTS, BATCH_CACHE, None,
                          device="cuda")
    except ValueError as e:
        log(f"[batcher] the bf16-compute config refused, as the reference's step fails: "
            f"{str(e)[:90]}...")
    else:
        raise AssertionError("the batcher accepted a bfloat16-compute config")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lm_launch.main(["--arch", "dbrx-132b", "--smoke"])
    lines = buf.getvalue().splitlines()
    if not lines or not lines[0].startswith("dbrx-132b: 64 tokens in"):
        raise AssertionError(f"launcher: {lines}")
    log(f"[launcher] serve --arch dbrx-132b --smoke on the card: {lines[0]}")
    res["launcher"] = lines[0]
    return res


def lm_alone(name: str, run) -> dict:
    """Builds #7 (its ptxas report checked), runs ``run()`` and writes its
    result to chiprun_out/<name>.json."""
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(card_line())
    OUT.mkdir(exist_ok=True)
    check_ptxas(build.build(("flash_attention",)))
    res = run()
    res["card"] = card_line()
    (OUT / f"{name}.json").write_text(json.dumps(res, indent=1, default=str))
    log(res["card"])
    return res


def moe_alone() -> dict:
    """Phases 6d and 6e on their own (``python3 -c 'import chip_smoke as c;
    c.moe_alone()'``): dbrx-132b, then grok-1-314b; chiprun_out/moe.json."""
    fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")

    def run():
        out = {}
        for arch in MOE_LAYERS:
            out[arch] = moe_lm_phase(arch, kernel_counters(), fa_mod)
            torch.cuda.empty_cache()
        return out

    return lm_alone("moe", run)


def batcher_alone() -> dict:
    """Phase 6f on its own (``python3 -c 'import chip_smoke as c;
    c.batcher_alone()'``); chiprun_out/batcher.json."""
    return lm_alone("batcher", batcher_phase)


# -- phases 6g-6h: the recurrent decoders at full width and depth ----------------------

RECURRENT_ARCHS = ("mamba2-2.7b", "recurrentgemma-9b")
# rows of the float32-compute yardstick forward: recurrentgemma's float32 logits
# (4.2 GB a row at its 256,000 vocab) must fit beside 37.6 GB of float32 weights
# and the two bf16 forwards' logits
F32_ROWS = {"mamba2-2.7b": LM_BATCH, "recurrentgemma-9b": 1}
DECODE_TOKENS = 64  # decode == forward at full width, float32 compute
DECODE_TOL = 1e-3   # as llama's prefill check (phase 6c)
CACHE_LENS = (4096, 524288)  # the reference's train_4k and long_500k contexts


def rowwise_max_abs(a, b) -> float:
    """max |a - b| in float32, one row of the batch at a time."""
    return max(float((a[i].float() - b[i].float()).abs().max()) for i in range(a.shape[0]))


def rowwise_rms(a, b) -> float:
    """Root-mean-square of a - b in float32, one row at a time."""
    total = sum(float((a[i].float() - b[i].float()).square().sum()) for i in range(a.shape[0]))
    return math.sqrt(total / a.numel())


def recurrent_block_time(arch: str, cfg, params) -> dict:
    """The recurrent core of one layer alone at the forward's shape (B = 2,
    S = 4096), CUDA events: mamba2's ``_ssd_chunked`` (float32, chunk 128),
    or the RG-LRU's ``_gates`` (two float32 rw x rw products a token) and
    its doubling scan.  The forward's layers times this is that core's share."""
    from repro_torch.models.lm import rglru, ssm

    gen = torch.Generator(device="cuda").manual_seed(4)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    if arch == "mamba2-2.7b":
        h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        xh, bm, cm = rnd(LM_BATCH, LM_SEQ, h, p), rnd(LM_BATCH, LM_SEQ, n), rnd(LM_BATCH, LM_SEQ, n)
        dt = torch.nn.functional.softplus(rnd(LM_BATCH, LM_SEQ, h))
        a = -torch.rand(h, generator=gen, device="cuda") - 0.1
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: ssm._ssd_chunked(xh, dt, a, bm, cm, cfg.ssm_chunk), reps=3)
        return dict(ssd_ms=ms, ssd_peak_bytes=torch.cuda.max_memory_allocated(),
                    layers=cfg.num_layers)
    p0 = {k: v[0] for k, v in params["scan"]["pos0"]["rglru"].items()}
    u = rnd(LM_BATCH, LM_SEQ, cfg.rnn_width).bfloat16()
    gates_ms = cuda_ms(lambda: rglru._gates(p0, u, cfg), reps=3)
    a, b = rglru._gates(p0, u, cfg)
    scan_ms = cuda_ms(lambda: rglru.linear_scan(a, b), reps=3)
    layers = sum(cfg.pattern_for_layer(i) == "rglru" for i in range(cfg.num_layers))
    return dict(gates_ms=gates_ms, gates_flops=2 * 2 * LM_BATCH * LM_SEQ * cfg.rnn_width ** 2,
                scan_ms=scan_ms, layers=layers)


def recurrent_lm_phase(arch: str, counters: dict, fa_mod) -> dict:
    """Phase 6g (mamba2-2.7b) or 6h (recurrentgemma-9b): the recurrent
    decoder at full width and depth, random float32 weights (seed 0), bf16
    compute: the forward with impl="flash" at B = 2, S = 4096, counters
    zeroed just before (mamba2: no kernel; recurrentgemma: #7 once a local
    layer, all on cuda_cores, its first call held against its plain
    version, and at most as far from the float32 attention as xla's, root
    mean square); twice bitwise equal; flash against xla (bitwise equal
    without attention) and both against the float32-compute forward;
    decode == forward over 64 tokens at float32;
    the bf16 server; the cache bytes at 4,096 and 524,288 positions; the
    smoke config on the card against the CPU; the launcher's --smoke run."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch import serve as lm_launch
    from repro_torch.models.lm import transformer
    from repro_torch.models.lm.api import build
    from repro_torch.serve import engine
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config(arch)
    api = build(cfg)
    tag = f"[{arch}]"
    n_local = sum(cfg.pattern_for_layer(i) in transformer.ATTENTION for i in range(cfg.num_layers))
    res = dict(layers=cfg.num_layers, local_layers=n_local, batch=LM_BATCH, seq=LM_SEQ)
    torch.cuda.reset_peak_memory_stats()
    params, res["init_ms"] = timed(
        lambda: api.init(torch.Generator(device="cuda").manual_seed(0), device="cuda"))
    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in tree_leaves(tree))  # noqa: E731
    res.update(params=sum(t.numel() for t in tree_leaves(params)), weight_bytes=nbytes(params),
               init_peak_bytes=torch.cuda.max_memory_allocated())
    log(f"{tag} all {cfg.num_layers} layers ({cfg.block_pattern}, {n_local} local attention), "
        f"d_model {cfg.d_model}, vocab {cfg.vocab_size} (tied); {res['params']} parameters "
        f"({res['weight_bytes'] / 1e9:.3f} GB {cfg.param_dtype}), compute {cfg.dtype}; init "
        f"{res['init_ms']:.1f} ms, peak {res['init_peak_bytes'] / 2**30:.3f} GiB")
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (LM_BATCH, LM_SEQ)),
                           dtype=torch.int32, device="cuda")
    vp = transformer.vocab_padded(cfg)

    # the main path: counters zeroed just before the forward, read just after;
    # #7's first launch held against its plain version as it returns
    by_route = fa_mod.flash_attention.launches_by_route
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters, fa_mod)
    with flash_launches_held(fa_mod, f"{arch} forward", every=False) as (held, first):
        (logits, aux), cold_ms = timed(lambda: api.forward(params, toks, impl="flash"))
    launches = {k: fn.launches for k, fn in counters.items()}
    routes = dict(by_route)
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in counters} | {"flash_attention": n_local}
    if launches != want or routes != {"wgmma": 0, "cuda_cores": n_local}:
        raise AssertionError(f"{arch} forward launches {launches}, by route {routes}; expected "
                             f"{want}, all {n_local} on the cuda_cores route")
    if logits.shape != (LM_BATCH, LM_SEQ, vp) or not torch.isfinite(logits).all() or float(aux):
        raise AssertionError(f"{arch} logits {tuple(logits.shape)} (expected {(LM_BATCH, LM_SEQ, vp)}) "
                             f"or non-finite, aux {float(aux)}")
    if first:
        res["flash_first_call_max_abs_err"] = held[0][3]
        log(f"[check] {arch} forward: #7's first launch {held[0][:3]} against "
            f"flash_attention_plain max_abs_err={held[0][3]:.3e} (atol=1e-4, rtol=8e-3)")
        # phase 6b's rule where flash and xla differ, this layer's attention
        res["attention_vs_float32_rms"] = attention_rule(fa_mod, cfg, first.pop(), arch)
    logits2, _ = api.forward(params, toks, impl="flash")
    if not torch.equal(logits, logits2):
        raise AssertionError(f"{arch}: two forwards on the same inputs differ")
    del logits2
    steady = [timed(lambda: api.forward(params, toks, impl="flash"))[1] for _ in range(2)]
    prof = profiled(lambda: api.forward(params, toks, impl="flash"), 2)
    tokens_s = LM_BATCH * LM_SEQ / (float(np.median(steady)) / 1e3)
    core = recurrent_block_time(arch, cfg, params)
    step_med = float(np.median(steady))
    if "ssd_ms" in core:
        core["ssd_share"] = core["ssd_ms"] * core["layers"] / step_med
        core_line = (f"one layer's _ssd_chunked (float32, chunk {cfg.ssm_chunk}) "
                     f"{core['ssd_ms']:.3f} ms (peak {core['ssd_peak_bytes'] / 2**30:.3f} GiB), "
                     f"x {core['layers']} layers = {core['ssd_share']:.4f} of the steady forward")
    else:
        core["gates_share"] = core["gates_ms"] * core["layers"] / step_med
        core["scan_share"] = core["scan_ms"] * core["layers"] / step_med
        core_line = (f"one layer's _gates (two float32 {cfg.rnn_width}^2 products a token, "
                     f"{core['gates_flops']:.3e} flops) {core['gates_ms']:.3f} ms and doubling scan "
                     f"{core['scan_ms']:.3f} ms, x {core['layers']} RG-LRU layers = "
                     f"{core['gates_share']:.4f} and {core['scan_share']:.4f} of the steady forward")
    res["forward"] = dict(launches=launches, launches_by_route=routes, cold_ms=cold_ms,
                          steady_ms=steady, tokens_s=tokens_s, peak_mem_bytes=peak,
                          profiled=prof, recurrent_core=core)
    log(f"{tag} forward flash, B={LM_BATCH} S={LM_SEQ}: launches={json.dumps(launches)}, #7 by "
        f"route {json.dumps(routes)}; ms cold {cold_ms:.3f}, steady median {step_med:.3f} "
        f"({['%.3f' % t for t in steady]}), {tokens_s:.1f} tokens/s, peak mem "
        f"{peak / 2**30:.3f} GiB; twice bitwise equal")
    log(f"{tag} {core_line}")
    log(f"{tag} 2 forwards under the profiler: {['%.3f' % t for t in prof['steps_ms']]} ms, device "
        f"busy {prof['device_busy_ms']:.3f} of {prof['device_wall_ms']:.3f} ms, idle share "
        f"{prof['device_idle_share']:.4f}")
    for kk in prof["top_kernels"][:8]:
        log(f"{tag}   {kk['device_ms']:9.3f} ms x{kk['calls']:<4d} {kk['name']}")

    # flash against xla (both bf16) and both against the float32-compute
    # forward on its rows.  Without attention the two are one computation
    # (bitwise equal).  With it, phase 6b's rule (flash at most as far from
    # float32, root mean square, as xla) is held above on the layer where
    # they differ: in the logits both distances are the other layers'
    # common bf16 roundings (recurrentgemma's 0.038856 and 0.038833 on row 0,
    # NVIDIA H100 80GB HBM3), and are printed
    (xla, _), xla_ms = timed(lambda: api.forward(params, toks, impl="xla"))
    if not n_local and not torch.equal(logits, xla):
        raise AssertionError(f"{arch}: with no attention layer flash and xla differ")
    agree = top1_agreement(logits, xla, cfg.vocab_size)
    dmax = rowwise_max_abs(logits, xla)
    rows = F32_ROWS[arch]
    logits, xla = logits[:rows].clone(), xla[:rows].clone()
    gc.collect()
    torch.cuda.empty_cache()
    api32 = build(dataclasses.replace(cfg, dtype="float32"))
    exact, _ = api32.forward(params, toks[:rows], impl="xla")
    to_exact = {name: dict(top1_agreement=top1_agreement(lg, exact, cfg.vocab_size),
                           max_abs_diff=rowwise_max_abs(lg, exact), rms_diff=rowwise_rms(lg, exact))
                for name, lg in (("flash", logits), ("xla", xla))}
    res["flash_vs_xla_bf16"] = dict(top1_agreement=agree, max_abs_diff=dmax, xla_ms=xla_ms,
                                    float32_rows=rows, vs_float32=to_exact)
    log(f"[check] {arch} forward flash vs xla, bf16: top-1 agreement {agree:.6f}, max |d| "
        f"{dmax:.4e}; xla forward {xla_ms:.3f} ms")
    for name, d in to_exact.items():
        log(f"[check] {arch} {name} (bf16) against the float32-compute forward on {rows} row(s): "
            f"top-1 agreement {d['top1_agreement']:.6f}, max |d| {d['max_abs_diff']:.4e}, rms "
            f"{d['rms_diff']:.4e}")
    del logits, xla, exact
    gc.collect()
    torch.cuda.empty_cache()

    # decode == forward at full width, float32 compute, over 64 tokens
    short = toks[:, :DECODE_TOKENS]
    before = dict(by_route)
    ref, _ = api32.forward(params, short, impl="flash")
    f32_routes = {r: by_route[r] - before[r] for r in by_route}
    if f32_routes != {"wgmma": 0, "cuda_cores": n_local}:
        raise AssertionError(f"{arch} float32 forward: #7 by route {f32_routes}")
    caches = api32.init_caches(LM_BATCH, DECODE_TOKENS, torch.float32, device="cuda")
    outs = []
    for t in range(DECODE_TOKENS):
        lg, caches = api32.decode(params, short[:, t:t + 1], t, caches)
        outs.append(lg)
    dec = torch.cat(outs, dim=1)
    ddf = float((dec - ref).abs().max())
    torch.testing.assert_close(dec, ref, atol=DECODE_TOL, rtol=DECODE_TOL,
                               msg=lambda m: f"{arch} decode == forward (float32, full width): {m}")
    res["decode_vs_forward"] = dict(tokens=DECODE_TOKENS, max_abs_diff=ddf, tol=DECODE_TOL,
                                    flash_routes=f32_routes)
    log(f"[check] {arch} decode == forward, float32 compute, full width: {DECODE_TOKENS} decode "
        f"steps against forward(flash) at B={LM_BATCH}: max |d| {ddf:.4e} (atol=rtol={DECODE_TOL})")
    del ref, caches, dec, outs

    # the bf16 server: 4 prompts of 8 tokens, 16 new each, bf16 caches
    prompts = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 8)),
                              dtype=torch.int32, device="cuda")
    steps, cache_len = 16, 8 + 16 + 1
    before = fa_mod.flash_attention.launches
    state = engine.init_serve_state(api, 4, cache_len + 2, dtype=torch.bfloat16, device="cuda")
    prefill, step = engine.make_prefill(api), engine.make_serve_step(api)
    (lg, state), prefill_ms = timed(lambda: prefill(params, state, prompts))
    toks_out, step_ms = [], []
    for _ in range(steps):
        tok = lg[:, : cfg.vocab_size].argmax(-1).to(torch.int32)
        toks_out.append(tok)
        (lg, state), ms = timed(lambda: step(params, state, tok[:, None]))
        step_ms.append(ms)
    gen = torch.stack(toks_out, 1)
    if not torch.isfinite(lg).all() or gen.shape != (4, steps) or state.cache_pos != cache_len - 1:
        raise AssertionError(f"{arch} bf16 serving: non-finite logits or wrong shapes")
    if fa_mod.flash_attention.launches != before:
        raise AssertionError(f"{arch} bf16 serving launched #7 (decode attends in plain PyTorch)")
    box = [state]

    def one_step():
        box[0] = step(params, box[0], gen[:, -1:])[1]

    dprof = profiled(one_step, 2)
    read = res["weight_bytes"]  # a step reads every weight, the tied embedding whole (logits)
    step_med = float(np.median(step_ms))
    res["serve_bf16"] = dict(prefill_ms=prefill_ms, step_ms=step_ms, step_median_ms=step_med,
                             tokens_s=4 * steps / (sum(step_ms) / 1e3), profiled=dprof,
                             step_bytes=read, step_bound_ms=read / PEAK_HBM_BYTES * 1e3,
                             tokens=gen.tolist())
    log(f"{tag} serve bf16: 4 prompts x 8 tokens, 16 new each, bf16 caches: prefill "
        f"{prefill_ms:.3f} ms, decode step median {step_med:.3f} ms, "
        f"{res['serve_bf16']['tokens_s']:.1f} tokens/s; a step reads {read / 1e9:.3f} GB of "
        f"weights: bound {res['serve_bf16']['step_bound_ms']:.3f} ms at 3.35 TB/s")
    log(f"{tag} 2 decode steps under the profiler: {['%.3f' % t for t in dprof['steps_ms']]} ms, "
        f"device busy {dprof['device_busy_ms']:.3f} of {dprof['device_wall_ms']:.3f} ms, idle "
        f"share {dprof['device_idle_share']:.4f}")
    for kk in dprof["top_kernels"][:4]:
        log(f"{tag}   {kk['device_ms']:9.3f} ms x{kk['calls']:<4d} {kk['name']}")
    del state, box, lg

    # greedy_generate's float32 caches at bf16 compute: mamba2 runs (no
    # attention), recurrentgemma is refused, as the reference fails
    try:
        out = engine.greedy_generate(api, params, prompts, steps=2, cache_len=11)
    except ValueError as e:
        if n_local == 0:
            raise
        res["greedy_bf16"] = "refused"
        log(f"{tag} greedy_generate at bf16 refuses, as the reference's fails: {str(e)[:90]}...")
    else:
        if n_local:
            raise AssertionError(f"{arch}: greedy_generate accepted bf16 compute with attention")
        if out.shape != (4, 2):
            raise AssertionError(f"{arch}: greedy_generate at bf16 gave {tuple(out.shape)}")
        res["greedy_bf16"] = out.tolist()
        log(f"{tag} greedy_generate at bf16 compute with float32 caches runs, as the "
            f"reference's: {out.tolist()}")

    # the caches at the reference's train_4k and long_500k contexts, batch 1, bf16
    res["cache_bytes"] = {}
    for n in CACHE_LENS:
        caches = api.init_caches(1, n, torch.bfloat16, device="cuda")
        res["cache_bytes"][n] = nbytes(caches)
        if any(c.k.shape[-3] != cfg.window for c in transformer._attn_caches(caches)):
            raise AssertionError(f"{arch}: a local cache is not a ring of {cfg.window} slots")
        del caches
    if len(set(res["cache_bytes"].values())) != 1:
        raise AssertionError(f"{arch}: cache bytes grow with the context: {res['cache_bytes']}")
    log(f"{tag} caches at batch 1, bf16: {res['cache_bytes'][CACHE_LENS[0]]} B at "
        f"{CACHE_LENS[0]} and {CACHE_LENS[1]} positions"
        + (f" (local attention: a ring of {cfg.window} slots)" if n_local else " (O(1) state)"))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # the smoke config (float32) on the card against the CPU, forward and decode
    scfg = smoke_config(arch)
    sapi = build(scfg)
    sp = sapi.init(torch.Generator().manual_seed(0), device="cpu")
    stoks = torch.randint(0, scfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(1))
    got, _ = sapi.forward(tree_map(lambda t: t.cuda(), sp), stoks.cuda(), impl="flash")
    want, _ = sapi.forward(sp, stoks, impl="flash")
    ds = float((got.cpu() - want).abs().max())
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4,
                               msg=lambda m: f"{arch} smoke, card vs CPU: {m}")
    res["smoke_card_vs_cpu_max_abs_diff"] = ds
    log(f"[check] {arch} smoke (float32, S=24{f' > window {scfg.window}' if scfg.window else ''}) "
        f"flash on the card vs the CPU: max |d| {ds:.3e} (atol=rtol=1e-4)")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lm_launch.main(["--arch", arch, "--smoke"])
    lines = buf.getvalue().splitlines()
    if not lines or not lines[0].startswith(f"{arch}: 64 tokens in"):
        raise AssertionError(f"launcher: {lines}")
    log(f"[launcher] serve --arch {arch} --smoke on the card: {lines[0]}")
    res["launcher"] = lines[0]
    return res


def recurrent_alone(arch: str) -> dict:
    """Phase 6g or 6h on its own; recurrentgemma's also times #7 at its
    layer shape (``flash_rg_shape``)."""
    fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")

    def run():
        out = {"phase": recurrent_lm_phase(arch, kernel_counters(), fa_mod)}
        if arch == "recurrentgemma-9b":
            out["flash_attention"] = flash_rg_shape(fa_mod)
        return out

    return lm_alone(arch, run)


def mamba2_alone() -> dict:
    """Phase 6g alone (``python3 -c 'import chip_smoke as c; c.mamba2_alone()'``);
    chiprun_out/mamba2-2.7b.json."""
    return recurrent_alone("mamba2-2.7b")


def recurrentgemma_alone() -> dict:
    """Phase 6h alone (``python3 -c 'import chip_smoke as c;
    c.recurrentgemma_alone()'``); chiprun_out/recurrentgemma-9b.json."""
    return recurrent_alone("recurrentgemma-9b")


# -- phases 6i-6j: the VLM (M-RoPE, visual slots) and the encoder-decoder ------------

VLM_ARCH, ENCDEC_ARCH = "qwen2-vl-7b", "whisper-large-v3"
VLM_GRID = 32  # the visual span: a 32 x 32 patch grid at t = 0, the first 1,024 slots
# whisper's 1,500 frames (the flash path refuses them: min(512, 1500) does not
# divide 1500, in both packages), the 1,024 of its flash forward, its 448 positions
WHISPER_FRAMES, WHISPER_FLASH_FRAMES, WHISPER_DEC = 1500, 1024, 448
LOGITS_RULE_SLACK = 1.25  # flash's logits at most this much farther (rms) from float32 than xla's


def vlm_positions(b: int, s: int, grid: int, device) -> torch.Tensor:
    """M-RoPE positions ``[b, s, 3]`` (t, h, w): a grid x grid patch span at
    t = 0 (h = row, w = col), the text after it from max + 1 with t == h == w."""
    n_vis = grid * grid
    pos = torch.zeros((s, 3), dtype=torch.int32)
    idx = torch.arange(n_vis, dtype=torch.int32)
    pos[:n_vis, 1], pos[:n_vis, 2] = idx // grid, idx % grid
    pos[n_vis:] = (grid + torch.arange(s - n_vis, dtype=torch.int32))[:, None]
    return pos.expand(b, s, 3).to(device)


@contextlib.contextmanager
def flash_launches_held(fa_mod, name: str, every: bool):
    """While active, #7's launches (``fa_mod.launch``, which the wrapper
    calls), every one or the first, are held against ``flash_attention_plain``
    on their operands as they return: within one rounding of the float32
    result for bf16 (atol=1e-4, rtol=8e-3), 1e-4 for float32.  Yields a
    list of (q shape, k shape, causal, max |d|); ``first`` keeps the first
    launch's operands.  The plain version launches no kernel, so no
    count moves."""
    launch, seen, first = fa_mod.launch, [], []

    def checking(q, k, v, out, **kw):
        launch(q, k, v, out, **kw)
        if not first:
            first.append((q, k, v, out, kw))
        if every or len(seen) == 0:
            plain = fa_mod.flash_attention_plain(q, k, v, **kw)
            tol = (dict(atol=1e-4, rtol=8e-3) if out.dtype == torch.bfloat16
                   else dict(atol=1e-4, rtol=1e-4))
            what = f"{name}: #7 launch {len(seen)} {tuple(q.shape)} / {tuple(k.shape)} {kw}"
            torch.testing.assert_close(out.float(), plain.float(), **tol,
                                       msg=lambda m: f"{what}: {m}")
            seen.append((tuple(q.shape), tuple(k.shape), kw["causal"],
                         float((out.float() - plain.float()).abs().max())))

    fa_mod.launch = checking
    try:
        yield seen, first
    finally:
        fa_mod.launch = launch


def attention_rule(fa_mod, cfg, launch, name: str) -> dict:
    """Phase 6b's rule on one attention layer of a forward: #7's output at
    most as far (root mean square) from the float32 attention of the same
    operands as impl "xla"'s bf16 einsums."""
    from repro_torch.models.lm import attention

    q, k, v, out, kw = launch
    exact32 = fa_mod.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    mask = fa_mod.attention_mask(q.shape[2], k.shape[2], kw["causal"], kw["window"], q.device)
    xla_att = attention._sdpa_xla(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  mask.expand(q.shape[0], -1, -1), cfg).transpose(1, 2)
    rms = {n: float((o.float() - exact32).square().mean().sqrt())
           for n, o in (("flash", out), ("xla", xla_att))}
    log(f"[check] {name} first attention layer against its float32 computation: rms flash "
        f"{rms['flash']:.4e}, xla {rms['xla']:.4e}")
    if not rms["flash"] <= rms["xla"]:
        raise AssertionError(f"{name}: #7's attention is further from float32 than xla's: {rms}")
    return rms


def reset_counts(counters: dict, fa_mod) -> None:
    """Every kernel count to 0, #7's by route too (just before a main path)."""
    for fn in counters.values():
        fn.launches = 0
    for r in fa_mod.flash_attention.launches_by_route:
        fa_mod.flash_attention.launches_by_route[r] = 0


def logits_vs_float32(name: str, bf16: dict, exact, vocab: int) -> dict:
    """Each bf16 forward's logits (``{impl: logits}``) against the
    float32-compute forward's: top-1 agreement, max |d|, rms; and phase
    6b's rule in the logits with ``LOGITS_RULE_SLACK`` for the other
    layers' roundings, which both paths share."""
    to_exact = {impl: dict(top1_agreement=top1_agreement(lg, exact, vocab),
                           max_abs_diff=rowwise_max_abs(lg, exact), rms_diff=rowwise_rms(lg, exact))
                for impl, lg in bf16.items()}
    for impl, d in to_exact.items():
        log(f"[check] {name} {impl} (bf16) against the float32-compute forward: top-1 agreement "
            f"{d['top1_agreement']:.6f}, max |d| {d['max_abs_diff']:.4e}, rms {d['rms_diff']:.4e}")
    if "xla" in to_exact and not (to_exact["flash"]["rms_diff"]
                                  <= LOGITS_RULE_SLACK * to_exact["xla"]["rms_diff"]):
        raise AssertionError(f"{name}: flash's logits are further from float32 than "
                             f"{LOGITS_RULE_SLACK} x xla's: {to_exact}")
    return to_exact


def bf16_server(name: str, api, params, fa_mod, frames=None) -> dict:
    """4 prompts of 8 tokens, 16 new each, ``make_prefill`` + ``make_serve_step``
    with bf16 caches (an encoder-decoder's ``frames`` encoded once in
    prefill, its cross K/V precomputed there and read by every step): ms,
    tokens/s, the profiler over 2 steps; decode launches no #7."""
    cfg = api.cfg
    from repro_torch.serve import engine

    prompts = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 8)),
                              dtype=torch.int32, device="cuda")
    steps, cache_len = 16, 8 + 16 + 1
    before = fa_mod.flash_attention.launches
    state = engine.init_serve_state(api, 4, cache_len + 2, dtype=torch.bfloat16, device="cuda")
    prefill, step = engine.make_prefill(api), engine.make_serve_step(api)
    kw = {} if frames is None else {"frames": frames}
    (lg, state), prefill_ms = timed(lambda: prefill(params, state, prompts, **kw))
    cross = state.cross_kv
    toks_out, step_ms = [], []
    for _ in range(steps):
        tok = lg[:, : cfg.vocab_size].argmax(-1).to(torch.int32)
        toks_out.append(tok)
        (lg, state), ms = timed(lambda: step(params, state, tok[:, None]))
        step_ms.append(ms)
    gen = torch.stack(toks_out, 1)
    if not torch.isfinite(lg).all() or gen.shape != (4, steps) or state.cache_pos != cache_len - 1:
        raise AssertionError(f"{name} bf16 serving: non-finite logits or wrong shapes")
    if fa_mod.flash_attention.launches != before:
        raise AssertionError(f"{name} bf16 serving launched #7 (decode attends in plain PyTorch)")
    if frames is not None:  # the cross K/V: computed once, in prefill, and carried
        want = (cfg.num_layers, 4, frames.shape[1], cfg.num_kv_heads, cfg.head_dim)
        if state.cross_kv is not cross or any(t.shape != want or t.dtype != torch.bfloat16
                                              for t in cross):
            raise AssertionError(f"{name}: the cross K/V are not prefill's {want} bf16 pair")
    box = [state]

    def one_step():
        box[0] = step(params, box[0], gen[:, -1:])[1]

    prof = profiled(one_step, 2)
    step_med = float(np.median(step_ms))
    res = dict(prefill_ms=prefill_ms, step_ms=step_ms, step_median_ms=step_med,
               tokens_s=4 * steps / (sum(step_ms) / 1e3), profiled=prof, tokens=gen.tolist())
    log(f"[{name}] serve bf16: 4 prompts x 8 tokens, 16 new each, bf16 caches"
        + ("" if frames is None else f", {frames.shape[1]} frames encoded in prefill")
        + f": prefill {prefill_ms:.3f} ms, decode step median {step_med:.3f} ms, "
        f"{res['tokens_s']:.1f} tokens/s; 2 steps under the profiler: device busy "
        f"{prof['device_busy_ms']:.3f} of {prof['device_wall_ms']:.3f} ms, idle share "
        f"{prof['device_idle_share']:.4f}")
    try:
        engine.greedy_generate(api, params, prompts, steps=1, cache_len=10)
    except ValueError as e:
        log(f"[{name}] greedy_generate at bf16 refuses, as the reference's fails: "
            f"{str(e)[:90]}...")
    else:
        raise AssertionError(f"{name}: greedy_generate accepted a bfloat16-compute config")
    return res


def smoke_on_card(arch: str) -> dict:
    """The smoke config (float32) on the card: flash forward against the
    CPU's at 1e-4, decode steps against the card's own forward at
    ``DECODE_TOL`` (the dense family's, llama's prefill check; the
    encoder-decoder decodes from prefill's cross K/V of the same frames)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.lm.api import build
    from repro_torch.serve import engine
    from repro_torch.tree import tree_map

    cfg = smoke_config(arch)
    api = build(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    card = tree_map(lambda t: t.cuda(), params)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen)
    if cfg.is_encoder_decoder:
        kw = {"frames": torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen)}
    else:
        kw = {"positions": vlm_positions(2, 24, 2, "cpu"),
              "visual_embeds": 0.5 * torch.randn((2, 4, cfg.d_model), generator=gen)}
    ckw = {k: v.cuda() for k, v in kw.items()}
    got, _ = api.forward(card, toks.cuda(), impl="flash", **ckw)
    want, _ = api.forward(params, toks, impl="flash", **kw)
    d_cpu = float((got.cpu() - want).abs().max())
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4,
                               msg=lambda m: f"{arch} smoke, card vs CPU: {m}")
    state = engine.init_serve_state(api, 2, 24, dtype=torch.float32, device="cuda")
    if cfg.is_encoder_decoder:
        full, _ = api.forward(card, toks.cuda(), impl="flash", **ckw)
        lg, state = engine.make_prefill(api)(card, state, toks[:, :1].cuda(), ckw["frames"])
        outs = [lg]
    else:
        full, _ = api.forward(card, toks.cuda(), impl="flash")  # decode's positions are text's
        outs = []
    step = engine.make_serve_step(api)
    for t in range(len(outs), 24):
        lg, state = step(card, state, toks[:, t:t + 1].cuda())
        outs.append(lg)
    dec = torch.stack(outs, 1)
    d_dec = float((dec - full).abs().max())
    torch.testing.assert_close(dec, full, atol=DECODE_TOL, rtol=DECODE_TOL,
                               msg=lambda m: f"{arch} smoke decode == forward on the card: {m}")
    log(f"[check] {arch} smoke (float32) on the card: flash forward vs the CPU max |d| "
        f"{d_cpu:.3e} (atol=rtol=1e-4); 24 decode steps vs the forward max |d| {d_dec:.3e} "
        f"(atol=rtol={DECODE_TOL})")
    return dict(card_vs_cpu_max_abs_diff=d_cpu, decode_vs_forward_max_abs_diff=d_dec)


def vlm_lm_phase(counters: dict, fa_mod) -> dict:
    """Phase 6i: qwen2-vl-7b at full width and depth (28 layers, its bf16
    weights, seed 0), bf16 compute, B = 2, S = 4096: the first 1,024 slots
    take seeded visual embeddings at M-RoPE positions of a 32 x 32 grid, the
    text after them continuing from max + 1.  The flash forward with every
    count zeroed just before (#7 once a layer, all on wgmma; the first
    launch held against its plain version and phase 6b's rule on it);
    twice bitwise equal; steady ms, peak memory, the profiler; flash and
    xla against the float32-compute forward of the same weights on row 0;
    the bf16 server; the smoke config on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import transformer
    from repro_torch.models.lm.api import build
    from repro_torch.tree import tree_leaves

    cfg = get_config(VLM_ARCH)
    api = build(cfg)
    tag = f"[{VLM_ARCH}]"
    n_vis = VLM_GRID * VLM_GRID
    res = dict(layers=cfg.num_layers, batch=LM_BATCH, seq=LM_SEQ, visual_slots=n_vis)
    torch.cuda.reset_peak_memory_stats()
    params, res["init_ms"] = timed(
        lambda: api.init(torch.Generator(device="cuda").manual_seed(0), device="cuda"))
    res.update(params=sum(t.numel() for t in tree_leaves(params)),
               weight_bytes=sum(t.numel() * t.element_size() for t in tree_leaves(params)),
               init_peak_bytes=torch.cuda.max_memory_allocated())
    log(f"{tag} all {cfg.num_layers} layers, d_model {cfg.d_model}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads} x {cfg.head_dim} (QKV bias), d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, M-RoPE sections {cfg.m_rope_sections}; {res['params']} parameters "
        f"({res['weight_bytes'] / 1e9:.3f} GB {cfg.param_dtype}), compute {cfg.dtype}; init "
        f"{res['init_ms']:.1f} ms, peak {res['init_peak_bytes'] / 2**30:.3f} GiB")
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (LM_BATCH, LM_SEQ)),
                           dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    vis = (0.02 * torch.randn((LM_BATCH, n_vis, cfg.d_model), generator=gen,
                              device="cuda")).to(torch.bfloat16)
    kw = dict(positions=vlm_positions(LM_BATCH, LM_SEQ, VLM_GRID, "cuda"), visual_embeds=vis)
    vp = transformer.vocab_padded(cfg)

    # the main path: counts zeroed just before the forward, read just after
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters, fa_mod)
    with flash_launches_held(fa_mod, VLM_ARCH, every=False) as (held, first):
        (logits, aux), cold_ms = timed(lambda: api.forward(params, toks, impl="flash", **kw))
    launches = {k: fn.launches for k, fn in counters.items()}
    routes = dict(fa_mod.flash_attention.launches_by_route)
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in counters} | {"flash_attention": cfg.num_layers}
    if launches != want or routes != {"wgmma": cfg.num_layers, "cuda_cores": 0}:
        raise AssertionError(f"{VLM_ARCH} forward launches {launches}, by route {routes}; "
                             f"expected {want}, all on the wgmma route")
    if logits.shape != (LM_BATCH, LM_SEQ, vp) or not torch.isfinite(logits).all() or float(aux):
        raise AssertionError(f"{VLM_ARCH} logits {tuple(logits.shape)} or non-finite, aux {aux}")
    log(f"[check] {VLM_ARCH} forward: #7's first launch {held[0][:3]} against "
        f"flash_attention_plain max_abs_err={held[0][3]:.3e} (atol=1e-4, rtol=8e-3)")
    res["flash_first_call_max_abs_err"] = held[0][3]
    res["attention_vs_float32_rms"] = attention_rule(fa_mod, cfg, first.pop(), VLM_ARCH)
    if not torch.equal(logits, api.forward(params, toks, impl="flash", **kw)[0]):
        raise AssertionError(f"{VLM_ARCH}: two forwards on the same inputs differ")
    steady = [timed(lambda: api.forward(params, toks, impl="flash", **kw))[1] for _ in range(2)]
    prof = profiled(lambda: api.forward(params, toks, impl="flash", **kw), 1)
    step_med = float(np.median(steady))
    res["forward"] = dict(launches=launches, launches_by_route=routes, cold_ms=cold_ms,
                          steady_ms=steady, tokens_s=LM_BATCH * LM_SEQ / (step_med / 1e3),
                          peak_mem_bytes=peak, profiled=prof)
    log(f"{tag} forward flash, B={LM_BATCH} S={LM_SEQ} ({n_vis} visual slots): "
        f"launches={json.dumps(launches)}, #7 by route {json.dumps(routes)}; ms cold "
        f"{cold_ms:.3f} (first launch checked), steady median {step_med:.3f} "
        f"({['%.3f' % t for t in steady]}), {res['forward']['tokens_s']:.1f} tokens/s, peak mem "
        f"{peak / 2**30:.3f} GiB; twice bitwise equal; under the profiler "
        f"{prof['steps_ms'][0]:.3f} ms, device busy {prof['device_busy_ms']:.3f}, idle share "
        f"{prof['device_idle_share']:.4f}")
    for kk in prof["top_kernels"][:6]:
        log(f"{tag}   {kk['device_ms']:9.3f} ms x{kk['calls']:<4d} {kk['name']}")

    (xla, _), xla_ms = timed(lambda: api.forward(params, toks, impl="xla", **kw))
    agree, dmax = top1_agreement(logits, xla, cfg.vocab_size), rowwise_max_abs(logits, xla)
    log(f"[check] {VLM_ARCH} forward flash vs xla, bf16: top-1 agreement {agree:.6f}, max |d| "
        f"{dmax:.4e}; xla forward {xla_ms:.3f} ms")
    bf16 = {"flash": logits[:1].clone(), "xla": xla[:1].clone()}
    del logits, xla
    gc.collect()
    torch.cuda.empty_cache()
    api32 = build(dataclasses.replace(cfg, dtype="float32"))
    exact, _ = api32.forward(params, toks[:1], impl="xla",
                             **{k: v[:1] for k, v in kw.items()})
    res["flash_vs_xla_bf16"] = dict(top1_agreement=agree, max_abs_diff=dmax, xla_ms=xla_ms,
                                    float32_rows=1, vs_float32=logits_vs_float32(
                                        VLM_ARCH, bf16, exact, cfg.vocab_size))
    del bf16, exact
    gc.collect()
    torch.cuda.empty_cache()
    res["serve_bf16"] = bf16_server(VLM_ARCH, api, params, fa_mod)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res["smoke"] = smoke_on_card(VLM_ARCH)
    return res


def encdec_lm_phase(counters: dict, fa_mod) -> dict:
    """Phase 6j: whisper-large-v3 at full width and depth (32 + 32 layers,
    float32 weights, seed 0), bf16 compute, B = 2, seeded frames, decoder S
    = 448.  The main path is the flash forward at 1,024 frames, every count
    zeroed just before: #7 32 times in the encoder (causal=False) and 32 in
    the decoder, all on wgmma, each launch held against its plain version
    as it returns (phase 6b's rule on the first); twice bitwise equal;
    held against xla at 1,024 frames and both against the float32-compute
    forward.  Then the real 1,500 frames on xla (steady ms, peak memory,
    the profiler), the flash path at 1,500 frames raising the reference's
    precondition, the bf16 server (frames encoded once per prompt batch),
    and the smoke config on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import transformer
    from repro_torch.models.lm.api import build
    from repro_torch.tree import tree_leaves

    cfg = get_config(ENCDEC_ARCH)
    api = build(cfg)
    tag = f"[{ENCDEC_ARCH}]"
    res = dict(layers=(cfg.encoder_layers, cfg.num_layers), batch=LM_BATCH, frames=WHISPER_FRAMES,
               flash_frames=WHISPER_FLASH_FRAMES, dec_seq=WHISPER_DEC)
    torch.cuda.reset_peak_memory_stats()
    params, res["init_ms"] = timed(
        lambda: api.init(torch.Generator(device="cuda").manual_seed(0), device="cuda"))
    res.update(params=sum(t.numel() for t in tree_leaves(params)),
               weight_bytes=sum(t.numel() * t.element_size() for t in tree_leaves(params)),
               init_peak_bytes=torch.cuda.max_memory_allocated())
    log(f"{tag} {cfg.encoder_layers} encoder + {cfg.num_layers} decoder layers, d_model "
        f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} x {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size} (tied); {res['params']} parameters "
        f"({res['weight_bytes'] / 1e9:.3f} GB {cfg.param_dtype}), compute {cfg.dtype}; init "
        f"{res['init_ms']:.1f} ms")
    toks = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (LM_BATCH, WHISPER_DEC)),
        dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    frames = torch.randn((LM_BATCH, WHISPER_FRAMES, cfg.d_model), generator=gen,
                         device="cuda").to(torch.bfloat16)
    short = frames[:, :WHISPER_FLASH_FRAMES].contiguous()
    vp = transformer.vocab_padded(cfg)
    shape = (LM_BATCH, WHISPER_DEC, vp)
    n_attn = cfg.encoder_layers + cfg.num_layers

    # the main path: counts zeroed just before the flash forward, read just after
    reset_counts(counters, fa_mod)
    with flash_launches_held(fa_mod, ENCDEC_ARCH, every=True) as (held, first):
        (logits, aux), cold_ms = timed(
            lambda: api.forward(params, toks, frames=short, impl="flash"))
    launches = {k: fn.launches for k, fn in counters.items()}
    routes = dict(fa_mod.flash_attention.launches_by_route)
    want = {k: 0 for k in counters} | {"flash_attention": n_attn}
    if launches != want or routes != {"wgmma": n_attn, "cuda_cores": 0}:
        raise AssertionError(f"{ENCDEC_ARCH} forward launches {launches}, by route {routes}; "
                             f"expected {want}, all on the wgmma route")
    enc = [h for h in held if not h[2]]
    dec = [h for h in held if h[2]]
    if (len(held) != n_attn or len(enc) != cfg.encoder_layers
            or {h[1][2] for h in enc} != {WHISPER_FLASH_FRAMES} or {h[1][2] for h in dec}
            != {WHISPER_DEC}):
        raise AssertionError(f"{ENCDEC_ARCH}: #7's launches {[h[:3] for h in held]}")
    if logits.shape != shape or not torch.isfinite(logits).all() or float(aux):
        raise AssertionError(f"{ENCDEC_ARCH} logits {tuple(logits.shape)} or non-finite")
    res["flash_calls_max_abs_err"] = {"encoder": max(h[3] for h in enc),
                                      "decoder": max(h[3] for h in dec)}
    log(f"[check] {ENCDEC_ARCH} forward at {WHISPER_FLASH_FRAMES} frames: each of #7's "
        f"{n_attn} launches against flash_attention_plain as it returned: max_abs_err encoder "
        f"(causal=False, {enc[0][0]}) {res['flash_calls_max_abs_err']['encoder']:.3e}, decoder "
        f"(causal, {dec[0][0]}) {res['flash_calls_max_abs_err']['decoder']:.3e} "
        f"(atol=1e-4, rtol=8e-3)")
    res["attention_vs_float32_rms"] = attention_rule(fa_mod, cfg, first.pop(), ENCDEC_ARCH)
    if not torch.equal(logits, api.forward(params, toks, frames=short, impl="flash")[0]):
        raise AssertionError(f"{ENCDEC_ARCH}: two forwards on the same inputs differ")
    flash_steady = [timed(lambda: api.forward(params, toks, frames=short, impl="flash"))[1]
                    for _ in range(2)]
    (xla, _), xla_ms = timed(lambda: api.forward(params, toks, frames=short, impl="xla"))
    agree, dmax = top1_agreement(logits, xla, cfg.vocab_size), rowwise_max_abs(logits, xla)
    api32 = build(dataclasses.replace(cfg, dtype="float32"))
    exact, _ = api32.forward(params, toks, frames=short.float(), impl="xla")
    res["flash_1024"] = dict(launches=launches, launches_by_route=routes, cold_ms=cold_ms,
                             steady_ms=flash_steady, xla_ms=xla_ms, top1_agreement=agree,
                             max_abs_diff=dmax, vs_float32=logits_vs_float32(
                                 f"{ENCDEC_ARCH} at {WHISPER_FLASH_FRAMES} frames",
                                 {"flash": logits, "xla": xla}, exact, cfg.vocab_size))
    log(f"{tag} forward flash at {WHISPER_FLASH_FRAMES} frames, decoder S={WHISPER_DEC}: "
        f"launches={json.dumps(launches)}, #7 by route {json.dumps(routes)}; ms cold "
        f"{cold_ms:.3f} (every launch checked), steady median "
        f"{float(np.median(flash_steady)):.3f}; twice bitwise equal; flash vs xla top-1 "
        f"agreement {agree:.6f}, max |d| {dmax:.4e}, xla {xla_ms:.3f} ms")
    del logits, xla, exact
    gc.collect()
    torch.cuda.empty_cache()

    # the real 1,500 frames, on xla
    torch.cuda.reset_peak_memory_stats()
    (lg, _), cold_ms = timed(lambda: api.forward(params, toks, frames=frames, impl="xla"))
    peak = torch.cuda.max_memory_allocated()
    if lg.shape != shape or not torch.isfinite(lg).all():
        raise AssertionError(f"{ENCDEC_ARCH} logits at {WHISPER_FRAMES} frames: "
                             f"{tuple(lg.shape)} or non-finite")
    steady = [timed(lambda: api.forward(params, toks, frames=frames, impl="xla"))[1]
              for _ in range(2)]
    prof = profiled(lambda: api.forward(params, toks, frames=frames, impl="xla"), 1)
    step_med = float(np.median(steady))
    res["forward"] = dict(cold_ms=cold_ms, steady_ms=steady, peak_mem_bytes=peak, profiled=prof,
                          frames_s=LM_BATCH * WHISPER_FRAMES / (step_med / 1e3))
    log(f"{tag} forward xla at {WHISPER_FRAMES} frames, B={LM_BATCH}, decoder S={WHISPER_DEC}: "
        f"ms cold {cold_ms:.3f}, steady median {step_med:.3f} ({['%.3f' % t for t in steady]}), "
        f"{res['forward']['frames_s']:.1f} frames/s, peak mem {peak / 2**30:.3f} GiB; under the "
        f"profiler {prof['steps_ms'][0]:.3f} ms, device busy {prof['device_busy_ms']:.3f}, idle "
        f"share {prof['device_idle_share']:.4f}")
    for kk in prof["top_kernels"][:6]:
        log(f"{tag}   {kk['device_ms']:9.3f} ms x{kk['calls']:<4d} {kk['name']}")
    del lg
    # the reference's precondition at its own length, pinned: flash refuses 1,500 frames
    before = fa_mod.flash_attention.launches
    try:
        api.forward(params, toks, frames=frames, impl="flash")
    except ValueError as e:
        if "multiples of the blocks" not in str(e) or fa_mod.flash_attention.launches != before:
            raise
        res["flash_at_1500"] = str(e)
        log(f"[check] {ENCDEC_ARCH} flash at {WHISPER_FRAMES} frames raises, as the reference's "
            f"kernel asserts: {e}")
    else:
        raise AssertionError(f"{ENCDEC_ARCH}: flash accepted {WHISPER_FRAMES} frames")
    serve_frames = torch.randn((4, WHISPER_FRAMES, cfg.d_model), generator=gen,
                               device="cuda").to(torch.bfloat16)
    res["serve_bf16"] = bf16_server(ENCDEC_ARCH, api, params, fa_mod, frames=serve_frames)
    del params, serve_frames
    gc.collect()
    torch.cuda.empty_cache()
    res["smoke"] = smoke_on_card(ENCDEC_ARCH)
    return res


def qwen2vl_alone() -> dict:
    """Phase 6i alone (``python3 -c 'import chip_smoke as c; c.qwen2vl_alone()'``),
    with #7 timed at qwen2-vl-7b's layer shape; chiprun_out/qwen2-vl-7b.json."""
    fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")
    return lm_alone(VLM_ARCH, lambda: {
        "phase": vlm_lm_phase(kernel_counters(), fa_mod),
        "flash_attention": flash_shape_times(fa_mod, FLASH_VLM, VLM_ARCH)})


def whisper_alone() -> dict:
    """Phase 6j alone (``python3 -c 'import chip_smoke as c; c.whisper_alone()'``),
    with #7 timed at whisper's two shapes; chiprun_out/whisper-large-v3.json."""
    fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")
    return lm_alone(ENCDEC_ARCH, lambda: {
        "phase": encdec_lm_phase(kernel_counters(), fa_mod),
        "flash_attention": {n: flash_shape_times(fa_mod, c, n) for n, c in WHISPER_SHAPES.items()}})


# -- phase 6k: LM training ------------------------------------------------------------

TRAIN_ARCH = "llama3.2-3b"
# 10 steps: at lr 3e-4 with no warmup the loss on fresh batches first rises (steps 1-5)
# and falls from step 6 on (PERF.md §6)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 4, 2048, 2, 10
TRAIN_OPT = dict(lr=3e-4, b2=0.95, weight_decay=0.1, grad_clip=1.0)
TRAIN_PEAK_GIB = 76  # the main path's peak memory must stay below this
# b. bf16 params with a float32 master and factored AdamW: dbrx-132b at full width,
# 1 of its 40 layers (8 B a param: 35.9 GB; 2 layers would be 62.0 GB)
MOE_TRAIN = dict(arch="dbrx-132b", layers=1, batch=2, seq=2048, steps=3)
MICRO_LAYERS = 2  # c. microbatches 2 against 1 at llama's width
MICRO_TOL = dict(rtol=5e-4, atol=5e-5)  # tests/test_train.py:105
GRAD_REL = 1e-4  # each grad leaf within this of its largest magnitude (the CPU parity tests')
SMOKE_STEPS, SMOKE_TOL = 3, 1e-4  # d. every family's smoke config, the card against the CPU
BF16_PEAK_FLOPS = 989e12  # H100 SXM dense bf16


def leaf_checksums(tree) -> list[int]:
    """Each leaf's bit patterns summed as integers (a changed bit changes its sum)."""
    from repro_torch.tree import tree_leaves

    out = []
    for t in tree_leaves(tree):
        flat = t.detach().reshape(-1)
        bits = flat.view(torch.int16 if flat.element_size() == 2 else torch.int32)
        out.append(sum(int(c.sum(dtype=torch.int64)) for c in bits.split(1 << 26)))
    return out


def train_run(api, opt, data_kw: dict, *, steps: int, microbatches: int,
              profile_steps: int = 0) -> dict:
    """``steps`` train steps from a seeded init (generator seed 0 on the
    card) on ``SyntheticLMData(**data_kw)``, each timed; the loss of the
    first batch (``lm_loss`` with no grad) before the first step and after
    the last; then the params' checksums and, with ``profile_steps``, that
    many more steps under the profiler.  The state is freed before it
    returns."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.train import lm_loss, make_train_step
    from repro_torch.train.step import init_train_state

    torch.cuda.reset_peak_memory_stats()
    state, init_ms = timed(lambda: init_train_state(
        api, torch.Generator(device="cuda").manual_seed(0), opt, device="cuda"))
    init_peak = torch.cuda.max_memory_allocated()
    step = make_train_step(api, opt, microbatches=microbatches,
                           lr_schedule=lambda s: torch.tensor(opt.lr))
    data = SyntheticLMData(**data_kw)
    first = {k: v.cuda() for k, v in SyntheticLMData(**data_kw).next().items()}

    def first_loss() -> float:
        with torch.no_grad():
            return float(lm_loss(api, state.params, first)[1]["loss"])

    seen = [first_loss()]
    hist = []
    for _ in range(steps):
        batch = data.next()
        (state, m), ms = timed(lambda: step(state, batch))
        hist.append({k: float(v) for k, v in m.items()} | {"ms": ms})
    seen.append(first_loss())
    res = dict(init_ms=init_ms, init_peak_bytes=init_peak, history=hist, first_batch_loss=seen,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               checksums=leaf_checksums(state.params))
    if profile_steps:
        box = [state]

        def one():
            box[0], _ = step(box[0], data.next())

        res["profiled"] = profiled(one, profile_steps)
        box.clear()
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return res


def same_run(name: str, a: dict, b: dict) -> None:
    """Two runs from one seed: bitwise the same losses, grad norms and params."""
    keys = ("loss", "aux_loss", "grad_norm")
    if [[h[k] for k in keys] for h in a["history"]] != [[h[k] for k in keys] for h in b["history"]]:
        raise AssertionError(f"{name}: two seeded runs differ: {a['history']} vs {b['history']}")
    if a["checksums"] != b["checksums"]:
        bad = [i for i, (x, y) in enumerate(zip(a["checksums"], b["checksums"])) if x != y]
        raise AssertionError(f"{name}: two seeded runs end with other params (leaves {bad})")


def falls(name: str, run: dict, *, fresh: bool) -> None:
    """The loss of the first batch fell from before the first step to after
    the last (the batches differ from step to step, and their own losses
    by a few hundredths); with ``fresh``, also the mean loss of the last
    three steps' fresh batches below the first step's."""
    hist, seen = run["history"], run["first_batch_loss"]
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(h[k]) for h in hist for k in ("loss", "aux_loss", "grad_norm")):
        raise AssertionError(f"{name}: non-finite loss, aux loss or grad norm: {hist}")
    if not seen[1] < seen[0] or (fresh and not np.mean(losses[-3:]) < losses[0]):
        raise AssertionError(f"{name}: the loss did not fall: first batch {seen}, steps {losses}")


def train_flops(cfg, params, tokens: int, seq: int) -> dict:
    """A step's model FLOPs (6 N T over the matmul params, the tied head
    included, plus PaLM's attention term 12 L H Dh S T) and what remat's
    recompute adds (the layers' forward again: 2 N_layers T + 4 L H Dh S T)."""
    from repro_torch.models.lm.transformer import vocab_padded
    from repro_torch.tree import tree_leaves

    n_layers = sum(t.numel() for t in tree_leaves(params["scan"]) if t.dim() >= 3)
    n_head = vocab_padded(cfg) * cfg.d_model
    attn = cfg.num_layers * cfg.num_heads * cfg.head_dim * seq * tokens
    return dict(model=6 * (n_layers + n_head) * tokens + 12 * attn,
                recompute=2 * n_layers * tokens + 4 * attn, matmul_params=n_layers + n_head)


def activation_cost(api, params) -> dict:
    """llama's flash forward at B = 2, S = 4096 with jax.nn's activations
    (the MLP's SiLU one torch op a primitive in bf16) against the single
    fused ``F.silu`` the port used before, timed in turns (old, new, new,
    old), host clock around a synchronise."""
    from repro_torch.models.lm import mlp

    toks = torch.as_tensor(np.random.default_rng(0).integers(0, api.cfg.vocab_size,
                                                            (LM_BATCH, LM_SEQ)),
                           dtype=torch.int32, device="cuda")
    forms = {"old": torch.nn.functional.silu, "new": mlp.silu}
    times = {k: [] for k in forms}
    try:
        with torch.no_grad():
            for form in ("old", "new", "new", "old"):
                mlp.silu = forms[form]
                api.forward(params, toks, impl="flash")
                times[form] += [timed(lambda: api.forward(params, toks, impl="flash"))[1]
                                for _ in range(2)]
    finally:
        mlp.silu = forms["new"]
    return {k: dict(ms=v, median_ms=float(np.median(v))) for k, v in times.items()}


def moe_train() -> dict:
    """6k b: dbrx-132b at full width, ``MOE_TRAIN["layers"]`` of its 40
    layers, bf16 params with a float32 master, factored AdamW."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm.api import build
    from repro_torch.optim import AdamWConfig

    m = MOE_TRAIN
    cfg = dataclasses.replace(get_config(m["arch"]), num_layers=m["layers"])
    api = build(cfg)
    opt = AdamWConfig(**TRAIN_OPT, factored=True)
    data_kw = dict(vocab_size=cfg.vocab_size, seq_len=m["seq"], global_batch=m["batch"], seed=0)
    runs = [train_run(api, opt, data_kw, steps=m["steps"], microbatches=1) for _ in range(2)]
    same_run(m["arch"], *runs)
    falls(m["arch"], runs[0], fresh=False)
    hist = runs[0]["history"]
    res = dict(cfg=dict(layers=cfg.num_layers, param_dtype=cfg.param_dtype, remat=cfg.remat,
                        batch=m["batch"], seq=m["seq"], optimizer="AdamW factored, float32 master"),
               runs=runs)
    log(f"[lm train {m['arch']}] {cfg.num_layers} of 40 layers at full width, {cfg.param_dtype} "
        f"params, float32 master, factored AdamW, remat {cfg.remat}, B={m['batch']} S={m['seq']}: "
        f"loss {['%.6f' % h['loss'] for h in hist]} (the first batch's "
        f"{runs[0]['first_batch_loss'][0]:.6f} -> {runs[0]['first_batch_loss'][1]:.6f}), aux "
        f"{['%.6f' % h['aux_loss'] for h in hist]}, "
        f"grad norm {['%.4f' % h['grad_norm'] for h in hist]}; step ms "
        f"{['%.3f' % h['ms'] for h in hist]}; peak {runs[0]['peak_mem_bytes'] / 2**30:.3f} GiB "
        f"(init {runs[0]['init_peak_bytes'] / 2**30:.3f}); a second seeded run bitwise equal")
    return res


def micro_check() -> dict:
    """6k c: at llama's full width, ``MICRO_LAYERS`` of its layers, float32
    compute (the reference test's), microbatches 2 against 1 on one global
    batch: the loss at rtol 1e-5, the grads at ``MICRO_TOL`` and within
    ``GRAD_REL`` of each leaf's largest magnitude.  The bf16-compute
    difference is printed beside it."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.lm.api import build
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import tree_leaves_with_path

    res = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=MICRO_LAYERS, dtype=dtype)
        api = build(cfg)
        params = api.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
        batch = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH, seed=0).next()
        batch = {k: v.cuda() for k, v in batch.items()}
        g1, m1 = loss_and_grads(api, params, batch, microbatches=1)
        g2, m2 = loss_and_grads(api, params, batch, microbatches=2)
        worst = max(((float((b.float() - a.float()).abs().max()) / float(a.abs().max()), k)
                     for (k, a), (_, b) in zip(tree_leaves_with_path(g1),
                                               tree_leaves_with_path(g2))))
        dl = abs(float(m2["loss"]) - float(m1["loss"])) / float(m1["loss"])
        res[dtype] = dict(loss=[float(m1["loss"]), float(m2["loss"])], loss_rel=dl,
                          worst_leaf_rel=worst[0], worst_leaf=worst[1])
        if dtype == "float32":
            if dl > 1e-5 or worst[0] > GRAD_REL:
                raise AssertionError(f"microbatches 2 vs 1 at full width: {res[dtype]}")
            for (k, a), (_, b) in zip(tree_leaves_with_path(g1), tree_leaves_with_path(g2)):
                torch.testing.assert_close(b, a, **MICRO_TOL, msg=lambda msg: f"{k}: {msg}")
        log(f"[lm train micro] {cfg.num_layers} layers at full width, {dtype} compute, "
            f"B={TRAIN_BATCH} S={TRAIN_SEQ}: loss {m1['loss']:.6f} (1) vs {m2['loss']:.6f} (2), "
            f"rel {dl:.3e}; worst grad leaf {worst[1]} {worst[0]:.3e} of its largest magnitude"
            + (f" (limits 1e-5, {GRAD_REL}; elementwise {MICRO_TOL})" if dtype == "float32"
               else " (printed only)"))
        del params, g1, g2
        gc.collect()
        torch.cuda.empty_cache()
    return res


def smoke_train_card_vs_cpu() -> dict:
    """6k d: every architecture's smoke config, ``SMOKE_STEPS`` train steps
    (the launcher's smoke optimizer, 2 microbatches) on the card and on the
    CPU from the same init and batches: losses and grad norms at rtol
    ``SMOKE_TOL``.  whisper's frames are cast to float32 here: the
    pipeline's bf16 frames run its encoder in bf16, whose roundings differ
    between the card's and the CPU's products."""
    from repro_torch.configs import ARCH_IDS, smoke_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.lm.api import build
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step
    from repro_torch.train.step import TrainState
    from repro_torch.tree import tree_map

    res = {}
    for arch in ARCH_IDS:
        cfg = smoke_config(arch)
        api = build(cfg)
        opt = AdamWConfig(lr=1e-2, weight_decay=0.0)
        params = api.init(torch.Generator().manual_seed(0), device="cpu")
        out = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev, copy=True), params)  # the step writes in place
            state = TrainState(p, init_opt_state(p, opt),
                               torch.zeros((), dtype=torch.int32, device=dev))
            step = make_train_step(api, opt, microbatches=2,
                                   lr_schedule=lambda s: torch.tensor(1e-2))
            data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8, seed=0,
                                   with_frames=cfg.frontend == "audio",
                                   frame_len=cfg.encoder_seq, d_model=cfg.d_model)
            hist = []
            for _ in range(SMOKE_STEPS):
                batch = data.next()
                if "frames" in batch:
                    batch["frames"] = batch["frames"].float()
                state, m = step(state, batch)
                hist.append([float(m["loss"]), float(m["grad_norm"])])
            out[dev] = hist
        got, want = np.array(out["cuda"]), np.array(out["cpu"])
        rel = float((np.abs(got - want) / np.abs(want)).max())
        res[arch] = dict(cuda=out["cuda"], cpu=out["cpu"], max_rel=rel)
        if not rel <= SMOKE_TOL:
            raise AssertionError(f"{arch} smoke training, card vs CPU: {res[arch]}")
    log(f"[lm train smoke] {SMOKE_STEPS} steps of each smoke config, card vs CPU (rtol "
        f"{SMOKE_TOL}): losses and grad norms max rel "
        + ", ".join(f"{a} {r['max_rel']:.2e}" for a, r in res.items()))
    return res


def train_entry_points() -> dict:
    """6k e: the launcher's ``--smoke`` run with a checkpoint, crashed at
    step 3 and resumed, against an uninterrupted run (bitwise); then
    ``examples_torch/train_lm.py`` at its defaults."""
    from repro_torch.launch import train as lm_train
    from repro_torch.tree import tree_leaves

    ckpt = OUT / "lm_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    silent = lambda *_: None  # noqa: E731
    kw = dict(smoke=True, steps=6, device="cuda", log=silent)
    ref, _ = lm_train.run_training(TRAIN_ARCH, **kw)
    try:
        lm_train.run_training(TRAIN_ARCH, ckpt=str(ckpt), ckpt_every=2, crash_at=3, **kw)
    except RuntimeError as e:
        if "injected failure" not in str(e):
            raise
    else:
        raise AssertionError("the launcher's run did not crash at step 3")
    got, hist = lm_train.run_training(TRAIN_ARCH, ckpt=str(ckpt), ckpt_every=2, **kw)
    if not all(torch.equal(a, b) for a, b in zip(tree_leaves(ref), tree_leaves(got))):
        raise AssertionError("the launcher's crashed and resumed run differs from an "
                             "uninterrupted one")
    shutil.rmtree(ckpt, ignore_errors=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ex = load_example("train_lm").main([])
    if not ex[-1]["loss"] < ex[0]["loss"]:
        raise AssertionError(f"examples_torch/train_lm.py: the loss did not fall: {ex}")
    last = buf.getvalue().strip().splitlines()[-1]
    log(f"[lm train launcher] --smoke, crashed at step 3 and resumed from step 2's checkpoint: "
        f"bitwise the uninterrupted run; examples_torch/train_lm.py on the card: {last}")
    return dict(example=ex, example_last_line=last)


def lm_train_phase(counters: dict, fa_mod) -> dict:
    """Phase 6k: LM training (a: the main path, llama3.2-3b at full width and
    depth; b-e as their functions say)."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm.api import build
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import tree_leaves

    cfg = get_config(TRAIN_ARCH)
    api = build(cfg)
    opt = AdamWConfig(**TRAIN_OPT)
    data_kw = dict(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=0)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    res = dict(cfg=dict(arch=TRAIN_ARCH, layers=cfg.num_layers, param_dtype=cfg.param_dtype,
                        dtype=cfg.dtype, remat=cfg.remat, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                        microbatches=TRAIN_MICRO, steps=TRAIN_STEPS, optimizer=TRAIN_OPT))

    # a. the main path: counters zeroed just before, read just after
    reset_counts(counters, fa_mod)
    run = train_run(api, opt, data_kw, steps=TRAIN_STEPS, microbatches=TRAIN_MICRO)
    launches = {k: fn.launches for k, fn in counters.items()}
    if any(launches.values()):
        raise AssertionError(f"LM training launched a kernel (none is on its path: #7 has no "
                             f"gradient, training runs impl=\"xla\"): {launches}")
    falls(TRAIN_ARCH, run, fresh=True)
    if not run["peak_mem_bytes"] < TRAIN_PEAK_GIB * 2**30:
        raise AssertionError(f"peak memory {run['peak_mem_bytes'] / 2**30:.3f} GiB")
    again = train_run(api, opt, data_kw, steps=TRAIN_STEPS, microbatches=TRAIN_MICRO,
                      profile_steps=2)
    same_run(TRAIN_ARCH, run, again)
    # the activations' cost, on params of the same init
    params = api.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    res["activation_cost"] = act = activation_cost(api, params)
    flops = train_flops(cfg, params, tokens, TRAIN_SEQ)
    n_params = sum(t.numel() for t in tree_leaves(params))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ms = [h["ms"] for h in run["history"]]
    steady = float(np.median(ms[1:]))
    prof = again["profiled"]
    res.update(launches=launches, run=run, again=again, params=n_params, flops=flops,
               cold_ms=ms[0], steady_ms=steady, tokens_s=tokens / (steady / 1e3),
               mfu=flops["model"] / (steady / 1e3 * BF16_PEAK_FLOPS),
               hfu=(flops["model"] + flops["recompute"]) / (steady / 1e3 * BF16_PEAK_FLOPS))
    hist = run["history"]
    log(f"[lm train] {TRAIN_ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model}, {n_params} "
        f"{cfg.param_dtype} params, compute {cfg.dtype}, remat {cfg.remat}; AdamW {TRAIN_OPT}, "
        f"constant lr; B={TRAIN_BATCH} S={TRAIN_SEQ} in {TRAIN_MICRO} microbatches; launches "
        f"{json.dumps(launches)}")
    log(f"[lm train] loss {['%.6f' % h['loss'] for h in hist]} (the first batch's "
        f"{run['first_batch_loss'][0]:.6f} -> {run['first_batch_loss'][1]:.6f}), grad norm "
        f"{['%.4f' % h['grad_norm'] for h in hist]}; a second seeded run bitwise equal (losses, "
        f"grad norms, {len(run['checksums'])} param leaves' checksums)")
    log(f"[lm train] step ms cold {ms[0]:.3f}, steady median {steady:.3f} "
        f"({['%.3f' % t for t in ms[1:]]}), {res['tokens_s']:.1f} tokens/s; peak mem "
        f"{run['peak_mem_bytes'] / 2**30:.3f} GiB (init {run['init_peak_bytes'] / 2**30:.3f}, "
        f"limit {TRAIN_PEAK_GIB}); model FLOPs {flops['model']:.4e} a step (6 N T, N "
        f"{flops['matmul_params']} matmul params, + attention), MFU {res['mfu']:.4f} of "
        f"{BF16_PEAK_FLOPS:.0f} FLOP/s bf16; with remat's recompute ({flops['recompute']:.4e}) "
        f"{res['hfu']:.4f}")
    log(f"[lm train] 2 steps under the profiler: {['%.3f' % t for t in prof['steps_ms']]} ms, "
        f"device busy {prof['device_busy_ms']:.3f} of {prof['device_wall_ms']:.3f} ms, idle share "
        f"{prof['device_idle_share']:.4f}")
    for k in prof["top_kernels"][:8]:
        log(f"[lm train]   {k['device_ms']:9.3f} ms x{k['calls']:<4d} {k['name']}")
    log(f"[lm train] activations' cost, flash forward B={LM_BATCH} S={LM_SEQ} (PERF.md: 147.554 ms "
        f"with F.silu): F.silu {act['old']['median_ms']:.3f} ms {['%.3f' % t for t in act['old']['ms']]}, "
        f"jax.nn's roundings {act['new']['median_ms']:.3f} ms {['%.3f' % t for t in act['new']['ms']]}")
    res["moe"] = moe_train()
    res["micro"] = micro_check()
    res["smoke"] = smoke_train_card_vs_cpu()
    res["entry_points"] = train_entry_points()
    return res


def lm_train_alone() -> dict:
    """Phase 6k alone (``python3 -c 'import chip_smoke as c; c.lm_train_alone()'``);
    chiprun_out/lm_train.json."""
    fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")
    return lm_alone("lm_train", lambda: lm_train_phase(kernel_counters(), fa_mod))


# -- LM training over a data mesh of four cards (run apart, under torchrun) ----------

# llama3.2-3b at phase 6k's width, depth and optimizer over a (4, 1) data mesh: global
# batch 16 x 2048 in 2 microbatches, so each card runs 2 microbatches of 2 rows (4 rows
# a card, the per-card load of phase 6k)
DP_BATCH, DP_MICRO, DP_STEPS, DP_CKPT_STEP = 16, 2, 10, 3
DP_ONE_MICRO = 8  # a. one card's step over the same 16 rows: 8 microbatches of the same 2-row blocks
DP_REL = 1e-5     # a. the loss and each reduced grad leaf within this of one card's (of its scale)
DP_WIRE_REL = 1e-2  # e. the bf16 wire's grads within this of the float32 wire's (of each leaf's scale)
DP_ONE_STEPS = 4  # d. one card's step at 4 rows, timed on every card at once
NVLINK_BYTES_S = 450e9  # NVLink 4, one direction
# f. the MoE balance loss over the data group: dbrx-132b at full width, 1 of its 40 layers,
# float32 params and compute (the config's bf16 params round each microbatch's grads to
# bf16, so rows grouped otherwise give other grads), remat full, global batch 8 x 1024 in 2
# microbatches (1 row a card each); one card's step over the same rows takes the same 4-row
# microbatches whole (S = 1024: its 4 rows beside 36 GB of float32 params and grads)
DP_MOE = dict(arch="dbrx-132b", layers=1, batch=8, seq=1024)
DP_MOE_REL = GRAD_REL  # loss, aux and each grad leaf (of its scale): float32 sums in other orders


def rank_rows_loss(api, params, batch, ranks: int, rank: int, group, **on_mesh) -> float:
    """The loss (``lm_loss`` with no grad) of a global batch, each rank over
    its own rows 2 at a time, averaged over the data group; ``on_mesh``:
    ``lm_loss``'s mesh and placements, where the params are pieces."""
    from repro_torch.train import lm_loss
    from repro_torch.train.step import data_rows

    import torch.distributed as dist

    rows = data_rows(batch, DP_MICRO, ranks, rank)
    n = rows["tokens"].shape[0]
    with torch.no_grad():
        losses = [lm_loss(api, params, {k: v[i:i + 2] for k, v in rows.items()},
                          **on_mesh)[1]["loss"] for i in range(0, n, 2)]
    mean = torch.stack(losses).mean().reshape(1)
    dist.all_reduce(mean, group=group)
    return float(mean) / ranks


def moe_data_parallel(mesh, world: int, rank: int, say) -> tuple[dict, bool]:
    """f: ``DP_MOE``'s first step over the data group (its balance loss takes
    the group's mean of ``me`` and ``ce`` in the forward, and again in
    remat's recompute on autograd's thread) against one card's over the
    same rows on rank 0: loss, aux loss and each grad leaf within
    ``DP_MOE_REL``."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.lm.api import build
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import tree_leaves_with_path

    m = DP_MOE
    cfg = dataclasses.replace(get_config(m["arch"]), num_layers=m["layers"], dtype="float32",
                              param_dtype="float32", remat="full")
    api = build(cfg)
    dev = torch.device("cuda", torch.cuda.current_device())
    params = api.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = {k: v.to(dev) for k, v in SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=m["seq"], global_batch=m["batch"], seed=0).next().items()}
    torch.cuda.reset_peak_memory_stats()
    one = None
    if rank == 0:  # one card's grads wait on the host while the group runs
        g1, m1 = loss_and_grads(api, params, batch, microbatches=DP_MICRO)
        one = ({k: v.cpu() for k, v in tree_leaves_with_path(g1)},
               {k: float(m1[k]) for k in ("loss", "aux_loss")})
        del g1
        gc.collect()
        torch.cuda.empty_cache()
    (grads, mx), ms = timed(lambda: loss_and_grads(api, params, batch, microbatches=DP_MICRO,
                                                   mesh=mesh))
    res, ok = dict(cfg=dict(m, microbatches=DP_MICRO, dtype=cfg.dtype,
                            param_dtype=cfg.param_dtype, remat=cfg.remat), data_group_ms=ms,
                   peak_mem_bytes=torch.cuda.max_memory_allocated()), True
    if rank == 0:
        g1, m1 = one
        rel = {k: abs(float(mx[k]) - m1[k]) / abs(m1[k]) for k in ("loss", "aux_loss")}
        worst = max((float((b - g1[k].to(dev)).abs().max()) / float(g1[k].abs().max()), k)
                    for k, b in tree_leaves_with_path(grads))
        res.update(one_card=m1, data_group={k: float(mx[k]) for k in ("loss", "aux_loss")},
                   rel=rel, worst_leaf_rel=worst[0], worst_leaf=worst[1])
        ok = max(rel.values()) <= DP_MOE_REL and worst[0] <= DP_MOE_REL
        say(f"[lm dp f] {m['arch']}, {cfg.num_layers} of 40 layers at full width, float32 "
            f"params and compute, remat full, B={m['batch']} S={m['seq']} in {DP_MICRO} microbatches "
            f"({m['batch'] // DP_MICRO // world} row a card each): loss {m1['loss']:.6f} one card, "
            f"{float(mx['loss']):.6f} the group (rel {rel['loss']:.3e}); aux {m1['aux_loss']:.6f} "
            f"vs {float(mx['aux_loss']):.6f} (rel {rel['aux_loss']:.3e}); worst grad leaf "
            f"{worst[1]} {worst[0]:.3e} of its scale (limit {DP_MOE_REL}); {ms:.1f} ms; rank 0's "
            f"peak {res['peak_mem_bytes'] / 2**30:.3f} GiB")
    del params, grads, one
    gc.collect()
    torch.cuda.empty_cache()
    return res, ok


def lm_data_parallel() -> dict:
    """LM training over a data mesh of four cards, one process a card:

        torchrun --nproc-per-node 4 --no-python python3 -c 'import chip_smoke as c; c.lm_data_parallel()'

    llama3.2-3b at full width and depth as phase 6k (float32 params, bf16
    compute, remat full, AdamW lr 3e-4 constant) over the ``(4, 1)`` data
    mesh of ``launch.mesh.make_data_mesh`` (NCCL), global batch 16 × 2,048
    in 2 microbatches (each card 2 microbatches of 2 rows):

    a. the first step's loss and reduced grads on rank 0 against one card's
       ``loss_and_grads`` over the same 16 rows in 8 microbatches of the
       same 2-row blocks (only the sum order differs): within ``DP_REL`` of
       the loss and of each leaf's largest magnitude;
    b. 10 steps through ``make_train_step(mesh=)`` and ``train_loop(mesh=,
       placements=)`` (a checkpoint written at step 3 by rank 0), each timed
       with CUDA events: every rank's param checksums (``leaf_checksums``)
       equal after every step; the loss falls as phase 6k's (the first
       batch's after the last step, and the last three steps' mean below
       the first's); peak memory per rank;
    c. ``train_loop`` resumed from the step-3 checkpoint (restored in place
       on the writer, broadcast to the others) for step 4: its checksums
       equal the uninterrupted run's after step 4;
    d. the steady step (median of steps 2-10), tokens/s, and the scaling
       efficiency: 4-card tokens/s over 4 × one card's at 4 rows (its own
       step with no mesh, 2 microbatches of 2 rows, timed on every card at
       once in the same run); 2 steps under the profiler: rank 0's NCCL
       kernel time and idle share;
    e. one step's grads with ``grad_dtype="bfloat16"`` (bf16 on the wire,
       float32 accumulators) within ``DP_WIRE_REL`` of each leaf's scale of
       the float32 wire's, and half its bytes on the wire
       (``launch.opstats.CollectiveCounter``);
    f. :func:`moe_data_parallel`.

    Every kernel's launch count is set to 0 just before b's steps and read
    just after: none may launch (training runs impl "xla").  The
    checkpoint goes under ``build/`` (gitignored; the run fails at once
    where it has no room) and is deleted at the end.  Rank 0 prints the
    results and writes lm_data_parallel.json to the output directory."""
    import os

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.dist import make_rules, param_shardings
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.launch.opstats import CollectiveCounter
    from repro_torch.models.lm.api import build
    from repro_torch.obs import MetricsRegistry
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step, train_loop
    from repro_torch.train.step import TrainState, loss_and_grads, train_state_axes
    from repro_torch.tree import tree_leaves, tree_leaves_with_path

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl")
    ckpt = None
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        mesh = make_data_mesh(world)  # each rank on card LOCAL_RANK
        group = mesh.get_group("data")
        dev = torch.device("cuda", torch.cuda.current_device())
        say = log if rank == 0 else (lambda *_: None)
        fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")
        counters = kernel_counters()
        cfg = get_config(TRAIN_ARCH)
        api = build(cfg)
        opt = AdamWConfig(**TRAIN_OPT)
        lr = lambda s: torch.tensor(opt.lr)  # noqa: E731
        data_kw = dict(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=DP_BATCH, seed=0)
        tokens = DP_BATCH * TRAIN_SEQ
        res = dict(card=card_line(), world=world, cfg=dict(
            arch=TRAIN_ARCH, layers=cfg.num_layers, param_dtype=cfg.param_dtype, dtype=cfg.dtype,
            remat=cfg.remat, global_batch=DP_BATCH, seq=TRAIN_SEQ, microbatches=DP_MICRO,
            rows_a_card=DP_BATCH // world, optimizer=TRAIN_OPT))
        say(f"[lm dp] {res['card']}; {world} ranks; {json.dumps(res['cfg'])}")
        checks = {}

        # a. the data group's first grads against one card's over the same 16 rows
        params = api.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        first = {k: v.to(dev) for k, v in SyntheticLMData(**data_kw).next().items()}
        one = None
        if rank == 0:
            one, one_ms = timed(lambda: loss_and_grads(api, params, first,
                                                       microbatches=DP_ONE_MICRO))
        dist.barrier()
        (grads, m), dp_ms = timed(lambda: loss_and_grads(api, params, first,
                                                         microbatches=DP_MICRO, mesh=mesh))
        if rank == 0:
            g1, m1 = one
            loss_rel = abs(float(m["loss"]) - float(m1["loss"])) / float(m1["loss"])
            worst = max((float((b - a).abs().max()) / float(a.abs().max()), k)
                        for (k, a), (_, b) in zip(tree_leaves_with_path(g1),
                                                  tree_leaves_with_path(grads)))
            res["a"] = dict(loss=[float(m1["loss"]), float(m["loss"])], loss_rel=loss_rel,
                            worst_leaf_rel=worst[0], worst_leaf=worst[1], one_card_ms=one_ms,
                            data_group_ms=dp_ms)
            checks["a"] = loss_rel <= DP_REL and worst[0] <= DP_REL
            say(f"[lm dp a] first step, rank 0 vs one card over the same {DP_BATCH} rows "
                f"({DP_ONE_MICRO} microbatches of 2): loss {float(m1['loss']):.6f} vs "
                f"{float(m['loss']):.6f} (rel {loss_rel:.3e}); worst reduced grad leaf {worst[1]} "
                f"{worst[0]:.3e} of its largest magnitude (limit {DP_REL}); grads {one_ms:.1f} ms "
                f"on one card, {dp_ms:.1f} ms over the group")
            del g1, one
        del grads
        gc.collect()
        torch.cuda.empty_cache()

        # b. 10 steps over the mesh, a checkpoint at step 3, checksums after every step
        state = TrainState(params, init_opt_state(params, opt),
                           torch.zeros((), dtype=torch.int32, device=dev))
        del params
        # rank 0 writes the checkpoints under build/: two of the state (c's resumed run
        # writes step 4's)
        need = 2.1 * sum(t.numel() * t.element_size() for t in tree_leaves(state))
        free = [0]
        if rank == 0:
            (ROOT / "build").mkdir(exist_ok=True)
            free[0] = shutil.disk_usage(ROOT / "build").free
        dist.broadcast_object_list(free, src=0, group=group)
        if free[0] < need:
            raise AssertionError(f"the checkpoints need {need / 1e9:.1f} GB under "
                                 f"{ROOT / 'build'}, which has {free[0] / 1e9:.1f} GB free")
        ckpt = str(ROOT / "build" / "lm_data_parallel_ckpt")
        if rank == 0:
            shutil.rmtree(ckpt, ignore_errors=True)
        say(f"[lm dp] checkpoints need {need / 1e9:.1f} GB: {ckpt} ({free[0] / 1e9:.1f} GB free)")
        placements = param_shardings(mesh, make_rules(batch_shard=True, fsdp=False),
                                     train_state_axes(api, opt, state.params))
        step = make_train_step(api, opt, microbatches=DP_MICRO, lr_schedule=lr, mesh=mesh)
        step_ms, sums = [], []

        def recorded(st, batch):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            st, mx = step(st, batch)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            sums.append(leaf_checksums(st.params))
            return st, mx

        seen = [rank_rows_loss(api, state.params, first, world, rank, group)]
        torch.cuda.reset_peak_memory_stats()
        data = SyntheticLMData(**data_kw)
        loop_kw = dict(log_every=1, log=lambda *_: None, mesh=mesh, placements=placements,
                       registry=MetricsRegistry())
        reset_counts(counters, fa_mod)  # b is the main path: counts zeroed just before
        t0 = time.perf_counter()
        state, hist = train_loop(state=state, train_step=recorded, data=data, steps=DP_CKPT_STEP,
                                 ckpt_dir=ckpt, ckpt_every=DP_CKPT_STEP, **loop_kw)
        ckpt_s = time.perf_counter() - t0
        state, more = train_loop(state=state, train_step=recorded, data=data,
                                 steps=DP_STEPS - DP_CKPT_STEP, **loop_kw)
        launches = {k: fn.launches for k, fn in counters.items()}  # and read just after
        hist += more
        times = list(step_ms)  # b's steps (c's resumed step records after them)
        peak = torch.cuda.max_memory_allocated()
        seen.append(rank_rows_loss(api, state.params, first, world, rank, group))
        ranks_sums = [None] * world
        dist.all_gather_object(ranks_sums, sums, group=group)
        peaks = [None] * world
        dist.all_gather_object(peaks, peak, group=group)
        run = dict(history=[{k: h[k] for k in ("loss", "aux_loss", "grad_norm")} | {"ms": t}
                            for h, t in zip(hist, times)], first_batch_loss=seen)
        checks["b_replicas"] = all(s == ranks_sums[0] for s in ranks_sums)
        checks["b_no_kernel"] = not any(launches.values())
        try:
            falls(f"{TRAIN_ARCH} over {world} cards", run, fresh=True)
            checks["b_falls"] = True
        except AssertionError as e:
            say(f"[lm dp b] {e}")
            checks["b_falls"] = False
        steady = float(np.median(times[1:]))
        res["b"] = dict(run=run, peak_mem_bytes=peaks, replicas_bitwise=checks["b_replicas"],
                        first_three_ckpt_s=ckpt_s, launches=launches)
        say(f"[lm dp b] {DP_STEPS} steps: loss {['%.6f' % h['loss'] for h in hist]} (the first "
            f"batch's {seen[0]:.6f} -> {seen[1]:.6f}), grad norm "
            f"{['%.4f' % h['grad_norm'] for h in hist]}; the {world} ranks' param checksums "
            f"{'equal' if checks['b_replicas'] else 'DIFFER'} after every step; peak memory "
            f"{['%.3f GiB' % (p / 2**30) for p in peaks]}; steps 1-3 with the step-3 checkpoint "
            f"{ckpt_s:.1f} s; rank 0's kernel launches in the {DP_STEPS} steps "
            f"{json.dumps(launches)} (none may launch)")

        # c. resumed from the step-3 checkpoint for step 4
        t0 = time.perf_counter()
        state, resumed = train_loop(state=state, train_step=recorded, data=SyntheticLMData(
            **data_kw), steps=DP_CKPT_STEP + 1, ckpt_dir=ckpt, ckpt_every=DP_STEPS, **loop_kw)
        resume_s = time.perf_counter() - t0
        dist.barrier()
        if rank == 0:
            shutil.rmtree(ckpt, ignore_errors=True)
        checks["c"] = len(resumed) == 1 and sums[-1] == sums[DP_CKPT_STEP]
        res["c"] = dict(resumed_loss=resumed[0]["loss"] if resumed else None,
                        uninterrupted_loss=hist[DP_CKPT_STEP]["loss"], bitwise=checks["c"],
                        resume_s=resume_s)
        say(f"[lm dp c] resumed from step {DP_CKPT_STEP}'s checkpoint for step "
            f"{DP_CKPT_STEP + 1}: loss {res['c']['resumed_loss']} vs "
            f"{res['c']['uninterrupted_loss']}, params "
            f"{'bitwise the uninterrupted run' if checks['c'] else 'DIFFER'} (restore, step and "
            f"step 4's checkpoint {resume_s:.1f} s)")

        # d. one card's step at 4 rows, on every card at once; then the profiler
        one_kw = dict(data_kw, global_batch=DP_BATCH // world)
        one_step = make_train_step(api, opt, microbatches=DP_MICRO, lr_schedule=lr)
        one_data = SyntheticLMData(**one_kw)
        one_ms = []
        for _ in range(DP_ONE_STEPS):
            batch = one_data.next()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, _ = one_step(state, batch)
            end.record()
            end.synchronize()
            one_ms.append(start.elapsed_time(end))
        dist.barrier()
        one_steady = float(np.median(one_ms[1:]))
        box = [state]

        def dp_step():
            box[0], _ = step(box[0], data.next())

        prof = profiled(dp_step, 2)
        state = box.pop()
        tok_s = tokens / (steady / 1e3)
        one_tok_s = one_kw["global_batch"] * TRAIN_SEQ / (one_steady / 1e3)
        grad_bytes = sum(t.numel() * 4 for t in tree_leaves(state.params))
        ring_ms = 2 * (world - 1) / world * grad_bytes / NVLINK_BYTES_S * 1e3
        res["d"] = dict(step_ms=times, steady_ms=steady, tokens_s=tok_s, one_card_step_ms=one_ms,
                        one_card_steady_ms=one_steady, one_card_tokens_s=one_tok_s,
                        scaling_efficiency=tok_s / (world * one_tok_s), profiled=prof,
                        grad_bytes=grad_bytes, ring_all_reduce_bound_ms=ring_ms)
        say(f"[lm dp d] step ms {['%.3f' % t for t in times]}: steady (median of steps 2-"
            f"{DP_STEPS}) {steady:.3f}, {tok_s:.1f} tokens/s; one card at "
            f"{one_kw['global_batch']} rows {['%.3f' % t for t in one_ms]}: steady "
            f"{one_steady:.3f}, {one_tok_s:.1f} tokens/s; scaling efficiency "
            f"{res['d']['scaling_efficiency']:.4f}; the grads' all-reduce moves {grad_bytes} B a "
            f"rank (ring bound {ring_ms:.3f} ms at {NVLINK_BYTES_S / 1e9:.0f} GB/s)")
        say(f"[lm dp d] 2 steps under the profiler (rank 0): {['%.3f' % t for t in prof['steps_ms']]}"
            f" ms, device busy {prof['device_busy_ms']:.3f} of {prof['device_wall_ms']:.3f} ms, "
            f"idle share {prof['device_idle_share']:.4f}, NCCL kernels {prof['nccl_ms']:.3f} ms")
        for k in prof["top_kernels"]:
            say(f"[lm dp d]   {k['device_ms']:9.3f} ms x{k['calls']:<4d} {k['name']}")

        # e. the bf16 wire against the float32 wire, on the current params
        params = state.params
        del state, box
        gc.collect()
        torch.cuda.empty_cache()
        wire = {}
        for gdt in (None, "bfloat16"):
            counter = CollectiveCounter()
            with counter:
                g, mx = loss_and_grads(api, params, first, microbatches=DP_MICRO, grad_dtype=gdt,
                                       mesh=mesh)
            wire[gdt] = (g, float(mx["loss"]), dict(counter.bytes))
        g32, l32, b32 = wire[None]
        g16, l16, b16 = wire["bfloat16"]
        worst = max((float((b - a).abs().max()) / float(a.abs().max()), k)
                    for (k, a), (_, b) in zip(tree_leaves_with_path(g32),
                                              tree_leaves_with_path(g16)))
        ar32, ar16 = b32.get("all-reduce", 0), b16.get("all-reduce", 0)
        checks["e"] = worst[0] <= DP_WIRE_REL and 0.45 <= ar16 / ar32 <= 0.55
        res["e"] = dict(loss=[l32, l16], worst_leaf_rel=worst[0], worst_leaf=worst[1],
                        wire_bytes={"float32": b32, "bfloat16": b16}, ratio=ar16 / ar32)
        say(f"[lm dp e] grad_dtype=bfloat16: worst grad leaf {worst[1]} {worst[0]:.3e} of its "
            f"largest magnitude (limit {DP_WIRE_REL}); all-reduce bytes a rank {ar16} vs {ar32} "
            f"(ratio {ar16 / ar32:.4f}); loss {l16:.6f} vs {l32:.6f}")
        del wire, g32, g16, params
        gc.collect()
        torch.cuda.empty_cache()
        res["f"], checks["f"] = moe_data_parallel(mesh, world, rank, say)
        res["checks"] = checks
        ok = torch.tensor(int(all(checks.values())), device=dev)
        dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        res["all_ranks_ok"] = bool(ok)
        if rank == 0:
            OUT.mkdir(exist_ok=True)
            (OUT / "lm_data_parallel.json").write_text(json.dumps(res, indent=1, default=str))
            log(f"[lm dp] checks {json.dumps(checks)}; all ranks ok: {res['all_ranks_ok']}")
            log(res["card"])
        if not res["all_ranks_ok"]:
            raise AssertionError(f"rank {rank}: LM training over the data mesh failed a check "
                                 f"({checks}; see {OUT / 'lm_data_parallel.json'})")
        return res
    finally:
        if ckpt and dist.get_rank() == 0:
            shutil.rmtree(ckpt, ignore_errors=True)
        dist.destroy_process_group()


# -- the LM under the model axis (tp), four cards ---------------------------------

MS_REL = 1e-5  # float32: logits, loss and each grad leaf within this of one card's (of its scale)
MS_STEPS = 10  # b. steps a mesh (phase 6k's loss rises for about five before it falls)
MS_SHAPES = ((1, 4), (2, 2))  # b. (data, model)
MS_DECODE = dict(batch=4, prompt=8, steps=16, cache=64)  # c. float32 llama, greedy
MS_MOE_F32 = dict(layers=2, seq=1024)  # d. float32 at a depth one card holds
MS_MOE_BIG = 16  # d. dbrx-132b layers in bf16: 109 GB of weights, more than one card holds


def ms_device() -> torch.device:
    """This rank's card (``make_mesh`` sets it from ``LOCAL_RANK``)."""
    return torch.device("cuda", torch.cuda.current_device())


def ms_config(arch: str, **over):
    """The full config of ``arch`` with ``over`` replaced."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), **over)


def ms_pieces(tree, placements, mesh):
    """This rank's pieces of a logical tree (``dist.local_slice``)."""
    from repro_torch.dist import local_slice, map_placements

    return map_placements(lambda pl, x: local_slice(x, pl, mesh), placements, tree)


def ms_logical(tree, placements, mesh):
    """The logical leaves of a tree of pieces (a collective)."""
    from repro_torch.dist import gather_leaf, map_placements

    return map_placements(lambda pl, x: gather_leaf(x, pl, mesh), placements, tree)


def ms_draw_pieces(cfg, placements, mesh, dev):
    """This rank's pieces of random params (seed 0), drawn one logical leaf
    at a time on the card and cut at once: a model whose logical weights
    one card cannot hold.  Every rank draws the same leaves in the same
    order."""
    from repro_torch.dist import local_slice, map_placements
    from repro_torch.models.lm.layers import init_from_specs, torch_dtype
    from repro_torch.models.lm.transformer import decoder_specs

    gen = torch.Generator(device=dev).manual_seed(0)
    dtype = torch_dtype(cfg.param_dtype)

    def draw(pl, spec):
        leaf = init_from_specs({"x": spec}, gen, dtype, dev)["x"]
        piece = local_slice(leaf, pl, mesh)
        del leaf
        return piece

    return map_placements(draw, placements, decoder_specs(cfg))


def ms_same_pieces(sums: list, placements, mesh) -> bool:
    """Whether every two ranks that hold the same piece of a leaf (the same
    coordinates on the mesh dimensions of more than one rank that shard it)
    hold it bit for bit: ``sums`` are the ranks' ``leaf_checksums`` in
    rank order."""
    import torch.distributed as dist

    from repro_torch.dist import placement_leaves
    from torch.distributed.tensor import Shard

    coords = [None] * dist.get_world_size()
    dist.all_gather_object(coords, mesh.get_coordinate())
    for i, pl in enumerate(placement_leaves(placements)):
        dims = [d for d, p in enumerate(pl) if isinstance(p, Shard) and mesh.size(d) > 1]
        seen = {}
        for r, c in enumerate(coords):
            if seen.setdefault(tuple(c[d] for d in dims), sums[r][i]) != sums[r][i]:
                return False
    return True


def ms_worst(got_tree, want: dict, dev) -> tuple[float, str]:
    """max over leaves of max |got - want| / max |want| (``want`` by path,
    on the host; one leaf on the card at a time)."""
    from repro_torch.tree import tree_leaves_with_path

    worst = (0.0, "")
    for k, g in tree_leaves_with_path(got_tree):
        w = want[k].to(dev)
        worst = max(worst, (float((g.float() - w.float()).abs().max()) / float(w.abs().max()), k))
        del w
    return worst


def ms_forward(mesh, rank: int, counters: dict, fa_mod, say) -> tuple[dict, dict]:
    """a. llama3.2-3b at full width and depth on the (1, 4) mesh."""
    import torch.distributed as dist

    from repro_torch.dist import make_rules, param_shardings
    from repro_torch.models.lm import attention
    from repro_torch.models.lm.api import build

    dev = ms_device()
    res, checks = {}, {}
    group = mesh.get_group("model")
    # float32: one card's forward on rank 0 against the group's, the same tokens
    cfg = ms_config(LM_ARCH, dtype="float32")
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    pl = param_shardings(mesh, make_rules(fsdp=cfg.fsdp), api.axes())
    pieces = ms_pieces(params, pl, mesh)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                            (LM_BATCH, LM_SEQ_F32)),
                           dtype=torch.int32, device=dev)
    with torch.no_grad():
        one = api.forward(params, toks)[0] if rank == 0 else None
        del params
        gc.collect()
        torch.cuda.empty_cache()
        got, ms32 = timed(lambda: api.forward(pieces, toks, mesh=mesh, placements=pl)[0])
    sums = [None] * dist.get_world_size(group)
    dist.all_gather_object(sums, leaf_checksums([got]), group=group)
    checks["a_f32_bitwise"] = all(s == sums[0] for s in sums)
    if rank == 0:
        rel = float((got - one).abs().max()) / float(one.abs().max())
        checks["a_f32"] = rel <= MS_REL
        res["float32"] = dict(batch=LM_BATCH, seq=LM_SEQ_F32, rel=rel, ms=ms32,
                              bitwise_in_group=checks["a_f32_bitwise"])
        say(f"[lm tp a] float32, B={LM_BATCH} S={LM_SEQ_F32}, xla: the (1, 4) group's logits "
            f"within {rel:.3e} of one card's scale (limit {MS_REL}), "
            f"{'bitwise equal' if checks['a_f32_bitwise'] else 'NOT equal'} on the 4 ranks; "
            f"{ms32:.1f} ms")
    del pieces, got, one
    gc.collect()
    torch.cuda.empty_cache()

    # bf16, flash: #7 on each rank's own heads, counted; one card's forward timed on rank 0
    cfg = ms_config(LM_ARCH)
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    pl = param_shardings(mesh, make_rules(fsdp=cfg.fsdp), api.axes())
    pieces = ms_pieces(params, pl, mesh)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                            (LM_BATCH, LM_SEQ)),
                           dtype=torch.int32, device=dev)
    with torch.no_grad():
        one_ms, one = [], None
        if rank == 0:
            one = api.forward(params, toks, impl="flash")[0]
            one_ms = [timed(lambda: api.forward(params, toks, impl="flash"))[1] for _ in range(3)]
        del params
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        real, shapes = attention.flash_attention, []

        def recorded(q, k, v, **kw):
            shapes.append((tuple(q.shape), tuple(k.shape)))
            return real(q, k, v, **kw)

        attention.flash_attention = recorded
        try:
            reset_counts(counters, fa_mod)  # the main path: counts zeroed just before
            got, cold = timed(lambda: api.forward(pieces, toks, impl="flash", mesh=mesh,
                                                  placements=pl)[0])
            launches = {k: fn.launches for k, fn in counters.items()}  # and read just after
            by_route = dict(fa_mod.flash_attention.launches_by_route)
        finally:
            attention.flash_attention = real
        steady = [timed(lambda: api.forward(pieces, toks, impl="flash", mesh=mesh,
                                            placements=pl))[1] for _ in range(3)]
        prof = profiled(lambda: api.forward(pieces, toks, impl="flash", mesh=mesh,
                                            placements=pl), 2)
    m = mesh.size(1)
    heads = ((LM_BATCH, cfg.num_heads // m, LM_SEQ, cfg.head_dim),
             (LM_BATCH, cfg.num_kv_heads // m, LM_SEQ, cfg.head_dim))
    want = {k: 0 for k in counters} | {"flash_attention": cfg.num_layers}
    checks["a_launches"] = (launches == want and by_route.get("wgmma") == cfg.num_layers
                            and shapes == [heads] * cfg.num_layers)
    # #7 at a rank's shape against its plain version (after the counts were read)
    case = (LM_BATCH, cfg.num_heads // m, cfg.num_kv_heads // m, LM_SEQ, LM_SEQ, cfg.head_dim,
            True, None)
    q, k, v = flash_operands(case, torch.bfloat16)
    out, plain = fa_mod.flash_attention(q, k, v, causal=True), \
        fa_mod.flash_attention_plain(q, k, v, causal=True)
    kernel = dict(max_abs_err=float((out.float() - plain.float()).abs().max()),
                  bitwise_share=float((out == plain).float().mean()),
                  one_rounding=bool(torch.allclose(out.float(), plain.float(), atol=1e-4,
                                                   rtol=8e-3)))
    checks["a_kernel"] = kernel["one_rounding"] and \
        kernel["bitwise_share"] >= fa_mod.BITWISE_SHARE_MIN
    del q, k, v, out, plain
    kernel.update(flash_shape_times(fa_mod, case, f"llama3.2-3b's heads of one of {m} ranks"))
    res["bf16_flash"] = dict(batch=LM_BATCH, seq=LM_SEQ, route=attention.attention_route(cfg, m),
                             launches=launches, launches_by_route=by_route,
                             kernel_shapes=sorted(set(map(str, shapes))), kernel=kernel,
                             cold_ms=cold,
                             steady_ms=steady, one_card_ms=one_ms, profiled=prof,
                             peak_mem_bytes=torch.cuda.max_memory_allocated())
    if rank == 0:
        top1 = top1_agreement(got, one, cfg.vocab_size)
        res["bf16_flash"]["top1_vs_one_card"] = top1
        say(f"[lm tp a] bf16, flash, B={LM_BATCH} S={LM_SEQ}: route "
            f"{res['bf16_flash']['route']}, launches {json.dumps(launches)}, #7 by route "
            f"{json.dumps(by_route)}, #7's (q, k) shapes {res['bf16_flash']['kernel_shapes']} "
            f"(expected {cfg.num_layers} of {heads}); ms cold {cold:.3f}, steady "
            f"{['%.3f' % t for t in steady]}; one card {['%.3f' % t for t in one_ms]}; top-1 "
            f"agreement with one card's logits {top1:.6f}")
        say(f"[lm tp a] #7 at {case} bf16 against its plain version: max |d| "
            f"{kernel['max_abs_err']:.3e}, one rounding {kernel['one_rounding']}, bitwise share "
            f"{kernel['bitwise_share']:.6f} (>= {fa_mod.BITWISE_SHARE_MIN})")
        say(f"[lm tp a] 2 forwards under the profiler (rank 0): "
            f"{['%.3f' % t for t in prof['steps_ms']]} ms, device busy {prof['device_busy_ms']:.3f}"
            f" of {prof['device_wall_ms']:.3f}, idle {prof['device_idle_share']:.4f}, NCCL "
            f"{prof['nccl_ms']:.3f} ms")
        for k in prof["top_kernels"][:6]:
            say(f"[lm tp a]   {k['device_ms']:9.3f} ms x{k['calls']:<4d} {k['name']}")
    del pieces, got, one
    gc.collect()
    torch.cuda.empty_cache()
    return res, checks


def ms_one_card_grads(api32, first: dict, dev) -> tuple[dict, float, tuple[float, str]]:
    """b. one card's float32 grads (by path, on the host) and loss over the
    global batch in the meshes' own microbatches (``DP_MICRO`` of 8 rows:
    on (1, 4) every rank runs those rows, on (2, 2) each data rank 4 of
    them), and the floor of one card against itself: the worst leaf of the
    same grads in ``lm_data_parallel``'s 8 microbatches of 2 rows (only the
    float32 sums' order differs)."""
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import tree_leaves_with_path

    params = api32.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    g, m = loss_and_grads(api32, params, first, microbatches=DP_MICRO)
    want = {k: v.cpu() for k, v in tree_leaves_with_path(g)}
    del g
    gc.collect()
    g2, _ = loss_and_grads(api32, params, first, microbatches=DP_ONE_MICRO)
    floor = ms_worst(g2, want, dev)
    del params, g2
    gc.collect()
    torch.cuda.empty_cache()
    return want, float(m["loss"]), floor


def ms_train(shape, one, rank: int, counters: dict, fa_mod, say) -> tuple[dict, dict]:
    """b. the llama3.2-3b train step on one mesh ``shape`` under
    ``make_rules(fsdp=True)``."""
    import torch.distributed as dist

    from repro_torch.data import SyntheticLMData
    from repro_torch.dist import make_rules, param_shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm.api import build
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step
    from repro_torch.train.step import TrainState, data_group, loss_and_grads, train_state_axes

    mesh = make_mesh(shape, ("data", "model"), device_type=ms_device().type)
    dev = ms_device()
    tag = f"[lm tp b {shape[0]}x{shape[1]}]"
    cfg = ms_config(TRAIN_ARCH)
    opt = AdamWConfig(**TRAIN_OPT)
    rules = make_rules(fsdp=cfg.fsdp)
    data_kw = dict(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=DP_BATCH, seed=0)
    first = {k: v.to(dev) for k, v in SyntheticLMData(**data_kw).next().items()}
    res, checks = dict(mesh=list(shape), rules="make_rules(fsdp=True)"), {}

    # the first step's float32 grads against one card's
    api32 = build(dataclasses.replace(cfg, dtype="float32"))
    params = api32.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    ppl = param_shardings(mesh, rules, api32.axes())
    pieces = ms_pieces(params, ppl, mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    (grads, m), ms = timed(lambda: loss_and_grads(api32, pieces, first, microbatches=DP_MICRO,
                                                  mesh=mesh, placements=ppl))
    whole = ms_logical(grads, ppl, mesh)
    del grads
    if rank == 0:
        g1, l1, floor = one
        worst = ms_worst(whole, g1, dev)
        loss_rel = abs(float(m["loss"]) - l1) / l1
        checks["b_f32"] = loss_rel <= MS_REL and worst[0] <= MS_REL
        res["float32_first_step"] = dict(loss=[l1, float(m["loss"])], loss_rel=loss_rel,
                                         worst_leaf_rel=worst[0], worst_leaf=worst[1],
                                         one_card_floor=floor, grads_ms=ms)
        say(f"{tag} float32 compute, the first step's grads over {DP_BATCH} x {TRAIN_SEQ} rows in "
            f"{DP_MICRO} microbatches: loss {l1:.6f} one card, {float(m['loss']):.6f} the mesh "
            f"(rel {loss_rel:.3e}); worst grad leaf {worst[1]} {worst[0]:.3e} of its scale (limit "
            f"{MS_REL}); one card against itself in {DP_ONE_MICRO} microbatches: {floor[1]} "
            f"{floor[0]:.3e}; {ms:.1f} ms")
    del whole, pieces
    gc.collect()
    torch.cuda.empty_cache()

    # the config's bf16 compute: MS_STEPS steps, the pieces' checksums after each
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    state = TrainState(params, init_opt_state(params, opt),
                       torch.zeros((), dtype=torch.int32, device=dev))
    pl = param_shardings(mesh, rules, train_state_axes(api, opt, state.params))
    state = ms_pieces(state, pl, mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    step = make_train_step(api, opt, microbatches=DP_MICRO, mesh=mesh, placements=pl,
                           lr_schedule=lambda s: torch.tensor(opt.lr))
    data = SyntheticLMData(**data_kw)
    group, ranks, drank = data_group(mesh)
    on_mesh = dict(mesh=mesh, placements=pl.params)
    seen = [rank_rows_loss(api, state.params, first, ranks, drank, group, **on_mesh)]
    torch.cuda.reset_peak_memory_stats()
    hist, times, sums = [], [], []
    reset_counts(counters, fa_mod)  # the main path: counts zeroed just before
    for _ in range(MS_STEPS):
        batch = data.next()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, mx = step(state, batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        hist.append({k: float(v) for k, v in mx.items()})
        sums.append(leaf_checksums(state.params))
    launches = {k: fn.launches for k, fn in counters.items()}  # and read just after
    peak = torch.cuda.max_memory_allocated()
    seen.append(rank_rows_loss(api, state.params, first, ranks, drank, group, **on_mesh))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, sums)
    hists = [None] * dist.get_world_size()
    dist.all_gather_object(hists, hist)
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    checks["b_pieces"] = all(ms_same_pieces([s[i] for s in every], pl.params, mesh)
                             for i in range(MS_STEPS)) and all(h == hists[0] for h in hists)
    checks["b_no_kernel"] = not any(launches.values())
    run = dict(history=[{k: h[k] for k in ("loss", "aux_loss", "grad_norm")} | {"ms": t}
                        for h, t in zip(hist, times)], first_batch_loss=seen)
    try:
        falls(f"{TRAIN_ARCH} on a {shape} mesh", run, fresh=True)
        checks["b_falls"] = True
    except AssertionError as e:
        say(f"{tag} {e}")
        checks["b_falls"] = False
    box = [state]

    def one_step():
        box[0], _ = step(box[0], data.next())

    prof = profiled(one_step, 2)
    del state, box
    gc.collect()
    torch.cuda.empty_cache()
    steady = float(np.median(times[1:]))
    res.update(run=run, steady_ms=steady, tokens_s=DP_BATCH * TRAIN_SEQ / (steady / 1e3),
               peak_mem_bytes=peaks, launches=launches, profiled=prof,
               pieces_bitwise=checks["b_pieces"])
    say(f"{tag} bf16 compute, {MS_STEPS} steps of {DP_BATCH} x {TRAIN_SEQ} in {DP_MICRO} "
        f"microbatches: loss {['%.6f' % h['loss'] for h in hist]} (the first batch's "
        f"{seen[0]:.6f} -> {seen[1]:.6f}); pieces "
        f"{'bitwise equal' if checks['b_pieces'] else 'DIFFER'} where the layout replicates them, "
        f"after every step; step ms {['%.3f' % t for t in times]}, steady {steady:.3f} "
        f"({res['tokens_s']:.1f} tokens/s); peak {['%.3f GiB' % (p / 2**30) for p in peaks]}; "
        f"kernel launches {json.dumps(launches)} (none may launch)")
    say(f"{tag} 2 steps under the profiler (rank 0): {['%.3f' % t for t in prof['steps_ms']]} "
        f"ms, device busy {prof['device_busy_ms']:.3f} of {prof['device_wall_ms']:.3f}, idle "
        f"{prof['device_idle_share']:.4f}, NCCL {prof['nccl_ms']:.3f} ms "
        f"({prof['nccl_ms'] / prof['device_wall_ms']:.4f} of the wall)")
    for k in prof["top_kernels"][:6]:
        say(f"{tag}   {k['device_ms']:9.3f} ms x{k['calls']:<4d} {k['name']}")
    return res, checks


def ms_decode(mesh, rank: int, counters: dict, fa_mod, say) -> tuple[dict, dict]:
    """c. greedy decode of float32 llama3.2-3b on the (1, 4) mesh, its
    caches sequence-sharded over ``model``, against one card's
    ``greedy_generate``."""
    import torch.distributed as dist

    from repro_torch.dist import make_rules, map_placements, param_shardings
    from repro_torch.launch.dryrun import cache_placements
    from repro_torch.models.lm.api import build
    from repro_torch.models.lm.attention import AttnCache
    from repro_torch.serve import engine

    dev = ms_device()
    d = MS_DECODE
    cfg = ms_config(LM_ARCH, dtype="float32")
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    prompt = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size,
                                                              (d["batch"], d["prompt"])),
                             dtype=torch.int32, device=dev)
    one = engine.greedy_generate(api, params, prompt, d["steps"], d["cache"]) if rank == 0 \
        else None
    pl = param_shardings(mesh, make_rules(fsdp=cfg.fsdp), api.axes())
    pieces = ms_pieces(params, pl, mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    state = engine.init_serve_state(api, d["batch"], d["cache"], dtype=torch.float32, device=dev)
    cpl = cache_placements(mesh, state.caches, cfg, batch=d["batch"], cache_len=d["cache"],
                           data_axes=("data",))
    state = engine.ServeState(caches=ms_pieces(state.caches, cpl, mesh), cache_pos=0)
    kw = dict(mesh=mesh, placements=pl, cache_placements=cpl)
    prefill, step = engine.make_prefill(api, **kw), engine.make_serve_step(api, **kw)
    slots = {tuple(c.k.shape) for c in [state.caches["scan"]["pos0"]]}
    reset_counts(counters, fa_mod)
    with torch.no_grad():
        (lg, state), prefill_ms = timed(lambda: prefill(pieces, state, prompt))
        out, step_ms = [], []
        for _ in range(d["steps"]):
            tok = lg[:, : cfg.vocab_size].argmax(-1).to(torch.int32)
            out.append(tok)
            (lg, state), ms = timed(lambda: step(pieces, state, tok[:, None]))
            step_ms.append(ms)
    launches = {k: fn.launches for k, fn in counters.items()}
    got = torch.stack(out, 1)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, got.tolist())
    res = dict(cfg=d, cache_piece_shape=sorted(slots), prefill_ms=prefill_ms, step_ms=step_ms,
               launches=launches)
    checks = {"c_ranks": all(e == every[0] for e in every),
              "c_split": all(s[2] == d["cache"] // mesh.size(1) for s in slots),
              "c_no_kernel": not any(launches.values())}
    if rank == 0:
        checks["c_tokens"] = torch.equal(got, one)
        res.update(tokens=got.tolist(), one_card=one.tolist())
        say(f"[lm tp c] float32 greedy, B={d['batch']}, prompt {d['prompt']}, {d['steps']} new, "
            f"cache {d['cache']} slots ({d['cache'] // mesh.size(1)} a rank: cache piece "
            f"{sorted(slots)}): tokens {'equal' if checks['c_tokens'] else 'DIFFER from'} one "
            f"card's {'' if checks['c_tokens'] else str(one.tolist())}; the ranks "
            f"{'agree' if checks['c_ranks'] else 'DISAGREE'}; prefill {prefill_ms:.1f} ms, steps "
            f"{['%.1f' % t for t in step_ms]} ms; launches {json.dumps(launches)}")
    del pieces, state
    gc.collect()
    torch.cuda.empty_cache()
    return res, checks


def ms_moe_compare(arch: str, cfg, toks, mesh, rank: int, dtype, say, counters=None,
                   fa_mod=None) -> tuple[dict, dict]:
    """d. one MoE config on the (1, 4) mesh against one card's forward on
    rank 0 over the same tokens and weights: the route flips (those with
    none upstream must be near-ties), the logits on the tokens routed alike
    in every layer, and, with ``counters``, #7's launches (impl flash)."""
    import torch.distributed as dist

    from repro_torch.dist import make_rules, param_shardings
    from repro_torch.models.lm import moe
    from repro_torch.models.lm.api import build

    dev = ms_device()
    api = build(cfg)
    impl = "flash" if counters is not None else "xla"
    pl = param_shardings(mesh, make_rules(fsdp=cfg.fsdp), api.axes())
    one = r1 = None
    with torch.no_grad():
        if rank == 0:  # the logical weights on the card for one card's forward, then cut
            params = api.init(torch.Generator(device=dev).manual_seed(0), device=dev)
            r1 = []
            one = api.forward(params, toks, impl=impl, routes=r1)[0]
            pieces = ms_pieces(params, pl, mesh)
            del params
        else:
            pieces = ms_pieces(api.init(torch.Generator(device=dev).manual_seed(0), device=dev),
                               pl, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        r2 = []
        torch.cuda.reset_peak_memory_stats()
        if counters is not None:
            reset_counts(counters, fa_mod)
        got, ms = timed(lambda: api.forward(pieces, toks, impl=impl, mesh=mesh, placements=pl,
                                            routes=r2)[0])
        launches = None if counters is None else {k: fn.launches for k, fn in counters.items()}
        steady = [timed(lambda: api.forward(pieces, toks, impl=impl, mesh=mesh,
                                            placements=pl))[1] for _ in range(2)]
    res = dict(layers=cfg.num_layers, dtype=cfg.dtype, seq=toks.shape[1], impl=impl,
               cold_ms=ms, steady_ms=steady, launches=launches,
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    checks = {}
    sums = [None] * dist.get_world_size()
    dist.all_gather_object(sums, leaf_checksums([got]))
    checks[f"d_{arch}_{cfg.dtype}_bitwise"] = all(s == sums[0] for s in sums)
    if counters is not None:
        checks[f"d_{arch}_launches"] = launches == ({k: 0 for k in counters}
                                                    | {"flash_attention": cfg.num_layers})
    if rank == 0:
        flipped, unexplained = moe.route_flips(stacked(r1, "expert_ids"), stacked(r1, "gap"),
                                               stacked(r2, "expert_ids"), stacked(r2, "gap"),
                                               dtype)
        free = torch.stack([upstream_free(f) for f in flipped.unbind(1)], 1)  # [L, B, S]
        agree = ~flipped.any(0)
        a, b = one[agree][:, : cfg.vocab_size].float(), got[agree][:, : cfg.vocab_size].float()
        rel = float((a - b).abs().max()) / float(a.abs().max())
        top1 = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        res.update(flipped_by_layer=flipped.sum((1, 2)).tolist(),
                   upstream_free_beyond_near_tie=int((unexplained & free).sum()),
                   tokens_agreeing=int(agree.sum()), rel_on_agreeing=rel, top1_on_agreeing=top1,
                   one_card_launches=None)
        ok = res["upstream_free_beyond_near_tie"] == 0 and torch.isfinite(got).all()
        if dtype == torch.float32:
            ok = ok and rel <= MS_REL
        checks[f"d_{arch}_{cfg.dtype}"] = bool(ok)
        say(f"[lm tp d] {arch}, {cfg.num_layers} layers, {cfg.dtype}, {impl}, B={toks.shape[0]} "
            f"S={toks.shape[1]}: route flips by layer {res['flipped_by_layer']} (with none "
            f"upstream and beyond a near-tie: {res['upstream_free_beyond_near_tie']}); on the "
            f"{res['tokens_agreeing']} tokens routed alike in every layer max |d| {rel:.3e} of one "
            f"card's scale{f' (limit {MS_REL})' if dtype == torch.float32 else ''}, top-1 "
            f"{top1:.6f}; ms cold {ms:.1f}, steady {['%.1f' % t for t in steady]}; launches "
            f"{json.dumps(launches)}; peak {res['peak_mem_bytes'] / 2**30:.3f} GiB")
    del pieces, got, one
    gc.collect()
    torch.cuda.empty_cache()
    return res, checks


def ms_moe(mesh, rank: int, counters: dict, fa_mod, say) -> tuple[dict, dict]:
    """d. dbrx-132b (experts over ``model``) and grok-1-314b (FFN over
    ``mlp``) on the (1, 4) mesh: float32 at ``MS_MOE_F32`` layers and bf16
    at phases 6d/6e's depth against one card; dbrx at ``MS_MOE_BIG`` layers,
    which one card cannot hold."""
    import torch.distributed as dist

    from repro_torch.dist import make_rules, param_shardings
    from repro_torch.models.lm.api import build
    from repro_torch.tree import tree_leaves

    dev = ms_device()
    res, checks = {}, {}
    for arch in ("dbrx-132b", "grok-1-314b"):
        cfg = ms_config(arch, num_layers=MS_MOE_F32["layers"], dtype="float32",
                        param_dtype="float32")
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (LM_BATCH, MS_MOE_F32["seq"])), dtype=torch.int32, device=dev)
        res[f"{arch}/float32"], c = ms_moe_compare(arch, cfg, toks, mesh, rank, torch.float32, say)
        checks.update(c)
        cfg = ms_config(arch, num_layers=MOE_LAYERS[arch])
        toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                                (LM_BATCH, LM_SEQ)),
                               dtype=torch.int32, device=dev)
        res[f"{arch}/bf16"], c = ms_moe_compare(arch, cfg, toks, mesh, rank, torch.bfloat16, say,
                                                counters, fa_mod)
        checks.update(c)

    # dbrx at MS_MOE_BIG layers: each rank draws its pieces one logical leaf at a time
    cfg = ms_config("dbrx-132b", num_layers=MS_MOE_BIG)
    api = build(cfg)
    pl = param_shardings(mesh, make_rules(fsdp=cfg.fsdp), api.axes())
    torch.cuda.reset_peak_memory_stats()
    pieces, init_ms = timed(lambda: ms_draw_pieces(cfg, pl, mesh, dev))
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                            (LM_BATCH, LM_SEQ)),
                           dtype=torch.int32, device=dev)
    with torch.no_grad():
        reset_counts(counters, fa_mod)
        (got, aux), cold = timed(lambda: api.forward(pieces, toks, impl="flash", mesh=mesh,
                                                     placements=pl))
        launches = {k: fn.launches for k, fn in counters.items()}
        steady = [timed(lambda: api.forward(pieces, toks, impl="flash", mesh=mesh,
                                            placements=pl))[1] for _ in range(2)]
    peak = torch.cuda.max_memory_allocated()
    weight = sum(t.numel() * t.element_size() for t in tree_leaves(pieces))
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    checks["d_big"] = bool(torch.isfinite(got).all()) and math.isfinite(float(aux)) and \
        launches["flash_attention"] == cfg.num_layers
    res["dbrx-132b/big"] = dict(layers=cfg.num_layers, of_layers=40, weight_bytes_a_rank=weight,
                                init_ms=init_ms, cold_ms=cold, steady_ms=steady,
                                launches=launches, peak_mem_bytes=peaks)
    say(f"[lm tp d] dbrx-132b at {cfg.num_layers} of 40 layers in bf16 "
        f"({4 * weight / 1e9:.1f} GB of weights, {weight / 1e9:.1f} GB a rank), flash, "
        f"B={LM_BATCH} S={LM_SEQ}: ms cold {cold:.1f}, steady {['%.1f' % t for t in steady]}; "
        f"launches {json.dumps(launches)}; peak {['%.3f GiB' % (p / 2**30) for p in peaks]}; "
        f"pieces drawn in {init_ms:.0f} ms")
    del pieces, got
    gc.collect()
    torch.cuda.empty_cache()
    return res, checks


def lm_model_sharded() -> dict:
    """The LM under the ``model`` mesh axis (the ``tp`` posture) on four
    cards, one process a card (NCCL, TF32 off):

        torchrun --nproc-per-node 4 --no-python python3 -c 'import chip_smoke as c; c.lm_model_sharded()'

    Each rank holds its pieces of the weights (``dist.param_shardings`` under
    ``make_rules(fsdp=True)``, ``dist.local_slice``), and the forward, the
    train step and decode compute on them with the mesh and the placements.

    a. llama3.2-3b at full width and depth on the (1, 4) mesh.  float32
       (xla, B = 2, S = 2,048): the logits within ``MS_REL`` of one card's
       scale (rank 0's forward over the same tokens) and bitwise equal on
       the 4 ranks.  bf16, impl flash, B = 2, S = 4,096: #7 launches once a
       layer a forward on each rank's 6 q / 2 K/V heads (route "local
       heads", every launch on the wgmma route), counted with the counts
       zeroed just before; the steady time beside one card's, and the NCCL
       time under the profiler.
    b. llama3.2-3b's train step on the (1, 4) and (2, 2) meshes,
       ``lm_data_parallel``'s 16 × 2,048 rows in 2 microbatches and optimizer: the
       first step's float32-compute loss and each gathered grad leaf
       within ``MS_REL`` of one card's over the same 2 microbatches (beside
       one card against itself in 8 microbatches of 2 rows, the float32
       sums' floor); ``MS_STEPS`` steps at the config's
       bf16 compute, the pieces bitwise equal on the ranks that hold the
       same piece after every step, the loss falling as phase 6k's; peak
       memory a rank, the steady step and the NCCL share; no kernel
       launches (training runs impl "xla").
    c. greedy decode, float32 llama3.2-3b, B = 4, caches of 64 slots
       sequence-sharded over ``model`` (16 a rank): 16 tokens equal to one
       card's ``greedy_generate``.
    d. dbrx-132b (experts over ``model``) and grok-1-314b (``ep_shard``
       off: each expert's FFN over ``mlp``): float32 at 2 layers, B = 2,
       S = 1,024, within ``MS_REL`` of one card's on the tokens routed alike
       in every layer; bf16 at phases 6d/6e's 8 and 4 layers, flash, against
       one card (route flips with none upstream must be near-ties); then
       dbrx at ``MS_MOE_BIG`` of 40 layers in bf16 (109 GB of weights), its
       pieces drawn a leaf at a time: the forward time and peak a rank.

    Rank 0 prints the results and writes lm_model_sharded.json to the output
    directory."""
    import torch.distributed as dist

    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm.api import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl")
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        if world != 4:
            raise AssertionError(f"lm_model_sharded runs on 4 ranks, not {world}")
        mesh = make_mesh((1, 4), ("data", "model"))  # each rank on card LOCAL_RANK
        dev = ms_device()
        say = log if rank == 0 else (lambda *_: None)
        fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")
        counters = kernel_counters()
        res, checks = dict(card=card_line(), world=world), {}
        say(f"[lm tp] {res['card']}; {world} ranks")
        res["a"], c = ms_forward(mesh, rank, counters, fa_mod, say)
        checks.update(c)
        one = None
        if rank == 0:
            cfg = ms_config(TRAIN_ARCH)
            first = {k: v.to(dev) for k, v in SyntheticLMData(
                vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=DP_BATCH,
                seed=0).next().items()}
            one = ms_one_card_grads(build(dataclasses.replace(cfg, dtype="float32")), first, dev)
        for shape in MS_SHAPES:
            res[f"b_{shape[0]}x{shape[1]}"], c = ms_train(shape, one, rank, counters, fa_mod, say)
            checks.update({f"{k}_{shape[0]}x{shape[1]}": v for k, v in c.items()})
        del one
        res["c"], c = ms_decode(mesh, rank, counters, fa_mod, say)
        checks.update(c)
        res["d"], c = ms_moe(mesh, rank, counters, fa_mod, say)
        checks.update(c)
        res["checks"] = checks
        ok = torch.tensor(int(all(checks.values())), device=dev)
        dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        res["all_ranks_ok"] = bool(ok)
        if rank == 0:
            OUT.mkdir(exist_ok=True)
            (OUT / "lm_model_sharded.json").write_text(json.dumps(res, indent=1, default=str))
            log(f"[lm tp] checks {json.dumps(checks)}; all ranks ok: {res['all_ranks_ok']}")
            log(res["card"])
        if not res["all_ranks_ok"]:
            raise AssertionError(f"rank {rank}: the LM under the model axis failed a check "
                                 f"({checks}; see {OUT / 'lm_model_sharded.json'})")
        return res
    finally:
        dist.destroy_process_group()


# -- phase 7: observability and the HGNN leftovers ---------------------------


# examples_torch/train_hgnn_han.py's defaults: ACM at scale 0.5, full features, 8 heads of 128
# (a row of 1,024 floats, the widest #1/#2 take), full batch, the launcher's B = 128
OBS_TRAIN = dict(dataset="acm", scale=0.5, feat_scale=1.0, hidden=128, heads=8)
OBS_STEPS = 20
CHAR_PASSES = 6  # characterization passes a backend: one with its set-up, five steady
# the serving phase's problem and width (full IMDB, HAN's 8 x 64, B = 16, a 64 MiB FP cache,
# three slots, two requests a metapath) through the serving launcher's flags
OBS_SERVE = ["--dataset", "imdb", "--scale", "1.0", "--feat-scale", "1.0", "--heads", "8",
             "--hidden", "64", "--block", "16", "--cache-kb", str(64 << 10), "--slots", "3",
             "--repeats", "2", "--max-edges", "20000"]


def trace_spans(path) -> list[tuple[str, str]]:
    """(name, lane) of each complete event of a Chrome trace."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    lanes = {e["tid"]: e["args"]["name"] for e in events if e["name"] == "thread_name"}
    return [(e["name"], lanes[e["tid"]]) for e in events if e["ph"] == "X"]


def load_example(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def characterization(data, counters, k5_mod) -> dict:
    """Phase 7a: ``characterize_hgnn`` on HAN at its own width on the
    phase-4 problem under ``enable_tracing(sync=True)``, on BLOCK, KERNEL
    (#5 once a graph) and MULTIGRAPH (#1 at G = 1), ``CHAR_PASSES`` passes
    each (the first builds MULTIGRAPH's edge index and is reported apart;
    the others by their median); every #5 and #1 call held against its
    plain version; each pass's trace must hold one ``char/na/<g>`` span on
    lane ``sg/<g>`` a semantic graph."""
    from repro_torch.models.hgnn import HAN
    from repro_torch.obs import MetricsRegistry, disable_tracing, enable_tracing
    from repro_torch.obs.characterize import characterize_hgnn
    from repro_torch.core import NABackend as NAB

    params = HAN.init(torch.Generator().manual_seed(0), data, **WIDTH)
    names = [b.name for b in data.graphs]
    res = {}
    for backend in (NAB.BLOCK, NAB.KERNEL, NAB.MULTIGRAPH):
        passes = []

        def run():
            for i in range(CHAR_PASSES):
                tracer = enable_tracing(sync=True)
                try:
                    passes.append(characterize_hgnn(params, data, backend=backend,
                                                    registry=MetricsRegistry()))
                finally:
                    disable_tracing()
                path = OUT / f"char_{backend.value}_{i}.json"
                tracer.export_chrome_trace(str(path))
                spans = trace_spans(path)
                for g in names:
                    if spans.count((f"char/na/{g}", f"sg/{g}")) != 1:
                        raise AssertionError(f"characterize {backend.value}: no single char/na/{g} "
                                             f"span on lane sg/{g}: {spans}")

        for fn in counters.values():
            fn.launches = 0
        mem0 = torch.cuda.memory_stats()
        if backend is NAB.KERNEL:
            _, calls, err = k5_calls_to_plain("characterize KERNEL", run, k5_mod)
            n_calls = len(calls)
        elif backend is NAB.MULTIGRAPH:
            n_calls = CHAR_PASSES * len(names)
            _, err = na_calls_to_plain("characterize MULTIGRAPH", run, n_calls, backward=False)
        else:
            run()
            err, n_calls = None, 0
        launches = {k: fn.launches for k, fn in counters.items()}
        mem1 = torch.cuda.memory_stats()  # the caching allocator's cudaMallocs and retries
        alloc = {k: mem1.get(k, 0) - mem0.get(k, 0) for k in ("num_device_alloc", "num_alloc_retries")}
        want = {"seg_gat_agg": n_calls if backend is NAB.KERNEL else 0,
                "multigraph": n_calls if backend is NAB.MULTIGRAPH else 0}
        if {k: launches[k] for k in want} != want or launches["multigraph_bwd"]:
            raise AssertionError(f"characterize {backend.value}: launches {launches}, "
                                 f"expected {want}")
        steady = passes[1:]
        med = {part: {k: float(np.median([p[part][k] for p in steady])) for k in steady[0][part]}
               for part in ("stage_us", "na_us_per_graph")}
        med["total_us"] = float(np.median([p["total_us"] for p in steady]))
        res[backend.value] = dict(median=med, passes=passes, launches=launches, max_abs_err=err,
                                  alloc=alloc)
        log(f"[characterize {backend.value}] median of {len(steady)} passes: stage_us "
            + " ".join(f"{k}={v:.1f}" for k, v in med["stage_us"].items())
            + " na_us_per_graph " + " ".join(f"{k}={v:.1f}"
                                               for k, v in med["na_us_per_graph"].items())
            + f" total {med['total_us']:.1f} us (totals "
            + ", ".join(f"{p['total_us']:.1f}" for p in passes)
            + f", the first with its set-up); launches {json.dumps(launches)}; allocator "
            f"{json.dumps(alloc)}, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    return res


def observability_phase(data, counters, k5_mod) -> dict:
    """Phase 7: the characterization (7a), the training launcher's
    ``--trace``/``--metrics`` at the training example's width (7b), the
    serving launcher's backend names and the examples (7c)."""
    import tempfile

    from repro_torch.launch import hgnn_serve, hgnn_train
    from repro_torch.obs import get_registry, reset_registry

    t_phase = time.perf_counter()
    res = {"characterize": characterization(data, counters, k5_mod)}

    # b. the launcher with --trace/--metrics, counters zeroed just before
    reset_registry()
    with tempfile.TemporaryDirectory() as tmp:
        trace, metrics = Path(tmp) / "trace.json", Path(tmp) / "metrics.json"
        lines = []
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        (_, hist, meta), err = na_calls_to_plain(
            "trainer 8 x 128", lambda: hgnn_train.run_training(
                steps=OBS_STEPS, backend="kernel", log_every=1, log=lines.append,
                trace=str(trace), metrics_out=str(metrics), device="cuda", **OBS_TRAIN), 1)
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        spans = {name for name, _ in trace_spans(trace)}
        snap = json.loads(metrics.read_text())
    stages = sorted(s["labels"]["stage"] for s in snap["histograms"].get("char.stage_us", []))
    char_line = next(ln for ln in lines if ln.startswith("[characterize]"))
    log(f"[obs trainer] {lines[0]}")
    log(f"[obs trainer] {char_line}; launches {json.dumps(launches)}; loss "
        f"{hist[0]['loss']:.6f} -> {hist[-1]['loss']:.6f}; step ms cold {hist[0]['sec'] * 1e3:.3f}, "
        f"steady median {float(np.median([h['sec'] for h in hist[1:]])) * 1e3:.3f}; wall "
        f"{wall:.3f} s")
    want_spans = {"char/forward", "char/fp", "char/gsf", "train/step", "na/multilane"}
    want_spans |= {f"char/{st}/{g}" for g in meta["characterize"]["na_us_per_graph"]
                   for st in ("theta", "na", "lsf")}
    if not want_spans <= spans:
        raise AssertionError(f"trainer trace lacks {sorted(want_spans - spans)}")
    if stages != ["FA", "FP", "NA", "theta"] or "train.step_ms" not in snap["histograms"]:
        raise AssertionError(f"trainer metrics: {json.dumps(snap)[:2000]}")
    if snap["counters"]["train.steps"][0]["value"] != OBS_STEPS:
        raise AssertionError(f"trainer metrics count {snap['counters']['train.steps']} steps")
    if launches["multigraph"] != OBS_STEPS or launches["multigraph_bwd"] != OBS_STEPS:
        raise AssertionError(f"#1/#2 did not launch once a step: {launches}")
    if not hist[-1]["loss"] < hist[0]["loss"] or not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"the loss did not fall: {[h['loss'] for h in hist]}")
    res["trainer"] = dict(launches=launches, wall_s=wall, meta=meta, max_abs_err=err,
                          loss=[h["loss"] for h in hist], steps_ms=[h["sec"] * 1e3 for h in hist],
                          spans=sorted(spans), histograms=sorted(snap["histograms"]))
    reset_registry()
    if get_registry().snapshot()["histograms"]:
        raise AssertionError("reset_registry left series behind")

    # c. the serving launcher's backend names at the serving phase's width
    # (full IMDB, HAN's 8 x 64, B = 16), every #1/#3 call held against its
    # plain version, then the examples (serve_hgnn.py's #1 calls held too)
    outs = {}
    for name in ("multigraph", "segment", "fused-fp", "fused_fp"):
        for fn in counters.values():
            fn.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            outs[name], checked, err = serve_calls_to_plain(
                f"hgnn_serve {name}", lambda: hgnn_serve.main(["--na-backend", name, *OBS_SERVE]))
        m = json.loads(captured(buf))
        launches = {k: fn.launches for k, fn in counters.items()}
        res[f"serve_{name}"] = dict(m, launches=launches, checked=checked, max_abs_err=err)
        if not m["device"].startswith("cuda") or m["requests_finished"] != len(outs[name]):
            raise AssertionError(f"hgnn_serve --na-backend {name}: {m}")
        if any(launches[k] != checked[k] for k in checked):
            raise AssertionError(f"hgnn_serve {name}: launches {launches}, checked {checked}")
    if res["serve_fused_fp"]["launches"]["fused_fp"] == 0:
        raise AssertionError("hgnn_serve --na-backend fused_fp never launched #3")
    if any(res["serve_segment"]["launches"].values()):
        raise AssertionError(f"segment launched a kernel: {res['serve_segment']['launches']}")
    for rid, out in outs["fused-fp"].items():
        if not torch.equal(outs["fused_fp"][rid], out):
            raise AssertionError(f"hgnn_serve fused_fp and fused-fp differ on request {rid}")
    for name in ("multigraph", "fused_fp"):
        res[f"serve_segment_vs_{name}"] = max(
            compare(f"hgnn_serve {name} vs segment rid {rid}", (outs[name][rid],), (out,))
            for rid, out in outs["segment"].items())
    log(f"[obs serve] {' '.join(OBS_SERVE)}: " + ", ".join(
        f"{k}: {res['serve_' + k]['steps']} steps, launches "
        f"{json.dumps({n: v for n, v in res['serve_' + k]['launches'].items() if v})}"
        + (f", each within {res['serve_' + k]['max_abs_err']:.3e} of plain"
           if any(res['serve_' + k]['checked'].values()) else "") for k in outs)
        + "; fused_fp == fused-fp bitwise; multigraph and fused_fp within "
        f"{res['serve_segment_vs_multigraph']:.3e} and {res['serve_segment_vs_fused_fp']:.3e} "
        "of segment")

    for name in ("serve_hgnn", "quickstart"):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out, checked, err = serve_calls_to_plain(f"example {name}",
                                                     lambda: load_example(name).main([]))
        launches = {k: fn.launches for k, fn in counters.items()}
        res[f"example_{name}"] = dict(wall_s=time.perf_counter() - t0, result=out,
                                      launches=launches, checked=checked, max_abs_err=err)
        if any(launches[k] != checked[k] for k in checked):
            raise AssertionError(f"example {name}: launches {launches}, checked {checked}")
        log(f"[obs example {name}] {time.perf_counter() - t0:.3f} s (with the checks); "
            + captured(buf).strip().splitlines()[-1] + "; launches "
            + json.dumps({k: v for k, v in launches.items() if v})
            + (f", each within {err:.3e} of plain" if any(checked.values()) else ""))
    if not res["example_serve_hgnn"]["launches"]["multigraph"]:
        raise AssertionError("examples_torch/serve_hgnn.py never launched #1")
    losses = res["example_quickstart"]["result"]
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"examples_torch/quickstart.py: losses {losses}")
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"[obs] phase 7 in {res['wall_s']:.1f} s on {card_line()}")
    return res


def observability_alone() -> dict:
    """Phase 7 alone: builds the kernels, runs the phase on the phase-4
    problem and writes chiprun_out/observability.json."""
    from repro_torch.kernels import build
    from repro_torch.launch import hgnn_train

    torch.backends.cuda.matmul.allow_tf32 = False
    OUT.mkdir(exist_ok=True)
    log(card_line())
    build.build()
    mg_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg_multigraph")
    ff_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg_fused_fp")
    k5_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg")
    _, tdata = hgnn_train.build_problem(device="cuda", **TRAIN)
    res = observability_phase(tdata, obs_counters(mg_mod, ff_mod, k5_mod), k5_mod)
    (OUT / "observability.json").write_text(json.dumps(res, indent=1, default=str))
    log(card_line())
    return res


def obs_counters(mg_mod, ff_mod, k5_mod) -> dict:
    return {"multigraph": mg_mod.seg_gat_agg_multigraph_fwd,
            "multigraph_bwd": mg_mod.seg_gat_agg_multigraph_bwd,
            "fused_fp": ff_mod.seg_gat_agg_fused_fp_fwd,
            "fused_fp_bwd": ff_mod.seg_gat_agg_fused_fp_bwd,
            "seg_gat_agg": k5_mod.seg_gat_agg}


# -- phase 9: AdamW as one kernel pair ------------------------------------------


def adamw_trees() -> dict[str, list[tuple]]:
    """Leaf shapes of the benchmark's trees (``hgnnbench/configs``): HAN on
    ``han-dblp`` (9 leaves), R-GAT on ``rgat-mag`` (66)."""
    han = json.loads((ROOT / "hgnnbench" / "configs" / "han-dblp.json").read_text())
    w, g = han["widths"], han["graph"]
    c, k, n_cls = w["heads"] * w["hidden"], len(g["metapaths"]), g["num_classes"]
    han_shapes = [(g["features"][g["target"]], c), (c,), (k, w["heads"], w["hidden"]),
                  (k, w["heads"], w["hidden"]), (c, w["att_dim"]), (w["att_dim"],),
                  (w["att_dim"], 1), (c, n_cls), (n_cls,)]
    rgat = json.loads((ROOT / "hgnnbench" / "configs" / "rgat-mag.json").read_text())
    w, g = rgat["widths"], rgat["graph"]
    c, feat = w["heads"] * w["hidden"], g["feature_width"]
    rels, types = len(g["relations"]) + len(g["reverse"]), len(g["vertices"])
    rgat_shapes = []
    for layer in range(w["layers"]):
        d = feat if layer == 0 else c
        rgat_shapes += [(d, c), (d, c), (w["heads"], w["hidden"]), (w["heads"], w["hidden"])] * rels
        rgat_shapes += [(d, c)] * types
    rgat_shapes += [(c, g["num_classes"]), (g["num_classes"],)]
    return {"han-dblp": han_shapes, "rgat-mag": rgat_shapes}


ADAMW_LEAF_REL = 1e-6  # of each leaf's largest magnitude: kernels against the loop


def adamw_phase(reps: int = 200) -> dict:
    """AdamW's kernel pair (``kernels/fused_adamw.py``) at the benchmark's
    HAN and R-GAT trees, float32, the configurations' optimizer: one step
    against the loop (every leaf of params, m and v, and the norm, within
    ``ADAMW_LEAF_REL`` of its own largest magnitude: v is ~1e-8 here, below
    any absolute tolerance), the loop's bits given the kernels' norm, and
    twice bitwise equal; the pair's device ms (torch.profiler, in place),
    its bound (28 bytes an element at 3.35 TB/s: g, p, m, v read and p, m,
    v written once from HBM; pass 2's second read of g hits the 50 MB L2,
    which holds R-GAT's 7.5 MB of gradient), and the wall ms of
    a step with its synchronise through ``apply_updates`` (the kernels, out
    of place, as the trainer calls it) and through the loop it replaces
    (``fused_adamw_plain`` out of place: the clones, the norm, the leaf
    loop)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim import AdamWConfig, adamw, apply_updates, init_opt_state

    fa = importlib.import_module("repro_torch.kernels.fused_adamw")
    opt = json.loads((ROOT / "hgnnbench" / "configs" / "rgat-mag.json").read_text())["optimizer"]
    cfg = AdamWConfig(**opt)
    res = {}
    for name, shapes in adamw_trees().items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = {f"w{i:03d}": torch.randn(s, generator=gen, device="cuda")
                  for i, s in enumerate(shapes)}
        grads = {k: 0.1 * torch.randn(p.shape, generator=gen, device="cuda")
                 for k, p in params.items()}
        state = init_opt_state(params, cfg)
        lr = torch.tensor(cfg.lr, device="cuda")
        leaves = adamw._leaves(params, grads, state)
        n = sum(p.numel() for p in params.values())
        got = fa.fused_adamw(cfg, lr, *leaves, state["count"], in_place=False)
        again = fa.fused_adamw(cfg, lr, *leaves, state["count"], in_place=False)
        want = fa.fused_adamw_plain(cfg, lr, *leaves, state["count"], in_place=False)
        flat = lambda out: [*out[0], *out[1], *out[2], out[4], out[5]]  # noqa: E731
        if int(got[4]) != int(want[4]) or int(got[4]) != int(state["count"]) + 1:
            raise AssertionError(f"fused_adamw {name}: count {int(got[4])}, loop {int(want[4])}")
        err = rel = 0.0
        labels = [f"{k}[{i}]" for k in ("param", "m", "v") for i in range(len(shapes))]
        for label, a, b in zip(labels + ["grad_norm"], flat(got)[:-2] + [got[5]],
                               flat(want)[:-2] + [want[5]]):
            if a.shape != b.shape or not torch.isfinite(a).all():
                raise AssertionError(f"fused_adamw {name} {label}: shape or non-finite")
            d = float((a - b).abs().max())
            leaf_rel = d / max(float(b.abs().max()), 1e-30)
            if leaf_rel > ADAMW_LEAF_REL:
                raise AssertionError(f"fused_adamw {name} {label}: {d:.3e} is {leaf_rel:.3e} of "
                                     f"the leaf's largest magnitude (limit {ADAMW_LEAF_REL})")
            err, rel = max(err, d), max(rel, leaf_rel)
        log(f"[check] fused_adamw {name} vs loop: max_abs_err={err:.3e}, worst leaf "
            f"{rel:.3e} of its largest magnitude (limit {ADAMW_LEAF_REL})")
        # given the kernels' norm, the loop writes the kernels' bits
        p_, m_, v_ = ([t.clone() for t in ts] for ts in (leaves[0], leaves[2], leaves[3]))
        master_ = [None if t is None else t.clone() for t in leaves[4]]
        count_ = state["count"].clone()
        adamw.update_leaves_(cfg, lr, got[5], p_, leaves[1], m_, v_, master_, count_)
        if not all(torch.equal(a, b) for a, b in zip(flat(got)[:-2], p_ + m_ + v_)):
            raise AssertionError(f"fused_adamw {name}: the loop given the kernels' norm differs")
        if not all(torch.equal(a, b) for a, b in zip(flat(got), flat(again))):
            raise AssertionError(f"fused_adamw {name}: two runs differ")

        def walls(step) -> float:
            step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                step()
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / reps

        fused_ms = walls(lambda: apply_updates(params, grads, state, cfg, lr))
        loop_ms = walls(lambda: fa.fused_adamw_plain(cfg, lr, *leaves, state["count"],
                                                     in_place=False))
        before = fa.fused_adamw.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fa.fused_adamw(cfg, lr, *leaves, state["count"], in_place=True)
            torch.cuda.synchronize()
        launches = fa.fused_adamw.launches - before
        pair = {e.key: e.self_device_time_total / 1e3 / reps for e in prof.key_averages()
                if "adamw_" in e.key and e.self_device_time_total > 0}
        kernel_ms = sum(pair.values())
        bound = 28 * n / PEAK_HBM_BYTES * 1e3
        res[name] = dict(leaves=len(shapes), elements=n, groups=len(fa.plan(
            tuple(p.numel() for p in params.values())).groups), launches_per_step=launches / reps,
            max_abs_err=err, max_leaf_rel_err=rel, kernel_ms=kernel_ms, by_kernel=pair,
            bound_ms=bound, apply_updates_ms=fused_ms, loop_ms=loop_ms)
        log(f"[adamw] {name}: {len(shapes)} leaves, {n} elements, pair {kernel_ms:.4f} ms "
            f"({', '.join(f'{k[:40]} {v:.4f}' for k, v in pair.items())}), bound {bound:.4f} ms, "
            f"apply_updates {fused_ms:.4f} ms a step, loop {loop_ms:.4f} ms a step, "
            f"{launches / reps:.0f} launches a step")
        if launches != 2 * reps or kernel_ms <= 0:
            raise AssertionError(f"fused_adamw {name}: {launches} launches, {kernel_ms} ms")
    return res


def adamw_alone() -> dict:
    """Phase 9 alone (``python3 -c 'import chip_smoke as c; c.adamw_alone()'``):
    builds the kernel pair, writes its ptxas report, runs the phase and
    writes adamw.json to the output directory."""
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    OUT.mkdir(exist_ok=True)
    check_ptxas(build.build(("fused_adamw",)))
    res = adamw_phase()
    res["card"] = card_line()
    (OUT / "adamw.json").write_text(json.dumps(res, indent=1, default=str))
    return res


# -- phase 10: Simple-HGN's joint NA (the joint #1 and #2) ----------------------

SIMPLE_HGN_PROBLEM = dict(dataset="imdb", scale=1.0, feat_scale=1.0, block=8)
SIMPLE_HGN_WIDTH = dict(hidden=64, heads=8)
JOINT_CASES = (  # (H, Dh, prior layers): the hidden layers' shape, and the output
    (8, 64, 1),  # layer's 349 columns padded to 352 (float4 lane groups)
    (8, 64, 0),
    (1, 352, 0),
)


def joint_case(mg_mod, jg, H: int, Dh: int, K: int, seed: int, dev) -> dict:
    """Random operands of the joint NA over ``jg`` (every unit, or the
    target's units at H = 1) and K prior layers, each prior's lse its own
    joint forward's (as the model passes it on)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, R = jg.num_rows, jg.num_edge_types
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)  # noqa: E731
    n_units = jg.num_units if H > 1 else jg.units_of(jg.types[0])
    index = jg.index(n_units)
    ops = dict(theta_src=rnd(n, H), theta_dst=rnd(n, H), h_src=rnd(n, H, Dh),
               edge_bias=rnd(R, H))
    priors = None
    if K:
        ths, thd, bias = rnd(K, n, H), rnd(K, n, H), rnd(K, R, H)
        lse = torch.zeros((K, n, H), device=dev)
        for k in range(K):
            _, lse_k, _ = mg_mod.seg_gat_agg_multigraph_joint_plain(
                index, ths[k], thd[k], rnd(n, H, Dh), bias[k], leaky_slope=0.05)
            lse[k, : lse_k.shape[0]] = lse_k
        priors = mg_mod.JointPriors(ths, thd, bias, lse, (1.0,) * K)
    return dict(index=index, ops=ops, priors=priors)


def simple_hgn_phase() -> dict:
    """The joint #1 and #2 against their plain versions at each of
    JOINT_CASES on full IMDB as Simple-HGN trains on it (B = 8), each run
    twice and bitwise equal, with their CUDA-event times; then Simple-HGN's
    loss and gradients on the card against the CPU at 8 heads of 64, with
    the step's joint launches (3 forward, 3 backward, 2 prior layers
    recomputed: one in the forward, one in the backward)."""
    from repro_torch.launch import hgnn_train
    from repro_torch.models.hgnn import SIMPLE_HGN
    from repro_torch.train.hgnn import hgnn_loss_and_grads
    from repro_torch.tree import tree_leaves, tree_map

    mg_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg_multigraph")
    fwd, bwd = mg_mod.seg_gat_agg_multigraph_joint_fwd, mg_mod.seg_gat_agg_multigraph_joint_bwd
    dev = torch.device("cuda")
    _, data = hgnn_train.build_simple_hgn_problem(device=dev, **SIMPLE_HGN_PROBLEM)
    jg = data.joint
    res = dict(edges=jg.num_edges, rows=jg.num_rows, slots=int(jg.slot_col.numel()), cases={})
    for H, Dh, K in JOINT_CASES:
        name = f"{H}x{Dh}_priors{K}"
        c = joint_case(mg_mod, jg, H, Dh, K, seed=H * Dh + K, dev=dev)
        idx, ops, pr = c["index"], c["ops"], c["priors"]
        kw = dict(beta=0.05, leaky_slope=0.05)
        got = fwd(idx, **ops, priors=pr, **kw)
        again = fwd(idx, **ops, priors=pr, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"joint #1 {name}: two runs differ")
        err_f = compare(f"joint #1 {name}",
                        got, mg_mod.seg_gat_agg_multigraph_joint_plain(idx, **ops, priors=pr, **kw))
        out, lse, soft = got
        g = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(7),
                        device=dev)
        gb = bwd(idx, **ops, soft=soft, lse=lse, g_out=g, priors=pr, **kw)
        gb2 = bwd(idx, **ops, soft=soft, lse=lse, g_out=g, priors=pr, **kw)
        if not all(torch.equal(a, b) for a, b in zip(gb, gb2)):
            raise AssertionError(f"joint #2 {name}: two runs differ")
        err_b = compare(f"joint #2 {name}", gb, mg_mod.seg_gat_agg_multigraph_joint_bwd_plain(
            idx, **ops, soft=soft, lse=lse, g_out=g, priors=pr, **kw))
        res["cases"][name] = dict(
            edges=idx["E"], fwd_err=err_f, bwd_err=err_b,
            fwd_ms=cuda_ms(lambda: fwd(idx, **ops, priors=pr, **kw), reps=10),
            bwd_ms=cuda_ms(lambda: bwd(idx, **ops, soft=soft, lse=lse, g_out=g, priors=pr, **kw),
                           reps=10))
        log(f"[simple_hgn] {name}: {res['cases'][name]}")
    # the model on the card against the CPU, and its launches a step
    params = SIMPLE_HGN.init(torch.Generator().manual_seed(0), data, **SIMPLE_HGN_WIDTH,
                             edge_dim=SIMPLE_HGN_WIDTH["hidden"])
    _, cpu = hgnn_train.build_simple_hgn_problem(device="cpu", **SIMPLE_HGN_PROBLEM)
    idx_all = torch.arange(int(data.labels.shape[0]))
    before = (fwd.launches, bwd.launches, fwd.prior_layers)
    loss, _, grads = hgnn_loss_and_grads(lambda p: SIMPLE_HGN.forward(p, data), params, data,
                                         idx_all.to(dev))
    torch.cuda.synchronize()
    launches = dict(fwd=fwd.launches - before[0], bwd=bwd.launches - before[1],
                    prior_layers=fwd.prior_layers - before[2])
    if launches != dict(fwd=3, bwd=3, prior_layers=2):
        raise AssertionError(f"Simple-HGN's step launched {launches}")
    loss_c, _, grads_c = hgnn_loss_and_grads(
        lambda p: SIMPLE_HGN.forward(p, cpu), tree_map(lambda t: t.cpu(), params), cpu, idx_all)
    res["model"] = dict(
        launches=launches, loss=float(loss), loss_cpu=float(loss_c),
        grad_err=compare("Simple-HGN grads card vs CPU",
                         [g.cpu() for g in tree_leaves(grads)], tree_leaves(grads_c)))
    return res


def simple_hgn_alone() -> dict:
    """Phase 10 alone (``python3 -c 'import chip_smoke as c; c.simple_hgn_alone()'``):
    builds #1's and #2's libraries, writes their ptxas reports, runs the
    phase and writes simple_hgn.json to the output directory."""
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    log(card_line())
    OUT.mkdir(exist_ok=True)
    reports = build.build(("seg_gat_agg_multigraph", "seg_gat_agg_multigraph_bwd"))
    check_ptxas(reports)
    res = simple_hgn_phase()
    res["card"] = card_line()
    res["registers"] = {k: ptxas_registers(v) for k, v in reports.items()}
    (OUT / "simple_hgn.json").write_text(json.dumps(res, indent=1, default=str))
    return res


def multigraph_digest() -> dict:
    """Digests of HAN's and R-GAT's trained parameters after three steps
    of the training launcher on full IMDB (#1 and #2 in every forward and
    backward, AdamW after), and of R-GAT (phase 5's width, 3 layers) on
    full IMDB's relation graphs, whose last layer feeds the logits from
    three of its six relations: its KERNEL logits (#6 and #5) and its
    parameters after three MULTIGRAPH training steps.  Each is run twice;
    prints one JSON line.  It runs the ``repro_torch`` beside this script
    through calls that trees before the joint NA have too, so two trees
    compare bit for bit by copying this script to each tree's root and
    running it there
    (``python3 -c 'import chip_smoke as c; c.multigraph_digest()'``)."""
    import hashlib

    from repro_torch.core import NABackend
    from repro_torch.graphs import synthetic_hetgraph
    from repro_torch.launch import hgnn_train
    from repro_torch.models.hgnn import RGAT
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_hgnn_train_state, make_hgnn_train_step
    from repro_torch.tree import tree_leaves

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False

    def digest(tensors) -> str:
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    res = {}
    for model, heads in (("HAN", 8), ("R-GAT", 4)):
        digests = []
        for _ in range(2):
            state, hist, _ = hgnn_train.run_training(
                dataset="imdb", model_name=model, steps=3, scale=1.0, feat_scale=1.0,
                hidden=64, heads=heads, block=16, log=lambda *_: None, device="cuda")
            digests.append(digest(tree_leaves(state.params)))
        res[model] = dict(digests=digests, losses=[r["loss"] for r in hist])
    data = relation_data(synthetic_hetgraph("imdb", scale=1.0, feat_scale=1.0, seed=0), "cuda")
    opt = AdamWConfig(lr=5e-3, weight_decay=0.0)
    idx = torch.arange(data.labels.shape[0], device="cuda")
    logits, trained, losses = [], [], []
    for _ in range(2):
        params = RGAT.init(torch.Generator().manual_seed(0), data, **MODEL_WIDTHS["R-GAT"])
        with torch.no_grad():
            logits.append(digest([RGAT.forward(params, data, backend=NABackend.KERNEL)]))
        state = init_hgnn_train_state(RGAT, torch.Generator().manual_seed(0), data, opt,
                                      **MODEL_WIDTHS["R-GAT"])
        step = make_hgnn_train_step(
            lambda p: RGAT.forward(p, data, backend=NABackend.MULTIGRAPH), data, opt)
        losses = []
        for _ in range(3):
            state, metrics = step(state, {"idx": idx})
            losses.append(float(metrics["loss"]))
        trained.append(digest(tree_leaves(state.params)))
    res["R-GAT relations"] = dict(kernel_logits=logits, trained=trained, losses=losses)
    res["card"] = card_line()
    print("DIGEST " + json.dumps(res), flush=True)
    return res


# -- phase 3: the serving path -------------------------------------------------


def timed_step(eng) -> tuple[float, float]:
    """(CUDA-event ms, host-clock ms) of one engine step."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    eng.step()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def serve(graph, serve_mod, backend, counters):
    """The main path: a fresh engine serves the request mix.  Every launch
    counter is zeroed just before the run and read just after it."""
    eng = serve_mod.HGNNEngine(
        graph, target_type="movie", num_slots=3, cache_bytes=64 << 20,
        admission="similarity", backend=backend, block=16, max_edges=20_000,
        device="cuda", **WIDTH,
    )
    for req in serve_mod.make_request_mix(0, [[mp] for mp in METAPATHS], repeats=2):
        eng.submit(req)
    torch.cuda.reset_peak_memory_stats()
    steps_ms = []
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    while eng.queue or any(s is not None for s in eng.slots):
        steps_ms.append(timed_step(eng)[0])
    wall_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    stats = dict(steps_ms=steps_ms, wall_s=wall_s, launches=launches,
                 peak_mem_bytes=torch.cuda.max_memory_allocated(), metrics=eng.metrics())
    return eng, {r.rid: r for r in eng.finished}, stats


def steady_state(eng, serve_mod) -> dict:
    """A second mix (repeats=4) on the warmed engine, every step timed with
    CUDA events and traced by torch.profiler (device activity only, so the
    host adds no per-op records).  Device busy time (the kernels' and
    copies' own time) and the device wall time (the CUDA events) are of the
    same steps; idle share = 1 - busy / wall."""
    from torch.profiler import ProfilerActivity, profile

    for req in serve_mod.make_request_mix(100, [[mp] for mp in METAPATHS], repeats=4):
        eng.submit(req)
    steps = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        while eng.queue or any(s is not None for s in eng.slots):
            steps.append(timed_step(eng))
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if e.self_device_time_total > 0),
        key=lambda k: -k[1],
    )
    busy_ms = sum(k[1] for k in kernels)
    wall_ms = sum(s[0] for s in steps)
    if busy_ms <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return dict(
        steps_ms=[s[0] for s in steps], steps_host_ms=[s[1] for s in steps],
        device_wall_ms=wall_ms, device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / wall_ms,
        top_kernels=[dict(name=k[0][:80], device_ms=k[1], calls=k[2]) for k in kernels[:8]],
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core import NABackend, fusion
    from repro_torch.graphs import synthetic_hetgraph
    from repro_torch.kernels import build
    # the modules, not the differentiable functions the package exports by the same names
    ff_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg_fused_fp")
    mg_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg_multigraph")
    k5_mod = importlib.import_module("repro_torch.kernels.seg_gat_agg")
    k6_mod = importlib.import_module("repro_torch.kernels.fused_fp_coeff")
    from repro_torch.launch import hgnn_serve
    from repro_torch import serve as serve_mod

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    OUT.mkdir(exist_ok=True)

    t0 = time.perf_counter()
    reports = build.build()
    build_s = time.perf_counter() - t0
    log(f"[build] {len(build.KERNELS)} kernels in {build_s:.1f} s")
    check_ptxas(reports)
    adamw = adamw_phase()
    simple_hgn = simple_hgn_phase()

    t0 = time.perf_counter()
    graph = synthetic_hetgraph("imdb", scale=1.0, feat_scale=1.0, seed=0)
    log(f"[graph] full IMDB in {time.perf_counter() - t0:.1f} s: "
        f"{dict(graph.vertex_counts)}, movie features {graph.feature_dim('movie')}")

    probe = serve_mod.HGNNEngine(graph, target_type="movie", block=16, max_edges=20_000,
                                 device="cuda", **WIDTH)
    for mp in METAPATHS:
        b = probe._batch(mp)
        log(f"[sgb] {b.name}: {b.num_edges} edges, block CSR {tuple(b.col_index.shape)}")
    kernels = kernel_phase(probe, fusion, mg_mod, ff_mod)
    del probe

    # the main path, each backend's run with its own counts
    counters = {"multigraph": mg_mod.seg_gat_agg_multigraph_fwd,
                "fused_fp": ff_mod.seg_gat_agg_fused_fp_fwd,
                "multigraph_bwd": mg_mod.seg_gat_agg_multigraph_bwd,
                "fused_fp_bwd": ff_mod.seg_gat_agg_fused_fp_bwd}
    eng_mg, res_mg, st_mg = serve(graph, serve_mod, NABackend.MULTIGRAPH, counters)
    eng_ff, res_ff, st_ff = serve(graph, serve_mod, NABackend.FUSED_FP, counters)
    launches_by_path = {"multigraph": st_mg["launches"], "fused_fp": st_ff["launches"]}
    log(f"[launches] launches_by_path={json.dumps(launches_by_path)}")
    # each kernel's count comes from the run of the path that launches it
    serve_launches = {"multigraph": st_mg["launches"]["multigraph"],
                      "fused_fp": st_ff["launches"]["fused_fp"]}
    if not all(serve_launches.values()):
        raise AssertionError(f"a kernel of the serving path never launched: {launches_by_path}")
    if any(st["launches"][k] for st in (st_mg, st_ff) for k in ("multigraph_bwd", "fused_fp_bwd")):
        raise AssertionError(f"serving launched a backward kernel: {launches_by_path}")
    if st_mg["launches"]["fused_fp"]:
        raise AssertionError(f"the multigraph run launched the fused kernel: {launches_by_path}")
    for name, st in (("multigraph", st_mg), ("fused-fp", st_ff)):
        m = st["metrics"]
        log(f"[serve {name}] steps_ms={['%.3f' % t for t in st['steps_ms']]} wall={st['wall_s']:.3f} s "
            f"peak_mem={st['peak_mem_bytes'] / 2**20:.1f} MiB requests={m['requests_finished']} "
            f"na_launches={m['na_launches']} fused_steps={m['fused_steps']} "
            f"bypasses={m['fused_cache_bypasses']} cache_hit_rate={m['cache_hit_rate']:.3f}")
    if st_ff["metrics"]["fused_steps"] == 0:
        raise AssertionError("the fused-fp run never took the fused path")
    n_target = graph.num_vertices("movie")
    if sorted(res_mg) != sorted(res_ff) or len(res_mg) != 2 * len(METAPATHS):
        raise AssertionError("not every request finished")
    serve_err = 0.0
    for rid, r in res_mg.items():
        if r.result.shape != (n_target, WIDTH["heads"] * WIDTH["hidden"]):
            raise AssertionError(f"request {rid}: result shape {tuple(r.result.shape)}")
        if not torch.isfinite(r.result).all() or abs(float(r.beta.sum()) - 1.0) > 1e-5:
            raise AssertionError(f"request {rid}: non-finite result or beta not a softmax")
        serve_err = max(serve_err, compare(f"serve rid {rid} fused-fp vs multigraph",
                                           (res_ff[rid].result, res_ff[rid].beta),
                                           (r.result, r.beta)))

    # steady state on the warmed engines (after the main path's counts were read)
    steady = {}
    for name, eng in (("multigraph", eng_mg), ("fused-fp", eng_ff)):
        st = steady[name] = steady_state(eng, serve_mod)
        log(f"[steady {name}] steps_ms={['%.3f' % t for t in st['steps_ms']]} "
            f"device wall {st['device_wall_ms']:.3f} ms, busy {st['device_busy_ms']:.3f} ms, "
            f"idle share {st['device_idle_share']:.4f}")
        for k in st["top_kernels"]:
            log(f"[steady {name}]   {k['device_ms']:9.3f} ms x{k['calls']:<4d} {k['name']}")
    del eng_mg, eng_ff

    # the card against the CPU (plain versions) on a small graph
    small = synthetic_hetgraph("imdb", scale=0.05, feat_scale=0.02, seed=0)
    for backend in (NABackend.MULTIGRAPH, NABackend.FUSED_FP):
        out = {}
        for dev in ("cpu", "cuda"):
            eng = serve_mod.HGNNEngine(small, target_type="movie", backend=backend, block=8,
                                       max_edges=2000, device=dev)
            for req in serve_mod.make_request_mix(0, [[mp] for mp in METAPATHS], repeats=1):
                eng.submit(req)
            out[dev] = {r.rid: r.result for r in eng.run()}
        for rid in out["cpu"]:
            compare(f"small imdb {backend.value} rid {rid} cuda vs cpu",
                    (out["cuda"][rid].cpu(),), (out["cpu"][rid],))

    # the launcher, as a user runs it
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        hgnn_serve.main(["--na-backend", "fused-fp"])
    cli = json.loads(buf.getvalue())
    if cli["requests_finished"] == 0 or not cli["device"].startswith("cuda"):
        raise AssertionError(f"launcher run: {cli}")
    log(f"[launcher] fused-fp: {cli['requests_finished']} requests, {cli['steps']} steps, "
        f"fused_steps={cli['fused_steps']}, wall {cli['wall_s']:.3f} s")

    # phase 4: training
    from repro_torch.launch import hgnn_train

    t0 = time.perf_counter()
    _, tdata = hgnn_train.build_problem(device="cuda", **TRAIN)
    log(f"[train problem] {[b.name for b in tdata.graphs]}: edges "
        f"{[b.num_edges for b in tdata.graphs]}, built in {time.perf_counter() - t0:.1f} s")
    from repro_torch.models.hgnn import HAN

    params0 = HAN.init(torch.Generator().manual_seed(0), tdata, **TRAIN_WIDTH,
                       att_dim=2 * TRAIN_WIDTH["hidden"])
    train_kernels = train_kernel_phase(tdata, params0, fusion, mg_mod, ff_mod)
    train_counters = {"multigraph": mg_mod.seg_gat_agg_multigraph_fwd,
                      "multigraph_bwd": mg_mod.seg_gat_agg_multigraph_bwd,
                      "fused_fp": ff_mod.seg_gat_agg_fused_fp_fwd,
                      "fused_fp_bwd": ff_mod.seg_gat_agg_fused_fp_bwd}
    train = training(tdata, train_counters, fusion)
    lanes = multilane_phase(tdata, train_counters, mg_mod)
    b128 = fused_b128_phase(train_counters, mg_mod, ff_mod, fusion)
    # phase 7 on the phase-4 problem (its counts are read apart from the main path's)
    obs = observability_phase(tdata, obs_counters(mg_mod, ff_mod, k5_mod), k5_mod)
    # each kernel's count comes from the training run of the path that launches it
    launches = {"multigraph": train["multigraph_run"]["launches"]["multigraph"],
                "multigraph_bwd": train["multigraph_run"]["launches"]["multigraph_bwd"],
                "fused_fp": train["fused_fp_run"]["launches"]["fused_fp"],
                "fused_fp_bwd": train["fused_fp_run"]["launches"]["fused_fp_bwd"]}
    del tdata

    # phase 5: the per-graph models on full IMDB's relation graphs
    from repro_torch.models.hgnn import MODELS

    rdata = relation_data(graph, "cuda")
    log("[relations] " + ", ".join(
        f"{b.name} {b.src_type}->{b.dst_type} {b.num_edges} edges, block CSR "
        f"{tuple(b.col_index.shape)}" for b in rdata.graphs))
    rgat0 = MODELS["R-GAT"].init(torch.Generator().manual_seed(0), rdata, **MODEL_WIDTHS["R-GAT"])
    train_kernels["seg_gat_agg"] = kernel5_phase(rdata, rgat0, fusion, k5_mod, mg_mod)
    # c. (run before b, so that a fault of #6 shows here first)
    train_kernels["fused_fp_coeff"] = kernel6_phase(rdata, rgat0, k6_mod)
    del rdata, rgat0
    all_counters = dict(train_counters, seg_gat_agg=k5_mod.seg_gat_agg,
                        fused_fp_coeff=k6_mod.fused_fp_coeff)
    infer = inference(graph, all_counters, NABackend)
    # e. the same models at block=128 (after the main path's counts were read)
    infer["block128"] = inference_block128(graph, k5_mod, NABackend)
    # #5's and #6's counts come from the inference runs that launch them (R-GAT, then S-HGN)
    for k in ("seg_gat_agg", "fused_fp_coeff"):
        launches[k] = sum(infer[m]["launches"][k] for m in ("R-GAT", "S-HGN"))
    # which run each count comes from, and what one `ms` covers
    by_path = {
        "multigraph": {"HAN training, 20 steps": launches["multigraph"],
                       "HAN training over a 16-lane plan at B = 128, 5 steps":
                           lanes["run"]["launches"]["multigraph"],
                       f"run_training(trace=, metrics_out=) at 8 x 128, {OBS_STEPS} steps":
                           obs["trainer"]["launches"]["multigraph"],
                       "HAN training on the (1, 1) mesh through the dist rules, B = 128, 3 steps":
                           b128["mesh_1x1"]["launches"]["mesh"]["multigraph"],
                       f"characterize_hgnn(MULTIGRAPH), {CHAR_PASSES} passes":
                           obs["characterize"]["multigraph"]["launches"]["multigraph"],
                       "examples_torch/serve_hgnn.py":
                           obs["example_serve_hgnn"]["launches"]["multigraph"],
                       "hgnn_serve --na-backend multigraph, full IMDB at 8 x 64":
                           obs["serve_multigraph"]["launches"]["multigraph"]},
        "multigraph_bwd": {"HAN training, 20 steps": launches["multigraph_bwd"],
                           "HAN training over a 16-lane plan at B = 128, 5 steps":
                               lanes["run"]["launches"]["multigraph_bwd"],
                           f"run_training(trace=, metrics_out=) at 8 x 128, {OBS_STEPS} steps":
                               obs["trainer"]["launches"]["multigraph_bwd"],
                           "HAN training on the (1, 1) mesh through the dist rules, B = 128, "
                           "3 steps": b128["mesh_1x1"]["launches"]["mesh"]["multigraph_bwd"]},
        "fused_fp": {"HAN training on FUSED_FP, 3 steps": launches["fused_fp"],
                     "HAN training on FUSED_FP at B = 128 (re-blocked to 32), 3 steps":
                         b128["run"]["launches"]["fused_fp"],
                     "hgnn_serve --na-backend fused_fp, full IMDB at 8 x 64":
                         obs["serve_fused_fp"]["launches"]["fused_fp"]},
        "fused_fp_bwd": {"HAN training on FUSED_FP, 3 steps": launches["fused_fp_bwd"],
                         "HAN training on FUSED_FP at B = 128 (re-blocked to 32), 3 steps":
                             b128["run"]["launches"]["fused_fp_bwd"]},
        "seg_gat_agg": {**{f"{m} forward": infer[m]["launches"]["seg_gat_agg"]
                           for m in ("R-GAT", "S-HGN")},
                        f"characterize_hgnn(KERNEL), {CHAR_PASSES} passes":
                            obs["characterize"]["kernel"]["launches"]["seg_gat_agg"]},
        "fused_fp_coeff": {f"{m} forward": infer[m]["launches"]["fused_fp_coeff"]
                           for m in ("R-GAT", "S-HGN")},
    }
    ms_per = {k: "one launch at the HAN training shapes" for k in by_path}
    for k in ("fused_fp", "fused_fp_bwd"):
        ms_per[k] += (" (phase P and the NA pass: one call, two kernels; multigraph_ms: x @ W + "
                      "the θ einsums + #1 (#2 for the VJP) on the same operands, as MULTIGRAPH "
                      "runs them; library_ms null: no PyTorch call computes fused FP+NA); "
                      "*_b128: the same at B = 128, the topology re-blocked to 32 (phase 4h)")
    ms_per["seg_gat_agg"] = "one R-GAT layer: 6 launches, one per IMDB relation graph"
    ms_per["fused_fp_coeff"] = ("one launch at R-GAT layer 0's actor projection "
                                f"({train_kernels['fused_fp_coeff']['shape']}, float32): the "
                                "wgmma route, w's split included; ms_cuda_cores: the cuda_cores "
                                "route on the same operands")
    rgat_train = rgat_training(all_counters)

    # phase 6: the LM slice
    fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")
    train_kernels["flash_attention"] = flash_phase(fa_mod)
    lm_counters = dict(all_counters, flash_attention=fa_mod.flash_attention)
    lm = lm_phase(lm_counters, fa_mod)
    launches["flash_attention"] = lm["forward"]["launches"]["flash_attention"]
    # phases 6d-6f: the MoE decoders (the llama weights went with lm_phase's frame)
    gc.collect()
    torch.cuda.empty_cache()
    for arch in MOE_LAYERS:
        lm[arch] = moe_lm_phase(arch, lm_counters, fa_mod)
        gc.collect()
        torch.cuda.empty_cache()
    lm["batcher"] = batcher_phase()
    # phases 6g-6h: the recurrent decoders at full width and depth
    gc.collect()
    torch.cuda.empty_cache()
    for arch in RECURRENT_ARCHS:
        lm[arch] = recurrent_lm_phase(arch, lm_counters, fa_mod)
        gc.collect()
        torch.cuda.empty_cache()
    # phases 6i-6j: the VLM and the encoder-decoder at full width and depth
    for arch, phase in ((VLM_ARCH, vlm_lm_phase), (ENCDEC_ARCH, encdec_lm_phase)):
        lm[arch] = phase(lm_counters, fa_mod)
        gc.collect()
        torch.cuda.empty_cache()
    # phase 6k: LM training (no kernel on its path)
    lm["train"] = lm_train_phase(lm_counters, fa_mod)
    gc.collect()
    torch.cuda.empty_cache()
    by_path["flash_attention"] = {"lm_forward": launches["flash_attention"],
                                  "lm_serve": lm["serve_bf16"]["flash_launches"],
                                  "dbrx_forward": lm["dbrx-132b"]["forward"]["launches"][
                                      "flash_attention"],
                                  "grok_forward": lm["grok-1-314b"]["forward"]["launches"][
                                      "flash_attention"],
                                  "recurrentgemma_forward": lm["recurrentgemma-9b"]["forward"][
                                      "launches"]["flash_attention"],
                                  "qwen2vl_forward": lm[VLM_ARCH]["forward"]["launches"][
                                      "flash_attention"],
                                  "whisper_forward_1024_frames": lm[ENCDEC_ARCH]["flash_1024"][
                                      "launches"]["flash_attention"]}
    ms_per["flash_attention"] = (f"one launch at {LM_ARCH}'s layer shape (B={LM_BATCH}, "
                                 f"S={LM_SEQ}, heads 24/8, Dh=128, bf16): the wgmma route; "
                                 "ms_float32: the cuda_cores route on float32 operands; "
                                 "moe_shape: the wgmma route at dbrx's and grok's layer shape "
                                 "(heads 48/8), with its plain, SDPA and bound times; "
                                 "recurrentgemma_shape: the cuda_cores route at recurrentgemma-9b's "
                                 "local layer (heads 16/1 of 256, window 2048, bf16), SDPA with "
                                 "the same window mask (library_backend); vlm_shape: the wgmma "
                                 "route at qwen2-vl-7b's layer (heads 28/4 of 128); whisper_shapes: "
                                 "the wgmma route at whisper-large-v3's encoder on flash (1,024 "
                                 "frames, causal=False) and decoder (448 positions), 20/20 heads "
                                 "of 64")

    sources = {
        "multigraph": ("seg_gat_agg_multigraph_fwd", "src/repro_torch/csrc/seg_gat_agg_multigraph.cu",
                       "src/repro/kernels/seg_gat_agg_multigraph.py:180"),
        "multigraph_bwd": ("seg_gat_agg_multigraph_bwd",
                           "src/repro_torch/csrc/seg_gat_agg_multigraph_bwd.cu",
                           "src/repro/kernels/seg_gat_agg_multigraph.py:228"),
        "fused_fp": ("seg_gat_agg_fused_fp_fwd", "src/repro_torch/csrc/seg_gat_agg_fused_fp.cu",
                     "src/repro/kernels/seg_gat_agg_fused_fp.py:288"),
        "fused_fp_bwd": ("seg_gat_agg_fused_fp_bwd", "src/repro_torch/csrc/seg_gat_agg_fused_fp_bwd.cu",
                         "src/repro/kernels/seg_gat_agg_fused_fp.py:331"),
        "seg_gat_agg": ("seg_gat_agg", "src/repro_torch/csrc/seg_gat_agg.cu",
                        "src/repro/kernels/seg_gat_agg.py:97"),
        "fused_fp_coeff": ("fused_fp_coeff", "src/repro_torch/csrc/fused_fp_coeff.cu",
                           "src/repro/kernels/fused_fp_coeff.py:75"),
        "flash_attention": ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:95"),
    }
    line = {"kernels": [
        {"name": sources[k][0], "route": "cuda", "source": sources[k][1],
         "replaces": sources[k][2], "launches": launches[k],
         "max_abs_err": train_kernels[k]["max_abs_err"], "ms": train_kernels[k]["ms"],
         "plain_ms": train_kernels[k]["plain_ms"], "bound_ms": train_kernels[k]["bound_ms"],
         "bound_by": train_kernels[k]["bound_by"], "library_ms": train_kernels[k]["library_ms"],
         "launches_by_path": by_path[k], "ms_per": ms_per[k]}
        for k in sources
    ]}
    # AdamW's pair: port only, replaces no TPU kernel; its launches from the
    # HAN and R-GAT main-path training runs, its times from phase 9
    line["kernels"].append({
        "name": "fused_adamw", "route": "cuda", "source": "src/repro_torch/csrc/fused_adamw.cu",
        "replaces": None, "launches": train["multigraph_run"]["adamw_launches"]
        + rgat_train["adamw_launches"],
        "max_abs_err": max(adamw[t]["max_abs_err"] for t in ("han-dblp", "rgat-mag")),
        "max_leaf_rel_err": max(adamw[t]["max_leaf_rel_err"] for t in ("han-dblp", "rgat-mag")),
        "ms": adamw["rgat-mag"]["kernel_ms"], "plain_ms": adamw["rgat-mag"]["loop_ms"],
        "bound_ms": adamw["rgat-mag"]["bound_ms"], "bound_by": "hbm", "library_ms": None,
        "launches_by_path": {"HAN training, 20 steps": train["multigraph_run"]["adamw_launches"],
                             "R-GAT training, 20 steps": rgat_train["adamw_launches"]},
        "ms_per": ("one step of the pair (adamw_norm_partials + adamw_update) at rgat-mag's "
                   "66-leaf tree, device ms; plain_ms: the loop it replaces, wall ms of a step "
                   "with its synchronise; han_*: the same at han-dblp's 9-leaf tree"),
        "han_ms": adamw["han-dblp"]["kernel_ms"], "han_plain_ms": adamw["han-dblp"]["loop_ms"],
        "han_bound_ms": adamw["han-dblp"]["bound_ms"]})
    fa_row = next(r for r in line["kernels"] if r["name"] == "flash_attention")
    fa_row["ms_float32"] = train_kernels["flash_attention"]["ms_float32"]
    fa_row["bound_split_ms"] = train_kernels["flash_attention"]["bound_split_ms"]
    fa_row["launches_by_route"] = lm["forward"]["launches_by_route"]
    fa_row["moe_shape"] = train_kernels["flash_attention"]["moe_shape"]
    fa_row["recurrentgemma_shape"] = train_kernels["flash_attention"]["recurrentgemma_shape"]
    fa_row["vlm_shape"] = train_kernels["flash_attention"]["vlm_shape"]
    fa_row["whisper_shapes"] = train_kernels["flash_attention"]["whisper_shapes"]
    k6_row = next(r for r in line["kernels"] if r["name"] == "fused_fp_coeff")
    k6 = train_kernels["fused_fp_coeff"]
    k6_row.update(ms_cuda_cores=k6["ms_cuda_cores"], bound_split_ms=k6["bound_split_ms"],
                  bound_cuda_cores_ms=k6["bound_cuda_cores_ms"], split_error=k6["split_error"],
                  launches_by_route={
                      r: sum(infer[m]["fused_fp_coeff_by_route"][r] for m in ("R-GAT", "S-HGN"))
                      for r in k6_mod.ROUTES})
    for k in ("multigraph", "multigraph_bwd"):  # #1 and #2 visit the live edges only
        row = next(r for r in line["kernels"] if r["source"].endswith(f"seg_gat_agg_{k}.cu"))
        v = train_kernels[k]["visits"]
        row["visited_per_edge"] = (v["fwd"] if k == "multigraph"
                                   else {"pass_a": v["pass_a"], "pass_b": v["pass_b"]})
    k5_row = next(r for r in line["kernels"] if r["name"] == "seg_gat_agg")
    k5 = train_kernels["seg_gat_agg"]
    k5_row.update(visited_per_edge=k5["visited_per_edge"],
                  per_graph_ms={g: v["ms"] for g, v in k5["per_graph"].items()},
                  block128_layer_ms=infer["block128"]["seg_gat_agg_layer"]["ms"])
    bwd_row = next(r for r in line["kernels"] if r["name"] == "seg_gat_agg_multigraph_bwd")
    bwd_row["peak_mem_bytes"] = train_kernels["multigraph_bwd"]["peak_memory"]["peak_bytes"]
    for k in ("fused_fp", "fused_fp_bwd"):  # #3 and #4: no library call computes fused FP+NA
        row = next(r for r in line["kernels"] if r["source"].endswith(f"seg_gat_agg_{k}.cu"))
        tk = train_kernels[k]
        row.update(multigraph_ms=tk["multigraph_ms"], bound_split_ms=tk["bound_split_ms"],
                   bound_cuda_cores_ms=tk["bound_cuda_cores_ms"], split_error=tk["split_error"],
                   kernel_flops=tk["kernel_flops"], flops=tk["flops"],
                   projection_ratio=tk["projection"]["ratio"],
                   launches_by_route=train["fused_fp_run"]["launches_by_route"][k],
                   **{f"{f}_b128": b128[k][f] for f in ("ms", "plain_ms", "multigraph_ms",
                                                        "bound_ms", "bound_by")})
    full = dict(card=card, torch=torch.__version__, build_s=build_s, kernels=kernels,
                train_kernels=train_kernels, training=train, multilane=lanes, fused_b128=b128,
                inference=infer,
                observability=obs,
                rgat_training=rgat_train, lm=lm, adamw=adamw, simple_hgn=simple_hgn,
                launches=launches, launches_by_path=launches_by_path,
                serve={"multigraph": st_mg, "fused-fp": st_ff}, steady=steady,
                serve_max_abs_err=serve_err, launcher=cli)
    (OUT / "chip_smoke.json").write_text(json.dumps(full, indent=1, default=str))
    for k in line["kernels"]:
        nums = [k[f] for f in ("ms", "plain_ms", "bound_ms", "max_abs_err")]
        nums += [] if k["library_ms"] is None else [k["library_ms"]]
        if not all(math.isfinite(v) for v in nums):
            raise AssertionError(f"non-finite number in {k}")
    log(card_line())
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
