#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

Run from the root of the repository, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile every kernel from ``paddle_tpu_torch/csrc`` (ptxas's
   resource-usage log kept beside each library).
   analysis — the kernel analysis tier (``paddle_tpu_torch.analysis.
   kernels``, rules CK200-CK209) on the card: the H100 preset held against
   the card's properties; every plane over ``paddle_tpu_torch/ops/kernels``
   — each module's declared launches (``ck_examples()``: the JAX
   ``pk_examples()`` shapes and every phase-3 row's shape, each with a tail
   shape) checked over their grids, ptxas's registers, shared memory and
   spills joined into one resource sheet per launch (and per compiled
   kernel no example launches), every example and tail launched once
   under ``torch.profiler`` (grid, block, shared memory and registers as
   declared) and once inside poisoned guard bands (no band changed, no
   sentinel left, no poison read, the plain version's result): no
   unwaived error and no ``__global__`` function left unlaunched; one line
   per sheet. Then row 22, the planted demo (``csrc/analysis_demo.cu``):
   its findings map one to one onto its plants (CK200 vmem_overflow,
   CK201 overlapping_writes, CK202 coverage_gap, CK203 oob_read, CK206
   missing_check, nothing on vmem_scalar_mulf), the card refuses the
   overflow, the coverage gap leaves the sentinel in rows 128-255 and the
   out-of-bounds read brings the poison into the output; each runnable
   plant is timed. Phase 3 takes every row's bound from these sheets.
3. kernels — each kernel against its plain PyTorch version on the card at
   the serving path's shapes (bf16): max abs error within its tolerance
   (the block epilogue's dropped positions identical), and cold-L2 times
   of the kernel, the plain version and, where one exists, the single
   PyTorch call that computes the same function, beside the least time
   the card could take (``bound_ms``). RoPE runs on the q+k pairs of a
   decode step and of a 512-token chunk (one launch each) and on single
   tensors; mmha at Llama-3-8B's decode batch (B 8, positions 0..1500)
   and at B 1 (position 900), B 16, rep 1 (Hkv 32), rep 8 (H 64) and D 64,
   each with two calls bit for bit and SDPA on the gathered view as its
   yardstick; then through the contiguous entry at the fmt phase's last
   step (q [8, 1, 12, 64] over [8, 12, 1024, 64] caches at position 575:
   two calls and the pool path over the same pages bit for bit, plain
   version ``reference_mmha``, SDPA on the [8, 12, 576, 64] view). The decode layer is also timed
   through the port's composite path (``composite_ms``) and broken down
   by its phases. The weight-only int8 / grouped int8 / int4 kernels run
   at decode and prefill shapes of Llama-3-8B's projections (yardstick:
   cuBLAS bf16 ``torch.matmul`` on the dequantized weight), and A8W8 must
   be bit-identical to its plain version on a construction where
   ``x / s`` is exact (yardstick: ``torch._int_mm``, the int8
   contraction alone). SwiGLU runs at every shape the paths launch and at
   the sigmoid's extremes (each element within one ulp); the RMSNorm
   backward at the Llama and Qwen2-MoE train steps' rows, two calls bit
   for bit. Each kernel's summary in the last lines carries every shape's
   numbers (``shapes``).
4. serve   — Llama-3-8B at full width and depth, random weights from a
   seed, served by six ``LLMEngine``s over the same model, 12 greedy
   requests each on 8 slots (engine f: 4); every kernel's launch count is
   set to 0 just before each engine's run and read just after:
   a. chunked prefill on the per-op path, no prefix cache (four kernels
      must have launched);
   b. the default ``ServingConfig()``: monolithic prefill through the
      flash kernel, the block epilogues, the prefix cache. Every prompt
      is a shared 512-token system prompt plus a unique suffix, and one
      request repeats another's whole page-aligned prompt (the full-cover
      cap and copy-on-write). All six kernels of that path must have
      launched, every request after the first must claim the system
      prompt's 32 pages, and no page may leak;
   c. ``ServingConfig(fused_decode_layer=True)`` on engine b's traffic:
      its construction tunes the decode layer's ``block_i`` into a
      temporary cache file (a second construction must hit the cache),
      then every decode step must launch the decode-layer kernel once per
      layer and mmha never, with engine b's prefix-cache claims;
   d. ``ServingConfig(quant="weight_only_int8")`` on engine b's traffic:
      every monolithic prefill and decode step launches the int8 kernel
      once per projection (7 x 32), with engine b's prefix-cache claims;
   e. the same with ``quant="weight_only_int4"`` and the int4 kernel;
   f. ``quant="weight_only_int8", quant_group_size=128,
      fused_decode_layer=True``, the first 4 requests of engine b's
      traffic, 16 tokens each: the grouped kernel in prefill and on q/k/v
      in decode, 32 decode-layer launches a step on the dequantized
      weights, no mmha.
   Each quantized engine's copies are freed before the next is built.
   After phase 6, engine b's configuration and traffic with ``spec_k=4``
   (speculative decoding), each engine's tokens held against engine b's
   (a first divergence allowed only where b's top-2 logit gap there is
   within the parity tolerance), mmha launched once a layer in every
   decode and verify step, no page leaked:
   g. the n-gram drafter, adaptive K;
   h. a drafter that replays engine b's output (drafts land whenever the
      outputs agree): it must accept drafts and emit more than one token
      a step;
   i. b's first 4 requests with a drafter that proposes b's next tokens
      plus one (never the argmax while the outputs agree) at a pinned K:
      the verify's pure cost and the rollback path.
   Engine b's configuration serves b's traffic again before g and after
   i: a control of the same phase, since the host's speed moves between
   phases.
   Each reports tokens/s, decode and verify steps and their ms, accepted
   over proposed drafts, tokens per step and the drafter's host ms a step.
   verify_attention — the verify step's attention at those engines' shape
   (8 rows of 5 lanes): mmha over the 40 lanes as rows against its plain
   version (the same bits twice) and the JAX verify's ``chunk_attention``
   composite, both timed; the whole verify forward, kernels against plain
   versions over every lane's logits, and its profile.
   generate — cached ``model.generate`` on the served model: 64 greedy
   tokens for 4 of engine b's prompts, one B 1 call each (mmha 32 a token,
   flash 32 at the prefill), held against engine b's tokens by the same
   rule, then the four prompts cut to the shortest in one B 4 call held
   against B 1 calls; GPT-2 small (bf16) 64 tokens for 8 prompts of 128,
   held against the exact-length host loop (``use_cache=False``). ms per
   token.
5. parity  — at full width, through the kernels and through the plain
   versions, logits compared: the first decode step of every request of
   engine a (after chunked prefill), of every request of engine b its
   monolithic-prefill logits and its first fused decode step, and of every
   request of engine c its first fused-layer decode step; the same for
   engines d, e and f.
6. profile — torch.profiler breakdown of a per-op decode step (batch 8),
   a 512-token prefill chunk, a fused decode step (batch 8), a
   fused-layer decode step (batch 8) and a 1024-token monolithic prefill:
   the port's kernels, matrix products, the rest, and the device's idle
   share; a decode step (batch 8) and a 1024-token monolithic prefill on
   each quantized engine (d int8, e int4, f grouped int8 with the fused
   layer). Every profiled decode step launches RoPE exactly once a layer
   (q and k together) and mmha once a layer (none on the fused layer).
   llm_int8 — ``nn.quant.llm_int8_linear`` at x [1024, 4096] bf16 with 4
   outlier channels, w [14336, 4096] int8 and a bias: one A8W8 launch per
   call, against its plain path, timed.
   ptq — ``quantization.PTQ`` with an absmax activation observer on a
   copy of the served Llama-3-8B, calibrated on 4 prompts of 512 tokens
   and converted: 225 ``Int8WeightOnlyLinear`` s holding about half of
   bf16's bytes; a 1024-token forward (one int8 launch a projection, the
   prefill kernel) whose last logits match the plain int8 products within
   the parity tolerance and whose argmax is that of the same model with
   ``weight_dequantize``'d bf16 weights but at a near-tie, and cached
   ``generate`` B 1 and B 8 x 32 against that twin (the decode kernel a
   token), tokens agreeing but at near-ties.
   http — engine b behind ``serving.server.serve`` on a local port: its
   12 prompts posted from 8 client threads, half streaming NDJSON, tokens
   against engine b's; ``/metrics`` parsed as an exposition and its
   serving counters (generated tokens, decode steps, the TTFT and e2e
   histograms' counts) against what was served; ``/healthz`` in serving
   mode; ``/requests`` and ``/flight`` holding the 12 requests; a bad body
   400, an over-long prompt 429; then engine b's tokens/s, scheduler
   iteration wall and its host work outside the forward with metrics,
   tracing and the flight recorder all on against all off (on, off, off,
   on), a finding and not a gate.
   train — once the serving model and engines are freed: Llama-3-8B's
   width cut to 4 layers (bf16 with f32 master weights) on one fixed B 2 x
   S 2048 batch through the backward kernels and the AdamW kernel: parity
   of the loss and of every gradient with the plain path and an f32 copy
   on the fused trunk (the default: the block epilogue and its backward
   at every junction) and on the unfused trunk, one unfused step and 8
   fused steps with a falling loss, the exact launches of every step, step
   time, tokens/s, peak memory and a profile of a step on each trunk.
   int8_grad — ``llama3_8b(num_layers=4)`` with its 28 decoder projections
   PTQ-converted and frozen, the embedding, norms and head training with
   AdamW at B 2 x S 2048: the forward's int8 launches at M 4096, ``dx``
   through the weight-only VJP; the train-parity gate, 4 steps with their
   launches and a falling loss, the backward's dequantised-weight bytes
   and times, a profile of a step.
   packed_mlp — ``nn.functional.swiglu(x)`` on one packed operand in an
   MLP with a fused gate/up projection at Llama-3-8B's widths, forward and
   backward: one launch of each packed SwiGLU kernel, gradients against
   the plain path.
   train_gpt — GPT-2 small at full width and depth (12 layers, 124M,
   vocab 50304) on B 8 x S 1024 through the block epilogue (layer norm
   with its bias) and its backward, flash attention forward and backward
   and AdamW: parity, 8 steps with their launches, a falling loss, step
   time, tokens/s, MFU, peak memory and a profile of a step.
   qat — ``quantization.QAT`` with absmax fake quanters on GPT-2 small's
   48 projections: the train-parity gate from one quanter state on both
   paths (weight scales equal, activation scales within two bf16 ulps),
   8 AdamW steps with the fused trunk's launches and a falling loss; then
   ``QAT.convert``, ``PTQ`` to int8 and cached ``generate`` B 8 x 64
   against the dequantized twin.
   optimizers — SGD, Momentum (Nesterov; bf16 with master weights),
   Adagrad, Adadelta, Adamax, centered RMSProp with momentum, Adam with
   ``L1Decay``, SGD with ``L2Decay`` and ``ClipGradByValue``, Momentum with
   ``ClipGradByNorm``: 3 steps each on GPT-2 small's embedding, first-block
   and final-norm shapes on the card against the same steps on CPU copies,
   the last step on the card under ``set_sync_debug_mode("error")``; LBFGS
   with a closure on a least-squares problem, its loss falling.
   train_lamb — GPT-2 small at full width and depth with ``Lamb``
   (multi_precision, 1-D parameters excluded from the decay, a global-norm
   clip) under ``LinearWarmup(CosineAnnealingDecay(2e-3, T_max=8))`` and
   the loss ``ParallelCrossEntropy()(logits, labels).mean()``: parity, 8
   steps with their launches (lamb once per parameter, parallel_ce once),
   the learning rate at the schedule's value, a step that does not
   synchronise, a falling loss, one Lamb step against the plain version,
   step time, tokens/s, MFU, peak memory and a profile of a step.
   incubate — the incubate fused ops' path: 12 post-LN blocks at GPT-2
   small's width (hidden 768, 12 heads, FFN 3072, bf16, dropout 0.1)
   written only with ``incubate.softmax_mask_fuse[_upper_triangle]``,
   ``incubate.nn.FusedLinear``, ``FusedBiasDropoutResidualLayerNorm`` and
   ``FusedDropoutAdd``, each linear's weight and bias gradients
   accumulated into f32 ``main_grad`` buffers by
   ``fused_linear_param_grad_add`` from a hook on its output: (a) two
   causal micro-batches of B 4 x S 1024 and (b) one encoder batch with a
   padding mask, forward and backward, each through the kernels and,
   from the same seed, the plain path: exact launches, the same dropout
   draws, parity of the output, dx and every main_grad, the first layer's
   attention against the flash kernel, the main_grads against autograd's
   weight gradients, ms a micro-batch on each path, peak memory and a
   profile of a micro-batch.
   fmt — ``incubate.nn.FusedMultiTransformer`` at GPT-2 small's widths
   (12 layers, hidden 768, 12 heads of 64, FFN 3072, gelu, pre-LN, bf16):
   8 prompts of 512 seeded hidden states prefilled into per-layer caches
   [2, 8, 12, 1024, 64] (302 MB), then 64 decode steps at ``time_step``
   512-575, each through the mmha kernel over the caller's caches in place
   (the contiguous entry): each step's output against the one-shot
   576-position prefill at its position, 12 mmha launches a step, no host
   sync in a step, the strided kernel within one bf16 ulp of
   ``reference_mmha`` on the same buffers; prefill ms, decode-step wall
   and device ms, a profile of a step.
   encoder — 12 ``FusedTransformerEncoderLayer`` s at BERT-base's widths
   (768, 12 heads, 3072, post-LN, gelu), B 8 x S 512, bf16, forward and
   backward: (a) no mask, no dropout (flash forward and backward, 12 + 12
   launches), (b) a padding mask and attention dropout 0.1 (the SDPA
   composite); each held to its plain path and an f32 copy by the
   train-parity gate; step ms and a profile of each.
   incubate_functions — each composite of ``incubate.nn.functional`` and
   the masked SDPA at a small shape, card against CPU in f32.
   serve_moe — Qwen1.5-MoE-A2.7B (``Qwen2MoeConfig()``: 24 layers, 60
   experts of 1408, top-4, a shared expert, 14.3 B parameters in bf16)
   answers 4 prompts of 512 seeded random tokens with 32 greedy tokens
   each through ``model.generate``, the exact-length host loop: the
   layer loop's kernels and 72 grouped-product launches a forward, tokens/s,
   ms a forward, peak memory, each layer's share of slots dropped by
   capacity, a profile of the prompt's forward.
   parity_moe — that model, kernel path against plain: every MoE block and
   every whole layer on the same input (routing pinned), the prompts'
   last-position logits with the routing pinned, the free-running routing
   flips by layer (reported), the first served tokens.
   train_moe — Qwen1.5-MoE's width at 4 layers, B 2 x S 2048, AdamW with
   master weights and ``ClipGradForMOEByGlobalNorm``: parity with the
   routing pinned (and free running, reported), 8 steps with their
   launches, a falling loss, step time, tokens/s, MFU, peak memory and a
   profile of a step.
   serve_ernie — dense ERNIE-4.5 at full width and depth (``ErnieConfig()``:
   28 layers, hidden 2560, 20 query heads over 4 kv heads, so mmha and
   flash at rep 5, a tied head, 3.35 B parameters, random bf16 weights
   from a seed) on ``LLMEngine(ServingConfig())``, engine b's traffic (12
   requests of 64 greedy tokens after a shared 512-token system prompt):
   no leaked page, the prefix-cache claims, the 131072-position rope
   tables built once, the prefill and first-decode logits of every request
   against the plain path, 28 mmha launches a profiled decode step; then
   cached ``generate`` at B 1 x 64 against the engine's tokens (and B 4
   against B 1), as the generate phase does for Llama.
   ernie_moe — ERNIE-4.5 with its MoE tail (``ErnieConfig(num_experts=64)``:
   3 dense layers, then 25 MoE layers of 64 experts of 1536, top-6, a
   shared expert; 20.2 B parameters in bf16) generates 16 greedy tokens for
   4 prompts of 512 through the exact-length host loop (the layer loop's
   kernels, 75 grouped-product launches a forward); then parity_moe's
   checks on it (every layer and MoE block on the same input, the
   last-position logits with the routing pinned, the first served tokens).
   train_ernie — dense ERNIE at 4 of its 28 layers, B 2 x S 2048,
   ``AdamW(multi_precision=True, ClipGradByGlobalNorm(1.0), fuse=True)``:
   the train-parity gate over 4 batches (flash forward and backward at rep
   5), 8 steps (an eager warm-up, one capture, 6 replays: the fused-trunk
   kernels every step, AdamW's launches on the first two), a falling loss,
   the fused step's stats; then ``ErnieConfig(num_experts=64,
   num_layers=5)`` (3 dense, 2 MoE layers) for 2 steps.
   fused_step — GPT-2 small (148 parameters), AdamW then Lamb with a
   global-norm clip and master weights: 8 steps eager and 8 fused from one
   seed on the same 8 batches, the grads zeroed in place but re-allocated
   once: every parameter, moment and master weight the same bits, 7
   replays, 1 warm-up, 0 fallbacks, the re-allocated grads copied in; the
   step wall, the optimizer's host ms, the launches the profiler sees and
   peak memory, fused against eager.
   Phase 3 holds the training kernels (RMSNorm, SwiGLU, flash-attention
   and block-epilogue backward, packed SwiGLU and its backward, AdamW,
   LAMB and the cross-entropy row statistics) against their plain versions
   at the train phases' shapes, the grouped expert product at one
   Qwen1.5-MoE layer's shapes (both weight layouts), and the incubate
   kernels (masked and causal softmax and its backward, bias-dropout-
   residual layer norm and its backward, dropout-add both ways, the
   weight-gradient accumulation) at GPT-2 small's and Llama-3-8B's shapes.
   Every row's bytes and operations are those of the analysis phase's
   resource sheet at its shape; its ``predicted_ms`` must agree with the
   row's ``bound_ms`` within 1%, and the row carries the sheet's
   registers, shared memory, spills and occupancy.
7. summary — one JSON line of every kernel's launches (the decode layer's
   on engine c's run, the weight-only kernels' on engines d, e and f, A8W8's
   in the llm_int8 phase, the training kernels' in one fused-trunk train
   step, the packed SwiGLU kernels' in the packed_mlp phase, LAMB's and the
   cross entropy's in one train_lamb step, the incubate kernels' over the
   incubate phase's runs (a) and (b), the grouped product's in serve_moe's
   run, the others' on engine b's, the demo plants' in the analysis
   phase) and times, then the last
   line ``{"ok": true, "device": {...}}``.

The script imports neither JAX nor ``paddle_tpu``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM rate, the f32
# rate outside the tensor cores, where the row kernels compute, the bf16
# tensor-core rate, where flash attention's and the weight-only kernels'
# products run, and the int8 tensor-core rate, where A8W8's run
MEM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TC_FLOPS_PER_S = 989e12
INT8_TC_OPS_PER_S = 1979e12

SERVE_REQUESTS = 12
SERVE_NEW_TOKENS = 64
PROMPT_MIN, PROMPT_MAX = 256, 1536
PARITY_REL_TOL = 0.05    # max |logit diff| <= 5% of the largest plain logit
SYSTEM_PROMPT = 512       # shared prefix of the default engine's prompts
SUFFIX_MIN, SUFFIX_MAX = 64, 1024
QUANT_KERNELS = ("wo_int8", "wo_int8_grouped", "wo_int4", "a8w8")
QUANT_GROUP = 128         # engine f's quant_group_size
FUSED_QUANT_REQUESTS, FUSED_QUANT_TOKENS = 4, 16
SPEC_K = 4                # engines g-i: draft tokens a request and step
SPEC_ADVERSARIAL_REQUESTS = 4     # engine i serves engine b's first four
GEN_REQUESTS, GEN_TOKENS = 4, 64  # generate phase: Llama-3-8B, B 1 calls
GPT_GEN_BATCH, GPT_GEN_PROMPT = 8, 128    # generate phase: GPT-2 small
LLM_INT8_CALLS = 4        # llm_int8_linear calls of the A8W8 phase's run
TRAIN_KERNELS = ("rms_norm_bwd", "swiglu_bwd", "flash_attention_bwd",
                 "adamw", "block_epilogue_bwd")
PACKED_KERNELS = ("swiglu_packed", "swiglu_packed_bwd")
LAMB_KERNELS = ("lamb", "parallel_ce")
TRAIN_LAYERS = 4          # Llama-3-8B's width, depth cut to fit the state
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_STEPS = 8
TRAIN_LOSS_TOL = 5e-3     # kernels vs plain: loss, relative
# Each gradient, relative L2. Both bf16 paths lie 1.2-4.5% from the f32
# gradient of the same weights (PR 5's first runs, PERF.md §6), so the
# kernel path is held against the plain one at 5e-2, and against f32 to no
# more than 1.1x the plain path's own distance from it.
TRAIN_GRAD_TOL = 5e-2
TRAIN_F32_RATIO = 1.1
GPT_BATCH, GPT_SEQ = 8, 1024   # GPT-2 small's train phase: B 8 x S 1024
# ptq: calibration prompts and length, the forward held against the
# dequantized twin, cached generate at B 1 and B PTQ_BATCH
PTQ_CALIB, PTQ_CALIB_LEN, PTQ_FORWARD_LEN = 4, 512, 1024
PTQ_BATCH, PTQ_PROMPT_LEN, PTQ_NEW_TOKENS = 8, 128, 32
PTQ_BYTES_RATIO = (0.49, 0.51)   # int8 + f32 scales over bf16: 1/2 + 2/K
QAT_PARITY_BATCHES, QAT_STEPS, QAT_NEW_TOKENS = 2, 8, 64
GPT_GEN_BATCH, QAT_PROMPT_LEN = 8, 128   # qat's int8 generate: B 8 x 128
QAT_ACT_SCALE_TOL = 2.0 ** -6    # two bf16 ulps: absmax of bf16 activations
INT8_GRAD_STEPS = 4
HTTP_CLIENTS = 8           # the http phase's client threads
HTTP_AB_TOKENS = 32        # tokens a request in its on/off host-wall turns
HTTP_AB_ROUNDS = 6         # rounds of turns on, off, off, on
GPT_STEPS = 8
# GPT-2 small's parity runs over 4 batches. Its layer-norm weights and
# biases have 768 entries, and on one batch the ratio of a gradient's
# distance from f32 through the kernels to the plain path's scatters by a
# few percent around 1 (the train_parity line's per_batch summary shows
# each batch's worst, mean and spread), so the largest of 148 gradients
# can pass 1.1 by chance; summed over 4 batches the spread halves, and the
# same TRAIN_F32_RATIO holds every gradient.
GPT_PARITY_BATCHES = 4
# train_lamb's schedule: LinearWarmup(CosineAnnealingDecay(2e-3, T_max=8),
# warmup_steps=2, start_lr=0.0, end_lr=2e-3)
LAMB_PEAK_LR, LAMB_T_MAX, LAMB_WARMUP = 2e-3, 8, 2
# phase 3's LAMB shapes (Llama-3-8B's largest parameter, GPT-2 small's
# embedding) and cross-entropy logits (Llama-3-8B's at B 2 x S 2048, GPT-2
# small's at B 8 x S 1024)
LAMB_SHAPES = ((14336, 4096), (50304, 768))
CE_SHAPES = ((4096, 128256), (8192, 50304))
# The optimizers phase: card against CPU, relative L2 of each parameter.
# The same f32 operations on both (AdamW's kernel rounds as its plain
# version does); only a norm's or a power's last bits differ.
OPT_REL_TOL = 1e-5
# Qwen2-MoE (Qwen1.5-MoE-A2.7B's widths): phase 3's grouped products at one
# layer's shapes for MOE_TOKENS tokens; serve_moe's prompts; train_moe's
# depth (24 layers cut to 4 so that bf16 weights and grads, f32 masters and
# both moments, 46.5 GB, fit the card)
MOE_KERNELS = ("moe_gemm",)
MOE_TOKENS = 2048
MOE_REQUESTS, MOE_PROMPT, MOE_NEW_TOKENS = 4, 512, 32
# ERNIE-4.5 (ErnieConfig(): the published text backbone's widths)
ERNIE_MOE_EXPERTS = 64     # ernie_moe and the MoE train: the MoE tail
ERNIE_MOE_NEW_TOKENS = 16
ERNIE_TRAIN_LAYERS = 4     # 28 cut to 4, as Llama-3-8B's train phase
ERNIE_PARITY_BATCHES = 4
ERNIE_MOE_TRAIN_LAYERS, ERNIE_MOE_TRAIN_STEPS = 5, 2
FUSED_STEPS = 8            # fused_step: eager and fused runs of GPT-2 small
FUSED_REALLOC_STEP = 4     # the step after which clear_grad() re-allocates
MOE_TRAIN_LAYERS = 4
MOE_PARITY_BATCHES = 1
# parity_moe (a): max abs error <= 2**-5 (four bf16 ulps) of the largest
# plain magnitude. On one input the two paths round the expert products,
# the SwiGLU gate, the down product and the sum with the shared expert once
# each, at values up to one ulp apart.
MOE_BLOCK_TOL = 2.0 ** -5
# The incubate slice (rows 18-21): its path is INCUBATE_LAYERS post-LN
# blocks at GPT-2 small's width (hidden 768, 12 heads of 64, FFN 3072),
# depth and S (GPT_SEQ), dropout 0.1, two micro-batches of B 4
INCUBATE_KERNELS = ("softmax_mask", "softmax_mask_tri", "softmax_mask_bwd",
                    "bias_dropout_ln", "bias_dropout_ln_bwd", "dropout_add",
                    "dropout_add_bwd", "linear_grad_add")
INCUBATE_LAYERS, INCUBATE_HIDDEN, INCUBATE_HEADS = 12, 768, 12
INCUBATE_BATCH, INCUBATE_SEQ, INCUBATE_P = 4, 1024, 0.1
INCUBATE_SEED = 2028
# fmt phase: FusedMultiTransformer at GPT-2 small's widths (GPTConfig()),
# B 8 prompts of 512 seeded hidden states into 1024-position caches, then
# 64 decode steps; each step's output within FMT_TOL relative L2 of the
# one-shot 576-position prefill's at its position (bf16 through 12 layers:
# the two paths round their products in other orders, and a decode step's
# projections run at other GEMM shapes)
FMT_BATCH, FMT_PROMPT, FMT_STEPS, FMT_CACHE = 8, 512, 64, 1024
FMT_SEED = 2040
FMT_TOL = 1e-2
# encoder phase: 12 FusedTransformerEncoderLayers at BERT-base's widths,
# post-LN, gelu, B 8 x S 512, bf16
ENC_LAYERS, ENC_HIDDEN, ENC_HEADS, ENC_FFN = 12, 768, 12, 3072
ENC_BATCH, ENC_SEQ, ENC_ATTN_DROPOUT, ENC_SEED = 8, 512, 0.1, 2041
# its parity runs over 4 batches, as GPT-2 small's (GPT_PARITY_BATCHES): the
# same 768-entry layer-norm vectors, whose one-batch f32 ratios scatter by
# a few percent around 1 (on one batch the largest of 192 gradients reached
# 1.103 with a mean of 1.006 and a spread of 0.029)
ENC_PARITY_BATCHES = 4
# incubate_functions: card against CPU in f32, max abs error within this
# share of the largest reference magnitude (f32 products summed in another
# order; TF32 off)
INCUBATE_FN_TOL = 1e-4
# phase 3's incubate shapes: softmax (B, H, S, masked, with the backward;
# the last the incubate micro-batch's own); rows of the layer norm (rows,
# hidden, masked) and of dropout-add (rows, hidden); the weight-gradient
# accumulations (M, K, N, accumulator dtype)
INCUBATE_SOFTMAX = ((8, 12, 1024, True, True), (8, 12, 1024, False, False),
                    (2, 32, 2048, False, False), (4, 12, 1024, False, True))
INCUBATE_LN = ((8192, 768, True), (8192, 768, False), (4096, 768, True),
               (4096, 4096, True))
INCUBATE_DROPOUT = ((8192, 768), (4096, 768), (4096, 4096))
INCUBATE_GRAD = ((8192, 768, 3072, "float32"), (4096, 4096, 14336, "float32"),
                 (8192, 768, 3072, "bfloat16"),
                 # the incubate path's own four products at B 4 x S 1024
                 (4096, 768, 2304, "float32"), (4096, 768, 768, "float32"),
                 (4096, 768, 3072, "float32"), (4096, 3072, 768, "float32"))


# the analysis phase: each plant of the demo and the rules its findings must
# name, exactly (row 22)
DEMO_RULES = {"vmem_overflow": {"CK200"}, "overlapping_writes": {"CK201"},
              "coverage_gap": {"CK202"}, "oob_read": {"CK203"},
              "vmem_scalar_mulf": set(), "missing_check": {"CK206"}}
DEMO_REPLACES = {"vmem_overflow": 38, "overlapping_writes": 48,
                 "coverage_gap": 60, "oob_read": 72, "vmem_scalar_mulf": 89}
RATES = {"f32": F32_FLOPS_PER_S, "bf16": BF16_TC_FLOPS_PER_S,
         "int8": INT8_TC_OPS_PER_S}
#: g at the sigmoid's extremes for phase 3's SwiGLU check (exp(-g) passes
#: 2^126 below about -88 and overflows below -88.7)
SWIGLU_EXTREMES = [88.0, -88.0, 100.0, -100.0, 1e4, -1e4, 0.0, -87.5, -88.5,
                   -89.0, -90.0, 20.0, -20.0, 1.0, -1.0]
#: (library, label) -> the analysis phase's resource sheets of that
#: example, one a kernel it launches
SHEETS: dict = {}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries ``t_s``, the seconds since
    the script started, so the run's wall splits by phase."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the rate of the units that do them (f32 by default)."""
    t_b, t_o = nbytes / MEM_BYTES_PER_S, flops / flops_per_s
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


class ColdTimer:
    """Mean device time of one call, each call starting with a cold L2:
    a 1 GiB buffer is written between calls (the card's L2 holds 50 MB).
    The write takes ~0.3 ms on the device, long enough for the host to
    enqueue the next call before the device reaches it, so the events
    time the device work and not the host's launch path."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.int32, device=device)

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters


def compare(torch, got, ref):
    """(max abs error, tolerance): one bf16 ulp of the largest reference
    magnitude, 2**-7 * max|ref| — kernel and plain version do the same
    f32 arithmetic and round once, in another order."""
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    tol = 2.0 ** -7 * ref.float().abs().max().item()
    return err, tol


# -- phases ------------------------------------------------------------------

def phase_device(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi unavailable"
    print(card, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return card


def phase_build():
    from paddle_tpu_torch.ops.kernels import _build
    secs = _build.build_all()
    emit({"phase": "build", "seconds": secs,
          "sources": [f"paddle_tpu_torch/csrc/{n}.cu" for n in _build.SOURCES]})


def phase_analysis(torch):
    """The kernel analysis tier on the card: the H100 preset against the
    card, every plane over ``paddle_tpu_torch/ops/kernels/`` (no unwaived
    error, no ``__global__`` left unlaunched), one line per resource sheet,
    then the planted demo (row 22). Fills :data:`SHEETS` for phase 3.
    Returns the demo plants' rows of the summary line."""
    from paddle_tpu_torch import cost_model
    from paddle_tpu_torch.analysis.cli import apply_allowlist, load_allowlist
    from paddle_tpu_torch.analysis.diagnostics import ERROR, format_text
    from paddle_tpu_torch.analysis.kernels import ALLOWLIST_NAME, collect

    t0 = time.perf_counter()
    diffs = cost_model.check_preset("h100")
    if diffs:
        fail(f"the h100 preset differs from the card: {diffs}")
    report: list = []
    findings, sheets = collect(["paddle_tpu_torch/ops/kernels/"],
                               report=report)
    kept, waived = apply_allowlist(findings, load_allowlist(ALLOWLIST_NAME))
    for f in kept:
        print(format_text(f, show_hint=False), flush=True)
    for sheet in sheets:
        print("sheet", sheet.line_text(), flush=True)
        if sheet.label:
            SHEETS.setdefault((sheet.library, sheet.label), []).append(sheet)
    errors = [f for f in kept if f.severity == ERROR]
    unlaunched = [f for f in kept if f.rule_id == "CK209"
                  and "not launched" in f.message]
    emit({"phase": "analysis", "preset": "h100", "examples": len(report),
          "sheets": len(sheets),
          "static_sheets": sum(1 for x in sheets if not x.label),
          "kernels_profiled": sum(len(r["kernels"]) for r in report),
          "findings": {sev: sum(1 for f in kept if f.severity == sev)
                       for sev in ("error", "warning", "info")},
          "waived": [f"{f.rule_id} {os.path.basename(f.file)}"
                     for f in waived],
          "worst_guard": max((r.get("max_err", 0.0) / r["tol"]
                              for r in report if r.get("tol")), default=0.0)})
    if errors or unlaunched:
        fail(f"analysis: {len(errors)} unwaived error(s), "
             f"{len(unlaunched)} kernel(s) no example launches: "
             f"{[f.message for f in errors + unlaunched][:5]}")
    rows = _analysis_demo(torch)
    emit({"phase": "analysis", "seconds": time.perf_counter() - t0})
    return rows


def _plant_of(f):
    """The plant a demo finding belongs to: its ``[label]``, else the
    function it sits in."""
    if f.message.startswith("["):
        return f.message[1:f.message.index("]")].removesuffix(" tail")
    return f.symbol


def _analysis_demo(torch):
    """Row 22: the demo's findings map one to one onto its plants, and on
    the card the refused overflow, the copy of the overlapping writes, the
    sentinel left by the coverage gap and the poison read past the input
    show. Each runnable plant is then timed against its plain version."""
    from paddle_tpu_torch.analysis.diagnostics import INFO
    from paddle_tpu_torch.analysis.kernels import collect, demo, guard

    for k in demo.LAUNCHES:
        demo.LAUNCHES[k] = 0
    report: list = []
    findings, sheets = collect([demo.__file__], report=report)
    launches = dict(demo.LAUNCHES)
    for sheet in sheets:
        print("sheet", sheet.line_text(), flush=True)
    got = {p: set() for p in DEMO_RULES}
    for f in findings:
        if f.severity != INFO:
            got.setdefault(_plant_of(f), set()).add(f.rule_id)
        print(f"demo {f.rule_id} {f.severity}: {f.message}", flush=True)
    if got != DEMO_RULES:
        fail(f"analysis demo: findings by plant {got}, expected "
             f"{DEMO_RULES}")
    on_card = {p: [f.message for f in findings if _plant_of(f) == p]
               for p in DEMO_RULES}
    checks = {
        "vmem_overflow refused": any("refused" in m
                                     for m in on_card["vmem_overflow"]),
        "coverage_gap sentinel in rows 128-255": any(
            "16384 of 32768 elements of o still hold the sentinel" in m
            for m in on_card["coverage_gap"]),
        "oob_read poison read, bands unchanged": any(
            "NaN in o" in m for m in on_card["oob_read"])
        and not any("guard band" in m for m in on_card["oob_read"]),
        "overlapping_writes equals the copy": not any(
            "differs" in m or "sentinel" in m
            for m in on_card["overlapping_writes"])}
    emit({"phase": "analysis_demo", "findings": {p: sorted(r) for p, r in
                                                  got.items()},
          "card": checks, "launches": launches})
    if not all(checks.values()):
        fail(f"analysis demo on the card: {checks}")
    if launches["vmem_overflow"] or not all(
            launches[p] for p in launches if p != "vmem_overflow"):
        fail(f"analysis demo launches {launches}")

    dev = torch.device("cuda")
    timer = ColdTimer(torch, dev)
    by_label = {s.label: s for s in sheets if s.label}
    errs = {r["label"]: r for r in report}
    library = {"vmem_overflow": lambda t: torch.add(t["x"], t["x"]),
               "overlapping_writes": lambda t: t["o"].copy_(t["x"]),
               "coverage_gap": lambda t: t["o"][:128].copy_(t["x"]),
               "oob_read": lambda t: t["o"][:128].copy_(t["x"]),
               "vmem_scalar_mulf": None}
    rows = []
    stream = torch.cuda.current_stream().cuda_stream
    for ex in demo.ck_examples():
        t = guard.make_inputs(torch, ex, dev)
        s = by_label[ex.label]
        refused = "refused" in errs[ex.label]
        bms, by = bound(s.nbytes, s.flops, RATES[s.unit])
        lib = library[ex.label]
        rows.append({
            "name": f"analysis_demo.{ex.label}", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/analysis_demo.cu",
            "replaces": "paddle_tpu/analysis/kernels/demo.py:"
                        f"{DEMO_REPLACES[ex.label]}",
            "launches": launches[ex.label],
            "max_abs_err": None if refused else errs[ex.label]["max_err"],
            "ms": None if refused else timer(lambda: ex.launch(t, stream)),
            "plain_ms": timer(lambda: ex.plain(t)), "bound_ms": bms,
            "bound_by": by,
            "library_ms": None if lib is None else timer(lambda: lib(t)),
            **({"refused": errs[ex.label]["refused"]} if refused else {})})
        emit({"kernel": rows[-1]["name"], **{k: v for k, v in rows[-1].items()
                                             if k != "name"}})
    return rows


def _record(results, name, shape, err, tol, ms, plain_ms, library_ms,
            sheet, **extra):
    """One phase-3 row. ``sheet`` is ``(library, label)`` of the analysis
    phase's resource sheet at this row's shape: the bound is taken from its
    byte and operation counts (one count for both phases), and must agree
    with the sheet's ``predicted_ms`` within 1%."""
    kernels = SHEETS.get(sheet)
    if not kernels:
        fail(f"{name} {shape}: no resource sheet {sheet} from the analysis "
             f"phase")
    s = kernels[0]          # the example's counts ride every one of its sheets
    bms, by = bound(s.nbytes, s.flops, RATES[s.unit])
    if not abs(bms - s.predicted_ms) <= 0.01 * s.predicted_ms:
        fail(f"{name} {shape}: bound {bms} ms against the sheet's "
             f"predicted {s.predicted_ms} ms (more than 1% apart)")
    row = {"kernel": name, "shape": shape, "max_abs_err": err, "tol": tol,
           "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bms, "bound_by": by, "predicted_ms": s.predicted_ms,
           "sheet": list(sheet),
           "resources": [{"kernel": k.kernel, "regs": k.registers,
                          "smem": [k.static_smem, k.dynamic_smem],
                          "spills": [k.spill_stores, k.spill_loads],
                          "occupancy": k.occupancy, "blocks": k.grid,
                          "waves": k.waves} for k in kernels], **extra}
    emit(row)
    if not err <= tol:
        fail(f"{name} {shape}: max abs error {err} > tolerance {tol}")
    # the first (decode) shape is the kernel's summary; every shape's numbers
    # ride it under "shapes"
    first = results.setdefault(name, row)
    first.setdefault("shapes", []).append(
        {"shape": shape, "ms": ms, "plain_ms": plain_ms,
         "library_ms": library_ms, "bound_ms": bms, "bound_by": by,
         "max_abs_err": err})


def phase_kernels(torch, dev):
    import torch.nn.functional as TF

    from paddle_tpu_torch.models.llama import LlamaConfig, rope_tables
    from paddle_tpu_torch.ops.kernels import mmha, rms_norm, rope, swiglu

    gen = torch.Generator(device=dev).manual_seed(1234)
    timer = ColdTimer(torch, dev)
    bf = torch.bfloat16
    results: dict = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    # rms_norm: the decode rows [8, 4096] and the prefill chunk's [512,
    # 4096] with and without the residual, the Qwen2-MoE forward's [2048,
    # 2048] with it, the unfused Llama train step's [4096, 4096] with and
    # without; two calls give the same bits
    for rows, hid, with_res in rms_norm.FWD_SHAPES:
        w = (1.0 + torch.randn(hid, generator=gen, device=dev) * 0.1).to(bf)
        x, res = randn(rows, hid), randn(rows, hid)
        r = res if with_res else None
        got = rms_norm.rms_norm(x, w, r, 1e-5)
        ref = rms_norm.rms_norm_plain(x, w, r, 1e-5)
        again = rms_norm.rms_norm(x, w, r, 1e-5)
        if with_res:
            err_h, tol_h = compare(torch, got[1], ref[1])
            if not err_h <= tol_h:
                fail(f"rms_norm residual sum: {err_h} > {tol_h}")
            if not torch.equal(got[1], again[1]):
                fail(f"rms_norm [{rows}, {hid}]: two calls gave different h")
            got, ref, again = got[0], ref[0], again[0]
        if not torch.equal(got, again):
            fail(f"rms_norm [{rows}, {hid}]: two calls gave different bits")
        err, tol = compare(torch, got, ref)
        lib = None if with_res else timer(
            lambda: TF.rms_norm(x, (hid,), w, 1e-5))
        _record(results, "rms_norm",
                [rows, hid] + (["residual"] if with_res else []),
                err, tol, timer(lambda: rms_norm.rms_norm(x, w, r, 1e-5)),
                timer(lambda: rms_norm.rms_norm_plain(x, w, r, 1e-5)),
                lib, ("rms_norm", rms_norm.fwd_label(rows, hid, with_res)),
                same_bits=True, plan=list(rms_norm.plan(rows, hid)[:3]))
        del x, res, r, got, ref, again

    # swiglu: every shape the paths launch (swiglu.FWD_SHAPES: the decode
    # batches, the prefill chunk and the 1024-token prefill, the Llama train
    # step, Qwen1.5-MoE's expert capacity tensor and shared expert); two
    # calls give the same bits; then g at the sigmoid's extremes, every
    # element within one ulp of the plain version at its own magnitude
    for rows, width in swiglu.FWD_SHAPES:
        g, u = randn(rows, width), randn(rows, width)
        got = swiglu.swiglu(g, u)
        if not torch.equal(got, swiglu.swiglu(g, u)):
            fail(f"swiglu [{rows}, {width}]: two calls gave different bits")
        err, tol = compare(torch, got, swiglu.swiglu_plain(g, u))
        _record(results, "swiglu", [rows, width], err, tol,
                timer(lambda: swiglu.swiglu(g, u)),
                timer(lambda: swiglu.swiglu_plain(g, u)), None,
                ("swiglu", swiglu.fwd_label(rows, width)), same_bits=True,
                plan=list(swiglu.plan(rows * width)[:3]))
        del g, u, got
    g = torch.tensor(SWIGLU_EXTREMES, device=dev).repeat(4, 32).to(bf)
    u = torch.linspace(-3.0, 3.0, g.numel(), device=dev).view(g.shape).to(bf)
    got, ref = swiglu.swiglu(g, u).float(), swiglu.swiglu_plain(g, u).float()
    ulp = (2.0 ** (torch.floor(torch.log2(ref.abs())) - 7)).clamp(
        min=2.0 ** -133)
    worst = ((got - ref).abs() / ulp).max().item()
    emit({"kernel": "swiglu", "extremes": SWIGLU_EXTREMES,
          "max_ulps": worst})
    if not (worst <= 1.0 and bool(torch.isfinite(got).all())):
        fail(f"swiglu at g {SWIGLU_EXTREMES}: {worst} ulps from the plain "
             f"version")

    # rope: the q+k pairs of a decode step (per-token tables at ragged
    # positions) and of a 512-token prefill chunk, one launch each; then the
    # one-tensor rows of earlier runs
    cfg = LlamaConfig()
    cos_t, sin_t = rope_tables(cfg, 2048, dev)
    dpos = torch.tensor([0, 17, 255, 256, 700, 1023, 1200, 1500], device=dev)
    for (b, s), c, sn in (((8, 1), cos_t[dpos], sin_t[dpos]),
                          ((1, 512), cos_t[:512], sin_t[:512])):
        q, k = randn(b, s, 32, 128), randn(b, s, 8, 128)
        gq, gk = rope.rope_qk(q, k, c, sn)
        err_q, tol_q = compare(torch, gq, rope.rope_plain(q, c, sn))
        err_k, tol_k = compare(torch, gk, rope.rope_plain(k, c, sn))
        if not err_k <= tol_k:
            fail(f"rope k [{b}, {s}, 8, 128]: {err_k} > {tol_k}")
        label = f"q [{b}, {s}, 32, 128] + k [{b}, {s}, 8, 128]"
        _record(results, "rope", label, err_q, tol_q,
                timer(lambda: rope.rope_qk(q, k, c, sn)),
                timer(lambda: (rope.rope_plain(q, c, sn),
                               rope.rope_plain(k, c, sn))), None,
                ("rope", f"phase3 {label}"), max_abs_err_k=err_k, tol_k=tol_k)
    cases = [([8, 1, 32, 128], cos_t[dpos], sin_t[dpos]),
             ([1, 512, 32, 128], cos_t[:512], sin_t[:512]),
             ([1, 512, 8, 128], cos_t[:512], sin_t[:512])]
    for shape, c, s in cases:
        x = randn(*shape)
        err, tol = compare(torch, rope.rope_apply(x, c, s),
                           rope.rope_plain(x, c, s))
        _record(results, "rope", shape, err, tol,
                timer(lambda: rope.rope_apply(x, c, s)),
                timer(lambda: rope.rope_plain(x, c, s)), None,
                ("rope", f"phase3 {shape}"))

    # mmha: B=8, H=32, Hkv=8, D=128, page 16, ragged positions; row 0 is
    # inactive (pos 0, all-trash table); pages handed out shuffled; then
    # the rows at B 1, B 16, rep 1 (Hkv 32), rep 8 (H 64) and D 64
    ps, max_pages = 16, 2048 // 16
    rows = [("phase3 [8, 1, 32, 128]",
             [0] + [int(p) + 1 for p in dpos[1:].tolist()], 32, 8, 128)]
    rows += list(mmha.PHASE3_ROWS)
    for label, lengths, h, h_kv, d in rows:
        b = len(lengths)
        tables, pos, n_pages = _paged(torch, dev, lengths, ps, max_pages, 7)
        k_pool = randn(n_pages, h_kv, ps, d)
        v_pool = randn(n_pages, h_kv, ps, d)
        q = randn(b, 1, h, d)
        got = mmha.mmha_decode(q, k_pool, v_pool, tables, pos)
        again = mmha.mmha_decode(q, k_pool, v_pool, tables, pos)
        ref = mmha.mmha_plain(q, k_pool, v_pool, tables, pos)
        if not torch.isfinite(got).all():
            fail(f"mmha {label}: output (an inactive row's included) is "
                 f"not finite")
        if not torch.equal(got, again):
            fail(f"mmha {label}: two calls gave different bits")
        err, tol = compare(torch, got, ref)
        # library yardstick: SDPA over the gathered view with a <= pos mask
        kc = mmha.gather_pages(k_pool, tables)
        vc = mmha.gather_pages(v_pool, tables)
        mask = (torch.arange(kc.shape[2], device=dev)[None, :]
                <= pos[:, None])[:, None, None, :]
        qt = q.transpose(1, 2)
        if h // h_kv == 5:
            # ERNIE-4.5's rep: SDPA's own GQA over the gathered copy
            kr, vr = kc, vc
            lib = timer(lambda: TF.scaled_dot_product_attention(
                qt, kc, vc, attn_mask=mask, enable_gqa=True))
        else:
            kr = kc.repeat_interleave(h // h_kv, dim=1)
            vr = vc.repeat_interleave(h // h_kv, dim=1)
            lib = timer(lambda: TF.scaled_dot_product_attention(
                qt, kr, vr, attn_mask=mask))
        del kc, vc, kr, vr, mask
        _record(results, "mmha", [b, 1, h, d, "Hkv", h_kv, "ps", ps,
                                  "pos", pos.tolist()], err, tol,
                timer(lambda: mmha.mmha_decode(q, k_pool, v_pool, tables,
                                               pos)),
                timer(lambda: mmha.mmha_plain(q, k_pool, v_pool, tables,
                                              pos)),
                lib, ("mmha", label), same_bits=True,
                chunk_plan=list(mmha.plan(b, h_kv, max_pages, ps, d)))
    _kernels_mmha_contiguous(torch, dev, randn, timer, results)
    _kernels_flash(torch, dev, randn, timer, results)
    _kernels_epilogue(torch, randn, timer, results)
    _kernels_decode_layer(torch, dev, randn, timer, results)
    _kernels_wo(torch, dev, randn, timer, results)
    _kernels_a8w8(torch, dev, randn, timer, results)
    _kernels_train(torch, dev, randn, timer, results)
    _kernels_epilogue_bwd(torch, randn, timer, results)
    _kernels_swiglu_packed(torch, randn, timer, results)
    _kernels_lamb(torch, dev, timer, results)
    _kernels_parallel_ce(torch, dev, timer, results)
    _kernels_moe_gemm(torch, dev, randn, timer, results)
    _kernels_incubate(torch, dev, randn, timer, results)
    return results


def _kernels_mmha_contiguous(torch, dev, randn, timer, results):
    """Row 1 through the contiguous entry at the fmt phase's last decode
    step: q [8, 1, 12, 64] over caches [8, 12, 1024, 64] read in place,
    every row at position 575. Two calls give the same bits, and the same
    bits as the pool path over the same pages (the cache recast as a pool
    with its own table); the plain version is ``reference_mmha``; the
    library yardstick SDPA on the cache's [8, 12, 576, 64] view."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels import mmha

    label, lengths, h, h_kv, d, t = mmha.CONTIGUOUS_ROW
    b, ps = len(lengths), mmha.CONTIGUOUS_PAGE
    kb, vb = randn(b, h_kv, t, d), randn(b, h_kv, t, d)
    q = randn(b, 1, h, d)
    pos = torch.tensor([n - 1 for n in lengths], dtype=torch.int32,
                       device=dev)
    got = mmha.mmha_decode_contiguous(q, kb, vb, pos)
    again = mmha.mmha_decode_contiguous(q, kb, vb, pos)
    if not torch.equal(got, again):
        fail(f"mmha {label}: two calls gave different bits")

    def as_pool(buf):       # [B, Hkv, T, D] -> pages [B * T / ps, Hkv, ps, D]
        return buf.reshape(b, h_kv, t // ps, ps, d).permute(
            0, 2, 1, 3, 4).reshape(b * t // ps, h_kv, ps, d).contiguous()
    tables = (torch.arange(b, device=dev)[:, None] * (t // ps)
              + torch.arange(t // ps, device=dev)[None, :]).to(torch.int32)
    pooled = mmha.mmha_decode(q, as_pool(kb), as_pool(vb), tables, pos)
    if not torch.equal(got, pooled):
        fail(f"mmha {label}: the contiguous entry and the pool path over "
             f"the same pages gave different bits")
    del pooled
    ref = mmha.reference_mmha(q, kb, vb, pos)
    err, tol = compare(torch, got, ref)
    n = int(pos.max()) + 1
    qt = q.transpose(1, 2)
    kv, vv = kb[:, :, :n], vb[:, :, :n]
    lib = timer(lambda: TF.scaled_dot_product_attention(qt, kv, vv))
    _record(results, "mmha", [b, 1, h, d, "Hkv", h_kv, "contiguous T", t,
                              "pos", pos.tolist()], err, tol,
            timer(lambda: mmha.mmha_decode_contiguous(q, kb, vb, pos)),
            timer(lambda: mmha.reference_mmha(q, kb, vb, pos)), lib,
            ("mmha", label), same_bits=True, same_bits_as_pool=True,
            chunk_plan=list(mmha.plan(b, h_kv, t // ps, ps, d)))


def _rel_l2(torch, got, ref):
    torch.cuda.synchronize()
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def _grad_timer(torch, timer, out, inputs, grad_out):
    """Cold time of autograd's backward of ``out`` (a graph built once)
    with respect to ``inputs``: a library call's backward as a yardstick."""
    return timer(lambda: torch.autograd.grad(out, inputs, grad_out,
                                             retain_graph=True))


def _kernels_train(torch, dev, randn, timer, results):
    """The training kernels at the train phase's shapes (Llama-3-8B's
    width, TRAIN_BATCH x TRAIN_SEQ = 2 x 2048 tokens): the RMSNorm backward
    at [4096, 4096] and at the Qwen2-MoE step's [4096, 2048], each with and
    without the residual sum's cotangent (dx within one bf16 ulp; dw within
    1e-3 of its largest value plus the one bf16 rounding of the result; dx
    and dw the same bits on two calls), the SwiGLU backward [4096, 14336] (one ulp),
    the flash-attention backward at q [2, 2048, 32, 128] over 8 kv heads,
    causal, then packed segments at [2, 1024], full attention at [1, 1024]
    and D 64, and GPT-2 small's causal [GPT_BATCH, GPT_SEQ, 12, 64] over
    12 kv heads (dq, dk, dv within 1e-2 relative L2 of the plain f32
    version), and AdamW over a [14336, 4096] parameter with an f32 master
    and a bf16 gradient (bit for bit). Yardsticks, timed only: autograd of
    ``F.rms_norm`` and of ``F.scaled_dot_product_attention(enable_gqa=
    True)``, and ``torch.optim.AdamW(fused=True)``'s step on an f32
    parameter of the same size with an f32 gradient (the same 28 bytes an
    element)."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels import adamw, flash_attention as fa
    from paddle_tpu_torch.ops.kernels import rms_norm, swiglu

    from paddle_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig()
    rows, hid, inter = TRAIN_BATCH * TRAIN_SEQ, cfg.hidden_size, \
        cfg.intermediate_size
    # the Llama train step's [4096, 4096] and the Qwen2-MoE one's [4096,
    # 2048] (rms_norm.BWD_SHAPES), each with and without the cotangent of
    # the residual sum; dx and dw the same bits on two calls
    for b_rows, b_hid in rms_norm.BWD_SHAPES:
        w = (1.0 + randn(b_hid).float() * 0.1).to(torch.bfloat16)
        h, g = randn(b_rows, b_hid), randn(b_rows, b_hid)
        for with_gh in (False, True):
            gh = randn(b_rows, b_hid) if with_gh else None
            dx, dw = rms_norm.rms_norm_bwd(h, w, g, gh, 1e-5)
            dx2, dw2 = rms_norm.rms_norm_bwd(h, w, g, gh, 1e-5)
            if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
                fail(f"rms_norm_bwd [{b_rows}, {b_hid}]: two calls gave "
                     f"different bits")
            rdx, rdw = rms_norm.rms_norm_bwd_plain(h, w, g, gh, 1e-5)
            err, tol = compare(torch, dx, rdx)
            err_w, _ = compare(torch, dw, rdw)
            tol_w = (1e-3 + 2.0 ** -7) * rdw.float().abs().max().item()
            if not err_w <= tol_w:
                fail(f"rms_norm_bwd dw: {err_w} > {tol_w}")
            lib = None
            if not with_gh:
                xl = h.clone().requires_grad_()
                wl = w.clone().requires_grad_()
                lib = _grad_timer(torch, timer,
                                  TF.rms_norm(xl, (b_hid,), wl, 1e-5),
                                  (xl, wl), g)
                del xl, wl
            _record(results, "rms_norm_bwd",
                    [b_rows, b_hid] + (["residual cotangent"] if with_gh
                                       else []), err, tol,
                    timer(lambda: rms_norm.rms_norm_bwd(h, w, g, gh, 1e-5)),
                    timer(lambda: rms_norm.rms_norm_bwd_plain(h, w, g, gh,
                                                              1e-5)),
                    lib, ("rms_norm", rms_norm.bwd_label(b_rows, b_hid,
                                                         with_gh)),
                    dw_err=err_w, dw_tol=tol_w, same_bits=True,
                    plan=list(rms_norm.bwd_plan(b_rows, b_hid, with_gh)[:5]))
            del gh, dx, dw, dx2, dw2, rdx, rdw
        del w, h, g

    gg, uu, dy = randn(rows, inter), randn(rows, inter), randn(rows, inter)
    got, ref = swiglu.swiglu_bwd(gg, uu, dy), swiglu.swiglu_bwd_plain(gg, uu, dy)
    err_u, tol_u = compare(torch, got[1], ref[1])
    if not err_u <= tol_u:
        fail(f"swiglu_bwd du: {err_u} > {tol_u}")
    err, tol = compare(torch, got[0], ref[0])
    _record(results, "swiglu_bwd", [rows, inter], err, tol,
            timer(lambda: swiglu.swiglu_bwd(gg, uu, dy)),
            timer(lambda: swiglu.swiglu_bwd_plain(gg, uu, dy)), None,
            ("swiglu", f"phase3 bwd [{rows}, {inter}]"))
    del gg, uu, dy, got, ref

    half = TRAIN_SEQ // 2
    for b, s, hq, h_kv, d, causal, with_seg in (
            (TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads, cfg.num_kv_heads,
             cfg.head_dim, True, False),
            (2, half, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, True,
             True),
            (1, half, cfg.num_heads, cfg.num_kv_heads, 64, False, False),
            (GPT_BATCH, GPT_SEQ, 12, 12, 64, True, False)):
        q, do = randn(b, s, hq, d), randn(b, s, hq, d)
        k, v = randn(b, s, h_kv, d), randn(b, s, h_kv, d)
        seg = None
        if with_seg:
            seg = fa.segment_ids(s, [[s // 10, s // 3, s // 3 + 1],
                                     [s // 2]]).to(dev)
        out, lse = fa.flash_attention(q, k, v, causal, seg, True)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal, seg)
        ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal, seg)
        errs = {nm: _rel_l2(torch, a, r)
                for nm, a, r in zip(("dq", "dk", "dv"), got, ref)}
        if not all(torch.isfinite(a).all() for a in got):
            fail("flash_attention_bwd: non-finite gradients")
        if not max(errs.values()) <= 1e-2:
            fail(f"flash_attention_bwd {[b, s, hq, d]}: relative L2 {errs} "
                 f"> 1e-2")
        del ref
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        if seg is None:
            lo = TF.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                 enable_gqa=True)
        else:
            mask = ((seg[:, :, None] == seg[:, None, :])
                    & torch.ones(s, s, dtype=torch.bool, device=dev).tril()
                    )[:, None]
            lo = TF.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                 enable_gqa=True)
        lib = _grad_timer(torch, timer, lo, (qt, kt, vt), do.transpose(1, 2))
        del lo, qt, kt, vt
        _record(results, "flash_attention_bwd",
                [b, s, hq, d, "Hkv", h_kv, "causal" if causal else "full"]
                + (["segments"] if with_seg else []),
                max(errs.values()), 1e-2,
                timer(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do,
                                                     causal, seg)),
                timer(lambda: fa.flash_attention_bwd_plain(
                    q, k, v, out, lse, do, causal, seg), iters=5),
                lib, ("flash_attention_bwd",
                      f"phase3 bwd [{b}, {s}, {hq}, {d}] "
                      + ("causal" if causal else "full")
                      + (" segments" if with_seg else "")),
                rel_l2=errs, error_metric="max relative L2 of dq, dk, dv",
                host_us=_host_us(torch, lambda: fa.flash_attention_bwd(
                    q, k, v, out, lse, do, causal, seg)))
        del q, k, v, do, out, lse, got

    rows_w, cols_w = inter, hid
    gen = torch.Generator(device=dev).manual_seed(77)
    master = torch.randn(rows_w, cols_w, generator=gen, device=dev) * 0.02
    grad = (torch.randn(rows_w, cols_w, generator=gen, device=dev)
            * 1e-3).to(torch.bfloat16)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, wd=0.01)
    scal = adamw.adamw_scalars(torch.tensor(1e-4, device=dev),
                               torch.tensor(3.0, device=dev), 0.9, 0.999)
    state = [master.to(torch.bfloat16), torch.rand_like(master) * 1e-3,
             torch.rand_like(master) * 1e-6, master]
    ref = [t.clone() for t in state]
    adamw.adamw_update(state[0], grad, state[1], state[2], scal,
                       master=state[3], **kw)
    adamw.adamw_update_plain(ref[0], grad, ref[1], ref[2], scal,
                             master=ref[3], **kw)
    torch.cuda.synchronize()
    err = max((a.float() - r.float()).abs().max().item()
              for a, r in zip(state, ref))
    if not all(torch.equal(a, r) for a, r in zip(state, ref)):
        fail(f"adamw: kernel and plain version differ (max abs {err})")
    del ref
    lib_p = torch.nn.Parameter(master.clone())
    lib_p.grad = grad.float()
    lib_opt = torch.optim.AdamW([lib_p], lr=1e-4, weight_decay=0.01,
                                fused=True)
    lib = timer(lib_opt.step)
    del lib_p, lib_opt
    _record(results, "adamw", [rows_w, cols_w, "f32 master", "bf16 grad"],
            err, 0.0,
            timer(lambda: adamw.adamw_update(state[0], grad, state[1],
                                             state[2], scal, master=state[3],
                                             **kw)),
            timer(lambda: adamw.adamw_update_plain(
                state[0], grad, state[1], state[2], scal, master=state[3],
                **kw)),
            lib, ("adamw", f"phase3 [{rows_w}, {cols_w}]"))


def _kernels_epilogue_bwd(torch, randn, timer, results):
    """The block-epilogue backward at the train phases' junctions: [4096,
    4096] rms with the residual stream's cotangent (Llama-3-8B's width, B 2
    x S 2048) and [8192, 768] layer norm with its bias and that cotangent
    (GPT-2 small, B 8 x S 1024); then one functional row each at [4096,
    4096] for gelu with layer norm, a bias and p = 0.2, and for swiglu
    (x [4096, 8192]) with rms and p = 0.4. dx and dres within one bf16 ulp
    of the plain version, the f32 dw and db within 1e-3 of their largest
    values; with dropout, dx is zero exactly where the forward's counter
    hash dropped. A second call must give the same bits (no atomics).
    Yardstick, for the act-free p = 0 rows: autograd of ``F.rms_norm`` /
    ``F.layer_norm`` on ``x + residual`` with both cotangents. The call's
    time holds both of its launches (the rows kernel and the partial-sum
    kernel); ``split_ms`` gives each one's device ms over 10 warm calls."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels import block_epilogue as be

    for rows, hid, act, norm, p, bias_on in (
            (TRAIN_BATCH * TRAIN_SEQ, 4096, None, "rms", 0.0, False),
            (GPT_BATCH * GPT_SEQ, 768, None, "layer", 0.0, True),
            (4096, 4096, "gelu", "layer", 0.2, True),
            (4096, 4096, "swiglu", "rms", 0.4, False)):
        xw = 2 * hid if act == "swiglu" else hid
        w = (1.0 + randn(hid).float() * 0.1).to(torch.bfloat16)
        h, gy, gh = randn(rows, hid), randn(rows, hid), randn(rows, hid)
        x = randn(rows, xw) if act else None
        args = (h, x, w, gy, gh, 1234, p, 1e-5, act, norm, bias_on)
        got = be.fused_epilogue_bwd(*args)
        ref = be.fused_epilogue_bwd_plain(*args)
        err_r, tol_r = compare(torch, got[1], ref[1])
        if not err_r <= tol_r:
            fail(f"block_epilogue_bwd dres: {err_r} > {tol_r}")
        err, tol = compare(torch, got[0], ref[0])
        sums = {}
        for nm, a, r in (("dw", got[2], ref[2]), ("db", got[3], ref[3])):
            if r is None:
                continue
            e, _ = compare(torch, a, r)
            t = 1e-3 * r.abs().max().item()
            if not e <= t:
                fail(f"block_epilogue_bwd {nm}: {e} > {t}")
            sums[f"{nm}_err"], sums[f"{nm}_tol"] = e, t
        again = be.fused_epilogue_bwd(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)
                   if a is not None):
            fail("block_epilogue_bwd: two calls on the same inputs differ")
        del got, ref, again
        if p:
            # a zero gy leaves dx = mask(gh) * scale: zero exactly where the
            # forward dropped (gh bounded away from 0)
            gh1 = (gh.float().abs() + 1.0).to(gh.dtype)
            dx0 = be.fused_epilogue_bwd(h, None, w, torch.zeros_like(gy), gh1,
                                        1234, p, 1e-5, None, norm,
                                        bias_on)[0]
            keep = be.keep_mask(rows, hid, 1234, p, h.device)
            bad = int(((dx0 != 0) != keep).sum())
            if bad:
                fail(f"block_epilogue_bwd dropout: the kernel kept other "
                     f"positions than the counter hash at {bad} of "
                     f"{keep.numel()} elements")
        lib = None
        if act is None and not p:
            xl = randn(rows, hid).requires_grad_()
            rl = randn(rows, hid).requires_grad_()
            wl = w.clone().requires_grad_()
            hl = xl + rl
            if norm == "rms":
                yl, ins = TF.rms_norm(hl, (hid,), wl, 1e-5), (xl, rl, wl)
            else:
                bl = randn(hid, scale=0.1).requires_grad_()
                yl = TF.layer_norm(hl, (hid,), wl, bl, 1e-5)
                ins = (xl, rl, wl, bl)
            lib = timer(lambda: torch.autograd.grad(
                (yl, hl), ins, (gy, gh), retain_graph=True))
            del xl, rl, hl, yl, ins
        split = _profile(torch, lambda: be.fused_epilogue_bwd(*args),
                         reps=10).get("port_ms_per_call")
        _record(results, "block_epilogue_bwd",
                [rows, hid, f"act={act}", norm, f"p={p}",
                 "bias" if bias_on else "no bias", "residual cotangent"],
                err, tol, timer(lambda: be.fused_epilogue_bwd(*args)),
                timer(lambda: be.fused_epilogue_bwd_plain(*args), iters=5),
                lib, ("block_epilogue",
                      f"phase3 bwd [{rows}, {hid}] act={act} {norm} p={p}"
                      + (" bias" if bias_on else "")),
                dres_err=err_r, split_ms=split, **sums)
        del h, gy, gh, x


def _kernels_swiglu_packed(torch, randn, timer, results):
    """Packed SwiGLU at the packed-MLP phase's shape, x [4096, 2 x 14336]
    (Llama-3-8B's intermediate width, B 2 x S 2048 tokens): the gate and
    its backward within one bf16 ulp. No single PyTorch call computes
    either."""
    from paddle_tpu_torch.ops.kernels import swiglu

    rows, inter = TRAIN_BATCH * TRAIN_SEQ, 14336
    x, dy = randn(rows, 2 * inter), randn(rows, inter)
    err, tol = compare(torch, swiglu.swiglu_packed(x),
                       swiglu.swiglu_packed_plain(x))
    _record(results, "swiglu_packed", [rows, 2 * inter], err, tol,
            timer(lambda: swiglu.swiglu_packed(x)),
            timer(lambda: swiglu.swiglu_packed_plain(x)), None,
            ("swiglu", f"phase3 packed [{rows}, 2 x {inter}]"))
    err, tol = compare(torch, swiglu.swiglu_packed_bwd(x, dy),
                       swiglu.swiglu_packed_bwd_plain(x, dy))
    _record(results, "swiglu_packed_bwd", [rows, 2 * inter], err, tol,
            timer(lambda: swiglu.swiglu_packed_bwd(x, dy)),
            timer(lambda: swiglu.swiglu_packed_bwd_plain(x, dy)), None,
            ("swiglu", f"phase3 packed bwd [{rows}, 2 x {inter}]"))


def _kernels_lamb(torch, dev, timer, results):
    """LAMB at Llama-3-8B's largest parameter, [14336, 4096], and GPT-2
    small's embedding, [50304, 768]: an f32 master, its bf16 copy and a
    bf16 gradient at step 3 of warm moments. The moments bit for bit; the
    f32 master within 1e-6 of its largest entry and the trust ratio within
    1e-6 relative (the kernel sums the norms in another order than
    ``torch.sum``); the bf16 parameter within one bf16 ulp. No PyTorch call
    computes LAMB: no library time."""
    from paddle_tpu_torch.ops.kernels import adamw, lamb

    kw = dict(beta1=0.9, beta2=0.999, eps=1e-6, wd=0.01)
    scal = adamw.adamw_scalars(torch.tensor(2e-3, device=dev),
                               torch.tensor(3.0, device=dev), 0.9, 0.999)
    gen = torch.Generator(device=dev).manual_seed(78)
    for rows, cols in LAMB_SHAPES:
        master = torch.randn(rows, cols, generator=gen, device=dev) * 0.02
        grad = (torch.randn(rows, cols, generator=gen, device=dev)
                * 1e-3).to(torch.bfloat16)
        state = [master.to(torch.bfloat16),
                 torch.randn(rows, cols, generator=gen, device=dev) * 1e-4,
                 torch.rand(rows, cols, generator=gen, device=dev) * 1e-7,
                 master]
        ref = [t.clone() for t in state]
        trust = lamb.lamb_update(state[0], grad, state[1], state[2], scal,
                                 master=state[3], **kw)
        want = lamb.lamb_update_plain(ref[0], grad, ref[1], ref[2], scal,
                                      master=ref[3], **kw)
        torch.cuda.synchronize()
        if not (torch.equal(state[1], ref[1]) and torch.equal(state[2],
                                                              ref[2])):
            fail(f"lamb {[rows, cols]}: moments differ from the plain "
                 f"version")
        trust_rel = abs(trust.item() - want.item()) / want.item()
        if not trust_rel <= 1e-6:
            fail(f"lamb {[rows, cols]}: trust {trust.item()} against "
                 f"{want.item()} ({trust_rel} > 1e-6 relative)")
        err_p, tol_p = compare(torch, state[0], ref[0])
        if not err_p <= tol_p:
            fail(f"lamb {[rows, cols]}: bf16 parameter {err_p} > {tol_p}")
        err = (state[3] - ref[3]).abs().max().item()
        tol = 1e-6 * ref[3].abs().max().item()
        del ref
        _record(results, "lamb", [rows, cols, "f32 master", "bf16 grad"],
                err, tol,
                timer(lambda: lamb.lamb_update(state[0], grad, state[1],
                                               state[2], scal,
                                               master=state[3], **kw)),
                timer(lambda: lamb.lamb_update_plain(
                    state[0], grad, state[1], state[2], scal,
                    master=state[3], **kw)),
                None, ("lamb", f"phase3 [{rows}, {cols}]"),
                trust=trust.item(),
                trust_rel_err=trust_rel, param_err=err_p, param_tol=tol_p)
        del state, grad, master


def _kernels_parallel_ce(torch, dev, timer, results):
    """The cross-entropy row statistics at Llama-3-8B's training logits,
    [4096, 128256], and GPT-2 small's, [8192, 50304], bf16, with every
    97th label at ``ignore_index``: the row max and the target logit
    exactly, the sum of exponentials within 1e-5 relative, and the loss of
    ``c_softmax_with_cross_entropy`` within 1e-5 absolute of the plain
    path's. Yardstick, timed only: ``F.cross_entropy(logits.float(),
    labels, reduction="none")``."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels import parallel_ce as pce

    gen = torch.Generator(device=dev).manual_seed(79)
    for n, v in CE_SHAPES:
        x = (torch.randn(n, v, generator=gen, device=dev) * 2).to(
            torch.bfloat16)
        lab = torch.randint(0, v, (n,), generator=gen, device=dev)
        lab[::97] = -100
        safe = torch.where(lab == -100, torch.zeros_like(lab), lab)
        got = pce.row_stats(x, safe)
        ref = pce.row_stats_plain(x, safe)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[2], ref[2])):
            fail(f"parallel_ce {[n, v]}: row max or target logit differs")
        se_rel = ((got[1] - ref[1]).abs() / ref[1]).max().item()
        if not se_rel <= 1e-5:
            fail(f"parallel_ce {[n, v]}: sum of exponentials {se_rel} > "
                 f"1e-5 relative")
        loss = pce.c_softmax_with_cross_entropy(x, lab, ignore_index=-100)
        loss_p = pce.c_softmax_with_cross_entropy(x, lab, ignore_index=-100,
                                                  plain=True)
        err = (loss - loss_p).abs().max().item()
        del got, ref, loss, loss_p
        lib = timer(lambda: TF.cross_entropy(x.float(), lab,
                                             reduction="none"))
        _record(results, "parallel_ce", [n, v, "bf16", "ignore 1/97"],
                err, 1e-5, timer(lambda: pce.row_stats(x, safe)),
                timer(lambda: pce.row_stats_plain(x, safe), iters=5), lib,
                ("cross_entropy", f"phase3 [{n}, {v}]"), se_rel_err=se_rel,
                error_metric="max abs loss error")
        del x, lab, safe


def _host_us(torch, fn, calls: int = 100, repeats: int = 5) -> float:
    """Host wall time of one wrapper call in microseconds: the mean of
    ``calls`` calls with no synchronise between them (the checks, the
    tensor maps and the launches; the device runs behind), the median of
    ``repeats`` such means."""
    means = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        means.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return sorted(means)[repeats // 2]


def _kernels_flash(torch, dev, randn, timer, results):
    """Flash attention: causal prefill q [1, L, 32, 128] over k/v with 8
    heads at L = 1024, 1531 (a ragged tail) and 2048, one packed [2, 512]
    batch with segment ids and the log-sum-exp, and the training forwards
    with the log-sum-exp: Llama [TRAIN_BATCH, TRAIN_SEQ, 32, 128] over 8 kv
    heads and GPT-2 small [GPT_BATCH, GPT_SEQ, 12, 64] over 12. The
    yardstick is SDPA (``enable_gqa``; with the segment mask where there
    are segments), timed only. Operations are counted on the bf16 tensor
    cores, for the (query, key) pairs these inputs make visible. Each row
    carries the wrapper's host time a call (``host_us``)."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    for b, s, h, h_kv, d, with_seg, with_lse in (
            (1, 1024, 32, 8, 128, False, False),
            (1, 1531, 32, 8, 128, False, False),
            (1, 2048, 32, 8, 128, False, False),
            (2, 512, 32, 8, 128, True, True),
            (TRAIN_BATCH, TRAIN_SEQ, 32, 8, 128, False, True),
            (GPT_BATCH, GPT_SEQ, 12, 12, 64, False, True)):
        q, k, v = randn(b, s, h, d), randn(b, s, h_kv, d), randn(b, s, h_kv, d)
        seg = None
        if with_seg:
            seg = fa.segment_ids(s, [[100, 300, 301], [256]]).to(dev)
        got = fa.flash_attention(q, k, v, True, seg, with_lse)
        ref = fa.flash_attention_plain(q, k, v, True, seg, with_lse)
        if with_lse:
            torch.cuda.synchronize()
            err_l = (got[1] - ref[1]).abs().max().item()
            tol_l = 1e-4 * (1.0 + ref[1].abs().max().item())
            if not err_l <= tol_l:
                fail(f"flash_attention lse: {err_l} > {tol_l}")
            got, ref = got[0], ref[0]
        err, tol = compare(torch, got, ref)
        del got, ref
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if seg is None:
            lib = timer(lambda: TF.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
        else:
            mask = ((seg[:, :, None] == seg[:, None, :])
                    & torch.ones(s, s, dtype=torch.bool, device=dev).tril()
                    )[:, None]
            lib = timer(lambda: TF.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))
        _record(results, "flash_attention",
                [b, s, h, d, "Hkv", h_kv, "causal"]
                + (["segments"] if with_seg else [])
                + (["lse"] if with_lse else []), err, tol,
                timer(lambda: fa.flash_attention(q, k, v, True, seg,
                                                 with_lse)),
                timer(lambda: fa.flash_attention_plain(q, k, v, True, seg,
                                                       with_lse),
                      iters=5 if b * s > 2048 else 20),
                lib, ("flash_attention", f"phase3 [{b}, {s}, {h}, {d}] causal"
                      + (" segments" if with_seg else "")
                      + (" lse" if with_lse else "")),
                host_us=_host_us(torch, lambda: fa.flash_attention(
                    q, k, v, True, seg, with_lse)))
        del q, k, v


def _kernels_epilogue(torch, randn, timer, results):
    """Block epilogue at ``block_epilogue.FWD_SHAPES``: the decode and
    prefill junctions ([8, 4096], [1024, 4096], rms, no activation), the
    Llama train step's [4096, 4096], one row each at [512, 4096] for gelu,
    swiglu (x [512, 8192]), dropout p = 0.1 and layer norm with a bias, and
    GPT-2 small's [8192, 768] layer norm with a bias. With dropout, the
    dropped positions of kernel and plain version must both be the counter
    hash's, exactly; two calls give the same bits. No single PyTorch call
    computes the same function."""
    from paddle_tpu_torch.ops.kernels import block_epilogue as be

    for rows, hid, act, norm, p, bias_on in be.FWD_SHAPES:
        w = (1.0 + randn(hid).float() * 0.1).to(torch.bfloat16)
        xw = 2 * hid if act == "swiglu" else hid
        x, res = randn(rows, xw), randn(rows, hid)
        b = randn(hid, scale=0.1) if bias_on else None
        args = (x, res, w, b, 1234, p, 1e-5, act, norm)
        got, ref = be.fused_epilogue(*args), be.fused_epilogue_plain(*args)
        again = be.fused_epilogue(*args)
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            fail(f"block_epilogue [{rows}, {hid}] act={act} {norm}: two calls "
                 f"gave different bits")
        err_h, tol_h = compare(torch, got[1], ref[1])
        if not err_h <= tol_h:
            fail(f"block_epilogue residual sum: {err_h} > {tol_h}")
        err, tol = compare(torch, got[0], ref[0])
        if p:
            # with a zero residual and x bounded away from 0 (randn can give
            # an exact 0), h is 0 exactly where an element was dropped
            zero = torch.zeros_like(res)
            x1 = (x.float().abs() + 1.0).to(x.dtype)
            keep = be.keep_mask(rows, hid, 1234, p, x.device)
            for fn in (be.fused_epilogue, be.fused_epilogue_plain):
                h0 = fn(x1, zero, w, b, 1234, p, 1e-5, act, norm)[1]
                bad = int(((h0 == 0) != ~keep).sum())
                if bad:
                    fail(f"block_epilogue dropout: {fn.__name__} dropped "
                         f"other positions than the counter hash at {bad} "
                         f"of {keep.numel()} elements")
        _record(results, "block_epilogue",
                [rows, hid, f"act={act}", norm, f"p={p}",
                 "bias" if bias_on else "no bias"], err, tol,
                timer(lambda: be.fused_epilogue(*args)),
                timer(lambda: be.fused_epilogue_plain(*args)), None,
                ("block_epilogue", f"phase3 [{rows}, {hid}] act={act} {norm} "
                 f"p={p}" + (" bias" if bias_on else "")), same_bits=True,
                plan=list(be.plan(rows, hid, act, 0 < p < 1)[:3]))
        del x, res, b, args, got, ref, again


def _paged(torch, dev, lengths, ps, max_pages, seed):
    """``mmha.paged_tables`` (the analysis examples' tables) on the card:
    (tables, pos, n_pages)."""
    from paddle_tpu_torch.ops.kernels.mmha import paged_tables
    tables, pos, n_pages = paged_tables(lengths, ps, max_pages, seed)
    return tables.to(dev), pos.to(dev), n_pages


def decode_layer_tol(torch, args, ref_y, ref_h, eps=1e-5):
    """(tol_y, tol_h) of the decode layer against its plain version: one
    bf16 ulp of the largest reference value (2**-7 * max|ref|), plus what
    the plain version's one extra rounding, of the attention output to
    bf16, changes on these inputs (the plain version run once more with an
    f32 query, which keeps its attention output in f32 as the kernel
    does)."""
    from paddle_tpu_torch.ops.kernels import decode_layer as dl

    y32, h32 = dl.decode_layer_plain(args[0].float(), *args[1:], eps, eps)
    return tuple(2.0 ** -7 * ref.float().abs().max().item()
                 + (ref.float() - r32.float()).abs().max().item()
                 for ref, r32 in ((ref_y, y32), (ref_h, h32)))


def _kernels_decode_layer(torch, dev, randn, timer, results):
    """The decode layer at Llama-3-8B's width (hidden 4096, I 14336, H 32,
    D 128, page 16): B 8 over Hkv 8 at positions 0..1500 with an inactive
    row 0, B 1, a rep-1 case (Hkv 32), B 16 (the kernel's 16-row wgmma
    width: the weights read once), and every legal block_i at the first
    shape. Times: the kernel, the plain version and the port's
    composite path for the same layer (mmha, o_proj, the block epilogue,
    gate/up, the SwiGLU kernel, down, the block epilogue), which nothing
    on the serving path calls; and the kernel's phases from its device
    clock stamps. Bound: bytes, the weights once plus the visible keys and
    values; operations counted in f32 on the CUDA cores. No single
    PyTorch call computes this function."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels import autotune
    from paddle_tpu_torch.ops.kernels import block_epilogue as be
    from paddle_tpu_torch.ops.kernels import decode_layer as dl
    from paddle_tpu_torch.ops.kernels import mmha, swiglu

    hd, inter, d, ps, eps = 4096, 14336, 128, 16, 1e-5
    wo = randn(hd, 32 * d, scale=0.02)
    wg, wu = randn(inter, hd, scale=0.02), randn(inter, hd, scale=0.02)
    wd = randn(hd, inter, scale=0.02)
    w_post = (1.0 + randn(hd).float() * 0.1).to(torch.bfloat16)
    w_next = (1.0 + randn(hd).float() * 0.1).to(torch.bfloat16)
    full = [0, 18, 256, 257, 701, 1024, 1201, 1501]
    cases = [(full, 8, "B 8"), ([901], 8, "B 1"),
             ([0] + [100 + 190 * r for r in range(1, 8)], 32, "rep 1"),
             (full * 2, 8, "B 16")]
    for lengths, h_kv, label in cases:
        b = len(lengths)
        tables, pos, n_pages = _paged(torch, dev, lengths, ps, 2048 // ps, 7)
        args = (randn(b, 32, d), randn(n_pages, h_kv, ps, d),
                randn(n_pages, h_kv, ps, d), tables, pos, randn(b, hd), wo,
                w_post, wg, wu, wd, w_next)
        got = dl.decode_layer(*args, eps, eps)
        ref = dl.decode_layer_plain(*args, eps, eps)
        tol_y, tol_h = decode_layer_tol(torch, args, *ref, eps=eps)
        if not (torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()):
            fail(f"decode_layer {label}: non-finite output")
        err_h, _ = compare(torch, got[1], ref[1])
        if not err_h <= tol_h:
            fail(f"decode_layer {label} residual: {err_h} > {tol_h}")
        err, _ = compare(torch, got[0], ref[0])
        again = dl.decode_layer(*args, eps, eps)
        if not (torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])):
            fail(f"decode_layer {label}: two calls on the same inputs differ")
        if label == "B 8":
            for block_i in autotune._block_i_candidates(inter):
                yb, hb = dl.decode_layer(*args, eps, eps, block_i=block_i)
                e_y, _ = compare(torch, yb, ref[0])
                e_h, _ = compare(torch, hb, ref[1])
                emit({"kernel": "decode_layer", "block_i": block_i,
                      "max_abs_err": e_y, "tol": tol_y,
                      "max_abs_err_h": e_h, "tol_h": tol_h})
                if not (e_y <= tol_y and e_h <= tol_h):
                    fail(f"decode_layer block_i={block_i}: errors {e_y} / "
                         f"{e_h} > {tol_y} / {tol_h}")

        q, kl, vl = args[:3]
        hres = args[5]

        def composite():
            o = mmha.mmha_decode(q[:, None], kl, vl, tables, pos)
            y1, h1 = be.decode_epilogue(TF.linear(o.reshape(b, -1), wo), hres,
                                        w_post, eps)
            z = swiglu.swiglu(TF.linear(y1, wg), TF.linear(y1, wu))
            return be.decode_epilogue(TF.linear(z, wd), h1, w_next, eps)

        stamps = torch.zeros(6, dtype=torch.int64, device=dev)
        timer.flush.zero_()
        dl.decode_layer(*args, eps, eps, stamps=stamps)
        torch.cuda.synchronize()
        phases = {n: (stamps[i + 1] - stamps[i]).item() / 1e6
                  for i, n in enumerate(dl.PHASES)}
        _record(results, "decode_layer",
                [b, 32, d, "Hkv", h_kv, "ps", ps, "hidden", hd, "I", inter,
                 "pos", pos.tolist(), label, "block_i",
                 dl._pick_block_i(inter)], err, tol_y,
                timer(lambda: dl.decode_layer(*args, eps, eps)),
                timer(lambda: dl.decode_layer_plain(*args, eps, eps)), None,
                ("decode_layer", f"phase3 {label}"),
                composite_ms=timer(composite),
                max_abs_err_h=err_h, tol_h=tol_h, phase_ms=phases)


def _kernels_wo(torch, dev, randn, timer, results):
    """The weight-only kernels at Llama-3-8B's projection shapes: decode
    x [8, 4096] @ [4096, 14336] (gate/up) and [8, 14336] @ [14336, 4096]
    (down), prefill [1024, 4096] @ [4096, 14336] and a ragged
    [1531, 4096] @ [4096, 1024] (k_proj); grouped scales at G 128. The
    yardstick is cuBLAS bf16 ``torch.matmul`` on the dequantized bf16
    weight, which the port never calls. Bound: the weight, scales,
    activations and output once over the memory rate, or the products
    over the bf16 tensor-core rate. The rows at gate/up's decode and
    prefill shapes carry the wrapper's host time a call (``host_us``).
    Also times the per-call unpacking of one layer's int4 weights that a
    grouped int4 engine pays (the JAX package's rule: grouped int4 unpacks
    to dense int8 on every call)."""
    from paddle_tpu_torch.ops.kernels import wo_matmul as wo

    gen = torch.Generator(device=dev).manual_seed(4321)
    bf = torch.bfloat16

    def int8(*shape, lo=-127):
        return torch.randint(lo, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def scales(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 2e-3 + 1e-4

    shapes = ((8, 4096, 14336, "decode gate/up"),
              (8, 14336, 4096, "decode down"),
              (1024, 4096, 14336, "prefill gate/up"),
              (1531, 4096, 1024, "prefill k_proj, ragged"))
    for name in ("wo_int8", "wo_int8_grouped", "wo_int4"):
        for m, k, n, label in shapes:
            x = randn(m, k)
            if name == "wo_int4":
                w, s = int8(k, n // 2, lo=-128), scales(n)
                fn, plain = wo.wo_int4, wo.wo_int4_matmul_plain
                wd = (wo.unpack_int4_halves(w).float() * s).to(bf)
            elif name == "wo_int8_grouped":
                w, s = int8(k, n), scales(k // QUANT_GROUP, n)
                fn, plain = wo.wo_int8_grouped, wo.wo_int8_matmul_plain
                wd = wo.dequant_grouped(w, s).to(bf)
            else:
                w, s = int8(k, n), scales(n)
                fn, plain = wo.wo_int8, wo.wo_int8_matmul_plain
                wd = (w.float() * s).to(bf)
            err, tol = compare(torch, fn(x, w, s), plain(x, w, s))
            host = {}
            if (m, k) in ((8, 4096), (1024, 4096)):
                host["host_us"] = _host_us(torch, lambda: fn(x, w, s))
            _record(results, name,
                    [m, k, n, label] + (["G", QUANT_GROUP]
                                        if name == "wo_int8_grouped" else []),
                    err, tol, timer(lambda: fn(x, w, s)),
                    timer(lambda: plain(x, w, s)), timer(lambda: x @ wd),
                    ("wo_matmul", f"phase3 {name} [{m}, {k}, {n}]"),
                    library="cuBLAS bf16 torch.matmul, dequantized weight",
                    **host)
    layer = ((4096, 4096), (4096, 1024), (4096, 1024), (4096, 4096),
             (4096, 14336), (4096, 14336), (14336, 4096))
    packed = [int8(k, n // 2, lo=-128) for k, n in layer]
    ms = timer(lambda: [wo.unpack_int4_halves(p) for p in packed])
    emit({"kernel": "wo_int4 grouped: unpack_int4_halves of one layer's "
          "seven weights (plain torch ops)", "ms_per_layer": ms,
          "ms_per_decode_step_32_layers": 32 * ms,
          "bytes_per_layer": sum(p.numel() for p in packed) * 3})


def _kernels_a8w8(torch, dev, randn, timer, results):
    """A8W8 at [1024, 4096] @ nk [14336, 4096], the llm_int8 prefill
    shape: bit-identical to the plain version in both layouts on x =
    q * 2**-5 with |q| = 127 pinned in every row (s = 2**-5 exactly, so
    x / s is exact), and within one bf16 ulp of the largest value on
    random activations (where q can differ only at a rounding tie). The
    yardstick is ``torch._int_mm`` on the quantized activations, the int8
    contraction alone. Bound: operations at the int8 tensor-core rate.
    A second row times the same product with a "kn" weight (through its
    K-major copy). Each row carries ``split_ms``: the device ms of each of
    the call's kernels (the quantisation apart from the product) over 10
    warm calls under the profiler."""
    from paddle_tpu_torch.ops.kernels import a8w8_matmul as a8

    gen = torch.Generator(device=dev).manual_seed(8888)
    m, k, n = 1024, 4096, 14336
    w = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                      dtype=torch.int8)
    ws = torch.rand(n, generator=gen, device=dev) * 2e-3 + 1e-4
    q = torch.randint(-127, 128, (m, k), generator=gen, device=dev).float()
    q[:, 0] = 127.0
    xp = (q * 2.0 ** -5).to(torch.bfloat16)
    for layout, wl in (("nk", w), ("kn", w.t().contiguous())):
        got = a8.a8w8_matmul(xp, wl, ws, layout)
        ref = a8.a8w8_matmul_plain(xp, wl, ws, layout)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"a8w8 ({layout}): not bit-identical on the pinned "
                 f"construction, {int((got != ref).sum())} elements differ, "
                 f"max {(got.float() - ref.float()).abs().max().item()}")
    x = randn(m, k)
    xq = a8.row_quantize(x)[0].to(torch.int8)
    wt = w.t()                        # [K, N], column-major: _int_mm's layout
    try:
        torch._int_mm(xq, wt)
        lib, lib_note = timer(lambda: torch._int_mm(xq, wt)), \
            "torch._int_mm, the int8 contraction alone"
    except RuntimeError as e:         # a yardstick only: the port never calls it
        lib, lib_note = None, f"torch._int_mm unavailable: {e}"[:200]
    for layout, wl, sheet in (
            ("nk", w, f"phase3 [{m}, {k}] @ nk [{n}, {k}]"),
            ("kn", w.t().contiguous(), f"phase3 [{m}, {k}] @ kn [{k}, {n}]")):
        err, tol = compare(torch, a8.a8w8_matmul(x, wl, ws, layout),
                           a8.a8w8_matmul_plain(x, wl, ws, layout))
        split = _profile(torch, lambda: a8.a8w8_matmul(x, wl, ws, layout),
                         reps=10).get("port_ms_per_call")
        _record(results, "a8w8",
                [m, k, n, layout, "bit-identical on pinned x"], err, tol,
                timer(lambda: a8.a8w8_matmul(x, wl, ws, layout)),
                timer(lambda: a8.a8w8_matmul_plain(x, wl, ws, layout)), lib,
                ("a8w8_matmul", sheet), library=lib_note, split_ms=split)
        del wl


_CHUNKED_PATH = ("mmha", "rms_norm", "rope", "swiglu")


def _serve(torch, np, engine, prompts, new_tokens=SERVE_NEW_TOKENS,
           after_warmup=None):
    """Serve ``prompts`` (greedy, ``new_tokens`` each) after a warm-up,
    with every kernel's launch count set to 0 just before and read just
    after (``after_warmup()`` runs once the warm-up is done). Returns
    (requests, outputs, wall seconds, launches, stats)."""
    from paddle_tpu_torch.ops.kernels import WRAPPERS

    engine.generate(list(range(1, 17)), max_new_tokens=2, timeout=600)
    for times in (engine.prefill_ms, engine.chunk_ms, engine.step_ms,
                  engine.verify_ms):
        times.clear()
    if after_warmup is not None:
        after_warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new_tokens=new_tokens, temperature=0.0)
            for p in prompts]
    outs = [r.result(timeout=900) for r in reqs]
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    stats = engine.stats()
    summary = engine.shutdown()
    vocab = engine._sm.cfg.vocab_size
    for i, toks in enumerate(outs):
        if len(toks) != new_tokens or \
                not all(0 <= t < vocab for t in toks):
            fail(f"request {i}: {len(toks)} tokens, want {new_tokens} "
                 f"in-vocab")
    if summary["pages_leaked"] or engine.pool.leaked() or engine.pool.lost():
        fail(f"pages leaked or lost: {summary}, lost {engine.pool.lost()}")
    return reqs, outs, wall, launches, stats


def _serve_row(torch, np, engine, reqs, wall, launches, stats):
    gen_tokens = sum(len(r.tokens) for r in reqs)
    mean = lambda xs: float(np.mean(xs)) if xs else None  # noqa: E731
    return {"requests": len(reqs),
            "prompt_lens": [len(r.prompt) for r in reqs],
            "generated_tokens": gen_tokens, "wall_s": wall,
            "tokens_per_s": gen_tokens / wall,
            "prefills": len(engine.prefill_ms),
            "prefill_ms_mean": mean(engine.prefill_ms),
            "prefill_chunks": len(engine.chunk_ms),
            "prefill_chunk_ms_mean": mean(engine.chunk_ms),
            "decode_steps": len(engine.step_ms),
            "decode_step_ms_mean": mean(engine.step_ms),
            "ttft_ms_mean": mean([r.ttft_ms for r in reqs]),
            "e2e_ms_mean": mean([r.e2e_ms for r in reqs]),
            "evictions": stats["evictions"], "pages": stats["pages"],
            "launches": launches,
            "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_serve_chunked(torch, np, dev):
    """Engine a: chunked prefill on the per-op path, no prefix cache
    (the first slice's configuration), prompts of 256-1536 random tokens."""
    from paddle_tpu_torch.models import llama3_8b
    from paddle_tpu_torch.serving import LLMEngine, ServingConfig

    t0 = time.perf_counter()
    model = llama3_8b(device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = model.cfg
    engine = LLMEngine(model, ServingConfig(
        max_batch=8, page_size=16, max_seq_len=2048, num_pages=1025,
        prefill_chunk=512, fused_block=False, prefix_cache=False,
        dtype="bfloat16"))
    rng = np.random.default_rng(0)
    lengths = rng.integers(PROMPT_MIN, PROMPT_MAX + 1, size=SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in lengths]
    reqs, outs, wall, launches, stats = _serve(torch, np, engine, prompts)
    idle = [n for n in _CHUNKED_PATH if launches[n] == 0]
    if idle:
        fail(f"kernels never launched on the chunked serving path: {idle}")
    emit({"phase": "serve", "engine": "chunked_per_op", "model": "llama3_8b",
          "layers": cfg.num_layers, "hidden": cfg.hidden_size,
          "params": sum(p.numel() for p in model.parameters()),
          "init_s": init_s,
          **_serve_row(torch, np, engine, reqs, wall, launches, stats)})
    return model, engine, prompts, outs


def default_prompts(np, vocab):
    """A shared system prompt of SYSTEM_PROMPT tokens plus a seeded unique
    suffix of SUFFIX_MIN..SUFFIX_MAX tokens per request; request 1's
    suffix is a whole number of pages and request 2 repeats request 1's
    prompt exactly."""
    rng = np.random.default_rng(1)
    system = rng.integers(0, vocab, size=SYSTEM_PROMPT).tolist()
    lengths = rng.integers(SUFFIX_MIN, SUFFIX_MAX + 1, size=SERVE_REQUESTS)
    lengths[1] -= lengths[1] % 16
    prompts = [system + rng.integers(0, vocab, size=int(n)).tolist()
               for n in lengths]
    prompts[2] = list(prompts[1])
    return prompts


def phase_serve_default(torch, np, model):
    """Engine b: the default ServingConfig() (monolithic prefill, fused
    blocks, prefix cache) over the same model."""
    from paddle_tpu_torch.serving import LLMEngine, ServingConfig

    engine = LLMEngine(model, ServingConfig(
        max_batch=8, page_size=16, max_seq_len=2048, num_pages=1025,
        dtype="bfloat16"))
    cfg = engine.config
    if not (cfg.prefill_chunk is None and cfg.fused_block
            and cfg.prefix_cache):
        fail(f"ServingConfig() is not the default path: {cfg}")
    prompts = default_prompts(np, model.cfg.vocab_size)
    reqs, outs, wall, launches, stats = _serve(torch, np, engine, prompts)
    idle = [n for n, c in launches.items()
            if c == 0 and n not in ("decode_layer",) + QUANT_KERNELS
            + TRAIN_KERNELS + PACKED_KERNELS + LAMB_KERNELS + MOE_KERNELS
            + INCUBATE_KERNELS]
    if idle:
        fail(f"kernels never launched on the default serving path: {idle}")
    pages, px = _check_prefix_claims(engine, reqs, stats)
    emit({"phase": "serve", "engine": "default", "model": "llama3_8b",
          "config": {"prefill_chunk": cfg.prefill_chunk,
                     "fused_block": cfg.fused_block,
                     "prefix_cache": cfg.prefix_cache},
          "claimed_pages": pages, "prefix_cache": px,
          "prefix_cache_entries": engine.prefix_cache.stats(),
          **_serve_row(torch, np, engine, reqs, wall, launches, stats)})
    return engine, prompts, outs, launches


def _check_prefix_claims(engine, reqs, stats):
    """Every request after the first claims the system prompt's pages and
    the repeated prompt copies a shared page. Returns (claimed pages per
    request, prefix-cache stats)."""
    pages = [r._cached_tokens // engine.pool.page_size for r in reqs]
    short = [i for i, n in enumerate(pages[1:], 1)
             if n < SYSTEM_PROMPT // engine.pool.page_size]
    if short:
        fail(f"requests {short} claimed fewer than the system prompt's "
             f"pages: {pages}")
    px = stats["prefix_cache"]
    if px["cow_copies"] < 1:
        fail(f"the repeated prompt did not copy a shared page: {px}")
    return pages, px


def _fused_layer_config(ServingConfig):
    return ServingConfig(max_batch=8, page_size=16, max_seq_len=2048,
                         num_pages=1025, dtype="bfloat16",
                         fused_decode_layer=True)


def phase_tune(torch, model):
    """Engine c's construction tunes the decode layer's block_i at its
    decode shape into a temporary cache file; a second construction must
    load it with no trial. Returns the second engine."""
    import tempfile

    from paddle_tpu_torch.ops.kernels import autotune
    from paddle_tpu_torch.serving import LLMEngine, ServingConfig

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    os.environ["PADDLE_TPU_TUNE_CACHE"] = os.path.join(tmp, "tuning.json")
    os.environ.pop("PADDLE_TPU_TUNE", None)
    cache = autotune.default_cache()
    t0 = time.perf_counter()
    first = LLMEngine(model, _fused_layer_config(ServingConfig))
    tune_s = time.perf_counter() - t0
    first.shutdown()
    entry = first.tuning
    if entry is None or cache.misses != 1 or cache.hits != 0:
        fail(f"engine c's construction did not measure block_i: {entry}, "
             f"{cache.stats()}")
    measured = cache.measure_seconds
    t0 = time.perf_counter()
    engine = LLMEngine(model, _fused_layer_config(ServingConfig))
    again_s = time.perf_counter() - t0
    if cache.hits != 1 or cache.misses != 1 or \
            cache.measure_seconds != measured or engine.tuning != entry:
        fail(f"engine c's second construction measured again: "
             f"{cache.stats()}")
    emit({"phase": "tune", "kernel": entry["kernel"],
          "block_i": entry["block_i"], "ms": entry["ms"],
          "timings_ms": entry["timings_ms"], "shapes": entry["shapes"],
          "construct_s": tune_s, "construct_again_s": again_s,
          "cache": cache.stats()})
    for name in os.listdir(tmp):
        os.unlink(os.path.join(tmp, name))
    os.rmdir(tmp)
    return engine


def phase_serve_fused_layer(torch, np, model, engine, prompts):
    """Engine c: ``fused_decode_layer=True`` over engine b's traffic."""
    reqs, outs, wall, launches, stats = _serve(torch, np, engine, prompts)
    steps = len(engine.step_ms)
    layers = model.cfg.num_layers
    if launches["decode_layer"] != layers * steps or steps == 0:
        fail(f"decode_layer launched {launches['decode_layer']} times in "
             f"{steps} decode steps, want {layers} per step")
    if launches["mmha"]:
        fail(f"mmha launched {launches['mmha']} times: a decode step "
             f"bypassed the decode layer")
    pages, px = _check_prefix_claims(engine, reqs, stats)
    emit({"phase": "serve", "engine": "fused_decode_layer",
          "model": "llama3_8b", "block_i": engine.tuning["block_i"],
          "claimed_pages": pages, "prefix_cache": px,
          **_serve_row(torch, np, engine, reqs, wall, launches, stats)})
    return outs, launches


def _quant_config(ServingConfig, **kw):
    return ServingConfig(max_batch=8, page_size=16, max_seq_len=2048,
                         num_pages=1025, dtype="bfloat16", **kw)


def phase_serve_quant(torch, np, model, prompts, label, quant):
    """Engines d and e: ``quant`` on engine b's configuration and traffic.
    Every monolithic prefill (a prefix hit's suffix included) and every
    decode step runs each of the 7 projections of each layer through the
    quant's kernel once; the other quantized kernels never launch."""
    from paddle_tpu_torch.serving import LLMEngine, ServingConfig

    kernel = {"weight_only_int8": "wo_int8", "weight_only_int4": "wo_int4"}[
        quant]
    t0 = time.perf_counter()
    engine = LLMEngine(model, _quant_config(ServingConfig, quant=quant))
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    reqs, outs, wall, launches, stats = _serve(torch, np, engine, prompts)
    forwards = len(engine.prefill_ms) + len(engine.step_ms)
    want = 7 * model.cfg.num_layers * forwards
    if launches[kernel] != want or forwards == 0:
        fail(f"{label}: {kernel} launched {launches[kernel]} times in "
             f"{forwards} forwards, want {want} (7 per layer)")
    stray = [n for n in QUANT_KERNELS if n != kernel and launches[n]]
    idle = [n for n in ("mmha", "rms_norm", "rope", "swiglu",
                        "flash_attention", "block_epilogue")
            if launches[n] == 0]
    if stray or idle:
        fail(f"{label}: launched {stray}, never launched {idle}")
    pages, px = _check_prefix_claims(engine, reqs, stats)
    emit({"phase": "serve", "engine": label, "model": "llama3_8b",
          "quant": quant, "construct_s": construct_s,
          "quantized_bytes": _quant_bytes(engine._sm),
          "claimed_pages": pages, "prefix_cache": px,
          **_serve_row(torch, np, engine, reqs, wall, launches, stats)})
    return engine, outs, launches


def _quant_bytes(sm):
    return sum(t.numel() * t.element_size()
               for pair in sm._qweights.values() for t in pair)


def phase_serve_quant_fused_layer(torch, np, model, prompts):
    """Engine f: grouped int8 (G 128) with ``fused_decode_layer=True``.
    Its construction quantizes, dequantizes o/gate/up/down once for the
    decode-layer kernel and tunes block_i into a temporary cache file.
    Every decode step launches the decode layer once per layer and mmha
    never; the grouped kernel runs the 7 projections of every prefill and
    q/k/v of every decode step."""
    import tempfile

    from paddle_tpu_torch.serving import LLMEngine, ServingConfig

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    os.environ["PADDLE_TPU_TUNE_CACHE"] = os.path.join(tmp, "tuning.json")
    try:
        t0 = time.perf_counter()
        engine = LLMEngine(model, _quant_config(
            ServingConfig, quant="weight_only_int8",
            quant_group_size=QUANT_GROUP, fused_decode_layer=True))
        torch.cuda.synchronize()
        construct_s = time.perf_counter() - t0
    finally:
        for name in os.listdir(tmp):
            os.unlink(os.path.join(tmp, name))
        os.rmdir(tmp)
    if engine.tuning is None or engine.tuning.get("quant") != "int8":
        fail(f"engine f did not tune block_i for its quant: {engine.tuning}")
    reqs, outs, wall, launches, stats = _serve(torch, np, engine, prompts,
                                               FUSED_QUANT_TOKENS)
    steps, prefills = len(engine.step_ms), len(engine.prefill_ms)
    layers = model.cfg.num_layers
    want = {"decode_layer": layers * steps, "mmha": 0,
            "wo_int8_grouped": layers * (7 * prefills + 3 * steps),
            "wo_int8": 0, "wo_int4": 0}
    got = {n: launches[n] for n in want}
    if got != want or steps == 0:
        fail(f"engine f: launches {got} in {steps} decode steps and "
             f"{prefills} prefills, want {want}")
    pages, px = _check_prefix_claims(engine, reqs, stats)
    emit({"phase": "serve", "engine": "int8_g128_fused_decode_layer",
          "model": "llama3_8b", "quant": "weight_only_int8",
          "quant_group_size": QUANT_GROUP, "construct_s": construct_s,
          "block_i": engine.tuning["block_i"],
          "quantized_bytes": _quant_bytes(engine._sm),
          "dequantized_bytes": sum(t.numel() * t.element_size()
                                   for t in engine._sm._dq_weights.values()),
          "claimed_pages": pages, "prefix_cache": px,
          **_serve_row(torch, np, engine, reqs, wall, launches, stats)})
    return engine, outs, launches


def _free(torch):
    """Release what the engine just dropped (its quantized copies) before
    the next one is built."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _first_decode_logits(torch, sm, engine, prompt):
    """Prefill ``prompt`` into fresh pages through the kernels, then run
    its first decode step twice on the same pool state: through the
    kernels and through the plain versions. Returns (first token,
    kernel logits, plain logits), f32 ``[vocab]``."""
    pool = engine.pool
    dev = engine.device
    n = len(prompt)
    pages = pool.alloc(pool.pages_for(n + 1))
    try:
        row = torch.zeros(engine.scheduler.max_pages, dtype=torch.int32)
        row[:len(pages)] = torch.tensor(pages, dtype=torch.int32)
        row = row.to(dev)
        chunk = engine.config.prefill_chunk
        toks = torch.tensor([prompt], device=dev)
        for s in range(0, n, chunk):
            c = min(chunk, n - s)
            logits = sm.prefill_chunk_forward(toks[:, s:s + c], s, c, row)
        first = int(logits.float().argmax(-1)[0])
        args = (torch.tensor([first], device=dev),
                torch.tensor([n], dtype=torch.int32, device=dev), row[None])
        lk = sm.decode_forward(*args)[0].float()
        lp = sm.decode_forward(*args, plain=True)[0].float()
        torch.cuda.synchronize()
    finally:
        pool.free(pages)
    return first, lk, lp


def _parity_row(torch, i, position, lk, lp):
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        fail(f"parity: request {i}: non-finite logits")
    top2 = lp.topk(2).values
    return {"request": i, "position": position,
            "max_abs_err": (lk - lp).abs().max().item(),
            "tol": PARITY_REL_TOL * lp.abs().max().item(),
            "argmax_kernel": int(lk.argmax()), "argmax_plain": int(lp.argmax()),
            "plain_top2_gap": (top2[0] - top2[1]).item()}


def _check_parity(what, rows):
    """Logits within ``tol`` (5% of the largest plain logit) everywhere;
    argmax equal on every row whose plain top-2 gap exceeds ``tol``. Below
    that gap the two bf16 paths may rank the top two either way: they
    differ by a few bf16 ulps after 32 layers, and random weights leave
    top-2 gaps of one ulp (the first run of this check met a 0.031 gap at
    a 0.195 difference)."""
    decisive = [r for r in rows if r["plain_top2_gap"] > r["tol"]]
    emit({"phase": "parity", "what": what, "requests": len(rows),
          "decisive": len(decisive),
          "argmax_agree": sum(r["argmax_kernel"] == r["argmax_plain"]
                              for r in rows),
          "max_abs_err": max(r["max_abs_err"] for r in rows),
          "tol_min": min(r["tol"] for r in rows), "rows": rows})
    for r in rows:
        if not r["max_abs_err"] <= r["tol"]:
            fail(f"parity ({what}): request {r['request']}: logits differ "
                 f"by {r['max_abs_err']} > {r['tol']}")
    for r in decisive:
        if r["argmax_kernel"] != r["argmax_plain"]:
            fail(f"parity ({what}): request {r['request']}: argmax "
                 f"{r['argmax_kernel']} (kernels) != {r['argmax_plain']} "
                 f"(plain) at a top-2 gap of {r['plain_top2_gap']}")
    if not decisive:
        fail(f"parity ({what}): no request had a top-2 gap above the "
             f"tolerance")


def phase_parity(torch, model, engine, prompts, served):
    """Engine a: the first decode step of every served request at full
    width, kernel path vs plain versions, after a chunked prefill."""
    from paddle_tpu_torch.serving import ServingModel

    sm = ServingModel(model, fused_block=False).bind_pool(engine.pool)
    rows = []
    for i, prompt in enumerate(prompts):
        first, lk, lp = _first_decode_logits(torch, sm, engine, prompt)
        row = _parity_row(torch, i, len(prompt), lk, lp)
        row["first_token_is_served"] = first == served[i][0]
        row["kernel_argmax_is_served"] = int(lk.argmax()) == served[i][1]
        rows.append(row)
    _check_parity("chunked prefill, per-op first decode step", rows)


def phase_parity_default(torch, model, engine, prompts, served):
    """Engine b: for every request, its monolithic-prefill logits and its
    first fused decode step, kernel path vs plain versions. The prefill
    runs into fresh pages through the kernels (its KV then serves both
    decode runs), and once more into the same pages through the plain
    versions for its logits; the pages are rewritten by the kernel path
    before the decode step."""
    from paddle_tpu_torch.serving import ServingModel

    sm = ServingModel(model).bind_pool(engine.pool)
    pool, dev = engine.pool, engine.device
    prefill_rows, decode_rows = [], []
    for i, prompt in enumerate(prompts):
        n = len(prompt)
        pages = pool.alloc(pool.pages_for(n + 1))
        try:
            row = torch.zeros(engine.scheduler.max_pages, dtype=torch.int32)
            row[:len(pages)] = torch.tensor(pages, dtype=torch.int32)
            row = row.to(dev)
            toks = torch.tensor([prompt], device=dev)
            pp = sm.prefill_forward(toks, n, row, plain=True)[0].float()
            pk = sm.prefill_forward(toks, n, row)[0].float()
            first = int(pk.argmax())
            args = (torch.tensor([first], device=dev),
                    torch.tensor([n], dtype=torch.int32, device=dev),
                    row[None])
            lk = sm.decode_forward(*args)[0].float()
            lp = sm.decode_forward(*args, plain=True)[0].float()
            torch.cuda.synchronize()
        finally:
            pool.free(pages)
        r = _parity_row(torch, i, n - 1, pk, pp)
        r["kernel_argmax_is_served"] = first == served[i][0]
        prefill_rows.append(r)
        r = _parity_row(torch, i, n, lk, lp)
        r["kernel_argmax_is_served"] = int(lk.argmax()) == served[i][1]
        decode_rows.append(r)
    _check_parity("monolithic prefill, fused", prefill_rows)
    _check_parity("first fused decode step", decode_rows)


def phase_parity_fused_layer(torch, model, engine, prompts, served):
    """Engine c: for every request, its first fused-layer decode step,
    kernel path vs plain versions, after a monolithic prefill through the
    kernels into fresh pages."""
    from paddle_tpu_torch.serving import ServingModel

    sm = ServingModel(model, fused_decode_layer=True).bind_pool(engine.pool)
    _parity_first_decode(torch, "first fused-layer decode step", sm, engine,
                         prompts, served)


def _parity_first_decode(torch, what, sm, engine, prompts, served):
    """For every request, its first decode step through ``sm``, kernel
    path vs plain versions, after a monolithic prefill through the kernels
    into fresh pages of ``engine``'s pool."""
    pool, dev = engine.pool, engine.device
    rows = []
    for i, prompt in enumerate(prompts):
        n = len(prompt)
        pages = pool.alloc(pool.pages_for(n + 1))
        try:
            row = torch.zeros(engine.scheduler.max_pages, dtype=torch.int32)
            row[:len(pages)] = torch.tensor(pages, dtype=torch.int32)
            row = row.to(dev)
            toks = torch.tensor([prompt], device=dev)
            first = int(sm.prefill_forward(toks, n, row)[0].float().argmax())
            args = (torch.tensor([first], device=dev),
                    torch.tensor([n], dtype=torch.int32, device=dev),
                    row[None])
            lk = sm.decode_forward(*args)[0].float()
            lp = sm.decode_forward(*args, plain=True)[0].float()
            torch.cuda.synchronize()
        finally:
            pool.free(pages)
        r = _parity_row(torch, i, n, lk, lp)
        r["first_token_is_served"] = first == served[i][0]
        r["kernel_argmax_is_served"] = int(lk.argmax()) == served[i][1]
        rows.append(r)
    _check_parity(what, rows)


def _next_logits(torch, sm, engine, ctx):
    """f32 logits ``[vocab]`` of the token after ``ctx``: a monolithic
    prefill through ``sm``'s kernels into fresh pages of ``engine``'s pool
    (the pages are freed again)."""
    pool, dev = engine.pool, engine.device
    pages = pool.alloc(pool.pages_for(len(ctx)))
    try:
        row = torch.zeros(engine.scheduler.max_pages, dtype=torch.int32)
        row[:len(pages)] = torch.tensor(pages, dtype=torch.int32)
        toks = torch.tensor([ctx], device=dev)
        out = sm.prefill_forward(toks, len(ctx), row.to(dev))[0].float()
        torch.cuda.synchronize()
    finally:
        pool.free(pages)
    return out


def _agreement(torch, what, got, want, logits_at):
    """Generated streams held token for token against reference streams.
    At a row's first divergence (token ``j``) ``logits_at(row, j)`` gives
    the reference's logits there: the rule of :func:`_check_parity`
    allows the divergence only where their top-2 gap is within
    ``PARITY_REL_TOL`` of the largest logit (two bf16 paths may rank a
    near-tie either way). Returns one row a stream."""
    rows = []
    for i, (g, w) in enumerate(zip(got, want)):
        j = next((t for t, (a, b) in enumerate(zip(g, w)) if a != b), None)
        row = {"request": i, "first_divergence": j}
        if j is None:
            if len(g) != len(w):
                fail(f"{what}: request {i}: {len(g)} tokens, want {len(w)}")
        else:
            lg = logits_at(i, j)
            if not torch.isfinite(lg).all():
                fail(f"{what}: request {i}: non-finite reference logits")
            top2 = lg.topk(2).values
            row.update(got=g[j], want=w[j],
                       top2_gap=(top2[0] - top2[1]).item(),
                       tol=PARITY_REL_TOL * lg.abs().max().item())
            if not row["top2_gap"] <= row["tol"]:
                fail(f"{what}: request {i} diverges at token {j} ({g[j]} "
                     f"!= {w[j]}) where the reference's top-2 gap "
                     f"{row['top2_gap']} exceeds {row['tol']}")
        rows.append(row)
    return rows


class _ReplayDrafter:
    """Proposes engine b's own continuation of each request. It has no
    ``window``, so the scheduler hands it the whole context, whose prompt
    names the request (looked up by its length and last 16 tokens).
    ``shift=1`` proposes each of those tokens plus one, modulo the
    vocabulary: never the argmax while the outputs agree."""

    def __init__(self, prompts, outs, vocab, shift=0):
        self.by_len: dict = {}
        for p, o in zip(prompts, outs):
            self.by_len.setdefault(len(p), {})[tuple(p[-16:])] = o
        self.vocab, self.shift = vocab, shift

    def propose(self, history, k):
        for n, by_tail in self.by_len.items():
            out = by_tail.get(tuple(history[n - 16:n])) \
                if len(history) >= n else None
            if out is not None:
                done = len(history) - n
                return [(t + self.shift) % self.vocab
                        for t in out[done:done + k]]
        return []


def _spec_config(ServingConfig, **kw):
    return ServingConfig(**{**dict(max_batch=8, page_size=16,
                                   max_seq_len=2048, num_pages=1025,
                                   dtype="bfloat16", spec_k=SPEC_K), **kw})


def _serve_spec(torch, np, model, prompts, drafter=None, **kw):
    """One engine of b's configuration with ``spec_k=4`` (``kw`` overrides,
    ``drafter`` replaces the n-gram drafter) serving ``prompts``: the
    scheduler's ``_propose`` timed a step, its speculative counters zeroed
    after the warm-up. Returns (the engine's row, outputs, launches); the
    engine is shut down and freed."""
    from paddle_tpu_torch.serving import LLMEngine, ServingConfig

    engine = LLMEngine(model, _spec_config(ServingConfig, **kw))
    sched = engine.scheduler
    if drafter is not None:
        sched.drafter = drafter
    spent: list = []
    propose = sched._propose

    def timed(active):
        t0 = time.perf_counter()
        out = propose(active)
        spent.append((time.perf_counter() - t0) * 1e3)
        return out

    def reset():
        spent.clear()
        for name in ("spec_steps", "spec_proposed", "spec_accepted",
                     "spec_rejected", "step_tokens", "step_rows"):
            setattr(sched, name, 0)

    sched._propose = timed
    reqs, outs, wall, launches, stats = _serve(torch, np, engine, prompts,
                                               after_warmup=reset)
    cfg = engine.config
    verifies = len(engine.verify_ms)
    row = {"spec_k": cfg.spec_k, "adaptive": cfg.spec_adaptive,
           "drafter": type(sched.drafter).__name__ if cfg.spec_k else None,
           "verify_steps": verifies,
           "verify_step_ms_mean": float(np.mean(engine.verify_ms))
           if verifies else None,
           "speculative": stats["speculative"],
           "tokens_per_step": stats["tokens_per_step"],
           "drafter_ms_per_step": float(np.mean(spent)) if spent else None,
           "drafter_ms_total": float(np.sum(spent)),
           **_serve_row(torch, np, engine, reqs, wall, launches, stats)}
    del engine, sched
    _free(torch)
    return row, outs, launches


def phase_serve_spec(torch, np, model, b_engine, prompts, served):
    """Engines g, h and i: engine b's configuration with ``spec_k=4`` on
    its traffic, over the same model. g drafts with the n-gram drafter
    (adaptive K); h with a drafter that replays engine b's own output (the
    most speculation can give at K 4); i, on b's first four requests, with
    one that proposes b's next tokens plus one (never accepted while the
    outputs agree) at a pinned K: the verify's pure cost and the rollback
    path. Engine b's configuration (``spec_k=0``) serves b's traffic again
    before g and after i: the host's speed moves between phases, so each
    engine's tokens/s stands beside these controls of the same phase.
    Each serves every request's tokens as engine b did, but for a
    divergence at a near-tie of b's logits (:func:`_agreement`), launches
    mmha once a layer in every decode and verify step (a speculating
    engine at least one verify step), and leaks no page; h accepts drafts
    and emits more than one token a step. The drafter's host time is the
    scheduler's ``_propose`` a step."""
    from paddle_tpu_torch.serving import ServingModel

    sm = ServingModel(model).bind_pool(b_engine.pool)
    vocab, layers = model.cfg.vocab_size, model.cfg.num_layers
    n_adv = SPEC_ADVERSARIAL_REQUESTS
    control = ("b", "spec_off_control", None, len(prompts), {"spec_k": 0})
    runs = (control,
            ("g", "spec_ngram", None, len(prompts), {}),
            ("h", "spec_replay", _ReplayDrafter(prompts, served, vocab),
             len(prompts), {}),
            ("i", "spec_adversarial",
             _ReplayDrafter(prompts[:n_adv], served[:n_adv], vocab, 1),
             n_adv, {"spec_adaptive": False}),
            control)
    for tag, label, drafter, n_req, kw in runs:
        row, outs, launches = _serve_spec(torch, np, model,
                                          prompts[:n_req], drafter, **kw)
        steps, verifies = row["decode_steps"], row["verify_steps"]
        if launches["mmha"] != layers * (steps + verifies) or \
                bool(verifies) != bool(row["spec_k"]):
            fail(f"engine {tag}: mmha launched {launches['mmha']} times in "
                 f"{steps} decode and {verifies} verify steps (spec_k "
                 f"{row['spec_k']}), want {layers} a step")
        rows = _agreement(
            torch, f"engine {tag}", outs, served[:n_req],
            lambda i, j: _next_logits(torch, sm, b_engine,
                                      prompts[i] + served[i][:j]))
        spec = row["speculative"]
        if tag == "h" and not (spec["accepted_tokens"] >= 1
                               and row["tokens_per_step"] > 1.0):
            fail(f"engine h accepted no draft: {spec}")
        emit({"phase": "serve", "engine": label, "model": "llama3_8b",
              "diverged": sum(r["first_divergence"] is not None
                              for r in rows),
              "agreement": rows, **row})


def phase_verify_attention(torch, model, engine, prompts):
    """The verify step's attention at engines g-i's shape (8 rows of K + 1
    = 5 lanes at the served prompts' lengths, tables of 128 pages): the
    mmha kernel over the 40 lanes as rows against its plain version (and
    the same bits twice) and against the ``chunk_attention`` composite the
    JAX verify runs (every row's whole table gathered, an f32 grouped
    einsum), each timed with a cold L2, beside the least time of the
    function (each row's visible K and V read once). Then the whole
    verify forward on the fused path, kernels against plain versions over
    all 40 lanes' logits, and its profile (mmha once a layer)."""
    from paddle_tpu_torch.ops.kernels import mmha
    from paddle_tpu_torch.serving import ServingModel, kv_cache

    pool, dev = engine.pool, engine.device
    cfg = model.cfg
    b, s = engine.config.max_batch, SPEC_K + 1
    h, h_kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    timer = ColdTimer(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    tables, _, lens, held = _batch_tables(torch, engine, prompts)
    try:
        # the K + 1 lanes' writes stay inside each row's pages
        base = lens - s
        idx = torch.tensor(held, device=dev)
        for t in (pool.k[0], pool.v[0]):
            t[idx] = torch.randn(t[idx].shape, generator=gen,
                                 device=dev).to(t.dtype)
        q = torch.randn(b, s, h, d, generator=gen, device=dev).to(
            torch.bfloat16)
        q1 = q.reshape(b * s, 1, h, d)
        lane = torch.arange(s, device=dev, dtype=torch.int32)
        tab_lanes = tables.repeat_interleave(s, dim=0)
        pos_lanes = (base[:, None] + lane).reshape(-1)
        kl, vl = pool.k[0], pool.v[0]
        got = mmha.mmha_decode(q1, kl, vl, tab_lanes, pos_lanes)
        again = mmha.mmha_decode(q1, kl, vl, tab_lanes, pos_lanes)
        if not torch.equal(got, again):
            fail("verify attention: two mmha calls gave different bits")
        err, tol = compare(torch, got, mmha.mmha_plain(q1, kl, vl, tab_lanes,
                                                       pos_lanes))
        if not err <= tol:
            fail(f"verify attention: mmha over lanes {err} > {tol}")

        def composite():
            return kv_cache.chunk_attention(
                q, kv_cache.gather_layer(pool.k, 0, tables),
                kv_cache.gather_layer(pool.v, 0, tables), base)

        err_c, tol_c = compare(torch, got.reshape(b, s, h, d), composite())
        if not err_c <= tol_c:
            fail(f"verify attention: mmha against chunk_attention {err_c} "
                 f"> {tol_c}")
        ms = timer(lambda: mmha.mmha_decode(q1, kl, vl, tab_lanes,
                                            pos_lanes))
        plain_ms = timer(lambda: mmha.mmha_plain(q1, kl, vl, tab_lanes,
                                                 pos_lanes))
        composite_ms = timer(composite)
        visible = int((base + s).sum())
        nbytes = 2 * visible * h_kv * d * 2 + 2 * q.numel() * 2 \
            + tab_lanes.numel() * 4
        bound_ms, bound_by = bound(nbytes, 4.0 * visible * h * d,
                                   BF16_TC_FLOPS_PER_S)

        fused = ServingModel(model).bind_pool(pool)
        toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                             device=dev)
        dl = torch.full((b,), SPEC_K, dtype=torch.int32, device=dev)
        lp = fused.verify_forward(toks, base, dl, tables, plain=True).float()
        lk = fused.verify_forward(toks, base, dl, tables).float()
        torch.cuda.synchronize()
        rows = [_parity_row(torch, r * s + i, int(base[r]) + i, lk[r, i],
                            lp[r, i]) for r in range(b) for i in range(s)]
        prof = _profile(torch, lambda: fused.verify_forward(
            toks, base, dl, tables), reps=10)
    finally:
        pool.free(held)
    _check_parity("verify forward, fused, 8 rows x 5 lanes", rows)
    if prof["port_launches_per_call"]["mmha"] != cfg.num_layers:
        fail(f"verify step: mmha launched "
             f"{prof['port_launches_per_call']['mmha']} times, want one a "
             f"layer")
    emit({"phase": "verify_attention", "rows": b, "lanes": s,
          "positions": (base + s - 1).tolist(), "max_pages": tables.shape[1],
          "mmha_lanes_ms": ms, "mmha_lanes_plain_ms": plain_ms,
          "chunk_attention_ms": composite_ms, "bound_ms": bound_ms,
          "bound_by": bound_by, "max_abs_err": err, "tol": tol,
          "max_abs_err_vs_chunk_attention": err_c,
          "verify_step_profile": prof})


def phase_generate(torch, np, model, b_engine, prompts, served,
                   name="llama3_8b"):
    """Cached ``generate`` on the served Llama-3-8B: 64 greedy tokens for
    each of engine b's first four prompts, one B 1 call each, held against
    engine b's tokens by :func:`_agreement`; each call launches mmha once
    a layer a token and flash once a layer (the prefill). Then the four
    prompts cut to the shortest one's length in one B 4 call, held against
    B 1 calls on the same cut prompts. ms per token after the prefill,
    which is timed alone."""
    from paddle_tpu_torch.ops.kernels import WRAPPERS
    from paddle_tpu_torch.serving import ServingModel

    dev = b_engine.device
    layers = model.cfg.num_layers
    sm = ServingModel(model).bind_pool(b_engine.pool)
    ps = [list(p) for p in prompts[:GEN_REQUESTS]]
    model.generate(torch.tensor([ps[0][:32]], device=dev), max_new_tokens=2)

    def run(batch):
        ids = torch.tensor(batch, device=dev)
        caches = model.init_cache(ids.shape[0], ids.shape[1] + GEN_TOKENS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            model(ids[:, :-1], caches=caches, cache_pos=0, with_head=False)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        del caches
        for w in WRAPPERS.values():
            w.launches = 0
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=GEN_TOKENS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = {n: w.launches for n, w in WRAPPERS.items() if w.launches}
        want = {"mmha": layers * GEN_TOKENS, "flash_attention": layers}
        got = {n: launches.get(n, 0) for n in want}
        if got != want:
            fail(f"generate B {len(batch)}: launches {got}, want {want}")
        toks = [out[r, ids.shape[1]:].tolist() for r in range(len(batch))]
        return toks, {"batch": len(batch), "prompt_len": ids.shape[1],
                      "wall_ms": wall_ms, "prefill_ms": prefill_ms,
                      "ms_per_token": (wall_ms - prefill_ms) / GEN_TOKENS,
                      "launches": launches}

    singles, calls = [], []
    for p in ps:
        toks, row = run([p])
        singles.append(toks[0])
        calls.append(row)
    rows = _agreement(torch, "generate B 1 against engine b", singles,
                      [o[:GEN_TOKENS] for o in served[:GEN_REQUESTS]],
                      lambda i, j: _next_logits(torch, sm, b_engine,
                                                ps[i] + served[i][:j]))
    cut = min(len(p) for p in ps)
    cut_ps = [p[:cut] for p in ps]
    cut_singles = []
    for p in cut_ps:
        toks, row = run([p])
        cut_singles.append(toks[0])
        calls.append(row)
    batched, row = run(cut_ps)
    calls.append(row)
    rows4 = _agreement(torch, "generate B 4 against B 1", batched,
                       cut_singles,
                       lambda i, j: _next_logits(torch, sm, b_engine,
                                                 cut_ps[i]
                                                 + cut_singles[i][:j]))
    emit({"phase": "generate", "model": name, "tokens": GEN_TOKENS,
          "calls": calls, "against_engine_b": rows,
          "b4_against_b1": rows4, "cut_prompt_len": cut})


def phase_generate_gpt(torch, dev):
    """Cached ``generate`` on GPT-2 small (bf16, random weights from a
    seed): 64 greedy tokens for 8 seeded prompts of 128 in one call, held
    by :func:`_agreement` against the exact-length host loop
    (``use_cache=False``) on the same model, whose logits at a divergence
    come from a whole forward. The cached call launches mmha once a layer
    a token and flash once a layer."""
    from paddle_tpu_torch.models import gpt2_small
    from paddle_tpu_torch.ops.kernels import WRAPPERS

    model = gpt2_small(device=dev, dtype=torch.bfloat16, seed=0).eval()
    layers = model.cfg.num_layers
    gen = torch.Generator(device=dev).manual_seed(5)
    ids = torch.randint(0, 50257, (GPT_GEN_BATCH, GPT_GEN_PROMPT),
                        generator=gen, device=dev)
    for cache in (True, False):
        model.generate(ids[:, :16], max_new_tokens=2, use_cache=cache)
    times, outs = {}, {}
    for cache in (True, False):
        for w in WRAPPERS.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=GEN_TOKENS, use_cache=cache)
        torch.cuda.synchronize()
        times[cache] = (time.perf_counter() - t0) * 1e3
        outs[cache] = out
        if cache:
            launches = {n: w.launches for n, w in WRAPPERS.items()
                        if w.launches}
    want = {"mmha": layers * GEN_TOKENS, "flash_attention": layers}
    got = {n: launches.get(n, 0) for n in want}
    if got != want:
        fail(f"GPT-2 generate: launches {got}, want {want}")
    ref = outs[False]

    def logits_at(i, j):
        with torch.no_grad():
            return model(ref[i:i + 1, :GPT_GEN_PROMPT + j])[0, -1].float()

    rows = _agreement(torch, "GPT-2 generate against the host loop",
                      [outs[True][r, GPT_GEN_PROMPT:].tolist()
                       for r in range(GPT_GEN_BATCH)],
                      [ref[r, GPT_GEN_PROMPT:].tolist()
                       for r in range(GPT_GEN_BATCH)], logits_at)
    emit({"phase": "generate", "model": "gpt2_small", "batch": GPT_GEN_BATCH,
          "prompt_len": GPT_GEN_PROMPT, "tokens": GEN_TOKENS,
          "cached_ms": times[True],
          "cached_ms_per_token": times[True] / GEN_TOKENS,
          "host_loop_ms": times[False],
          "host_loop_ms_per_token": times[False] / GEN_TOKENS,
          "launches": launches, "against_host_loop": rows})
    del model
    _free(torch)


_OWN_KERNELS = ("mmha_paged_kernel", "rms_norm_kernel", "rope_kernel",
                "swiglu_kernel", "flash_attention_kernel",
                "block_epilogue_kernel", "decode_layer_wgmma_kernel",
                "wo_prefill_kernel", "wo_decode_kernel",
                "a8w8_quantize_kernel", "a8w8_transpose_kernel",
                "a8w8_wgmma_kernel", "rms_norm_bwd_kernel",
                "rms_norm_bwd_sum_kernel",
                "swiglu_bwd_kernel", "flash_bwd_delta_kernel",
                "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                "adamw_kernel", "block_epilogue_bwd_rows_kernel",
                "block_epilogue_bwd_sum_kernel",
                "swiglu_packed_kernel", "swiglu_packed_bwd_kernel",
                "lamb_moments_kernel", "lamb_apply_kernel",
                "ce_row_stats_kernel", "moe_wgmma_kernel",
                "softmax_mask_kernel", "softmax_mask_bwd_kernel",
                "softmax_mask_smem_kernel", "softmax_mask_bwd_smem_kernel",
                "bias_dropout_ln_kernel", "bias_dropout_ln_bwd_kernel",
                "bdl_partial_sum_kernel", "dropout_add_kernel",
                "grad_acc_kernel")
_GEMM_MARKS = ("gemm", "xmma", "nvjet", "cutlass")


def _profile(torch, fn, reps: int):
    """Breakdown of ``reps`` calls of ``fn``: the host-clock wall time per
    call without the profiler (ending in a synchronise), then, under
    torch.profiler, the device time per call of the port's kernels, of
    matrix products and of everything else, and the top kernels. The idle
    share is 1 - device busy time / unprofiled wall time (the profiler
    slows the host, so its own timeline overstates idleness). The port's
    launches per call come from the wrappers' counts over the timed
    calls; its kernels' device time per call is also given by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops.kernels import WRAPPERS

    fn()
    torch.cuda.synchronize()
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    port_launches = {n: w.launches / reps for n, w in WRAPPERS.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"wall_ms_per_call": wall_ms, "device_events": 0,
                "port_launches_per_call": port_launches,
                "breakdown": "not measured"}
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    buckets = {"port_kernels": 0.0, "matmul": 0.0, "other": 0.0}
    own: dict = {}
    for name, us in by_name.items():
        mine = [k for k in _OWN_KERNELS if k in name]
        key = "port_kernels" if mine else \
            "matmul" if any(k in name.lower() for k in _GEMM_MARKS) else \
            "other"
        buckets[key] += us
        if mine:
            k = max(mine, key=len)       # rms_norm_bwd_kernel, not rms_norm
            own[k] = own.get(k, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    busy_ms = busy / reps / 1e3
    return {"wall_ms_per_call": wall_ms, "device_events": len(kernels),
            "launches_per_call": len(kernels) / reps,
            "port_launches_per_call": port_launches,
            "busy_ms_per_call": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "ms_per_call": {k: v / reps / 1e3 for k, v in buckets.items()},
            "port_ms_per_call": {k: v / reps / 1e3 for k, v in own.items()},
            "top": [{"kernel": n[:90], "ms_per_call": us / reps / 1e3}
                    for n, us in top]}


def _batch_tables(torch, engine, prompts):
    """A decode batch of ``max_batch`` rows at the lengths of the first
    prompts plus 32, on pages held from ``engine``'s pool. Returns
    (tables, tokens, positions, held pages) on the card."""
    pool, dev = engine.pool, engine.device
    b = engine.config.max_batch
    lens = [len(p) + 32 for p in prompts[:b]]
    tables = torch.zeros(b, engine.scheduler.max_pages, dtype=torch.int32)
    held = []
    try:
        for r, n in enumerate(lens):
            pages = pool.alloc(pool.pages_for(n + 1))
            held += pages
            tables[r, :len(pages)] = torch.tensor(pages, dtype=torch.int32)
    except Exception:
        pool.free(held)
        raise
    return (tables.to(dev), torch.arange(1, b + 1, device=dev),
            torch.tensor(lens, dtype=torch.int32, device=dev), held)


def _decode_step_gate(what, prof, layers, mmha_launches):
    """A decode step's RoPE and mmha launches, exact: one q+k RoPE launch a
    layer (the step's q and k together) and ``mmha_launches``."""
    got = {n: prof["port_launches_per_call"][n] for n in ("rope", "mmha")}
    want = {"rope": layers, "mmha": mmha_launches}
    if got != want:
        fail(f"{what}: launches a decode step {got}, want {want}")


def phase_profile_quant(torch, engine, prompts, label):
    """A quantized engine: where a decode step (batch 8) and a 1024-token
    monolithic prefill spend their device time; the step's RoPE and mmha
    launches (``_decode_step_gate``)."""
    sm, pool, dev = engine._sm, engine.pool, engine.device
    tables, toks, pos, held = _batch_tables(torch, engine, prompts)
    out = {"phase": "profile", "engine": label}
    layers = sm.cfg.num_layers
    try:
        out[f"{label}_decode_step"] = _profile(
            torch, lambda: sm.decode_forward(toks, pos, tables), reps=10)
        _decode_step_gate(f"engine {label}", out[f"{label}_decode_step"],
                          layers, 0 if engine.config.fused_decode_layer
                          else layers)
        mono_toks = torch.arange(1024, device=dev)[None] + 7
        out[f"{label}_monolithic_prefill_1024"] = _profile(
            torch, lambda: sm.prefill_forward(mono_toks, 1024, tables[0]),
            reps=2)
    finally:
        pool.free(held)
    emit(out)


def phase_llm_int8(torch, dev):
    """``nn.quant.llm_int8_linear`` at the prefill shape x [1024, 4096]
    bf16 with 4 outlier channels scaled by 40, w [14336, 4096] int8, ws
    and a bias, called LLM_INT8_CALLS times with every launch count set to
    0 just before and read just after: each call launches A8W8 once (its
    dense part) and nothing else. The output matches the plain path within
    3 bf16 ulps of the largest value (one for A8W8's output, one for the
    cast of the sum, one for the bias add). Timed cold, with the plain
    path beside it, and profiled over 5 warm calls: the device ms of the
    A8W8 kernels against everything else the call runs (the outlier part:
    its f32 weight and product, the casts and adds). Returns the launches
    of the run."""
    from paddle_tpu_torch.nn.quant import llm_int8_linear
    from paddle_tpu_torch.ops.kernels import WRAPPERS

    gen = torch.Generator(device=dev).manual_seed(99)
    m, k, n = 1024, 4096, 14336
    x = torch.randn(m, k, generator=gen, device=dev)
    x[:, [7, 100, 2000, 4000]] *= 40.0
    x = x.to(torch.bfloat16)
    w = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                      dtype=torch.int8)
    ws = torch.rand(n, generator=gen, device=dev) * 2e-3 + 1e-4
    bias = (torch.randn(n, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    timer = ColdTimer(torch, dev)
    calls = LLM_INT8_CALLS
    with torch.inference_mode():
        torch.cuda.synchronize()
        for wr in WRAPPERS.values():
            wr.launches = 0
        outs = [llm_int8_linear(x, w, bias, ws) for _ in range(calls)]
        torch.cuda.synchronize()
        launches = {name: wr.launches for name, wr in WRAPPERS.items()}
        got = outs[0]
        ref = llm_int8_linear(x, w, bias, ws, plain=True)
        err, ulp = compare(torch, got, ref)
        if not all(torch.equal(o, got) for o in outs[1:]):
            fail("llm_int8_linear: calls on the same inputs differ")
        ms = timer(lambda: llm_int8_linear(x, w, bias, ws))
        plain_ms = timer(lambda: llm_int8_linear(x, w, bias, ws, plain=True))
        prof = _profile(torch, lambda: llm_int8_linear(x, w, bias, ws),
                        reps=5)
    a8_ms = sum((prof.get("port_ms_per_call") or {}).values())
    split = {"a8w8_ms": a8_ms,
             "outlier_composite_ms": None if "busy_ms_per_call" not in prof
             else prof["busy_ms_per_call"] - a8_ms,
             "a8w8_kernels_ms": prof.get("port_ms_per_call"),
             "wall_ms": prof.get("wall_ms_per_call"), "top": prof.get("top")}
    emit({"phase": "llm_int8_linear", "shape": [m, k, n], "outliers": 4,
          "finite": bool(torch.isfinite(got).all()),
          "max_abs_err": err, "tol": 3 * ulp, "ms": ms, "plain_ms": plain_ms,
          "calls": calls, "launches": launches, "split": split})
    if launches["a8w8"] != calls or any(
            c for name, c in launches.items() if name != "a8w8"):
        fail(f"llm_int8_linear: launches {launches} in {calls} calls, want "
             f"a8w8 once per call and nothing else")
    if not err <= 3 * ulp:
        fail(f"llm_int8_linear: kernel path differs from the plain one by "
             f"{err} > {3 * ulp}")
    return launches


def _train_step(torch, model, opt, ids, labels):
    """One forward, backward and optimizer step; returns the loss."""
    _, loss = model(ids, labels=labels)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.detach()


def _grad_parity(torch, what, model, ref, batches, loss_fn=None,
                 grad_tol=TRAIN_GRAD_TOL):
    """Forward and backward of ``model`` through the kernels and with
    ``plain=True`` from the same weights, and with ``plain=True`` through
    ``ref``, an f32 copy of them, on each ``(ids, labels)`` of
    ``batches``: the mean bf16 losses within TRAIN_LOSS_TOL relative;
    every parameter's gradient within TRAIN_GRAD_TOL relative L2 of the
    plain path's, and no farther from the f32 gradient than
    TRAIN_F32_RATIO times the plain path's distance from it. Over several
    batches a relative L2 distance is ``sqrt(sum_b |a_b - r_b|^2) /
    sqrt(sum_b |r_b|^2)``; over one it is the plain relative L2. With
    several batches, each batch's own f32 ratios are summarised beside the
    gate (the worst, the mean and the spread over the gradients).
    ``loss_fn(net, plain, ids, labels)``, where given, computes the loss
    in place of the model's own ``labels`` path. ``grad_tol=None`` reports
    the gradients' distance from the plain path's without holding it.
    A parameter the f32 reference's loss does not reach (a post-LN
    layer's pre-LN scale) is left out; a gradient that the kernel or the
    plain path lacks, or has where the reference has none, fails."""
    def grads_of(net, plain, ids, labels):
        if loss_fn is None:
            _, loss = net(ids, labels=labels, plain=plain)
        else:
            loss = loss_fn(net, plain, ids, labels)
        loss.backward()
        out = {n: p.grad for n, p in net.named_parameters()}
        net.zero_grad(set_to_none=True)
        return loss.item(), out

    def sq(a, b=None):
        d = a.float() if b is None else a.float() - b.float()
        return d.square().sum().item()

    losses = {"kernels": 0.0, "plain": 0.0, "f32": 0.0}
    acc = {k: {} for k in ("kp", "p", "k32", "p32", "r")}
    per_batch = []
    for ids, labels in batches:
        loss_k, g_k = grads_of(model, False, ids, labels)
        loss_p, g_p = grads_of(model, True, ids, labels)
        loss_r, g_r = grads_of(ref, True, ids, labels)
        g_r = {n: g for n, g in g_r.items() if g is not None}
        for path, g in (("kernel", g_k), ("plain", g_p)):
            have = {n for n, v in g.items() if v is not None}
            if have != set(g_r):
                fail(f"{what} parity: the {path} path has gradients for "
                     f"{sorted(have - set(g_r))} that the f32 reference "
                     f"lacks and none for {sorted(set(g_r) - have)}")
        for key, val in (("kernels", loss_k), ("plain", loss_p),
                         ("f32", loss_r)):
            losses[key] += val / len(batches)
        ratios = {}
        for n in g_r:
            d = {"kp": sq(g_k[n], g_p[n]), "p": sq(g_p[n]),
                 "k32": sq(g_k[n], g_r[n]), "p32": sq(g_p[n], g_r[n]),
                 "r": sq(g_r[n])}
            for key, val in d.items():
                acc[key][n] = acc[key].get(n, 0.0) + val
            ratios[n] = math.sqrt(d["k32"] / max(d["p32"], 1e-30))
        del g_k, g_p, g_r
        top = max(ratios, key=ratios.get)
        mean = sum(ratios.values()) / len(ratios)
        per_batch.append({
            "worst_f32_ratio": ratios[top], "worst_f32_ratio_grad": top,
            "mean_f32_ratio": mean,
            "sd_f32_ratio": math.sqrt(sum((r - mean) ** 2 for r in
                                          ratios.values()) / len(ratios))})
    names = list(acc["kp"])
    rel = {n: math.sqrt(acc["kp"][n] / acc["p"][n]) for n in names}
    rel_k32 = {n: math.sqrt(acc["k32"][n] / acc["r"][n]) for n in names}
    rel_p32 = {n: math.sqrt(acc["p32"][n] / acc["r"][n]) for n in names}
    worst = max(rel, key=rel.get)
    ratio = {n: rel_k32[n] / max(rel_p32[n], 1e-12) for n in names}
    worst_ratio = max(ratio, key=ratio.get)
    loss_rel = abs(losses["kernels"] - losses["plain"]) / abs(losses["plain"])
    emit({"phase": "train_parity", "what": what, "batches": len(batches),
          "loss_kernels": losses["kernels"], "loss_plain": losses["plain"],
          "loss_f32": losses["f32"], "loss_rel_diff": loss_rel,
          "loss_tol": TRAIN_LOSS_TOL, "worst_grad": worst,
          "worst_grad_rel_l2": rel[worst], "grad_tol": grad_tol,
          "worst_f32_ratio_grad": worst_ratio,
          "worst_f32_ratio": ratio[worst_ratio],
          "f32_ratio_tol": TRAIN_F32_RATIO, "per_batch": per_batch,
          "grad_rel_l2": rel,
          "kernels_vs_f32": rel_k32, "plain_vs_f32": rel_p32})
    if not (loss_rel <= TRAIN_LOSS_TOL
            and (grad_tol is None or rel[worst] <= grad_tol)
            and ratio[worst_ratio] <= TRAIN_F32_RATIO):
        fail(f"{what} parity: loss {loss_rel} (tol {TRAIN_LOSS_TOL}), "
             f"{worst} gradient {rel[worst]} (tol {grad_tol}), "
             f"{worst_ratio} {rel_k32[worst_ratio]} from f32 against the "
             f"plain path's {rel_p32[worst_ratio]} (tol x{TRAIN_F32_RATIO})")


def _train_steps(torch, what, model, opt, ids, labels, steps, want,
                 step_fn=None):
    """``steps`` optimizer steps (``step_fn()`` where given, else
    :func:`_train_step`), each one's launches set to 0 just before it and
    read just after, and held to ``want``. Returns (losses, host ms per
    step to a synchronise, the launches of the last step)."""
    from paddle_tpu_torch.ops.kernels import WRAPPERS

    losses, step_ms, launches = [], [], None
    for step in range(steps):
        torch.cuda.synchronize()
        for w in WRAPPERS.values():
            w.launches = 0
        t0 = time.perf_counter()
        losses.append(step_fn() if step_fn is not None else
                      _train_step(torch, model, opt, ids, labels))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        got = {n: w.launches for n, w in WRAPPERS.items() if w.launches}
        if got != want:
            fail(f"{what} step {step}: launches {got}, want {want}")
        launches = {n: w.launches for n, w in WRAPPERS.items()}
    return [x.item() for x in losses], step_ms, launches


def _heldout(torch, model, gen, vocab, batch, seq):
    """The loss on a fresh batch of random tokens: memorising the training
    batch cannot bring it below ln(vocab), the entropy of uniform tokens; a
    causal mask that let a position see its label would."""
    held = torch.randint(0, vocab, (batch, seq + 1), generator=gen,
                         device=model.device)
    with torch.no_grad():
        loss = model(held[:, :-1].contiguous(),
                     labels=held[:, 1:].contiguous())[1].item()
    return loss, math.log(vocab)


def _check_curve(what, losses, heldout, uniform):
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"{what}: losses {losses} not finite or not falling")
    if not heldout >= uniform - 1.0:
        fail(f"{what}: loss {heldout} on a fresh random batch is below "
             f"ln(vocab) - 1 = {uniform - 1.0}: a position sees its label")


def phase_train(torch, dev):
    """Llama training at Llama-3-8B's width, cut to TRAIN_LAYERS layers:
    ``llama3_8b(num_layers=4)`` in bf16 from a seed,
    ``AdamW(1e-4, weight_decay=0.01, multi_precision=True,
    grad_clip=ClipGradByGlobalNorm(1.0))``, one fixed batch of B x S random
    tokens (labels: the next token).
    a. parity (``_grad_parity``) on the fused trunk (the default), then on
       the unfused trunk (``fused_blocks = False``);
    b. one step on the unfused trunk, its launches: rms_norm and
       rms_norm_bwd 2L+1, rope 2L (one q+k launch a layer forward and
       one backward), swiglu and swiglu_bwd L,
       flash_attention and flash_attention_bwd L (one call of the backward
       wrapper launches its delta, dq and dk/dv kernels and counts once),
       adamw one per parameter (9L+3), nothing else;
    c. TRAIN_STEPS steps on the fused trunk, each one's launches: rms_norm
       and rms_norm_bwd 1 (the first input_layernorm), block_epilogue and
       block_epilogue_bwd 2L, rope 2L, swiglu, swiglu_bwd,
       flash_attention and flash_attention_bwd L, adamw 9L+3, nothing
       else; every loss finite and the last below the first; then, on a
       fresh random batch, a loss no lower than ln(vocab) - 1;
    d. step time of the fused trunk (host clock to a synchronise, steps 2
       on), tokens/s, peak memory, and a torch.profiler breakdown of one
       step.
    Returns the launches of one fused-trunk step."""
    from paddle_tpu_torch.models import llama3_8b
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    torch.cuda.reset_peak_memory_stats()
    layers = TRAIN_LAYERS
    model = llama3_8b(device=dev, dtype=torch.bfloat16, seed=0,
                      num_layers=layers)
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device=dev).manual_seed(2024)
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                         generator=gen, device=dev)
    ids, labels = toks[:, :-1].contiguous(), toks[:, 1:].contiguous()

    ref = llama3_8b(device=dev, dtype=torch.float32, seed=None,
                    num_layers=layers)
    ref.load_state_dict(model.state_dict())
    for fused in (True, False):
        model.fused_blocks = ref.fused_blocks = fused
        _grad_parity(torch, f"llama {'fused' if fused else 'unfused'} trunk",
                     model, ref, [(ids, labels)])
    del ref

    opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0))
    n_tensors = 9 * layers + 3
    unfused = {"rms_norm": 2 * layers + 1, "rms_norm_bwd": 2 * layers + 1,
               "rope": 2 * layers, "swiglu": layers, "swiglu_bwd": layers,
               "flash_attention": layers, "flash_attention_bwd": layers,
               "adamw": n_tensors}
    _, unfused_ms, _ = _train_steps(torch, "llama unfused train", model, opt,
                                    ids, labels, 1, unfused)
    model.fused_blocks = True
    fused = {"rms_norm": 1, "rms_norm_bwd": 1,
             "block_epilogue": 2 * layers, "block_epilogue_bwd": 2 * layers,
             "rope": 2 * layers, "swiglu": layers, "swiglu_bwd": layers,
             "flash_attention": layers, "flash_attention_bwd": layers,
             "adamw": n_tensors}
    losses, step_ms, launches = _train_steps(
        torch, "llama fused train", model, opt, ids, labels, TRAIN_STEPS,
        fused)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    heldout, uniform = _heldout(torch, model, gen, cfg.vocab_size,
                                TRAIN_BATCH, TRAIN_SEQ)
    steady = step_ms[1:]
    mean_ms = sum(steady) / len(steady)
    emit({"phase": "train", "model": "llama3_8b", "trunk": "fused",
          "layers": layers, "hidden": cfg.hidden_size,
          "intermediate": cfg.intermediate_size, "vocab": cfg.vocab_size,
          "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "losses": losses, "step_ms": step_ms,
          "step_ms_mean_after_first": mean_ms,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / mean_ms * 1e3,
          "unfused_step_ms": unfused_ms, "peak_memory_gb": peak_gb,
          "launches_per_step": launches, "unfused_launches_per_step":
          unfused, "heldout_loss": heldout, "uniform_loss": uniform})
    _check_curve("llama train", losses, heldout, uniform)
    prof = _profile(torch, lambda: _train_step(torch, model, opt, ids,
                                               labels), reps=2)
    model.fused_blocks = False
    prof_unfused = _profile(torch, lambda: _train_step(torch, model, opt, ids,
                                                       labels), reps=2)
    emit({"phase": "profile", "train_step": prof,
          "train_step_unfused": prof_unfused})
    return launches


def phase_packed_mlp(torch, dev):
    """``nn.functional.swiglu(x)`` on one packed operand, through a user's
    MLP with a fused gate/up projection at Llama-3-8B's widths
    (``gate_up [2 x 14336, 4096]``, ``down [4096, 14336]``, bf16, x of B 2
    x S 2048 tokens): forward and backward, the launches set to 0 just
    before and read just after (swiglu_packed and swiglu_packed_bwd once,
    nothing else), and the gradients of x and of both weights within
    TRAIN_GRAD_TOL relative L2 of the plain path's. Returns the
    launches."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.kernels import WRAPPERS

    hid, inter = 4096, 14336
    gen = torch.Generator(device=dev).manual_seed(99)
    gate_up = torch.nn.Linear(hid, 2 * inter, bias=False, device=dev,
                              dtype=torch.bfloat16)
    down = torch.nn.Linear(inter, hid, bias=False, device=dev,
                           dtype=torch.bfloat16)
    with torch.no_grad():
        gate_up.weight.normal_(0.0, 0.02, generator=gen)
        down.weight.normal_(0.0, 0.02, generator=gen)
    x = torch.randn(TRAIN_BATCH * TRAIN_SEQ, hid, generator=gen, device=dev
                    ).to(torch.bfloat16).requires_grad_()
    params = (x, gate_up.weight, down.weight)

    def run(plain):
        out = down(F.swiglu(gate_up(x), plain=plain))
        loss = out.float().square().mean()
        return torch.autograd.grad(loss, params)

    ref = run(True)
    torch.cuda.synchronize()
    for w in WRAPPERS.values():
        w.launches = 0
    got = run(False)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in WRAPPERS.items()}
    want = {"swiglu_packed": 1, "swiglu_packed_bwd": 1}
    rel = {n: _rel_l2(torch, a, r)
           for n, a, r in zip(("x", "gate_up", "down"), got, ref)}
    emit({"phase": "packed_mlp", "tokens": x.shape[0], "hidden": hid,
          "intermediate": inter, "grad_rel_l2": rel,
          "launches": {n: c for n, c in launches.items() if c}})
    if {n: c for n, c in launches.items() if c} != want:
        fail(f"packed mlp: launches {launches}, want {want}")
    if not max(rel.values()) <= TRAIN_GRAD_TOL:
        fail(f"packed mlp: gradients {rel} > {TRAIN_GRAD_TOL} from plain")
    return launches


def phase_train_gpt(torch, dev):
    """GPT-2 small at full width and depth (12 layers, 124M parameters,
    vocab 50304, S 1024; ``gpt2_small`` in bf16 from a seed) trains on the
    fused trunk with ``AdamW(3e-4, weight_decay=0.01, multi_precision=True,
    grad_clip=ClipGradByGlobalNorm(1.0))`` on one fixed batch of B 8 x S
    1024 random tokens: parity (``_grad_parity``) against the plain path
    and an f32 copy over that batch and GPT_PARITY_BATCHES - 1 more;
    GPT_STEPS steps, each one's launches block_epilogue
    and block_epilogue_bwd 2L, flash_attention and flash_attention_bwd L,
    adamw one per parameter (12L+4), nothing else; a finite, falling loss
    and the fresh-batch check; step time, tokens/s, MFU (tokens/s times
    ``flops_per_token(S)`` over the bf16 tensor-core peak), peak memory and
    a profile of one step. Returns the launches of one step."""
    from paddle_tpu_torch.models import gpt2_small
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    torch.cuda.reset_peak_memory_stats()
    model = gpt2_small(device=dev, dtype=torch.bfloat16, seed=0)
    cfg = model.cfg
    layers = cfg.num_layers
    gen = torch.Generator(device=dev).manual_seed(2025)
    toks = torch.randint(0, cfg.vocab_size, (GPT_BATCH, GPT_SEQ + 1),
                         generator=gen, device=dev)
    ids, labels = toks[:, :-1].contiguous(), toks[:, 1:].contiguous()
    ref = gpt2_small(device=dev, dtype=torch.float32, seed=None)
    ref.load_state_dict(model.state_dict())
    batches = [(ids, labels)]
    for _ in range(GPT_PARITY_BATCHES - 1):
        more = torch.randint(0, cfg.vocab_size, (GPT_BATCH, GPT_SEQ + 1),
                             generator=gen, device=dev)
        batches.append((more[:, :-1].contiguous(), more[:, 1:].contiguous()))
    _grad_parity(torch, "gpt2_small", model, ref, batches)
    del ref, batches
    opt = AdamW(3e-4, parameters=model.parameters(), weight_decay=0.01,
                multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0))
    n_tensors = len(list(model.parameters()))
    want = {"block_epilogue": 2 * layers, "block_epilogue_bwd": 2 * layers,
            "flash_attention": layers, "flash_attention_bwd": layers,
            "adamw": n_tensors}
    if n_tensors != 12 * layers + 4:
        fail(f"gpt2_small has {n_tensors} parameter tensors, want "
             f"{12 * layers + 4}")
    losses, step_ms, launches = _train_steps(
        torch, "gpt2 train", model, opt, ids, labels, GPT_STEPS, want)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    heldout, uniform = _heldout(torch, model, gen, cfg.vocab_size, GPT_BATCH,
                                GPT_SEQ)
    steady = step_ms[1:]
    mean_ms = sum(steady) / len(steady)
    tokens_per_s = GPT_BATCH * GPT_SEQ / mean_ms * 1e3
    fpt = model.flops_per_token(GPT_SEQ)
    emit({"phase": "train_gpt", "model": "gpt2_small", "layers": layers,
          "hidden": cfg.hidden_size, "vocab": cfg.vocab_size,
          "params": model.num_params(non_embedding=False),
          "batch": GPT_BATCH, "seq": GPT_SEQ, "losses": losses,
          "step_ms": step_ms, "step_ms_mean_after_first": mean_ms,
          "tokens_per_s": tokens_per_s, "flops_per_token": fpt,
          "mfu": tokens_per_s * fpt / BF16_TC_FLOPS_PER_S,
          "peak_memory_gb": peak_gb, "launches_per_step": launches,
          "heldout_loss": heldout, "uniform_loss": uniform})
    _check_curve("gpt2 train", losses, heldout, uniform)
    prof = _profile(torch, lambda: _train_step(torch, model, opt, ids,
                                               labels), reps=3)
    emit({"phase": "profile", "gpt2_train_step": prof})
    return launches


def _optimizer_cases(torch, opt_mod, reg, clip):
    """(label, optimizer class, kwargs, bf16 with master weights) of the
    optimizers phase."""
    return [
        ("SGD", opt_mod.SGD, dict(learning_rate=0.1), False),
        ("Momentum nesterov", opt_mod.Momentum,
         dict(learning_rate=0.05, use_nesterov=True), False),
        ("Momentum multi_precision", opt_mod.Momentum,
         dict(learning_rate=0.05, use_nesterov=True, multi_precision=True),
         True),
        ("Adagrad", opt_mod.Adagrad, dict(learning_rate=0.05), False),
        ("Adadelta", opt_mod.Adadelta, dict(learning_rate=1.0), False),
        ("Adamax", opt_mod.Adamax, dict(learning_rate=0.01), False),
        ("RMSProp centered momentum", opt_mod.RMSProp,
         dict(learning_rate=0.01, centered=True, momentum=0.9), False),
        ("Adam L1Decay", opt_mod.Adam,
         dict(learning_rate=0.01, weight_decay=reg.L1Decay(1e-4)), False),
        ("SGD L2Decay ClipGradByValue", opt_mod.SGD,
         dict(learning_rate=0.1, weight_decay=reg.L2Decay(1e-3),
              grad_clip=clip.ClipGradByValue(1e-3)), False),
        ("Momentum ClipGradByNorm", opt_mod.Momentum,
         dict(learning_rate=0.05, grad_clip=clip.ClipGradByNorm(0.5)),
         False)]


def phase_optimizers(torch, dev):
    """The element-wise optimizers on the card against the same steps on
    CPU copies: the parameter shapes of GPT-2 small's embeddings, first
    block and final norm (f32, or bf16 with f32 master weights), weights
    and three fixed gradients made from a seed; each optimizer takes 3
    steps on both, the last one on the card under
    ``set_sync_debug_mode("error")``; every parameter (and master weight)
    within OPT_REL_TOL relative L2 of the CPU run's. Then LBFGS with a
    closure on a seeded least-squares problem on the card: its loss must
    fall over three ``step`` calls of 4 iterations and end within 1e-4
    relative of the least-squares optimum (``torch.linalg.lstsq`` in f64 on
    the CPU)."""
    from paddle_tpu_torch import optimizer as opt_mod
    from paddle_tpu_torch import regularizer as reg
    from paddle_tpu_torch.models import gpt2_small
    from paddle_tpu_torch.nn import clip

    shapes = [(n, tuple(p.shape)) for n, p in
              gpt2_small(device="meta", seed=None).named_parameters()
              if n.startswith(("wte", "wpe", "blocks.0.", "ln_f"))]
    gen = torch.Generator().manual_seed(80)
    w0 = [torch.randn(s, generator=gen) * 0.02 for _, s in shapes]
    grads = [[torch.randn(s, generator=gen) * 1e-2 for _, s in shapes]
             for _ in range(3)]
    rows = []
    for label, cls, kw, master in _optimizer_cases(torch, opt_mod, reg,
                                                   clip):
        dtype = torch.bfloat16 if master else torch.float32
        runs = {}
        for where in ("cpu", dev):
            params = [torch.nn.Parameter(w.to(where, dtype, copy=True))
                      for w in w0]
            opt = cls(parameters=params, **kw)
            for step, gs in enumerate(grads):
                for p, g in zip(params, gs):
                    p.grad = g.to(where, dtype, copy=True)
                if where != "cpu" and step == len(grads) - 1:
                    torch.cuda.synchronize()
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        opt.step()
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                else:
                    opt.step()
                opt.clear_grad()
            out = [p.detach().float().cpu() for p in params]
            if master:
                state = opt.state_dict()["master_weights"]
                out += [state[f"param_{i}"].cpu() for i in range(len(params))]
            runs[str(where)] = out
        rel = max(_rel_l2(torch, a, b)
                  for a, b in zip(runs[str(dev)], runs["cpu"]))
        rows.append({"optimizer": label, "worst_rel_l2": rel})
        if not rel <= OPT_REL_TOL:
            fail(f"optimizer {label}: card and CPU differ by {rel} relative "
                 f"L2 (> {OPT_REL_TOL})")
    # LBFGS on a least-squares problem whose A has singular values in
    # about [0.4, 1.2], so that its first step (a unit step along -g)
    # already lowers the loss
    a = (torch.randn(2048, 512, generator=gen) * 0.8 / math.sqrt(2048)).to(dev)
    b = torch.randn(2048, generator=gen).to(dev)
    x = torch.nn.Parameter(torch.zeros(512, device=dev))
    lbfgs = opt_mod.LBFGS(learning_rate=1.0, max_iter=4, history_size=10,
                          parameters=[x])

    def closure():
        lbfgs.clear_grad()
        loss = 0.5 * (a @ x - b).square().sum()
        loss.backward()
        return loss

    start = closure().item()
    losses = [lbfgs.step(closure).item() for _ in range(3)]
    sol = torch.linalg.lstsq(a.double().cpu(), b.double().cpu()[:, None])
    best = 0.5 * (a.double().cpu() @ sol.solution[:, 0]
                  - b.double().cpu()).square().sum().item()
    emit({"phase": "optimizers", "params": [n for n, _ in shapes],
          "elements": sum(math.prod(s) for _, s in shapes), "steps": 3,
          "tol": OPT_REL_TOL, "cases": rows, "lbfgs_start_loss": start,
          "lbfgs_losses": losses, "lbfgs_optimum": best})
    if not (losses[2] < losses[1] < losses[0] < start
            and losses[2] <= best * (1 + 1e-4)):
        fail(f"LBFGS: losses {start} -> {losses} do not fall to the "
             f"optimum {best}")


def _lamb_schedule(opt_mod):
    return opt_mod.lr.LinearWarmup(
        opt_mod.lr.CosineAnnealingDecay(LAMB_PEAK_LR, T_max=LAMB_T_MAX),
        warmup_steps=LAMB_WARMUP, start_lr=0.0, end_lr=LAMB_PEAK_LR)


def _lamb_lr(epoch):
    """The schedule's value at ``epoch``, written out."""
    if epoch < LAMB_WARMUP:
        return LAMB_PEAK_LR * epoch / LAMB_WARMUP
    t = epoch - LAMB_WARMUP
    return LAMB_PEAK_LR * (1 + math.cos(math.pi * t / LAMB_T_MAX)) / 2


def _lamb_step_parity(torch, model, opt, loss_fn, ids, labels):
    """One more step's clipped gradients, then every parameter's Lamb
    update through the kernel and through the plain version from copies of
    the optimizer's state: the moments bit for bit, the master weights
    within 1e-6 of their largest entry, the bf16 parameters within one
    bf16 ulp and the trust ratio within 1e-6 relative."""
    from paddle_tpu_torch.ops.kernels import adamw, lamb

    loss_fn(model, False, ids, labels).backward()
    params = [p for p in model.parameters() if p.grad is not None]
    pgs = opt._grad_clip([(p, p.grad) for p in params])
    scal = adamw.adamw_scalars(opt._lr_tensor, opt._step_tensor + 1.0,
                               opt._beta1, opt._beta2)
    worst = {"master": 0.0, "param": 0.0, "trust": 0.0}
    for p, g in pgs:
        wd = 0.0 if opt._exclude_fn(p) else opt._lamb_wd
        state = [p.detach().clone(),
                 opt._accumulators["moment1"][id(p)].clone(),
                 opt._accumulators["moment2"][id(p)].clone(),
                 opt._master_weights[id(p)].clone()]
        ref = [t.clone() for t in state]
        kw = dict(beta1=opt._beta1, beta2=opt._beta2, eps=opt._epsilon,
                  wd=wd)
        t_k = lamb.lamb_update(state[0], g, state[1], state[2], scal,
                               master=state[3], **kw)
        t_p = lamb.lamb_update_plain(ref[0], g, ref[1], ref[2], scal,
                                     master=ref[3], **kw)
        torch.cuda.synchronize()
        if not (torch.equal(state[1], ref[1]) and torch.equal(state[2],
                                                              ref[2])):
            fail(f"lamb step: moments differ from the plain version")
        scale = ref[3].abs().max().item()
        worst["master"] = max(worst["master"], (state[3] - ref[3]).abs()
                              .max().item() / max(scale, 1e-30))
        err_p, tol_p = compare(torch, state[0], ref[0])
        worst["param"] = max(worst["param"], err_p / max(tol_p, 1e-30))
        worst["trust"] = max(worst["trust"],
                             abs(t_k.item() - t_p.item()) / t_p.item())
    model.zero_grad(set_to_none=True)
    if not (worst["master"] <= 1e-6 and worst["param"] <= 1.0
            and worst["trust"] <= 1e-6):
        fail(f"lamb step against the plain version: {worst}")
    return dict(worst, tensors=len(pgs))


def phase_train_lamb(torch, dev):
    """GPT-2 small at full width and depth trained with the optimizer and
    loss surface of a BERT-style large-batch recipe: ``Lamb(
    learning_rate=LinearWarmup(CosineAnnealingDecay(2e-3, T_max=8),
    warmup_steps=2, start_lr=0.0, end_lr=2e-3), lamb_weight_decay=0.01,
    exclude_from_weight_decay_fn=lambda p: p.ndim == 1,
    multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0))`` and the
    loss ``ParallelCrossEntropy()(logits, labels).mean()``, bf16 weights
    from a seed, one fixed batch of B 8 x S 1024 random tokens:
    a. loss and gradient parity (``_grad_parity`` with that loss) against
       the plain path and an f32 copy over GPT_PARITY_BATCHES batches;
    b. GPT_STEPS steps, the scheduler stepped after each: the launches of
       each step (block_epilogue and its backward 2L, flash_attention and
       its backward L, lamb one per parameter, parallel_ce once, nothing
       else), ``opt.get_lr()`` at the schedule's value before every step,
       ``opt.step()`` and the scheduler's step under
       ``set_sync_debug_mode("error")``, a finite, falling loss and the
       fresh-batch check; step time, tokens/s, MFU and peak memory;
    c. one Lamb step through the kernel against the plain version from the
       optimizer's state (``_lamb_step_parity``);
    d. a profile of one step. Returns the launches of one step."""
    from paddle_tpu_torch import optimizer as opt_mod
    from paddle_tpu_torch.distributed import ParallelCrossEntropy
    from paddle_tpu_torch.models import gpt2_small
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

    torch.cuda.reset_peak_memory_stats()
    model = gpt2_small(device=dev, dtype=torch.bfloat16, seed=0)
    cfg = model.cfg
    layers = cfg.num_layers
    gen = torch.Generator(device=dev).manual_seed(2026)
    batches = []
    for _ in range(GPT_PARITY_BATCHES):
        toks = torch.randint(0, cfg.vocab_size, (GPT_BATCH, GPT_SEQ + 1),
                             generator=gen, device=dev)
        batches.append((toks[:, :-1].contiguous(), toks[:, 1:].contiguous()))
    ids, labels = batches[0]
    ce = ParallelCrossEntropy()

    def loss_fn(net, plain, ids, labels):
        return ce(net(ids, plain=plain), labels, plain=plain).mean()

    ref = gpt2_small(device=dev, dtype=torch.float32, seed=None)
    ref.load_state_dict(model.state_dict())
    _grad_parity(torch, "gpt2_small lamb + ParallelCrossEntropy", model, ref,
                 batches, loss_fn)
    del ref, batches
    sched = _lamb_schedule(opt_mod)
    opt = opt_mod.Lamb(learning_rate=sched, lamb_weight_decay=0.01,
                       exclude_from_weight_decay_fn=lambda p: p.ndim == 1,
                       multi_precision=True, parameters=model.parameters(),
                       grad_clip=ClipGradByGlobalNorm(1.0))
    lrs = []

    def step():
        lrs.append(opt.get_lr())
        loss = loss_fn(model, False, ids, labels)
        loss.backward()
        torch.cuda.set_sync_debug_mode("error")
        try:
            opt.step()
            sched.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        opt.clear_grad()
        return loss.detach()

    n_tensors = len(list(model.parameters()))
    want = {"block_epilogue": 2 * layers, "block_epilogue_bwd": 2 * layers,
            "flash_attention": layers, "flash_attention_bwd": layers,
            "lamb": n_tensors, "parallel_ce": 1}
    losses, step_ms, launches = _train_steps(
        torch, "gpt2 lamb train", model, opt, ids, labels, GPT_STEPS, want,
        step_fn=step)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want_lrs = [_lamb_lr(e) for e in range(GPT_STEPS)]
    if any(abs(a - b) > 1e-6 * LAMB_PEAK_LR for a, b in zip(lrs, want_lrs)):
        fail(f"lamb train: learning rates {lrs}, want the schedule's "
             f"{want_lrs}")
    heldout, uniform = _heldout(torch, model, gen, cfg.vocab_size, GPT_BATCH,
                                GPT_SEQ)
    steady = step_ms[1:]
    mean_ms = sum(steady) / len(steady)
    tokens_per_s = GPT_BATCH * GPT_SEQ / mean_ms * 1e3
    fpt = model.flops_per_token(GPT_SEQ)
    step_parity = _lamb_step_parity(torch, model, opt, loss_fn, ids, labels)
    emit({"phase": "train_lamb", "model": "gpt2_small", "layers": layers,
          "hidden": cfg.hidden_size, "vocab": cfg.vocab_size,
          "params": model.num_params(non_embedding=False),
          "param_tensors": n_tensors, "batch": GPT_BATCH, "seq": GPT_SEQ,
          "losses": losses, "lrs": lrs, "schedule_lrs": want_lrs,
          "step_ms": step_ms, "step_ms_mean_after_first": mean_ms,
          "tokens_per_s": tokens_per_s, "flops_per_token": fpt,
          "mfu": tokens_per_s * fpt / BF16_TC_FLOPS_PER_S,
          "peak_memory_gb": peak_gb, "launches_per_step": launches,
          "heldout_loss": heldout, "uniform_loss": uniform,
          "lamb_step_vs_plain": step_parity, "sync_free_optimizer_step": True})
    _check_curve("gpt2 lamb train", losses, heldout, uniform)
    prof = _profile(torch, step, reps=3)
    emit({"phase": "profile", "gpt2_lamb_train_step": prof})
    return launches


# -- the incubate fused ops: masked softmax, bias-dropout-residual layer norm,
# dropout-add and the weight-gradient accumulation ---------------------------

def _pad_mask(torch, dev, batch, seq, seed):
    """An additive ``[batch, 1, seq, seq]`` bf16 padding mask: 0 before each
    sequence's length, -1e4 from it on, the lengths drawn from ``seed`` in
    [seq / 2, seq]."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lengths = torch.randint(seq // 2, seq + 1, (batch,), generator=gen,
                            device=dev)
    past = torch.arange(seq, device=dev)[None, :] >= lengths[:, None]
    mask = torch.where(past, -1e4, 0.0).to(torch.bfloat16)
    return mask[:, None, None, :].expand(batch, 1, seq, seq).contiguous(), \
        lengths


def _kernels_incubate(torch, dev, randn, timer, results):
    """The incubate kernels at the shapes of the incubate phase (GPT-2
    small: 12 heads, S 1024, B 8, hidden 768, FFN 3072) and at Llama-3-8B's
    (32 heads at S 2048; hidden 4096, FFN 14336), bf16:

    - row 18: the masked softmax at [8, 12, 1024, 1024] with a padding mask
      [8, 1, 1024, 1024] (-1e4 past each seeded length), the causal one
      there, at [2, 32, 2048, 2048] and at the incubate micro-batch's [4,
      12, 1024, 1024] (yardstick ``torch._masked_softmax`` with the
      triangle as a boolean mask, timed only where it agrees within one
      bf16 ulp), the backward at [8, 12, 1024, 1024] and [4, 12, 1024,
      1024] (yardstick ``torch._softmax_backward_data``); the causal bound
      counts x's lower triangle, which is all the kernel reads;
    - row 19: [8192, 768] with the p = 0.1 mask and maskless, the incubate
      micro-batch's [4096, 768] and [4096, 4096] with the mask, forward and
      backward (dgamma, dbeta, dbias within 1e-3 of their largest values;
      two backward calls give the same bits);
    - row 20: [8192, 768], [4096, 768] and [4096, 4096] at p = 0.1, forward
      and backward, bit for bit, the dropped positions the counter hash's;
    - row 21: GPT-2's ``mlp.fc`` (x [8192, 768], dy [8192, 3072]) and
      Llama-3-8B's gate (x [4096, 4096], dy [4096, 14336]) into f32 within
      1e-4 of the largest plain value (f32 sums in another order), and the
      ``mlp.fc`` shape once into bf16 (yardstick: ``torch.matmul(x.t(),
      dy)``, the bf16 product alone).

    Rows 18-20 within one bf16 ulp of the plain version. Bounds: each
    input read once and each output written once (the mask's distinct
    bytes once), over the memory rate; row 21's 2 M K N operations on the
    bf16 tensor cores."""
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.ops.kernels import bias_dropout_ln as bdl
    from paddle_tpu_torch.ops.kernels import dropout_add as da
    from paddle_tpu_torch.ops.kernels import linear_grad_add as lga
    from paddle_tpu_torch.ops.kernels import softmax_mask as sm

    bf = torch.bfloat16
    # row 18
    for b, h, s, masked, with_bwd in INCUBATE_SOFTMAX:
        x = randn(b, h, s, s, scale=3.0)
        lib = None
        if masked:
            mask, _ = _pad_mask(torch, dev, b, s, seed=91)
            args, name = (x, mask), "softmax_mask"
            fn, plain = sm.softmax_mask, sm.softmax_mask_plain
        else:
            mask, args, name = None, (x,), "softmax_mask_tri"
            fn, plain = sm.softmax_mask_tri, sm.softmax_mask_tri_plain
        got, ref = fn(*args), plain(*args)
        err, tol = compare(torch, got, ref)
        if not masked:
            above = torch.ones(s, s, dtype=torch.bool, device=dev).triu(1)
            lib_err, _ = compare(torch, torch._masked_softmax(x, above, 3, 0),
                                 ref)
            if lib_err <= tol:
                lib = timer(lambda: torch._masked_softmax(x, above, 3, 0))
            del above
        _record(results, name, [b, h, s, s] + (["mask", list(mask.shape)]
                                               if masked else ["causal"]),
                err, tol, timer(lambda: fn(*args)),
                timer(lambda: plain(*args), iters=5), lib,
                ("softmax_mask", f"phase3 [{b}, {h}, {s}, {s}] "
                 + ("mask" if masked else "causal")))
        if with_bwd:
            dy = randn(b, h, s, s)
            got_b = sm.softmax_mask_bwd(got, dy)
            err, tol = compare(torch, got_b, sm.softmax_mask_bwd_plain(got,
                                                                       dy))
            lib = timer(lambda: torch._softmax_backward_data(dy, got, -1,
                                                             bf))
            _record(results, "softmax_mask_bwd", [b, h, s, s], err, tol,
                    timer(lambda: sm.softmax_mask_bwd(got, dy)),
                    timer(lambda: sm.softmax_mask_bwd_plain(got, dy),
                          iters=5), lib,
                    ("softmax_mask", f"phase3 bwd [{b}, {h}, {s}, {s}]"))
            del dy, got_b
        del x, got, ref, mask, args
    # row 19
    for rows, hid, masked in INCUBATE_LN:
        x, res = randn(rows, hid), randn(rows, hid)
        bias, beta = randn(hid, scale=0.1), randn(hid, scale=0.1)
        gamma = (1.0 + randn(hid).float() * 0.1).to(bf)
        mask = IF.dropout_mask((rows, hid), 0.1, dev) if masked else None
        args = (x, bias, res, mask, gamma, beta, 1e-5)
        got, ref = bdl.bias_dropout_ln(*args), bdl.bias_dropout_ln_plain(*args)
        err_h, tol_h = compare(torch, got[1], ref[1])
        if not err_h <= tol_h:
            fail(f"bias_dropout_ln h: {err_h} > {tol_h}")
        err, tol = compare(torch, got[0], ref[0])
        shape = [rows, hid, "mask p=0.1" if masked else "maskless"]
        _record(results, "bias_dropout_ln", shape, err, tol,
                timer(lambda: bdl.bias_dropout_ln(*args)),
                timer(lambda: bdl.bias_dropout_ln_plain(*args), iters=5),
                None, ("bias_dropout_ln", f"phase3 [{rows}, {hid}] {shape[2]}"),
                h_err=err_h)
        dy = randn(rows, hid)
        bargs = (ref[1], mask, gamma, dy, 1e-5)
        gb, rb = bdl.bias_dropout_ln_bwd(*bargs), \
            bdl.bias_dropout_ln_bwd_plain(*bargs)
        err_r, tol_r = compare(torch, gb[1], rb[1])
        if not err_r <= tol_r:
            fail(f"bias_dropout_ln_bwd dres: {err_r} > {tol_r}")
        sums = {}
        for nm, a, r in zip(("dgamma", "dbeta", "dbias"), gb[2:], rb[2:]):
            e, _ = compare(torch, a, r)
            t = 1e-3 * r.abs().max().item()
            if not e <= t:
                fail(f"bias_dropout_ln_bwd {nm}: {e} > {t}")
            sums[f"{nm}_err"], sums[f"{nm}_tol"] = e, t
        again = bdl.bias_dropout_ln_bwd(*bargs)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(gb, again)):
            fail("bias_dropout_ln_bwd: two calls on the same inputs differ")
        err, tol = compare(torch, gb[0], rb[0])
        _record(results, "bias_dropout_ln_bwd", shape, err, tol,
                timer(lambda: bdl.bias_dropout_ln_bwd(*bargs)),
                timer(lambda: bdl.bias_dropout_ln_bwd_plain(*bargs),
                      iters=5), None,
                ("bias_dropout_ln", f"phase3 bwd [{rows}, {hid}] {shape[2]}"),
                dres_err=err_r, **sums)
        del x, res, mask, got, ref, dy, gb, rb, again, args, bargs
    # row 20
    for rows, hid in INCUBATE_DROPOUT:
        x, res = randn(rows, hid), randn(rows, hid)
        n = rows * hid
        got = da.dropout_add(x, res, 1234, 0.1)
        ref = da.dropout_add_plain(x, res, 1234, 0.1)
        err, tol = compare(torch, got, ref)
        if not torch.equal(got, ref):
            fail(f"dropout_add [{rows}, {hid}]: not bit for bit the plain "
                 f"version (max abs error {err})")
        ones = torch.ones_like(x)
        keep = da.keep_mask(rows, hid, 1234, 0.1, dev)
        for fn in (da.dropout_add_bwd, da.dropout_add_bwd_plain):
            bad = int(((fn(ones, 1234, 0.1) != 0) != keep).sum())
            if bad:
                fail(f"dropout_add: {fn.__name__} kept other positions than "
                     f"the counter hash at {bad} of {n} elements")
        _record(results, "dropout_add", [rows, hid, "p=0.1"], err, tol,
                timer(lambda: da.dropout_add(x, res, 1234, 0.1)),
                timer(lambda: da.dropout_add_plain(x, res, 1234, 0.1)),
                None, ("dropout_add", f"phase3 [{rows}, {hid}]"))
        got = da.dropout_add_bwd(x, 1234, 0.1)
        ref = da.dropout_add_bwd_plain(x, 1234, 0.1)
        err, tol = compare(torch, got, ref)
        if not torch.equal(got, ref):
            fail(f"dropout_add_bwd [{rows}, {hid}]: not bit for bit the "
                 f"plain version (max abs error {err})")
        _record(results, "dropout_add_bwd", [rows, hid, "p=0.1"], err, tol,
                timer(lambda: da.dropout_add_bwd(x, 1234, 0.1)),
                timer(lambda: da.dropout_add_bwd_plain(x, 1234, 0.1)),
                None, ("dropout_add", f"phase3 bwd [{rows}, {hid}]"))
        del x, res, got, ref, ones, keep
    # row 21
    for m, k, nn_, acc_name in INCUBATE_GRAD:
        acc_dt = getattr(torch, acc_name)
        x, dy = randn(m, k), randn(m, nn_)
        acc0 = randn(k, nn_, scale=4.0).to(acc_dt)
        got = lga.linear_grad_add(x, dy, acc0.clone())
        ref = lga.linear_grad_add_plain(x, dy, acc0.clone())
        if acc_dt == torch.float32:
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            tol = 1e-4 * ref.abs().max().item()
        else:
            err, tol = compare(torch, got, ref)
        scratch = acc0.clone()
        _record(results, "linear_grad_add",
                [f"x [{m}, {k}]", f"dy [{m}, {nn_}]",
                 f"acc {acc_name}"], err, tol,
                timer(lambda: lga.linear_grad_add(x, dy, scratch)),
                timer(lambda: lga.linear_grad_add_plain(x, dy, scratch),
                      iters=5),
                timer(lambda: torch.matmul(x.t(), dy)),
                ("linear_grad_add", f"phase3 x [{m}, {k}] dy [{m}, {nn_}] "
                 + ("f32" if acc_name == "float32" else "bf16")),
                library="torch.matmul(x.t(), dy), the bf16 product alone")
        del x, dy, acc0, got, ref, scratch


class _IncubateBlocks:
    """INCUBATE_LAYERS post-LN transformer blocks at GPT-2 small's width
    (hidden 768, 12 heads of 64, FFN 3072, layer-norm eps 1e-5), bf16, from
    a seed, written only with the port's public incubate entry points:

        qkv = FusedLinear(768, 2304)(x);  q, k, v = split
        s   = q @ k^T / 8
        p   = softmax_mask_fuse_upper_triangle(s)   (or softmax_mask_fuse(s,
                                                     pad_mask))
        o   = FusedLinear(768, 768, bias_attr=False)(p @ v)
        h1  = FusedBiasDropoutResidualLayerNorm(768, dropout_rate=0.1)(o, x)
        g   = FusedLinear(3072, 768)(gelu(FusedLinear(768, 3072)(h1)))
        out = FusedDropoutAdd(p=0.1)(g, h1)

    The linears' weights do not require grad: as in Paddle's ``main_grad``
    flow, a hook on each linear's output accumulates its weight and bias
    gradients by ``fused_linear_param_grad_add(x_in, dy, main_grad, dbias,
    multi_precision=True)`` into f32 buffers (``self.main``)."""

    def __init__(self, torch, dev):
        from paddle_tpu_torch.incubate import nn as inn

        self.torch = torch
        bf = torch.bfloat16
        hid = INCUBATE_HIDDEN
        gen = torch.Generator(device=dev).manual_seed(2029)
        self.layers = []
        for i in range(INCUBATE_LAYERS):
            mods = {
                "qkv": inn.FusedLinear(hid, 3 * hid, device=dev, dtype=bf,
                                       seed=4 * i),
                "out": inn.FusedLinear(hid, hid, bias_attr=False, device=dev,
                                       dtype=bf, seed=4 * i + 1),
                "ln1": inn.FusedBiasDropoutResidualLayerNorm(
                    hid, dropout_rate=INCUBATE_P, device=dev, dtype=bf),
                "fc": inn.FusedLinear(hid, 4 * hid, device=dev, dtype=bf,
                                      seed=4 * i + 2),
                "proj": inn.FusedLinear(4 * hid, hid, device=dev, dtype=bf,
                                        seed=4 * i + 3),
                "add": inn.FusedDropoutAdd(p=INCUBATE_P)}
            with torch.no_grad():
                for name in ("qkv", "fc", "proj"):
                    mods[name].bias.normal_(0.0, 0.02, generator=gen)
                for name in ("linear_bias", "ln_bias"):
                    getattr(mods["ln1"], name).normal_(0.0, 0.02,
                                                       generator=gen)
            for mod in mods.values():
                mod.requires_grad_(False)
            self.layers.append(mods)
        self.linears = [(f"{i}.{n}", m[n]) for i, m in enumerate(self.layers)
                        for n in ("qkv", "out", "fc", "proj")]
        self.reset_main()
        self.hooks = True
        self.attn0 = None

    def reset_main(self):
        torch = self.torch
        self.main = {
            name: (torch.zeros(mod.weight.shape, device=mod.weight.device),
                   None if mod.bias is None else
                   torch.zeros(mod.bias.shape, device=mod.weight.device))
            for name, mod in self.linears}

    def _linear(self, name, mod, inp, plain):
        from paddle_tpu_torch.incubate.nn import functional as IF

        out = mod(inp)
        if self.hooks:
            mg = self.main[name]

            def hook(g):
                IF.fused_linear_param_grad_add(
                    inp, g, mg[0], mg[1], multi_precision=True,
                    has_bias=mg[1] is not None, plain=plain)
            out.register_hook(hook)
        return out

    def forward(self, x, plain, pad_mask=None, keep_attn0=False):
        from paddle_tpu_torch import incubate
        from paddle_tpu_torch.nn import functional as TF

        b, s, hid = x.shape
        heads = INCUBATE_HEADS
        h = x
        for i, m in enumerate(self.layers):
            qkv = self._linear(f"{i}.qkv", m["qkv"], h, plain).reshape(
                b, s, 3, heads, hid // heads)
            q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
            sc = q @ k.transpose(-1, -2) / 8.0
            if pad_mask is None:
                p = incubate.softmax_mask_fuse_upper_triangle(sc, plain=plain)
            else:
                p = incubate.softmax_mask_fuse(sc, pad_mask, plain=plain)
            o = (p @ v).transpose(1, 2)
            if keep_attn0 and i == 0:
                self.attn0 = [t.detach() for t in (
                    qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], o)]
            o = self._linear(f"{i}.out", m["out"], o.reshape(b, s, hid),
                             plain)
            h1 = m["ln1"](o, h, plain=plain)
            f = self._linear(f"{i}.fc", m["fc"], h1, plain)
            g = self._linear(f"{i}.proj", m["proj"], TF.gelu(f), plain)
            h = m["add"](g, h1, plain=plain)
        return h


def _incubate_run(torch, blocks, xs, plain, pad_mask=None, keep_attn0=False):
    """Forward and backward of ``out.float().square().mean()`` for each
    micro-batch of ``xs`` after ``seed(INCUBATE_SEED)``, with fresh
    ``main_grad`` buffers; the draws of every dropout are logged. Returns
    (outputs, dx of each micro-batch, the main grads, the launches, host ms
    of each micro-batch to a synchronise, the logged draws)."""
    import paddle_tpu_torch
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.ops.kernels import WRAPPERS

    draws = []
    draw_mask, draw_seed = IF.dropout_mask, IF.dropout_seed

    def log(fn):
        def logged(*a):
            draws.append(fn(*a))
            return draws[-1]
        return logged
    IF.dropout_mask, IF.dropout_seed = log(draw_mask), log(draw_seed)
    try:
        blocks.reset_main()
        paddle_tpu_torch.seed(INCUBATE_SEED)
        torch.cuda.synchronize()
        for w in WRAPPERS.values():
            w.launches = 0
        outs, dxs, ms = [], [], []
        for x0 in xs:
            t0 = time.perf_counter()
            x = x0.clone().requires_grad_()
            out = blocks.forward(x, plain, pad_mask, keep_attn0)
            out.float().square().mean().backward()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(out.detach())
            dxs.append(x.grad)
        launches = {n: w.launches for n, w in WRAPPERS.items() if w.launches}
    finally:
        IF.dropout_mask, IF.dropout_seed = draw_mask, draw_seed
    return outs, dxs, blocks.main, launches, ms, draws


def _incubate_parity(torch, what, got, ref):
    """The kernel run against the plain run from the same seed: the same
    dropout draws (so the same kept positions of rows 19 and 20), each
    output within PARITY_REL_TOL of its largest plain value, dx and every
    main_grad and bias grad within TRAIN_GRAD_TOL relative L2."""
    gd, rd = got[5], ref[5]
    if len(gd) != len(rd) or not all(
            (a == b) if isinstance(a, int) else torch.equal(a, b)
            for a, b in zip(gd, rd)):
        fail(f"{what}: the kernel and plain runs drew other dropout masks "
             f"or seeds")
    out_err = 0.0
    for a, b in zip(got[0], ref[0]):
        err, _ = compare(torch, a, b)
        tol = PARITY_REL_TOL * b.float().abs().max().item()
        if not err <= tol:
            fail(f"{what}: output max abs error {err} > {tol}")
        out_err = max(out_err, err / b.float().abs().max().item())
    rel = {"dx": max(_rel_l2(torch, a, b) for a, b in zip(got[1], ref[1]))}
    for name, (w, bias) in ref[2].items():
        rel[f"{name}.weight"] = _rel_l2(torch, got[2][name][0], w)
        if bias is not None:
            rel[f"{name}.bias"] = _rel_l2(torch, got[2][name][1], bias)
    worst = max(rel, key=rel.get)
    if rel[worst] > TRAIN_GRAD_TOL:
        fail(f"{what}: {worst} relative L2 {rel[worst]} > {TRAIN_GRAD_TOL}")
    return {"out_max_err_rel": out_err, "worst_grad": worst,
            "worst_grad_rel_l2": rel[worst], "dx_rel_l2": rel["dx"],
            "draws": len(gd)}


def phase_incubate(torch, dev):
    """The incubate slice's path: ``_IncubateBlocks`` (12 layers, GPT-2
    small's width) through the port's public incubate entry points.

    (a) causal: two micro-batches of B 4 x S 1024, forward and backward of
    ``out.float().square().mean()``; (b) encoder: one batch of B 4 x S 1024
    with a [4, 1, 1024, 1024] padding mask from seeded lengths in
    [512, 1024]. Each through the kernels and, from the same seed, through
    ``plain=True``. Checks: the exact launches of every kernel ((a): 24 of
    the causal softmax, of its backward and of rows 19 and 20 forward and
    backward each, 96 of row 21; (b): 12 of the masked softmax and of its
    backward and of rows 19-20 each way, 48 of row 21, nothing else);
    parity (``_incubate_parity``); the first layer's causal attention of
    micro-batch 0 through row 18 against the flash kernel on the same q,
    k, v within 1e-2 relative L2; every main_grad of (a) against the f32
    sum of ``torch.autograd.grad`` of the same weights over the two
    micro-batches (the same draws) within TRAIN_GRAD_TOL relative L2.
    Reports ms a micro-batch on each path, peak memory and a profile of a
    micro-batch. Returns the launches of (a) and (b) together."""
    from paddle_tpu_torch.nn import functional as TF

    torch.cuda.reset_peak_memory_stats()
    layers, b, s = INCUBATE_LAYERS, INCUBATE_BATCH, INCUBATE_SEQ
    blocks = _IncubateBlocks(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(2030)
    xs = [torch.randn(b, s, INCUBATE_HIDDEN, generator=gen,
                      device=dev).to(torch.bfloat16) for _ in range(3)]
    micro, enc = xs[:2], xs[2:]

    got = _incubate_run(torch, blocks, micro, False, keep_attn0=True)
    want = {"softmax_mask_tri": 2 * layers, "softmax_mask_bwd": 2 * layers,
            "bias_dropout_ln": 2 * layers, "bias_dropout_ln_bwd": 2 * layers,
            "dropout_add": 2 * layers, "dropout_add_bwd": 2 * layers,
            "linear_grad_add": 8 * layers}
    if got[3] != want:
        fail(f"incubate (a) launches {got[3]}, want {want}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kernel_main = got[2]        # a later run fills buffers of its own
    # row 18 against flash attention (row 7) on layer 0's q, k, v
    q, k, v, o = blocks.attn0
    flash = TF.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True)
    flash_rel = _rel_l2(torch, o, flash)
    if not flash_rel <= 1e-2:
        fail(f"incubate: causal attention through row 18 lies {flash_rel} "
             f"(relative L2) from the flash kernel's")
    blocks.attn0 = None
    ref = _incubate_run(torch, blocks, micro, True)
    parity_a = _incubate_parity(torch, "incubate (a)", got, ref)
    plain_ms = ref[4]
    del ref

    # every main_grad of (a) against autograd's weight gradients, summed in
    # f32 over the two micro-batches, from the same draws
    import paddle_tpu_torch
    params = [(name, mod) for name, mod in blocks.linears]
    for _, mod in params:
        mod.requires_grad_(True)
    blocks.hooks = False
    paddle_tpu_torch.seed(INCUBATE_SEED)
    sums = {}
    for x0 in micro:
        out = blocks.forward(x0, False)
        flat = [t for _, mod in params for t in (mod.weight, mod.bias)
                if t is not None]
        grads = iter(torch.autograd.grad(out.float().square().mean(), flat))
        for name, mod in params:
            gw = next(grads).float()
            gb = None if mod.bias is None else next(grads).float()
            acc = sums.get(name)
            sums[name] = (gw, gb) if acc is None else (
                acc[0] + gw, None if gb is None else acc[1] + gb)
        del out, flat
    for _, mod in params:
        mod.requires_grad_(False)
    blocks.hooks = True
    auto_rel = {}
    for name, (gw, gb) in sums.items():
        auto_rel[f"{name}.weight"] = _rel_l2(torch, kernel_main[name][0], gw)
        if gb is not None:
            auto_rel[f"{name}.bias"] = _rel_l2(torch, kernel_main[name][1],
                                               gb)
    worst_auto = max(auto_rel, key=auto_rel.get)
    if auto_rel[worst_auto] > TRAIN_GRAD_TOL:
        fail(f"incubate: main_grad {worst_auto} lies {auto_rel[worst_auto]} "
             f"(relative L2) from autograd's sum")
    del sums

    # (b) the encoder variant with a padding mask
    pad, lengths = _pad_mask(torch, dev, b, s, seed=2031)
    enc_got = _incubate_run(torch, blocks, enc, False, pad_mask=pad)
    want_b = {"softmax_mask": layers, "softmax_mask_bwd": layers,
              "bias_dropout_ln": layers, "bias_dropout_ln_bwd": layers,
              "dropout_add": layers, "dropout_add_bwd": layers,
              "linear_grad_add": 4 * layers}
    if enc_got[3] != want_b:
        fail(f"incubate (b) launches {enc_got[3]}, want {want_b}")
    enc_ref = _incubate_run(torch, blocks, enc, True, pad_mask=pad)
    parity_b = _incubate_parity(torch, "incubate (b)", enc_got, enc_ref)
    for out in enc_got[0] + got[0]:
        if not torch.isfinite(out).all():
            fail("incubate: a non-finite output")

    launches = dict(got[3])
    for name, n in enc_got[3].items():
        launches[name] = launches.get(name, 0) + n
    emit({"phase": "incubate", "layers": layers, "hidden": INCUBATE_HIDDEN,
          "heads": INCUBATE_HEADS, "batch": b, "seq": s, "p": INCUBATE_P,
          "causal_ms_per_microbatch": got[4],
          "causal_plain_ms_per_microbatch": plain_ms,
          "encoder_ms": enc_got[4], "encoder_plain_ms": enc_ref[4],
          "encoder_lengths": lengths.tolist(),
          "launches_causal": got[3], "launches_encoder": enc_got[3],
          "parity_causal": parity_a, "parity_encoder": parity_b,
          "flash_rel_l2": flash_rel, "main_grad_vs_autograd_worst": worst_auto,
          "main_grad_vs_autograd_rel_l2": auto_rel[worst_auto],
          "peak_memory_gb": peak_gb})
    del got, enc_got, enc_ref, kernel_main

    def microbatch():
        x = micro[0].clone().requires_grad_()
        blocks.forward(x, False).float().square().mean().backward()

    def microbatch_plain():
        x = micro[0].clone().requires_grad_()
        blocks.forward(x, True).float().square().mean().backward()
    prof = _profile(torch, microbatch, reps=3)
    prof_plain = _profile(torch, microbatch_plain, reps=2)
    emit({"phase": "profile", "incubate_causal_microbatch": prof,
          "incubate_causal_microbatch_plain": prof_plain})
    return launches


# -- the rest of the incubate surface: fused_multi_transformer decoding
# through mmha, the encoder layers, the composite functions ------------------

def phase_fmt(torch, dev):
    """``incubate.nn.FusedMultiTransformer`` at GPT-2 small's widths
    (``GPTConfig()``: 12 layers, hidden 768, 12 heads of 64, FFN 3072,
    gelu, pre-LN), bf16, random weights from FMT_SEED: FMT_BATCH prompts
    of FMT_PROMPT seeded hidden states prefilled into per-layer caches
    ``[2, 8, 12, 1024, 64]``, then FMT_STEPS decode steps at ``time_step``
    512..575 (a device tensor). Gates: each step's output within FMT_TOL
    relative L2 of the one-shot 576-position prefill's at its position;
    each layer's cache rows that the decode steps wrote within FMT_TOL of
    the rows the one-shot prefill wrote into caches of its own, and the
    rows past them still zero; exactly one mmha launch a layer a step and
    nothing else; no host sync in a step (``set_sync_debug_mode("error")``
    around the second step); the caches the caller's tensors, updated in
    place; layer 0's caches through the contiguous entry within one bf16
    ulp of ``reference_mmha`` on the same buffers; the last step through
    the kernels within one bf16 ulp of the same step with ``plain=True``.
    A control, the last step written one position early (``time_step``
    574 on a copy of the caches), reports how far such a fault moves the
    output and the cache rows, and fails the phase if the cache gate would
    not see it. Reports the prefill ms, the decode step's wall and device
    ms (a profile of the last step) and its launches. Returns the
    launches of the decode steps together."""
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.ops.kernels import WRAPPERS, mmha

    cfg = GPTConfig()
    e, h, layers = cfg.hidden_size, cfg.num_heads, cfg.num_layers
    hd, b, s0, steps = e // h, FMT_BATCH, FMT_PROMPT, FMT_STEPS
    bf = torch.bfloat16
    torch.cuda.reset_peak_memory_stats()
    model = FusedMultiTransformer(e, h, cfg.ffn_size, activation="gelu",
                                  normalize_before=True, num_layers=layers,
                                  device=dev, dtype=bf, seed=FMT_SEED).eval()
    gen = torch.Generator(device=dev).manual_seed(FMT_SEED)
    xs = torch.randn(b, s0 + steps, e, generator=gen, device=dev).to(bf)
    caches = [torch.zeros(2, b, h, FMT_CACHE, hd, dtype=bf, device=dev)
              for _ in range(layers)]
    given = list(caches)
    ts = torch.arange(s0, s0 + steps, dtype=torch.int32, device=dev)
    rows = slice(s0, s0 + steps)

    def cache_rel(got):
        """The worst layer's relative L2 over the decode steps' rows."""
        return max(_rel_l2(torch, g[:, :, :, rows], r[:, :, :, rows])
                   for g, r in zip(got, ref_caches))

    with torch.no_grad():
        ref_caches = [torch.zeros_like(c) for c in caches]
        # one-shot, 576 positions, into caches of its own
        ref, ref_caches = model(xs, caches=ref_caches)
        torch.cuda.synchronize()
        for w in WRAPPERS.values():
            w.launches = 0
        t0 = time.perf_counter()
        out, caches = model(xs[:, :s0], caches=caches)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_launches = {n: w.launches for n, w in WRAPPERS.items()
                            if w.launches}
        pre_rel = _rel_l2(torch, out, ref[:, :s0])
        rels, walls, total = [], [], {}
        for i in range(steps):
            torch.cuda.synchronize()
            for w in WRAPPERS.values():
                w.launches = 0
            t0 = time.perf_counter()
            if i == 1:
                torch.cuda.set_sync_debug_mode("error")
            try:
                out, caches = model(xs[:, s0 + i:s0 + i + 1], caches=caches,
                                    time_step=ts[i:i + 1])
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            got = {n: w.launches for n, w in WRAPPERS.items() if w.launches}
            if got != {"mmha": layers}:
                fail(f"fmt decode step {i}: launches {got}, want mmha "
                     f"{layers}")
            for n, k in got.items():
                total[n] = total.get(n, 0) + k
            rels.append(_rel_l2(torch, out, ref[:, s0 + i:s0 + i + 1]))
            if not torch.isfinite(out).all():
                fail(f"fmt decode step {i}: a non-finite output")
        if any(c is not g for c, g in zip(caches, given)):
            fail("fmt: the returned caches are not the caller's tensors")
        cache_worst = cache_rel(caches)
        untouched = all(not c[:, :, :, s0 + steps:].any() for c in caches)
        # the strided kernel against the reference on layer 0's buffers
        q = torch.randn(b, 1, h, hd, generator=gen, device=dev).to(bf)
        pos = torch.full((b,), s0 + steps - 1, dtype=torch.int32, device=dev)
        kb, vb = caches[0][0], caches[0][1]
        err, tol = compare(torch, mmha.mmha_decode_contiguous(q, kb, vb, pos),
                           mmha.reference_mmha(q, kb, vb, pos))
        x_last, t_last = xs[:, -1:], ts[-1:]
        plain_out = model(x_last, caches=caches, time_step=t_last,
                          plain=True)[0]
        kern_out = model(x_last, caches=caches, time_step=t_last)[0]
        kern_plain = _rel_l2(torch, kern_out, plain_out)
        kp_err, kp_tol = compare(torch, kern_out, plain_out)
        kp_same = torch.equal(kern_out, plain_out)
        ctrl = [c.clone() for c in caches]
        ctrl_out = model(x_last, caches=ctrl, time_step=t_last - 1)[0]
        ctrl_rel = _rel_l2(torch, ctrl_out, ref[:, -1:])
        ctrl_cache = cache_rel(ctrl)
        del ctrl
        prof = _profile(torch, lambda: model(x_last, caches=caches,
                                             time_step=t_last), reps=10)
    worst = max(range(steps), key=lambda i: rels[i])
    emit({"phase": "fmt", "layers": layers, "hidden": e, "heads": h,
          "batch": b, "prompt": s0, "steps": steps, "cache": FMT_CACHE,
          "cache_mb": sum(c.numel() for c in caches) * 2 / 1e6,
          "prefill_ms": prefill_ms, "prefill_launches": prefill_launches,
          "prefill_rel_l2": pre_rel,
          "decode_step_wall_ms_mean": sum(walls) / steps,
          "decode_step_wall_ms_median": sorted(walls)[steps // 2],
          "decode_step_device_ms": prof.get("busy_ms_per_call"),
          "launches_a_step": {"mmha": total.get("mmha", 0) / steps},
          "decode_rel_l2_worst": rels[worst], "worst_step": worst,
          "decode_rel_l2_mean": sum(rels) / steps, "tol": FMT_TOL,
          "mmha_vs_reference": {"max_abs_err": err, "tol": tol},
          "cache_rel_l2_worst_layer": cache_worst,
          "cache_rows_past_decode_zero": untouched,
          "kernel_vs_plain_decode": {"rel_l2": kern_plain,
                                     "max_abs_err": kp_err, "tol": kp_tol,
                                     "same_bits": kp_same},
          "control_shifted_write": {"decode_rel_l2": ctrl_rel,
                                    "cache_rel_l2_worst_layer": ctrl_cache},
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    emit({"phase": "profile", "fmt_decode_step": prof})
    if not pre_rel <= FMT_TOL:
        fail(f"fmt: the prefill lies {pre_rel} (relative L2) from the "
             f"one-shot prefill's first {s0} positions")
    if not rels[worst] <= FMT_TOL:
        fail(f"fmt: decode step {worst} lies {rels[worst]} (relative L2) "
             f"from the one-shot prefill (tol {FMT_TOL})")
    if not err <= tol:
        fail(f"fmt: the contiguous mmha lies {err} from reference_mmha "
             f"(tol {tol})")
    if not kp_err <= kp_tol:
        fail(f"fmt: the kernel decode lies {kp_err} from the plain decode "
             f"on the same caches (tol {kp_tol})")
    if not cache_worst <= FMT_TOL:
        fail(f"fmt: the decode steps' cache rows lie {cache_worst} "
             f"(relative L2) from the one-shot prefill's (tol {FMT_TOL})")
    if not untouched:
        fail("fmt: a decode step wrote cache rows past its time_step")
    if not ctrl_cache > FMT_TOL:
        fail(f"fmt: a write one position early moves the cache rows only "
             f"{ctrl_cache}: the cache gate (tol {FMT_TOL}) cannot see it")
    return total


def phase_encoder(torch, dev):
    """ENC_LAYERS ``incubate.nn.FusedTransformerEncoderLayer`` s at
    BERT-base's published widths (hidden 768, 12 heads, FFN 3072, post-LN,
    gelu), bf16, B 8 x S 512, forward and backward of
    ``(out.float() * c).square().mean()`` with fixed seeded channel weights
    ``c`` (a post-LN output's mean square is 1 whatever the weights, so
    its gradients would be rounding noise), twice: (a) no mask, dropout 0: flash
    attention forward and backward, exactly 12 + 12 launches and nothing
    else; (b) a padding mask from seeded lengths and
    ``attn_dropout_rate=ENC_ATTN_DROPOUT``: the SDPA composite, no launch.
    Each held to its plain path and an f32 copy by ``_grad_parity`` (the
    dropout draws reseeded before every forward, so all three see the same
    masks), over ENC_PARITY_BATCHES seeded batches. Reports the step ms
    of each and a profile of a step. Returns the launches of (a)."""
    import copy

    import paddle_tpu_torch
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer
    from paddle_tpu_torch.ops.kernels import WRAPPERS

    class Encoder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layers = torch.nn.ModuleList(
                FusedTransformerEncoderLayer(
                    ENC_HIDDEN, ENC_HEADS, ENC_FFN, dropout_rate=0.0,
                    activation="gelu", attn_dropout_rate=0.0,
                    normalize_before=False, device=dev, dtype=torch.bfloat16,
                    seed=ENC_SEED + i) for i in range(ENC_LAYERS))

        def forward(self, x, mask=None, plain=False):
            for layer in self.layers:
                x = layer(x, src_mask=mask, plain=plain)
            return x

        def attn_dropout(self, p):
            for layer in self.layers:
                layer.fused_attn.attn_dropout_rate = p

    torch.cuda.reset_peak_memory_stats()
    model = Encoder().train()
    ref = copy.deepcopy(model).float()
    gen = torch.Generator(device=dev).manual_seed(ENC_SEED)
    xs = [torch.randn(ENC_BATCH, ENC_SEQ, ENC_HIDDEN, generator=gen,
                      device=dev) for _ in range(ENC_PARITY_BATCHES)]
    x = xs[0]
    chan = torch.randn(ENC_HIDDEN, generator=gen, device=dev)
    pad, lengths = _pad_mask(torch, dev, ENC_BATCH, ENC_SEQ, ENC_SEED)

    def loss_of(mask):
        def loss_fn(net, plain, xin, _):
            paddle_tpu_torch.seed(ENC_SEED)
            dt = next(net.parameters()).dtype
            m = None if mask is None else mask.to(dt)
            out = net(xin.to(dt), m, plain)
            return (out.float() * chan).square().mean()
        return loss_fn

    def step(mask):
        loss_of(mask)(model, False, x, None).backward()
        model.zero_grad(set_to_none=True)

    rows = {}
    for label, mask, p in (("a", None, 0.0), ("b", pad, ENC_ATTN_DROPOUT)):
        model.attn_dropout(p)
        ref.attn_dropout(p)
        torch.cuda.synchronize()
        for w in WRAPPERS.values():
            w.launches = 0
        step(mask)
        torch.cuda.synchronize()
        got = {n: w.launches for n, w in WRAPPERS.items() if w.launches}
        want = {"flash_attention": ENC_LAYERS,
                "flash_attention_bwd": ENC_LAYERS} if mask is None else {}
        if got != want:
            fail(f"encoder ({label}) launches {got}, want {want}")
        rows[label] = {"launches": got}
        _grad_parity(torch, f"encoder ({label})", model, ref,
                     [(xb, None) for xb in xs], loss_fn=loss_of(mask))
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(mask)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        rows[label]["step_ms"] = walls
        rows[label]["profile"] = _profile(torch, lambda: step(mask), reps=2)
    model.attn_dropout(0.0)
    emit({"phase": "encoder", "layers": ENC_LAYERS, "hidden": ENC_HIDDEN,
          "heads": ENC_HEADS, "ffn": ENC_FFN, "batch": ENC_BATCH,
          "seq": ENC_SEQ, "attn_dropout_b": ENC_ATTN_DROPOUT,
          "lengths_b": lengths.tolist(),
          **{f"step_ms_{k}": v["step_ms"] for k, v in rows.items()},
          **{f"launches_{k}": v["launches"] for k, v in rows.items()},
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    emit({"phase": "profile", "encoder_step_a": rows["a"]["profile"],
          "encoder_step_b": rows["b"]["profile"]})
    return rows["a"]["launches"]


def _incubate_cases(torch, rng):
    """Each composite function of ``incubate.nn.functional`` (and the
    masked SDPA) at a small shape: ``(name, fn, args, kwargs)`` with numpy
    f32 operands, made from ``rng``."""
    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype("float32")

    ilens = rng.integers(1, 40, (3,)).astype("int32")
    kvlens = ilens.copy()
    kvlens[1] = 0                              # a row with no valid key
    mask_mha = (rng.uniform(size=(2, 1, 1, 24)) < 0.2) * -1e4
    return [
        ("scaled_dot_product_attention (mask, GQA)",
         "nn.functional.scaled_dot_product_attention",
         (r(2, 24, 4, 32), r(2, 24, 2, 32), r(2, 24, 2, 32)),
         dict(attn_mask=r(2, 4, 24, 24), is_causal=True)),
        ("memory_efficient_attention (bias, 2 chunks)",
         "memory_efficient_attention",
         (r(2, 600, 4, 32), r(2, 600, 4, 32), r(2, 600, 4, 32)),
         dict(attn_bias=r(2, 4, 600, 600))),
        ("variable_length_memory_efficient_attention (GQA, causal)",
         "variable_length_memory_efficient_attention",
         (r(3, 4, 40, 32), r(3, 2, 40, 32), r(3, 2, 40, 32), ilens, kvlens),
         dict(causal=True)),
        ("masked_multihead_attention",
         "masked_multihead_attention", (r(4, 3 * 4 * 32),),
         dict(cache_kv=r(2, 4, 4, 64, 32), bias=r(3, 4, 32),
              src_mask=r(4, 1, 1, 64),
              sequence_lengths=rng.integers(0, 64, (4, 1)).astype("int32"))),
        ("fused_multi_head_attention (pre-LN, mask)",
         "fused_multi_head_attention",
         (r(2, 24, 64), r(3, 4, 16, 64, scale=0.1), r(64, 64, scale=0.1)),
         dict(pre_layer_norm=True, qkv_bias=r(3, 4, 16),
              linear_bias=r(64), attn_mask=mask_mha.astype("float32"),
              training=False)),
        ("fused_feedforward (post-LN, gelu)", "fused_feedforward",
         (r(2, 24, 64), r(64, 256, scale=0.1), r(256, 64, scale=0.1)),
         dict(linear1_bias=r(256), linear2_bias=r(64), activation="gelu",
              training=False)),
        ("fused_gate_attention (merged qkv)", "fused_gate_attention",
         (r(2, 3, 24, 64),),
         dict(qkv_weight=r(3, 4, 16, 64, scale=0.1),
              gate_linear_weight=r(64, 4, 16, scale=0.1),
              gate_linear_bias=r(4, 16), out_linear_weight=r(4, 16, 64,
                                                             scale=0.1),
              out_linear_bias=r(64), nonbatched_bias=r(2, 1, 4, 24, 24))),
        ("fused_ec_moe (gelu)", "fused_ec_moe",
         (r(2, 32, 64), r(2, 32, 8), r(8, 64, 128, scale=0.1), r(8, 1, 128),
          r(8, 128, 64, scale=0.1), r(8, 1, 64), "gelu"), {}),
    ]


def phase_incubate_functions(torch, dev):
    """Each composite function of ``incubate.nn.functional`` and the
    masked SDPA (:func:`_incubate_cases`) on the card against the same call
    on the CPU, the same f32 inputs: the largest absolute difference within
    INCUBATE_FN_TOL of the largest CPU magnitude, every output finite, and
    no kernel launched (these are composites; the SDPA case has a
    mask)."""
    import numpy as np

    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.kernels import WRAPPERS

    def resolve(name):
        return F.scaled_dot_product_attention if name.startswith("nn.") \
            else getattr(IF, name)

    def on(where, v):
        return torch.from_numpy(v).to(where) if isinstance(v, np.ndarray) \
            else v

    rows = []
    for label, name, args, kw in _incubate_cases(torch,
                                                 np.random.default_rng(42)):
        outs = {}
        for where in ("cpu", dev):
            for w in WRAPPERS.values():
                w.launches = 0
            out = resolve(name)(*(on(where, a) for a in args),
                                **{k: on(where, v) for k, v in kw.items()})
            outs[str(where)] = [t.float().cpu() for t in
                                (out if isinstance(out, tuple) else (out,))]
            if any(w.launches for w in WRAPPERS.values()):
                fail(f"incubate_functions {label}: a kernel launched")
        errs = []
        for got, want in zip(outs[str(dev)], outs["cpu"]):
            if not torch.isfinite(got).all():
                fail(f"incubate_functions {label}: a non-finite output")
            errs.append(((got - want).abs().max().item(),
                         INCUBATE_FN_TOL * want.abs().max().item()))
        rows.append({"function": label, "max_abs_err": [e for e, _ in errs],
                     "tol": [t for _, t in errs]})
        if not all(e <= t for e, t in errs):
            fail(f"incubate_functions {label}: card against CPU {errs}")
    emit({"phase": "incubate_functions", "rows": rows})


# -- Qwen2-MoE: the grouped expert product, serving, parity and training -------

def _kernels_moe_gemm(torch, dev, randn, timer, results):
    """The grouped expert product at one Qwen1.5-MoE layer's shapes at
    n = MOE_TOKENS tokens (60 experts, top-4, capacity factor 2.0: capacity
    ``ceil(2 * n * 4 / 60)``), bf16: gate/up ``[60, C, 2048] @ [60, 2048,
    1408]``, down ``[60, C, 1408] @ [60, 1408, 2048]`` and the backward's
    dx ``[60, C, 1408] @ w_up^T``, the weight read as the transposed view
    of the forward's ``[60, 2048, 1408]`` stack; then gate/up and dx at
    train_moe's capacity (B 2 x S 2048 = 4096 tokens: 547). Counts from a
    seeded skewed draw (``moe_gemm.skewed_counts``, the analysis phase's
    examples' counts) with an empty and a full expert; every padding row of
    x is random. Within one bf16 ulp of the plain version, exactly zero
    past each count, and the same bits on a second call. Bound: the weights of the experts
    with a live row read once, the live rows of x read once, the whole
    output written once, over the memory rate; against ``2 * sum(counts) *
    H * F`` operations on the bf16 tensor cores. Yardstick, timed only:
    ``torch.bmm`` on x with its padding rows zeroed (the dense einsum XLA
    runs without the kernel)."""
    from paddle_tpu_torch.ops.kernels import moe_gemm

    e, k, h, f = 60, 4, 2048, 1408
    w_gate = randn(e, h, f, scale=0.02)
    w_down = randn(e, f, h, scale=0.02)
    for n, labels in ((MOE_TOKENS, ("gate/up", "down", "dx, w^T")),
                      (TRAIN_BATCH * TRAIN_SEQ, ("gate/up", "dx, w^T"))):
        cap = math.ceil(2.0 * n * k / e)
        counts = moe_gemm.skewed_counts(e, n * k, cap, seed=81).to(dev)
        live = moe_gemm.live_rows(counts, cap)
        x = randn(e, cap, h)
        act = randn(e, cap, f)
        cases = {"gate/up": (x, w_gate, f"gate/up [60, {cap}, 2048] @ "
                             f"[60, 2048, 1408]"),
                 "down": (act, w_down, f"down [60, {cap}, 1408] @ "
                          f"[60, 1408, 2048]"),
                 "dx, w^T": (act, w_gate.transpose(1, 2),
                             f"dx [60, {cap}, 1408] @ [60, 2048, 1408]^T")}
        rows_live = int(counts.sum())
        experts_live = int((counts > 0).sum())
        for label in labels:
            a, w, sheet = cases[label]
            got = moe_gemm.grouped_matmul(a, w, counts)
            ref = moe_gemm.grouped_matmul_plain(a, w, counts)
            err, tol = compare(torch, got, ref)
            if got.masked_select(~live).any():
                fail(f"moe_gemm {label}: non-zero output past the counts")
            again = moe_gemm.grouped_matmul(a, w, counts)
            if not torch.equal(again, got):
                fail(f"moe_gemm {label}: two calls on the same inputs differ")
            padded = torch.where(live, a, torch.zeros((), dtype=a.dtype,
                                                      device=dev))
            lib = timer(lambda: torch.bmm(padded, w))
            _record(results, "moe_gemm",
                    [label, list(a.shape), list(w.shape), "counts", rows_live],
                    err, tol,
                    timer(lambda: moe_gemm.grouped_matmul(a, w, counts)),
                    timer(lambda: moe_gemm.grouped_matmul_plain(a, w, counts),
                          iters=5), lib, ("moe_gemm", f"phase3 {sheet}"),
                    capacity=cap, experts_live=experts_live,
                    weight_layout="[E, F, H] viewed as [E, H, F]"
                    if not w.is_contiguous() else "[E, H, F]")
            del got, ref, again, padded
        del x, act
    del w_gate, w_down


def _moe_path_launches(layers, forwards=1, train=False):
    """The kernel launches of ``forwards`` Qwen2-MoE forwards (with
    ``train``, one train step) at ``layers`` MoE layers on the layer loop:
    rms_norm 2L+1, rope L (one q+k launch a layer; 2L with the backward,
    RoPE's backward being its forward with the sign flag), flash attention
    L, swiglu 2L (the shared expert and the
    routed experts' gate), the grouped product 3L (6L with the backward's
    dx); with ``train``, the backward kernels of each."""
    want = {"rms_norm": 2 * layers + 1, "rope": layers,
            "flash_attention": layers, "swiglu": 2 * layers,
            "moe_gemm": 3 * layers}
    if train:
        want["rope"] *= 2
        want["moe_gemm"] *= 2
        want.update({"rms_norm_bwd": 2 * layers + 1, "swiglu_bwd": 2 * layers,
                     "flash_attention_bwd": layers})
    return {n: c * forwards for n, c in want.items()}


def _moe_prompts(torch, dev, vocab):
    gen = torch.Generator(device=dev).manual_seed(2027)
    return torch.randint(0, vocab, (MOE_REQUESTS, MOE_PROMPT), generator=gen,
                         device=dev)


def _kept_log(model):
    """Forward hooks on every MoE layer that log each call's kept slots and
    routed slots by layer. Returns (log, hook handles)."""
    log = {}

    def hook_of(i):
        def hook(mod, inp, _out):
            n = inp[0].numel() // inp[0].shape[-1]
            log.setdefault(i, []).append((mod.counts.sum(), n * mod.top_k))
        return hook
    handles = [layer.mlp.register_forward_hook(hook_of(i))
               for i, layer in enumerate(model.layers)
               if not getattr(layer, "is_dense", True)]
    return log, handles


def _drop_share(log):
    """Per MoE layer, the share of routed slots dropped by capacity over
    every logged call."""
    return {i: 1.0 - sum(int(c) for c, _ in calls) / sum(r for _, r in calls)
            for i, calls in log.items()}


class _GateTap:
    """Forward hooks on every MoE layer's gate. Each call's output (the
    router logits) is kept by layer in ``out``; a layer found in ``pin``
    has its gate's output replaced by the value of ``pin[layer]``, so that
    a forward routes every token as the run that produced those logits
    did. The replacement is ``pin + (out - out.detach())``: exactly
    ``pin``'s value, and the cotangent still reaches the gate."""

    def __init__(self, model):
        self.out, self.pin = {}, {}
        self.top_k = {}
        self.handles = []
        for i, layer in enumerate(model.layers):
            if not getattr(layer, "is_dense", True):   # ERNIE's Llama layers
                self.top_k[i] = layer.mlp.top_k
                self.handles.append(
                    layer.mlp.gate.register_forward_hook(self._hook(i)))

    def _hook(self, i):
        def hook(_mod, _inp, out):
            if i in self.pin:
                return self.pin[i].to(out.dtype) + (out - out.detach())
            self.out[i] = out.detach()
        return hook

    def sets(self, i, logits):
        """Each token's top-k expert set (sorted) of router ``logits``."""
        probs = logits.float().softmax(-1)
        return probs.topk(self.top_k[i], dim=-1).indices.sort(-1).values

    def flips(self, i, a, b):
        """Tokens whose top-k sets under logits ``a`` and ``b`` differ."""
        return int((self.sets(i, a) != self.sets(i, b)).any(-1).sum())

    def remove(self):
        for h in self.handles:
            h.remove()


def phase_serve_moe(torch, dev):
    """Qwen1.5-MoE-A2.7B at full width and depth (``Qwen2MoeConfig()``: 24
    layers, 60 experts of 1408, top-4, a shared expert of 5632, vocab
    151936; 14.3 B parameters, 28.6 GB in bf16, random weights from a
    seed) answers MOE_REQUESTS prompts of MOE_PROMPT seeded random tokens
    with MOE_NEW_TOKENS greedy tokens each through ``model.generate``, the
    exact-length host loop: one whole forward per emitted token. Every
    kernel count is set to 0 just before and read just after; the run must
    launch exactly the layer loop's kernels (``_moe_path_launches``) per
    forward, the grouped product 3 x 24 times, nothing else. Forward hooks
    time each forward with CUDA events (nothing synchronises inside the
    loop) and log each MoE layer's kept slots. Reports generated tokens/s,
    the first forward's ms (the prompt, B x S tokens) and the mean of the
    rest, peak memory, each layer's share of routed slots dropped by
    capacity, and a profile of the prompt's forward. Returns (model,
    prompts, generated buffer, launches of the run)."""
    from paddle_tpu_torch.models import Qwen2Moe, Qwen2MoeConfig
    from paddle_tpu_torch.ops.kernels import WRAPPERS

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Qwen2Moe(Qwen2MoeConfig(), device=dev, dtype=torch.bfloat16,
                     seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = model.cfg
    prompts = _moe_prompts(torch, dev, cfg.vocab_size)
    kept, kept_hooks = _kept_log(model)
    marks = []

    def pre(_mod, _inp):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append([ev, None, WRAPPERS["moe_gemm"].launches])

    def post(_mod, _inp, _out):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[-1][1] = ev
        marks[-1][2] = WRAPPERS["moe_gemm"].launches - marks[-1][2]

    hooks = [model.register_forward_pre_hook(pre),
             model.register_forward_hook(post)]
    torch.cuda.synchronize()
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = model.generate(prompts, max_new_tokens=MOE_NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: w.launches for n, w in WRAPPERS.items()}
    for h in hooks:
        h.remove()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd_ms = [a.elapsed_time(b) for a, b, _ in marks]
    per_fwd = [c for _, _, c in marks]
    drops = _drop_share(kept)
    for h in kept_hooks:
        h.remove()
    want = _moe_path_launches(cfg.num_layers, len(marks))
    got = {n: c for n, c in launches.items() if c}
    new = out[:, MOE_PROMPT:]
    emit({"phase": "serve_moe", "model": "qwen2_moe (Qwen1.5-MoE-A2.7B)",
          "layers": cfg.num_layers, "hidden": cfg.hidden_size,
          "experts": cfg.num_experts, "top_k": cfg.num_experts_per_tok,
          "vocab": cfg.vocab_size, "params": model.num_params(),
          "activated_params": model.num_activated_params(),
          "build_s": build_s, "requests": MOE_REQUESTS,
          "prompt": MOE_PROMPT, "new_tokens": MOE_NEW_TOKENS,
          "wall_s": wall,
          "tokens_per_s": MOE_REQUESTS * MOE_NEW_TOKENS / wall,
          "forwards": len(marks), "first_forward_ms": fwd_ms[0],
          "rest_forward_ms_mean": sum(fwd_ms[1:]) / max(len(fwd_ms) - 1, 1),
          "forward_ms": fwd_ms, "moe_gemm_per_forward": sorted(set(per_fwd)),
          "peak_memory_gb": peak_gb, "drop_share_by_layer": drops,
          "launches": got})
    if tuple(out.shape) != (MOE_REQUESTS, MOE_PROMPT + MOE_NEW_TOKENS) or \
            not torch.equal(out[:, :MOE_PROMPT], prompts) or \
            not bool(((new >= 0) & (new < cfg.vocab_size)).all()):
        fail(f"serve_moe: generated buffer {tuple(out.shape)} is not the "
             f"prompts followed by {MOE_NEW_TOKENS} tokens of the vocab")
    if len(marks) != MOE_NEW_TOKENS or \
            set(per_fwd) != {3 * cfg.num_layers} or got != want:
        fail(f"serve_moe: {len(marks)} forwards, moe_gemm per forward "
             f"{sorted(set(per_fwd))} (want {3 * cfg.num_layers}), launches "
             f"{got}, want {want}")
    with torch.no_grad():
        prof = _profile(torch, lambda: model(prompts), reps=2)
    emit({"phase": "profile", "qwen2_moe_prompt_forward": prof})
    return model, prompts, out, launches


def phase_parity_moe(torch, model, prompts, served, name="qwen2_moe"):
    """Qwen1.5-MoE at full width, the kernel path against ``plain=True``,
    over the prompts:
    a. every layer on the same input: forward hooks capture, on the plain
       path, each layer's input and output, its MoE block's input and
       output and its gate's output. Each MoE block runs through the
       kernels on its captured input (the gate is the same product on
       both paths, so the routing is identical), and each whole layer on
       its captured input with its gate's output pinned to the captured one
       (``_GateTap``: the routing identical again); both within
       MOE_BLOCK_TOL. The whole layer runs once more unpinned, and the
       tokens whose top-k set then differs are counted;
    b. end to end: the kernel path's forward, its gates' outputs kept; the
       plain path with every gate's output pinned to the kernel path's, so
       both route every token alike: each prompt's last-position logits
       within PARITY_REL_TOL (5% of the largest plain logit). Free running
       (reported, not held: a bf16 near-tie at the top-k boundary flips a
       token's experts, and the flip spreads through the later layers;
       PERF.md §6, Qwen2-MoE): the plain path's own logits against the kernel
       path's and the tokens whose top-k set differs, by layer;
    c. the first served token of each prompt is the kernel path's argmax
       (the same computation as the served run's first forward)."""
    tap = _GateTap(model)
    captured = {}

    def grab(i, what):
        def hook(_mod, inp, out):
            captured.setdefault(i, {})[what] = (inp[0], out)
        return hook

    hooks = []
    for i, layer in enumerate(model.layers):
        hooks.append(layer.register_forward_hook(grab(i, "layer")))
        hooks.append(layer.mlp.register_forward_hook(grab(i, "mlp")))
    with torch.no_grad():
        lp = model(prompts, plain=True)[:, -1].float()
        for h in hooks:
            h.remove()
        plain_gates = dict(tap.out)
        cos, sin = model.rope(prompts.shape[1])
        rows = []
        for i, layer in enumerate(model.layers):
            x_in, y_plain = captured[i]["mlp"]
            blk = _tol_row(torch, layer.mlp(x_in), y_plain)
            x_in, h_plain = captured[i]["layer"]
            tap.pin = {i: plain_gates[i]} if i in plain_gates else {}
            whole = _tol_row(torch, layer(x_in, cos, sin), h_plain)
            tap.pin = {}
            row = {"index": i, "moe_block": blk, "whole_layer_pinned": whole}
            if i in plain_gates:
                layer(x_in, cos, sin)
                row["tokens_flipped_unpinned"] = tap.flips(
                    i, tap.out[i], plain_gates[i])
            rows.append(row)
        del captured
        lk = model(prompts)[:, -1].float()
        kernel_gates = dict(tap.out)
        tap.pin = kernel_gates
        lpp = model(prompts, plain=True)[:, -1].float()
        tap.pin = {}
    flips = {i: tap.flips(i, kernel_gates[i], plain_gates[i])
             for i in plain_gates}
    tap.remove()
    first_flip = next((i for i in sorted(flips) if flips[i]), None)
    pinned = [_parity_row(torch, r, MOE_PROMPT, lk[r], lpp[r])
              for r in range(lk.shape[0])]
    free = [_parity_row(torch, r, MOE_PROMPT, lk[r], lp[r])
            for r in range(lk.shape[0])]
    served_first = served[:, MOE_PROMPT].tolist()
    emit({"phase": "parity_moe", "model": name, "block_tol": MOE_BLOCK_TOL,
          "per_layer": rows, "e2e_pinned": pinned,
          "e2e_free_running": free,
          "free_running_tokens_flipped_by_layer": flips,
          "free_running_first_layer_with_flips": first_flip,
          "first_served_token_is_kernel_argmax":
              served_first == lk.argmax(-1).tolist()})
    bad = [r for r in rows if not (r["moe_block"]["ok"]
                                   and r["whole_layer_pinned"]["ok"])]
    if bad:
        fail(f"parity_moe (a): layers {[r['index'] for r in bad]} outside "
             f"{MOE_BLOCK_TOL}: {bad[0]}")
    for r in pinned:
        if not r["max_abs_err"] <= r["tol"]:
            fail(f"parity_moe (b): request {r['request']}: last-position "
                 f"logits with the routing pinned differ by "
                 f"{r['max_abs_err']} > {r['tol']}")
    if served_first != lk.argmax(-1).tolist():
        fail(f"parity_moe (c): first served tokens {served_first} are not "
             f"the kernel path's argmax {lk.argmax(-1).tolist()}")


def _tol_row(torch, got, ref):
    """Max abs and relative L2 error of ``got`` against ``ref``, held to
    MOE_BLOCK_TOL: max abs <= MOE_BLOCK_TOL x the largest |ref|."""
    d = got.float() - ref.float()
    scale = ref.float().abs().max().item()
    err = d.abs().max().item()
    return {"max_abs_err": err, "max_abs_ref": scale,
            "rel_l2": (d.norm() / ref.float().norm()).item(),
            "ok": err <= MOE_BLOCK_TOL * scale}


def phase_train_moe(torch, dev):
    """Qwen1.5-MoE's widths trained at MOE_TRAIN_LAYERS layers (24 cut to 4:
    bf16 weights and grads, f32 master weights and both moments, 2.90 B
    parameters, 46.5 GB): ``Qwen2MoeConfig(num_layers=4)`` in bf16 from a
    seed, ``AdamW(1e-4, weight_decay=0.01, multi_precision=True,
    grad_clip=ClipGradForMOEByGlobalNorm(1.0))`` (each ``[E, ...]`` expert
    stack one parameter, one AdamW launch), one fixed batch of B 2 x S
    2048 random tokens (n = 4096 tokens a layer, capacity 547):
    a. parity (``_grad_parity``) of the loss (the cross entropy plus
       ``router_aux_loss_coef * l_aux``) and of every gradient with the
       plain path and an f32 copy over MOE_PARITY_BATCHES batches, with
       the routing pinned: the plain path's and the f32 copy's gates give
       the kernel path's router logits (``_GateTap``; their cotangent
       still reaches the gate), so the three route every token alike and
       differ in their arithmetic only. Free running, a bf16 near-tie at
       the top-k boundary routes a token apart (PERF.md §6, Qwen2-MoE): that
       run holds the loss and the f32 ratio of every gradient and reports
       the gradients' distance from the plain path's;
    b. TRAIN_STEPS steps, each one's launches the layer loop's forward and
       backward kernels (``_moe_path_launches(train=True)``) and adamw one
       per parameter (14L+3), nothing else; a finite, falling loss and the
       fresh-batch check;
    c. step time, tokens/s, MFU (tokens/s times ``flops_per_token(S)`` over
       the bf16 tensor-core peak), peak memory and a profile of one step.
    Returns the launches of one step."""
    from paddle_tpu_torch.incubate.distributed.models.moe import \
        ClipGradForMOEByGlobalNorm
    from paddle_tpu_torch.models import Qwen2Moe, Qwen2MoeConfig
    from paddle_tpu_torch.optimizer import AdamW

    torch.cuda.reset_peak_memory_stats()
    layers = MOE_TRAIN_LAYERS
    cfg = Qwen2MoeConfig(num_layers=layers)
    model = Qwen2Moe(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    gen = torch.Generator(device=dev).manual_seed(2028)
    batches = []
    for _ in range(MOE_PARITY_BATCHES):
        toks = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                             generator=gen, device=dev)
        batches.append((toks[:, :-1].contiguous(), toks[:, 1:].contiguous()))
    ids, labels = batches[0]
    ref = Qwen2Moe(cfg, device=dev, dtype=torch.float32, seed=None)
    ref.load_state_dict(model.state_dict())
    taps = {id(model): _GateTap(model), id(ref): _GateTap(ref)}
    routes = {}

    def pinned_loss(net, plain, ids, labels):
        tap = taps[id(net)]
        if net is model and not plain:
            _, loss = net(ids, labels=labels)
            routes.clear()
            routes.update(tap.out)
            return loss
        tap.pin = routes
        try:
            return net(ids, labels=labels, plain=plain)[1]
        finally:
            tap.pin = {}

    _grad_parity(torch, "qwen2_moe, routing pinned", model, ref, batches,
                 pinned_loss)
    _grad_parity(torch, "qwen2_moe, free running", model, ref, batches,
                 grad_tol=None)
    for tap in taps.values():
        tap.remove()
    del ref, batches, taps, routes
    _free(torch)
    opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                multi_precision=True,
                grad_clip=ClipGradForMOEByGlobalNorm(1.0))
    n_tensors = len(list(model.parameters()))
    if n_tensors != 14 * layers + 3:
        fail(f"qwen2_moe has {n_tensors} parameter tensors, want "
             f"{14 * layers + 3}")
    want = dict(_moe_path_launches(layers, train=True), adamw=n_tensors)
    losses, step_ms, launches = _train_steps(
        torch, "qwen2_moe train", model, opt, ids, labels, TRAIN_STEPS, want)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    heldout, uniform = _heldout(torch, model, gen, cfg.vocab_size,
                                TRAIN_BATCH, TRAIN_SEQ)
    steady = step_ms[1:]
    mean_ms = sum(steady) / len(steady)
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / mean_ms * 1e3
    fpt = model.flops_per_token(TRAIN_SEQ)
    emit({"phase": "train_moe", "model": "qwen2_moe (Qwen1.5-MoE widths)",
          "layers": layers, "hidden": cfg.hidden_size,
          "experts": cfg.num_experts, "vocab": cfg.vocab_size,
          "params": model.num_params(),
          "activated_params": model.num_activated_params(),
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "capacity": math.ceil(cfg.capacity_factor * TRAIN_BATCH * TRAIN_SEQ
                                * cfg.num_experts_per_tok / cfg.num_experts),
          "losses": losses, "step_ms": step_ms,
          "step_ms_mean_after_first": mean_ms, "tokens_per_s": tokens_per_s,
          "flops_per_token": fpt,
          "mfu": tokens_per_s * fpt / BF16_TC_FLOPS_PER_S,
          "peak_memory_gb": peak_gb, "launches_per_step": launches,
          "heldout_loss": heldout, "uniform_loss": uniform})
    _check_curve("qwen2_moe train", losses, heldout, uniform)
    prof = _profile(torch, lambda: _train_step(torch, model, opt, ids,
                                               labels), reps=2)
    emit({"phase": "profile", "qwen2_moe_train_step": prof})
    return launches


def phase_serve_ernie(torch, np, dev):
    """Dense ERNIE-4.5 at full width and depth on the default engine, engine
    b's traffic; see the module docstring. Returns the launches of the
    served run."""
    from paddle_tpu_torch.models import Ernie, ErnieConfig
    from paddle_tpu_torch.serving import LLMEngine, ServingConfig, \
        ServingModel

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Ernie(ErnieConfig(), device=dev, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = model.cfg
    layers = cfg.num_layers
    engine = LLMEngine(model, ServingConfig(
        max_batch=8, page_size=16, max_seq_len=2048, num_pages=1025,
        dtype="bfloat16"))
    tables_before = model.rope(cfg.max_position_embeddings)
    prompts = default_prompts(np, cfg.vocab_size)
    reqs, outs, wall, launches, stats = _serve(torch, np, engine, prompts)
    path = ("mmha", "rms_norm", "rope", "swiglu", "flash_attention",
            "block_epilogue")
    idle = [n for n in path if launches[n] == 0]
    if idle:
        fail(f"serve_ernie: kernels never launched: {idle}")
    if list(model._rope_cache) != [cfg.max_position_embeddings] or \
            model.rope(cfg.max_position_embeddings)[0] is not \
            tables_before[0]:
        fail(f"serve_ernie: rope tables built for {list(model._rope_cache)}"
             f", want the one {cfg.max_position_embeddings}-position pair")
    pages, px = _check_prefix_claims(engine, reqs, stats)
    emit({"phase": "serve_ernie", "model": "ernie (ErnieConfig())",
          "layers": layers, "hidden": cfg.hidden_size,
          "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
          "vocab": cfg.vocab_size, "tied_head": model.lm_head is None,
          "params": model.num_params(), "init_s": init_s,
          "rope_table_bytes": 2 * tables_before[0].numel() * 4,
          "claimed_pages": pages, "prefix_cache": px,
          **_serve_row(torch, np, engine, reqs, wall, launches, stats)})
    phase_parity_default(torch, model, engine, prompts, outs)
    sm = ServingModel(model).bind_pool(engine.pool)
    tables, toks, pos, held = _batch_tables(torch, engine, prompts)
    try:
        decode = _profile(torch, lambda: sm.decode_forward(toks, pos, tables),
                          reps=10)
        mono_toks = torch.arange(1024, device=dev)[None] + 7
        mono = _profile(torch, lambda: sm.prefill_forward(
            mono_toks, 1024, tables[0]), reps=2)
    finally:
        engine.pool.free(held)
    _decode_step_gate("ernie decode step", decode, layers, layers)
    emit({"phase": "profile", "ernie_decode_step": decode,
          "ernie_monolithic_prefill_1024": mono})
    phase_generate(torch, np, model, engine, prompts, outs, name="ernie")
    return launches


def _ernie_moe_launches(n_dense, n_moe, forwards=1, train=False):
    """The kernel launches of ``forwards`` forwards (with ``train``, one
    train step) of a MoE ERNIE on the layer loop: Qwen2-MoE's
    (``_moe_path_launches``) at ``n_dense + n_moe`` layers, less a dense
    layer's second SwiGLU and its grouped products."""
    want = _moe_path_launches(n_dense + n_moe, forwards, train)
    want["swiglu"] -= n_dense * forwards
    want["moe_gemm"] -= (6 if train else 3) * n_dense * forwards
    if train:
        want["swiglu_bwd"] -= n_dense * forwards
    return want


def phase_ernie_moe(torch, dev):
    """ERNIE-4.5 with its MoE tail at full width and depth: 16 greedy tokens
    for 4 prompts of 512 through the host loop, then ``phase_parity_moe``'s
    checks; see the module docstring."""
    from paddle_tpu_torch.models import Ernie, ErnieConfig
    from paddle_tpu_torch.ops.kernels import WRAPPERS

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Ernie(ErnieConfig(num_experts=ERNIE_MOE_EXPERTS), device=dev,
                  dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = model.cfg
    if model.init_cache is not None:
        fail("ernie_moe: a MoE ERNIE must have no init_cache")
    prompts = _moe_prompts(torch, dev, cfg.vocab_size)
    kept, kept_hooks = _kept_log(model)
    torch.cuda.synchronize()
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = model.generate(prompts, max_new_tokens=ERNIE_MOE_NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {n: w.launches for n, w in WRAPPERS.items() if w.launches}
    for h in kept_hooks:
        h.remove()
    n_moe = cfg.num_layers - cfg.first_k_dense
    want = _ernie_moe_launches(cfg.first_k_dense, n_moe,
                               ERNIE_MOE_NEW_TOKENS)
    new = out[:, MOE_PROMPT:]
    with torch.no_grad():
        prof = _profile(torch, lambda: model(prompts), reps=2)
    emit({"phase": "ernie_moe", "model": "ernie (ErnieConfig(num_experts=64))",
          "layers": cfg.num_layers, "dense_layers": cfg.first_k_dense,
          "experts": cfg.num_experts, "top_k": cfg.num_experts_per_tok,
          "params": model.num_params(), "build_s": build_s,
          "requests": MOE_REQUESTS, "prompt": MOE_PROMPT,
          "new_tokens": ERNIE_MOE_NEW_TOKENS, "wall_s": wall,
          "tokens_per_s": MOE_REQUESTS * ERNIE_MOE_NEW_TOKENS / wall,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "drop_share_by_layer": _drop_share(kept), "launches": got,
          "prompt_forward": prof})
    if tuple(out.shape) != (MOE_REQUESTS, MOE_PROMPT + ERNIE_MOE_NEW_TOKENS) \
            or not torch.equal(out[:, :MOE_PROMPT], prompts) \
            or not bool(((new >= 0) & (new < cfg.vocab_size)).all()):
        fail(f"ernie_moe: generated buffer {tuple(out.shape)} is not the "
             f"prompts followed by {ERNIE_MOE_NEW_TOKENS} in-vocab tokens")
    if got != want:
        fail(f"ernie_moe: launches {got}, want {want}")
    phase_parity_moe(torch, model, prompts, out, name="ernie_moe")


def phase_train_ernie(torch, dev):
    """Dense ERNIE at ERNIE_TRAIN_LAYERS layers with the fused optimizer
    step, then a MoE ERNIE for two steps; see the module docstring."""
    from paddle_tpu_torch.models import Ernie, ErnieConfig
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    torch.cuda.reset_peak_memory_stats()
    layers = ERNIE_TRAIN_LAYERS
    cfg = ErnieConfig(num_layers=layers)
    model = Ernie(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    gen = torch.Generator(device=dev).manual_seed(2041)
    batches = []
    for _ in range(ERNIE_PARITY_BATCHES):
        toks = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                             generator=gen, device=dev)
        batches.append((toks[:, :-1].contiguous(), toks[:, 1:].contiguous()))
    ids, labels = batches[0]
    ref = Ernie(cfg, device=dev, dtype=torch.float32, seed=None)
    ref.load_state_dict(model.state_dict())
    _grad_parity(torch, "ernie (rep 5, tied head)", model, ref, batches)
    del ref, batches
    _free(torch)
    opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0),
                fuse=True)
    n_tensors = len(list(model.parameters()))
    if n_tensors != 9 * layers + 2:
        fail(f"ernie has {n_tensors} parameter tensors, want "
             f"{9 * layers + 2} (tied head)")
    path = {"rms_norm": 1, "rms_norm_bwd": 1,
            "block_epilogue": 2 * layers, "block_epilogue_bwd": 2 * layers,
            "rope": 2 * layers, "swiglu": layers, "swiglu_bwd": layers,
            "flash_attention": layers, "flash_attention_bwd": layers}
    # the eager warm-up and the capture launch (count) AdamW once a tensor;
    # a replay counts nothing on the host
    losses, step_ms = [], []
    for what, steps, want in (
            ("warm-up", 1, dict(path, adamw=n_tensors)),
            ("capture", 1, dict(path, adamw=n_tensors)),
            ("replays", TRAIN_STEPS - 2, path)):
        got_losses, ms, launches = _train_steps(
            torch, f"ernie train ({what})", model, opt, ids, labels, steps,
            want)
        losses += got_losses
        step_ms += ms
    stats = dict(opt._fused_impl.stats)
    if stats != {"fused": TRAIN_STEPS - 1, "warmup": 1, "captures": 1,
                 "fallbacks": 0}:
        fail(f"ernie train: fused step stats {stats}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    heldout, uniform = _heldout(torch, model, gen, cfg.vocab_size,
                                TRAIN_BATCH, TRAIN_SEQ)
    steady = step_ms[2:]
    mean_ms = sum(steady) / len(steady)
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / mean_ms * 1e3
    fpt = model.flops_per_token(TRAIN_SEQ)
    emit({"phase": "train_ernie", "model": "ernie (ErnieConfig(num_layers=4))",
          "layers": layers, "hidden": cfg.hidden_size,
          "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
          "vocab": cfg.vocab_size, "params": model.num_params(),
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "losses": losses,
          "step_ms": step_ms, "step_ms_mean_replayed": mean_ms,
          "tokens_per_s": tokens_per_s, "flops_per_token": fpt,
          "mfu": tokens_per_s * fpt / BF16_TC_FLOPS_PER_S,
          "peak_memory_gb": peak_gb, "fused_step": stats,
          "launches_per_replayed_step": launches, "heldout_loss": heldout,
          "uniform_loss": uniform})
    _check_curve("ernie train", losses, heldout, uniform)
    prof = _profile(torch, lambda: _train_step(torch, model, opt, ids,
                                               labels), reps=2)
    emit({"phase": "profile", "ernie_train_step_fused": prof})
    del model, opt
    _free(torch)

    torch.cuda.reset_peak_memory_stats()
    mcfg = ErnieConfig(num_experts=ERNIE_MOE_EXPERTS,
                       num_layers=ERNIE_MOE_TRAIN_LAYERS)
    model = Ernie(mcfg, device=dev, dtype=torch.bfloat16, seed=0)
    opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0),
                fuse=True)
    n_moe = mcfg.num_layers - mcfg.first_k_dense
    want = dict(_ernie_moe_launches(mcfg.first_k_dense, n_moe, train=True),
                adamw=len(list(model.parameters())))
    losses, step_ms, _ = _train_steps(
        torch, "ernie moe train", model, opt, ids, labels,
        ERNIE_MOE_TRAIN_STEPS, want)
    stats = dict(opt._fused_impl.stats)
    emit({"phase": "train_ernie_moe",
          "model": "ernie (ErnieConfig(num_experts=64, num_layers=5))",
          "dense_layers": mcfg.first_k_dense, "moe_layers": n_moe,
          "params": model.num_params(), "losses": losses,
          "step_ms": step_ms, "fused_step": stats,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    if not all(math.isfinite(x) for x in losses) or \
            stats != {"fused": 1, "warmup": 1, "captures": 1,
                      "fallbacks": 0}:
        fail(f"ernie moe train: losses {losses}, fused step stats {stats}")


def _fused_gpt_run(torch, dev, cls, kw, batches, fuse):
    """GPT-2 small (bf16, master weights, a global-norm clip) over
    ``batches``, one step each; the grads zeroed in place after each step
    but FUSED_REALLOC_STEP's, after which ``clear_grad()`` drops them (the
    next backward puts them elsewhere). Returns (model, optimizer, the
    state's tensors, step wall ms, optimizer host ms, peak GB, the fused
    step's stats and its replays that copied moved grads in)."""
    from paddle_tpu_torch.models import gpt2_small
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

    torch.cuda.reset_peak_memory_stats()
    model = gpt2_small(device=dev, dtype=torch.bfloat16, seed=0)
    opt = cls(parameters=model.parameters(), multi_precision=True,
              grad_clip=ClipGradByGlobalNorm(1.0), fuse=fuse, **kw)
    wall, host = [], []
    for i, (ids, labels) in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss = model(ids, labels=labels)
        loss.backward()
        t1 = time.perf_counter()
        opt.step()
        host.append((time.perf_counter() - t1) * 1e3)
        opt.clear_grad(set_to_zero=i != FUSED_REALLOC_STEP)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    state = [p.detach().clone() for p in model.parameters()]
    for name in sorted(opt._accumulators):
        state += [opt._accumulators[name][id(p)].clone()
                  for p in model.parameters()]
    state += [opt._master_weights[id(p)].clone() for p in model.parameters()]
    impl = opt._fused_impl
    stats = None if impl is None else dict(
        impl.stats, copy_replays=sum(getattr(e, "copies", 0)
                                     for e in impl._cache.values()))
    return (model, opt, state + [opt._step_tensor.clone()], wall, host,
            torch.cuda.max_memory_allocated() / 1e9, stats)


def phase_fused_step(torch, dev):
    """The fused optimizer step (one CUDA graph a step) against the eager
    loop on GPT-2 small; see the module docstring."""
    from paddle_tpu_torch.models import GPTConfig
    from paddle_tpu_torch.optimizer import AdamW, Lamb

    vocab = GPTConfig().vocab_size
    gen = torch.Generator(device=dev).manual_seed(2042)
    batches = []
    for _ in range(FUSED_STEPS):
        toks = torch.randint(0, vocab, (GPT_BATCH, GPT_SEQ + 1),
                             generator=gen, device=dev)
        batches.append((toks[:, :-1].contiguous(), toks[:, 1:].contiguous()))
    ids, labels = batches[0]
    out = {"phase": "fused_step", "model": "gpt2_small", "steps": FUSED_STEPS,
           "realloc_after_step": FUSED_REALLOC_STEP}
    for name, cls, kw in (("adamw", AdamW, dict(learning_rate=3e-4,
                                                 weight_decay=0.01)),
                          ("lamb", Lamb, dict(learning_rate=2e-3,
                                              lamb_weight_decay=0.01))):
        rows = {}
        for mode in ("eager", "fused"):
            model, opt, state, wall, host, peak, stats = _fused_gpt_run(
                torch, dev, cls, kw, batches, mode == "fused")
            step_prof = _profile(torch, lambda: _train_step(
                torch, model, opt, ids, labels), reps=3)
            _, loss = model(ids, labels=labels)
            loss.backward()
            opt_prof = _profile(torch, opt.step, reps=3)
            rows[mode] = {"state": state, "wall_ms": wall, "host_ms": host,
                          "peak_memory_gb": peak, "stats": stats,
                          "step_profile": step_prof,
                          "optimizer_profile": opt_prof}
            del model, opt
        fused, eager = rows["fused"], rows["eager"]
        differ = sum(not torch.equal(a, b)
                     for a, b in zip(fused["state"], eager["state"]))
        stats = fused["stats"]
        mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
        out[name] = {
            "tensors": len(fused["state"]), "tensors_differing": differ,
            "stats_after_compared_steps": stats,
            **{f"{m}_{k}": rows[m][k] for m in ("eager", "fused")
               for k in ("wall_ms", "host_ms", "peak_memory_gb")},
            "wall_ms_mean_after_second": {m: mean(rows[m]["wall_ms"][2:])
                                          for m in rows},
            "optimizer_host_ms_mean_after_second": {
                m: mean(rows[m]["host_ms"][2:]) for m in rows},
            "step_profile": {m: rows[m]["step_profile"] for m in rows},
            "optimizer_profile": {m: rows[m]["optimizer_profile"]
                                  for m in rows}}
        del rows, fused, eager
        _free(torch)
        # the grads re-allocated after FUSED_REALLOC_STEP are copied into
        # the captured ones on every later replay
        want = {"fused": FUSED_STEPS - 1, "warmup": 1, "captures": 1,
                "fallbacks": 0,
                "copy_replays": FUSED_STEPS - 1 - FUSED_REALLOC_STEP}
        if differ or stats != want:
            emit(out)
            fail(f"fused_step ({name}): {differ} of {out[name]['tensors']} "
                 f"state tensors differ from the eager run's; stats {stats}"
                 f", want {want}")
    emit(out)


# -- quantization flows, quantized gradients and the HTTP front --------------

def _int8_linears(model):
    from paddle_tpu_torch.quantization import Int8WeightOnlyLinear
    return [m for m in model.modules() if isinstance(m, Int8WeightOnlyLinear)]


def _dequantized_twin(torch, model, dtype):
    """A copy of ``model`` in which every ``Int8WeightOnlyLinear`` is a
    ``torch.nn.Linear`` holding ``weight_dequantize``'s weights in
    ``dtype``: the reference a weight-only model is held against."""
    import copy

    from paddle_tpu_torch.nn.quant import weight_dequantize
    from paddle_tpu_torch.quantization import Int8WeightOnlyLinear

    twin = copy.deepcopy(model)
    for parent in list(twin.modules()):
        for name, sub in list(parent.named_children()):
            if not isinstance(sub, Int8WeightOnlyLinear):
                continue
            k, n = sub.weight_int8.shape
            lin = torch.nn.Linear(k, n, bias=sub.bias is not None,
                                  device="meta", dtype=dtype)
            lin = lin.to_empty(device=sub.weight_int8.device)
            with torch.no_grad():
                lin.weight.copy_(weight_dequantize(
                    sub.weight_int8, sub.scales, out_dtype=dtype).t())
                if sub.bias is not None:
                    lin.bias.copy_(sub.bias)
            setattr(parent, name, lin)
    return twin


def _int8_generate(torch, what, model, twin, prompts, new, n_head, n_body):
    """Cached greedy ``generate`` of ``new`` tokens for ``prompts`` [B, S]
    through ``model``'s weight-only kernels, held against its dequantized
    twin by :func:`_agreement`. The int8 kernel launches once a
    projection a forward: the prefill's ``n_body`` (no head, M = B (S - 1)
    > 16: the prefill kernel), then ``n_body + n_head`` a token (M = B <=
    16: the decode kernel)."""
    from paddle_tpu_torch.ops.kernels import WRAPPERS

    dev = next(model.parameters()).device
    ids = torch.tensor(prompts, device=dev)
    b, s = ids.shape
    for w in WRAPPERS.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=new)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {n: w.launches for n, w in WRAPPERS.items() if w.launches}
    want = n_body + new * (n_body + n_head)
    if launches.get("wo_int8") != want:
        fail(f"{what}: wo_int8 launched {launches.get('wo_int8')} times, "
             f"want {want}")
    ref = twin.generate(ids, max_new_tokens=new)
    got = [out[r, s:].tolist() for r in range(b)]
    exp = [ref[r, s:].tolist() for r in range(b)]

    def logits_at(i, j):
        ctx = torch.tensor([list(prompts[i]) + exp[i][:j]], device=dev)
        with torch.no_grad():
            return twin(ctx)[0, -1].float()

    rows = _agreement(torch, what, got, exp, logits_at)
    return {"batch": b, "prompt_len": s, "tokens": new, "wall_ms": wall_ms,
            "ms_per_token": wall_ms / new, "launches": launches,
            "prefill_rows": b * (s - 1), "decode_rows": b,
            "against_dequantized": rows}


def phase_ptq(torch, np, model):
    """PTQ on the served Llama-3-8B: ``PTQ(QuantConfig(activation=
    AbsmaxObserver(), weight=None))`` on a copy of the model, calibrated
    on PTQ_CALIB prompts of PTQ_CALIB_LEN seeded tokens, then ``convert``:
    every projection an ``Int8WeightOnlyLinear``. Gates: the int8 weights'
    bytes (``memory_bytes()``) about half of bf16's; a PTQ_FORWARD_LEN
    forward launching the int8 kernel once a projection (M > 16: the
    prefill kernel), its last-position logits within PARITY_REL_TOL of its
    plain weight-only products (engine d's check) and their argmax that of
    the same model with ``weight_dequantize``'d bf16 weights unless its top
    two are within that tolerance (the gap from the plain products to that
    twin is reported, not gated); cached ``generate`` at B 1 and B
    PTQ_BATCH x PTQ_NEW_TOKENS against that twin's by :func:`_agreement`,
    with the decode kernel's launches a token (M <= 16)."""
    from paddle_tpu_torch.ops.kernels import WRAPPERS
    from paddle_tpu_torch.quantization import AbsmaxObserver, PTQ, QuantConfig

    dev = model.device
    cfg = model.cfg
    rng = np.random.default_rng(2050)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ptq = PTQ(QuantConfig(activation=AbsmaxObserver(), weight=None))
    calib = ptq.quantize(model)           # a copy: the served model stays
    with torch.no_grad():
        for _ in range(PTQ_CALIB):
            calib(torch.tensor(rng.integers(0, cfg.vocab_size,
                                            (1, PTQ_CALIB_LEN)), device=dev))
    scales = [m.observer.scale() for m in calib.modules()
              if hasattr(m, "observer")]
    q = ptq.convert(calib, inplace=True)
    del calib
    _free(torch)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    lin8 = _int8_linears(q)
    n_head = 0 if model.lm_head is None else 1
    n_body = 7 * cfg.num_layers
    if len(lin8) != n_body + n_head or len(scales) != len(lin8) or \
            not all(s > 0 for s in scales):
        fail(f"ptq: {len(lin8)} int8 projections, {len(scales)} observed "
             f"scales, want {n_body + n_head}")
    int8_bytes = sum(m.memory_bytes() for m in lin8)
    bf16_bytes = sum(2 * m.weight_int8.numel() for m in lin8)
    ratio = int8_bytes / bf16_bytes
    if not PTQ_BYTES_RATIO[0] <= ratio <= PTQ_BYTES_RATIO[1]:
        fail(f"ptq: int8 weights take {ratio} of bf16's bytes")
    twin = _dequantized_twin(torch, q, torch.bfloat16)
    ids = torch.tensor(rng.integers(0, cfg.vocab_size, (1, PTQ_FORWARD_LEN)),
                       device=dev)
    with torch.no_grad():
        q(ids[:, :16])
        for w in WRAPPERS.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lq = q(ids)[0, -1].float()
        torch.cuda.synchronize()
        forward_ms = (time.perf_counter() - t0) * 1e3
        launches = {n: w.launches for n, w in WRAPPERS.items() if w.launches}
        lt = twin(ids)[0, -1].float()
        for m in lin8:
            m.plain = True
        lp = q(ids)[0, -1].float()
        for m in lin8:
            m.plain = False
    if launches.get("wo_int8") != n_body + n_head:
        fail(f"ptq forward: launches {launches}, want wo_int8 "
             f"{n_body + n_head}")
    # the twin rounds every dequantized weight to bf16, which the int8
    # products never do: through 32 random layers that alone moves the
    # logits about as far as engine d's tolerance. So the logits gate holds
    # the kernel against the plain int8 products (engine d's check), and
    # against the twin only the argmax, unless its top two are within the
    # tolerance; plain_vs_twin is reported, not gated
    row = _parity_row(torch, 0, PTQ_FORWARD_LEN, lq, lt)
    row["plain_vs_twin"] = (lp - lt).abs().max().item()
    row["kernel_vs_plain"] = (lq - lp).abs().max().item()
    if not row["kernel_vs_plain"] <= row["tol"] or (
            row["plain_top2_gap"] > row["tol"]
            and row["argmax_kernel"] != row["argmax_plain"]):
        fail(f"ptq forward: last-position logits against the dequantized "
             f"twin: {row}")
    calls = []
    for b in (1, PTQ_BATCH):
        prompts = rng.integers(0, cfg.vocab_size, (b, PTQ_PROMPT_LEN))
        calls.append(_int8_generate(
            torch, f"ptq generate B {b}", q, twin, prompts.tolist(),
            PTQ_NEW_TOKENS, n_head, n_body))
    emit({"phase": "ptq", "model": "llama3_8b", "layers": cfg.num_layers,
          "calibration": [PTQ_CALIB, PTQ_CALIB_LEN],
          "int8_projections": len(lin8), "quantize_s": quantize_s,
          "observed_scale_range": [min(scales), max(scales)],
          "int8_weight_bytes": int8_bytes, "bf16_weight_bytes": bf16_bytes,
          "bytes_ratio": ratio, "forward_len": PTQ_FORWARD_LEN,
          "forward_ms": forward_ms, "forward_launches": launches,
          "forward_parity": row, "generate": calls,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    del q, twin
    _free(torch)


def _parse_exposition(text):
    """The Prometheus text exposition (0.0.4) walked line by line: HELP and
    TYPE before a family's samples, every sample ``name{labels} value``
    of a declared family (a histogram's ``_bucket`` / ``_sum`` /
    ``_count``), labels well-formed. Returns {sample name: [(labels,
    value)]}; fails on anything else."""
    import re
    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
    label = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    kinds, out = {}, {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            kinds[name] = kind
            continue
        m = sample.match(line)
        if m is None:
            fail(f"http /metrics: not an exposition line: {line!r}")
        name, labels, value = m.group(1), m.group(2) or "", float(m.group(3))
        fam = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and \
                    kinds.get(name[:-len(suffix)]) == "histogram":
                fam = name[:-len(suffix)]
        pairs = label.findall(labels)
        if fam not in kinds or ",".join(
                f'{k}="{v}"' for k, v in pairs) != labels:
            fail(f"http /metrics: undeclared family or bad labels: {line!r}")
        out.setdefault(name, []).append((dict(pairs), value))
    return out


def _http_get(base, path):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(base + path, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _http_post(base, body):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(base + "/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _serve_turn(engine, prompts, tokens, hooks=None):
    """One turn of ``prompts`` at ``tokens`` new tokens each through
    ``engine``, timed on the host: the window from the first submit to the
    last result (tokens/s), the wall of every scheduler iteration
    (``scheduler.step``, wrapped for the turn), and what of those walls
    lies outside the engine's forward spans (``prefill_ms`` / ``chunk_ms``
    / ``step_ms`` / ``verify_ms``: the forward, the sampling and the read
    back), which is the scheduler's own host work, where the serving hooks
    run. ``hooks`` True / False turns metrics, tracing and the flight
    recorder all on / all off for the turn (None: leave them, for a tree
    that has none)."""
    sched = engine.scheduler
    spans = [getattr(engine, n) for n in ("prefill_ms", "chunk_ms",
                                          "step_ms", "verify_ms")]
    if hooks is not None:
        import paddle_tpu_torch.observability as obs
        from paddle_tpu_torch.observability import flight, tracing
        for mod in (obs, flight, tracing):
            mod.enable(hooks)
    iters, step = [], sched.step

    def timed():
        t0 = time.perf_counter()
        try:
            return step()
        finally:
            iters.append((time.perf_counter() - t0) * 1e3)

    for times in spans:
        times.clear()
    sched.step = timed
    try:
        t0 = time.perf_counter()
        reqs = [engine.submit(p, max_new_tokens=tokens) for p in prompts]
        done = sum(len(r.result(timeout=900)) for r in reqs)
        window = time.perf_counter() - t0
        time.sleep(0.1)     # the iteration that completed the last request
    finally:
        del sched.step
        if hooks is not None:
            for mod in (obs, flight, tracing):
                mod.enable(True)
    inside = sum(sum(times) for times in spans)
    return {"hooks": {None: "none", True: "on", False: "off"}[hooks],
            "tokens": done, "window_s": window, "tokens_per_s": done / window,
            "iterations": len(iters), "iter_ms_mean": sum(iters) / len(iters),
            "host_ms_per_iter": (sum(iters) - inside) / len(iters),
            "decode_steps": len(spans[2]),
            "decode_step_ms_mean": sum(spans[2]) / max(1, len(spans[2]))}


def _turn_medians(turns):
    """Per hooks mode, the median and the range of each turn metric."""
    out = {}
    for mode in sorted({t["hooks"] for t in turns}):
        rows = [t for t in turns if t["hooks"] == mode]
        for key in ("tokens_per_s", "iter_ms_mean", "host_ms_per_iter",
                    "decode_step_ms_mean"):
            xs = sorted(t[key] for t in rows)
            mid = len(xs) // 2
            med = xs[mid] if len(xs) % 2 else (xs[mid - 1] + xs[mid]) / 2
            out.setdefault(mode, {})[key] = {"median": med, "min": xs[0],
                                             "max": xs[-1]}
    return out


def phase_http(torch, np, model, engine, prompts, served):
    """Engine b behind the HTTP front: ``serving.server.serve(engine,
    port=0, host="127.0.0.1")``, engine b's 12 prompts posted to ``POST
    /generate`` from HTTP_CLIENTS client threads, every second request
    streaming (NDJSON). Gates: the tokens against engine b's in-process
    ones by :func:`_agreement`; ``/metrics`` a well-formed exposition whose
    generated-token counter equals the tokens returned, whose decode-step
    counter equals ``stats()``'s steps over the run, and whose TTFT and
    e2e histograms count 12; ``/healthz`` 200 in serving mode;
    ``/requests`` 12 records; ``/flight`` 12 submit, prefill and complete
    events; a bad body 400 and an over-long prompt 429. Then, as a
    finding, engine b's serving with metrics, tracing and the flight
    recorder all on against all off (:func:`_serve_turn`: tokens/s over
    the window, the scheduler iteration's wall and its host work outside
    the forward), in HTTP_AB_ROUNDS rounds of turns on, off, off, on (each
    mode's medians and range, and the medians' ratios)."""
    import threading

    import paddle_tpu_torch.observability as obs
    from paddle_tpu_torch.observability import flight, tracing
    from paddle_tpu_torch.serving import ServingModel, server

    obs.reset()
    flight.clear()
    tracing.reset()
    steps0 = engine.stats()["decode_steps"]
    srv = server.serve(engine, port=0, host="127.0.0.1")
    base = f"http://127.0.0.1:{srv.port}"
    results, errors = [None] * len(prompts), []

    def client(k):
        for i in range(k, len(prompts), HTTP_CLIENTS):
            stream = i % 2 == 1
            code, raw = _http_post(base, {
                "prompt_ids": prompts[i], "stream": stream,
                "max_new_tokens": SERVE_NEW_TOKENS})
            if code != 200:
                errors.append((i, code, raw[:200]))
                continue
            if stream:
                lines = [json.loads(x) for x in raw.splitlines()]
                toks = [x["token"] for x in lines[:-1]]
                if not lines[-1].get("done") or lines[-1]["tokens"] != toks:
                    errors.append((i, "stream", lines[-1]))
                results[i] = toks
            else:
                results[i] = json.loads(raw)["tokens"]

    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(HTTP_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if errors or any(r is None for r in results):
            fail(f"http: failed requests {errors}")
        sm = ServingModel(model).bind_pool(engine.pool)
        rows = _agreement(torch, "http against engine b", results,
                          [o[:SERVE_NEW_TOKENS] for o in served],
                          lambda i, j: _next_logits(torch, sm, engine,
                                                    prompts[i]
                                                    + served[i][:j]))
        code, raw = _http_get(base, "/metrics")
        metrics = _parse_exposition(raw.decode())
        value = lambda name, **lab: next(  # noqa: E731
            (v for labels, v in metrics.get(name, []) if labels == lab), None)
        generated = sum(len(r) for r in results)
        steps = engine.stats()["decode_steps"] - steps0
        got = {
            "tokens_generated": value("paddle_tpu_serving_tokens_total",
                                      kind="generated"),
            "decode_steps": value("paddle_tpu_serving_decode_steps_total"),
            "ttft_count": value("paddle_tpu_serving_ttft_ms_count"),
            "e2e_count": value("paddle_tpu_serving_e2e_ms_count"),
            "completed": value("paddle_tpu_serving_requests_total",
                               status="completed")}
        want = {"tokens_generated": generated, "decode_steps": steps,
                "ttft_count": len(prompts), "e2e_count": len(prompts),
                "completed": len(prompts)}
        if code != 200 or got != want:
            fail(f"http /metrics: {got}, want {want} (status {code})")
        hcode, hraw = _http_get(base, "/healthz")
        health = json.loads(hraw)
        rcode, rraw = _http_get(base, "/requests?last=100")
        records = json.loads(rraw)["requests"]
        fcode, fraw = _http_get(base, "/flight")
        kinds = [e["kind"] for e in json.loads(fraw)["events"]]
        counts = {k: kinds.count(k) for k in
                  ("serving_submit", "serving_prefill", "serving_complete")}
        if hcode != 200 or health.get("mode") != "serving" or \
                rcode != 200 or len(records) != len(prompts) or \
                fcode != 200 or set(counts.values()) != {len(prompts)}:
            fail(f"http: /healthz {hcode} {health}, /requests {rcode} "
                 f"{len(records)} records, /flight {fcode} {counts}")
        trace = json.loads(_http_get(
            base, f"/trace/{records[0]['trace_id']}")[1])
        bad, _ = _http_post(base, {"prompt_ids": "nope"})
        long, _ = _http_post(base, {"prompt_ids": [1] * engine.max_seq_len,
                                    "max_new_tokens": SERVE_NEW_TOKENS})
        if (bad, long) != (400, 429):
            fail(f"http: bad body {bad} (want 400), over-long prompt "
                 f"{long} (want 429)")
    finally:
        srv.close()
        server.detach()
    turns = [_serve_turn(engine, prompts, HTTP_AB_TOKENS, hooks=on)
             for on in (True, False, False, True) * HTTP_AB_ROUNDS]
    medians = _turn_medians(turns)
    summary = engine.shutdown()
    if summary["pages_leaked"] or engine.pool.lost():
        fail(f"http: pages leaked or lost: {summary}")
    emit({"phase": "http", "engine": "default", "clients": HTTP_CLIENTS,
          "requests": len(prompts), "streamed": len(prompts) // 2,
          "generated_tokens": generated, "wall_s": wall,
          "tokens_per_s": generated / wall, "agreement": rows,
          "metrics": got, "healthz": health,
          "ttft_ms_mean": sum(r["ttft_ms"] for r in records) / len(records),
          "e2e_ms_mean": sum(r["e2e_ms"] for r in records) / len(records),
          "span_kinds": records[0]["span_kinds"],
          "trace_spans": len(trace.get("spans", [])),
          "flight_event_kinds": sorted(set(kinds)),
          "hooks_turns": turns, "hooks_medians": medians,
          "hooks_on_over_off": {
              k: medians["on"][k]["median"] / medians["off"][k]["median"]
              for k in medians["on"]}})


def _quanter_state(torch, net, cls):
    return [(m._scale.clone(), m._inited.clone()) for m in net.modules()
            if isinstance(m, cls)]


def phase_qat(torch, dev):
    """QAT on GPT-2 small (BASELINE config #1, bf16 from a seed):
    ``QAT(QuantConfig(activation=FakeQuanterWithAbsMaxObserver(),
    weight=FakeQuanterWithAbsMaxObserver()))`` wraps its 4L projections.
    The train-parity gate (``_grad_parity``, kernel path against plain and
    an f32 copy, QAT_PARITY_BATCHES batches of B 8 x S 1024), every path
    starting from the same quanter state: the weight quanters' scales
    equal on both paths, the activation quanters' within QAT_ACT_SCALE_TOL
    relative (their absmax is taken of bf16 activations that the two
    paths round apart). Then QAT_STEPS AdamW steps with the fused trunk's
    launches and a falling loss; ``QAT.convert``, ``PTQ`` with an absmax
    observer and ``convert`` to ``Int8WeightOnlyLinear``; cached
    ``generate`` B 8 x QAT_NEW_TOKENS held against the dequantized twin."""
    import copy

    from paddle_tpu_torch.models import gpt2_small
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.quantization import (
        PTQ, QAT, AbsmaxObserver, FakeQuanterWithAbsMaxObserver, QuantConfig,
        QuantedLinear)

    torch.cuda.reset_peak_memory_stats()
    quanter = FakeQuanterWithAbsMaxObserver
    qat = QAT(QuantConfig(activation=quanter(), weight=quanter()))
    model = qat.quantize(gpt2_small(device=dev, dtype=torch.bfloat16, seed=0),
                         inplace=True)
    cfg = model.cfg
    layers = cfg.num_layers
    wrapped = [m for m in model.modules() if isinstance(m, QuantedLinear)]
    if len(wrapped) != 4 * layers:
        fail(f"qat: {len(wrapped)} QuantedLinears, want {4 * layers}")
    weight_q = {id(m.weight_quanter) for m in wrapped}
    gen = torch.Generator(device=dev).manual_seed(2052)
    batches = []
    for _ in range(QAT_PARITY_BATCHES):
        toks = torch.randint(0, cfg.vocab_size, (GPT_BATCH, GPT_SEQ + 1),
                             generator=gen, device=dev)
        batches.append((toks[:, :-1].contiguous(), toks[:, 1:].contiguous()))
    ids, labels = batches[0]
    with torch.no_grad():
        model(ids, labels=labels)        # the quanters' first scales
    ref = copy.deepcopy(model).float()
    snaps, scales = {}, {}

    def loss_fn(net, plain, ids, labels):
        qs = [m for m in net.modules() if isinstance(m, quanter)]
        snap = snaps.setdefault(id(net), _quanter_state(torch, net, quanter))
        with torch.no_grad():
            for m, (s, i) in zip(qs, snap):
                m._scale.copy_(s)
                m._inited.copy_(i)
        _, loss = net(ids, labels=labels, plain=plain)
        if net is model:
            scales.setdefault(plain, []).append(
                [(id(m) in weight_q, m._scale.item()) for m in qs])
        return loss

    _grad_parity(torch, "qat gpt2_small", model, ref, batches,
                 loss_fn=loss_fn)
    del ref
    worst_w = worst_a = 0.0
    for k_run, p_run in zip(scales[False], scales[True]):
        for (is_w, sk), (_, sp) in zip(k_run, p_run):
            rel = abs(sk - sp) / max(abs(sp), 1e-30)
            if is_w:
                worst_w = max(worst_w, rel)
            else:
                worst_a = max(worst_a, rel)
    if worst_w != 0.0 or worst_a > QAT_ACT_SCALE_TOL:
        fail(f"qat: quanter scales differ between the kernel and plain "
             f"paths: weights {worst_w} (want 0), activations {worst_a} "
             f"(tol {QAT_ACT_SCALE_TOL})")
    with torch.no_grad():
        qs = [m for m in model.modules() if isinstance(m, quanter)]
        for m, (s, i) in zip(qs, snaps[id(model)]):
            m._scale.copy_(s)
            m._inited.copy_(i)
    opt = AdamW(3e-4, parameters=model.parameters(), weight_decay=0.01,
                multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0))
    n_tensors = len(list(model.parameters()))
    want = {"block_epilogue": 2 * layers, "block_epilogue_bwd": 2 * layers,
            "flash_attention": layers, "flash_attention_bwd": layers,
            "adamw": n_tensors}
    scale0 = [m._scale.item() for m in qs]
    losses, step_ms, launches = _train_steps(
        torch, "qat train", model, opt, ids, labels, QAT_STEPS, want)
    moved = sum(m._scale.item() != s for m, s in zip(qs, scale0))
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0] or not moved:
        fail(f"qat train: losses {losses}, {moved} quanter scales moved")
    prof = _profile(torch, lambda: _train_step(torch, model, opt, ids,
                                               labels), reps=2)
    emit({"phase": "profile", "qat_train_step": prof})
    deploy = qat.convert(model)
    del opt, model
    _free(torch)
    ptq = PTQ(QuantConfig(activation=AbsmaxObserver(), weight=None))
    int8 = ptq.quantize(deploy, inplace=True)
    with torch.no_grad():
        int8(ids[:1])
    ptq.convert(int8, inplace=True)
    lin8 = _int8_linears(int8)
    if len(lin8) != 4 * layers:
        fail(f"qat: {len(lin8)} int8 projections after PTQ, want "
             f"{4 * layers}")
    twin = _dequantized_twin(torch, int8, torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (GPT_GEN_BATCH, QAT_PROMPT_LEN),
                            generator=gen, device=dev).tolist()
    call = _int8_generate(torch, "qat int8 generate", int8, twin, prompts,
                          QAT_NEW_TOKENS, 0, 4 * layers)
    steady = step_ms[1:]
    emit({"phase": "qat", "model": "gpt2_small", "layers": layers,
          "quanted_linears": len(wrapped), "quanters": len(qs),
          "batch": GPT_BATCH, "seq": GPT_SEQ, "losses": losses,
          "step_ms": step_ms,
          "step_ms_mean_after_first": sum(steady) / len(steady),
          "launches_per_step": launches,
          "scale_rel_diff_weights": worst_w,
          "scale_rel_diff_activations": worst_a,
          "scale_tol_activations": QAT_ACT_SCALE_TOL,
          "quanter_scales_moved": moved, "int8_generate": call,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    del int8, twin, deploy
    _free(torch)


def phase_int8_grad(torch, dev):
    """Training around frozen int8 projections: ``llama3_8b(num_layers=
    TRAIN_LAYERS)`` in bf16 with every decoder projection PTQ-converted
    (``Int8WeightOnlyLinear``, frozen); the embedding, the norms and the
    head train with AdamW (master weights, a global-norm clip) on B 2 x S
    2048. The forward runs the int8 kernel at M 4096 (the prefill kernel);
    ``dx`` of every projection the weight-only VJP (``torch.matmul`` on
    the dequantised bf16 weight). Gates: ``_grad_parity`` against the
    plain path and an f32 copy; INT8_GRAD_STEPS steps with their launches
    and a falling loss. Reported: the backward's dequantised weights
    (bytes a step, and the cast's and dx products' cold times at each
    projection shape) and a profile of a step."""
    import copy

    from paddle_tpu_torch.models import llama3_8b
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.quantization import AbsmaxObserver, PTQ, QuantConfig

    torch.cuda.reset_peak_memory_stats()
    layers = TRAIN_LAYERS
    model = llama3_8b(device=dev, dtype=torch.bfloat16, seed=0,
                      num_layers=layers)
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(2053)
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                         generator=gen, device=dev)
    ids, labels = toks[:, :-1].contiguous(), toks[:, 1:].contiguous()
    ptq = PTQ(QuantConfig(activation=AbsmaxObserver(), weight=None))
    ptq.quantize(model.layers, inplace=True)
    with torch.no_grad():
        model(ids[:1, :512])
    ptq.convert(model.layers, inplace=True)
    _free(torch)
    lin8 = _int8_linears(model)
    trainable = [p for p in model.parameters() if p.requires_grad]
    if len(lin8) != 7 * layers or len(trainable) != 2 * layers + 3:
        fail(f"int8_grad: {len(lin8)} int8 projections (want {7 * layers}),"
             f" {len(trainable)} trainable tensors (want {2 * layers + 3})")
    ref = copy.deepcopy(model).float()

    def loss_fn(net, plain, ids, labels):
        for m in _int8_linears(net):
            m.plain = plain
        _, loss = net(ids, labels=labels, plain=plain)
        return loss

    _grad_parity(torch, "int8_grad llama", model, ref, [(ids, labels)],
                 loss_fn=loss_fn)
    del ref
    for m in lin8:
        m.plain = False
    opt = AdamW(1e-4, parameters=trainable, weight_decay=0.01,
                multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0))
    want = {"rms_norm": 1, "rms_norm_bwd": 1,
            "block_epilogue": 2 * layers, "block_epilogue_bwd": 2 * layers,
            "rope": 2 * layers, "swiglu": layers, "swiglu_bwd": layers,
            "flash_attention": layers, "flash_attention_bwd": layers,
            "adamw": len(trainable), "wo_int8": len(lin8)}
    losses, step_ms, launches = _train_steps(
        torch, "int8_grad train", model, opt, ids, labels, INT8_GRAD_STEPS,
        want)
    heldout, uniform = _heldout(torch, model, gen, cfg.vocab_size,
                                TRAIN_BATCH, TRAIN_SEQ)
    _check_curve("int8_grad train", losses, heldout, uniform)
    timer = ColdTimer(torch, dev)
    m_rows = TRAIN_BATCH * TRAIN_SEQ
    shapes = {}
    for m in lin8:
        shapes.setdefault(tuple(m.weight_int8.shape), []).append(m)
    dequant = []
    for (k, n), mods in sorted(shapes.items()):
        m = mods[0]
        g = torch.randn(m_rows, n, device=dev, dtype=torch.bfloat16)
        wd = m.weight_int8.to(torch.bfloat16)
        cast_ms = timer(lambda: m.weight_int8.to(torch.bfloat16))
        gs_ms = timer(lambda: g * m.scales.to(torch.bfloat16))
        gs = g * m.scales.to(torch.bfloat16)
        dx_ms = timer(lambda: torch.matmul(gs, wd.t()))
        dequant.append({
            "weight": [k, n], "per_step": len(mods),
            "dense_bytes": 2 * k * n, "cast_ms": cast_ms,
            "cast_bound_ms": 3 * k * n / MEM_BYTES_PER_S * 1e3,
            "g_scale_ms": gs_ms, "dx_matmul_ms": dx_ms,
            "dx_bound_ms": 2 * m_rows * k * n / BF16_TC_FLOPS_PER_S * 1e3})
        del g, wd, gs
    prof = _profile(torch, lambda: _train_step(torch, model, opt, ids,
                                               labels), reps=2)
    steady = step_ms[1:]
    emit({"phase": "int8_grad", "model": "llama3_8b", "layers": layers,
          "int8_projections": len(lin8), "trainable_tensors": len(trainable),
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "losses": losses,
          "step_ms": step_ms,
          "step_ms_mean_after_first": sum(steady) / len(steady),
          "launches_per_step": launches, "heldout_loss": heldout,
          "uniform_loss": uniform,
          "backward_dequantized_bytes_per_step": sum(
              r["dense_bytes"] * r["per_step"] for r in dequant),
          "backward_dequant_ms_per_step": sum(
              (r["cast_ms"] + r["g_scale_ms"]) * r["per_step"]
              for r in dequant),
          "backward_dx_ms_per_step": sum(
              r["dx_matmul_ms"] * r["per_step"] for r in dequant),
          "dequant_rows": dequant,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    emit({"phase": "profile", "int8_grad_train_step": prof})
    del model, opt
    _free(torch)


def phase_profile(torch, model, engine, prompts):
    """Where a decode step (8 rows at the served prompts' lengths) and a
    512-token prefill chunk (at position 1024) spend their device time, on
    the per-op path and engine a's pool; then a fused decode step and a
    fused-layer decode step and a 1024-token monolithic prefill. Each decode
    step launches RoPE once a layer and mmha once a layer (none on the
    fused layer), exactly."""
    from paddle_tpu_torch.serving import ServingModel

    pool = engine.pool
    dev = engine.device
    sm = ServingModel(model, fused_block=False).bind_pool(pool)
    fused = ServingModel(model).bind_pool(pool)
    layer = ServingModel(model, fused_decode_layer=True).bind_pool(pool)
    tables, toks, pos, held = _batch_tables(torch, engine, prompts)
    try:
        decode = _profile(torch, lambda: sm.decode_forward(toks, pos, tables),
                          reps=10)
        chunk_toks = torch.arange(512, device=dev)[None] + 7
        chunk = _profile(torch, lambda: sm.prefill_chunk_forward(
            chunk_toks, 1024, 512, tables[0]), reps=2)
        fused_decode = _profile(
            torch, lambda: fused.decode_forward(toks, pos, tables), reps=10)
        layer_decode = _profile(
            torch, lambda: layer.decode_forward(toks, pos, tables), reps=10)
        mono_toks = torch.arange(1024, device=dev)[None] + 7
        mono = _profile(torch, lambda: fused.prefill_forward(
            mono_toks, 1024, tables[0]), reps=2)
    finally:
        pool.free(held)
    layers = model.cfg.num_layers
    _decode_step_gate("per-op decode step", decode, layers, layers)
    _decode_step_gate("fused decode step", fused_decode, layers, layers)
    _decode_step_gate("fused-layer decode step", layer_decode, layers, 0)
    emit({"phase": "profile", "decode_step_batch": engine.config.max_batch,
          "decode_step": decode,
          "prefill_chunk_512_at_1024": chunk,
          "fused_decode_step": fused_decode,
          "fused_layer_decode_step": layer_decode,
          "monolithic_prefill_1024": mono})


_SOURCES = {
    "mmha": ("paddle_tpu_torch/csrc/mmha.cu",
             "paddle_tpu/ops/kernels/mmha_pallas.py:109"),
    "rms_norm": ("paddle_tpu_torch/csrc/rms_norm.cu",
                 "paddle_tpu/ops/kernels/rms_norm_pallas.py:82"),
    "rope": ("paddle_tpu_torch/csrc/rope.cu",
             "paddle_tpu/ops/kernels/rope_pallas.py:48"),
    "swiglu": ("paddle_tpu_torch/csrc/swiglu.cu",
               "paddle_tpu/ops/kernels/swiglu_pallas.py:81"),
    "flash_attention": ("paddle_tpu_torch/csrc/flash_attention.cu",
                        "paddle_tpu/ops/kernels/flash_attention_pallas.py:124"),
    "block_epilogue": ("paddle_tpu_torch/csrc/block_epilogue.cu",
                       "paddle_tpu/ops/kernels/block_fused_pallas.py:212"),
    "decode_layer": ("paddle_tpu_torch/csrc/decode_layer.cu",
                     "paddle_tpu/ops/kernels/decode_layer_pallas.py:201"),
    "wo_int8": ("paddle_tpu_torch/csrc/wo_matmul.cu",
                "paddle_tpu/ops/kernels/wo_matmul_pallas.py:33"),
    "wo_int8_grouped": ("paddle_tpu_torch/csrc/wo_matmul.cu",
                        "paddle_tpu/ops/kernels/wo_matmul_pallas.py:41"),
    "wo_int4": ("paddle_tpu_torch/csrc/wo_matmul.cu",
                "paddle_tpu/ops/kernels/wo_matmul_pallas.py:176"),
    "a8w8": ("paddle_tpu_torch/csrc/a8w8_matmul.cu",
             "paddle_tpu/ops/kernels/a8w8_matmul_pallas.py:50"),
    "rms_norm_bwd": ("paddle_tpu_torch/csrc/rms_norm.cu",
                     "paddle_tpu/ops/kernels/rms_norm_pallas.py:114"),
    "swiglu_bwd": ("paddle_tpu_torch/csrc/swiglu.cu",
                   "paddle_tpu/ops/kernels/swiglu_pallas.py:117"),
    "flash_attention_bwd": (
        "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        "paddle_tpu/ops/kernels/flash_attention_pallas.py:340"),
    "adamw": ("paddle_tpu_torch/csrc/adamw.cu",
              "paddle_tpu/ops/kernels/adamw_pallas.py:59"),
    "block_epilogue_bwd": ("paddle_tpu_torch/csrc/block_epilogue.cu",
                           "paddle_tpu/ops/kernels/block_fused_pallas.py:252"),
    "swiglu_packed": ("paddle_tpu_torch/csrc/swiglu.cu",
                      "paddle_tpu/ops/kernels/swiglu_pallas.py:99"),
    "swiglu_packed_bwd": ("paddle_tpu_torch/csrc/swiglu.cu",
                          "paddle_tpu/ops/kernels/swiglu_pallas.py:136"),
    "lamb": ("paddle_tpu_torch/csrc/lamb.cu",
             "paddle_tpu/ops/kernels/lamb_pallas.py:78"),
    "parallel_ce": ("paddle_tpu_torch/csrc/cross_entropy.cu",
                    "paddle_tpu/ops/kernels/ce_pallas.py:66"),
    "moe_gemm": ("paddle_tpu_torch/csrc/moe_gemm.cu",
                 "paddle_tpu/ops/kernels/moe_gemm_pallas.py:74"),
    "softmax_mask": ("paddle_tpu_torch/csrc/softmax_mask.cu",
                     "paddle_tpu/ops/kernels/softmax_mask_pallas.py:67"),
    "softmax_mask_tri": ("paddle_tpu_torch/csrc/softmax_mask.cu",
                         "paddle_tpu/ops/kernels/softmax_mask_pallas.py:88"),
    "softmax_mask_bwd": ("paddle_tpu_torch/csrc/softmax_mask.cu",
                         "paddle_tpu/ops/kernels/softmax_mask_pallas.py:106"),
    "bias_dropout_ln": (
        "paddle_tpu_torch/csrc/bias_dropout_ln.cu",
        "paddle_tpu/ops/kernels/bias_dropout_ln_pallas.py:96"),
    "bias_dropout_ln_bwd": (
        "paddle_tpu_torch/csrc/bias_dropout_ln.cu",
        "paddle_tpu/ops/kernels/bias_dropout_ln_pallas.py:125"),
    "dropout_add": ("paddle_tpu_torch/csrc/dropout_add.cu",
                    "paddle_tpu/ops/kernels/dropout_add_pallas.py:98"),
    "dropout_add_bwd": ("paddle_tpu_torch/csrc/dropout_add.cu",
                        "paddle_tpu/ops/kernels/dropout_add_pallas.py:118"),
    "linear_grad_add": (
        "paddle_tpu_torch/csrc/linear_grad_add.cu",
        "paddle_tpu/ops/kernels/linear_grad_add_pallas.py:66"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    import numpy as np
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"paddle_tpu_torch not importable from {os.getcwd()}: {e}")

    if os.environ.get("PADDLE_TPU_FUSED_DECODE", "1") == "0":
        fail("PADDLE_TPU_FUSED_DECODE=0 turns the decode-layer kernel off")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device(torch)
    phase_build()
    demo_rows = phase_analysis(torch)
    kern = phase_kernels(torch, dev)
    model, engine, prompts, served = phase_serve_chunked(torch, np, dev)
    d_engine, d_prompts, d_served, launches = phase_serve_default(
        torch, np, model)
    c_engine = phase_tune(torch, model)
    c_served, c_launches = phase_serve_fused_layer(torch, np, model, c_engine,
                                                   d_prompts)
    launches["decode_layer"] = c_launches["decode_layer"]
    phase_parity(torch, model, engine, prompts, served)
    phase_parity_default(torch, model, d_engine, d_prompts, d_served)
    phase_parity_fused_layer(torch, model, c_engine, d_prompts, c_served)
    phase_profile(torch, model, engine, prompts)
    phase_serve_spec(torch, np, model, d_engine, d_prompts, d_served)
    phase_verify_attention(torch, model, d_engine, d_prompts)
    phase_generate(torch, np, model, d_engine, d_prompts, d_served)
    phase_generate_gpt(torch, dev)

    # quantized serving: each engine's copies are freed before the next
    qd, qd_served, qd_launches = phase_serve_quant(
        torch, np, model, d_prompts, "int8", "weight_only_int8")
    _parity_first_decode(torch, "first int8 decode step", qd._sm, qd,
                         d_prompts, qd_served)
    phase_profile_quant(torch, qd, d_prompts, "int8")
    del qd
    _free(torch)
    qe, qe_served, qe_launches = phase_serve_quant(
        torch, np, model, d_prompts, "int4", "weight_only_int4")
    _parity_first_decode(torch, "first int4 decode step", qe._sm, qe,
                         d_prompts, qe_served)
    phase_profile_quant(torch, qe, d_prompts, "int4")
    del qe
    _free(torch)
    f_prompts = d_prompts[:FUSED_QUANT_REQUESTS]
    qf, qf_served, qf_launches = phase_serve_quant_fused_layer(
        torch, np, model, f_prompts)
    _parity_first_decode(torch, "first int8 g128 fused-layer decode step",
                         qf._sm, qf, f_prompts, qf_served)
    phase_profile_quant(torch, qf, d_prompts, "int8_g128_fused_layer")
    del qf
    _free(torch)
    llm_launches = phase_llm_int8(torch, dev)
    launches["wo_int8"] = qd_launches["wo_int8"]
    launches["wo_int4"] = qe_launches["wo_int4"]
    launches["wo_int8_grouped"] = qf_launches["wo_int8_grouped"]
    launches["a8w8"] = llm_launches["a8w8"]
    # PTQ of the served model, then engine b behind the HTTP front
    phase_ptq(torch, np, model)
    phase_http(torch, np, model, d_engine, d_prompts, d_served)

    # training, once every serving model and engine is freed
    del model, engine, d_engine, c_engine
    _free(torch)
    train_launches = phase_train(torch, dev)
    for name in TRAIN_KERNELS:
        launches[name] = train_launches[name]
    _free(torch)
    phase_int8_grad(torch, dev)
    _free(torch)
    packed_launches = phase_packed_mlp(torch, dev)
    for name in PACKED_KERNELS:
        launches[name] = packed_launches[name]
    _free(torch)
    phase_train_gpt(torch, dev)
    _free(torch)
    phase_qat(torch, dev)
    _free(torch)
    phase_optimizers(torch, dev)
    _free(torch)
    lamb_launches = phase_train_lamb(torch, dev)
    for name in LAMB_KERNELS:
        launches[name] = lamb_launches[name]
    _free(torch)
    incubate_launches = phase_incubate(torch, dev)
    for name in INCUBATE_KERNELS:
        launches[name] = incubate_launches[name]
    _free(torch)
    phase_fmt(torch, dev)
    _free(torch)
    phase_encoder(torch, dev)
    _free(torch)
    phase_incubate_functions(torch, dev)

    # Qwen2-MoE: served at full width and depth, then trained at 4 layers
    _free(torch)
    moe_model, moe_prompts, moe_served, moe_launches = phase_serve_moe(
        torch, dev)
    for name in MOE_KERNELS:
        launches[name] = moe_launches[name]
    phase_parity_moe(torch, moe_model, moe_prompts, moe_served)
    del moe_model
    _free(torch)
    phase_train_moe(torch, dev)

    # ERNIE-4.5 (rep 5): served dense, generated with the MoE tail, trained
    # through the fused optimizer step; then the fused step on GPT-2 small
    _free(torch)
    phase_serve_ernie(torch, np, dev)
    _free(torch)
    phase_ernie_moe(torch, dev)
    _free(torch)
    phase_train_ernie(torch, dev)
    _free(torch)
    phase_fused_step(torch, dev)

    summary = []
    for name in sorted(kern):
        row = kern[name]
        src, replaces = _SOURCES[name]
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "shapes": row["shapes"],
            **({"composite_ms": row["composite_ms"]}
               if "composite_ms" in row else {})})
    emit({"kernels": summary + demo_rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
