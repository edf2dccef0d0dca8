#!/usr/bin/env python3
"""One family of kernels of one checkout of this repository, on one GPU,
for comparing two checkouts in one run (the card and its neighbours change
between runs): run it on each tree in turns (A, B, B, A).

    python3 kernel_ab.py <checkout root> <tag> flash [--gpt]
    python3 kernel_ab.py <checkout root> <tag> wo [--engine]
    python3 kernel_ab.py <checkout root> <tag> grad [--incubate]
    python3 kernel_ab.py <checkout root> <tag> a8w8 [--llm-int8]
    python3 kernel_ab.py <checkout root> <tag> epi [--train]
    python3 kernel_ab.py <checkout root> <tag> moe [--train]
    python3 kernel_ab.py <checkout root> <tag> dl [--engine]
    python3 kernel_ab.py <checkout root> <tag> decode [--engine] [--contiguous] [--rep=N ...]
    python3 kernel_ab.py <checkout root> <tag> softmax [--incubate]
    python3 kernel_ab.py <checkout root> <tag> rows [--incubate]
    python3 kernel_ab.py <checkout root> <tag> norm [--engine] [--train]
    python3 kernel_ab.py <checkout root> <tag> swiglu [--engine] [--train[=llama]]
    python3 kernel_ab.py <checkout root> <tag> normbwd [--train]
    python3 kernel_ab.py <checkout root> <tag> spec [--rounds=N]
    python3 kernel_ab.py <checkout root> <tag> fused
    python3 kernel_ab.py <checkout root> <tag> serve [--rounds=N] [--tokens=N]

Prints one JSON line per measurement, each with ``tag``. Family
``flash``:

- ``fwd`` / ``bwd``: the flash rows of ``chip_smoke.py``'s phase 3 (and
  the training shapes): the kernel's cold-L2 ms (``chip_smoke.ColdTimer``),
  SDPA's (forward) or autograd of SDPA's (backward), their ratio, and the
  kernel's error against its plain version;
- ``host``: the host wall time of one wrapper call, forward and backward,
  at a small and two path shapes: the median of five means of 100 calls
  with no synchronise between them (the checks, the allocations, the TMA
  tensor maps and the launches; the device runs behind);
- with ``--gpt``, ``chip_smoke.py``'s ``train_gpt`` phase of that checkout
  (GPT-2 small, B 8 x S 1024: parity, 8 steps, a profile).

Family ``wo`` (the weight-only kernels, rows 12a-12c):

- ``wo``: phase 3's four Llama-3-8B shapes for each kernel (grouped at G
  128): the kernel's cold-L2 ms, cuBLAS bf16 ``torch.matmul`` on the
  dequantised weight, their ratio and the kernel's error against its
  plain version;
- ``host``: the host time of one wrapper call of each kernel at gate/up's
  decode and prefill shapes, measured as for flash;
- with ``--engine``, engines d and e of ``chip_smoke.py`` (Llama-3-8B,
  random weights, ``quant="weight_only_int8"`` and ``"weight_only_int4"``):
  the profile of a decode step at batch 8 and of a 1024-token monolithic
  prefill (``chip_smoke._profile``), each engine freed before the next.

Family ``grad`` (the weight-gradient accumulation, row 21):

- ``grad``: the incubate path's four products at M 4096 and phase 3's
  three rows (into f32, and bf16 at GPT-2's ``mlp.fc``): the kernel's
  cold-L2 ms, ``torch.matmul(x.t(), dy)`` (the bf16 product alone), their
  ratio and the kernel's error against its plain version;
- ``host``: the host time of one wrapper call at two shapes, as for flash;
- with ``--incubate``, ``chip_smoke.py``'s ``incubate`` phase of that
  checkout (12 post-LN blocks at GPT-2 small's width: launches, parity,
  main_grads, and the profile of a micro-batch).

Family ``a8w8`` (the A8W8 product, row 13):

- ``a8w8``: the llm_int8 prefill shape x [1024, 4096] @ w [14336, 4096]
  ("nk", the path's layout) and the same product with a "kn" weight: the
  call's cold-L2 ms, ``torch._int_mm`` on the quantised operands (the int8
  contraction alone), their ratio, the error against the plain version,
  and the device ms of each of the call's kernels (``chip_smoke._profile``
  over 10 warm calls: the quantisation apart from the product);
- ``host``: the host time of one wrapper call at a small and the path
  shape, as for flash;
- with ``--llm-int8``, ``nn.quant.llm_int8_linear`` at that shape with 4
  outlier channels: the call's cold-L2 ms and the profile of a call, the
  A8W8 kernels against the outlier composite (everything else).

Family ``epi`` (the block-epilogue backward, row 10):

- ``epi``: ``chip_smoke.py``'s four phase-3 rows ([4096, 4096] rms and
  [8192, 768] layer norm with a bias, both with the residual cotangent,
  and the gelu and swiglu rows with dropout): the call's cold-L2 ms (the
  partial sums included), autograd of ``F.rms_norm`` / ``F.layer_norm`` on
  x + residual for the two act-free rows and the ratio (autograd's host
  work can outlast the timer's L2 flush, so its device time over 10 warm
  calls and that ratio are given too), the errors against the plain
  version, and the device ms of each of the call's kernels;
- ``host``: the host time of one wrapper call at GPT-2 small's shape;
- with ``--train``, ``chip_smoke.py``'s ``train_gpt`` phase of that
  checkout (GPT-2 small, B 8 x S 1024: parity, 8 steps, a profile with
  row 10's device ms and the step's wall).

Family ``moe`` (the grouped expert product, row 17):

- ``moe``: ``chip_smoke.py``'s three phase-3 rows (one Qwen1.5-MoE layer
  at 2048 tokens, capacity 274: gate/up, down and dx through the
  transposed view of the gate/up stack) and train_moe's capacity 547
  (4096 tokens: gate/up and dx), counts from ``moe_gemm.skewed_counts``:
  the kernel's cold-L2 ms, ``torch.bmm`` on x with its padding rows zeroed,
  their ratio and the error against the plain version;
- ``host``: the host time of one wrapper call at a small shape and at
  gate/up's, as for flash;
- with ``--train``, ``chip_smoke.py``'s ``train_moe`` phase of that
  checkout (Qwen1.5-MoE's widths at 4 layers, B 2 x S 2048: parity, the
  steps, a profile of a step with row 17's device ms).

Family ``dl`` (the decode layer, row 11):

- ``dl``: ``chip_smoke.py``'s phase-3 rows (Llama-3-8B's layer: B 8 over
  Hkv 8 at positions 0..1500, B 1, rep 1 over Hkv 32) and B 16: the
  kernel's cold-L2 ms, its phases from its clock stamps, the port's
  composite path (mmha, the projections, the block epilogues, SwiGLU) and
  the ratio, the errors of y and h against the plain version;
- ``host``: the host time of one wrapper call at B 8;
- with ``--engine``, engine c of ``chip_smoke.py`` (Llama-3-8B, random
  weights, ``fused_decode_layer=True``, block_i tuned into a temporary
  cache): the profile of a decode step at batch 8.

Family ``decode`` (decode attention and RoPE, rows 1 and 4):

- ``mmha``: ``chip_smoke.py``'s phase-3 rows (Llama-3-8B's decode: B 8 over
  Hkv 8 at positions 0..1500 with an inactive row 0, B 1 at position 900,
  B 16, rep 1 over Hkv 32, rep 8 (H 64) and D 64; pages of 16 handed out
  shuffled): the kernel's cold-L2 ms, SDPA's on the gathered view with a
  ``<= pos`` mask (the GQA heads repeated), their ratio, the byte bound and
  the kernel's share of it, the error against the plain version and
  whether two calls give the same bits;
- ``rope``: ``F.rope(q, k, sin, cos)`` on the decode pair q [8, 1, 32,
  128] + k [8, 1, 8, 128] with per-token tables and the prefill pair
  [1, 512, 32, 128] + [1, 512, 8, 128]: cold-L2 ms of the call, of its
  plain version, the launches a call, the error against the plain
  version, and the byte bound;
- ``host``: the host time of one ``mmha_decode`` call at B 8 and of one
  ``F.rope`` call on the decode pair, as for flash;
- with ``--engine``, Llama-3-8B (random weights) on engine a's per-op
  decode path and engine b's fused-epilogue one over one pool: the
  profile of a decode step at batch 8 (``chip_smoke._profile``: per-kernel
  device ms, launches, busy, wall), at the lengths of engine a's first
  8 prompts plus 32;
- with ``--contiguous``, each ``mmha`` row also carries ``bits``, a digest
  of the pool path's output (the inputs are the same on both trees, so
  equal digests are the same bits), and where the tree has
  ``mmha_decode_contiguous``, a ``contiguous`` row: the same pages
  gathered into a ``[B, Hkv, 2048, D]`` cache and read in place (its
  cold-L2 ms, whether it gives the pool path's bits), then the fmt
  phase's shape (``mmha.CONTIGUOUS_ROW``: q [8, 1, 12, 64] over a
  1024-position cache at position 575) against ``reference_mmha`` and
  SDPA on the visible view;
- each ``--rep=N`` adds an ``mmha`` row at B 8 over 4 kv heads of D 128
  with N query heads each (``--rep=5``: ERNIE-4.5's 20 over 4) at the B 8
  row's positions, SDPA with ``enable_gqa`` as its yardstick; a tree whose
  kernel refuses N reports the error in the row.

Family ``fused`` (the fused optimizer step): ``chip_smoke.py``'s
``fused_step`` phase of that checkout (GPT-2 small, AdamW then Lamb, 8
steps eager and 8 fused: the bits, the stats, the step wall, the
optimizer's host ms and the profiler's launches); a tree without the
phase reports so.

Family ``softmax`` (the masked softmax and its backward, row 18):

- ``softmax``: ``chip_smoke.py``'s phase-3 rows (the masked forward at [8,
  12, 1024, 1024] with a [8, 1, 1024, 1024] padding mask, the causal one
  there and at [2, 32, 2048, 2048], the backward there), the incubate
  micro-batch's causal forward and backward at [4, 12, 1024, 1024], the
  tail [1, 3, 1000, 1000], Sk 64, 128, 2048, 8192 and 16384, masks that
  vary over heads ([1, H, Sq, Sk]) and over batches and heads, and f32
  scores: the call's cold-L2 ms, the byte bound (each
  input read once, the causal forward's x only in its lower triangle, the
  mask's distinct bytes) and the kernel's share of it, the library call
  where one computes the same function (``torch._masked_softmax`` with the
  triangle as a boolean ``[S, S]`` mask, at Sq = Sk and where it agrees
  within one bf16 ulp;
  ``torch._softmax_backward_data``), the error against the plain version
  and whether two calls give the same bits;
- ``host``: the host time of one wrapper call of each at a small shape,
  as for flash;
- with ``--incubate``, ``chip_smoke.py``'s ``incubate`` phase of that
  checkout (launches, parity, the profile of a micro-batch).

Family ``rows`` (bias-dropout-LN and dropout-add, rows 19 and 20):

- ``bdl`` / ``da``: ``chip_smoke.py``'s phase-3 rows (row 19 at [8192,
  768] with the p = 0.1 mask and maskless and at [4096, 4096] with it;
  row 20 at [8192, 768] and [4096, 4096]), the incubate micro-batch's
  [4096, 768], the tails (1061 rows at H 1000 and 776), H 8192 and one
  f32 shape each, forward and backward: the call's cold-L2 ms (row 19's
  backward with its sum launch), the byte bound (each row operand read
  or written once in its type, the f32 mask and vectors once) and the
  share of it, the error against the plain version (row 20 must be bit
  for bit) and whether two calls give the same bits (row 19's backward:
  dx, dres and the three sums); beside each, ``copy_ms``: a ``copy_`` of
  as many bytes (half read, half written) under the same timer, and
  ``clean_ms`` / ``copy_clean_ms``: both again with an L2 flushed by
  reading 1 GiB instead of writing it (the cold timer's written flush
  leaves up to 50 MB of dirty lines that the timed call evicts); row 19's
  ``split``: the device ms of each of its kernels over 10 warm calls;
- ``floor``: row 20 forward at 8 elements, the timer's floor for one
  launch;
- ``host``: the host time of one wrapper call of each at a small shape,
  as for flash;
- with ``--incubate``, ``chip_smoke.py``'s ``incubate`` phase of that
  checkout (its profile's ``port_ms_per_call`` gives rows 19 and 20 by
  kernel).

Family ``norm`` (the RMSNorm forward and the block-epilogue forward, rows
2 and 9):

- ``rms`` / ``epi``: every shape the paths launch (row 2 at [1, 4096] and
  [8, 4096] with and without a residual, [512, 4096] and [2048, 2048] with
  one, [4096, 4096] with and without; row 9 rms at [1, 4096], [8, 4096],
  [1024, 4096] and [4096, 4096], layer norm with a bias at [8192, 768],
  and phase 3's [512, 4096] rows with gelu, swiglu, dropout 0.1 and layer
  norm with a bias): the call's cold-L2 ms (the mean of 20 calls, as
  phase 3 times it, and their median), its warm device ms (``split``:
  each kernel's device ms over 10 warm calls), the byte bound (each input
  read once, each output written once) and the share of it, ``copy_ms``:
  a ``copy_`` of as many bytes (half read, half written) under the same
  timer, ``library_ms``: ``F.rms_norm`` where it computes the same
  function (row 2 without a residual), the error against the plain
  version, whether two calls give the same bits, and for dropout whether
  the dropped positions are the counter hash's;
- ``floor``: a ``copy_`` of 16 bytes under the cold timer;
- ``host``: the host time of one wrapper call at [8, 4096] (both rows,
  row 2 with and without the residual) and at [8, 768] layer norm with a
  bias, as for flash;
- with ``--engine``, Llama-3-8B (random weights): the decode-step profiles
  of engines a and b (as ``decode --engine``) and engine b's 1024-token
  monolithic prefill (``chip_smoke._profile``);
- with ``--train``, ``chip_smoke.py``'s ``train`` and ``train_gpt``
  phases of that checkout (the Llama trunks and GPT-2 small, each with the
  profile of a step).

Family ``swiglu`` (the two-operand SwiGLU forward, row 5):

- ``swiglu``: every shape the paths launch ([1, 14336] and [8, 14336]
  decode, [512, 14336] and [1024, 14336] prefill, [4096, 14336] the Llama
  train step, [16440, 1408] the Qwen1.5-MoE experts' capacity tensor in
  serve_moe, [2048, 5632] its shared expert) and a tail [3, 77]: the call's
  cold-L2 ms (mean and median of 20 calls), its warm device ms
  (``split``), the byte bound (g and u read, y written once) and the share
  of it, ``copy_ms``: a ``copy_`` of as many bytes (half read, half
  written) under the same timer, the error against the plain version and
  whether two calls give the same bits; ``library_ms`` is null: no one
  PyTorch call computes ``silu(g) * u``;
- ``extreme``: g at +-88, +-100 and +-1e4 (and 0) against the plain
  version, element by element in bf16 ulps;
- ``floor``: a ``copy_`` of 16 bytes under the cold timer;
- ``host``: the host time of one wrapper call at [8, 14336] and [4096,
  14336], as for flash;
- with ``--engine``, the decode-step profiles of engines a and b and
  engine b's 1024-token monolithic prefill (as ``norm --engine``);
- with ``--train``, ``chip_smoke.py``'s ``train``, ``serve_moe`` and
  ``train_moe`` phases of that checkout (each with its profile); with
  ``--train=llama`` the ``train`` phase alone;
- with ``--probe=threads,unroll,blocks_sm``, every shape launched as
  ``swiglu.make(n, threads, unroll, blocks_sm)`` gives it (a checkout
  whose plan has those choices).

Family ``normbwd`` (the RMSNorm backward, row 3):

- ``rms_bwd``: [4096, 4096] (the Llama train step) and [4096, 2048] (the
  Qwen2-MoE train step), each with and without the sum's cotangent, and a
  tail [37, 776]: the call's cold-L2 ms (the dw sum included; mean and
  median), its warm device ms by kernel (``split``), the byte bound (h, g
  and the cotangent read, dx written, w read and dw written once) and the
  share of it, ``copy_ms`` under the same timer, ``library_ms``: autograd
  of ``F.rms_norm`` (without the cotangent; its device ms too), dx's and
  dw's error against the plain version and whether two calls give the same
  bits of dx and dw;
- ``epi_yardstick``: row 10 (``fused_epilogue_bwd``, rms, no activation)
  at [4096, 4096] with the cotangent, the same function plus one more
  written row (``dres``), timed the same way;
- ``host``: the host time of one wrapper call at [4096, 4096] with and
  without the cotangent;
- with ``--train``, ``chip_smoke.py``'s ``train`` and ``train_moe``
  phases (their profiles carry the backward's device ms by kernel);
- with ``--probe=blocks_sm``, every shape launched as
  ``rms_norm.make_bwd(rows, hidden, has_gh, blocks_sm)`` gives it (a
  checkout whose plan has that choice).

Family ``spec`` (speculative decoding on the host-bound serving path;
one checkout's spec-on against spec-off, so it runs on one tree):
Llama-3-8B (random weights) serves engine b's traffic of ``chip_smoke.py``
once with ``spec_k=0`` for the replay drafter's reference, then ``N``
rounds (default 4) of three engines of b's configuration, the order
rotated a round: ``off`` (``spec_k=0``), ``ngram`` (``spec_k=4``) and
``replay`` (``spec_k=4``, the drafter replaying the reference). One line
an engine run (``chip_smoke._serve_spec``'s row: tokens/s, decode and
verify steps and their ms, tokens a step, drafts, the drafter's host ms),
then ``spec_summary``: each engine's median tokens/s and each spec-on
engine's ratio to ``off`` a round (the rounds' median, and in how many
rounds it beat ``off``).

Family ``serve`` (engine b's host-bound serving path and its hooks):
Llama-3-8B (random weights) on engine b's configuration serves engine b's
traffic of ``chip_smoke.py`` once as its ``serve`` phase does
(``chip_smoke._serve``: one line ``serve`` with that phase's row), then
``N`` rounds (default 6) of four turns of the same prompts at ``M`` new
tokens each (default 32), timed by this script's own
``chip_smoke._serve_turn`` (tokens/s over the window, the scheduler
iteration's wall and its host work outside the forward): on a checkout
with ``paddle_tpu_torch.observability``, metrics, tracing and the flight
recorder all on, off, off, on; on one without, four turns as they are.
One line a turn, then ``serve_summary``: each mode's medians and range.

The checkout's own ``paddle_tpu_torch`` and ``chip_smoke.py`` are imported
(the tree is put first on ``sys.path``), so a parent commit unpacked with
``git archive`` into an ignored directory measures as it was; the
``serve`` family's turns are timed by the ``chip_smoke.py`` beside this
script, the same code on either tree.
"""

import json
import sys
import time


def main() -> int:
    root, tag, family = sys.argv[1], sys.argv[2], sys.argv[3]
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import paddle_tpu_torch

    if not paddle_tpu_torch.__file__.startswith(root) \
            or not cs.__file__.startswith(root):
        cs.fail(f"{root}: its modules were not the ones imported")
    families = {"flash": _flash, "wo": _wo, "grad": _grad, "a8w8": _a8w8,
                "epi": _epi, "moe": _moe, "dl": _dl, "decode": _decode,
                "softmax": _softmax, "rows": _rows,
                "norm": _norm, "swiglu": _swiglu, "normbwd": _normbwd,
                "spec": _spec, "fused": _fused, "serve": _serve}
    if family not in families:
        cs.fail(f"family {family!r}: one of {', '.join(families)}")
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = cs.ColdTimer(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def emit(**row):
        print(json.dumps({"tag": tag, **row}), flush=True)

    families[family](torch, cs, dev, timer, randn, emit)
    return 0


def _flash(torch, cs, dev, timer, randn, emit):
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    def mask_of(seg, s):
        return ((seg[:, :, None] == seg[:, None, :])
                & torch.ones(s, s, dtype=torch.bool, device=dev).tril())[:, None]

    # forward: (b, s, h, h_kv, d, segments, lse), causal
    for b, s, h, h_kv, d, with_seg, lse in (
            (1, 1024, 32, 8, 128, False, False), (1, 1531, 32, 8, 128, False, False),
            (1, 2048, 32, 8, 128, False, False), (2, 512, 32, 8, 128, True, True),
            (8, 1024, 12, 12, 64, False, True), (2, 2048, 32, 8, 128, False, True)):
        q, k, v = randn(b, s, h, d), randn(b, s, h_kv, d), randn(b, s, h_kv, d)
        seg = fa.segment_ids(s, [[100, 300, 301], [256]]).to(dev) if with_seg else None
        got = fa.flash_attention(q, k, v, True, seg, lse)
        ref = fa.flash_attention_plain(q, k, v, True, seg, lse)
        if lse:
            got, ref = got[0], ref[0]
        err, tol = cs.compare(torch, got, ref)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None if seg is None else mask_of(seg, s)
        lib = timer(lambda: TF.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None, enable_gqa=True))
        ms = timer(lambda: fa.flash_attention(q, k, v, True, seg, lse))
        emit(fwd=[b, s, h, h_kv, d, "causal"] + (["segments"] if with_seg else [])
             + (["lse"] if lse else []), ms=ms, sdpa_ms=lib, ratio=ms / lib,
             max_abs_err=err, tol=tol)

    # backward: (b, s, h, h_kv, d, causal, segments)
    for b, s, h, h_kv, d, causal, with_seg in (
            (2, 2048, 32, 8, 128, True, False), (2, 1024, 32, 8, 128, True, True),
            (1, 1024, 32, 8, 64, False, False), (8, 1024, 12, 12, 64, True, False)):
        q, k, v, do = (randn(b, s, h, d), randn(b, s, h_kv, d), randn(b, s, h_kv, d),
                       randn(b, s, h, d))
        seg = fa.segment_ids(s, [[s // 10, s // 3, s // 3 + 1], [s // 2]]).to(dev) \
            if with_seg else None
        out, lse = fa.flash_attention(q, k, v, causal, seg, True)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal, seg)
        ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal, seg)
        rel = max(((a.float() - r.float()).norm() / r.float().norm()).item()
                  for a, r in zip(got, ref))
        del ref
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        mask = None if seg is None else mask_of(seg, s)
        lo = TF.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                             is_causal=causal and mask is None,
                                             enable_gqa=True)
        g = do.transpose(1, 2)
        lib = timer(lambda: torch.autograd.grad(lo, (qt, kt, vt), g, retain_graph=True))
        ms = timer(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, causal, seg))
        emit(bwd=[b, s, h, h_kv, d, "causal" if causal else "full"]
             + (["segments"] if with_seg else []), ms=ms, autograd_sdpa_ms=lib,
             ratio=ms / lib, rel_l2=rel)
        del q, k, v, do, out, lse, got, lo

    # the wrapper's host time a call
    for b, s, h, h_kv, d in ((1, 128, 8, 2, 64), (1, 1024, 32, 8, 128),
                             (8, 1024, 12, 12, 64)):
        q, k, v, do = (randn(b, s, h, d), randn(b, s, h_kv, d), randn(b, s, h_kv, d),
                       randn(b, s, h, d))
        out, lse = fa.flash_attention(q, k, v, True, None, True)
        fwd = _host_us(torch, lambda: fa.flash_attention(q, k, v, True))
        bwd = _host_us(torch, lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, True))
        emit(host=[b, s, h, h_kv, d], fwd_us=fwd, bwd_us=bwd)

    if "--gpt" in sys.argv[4:]:
        cs.phase_train_gpt(torch, dev)


def _wo(torch, cs, dev, timer, randn, emit):
    from paddle_tpu_torch.ops.kernels import wo_matmul as wo

    bf = torch.bfloat16
    group = cs.QUANT_GROUP

    def int8(*shape, lo=-127):
        return torch.randint(lo, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def scales(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 2e-3 + 1e-4

    gen = torch.Generator(device=dev).manual_seed(4321)
    for name in ("wo_int8", "wo_int8_grouped", "wo_int4"):
        for m, k, n in ((8, 4096, 14336), (8, 14336, 4096),
                        (1024, 4096, 14336), (1531, 4096, 1024)):
            x = randn(m, k)
            if name == "wo_int4":
                w, s = int8(k, n // 2, lo=-128), scales(n)
                fn, plain = wo.wo_int4, wo.wo_int4_matmul_plain
                wd = (wo.unpack_int4_halves(w).float() * s).to(bf)
            elif name == "wo_int8_grouped":
                w, s = int8(k, n), scales(k // group, n)
                fn, plain = wo.wo_int8_grouped, wo.wo_int8_matmul_plain
                wd = wo.dequant_grouped(w, s).to(bf)
            else:
                w, s = int8(k, n), scales(n)
                fn, plain = wo.wo_int8, wo.wo_int8_matmul_plain
                wd = (w.float() * s).to(bf)
            err, tol = cs.compare(torch, fn(x, w, s), plain(x, w, s))
            lib = timer(lambda: x @ wd)
            ms = timer(lambda: fn(x, w, s))
            emit(wo=[name, m, k, n], ms=ms, cublas_ms=lib, ratio=ms / lib,
                 max_abs_err=err, tol=tol)
            if (m, k) in ((8, 4096), (1024, 4096)):
                emit(host=[name, m, k, n],
                     us=_host_us(torch, lambda: fn(x, w, s)))
            del x, w, s, wd

    if "--engine" in sys.argv[4:]:
        import numpy as np

        from paddle_tpu_torch.models import llama3_8b
        from paddle_tpu_torch.serving import LLMEngine, ServingConfig

        model = llama3_8b(device=dev, seed=0)
        prompts = cs.default_prompts(np, model.cfg.vocab_size)
        for label, quant in (("d", "weight_only_int8"),
                             ("e", "weight_only_int4")):
            engine = LLMEngine(model, cs._quant_config(ServingConfig,
                                                       quant=quant))
            sm = engine._sm
            tables, toks, pos, held = cs._batch_tables(torch, engine, prompts)
            try:
                emit(**{f"engine_{label}_decode_step": cs._profile(
                    torch, lambda: sm.decode_forward(toks, pos, tables),
                    reps=10)})
                mono = torch.arange(1024, device=dev)[None] + 7
                emit(**{f"engine_{label}_monolithic_prefill_1024": cs._profile(
                    torch, lambda: sm.prefill_forward(mono, 1024, tables[0]),
                    reps=2)})
            finally:
                engine.pool.free(held)
            del engine, sm
            cs._free(torch)


# (M, K, N, accumulator dtype): the incubate path's four products, then
# chip_smoke.py's phase-3 rows (GPT-2 small's mlp.fc, Llama-3-8B's gate)
GRAD_SHAPES = ((4096, 768, 2304, "float32"), (4096, 768, 768, "float32"),
               (4096, 768, 3072, "float32"), (4096, 3072, 768, "float32"),
               (8192, 768, 3072, "float32"), (4096, 4096, 14336, "float32"),
               (8192, 768, 3072, "bfloat16"))


def _grad(torch, cs, dev, timer, randn, emit):
    from paddle_tpu_torch.ops.kernels import linear_grad_add as lga

    for m, k, n, acc_name in GRAD_SHAPES:
        x, dy = randn(m, k), randn(m, n)
        acc0 = (randn(k, n).float() * 4).to(getattr(torch, acc_name))
        got = lga.linear_grad_add(x, dy, acc0.clone())
        ref = lga.linear_grad_add_plain(x, dy, acc0.clone())
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scratch = acc0.clone()
        lib = timer(lambda: torch.matmul(x.t(), dy))
        ms = timer(lambda: lga.linear_grad_add(x, dy, scratch))
        emit(grad=[m, k, n, acc_name], ms=ms, matmul_ms=lib, ratio=ms / lib,
             max_abs_err=err, ref_max=ref.float().abs().max().item())
        del x, dy, acc0, got, ref, scratch

    # the wrapper's host time a call
    for m, k, n in ((256, 256, 256), (4096, 768, 2304)):
        x, dy = randn(m, k), randn(m, n)
        acc = torch.zeros(k, n, device=dev)
        emit(host=["linear_grad_add", m, k, n],
             us=_host_us(torch, lambda: lga.linear_grad_add(x, dy, acc)))

    if "--incubate" in sys.argv[4:]:
        cs.phase_incubate(torch, dev)


def _split(torch, cs, fn):
    """Device ms a call of each of the port's kernels that ``fn``
    launches (10 warm calls under the profiler), the rest, and all of
    it."""
    prof = cs._profile(torch, fn, reps=10)
    return {"kernels_ms": prof.get("port_ms_per_call"),
            "other_ms": (prof.get("ms_per_call") or {}).get("other"),
            "matmul_ms": (prof.get("ms_per_call") or {}).get("matmul"),
            "device_ms": prof.get("busy_ms_per_call"),
            "launches": prof.get("launches_per_call")}


def _a8w8(torch, cs, dev, timer, randn, emit):
    from paddle_tpu_torch.ops.kernels import a8w8_matmul as a8

    gen = torch.Generator(device=dev).manual_seed(8888)
    m, k, n = 1024, 4096, 14336
    w = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                      dtype=torch.int8)
    ws = torch.rand(n, generator=gen, device=dev) * 2e-3 + 1e-4
    x = randn(m, k)
    xq = a8.row_quantize(x)[0].to(torch.int8)
    wt = w.t()                     # [K, N], column-major: _int_mm's layout
    lib = timer(lambda: torch._int_mm(xq, wt))
    for layout, wl in (("nk", w), ("kn", w.t().contiguous())):
        err, tol = cs.compare(torch, a8.a8w8_matmul(x, wl, ws, layout),
                              a8.a8w8_matmul_plain(x, wl, ws, layout))
        ms = timer(lambda: a8.a8w8_matmul(x, wl, ws, layout))
        emit(a8w8=[m, k, n, layout], ms=ms, int_mm_ms=lib, ratio=ms / lib,
             max_abs_err=err, tol=tol,
             **_split(torch, cs, lambda: a8.a8w8_matmul(x, wl, ws, layout)))
        del wl
    for mm, kk, nn in ((128, 256, 256), (m, k, n)):
        xs, wsm = randn(mm, kk), w[:nn, :kk].contiguous()
        emit(host=["a8w8", mm, kk, nn, "nk"], us=_host_us(
            torch, lambda: a8.a8w8_matmul(xs, wsm, ws[:nn], "nk")))
        del xs, wsm

    if "--llm-int8" in sys.argv[4:]:
        from paddle_tpu_torch.nn.quant import llm_int8_linear

        g2 = torch.Generator(device=dev).manual_seed(99)
        xo = torch.randn(m, k, generator=g2, device=dev)
        xo[:, [7, 100, 2000, 4000]] *= 40.0
        xo = xo.to(torch.bfloat16)
        bias = (torch.randn(n, generator=g2, device=dev) * 0.1).to(
            torch.bfloat16)
        with torch.inference_mode():
            ms = timer(lambda: llm_int8_linear(xo, w, bias, ws))
            emit(llm_int8_linear=[m, k, n, "outliers 4"], ms=ms,
                 **_split(torch, cs, lambda: llm_int8_linear(xo, w, bias, ws)))


# (rows, hidden, act, norm, p, bias): chip_smoke.py's phase-3 rows of row 10
EPI_SHAPES = ((4096, 4096, None, "rms", 0.0, False),
              (8192, 768, None, "layer", 0.0, True),
              (4096, 4096, "gelu", "layer", 0.2, True),
              (4096, 4096, "swiglu", "rms", 0.4, False))


def _epi(torch, cs, dev, timer, randn, emit):
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels import block_epilogue as be

    for rows, hid, act, norm, p, bias_on in EPI_SHAPES:
        xw = 2 * hid if act == "swiglu" else hid
        w = (1.0 + randn(hid).float() * 0.1).to(torch.bfloat16)
        h, gy, gh = randn(rows, hid), randn(rows, hid), randn(rows, hid)
        x = randn(rows, xw) if act else None
        args = (h, x, w, gy, gh, 1234, p, 1e-5, act, norm, bias_on)
        got = be.fused_epilogue_bwd(*args)
        ref = be.fused_epilogue_bwd_plain(*args)
        errs = {}
        for nm, a, r in zip(("dx", "dres", "dw", "db"), got, ref):
            if r is not None:
                errs[nm] = cs.compare(torch, a, r)[0] / max(
                    r.float().abs().max().item(), 1e-30)
        del got, ref
        lib = lib_dev = None
        if act is None:
            xl = randn(rows, hid).requires_grad_()
            rl = randn(rows, hid).requires_grad_()
            wl = w.clone().requires_grad_()
            hl = xl + rl
            if norm == "rms":
                yl, ins = TF.rms_norm(hl, (hid,), wl, 1e-5), (xl, rl, wl)
            else:
                bl = randn(hid).requires_grad_()
                yl = TF.layer_norm(hl, (hid,), wl, bl, 1e-5)
                ins = (xl, rl, wl, bl)
            def grad():
                return torch.autograd.grad((yl, hl), ins, (gy, gh),
                                           retain_graph=True)
            lib = timer(grad)
            lib_dev = _split(torch, cs, grad)["device_ms"]
            del xl, rl, hl, yl, ins, grad
        ms = timer(lambda: be.fused_epilogue_bwd(*args))
        split = _split(torch, cs, lambda: be.fused_epilogue_bwd(*args))
        emit(epi=[rows, hid, f"act={act}", norm, f"p={p}",
                  "bias" if bias_on else "no bias"], ms=ms, autograd_ms=lib,
             ratio=None if lib is None else ms / lib,
             autograd_device_ms=lib_dev,
             device_ratio=split["device_ms"] / lib_dev
             if lib_dev and split["device_ms"] else None,
             rel_err=errs, **split)
        del h, gy, gh, x
    h, gy, gh = randn(8192, 768), randn(8192, 768), randn(8192, 768)
    w = randn(768)
    emit(host=["block_epilogue_bwd", 8192, 768, "layer", "bias"],
         us=_host_us(torch, lambda: be.fused_epilogue_bwd(
             h, None, w, gy, gh, 0, 0.0, 1e-5, None, "layer", True)))

    if "--train" in sys.argv[4:]:
        cs.phase_train_gpt(torch, dev)


def _moe(torch, cs, dev, timer, randn, emit):
    from paddle_tpu_torch.ops.kernels import moe_gemm

    e, k, h, f = 60, 4, 2048, 1408
    w_gate, w_down = randn(e, h, f) * 0.02, randn(e, f, h) * 0.02
    for tokens, rows in ((2048, ("gate/up", "down", "dx")),
                         (4096, ("gate/up", "dx"))):
        cap = -(-2 * tokens * k // e)
        counts = moe_gemm.skewed_counts(e, tokens * k, cap, seed=81).to(dev)
        live = moe_gemm.live_rows(counts, cap)
        x, act = randn(e, cap, h), randn(e, cap, f)
        cases = {"gate/up": (x, w_gate), "down": (act, w_down),
                 "dx": (act, w_gate.transpose(1, 2))}
        for label in rows:
            a, w = cases[label]
            err, tol = cs.compare(torch, moe_gemm.grouped_matmul(a, w, counts),
                                  moe_gemm.grouped_matmul_plain(a, w, counts))
            padded = torch.where(live, a, torch.zeros((), dtype=a.dtype,
                                                      device=dev))
            lib = timer(lambda: torch.bmm(padded, w))
            ms = timer(lambda: moe_gemm.grouped_matmul(a, w, counts))
            emit(moe=[label, list(a.shape), list(w.shape), "capacity", cap,
                      "live rows", int(counts.sum())], ms=ms, bmm_ms=lib,
                 ratio=ms / lib, max_abs_err=err, tol=tol)
            del padded
        if tokens == 2048:
            emit(host=["moe_gemm", "gate/up", e, cap, h, f], us=_host_us(
                torch, lambda: moe_gemm.grouped_matmul(x, w_gate, counts)))
        del x, act
    xs, ws = randn(4, 64, 256), randn(4, 256, 384)
    cs_small = torch.tensor([0, 64, 10, 33], dtype=torch.int32, device=dev)
    emit(host=["moe_gemm", 4, 64, 256, 384], us=_host_us(
        torch, lambda: moe_gemm.grouped_matmul(xs, ws, cs_small)))
    del w_gate, w_down

    if "--train" in sys.argv[4:]:
        cs._free(torch)
        cs.phase_train_moe(torch, dev)


def _dl(torch, cs, dev, timer, randn, emit):
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels import block_epilogue as be
    from paddle_tpu_torch.ops.kernels import decode_layer as dl
    from paddle_tpu_torch.ops.kernels import mmha, swiglu

    hd, inter, d, ps, eps = 4096, 14336, 128, 16, 1e-5
    wo = randn(hd, 32 * d) * 0.02
    wg, wu = randn(inter, hd) * 0.02, randn(inter, hd) * 0.02
    wd = randn(hd, inter) * 0.02
    w_post = (1.0 + randn(hd).float() * 0.1).to(torch.bfloat16)
    w_next = (1.0 + randn(hd).float() * 0.1).to(torch.bfloat16)
    full = [0, 18, 256, 257, 701, 1024, 1201, 1501]
    for lengths, h_kv, label in (
            (full, 8, "B 8"), ([901], 8, "B 1"),
            ([0] + [100 + 190 * r for r in range(1, 8)], 32, "rep 1"),
            (full * 2, 8, "B 16")):
        b = len(lengths)
        tables, pos, n_pages = cs._paged(torch, dev, lengths, ps, 2048 // ps, 7)
        args = (randn(b, 32, d), randn(n_pages, h_kv, ps, d),
                randn(n_pages, h_kv, ps, d), tables, pos, randn(b, hd), wo,
                w_post, wg, wu, wd, w_next)
        got = dl.decode_layer(*args, eps, eps)
        ref = dl.decode_layer_plain(*args, eps, eps)
        tol_y, tol_h = cs.decode_layer_tol(torch, args, *ref, eps=eps)
        err_y = cs.compare(torch, got[0], ref[0])[0]
        err_h = cs.compare(torch, got[1], ref[1])[0]
        del got, ref
        q, kl, vl, hres = args[0], args[1], args[2], args[5]

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
        ms = timer(lambda: dl.decode_layer(*args, eps, eps))
        comp = timer(composite)
        emit(dl=[label, "Hkv", h_kv, "pos", pos.tolist()], ms=ms,
             composite_ms=comp, ratio=ms / comp, phase_ms=phases,
             max_abs_err=err_y, tol=tol_y, max_abs_err_h=err_h, tol_h=tol_h)
        if label == "B 8":
            emit(host=["decode_layer", "B 8"], us=_host_us(
                torch, lambda: dl.decode_layer(*args, eps, eps)))
        del args
    del wo, wg, wu, wd

    if "--engine" in sys.argv[4:]:
        import os
        import tempfile

        import numpy as np

        from paddle_tpu_torch.models import llama3_8b
        from paddle_tpu_torch.serving import (LLMEngine, ServingConfig,
                                              ServingModel)

        cs._free(torch)
        tmp = tempfile.mkdtemp(prefix="kernel_ab_tune_")
        os.environ["PADDLE_TPU_TUNE_CACHE"] = os.path.join(tmp, "tuning.json")
        model = llama3_8b(device=dev, seed=0)
        prompts = cs.default_prompts(np, model.cfg.vocab_size)
        engine = LLMEngine(model, cs._fused_layer_config(ServingConfig))
        layer = ServingModel(model, fused_decode_layer=True).bind_pool(
            engine.pool)
        tables, toks, pos, held = cs._batch_tables(torch, engine, prompts)
        try:
            emit(engine_c_decode_step=cs._profile(
                torch, lambda: layer.decode_forward(toks, pos, tables),
                reps=10), block_i=(engine.tuning or {}).get("block_i"))
        finally:
            engine.pool.free(held)
            engine.shutdown()


#: the decode family's mmha rows: (label, lengths, H, Hkv, D); kept here,
#: not read from the checkout, so that a parent without them measures too
_FULL = [0, 18, 256, 257, 701, 1024, 1201, 1501]
DECODE_ROWS = (("B 8", _FULL, 32, 8, 128), ("B 1 pos 900", [901], 32, 8, 128),
               ("B 16", _FULL * 2, 32, 8, 128),
               ("rep 1", [0] + [100 + 190 * r for r in range(1, 8)], 32, 32,
                128),
               ("rep 8", _FULL, 64, 8, 128), ("D 64", _FULL, 32, 8, 64))


def _decode(torch, cs, dev, timer, randn, emit):
    import torch.nn.functional as TF

    from paddle_tpu_torch.models.llama import LlamaConfig, rope_tables
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.kernels import WRAPPERS, mmha

    ps = 16
    contiguous = "--contiguous" in sys.argv[4:]
    reps = [int(a.split("=", 1)[1]) for a in sys.argv[4:]
            if a.startswith("--rep=")]
    added = [(f"rep {n} over Hkv 4", _FULL, 4 * n, 4, 128) for n in reps]
    rows = list(DECODE_ROWS) + added
    for label, lengths, h, h_kv, d in rows:
        b = len(lengths)
        tables, pos, n_pages = cs._paged(torch, dev, lengths, ps, 2048 // ps, 7)
        q = randn(b, 1, h, d)
        kp, vp = randn(n_pages, h_kv, ps, d), randn(n_pages, h_kv, ps, d)
        try:
            got = mmha.mmha_decode(q, kp, vp, tables, pos)
        except (ValueError, RuntimeError) as e:
            emit(mmha=[label, "H", h, "Hkv", h_kv, "D", d], error=str(e))
            continue
        again = mmha.mmha_decode(q, kp, vp, tables, pos)
        err, tol = cs.compare(torch, got, mmha.mmha_plain(q, kp, vp, tables, pos))
        kc, vc = mmha.gather_pages(kp, tables), mmha.gather_pages(vp, tables)
        mask = (torch.arange(kc.shape[2], device=dev)[None, :]
                <= pos[:, None])[:, None, None, :]
        qt = q.transpose(1, 2)
        if any(label == row[0] for row in added):
            kr, vr = kc, vc
            sdpa = timer(lambda: TF.scaled_dot_product_attention(
                qt, kc, vc, attn_mask=mask, enable_gqa=True))
        else:
            kr = kc.repeat_interleave(h // h_kv, dim=1)
            vr = vc.repeat_interleave(h // h_kv, dim=1)
            sdpa = timer(lambda: TF.scaled_dot_product_attention(
                qt, kr, vr, attn_mask=mask))
        del kc, vc, kr, vr, mask
        ms = timer(lambda: mmha.mmha_decode(q, kp, vp, tables, pos))
        seen = int((pos + 1).sum())
        nbytes = 2 * seen * h_kv * d * 2 + 2 * b * h * d * 2 + tables.numel() * 4
        bound = nbytes / cs.MEM_BYTES_PER_S * 1e3
        emit(mmha=[label, "H", h, "Hkv", h_kv, "D", d, "pos", pos.tolist()],
             ms=ms, sdpa_ms=sdpa, ratio=ms / sdpa, bound_ms=bound,
             bound_share=bound / ms, max_abs_err=err, tol=tol,
             same_bits=bool(torch.equal(got, again)))
        if label == "B 8":
            emit(host=["mmha_decode", "B 8"], us=_host_us(
                torch, lambda: mmha.mmha_decode(q, kp, vp, tables, pos)))
        if contiguous:
            emit(bits=["mmha", label], digest=_digest(torch, got))
            if hasattr(mmha, "mmha_decode_contiguous"):
                kc, vc = mmha.gather_pages(kp, tables), \
                    mmha.gather_pages(vp, tables)
                cont = mmha.mmha_decode_contiguous(q, kc, vc, pos)
                emit(contiguous=[label, "T", kc.shape[2]],
                     ms=timer(lambda: mmha.mmha_decode_contiguous(q, kc, vc,
                                                                  pos)),
                     pool_ms=ms, same_bits_as_pool=bool(torch.equal(cont,
                                                                    got)))
                del kc, vc
    if contiguous and hasattr(mmha, "mmha_decode_contiguous"):
        label, lengths, h, h_kv, d, t = mmha.CONTIGUOUS_ROW
        b = len(lengths)
        q = randn(b, 1, h, d)
        kc, vc = randn(b, h_kv, t, d), randn(b, h_kv, t, d)
        pos = torch.tensor([n - 1 for n in lengths], dtype=torch.int32,
                           device=dev)
        got = mmha.mmha_decode_contiguous(q, kc, vc, pos)
        err, tol = cs.compare(torch, got, mmha.reference_mmha(q, kc, vc, pos))
        n = max(lengths)
        qt, kv, vv = q.transpose(1, 2), kc[:, :, :n], vc[:, :, :n]
        seen = sum(lengths)
        nbytes = 2 * seen * h_kv * d * 2 + 2 * b * h * d * 2 + b * t // 16 * 4
        bound = nbytes / cs.MEM_BYTES_PER_S * 1e3
        ms = timer(lambda: mmha.mmha_decode_contiguous(q, kc, vc, pos))
        emit(contiguous=[label], ms=ms,
             plain_ms=timer(lambda: mmha.reference_mmha(q, kc, vc, pos)),
             sdpa_ms=timer(lambda: TF.scaled_dot_product_attention(qt, kv,
                                                                   vv)),
             bound_ms=bound, bound_share=bound / ms, max_abs_err=err,
             tol=tol)

    cos_t, sin_t = rope_tables(LlamaConfig(), 2048, dev)
    dpos = torch.tensor(_FULL, device=dev)
    for label, (b, s), c, sn in (
            ("decode", (8, 1), cos_t[dpos], sin_t[dpos]),
            ("prefill", (1, 512), cos_t[:512], sin_t[:512])):
        q, k = randn(b, s, 32, 128), randn(b, s, 8, 128)
        rope = WRAPPERS["rope"]
        before = rope.launches
        gq, gk = F.rope(q, k, sn, c)
        launches = rope.launches - before
        pq, pk = F.rope(q, k, sn, c, plain=True)
        err = max(cs.compare(torch, gq, pq)[0], cs.compare(torch, gk, pk)[0])
        tol = min(cs.compare(torch, gq, pq)[1], cs.compare(torch, gk, pk)[1])
        n = b * s * 40 * 128
        bound = (2 * n * 2 + 2 * c.numel() * 4) / cs.MEM_BYTES_PER_S * 1e3
        ms = timer(lambda: F.rope(q, k, sn, c))
        emit(rope=[label, f"q [{b}, {s}, 32, 128] + k [{b}, {s}, 8, 128]"],
             ms=ms, plain_ms=timer(lambda: F.rope(q, k, sn, c, plain=True)),
             launches_a_call=launches, bound_ms=bound, bound_share=bound / ms,
             max_abs_err=err, tol=tol)
        if label == "decode":
            emit(host=["F.rope", "decode pair"], us=_host_us(
                torch, lambda: F.rope(q, k, sn, c)))

    if "--engine" in sys.argv[4:]:
        _engine_profiles(torch, cs, dev, emit)


def _digest(torch, t):
    """A short digest of a tensor's bits."""
    import hashlib
    raw = t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def _spec(torch, cs, dev, timer, randn, emit):
    import numpy as np

    from paddle_tpu_torch.models import llama3_8b

    rounds = int(next((a.split("=", 1)[1] for a in sys.argv[4:]
                       if a.startswith("--rounds=")), 4))
    cs._free(torch)
    model = llama3_8b(device=dev, seed=0)
    prompts = cs.default_prompts(np, model.cfg.vocab_size)
    _, ref, _ = cs._serve_spec(torch, np, model, prompts, spec_k=0)
    replay = cs._ReplayDrafter(prompts, ref, model.cfg.vocab_size)
    engines = (("off", None, {"spec_k": 0}), ("ngram", None, {}),
               ("replay", replay, {}))
    tps: dict = {name: [] for name, _, _ in engines}
    for r in range(rounds):
        for name, drafter, kw in engines[r % 3:] + engines[:r % 3]:
            row, _, _ = cs._serve_spec(torch, np, model, prompts, drafter,
                                      **kw)
            tps[name].append(row["tokens_per_s"])
            emit(spec_engine=name, round=r,
                 **{k: v for k, v in row.items() if k != "pages"})
    summary = {"rounds": rounds,
               "median_tokens_per_s": {n: float(np.median(v))
                                       for n, v in tps.items()}}
    for name in ("ngram", "replay"):
        ratios = [a / b for a, b in zip(tps[name], tps["off"])]
        summary[name] = {"ratio_median": float(np.median(ratios)),
                         "beat_off": sum(x > 1.0 for x in ratios),
                         "ratios": ratios}
    emit(spec_summary=summary)
    del model
    cs._free(torch)


def _own_smoke():
    """The ``chip_smoke.py`` beside this script, whichever checkout's
    modules are measured."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_own", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _serve(torch, cs, dev, timer, randn, emit):
    import importlib.util

    import numpy as np

    from paddle_tpu_torch.models import llama3_8b
    from paddle_tpu_torch.serving import LLMEngine, ServingConfig

    arg = lambda name, d: int(next(  # noqa: E731
        (a.split("=", 1)[1] for a in sys.argv[4:]
         if a.startswith(f"--{name}=")), d))
    rounds, tokens = arg("rounds", 6), arg("tokens", 32)
    own = _own_smoke()
    hooks = importlib.util.find_spec("paddle_tpu_torch.observability")
    modes = (True, False, False, True) if hooks else (None,) * 4
    cs._free(torch)
    model = llama3_8b(device=dev, seed=0)
    engine = LLMEngine(model, cs._quant_config(ServingConfig))
    prompts = cs.default_prompts(np, model.cfg.vocab_size)
    reqs, _, wall, launches, stats = cs._serve(torch, np, engine, prompts)
    row = cs._serve_row(torch, np, engine, reqs, wall, launches, stats)
    emit(serve={k: v for k, v in row.items()
                if k not in ("pages", "launches", "prompt_lens")})
    turns = []
    for r in range(rounds):
        for on in modes:
            turns.append(own._serve_turn(engine, prompts, tokens, hooks=on))
            emit(turn=turns[-1], round=r)
    emit(serve_summary={"rounds": rounds, "tokens": tokens,
                        "medians": own._turn_medians(turns)})
    engine.shutdown()
    del model, engine
    cs._free(torch)


def _engine_profiles(torch, cs, dev, emit, prefill=False):
    """Llama-3-8B (random weights) on engine a's per-op decode path and
    engine b's fused-epilogue one over one pool: the profile of a decode
    step at batch 8 (``chip_smoke._profile``: per-kernel device ms,
    launches, busy, wall), at the lengths of engine a's first 8 prompts
    plus 32; with ``prefill``, engine b's 1024-token monolithic prefill
    too."""
    import numpy as np

    from paddle_tpu_torch.models import llama3_8b
    from paddle_tpu_torch.serving import LLMEngine, ServingConfig, \
        ServingModel

    cs._free(torch)
    model = llama3_8b(device=dev, seed=0)
    engine = LLMEngine(model, cs._quant_config(ServingConfig))
    rng = np.random.default_rng(0)     # engine a's prompts (chip_smoke)
    lengths = rng.integers(cs.PROMPT_MIN, cs.PROMPT_MAX + 1,
                           size=cs.SERVE_REQUESTS)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=int(n)).tolist()
               for n in lengths]
    tables, toks, pos, held = cs._batch_tables(torch, engine, prompts)
    try:
        for name, fused in (("engine_a_decode_step", False),
                            ("engine_b_decode_step", True)):
            sm = ServingModel(model, fused_block=fused).bind_pool(
                engine.pool)
            emit(**{name: cs._profile(
                torch, lambda: sm.decode_forward(toks, pos, tables),
                reps=10)}, pos=pos.tolist())
        if prefill:
            mono = torch.arange(1024, device=dev)[None] + 7
            emit(engine_b_monolithic_prefill_1024=cs._profile(
                torch, lambda: sm.prefill_forward(mono, 1024, tables[0]),
                reps=4))
    finally:
        engine.pool.free(held)
        engine.shutdown()
    del model, engine
    cs._free(torch)


#: the softmax family's rows: (label, [B, H, Sq, Sk], kind, dtype); kind
#: "mask" (a [B, 1, Sq, Sk] padding mask), "head" (a [1, H, Sq, Sk] mask),
#: "full" (a [B, H, Sq, Sk] mask), "tri" (causal) or "bwd"
SOFTMAX_ROWS = (
    ("phase3 mask", (8, 12, 1024, 1024), "mask", "bfloat16"),
    ("phase3 causal", (8, 12, 1024, 1024), "tri", "bfloat16"),
    ("phase3 causal 2048", (2, 32, 2048, 2048), "tri", "bfloat16"),
    ("phase3 bwd", (8, 12, 1024, 1024), "bwd", "bfloat16"),
    ("incubate causal", (4, 12, 1024, 1024), "tri", "bfloat16"),
    ("incubate bwd", (4, 12, 1024, 1024), "bwd", "bfloat16"),
    ("tail mask", (1, 3, 1000, 1000), "mask", "bfloat16"),
    ("tail causal", (1, 3, 1000, 1000), "tri", "bfloat16"),
    ("tail bwd", (1, 3, 1000, 1000), "bwd", "bfloat16"),
    ("Sk 64 mask", (64, 12, 1024, 64), "mask", "bfloat16"),
    ("Sk 64 causal", (64, 12, 1024, 64), "tri", "bfloat16"),
    ("Sk 64 bwd", (64, 12, 1024, 64), "bwd", "bfloat16"),
    ("Sk 128 mask", (32, 12, 1024, 128), "mask", "bfloat16"),
    ("Sk 128 causal", (32, 12, 1024, 128), "tri", "bfloat16"),
    ("Sk 128 bwd", (32, 12, 1024, 128), "bwd", "bfloat16"),
    ("Sk 2048 mask", (2, 32, 2048, 2048), "mask", "bfloat16"),
    ("Sk 2048 bwd", (2, 32, 2048, 2048), "bwd", "bfloat16"),
    ("Sk 8192 mask", (1, 8, 1024, 8192), "mask", "bfloat16"),
    ("Sk 8192 causal", (1, 8, 1024, 8192), "tri", "bfloat16"),
    ("Sk 8192 bwd", (1, 8, 1024, 8192), "bwd", "bfloat16"),
    ("Sk 16384 mask", (1, 4, 512, 16384), "mask", "bfloat16"),
    ("Sk 16384 causal", (1, 4, 512, 16384), "tri", "bfloat16"),
    ("Sk 16384 bwd", (1, 4, 512, 16384), "bwd", "bfloat16"),
    ("head mask", (8, 12, 1024, 1024), "head", "bfloat16"),
    ("full mask", (8, 12, 1024, 1024), "full", "bfloat16"),
    ("f32 mask", (4, 12, 1024, 1024), "mask", "float32"),
    ("f32 causal", (4, 12, 1024, 1024), "tri", "float32"),
    ("f32 bwd", (4, 12, 1024, 1024), "bwd", "float32"))


def _softmax(torch, cs, dev, timer, randn, emit):
    from paddle_tpu_torch.ops.kernels import softmax_mask as sm

    gen = torch.Generator(device=dev).manual_seed(17)

    def call(kind, shape, dtype):
        b, h, sq, sk = shape
        x = (torch.randn(shape, generator=gen, device=dev) * 3).to(dtype)
        mask = None
        if kind == "mask":       # -1e4 past each seeded length in [Sk/2, Sk]
            lengths = torch.randint(sk // 2, sk + 1, (b, 1, 1, 1),
                                    generator=gen, device=dev)
            past = torch.arange(sk, device=dev) >= lengths
            mask = torch.where(past, -1e4, 0.0).to(dtype).expand(
                b, 1, sq, sk).contiguous()
        elif kind in ("head", "full"):
            mask = (torch.randn(1 if kind == "head" else b, h, sq, sk,
                                generator=gen, device=dev) * 2).to(dtype)
        if kind == "bwd":
            y = torch.softmax(x.float(), -1).to(dtype)
            dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
            return (lambda: sm.softmax_mask_bwd(y, dy),
                    lambda: sm.softmax_mask_bwd_plain(y, dy),
                    lambda: torch._softmax_backward_data(dy, y, -1, dtype),
                    3 * x.numel())
        if kind == "tri":
            above = torch.ones(sq, sk, dtype=torch.bool, device=dev).triu(1)
            q = torch.arange(sq, device=dev)
            live = int(torch.clamp(q + 1, max=sk).sum()) * b * h
            return (lambda: sm.softmax_mask_tri(x),
                    lambda: sm.softmax_mask_tri_plain(x),
                    (lambda: torch._masked_softmax(x, above, 3, 0))
                    if sq == sk else None, live + x.numel())
        return (lambda: sm.softmax_mask(x, mask),
                lambda: sm.softmax_mask_plain(x, mask), None,
                2 * x.numel() + mask.numel())

    for label, shape, kind, dt in SOFTMAX_ROWS:
        dtype = getattr(torch, dt)
        fn, plain, lib, elems = call(kind, shape, dtype)
        got, again, ref = fn(), fn(), plain()
        err, tol = cs.compare(torch, got, ref)
        lib_ms = lib_err = None
        if lib is not None:
            lib_err = cs.compare(torch, lib(), ref)[0]
            if lib_err <= tol:
                lib_ms = timer(lib)
        ms = timer(fn)
        bound = elems * dtype.itemsize / cs.MEM_BYTES_PER_S * 1e3
        emit(softmax=[label, list(shape), kind, dt], ms=ms, bound_ms=bound,
             bound_share=bound / ms, library_ms=lib_ms, library_err=lib_err,
             max_abs_err=err, tol=tol, same_bits=bool(torch.equal(got, again)))
        del fn, plain, lib, got, again, ref
        torch.cuda.empty_cache()

    for kind in ("mask", "tri", "bwd"):
        fn = call(kind, (1, 12, 128, 128), torch.bfloat16)[0]
        emit(host=["softmax", kind, [1, 12, 128, 128]],
             us=_host_us(torch, fn))

    if "--incubate" in sys.argv[4:]:
        cs.phase_incubate(torch, dev)


#: the rows family's shapes: (label, rows, hidden, masked, dtype) of row
#: 19 and (label, rows, hidden, dtype) of row 20
BDL_ROWS = (
    ("phase3 mask", 8192, 768, True, "bfloat16"),
    ("phase3 maskless", 8192, 768, False, "bfloat16"),
    ("phase3 4096 mask", 4096, 4096, True, "bfloat16"),
    ("incubate mask", 4096, 768, True, "bfloat16"),
    ("tail H 1000", 1061, 1000, True, "bfloat16"),
    ("tail H 776", 1061, 776, True, "bfloat16"),
    ("H 8192 mask", 1024, 8192, True, "bfloat16"),
    ("f32 mask", 8192, 768, True, "float32"))
DA_ROWS = (
    ("phase3", 8192, 768, "bfloat16"),
    ("phase3 4096", 4096, 4096, "bfloat16"),
    ("incubate", 4096, 768, "bfloat16"),
    ("tail", 1061, 1000, "bfloat16"),
    ("odd count", 1061, 777, "bfloat16"),
    ("f32", 8192, 768, "float32"))


def _rows(torch, cs, dev, timer, randn, emit):
    from paddle_tpu_torch.ops.kernels import bias_dropout_ln as bdl
    from paddle_tpu_torch.ops.kernels import dropout_add as da

    gen = torch.Generator(device=dev).manual_seed(19)
    rate = cs.MEM_BYTES_PER_S
    clean = _CleanTimer(torch, dev)
    copies = {}

    def yardsticks(fn, nbytes):
        """clean_ms of ``fn``; copy_ms and copy_clean_ms of a copy of
        ``nbytes`` bytes."""
        if nbytes not in copies:
            src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
            dst = torch.empty_like(src)
            copies[nbytes] = (timer(lambda: dst.copy_(src)),
                              clean(lambda: dst.copy_(src)))
            del src, dst
        return {"clean_ms": clean(fn), "copy_ms": copies[nbytes][0],
                "copy_clean_ms": copies[nbytes][1]}

    def rnd(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def bdl_args(rows, hid, masked, dtype):
        x, res = rnd(rows, hid, dtype=dtype), rnd(rows, hid, dtype=dtype)
        bias, beta = rnd(hid, dtype=dtype, scale=0.1), \
            rnd(hid, dtype=dtype, scale=0.1)
        gamma = (1.0 + rnd(hid, dtype=torch.float32) * 0.1).to(dtype)
        mask = None
        if masked:
            keep = torch.rand(rows, hid, generator=gen, device=dev) >= 0.1
            mask = keep.float() / 0.9
        return (x, bias, res, mask, gamma, beta, 1e-5)

    for label, rows, hid, masked, dt in BDL_ROWS:
        dtype = getattr(torch, dt)
        args = bdl_args(rows, hid, masked, dtype)
        got, again = bdl.bias_dropout_ln(*args), bdl.bias_dropout_ln(*args)
        ref = bdl.bias_dropout_ln_plain(*args)
        err = max(cs.compare(torch, g, r)[0] for g, r in zip(got, ref))
        tol = max(cs.compare(torch, g, r)[1] for g, r in zip(got, ref))
        n = rows * hid
        nbytes = n * (4 * dtype.itemsize + 4 * masked) + 12 * hid
        ms = timer(lambda: bdl.bias_dropout_ln(*args))
        emit(bdl=[label, rows, hid, masked, dt, "fwd"], ms=ms,
             bound_ms=nbytes / rate * 1e3, bound_share=nbytes / rate * 1e3
             / ms, max_abs_err=err, tol=tol,
             same_bits=all(bool(torch.equal(a, b))
                           for a, b in zip(got, again)),
             split=_split(torch, cs, lambda: bdl.bias_dropout_ln(*args)),
             **yardsticks(lambda: bdl.bias_dropout_ln(*args), nbytes))
        dy = rnd(rows, hid, dtype=dtype)
        bargs = (ref[1], args[3], args[4], dy, 1e-5)
        gb, again = bdl.bias_dropout_ln_bwd(*bargs), \
            bdl.bias_dropout_ln_bwd(*bargs)
        rb = bdl.bias_dropout_ln_bwd_plain(*bargs)
        err = max(cs.compare(torch, g, r)[0] for g, r in zip(gb[:2], rb[:2]))
        sums = max(cs.compare(torch, g, r)[0]
                   / max(r.abs().max().item(), 1e-30)
                   for g, r in zip(gb[2:], rb[2:]))
        nbytes = n * (4 * dtype.itemsize + 4 * masked) + 16 * hid
        ms = timer(lambda: bdl.bias_dropout_ln_bwd(*bargs))
        emit(bdl=[label, rows, hid, masked, dt, "bwd"], ms=ms,
             bound_ms=nbytes / rate * 1e3, bound_share=nbytes / rate * 1e3
             / ms, max_abs_err=err, sums_rel_err=sums,
             same_bits=all(bool(torch.equal(a, b))
                           for a, b in zip(gb, again)),
             split=_split(torch, cs, lambda: bdl.bias_dropout_ln_bwd(*bargs)),
             **yardsticks(lambda: bdl.bias_dropout_ln_bwd(*bargs), nbytes))
        del args, got, again, ref, dy, bargs, gb, rb
        torch.cuda.empty_cache()

    for label, rows, hid, dt in DA_ROWS:
        dtype = getattr(torch, dt)
        x, res = rnd(rows, hid, dtype=dtype), rnd(rows, hid, dtype=dtype)
        for way in ("fwd", "bwd"):
            if way == "fwd":
                fn = lambda: da.dropout_add(x, res, 1234, 0.1)  # noqa: E731
                ref = da.dropout_add_plain(x, res, 1234, 0.1)
            else:
                fn = lambda: da.dropout_add_bwd(x, 1234, 0.1)  # noqa: E731
                ref = da.dropout_add_bwd_plain(x, 1234, 0.1)
            got, again = fn(), fn()
            nbytes = (3 if way == "fwd" else 2) * x.numel() * dtype.itemsize
            ms = timer(fn)
            emit(da=[label, rows, hid, dt, way], ms=ms,
                 bound_ms=nbytes / rate * 1e3,
                 bound_share=nbytes / rate * 1e3 / ms,
                 bit_exact=bool(torch.equal(got, ref)),
                 same_bits=bool(torch.equal(got, again)),
                 **yardsticks(fn, nbytes))
        del x, res, got, again, ref

    x8 = rnd(8, dtype=torch.bfloat16)
    emit(floor=["dropout_add", 8],
         ms=timer(lambda: da.dropout_add(x8, x8, 1234, 0.1)))
    args = bdl_args(64, 768, True, torch.bfloat16)
    dy = rnd(64, 768, dtype=torch.bfloat16)
    emit(host=["bias_dropout_ln", 64, 768],
         us=_host_us(torch, lambda: bdl.bias_dropout_ln(*args)))
    emit(host=["bias_dropout_ln_bwd", 64, 768],
         us=_host_us(torch, lambda: bdl.bias_dropout_ln_bwd(
             args[0], args[3], args[4], dy, 1e-5)))
    emit(host=["dropout_add", 64, 768],
         us=_host_us(torch, lambda: da.dropout_add(args[0], args[2], 1234,
                                                  0.1)))

    if "--incubate" in sys.argv[4:]:
        cs.phase_incubate(torch, dev)


#: the norm family's rows: row 2 (rows, hidden, residual) and row 9
#: (rows, hidden, act, norm, p, bias)
NORM_RMS_ROWS = ((1, 4096, False), (8, 4096, False), (8, 4096, True),
                 (512, 4096, True), (2048, 2048, True), (4096, 4096, False),
                 (4096, 4096, True))
NORM_EPI_ROWS = ((1, 4096, None, "rms", 0.0, False),
                 (8, 4096, None, "rms", 0.0, False),
                 (1024, 4096, None, "rms", 0.0, False),
                 (4096, 4096, None, "rms", 0.0, False),
                 (8192, 768, None, "layer", 0.0, True),
                 (512, 4096, "gelu", "rms", 0.0, False),
                 (512, 4096, "swiglu", "rms", 0.0, False),
                 (512, 4096, None, "rms", 0.1, False),
                 (512, 4096, None, "layer", 0.0, True))


def _norm(torch, cs, dev, timer, randn, emit):
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels import block_epilogue as be
    from paddle_tpu_torch.ops.kernels import rms_norm as rn


    rate = cs.MEM_BYTES_PER_S
    bf = torch.bfloat16
    copies = {}

    def copy_ms(nbytes):
        if nbytes not in copies:
            src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
            dst = torch.empty_like(src)
            copies[nbytes] = timer(lambda: dst.copy_(src))
            del src, dst
        return copies[nbytes]

    def weight(hid):
        return (1.0 + randn(hid).float() * 0.1).to(bf)

    def measure(fn, outs, refs, nbytes):
        err = max(cs.compare(torch, g, r)[0] for g, r in zip(outs, refs))
        tol = min(cs.compare(torch, g, r)[1] for g, r in zip(outs, refs))
        again = fn()
        again = again if isinstance(again, tuple) else (again,)
        ms, median = _cold_stats(torch, timer, fn)
        bound = nbytes / rate * 1e3
        return dict(ms=ms, ms_median=median, bound_ms=bound,
                    bound_share=bound / ms,
                    copy_ms=copy_ms(nbytes), max_abs_err=err, tol=tol,
                    same_bits=all(bool(torch.equal(a, b))
                                  for a, b in zip(outs, again)),
                    split=_split(torch, cs, fn))

    for rows, hid, with_res in NORM_RMS_ROWS:
        x, w = randn(rows, hid), weight(hid)
        r = randn(rows, hid) if with_res else None
        fn = lambda: rn.rms_norm(x, w, r, 1e-5)  # noqa: E731
        got, ref = fn(), rn.rms_norm_plain(x, w, r, 1e-5)
        got = got if with_res else (got,)
        ref = ref if with_res else (ref,)
        nbytes = 2 * rows * hid * (2 if with_res else 1) * 2 + 2 * hid
        lib = None if with_res else timer(
            lambda: TF.rms_norm(x, (hid,), w, 1e-5))
        emit(rms=[rows, hid, "residual" if with_res else "no residual"],
             library_ms=lib, **measure(fn, got, ref, nbytes))
        del x, w, r, got, ref

    for rows, hid, act, norm, p, bias_on in NORM_EPI_ROWS:
        xw = 2 * hid if act == "swiglu" else hid
        x, res, w = randn(rows, xw), randn(rows, hid), weight(hid)
        b = randn(hid) * 0.1 if bias_on else None
        args = (x, res, w, b, 1234, p, 1e-5, act, norm)
        fn = lambda: be.fused_epilogue(*args)  # noqa: E731
        got, ref = fn(), be.fused_epilogue_plain(*args)
        extra = {}
        if p:
            x1 = (x.float().abs() + 1.0).to(bf)
            h0 = be.fused_epilogue(x1, torch.zeros_like(res), w, b, 1234, p,
                                   1e-5, act, norm)[1]
            keep = be.keep_mask(rows, hid, 1234, p, dev)
            extra["dropped_exact"] = bool(torch.equal(h0 == 0, ~keep))
        nbytes = 2 * (rows * xw + 3 * rows * hid + hid * (1 + bias_on))
        emit(epi=[rows, hid, f"act={act}", norm, f"p={p}",
                  "bias" if bias_on else "no bias"], library_ms=None,
             **measure(fn, got, ref, nbytes), **extra)
        del x, res, w, b, args, got, ref

    s8 = torch.empty(16, dtype=torch.uint8, device=dev)
    d8 = torch.empty_like(s8)
    emit(floor=["copy_", 16], ms=timer(lambda: d8.copy_(s8)))
    x, r, w = randn(8, 4096), randn(8, 4096), weight(4096)
    emit(host=["rms_norm", 8, 4096, "no residual"],
         us=_host_us(torch, lambda: rn.rms_norm(x, w, None, 1e-5)))
    emit(host=["rms_norm", 8, 4096, "residual"],
         us=_host_us(torch, lambda: rn.rms_norm(x, w, r, 1e-5)))
    emit(host=["block_epilogue", 8, 4096, "rms"],
         us=_host_us(torch, lambda: be.decode_epilogue(x, r, w, 1e-5)))
    x, r, w, b = randn(8, 768), randn(8, 768), weight(768), randn(768)
    emit(host=["block_epilogue", 8, 768, "layer", "bias"],
         us=_host_us(torch, lambda: be.fused_epilogue(
             x, r, w, b, 0, 0.0, 1e-5, None, "layer")))

    if "--engine" in sys.argv[4:]:
        _engine_profiles(torch, cs, dev, emit, prefill=True)
    if "--train" in sys.argv[4:]:
        cs._free(torch)
        cs.phase_train(torch, dev)
        cs._free(torch)
        cs.phase_train_gpt(torch, dev)


#: the swiglu family's shapes: (rows, width) of g, u and y
SWIGLU_ROWS = ((1, 14336), (8, 14336), (512, 14336), (1024, 14336),
               (4096, 14336), (16440, 1408), (2048, 5632), (3, 77))
#: the normbwd family's shapes: (rows, hidden, with the sum's cotangent)
NORMBWD_ROWS = ((4096, 4096, False), (4096, 4096, True), (4096, 2048, False),
                (4096, 2048, True), (37, 776, True))


def _probe():
    """The integers of a ``--probe=a,b,...`` argument, or None."""
    for a in sys.argv[4:]:
        if a.startswith("--probe="):
            return [int(v) for v in a[len("--probe="):].split(",")]
    return None


def _copy_timer(torch, dev, timer):
    """``copy_ms(nbytes)``: a ``copy_`` of ``nbytes`` bytes, half read and
    half written, under ``timer`` (each size timed once)."""
    copies = {}

    def copy_ms(nbytes):
        if nbytes not in copies:
            src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
            dst = torch.empty_like(src)
            copies[nbytes] = timer(lambda: dst.copy_(src))
            del src, dst
        return copies[nbytes]
    return copy_ms


def _swiglu(torch, cs, dev, timer, randn, emit):
    from paddle_tpu_torch.ops.kernels import swiglu as sw

    probe = _probe()
    if probe:
        sw.plan = lambda n: sw.make(n, *probe)
    rate = cs.MEM_BYTES_PER_S
    copy_ms = _copy_timer(torch, dev, timer)
    for rows, width in SWIGLU_ROWS:
        g, u = randn(rows, width), randn(rows, width)
        fn = lambda: sw.swiglu(g, u)  # noqa: E731
        got, again, ref = fn(), fn(), sw.swiglu_plain(g, u)
        err, tol = cs.compare(torch, got, ref)
        ms, median = _cold_stats(torch, timer, fn)
        nbytes = 3 * 2 * rows * width
        bound = nbytes / rate * 1e3
        emit(swiglu=[rows, width], ms=ms, ms_median=median, bound_ms=bound,
             bound_share=bound / ms, copy_ms=copy_ms(nbytes),
             library_ms=None, max_abs_err=err, tol=tol,
             same_bits=bool(torch.equal(got, again)),
             split=_split(torch, cs, fn))
        del g, u, got, again, ref

    vals = torch.tensor([88.0, -88.0, 100.0, -100.0, 1e4, -1e4, 0.0, -87.5,
                         -89.0, 20.0, -20.0], device=dev)
    g = vals.repeat(2, 64).to(torch.bfloat16)
    u = torch.linspace(-3.0, 3.0, g.numel(), device=dev).view(g.shape).to(
        torch.bfloat16)
    got, ref = sw.swiglu(g, u).float(), sw.swiglu_plain(g, u).float()
    torch.cuda.synchronize()
    # one bf16 ulp at each reference value (2**-133 below the normal range)
    ulp = (2.0 ** (torch.floor(torch.log2(ref.abs())) - 7)).clamp(
        min=2.0 ** -133)
    emit(extreme=vals.tolist(),
         max_ulps=((got - ref).abs() / ulp).max().item(),
         finite=bool(torch.isfinite(got).all()))

    s8 = torch.empty(16, dtype=torch.uint8, device=dev)
    d8 = torch.empty_like(s8)
    emit(floor=["copy_", 16], ms=timer(lambda: d8.copy_(s8)))
    for rows in (8, 4096):
        g, u = randn(rows, 14336), randn(rows, 14336)
        emit(host=["swiglu", rows, 14336],
             us=_host_us(torch, lambda: sw.swiglu(g, u)))
        del g, u

    if "--engine" in sys.argv[4:]:
        _engine_profiles(torch, cs, dev, emit, prefill=True)
    if "--train" in sys.argv[4:] or "--train=llama" in sys.argv[4:]:
        cs._free(torch)
        cs.phase_train(torch, dev)
    if "--train" in sys.argv[4:]:
        cs._free(torch)
        moe_model = cs.phase_serve_moe(torch, dev)[0]
        del moe_model
        cs._free(torch)
        cs.phase_train_moe(torch, dev)


def _normbwd(torch, cs, dev, timer, randn, emit):
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels import block_epilogue as be
    from paddle_tpu_torch.ops.kernels import rms_norm as rn

    probe = _probe()
    if probe:
        rn.bwd_plan = lambda rows, hid, gh: rn.make_bwd(rows, hid, gh, *probe)
    rate = cs.MEM_BYTES_PER_S
    copy_ms = _copy_timer(torch, dev, timer)
    for rows, hid, with_gh in NORMBWD_ROWS:
        w = (1.0 + randn(hid).float() * 0.1).to(torch.bfloat16)
        h, g = randn(rows, hid), randn(rows, hid)
        gh = randn(rows, hid) if with_gh else None
        fn = lambda: rn.rms_norm_bwd(h, w, g, gh, 1e-5)  # noqa: E731
        got, again = fn(), fn()
        ref = rn.rms_norm_bwd_plain(h, w, g, gh, 1e-5)
        err, tol = cs.compare(torch, got[0], ref[0])
        err_w = cs.compare(torch, got[1], ref[1])[0]
        dw_rel = err_w / max(ref[1].float().abs().max().item(), 1e-30)
        lib = lib_dev = None
        if not with_gh:
            xl, wl = h.clone().requires_grad_(), w.clone().requires_grad_()
            yl = TF.rms_norm(xl, (hid,), wl, 1e-5)

            def grad():
                return torch.autograd.grad(yl, (xl, wl), g,
                                           retain_graph=True)
            lib = timer(grad)
            lib_dev = _split(torch, cs, grad)["device_ms"]
            del xl, wl, yl, grad
        ms, median = _cold_stats(torch, timer, fn)
        nbytes = 2 * rows * hid * (3 + with_gh) + 2 * hid * 2
        bound = nbytes / rate * 1e3
        emit(rms_bwd=[rows, hid, "cotangent" if with_gh else "no cotangent"],
             ms=ms, ms_median=median, bound_ms=bound, bound_share=bound / ms,
             copy_ms=copy_ms(nbytes), library_ms=lib,
             library_device_ms=lib_dev, max_abs_err=err, tol=tol,
             dw_rel_err=dw_rel,
             same_bits=all(bool(torch.equal(a, b))
                           for a, b in zip(got, again)),
             split=_split(torch, cs, fn))
        del h, g, gh, got, again, ref

    rows, hid = 4096, 4096
    w = (1.0 + randn(hid).float() * 0.1).to(torch.bfloat16)
    h, gy, gh = randn(rows, hid), randn(rows, hid), randn(rows, hid)
    args = (h, None, w, gy, gh, 0, 0.0, 1e-5, None, "rms", False)
    fn = lambda: be.fused_epilogue_bwd(*args)  # noqa: E731
    ms, median = _cold_stats(torch, timer, fn)
    emit(epi_yardstick=[rows, hid, "rms", "cotangent"], ms=ms,
         ms_median=median, split=_split(torch, cs, fn))
    for with_gh in (False, True):
        g2 = gh if with_gh else None
        emit(host=["rms_norm_bwd", rows, hid,
                   "cotangent" if with_gh else "no cotangent"],
             us=_host_us(torch, lambda: rn.rms_norm_bwd(h, w, gy, g2, 1e-5)))
    del h, gy, gh, args

    if "--train" in sys.argv[4:]:
        cs._free(torch)
        cs.phase_train(torch, dev)
        cs._free(torch)
        cs.phase_train_moe(torch, dev)


def _cold_stats(torch, timer, fn, iters=20, warmup=3):
    """The mean of ``timer`` (``chip_smoke.ColdTimer``: its flush before
    each call) and the median of the same calls: one call in a few hundred
    stalls for ~0.4 ms, which moves a mean of 20 by 20 us."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        timer.flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in pairs)
    return sum(ms) / iters, (ms[iters // 2 - 1] + ms[iters // 2]) / 2


class _CleanTimer:
    """``chip_smoke.ColdTimer`` with a flush that reads 1 GiB instead of
    writing it, so the L2 holds no dirty lines when the timed call
    starts."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.zeros(256 << 20, dtype=torch.int32, device=device)

    def __call__(self, fn, iters=20, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.sum()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters


def _fused(torch, cs, dev, timer, randn, emit):
    """chip_smoke's fused_step phase of this checkout."""
    if not hasattr(cs, "phase_fused_step"):
        emit(fused="this tree has no fused optimizer step")
        return
    cs.phase_fused_step(torch, dev)


def _host_us(torch, fn, calls=100, repeats=5):
    """Host microseconds a call, as ``chip_smoke._host_us`` measures them
    (kept here too, for checkouts whose script predates it)."""
    means = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        means.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return sorted(means)[repeats // 2]


if __name__ == "__main__":
    sys.exit(main())
