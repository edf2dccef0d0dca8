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

The checkout's own ``paddle_tpu_torch`` and ``chip_smoke.py`` are imported
(the tree is put first on ``sys.path``), so a parent commit unpacked with
``git archive`` into an ignored directory measures as it was.
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
                "epi": _epi, "moe": _moe, "dl": _dl}
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
