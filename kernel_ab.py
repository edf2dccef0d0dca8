#!/usr/bin/env python3
"""One family of kernels of one checkout of this repository, on one GPU,
for comparing two checkouts in one run (the card and its neighbours change
between runs): run it on each tree in turns (A, B, B, A).

    python3 kernel_ab.py <checkout root> <tag> flash [--gpt]
    python3 kernel_ab.py <checkout root> <tag> wo [--engine]
    python3 kernel_ab.py <checkout root> <tag> grad [--incubate]

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
    if family not in ("flash", "wo", "grad"):
        cs.fail(f"family {family!r}: flash, wo or grad")
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

    if family == "flash":
        _flash(torch, cs, dev, timer, randn, emit)
    elif family == "wo":
        _wo(torch, cs, dev, timer, randn, emit)
    else:
        _grad(torch, cs, dev, timer, randn, emit)
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
