#!/usr/bin/env python3
"""Flash attention of one checkout of this repository, on one GPU, for
comparing two checkouts in one run (the card and its neighbours change
between runs): run it on each tree in turns (A, B, B, A).

    python3 flash_ab.py <checkout root> <tag> [--gpt]

Prints one JSON line per measurement, each with ``tag``:

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

The checkout's own ``paddle_tpu_torch`` and ``chip_smoke.py`` are imported
(the tree is put first on ``sys.path``), so a parent commit unpacked with
``git archive`` into an ignored directory measures as it was.
"""

import json
import sys
import time


def main() -> int:
    root, tag = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as TF

    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    if not fa.__file__.startswith(root) or not cs.__file__.startswith(root):
        cs.fail(f"{root}: its modules were not the ones imported")
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = cs.ColdTimer(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def mask_of(seg, s):
        return ((seg[:, :, None] == seg[:, None, :])
                & torch.ones(s, s, dtype=torch.bool, device=dev).tril())[:, None]

    def emit(**row):
        print(json.dumps({"tag": tag, **row}), flush=True)

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

    if "--gpt" in sys.argv[3:]:
        cs.phase_train_gpt(torch, dev)
    return 0


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
