"""paddle_tpu_torch's decode-layer kernel module, its block_i tuner and the
``fused_decode_layer=True`` serving path, against the JAX package.

On the CPU the port's ``decode_layer`` takes its plain version; the JAX
side runs its Pallas kernel in interpret mode. The same numpy inputs go to
both, the port's weights transposed into ``nn.Linear``'s ``[out, in]``.
Tolerance 2e-5 in f32, the JAX kernel's own against its reference: the
same math summed in another order. Greedy serving is token-exact against
the JAX engine with ``fused_decode_layer=True`` (interpret mode, tuning
off).
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.ops.kernels import _common as jax_kern
from paddle_tpu.ops.kernels import decode_layer_pallas as jax_dlp
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import ServingConfig as JaxConfig
from paddle_tpu_torch.models import LlamaConfig, llama_from_jax_state
from paddle_tpu_torch.ops.kernels import autotune, decode_layer as dl
from paddle_tpu_torch.serving import LLMEngine, ServingConfig, ServingModel

TOL = dict(rtol=0, atol=2e-5)


@pytest.fixture
def no_override():
    dl.set_block_override(dl.BLOCK_I_KEY, None)
    yield
    dl.set_block_override(dl.BLOCK_I_KEY, None)


def _layer_args(b=2, h=4, h_kv=2, d=16, ps=8, pages=8, n_tab=4, i=64,
                seed=0):
    """``tests/test_decode_layer_fused.py``'s inputs as numpy, JAX layout."""
    rng = np.random.default_rng(seed)
    hd = h * d

    def mk(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    tab = np.stack([rng.choice(pages - 1, n_tab, replace=False) + 1
                    for _ in range(b)]).astype(np.int32)
    pos = rng.integers(ps, n_tab * ps, size=b).astype(np.int32)
    return dict(
        q=mk(b, h, d), k_layer=mk(pages, h_kv, ps, d),
        v_layer=mk(pages, h_kv, ps, d), tables=tab, pos=pos,
        hres=mk(b, hd), wo=mk(h * d, hd, scale=0.05),
        w_post=(1.0 + 0.1 * rng.standard_normal(hd)).astype(np.float32),
        wg=mk(hd, i, scale=0.05), wu=mk(hd, i, scale=0.05),
        wd=mk(i, hd, scale=0.05),
        w_next=(1.0 + 0.1 * rng.standard_normal(hd)).astype(np.float32))


def _port_args(a):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()}
    for k in ("wo", "wg", "wu", "wd"):        # [in, out] -> [out, in]
        t[k] = t[k].t().contiguous()
    return t


@pytest.mark.parametrize("dims", [
    dict(),                                      # GQA rep 2
    dict(h=4, h_kv=4),                           # MHA rep 1
    dict(h=8, h_kv=1, d=8),                      # rep 8
    dict(b=3, n_tab=3, ps=16, pages=6),          # odd batch, wide pages
])
def test_decode_layer_matches_jax_interpret_kernel(dims):
    a = _layer_args(**dims)
    y, h = jax_dlp.decode_layer(**a, eps_post=1e-5, eps_next=1e-6,
                                interpret=True)
    dl.decode_layer.launches = 0
    yt, ht = dl.decode_layer(**_port_args(a), eps_post=1e-5, eps_next=1e-6)
    assert dl.decode_layer.launches == 0               # CPU: plain version
    assert yt.dtype == torch.float32 and yt.shape == y.shape
    np.testing.assert_allclose(yt.numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(h), **TOL)


@pytest.mark.parametrize("block_i", [8, 16, 32, 64])
def test_decode_layer_block_i_is_a_schedule_knob(block_i):
    """Every legal column chunk gives the JAX kernel's output at that
    chunk (the plain version ignores it)."""
    a = _layer_args(i=64)
    y, h = jax_dlp.decode_layer(**a, block_i=block_i, interpret=True)
    yt, ht = dl.decode_layer(**_port_args(a), block_i=block_i)
    np.testing.assert_allclose(yt.numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(h), **TOL)


@pytest.mark.parametrize("override,i_size", [
    (48, 64), (48, 48), (1024, 14336), (40, 14336), (64, 14336),
    (8, 14336), (96, 128), (200, 128)])
def test_pick_block_i_clamps_like_jax(no_override, override, i_size):
    jax_kern.set_block_override(jax_dlp.BLOCK_I_KEY, override)
    dl.set_block_override(dl.BLOCK_I_KEY, override)
    try:
        assert dl._pick_block_i(i_size) == jax_dlp._pick_block_i(i_size)
    finally:
        jax_kern.set_block_override(jax_dlp.BLOCK_I_KEY, None)


def test_pick_block_i_default_and_registry(no_override):
    """With nothing installed the port takes DEFAULT_BLOCK_I, clamped by
    the same rule (the TPU kernel takes the full width); the registry
    refuses what the JAX one refuses."""
    assert dl._pick_block_i(14336) == dl.DEFAULT_BLOCK_I
    assert dl._pick_block_i(48) == 48
    assert dl._pick_block_i(40) == 40
    for bad in (0, 12, -8):
        with pytest.raises(ValueError):
            dl.set_block_override(dl.BLOCK_I_KEY, bad)


def test_use_kernel_checks_only_what_the_cuda_kernel_takes():
    bf = torch.bfloat16
    # Llama-3-8B at batch 8: the JAX VMEM gate refuses it, the port takes it
    assert dl.use_kernel((8, 32, 128), (1025, 8, 16, 128), 128, 4096, 14336,
                         bf)
    assert dl.use_kernel((16, 8, 64), (9, 4, 16, 64), 4, 512, 1024, bf)
    assert not dl.use_kernel((17, 32, 128), (9, 8, 16, 128), 4, 4096, 14336,
                             bf)                          # batch > 16
    assert not dl.use_kernel((2, 4, 16), (8, 2, 8, 16), 4, 64, 64, bf)  # D
    assert not dl.use_kernel((2, 12, 64), (8, 4, 8, 64), 4, 768, 64, bf)  # rep 3
    assert not dl.use_kernel((2, 4, 64), (8, 2, 8, 64), 4, 256, 100, bf)
    assert not dl.use_kernel((2, 4, 64), (8, 2, 8, 64), 4, 256, 512,
                             torch.float32)
    assert "batch" in dl.unsupported_reason((17, 32, 128), (9, 8, 16, 128),
                                            4, 4096, 14336)


def test_wrapper_rejects_bad_operands():
    t = _port_args(_layer_args())
    with pytest.raises(ValueError):                       # [in, out] wo
        dl.decode_layer(**dict(t, wo=t["wo"].t().contiguous()[:, :32]))
    with pytest.raises(TypeError):
        dl.decode_layer(**dict(t, pos=t["pos"].long()))
    meta = {k: v.to("meta") for k, v in t.items()}
    with pytest.raises(ValueError):                       # no quiet fallback
        dl.decode_layer(**meta)


# -- serving: token-exact against the JAX fused-layer engine -------------------

_SERVE_CFG = dict(page_size=8, num_pages=32, max_batch=4, max_new_tokens=6,
                  max_seq_len=64)
_PROMPTS = [[3, 5, 7, 11], [2, 4, 6], [9, 9, 1, 2, 3]]
_SHARED = list(range(1, 17))       # two whole pages


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = jax_llama_tiny()
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = LlamaConfig(**dataclasses.asdict(jm.cfg))
    return jm, llama_from_jax_state(state, cfg, device="cpu")


@pytest.fixture
def no_tune(monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_TPU_TUNE", "0")
    monkeypatch.setenv("PADDLE_TPU_TUNE_CACHE",
                       str(tmp_path / "tuning_cache.json"))


@pytest.mark.parametrize("name,extra,prompts", [
    ("alone", dict(prefix_cache=False), _PROMPTS),
    ("prefix_cache_cow", dict(prefix_cache=True),
     # the repeated page-aligned prompt claims both pages and copies the
     # second before its first decode write
     [_SHARED, _SHARED[:10] + [12, 13], [2, 4, 6], _SHARED]),
    ("chunked_prefill", dict(prefill_chunk=4, prefix_cache=False), _PROMPTS),
])
def test_fused_layer_engine_tokens_equal_jax(models, no_tune, name, extra,
                                             prompts):
    jm, tm = models
    jax_kern.force_interpret(True)
    try:
        jeng = JaxEngine(jm, JaxConfig(fused_decode_layer=True, **_SERVE_CFG,
                                       **extra))
        assert jeng._sm._fused_layer_active()
        want = [jeng.generate(p) for p in prompts]
        jeng.shutdown(drain=True)
    finally:
        jax_kern.force_interpret(False)
    teng = LLMEngine(tm, ServingConfig(fused_decode_layer=True, **_SERVE_CFG,
                                       **extra), device="cpu")
    assert teng._sm._fused_layer_active() and teng.tuning is None
    try:
        # submitted together, so that the repeated prompt shares live pages
        got = [r.result(300) for r in [teng.submit(p) for p in prompts]]
        stats = teng.stats()
    finally:
        summary = teng.shutdown()
    assert got == want, name
    assert summary["pages_leaked"] == 0 and teng.pool.lost() == 0
    if name == "prefix_cache_cow":
        assert stats["prefix_cache"]["page_hits"] >= 2
        assert stats["prefix_cache"]["cow_copies"] >= 1
    if name == "chunked_prefill":
        assert stats["prefill_chunks"] > len(prompts)


def test_fused_layer_decode_step_equals_composite(models):
    """One decode step through the decode layer and through the fused
    epilogue path on the same pool state: the same function, f32."""
    _, tm = models
    from paddle_tpu_torch.serving import PagePool
    cfg = tm.cfg
    pool = PagePool(cfg.num_layers, 17, cfg.num_kv_heads, 8, cfg.head_dim)
    g = torch.Generator().manual_seed(0)
    pool.k.copy_(torch.randn(pool.k.shape, generator=g))
    pool.v.copy_(torch.randn(pool.v.shape, generator=g))
    fused = ServingModel(tm, fused_decode_layer=True).bind_pool(pool)
    comp = ServingModel(tm).bind_pool(pool)
    tables = torch.tensor([[4, 9, 0], [0, 0, 0], [2, 11, 5]],
                          dtype=torch.int32)
    args = (torch.tensor([7, 0, 300]),
            torch.tensor([13, 0, 20], dtype=torch.int32), tables)
    want = comp.decode_forward(*args)
    got = fused.decode_forward(*args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(fused.decode_forward(*args, plain=True),
                                  got)


def test_gate_follows_jax(models):
    """The flag takes effect only with fused_block (and bias-free
    projections), as in the JAX ServingModel."""
    _, tm = models
    assert ServingModel(tm, fused_decode_layer=True).fused_decode_layer
    assert not ServingModel(tm, fused_block=False,
                            fused_decode_layer=True).fused_decode_layer
    assert not ServingModel(tm).fused_decode_layer


def test_escape_hatch(models, monkeypatch, tmp_path):
    """PADDLE_TPU_FUSED_DECODE=0 turns the fused layer off even when the
    config asks for it: no tuning, the epilogue path decodes."""
    _, tm = models
    monkeypatch.setenv("PADDLE_TPU_FUSED_DECODE", "0")
    monkeypatch.setenv("PADDLE_TPU_TUNE_CACHE", str(tmp_path / "tc.json"))
    eng = LLMEngine(tm, ServingConfig(fused_decode_layer=True, **_SERVE_CFG),
                    device="cpu")
    try:
        assert eng._sm.fused_decode_layer
        assert not eng._sm._fused_layer_active()
        assert eng.tuning is None
        assert len(eng.generate(_PROMPTS[0], timeout=300)) == 6
    finally:
        eng.shutdown()


@pytest.mark.parametrize("kw", [dict(spec_k=2), dict(quant="weight_only_int8"),
                                dict(prefill_budget=8)])
def test_engine_still_refuses_unported_options(models, no_tune, kw):
    """Every option is ported now: a fused-layer engine with ``spec_k``
    (the verify runs the layer loop), int8 ``quant`` or ``prefill_budget``
    (with ``prefill_chunk``, which it needs) constructs and serves the
    same greedy tokens as the plain fused-layer engine."""
    _, tm = models
    if "prefill_budget" in kw:
        kw = dict(kw, prefill_chunk=4)
    ref = LLMEngine(tm, ServingConfig(fused_decode_layer=True, **_SERVE_CFG),
                    device="cpu")
    eng = LLMEngine(tm, ServingConfig(fused_decode_layer=True, **_SERVE_CFG,
                                      **kw), device="cpu")
    try:
        assert eng._sm._fused_layer_active()
        got = eng.generate(_PROMPTS[0], timeout=300)
        assert len(got) == 6
        if "quant" in kw:
            assert eng._sm.quantized
        else:
            assert got == ref.generate(_PROMPTS[0], timeout=300)
    finally:
        ref.shutdown()
        assert eng.shutdown()["pages_leaked"] == 0


# -- the block_i tuner's cache ----------------------------------------------------

def _fake_trial(times):
    """A trial stand-in: records calls, returns scripted seconds per
    candidate (the largest block_i is tried first)."""
    calls = []

    def trial(step, args, steps=2, warmup=1):
        calls.append(step)
        return times[len(calls) - 1]
    trial.calls = calls
    return trial


_DIMS = dict(b=2, h=4, h_kv=2, d=16, page_size=8, n_pages=4, hd=64,
             i_size=64)


def _tune(cache, trial, **over):
    kw = dict(_DIMS, dtype="float32", device="cpu", cache=cache, trial=trial)
    kw.update(over)
    return autotune.tune_decode_layer(**kw)


@pytest.fixture
def cache(tmp_path, no_override):
    return autotune.TuningCache(path=str(tmp_path / "tuning_cache.json"))


def test_fingerprint_covers_every_invalidator():
    base = autotune.kernel_fingerprint("k", [(2, 4, 16)], ["bfloat16"],
                                       device="H100", kernel_hash="a")
    assert base == autotune.kernel_fingerprint(
        "k", [(2, 4, 16)], ["bfloat16"], device="H100", kernel_hash="a")
    for kw in (dict(kernel="k2"), dict(shapes=[(2, 4, 32)]),
               dict(dtypes=["float32"]), dict(device="A100"),
               dict(kernel_hash="b"), dict(quant="int8")):
        args = dict(kernel="k", shapes=[(2, 4, 16)], dtypes=["bfloat16"],
                    device="H100", kernel_hash="a")
        args.update(kw)
        assert autotune.kernel_fingerprint(**args) != base, kw


def test_tuner_round_trip_second_run_zero_trials(cache):
    # candidates for i_size 64 are (64, 32, 16, 8); make 32 the winner
    trial = _fake_trial([3.0, 1.0, 2.0, 4.0])
    entry = _tune(cache, trial)
    assert entry["block_i"] == 32 and len(trial.calls) == 4
    assert set(entry["timings_ms"]) == {"64", "32", "16", "8"}
    assert dl.get_block_override(dl.BLOCK_I_KEY) == 32
    assert cache.stats()["misses"] == 1 and cache.stats()["hits"] == 0
    assert cache.stats()["measure_seconds"] > 0

    dl.set_block_override(dl.BLOCK_I_KEY, None)
    cache2 = autotune.TuningCache(path=cache.path)     # the JSON is the truth
    trial2 = _fake_trial([9.9] * 8)
    entry2 = _tune(cache2, trial2)
    assert entry2["block_i"] == 32 and trial2.calls == []
    assert cache2.stats()["hits"] == 1 and cache2.stats()["misses"] == 0
    assert cache2.stats()["measure_seconds"] == 0.0
    assert dl.get_block_override(dl.BLOCK_I_KEY) == 32


@pytest.mark.parametrize("change", [
    dict(hd=128, i_size=128, h=8, h_kv=4),     # shape
    dict(dtype="bfloat16"),                    # dtype
    dict(kernel_hash="decode_layer-0123456789abcdef.so"),   # edited kernel
])
def test_tuner_key_change_measures_again(cache, change):
    _tune(cache, _fake_trial([3.0, 1.0, 2.0, 4.0]))
    trial = _fake_trial([1.0] + [5.0] * 8)
    entry = _tune(cache, trial, **change)
    assert trial.calls, f"{change} must measure again, not hit the cache"
    assert entry["block_i"] == max(int(c) for c in entry["timings_ms"])
    assert cache.stats()["entries"] == 2


def test_tuner_disabled_skips_measurement_but_loads(cache, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TUNE", "0")
    trial = _fake_trial([1.0] * 8)
    assert _tune(cache, trial) is None and trial.calls == []
    monkeypatch.delenv("PADDLE_TPU_TUNE")
    _tune(cache, _fake_trial([3.0, 1.0, 2.0, 4.0]))
    dl.set_block_override(dl.BLOCK_I_KEY, None)
    monkeypatch.setenv("PADDLE_TPU_TUNE", "0")
    entry = _tune(cache, trial)
    assert entry is not None and trial.calls == []
    assert dl.get_block_override(dl.BLOCK_I_KEY) == entry["block_i"]


def test_tuner_without_a_card_changes_nothing(cache):
    assert _tune(cache, None) is None
    assert dl.get_block_override(dl.BLOCK_I_KEY) is None
    assert autotune.lookup_measured(autotune.KERNEL, "cpu", cache) is None


def test_corrupt_cache_file_is_a_miss(tmp_path):
    p = tmp_path / "tuning_cache.json"
    p.write_text("{not json")
    c = autotune.TuningCache(path=str(p))
    assert c.get("anything") is None
    c.put("k", {"kernel": "x", "block_i": 8})
    assert autotune.TuningCache(path=str(p)).peek("k")["block_i"] == 8


def test_engine_hook_tunes_once_then_hits(models, monkeypatch, tmp_path,
                                         no_override):
    """``tune_for_serving`` at the engine's decode shape: the first call
    measures (an injected trial stands in for the card), the second hits
    the cache; ``lookup_measured`` finds the entry."""
    _, tm = models
    monkeypatch.setenv("PADDLE_TPU_TUNE_CACHE", str(tmp_path / "tc.json"))
    eng = LLMEngine(tm, ServingConfig(fused_decode_layer=True, **_SERVE_CFG),
                    device="cpu")
    try:
        trial = _fake_trial([float(i) for i in range(1, 9)])
        cache = autotune.TuningCache()
        sched = eng.scheduler
        entry = autotune.tune_for_serving(eng._sm, 8, 32, sched.max_pages, 4,
                                          cache=cache, trial=trial)
        assert entry["block_i"] == tm.cfg.intermediate_size and trial.calls
        assert entry["shapes"][0] == [4, 4, 16]
        n = len(trial.calls)
        again = autotune.tune_for_serving(eng._sm, 8, 32, sched.max_pages, 4,
                                          cache=cache, trial=trial)
        assert again == entry and len(trial.calls) == n
        assert autotune.lookup_measured(autotune.KERNEL, "cpu",
                                        cache)["block_i"] == entry["block_i"]
    finally:
        eng.shutdown()
