"""The port's kernel analysis tier (CK200-CK209) on the CPU: the
declaration and source planes, the resource sheets from recorded ptxas
output, the planted demo, the CLI, and the declarations held against the
JAX tier's examples and the CUDA sources.

The JAX tier's own tests (``tests/test_kernel_analysis.py``) trace real
``pallas_call``s; with jax 0.9.0 its model plane fails to trace
(``BlockMapping`` has no ``array_shape_dtype``), so those cases are red
here. The cases below therefore hold the port to the expectation each JAX
test asserts, case by case, not to a JAX run. The card plane (profiled
and guard-band launches) runs on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here its guard-band logic is rehearsed with launches
that write the plain result, or a planted fault, into the guarded
operands.
"""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from paddle_tpu_torch import cost_model  # noqa: E402
from paddle_tpu_torch.analysis.cli import (apply_allowlist,  # noqa: E402
                                           discover_allowlist,
                                           load_allowlist)
from paddle_tpu_torch.analysis.diagnostics import ERROR, INFO  # noqa: E402
from paddle_tpu_torch.analysis.kernels import (  # noqa: E402
    ALLOWLIST_NAME, analyze_paths, check_example, check_sheet,
    check_source, collect, demo, kernel_cost, resource_sheet)
from paddle_tpu_torch.analysis.kernels import model as M  # noqa: E402
from paddle_tpu_torch.analysis.kernels.__main__ import main  # noqa: E402
from paddle_tpu_torch.analysis.kernels.guard import (  # noqa: E402
    guard_example, make_inputs)
from paddle_tpu_torch.analysis.kernels.resources import (  # noqa: E402
    KernelUsage, canonical_name, occupancy, parse_cuobjdump,
    parse_resource_usage)
from paddle_tpu_torch.analysis.kernels.rules import (  # noqa: E402
    global_kernels)

KERNELS_DIR = os.path.join(REPO, "paddle_tpu_torch", "ops", "kernels")
CSRC = os.path.join(REPO, "paddle_tpu_torch", "csrc")
F32 = torch.float32
H100 = cost_model.DEVICE_PRESETS["h100"]


def _noop(t, stream):
    raise AssertionError("fixtures are never launched")


def _example(grid, in_shape, in_block, in_map, out_shape, out_block,
             out_map, smem=0, tail="fixture", accumulate=False):
    """One-in / one-out launch fixture, the counterpart of the JAX tests'
    ``_copy_call``: the tiles of a BlockSpec, as a tile map."""
    return M.Example(
        "fixture", "fixture",
        [M.Operand("x", in_shape, F32),
         M.Operand("o", out_shape, F32, "out", accumulate=accumulate)],
        [M.KernelLaunch("copy_kernel", grid, 128, smem=smem,
                        writes=[M.TileMap("o", out_block, out_map)],
                        reads=[M.TileMap("x", in_block, in_map)])],
        _noop, lambda t: {"o": t["x"]}, flops=0, nbytes=0, tail=tail,
        file="<fixture>")


def _rules(ex):
    return {f.rule_id for f in check_example(ex)}


# -- one case per JAX test case (tests/test_kernel_analysis.py:57-350) -------

ident = lambda *b: (0, 0)   # noqa: E731


JAX_CASES = {
    # test_pk200_overflowing_block_flagged: two 16 MiB f32 blocks resident
    # in one grid step; here, staged in one block's dynamic shared memory
    "pk200_overflowing_block": (
        lambda: _example(1, (4096, 1024), (4096, 1024), ident,
                         (4096, 1024), (4096, 1024), ident,
                         smem=2 * 4096 * 1024 * 4), {"CK200"}, set()),
    # test_pk200_small_block_clean: two [128, 128] f32 blocks, 128 KiB
    "pk200_small_block": (
        lambda: _example(1, (128, 128), (128, 128), ident, (128, 128),
                         (128, 128), ident, smem=2 * 128 * 128 * 4),
        set(), {"CK200"}),
    # test_pk201_nonconsecutive_output_revisit_flagged
    "pk201_nonconsecutive_revisit": (
        lambda: _example((2, 2), (2, 128), (1, 128), lambda i, j, z: (i, 0),
                         (2, 128), (1, 128), lambda i, j, z: (j, 0)),
        {"CK201"}, {"CK202", "CK203"}),
    # test_pk201_consecutive_revisit_clean: legal on the TPU's sequential
    # grid; CUDA blocks run at once, so the clean counterpart is the
    # accumulation declared (atomics)
    "pk201_consecutive_revisit_accumulated": (
        lambda: _example((2, 2), (2, 128), (1, 128), lambda i, j, z: (i, 0),
                         (2, 128), (1, 128), lambda i, j, z: (i, 0),
                         accumulate=True), set(), {"CK201"}),
    # test_pk202_uncovered_output_blocks_flagged
    "pk202_uncovered_output": (
        lambda: _example(2, (2, 128), (1, 128), lambda i, j, z: (i, 0),
                         (4, 128), (1, 128), lambda i, j, z: (i, 0)),
        {"CK202"}, set()),
    # test_pk203_out_of_bounds_index_map_flagged
    "pk203_out_of_bounds": (
        lambda: _example(2, (128, 128), (64, 128),
                         lambda i, j, z: (i + 1, 0), (128, 128), (64, 128),
                         lambda i, j, z: (i, 0)), {"CK203"}, set()),
    # test_pk20x_identity_grid_clean
    "pk20x_identity_grid": (
        lambda: _example(2, (128, 128), (64, 128), lambda i, j, z: (i, 0),
                         (128, 128), (64, 128), lambda i, j, z: (i, 0)),
        set(), {"CK201", "CK202", "CK203"}),
    # test_pk204_unmasked_tail_flagged: 100 rows of 64-row tiles and no
    # shape past the last full tile ever checked
    "pk204_unmasked_tail": (
        lambda: _example(2, (100, 128), (64, 128), lambda i, j, z: (i, 0),
                         (100, 128), (64, 128), lambda i, j, z: (i, 0),
                         tail=None), {"CK204"}, set()),
    # test_pk204_masked_tail_clean: the tail checked (on the card, by the
    # guard plane)
    "pk204_masked_tail": (
        lambda: _example(2, (100, 128), (64, 128), lambda i, j, z: (i, 0),
                         (100, 128), (64, 128), lambda i, j, z: (i, 0),
                         tail=_example(2, (100, 128), (64, 128),
                                       lambda i, j, z: (i, 0), (100, 128),
                                       (64, 128), lambda i, j, z: (i, 0))),
        set(), {"CK204"}),
    # test_clean_kernel_has_no_findings
    "clean_kernel": (
        lambda: _example(1, (8, 128), (8, 128), ident, (8, 128), (8, 128),
                         ident), set(), {"CK200", "CK201", "CK202", "CK203",
                                         "CK204", "CK209"}),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_jax_case_counterpart(case):
    """The same grid, tile shapes and index maps as the JAX test case;
    the rule it expects (first set) fires, the ones it excludes (second
    set) do not."""
    build, want, absent = JAX_CASES[case]
    rules = _rules(build())
    assert want <= rules, rules
    assert not (absent & rules), rules


# -- CK200 against the H100 preset --------------------------------------------

@pytest.mark.parametrize("smem,flagged", [(227 * 1024, False),
                                          (227 * 1024 + 1, True)])
def test_ck200_dynamic_smem_against_the_optin_limit(smem, flagged):
    ex = _example(1, (8, 128), (8, 128), ident, (8, 128), (8, 128), ident,
                  smem=smem)
    assert ("CK200" in _rules(ex)) == flagged


def test_ck200_registers_times_threads():
    ex = _example(1, (8, 128), (8, 128), ident, (8, 128), (8, 128), ident)
    ex.kernels[0].block = (1024, 1, 1)
    tight = KernelUsage("k", name="copy_kernel", registers=64)
    fat = KernelUsage("k", name="copy_kernel", registers=72)
    assert not check_sheet(resource_sheet(ex, ex.kernels[0], tight))
    rules = {f.rule_id for f in check_sheet(resource_sheet(
        ex, ex.kernels[0], fat))}
    assert rules == {"CK200"}       # 72 x 1024 > 65,536


def test_ck200_cooperative_grid_past_the_card():
    """A cooperative grid must be resident at once: blocks-per-SM x 132."""
    ex = _example(1, (8, 128), (8, 128), ident, (8, 128), (8, 128), ident)
    k = ex.kernels[0]
    k.block, k.smem, k.cooperative = (512, 1, 1), 132 * 1024, True
    usage = KernelUsage("k", name="copy_kernel", registers=128)
    k.grid = (132, 1, 1)
    sheet = resource_sheet(ex, k, usage)
    assert sheet.occupancy == 1 and sheet.fits
    assert not check_sheet(sheet)
    k.grid = (133, 1, 1)
    sheet = resource_sheet(ex, k, usage)
    assert not sheet.fits
    assert {f.rule_id for f in check_sheet(sheet)} == {"CK200"}


def test_occupancy_by_the_h100_limits():
    assert occupancy(256, 32, 0, H100) == 8          # threads: 2048 / 256
    assert occupancy(128, 255, 0, H100) == 2         # registers
    assert occupancy(128, 32, 100 * 1024, H100) == 2  # shared memory
    assert occupancy(1024, 32, 227 * 1024, H100) == 1
    assert occupancy(1056, 32, 0, H100) == 0


# -- the resource plane: recorded ptxas output --------------------------------

# nvcc -gencode arch=compute_90a,code=sm_90a ... --resource-usage, on the
# card's machine: "Cuda compilation tools, release 12.9, V12.9.86"
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z11rope_kernelPK13__nv_bfloat16PKfS3_PS_iiii' for 'sm_90a'
ptxas info    : Function properties for _Z11rope_kernelPK13__nv_bfloat16PKfS3_PS_iiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
ptxas info    : Compile time = 12.869 ms
ptxas info    : Compiling entry function '_Z15rms_norm_kernelILb1EEvPK13__nv_bfloat16S2_S2_PS0_S3_if' for 'sm_90a'
ptxas info    : Function properties for _Z15rms_norm_kernelILb1EEvPK13__nv_bfloat16S2_S2_PS0_S3_if
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 1 barriers, 128 bytes smem
ptxas info    : Compile time = 14.063 ms
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__ca73c3f4_7_mmha_cu_b234771817mmha_paged_kernelILi128ELi8EEEvPK13__nv_bfloat16S3_S3_PKiS5_PS1_iiif' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__ca73c3f4_7_mmha_cu_b234771817mmha_paged_kernelILi128ELi8EEEvPK13__nv_bfloat16S3_S3_PKiS5_PS1_iiif
    264 bytes stack frame, 264 bytes spill stores, 264 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 264 bytes cumulative stack size, 33280 bytes smem
ptxas info    : Compile time = 623.750 ms
"""


def test_parse_resource_usage_recorded_on_the_card():
    by = {u.name: u for u in parse_resource_usage(PTXAS_LOG)}
    assert set(by) == {"rope_kernel", "rms_norm_kernel<true>",
                       "mmha_paged_kernel<128,8>"}
    rope = by["rope_kernel"]                                 # plain
    assert (rope.registers, rope.static_smem, rope.barriers,
            rope.spill_stores) == (32, 0, 0, 0)
    rms = by["rms_norm_kernel<true>"]                        # a template
    assert (rms.registers, rms.static_smem, rms.barriers) == (30, 128, 1)
    mm = by["mmha_paged_kernel<128,8>"]                      # it spills
    assert (mm.registers, mm.static_smem, mm.stack, mm.spill_stores,
            mm.spill_loads) == (255, 33280, 264, 264, 264)
    assert mm.demangled.startswith(
        "void (anonymous namespace)::mmha_paged_kernel<128, 8>(")
    findings = check_sheet(resource_sheet(
        _example(1, (8, 128), (8, 128), ident, (8, 128), (8, 128), ident),
        M.KernelLaunch("mmha_paged_kernel<128,8>", (8, 8), 256), mm))
    assert [f.rule_id for f in findings] == ["CK205"]


# cuobjdump --dump-resource-usage of the same build's rms_norm library
CUOBJDUMP = """\
Resource usage:
 Common:
  GLOBAL:0
 Function _ZN44_GLOBAL__N__531f4a71_11_rms_norm_cu_c6b45bae19rms_norm_bwd_kernelILi4EEEvPK13__nv_bfloat16S3_S3_S3_PS1_Pfiiif:
  REG:161 STACK:0 SHARED:1280 LOCAL:0 CONSTANT[0]:592 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _Z15rms_norm_kernelILb1EEvPK13__nv_bfloat16S2_S2_PS0_S3_if:
  REG:30 STACK:0 SHARED:1152 LOCAL:0 CONSTANT[0]:576 TEXTURE:0 SURFACE:0 SAMPLER:0
"""


def test_cuobjdump_cross_check_parses_registers():
    regs = parse_cuobjdump(CUOBJDUMP)
    by = {u.mangled: u.registers for u in parse_resource_usage(PTXAS_LOG)}
    name = "_Z15rms_norm_kernelILb1EEvPK13__nv_bfloat16S2_S2_PS0_S3_if"
    assert regs[name] == by[name] == 30
    assert len(regs) == 2


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::rms_norm_bwd_kernel<2>(__nv_bfloat16 "
     "const*, float*, int)", "rms_norm_bwd_kernel<2>"),
    ("void adamw_kernel<float, 2>(float*, float)", "adamw_kernel<float,2>"),
    ("(anonymous namespace)::demo_double_kernel(float const*, float*, int)",
     "demo_double_kernel"),
    ("block_epilogue_kernel<0, true, false, false>",
     "block_epilogue_kernel<0,true,false,false>")])
def test_canonical_name_joins_declaration_ptxas_and_profiler(name, want):
    assert canonical_name(name) == want


# -- the source plane (CK206) ------------------------------------------------

def test_ck206_demo_plant_flagged():
    with open(demo.__file__, encoding="utf-8") as f:
        fs = check_source(f.read(), demo.__file__)
    assert [(f.rule_id, f.symbol) for f in fs] == [("CK206",
                                                    "missing_check")]


def test_ck206_except_that_falls_back_flagged():
    src = (
        "def wrapper(x):\n"
        "    fn = _build.function('lib', 'ptt_k', ARGS)\n"
        "    try:\n"
        "        _build.check(fn(x.data_ptr(), _build.stream_of(x)), 'k')\n"
        "    except RuntimeError:\n"
        "        return plain(x)\n")
    fs = check_source(src, "fix.py")
    assert [f.rule_id for f in fs] == ["CK206"]
    assert "except" in fs[0].message


def test_ck206_checked_launch_and_reraise_clean():
    src = (
        "def wrapper(x):\n"
        "    fn = _build.function('lib', 'ptt_k', ARGS)\n"
        "    err = fn(x.data_ptr(), _build.stream_of(x))\n"
        "    _build.check(err, 'k')\n"
        "    try:\n"
        "        _build.check(fn(x.data_ptr(), stream), 'k')\n"
        "    except RuntimeError as e:\n"
        "        raise ValueError('refused') from e\n"
        "    n = _build.function('lib', 'ptt_count', [])()\n")
    assert check_source(src, "fix.py") == []


def test_ck206_dropped_return_code_flagged():
    src = ("def wrapper(x):\n"
           "    _build.function('lib', 'ptt_k', A)(x.data_ptr(), s)\n"
           "    err = _build.function('lib', 'ptt_k', A)(x.data_ptr(), s)\n")
    assert [f.line for f in check_source(src, "fix.py")] == [2, 3]


# -- self-application and the planted demo -----------------------------------

@pytest.fixture(scope="module")
def kernels_cpu():
    return collect([KERNELS_DIR], device="cpu")


def test_self_application_clean_modulo_allowlist(kernels_cpu):
    findings, sheets = kernels_cpu
    entries = load_allowlist(os.path.join(REPO, ALLOWLIST_NAME))
    kept, _ = apply_allowlist(findings, entries)
    bad = [f for f in kept if f.severity != INFO]
    assert bad == [], [f"{f.rule_id} {f.file}:{f.line} {f.message}"
                       for f in bad]
    # the one note of the planes that did not run, and the undeclared write
    # maps of the decode layer (a cooperative grid's phases) and of mmha
    # (a row's output written by whichever of its chunks' blocks is last)
    assert any("device cpu" in f.message for f in kept)
    assert {os.path.basename(f.file) for f in kept
            if "write map not declared" in f.message} == {"decode_layer.py",
                                                          "mmha.py"}
    assert len(sheets) >= 200


def test_demo_trips_every_error_rule_on_its_own_plant():
    fs = analyze_paths([demo.__file__], device="cpu")
    by_plant = {}
    for f in fs:
        if f.severity == ERROR:
            plant = (f.message[1:f.message.index("]")]
                     if f.message.startswith("[") else f.symbol)
            by_plant.setdefault(plant, set()).add(f.rule_id)
    assert by_plant == {"vmem_overflow": {"CK200"},
                        "overlapping_writes": {"CK201"},
                        "coverage_gap": {"CK202"}, "oob_read": {"CK203"},
                        "missing_check": {"CK206"}}
    assert not any("vmem_scalar_mulf" in f.message for f in fs)


def test_source_plane_matches_the_jax_tier_on_the_demo():
    """The JAX tier's AST plane runs here (no trace): it flags PK206 at
    ``missing_x64_off``, and the port flags CK206 at its counterpart."""
    from paddle_tpu.analysis.kernels import check_source as jax_check
    path = os.path.join(REPO, "paddle_tpu", "analysis", "kernels", "demo.py")
    with open(path, encoding="utf-8") as f:
        jax_fs = jax_check(f.read(), path)
    assert ("PK206", "missing_x64_off") in {(f.rule_id, f.symbol)
                                            for f in jax_fs}
    with open(demo.__file__, encoding="utf-8") as f:
        port_fs = check_source(f.read(), demo.__file__)
    assert {(f.rule_id, f.symbol) for f in port_fs} == {
        ("CK206", "missing_check")}


def test_plain_plants_equal_the_jax_bodies():
    """The JAX demo's kernel bodies, run on numpy arrays as refs, against
    the port's plain versions of the plants on the same inputs."""
    from paddle_tpu.analysis.kernels import demo as jdemo
    x = np.random.default_rng(0).standard_normal((128, 128)).astype(
        np.float32)
    xt = torch.from_numpy(x)
    for body, plain in ((jdemo._double_kernel, demo.double_plain),
                        (jdemo._copy_kernel, lambda t: demo.copy_plain(
                            t, 128)),
                        (jdemo._vmem_scalar_kernel, demo.scalar_plain)):
        o = np.empty_like(x)
        body(x, o)
        np.testing.assert_array_equal(plain(xt).numpy(), o)
    # the coverage-gap and out-of-bounds plants copy into 256 rows: the
    # first 128 are the copy
    np.testing.assert_array_equal(demo.copy_plain(xt, 256)[:128].numpy(), x)


@pytest.mark.parametrize("plant,rule,message", [
    ("coverage_gap", "CK202", "16384 of 32768 elements of o still hold the "
                              "sentinel"),
    ("oob_read", "CK203", "16384 NaN in o")])
def test_guard_plane_finds_the_plants_fault(plant, rule, message):
    """The guard launch rehearsed on the CPU: a launch that does what the
    plant's kernel does (blocks copy the declared tiles, reading the
    guard band past the input) leaves the sentinel, or the poison."""
    ex = next(e for e in demo.ck_examples() if e.label == plant)

    def launch(t, stream):
        x = t["x"]
        flat_x = x.reshape(-1)
        o = t["o"]
        for b in range(ex.kernels[0].grid[0]):
            # tile b of x: 64 rows, read through the storage past x's end
            src = flat_x.as_strided((64, 128), (128, 1),
                                    x.storage_offset() + b * 64 * 128)
            o[b * 64:(b + 1) * 64] = src
    ex.launch = launch
    findings = []
    guard_example(torch, ex, "cpu", findings)
    assert {f.rule_id for f in findings} == {rule}
    assert any(message in f.message for f in findings)


def test_guard_plane_finds_a_write_past_the_output():
    ex = next(e for e in demo.ck_examples() if e.label == "vmem_scalar_mulf")

    def launch(t, stream):
        o = t["o"]
        o.copy_(demo.scalar_plain(t["x"]))
        o.reshape(-1).as_strided((8,), (1,), o.storage_offset()
                                 + o.numel()).fill_(1.0)
    ex.launch = launch
    findings = []
    guard_example(torch, ex, "cpu", findings)
    assert [f.rule_id for f in findings] == ["CK203"]
    assert "guard band after o" in findings[0].message


# -- the declarations against the JAX tier and the CUDA sources --------------

PORT_OF = {"a8w8_matmul_pallas": "a8w8_matmul", "adamw_pallas": "adamw",
           "bias_dropout_ln_pallas": "bias_dropout_ln",
           "block_fused_pallas": "block_epilogue", "ce_pallas": "parallel_ce",
           "decode_layer_pallas": "decode_layer",
           "dropout_add_pallas": "dropout_add",
           "flash_attention_pallas": "flash_attention",
           "lamb_pallas": "lamb", "linear_grad_add_pallas": "linear_grad_add",
           "mmha_pallas": "mmha", "moe_gemm_pallas": "moe_gemm",
           "rms_norm_pallas": "rms_norm", "rope_pallas": "rope",
           "softmax_mask_pallas": "softmax_mask", "swiglu_pallas": "swiglu",
           "wo_matmul_pallas": "wo_matmul"}
#: operands whose layout or type the port's kernel takes otherwise, by JAX
#: module: compared by element count only (the reason beside each)
LAYOUT = {
    "mmha_pallas": "the port's cache is the paged pool, not a contiguous "
                   "[B, Hkv, T, D] buffer",
    "decode_layer_pallas": "the kernel takes bf16 (the JAX example is f32) "
                           "and the paged pool",
    "softmax_mask_pallas": "the kernel takes 4-D [B, H, Sq, Sk] scores",
    "ce_pallas": "the kernel takes int64 labels",
    "bias_dropout_ln_pallas": "the C entry takes f32 vectors and an f32 "
                              "mask",
}


def _jax_examples(modname):
    import importlib
    mod = importlib.import_module(f"paddle_tpu.ops.kernels.{modname}")
    return [(e[0], [a for a in e[2] if a is not None
                    and len(getattr(a, "shape", ())) >= 1])
            for e in mod.pk_examples()]


@pytest.mark.parametrize("jax_mod", sorted(PORT_OF))
def test_examples_cover_the_jax_labels_shapes_and_dtypes(jax_mod):
    import importlib
    port = importlib.import_module(
        f"paddle_tpu_torch.ops.kernels.{PORT_OF[jax_mod]}")
    examples = {e.label: e for e in port.ck_examples()}
    for label, args in _jax_examples(jax_mod):
        assert label in examples, (jax_mod, label, sorted(examples))
        ops = examples[label].operands
        if jax_mod in LAYOUT:
            have = sorted(o.numel for o in ops)
            for a in args:
                if jax_mod == "mmha_pallas" and len(a.shape) == 4 \
                        and a.shape[1] != 1:
                    continue          # the contiguous cache
                if jax_mod == "decode_layer_pallas" and len(a.shape) == 4:
                    continue          # the pool slice
                assert int(np.prod(a.shape)) in have, (label, a.shape)
            continue
        have = [(o.shape, str(o.dtype).replace("torch.", "")) for o in ops]
        for a in args:
            want = (tuple(a.shape), np.dtype(a.dtype).name)
            assert want in have, (label, want, have)
            have.remove(want)


def test_grouped_example_passes_the_group_size(monkeypatch):
    """The first card run of the guard plane found the grouped weight-only
    examples passing K/G where ``ptt_wo_int8_grouped`` takes G: the kernel
    then read its scales past their end (NaN from the guard's poison).
    Every grouped example must hand the C entry K / scale rows."""
    from paddle_tpu_torch.ops.kernels import wo_matmul
    seen = []
    monkeypatch.setattr(wo_matmul, "_call", lambda name, symbol, args, x, w,
                        s, y, extra, stream: seen.append((w.shape[0],
                                                          s.shape, extra)))
    for ex in wo_matmul.ck_examples():
        for e in (ex, ex.tail):
            if e.label.startswith(("wo_int8_grouped",
                                   "phase3 wo_int8_grouped")):
                t = {op.name: torch.empty(op.shape, dtype=op.dtype)
                     for op in e.operands}
                e.launch(t, 0)
    assert len(seen) == 10
    for k, s_shape, extra in seen:
        assert extra == (k // s_shape[0],), (k, s_shape, extra)


def _all_examples():
    import importlib
    out = []
    for path in sorted(glob.glob(os.path.join(KERNELS_DIR, "*.py"))):
        name = os.path.basename(path)[:-3]
        mod = importlib.import_module(f"paddle_tpu_torch.ops.kernels.{name}")
        if hasattr(mod, "ck_examples"):
            out += mod.ck_examples()
    return out + demo.ck_examples()


def test_every_global_kernel_is_declared():
    launched = set()
    for ex in _all_examples():
        for e in (ex, ex.tail):
            if isinstance(e, M.Example):
                launched.update(k.kernel.split("<")[0] for k in e.kernels)
    defined = set()
    for cu in glob.glob(os.path.join(CSRC, "*.cu")):
        with open(cu, encoding="utf-8") as f:
            defined.update(global_kernels(f.read()))
    assert len(defined) == 41
    assert defined <= launched, sorted(defined - launched)


def test_every_example_has_a_tail_and_a_plain_version():
    for ex in _all_examples():
        assert ex.tail is not None, ex.label
        t = make_inputs(torch, ex, torch.device("cpu")) \
            if sum(o.numel for o in ex.operands) < 2_000_000 else None
        if t is not None:
            want = ex.plain(t)
            outs = {o.name for o in ex.outputs}
            assert set(want) <= outs, (ex.label, set(want), outs)


# -- the CLI, the allowlist and the costs ------------------------------------

def test_cli_json_select_and_exit_codes(capsys):
    assert main([demo.__file__, "--device", "cpu", "--no-allowlist",
                 "--format", "json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["counts"]["error"] == 5
    assert {s["kernel"] for s in payload["resource_sheets"]} >= {
        "demo_double_kernel", "demo_gap_kernel"}
    assert main([demo.__file__, "--device", "cpu", "--no-allowlist",
                 "--select", "CK201"]) == 1
    out = capsys.readouterr().out
    assert "CK201" in out and "CK202" not in out
    assert main([demo.__file__, "--device", "cpu", "--select", "CK204"]) == 0
    assert main([KERNELS_DIR, "--device", "cpu"]) == 0
    capsys.readouterr()


def test_cli_list_rules(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in ("CK200", "CK201", "CK202", "CK203", "CK204", "CK205",
                "CK206", "CK209"):
        assert rid in out
    assert "PK207" not in out and "CK207" not in out


def test_cli_without_device_cpu_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs every plane")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([KERNELS_DIR])


def test_allowlist_discovered_above_the_analyzed_paths(tmp_path):
    assert discover_allowlist([KERNELS_DIR], ALLOWLIST_NAME) == os.path.join(
        REPO, ALLOWLIST_NAME)
    waiver = tmp_path / "waivers.txt"
    waiver.write_text("analysis/kernels/demo.py CK201  # fixture\n")
    entries = load_allowlist(str(waiver))
    kept, waived = apply_allowlist(
        analyze_paths([demo.__file__], device="cpu"), entries)
    assert [f.rule_id for f in waived] == ["CK201"]
    assert "CK201" not in {f.rule_id for f in kept}


def test_kernel_cost_has_the_jax_keys():
    cost = kernel_cost("paddle_tpu_torch.ops.kernels.rms_norm", device="cpu")
    # paddle_tpu/analysis/kernels/__init__.py:140-174: module, chip,
    # vmem_budget, kernels, notes
    assert set(cost) == {"module", "device", "smem_budget", "kernels",
                         "notes"}
    assert cost["smem_budget"] == 227 * 1024 == cost_model.smem_per_block_bytes()
    sheet = next(s for s in cost["kernels"]
                 if s["label"] == "phase3 [4096, 4096]")
    assert sheet["cost_source"] == "roofline"
    assert sheet["kernel"] == "rms_norm_bwd_kernel<false>"
    assert sheet["predicted_ms"] == pytest.approx(
        cost_model.roofline_ms(sheet["flops"], sheet["nbytes"], "f32"))
    # what phase 3 has always counted: h, g read and dx written in bf16,
    # w read and dw written
    assert sheet["nbytes"] == 2 * 4096 * 4096 * 3 + 2 * 4096 * 2


def test_h100_preset_and_roofline():
    p = cost_model.device_preset("h100")
    assert (p["sms"], p["smem_per_block_optin"], p["smem_per_sm"],
            p["regs_per_sm"], p["threads_per_sm"]) == (
        132, 232448, 233472, 65536, 2048)
    assert cost_model.roofline_ms(0, 3.35e9) == pytest.approx(1.0)
    assert cost_model.roofline_ms(989e9, 0, "bf16") == pytest.approx(1.0)
    with pytest.raises(KeyError):
        cost_model.device_preset("v5e")
