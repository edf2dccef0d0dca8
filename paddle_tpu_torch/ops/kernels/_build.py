"""Build and load the port's CUDA kernels (counterpart of
``paddle_tpu/ops/kernels/_common.py``).

Each ``paddle_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into its
own shared library with a plain C interface and loaded with ``ctypes``.
The libraries go to ``paddle_tpu_torch/_build/`` (ignored by git), named
by a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused. The first kernel call builds every source at
once, one ``nvcc`` process each, all started together. A missing ``nvcc``
or a failed compile raises :class:`KernelBuildError`; nothing falls back.
``--resource-usage`` makes ptxas print each kernel's registers, shared
memory, stack frame and spills; that log is kept beside its library
(:func:`usage_path`) for the kernel analyzer's resource sheets
(``paddle_tpu_torch/analysis/kernels/resources.py``).

Every C entry point takes device pointers and the stream as
``c_void_p`` and returns ``cudaGetLastError()``; :func:`check` raises when
it is not 0, because a refused launch never runs and a later synchronise
does not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["KernelBuildError", "SOURCES", "build_all", "function", "check",
           "stream_of", "require_aligned", "lib_path", "usage_path",
           "resource_usage"]

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("rms_norm", "swiglu", "rope", "mmha", "block_epilogue",
           "flash_attention", "flash_attention_bwd", "decode_layer",
           "wo_matmul", "a8w8_matmul", "adamw", "lamb", "cross_entropy",
           "moe_gemm", "softmax_mask", "bias_dropout_ln", "dropout_add",
           "linear_grad_add", "analysis_demo")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--resource-usage")

_lock = threading.Lock()
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or a kernel source failed to compile."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise KernelBuildError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's "
        "kernels are built from paddle_tpu_torch/csrc at first use")


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def usage_path(name: str) -> Path:
    """Where the ptxas resource-usage log of library ``name`` is kept."""
    return lib_path(name).with_suffix(".usage.txt")


def resource_usage(name: str) -> str:
    """The ptxas resource-usage log of library ``name`` (built first)."""
    build_all((name,))
    return usage_path(name).read_text()


def build_all(names=SOURCES) -> float:
    """Compile every library not built yet, one nvcc process per source,
    all running at once. Returns the seconds spent (0 when all are built)."""
    t0 = time.perf_counter()
    todo = [n for n in names
            if not (lib_path(n).is_file() and usage_path(n).is_file())]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for n in todo:
        out = lib_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{n}.cu")]
        jobs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for n, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"--- {n}.cu (exit {proc.returncode}) ---\n{log}")
        else:
            usage = usage_path(n)
            usage.with_name(f"{usage.name}.{os.getpid()}.tmp").write_text(log)
            os.replace(usage.with_name(f"{usage.name}.{os.getpid()}.tmp"),
                       usage)
            os.replace(tmp, out)
    if errors:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of library ``name``, typed; builds all
    libraries on first use (under a lock; a function already loaded is
    returned without it)."""
    key = (name, symbol)
    fn = _functions.get(key)
    if fn is not None:
        return fn
    with _lock:
        fn = _functions.get(key)
        if fn is None:
            build_all()
            fn = getattr(ctypes.CDLL(str(lib_path(name))), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _functions[key] = fn
        return fn


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: kernel launch failed with cudaError {err}")


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device (through the
    raw-handle getter torch's own generated code calls, where this build
    has it: no Stream object a call)."""
    global _raw_stream
    if _raw_stream is None:
        import torch
        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", False) \
            or (lambda i: torch.cuda.current_stream(i).cuda_stream)
    return _raw_stream(t.get_device())


_raw_stream = None


def require_aligned(what: str, *tensors) -> None:
    """The kernels move 16-byte vectors: every operand must start on a
    16-byte boundary."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{what}: operand is not 16-byte aligned "
                             f"(storage offset {t.storage_offset()})")
