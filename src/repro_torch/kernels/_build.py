"""Build and load the CUDA kernels: one ``nvcc`` per source, run in parallel,
each into a shared library with a plain C interface that ``ctypes`` loads.

The build happens at first use, from the sources under ``csrc/`` only, into
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``).
A library's file name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and a stale
library is never loaded.  ``nvcc``'s ``-Xptxas -v`` report (registers,
shared memory, spills) is printed once, one line per kernel, when a
library is built, and kept in ``REPORTS``.

Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("decode_attention", "matmul", "flash_attention",
           "sparse_attention", "moe_ffn", "quant_moe_ffn", "quant_matmul",
           "stream", "stencil", "chunk_scan", "embed_gather", "ssd", "rglru",
           "windowed_gather", "rmsnorm")
MAX_SMEM = 227 * 1024               # dynamic shared memory a block may use
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures: every pointer and the stream as c_void_p, ints as c_int
SIGNATURES = {
    "decode_attention": {
        "split_kv_attention": [_P] * 10 + [_I] * 16 + [_F, _P],
        "split_kv_instance": [_I, _P, _I, _P, _P],
    },
    "matmul": {
        "coarsened_matmul_bf16": [_P] * 4 + [_I] * 11 + [_F, _P],
        "coarsened_matmul_instance": [_I, _P, _I, _P, _P],
    },
    "flash_attention": {
        "flash_fwd_bf16": [_P] * 6 + [_I] * 12 + [_F, _P],
        "flash_dq_bf16": [_P] * 8 + [_I] * 12 + [_F, _P],
        "flash_dkv_bf16": [_P] * 9 + [_I] * 12 + [_F, _I, _P],
        "flash_dkv_clusters": [_I] * 7,
        "flash_bwd_prep": [_P] * 4 + [_I] * 2 + [_P],
        "flash_bwd_instance": [_I, _P, _I, _P, _P],
    },
    "sparse_attention": {
        "flash_sparse_fwd_bf16": [_P] * 7 + [_I] * 13 + [_F, _P],
    },
    "moe_ffn": {
        "moe_ffn_bf16": [_P] * 7 + [_I] * 6 + [_P],
    },
    "quant_moe_ffn": {
        "quant_moe_ffn": [_P] * 10 + [_I] * 18 + [_P],
        "quant_moe_ffn_instance": [_I, _P, _I, _P, _P],
    },
    "quant_matmul": {
        "quant_matmul": [_P] * 4 + [_I] * 8 + [_P],
    },
    "stream": {
        "ew_stream_f32": [_P, _I, _P, _L] + [_I] * 8 + [_P],
        "gather_stream_f32": [_P, _P, _I, _P, _L] + [_I] * 11 + [_P],
    },
    "stencil": {
        "stencil5_f32": [_P] * 2 + [_I] * 8 + [_P],
    },
    "chunk_scan": {
        "dp_scan_f32": [_P] * 2 + [_I] * 3 + [_P],
    },
    "embed_gather": {
        "embed_gather": [_P] * 3 + [_I] * 9 + [_P],
    },
    "ssd": {
        "ssd_f32": [_P] * 7 + [_I] * 10 + [_P],
    },
    "rglru": {
        "rglru_f32": [_P] * 5 + [_I] * 7 + [_P],
    },
    "windowed_gather": {
        "windowed_gather_f32": [_P] * 4 + [_I] * 8 + [_P],
    },
    "rmsnorm": {
        "rmsnorm_bf16": [_P] * 3 + [_I] * 2 + [_F, _P],
        "qk_norm_rope_bf16": [_P] * 8 + [_I] * 6 + [_F, _P],
    },
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
REPORTS: dict[str, list[str]] = {}  # source -> its kernels' ptxas lines


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _target(name: str) -> Path:
    # the shared headers are part of every source's identity
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                             *sorted(CSRC.glob("*.cuh"))])
    tag = hashlib.sha1(src + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def _start(name: str) -> tuple[Path, subprocess.Popen | None, str]:
    """Start nvcc for one source (None when its library is already built)."""
    out = _target(name)
    if out.exists():
        return out, None, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True), tmp


def _report(log: str) -> list[str]:
    """One line per kernel from nvcc's ``-Xptxas -v`` output: its
    (mangled) name, registers and shared memory, stack and spills."""
    lines, name, spill = [], "", ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and name:
            lines.append(f"  {name}: {ln.split(':', 1)[1].strip()}; "
                         f"{spill}")
            name = ""
    return lines


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every source that has no library yet, all at once; returns
    {name: library path}.  Raises with nvcc's output when a build fails."""
    started = {n: _start(n) for n in names}
    paths = {}
    for n, (out, proc, tmp) in started.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                Path(tmp).unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed for {n}.cu:\n{log}")
            os.replace(tmp, out)
            REPORTS[n] = _report(log)
            print(f"[build] {out.name}\n" + "\n".join(REPORTS[n]),
                  flush=True)
        paths[n] = out
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def instances(name: str, entry: str) -> list[tuple[str, int, int]]:
    """(name, local bytes a thread, registers) of every kernel instance
    that the library's ``entry`` enumerates, read from the loaded module
    (`cudaFuncGetAttributes`): the local bytes are the spills and stack
    frame, whether or not this process built the library."""
    fn = getattr(library(name), entry)
    label, local, regs = (ctypes.create_string_buffer(64), ctypes.c_int(),
                          ctypes.c_int())
    out = []
    while True:
        rc = fn(len(out), ctypes.addressof(label), 64,
                ctypes.addressof(local), ctypes.addressof(regs))
        if rc == -1:
            return out
        check(rc, entry)
        out.append((label.value.decode(), local.value, regs.value))


def pointers(tensors) -> ctypes.Array:
    """A C array of the tensors' device pointers (``const void* const*``);
    the caller keeps the tensors alive across the call."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def check_f32_cuda(what: str, tensors) -> None:
    """Raise unless every tensor is contiguous, 16-byte aligned float32 on
    one CUDA device (the streaming kernels' vector loads need that)."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} operands must share one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{what} kernel takes float32")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError(f"{what} kernel takes contiguous, 16-byte aligned "
                         f"operands")


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
