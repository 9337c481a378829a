"""Where the port meets the card: device selection and the CUDA build.

The kernels are CUDA C++ sources in ``csrc/`` with a plain C interface
(``*.cuh`` holds code that several sources include).
At first CUDA use they are compiled with ``nvcc`` for ``sm_90a`` into
``build/`` (beside this file, listed in ``.gitignore``) and loaded with
``ctypes``; nothing here runs at import time, so the package imports on
machines without a CUDA toolkit. ``--use_fast_math`` is deliberately
absent: it would turn ``/`` into an approximate division and ``expf``
into ``__expf``, and the activation snap depends on IEEE division.

A failed build or a refused launch raises; nothing falls back to the
plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["resolve_device", "build_all", "load", "check", "stream_ptr",
           "SOURCES"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
SOURCES = ("stacked_i8.cu", "stacked_aovp.cu", "int8_kv_attention.cu",
           "stacked_prefill.cu", "stacked_p4.cu", "qmatmul_w4.cu",
           "int8_kv_attention_split.cu", "w8a8_matmul.cu", "kv_append.cu")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict = {}


def resolve_device(device=None) -> torch.device:
    """``device`` or the default ``"cuda"``; raises when a CUDA device is
    asked for and none is present (the port never quietly runs on the
    CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(source: str) -> Path:
    # the shared headers are part of every source's build
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1((CSRC / source).read_bytes() + headers
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{Path(source).stem}-{digest}.so"


def build_all() -> dict:
    """Compile every source that has no up-to-date library, one ``nvcc``
    per source, all started together. Returns {source: ptxas report}."""
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for src in SOURCES:
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[src] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    reports = {}
    failed = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[src] = log
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{log}")
        else:
            tmp.replace(out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _LIBS.get(source)
    if lib is None:
        path = _lib_path(source)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        lib.aq_error_string.argtypes = [ctypes.c_int]
        lib.aq_error_string.restype = ctypes.c_char_p
        _LIBS[source] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}: "
                           f"{lib.aq_error_string(code).decode()}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
