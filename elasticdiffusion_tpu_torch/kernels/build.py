"""Builds the CUDA sources under ``csrc/`` and loads them with ctypes.

Every source has a plain C interface, so no PyTorch header is compiled:
``nvcc`` turns each ``.cu`` into its own shared library (for ``sm_90a``) in a
few seconds, all sources in parallel. Libraries land in ``build/kernels`` at
the root of the checkout (``.gitignore`` lists ``build/``), named after a hash
of the sources, so an edited source rebuilds and an unchanged one is reused.

The build happens at first use, never at import: a host without ``nvcc``
imports every module of the package and runs the plain versions on CPU
tensors. A failed build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("flash_attention", "layernorm", "groupnorm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}  # nvcc output per source (registers, spills)


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        exe = "/usr/local/cuda/bin/nvcc"
    if exe is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are compiled at first use and "
            "need the CUDA toolkit on the machine with the GPU")
    return exe


def _source_hash() -> str:
    h = hashlib.sha1()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}_{_source_hash()}.so"


def build_all() -> float:
    """Compile every source that has no up-to-date library, all in parallel.
    Returns the seconds spent. Raises RuntimeError with nvcc's output."""
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    procs = {}
    for name in todo:
        tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, _lib_path(name))
    spent = time.time() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return spent


def load(name: str) -> ctypes.CDLL:
    """The shared library of one source, built first if need be."""
    lib = _libs.get(name)
    if lib is None:
        if name not in SOURCES:
            raise KeyError(name)
        build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.ed_cuda_error_string.restype = ctypes.c_char_p
        lib.ed_cuda_error_string.argtypes = [ctypes.c_int]
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str,
          unsupported: Optional[str] = None) -> None:
    """Raise unless a launch returned cudaSuccess."""
    if code == 0:
        return
    if code == -1:
        raise NotImplementedError(unsupported or f"{what}: no such kernel")
    msg = lib.ed_cuda_error_string(code).decode()
    raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
