"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into its
own shared library with a plain C interface, loaded with :mod:`ctypes`.  The
libraries land in ``build/repro_torch_kernels/`` at the checkout root, named
by a hash of every source and flag, so an edited source rebuilds and an
unchanged one loads at once.  All sources compile in parallel (one ``nvcc``
each), and each splits its device code over the host's cores
(``--split-compile=0``: the decode kernel's many instantiations).
Importing this module needs no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

__all__ = ["SRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build_all", "library",
           "build_log"]

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              "--split-compile=0"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc on the GPU host")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(SRC_DIR.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(stem: str) -> Path:
    return BUILD_DIR / f"{stem}-{_digest()}.so"


def build_all() -> Dict[str, float]:
    """Compile every source whose library is missing, all at once; returns
    ``{stem: seconds}`` for the sources it compiled.  Raises with the
    compiler's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src in sorted(SRC_DIR.glob("*.cu")):
        out = _lib_path(src.stem)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs[src.stem] = (out, tmp, time.perf_counter(),
                          subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    seconds, failed = {}, []
    for stem, (out, tmp, t0, proc) in jobs.items():
        log, _ = proc.communicate()
        seconds[stem] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc {stem}.cu failed ({proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def build_log(stem: str) -> str:
    """The compiler's output (``-Xptxas=-v``: registers, spills, shared
    memory per kernel) from the build of ``csrc/<stem>.cu``."""
    p = _lib_path(stem).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built first if needed."""
    lib = _LIBS.get(stem)
    if lib is None:
        path = _lib_path(stem)
        if not path.exists():
            build_all()
        lib = _LIBS[stem] = ctypes.CDLL(str(path))
    return lib
