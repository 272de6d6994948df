"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into its
own shared library with a plain C interface, loaded with :mod:`ctypes`.  The
libraries land in ``build/repro_torch_kernels/`` at the checkout root, named
by a hash of every source and flag, so an edited source rebuilds and an
unchanged one loads at once.  All sources compile in parallel (one ``nvcc``
each, or one a part for a source listed in ``PARTS``: the decode kernel's
instantiations, compiled a sixth at a time and linked into its one
library), and each splits its device code over the host's cores
(``--split-compile=0``).  Importing this module needs no ``nvcc``.
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

__all__ = ["SRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "PARTS", "build_all",
           "library", "build_log"]

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              "--split-compile=0"]
#: Sources compiled in parts: ``{stem: (macro, parts)}``.  Each part is one
#: ``nvcc -c -D<macro>=<i>`` of the whole source, all run at once, and the
#: objects are linked into the source's one library.
PARTS = {"decode_fused": ("DECODE_PART", 6)}

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
    h = hashlib.sha256(f"{' '.join(NVCC_FLAGS)} {sorted(PARTS.items())}"
                       .encode())
    for p in sorted(SRC_DIR.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(stem: str) -> Path:
    return BUILD_DIR / f"{stem}-{_digest()}.so"


def _compile(src: Path, dst: Path, part=None) -> subprocess.Popen:
    """Start ``nvcc`` on ``src``: the whole library, or one part's object;
    its output goes to ``dst`` with the suffix ``.out``."""
    if part is None:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(dst), str(src)]
    else:
        flags = [f for f in NVCC_FLAGS if f != "-shared"]
        cmd = [_nvcc(), *flags, "-c", f"-D{PARTS[src.stem][0]}={part}",
               "-o", str(dst), str(src)]
    with open(dst.with_suffix(".out"), "w") as out:
        return subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)


def _finish(out: Path, tmp: Path, procs) -> str:
    """Link a finished source's part objects into ``tmp``, move it to
    ``out`` and keep the compiler's output beside it; returns "" or the
    failure's output."""
    ok = all(proc.returncode == 0 for _, proc in procs)
    logs = []
    for dst, _ in procs:
        logs.append(dst.with_suffix(".out").read_text())
        dst.with_suffix(".out").unlink()
    objs = [dst for dst, _ in procs if dst != tmp]
    if ok and objs:
        link = subprocess.run(
            [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(link.stdout)
        ok = link.returncode == 0
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "".join(logs)
    out.with_suffix(".log").write_text(log)
    if not ok:
        tmp.unlink(missing_ok=True)
        return log
    os.replace(tmp, out)
    return ""


def build_all() -> Dict[str, float]:
    """Compile every source whose library is missing, all at once; returns
    ``{stem: seconds}`` for the sources it compiled, each from the start to
    its own library.  Raises with the compiler's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0, pending = time.perf_counter(), {}
    for src in sorted(SRC_DIR.glob("*.cu")):
        out = _lib_path(src.stem)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        if src.stem in PARTS:
            dsts = [tmp.with_suffix(f".part{i}.o")
                    for i in range(PARTS[src.stem][1])]
            procs = [(dst, _compile(src, dst, i))
                     for i, dst in enumerate(dsts)]
        else:
            procs = [(tmp, _compile(src, tmp))]
        pending[src.stem] = (out, tmp, procs)
    seconds, failed = {}, []
    while pending:
        done = [stem for stem, (_, _, procs) in pending.items()
                if all(proc.poll() is not None for _, proc in procs)]
        for stem in done:
            log = _finish(*pending.pop(stem))
            seconds[stem] = time.perf_counter() - t0
            if log:
                failed.append(f"nvcc {stem}.cu failed:\n{log}")
        if pending:
            time.sleep(0.05)
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
