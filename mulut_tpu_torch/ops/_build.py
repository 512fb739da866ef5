"""Build and load the port's CUDA kernels.

Each source in `csrc/` has a plain C interface and is compiled by `nvcc`
into its own shared library for `sm_90a`, then loaded with `ctypes`.  The
build runs at first use, one `nvcc` per source, all started together; the
libraries go to `_build/` beside this file (listed in `.gitignore`), named
by a hash of the source, the shared headers (`csrc/*.cuh`) and the flags,
so an edited source or header is rebuilt.  Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("fold_contract", "window_fold", "tail_assemble", "plain_window",
           "plain_feature", "plain_site", "dense_ensemble", "dense_window",
           "dense_feature", "dense_unit", "plain_w8a8")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # any source may include one
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing; returns
    {name: compiler output} for the sources compiled by this call (the
    `-Xptxas -v` register and shared-memory report).  Raises with the
    compiler output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = []
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((name, proc, tmp, out))
    logs, failed = {}, []
    for name, proc, tmp, out in jobs:
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of `csrc/{name}.cu`, built if needed."""
    build_all()
    return ctypes.CDLL(str(_lib_path(name)))
