"""Build the port's CUDA sources with nvcc at first use.

Each library is built from its sources under ``ops/csrc/`` by one nvcc
call, has a plain C interface and is loaded with ctypes: ``photometric``
holds K1 (photo_reduce.cu, at padded widths 32 and 48) and the prep kernel
(photo_prep.cu, at code widths 16 and 32), every instantiation compiled
by that one call; ``assembly`` holds the Hessian assembly
(hessian_assembly.cu); ``geometric`` the geometric factor's linearization
(geo_linearize.cu, at code widths 16 and 32). The first load builds every
library not yet built, one nvcc each, all at once. Libraries
go to ``_build/`` beside this file (listed in .gitignore), named by the
hash of their sources and the flags, so an edited source is rebuilt and
an unchanged one is not. A build
writes to a temporary name and renames it into place, so two processes
that build at once do not see a half-written file. A missing nvcc or a
failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "ops" / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = {"photometric": ("photo_reduce.cu", "photo_prep.cu"), "assembly": ("hessian_assembly.cu",),
           "geometric": ("geo_linearize.cu",)}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    for home in (cuda_home, "/usr/local/cuda"):
        if home:
            candidates.append(os.path.join(home, "bin", "nvcc"))
    for cand in candidates:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
        "the CUDA kernels cannot be built"
    )


def library_path(name: str) -> Path:
    src = b"".join((CSRC_DIR / f).read_bytes() for f in SOURCES[name])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=None) -> dict:
    """Compile the named libraries (default: all) that are not built yet,
    one nvcc per library, all started together. Returns {name: (seconds,
    compiler output)} for the sources compiled by this call."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    start = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC_DIR / f) for f in SOURCES[name])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs[name] = (proc, tmp, out)
    results = {}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        results[name] = (time.perf_counter() - start, log)
    if failures:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))
    return results


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """One built library, building it and every other library not yet built
    first if needed."""
    path = library_path(name)
    if not path.exists():
        build()
    return ctypes.CDLL(str(path))
