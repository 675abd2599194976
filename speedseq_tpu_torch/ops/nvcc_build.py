"""Build a CUDA source of ``csrc/`` into a ctypes-loadable shared library.

Each source compiles with ``nvcc`` for ``sm_90a`` into a plain-C shared
library under ``ops/build/``, keyed by a hash of the source, on first use
(``torch.utils.cpp_extension`` is not used: it needs ninja and builds for
minutes).  Only the launching wrappers call this; nothing here runs when a
module is imported.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def build_library(source: str, info: dict, verbose_ptxas: bool = False) -> str:
    """Compile ``source`` (once per source hash); returns the .so path.
    A fresh compile records its seconds, command and ptxas report in
    ``info``."""
    with open(source, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    so = os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")
    if os.path.exists(so) and not verbose_ptxas:
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}.{threading.get_ident()}"
    cmd = [_nvcc(), *NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose_ptxas else [])
    cmd += [source, "-o", tmp]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)
    info.update(seconds=time.perf_counter() - t0, ptxas=res.stderr,
                command=" ".join(cmd))
    return so
