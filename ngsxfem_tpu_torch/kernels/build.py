"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  On first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
the git-ignored ``build/kernels/`` directory of the checkout and loaded with
``ctypes``.  The library name carries a hash of the source and the flags, so
an edited source is rebuilt and never confused with a stale build.  Nothing
here runs at import time: this module is imported on machines without
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED = {}


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels build only where the "
                           "CUDA toolkit is installed")
    return found


def build(name, src=None):
    """Compile ``csrc/<name>.cu`` (or the source at ``src``) if no current
    build exists.

    Returns ``(path to the .so, seconds spent compiling, compiler log)``;
    the seconds are 0 and the log empty when an existing build was reused.
    """
    src = src or os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    so = os.path.join(BUILD_DIR, f"lib{name}-{tag}.so")
    if os.path.exists(so):
        return so, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so, time.perf_counter() - t0, proc.stdout + proc.stderr


def build_all(names, srcs=None):
    """``build`` for several sources at once: one ``nvcc`` per source, all
    started together; ``srcs`` maps a name to its source where it is not
    under ``csrc/``.  Returns {name: build(name, src)}."""
    from concurrent.futures import ThreadPoolExecutor

    srcs = srcs or {}
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(lambda n: build(n, srcs.get(n)),
                                        names)))


def load(name):
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    lib = _LOADED.get(name)
    if lib is None:
        so, _, _ = build(name)
        lib = _LOADED[name] = ctypes.CDLL(so)
    return lib
