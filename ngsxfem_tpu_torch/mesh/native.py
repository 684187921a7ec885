"""ctypes bindings for the native topology library (native/topology.cpp).

Copied from ``ngsxfem_tpu/mesh/native.py`` with one change: the shared
library is built from the repository's ``native/topology.cpp`` into the
git-ignored ``build/native/`` directory, never into ``native/`` (which holds
the JAX package's tracked prebuilt library).  Falls back to pure numpy when no
C++ compiler is present, as the original does.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "topology.cpp")
_SO = os.path.join(_ROOT, "build", "native", "libngsxtopo.so")

_LIB = None
_TRIED = False


def _build():
    """Compile topology.cpp into build/native/ (atomic: concurrent test
    workers may race, so each writes its own temp file and renames)."""
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
                   check=True, capture_output=True)
    os.replace(tmp, _SO)


def _lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        if not os.path.exists(_SO) or (
                os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_SO)
    except (OSError, subprocess.CalledProcessError):
        return None  # no compiler / no source: numpy fallback
    lib.build_facets.restype = ctypes.c_int64
    lib.build_facets.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.dedup_rows.restype = ctypes.c_int64
    lib.dedup_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.dedup_i64.restype = ctypes.c_int64
    lib.dedup_i64.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    _LIB = lib
    return _LIB


def build_facets(elements: np.ndarray, facet_loc: np.ndarray):
    """Native facet dedup; returns (facets, el2facet, facet2el, facet2elloc)
    or None if the native library is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    elements = np.ascontiguousarray(elements, dtype=np.int32)
    facet_loc = np.ascontiguousarray(facet_loc, dtype=np.int32)
    ne, nvel = elements.shape
    nfel, nvf = facet_loc.shape
    el2facet = np.empty((ne, nfel), dtype=np.int32)
    facets = np.empty((ne * nfel, nvf), dtype=np.int32)
    facet2el = np.empty((ne * nfel, 2), dtype=np.int32)
    facet2elloc = np.empty((ne * nfel, 2), dtype=np.int32)
    nf = lib.build_facets(
        elements.ctypes.data, ne, nvel, facet_loc.ctypes.data, nfel, nvf,
        el2facet.ctypes.data, facets.ctypes.data, facet2el.ctypes.data,
        facet2elloc.ctypes.data,
    )
    if nf < 0:
        return None
    return (
        facets[:nf].copy(), el2facet, facet2el[:nf].copy(),
        facet2elloc[:nf].copy(),
    )


def dedup_rows(keys: np.ndarray):
    """Native row dedup for dof fingerprints; returns (ndof, inv, first) or
    None if unavailable."""
    lib = _lib()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    n, klen = keys.shape
    inv = np.empty(n, dtype=np.int32)
    first = np.empty(n, dtype=np.int64)
    if klen == 1:
        ndof = lib.dedup_i64(keys.ctypes.data, n, inv.ctypes.data,
                             first.ctypes.data)
    else:
        ndof = lib.dedup_rows(keys.ctypes.data, n, klen, inv.ctypes.data,
                              first.ctypes.data)
    if ndof < 0:
        return None
    return int(ndof), inv, first[:ndof].copy()
