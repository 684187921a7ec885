"""How the port enters its hand-written CUDA kernels.

``Library`` is the only code of the port that loads a build of
``csrc/<name>.cu``, sets the signatures of its C entries (each returns an
int, 0 on success), reads a CUDA stream, and turns a nonzero return into
``RuntimeError`` carrying the library's own error text.  ``on_card`` is the
sparse layer's one test of "on a card": each operation branches on it
between its kernel and its plain twin.  Nothing here touches a card at
import time.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

# the C types of the interfaces: pointers and streams, int, unsigned, int64
PTR, INT, U32, I64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                      ctypes.c_longlong)


def on_card(t):
    """Whether tensor ``t`` lies on a CUDA card, where the kernels run."""
    return t.is_cuda


class Library:
    """The C entries of one build of ``csrc/<name>.cu``: ``entries`` maps the
    caller's key (a dtype, or a name) to ``(C name, argument types)``; the
    error text comes from ``<prefix>_error_string`` (``prefix`` defaults to
    ``name``).  Loaded (``build.load``, or the library at ``path``) and
    bound at the first call, once."""

    def __init__(self, name, entries, prefix=None, path=None):
        self.name, self.entries = name, dict(entries)
        self.prefix, self.path = prefix or name, path
        self._fns = self._error = None

    def bind(self, lib):
        """Set the signatures of the entries of ``lib`` (a ``ctypes.CDLL``,
        or a stand-in with its attributes) and call them from now on."""
        fns = {k: getattr(lib, c) for k, (c, _) in self.entries.items()}
        for k, fn in fns.items():
            fn.restype, fn.argtypes = INT, list(self.entries[k][1])
        err = getattr(lib, f"{self.prefix}_error_string")
        err.restype, err.argtypes = ctypes.c_char_p, [INT]
        self._fns, self._error = fns, err
        return fns

    def fn(self, key):
        """The bound C entry of ``key``."""
        if self._fns is None:
            from .build import load

            self.bind(ctypes.CDLL(self.path) if self.path else load(self.name))
        return self._fns[key]

    def check(self, key, err):
        """Raise ``RuntimeError`` with the library's text of ``err`` unless
        it is 0."""
        if err:
            raise RuntimeError(f"{self.entries[key][0]} failed: "
                               f"{self._error(err).decode()}")

    def launch(self, key, t, *args):
        """Entry ``key`` on ``args`` and the current stream of tensor ``t``,
        under ``t``'s device guard (one guard, one stream read); raises as
        ``check``, so the caller counts a launch once this returns."""
        fn = self.fn(key)
        with torch.cuda.device(t.device):
            err = fn(*args, torch.cuda.current_stream(t.device).cuda_stream)
        if err:
            self.check(key, err)

    @contextlib.contextmanager
    def on(self, t):
        """``t``'s device guard, giving its current stream, for a caller
        that needs the stream before it launches: it passes the stream last
        to ``fn(key)`` and the return to ``check``."""
        with torch.cuda.device(t.device):
            yield torch.cuda.current_stream(t.device).cuda_stream

    def ints(self, key, device, n):
        """The ``n`` ints that entry ``key`` writes to the buffer it is
        given, under the device guard of ``device``."""
        fn, buf = self.fn(key), (INT * n)()
        with torch.cuda.device(device):
            err = fn(ctypes.addressof(buf))
        self.check(key, err)
        return list(buf)
