"""The launcher of the port's CUDA kernels (``kernels/launch.py``) and the
five bindings that call it, on the CPU.

No card and no ``nvcc``: each binding's ``Library`` is bound to a stand-in
library object whose entries record their arguments and return the code a
case asks for, and ``torch.cuda``'s device guard and current stream are
stood in for.  For each of ``ell_spmv``, ``dia_spmv``, ``coo_ell``,
``dia_cg`` and ``lattice_asm``: its entries' C names and argument types equal ``SIGNATURES``
(the C interfaces, each found in ``csrc/<name>.cu`` with as many
parameters); a launch through the module's own path enters the guard of
its tensor's device once, reads the stream once and passes it last, and
adds one to the module's ``launches``; a nonzero return raises
``RuntimeError`` carrying the library's own error text and leaves
``launches`` where it was.  The two queries (``ell_spmv.kernel_info``,
``dia_cg.device_info``) read their buffer under the guard and raise the
same way.
"""
import contextlib
import ctypes
import os
import re
from types import SimpleNamespace

import pytest
import torch

from ngsxfem_tpu_torch.kernels import build
from ngsxfem_tpu_torch.kernels.launch import Library
from ngsxfem_tpu_torch.models import lattice_asm
from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson
from ngsxfem_tpu_torch.solvers import coo_ell, dia_cg, dia_spmv, ell_spmv

P, I, U, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
D = ctypes.c_double
STREAM = 0x5EED

# binding -> (error-text entry, {C entry: argument types})
SIGNATURES = {
    "ell_spmv": ("ell_spmv_error_string", {
        "sell_spmv_f32": [P] * 7 + [I, L, P],
        "sell_spmv_f64": [P] * 7 + [I, L, P],
        "sell_spmv_kernel_info": [P]}),
    "dia_spmv": ("dia_spmv_error_string", {
        "dia_spmv_f32": [P, P, P, L, dia_spmv._Offsets, P],
        "dia_spmv_f64": [P, P, P, L, dia_spmv._Offsets, P]}),
    "coo_ell": ("coo_ell_error_string", {
        "coo_ell_place_f32": [P] * 8 + [L, L, I, P],
        "coo_ell_place_f64": [P] * 8 + [L, L, I, P]}),
    "dia_cg": ("dia_cg_f32_error_string", {
        "dia_cg_f32": [P, I, I, P, P, P] + [I] * 7
                      + [P, P, I, P, P, P, U, P, P],
        "dia_cg_f32_exchange_words": [],
        "dia_cg_f32_device_info": [P]}),
    "lattice_asm": ("lattice_asm_error_string", {
        "lattice_asm_f32": [P] * 5 + [I, I, D, D, D, P],
        "lattice_asm_f64": [P] * 5 + [I, I, D, D, D, P]}),
}
MODULES = {"ell_spmv": ell_spmv, "dia_spmv": dia_spmv, "coo_ell": coo_ell,
           "dia_cg": dia_cg, "lattice_asm": lattice_asm}
# what dia_cg_f32_device_info writes: an H100's SMs and shared memory
DEVICE_INFO = [132, 232448, 1, 1024, 40, 0, 0]


class _StandIn:
    """A compiled library's stand-in: every attribute is an entry that
    records its name and arguments and returns ``codes[name]`` (0 by
    default; a callable is called with the arguments)."""

    def __init__(self, codes):
        self.calls, self.codes = [], codes

    def __getattr__(self, name):
        if name.endswith("_error_string"):
            def entry(code):
                return f"stand-in error {code} of {name}".encode()
        else:
            def entry(*args):
                self.calls.append((name, args))
                code = self.codes.get(name, 0)
                return code(*args) if callable(code) else code
        entry.restype = entry.argtypes = None
        setattr(self, name, entry)
        return entry


def _write_ints(values):
    def write(addr):
        (I * len(values)).from_address(addr)[:] = values
        return 0
    return write


@pytest.fixture
def card(monkeypatch):
    """``torch.cuda``'s guard and stream stood in for; returns the log of
    the guards entered and the streams read."""
    log = SimpleNamespace(guards=[], streams=0)

    def device(d):
        log.guards.append(d)
        return contextlib.nullcontext()

    def current_stream(d=None):
        log.streams += 1
        return SimpleNamespace(cuda_stream=STREAM)

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return log


def _stand_in(name, monkeypatch, codes):
    """The module's ``Library`` bound to a stand-in, put in its place."""
    mod, real = MODULES[name], MODULES[name].LIB
    lib = Library(real.name, real.entries, prefix=real.prefix)
    fake = _StandIn(codes)
    lib.bind(fake)
    monkeypatch.setattr(mod, "LIB", lib)
    monkeypatch.setattr(mod, "on_card", lambda t: True)
    return fake


def _launch(name):
    """One call of the module's own path on small CPU tensors; returns
    (the C entry that launches, the tensor whose device and stream it
    takes)."""
    if name == "ell_spmv":
        vals = torch.tensor([[2.0, 1.0], [3.0, 0.0]], dtype=torch.float64)
        cols = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)
        x = torch.ones(2, dtype=torch.float64)
        ell_spmv.ell_matvec(vals, cols, x)
        return "sell_spmv_f64", x
    if name == "dia_spmv":
        vals = torch.ones((3, 5), dtype=torch.float32)
        x = torch.ones(5, dtype=torch.float32)
        dia_spmv.dia_matvec([-1, 0, 1], vals, x)
        return "dia_spmv_f32", x
    if name == "coo_ell":
        vals = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float32)
        coo_ell.coo_to_ell(torch.tensor([0, 1, 0]), torch.tensor([1, 0, 1]),
                           vals, (2, 2))
        return "coo_ell_place_f32", vals
    if name == "lattice_asm":
        m = UnfittedPoisson(nx=2, dim=3, order=1, device="cpu")
        m.assemble_vals_lattice(m.vertices, m.lset, m.dia_structure())
        return "lattice_asm_f32", m.vertices
    V = torch.zeros((3, 8), dtype=torch.float32)
    V[1] = 2.0
    b = torch.ones(8, dtype=torch.float32)
    dia_cg.dia_cg_fused([-1, 0, 1], V, b,
                        torch.full((8,), 0.5, dtype=torch.float32), 4)
    return "dia_cg_f32", b


@pytest.mark.parametrize("name", sorted(MODULES))
def test_binding_launches_through_the_launcher(name, card, monkeypatch):
    error, entries = SIGNATURES[name]
    with open(os.path.join(build.CSRC, f"{name}.cu")) as f:
        src = f.read()
    assert re.search(rf"const char\*\s+{error}\(int code\)", src)
    for cname, types in entries.items():
        m = re.search(rf"\bint\s+{cname}\(([^)]*)\)", src)
        assert m, cname
        params = [p for p in m.group(1).split(",") if p.strip() != "void"]
        assert len(params) == len(types), cname
    if name == "dia_cg":
        for cache in ("_INFO", "_XCH", "_LAUNCH"):
            monkeypatch.setattr(dia_cg, cache, {})
    codes = {"dia_cg_f32_device_info": _write_ints(DEVICE_INFO),
             "dia_cg_f32_exchange_words": 4}
    fake = _stand_in(name, monkeypatch, codes)
    if name == "dia_cg":  # the plan's query first, under its own guard
        dia_cg.cuda_plan([-1, 0, 1], 8, torch.device("cpu"))
    bound = {n: e.argtypes for n, e in vars(fake).items()
             if n not in ("calls", "codes") and e.argtypes is not None}
    assert bound == dict(entries, **{error: [I]})
    assert all(getattr(fake, n).restype is I for n in entries)
    assert getattr(fake, error).restype is ctypes.c_char_p
    mod = MODULES[name]

    before = mod.launches
    card.guards.clear()
    card.streams = 0
    cname, t = _launch(name)
    launched = [args for n, args in fake.calls if n == cname]
    assert len(launched) == 1 and launched[0][-1] == STREAM
    assert len(launched[0]) == len(entries[cname])
    assert card.guards == [t.device] and card.streams == 1
    assert mod.launches == before + 1

    fake.codes[cname] = 719
    with pytest.raises(RuntimeError,
                       match=f"{cname} failed: stand-in error 719 of {error}"):
        _launch(name)
    assert mod.launches == before + 1


@pytest.mark.parametrize("name,entry,n", [
    ("ell_spmv", "sell_spmv_kernel_info", 6),
    ("dia_cg", "dia_cg_f32_device_info", 7)])
def test_queries_read_their_buffer_under_the_guard(name, entry, n, card,
                                                    monkeypatch):
    values = list(range(10, 10 + n))
    fake = _stand_in(name, monkeypatch, {entry: _write_ints(values)})
    if name == "dia_cg":
        monkeypatch.setattr(dia_cg, "_INFO", {})
        info = dia_cg.device_info("cuda:3")
        assert list(info.values()) == values and card.guards == [3]
    else:
        info = ell_spmv.kernel_info("cuda:3")
        assert info == {"float32": (10, 11, 12), "float64": (13, 14, 15)}
        assert card.guards == ["cuda:3"]
    assert card.streams == 0
    fake.codes[entry] = 2
    monkeypatch.setattr(dia_cg, "_INFO", {})
    with pytest.raises(RuntimeError,
                       match=f"{entry} failed: stand-in error 2"):
        (dia_cg.device_info("cuda:1") if name == "dia_cg"
         else ell_spmv.kernel_info("cuda:1"))
