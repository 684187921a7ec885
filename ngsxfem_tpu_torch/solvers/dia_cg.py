"""Fused fixed-budget Jacobi-PCG on the symmetric offset-diagonal operator.

Counterpart of ``ngsxfem_tpu/solvers/pallas_cg.py``.  On a card
(``on_card``), ``dia_cg_fused`` runs the whole loop as one persistent
cooperative kernel, ``csrc/dia_cg.cu`` (see the note at the top of that file
for its design and what bounds it), launched with the plan of ``_plan``;
elsewhere it runs ``dia_cg_fused_plain``, the same algorithm in PyTorch.
There is no fallback between the two: a CUDA tensor reaches the kernel or
the call raises.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..config import as_input
from ..kernels.launch import INT, PTR, U32, Library, on_card
from .krylov import _vdot

# calls of `dia_cg_fused` that went to the CUDA kernel (one device kernel per
# call); read and reset by chip_smoke.py
launches = 0

MAX_TERMS = 32  # offsets the kernel takes (csrc/dia_cg.cu kMaxTerms)
THREADS = 1024  # threads per block (csrc/dia_cg.cu kThreads)

LIB = Library("dia_cg", {
    "dia_cg_f32": ("dia_cg_f32", (PTR, INT, INT, PTR, PTR, PTR) + (INT,) * 7
                   + (PTR, PTR, INT, PTR, PTR, PTR, U32, PTR, PTR)),
    "exchange_words": ("dia_cg_f32_exchange_words", ()),
    "device_info": ("dia_cg_f32_device_info", (PTR,))}, prefix="dia_cg_f32")
_INFO = {}  # device index -> dia_cg_f32_device_info
_XCH = {}   # (device index, stream) -> [exchange words, next tag]
_LAUNCH = {}  # (device index, offsets, n) -> (plan, rows, offs, slots)


def _key(offsets):
    """The offset set as a tuple of ints (the key of the host caches)."""
    return tuple(int(o) for o in np.asarray(offsets).tolist())


def _upper(offsets):
    """Host split of a symmetric offset set into (main-diag idx, [(idx, o>0)])."""
    offs = list(_key(offsets))
    if sorted(offs) != sorted(-o for o in offs):
        raise ValueError("DIA offset set is not symmetric; fused CG "
                         "requires a symmetric operator")
    k0 = offs.index(0)
    pos = [(k, o) for k, o in enumerate(offs) if o > 0]
    return k0, pos


@functools.lru_cache(maxsize=None)
def _terms_of(offs):
    k0, pos = _upper(offs)
    row = {o: k for k, o in pos}
    row[0] = k0
    return tuple((row[abs(o)], o) for o in offs)


def _terms(offsets):
    """The offsets in table order, each with the table row it reads: the
    main diagonal for 0, the positive-offset diagonal of |o| otherwise (a
    negative offset is applied as the transpose of its mirror)."""
    return list(_terms_of(_key(offsets)))


def _sym_dia_matvec(vals, terms, p):
    """y = A p with A symmetric, read from its main and upper diagonals only:
    A[i, i+o] = d_|o|[min(i, i+o)].  Terms are summed in table order, the
    order of `sparse.dia_matvec`, so on an exactly symmetric table the two
    agree bit for bit."""
    n = p.shape[0]
    y = torch.zeros_like(p)
    for k, o in terms:
        m = abs(o)
        if m >= n:
            continue
        d = vals[k]
        # in place on views of the fresh y
        if o > 0:
            y[:n - m] += d[:n - m] * p[m:]
        elif o < 0:
            y[m:] += d[:n - m] * p[:n - m]
        else:
            y += d * p
    return y


def dia_cg_fused_plain(offsets, vals, b, dinv, iters):
    """The kernel's algorithm in PyTorch: fixed-budget Jacobi-PCG, x0 = 0,
    on the upper-diagonal symmetric matvec, with the same alpha/beta guards
    and the same f64-accumulated dot products (`krylov._vdot`).  Returns
    (x, ||r||)."""
    terms = _terms(offsets)
    x = torch.zeros_like(b)
    r = b
    z = dinv * r
    p = z
    rz = _vdot(r, z)
    for _ in range(iters):
        Ap = _sym_dia_matvec(vals, terms, p)
        den = _vdot(p, Ap)
        alpha = rz / torch.where(den == 0, 1.0, den)
        x = x + alpha * p
        r = r - alpha * Ap
        z = dinv * r
        rz_new = _vdot(r, z)
        beta = rz_new / torch.where(rz == 0, 1.0, rz)
        p = z + beta * p
        rz = rz_new
    return x, torch.sqrt(_vdot(r, r))


@dataclass(frozen=True)
class Plan:
    """Launch plan of the cooperative kernel (see ``_plan``)."""

    grid: int         # blocks, all co-resident, at most one per SM
    threads: int      # threads per block
    chunk: int        # rows per block: block j owns [j chunk, (j+1) chunk)
    halo: int         # the staged p window reaches this far beyond the rows
    win: int          # floats of shared memory for the window (0: none)
    stage_vec: bool   # x, r, dinv and Ap of the block's rows staged
    slots: tuple      # per term: its shared-memory coefficient slot or -1
    smem: int         # dynamic shared memory per block, bytes
    o_max: int        # largest |offset|
    barriers_per_iter: int = 2  # grid-wide exchanges, csrc/dia_cg.cu

    @property
    def staged_terms(self):
        return sum(1 for sl in self.slots if sl >= 0)

    @property
    def full(self):
        """Every coefficient and the whole halo staged: the kernel instance
        without bounds checks (csrc/dia_cg.cu decides the same way)."""
        return (self.win > 0 and self.staged_terms == len(self.slots)
                and self.halo >= self.o_max)

    def rows(self, j, n):
        """Rows [start, end) of block j."""
        return j * self.chunk, min(n, (j + 1) * self.chunk)

    def window(self, j, n):
        """Staged p window [lo, hi) of block j (empty when none is)."""
        if not self.win:
            return 0, 0
        s, e = self.rows(j, n)
        return max(0, s - self.halo), min(n, e + self.halo)

    def describe(self):
        return (f"grid {self.grid} x {self.threads} threads, {self.chunk} rows "
                f"per block, {self.smem} B dynamic shared memory: "
                f"{self.staged_terms}/{len(self.slots)} coefficient slices, "
                f"p window halo {self.halo}/{self.o_max}"
                f"{'' if self.win else ' (no window)'}, x/r/dinv/Ap "
                f"{'staged' if self.stage_vec else 'in global memory'}"
                f"{' (all staged)' if self.full else ''}; "
                f"{self.barriers_per_iter} grid barriers per iteration")


def _plan(n, offsets, sm_count, smem_bytes, threads=THREADS):
    """Launch plan for n rows, the offset set, `sm_count` SMs and
    `smem_bytes` of dynamic shared memory per block.

    One block per SM at most, and no more blocks than rows / threads, so that
    a block's threads each own about one row and a grid barrier waits on as
    few blocks as will do.  Rows are cut into equal contiguous chunks.  Shared
    memory goes, in this order, to the p window (the block's rows, then a
    halo of up to the largest offset on each side: a column outside it costs
    two L2 reads per term), to the block's x, r, dinv and Ap, and to the
    coefficient slices of the terms in table order (one slice costs one L2
    read per row and term when left out).  What does not fit is read from
    global memory by the same kernel.
    """
    n = int(n)
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    terms = _terms(offsets)
    if len(terms) > MAX_TERMS:
        raise ValueError(f"{len(terms)} offsets; the kernel takes at most "
                         f"{MAX_TERMS}")
    o_max = max(abs(o) for _, o in terms)
    grid = max(1, min(int(sm_count), -(-n // threads)))
    chunk = -(-n // grid)
    grid = -(-n // chunk)
    budget = int(smem_bytes) // 4
    halo = win = 0
    if chunk <= budget:
        halo = min(o_max, n, (budget - chunk) // 2)
        win = chunk + 2 * halo
        budget -= win
    stage_vec = 4 * chunk <= budget
    if stage_vec:
        budget -= 4 * chunk
    n_slots = min(len(terms), budget // chunk)
    slots = tuple(q if q < n_slots else -1 for q in range(len(terms)))
    smem = 4 * ((4 * chunk if stage_vec else 0) + n_slots * chunk + win)
    return Plan(grid, threads, chunk, halo, win, stage_vec, slots, smem, o_max)


def device_info(device):
    """The kernel's view of a CUDA device: SMs, dynamic shared memory per
    block, cooperative launch, and the kernel's max threads per block,
    registers, static shared memory and local memory (spills) per thread."""
    device = torch.device(device)
    idx = torch.cuda.current_device() if device.index is None else device.index
    if idx not in _INFO:
        _INFO[idx] = dict(zip(("sm_count", "smem_bytes", "cooperative",
                               "max_threads", "registers", "static_smem",
                               "local_bytes"),
                              LIB.ints("device_info", idx, 7)))
    return _INFO[idx]


def cuda_plan(offsets, n, device):
    """The plan ``dia_cg_fused`` launches for n rows on a CUDA device."""
    info = device_info(device)
    return _plan(n, offsets, info["sm_count"], info["smem_bytes"],
                 min(THREADS, info["max_threads"]))


def _dia_cg_cuda(offsets, terms, vals, b, dinv, iters, lib=None):
    """Launch the kernel (or `lib`, a ``Library`` of another build of the
    same source)."""
    global launches
    lib = lib or LIB
    n = b.shape[0]
    key = (b.device.index, _key(offsets), n)
    if key not in _LAUNCH:
        plan = cuda_plan(offsets, n, b.device)
        _LAUNCH[key] = (
            plan, np.ascontiguousarray([k for k, _ in terms], dtype=np.int32),
            np.ascontiguousarray([o for _, o in terms], dtype=np.int32),
            np.ascontiguousarray(plan.slots, dtype=np.int32))
    plan, rows, offs, slots = _LAUNCH[key]
    x = torch.empty_like(b)
    work = torch.empty((5, n), dtype=b.dtype, device=b.device)
    res = torch.empty((), dtype=b.dtype, device=b.device)
    with lib.on(b) as stream:
        xch = _XCH.get((b.device.index, stream))
        if xch is None:
            words = torch.zeros(lib.fn("exchange_words")(),
                                dtype=torch.int64, device=b.device)
            xch = _XCH[(b.device.index, stream)] = [words, 1]
        # each call's exchanges carry tags above the previous call's on this
        # buffer; before the 32-bit tags would wrap, the buffer is re-zeroed
        tag0 = xch[1]
        if tag0 + 2 * iters >= 2**32:
            xch[0].zero_()
            tag0 = 1
        xch[1] = tag0 + 2 * iters + 1
        err = lib.fn("dia_cg_f32")(
            vals.data_ptr(), n, len(terms), rows.ctypes.data, offs.ctypes.data,
            slots.ctypes.data, plan.grid, plan.threads, plan.chunk, plan.halo,
            plan.win, int(plan.stage_vec), plan.staged_terms,
            b.data_ptr(), dinv.data_ptr(), iters, x.data_ptr(), work.data_ptr(),
            xch[0].data_ptr(), tag0, res.data_ptr(), stream)
    lib.check("dia_cg_f32", err)
    launches += 1
    return x, res


def dia_cg_fused(offsets, vals, b, dinv, iters, plane=None):
    """Fixed-budget Jacobi-PCG with x0 = 0 on a symmetric DIA operator.

    offsets : host ints, the symmetric DIA offset set (from
        ``UnfittedPoisson.dia_structure()["offsets"]``)
    vals    : (n_off, n) diagonal table, exactly symmetric; only the main
        and the positive-offset diagonals are read
    b       : (n,) rhs; dinv : (n,) Jacobi inverse diagonal
    iters   : iteration count (matches ``krylov.cg(tol=0)``)
    plane   : optional, the reference's vertex-lattice plane size L; it
        must divide n (else ``ValueError``, as in the reference) and is
        otherwise unused: the kernel indexes flat

    Returns (x (n,), res_norm 0-d tensor), the contract of the reference
    ``pallas_cg.dia_cg_fused`` up to reduction-order roundoff.  ``vals``,
    ``b`` and ``dinv`` may be numpy: they become tensors on the device and
    in the dtype of the tensors among them, else on the current card in
    numpy's dtype.  Tensors on a card must be float32 (the kernel's type)
    and go to the kernel; others run ``dia_cg_fused_plain`` in their own
    floating dtype.  It has no backward, as the reference's has none:
    with grad mode on, an input that requires a gradient raises
    ``RuntimeError`` (``krylov.cg`` on ``dia_matvec`` is the differentiable
    fixed-budget PCG).
    """
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in (vals, b, dinv)):
        raise RuntimeError(
            "dia_cg_fused has no backward (nor has the reference's Pallas "
            "kernel): differentiate krylov.cg on dia_matvec instead")
    vals = as_input(vals, next((t for t in (b, dinv) if torch.is_tensor(t)),
                               None))
    b, dinv = as_input(b, vals), as_input(dinv, vals)
    terms = _terms(offsets)
    n_off = len(terms)
    if vals.dim() != 2 or vals.shape[0] != n_off:
        raise ValueError(f"vals must be ({n_off}, n), got {tuple(vals.shape)}")
    n = vals.shape[1]
    if plane is not None and (int(plane) <= 0 or n % int(plane)):
        raise ValueError(f"plane size {plane} does not divide n={n}")
    for name, t in (("b", b), ("dinv", dinv)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(t.shape)}")
    for name, t in (("vals", vals), ("b", b), ("dinv", dinv)):
        if t.device != b.device:
            raise ValueError(f"{name} is on {t.device}, b on {b.device}")
        if t.dtype != vals.dtype or not t.dtype.is_floating_point:
            raise ValueError(f"{name} has dtype {t.dtype}; all inputs must "
                             f"share one floating dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    iters = int(iters)
    if iters < 0:
        raise ValueError("iters must be >= 0")
    if not on_card(b):
        return dia_cg_fused_plain(offsets, vals, b, dinv, iters)
    if vals.dtype != torch.float32:
        raise ValueError(f"the CUDA kernel takes float32, got {vals.dtype}")
    return _dia_cg_cuda(offsets, terms, vals, b, dinv, iters)
