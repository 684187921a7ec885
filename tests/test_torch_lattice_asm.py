"""The lattice DIA table on the card: ``models/lattice_asm.py`` and its
kernel ``csrc/lattice_asm.cu``.

On the CPU: a plain PyTorch replay of the kernel's plan tables (its walk
over each row's cubes, tets, facet patches and diagonals, with the eager
path's own closed forms) gives ``assemble_vals_lattice``'s table bit for bit
(signed zeros aside) at nx 4-6 in float32 and float64, a level set with
vertices exactly 0 among them; the path rule (``lattice_asm.takes``) sends
the CPU, 2D, ``planes`` and inputs that require a gradient to the eager
path, which counts ``UnfittedPoisson::assemble_vals_lattice::eager`` once a
call and launches nothing.  The card cases (marked ``cuda``, skipped
without a card) hold the kernel to ``assemble_vals_lattice_plain`` on the
card bit for bit (signed zeros aside) at nx 6, 8 and 48, float32 and
float64, at three positions of the lattice cell's walk, with ``ncut`` equal,
the table exactly symmetric and repeated bit for bit (the check is
``chip_smoke.py``'s ``lattice_asm_check``, shared with its phase 34), and
one launch a call with no host sync.  This file imports no JAX, so the card
cases run where JAX is absent: ``python3 -c "import sys; sys.path.insert(0, 'tests'); import
test_torch_lattice_asm as t; t.test_kernel_equals_plain_on_the_card();
t.test_one_launch_no_sync_on_the_card()"`` from the repository's root.
"""
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ngsxfem_tpu_torch.models import lattice_asm
from ngsxfem_tpu_torch.models.poisson import (
    UnfittedPoisson, _soa_jacobian, cut_poisson_flat_soa,
    ghost_penalty_flat_soa)
from ngsxfem_tpu_torch.ops.straightcut import eps_guard_list
from ngsxfem_tpu_torch.utils import timing

KERNEL = "UnfittedPoisson::assemble_vals_lattice::kernel"
EAGER = "UnfittedPoisson::assemble_vals_lattice::eager"


def _walk_lset(model, t, dtype=None):
    """The level set |x - c(t)| - r of the lattice cell's walk, c(t) = 0.5 +
    0.08 (sin t, sin sqrt2 t, sin sqrt3 t), r = 0.4, computed in float64
    and rounded to the model's dtype."""
    c = torch.tensor([0.5 + 0.08 * math.sin(t),
                      0.5 + 0.08 * math.sin(math.sqrt(2) * t),
                      0.5 + 0.08 * math.sin(math.sqrt(3) * t)],
                     dtype=torch.float64, device=model.vertices.device)
    x = model.vertices.double()
    return (torch.linalg.vector_norm(x - c, dim=1) - 0.4).to(
        dtype or model.dtype)


def _zero_some(lset, model):
    """The level set with the vertex nearest to the sphere in each of a few
    lattice rows set exactly to 0 (``eps_guard`` snaps them to +eps)."""
    lset = lset.clone()
    nv1 = model.nx + 1
    for z in (1, nv1 // 2):
        row = slice(z * nv1 * nv1, (z + 1) * nv1 * nv1)
        lset[row][int(lset[row].abs().argmin())] = 0.0
    return lset


def _same(a, b):
    """The same bits, +0 and -0 taken as equal."""
    return a.dtype == b.dtype and torch.equal((a + 0.0).cpu(), (b + 0.0).cpu())


def _parse(tab):
    """The plan's sections, walked as the kernel walks them."""
    h = dict(zip(lattice_asm.HEADER, tab[:len(lattice_asm.HEADER)].tolist()))
    units, p = [], h["elem_start"]
    for _ in range(h["elem_units"]):
        dsp, nvis, nks = tuple(tab[p:p + 3]), tab[p + 3], tab[p + 4]
        ks = tab[p + 5:p + 5 + nks].tolist()
        vis = tab[p + 5 + nks:p + 5 + nks + 6 * nvis].reshape(nvis, 6)
        units.append((dsp, ks, vis.tolist()))
        p += 5 + nks + 6 * nvis
    S = h["n_types"]
    cd = tab[h["corner_start"]:h["corner_start"] + 12 * S].reshape(S, 4, 3)
    types, p = [], h["gp_start"]
    for _ in range(h["gp_types"]):
        ta, tb, nun = tab[p], tab[p + 1], tab[p + 5]
        dlt = tuple(tab[p + 2:p + 5])
        p += 6
        tunits = []
        for _ in range(nun):
            dsp, nterm = tuple(tab[p:p + 3]), tab[p + 3]
            terms = [(t & 15, (t >> 4) & 15, t >> 8)
                     for t in tab[p + 4:p + 4 + nterm].tolist()]
            tunits.append((dsp, terms))
            p += 4 + nterm
        types.append((ta, tb, dlt, tunits))
    assert p == len(tab)
    return h, units, cd, types


def _replay(model, vertices, lset, struct):
    """The kernel's walk over the plan in plain PyTorch, over all rows at
    once: the eager path's closed forms per element and facet patch, then
    per cube around a row (its units) the fold of the tets' entries per
    diagonal and its add into the row, per facet type and patch position
    the fold of the patch's terms per diagonal, times the band mask, and
    the identity rows.  Returns (V (n_off, n), ncut)."""
    h, units, cd, types = _parse(lattice_asm.plan_tables(model,
                                                         struct["offsets"]))
    nx, d = model.nx, 3
    nv1 = nx + 1
    vshape, cshape = (nv1,) * 3, (nx,) * 3
    vlat = vertices.reshape(vshape + (d,))
    llat = lset.reshape(vshape)
    S = h["n_types"]

    def sl(off, ext):
        return tuple(slice(o, o + e) for o, e in zip(off, ext))

    # the closed forms of every element, stacked (S, nc) as the eager path
    x = [[torch.stack([vlat[sl(cd[t, c], cshape) + (a,)].reshape(-1)
                       for t in range(S)]) for a in range(d)]
         for c in range(4)]
    raw = [torch.stack([llat[sl(cd[t, c], cshape)].reshape(-1)
                        for t in range(S)]) for c in range(4)]
    lv = eps_guard_list(raw)
    has_neg = (lv[0] < 0) | (lv[1] < 0) | (lv[2] < 0) | (lv[3] < 0)
    has_pos = (lv[0] > 0) | (lv[1] > 0) | (lv[2] > 0) | (lv[3] > 0)
    raw_neg = (raw[0] < 0) | (raw[1] < 0) | (raw[2] < 0) | (raw[3] < 0)
    det, Jinv = _soa_jacobian(x, d)
    A = cut_poisson_flat_soa("tet", lv, det, Jinv, model.lam_nitsche)

    acc = torch.zeros((h["n_off"],) + vshape, dtype=vertices.dtype)
    for dsp, ks, vis in units:
        s = torch.zeros_like(acc)
        rows = sl(dsp, cshape)      # row v = cube v - dsp
        for t, i, *kk in vis:
            for j, k in enumerate(kk):
                s[(k,) + rows] += A[i][j][t].reshape(cshape)
        for k in ks:
            acc[k] += s[k]
    cut = (has_neg & has_pos).reshape((S,) + cshape)
    neg = has_neg.reshape((S,) + cshape)
    for ta, tb, dlt, tunits in types:
        win = tuple(nx - a for a in dlt)
        x1 = [[vlat[sl(cd[ta, c], win) + (a,)] for a in range(d)]
              for c in range(4)]
        x2 = [[vlat[sl(cd[tb, c] + np.asarray(dlt), win) + (a,)]
               for a in range(d)] for c in range(4)]
        F = ghost_penalty_flat_soa("tet", x1, x2, model.gamma_gp)
        w0, wd = sl((0, 0, 0), win), sl(dlt, win)
        mask = ((cut[ta][w0] & neg[tb][wd])
                | (cut[tb][wd] & neg[ta][w0])).to(vertices.dtype)
        for dsp, terms in tunits:
            total = None
            for q, (i, j, k) in enumerate(terms):
                total = F[i][j] if total is None else total + F[i][j]
                if q + 1 == len(terms) or terms[q + 1][2] != k:
                    acc[(k,) + sl(dsp, win)] += total * mask
                    total = None
    act = torch.zeros(vshape, dtype=torch.bool)
    rn = raw_neg.reshape((S,) + cshape)
    for t in range(S):
        for c in range(4):
            act[sl(cd[t, c], cshape)] |= rn[t]
    acc[h["k0"]] += 1.0 - act.to(vertices.dtype)
    return acc.reshape(h["n_off"], -1), (has_neg & has_pos).sum()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nx", [4, 6])
def test_plan_replay_equals_eager(nx, dtype):
    """The replay of the plan gives ``assemble_vals_lattice``'s table on the
    CPU bit for bit (signed zeros aside) and its ``ncut``, at two positions
    of the walk, with level-set values exactly 0 at some vertices."""
    m = UnfittedPoisson(nx=nx, dim=3, order=1, dtype=dtype, device="cpu")
    st = m.dia_structure()
    for t in (0.0, 2.3):
        lset = _zero_some(_walk_lset(m, t), m)
        assert int((lset == 0).sum()) >= 2
        V, ncut = m.assemble_vals_lattice(m.vertices, lset, st)
        Vr, ncr = _replay(m, m.vertices, lset, st)
        assert _same(Vr, V), (nx, dtype, t)
        assert int(ncr) == int(ncut)


def test_plan_tables():
    """The plan of the nx=6 lattice: 27 diagonals, 8 cubes around a row
    holding 24 tet corners, 12 facet types, the 16 sign patterns, and every
    table entry inside the kernel's limits."""
    m = UnfittedPoisson(nx=6, dim=3, order=1, device="cpu")
    st = m.dia_structure()
    tab = lattice_asm.plan_tables(m, st["offsets"])
    assert tab.dtype == np.int32 and len(tab) * 4 <= 48 * 1024
    h, units, cd, types = _parse(tab)
    assert h["n_off"] == 27 and st["offsets"][h["k0"]] == 0
    assert len(units) == 8 and sum(len(v) for _, _, v in units) == 24
    assert [u[0] for u in units] == sorted(u[0] for u in units)
    assert len(types) == 12 and h["n_types"] == 6
    assert cd.min() >= 0 and cd.max() <= 1
    for _, _, _, tunits in types:
        for dsp, terms in tunits:
            ks = [k for _, _, k in terms]
            assert ks == sorted(ks) and max(ks) < 27 and min(dsp) >= 0
    # the plan is made once per model, offset set and device
    assert lattice_asm.plan(m, st["offsets"], "cpu") is lattice_asm.plan(
        m, list(st["offsets"]), torch.device("cpu"))


def test_path_rule(monkeypatch):
    """``takes``: only card tensors of the 3D lattice in one float dtype,
    without ``planes`` and without a gradient asked for.  The card is
    stood in for by patching ``lattice_asm.on_card`` (the predicate alone:
    nothing launches)."""
    m3 = UnfittedPoisson(nx=4, dim=3, order=1, device="cpu")
    m2 = UnfittedPoisson(nx=4, dim=2, order=1, device="cpu")
    v, l = m3.vertices, m3.lset
    assert not lattice_asm.takes(m3, v, l)          # CPU tensors
    monkeypatch.setattr(lattice_asm, "on_card", lambda t: True)
    assert lattice_asm.takes(m3, v, l)
    assert not lattice_asm.takes(m3, v, l, planes=(0, 3))
    assert not lattice_asm.takes(m2, m2.vertices, m2.lset)
    assert not lattice_asm.takes(m3, v, l.double())
    assert not lattice_asm.takes(m3, v.half(), l.half())
    assert not lattice_asm.takes(m3, v[:-1], l[:-1])
    g = l.clone().requires_grad_(True)
    assert not lattice_asm.takes(m3, v, g)
    with torch.no_grad():
        assert lattice_asm.takes(m3, v, g)


def _eager_cases():
    m3 = UnfittedPoisson(nx=4, dim=3, order=1, device="cpu")
    m2 = UnfittedPoisson(nx=4, dim=2, order=1, device="cpu")
    s3, s2 = m3.dia_structure(), m2.dia_structure()
    nv1 = 5
    box = slice(0, 3 * nv1 * nv1)
    return {
        "cpu": lambda: m3.assemble_vals_lattice(m3.vertices, m3.lset, s3),
        "2d": lambda: m2.assemble_vals_lattice(m2.vertices, m2.lset, s2),
        "planes": lambda: m3.assemble_vals_lattice(
            m3.vertices[box], m3.lset[box], s3, planes=(0, 3)),
        "gradient": lambda: m3.assemble_vals_lattice(
            m3.vertices, m3.lset.clone().requires_grad_(True), s3),
    }


@pytest.mark.parametrize("case", ["cpu", "2d", "planes", "gradient"])
def test_eager_path_counts_eager(case):
    """The CPU, 2D, ``planes`` and a level set that requires a gradient run
    the eager path: one ``::eager`` a call in the ``assemble_vals_lattice``
    span, no ``::kernel``, no launch; the gradient case keeps its graph."""
    call = _eager_cases()[case]
    before = lattice_asm.launches
    timing.reset_trace()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            V, _ = call()
            call()
        totals, recs = timing.counters(), timing.spans()
    finally:
        timing.reset_trace()
    assert totals == {EAGER: 2}
    top = [r for r in recs
           if r["name"] == "UnfittedPoisson::assemble_vals_lattice"]
    assert [r["counters"] for r in top] == [{EAGER: 1}, {EAGER: 1}]
    assert lattice_asm.launches == before
    assert V.requires_grad == (case == "gradient")


def _card_models(nx):
    return {dt: UnfittedPoisson(nx=nx, dim=3, order=1, dtype=dt,
                                device="cuda")
            for dt in (torch.float32, torch.float64)}


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_card():
    """On the card the kernel gives ``assemble_vals_lattice_plain``'s table
    bit for bit (signed zeros aside) and its ``ncut`` at nx 6, 8 and 48,
    float32 and float64, at three positions of the lattice cell's walk
    (one with level-set values exactly 0); the table is exactly symmetric
    and a second call repeats it bit for bit (``chip_smoke.py``'s
    ``lattice_asm_check``, which its phase 34 runs too); one launch a call,
    counted ``::kernel``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from chip_smoke import lattice_asm_check

    for nx in (6, 8, 48):
        for dtype, m in _card_models(nx).items():
            st = m.dia_structure()
            lattice_asm.plan(m, st["offsets"], m.vertices.device)  # once
            for t in (0.0, 0.7, 4.1):
                lset = _walk_lset(m, t)
                if t == 0.7:
                    lset = _zero_some(lset, m)
                timing.reset_trace()
                try:
                    with profile(activities=[ProfilerActivity.CPU]):
                        m.assemble_vals_lattice(m.vertices, lset, st)
                    totals = timing.counters()
                finally:
                    timing.reset_trace()
                assert totals == {KERNEL: 1}, totals
                lattice_asm_check(m, st, lset, f"nx={nx} {dtype} t={t}")


@pytest.mark.cuda
def test_one_launch_no_sync_on_the_card():
    """Calls with their plan made launch the kernel once each
    (``lattice_asm.launches``) and synchronise nothing
    (``set_sync_debug_mode("error")``), in float32 and float64 at nx=48.
    The device ops of a call (the kernel and the fill of ``ncut``) are
    profiled in ``chip_smoke.py``'s phase 34."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    calls = 3
    for dtype, m in _card_models(48).items():
        st = m.dia_structure()
        lset = _walk_lset(m, 1.9)
        m.assemble_vals_lattice(m.vertices, lset, st)   # the plan, once
        torch.cuda.synchronize()
        before = lattice_asm.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(calls):
                V, ncut = m.assemble_vals_lattice(m.vertices, lset, st)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert lattice_asm.launches == before + calls
        assert V.shape == (27, 49 ** 3) and ncut.dtype == torch.int64
        assert V.is_cuda and ncut.is_cuda
