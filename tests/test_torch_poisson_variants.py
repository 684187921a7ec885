"""The other assembly routes of the flagship model (``UnfittedPoisson``'s
compact two-tier, gather, SoA and stencil assemblies) against the JAX
package at nx <= 8, in float64 (each JAX call runs once: eagerly
(``jax.disable_jit``) where that is quicker, jitted where the reference runs
its cut kernel on every element, 19-25 s eagerly against 2-3 s with its
compile at these sizes), with the tolerances of tests/test_model_poisson.py and
tests/test_model_review.py: ``apply_compact`` within 1e-12 of ``apply``,
the gather table equal and its assembly within 1e-13 of the scatter one,
the SoA assembly within 1e-12 relative of the AoS one, the stencil assembly
within 1e-13 of the one-pass SoA and of the lattice assemblies; the
capacity overflow and the moved band poison with NaN.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from ngsxfem_tpu.models import poisson as jp
from ngsxfem_tpu_torch.models import poisson as tp

CPU = torch.device("cpu")


def _models(dim, nx, order=1):
    mj = jp.UnfittedPoisson(nx=nx, dim=dim, order=order, dtype=jnp.float64)
    mt = tp.UnfittedPoisson(nx=nx, dim=dim, order=order, dtype=torch.float64,
                            device=CPU)
    return mj, mt


def _ncut(m):
    vals = m.lset_np[m.mesh.elements_np]
    return int(((vals < 0).any(1) & (vals > 0).any(1)).sum())


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _maxdiff(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


def test_affine_stiffness_tensor_matches():
    """``_affine_stiffness_S`` (host float64) equals the JAX package's."""
    for et in ("trig", "tet"):
        for order in (1, 2, 3):
            assert np.array_equal(tp._affine_stiffness_S(et, order),
                                  jp._affine_stiffness_S(et, order))


@pytest.mark.parametrize("dim,nx", [(2, 8), (3, 5)])
def test_elmats_compact_and_apply_compact(dim, nx):
    """The compact tiers (standard stiffness, fixed-capacity cut tier)
    equal the JAX package's; ``apply_compact`` is the port's and the JAX
    package's ``apply`` to 1e-12
    (tests/test_model_poisson.py::test_compact_equals_full); blocks of 7
    elements change nothing."""
    mj, mt = _models(dim, nx)
    cap = _ncut(mj) + 5
    x = np.random.default_rng(0).standard_normal(mj.ndof)
    Aj = jax.jit(lambda v, l: mj.elmats_compact(v, l, mj.elements, cap))(
        mj.vertices, mj.lset)
    # the reference's apply_compact indexes a host table with its traced
    # cut ids (no jit) and takes ~20 s eagerly: its own test holds it to
    # 1e-12 of `apply`, the reference the port's is held to here
    yj = jax.jit(mj.apply)(mj.vertices, mj.lset, jnp.asarray(x))
    with jax.disable_jit():
        lj = mj.lset_elem_vals(mj.lset)
    At = mt.elmats_compact(mt.vertices, mt.lset, mt.elements, cap)
    for a, b in zip(Aj[:2], At[:2]):
        assert _maxdiff(a, b) < 1e-12
    assert np.array_equal(_np(Aj[2]), _np(At[2])) and int(Aj[3]) == int(At[3])
    Ab = mt.elmats_compact(mt.vertices, mt.lset, mt.elements, cap, block=7)
    assert all(torch.equal(a, b) for a, b in zip(At, Ab))
    yt = mt.apply_compact(mt.vertices, mt.lset, torch.as_tensor(x), cap)
    assert _maxdiff(yt, yj) < 1e-12
    assert _maxdiff(yt, mt.apply(mt.vertices, mt.lset, torch.as_tensor(x))) \
        < 1e-12
    assert np.array_equal(_np(lj), _np(mt.lset_elem_vals(mt.lset)))


def test_apply_compact_poisons():
    """tests/test_model_review.py: a cut capacity of 1 overflows, and a
    moved ghost-penalty band poisons the product with NaN."""
    mt = tp.UnfittedPoisson(nx=6, dim=2, order=1, dtype=torch.float64,
                            device=CPU)
    moved = tp.UnfittedPoisson(nx=6, dim=2, order=1, dtype=torch.float64,
                               radius=0.3, device=CPU)
    x = torch.ones(mt.ndof, dtype=torch.float64)
    assert torch.isnan(mt.apply_compact(mt.vertices, mt.lset, x, 1)).any()
    cap = _ncut(moved) + _ncut(mt)
    assert torch.isnan(mt.apply_compact(mt.vertices, moved.lset, x,
                                        cap)).any()
    assert not torch.isnan(mt.apply_compact(mt.vertices, mt.lset, x,
                                            cap)).any()


def test_gather_assembly_matches_scatter():
    """``ell_gather_structure`` equals the JAX package's table, and the
    gather assembly is the scatter one's (``assemble_ell_vals``) and the
    JAX package's to 1e-13 (tests/test_model_poisson.py)."""
    mj, mt = _models(3, 6)
    cap = int(_ncut(mj) * 1.2) + 8
    sj, st = mj.ell_structure(), mt.ell_structure()
    gj, gt = mj.ell_gather_structure(sj), mt.ell_gather_structure(st)
    assert np.array_equal(gj, gt)
    a1j, _ = jax.jit(lambda v, l: mj.assemble_ell_vals(v, l, cap, sj))(
        mj.vertices, mj.lset)
    a1, n1 = mt.assemble_ell_vals(mt.vertices, mt.lset, cap, st)
    a2, n2 = mt.assemble_ell_vals_gather(mt.vertices, mt.lset, cap, st, gt)
    assert int(n1) == int(n2) == _ncut(mj)
    assert _maxdiff(a1, a2) < 1e-13 and _maxdiff(a1, a1j) < 1e-13


@pytest.mark.parametrize("dim,order,nx", [(2, 1, 8), (3, 1, 5), (2, 2, 6),
                                          (3, 2, 4)])
def test_soa_assembly_matches_aos(dim, order, nx):
    """``assemble_ell_vals_soa`` (the standard tier through the constant
    stiffness tensor) is the AoS ``assemble_ell_vals`` to 1e-12 relative,
    as in the JAX package, and its ELL table is the JAX package's to
    1e-12 relative."""
    mj, mt = _models(dim, nx, order)
    cap = _ncut(mj) + 4
    sj, st = mj.ell_structure(), mt.ell_structure()
    with jax.disable_jit():
        aj, _ = mj.assemble_ell_vals_soa(mj.vertices, mj.lset, cap, sj)
    a1, _ = mt.assemble_ell_vals(mt.vertices, mt.lset, cap, st)
    a2, n2 = mt.assemble_ell_vals_soa(mt.vertices, mt.lset, cap, st)
    big = float(a1.abs().max())
    assert _maxdiff(a1, a2) < 1e-12 * big
    assert _maxdiff(a2, aj) < 1e-12 * big and int(n2) == _ncut(mj)


@pytest.mark.parametrize("dim,nx", [(2, 8), (3, 6)])
def test_stencil_assembly_matches(dim, nx):
    """``assemble_vals_stencil`` (windowed lattice adds) is the one-pass SoA
    and the lattice assembly's DIA table to 1e-13, and the JAX package's;
    ``gp_flat_soa`` is the JAX package's stream; the DIA table of
    ``assemble_ell_vals_soa`` on the DIA structure agrees too."""
    mj, mt = _models(dim, nx)
    dj, dt = mj.dia_structure(), mt.dia_structure()
    with jax.disable_jit():
        sj, nj = mj.assemble_vals_stencil(mj.vertices, mj.lset, dj)
        gj = mj.gp_flat_soa(mj.vertices)
    s, n1 = mt.assemble_vals_stencil(mt.vertices, mt.lset, dt)
    a, _ = mt.assemble_vals_soa1(mt.vertices, mt.lset, dt)
    b, n2 = mt.assemble_vals_lattice(mt.vertices, mt.lset, dt)
    assert int(n1) == int(n2) == int(nj)
    assert _maxdiff(s, a) < 1e-13 and _maxdiff(s, b) < 1e-13
    assert _maxdiff(s, sj) < 1e-13
    assert _maxdiff(mt.gp_flat_soa(mt.vertices), gj) < 1e-13
    d, _ = mt.assemble_ell_vals_soa(mt.vertices, mt.lset, _ncut(mj) + 4, dt)
    assert _maxdiff(d, a) < 1e-12 * float(a.abs().max())


def test_lattice_box_rows_bitwise():
    """``assemble_vals_lattice(planes=(p0, p1))``: the rows of the planes
    two inside the box (or at the lattice's end) are the whole table's
    rows bit for bit, for every slab of a 3D lattice (layout D's
    assembly)."""
    mt = tp.UnfittedPoisson(nx=6, dim=3, order=1, dtype=torch.float64,
                            device=CPU)
    dst = mt.dia_structure()
    V, _ = mt.assemble_vals_lattice(mt.vertices, mt.lset, dst)
    nv1, plane = 7, 49
    for z0 in range(nv1):
        for z1 in range(z0 + 1, nv1 + 1):
            p0, p1 = max(z0 - 2, 0), min(z1 + 2, nv1)
            Vb, _ = mt.assemble_vals_lattice(
                mt.vertices[p0 * plane:p1 * plane],
                mt.lset[p0 * plane:p1 * plane], dst, planes=(p0, p1))
            assert torch.equal(Vb[:, (z0 - p0) * plane:(z1 - p0) * plane],
                               V[:, z0 * plane:z1 * plane]), (z0, z1)


def test_map_blocks():
    """``_map_blocks``: blocks of any size give the one-call result."""
    x = torch.arange(23.0)
    fn = lambda a, b: a * 2 + b
    for blk in (None, 1, 5, 23, 40):
        assert torch.equal(tp._map_blocks(fn, blk, x, x), fn(x, x))
