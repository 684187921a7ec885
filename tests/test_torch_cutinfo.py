"""``CutInfo`` and the facet/element/dof set algebra of the port against
the JAX package: on seeded random P1 level sets (the same numpy dof vector
to both, exact zeros among the values) the classification arrays are equal
exactly and the cut ratios to 1e-13."""
import numpy as np
import pytest
import jax.numpy as jnp

import ngsxfem_tpu as J
import ngsxfem_tpu_torch as T
from ngsxfem_tpu.geom import cutinfo as jci
from ngsxfem_tpu_torch.geom import cutinfo as tci


def _mesh(pkg, et, n):
    if et in ("trig", "quad"):
        return pkg.MakeStructured2DMesh(quads=et == "quad", nx=n, ny=n)
    return pkg.MakeStructured3DMesh(hexes=et == "hex", nx=n, ny=n, nz=n)


def _pair(et, n, seed):
    mj, mt = _mesh(J, et, n), _mesh(T, et, n)
    lj = J.GridFunction(J.H1(mj, order=1))
    lt = T.GridFunction(T.H1(mt, order=1, device="cpu"))
    v = np.random.default_rng(seed).standard_normal(lj.space.ndof) + 0.3
    v[::5] = 0.0
    lj.vec.data = jnp.asarray(v)
    lt.vec.data = v
    return mj, mt, J.CutInfo(mj, lj), T.CutInfo(mt, lt)


CASES = [("trig", 5), ("quad", 4), ("tet", 3), ("hex", 3)]


@pytest.mark.parametrize("et,n", CASES)
def test_cutinfo_arrays_match_jax(et, n):
    _, _, cj, ct = _pair(et, n, seed=n)
    for name in ("dt_of_elem", "dt_of_vertex", "cdt_of_facet", "dt_of_belem"):
        a, b = getattr(cj, name), getattr(ct, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for vb in ("VOL", "BND"):
        a, b = cj.GetCutRatios(vb), ct.GetCutRatios(vb)
        assert np.max(np.abs(a - b), initial=0.0) <= 1e-13, vb
        assert ((b >= 0) & (b <= 1)).all()
    assert (ct.dt_of_elem == int(T.IF)).any()


@pytest.mark.parametrize("et,n", CASES)
def test_set_algebra_matches_jax(et, n):
    mj, mt, cj, ct = _pair(et, n, seed=n + 1)
    for dt in ("NEG", "POS", "IF", "HASNEG", "HASPOS", "ANY", "UNCUT"):
        a = cj.GetElementsOfType(getattr(J, dt)).np
        b = ct.GetElementsOfType(getattr(T, dt)).np
        assert np.array_equal(a, b), dt
        assert np.array_equal(cj.GetFacetsOfType(getattr(J, dt)).np,
                              ct.GetFacetsOfType(getattr(T, dt)).np), dt
    for dt in ("NEG", "POS", "IF"):
        assert np.array_equal(
            cj.GetElementsOfType(getattr(J, dt), "BND").np,
            ct.GetElementsOfType(getattr(T, dt), "BND").np), dt
    for thr in (0.0, 0.5, 1.0):
        assert np.array_equal(
            cj.GetElementsWithThresholdContribution(J.NEG, thr).np,
            ct.GetElementsWithThresholdContribution(T.NEG, thr).np)
    hn = ct.GetElementsOfType(T.HASNEG)
    hi = ct.GetElementsOfType(T.IF)
    for use_and in (True, False):
        fj = jci.GetFacetsWithNeighborTypes(mj, hn.np, hi.np, use_and=use_and)
        ft = tci.GetFacetsWithNeighborTypes(mt, hn, hi, use_and=use_and)
        assert np.array_equal(fj.np, ft.np)
    assert np.array_equal(jci.GetElementsWithNeighborFacets(mj, ft.np).np,
                          tci.GetElementsWithNeighborFacets(mt, ft).np)
    for order in (1, 2, 3):
        sj = J.H1(mj, order=order)
        st = T.H1(mt, order=order)
        assert np.array_equal(jci.GetDofsOfFacets(sj, ft.np).np,
                              tci.GetDofsOfFacets(st, ft).np), order


def test_indicator_cfs_integrate_like_jax():
    """IndicatorCF, CutRatioGF and BitArrayCF as integrands."""
    mj, mt, cj, ct = _pair("trig", 4, seed=9)
    ba = ct.GetElementsOfType(T.IF)
    pairs = ((jci.IndicatorCF(mj, ba.np), tci.IndicatorCF(mt, ba)),
             (jci.CutRatioGF(cj), tci.CutRatioGF(ct)),
             (jci.BitArrayCF(ba.np, mj), tci.BitArrayCF(ba, mt)))
    for cfj, cft in pairs:
        a = J.Integrate(cfj * J.x, mj, order=2)
        b = T.Integrate(cft * T.x, mt, order=2, device="cpu")
        assert abs(a - b) <= 1e-13
