"""Spaces, boundary ids and GridFunction vectors of the PyTorch port against
the JAX package.

Host tables are held bitwise equal: the boundary-condition ids of the
structured meshes, ``bc_of_dof``/``dirichlet_dofs``/``FreeDofs`` of ``H1``
(id lists and regexes, orders 1-3), the maps of ``Compress``,
``GetDofsOfElements`` and the compound offsets.  GridFunction vectors
(``Set`` with ``boundary``/``definedonelements``, components that write
through to their parent, evaluation on compressed spaces and components) are
held to 1e-13.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import ngsxfem_tpu as J
import ngsxfem_tpu_torch as T
from ngsxfem_tpu.fem.gridfunction import StandaloneVec as JStandaloneVec
from ngsxfem_tpu_torch.fem.gridfunction import (StandaloneVec, VecShim,
                                                _CompVecShim)

CPU = {"device": "cpu"}


def _meshes(N):
    m2 = lambda a, b: (2 * a - 1, 3 * b)
    m3 = lambda a, b, c: (2 * a - 1, 2 * b - 1, c + 1)
    return {
        "1d": N.Make1DMesh(5, mapping=lambda a: 2 * a - 1),
        "trig": N.MakeStructured2DMesh(quads=False, nx=4, ny=3, mapping=m2),
        "quad": N.MakeStructured2DMesh(quads=True, nx=3, ny=4),
        "tet": N.MakeStructured3DMesh(hexes=False, nx=2, ny=3, nz=2,
                                      mapping=m3),
        "hex": N.MakeStructured3DMesh(hexes=True, nx=2, ny=2, nz=3),
    }


@pytest.fixture(scope="module")
def meshes():
    return _meshes(J), _meshes(T)


@pytest.mark.parametrize("kind", ["1d", "trig", "quad", "tet", "hex"])
def test_boundary_ids_bitwise(meshes, kind):
    mj, mt = meshes[0][kind], meshes[1][kind]
    assert mt.bc_of_facet_np.dtype == mj.bc_of_facet_np.dtype
    assert np.array_equal(mt.bc_of_facet_np, mj.bc_of_facet_np)
    assert np.array_equal(mt.boundary_facets_np, mj.boundary_facets_np)
    assert dict(mt.bc_names) == dict(mj.bc_names)
    assert mt.GetBoundaries() == mj.GetBoundaries()
    # every boundary facet has an id, no interior facet has one
    assert (mt.bc_of_facet_np[mt.boundary_facets_np] > 0).all()
    assert (mt.bc_of_facet_np > 0).sum() == len(mt.boundary_facets_np)


def test_plain_mesh_default_bc():
    mj, mt = _meshes(J)["trig"], _meshes(T)["trig"]
    from ngsxfem_tpu.mesh.mesh import Mesh as JMesh
    from ngsxfem_tpu_torch.mesh.mesh import Mesh as TMesh

    pj = JMesh("trig", mj.vertices_np, mj.elements_np)
    pt = TMesh("trig", mt.vertices_np, mt.elements_np)
    assert np.array_equal(pt.bc_of_facet_np, pj.bc_of_facet_np)
    assert pt.GetBoundaries() == pj.GetBoundaries() == ("bc1",)


@pytest.mark.parametrize("kind,order,dirichlet", [
    ("trig", 1, [1, 2, 3, 4]), ("trig", 2, [2, 4]), ("trig", 3, "bottom|top"),
    ("quad", 1, "left"), ("quad", 2, [1]), ("tet", 1, [1, 6]),
    ("tet", 2, "back|front|left"), ("hex", 1, ".*"), ("hex", 2, [5]),
    ("1d", 2, [2]), ("trig", 1, None), ("tet", 1, []),
])
def test_h1_boundary_and_free_dofs_bitwise(meshes, kind, order, dirichlet):
    sj = J.H1(meshes[0][kind], order=order, dirichlet=dirichlet)
    st = T.H1(meshes[1][kind], order=order, dirichlet=dirichlet, **CPU)
    assert st.ndof == sj.ndof and st.ndof_el == sj.ndof_el
    assert np.array_equal(st.el2dof_np, sj.el2dof_np)
    assert st.bc_of_dof.dtype == sj.bc_of_dof.dtype
    assert np.array_equal(st.bc_of_dof, sj.bc_of_dof)
    assert np.array_equal(st.dirichlet_dofs, sj.dirichlet_dofs)
    assert np.array_equal(st.FreeDofs().np, sj.FreeDofs().np)
    assert st.FreeDofs().NumSet() == sj.FreeDofs().NumSet()
    assert st.el2dof.dtype == torch.int64
    assert np.array_equal(st.el2dof.numpy(), sj.el2dof_np)
    assert st.el2dof_valid_on("cpu") is None
    assert repr(st) == repr(sj)


def test_space_device_defaults_to_card():
    sp = T.H1(_meshes(T)["trig"], order=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            sp.el2dof
        with pytest.raises(RuntimeError):
            T.GridFunction(sp)


def _marks(mesh, seed):
    return np.random.default_rng(seed).random(mesh.ne) < 0.4


@pytest.mark.parametrize("kind,order", [("trig", 1), ("trig", 2), ("quad", 1),
                                        ("tet", 1), ("hex", 2)])
def test_compress_and_dofs_of_elements_bitwise(meshes, kind, order):
    mj, mt = meshes[0][kind], meshes[1][kind]
    marks = _marks(mj, 3)
    bj = J.H1(mj, order=order, dirichlet=[1], dgjumps=True)
    bt = T.H1(mt, order=order, dirichlet=[1], dgjumps=True, **CPU)
    aj = J.GetDofsOfElements(bj, J.BitArray(marks))
    at = T.GetDofsOfElements(bt, T.BitArray(marks))
    assert np.array_equal(at.np, aj.np)
    cj, ct = J.Compress(bj, aj), T.Compress(bt, at)
    assert ct.ndof == cj.ndof and ct.order == cj.order
    assert ct.dgjumps == cj.dgjumps and ct.mesh is mt
    for attr in ("comp2base", "base2comp", "el2dof_np", "el2dof_valid_np",
                 "dirichlet_dofs", "bc_of_dof", "dof_rep_elem",
                 "dof_rep_local", "dof_rep_ref"):
        a, b = getattr(ct, attr), getattr(cj, attr)
        assert a.dtype == b.dtype and np.array_equal(a, b), attr
    assert np.array_equal(ct.FreeDofs().np, cj.FreeDofs().np)
    assert np.array_equal(ct.el2dof_valid_on("cpu").numpy(),
                          cj.el2dof_valid_np)
    # placeholder slots of the compressed space are skipped
    other = _marks(mj, 4)
    assert np.array_equal(T.GetDofsOfElements(ct, other).np,
                          J.GetDofsOfElements(cj, other).np)
    with pytest.raises(ValueError):
        T.Compress(bt)


def test_compound_space_bitwise(meshes):
    mj, mt = meshes[0]["trig"], meshes[1]["trig"]
    vj = [J.H1(mj, order=1, dirichlet=[1, 2]), J.H1(mj, order=2, dirichlet=[3])]
    vt = [T.H1(mt, order=1, dirichlet=[1, 2], **CPU),
          T.H1(mt, order=2, dirichlet=[3], **CPU)]
    cj, ct = J.FESpace(vj), T.FESpace(vt)
    assert ct.is_compound and ct.ndof == cj.ndof
    assert ct.offsets.dtype == cj.offsets.dtype
    assert np.array_equal(ct.offsets, cj.offsets)
    assert [ct.Range(i) for i in range(2)] == [cj.Range(i) for i in range(2)]
    assert np.array_equal(ct.FreeDofs().np, cj.FreeDofs().np)
    assert ct.components[1] is vt[1] and repr(ct) == repr(cj)
    ba = T.CompoundBitArray([T.BitArray([True, False]), [False, True, True]])
    assert np.array_equal(
        ba.np, J.CompoundBitArray([J.BitArray([True, False]),
                                   [False, True, True]]).np)
    u, v = ct.TnT()
    assert len(u) == len(v) == 2 and u[1].block_key == (1, False)
    assert v[0].test and not u[0].test and u[1].compound == (ct, 1)
    with pytest.raises(TypeError):
        T.FESpace(vt[0])


def test_vec_shims_and_components(meshes):
    mt = meshes[1]["trig"]
    V = T.H1(mt, order=1, **CPU)
    W = T.FESpace([V, V])
    g = T.GridFunction(W)
    assert isinstance(g.vec, VecShim) and len(g.components) == 2
    c0, c1 = g.components
    assert isinstance(c1.vec, _CompVecShim)
    rng = np.random.default_rng(0)
    a = rng.standard_normal(V.ndof)
    c1.vec.data = a                       # writes through to the parent
    assert np.array_equal(g.vec.NumPy()[V.ndof:], a)
    assert np.array_equal(g.vec.NumPy()[:V.ndof], np.zeros(V.ndof))
    whole = rng.standard_normal(W.ndof)
    g.vec.data = whole                    # and the component sees the parent
    assert np.array_equal(c0.vec.NumPy(), whole[:V.ndof])
    c0.vec[:] = 0.0
    assert float(g.vec.data[:V.ndof].abs().max()) == 0.0
    assert np.array_equal(g.vec.NumPy()[V.ndof:], whole[V.ndof:])
    c0.vec[2] = 5.0
    assert float(g.vec[2]) == 5.0 and len(g.vec) == W.ndof
    # arithmetic and conversions
    assert np.allclose((g.vec + g.vec).numpy(), 2 * g.vec.NumPy())
    assert np.allclose((g.vec - c0.vec.CreateVector().data.new_zeros(W.ndof))
                       .numpy(), g.vec.NumPy())
    assert np.allclose((2.0 * g.vec).numpy(), (g.vec * 2.0).numpy())
    assert np.array_equal(np.asarray(g.vec), g.vec.NumPy())
    assert g.vec.FV().NumPy().shape == (W.ndof,)
    sv = g.vec.CreateVector()
    assert isinstance(sv, StandaloneVec) and len(sv) == W.ndof
    sv[:] = g.vec
    sv[0] = 1.5
    assert float(sv[0]) == 1.5 and np.allclose(np.asarray(sv)[1:],
                                               g.vec.NumPy()[1:])
    sv.data = g.vec
    assert np.allclose((sv + sv).numpy(), (g.vec * 2).numpy())
    assert float((sv - g.vec).abs().max()) == 0.0
    g2 = T.GridFunction(W)
    g2.vec = g.vec
    assert np.array_equal(g2.vec.NumPy(), g.vec.NumPy())
    with pytest.raises(ValueError):
        c0.vec.data = np.zeros(3)
    with pytest.raises(TypeError):
        g.Set(T.x)
    # the reference's standalone vector behaves alike
    jv = JStandaloneVec(jnp.zeros(4))
    jv[1] = 2.0
    tv = StandaloneVec(torch.zeros(4, dtype=torch.float64))
    tv[1] = 2.0
    assert np.array_equal(np.asarray(jv), np.asarray(tv))


@pytest.mark.parametrize("kind,order", [("trig", 2), ("quad", 1), ("tet", 1)])
def test_set_boundary_and_definedonelements(meshes, kind, order):
    mj, mt = meshes[0][kind], meshes[1][kind]
    marks = _marks(mj, 5)
    outs = []
    for N, m, kw in ((J, mj, {}), (T, mt, CPU)):
        V = N.H1(m, order=order, dirichlet=[1], **kw)
        W = N.FESpace([V, V])
        g = N.GridFunction(W)
        f = N.sin(N.x) + 2.0 * N.y * N.y
        g.components[0].Set(f)
        g.components[1].Set(N.x - N.y)
        g.components[1].Set(f, boundary=True)
        g.components[0].Set(3.0 * N.x, definedonelements=N.BitArray(marks))
        outs.append(np.asarray(g.vec.NumPy()))
    assert np.abs(outs[1] - outs[0]).max() <= 1e-13


@pytest.mark.parametrize("kind", ["trig", "quad", "tet"])
def test_gridfunction_on_compressed_space_and_component(meshes, kind):
    """A GridFunction on a compressed space (placeholder slots read zero)
    and a component of a compound one, evaluated under Integrate."""
    mj, mt = meshes[0][kind], meshes[1][kind]
    marks = _marks(mj, 6)
    rng = np.random.default_rng(7)
    vals = []
    for N, m, kw in ((J, mj, {}), (T, mt, CPU)):
        B = N.H1(m, order=2, **kw)
        C = N.Compress(B, N.GetDofsOfElements(B, N.BitArray(marks)))
        g = N.GridFunction(C)
        if not vals:
            data = rng.standard_normal(C.ndof) + 2.0
            whole = rng.standard_normal(2 * B.ndof)
        g.vec.data = data
        W = N.FESpace([B, B])
        gw = N.GridFunction(W)
        gw.vec.data = whole
        v = [N.Integrate(g * g + g, m, order=4, **kw),
             N.Integrate(N.grad(g) * N.grad(g), m, order=4, **kw),
             N.Integrate(gw.components[1] * N.x, m, order=4, **kw),
             N.Integrate(N.grad(gw.components[0])[0], m, order=4, **kw)]
        vals.append(v)
    assert np.allclose(vals[1], vals[0], rtol=1e-12, atol=1e-13)
