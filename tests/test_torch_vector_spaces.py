"""L2, NumberSpace and vector spaces of the PyTorch port against the JAX
package.

Host tables are held bitwise equal: ``ndof``, the dof maps and dof
representatives, ``bc_of_dof``/``dirichlet_dofs``/``FreeDofs``,
``GetDofsOfElements`` and ``Compress`` of ``L2`` (orders 0-2),
``NumberSpace``, ``VectorH1``/``VectorL2`` and compounds holding vector
blocks.  Vector GridFunctions (``Set``, values, gradients and ``div``,
components of a compound) are held to 1e-14 at the quadrature points, and
forms with ``div`` and vector proxies (``a.mat.todense()``) to 1e-12 of the
largest entry.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import ngsxfem_tpu as J
import ngsxfem_tpu_torch as T
from ngsxfem_tpu.cf.context import EvalCtx as JCtx, eval_pure as j_eval
from ngsxfem_tpu.fem.space import NumberSpace as JNumberSpace
from ngsxfem_tpu_torch.cf.context import EvalCtx as TCtx, eval_pure as t_eval

CPU = {"device": "cpu"}
KINDS = ["1d", "trig", "quad", "tet", "hex"]


def _meshes(N):
    m2 = lambda a, b: (2 * a - 1, 3 * b)
    return {
        "1d": N.Make1DMesh(5, mapping=lambda a: 2 * a - 1),
        "trig": N.MakeStructured2DMesh(quads=False, nx=4, ny=3, mapping=m2),
        "quad": N.MakeStructured2DMesh(quads=True, nx=3, ny=4),
        "tet": N.MakeStructured3DMesh(hexes=False, nx=2, ny=3, nz=2),
        "hex": N.MakeStructured3DMesh(hexes=True, nx=2, ny=2, nz=3),
    }


@pytest.fixture(scope="module")
def meshes():
    return _meshes(J), _meshes(T)


def _marks(mesh, seed):
    return np.random.default_rng(seed).random(mesh.ne) < 0.4


def _same(a, b, attrs):
    for attr in attrs:
        x, y = np.asarray(getattr(a, attr)), np.asarray(getattr(b, attr))
        assert x.dtype == y.dtype and np.array_equal(x, y), attr


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("order", [0, 1, 2])
def test_l2_bitwise(meshes, kind, order):
    mj, mt = meshes[0][kind], meshes[1][kind]
    sj = J.L2(mj, order=order, dirichlet=[1], dgjumps=True)
    st = T.L2(mt, order=order, dirichlet=[1], dgjumps=True, **CPU)
    assert st.ndof == sj.ndof and st.ndof_el == sj.ndof_el
    _same(st, sj, ("el2dof_np", "dof_rep_elem", "dof_rep_local",
                   "dof_rep_ref", "bc_of_dof", "dirichlet_dofs"))
    assert np.array_equal(st.FreeDofs().np, sj.FreeDofs().np)
    marks = _marks(mj, order)
    aj = J.GetDofsOfElements(sj, J.BitArray(marks))
    at = T.GetDofsOfElements(st, T.BitArray(marks))
    assert np.array_equal(at.np, aj.np)
    cj, ct = J.Compress(sj, aj), T.Compress(st, at)
    _same(ct, cj, ("comp2base", "base2comp", "el2dof_np", "el2dof_valid_np",
                   "dirichlet_dofs", "dof_rep_elem", "dof_rep_ref"))


@pytest.mark.parametrize("kind", ["trig", "tet"])
def test_number_space_bitwise(meshes, kind):
    mj, mt = meshes[0][kind], meshes[1][kind]
    nj, nt = JNumberSpace(mj), T.NumberSpace(mt, **CPU)
    assert nt.ndof == nj.ndof == 1 and nt.order == nj.order == 0
    _same(nt, nj, ("el2dof_np", "bc_of_dof", "dirichlet_dofs", "dof_rep_ref"))
    assert np.array_equal(nt.FreeDofs().np, nj.FreeDofs().np)
    # a zero-mean multiplier row: the integral of one test function
    for N, sp, kw in ((J, nj, {}), (T, nt, CPU)):
        f = N.LinearForm(sp)
        f += N.SymbolicLFI(form=sp.TestFunction())
        f.Assemble()
        vol = float(np.asarray(f.vec.data)[0])
        assert abs(vol - (6.0 if kind == "trig" else 1.0)) < 1e-12


@pytest.mark.parametrize("kind", KINDS[1:])
@pytest.mark.parametrize("space", ["VectorH1", "VectorL2"])
def test_vector_space_bitwise(meshes, kind, space):
    mj, mt = meshes[0][kind], meshes[1][kind]
    kw = {"dirichlet": [1, 2]} if space == "VectorH1" else {}
    vj = getattr(J, space)(mj, order=2, **kw)
    vt = getattr(T, space)(mt, order=2, **kw, **CPU)
    assert (vt.ndof, vt.nscal, vt.vdim, vt.order) == \
        (vj.ndof, vj.nscal, vj.vdim, vj.order)
    _same(vt, vj, ("el2dof_np", "dirichlet_dofs", "bc_of_dof"))
    assert np.array_equal(vt.FreeDofs().np, vj.FreeDofs().np)
    marks = _marks(mj, 5)
    aj = J.GetDofsOfElements(vj, J.BitArray(marks))
    at = T.GetDofsOfElements(vt, T.BitArray(marks))
    assert np.array_equal(at.np, aj.np)
    # the block dof map of all components, as the reference assembles it
    from ngsxfem_tpu.forms.assemble import block_dofmap as j_block
    from ngsxfem_tpu_torch.forms.assemble import block_dofmap as t_block

    ids = np.nonzero(marks)[0]
    assert np.array_equal(
        t_block(vt, (0, False), torch.as_tensor(ids), device="cpu").numpy(),
        j_block(vj, (0, False), ids))
    # compound with a vector block
    qj = J.H1(mj, order=1, dirichlet=[3])
    qt = T.H1(mt, order=1, dirichlet=[3], **CPU)
    cj, ct = J.FESpace([vj, qj]), T.FESpace([vt, qt])
    assert np.array_equal(ct.offsets, cj.offsets) and ct.ndof == cj.ndof
    assert np.array_equal(ct.FreeDofs().np, cj.FreeDofs().np)
    u, v = ct.TnT()
    assert u[0].dims == (mt.dim,) and T.grad(u[0]).dims == (mt.dim, mt.dim)
    assert T.div(v[0]).dims == () and u[0].Operator("div").op == "div"


def _vector_cf(N, dim):
    x, y, z = N.x, N.y, N.z
    comps = [x * x + y, x * y - 1.0, z * x + 0.5][:dim]
    if dim == 3:
        comps[1] = comps[1] + z * z
    return N.CoefficientFunction(tuple(comps))


@pytest.mark.parametrize("kind", KINDS[1:])
def test_vector_gridfunction_values(meshes, kind):
    """Set, values, gradients, div and compound components at seeded
    reference points of every element, to 1e-14."""
    mj, mt = meshes[0][kind], meshes[1][kind]
    d = mt.dim
    gj = J.GridFunction(J.VectorH1(mj, order=2, dirichlet=[1]))
    gt = T.GridFunction(T.VectorH1(mt, order=2, dirichlet=[1], **CPU))
    gj.Set(_vector_cf(J, d))
    gt.Set(_vector_cf(T, d))
    assert gt.dims == gj.dims == (d,)
    assert np.abs(gt.vec.NumPy() - np.asarray(gj.vec.data)).max() <= 1e-14
    gj.Set(J.CoefficientFunction((0.25,) * d), boundary=True)
    gt.Set(T.CoefficientFunction((0.25,) * d), boundary=True)
    assert np.abs(gt.vec.NumPy() - np.asarray(gj.vec.data)).max() <= 1e-14

    pts = np.random.default_rng(7).random((mt.ne, 4, d))
    if kind in ("trig", "tet"):
        pts = pts / (1.0 + pts.sum(-1, keepdims=True))
    cj = JCtx(mj, jnp.asarray(pts))
    ct = TCtx(mt, torch.as_tensor(pts))
    # the reference's div(gf) indexes g[i, i], which its Component node
    # rejects; the trace is built here from its grad(gf)[i][i]
    div_j = J.grad(gj)[0][0]
    for i in range(1, d):
        div_j = div_j + J.grad(gj)[i][i]
    for cfj, cft in ((gj, gt), (J.grad(gj), T.grad(gt)),
                     (div_j, T.div(gt)), (J.Norm(gj), T.Norm(gt))):
        vj = np.asarray(j_eval(cfj, cj))
        vt = t_eval(cft, ct).numpy()
        assert vt.shape == vj.shape
        assert np.abs(vt - vj).max() <= 1e-14 * max(1.0, np.abs(vj).max())

    # a vector block of a compound GridFunction reads its slice
    Xj = J.FESpace([gj.space, J.H1(mj, order=1)])
    Xt = T.FESpace([gt.space, T.H1(mt, order=1, **CPU)])
    cgj, cgt = J.GridFunction(Xj), T.GridFunction(Xt)
    cgj.components[0].vec.data = gj.vec.data
    cgt.components[0].vec.data = gt.vec.data
    assert cgt.components[0].dims == (d,)
    vj = np.asarray(j_eval(J.grad(cgj.components[0]), cj))
    vt = t_eval(T.grad(cgt.components[0]), ct).numpy()
    assert np.abs(vt - vj).max() <= 1e-14 * max(1.0, np.abs(vj).max())


@pytest.mark.parametrize("kind", ["trig", "quad", "tet"])
def test_vector_forms_match(meshes, kind):
    """Taylor-Hood-type forms on a compound with a vector block: grad:grad,
    div-pressure coupling, a vector load, a boundary term and (in 2D)
    the vector dn jump on the skeleton."""
    out = []
    for N, m, kw in ((J, meshes[0][kind], {}), (T, meshes[1][kind], CPU)):
        d = m.dim
        V = N.VectorH1(m, order=2, dgjumps=True, **kw)
        Q = N.H1(m, order=1, **kw)
        X = N.FESpace([V, Q])
        (u, p), (v, q) = X.TnT()
        h = N.specialcf.mesh_size
        a = N.BilinearForm(X)
        a += N.SymbolicBFI(form=N.InnerProduct(N.grad(u), N.grad(v))
                           - N.div(v) * p - u.Operator("div") * q
                           + 0.5 * (u * v) - 1e-3 * p * q)
        if d == 2:
            a += N.SymbolicBFI(form=h * N.InnerProduct(N.dnjump(u, 1),
                                                       N.dnjump(v, 1)),
                               skeleton=True)
        a += N.SymbolicBFI(form=(u * N.specialcf.normal(d)) * q,
                           VOL_or_BND=N.BND)
        a.Assemble()
        f = N.LinearForm(X)
        f += N.SymbolicLFI(form=_vector_cf(N, d) * v + N.x * q)
        f.Assemble()
        out.append((np.asarray(a.mat.todense()), np.asarray(f.vec.data)))
    (Aj, fj), (At, ft) = out
    assert np.abs(At - Aj).max() <= 1e-12 * np.abs(Aj).max()
    assert np.abs(ft - fj).max() <= 1e-12 * np.abs(fj).max()
