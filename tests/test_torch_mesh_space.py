"""Host tables of the PyTorch port equal the JAX package's, bit for bit.

The port copies the numpy host code (mesh, dof numbering, DIA structure,
lattice plans); every table must come out identical at nx=4 and 6 in 2D and
3D.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ngsxfem_tpu.models.poisson import UnfittedPoisson as JaxPoisson
from ngsxfem_tpu.ops import cuttables as jax_cuttables
from ngsxfem_tpu.ops import gauss as jax_gauss
from ngsxfem_tpu.fem import basis as jax_basis
from ngsxfem_tpu import integrate as jax_integrate

from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson as TorchPoisson
from ngsxfem_tpu_torch.ops import cuttables as torch_cuttables
from ngsxfem_tpu_torch.ops import gauss as torch_gauss
from ngsxfem_tpu_torch.fem import basis as torch_basis
from ngsxfem_tpu_torch import integrate as torch_integrate

CASES = [(2, 4), (2, 6), (3, 4), (3, 6)]
_MODELS = {}


def _pair(dim, nx):
    if (dim, nx) not in _MODELS:
        mj = JaxPoisson(nx=nx, dim=dim, order=1, dtype=jnp.float64)
        mt = TorchPoisson(nx=nx, dim=dim, order=1, dtype=torch.float64,
                          device="cpu")
        _MODELS[(dim, nx)] = (mj, mt, mj.dia_structure(), mt.dia_structure())
    return _MODELS[(dim, nx)]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("dim,nx", CASES)
def test_mesh_tables(dim, nx):
    mj, mt, _, _ = _pair(dim, nx)
    for name in ("vertices_np", "elements_np", "facets_np", "el2facet_np",
                 "facet2el_np", "facet2elloc_np", "boundary_facets_np"):
        assert _same(getattr(mj.mesh, name), getattr(mt.mesh, name)), name
    assert mj.mesh.et == mt.mesh.et and mj.mesh.nfacets == mt.mesh.nfacets


@pytest.mark.parametrize("dim,nx", CASES)
def test_space_tables(dim, nx):
    mj, mt, _, _ = _pair(dim, nx)
    assert mj.space.ndof == mt.space.ndof
    assert _same(mj.space.el2dof_np, mt.space.el2dof_np)


@pytest.mark.parametrize("dim,nx", CASES)
def test_model_tables(dim, nx):
    mj, mt, _, _ = _pair(dim, nx)
    for name in ("p1dof2vertex", "gp_facets", "gp_e1", "gp_e2", "active",
                 "active_dofs", "el2vert", "el2dof", "elements", "lset_np"):
        assert _same(getattr(mj, name), getattr(mt, name)), name
    assert np.array_equal(np.asarray(mj.vertices), mt.vertices.numpy())
    assert np.array_equal(np.asarray(mj.lset), mt.lset.numpy())


@pytest.mark.parametrize("dim,nx", CASES)
def test_dia_structure(dim, nx):
    _, _, sj, st = _pair(dim, nx)
    assert sorted(sj) == sorted(st)
    for key in sj:
        if key == "n":
            assert sj[key] == st[key]
        else:
            assert _same(sj[key], st[key]), key


@pytest.mark.parametrize("dim,nx", CASES)
def test_lattice_plans(dim, nx):
    mj, mt, sj, _ = _pair(dim, nx)
    offs = sj["offsets"]
    assert mj.stencil_groups(offs) == mt.stencil_groups(offs)
    assert mj.gp_lattice_types(offs) == mt.gp_lattice_types(offs)


@pytest.mark.parametrize("et", ["segm", "trig", "quad", "tet", "hex"])
def test_reference_rules_and_bases(et):
    for order in range(5):
        pj, wj = jax_gauss.reference_rule(et, order)
        pt, wt = torch_gauss.reference_rule(et, order)
        assert np.array_equal(pj, pt) and np.array_equal(wj, wt)
    for order in range(1, 4):
        bj = jax_basis.lagrange_element(et, order)
        bt = torch_basis.lagrange_element(et, order)
        for key in ("nodes", "exps", "coeff"):
            assert np.array_equal(bj[key], bt[key]), key
        assert jax_basis.ndof_el(et, order) == torch_basis.ndof_el(et, order)
        assert np.array_equal(jax_integrate.vertex_local_ids(et, order),
                              torch_integrate.vertex_local_ids(et, order))
    assert jax_gauss.ET_DIM == torch_gauss.ET_DIM
    assert jax_gauss.ET_NVERT == torch_gauss.ET_NVERT


@pytest.mark.parametrize("d", [1, 2, 3])
def test_cut_decomposition_tables(d):
    for p in range(2 ** (d + 1)):
        assert jax_cuttables._decompose(d, p) == torch_cuttables._decompose(d, p)
    for et, rv in jax_cuttables.REF_VERTS.items():
        assert np.array_equal(rv, torch_cuttables.REF_VERTS[et])
