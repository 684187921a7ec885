"""Lattice assembly of the PyTorch port against the JAX package.

Both packages assemble the flagship DIA table from the same state (the JAX
model's vertices and level set, carried over as numpy).  Tolerances: f64 to
1e-12 of max|V| (the reference's own lattice-vs-stencil bound is 1e-13,
tests/test_model_poisson.py:150; a different pow/sqrt library may move the
last bits), f32 to 2e-5 of max|V| (f32 roundoff from sums taken in another
order).  The port's table must be exactly symmetric, as
tests/test_pallas_cg.py:34-44 asserts for the reference.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ngsxfem_tpu.models import poisson as jax_poisson
from ngsxfem_tpu.ops.straightcut import eps_guard_list as jax_eps_guard_list
from ngsxfem_tpu_torch.models import poisson as torch_poisson
from ngsxfem_tpu_torch.ops.straightcut import eps_guard_list

CASES = [(3, 6), (3, 8), (2, 8)]
DTYPES = {"f64": (jnp.float64, torch.float64, 1e-12),
          "f32": (jnp.float32, torch.float32, 2e-5)}
_CACHE = {}


def _assembled(dim, nx, prec):
    key = (dim, nx, prec)
    if key not in _CACHE:
        jdt, tdt, _ = DTYPES[prec]
        mj = jax_poisson.UnfittedPoisson(nx=nx, dim=dim, order=1, dtype=jdt)
        sj = mj.dia_structure()
        Vj, nj = mj.assemble_vals_lattice(mj.vertices, mj.lset, sj)
        mt = torch_poisson.UnfittedPoisson(nx=nx, dim=dim, order=1, dtype=tdt,
                                           device="cpu")
        mt.load_numpy_state({"vertices": np.asarray(mj.vertices),
                             "lset": np.asarray(mj.lset)})
        st = mt.dia_structure()
        Vt, nt = mt.assemble_vals_lattice(mt.vertices, mt.lset, st)
        _CACHE[key] = (np.asarray(Vj), int(nj), Vt.numpy(), int(nt),
                       st["offsets"])
    return _CACHE[key]


def _is_symmetric(V, offsets):
    n = V.shape[1]
    offs = np.asarray(offsets)
    return all(np.array_equal(V[k][:n - o], V[int(np.flatnonzero(offs == -o)[0])][o:])
               for k, o in enumerate(offs) if o > 0)


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("dim,nx", CASES)
def test_lattice_assembly_matches_reference(dim, nx, prec):
    Vj, nj, Vt, nt, _ = _assembled(dim, nx, prec)
    tol = DTYPES[prec][2]
    assert Vt.dtype == Vj.dtype and Vt.shape == Vj.shape
    assert nt == nj
    err = np.abs(Vt - Vj).max()
    assert err <= tol * np.abs(Vj).max(), err


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("dim,nx", CASES)
def test_dia_table_exactly_symmetric(dim, nx, prec):
    _, _, Vt, _, offs = _assembled(dim, nx, prec)
    assert _is_symmetric(Vt, offs)


def test_lattice_assembly_tracks_moving_levelset():
    """Assembling radius 0.45 through a model built at 0.35 equals a model
    built at 0.45 (identity rows and ghost-penalty band follow the level
    set it is given); mirrors tests/test_model_review.py:34-43."""
    m1 = torch_poisson.UnfittedPoisson(nx=6, dim=3, dtype=torch.float64,
                                       radius=0.35, device="cpu")
    m2 = torch_poisson.UnfittedPoisson(nx=6, dim=3, dtype=torch.float64,
                                       radius=0.45, device="cpu")
    s1, s2 = m1.dia_structure(), m2.dia_structure()
    assert np.array_equal(s1["offsets"], s2["offsets"])  # topology-only
    V_moved, n_moved = m1.assemble_vals_lattice(m1.vertices, m2.lset, s1)
    V_ref, n_ref = m2.assemble_vals_lattice(m2.vertices, m2.lset, s2)
    assert int(n_moved) == int(n_ref)
    d = (V_moved - V_ref).abs().max().item()
    assert d < 1e-12, d


def test_closed_form_kernels_on_random_tets():
    """cut_poisson_flat_soa and ghost_penalty_flat_soa on seeded random
    tetrahedra and level-set values covering every sign pattern."""
    rng = np.random.default_rng(7)
    E = 96
    base = rng.standard_normal((E, 3))
    x1 = [base + (rng.standard_normal((E, 3)) * 0.3 + np.eye(3)[c - 1] if c
                  else 0.0) for c in range(4)]
    x2 = [x1[c] + 0.05 * rng.standard_normal((E, 3)) for c in range(4)]
    lv = rng.standard_normal((4, E))
    lv[:, :16] = np.where((np.arange(16)[None, :] >> np.arange(4)[:, None]) & 1,
                          np.abs(lv[:, :16]), -np.abs(lv[:, :16]))

    def soa(xs, t):
        return [[t(xs[c][:, a]) for a in range(3)] for c in range(4)]

    out = []
    for mod, t, guard in ((jax_poisson, jnp.asarray, jax_eps_guard_list),
                          (torch_poisson, torch.as_tensor, eps_guard_list)):
        X1, X2 = soa(x1, t), soa(x2, t)
        det, Jinv = mod._soa_jacobian(X1, 3)
        A = mod.cut_poisson_flat_soa("tet", guard([t(v) for v in lv]),
                                     det, Jinv, 20.0)
        G = mod.ghost_penalty_flat_soa("tet", X1, X2, 0.1)
        out.append(([np.asarray(A[i][j]) for i in range(4) for j in range(4)],
                    [np.asarray(G[i][j]) for i in range(8) for j in range(8)]))
    for a, b in zip(out[0][0] + out[0][1], out[1][0] + out[1][1]):
        scale = max(np.abs(a).max(), 1e-300)
        assert np.abs(a - b).max() <= 1e-12 * scale
