"""The DG, dn-ghost-penalty and cut Stokes workloads of the PyTorch port
against the JAX package's examples.

``examples.fictdom_dg_ghostpen`` (L2, cut-facet interior penalty),
``examples.fictdom_dn_ghostpen`` (``dnjump`` skeleton ghost penalty) and
``examples.stokescutfem`` (``VectorH1``, ``div``, a saddle-point system) of
the port reproduce the JAX examples' L2 errors to 1e-9 relative at the
sizes of the JAX tests, and meet those tests' thresholds
(``tests/test_workloads.py:74-83``, ``tests/test_ghostpenalty.py:13-24``,
``tests/test_stokes.py:11-21``).  ``MinResSolver`` solves the Stokes system
to the host LU's solution at nx=8 (1e-8 relative, as
``tests/test_stokes.py:51-59`` asks of the reference).  ``examples.nxfem``
and ``examples.xfespaces`` are held in ``test_torch_xfespace.py``.
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ngsxfem_tpu_torch import GridFunction, MinResSolver
from ngsxfem_tpu_torch.examples import (fictdom_dg_ghostpen,
                                        fictdom_dn_ghostpen, stokescutfem)

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: under ``-n 6`` the workers'
    thread pools contend, and the port's small-tensor Krylov loops slow
    down 8x with torch's default threads (the phase-16 rehearsal on an
    8-core CPU with seven cores busy: 52.6 s, against 6.8 s with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_fictdom_dg_ghostpen_matches_jax():
    from examples import fictdom_dg_ghostpen as jdg

    e20 = fictdom_dg_ghostpen.run(nx=20, order=2, verbose=False, **CPU)
    assert _rel(e20, jdg.run(nx=20, order=2, verbose=False)) <= 1e-9
    e40 = fictdom_dg_ghostpen.run(nx=40, order=2, verbose=False, **CPU)
    assert e40 < 0.006 and e40 < e20 / 3, (e20, e40)


def test_fictdom_dn_ghostpen_matches_jax():
    from examples import fictdom_dn_ghostpen as jdn

    e1 = fictdom_dn_ghostpen.run(nx=20, order=1, verbose=False, **CPU)
    assert _rel(e1, jdn.run(nx=20, order=1, verbose=False)) <= 1e-9
    assert e1 < 0.08, e1
    e2 = fictdom_dn_ghostpen.run(nx=20, order=2, verbose=False, **CPU)
    assert e2 < 0.02, e2


def test_stokescutfem_matches_jax():
    from examples import stokescutfem as jst

    u16, p16 = stokescutfem.run(nx=16, verbose=False, **CPU)
    uj, pj = jst.run(nx=16, verbose=False)
    assert _rel(u16, uj) <= 1e-9 and _rel(p16, pj) <= 1e-9
    assert u16 < 0.02 and p16 < 0.05, (u16, p16)
    u32, p32 = stokescutfem.run(nx=32, verbose=False, **CPU)
    assert u32 < u16 / 3 and p32 < p16 / 2.5, (u16, p16, u32, p32)


@pytest.mark.parametrize("pre", ["abs-Jacobi", "pressure mass"])
def test_stokes_minres_matches_direct(pre):
    """MinResSolver with its default preconditioner and with the example's
    block preconditioner: the velocity to 1e-8 relative and both L2 errors
    to 1e-8 of the LU's.  The pressure is fixed only up to a constant by
    its 1e-8 regularization, so it is compared through its mean-free
    error."""
    a, f, X, active, errors, pmass = stokescutfem.system(nx=8, **CPU)
    a.Assemble()
    f.Assemble()
    M = None
    if pre == "pressure mass":
        pmass.Assemble()
        M = stokescutfem.minres_preconditioner(a, pmass, X, active)
    x_lu = a.mat.Inverse(active) * f.vec
    x_mr = MinResSolver(a.mat, pre=M, freedofs=active, maxsteps=2000,
                        tol=1e-12) * f.vec
    vel = X.Range(0)
    assert (torch.linalg.vector_norm(x_mr[vel] - x_lu[vel])
            / torch.linalg.vector_norm(x_lu[vel])) <= 1e-8
    errs = []
    for x in (x_lu, x_mr):
        gf = GridFunction(X)
        gf.vec.data = x
        errs.append(errors(gf))
    (u_d, p_d), (u_m, p_m) = errs
    assert _rel(u_m, u_d) < 1e-8 and _rel(p_m, p_d) < 1e-8
    assert not x_mr.numpy()[~active.np].any()
