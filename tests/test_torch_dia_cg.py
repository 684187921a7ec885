"""Fused Jacobi-PCG of the PyTorch port (solvers/dia_cg.py).

On the CPU the wrapper runs its plain version, held here against the JAX
package's Pallas kernel (interpret mode, as tests/test_pallas_cg.py runs it)
and against the JAX ``krylov.cg`` + ``dia_matvec`` path, at the reference's
thresholds (tests/test_pallas_cg.py:72-89: rel 5e-5, residual 5e-5 ||b||).
The CUDA kernel itself runs only on a card: its test skips without one.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ngsxfem_tpu.solvers import krylov as jax_krylov
from ngsxfem_tpu.solvers import pallas_cg
from ngsxfem_tpu.solvers import sparse as jax_sparse
from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson
from ngsxfem_tpu_torch.solvers import dia_cg, krylov, sparse

_CACHE = {}


def _setup(device="cpu"):
    """The port's nx=6 flagship operator (f32), rhs and Jacobi inverse."""
    if device not in _CACHE:
        m = UnfittedPoisson(nx=6, dim=3, order=1, dtype=torch.float32,
                            device=device)
        st = m.dia_structure()
        V, _ = m.assemble_vals_lattice(m.vertices, m.lset, st)
        offs = st["offsets"]
        k0 = int(np.searchsorted(offs, 0))
        b = torch.as_tensor(np.where(m.active_dofs[st["perm_inv"]], 1.0, 0.0),
                            dtype=torch.float32, device=device)
        dinv = torch.where(V[k0].abs() > 1e-30, 1.0 / V[k0], 1.0)
        _CACHE[device] = (offs, V, b, dinv)
    return _CACHE[device]


def _jax(*ts):
    return [jnp.asarray(t.cpu().numpy()) for t in ts]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("iters", [1, 12])
def test_plain_matches_pallas_interpret(iters):
    offs, V, b, dinv = _setup()
    xf, rf = pallas_cg.dia_cg_fused(offs, *_jax(V, b, dinv), iters,
                                    plane=7 * 7, interpret=True)
    xt, rt = dia_cg.dia_cg_fused_plain(offs, V, b, dinv, iters)
    assert _rel(xt.numpy(), xf) < 5e-5
    assert abs(float(rt) - float(rf)) <= 5e-5 * float(torch.linalg.vector_norm(b))


@pytest.mark.parametrize("iters", [1, 12])
def test_plain_matches_reference_cg(iters):
    offs, V, b, dinv = _setup()
    Vj, bj, dj = _jax(V, b, dinv)
    xr, _, rr = jax_krylov.cg(lambda x: jax_sparse.dia_matvec(offs, Vj, x), bj,
                              M=lambda r: dj * r, maxiter=iters, tol=0.0)
    xt, rt = dia_cg.dia_cg_fused_plain(offs, V, b, dinv, iters)
    assert _rel(xt.numpy(), xr) < 5e-5
    assert abs(float(rt) - float(rr)) <= 5e-5 * float(torch.linalg.vector_norm(b))


def test_plain_reduces_residual():
    offs, V, b, dinv = _setup()
    _, rt = dia_cg.dia_cg_fused_plain(offs, V, b, dinv, 40)
    assert float(rt) < 0.05 * float(torch.linalg.vector_norm(b))


def test_sym_matvec_equals_dia_matvec_bitwise():
    """Upper diagonals in table order give dia_matvec's sums exactly."""
    offs, V, _, _ = _setup()
    p = torch.as_tensor(np.random.default_rng(5).standard_normal(V.shape[1]),
                        dtype=torch.float32)
    assert torch.equal(dia_cg._sym_dia_matvec(V, dia_cg._terms(offs), p),
                       sparse.dia_matvec(offs, V, p))


@pytest.mark.parametrize("iters", [0, 1, 12, 50])
def test_wrapper_on_cpu_equals_port_cg_bitwise(iters):
    """On CPU tensors the wrapper runs the plain version (no kernel launch),
    which reproduces the port's krylov.cg + dia_matvec bit for bit — the
    property the CUDA kernel is held to on the card."""
    offs, V, b, dinv = _setup()
    before = dia_cg.launches
    xw, rw = dia_cg.dia_cg_fused(offs, V, b, dinv, iters)
    assert dia_cg.launches == before
    xr, _, rr = krylov.cg(lambda x: sparse.dia_matvec(offs, V, x), b,
                          M=lambda r: dinv * r, maxiter=iters, tol=0.0)
    assert torch.equal(xw, xr) and torch.equal(rw, rr)


def test_rejects_asymmetric_offsets():
    with pytest.raises(ValueError):
        dia_cg._upper([-1, 0, 2])
    _, V, b, dinv = _setup()
    with pytest.raises(ValueError):
        dia_cg.dia_cg_fused([-1, 0, 2], V[:3], b, dinv, 2)


@pytest.mark.parametrize("bad", ["n_off", "b_len", "dinv_dtype",
                                 "noncontig", "iters"])
def test_rejects_bad_inputs(bad):
    offs, V, b, dinv = _setup()
    args = dict(offsets=offs, vals=V, b=b, dinv=dinv, iters=3)
    if bad == "n_off":
        args["vals"] = V[:-1]
    elif bad == "b_len":
        args["b"] = b[:-1]
    elif bad == "dinv_dtype":
        args["dinv"] = dinv.double()
    elif bad == "noncontig":
        args["vals"] = V.t().contiguous().t()
    else:
        args["iters"] = -1
    with pytest.raises(ValueError):
        dia_cg.dia_cg_fused(**args)


def test_kernel_matches_plain_on_cuda():
    """The CUDA kernel against its plain version, on the card: bitwise
    repeatable and within 5e-4 (the reference's on-hardware bound,
    tests/test_pallas_cg.py:105).  Needs a CUDA device and nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    offs, V, b, dinv = _setup("cuda")
    for iters in (1, 12, 40):
        before = dia_cg.launches
        xk, rk = dia_cg.dia_cg_fused(offs, V, b, dinv, iters)
        xk2, rk2 = dia_cg.dia_cg_fused(offs, V, b, dinv, iters)
        assert dia_cg.launches == before + 2
        xp, rp = dia_cg.dia_cg_fused_plain(offs, V, b, dinv, iters)
        torch.cuda.synchronize()
        assert torch.equal(xk, xk2) and torch.equal(rk, rk2)
        assert _rel(xk.cpu().numpy(), xp.cpu().numpy()) <= 5e-4
        assert abs(float(rk) - float(rp)) <= 5e-4 * float(
            torch.linalg.vector_norm(b))
