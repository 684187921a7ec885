"""Cut-rule construction of the port against the JAX package.

Seeded random level-set vertex values, with exact zeros and values below
the 1e-14 guard mixed in, go through ``ops.straightcut.cut_rule_element``
of both packages (JAX on the CPU in float64, the port with tensors on the
CPU): every output agrees to 1e-13 absolute.

Exact zeros snap to +1e-14 and make sliver sub-simplices.  Two things then
differ from the reference by more than rounding, and the test handles them
as follows:

- The reference measures an interface triangle by the square root of a Gram
  determinant, |u|^2 |v|^2 - (u.v)^2, which cancels for a sliver between
  O(1) edges and leaves up to ~1e-8 of spurious measure; the port sums the
  squares of u x v instead.  The reference runs here with that measure
  swapped in (``_gram_measure_exact``); everything else of it runs as is.
- A point of zero weight is padding (snapped to its simplex's centroid),
  and one of weight below 1e-13 moves an integral by less than the
  tolerance, so points are compared where both rules give them more;
  weights everywhere.
- Two opposite QUAD corners at zero make the OPTIMAL axis criterion an
  exact tie (bound_id == bound_xy in exact arithmetic, likewise the two
  smallest HEX bounds), which rounding breaks either way; such elements
  (``_ties``) are left out, and they are a minority.
"""
import zlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ngsxfem_tpu.ops import straightcut as jax_sc
from ngsxfem_tpu.ops import cuttables as jax_ct
from ngsxfem_tpu.mesh import mesh as jax_mesh
from ngsxfem_tpu_torch.ops import straightcut as sc
from ngsxfem_tpu_torch.ops import cuttables as ct
from ngsxfem_tpu_torch.mesh import mesh as tmesh

NVERT = {"segm": 2, "trig": 3, "quad": 4, "tet": 4, "hex": 8}
TOL = 1e-13


def _gram_measure_exact(edges):
    """The reference's ``_gram_measure`` with the interface-triangle area
    taken from the cross product (no cancellation)."""
    k, g = edges.shape[-2], edges.shape[-1]
    if k == 2 and g == 3:
        det = jnp.sum(jnp.cross(edges[..., 0, :], edges[..., 1, :]) ** 2, -1)
    elif k == 1 and g > 1:
        det = jnp.sum(edges[..., 0, :] ** 2, -1)
    else:
        return _GRAM_REF(edges)
    pos = det > 0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, det, 1.0)), 0.0)


_GRAM_REF = jax_sc._gram_measure


def _jax_rule(monkeypatch, et, v, order, policy):
    """The reference rule, traced afresh with the exact sliver measure."""
    import jax

    monkeypatch.setattr(jax_sc, "_gram_measure", _gram_measure_exact)
    raw = jax_sc.cut_rule_element.__wrapped__
    return jax.jit(lambda a: raw(et, a, order, policy))(jnp.asarray(v))


def _quad_ties(v):
    """QUAD elements whose OPTIMAL axis bounds tie within 1e-12."""
    c10, c01 = v[:, 1] - v[:, 0], v[:, 3] - v[:, 0]
    c11 = v[:, 2] - v[:, 1] - v[:, 3] + v[:, 0]
    gx = c10[:, None] + c11[:, None] * np.array([0.0, 0, 1, 1])
    gy = c01[:, None] + c11[:, None] * np.array([0.0, 1, 1, 0])
    gn = np.maximum(np.hypot(gx, gy), 1e-30)
    return np.abs((np.abs(gy) / gn).max(1) - (np.abs(gx) / gn).max(1)) < 1e-12


def _ties(et, v, order, policy):
    """Elements whose OPTIMAL axis choice is a tie within 1e-12: the
    element's own choice, or for a HEX that of one of its bilinear slices
    (built as ``multilinear.hex_cut_rule`` builds them)."""
    from ngsxfem_tpu_torch.ops import multilinear as ml
    from ngsxfem_tpu_torch.ops.gauss import gauss_legendre_01, _n_for_degree

    v = np.where(np.abs(v) < 1e-14, 1e-14, v)
    if policy != "OPTIMAL" or et not in ("quad", "hex"):
        return np.zeros(len(v), bool)
    if et == "quad":
        return _quad_ties(v)
    vt = torch.as_tensor(v)
    corners = torch.as_tensor(ct.REF_VERTS["hex"])[None]
    g2 = (tmesh.multilinear_grad("hex", vt, corners) ** 2).numpy()
    vsq = g2.max(1).sum(-1)
    q = (vsq[:, None, None] / np.maximum(vsq[:, None, None] - g2, 1e-30)).max(1)
    b = np.sort(np.sqrt(np.clip(1.0 - 1.0 / np.maximum(q, 1.0), 0, 1)), 1)
    tie = b[:, 1] - b[:, 0] < 1e-12
    sw = ml._hex_axis_choice(vt, policy).numpy()
    vc = np.where((sw == 1)[:, None], v[:, ml.HEX_SWAP_YZ],
                  np.where((sw == 2)[:, None], v[:, ml.HEX_SWAP_XZ], v))
    vc = torch.as_tensor(vc)
    roots = [ml._edge_root(vc[:, i], vc[:, i + 4]).numpy() for i in range(4)]
    br = np.sort(np.stack([0 * roots[0]] + roots + [0 * roots[0] + 1], -1), -1)
    tg, _ = gauss_legendre_01(_n_for_degree(order))
    z = (br[:, :5, None] + (br[:, 1:] - br[:, :5])[:, :, None] * tg).reshape(
        len(v), -1)
    vc = vc.numpy()
    sl = (1 - z)[..., None] * vc[:, None, :4] + z[..., None] * vc[:, None, 4:]
    return tie | _quad_ties(sl.reshape(-1, 4)).reshape(len(v), -1).any(1)


def _vals(et, n, seed):
    """Random vertex values; about a fifth of them exact zeros or tiny."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, NVERT[et]))
    pick = rng.random(v.shape)
    v[pick < 0.1] = 0.0
    v[(pick >= 0.1) & (pick < 0.2)] = 1e-15 * np.sign(
        rng.standard_normal(int(((pick >= 0.1) & (pick < 0.2)).sum())))
    return v


@pytest.mark.parametrize("et", ["segm", "trig", "tet", "quad", "hex"])
@pytest.mark.parametrize("policy", ["FIRST", "OPTIMAL", "FALLBACK"])
@pytest.mark.parametrize("order", [0, 2, 5])
def test_cut_rule_element_matches_jax(monkeypatch, et, policy, order):
    v = _vals(et, 64, seed=zlib.crc32(f"{et}-{policy}-{order}".encode()))
    rj = _jax_rule(monkeypatch, et, v, order, policy)
    rt = sc.cut_rule_element(et, torch.as_tensor(v), order, policy)
    rj = {k: np.asarray(a) for k, a in zip(rt._fields, rj)}
    rt = {k: a.numpy() for k, a in zip(rt._fields, rt)}
    keep = ~_ties(et, v, order, policy)
    assert keep.mean() > 0.6
    rj = {k: a[keep] for k, a in rj.items()}
    rt = {k: a[keep] for k, a in rt.items()}
    vol = (rj["w"] > TOL) & (rt["w"] > TOL)
    itf = (rj["w_if"] > TOL) & (rt["w_if"] > TOL)
    live = {"pts": vol, "side": vol, "pts_if": itf, "nref": itf}
    for name in rt:
        a, b = rj[name], rt[name]
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if name in live:
            a, b = a[live[name]], b[live[name]]
        assert np.max(np.abs(a - b), initial=0.0) <= TOL, name
    assert live["pts"].any() and live["pts_if"].any()


def test_tables_match_jax():
    for d in (1, 2, 3):
        tj, tt = jax_ct.simplex_cut_tables(d), ct.simplex_cut_tables(d)
        for k in tj:
            assert np.array_equal(tj[k], tt[k]), (d, k)
    assert ct.NSUB == jax_ct.NSUB and ct.NIF == jax_ct.NIF
    for et in ct.ET_SPLIT:
        assert np.array_equal(ct.ET_SPLIT[et], jax_ct.ET_SPLIT[et])
    assert tmesh.FACET_ET == jax_mesh.FACET_ET
    assert tmesh.EDGE_VERTS == jax_mesh.EDGE_VERTS


@pytest.mark.parametrize("et", ["segm", "trig", "quad", "tet", "hex"])
def test_geometry_maps_match_jax(et):
    """map_points / det_and_inv on random elements and points (the port
    returns one Jacobian per element on simplices)."""
    rng = np.random.default_rng(5)
    d = {"segm": 1, "trig": 2, "quad": 2, "tet": 3, "hex": 3}[et]
    coords = rng.standard_normal((7, NVERT[et], d)) + 3 * np.eye(
        NVERT[et], d)[None]
    pts = rng.random((7, 5, d))
    pj, Jj = jax_mesh.map_points(et, jnp.asarray(coords), jnp.asarray(pts))
    dj, ij = jax_mesh.det_and_inv(Jj)
    pt, Jt = tmesh.map_points(et, torch.as_tensor(coords), torch.as_tensor(pts))
    dt, it = tmesh.det_and_inv(Jt)
    assert np.allclose(np.asarray(pj), pt.numpy(), atol=1e-14, rtol=0)
    for a, b in ((Jj, Jt), (dj, dt), (ij, it)):
        b = torch.broadcast_to(b, a.shape).numpy()
        assert np.allclose(np.asarray(a), b, atol=1e-13, rtol=1e-13)
    gj = jax_mesh.geom_dshapes(et, jnp.asarray(pts))
    gt = tmesh.geom_dshapes(et, torch.as_tensor(pts))
    assert np.allclose(np.asarray(gj), gt.numpy(), atol=1e-15, rtol=0)


def test_cut_rule_is_differentiable():
    """The gradient of a cut measure with respect to the vertex values is
    finite, also with padded sub-simplices and zero values around."""
    v = torch.as_tensor(_vals("tet", 32, 3), dtype=torch.float64)
    v.requires_grad_(True)
    r = sc.cut_rule_element("tet", v, 2)
    ((r.w * (r.side == 0)).sum() + r.w_if.sum()).backward()
    assert torch.isfinite(v.grad).all()
