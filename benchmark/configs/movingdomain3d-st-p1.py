"""Configuration ``movingdomain3d-st-p1``: the program's slab and its
comparison.

The space-time CutFEM step of the reference's ``py_tutorials/
moving_domain.py`` in 3D, as ``ngsxfem_tpu_torch/examples/moving_domain3d.py``
writes it, through the public API only: ``H1(order=1, dgjumps=True) x
ScalarTimeFE(1)``, the sphere's level set interpolated over the slab
(``SpaceTimeInterpolateToP1``) and restricted to its bottom
(``RestrictGFInTime``), ``CutInfo.Update(time_order=1)``, the volume
integral ``dt(u) v + dt (w.grad(u) v + grad(u).grad(v))`` at time order 3,
the upwind coupling ``fix_t(u, 0) fix_t(v, 0)`` to the slab below, the
facet-patch ghost penalty at time order 2 (the tutorial's ``2 k_t``; at the
example's time order 1 its one time point stabilises only the mean in time,
and the active block is singular to rounding at some positions), the load
``dt f v + uold fix_t(v, 0)``, ``a.mat.Inverse(GetDofsOfElements(W,
hasneg))`` (the default method: a non-symmetric matrix, so the host LU)
and the solution's top, ``RestrictGFInTime(..., 1.0, uold)``, carried to
the next slab.  Float64.

Each step is one slab: the traffic's walk gives the centre at its top, the
previous step's at its bottom, and the slab's velocity is their chord over
the slab's length.  A step returns the solution at the bottom that it
started from, the previous slab's top as the driver reads it from that
slab's solution (the second time node's block of the time-major dofs), so
the comparison works each sampled slab out from it, and a program that
does not carry its solution from slab to slab differs there.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from harness import judge
from reference import cutp1, stcut


def setup(sizes, traffic, device):
    import ngsxfem_tpu_torch as api

    if not traffic.get("walk"):
        raise ValueError("movingdomain3d-st-p1 runs a moving sphere: give a "
                         "walk")
    nx = sizes["nx"]
    lo, hi = sizes["box"]
    w = hi - lo
    mesh = api.MakeStructured3DMesh(
        hexes=False, nx=nx, ny=nx, nz=nx,
        mapping=lambda a, b, c: (lo + w * a, lo + w * b, lo + w * c))
    dt, R = sizes["slab"], sizes["radius"]
    bot = [api.Parameter(v) for v in sizes["centre"]]
    vel = [api.Parameter(0.0) for _ in range(3)]
    x = (api.x, api.y, api.z)
    st = SimpleNamespace(api=api, mesh=mesh, bot=bot, vel=vel, dt=dt,
                         sizes=sizes, prev=tuple(sizes["centre"]))
    # the centre at the slab's reference time tref in [0, 1]
    d = [x[i] - (bot[i] + vel[i] * (dt * api.tref)) for i in range(3)]
    rho2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    st.levelset = api.sqrt(rho2) - R
    st.coeff_f = -(8.0 * rho2 + 12.0 * (rho2 - R * R)) / R ** 4
    st.wind = api.CoefficientFunction(tuple(vel))
    st.Vh = api.H1(mesh, order=sizes["order"], dgjumps=True, device=device)
    st.W = api.SpaceTimeFESpace(st.Vh, api.ScalarTimeFE(sizes["order_time"]))
    st.lset_st = api.GridFunction(st.W)
    st.lset_bot = api.GridFunction(api.H1(mesh, order=1, device=device))
    st.uold = api.GridFunction(st.Vh)
    st.gfu = api.GridFunction(st.W)
    st.ci = api.CutInfo(mesh, device=device)
    # the manufactured solution at the configuration's centre
    s0 = sum((x[i] - sizes["centre"][i]) * (x[i] - sizes["centre"][i])
             for i in range(3))
    st.uold.Set((s0 - R * R) * (s0 - R * R) / R ** 4)
    st.top = st.uold.vec.data.clone()
    st.meta = _index_maps(api, st.Vh, sizes)
    return st


def _index_maps(api, Vh, sizes):
    """Lattice coordinates of the program's spatial dofs (through ``Set``
    of the coordinate functions) and of its elements' vertex sums: the map
    of its outputs to the reference's numbering."""
    nx = sizes["nx"]
    lo, hi = sizes["box"]
    gf = api.GridFunction(Vh)
    coords = []
    for cf in (api.x, api.y, api.z):
        gf.Set(cf)
        coords.append(torch.as_tensor(gf.vec.data).detach().cpu().clone())
    dof_ijk = torch.round((torch.stack(coords, 1) - lo) / (hi - lo) * nx)
    mesh = Vh.mesh
    vijk = torch.round((torch.as_tensor(mesh.vertices_np) - lo)
                       / (hi - lo) * nx)
    el_sum = vijk[torch.as_tensor(mesh.elements_np).long()].sum(1)
    return {"dof_ijk": dof_ijk.long(), "el_sum": el_sum.long()}


def _cut(st):
    """The slab's space-time level set and its bottom, the cut marks, the
    ghost-penalty facets and the active dofs."""
    api = st.api
    api.SpaceTimeInterpolateToP1(st.levelset, api.tref, st.lset_st)
    api.RestrictGFInTime(spacetime_gf=st.lset_st, reference_time=0.0,
                         space_gf=st.lset_bot)
    st.ci.Update(st.lset_st, time_order=st.sizes["order_time"])
    hasneg = st.ci.GetElementsOfType(api.HASNEG)
    hasif = st.ci.GetElementsOfType(api.IF)
    return {"hasneg": hasneg, "hasif": hasif,
            "facets": api.GetFacetsWithNeighborTypes(st.mesh, a=hasneg,
                                                     b=hasif),
            "free": api.GetDofsOfElements(st.W, hasneg)}


def _time_orders(st):
    """Time orders of the volume integrals and of the ghost penalty."""
    kt = st.sizes["order_time"]
    return 2 * kt + 1, 2 * kt


def _bilinear(st, geom):
    api = st.api
    u, v = st.W.TnT()
    h = api.specialcf.mesh_size
    dt, gamma = st.dt, st.sizes["ghost_penalty"]
    vol_order, gp_order = _time_orders(st)
    neg = {"levelset": st.lset_st, "domain_type": api.NEG}
    bot = {"levelset": st.lset_bot, "domain_type": api.NEG}
    a = api.BilinearForm(st.W)
    a += api.SymbolicBFI(
        neg, form=api.dt(u) * v
        + dt * ((st.wind * api.grad(u)) * v + api.grad(u) * api.grad(v)),
        time_order=vol_order, definedonelements=geom["hasneg"])
    a += api.SymbolicBFI(bot, form=api.fix_t(u, 0.0) * api.fix_t(v, 0.0),
                         definedonelements=geom["hasneg"])
    a += api.SymbolicFacetPatchBFI(
        form=dt * gamma / (h * h) * (u - u.Other()) * (v - v.Other()),
        time_order=gp_order, definedonelements=geom["facets"])
    return a


def _linear(st, geom):
    api = st.api
    v = st.W.TestFunction()
    vol_order, _ = _time_orders(st)
    f = api.LinearForm(st.W)
    f += api.SymbolicLFI({"levelset": st.lset_st, "domain_type": api.NEG},
                         form=st.dt * st.coeff_f * v, time_order=vol_order,
                         definedonelements=geom["hasneg"])
    f += api.SymbolicLFI({"levelset": st.lset_bot, "domain_type": api.NEG},
                         form=st.uold * api.fix_t(v, 0.0),
                         definedonelements=geom["hasneg"])
    return f


def step(st, inp, spans):
    api = st.api
    prev, uold = st.prev, st.top
    with spans("cut"):
        for bot, vel, b, t in zip(st.bot, st.vel, prev, inp.centre):
            bot.Set(b)
            vel.Set((t - b) / st.dt)
        geom = _cut(st)
    with spans("assemble"):
        a = _bilinear(st, geom)
        f = _linear(st, geom)
        a.Assemble()
        f.Assemble()
    with spans("inverse"):
        inv = a.mat.Inverse(geom["free"])
    with spans("solve"):
        u = inv * f.vec
        st.gfu.vec.data = u
        api.RestrictGFInTime(spacetime_gf=st.gfu, reference_time=1.0,
                             space_gf=st.uold)
    st.prev = tuple(inp.centre)
    # the top of the time-major dofs: the second Gauss-Lobatto node, t = 1
    st.top = u[st.Vh.ndof:].clone()
    return {"geom": geom, "mat": a.mat, "rhs": f.vec.data, "sol": u,
            "uold": uold, "bottom": prev}


def work(st, out):
    """No Krylov solve: the slab's solve is the host LU."""
    return {}


def release(st):
    return st.meta


def _maps(lat, meta):
    """Reference vertex of each program dof, reference element of each
    program element."""
    n1 = lat.nx + 1
    dev = lat.X.device
    d = meta["dof_ijk"].to(dev)
    vid = (d[:, 0] * n1 + d[:, 1]) * n1 + d[:, 2]
    K = 4 * n1

    def key(s):
        return (s[:, 0] * K + s[:, 1]) * K + s[:, 2]

    ijk = torch.stack([lat.tets // (n1 * n1), lat.tets // n1 % n1,
                       lat.tets % n1], 2).sum(1)
    rkey, order = torch.sort(key(ijk))
    pkey = key(meta["el_sum"].to(dev))
    pos = torch.searchsorted(rkey, pkey).clamp(max=rkey.numel() - 1)
    found = rkey[pos] == pkey
    return vid, torch.where(found, order[pos], -1)


def canonical(out, lat, vid, emap):
    """The program's outputs on the reference's space-time nodes (node
    ``v`` at time node ``a`` is ``a * nv + v``) and elements."""
    dev = lat.X.device
    sid = torch.cat([vid, vid + lat.nv])  # program space-time dof -> node

    def on_nodes(v, dtype=torch.float64):
        o = torch.zeros(2 * lat.nv, dtype=dtype, device=dev)
        o[sid] = torch.as_tensor(v).to(device=dev, dtype=dtype)
        return o

    def on_elements(ba):
        o = torch.zeros(lat.ne, dtype=torch.bool, device=dev)
        m = torch.as_tensor(ba.np, device=dev)
        ok = emap >= 0
        o[emap[ok]] = m[ok]
        return o if bool(ok.all()) else ~o  # an unmapped element: all differ

    mat = out["mat"]
    rows, cols = mat.rows.to(dev).long(), mat.cols.to(dev).long()
    vals = mat.vals.to(dev).to(torch.float64)

    def matvec(x):
        y = torch.zeros(mat.shape[0], dtype=torch.float64, device=dev)
        y.index_add_(0, rows, vals * x[sid][cols])
        return on_nodes(y)

    geom = out["geom"]
    return {"hasneg": on_elements(geom["hasneg"]),
            "cut": on_elements(geom["hasif"]),
            "active": on_nodes(geom["free"].np, torch.bool),
            "matvec": matvec, "rhs": on_nodes(out["rhs"]),
            "sol": on_nodes(out["sol"])}


def reference(lat, sizes, bottom, top, uold):
    """The reference slab and its solution, in the dtype of the lattice's
    coordinates; ``uold`` on the reference's vertices."""
    S = stcut.assemble(lat, bottom, top, sizes["radius"], sizes["slab"],
                       sizes["ghost_penalty"], uold.to(lat.X.dtype))
    return S, stcut.solve(S)


def compare(sizes, traffic, samples, meta, device, seed):
    """Numbers of each sampled slab against the float64 reference, which
    starts from the program's own bottom values."""
    lat = cutp1.Lattice(sizes["nx"], *sizes["box"], device)
    vid, emap = _maps(lat, meta)
    probe = _probe(lat, seed)
    out = []
    for inp, o in samples:
        uold = torch.zeros(lat.nv, dtype=torch.float64, device=lat.X.device)
        uold[vid] = o["uold"].to(lat.X.device, torch.float64)
        S, x = reference(lat, sizes, o["bottom"], inp.centre, uold)
        out.append(judge.numbers(canonical(o, lat, vid, emap), S, x, probe))
    return out


def _bottom_of(traffic, sizes, index):
    """The walk's position before step ``index`` (its own at step 0)."""
    from harness.traffic import _curve

    path = _curve(traffic["walk"], sizes)
    prev = c = next(path)
    for _ in range(index):
        prev, c = c, next(path)
    return prev


def control(sizes, traffic, inputs, device, seed):
    """The comparison's numbers of the reference computed in float32 in
    the program's place, each slab from the manufactured solution at its
    bottom."""
    lat = cutp1.Lattice(sizes["nx"], *sizes["box"], device)
    lat32 = lat.with_dtype(torch.float32)
    probe = _probe(lat, seed)
    R2 = sizes["radius"] ** 2
    out = []
    for inp in inputs:
        bottom = _bottom_of(traffic, sizes, inp.index)
        c = torch.as_tensor(bottom, dtype=torch.float64, device=lat.X.device)
        s = ((lat.X - c) ** 2).sum(1)
        uold = (s - R2) ** 2 / (R2 * R2)
        S, x = reference(lat, sizes, bottom, inp.centre, uold)
        S32, x32 = reference(lat32, sizes, bottom, inp.centre, uold)
        canon = {"hasneg": S32.hasneg, "cut": S32.cut, "active": S32.active,
                 "matvec": lambda v: S32.matvec(v.float()).double(),
                 "rhs": S32.rhs.double(), "sol": x32.double()}
        out.append(judge.numbers(canon, S, x, probe))
    return out


def _probe(lat, seed):
    g = torch.Generator(device=lat.X.device).manual_seed(int(seed) % 2 ** 62)
    return torch.rand(2 * lat.nv, dtype=torch.float64, device=lat.X.device,
                      generator=g) * 2 - 1
