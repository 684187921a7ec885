"""Driver of the configuration ``fictdom3d-p1-forms``.

The weak form of ``ngsxfem_tpu_torch/examples/fictdom3d.py`` at order 1
(the reference's ``py_tutorials/fictdom_ghostpen.py`` in 3D) through the
public API only: P1 level set of a sphere, ``CutInfo``, Nitsche terms on
the interface, the facet-patch ghost penalty, ``a.mat.Inverse(freedofs)``
(on the card Jacobi-CG through the ELL kernel), float64.

With a walk in the traffic a step moves the sphere and does everything
again: level set, cut marks, both forms, the ``Inverse`` and the solve.
Without one, set-up builds the geometry, ``a`` and its ``Inverse`` once,
and a step assembles the step's load and solves.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from harness import judge
from reference import cutp1

SOLVE_TOL = 1e-14       # reference CG, relative residual of its recurrence
SOLVE_MAXITER = 50000


def setup(sizes, traffic, device):
    import ngsxfem_tpu_torch as api

    nx = sizes["nx"]
    lo, hi = sizes["box"]
    w = hi - lo
    mesh = api.MakeStructured3DMesh(
        hexes=False, nx=nx, ny=nx, nz=nx,
        mapping=lambda a, b, c: (lo + w * a, lo + w * b, lo + w * c))
    c = [api.Parameter(v) for v in sizes["centre"]]
    a0 = api.Parameter(sizes["load"][0])
    av = [api.Parameter(v) for v in sizes["load"][1]]
    x, y, z = api.x, api.y, api.z
    st = SimpleNamespace(api=api, mesh=mesh, centre=c, a0=a0, av=av,
                         moving=bool(traffic.get("walk")), sizes=sizes)
    st.levelset = api.sqrt((x - c[0]) * (x - c[0]) + (y - c[1]) * (y - c[1])
                           + (z - c[2]) * (z - c[2])) - sizes["radius"]
    st.coeff_f = a0 + av[0] * x + av[1] * y + av[2] * z
    st.lsetp1 = api.GridFunction(api.H1(mesh, order=1, device=device))
    st.Vh = api.H1(mesh, order=sizes["order"], dgjumps=True, device=device)
    st.ci = api.CutInfo(mesh, device=device)
    st.meta = _index_maps(api, st.Vh, sizes)
    st.nnz = {}
    if not st.moving:
        st.geom = _cut(st)
        st.a = _bilinear(st, st.geom)
        st.a.Assemble()
        st.inv = st.a.mat.Inverse(st.geom["free"])
        st.f = _linear(st, st.geom)
    return st


def _index_maps(api, Vh, sizes):
    """Lattice coordinates of the program's dofs (through ``Set`` of the
    coordinate functions) and of its elements' vertex sums: the map of
    its outputs to the reference's numbering."""
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
    """Level set, cut marks, ghost-penalty facets and free dofs of the
    sphere at the centre's current parameters."""
    api = st.api
    api.InterpolateToP1(st.levelset, st.lsetp1)
    st.ci.Update(st.lsetp1)
    hasneg = st.ci.GetElementsOfType(api.HASNEG)
    hasif = st.ci.GetElementsOfType(api.IF)
    return {"hasneg": hasneg, "hasif": hasif,
            "facets": api.GetFacetsWithNeighborTypes(st.mesh, a=hasneg,
                                                     b=hasif),
            "free": api.GetDofsOfElements(st.Vh, hasneg)}


def _bilinear(st, geom):
    api = st.api
    order = st.sizes["order"]
    h = api.specialcf.mesh_size
    lam = st.sizes["nitsche"] * order * order / h
    gamma = st.sizes["ghost_penalty"]
    n = 1.0 / api.Norm(api.grad(st.lsetp1)) * api.grad(st.lsetp1)
    u, v = st.Vh.TnT()
    neg = {"levelset": st.lsetp1, "domain_type": api.NEG}
    itf = {"levelset": st.lsetp1, "domain_type": api.IF}
    a = api.BilinearForm(st.Vh)
    a += api.SymbolicBFI(neg, form=api.grad(u) * api.grad(v),
                         definedonelements=geom["hasneg"])
    a += api.SymbolicBFI(itf, form=-(api.grad(u) * n) * v
                         - (api.grad(v) * n) * u + lam * u * v)
    a += api.SymbolicFacetPatchBFI(
        form=gamma / (h * h) * (u - u.Other()) * (v - v.Other()),
        definedonelements=geom["facets"])
    return a


def _linear(st, geom):
    api = st.api
    v = st.Vh.TestFunction()
    f = api.LinearForm(st.Vh)
    f += api.SymbolicLFI({"levelset": st.lsetp1, "domain_type": api.NEG},
                         form=st.coeff_f * v,
                         definedonelements=geom["hasneg"])
    return f


def step(st, inp, spans):
    from ngsxfem_tpu_torch.solvers import ell_spmv

    st.a0.Set(inp.load[0])
    for p, val in zip(st.av, inp.load[1]):
        p.Set(val)
    if st.moving:
        with spans("cut"):
            for p, val in zip(st.centre, inp.centre):
                p.Set(val)
            geom = _cut(st)
        with spans("assemble"):
            a = _bilinear(st, geom)
            f = _linear(st, geom)
            a.Assemble()
            f.Assemble()
        with spans("inverse"):
            inv = a.mat.Inverse(geom["free"])
    else:
        geom, a, f, inv = st.geom, st.a, st.f, st.inv
        with spans("assemble"):
            f.Assemble()
    launches = ell_spmv.launches
    with spans("solve"):
        u = inv * f.vec
    return {"geom": geom, "mat": a.mat, "rhs": f.vec.data, "sol": u,
            "launches": ell_spmv.launches - launches}


def work(st, out):
    """The solve's products and iterations as Jacobi-CG needs them: one
    product per iteration (the counter also counts the product with the
    zero start, which the algorithm does not need), each reading the
    operator's real slots, and vectors as long as the free dofs, the
    unknowns of the system (the program's vectors span every dof of the
    mesh: a layout's length, not the problem's)."""
    mat = out["mat"]
    key = id(mat)
    if key not in st.nnz:
        n = mat.shape[1]
        st.nnz = {key: (int(torch.unique(mat.rows.long() * n
                                         + mat.cols.long()).numel()),
                        int(out["geom"]["free"].np.sum()))}
    it = max(out["launches"] - 1, 0)
    (nnz, n), size = st.nnz[key], mat.vals.element_size()
    return {"solve": {"products": [(it, nnz, n, size, 4)],
                      "iterations": [(it, n, size)]}}


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
    dev = lat.X.device

    def on_vertices(v, dtype=torch.float64):
        o = torch.zeros(lat.nv, dtype=dtype, device=dev)
        o[vid] = torch.as_tensor(v).to(device=dev, dtype=dtype)
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
        y.index_add_(0, rows, vals * x[vid][cols])
        return on_vertices(y)

    geom = out["geom"]
    return {"hasneg": on_elements(geom["hasneg"]),
            "cut": on_elements(geom["hasif"]),
            "active": on_vertices(geom["free"].np, torch.bool),
            "matvec": matvec, "rhs": on_vertices(out["rhs"]),
            "sol": on_vertices(out["sol"])}


def reference(lat, sizes, inp):
    """The reference system and solution of one step's inputs, in the
    dtype of the lattice's coordinates."""
    c = torch.as_tensor(inp.centre, dtype=lat.X.dtype, device=lat.X.device)
    phi = torch.linalg.vector_norm(lat.X - c, dim=1) - sizes["radius"]
    order = sizes["order"]
    S = cutp1.assemble(lat, phi, sizes["nitsche"] * order * order,
                       sizes["ghost_penalty"], inp.load)
    x, _, _ = cutp1.pcg(S.csr(), S.rhs, S.active,
                        SOLVE_TOL if phi.dtype == torch.float64 else 1e-6,
                        SOLVE_MAXITER)
    return S, x


def compare(sizes, traffic, samples, meta, device, seed):
    """Numbers of each sampled step against the float64 reference."""
    lat = cutp1.Lattice(sizes["nx"], *sizes["box"], device)
    vid, emap = _maps(lat, meta)
    probe = _probe(lat, seed)
    out = []
    for inp, o in samples:
        S, x = reference(lat, sizes, inp)
        out.append(judge.numbers(canonical(o, lat, vid, emap), S, x, probe))
    return out


def control(sizes, traffic, inputs, device, seed):
    """The comparison's numbers of the reference computed in float32 in
    the program's place."""
    lat = cutp1.Lattice(sizes["nx"], *sizes["box"], device)
    lat32 = lat.with_dtype(torch.float32)
    probe = _probe(lat, seed)
    out = []
    for inp in inputs:
        S, x = reference(lat, sizes, inp)
        S32, x32 = reference(lat32, sizes, inp)
        canon = {"hasneg": S32.hasneg, "cut": S32.cut, "active": S32.active,
                 "matvec": lambda v: S32.matvec(v.float()).double(),
                 "rhs": S32.rhs.double(), "sol": x32.double()}
        out.append(judge.numbers(canon, S, x, probe))
    return out


def _probe(lat, seed):
    g = torch.Generator(device=lat.X.device).manual_seed(int(seed) % 2 ** 62)
    return torch.rand(lat.nv, dtype=torch.float64, device=lat.X.device,
                      generator=g) * 2 - 1
