"""Configuration ``fictdom3d-p2iso``: the program's step and its comparison.

The weak form of ``ngsxfem_tpu_torch/examples/fictdom3d.py`` with
``isoparametric=True`` at order 2 (the reference's
``py_tutorials/fictdom_ghostpen.py`` with ``lsetcurving``'s
``LevelSetMeshAdaptation``, in 3D) through the public API only: the
order-2 deformation of the mesh to the sphere's level set, ``CutInfo`` of
its P1 interpolant, Nitsche terms on the interface and the facet-patch
ghost penalty on the deformed elements, ``a.mat.Inverse(freedofs)`` (on
the card Jacobi-CG through the ELL kernel), float64.

Each step moves the sphere along the traffic's walk and does everything
again: the deformation (unset, computed, set), the cut marks, both forms,
the ``Inverse`` and the solve.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from harness import judge
from reference import isop2

SOLVE_TOL = 1e-14       # reference CG, relative residual of its recurrence
SOLVE_MAXITER = 50000


def setup(sizes, traffic, device):
    import ngsxfem_tpu_torch as api

    if not traffic.get("walk"):
        raise ValueError("fictdom3d-p2iso runs a moving sphere: give a walk")
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
                         sizes=sizes)
    st.levelset = api.sqrt((x - c[0]) * (x - c[0]) + (y - c[1]) * (y - c[1])
                           + (z - c[2]) * (z - c[2])) - sizes["radius"]
    st.coeff_f = a0 + av[0] * x + av[1] * y + av[2] * z
    st.lsa = api.LevelSetMeshAdaptation(
        mesh, order=sizes["order"], threshold=sizes["threshold"],
        discontinuous_qn=True, device=device)
    st.Vh = api.H1(mesh, order=sizes["order"], dgjumps=True, device=device)
    st.ci = api.CutInfo(mesh, device=device)
    st.meta = _index_maps(api, st.Vh, st.lsa.deform_space, sizes)
    st.nnz = {}
    return st


def _index_maps(api, Vh, deform_space, sizes):
    """Coordinates on the doubled lattice of the program's dofs and of its
    deformation's dofs (through ``Set`` of the coordinate functions, on the
    undeformed mesh), and the lattice coordinates of its elements' vertex
    sums: the map of its outputs to the reference's numbering."""
    nx = sizes["nx"]
    lo, hi = sizes["box"]

    def ijk(coords):
        return torch.round((coords - lo) / (hi - lo) * (2 * nx)).long()

    gf = api.GridFunction(Vh)
    coords = []
    for cf in (api.x, api.y, api.z):
        gf.Set(cf)
        coords.append(torch.as_tensor(gf.vec.data).detach().cpu().clone())
    dgf = api.GridFunction(deform_space)
    dgf.Set(api.CoefficientFunction((api.x, api.y, api.z)))
    dc = torch.as_tensor(dgf.vec.data).detach().cpu().reshape(3, -1).T
    mesh = Vh.mesh
    vijk = torch.round((torch.as_tensor(mesh.vertices_np) - lo)
                       / (hi - lo) * nx)
    el_sum = vijk[torch.as_tensor(mesh.elements_np).long()].sum(1)
    return {"dof_ijk": ijk(torch.stack(coords, 1)), "deform_ijk": ijk(dc),
            "el_sum": el_sum.long()}


def _cut(st):
    """Deformation, cut marks, ghost-penalty facets and free dofs of the
    sphere at the centre's current parameters; the mesh holds the
    deformation on return."""
    api = st.api
    st.mesh.UnsetDeformation()
    deform = st.lsa.CalcDeformation(st.levelset)
    st.mesh.SetDeformation(deform)
    st.ci.Update(st.lsa.lset_p1)
    hasneg = st.ci.GetElementsOfType(api.HASNEG)
    hasif = st.ci.GetElementsOfType(api.IF)
    return {"hasneg": hasneg, "hasif": hasif,
            "facets": api.GetFacetsWithNeighborTypes(st.mesh, a=hasneg,
                                                     b=hasif),
            "free": api.GetDofsOfElements(st.Vh, hasneg)}


def _bilinear(st, geom):
    api = st.api
    order = st.sizes["order"]
    lsetp1 = st.lsa.lset_p1
    h = api.specialcf.mesh_size
    lam = st.sizes["nitsche"] * order * order / h
    gamma = st.sizes["ghost_penalty"]
    n = 1.0 / api.Norm(api.grad(lsetp1)) * api.grad(lsetp1)
    u, v = st.Vh.TnT()
    neg = {"levelset": lsetp1, "domain_type": api.NEG}
    itf = {"levelset": lsetp1, "domain_type": api.IF}
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
    f += api.SymbolicLFI({"levelset": st.lsa.lset_p1,
                          "domain_type": api.NEG},
                         form=st.coeff_f * v,
                         definedonelements=geom["hasneg"])
    return f


def step(st, inp, spans):
    from ngsxfem_tpu_torch.solvers import ell_spmv

    st.a0.Set(inp.load[0])
    for p, val in zip(st.av, inp.load[1]):
        p.Set(val)
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
    launches = ell_spmv.launches
    with spans("solve"):
        u = inv * f.vec
    return {"geom": geom, "mat": a.mat, "rhs": f.vec.data, "sol": u,
            "deform": st.lsa.deform.vec.data.clone(),
            "launches": ell_spmv.launches - launches}


def work(st, out):
    """The solve's products and iterations as Jacobi-CG needs them: one
    product per iteration (the counter also counts the product with the
    zero start, which the algorithm does not need), each reading the
    operator's real slots, and vectors as long as the free dofs."""
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
    st.mesh.UnsetDeformation()
    return st.meta


def _maps(m, meta):
    """Reference node of each program dof and of each dof of its
    deformation's scalar space, reference element of each program
    element."""
    n1, N1 = m.nx + 1, m.N1
    dev = m.X.device

    def node(ijk):
        d = ijk.to(dev)
        return (d[:, 0] * N1 + d[:, 1]) * N1 + d[:, 2]

    K = 4 * n1

    def key(s):
        return (s[:, 0] * K + s[:, 1]) * K + s[:, 2]

    ijk = torch.stack([m.tets // (n1 * n1), m.tets // n1 % n1,
                       m.tets % n1], 2).sum(1)
    rkey, order = torch.sort(key(ijk))
    pkey = key(meta["el_sum"].to(dev))
    pos = torch.searchsorted(rkey, pkey).clamp(max=rkey.numel() - 1)
    found = rkey[pos] == pkey
    return (node(meta["dof_ijk"]), node(meta["deform_ijk"]),
            torch.where(found, order[pos], -1))


def canonical(out, m, nid, emap):
    dev = m.X.device

    def on_nodes(v, dtype=torch.float64):
        o = torch.zeros(m.nn, dtype=dtype, device=dev)
        o[nid] = torch.as_tensor(v).to(device=dev, dtype=dtype)
        return o

    def on_elements(ba):
        o = torch.zeros(m.ne, dtype=torch.bool, device=dev)
        mk = torch.as_tensor(ba.np, device=dev)
        ok = emap >= 0
        o[emap[ok]] = mk[ok]
        return o if bool(ok.all()) else ~o  # an unmapped element: all differ

    mat = out["mat"]
    rows, cols = mat.rows.to(dev).long(), mat.cols.to(dev).long()
    vals = mat.vals.to(dev).to(torch.float64)

    def matvec(x):
        y = torch.zeros(mat.shape[0], dtype=torch.float64, device=dev)
        y.index_add_(0, rows, vals * x[nid][cols])
        return on_nodes(y)

    geom = out["geom"]
    return {"hasneg": on_elements(geom["hasneg"]),
            "cut": on_elements(geom["hasif"]),
            "active": on_nodes(geom["free"].np, torch.bool),
            "matvec": matvec, "rhs": on_nodes(out["rhs"]),
            "sol": on_nodes(out["sol"])}


def deform_gap(D, D_ref, h):
    """max over the nodes of |d - d_ref| / h."""
    return float(torch.linalg.vector_norm(D.double() - D_ref, dim=1).max()
                 / h)


def reference(m, sizes, inp):
    """The reference system and solution of one step's inputs, in the
    dtype of the mesh's coordinates."""
    S = isop2.assemble(m, inp.centre, sizes["radius"], sizes["order"],
                       sizes["nitsche"], sizes["ghost_penalty"], inp.load,
                       sizes["threshold"])
    x, _, _ = isop2.pcg(S.csr(), S.rhs, S.active,
                        SOLVE_TOL if m.X.dtype == torch.float64 else 1e-6,
                        SOLVE_MAXITER)
    return S, x


def compare(sizes, traffic, samples, meta, device, seed):
    """Numbers of each sampled step against the float64 reference."""
    m = isop2.Mesh(sizes["nx"], *sizes["box"], device)
    nid, did, emap = _maps(m, meta)
    probe = _probe(m, seed)
    out = []
    for inp, o in samples:
        S, x = reference(m, sizes, inp)
        r = judge.numbers(canonical(o, m, nid, emap), S, x, probe)
        D = torch.zeros(m.nn, 3, dtype=torch.float64, device=m.X.device)
        D[did] = o["deform"].to(m.X.device, torch.float64).reshape(3, -1).T
        r["deform"] = deform_gap(D, S.D, m.h)
        out.append(r)
    return out


def control(sizes, traffic, inputs, device, seed):
    """The comparison's numbers of the reference computed in float32 in
    the program's place."""
    m = isop2.Mesh(sizes["nx"], *sizes["box"], device)
    m32 = m.with_dtype(torch.float32)
    probe = _probe(m, seed)
    out = []
    for inp in inputs:
        S, x = reference(m, sizes, inp)
        S32, x32 = reference(m32, sizes, inp)
        canon = {"hasneg": S32.hasneg, "cut": S32.cut, "active": S32.active,
                 "matvec": lambda v: S32.matvec(v.float()).double(),
                 "rhs": S32.rhs.double(), "sol": x32.double()}
        r = judge.numbers(canon, S, x, probe)
        r["deform"] = deform_gap(S32.D, S.D, m.h)
        out.append(r)
    return out


def _probe(m, seed):
    g = torch.Generator(device=m.X.device).manual_seed(int(seed) % 2 ** 62)
    return torch.rand(m.nn, dtype=torch.float64, device=m.X.device,
                      generator=g) * 2 - 1
