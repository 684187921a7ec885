"""VTK output and a ``Draw`` stub (visualization parity).

Counterpart of ``ngsxfem_tpu/utils/vtkout.py``.  The reference tutorials
end with ``Draw(...)`` / ``VTKOutput(...)`` (e.g. py_tutorials/
tracefem3d.py): ``VTKOutput`` writes legacy ASCII VTK unstructured grids of
point-evaluated CoefficientFunctions.  ``subdivision=k`` evaluates on the
level-k dyadic refinement of every element (``ops/subdivide.py``, NGSolve's
subdivision flag); repeated ``Do()`` calls write one file per step and a
ParaView ``.pvd`` collection with the time values.  The evaluation runs on
``device`` (default: that of the first GridFunction among ``coefs``, else
the card); the values come to the host to be written.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import config, resolve_device

_VTK_CELL = {"segm": 3, "trig": 5, "quad": 9, "tet": 10, "hex": 12}
# subdivided cells are simplices of the mesh dimension
_VTK_SIMPLEX = {1: 3, 2: 5, 3: 10}


def Draw(*args, **kwargs):
    """No-op: there is no GUI; ``VTKOutput`` writes files."""
    return None


class VTKOutput:
    def __init__(self, ma=None, mesh=None, coefs=(), names=(), filename="out",
                 subdivision=0, device=None, **kw):
        self.mesh = ma if ma is not None else mesh
        self.coefs = list(coefs)
        self.names = list(names)
        if len(self.coefs) != len(self.names):
            raise ValueError(
                f"VTKOutput: {len(self.coefs)} coefs but {len(self.names)} "
                "names (zip would silently drop fields)")
        self.filename = filename
        self.subdivision = int(subdivision)
        if device is None:
            device = next((c.device for c in self.coefs
                           if isinstance(getattr(c, "device", None),
                                         torch.device)), None)
        self.device = resolve_device(device)
        self._steps = []  # (filename, time) of every Do() call

    def _ref_cells(self):
        """(ref_pts (nlat, d), cells (nsub, nvc), vtk_cell_type)."""
        mesh = self.mesh
        if self.subdivision == 0:
            from ..ops.cuttables import REF_VERTS

            refv = np.asarray(REF_VERTS[mesh.et], dtype=np.float64)
            cells = np.arange(refv.shape[0])[None, :]
            return refv, cells, _VTK_CELL[mesh.et]
        from ..ops.subdivide import subdivision_tables

        lattice, subs = subdivision_tables(mesh.et, self.subdivision)
        return (np.asarray(lattice, dtype=np.float64),
                np.asarray(subs, dtype=np.int64),
                _VTK_SIMPLEX[mesh.dim])

    def Do(self, time=None, **kw):
        """Write the next step's file; returns its name."""
        from ..cf.coefficient import wrap
        from ..cf.context import EvalCtx, eval_pure

        mesh = self.mesh
        refp, rcells, ctype = self._ref_cells()
        nlat = refp.shape[0]
        pts = torch.as_tensor(refp, dtype=config.dtype,
                              device=self.device)[None].expand(
                                  (mesh.ne,) + refp.shape)
        ctx = EvalCtx(mesh, pts)
        phys = ctx.phys.detach().cpu().numpy()  # (ne, nlat, d), deformed
        d = phys.shape[-1]
        npts = mesh.ne * nlat
        ncell = mesh.ne * rcells.shape[0]
        nvc = rcells.shape[1]

        step = len(self._steps)
        fn = (f"{self.filename}.vtk" if step == 0
              else f"{self.filename}_step{step:04d}.vtk")
        with open(fn, "w") as f:
            f.write("# vtk DataFile Version 3.0\nngsxfem_tpu output\nASCII\n")
            f.write("DATASET UNSTRUCTURED_GRID\n")
            f.write(f"POINTS {npts} double\n")
            p3 = np.zeros((npts, 3))
            p3[:, :d] = phys.reshape(-1, d)
            np.savetxt(f, p3, fmt="%.10g")
            f.write(f"\nCELLS {ncell} {ncell * (nvc + 1)}\n")
            offs = (np.arange(mesh.ne) * nlat)[:, None, None]
            conn = (rcells[None] + offs).reshape(-1, nvc)
            np.savetxt(
                f, np.concatenate([np.full((ncell, 1), nvc), conn], axis=1),
                fmt="%d",
            )
            f.write(f"\nCELL_TYPES {ncell}\n")
            np.savetxt(f, np.full(ncell, ctype), fmt="%d")
            f.write(f"\nPOINT_DATA {npts}\n")
            for cf, name in zip(self.coefs, self.names):
                cf = wrap(cf)
                vals = torch.broadcast_to(eval_pure(cf, ctx),
                                          (mesh.ne, nlat) + cf.dims)
                vals = vals.detach().cpu().numpy()
                ncomp = int(np.prod(cf.dims)) if cf.dims else 1
                if ncomp == 1:
                    f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                    np.savetxt(f, vals.reshape(-1, 1), fmt="%.10g")
                elif len(cf.dims) == 1 and ncomp <= 3:
                    f.write(f"VECTORS {name} double\n")
                    v3 = np.zeros((npts, 3))
                    v3[:, :ncomp] = vals.reshape(npts, ncomp)
                    np.savetxt(f, v3, fmt="%.10g")
                else:  # matrices / wide vectors: generic FIELD array
                    f.write(f"FIELD {name}_field 1\n")
                    f.write(f"{name} {ncomp} {npts} double\n")
                    np.savetxt(f, vals.reshape(npts, ncomp), fmt="%.10g")
        self._steps.append((fn, 0.0 if time is None else float(time)))
        if len(self._steps) > 1:
            self._write_pvd()
        return fn

    def _write_pvd(self):
        """ParaView collection indexing all steps with their time values."""
        with open(f"{self.filename}.pvd", "w") as f:
            f.write('<?xml version="1.0"?>\n'
                    '<VTKFile type="Collection" version="0.1">\n'
                    "  <Collection>\n")
            for fn, t in self._steps:
                f.write(f'    <DataSet timestep="{t}" file="{fn}"/>\n')
            f.write("  </Collection>\n</VTKFile>\n")

    __call__ = Do
