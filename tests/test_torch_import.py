"""The PyTorch port imports neither JAX nor the JAX package.

Runs in subprocesses: this test process has already imported jax
(tests/conftest.py), so ``sys.modules`` here says nothing about the port.
"""
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import ngsxfem_tpu_torch
import ngsxfem_tpu_torch.kernels.build
import ngsxfem_tpu_torch.solvers.dia_cg
import ngsxfem_tpu_torch.solvers.ell_spmv
import ngsxfem_tpu_torch.solvers.sparse
import ngsxfem_tpu_torch.solvers.krylov
import ngsxfem_tpu_torch.solvers.mg
import ngsxfem_tpu_torch.solvers.latticemg
import ngsxfem_tpu_torch.fem.space
import ngsxfem_tpu_torch.fem.gridfunction
import ngsxfem_tpu_torch.forms.proxies
import ngsxfem_tpu_torch.forms.evaluate
import ngsxfem_tpu_torch.forms.assemble
import ngsxfem_tpu_torch.examples.cutfem
import ngsxfem_tpu_torch.examples.fictdom3d
import ngsxfem_tpu_torch.examples.fictdom_ghostpen
import ngsxfem_tpu_torch.examples.fictdom_dg_ghostpen
import ngsxfem_tpu_torch.examples.fictdom_dn_ghostpen
import ngsxfem_tpu_torch.examples.stokescutfem
import ngsxfem_tpu_torch.examples.nxfem
import ngsxfem_tpu_torch.examples.xfespaces
import ngsxfem_tpu_torch.fem.xfespace
import ngsxfem_tpu_torch.ops.multilinear
import ngsxfem_tpu_torch.geom.cutinfo
import ngsxfem_tpu_torch.utils.diagnostics
import ngsxfem_tpu_torch.lsetcurv
import ngsxfem_tpu_torch.lsetcurv.lsetcurv
import ngsxfem_tpu_torch.lsetcurv.shifted
import ngsxfem_tpu_torch.examples.nxfem_higher_order
import ngsxfem_tpu_torch.examples.fictdom_ghostpen_restrictedblf
import ngsxfem_tpu_torch.examples.tracefem
import ngsxfem_tpu_torch.examples.tracefem3d
import ngsxfem_tpu_torch.examples.traceconverg
import ngsxfem_tpu_torch.examples.stokesxfem
import ngsxfem_tpu_torch.spacetime
import ngsxfem_tpu_torch.spacetime.timefe
import ngsxfem_tpu_torch.spacetime.space
import ngsxfem_tpu_torch.ops.spacetimecut
import ngsxfem_tpu_torch.lsetcurv.lset_spacetime
import ngsxfem_tpu_torch.utils.utils
import ngsxfem_tpu_torch.examples.moving_domain
import ngsxfem_tpu_torch.examples.moving_domain3d
import ngsxfem_tpu_torch.examples.heateq_cg_spacetime
import ngsxfem_tpu_torch.ops.subdivide
import ngsxfem_tpu_torch.solvers.operator
import ngsxfem_tpu_torch.solvers.stencilop
import ngsxfem_tpu_torch.solvers.condense
import ngsxfem_tpu_torch.fem.facetspace
import ngsxfem_tpu_torch.fem.hdiv
import ngsxfem_tpu_torch.fem.sfespace
import ngsxfem_tpu_torch.examples.tracefem_hdg
import ngsxfem_tpu_torch.mesh.io
import ngsxfem_tpu_torch.mesh.refine
import ngsxfem_tpu_torch.mesh.splinegeom
import ngsxfem_tpu_torch.mesh.composite
import ngsxfem_tpu_torch.examples.cutmg
import ngsxfem_tpu_torch.examples.unstructured_nxfem
import ngsxfem_tpu_torch.examples.integrate_curved
import ngsxfem_tpu_torch.examples.lsetgeoms
import ngsxfem_tpu_torch.examples.levelset_shape_opt
import ngsxfem_tpu_torch.utils.timing
import ngsxfem_tpu_torch.utils.vtkout
import ngsxfem_tpu_torch.utils.globals
import ngsxfem_tpu_torch.parallel
import ngsxfem_tpu_torch.parallel.sharding
import ngsxfem_tpu_torch.parallel.halo
import ngsxfem_tpu_torch.parallel.latticeshard
import ngsxfem_tpu_torch.parallel.dryrun
import chip_smoke
from ngsxfem_tpu_torch import *

# the README's Quick start, on the CPU
mesh = MakeStructured2DMesh(quads=False, nx=32, ny=32)
lsetp1 = GridFunction(H1(mesh, order=1, device="cpu"))
InterpolateToP1(sqrt(x*x + y*y) - 0.5, lsetp1)
area = Integrate({"levelset": lsetp1, "domain_type": NEG},
                 CoefficientFunction(1.0), mesh, order=4)
assert abs(area - 0.19634954084936207) < 1e-3, area
# a weak form through BilinearForm/LinearForm, and the lattice multigrid
err = ngsxfem_tpu_torch.examples.fictdom3d.run(nx=4, verbose=False,
                                               device="cpu")
assert 0.05 < err < 0.2, err
err = ngsxfem_tpu_torch.examples.cutfem.run(nx=6, verbose=False, device="cpu")
assert 0.1 < err < 0.5, err
# skeleton, vector and XFEM workloads
err = ngsxfem_tpu_torch.examples.fictdom_dg_ghostpen.run(nx=6, verbose=False,
                                                         device="cpu")
assert 0.05 < err < 0.5, err
err = ngsxfem_tpu_torch.examples.nxfem.run(nx=6, verbose=False, device="cpu")
assert 0.1 < err < 0.5, err
u_err, p_err = ngsxfem_tpu_torch.examples.stokescutfem.run(nx=4, verbose=False,
                                                           device="cpu")
assert u_err < 0.5 and p_err < 1.0, (u_err, p_err)
# the isoparametric mesh adaptation and a deformed integral
lsa = LevelSetMeshAdaptation(mesh, order=2, threshold=10.0, device="cpu")
deform = lsa.CalcDeformation(sqrt(x*x + y*y) - 0.5)
assert lsa.CalcMaxDistance(sqrt(x*x + y*y) - 0.5) < 1e-4
area = Integrate({"levelset": lsa.lset_p1, "domain_type": NEG},
                 CoefficientFunction(1.0), mesh, order=4, deformation=deform)
assert abs(area - 0.19634954084936207) < 1e-6 and mesh.deformation is None
# space-time: a slab of the moving-domain example, the CG-in-time heat
# example and the space-time mesh adaptation
err = ngsxfem_tpu_torch.examples.moving_domain.run(nx=8, nslab=2,
                                                   verbose=False, device="cpu")
assert 0 < err < 1.0, err
errs = ngsxfem_tpu_torch.examples.heateq_cg_spacetime.run(
    nx=6, nslab=2, tend=0.1, verbose=False, device="cpu")
assert 0 < errs[-1] < 1.0, errs
lst = LevelSetMeshAdaptation_Spacetime(mesh, order_space=2, order_time=1,
                                       threshold=0.5, device="cpu")
lst.CalcDeformation(sqrt((x - 0.1 * tref) ** 2 + y * y) - 0.5)
assert lst.CalcMaxDistance() < 1e-3
mg1 = LatticeDIAMG([[-1, 0, 1]], [5], dim=1)
pp = mg1.prepare_safe(mg1.params([[[0, -1, -1, -1, -1], [2] * 5,
                                   [-1, -1, -1, -1, 0]]], device="cpu"))
assert float(pp["ainv0_res"]) < 1e-12
# the general cut multigrid, refinement, the spline mesher and Gmsh I/O
it_mg, it_j, diff = ngsxfem_tpu_torch.examples.cutmg.run(
    nx0=4, levels=2, verbose=False, device="cpu")
assert it_mg < it_j and diff < 1e-6, (it_mg, it_j, diff)
rm = MakeStructured2DMesh(quads=False, nx=4, ny=4)
RefineAtLevelSet(GridFunction(H1(rm, order=1, device="cpu")))
rm.Refine()
assert rm.ne == 128
err = ngsxfem_tpu_torch.examples.unstructured_nxfem.run(
    mesher="delaunay", npts=100, via_gmsh=True, verbose=False, device="cpu")
assert 0 < err < 0.5, err
cm = MakeQuadDominated2DMesh(nx=4, ny=4)
assert abs(IntegrateC(None, 1.0, cm, order=1, device="cpu") - 1.0) < 1e-12
# differentiation through the level set, periodic spaces, the utilities
r_opt, area_opt = ngsxfem_tpu_torch.examples.levelset_shape_opt.run(
    nx=16, verbose=False, device="cpu")
assert abs(area_opt - 0.25) < 1e-10, area_opt
pm = MakeStructured2DMesh(quads=False, nx=4, ny=4, periodic="x")
assert Periodic(H1(pm, order=1, device="cpu")).ndof == 20
with Timer("import probe"):
    ngsglobals.msg_level = 1
assert "import probe" in ngsxfem_tpu_torch.utils.timing.GetTimers()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ngsxfem_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    """Importing the port, its modules, its examples and chip_smoke, and
    running the Quick start, five examples, the isoparametric adaptation,
    the space-time examples and adaptation, a coarse multigrid inverse, the
    cut multigrid example, a refinement, the unstructured example through
    Gmsh and a composite integral on the CPU, loads no jax and no
    ngsxfem_tpu module."""
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py without the rest of the repository (and here, without
    a card) exits non-zero and prints no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
