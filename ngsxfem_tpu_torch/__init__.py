"""ngsxfem_tpu_torch: the PyTorch/CUDA port of ngsxfem_tpu.

Module layout and function names follow the JAX package ``ngsxfem_tpu``,
which stays the reference the port is tested against.  This package imports
``torch`` and never ``jax`` or ``ngsxfem_tpu``; host tables are numpy, and
every entry point that makes tensors runs on the first CUDA card unless it
is given ``device="cpu"``.

Ported so far: the flagship 3D fictitious-domain Poisson
``UnfittedPoisson`` (host setup, lattice assembly into a DIA table in f32 or
f64, one-pass assembly into an ELL table, the quadrature-assembled
``elmats``/``apply``/``rhs``/``solve``), the DIA operator and the fused
Jacobi-PCG ``dia_cg_fused``, the ELL operator ``ELLMatrix`` (product
``ell_matvec``), the Krylov solvers, the functional cut multigrid
``FunctionalELLMG`` and the lattice multigrid ``LatticeDIAMG``; general
straight-cut quadrature (meshes with boundary ids, CoefficientFunctions, P1
level-set ``GridFunction``s, ``CutInfo``, ``Integrate``); and public
symbolic-form assembly: ``H1``, ``L2``, ``NumberSpace``, ``VectorH1``/
``VectorL2`` with Dirichlet marks, ``Compress``, the enrichment space
``XFESpace`` with ``neg``/``pos``/``extend``, compound ``FESpace([...])``,
trial/test proxies with ``grad``, ``div``, ``dn``/``dnjump``,
``BilinearForm``/``LinearForm``/``RestrictedBilinearForm`` with cut-volume
(``SymbolicBFI``, ``SymbolicLFI``), skeleton, element-boundary, boundary
(``VOL_or_BND=BND``) and facet-patch (``SymbolicFacetPatchBFI``)
integrators, ``a.mat.Inverse`` (host LU, or ``"cg"`` on the device) and
``MinResSolver`` for saddle-point systems; the isoparametric level-set
mesh adaptation ``LevelSetMeshAdaptation`` (with ``ProjectShift``,
``CalcMaxDistance``, ``CalcDistances`` and ``shifted_eval``), whose
deformation ``Mesh.SetDeformation`` applies to ``Integrate`` and to every
integrator of the forms; and space-time unfitted FEM: ``ScalarTimeFE``,
``SpaceTimeFESpace`` with ``tref``, ``dt``, ``fix_t`` and the time
restrictions, space-time cut quadrature (``time_order=`` in ``Integrate``,
``CutInfo.Update`` and every integrator), Petrov-Galerkin forms across
space-time spaces, ``SpaceTimeWeakSet`` and
``LevelSetMeshAdaptation_Spacetime``; matrix-free operators
(``BilinearForm.AssembleOperator``: ``PartialAssemblyOperator`` and the
channel-lattice ``LatticeStencilOperator``), the subdivision quadrature of
level-set CoefficientFunctions (``subdivlvl > 0``), the spaces
``FacetFESpace``, ``HDiv`` (RT0, ``dn(..., hdiv=True)``) and ``SFESpace``,
and static condensation ``condensed_solve``; the general cut multigrid
(``MultiGridCL``, ``CutFemSmoother`` with patch-block smoothing, the
prolongation classes, ``P2TwoGridCL``, ``LinearMGIterator``) and meshing
(``Mesh.Refine``, ``MeshFromArrays``, Gmsh I/O, ``MakeUnstructuredMesh``,
``SplineGeometry``, the quad-dominated ``CompositeMesh`` with
``IntegrateC``); periodic spaces (``Periodic``, ``MakeStructured*DMesh(
periodic=...)``, ``LevelSetMeshAdaptation(periodic=True)``) and material
regions (``Mesh.Materials``, ``definedon=``); differentiation through the
level set (``torch.autograd`` through the cut quadrature, the assemblies,
``ELLMatrix`` products and ``krylov.cg``, and the implicitly differentiated
``krylov.cg_implicit``); and the utilities (``Timer``/``PrintTimers``,
``torch_trace``, ``VTKOutput``/``Draw``, ``ngsglobals``,
``StatisticContainer``/``PrintConvergenceTable``, ``kappa``, ``IsCut``,
``set_default_dtype``).  ``from ngsxfem_tpu_torch import *`` runs the
README's Quick start and the workloads in ``ngsxfem_tpu_torch/examples``.
What is not ported raises ``NotImplementedError`` naming its item in
ROADMAP.md.  ``dia_cg_fused``, ``ell_matvec`` and ``dia_matvec`` run
hand-written CUDA kernels for Hopper on CUDA tensors.
"""
from .config import config, set_default_dtype
from .domaintype import (DOMAIN_TYPE, COMBINED_DOMAIN_TYPE, NEG, POS, IF,
                         CDOM_NO, CDOM_NEG, CDOM_POS, UNCUT, HASNEG, HASPOS,
                         ANY, all_domain_types, all_combined_domain_types,
                         TO_CDT, INVERT)
from .mesh.mesh import Mesh, Region
from .mesh.structured import (Make1DMesh, MakeStructured2DMesh,
                              MakeStructured3DMesh)
from .mesh.io import MeshFromArrays, ReadGmsh, WriteGmsh, MakeUnstructuredMesh
from .mesh.splinegeom import SplineGeometry, MakeCircle, MakeRectangle
from .mesh.composite import (CompositeMesh, MakeQuadDominated2DMesh,
                             CompositeGridFunction, CompositeCutInfo,
                             CompositeBilinearForm, CompositeLinearForm,
                             IntegrateC)
from .fem.space import (BitArray, CompoundBitArray, H1, L2, NumberSpace,
                        VectorH1, VectorL2, VectorFESpace, CompoundFESpace,
                        CompressedFESpace, Compress, GetDofsOfElements,
                        Periodic, PeriodicFESpace, FESpaceFactory)
from .fem.xfespace import (XFESpace, XToNegPos, neg, pos, extend, neg_grad,
                           pos_grad, extend_grad)
from .fem.space import FESpaceFactory as FESpace
from .fem.facetspace import FacetFESpace
from .fem.hdiv import HDiv
from .fem.sfespace import SFESpace
from .fem.gridfunction import GridFunction, InterpolateToP1, grad
from .forms.proxies import dn, dnjump, div
from .forms.assemble import (BilinearForm, LinearForm,
                             RestrictedBilinearForm, SymbolicBFI, SymbolicLFI,
                             SymbolicFacetPatchBFI, VOL, BND)
from .cf.coefficient import (CF, CoefficientFunction, InnerProduct, Parameter,
                             IfPos, Norm, x,
                             y, z, sin, cos, tan, exp, log, sqrt, atan, sinh,
                             cosh, fabs, floor, ceil, specialcf)
from .integrate import Integrate, Integrate_X_special_args
from .lsetcurv import (LevelSetMeshAdaptation, ProjectShift, CalcMaxDistance,
                       CalcDistances, RefineAtLevelSet, shifted_eval,
                       LevelSetMeshAdaptation_Spacetime)
from .spacetime import (ScalarTimeFE, SpaceTimeFESpace, ReferenceTimeVariable,
                        tref, dt, fix_t, CreateTimeRestrictedGF,
                        RestrictGFInTime, SpaceTimeInterpolateToP1)
from .spacetime.space import dt_vec
from .utils.utils import (SpaceTimeWeakSet, LevelsetExamples, BoundingBoxes,
                          StatisticContainer, PrintConvergenceTable, kappa,
                          IsCut)
from .utils.vtkout import Draw, VTKOutput
from .utils.globals import ngsglobals
from .utils.timing import Timer, PrintTimers, torch_trace
from .geom.cutinfo import (CutInfo, GetFacetsWithNeighborTypes,
                           GetElementsWithNeighborFacets, GetDofsOfFacets,
                           IndicatorCF, CutRatioGF, BitArrayCF)
from .models.poisson import UnfittedPoisson
from .solvers.sparse import (DIAMatrix, ELLMatrix, InverseMatrix,
                             SparseMatrix, dia_matvec, dia_matvec_plain)
from .solvers.ell_spmv import ell_matvec, ell_matvec_plain
from .solvers.krylov import (CGSolver, MinResSolver, cg, cg_ir, cg_implicit,
                             minres, jacobi_preconditioner)
from .solvers.dia_cg import dia_cg_fused, dia_cg_fused_plain
from .solvers.mg import (FunctionalELLMG, MultiGridCL, CutFemSmoother,
                         LinearMGIterator, CompoundProlongation,
                         P1Prolongation, P2Prolongation, P2CutProlongation,
                         P2TwoGridCL, VertPatches, ElemPatches, EdgePatches)
from .solvers.operator import PartialAssemblyOperator
from .solvers.stencilop import LatticeStencilOperator
from .solvers.condense import condensed_solve
from .solvers.latticemg import LatticeDIAMG
from .ops.straightcut import cut_rule_element as CreateCutIntegrationRule
from . import parallel

FIRST, OPTIMAL, FALLBACK = "FIRST", "OPTIMAL", "FALLBACK"
CXFESpace = XFESpace  # the reference's C++ class name
CSpaceTimeFESpace = SpaceTimeFESpace
# binding-level aliases of the reference (python_xfem.cpp SymbolicCutBFI/
# LFI, spacetime/python_spacetime.cpp:271 TimeVariableCoefficientFunction)
SymbolicCutBFI, SymbolicCutLFI = SymbolicBFI, SymbolicLFI
TimeVariableCoefficientFunction = type(tref)


def IntegrateX(lset=None, mesh=None, cf=None, order=5, domain_type=None,
               subdivlvl=0, time_order=-1, quad_dir_policy=None, **kw):
    """Low-level Integrate entry (reference python_cutint.cpp:20-122)."""
    ld = {"levelset": lset, "domain_type": domain_type, "subdivlvl": subdivlvl}
    if quad_dir_policy is not None:
        ld["quad_dir_policy"] = quad_dir_policy
    return Integrate(levelset_domain=ld, cf=cf, mesh=mesh, order=order,
                     time_order=time_order, **kw)


__all__ = ["config", "DOMAIN_TYPE", "COMBINED_DOMAIN_TYPE", "NEG", "POS",
           "IF", "CDOM_NO", "CDOM_NEG", "CDOM_POS", "UNCUT", "HASNEG",
           "HASPOS", "ANY", "FIRST", "OPTIMAL", "FALLBACK", "Make1DMesh",
           "MakeStructured2DMesh", "MakeStructured3DMesh", "BitArray", "H1",
           "L2", "NumberSpace", "VectorH1", "VectorL2", "VectorFESpace",
           "Periodic", "XFESpace", "CXFESpace", "XToNegPos", "neg", "pos",
           "extend", "neg_grad", "pos_grad", "extend_grad", "MinResSolver",
           "minres", "SymbolicCutBFI", "SymbolicCutLFI",
           "CompoundBitArray", "FESpace", "CompoundFESpace",
           "CompressedFESpace", "Compress", "GetDofsOfElements", "dn",
           "dnjump", "div", "BilinearForm", "LinearForm",
           "RestrictedBilinearForm", "SymbolicBFI", "SymbolicLFI",
           "SymbolicFacetPatchBFI", "VOL", "BND", "InverseMatrix",
           "LatticeDIAMG",
           "GridFunction", "InterpolateToP1", "grad", "CoefficientFunction",
           "InnerProduct", "Parameter", "IfPos", "Norm", "x", "y", "z", "sin", "cos", "tan",
           "exp", "log", "sqrt", "atan", "sinh", "cosh", "fabs", "floor",
           "ceil", "specialcf", "Integrate", "Integrate_X_special_args",
           "LevelSetMeshAdaptation", "ProjectShift", "CalcMaxDistance",
           "CalcDistances", "RefineAtLevelSet", "shifted_eval",
           "CutInfo", "GetFacetsWithNeighborTypes",
           "GetElementsWithNeighborFacets", "GetDofsOfFacets", "IndicatorCF",
           "CutRatioGF", "BitArrayCF", "UnfittedPoisson", "DIAMatrix", "ELLMatrix",
           "SparseMatrix", "dia_matvec", "dia_matvec_plain", "ell_matvec",
           "ell_matvec_plain",
           "CGSolver", "cg", "cg_ir", "jacobi_preconditioner", "dia_cg_fused",
           "dia_cg_fused_plain", "FunctionalELLMG", "ScalarTimeFE",
           "SpaceTimeFESpace", "CSpaceTimeFESpace", "ReferenceTimeVariable",
           "tref", "dt", "fix_t", "CreateTimeRestrictedGF",
           "RestrictGFInTime", "SpaceTimeInterpolateToP1",
           "SpaceTimeWeakSet", "LevelSetMeshAdaptation_Spacetime",
           "FacetFESpace", "HDiv", "SFESpace", "PartialAssemblyOperator",
           "LatticeStencilOperator", "condensed_solve", "Mesh",
           "MeshFromArrays", "ReadGmsh", "WriteGmsh", "MakeUnstructuredMesh",
           "SplineGeometry", "MakeCircle", "MakeRectangle", "CompositeMesh",
           "MakeQuadDominated2DMesh", "CompositeGridFunction",
           "CompositeCutInfo", "CompositeBilinearForm",
           "CompositeLinearForm", "IntegrateC", "LevelsetExamples",
           "BoundingBoxes", "MultiGridCL", "CutFemSmoother",
           "LinearMGIterator", "CompoundProlongation", "P1Prolongation",
           "P2Prolongation", "P2CutProlongation", "P2TwoGridCL",
           "VertPatches", "ElemPatches", "EdgePatches", "set_default_dtype",
           "all_domain_types", "all_combined_domain_types", "TO_CDT",
           "INVERT", "Region", "PeriodicFESpace", "FESpaceFactory", "CF",
           "dt_vec", "StatisticContainer", "PrintConvergenceTable", "kappa",
           "IsCut", "Draw", "VTKOutput", "ngsglobals", "Timer",
           "PrintTimers", "torch_trace", "cg_implicit",
           "CreateCutIntegrationRule", "TimeVariableCoefficientFunction",
           "IntegrateX"]
