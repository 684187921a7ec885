#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's flagship paths once on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; one CUDA card, nvcc)

The flagship is 3D fictitious-domain Poisson with Nitsche terms and
facet-patch ghost penalty on a structured tet mesh at nx=48 (663,552 tets,
117,649 dofs, float32).  Three paths run through it (and general cut
quadrature, phase 9, beside it), two more in phases 12-15, the
skeleton, vector and XFEM workloads in phases 16-17, the isoparametric
(order-2/3 deformed-mesh) workloads in phases 18-19, the space-time
moving-domain workloads in phases 20-21, the matrix-free operators, the
subdivision quadrature and the HDG trace FEM in phases 22-23, and the
general cut multigrid and the meshing and refinement in phases 24-25, the
gradient of a cut-FEM functional with respect to the level set in phase 26,
the periodic spaces, materials and utilities in phase 27, the parallel
layouts through spawned NCCL ranks and at world size 1 through NCCL, with
the matrix-free operators and the solve on a sharded mesh, in phase 28,
the reference's other assembly routes of the flagship in phase 29, and the
public-API paths the parity run with the JAX package's own tests repaired
(numpy vectors at the solvers and transfers, ``Compress`` of a facet space,
the assembly timers) in phase 30, and the card's ELL conversion of
``SparseMatrix.to_ell`` (every table built on the card in phases 3-31 held
to its plain version and to ``to_ell`` on the CPU between phases, then timed on
the nx=48 forms table) in phase 32, the DIA product ``dia_matvec`` as one
launch of its kernel on the nx=48 lattice table in phase 33, and the lattice
DIA assembly ``assemble_vals_lattice`` as one launch of its kernel at nx=48
in phase 34:

- the DIA path: ``UnfittedPoisson`` host setup -> ``dia_structure`` ->
  ``assemble_vals_lattice`` (DIA table) -> ``dia_cg_fused`` (hand-written
  CUDA kernel, 50 Jacobi-PCG iterations) -> ``cg_ir`` (converged solve, true
  f64 residual <= 1e-10);
- the ELL path: ``ell_structure`` -> ``assemble_vals_soa1`` (ELL table) on
  nx = 12, 24, 48 -> ``ELLMatrix`` / ``ell_matvec`` (hand-written CUDA
  kernel) -> Jacobi-CG-50 through ``CGSolver`` -> ``FunctionalELLMG``
  (cut multigrid, ``prepare_host``) as the preconditioner of ``krylov.cg``
  to 1e-8;
- the quadrature path: ``UnfittedPoisson.elmats`` / ``apply`` / ``rhs`` /
  ``solve`` from cut quadrature rules (no hand-written kernel: no TPU
  kernel lies on this path);
- the lattice multigrid on the DIA path: ``LatticeDIAMG`` on the DIA tables
  of nx = 12, 24, 48 as the preconditioner of ``krylov.cg`` (f32 and f64;
  plain PyTorch: the reference has no TPU kernel there), and the flagship
  in native f64;
- the public API: ``examples.fictdom3d`` (the flagship written as a weak form
  through ``BilinearForm``/``LinearForm``), solved by the named host LU
  (``inverse="umfpack"``), by ``a.mat.Inverse(freedofs, inverse="cg")`` and
  by the default ``a.mat.Inverse(freedofs)``, both of which run Jacobi-CG
  through the ``ell_matvec`` kernel on the card;
- the skeleton, vector and XFEM workloads: ``examples.fictdom_dg_ghostpen``
  (L2, cut-facet interior penalty), ``fictdom_dn_ghostpen`` (``dnjump``
  skeleton ghost penalty), ``stokescutfem`` (``VectorH1``, ``div``, a
  saddle-point system solved by ``MinResSolver``), ``nxfem`` (XFESpace)
  and ``xfespaces``, their systems' products all through ``ell_matvec``;
- the isoparametric path: ``LevelSetMeshAdaptation.CalcDeformation`` ->
  ``mesh.SetDeformation`` -> ``BilinearForm``/``LinearForm`` (deformed
  volume, interface and facet-patch contexts) -> ``to_ell`` -> the default
  ``a.mat.Inverse(freedofs)`` (Jacobi-CG through ``ell_matvec``) ->
  ``Integrate`` of the L2 error on the deformed mesh: ``examples.fictdom3d``
  with ``isoparametric=True`` (bench.py's high_order workload),
  ``tracefem3d`` and ``nxfem_higher_order``;
- the space-time path: per slab ``SpaceTimeInterpolateToP1`` (or
  ``LevelSetMeshAdaptation_Spacetime.CalcDeformation``) ->
  ``CutInfo.Update(time_order=)`` -> re-marked ``BilinearForm``/
  ``LinearForm`` (space-time cut rules, facet patches, Petrov-Galerkin
  blocks) -> ``a.mat.Inverse(active)`` (the host LU: the slab systems are
  not symmetric) -> ``RestrictGFInTime``: ``examples.moving_domain`` (also
  with ``deform=True``), ``heateq_cg_spacetime`` and ``moving_domain3d``;
- the matrix-free path: ``BilinearForm.AssembleOperator()`` (the channel-
  lattice stencil, per-offset apply on the card, or the partial assembly
  with its fixed-order scatter) -> ``matvec``/``diagonal()`` -> Jacobi-PCG
  through ``krylov.cg`` on the high_order systems, beside the same PCG
  through ``ell_matvec``; ``Integrate`` with ``subdivlvl > 0`` on a level-
  set CoefficientFunction; ``examples.tracefem_hdg`` (L2 x FacetFESpace x
  FacetFESpace, an HDiv normal helper, element-boundary cut integrals,
  ``condensed_solve`` on the host);
- the general cut-multigrid path: ``examples.cutmg`` (per level
  ``BilinearForm`` -> ``prolongation_matrix`` -> ``CutFemSmoother`` with
  its interface block -> ``MultiGridCL``, coarse factor on the host) as the
  preconditioner of CG beside Jacobi-CG, and ``P2TwoGridCL`` (patch-block
  smoothing, inverses batched on the card) with the P1 system's default
  ``Inverse()`` as its coarse solver, every sparse product through
  ``ell_matvec``;
- the meshing path: ``Mesh.Refine`` (trig/tet bisection, quad/hex
  uniform), ``RefineAtLevelSet``, ``MakeUnstructuredMesh``, Gmsh I/O and
  ``examples.unstructured_nxfem`` (its default ``Inverse()`` through
  ``ell_matvec``), ``integrate_curved`` and ``lsetgeoms``;
- the sharded path: ``dryrun_multichip`` through one spawned NCCL rank per
  card, the layouts A-D at world size 1 through NCCL, and
  ``examples.fictdom3d`` on a sharded mesh: ``AssembleOperator()`` and
  ``Assemble()`` -> the default ``a.mat.Inverse(freedofs)`` (Jacobi-CG
  through ``ell_matvec``).

Phases, one line each:

1. environment: a CUDA card, its name and power limit from nvidia-smi;
2. build: compile csrc/dia_cg.cu, csrc/ell_spmv.cu, csrc/coo_ell.cu,
   csrc/dia_spmv.cu, csrc/lattice_asm.cu and the row-major ELL kernel B2
   replaced (tools/torch_ell_spmv_rowmajor.cu, the "before" of
   B2's times) with nvcc for sm_90a, all at once; B2's registers, shared
   memory and local memory (spills);
3. DIA-PCG kernel (one persistent cooperative kernel per call) against its
   plain PyTorch version on the card: the flagship at nx=16, 48 and 64 and
   seeded random exactly symmetric tables (1D, 2D and 3D lattice offsets,
   n = 1 / 257 / 100,003, and two large ones whose launch plan stages only
   part of the operator), iters 0/1/12/50: rel ||x_k - x_p|| <= 5e-4,
   |res_k - res_p| <= 5e-4 ||b||, two kernel runs bitwise equal, an
   asymmetric offset set raises; prints the launch plan at nx=48 and 64;
4. the DIA path at nx=48 with the launch counters reset before it (its
   one assembly one ``lattice_asm`` launch, ``cg_ir``'s products one
   ``dia_spmv`` launch each), then checks of mesh size, ncut, DIA symmetry, residuals, kernel vs
   ``krylov.cg`` + ``dia_matvec``, and the ``cg_ir`` residual;
5. DIA-path times on the card with CUDA events (one warm-up, median of 5),
   and ``torch.profiler`` on PCG-50 calls: exactly one ``dia_cg`` device
   kernel per call, device time per iteration (t(50) - t(0)) / 50;
6. ELL kernel (SELL-32-1024 layout from ``prepare_ell``) against its plain
   PyTorch versions on the card: the nx=48 ELL table in f32 and f64 and
   seeded tables (K = 1..64, n = 0, 1, 31, 32, 33, 257, 100,003, row
   lengths varying inside each slice, all-padding rows, a NaN-poisoned
   table that stays NaN): == ``sell_matvec_plain`` bit for bit, ==
   ``ell_matvec_plain`` under ``torch.equal``, bitwise repeatable; int64
   cols, a wrong shape, a CPU x and a layout of another table raise; a raw
   call builds its own layout; the nx=48 table's slice_K statistics and
   slice fill;
7. the ELL path at nx=48 with the launch counters reset before it, its
   tables assembled as a user's call assembles them (fixed-order sums, no
   global flag): ELL operator == DIA operator after the dof renumbering
   (rel <= 1e-5), Jacobi-CG-50 on ELL == the DIA-PCG kernel's x (rel
   <= 5e-4), MG-CG on [12, 24, 48] to rel res <= 1e-8 in <= 16 iterations
   with a true f64 relative residual <= 1e-4, the solve's layouts == its
   tables (built in ``prepare_host``, none per product), ELL-kernel
   launches > 0; then the nx=48 table assembled five more times: bitwise
   equal, MG-CG in the same number of iterations each time;
8. ELL-path times on the card: SpMV kernel per call (mean of 100) and
   device time per launch, the row-major kernel it replaced, its plain
   versions, ``torch.sparse_csr_tensor @ x`` (cuSPARSE, a yardstick only),
   the nnz bound (the record's ``bound_ms``) and the padded one, assembly
   per level, ``prepare_host``, MG-CG;
9. general cut quadrature through ``Integrate`` on the card, f64: the
   reference suite's exactness cases (error <= 5e-15 (k+1)^2, the plane on
   256 x 256 meshes to 1e-12), the ball r=0.4 on tets nx = 16, 32, 64 and
   hexes nx = 12, 24, 48 (order 4, NEG volume and IF area EOC >= 1.75,
   NEG + POS = 1, element_wise sums), f32 vs f64 at tets nx=64 (rel
   <= 1e-5), the README's Quick start, the autograd dV/dr of the ball
   (against 4 pi r^2 and a central difference) and ``CutInfo`` at tets
   nx=64 against a host sign count;
10. the quadrature path of the flagship at nx=48: ``apply`` == the DIA
   operator of ``assemble_vals_lattice`` (f64 rel <= 1e-11, f32 <= 1e-5),
   ``rhs`` against ``Integrate`` over NEG (1e-12), ``solve()`` in f32 (its
   recursion residual within 1e-2 of the true f64 residual), and the
   symmetry of the order-2 operator at nx=24 (<= 1e-6, f32);
11. times of ``Integrate``, ``CutInfo``, ``elmats``, ``apply``, the
   operator's matvec and ``solve()`` with CUDA events and
   ``torch.profiler`` (device kernels, busy time, idle share), and the
   peak memory of phases 9-11;
12. lattice multigrid on the DIA path: levels nx = 12, 24, 48 in f32 and
   f64 (``prepare_safe``, which raises on a bad coarse inverse; its residual
   <= 1e-3), MG-CG to rel res <= 1.5e-8 in <= 12 iterations (10 measured),
   true f64 relative residual <= 1e-4 (f32) / 1e-7 (f64), fewer than half the
   iterations of Jacobi-CG; the f32 table bitwise equal over five
   assemblies; the hierarchy nx = 16, 32, 64 once;
13. native f64: the f64 lattice table at nx=48 within 2e-5 max|V| of the f32
   one and exactly symmetric, f64 Jacobi-PCG and ``cg_ir`` both to a true
   relative residual <= 1e-10, solutions equal to 1e-8 relative;
14. the public API, launch counters reset before it: ``examples.fictdom3d``
   at nx = 8, 12, 24, 48 (nx=8 error < 0.06, EOC >= 1.75; nx=48 is built
   once through ``examples.fictdom3d.system``), there the ELL kernel against
   its plain versions on the forms-assembled table (117,649 x 24, f64) with
   a seeded x and the free-masked load, bitwise, and its times as in phase
   8; the named direct (``inverse="umfpack"``), the ``"cg"`` and the
   default ``Inverse()`` solve (on the card: Jacobi-CG, path
   ``"device_cg"``, its wall time beside the LU's) equal to 1e-8 with
   ``ell_spmv`` launches equal to the CGs' products and one layout built
   for the table, ``a.mat`` symmetric to 1e-12, the same three
   integrators on ``UnfittedPoisson``'s mesh against its DIA operator on
   active dofs (f64, rel <= 1e-12), ``examples.fictdom_ghostpen`` (nx=40) and
   ``examples.cutfem`` (nx=30, L2 ~0.0188) within 1e-8 of their CPU runs;
15. times of phases 12-14 with CUDA events and ``torch.profiler`` (device
   kernels, busy time, idle share, kernels per MG-CG iteration) and their
   peak memory;
16. the skeleton, vector and XFEM workloads, launch counters reset before
   them, f64: ``fictdom_dg_ghostpen`` (order 2) at nx = 20, 40,
   ``fictdom_dn_ghostpen`` at nx=20, ``nxfem`` at nx=15 and ``xfespaces``
   on the card (whose default ``Inverse()`` now solves on the device but
   for Stokes) against the CPU (host LU) to 1e-8 with the reference tests'
   limits; ``nxfem`` nx=64 ``"cg"`` vs the named host LU (1e-8);
   ``stokescutfem`` at nx=16 (limits) and nx=32 (convergence;
   ``MinResSolver`` with the example's block preconditioner vs the named
   host LU, velocity and errors to 1e-8); then each
   at its card size (DG, dn and nxfem nx=256 through ``Inverse(free,
   inverse="cg")``, Stokes nx=128 through ``MinResSolver``), built once
   through ``system()``: kernel B2 == plain bitwise on each table (a seeded
   x, the free-masked load) with its times as in phase 8, ``ell_spmv``
   launches == the solver's products == iterations + 1, one layout built
   per solve, true relative residual <= 1e-8, L2 errors below the smaller
   sizes';
17. the card-size calls of phase 16: ``Assemble`` by CUDA events and under
   ``torch.profiler`` (device kernels, busy, idle share, host seconds),
   ``to_ell`` (on the card), each solve over a window of 100 iterations, peak
   memory;
18. the isoparametric path at the JAX package's test sizes, launch counters
   reset before it (with phase 19), card against this host's CPU to 1e-8,
   f64: the 2D max-distance EOC of orders 2 and 3 (nx = 8, 16, 32; mean EOC
   above the order), ``fictdom3d(isoparametric=True)`` order 2 at nx = 8,
   16 (L2 < 1.5e-3, ratio > 6), ``tracefem3d`` at nx = 6, 12 (< 0.06, ratio
   > 6), ``nxfem_higher_order`` at nx=15 (< 1e-3); order 3 at nx=16
   (bench.py's high_order size) on the card, its L2 below order 2's; no
   shift-Newton warning anywhere;
19. card size: the high_order workload (sphere r=0.7 on [-1,1]^3,
   threshold 0.2, lambda = 10 k^2, gamma 0.1, f64) at order 2 nx=48
   (663,552 tets) and order 3 nx=24, and ``tracefem3d`` order 2 at nx=32,
   each built once through its ``system()``: ``CalcDeformation`` and
   ``CalcMaxDistance`` by CUDA events, ``Assemble`` by events and under
   ``torch.profiler``, ``to_ell`` (card), ``a.mat`` symmetric to 1e-12, B2
   == both plain versions bitwise on each table (a seeded x, the masked
   load) with its times, bounds, cuSPARSE and slice fill as in phase 8, the
   default ``Inverse()`` on path ``device_cg`` with ell_spmv launches ==
   products == iterations + 1, true relative residual <= 1e-10, L2 errors
   below phase 18's, peak memory; the order-3 facet-patch contraction by
   ``small_matmul`` against ``torch.matmul``;
20. the space-time path at the JAX package's test sizes, launch counters
   reset before it (with phase 21), card against this host's CPU, f64: one
   space-time ``Integrate`` (NEG/POS/IF, kt=2, tets nx=12) and one
   ``CutInfo.Update(time_order=2)`` to 1e-12, and ``moving_domain`` (12, 4)
   / (24, 8), ``heateq_cg_spacetime`` (12, 8) / (24, 16),
   ``moving_domain3d`` (6, 2) / (12, 4) and ``moving_domain(deform=True)``
   order 2 (8, 2) / (16, 4) as (nx, nslab): L2 errors to 1e-8, halving
   over the doubling;
21. card size: ``moving_domain`` (128, 8) / (256, 16), ``moving_domain3d``
   (24, 8) and the deformed one (32, 8) / (64, 16), each L2 error below
   phase 20's and halving over each doubling; ``heateq_cg_spacetime`` (64,
   16) / (128, 32), card == CPU at (64, 16) (its scheme stops converging
   past (24, 16), in the JAX package too); every slab solve on the card
   the dense LU (``device_lu``: every free block here fits
   ``_dense_lu_budget``), on the CPU the host LU, the path and free rows
   printed per example,
   ``a.mat.shape == (W_t.ndof, W_i.ndof)`` for every Petrov-Galerkin form,
   no shift-Newton warning; per slab ``CutInfo.Update`` and both
   ``Assemble`` by CUDA events, ``Inverse()`` (its ``to_ell``),
   ``to_scipy``, ``splu`` and the solve by the host clock, one
   ``BilinearForm.Assemble`` under ``torch.profiler``, peak memory; B2 and
   B1 launches of the path (0: the record's ``launches_spacetime``);
22. matrix-free operators, subdivision quadrature and the new spaces at the
   JAX package's test sizes, launch counters reset before it (with phase
   23), f64, card against this host's CPU: ``AssembleOperator()`` (stencil)
   and ``lattice=False`` (PA) of tests/test_operator.py's fictdom form in
   2D and 3D at orders 1 and 2 (nx=6) and of the order-2 Laplace on 7 x 5:
   ``matvec``/``diagonal()`` against ``a.mat`` to 1e-12 of the largest
   entry, stencil vs PA to 5e-13, the per-offset apply vs
   ``stencil_apply_plain`` to 1e-13, card == CPU to 1e-12;
   tests/test_backuprule.py's cases (straight cuts exact, circle EOC > 1.75,
   ~4x per level, the space-time plane) card == CPU to 1e-12; HDiv RT0
   constants and divergence theorem, the SFESpace projection;
   ``tracefem_hdg`` orders 1, 2 at nx = 8, 16 (EOC > 1.75 / > 2.6, order-2
   error < 3e-4), ``condense=True`` == the direct solve to 1e-8 at nx=12,
   card == CPU to 1e-8;
23. card size: on phase 19's high_order systems (P2 nx=48, P3 nx=24, kept
   with their deformations, not rebuilt) ``AssembleOperator()`` by CUDA
   events (the kind ``"auto"`` took, bytes), the symmetry probe, ``matvec``
   vs B2's product of ``a.mat`` (1e-12), one apply's time, device kernels
   and bound, Jacobi-PCG-50 on ``op.diagonal()`` by events and under
   ``torch.profiler`` (kernels per iteration, busy, idle share) beside the
   same PCG through B2 (ell_spmv launches == products), and at P2 the same
   for ``lattice=False``; ``Integrate`` of the sphere r=0.4 (a CF) on tets
   nx=48 at subdivlvl 0, 1, 2 (error ratio > 2.5 per level, band and
   mixed-child counts, ms, peak memory); ``tracefem_hdg`` order 2 at nx =
   128, 256 (``Assemble`` ms, ``to_ell``, the default ``Inverse()`` path,
   on ``device_cg`` launches == iterations + 1, L2 below nx=16's); B2 and
   B1 launches of phases 22-23 (the record's ``launches_matrix_free`` and
   ``matrix_free_tables``);
24. the general cut multigrid, launch counters reset before it, f64:
   ``examples.cutmg`` in 2D (nx0=80, 3 levels: fine nx=320, 103,041 dofs)
   and 3D (nx0=12, 3 levels: fine nx=48, 117,649 dofs) with the JAX tests'
   limits (||x_mg - x_j|| < 1e-6, MG-CG under half Jacobi-CG's
   iterations): host seconds per setup stage, MG-CG and Jacobi-CG by CUDA
   events and under ``torch.profiler`` (kernels per iteration, busy, idle
   share), ell_spmv launches == the ELL products of one MG-CG solve, a
   second solve bitwise equal, peak memory; B2 == both plain versions
   bitwise on the finest prolongation and restriction tables with their
   times, bounds and cuSPARSE; ``P2TwoGridCL`` on the P2 problem at
   nx=128 (edge patches, nu=2, maxit=30, tol=1e-8, the P1 default
   ``Inverse()`` as coarse solver): patches, K, the batched block setup by
   events, ``pinv`` count, iterations, r < 1e-6 ||b||; card == CPU at the
   JAX tests' sizes (2D nx0=8 two levels, 3D nx0=4 three levels: MG-CG
   iterations within one, solutions to 1e-8);
25. meshing and refinement, launch counters reset before it, f64: uniform
   ``Refine()`` of trig, tet, quad and hex meshes (host seconds, over 10 s
   reported; measure to 1e-12 on the card, a cut volume card == CPU to
   1e-12), ``RefineAtLevelSet`` loops in 2D and 3D (card == CPU each level,
   the error falling), ``examples.unstructured_nxfem``'s solve on a
   Delaunay mesh refined to ~100k trigs (Delaunay, ``Refine`` and
   ``to_ell`` on the host clock, the default ``Inverse()`` on
   ``device_cg`` with ell_spmv launches == its products), the example at
   its own size card == CPU to 1e-8 and through a Gmsh file, a Gmsh round
   trip of the big mesh, ``integrate_curved`` and ``lsetgeoms`` at their
   own sizes card == CPU (integrals 1e-12, distances 1e-8); B2 and B1
   launches of each phase (the record's ``launches_mg``, ``mg_tables`` and
   ``launches_meshing``);
26. differentiable cut FEM, launch counters reset before it, f64: kernel
   B2 under autograd (``ELLMatrix.matvec`` -> ``EllMatvec``) on the
   flagship ELL table at nx=48 and on the non-symmetric P1 prolongation
   nx=24 -> 48, a seeded x and output gradient: one forward and one
   transposed launch per product, the backward's ``A^T g`` bitwise equal to
   ``sell_matvec_plain`` on the transposed table's layout, ``grad_vals``
   bitwise equal to ``g[r] * x[cols]``, <g, A x> = <A^T g, x>, B2's times,
   bounds and cuSPARSE on each transposed table (the record's
   ``autograd_tables``); tests/test_ad_fastpath.py's compliance J(r) =
   b^T x at nx=48 through PCG-120 both ways (the lattice assembly +
   ``dia_matvec`` under autograd, ``dia_spmv.DiaMatvec``: dia_spmv
   launches = 2 x 120 + 1, + unrolled ``krylov.cg``; ``assemble_vals_soa1`` + B2
   products under autograd + the same PCG, ELL products = B2 launches =
   2 x 120 + 1), r0 midway between two vertex distances: dJ/dr against a
   central difference on the card (1e-5; the step 1e-6 x 8 / nx) and the
   two paths against each other (1e-6), J to 1e-9, forward and backward
   ms by events, peak memory (autograd keeps the whole assembly's
   intermediates: under 40 GB, so no recomputation), the general path's
   device kernels and idle share; the rounding witness at PCG-80 (the JAX
   test's budget, printed, not checked) and at PCG-120 (dJ/dr within 1e-6
   of itself): both paths, the general path with its ELL rows' slots in a
   seeded order and at r0 + 1 ulp;
   ``examples.levelset_shape_opt``: ``run`` at nx=1024 (area to 1e-10, r
   within 2e-3 (32 / nx)^2), ``compliance_sensitivity`` through
   ``krylov.cg_implicit`` (B2 in both solves, launches = products) against a
   central difference at nx=64 (1e-7) and at nx=128 with its time, card ==
   CPU at nx=32 and nx=10 (1e-10);
27. periodic spaces, materials and utilities, launch counters reset before
   it, f64: ``Periodic(H1)`` for -u'' + u = cos(2 pi x) at nx=256 and 512
   (~262k dofs) through the default ``Inverse()`` (``device_cg``, B2
   launches = products) under a ``Timer``, the error falling more than
   3.2x per halving of h; at tests/test_misc.py's nx=16 card == CPU (the
   solution 1e-8), ``LevelSetMeshAdaptation(periodic=True)`` (deformation and
   max distance 1e-8), region-wise and ``definedon`` integrals of a cut
   domain (1e-12), ``VTKOutput`` of the card GridFunctions (the file's
   numbers 1e-8); B2 launches of each phase (the record's
   ``launches_autograd`` and ``launches_periodic``);
28. the parallel layer (``ngsxfem_tpu_torch.parallel``) on the card:
   first ``dryrun_multichip(torch.cuda.device_count())`` through
   ``spawn_ranks``' default path (one spawned NCCL rank per card, on its
   card by ``rank_device``; layouts A-C at nx=12 equal to one rank, checked
   on rank 0; a failed rank fails the script); then on cuda:0 at world
   size 1: ``init_process_group("nccl")`` through a ``FileStore`` in
   ``build/``, destroyed at the end; on the f64 flagship (nx=48) layout A
   (``spmd_step``, one all-reduce of the dof vector per product) and B
   (``spmd_step_sharded``, the shared halo buffer, empty at one rank), each
   a 25-iteration partial CG held to the same CG on one device
   (``replicated_operator``; 1e-5 f64, 1e-3 f32); on the f32 and f64
   flagships layout C (``LatticeShard`` Jacobi-PCG-50 vs ``dia_matvec``'s)
   and layout D (each rank's DIA rows assembled from its planes plus the
   exchanged halo planes, bitwise the whole table's, then ``cg_ir`` 4 x 120
   on the slab product: 1e-6 of the one-device pipeline, true relative
   residual <= 1e-8); ms per step and per CG iteration by CUDA events
   after a warm-up, collectives and bytes per iteration, the idle share of
   one step of A, and the host halo tables of ``DofPartition`` and
   ``LatticeShard`` for 2, 4 and 8 ranks at nx=48 (no run); and the
   public-API flagship (``examples.fictdom3d``, P1, f64, nx=48) built
   unsharded and on a mesh sharded over that group: the sharded
   ``AssembleOperator()`` (stencil) and ``AssembleOperator(lattice=False)``
   (PA) each built with one all-reduce of the element stream, their
   ``matvec`` and ``diagonal()``, Jacobi-PCG-50 through the stencil, and
   ``Assemble()`` + the default ``Inverse()`` (Jacobi-CG through B2, the
   launch counter reset just before the sharded solve, launches ==
   products; the record's ``launches_slice14``) bitwise equal to the
   unsharded ones, with the ms of each step by CUDA events and the
   collectives and bytes of each sharded build;
29. the other assembly routes on the f64 flagship: ``assemble_vals_stencil``
   within 1e-13 of ``assemble_vals_lattice``, ``apply_compact`` within
   1e-12 of ``apply``, ``assemble_ell_vals`` / ``_gather`` / ``_soa``
   within 1e-12 of ``assemble_vals_soa1``, each with its ms; B2's launch
   counter reset, Jacobi-CG-50 on the compact ELL table through B2
   (launches == products, the solution bitwise the plain product's), and
   B2 against its plain versions on that table with its times, bound and
   cuSPARSE (the record's ``launches_slice13`` and ``slice13_tables``);
30. the public-API paths the parity run repaired, each B2 launch counter
   reset just before its call: phase 28's unsharded ``examples.fictdom3d``
   P1 f64 nx=48 solved with a numpy right-hand side by ``CGSolver(a.mat,
   freedofs) *`` and ``a.mat.Inverse(freedofs, inverse="cg") *``, each
   bitwise the call with the tensor on the card, B2 launches == products,
   true relative residual <= 1e-8; ``P2Prolongation.Prolongate`` of a numpy
   vector on a P2 pair (nx 64 -> 128) as one B2 product, bitwise the
   tensor call's, the constant to the constant within 1e-10; a
   ``Compress``ed ``FacetFESpace`` on the facets of the ``tracefem_hdg``
   band at nx=256: its ``element_boundary`` mass form assembled on the card
   within 1e-12 of the CPU assembly (no dead rows) and solved by its
   default ``Inverse()`` (Jacobi-CG through B2, launches == products);
   ``GetTimers()`` after that card ``Assemble`` and a ``LinearForm``'s has
   both ``::Assemble`` keys, once each; ms by CUDA events (the record's
   ``launches_slice15``);
32. ``SparseMatrix.to_ell`` on the card: every table that ``coo_ell``
   built on the card in phases 3-31 (``to_ell_audit``, checked between
   phases: ``[to_ell audit]`` lines) equals, bit for bit, the plain
   version's on the card and ``to_ell``'s of its triplets on the CPU, and
   ``coo_ell.launches`` then equals the number of those with an entry; on
   phase 14's nx=48 forms ``a.mat``, launch counter reset just before, one
   ``to_ell`` is one launch and its table equals phase 14's view, with the
   call's and the kernel's times, the kernel's bound, the plain version and
   ``coalesce`` (the record's ``coo_ell_place`` entry);
33. ``dia_matvec`` on the card (``phase_33``): phase 4's nx=48 f32 lattice
   table and its f64 copy, one launch of ``csrc/dia_spmv.cu`` a call, bit
   for bit ``dia_matvec_plain`` (with +-0, +-inf and NaN at the boundary
   rows; NaNs equal whatever their payload), the kernel's device us warm
   and cold in L2 beside its bytes bound, the call's and the host's time,
   and the eager path's (the record's ``dia_spmv`` entry, whose
   ``launches`` are phase 4's ``cg_ir``: one a product, checked there;
   phase 26 checks one a product and one a transposed product under
   autograd).  Alone: ``python3 -c "import time,
   torch, chip_smoke as c; d = torch.device('cuda', 0); _, s, V, *_ =
   c.flagship(48, d); c.phase_33(d, s['offsets'], V,
   time.perf_counter())"``;
34. ``assemble_vals_lattice`` on the card (``phase_34``): the nx=48
   flagship in f32 (phase 4's model) and f64 (phase 13's), at the model's
   sphere and a moved one: one launch of ``csrc/lattice_asm.cu`` a call,
   the table and ``ncut`` bit for bit ``assemble_vals_lattice_plain``'s on
   the card (+0 and -0 equal), exactly symmetric; the kernel's device us a
   call beside its bytes bound, its launches a call, the call's ms and the
   eager path's (the record's ``lattice_asm`` entry).  Alone: ``python3 -c
   "import time, torch, chip_smoke as c; from
   ngsxfem_tpu_torch.models.poisson import UnfittedPoisson as U; d =
   torch.device('cuda', 0); ms = {t: U(nx=48, dtype=t, device=d) for t in
   (torch.float32, torch.float64)}; c.phase_34(d, {t: (m,
   m.dia_structure()) for t, m in ms.items()}, time.perf_counter())"``.

Every failed check raises, so the script exits non-zero.  It imports nothing
of JAX.  The line before the last is the kernel record
``{"kernels": [...]}`` (B1, B2, ``coo_ell_place``, ``dia_spmv`` and
``lattice_asm``); the
last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

NX = 48
KERNEL_NX = (16, 48, 64)  # flagship sizes of phase 3
KERNEL_ITERS = (0, 1, 12, 50)
CG_ITERS = 50
IR_OUTER, IR_INNER = 4, 120
KERNEL_TOL = 5e-4     # f32 kernel vs plain (the reference's on-hardware bound)
SOLVE_TOL = 1e-10     # true f64 relative residual of cg_ir
MG_NX = (12, 24, 48)  # the cut-multigrid hierarchy of the ELL path
MG_TOL, MG_MAXITER, MG_MAX_ITERS = 1e-8, 60, 16
MG_TRUE_TOL = 1e-4    # true f64 relative residual of the f32 MG-CG solution
ELL_DIA_TOL = 1e-5    # ELL vs DIA operator, f32
LMG_NX, LMG_NX_BIG = (12, 24, 48), (16, 32, 64)   # lattice-MG hierarchies
LMG_TOL, LMG_MAXITER, LMG_MAX_ITERS = 1e-8, 100, 12
LMG_TRUE_TOL = {torch.float32: 1e-4, torch.float64: 1e-7}
JACOBI_MAXITER = 3000
F64_SOLVE_TOL = 1e-10   # true relative residual of the native-f64 solves
API_NX = (8, 12, 24, 48)  # examples.fictdom3d levels (EOC over the last 3)
# phase 16: the examples' published settings at the reference tests' sizes,
# then one card size each ("big"), built once through system()
DG_NX, DN_NX, ST_NX, NXF_NX, NXF_LU_NX = (20, 40), 20, (16, 32), 15, 64
# the reference tests' limits at those sizes: DG at nx=40, dn at nx=20,
# nxfem at nx=15, Stokes (u, p) at nx=16 (tests/test_workloads.py:74-83,
# :199-205, tests/test_ghostpenalty.py:13-18, tests/test_stokes.py:11-21)
DG_MAX, DN_MAX, NXF_MAX, ST_MAX = 0.006, 0.08, 0.08, (0.02, 0.05)
# and their convergence under the doubling of nx (DG; Stokes u, p)
DG_RATE, ST_RATE = 3.0, (3.0, 2.5)
BIG_NX = {"fictdom_dg_ghostpen": 256, "fictdom_dn_ghostpen": 256,
          "stokescutfem": 128, "nxfem": 256}
WINDOW = 100  # solver iterations profiled per card-size solve (phase 17)
TOOLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
F32_FLOP_PER_S = 67e12      # H100 SXM, f32 outside the tensor cores
F64_FLOP_PER_S = 34e12      # H100 SXM, f64 outside the tensor cores


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def flagship(nx, device):
    """Model, DIA structure, table, ncut, rhs, Jacobi inverse diagonal and
    host-setup seconds, built as bench.py builds the reference's flagship."""
    from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson

    t0 = time.perf_counter()
    model = UnfittedPoisson(nx=nx, dim=3, order=1, dtype=torch.float32,
                            device=device)
    struct = model.dia_structure()
    setup_s = time.perf_counter() - t0
    V, ncut = model.assemble_vals_lattice(model.vertices, model.lset, struct)
    k0 = int(np.searchsorted(struct["offsets"], 0))
    b = torch.as_tensor(np.where(model.active_dofs[struct["perm_inv"]], 1.0, 0.0),
                        dtype=torch.float32, device=device)
    dinv = torch.where(V[k0].abs() > 1e-30, 1.0 / V[k0], 1.0)
    return model, struct, V, ncut, b, dinv, setup_s


def is_symmetric(V, offsets):
    Vn = V.cpu().numpy()
    n = Vn.shape[1]
    offs = np.asarray(offsets)
    return all(np.array_equal(Vn[k][:n - o], Vn[int(np.flatnonzero(offs == -o)[0])][o:])
               for k, o in enumerate(offs) if o > 0)


def lattice_offsets(dim, w):
    """The 3**dim stencil offsets of a lattice with rows of width w."""
    return np.array(sorted({sum(e * w**k for k, e in enumerate(es))
                            for es in itertools.product((-1, 0, 1), repeat=dim)}))


def random_dia(rng, n, offsets, device):
    """Seeded exactly symmetric, diagonally dominant f32 DIA table
    (diagonal 0.01 + the row's absolute off-diagonal sum), a rhs and the
    Jacobi inverse diagonal."""
    offs = [int(o) for o in offsets]
    V = np.zeros((len(offs), n))
    for k, o in enumerate(offs):
        if 0 < o < n:
            d = -rng.uniform(0.0, 1.0, n - o)
            V[k, :n - o] = d
            V[offs.index(-o), o:] = d
    k0 = offs.index(0)
    V[k0] = 0.01 + np.abs(V).sum(0)
    V = torch.as_tensor(V, dtype=torch.float32, device=device)
    b = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                        device=device)
    return V, b, 1.0 / V[k0]


def dia_kernel_vs_plain(label, offs, V, b, dinv, iters_list):
    """Kernel vs plain (rel, residual) and kernel vs kernel (bitwise) for
    each iteration count.  Returns [(label, iters, rel, max|x_k - x_p|)]."""
    from ngsxfem_tpu_torch.solvers import dia_cg

    bn = float(torch.linalg.vector_norm(b))
    out = []
    for iters in iters_list:
        xk, rk = dia_cg.dia_cg_fused(offs, V, b, dinv, iters)
        xk2, rk2 = dia_cg.dia_cg_fused(offs, V, b, dinv, iters)
        xp, rp = dia_cg.dia_cg_fused_plain(offs, V, b, dinv, iters)
        torch.cuda.synchronize()
        rel = float(torch.linalg.vector_norm(xk - xp)
                    / torch.linalg.vector_norm(xp).clamp_min(1e-30))
        check(rel <= KERNEL_TOL, f"{label} iters={iters}: rel {rel}")
        check(abs(float(rk) - float(rp)) <= KERNEL_TOL * bn,
              f"{label} iters={iters}: res {float(rk)} vs {float(rp)}")
        check(torch.equal(xk, xk2) and torch.equal(rk, rk2),
              f"{label} iters={iters}: two kernel runs differ")
        out.append((label, iters, rel, float((xk - xp).abs().max())))
    return out


def time_ms(fn, reps=5):
    """Median CUDA-event time of `fn` in ms, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return statistics.median(ts)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ran_on(device):
    """Where ``SparseMatrix.to_ell`` runs for tensors on ``device``."""
    return "card" if device.type == "cuda" else "host"


def per_call_ms(fn, calls):
    """Mean CUDA-event time of one call of `fn` in ms, over `calls` calls
    back to back, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


PROFILE_TRIES = 3   # profiler windows device_kernels takes at most


def device_kernels(fn, calls, warm=True):
    """torch.profiler over `calls` calls of `fn` after a warm-up (left out
    with warm=False, for a caller that has just run `fn`): ({kernel name:
    (launches, device us)}, host wall ms of the window).  Every profiled
    `fn` launches kernels, so a window that recorded no device event (late
    in a long process torch.profiler now and then records none) is taken
    again, up to PROFILE_TRIES windows in all."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        out = {}
        for evt in prof.key_averages():
            us = getattr(evt, "device_time_total",
                         getattr(evt, "cuda_time_total", 0))
            if us and evt.count:
                out[evt.key] = (evt.count, us)
        if out:
            break
    return out, wall_ms


def device_busy(fn):
    """(device kernels, device busy ms, host wall ms) of one call of `fn`
    under torch.profiler, counted from the raw kineto events: the per-name
    tables that ``device_kernels`` builds took 52 s of host time for the
    ~230,000 kernels of a gradient at nx=48 (phase 26, beside an NVIDIA
    H100 80GB HBM3 at 700.00 W).  A window that recorded no
    device event is taken again, up to PROFILE_TRIES windows in all."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        n, ns = 0, 0
        for evt in prof.profiler.kineto_results.events():
            if str(evt.device_type()).endswith("CUDA"):
                n += 1
                ns += evt.duration_ns()
        if n:
            break
    return n, ns / 1e6, wall_ms


def bound(nbytes, flops, flop_per_s=F32_FLOP_PER_S):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over HBM bandwidth and the operations over the
    peak rate of their type (f32 unless given; H100 SXM data sheet)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / flop_per_s * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def dia_cg_bound(offsets, n, iters):
    """B1: inputs read once (the main and upper diagonals the kernel reads,
    b, dinv), x written once; per iteration 2 flops per offset per row for
    the SpMV plus 11 per row for the dots and updates."""
    rows = sum(1 for o in np.asarray(offsets).tolist() if o >= 0)
    return bound((rows * n + 2 * n) * 4 + n * 4,
                 iters * (2 * len(offsets) + 11) * n + 5 * n)


def ell_bound(n, K, ncols, itemsize):
    """B2 on the padded table: vals and int32 cols (n, K) and x read once,
    y written once; 2 flops per slot."""
    return nnz_bound(n * K, n, ncols, itemsize)


def nnz_bound(nnz, n, ncols, itemsize):
    """B2 whatever layout implements it: each of the table's ``nnz`` real
    slots (value and int32 column) and x read once, y written once; 2 flops
    per slot."""
    return bound(nnz * (4 + itemsize) + ncols * itemsize + n * itemsize,
                 2 * nnz, F64_FLOP_PER_S if itemsize == 8 else F32_FLOP_PER_S)


def ell_level(nx, device, model=None):
    """One level of the ELL path: model (reused when given), ELL structure,
    f32 table, ncut, interface-dof mask (dofs of cut elements, active)."""
    from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson

    if model is None:
        model = UnfittedPoisson(nx=nx, dim=3, order=1, dtype=torch.float32,
                                device=device)
    struct = model.ell_structure()
    V, ncut = model.assemble_vals_soa1(model.vertices, model.lset, struct)
    ve = model.lset_np[model.mesh.elements_np]
    cut = (ve < 0).any(1) & (ve > 0).any(1)
    ifm = np.zeros(model.ndof, bool)
    ifm[model.space.el2dof_np[cut].ravel()] = True
    return {"nx": nx, "model": model, "struct": struct, "V": V, "ncut": ncut,
            "if_mask": ifm & model.active_dofs}


def random_ell(rng, n, K, ncols, dtype, device, nan=False):
    """Seeded ELL table with trailing padding (col 0, val 0) of a random
    length in each row (so row lengths vary inside each slice of 32), the
    first rows all padding, and an x; ``nan`` poisons the whole table as
    ``_band_guard`` does."""
    cols = rng.integers(0, ncols, size=(n, K)).astype(np.int32)
    vals = rng.standard_normal((n, K))
    pad = np.arange(K)[None, :] >= rng.integers(0, K + 1, size=(n, 1))
    pad[:40] = True
    cols[pad] = 0
    vals[pad] = 0.0
    if nan:
        vals = vals * np.nan
    x = rng.standard_normal(ncols)
    return (torch.as_tensor(vals, dtype=dtype, device=device),
            torch.as_tensor(cols, device=device),
            torch.as_tensor(x, dtype=dtype, device=device))


def _same(a, b, bits):
    """a == b: bit for bit (``bits``) or under ``torch.equal``, NaN at the
    same places counting as equal."""
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    if bits:
        it = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
        return torch.equal(a[~na].view(it), b[~nb].view(it))
    return torch.equal(a[~na], b[~nb])


def ell_kernel_vs_plain(cases):
    """Each (label, vals, cols, x): on the table's layout, kernel ==
    ``sell_matvec_plain`` bit for bit, kernel == ``ell_matvec_plain`` under
    ``torch.equal``, two kernel runs bit for bit.  The layouts and launches
    made here are not any path's: both counters are put back.  Returns
    (the largest |y_kernel - y_plain|, the last case's layout)."""
    from ngsxfem_tpu_torch.solvers import ell_spmv

    counts = ell_spmv.launches, ell_spmv.layouts_built
    worst, L = 0.0, None
    for label, vals, cols, x in cases:
        L = ell_spmv.prepare_ell(vals, cols, x.shape[0])
        yk = ell_spmv.ell_matvec(vals, cols, x, L)
        yk2 = ell_spmv.ell_matvec(vals, cols, x, L)
        ys = ell_spmv.sell_matvec_plain(L, x)
        yp = ell_spmv.ell_matvec_plain(vals, cols, x)
        torch.cuda.synchronize()
        fin = torch.isfinite(yk) & torch.isfinite(yp)
        err = float((yk - yp)[fin].abs().max()) if fin.any() else 0.0
        check(_same(yk, yk2, True), f"{label}: two kernel runs differ")
        check(_same(yk, ys, True),
              f"{label}: kernel != sell_matvec_plain bit for bit")
        check(_same(yk, yp, False),
              f"{label}: kernel != ell_matvec_plain, max|dy| {err}")
        worst = max(worst, err)
    ell_spmv.launches, ell_spmv.layouts_built = counts
    return worst, L


def slice_stats(L):
    """'slice_K min/median/max, fill' of a layout, for the logs."""
    sk = L.slice_K.cpu().numpy()
    med = float(np.median(sk)) if sk.size else 0.0
    return (f"slice_K min/median/max {sk.min() if sk.size else 0}/{med:g}/"
            f"{L.kmax}, {L.nnz} real slots of {L.vals.shape[0]} stored, "
            f"slice fill {L.fill:.4f}")


def dia_as_ell(dia, perm, perm_inv):
    """The DIA table ``dia["V"]`` (vertex numbering) as an ELLMatrix in dof
    numbering: row d holds the n_off diagonals of vertex row perm[d] in
    offset order, out-of-range slots padded (col 0, val 0).  Its row sums
    run in ``dia_matvec``'s order, so it is the same f32 operator."""
    from ngsxfem_tpu_torch.solvers.sparse import ELLMatrix

    V = dia["V"]
    n = V.shape[1]
    offs = torch.as_tensor(np.asarray(dia["offsets"]), device=V.device)
    c = perm[:, None] + offs[None, :]
    ok = (c >= 0) & (c < n)
    cols = torch.where(ok, perm_inv[c.clamp(0, n - 1)], 0).to(torch.int32)
    vals = torch.where(ok, V[:, perm].T, 0.0).contiguous()
    return ELLMatrix(cols.contiguous(), vals, (n, n))


def ell_path(device, model48, dia, x_dia):
    """The ELL path: levels MG_NX (the finest reuses the DIA path's model),
    operator and Jacobi-CG-50 checks against the DIA path, FunctionalELLMG
    with prepare_host, MG-CG to MG_TOL.  Returns what phase 8 times."""
    from ngsxfem_tpu_torch.solvers import ell_spmv, sparse
    from ngsxfem_tpu_torch.solvers import mg as mgmod
    from ngsxfem_tpu_torch.solvers.krylov import CGSolver, cg
    from ngsxfem_tpu_torch.solvers.ell_spmv import ell_matvec
    from ngsxfem_tpu_torch.solvers.sparse import ELLMatrix, dia_matvec

    t0 = time.perf_counter()
    levels = [ell_level(nx, device, model48 if nx == model48.nx else None)
              for nx in MG_NX]
    levels_s = time.perf_counter() - t0
    fine = levels[-1]
    m = fine["model"]
    cols = torch.as_tensor(fine["struct"]["ell_cols"], device=device)
    A = ELLMatrix(cols, fine["V"], (m.ndof, m.ndof))

    # the ELL operator equals the DIA operator after the renumbering
    perm = torch.as_tensor(dia["perm"], device=device)
    perm_inv = torch.as_tensor(dia["perm_inv"], device=device)
    xr = torch.as_tensor(np.random.default_rng(11).standard_normal(m.ndof),
                         dtype=torch.float32, device=device)
    y_dia = dia_matvec(dia["offsets"], dia["V"], xr[perm_inv])[perm]
    rel_op = float(torch.linalg.vector_norm(A @ xr - y_dia)
                   / torch.linalg.vector_norm(y_dia))

    # Jacobi-CG-50 through CGSolver (the ELL kernel) against the DIA-PCG
    # kernel's x: on the ELL form of the DIA table, the same f32 operator,
    # and on the assembled ELL table, an operator that differs from it in
    # the last bits (f32 CG-50 on this system amplifies such differences)
    b = torch.as_tensor(np.where(m.active_dofs, 1.0, 0.0), dtype=torch.float32,
                        device=device)
    xd = x_dia[perm]
    A_dia = dia_as_ell(dia, perm, perm_inv)
    rel_dia_ell = float(torch.linalg.vector_norm(A_dia @ xr - y_dia)
                        / torch.linalg.vector_norm(y_dia))
    x50 = CGSolver(A_dia, maxsteps=CG_ITERS, tol=0.0) * b
    rel_cg = float(torch.linalg.vector_norm(x50 - xd)
                   / torch.linalg.vector_norm(xd))
    x50_asm = CGSolver(A, maxsteps=CG_ITERS, tol=0.0) * b
    rel_cg_asm = float(torch.linalg.vector_norm(x50_asm - xd)
                       / torch.linalg.vector_norm(xd))
    # true f64 relative residuals, on the assembled ELL table, of the two
    # f32 trajectories' x
    b64, A64 = b.double(), A.vals.double()
    res50 = [float(torch.linalg.vector_norm(
        b64 - ell_matvec(A64, A.cols, v.double()))
        / torch.linalg.vector_norm(b64)) for v in (xd, x50_asm)]

    # cut multigrid as the CG preconditioner
    t0 = time.perf_counter()
    prols = [mgmod.prolongation_coo_np(levels[i]["model"].space,
                                       levels[i + 1]["model"].space)
             for i in range(len(levels) - 1)]
    mg = mgmod.FunctionalELLMG(
        [lv["struct"]["ell_cols"] for lv in levels], prols,
        if_masks=[None] + [lv["if_mask"] for lv in levels[1:]], if_iters=10,
        active_masks=[lv["model"].active_dofs for lv in levels])
    mg_setup_s = time.perf_counter() - t0
    params = mg.params([lv["V"] for lv in levels], dtype=torch.float32,
                       device=device)
    layouts_before = ell_spmv.layouts_built
    t0 = time.perf_counter()
    pp = mg.prepare_host(params)
    sync(device)
    prepare_s = time.perf_counter() - t0
    # the solve's tables: the level operators (the finest is the CG's
    # operator too), the transfers and the interface blocks
    ntables = (len(pp["ops"]) + len(pp["R_ops"]) + len(pp["P_ops"])
               + sum(s is not None for s in pp["if_ops"]))

    def mgcg(pp=pp):
        return cg(pp["ops"][-1].matvec, b, M=lambda r: mg.apply(pp, r),
                  maxiter=MG_MAXITER, tol=MG_TOL)

    t0 = time.perf_counter()
    x, iters, res = mgcg()
    sync(device)
    mgcg_wall_s = time.perf_counter() - t0
    layouts = ell_spmv.layouts_built - layouts_before
    want = ntables if sparse._on_card(b) else 0  # none on the CPU
    check(layouts == want, f"MG-CG: {layouts} layouts built for "
                           f"{ntables} tables, {want} expected")
    return {"levels": levels, "A": A, "xr": xr, "b": b, "x": x,
            "iters": iters, "res": res, "rel_op": rel_op, "rel_cg": rel_cg,
            "rel_dia_ell": rel_dia_ell, "rel_cg_asm": rel_cg_asm,
            "res50": res50, "layouts": layouts, "params": params,
            "mg": mg, "pp": pp, "mgcg": mgcg, "levels_s": levels_s,
            "mg_setup_s": mg_setup_s, "prepare_s": prepare_s,
            "mgcg_wall_s": mgcg_wall_s}


def repeat_assembly(ell, reps=5):
    """The finest level's table assembled ``reps`` more times as a user's
    call assembles it (no global flag): each bitwise equal to the first,
    and MG-CG on each (``prepare_host`` anew) in the same number of
    iterations.  Returns the iteration counts."""
    fine = ell["levels"][-1]
    m, mg, params = fine["model"], ell["mg"], ell["params"]
    iters = []
    for _ in range(reps):
        V, _ = m.assemble_vals_soa1(m.vertices, m.lset, fine["struct"])
        check(_same(V.reshape(-1), fine["V"].reshape(-1), True),
              f"assemble_vals_soa1 nx={fine['nx']}: the table changed "
              f"between two assemblies")
        pp = mg.prepare_host(dict(params, vals=params["vals"][:-1] + [V]))
        iters.append(int(ell["mgcg"](pp)[1]))
    check(iters == [ell["iters"]] * reps,
          f"MG-CG iterations over {reps} assemblies {iters}, first "
          f"{ell['iters']}")
    return iters


# --- phases 9-11: general cut quadrature and the quadrature path ----------

EXACT_TOL = 5e-15      # x (order + 1)^2, the reference suite's bound
SPHERE_R = 0.4
SPHERE_NX = {"tet": (16, 32, 64), "hex": (12, 24, 48)}
EOC_MIN = 1.75
ORDER2_NX = 24
QUAD_OP_TOL = {torch.float64: 1e-11, torch.float32: 1e-5}


def _mesh(T, et, n):
    if et == "segm":
        return T.Make1DMesh(n)
    if et in ("trig", "quad"):
        return T.MakeStructured2DMesh(quads=et == "quad", nx=n, ny=n)
    return T.MakeStructured3DMesh(hexes=et == "hex", nx=n, ny=n, nz=n)


def _p1(T, mesh, lset_cf, device, dtype=torch.float64):
    gf = T.GridFunction(T.H1(mesh, order=1, device=device), dtype=dtype)
    T.InterpolateToP1(lset_cf, gf)
    return gf


def cut_exactness(device):
    """The reference suite's exactness cases (tests/test_straightcutrule.py:
    17-137, tests/test_quadchallenges.py) on the card, f64.  Returns (cases,
    worst error / bound) and raises past the bound."""
    import ngsxfem_tpu_torch as T

    x, y, z = T.x, T.y, T.z
    worst, n = 0.0, 0

    def case(et, N, lset_cf, f, order, dt, ref, policy=None, tol=None):
        nonlocal worst, n
        mesh = _mesh(T, et, N)
        ld = {"levelset": _p1(T, mesh, lset_cf, device),
              "domain_type": getattr(T, dt)}
        if policy:
            ld["quad_dir_policy"] = policy
        got = T.Integrate(ld, f, mesh, order=order)
        bound = tol if tol is not None else EXACT_TOL * (order + 1) ** 2
        check(abs(got - ref) <= bound,
              f"exactness {et} N={N} order={order} {dt}: {got} vs {ref}")
        worst = max(worst, abs(got - ref) / bound)
        n += 1
        return got

    xa = 0.78522
    for alpha in (2, 4, 8):
        for dt, ref in (("POS", xa ** (alpha + 1) / (alpha + 1)),
                        ("NEG", (1 - xa ** (alpha + 1)) / (alpha + 1)),
                        ("IF", xa ** alpha)):
            case("segm", 1, xa - x, x ** alpha, alpha, dt, ref)
    for et in ("trig", "quad"):
        for N in (1, 10):
            for order in (2, 4, 8):
                for dt, ref in (("NEG", 7 / 8), ("POS", 1 / 8),
                                ("IF", 1 / np.sqrt(2))):
                    case(et, N, 1 - 2 * x - 2 * y, T.CoefficientFunction(1),
                         order, dt, ref)
        for order in (2, 4, 8):
            for alpha in (0, 1, 2):
                vp = 2 ** (-alpha - 2) / (alpha * alpha + 3 * alpha + 2)
                for c in (x, y):
                    for dt, ref in (("POS", vp), ("NEG", 1 / (alpha + 1) - vp)):
                        case(et, 1, 1 - 2 * x - 2 * y, c ** alpha, order, dt,
                             ref)
        for eps in (1e-1, 1e-2, 5e-3, 1e-3, 0):
            for lcf in (1 - 2 * x + eps * (y - 0.5), 1 - 2 * y + eps * (x - 0.5)):
                for dt, ref in (("NEG", 0.5), ("POS", 0.5),
                                ("IF", np.sqrt(1 + eps * eps / 4))):
                    case(et, 1, lcf, T.CoefficientFunction(1), 2, dt, ref)
    plane3 = 1 - 2 * x - 2 * y - 2 * z
    for et in ("tet", "hex"):
        for order in (2, 4, 8):
            for dt, ref in (("POS", 1 / 48), ("NEG", 47 / 48),
                            ("IF", np.sqrt(3) / 8)):
                case(et, 1, plane3, T.CoefficientFunction(1), order, dt, ref)
                if et == "hex":
                    case(et, 2, plane3, 1.0, order, dt, ref)
        for alpha in (0, 1, 2):
            vp = 2 ** (-alpha - 3) / (alpha ** 3 + 6 * alpha ** 2 + 11 * alpha + 6)
            for c in (x, y, z):
                for dt, ref in (("POS", vp), ("NEG", 1 / (alpha + 1) - vp)):
                    case(et, 1, plane3, c ** alpha, 4, dt, ref)
                    if et == "hex":
                        case(et, 5, plane3, c ** alpha, 4, dt, ref,
                             policy="OPTIMAL")
    vp = 2 ** (-5) / (8 + 24 + 22 + 6)
    case("hex", 2, plane3, x ** 2, 4, "POS", vp, policy="OPTIMAL")
    # the trilinear TPMC level set (tests/test_quadchallenges.py:77-135)
    tpmc = x * ((7 * y - 13) * z + 6) + y * (3 - 8 * z) + 8 * z - 4
    for order in (2, 4, 6):
        neg = case("hex", 1, tpmc, 1.0, order, "NEG", 0.5167820912197415,
                   tol=0.75)
        pos = case("hex", 1, tpmc, 1.0, order, "POS", 0.4825797907263282,
                   tol=0.75)
        check(abs(neg + pos - 1.0) <= 1e-12, f"TPMC order {order}: NEG+POS")
    for order in (2, 4):
        for dt, ref, tol in (("NEG", 0.51681, 1e-3), ("POS", 0.48319, 1e-3),
                             ("IF", 1.82169, 5e-3)):
            case("hex", 10, tpmc, 1.0, order, dt, ref, tol=tol)
    # the plane on 256 x 256 meshes (131,072 triangles, 65,536 quads)
    for et in ("trig", "quad"):
        for dt, ref in (("NEG", 7 / 8), ("POS", 1 / 8), ("IF", 1 / np.sqrt(2))):
            case(et, 256, 1 - 2 * x - 2 * y, 1.0, 4, dt, ref, tol=1e-12)
    return n, worst


def sphere_levels(device):
    """Order-4 NEG volume and IF area of the ball r=0.4 at the centre of the
    unit cube on tets and hexes (SPHERE_NX): errors, EOC, NEG + POS, and
    element_wise sums.  Returns the rows and the finest tet mesh with its
    level set (reused by the CutInfo check and phase 11)."""
    import ngsxfem_tpu_torch as T

    c = T.sqrt((T.x - 0.5) ** 2 + (T.y - 0.5) ** 2 + (T.z - 0.5) ** 2) - SPHERE_R
    exact = {"NEG": 4 / 3 * np.pi * SPHERE_R ** 3, "IF": 4 * np.pi * SPHERE_R ** 2}
    rows = []
    for et, nxs in SPHERE_NX.items():
        err = {"NEG": [], "IF": []}
        for nx in nxs:
            mesh = _mesh(T, et, nx)
            lset = _p1(T, mesh, c, device)
            if et == "tet":
                finest = (mesh, lset)
            got = {}
            for dt in ("NEG", "POS", "IF"):
                ld = {"levelset": lset, "domain_type": getattr(T, dt)}
                got[dt] = T.Integrate(ld, 1.0, mesh, order=4)
                ew = T.Integrate(ld, 1.0, mesh, order=4, element_wise=True)
                check(abs(float(ew.sum()) - got[dt]) <= 1e-12 * got[dt],
                      f"{et} nx={nx} {dt}: element_wise sum")
            check(abs(got["NEG"] + got["POS"] - 1.0) <= 1e-12,
                  f"{et} nx={nx}: NEG + POS = {got['NEG'] + got['POS']}")
            for dt in err:
                err[dt].append(abs(got[dt] - exact[dt]))
        eoc = {dt: float(np.log(e[-2] / e[-1]) / np.log(2)) for dt, e in err.items()}
        for dt in eoc:
            check(eoc[dt] >= EOC_MIN, f"{et} {dt}: EOC {eoc[dt]} < {EOC_MIN}")
        rows.append((et, nxs, err, eoc, peak_gib(device)))
    return rows, finest


def autograd_check(device):
    """dV/dr of the ball through the cut rule by torch.autograd at tets
    nx=32, r=0.31 (tests/test_misc.py:331-343): near 4 pi r^2, and equal to
    the central difference (f64, eps 1e-5).  Returns (grad, fd)."""
    from ngsxfem_tpu_torch.mesh.mesh import map_points, det_and_inv
    from ngsxfem_tpu_torch.mesh.structured import MakeStructured3DMesh
    from ngsxfem_tpu_torch.ops.straightcut import cut_rule_element

    m = MakeStructured3DMesh(hexes=False, nx=32, ny=32, nz=32)
    dist = torch.as_tensor(np.sqrt(((m.vertices_np - 0.5) ** 2).sum(1))[m.elements_np],
                           device=device)
    coords = torch.as_tensor(m.vertices_np[m.elements_np], device=device)

    def vol(r):
        rule = cut_rule_element("tet", dist - r, 2)
        _, J = map_points("tet", coords, rule.pts)
        return (rule.w * (rule.side == 0) * det_and_inv(J)[0].abs()).sum()

    r = torch.tensor(0.31, dtype=torch.float64, device=device, requires_grad=True)
    vol(r).backward()
    g = float(r.grad)
    with torch.no_grad():
        fd = float((vol(torch.tensor(0.31 + 1e-5, dtype=torch.float64, device=device))
                    - vol(torch.tensor(0.31 - 1e-5, dtype=torch.float64,
                                       device=device))) / 2e-5)
    check(abs(g - 4 * np.pi * 0.31 ** 2) < 0.03, f"dV/dr {g} vs 4 pi r^2")
    check(abs(g - fd) <= 1e-6 * abs(fd), f"dV/dr {g} vs central difference {fd}")
    return g, fd


def cutinfo_check(mesh, lset):
    """CutInfo at the finest tet level: element counts equal a numpy sign
    count of the eps-guarded vertex values, ratios in [0, 1], and the
    facets with neighbours (HASNEG, IF) are non-empty and lie between such
    elements.  Returns (NEG, POS, IF counts, marked facets)."""
    import ngsxfem_tpu_torch as T
    from ngsxfem_tpu_torch.integrate import vertex_local_ids

    ci = T.CutInfo(mesh, lset)
    v = lset.vec.NumPy()[lset.space.el2dof_np[:, vertex_local_ids(mesh.et, 1)]]
    v = np.where(np.abs(v) < 1e-14, 1e-14, v)
    neg, pos = (v < 0).any(1), (v > 0).any(1)
    counts = tuple(ci.GetElementsOfType(getattr(T, dt)).NumSet()
                   for dt in ("NEG", "POS", "IF"))
    host = (int((neg & ~pos).sum()), int((pos & ~neg).sum()), int((neg & pos).sum()))
    check(counts == host, f"CutInfo counts {counts} != host {host}")
    r = ci.GetCutRatios()
    check(bool(((r >= 0) & (r <= 1)).all()), "cut ratios outside [0, 1]")
    hn, hi = ci.GetElementsOfType(T.HASNEG), ci.GetElementsOfType(T.IF)
    f = T.GetFacetsWithNeighborTypes(mesh, a=hn, b=hi)
    check(f.NumSet() > 0, "no facets with neighbours (HASNEG, IF)")
    f2e = mesh.facet2el_np[f.np]
    check(bool(((f2e >= 0).all(1) & hn.np[f2e].all(1) & hi.np[f2e].any(1)).all()),
          "a marked facet is not between HASNEG and IF elements")
    return counts, f.NumSet()


def quad_flagship(device, model, struct, V32):
    """Phase 10: the quadrature path of the flagship at nx=48 against the
    lattice DIA operator, its rhs against Integrate, solve() in f32, and the
    order-2 symmetry probe at nx=24.  Returns what phase 10 prints."""
    import ngsxfem_tpu_torch as T
    from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson
    from ngsxfem_tpu_torch.solvers.sparse import dia_matvec

    out = {}
    offs = struct["offsets"]
    perm = torch.as_tensor(struct["perm"], device=device)
    perm_inv = torch.as_tensor(struct["perm_inv"], device=device)
    v64 = torch.as_tensor(model.mesh.vertices_np, dtype=torch.float64, device=device)
    l64 = torch.as_tensor(model.lset_np, dtype=torch.float64, device=device)
    V64, _ = model.assemble_vals_lattice(v64, l64, struct)
    xr = np.random.default_rng(12).standard_normal(model.ndof)
    for dt, (v, l, V) in ((torch.float64, (v64, l64, V64)),
                          (torch.float32, (model.vertices, model.lset, V32))):
        x = torch.as_tensor(xr, dtype=dt, device=device)
        y = model.apply(v, l, x)
        yd = dia_matvec(offs, V, x[perm_inv])[perm]
        rel = float(torch.linalg.vector_norm(y - yd) / torch.linalg.vector_norm(yd))
        check(rel <= QUAD_OP_TOL[dt], f"quadrature vs DIA operator {dt}: rel {rel}")
        out[f"op_{str(dt)[6:]}"] = rel

    # rhs: sum and a random projection against Integrate over NEG
    one = lambda p: torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    b = model.rhs(v64, l64, one)
    mesh = model.mesh
    lset = T.GridFunction(T.H1(mesh, order=1, device=device))
    lset.vec.data = l64[torch.as_tensor(model.p1dof2vertex, device=device)]
    ld = {"levelset": lset, "domain_type": T.NEG}
    vol = T.Integrate(ld, 1.0, mesh, order=5)
    u = T.GridFunction(T.H1(mesh, order=1, device=device))
    u.vec.data = torch.as_tensor(xr, device=device)
    proj = T.Integrate(ld, u, mesh, order=5)
    out["rhs_sum"] = (float(b.sum()), vol)
    out["rhs_proj"] = (float(b @ u.vec.data), proj)
    check(abs(float(b.sum()) - vol) <= 1e-12 * vol, f"sum(rhs) {float(b.sum())} vs {vol}")
    check(abs(float(b @ u.vec.data) - proj) <= 1e-12 * abs(b).sum().item(),
          f"x.rhs {float(b @ u.vec.data)} vs Integrate(NEG, u_x) {proj}")

    # solve() in f32 with its defaults; its recursion residual against the
    # true residual of x in f64 on the f64 operator
    t0 = time.perf_counter()
    x, k, res = model.solve()
    sync(device)
    out["solve_s"] = time.perf_counter() - t0
    check(bool(torch.isfinite(x).all()), "solve(): non-finite x")
    b32 = model.rhs(model.vertices, model.lset, one)
    true64 = float(torch.linalg.vector_norm(
        b32.double() - model.apply(v64, l64, x.double())))
    out["solve"] = (k, float(res), true64, float(torch.linalg.vector_norm(b32)))
    check(abs(float(res) - true64) <= 1e-2 * true64,
          f"solve(): recursion residual {float(res)} vs true f64 {true64}")

    # order 2: symmetry of the f32 operator (bench.py:651-656), the dots
    # accumulated in f64 as krylov._vdot does (an f32 dot alone gives ~5e-7)
    m2 = UnfittedPoisson(nx=ORDER2_NX, dim=3, order=2, dtype=torch.float32,
                         device=device)
    op = m2.operator(m2.vertices, m2.lset)
    uu = torch.cos(torch.arange(m2.ndof, dtype=torch.float32, device=device))
    vv = torch.sin(torch.arange(m2.ndof, dtype=torch.float32, device=device))
    dot = lambda a, b: float(torch.dot(a.double(), b.double()))
    uav, vau = dot(uu, op(vv)), dot(vv, op(uu))
    sym = abs(uav - vau) / max(abs(uav), 1e-30)
    check(sym <= 1e-6, f"order-2 symmetry probe {sym}")
    out["sym2"] = (m2.ndof, sym)
    return out


def lattice_level(model, struct, V):
    """One level of the lattice multigrid, as bench.py builds it: offsets,
    DIA table, active mask and interface mask (dofs of cut elements, active)
    in vertex-lex order."""
    from ngsxfem_tpu_torch.config import config

    eps = config.lset_eps
    ge = model.lset_np[model.mesh.elements_np]
    ge = np.where(np.abs(ge) < eps, np.where(ge >= 0, eps, -eps), ge)
    cut = (ge < 0).any(1) & (ge > 0).any(1)
    ifd = np.zeros(model.ndof, bool)
    ifd[model.space.el2dof_np[cut].ravel()] = True
    pinv = struct["perm_inv"]
    return {"nx": model.nx, "model": model, "struct": struct, "V": V,
            "offsets": struct["offsets"], "act": model.active_dofs[pinv],
            "if_mask": (ifd & model.active_dofs)[pinv]}


def new_lattice_level(nx, device, dtype):
    from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson

    model = UnfittedPoisson(nx=nx, dim=3, order=1, dtype=dtype, device=device)
    struct = model.dia_structure()
    V, _ = model.assemble_vals_lattice(model.vertices, model.lset, struct)
    return lattice_level(model, struct, V)


def lattice_mg(levels, dtype, device, jacobi=True):
    """LatticeDIAMG on `levels` (coarse to fine) as the preconditioner of
    krylov.cg to LMG_TOL, beside Jacobi-CG to the same tolerance.  Checks
    the coarse inverse, the residuals and the iteration limits; returns the
    numbers and the closures that phase 15 times."""
    from ngsxfem_tpu_torch.solvers.krylov import cg
    from ngsxfem_tpu_torch.solvers.latticemg import LatticeDIAMG
    from ngsxfem_tpu_torch.solvers.sparse import dia_matvec

    nxs = [lv["nx"] for lv in levels]
    mg = LatticeDIAMG([lv["offsets"] for lv in levels], [n + 1 for n in nxs],
                      dim=3, active_masks=[lv["act"] for lv in levels],
                      if_masks=[None] + [lv["if_mask"] for lv in levels[1:]])
    params = mg.params([lv["V"] for lv in levels], dtype=dtype, device=device)
    t0 = time.perf_counter()
    pp = mg.prepare_safe(params)   # raises on a bad coarse inverse
    sync(device)
    prepare_s = time.perf_counter() - t0
    label = f"lattice MG nx={nxs} {dtype}"
    ainv_res = float(pp["ainv0_res"])
    check(ainv_res <= 1e-3, f"{label}: coarse inverse residual {ainv_res}")
    offs = levels[-1]["offsets"]
    Vf = pp["vals"][-1]
    b = torch.as_tensor(np.where(levels[-1]["act"], 1.0, 0.0), dtype=dtype,
                        device=device)
    bn = float(torch.linalg.vector_norm(b))
    mv = lambda z: dia_matvec(offs, Vf, z)
    mgcg = lambda: cg(mv, b, M=lambda r: mg.apply(pp, r),
                      maxiter=LMG_MAXITER, tol=LMG_TOL)
    x, k, res = mgcg()
    check(float(res) <= 1.5 * LMG_TOL * bn,
          f"{label}: MG-CG res {float(res)} > {1.5 * LMG_TOL * bn}")
    check(k <= LMG_MAX_ITERS, f"{label}: MG-CG took {k} iterations")
    r64 = b.double() - dia_matvec(offs, Vf.double(), x.double())
    true_rel = float(torch.linalg.vector_norm(r64)) / bn
    check(true_rel <= LMG_TRUE_TOL[dtype],
          f"{label}: MG-CG true f64 rel res {true_rel}")
    out = {"nxs": nxs, "dtype": dtype, "mg": mg, "params": params, "pp": pp,
           "prepare_s": prepare_s, "ainv_res": ainv_res, "iters": k,
           "rel": float(res) / bn, "true_rel": true_rel, "mgcg": mgcg,
           "x": x, "n0": int(pp["ainv0"].shape[0])}
    if jacobi:
        k0 = int(np.searchsorted(offs, 0))
        dinv = torch.where(Vf[k0].abs() > 1e-30, 1.0 / Vf[k0], 1.0)
        jcg = lambda: cg(mv, b, M=lambda r: dinv * r, maxiter=JACOBI_MAXITER,
                         tol=LMG_TOL)
        _, kj, rj = jcg()
        check(k < kj / 2, f"{label}: MG-CG {k} iterations, Jacobi-CG {kj}")
        out.update(jacobi_iters=kj, jacobi_rel=float(rj) / bn, jcg=jcg)
    return out


def native_f64(device, V32, b32):
    """Phase 13: the flagship in native f64 at nx=48.  Returns the model,
    its table and what phase 15 times."""
    from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson
    from ngsxfem_tpu_torch.solvers.krylov import cg, cg_ir
    from ngsxfem_tpu_torch.solvers.sparse import dia_matvec

    model = UnfittedPoisson(nx=NX, dim=3, order=1, dtype=torch.float64,
                            device=device)
    struct = model.dia_structure()
    V, ncut = model.assemble_vals_lattice(model.vertices, model.lset, struct)
    offs = struct["offsets"]
    check(V.dtype == torch.float64, f"f64 table has dtype {V.dtype}")
    dv = float((V - V32.to(V.device).double()).abs().max() / V.abs().max())
    check(dv <= 2e-5, f"f64 vs f32 lattice table: {dv} of max|V|")
    check(is_symmetric(V, offs), "f64 DIA table is not exactly symmetric")
    k0 = int(np.searchsorted(offs, 0))
    b = b32.double()
    bn = float(torch.linalg.vector_norm(b))
    dinv = torch.where(V[k0].abs() > 1e-30, 1.0 / V[k0], 1.0)
    mv64 = lambda v: dia_matvec(offs, V, v)
    V32b = V.float()
    dinv32 = dinv.float()
    mv32 = lambda v: dia_matvec(offs, V32b, v)
    pcg = lambda: cg(mv64, b, M=lambda r: dinv * r, maxiter=JACOBI_MAXITER,
                     tol=1e-12)
    ir = lambda: cg_ir(mv32, mv64, b, M=lambda r: dinv32 * r, outer=IR_OUTER,
                       inner=IR_INNER)
    x, k, _ = pcg()
    pcg_rel = float(torch.linalg.vector_norm(b - mv64(x))) / bn
    check(pcg_rel <= F64_SOLVE_TOL, f"f64 PCG true rel res {pcg_rel}")
    x_ir, res_ir = ir()
    ir_rel = float(res_ir) / bn
    check(ir_rel <= F64_SOLVE_TOL, f"cg_ir true rel res {ir_rel}")
    dx = float(torch.linalg.vector_norm(x - x_ir) / torch.linalg.vector_norm(x))
    check(dx <= 1e-8, f"f64 PCG vs cg_ir solutions: rel {dx}")
    return {"model": model, "struct": struct, "V": V, "ncut": int(ncut),
            "dv": dv, "pcg_iters": k, "pcg_rel": pcg_rel, "ir_rel": ir_rel,
            "dx": dx, "pcg": pcg, "ir": ir}


def fictdom3d_forms(T, mesh, lset_values, lam, gamma, device):
    """The flagship's three integrators and its load written as weak forms
    on `mesh` with the P1 level set `lset_values` (one per vertex), as
    examples/fictdom3d.py writes them.  Returns (a, f, free dofs), not yet
    assembled."""
    P1 = T.H1(mesh, order=1, device=device)
    lsetp1 = T.GridFunction(P1)
    from ngsxfem_tpu_torch.integrate import _p1_vertex_dofs

    vec = np.zeros(P1.ndof)
    vec[_p1_vertex_dofs(P1)] = lset_values
    lsetp1.vec.data = vec
    ci = T.CutInfo(mesh, lsetp1)
    hasneg = ci.GetElementsOfType(T.HASNEG)
    hasif = ci.GetElementsOfType(T.IF)
    Vh = T.H1(mesh, order=1, dgjumps=True, device=device)
    u, v = Vh.TnT()
    h = T.specialcf.mesh_size
    n = 1.0 / T.Norm(T.grad(lsetp1)) * T.grad(lsetp1)
    neg = {"levelset": lsetp1, "domain_type": T.NEG}
    iff = {"levelset": lsetp1, "domain_type": T.IF}
    a = T.BilinearForm(Vh)
    a += T.SymbolicBFI(neg, form=T.grad(u) * T.grad(v),
                       definedonelements=hasneg)
    a += T.SymbolicBFI(iff, form=-(T.grad(u) * n) * v - (T.grad(v) * n) * u
                       + lam / h * u * v)
    a += T.SymbolicFacetPatchBFI(
        form=gamma / (h * h) * (u - u.Other()) * (v - v.Other()),
        definedonelements=T.GetFacetsWithNeighborTypes(mesh, a=hasneg,
                                                       b=hasif))
    f = T.LinearForm(Vh)
    f += T.SymbolicLFI(neg, form=T.CoefficientFunction(6.0) * v,
                       definedonelements=hasneg)
    return a, f, T.GetDofsOfElements(Vh, hasneg)


def forms_vs_model(T, model, struct, V, device):
    """The weak-form operator on the hand-written model's own mesh and level
    set against the model's DIA operator, on active dofs, over three seeded
    vectors (f64).  Returns (worst rel, the assembled form)."""
    from ngsxfem_tpu_torch.solvers.sparse import dia_matvec

    a, _, _ = fictdom3d_forms(T, model.mesh, model.lset_np, model.lam_nitsche,
                              model.gamma_gp, device)
    a.Assemble()
    act = model.active_dofs
    perm, pinv = struct["perm"], struct["perm_inv"]
    rng = np.random.default_rng(2028)
    worst = 0.0
    for _ in range(3):
        xv = np.where(act, rng.standard_normal(model.ndof), 0.0)
        y_forms = (a.mat * torch.as_tensor(xv, device=device)).cpu().numpy()
        y_dia = dia_matvec(struct["offsets"], V, torch.as_tensor(
            xv[pinv], dtype=V.dtype, device=V.device)).cpu().numpy()[perm]
        worst = max(worst, float(np.linalg.norm((y_forms - y_dia)[act])
                                 / np.linalg.norm(y_dia[act])))
    return worst, a


def public_api(T, device, model64, struct64, V64):
    """Phase 14: the examples through BilinearForm/LinearForm.  Returns the
    numbers of the phase and the closures that phase 15 times."""
    from ngsxfem_tpu_torch.examples import cutfem, fictdom3d, fictdom_ghostpen
    from ngsxfem_tpu_torch.solvers import ell_spmv, sparse

    out = {}
    errs = [fictdom3d.run(nx=nx, verbose=False, device=device)
            for nx in API_NX[:-1]]

    # nx = 48 step by step, as examples.fictdom3d.run does it, so that one
    # assembled system serves the error, both solves and the kernel check
    nx = API_NX[-1]
    a, f, Vh, free, l2error = fictdom3d.system(nx=nx, device=device)
    mesh = Vh.mesh
    check(mesh.ne == 6 * nx**3 and mesh.nv == (nx + 1) ** 3,
          f"fictdom3d mesh ne={mesh.ne} nv={mesh.nv}")
    a.Assemble()
    f.Assemble()
    check(a.mat.vals.is_cuda == (device.type == "cuda")
          and a.mat.vals.dtype == torch.float64, "a.mat is not f64 on the device")
    S = a.mat.to_scipy()
    asym = float(abs(S - S.T).max() / abs(S).max())
    check(asym <= 1e-12, f"a.mat symmetry {asym} of its largest entry")
    ell = a.mat.ell()
    n, K = ell.vals.shape
    out["K"], out["nrows"] = int(K), int(n)
    if device.type == "cuda":
        # kernel B2 against its plain versions on the table, type and
        # vectors this path gives it: f64, K=24, a seeded x and the
        # free-masked load, and its times
        out["b2"] = b2_on_table(f"fictdom3d forms nx={nx}", ell, free.np,
                                f.vec.data, device)
    inv_lu = a.mat.Inverse(free, inverse="umfpack")
    t0 = time.perf_counter()
    x_lu = inv_lu * f.vec.data        # factorizes on the host, then solves
    sync(device)
    out["lu_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    inv_lu * f.vec.data               # the factors are kept
    sync(device)
    out["lu_again_s"] = time.perf_counter() - t0
    gfu = T.GridFunction(Vh)
    gfu.vec.data = x_lu
    errs.append(l2error(gfu))
    check(errs[0] < 0.06, f"fictdom3d nx={API_NX[0]} L2 error {errs[0]}")
    eocs = [float(np.log2(errs[i] / errs[i + 1])) for i in range(1, len(errs) - 1)]
    check(min(eocs) >= EOC_MIN, f"fictdom3d L2 errors {errs}: EOC {eocs}")
    out["errs"], out["eocs"] = errs, eocs
    before = ell_spmv.launches
    layouts_before = ell_spmv.layouts_built
    with counted_products("cg") as cnt:
        x_cg = a.mat.Inverse(free, inverse="cg") * f.vec.data
    sync(device)
    out["cg_launches"] = ell_spmv.launches - before
    out["cg_iters"], out["cg_products"] = cnt.iters, cnt.products
    if device.type == "cuda":
        check(out["cg_launches"] == cnt.products > 0,
              f"'cg' solve: {out['cg_launches']} ell_spmv launches for "
              f"{cnt.products} products")
    dsol = float(torch.linalg.vector_norm(x_cg - x_lu)
                 / torch.linalg.vector_norm(x_lu))
    check(dsol <= 1e-8, f"direct vs 'cg' solution: rel {dsol}")
    # the default Inverse(): Jacobi-CG on the card (this SPD free block),
    # the host LU on the CPU; the ELL view's layout is already built
    before = ell_spmv.launches
    t0 = time.perf_counter()
    with counted_products("cg") as cnt:
        inv = a.mat.Inverse(free)
        x_def = inv * f.vec.data
    sync(device)
    out["default_s"] = time.perf_counter() - t0
    out["default_path"] = inv.path
    out["default_launches"] = ell_spmv.launches - before
    out["default_iters"], out["default_products"] = cnt.iters, cnt.products
    out["layouts"] = ell_spmv.layouts_built - layouts_before
    want = int(sparse._on_card(a.mat.vals))  # none on the CPU
    check(out["layouts"] == want, f"the 'cg' and default solves built "
                                  f"{out['layouts']} layouts for one table, "
                                  f"{want} expected")
    if device.type == "cuda":
        check(inv.path == "device_cg" and out["default_launches"]
              == cnt.products == cnt.iters + 1,
              f"default Inverse(): path {inv.path}, "
              f"{out['default_launches']} ell_spmv launches for "
              f"{cnt.products} products, {cnt.iters} iterations")
    out["dsol_default"] = float(torch.linalg.vector_norm(x_def - x_lu)
                                / torch.linalg.vector_norm(x_lu))
    check(out["dsol_default"] <= 1e-8,
          f"named LU vs default Inverse() solution: rel {out['dsol_default']}")
    out.update(asym=asym, dsol=dsol, nfree=free.NumSet(),
               ntriplets=int(a.mat.vals.shape[0]), a=a, f=f, free=free)

    # the same integrators on the hand-written model's mesh and level set
    out["vs_model"], _ = forms_vs_model(T, model64, struct64, V64, device)
    check(out["vs_model"] <= 1e-12,
          f"forms operator vs UnfittedPoisson's DIA operator: {out['vs_model']}")

    # the two 2D workloads, card against this host's CPU
    for name, mod, kw in (("fictdom_ghostpen", fictdom_ghostpen, {"nx": 40}),
                          ("cutfem", cutfem, {"nx": 30})):
        e_dev = mod.run(verbose=False, device=device, **kw)
        e_cpu = mod.run(verbose=False, device="cpu", **kw)
        check(abs(e_dev - e_cpu) <= 1e-8 * e_cpu,
              f"{name}: card {e_dev} vs CPU {e_cpu}")
        out[name] = (e_dev, e_cpu)
    check(abs(out["cutfem"][0] - 0.0188) < 5e-4,
          f"cutfem L2 error {out['cutfem'][0]}")
    return out


# --- phases 16-17: skeleton, vector and XFEM workloads --------------------


class counted_products:
    """While active, counts the matrix products and iterations of
    ``krylov.<name>`` (``cg`` or ``minres``), which the solver objects
    call through the module."""

    def __init__(self, name):
        from ngsxfem_tpu_torch.solvers import krylov

        self.mod, self.name = krylov, name
        self.products, self.iters = 0, None

    def __enter__(self):
        self.orig = getattr(self.mod, self.name)

        def run(matvec, *args, **kw):
            def mv(z):
                self.products += 1
                return matvec(z)
            res = self.orig(mv, *args, **kw)
            self.iters = int(res[1])
            return res

        setattr(self.mod, self.name, run)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


def event_ms(fn):
    """(fn(), ms by CUDA events) of one call (by the host clock without a
    card, as the CPU rehearsal of the tests runs it)."""
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def b2_timed(label, A, x):
    """Kernel B2 on the ``ELLMatrix`` A with the seeded x: us per call
    (events), device us per launch (``torch.profiler``), the row-major
    kernel it replaced on the same table (device us, equal to the plain
    version under ``torch.equal``), the ms of the kernel's plain version
    ``sell_matvec_plain`` and of ``ell_matvec_plain``, the nnz bound (the
    least time of the function: ``bound_ms`` of the record) and the padded
    one, and cuSPARSE.  Launches and layouts made here are put back."""
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    import torch_ell_spmv_before_after as before_after
    from ngsxfem_tpu_torch.solvers import ell_spmv
    from ngsxfem_tpu_torch.solvers.sparse import ELLMatrix

    counts = ell_spmv.launches, ell_spmv.layouts_built
    A = ELLMatrix(A.cols, A.vals, A.shape)  # its own layout, not the path's
    n, K = A.vals.shape
    L = A.layout()
    s = A.vals.element_size()
    out = {"label": label, "n": int(n), "K": int(K),
           "dtype": str(A.vals.dtype)[6:], "fill": L.fill, "nnz": L.nnz,
           "slices": slice_stats(L)}
    out["ms"] = per_call_ms(lambda: A @ x, 100)
    out["dev_us"] = before_after.device_us(lambda: A @ x,
                                           before_after.NEW_KERNEL)
    old = before_after.load_rowmajor()
    y_old = before_after.rowmajor_matvec(old, A.vals, A.cols, x)
    check(torch.equal(y_old, ell_spmv.ell_matvec_plain(A.vals, A.cols, x)),
          f"{label}: the row-major kernel != plain")
    out["before_us"] = before_after.device_us(
        lambda: before_after.rowmajor_matvec(old, A.vals, A.cols, x),
        before_after.OLD_KERNEL)
    out["plain_ms"] = per_call_ms(
        lambda: ell_spmv.sell_matvec_plain(L, x), 5)
    out["plain_ell_ms"] = per_call_ms(
        lambda: ell_spmv.ell_matvec_plain(A.vals, A.cols, x), 5)
    out["bound"] = nnz_bound(L.nnz, n, A.shape[1], s)
    out["bound_padded"] = ell_bound(n, K, A.shape[1], s)
    rid = torch.arange(n, device=x.device)[:, None].expand(n, K)
    with warnings.catch_warnings():  # "beta state" notices of torch.sparse
        warnings.simplefilter("ignore")
        csr = torch.sparse_coo_tensor(
            torch.stack([rid.reshape(-1), A.cols.reshape(-1).long()]),
            A.vals.reshape(-1), A.shape).coalesce().to_sparse_csr()
    y_lib = csr @ x
    y_k = A @ x
    lib_rel = float(torch.linalg.vector_norm(y_lib - y_k)
                    / torch.linalg.vector_norm(y_lib))
    check(lib_rel <= (1e-12 if s == 8 else 1e-5),
          f"{label}: cuSPARSE yardstick rel {lib_rel}")
    out["lib_ms"] = per_call_ms(lambda: csr @ x, 100)
    kern, _ = device_kernels(lambda: csr @ x, 20)
    out["lib_dev_us"] = sum(us for _, us in kern.values()) / 20 if kern else None
    ell_spmv.launches, ell_spmv.layouts_built = counts
    return out


def b2_text(b2):
    """One log clause of ``b2_timed``'s numbers."""
    return (f"{b2['dev_us']:.3f} us device per launch "
            f"({b2['ms'] * 1e3:.3f} us per call), the row-major kernel it "
            f"replaced {b2['before_us']:.3f} us device, plain "
            f"sell_matvec_plain {b2['plain_ms'] * 1e3:.3f} us and "
            f"ell_matvec_plain {b2['plain_ell_ms'] * 1e3:.3f} us, bound nnz "
            f"{b2['bound'][0] * 1e3:.3f} us ({b2['bound'][1]}), bound padded "
            f"{b2['bound_padded'][0] * 1e3:.3f} us "
            f"({b2['bound_padded'][1]}), "
            f"cuSPARSE {b2['lib_dev_us']} us device "
            f"({b2['lib_ms'] * 1e3:.3f} us per call); {b2['slices']}")


def b2_record(b2):
    """B2's numbers on one table for the kernel record."""
    return {"table": b2["label"], "n": b2["n"], "K": b2["K"],
            "dtype": b2["dtype"], "max_abs_err": b2["err"], "ms": b2["ms"],
            "device_us": b2["dev_us"], "before_us": b2["before_us"],
            "plain_ms": b2["plain_ms"], "plain_ell_ms": b2["plain_ell_ms"],
            "bound_ms": b2["bound"][0], "bound_by": b2["bound"][1],
            "bound_nnz_ms": b2["bound"][0],
            "bound_padded_ms": b2["bound_padded"][0],
            "slice_fill": b2["fill"], "library_ms": b2["lib_ms"],
            "library_device_us": b2["lib_dev_us"]}


def b2_on_table(label, ell, free, load, device):
    """Kernel B2 against its plain versions on an assembled table, with a
    seeded x and with the free-masked load, and ``b2_timed`` on it."""
    rng = np.random.default_rng(2030)
    xs = torch.as_tensor(rng.standard_normal(ell.shape[1]),
                         dtype=ell.vals.dtype, device=device)
    fm = torch.as_tensor(free, device=device)
    xf = torch.where(fm, load, 0.0).contiguous()
    err, _ = ell_kernel_vs_plain([(f"{label} seeded x", ell.vals, ell.cols,
                                   xs),
                                  (f"{label} masked load", ell.vals,
                                   ell.cols, xf)])
    out = b2_timed(label, ell, xs)
    out["err"] = err
    return out


def card_size(name, build, device, lift=None, minres_pre=None):
    """One workload at its card size, built once through its module's
    ``system()`` (``build()`` returns its tuple): ``Assemble`` (seconds by
    the host clock), ``to_ell`` (host clock), B2 on the table, the device
    solve (``Inverse(free, inverse="cg")``, or ``MinResSolver`` with the
    preconditioner ``minres_pre(a, parts)``) with its ell_spmv launches
    against the solver's products, the true residual and the L2 error.
    ``lift(parts)`` gives the GridFunction holding Dirichlet data, if any.
    Returns the numbers and what phase 17 profiles."""
    from ngsxfem_tpu_torch import CGSolver, GridFunction, MinResSolver
    from ngsxfem_tpu_torch.solvers import ell_spmv, sparse

    out = {"name": name, "nx": BIG_NX[name]}
    t0 = time.perf_counter()
    parts = build()
    a, f, V, free, error = parts[:5]
    sync(device)
    out["system_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    a.Assemble()
    f.Assemble()
    sync(device)
    out["assemble_s"] = time.perf_counter() - t0
    out["ntriplets"] = int(a.mat.vals.shape[0])
    t0 = time.perf_counter()
    ell = a.mat.ell()  # the cached ELL view: to_ell, once
    sync(device)
    out["to_ell_s"] = time.perf_counter() - t0
    lift = None if lift is None else lift(parts)
    rhs = f.vec.data if lift is None else f.vec.data - a.mat * lift.vec.data
    free_np = free.np
    out["nfree"] = int(free_np.sum())
    if device.type == "cuda":
        out["b2"] = b2_on_table(f"{name} nx={out['nx']}", ell, free_np, rhs,
                                device)
    before = ell_spmv.launches
    layouts_before = ell_spmv.layouts_built
    if minres_pre is None:
        solver = a.mat.Inverse(free, inverse="cg")
        kind = "cg"
    else:
        pre = minres_pre(a, parts)
        solver = MinResSolver(a.mat, pre=pre, freedofs=free, maxsteps=50000,
                              tol=1e-12)
        kind = "minres"
    with counted_products(kind) as cnt:
        x, out["solve_ms"] = event_ms(lambda: solver * rhs)
    out["launches"] = ell_spmv.launches - before
    out["layouts"] = ell_spmv.layouts_built - layouts_before
    out["kind"], out["iters"], out["products"] = kind, cnt.iters, cnt.products
    want = int(sparse._on_card(a.mat.vals))  # none on the CPU
    check(out["layouts"] == want, f"{name}: the solve built "
                                  f"{out['layouts']} layouts for its one "
                                  f"table, {want} expected")
    if device.type == "cuda":
        check(out["launches"] == cnt.products == cnt.iters + 1,
              f"{name}: {out['launches']} ell_spmv launches, "
              f"{cnt.products} products, {cnt.iters} iterations")
    fm = torch.as_tensor(free_np, device=device)
    r = torch.where(fm, rhs - a.mat * x, 0.0)
    out["true_rel"] = float(torch.linalg.vector_norm(r)
                            / torch.linalg.vector_norm(torch.where(fm, rhs, 0.0)))
    gfu = GridFunction(V)
    gfu.vec.data = x if lift is None else lift.vec.data + x
    out["err"] = error(gfu)
    out["peak_gib"] = peak_gib(device)
    out["a"], out["f"], out["solver"], out["rhs"] = a, f, solver, rhs
    # the same solver for WINDOW iterations on its tolerance path (a
    # tolerance it cannot reach): what phase 17 profiles
    out["window"] = (MinResSolver(a.mat, pre=solver.pre, freedofs=free,
                                  maxsteps=WINDOW, tol=1e-300)
                     if kind == "minres" else
                     CGSolver(a.mat, freedofs=free, maxsteps=WINDOW,
                              tol=1e-300))
    return out


def skeleton_slice(T, device):
    """Phase 16: the DG, dn-ghost-penalty, cut Stokes, Nitsche-XFEM and
    XFESpace workloads at their reference tests' sizes (card against this
    host's CPU, the tests' thresholds), then each at its card size."""
    from ngsxfem_tpu_torch.examples import (fictdom_dg_ghostpen,
                                            fictdom_dn_ghostpen, nxfem,
                                            stokescutfem, xfespaces)

    out = {}

    def card_vs_cpu(name, fn):
        e_dev, e_cpu = fn(device), fn(torch.device("cpu"))
        for a, b in zip(np.atleast_1d(e_dev), np.atleast_1d(e_cpu)):
            check(abs(a - b) <= 1e-8 * abs(b), f"{name}: card {e_dev} vs CPU "
                                               f"{e_cpu}")
        out[name] = (e_dev, e_cpu)
        return e_dev

    # DG fictitious domain, order 2 (tests/test_workloads.py:74-83)
    e_dg = [card_vs_cpu(f"dg nx={nx}", lambda d, nx=nx: fictdom_dg_ghostpen.run(
        nx=nx, order=2, verbose=False, device=d)) for nx in DG_NX]
    out["dg"] = e_dg
    check(e_dg[1] < DG_MAX and e_dg[1] < e_dg[0] / DG_RATE,
          f"DG L2 errors {e_dg}")
    # dn-jump ghost penalty, order 1 (tests/test_ghostpenalty.py:13-18)
    e_dn = card_vs_cpu(f"dn nx={DN_NX}", lambda d: fictdom_dn_ghostpen.run(
        nx=DN_NX, order=1, verbose=False, device=d))
    check(e_dn < DN_MAX, f"dn ghost penalty L2 error {e_dn}")
    out["dn"] = e_dn
    # Nitsche-XFEM, order 1 (tests/test_workloads.py:199-205)
    e_nx = card_vs_cpu(f"nxfem nx={NXF_NX}", lambda d: nxfem.run(
        nx=NXF_NX, verbose=False, device=d))
    check(e_nx < NXF_MAX, f"nxfem L2 error {e_nx}")
    out["nxfem"] = e_nx
    # the XFESpace demo: every number equal on card and CPU
    nums = [xfespaces.system(device=d) for d in (device, torch.device("cpu"))]
    for k in nums[1]:
        a, b = np.asarray(nums[0][k], float), np.asarray(nums[1][k], float)
        check(np.all(np.abs(a - b) <= 1e-12 * np.maximum(np.abs(b), 1.0)),
              f"xfespaces {k}: card {nums[0][k]} vs CPU {nums[1][k]}")
    out["xfespaces"] = nums[0]

    # the "cg" solve at nx=64 against the host LU (nxfem)
    a, f, VhG, free, _, lift = nxfem.system(nx=NXF_LU_NX, device=device)
    a.Assemble()
    f.Assemble()
    rhs = f.vec.data - a.mat * lift.vec.data
    x_lu = a.mat.Inverse(free, inverse="umfpack") * rhs
    x_cg = a.mat.Inverse(free, inverse="cg") * rhs
    out["nxfem_lu_cg"] = float(torch.linalg.vector_norm(x_cg - x_lu)
                               / torch.linalg.vector_norm(x_lu))
    check(out["nxfem_lu_cg"] <= 1e-8,
          f"nxfem nx={NXF_LU_NX}: 'cg' vs LU rel {out['nxfem_lu_cg']}")

    # cut Stokes, P2/P1 (tests/test_stokes.py:11-21): nx=16 by run(); nx=32
    # built once: the host LU and MINRES on the card, equal to 1e-8
    u16, p16 = card_vs_cpu(f"stokes nx={ST_NX[0]}", lambda d: stokescutfem.run(
        nx=ST_NX[0], verbose=False, device=d))
    check(u16 < ST_MAX[0] and p16 < ST_MAX[1],
          f"Stokes nx={ST_NX[0]} errors {u16}, {p16}")
    out["stokes"] = (u16, p16)
    a, f, X, act, errors, pmass = stokescutfem.system(nx=ST_NX[1],
                                                      device=device)
    a.Assemble()
    f.Assemble()
    pmass.Assemble()
    x_lu = a.mat.Inverse(act, inverse="umfpack") * f.vec
    with counted_products("minres") as cnt:
        x_mr = T.MinResSolver(a.mat, pre=stokescutfem.minres_preconditioner(
            a, pmass, X, act), freedofs=act, maxsteps=50000, tol=1e-12) * f.vec
    errs = []
    for xs in (x_lu, x_mr):
        gf = T.GridFunction(X)
        gf.vec.data = xs
        errs.append(errors(gf))
    (u32, p32), (u32m, p32m) = errs
    vel = X.Range(0)
    dvel = float(torch.linalg.vector_norm(x_mr[vel] - x_lu[vel])
                 / torch.linalg.vector_norm(x_lu[vel]))
    check(u32 < u16 / ST_RATE[0] and p32 < p16 / ST_RATE[1],
          f"Stokes convergence {(u16, p16)} -> {(u32, p32)}")
    check(dvel <= 1e-8 and abs(u32m - u32) <= 1e-8 * u32
          and abs(p32m - p32) <= 1e-8 * p32,
          f"Stokes nx=32 MINRES vs LU: velocity rel {dvel}, errors "
          f"{(u32m, p32m)} vs {(u32, p32)}")
    out["stokes32"] = (u32, p32, dvel, abs(u32m - u32) / u32,
                       abs(p32m - p32) / p32, cnt.iters)

    def stokes_pre(a, parts):
        _, _, X, act, _, pmass = parts
        pmass.Assemble()
        return stokescutfem.minres_preconditioner(a, pmass, X, act)

    # the card sizes, each built once through system()
    bigs = [
        card_size("fictdom_dg_ghostpen", lambda: fictdom_dg_ghostpen.system(
            nx=BIG_NX["fictdom_dg_ghostpen"], order=2, device=device), device),
        card_size("fictdom_dn_ghostpen", lambda: fictdom_dn_ghostpen.system(
            nx=BIG_NX["fictdom_dn_ghostpen"], order=1, device=device), device),
        card_size("stokescutfem", lambda: stokescutfem.system(
            nx=BIG_NX["stokescutfem"], device=device), device,
            minres_pre=stokes_pre),
        card_size("nxfem", lambda: nxfem.system(nx=BIG_NX["nxfem"],
                                                device=device), device,
                  lift=lambda parts: parts[5]),
    ]
    dg, dn, st, nxf = bigs
    check(dg["err"] < e_dg[1], f"DG nx={dg['nx']} L2 {dg['err']} >= "
                               f"nx={DG_NX[1]} {e_dg[1]}")
    check(dn["err"] < e_dn, f"dn nx={dn['nx']} L2 {dn['err']} >= "
                            f"nx={DN_NX} {e_dn}")
    check(st["err"][0] < u32 and st["err"][1] < p32,
          f"Stokes nx={st['nx']} errors {st['err']} vs nx={ST_NX[1]} "
          f"{(u32, p32)}")
    check(nxf["err"] < e_nx, f"nxfem nx={nxf['nx']} L2 {nxf['err']} >= "
                             f"nx={NXF_NX} {e_nx}")
    for b in bigs:
        check(b["true_rel"] <= 1e-8, f"{b['name']} nx={b['nx']}: true "
                                     f"relative residual {b['true_rel']}")
    out["bigs"] = bigs
    return out


def peak_gib(device):
    """Peak device memory since the last call, in GiB (0 on the CPU)."""
    if device.type != "cuda":
        return 0.0
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    torch.cuda.reset_peak_memory_stats(device)
    return peak


def profiled(fn, reps=5):
    """(median ms by CUDA events over `reps` calls, device kernels, device
    busy ms, idle share, the three kernels with the most device time) of one
    call of `fn`."""
    ms = time_ms(fn, reps)
    kern, wall = device_kernels(fn, 1, warm=False)
    busy = sum(us for _, us in kern.values()) / 1e3
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:3]
    return (ms, sum(c for c, _ in kern.values()), busy, 1 - busy / wall,
            "; ".join(f"{k[:50]} x{c} {us / 1e3:.3f} ms" for k, (c, us) in top))


def phases_16_17(T, dev, t_start):
    """Phases 16 (skeleton, vector and XFEM workloads, launch counters reset
    just before them) and 17 (their card-size calls profiled).  Returns the
    phase-16 numbers and the ell_spmv launches of its path."""
    from ngsxfem_tpu_torch.solvers import dia_cg, ell_spmv

    torch.cuda.synchronize()
    peak_gib(dev)
    dia_cg.launches = 0
    ell_spmv.launches = 0
    t0 = time.perf_counter()
    sk = skeleton_slice(T, dev)
    sk_launches = ell_spmv.launches
    check(sk_launches > 0, "the skeleton/XFEM path launched ell_spmv no time")
    u32, p32, dvel, du, dp, mr32 = sk["stokes32"]
    print(f"[16 reference sizes] card (CPU): fictdom_dg_ghostpen order 2 "
          f"nx={list(DG_NX)} L2 "
          + ", ".join(f"{sk[f'dg nx={nx}'][0]:.10e} ({sk[f'dg nx={nx}'][1]:.10e})"
                      for nx in DG_NX)
          + f"; fictdom_dn_ghostpen nx={DN_NX} L2 {sk[f'dn nx={DN_NX}'][0]:.10e} "
          f"({sk[f'dn nx={DN_NX}'][1]:.10e}); nxfem nx={NXF_NX} L2 "
          f"{sk[f'nxfem nx={NXF_NX}'][0]:.10e} "
          f"({sk[f'nxfem nx={NXF_NX}'][1]:.10e}), nx={NXF_LU_NX} 'cg' vs LU "
          f"rel {sk['nxfem_lu_cg']:.3e}; stokescutfem nx={ST_NX[0]} u/p L2 "
          f"{sk['stokes'][0]:.6e}/{sk['stokes'][1]:.6e}, "
          f"nx={ST_NX[1]} {u32:.6e}/{p32:.6e}, MINRES ({mr32} iterations) vs "
          f"LU: velocity rel {dvel:.3e}, u/p errors rel {du:.3e}/{dp:.3e}; "
          f"xfespaces {sk['xfespaces']}", flush=True)
    for b in sk["bigs"]:
        b2 = b["b2"]
        print(f"[16 card size] {b['name']} nx={b['nx']}: {b['nfree']} free "
              f"dofs, {b['ntriplets']} COO triplets, ELL {b2['n']} x "
              f"{b2['K']} {b2['dtype']}; system() {b['system_s']:.2f} s, "
              f"Assemble (a and f) {b['assemble_s']:.2f} s, to_ell "
              f"{b['to_ell_s']:.2f} s ({ran_on(dev)}); {b['kind']} solve "
              f"{b['iters']} iterations = {b['products']} products = "
              f"{b['launches']} ell_spmv launches, {b['layouts']} layout "
              f"built, {b['solve_ms']:.1f} ms, true rel res "
              f"{b['true_rel']:.3e}; L2 error {b['err']}; B2 on this table "
              f"== plain bitwise (seeded x, masked load, max|dy| "
              f"{b2['err']:.3e}), {b2_text(b2)}; peak memory "
              f"{b['peak_gib']:.2f} GiB", flush=True)
    print(f"[16 launches] ell_spmv {sk_launches}, dia_cg {dia_cg.launches}; "
          f"wall of phase 16 {time.perf_counter() - t0:.2f} s", flush=True)

    # 17. the card-size calls of phase 16 on the card: one call each by CUDA
    # events, one under torch.profiler; the solves over a window of WINDOW
    # iterations of the same solver
    t0 = time.perf_counter()
    for b in sk["bigs"]:
        tag = f"{b['name']} nx={b['nx']}"
        for what, fn in (("BilinearForm.Assemble", b["a"].Assemble),
                         ("LinearForm.Assemble", b["f"].Assemble)):
            _, ms = event_ms(fn)
            kern, wall = device_kernels(fn, 1, warm=False)
            busy = sum(us for _, us in kern.values()) / 1e3
            print(f"[17 times] {card()} | {what} {tag}: {ms:.3f} ms, "
                  f"{sum(c for c, _ in kern.values())} device kernels, device "
                  f"busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}, host "
                  f"(not device-busy) {(ms - busy) / 1e3:.3f} s", flush=True)
        window, rhs = b["window"], b["rhs"]
        _, wms = event_ms(lambda: window * rhs)
        kern, wall = device_kernels(lambda: window * rhs, 1, warm=False)
        busy = sum(us for _, us in kern.values()) / 1e3
        nk = sum(c for c, _ in kern.values())
        print(f"[17 times] {card()} | {b['kind']} solve {tag}: "
              f"{b['solve_ms']:.3f} ms for {b['iters']} iterations (phase 16); "
              f"a {WINDOW}-iteration window {wms:.3f} ms, {nk} device kernels "
              f"({nk / WINDOW:.1f} per iteration), device busy {busy:.3f} ms, "
              f"idle share {1 - busy / wall:.3f}; to_ell {b['to_ell_s']:.3f} s "
              f"({ran_on(dev)}); peak memory {b['peak_gib']:.2f} GiB", flush=True)
    print(f"[17 times] peak memory {peak_gib(dev):.2f} GiB | wall of phase 17 "
          f"{time.perf_counter() - t0:.2f} s, of the whole run "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)

    return sk, sk_launches


# --- phases 18-19: isoparametric level-set mesh adaptation ---------------

# phase 18: the JAX package's test sizes; the max-distance EOC of
# tests/test_lsetcurv.py:15-31, fictdom3d(isoparametric=True) order 2 with
# the limits of tests/test_workloads.py:239-250, tracefem3d with those of
# tests/test_tracefem.py:11-19, nxfem_higher_order with
# tests/test_workloads.py:208-214's
ISO_EOC_NX = (8, 16, 32)
ISO_FD_NX, ISO_FD_MAX, ISO_FD_RATE = (8, 16), 1.5e-3, 6.0
ISO_HO_NX = 16  # bench.py's high_order configuration (BENCH_HO_NX)
TRACE_NX, TRACE_MAX, TRACE_RATE = (6, 12), 0.06, 6.0
NXHO_NX, NXHO_MAX = 15, 1e-3
# phase 19: the high_order workload at card size, (order, nx); the trace-FEM
# band system at card size
ISO_BIG = ((2, 48), (3, 24))
TRACE_BIG_NX = 32
ISO_TRUE_TOL = 1e-10  # true relative residual of the default Inverse() solves


def ell_asym(ell):
    """max |A - A^T| / max |A| of an ``ELLMatrix``, on its device."""
    n = ell.shape[0]
    cols = ell.cols.long()
    rows = torch.arange(n, device=cols.device)[:, None].expand_as(cols)
    nz = ell.vals != 0
    r, c, v = rows[nz], cols[nz], ell.vals[nz]
    key, order = torch.sort(r * n + c)
    tkey = c * n + r
    pos = torch.searchsorted(key, tkey).clamp(max=key.numel() - 1)
    vt = torch.where(key[pos] == tkey, v[order[pos]], 0.0)
    return float((v - vt).abs().max() / v.abs().max())


def no_shift_warning(fn):
    """fn(), failing if the isoparametric shift Newton warned."""
    from ngsxfem_tpu_torch.utils.diagnostics import (
        NewtonNonConvergenceWarning)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    bad = [str(w.message) for w in caught
           if issubclass(w.category, NewtonNonConvergenceWarning)]
    check(not bad, f"the shift Newton did not converge: {bad}")
    return out


def iso_solve(label, parts, device, detail=True, keep=False):
    """One assembled isoparametric system, built once through an example's
    ``system()`` (``parts``; the mesh holds the deformation): ``Assemble``
    by CUDA events and under ``torch.profiler``, ``to_ell`` (host clock), the
    symmetry of ``a.mat``, B2 on its table (with ``detail``), the default
    ``Inverse()`` solve on the card (path ``device_cg``, ell_spmv launches
    == products == iterations + 1, the true residual) and the L2 error.
    With ``keep`` the result holds the system (``"system"``) and its
    deformation (``"deformation"``) for phase 23."""
    from ngsxfem_tpu_torch import GridFunction
    from ngsxfem_tpu_torch.solvers import ell_spmv

    a, f, V, free, l2error = parts
    out = {"label": label}
    on_card = device.type == "cuda"  # the CPU rehearsal of the tests: no
    detail = detail and on_card      # profiler, no kernel, no launches
    try:
        _, out["asm_a_ms"] = event_ms(a.Assemble)
        _, out["asm_f_ms"] = event_ms(f.Assemble)
        if detail:
            for key, fn in (("prof_a", a.Assemble), ("prof_f", f.Assemble)):
                kern, wall = device_kernels(fn, 1, warm=False)
                busy = sum(us for _, us in kern.values()) / 1e3
                top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:4]
                out[key] = (sum(c for c, _ in kern.values()), busy,
                            1 - busy / wall, wall, "; ".join(
                                f"{k[:48]} x{c} {us / 1e3:.2f} ms"
                                for k, (c, us) in top))
        out["ntriplets"] = int(a.mat.vals.shape[0])
        t0 = time.perf_counter()
        ell = a.mat.ell()  # the cached ELL view: to_ell, once
        sync(device)
        out["to_ell_s"] = time.perf_counter() - t0
        out["n"], out["K"] = (int(s) for s in ell.vals.shape)
        out["nnz"] = int((ell.vals != 0).sum())
        out["asym"] = ell_asym(ell)
        check(out["asym"] <= 1e-12, f"{label}: a.mat symmetry {out['asym']}")
        out["nfree"] = int(free.np.sum())
        if detail:
            out["b2"] = b2_on_table(label, ell, free.np, f.vec.data, device)
        rhs = f.vec.data
        inv = a.mat.Inverse(free)
        out["path"] = inv.path
        check(inv.path == "device_cg", f"{label}: default Inverse() took "
                                       f"{inv.path}, not device_cg")
        before = ell_spmv.launches
        with counted_products("cg") as cnt:
            x, out["solve_ms"] = event_ms(lambda: inv * rhs)
        out["launches"] = ell_spmv.launches - before
        out["iters"], out["products"] = cnt.iters, cnt.products
        check(out["launches"] == (cnt.products if on_card else 0)
              and cnt.products == cnt.iters + 1,
              f"{label}: {out['launches']} ell_spmv launches, "
              f"{cnt.products} products, {cnt.iters} iterations")
        fm = torch.as_tensor(free.np, device=device)
        r = torch.where(fm, rhs - a.mat * x, 0.0)
        out["true_rel"] = float(torch.linalg.vector_norm(r)
                                / torch.linalg.vector_norm(
                                    torch.where(fm, rhs, 0.0)))
        check(out["true_rel"] <= ISO_TRUE_TOL,
              f"{label}: true relative residual {out['true_rel']}")
        gfu = GridFunction(V)
        gfu.vec.data = x
        out["err"] = l2error(gfu)
        check(np.isfinite(out["err"]), f"{label}: L2 error {out['err']}")
        if keep:
            out["system"], out["deformation"] = parts, V.mesh.deformation
    finally:
        V.mesh.UnsetDeformation()
    out["peak_gib"] = peak_gib(device)
    return out


def iso_card(T, order, nx, device, detail=True, keep=False):
    """The high_order workload (``examples.fictdom3d`` with
    ``isoparametric=True``: sphere r=0.7 on [-1,1]^3, threshold 0.2,
    lambda = 10 k^2, gamma 0.1, f64) at (order, nx): ``CalcDeformation`` and
    ``CalcMaxDistance`` timed by CUDA events on their own, then the system
    through ``fictdom3d.system`` and ``iso_solve``."""
    from ngsxfem_tpu_torch.examples import fictdom3d

    t0 = time.perf_counter()
    peak_gib(device)
    mesh = T.MakeStructured3DMesh(
        hexes=False, nx=nx, ny=nx, nz=nx,
        mapping=lambda a, b, c: (2 * a - 1, 2 * b - 1, 2 * c - 1))
    levelset = T.sqrt(T.x * T.x + T.y * T.y + T.z * T.z) - 0.7
    lsa = T.LevelSetMeshAdaptation(mesh, order=order, threshold=0.2,
                                   device=device)
    lsa.CalcDeformation(levelset)  # warm-up
    _, deform_ms = no_shift_warning(
        lambda: event_ms(lambda: lsa.CalcDeformation(levelset)))
    maxdist, maxdist_ms = event_ms(lambda: lsa.CalcMaxDistance(levelset))
    del lsa, mesh
    t1 = time.perf_counter()
    parts = no_shift_warning(lambda: fictdom3d.system(
        nx=nx, order=order, device=device, isoparametric=True))
    sync(device)
    system_s = time.perf_counter() - t1
    out = iso_solve(f"fictdom3d P{order} iso nx={nx}", parts, device, detail,
                    keep)
    out.update(order=order, nx=nx, deform_ms=deform_ms, maxdist=maxdist,
               maxdist_ms=maxdist_ms, system_s=system_s,
               ne=6 * nx ** 3, wall_s=time.perf_counter() - t0)
    if detail and order == 3:
        out["small_matmul"] = small_matmul_probe(T, parts, device)
    return out


def small_matmul_probe(T, parts, device):
    """The contraction of the order-3 facet-patch element matrices (the
    u*v term: (F, 20, Q) @ (F, Q, 20) over the Q points of both
    neighbours' order-6 rule) by ``mesh.small_matmul`` (Q unrolled
    multiply-adds) and by ``torch.matmul`` (a library batched GEMM), ms by
    CUDA events, and their largest relative difference."""
    from ngsxfem_tpu_torch.mesh.mesh import small_matmul
    from ngsxfem_tpu_torch.ops.gauss import reference_rule

    F = int(parts[0].integrals[-1].definedonelements.sum())
    Q = 2 * len(reference_rule("tet", 6)[1])
    g = torch.Generator(device=device).manual_seed(2030)
    a = torch.randn(F, 20, Q, generator=g, device=device, dtype=torch.float64)
    b = torch.randn(F, Q, 20, generator=g, device=device, dtype=torch.float64)
    ref = torch.matmul(a, b)
    diff = float((small_matmul(a, b) - ref).abs().max() / ref.abs().max())
    return {"F": F, "Q": Q, "diff": diff,
            "small_ms": time_ms(lambda: small_matmul(a, b)),
            "matmul_ms": time_ms(lambda: torch.matmul(a, b))}


def iso_parity(T, device):
    """Phase 18: the isoparametric path at the JAX package's test sizes,
    card against this host's CPU (1e-8) with the tests' limits, and order 3
    at bench.py's high_order size on the card."""
    from ngsxfem_tpu_torch.examples import (fictdom3d, nxfem_higher_order,
                                            tracefem3d)

    out = {}
    cpu = torch.device("cpu")

    def card_vs_cpu(name, fn):
        e_dev, e_cpu = no_shift_warning(lambda: fn(device)), fn(cpu)
        for a, b in zip(np.atleast_1d(e_dev), np.atleast_1d(e_cpu)):
            check(abs(a - b) <= 1e-8 * abs(b), f"{name}: card {e_dev} vs CPU "
                                               f"{e_cpu}")
        out[name] = (e_dev, e_cpu)
        return e_dev

    def maxdists(order, dev):
        res = []
        for nx in ISO_EOC_NX:
            mesh = T.MakeStructured2DMesh(
                quads=False, nx=nx, ny=nx,
                mapping=lambda a, b: (2 * a - 1, 2 * b - 1))
            lset = T.sqrt(T.x * T.x + T.y * T.y) - 2.0 / 3.0
            lsa = T.LevelSetMeshAdaptation(mesh, order=order, threshold=10.0,
                                           device=dev)
            lsa.CalcDeformation(lset)
            res.append(lsa.CalcMaxDistance(lset))
        return res

    for order in (2, 3):
        d = card_vs_cpu(f"maxdist P{order}", lambda dev, o=order: maxdists(
            o, dev))
        eocs = [float(np.log2(d[i] / d[i + 1])) for i in range(len(d) - 1)]
        check(sum(eocs) / len(eocs) > order,
              f"max distance P{order} {d}: EOC {eocs}")
        out[f"eoc P{order}"] = eocs
    e_fd = [card_vs_cpu(f"fictdom3d P2 iso nx={nx}", lambda dev, nx=nx:
                        fictdom3d.run(nx=nx, order=2, isoparametric=True,
                                      verbose=False, device=dev))
            for nx in ISO_FD_NX]
    check(e_fd[0] < ISO_FD_MAX and e_fd[0] / e_fd[1] > ISO_FD_RATE,
          f"fictdom3d P2 iso L2 errors {e_fd}")
    out["fictdom3d"] = e_fd
    # bench.py's high_order configuration: order 3 at nx=16, on the card
    out["ho16"] = iso_card(T, 3, ISO_HO_NX, device, detail=False)
    check(out["ho16"]["err"] < e_fd[1],
          f"fictdom3d P3 iso nx={ISO_HO_NX} L2 {out['ho16']['err']} >= P2's "
          f"{e_fd[1]}")
    e_tr = [card_vs_cpu(f"tracefem3d nx={nx}", lambda dev, nx=nx:
                        tracefem3d.run(nx=nx, order=2, verbose=False,
                                       device=dev))
            for nx in TRACE_NX]
    check(e_tr[0] < TRACE_MAX and e_tr[1] < e_tr[0] / TRACE_RATE,
          f"tracefem3d L2 errors {e_tr}")
    out["tracefem3d"] = e_tr
    e_nx = card_vs_cpu(f"nxfem_higher_order nx={NXHO_NX}", lambda dev:
                       nxfem_higher_order.run(nx=NXHO_NX, order=3,
                                              verbose=False, device=dev))
    check(e_nx < NXHO_MAX, f"nxfem_higher_order L2 error {e_nx}")
    out["nxfem_ho"] = e_nx
    return out


def phases_18_19(T, dev, t_start):
    """Phases 18 (the isoparametric path at the JAX package's test sizes)
    and 19 (the high_order workload and the trace-FEM band at card size),
    launch counters reset just before them.  Returns the phase-19 systems
    and the ell_spmv launches of the path."""
    from ngsxfem_tpu_torch.examples import tracefem3d
    from ngsxfem_tpu_torch.solvers import dia_cg, ell_spmv

    torch.cuda.synchronize()
    peak_gib(dev)
    dia_cg.launches = 0
    ell_spmv.launches = 0
    t0 = time.perf_counter()
    par = iso_parity(T, dev)
    ho = par["ho16"]
    print(f"[18 parity] card (CPU): max distance P2 "
          f"{par['maxdist P2'][0]} ({par['maxdist P2'][1]}), EOC "
          f"{par['eoc P2']}; P3 {par['maxdist P3'][0]} "
          f"({par['maxdist P3'][1]}), EOC {par['eoc P3']}; fictdom3d P2 iso "
          f"nx={list(ISO_FD_NX)} L2 "
          + ", ".join(f"{par[f'fictdom3d P2 iso nx={nx}'][0]:.10e} "
                      f"({par[f'fictdom3d P2 iso nx={nx}'][1]:.10e})"
                      for nx in ISO_FD_NX)
          + f" (ratio {par['fictdom3d'][0] / par['fictdom3d'][1]:.2f}); "
          f"tracefem3d nx={list(TRACE_NX)} L2 "
          + ", ".join(f"{par[f'tracefem3d nx={nx}'][0]:.10e} "
                      f"({par[f'tracefem3d nx={nx}'][1]:.10e})"
                      for nx in TRACE_NX)
          + f"; nxfem_higher_order nx={NXHO_NX} L2 "
          f"{par[f'nxfem_higher_order nx={NXHO_NX}'][0]:.10e} "
          f"({par[f'nxfem_higher_order nx={NXHO_NX}'][1]:.10e}); fictdom3d "
          f"P3 iso nx={ISO_HO_NX} (bench.py high_order) on the card: L2 "
          f"{ho['err']:.10e}, {ho['nfree']} free dofs, ELL {ho['n']} x "
          f"{ho['K']}, default Inverse() {ho['path']} {ho['iters']} "
          f"iterations in {ho['solve_ms']:.1f} ms; wall of phase 18 "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 19. card size
    t0 = time.perf_counter()
    bigs = []
    for order, nx in ISO_BIG:
        b = iso_card(T, order, nx, dev, keep=True)  # reused by phase 23
        bigs.append(b)
        pa, pf = b["prof_a"], b["prof_f"]
        print(f"[19 card size] {card()} | fictdom3d P{order} iso nx={nx} "
              f"({b['ne']} tets, f64): CalcDeformation {b['deform_ms']:.3f} "
              f"ms, CalcMaxDistance {b['maxdist_ms']:.3f} ms (max distance "
              f"{b['maxdist']:.3e}); system() {b['system_s']:.2f} s; "
              f"BilinearForm.Assemble {b['asm_a_ms']:.1f} ms ({pa[0]} device "
              f"kernels, busy {pa[1]:.1f} ms, idle share {pa[2]:.3f}; top: "
              f"{pa[4]}), LinearForm.Assemble {b['asm_f_ms']:.1f} ms "
              f"({pf[0]} kernels, busy {pf[1]:.1f} ms, idle {pf[2]:.3f}); "
              f"{b['ntriplets']} COO triplets, to_ell {b['to_ell_s']:.2f} s "
              f"({ran_on(dev)}), ELL {b['n']} x {b['K']} ({b['nnz']} "
              f"nonzeros), a.mat "
              f"asymmetry {b['asym']:.2e}; default Inverse() {b['path']}: "
              f"{b['iters']} iterations = {b['products']} products = "
              f"{b['launches']} ell_spmv launches, {b['solve_ms']:.1f} ms, "
              f"true rel res {b['true_rel']:.3e}; L2 error {b['err']:.10e}; "
              f"peak memory {b['peak_gib']:.2f} GiB; wall {b['wall_s']:.2f} s",
              flush=True)
        b2 = b["b2"]
        print(f"[19 B2] {card()} | {b2['label']}: == plain bitwise (seeded "
              f"x, masked load, max|dy| {b2['err']:.3e}), slice fill "
              f"{b2['fill']:.3f}, {b2_text(b2)}", flush=True)
        if "small_matmul" in b:
            sm = b["small_matmul"]
            print(f"[19 small_matmul] {card()} | order-3 facet-patch "
                  f"contraction ({sm['F']} patches, {sm['Q']} points, 20 x "
                  f"20): small_matmul {sm['small_ms']:.3f} ms, torch.matmul "
                  f"{sm['matmul_ms']:.3f} ms, rel diff {sm['diff']:.2e}",
                  flush=True)
    trace = iso_solve(f"tracefem3d P2 nx={TRACE_BIG_NX}", no_shift_warning(
        lambda: tracefem3d.system(nx=TRACE_BIG_NX, order=2, device=dev)), dev)
    check(trace["err"] < par["tracefem3d"][1],
          f"tracefem3d nx={TRACE_BIG_NX} L2 {trace['err']} >= nx="
          f"{TRACE_NX[1]}'s {par['tracefem3d'][1]}")
    bigs.append(trace)
    pa = trace["prof_a"]
    print(f"[19 card size] {card()} | tracefem3d P2 nx={TRACE_BIG_NX}: "
          f"{trace['nfree']} free dofs, BilinearForm.Assemble "
          f"{trace['asm_a_ms']:.1f} ms ({pa[0]} kernels, idle {pa[2]:.3f}), "
          f"to_ell {trace['to_ell_s']:.2f} s, ELL {trace['n']} x "
          f"{trace['K']}; default Inverse() {trace['path']} {trace['iters']} "
          f"iterations, {trace['launches']} launches, {trace['solve_ms']:.1f} "
          f"ms, true rel res {trace['true_rel']:.3e}; L2 {trace['err']:.10e}"
          f"; B2 == plain bitwise, slice fill {trace['b2']['fill']:.3f}, "
          f"{b2_text(trace['b2'])}", flush=True)
    check(bigs[0]["err"] < par["fictdom3d"][1] and bigs[1]["err"] < ho["err"],
          f"card-size L2 errors {bigs[0]['err']} (P2), {bigs[1]['err']} (P3) "
          f"not below nx={ISO_FD_NX[1]}'s {par['fictdom3d'][1]} (P2) and "
          f"nx={ISO_HO_NX}'s {ho['err']} (P3)")
    launches = ell_spmv.launches
    check(launches > 0, "the isoparametric path launched ell_spmv no time")
    print(f"[19 launches] ell_spmv {launches}, dia_cg {dia_cg.launches}; "
          f"wall of phase 19 {time.perf_counter() - t0:.2f} s, of the whole "
          f"run {time.perf_counter() - t_start:.2f} s", flush=True)
    return bigs, launches


# --- phases 20-21: space-time unfitted FEM ---------------------------------

# phase 20: the JAX package's test sizes, (nx, nslab) each doubled once:
# moving_domain (tests/test_spacetime.py:65-70), heateq_cg_spacetime at
# tend 0.25 (:122-131), moving_domain3d (tests/test_workloads.py:228-235),
# and moving_domain(deform=True) at order 2 (tests/test_torch_spacetime.py)
ST_MD = ((12, 4), (24, 8))
ST_HEAT = ((12, 8), (24, 16))
ST_3D = ((6, 2), (12, 4))
ST_DEF = ((8, 2), (16, 4))
ST_HEAT_TEND = 0.25
ST_DEF_ORDER = 2
# phase 21: card size, each pair a doubling of (nx, nslab); 3D doubles the
# last of ST_3D
ST_MD_BIG = ((128, 8), (256, 16))
ST_HEAT_BIG = ((64, 16), (128, 32))
ST_3D_BIG = ((24, 8),)
ST_DEF_BIG = ((32, 8), (64, 16))
ST_RULE_NX = 12        # tets of the Integrate / CutInfo parity
ST_PARITY_TOL = 1e-8   # card vs CPU, L2 errors (relative)
ST_RULE_TOL = 1e-12    # card vs CPU, Integrate and CutInfo ratios


class SlabClock:
    """While active, the per-call times of a slab loop's steps:
    ``CutInfo.Update``, ``BilinearForm.Assemble`` and
    ``LinearForm.Assemble`` by CUDA events (by the host clock without a
    card); by the host clock ``a.mat.Inverse(free)`` (on the card it builds
    the ELL view, ``to_ell``, to test for an SPD free block), the host LU's
    ``SparseMatrix.to_scipy``, ``splu``, whole ``InverseMatrix.solve`` and
    the solve without its ``to_scipy`` (``lu``); the path and free rows of
    every solve,
    and each rectangular form's (shape, (test ndof, trial ndof)).  With
    ``profile_call`` = k, the k-th ``BilinearForm.Assemble`` is run once
    more under ``torch.profiler`` (device kernels, busy ms, wall ms)."""

    def __init__(self, profile_call=None):
        from ngsxfem_tpu_torch.forms import assemble
        from ngsxfem_tpu_torch.geom import cutinfo
        from ngsxfem_tpu_torch.solvers import sparse
        import scipy.sparse.linalg as spla

        self.targets = [
            (cutinfo.CutInfo, "Update", "cutinfo", True),
            (assemble.BilinearForm, "Assemble", "bfi", True),
            (assemble.LinearForm, "Assemble", "lfi", True),
            (sparse.InverseMatrix, "__init__", "inverse_init", False),
            (sparse.SparseMatrix, "to_ell", "to_ell", False),
            (sparse.SparseMatrix, "to_scipy", "to_scipy", False),
            (spla, "splu", "splu", False),
            (sparse.InverseMatrix, "solve", "solve", False),
        ]
        self.times = {key: [] for _, _, key, _ in self.targets}
        self.times["lu"] = []
        self.paths, self.nfree, self.rect = [], [], []
        self.profile_call, self.profile = profile_call, None
        self.saved = []

    def _wrap(self, orig, key, events):
        clock = self

        def run(*args, **kw):
            if key == "solve":
                clock.paths.append(args[0].path)
                clock.nfree.append(int(np.count_nonzero(args[0].free)))
                scipy_calls = len(clock.times["to_scipy"])
            if events:
                out, ms = event_ms(lambda: orig(*args, **kw))
            else:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = orig(*args, **kw)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            clock.times[key].append(ms)
            if key == "solve":
                clock.times["lu"].append(
                    ms - sum(clock.times["to_scipy"][scipy_calls:]))
            if key == "bfi":
                form = args[0]
                if form.space_u is not form.space_v:
                    clock.rect.append((tuple(form.mat.shape),
                                       (form.space_v.ndof, form.space_u.ndof)))
                if (clock.profile_call == len(clock.times["bfi"])
                        and torch.cuda.is_available()):
                    kern, wall = device_kernels(lambda: orig(*args, **kw), 1,
                                                warm=False)
                    busy = sum(us for _, us in kern.values()) / 1e3
                    clock.profile = (sum(c for c, _ in kern.values()), busy,
                                     wall)
            return out

        return run

    def __enter__(self):
        for obj, name, key, events in self.targets:
            orig = getattr(obj, name)
            self.saved.append((obj, name, orig))
            setattr(obj, name, self._wrap(orig, key, events))
        return self

    def __exit__(self, *exc):
        for obj, name, orig in self.saved:
            setattr(obj, name, orig)

    def split(self):
        """{step: (median ms per call, total ms, calls)}; ``lu`` is each
        solve without its ``to_scipy`` (factorization + triangular solves,
        on either LU)."""
        return {k: (statistics.median(v) if v else 0.0, sum(v), len(v))
                for k, v in self.times.items()}


def st_rule_parity(T, device):
    """One space-time ``Integrate`` (NEG/POS/IF, kt = 2, a moving sphere on
    tets nx=ST_RULE_NX) and one ``CutInfo.Update(time_order=2)``, on
    ``device`` and on the CPU: values equal to ST_RULE_TOL."""
    out = {}
    n = ST_RULE_NX
    for dev in (device, torch.device("cpu")):
        mesh = T.MakeStructured3DMesh(hexes=False, nx=n, ny=n, nz=n)
        st = T.SpaceTimeFESpace(T.H1(mesh, order=1, device=dev),
                                T.ScalarTimeFE(2))
        lset = T.GridFunction(st)
        T.SpaceTimeInterpolateToP1(
            T.sqrt((T.x - 0.35 - 0.3 * T.tref * T.tref) ** 2
                   + (T.y - 0.5) ** 2 + (T.z - 0.5) ** 2) - 0.3, T.tref, lset)
        f = 1 + T.sin(T.x * T.tref) + T.exp(T.y) * T.tref ** 3
        vals = [T.Integrate({"levelset": lset, "domain_type": dom}, f, mesh,
                            order=3, time_order=4)
                for dom in (T.NEG, T.POS, T.IF)]
        ci = T.CutInfo(mesh)
        ci.Update(lset, time_order=2)
        out[dev.type] = (vals, ci.dt_of_elem, ci.GetCutRatios(),
                         lset.vec.data.device.type)
    card_, host = out[device.type], out["cpu"]
    check(card_[3] == device.type, "the space-time level set left the card")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_[0], host[0]))
    check(rel <= ST_RULE_TOL, f"space-time Integrate card vs CPU rel {rel}")
    check(np.array_equal(card_[1], host[1]), "space-time CutInfo: dt_of_elem "
                                             "differs between card and CPU")
    dr = float(np.abs(card_[2] - host[2]).max())
    check(dr <= ST_RULE_TOL, f"space-time CutInfo ratios card vs CPU {dr}")
    nif = int((card_[1] == 2).sum())
    check(0 < nif < len(card_[1]), f"space-time CutInfo: {nif} IF elements")
    return card_[0], rel, dr, nif


def st_runs(T, device):
    """The space-time examples' runners: name -> fn(nx, nslab, dev)
    returning the final L2 error (heateq: the list of per-slab errors)."""
    from ngsxfem_tpu_torch.examples import (heateq_cg_spacetime,
                                            moving_domain, moving_domain3d)

    return {
        "moving_domain": lambda nx, ns, dev: moving_domain.run(
            nx=nx, nslab=ns, verbose=False, device=dev),
        "heateq_cg_spacetime": lambda nx, ns, dev: heateq_cg_spacetime.run(
            nx=nx, nslab=ns, tend=ST_HEAT_TEND, verbose=False, device=dev),
        "moving_domain3d": lambda nx, ns, dev: moving_domain3d.run(
            nx=nx, nslab=ns, verbose=False, device=dev),
        f"moving_domain(deform=True, order={ST_DEF_ORDER})":
            lambda nx, ns, dev: moving_domain.run(
                nx=nx, nslab=ns, order=ST_DEF_ORDER, deform=True,
                verbose=False, device=dev),
    }


def _final(e):
    return e[-1] if isinstance(e, list) else e


def st_parity(T, device):
    """Phase 20: the three examples (and the deformed moving domain) at the
    JAX tests' sizes on ``device`` and on the CPU: L2 errors equal to
    ST_PARITY_TOL, and the tests' rule (the final error halves when nx and
    nslab double)."""
    runs = st_runs(T, device)
    sizes = dict(zip(runs, (ST_MD, ST_HEAT, ST_3D, ST_DEF)))
    out = {}
    for name, fn in runs.items():
        if not sizes[name]:
            continue
        errs = []
        for nx, ns in sizes[name]:
            e_dev = no_shift_warning(lambda: fn(nx, ns, device))
            e_cpu = fn(nx, ns, torch.device("cpu"))
            for a, b in zip(np.atleast_1d(e_dev), np.atleast_1d(e_cpu)):
                check(abs(a - b) <= ST_PARITY_TOL * abs(b),
                      f"{name} nx={nx} nslab={ns}: card {a} vs CPU {b}")
            errs.append((nx, ns, _final(e_dev), _final(e_cpu)))
        check(errs[1][2] < errs[0][2] / 2,
              f"{name}: L2 errors {errs} do not halve")
        out[name] = errs
    return out


def st_card(T, device, par):
    """Phase 21: each example at card size (ST_*_BIG), its final L2 error
    below the phase-20 ones and halving over each doubling (moving_domain,
    its deformed variant, moving_domain3d); heateq_cg_spacetime's error is
    reported with its card-vs-CPU parity at the smaller size (the
    scheme's error does not halve beyond (24, 16), on the card as in the
    JAX package).  The largest moving_domain run is clocked per slab
    (``SlabClock``, its second slab's ``BilinearForm.Assemble`` profiled)."""
    runs = st_runs(T, device)
    out = {}
    for name, sizes in zip(runs, (ST_MD_BIG, ST_HEAT_BIG, ST_3D_BIG,
                                  ST_DEF_BIG)):
        if not sizes:
            continue
        fn = runs[name]
        rows = []
        for nx, ns in sizes:
            peak_gib(device)
            clock = SlabClock(profile_call=2)
            t0 = time.perf_counter()
            with clock:
                e = no_shift_warning(lambda: fn(nx, ns, device))
            sync(device)
            row = {"nx": nx, "nslab": ns, "err": _final(e),
                   "wall_s": time.perf_counter() - t0,
                   "peak_gib": peak_gib(device), "clock": clock}
            check(np.isfinite(row["err"]), f"{name} nx={nx}: L2 {row['err']}")
            # every slab's free block fits the card's dense LU at these
            # sizes (2 nf^2 x 8 B at most ~12 GB against a budget of ~21 GB)
            lu = "device_lu" if device.type == "cuda" else "host_lu"
            check(set(clock.paths) == {lu},
                  f"{name} nx={nx}: slab solves took {set(clock.paths)}, "
                  f"not {lu}; free rows {min(clock.nfree, default=0)}-"
                  f"{max(clock.nfree, default=0)}")
            for shape, want in clock.rect:
                check(shape == want, f"{name}: a.mat.shape {shape} != "
                                     f"(W_t.ndof, W_i.ndof) {want}")
            rows.append(row)
        small = par[name][-1][2]
        if name == "heateq_cg_spacetime":
            nx, ns = sizes[0]
            e_cpu = fn(nx, ns, torch.device("cpu"))[-1]
            check(abs(rows[0]["err"] - e_cpu) <= ST_PARITY_TOL * abs(e_cpu),
                  f"{name} nx={nx}: card {rows[0]['err']} vs CPU {e_cpu}")
            rows[0]["cpu"] = e_cpu
            check(len(rows[0]["clock"].rect) > 0,
                  "heateq_cg_spacetime assembled no Petrov-Galerkin form")
        else:
            check(rows[0]["err"] < small,
                  f"{name}: card-size L2 {rows[0]['err']} not below the "
                  f"phase-20 one {small}")
            # each doubling of (nx, nslab): 3D's card size doubles the last
            # of ST_3D, the others' second card size doubles their first
            pairs = ([(small, rows[0])] if name == "moving_domain3d" else
                     list(zip((r["err"] for r in rows), rows[1:])))
            for p, r in pairs:
                check(r["err"] < p / 2, f"{name}: L2 {r['err']} does not "
                                        f"halve from {p}")
        out[name] = rows
    return out


def phases_20_21(T, dev, t_start):
    """Phases 20 (the space-time path at the JAX package's test sizes, card
    against CPU) and 21 (card size, per-slab clock, profile, peak memory),
    launch counters reset just before them.  Returns the ell_spmv launches
    of the path."""
    from ngsxfem_tpu_torch.solvers import dia_cg, ell_spmv

    torch.cuda.synchronize()
    peak_gib(dev)
    dia_cg.launches = 0
    ell_spmv.launches = 0
    t0 = time.perf_counter()
    vals, rel, dr, nif = st_rule_parity(T, dev)
    par = st_parity(T, dev)
    print(f"[20 parity] space-time Integrate NEG/POS/IF (tets nx="
          f"{ST_RULE_NX}, kt=2) "
          + ", ".join(f"{v:.15f}" for v in vals)
          + f" card vs CPU rel {rel:.3e}; CutInfo.Update(time_order=2) "
          f"dt_of_elem equal ({nif} IF), ratios max diff {dr:.3e}; "
          + "; ".join(f"{name} (nx, nslab, card L2, CPU L2) "
                      + ", ".join(f"({nx}, {ns}, {a:.10e}, {b:.10e})"
                                  for nx, ns, a, b in errs)
                      for name, errs in par.items())
          + f"; peak memory {peak_gib(dev):.2f} GiB; wall of phase 20 "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    big = st_card(T, dev, par)
    for name, rows in big.items():
        print(f"[21 card] {card()} | {name}: "
              + "; ".join(f"nx={r['nx']} nslab={r['nslab']} L2 "
                          f"{r['err']:.10e}"
                          + (f" (CPU {r['cpu']:.10e})" if "cpu" in r else "")
                          + f", wall {r['wall_s']:.2f} s, peak memory "
                          f"{r['peak_gib']:.2f} GiB" for r in rows), flush=True)
    for name, rows in big.items():
        r = rows[-1]
        sp = r["clock"].split()
        prof = r["clock"].profile
        ptxt = ("not profiled" if prof is None else
                f"{prof[0]} device kernels, device busy {prof[1]:.3f} ms of "
                f"{prof[2]:.3f} ms wall (idle share "
                f"{1 - prof[1] / prof[2]:.3f})")
        paths = collections.Counter(r["clock"].paths)
        print(f"[21 slab split] {card()} | {name} nx={r['nx']} nslab="
              f"{r['nslab']}, slab solves "
              + ", ".join(f"{p} x{k}" for p, k in sorted(paths.items()))
              + f" ({min(r['clock'].nfree)}-{max(r['clock'].nfree)} free "
              f"rows), median per call (total, calls): "
              + ", ".join(f"{k} {v[0]:.3f} ms ({v[1]:.1f} ms, {v[2]})"
                          for k, v in sp.items())
              + f" | 2nd BilinearForm.Assemble under torch.profiler: {ptxt}",
              flush=True)
    launches = ell_spmv.launches
    check(dia_cg.launches == 0, f"the space-time path launched dia_cg "
                                f"{dia_cg.launches} times")
    print(f"[21 launches] space-time path: ell_spmv {launches}, dia_cg "
          f"{dia_cg.launches} (every slab solve is an LU); wall of "
          f"phase 21 {time.perf_counter() - t0:.2f} s, of the whole run "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    return launches


# --- phases 22-23: matrix-free operators, subdivision quadrature, HDG ------

# phase 22: the JAX package's test sizes.  tests/test_operator.py's fictdom
# form (sphere r=0.4 in the unit square/cube, nx=6) as (dim, order), and
# tests/test_stencilop.py's plain order-2 Laplace on a 7 x 5 mesh;
# tests/test_backuprule.py's cases; tests/test_tracefem.py's HDG limits
MF_PARITY = ((2, 1), (2, 2), (3, 1), (3, 2))
MF_TOL, MF_ST_TOL, MF_OFF_TOL = 1e-12, 5e-13, 1e-13
SUBDIV_EOC_NX = (2, 4, 8, 16, 32)
HDG_NX, HDG_COND_NX = (8, 16), 12
HDG_EOC, HDG_P2_MAX = {1: 1.75, 2: 2.6}, 3e-4
# phase 23: card size.  The matrix-free operators on phase 19's systems;
# the sphere r=0.4 (a CoefficientFunction) on tets nx=48 at subdivlvl
# 0, 1, 2; tracefem_hdg order 2 at nx = 128, 256
MF_PCG_ITERS = 50
SUBDIV_BIG_NX, SUBDIV_LVLS, SUBDIV_RATIO = 48, (0, 1, 2), 2.5
HDG_BIG_NX = (128, 256)


def mf_fictdom(T, dim, nx, order, device):
    """tests/test_operator.py's fictdom form: NEG volume, Nitsche IF and
    facet-patch ghost penalty of the sphere r=0.4 at the centre of the unit
    square/cube.  Returns (space, form, free mask)."""
    if dim == 3:
        mesh = T.MakeStructured3DMesh(hexes=False, nx=nx, ny=nx, nz=nx)
        lev = (T.sqrt((T.x - .5) ** 2 + (T.y - .5) ** 2 + (T.z - .5) ** 2)
               - 0.4)
    else:
        mesh = T.MakeStructured2DMesh(quads=False, nx=nx, ny=nx)
        lev = T.sqrt((T.x - .5) ** 2 + (T.y - .5) ** 2) - 0.4
    lsetp1 = _p1(T, mesh, lev, device)
    ci = T.CutInfo(mesh, lsetp1)
    hasneg = ci.GetElementsOfType(T.HASNEG)
    hasif = ci.GetElementsOfType(T.IF)
    V = T.H1(mesh, order=order, dgjumps=True, device=device)
    u, v = V.TnT()
    h = T.specialcf.mesh_size
    nl = 1.0 / T.Norm(T.grad(lsetp1)) * T.grad(lsetp1)
    gp = T.GetFacetsWithNeighborTypes(mesh, a=hasneg, b=hasif)
    a = T.BilinearForm(V)
    a += T.SymbolicBFI({"levelset": lsetp1, "domain_type": T.NEG},
                       form=T.grad(u) * T.grad(v), definedonelements=hasneg)
    a += T.SymbolicBFI({"levelset": lsetp1, "domain_type": T.IF},
                       form=-(T.grad(u) * nl) * v - (T.grad(v) * nl) * u
                       + 40.0 / h * u * v)
    a += T.SymbolicFacetPatchBFI(
        form=0.1 / (h * h) * (u - u.Other()) * (v - v.Other()),
        definedonelements=gp)
    return V, a, T.GetDofsOfElements(V, hasneg)


def _rel_max(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _rel_2(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-300))


def mf_parity(T, device):
    """Phase 22, operators: ``AssembleOperator()`` (stencil) and
    ``lattice=False`` (partial assembly) of each ``MF_PARITY`` form and of
    the plain order-2 Laplace: ``matvec`` and ``diagonal()`` against
    ``a.mat`` (its B2 product on the card) to 1e-12 of the largest entry,
    stencil against PA to 5e-13, the per-offset apply against
    ``stencil_apply_plain`` to 1e-13 (both on the device), card against
    CPU to 1e-12."""
    from ngsxfem_tpu_torch.solvers.stencilop import (stencil_apply_offsets,
                                                     stencil_apply_plain)

    def laplace(dev):
        mesh = T.MakeStructured2DMesh(quads=False, nx=7, ny=5)
        V = T.H1(mesh, order=2, device=dev)
        u, v = V.TnT()
        a = T.BilinearForm(V)
        a += T.SymbolicBFI(form=T.grad(u) * T.grad(v) + u * v)
        return V, a, None

    cases = [(f"fictdom {dim}D P{order} nx=6",
              lambda dev, d=dim, o=order: mf_fictdom(T, d, 6, o, dev))
             for dim, order in MF_PARITY]
    cases.append(("laplace 2D P2 7x5", laplace))
    rows = []
    for label, build in cases:
        ys = {}
        for dev in (device, torch.device("cpu")):
            V, a, _ = build(dev)
            a.Assemble()
            x = torch.as_tensor(np.random.default_rng(11).standard_normal(
                V.ndof), device=dev)
            y_mat = a.mat.ell() @ x
            d_mat = a.mat.diagonal()
            st = a.AssembleOperator()
            pa = a.AssembleOperator(lattice=False)
            check(st.kind == "stencil" and pa.kind == "pa",
                  f"{label}: operator kinds {st.kind}, {pa.kind}")
            errs = {}
            for op in (st, pa):
                y = op.matvec(x)
                errs[op.kind] = (_rel_max(y, y_mat),
                                 _rel_max(op.diagonal(), d_mat))
                check(max(errs[op.kind]) <= MF_TOL,
                      f"{label} {op.kind} on {dev}: matvec/diagonal vs a.mat "
                      f"{errs[op.kind]}")
                ys[(dev.type, op.kind)] = y
            e_st = _rel_2(ys[(dev.type, "stencil")], ys[(dev.type, "pa")])
            check(e_st <= MF_ST_TOL, f"{label}: stencil vs PA {e_st}")
            e_off = _rel_2(
                stencil_apply_offsets(st.tables, st.offsets, st.reach,
                                      st.chan, st.fs, x),
                stencil_apply_plain(st.tables, st.meta, st.offsets,
                                    st.reach, st.chan, st.fs, x))
            check(e_off <= MF_OFF_TOL,
                  f"{label}: per-offset vs plain apply {e_off}")
            if dev == device:
                row = {"label": label, "ndof": V.ndof, "ncombo": st.ncombo,
                       "noff": len(st.offsets), "errs": errs, "st_pa": e_st,
                       "off_plain": e_off}
        e_cpu = max(_rel_max(ys[(device.type, k)].cpu(), ys[("cpu", k)])
                    for k in ("stencil", "pa"))
        check(e_cpu <= MF_TOL, f"{label}: card vs CPU {e_cpu}")
        row["card_cpu"] = e_cpu
        rows.append(row)
    return rows


def _both(fn, device, tol, what):
    """fn(device) and fn(cpu), equal to ``tol`` relative (at least 1)."""
    a, b = fn(device), fn(torch.device("cpu"))
    for u, w in zip(np.atleast_1d(a), np.atleast_1d(b)):
        check(abs(u - w) <= tol * max(1.0, abs(w)),
              f"{what}: card {a} vs CPU {b}")
    return a


def subdiv_parity(T, device):
    """Phase 22, subdivision quadrature, tests/test_backuprule.py's cases:
    straight cuts exact to 5e-15 (k+1)^2 (2D lvl 1-2, 3D lvl 1, orders 2
    and 8), the circle r=0.6 EOC > 1.75, ~4x per level (ratios > 2.5, mean
    > 3.4), the space-time plane exact to 5e-14; card == CPU to 1e-12."""
    out = {"cases": 0}

    def integ(mesh_fn, lset, dt, lvl, order, **kw):
        def run(dev):
            return T.Integrate({"levelset": lset, "domain_type": getattr(T, dt),
                                "subdivlvl": lvl}, 1.0, mesh_fn(), order=order,
                               device=dev, **kw)
        out["cases"] += 1
        return _both(run, device, 1e-12, f"subdiv {dt} lvl={lvl} o={order}")

    for quad in (True, False):
        for order in (2, 8):
            for dt, ref in (("NEG", 7 / 8), ("POS", 1 / 8),
                            ("IF", 1 / np.sqrt(2))):
                for lvl in (1, 2):
                    v = integ(lambda: T.MakeStructured2DMesh(
                        quads=quad, nx=2, ny=2), 1 - 2 * T.x - 2 * T.y, dt,
                        lvl, order)
                    check(abs(v - ref) < 5e-15 * (order + 1) ** 2,
                          f"subdiv 2D straight {dt} quad={quad} lvl={lvl}: "
                          f"{v} vs {ref}")
    for hex_ in (True, False):
        for order in (2, 8):
            for dt, ref in (("NEG", 47 / 48), ("POS", 1 / 48),
                            ("IF", np.sqrt(3) / 8)):
                v = integ(lambda: T.MakeStructured3DMesh(
                    hexes=hex_, nx=1, ny=1, nz=1),
                    1 - 2 * T.x - 2 * T.y - 2 * T.z, dt, 1, order)
                check(abs(v - ref) < 5e-15 * (order + 1) ** 2,
                      f"subdiv 3D straight {dt} hex={hex_}: {v} vs {ref}")
    r = 0.6
    circle = T.sqrt(T.x * T.x + T.y * T.y) - r
    refs = {"NEG": np.pi * r * r / 4, "POS": 1 - np.pi * r * r / 4,
            "IF": r * np.pi / 2}
    out["eoc"] = {}
    for dt in ("NEG", "POS", "IF"):
        e = [abs(integ(lambda n=n: T.MakeStructured2DMesh(
            quads=False, nx=n, ny=n), circle, dt, 1, 4) - refs[dt])
            for n in SUBDIV_EOC_NX]
        eoc = [float(np.log2(e[i] / e[i + 1])) for i in range(len(e) - 1)]
        check(sum(eoc[1:]) / len(eoc[1:]) > 1.75, f"subdiv circle {dt} EOC "
                                                  f"{eoc}")
        out["eoc"][dt] = eoc
    out["levels"] = {}
    for dt in ("NEG", "IF"):
        e = [abs(integ(lambda: T.MakeStructured2DMesh(quads=False, nx=2,
                                                      ny=2),
                       circle, dt, lvl, 4) - refs[dt]) for lvl in (1, 2, 3, 4)]
        ratios = [e[i] / e[i + 1] for i in range(3)]
        check(min(ratios) > 2.5 and sum(ratios) / 3 > 3.4,
              f"subdiv levels {dt}: ratios {ratios}")
        out["levels"][dt] = ratios
    for quad in (True, False):
        for dt, ref in (("NEG", 7 / 8), ("POS", 1 / 8), ("IF", 0.5)):
            v = integ(lambda: T.MakeStructured2DMesh(quads=quad, nx=1, ny=1),
                      1 - 2 * T.x - 2 * T.tref, dt, 1, 1, time_order=1)
            check(abs(v - ref) < 5e-14, f"subdiv space-time {dt}: {v}")
    return out


def _rt0_constant_dofs(mesh, v0):
    """RT0 dofs of a constant field: outward fluxes over the facets, each
    oriented away from the facet's first neighbour."""
    fverts = mesh.vertices_np[mesh.facets_np]
    if mesh.dim == 2:
        t = fverts[:, 1] - fverts[:, 0]
        n = np.stack([t[:, 1], -t[:, 0]], axis=1)
    else:
        n = 0.5 * np.cross(fverts[:, 1] - fverts[:, 0],
                           fverts[:, 2] - fverts[:, 0])
    e0 = mesh.facet2el_np[:, 0]
    cent = mesh.vertices_np[mesh.elements_np[e0]].mean(axis=1)
    s = np.sign(np.einsum("fd,fd->f", n, fverts.mean(axis=1) - cent))
    return (n * s[:, None]) @ np.asarray(v0)


def spaces_parity(T, device):
    """Phase 22, spaces: HDiv RT0 reproduces constants (2D nx=3, 3D nx=2,
    error < 1e-22), its divergence theorem (1e-12), and the SFESpace L2
    projection of x + y (error < 1e-20), card == CPU."""
    from ngsxfem_tpu_torch.cf.context import EvalCtx

    def rt0(dev):
        errs = []
        for mesh in (T.MakeStructured2DMesh(quads=False, nx=3, ny=3),
                     T.MakeStructured3DMesh(hexes=False, nx=2, ny=2, nz=2)):
            gf = T.GridFunction(T.HDiv(mesh, order=0, device=dev))
            v0 = np.arange(1, mesh.dim + 1, dtype=float)
            gf.vec.data = _rt0_constant_dofs(mesh, v0)
            c = T.CoefficientFunction(tuple(float(a) for a in v0))
            errs.append(T.Integrate(cf=T.InnerProduct(gf - c, gf - c),
                                    mesh=mesh, order=3, device=dev))
        return errs

    errs = _both(rt0, device, 1e-20, "HDiv RT0 constants")
    check(max(abs(e) for e in errs) < 1e-22, f"HDiv RT0 constants {errs}")

    def divthm(dev):
        mesh = T.MakeStructured2DMesh(quads=False, nx=4, ny=4)
        V = T.HDiv(mesh, order=0, device=dev)
        vec = np.random.default_rng(3).standard_normal(V.ndof)
        cent = torch.full((mesh.ne, 1, 2), 1.0 / 3.0, dtype=torch.float64,
                          device=dev)
        ctx = EvalCtx(mesh, cent)
        _, dv = V._piola(ctx, ctx.ref_pts)
        div_el = (dv[:, 0] * torch.as_tensor(vec, device=dev)[
            V.el2dof_on(dev)]).sum(1)
        return (float((div_el * ctx.detJ.abs()[:, 0] * 0.5).sum()),
                float(vec[mesh.boundary_facets_np].sum()))

    d = _both(divthm, device, 1e-12, "HDiv divergence theorem")
    check(abs(d[0] - d[1]) < 1e-12, f"HDiv divergence theorem {d}")

    def sfe(dev):
        mesh = T.MakeStructured2DMesh(
            quads=False, nx=10, ny=10,
            mapping=lambda a, b: (3 * a - 1.5, 3 * b - 1.5))
        lset = _p1(T, mesh, T.sqrt(T.x * T.x + T.y * T.y) - 1.0, dev)
        S = T.SFESpace(mesh, lset, order=1, device=dev)
        u, v = S.TnT()
        lif = {"levelset": lset, "domain_type": T.IF}
        a = T.BilinearForm(S)
        a += T.SymbolicBFI(lif, form=u * v)
        a.Assemble()
        f = T.LinearForm(S)
        f += T.SymbolicLFI(lif, form=(T.x + T.y) * v)
        f.Assemble()
        gfu = T.GridFunction(S)
        gfu.vec.data = a.mat.Inverse(S.FreeDofs()) * f.vec.data
        err = T.Integrate(lif, (gfu - (T.x + T.y)) * (gfu - (T.x + T.y)),
                          mesh, order=4)
        return [err] + gfu.vec.data.cpu().tolist()

    s = _both(sfe, device, 1e-12, "SFESpace projection")
    check(abs(s[0]) < 1e-20, f"SFESpace projection error {s[0]}")
    return {"rt0": errs, "divthm": d, "sfe_err": s[0], "sfe_ndof": len(s) - 1}


def hdg_parity(T, device):
    """Phase 22, ``tracefem_hdg``: orders 1 and 2 at nx = 8, 16 (EOC > 1.75
    / > 2.6, order 2 error < 3e-4) and ``condense=True`` equal to the direct
    solve to 1e-8 at nx=12, card == CPU to 1e-8."""
    from ngsxfem_tpu_torch.examples import tracefem_hdg

    out = {}
    for order in (1, 2):
        e = [_both(lambda dev, nx=nx: tracefem_hdg.run(
            nx, order=order, verbose=False, device=dev), device, 1e-8,
            f"tracefem_hdg P{order} nx={nx}") for nx in HDG_NX]
        eoc = float(np.log2(e[0] / e[1]))
        check(eoc > HDG_EOC[order], f"tracefem_hdg P{order} {e}: EOC {eoc}")
        out[order] = (e, eoc)
    check(out[2][0][1] < HDG_P2_MAX, f"tracefem_hdg P2 nx=16 {out[2][0][1]}")
    ec, ed = (_both(lambda dev, c=c: tracefem_hdg.run(
        HDG_COND_NX, order=1, verbose=False, condense=c, device=dev), device,
        1e-8, f"tracefem_hdg condense={c}") for c in (True, False))
    check(abs(ec - ed) < 1e-8, f"tracefem_hdg condensed {ec} vs direct {ed}")
    out["condense"] = (ec, ed)
    return out


def mf_pcg(matvec, diag, free, load, device, iters=MF_PCG_ITERS):
    """Jacobi-PCG of ``iters`` iterations (tol 0: a fixed budget) on the
    free block through ``matvec``: (x, ms by CUDA events, profile
    (kernels, busy ms, idle share, wall ms), products over all the runs
    made here)."""
    from ngsxfem_tpu_torch.solvers.krylov import cg

    fm = torch.as_tensor(free, device=device)
    dinv = torch.where(fm & (diag.abs() > 1e-30), 1.0 / diag, 0.0)
    b = torch.where(fm, load, 0.0)
    products = [0]

    def mv(z):
        products[0] += 1
        return torch.where(fm, matvec(torch.where(fm, z, 0.0)), 0.0)

    def run():
        return cg(mv, b, M=lambda r: dinv * r, maxiter=iters, tol=0.0)[0]

    x, ms = event_ms(run)
    prof = None
    if device.type == "cuda":
        ms = time_ms(run, reps=3)
        kern, wall = device_kernels(run, 1, warm=False)
        busy = sum(us for _, us in kern.values()) / 1e3
        prof = (sum(c for c, _ in kern.values()), busy, 1 - busy / wall, wall)
    return x, ms, prof, products[0]


def mf_card(T, rec, device, lattices):
    """Phase 23 on one of phase 19's systems (``rec``, kept with its
    deformation): per ``lattice`` the operator by CUDA events, its kind and
    bytes, the symmetry probe, ``matvec`` against B2's product of ``a.mat``
    (1e-12 relative), one apply's time, kernels and bound, Jacobi-PCG-50 on
    ``op.diagonal()`` beside the same PCG through B2 (ell_spmv launches ==
    products), and the peak memory."""
    from ngsxfem_tpu_torch.solvers import ell_spmv

    a, f, V, free, _ = rec["system"]
    mesh = V.mesh
    mesh.SetDeformation(rec["deformation"])
    rows = []
    try:
        n = V.ndof
        ar = torch.arange(n, dtype=torch.float64, device=device)
        xu, xv = torch.cos(ar), torch.sin(ar)
        ell = a.mat.ell()
        before = ell_spmv.launches
        y_b2 = ell @ xu
        x_b2, b2_ms, b2_prof, calls = mf_pcg(
            lambda z: ell @ z, a.mat.diagonal(), free.np, f.vec.data, device)
        b2_launches = ell_spmv.launches - before
        check(b2_launches == ((1 + calls) if device.type == "cuda" else 0),
              f"{rec['label']}: {b2_launches} ell_spmv launches, "
              f"{1 + calls} products")
        fm = torch.as_tensor(free.np, device=device)
        load = torch.where(fm, f.vec.data, 0.0)

        def res_of(z):  # true relative residual on the free block, via B2
            r = torch.where(fm, load - ell @ torch.where(fm, z, 0.0), 0.0)
            return float(torch.linalg.vector_norm(r)
                         / torch.linalg.vector_norm(load))

        res_b2 = res_of(x_b2)
        for lattice in lattices:
            peak_gib(device)
            op, build_ms = event_ms(lambda: a.AssembleOperator(lattice))
            row = {"label": rec["label"], "lattice": lattice,
                   "kind": op.kind, "build_ms": build_ms,
                   "nbytes": op.nbytes(), "ndof": n}
            y = op.matvec(xu)
            row["vs_b2"] = _rel_max(y, y_b2)
            check(row["vs_b2"] <= MF_TOL, f"{rec['label']} {op.kind}: matvec "
                                          f"vs B2 {row['vs_b2']}")
            uav = float(torch.dot(xu, op.matvec(xv)))
            vau = float(torch.dot(xv, y))
            row["sym"] = abs(uav - vau) / max(abs(uav), 1e-30)
            if op.kind == "stencil":
                row.update(ncombo=op.ncombo, noff=len(op.offsets),
                           reach=op.reach)
            x, row["pcg_ms"], row["pcg_prof"], _ = mf_pcg(
                op.matvec, op.diagonal(), free.np, f.vec.data, device)
            # the two PCG-50 iterates part by round-off amplified over the
            # iterations; their true residuals (through B2) must agree
            row["pcg_vs_b2"] = _rel_2(x, x_b2)
            row["res"] = (res_of(x), res_b2)
            check(np.isfinite(row["res"][0])
                  and row["res"][0] <= 2 * res_b2 + 1e-12,
                  f"{rec['label']} {op.kind}: PCG-{MF_PCG_ITERS} true "
                  f"residual {row['res'][0]} vs B2's {res_b2}")
            if device.type == "cuda":
                row["apply_ms"] = time_ms(lambda: op.matvec(xu), reps=5)
                kern, wall = device_kernels(lambda: op.matvec(xu), 1)
                busy = sum(us for _, us in kern.values()) / 1e3
                row["apply_prof"] = (sum(c for c, _ in kern.values()), busy,
                                     1 - busy / wall)
                nvals = (op.tables.numel() if op.kind == "stencil" else
                         sum(m.numel() for m, _, _ in op.parts))
                row["bound_ms"] = bound(op.nbytes() + 2 * n * 8, 2 * nvals,
                                        F64_FLOP_PER_S)
            row["peak_gib"] = peak_gib(device)
            rows.append(row)
            del op
    finally:
        mesh.UnsetDeformation()
    return {"rows": rows, "b2_ms": b2_ms, "b2_prof": b2_prof,
            "b2_launches": b2_launches, "label": rec["label"]}


def subdiv_card(T, device):
    """Phase 23, subdivision ``Integrate``: the NEG volume of the sphere
    r=0.4 (a CoefficientFunction) at the centre of the unit cube on tets
    nx=48 at subdivlvl 0, 1, 2 (order 2): errors against 4/3 pi r^3 falling
    ~4x per level, the band and mixed-child counts, ms by CUDA events, peak
    memory."""
    from ngsxfem_tpu_torch.integrate import subdiv_tiers

    mesh = T.MakeStructured3DMesh(hexes=False, nx=SUBDIV_BIG_NX,
                                  ny=SUBDIV_BIG_NX, nz=SUBDIV_BIG_NX)
    c = (T.sqrt((T.x - 0.5) ** 2 + (T.y - 0.5) ** 2 + (T.z - 0.5) ** 2)
         - SPHERE_R)
    exact = 4 / 3 * np.pi * SPHERE_R ** 3
    rows = []
    for lvl in SUBDIV_LVLS:
        ld = {"levelset": c, "domain_type": T.NEG, "subdivlvl": lvl}
        peak_gib(device)
        with warnings.catch_warnings():  # lvl 0: the P1 interpolation
            warnings.simplefilter("ignore")
            T.Integrate(ld, 1.0, mesh, order=2, device=device)  # warm-up
            v, ms = event_ms(lambda: T.Integrate(ld, 1.0, mesh, order=2,
                                                 device=device))
        row = {"lvl": lvl, "vol": v, "err": abs(v - exact), "ms": ms,
               "peak_gib": peak_gib(device)}
        if lvl > 0:
            tiers = subdiv_tiers(mesh, c, T.NEG, 2, lvl, device)
            row["band"], row["mixed"] = len(tiers[1][3]), len(tiers[2][3])
            del tiers
        rows.append(row)
    for r0, r1 in zip(rows, rows[1:]):
        check(r0["err"] / r1["err"] > SUBDIV_RATIO,
              f"subdiv nx={SUBDIV_BIG_NX}: errors {[r['err'] for r in rows]}")
    return rows


def hdg_card(T, device, small_err):
    """Phase 23, ``tracefem_hdg`` order 2 at ``HDG_BIG_NX``, each built once
    through ``system()``: ``Assemble`` by CUDA events, ``to_ell`` (host clock),
    the default ``Inverse()`` (its path; on ``device_cg`` ell_spmv launches
    == products == iterations + 1), the L2 error below nx=16's."""
    from ngsxfem_tpu_torch import GridFunction
    from ngsxfem_tpu_torch.examples import tracefem_hdg
    from ngsxfem_tpu_torch.solvers import ell_spmv

    rows = []
    for nx in HDG_BIG_NX:
        t0 = time.perf_counter()
        peak_gib(device)
        s = tracefem_hdg.system(nx, order=2, device=device)
        mesh, a, f = s["mesh"], s["a"], s["f"]
        mesh.SetDeformation(s["deformation"])
        try:
            row = {"nx": nx, "ndof": s["Vhg"].ndof,
                   "nfree": int(s["freedofs"].np.sum())}
            _, row["asm_a_ms"] = event_ms(a.Assemble)
            _, row["asm_f_ms"] = event_ms(f.Assemble)
            t1 = time.perf_counter()
            a.mat.ell()
            sync(device)
            row["to_ell_s"] = time.perf_counter() - t1
            inv = a.mat.Inverse(s["freedofs"])
            row["path"] = inv.path
            before = ell_spmv.launches
            with counted_products("cg") as cnt:
                x, row["solve_ms"] = event_ms(lambda: inv * f.vec.data)
            row["launches"] = ell_spmv.launches - before
            row["iters"], row["products"] = cnt.iters, cnt.products
            if inv.path == "device_cg":
                check(row["launches"] == (cnt.products
                                          if device.type == "cuda" else 0)
                      and cnt.products == cnt.iters + 1,
                      f"tracefem_hdg nx={nx}: {row['launches']} launches, "
                      f"{cnt.products} products, {cnt.iters} iterations")
            gfu = GridFunction(s["Vhg"])
            gfu.vec.data = x
            row["err"] = tracefem_hdg.error(s, gfu, 2)
        finally:
            mesh.UnsetDeformation()
        check(row["err"] < small_err, f"tracefem_hdg nx={nx} L2 "
                                      f"{row['err']} >= nx=16's {small_err}")
        row["peak_gib"] = peak_gib(device)
        row["wall_s"] = time.perf_counter() - t0
        rows.append(row)
    return rows


def _prof_text(p):
    if p is None:
        return "not profiled"
    return (f"{p[0]} device kernels ({p[0] / MF_PCG_ITERS:.1f} per "
            f"iteration), busy {p[1]:.2f} ms of {p[3]:.2f} ms wall, idle "
            f"share {p[2]:.3f}")


def phases_22_23(T, dev, t_start, iso):
    """Phases 22 (matrix-free operators, subdivision quadrature, the new
    spaces and tracefem_hdg at the JAX package's test sizes, card against
    CPU) and 23 (card size: the matrix-free operators on phase 19's
    systems, subdivision Integrate at nx=48, tracefem_hdg at nx=128, 256),
    launch counters reset just before them.  Returns (ell_spmv launches of
    the path, B2's launches per table)."""
    from ngsxfem_tpu_torch.solvers import dia_cg, ell_spmv

    sync(dev)
    peak_gib(dev)
    dia_cg.launches = 0
    ell_spmv.launches = 0
    t0 = time.perf_counter()
    mf = mf_parity(T, dev)
    print("[22 operators] card (CPU) f64: " + "; ".join(
        f"{r['label']} ({r['ndof']} dofs, {r['ncombo']} combos on "
        f"{r['noff']} offsets): matvec/diagonal vs a.mat stencil "
        f"{r['errs']['stencil'][0]:.1e}/{r['errs']['stencil'][1]:.1e}, PA "
        f"{r['errs']['pa'][0]:.1e}/{r['errs']['pa'][1]:.1e}, stencil vs PA "
        f"{r['st_pa']:.1e}, per-offset vs plain {r['off_plain']:.1e}, card "
        f"vs CPU {r['card_cpu']:.1e}" for r in mf), flush=True)
    sd = subdiv_parity(T, dev)
    print(f"[22 subdiv] {sd['cases']} Integrate cases card == CPU to 1e-12, "
          f"straight cuts exact; circle EOC "
          + ", ".join(f"{k} {[round(e, 3) for e in v]}"
                      for k, v in sd["eoc"].items())
          + "; level ratios "
          + ", ".join(f"{k} {[round(e, 2) for e in v]}"
                      for k, v in sd["levels"].items()), flush=True)
    sp = spaces_parity(T, dev)
    hd = hdg_parity(T, dev)
    print(f"[22 spaces] HDiv RT0 constants {sp['rt0']}, divergence theorem "
          f"{sp['divthm'][0]:.15f} = {sp['divthm'][1]:.15f}; SFESpace "
          f"({sp['sfe_ndof']} dofs) projection error {sp['sfe_err']:.2e}; "
          f"tracefem_hdg P1 nx={list(HDG_NX)} "
          f"{[f'{e:.10e}' for e in hd[1][0]]} (EOC {hd[1][1]:.3f}), P2 "
          f"{[f'{e:.10e}' for e in hd[2][0]]} (EOC {hd[2][1]:.3f}), condensed "
          f"{hd['condense'][0]:.12e} vs direct {hd['condense'][1]:.12e} at "
          f"nx={HDG_COND_NX}; all card == CPU; wall of phase 22 "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 23. card size
    t0 = time.perf_counter()
    tables = []
    for i, rec in enumerate(iso[:2]):
        res = mf_card(T, rec, dev, ("auto", False) if i == 0 else ("auto",))
        tables.append({"table": f"{res['label']} (PCG-{MF_PCG_ITERS} beside "
                                f"the matrix-free operators)",
                       "launches": res["b2_launches"]})
        print(f"[23 matrix-free] {card()} | {res['label']}: assembled "
              f"Jacobi-PCG-{MF_PCG_ITERS} through B2 {res['b2_ms']:.2f} ms "
              f"({res['b2_ms'] / MF_PCG_ITERS:.3f} ms per iteration; "
              f"{_prof_text(res['b2_prof'])}; {res['b2_launches']} ell_spmv "
              f"launches)", flush=True)
        for r in res["rows"]:
            ap = r.get("apply_prof", (0, 0.0, 0.0))
            extra = (f", {r['ncombo']} combos on {r['noff']} offsets, reach "
                     f"{r['reach']}" if r["kind"] == "stencil" else "")
            print(f"[23 matrix-free] {card()} | {r['label']} "
                  f"AssembleOperator(lattice={r['lattice']!r}) -> {r['kind']}"
                  f"{extra}: built in {r['build_ms']:.1f} ms, {r['nbytes']} "
                  f"bytes; matvec vs B2 {r['vs_b2']:.2e}, symmetry probe "
                  f"{r['sym']:.2e}; one apply {r.get('apply_ms', 0.0):.3f} ms "
                  f"({ap[0]} device kernels, busy {ap[1]:.3f} ms, idle share "
                  f"{ap[2]:.3f}; bound {r.get('bound_ms', (0.0, ''))[0]:.3f} "
                  f"ms by {r.get('bound_ms', (0.0, ''))[1]}); Jacobi-PCG-"
                  f"{MF_PCG_ITERS} on op.diagonal() {r['pcg_ms']:.2f} ms "
                  f"({r['pcg_ms'] / MF_PCG_ITERS:.3f} ms per iteration; "
                  f"{_prof_text(r['pcg_prof'])}), true residual "
                  f"{r['res'][0]:.3e} (B2's {r['res'][1]:.3e}), iterate vs "
                  f"B2's {r['pcg_vs_b2']:.1e}; peak memory "
                  f"{r['peak_gib']:.2f} GiB",
                  flush=True)
    for rec in iso:
        rec.pop("system", None)
        rec.pop("deformation", None)
    rows = subdiv_card(T, dev)
    print(f"[23 subdiv] {card()} | NEG volume of the sphere r={SPHERE_R} "
          f"(CF) on tets nx={SUBDIV_BIG_NX}, order 2: " + "; ".join(
              f"subdivlvl {r['lvl']}: error {r['err']:.4e}, {r['ms']:.1f} ms"
              + (f", band {r['band']} tets, {r['mixed']} mixed children"
                 if "band" in r else "")
              + f", peak {r['peak_gib']:.2f} GiB" for r in rows), flush=True)
    big = hdg_card(T, dev, hd[2][0][1])
    for r in big:
        tables.append({"table": f"tracefem_hdg P2 nx={r['nx']} "
                                f"({r['path']})", "launches": r["launches"]})
        print(f"[23 hdg] {card()} | tracefem_hdg P2 nx={r['nx']} "
              f"({r['ndof']} dofs, {r['nfree']} free): BilinearForm.Assemble "
              f"{r['asm_a_ms']:.1f} ms, LinearForm.Assemble "
              f"{r['asm_f_ms']:.1f} ms, to_ell {r['to_ell_s']:.3f} s "
              f"({ran_on(dev)}), "
              f"default Inverse() {r['path']}: {r['iters']} iterations, "
              f"{r['products']} products, {r['launches']} ell_spmv launches, "
              f"{r['solve_ms']:.1f} ms; L2 {r['err']:.10e}; peak memory "
              f"{r['peak_gib']:.2f} GiB; wall {r['wall_s']:.2f} s", flush=True)
    launches = ell_spmv.launches
    check(launches > 0 or dev.type != "cuda",
          "the matrix-free path launched ell_spmv no time")
    print(f"[23 launches] ell_spmv {launches}, dia_cg {dia_cg.launches}; "
          f"wall of phase 23 {time.perf_counter() - t0:.2f} s, of the whole "
          f"run {time.perf_counter() - t_start:.2f} s", flush=True)
    return launches, tables


# --- phases 24-25: general cut multigrid, meshing and refinement -----------

CUTMG_BIG = ((2, 80, 3), (3, 12, 3))  # (dim, nx0, levels): fine nx 320 / 48
CUTMG_PARITY = ((2, 8, 2), (3, 4, 3))  # the JAX tests' sizes, card == CPU
P2TG_NX = 128           # P2TwoGridCL on the 2D P2 problem, edge patches
P2TG_TOL = 1e-8
REFINE_CASES = (("trig", 64), ("tet", 8), ("quad", 64), ("hex", 12))
LSREF_CASES = (("trig", 32, 3), ("tet", 8, 2))  # (et, nx, levels)
UNSTR_NPTS = 12_500     # Delaunay: ~25,000 trigs, one Refine(): ~100,000
UNSTR_PARITY_NPTS = 900  # examples.unstructured_nxfem's own size
HOST_CAP_S = 10.0       # a host refinement slower than this is reported
PARITY_TOL = 1e-8       # card vs CPU: MG-CG solutions and L2 errors
INTEGRATE_TOL = 1e-12   # card vs CPU: Integrate
COMPOSITE_NX = 96       # the quad-dominated fictitious domain on the card


class counted_ell:
    """While active, counts the ELL products (``ELLMatrix.matvec`` calls,
    however bound): the sparse products of a cycle, each of which should
    launch B2 once on the card."""

    def __enter__(self):
        from ngsxfem_tpu_torch.solvers import sparse

        self.mod, self.calls = sparse, 0
        self.orig = sparse.ell_matvec

        def ell_matvec(*args, **kw):
            self.calls += 1
            return self.orig(*args, **kw)

        sparse.ell_matvec = ell_matvec
        return self

    def __exit__(self, *exc):
        self.mod.ell_matvec = self.orig


class timed_calls:
    """While active, records the seconds of each call of ``cls.name`` (by
    CUDA events with ``events`` on the card, else by the host clock after a
    device sync), and the object it was called on."""

    def __init__(self, cls, name, device, events=False):
        self.cls, self.name, self.device = cls, name, device
        self.events = events and device.type == "cuda"
        self.seconds, self.objs = [], []

    def __enter__(self):
        self.orig = getattr(self.cls, self.name)

        def run(obj, *args, **kw):
            if self.events:
                out, ms = event_ms(lambda: self.orig(obj, *args, **kw))
                self.seconds.append(ms / 1e3)
            else:
                sync(self.device)
                t0 = time.perf_counter()
                out = self.orig(obj, *args, **kw)
                sync(self.device)
                self.seconds.append(time.perf_counter() - t0)
            self.objs.append(obj)
            return out

        setattr(self.cls, self.name, run)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.orig)


def _prof(fn, iters):
    """(device kernels per iteration, busy ms, idle share, wall ms) of one
    call of ``fn`` that runs ``iters`` solver iterations (None on the
    CPU)."""
    if not torch.cuda.is_available():
        return None
    kern, wall = device_kernels(fn, 1, warm=False)
    busy = sum(us for _, us in kern.values()) / 1e3
    nk = sum(c for c, _ in kern.values())
    return (nk / max(iters, 1), busy, 1 - busy / wall, wall)


def _prof_line(p):
    if p is None:
        return "not profiled"
    return (f"{p[0]:.1f} device kernels per iteration, busy {p[1]:.2f} ms of "
            f"{p[3]:.2f} ms wall, idle share {p[2]:.3f}")


def _vec_rel(a, b):
    return float(torch.linalg.vector_norm(a.cpu() - b.cpu())
                 / torch.linalg.vector_norm(b.cpu()).clamp_min(1e-300))


def cutmg_card(T, dev, dim, nx0, levels):
    """``examples.cutmg.run`` at card size on ``dev``: the JAX tests'
    limits, per-stage host setup, MG-CG and Jacobi-CG by events and under
    the profiler, B2 launches against the ELL products of one MG-CG solve,
    a second solve bitwise equal to the first, peak memory; B2 against its
    plain versions on the finest prolongation and restriction tables."""
    from ngsxfem_tpu_torch.examples import cutmg
    from ngsxfem_tpu_torch.solvers import ell_spmv

    sync(dev)
    peak_gib(dev)
    st = {}
    t0 = time.perf_counter()
    it_mg, it_j, diff = cutmg.run(nx0=nx0, levels=levels, dim=dim,
                                  verbose=False, device=dev, stats=st)
    sync(dev)
    out = {"label": f"{dim}D nx0={nx0} levels={levels} (fine nx="
                    f"{nx0 * 2 ** (levels - 1)})", "it_mg": it_mg,
           "it_j": it_j, "diff": diff, "ndof": st["ndof"],
           "nfree": st["nfree"], "setup": st["setup_s"],
           "wall_s": time.perf_counter() - t0}
    check(diff < 1e-6, f"cutmg {out['label']}: MG-CG vs Jacobi-CG {diff}")
    check(it_mg < it_j / 2, f"cutmg {out['label']}: MG-CG {it_mg} "
                            f"iterations vs Jacobi-CG {it_j}")
    (x2, it2, _), out["mg_ms"] = event_ms(st["mgcg"])
    check(it2 == it_mg and torch.equal(x2, st["x_mg"]),
          f"cutmg {out['label']}: a second MG-CG solve differs")
    (_, itj2, _), out["j_ms"] = event_ms(st["jcg"])
    check(itj2 == it_j, f"cutmg {out['label']}: Jacobi-CG iterations")
    l0 = ell_spmv.launches
    with counted_ell() as c:
        st["mgcg"]()
    out["launches"] = ell_spmv.launches - l0
    out["products"] = c.calls
    check(out["launches"] == (c.calls if dev.type == "cuda" else 0),
          f"cutmg {out['label']}: {out['launches']} ell_spmv launches for "
          f"{c.calls} ELL products")
    out["mg_prof"] = _prof(st["mgcg"], it_mg)
    out["j_prof"] = _prof(st["jcg"], it_j)
    out["peak_gib"] = peak_gib(dev)
    sm = st["smoothers"][-1]
    out["if_rows"] = (0 if sm.ifsolve is None
                      else int(sm.ifsolve[0].numel()))
    out["tables"] = []
    if dev.type == "cuda":
        P = st["prols"][-1]
        rng = np.random.default_rng(2031)
        for kind, E in (("prolongation", P.ell()), ("restriction",
                                                    P._ell_T)):
            x = torch.as_tensor(rng.standard_normal(E.shape[1]),
                                dtype=E.vals.dtype, device=dev)
            label = f"cutmg {dim}D {kind} nx={nx0 * 2 ** (levels - 1)}"
            err, _ = ell_kernel_vs_plain([(label, E.vals, E.cols, x)])
            b2 = b2_timed(label, E, x)
            b2["err"] = err
            out["tables"].append(b2)
    return out


def cutmg_parity(T, dev):
    """``examples.cutmg`` at the JAX tests' sizes on the card and on this
    host's CPU: MG-CG iterations within one, solutions to 1e-8, a second
    solve on the card bitwise equal to the first."""
    from ngsxfem_tpu_torch.examples import cutmg

    rows = []
    for dim, nx0, levels in CUTMG_PARITY:
        res = []
        for d in (dev, torch.device("cpu")):
            st = {}
            it = cutmg.run(nx0=nx0, levels=levels, dim=dim, verbose=False,
                           device=d, stats=st)
            res.append((it, st["x_mg"]))
            if d == dev:
                x2, it2, _ = st["mgcg"]()
                check(it2 == it[0] and torch.equal(x2, st["x_mg"]),
                      f"cutmg {dim}D nx0={nx0}: a second card solve differs")
        (a, xa), (b, xb) = res
        rel = _vec_rel(xa, xb)
        check(abs(a[0] - b[0]) <= 1 and rel <= PARITY_TOL,
              f"cutmg {dim}D nx0={nx0}: card {a} vs CPU {b}, rel {rel}")
        check(a[2] < 1e-6 and a[0] < a[1] / 2, f"cutmg {dim}D nx0={nx0} {a}")
        rows.append((dim, nx0, levels, a, b, rel))
    return rows


def p2_cut_system(T, nx, order, dev):
    """tests/test_cutmg_api.py's system (circle r=0.6 on [-1, 1]^2 trigs,
    Nitsche 20 k^2 / h, ghost penalty on the facet patches): (mesh, V, ci,
    a.mat, f.vec, active dofs)."""
    mesh = T.MakeStructured2DMesh(quads=False, nx=nx, ny=nx,
                                  mapping=lambda a, b: (2 * a - 1, 2 * b - 1))
    lsetp1 = T.GridFunction(T.H1(mesh, order=1, device=dev))
    T.InterpolateToP1(T.sqrt(T.x * T.x + T.y * T.y) - 0.6, lsetp1)
    ci = T.CutInfo(mesh, lsetp1)
    hasneg = ci.GetElementsOfType(T.HASNEG)
    hasif = ci.GetElementsOfType(T.IF)
    V = T.H1(mesh, order=order, dgjumps=True, device=dev)
    gp = T.GetFacetsWithNeighborTypes(mesh, a=hasneg, b=hasif)
    h = T.specialcf.mesh_size
    nl = 1.0 / T.Norm(T.grad(lsetp1)) * T.grad(lsetp1)
    u, v = V.TnT()
    a = T.BilinearForm(V)
    a += T.SymbolicBFI({"levelset": lsetp1, "domain_type": T.NEG},
                       form=T.grad(u) * T.grad(v), definedonelements=hasneg)
    a += T.SymbolicBFI({"levelset": lsetp1, "domain_type": T.IF},
                       form=-(T.grad(u) * nl) * v - (T.grad(v) * nl) * u
                       + 20.0 * order * order / h * u * v)
    a += T.SymbolicFacetPatchBFI(
        form=0.5 / (h * h) * (u - u.Other()) * (v - v.Other()),
        definedonelements=gp)
    a.Assemble()
    f = T.LinearForm(V)
    f += T.SymbolicLFI({"levelset": lsetp1, "domain_type": T.NEG},
                       form=T.CoefficientFunction(1.0) * v,
                       definedonelements=hasneg)
    f.Assemble()
    return mesh, V, ci, a.mat, f.vec.data, T.GetDofsOfElements(V, hasneg)


def p2twogrid_card(T, dev):
    """``P2TwoGridCL`` (edge patches, nu=2, maxit=30, tol=1e-8, the
    interface CG) on the P2 problem at nx=P2TG_NX with the P1 system's
    default ``Inverse()`` as the coarse solver: the JAX test's r < 1e-6
    ||b||, the batched block setup by events, iterations, pinv."""
    from ngsxfem_tpu_torch.solvers import ell_spmv
    from ngsxfem_tpu_torch.solvers import mg as tmg

    sync(dev)
    peak_gib(dev)
    t0 = time.perf_counter()
    mesh, V2, ci, A2, b2, act2 = p2_cut_system(T, P2TG_NX, 2, dev)
    _, V1, _, A1, _, act1 = p2_cut_system(T, P2TG_NX, 1, dev)
    sync(dev)
    out = {"ndof": V2.ndof, "system_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    blocks = tmg.EdgePatches(V2, mesh)
    out["patches_s"] = time.perf_counter() - t0
    free = np.asarray(V2.FreeDofs().np)
    stats = {}
    tmg._prepare_blocks(A2, blocks, free)  # warm-up
    _, out["blocks_ms"] = event_ms(
        lambda: tmg._prepare_blocks(A2, blocks, free, stats))
    out.update(stats)
    coarse = A1.Inverse(act1)
    out["coarse_path"] = coarse.path
    t0 = time.perf_counter()
    tg = T.P2TwoGridCL(a=A2, fes=V2, mesh=mesh, ci=ci, ifsolver="cg",
                       linmgiter=coarse, coarse_space=V1, patchtype="edge",
                       nu=2, maxit=30, tol=P2TG_TOL)
    sync(dev)
    out["setup_s"] = time.perf_counter() - t0
    fm = torch.as_tensor(act2.np, device=dev)
    tg.free = fm
    l0 = ell_spmv.launches
    x, out["mult_ms"] = event_ms(lambda: tg.Mult(b2))
    out["launches"] = ell_spmv.launches - l0
    out["iters"] = tg.iterations
    check(torch.equal(tg.Mult(b2), x) and tg.iterations == out["iters"],
          f"P2TwoGridCL nx={P2TG_NX}: a second Mult differs from the first")
    r = float(torch.linalg.vector_norm(torch.where(
        fm, b2 - A2.ell().matvec(x), 0.0)))
    nb = float(torch.linalg.vector_norm(torch.where(fm, b2, 0.0)))
    out["rel"] = r / nb
    check(r < 1e-6 * nb, f"P2TwoGridCL nx={P2TG_NX}: r {r} vs ||b|| {nb}")
    out["pinv_smoother"] = tg.smoother.block_stats.get("pinv")
    out["peak_gib"] = peak_gib(dev)
    return out


def _mesh_of(T, et, n):
    if et in ("trig", "quad"):
        return T.MakeStructured2DMesh(quads=et == "quad", nx=n, ny=n)
    return T.MakeStructured3DMesh(hexes=et == "hex", nx=n, ny=n, nz=n)


def _ball(T, dim, r=0.3):
    d2 = (T.x - 0.5) ** 2 + (T.y - 0.5) ** 2
    if dim == 3:
        d2 = d2 + (T.z - 0.5) ** 2
    return T.sqrt(d2) - r


def _cut_volume(T, mesh, dev, r=0.3):
    lset = T.GridFunction(T.H1(mesh, order=1, device=dev))
    T.InterpolateToP1(_ball(T, mesh.dim, r), lset)
    return T.Integrate({"levelset": lset, "domain_type": T.NEG}, 1.0, mesh,
                       order=2)


def refine_card(T, dev):
    """Uniform ``Refine()`` of trig, tet, quad and hex meshes (host
    seconds; over HOST_CAP_S reported), the measure kept to 1e-12 on the
    card, a cut volume card == CPU to 1e-12."""
    rows = []
    for et, n in REFINE_CASES:
        mesh = _mesh_of(T, et, n)
        ne0 = mesh.ne
        t0 = time.perf_counter()
        mesh.Refine()
        secs = time.perf_counter() - t0
        vol = T.Integrate(cf=1.0, mesh=mesh, order=2, device=dev)
        check(abs(vol - 1.0) < 1e-12, f"Refine {et} nx={n}: measure {vol}")
        a, b = _cut_volume(T, mesh, dev), _cut_volume(T, mesh, "cpu")
        check(abs(a - b) <= INTEGRATE_TOL * abs(b),
              f"Refine {et} nx={n}: card {a} vs CPU {b}")
        rows.append({"et": et, "nx": n, "ne0": ne0, "ne": mesh.ne,
                     "nv": mesh.nv, "s": secs, "vol": vol, "cut": a,
                     "over_cap": secs > HOST_CAP_S})
    return rows


def refine_at_levelset_card(T, dev):
    """The adaptive loop RefineAtLevelSet + Refine in 2D and 3D (the ball
    r=0.3): per level the NEG volume on the card == the CPU's to 1e-12, the
    marks and elements; the error falls."""
    rows = []
    for et, n, levels in LSREF_CASES:
        mesh = _mesh_of(T, et, n)
        exact = math.pi * 0.09 if et == "trig" else 4 / 3 * math.pi * 0.027
        errs, nes, marks, secs = [], [], [], []
        for _ in range(levels):
            lset = T.GridFunction(T.H1(mesh, order=1, device=dev))
            T.InterpolateToP1(_ball(T, mesh.dim), lset)
            a = T.Integrate({"levelset": lset, "domain_type": T.NEG}, 1.0,
                            mesh, order=2)
            b = _cut_volume(T, mesh, "cpu")
            check(abs(a - b) <= INTEGRATE_TOL * abs(b),
                  f"RefineAtLevelSet {et}: card {a} vs CPU {b}")
            errs.append(abs(a - exact))
            nes.append(mesh.ne)
            marks.append(T.RefineAtLevelSet(lset).NumSet())
            t0 = time.perf_counter()
            mesh.Refine()
            secs.append(time.perf_counter() - t0)
        check(errs[-1] < errs[0] / 2, f"RefineAtLevelSet {et}: errors {errs}")
        rows.append({"et": et, "nx": n, "errs": errs, "nes": nes,
                     "marks": marks, "s": secs, "ne": mesh.ne})
    return rows


def unstructured_card(T, dev):
    """``examples.unstructured_nxfem`` on a Delaunay mesh refined once to
    ~100k trigs: MakeUnstructuredMesh, Refine and to_ell on the host clock,
    the default ``Inverse()`` solve by CUDA events, its path, products and
    B2 launches; the example
    at its own size card == CPU to 1e-8, through a Gmsh file equal; a Gmsh
    round trip of the big mesh, its measure on the card."""
    import tempfile

    from ngsxfem_tpu_torch.examples import cutfem, unstructured_nxfem
    from ngsxfem_tpu_torch.solvers import ell_spmv
    from ngsxfem_tpu_torch.solvers.sparse import InverseMatrix, SparseMatrix

    out = {}
    t0 = time.perf_counter()
    mesh = unstructured_nxfem.make_mesh(npts=UNSTR_NPTS, seed=5,
                                        mesher="delaunay")
    out["delaunay_s"] = time.perf_counter() - t0
    out["ne0"] = mesh.ne
    t0 = time.perf_counter()
    mesh.Refine()
    out["refine_s"] = time.perf_counter() - t0
    out["ne"], out["nv"] = mesh.ne, mesh.nv
    sync(dev)
    peak_gib(dev)
    l0 = ell_spmv.launches
    t0 = time.perf_counter()
    with timed_calls(SparseMatrix, "to_ell", dev) as te, \
            timed_calls(InverseMatrix, "solve", dev, events=True) as ts, \
            counted_products("cg") as cp:
        err = cutfem.run(order=1, verbose=False, mesh=mesh, device=dev)
    sync(dev)
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = ell_spmv.launches - l0
    out["err"] = err
    out["to_ell_s"] = sum(te.seconds)
    out["solve_s"] = sum(ts.seconds)
    out["path"] = ts.objs[0].path
    out["products"], out["iters"] = cp.products, cp.iters
    out["peak_gib"] = peak_gib(dev)
    if dev.type == "cuda":
        check(out["path"] == "device_cg" and out["launches"] == cp.products,
              f"unstructured_nxfem: path {out['path']}, {out['launches']} "
              f"launches for {cp.products} products")
    check(err < 0.06, f"unstructured_nxfem ~100k trigs: L2 {err}")
    a, b = (unstructured_nxfem.run(mesher="delaunay",
                                   npts=UNSTR_PARITY_NPTS, verbose=False,
                                   device=d) for d in (dev, "cpu"))
    check(abs(a - b) <= PARITY_TOL * b, f"unstructured_nxfem card {a} CPU {b}")
    g = unstructured_nxfem.run(mesher="delaunay", npts=UNSTR_PARITY_NPTS,
                               via_gmsh=True, verbose=False, device=dev)
    # the same mesh (a Gmsh file keeps every bit), the same bits
    check(g == a, f"unstructured_nxfem through Gmsh {g} vs {a}")
    out["small"], out["gmsh_err"] = (a, b), g
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "big.msh")
        t0 = time.perf_counter()
        T.WriteGmsh(mesh, path)
        back = T.ReadGmsh(path)
        out["gmsh_s"] = time.perf_counter() - t0
    for attr in ("vertices_np", "elements_np", "bc_of_facet_np"):
        check(np.array_equal(getattr(back, attr), getattr(mesh, attr)),
              f"Gmsh round trip: {attr}")
    vol = T.Integrate(cf=1.0, mesh=back, order=1, device=dev)
    check(abs(vol - 9.0) < 1e-11, f"Gmsh round trip measure {vol}")
    return out


def quad_fictdom(T, dev, nx):
    """tests/test_composite.py's fictitious-domain solve on a
    ``MakeQuadDominated2DMesh`` (nx x nx, trig band 0.5; the disc r=0.35,
    Nitsche on the interface): the ``CompositeBilinearForm``, the
    ``CompositeLinearForm``, the active vertices and the default
    ``Inverse()`` solution."""
    cm = T.MakeQuadDominated2DMesh(nx=nx, ny=nx, trig_band=0.5)
    lset = T.CompositeGridFunction(cm, device=dev).Set(
        T.sqrt((T.x - 0.5) ** 2 + (T.y - 0.5) ** 2) - 0.35)
    hasneg = T.CompositeCutInfo(cm, lset).per_group(T.HASNEG)
    space = T.CompositeGridFunction(cm, device=dev)

    def make_a(V, k):
        u, v = V.TnT()
        g = lset.gfs[k]
        nl = 1.0 / T.Norm(T.grad(g)) * T.grad(g)
        a = T.BilinearForm(V)
        a += T.SymbolicBFI({"levelset": g, "domain_type": T.NEG},
                           form=T.grad(u) * T.grad(v),
                           definedonelements=hasneg[k])
        a += T.SymbolicBFI({"levelset": g, "domain_type": T.IF},
                           form=-(T.grad(u) * nl) * v - (T.grad(v) * nl) * u
                           + 40.0 / T.specialcf.mesh_size * u * v)
        return a

    def make_f(V, k):
        f = T.LinearForm(V)
        f += T.SymbolicLFI({"levelset": lset.gfs[k], "domain_type": T.NEG},
                           form=V.TnT()[1], definedonelements=hasneg[k])
        return f

    A = T.CompositeBilinearForm(space, make_a).Assemble()
    F = T.CompositeLinearForm(space, make_f).Assemble()
    act = np.zeros(cm.nv, dtype=bool)
    for k, m in enumerate(cm.submeshes):
        act[m.elements_np[np.asarray(hasneg[k].np)].ravel()] = True
    u = A.mat.Inverse(freedofs=T.BitArray(act)) * F.vec
    return cm, lset, A, F, act, u


def composite_card(T, dev):
    """The composite meshes on the card: ``IntegrateC`` (the measure, the
    disc) card == CPU to 1e-12; the quad-dominated fictitious-domain solve
    card == CPU to 1e-8 at nx=12 and at nx=COMPOSITE_NX on the card with
    its sanity limits, where a second ``CompositeBilinearForm``,
    ``CompositeLinearForm``, COO product and solve give the same bits."""
    out = {}
    for nx in (12, COMPOSITE_NX):
        t0 = time.perf_counter()
        cm, lset, A, F, act, u = quad_fictdom(T, dev, nx)
        sync(dev)
        out[nx] = {"s": time.perf_counter() - t0, "nv": cm.nv,
                   "groups": [m.ne for m in cm.submeshes],
                   "active": int(act.sum())}
        _, lset_c, _, F_c, _, u_c = quad_fictdom(T, "cpu", nx)
        rel = float((u.cpu() - u_c).abs().max() / u_c.abs().max())
        check(rel <= PARITY_TOL, f"composite fictdom nx={nx}: card vs CPU "
              f"{rel}")
        df = float((F.vec.data.cpu() - F_c.vec.data).abs().max())
        check(df <= INTEGRATE_TOL, f"composite load nx={nx}: card vs CPU {df}")
        ints = []
        for ls, d in ((lset, dev), (lset_c, "cpu")):
            ints.append([T.IntegrateC(None, 1.0, cm, order=2, device=d)] + [
                T.IntegrateC({"levelset": ls, "domain_type": dt}, 1.0, cm,
                             order=2) for dt in (T.NEG, T.IF)])
        worst = max(abs(a - b) for a, b in zip(*ints))
        check(worst <= INTEGRATE_TOL and abs(ints[0][0] - 1.0) < 1e-13,
              f"IntegrateC nx={nx}: card {ints[0]} CPU {ints[1]}")
        out[nx].update(rel=rel, load=df, ints=ints[0], worst=worst)
    r = np.linalg.norm(cm.vertices_np - 0.5, axis=1)
    uc = u.cpu().numpy()
    out["center"] = float(uc[np.argmin(r)])
    out["ring"] = float(np.abs(uc[act & (np.abs(r - 0.35) < 0.05)]).max())
    check(abs(out["center"] - 0.35 ** 2 / 4) < 5e-3 and out["ring"] < 2e-2,
          f"composite fictdom nx={COMPOSITE_NX}: centre {out['center']}, "
          f"ring {out['ring']}")
    vals, vec = A.mat.vals.clone(), F.vec.data.clone()
    y = A.mat * u
    check(torch.equal(A.Assemble().mat.vals, vals)
          and torch.equal(F.Assemble().vec.data, vec)
          and torch.equal(A.mat * u, y)
          and torch.equal(A.mat.Inverse(freedofs=T.BitArray(act)) * F.vec, u),
          f"composite nx={COMPOSITE_NX}: a second assembly, product or "
          f"solve differs from the first")
    return out


def geometry_examples(T, dev):
    """``integrate_curved`` (both demos) and ``lsetgeoms`` at their own
    sizes on the card and on the CPU: errors card == CPU to 1e-12
    (integrals), distances to 1e-8 (Newton-projected deformations)."""
    from ngsxfem_tpu_torch.examples import integrate_curved, lsetgeoms

    res = []
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res.append((integrate_curved.run_curved(verbose=False, device=d),
                        integrate_curved.run_quads(verbose=False, device=d),
                        lsetgeoms.run(verbose=False, device=d),
                        time.perf_counter() - t0))
    ((unc, cur), quads, geoms, wall), ((unc_c, cur_c), quads_c, geoms_c,
                                       wall_c) = res
    worst = 0.0
    for a, b in ((unc, unc_c), (cur, cur_c), (quads, quads_c)):
        for k in a:
            worst = max(worst, float(np.abs(np.subtract(a[k], b[k])).max()))
    check(worst <= INTEGRATE_TOL, f"integrate_curved card vs CPU {worst}")
    gworst = max(float(np.abs(np.subtract(geoms[g][0], geoms_c[g][0])).max()
                       / max(geoms_c[g][0])) for g in geoms)
    check(gworst <= PARITY_TOL, f"lsetgeoms card vs CPU {gworst}")
    for g, (dist, eoc) in geoms.items():
        check(dist[-1] < dist[0], f"lsetgeoms {g}: distances {dist}")
    return {"uncurved": unc, "curved": cur, "quads": quads, "geoms": geoms,
            "wall": wall, "wall_cpu": wall_c, "worst": worst,
            "gworst": gworst}


def phases_24_25(T, dev, t_start):
    """Phases 24 (the general cut multigrid at card size, P2TwoGridCL, card
    against CPU at the JAX tests' sizes) and 25 (meshing and refinement),
    each with the launch counters reset just before it.  Returns (ell_spmv
    launches of phase 24, of phase 25, B2's records on phase 24's transfer
    tables)."""
    from ngsxfem_tpu_torch.solvers import dia_cg, ell_spmv

    sync(dev)
    dia_cg.launches = 0
    ell_spmv.launches = 0
    t0 = time.perf_counter()
    tables = []
    for dim, nx0, levels in CUTMG_BIG:
        r = cutmg_card(T, dev, dim, nx0, levels)
        s = r["setup"]
        print(f"[24 cutmg] {card()} | {r['label']}: {r['ndof']} dofs "
              f"({r['nfree']} free), {r['if_rows']} interface rows on the "
              f"fine level; host setup s: meshes {s['meshes']:.2f}, levels "
              f"{', '.join(f'{x:.2f}' for x in s['levels'])}, prolongations "
              f"{s['prolongations']:.2f}, to_ell {s['to_ell']:.2f}, "
              f"smoothers (interface blocks) {s['smoothers']:.2f}, "
              f"MultiGridCL (coarse factor, views) {s['multigrid']:.2f}; "
              f"MG-CG {r['it_mg']} iterations {r['mg_ms']:.2f} ms "
              f"({_prof_line(r['mg_prof'])}); Jacobi-CG {r['it_j']} "
              f"iterations {r['j_ms']:.2f} ms ({_prof_line(r['j_prof'])}); "
              f"|x_mg - x_j| {r['diff']:.3e}; one MG-CG solve: "
              f"{r['products']} ELL products = {r['launches']} ell_spmv "
              f"launches; second solve bitwise equal; peak memory "
              f"{r['peak_gib']:.2f} GiB; wall {r['wall_s']:.2f} s",
              flush=True)
        for b2 in r["tables"]:
            tables.append(dict(b2_record(b2), launches=r["launches"]))
            print(f"[24 B2] {b2['label']} ({b2['n']} x {b2['K']} "
                  f"{b2['dtype']}): kernel == plain bitwise (max|dy| "
                  f"{b2['err']:.3e}), {b2_text(b2)}", flush=True)
    tg = p2twogrid_card(T, dev)
    print(f"[24 P2TwoGridCL] {card()} | P2 nx={P2TG_NX} ({tg['ndof']} dofs): "
          f"{tg['nb']} edge patches, K={tg['K']}, pinv for {tg['pinv']} "
          f"blocks (smoother: {tg['pinv_smoother']}); EdgePatches "
          f"{tg['patches_s']:.2f} s (host), batched block setup "
          f"{tg['blocks_ms']:.1f} ms; P2TwoGridCL setup {tg['setup_s']:.2f} "
          f"s; P1 coarse Inverse() {tg['coarse_path']}; Mult {tg['iters']} "
          f"iterations, {tg['mult_ms']:.1f} ms, {tg['launches']} ell_spmv "
          f"launches, r/||b|| {tg['rel']:.3e}; system build "
          f"{tg['system_s']:.2f} s; peak memory {tg['peak_gib']:.2f} GiB",
          flush=True)
    par = cutmg_parity(T, dev)
    print("[24 parity] cutmg card (CPU): " + "; ".join(
        f"{dim}D nx0={nx0} levels={lv}: MG-CG {a[0]} ({b[0]}) iterations, "
        f"Jacobi-CG {a[1]} ({b[1]}), solutions rel {rel:.2e}"
        for dim, nx0, lv, a, b, rel in par)
          + "; card solves repeat bit for bit", flush=True)
    mg_launches = ell_spmv.launches
    check(mg_launches > 0 or dev.type != "cuda",
          "the cut-multigrid path launched ell_spmv no time")
    print(f"[24 launches] ell_spmv {mg_launches}, dia_cg {dia_cg.launches}; "
          f"wall of phase 24 {time.perf_counter() - t0:.2f} s", flush=True)

    sync(dev)
    dia_cg.launches = 0
    ell_spmv.launches = 0
    t0 = time.perf_counter()
    for r in refine_card(T, dev):
        print(f"[25 refine] {r['et']} nx={r['nx']}: {r['ne0']} -> {r['ne']} "
              f"elements ({r['nv']} vertices) in {r['s']:.2f} s (host"
              + (f", over the {HOST_CAP_S:.0f} s cap" if r["over_cap"]
                 else "") + f"); measure {r['vol']:.15f}; cut volume card "
              f"== CPU {r['cut']:.15f}", flush=True)
    for r in refine_at_levelset_card(T, dev):
        print(f"[25 RefineAtLevelSet] {r['et']} nx={r['nx']}: elements "
              f"{r['nes']} -> {r['ne']}, marked {r['marks']}, NEG volume "
              f"errors {', '.join(f'{e:.3e}' for e in r['errs'])} (card == "
              f"CPU), Refine s {', '.join(f'{s:.2f}' for s in r['s'])}",
              flush=True)
    u = unstructured_card(T, dev)
    print(f"[25 unstructured] {card()} | MakeUnstructuredMesh (Delaunay, "
          f"{UNSTR_NPTS} points) {u['ne0']} trigs in {u['delaunay_s']:.2f} s, "
          f"Refine() -> {u['ne']} trigs ({u['nv']} vertices) in "
          f"{u['refine_s']:.2f} s (host); examples.cutfem on it: L2 "
          f"{u['err']:.6e}, to_ell {u['to_ell_s']:.2f} s ({ran_on(dev)}), "
          f"default "
          f"Inverse() {u['path']}: {u['iters']} iterations, {u['products']} "
          f"products, {u['launches']} ell_spmv launches, solve "
          f"{u['solve_s'] * 1e3:.1f} ms (events); wall {u['wall_s']:.2f} s; peak "
          f"memory {u['peak_gib']:.2f} GiB; npts={UNSTR_PARITY_NPTS} L2 card "
          f"{u['small'][0]:.12e} CPU {u['small'][1]:.12e}, through a Gmsh "
          f"file {u['gmsh_err']:.12e}; Gmsh round trip of the big mesh {u['gmsh_s']:.2f} s, "
          f"arrays equal, measure 9 on the card", flush=True)
    c = composite_card(T, dev)
    print(f"[25 composite] quad-dominated fictitious domain: " + "; ".join(
        f"nx={nx}: {c[nx]['nv']} vertices, groups {c[nx]['groups']} "
        f"elements, {c[nx]['active']} active, built and solved in "
        f"{c[nx]['s']:.2f} s, solution card == CPU rel {c[nx]['rel']:.1e}, "
        f"load {c[nx]['load']:.1e}, IntegrateC measure/NEG/IF "
        f"{', '.join(f'{v:.15f}' for v in c[nx]['ints'])} (card == CPU "
        f"{c[nx]['worst']:.1e})" for nx in (12, COMPOSITE_NX))
          + f"; centre {c['center']:.6f} (r^2/4 {0.35 ** 2 / 4:.6f}), ring "
          f"max {c['ring']:.2e}; second bilinear and linear assembly, COO "
          f"product and solve bitwise equal", flush=True)
    g = geometry_examples(T, dev)
    print(f"[25 geometry] integrate_curved (order 5, nx0=8, 4 levels): "
          f"uncurved IF errors {[f'{e:.3e}' for e in g['uncurved'][T.IF]]}, "
          f"curved {[f'{e:.3e}' for e in g['curved'][T.IF]]}; quads NEG "
          f"{[f'{e:.3e}' for e in g['quads'][T.NEG]]}; lsetgeoms "
          + ", ".join(f"{k} {[f'{d:.3e}' for d in v[0]]}"
                      for k, v in g["geoms"].items())
          + f"; card == CPU (integrals {g['worst']:.1e}, distances rel "
          f"{g['gworst']:.1e}); wall card {g['wall']:.2f} s, CPU "
          f"{g['wall_cpu']:.2f} s", flush=True)
    mesh_launches = ell_spmv.launches
    check(mesh_launches > 0 or dev.type != "cuda",
          "the meshing path launched ell_spmv no time")
    print(f"[25 launches] ell_spmv {mesh_launches}, dia_cg {dia_cg.launches}; "
          f"wall of phase 25 {time.perf_counter() - t0:.2f} s, of the whole "
          f"run {time.perf_counter() - t_start:.2f} s", flush=True)
    return mg_launches, mesh_launches, tables


# --- phases 26-27: differentiable cut FEM; periodic spaces, materials and
# utilities ------------------------------------------------------------------

AD_NX = 48               # the flagship compliance J(r) = b^T x, f64
# the fixed PCG budget of both paths, its own constant.  The budget scan
# (tools/torch_ad_budget.py, NVIDIA H100 80GB HBM3, 700.00 W) read lattice
# vs general, rel in J / in dJ/dr:
#   PCG-20  1.2e-13 / 1.4e-11     PCG-50   2.4e-8 / 1.9e-6
#   PCG-80  5.5e-9  / 1.5e-6      PCG-120  1.7e-13 / 1.0e-10
# tests/test_ad_fastpath.py's 80 steps nearly converge at NX=8; at nx=48
# steps ~50-80 lie on the PCG's plateau, where rounding (the two paths sum
# their tables in different orders) grows past the paths' 1e-6 limit
AD_CG_ITERS = 120
# the JAX test's budget, on the plateau at nx=48: printed, not checked,
# beside the witness that its gap is rounding (one path against itself
# with its sums reordered, and with r moved by one ulp)
AD_PLATEAU_ITERS = 80
AD_FD_EPS = 1e-6         # central difference step at NX=8 (the JAX test's)
AD_FD_TOL = 1e-5         # autograd vs central difference (the JAX test's)
AD_PATH_TOL = 1e-6       # lattice vs general path (the JAX test's)
AD_PARITY_TOL = 1e-10    # levelset_shape_opt card vs CPU
SHAPE_NX = 1024          # levelset_shape_opt.run on the card: 2,097,152 trigs
SHAPE_PARITY_NX = 32     # the JAX tests' size of make_area_fn / run
COMP_PARITY_NX = 10      # the JAX tests' size of compliance_sensitivity
# compliance_sensitivity against a central difference (1e-7): the example
# has no ghost penalty, so past nx=64 its cut system's conditioning puts the
# solves' 1e-12 residual into the difference (2e-4 apart at nx=128 on the
# CPU); the gradient alone runs at COMP_BIG_NX
COMP_FD_NX = 64
COMP_BIG_NX = 128
COMP_FD_TOL = 1e-7
PER_NX = (256, 512)      # Periodic(H1), -u'' + u = cos(2 pi x): ~262k dofs
PER_PARITY_NX = 16       # tests/test_misc.py's size
PER_DECAY = 3.2          # error falling per halving of h (test_misc's bound)


def _gap_midpoint(vd, r):
    """The midpoint between the two vertex distances bracketing r (the JAX
    test's choice: one sign pattern for the gradient and the difference,
    no tie of a clamp or of eps_guard)."""
    vds = np.unique(vd)
    i = int(np.searchsorted(vds, r))
    return float(0.5 * (vds[i - 1] + vds[i])), float(vds[i] - vds[i - 1])


def b2_backward(label, A, device):
    """Kernel B2 under autograd (``ELLMatrix.matvec`` -> ``EllMatvec``) on
    the table of ``A`` with a seeded x and a seeded output gradient: one
    forward and one transposed launch per product; the backward's
    ``A^T g`` bitwise equal to ``sell_matvec_plain`` on the transposed
    table's layout, ``grad_vals`` bitwise equal to ``g[r] * x[cols]``, the
    transposed table the transpose (<g, A x> = <A^T g, x> to 1e-12);
    ``b2_timed`` on the transposed table; one forward and backward by
    events.  Launches made for the timings are put back."""
    from ngsxfem_tpu_torch.solvers import ell_spmv
    from ngsxfem_tpu_torch.solvers.sparse import ELLMatrix

    rng = np.random.default_rng(2032)
    dt = A.vals.dtype
    vals = A.vals.detach().clone().requires_grad_()
    E = ELLMatrix(A.cols, vals, A.shape)
    x = torch.as_tensor(rng.standard_normal(A.shape[1]), dtype=dt,
                        device=device).requires_grad_()
    g = torch.as_tensor(rng.standard_normal(A.shape[0]), dtype=dt,
                        device=device)
    l0 = ell_spmv.launches
    y = E.matvec(x)
    y.backward(g)
    launches = ell_spmv.launches - l0
    check(launches == (2 if device.type == "cuda" else 0),
          f"{label}: {launches} ell_spmv launches for one forward and one "
          f"transposed product")
    check(type(y.grad_fn).__name__ == "EllMatvecBackward",
          f"{label}: the product under autograd is not EllMatvec")
    Et = E.transposed()
    with torch.no_grad():
        if device.type == "cuda":
            want = ell_spmv.sell_matvec_plain(Et.layout(), g)
        else:
            want = ell_spmv.ell_matvec_plain(Et.vals, Et.cols, g)
        check(torch.equal(x.grad, want),
              f"{label}: A^T g != the plain sum of the transposed table")
        check(torch.equal(vals.grad, g[:, None] * x.detach()[A.cols.long()]),
              f"{label}: grad_vals != g[r] * x[cols]")
        lhs = float(torch.dot(g, y.detach()))
        rhs = float(torch.dot(x.grad, x.detach()))
        check(abs(lhs - rhs) <= 1e-12 * (float(g.abs() @ (
            ell_spmv.ell_matvec_plain(vals.detach().abs(), A.cols,
                                      x.detach().abs())))),
              f"{label}: <g, A x> {lhs} != <A^T g, x> {rhs}")
    out = {"label": label, "n": A.shape[0], "ncols": A.shape[1],
           "K": int(A.cols.shape[1]), "KT": int(Et.cols.shape[1]),
           "launches": launches}
    if device.type == "cuda":
        counts = ell_spmv.launches, ell_spmv.layouts_built

        def fb():
            xx = x.detach().requires_grad_()
            E.matvec(xx).backward(g)
            return xx.grad

        fb()
        _, out["fb_ms"] = event_ms(fb)
        out["b2"] = b2_timed(f"{label} transposed", Et, g)
        out["b2"]["err"] = float((x.grad - want).abs().max())
        ell_spmv.launches, ell_spmv.layouts_built = counts
    return out


def ad_r0(model):
    """r0 of the compliance at 0.4 (``_gap_midpoint``) and its vertex gap."""
    return _gap_midpoint(
        np.sqrt(((model.mesh.vertices_np - 0.5) ** 2).sum(1)), 0.4)


def compliance_fns(model, dst, st, iters, dev, k_order=None):
    """tests/test_ad_fastpath.py's compliance J(r) = b^T x in f64 through
    an ``iters``-step Jacobi-PCG, as two functions of r: the lattice
    assembly + ``dia_matvec`` + unrolled ``krylov.cg``, and
    ``assemble_vals_soa1`` + ``ELLMatrix`` products (B2 forward and
    transposed under autograd) + the same PCG.  ``k_order`` permutes the
    slots of every ELL row: the same matrix, its sums taken in another
    order."""
    from ngsxfem_tpu_torch.solvers.krylov import cg
    from ngsxfem_tpu_torch.solvers.sparse import ELLMatrix, dia_matvec

    tvd = torch.as_tensor(
        np.sqrt(((model.mesh.vertices_np - 0.5) ** 2).sum(1)), device=dev)
    offs = dst["offsets"]
    k0 = int(np.searchsorted(offs, 0))
    act = model.active_dofs
    b_dia = torch.as_tensor(np.where(act[dst["perm_inv"]], 1.0, 0.0),
                            device=dev)
    b_dof = torch.as_tensor(np.where(act, 1.0, 0.0), device=dev)
    cols = torch.as_tensor(st["ell_cols"], device=dev)
    if k_order is not None:
        cols = cols[:, k_order].contiguous()

    def lattice(r):
        V, _ = model.assemble_vals_lattice(model.vertices, tvd - r, dst)
        dinv = torch.where(V[k0].abs() > 1e-30, 1.0 / V[k0], 1.0)
        x, _, _ = cg(lambda z: dia_matvec(offs, V, z), b_dia,
                     M=lambda w: dinv * w, maxiter=iters, tol=0.0)
        return torch.dot(b_dia, x)

    def general(r):
        vals, _ = model.assemble_vals_soa1(model.vertices, tvd - r, st)
        if k_order is not None:
            vals = vals[:, k_order].contiguous()
        A = ELLMatrix(cols, vals, (model.ndof, model.ndof))
        d = A.diagonal()
        dinv = torch.where(d.abs() > 1e-30, 1.0 / d, 1.0)
        x, _, _ = cg(A.matvec, b_dof, M=lambda w: dinv * w, maxiter=iters,
                     tol=0.0)
        return torch.dot(b_dof, x)

    return lattice, general


def _value_and_grad(fn, r0, dev):
    r = torch.tensor(r0, dtype=torch.float64, device=dev, requires_grad=True)
    J = fn(r)
    (g,) = torch.autograd.grad(J, r)
    return float(J.detach()), float(g)


def ad_compliance(T, dev, model, dst, st):
    """The compliance of ``compliance_fns`` at nx=AD_NX through the
    AD_CG_ITERS-step PCG both ways.  dJ/dr by autograd against a central
    difference on the card (AD_FD_TOL) and the two paths against each
    other (AD_PATH_TOL); forward and backward ms by events, peak memory, B2
    launches against the products; the general path's device kernels and
    idle share.  Then the rounding witness, at AD_PLATEAU_ITERS (printed,
    not checked) and at AD_CG_ITERS (the general path within AD_PATH_TOL
    of itself): both paths, and the general path with its ELL rows' slots
    in a seeded order and with r moved by one ulp."""
    from ngsxfem_tpu_torch.solvers import dia_spmv, ell_spmv

    r0, gap = ad_r0(model)
    lattice, general = compliance_fns(model, dst, st, AD_CG_ITERS, dev)
    out = {"r0": r0, "gap": gap}
    for name, fn in (("lattice", lattice), ("general", general)):
        sync(dev)
        peak_gib(dev)
        l0, d0 = ell_spmv.launches, dia_spmv.launches
        r = torch.tensor(r0, dtype=torch.float64, device=dev,
                         requires_grad=True)
        with counted_ell() as c:
            J, fwd_ms = event_ms(lambda: fn(r))
            (g,), bwd_ms = event_ms(lambda: torch.autograd.grad(J, r))
        out[name] = {"J": float(J.detach()), "grad": float(g),
                     "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
                     "peak_gib": peak_gib(dev), "products": c.calls,
                     "launches": ell_spmv.launches - l0,
                     "dia_launches": dia_spmv.launches - d0}
        check(math.isfinite(float(g)) and float(g) != 0.0,
              f"AD {name}: gradient {float(g)}")
        check(out[name]["launches"] == (c.calls if dev.type == "cuda"
                                        else 0),
              f"AD {name}: {out[name]['launches']} ell_spmv launches for "
              f"{c.calls} ELL products")
    # one forward product per CG step and the initial residual's, one
    # transposed product per step (x0 = 0 needs none)
    check(out["general"]["products"] == 2 * AD_CG_ITERS + 1,
          f"AD general: {out['general']['products']} ELL products, not one "
          f"forward and one transposed per CG product")
    # the lattice path's DIA products likewise, each a launch of dia_spmv
    # (dia_spmv.DiaMatvec) on the card
    want = 2 * AD_CG_ITERS + 1 if dev.type == "cuda" else 0
    check(out["lattice"]["dia_launches"] == want,
          f"AD lattice: {out['lattice']['dia_launches']} dia_spmv launches, "
          f"not {want}")
    # the central difference errs by its eps^2 J'''(r) / 6 term, and J'''
    # grows with the resolution of the cut (at nx=48 the JAX test's step
    # 1e-6 leaves 6e-6 of it, a quarter at half the step,
    # tools/torch_ad_budget.py): the step is the JAX test's scaled by h
    eps = out["fd_eps"] = AD_FD_EPS * 8 / model.nx
    t0 = time.perf_counter()
    with torch.no_grad():
        fd = out["fd"] = (float(lattice(r0 + eps))
                          - float(lattice(r0 - eps))) / (2 * eps)
    out["fd_s"] = time.perf_counter() - t0
    gl, gg = out["lattice"]["grad"], out["general"]["grad"]
    out["rel_fd"] = abs(gl - fd) / abs(fd)
    out["rel_paths"] = abs(gl - gg) / abs(gg)
    check(out["rel_fd"] <= AD_FD_TOL, f"AD lattice {gl} vs FD {fd}")
    check(out["rel_paths"] <= AD_PATH_TOL, f"AD lattice {gl} vs general {gg}")
    check(abs(out["lattice"]["J"] - out["general"]["J"])
          <= 1e-9 * abs(out["general"]["J"]),
          f"AD J lattice {out['lattice']['J']} vs general "
          f"{out['general']['J']}")
    if dev.type == "cuda":
        def fb():
            r = torch.tensor(r0, dtype=torch.float64, device=dev,
                             requires_grad=True)
            return torch.autograd.grad(general(r), r)

        counts = ell_spmv.launches
        t0 = time.perf_counter()
        nk, busy, wall = device_busy(fb)
        out["general_prof"] = (nk, busy, 1 - busy / wall, wall,
                               time.perf_counter() - t0)
        ell_spmv.launches = counts
    t0 = time.perf_counter()
    k_order = np.random.default_rng(2033).permutation(st["ell_cols"].shape[1])
    r_ulp = float(np.nextafter(r0, 1.0))
    wit = out["witness"] = {}
    for it in (AD_PLATEAU_ITERS, AD_CG_ITERS):
        lat, gen = compliance_fns(model, dst, st, it, dev)
        _, gen_perm = compliance_fns(model, dst, st, it, dev, k_order)
        row = wit[it] = {}
        if it == AD_CG_ITERS:
            row["lattice"] = (out["lattice"]["J"], gl)
            row["general"] = (out["general"]["J"], gg)
        else:
            row["lattice"] = _value_and_grad(lat, r0, dev)
            row["general"] = _value_and_grad(gen, r0, dev)
        row["slots"] = _value_and_grad(gen_perm, r0, dev)
        row["ulp"] = _value_and_grad(gen, r_ulp, dev)
        base = row["general"]
        row["rel"] = {k: tuple(abs(a - b) / abs(b)
                               for a, b in zip(row[k], base))
                      for k in ("lattice", "slots", "ulp")}
    for k in ("slots", "ulp"):
        check(wit[AD_CG_ITERS]["rel"][k][1] <= AD_PATH_TOL,
              f"AD general PCG-{AD_CG_ITERS} vs itself ({k}): dJ/dr rel "
              f"{wit[AD_CG_ITERS]['rel'][k][1]:.3e}")
    out["witness_s"] = time.perf_counter() - t0
    return out


def shape_opt_card(dev):
    """examples.levelset_shape_opt: ``run`` at SHAPE_NX on the card (final
    area to 1e-10, r within the JAX test's 2e-3 scaled by h^2), the
    compliance gradient through ``krylov.cg_implicit`` (B2 in both solves)
    against a central difference at COMP_FD_NX (COMP_FD_TOL) and at
    COMP_BIG_NX with its time and launches; card against CPU at the JAX
    tests' sizes (AD_PARITY_TOL)."""
    from ngsxfem_tpu_torch.examples import levelset_shape_opt as ex
    from ngsxfem_tpu_torch.solvers import ell_spmv

    out = {}
    sync(dev)
    peak_gib(dev)
    t0 = time.perf_counter()
    out["r"], out["area"] = ex.run(nx=SHAPE_NX, verbose=False, device=dev)
    sync(dev)
    out["run_s"] = time.perf_counter() - t0
    out["run_peak"] = peak_gib(dev)
    r_exact = math.sqrt(0.25 / math.pi)
    out["r_err"] = abs(out["r"] - r_exact)
    check(abs(out["area"] - 0.25) < 1e-10,
          f"levelset_shape_opt nx={SHAPE_NX}: area {out['area']}")
    check(out["r_err"] < 2e-3 * (32 / SHAPE_NX) ** 2,
          f"levelset_shape_opt nx={SHAPE_NX}: r off by {out['r_err']}")

    def grad_of(comp, r0, d):
        r = torch.tensor(r0, dtype=torch.float64, device=d,
                         requires_grad=True)
        c = comp(r)
        (g,) = torch.autograd.grad(c, r)
        return float(c.detach()), float(g)

    for nx in (COMP_FD_NX, COMP_BIG_NX):
        m = np.linspace(0.0, 1.0, nx + 1)
        X, Y = np.meshgrid(m, m)
        r0, _ = _gap_midpoint(np.sqrt((X - 0.5) ** 2 + (Y - 0.5) ** 2), 0.33)
        comp = ex.compliance_sensitivity(nx=nx, device=dev)
        l0 = ell_spmv.launches
        with counted_ell() as c:
            (cval, g), ms = event_ms(lambda: grad_of(comp, r0, dev))
        row = {"nx": nx, "r0": r0, "J": cval, "grad": g, "ms": ms,
               "products": c.calls, "launches": ell_spmv.launches - l0}
        check(row["launches"] == (c.calls if dev.type == "cuda" else 0),
              f"compliance_sensitivity nx={nx}: {row['launches']} launches "
              f"for {c.calls} ELL products")
        if nx == COMP_FD_NX:
            with torch.no_grad():
                eps = AD_FD_EPS
                row["fd"] = (float(comp(r0 + eps))
                             - float(comp(r0 - eps))) / (2 * eps)
            row["rel_fd"] = abs(g - row["fd"]) / abs(row["fd"])
            check(row["rel_fd"] <= COMP_FD_TOL,
                  f"compliance_sensitivity nx={nx}: {g} vs FD {row['fd']}")
        out[f"comp{nx}"] = row

    par = {}
    for d in (dev, torch.device("cpu")):
        area = ex.make_area_fn(nx=SHAPE_PARITY_NX, device=d)
        r = torch.tensor(0.31, dtype=torch.float64, device=d,
                         requires_grad=True)
        a = area(r)
        (ga,) = torch.autograd.grad(a, r)
        comp = ex.compliance_sensitivity(nx=COMP_PARITY_NX, device=d)
        par[d.type] = (float(a.detach()), float(ga),
                       ex.run(nx=SHAPE_PARITY_NX, verbose=False,
                              device=d)[0],
                       *grad_of(comp, 0.33, d))
    worst = max(abs(a - b) / max(abs(b), 1e-300)
                for a, b in zip(par[dev.type], par["cpu"]))
    check(worst <= AD_PARITY_TOL,
          f"levelset_shape_opt card {par[dev.type]} vs CPU {par['cpu']}")
    out["parity"], out["parity_worst"] = par[dev.type], worst
    return out


def phase_26(T, dev, model64, dst64, st64):
    """Phase 26, launch counters reset before it: B2 under autograd on the
    flagship ELL table (f64, symmetric) and on a non-symmetric table (the
    3D nx=24 -> 48 P1 prolongation), the flagship compliance gradient at
    nx=AD_NX both ways, and ``levelset_shape_opt`` at card size.  Returns
    (ell_spmv launches of the phase, B2's records on the transposed
    tables)."""
    from ngsxfem_tpu_torch.solvers import dia_cg, ell_spmv
    from ngsxfem_tpu_torch.solvers.mg import prolongation_matrix
    from ngsxfem_tpu_torch.solvers.sparse import ELLMatrix

    sync(dev)
    dia_cg.launches = 0
    ell_spmv.launches = 0
    t0 = time.perf_counter()
    vals48, _ = model64.assemble_vals_soa1(model64.vertices, model64.lset,
                                           st64)
    flag = ELLMatrix(torch.as_tensor(st64["ell_cols"], device=dev), vals48,
                     (model64.ndof, model64.ndof))
    nxf = model64.nx
    fine = T.H1(T.MakeStructured3DMesh(hexes=False, nx=nxf, ny=nxf, nz=nxf),
                order=1, device=dev)
    coarse = T.H1(T.MakeStructured3DMesh(hexes=False, nx=nxf // 2,
                                         ny=nxf // 2, nz=nxf // 2),
                  order=1, device=dev)
    prol = prolongation_matrix(coarse, fine, torch.float64,
                               device=dev).ell()
    tables = []
    for label, A in ((f"flagship ELL nx={nxf} f64", flag),
                     (f"P1 prolongation nx={nxf // 2}->{nxf} f64", prol)):
        b = b2_backward(label, A, dev)
        tables.append(b)
        if "b2" in b:
            print(f"[26 B2 autograd] {b['label']} ({b['n']} x {b['K']}, "
                  f"transposed {b['ncols']} x {b['KT']}): one forward and "
                  f"one transposed launch per product, A^T g == "
                  f"sell_matvec_plain of the transposed layout bit for bit, "
                  f"grad_vals == g[r] x[cols] bit for bit; forward + "
                  f"backward {b['fb_ms']:.3f} ms (events); the transposed "
                  f"table: {b2_text(b['b2'])}", flush=True)
    del flag, vals48, prol
    print(f"[26 B2 autograd] wall {time.perf_counter() - t0:.2f} s",
          flush=True)
    t1 = time.perf_counter()
    ad = ad_compliance(T, dev, model64, dst64, st64)
    ad["wall_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    for name in ("lattice", "general"):
        p = ad[name]
        print(f"[26 AD {name}] {card()} | compliance nx={AD_NX} f64, "
              f"PCG-{AD_CG_ITERS}, r0={ad['r0']:.12f} (vertex gap "
              f"{ad['gap']:.3e}): J {p['J']:.12e}, dJ/dr {p['grad']:.12e}; "
              f"forward {p['fwd_ms']:.1f} ms, backward {p['bwd_ms']:.1f} ms "
              f"(events); peak memory {p['peak_gib']:.2f} GiB; ELL products "
              f"{p['products']} = ell_spmv launches {p['launches']}; "
              f"dia_spmv launches {p['dia_launches']}", flush=True)
    print(f"[26 AD check] dJ/dr lattice vs central difference (eps "
          f"{ad['fd_eps']:.4g}, {ad['fd_s']:.2f} s) {ad['fd']:.12e}: rel "
          f"{ad['rel_fd']:.3e} <= {AD_FD_TOL:g}; lattice vs general rel "
          f"{ad['rel_paths']:.3e} <= "
          f"{AD_PATH_TOL:g}; general forward + backward under the "
          f"profiler: "
          + ("{} device kernels, busy {:.2f} ms of {:.2f} ms wall, idle "
             "share {:.3f} (the profile {:.2f} s)".format(
                 *ad["general_prof"][:2], ad["general_prof"][3],
                 ad["general_prof"][2], ad["general_prof"][4])
             if "general_prof" in ad else "not profiled")
          + f"; wall of the compliance {ad['wall_s']:.2f} s", flush=True)
    for it, row in ad["witness"].items():
        rel = row["rel"]
        print(f"[26 AD rounding] PCG-{it}"
              + (" (checked)" if it == AD_CG_ITERS else
                 " (the JAX test's budget, printed, not checked)")
              + f": general J {row['general'][0]:.15e}, dJ/dr "
              f"{row['general'][1]:.12e}; rel in J / in dJ/dr against it: "
              f"lattice {rel['lattice'][0]:.3e} / {rel['lattice'][1]:.3e}, "
              f"general with its ELL slots reordered {rel['slots'][0]:.3e} "
              f"/ {rel['slots'][1]:.3e}, general at r0 + 1 ulp "
              f"{rel['ulp'][0]:.3e} / {rel['ulp'][1]:.3e}", flush=True)
    print(f"[26 AD rounding] wall {ad['witness_s']:.2f} s", flush=True)
    so = shape_opt_card(dev)
    c64, c128 = so[f"comp{COMP_FD_NX}"], so[f"comp{COMP_BIG_NX}"]
    print(f"[26 levelset_shape_opt] {card()} | run nx={SHAPE_NX} "
          f"({2 * SHAPE_NX ** 2} trigs): r {so['r']:.12f} (exact - r "
          f"{so['r_err']:.3e}), area {so['area']:.15f}, {so['run_s']:.2f} s, "
          f"peak memory {so['run_peak']:.2f} GiB; compliance_sensitivity "
          f"(cg_implicit, B2 in both solves) nx={COMP_FD_NX}: dC/dr "
          f"{c64['grad']:.12e} vs FD {c64['fd']:.12e} rel "
          f"{c64['rel_fd']:.3e}, {c64['ms']:.1f} ms, {c64['products']} "
          f"products = {c64['launches']} launches; nx={COMP_BIG_NX}: dC/dr "
          f"{c128['grad']:.12e}, {c128['ms']:.1f} ms, {c128['products']} "
          f"products = {c128['launches']} launches; card == CPU at nx="
          f"{SHAPE_PARITY_NX}/{COMP_PARITY_NX} (rel "
          f"{so['parity_worst']:.1e}); "
          f"wall {time.perf_counter() - t1:.2f} s", flush=True)
    launches = ell_spmv.launches
    check(launches > 0 or dev.type != "cuda",
          "the autograd path launched ell_spmv no time")
    check(dia_cg.launches == 0, "the autograd path launched dia_cg")
    print(f"[26 launches] ell_spmv {launches}, dia_cg {dia_cg.launches}; "
          f"wall of phase 26 {time.perf_counter() - t0:.2f} s", flush=True)
    return launches, [dict(b2_record(b["b2"]), launches=b["launches"])
                      for b in tables if "b2" in b]


def periodic_solve(T, nx, dev):
    """tests/test_misc.py's periodic problem at nx: the solution, its L2
    error, the Inverse() object and the ELL products of its solve."""
    mesh = T.MakeStructured2DMesh(quads=False, nx=nx, ny=nx, periodic="x")
    P = T.Periodic(T.H1(mesh, order=1, device=dev))
    u, v = P.TnT()
    a = T.BilinearForm(P)
    a += T.SymbolicBFI(form=T.grad(u) * T.grad(v) + u * v)
    f = T.LinearForm(P)
    f += T.SymbolicLFI(form=T.cos(2 * np.pi * T.x) * v)
    a.Assemble()
    f.Assemble()
    gfu = T.GridFunction(P)
    inv = a.mat.Inverse()
    with counted_ell() as c:
        gfu.vec.data = inv * f.vec.data
    exact = T.cos(2 * np.pi * T.x) / (1 + 4 * np.pi ** 2)
    err = T.Integrate(cf=(gfu - exact) ** 2, mesh=mesh, order=6,
                      device=dev) ** 0.5
    return gfu, float(err), inv, c.calls, mesh


def phase_27(T, dev):
    """Phase 27, launch counters reset before it: ``Periodic(H1)`` solves at
    PER_NX through the default ``Inverse()`` (Jacobi-CG through B2 on the
    card, launches == products) with the error falling more than PER_DECAY
    per halving of h, under a ``Timer``; ``LevelSetMeshAdaptation(
    periodic=True)``, region-wise and ``definedon`` integrals, ``VTKOutput``
    of a card GridFunction; card == CPU at the tests' sizes (integrals 1e-12,
    solves and distances 1e-8).  Returns the ell_spmv launches."""
    import tempfile

    from ngsxfem_tpu_torch.solvers import dia_cg, ell_spmv
    from ngsxfem_tpu_torch.utils import timing

    sync(dev)
    dia_cg.launches = 0
    ell_spmv.launches = 0
    t0 = time.perf_counter()
    timing.ResetTimers()
    rows = []
    for nx in PER_NX:
        l0 = ell_spmv.launches
        with T.Timer(f"periodic nx={nx}"):
            gfu, err, inv, products, _ = periodic_solve(T, nx, dev)
        rows.append({"nx": nx, "ndof": gfu.space.ndof, "err": err,
                     "path": inv.path, "products": products,
                     "launches": ell_spmv.launches - l0,
                     "s": timing.GetTimers()[f"periodic nx={nx}"][0]})
        check(inv.path == ("device_cg" if dev.type == "cuda" else "host_lu")
              and rows[-1]["launches"] == (products if dev.type == "cuda"
                                           else 0),
              f"periodic nx={nx}: path {inv.path}, {rows[-1]['launches']} "
              f"launches for {products} products")
    check(rows[1]["err"] < rows[0]["err"] / PER_DECAY,
          f"periodic errors {[r['err'] for r in rows]}")
    par = {}
    with tempfile.TemporaryDirectory() as tmp:
        for d in (dev, torch.device("cpu")):
            gfu, err, _, _, mesh = periodic_solve(T, PER_PARITY_NX, d)
            lsa = T.LevelSetMeshAdaptation(mesh, order=2, periodic=True,
                                           device=d)
            phi = T.y - 0.5 - 0.1 * T.sin(2 * math.pi * T.x)
            deform = lsa.CalcDeformation(phi)
            dist = lsa.CalcMaxDistance(phi)
            cent = mesh.vertices_np[mesh.elements_np].mean(1)
            mesh.mat_of_el_np = np.where(cent[:, 0] < 0.5, 1, 2).astype(
                np.int32)
            mesh.mat_names = {1: "left", 2: "right"}
            lset = T.GridFunction(T.H1(mesh, order=1, device=d))
            T.InterpolateToP1(phi, lset)
            ld = {"levelset": lset, "domain_type": T.NEG}
            ints = list(T.Integrate(ld, cf=1.0 + T.x, mesh=mesh, order=2,
                                    region_wise=True))
            ints.append(T.Integrate(ld, cf=T.x, mesh=mesh, order=2,
                                    definedon=mesh.Materials("right")))
            vtk = T.VTKOutput(mesh, coefs=[gfu, deform], names=["u", "d"],
                              filename=os.path.join(tmp, d.type),
                              subdivision=1)
            with open(vtk.Do()) as fh:
                nums = np.array([float(t) for t in fh.read().split()
                                 if t[0].isdigit() or t[0] == "-"])
            par[d.type] = (gfu.vec.data.cpu(), err, deform.vec.data.cpu(),
                           dist, np.array(ints), nums)
    a, b = par[dev.type], par["cpu"]
    rel_u = _vec_rel(a[0], b[0])
    rel_d = float((a[2] - b[2]).abs().max())
    worst_int = float(np.abs(a[4] - b[4]).max())
    worst_vtk = float(np.abs(a[5] - b[5]).max())
    check(rel_u <= PARITY_TOL and abs(a[1] - b[1]) <= PARITY_TOL * b[1],
          f"periodic nx={PER_PARITY_NX}: card vs CPU rel {rel_u}")
    check(rel_d <= PARITY_TOL and abs(a[3] - b[3]) <= PARITY_TOL * b[3]
          and a[3] < 5e-3,
          f"lsetcurv periodic: deformation {rel_d}, distance {a[3]} {b[3]}")
    check(worst_int <= INTEGRATE_TOL,
          f"region-wise integrals card {a[4]} vs CPU {b[4]}")
    check(a[5].shape == b[5].shape and worst_vtk <= 1e-8,
          f"VTKOutput numbers card vs CPU {worst_vtk}")
    for r in rows:
        print(f"[27 periodic] {card()} | Periodic(H1) nx={r['nx']} "
              f"({r['ndof']} dofs): L2 error {r['err']:.6e}, default "
              f"Inverse() {r['path']}, {r['products']} products = "
              f"{r['launches']} ell_spmv launches; Timer (assembly, solve, "
              f"error) {r['s']:.2f} s", flush=True)
    print(f"[27 parity] error ratio {rows[0]['err'] / rows[1]['err']:.3f} > "
          f"{PER_DECAY}; card (CPU) at nx={PER_PARITY_NX}: L2 {a[1]:.12e} "
          f"({b[1]:.12e}), solution rel {rel_u:.1e}; LevelSetMeshAdaptation("
          f"periodic=True) max distance {a[3]:.6e} ({b[3]:.6e}), deformation "
          f"max|diff| {rel_d:.1e}; region-wise and definedon integrals "
          f"{', '.join(f'{v:.12f}' for v in a[4])} (max|diff| "
          f"{worst_int:.1e}); VTKOutput {a[5].size} numbers, max|diff| "
          f"{worst_vtk:.1e}", flush=True)
    launches = ell_spmv.launches
    check(launches > 0 or dev.type != "cuda",
          "the periodic path launched ell_spmv no time")
    print(f"[27 launches] ell_spmv {launches}, dia_cg {dia_cg.launches}; "
          f"wall of phase 27 {time.perf_counter() - t0:.2f} s", flush=True)
    return launches


def phases_26_27(T, dev, t_start, model64=None, dst64=None, st64=None):
    """Phases 26 (differentiable cut FEM) and 27 (periodic spaces,
    materials, utilities), each with the launch counters reset just before
    it; the f64 flagship model of phase 13 and its structures are reused
    when given.  Returns (ell_spmv launches of phase 26, of phase 27, B2's
    records on phase 26's transposed tables)."""
    from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson

    t0 = time.perf_counter()
    if model64 is None:
        model64 = UnfittedPoisson(nx=AD_NX, dim=3, order=1,
                                  dtype=torch.float64, device=dev)
    dst64 = dst64 if dst64 is not None else model64.dia_structure()
    st64 = st64 if st64 is not None else model64.ell_structure()
    print(f"[26 setup] nx={model64.nx} f64 model and structures in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    ad_launches, ad_tables = phase_26(T, dev, model64, dst64, st64)
    per_launches = phase_27(T, dev)
    print(f"[27 whole] wall of phases 26-27 {time.perf_counter() - t0:.2f} "
          f"s, of the whole run {time.perf_counter() - t_start:.2f} s",
          flush=True)
    return ad_launches, per_launches, ad_tables


# phase 28: the dry run through spawned NCCL ranks, the parallel layouts at
# world size 1 through NCCL, nx=48 (the flagship's full width), and the
# public-API flagship on a sharded mesh; phase 29: the reference's other
# assembly routes
PAR_WIDTHS = (2, 4, 8)    # halo tables from the host partitions
PAR_ITERS = 25            # layouts A-B: the reference's partial CG
PAR_PCG = 50              # layout C: Jacobi-PCG
PAR_TOL = {torch.float64: 1e-5, torch.float32: 1e-3}  # partial CGs
PAR_D_TOL = 1e-6          # layout D vs the single-rank pipeline
PAR_D_RES = 1e-8          # layout D's true relative residual
PAR_API_NX = 48           # phase 28(b): examples.fictdom3d P1 f64, full width
PAR_API_SEED = 2032       # the seeded x of the sharded operators' products
A4B_CAP_EXTRA = 64        # cut capacity beyond ncut
A4B_TOL = 1e-12           # relative, apply_compact and the ELL routes
A4B_STENCIL_TOL = 1e-13   # stencil vs lattice, absolute (the JAX test's)


def par_group(dev):
    """(world-size-1 ``ShardGroup`` on ``dev`` through a ``FileStore``,
    the store's path) : NCCL on a card, gloo on the CPU."""
    from ngsxfem_tpu_torch.parallel import init_group

    build = os.path.join(os.path.dirname(TOOLS), "build")
    os.makedirs(build, exist_ok=True)
    store = os.path.join(build, f"filestore-{os.getpid()}")
    if os.path.exists(store):
        os.remove(store)
    return init_group(0, 1, store, device=dev), store


def halo_tables(model, offsets):
    """(ranks, shared dofs of ``DofPartition``, lattice halo dofs per rank
    boundary 2 H plane, slab planes L) for ``PAR_WIDTHS`` ranks, from the
    host tables alone."""
    from ngsxfem_tpu_torch.parallel import (DofPartition, LatticeShard,
                                            ShardGroup, element_chunks)

    e2d = model.space.el2dof_np
    fd = np.concatenate([e2d[model.gp_e1], e2d[model.gp_e2]], axis=1)
    rows = []
    for n in PAR_WIDTHS:
        ch = element_chunks(model.mesh.ne, n, planes=model.nx)
        part = DofPartition(model.ndof, [e2d, fd], [ch, ch[model.gp_e1]], n)
        ls = LatticeShard(offsets, model.nx + 1, model.dim,
                          ShardGroup(0, n, "cpu"))
        rows.append((n, part.S, 2 * ls.H * ls.plane, ls.L))
    return rows


def _counted(group, fn, reps=3):
    """(fn() of a first call, the median ms of ``reps`` more by CUDA
    events, the collectives the first call issued, the bytes they
    moved)."""
    c0, b0 = group.calls, group.bytes
    out = fn()
    calls, nbytes = group.calls - c0, group.bytes - b0
    return out, _warm_ms(fn, reps), calls, nbytes


def _warm_ms(fn, reps=3):
    """Median ms of ``reps`` calls of an already warmed ``fn`` (CUDA events;
    the host clock on the CPU)."""
    return statistics.median(event_ms(fn)[1] for _ in range(reps))


def par_dryrun(dev):
    """Phase 28(a): ``dryrun_multichip`` on every card of this host through
    ``spawn_ranks``' default path (one spawned NCCL rank per card:
    ``rank_device``, ``set_device``, a ``FileStore``), on the CPU one gloo
    rank.  Its checks run on rank 0 and a failed rank raises here.
    Returns (the world size, rank 0's numbers, wall s)."""
    from ngsxfem_tpu_torch.parallel import dryrun_multichip

    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the ranks share this process's card
        n = torch.cuda.device_count()
        out = dryrun_multichip(n)
    else:
        n = 1
        out = dryrun_multichip(n, device="cpu")
    return n, out, time.perf_counter() - t0


def par_operator(dev, group):
    """Phase 28(b): the public-API flagship (``examples.fictdom3d``, P1,
    f64, ``PAR_API_NX``) built twice, its mesh unsharded and sharded over
    ``group`` (world size 1 through NCCL on the card).  The sharded
    ``AssembleOperator()`` (stencil) and ``AssembleOperator(lattice=False)``
    (PA) give the unsharded operators' ``matvec`` of a seeded x and
    ``diagonal()`` bit for bit, Jacobi-PCG-50 through the sharded stencil
    the unsharded one's iterate, and the sharded ``Assemble()`` and default
    ``a.mat.Inverse(freedofs)`` (Jacobi-CG through B2, the launch counter
    reset just before the sharded solve) the unsharded solution.  Returns
    the numbers: ms of each step by CUDA events per run, the collectives
    and bytes of each sharded build, B2's launches and the CG's products
    of the sharded solve, and the unsharded system (``system``: the
    assembled forms, the space and the free dofs) for phase 30."""
    from ngsxfem_tpu_torch import GridFunction
    from ngsxfem_tpu_torch.examples import fictdom3d
    from ngsxfem_tpu_torch.parallel import shard_space
    from ngsxfem_tpu_torch.solvers import ell_spmv
    from ngsxfem_tpu_torch.solvers.krylov import cg

    t0 = time.perf_counter()
    runs = {}
    for name in ("unsharded", "sharded"):
        a, f, Vh, free, l2error = fictdom3d.system(nx=PAR_API_NX, device=dev)
        if name == "sharded":
            shard_space(Vh, group)
        r = runs[name] = {"ms": {}, "coll": {}, "ndof": Vh.ndof}
        x = torch.as_tensor(
            np.random.default_rng(PAR_API_SEED).standard_normal(Vh.ndof),
            dtype=torch.float64, device=dev)
        c0, b0 = group.calls, group.bytes
        _, r["ms"]["LinearForm.Assemble"] = event_ms(f.Assemble)
        r["coll"]["LinearForm.Assemble"] = (group.calls - c0,
                                            group.bytes - b0)
        fm = torch.as_tensor(free.np, device=dev)
        load = torch.where(fm, f.vec.data, 0.0)
        for kind, lattice in (("stencil", "auto"), ("pa", False)):
            c0, b0 = group.calls, group.bytes
            op, r["ms"][f"{kind} build"] = event_ms(
                lambda: a.AssembleOperator(lattice))
            r["coll"][f"{kind} build"] = (group.calls - c0, group.bytes - b0)
            check(op.kind == kind, f"{name} AssembleOperator({lattice!r}): "
                                   f"kind {op.kind}, {kind} expected")
            r[kind] = (op.matvec(x), op.diagonal())
            r["ms"][f"{kind} matvec"] = _warm_ms(lambda: op.matvec(x))
            if kind == "stencil":
                d = r[kind][1]
                dinv = torch.where(fm & (d.abs() > 1e-30), 1.0 / d, 0.0)

                def pcg():
                    return cg(lambda z: torch.where(
                        fm, op.matvec(torch.where(fm, z, 0.0)), 0.0), load,
                        M=lambda q: dinv * q, maxiter=PAR_PCG, tol=0.0)[0]

                r["pcg"], _ = event_ms(pcg)
                r["ms"][f"stencil PCG-{PAR_PCG}"] = _warm_ms(pcg, reps=1)
            del op
        c0, b0 = group.calls, group.bytes
        _, r["ms"]["BilinearForm.Assemble"] = event_ms(a.Assemble)
        r["coll"]["BilinearForm.Assemble"] = (group.calls - c0,
                                              group.bytes - b0)

        def solve():
            inv = a.mat.Inverse(free)
            return inv, inv * f.vec.data

        if name == "sharded":
            ell_spmv.launches = 0
        before = ell_spmv.launches
        with counted_products("cg") as cnt:
            (inv, r["x"]), r["ms"]["Inverse() solve"] = event_ms(solve)
        r["launches"] = ell_spmv.launches - before
        r["path"], r["products"], r["iters"] = inv.path, cnt.products, \
            cnt.iters
        gfu = GridFunction(Vh)
        gfu.vec.data = r["x"]
        r["l2"] = float(l2error(gfu))
        if name == "unsharded":  # phase 30 solves it again
            r["system"] = (a, f, Vh, free)
        del a, f, Vh, inv, gfu
    one, sh = runs["unsharded"], runs["sharded"]
    for kind in ("stencil", "pa"):
        for i, what in enumerate(("matvec", "diagonal()")):
            check(torch.equal(sh[kind][i], one[kind][i]),
                  f"sharded {kind} {what} != the unsharded operator's")
        check(sh["coll"][f"{kind} build"][0] == 1,
              f"sharded {kind} build: {sh['coll'][f'{kind} build'][0]} "
              "collectives, one all-reduce of the element stream expected")
    check(torch.equal(sh["pcg"], one["pcg"]),
          f"Jacobi-PCG-{PAR_PCG} through the sharded stencil != unsharded")
    check(torch.equal(sh["x"], one["x"]),
          "the sharded Assemble + Inverse() solution != the unsharded one")
    check(np.isfinite(sh["l2"]) and abs(sh["l2"] - one["l2"])
          <= 1e-12 * one["l2"], f"L2 errors {sh['l2']} vs {one['l2']}")
    if dev.type == "cuda":
        for r in (one, sh):
            check(r["path"] == "device_cg" and r["launches"] == r["products"]
                  == r["iters"] + 1 > 1,
                  f"Inverse(): path {r['path']}, {r['launches']} B2 "
                  f"launches for {r['products']} products, {r['iters']} "
                  "iterations")
    sh["wall"] = time.perf_counter() - t0
    return one, sh


def phase_28(dev, flagships):
    """The parallel layouts on ``dev`` at world size 1 (NCCL on the card,
    gloo on the CPU) on the flagships ``{dtype: (model, dia structure, DIA
    table)}``: A and B in f64, C and D in f32 and f64, each against the
    same solve on one device; ms per step and per CG iteration, the
    collectives and bytes per CG iteration, the host halo tables for 2, 4
    and 8 ranks, the idle share of one step of A.  A failed collective
    raises; the group is destroyed at the end."""
    import torch.distributed as dist
    from ngsxfem_tpu_torch.parallel import dryrun as D

    t0 = time.perf_counter()
    group, store = par_group(dev)
    rows = []
    try:
        f64 = torch.float64
        m64 = flagships[f64][0]
        x1, _ = D.single_apply_cg(m64, PAR_ITERS)
        for name, make in (("A element-sharded (spmd_step)",
                            lambda it: m64.spmd_step(group, maxiter=it)),
                           ("B dof-sharded (spmd_step_sharded)",
                            lambda it: m64.spmd_step_sharded(group,
                                                             maxiter=it))):
            made = make(PAR_ITERS)
            step, args = made[:2]
            out, ms, calls, nbytes = _counted(group, lambda: step(*args))
            step0, args0 = make(0)[:2]
            step0(*args0)
            ms0 = _warm_ms(lambda: step0(*args0))
            if name.startswith("A"):
                x = out[0]
                busy = (device_busy(lambda: step(*args))
                        if dev.type == "cuda" else None)
            else:
                x = made[2](out[0], out[1])
                busy = None
            rel = D._rel(x, x1)
            check(rel <= PAR_TOL[f64], f"{name} vs one device: rel {rel}")
            rows.append({"layout": name, "dtype": "float64", "ms": ms,
                         "ms_iter": (ms - ms0) / PAR_ITERS,
                         "calls_iter": calls / PAR_ITERS,
                         "bytes_iter": nbytes / PAR_ITERS, "rel": rel,
                         "busy": busy})
        for dt in (torch.float32, f64):
            m, dst, V = flagships[dt]
            (x, _, ls, cg_bytes), ms, calls, _ = _counted(
                group, lambda: D.layout_c(m, dst, V, group, PAR_PCG, 0.0))
            xr, _ = D.single_dia_cg(m, dst, V, PAR_PCG, 0.0)
            rel = D._rel(x, xr)
            check(rel <= PAR_TOL[dt], f"layout C {dt} vs one device: {rel}")
            rows.append({"layout": f"C lattice-slab Jacobi-PCG-{PAR_PCG}",
                         "dtype": str(dt)[6:], "ms": ms, "ms_iter": ms / PAR_PCG,
                         "calls_iter": calls / PAR_PCG,
                         "bytes_iter": cg_bytes / PAR_PCG, "rel": rel,
                         "busy": None})
            (x, res, Vl, ls), ms, calls, nbytes = _counted(
                group, lambda: D.layout_d(m, dst, group, outer=IR_OUTER,
                                          inner=IR_INNER), reps=1)
            xs, res1, Vfull = D.single_pipeline_d(m, dst, outer=IR_OUTER,
                                                  inner=IR_INNER)
            rel = D._rel(x, xs)
            bn = float(torch.linalg.vector_norm(D.indicator(m, dst).double()))
            check(torch.equal(Vl[:, :ls.n], Vfull),
                  f"layout D {dt}: slab rows != the whole table's")
            check(rel <= PAR_D_TOL, f"layout D {dt} vs one device: {rel}")
            check(float(res) / bn <= PAR_D_RES,
                  f"layout D {dt}: true rel res {float(res) / bn}")
            iters = IR_OUTER * IR_INNER
            rows.append({"layout": f"D slab assembly + cg_ir "
                                   f"({IR_OUTER} x {IR_INNER})",
                         "dtype": str(dt)[6:], "ms": ms, "ms_iter": ms / iters,
                         "calls_iter": calls / iters,
                         "bytes_iter": nbytes / iters, "rel": rel,
                         "busy": None, "rel_res": float(res) / bn})
        api = par_operator(dev, group)
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):  # the store removes its file itself
            os.remove(store)
    m32, d32, _ = flagships[torch.float32]
    halos = halo_tables(m32, d32["offsets"])
    for r in rows:
        idle = ("" if r["busy"] is None else
                f", one step {r['busy'][0]} device kernels, busy "
                f"{r['busy'][1]:.3f} ms of {r['busy'][2]:.3f} ms wall (idle "
                f"share {1 - r['busy'][1] / r['busy'][2]:.3f})")
        res = "" if "rel_res" not in r else \
            f", true rel res {r['rel_res']:.3e}"
        print(f"[28 parallel] {card() if dev.type == 'cuda' else 'CPU'} | "
              f"nx={m64.nx} world size 1 | {r['layout']} {r['dtype']}: "
              f"{r['ms']:.3f} ms per step, {r['ms_iter']:.3f} ms per CG "
              f"iteration, {r['calls_iter']:.2f} collectives and "
              f"{r['bytes_iter']:.0f} B per iteration, vs one device rel "
              f"{r['rel']:.3e}{res}{idle}", flush=True)
    print(f"[28 halo tables] nx={m32.nx} ndof={m32.ndof} (host partitions, "
          f"no run): " + "; ".join(
              f"{n} ranks: dof-sharded shared buffer {S} dofs "
              f"({100.0 * S / m32.ndof:.1f}% of ndof), lattice slabs of {L} "
              f"planes, halo {h} dofs per rank boundary"
              for n, S, h, L in halos), flush=True)
    one, sh = api
    where, clock = ((card(), "CUDA events") if dev.type == "cuda"
                    else ("CPU", "host clock"))
    print(f"[28 sharded api] {where} | examples.fictdom3d P1 f64 "
          f"nx={PAR_API_NX} ({sh['ndof']} dofs), mesh sharded at world size "
          f"1 through {group_backend(dev)} vs unsharded: AssembleOperator() "
          "stencil and AssembleOperator(lattice=False) PA, matvec and "
          f"diagonal() bitwise; Jacobi-PCG-{PAR_PCG} through the stencil "
          "bitwise; Assemble() + default Inverse() bitwise, path "
          f"{sh['path']}, {sh['iters']} iterations = {sh['products']} "
          f"products = {sh['launches']} B2 launches; L2 error "
          f"{sh['l2']:.10e} | ms ({clock}), sharded (unsharded): "
          + ", ".join(f"{k} {v:.3f} ({one['ms'][k]:.3f})"
                      for k, v in sh["ms"].items())
          + " | collectives and bytes of the sharded builds: "
          + ", ".join(f"{k} {c} ({nb} B)" for k, (c, nb)
                      in sh["coll"].items())
          + f"; wall of 28(b) {sh['wall']:.2f} s", flush=True)
    print(f"[28 whole] wall of phase 28 {time.perf_counter() - t0:.2f} s",
          flush=True)
    return rows, halos, api


def phase_29(dev, model, dst, V, st):
    """The reference's other assembly routes of the f64 flagship ``model``
    (DIA structure ``dst`` and lattice table ``V``, ELL structure ``st``):
    ``assemble_vals_stencil`` against ``V``, ``apply_compact`` against
    ``apply``, ``assemble_ell_vals`` / ``_gather`` / ``_soa`` against each
    other and ``assemble_vals_soa1``; their ELL table solved by Jacobi-CG-50
    through B2 (the launches of the phase) and, on the card, B2 against its
    plain versions with its times.  Returns (B2 launches, B2's record or
    None on the CPU, the numbers)."""
    from ngsxfem_tpu_torch.solvers import ell_spmv
    from ngsxfem_tpu_torch.solvers.krylov import cg
    from ngsxfem_tpu_torch.solvers.sparse import ELLMatrix

    t0 = time.perf_counter()
    out = {}
    S, n1 = model.assemble_vals_stencil(model.vertices, model.lset, dst)
    out["stencil_bitwise"] = torch.equal(S, V)
    out["stencil_diff"] = float((S - V).abs().max())
    check(out["stencil_diff"] <= A4B_STENCIL_TOL,
          f"stencil vs lattice: {out['stencil_diff']}")
    ncut = int(n1)
    cap = ncut + A4B_CAP_EXTRA
    rng = np.random.default_rng(2031)
    x = torch.as_tensor(rng.standard_normal(model.ndof), dtype=model.dtype,
                        device=dev)
    yc = model.apply_compact(model.vertices, model.lset, x, cap)
    ya = model.apply(model.vertices, model.lset, x)
    out["compact_rel"] = float((yc - ya).abs().max() / ya.abs().max())
    check(out["compact_rel"] <= A4B_TOL,
          f"apply_compact vs apply: {out['compact_rel']}")
    gt = model.ell_gather_structure(st)
    tables = {}
    for name, fn in (
            ("assemble_ell_vals", lambda: model.assemble_ell_vals(
                model.vertices, model.lset, cap, st)),
            ("assemble_ell_vals_gather", lambda: model.assemble_ell_vals_gather(
                model.vertices, model.lset, cap, st, gt)),
            ("assemble_ell_vals_soa", lambda: model.assemble_ell_vals_soa(
                model.vertices, model.lset, cap, st)),
            ("assemble_vals_soa1", lambda: model.assemble_vals_soa1(
                model.vertices, model.lset, st))):
        (vals, n), ms = event_ms(fn)
        check(int(n) == ncut, f"{name}: ncut {int(n)} != {ncut}")
        tables[name] = (vals, ms)
    ref = tables["assemble_vals_soa1"][0]
    big = float(ref.abs().max())
    out["ell_rel"] = {k: float((v - ref).abs().max()) / big
                      for k, (v, _) in tables.items()}
    check(max(out["ell_rel"].values()) <= A4B_TOL,
          f"the ELL routes disagree: {out['ell_rel']}")
    out["ms"] = {k: ms for k, (_, ms) in tables.items()}

    # the path: Jacobi-CG-50 on the compact table through B2, counters
    # reset just before it
    cols = torch.as_tensor(st["ell_cols"], device=dev)
    A = ELLMatrix(cols, tables["assemble_ell_vals"][0], (model.ndof,) * 2)
    b = torch.as_tensor(np.where(model.active_dofs, 1.0, 0.0),
                        dtype=model.dtype, device=dev)
    dinv = 1.0 / A.diagonal()
    ell_spmv.launches = 0
    xk, _, res = cg(A.matvec, b, M=lambda r: dinv * r, maxiter=CG_ITERS,
                    tol=0.0)
    launches = ell_spmv.launches
    xp, _, _ = cg(lambda z: ell_spmv.ell_matvec_plain(A.vals, A.cols, z), b,
                  M=lambda r: dinv * r, maxiter=CG_ITERS, tol=0.0)
    ell_spmv.launches = launches  # the plain solve is no path's
    check(torch.equal(xk, xp), "Jacobi-CG on B2 != on ell_matvec_plain")
    if dev.type == "cuda":
        check(launches == CG_ITERS + 1,
              f"B2 launches {launches} != products {CG_ITERS + 1}")
        b2 = b2_on_table(f"compact ELL nx={model.nx} f64", A,
                         np.ones(model.ndof, bool), b, dev)
    else:
        b2 = None
    out["cg_rel"] = float(res) / float(torch.linalg.vector_norm(b))
    print(f"[29 a4b] nx={model.nx} f64 | assemble_vals_stencil vs "
          f"assemble_vals_lattice: bitwise {out['stencil_bitwise']}, max|d| "
          f"{out['stencil_diff']:.3e} | apply_compact (cap {cap}) vs apply "
          f"rel {out['compact_rel']:.3e} | vs assemble_vals_soa1 rel "
          + ", ".join(f"{k} {v:.3e} ({out['ms'][k]:.3f} ms)"
                      for k, v in out["ell_rel"].items())
          + f" | Jacobi-CG-{CG_ITERS} on the compact ELL table: {launches} "
          f"B2 launches, == on ell_matvec_plain bitwise, rel res "
          f"{out['cg_rel']:.3e}"
          + (f" | B2 on this table ({model.ndof} x {st['K']} f64): kernel == "
             f"plain bitwise (max|dy| {b2['err']:.3e}), {b2_text(b2)}"
             if b2 is not None else "")
          + f"; wall of phase 29 {time.perf_counter() - t0:.2f} s",
          flush=True)
    return launches, b2, out


def group_backend(dev):
    return "NCCL" if dev.type == "cuda" else "gloo"


def phases_28_29(dev, t_start, flagships, st):
    """Phases 28 (the spawned dry run, the parallel layouts, the sharded
    public-API operators and solve, B2's launch counter reset before that
    solve) and 29 (the other assembly routes, the counter reset before its
    solve).  Returns (B2 launches of phase 29, B2's record, phase 28's
    rows, its halo tables, the (unsharded, sharded) numbers of 28(b))."""
    n, dry, wall = par_dryrun(dev)
    lay = dry["layouts"]
    print(f"[28 spawn] {card() if dev.type == 'cuda' else 'CPU'} | "
          f"dryrun_multichip({n}) through spawn_ranks"
          + ("' default path: one spawned NCCL rank per card (rank_device, "
             "set_device, FileStore)" if dev.type == "cuda" else
             "(device='cpu'): one spawned gloo rank (FileStore)")
          + f"; layouts at nx=12 "
          f"(ne={lay['ne']}, ndof={lay['ndof']}) vs one rank rel A "
          f"{lay['d_rep']:.3e}, B {lay['d_dof']:.3e}, C {lay['d_lat']:.3e}"
          + (f", {len(dry['scaling'])} halo-table rows, layout D widths "
             f"{[r['width'] for r in dry['layout_d']]}"
             if "scaling" in dry else "")
          + f"; wall {wall:.2f} s", flush=True)
    rows, halos, api = phase_28(dev, flagships)
    m64, d64, V64 = flagships[torch.float64]
    launches, b2, _ = phase_29(dev, m64, d64, V64, st)
    print(f"[29 whole] of the whole run {time.perf_counter() - t_start:.2f} s",
          flush=True)
    return launches, b2, rows, halos, api


P30_P2_NX = 128       # fine mesh of the P2 pair (coarse nx 64)
P30_HDG_NX = 256      # the tracefem_hdg band's mesh, phase 23's size
P30_SEED = 3030       # seeded numpy right-hand sides and vectors
P30_CG_STEPS = 4000   # CGSolver's budget at nx=48 (converges well before)
P30_RES = 1e-8        # true relative residual of the numpy-input solves
P30_ASM_TOL = 1e-12   # compressed facet assembly, card vs CPU


def p30_solve(fn):
    """(fn(), ms by CUDA events, B2 launches, products, iterations) of one
    ``krylov.cg`` solve, B2's launch counter reset just before it."""
    from ngsxfem_tpu_torch.solvers import ell_spmv

    ell_spmv.launches = 0
    with counted_products("cg") as cnt:
        x, ms = event_ms(fn)
    return x, ms, ell_spmv.launches, cnt.products, cnt.iters


def p30_rel_res(A, x, b, free=None):
    """True relative residual of A x = b on the free dofs (all without)."""
    r = A.matvec(x) - b
    if free is not None:
        r, b = torch.where(free, r, 0.0), torch.where(free, b, 0.0)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))


def phase_30(dev, system, t_start):
    """Phase 30: the public-API paths the parity run repaired, on ``dev``.
    ``system`` is phase 28's unsharded ``examples.fictdom3d`` (assembled
    forms ``a``/``f``, the space, the free dofs).  Each solve and product
    runs once with a numpy input and once with the tensor on ``dev``: the
    two results bitwise equal, B2's launches (counter reset just before
    each call) == the products (0 on the CPU).  Returns the cases' numbers
    and the B2 launches of the phase."""
    from ngsxfem_tpu_torch import (
        CGSolver, Compress, CutInfo, GetFacetsWithNeighborTypes,
        GridFunction, H1, IF, InterpolateToP1, BilinearForm,
        MakeStructured2DMesh, P2Prolongation, SymbolicBFI, sqrt, x, y)
    from ngsxfem_tpu_torch.fem.facetspace import (FacetFESpace,
                                                  GetDofsOfFacets)
    from ngsxfem_tpu_torch.solvers import ell_spmv
    from ngsxfem_tpu_torch.utils.timing import GetTimers, ResetTimers

    t0 = time.perf_counter()
    on_card = dev.type == "cuda"
    where = card() if on_card else "CPU"
    clock = "CUDA events" if on_card else "host clock"
    rng = np.random.default_rng(P30_SEED)
    out = {"launches": 0}

    def launches_ok(what, launches, products):
        check(launches == (products if on_card else 0) and products > 0,
              f"{what}: {launches} B2 launches for {products} products")
        out["launches"] += launches

    # (a) numpy right-hand sides of the public-API flagship
    a, f, Vh, free = system
    fm = torch.as_tensor(free.np, device=dev)
    b = f.vec.data
    b_np = b.cpu().numpy()
    rows = []
    for name, solve in (
            ("CGSolver(a.mat, freedofs) *",
             lambda rhs: CGSolver(a.mat, freedofs=free, maxsteps=P30_CG_STEPS,
                                  tol=1e-10) * rhs),
            ('a.mat.Inverse(freedofs, inverse="cg") *',
             lambda rhs: a.mat.Inverse(free, inverse="cg") * rhs)):
        solve(b)  # warm-up, so that both timed calls find the same state
        res = {}
        for kind, rhs in (("numpy", b_np), ("tensor", b)):
            xk, ms, launches, products, iters = p30_solve(lambda: solve(rhs))
            launches_ok(f"{name} {kind}", launches, products)
            check(products == iters + 1, f"{name} {kind}: {products} "
                                         f"products, {iters} iterations")
            res[kind] = (xk, ms, launches, iters)
        check(torch.equal(res["numpy"][0], res["tensor"][0]),
              f"{name}: the numpy right-hand side's solution != the tensor's")
        rel = p30_rel_res(a.mat, res["numpy"][0], b, fm)
        check(rel <= P30_RES, f"{name}: true relative residual {rel}")
        rows.append((name, res, rel))
    print(f"[30 numpy rhs] {where} | examples.fictdom3d P1 f64 nx="
          f"{PAR_API_NX} ({Vh.ndof} dofs, phase 28's unsharded system): "
          + "; ".join(
              f"{n} b_np: bitwise the tensor call's, {r['numpy'][3]} "
              f"iterations, {r['numpy'][2]} B2 launches = products, true rel "
              f"res {rel:.3e}, ms ({clock}) numpy {r['numpy'][1]:.3f} / "
              f"tensor {r['tensor'][1]:.3f}" for n, r, rel in rows),
          flush=True)
    out["solves"] = [{"call": n, "iters": r["numpy"][3],
                      "launches": r["numpy"][2], "ms_numpy": r["numpy"][1],
                      "ms_tensor": r["tensor"][1], "rel_res": rel}
                     for n, r, rel in rows]

    # (b) P2Prolongation.Prolongate of a numpy vector: one B2 product
    m1 = MakeStructured2DMesh(quads=False, nx=P30_P2_NX // 2,
                              ny=P30_P2_NX // 2)
    m2 = MakeStructured2DMesh(quads=False, nx=P30_P2_NX, ny=P30_P2_NX)
    prol = P2Prolongation(m1)
    prol.Update(H1(m1, order=2, device=dev))
    prol.Update(H1(m2, order=2, device=dev))
    nc = prol.mats[0].shape[1]
    ones = prol.Prolongate(1, np.ones(nc))  # builds the ELL view once
    check(float((ones - 1.0).abs().max()) <= 1e-10,
          "P2Prolongation: the constant does not map to the constant")
    c_np = rng.standard_normal(nc)
    pro = {}
    for kind, vec in (("numpy", c_np), ("tensor", torch.as_tensor(
            c_np, device=dev))):
        ell_spmv.launches = 0
        pro[kind], ms = event_ms(lambda: prol.Prolongate(1, vec))
        launches_ok(f"Prolongate {kind}", ell_spmv.launches, 1)
        pro[kind + "_ms"] = ms
    check(torch.equal(pro["numpy"], pro["tensor"]),
          "P2Prolongation.Prolongate: numpy input != tensor input")
    print(f"[30 prolongation] {where} | P2Prolongation nx {P30_P2_NX // 2} "
          f"-> {P30_P2_NX} ({nc} -> {pro['numpy'].numel()} dofs): "
          f"Prolongate(1, numpy) bitwise the tensor call's, one B2 launch "
          f"each, constant -> constant within 1e-10 (max dev "
          f"{float((ones - 1.0).abs().max()):.3e}); ms ({clock}) numpy "
          f"{pro['numpy_ms']:.3f} / tensor {pro['tensor_ms']:.3f}",
          flush=True)
    out["prolongate"] = {"nc": nc, "ms_numpy": pro["numpy_ms"],
                         "ms_tensor": pro["tensor_ms"]}
    del prol, ones, pro

    # (c) a Compressed FacetFESpace on the tracefem_hdg band, and (d) the
    # assembly timers of one card Assemble of each form
    mesh = MakeStructured2DMesh(quads=False, nx=P30_HDG_NX, ny=P30_HDG_NX,
                                mapping=lambda s, t: (2 * s - 1, 2 * t - 1))
    lset = GridFunction(H1(mesh, order=1, device=dev))
    InterpolateToP1(sqrt(x * x + y * y) - 0.7, lset)
    band = CutInfo(mesh, lset).GetElementsOfType(IF)
    band_f = GetFacetsWithNeighborTypes(mesh, a=band, b=band, use_and=True)
    mats = {}
    for d in (dev, torch.device("cpu")):
        F = FacetFESpace(mesh, order=1, device=d)
        Fc = Compress(F, GetDofsOfFacets(F, band_f))
        u, v = Fc.TnT()
        form = BilinearForm(Fc)
        form += SymbolicBFI(form=u * v, element_boundary=True,
                            definedonelements=band)
        if d == dev:
            ResetTimers()
            _, asm_ms = event_ms(form.Assemble)
            _, lf_ms = event_ms(f.Assemble)
            timers = GetTimers()
        else:
            form.Assemble()
        mats[d.type] = form.mat
    Ad = mats[dev.type].todense()
    Ah = mats["cpu"].todense().to(dev)
    scale = float(Ah.abs().max())
    diff = float((Ad - Ah).abs().max())
    check(scale > 0 and diff <= P30_ASM_TOL * scale,
          f"compressed facet assembly card vs CPU: {diff} of {scale}")
    check(bool((Ad.abs().sum(1) > 1e-12 * scale).all()),
          "compressed facet assembly: a dead row")
    A = mats[dev.type]
    inv = A.Inverse()
    check(inv.path == ("device_cg" if on_card else "host_lu"),
          f"compressed facet Inverse(): path {inv.path}")
    rhs = rng.standard_normal(A.shape[0])
    xc, inv_ms, launches, products, iters = p30_solve(lambda: inv * rhs)
    if on_card:
        launches_ok("compressed facet Inverse()", launches, products)
    rel = p30_rel_res(A, xc, torch.as_tensor(rhs, device=dev))
    check(rel <= P30_RES, f"compressed facet Inverse(): rel res {rel}")
    for key in ("BilinearForm::Assemble", "LinearForm::Assemble"):
        check(timers.get(key, (0.0, 0))[1] == 1,
              f"GetTimers() after one Assemble: {key} {timers.get(key)}")
    print(f"[30 compressed facet space] {where} | FacetFESpace order 1 on "
          f"the tracefem_hdg band at nx={P30_HDG_NX} ({int(band.np.sum())} "
          f"band elements, {int(band_f.np.sum())} band facets), Compress -> "
          f"{A.shape[0]} dofs: element_boundary mass on the card vs CPU max "
          f"{diff:.3e} of {scale:.3e}, no dead row; default Inverse() path "
          f"{inv.path}, {iters} iterations, {launches} B2 launches = "
          f"products, true rel res {rel:.3e}; ms ({clock}) Assemble "
          f"{asm_ms:.3f}, solve {inv_ms:.3f} | GetTimers() after one card "
          f"Assemble of each form: "
          + ", ".join(f"{k} {timers[k][1]} call {1e3 * timers[k][0]:.3f} ms"
                      for k in ("BilinearForm::Assemble",
                                "LinearForm::Assemble"))
          + f" (host clock, LinearForm.Assemble {lf_ms:.3f} ms by {clock})",
          flush=True)
    out["facet"] = {"ndof": A.shape[0], "asm_ms": asm_ms, "diff": diff,
                    "scale": scale, "iters": iters, "launches": launches,
                    "solve_ms": inv_ms, "rel_res": rel}
    print(f"[30 whole] B2 launches of phase 30 {out['launches']}; wall of "
          f"phase 30 {time.perf_counter() - t0:.2f} s, of the whole run "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    return out


P31_REPS = 7          # interleaved numpy / tensor pairs timed per case
P31_SEED = 3131       # seeded numpy vectors of the kernel-free cases
P31_LAT_NX = 24       # the lattice transfers: nx 24 -> 48 (25^3 -> 49^3)


class counted_ell_products:
    """While active, counts the calls of ``ELLMatrix.matvec``: every product
    of a Krylov solve on an ``ELLMatrix``, called through its bound method
    as a user passes it."""

    def __enter__(self):
        from ngsxfem_tpu_torch.solvers.sparse import ELLMatrix

        self.cls, self.orig, self.products = ELLMatrix, ELLMatrix.matvec, 0

        def matvec(mat, x):
            self.products += 1
            return self.orig(mat, x)

        ELLMatrix.matvec = matvec
        return self

    def __exit__(self, *exc):
        self.cls.matvec = self.orig


def p31_pair(fns):
    """Each of ``fns`` ({kind: fn}) called once, then ``P31_REPS`` times
    more in turns whose order flips each round (numpy, tensor, tensor,
    numpy, ...); returns ({kind: first result}, {kind: (median, min) ms})
    by CUDA events (host clock without a card)."""
    first = {k: fn() for k, fn in fns.items()}
    times = {k: [] for k in fns}
    kinds = list(fns)
    for i in range(P31_REPS):
        for k in (kinds if i % 2 == 0 else kinds[::-1]):
            times[k].append(event_ms(fns[k])[1])
    return first, {k: (float(np.median(v)), min(v)) for k, v in times.items()}


def p31_ms(ms):
    """'numpy m (min) / tensor m (min)' of ``p31_pair``'s times."""
    return " / ".join(f"{k} {ms[k][0]:.3f} ({ms[k][1]:.3f})"
                      for k in ("numpy", "tensor"))


# --- to_ell on the card: every table held to the plain version and the host
# conversion, and phase 32 -----------------------------------------------

AUDIT_CAP_BYTES = 16 << 30  # triplets held before the audit checks at once


def _same_ell(c1, v1, c2, v2):
    """Two ELL tables equal bit for bit: shapes, int32 columns, the bits of
    the values."""
    bits = {torch.float64: torch.int64, torch.float32: torch.int32}
    return (c1.shape == c2.shape and c1.dtype == c2.dtype == torch.int32
            and v1.dtype == v2.dtype and torch.equal(c1.cpu(), c2.cpu())
            and torch.equal(v1.cpu().view(bits[v1.dtype]),
                            v2.cpu().view(bits[v2.dtype])))


class to_ell_audit:
    """While active, holds every table that ``SparseMatrix.to_ell`` builds on
    the card (``coo_ell.coo_to_ell`` on CUDA tensors) with its triplets;
    ``check(label)`` holds each against the plain version
    (``coo_ell.place_plain``) on the card and against ``to_ell`` on CPU
    copies, bit for bit, prints one line and lets them
    go.  ``main`` checks between phases, so that no phase's times include
    the checks, unless the held triplets pass ``AUDIT_CAP_BYTES``: then the
    check runs at once, and its line says so.  Conversions inside the
    spawned ranks of phase 28 run in other processes and are not held."""

    def __init__(self):
        self.held, self.bytes = [], 0
        self.tables = self.launching = self.triplets = 0
        self.largest = None
        self.seconds = 0.0

    def __enter__(self):
        from ngsxfem_tpu_torch.solvers import sparse

        self.sparse, self.orig = sparse, sparse.coo_to_ell

        def run(rows, cols, vals, shape):
            out = self.orig(rows, cols, vals, shape)
            if vals.is_cuda:
                self.held.append((rows, cols, vals, tuple(shape), out))
                self.bytes += rows.nbytes + cols.nbytes + vals.nbytes
                if self.bytes > AUDIT_CAP_BYTES:
                    self.check("held triplets over the cap, checked at once")
            return out

        sparse.coo_to_ell = run
        return self

    def __exit__(self, *exc):
        self.sparse.coo_to_ell = self.orig

    def check(self, label):
        from ngsxfem_tpu_torch.solvers import coo_ell

        t0 = time.perf_counter()
        held, self.held, self.bytes = self.held, [], 0
        triplets = 0
        kernel = coo_ell._place_kernel
        for rows, cols, vals, shape, (c, v, nu) in held:
            T = int(vals.shape[0])
            coo_ell._place_kernel = coo_ell.place_plain
            try:
                pc, pv, pnu = self.orig(rows, cols, vals, shape)
            finally:
                coo_ell._place_kernel = kernel
            what = f"to_ell of {T} triplets, shape {shape}, {vals.dtype}"
            check(pnu == nu and _same_ell(c, v, pc, pv),
                  f"{what}: the kernel's table != place_plain's on the card")
            host = self.sparse.SparseMatrix(
                rows.cpu(), cols.cpu(), vals.cpu(), shape,
                device="cpu").to_ell()
            check(_same_ell(c, v, host.cols, host.vals),
                  f"{what}: the card's table != the CPU's")
            triplets += T
            self.launching += nu > 0
            if self.largest is None or T > self.largest["triplets"]:
                self.largest = {"triplets": T, "entries": nu,
                                "n": int(c.shape[0]), "K": int(c.shape[1]),
                                "dtype": str(vals.dtype)[6:]}
            del pc, pv, host
        self.tables += len(held)
        self.triplets += triplets
        dt = time.perf_counter() - t0
        self.seconds += dt
        print(f"[to_ell audit] {label}: {len(held)} tables built on the card "
              f"({triplets} triplets) == place_plain on the card == to_ell "
              f"on the CPU, bit for bit; {self.tables} tables so far; check "
              f"{dt:.2f} s", flush=True)


def phase_32(dev, S, t_start):
    """Phase 32: ``SparseMatrix.to_ell`` on the card on the main path's
    table, phase 14's ``examples.fictdom3d`` P1 f64 nx=48 ``a.mat`` (the
    benchmark's fictdom3d-p1-forms matrix at the fixed sphere),
    ``coo_ell.launches`` reset just before: one call is one launch of the
    kernel ``csrc/coo_ell.cu``, and its table equals phase 14's cached view,
    the plain version's (``place_plain``) on the card and the host
    conversion's bit for bit.  Then the whole call (median of 20 by CUDA
    events), the kernel's device time per launch (``torch.profiler`` over 20
    calls), its bound from this table's counts (the bytes of
    ``tools/torch_to_ell_before_after.kernel_bytes``, one f64 add per
    triplet), the plain version on the card and ``coalesce`` (the dedup and
    sum alone, no placement) as yardsticks.  Returns the kernel record."""
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    import torch_to_ell_before_after as before_after
    from ngsxfem_tpu_torch.solvers import coo_ell, sparse

    t0 = time.perf_counter()
    before = coo_ell.launches
    torch.cuda.synchronize()
    coo_ell.launches = 0
    E = S.to_ell()
    torch.cuda.synchronize()
    launches = coo_ell.launches
    check(launches == 1, f"to_ell launched coo_ell {launches} times, not 1")
    check(_same_ell(E.cols, E.vals, S.ell().cols, S.ell().vals),
          "to_ell != phase 14's cached ELL view")
    T = int(S.vals.shape[0])
    n, K = (int(x) for x in E.vals.shape)
    kernel = coo_ell._place_kernel
    coo_ell._place_kernel = coo_ell.place_plain
    try:
        pc, pv, nu = coo_ell.coo_to_ell(S.rows, S.cols, S.vals, S.shape)
        plain_ms = time_ms(S.to_ell, reps=3)
    finally:
        coo_ell._place_kernel = kernel
    check(_same_ell(E.cols, E.vals, pc, pv),
          "to_ell on the card != place_plain on the card")
    host = sparse.SparseMatrix(S.rows.cpu(), S.cols.cpu(), S.vals.cpu(),
                               S.shape, device="cpu").to_ell()
    check(_same_ell(E.cols, E.vals, host.cols, host.vals),
          "to_ell on the card != to_ell on the CPU")
    del pc, pv, host
    path_ms = time_ms(S.to_ell, reps=20)
    l0 = coo_ell.launches
    kern, _ = device_kernels(S.to_ell, 20)
    check(coo_ell.launches - l0 == 21, f"{coo_ell.launches - l0} coo_ell "
          f"launches in 21 to_ell calls")
    # the profiler may drop an event of a window: per launch it records
    mine = [v for name, v in kern.items() if before_after.KERNEL in name]
    check(len(mine) == 1, f"profiled coo_ell kernels {mine}")
    dev_us = mine[0][1] / mine[0][0]
    vb = E.vals.element_size()
    bound_ms, bound_by = bound(before_after.kernel_bytes(T, nu, n, vb), T,
                               F64_FLOP_PER_S)
    idx = torch.stack([S.rows.long(), S.cols.long()])
    with warnings.catch_warnings():  # "beta state" notices of torch.sparse
        warnings.simplefilter("ignore")
        lib_ms = time_ms(lambda: torch.sparse_coo_tensor(
            idx, S.vals, S.shape).coalesce(), reps=5)
    print(f"[32 coo_ell] {card()} | examples.fictdom3d nx={NX} a.mat: {T} "
          f"triplets, {nu} entries, ELL {n} x {K} {str(E.vals.dtype)[6:]}; "
          f"launches {launches} (counter reset just before; {before} in "
          f"phases 3-31); table == phase 14's view == place_plain on the "
          f"card == to_ell on the CPU, bit for bit; to_ell {path_ms:.3f} ms "
          f"(events, median of 20), the kernel {dev_us:.3f} us device per "
          f"launch, bound {bound_ms * 1e3:.3f} us ({bound_by}); place_plain "
          f"on the card {plain_ms:.3f} ms; coalesce (dedup and sum only) "
          f"{lib_ms:.3f} ms; peak memory {peak_gib(dev):.2f} GiB; wall "
          f"{time.perf_counter() - t0:.2f} s, of the whole run "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    return {"launches": launches, "launches_before": before,
            "table": {"n": n, "K": K, "triplets": T, "entries": nu,
                      "dtype": str(E.vals.dtype)[6:]},
            "ms": dev_us / 1e3, "device_us": dev_us, "path_ms": path_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}


DIA_SPMV_CALLS = 200   # calls per timing of phase 33's kernel
L2_FLUSH_BYTES = 128 << 20  # more than the H100's 50 MB L2


def phase_33(dev, offs, V32, t_start):
    """Phase 33: ``dia_matvec`` on the card as one launch of the kernel
    ``csrc/dia_spmv.cu``, on phase 4's nx=48 f32 lattice table and its f64
    copy (the lattice cell's two products).  Per dtype: one call is one
    launch; the result equals ``dia_matvec_plain``'s bit for bit (NaNs
    equal whatever their payload) on a seeded x and on it with signed
    zeros, infinities and a NaN at the boundary rows; the kernel's device us per launch (``torch.profiler``,
    back to back, the table warm in L2 as in a CG loop, and with a 128 MB
    write between launches, cold) beside its bytes bound (the table, x and
    y once over 3.35 TB/s); the call's ms (CUDA events, mean of
    ``DIA_SPMV_CALLS`` back to back, host-bound) and the host's enqueue us
    per call; the eager path's call ms, device us per call and kernels per
    call.  Returns the numbers per dtype, the phase's launches and the
    largest |kernel - plain| of its comparisons (0 where both are the same
    infinity or both NaN)."""
    from ngsxfem_tpu_torch.solvers import dia_spmv
    from ngsxfem_tpu_torch.solvers.sparse import dia_matvec, dia_matvec_plain

    t0 = time.perf_counter()
    before = dia_spmv.launches
    offs = np.asarray(offs)
    n = int(V32.shape[1])
    rng = np.random.default_rng(33)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    out = {}
    max_err = 0.0
    for dtype, V in ((torch.float32, V32), (torch.float64, V32.double())):
        name = str(dtype)[6:]
        bits = torch.int32 if dtype == torch.float32 else torch.int64
        x = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev)
        xs = x.clone()
        xs[0], xs[1], xs[2] = -0.0, float("inf"), 0.0
        xs[-1], xs[-2], xs[-3] = float("nan"), -float("inf"), -0.0
        for label, v in (("seeded x", x), ("specials", xs)):
            l0 = dia_spmv.launches
            y = dia_matvec(offs, V, v)
            torch.cuda.synchronize()
            check(dia_spmv.launches == l0 + 1,
                  f"dia_matvec {name} {label}: {dia_spmv.launches - l0} "
                  f"launches, not 1")
            yp = dia_matvec_plain(offs, V, v)
            nan = y.isnan()
            same = (y == yp) | (nan & yp.isnan())
            err = float(torch.where(same, 0.0, (y - yp).abs()).max())
            max_err = err if math.isnan(err) else max(max_err, err)
            check(torch.equal(nan, yp.isnan())
                  and torch.equal(y.view(bits)[~nan], yp.view(bits)[~nan]),
                  f"dia_spmv {name} {label} != dia_matvec_plain bit for bit "
                  f"(max |diff| {err})")

        def kernel_call():
            return dia_matvec(offs, V, x)

        def plain_call():
            return dia_matvec_plain(offs, V, x)

        def cold_call():
            flush.zero_()
            return dia_matvec(offs, V, x)

        call_ms = per_call_ms(kernel_call, DIA_SPMV_CALLS)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        for _ in range(DIA_SPMV_CALLS):
            kernel_call()
        host_us = (time.perf_counter() - h0) * 1e6 / DIA_SPMV_CALLS
        torch.cuda.synchronize()
        # the profiler may drop events of a window: per launch it recorded
        kern, _ = device_kernels(kernel_call, DIA_SPMV_CALLS)
        mine = [v for k, v in kern.items() if "dia_spmv" in k]
        check(len(mine) == 1, f"profiled dia_spmv kernels {kern}")
        warm_us = mine[0][1] / mine[0][0]
        kern, _ = device_kernels(cold_call, DIA_SPMV_CALLS)
        mine = [v for k, v in kern.items() if "dia_spmv" in k]
        check(len(mine) == 1, f"profiled dia_spmv kernels {kern}")
        cold_us = mine[0][1] / mine[0][0]
        plain_ms = per_call_ms(plain_call, DIA_SPMV_CALLS // 4)
        kern, _ = device_kernels(plain_call, DIA_SPMV_CALLS // 4)
        plain_kernels = sum(c for c, _ in kern.values()) / (DIA_SPMV_CALLS // 4)
        plain_us = sum(us for _, us in kern.values()) / (DIA_SPMV_CALLS // 4)
        item = V.element_size()
        bound_ms, bound_by = bound((V.numel() + 2 * n) * item, 2 * V.numel(),
                                   F32_FLOP_PER_S if item == 4
                                   else F64_FLOP_PER_S)
        out[name] = {"device_us": warm_us, "device_cold_us": cold_us,
                     "call_ms": call_ms, "host_us": host_us,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "plain_ms": plain_ms, "plain_device_us": plain_us,
                     "plain_kernels": plain_kernels}
        print(f"[33 dia_spmv] {card()} | nx=48 lattice table "
              f"{tuple(V.shape)} {name}: == dia_matvec_plain bit for bit "
              f"(seeded x; +-0, +-inf, NaN at the boundary rows), 1 launch "
              f"a call; kernel {warm_us:.3f} us device per launch warm in L2, "
              f"{cold_us:.3f} us cold (L2 flushed), bound "
              f"{bound_ms * 1e3:.3f} us ({bound_by}); call {call_ms * 1e3:.3f}"
              f" us (events, mean of {DIA_SPMV_CALLS}), host enqueue "
              f"{host_us:.3f} us a call; eager path {plain_ms * 1e3:.3f} us a "
              f"call, {plain_us:.3f} us device in {plain_kernels:.1f} kernels",
              flush=True)
    del flush
    launches = dia_spmv.launches - before
    print(f"[33 dia_spmv] launches {launches} in this phase, max |kernel - "
          f"plain| {max_err} | wall {time.perf_counter() - t0:.2f} s, of the "
          f"whole run {time.perf_counter() - t_start:.2f} s", flush=True)
    return {"launches": launches, "max_abs_err": max_err, **out}


LATTICE_ASM_CALLS = 50  # calls per timing of phase 34's kernel
LATTICE_PLAIN_CALLS = 3  # calls per timing of the eager path beside it


def lattice_asm_check(m, st, lset, label):
    """The lattice kernel against the eager path on the card, at one level
    set ``lset`` of the 3D order-1 model ``m`` (phase 34 and the card cases
    of ``tests/test_torch_lattice_asm.py``): one call is one launch of
    ``csrc/lattice_asm.cu``; its table and ``ncut`` (a card scalar) equal
    ``assemble_vals_lattice_plain``'s on the card bit for bit (+0 and -0
    taken as equal); the table is exactly symmetric and a second call
    repeats it bit for bit.  Returns max |kernel - plain|."""
    from ngsxfem_tpu_torch.models import lattice_asm

    l0 = lattice_asm.launches
    V, ncut = m.assemble_vals_lattice(m.vertices, lset, st)
    torch.cuda.synchronize()
    check(lattice_asm.launches == l0 + 1,
          f"lattice_asm {label}: {lattice_asm.launches - l0} launches, not 1")
    Vp, ncp = m.assemble_vals_lattice_plain(m.vertices, lset, st)
    err = float((V - Vp).abs().max())
    differ = int(((V + 0.0) != (Vp + 0.0)).sum())
    check(V.dtype == Vp.dtype and torch.equal(V + 0.0, Vp + 0.0)
          and ncut.is_cuda and int(ncut) == int(ncp),
          f"lattice_asm {label} != assemble_vals_lattice_plain bit for bit "
          f"({differ} entries differ, max |diff| {err}, ncut {int(ncut)} / "
          f"{int(ncp)})")
    check(is_symmetric(V, st["offsets"]),
          f"lattice_asm {label}: table not exactly symmetric")
    V2, _ = m.assemble_vals_lattice(m.vertices, lset, st)
    check(torch.equal(V2, V), f"lattice_asm {label}: a repeat differs")
    return err


def phase_34(dev, models, t_start):
    """Phase 34: ``assemble_vals_lattice`` on the card as one launch of the
    kernel ``csrc/lattice_asm.cu``, on the nx=48 flagship in float32 (phase
    4's model) and float64 (phase 13's): ``models`` maps the dtype to
    (model, struct).  Per dtype, at the model's sphere and at a moved one
    (centre + (0.031, -0.017, 0.023)), ``lattice_asm_check``; the kernel's
    device us per call (``torch.profiler``, back to back: the kernel and the
    fill that zeroes ``ncut``, the call's only device ops) beside its bytes
    bound (the table written once, the vertices and the level set read
    once, over 3.35 TB/s), its launches per call, the call's ms (CUDA
    events, mean of ``LATTICE_ASM_CALLS``) and the eager path's ms, device
    us and kernels per call.  Returns the numbers per dtype, the phase's
    launches and the largest |kernel - plain| of its comparisons."""
    from ngsxfem_tpu_torch.models import lattice_asm

    t0 = time.perf_counter()
    before = lattice_asm.launches
    out = {}
    max_err = 0.0
    for dtype, (m, st) in models.items():
        name = str(dtype)[6:]
        x = m.vertices.double()
        centre = torch.tensor([0.531, 0.483, 0.523], dtype=torch.float64,
                              device=dev)
        moved = (torch.linalg.vector_norm(x - centre, dim=1) - 0.4).to(dtype)
        for label, lset in (("model's sphere", m.lset), ("moved", moved)):
            max_err = max(max_err, lattice_asm_check(m, st, lset,
                                                     f"{name} {label}"))

        def kernel_call():
            return m.assemble_vals_lattice(m.vertices, moved, st)

        def plain_call():
            return m.assemble_vals_lattice_plain(m.vertices, moved, st)

        l0 = lattice_asm.launches
        call_ms = per_call_ms(kernel_call, LATTICE_ASM_CALLS)
        per_call = (lattice_asm.launches - l0) / (LATTICE_ASM_CALLS + 1)
        check(per_call == 1, f"lattice_asm: {per_call} launches a call")
        # the profiler may drop events of a window: per launch it recorded
        kern, _ = device_kernels(kernel_call, LATTICE_ASM_CALLS)
        asm = [v for k, v in kern.items() if "lattice_asm" in k]
        fill = [k for k in kern if "lattice_asm" not in k]
        check(len(asm) == 1 and len(fill) <= 1
              and all("Fill" in k for k in fill),
              f"profiled kernels of lattice_asm calls {kern}")
        (count_, us), = asm
        device_us = us / count_
        plain_ms = per_call_ms(plain_call, LATTICE_PLAIN_CALLS)
        kern, _ = device_kernels(plain_call, LATTICE_PLAIN_CALLS)
        plain_kernels = sum(c for c, _ in kern.values()) / LATTICE_PLAIN_CALLS
        plain_us = sum(us for _, us in kern.values()) / LATTICE_PLAIN_CALLS
        n, item = m.vertices.shape[0], m.vertices.element_size()
        nbytes = (len(st["offsets"]) * n + 4 * n) * item
        bound_ms, bound_by = bound(nbytes, 0)
        out[name] = {"device_us": device_us, "launches_per_call": per_call,
                     "call_ms": call_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "plain_ms": plain_ms, "plain_device_us": plain_us,
                     "plain_kernels": plain_kernels}
        print(f"[34 lattice_asm] {card()} | nx=48 flagship {name}: table "
              f"(27, {n}) and ncut == assemble_vals_lattice_plain bit for bit "
              f"(model's sphere, moved), exactly symmetric, repeated, "
              f"{per_call:g} launch and one fill a call; kernel {device_us:.3f} us device a call, bound "
              f"{bound_ms * 1e3:.3f} us ({bound_by}); call {call_ms:.3f} ms "
              f"(events, mean of {LATTICE_ASM_CALLS}); eager path "
              f"{plain_ms:.3f} ms a call, {plain_us:.1f} us device in "
              f"{plain_kernels:.1f} kernels", flush=True)
    launches = lattice_asm.launches - before
    print(f"[34 lattice_asm] launches {launches} in this phase, max |kernel - "
          f"plain| {max_err} | wall {time.perf_counter() - t0:.2f} s, of the "
          f"whole run {time.perf_counter() - t_start:.2f} s", flush=True)
    return {"launches": launches, "max_abs_err": max_err, **out}

def phase_31_system(nx, dev):
    """Phase 31's inputs built as the whole script builds them (phase 4's
    flagship DIA table, b and dinv; phase 7's ELL table of the same model
    and its indicator rhs), for running the phase alone."""
    from ngsxfem_tpu_torch.solvers.sparse import ELLMatrix

    model, struct, V, _, b, dinv, _ = flagship(nx, dev)
    lv = ell_level(nx, dev, model)
    A = ELLMatrix(torch.as_tensor(lv["struct"]["ell_cols"], device=dev),
                  lv["V"], (model.ndof, model.ndof))
    b_ell = torch.as_tensor(np.where(model.active_dofs, 1.0, 0.0),
                            dtype=torch.float32, device=dev)
    return struct["offsets"], V, b, dinv, A, b_ell


def phase_31(dev, offs, V, b, dinv, A, b_ell, t_start):
    """Phase 31: the functional layer from numpy inputs on ``dev``.  Kernel
    B1 (``dia_cg_fused`` with the reference's ``plane``) on numpy copies of
    phase 4's f32 DIA table ``V``, ``b`` and ``dinv``; kernel B2 through
    ``krylov.cg``, ``minres`` and ``cg_ir`` on phase 7's flagship f32 ELL
    table ``A`` (and its f64 copy) with the numpy right-hand side
    ``b_ell``; ``dia_matvec`` (one launch of ``csrc/dia_spmv.cu``) and the
    lattice transfers (no kernel; the ``[31 no kernel]`` line).
    Each numpy call is bitwise its tensor call, lies on ``dev``, and
    launches the same kernels as many times (B2: once per product).
    Returns the cases' numbers and the B1 (``dia_cg``) and B2
    (``ell_spmv``) launches of its counted calls."""
    from ngsxfem_tpu_torch.solvers import dia_cg, ell_spmv, krylov
    from ngsxfem_tpu_torch.solvers.latticemg import (_interp_axis,
                                                     _restrict_axis)
    from ngsxfem_tpu_torch.solvers.sparse import ELLMatrix, dia_matvec

    t0 = time.perf_counter()
    on_card = dev.type == "cuda"
    where = card() if on_card else "CPU"
    clock = "CUDA events" if on_card else "host clock"
    rng = np.random.default_rng(P31_SEED)
    out = {"dia_cg": 0, "ell_spmv": 0, "cases": []}

    def same(what, res):
        """Every tensor of the numpy call's result on ``dev`` and equal to
        the tensor call's."""
        rn, rt = res["numpy"], res["tensor"]
        rn, rt = ((rn,), (rt,)) if torch.is_tensor(rn) else (rn, rt)
        for a, c in zip(rn, rt):
            if torch.is_tensor(a):
                check(a.device == dev, f"{what}: the numpy call's result is "
                                       f"on {a.device}, not {dev}")
                check(torch.equal(a, c), f"{what}: numpy input != tensor "
                                         f"input")
            else:
                check(a == c, f"{what}: {a} != {c}")

    def record(what, ms, launches, products=None, copy_ms=None):
        out["cases"].append({"call": what, "ms_numpy": ms["numpy"][0],
                             "ms_tensor": ms["tensor"][0],
                             "min_ms_numpy": ms["numpy"][1],
                             "min_ms_tensor": ms["tensor"][1],
                             "launches": launches, "products": products,
                             "copy_ms": copy_ms})
        for k, v in launches.items():
            out[k] += v

    # (a) kernel B1 from numpy, with the reference's plane
    n = V.shape[1]
    plane = round(n ** (2 / 3))
    check(plane ** 3 == n ** 2, f"n={n} is not a cube: no plane size")
    V_np, b_np, dinv_np = (t.cpu().numpy() for t in (V, b, dinv))
    try:
        dia_cg.dia_cg_fused(offs, V_np, b_np, dinv_np, 1, plane + 1)
    except ValueError:
        pass
    else:
        raise RuntimeError(f"check failed: plane {plane + 1} not dividing "
                           f"n={n} did not raise")
    calls = {"numpy": lambda: dia_cg.dia_cg_fused(offs, V_np, b_np, dinv_np,
                                                  CG_ITERS, plane),
             "tensor": lambda: dia_cg.dia_cg_fused(offs, V, b, dinv,
                                                   CG_ITERS, plane)}
    b1 = {}
    for kind, fn in calls.items():
        before = dia_cg.launches
        fn()
        b1[kind] = dia_cg.launches - before
        check(b1[kind] == (1 if on_card else 0),
              f"dia_cg_fused {kind}: {b1[kind]} B1 launches")
    res, ms = p31_pair(calls)
    same("dia_cg_fused", res)
    _, copy_ms = event_ms(lambda: [torch.as_tensor(a, device=dev)
                                   for a in (V_np, b_np, dinv_np)])
    record("dia_cg_fused(offsets, vals_np, b_np, dinv_np, "
           f"{CG_ITERS}, plane={plane})", ms, {"dia_cg": b1["numpy"]},
           copy_ms=copy_ms)
    print(f"[31 B1] {where} | dia_cg_fused PCG-{CG_ITERS} on numpy copies of "
          f"the flagship f32 DIA table {tuple(V.shape)}, b, dinv with plane="
          f"{plane} (plane {plane + 1} raises ValueError): x bitwise the "
          f"tensor call's, on {dev}, {b1['numpy']} B1 launch per call (tensor "
          f"{b1['tensor']}); median (min) ms ({clock}, {P31_REPS} "
          f"interleaved pairs) {p31_ms(ms)}, the three host-to-device "
          f"copies alone {copy_ms:.3f}", flush=True)

    # (b) kernel B2 through the Krylov functions, numpy right-hand side
    A64 = ELLMatrix(A.cols, A.vals.double(), A.shape)
    A64.layout()  # built once, outside the counts and the timings
    A.layout()
    bt = b_ell
    bt_np = bt.cpu().numpy()
    diag = A.diagonal()
    diag_np = diag.cpu().numpy()
    solves = {
        f"krylov.cg(A.matvec, b, M=jacobi_preconditioner(diag), tol=0, "
        f"maxiter={CG_ITERS})": lambda rhs, d: krylov.cg(
            A.matvec, rhs, M=krylov.jacobi_preconditioner(d),
            maxiter=CG_ITERS, tol=0.0),
        f"krylov.minres(A.matvec, b, M=jacobi_preconditioner(diag), tol=0, "
        f"maxiter={CG_ITERS})": lambda rhs, d: krylov.minres(
            A.matvec, rhs, M=krylov.jacobi_preconditioner(d),
            maxiter=CG_ITERS, tol=0.0),
        f"krylov.cg_ir(A32.matvec, A64.matvec, b, M=jacobi_preconditioner("
        f"diag), outer={IR_OUTER}, inner={IR_INNER})": lambda rhs, d:
            krylov.cg_ir(A.matvec, A64.matvec, rhs,
                         M=krylov.jacobi_preconditioner(d), outer=IR_OUTER,
                         inner=IR_INNER),
    }
    lines = []
    for name, solve in solves.items():
        calls = {"numpy": lambda s=solve: s(bt_np, diag_np),
                 "tensor": lambda s=solve: s(bt, diag)}
        counts = {}
        for kind, fn in calls.items():
            ell_spmv.launches = 0
            with counted_ell_products() as cnt:
                fn()
            counts[kind] = (ell_spmv.launches, cnt.products)
            check(cnt.products > 0 and ell_spmv.launches
                  == (cnt.products if on_card else 0),
                  f"{name} {kind}: {ell_spmv.launches} B2 launches for "
                  f"{cnt.products} products")
        check(counts["numpy"] == counts["tensor"],
              f"{name}: numpy (launches, products) {counts['numpy']} != "
              f"tensor {counts['tensor']}")
        res, ms = p31_pair(calls)
        same(name, res)
        _, copy_ms = event_ms(lambda: [torch.as_tensor(a, device=dev)
                                       for a in (bt_np, diag_np)])
        launches, products = counts["numpy"]
        record(name, ms, {"ell_spmv": launches}, products, copy_ms)
        lines.append(f"{name.split('(')[0]}: bitwise, {launches} B2 launches "
                     f"= {products} products (tensor call the same), ms "
                     f"{p31_ms(ms)} / copies {copy_ms:.3f}")
    print(f"[31 B2] {where} | flagship f32 ELL nx={NX} {tuple(A.vals.shape)} "
          f"(and its f64 copy for cg_ir), numpy b and diag, results on {dev}, "
          f"median (min) ms ({clock}, {P31_REPS} interleaved pairs): "
          + "; ".join(lines), flush=True)

    # (c) dia_matvec (its own kernel) and the lattice transfers (none)
    x_np = rng.standard_normal(n).astype(np.float32)
    nc = P31_LAT_NX + 1
    c_np = rng.standard_normal((nc,) * 3)
    f_np = rng.standard_normal(((2 * nc - 1),) * 3)
    xt, ct, ft = (torch.as_tensor(a, device=dev) for a in (x_np, c_np, f_np))

    def transfer(fn, a):
        for ax in range(3):
            a = fn(a, ax)
        return a

    plain = {
        "dia_matvec(offsets, vals, x)": {
            "numpy": lambda: dia_matvec(offs, V_np, x_np),
            "tensor": lambda: dia_matvec(offs, V, xt)},
        f"_interp_axis x3 ({nc}^3 -> {2 * nc - 1}^3)": {
            "numpy": lambda: transfer(_interp_axis, c_np),
            "tensor": lambda: transfer(_interp_axis, ct)},
        f"_restrict_axis x3 ({2 * nc - 1}^3 -> {nc}^3)": {
            "numpy": lambda: transfer(_restrict_axis, f_np),
            "tensor": lambda: transfer(_restrict_axis, ft)},
    }
    lines = []
    for name, calls in plain.items():
        res, ms = p31_pair(calls)
        same(name, res)
        record(name, ms, {})
        lines.append(f"{name}: bitwise, ms {p31_ms(ms)}")
    print(f"[31 no kernel] {where} | numpy inputs, results on {dev}, median "
          f"(min) ms ({clock}, {P31_REPS} interleaved pairs): "
          + "; ".join(lines), flush=True)
    print(f"[31 whole] launches of phase 31's counted calls: B1 "
          f"{out['dia_cg']}, B2 {out['ell_spmv']}; wall of phase 31 "
          f"{time.perf_counter() - t0:.2f} s, of the whole run "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    return out


def main():
    # 1. environment
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from ngsxfem_tpu_torch.kernels import build
    from ngsxfem_tpu_torch.models import lattice_asm
    from ngsxfem_tpu_torch.solvers import dia_cg, dia_spmv, ell_spmv
    from ngsxfem_tpu_torch.solvers.krylov import cg, cg_ir
    from ngsxfem_tpu_torch.solvers.sparse import dia_matvec

    t_start = time.perf_counter()
    gpu = card()
    dev = torch.device("cuda", 0)
    print(f"[1 env] {gpu} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| devices {torch.cuda.device_count()}", flush=True)

    # 2. build, one nvcc per source, all started together: the five
    # kernels and the row-major ELL kernel that B2 replaced (the "before" of
    # its timings)
    t0 = time.perf_counter()
    rowmajor = os.path.join(TOOLS, "torch_ell_spmv_rowmajor.cu")
    built = build.build_all(["dia_cg", "ell_spmv", "coo_ell", "dia_spmv",
                             "lattice_asm", "ell_spmv_rowmajor"],
                            {"ell_spmv_rowmajor": rowmajor})
    parts = []
    for name, (so, build_s, log) in built.items():
        regs = sorted({ln.split("Used ")[1].split(" registers")[0]
                       for ln in log.splitlines() if "registers" in ln})
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill" in ln})
        parts.append(f"{name} -> {so.rsplit('/', 1)[-1]} in "
                     f"{build_s:.2f} s (registers per kernel: "
                     f"{', '.join(regs) or 'reused build'}; "
                     f"{' / '.join(spills) or 'no spill report'})")
    b2_info = ell_spmv.kernel_info(dev)
    print(f"[2 build] B2 sell32_spmv_kernel (registers, static shared memory "
          f"B, local memory B per thread): f32 {b2_info['float32']}, f64 "
          f"{b2_info['float64']}", flush=True)
    info = dia_cg.device_info(dev)
    print(f"[2 build] {'; '.join(parts)}; wall {time.perf_counter() - t0:.2f} s"
          f" | dia_cg kernel: {info['registers']} registers, "
          f"{info['static_smem']} B static shared memory, {info['local_bytes']}"
          f" B local memory per thread; {info['sm_count']} SMs, "
          f"{info['smem_bytes']} B dynamic shared memory per block, "
          f"cooperative launch {bool(info['cooperative'])}", flush=True)

    # every ELL table built on the card from here to phase 31 is held to the
    # plain version and to_ell on the CPU, between phases
    audit = to_ell_audit().__enter__()

    # 3. kernel against its plain version on the card
    t0 = time.perf_counter()
    before = dia_cg.launches
    cases = []
    plans = []
    kept = {}  # nx -> lattice level, reused by phase 12
    for nx in KERNEL_NX:
        m3, struct, V, _, b, dinv, _ = flagship(nx, dev)
        kept[nx] = lattice_level(m3, struct, V)
        offs = struct["offsets"]
        cases += dia_kernel_vs_plain(f"nx={nx}", offs, V, b, dinv, KERNEL_ITERS)
        if nx >= NX:
            plans.append(f"nx={nx} n={V.shape[1]}: "
                         + dia_cg.cuda_plan(offs, V.shape[1], dev).describe())
    rng = np.random.default_rng(2027)
    for dim in (1, 2, 3):
        for n in (1, 257, 100_003):
            offs = lattice_offsets(dim, max(2, round(n ** (1 / dim))))
            cases += dia_kernel_vs_plain(f"random {dim}D n={n}", offs,
                                         *random_dia(rng, n, offs, dev),
                                         KERNEL_ITERS)
    # larger than the shared memory of the grid: only part of the operator
    # (coefficients, the vectors, then the p window) is staged
    for n, w in ((1_000_003, 101), (2_146_689, 129)):
        offs = lattice_offsets(3, w)
        plan = dia_cg.cuda_plan(offs, n, dev)
        check(plan.staged_terms < len(offs), f"n={n}: the plan stages all")
        plans.append(f"random 3D n={n}: " + plan.describe())
        cases += dia_kernel_vs_plain(f"random 3D n={n}", offs,
                                     *random_dia(rng, n, offs, dev), (1, 12))
    try:
        dia_cg.dia_cg_fused([-1, 0, 2], V[:3], b, dinv, 1)
    except ValueError:
        pass
    else:
        raise RuntimeError("check failed: asymmetric offsets did not raise")
    check(dia_cg.launches > before, "kernel launch counter did not move")
    worst_rel = max(c[2] for c in cases)
    worst_abs = max(c[3] for c in cases)
    n_bitwise = sum(1 for c in cases if c[3] == 0.0)
    max_abs_err = max(c[3] for c in cases if c[0] == f"nx={NX}")
    print(f"[3 kernel] {len(cases)} cases (flagship nx={list(KERNEL_NX)} "
          f"and seeded random tables, iters {list(KERNEL_ITERS)}): worst rel "
          f"{worst_rel:.3e} <= {KERNEL_TOL}, max|x_k - x_p| {worst_abs:.3e} "
          f"(at nx={NX} {max_abs_err:.3e}), kernel == plain bitwise in "
          f"{n_bitwise}/{len(cases)} cases, bitwise repeatable, asymmetric "
          f"offsets raise, {dia_cg.launches - before} launches, "
          f"wall {time.perf_counter() - t0:.2f} s", flush=True)
    for line in plans:
        print(f"[3 plan] {line}", flush=True)
    del V, b, dinv, m3

    # 4. the DIA path, launch counters reset just before it
    dia_cg.launches = 0
    ell_spmv.launches = 0
    dia_spmv.launches = 0
    lattice_asm.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, struct, V, ncut, b, dinv, setup_s = flagship(NX, dev)
    lattice_asm_launches = lattice_asm.launches
    check(lattice_asm_launches == 1,
          f"the flagship's one assembly launched lattice_asm "
          f"{lattice_asm_launches} times")
    offs = struct["offsets"]
    x, res = dia_cg.dia_cg_fused(offs, V, b, dinv, CG_ITERS)
    V64 = V.double()
    mv32 = lambda v: dia_matvec(offs, V, v)
    mv64 = lambda v: dia_matvec(offs, V64, v)
    x64, res64 = cg_ir(mv32, mv64, b, M=lambda r: dinv * r,
                       outer=IR_OUTER, inner=IR_INNER)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dia_cg.launches
    check(launches > 0, "the DIA path launched the dia_cg kernel no time")
    # cg_ir's products: per outer step the inner PCG's initial residual and
    # one a step, then the f64 residual
    dia_spmv_launches = dia_spmv.launches
    ir_products = IR_OUTER * (IR_INNER + 1) + IR_OUTER
    check(dia_spmv_launches == ir_products,
          f"cg_ir launched dia_spmv {dia_spmv_launches} times for "
          f"{ir_products} DIA products")

    check(model.mesh.ne == 663_552 and model.ndof == 117_649,
          f"mesh size ne={model.mesh.ne} ndof={model.ndof}")
    lset = model.lset.cpu().numpy()
    lset = np.where(np.abs(lset) < 1e-14, np.float32(1e-14), lset)
    lv = lset[model.elements]  # eps-guarded as the reference guards it
    ncut_host = int(((lv < 0).any(1) & (lv > 0).any(1)).sum())
    check(int(ncut) == ncut_host, f"ncut {int(ncut)} != host count {ncut_host}")
    check(is_symmetric(V, offs), "DIA table is not exactly symmetric")
    bn = float(torch.linalg.vector_norm(b))
    rel50 = float(res) / bn
    _, res1 = dia_cg.dia_cg_fused(offs, V, b, dinv, 1)
    rel1 = float(res1) / bn
    check(np.isfinite(rel50) and rel50 < rel1,
          f"PCG-{CG_ITERS} residual {rel50} not below 1-iteration {rel1}")
    xr, _, _ = cg(mv32, b, M=lambda r: dinv * r, maxiter=CG_ITERS, tol=0.0)
    rel_cg = float(torch.linalg.vector_norm(x - xr)
                   / torch.linalg.vector_norm(xr).clamp_min(1e-30))
    check(rel_cg <= KERNEL_TOL, f"kernel x vs krylov.cg: rel {rel_cg}")
    ir_rel = float(res64) / float(torch.linalg.vector_norm(b.double()))
    check(ir_rel <= SOLVE_TOL, f"cg_ir true f64 relative residual {ir_rel}")
    print(f"[4 main] nx={NX} ne={model.mesh.ne} ndof={model.ndof} ncut={int(ncut)} "
          f"(host {ncut_host}), DIA {tuple(V.shape)} exactly symmetric, "
          f"PCG-{CG_ITERS} rel res {rel50:.4e} (1 iter {rel1:.4e}), kernel vs "
          f"krylov.cg rel {rel_cg:.3e}, cg_ir true f64 rel res {ir_rel:.3e}, "
          f"dia_cg launches {launches}, dia_spmv launches "
          f"{dia_spmv_launches} == cg_ir's products, wall {main_s:.2f} s",
          flush=True)

    # 5. times on the card
    t0 = time.perf_counter()
    asm_ms = time_ms(lambda: model.assemble_vals_lattice(model.vertices,
                                                         model.lset, struct))
    pcg_ms = time_ms(lambda: dia_cg.dia_cg_fused(offs, V, b, dinv, CG_ITERS))
    plain_ms = time_ms(lambda: dia_cg.dia_cg_fused_plain(offs, V, b, dinv,
                                                         CG_ITERS))
    cg_ms = time_ms(lambda: cg(mv32, b, M=lambda r: dinv * r,
                               maxiter=CG_ITERS, tol=0.0))
    ir_ms = time_ms(lambda: cg_ir(mv32, mv64, b, M=lambda r: dinv * r,
                                  outer=IR_OUTER, inner=IR_INNER))
    eps = model.mesh.ne / ((asm_ms + pcg_ms) / 1e3)
    dev_us = {}
    for iters in (0, CG_ITERS):
        kern, _ = device_kernels(
            lambda it=iters: dia_cg.dia_cg_fused(offs, V, b, dinv, it), 5)
        names = list(kern)
        check(len(names) == 1 and "dia_cg" in names[0] and kern[names[0]][0] == 5,
              f"PCG-{iters}: expected one dia_cg device kernel per call, got "
              f"{ {k[:60]: c for k, (c, _) in kern.items()} }")
        dev_us[iters] = kern[names[0]][1] / 5
    per_iter_us = (dev_us[CG_ITERS] - dev_us[0]) / CG_ITERS
    print(f"[5 times] {card()} | host setup {setup_s:.3f} s | assembly "
          f"{asm_ms:.3f} ms | PCG-{CG_ITERS} kernel {pcg_ms:.3f} ms | "
          f"PCG-{CG_ITERS} plain (dia_cg_fused_plain) {plain_ms:.3f} ms | "
          f"PCG-{CG_ITERS} krylov.cg+dia_matvec {cg_ms:.3f} ms | cg_ir "
          f"{ir_ms:.3f} ms | assembly+PCG-{CG_ITERS} {eps:.4g} elements/s",
          flush=True)
    print(f"[5 pcg profile] {card()} | one dia_cg device kernel per call | "
          f"device time PCG-{CG_ITERS} {dev_us[CG_ITERS]:.3f} us, PCG-0 "
          f"{dev_us[0]:.3f} us, per iteration {per_iter_us:.3f} us "
          f"({dia_cg.cuda_plan(offs, model.ndof, dev).barriers_per_iter} grid "
          f"barriers per iteration) | wall {time.perf_counter() - t0:.2f} s",
          flush=True)

    # 6. the ELL kernel against its plain versions on the card
    before = ell_spmv.launches
    t0 = time.perf_counter()
    st48 = model.ell_structure()
    V48, _ = model.assemble_vals_soa1(model.vertices, model.lset, st48)
    cols48 = torch.as_tensor(st48["ell_cols"], device=dev)
    rng = np.random.default_rng(2026)
    x48 = rng.standard_normal(model.ndof)
    cases = [(f"nx={NX} {dt}", V48.to(dt).contiguous(), cols48,
              torch.as_tensor(x48, dtype=dt, device=dev))
             for dt in (torch.float32, torch.float64)]
    ell_err, L48 = ell_kernel_vs_plain(cases[:1])
    for dt in (torch.float32, torch.float64):
        for K in (1, 2, 3, 7, 16, 25, 32, 60, 64):
            for n in (0, 1, 31, 32, 33, 257, 100_003):
                cases.append((f"random n={n} K={K} {dt}",
                              *random_ell(rng, n, K, n + 5, dt, dev)))
        cases.append((f"NaN-poisoned n=1000 K=24 {dt}",
                      *random_ell(rng, 1000, 24, 1005, dt, dev, nan=True)))
    ell_err = max(ell_err, ell_kernel_vs_plain(cases)[0])
    vals32, _, x32 = cases[0][1:]
    vn, cn, xn = cases[-1][1:]
    yn = ell_spmv.ell_matvec(vn, cn, xn)  # a raw call: a throwaway layout
    check(bool(torch.isnan(yn).all()), "a NaN-poisoned table's product "
                                       "is not NaN in every row")
    built_before = ell_spmv.layouts_built
    ell_spmv.ell_matvec(vals32, cols48, x32)
    check(ell_spmv.layouts_built == built_before + 1,
          "a raw CUDA call did not build (and count) a layout")
    for what, args in (
            ("int64 cols", (vals32, cols48.long(), x32)),
            ("wrong shape", (vals32, cols48[:-1], x32)),
            ("CPU x with CUDA vals", (vals32, cols48, x32.cpu())),
            ("a layout of another table", (vals32[:-1].contiguous(),
                                           cols48[:-1].contiguous(),
                                           x32, L48))):
        try:
            ell_spmv.ell_matvec(*args)
        except ValueError:
            pass
        else:
            raise RuntimeError(f"check failed: {what} did not raise")
    check(ell_spmv.launches > before, "ell_spmv launch counter did not move")
    print(f"[6 ell kernel] nx={NX} ELL {tuple(V48.shape)} f32+f64 and "
          f"{len(cases) - 2} seeded tables (K=1..64, n=0..100,003, rows of "
          f"varying length in each slice, all-padding rows, NaN-poisoned): "
          f"kernel == sell_matvec_plain bit for bit, == ell_matvec_plain "
          f"(torch.equal; max|dy| {ell_err:.3e}), bitwise repeatable, bad "
          f"inputs raise, a raw call builds its layout; nx={NX} f32 layout: "
          f"{slice_stats(L48)}; {ell_spmv.launches - before} launches, "
          f"wall {time.perf_counter() - t0:.2f} s", flush=True)
    del cases, V48, cols48, L48, vn, cn, xn

    # 7. the ELL path, launch counters reset just before it.  Its tables
    # are assembled as a user's call assembles them, in a fixed order
    # (ScatterPlan), with no global flag set.
    dia_cg.launches = 0
    ell_spmv.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ell = ell_path(dev, model, dict(struct, V=V), x)
    ell_main_s = time.perf_counter() - t0
    ell_launches = ell_spmv.launches
    dia_launches_ell = dia_cg.launches
    check(ell_launches > 0, "the ELL path launched the ell_spmv kernel no time")
    fine = ell["levels"][-1]
    check(int(fine["ncut"]) == ncut_host,
          f"ELL ncut {int(fine['ncut'])} != host count {ncut_host}")
    check(ell["rel_op"] <= ELL_DIA_TOL,
          f"ELL vs DIA operator: rel {ell['rel_op']}")
    check(ell["rel_dia_ell"] <= ELL_DIA_TOL,
          f"ELL form of the DIA table vs DIA operator: rel {ell['rel_dia_ell']}")
    check(ell["rel_cg"] <= KERNEL_TOL,
          f"Jacobi-CG-{CG_ITERS} on ELL vs dia_cg kernel: rel {ell['rel_cg']}")
    b_ell, x_mg = ell["b"], ell["x"]
    bn_ell = float(torch.linalg.vector_norm(b_ell))
    mg_rel = float(ell["res"]) / bn_ell
    check(np.isfinite(mg_rel) and mg_rel <= MG_TOL,
          f"MG-CG recursion rel res {mg_rel} > {MG_TOL}")
    check(ell["iters"] <= MG_MAX_ITERS,
          f"MG-CG took {ell['iters']} > {MG_MAX_ITERS} iterations")
    A = ell["A"]
    r64 = b_ell.double() - ell_spmv.ell_matvec(A.vals.double(), A.cols,
                                               x_mg.double())
    true_rel = float(torch.linalg.vector_norm(r64)
                     / torch.linalg.vector_norm(b_ell.double()))
    check(true_rel <= MG_TRUE_TOL, f"MG-CG true f64 rel res {true_rel}")
    print(f"[7 ell path] levels nx={list(MG_NX)} ndof="
          f"{[lv['model'].ndof for lv in ell['levels']]} ELL K="
          f"{[lv['struct']['K'] for lv in ell['levels']]}, ncut {int(fine['ncut'])}, "
          f"ELL vs DIA operator rel {ell['rel_op']:.3e}, Jacobi-CG-{CG_ITERS} "
          f"vs dia_cg kernel: on the ELL form of the DIA table rel "
          f"{ell['rel_cg']:.3e}, on the assembled ELL table rel "
          f"{ell['rel_cg_asm']:.3e} (true rel res {ell['res50'][1]:.4e} vs "
          f"the kernel's {ell['res50'][0]:.4e}), MG-CG "
          f"{ell['iters']} iterations to rel res {mg_rel:.3e}, true f64 rel "
          f"res {true_rel:.3e}, ell_spmv launches {ell_launches}, dia_cg "
          f"launches {dia_launches_ell}, host: levels {ell['levels_s']:.2f} s, "
          f"MG setup {ell['mg_setup_s']:.2f} s, prepare_host "
          f"{ell['prepare_s']:.3f} s, wall {ell_main_s:.2f} s", flush=True)
    t0 = time.perf_counter()
    rep_iters = repeat_assembly(ell)
    print(f"[7 repeat] assemble_vals_soa1 nx={NX} f32 five more times on the "
          f"card, no global flag: every table bitwise equal to the first; "
          f"MG-CG iterations {rep_iters}; the MG-CG solve built "
          f"{ell['layouts']} layouts for its {ell['layouts']} tables, none "
          f"per product; wall {time.perf_counter() - t0:.2f} s", flush=True)

    # 8. ELL-path times on the card
    t0 = time.perf_counter()
    xr = ell["xr"]
    b2_48 = b2_timed(f"flagship ELL nx={NX} f32", A, xr)
    b2_48["err"] = ell_err
    n, K = A.vals.shape
    asm_lv_ms = [time_ms(lambda lv=lv: lv["model"].assemble_vals_soa1(
        lv["model"].vertices, lv["model"].lset, lv["struct"]))
        for lv in ell["levels"]]
    asm_txt = ", ".join(f"nx={lv['nx']} {t:.3f} ms"
                        for lv, t in zip(ell["levels"], asm_lv_ms))
    mgcg_ms = time_ms(ell["mgcg"], reps=3)
    kern, mg_wall = device_kernels(ell["mgcg"], 1)
    mg_busy = sum(us for _, us in kern.values()) / 1e3
    mg_kernels = sum(c for c, _ in kern.values())
    mg_top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:4]
    ell_spmv.launches = 0
    dia_cg.launches = 0
    ell["mgcg"]()
    per_solve = {"ell_spmv": ell_spmv.launches, "dia_cg": dia_cg.launches}
    print(f"[8 ell times] {card()} | ELL SpMV nx={NX} ({n} x {K} f32): "
          f"{b2_text(b2_48)} | assembly_soa1 per level {asm_txt} "
          f"| prepare_host {ell['prepare_s']:.3f} s | MG-CG {mgcg_ms:.3f} ms, "
          f"{ell['iters']} iterations | launches per MG-CG solve {per_solve}, "
          f"layouts built by the solve path {ell['layouts']} "
          f"(= its tables)", flush=True)
    fl = ell["levels"][-1]
    kern, asm_wall = device_kernels(lambda: fl["model"].assemble_vals_soa1(
        fl["model"].vertices, fl["model"].lset, fl["struct"]), 1)
    asm_busy = sum(us for _, us in kern.values()) / 1e3
    print(f"[8 assembly profile] assemble_vals_soa1 nx={NX}: "
          f"{sum(c for c, _ in kern.values())} device kernels, device busy "
          f"{asm_busy:.3f} ms of {asm_wall:.3f} ms wall (idle share "
          f"{1 - asm_busy / asm_wall:.3f})", flush=True)
    print(f"[8 mg-cg profile] one solve: {mg_kernels} device kernels, device "
          f"busy {mg_busy:.3f} ms of {mg_wall:.3f} ms wall (idle share "
          f"{1 - mg_busy / mg_wall:.3f}); top kernels by device time: "
          + "; ".join(f"{k[:60]} x{c} {us / 1e3:.3f} ms" for k, (c, us) in mg_top)
          + f"; wall of phase 8 {time.perf_counter() - t0:.2f} s", flush=True)
    audit.check("phases 3-8")

    # 9. general cut quadrature and Integrate on the card (f64)
    import ngsxfem_tpu_torch as T

    del ell
    torch.cuda.synchronize()
    peak_gib(dev)
    t0 = time.perf_counter()
    n_exact, worst_exact = cut_exactness(dev)
    exact_s = time.perf_counter() - t0
    print(f"[9 exactness] {n_exact} cases of the reference suite (segm/trig/"
          f"quad/tet/hex, orders 2-8, NEG/POS/IF, eps-challenges, TPMC, the "
          f"plane on 256 x 256 trig and quad meshes): worst error / bound "
          f"{worst_exact:.3e}, peak memory {peak_gib(dev):.2f} GiB, wall "
          f"{exact_s:.2f} s", flush=True)
    t0 = time.perf_counter()
    rows, (mesh64, lset64) = sphere_levels(dev)
    for et, nxs, err, eoc, peak in rows:
        print(f"[9 sphere] {et} nx={list(nxs)} order 4: NEG volume errors "
              + ", ".join(f"{e:.3e}" for e in err["NEG"])
              + f" (EOC {eoc['NEG']:.3f}), IF area errors "
              + ", ".join(f"{e:.3e}" for e in err["IF"])
              + f" (EOC {eoc['IF']:.3f}); NEG + POS = 1 and element_wise sums "
              f"to 1e-12; peak memory {peak:.2f} GiB", flush=True)
    lset64_32 = T.GridFunction(lset64.space, dtype=torch.float32)
    lset64_32.vec.data = lset64.vec.data
    f32_rel = {}
    for dt in ("NEG", "IF"):
        a64 = T.Integrate({"levelset": lset64, "domain_type": getattr(T, dt)},
                          1.0, mesh64, order=4)
        a32 = T.Integrate({"levelset": lset64_32, "domain_type": getattr(T, dt)},
                          1.0, mesh64, order=4)
        f32_rel[dt] = abs(a32 - a64) / a64
        check(f32_rel[dt] <= 1e-5, f"f32 vs f64 {dt} at tets nx=64: {f32_rel[dt]}")
    mesh = T.MakeStructured2DMesh(quads=False, nx=32, ny=32)
    lsetp1 = T.GridFunction(T.H1(mesh, order=1))
    T.InterpolateToP1(T.sqrt(T.x * T.x + T.y * T.y) - 0.5, lsetp1)
    area = T.Integrate({"levelset": lsetp1, "domain_type": T.NEG},
                       T.CoefficientFunction(1.0), mesh, order=4)
    check(abs(area - np.pi / 16) < 1e-3 and lsetp1.vec.data.is_cuda,
          f"Quick start area {area}")
    peaks = {"f32 vs f64 and Quick start": peak_gib(dev)}
    grad, fd = autograd_check(dev)
    peaks["autograd"] = peak_gib(dev)
    counts, nfacets = cutinfo_check(mesh64, lset64)
    peaks["CutInfo"] = peak_gib(dev)
    sphere_s = time.perf_counter() - t0
    print(f"[9 integrate] tets nx=64 ({mesh64.ne} elements): f32 vs f64 rel "
          f"NEG {f32_rel['NEG']:.3e} IF {f32_rel['IF']:.3e}; Quick start area "
          f"{area:.12f} (pi/16 = {np.pi / 16:.12f}); autograd dV/dr at r=0.31 "
          f"{grad:.10f} vs central difference {fd:.10f} (4 pi r^2 = "
          f"{4 * np.pi * 0.31 ** 2:.6f}); CutInfo NEG/POS/IF {counts} = host "
          f"count, {nfacets} facets between HASNEG and IF; peak memory GiB "
          + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items())
          + f"; wall {sphere_s:.2f} s", flush=True)

    # 10. the quadrature path of the flagship at nx=48
    t0 = time.perf_counter()
    q = quad_flagship(dev, model, struct, V)
    k, res, true64, bn = q["solve"]
    print(f"[10 quad flagship] nx={NX}: apply vs DIA operator rel f64 "
          f"{q['op_float64']:.3e} f32 {q['op_float32']:.3e}; sum(rhs) "
          f"{q['rhs_sum'][0]:.15f} vs Integrate(NEG, 1) {q['rhs_sum'][1]:.15f}; "
          f"x.rhs {q['rhs_proj'][0]:.12e} vs Integrate(NEG, u_x) "
          f"{q['rhs_proj'][1]:.12e}; solve() f32: {k} iterations, recursion "
          f"res {res:.4e} vs true f64 res {true64:.4e} (||b|| {bn:.4e}), "
          f"{q['solve_s']:.2f} s; order 2 nx=24 ({q['sym2'][0]} dofs) f32 "
          f"symmetry {q['sym2'][1]:.3e}; peak memory {peak_gib(dev):.2f} "
          f"GiB; wall {time.perf_counter() - t0:.2f} s", flush=True)

    # 11. times on the card
    t0 = time.perf_counter()
    timed = []
    for dt, gf in (("f64", lset64), ("f32", lset64_32)):
        for dom in ("NEG", "IF"):
            ld = {"levelset": gf, "domain_type": getattr(T, dom)}
            timed.append((f"Integrate {dom} order 4 tets nx=64 {dt}",
                          profiled(lambda ld=ld: T.Integrate(ld, 1.0, mesh64,
                                                             order=4))))
    timed.append(("CutInfo tets nx=64 f64",
                  profiled(lambda: T.CutInfo(mesh64, lset64))))
    timed.append((f"UnfittedPoisson.elmats nx={NX} f32", profiled(
        lambda: model.elmats(model.vertices, model.lset))))
    xa = torch.ones(model.ndof, dtype=torch.float32, device=dev)
    timed.append((f"UnfittedPoisson.apply nx={NX} f32", profiled(
        lambda: model.apply(model.vertices, model.lset, xa))))
    mv = model.operator(model.vertices, model.lset)
    timed.append((f"operator matvec alone nx={NX} f32", profiled(lambda: mv(xa))))
    timed.append((f"UnfittedPoisson.solve() nx={NX} f32", profiled(model.solve)))
    for name, (ms, nk, busy, idle, top) in timed:
        print(f"[11 times] {card()} | {name}: {ms:.3f} ms (median of 5), "
              f"{nk} device kernels, device busy {busy:.3f} ms, idle share "
              f"{idle:.3f}; top: {top}", flush=True)
    print(f"[11 times] peak memory {peak_gib(dev):.2f} GiB; wall "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    audit.check("phases 9-11")

    # 12. lattice multigrid on the DIA path (plain PyTorch: the reference has
    # no TPU kernel on it), f32 and f64, then the larger hierarchy once
    del q, mv, xa
    torch.cuda.synchronize()
    peak_gib(dev)
    t0 = time.perf_counter()
    reps = [model.assemble_vals_lattice(model.vertices, model.lset, struct)[0]
            for _ in range(5)]
    check(all(torch.equal(r, V) for r in reps),
          "assemble_vals_lattice does not repeat bit for bit")
    del reps
    kept[NX] = lattice_level(model, struct, V)
    lv32 = [kept[nx] if nx in kept else new_lattice_level(nx, dev, torch.float32)
            for nx in LMG_NX]
    lmg32 = lattice_mg(lv32, torch.float32, dev)
    again = lattice_mg(lv32, torch.float32, dev, jacobi=False)
    check(again["iters"] == lmg32["iters"] and torch.equal(again["x"], lmg32["x"]),
          "f32 MG-CG does not repeat bit for bit")
    f64 = native_f64(dev, V, b)     # phase 13, reported below
    lv64 = [new_lattice_level(nx, dev, torch.float64) for nx in LMG_NX[:-1]]
    lv64.append(lattice_level(f64["model"], f64["struct"], f64["V"]))
    lmg64 = lattice_mg(lv64, torch.float64, dev)
    lv_big = [kept[nx] if nx in kept else new_lattice_level(nx, dev, torch.float32)
              for nx in LMG_NX_BIG]
    lmg_big = lattice_mg(lv_big, torch.float32, dev)
    for r in (lmg32, lmg64, lmg_big):
        print(f"[12 lattice mg] nx={r['nxs']} {str(r['dtype'])[6:]}: coarse "
              f"inverse {r['n0']} x {r['n0']} on the device, "
              f"prepare_safe's guard passed, max|I - A0 X| {r['ainv_res']:.3e}, prepare_safe "
              f"{r['prepare_s']:.3f} s; MG-CG {r['iters']} iterations to rel "
              f"res {r['rel']:.3e}, true f64 rel res {r['true_rel']:.3e}; "
              f"Jacobi-CG {r['jacobi_iters']} iterations to rel res "
              f"{r['jacobi_rel']:.3e} (maxiter {JACOBI_MAXITER})", flush=True)
    print(f"[12 lattice mg] f32 table at nx={NX} bitwise equal over five "
          f"assemblies, MG-CG on it bitwise repeatable; peak memory "
          f"{peak_gib(dev):.2f} GiB; wall {time.perf_counter() - t0:.2f} s "
          f"(phase 13's solves included)", flush=True)

    # 13. the flagship in native f64
    print(f"[13 native f64] nx={NX}: f64 table within {f64['dv']:.3e} max|V| "
          f"of the f32 one, exactly symmetric, ncut {f64['ncut']}; f64 "
          f"Jacobi-PCG {f64['pcg_iters']} iterations, true rel res "
          f"{f64['pcg_rel']:.3e}; cg_ir true rel res {f64['ir_rel']:.3e}; "
          f"solutions differ by rel {f64['dx']:.3e}", flush=True)

    # 14. the public API, launch counters reset just before it
    dia_cg.launches = 0
    ell_spmv.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    api = public_api(T, dev, f64["model"], f64["struct"], f64["V"])
    api_launches = ell_spmv.launches
    check(api_launches > 0, "the public-API path launched ell_spmv no time")
    b2_api = api["b2"]
    print(f"[14 public api] examples.fictdom3d nx={list(API_NX)} L2 errors "
          + ", ".join(f"{e:.4e}" for e in api["errs"])
          + f" (EOC {', '.join(f'{e:.3f}' for e in api['eocs'])}); nx={NX}: "
          f"{api['ntriplets']} COO triplets, ELL K={api['K']}, "
          f"{api['nfree']} free dofs, a.mat symmetric to {api['asym']:.3e}, "
          f"named direct solve (umfpack) {api['lu_s']:.2f} s (host), 'cg' "
          f"solve {api['cg_iters']} iterations = {api['cg_products']} "
          f"products = {api['cg_launches']} ell_spmv launches, direct vs "
          f"'cg' rel {api['dsol']:.3e}; default Inverse(): path "
          f"{api['default_path']}, {api['default_s']:.3f} s wall (the named "
          f"LU {api['lu_s']:.3f} s), {api['default_iters']} iterations = "
          f"{api['default_products']} products = {api['default_launches']} "
          f"ell_spmv launches, vs the named LU rel "
          f"{api['dsol_default']:.3e}; layouts built by both solves "
          f"{api['layouts']} (one table); B2 on this table "
          f"({api['nrows']} x {api['K']} f64): kernel == plain bitwise on a "
          f"seeded x and on the free-masked load (max|dy| "
          f"{b2_api['err']:.3e}), {b2_text(b2_api)}; forms operator vs "
          f"UnfittedPoisson's DIA operator on active dofs rel "
          f"{api['vs_model']:.3e}; fictdom_ghostpen nx=40 L2 "
          f"{api['fictdom_ghostpen'][0]:.10e} (CPU "
          f"{api['fictdom_ghostpen'][1]:.10e}), cutfem nx=30 L2 "
          f"{api['cutfem'][0]:.10e} (CPU {api['cutfem'][1]:.10e}); ell_spmv "
          f"launches {api_launches}, dia_cg launches {dia_cg.launches}; peak "
          f"memory {peak_gib(dev):.2f} GiB; wall "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 15. times of phases 12-14 on the card
    t0 = time.perf_counter()
    timed = []
    for r, name in ((lmg32, "f32"), (lmg_big, "f32")):
        tag = f"nx={r['nxs'][-1]} {name}"
        timed.append((f"LatticeDIAMG.prepare {tag}", profiled(
            lambda r=r: r["mg"].prepare(r["params"]))))
        mg_prof = profiled(r["mgcg"], reps=3)
        timed.append((f"MG-CG to 1e-8 {tag} ({r['iters']} iterations, "
                      f"{mg_prof[1] / r['iters']:.1f} device kernels per "
                      f"iteration)", mg_prof))
        timed.append((f"Jacobi-CG to 1e-8 {tag} ({r['jacobi_iters']} "
                      f"iterations)", profiled(r["jcg"], reps=1)))
    m64 = f64["model"]
    timed.append((f"assemble_vals_lattice nx={NX} f64", profiled(
        lambda: m64.assemble_vals_lattice(m64.vertices, m64.lset,
                                          f64["struct"]))))
    timed.append((f"f64 Jacobi-PCG nx={NX} ({f64['pcg_iters']} iterations)",
                  profiled(f64["pcg"], reps=3)))
    timed.append((f"cg_ir nx={NX} on the f64 table", profiled(f64["ir"], reps=3)))
    a_form, f_form, free = api["a"], api["f"], api["free"]
    timed.append((f"BilinearForm.Assemble fictdom3d nx={NX} f64",
                  profiled(a_form.Assemble)))
    timed.append((f"LinearForm.Assemble fictdom3d nx={NX} f64",
                  profiled(f_form.Assemble)))
    inv_cg = a_form.mat.Inverse(free, inverse="cg")
    inv_cg * f_form.vec.data   # builds the ELL view once, outside the timing
    timed.append((f"Inverse(inverse='cg') solve nx={NX} ({api['cg_iters']} "
                  f"iterations)", profiled(lambda: inv_cg * f_form.vec.data,
                                           reps=3)))
    for name, (ms, nk, busy, idle, top) in timed:
        print(f"[15 times] {card()} | {name}: {ms:.3f} ms, {nk} device "
              f"kernels, device busy {busy:.3f} ms, idle share {idle:.3f}; "
              f"top: {top}", flush=True)
    print(f"[15 times] {card()} | Inverse() direct solve nx={NX} on the host "
          f"(scipy splu, {api['nfree']} free dofs, timed in phase 14): "
          f"factorize + solve {api['lu_s']:.3f} s, solve again "
          f"{api['lu_again_s']:.3f} s | peak memory "
          f"{peak_gib(dev):.2f} GiB | wall of phase 15 "
          f"{time.perf_counter() - t0:.2f} s, of the whole run "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)

    audit.check("phases 12-15")
    forms48 = a_form.mat  # phase 32's table
    del api, a_form, f_form, inv_cg
    sk, sk_launches = phases_16_17(T, dev, t_start)
    audit.check("phases 16-17")
    iso, iso_launches = phases_18_19(T, dev, t_start)
    audit.check("phases 18-19")
    st_launches = phases_20_21(T, dev, t_start)
    audit.check("phases 20-21")
    mf_launches, mf_tables = phases_22_23(T, dev, t_start, iso)
    audit.check("phases 22-23")
    mg_launches, mesh_launches, mg_tables = phases_24_25(T, dev, t_start)
    audit.check("phases 24-25")
    ad_launches, per_launches, ad_tables = phases_26_27(
        T, dev, t_start, f64["model"], f64["struct"], st48)
    audit.check("phases 26-27")
    sl13_launches, sl13_b2, _, _, (one14, sl14) = phases_28_29(
        dev, t_start, {torch.float32: (model, struct, V),
                       torch.float64: (f64["model"], f64["struct"],
                                       f64["V"])}, st48)
    audit.check("phases 28-29")
    sl15 = phase_30(dev, one14.pop("system"), t_start)
    sl16 = phase_31(dev, offs, V, b, dinv, A, b_ell, t_start)
    audit.check("phases 30-31")
    audit.__exit__()
    sl17 = phase_32(dev, forms48, t_start)
    sl18 = phase_33(dev, offs, V, t_start)
    sl19 = phase_34(dev, {torch.float32: (model, struct),
                          torch.float64: (f64["model"], f64["struct"])},
                    t_start)
    check(sl17["launches_before"] == audit.launching,
          f"coo_ell launched {sl17['launches_before']} times in phases 3-31, "
          f"for {audit.launching} tables with an entry")
    print(f"[to_ell audit] phases 3-31: {audit.tables} tables built on the "
          f"card ({audit.triplets} triplets, the longest stream "
          f"{audit.largest}), {audit.launching} coo_ell launches, all bit "
          f"for bit; checks {audit.seconds:.2f} s", flush=True)

    dia_bound_ms, dia_bound_by = dia_cg_bound(offs, model.ndof, CG_ITERS)
    print(json.dumps({"kernels": [{
        "name": "dia_cg_fused",
        "route": "cuda",
        "source": "ngsxfem_tpu_torch/csrc/dia_cg.cu",
        "replaces": "ngsxfem_tpu/solvers/pallas_cg.py:159",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": pcg_ms,
        "plain_ms": plain_ms,
        "bound_ms": dia_bound_ms,
        "bound_by": dia_bound_by,
        "library_ms": None,
    }, {
        "name": "ell_spmv",
        "route": "cuda",
        "source": "ngsxfem_tpu_torch/csrc/ell_spmv.cu",
        "replaces": "ngsxfem_tpu/solvers/sparse.py:179",
        "launches": ell_launches,
        "max_abs_err": ell_err,
        "ms": b2_48["ms"],
        "device_us": b2_48["dev_us"],
        "before_us": b2_48["before_us"],
        "plain_ms": b2_48["plain_ms"],
        "plain_ell_ms": b2_48["plain_ell_ms"],
        "bound_ms": b2_48["bound"][0],
        "bound_by": b2_48["bound"][1],
        "bound_nnz_ms": b2_48["bound"][0],
        "bound_padded_ms": b2_48["bound_padded"][0],
        "slice_fill": b2_48["fill"],
        "library_ms": b2_48["lib_ms"],
        "launches_public_api": api_launches,
        "public_api_table": b2_record(b2_api),
        "launches_slice6": sk_launches,
        "slice6_tables": [dict(b2_record(b["b2"]), launches=b["launches"])
                          for b in sk["bigs"]],
        "launches_isoparametric": iso_launches,
        "isoparametric_tables": [dict(b2_record(b["b2"]),
                                      launches=b["launches"])
                                 for b in iso],
        "launches_spacetime": st_launches,
        "launches_matrix_free": mf_launches,
        "matrix_free_tables": mf_tables,
        "launches_mg": mg_launches,
        "mg_tables": mg_tables,
        "launches_meshing": mesh_launches,
        "launches_autograd": ad_launches,
        "autograd_tables": ad_tables,
        "launches_periodic": per_launches,
        "launches_slice13": sl13_launches,
        "slice13_tables": [dict(b2_record(sl13_b2), launches=sl13_launches)],
        "launches_slice14": sl14["launches"],
        "launches_slice15": sl15["launches"],
        "launches_slice16": sl16["ell_spmv"],
    }, {
        "name": "coo_ell_place",
        "route": "cuda",
        "source": "ngsxfem_tpu_torch/csrc/coo_ell.cu",
        "replaces": "ngsxfem_tpu/solvers/sparse.py:55 (host numpy; no TPU "
                    "kernel)",
        "launches": sl17["launches"],
        "max_abs_err": 0.0,
        "ms": sl17["ms"],
        "device_us": sl17["device_us"],
        "path_ms": sl17["path_ms"],
        "plain_ms": sl17["plain_ms"],
        "bound_ms": sl17["bound_ms"],
        "bound_by": sl17["bound_by"],
        "library_ms": sl17["library_ms"],
        "table": sl17["table"],
        "launches_whole_run": sl17["launches_before"],
        "audited_tables": audit.tables,
        "audited_triplets": audit.triplets,
        "audited_longest": audit.largest,
    }, {
        "name": "dia_spmv",
        "route": "cuda",
        "source": "ngsxfem_tpu_torch/csrc/dia_spmv.cu",
        "replaces": "ngsxfem_tpu/solvers/sparse.py dia_matvec (jnp code "
                    "that XLA fuses; no TPU kernel)",
        "launches": dia_spmv_launches,
        "max_abs_err": sl18["max_abs_err"],
        "ms": sl18["float32"]["device_us"] / 1e3,
        "device_us": sl18["float32"]["device_us"],
        "plain_ms": sl18["float32"]["plain_ms"],
        "bound_ms": sl18["float32"]["bound_ms"],
        "bound_by": sl18["float32"]["bound_by"],
        "library_ms": None,
        "float32": sl18["float32"],
        "float64": sl18["float64"],
    }, {
        "name": "lattice_asm",
        "route": "cuda",
        "source": "ngsxfem_tpu_torch/csrc/lattice_asm.cu",
        "replaces": "ngsxfem_tpu/models/poisson.py assemble_vals_lattice "
                    "(jnp code that XLA fuses; no TPU kernel)",
        "launches": lattice_asm_launches,
        "max_abs_err": sl19["max_abs_err"],
        "ms": sl19["float32"]["device_us"] / 1e3,
        "device_us": sl19["float32"]["device_us"],
        "plain_ms": sl19["float32"]["plain_ms"],
        "bound_ms": sl19["float32"]["bound_ms"],
        "bound_by": sl19["float32"]["bound_by"],
        "library_ms": None,
        "float32": sl19["float32"],
        "float64": sl19["float64"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
