"""ngsxfem_tpu_torch: the PyTorch/CUDA port of ngsxfem_tpu.

Module layout and function names follow the JAX package ``ngsxfem_tpu``,
which stays the reference the port is tested against.  This package imports
``torch`` and never ``jax`` or ``ngsxfem_tpu``; host tables are numpy, and
every entry point that makes tensors takes an explicit ``device``.

This first slice covers the flagship 3D fictitious-domain Poisson path:
``UnfittedPoisson`` (host setup, ``dia_structure``, lattice assembly into a
DIA table), ``dia_matvec``, the Krylov solvers ``cg``/``cg_ir`` and the
fused Jacobi-PCG ``dia_cg_fused``, which runs a hand-written CUDA kernel for
Hopper on CUDA tensors.
"""
from .config import config
from .models.poisson import UnfittedPoisson
from .solvers.sparse import DIAMatrix, dia_matvec
from .solvers.krylov import cg, cg_ir, jacobi_preconditioner
from .solvers.dia_cg import dia_cg_fused, dia_cg_fused_plain

__all__ = ["config", "UnfittedPoisson", "DIAMatrix", "dia_matvec", "cg",
           "cg_ir", "jacobi_preconditioner", "dia_cg_fused",
           "dia_cg_fused_plain"]
