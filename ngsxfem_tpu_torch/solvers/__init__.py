"""solvers of ngsxfem_tpu_torch (see the package docstring)."""
