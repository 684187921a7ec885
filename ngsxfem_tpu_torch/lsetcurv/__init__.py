"""Isoparametric level-set mesh adaptation (counterpart of
``ngsxfem_tpu/lsetcurv``; the space-time adaptation is ROADMAP A13)."""
from .lsetcurv import (  # noqa: F401
    LevelSetMeshAdaptation,
    ProjectShift,
    CalcMaxDistance,
    CalcDistances,
    RefineAtLevelSet,
)
from .shifted import shifted_eval  # noqa: F401
