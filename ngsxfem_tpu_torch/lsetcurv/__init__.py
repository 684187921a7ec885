"""Isoparametric level-set mesh adaptation, stationary and space-time
(counterpart of ``ngsxfem_tpu/lsetcurv``)."""
from .lsetcurv import (  # noqa: F401
    LevelSetMeshAdaptation,
    ProjectShift,
    CalcMaxDistance,
    CalcDistances,
    RefineAtLevelSet,
)
from .shifted import shifted_eval  # noqa: F401
from .lset_spacetime import LevelSetMeshAdaptation_Spacetime  # noqa: F401
