from .timefe import ScalarTimeFE  # noqa: F401
from .space import (  # noqa: F401
    SpaceTimeFESpace,
    ReferenceTimeVariable,
    tref,
    dt,
    fix_t,
    CreateTimeRestrictedGF,
    RestrictGFInTime,
    SpaceTimeInterpolateToP1,
    TimeFixedCF,
)
