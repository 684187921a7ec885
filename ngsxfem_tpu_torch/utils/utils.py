"""Reference helper functions of the port's examples.

Counterpart of part of ``ngsxfem_tpu/utils/utils.py``: the level-set
geometry zoo ``LevelsetExamples`` with its ``BoundingBoxes`` (the
reference's ``utils/utils.py:5-27``, which the ``lsetgeoms`` example
drives) and ``SpaceTimeWeakSet``, which the CG-in-time heat example calls.
"""
from __future__ import annotations

from math import pi as _pi

from ..cf.coefficient import x, y, z, sqrt, sin, cos, IfPos


def _r2(cx=0.0, cy=0.0, cz=0.0):
    return (x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2


# the reference zoo, same formulas (utils/utils.py:5-18)
LevelsetExamples = {
    # Dziuk/Elliott, Acta Numerica 2013, pp. 373-374
    "cheese": sqrt(
        (x * x - 1) ** 2 + (y * y - 1) ** 2 + (z * z - 1) ** 2
        + (x * x + y * y - 4) ** 2 + (x * x + z * z - 4) ** 2
        + (y * y + z * z - 4) ** 2
    ) - 4,
    # Dziuk/Elliott, Acta Numerica 2013, pp. 318-319
    "dziukelliott": sqrt(
        0.25 * x * x + y * y
        + 4.0 * z * z / ((1 + 0.5 * sin(_pi * x)) * (1 + 0.5 * sin(_pi * x)))
    ) - 1.0,
    # Dziuk '88, Beltrami operator on arbitrary surfaces
    "dziuk88": sqrt((x - z * z) * (x - z * z) + y * y + z * z) - 1.0,
    "sphere": sqrt(x * x + y * y + z * z) - 1.0,
    # Grande/Reusken SINUM 2016 parameters
    "torus": sqrt(z * z + (sqrt(x * x + y * y) - 1.0) ** 2) - 0.6,
    # Lehrenfeld CMAME 2016
    "gyroid": (cos(_pi * x) * sin(_pi * y) + cos(_pi * y) * sin(_pi * z)
               + cos(_pi * z) * sin(_pi * x)),
    # additions beyond the reference zoo (2D workloads):
    "circle": sqrt(x * x + y * y) - 1.0,
    "ellipsoid": sqrt(x * x / 1.69 + y * y + z * z) - 1.0,
    "spheres": IfPos(
        sqrt(_r2(-1.0)) - sqrt(_r2(1.0)),
        sqrt(_r2(1.0)) - 0.75,
        sqrt(_r2(-1.0)) - 0.75,
    ),
}

# [lo..., hi...] boxes matching the reference OrthoBricks (utils/utils.py:20-27)
BoundingBoxes = {
    "cheese": [-2.5, -2.5, -2.5, 2.5, 2.5, 2.5],
    "dziukelliott": [-2.5, -1.5, -1.5, 2.5, 1.5, 1.5],
    "dziuk88": [-2.0, -2.0, -2.0, 2.0, 2.0, 2.0],
    "sphere": [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5],
    "torus": [-2.0, -2.0, -2.0, 2.0, 2.0, 2.0],
    "gyroid": [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0],
    "circle": [-1.2, -1.2, 1.2, 1.2],
    "ellipsoid": [-1.5, -1.2, -1.2, 1.5, 1.2, 1.2],
    "spheres": [-2.0, -1.2, -1.2, 2.0, 1.2, 1.2],
}


def SpaceTimeWeakSet(gf, cf, space):
    """Reference helper (python/__init__.py SpaceTimeWeakSet): set the
    bottom-time-node spatial component of a space-time GridFunction to the
    interpolant of ``cf`` in ``space``."""
    from ..fem.gridfunction import GridFunction

    ndof_s = getattr(gf.space, "ndof_s", None)
    if ndof_s is not None and ndof_s != space.ndof:
        raise ValueError(
            f"SpaceTimeWeakSet: spatial space ndof {space.ndof} does not "
            f"match the space-time spatial block size {ndof_s}")
    tmp = GridFunction(space, device=gf.device, dtype=gf.dtype)
    tmp.Set(cf)
    arr = gf._arr.clone()
    arr[: space.ndof] = tmp._arr
    gf._set_array(arr)
