"""Reference helper functions: level-set zoo and convergence reporting.

Counterpart of ``ngsxfem_tpu/utils/utils.py``: the level-set geometry zoo
``LevelsetExamples`` with its ``BoundingBoxes`` (the reference's
``utils/utils.py:5-27``, which the ``lsetgeoms`` example drives),
``SpaceTimeWeakSet`` (the CG-in-time heat example), the reporting pieces of
``lsetcurving/calcgeomerrors`` (``StatisticContainer``,
``PrintConvergenceTable``) and the deprecated helpers ``kappa`` and
``IsCut`` of the reference's ``python/__init__.py``.
"""
from __future__ import annotations

from math import log as _mlog
from math import pi as _pi

import numpy as np

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


class StatisticContainer:
    """Collects error series over refinements (cf.
    calcgeomerrors.hpp:19-25)."""

    def __init__(self):
        self.errors = {}

    def Add(self, name, value):
        self.errors.setdefault(name, []).append(float(value))

    def __getitem__(self, name):
        return self.errors[name]

    def Print(self, label="something", select="all"):
        """Print convergence tables of the collected series (reference
        python_lsetcurving.cpp:27-45): ``select`` picks "L1", "L2", "max",
        "misc" or "all"."""
        keys = ("L1", "L2", "max", "misc") if select == "all" else (select,)
        for k in keys:
            if k in self.errors:
                PrintConvergenceTable(self.errors[k], label=f"{label}_{k}")


def PrintConvergenceTable(errors, label="error"):
    """Print an error/EOC table (cf. the PrintConvergenceTable binding);
    returns the last EOC, or None."""
    print(f"{'lvl':>4} {label:>14} {'eoc':>7}")
    for i, e in enumerate(errors):
        eoc = ""
        if i > 0 and errors[i - 1] > 0 and e > 0:
            eoc = f"{_mlog(errors[i - 1] / e) / _mlog(2):7.2f}"
        print(f"{i:>4} {e:14.6e} {eoc:>7}")
    if len(errors) > 1 and errors[-1] > 0 and errors[-2] > 0:
        return _mlog(errors[-2] / errors[-1]) / _mlog(2)
    return None


def kappa(mesh, lset_approx, subdivlvl=0):
    """Deprecated Hansbo-weight helper (python/__init__.py kappa): the cut
    ratio CF and one minus it; use ``CutRatioGF(CutInfo(mesh, lset))``."""
    from ..geom.cutinfo import CutInfo, CutRatioGF

    k = CutRatioGF(CutInfo(mesh, lset_approx))
    return (k, 1.0 - k)


def IsCut(mesh, lset_approx, subdivlvl=0):
    """Deprecated cut-indicator helper (python/__init__.py:422-439): a
    piecewise-constant GridFunction, 1 on cut elements and 0 elsewhere, on
    the level set's device; use ``CutInfo`` + ``BitArrayCF``."""
    from ..fem.gridfunction import GridFunction
    from ..fem.space import L2
    from ..geom.cutinfo import CutInfo

    k = np.asarray(CutInfo(mesh, lset_approx).GetCutRatios())
    dev = getattr(lset_approx, "device", None)
    gf = GridFunction(L2(mesh, order=0, device=dev), device=dev)
    gf.vec.data = ((k > 1e-16) & (k < 1.0 - 1e-16)).astype(np.float64)
    return gf
