"""Reference helper functions of the port's examples.

Counterpart of part of ``ngsxfem_tpu/utils/utils.py``: only
``SpaceTimeWeakSet``, which the CG-in-time heat example calls.
"""
from __future__ import annotations


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
