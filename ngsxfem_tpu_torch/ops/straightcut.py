"""Level-set guards of the straight-cut engine (the part the flagship needs).

Counterpart of ``ngsxfem_tpu/ops/straightcut.py:56,75``.
"""
from __future__ import annotations

import torch

from ..config import config


def eps_guard(vals, eps=None):
    """Snap near-zero level-set values to +eps, exactly like the reference
    (straightcutrule.cpp:553-554, spacetimecutrule.cpp:132: every
    ``|v| < 1e-14`` becomes ``+1e-14`` REGARDLESS of sign), so rounding noise
    cannot fabricate sliver cut elements.  The threshold is ABSOLUTE like the
    reference's; for level sets scaled far from O(1), adjust
    ``config.lset_eps``."""
    if eps is None:
        eps = config.lset_eps
    return torch.where(vals.abs() < eps,
                       torch.tensor(eps, dtype=vals.dtype, device=vals.device),
                       vals)


def eps_guard_list(vals_list, eps=None):
    """``eps_guard`` for SoA corner arrays (one (E,) tensor per corner)."""
    return [eps_guard(v, eps=eps) for v in vals_list]
