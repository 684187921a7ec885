"""Global configuration for ngsxfem_tpu_torch.

PyTorch counterpart of ``ngsxfem_tpu/config.py``.  PyTorch runs float64
natively on the CPU and on the GPU, so there is no x64 switch and no
compilation cache: the port runs eagerly.  Importing this module pins float32
matrix products and convolutions to full float32 (no TF32): the f32-integrity
rule of the reference carries over (Krylov dot products and element matrices
at full precision).
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


class _Config:
    """Mutable global defaults."""

    def __init__(self):
        # floating dtype of the flagship model when none is given (the
        # reference's UnfittedPoisson defaults to float32 as well)
        self.dtype = torch.float32
        # ABSOLUTE epsilon used to snap near-zero level-set vertex values to
        # +eps (sign-collapsing, exactly like the reference guard:
        # straightcutrule.cpp:553-554, spacetimecutrule.cpp:132)
        self.lset_eps = 1e-14


config = _Config()
