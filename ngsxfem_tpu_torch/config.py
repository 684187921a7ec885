"""Global configuration for ngsxfem_tpu_torch.

PyTorch counterpart of ``ngsxfem_tpu/config.py``.  PyTorch runs float64
natively on the CPU and on the GPU, so there is no x64 switch and no
compilation cache: the port runs eagerly.  Importing this module pins float32
matrix products and convolutions to full float32 (no TF32): the f32-integrity
rule of the reference carries over (Krylov dot products and element matrices
at full precision).
"""
from __future__ import annotations

import os

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


class _Config:
    """Mutable global defaults."""

    def __init__(self):
        # floating dtype of geometry, quadrature and dof vectors when none is
        # given: float64, as the reference package runs with x64 on; the
        # flagship UnfittedPoisson asks for float32 in its own signature
        self.dtype = torch.float64
        # ABSOLUTE epsilon used to snap near-zero level-set vertex values to
        # +eps (sign-collapsing, exactly like the reference guard:
        # straightcutrule.cpp:553-554, spacetimecutrule.cpp:132)
        self.lset_eps = 1e-14
        # warn (NewtonNonConvergenceWarning) when the fixed-iteration Newton
        # searches (facet-patch neighbour map, shifted_eval) miss their
        # tolerance and fall back; off by default because the count is read
        # back to the host
        self.newton_debug = os.environ.get(
            "NGSXFEM_TPU_NEWTON_DEBUG", "0") != "0"


config = _Config()


def resolve_device(device=None):
    """The device an entry point makes its tensors on: the given one, or
    the current CUDA card (``torch.cuda.current_device()``: card 0 in a
    single process, the rank's own card once a rank has called
    ``torch.cuda.set_device``) when none is given.  Without a card the
    default raises; the CPU runs only when the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def torch_dtype(dtype):
    """The torch dtype of ``dtype``: a torch dtype itself, or what numpy
    names (``np.float32``, ``"float64"``, ``np.dtype("f4")``) as the JAX
    package's entry points take it; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    try:
        return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype
    except TypeError as e:
        raise TypeError(f"not a dtype torch has: {dtype!r}") from e


def set_default_dtype(dtype):
    """Set ``config.dtype``, the floating dtype of geometry, quadrature and
    dof vectors made without one (a floating dtype of torch, or one numpy
    names)."""
    dt = torch_dtype(dtype)
    if dt is None or not dt.is_floating_point:
        raise TypeError(f"set_default_dtype takes a floating dtype, "
                        f"got {dtype!r}")
    config.dtype = dt
