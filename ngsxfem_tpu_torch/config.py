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

    @property
    def np_dtype(self):
        """``dtype`` as numpy names it (``np.dtype("float64")``)."""
        return torch.empty(0, dtype=self.dtype).numpy().dtype


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


def as_input(x, like=None, dtype=None, device=None):
    """``x`` as a tensor, converted once at a function's entry, the way the
    JAX package's ``jnp`` ops take numpy arrays, lists and scalars.

    A tensor comes back as it is, and a dof-vector shim (``gf.vec``,
    ``f.vec``) as the tensor behind it.  Anything else becomes a tensor on
    ``device``, else on the device of ``like``, else on
    ``resolve_device(None)`` (the current card; without one that raises, as
    every entry point does).  ``like`` is a tensor or an object holding one
    (an operator's ``vals``, or its ``device``/``dtype``).  The dtype is
    ``dtype`` (torch's or numpy's name for it), else that of a floating
    ``like`` for a numeric value (a bool mask stays bool), else numpy's own
    through ``torch_dtype``."""
    if torch.is_tensor(x):
        return x
    from .fem.gridfunction import StandaloneVec, VecShim

    if isinstance(x, (VecShim, StandaloneVec)):
        return x.data
    arr = np.asarray(x)
    ldev = ldt = None
    if like is not None:
        t = like if torch.is_tensor(like) else getattr(like, "vals", None)
        if torch.is_tensor(t):
            ldev, ldt = t.device, t.dtype
        else:
            ldev = getattr(like, "device", None)
            ldt = getattr(like, "dtype", None)
            ldev = ldev if isinstance(ldev, torch.device) else None
            ldt = ldt if isinstance(ldt, torch.dtype) else None
    if dtype is not None:
        dt = torch_dtype(dtype)
    elif (ldt is not None and (ldt.is_floating_point or ldt.is_complex)
          and arr.dtype.kind in "fiuc"):
        dt = ldt
    else:
        dt = torch_dtype(arr.dtype)
    dev = resolve_device(device if device is not None else ldev)
    return torch.as_tensor(arr, dtype=dt, device=dev)


def set_default_dtype(dtype):
    """Set ``config.dtype``, the floating dtype of geometry, quadrature and
    dof vectors made without one (a floating dtype of torch, or one numpy
    names)."""
    dt = torch_dtype(dtype)
    if dt is None or not dt.is_floating_point:
        raise TypeError(f"set_default_dtype takes a floating dtype, "
                        f"got {dtype!r}")
    config.dtype = dt
