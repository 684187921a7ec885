"""Runtime numerical-failure diagnostics.

Counterpart of ``ngsxfem_tpu/utils/diagnostics.py``.  The reference warns on
Newton non-convergence in the facet-patch point map and the shifted
evaluation and falls back to a lower-order rule
(symboliccutbfi.cpp:1184-1192, shiftedevaluate.cpp:68-95).  The port's
fixed-iteration batched Newton searches take the same fallback through
masks; with ``config.newton_debug`` on, the count of non-converged points is
read back to the host and surfaced as a :class:`NewtonNonConvergenceWarning`
(off by default: the read-back synchronises the card on the assembly path).
"""
from __future__ import annotations

import warnings


class NewtonNonConvergenceWarning(UserWarning):
    """A fixed-iteration Newton point search missed its tolerance somewhere
    and the documented low-order fallback was used for those points."""


def warn_nonconverged(label, fallback, n, total=None):
    """Warn iff the count ``n`` of non-converged points is positive."""
    n = int(n)
    if n > 0:
        tot = f"/{int(total)}" if total is not None else ""
        warnings.warn(
            f"{label}: {n}{tot} Newton points non-converged; "
            f"falling back to {fallback} there",
            NewtonNonConvergenceWarning, stacklevel=2)


def emit_nonconverged(label, fallback, nonconv_count, total):
    """``warn_nonconverged`` of the count of non-converged points (an int
    or a 0-d tensor, read back to the host here)."""
    warn_nonconverged(label, fallback, nonconv_count, total=total)
