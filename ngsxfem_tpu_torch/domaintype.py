"""Domain-type enums and combined-domain-type (CDT) bit algebra.

Copied from ``ngsxfem_tpu/domaintype.py`` (numpy-free, device-free).
Re-design of the reference enums in ``utils/ngsxstd.hpp:14-33``
(ChrLackner/ngsxfem): ``DOMAIN_TYPE {NEG, POS, IF}`` classifies where (w.r.t.
the level set phi) an integral lives; ``COMBINED_DOMAIN_TYPE`` is the 8-valued
bitmask lattice over the three atoms used for element/facet marking.

Domain codes are plain ints, so they can be compared with the values of
int8 element-classification arrays and tensors.
"""
from __future__ import annotations

from enum import IntEnum


class DOMAIN_TYPE(IntEnum):
    NEG = 0
    POS = 1
    IF = 2


class COMBINED_DOMAIN_TYPE(IntEnum):
    """Bitmask over (NEG=bit0, POS=bit1, IF=bit2); cf. utils/ngsxstd.hpp:20-33."""

    CDOM_NO = 0
    CDOM_NEG = 1
    CDOM_POS = 2
    CDOM_UNCUT = 3
    CDOM_IF = 4
    CDOM_HASNEG = 5
    CDOM_HASPOS = 6
    CDOM_ANY = 7


NEG = DOMAIN_TYPE.NEG
POS = DOMAIN_TYPE.POS
IF = DOMAIN_TYPE.IF

CDOM_NO = COMBINED_DOMAIN_TYPE.CDOM_NO
CDOM_NEG = COMBINED_DOMAIN_TYPE.CDOM_NEG
CDOM_POS = COMBINED_DOMAIN_TYPE.CDOM_POS
UNCUT = COMBINED_DOMAIN_TYPE.CDOM_UNCUT
HASNEG = COMBINED_DOMAIN_TYPE.CDOM_HASNEG
HASPOS = COMBINED_DOMAIN_TYPE.CDOM_HASPOS
ANY = COMBINED_DOMAIN_TYPE.CDOM_ANY

# list of all atomic domain types (mirrors python/__init__.py `all_domain_types`)
all_domain_types = [NEG, POS, IF]
all_combined_domain_types = list(COMBINED_DOMAIN_TYPE)


def TO_CDT(dt: DOMAIN_TYPE) -> COMBINED_DOMAIN_TYPE:
    """Atomic domain type -> its singleton bitmask (ngsxstd.hpp TO_CDT)."""
    return COMBINED_DOMAIN_TYPE(1 << int(dt))


def cdt_contains(cdt: int, dt: int) -> bool:
    return bool((int(cdt) >> int(dt)) & 1)


def INVERT(cdt: COMBINED_DOMAIN_TYPE) -> COMBINED_DOMAIN_TYPE:
    """Swap the NEG and POS bits (IF bit unchanged)."""
    c = int(cdt)
    neg, pos, iff = c & 1, (c >> 1) & 1, (c >> 2) & 1
    return COMBINED_DOMAIN_TYPE(pos | (neg << 1) | (iff << 2))


def as_cdt(dt_or_cdt) -> COMBINED_DOMAIN_TYPE:
    """Normalize a DOMAIN_TYPE or COMBINED_DOMAIN_TYPE to a CDT bitmask.

    Plain ints 0..2 are AMBIGUOUS (NEG/POS/IF atomic codes vs
    CDOM_NO/CDOM_NEG/CDOM_POS bitmasks) and are rejected — pass the enum
    member.  Ints >= 3 are unambiguous CDT masks and accepted.
    """
    if isinstance(dt_or_cdt, DOMAIN_TYPE):
        return TO_CDT(dt_or_cdt)
    if isinstance(dt_or_cdt, COMBINED_DOMAIN_TYPE):
        return dt_or_cdt
    v = int(dt_or_cdt)
    if 0 <= v <= 2:
        raise TypeError(
            f"ambiguous plain int {v}: pass DOMAIN_TYPE (NEG/POS/IF) or "
            "COMBINED_DOMAIN_TYPE (CDOM_*) explicitly")
    return COMBINED_DOMAIN_TYPE(v)
