"""Constructor-knob validation shared across the monitor stack.

Every check raises ``ValueError`` naming the offending argument and the
value it got (mirroring the ``SCALANA_DETECT_BACKEND`` style in
``repro_torch.core.detect``), so a mistyped knob fails at construction with a
message that says which knob — not three layers down with an opaque
type error.
"""
from __future__ import annotations

from typing import Optional


def positive_int(name: str, value, *, allow_none: bool = False
                 ) -> Optional[int]:
    """``value`` as a positive int (``None`` passes when allowed)."""
    if value is None:
        if allow_none:
            return None
        raise ValueError(f"{name} must be a positive integer, got None")
    try:
        v = int(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"{name} must be a positive integer, got {value!r}") from None
    if v <= 0:
        raise ValueError(f"{name} must be a positive integer, got {value!r}")
    return v


def non_negative_int(name: str, value) -> int:
    try:
        v = int(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"{name} must be a non-negative integer, got {value!r}") from None
    if v < 0:
        raise ValueError(
            f"{name} must be a non-negative integer, got {value!r}")
    return v


def positive_float(name: str, value, *, allow_none: bool = False
                   ) -> Optional[float]:
    if value is None:
        if allow_none:
            return None
        raise ValueError(f"{name} must be a positive number, got None")
    try:
        v = float(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"{name} must be a positive number, got {value!r}") from None
    if not v > 0:
        raise ValueError(f"{name} must be a positive number, got {value!r}")
    return v


def probability(name: str, value) -> float:
    try:
        v = float(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"{name} must be a probability in [0, 1], got {value!r}") \
            from None
    if not 0.0 <= v <= 1.0:
        raise ValueError(
            f"{name} must be a probability in [0, 1], got {value!r}")
    return v


def fraction(name: str, value, *, allow_none: bool = False
             ) -> Optional[float]:
    """A detection-trigger fraction: in (0, 1]."""
    if value is None:
        if allow_none:
            return None
        raise ValueError(f"{name} must be a fraction in (0, 1], got None")
    try:
        v = float(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"{name} must be a fraction in (0, 1], got {value!r}") from None
    if not 0.0 < v <= 1.0:
        raise ValueError(f"{name} must be a fraction in (0, 1], got {value!r}")
    return v


def port_number(name: str, value, *, allow_zero: bool = True) -> int:
    """A TCP port: 1..65535, or 0 for "pick a free one" when allowed."""
    try:
        v = int(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"{name} must be a TCP port in "
            f"{'0' if allow_zero else '1'}..65535, got {value!r}") from None
    lo = 0 if allow_zero else 1
    if not lo <= v <= 65535:
        raise ValueError(f"{name} must be a TCP port in {lo}..65535, "
                         f"got {value!r}")
    return v


def backoff_bounds(base_name: str, base, max_name: str, max_value
                   ) -> tuple:
    """Validate an exponential-backoff (base, cap) pair together."""
    b = positive_float(base_name, base)
    m = positive_float(max_name, max_value)
    if m < b:
        raise ValueError(
            f"{max_name} must be >= {base_name} "
            f"({max_name}={max_value!r} < {base_name}={base!r})")
    return b, m
