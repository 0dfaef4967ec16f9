"""Fixed-point scaling between external float prices/volumes and internal
integer ticks/lots.

The reference scales price and volume by 10^accuracy at ingestion using
shopspring/decimal and stores the result back into float64
(gomengine/engine/ordernode.go:76-87; accuracy default 8,
config.yaml.example:24). Go's decimal.NewFromFloat takes the shortest decimal
representation of the float — the same value Python's repr()/str() produces —
so Decimal(str(x)) * 10^accuracy reproduces the reference's scaled value
exactly. We keep the scaled value as a Python int (exact), whereas the
reference keeps float64 (exact only below 2^53 — SURVEY §2.2); parity is
defined on the event stream for in-range inputs.
"""

from __future__ import annotations

import decimal

DEFAULT_ACCURACY = 8  # config.yaml.example:24
_FLOAT53 = 1 << 53


def scale(value: float, accuracy: int = DEFAULT_ACCURACY) -> int:
    """External float → internal scaled integer (exact decimal semantics)."""
    d = decimal.Decimal(str(value)) * (decimal.Decimal(10) ** accuracy)
    # The reference truncates nothing: values with more than `accuracy`
    # decimals keep a fractional scaled part in its float64. Such inputs are
    # out of contract (the fixed-point scale IS the tick size); we reject
    # them loudly instead of silently rounding.
    if d != d.to_integral_value():
        raise ValueError(
            f"value {value!r} has more than {accuracy} decimal places; "
            f"not representable at accuracy={accuracy}"
        )
    return int(d)


def unscale(ticks: int, accuracy: int = DEFAULT_ACCURACY) -> float:
    """Internal scaled integer → the float64 the reference would hold.

    The reference's arithmetic happens on float64(scaled); below 2^53 that
    float is integer-exact, so float(ticks) reproduces it bit-for-bit.
    """
    return float(ticks)


def unscale_external(ticks: int, accuracy: int = DEFAULT_ACCURACY) -> float:
    """Internal scaled integer → external (human) units."""
    return float(
        decimal.Decimal(ticks) / (decimal.Decimal(10) ** accuracy)
    )


def is_float64_exact(ticks: int) -> bool:
    """Whether the reference's float64 representation of this scaled value is
    integer-exact (SURVEY §2.2 consequence (a))."""
    return abs(ticks) < _FLOAT53
