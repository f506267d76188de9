"""Peaks of one NVIDIA H100 and the least time of the kernels the cells read.

Frozen copies of ``chip_smoke.py`` at the commit that added this benchmark:
``HBM_BYTES_PER_S`` and ``PEAK_OPS_PER_S`` (lines 199-203), ``bound``
(lines 306-311), ``table_bound`` (lines 941-945) and ``screen_bound``
(lines 979-986). The benchmark imports nothing from ``chip_smoke.py``, so a
later change there cannot move a roofline share.

The peaks are NVIDIA's data sheet for the H100 SXM, dense rates at 700 W.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "f32": 67e12}


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """bound_ms and bound_by of a kernel that must move ``nbytes`` and do
    ``ops`` operations of type ``kind``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def table_bound(q: int, n_cols: int, k: int) -> dict:
    """The exact table (K5 (a)) reads the queries and the listed slides' rows
    once (256 B + a valid byte a slot) and writes best + arg; 2 * 256 int8
    operations a (query, slot) pair."""
    return bound(n_cols * k * (256 + 1) + q * 256 + q * n_cols * 8, 2 * q * n_cols * k * 256, "int8")


def screen_bound(r: int, n_cols: int, n_slots: int, n_read: int, bits: int = 128) -> dict:
    """Stage-1 screening (K5 (b)) must read the ``bits``-byte prefix and the
    valid byte of each of ``n_slots`` slots of each of the ``n_read``
    distinct slides it scores once, and the queries once, and write
    [R, n_cols] int32; 2 * bits int8 operations a (query, slot) pair."""
    return bound(n_read * n_slots * (bits + 1) + r * bits + r * n_cols * 4,
                 2 * r * n_cols * n_slots * bits, "int8")
