"""The yardstick of the kernels: the H100's peaks and the operations and
bytes a decision kernel's call needs, from its shapes.

Peaks: NVIDIA's H100 SXM data sheet (dense, at the 700 W limit).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# the ETF search's rows: the ready queue it scans (the engine's R_MAX)
ETF_ROWS = 16


def etf_search_bytes(S: int, R: int, P: int, alive: bool = False) -> int:
    """Bytes one call of the masked ETF search must move for S lanes of
    R ready slots x P PEs: the availability and execution-time tables
    [S, R, P] f32, the PEs' free times [S, P] f32, `now` [S] f32 and the
    slot mask [S, R] u8 read once; the PE mask [S, P] u8 when given; the
    minimum f32, slot i32, PE i32 and feasibility u8 a lane written
    once."""
    return S * (2 * R * P * 4 + P * 4 + 4 + R + (P if alive else 0)
                + 4 + 4 + 4 + 1)


def etf_search_ops(S: int, R: int, P: int) -> int:
    """Operations of one call: a finish time (a max of three and an add),
    a finiteness test and a compare a cell."""
    return 6 * S * R * P


def etf_search_bound_us(S: int, R: int, P: int, alive: bool = False) -> float:
    """The least time the H100 could take for the call: the larger of
    its bytes over HBM bandwidth and its operations over the fp32 rate."""
    return max(etf_search_bytes(S, R, P, alive) / HBM_BYTES_PER_S,
               etf_search_ops(S, R, P) / F32_OPS_PER_S) * 1e6
