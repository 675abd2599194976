"""Frozen operation and byte counts of the hand kernels whose rooflines
the benchmark reads, and the peaks they are divided by.  They count the
work from the launched shapes, so a kernel's share reads the same work
whatever implements it.  Nothing here imports the program.

Peaks of one NVIDIA H100 SXM (NVIDIA H100 Tensor Core GPU data sheet;
Hopper tuning guide):
- ``INT32_ISSUE_PER_SM``: 128 int32 instructions a clock per SM, the
  SM's issue limit (4 schedulers x 32 lanes: the INT pipe's 64 lanes and
  the FMA pipe's 64, which runs IMAD, together); an operation fused with
  its neighbour (multiply-add, add-then-max, 3-input max) counts once.
- the SM clock: the card's maximum SM clock, as
  ``nvidia-smi --query-gpu=clocks.max.sm`` reads it (1,980 MHz on the
  H100 80GB HBM3 measured so far).
- ``HBM_BYTES_PER_S``: 3.35 TB/s of HBM3.
"""

from __future__ import annotations

INT32_ISSUE_PER_SM = 128
HBM_BYTES_PER_S = 3.35e12

# ssq_sw_cigar: the banded DP with traceback codes, 128 band cells a row
SW_BAND = 128
SW_CIGAR_OPS_PER_CELL = 19
SW_CIGAR_MAX_OPS = 48
# ssq_sw_unbanded_score: the haplotype scan, Lr cells a row
SW_UNBANDED_OPS_PER_CELL = 8


def bound_ms(int_ops: float, nbytes: float, clock_hz: float,
             n_sms: int) -> float:
    """The least time of a kernel's work: the larger of its int32
    instructions over the SMs' issue rate and its bytes over the HBM
    rate, in ms."""
    ops_ms = int_ops / (n_sms * INT32_ISSUE_PER_SM) / clock_hz * 1e3
    return max(ops_ms, nbytes / HBM_BYTES_PER_S * 1e3)


def sw_cigar_ms(lanes: int, Lq: int, Lr: int, rows: int, clock_hz: float,
                n_sms: int) -> float:
    """``ssq_sw_cigar`` on ``lanes`` alignments of Lq query columns
    against Lr reference columns, running ``rows`` query rows in all
    (each lane's length clamped to [1, Lq]): rows x 128 cells x 19
    instructions, or its bytes (query, length and window read; 9 values
    and 2 x 48 CIGAR operations a lane written)."""
    n_out = (9 + 2 * SW_CIGAR_MAX_OPS) * lanes
    return bound_ms(float(rows) * SW_BAND * SW_CIGAR_OPS_PER_CELL,
                    4.0 * (lanes * Lq + lanes + lanes * Lr + n_out),
                    clock_hz, n_sms)


def sw_unbanded_score_ms(lanes: int, Lq: int, Lr: int, rows: int,
                         clock_hz: float, n_sms: int) -> float:
    """``ssq_sw_unbanded_score``: rows x Lr cells x 8 instructions, or its
    bytes (query, length and window read, five values a lane written)."""
    return bound_ms(float(rows) * Lr * SW_UNBANDED_OPS_PER_CELL,
                    4.0 * (lanes * Lq + lanes + lanes * Lr + 5 * lanes),
                    clock_hz, n_sms)
