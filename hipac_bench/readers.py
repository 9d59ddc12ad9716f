"""Arithmetic that the per-layer metric readers share: each reader,
``metrics/<name>.py``, picks its work count and kernel and calls these."""

from __future__ import annotations

from hipac_bench import counts
from hipac_bench.trace import kernel_seconds


def idle_share(trace: dict) -> float:
    """Per cent of the traced window in which no kernel, copy or set ran on
    the device."""
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def mfu(flop: float, trace: dict) -> float:
    """Per cent of the card's bf16 peak that ``flop`` operations over the
    traced window make."""
    return 100.0 * flop / trace["window_s"] / counts.BF16_FLOP_S


def roofline(trace: dict, fragment: str, nbytes: float, flop: float):
    """Per cent of the least time (``counts.bound_s``) over the device time
    of the kernels whose name holds ``fragment``; None where none ran."""
    launches, seconds = kernel_seconds(trace, fragment)
    if launches == 0 or seconds <= 0.0:
        return None
    return 100.0 * counts.bound_s(nbytes, flop) / seconds
