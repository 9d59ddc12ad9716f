"""What the span readers share: the program's own spans and counters of the
traced window (``utils/profiling.py`` of the port, which records them while
the harness's profiler runs), summed and taken a step.

A program that records no spans (one without ``profiling.records``), or
whose ``hipac.data.gather`` spans are not one a step of the window, gives
nothing to read: the readers return None.
"""

from __future__ import annotations

from hipac_bench import training

GATHER = "hipac.data.gather"
GATHERED_BYTES = "hipac.data.bytes"
PIN = "hipac.feed.pin"
PINNED_BYTES = "hipac.feed.pinned_bytes"
#: the parts of a SimCLR step whose host time is the host's own work
SIMCLR_ISSUE = ("hipac.simclr.views", "hipac.simclr.forward",
                "hipac.simclr.loss", "hipac.simclr.optimizer")
#: the part of a SimCLR step where the host waits on the device
SIMCLR_BACKWARD = "hipac.simclr.backward"


def window(work: dict):
    """(spans, counters) that the program recorded in the window, or None."""
    prof = training.port("utils.profiling")
    if not hasattr(prof, "records") or not work.get("steps"):
        return None
    spans = prof.records()
    if sum(s.name == GATHER for s in spans) != work["steps"]:
        return None
    return spans, prof.counters()


def seconds(spans, names) -> tuple[int, float]:
    """(count, summed seconds) of the spans named in ``names``."""
    n, ns = 0, 0
    for s in spans:
        if s.name in names:
            n += 1
            ns += s.end_ns - s.start_ns
    return n, ns * 1e-9


def ms_per_step(work: dict, names) -> float | None:
    """The spans of ``names``, summed over the window, in ms a step; None
    where there are none."""
    rec = window(work)
    if rec is None:
        return None
    n, s = seconds(rec[0], names)
    return 1e3 * s / work["steps"] if n else None


def gb_per_s(work: dict, name: str, counter: str) -> float | None:
    """The bytes of ``counter`` over the seconds of the spans ``name``, in
    GB/s (1e9 bytes); None where either is missing."""
    rec = window(work)
    if rec is None:
        return None
    n, s = seconds(rec[0], (name,))
    nbytes = rec[1].get(counter, 0)
    if not n or not nbytes or s <= 0.0:
        return None
    return nbytes / s * 1e-9
