"""Profiling hooks: a ``torch.profiler`` trace around a region, the
program's spans and counters inside it, and the wall-clock stage ``Timer``.

Counterpart of the JAX package's ``utils/profiling.py``. :func:`trace`
records the host and, where a card is present, its kernels (CUPTI), and
writes one Chrome trace (``chrome://tracing``, Perfetto) into ``log_dir``:
``trace.json``, or ``trace_rank{R}.json`` for a rank of a process group,
and beside it ``spans.json`` (``spans_rank{R}.json``), the program's spans
and counters of the region. The CLI's ``--profile`` wraps
``--extract_features`` in it, under ``<log_dir>/profile``.

Spans (:func:`annotate`) and counters (:func:`count`) record only while a
``torch.profiler`` session is active on their thread (a session profiles
the thread that started it, and no other); with none, a span or a count
costs one check of the profiler's state and records nothing. While one is,
a span is a ``record_function`` on the profiler's timeline, beside the
kernels and copies it issued, and a :class:`Span` in memory
(:func:`records`), which readers without the profiler's events take; a
count adds to a named total (:func:`counters`). :func:`reset` clears both.
Importing this module imports no torch: where torch is not loaded, no
profiler runs, and a span or a count does nothing.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from typing import NamedTuple

from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    Timer,
    get_logger,
)

log = get_logger("utils.profiling")


class Span(NamedTuple):
    """One closed span: its name, start and end (``time.perf_counter_ns``)."""

    name: str
    start_ns: int
    end_ns: int


_RECORDS: list[Span] = []
_COUNTERS: dict[str, int] = {}
_LOCK = threading.Lock()
_OFF = contextlib.nullcontext()


def _on() -> bool:
    """Whether a ``torch.profiler`` session is active on this thread."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


@contextlib.contextmanager
def _span(name: str):
    import torch

    with torch.profiler.record_function(name):
        start = time.perf_counter_ns()
        yield
        _RECORDS.append(Span(name, start, time.perf_counter_ns()))


def annotate(name: str):
    """The program's span ``name`` around a ``with`` block: recorded while a
    ``torch.profiler`` session is active, nothing otherwise."""
    return _span(name) if _on() else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a ``torch.profiler`` session is
    active."""
    if _on():
        with _LOCK:
            _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def records() -> list[Span]:
    """The spans closed since the last :func:`reset`, in the order they
    closed."""
    return list(_RECORDS)


def counters() -> dict[str, int]:
    """The counters' totals since the last :func:`reset`."""
    with _LOCK:
        return dict(_COUNTERS)


def reset() -> None:
    """Forget every recorded span and counter."""
    with _LOCK:
        _RECORDS.clear()
        _COUNTERS.clear()


def _rank_file(log_dir: str, stem: str) -> str:
    rank = os.environ.get("RANK")
    return os.path.join(log_dir, f"{stem}.json" if rank is None
                        else f"{stem}_rank{rank}.json")


def trace_path(log_dir: str) -> str:
    """The Chrome trace file that :func:`trace` writes into ``log_dir``."""
    return _rank_file(log_dir, "trace")


def spans_path(log_dir: str) -> str:
    """The span and counter summary that :func:`trace` writes beside the
    Chrome trace."""
    return _rank_file(log_dir, "spans")


def span_table(prof) -> dict[str, dict[str, float]]:
    """The program's spans (``hipac.*``) on the host's side of ``prof``'s
    timeline, by name: ``count``, ``total_ms``, ``mean_ms`` and ``self_ms``
    (less the time of every event inside it), from ``key_averages``."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    return {
        e.key: {"count": e.count,
                "total_ms": e.cpu_time_total * 1e-3,
                "mean_ms": e.cpu_time_total * 1e-3 / e.count,
                "self_ms": e.self_cpu_time_total * 1e-3}
        for e in prof.key_averages()
        if e.key.startswith("hipac.") and e.device_type == cpu
    }


@contextlib.contextmanager
def trace(log_dir: str = "logs/profile", enabled: bool = True):
    """Capture a ``torch.profiler`` trace of the CPU and, when CUDA is
    available, of the card around a code region, with the program's spans
    and counters in ``spans.json``::

        with trace("logs/profile"):
            run_feature_extraction(...)
    """
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    log.info("capturing torch.profiler trace into %s", log_dir)
    with profile(activities=activities) as prof:
        yield
    path = trace_path(log_dir)
    prof.export_chrome_trace(path)
    with open(spans_path(log_dir), "w") as f:
        json.dump({"spans": span_table(prof), "counters": counters()}, f,
                  indent=1, sort_keys=True)
    reset()
    log.info("trace written to %s", path)


__all__ = ["trace", "annotate", "count", "records", "counters", "reset",
           "span_table", "Span", "Timer"]
