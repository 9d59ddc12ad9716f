"""Profiling hooks: a ``torch.profiler`` trace around a region, named
sub-spans inside it, and the wall-clock stage ``Timer``.

Counterpart of the JAX package's ``utils/profiling.py``. :func:`trace`
records the host and, where a card is present, its kernels (CUPTI), and
writes one Chrome trace (``chrome://tracing``, Perfetto) into ``log_dir``:
``trace.json``, or ``trace_rank{R}.json`` for a rank of a process group.
The CLI's ``--profile`` wraps ``--extract_features`` in it, under
``<log_dir>/profile``.
"""

from __future__ import annotations

import contextlib
import os

from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    Timer,
    get_logger,
)

log = get_logger("utils.profiling")


def trace_path(log_dir: str) -> str:
    """The Chrome trace file that :func:`trace` writes into ``log_dir``."""
    rank = os.environ.get("RANK")
    return os.path.join(log_dir, "trace.json" if rank is None
                        else f"trace_rank{rank}.json")


@contextlib.contextmanager
def trace(log_dir: str = "logs/profile", enabled: bool = True):
    """Capture a ``torch.profiler`` trace of the CPU and, when CUDA is
    available, of the card around a code region::

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
    log.info("trace written to %s", path)


def annotate(name: str):
    """A named sub-span inside an active trace
    (``torch.profiler.record_function``)."""
    import torch

    return torch.profiler.record_function(name)


__all__ = ["trace", "annotate", "Timer"]
