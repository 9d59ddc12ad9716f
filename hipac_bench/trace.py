"""The traced window: ``torch.profiler`` over the measured loop, and what the
metric readers take from it.

The window is the span ``bench.window`` that the harness records around
its loop. Device time is the union of the CUDA kernel, copy and set
intervals inside it; the idle gaps are what lies between them, each named by
the harness span and the host operation that overlapped it most.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

WINDOW = "bench.window"
TOP = 10


@contextlib.contextmanager
def span(name: str):
    """A host span of the harness, visible in the trace."""
    with torch.profiler.record_function(name):
        yield


def profile():
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def _union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlap(a0, a1, b0, b1) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def summarize(prof) -> dict:
    """``busy_s``, ``window_s``, device seconds and launches by kernel name,
    and the ``breakdown`` (device operations and idle gaps, at most
    :data:`TOP` each, in seconds)."""
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    host, device = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == cuda:
            # a host span's mirror on the device's timeline is no work
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith("bench.")):
                device.append((tr.start, tr.end, e.name))
        elif e.name == WINDOW:
            window = (tr.start, tr.end)
        else:
            host.append((tr.start, tr.end, e.name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w0, w1 = window
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in device
              if e > w0 and s < w1]
    merged = _union([(s, e) for s, e, _ in inside])
    busy_us = sum(e - s for s, e in merged)
    kernels: dict[str, list] = defaultdict(lambda: [0, 0.0])
    for s, e, n in inside:
        kernels[n][0] += 1
        kernels[n][1] += (e - s) * 1e-6
    edges = [w0] + [v for se in merged for v in se] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:TOP]:
        best = {"bench": ("", 0.0), "op": ("", 0.0)}
        for s, e, n in host:
            ov = _overlap(s, e, g0, g1)
            if ov <= 0.0:
                continue
            kind = "bench" if n.startswith("bench.") else "op"
            # the innermost harness span: ties go to the later-starting one
            if ov > best[kind][1] or (kind == "bench" and ov == best[kind][1]):
                best[kind] = (n, ov)
        name = "/".join(v[0] for v in best.values() if v[0]) or "no host span"
        named.append([name, (g1 - g0) * 1e-6])
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "kernels": {n: {"launches": c, "seconds": t}
                    for n, (c, t) in kernels.items()},
        "breakdown": {"device_ops": [[n, t] for n, (_c, t) in ops],
                      "idle_gaps": named},
    }


def kernel_seconds(summary: dict, fragment: str) -> tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds
    ``fragment``."""
    launches, seconds = 0, 0.0
    for name, k in summary["kernels"].items():
        if fragment in name:
            launches += k["launches"]
            seconds += k["seconds"]
    return launches, seconds
