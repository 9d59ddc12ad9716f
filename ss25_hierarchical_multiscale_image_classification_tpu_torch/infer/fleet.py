"""Slide fleet inference: one slide per device group, groups at once.

Counterpart of the JAX package's ``infer/fleet.py``. The devices are split
into contiguous groups (the rows of a (group, data) mesh,
``parallel/mesh.py``); one worker thread per group takes slides from a
shared queue and runs the producer on them, each batch split over the
group's devices (``predict_slide(devices=...)``). The threads overlap one
group's host work (slide decode, band cutting) with another's device work.
Each thread issues its work on a CUDA stream of its own on each of its
devices, so groups that share a card overlap there too.

A slide's failure is logged and the others go on; at the end one
``RuntimeError`` names the count and the first failing path, chained from
its exception. Unlike the JAX fleet, which filters tissue on the host, the
producer's ``tissue_filter`` is passed through (``"device"`` runs the
normalize kernel on every device of the group).
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
from typing import Sequence

import numpy as np
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    DETECTION_PROB_THRESHOLD,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
    cuda_devices,
    resolve_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
    margin_detections,
    predict_slide,
    replicate_model,
    sigmoid,
    slide_name,
    write_detection_csv,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    Timer,
    get_logger,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    group_submeshes,
    make_mesh,
)

log = get_logger("torch.infer.fleet")


def device_groups(group_size: int | None = None,
                  devices: Sequence | None = None) -> list[list[torch.device]]:
    """Partition ``devices`` (default: every visible card) into contiguous
    groups of ``group_size``; None → one group with all of them,
    ``group_size=1`` → one slide per device. The rows of a ``("group",
    "data")`` mesh of shape (-1, group_size)."""
    devices = ([resolve_device(d) for d in devices] if devices is not None
               else cuda_devices())
    if group_size is None:
        return [devices]
    if group_size < 1 or len(devices) % group_size:
        raise ValueError(
            f"group_size {group_size} must divide the {len(devices)} devices"
        )
    mesh = make_mesh(devices=devices, axis_names=("group", DATA_AXIS),
                     shape=(-1, group_size))
    return [list(m.devices) for m in group_submeshes(mesh)]


def _own_streams(devices: list[torch.device]) -> contextlib.ExitStack:
    """A context in which this thread's current stream on each CUDA device
    of ``devices`` is a new one."""
    stack = contextlib.ExitStack()
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            stack.enter_context(torch.cuda.stream(torch.cuda.Stream(dev)))
    return stack


def predict_slide_fleet(
    slide_paths: list[str],
    model: torch.nn.Module,
    csv_dir: str,
    level: int = 3,
    group_size: int | None = None,
    threshold: float | None = None,
    devices: Sequence | None = None,
    predict_fn=None,
    **predict_kw,
) -> dict[str, np.ndarray]:
    """Run the detection producer over many slides, one slide per device
    group at a time; returns ``{slide_path: prob_grid}`` and writes one
    detection CSV per slide into ``csv_dir``.

    ``model`` is the inference model on any device; each group gets a
    replica on each of its devices. ``predict_kw`` goes to
    :func:`predict_slide` (``batch_size``, ``stride``, ``tissue_filter``,
    ``int8``, ``qtree``, ...). ``threshold`` is the emission floor in
    probability space (default :data:`DETECTION_PROB_THRESHOLD`).

    ``predict_fn(path, models, *, devices, output, **predict_kw) →
    (margins, grid)`` swaps the producer (``models``: the replicas, one per
    device of ``devices``); it is called with ``output="margin"``.
    """
    if threshold is None:
        threshold = DETECTION_PROB_THRESHOLD
    if predict_fn is None:
        def predict_fn(path, models, *, devices, **kw):
            return predict_slide(path, models, level=level, device=devices[0],
                                 devices=devices, **kw)

    groups = device_groups(group_size, devices)
    work: queue.Queue[str] = queue.Queue()
    for p in slide_paths:
        work.put(p)

    results: dict[str, np.ndarray] = {}
    errors: list[tuple[str, Exception]] = []
    lock = threading.Lock()
    os.makedirs(csv_dir, exist_ok=True)

    def group_worker(gi: int, group_devices: list, models: list) -> None:
        with _own_streams(group_devices):
            while True:
                try:
                    path = work.get_nowait()
                except queue.Empty:
                    return
                name = slide_name(os.path.basename(path))
                try:
                    margins, grid = predict_fn(path, models,
                                               devices=group_devices,
                                               output="margin", **predict_kw)
                    detections = margin_detections(margins, grid, threshold)
                    write_detection_csv(os.path.join(csv_dir, f"{name}.csv"),
                                        detections)
                    with lock:
                        results[path] = sigmoid(margins)
                    log.info("group %d: %s → %d detections", gi, name,
                             len(detections))
                except Exception as e:  # surfaced after the other slides
                    with lock:
                        errors.append((path, e))
                    log.error("group %d: %s failed: %s", gi, name, e,
                              exc_info=True)

    with Timer(f"fleet[{len(slide_paths)} slides / {len(groups)} groups]", log):
        threads = [
            threading.Thread(target=group_worker,
                             args=(gi, g, replicate_model(model, g)),
                             daemon=True)
            for gi, g in enumerate(groups)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    if errors:
        path, e = errors[0]
        raise RuntimeError(
            f"{len(errors)} slide(s) failed; first: {path}"
        ) from e
    return results
