"""Full-slide sliding-window inference → margin grid → detection CSV.

Counterpart of the JAX package's ``infer/sliding_window.py``: grid the slide
at a level, stream the cells through the classifier in batches, assemble the
(ny, nx) tumor logit-margin grid, and turn it into centroid-NMS detections
in level-0 coordinates for the FROC consumer.

The port loads nothing of the JAX package, whose module imports jax and
flax at module level; this module carries copies of its host helpers (:class:`BandProducer`,
:data:`NON_TISSUE_MARGIN`, :func:`sigmoid`, :func:`prob_to_margin`,
:func:`margin_to_score`, :func:`nms_detections`, :func:`margin_detections`,
:func:`write_detection_csv`, and ``slide_name`` from ``data/extract.py``),
held to the originals by exact-equality tests.

One device, or several (``devices``, the JAX function's ``mesh``): each
batch is then split in contiguous rows over the devices, one model replica
each. ``int8=True`` runs the int8 (w8a8) forward of ``models/quantized.py``
(every convolution on the port's int8 kernels) from a persisted artifact
(``qtree``) or, without one and on one device, from scales calibrated on
the slide's first tissue batch.
"""

from __future__ import annotations

import copy
import csv
import os
from collections import deque
from typing import Sequence

import numpy as np
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    DETECTION_PROB_THRESHOLD,
    TISSUE_MEAN_RGB_THRESHOLD,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
    normalize,
    resize,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
    resolve_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.pyramid import PatchGrid
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import Slide, open_slide
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import Timer, get_logger
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.preprocess import (
    fused_normalize,
)

log = get_logger("torch.infer.sliding_window")


class BandProducer:
    """Band-prefetch thread with a bounded queue and SAFE shutdown.

    The consumer may exit early (exception in the step, bad checkpoint, ...)
    while the producer is blocked on ``put`` or mid ``read_region``; closing
    the slide then would free the native TIFF handle under the reader.
    ``stop()`` unblocks the producer, waits for it to finish, and only then
    should the caller close the slide.

    Items arrive via :meth:`get`: ``(index, bands)`` tuples, ``None`` at
    end of stream; producer exceptions re-raise in the consumer.
    """

    def __init__(self, n_items: int, read_fn, maxsize: int = 2):
        import queue as _queue
        import threading as _threading

        self._queue_mod = _queue
        self._q: "_queue.Queue" = _queue.Queue(maxsize=maxsize)
        self._stop = _threading.Event()
        self._n = n_items
        self._read = read_fn
        self._thread = _threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except self._queue_mod.Full:
                continue
        return False

    def _run(self) -> None:
        try:
            for i in range(self._n):
                if self._stop.is_set():
                    return
                if not self._put((i, self._read(i))):
                    return
            self._put(None)
        except BaseException as e:  # propagate to the consumer
            self._put(e)

    def get(self):
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        return item

    def stop(self) -> None:
        """Idempotent: unblock and join the producer (call before closing
        the slide handle, on every exit path)."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except self._queue_mod.Empty:
                break
        # unbounded: a band decode in flight must finish before the caller
        # frees the slide handle
        self._thread.join()


# Margin assigned to cells the tissue filter skipped: sigmoid(-1e4) is
# exactly 0.0f and any real tissue margin ranks above it.
NON_TISSUE_MARGIN: float = -1.0e4


def sigmoid(m: np.ndarray) -> np.ndarray:
    """Numerically-safe elementwise logistic on host (margin → prob).

    Only exponentiates non-positive values, so it never overflows and
    :data:`NON_TISSUE_MARGIN` underflows to exactly 0.0."""
    m = np.asarray(m, np.float32)
    pos = m >= 0
    z = np.exp(np.where(pos, -m, m))  # exponent ≤ 0: safe
    return np.where(pos, 1.0 / (1.0 + z), z / (1.0 + z)).astype(np.float32)


def prob_to_margin(p: float) -> float:
    """Inverse logistic: probability-space threshold → margin space."""
    p = min(max(float(p), 1e-12), 1.0 - 1e-12)
    return float(np.log(p / (1.0 - p)))


def margin_to_score(m) -> np.ndarray:
    """Detection score for the CSV: ``0.5 + 0.5*m/(1+|m|)`` ∈ (0, 1).

    Softsign, not the logistic: monotone in the margin and free of the
    float saturation ties the logistic gives past margin ~17, which would
    collapse the FROC consumer's operating points (it ranks by this value).
    """
    m = np.asarray(m, np.float64)
    return 0.5 + 0.5 * m / (1.0 + np.abs(m))


SLIDE_EXTENSIONS = (".wsi.npz", ".tif", ".tiff")


def slide_name(filename: str) -> str:
    """Slide name without its container extension (``tumor_001.wsi.npz`` →
    ``tumor_001``)."""
    for ext in SLIDE_EXTENSIONS:
        if filename.endswith(ext):
            return filename[: -len(ext)]
    return os.path.splitext(filename)[0]


def make_prob_step(model: torch.nn.Module, input_size: int = 224,
                   device_tissue_threshold: float | None = None):
    """Margin step. Not cached, unlike the JAX step (which is cached to
    avoid retracing): an eager closure costs nothing to build, and a cache
    would keep every model it saw alive on the card.

    The step maps a uint8 (B, S, S, 3) batch on the model's device to the
    float32 tumor logit margin ``logits[:,1] - logits[:,0]`` (B,), which
    keeps full ranking resolution where a float32 softmax saturates.

    With ``device_tissue_threshold`` set, normalize and the per-patch mean
    come from one pass of :func:`..ops.preprocess.fused_normalize` (the CUDA
    kernel for a CUDA batch), and white patches (mean > threshold) clamp to
    :data:`NON_TISSUE_MARGIN` on the device.

    The normalized batch is written directly in the model's dtype when no
    resize follows. The JAX step writes float32 and its model then casts to
    bfloat16; one float32 → bfloat16 rounding gives the same bits either
    way, and writing bfloat16 halves the kernel's stores. A resize runs in
    float32, as in the JAX step (normalize is a per-channel affine, so it
    commutes with the bilinear resize).
    """

    @torch.inference_mode()
    def prob_step(imgs_u8: torch.Tensor) -> torch.Tensor:
        dtype = torch.float32
        if imgs_u8.shape[1] == input_size:
            dtype = next(model.parameters()).dtype
        means = None
        if device_tissue_threshold is None:
            imgs = normalize(imgs_u8, dtype)
        else:
            imgs, means = fused_normalize(imgs_u8, dtype)
        if imgs.shape[1] != input_size:
            imgs = resize(imgs, input_size)
        logits = model(imgs)
        margin = logits[:, 1] - logits[:, 0]
        if means is not None:
            margin = torch.where(means > device_tissue_threshold,
                                 NON_TISSUE_MARGIN, margin)
        return margin

    return prob_step


def _resize_u8(imgs_u8: torch.Tensor, input_size: int) -> torch.Tensor:
    """A uint8 batch at ``input_size``: bilinear resize in float32, rounded
    and clipped back to uint8, as the JAX int8 step resizes."""
    if imgs_u8.shape[1] == input_size:
        return imgs_u8
    f = resize(imgs_u8.to(torch.float32), input_size)
    return torch.round(f).clamp(0, 255).to(torch.uint8)


def make_prob_step_int8(input_size: int = 224):
    """int8 (w8a8) margin step over a quantized tree
    (``models/quantized.py``): ``prob_step(qtree, imgs_u8)`` maps a uint8
    (B, S, S, 3) batch on the tree's device to the float32 margins (B,);
    patches of another size resize on the device. Not cached (see
    :func:`make_prob_step`)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quantized import (
        quant_forward,
    )

    @torch.inference_mode()
    def prob_step(qtree, imgs_u8: torch.Tensor) -> torch.Tensor:
        logits = quant_forward(qtree, _resize_u8(imgs_u8, input_size),
                               with_fc=True)
        return logits[:, 1] - logits[:, 0]

    return prob_step


class _BatchPipeline:
    """A window of ``depth`` in-flight batches (4, as in the JAX module).

    ``step`` and ``device`` may be lists, one step per device: each batch is
    then split in contiguous rows of ``ceil(batch_size / devices)``, each
    part uploaded to its device and run by its step, and the results land
    in the batch's order.

    The host fills :attr:`host` (a numpy view of a pinned uint8 buffer on a
    CUDA device), :meth:`dispatch` copies it to the device without
    blocking, runs the step, and starts the result's copy back into a
    pinned buffer; a result is read only once it falls off the window. A
    ring of ``depth + 1`` buffers means the one being filled is never one a
    pending batch still reads. On the CPU everything runs synchronously.

    ``patch_size`` is one edge, or ``{level: edge}`` for a multiscale step,
    which then takes a dict of per-level batches and :attr:`host` is a dict
    of per-level buffers. ``columns`` gives each cell a row of that many
    results. ``out`` is the array the results land in at their positions,
    or a function ``out(positions, values)`` that takes them.
    ``before(batch)``, where given, sees each whole batch (host tensors of
    its rows, a dict of them for a multiscale step) before the split: the
    int8 path's lazy calibration.
    """

    DEPTH = 4

    def __init__(self, step, device, batch_size: int,
                 patch_size: int | dict, out, columns: int | None = None,
                 depth: int = DEPTH, before=None):
        many = isinstance(device, (list, tuple))
        self._devices = list(device) if many else [device]
        self._steps = list(step) if many else [step]
        self._part = -(-batch_size // len(self._devices))
        pin = any(d.type == "cuda" for d in self._devices)
        ring = depth + 1
        self._single = not isinstance(patch_size, dict)
        sizes = {None: patch_size} if self._single else dict(patch_size)
        # rows are written whole before they are sent: no fill needed
        self._bufs = [
            {key: torch.empty((batch_size, ps, ps, 3), dtype=torch.uint8,
                              pin_memory=pin) for key, ps in sizes.items()}
            for _ in range(ring)
        ]
        shape = (batch_size,) if columns is None else (batch_size, columns)
        self._results = [torch.empty(shape, dtype=torch.float32,
                                     pin_memory=pin) for _ in range(ring)]
        self._out = out
        self._depth = depth
        self._before = before
        self._slot = 0
        self._pending: deque = deque()  # (result view, positions, event)
        self.host = self._host_views()

    def _host_views(self):
        bufs = self._bufs[self._slot]
        if self._single:
            return bufs[None].numpy()
        return {key: b.numpy() for key, b in bufs.items()}

    def dispatch(self, positions: list) -> None:
        k = len(positions)
        res = self._results[self._slot][:k]
        if self._before is not None:
            batch = {key: b[:k] for key, b in self._bufs[self._slot].items()}
            self._before(batch[None] if self._single else batch)
        events = []
        for i, (dev, step) in enumerate(zip(self._devices, self._steps)):
            lo, hi = i * self._part, min(k, (i + 1) * self._part)
            if lo >= hi:
                break
            imgs = {key: b[lo:hi].to(dev, non_blocking=True)
                    for key, b in self._bufs[self._slot].items()}
            res[lo:hi].copy_(step(imgs[None] if self._single else imgs),
                             non_blocking=True)
            if dev.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
                events.append(event)
        self._pending.append((res, np.asarray(positions), events))
        if len(self._pending) > self._depth:
            self._drain_one()
        self._slot = (self._slot + 1) % len(self._bufs)
        self.host = self._host_views()

    def _drain_one(self) -> None:
        res, positions, events = self._pending.popleft()
        for event in events:
            event.synchronize()
        if callable(self._out):
            self._out(positions, res.numpy())
        else:
            self._out[positions] = res.numpy()

    def finish(self) -> None:
        while self._pending:
            self._drain_one()

    def discard(self) -> None:
        """Wait for the batches in flight and drop their results."""
        while self._pending:
            for event in self._pending.popleft()[2]:
                event.synchronize()


def replicate_model(model: torch.nn.Module, devices: Sequence[torch.device]
                    ) -> list[torch.nn.Module]:
    """One copy of an inference ``model`` on each of ``devices`` (the model
    itself where it already lies; its dtype and memory format kept)."""
    own = next(model.parameters()).device
    return [model if dev == own
            else copy.deepcopy(model).to(device=dev,
                                         memory_format=torch.channels_last)
            for dev in devices]


def predict_slide(
    slide_or_path: Slide | str,
    model: torch.nn.Module | Sequence[torch.nn.Module],
    level: int = 3,
    stride: int | None = None,
    batch_size: int = 512,
    tissue_threshold: float = TISSUE_MEAN_RGB_THRESHOLD,
    input_size: int = 224,
    output: str = "prob",
    tissue_filter: str = "host",
    int8: bool = False,
    qtree: dict | None = None,
    *,
    device: str | torch.device,
    devices: Sequence[str | torch.device] | None = None,
) -> tuple[np.ndarray, PatchGrid]:
    """Tumor probability (or margin) per grid cell.

    Returns (grid values (ny, nx) float32 indexed [y_idx, x_idx], grid).
    ``output="prob"`` gives probabilities with non-tissue cells at 0;
    ``output="margin"`` the logit margins with non-tissue cells at
    :data:`NON_TISSUE_MARGIN`, which the detection producers need.

    ``model`` must already lie on ``device`` (``model.to(device)``); its
    parameters' dtype is the compute dtype. ``tissue_filter`` picks where
    the white-patch short-circuit runs:

    - ``"host"``: per-cell ``mean > threshold`` on the host before batching;
      white cells are never uploaded.
    - ``"device"``: every cell uploads, and the fused normalize kernel gives
      the per-patch means from the same pass, clamping white cells on the
      device; the host never computes per-patch means. Float path only.

    ``int8=True`` runs the int8 forward: with a ``qtree`` (a persisted
    ``models/quant_artifact.py`` tree, calibrated once on training tissue)
    outputs do not depend on batch size or slide; without one, the model's
    weights are quantized with scales calibrated on this slide's first
    whole tissue batch (with one white cell beside it when that batch is
    short: the JAX function calibrates on its white-padded batch buffer),
    on ``device``, before the batch is split, and the tree is copied to
    every device.

    ``devices`` (``device`` first among them; the JAX function's ``mesh``):
    each batch is split in contiguous rows over the devices, with a replica
    of ``model`` on each (``model`` may also be the list of replicas,
    :func:`replicate_model`), and ``batch_size`` is rounded up to a
    multiple of their number.
    """
    if output not in ("prob", "margin"):
        raise ValueError(f"unknown output mode {output!r}")
    if tissue_filter not in ("host", "device"):
        raise ValueError(f"unknown tissue_filter {tissue_filter!r}")
    if tissue_filter == "device" and int8:
        raise ValueError(
            "tissue_filter='device' is the float single-chip path: the int8 "
            "stem folds normalization into its weights, and the meshed step "
            "would replicate the pallas_call per device"
        )
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    dev = resolve_device(device)
    devs = [dev] if devices is None else [resolve_device(d) for d in devices]
    if devs[0] != dev:
        raise ValueError(f"device {dev} must be the first of devices {devs}")
    models = (list(model) if isinstance(model, (list, tuple))
              else [model] + replicate_model(model, devs[1:]))
    if len(models) != len(devs):
        raise ValueError(f"{len(models)} model replicas for {len(devs)} "
                         "devices")
    for m, d in zip(models, devs):
        model_dev = next(m.parameters()).device
        if model_dev != d:
            raise ValueError(
                f"model lies on {model_dev}, not {d}: move it with "
                "model.to(device) first"
            )
    if batch_size % len(devs):
        batch_size = -(-batch_size // len(devs)) * len(devs)
        log.info("batch_size rounded up to %d (multiple of the %d-device "
                 "mesh)", batch_size, len(devs))
    own = isinstance(slide_or_path, str)
    slide = open_slide(slide_or_path) if own else slide_or_path
    try:
        grid = PatchGrid.for_slide_level(
            level,
            slide.level_dimensions[level],
            slide.level_downsamples[level],
            stride=stride,
        )
        coords = grid.coords_array()
        ps = grid.patch_size
        calibrate = None
        if int8:
            steps, calibrate = _int8_steps(models, qtree, input_size,
                                           batch_size, devs)
        else:
            steps = [make_prob_step(
                m,
                input_size,
                float(tissue_threshold) if tissue_filter == "device" else None,
            ) for m in models]
        stride_px = grid.stride
        n = len(coords)
        # margins throughout; converted to probability at return if asked
        margins = np.full((n,), NON_TISSUE_MARGIN, np.float32)
        level_w, level_h = slide.level_dimensions[level]

        def read_band(iy: int) -> np.ndarray:
            """Decode one full-width grid row band, white-padded to a full
            patch height at the bottom edge."""
            y = iy * stride_px
            h = min(ps, level_h - y)
            band = slide.read_region(grid.level0_origin(0, y), level,
                                     (level_w, h))
            if h < ps:
                full = np.full((ps, level_w, 3), 255, np.uint8)
                full[:h] = band
                band = full
            return band

        ny, nx = grid.ny, grid.nx
        pipeline = _BatchPipeline(steps, devs, batch_size, ps, margins,
                                  before=calibrate)
        producer = BandProducer(ny, read_band)
        try:
            with Timer(f"predict_slide[{n} cells]", log):
                batch_pos: list[int] = []
                while True:
                    item = producer.get()
                    if item is None:
                        break
                    iy, band = item
                    for ix in range(nx):
                        x = ix * stride_px
                        patch = band[:, x : x + ps]
                        row = pipeline.host[len(batch_pos)]
                        w = patch.shape[1]
                        row[:, :w] = patch
                        row[:, w:] = 255  # white pad past the right edge
                        if (
                            tissue_filter == "host"
                            and row.mean() > tissue_threshold
                        ):
                            continue  # the row is overwritten by the next cell
                        # coords_array order is x-outer / y-inner (reference
                        # enumeration): flat index = ix * ny + iy
                        batch_pos.append(ix * ny + iy)
                        if len(batch_pos) == batch_size:
                            pipeline.dispatch(batch_pos)
                            batch_pos = []
                if batch_pos:
                    pipeline.dispatch(batch_pos)
                pipeline.finish()
        finally:
            # stop/join BEFORE the outer finally closes the slide handle
            producer.stop()

        out = np.full((ny, nx), NON_TISSUE_MARGIN, np.float32)
        for i, (x, y) in enumerate(coords):
            out[y // stride_px, x // stride_px] = margins[i]
        if output == "prob":
            out = sigmoid(out)
        return out, grid
    finally:
        if own:
            slide.close()


def _int8_steps(models: Sequence[torch.nn.Module], qtree: dict | None,
                input_size: int, batch_size: int,
                devs: Sequence[torch.device]):
    """The int8 path's ``(steps, calibrate)``: one ``step(imgs_u8)`` a
    device over one tree, a copy on each device. With a persisted ``qtree``
    the copies are made here and ``calibrate`` is None; without one,
    ``calibrate(batch_u8)`` (the pipeline's ``before``) quantizes
    ``models[0]`` on ``devs[0]`` at the first whole batch, before the
    split, as the JAX function calibrates before it shards the batch."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quantized import (
        quantize_resnet18,
        quantized_to,
    )

    qstep = make_prob_step_int8(input_size)
    # a persisted artifact: deterministic scales, no calibration per slide
    trees = None if qtree is None else [quantized_to(qtree, d) for d in devs]

    def calibrate(batch_u8: torch.Tensor) -> None:
        nonlocal trees
        if trees is not None:
            return
        # this slide's first tissue batch, resized as the step resizes (the
        # folded stem's bias map is bound to the calibration input size)
        cal = batch_u8.to(devs[0])
        if cal.shape[0] < batch_size:
            cal = torch.cat([cal, torch.full_like(cal[:1], 255)])
        weights = {k: v.float() for k, v in models[0].state_dict().items()}
        q = quantize_resnet18(weights, [_resize_u8(cal, input_size)],
                              device=devs[0])
        tree = q.tree()
        trees = [quantized_to(tree, d) for d in devs]

    def step_on(i: int):
        return lambda imgs_u8: qstep(trees[i], imgs_u8)

    return ([step_on(i) for i in range(len(devs))],
            calibrate if qtree is None else None)


def _component_mask(
    positive: np.ndarray, sy: int, sx: int
) -> np.ndarray:
    """4-connected component of True cells containing (sy, sx), within a
    small NMS localization window (≤ (2*com_radius+1)² cells)."""
    keep = np.zeros_like(positive, bool)
    keep[sy, sx] = True
    q = deque([(sy, sx)])
    h, w = positive.shape
    while q:
        y, x = q.popleft()
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            yy, xx = y + dy, x + dx
            if 0 <= yy < h and 0 <= xx < w and positive[yy, xx] and not keep[yy, xx]:
                keep[yy, xx] = True
                q.append((yy, xx))
    return keep


def nms_detections(
    prob_grid: np.ndarray,
    grid: PatchGrid,
    threshold: float = 0.5,
    radius_cells: int = 1,
    max_detections: int = 1000,
    com_radius: int = 2,
    com_weight=None,
) -> list[tuple[float, int, int]]:
    """Greedy grid NMS → [(score, x_level0, y_level0)].

    Space-agnostic: operates on whatever monotone score the grid carries
    (probability or logit margin); ``threshold`` must be in the same space.

    Each emitted coordinate is the centroid of the probability mass above
    the decision boundary (``com_weight``, default ``max(p - 0.5, 0)``) in
    the ``(2*com_radius+1)²`` window around the peak, restricted to the
    4-connected positive component that contains the peak; a zero-weight
    peak keeps its argmax centre. ``com_radius=0`` gives raw argmax
    centres. Centroids weigh the ORIGINAL field, including cells an earlier
    detection suppressed.
    """
    probs = prob_grid.copy()
    out: list[tuple[float, int, int]] = []
    ds = grid.downsample
    half = grid.patch_size // 2
    if com_weight is None:
        com_weight = lambda v: np.clip(v - 0.5, 0.0, None)  # noqa: E731
    weights = np.asarray(com_weight(prob_grid), np.float64)
    ny, nx = probs.shape
    while len(out) < max_detections:
        idx = np.unravel_index(np.argmax(probs), probs.shape)
        p = float(probs[idx])
        if p < threshold:
            break
        gy, gx = int(idx[0]), int(idx[1])
        cy, cx = float(gy), float(gx)
        if com_radius > 0:
            wy_lo, wy_hi = max(0, gy - com_radius), min(ny, gy + com_radius + 1)
            wx_lo, wx_hi = max(0, gx - com_radius), min(nx, gx + com_radius + 1)
            w = weights[wy_lo:wy_hi, wx_lo:wx_hi].copy()
            if w[gy - wy_lo, gx - wx_lo] <= 0.0:
                w[:] = 0.0
            else:
                w = np.where(
                    _component_mask(w > 0.0, gy - wy_lo, gx - wx_lo), w, 0.0
                )
            total = float(w.sum())
            if total > 0.0:
                yy, xx = np.mgrid[wy_lo:wy_hi, wx_lo:wx_hi]
                cy = float((yy * w).sum() / total)
                cx = float((xx * w).sum() / total)
        x0 = int((cx * grid.stride + half) * ds)
        y0 = int((cy * grid.stride + half) * ds)
        out.append((p, x0, y0))
        y_lo, y_hi = max(0, gy - radius_cells), gy + radius_cells + 1
        x_lo, x_hi = max(0, gx - radius_cells), gx + radius_cells + 1
        # -inf, not a finite sentinel: in margin space any finite value
        # can sit above the emission threshold
        probs[y_lo:y_hi, x_lo:x_hi] = -np.inf
    return out


def write_detection_csv(
    path: str, detections: list[tuple[float, int, int]]
) -> None:
    """CSV rows ``prob,x,y`` as the FROC reader expects (no header, 3
    columns)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        for prob, x, y in detections:
            w.writerow([prob, x, y])


def margin_detections(
    margin_grid: np.ndarray,
    grid: PatchGrid,
    threshold: float,
    **nms_kw,
) -> list[tuple[float, int, int]]:
    """NMS on a margin grid, scores squashed for the CSV.

    ``threshold`` is in probability space (the user-facing knob); it maps
    to margin space for the floor, and emitted scores are
    :func:`margin_to_score`. Centroid weights are the probability mass above
    the decision boundary, through the safe :func:`sigmoid`.
    """
    nms_kw.setdefault(
        "com_weight", lambda m: np.clip(sigmoid(m) - 0.5, 0.0, None)
    )
    dets = nms_detections(
        margin_grid, grid, threshold=prob_to_margin(threshold), **nms_kw
    )
    return [(float(margin_to_score(m)), x, y) for m, x, y in dets]


def predict_and_export(
    slide_path: str,
    model: torch.nn.Module,
    csv_dir: str,
    level: int = 3,
    threshold: float | None = None,
    **kw,
) -> tuple[np.ndarray, str]:
    """Full producer: probability grid + detection CSV for one slide.
    ``kw`` goes to :func:`predict_slide` (``device`` among them)."""
    if threshold is None:
        threshold = DETECTION_PROB_THRESHOLD
    name = slide_name(os.path.basename(slide_path))
    margins, grid = predict_slide(
        slide_path, model, level=level, output="margin", **kw
    )
    detections = margin_detections(margins, grid, threshold)
    csv_path = os.path.join(csv_dir, f"{name}.csv")
    write_detection_csv(csv_path, detections)
    log.info("%s: %d detections → %s", name, len(detections), csv_path)
    return sigmoid(margins), csv_path
