"""Hierarchical multiscale sliding-window slide inference.

Counterpart of the JAX package's ``infer/multiscale.py``: every grid cell
is classified from all its magnifications at once. The pyramid's per-level
patch sizes (1792/896/448/224 at levels 0-3) cover the same level-0 field
of view, so the co-located stack of a cell is well defined; the
:class:`~..models.hierarchical.HierarchicalPatchClassifier` fuses it
through one shared trunk (scales folded into the batch) and a fusion head.

Same producer contract as :mod:`.sliding_window`: a grid of calibrated
log-odds scores (five surfaces, :data:`COMBINE_COLUMNS`) → centroid-NMS
detections → ``prob,x,y`` CSV for the FROC consumer.

Each level of a batch is normalized by kernel 2a
(:func:`..ops.preprocess.fused_normalize`; its means are not used: the
host filters tissue on the base patch, as the JAX function does), in the
model's dtype when no resize follows and in float32 before one. With
``int8=True`` the shared trunk runs the int8 forward of
``models/quantized.py`` on the stacked (S·B, 224, 224, 3) batch (kernels 2d,
``int8_conv_requant`` and ``int8_maxpool``) and the heads stay float. The
``cascade`` screens every tissue cell with the base level's aux head first
and runs the fused model on the survivors only.

One device, or several (``devices``, the JAX function's ``mesh``): each
batch of co-located cells is then split in contiguous rows over the
devices, one model replica each, and each replica runs its rows' stacked
S·B trunk batch (the slide fleet, ``infer/fleet.py``, passes a group's
devices). The model and its calibration travel
as two arguments (the JAX function reads both from one ``variables`` tree;
:func:`..models.convert.split_calibration` takes an artifact apart).
"""

from __future__ import annotations

import functools
import os
from typing import Mapping

import numpy as np
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    DETECTION_PROB_THRESHOLD,
    TISSUE_MEAN_RGB_THRESHOLD,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
    resize,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
    resolve_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation.calibration import (
    decode_combine,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.pyramid import (
    PatchGrid,
    patch_size_for_level,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
    NON_TISSUE_MARGIN,
    BandProducer,
    _BatchPipeline,
    replicate_model,
    _resize_u8,
    margin_detections,
    prob_to_margin,
    sigmoid,
    slide_name,
    write_detection_csv,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
    Slide,
    open_slide,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    Timer,
    get_logger,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.hierarchical import (
    HierarchicalPatchClassifier,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.preprocess import (
    fused_normalize,
)

log = get_logger("torch.infer.multiscale")

COMBINE_COLUMNS = ("ensemble", "fusion", "aux", "aux_base", "ensemble_base")

#: component surfaces ``--ms_components`` exports next to the main CSV (dirs
#: ``<csv_dir>_<name>``); "ensemble" is omitted: it is the main CSV whenever
#: the calibration selects it
COMPONENT_EXPORTS = ("fusion", "aux", "aux_base", "ensemble_base")

#: rows of each call of the int8 step's float heads. cuBLAS and MKL pick a
#: GEMM kernel by the row count, and kernels sum in other orders: heads
#: called on a fixed number of rows score a cell the same at any batch size
#: and on any split over devices, as the int8 trunk does.
HEAD_ROWS = 64


def _in_row_chunks(fn, x: torch.Tensor, rows: int = HEAD_ROWS) -> torch.Tensor:
    """``fn`` over ``x``'s rows in calls of exactly ``rows`` rows (the last
    one padded with zeros), the results cut back to ``x``'s rows."""
    n = x.shape[0]
    x = torch.cat([x, x.new_zeros((-n % rows, *x.shape[1:]))])
    return torch.cat([fn(chunk) for chunk in x.split(rows)])[:n]


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a float32 0-d tensor on ``like``'s device: a division by
    it is the IEEE quotient on the card too (by a host scalar PyTorch
    multiplies with the reciprocal there)."""
    return torch.full((), float(value), dtype=torch.float32, device=like.device)


def _combine_scores(logits: torch.Tensor, aux: torch.Tensor | None,
                    temperature: float, aux_temperature: float,
                    ensemble_weight: float,
                    ensemble_base_weight: float = 0.5) -> torch.Tensor:
    """(fusion logits (B, 2), aux logits (B, S, 2) or None) → (B, 5)
    detection scores in calibrated log-odds space, columns
    :data:`COMBINE_COLUMNS`: [ensemble, fusion, aux-mean, aux-base,
    ensemble-base].

    Per head the score is the logit margin over its fitted temperature
    (rank-identical to the temperature-scaled probability, without its
    float32 saturation). ``ensemble`` mixes the fusion and aux-mean
    log-odds with the validation-selected weight; ``aux_base`` is the base
    (detection-grid) level's aux margin alone, aux column −1 (levels sorted
    ascending, the base = the largest level number); ``ensemble_base``
    mixes fusion with it. Without aux heads every column carries the fusion
    score."""
    z = logits.float()
    m_fusion = (z[:, 1] - z[:, 0]) / _scalar(temperature, z)
    if aux is None:
        return torch.stack([m_fusion] * len(COMBINE_COLUMNS), dim=1)
    za = aux.float()
    m_per_level = (za[:, :, 1] - za[:, :, 0]) / _scalar(aux_temperature, za)
    m_aux = torch.mean(m_per_level, dim=1)
    m_base = m_per_level[:, -1]
    m_ens = ensemble_weight * m_fusion + (1.0 - ensemble_weight) * m_aux
    m_ens_base = (ensemble_base_weight * m_fusion
                  + (1.0 - ensemble_base_weight) * m_base)
    return torch.stack([m_ens, m_fusion, m_aux, m_base, m_ens_base], dim=1)


def _crops(lvl: int, levels: tuple, input_mode: str, size: int,
           input_size: int) -> bool:
    """``"crop"`` takes a finer level's center at native magnification; the
    base (coarsest) level is never cropped: it defines the cell's field of
    view."""
    return input_mode == "crop" and lvl != levels[-1] and size > input_size


def _center(x: torch.Tensor, input_size: int) -> torch.Tensor:
    off = (x.shape[1] - input_size) // 2
    return x[:, off:off + input_size, off:off + input_size]


def _normalized(x_u8: torch.Tensor, input_size: int,
                dtype: torch.dtype) -> torch.Tensor:
    """One level of a batch normalized on kernel 2a (its means dropped):
    written in ``dtype`` when it is already at ``input_size``, else in
    float32 and then resized (normalize is a per-channel affine, so it
    commutes with the bilinear resize, as in the JAX step)."""
    if x_u8.shape[1] == input_size:
        return fused_normalize(x_u8.contiguous(), dtype)[0]
    x, _ = fused_normalize(x_u8.contiguous(), torch.float32)
    return resize(x, input_size)


def make_prob_step_multiscale(
    model: HierarchicalPatchClassifier, levels, input_size: int = 224,
    temperature: float = 1.0, aux_temperature: float = 1.0,
    ensemble_weight: float = 1.0, with_aux: bool = False,
    ensemble_base_weight: float = 0.5, input_mode: str = "resize",
):
    """Step: ``{level: uint8 (B, ps_l, ps_l, 3)}`` on the model's device →
    (B, 5) float32 scores in calibrated log-odds space
    (:func:`_combine_scores`). Not cached (see
    ``sliding_window.make_prob_step``).

    A cropped level is cropped before it is normalized, which gives the
    same numbers as the JAX step's normalize-then-crop (normalize acts per
    pixel) and normalizes a quarter of the pixels. The base level and a
    cropped level are written in the model's dtype directly; a resized
    level in float32, as the JAX step resizes (one float32 → bfloat16
    rounding either way)."""
    levels = tuple(sorted(levels))

    @torch.inference_mode()
    def prob_step(batch_by_level: Mapping[int, torch.Tensor]) -> torch.Tensor:
        dtype = model.trunk.conv1.weight.dtype
        prepared = {}
        for lvl in levels:
            x = batch_by_level[lvl]
            if _crops(lvl, levels, input_mode, x.shape[1], input_size):
                x = _center(x, input_size)
            prepared[lvl] = _normalized(x, input_size, dtype)
        out = model(prepared, with_aux=with_aux)
        logits, aux = out if with_aux else (out, None)
        return _combine_scores(logits, aux, temperature, aux_temperature,
                               ensemble_weight, ensemble_base_weight)

    return prob_step


def make_screen_step_base(model: HierarchicalPatchClassifier,
                          input_size: int = 224,
                          aux_temperature: float = 1.0):
    """Cascade screen: uint8 (B, ps_base, ps_base, 3) → (B,) calibrated
    aux-base log-odds margins: the shared trunk on the BASE level only and
    that level's scale-embedded aux head (1/S of the fused step's trunk
    batch, none of the finer-level decode)."""

    @torch.inference_mode()
    def screen_step(x_u8: torch.Tensor) -> torch.Tensor:
        x = _normalized(x_u8, input_size, model.trunk.conv1.weight.dtype)
        za = model.base_aux_logits(model.trunk(x))
        return (za[:, 1] - za[:, 0]) / _scalar(aux_temperature, za)

    return screen_step


def make_prob_step_multiscale_int8(
    model: HierarchicalPatchClassifier, levels, input_size: int = 224,
    temperature: float = 1.0, aux_temperature: float = 1.0,
    ensemble_weight: float = 1.0, with_aux: bool = False,
    ensemble_base_weight: float = 0.5, input_mode: str = "resize",
):
    """int8 step ``prob_step(qtree, {level: uint8 batch})`` → (B, 5) scores:
    the shared trunk runs the int8 (w8a8) forward once on the stacked
    (S·B, input, input, 3) batch, the scale embedding and the heads stay
    float (:meth:`~..models.hierarchical.HierarchicalPatchClassifier.fuse`,
    ``aux_logits``), in calls of :data:`HEAD_ROWS` rows. A finer level is
    cropped, or resized in float32 and rounded back to uint8, as in the JAX
    step."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quantized import (
        quant_forward,
    )

    levels = tuple(sorted(levels))

    @torch.inference_mode()
    def prob_step(qtree, batch_by_level: Mapping[int, torch.Tensor]
                  ) -> torch.Tensor:
        parts = []
        for lvl in levels:
            x = batch_by_level[lvl]
            if _crops(lvl, levels, input_mode, x.shape[1], input_size):
                x = _center(x, input_size)
            else:
                x = _resize_u8(x, input_size)
            parts.append(x)
        feats = quant_forward(qtree, torch.cat(parts), with_fc=False)
        b = parts[0].shape[0]
        feats = feats.reshape(len(levels), b, -1).transpose(0, 1).float()
        logits = _in_row_chunks(model.fuse, feats)
        aux = _in_row_chunks(model.aux_logits, feats) if with_aux else None
        return _combine_scores(logits, aux, temperature, aux_temperature,
                               ensemble_weight, ensemble_base_weight)

    return prob_step


def make_screen_step_base_int8(model: HierarchicalPatchClassifier,
                               input_size: int = 224,
                               aux_temperature: float = 1.0):
    """int8 cascade screen ``screen_step(qtree, x_u8)``: the persisted
    quantized trunk on the base level only, the float aux head (the
    deployment pairing of ``--cascade`` with ``--int8`` and a
    ``--quantize`` artifact)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quantized import (
        quant_forward,
    )

    @torch.inference_mode()
    def screen_step(qtree, x_u8: torch.Tensor) -> torch.Tensor:
        feats = quant_forward(qtree, _resize_u8(x_u8, input_size),
                              with_fc=False).float()
        za = model.base_aux_logits(feats)
        return (za[:, 1] - za[:, 0]) / _scalar(aux_temperature, za)

    return screen_step


def _lazy_trunk_tree(model: HierarchicalPatchClassifier,
                     batch_by_level: Mapping[int, torch.Tensor], levels,
                     input_size: int, batch_size: int,
                     dev: torch.device) -> dict:
    """The trunk quantized with scales calibrated on the first whole fused
    batch (host or device tensors), on ``dev``. Every level is resized as
    the JAX function's calibration resizes it (a ``"crop"`` level too: the
    JAX function calibrates on the resized fine stream). The JAX buffers are white-padded to
    ``batch_size`` rows, so a short batch gets one white cell per level
    beside it (the same maxima)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quantized import (
        quantize_resnet18,
        quantized_to,
    )

    cal = []
    for lvl in levels:
        x = batch_by_level[lvl].to(dev)
        if x.shape[0] < batch_size:
            x = torch.cat([x, torch.full_like(x[:1], 255)])
        cal.append(_resize_u8(x, input_size))
    weights = {k: v.float() for k, v in model.trunk.state_dict().items()}
    q = quantize_resnet18(weights, [torch.cat(cal)], device=dev)
    return quantized_to(q.tree(), dev)


def predict_slide_multiscale(
    slide_or_path: Slide | str,
    model: HierarchicalPatchClassifier,
    calibration: Mapping[str, float] | None = None,
    levels=(2, 3),
    stride: int | None = None,
    batch_size: int = 128,
    tissue_threshold: float = TISSUE_MEAN_RGB_THRESHOLD,
    input_size: int = 224,
    int8: bool = False,
    combine: str = "auto",
    return_components: bool = False,
    qtree: dict | None = None,
    output: str = "prob",
    cascade: float | str | None = None,
    cascade_bailout: float = 0.6,
    cell_filter: np.ndarray | None = None,
    input_mode: str | None = None,
    *,
    device: str | torch.device,
    devices=None,
):
    """Multiscale tumor probability per co-located grid cell.

    The grid lives on the BASE level requested (the largest level number,
    the most downsampled plane: the single-level producer's own level); a
    cell's patch at a finer level shares its level-0 origin and field of
    view. ``stride`` is in base-level pixels. ``model`` must already lie on
    ``device`` (:meth:`~..models.hierarchical.HierarchicalPatchClassifier.
    for_inference`); ``calibration`` is the artifact's (temperatures,
    weights, ``combine``, ``input_mode``, ``cascade_margin``; missing keys
    take the JAX function's defaults).

    ``devices`` (``device`` first among them): each batch is split in
    contiguous rows over the devices, with a replica of ``model`` on each
    (``model`` may also be the list of replicas), and ``batch_size`` is
    rounded up to a multiple of their number.

    ``combine`` selects the reported surface: ``"auto"`` (the one the
    calibration selected; fusion-only for artifacts without aux heads),
    ``"ensemble"``, ``"fusion"``, ``"aux"`` (per-scale mean), ``"aux_base"``
    (the base level's aux head alone) or ``"ensemble_base"`` (fusion ×
    aux-base mix). All five come from one pass; ``return_components=True``
    also returns ``{column: (ny, nx)}`` for :data:`COMBINE_COLUMNS`.
    ``output="margin"`` returns calibrated log-odds surfaces (non-tissue =
    ``NON_TISSUE_MARGIN``) instead of probabilities.

    ``int8=True`` runs the shared trunk quantized: from ``qtree`` (a
    persisted trunk artifact) or, without one, with scales calibrated on
    the slide's first whole fused batch on ``device``, before the split,
    the tree then copied to every device; the heads stay float.

    ``cascade`` screens every tissue cell with the base level's aux head
    first and runs the fused model on the survivors only; rows without a
    survivor are not read again, and a survivor row reads only the x-span of
    its survivors. The floor: ``"auto"``, the artifact's
    ``cascade_margin`` (ignored with a log line when there is none), or a
    probability in [0, 1) taken through the calibrated sigmoid.
    ``cascade_bailout`` abandons the screen (and runs the full fused pass)
    once a sample of max(2 · batch, min(1024, a quarter of the estimated
    tissue)) cells has been screened and more than this fraction survives,
    or, where the screen ends before that sample, on the final tally;
    ``>= 1`` disables the probe. The screen keeps at most two batches in
    flight, so the probe reads the tally at the JAX function's lag.
    Screened-out tissue cells carry their screen margin in ``aux_base`` and
    the selected column only; the other components stay non-tissue. It
    needs aux heads (ignored otherwise); with ``int8`` and a ``qtree`` the
    screen runs the quantized trunk, else float.

    ``cell_filter`` (internal) restricts evaluation to a boolean (ny, nx)
    mask: the cascade's second pass.

    Returns (scores (ny, nx), base grid[, components]).
    """
    if output not in ("prob", "margin"):
        raise ValueError(f"unknown output mode {output!r}")
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    levels = tuple(sorted(levels))
    base = max(levels)
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
                "model.for_inference(device, dtype) first"
            )
    if batch_size % len(devs):
        batch_size = -(-batch_size // len(devs)) * len(devs)
        log.info("batch_size rounded up to %d (multiple of the %d-device "
                 "mesh)", batch_size, len(devs))
    model = models[0]
    own = isinstance(slide_or_path, str)
    slide = open_slide(slide_or_path) if own else slide_or_path
    try:
        grid = PatchGrid.for_slide_level(
            base,
            slide.level_dimensions[base],
            slide.level_downsamples[base],
            stride=stride,
        )
        calibration = dict(calibration or {})
        has_aux = model.aux_head is not None
        temperature = float(calibration.get("temperature", 1.0))
        aux_temperature = float(calibration.get("aux_temperature", 1.0))
        ensemble_weight = float(
            calibration.get("ensemble_weight", 1.0 if not has_aux else 0.5))
        ensemble_base_weight = float(calibration.get(
            "ensemble_base_weight",
            # earlier artifacts wrote the weight under the misnamed key (see
            # evaluation.calibration._LEGACY_COMBINE)
            calibration.get("ensemble_fine_weight", 0.5)))
        if input_mode is None:
            # the artifact records how it was trained (0=resize, 1=crop);
            # serving must match or the fine stream's meaning flips
            input_mode = ("crop" if int(calibration.get("input_mode", 0))
                          else "resize")
        if combine != "auto" and combine not in COMBINE_COLUMNS:
            raise ValueError(f"unknown combine mode {combine!r}")
        if combine == "auto":
            # the calibration's detection-grade choice; artifacts from
            # before mode selection shipped ensemble scores in column 0
            combine = decode_combine(calibration.get("combine", "ensemble"))
        if not has_aux and combine != "fusion":
            combine = "fusion"  # artifact without aux heads: fusion only
        col = COMBINE_COLUMNS.index(combine)
        step_kw = dict(
            temperature=temperature, aux_temperature=aux_temperature,
            ensemble_weight=ensemble_weight, with_aux=has_aux,
            ensemble_base_weight=ensemble_base_weight, input_mode=input_mode,
        )
        qstate: dict = {}
        if int8:
            from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quantized import (
                quantized_to,
            )

            qsteps = [make_prob_step_multiscale_int8(m, levels, input_size,
                                                     **step_kw)
                      for m in models]
            if qtree is not None:
                # persisted trunk artifact: deterministic scales
                qstate["trees"] = [quantized_to(qtree, d) for d in devs]
        else:
            fsteps = [make_prob_step_multiscale(m, levels, input_size,
                                                **step_kw) for m in models]

        ps = {lvl: patch_size_for_level(lvl) for lvl in levels}
        ds = {lvl: slide.level_downsamples[lvl] for lvl in levels}
        dims = {lvl: slide.level_dimensions[lvl] for lvl in levels}
        # base-level px → level px (power-of-two pyramid ratios)
        ratio = {lvl: ds[base] / ds[lvl] for lvl in levels}

        def read_bands(iy: int, which=levels,
                       cells: tuple[int, int] | None = None):
            """Co-located band per level for one grid row.

            ``cells=(lo, hi)`` restricts the decode to the x-span covering
            grid cells lo..hi inclusive; None reads full width. Returns
            (bands, x-offsets): each band's first column sits at level pixel
            ``xoff[lvl]``."""
            y0_l0 = int(iy * grid.stride * ds[base])
            out: dict[int, np.ndarray] = {}
            xoffs: dict[int, int] = {}
            for lvl in which:
                w_l, h_l = dims[lvl]
                if cells is None:
                    x_l, wspan = 0, w_l
                else:
                    lo, hi = cells
                    # cell x-starts use the SAME rounding as the consumer's
                    # per-cell index, so relative slicing is pixel-exact
                    x_l = int(round(lo * grid.stride * ratio[lvl]))
                    wspan = (int(round(hi * grid.stride * ratio[lvl]))
                             + ps[lvl] - x_l)
                xoffs[lvl] = x_l
                y_l = int(round(y0_l0 / ds[lvl]))
                h = min(ps[lvl], h_l - y_l)
                if h <= 0:
                    # rounding can put a coarse-level band start at or past
                    # the level height: the band is all white
                    out[lvl] = np.full((ps[lvl], wspan, 3), 255, np.uint8)
                    continue
                band = slide.read_region((int(x_l * ds[lvl]), y0_l0), lvl,
                                         (wspan, h))
                if h < ps[lvl]:
                    full = np.full((ps[lvl], wspan, 3), 255, np.uint8)
                    full[:h] = band
                    band = full
                out[lvl] = band
            return out, xoffs

        ny, nx = grid.ny, grid.nx
        n = grid.num_patches
        # log-odds scores (COMBINE_COLUMNS); the logistic applied at return
        ncol = len(COMBINE_COLUMNS)
        probs = np.full((n, ncol), NON_TISSUE_MARGIN, np.float32)

        screen_margins = None
        if cascade is not None and cell_filter is None:
            if not has_aux:
                log.info("cascade requested but the artifact has no aux "
                         "heads; running the full fused pass on every tissue "
                         "cell")
            elif cascade == "auto" and "cascade_margin" not in calibration:
                log.info("cascade=auto but the artifact ships no fitted "
                         "operating point (older artifact, or the base-level "
                         "screen was uninformative on validation); running "
                         "the full fused pass")
            else:
                if int8 and "trees" in qstate:
                    # persisted artifact: the screen runs the quantized
                    # trunk too. Lazy int8 calibrates on the first FUSED
                    # batch, which does not exist yet: that path screens
                    # float
                    screen = [functools.partial(
                        make_screen_step_base_int8(
                            m, input_size, aux_temperature=aux_temperature),
                        tree) for m, tree in zip(models, qstate["trees"])]
                else:
                    screen = [make_screen_step_base(
                        m, input_size, aux_temperature=aux_temperature)
                        for m in models]
                floor = (float(calibration["cascade_margin"])
                         if cascade == "auto" else prob_to_margin(float(cascade)))
                screen_margins = _cascade_screen(
                    screen, lambda iy: read_bands(iy, (base,))[0][base], grid,
                    ps[base], batch_size, tissue_threshold, floor,
                    cascade_bailout, devs)
                if screen_margins is not None:
                    cell_filter = screen_margins >= floor
                    log.info("cascade: %d / %d tissue cells survive the "
                             "base-level screen (margin >= %g%s)",
                             int(cell_filter.sum()),
                             int((screen_margins > NON_TISSUE_MARGIN).sum()),
                             floor, ", artifact operating point"
                             if cascade == "auto" else "")

        if cell_filter is None:
            rows = list(range(ny))

            def read_row(k: int):
                return read_bands(rows[k])
        else:
            # rows with no surviving cell are never decoded in pass 2, and
            # surviving rows decode only the x-span of their survivors
            rows = [iy for iy in range(ny) if bool(cell_filter[iy].any())]

            def read_row(k: int):
                xs = np.flatnonzero(cell_filter[rows[k]])
                return read_bands(rows[k], cells=(int(xs[0]), int(xs[-1])))

        def device_step(i: int):
            def step(batch_by_level):
                if not int8:
                    return fsteps[i](batch_by_level)
                return qsteps[i](qstate["trees"][i], batch_by_level)
            return step

        def calibrate(batch_by_level) -> None:
            """Lazy int8: one trunk tree from the first whole batch, before
            the split, copied to every device."""
            if "trees" not in qstate:
                tree = _lazy_trunk_tree(model, batch_by_level, levels,
                                        input_size, batch_size, dev)
                qstate["trees"] = [quantized_to(tree, d) for d in devs]

        # the base level first: the host filter reads it
        order = (base,) + tuple(lvl for lvl in levels if lvl != base)
        pipeline = _BatchPipeline([device_step(i) for i in range(len(devs))],
                                  devs, batch_size, ps, probs, columns=ncol,
                                  before=calibrate if int8 else None)
        producer = BandProducer(len(rows), read_row)
        try:
            with Timer(f"predict_slide_multiscale[{n} cells]", log):
                batch_pos: list[int] = []
                while True:
                    item = producer.get()
                    if item is None:
                        break
                    k, (bands, xoffs) = item
                    iy = rows[k]
                    for ix in range(nx):
                        if cell_filter is not None and not cell_filter[iy, ix]:
                            continue
                        j = len(batch_pos)
                        host = pipeline.host
                        white = False
                        for lvl in order:
                            x_l = (int(round(ix * grid.stride * ratio[lvl]))
                                   - xoffs[lvl])
                            patch = bands[lvl][:, x_l : x_l + ps[lvl]]
                            row = host[lvl][j]
                            w = patch.shape[1]
                            row[:, :w] = patch
                            row[:, w:] = 255  # white pad past the right edge
                            if lvl == base and row.mean() > tissue_threshold:
                                white = True
                                break  # the rows are overwritten next
                        if white:
                            continue
                        batch_pos.append(ix * ny + iy)  # reference x-major order
                        if len(batch_pos) == batch_size:
                            pipeline.dispatch(batch_pos)
                            batch_pos = []
                if batch_pos:
                    pipeline.dispatch(batch_pos)
                pipeline.finish()
        finally:
            # stop/join BEFORE the outer finally closes the slide handle
            producer.stop()

        # flat index ix * ny + iy → [column, iy, ix]
        grids = np.ascontiguousarray(probs.reshape(nx, ny, ncol).transpose(2, 1, 0))
        if screen_margins is not None:
            # screened-out tissue cells carry the screen margin ONLY where it
            # is that estimate: the aux_base column (the screen IS the
            # aux_base head) and the selected output column (a dense shipped
            # surface); the other components stay non-tissue
            fill = (screen_margins > NON_TISSUE_MARGIN) & ~cell_filter
            grids[COMBINE_COLUMNS.index("aux_base"), fill] = screen_margins[fill]
            grids[col, fill] = screen_margins[fill]
        if output == "prob":
            grids = sigmoid(grids)
        out = grids[col]
        if return_components:
            components = {name: grids[i] for i, name in enumerate(COMBINE_COLUMNS)}
            return out, grid, components
        return out, grid
    finally:
        if own:
            slide.close()


def _cascade_screen(screen, read_band, grid: PatchGrid, ps_base: int,
                    batch_size: int, tissue_threshold: float,
                    cascade_floor: float, cascade_bailout: float,
                    dev) -> np.ndarray | None:
    """The cascade's first pass: ``screen`` (uint8 base patches → margins;
    one step per device of the list ``dev``) over every tissue cell of the
    base level, read a row at a time by ``read_band``. Returns the (ny, nx) screen margins, or None after a
    bailout (the full fused pass then scores every cell)."""
    ny, nx, n = grid.ny, grid.nx, grid.num_patches

    def probe_min(rows_done: int, screened_so_far: int) -> int:
        # 1024 cells, or a quarter of the slide's ESTIMATED tissue, never
        # less than two full batches
        est_tissue = (screened_so_far * ny // max(rows_done, 1)
                      if rows_done else n)
        return max(2 * batch_size, min(1024, (est_tissue + 3) // 4))

    tally = {"screened": 0, "survivors": 0}
    screen_margins = np.full((ny, nx), NON_TISSUE_MARGIN, np.float32)

    def take(positions: np.ndarray, vals: np.ndarray) -> None:
        screen_margins[positions[:, 0], positions[:, 1]] = vals
        tally["screened"] += len(positions)
        tally["survivors"] += int((vals >= cascade_floor).sum())

    bailed = False
    # two batches in flight: the bailout probe's tally stays at most a
    # couple of batches behind, as in the JAX function
    spipe = _BatchPipeline(screen, dev, batch_size, ps_base, take, depth=2)
    sproducer = BandProducer(ny, read_band)
    try:
        with Timer(f"cascade screen[{n} cells]", log):
            spos: list[tuple[int, int]] = []
            rows_done = 0
            while True:
                item = sproducer.get()
                if item is None:
                    break
                iy, band = item
                for ix in range(nx):
                    x_l = ix * grid.stride
                    patch = band[:, x_l : x_l + ps_base]
                    row = spipe.host[len(spos)]
                    w = patch.shape[1]
                    row[:, :w] = patch
                    row[:, w:] = 255
                    if row.mean() > tissue_threshold:
                        continue
                    spos.append((iy, ix))
                    if len(spos) == batch_size:
                        spipe.dispatch(spos)
                        spos = []
                rows_done += 1
                screened, survivors = tally["screened"], tally["survivors"]
                if (cascade_bailout < 1.0
                        and screened >= probe_min(rows_done, screened)
                        and survivors > cascade_bailout * screened):
                    bailed = True
                    break
            if not bailed:
                if spos:
                    spipe.dispatch(spos)
                spipe.finish()
                screened, survivors = tally["screened"], tally["survivors"]
                # the probe arms mid-flight only once its sample floor is
                # met; a small or sparse slide can finish first, so the final
                # tally takes the same test (recall-safe)
                if (cascade_bailout < 1.0 and screened > 0
                        and survivors > cascade_bailout * screened):
                    bailed = True
                    log.info("cascade: probe never armed mid-flight (%d cells "
                             "screened < sample floor); final survivor "
                             "fraction %.2f exceeds the bailout threshold",
                             screened, survivors / screened)
    finally:
        spipe.discard()
        sproducer.stop()
    if bailed:
        log.info("cascade: bailout: %d / %d probed cells survive the screen "
                 "floor %g (> %g of tissue): the operating point is "
                 "uninformative on this slide's tissue; abandoning the screen "
                 "and running the full fused pass (recall-safe)",
                 tally["survivors"], tally["screened"], cascade_floor,
                 cascade_bailout)
        return None
    return screen_margins


def predict_and_export_multiscale(
    slide_path: str,
    model: HierarchicalPatchClassifier,
    csv_dir: str,
    levels=(2, 3),
    threshold: float | None = None,
    export_components: bool = False,
    **kw,
) -> tuple[np.ndarray, str]:
    """Multiscale producer: probability grid + detection CSV for one slide
    (the single-level producer's CSV contract). ``threshold`` is in
    probability space (default ``DETECTION_PROB_THRESHOLD``); ranking and
    emission run on the calibrated log-odds surface.
    ``export_components=True`` also writes one detection CSV per
    :data:`COMPONENT_EXPORTS` surface (same pass) into
    ``<csv_dir>_<component>/``. ``kw`` goes to
    :func:`predict_slide_multiscale` (``device`` and ``calibration`` among
    them)."""
    if threshold is None:
        threshold = DETECTION_PROB_THRESHOLD
    name = slide_name(os.path.basename(slide_path))
    if export_components:
        margins, grid, comps = predict_slide_multiscale(
            slide_path, model, levels=levels, output="margin",
            return_components=True, **kw)
        for comp in COMPONENT_EXPORTS:
            write_detection_csv(
                os.path.join(f"{csv_dir}_{comp}", f"{name}.csv"),
                margin_detections(comps[comp], grid, threshold))
    else:
        margins, grid = predict_slide_multiscale(
            slide_path, model, levels=levels, output="margin", **kw)
    detections = margin_detections(margins, grid, threshold)
    csv_path = os.path.join(csv_dir, f"{name}.csv")
    write_detection_csv(csv_path, detections)
    log.info("%s: %d multiscale detections → %s", name, len(detections),
             csv_path)
    return sigmoid(margins), csv_path
