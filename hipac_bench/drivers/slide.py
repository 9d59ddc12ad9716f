"""Slide inference, as ``--predict_slide <dir> --tissue_filter device`` runs
it on one card: slides one after another (a closed loop), each through
``infer/sliding_window.py::predict_slide`` at level 3 (margins, kernel 2a
normalizing every cell and clamping white ones on the card, the bf16
ResNet18 in batches of 512), then ``margin_detections`` and
``write_detection_csv``, as ``predict_and_export`` does for a path.

The slides are windows of one seed-made level-3 plane, of a fixed set of
sizes (a share of the whole plane's area each) sent in an order drawn from
the seed. The model's weights come from the seed, with BatchNorm
statistics and the head calibrated on tissue cells of the plane by the
plain reference.

Check (after the window, on a sample of the slides it finished drawn from
the seed, the largest among them): each cell's white clamp against the
reference's cell mean (exact), the tissue cells' margins against the float32
reference forward (the widest and the root-mean-square gap, in logits), and
each CSV against the reference's detections of the program's own margin
grid (exact).

``traffic["path"] = "int8"`` runs the program's int8 path instead (host
tissue filter, scales calibrated on each slide): the lower-precision
control, for ``hipac_bench.control``.
"""

from __future__ import annotations

import os
import statistics
import time

import numpy as np
import torch

from hipac_bench import inputs
from hipac_bench import trace as tr
from hipac_bench import weights
from hipac_bench.reference import augment as ref_aug
from hipac_bench.reference import detections as ref_det
from hipac_bench.reference import resnet as ref

PORT = "ss25_hierarchical_multiscale_image_classification_tpu_torch"
LEVEL = 3
NON_TISSUE = -1.0e4


def _windows(seed: int, sizes, height: int, width: int):
    """Slide windows without end: round after round of every size."""
    rnd = 0
    while True:
        yield from inputs.slide_windows(inputs.sub_seed(seed, 100 + rnd),
                                        sizes, height, width, 1)
        rnd += 1


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device, workdir: str):
        self.cfg, self.t, self.seed, self.dev = cfg, traffic, seed, device
        self.csv_dir = os.path.join(workdir, "csv")
        self.done: list[dict] = []

    # -- set-up ---------------------------------------------------------
    def setup(self, pieces: dict) -> None:
        import importlib

        t = time.perf_counter()
        sw = importlib.import_module(f"{PORT}.infer.sliding_window")
        resnet = importlib.import_module(f"{PORT}.models.resnet")
        self.launch_fns = {
            "fused_normalize": importlib.import_module(
                f"{PORT}.ops.preprocess").fused_normalize}
        if self.dev.type == "cuda":
            importlib.import_module(f"{PORT}.ops.build").load_library()
        self.sw = sw
        pieces["kernels"] = time.perf_counter() - t

        t = time.perf_counter()
        p = self.t["plane"]
        self.plane, tissue, tumor = inputs.make_plane(
            inputs.sub_seed(self.seed, 1), p["height"], p["width"],
            p["blobs"], tuple(p["radius"]), p["tumor_blob_share"], self.dev)
        self.sizes = inputs.slide_sizes(p["height"], p["width"],
                                        self.t["sizes"], tuple(self.t["area"]))
        self.windows = _windows(self.seed, self.sizes, p["height"],
                                p["width"])
        pieces["inputs"] = time.perf_counter() - t

        t = time.perf_counter()
        g = torch.Generator(device=self.dev).manual_seed(
            inputs.sub_seed(self.seed, 2))
        sd = weights.resnet18(g, self.dev, num_classes=2)
        cal = self.t["calibration"]
        cells, tum = inputs.tissue_cells(self.plane, tissue, tumor,
                                         cal["cells"], self.cfg["image_size"],
                                         inputs.sub_seed(self.seed, 3))
        self.weights = weights.calibrate_classifier(
            sd, torch.from_numpy(cells).to(self.dev),
            torch.from_numpy(tum).to(self.dev), cal["margin_std"])
        model = resnet.ResNet18Classifier(num_classes=2)
        model.load_state_dict(self.weights)
        # as the CLI: bf16 on a card for the float path, float32 for int8
        dtype = (torch.bfloat16 if self.dev.type == "cuda"
                 and self.t["path"] != "int8" else torch.float32)
        self.model = model.to(device=self.dev, dtype=dtype,
                              memory_format=torch.channels_last)
        pieces["weights"] = time.perf_counter() - t

        t = time.perf_counter()
        self._warm_up()
        for fn in self.launch_fns.values():
            fn.launches = 0
        pieces["warmup"] = time.perf_counter() - t

    def _predict_kw(self) -> dict:
        """``traffic["path"]``: ``device`` (kernel 2a filters on the card)
        or ``int8`` (the int8 path, which filters on the host)."""
        if self.t["path"] == "int8":
            return {"int8": True, "tissue_filter": "host"}
        if self.t["path"] != "device":
            raise ValueError(f"unknown slide path {self.t['path']!r}")
        return {"tissue_filter": "device"}

    def _warm_up(self) -> None:
        """One slide of the smallest size end to end, then the margin step
        at every batch size the cell's slides give."""
        w, h = self.sizes[0]
        self._one(inputs.PlaneSlide(self.plane, 0, 0, w, h),
                  os.path.join(self.csv_dir, "warmup.csv"))
        if self.t["path"] != "device":
            return
        bs, ps = self.cfg["batch_size"], self.cfg["image_size"]
        rows = {bs}
        for w, h in self.sizes:
            n = -(-w // ps) * -(-h // ps)
            rows.add(n % bs or bs)
        step = self.sw.make_prob_step(
            self.model, ps, float(self.cfg["tissue_threshold"]))
        for r in sorted(rows):
            step(torch.full((r, ps, ps, 3), 200, dtype=torch.uint8,
                            device=self.dev))
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # -- the window -----------------------------------------------------
    def _one(self, slide, csv_path: str):
        with tr.span("bench.slide.predict"):
            margins, grid = self.sw.predict_slide(
                slide, self.model, level=LEVEL, output="margin",
                batch_size=self.cfg["batch_size"],
                tissue_threshold=float(self.cfg["tissue_threshold"]),
                device=self.dev, **self._predict_kw())
        with tr.span("bench.slide.detect"):
            dets = self.sw.margin_detections(
                margins, grid, float(self.cfg["detect_threshold"]))
        with tr.span("bench.slide.csv"):
            self.sw.write_detection_csv(csv_path, dets)
        return margins, grid

    def window(self, seconds: float) -> dict:
        walls, cells = [], 0
        start = time.perf_counter()
        end = start
        while not walls or end - start < seconds:
            x0, y0, w, h = next(self.windows)
            path = os.path.join(self.csv_dir,
                                f"slide{len(self.done):05d}.csv")
            t = time.perf_counter()
            margins, grid = self._one(
                inputs.PlaneSlide(self.plane, x0, y0, w, h), path)
            end = time.perf_counter()
            walls.append(end - t)
            cells += grid.num_patches
            self.done.append({"window": (x0, y0, w, h), "margins": margins,
                              "csv": path, "cells": grid.num_patches,
                              "stride": grid.stride})
        return {"attempted": len(walls), "failed": 0, "cells": cells,
                "slides": len(walls), "seconds": end - start, "walls": walls}

    def end_to_end(self, work: dict) -> dict:
        walls = work["walls"]
        p90 = (statistics.quantiles(walls, n=10, method="inclusive")[8]
               if len(walls) > 1 else walls[0])
        return {"slide_cells_per_s": work["cells"] / work["seconds"],
                "slide_p90_s": p90}

    def launches(self) -> dict:
        return {k: fn.launches for k, fn in self.launch_fns.items()}

    def release(self) -> None:
        self.model = None
        self.windows = None

    # -- the check ------------------------------------------------------
    def _sample(self) -> list[dict]:
        k = min(int(self.t["check_slides"]), len(self.done))
        largest = max(range(len(self.done)),
                      key=lambda i: self.done[i]["cells"])
        rest = [i for i in range(len(self.done)) if i != largest]
        rng = np.random.default_rng(inputs.sub_seed(self.seed, 4))
        pick = [largest] + list(rng.choice(rest, size=k - 1, replace=False))
        return [self.done[i] for i in pick]

    @torch.no_grad()
    def reference_cells(self, slide: dict):
        """(white, margins) of the slide's cells by the plain reference,
        (ny, nx) each; margins only where not white (elsewhere NaN)."""
        x0, y0, w, h = slide["window"]
        ps = self.cfg["image_size"]
        if slide["stride"] != ps:
            raise ValueError("the check reads cells at a stride of one patch")
        ny, nx = -(-h // ps), -(-w // ps)
        win = torch.from_numpy(np.ascontiguousarray(
            self.plane[y0:y0 + h, x0:x0 + w])).to(self.dev)
        padded = torch.full((ny * ps, nx * ps, 3), 255, dtype=torch.uint8,
                            device=self.dev)
        padded[:h, :w] = win
        cells = padded.reshape(ny, ps, nx, ps, 3).permute(0, 2, 1, 3, 4)
        cells = cells.reshape(ny * nx, ps, ps, 3)
        white = ref_aug.cell_means(cells) > float(self.cfg["tissue_threshold"])
        margins = torch.full((ny * nx,), float("nan"), device=self.dev)
        idx = torch.nonzero(~white)[:, 0]
        block = int(self.t["check_block"])
        with ref.float32_exact():
            for i in range(0, len(idx), block):
                sel = idx[i:i + block]
                margins[sel] = ref.margins(self.weights,
                                           ref_aug.normalize(cells[sel]))
        return (white.reshape(ny, nx).cpu().numpy(),
                margins.reshape(ny, nx).cpu().numpy())

    def check(self, variant: str = "program", limits="cell") -> dict:
        """The compared numbers beside the cell's limits (``limits`` None:
        the numbers alone). The control is the int8 path of the program,
        which ``traffic["path"]`` selects before set-up."""
        if variant != "program":
            raise ValueError("the slide cell's control is traffic path int8")
        clamp_wrong, csv_wrong = 0, 0
        ref_margins, gaps = [], []
        ps = self.cfg["image_size"]
        for slide in self._sample():
            white, ref_m = self.reference_cells(slide)
            prog = slide["margins"]
            if self.t["path"] == "device":
                clamp_wrong += int(((prog == NON_TISSUE) != white).sum())
            tissue = ~white & (prog != NON_TISSUE)
            gaps.append(np.abs(prog[tissue] - ref_m[tissue]))
            ref_margins.append(ref_m[~white])
            rows = ref_det.detections(prog, slide["stride"], ps,
                                      float(1 << LEVEL),
                                      float(self.cfg["detect_threshold"]))
            want = ref_det.csv_text(rows).splitlines()
            with open(slide["csv"], newline="") as f:
                got = f.read().splitlines()
            csv_wrong += abs(len(want) - len(got)) + sum(
                a != b for a, b in zip(want, got))
        spread = float(np.concatenate(ref_margins).std())
        gaps = np.concatenate(gaps).astype(np.float64)
        r = {"clamp_cells_wrong": clamp_wrong,
             "margin_gap": float(gaps.max(initial=0.0)),
             "margin_rms": float(np.sqrt(np.mean(gaps * gaps))),
             "csv_rows_wrong": csv_wrong, "margin_std": spread,
             "cells": int(gaps.size)}
        if limits == "cell":
            limits = self.t["limits"]
        if limits is None:
            return r
        return {k: {"value": r[k], "limit": v} for k, v in limits.items()}
