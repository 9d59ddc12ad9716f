#!/usr/bin/env python3
"""The port's main path on a CAMELYON16-sized TIFF slide, on one NVIDIA card.

1. Writes the canonical 97792×221184 synthetic CAMELYON16 slide (4 levels,
   two tumor polygons, the spec of the JAX package's gigapixel proof) as a
   tiled JPEG BigTIFF with ``io/synthetic.py::write_giant_synthetic_slide``,
   in a child process (its wall and peak RSS reported apart). Both sides
   are halved, and the report says why, when the disk has less than 30 GB
   free or when the write, projected from a 1/64-area rehearsal of the same
   spec, would take more than 20 minutes.
2. Runs ``predict_and_export`` at level 3 with ``tissue_filter="device"``
   (full-width ResNet18 in bfloat16 from a seed, its BatchNorm statistics
   calibrated on 256 tissue cells of the slide, as ``chip_smoke.py`` does),
   the 2a launches counted.
3. Reports the wall and cells/s, the device's busy time and idle share (a
   second run under ``torch.profiler``), the band decode time and the tile
   cache's hits and misses, peak host RSS and peak device memory.

Run from the root of a checkout on a machine with a card:

    python3 scripts/profile_torch_tiff.py [--out_dir DIR] [--json chiprun_out/profile_torch_tiff.json]

The slide goes to ``--out_dir`` (default: a new directory in the system's
temporary directory, removed at the end).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

CANONICAL = (97792, 221184)
POLYGONS = (((0.42, 0.40), (0.55, 0.42), (0.58, 0.55), (0.45, 0.58)),
            ((0.30, 0.62), (0.36, 0.60), (0.38, 0.68), (0.31, 0.70)))
MIN_FREE_BYTES = 30e9
MAX_WRITE_S = 20 * 60
CALIB_CELLS = 256

_WRITE = """
import json, resource, sys, time
sys.path.insert(0, sys.argv[1])
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.synthetic import (
    tumor_spec, write_giant_synthetic_slide)
w, h = int(sys.argv[3]), int(sys.argv[4])
spec = tumor_spec(width=w, height=h, num_levels=4, seed=42,
                  tumor_polygons=json.loads(sys.argv[5]))
t0 = time.perf_counter()
write_giant_synthetic_slide(sys.argv[2], spec, xml_path=sys.argv[2] + ".xml")
print(json.dumps({"wall_s": time.perf_counter() - t0, "peak_rss_gib":
                  resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20}))
"""


def write_slide(path: str, w: int, h: int, timeout: float | None = None) -> dict:
    """Write the spec at ``w``×``h`` in a child process: its wall, peak RSS
    and the file's size."""
    proc = subprocess.run(
        [sys.executable, "-c", _WRITE, ROOT, path, str(w), str(h),
         json.dumps(POLYGONS)], capture_output=True, text=True,
        timeout=timeout, check=True)
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["file_gb"] = os.path.getsize(path) / 1e9
    return out


def calibration_cells(slide, level: int, n: int):
    """``n`` tissue cells (224², stride 224) from the level's centre rows."""
    import numpy as np

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        TISSUE_MEAN_RGB_THRESHOLD,
    )

    w, h = slide.level_dimensions[level]
    ds = slide.level_downsamples[level]
    cells = []
    y = (h // 2 // 224) * 224
    while len(cells) < n and y < h - 224:
        band = slide.read_region((0, int(y * ds)), level, (w, 224))
        for x in range(0, w - 224 + 1, 224):
            cell = band[:, x:x + 224]
            if cell.mean() <= TISSUE_MEAN_RGB_THRESHOLD:
                cells.append(cell)
        y += 224
    return np.stack(cells[:n])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--json", default=os.path.join(
        ROOT, "chiprun_out", "profile_torch_tiff.json"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
        predict_and_export,
        predict_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.tiff_slide import (
        TiffSlide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.preprocess import (
        fused_normalize,
    )

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this profile runs on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    out_dir = args.out_dir or tempfile.mkdtemp(prefix="hipac_tiff_")
    own = args.out_dir is None
    os.makedirs(out_dir, exist_ok=True)
    report = {"card": smi, "torch": torch.__version__}
    try:
        free = shutil.disk_usage(out_dir).free
        w, h = CANONICAL
        reasons = []
        if free < MIN_FREE_BYTES:
            reasons.append(f"{free / 1e9:.1f} GB free < 30 GB")
        else:
            # a 1/64-area rehearsal of the same spec projects the write wall
            probe = write_slide(os.path.join(out_dir, "probe.tif"), w // 8,
                                h // 8)
            os.remove(os.path.join(out_dir, "probe.tif"))
            projected = probe["wall_s"] * 64
            report["probe"] = dict(probe, projected_canonical_s=projected)
            if projected > MAX_WRITE_S:
                reasons.append(f"projected write {projected:.0f} s > "
                               f"{MAX_WRITE_S} s")
        if reasons:
            w, h = w // 2, h // 2
        report["geometry"] = {"width": w, "height": h,
                              "halved_because": reasons or None}
        path = os.path.join(out_dir, "tumor_giant.tif")
        report["write"] = write_slide(path, w, h)
        print(f"[write] {w}×{h} JPEG BigTIFF ({report['geometry']}): "
              f"{report['write']}", flush=True)

        slide = TiffSlide(path)
        cells = calibration_cells(slide, cs.LEVEL, CALIB_CELLS)
        slide.close()
        _sd, f32, model = cs.make_model(dev, cells)
        del f32
        torch.cuda.empty_cache()
        kw = dict(level=cs.LEVEL, tissue_filter="device", device=dev)
        csv_dir = os.path.join(out_dir, "csv")
        # the path once, cold, as a user meets the slide
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cs.reset_counts()
        t0 = time.perf_counter()
        probs, csv_path = predict_and_export(path, model, csv_dir, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = probs.size
        report["predict"] = {
            "grid": list(probs.shape), "cells": n, "wall_s": wall,
            "cells_per_s": n / wall, "tissue_cells": int((probs > 0).sum()),
            "fused_normalize_launches": fused_normalize.launches,
            "detections": sum(1 for _ in open(csv_path)),
            "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}
        print(f"[predict] {report['predict']}", flush=True)

        # the same run again (warm) on an open slide under the profiler:
        # busy time, idle share and the tile cache's counters
        slide = TiffSlide(path)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predict_slide(slide, model, **kw)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        busy = cs.busy_us(prof) / 1e6
        report["profiled"] = {"wall_s": pwall, "device_busy_s": busy,
                              "idle_share": 1 - busy / pwall,
                              "tile_cache": slide.cache_stats()}
        slide.close()
        print(f"[profile] {report['profiled']}", flush=True)

        # the band reads of the loop alone: cold, then from the cache
        from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.pyramid import (
            PatchGrid,
        )

        slide = TiffSlide(path)
        grid = PatchGrid.for_slide_level(
            cs.LEVEL, slide.level_dimensions[cs.LEVEL],
            slide.level_downsamples[cs.LEVEL])
        cold = cs.band_decode_ms(slide, grid)
        after_cold = slide.cache_stats()
        warm = cs.band_decode_ms(slide, grid)
        report["decode"] = {
            "bands": len(cold), "band_rows": grid.patch_size,
            "band_width": slide.level_dimensions[cs.LEVEL][0],
            "cold_ms_median": statistics.median(cold),
            "cold_ms_sum": sum(cold), "warm_ms_median": statistics.median(warm),
            "warm_ms_sum": sum(warm), "cache_after_cold": after_cold,
            "cache_after_warm": slide.cache_stats()}
        slide.close()
        report["peak_host_rss_gib"] = (
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)
        print(f"[decode] {report['decode']}", flush=True)
    finally:
        if own:
            shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(os.path.dirname(args.json), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(report, f, indent=2)
    print(smi)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
