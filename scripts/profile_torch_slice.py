#!/usr/bin/env python3
"""Where the port's slide inference spends its time on one NVIDIA card.

Builds the same slide and model as ``chip_smoke.py`` (3,072 cells of 224²,
full-width ResNet18 in bf16, batch 512), then:

1. walls of warm ``predict_slide`` runs, the two tissue-filter modes in
   turns (device, host, host, device, ...), as median and quartiles;
2. one warm run of each mode under ``torch.profiler``: the device's busy
   time (union of its kernel and copy intervals), the idle share
   ``1 - busy / wall``, and the device ops that take the most time;
3. the model alone: a B=512 bf16 forward by CUDA events.

Run from the root of a checkout on a machine with a card:

    python3 scripts/profile_torch_slice.py [--runs 10] [--out chiprun_out/profile_torch_slice.json]

It prints a summary and writes everything as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def quartiles(xs: list[float]) -> dict:
    q = statistics.quantiles(xs, n=4)
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2],
            "runs": len(xs)}


busy_us = cs.busy_us  # union of the device's kernel and copy intervals, µs


def top_ops(prof, k: int = 12) -> list[dict]:
    import torch

    rows = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            r = rows.setdefault(e.name, [0.0, 0])
            r[0] += e.time_range.end - e.time_range.start
            r[1] += 1
    ranked = sorted(rows.items(), key=lambda kv: -kv[1][0])[:k]
    return [{"name": n[:90], "ms": us / 1e3, "count": c}
            for n, (us, c) in ranked]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10,
                    help="warm runs per tissue-filter mode")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "profile_torch_slice.json"))
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
        normalize,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
        predict_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.synthetic import (
        SyntheticSlideSpec,
        make_synthetic_slide,
    )

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    slide = make_synthetic_slide(
        SyntheticSlideSpec(width=cs.SLIDE_W, height=cs.SLIDE_H, seed=1))
    grid, tissue = cs.tissue_cells(slide)
    pick = np.random.default_rng(cs.SEED).permutation(len(tissue))
    calib = np.stack([cs.read_cell(slide, grid, iy, ix)
                      for iy, ix in tissue[pick[:cs.CALIB_CELLS]]])
    _, _, model = cs.make_model(dev, calib)
    kw = dict(level=cs.LEVEL, stride=cs.STRIDE, batch_size=cs.BATCH,
              output="margin", device=dev)

    def run(mode: str) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict_slide(slide, model, tissue_filter=mode, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for mode in ("device", "host"):
        run(mode)  # cold
    walls = {"device": [], "host": []}
    for i in range(args.runs):
        for mode in (("device", "host") if i % 2 == 0 else ("host", "device")):
            walls[mode].append(run(mode))
    report = {"card": smi, "cells": grid.num_patches,
              "tissue_cells": len(tissue), "walls_s": {}, "profile": {}}
    for mode, xs in walls.items():
        report["walls_s"][mode] = quartiles(xs)
        report["walls_s"][mode]["cells_per_s_median"] = (
            grid.num_patches / statistics.median(xs))

    for mode in ("device", "host"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = run(mode)
        busy = busy_us(prof) / 1e3
        report["profile"][mode] = {
            "wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / (wall * 1e3), "top": top_ops(prof)}

    x = normalize(torch.randint(0, 256, (cs.BATCH, 224, 224, 3),
                                dtype=torch.uint8, device=dev), torch.bfloat16)
    with torch.inference_mode():
        for _ in range(5):
            model(x)
        ms = cs.cuda_ms(lambda: model(x), 20)
    report["model_b512_bf16_ms"] = quartiles(ms)

    print(smi)
    for mode in ("device", "host"):
        w, p = report["walls_s"][mode], report["profile"][mode]
        print(f"{mode:6s} wall median {w['median']:.4f} s (q1 {w['q1']:.4f}, "
              f"q3 {w['q3']:.4f}, {w['runs']} runs) = "
              f"{w['cells_per_s_median']:.0f} cells/s; profiled wall "
              f"{p['wall_ms']:.1f} ms, device busy {p['device_busy_ms']:.1f} ms, "
              f"idle share {p['idle_share']:.3f}")
        for t in p["top"][:8]:
            print(f"    {t['ms']:8.3f} ms  x{t['count']:<4d} {t['name']}")
    m = report["model_b512_bf16_ms"]
    print(f"model B={cs.BATCH} bf16 forward: median {m['median']:.3f} ms "
          f"(q1 {m['q1']:.3f}, q3 {m['q3']:.3f}) = "
          f"{cs.BATCH / m['median'] * 1e3:.0f} patches/s")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
