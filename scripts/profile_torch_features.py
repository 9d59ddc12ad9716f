#!/usr/bin/env python3
"""Where the port's folded feature extraction spends its time on one NVIDIA
card.

Builds the same slide, model and packed store of tissue cells as
``chip_smoke.py`` (1,752 cells of 224², full-width ResNet18, batch 512,
bf16), then:

1. walls of warm ``run_feature_extraction`` calls, the two stem routes
   (``stem_s2d`` False and True) in turns, as median and quartiles;
2. one warm call of each route under ``torch.profiler``: the device's busy
   time (union of its kernel and copy intervals), the idle share
   ``1 - busy / wall`` and the device ops that take the most time;
3. the device alone: the folded forward of both routes and the unfolded
   model on one batch on the card, by CUDA events, in turns;
4. the host alone: one batch's packed-store read, its copy into the pinned
   buffer and its upload, and the inference folds.

Run from the root of a checkout on a machine with a card:

    python3 scripts/profile_torch_features.py [--runs 6] \\
        [--out chiprun_out/profile_torch_features.json]

It prints a summary and writes everything as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import profile_torch_slice as pts

ROOT = pts.ROOT
cs = pts.cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=6,
                    help="warm extraction calls per stem route")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "profile_torch_features.json"))
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.features import (
        make_feature_step,
        run_feature_extraction,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.synthetic import (
        SyntheticSlideSpec,
        make_synthetic_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        resnet18_from_state_dict,
        strip_head,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quantized import (
        fold_resnet18_inference,
        folded_forward_inference,
        folded_to,
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
    sd, _, _ = cs.make_model(dev, calib)
    trunk = strip_head(sd)
    routes = {"conv + bias_relu_pool": False, "fused_stem": True}
    report = {"card": smi, "cells": len(tissue), "batch": cs.BATCH,
              "walls_ms": {}, "profile": {}, "forward_ms": {}, "host_ms": {}}

    with tempfile.TemporaryDirectory() as tmp:
        ds = cs.simclr_dataset(slide, grid, tissue, tmp)
        n = len(ds)

        def run(s2d: bool) -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_feature_extraction(ds, trunk, cs.BATCH, device=dev, stem_s2d=s2d)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        for s2d in routes.values():
            run(s2d)  # cold
        walls = {name: [] for name in routes}
        for i in range(args.runs):
            for name in (list(routes) if i % 2 == 0 else list(routes)[::-1]):
                walls[name].append(run(routes[name]))
        for name, xs in walls.items():
            report["walls_ms"][name] = pts.quartiles(xs)
            report["walls_ms"][name]["patches_per_s_median"] = (
                n / report["walls_ms"][name]["median"] * 1e3)

        for name, s2d in routes.items():
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall = run(s2d)
            busy = pts.busy_us(prof) / 1e3
            report["profile"][name] = {
                "wall_ms": wall, "device_busy_ms": busy,
                "idle_share": 1.0 - busy / wall, "top": pts.top_ops(prof)}

        # the device alone, one batch on the card
        imgs = ds.read_batch(range(cs.BATCH))[0]
        x = torch.from_numpy(imgs).to(dev)
        unfolded = resnet18_from_state_dict(trunk).to(
            device=dev, dtype=torch.bfloat16, memory_format=torch.channels_last)
        with torch.inference_mode():
            fps = {name: folded_to(fold_resnet18_inference(
                trunk, (224, 224), stem_s2d=s2d, dtype=torch.bfloat16), dev)
                for name, s2d in routes.items()}
            fns = {f"folded, {name}": (
                lambda fp=fp: folded_forward_inference(fp, x, False))
                for name, fp in fps.items()}
            model_step = make_feature_step(unfolded)
            fns["unfolded"] = lambda: model_step(x)
            ms = {name: [] for name in fns}
            for fn in fns.values():
                cs.cuda_ms(fn, 3)
            for _ in range(4):  # in turns
                for name, fn in fns.items():
                    ms[name] += cs.cuda_ms(fn, 5)
            for name, fn in fns.items():
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                report["forward_ms"][name] = {
                    **pts.quartiles(ms[name]),
                    "patches_per_s_median":
                        cs.BATCH / pts.quartiles(ms[name])["median"] * 1e3,
                    "top": pts.top_ops(prof, 10)}

        # the host alone
        read, stage, upload, fold = [], [], [], []
        pinned = torch.empty(imgs.shape, dtype=torch.uint8, pin_memory=True)
        for k in range(6):
            idx = np.arange(k * 200, k * 200 + cs.BATCH) % n
            t0 = time.perf_counter()
            batch = ds.read_batch(idx)[0]
            t1 = time.perf_counter()
            pinned.copy_(torch.from_numpy(batch))
            t2 = time.perf_counter()
            pinned.to(dev, non_blocking=True)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            fold_resnet18_inference(trunk, (224, 224), dtype=torch.bfloat16)
            t4 = time.perf_counter()
            read.append((t1 - t0) * 1e3)
            stage.append((t2 - t1) * 1e3)
            upload.append((t3 - t2) * 1e3)
            fold.append((t4 - t3) * 1e3)
        report["host_ms"] = {"packed_store_read": pts.quartiles(read),
                             "copy_to_pinned": pts.quartiles(stage),
                             "upload": pts.quartiles(upload),
                             "fold_resnet18_inference": pts.quartiles(fold)}

    print(smi)
    for name in routes:
        w, p = report["walls_ms"][name], report["profile"][name]
        print(f"run_feature_extraction, {name}: wall median {w['median']:.1f} ms "
              f"(q1 {w['q1']:.1f}, q3 {w['q3']:.1f}, {w['runs']} runs) = "
              f"{w['patches_per_s_median']:.0f} patches/s; profiled wall "
              f"{p['wall_ms']:.1f} ms, device busy {p['device_busy_ms']:.1f} ms, "
              f"idle share {p['idle_share']:.3f}")
        for t in p["top"][:8]:
            print(f"    {t['ms']:8.3f} ms  x{t['count']:<4d} {t['name']}")
    for name, m in report["forward_ms"].items():
        print(f"forward at B={cs.BATCH} bf16, {name}: median {m['median']:.3f} ms"
              f" (q1 {m['q1']:.3f}, q3 {m['q3']:.3f}) = "
              f"{m['patches_per_s_median']:.0f} patches/s")
        for t in m["top"][:8]:
            print(f"    {t['ms']:8.3f} ms  x{t['count']:<4d} {t['name']}")
    for name, m in report["host_ms"].items():
        print(f"host, {name}: median {m['median']:.2f} ms (q1 {m['q1']:.2f}, "
              f"q3 {m['q3']:.2f})")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
