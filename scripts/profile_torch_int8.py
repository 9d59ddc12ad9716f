#!/usr/bin/env python3
"""Where the port's int8 (w8a8) paths spend their time on one NVIDIA card.

Builds the same slide, model and packed store of tissue cells as
``chip_smoke.py`` (3,072 cells of which 1,752 tissue, 224², full-width
ResNet18, batch 512), calibrates the int8 artifact once on the store
(``quantize_classifier_to_artifact``), then:

1. the kernels alone (``--kernels``): ``chip_smoke.py``'s int8 kernel phases,
   that is every convolution of the forward on ``int8_conv_requant`` and
   ``fused_stage1_int8``, each checked against its plain version and timed;
2. the forward alone on one batch on the card, by CUDA events, in turns:
   ``quant_forward`` from the raw (512, 224, 224, 3) batch and from the
   host-made space-to-depth batch, beside the bf16 folded forward of both
   stems; and one profiled ``quant_forward`` with its device ops by time and
   their sums by part (stem conv, pool, fused stage 1, the 12 stage convs,
   the 3 downsamples, everything else: casts, space-to-depth, mean), which
   must add up to the forward;
3. walls of warm ``predict_slide`` runs in turns: int8 from the artifact
   (host tissue filter, the only one the int8 path takes), the float host
   filter and the float device filter; one profiled int8 run with the
   device's busy time and idle share;
4. walls of warm ``run_feature_extraction`` calls in turns: int8 from the
   artifact and the bf16 folded forward; one profiled int8 call with busy
   time and idle share.

Run from the root of a checkout on a machine with a card:

    python3 scripts/profile_torch_int8.py [--runs 6] [--kernels] \\
        [--out chiprun_out/profile_torch_int8.json]

It prints a summary and writes everything as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import profile_torch_slice as pts

ROOT = pts.ROOT
cs = pts.cs

# parts of an int8 forward by the names of its device kernels
FORWARD_PARTS = (
    ("stem conv", "int8_conv_stem_kernel"),
    ("int8_maxpool", "int8_maxpool_kernel"),
    ("fused_stage1_int8", "fused_stage1_kernel"),
    ("12 stage convs 3x3 (wgmma)", "int8_conv_wgmma_kernel<128, 9>"),
    ("3 downsamples 1x1 (wgmma)", "int8_conv_wgmma_kernel<128, 1>"),
)


def forward_parts(ops: list[dict]) -> dict:
    """Device time of a profiled forward by part, from its ops by name."""
    parts = {part: 0.0 for part, _ in FORWARD_PARTS}
    parts["other (casts, s2d, mean)"] = 0.0
    for op in ops:
        part = next((part for part, key in FORWARD_PARTS if key in op["name"]),
                    "other (casts, s2d, mean)")
        parts[part] += op["ms"]
    parts["sum"] = sum(parts.values())
    return parts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=6,
                    help="warm runs per route of each loop")
    ap.add_argument("--kernels", action="store_true",
                    help="also run the int8 kernel phases of chip_smoke.py")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "profile_torch_int8.json"))
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        Config,
        DataConfig,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.features import (
        run_feature_extraction,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
        predict_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.synthetic import (
        SyntheticSlideSpec,
        make_synthetic_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        strip_head,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quant_artifact import (
        load_quantized,
        quantize_classifier_to_artifact,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quantized import (
        fold_resnet18_inference,
        folded_forward_inference,
        folded_to,
        quant_forward,
        quantized_to,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
        save_model,
    )

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    report = {"card": smi, "batch": cs.BATCH, "kernels": {}, "forward_ms": {},
              "slide_walls_s": {}, "slide_profile": {}, "feature_walls_ms": {},
              "feature_profile": {}}
    print(smi)

    if args.kernels:
        cs.phase_build()
        report["kernels"]["int8_conv_requant"] = cs.phase_int8_conv(dev)
        report["kernels"]["fused_stage1_int8"] = cs.phase_fused_stage1(dev)

    slide = make_synthetic_slide(
        SyntheticSlideSpec(width=cs.SLIDE_W, height=cs.SLIDE_H, seed=1))
    grid, tissue = cs.tissue_cells(slide)
    pick = np.random.default_rng(cs.SEED).permutation(len(tissue))
    calib = np.stack([cs.read_cell(slide, grid, iy, ix)
                      for iy, ix in tissue[pick[:cs.CALIB_CELLS]]])
    sd, f32_model, bf16_model = cs.make_model(dev, calib)
    trunk = strip_head(sd)
    report["cells"], report["tissue_cells"] = grid.num_patches, len(tissue)

    with tempfile.TemporaryDirectory() as tmp:
        ds = cs.simclr_dataset(slide, grid, tissue, tmp)
        n = len(ds)
        models_dir = os.path.join(tmp, "models")
        save_model(os.path.join(models_dir, "resnet18_patch_classifier"), sd)
        cfg = Config(data=DataConfig(data_dir=os.path.join(tmp, "data")),
                     models_dir=models_dir)
        t0 = time.perf_counter()
        tree = load_quantized(quantize_classifier_to_artifact(
            cfg, level=cs.LEVEL, dataset=ds, device=dev))
        report["quantize_s"] = time.perf_counter() - t0
        qt = quantized_to(tree, dev)

        # 2. the forward alone, one batch on the card
        imgs = ds.read_batch(range(cs.BATCH))[0]
        x = torch.from_numpy(imgs).to(dev)
        xs = x.reshape(cs.BATCH, 112, 2, 112, 2, 3).permute(
            0, 1, 3, 2, 4, 5).reshape(cs.BATCH, 112, 112, 12).contiguous()
        with torch.inference_mode():
            fps = {name: folded_to(fold_resnet18_inference(
                trunk, (224, 224), stem_s2d=s2d, dtype=torch.bfloat16), dev)
                for name, s2d in (("bf16 folded, conv + bias_relu_pool", False),
                                  ("bf16 folded, fused_stem", True))}
            fns = {"int8 quant_forward, raw batch":
                   lambda: quant_forward(qt, x, with_fc=False),
                   "int8 quant_forward, pre-s2d batch":
                   lambda: quant_forward(qt, xs, with_fc=False)}
            fns.update({name: (lambda fp=fp: folded_forward_inference(
                fp, x, False)) for name, fp in fps.items()})
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
                q = pts.quartiles(ms[name])
                report["forward_ms"][name] = {
                    **q, "patches_per_s_median": cs.BATCH / q["median"] * 1e3,
                    "top": pts.top_ops(prof, 14),
                    "parts": forward_parts(pts.top_ops(prof, 1000))}

        # 3. the slide loop
        slide_kw = dict(level=cs.LEVEL, stride=cs.STRIDE, batch_size=cs.BATCH,
                        output="margin", device=dev)
        slide_routes = {
            "int8, artifact (host filter)":
                lambda: predict_slide(slide, f32_model, int8=True, qtree=tree,
                                      **slide_kw),
            "bf16, host filter":
                lambda: predict_slide(slide, bf16_model, tissue_filter="host",
                                      **slide_kw),
            "bf16, device filter":
                lambda: predict_slide(slide, bf16_model, tissue_filter="device",
                                      **slide_kw),
        }

        def wall(fn) -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        for fn in slide_routes.values():
            wall(fn)  # cold
        walls = {name: [] for name in slide_routes}
        for i in range(args.runs):
            names = list(slide_routes)
            for name in (names if i % 2 == 0 else names[::-1]):
                walls[name].append(wall(slide_routes[name]))
        for name, xs_ in walls.items():
            q = pts.quartiles(xs_)
            report["slide_walls_s"][name] = {
                **q, "cells_per_s_median": grid.num_patches / q["median"]}
        name = "int8, artifact (host filter)"
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            w = wall(slide_routes[name]) * 1e3
        busy = pts.busy_us(prof) / 1e3
        report["slide_profile"][name] = {
            "wall_ms": w, "device_busy_ms": busy, "idle_share": 1.0 - busy / w,
            "top": pts.top_ops(prof)}

        # 4. the extraction loop
        feature_routes = {
            "int8, artifact":
                lambda: run_feature_extraction(ds, trunk, cs.BATCH, device=dev,
                                               int8=True, qtree=tree),
            "bf16 folded":
                lambda: run_feature_extraction(ds, trunk, cs.BATCH, device=dev),
        }
        for fn in feature_routes.values():
            wall(fn)  # cold
        walls = {name: [] for name in feature_routes}
        for i in range(args.runs):
            names = list(feature_routes)
            for name in (names if i % 2 == 0 else names[::-1]):
                walls[name].append(wall(feature_routes[name]) * 1e3)
        for name, xs_ in walls.items():
            q = pts.quartiles(xs_)
            report["feature_walls_ms"][name] = {
                **q, "patches_per_s_median": n / q["median"] * 1e3}
        name = "int8, artifact"
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            w = wall(feature_routes[name]) * 1e3
        busy = pts.busy_us(prof) / 1e3
        report["feature_profile"][name] = {
            "wall_ms": w, "device_busy_ms": busy, "idle_share": 1.0 - busy / w,
            "top": pts.top_ops(prof)}

    print(f"--quantize on {n} cells: {report['quantize_s']:.2f} s")
    for name, m in report["forward_ms"].items():
        print(f"forward at B={cs.BATCH}, {name}: median {m['median']:.3f} ms "
              f"(q1 {m['q1']:.3f}, q3 {m['q3']:.3f}) = "
              f"{m['patches_per_s_median']:.0f} patches/s")
        if name.startswith("int8"):
            for t in m["top"][:14]:
                print(f"    {t['ms']:8.3f} ms  x{t['count']:<4d} {t['name']}")
            print("    by part: " + ", ".join(
                f"{part} {t:.3f}" for part, t in m["parts"].items())
                + f" ms (forward median {m['median']:.3f})")
    for name, m in report["slide_walls_s"].items():
        print(f"predict_slide, {name}: wall median {m['median']:.4f} s (q1 "
              f"{m['q1']:.4f}, q3 {m['q3']:.4f}, {m['runs']} runs) = "
              f"{m['cells_per_s_median']:.0f} cells/s")
    for kind in ("slide_profile", "feature_profile"):
        for name, p in report[kind].items():
            print(f"{kind}, {name}: wall {p['wall_ms']:.1f} ms, device busy "
                  f"{p['device_busy_ms']:.1f} ms, idle share "
                  f"{p['idle_share']:.3f}")
            for t in p["top"][:8]:
                print(f"    {t['ms']:8.3f} ms  x{t['count']:<4d} {t['name']}")
    for name, m in report["feature_walls_ms"].items():
        print(f"run_feature_extraction, {name}: wall median {m['median']:.1f} ms "
              f"(q1 {m['q1']:.1f}, q3 {m['q3']:.1f}, {m['runs']} runs) = "
              f"{m['patches_per_s_median']:.0f} patches/s")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
