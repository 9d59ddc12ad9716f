#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's main path, full-slide tumor detection
(``predict_slide`` → detections → CSV, then the ``hipac-torch`` CLI), once at
the full width of ResNet18 (224² patches, 64-wide stem, batch 512) with
random weights from a seed, on a numpy-rendered synthetic slide, and checks
every hand-written kernel of that path against its plain PyTorch version on
the card. Phases:

1. card and software: ``nvidia-smi`` name and power limit, torch, CUDA, nvcc;
2. build: the kernels from ``ops/csrc/`` of this checkout;
3. kernel against plain version: ``fused_normalize`` at B=512×224²×3, a
   ragged B=37 and an odd 7×13 patch, f32 and bf16, exactly equal; CUDA-event
   medians of kernel and plain at B=512;
4. the slice: a 3,072-cell slide (level 3 of 14336×10752, stride 28) in both
   tissue-filter modes, launch counts read around the run, partitions equal,
   the timed bfloat16 run's margins on sampled tissue cells against a float32
   CPU forward of the same cells (the model's BN statistics are calibrated on
   the slide's tissue, so margins spread across cells by far more than the
   bound); detections written to a CSV;
5. the CLI: ``--predict_slide … --tissue_filter device --device cuda`` as a
   subprocess on the same slide and weights.

It imports nothing of JAX or of the JAX package. Run it from the root of a
checkout:

    python3 chip_smoke.py

It exits non-zero, printing no result, without a CUDA card or outside a
checkout. On success the line before the last is the kernel table as JSON
and the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

PKG = "ss25_hierarchical_multiscale_image_classification_tpu_torch"
ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 512
LEVEL, STRIDE = 3, 28
SLIDE_W, SLIDE_H = 14336, 10752
TIMING_RUNS = 25
CALIB_CELLS = 256  # tissue cells that set the BN statistics
REF_CELLS = 32  # other tissue cells held to the float32 CPU forward
MARGIN_STD = 2.0  # the head is scaled to this margin spread over CALIB_CELLS
# Margin bounds (absolute, at margins of std MARGIN_STD), from the H100 run
# recorded in PERF.md (NVIDIA H100 80GB HBM3, 700 W):
# - the timed bf16 slice against the CPU's float32 forward: measured max|Δ|
#   0.044 over 32 cells whose margins spread 6.05; the reference margins
#   must spread by at least 10× the bound;
BF16_ATOL = 0.1
# - device- against host-filter run on the card: the same bf16 inputs in
#   other batches, measured max|Δ| = 0; should cuDNN pick another algorithm
#   for another batch size, the two differ as bf16 differs from float32;
MODES_ATOL = BF16_ATOL
# - the card's float32 forward (TF32 off) against the CPU's: measured 3.6e-6.
F32_ATOL = 1e-4
KERNEL_SHAPES = [(BATCH, 224, 224, 3), (37, 224, 224, 3), (5, 7, 13, 3)]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, runs: int) -> list[float]:
    """Per-launch milliseconds of ``fn`` by CUDA events, one pair per run."""
    import torch

    out = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def phase_card():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: this smoke run "
                         "needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        find_nvcc,
    )

    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, nvcc "
        f"{nvcc.strip().splitlines()[-1]}")
    return smi, torch.device("cuda", 0)


def phase_build() -> None:
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        build,
        load_library,
    )

    t0 = time.perf_counter()
    path = build()
    load_library()
    log(f"[build] {os.path.relpath(path, ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s")


def phase_kernels(dev) -> dict:
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.preprocess import (
        fused_normalize,
        fused_normalize_reference,
    )

    g = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    for shape in KERNEL_SHAPES:
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                          generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            out, means = fused_normalize(x, dtype)
            torch.cuda.synchronize()
            ref, ref_means = fused_normalize_reference(x, dtype)
            err = max((out.float() - ref.float()).abs().max().item(),
                      (means - ref_means).abs().max().item())
            max_err = max(max_err, err)
            same = torch.equal(out, ref) and torch.equal(means, ref_means)
            log(f"[kernel] fused_normalize {tuple(shape)} {dtype}: "
                f"exact={same} max_abs_err={err}")
            if not same:
                raise AssertionError(f"fused_normalize differs from its plain "
                                     f"version at {shape} {dtype}")

    x = torch.randint(0, 256, KERNEL_SHAPES[0], dtype=torch.uint8, device=dev,
                      generator=g)
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        kernel = lambda: fused_normalize(x, dtype)  # noqa: E731
        plain = lambda: fused_normalize_reference(x, dtype)  # noqa: E731
        for fn in (plain, kernel):
            cuda_ms(fn, 5)  # warm-up
        # in turns: plain, kernel, kernel, plain
        p = cuda_ms(plain, TIMING_RUNS)
        k = cuda_ms(kernel, TIMING_RUNS) + cuda_ms(kernel, TIMING_RUNS)
        p += cuda_ms(plain, TIMING_RUNS)
        times[dtype] = (statistics.median(k), statistics.median(p))
        mb = x.numel() * (1 + torch.finfo(dtype).bits // 8) / 1e6
        log(f"[kernel] fused_normalize B={BATCH} 224² → {dtype}: kernel "
            f"{times[dtype][0]:.4f} ms ({mb / times[dtype][0]:.1f} GB/s), "
            f"plain {times[dtype][1]:.4f} ms (medians of {2 * TIMING_RUNS})")
    return {"max_abs_err": max_err, "ms": times[torch.bfloat16][0],
            "plain_ms": times[torch.bfloat16][1]}


def tissue_cells(slide):
    """The slice's grid at ``LEVEL``/``STRIDE`` and its tissue cells as
    (iy, ix) pairs, by the host filter's rule on the cells as the slice reads
    them (white-padded past the edges)."""
    import numpy as np

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        TISSUE_MEAN_RGB_THRESHOLD,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.pyramid import (
        PatchGrid,
    )

    grid = PatchGrid.for_slide_level(LEVEL, slide.level_dimensions[LEVEL],
                                     slide.level_downsamples[LEVEL], STRIDE)
    cells = [(iy, ix) for ix in range(grid.nx) for iy in range(grid.ny)
             if read_cell(slide, grid, iy, ix).mean() <= TISSUE_MEAN_RGB_THRESHOLD]
    return grid, np.array(cells)


def read_cell(slide, grid, iy, ix):
    x, y = ix * grid.stride, iy * grid.stride
    ps = grid.patch_size
    return slide.read_region(grid.level0_origin(x, y), grid.level, (ps, ps))


def make_model(dev, calib_u8):
    """Full-width ResNet18 (64-wide stem, 2 classes) from a seeded generator,
    as a float32 CPU state dict, a float32 copy on the card and the bf16
    channels_last copy on the card that the slice runs.

    BN affines are random; BN statistics are calibrated on ``calib_u8``
    (tissue cells of the slide) in float32 on the card. With unit statistics
    a random trunk maps every tissue cell to nearly the same features, and a
    check of the margins could not tell a forward that ignores its input.
    The head then reads the features' first principal direction over those
    cells, scaled so that their margins have mean 0 and standard deviation
    :data:`MARGIN_STD`: the trunk's bf16 rounding is ~3 % of the features,
    and along a random direction it buries most of the cells' variation."""
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
        normalize,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        resnet18_from_state_dict,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
        ResNet18Classifier,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(SEED)
    model = ResNet18Classifier(num_classes=2, num_filters=64, generator=g)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for m in bns:
            m.weight.uniform_(0.5, 1.5, generator=g)
            m.bias.normal_(0.0, 0.1, generator=g)
            m.reset_running_stats()
            m.momentum = None  # running statistics = this batch's
    f32 = model.to(dev, memory_format=torch.channels_last)
    x = normalize(torch.from_numpy(calib_u8).to(dev))
    with torch.no_grad():
        f32.train()
        f32(x)
        f32.eval()
        fc, f32.fc = f32.fc, None
        feats = f32(x)  # (cells, 512) float32
        f32.fc = fc
        mean = feats.mean(dim=0)
        d = torch.linalg.svd(feats - mean, full_matrices=False).Vh[0]
        d = d * (MARGIN_STD / ((feats - mean) @ d).std())
        c = -(mean @ d)
        fc.weight.copy_(torch.stack([-d / 2, d / 2]))
        fc.bias.copy_(torch.stack([-c / 2, c / 2]))
    sd = {k: v.detach().cpu().clone() for k, v in f32.state_dict().items()}
    card = resnet18_from_state_dict(sd).to(device=dev, dtype=torch.bfloat16,
                                          memory_format=torch.channels_last)
    return sd, f32, card


def check_reference(sd, f32_card, ref_u8, ref_margins_bf16, dev) -> None:
    """The float32 CPU forward of ``ref_u8`` (tissue cells of the slide)
    against the card's float32 forward (TF32 off), and against the timed
    bf16 slice's margins of the same cells."""
    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
        normalize,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        resnet18_from_state_dict,
    )

    imgs = torch.from_numpy(ref_u8)
    cpu = resnet18_from_state_dict(sd)
    with torch.inference_mode():
        ref = cpu(normalize(imgs))
        got = f32_card(normalize(imgs.to(dev))).cpu()
    m_ref = (ref[:, 1] - ref[:, 0]).numpy()
    m32 = (got[:, 1] - got[:, 0]).numpy()
    d32 = np.abs(m32 - m_ref).max()
    d16 = np.abs(ref_margins_bf16 - m_ref).max()
    spread = m_ref.max() - m_ref.min()
    log(f"[reference] {len(m_ref)} tissue cells: CPU f32 margins span "
        f"{m_ref.min():.4f}..{m_ref.max():.4f} (spread {spread:.4f}, std "
        f"{m_ref.std():.4f})")
    log(f"[reference] card f32 max|Δ|={d32:.3g}; timed bf16 slice "
        f"max|Δ|={d16:.4g}, mean|Δ|={np.abs(ref_margins_bf16 - m_ref).mean():.4g}"
        f" (bound {BF16_ATOL})")
    if not np.isfinite(m_ref).all() or not np.isfinite(ref_margins_bf16).all():
        raise AssertionError("non-finite margins")
    if spread < 10 * BF16_ATOL:
        raise AssertionError("reference margins spread too little to check "
                             "the bf16 forward")
    if d32 > F32_ATOL:
        raise AssertionError("card f32 forward disagrees with the CPU's")
    if d16 > BF16_ATOL:
        raise AssertionError("timed bf16 slice outside the bf16 bound")


def phase_slice(dev, model, slide, ref_cells) -> dict:
    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
        NON_TISSUE_MARGIN,
        margin_detections,
        predict_slide,
        write_detection_csv,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        DETECTION_PROB_THRESHOLD,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.preprocess import (
        fused_normalize,
    )

    kw = dict(level=LEVEL, stride=STRIDE, batch_size=BATCH, output="margin",
              device=dev)
    runs = {}
    fused_normalize.launches = 0  # counts from here on are the main path's
    for i, mode in enumerate(("device", "host", "device", "host")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        margins, grid = predict_slide(slide, model, tissue_filter=mode, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.setdefault(mode, []).append((wall, margins))
        log(f"[slice] run {i + 1} tissue_filter={mode}: {grid.num_patches} "
            f"cells in {wall:.3f} s = {grid.num_patches / wall:.1f} cells/s "
            f"({'cold' if i < 2 else 'warm'})")
    launches = fused_normalize.launches

    n = grid.num_patches
    dev_batches = -(-n // BATCH)
    log(f"[slice] grid {grid.nx}×{grid.ny} = {n} cells, {dev_batches} "
        f"device-mode batches per run; fused_normalize launches {launches}")
    if launches != 2 * dev_batches:
        raise AssertionError(f"expected {2 * dev_batches} kernel launches on "
                             f"the main path, counted {launches}")
    dev_m, host_m = runs["device"][1][1], runs["host"][1][1]
    if not np.isfinite(dev_m).all():
        raise AssertionError("non-finite margins")
    white = host_m == NON_TISSUE_MARGIN
    if not np.array_equal(dev_m == NON_TISSUE_MARGIN, white):
        raise AssertionError("device and host tissue partitions differ")
    if white.all() or not white.any():
        raise AssertionError("slide lacks tissue or white cells")
    d = np.abs(dev_m[~white] - host_m[~white])
    log(f"[slice] tissue cells {int((~white).sum())}, white {int(white.sum())}; "
        f"device vs host margins max|Δ|={d.max():.4g} "
        f"(max|m|={np.abs(host_m[~white]).max():.4g}, std "
        f"{host_m[~white].std():.4g}); repeat device runs "
        f"max|Δ|={np.abs(runs['device'][0][1] - dev_m).max():.4g}")
    if d.max() > MODES_ATOL:
        raise AssertionError("device and host margins disagree")

    dets = margin_detections(dev_m, grid, DETECTION_PROB_THRESHOLD)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke_slide.csv")
        write_detection_csv(path, dets)
        with open(path) as f:
            rows = f.read().splitlines()
    if len(rows) != len(dets) or not dets:
        raise AssertionError("no detections written")
    log(f"[slice] {len(dets)} detections, top {dets[:3]}")
    iy, ix = ref_cells[:, 0], ref_cells[:, 1]
    if white[iy, ix].any():
        raise AssertionError("a reference cell was filtered as white")
    return {"launches": launches, "ref_margins": dev_m[iy, ix]}


def phase_cli(sd, slide) -> None:
    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
        save_npz_slide,
    )

    with tempfile.TemporaryDirectory() as tmp:
        slide_path = os.path.join(tmp, "smoke_slide.wsi.npz")
        save_npz_slide(slide_path, [slide.level_array(i)
                                    for i in range(slide.level_count)])
        models_dir = os.path.join(tmp, "models")
        os.makedirs(models_dir)
        torch.save(sd, os.path.join(models_dir, "resnet18_patch_classifier.pt"))
        cmd = [sys.executable, "-m", f"{PKG}.cli.main",
               "--predict_slide", slide_path, "--tissue_filter", "device",
               "--device", "cuda", "--stride", str(STRIDE),
               "--models_dir", models_dir]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ),
                              capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"CLI failed ({proc.returncode}):\n"
                                 f"{proc.stderr[-4000:]}")
        csv_path = os.path.join(models_dir, "model_predictions_csv",
                                "smoke_slide.csv")
        rows = np.loadtxt(csv_path, delimiter=",", ndmin=2)
    if rows.size == 0 or not ((rows[:, 0] > 0) & (rows[:, 0] < 1)).all():
        raise AssertionError("CLI wrote no valid detections")
    log(f"[cli] {' '.join(cmd[2:4])} … exit 0 in {wall:.1f} s (process "
        f"start and build cache included); {len(rows)} detections in "
        f"{os.path.basename(csv_path)}")


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        print(f"{PKG}/ not found beside {__file__}: run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import torch

    smi, dev = phase_card()
    phase_build()
    kernel = phase_kernels(dev)

    import numpy as np

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.synthetic import (
        SyntheticSlideSpec,
        make_synthetic_slide,
    )

    t0 = time.perf_counter()
    slide = make_synthetic_slide(
        SyntheticSlideSpec(width=SLIDE_W, height=SLIDE_H, seed=1))
    log(f"[slide] {SLIDE_W}×{SLIDE_H} synthetic slide (no tumor polygons) "
        f"rendered in {time.perf_counter() - t0:.1f} s; level {LEVEL} "
        f"{slide.level_dimensions[LEVEL]}")
    grid, tissue = tissue_cells(slide)
    pick = np.random.default_rng(SEED).permutation(len(tissue))
    calib, ref = tissue[pick[:CALIB_CELLS]], tissue[pick[-REF_CELLS:]]
    cells = lambda idx: np.stack([read_cell(slide, grid, iy, ix)  # noqa: E731
                                  for iy, ix in idx])
    sd, f32_card, model = make_model(dev, cells(calib))
    kernel.update(phase_slice(dev, model, slide, ref))
    check_reference(sd, f32_card, cells(ref), kernel.pop("ref_margins"), dev)
    phase_cli(sd, slide)

    table = {"kernels": [{
        "name": "fused_normalize",
        "route": "cuda",
        "source": f"{PKG}/ops/csrc/fused_normalize.cu",
        "replaces": "ss25_hierarchical_multiscale_image_classification_tpu/"
                    "ops/pallas/preprocess.py:35",
        "launches": kernel["launches"],
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
    }]}
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(json.dumps(table))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
