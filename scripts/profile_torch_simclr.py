#!/usr/bin/env python3
"""Where the port's SimCLR pretraining step spends its time on one NVIDIA card.

Full width (ResNet18 + 512→512→128 projector, batch 512, 224² views, bf16
autocast over float32 parameters, Adam), on random uint8 patches from a
seed written to a packed store in a temporary directory (the step's compute
does not depend on the pixels):

1. the step's phases by CUDA events on batches already on the card: the
   two views, the two forwards, the loss, the backward, the Adam update;
   ``loss_impl`` "pallas" (the NT-Xent kernels) and "xla" (the dense loss)
   in turns (xla, pallas, pallas, xla, ...), medians and quartiles;
2. walls of warm epochs run as ``pretrain_simclr`` runs them (packed-store
   reads, pinned copies and steps overlapping), per step;
3. one warm epoch under ``torch.profiler``: the device's busy time (union of
   its kernel and copy intervals), the idle share ``1 - busy / wall`` and
   the device ops that take the most time.

Run from the root of a checkout on a machine with a card:

    python3 scripts/profile_torch_simclr.py [--cells 1752] [--steps 10] \\
        [--out chiprun_out/profile_torch_simclr.json]

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
PHASES = ("views", "forwards", "loss", "backward", "adam")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, default=1752,
                    help="patches in the store (1,752: the smoke slide's "
                         "tissue cells)")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--steps", type=int, default=10,
                    help="timed steps per loss_impl in phase 1")
    ap.add_argument("--epochs", type=int, default=3,
                    help="timed warm epochs in phase 2")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "profile_torch_simclr.json"))
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        SimCLRConfig,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
        simclr_two_views,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
        BatchIterator,
        PatchDataset,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
        PatchManifest,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.patch_store import (
        PackedPatchWriter,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.simclr import (
        SimCLRModel,
        nt_xent_loss,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.nt_xent import (
        nt_xent_loss_kernel,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.simclr_trainer import (
        make_simclr_train_step,
        to_device,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
        create_train_state,
    )

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    sc = SimCLRConfig(batch_size=args.batch)
    report = {"card": smi, "cells": args.cells, "batch": args.batch,
              "phases_ms": {}, "epoch_ms_per_step": {}, "profile": {}}

    with tempfile.TemporaryDirectory() as tmp:
        writer = PackedPatchWriter(tmp, 3, "random", 224)
        rng = np.random.default_rng(0)
        recs = []
        for i in range(0, args.cells, args.batch):
            n = min(args.batch, args.cells - i)
            recs += writer.write_batch(
                rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8),
                np.zeros((n, 2), np.int64), np.zeros(n, np.int64))
        writer.close()
        ds = PatchDataset(PatchManifest(recs))
        state = create_train_state(SimCLRModel(), sc.learning_rate, dev)
        model, opt = state.model, state.optimizer
        gen = torch.Generator(device=dev).manual_seed(sc.seed + 17)
        batches = [(torch.from_numpy(i).to(dev), torch.from_numpy(v).to(dev).bool())
                   for i, _, v in BatchIterator(ds, args.batch, seed=sc.seed)]
        loss_fns = {"pallas": nt_xent_loss_kernel, "xla": nt_xent_loss}

        def phased_step(imgs, valid, loss_fn):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            opt.zero_grad(set_to_none=True)
            ev[0].record()
            v1, v2 = simclr_two_views(gen, imgs, 224)
            ev[1].record()
            with torch.autocast("cuda", torch.bfloat16):
                z1, z2 = model(v1), model(v2)
            ev[2].record()
            loss = loss_fn(z1, z2, sc.temperature, valid=valid)
            ev[3].record()
            loss.backward()
            ev[4].record()
            opt.step()
            ev[5].record()
            ev[5].synchronize()
            return [ev[i].elapsed_time(ev[i + 1]) for i in range(5)]

        for impl in ("xla", "pallas"):  # warm-up
            phased_step(*batches[0], loss_fns[impl])
        times = {"xla": [], "pallas": []}
        for k in range(args.steps):
            order = ("xla", "pallas") if k % 2 == 0 else ("pallas", "xla")
            for impl in order:
                times[impl].append(phased_step(*batches[k % len(batches)],
                                               loss_fns[impl]))
        for impl, rows in times.items():
            cols = list(zip(*rows))
            report["phases_ms"][impl] = {
                p: pts.quartiles(list(c)) for p, c in zip(PHASES, cols)}
            report["phases_ms"][impl]["step"] = pts.quartiles(
                [sum(r) for r in rows])

        train_step = make_simclr_train_step(sc.temperature, 224, "pallas")

        def epoch() -> tuple[float, int]:
            nonlocal state
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = 0
            for imgs, _, valid in BatchIterator(ds, args.batch, seed=sc.seed):
                state, _ = train_step(state, gen, to_device(imgs, dev),
                                      to_device(valid, dev).bool())
                n += 1
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3, n

        epoch()  # warm
        walls = [epoch() for _ in range(args.epochs)]
        report["epoch_ms_per_step"] = pts.quartiles([w / n for w, n in walls])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall, n = epoch()
        busy = pts.busy_us(prof) / 1e3
        report["profile"] = {"wall_ms": wall, "steps": n,
                             "device_busy_ms": busy,
                             "idle_share": 1.0 - busy / wall,
                             "top": pts.top_ops(prof, 16)}
        report["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30

    print(smi)
    for impl in ("xla", "pallas"):
        ph = report["phases_ms"][impl]
        parts = ", ".join(f"{p} {ph[p]['median']:.3f}" for p in PHASES)
        s = ph["step"]
        print(f"loss_impl={impl}: step median {s['median']:.3f} ms (q1 "
              f"{s['q1']:.3f}, q3 {s['q3']:.3f}, {s['runs']} steps) = "
              f"{2 * args.batch / s['median'] * 1e3:.0f} views/s; {parts}")
    e, p = report["epoch_ms_per_step"], report["profile"]
    print(f"epoch as pretrain_simclr runs it: {e['median']:.2f} ms/step (q1 "
          f"{e['q1']:.2f}, q3 {e['q3']:.2f}, {e['runs']} epochs); profiled "
          f"epoch {p['wall_ms']:.1f} ms over {p['steps']} steps, device busy "
          f"{p['device_busy_ms']:.1f} ms, idle share {p['idle_share']:.3f}; "
          f"peak memory {report['peak_memory_gib']:.2f} GiB")
    for t in p["top"]:
        print(f"    {t['ms']:8.3f} ms  x{t['count']:<4d} {t['name']}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
