#!/usr/bin/env python3
"""Where the port's attention-MIL path spends its time on one NVIDIA card.

Full width of ``MILConfig`` (instances of 512, attention and head hidden
128, 2 classes, bags padded or cut to 4096, 100 MC-dropout samples), on the
synthetic bag features of ``chip_smoke.py`` phase 7 (24 slides of
2,000–12,000 instances), with the seeded untrained classifier (the times do
not depend on the weights):

1. ``mil_predict`` walls on the bags of 4096+ instances (host clock, each
   call ending in its fetch to the host), per route, in turns: MC dropout
   (the kernel pools once, the head is sampled 100 times), ``streaming``
   without MC dropout (the kernel) and the module (no kernel); and the host
   pieces of a call: ``pad_bag`` and the bag's copy to the card;
2. one series of MC-dropout calls under ``torch.profiler``: the device's
   busy time (union of its kernel and copy intervals), the idle share
   ``1 - busy / wall`` and the device ops that take the most time;
3. warm epochs as ``train_mil_classifier`` runs them (20 bags at batch 8,
   ``MILBagIterator``'s host padding, pinned copies, Adam steps), the
   host batching alone, and one epoch under the profiler.

Run from the root of a checkout on a machine with a card:

    python3 scripts/profile_torch_mil.py [--runs 3] [--epochs 3] \\
        [--out logs/profile_torch_mil.json]

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
    ap.add_argument("--runs", type=int, default=3,
                    help="passes over the 4096+ bags per predict route")
    ap.add_argument("--epochs", type=int, default=3, help="timed warm epochs")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "logs", "profile_torch_mil.json"))
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        Config,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.mil import (
        MILBagIterator,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.mil import (
        MILClassifier,
        pad_bag,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.mil_trainer import (
        mil_predict,
        train_step,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.simclr_trainer import (
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
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config()
    with tempfile.TemporaryDirectory() as tmp:
        bags = cs.mil_features(tmp)
    long_bags = [b for b in bags if len(b.features) >= cfg.mil.max_bag_size]
    sd = MILClassifier(input_dim=512).state_dict()
    sd_card = {k: v.to(dev) for k, v in sd.items()}
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    routes = {"mc_dropout": {"mc_dropout": True, "generator": gen},
              "streaming": {"streaming": True},
              "module": {"streaming": False}}
    report = {"card": smi, "bags": len(long_bags), "predict_ms": {},
              "host_ms": {}, "profile_predict": {}, "epoch_ms": {},
              "profile_epoch": {}}

    def predict(bag, route):
        return mil_predict(sd_card, bag.features, cfg, device=dev,
                           **routes[route])

    for route in routes:  # warm-up
        predict(long_bags[0], route)
    walls = {r: [] for r in routes}
    for i in range(args.runs):
        for route in (list(routes) if i % 2 == 0 else list(routes)[::-1]):
            for bag in long_bags:
                t0 = time.perf_counter()
                predict(bag, route)
                walls[route].append((time.perf_counter() - t0) * 1e3)
    report["predict_ms"] = {r: pts.quartiles(w) for r, w in walls.items()}

    pad, copy = [], []
    for bag in long_bags:
        t0 = time.perf_counter()
        feats, _ = pad_bag(bag.features, cfg.mil.max_bag_size)
        t1 = time.perf_counter()
        torch.from_numpy(feats[None]).to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pad.append((t1 - t0) * 1e3)
        copy.append((t2 - t1) * 1e3)
    report["host_ms"] = {"pad_bag": pts.quartiles(pad),
                         "copy_to_card": pts.quartiles(copy)}

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for bag in long_bags:
            predict(bag, "mc_dropout")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = pts.busy_us(prof) / 1e3
    report["profile_predict"] = {"wall_ms": wall, "calls": len(long_bags),
                                 "device_busy_ms": busy,
                                 "idle_share": 1.0 - busy / wall,
                                 "top": pts.top_ops(prof, 12)}

    # the trainer's split and batches (train_mil_classifier)
    order = np.random.default_rng(cfg.train.seed).permutation(len(bags))
    train_bags = [bags[i] for i in order[max(1, int(len(bags) * 0.2)):]]
    max_bag = min(cfg.mil.max_bag_size, max(len(b.features) for b in bags))
    model = MILClassifier(input_dim=512)
    model.load_state_dict(sd)
    state = create_train_state(model, cfg.mil.learning_rate, dev)
    batches = MILBagIterator(train_bags, 8, max_bag, seed=cfg.train.seed)

    def epoch(step: bool = True) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for feats, mask, labels, valid in batches:
            if step:
                train_step(state, gen, to_device(feats, dev),
                           to_device(mask, dev), to_device(labels, dev),
                           to_device(valid, dev))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    epoch()  # warm-up
    report["epoch_ms"] = {
        "epoch": pts.quartiles([epoch() for _ in range(args.epochs)]),
        "host_batching_alone": pts.quartiles(
            [epoch(step=False) for _ in range(args.epochs)]),
        "steps": len(batches)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = epoch()
    busy = pts.busy_us(prof) / 1e3
    report["profile_epoch"] = {"wall_ms": wall, "device_busy_ms": busy,
                               "idle_share": 1.0 - busy / wall,
                               "top": pts.top_ops(prof, 12)}
    report["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30

    print(smi)
    for route, q in report["predict_ms"].items():
        print(f"mil_predict {route}: median {q['median']:.3f} ms (q1 "
              f"{q['q1']:.3f}, q3 {q['q3']:.3f}, {q['runs']} calls) = "
              f"{1e3 / q['median']:.1f} bags/s")
    h = report["host_ms"]
    print(f"host pieces of a call: pad_bag {h['pad_bag']['median']:.3f} ms, "
          f"copy to the card {h['copy_to_card']['median']:.3f} ms (medians)")
    for name in ("profile_predict", "profile_epoch"):
        p = report[name]
        print(f"{name}: wall {p['wall_ms']:.2f} ms, device busy "
              f"{p['device_busy_ms']:.3f} ms, idle share {p['idle_share']:.3f}")
        for t in p["top"]:
            print(f"    {t['ms']:8.3f} ms  x{t['count']:<4d} {t['name']}")
    e = report["epoch_ms"]
    print(f"warm epoch ({e['steps']} steps at batch 8): median "
          f"{e['epoch']['median']:.1f} ms (q1 {e['epoch']['q1']:.1f}, q3 "
          f"{e['epoch']['q3']:.1f}); host batching alone "
          f"{e['host_batching_alone']['median']:.1f} ms; peak memory "
          f"{report['peak_memory_gib']:.2f} GiB")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
