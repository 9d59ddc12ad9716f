"""Readings of a cell's compared numbers over many seeds in one process:
the program's own (the lower readings of the limits), its lower-precision
control and its faults (the upper readings). Not part of a benchmark run.

    python3 -m hipac_bench.control --workload <cell> --seeds 11,12,13 \
        --variant program|control|half_batch [--seconds 6]

Each seed sets the cell up as a run does, runs a window of ``--seconds``
(none for a training cell, whose readings are its first steps), and prints
one JSON line: the seed, the variant and every number the cell can
compare. For the slide cell ``control`` runs the program's int8 path in
place of the bf16 one; for a training cell it puts the reference in
float8 in the program's place, and ``half_batch`` the reference that
leaves out half of each batch.
"""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import tempfile
import time


def readings(workload: str, seed: int, variant: str, seconds: float,
             device: str = "cuda", overrides: dict | None = None) -> dict:
    import torch

    from hipac_bench import catalog
    from hipac_bench.run import merge

    overrides = overrides or {}
    wl = catalog.workload(workload)
    traffic = merge(wl["traffic"], overrides.get("traffic"))
    cfg = merge(catalog.config(wl["config"]), overrides.get("config"))
    slide = wl["driver"] == "slide"
    if slide and variant == "control":
        traffic["path"] = "int8"
    dev = torch.device(device)
    workdir = tempfile.mkdtemp(prefix="hipac_bench_control_")
    try:
        cell = catalog.driver(wl["driver"]).Cell(cfg, traffic, seed, dev,
                                                 workdir)
        cell.setup({})
        work = cell.window(seconds if slide else 0.0)
        cell.release()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        r = cell.check("program" if slide else variant, limits=None)
        return {"seed": seed, "variant": variant,
                "attempted": work["attempted"], **r}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variant", default="program",
                   choices=("program", "control", "half_batch"))
    p.add_argument("--seconds", type=float, default=6.0)
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = readings(args.workload, seed, args.variant, args.seconds)
        r["wall_s"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
