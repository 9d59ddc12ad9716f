"""Run one cell of the benchmark once and print its result line.

    python3 -m hipac_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's file (``workloads/<cell>.json``) names its configuration, its
driver and its traffic. The run builds everything from the seed, warms up
every shape, measures for ``--seconds`` (``--trace 1``: a shorter traced
window, under ``torch.profiler``), checks what the timed path produced
against the plain reference, and prints one JSON object as the last line of
its standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``, each
compared number beside its limit. The checks are also the last lines of
standard error. Set-up by piece and the kernels' launch counts come on
earlier lines.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with 2 and prints no result; if the process holds JAX or the JAX package
once the window has closed, with 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax",
             "ss25_hierarchical_multiscale_image_classification_tpu")
#: the traced window's length at most, in seconds
TRACE_SECONDS = 6.0


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    each compared whole (the port's name starts with the JAX package's)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False)
        return res.stdout.strip().splitlines()[0] if res.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None, overrides: dict | None = None, device: str | None = None,
         out=None) -> int:
    """One run. ``overrides`` replaces parts of the cell's ``traffic`` and
    ``config``, and
    ``device`` skips the look for a card (the harness's own tests: a small
    cell on the CPU); ``out`` receives the result object."""
    args = parse(argv)
    import torch

    from hipac_bench import catalog
    from hipac_bench import trace as tr

    bench = catalog.manifest()
    wl = catalog.workload(args.workload)
    overrides = overrides or {}
    params = merge(wl["traffic"], overrides.get("traffic"))
    cfg = merge(catalog.config(wl["config"]), overrides.get("config"))
    chips = int(wl["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            say(f"{args.workload} needs {chips} CUDA card(s); "
                f"found {torch.cuda.device_count()}: no result")
            return 2
        device = "cuda"
    dev = torch.device(device)
    workdir = tempfile.mkdtemp(prefix="hipac_bench_run_")
    try:
        pieces: dict[str, float] = {}
        t = time.perf_counter()
        if dev.type == "cuda":
            torch.cuda.init()
            torch.zeros(1, device=dev)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        pieces["context"] = time.perf_counter() - t
        cell = catalog.driver(wl["driver"]).Cell(cfg, params, args.seed, dev,
                                                 workdir)
        cell.setup(pieces)
        setup_s = time.perf_counter() - T0
        pieces["other"] = setup_s - sum(pieces.values())
        print("setup_s by piece: " + json.dumps(
            {k: round(v, 4) for k, v in pieces.items()}), flush=True)

        summary = None
        if args.trace:
            with tr.profile() as prof:
                with tr.span(tr.WINDOW):
                    work = cell.window(min(args.seconds, TRACE_SECONDS))
            summary = tr.summarize(prof)
        else:
            work = cell.window(args.seconds)
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        print("launches: " + json.dumps(cell.launches()), flush=True)
        print("work: " + json.dumps({k: v for k, v in work.items()
                                     if not isinstance(v, list)}),
              flush=True)
        cell.release()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        checks = cell.check()
        found = forbidden_modules()
        if found:
            say(f"loaded {found}, which the benchmark must not load: "
                "no result")
            return 3

        metrics = {}
        if args.trace:
            for m in catalog.metrics_of(args.workload, "per_layer", bench):
                value = catalog.metric(m["name"]).read(summary, work)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            values = dict(cell.end_to_end(work), setup_s=setup_s)
            for m in catalog.metrics_of(args.workload, "end_to_end", bench):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        card = card_line() if dev.type == "cuda" else ""
        result = {
            "correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": work["attempted"],
            "failed": work["failed"],
            "metrics": metrics,
            "device": {
                "platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": chips,
                "memory_peak_bytes": int(peak),
            },
            "card": card,
        }
        if summary is not None:
            result["device"]["busy_s"] = summary["busy_s"]
            result["device"]["window_s"] = summary["window_s"]
            result["breakdown"] = summary["breakdown"]
        result["checks"] = checks
        for name, c in checks.items():
            say(f"check {name} = {c['value']!r} limit {c['limit']!r} "
                f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}")
        if out is not None:
            out.update(result)
        print(json.dumps(result), flush=True)
        return 0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
