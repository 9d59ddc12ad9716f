#!/usr/bin/env python3
"""The t-SNE repulsion kernel (``ops/csrc/tsne_repulsion.cu``) on one NVIDIA
card, at the three sizes of ``chip_smoke.py`` phase 18: 1,752 rows (phase
8's feature triplet), 10,000 (``validate_features``' t-SNE cap) and 168,000
(``--tsne_full`` on the MIL triplet), on a seeded embedding (the kernel has
no branch on the values, so its time does not depend on them):

0. ``nvcc -Xptxas -v`` on the source: registers, spills, shared memory;
   and from ``cuobjdump -sass``, the float32 kernel's unmasked pair loop
   (the smallest loop with ``MUFU.RCP`` and no ``FSEL``): its instructions
   by opcode and a pair's share (one ``MUFU.RCP`` a pair);
1. the kernel against its plain version in float32 and float64
   (``chip_smoke.check_repulsion``), and a second call bit-equal;
2. per call and back to back beside the plain version, with its bound
   (``chip_smoke.time_repulsion``);
3. the device time of each of its launches by ``torch.profiler`` over 20
   calls back to back, and the host's time to enqueue a call (host clock
   over 200 calls, no synchronisation between them);
4. with ``--other NAME=DIR`` (repeatable; another checkout, such as the
   parent commit unpacked by ``git archive``, or only its
   ``…_torch/ops/csrc/tsne_repulsion.cu``): that file built by nvcc beside
   this one's, held to the plain version and timed back to back in turns
   with this one (other, this, this, other);
5. the SM clock and power (``nvidia-smi``, sampled every 0.2 s) while the
   kernel runs back to back for ~3 s at the largest size;
6. a descent iteration at 168,000 rows by piece
   (``chip_smoke.time_iteration``) on P of 168,000 × 512 seeded two-class
   features, as phase 18 builds them;
7. with ``--descents 1752,10000``: the whole t-SNE descent (1,000
   iterations, ``evaluation/embedding.py::tsne_descent``, after one
   untimed descent) at each size on
   seeded two-class × 512 features, ms an iteration by CUDA events, and a
   second descent under ``torch.profiler``: the device's busy time an
   iteration, the repulsion's share of it and the idle share. It uses
   nothing newer than the descent itself, so that run from an older
   checkout's root (``--rows "" --no-descent``) it times that checkout.

Run from the root of a checkout on a machine with a card:

    python3 scripts/profile_torch_tsne.py [--other parent=DIR ...] \\
        [--rows 1752,10000,168000] [--no-descent] [--descents 1752,10000] \\
        [--out logs/profile_torch_tsne.json]

It prints what it measures and writes it as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

SOURCE = "tsne_repulsion.cu"


def ptxas_report(src: str, out_dir: str) -> list[str]:
    """What ``ptxas -v`` says of each kernel of ``src``."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        NVCC_FLAGS,
        find_nvcc,
    )

    proc = subprocess.run(
        [find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.path.join(out_dir, "ptxas.so"), src],
        capture_output=True, text=True, timeout=600, check=True)
    return [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
            if "registers" in line or "spill" in line or "Compiling" in line]


def sass_pair_loop(src: str, out_dir: str) -> dict:
    """The float32 pair kernel's unmasked loop in the SASS of ``src``: its
    instructions by opcode and their count a pair."""
    import collections
    import re

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        NVCC_FLAGS,
        find_nvcc,
    )

    so = os.path.join(out_dir, "sass.so")
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", so, src], check=True,
                   timeout=600)
    sass = subprocess.run(
        [os.path.join(os.path.dirname(find_nvcc()), "cuobjdump"), "-sass", so],
        capture_output=True, text=True, timeout=600, check=True).stdout
    body = sass.split("repulsion_pairsIf", 1)[1].split("Function :", 1)[0]
    ins = [(int(m.group(1), 16), m.group(2), m.group(3)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*);", body)]
    loops = []
    for addr, op, rest in ins:
        target = re.search(r"0x([0-9a-f]+)", rest)
        if op == "BRA" and target and int(target.group(1), 16) < addr:
            ops = collections.Counter(
                o for a, o, _ in ins if int(target.group(1), 16) <= a <= addr)
            if ops["MUFU.RCP"] and not ops["FSEL"]:
                loops.append(ops)
    if not loops:
        return None
    ops = min(loops, key=lambda c: sum(c.values()))
    total = sum(ops.values())
    return {"instructions": total, "by_opcode": dict(ops.most_common()),
            "a_pair": total / ops["MUFU.RCP"]}


def other_kernel(checkout: str, out_dir: str):
    """The repulsion kernel of another checkout, built by nvcc and bound
    with the same signatures, as a function of the embedding."""
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        NVCC_FLAGS,
        SOURCES,
        find_nvcc,
    )

    src = os.path.join(checkout, cs.PKG, "ops", "csrc", SOURCE)
    so = os.path.join(out_dir, "libother_tsne_repulsion.so")
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", so, src], check=True,
                   timeout=600)
    lib = ctypes.CDLL(so)
    for name, (argtypes, restype) in SOURCES[SOURCE].items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype

    def call(y):
        n = y.shape[0]
        neg = torch.empty_like(y)
        sum_q = torch.empty((), dtype=torch.float64, device=y.device)
        size = lib.hipac_tsne_repulsion_scratch(n)
        scratch = torch.empty(size, dtype=torch.float64, device=y.device)
        rc = lib.hipac_tsne_repulsion(
            y.data_ptr(), neg.data_ptr(), sum_q.data_ptr(), scratch.data_ptr(),
            size, n, int(y.dtype == torch.float64),
            torch.cuda.current_stream(y.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the other checkout's kernel: cudaError {rc}")
        return neg, sum_q

    return call


def in_turns(y, name, other, this, smi) -> dict:
    """Back-to-back ms of two kernels on ``y``: other, this, this, other; a
    median of 5 groups of 10 each turn."""
    out = {name: [], "this": []}
    for turn in (name, "this", "this", name):
        fn = other if turn == name else this
        fn(y)
        out[turn].append(statistics.median(cs.back_to_back_ms(
            lambda: fn(y), groups=5, per=10)))
    cs.log(f"[tsne] {y.shape[0]} rows in turns, back to back: {name} "
           f"{out[name][0]:.4f} / {out[name][1]:.4f} ms, this "
           f"{out['this'][0]:.4f} / {out['this'][1]:.4f} ms [{smi}]")
    return out


def launches_by_profiler(fn, calls: int = 20) -> dict:
    """Device µs a launch of each kernel of ``fn`` (``torch.profiler``,
    ``calls`` calls back to back), and the host's µs to enqueue a call."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total = (getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0))
            out[e.key[:60]] = {"us": total / e.count, "count": e.count}
    t0 = time.perf_counter()
    for _ in range(200):
        fn()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    return {"device_us": out, "host_enqueue_us": host_us}


def clocks_while(fn, seconds: float) -> list[str]:
    """``nvidia-smi``'s SM clock and power draw every 0.2 s while ``fn``
    runs back to back for about ``seconds``."""
    import threading
    import time

    import torch

    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30).stdout.strip())
            time.sleep(0.2)

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    calls = max(1, int(seconds / (time.perf_counter() - t0)))
    th = threading.Thread(target=sample)
    th.start()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    stop.set()
    th.join()
    return samples


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=DIR",
                    help="another checkout whose kernel is timed in turns")
    ap.add_argument("--rows", default="1752,10000,168000")
    ap.add_argument("--no-descent", action="store_true",
                    help="leave out the descent iteration by piece")
    ap.add_argument("--descents", default="",
                    help="sizes at which to time the whole t-SNE descent")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "logs", "profile_torch_tsne.json"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation import (
        embedding as E,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        CSRC_DIR,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.tsne_repulsion import (
        tsne_repulsion_kernel,
    )

    smi, dev = cs.phase_card()
    result = {"card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        result["ptxas"] = ptxas_report(str(CSRC_DIR / SOURCE), tmp)
        for line in result["ptxas"]:
            cs.log(f"[ptxas] {line}")
        result["sass"] = sass_pair_loop(str(CSRC_DIR / SOURCE), tmp)
        cs.log(f"[sass] the float32 unmasked pair loop: "
               f"{json.dumps(result['sass'])}")
        others = {}
        for spec in args.other:
            name, path = spec.split("=", 1)
            os.makedirs(os.path.join(tmp, name))
            others[name] = other_kernel(path, os.path.join(tmp, name))
        g = torch.Generator(device=dev).manual_seed(cs.SEED)
        result["rows"] = {}
        for n in (int(r) for r in args.rows.split(",") if r):
            y = 20.0 * torch.randn(n, 2, generator=g, device=dev)
            row = {"max_abs_err": cs.check_repulsion(y)}
            for dtype in (torch.float32, torch.float64):
                yd = y.to(dtype)
                a, b = tsne_repulsion_kernel(yd), tsne_repulsion_kernel(yd)
                if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                    raise AssertionError(f"{n} rows {dtype}: a second call "
                                         "differs")
            row.update(cs.time_repulsion(y, 5 if n <= 10_000 else 1, smi))
            row["profiler"] = launches_by_profiler(
                lambda: tsne_repulsion_kernel(y))
            cs.log(f"[tsne] {n} rows: {json.dumps(row['profiler'])}")
            ref_neg = E.tsne_repulsion_reference(y)[0]
            for name, other in others.items():
                err = float((other(y)[0] - ref_neg).abs().max())
                cs.log(f"[tsne] {name} at {n} rows: max_abs_err {err:.3g}")
                row[name] = {"max_abs_err": err, "in_turns": in_turns(
                    y, name, other, tsne_repulsion_kernel, smi)}
            result["rows"][str(n)] = row
        if result["rows"]:
            result["clocks"] = clocks_while(
                lambda: tsne_repulsion_kernel(y), 3.0)
            cs.log(f"[tsne] SM clock, power draw at {n} rows back to back: "
                   f"{result['clocks']}")
        if not args.no_descent:
            n = cs.EMB_FULL_ROWS
            cls = torch.rand(n, generator=g, device=dev) < 0.4
            x = torch.randn(n, cs.EMB_TIMING_DIM, generator=g, device=dev)
            x += 0.5 * cls[:, None] * torch.randn(cs.EMB_TIMING_DIM,
                                                  generator=g, device=dev)
            p = E.tsne_affinities(x, 30.0)
            y0 = E.tsne_init(x)
            del x
            result["iteration_ms"] = cs.time_iteration(
                E.KLObjective(p), y0, E.tsne_learning_rate(n), 10, smi)
            del p, y0
        result["descents"] = {}
        for n in (int(r) for r in args.descents.split(",") if r):
            gd = torch.Generator(device=dev).manual_seed(cs.SEED)
            cls = torch.rand(n, generator=gd, device=dev) < 0.4
            x = torch.randn(n, cs.EMB_TIMING_DIM, generator=gd, device=dev)
            x += 0.5 * cls[:, None] * torch.randn(cs.EMB_TIMING_DIM,
                                                  generator=gd, device=dev)
            p, y0 = E.tsne_affinities(x, 30.0), E.tsne_init(x)
            descent = lambda: E.tsne_descent(  # noqa: E731
                E.KLObjective(p), y0, E.tsne_learning_rate(n))
            descent()  # warm: the first calls load libraries and kernels
            (_, kl, it), ms = cs._events_ms(descent)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                (_, _, it_p), ms_p = cs._events_ms(descent)
            busy = cs.busy_us(prof) / 1e3
            repulsion = sum(
                getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "repulsion" in e.key) / 1e3
            result["descents"][str(n)] = {
                "ms_an_iteration": ms / (it + 1), "iterations": it + 1,
                "kl": kl, "busy_ms_an_iteration": busy / (it_p + 1),
                "repulsion_ms_an_iteration": repulsion / (it_p + 1),
                "idle_share": 1 - busy / ms_p}
            cs.log(f"[tsne] the descent at {n} × {cs.EMB_TIMING_DIM}: "
                   f"{ms / (it + 1):.4f} ms an iteration over {it + 1}, KL "
                   f"{kl:.4f}; under the profiler the device busy "
                   f"{busy / (it_p + 1):.4f} ms an iteration (the repulsion's "
                   f"launches {repulsion / (it_p + 1):.4f}), idle share "
                   f"{1 - busy / ms_p:.3f} [{smi}]")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    cs.log(f"[tsne] written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
