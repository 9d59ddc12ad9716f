#!/usr/bin/env python3
"""What the design choices of the port's augment kernel cost on one NVIDIA card.

Builds ``ops/csrc/augment.cu`` as committed and variants of it, each made
from the committed source by a named edit, into libraries of their own,
and times each one's kernel alone, back to back (CUDA events around 20
launches, medians of 10 groups), in turns over ``--rounds`` rounds, on the
training path's shape: (512, 224, 224, 3) uint8 from a seed, the port's own
draws. The variants:

- ``no band load``: the bulk copies and the wait for them left out, so the
  block computes from whatever its shared memory holds: the compute and
  store path alone (its output is not compared);
- ``256 threads``: blocks of 256 threads, 4 an SM (the committed kernel has
  128, 8 an SM);
- ``__fdiv_rn``: the normalization's IEEE division in place of the
  reciprocal and two FMAs;
- ``float arithmetic``: each colour product and sum in float32, rounded to
  bfloat16 by a conversion after every operation, in place of the
  ``bf16x2`` instructions.

Every variant but ``no band load`` computes the same function: its output
is held equal to the plain version's, bit for bit.

With ``--other DIR`` (a checkout of another commit) it then times the call
as the trainer makes it, ``augment_batch_kernel(params, imgs)`` on the same
seeded inputs, in each checkout in turns (other, this, this, other), each in
a process of its own: CUDA-event medians per call and back to back.

Run from the root of a checkout on a machine with a card:

    python3 scripts/profile_torch_augment.py [--rounds 3] [--other DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FLOAT_CHANNEL = '''
__device__ __forceinline__ float channel_f32(const float* m, float bias,
                                             float r, float g, float b,
                                             float mean, float std) {
  float c = bf16r(__fmul_rn(m[0], r));
  c = bf16r(__fadd_rn(c, bf16r(__fmul_rn(m[1], g))));
  c = bf16r(__fadd_rn(c, bf16r(__fmul_rn(m[2], b))));
  c = bf16r(__fadd_rn(c, bias));
  c = fminf(fmaxf(c, 0.0f), 1.0f);
  return __fdiv_rn(__fsub_rn(__fmul_rn(c, 255.0f), mean), std);
}

__device__ __forceinline__ void cluster_arrive() {'''

FLOAT_PIXEL = '''          const uint8_t* p = band + org + iy * dy + ix * dx;
          const float vr = bf16r(__fmul_rn(static_cast<float>(p[0]), nm.inv255));
          const float vg = bf16r(__fmul_rn(static_cast<float>(p[1]), nm.inv255));
          const float vb = bf16r(__fmul_rn(static_cast<float>(p[2]), nm.inv255));
          float* o = bufw + (q * kRun + lane) * 3;
          o[0] = channel_f32(mf, bf, vr, vg, vb, nm.m0, nm.s0);
          o[1] = channel_f32(mf + 3, bf, vr, vg, vb, nm.m1, nm.s1);
          o[2] = channel_f32(mf + 6, bf, vr, vg, vb, nm.m2, nm.s2);
        }'''

VARIANTS = {
    "committed": [],
    "no band load": [
        ("      for (int r = lane; r < nr; r += 32) {\n        bulk_copy_g2s(",
         "      for (int r = lane; r < 0; r += 32) {\n        bulk_copy_g2s("),
        ("      if (lane == 0) mbar_arrive_expect_tx(bar, nr * row_bytes);\n",
         ""),
        ("    if (nr > 0) mbar_wait(bar, 0);\n", ""),
    ],
    "256 threads": [
        ("constexpr int kThreads = 128;", "constexpr int kThreads = 256;"),
        ("__launch_bounds__(kThreads, 8)", "__launch_bounds__(kThreads, 4)"),
    ],
    "__fdiv_rn": [
        ("  const float q0 = __fmul_rn(a, y);\n"
         "  return __fmaf_rn(__fmaf_rn(-std, q0, a), y, q0);",
         "  return __fdiv_rn(a, std);"),
    ],
    "float arithmetic": [
        ("\n__device__ __forceinline__ void cluster_arrive() {", FLOAT_CHANNEL),
        ("  const uint32_t bias2 = bias | bias << 16;\n",
         "  const uint32_t bias2 = bias | bias << 16;\n"
         "  float mf[9];\n"
         "  for (int i = 0; i < 9; ++i)\n"
         "    mf[i] = __uint_as_float(static_cast<uint32_t>(mat[b * 9 + i]) << 16);\n"
         "  const float bf = __uint_as_float(bias << 16);\n"),
        (None, FLOAT_PIXEL),
    ],
}


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if old is None:  # the per-pixel block, from its first line to its end
            start = src.index("          const uint8_t* p = band + org")
            end = src.index("        }\n", src.index("o[2] = normalize", start))
            src = src[:start] + new + src[end + len("        }"):]
            continue
        if src.count(old) != 1:
            raise SystemExit(f"the kernel source changed: {old[:60]!r} is not "
                             f"in it once; update this script's edits")
        src = src.replace(old, new)
    return src


# The call in one checkout (the working directory): JSON on the last line.
CALL = """
import json, statistics, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import sample_augment_params
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.augment import augment_batch_kernel
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(cs.SEED)
x = torch.randint(0, 256, (cs.BATCH, 224, 224, 3), dtype=torch.uint8, device=dev, generator=g)
p = sample_augment_params(g, cs.BATCH)
call = lambda: augment_batch_kernel(p, x)
cs.cuda_ms(call, 5)
before = augment_batch_kernel.launches
call()
launches = augment_batch_kernel.launches - before
print(json.dumps({"per_call": statistics.median(cs.cuda_ms(call, 40)),
                  "back_to_back": statistics.median(cs.back_to_back_ms(call)),
                  "launches": launches}))
"""


def compare_calls(other: str) -> None:
    runs = {ROOT: [], other: []}
    for tree in (other, ROOT, ROOT, other):
        proc = subprocess.run([sys.executable, "-c", CALL], cwd=tree,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode:
            raise SystemExit(f"the call failed in {tree}:\n{proc.stderr}")
        runs[tree].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for name, tree in (("other", other), ("this", ROOT)):
        per_call = ", ".join(f"{r['per_call']:.4f}" for r in runs[tree])
        b2b = ", ".join(f"{r['back_to_back']:.4f}" for r in runs[tree])
        print(f"  the call, {name} checkout ({runs[tree][0]['launches']} "
              f"launches a call): per call {per_call} ms, back to back "
              f"{b2b} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--other", help="a checkout of another commit to time "
                    "the call against")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
        augment as plain,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops import (
        augment as kernel,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        BUILD_DIR,
        CSRC_DIR,
        NVCC_FLAGS,
        SOURCES,
        find_nvcc,
    )

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")

    out_dir = BUILD_DIR / "augment_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (CSRC_DIR / "augment.cu").read_text()
    jobs = {}
    for name, edits in VARIANTS.items():
        stem = name.replace(" ", "_").strip("_")
        cu = out_dir / f"{stem}.cu"
        cu.write_text(variant_source(src, edits))
        so = out_dir / f"lib{stem}.so"
        jobs[name] = (so, subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, f"-I{CSRC_DIR}", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    argtypes, restype = SOURCES["augment.cu"]["hipac_augment"]
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name!r}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.hipac_augment.argtypes, lib.hipac_augment.restype = argtypes, restype
        libs[name] = lib

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    b, s = cs.BATCH, 224
    x = torch.randint(0, 256, (b, s, s, 3), dtype=torch.uint8, device=dev,
                      generator=g)
    p = plain.sample_augment_params(g, b)
    md = plain.augment_matrix(p)
    stream = torch.cuda.current_stream().cuda_stream
    outs = {name: torch.empty(x.shape, dtype=torch.float32, device=dev)
            for name in libs}

    def launch(name):
        rc = libs[name].hipac_augment(
            x.data_ptr(), p["h"].data_ptr(), p["v"].data_ptr(),
            p["k"].data_ptr(), p["k"].element_size() // 4, kernel.D4_PACKED,
            md.data_ptr(), p["fb"].data_ptr(), p["fc"].data_ptr(),
            outs[name].data_ptr(), b, s, kernel.INV_255_BF16, *plain.MEAN_255,
            *plain.STD_255, stream)
        if rc:
            raise RuntimeError(f"{name}: cudaError {rc}")

    for name in libs:
        launch(name)
    torch.cuda.synchronize()
    ref = plain.augment_batch(p, x)
    for name in libs:
        if name != "no band load" and not torch.equal(outs[name], ref):
            raise AssertionError(f"{name!r} differs from the plain version")
    times = {name: [] for name in libs}
    for _ in range(args.rounds):
        for name in libs:
            times[name].append(statistics.median(
                cs.back_to_back_ms(lambda: launch(name))))
    bound = cs.bound_ms(5 * x.numel(), 12 * x.numel())["bound_ms"]
    print(f"(512, 224, 224, 3) u8 -> f32, the kernel alone back to back, "
          f"{args.rounds} rounds in turns; bound {bound:.4f} ms")
    for name, ts in times.items():
        print(f"  {name:18s} {min(ts):.4f}-{max(ts):.4f} ms "
              f"({bound / statistics.median(ts) * 100:.1f} % of the bound)")
    if args.other:
        compare_calls(os.path.abspath(args.other))
    return 0


if __name__ == "__main__":
    sys.exit(main())
