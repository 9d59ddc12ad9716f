#!/usr/bin/env python3
"""Is the int8 slide's detection CSV of another checkout byte-identical to
this one's?

The port's int8 kernels equal their plain versions bit for bit, so a change
to a kernel must leave ``--predict_slide --int8`` with exactly the same CSV.
This script builds ``chip_smoke.py``'s synthetic slide and model once,
calibrates the int8 artifact once (with this checkout), then runs

    python -m ss25_hierarchical_multiscale_image_classification_tpu_torch.cli.main \\
        --predict_slide <slide> --int8 --models_dir <copy> ...

as a subprocess from the root of each checkout (this one, and ``--other``,
e.g. the parent commit unpacked with ``git archive`` into a git-ignored
directory) on the same slide file, weights and artifact, and compares the
two CSV files' bytes. Run from the root of a checkout on a machine with a
card:

    python3 scripts/compare_torch_int8_csv.py --other chip_scratch/parent

Exit code 0 when the files are identical, 1 otherwise.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile

import profile_torch_slice as pts

ROOT = pts.ROOT
cs = pts.cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="root of the checkout to compare with")
    args = ap.parse_args()

    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        Config,
        DataConfig,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
        save_npz_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.synthetic import (
        SyntheticSlideSpec,
        make_synthetic_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quant_artifact import (
        quantize_classifier_to_artifact,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
        save_model,
    )

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    other = os.path.abspath(args.other)
    slide = make_synthetic_slide(
        SyntheticSlideSpec(width=cs.SLIDE_W, height=cs.SLIDE_H, seed=1))
    grid, tissue = cs.tissue_cells(slide)
    pick = np.random.default_rng(cs.SEED).permutation(len(tissue))
    calib = np.stack([cs.read_cell(slide, grid, iy, ix)
                      for iy, ix in tissue[pick[:cs.CALIB_CELLS]]])
    sd, _, _ = cs.make_model(dev, calib)
    digests = {}
    with tempfile.TemporaryDirectory() as tmp:
        ds = cs.simclr_dataset(slide, grid, tissue, tmp)
        models_dir = os.path.join(tmp, "models")
        save_model(os.path.join(models_dir, "resnet18_patch_classifier"), sd)
        cfg = Config(data=DataConfig(data_dir=os.path.join(tmp, "data")),
                     models_dir=models_dir)
        quantize_classifier_to_artifact(cfg, level=cs.LEVEL, dataset=ds,
                                        device=dev)
        slide_path = os.path.join(tmp, "slide.wsi.npz")
        save_npz_slide(slide_path, [slide.level_array(i)
                                    for i in range(slide.level_count)])
        for name, root in (("this checkout", ROOT), ("other checkout", other)):
            run_dir = os.path.join(tmp, name.split()[0])
            shutil.copytree(models_dir, run_dir)
            cmd = [sys.executable, "-m", f"{cs.PKG}.cli.main",
                   "--predict_slide", slide_path, "--int8", "--models_dir",
                   run_dir, "--patch_level", str(cs.LEVEL), "--stride",
                   str(cs.STRIDE), "--batch_size", str(cs.BATCH)]
            env = dict(os.environ, PYTHONPATH=root)
            proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                                  text=True, timeout=900)
            if proc.returncode != 0:
                raise SystemExit(f"{name}: the CLI failed "
                                 f"({proc.returncode})\n{proc.stderr[-3000:]}")
            with open(os.path.join(run_dir, "model_predictions_csv",
                                   "slide.csv"), "rb") as f:
                data = f.read()
            digests[name] = (hashlib.sha256(data).hexdigest(), len(data),
                             data.count(b"\n"))
            print(f"{name} ({root}): {digests[name][2]} lines, "
                  f"{digests[name][1]} bytes, sha256 {digests[name][0]}")
    same = digests["this checkout"] == digests["other checkout"]
    print("the int8 slide's detection CSV is "
          + ("byte-identical in both checkouts" if same else "DIFFERENT"))
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
