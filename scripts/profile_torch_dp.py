#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` alone: data parallelism and the slide fleet.

Renders a 7168×5376 synthetic slide with the default tumor polygon (a
quarter of the smoke slide, so the run takes about a minute), cuts its
level-3 tissue cells into a packed store (repeated to one global batch of
512), calibrates the slide model's BatchNorm on them, and runs
``chip_smoke.py``'s phase 14 on them with every check of that phase:

- (a) the classifier ``Trainer`` and a SimCLR step (NT-Xent kernels) over
  a world-1 NCCL group in this process against one process, the global
  BatchNorm's CUDA route against its plain route, step walls beside the
  plain route's;
- (b), (c) 2 spawned ranks on the first card over gloo;
- (f) with two cards or more, one rank a card over NCCL (``--chips 4``);
- (d), (e) ``--predict_slide <dir> --group_size 1`` through the CLI over
  the slide and a second seeded one against the slides in turn, two fleet
  threads sharing the first card; with two cards or more, the slide split
  over every card against one card.

Run from the root of a checkout on a machine with one or more cards:

    python3 scripts/profile_torch_dp.py
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

SLIDE_W, SLIDE_H = 7168, 5376


def main() -> int:
    import numpy as np

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
        PatchDataset,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
        PatchManifest,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
        save_npz_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.synthetic import (
        make_synthetic_slide,
        tumor_spec,
    )

    t0 = time.perf_counter()
    smi, dev = cs.phase_card()
    cs.phase_build()
    spec = tumor_spec(width=SLIDE_W, height=SLIDE_H, seed=1)
    slide = make_synthetic_slide(spec)
    grid, tissue = cs.tissue_cells(slide)
    labels = cs.tumor_labels(spec, slide, grid, tissue)
    cs.log(f"[dp-profile] {SLIDE_W}×{SLIDE_H} slide: {len(tissue)} tissue "
           f"cells, rendered in {time.perf_counter() - t0:.1f} s")
    calib = np.stack([cs.read_cell(slide, grid, iy, ix)
                      for iy, ix in tissue[:cs.CALIB_CELLS]])
    sd, _, model = cs.make_model(dev, calib)
    del model
    with tempfile.TemporaryDirectory() as tmp:
        ds = cs.simclr_dataset(slide, grid, tissue, labels, tmp)
        recs = ds.manifest.records
        recs = (recs * -(-cs.BATCH // len(recs)))[:cs.BATCH]
        path = os.path.join(tmp, "smoke_slide.wsi.npz")
        save_npz_slide(path, [slide.level_array(i)
                              for i in range(slide.level_count)])
        dp = cs.phase_dp(dev, PatchDataset(PatchManifest(recs)), smi, tmp)
        fleet = cs.phase_fleet(dev, sd, path, smi, tmp)
    cs.log(f"[dp-profile] augment launches {dp['aug_launches']}, nt_xent "
           f"{dp['ntx_launches']} each, fused_normalize (fleet) "
           f"{fleet['launches']}; {time.perf_counter() - t0:.1f} s in all "
           f"[{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
