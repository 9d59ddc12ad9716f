"""Cells cut to what a test on the CPU can hold: the same drivers, traffic
and checks at a few cells, patches and steps."""

SLIDE = {
    "traffic": {"plane": {"height": 448, "width": 896, "blobs": 4,
                          "radius": [0.2, 0.4], "tumor_blob_share": 0.5},
                "sizes": 2, "area": [0.5, 1.0], "calibration": {"cells": 8},
                "check_slides": 2, "check_block": 16},
    "config": {"batch_size": 4},
}
STORE = {"patches": 24, "size": 96, "height": 512, "width": 1024,
         "blobs": 6, "radius": [0.15, 0.35]}
TRAIN = {"traffic": {"store": STORE}, "config": {"batch_size": 8}}
SIMCLR = {"traffic": {"store": STORE},
          "config": {"batch_size": 8, "image_size": 96}}
BY_CELL = {"r18-slide": SLIDE, "r18-train": TRAIN, "simclr-pretrain": SIMCLR}
SEED = 3_000_000_019  # above 2**31, as the driver's are
