"""Co-located multiscale patch sampling.

Copy of the JAX package's ``data/multiscale.py`` (``MultiscaleSample``,
``join_levels``, ``MultiscaleDataset``), held to it by exact tests, over the
port's manifest, patch store and split.

The per-level patch grids align across levels: the level-L patch size
224·2^(3-L) at downsample 2^L means grid cell (i, j) covers the same level-0
square at every level. This module joins the per-level manifests on (slide,
level-0 origin), so a model sees all magnifications of one location at once.

The ``"resize"`` input mode reads through ``PatchReader.read_batch(…,
resize_to=…)``, which downscales by the integer factors 2, 3, 4 and 8
(448², 672², 896² and 1792² patches at 224) with a numpy box mean equal
to cv2's ``INTER_AREA``, so that the standard pyramid reads without cv2;
other sizes resize with cv2.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    INPUT_SIZE,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
    PatchManifest,
    load_or_scan_manifest,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.patch_store import (
    PatchReader,
    resize_batch,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)

log = get_logger("data.multiscale")


@dataclasses.dataclass(frozen=True)
class MultiscaleSample:
    slide: str
    cell: tuple[int, int]  # level-0 (x, y) patch origin: unique per sample
    indices: dict[int, int]  # level → row in that level's manifest
    label: int  # tumor iff tumor at ANY level (finest annotation wins)


def join_levels(
    manifests: dict[int, PatchManifest],
) -> list[MultiscaleSample]:
    """Inner-join manifests on (slide, level-0 patch origin). A cell is
    kept only when every requested level stored a (tissue) patch there.

    Joining on level-0 origins (level coords × 2^level for the standard
    power-of-two pyramid) makes co-location exact even for overlapping
    (``stride < patch``) extractions, where grid-cell ids would collide.
    """
    levels = sorted(manifests)
    maps: dict[int, dict[tuple[str, int, int], int]] = {}
    for lvl in levels:
        scale = 2 ** lvl
        maps[lvl] = {
            (rec.slide, rec.x * scale, rec.y * scale): i
            for i, rec in enumerate(manifests[lvl])
        }
    base = levels[0]
    out = []
    for key, base_idx in maps[base].items():
        rows = {base: base_idx}
        for lvl in levels[1:]:
            idx = maps[lvl].get(key)
            if idx is None:
                break
            rows[lvl] = idx
        else:
            label = max(
                manifests[lvl][rows[lvl]].label for lvl in levels
            )
            out.append(
                MultiscaleSample(
                    slide=key[0], cell=(key[1], key[2]),
                    indices=rows, label=label,
                )
            )
    log.info(
        "multiscale join over levels %s: %d aligned cells", levels, len(out)
    )
    return out


class MultiscaleDataset:
    """Batches of co-located patches: dict[level → (B, S, S, 3) uint8].

    ``input_mode`` controls how a finer level's larger patch reaches the
    shared trunk's input size: ``"resize"`` box-downsamples it (at the
    standard 448→224 this composes to the same 8× box average as pyramid
    level 3, so the fine stream differs from the coarse one by uint8
    rounding only); ``"crop"`` takes the CENTER crop at native resolution
    (half the field of view, full magnification), which keeps the fine
    detail. The base level is input-sized either way.
    """

    def __init__(
        self,
        manifests: dict[int, PatchManifest],
        resize_to: int = INPUT_SIZE,
        input_mode: str = "resize",
    ):
        if input_mode not in ("resize", "crop"):
            raise ValueError(f"unknown input_mode {input_mode!r}")
        self.levels = sorted(manifests)
        self.manifests = manifests
        self.readers = {lvl: PatchReader(m) for lvl, m in manifests.items()}
        self.samples = join_levels(manifests)
        self.resize_to = resize_to
        self.input_mode = input_mode

    @classmethod
    def from_patches_dir(
        cls, patches_dir: str, levels: Sequence[int] = (2, 3),
        resize_to: int = INPUT_SIZE, input_mode: str = "resize",
    ) -> "MultiscaleDataset":
        manifests = {
            lvl: load_or_scan_manifest(patches_dir, lvl) for lvl in levels
        }
        return cls(manifests, resize_to=resize_to, input_mode=input_mode)

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def labels(self) -> np.ndarray:
        return np.array([s.label for s in self.samples], np.int32)

    def read_batch(
        self, indices: Sequence[int]
    ) -> tuple[dict[int, np.ndarray], np.ndarray]:
        imgs: dict[int, np.ndarray] = {}
        base = self.levels[-1]  # coarsest: defines the cell FoV, never cropped
        for lvl in self.levels:
            rows = [self.samples[int(i)].indices[lvl] for i in indices]
            if self.input_mode == "crop" and lvl != base:
                x = self.readers[lvl].read_batch(rows)  # native size
                if x.shape[1] > self.resize_to:
                    off = (x.shape[1] - self.resize_to) // 2
                    x = x[:, off:off + self.resize_to,
                          off:off + self.resize_to]
                elif x.shape[1] != self.resize_to:
                    # stored patches smaller than the input size: resize
                    # the batch already read instead of reading it again
                    x = resize_batch(x, self.resize_to)
                imgs[lvl] = np.ascontiguousarray(x)
            else:
                imgs[lvl] = self.readers[lvl].read_batch(
                    rows, resize_to=self.resize_to
                )
        labels = self.labels[np.asarray(indices, np.int64)]
        return imgs, labels

    def split_by_slide(
        self, val_fraction: float = 0.2, seed: int = 42
    ) -> tuple[np.ndarray, np.ndarray]:
        """Slide-level train/val sample indices (the reference's split
        semantics); with <2 slides a deterministic 80/20 sample split, so
        that calibration always has validation data.
        """
        from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
            slide_level_split,
        )

        slides = sorted({s.slide for s in self.samples})
        idx = np.arange(len(self.samples))
        if len(slides) < 2:
            rng = np.random.default_rng(seed)
            order = rng.permutation(idx)
            n_val = max(1, int(round(val_fraction * len(order))))
            return np.sort(order[n_val:]), np.sort(order[:n_val])
        train_slides, val_slides = slide_level_split(
            slides, val_fraction, seed
        )
        train_set = set(train_slides)
        is_train = np.array(
            [s.slide in train_set for s in self.samples], bool
        )
        return idx[is_train], idx[~is_train]

    def batches(
        self, batch_size: int, shuffle: bool = True, seed: int = 0,
        indices: np.ndarray | None = None, rows: slice | None = None,
    ) -> Iterator[tuple[dict[int, np.ndarray], np.ndarray, np.ndarray]]:
        """(``{level: uint8}``, labels, valid) batches of ``batch_size``
        cells of ``indices`` (default all), shuffled by ``seed``, the last
        wrap-padded with ``valid`` 0; ``rows`` (this rank's slice of each
        batch under data parallelism) reads only those rows."""
        order = (
            np.arange(len(self.samples))
            if indices is None else np.asarray(indices, np.int64).copy()
        )
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for start in range(0, len(order), batch_size):
            idx = order[start : start + batch_size]
            valid = np.ones((batch_size,), np.float32)
            if len(idx) < batch_size:
                valid[len(idx):] = 0.0
                idx = np.concatenate(
                    [idx, np.resize(order, batch_size - len(idx))]
                )
            if rows is not None:
                idx, valid = idx[rows], valid[rows]
            imgs, labels = self.read_batch(idx)
            yield imgs, labels.astype(np.int32), valid
