"""Manifest-backed patch datasets and batch iteration.

Copy of the JAX package's ``data/datasets.py`` (``PatchDataset``,
``BatchIterator``), held to it by exact tests: the same seeded per-epoch
shuffle (``default_rng(seed + epoch)``), the same wrap-padding of the final
short batch, and the same ``valid`` mask of its real rows. Batches are raw
uint8 images and int labels; augmentation and normalisation run on the
device (``data/augment.py``). The samplers, remainder-dropping
iteration, the slide-level split and class balancing
(``from_manifest``) come with the classifier trainer.
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
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.patch_store import (
    PatchReader,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)

log = get_logger("data.datasets")


@dataclasses.dataclass
class PatchDataset:
    """An index over a manifest subset with a random-access reader."""

    manifest: PatchManifest
    resize_to: int = INPUT_SIZE
    #: emit batches in the stem's space-to-depth layout (B, H/2, W/2, 12),
    #: the int8 inference feed
    s2d: bool = False

    def __post_init__(self):
        self.reader = PatchReader(self.manifest)
        counts = self.manifest.class_counts()
        log.info(
            "PatchDataset initialized: %d total patches. Tumor: %d | Normal: %d",
            len(self.manifest), counts.get(1, 0), counts.get(0, 0),
        )

    def __len__(self) -> int:
        return len(self.manifest)

    @property
    def labels(self) -> np.ndarray:
        return self.manifest.labels()

    def class_counts(self) -> dict[int, int]:
        return self.manifest.class_counts()

    def read_batch(self, indices: Sequence[int]) -> tuple[np.ndarray, np.ndarray]:
        imgs = self.reader.read_batch(indices, resize_to=self.resize_to,
                                      s2d=self.s2d)
        labels = self.labels[np.asarray(indices, dtype=np.int64)]
        return imgs, labels


class BatchIterator:
    """Epoch iterator yielding (images u8 (B,H,W,3), labels i32 (B,), valid
    f32 (B,)) with a **static batch size**: each epoch shuffles anew, the
    final short batch is padded by wrapping, and ``valid`` marks its real
    rows. ``shuffle=False`` walks the manifest in order, as feature
    extraction does. (The JAX class with ``drop_remainder=False`` and no
    sampler.)"""

    def __init__(self, dataset: PatchDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        bs = self.batch_size
        for start in range(0, len(order), bs):
            idx = order[start : start + bs]
            valid = np.ones((bs,), np.float32)
            if len(idx) < bs:
                valid[len(idx):] = 0.0
                # wrap-pad (tiling as needed for datasets smaller than a batch)
                pad = np.resize(order, bs - len(idx))
                idx = np.concatenate([idx, pad])
            imgs, labels = self.dataset.read_batch(idx)
            yield imgs, labels.astype(np.int32), valid
