"""Manifest-backed patch datasets, slide-level splits and batch iteration.

Copy of the JAX package's ``data/datasets.py``, held to it by exact tests:

- the **slide-level** train/val split (:func:`slide_level_split`), a numpy
  rule equal to sklearn's ``train_test_split(slides, test_size=f,
  random_state=seed)``, which the JAX function calls (the card's machine has
  no sklearn);
- class balancing to the smallest class (``PatchDataset.from_manifest``,
  :func:`balance_to_min_class` for the validation set);
- batches of a **static size**: the same seeded per-epoch shuffle
  (``default_rng(seed + epoch)``) or :class:`BalancedSampler` order, the
  same wrap-padding of the final short batch (or its drop), and the same
  ``valid`` mask of its real rows.

Batches are raw uint8 images and int labels; augmentation and normalisation
run on the device (``data/augment.py``).
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
from ss25_hierarchical_multiscale_image_classification_tpu_torch.utils.profiling import (
    annotate,
    count,
)

log = get_logger("data.datasets")


def slide_level_split(
    slides: Sequence[str], val_fraction: float = 0.2, seed: int = 42
) -> tuple[list[str], list[str]]:
    """Deterministic slide-level train/val split: the sorted slides shuffled
    by ``RandomState(seed).permutation``, the first ``ceil(val_fraction·n)``
    to validation, the rest to training, which is what sklearn's
    ``train_test_split(slides, test_size=val_fraction, random_state=seed)``
    does, and raising where it raises. A single slide goes to both sides."""
    slides = sorted(slides)
    n = len(slides)
    if n < 2:
        return list(slides), list(slides)
    if not 0.0 < val_fraction < 1.0:
        raise ValueError(f"test_size={val_fraction} should be a float in the "
                         "(0, 1) range")
    n_test = int(np.ceil(val_fraction * n))
    if n - n_test == 0:
        raise ValueError(
            f"With n_samples={n}, test_size={val_fraction} and "
            "train_size=None, the resulting train set will be empty. Adjust "
            "any of the aforementioned parameters.")
    perm = np.random.RandomState(seed).permutation(n)
    return ([slides[i] for i in perm[n_test:]],
            [slides[i] for i in perm[:n_test]])


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

    @classmethod
    def from_manifest(
        cls,
        manifest: PatchManifest,
        slide_names: Sequence[str] | None = None,
        balanced: bool = False,
        max_samples: int | None = None,
        seed: int = 0,
        resize_to: int = INPUT_SIZE,
    ) -> "PatchDataset":
        """A dataset of the manifest's rows (of ``slide_names``), each class
        subsampled to the smallest class's count (capped at
        ``max_samples``) when ``balanced``, else to ``max_samples``, then
        shuffled, all from ``default_rng(seed)``."""
        if slide_names is not None:
            manifest = manifest.for_slides(slide_names)
        labels = manifest.labels()
        rng = np.random.default_rng(seed)
        by_class = {c: np.flatnonzero(labels == c) for c in np.unique(labels)}
        selected: list[int] = []
        if balanced and by_class:
            min_count = min(len(v) for v in by_class.values())
            count = min(min_count, max_samples) if max_samples else min_count
            for idxs in by_class.values():
                take = min(count, len(idxs))
                selected.extend(rng.choice(idxs, size=take, replace=False))
        else:
            for idxs in by_class.values():
                if max_samples and len(idxs) > max_samples:
                    idxs = rng.choice(idxs, size=max_samples, replace=False)
                selected.extend(idxs)
        rng.shuffle(selected)
        sub = PatchManifest([manifest[int(i)] for i in selected])
        return cls(sub, resize_to=resize_to)


def balance_to_min_class(
    manifest: PatchManifest, seed: int = 42
) -> PatchManifest:
    """Every class subsampled to the smallest class's count with a seeded
    RNG, rows kept in manifest order: the validation set's balancing."""
    labels = manifest.labels()
    rng = np.random.default_rng(seed)
    by_class = {c: np.flatnonzero(labels == c) for c in np.unique(labels)}
    if not by_class:
        return manifest
    min_count = min(len(v) for v in by_class.values())
    selected = []
    for idxs in by_class.values():
        selected.extend(rng.choice(idxs, size=min_count, replace=False))
    selected.sort()
    return PatchManifest([manifest[int(i)] for i in selected])


def make_train_val_datasets(
    manifest: PatchManifest,
    val_fraction: float = 0.2,
    split_seed: int = 42,
    balance_val_seed: int = 42,
    resize_to: int = INPUT_SIZE,
) -> tuple[PatchDataset, PatchDataset]:
    """The slide-level split, the training rows as they are and a
    class-balanced validation set."""
    train_slides, val_slides = slide_level_split(
        manifest.slides(), val_fraction, split_seed
    )
    train_ds = PatchDataset(manifest.for_slides(train_slides), resize_to=resize_to)
    val_manifest = balance_to_min_class(
        manifest.for_slides(val_slides), seed=balance_val_seed
    )
    val_ds = PatchDataset(val_manifest, resize_to=resize_to)
    return train_ds, val_ds


class BatchIterator:
    """Epoch iterator yielding (images u8 (B,H,W,3), labels i32 (B,), valid
    f32 (B,)) with a **static batch size**: each epoch takes its order from
    ``sampler`` or shuffles anew (``shuffle=False`` walks the manifest in
    order, as feature extraction does); the final short batch is padded by
    wrapping, with ``valid`` marking its real rows, or dropped
    (``drop_remainder``). ``set_epoch`` sets the next epoch's number.
    ``rows`` (a slice of the batch, this rank's under data parallelism)
    reads and yields only those rows of every batch, the order being the
    same on every rank. Each batch's read is the span
    ``hipac.data.gather``, its images' bytes counted in
    ``hipac.data.bytes``."""

    def __init__(
        self,
        dataset: PatchDataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        sampler: "Sampler | None" = None,
        drop_remainder: bool = False,
        rows: slice | None = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.sampler = sampler
        self.drop_remainder = drop_remainder
        self.rows = rows
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        n = len(self.dataset)
        if self.sampler is not None:
            order = self.sampler.epoch_indices(self._epoch)
        else:
            order = np.arange(n)
            if self.shuffle:
                np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        bs = self.batch_size
        stop = (len(order) // bs) * bs if self.drop_remainder else len(order)
        for start in range(0, stop, bs):
            idx = order[start : start + bs]
            valid = np.ones((bs,), np.float32)
            if len(idx) < bs:
                valid[len(idx):] = 0.0
                # wrap-pad (tiling as needed for datasets smaller than a batch)
                pad = np.resize(order, bs - len(idx))
                idx = np.concatenate([idx, pad])
            if self.rows is not None:
                idx, valid = idx[self.rows], valid[self.rows]
            with annotate("hipac.data.gather"):
                imgs, labels = self.dataset.read_batch(idx)
            count("hipac.data.bytes", imgs.nbytes)
            yield imgs, labels.astype(np.int32), valid


class Sampler:
    """An epoch's order of dataset indices."""

    def epoch_indices(self, epoch: int) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError


class BalancedSampler(Sampler):
    """Class-balanced sampling with replacement (the ``balanced``
    strategy): per epoch, ``ceil(num_samples / classes)`` draws of each
    class from ``default_rng(seed + epoch)``, cut to ``num_samples`` and
    shuffled."""

    def __init__(self, labels: np.ndarray, num_samples: int | None = None,
                 seed: int = 0):
        self.labels = np.asarray(labels)
        self.num_samples = num_samples or len(self.labels)
        self.seed = seed

    def epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch)
        classes = np.unique(self.labels)
        per_class = -(-self.num_samples // len(classes))
        out = []
        for c in classes:
            idxs = np.flatnonzero(self.labels == c)
            out.append(rng.choice(idxs, size=per_class, replace=True))
        order = np.concatenate(out)[: self.num_samples]
        rng.shuffle(order)
        return order
