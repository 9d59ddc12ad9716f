"""MIL bag construction from the patch feature store.

Numpy copies of the JAX package's ``data/mil.py`` (``slide_from_patch_name``,
``Bag``, ``build_bags``, ``bags_from_artifacts``, ``MILBagIterator``), held
to the originals by exact tests: patch features grouped by slide, the slide
label "tumor iff any patch is tumor", bags padded to a static size with a
mask, batches shuffled with ``np.random.default_rng(seed + epoch)``. Patch
names follow the reference's ``{slide}_x{x}_y{y}_{label}.png``.
:func:`image_bags_from_manifest` builds image-space bags (raw uint8 patches
of each slide, for ``models/cnn_encoder.py``), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Iterator, Sequence

import numpy as np

from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.mil import (
    pad_bag,
)

_NAME_RE = re.compile(r"^(?P<slide>.+)_x\d+_y\d+_(?:normal|tumor)\.png$")


def slide_from_patch_name(name: str) -> str:
    m = _NAME_RE.match(name)
    if m:
        return m.group("slide")
    # degenerate fallback, as the reference's dataset parses names
    return "_".join(name.split("_")[:-2])


@dataclasses.dataclass
class Bag:
    slide: str
    features: np.ndarray  # (K, D)
    label: int  # 1 iff any instance is tumor
    coords: np.ndarray | None = None  # (K, 2) level coords when known


def build_bags(
    features: np.ndarray,
    labels: np.ndarray,
    patch_names: Sequence[str],
    coords: np.ndarray | None = None,
) -> list[Bag]:
    """Group per-patch features into per-slide bags, sorted by slide."""
    by_slide: dict[str, list[int]] = {}
    for i, name in enumerate(patch_names):
        by_slide.setdefault(slide_from_patch_name(name), []).append(i)
    bags = []
    for slide, idxs in sorted(by_slide.items()):
        idx = np.asarray(idxs)
        bags.append(
            Bag(
                slide=slide,
                features=features[idx],
                label=int((labels[idx] == 1).any()),
                coords=None if coords is None else coords[idx],
            )
        )
    return bags


def bags_from_artifacts(features_dir: str, level: int) -> list[Bag]:
    """Bags straight from the feature artifact triplet
    (``patch_features_{L}.npy`` etc.)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.features import (
        load_feature_artifacts,
    )

    feats, labels, names = load_feature_artifacts(features_dir, level)
    return build_bags(feats, labels, names)


def image_bags_from_manifest(
    manifest, resize_to: int = 224
) -> list[Bag]:
    """Image-space bags: one (K, H, W, 3)-patch bag per slide, sorted by
    slide: all stored patches of the slide (``features`` holds the raw
    uint8 patches at ``resize_to``), label tumor iff any patch is tumor,
    ``coords`` the patches' (x, y). Encode them with ``models.cnn_encoder``
    (or the ResNet18 extractor) before pooling."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.patch_store import (
        PatchReader,
    )

    reader = PatchReader(manifest)
    by_slide: dict[str, list[int]] = {}
    for i, rec in enumerate(manifest):
        by_slide.setdefault(rec.slide, []).append(i)
    bags = []
    for slide, idxs in sorted(by_slide.items()):
        imgs = reader.read_batch(idxs, resize_to=resize_to)
        labels = manifest.labels()[np.asarray(idxs)]
        coords = np.array(
            [(manifest[i].x, manifest[i].y) for i in idxs], np.int64
        )
        bags.append(
            Bag(
                slide=slide,
                features=imgs,  # (K, H, W, 3) uint8
                label=int((labels == 1).any()),
                coords=coords,
            )
        )
    return bags


class MILBagIterator:
    """Static-shape bag batches: (B, max_bag, D) + (B, max_bag) mask +
    (B,) labels + (B,) valid."""

    def __init__(
        self,
        bags: Sequence[Bag],
        batch_size: int,
        max_bag_size: int,
        shuffle: bool = True,
        seed: int = 0,
    ):
        self.bags = list(bags)
        self.batch_size = batch_size
        self.max_bag_size = max_bag_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return -(-len(self.bags) // self.batch_size)

    def __iter__(self) -> Iterator[tuple[np.ndarray, ...]]:
        order = np.arange(len(self.bags))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        bs = self.batch_size
        d = self.bags[0].features.shape[1] if self.bags else 0
        for start in range(0, len(order), bs):
            idx = order[start : start + bs]
            feats = np.zeros((bs, self.max_bag_size, d), np.float32)
            mask = np.zeros((bs, self.max_bag_size), bool)
            labels = np.zeros((bs,), np.int32)
            valid = np.zeros((bs,), np.float32)
            for j, i in enumerate(idx):
                bag = self.bags[int(i)]
                # no copy of a float32 bag (JAX's astype copies it)
                feats[j], mask[j] = pad_bag(
                    np.asarray(bag.features, np.float32), self.max_bag_size
                )
                labels[j] = bag.label
                valid[j] = 1.0
            yield feats, mask, labels, valid
