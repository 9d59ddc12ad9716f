"""Patch stores: the packed store's writer, the reference's PNG writer and
a random-access reader.

Copy of the JAX package's ``data/patch_store.py`` (``PngPatchWriter``,
``PackedPatchWriter``, ``PatchReader``, ``resize_batch``), held to it by
exact tests. A packed store appends raw
(N, P, P, 3) uint8 patches to ``patches/level_{L}/{slide}.pack`` with the
shape in a ``.shape`` sidecar, and is read back through a memmap with no
decoding. The PNG store (``--store png``) writes one file per patch with
Pillow, which the card's machine lacks: there the writer raises at once
(:func:`require_pillow`).

Packed rows are gathered as the JAX package gathers them, by the native
OpenMP ``gather_rows`` of ``io/native_lib.py`` (one call a pack file), and
with ``s2d=True`` and no resize by its ``gather_rows_s2d``, which writes the
int8 stem's space-to-depth layout during the gather.

Differences from the JAX module, none in the bytes read:

- PNG records (Pillow) import their library when they are read, and
  raise where it is missing;
- a downscale by an integer factor f ∈ {2, 3, 4, 8} (both sides of the
  stored patch f × the edge) is a numpy box mean, equal bit for bit to cv2's
  ``INTER_AREA`` (:func:`area_downscale`); any other resize imports cv2
  when it is read, and raises where cv2 is missing.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
    LABEL_NAMES,
    PatchManifest,
    PatchRecord,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.native_lib import (
    gather_rows,
    gather_rows_s2d,
    space_to_depth_u8,
)


def require_pillow() -> None:
    """Raise a clear error where Pillow, which writes the PNG store, is
    missing."""
    try:
        import PIL.Image  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "--store png writes one PNG a patch with Pillow, which is not "
            "installed here; use --store packed") from e


class PngPatchWriter:
    """Writes the reference's one-PNG-per-patch layout
    (``patches/level_{L}/{slide}/{slide}_x{x}_y{y}_{label}.png``)."""

    def __init__(self, patches_dir: str, level: int, slide: str):
        require_pillow()
        self.level = level
        self.slide = slide
        self.dir = os.path.join(patches_dir, f"level_{level}", slide)
        os.makedirs(self.dir, exist_ok=True)

    def write(self, patch: np.ndarray, x: int, y: int, label: int) -> PatchRecord:
        from PIL import Image

        name = f"{self.slide}_x{x}_y{y}_{LABEL_NAMES[label]}.png"
        path = os.path.join(self.dir, name)
        if not os.path.exists(path):  # idempotent
            Image.fromarray(patch).save(path)
        return PatchRecord(
            slide=self.slide, level=self.level, x=x, y=y,
            label=label, store="png", path=path,
        )

    def close(self) -> None:
        pass


class PackedPatchWriter:
    """Appends patches to ``patches/level_{L}/{slide}.pack`` as raw
    (N, P, P, 3) uint8; shape goes in a sidecar ``.shape`` file."""

    def __init__(self, patches_dir: str, level: int, slide: str, patch_size: int):
        self.level = level
        self.slide = slide
        self.patch_size = patch_size
        level_dir = os.path.join(patches_dir, f"level_{level}")
        os.makedirs(level_dir, exist_ok=True)
        self.path = os.path.join(level_dir, f"{slide}.pack")
        self._f = open(self.path, "wb")
        self._count = 0

    def write(self, patch: np.ndarray, x: int, y: int, label: int) -> PatchRecord:
        patch = np.ascontiguousarray(patch, dtype=np.uint8)
        expected = (self.patch_size, self.patch_size, 3)
        if patch.shape != expected:
            raise ValueError(f"patch shape {patch.shape} != {expected}")
        self._f.write(patch.tobytes())
        rec = PatchRecord(
            slide=self.slide, level=self.level, x=x, y=y,
            label=label, store="packed", path=self.path, row=self._count,
        )
        self._count += 1
        return rec

    def write_batch(
        self, patches: np.ndarray, coords: np.ndarray, labels: np.ndarray
    ) -> list[PatchRecord]:
        """Vectorized append of (N, P, P, 3) patches with (N, 2) coords."""
        patches = np.ascontiguousarray(patches, dtype=np.uint8)
        self._f.write(patches.tobytes())
        recs = [
            PatchRecord(
                slide=self.slide, level=self.level,
                x=int(coords[i, 0]), y=int(coords[i, 1]),
                label=int(labels[i]), store="packed",
                path=self.path, row=self._count + i,
            )
            for i in range(len(patches))
        ]
        self._count += len(patches)
        return recs

    def close(self) -> None:
        self._f.close()
        with open(self.path + ".shape", "w") as f:
            f.write(f"{self._count} {self.patch_size} {self.patch_size} 3\n")
        if self._count == 0:
            os.remove(self.path)
            os.remove(self.path + ".shape")


class PatchReader:
    """Random-access reader over a manifest, transparent to store format.

    Packed files are memmapped once and cached; PNG records decode via PIL.
    ``read_batch`` optionally resizes to a target edge.
    """

    def __init__(self, manifest: PatchManifest):
        self.manifest = manifest
        self._mmaps: dict[str, np.ndarray] = {}

    def _mmap(self, path: str) -> np.ndarray:
        mm = self._mmaps.get(path)
        if mm is None:
            with open(path + ".shape") as f:
                shape = tuple(int(v) for v in f.read().split())
            mm = np.memmap(path, dtype=np.uint8, mode="r", shape=shape)
            self._mmaps[path] = mm
        return mm

    def read(self, index: int) -> np.ndarray:
        rec = self.manifest[index]
        if rec.store == "packed":
            return np.asarray(self._mmap(rec.path)[rec.row])
        from PIL import Image

        with Image.open(rec.path) as im:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)

    def read_batch(
        self, indices: Sequence[int], resize_to: int | None = None,
        s2d: bool = False,
    ) -> np.ndarray:
        """(B, H, W, 3) uint8 batch of ``indices``; the packed rows of each
        pack file come in one native gather. ``s2d=True`` gives the stem's
        space-to-depth layout (B, H/2, W/2, 12) instead, which feeds the
        int8 forward with no transpose on the device; the gather writes it
        directly where every row has one size and no resize follows."""
        indices = [int(i) for i in indices]
        recs = [self.manifest[i] for i in indices]
        if recs and all(r.store == "packed" for r in recs):
            by_path: dict[str, list[int]] = {}
            for pos, r in enumerate(recs):
                by_path.setdefault(r.path, []).append(pos)
            stores = {path: self._mmap(path) for path in by_path}
            shapes = {mm.shape[1:] for mm in stores.values()}
            direct = s2d and len(shapes) == 1 and resize_to in (
                None, next(iter(shapes))[0])
            gather = gather_rows_s2d if direct else gather_rows
            parts = [(positions, gather(stores[path], np.array(
                [recs[p].row for p in positions], np.int64)))
                for path, positions in by_path.items()]
            if len(parts) == 1:
                imgs = parts[0][1]  # already the batch, in order: one copy
            elif len({g.shape[1:] for _, g in parts}) == 1:
                imgs = np.empty((len(recs),) + parts[0][1].shape[1:], np.uint8)
                for positions, gathered in parts:
                    imgs[positions] = gathered
            else:  # packs of different patch sizes: resized below
                imgs = [None] * len(recs)
                for positions, gathered in parts:
                    for j, p in enumerate(positions):
                        imgs[p] = gathered[j]
            if direct:
                return imgs
        else:
            imgs = [self.read(i) for i in indices]
        if resize_to is not None and isinstance(imgs, np.ndarray):
            imgs = resize_batch(imgs, resize_to)
        elif resize_to is not None and any(
                img.shape[:2] != (resize_to, resize_to) for img in imgs):
            imgs = [_resize(img, resize_to) for img in imgs]
        batch = imgs if isinstance(imgs, np.ndarray) else np.stack(imgs)
        return space_to_depth_u8(batch) if s2d else batch


#: integer downscale factors that :func:`area_downscale` takes without cv2
AREA_FACTORS = (2, 3, 4, 8)


def area_factor(h: int, w: int, edge: int) -> int | None:
    """The factor f of an (h, w) → (edge, edge) resize when it is one of
    :data:`AREA_FACTORS` on both sides, else None."""
    for f in AREA_FACTORS:
        if h == w == f * edge:
            return f
    return None


def area_downscale(batch: np.ndarray, f: int) -> np.ndarray:
    """(B, f·e, f·e, C) uint8 → (B, e, e, C): the mean of each f × f block,
    rounded as cv2's ``INTER_AREA`` rounds it, so that the bytes equal
    ``cv2.resize(img, (e, e), interpolation=cv2.INTER_AREA)``.

    With ``s`` the block's integer sum, cv2 rounds half up at f = 2 (its
    integer fast path, ``(s + 2) >> 2``) and half to even at 4 and 8 (its
    float path, exact there: 1/16 and 1/64 are powers of two); s/9 is never
    a tie. The sums run in uint16 (64 · 255 fits), rows first as whole
    contiguous rows, then columns; s / f² is exact in float32."""
    b, h, w, c = batch.shape
    if f not in AREA_FACTORS or h % f or w % f:
        raise ValueError(f"no box mean of {h}×{w} by {f}")
    eh, ew = h // f, w // f
    rows = batch.reshape(b, eh, f, w * c)
    s = rows[:, :, 0].astype(np.uint16)
    for i in range(1, f):
        s += rows[:, :, i]
    cols = s.reshape(b, eh, ew, f * c)
    s = cols[..., :c].copy()
    for j in range(1, f):
        s += cols[..., j * c:(j + 1) * c]
    if f == 2:
        return ((s + 2) >> 2).astype(np.uint8)
    return np.rint(s / np.float32(f * f)).astype(np.uint8)


def _resize(img: np.ndarray, edge: int) -> np.ndarray:
    if img.shape[0] == edge and img.shape[1] == edge:
        return img
    f = area_factor(img.shape[0], img.shape[1], edge)
    if f is not None:
        return area_downscale(img[None], f)[0]
    import cv2

    return cv2.resize(img, (edge, edge), interpolation=cv2.INTER_AREA)


def resize_batch(batch: np.ndarray, edge: int) -> np.ndarray:
    """Resize an already-read (B, H, W, 3) uint8 batch in memory, for
    callers that only learn the stored size after the gather (no second
    read just to change resolution)."""
    if batch.shape[1] == edge and batch.shape[2] == edge:
        return batch
    f = area_factor(batch.shape[1], batch.shape[2], edge)
    if f is not None:
        return area_downscale(batch, f)
    return np.stack([_resize(img, edge) for img in batch])
