"""Inputs made from a seed: a level-3 tissue plane, slides cut from it, and
a packed store of labelled patches.

A plane is white glass with elliptical tissue blobs of pink, noise-textured
stain; some blobs hold a tumor region with a wobbly outline, tinted darker
purple (the colours of the program's synthetic slides). Everything is drawn
on ``device`` from one ``torch.Generator`` in a few large calls, then
copied to the host once. The same seed on the same kind of device gives the
same bytes.

The slides of the slide cell are windows of one plane (:class:`PlaneSlide`
reads a window without copying the plane). The patch store is written once
per temporary directory under a name that holds everything it is made
from, and read back by the program's own packed-store reader.
"""

from __future__ import annotations

import hashlib
import json
import math
import os

import numpy as np
import torch

WHITE = 255
TISSUE_RGB = (205.0, 160.0, 190.0)
TUMOR_RGB = (150.0, 90.0, 160.0)
NOISE = 8.0
#: mask resolution: one mask value per MASK_STEP² pixels
MASK_STEP = 4
#: a slide window's left edge, in pixels (3 bytes each): 64-byte aligned
ALIGN = 64
#: bump when the way a plane or store is drawn changes
VERSION = 1


def sub_seed(seed: int, k: int) -> int:
    """The ``k``-th seed derived from a run's seed (below 2**63)."""
    return int(np.random.SeedSequence([int(seed), k]).generate_state(
        1, np.uint64)[0] >> 1)


def _masks(g: torch.Generator, h: int, w: int, blobs: int,
           radius: tuple[float, float], tumor_share: float, device):
    """(tissue, tumor) bool masks at 1/MASK_STEP resolution."""
    hm, wm = -(-h // MASK_STEP), -(-w // MASK_STEP)
    u = torch.rand(blobs, 9, generator=g, device=device, dtype=torch.float64)
    cy, cx = u[:, 0] * hm, u[:, 1] * wm
    short = min(hm, wm)
    ry = (radius[0] + (radius[1] - radius[0]) * u[:, 2]) * short
    rx = ry * (0.7 + 0.6 * u[:, 3])
    has_tumor = u[:, 4] < tumor_share
    t_scale = 0.3 + 0.3 * u[:, 5]
    phase = u[:, 6] * 2 * math.pi
    wobble = 0.1 + 0.15 * u[:, 7]
    lobes = 2 + (u[:, 8] * 4).floor()
    yy = torch.arange(hm, device=device, dtype=torch.float64)[:, None]
    xx = torch.arange(wm, device=device, dtype=torch.float64)[None, :]
    tissue = torch.zeros(hm, wm, dtype=torch.bool, device=device)
    tumor = torch.zeros_like(tissue)
    for i in range(blobs):
        dy, dx = (yy - cy[i]) / ry[i], (xx - cx[i]) / rx[i]
        r2 = dy * dy + dx * dx
        tissue |= r2 <= 1.0
        if bool(has_tumor[i]):
            theta = torch.atan2(dy, dx)
            edge = t_scale[i] * (1 + wobble[i] * torch.sin(lobes[i] * theta
                                                           + phase[i]))
            tumor |= r2 <= edge * edge
    return tissue, tumor & tissue


def make_plane(seed: int, height: int, width: int, blobs: int,
               radius: tuple[float, float], tumor_share: float,
               device) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(plane uint8 (H, W, 3) on the host, tissue mask, tumor mask), the
    masks bool at 1/MASK_STEP resolution on the host."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    tissue, tumor = _masks(g, height, width, blobs, radius, tumor_share, dev)
    cls = tissue.to(torch.uint8) + tumor.to(torch.uint8)  # 0, 1, 2
    cls = cls.repeat_interleave(MASK_STEP, 0).repeat_interleave(MASK_STEP, 1)
    cls = cls[:height, :width]
    colours = torch.tensor([(WHITE,) * 3, TISSUE_RGB, TUMOR_RGB],
                           dtype=torch.float32, device=dev)
    plane = torch.empty(height, width, 3, dtype=torch.uint8, device=dev)
    band = max(1, (1 << 26) // (width * 3))  # ~256 MB of float32 a band
    for y in range(0, height, band):
        c = cls[y:y + band].long()
        noise = torch.randn(c.shape[0], width, 3, generator=g, device=dev)
        px = colours[c] + noise * NOISE * (c > 0)[..., None]
        plane[y:y + band] = px.round_().clamp_(0, 255).to(torch.uint8)
    return plane.cpu().numpy(), tissue.cpu().numpy(), tumor.cpu().numpy()


class PlaneSlide:
    """A slide whose level 3 is the window (x0, y0, w, h) of a plane, in the
    program's slide protocol (OpenSlide coordinates, out-of-bounds white).
    Levels 0–2 have the sizes a pyramid would give and are never read."""

    LEVEL = 3

    def __init__(self, plane: np.ndarray, x0: int, y0: int, w: int, h: int):
        self._plane, self._x0, self._y0 = plane, x0, y0
        self._w, self._h = w, h

    @property
    def level_count(self) -> int:
        return self.LEVEL + 1

    @property
    def level_dimensions(self) -> list[tuple[int, int]]:
        return [(self._w << (self.LEVEL - lv), self._h << (self.LEVEL - lv))
                for lv in range(self.LEVEL + 1)]

    @property
    def level_downsamples(self) -> list[float]:
        return [float(1 << lv) for lv in range(self.LEVEL + 1)]

    def window(self) -> np.ndarray:
        """The level-3 plane of the slide, a view."""
        return self._plane[self._y0:self._y0 + self._h,
                           self._x0:self._x0 + self._w]

    def read_region(self, location, level: int, size) -> np.ndarray:
        if level != self.LEVEL:
            raise ValueError(f"only level {self.LEVEL} is held, not {level}")
        ds = 1 << self.LEVEL
        x, y = int(location[0] / ds), int(location[1] / ds)
        w, h = int(size[0]), int(size[1])
        out = np.full((h, w, 3), WHITE, np.uint8)
        x1, y1 = max(x, 0), max(y, 0)
        x2, y2 = min(x + w, self._w), min(y + h, self._h)
        if x2 > x1 and y2 > y1:
            out[y1 - y:y2 - y, x1 - x:x2 - x] = self.window()[y1:y2, x1:x2]
        return out

    def close(self) -> None:
        pass


def slide_sizes(height: int, width: int, count: int,
                area: tuple[float, float]) -> list[tuple[int, int]]:
    """``count`` (w, h) slide sizes whose areas are evenly spaced over
    ``area`` (shares of the whole plane), each of the plane's aspect."""
    out = []
    for i in range(count):
        a = area[0] + (area[1] - area[0]) * (i + 0.5) / count
        s = math.sqrt(a)
        out.append((max(1, round(width * s)), max(1, round(height * s))))
    return out


def slide_windows(seed: int, sizes, height: int, width: int,
                  cycles: int) -> list[tuple[int, int, int, int]]:
    """``cycles`` rounds of every size, each round in its own order drawn
    from the seed, each slide at a window origin drawn from the seed:
    (x0, y0, w, h) in the order the closed loop sends them. ``x0`` is a
    multiple of :data:`ALIGN` pixels, so that a band read starts on a
    64-byte boundary of the plane's rows, as a decoded slide's bands do."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 1]))
    out = []
    for _ in range(cycles):
        for i in rng.permutation(len(sizes)):
            w, h = sizes[i]
            x0 = ALIGN * int(rng.integers(0, (width - w) // ALIGN + 1))
            out.append((x0, int(rng.integers(0, height - h + 1)), w, h))
    return out


def tissue_cells(plane: np.ndarray, tissue: np.ndarray, tumor: np.ndarray,
                 count: int, size: int, seed: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """``count`` size² cells of the plane drawn from the seed, half centred
    on tumor and half on other tissue (all on tissue where the plane has no
    tumor), and whether each centre is tumor."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 2]))
    h, w = plane.shape[:2]
    half = size // 2 // MASK_STEP
    inner = np.zeros_like(tissue)
    inner[half:tissue.shape[0] - half, half:tissue.shape[1] - half] = True
    tum = np.flatnonzero((tumor & inner).ravel())
    other = np.flatnonzero((tissue & ~tumor & inner).ravel())
    n_tum = count // 2 if len(tum) else 0
    idx = np.concatenate([
        rng.choice(tum, size=n_tum, replace=len(tum) < n_tum),
        rng.choice(other, size=count - n_tum,
                   replace=len(other) < count - n_tum)])
    cy, cx = np.divmod(idx, tissue.shape[1])
    y0 = np.clip(cy * MASK_STEP - size // 2, 0, h - size)
    x0 = np.clip(cx * MASK_STEP - size // 2, 0, w - size)
    cells = np.stack([plane[y:y + size, x:x + size] for y, x in zip(y0, x0)])
    return cells, tumor.ravel()[idx]


# ---------------------------------------------------------------------------
# Patch store
# ---------------------------------------------------------------------------


def store_key(spec: dict, device_type: str) -> str:
    text = json.dumps({"spec": spec, "device": device_type,
                       "version": VERSION}, sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def _store_draw(spec: dict, device) -> tuple[np.ndarray, np.ndarray]:
    """(patches uint8 (n, s, s, 3), labels int64 (n,)) of a store ``spec``:
    patches of ``size``² centred on tissue pixels of a plane of its own,
    ``tumor_share`` of them on tumor pixels (label 1)."""
    n, size = int(spec["patches"]), int(spec["size"])
    plane, tissue, tumor = make_plane(
        spec["seed"], spec["height"], spec["width"], spec["blobs"],
        tuple(spec["radius"]), spec["tumor_blob_share"], device)
    rng = np.random.default_rng(np.random.SeedSequence([int(spec["seed"]), 3]))
    half = size // 2 // MASK_STEP
    inner = np.zeros_like(tissue)
    inner[half:tissue.shape[0] - half, half:tissue.shape[1] - half] = True
    tum = np.flatnonzero((tumor & inner).ravel())
    nor = np.flatnonzero((tissue & ~tumor & inner).ravel())
    n_tum = int(round(n * float(spec["tumor_share"])))
    labels = np.zeros(n, np.int64)
    labels[:n_tum] = 1
    rng.shuffle(labels)
    idx = np.empty(n, np.int64)
    idx[labels == 1] = rng.choice(tum, size=n_tum, replace=len(tum) < n_tum)
    idx[labels == 0] = rng.choice(nor, size=n - n_tum,
                                  replace=len(nor) < n - n_tum)
    cy, cx = np.divmod(idx, tissue.shape[1])
    h, w = plane.shape[:2]
    y0 = np.clip(cy * MASK_STEP - size // 2, 0, h - size)
    x0 = np.clip(cx * MASK_STEP - size // 2, 0, w - size)
    win = np.lib.stride_tricks.sliding_window_view(plane, (size, size),
                                                   axis=(0, 1))
    patches = np.ascontiguousarray(
        win[y0, x0].transpose(0, 2, 3, 1))  # (n, 3, s, s) → (n, s, s, 3)
    return patches, labels


def patch_store(spec: dict, directory: str, device) -> tuple[str, np.ndarray]:
    """The packed store of ``spec`` under ``directory``: (path of the
    ``.pack`` file with its ``.shape`` sidecar, labels). Written on first use
    into a private name renamed into place; a later call finds it."""
    dev = torch.device(device)
    key = store_key(spec, dev.type)
    folder = os.path.join(directory, f"store-{key}")
    path = os.path.join(folder, "patches.pack")
    labels_path = os.path.join(folder, "labels.npy")
    if os.path.exists(labels_path):
        return path, np.load(labels_path)
    patches, labels = _store_draw(spec, dev)
    tmp = folder + f".part{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    patches.tofile(os.path.join(tmp, "patches.pack"))
    with open(os.path.join(tmp, "patches.pack.shape"), "w") as f:
        f.write(" ".join(str(v) for v in patches.shape) + "\n")
    np.save(os.path.join(tmp, "labels.npy"), labels)
    os.replace(tmp, folder)
    return path, labels


def read_store(path: str) -> np.ndarray:
    """The store's rows, (n, s, s, 3) uint8, memory-mapped."""
    with open(path + ".shape") as f:
        shape = tuple(int(v) for v in f.read().split())
    return np.memmap(path, dtype=np.uint8, mode="r", shape=shape)
