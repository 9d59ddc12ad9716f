"""Hierarchical multiscale patch extraction: slides → packed patch store.

Counterpart of the JAX package's ``data/extract.py``, with its semantics:
per-level patch sizes {0: 1792, 1: 896, 2: 448, 3: 224}, stride = patch
size unless given, white pad-to-grid, a cell is tumor iff a pixel of the
annotation mask lies in its window, the tissue filter keeps a cell whose
mean RGB is at most 240, the grid is walked in the reference's x-major
order, and a slide already in the level's manifest is skipped.

The host route streams bounded column bands: each band's patches are cut
from the level plane of a ``.wsi.npz``, decoded by one threaded native call
from a TIFF (``TiffSlide.read_regions``), or read with ``read_region``
from another slide; the labels come from
the annotation rasterized in full-width y-slabs one patch row tall
(``grid/rasterize.py::polygons_to_mask_band``, the port's numpy fill) and
any-pooled per window. ``impl="device"`` runs ``data/streamed.py`` on
``device`` for a level whose decoded plane fits ``band_budget_bytes``
(larger planes fall back to the host route with a warning, the JAX rule).
``stain_norm`` Macenko-normalizes the kept patches on ``device``
(``data/stain.py``) in chunks of at most :data:`STAIN_CHUNK_PIXELS` pixels.

The level's manifest is saved after each slide to
``data/manifest.py::level_manifest_path``: the JAX package's
``manifest.parquet`` where pyarrow imports, ``manifest.npz`` elsewhere (the
card's machine); whichever exists is read back, so the idempotent skip and
resume work there too. Slides are listed by ``io/download.py::list_slides``.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    PAD_FILL_VALUE,
    TISSUE_MEAN_RGB_THRESHOLD,
    DataConfig,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
    PatchManifest,
    PatchRecord,
    level_manifest_path,
    load_level_manifest,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.patch_store import (
    PackedPatchWriter,
    PngPatchWriter,
    require_pillow,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
    resolve_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.labeling import (
    LABEL_NORMAL,
    LABEL_TUMOR,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.pyramid import (
    PatchGrid,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.rasterize import (
    polygons_to_mask_band,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (  # noqa: F401 (SLIDE_EXTENSIONS: a public name here)
    SLIDE_EXTENSIONS,
    slide_name,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.annotations import (
    parse_annotation_xml,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.download import (
    list_slides,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
    Slide,
    open_slide,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    Timer,
    get_logger,
)

log = get_logger("data.extract")

#: Default per-band host-memory budget for decoded patches (one grid column
#: is the minimum band), and the plane budget of ``impl="device"``.
BAND_BUDGET_BYTES = 512 << 20

#: Pixels of one chunk of ``--stain_norm`` on the device (each image of a
#: chunk is computed on its own, so the chunking does not change a byte).
STAIN_CHUNK_PIXELS = 1 << 24


def annotation_path_for(data: DataConfig, name: str) -> str:
    return os.path.join(data.annotations_dir, f"{name}.xml")


def _load_polygons(xml_path: str) -> list[np.ndarray]:
    if not os.path.exists(xml_path):
        return []
    return parse_annotation_xml(xml_path)


def _band_columns(grid: PatchGrid, budget_bytes: int) -> int:
    """Grid columns per band under the patch-bytes budget (>= 1)."""
    per_col = grid.ny * grid.patch_size * grid.patch_size * 3
    return max(1, int(budget_bytes // max(per_col, 1)))


def _iter_column_bands(grid: PatchGrid, band_cols: int):
    """Yield (xs, coords) per band in the reference's x-major order (outer
    x, inner y)."""
    xs_all = [
        x for x in range(0, grid.padded_width, grid.stride) if x < grid.width
    ]
    ys = np.array(
        [y for y in range(0, grid.padded_height, grid.stride) if y < grid.height],
        np.int32,
    )
    for i in range(0, len(xs_all), band_cols):
        xs = xs_all[i : i + band_cols]
        coords = np.empty((len(xs) * len(ys), 2), np.int32)
        coords[:, 0] = np.repeat(np.asarray(xs, np.int32), len(ys))
        coords[:, 1] = np.tile(ys, len(xs))
        yield xs, coords


def _fetch_band(
    slide: Slide, grid: PatchGrid, coords: np.ndarray, num_threads: int
) -> np.ndarray:
    """One band of patches, white-padded to full size: sliced from the
    level plane where the slide holds it, else decoded in one threaded
    native call where the slide has ``read_regions`` (a TIFF), else read
    with ``read_region`` on ``num_threads`` threads."""
    ps = grid.patch_size
    if len(coords) == 0:
        return np.zeros((0, ps, ps, 3), np.uint8)

    level_array = getattr(slide, "level_array", None)
    if level_array is not None:
        arr = level_array(grid.level)
        out = np.full((len(coords), ps, ps, 3), PAD_FILL_VALUE, np.uint8)
        for i, (x, y) in enumerate(coords):
            w, h = grid.valid_patch_extent(int(x), int(y))
            out[i, :h, :w] = arr[y : y + h, x : x + w]
        return out

    read_regions = getattr(slide, "read_regions", None)
    if read_regions is not None:
        # the native threaded batch decode; out-of-bounds pixels come back white
        return read_regions(coords, grid.level, (ps, ps), num_threads=num_threads)

    def fetch(idx: int) -> np.ndarray:
        x, y = int(coords[idx, 0]), int(coords[idx, 1])
        w, h = grid.valid_patch_extent(x, y)
        region = slide.read_region(grid.level0_origin(x, y), grid.level, (w, h))
        if w < ps or h < ps:
            full = np.full((ps, ps, 3), PAD_FILL_VALUE, np.uint8)
            full[:h, :w] = region
            region = full
        return region

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        patches = list(pool.map(fetch, range(len(coords))))
    return np.stack(patches)


def _compute_label_grid(
    polygons: list[np.ndarray],
    base_dims: tuple[int, int],
    grid: PatchGrid,
) -> np.ndarray | None:
    """The (ny, nx) tumor/normal label grid of a whole level: the
    annotation rasterized in full-width y-slabs one patch row tall, each
    window any-pooled. A slab equals the crop of the full mask exactly, so
    peak mask memory is one slab. None without an annotation (all normal)."""
    if not polygons:
        return None
    W, H, ps = grid.width, grid.height, grid.patch_size
    ys = [y for y in range(0, grid.padded_height, grid.stride) if y < H]
    xs = np.array(
        [x for x in range(0, grid.padded_width, grid.stride) if x < W], np.int64
    )
    out = np.zeros((len(ys), len(xs)), np.int32)
    for gy, y in enumerate(ys):
        slab = polygons_to_mask_band(
            polygons, (W, H), base_dims, x0=0, y0=y, band_w=W,
            band_h=min(ps, H - y),
        )
        hit = slab.any(axis=0)
        cum = np.concatenate([[0], np.cumsum(hit, dtype=np.int64)])
        win_any = cum[np.minimum(xs + ps, W)] - cum[xs] > 0
        out[gy] = np.where(win_any, LABEL_TUMOR, LABEL_NORMAL)
    return out


def _stain_normalize(patches: np.ndarray, device: torch.device) -> np.ndarray:
    """Macenko-normalize a batch of stored patches on ``device``, in chunks
    of at most :data:`STAIN_CHUNK_PIXELS` pixels."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.stain import (
        macenko_normalize_batch,
    )

    per = max(1, STAIN_CHUNK_PIXELS // (patches.shape[1] * patches.shape[2]))
    out = np.empty_like(patches)
    for i in range(0, len(patches), per):
        chunk = torch.from_numpy(np.ascontiguousarray(patches[i:i + per]))
        out[i:i + per] = macenko_normalize_batch(chunk.to(device)).cpu().numpy()
    return out


def _extract_on_device(
    slide: Slide,
    grid: PatchGrid,
    polygons: list[np.ndarray],
    tissue_threshold: float,
    device: torch.device,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode the whole level plane and extract it on ``device``
    (``data/streamed.py``); the caller guards the plane budget."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.streamed import (
        extract_patches_on_device,
    )

    level_array = getattr(slide, "level_array", None)
    if level_array is not None:
        plane = level_array(grid.level)
    else:
        plane = slide.read_region(
            (0, 0), grid.level, slide.level_dimensions[grid.level]
        )
    return extract_patches_on_device(
        plane,
        grid,
        polygons,
        slide.level_dimensions[0],
        tissue_threshold=tissue_threshold,
        device=device,
    )


def extract_patches_for_slide(
    slide_path: str,
    xml_path: str,
    level: int,
    patches_dir: str,
    store_format: str = "packed",
    only_tumor: bool = False,
    stride: int | None = None,
    tissue_threshold: float = TISSUE_MEAN_RGB_THRESHOLD,
    num_threads: int = 8,
    impl: str = "host",
    band_budget_bytes: int = BAND_BUDGET_BYTES,
    stain_norm: bool = False,
    device: str | torch.device = "cuda",
) -> list[PatchRecord]:
    """Extract, label, filter and store the patches of one slide level;
    returns their records. ``only_tumor`` keeps tumor cells only. The host
    route streams column bands with bounded memory; ``impl="device"`` runs
    the device route on ``device`` for a stride == patch-size grid whose
    plane fits ``band_budget_bytes`` (a larger plane falls back to the host
    route with a warning). ``device`` also runs ``stain_norm``."""
    name = slide_name(os.path.basename(slide_path))
    slide = open_slide(slide_path)
    try:
        if level >= slide.level_count:
            log.warning("%s has no level %d; skipping", name, level)
            return []
        grid = PatchGrid.for_slide_level(
            level,
            slide.level_dimensions[level],
            slide.level_downsamples[level],
            stride=stride,
        )
        polygons = _load_polygons(xml_path)
        dev = (resolve_device(device) if impl == "device" or stain_norm
               else None)

        if store_format == "packed":
            writer = PackedPatchWriter(patches_dir, level, name, grid.patch_size)
        else:
            writer = PngPatchWriter(patches_dir, level, name)
        recs: list[PatchRecord] = []
        n_tumor = n_normal = 0

        def emit(patches, coords, labels):
            nonlocal n_tumor, n_normal
            if stain_norm and len(patches):
                patches = _stain_normalize(patches, dev)
            n_tumor += int((labels == LABEL_TUMOR).sum())
            n_normal += int((labels == LABEL_NORMAL).sum())
            if store_format == "packed":
                recs.extend(writer.write_batch(patches, coords, labels))
            else:
                recs.extend(
                    writer.write(
                        patches[i],
                        int(coords[i, 0]),
                        int(coords[i, 1]),
                        int(labels[i]),
                    )
                    for i in range(len(patches))
                )

        plane_bytes = grid.width * grid.height * 3
        if impl == "device" and grid.stride == grid.patch_size:
            if plane_bytes > band_budget_bytes:
                log.warning(
                    "%s level %d plane (%.1f GB) exceeds the device budget; "
                    "falling back to host band streaming",
                    name, level, plane_bytes / 2**30,
                )
            else:
                patches, coords, labels = _extract_on_device(
                    slide, grid, polygons, tissue_threshold, dev
                )
                if only_tumor:
                    sel = labels == LABEL_TUMOR
                    patches, coords, labels = patches[sel], coords[sel], labels[sel]
                emit(patches, coords, labels)
                writer.close()
                log.info(
                    "Patch extraction complete for %s at level %d (device): "
                    "%d patches (%d tumor / %d normal)",
                    name, level, len(recs), n_tumor, n_normal,
                )
                return recs

        label_grid = _compute_label_grid(
            polygons, slide.level_dimensions[0], grid
        )
        band_cols = _band_columns(grid, band_budget_bytes)
        for _xs, coords in _iter_column_bands(grid, band_cols):
            patches = _fetch_band(slide, grid, coords, num_threads)
            if len(patches) == 0:
                continue
            # labels BEFORE the tissue filter
            if label_grid is None:
                labels = np.full((len(coords),), LABEL_NORMAL, np.int32)
            else:
                labels = label_grid[
                    coords[:, 1] // grid.stride, coords[:, 0] // grid.stride
                ]
            means = patches.reshape(len(patches), -1).mean(axis=1)
            keep = means <= tissue_threshold
            if only_tumor:
                keep &= labels == LABEL_TUMOR
            if keep.any():
                emit(patches[keep], coords[keep], labels[keep])

        writer.close()
        log.info(
            "Patch extraction complete for %s at level %d: %d patches "
            "(%d tumor / %d normal)",
            name, level, len(recs), n_tumor, n_normal,
        )
        return recs
    finally:
        slide.close()


# ---------------------------------------------------------------------------
# Dataset-level extraction
# ---------------------------------------------------------------------------


def _slide_already_extracted(
    manifest: PatchManifest, patches_dir: str, level: int, name: str
) -> bool:
    """Idempotent skip: packed store by manifest membership, PNG store by
    a non-empty slide directory."""
    if any(r.slide == name for r in manifest):
        return True
    png_dir = os.path.join(patches_dir, f"level_{level}", name)
    return os.path.isdir(png_dir) and len(os.listdir(png_dir)) > 0


def extract_patches(
    data: DataConfig,
    level: int = 3,
    split: str = "train",
    only_tumor: bool = False,
    stride: int | None = None,
    store_format: str | None = None,
    slide_filter: Sequence[str] | None = None,
    impl: str = "host",
    band_budget_bytes: int = BAND_BUDGET_BYTES,
    stain_norm: bool = False,
    on_slide=None,
    device: str | torch.device = "cuda",
) -> PatchManifest:
    """Extract patches for every slide of a split at one level.

    Returns the (cumulative) manifest of the level, saved after each slide
    (parquet where pyarrow imports, else numpy). ``on_slide(name, records)``
    fires after each slide's store and manifest rows land (a slide already
    extracted fires with its existing rows): the streaming trainer's hook
    (``train/streaming.py``). A slide that fails is logged and the others
    go on. ``--store png`` without Pillow raises before any slide."""
    img_dir = data.train_img_dir if split == "train" else data.test_img_dir
    store_format = store_format or data.patch_store_format
    if store_format == "png":
        require_pillow()
    mpath = level_manifest_path(data.patches_dir, level)
    manifest = load_level_manifest(data.patches_dir, level)

    slides = list_slides(img_dir)
    if slide_filter is not None:
        wanted = set(slide_filter)
        slides = [(n, p) for n, p in slides if n in wanted]
    if not slides:
        log.warning("No slides found in %s", img_dir)
        return manifest

    log.info("Extracting patches at level %d from %d slides...", level, len(slides))
    for name, path in slides:
        if _slide_already_extracted(manifest, data.patches_dir, level, name):
            log.info("Patches for %s already extracted, skipping.", name)
            if on_slide is not None:
                on_slide(name, [r for r in manifest if r.slide == name])
            continue
        try:
            with Timer(f"extract[{name} L{level}]", log):
                recs = extract_patches_for_slide(
                    path,
                    annotation_path_for(data, name),
                    level,
                    data.patches_dir,
                    store_format=store_format,
                    only_tumor=only_tumor,
                    stride=stride,
                    impl=impl,
                    band_budget_bytes=band_budget_bytes,
                    stain_norm=stain_norm,
                    device=device,
                )
        except Exception as e:  # one bad slide must not stop the run
            log.error("Could not process %s: %s", path, e)
            continue
        manifest.extend(recs)
        manifest.save(mpath)
        if on_slide is not None:
            on_slide(name, recs)
    return manifest
