"""Synthetic tissue slides with tumor polygons, rendered with numpy alone.

Copy of the JAX package's ``io/synthetic.py`` renderer: a white canvas with
an elliptical, noise-textured pink tissue blob, zero or more tumor polygons
tinted darker (``"tint"``) or carrying a zero-mean checkerboard
(``"texture"``), and a 2× box-averaged pyramid. Slides without polygons
equal the JAX package's byte for byte. The JAX package fills the polygons
with PIL, which the card's machine lacks; here the numpy fill of
``grid/rasterize.py`` does it, at the same fractional vertices, and the two
renders differ only in pixels within a pixel and a half of a polygon edge
(the tests count them).

:func:`write_synthetic_case` writes a slide and its annotation XML into the
reference layout, as ``.wsi.npz`` or as a tiled BigTIFF (``container=
"tiff"``, any compression of ``io/tiff_slide.py``; ``jpeg_ycbcr`` is the
CAMELYON16 encoding). :func:`write_giant_synthetic_slide` streams a slide of
any size, up to CAMELYON16's 97792×221184, to a BigTIFF in row bands
without holding a level. :func:`write_mask_npy` and :func:`write_mask_tiff`
write a tumor case's ground truth where the FROC evaluation reads it:
``<mask_dir>/<case>_mask.npy``, the polygons rasterized at the evaluation
level, or ``<case>_Mask.tif``, a pyramid of the polygons rasterized at
every level down to it, as CAMELYON16 ships its masks.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    EVALUATION_MASK_LEVEL,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.rasterize import (
    fill_polygons,
    polygons_to_mask,
    polygons_to_mask_band,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.annotations import (
    write_annotation_xml,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
    ArraySlide,
    save_npz_slide,
)


@dataclasses.dataclass
class SyntheticSlideSpec:
    """Procedural slide description: the level-0 canvas is white, with an
    elliptical tissue blob whose mean RGB is well under the tissue
    threshold, and tumor polygons inside it."""

    width: int = 1024
    height: int = 768
    num_levels: int = 4
    tissue_center: tuple[float, float] = (0.5, 0.5)  # fraction of (w, h)
    tissue_radii: tuple[float, float] = (0.38, 0.4)  # fraction of (w, h)
    tumor_polygons: tuple[tuple[tuple[float, float], ...], ...] = ()
    #: fractional (x, y) vertices; empty tuple = normal slide
    seed: int = 0
    noise: float = 8.0
    #: "tint": the tumor is a flat darker-purple shift, separable at every
    #: level; "texture": the tissue's mean colour with a zero-mean 4-px
    #: checkerboard (± ``texture_amp``) that level 3 averages to exactly 0
    tumor_style: str = "tint"
    texture_amp: float = 20.0


def _default_tumor_polygon() -> tuple[tuple[float, float], ...]:
    return ((0.40, 0.35), (0.62, 0.38), (0.65, 0.58), (0.45, 0.62), (0.38, 0.5))


def tumor_spec(**kw) -> SyntheticSlideSpec:
    kw.setdefault("tumor_polygons", (_default_tumor_polygon(),))
    return SyntheticSlideSpec(**kw)


def normal_spec(**kw) -> SyntheticSlideSpec:
    return SyntheticSlideSpec(**kw)


def polygons_level0(spec: SyntheticSlideSpec) -> list[np.ndarray]:
    """The spec's tumor polygons in level-0 pixels, (K, 2) float64 each."""
    w, h = spec.width, spec.height
    return [np.array([(px * w, py * h) for px, py in poly], dtype=np.float64)
            for poly in spec.tumor_polygons]


def make_level0(spec: SyntheticSlideSpec) -> tuple[np.ndarray, list[np.ndarray]]:
    """Render the level-0 image; returns (image, tumor_polygons_level0)."""
    rng = np.random.default_rng(spec.seed)
    h, w = spec.height, spec.width
    img = np.full((h, w, 3), 255, dtype=np.float32)

    yy, xx = np.mgrid[0:h, 0:w]
    cx, cy = spec.tissue_center[0] * w, spec.tissue_center[1] * h
    rx, ry = spec.tissue_radii[0] * w, spec.tissue_radii[1] * h
    tissue = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1.0

    # pink-ish H&E-looking base with per-pixel noise
    base = np.array([205.0, 160.0, 190.0])
    tex = rng.normal(0.0, spec.noise, size=(h, w, 3)).astype(np.float32)
    img[tissue] = base[None, :] + tex[tissue]

    polys = polygons_level0(spec)
    for poly_px in polys:
        mm = fill_polygons([poly_px], w, h)
        if spec.tumor_style == "texture":
            # zero-mean checkerboard, 4-px cells aligned to the level-0
            # grid so pyramid box-averaging cancels it exactly at level 3
            checker = (((xx // 4) + (yy // 4)) % 2).astype(np.float32)
            checker = (checker * 2.0 - 1.0) * spec.texture_amp
            img[mm] = base[None, :] + checker[mm, None] + tex[mm]
        else:
            img[mm] = np.array([150.0, 90.0, 160.0])[None, :] + tex[mm]

    np.clip(img, 0, 255, out=img)
    return img.astype(np.uint8), polys


def build_pyramid(level0: np.ndarray, num_levels: int) -> list[np.ndarray]:
    """2x-downsample pyramid by box averaging (each level halves both dims)."""
    levels = [level0]
    cur = level0.astype(np.float32)
    for _ in range(1, num_levels):
        h, w = cur.shape[:2]
        h2, w2 = h // 2, w // 2
        cur = cur[: h2 * 2, : w2 * 2]
        cur = cur.reshape(h2, 2, w2, 2, 3).mean(axis=(1, 3))
        levels.append(np.clip(cur, 0, 255).astype(np.uint8))
    return levels


def make_synthetic_slide(spec: SyntheticSlideSpec | None = None) -> ArraySlide:
    """Build an in-memory synthetic slide (its tumor polygons in level-0
    pixels are :func:`polygons_level0` of the spec)."""
    spec = spec or SyntheticSlideSpec()
    level0, _ = make_level0(spec)
    return ArraySlide(build_pyramid(level0, spec.num_levels))


def write_synthetic_case(
    data_dir: str,
    name: str,
    spec: SyntheticSlideSpec | None = None,
    split: str = "train",
    container: str = "npz",
    compression: str = "deflate",
) -> str:
    """Write a synthetic slide (and the annotation XML of its tumor
    polygons, if it has any) into the reference layout:
    ``{data_dir}/{split}/img/{name}.<ext>`` and
    ``{data_dir}/annotations/{name}.xml``.

    ``container="tiff"`` writes a tiled BigTIFF of ``compression``;
    ``"jpeg_ycbcr"`` there is the CAMELYON16 encoding, so the real slides'
    decode path runs on a fixture. Returns the slide path."""
    if container not in ("npz", "tiff"):
        raise ValueError(f"unknown container {container}")
    spec = spec or SyntheticSlideSpec()
    level0, polys = make_level0(spec)
    levels = build_pyramid(level0, spec.num_levels)
    img_dir = os.path.join(data_dir, split, "img")
    os.makedirs(img_dir, exist_ok=True)
    if container == "npz":
        slide_path = os.path.join(img_dir, f"{name}.wsi.npz")
        save_npz_slide(slide_path, levels)
    else:
        from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.tiff_slide import (
            write_pyramidal_tiff,
        )

        slide_path = os.path.join(img_dir, f"{name}.tif")
        write_pyramidal_tiff(slide_path, levels, compression=compression)
    if polys:
        write_annotation_xml(os.path.join(data_dir, "annotations", f"{name}.xml"),
                             polys)
    return slide_path


def write_giant_synthetic_slide(
    slide_path: str,
    spec: SyntheticSlideSpec | None = None,
    xml_path: str | None = None,
    tile_size: int = 512,
    compression: str = "jpeg",
    target_band_px: int = 48_000_000,
) -> None:
    """Stream a full-scale synthetic slide to a tiled BigTIFF.

    The JAX package's function, which renders each level in row bands of
    about ``target_band_px`` pixels (the tissue ellipse analytically, the
    tumor polygons by the band rasterizer, a 256² noise texture tiled from
    each band's first row) and appends them through
    :class:`~ss25_hierarchical_multiscale_image_classification_tpu_torch.io.tiff_slide.StreamingPyramidWriter`,
    so that no level is ever held in memory. A pixel's value depends only
    on its class (background, tissue, tumor) and its place in the texture,
    so the two textured colours are computed once as uint8 tiles and each
    band is assembled from them in uint8: the same bytes as the JAX
    package's float32 band, for less work. The default spec is the
    97792×221184 canonical CAMELYON16 slide."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.tiff_slide import (
        StreamingPyramidWriter,
    )

    spec = spec or SyntheticSlideSpec(width=97792, height=221184)
    w0, h0 = spec.width, spec.height
    polys_l0 = polygons_level0(spec)

    rng = np.random.default_rng(spec.seed)
    ntile = 256
    noise_tile = rng.normal(0.0, spec.noise, (ntile, ntile, 3)).astype(np.float32)
    # base + noise clipped and truncated, as the float32 band is
    tissue_tile, tumor_tile = (
        np.clip(np.array(base, np.float32) + noise_tile, 0, 255).astype(np.uint8)
        for base in ((205.0, 160.0, 190.0), (150.0, 90.0, 160.0)))

    with StreamingPyramidWriter(slide_path, tile_size=tile_size,
                                compression=compression) as wr:
        for lvl in range(spec.num_levels):
            w = max(1, w0 >> lvl)
            h = max(1, h0 >> lvl)
            wr.begin_level(w, h)
            band_rows = max(
                tile_size, (target_band_px // max(w, 1)) // tile_size * tile_size
            )
            cx, cy = spec.tissue_center[0] * w, spec.tissue_center[1] * h
            rx, ry = spec.tissue_radii[0] * w, spec.tissue_radii[1] * h
            xs = np.arange(w, dtype=np.float32)
            x_term = ((xs - cx) / rx) ** 2  # (w,)
            reps = (-(-band_rows // ntile), -(-w // ntile), 1)
            tissue_band = np.tile(tissue_tile, reps)
            tumor_band = np.tile(tumor_tile, reps) if polys_l0 else None
            for y0 in range(0, h, band_rows):
                rows = min(band_rows, h - y0)
                ys = np.arange(y0, y0 + rows, dtype=np.float32)
                y_term = ((ys - cy) / ry) ** 2  # (rows,)
                tissue = (y_term[:, None] + x_term[None, :]) <= 1.0
                img = np.full((rows, w, 3), 255, np.uint8)
                # x_term falls, then rises, and float rounding keeps that
                # order: a row's tissue is one run of columns
                first, count = tissue.argmax(axis=1), tissue.sum(axis=1)
                for r in np.flatnonzero(count):
                    a, b = first[r], first[r] + count[r]
                    img[r, a:b] = tissue_band[r, a:b]
                if polys_l0:
                    tumor = polygons_to_mask_band(
                        polys_l0, (w, h), (w0, h0), x0=0, y0=y0,
                        band_w=w, band_h=rows,
                    ) > 0
                    ty, tx = np.flatnonzero(tumor.any(1)), np.flatnonzero(
                        tumor.any(0))
                    if len(ty):
                        box = np.s_[ty[0]:ty[-1] + 1, tx[0]:tx[-1] + 1]
                        np.copyto(img[box], tumor_band[:rows, :w][box],
                                  where=tumor[box][:, :, None])
                wr.write_band(img)
            wr.end_level()

    if polys_l0 and xml_path:
        write_annotation_xml(xml_path, polys_l0)


def write_mask_npy(mask_dir: str, case: str, spec: SyntheticSlideSpec,
                   level: int = EVALUATION_MASK_LEVEL) -> str:
    """Write the spec's tumor polygons rasterized at ``level`` (0/255 uint8,
    (H, W) of that level of a 2× pyramid) to ``<mask_dir>/<case>_mask.npy``,
    the ground truth ``evaluation/froc.py::run_froc_evaluation`` reads;
    returns the path."""
    dims = (max(1, spec.width >> level), max(1, spec.height >> level))
    mask = polygons_to_mask(polygons_level0(spec), dims,
                            (spec.width, spec.height))
    os.makedirs(mask_dir, exist_ok=True)
    path = os.path.join(mask_dir, f"{case}_mask.npy")
    np.save(path, mask)
    return path


def write_mask_tiff(mask_dir: str, case: str, spec: SyntheticSlideSpec,
                    level: int = EVALUATION_MASK_LEVEL,
                    compression: str = "deflate",
                    band_px: int = 1 << 24) -> str:
    """Write the spec's tumor polygons as CAMELYON16 ships a ground-truth
    mask: ``<mask_dir>/<case>_Mask.tif``, a tiled BigTIFF pyramid of levels
    0 to ``level`` (each the polygons rasterized at that level, 0/255 in
    all three channels), streamed in row bands of about ``band_px``
    pixels. Level ``level`` equals :func:`write_mask_npy`'s array; returns
    the path."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.tiff_slide import (
        StreamingPyramidWriter,
    )

    base = (spec.width, spec.height)
    polys = polygons_level0(spec)
    os.makedirs(mask_dir, exist_ok=True)
    path = os.path.join(mask_dir, f"{case}_Mask.tif")
    tile = 256
    with StreamingPyramidWriter(path, tile_size=tile,
                                compression=compression) as wr:
        for lvl in range(level + 1):
            w, h = max(1, spec.width >> lvl), max(1, spec.height >> lvl)
            wr.begin_level(w, h)
            rows = max(tile, band_px // w // tile * tile)
            for y0 in range(0, h, rows):
                band = polygons_to_mask_band(polys, (w, h), base, x0=0, y0=y0,
                                             band_w=w, band_h=min(rows, h - y0))
                wr.write_band(np.repeat(band[:, :, None], 3, axis=2))
            wr.end_level()
    return path
