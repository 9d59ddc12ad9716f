"""Pyramidal TIFF slides over the port's native decoder.

Copy of the JAX package's ``io/tiff_slide.py``: tiled or stripped
(Big)TIFF decode through ``io/native/tile_decoder.cpp`` (libtiff, a TIFF
handle a reader thread, a decoded-tile LRU cache), OpenSlide's coordinates
(``read_region``'s location in level-0 pixels, its size in level pixels,
out-of-bounds pixels white), a threaded batch read (``read_regions``) for
extraction, and the tiled pyramidal BigTIFF writers (``none``, ``deflate``,
``jpeg``, ``jpeg_ycbcr``: the CAMELYON16 encoding, chroma-subsampled YCbCr
JPEG tiles). The native calls release the GIL.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ss25_hierarchical_multiscale_image_classification_tpu_torch.io import native_lib

#: ``compression`` name → the native writers' code
COMPRESSIONS = {"none": 0, "deflate": 1, "jpeg": 2, "jpeg_ycbcr": 3}


class TiffSlide:
    def __init__(self, path: str):
        lib = native_lib.tiff_lib()
        self._lib = lib
        self._handle = lib.hipac_open(path.encode())
        if not self._handle:
            raise IOError(
                f"cannot open slide {path}: {native_lib.last_error()}"
            )
        self.path = path
        n = lib.hipac_level_count(self._handle)
        dims = []
        for lvl in range(n):
            w = ctypes.c_int64()
            h = ctypes.c_int64()
            lib.hipac_level_dims(self._handle, lvl, ctypes.byref(w),
                                 ctypes.byref(h))
            dims.append((w.value, h.value))
        self._dims = dims
        base_w = dims[0][0]
        self._downsamples = [base_w / d[0] for d in dims]
        self.properties = {"path": path, "format": "tiff"}

    @property
    def level_count(self) -> int:
        return len(self._dims)

    @property
    def level_dimensions(self) -> list[tuple[int, int]]:
        return list(self._dims)

    @property
    def level_downsamples(self) -> list[float]:
        return list(self._downsamples)

    def read_region(
        self, location: tuple[int, int], level: int, size: tuple[int, int]
    ) -> np.ndarray:
        """OpenSlide convention: ``location`` in level-0 px, ``size`` in
        level px; returns (H, W, 3) uint8 (out-of-bounds = white)."""
        ds = self._downsamples[level]
        x = int(location[0] / ds)
        y = int(location[1] / ds)
        w, h = int(size[0]), int(size[1])
        out = np.empty((h, w, 3), np.uint8)
        rc = self._lib.hipac_read_region(
            self._handle, level, x, y, w, h,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if rc != 0:
            raise IOError(
                f"read_region failed on {self.path}: {native_lib.last_error()}"
            )
        return out

    def read_regions(
        self,
        coords_level: np.ndarray,
        level: int,
        size: tuple[int, int],
        num_threads: int = 0,
    ) -> np.ndarray:
        """Threaded batch read: (N, 2) LEVEL-space coords → (N, H, W, 3).

        This is the pipeline-facing API — one native call decodes the whole
        grid row/batch with per-thread TIFF handles.
        """
        coords = np.ascontiguousarray(coords_level, np.int64)
        n = len(coords)
        w, h = int(size[0]), int(size[1])
        out = np.empty((n, h, w, 3), np.uint8)
        failures = self._lib.hipac_read_regions(
            self._handle,
            level,
            coords.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, w, h,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            num_threads,
        )
        if failures:
            raise IOError(
                f"{failures} region reads failed on {self.path}: "
                f"{native_lib.last_error()}"
            )
        return out

    def set_cache_bytes(self, bytes_: int) -> None:
        """Size the decoded-tile LRU cache for this handle (0 disables).

        Overlapping band reads (inference at stride < patch size) and
        tile-straddling grid patches re-touch compressed tiles 3-7x; the
        native cache decodes each once. Default 256 MB."""
        rc = self._lib.hipac_set_cache_bytes(self._handle, int(bytes_))
        if rc != 0:
            raise ValueError(native_lib.last_error())

    def cache_stats(self) -> dict:
        """Decoded-tile cache counters: {hits, misses, bytes}."""
        h = ctypes.c_int64()
        m = ctypes.c_int64()
        b = ctypes.c_int64()
        self._lib.hipac_cache_stats(
            self._handle, ctypes.byref(h), ctypes.byref(m), ctypes.byref(b)
        )
        return {"hits": h.value, "misses": m.value, "bytes": b.value}

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.hipac_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_pyramidal_tiff(
    path: str,
    levels: list[np.ndarray],
    tile_size: int = 256,
    compression: str = "deflate",
) -> None:
    """Write a tiled pyramidal BigTIFF (fixtures + artifact interop).

    ``compression``: "none" | "deflate" (lossless) | "jpeg" (RGB JPEG) |
    "jpeg_ycbcr" (chroma-subsampled YCbCr JPEG — the CAMELYON16
    production encoding)."""
    lib = native_lib.tiff_lib()
    comp = COMPRESSIONS[compression]
    levels = [np.ascontiguousarray(lv, np.uint8) for lv in levels]
    n = len(levels)
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)(
        *[lv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) for lv in levels]
    )
    ws = (ctypes.c_int64 * n)(*[lv.shape[1] for lv in levels])
    hs = (ctypes.c_int64 * n)(*[lv.shape[0] for lv in levels])
    rc = lib.hipac_write_pyramid(
        path.encode(), ptrs, ws, hs, n, tile_size, comp
    )
    if rc != 0:
        raise IOError(f"write_pyramidal_tiff failed: {native_lib.last_error()}")


class StreamingPyramidWriter:
    """Band-streaming tiled pyramidal BigTIFF writer.

    Writes levels in order (0 first), each as sequential row bands whose
    heights are tile multiples (except the final band), so gigapixel
    fixtures/artifacts are produced with one band resident instead of the
    whole level (~65 GB at CAMELYON16 level 0). Wraps the native
    ``hipac_writer_*`` API.

    Usage::

        with StreamingPyramidWriter(path, compression="jpeg") as wr:
            wr.begin_level(w0, h0)
            for band in bands:          # (rows, w0, 3) uint8
                wr.write_band(band)
            wr.end_level()
            ...
    """

    def __init__(self, path: str, tile_size: int = 256,
                 compression: str = "deflate"):
        lib = native_lib.tiff_lib()
        self._lib = lib
        comp = COMPRESSIONS[compression]
        self.path = path
        self._handle = lib.hipac_writer_open(path.encode(), tile_size, comp)
        if not self._handle:
            raise IOError(
                f"cannot create {path}: {native_lib.last_error()}"
            )
        self._level_index = 0

    def begin_level(self, width: int, height: int) -> None:
        rc = self._lib.hipac_writer_begin_level(
            self._handle, width, height, 1 if self._level_index > 0 else 0
        )
        if rc != 0:
            raise IOError(f"begin_level failed: {native_lib.last_error()}")

    def write_band(self, band: np.ndarray) -> None:
        band = np.ascontiguousarray(band, np.uint8)
        rc = self._lib.hipac_writer_write_band(
            self._handle, band.shape[0],
            band.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if rc != 0:
            raise IOError(f"write_band failed: {native_lib.last_error()}")

    def end_level(self) -> None:
        rc = self._lib.hipac_writer_end_level(self._handle)
        if rc != 0:
            raise IOError(f"end_level failed: {native_lib.last_error()}")
        self._level_index += 1

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.hipac_writer_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
