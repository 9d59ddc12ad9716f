"""ctypes bindings of the port's two host libraries (``io/native/``).

Copy of the JAX package's ``io/native_lib.py`` with one difference: the
chunk processor (``chunkproc.cpp``, OpenMP only) and the TIFF reader and
writer (``tile_decoder.cpp``, on libtiff) are two libraries, built at first
use by ``ops/build.py::host_library``, so that a machine without libtiff
still gathers packed stores natively. There is no quiet numpy route: a
failed build raises with the compiler's output. The numpy versions of the
four chunk functions stay beside them under ``_plain`` names, for the
tests; the production path does not call them.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np

from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
    host_library,
)

_LOCK = threading.Lock()

_c = ctypes
_U8P, _I64P = _c.POINTER(_c.c_uint8), _c.POINTER(_c.c_int64)
# library → entry point → (argtypes, restype)
_SIGNATURES = {
    "chunk": {
        "hipac_patch_means": ([_U8P, _c.c_int64, _c.c_int64,
                               _c.POINTER(_c.c_float)], None),
        "hipac_patchify": ([_U8P, _c.c_int64, _c.c_int64, _c.c_int64, _U8P,
                            _I64P], _c.c_int64),
        "hipac_gather_rows": ([_U8P, _I64P, _c.c_int64, _c.c_int64, _U8P],
                              None),
        "hipac_gather_rows_s2d": ([_U8P, _I64P, _c.c_int64, _c.c_int64, _U8P],
                                  None),
        "hipac_omp_max_threads": ([], _c.c_int),
    },
    "tiff": {
        "hipac_last_error": ([], _c.c_char_p),
        "hipac_open": ([_c.c_char_p], _c.c_void_p),
        "hipac_close": ([_c.c_void_p], None),
        "hipac_level_count": ([_c.c_void_p], _c.c_int),
        "hipac_level_dims": ([_c.c_void_p, _c.c_int, _I64P, _I64P], _c.c_int),
        "hipac_read_region": ([_c.c_void_p, _c.c_int, _c.c_int64, _c.c_int64,
                               _c.c_int64, _c.c_int64, _U8P], _c.c_int),
        "hipac_read_regions": ([_c.c_void_p, _c.c_int, _I64P, _c.c_int64,
                                _c.c_int64, _c.c_int64, _U8P, _c.c_int],
                               _c.c_int),
        "hipac_set_cache_bytes": ([_c.c_void_p, _c.c_int64], _c.c_int),
        "hipac_cache_stats": ([_c.c_void_p, _I64P, _I64P, _I64P], None),
        "hipac_write_pyramid": ([_c.c_char_p, _c.POINTER(_U8P), _I64P, _I64P,
                                 _c.c_int, _c.c_int, _c.c_int], _c.c_int),
        "hipac_writer_open": ([_c.c_char_p, _c.c_int, _c.c_int], _c.c_void_p),
        "hipac_writer_begin_level": ([_c.c_void_p, _c.c_int64, _c.c_int64,
                                      _c.c_int], _c.c_int),
        "hipac_writer_write_band": ([_c.c_void_p, _c.c_int64, _U8P], _c.c_int),
        "hipac_writer_end_level": ([_c.c_void_p], _c.c_int),
        "hipac_writer_close": ([_c.c_void_p], _c.c_int),
        # libtiff's own, reached through the library's dependencies
        "TIFFGetVersion": ([], _c.c_char_p),
    },
}


def chunk_lib() -> ctypes.CDLL:
    """The chunk processor, built and loaded once (raises if the build
    fails)."""
    with _LOCK:
        return _load("chunk")


def tiff_lib() -> ctypes.CDLL:
    """The TIFF reader and writer, built and loaded once (raises if libtiff
    is missing or the build fails)."""
    with _LOCK:
        return _load("tiff")


@functools.cache
def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(host_library(name)))
    for fn_name, (argtypes, restype) in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def native_available() -> bool:
    """Whether both host libraries build and load here."""
    try:
        chunk_lib()
        tiff_lib()
    except (RuntimeError, OSError):
        return False
    return True


def last_error() -> str:
    """The TIFF library's last error message on this thread."""
    return (tiff_lib().hipac_last_error() or b"").decode()


def libtiff_version() -> str:
    """The first line of the linked libtiff's ``TIFFGetVersion()``."""
    return tiff_lib().TIFFGetVersion().decode().splitlines()[0]


# ---------------------------------------------------------------------------
# numpy wrappers of the chunk processor, and their plain versions
# ---------------------------------------------------------------------------


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _i64ptr(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def patch_means(patches: np.ndarray) -> np.ndarray:
    """(N, ...) uint8 → (N,) float32 per-patch means (the tissue
    statistic), with OpenMP."""
    patches = np.ascontiguousarray(patches, np.uint8)
    n = patches.shape[0]
    per = int(np.prod(patches.shape[1:]))
    out = np.empty((n,), np.float32)
    chunk_lib().hipac_patch_means(_u8ptr(patches), n, per,
                                  out.ctypes.data_as(_c.POINTER(_c.c_float)))
    return out


def patch_means_plain(patches: np.ndarray) -> np.ndarray:
    patches = np.ascontiguousarray(patches, np.uint8)
    n = patches.shape[0]
    return patches.reshape(n, -1).mean(axis=1, dtype=np.float64).astype(
        np.float32)


def _grid(plane: np.ndarray, patch_size: int) -> tuple[int, int]:
    h, w = plane.shape[:2]
    return -(-w // patch_size), -(-h // patch_size)


def patchify(plane: np.ndarray, patch_size: int) -> tuple[np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 → ((N, P, P, 3) patches, (N, 2) level coords) in the
    reference's x-major order, white pad-to-grid."""
    plane = np.ascontiguousarray(plane, np.uint8)
    h, w = plane.shape[:2]
    nx, ny = _grid(plane, patch_size)
    patches = np.empty((nx * ny, patch_size, patch_size, 3), np.uint8)
    coords = np.empty((nx * ny, 2), np.int64)
    count = chunk_lib().hipac_patchify(_u8ptr(plane), w, h, patch_size,
                                       _u8ptr(patches), _i64ptr(coords))
    return patches[:count], coords[:count]


def patchify_plain(plane: np.ndarray,
                   patch_size: int) -> tuple[np.ndarray, np.ndarray]:
    plane = np.ascontiguousarray(plane, np.uint8)
    h, w = plane.shape[:2]
    nx, ny = _grid(plane, patch_size)
    n = nx * ny
    padded = np.full((ny * patch_size, nx * patch_size, 3), 255, np.uint8)
    padded[:h, :w] = plane
    tiles = padded.reshape(ny, patch_size, nx, patch_size, 3)
    p = np.ascontiguousarray(
        tiles.transpose(2, 0, 1, 3, 4).reshape(n, patch_size, patch_size, 3))
    c = np.empty((n, 2), np.int64)
    c[:, 0] = np.repeat(np.arange(nx, dtype=np.int64), ny) * patch_size
    c[:, 1] = np.tile(np.arange(ny, dtype=np.int64), nx) * patch_size
    return p, c


def gather_rows(store: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Packed-store batch gather: ``store[indices]`` with OpenMP."""
    store = np.ascontiguousarray(store, np.uint8)
    indices = np.ascontiguousarray(indices, np.int64)
    _check_rows(store, indices)
    per = int(np.prod(store.shape[1:]))
    out = np.empty((len(indices),) + store.shape[1:], np.uint8)
    chunk_lib().hipac_gather_rows(_u8ptr(store), _i64ptr(indices),
                                  len(indices), per, _u8ptr(out))
    return out


def gather_rows_plain(store: np.ndarray, indices: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(store, np.uint8)[
        np.ascontiguousarray(indices, np.int64)].copy()


def _check_rows(store: np.ndarray, indices: np.ndarray) -> None:
    # the native gather reads whatever row it is given: bound it here
    if len(indices) and (indices.min() < 0 or indices.max() >= len(store)):
        raise IndexError(f"row index out of range for a store of "
                         f"{len(store)} rows")


def space_to_depth_u8(batch: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) → (B, H/2, W/2, 12) with slot ``(r·2 + rx)·3 + c`` holding
    pixel (2Y + r, 2X + rx, c): the stem's space-to-depth layout."""
    b, h, w, c = batch.shape
    if h % 2 or w % 2:
        raise ValueError(f"space-to-depth needs even H and W, got {h}×{w}")
    cells = batch.reshape(b, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 2, 4, 5)
    return np.ascontiguousarray(cells).reshape(b, h // 2, w // 2, 4 * c)


def _check_s2d(store: np.ndarray) -> int:
    patch = int(store.shape[1])
    if store.ndim != 4 or patch % 2 or store.shape[2] != patch or store.shape[3] != 3:
        raise ValueError(f"s2d gather needs (N, P, P, 3) with even P, "
                         f"got {store.shape}")
    return patch


def gather_rows_s2d(store: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Packed-store batch gather emitting the stem's space-to-depth layout
    (B, P/2, P/2, 12) directly: the bytes of :func:`gather_rows`, written
    to other addresses, so the int8 path needs no transpose."""
    store = np.ascontiguousarray(store, np.uint8)
    indices = np.ascontiguousarray(indices, np.int64)
    patch = _check_s2d(store)
    _check_rows(store, indices)
    out = np.empty((len(indices), patch // 2, patch // 2, 12), np.uint8)
    chunk_lib().hipac_gather_rows_s2d(_u8ptr(store), _i64ptr(indices),
                                      len(indices), patch, _u8ptr(out))
    return out


def gather_rows_s2d_plain(store: np.ndarray, indices: np.ndarray) -> np.ndarray:
    _check_s2d(store)
    return space_to_depth_u8(gather_rows_plain(store, indices))
