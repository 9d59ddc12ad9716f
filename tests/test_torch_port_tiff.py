"""The port's tiled TIFF slides and host libraries against the JAX package.

- ``io/native/*.cpp`` are copies of the JAX package's sources (the decoder
  with one include switch), and ``tiff_abi.h`` holds libtiff's values;
- the TIFF library built on the header-less route (``tiff_abi.h``, linked
  to a ``libtiff.so.N`` by path) decodes what the header route decodes;
- the host build is atomic under concurrent processes and raises on a
  compiler error;
- the writers write the JAX package's bytes (``none``, ``deflate``,
  ``jpeg``, ``jpeg_ycbcr``), and each package decodes the other's files
  equally: JPEG decodes are equal here because both link the same libjpeg;
- ``read_region``, ``read_regions`` (white past the edges), stripped files
  and the tile cache's counters against the JAX ``TiffSlide``;
- the four chunk functions against the JAX ``native_lib`` and the port's
  ``_plain`` versions, and ``PatchReader.read_batch`` against numpy;
- ``write_synthetic_case(container="tiff")``, ``write_giant_synthetic_slide``
  and ``write_mask_tiff`` against the JAX package's writers and the npz
  fixtures;
- extraction from a TIFF on both routes (the JAX package's records and
  bytes, and the port's own from the same slide's ``.wsi.npz``),
  ``predict_slide`` on a TIFF (the ``.wsi.npz`` run's grid and CSV bytes),
  the FROC with a ``_Mask.tif``;
- many threads reading one slide through both APIs, bytes exact.
"""

import ctypes
import ctypes.util
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu.data import (
    extract as jextract,
)
from ss25_hierarchical_multiscale_image_classification_tpu.evaluation import (
    froc as jfroc,
)
from ss25_hierarchical_multiscale_image_classification_tpu.io import (
    native_lib as jnative,
)
from ss25_hierarchical_multiscale_image_classification_tpu.io import (
    synthetic as jsynthetic,
)
from ss25_hierarchical_multiscale_image_classification_tpu.io import (
    tiff_slide as jtiff,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
    extract,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
    PatchManifest,
    PatchRecord,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.patch_store import (
    PackedPatchWriter,
    PatchReader,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation import (
    froc,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer import (
    sliding_window as psw,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io import (
    native_lib,
    synthetic,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io import (
    tiff_slide as ptiff,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
    open_slide,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops import (
    build,
)

from torch_port_native import load_jax_native_lib

JAX_PKG = "ss25_hierarchical_multiscale_image_classification_tpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPRESSIONS = ["none", "deflate", "jpeg", "jpeg_ycbcr"]
CPU = torch.device("cpu")

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="session")
def _jax_native_lib():
    """The JAX TIFF code's library, built or loaded under the workers' lock
    before any test here reaches it (``tests/torch_port_native.py``)."""
    load_jax_native_lib()


def _levels(seed=0, w=600, h=424, n=3):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    # smooth parts beside the noise, so that JPEG has both to encode
    base[: h // 2, : w // 2] = np.linspace(0, 255, w // 2, dtype=np.uint8)[
        None, :, None]
    return jsynthetic.build_pyramid(base, n)


def _plane(slide, level):
    return slide.read_region((0, 0), level, slide.level_dimensions[level])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One pyramid written by the port in each compression."""
    root = tmp_path_factory.mktemp("tiff")
    levels = _levels()
    out = {}
    for comp in COMPRESSIONS:
        out[comp] = str(root / f"p_{comp}.tif")
        ptiff.write_pyramidal_tiff(out[comp], levels, tile_size=128,
                                   compression=comp)
    return levels, out


# ---------------------------------------------------------------------------
# sources and the host build
# ---------------------------------------------------------------------------


def _native(pkg, name):
    return open(os.path.join(REPO, pkg, "io", "native", name)).read()


def test_native_sources_are_the_jax_packages():
    port = f"{JAX_PKG}_torch"
    assert _native(port, "chunkproc.cpp") == _native(JAX_PKG, "chunkproc.cpp")
    got = _native(port, "tile_decoder.cpp")
    switch = re.search(r"// Where libtiff's headers.*?#endif\n", got, re.S)
    assert switch and '#include "tiff_abi.h"' in switch.group(0)
    assert got.replace(switch.group(0), "#include <tiffio.h>\n") == _native(
        JAX_PKG, "tile_decoder.cpp")


def _header_values():
    """``#define NAME value`` of libtiff's installed headers."""
    cxx = build.find_cxx()
    proc = subprocess.run([cxx, "-x", "c++", "-E", "-dM", "-"],
                          input="#include <tiffio.h>\n", capture_output=True,
                          text=True, timeout=60)
    if proc.returncode:
        pytest.skip("libtiff's headers are not installed here")
    return dict(re.findall(r"#define (\w+) (.+)", proc.stdout))


def test_tiff_abi_header_holds_libtiffs_values():
    want = _header_values()
    abi = _native(f"{JAX_PKG}_torch", "tiff_abi.h")
    defined = re.findall(r"#define ((?:TIFFTAG|COMPRESSION|PHOTOMETRIC|"
                         r"ORIENTATION|PLANARCONFIG|FILETYPE|JPEGCOLORMODE)"
                         r"\w*) (\S+)", abi)
    assert len(defined) == 24
    for name, value in defined:
        assert int(value, 0) == int(want[name].split()[0], 0), name
    # every tag or value the decoder names is declared
    used = set(re.findall(r"\b(?:TIFFTAG|COMPRESSION|PHOTOMETRIC|ORIENTATION|"
                          r"PLANARCONFIG|FILETYPE|JPEGCOLORMODE)_\w+",
                          _native(f"{JAX_PKG}_torch", "tile_decoder.cpp")))
    assert used <= {n for n, _ in defined}


def _abi_libtiffs():
    out = []
    system = ctypes.util.find_library("tiff")
    if system:
        out.append(("system", f"-l:{system}", None))
    bundled = build._pillow_libtiff()
    if bundled is not None:
        out.append(("pillow", str(bundled), bundled.parent))
    return out


@pytest.mark.parametrize("which", ["system", "pillow"])
def test_header_less_route_decodes_as_the_header_route(files, tmp_path,
                                                       monkeypatch, which):
    found = {name: (arg, rpath) for name, arg, rpath in _abi_libtiffs()}
    if which not in found:
        pytest.skip(f"no {which} libtiff here")
    arg, rpath = found[which]
    native_lib.tiff_lib()  # the header build, loaded before the patch
    link = ("-DHIPAC_TIFF_ABI", f"-I{build.NATIVE_DIR}", arg)
    if rpath is not None:
        link += ("-Wl,--disable-new-dtags", f"-Wl,-rpath,{rpath}")
    monkeypatch.setattr(build, "libtiff_route", lambda: ("abi", link))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    lib = native_lib._load.__wrapped__("tiff")  # not the cached header build
    version = lib.TIFFGetVersion().decode()
    assert version.startswith("LIBTIFF, Version 4.")
    levels, paths = files
    for comp, path in paths.items():
        h = lib.hipac_open(path.encode())
        assert h
        for lv, want in enumerate(levels):
            w = ctypes.c_int64()
            hh = ctypes.c_int64()
            assert lib.hipac_level_dims(h, lv, ctypes.byref(w), ctypes.byref(hh)) == 0
            out = np.empty((hh.value, w.value, 3), np.uint8)
            assert lib.hipac_read_region(h, lv, 0, 0, w.value, hh.value,
                                         out.ctypes.data_as(native_lib._U8P)) == 0
            reader = ptiff.TiffSlide(path)
            header = _plane(reader, lv)
            reader.close()
            if comp in ("none", "deflate") or which == "system":
                np.testing.assert_array_equal(out, header)
            else:  # Pillow's libjpeg may round its IDCT another way
                assert np.abs(out.astype(int) - header).max() <= 2
        lib.hipac_close(h)
    # and it writes a file the header route reads back exactly
    out_path = str(tmp_path / "abi.tif")
    ptrs = (native_lib._U8P * len(levels))(
        *[lv.ctypes.data_as(native_lib._U8P) for lv in levels])
    ws = (ctypes.c_int64 * len(levels))(*[lv.shape[1] for lv in levels])
    hs = (ctypes.c_int64 * len(levels))(*[lv.shape[0] for lv in levels])
    assert lib.hipac_write_pyramid(out_path.encode(), ptrs, ws, hs,
                                   len(levels), 64, 1) == 0
    slide = ptiff.TiffSlide(out_path)
    for lv, want in enumerate(levels):
        np.testing.assert_array_equal(_plane(slide, lv), want)
    slide.close()


_BUILD_IN = """
import sys
from pathlib import Path
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops import build
build.BUILD_DIR = Path(sys.argv[1])
print(build.host_library("chunk"))
"""


def test_host_build_is_atomic_under_concurrent_processes(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_IN, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(4)]
    got = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
        got.append(out.strip())
    assert len(set(got)) == 1, got
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(["host.lock", os.path.basename(got[0])])
    lib = ctypes.CDLL(got[0])
    assert lib.hipac_omp_max_threads() >= 1


def test_failed_host_build_raises_with_the_compilers_output(tmp_path,
                                                            monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "chunkproc.cpp").write_text("int f() { return undeclared_name; }\n")
    monkeypatch.setattr(build, "NATIVE_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        build.host_library("chunk")
    assert os.listdir(tmp_path / "build") == ["host.lock"]  # no half file


def test_compiler_without_openmp_is_passed_over(tmp_path, monkeypatch):
    bad = tmp_path / "cxx"
    bad.write_text("#!/bin/sh\necho \"cannot read spec file libgomp.spec\" >&2\n"
                   "exit 1\n")
    bad.chmod(0o755)
    monkeypatch.setenv("CXX", str(bad))
    build.find_cxx.cache_clear()
    try:
        assert build.find_cxx() != str(bad)  # c++ or g++ on PATH
        monkeypatch.setattr(build.shutil, "which", lambda name: None)
        build.find_cxx.cache_clear()
        with pytest.raises(RuntimeError, match="libgomp.spec"):
            build.find_cxx()
    finally:
        build.find_cxx.cache_clear()


def test_libraries_are_two_and_available():
    assert native_lib.native_available()
    assert native_lib.chunk_lib() is not native_lib.tiff_lib()
    assert not hasattr(native_lib.chunk_lib(), "hipac_open")
    assert not hasattr(native_lib.tiff_lib(), "hipac_gather_rows")
    chunk = build.host_library_path("chunk")
    tiff = build.host_library_path("tiff")
    assert chunk.exists() and tiff.exists() and chunk != tiff
    # the chunk library does not link libtiff
    needed = subprocess.run(["ldd", str(chunk)], capture_output=True,
                            text=True).stdout
    assert "libtiff" not in needed
    assert native_lib.libtiff_version().startswith("LIBTIFF, Version 4.")


# ---------------------------------------------------------------------------
# writers and readers against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("comp", COMPRESSIONS)
def test_writer_writes_the_jax_packages_bytes(files, tmp_path, comp):
    levels, paths = files
    jpath = str(tmp_path / "j.tif")
    jtiff.write_pyramidal_tiff(jpath, levels, tile_size=128, compression=comp)
    with open(paths[comp], "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    # each package decodes each file equally, and lossless ones exactly
    for path in (paths[comp], jpath):
        p, j = ptiff.TiffSlide(path), jtiff.TiffSlide(path)
        assert p.level_dimensions == j.level_dimensions
        assert p.level_downsamples == j.level_downsamples
        for lv, want in enumerate(levels):
            got = _plane(p, lv)
            np.testing.assert_array_equal(got, _plane(j, lv))
            if comp in ("none", "deflate"):
                np.testing.assert_array_equal(got, want)
            else:  # the smooth quadrant survives quality 90 (and 4:2:0)
                h, w = want.shape[0] // 2, want.shape[1] // 2
                err = np.abs(got[:h, :w].astype(int) - want[:h, :w])
                assert err.mean() < 2.0
        p.close()
        j.close()


@pytest.mark.parametrize("comp", COMPRESSIONS)
def test_streaming_writer_writes_the_jax_packages_bytes(tmp_path, comp):
    levels = _levels(seed=1, w=520, h=300)
    out = {}
    for name, writer in (("p", ptiff.StreamingPyramidWriter),
                         ("j", jtiff.StreamingPyramidWriter)):
        out[name] = str(tmp_path / f"{name}.tif")
        with writer(out[name], tile_size=64, compression=comp) as wr:
            for lv in levels:
                wr.begin_level(lv.shape[1], lv.shape[0])
                for y in range(0, lv.shape[0], 128):
                    wr.write_band(lv[y:y + 128])
                wr.end_level()
    assert open(out["p"], "rb").read() == open(out["j"], "rb").read()


def test_streaming_writer_refuses_what_the_jax_one_refuses(tmp_path):
    wr = ptiff.StreamingPyramidWriter(str(tmp_path / "x.tif"), tile_size=64)
    wr.begin_level(100, 100)
    with pytest.raises(IOError, match="tile"):
        wr.write_band(np.zeros((10, 100, 3), np.uint8))  # not a tile multiple
    with pytest.raises(IOError, match="while a level is open"):
        wr.begin_level(10, 10)
    with pytest.raises(IOError, match="before all rows"):
        wr.end_level()
    wr.close()
    with pytest.raises(KeyError):
        ptiff.StreamingPyramidWriter(str(tmp_path / "y.tif"),
                                     compression="lzw")


REGIONS = [((0, 0), 0, (600, 424)), ((37, 51), 0, (200, 90)),
           ((-30, -20), 0, (100, 80)), ((550, 400), 0, (128, 64)),
           ((2000, 0), 0, (16, 16)), ((100, 60), 1, (150, 100)),
           ((-8, 300), 1, (64, 200)), ((0, 0), 2, (150, 106))]


@pytest.mark.parametrize("comp", ["deflate", "jpeg_ycbcr"])
@pytest.mark.parametrize("region", REGIONS, ids=lambda r: f"{r[0]}-L{r[1]}")
def test_read_region_equals_jax(files, comp, region):
    levels, paths = files
    loc, level, size = region
    p, j = ptiff.TiffSlide(paths[comp]), jtiff.TiffSlide(paths[comp])
    got = p.read_region(loc, level, size)
    np.testing.assert_array_equal(got, j.read_region(loc, level, size))
    assert got.shape == (size[1], size[0], 3)
    if comp == "deflate":  # the source plane, white past its edges
        ds = 2 ** level
        want = np.full((size[1], size[0], 3), 255, np.uint8)
        x, y = int(loc[0] / ds), int(loc[1] / ds)
        src = levels[level]
        xa, ya = max(x, 0), max(y, 0)
        xb, yb = min(x + size[0], src.shape[1]), min(y + size[1], src.shape[0])
        if xb > xa and yb > ya:
            want[ya - y:yb - y, xa - x:xb - x] = src[ya:yb, xa:xb]
        np.testing.assert_array_equal(got, want)
    p.close()
    j.close()


@pytest.mark.parametrize("num_threads", [0, 1, 3])
def test_read_regions_and_cache_stats_equal_jax(files, num_threads):
    _, paths = files
    coords = np.array([[0, 0], [100, 37], [-20, -20], [280, 200], [299, 211],
                       [1000, 5], [64, 64]], np.int64)
    p, j = ptiff.TiffSlide(paths["jpeg"]), jtiff.TiffSlide(paths["jpeg"])
    for level, size in ((0, (96, 96)), (1, (40, 72))):
        got = p.read_regions(coords, level, size, num_threads=num_threads)
        want = j.read_regions(coords, level, size, num_threads=num_threads)
        np.testing.assert_array_equal(got, want)
        for k, (x, y) in enumerate(coords):  # the single reads' bytes
            ds = 2 ** level
            for s in (p, j):
                np.testing.assert_array_equal(
                    got[k], s.read_region((int(x) * ds, int(y) * ds), level,
                                          size))
        assert (got[5] == 255).all()  # wholly outside: white
    # one worker decodes in the same order in both: the counters agree
    if num_threads == 1:
        assert p.cache_stats() == j.cache_stats()
    assert p.cache_stats()["bytes"] == j.cache_stats()["bytes"]
    p.close()
    j.close()


def test_cache_size_and_counters_equal_jax(files):
    _, paths = files
    p, j = ptiff.TiffSlide(paths["deflate"]), jtiff.TiffSlide(paths["deflate"])
    for s in (p, j):
        s.set_cache_bytes(2 * 128 * 128 * 3)
        for y in (0, 100, 200, 0):
            s.read_region((0, y), 0, (300, 64))
    assert p.cache_stats() == j.cache_stats()
    assert p.cache_stats()["bytes"] <= 2 * 128 * 128 * 3
    for s in (p, j):
        s.set_cache_bytes(0)
        s.read_region((0, 0), 0, (64, 64))
    assert p.cache_stats() == j.cache_stats()
    assert p.cache_stats()["bytes"] == 0
    with pytest.raises(ValueError):
        p.set_cache_bytes(-1)
    p.close()
    p.close()  # idempotent
    j.close()


@pytest.mark.parametrize("compression", ["raw", "tiff_adobe_deflate"])
def test_stripped_tiff_equals_jax(tmp_path, compression):
    from PIL import Image

    img = np.random.default_rng(11).integers(0, 256, (300, 400, 3), np.uint8)
    path = str(tmp_path / "striped.tif")
    Image.fromarray(img).save(path, compression=compression)
    p, j = open_slide(path), jtiff.TiffSlide(path)
    np.testing.assert_array_equal(_plane(p, 0), img)
    np.testing.assert_array_equal(_plane(j, 0), img)
    for loc, size in (((50, 40), (100, 200)), ((390, 290), (30, 30)),
                      ((-5, 0), (20, 300))):
        np.testing.assert_array_equal(p.read_region(loc, 0, size),
                                      j.read_region(loc, 0, size))
    # the strips cached as full-width tiles, re-read from the cache alike
    assert p.cache_stats() == j.cache_stats()
    assert p.cache_stats()["hits"] > 0
    coords = np.array([[0, 0], [350, 250]], np.int64)
    np.testing.assert_array_equal(p.read_regions(coords, 0, (64, 64)),
                                  j.read_regions(coords, 0, (64, 64)))
    p.close()
    j.close()


def test_open_slide_takes_both_extensions(files, tmp_path):
    levels, paths = files
    tiff = str(tmp_path / "x.tiff")
    os.link(paths["deflate"], tiff)
    slide = open_slide(tiff)
    assert isinstance(slide, ptiff.TiffSlide)
    assert slide.level_count == len(levels)
    assert slide.properties == {"path": tiff, "format": "tiff"}
    slide.close()
    (tmp_path / "bad.tif").write_bytes(b"not a tiff")
    with pytest.raises(IOError, match="cannot open"):
        open_slide(str(tmp_path / "bad.tif"))


# ---------------------------------------------------------------------------
# the chunk processor and the packed-store reader
# ---------------------------------------------------------------------------

CHUNK_SHAPES = [(7, 16, 16, 3), (33, 28, 28, 3)]


@pytest.mark.parametrize("shape", CHUNK_SHAPES)
@pytest.mark.parametrize("fn", ["patch_means", "gather_rows", "gather_rows_s2d"])
def test_chunk_functions_equal_jax_and_plain(fn, shape):
    rng = np.random.default_rng(len(fn) + shape[0])
    store = rng.integers(0, 256, shape, dtype=np.uint8)
    if fn == "patch_means":
        args = (store,)
    else:
        args = (store, rng.integers(0, shape[0], 19).astype(np.int64))
    got = getattr(native_lib, fn)(*args)
    np.testing.assert_array_equal(got, getattr(jnative, fn)(*args))
    np.testing.assert_array_equal(got, getattr(native_lib, fn + "_plain")(*args))
    assert got.dtype == (np.float32 if fn == "patch_means" else np.uint8)


@pytest.mark.parametrize("hw,ps", [((100, 130), 32), ((64, 64), 16),
                                   ((5, 9), 4)])
def test_patchify_equals_jax_and_plain(hw, ps):
    plane = np.random.default_rng(ps).integers(0, 256, hw + (3,), np.uint8)
    patches, coords = native_lib.patchify(plane, ps)
    jp, jc = jnative.patchify(plane, ps)
    pp, pc = native_lib.patchify_plain(plane, ps)
    for a, b in ((patches, jp), (patches, pp), (coords, jc), (coords, pc)):
        np.testing.assert_array_equal(a, b)


def test_gathers_refuse_what_they_cannot_read():
    store = np.zeros((4, 6, 6, 3), np.uint8)
    for fn in (native_lib.gather_rows, native_lib.gather_rows_s2d):
        with pytest.raises(IndexError):
            fn(store, np.array([0, 4]))
        with pytest.raises(IndexError):
            fn(store, np.array([-1]))
    with pytest.raises(ValueError):
        native_lib.gather_rows_s2d(np.zeros((4, 5, 5, 3), np.uint8),
                                   np.array([0]))
    with pytest.raises(ValueError):
        native_lib.space_to_depth_u8(np.zeros((1, 5, 4, 3), np.uint8))
    assert native_lib.gather_rows(store, np.array([], np.int64)).shape == (
        0, 6, 6, 3)


def _packs(tmp_path, sizes=(16, 16), n=12):
    recs = []
    rng = np.random.default_rng(3)
    for k, ps in enumerate(sizes):
        w = PackedPatchWriter(str(tmp_path), 3, f"s{k}", ps)
        patches = rng.integers(0, 256, (n, ps, ps, 3), dtype=np.uint8)
        coords = np.stack([np.arange(n), np.arange(n)], 1)
        recs += w.write_batch(patches, coords, np.arange(n) % 2)
        w.close()
    return recs


@pytest.mark.parametrize("sizes,resize,s2d", [
    ((16,), None, False), ((16, 16), None, False), ((16, 16), None, True),
    ((16,), 16, True), ((32, 16), 16, False), ((32, 16), 16, True),
    ((32,), 16, True)])
def test_read_batch_equals_the_numpy_gather(tmp_path, sizes, resize, s2d):
    recs = _packs(tmp_path, sizes)
    reader = PatchReader(PatchManifest(recs))
    idx = [len(recs) - 1, 0, 5, 11, 2, len(recs) // 2 + 1, 5]
    got = reader.read_batch(idx, resize_to=resize, s2d=s2d)
    imgs = [np.asarray(reader._mmap(recs[i].path))[recs[i].row] for i in idx]
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.patch_store import (
        _resize,
    )

    if resize is not None:
        imgs = [_resize(img, resize) for img in imgs]
    want = np.stack(imgs)
    if s2d:
        want = native_lib.space_to_depth_u8(want)
    np.testing.assert_array_equal(got, want)


def test_read_batch_equals_the_jax_reader(tmp_path):
    from ss25_hierarchical_multiscale_image_classification_tpu.data.manifest import (
        PatchManifest as JManifest,
        PatchRecord as JRecord,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu.data.patch_store import (
        PatchReader as JReader,
    )

    recs = _packs(tmp_path, (16, 16))
    jrecs = [JRecord(**{f: getattr(r, f) for f in PatchRecord.__dataclass_fields__})
             for r in recs]
    idx = [3, 17, 0, 22, 9]
    for s2d in (False, True):
        np.testing.assert_array_equal(
            PatchReader(PatchManifest(recs)).read_batch(idx, s2d=s2d),
            JReader(JManifest(jrecs)).read_batch(idx, s2d=s2d))


# ---------------------------------------------------------------------------
# fixtures written as TIFFs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("comp", COMPRESSIONS)
def test_write_synthetic_case_tiff_equals_jax(tmp_path, comp):
    spec_kw = dict(width=700, height=520, seed=5, tissue_radii=(0.45, 0.4))
    p = synthetic.write_synthetic_case(str(tmp_path / "p"), "normal_005",
                                       synthetic.normal_spec(**spec_kw),
                                       container="tiff", compression=comp)
    j = jsynthetic.write_synthetic_case(str(tmp_path / "j"), "normal_005",
                                        jsynthetic.normal_spec(**spec_kw),
                                        container="tiff", compression=comp)
    assert os.path.basename(p) == os.path.basename(j) == "normal_005.tif"
    assert open(p, "rb").read() == open(j, "rb").read()
    npz = synthetic.write_synthetic_case(str(tmp_path / "n"), "normal_005",
                                         synthetic.normal_spec(**spec_kw))
    if comp in ("none", "deflate"):
        a, b = open_slide(p), open_slide(npz)
        for lv in range(b.level_count):
            np.testing.assert_array_equal(_plane(a, lv), b.level_array(lv))
        a.close()


def test_write_synthetic_tumor_case_tiff_is_the_npz_pyramid(tmp_path):
    spec = synthetic.tumor_spec(width=640, height=480, seed=8)
    tif = synthetic.write_synthetic_case(str(tmp_path), "tumor_008", spec,
                                         container="tiff")
    npz = synthetic.write_synthetic_case(str(tmp_path), "tumor_008", spec)
    a, b = open_slide(tif), open_slide(npz)
    for lv in range(b.level_count):
        np.testing.assert_array_equal(_plane(a, lv), b.level_array(lv))
    a.close()
    assert os.path.exists(tmp_path / "annotations" / "tumor_008.xml")


GIANT = dict(width=4096, height=3072, num_levels=4, seed=9)


@pytest.mark.parametrize("kind", ["normal", "tumor"])
def test_giant_slide_equals_jax(tmp_path, kind):
    polys = (((0.45, 0.45), (0.55, 0.47), (0.53, 0.55)),) if kind == "tumor" \
        else ()
    p, j = str(tmp_path / "p.tif"), str(tmp_path / "j.tif")
    kw = dict(tile_size=256, target_band_px=2_000_000, compression="deflate")
    synthetic.write_giant_synthetic_slide(
        p, synthetic.tumor_spec(tumor_polygons=polys, **GIANT),
        xml_path=str(tmp_path / "p.xml"), **kw)
    jsynthetic.write_giant_synthetic_slide(
        j, jsynthetic.tumor_spec(tumor_polygons=polys, **GIANT),
        xml_path=str(tmp_path / "j.xml"), **kw)
    if kind == "normal":
        assert open(p, "rb").read() == open(j, "rb").read()
        assert not os.path.exists(tmp_path / "p.xml")
        return
    # the tumor fill is the port's numpy rasterizer, the JAX package's is
    # PIL's: the pixels differ only where the two masks do
    from ss25_hierarchical_multiscale_image_classification_tpu.grid import (
        rasterize as jrasterize,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid import (
        rasterize,
    )

    a, b = ptiff.TiffSlide(p), jtiff.TiffSlide(j)
    poly0 = [np.array([(x * 4096, y * 3072) for x, y in polys[0]])]
    for lv in range(4):
        dims = a.level_dimensions[lv]
        pa, pb = _plane(a, lv), _plane(b, lv)
        mp = rasterize.polygons_to_mask(poly0, dims, (4096, 3072)) > 0
        mj = jrasterize.polygons_to_mask(poly0, dims, (4096, 3072)) > 0
        differ = (pa != pb).any(-1)
        assert differ.sum() > 0
        assert not (differ & (mp == mj)).any()
    a.close()
    b.close()
    from ss25_hierarchical_multiscale_image_classification_tpu.io.annotations import (
        parse_annotation_xml,
    )

    for got, want in zip(parse_annotation_xml(str(tmp_path / "p.xml")),
                         parse_annotation_xml(str(tmp_path / "j.xml"))):
        np.testing.assert_array_equal(got, want)


def rasterize_level(spec, lv):
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid import (
        rasterize,
    )

    dims = (spec.width >> lv, spec.height >> lv)
    return rasterize.polygons_to_mask(synthetic.polygons_level0(spec), dims,
                                      (spec.width, spec.height))


def test_write_mask_tiff_is_the_npy_mask_at_every_level(tmp_path):
    spec = synthetic.tumor_spec(width=2048, height=1536, seed=3)
    path = synthetic.write_mask_tiff(str(tmp_path), "tumor_003", spec,
                                     band_px=100_000)
    assert os.path.basename(path) == "tumor_003_Mask.tif"
    npy = np.load(synthetic.write_mask_npy(str(tmp_path), "tumor_003", spec))
    slide = open_slide(path)
    assert slide.level_count == 6
    for lv in range(6):
        plane = _plane(slide, lv)
        want = rasterize_level(spec, lv)
        np.testing.assert_array_equal(plane, np.repeat(want[:, :, None], 3, 2))
    np.testing.assert_array_equal(_plane(slide, 5)[:, :, 0], npy)
    slide.close()


def test_froc_with_a_mask_tif_equals_jax_and_the_npy(tmp_path):
    spec = synthetic.tumor_spec(width=4096, height=3072, seed=4)
    tif_dir, npy_dir, csv_dir = (tmp_path / d for d in ("tif", "npy", "csv"))
    synthetic.write_mask_tiff(str(tif_dir), "tumor_004", spec)
    synthetic.write_mask_npy(str(npy_dir), "tumor_004", spec)
    csv_dir.mkdir()
    rng = np.random.default_rng(4)
    # detections in level-0 pixels, some inside the polygon
    xs = np.concatenate([rng.uniform(0.42, 0.6, 12), rng.uniform(0, 1, 12)]) * 4096
    ys = np.concatenate([rng.uniform(0.4, 0.58, 12), rng.uniform(0, 1, 12)]) * 3072
    (csv_dir / "tumor_004.csv").write_text("".join(
        f"{p},{int(x)},{int(y)}\n" for p, x, y in
        zip(rng.uniform(0.05, 1, 24), xs, ys)))
    (csv_dir / "normal_004.csv").write_text("0.7,10,10\n")
    got = froc.run_froc_evaluation(str(csv_dir), str(tif_dir))
    want = jfroc.run_froc_evaluation(str(csv_dir), str(tif_dir))
    npy = froc.run_froc_evaluation(str(csv_dir), str(npy_dir))
    for other in (want, npy):
        assert got["score"] == other["score"]
        assert got["num_tumors"] == other["num_tumors"]
        assert got["fp_probs"] == other["fp_probs"]
    assert got["num_tumors"][1] > 0 and 0.0 < got["score"] <= 1.0
    np.testing.assert_array_equal(
        froc.compute_evaluation_mask(os.path.join(str(tif_dir),
                                                  "tumor_004_Mask.tif")),
        froc.compute_evaluation_mask(np.load(os.path.join(
            str(npy_dir), "tumor_004_mask.npy"))))


# ---------------------------------------------------------------------------
# the slide paths on TIFF
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiff_case(tmp_path_factory):
    """JAX-written tumor and normal slides, each as ``.wsi.npz`` and as a
    deflate TIFF of the same pyramid, with the tumor's XML."""
    root = str(tmp_path_factory.mktemp("tiff_case"))
    specs = {
        "tumor_001": jsynthetic.tumor_spec(width=4032, height=2688,
                                           tissue_radii=(0.45, 0.45), seed=1),
        "normal_001": jsynthetic.SyntheticSlideSpec(
            width=1792, height=1344, tissue_radii=(0.45, 0.45), seed=2),
    }
    for name, spec in specs.items():
        jsynthetic.write_synthetic_case(root, name, spec)
        npz = open_slide(os.path.join(root, "train", "img", f"{name}.wsi.npz"))
        ptiff.write_pyramidal_tiff(
            os.path.join(root, "train", "img", f"{name}.tif"),
            [npz.level_array(i) for i in range(npz.level_count)])
    return root


def _case_paths(root, name, ext):
    return (os.path.join(root, "train", "img", f"{name}{ext}"),
            os.path.join(root, "annotations", f"{name}.xml"))


def _rows_bytes(recs):
    return ([(r.slide, r.level, r.x, r.y, r.label, r.row) for r in recs],
            [open(p, "rb").read() for p in sorted({r.path for r in recs})])


@pytest.mark.parametrize("kw", [dict(level=3), dict(level=2),
                                dict(level=3, stride=56),
                                dict(level=2, band_budget_bytes=1),
                                dict(level=1, impl="device"),
                                dict(level=3, impl="device")],
                         ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_extraction_from_tiff_equals_jax_and_the_npz(tiff_case, tmp_path, kw):
    tif, xml = _case_paths(tiff_case, "tumor_001", ".tif")
    npz, _ = _case_paths(tiff_case, "tumor_001", ".wsi.npz")
    pkw = dict(kw, device=CPU) if kw.get("impl") == "device" else kw
    jkw = {k: v for k, v in kw.items() if k != "impl"}
    from_tiff = extract.extract_patches_for_slide(tif, xml, patches_dir=str(
        tmp_path / "t"), **pkw)
    from_npz = extract.extract_patches_for_slide(npz, xml, patches_dir=str(
        tmp_path / "n"), **pkw)
    jax_tiff = jextract.extract_patches_for_slide(tif, xml, patches_dir=str(
        tmp_path / "j"), **jkw)
    assert len(from_tiff) > 0
    assert _rows_bytes(from_tiff) == _rows_bytes(from_npz)
    assert _rows_bytes(from_tiff) == _rows_bytes(jax_tiff)


def test_fetch_band_read_regions_route_equals_the_plane(tiff_case):
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.pyramid import (
        PatchGrid,
    )

    tif = open_slide(_case_paths(tiff_case, "tumor_001", ".tif")[0])
    npz = open_slide(_case_paths(tiff_case, "tumor_001", ".wsi.npz")[0])
    grid = PatchGrid.for_slide_level(2, tif.level_dimensions[2],
                                     tif.level_downsamples[2], 300)
    for _, coords in extract._iter_column_bands(grid, 2):
        np.testing.assert_array_equal(extract._fetch_band(tif, grid, coords, 3),
                                      extract._fetch_band(npz, grid, coords, 3))
    tif.close()


@pytest.fixture(scope="module")
def small_model():
    """An 8-wide ResNet18 from a seed: its state dict and the model."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
        ResNet18Classifier,
    )

    model = ResNet18Classifier(num_filters=8,
                               generator=torch.Generator().manual_seed(7))
    return model.state_dict(), model.eval()


@pytest.mark.parametrize("tissue_filter", ["host", "device"])
def test_predict_slide_on_tiff_equals_the_npz(tiff_case, small_model, tmp_path,
                                              tissue_filter):
    kw = dict(level=3, stride=56, batch_size=8, input_size=64, device="cpu",
              tissue_filter=tissue_filter, threshold=1e-9)
    grids, csvs = {}, {}
    for ext in (".wsi.npz", ".tif"):
        path, _ = _case_paths(tiff_case, "tumor_001", ext)
        grids[ext], csvs[ext] = psw.predict_and_export(
            path, small_model[1], str(tmp_path / ext), **kw)
    np.testing.assert_array_equal(grids[".tif"], grids[".wsi.npz"])
    assert (grids[".tif"] > 0).any() and (grids[".tif"] == 0).any()
    assert open(csvs[".tif"], "rb").read() == open(csvs[".wsi.npz"], "rb").read()


def test_predict_slide_on_an_open_tiff_counts_its_cache(tiff_case, small_model):
    slide = ptiff.TiffSlide(_case_paths(tiff_case, "tumor_001", ".tif")[0])
    psw.predict_slide(slide, small_model[1], level=3, stride=56, batch_size=8,
                      input_size=64, device="cpu")
    stats = slide.cache_stats()
    # bands at stride 56 re-read 224-row windows of 256-px tiles
    assert stats["misses"] > 0 and stats["hits"] > stats["misses"]
    slide.close()


def test_cli_predicts_a_tiff_directory(tiff_case, small_model, tmp_path):
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.cli import (
        main as cli,
    )

    models = tmp_path / "models"
    models.mkdir()
    torch.save(small_model[0], str(models / "resnet18_patch_classifier.pt"))
    img = tmp_path / "img"
    img.mkdir()
    for name in ("tumor_001", "normal_001"):
        os.link(_case_paths(tiff_case, name, ".tif")[0], img / f"{name}.tif")
    argv = ["--predict_slide", str(img), "--stride", "56", "--batch_size", "8",
            "--models_dir", str(models), "--device", "cpu"]
    assert cli.main(argv) == 0
    got = sorted(os.listdir(models / "model_predictions_csv"))
    assert got == ["normal_001.csv", "tumor_001.csv"]
    csv_path = str(models / "model_predictions_csv" / "tumor_001.csv")
    _, want = psw.predict_and_export(
        _case_paths(tiff_case, "tumor_001", ".wsi.npz")[0], small_model[1],
        str(tmp_path / "ref"), level=3, stride=56, batch_size=8, device="cpu")
    assert open(csv_path, "rb").read() == open(want, "rb").read()


# ---------------------------------------------------------------------------
# threads
# ---------------------------------------------------------------------------


def test_concurrent_single_and_batch_reads_stay_exact(files):
    """Four threads of ``read_region`` and four of ``read_regions`` on one
    handle, with a short switch interval: every result byte-exact."""
    levels, paths = files
    slide = ptiff.TiffSlide(paths["deflate"])
    plane = levels[1]
    errors = []

    def single(seed):
        r = np.random.default_rng(seed)
        try:
            for _ in range(40):
                x = int(r.integers(0, plane.shape[1] - 32))
                y = int(r.integers(0, plane.shape[0] - 32))
                got = slide.read_region((x * 2, y * 2), 1, (32, 32))
                np.testing.assert_array_equal(got, plane[y:y + 32, x:x + 32])
        except Exception as e:  # reported below
            errors.append(e)

    def batch(seed):
        r = np.random.default_rng(seed)
        try:
            for _ in range(10):
                xs = r.integers(0, plane.shape[1] - 48, 16)
                ys = r.integers(0, plane.shape[0] - 48, 16)
                out = slide.read_regions(np.stack([xs, ys], 1), 1, (48, 48),
                                         num_threads=4)
                for k, (x, y) in enumerate(zip(xs, ys)):
                    np.testing.assert_array_equal(out[k],
                                                  plane[y:y + 48, x:x + 48])
        except Exception as e:  # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=single, args=(100 + i,))
                   for i in range(4)]
        threads += [threading.Thread(target=batch, args=(200 + i,))
                    for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    slide.close()
    assert not errors, errors[:3]
