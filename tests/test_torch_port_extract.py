"""The port's patch extraction against the JAX package's, on the CPU.

- ``polygons_to_mask_device`` equals ``polygons_to_mask_jax`` bit for bit
  (convex and concave polygons, horizontal edges, vertices on pixel
  centres, polygons partly off the plane, invalid slots, several row tiles,
  non-square levels);
- ``is_tissue`` and ``patch_labels_from_mask`` against the JAX functions;
- ``extract_patches_on_device`` against the JAX device program and the JAX
  host extractor: the same (x, y) → label map and the same bytes;
- ``extract_patches_for_slide`` and ``extract_patches`` against JAX's rows
  and store bytes (``only_tumor``, ``stride``, several bands, a missing
  level, the idempotent skip, the ``on_slide`` hook, a corrupt slide, the
  PNG store, ``--stain_norm``), and the numpy manifest where pyarrow does
  not import;
- where the reference's two rasterizers (PIL on the host route, its own on
  the device route) disagree on a cell, the port's two routes disagree on
  it the same way.

Slides are written by the JAX package (PIL-drawn tumors) so that both
packages read the same bytes.
"""

import logging
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu.config import (
    DataConfig as JDataConfig,
)
from ss25_hierarchical_multiscale_image_classification_tpu.data import (
    extract as jextract,
)
from ss25_hierarchical_multiscale_image_classification_tpu.data.streamed import (
    extract_patches_on_device as jax_on_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu.grid import (
    labeling as jlabeling,
)
from ss25_hierarchical_multiscale_image_classification_tpu.grid import (
    rasterize as jrasterize,
)
from ss25_hierarchical_multiscale_image_classification_tpu.io import (
    synthetic as jsynthetic,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    DataConfig,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
    extract,
    manifest,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.patch_store import (
    PatchReader,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.streamed import (
    extract_patches_on_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid import (
    labeling,
    rasterize,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.pyramid import (
    PatchGrid,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.annotations import (
    parse_annotation_xml,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
    open_slide,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# Device rasterizer
# ---------------------------------------------------------------------------


def _star(rng, center, radius, k, jitter):
    a = np.sort(rng.uniform(0, 2 * np.pi, k))
    r = radius * (1 + jitter * rng.uniform(-1, 1, k))
    return np.stack([center[0] + r * np.cos(a), center[1] + r * np.sin(a)], 1)


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "convex":
        a = np.linspace(0, 2 * np.pi, 17)[:-1]
        return [np.stack([400 + 230 * np.cos(a), 300 + 170 * np.sin(a)], 1)]
    if name == "concave":
        return [_star(rng, (500, 350), 300, 45, 0.6),
                _star(rng, (200, 500), 120, 9, 0.8)]
    if name == "horizontal_and_centres":
        # integer vertices land on pixel centres at scale 1 and 1/4 (x4),
        # axis-aligned edges, a notch, a zero-length edge
        return [np.array([[100., 100.], [300., 100.], [300., 300.],
                          [200., 300.], [200., 200.], [152., 200.],
                          [152., 300.], [100., 300.], [100., 300.]]),
                np.array([[600., 40.], [880., 40.], [740., 40.]])]
    if name == "off_plane":
        return [np.array([[-250., -100.], [450., 120.], [1300., -40.],
                          [1200., 900.], [300., 760.], [-80., 500.]]),
                _star(rng, (980, 650), 200, 30, 0.5)]
    if name == "many_vertices":
        t = np.arange(1024) * 2 * np.pi / 1024
        r = 260 * (1 + 0.1 * np.cos(3 * t + 0.4) + 0.05 * np.cos(7 * t))
        return [np.stack([480 + r * np.cos(t), 330 + r * np.sin(t)], 1),
                np.array([[10.5, 10.5]])]
    raise KeyError(name)


BASE = (1000, 700)
LEVELS = [((1000, 700), 512), ((250, 175), 64), ((125, 87), 7), ((63, 44), 512)]


@pytest.mark.parametrize("name", ["convex", "concave", "horizontal_and_centres",
                                  "off_plane", "many_vertices"])
@pytest.mark.parametrize("level_dims,tile", LEVELS[1:])
def test_device_rasterizer_equals_jax_bit_for_bit(name, level_dims, tile):
    polys = _case(name)
    verts, valid = rasterize.pad_polygons(polys)
    jv, jval = jrasterize.pad_polygons(polys)
    np.testing.assert_array_equal(verts, jv)
    np.testing.assert_array_equal(valid, jval)
    want = np.asarray(jrasterize.polygons_to_mask_jax(
        jnp.asarray(jv), jnp.asarray(jval), level_dims, BASE, tile=tile))
    # budgets of one row, a few rows and the default
    for budget in (1, 1 << 20, rasterize.MASK_TILE_BUDGET_BYTES):
        got = rasterize.polygons_to_mask_device(
            verts, valid, level_dims, BASE, device=CPU, budget_bytes=budget)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (want > 0).mean() < 1


def test_device_rasterizer_at_full_size_and_invalid_slots():
    polys = _case("concave") + _case("off_plane")
    verts, valid = rasterize.pad_polygons(polys)
    valid[1] = False  # a slot switched off marks nothing
    want = np.asarray(jrasterize.polygons_to_mask_jax(
        jnp.asarray(verts), jnp.asarray(valid), LEVELS[0][0], BASE))
    got = rasterize.polygons_to_mask_device(verts, valid, LEVELS[0][0], BASE,
                                            device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)
    # no polygon: one invalid slot, an empty mask
    verts, valid = rasterize.pad_polygons([np.zeros((0, 2))])
    assert not valid.any()
    empty = rasterize.polygons_to_mask_device(verts, valid, (40, 30), BASE,
                                              device=CPU)
    assert empty.shape == (30, 40) and not empty.any()


def test_pad_polygons_equals_jax_with_truncation():
    polys = [np.arange(10.).reshape(5, 2), np.ones((2, 2)), np.zeros((0, 2))]
    for max_vertices in (None, 3, 4, 8):
        got = rasterize.pad_polygons(polys, max_vertices)
        want = jrasterize.pad_polygons(polys, max_vertices)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dims,level,stride", [((1000, 700), 3, None),
                                               ((4032, 2688), 2, 112),
                                               ((500, 1300), 1, None)])
def test_copied_grid_and_config_pieces_equal_jax(dims, level, stride):
    from ss25_hierarchical_multiscale_image_classification_tpu import (
        config as jconfig,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu.grid.pyramid import (
        PatchGrid as JPatchGrid,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch import (
        config as pconfig,
    )

    assert pconfig.PAD_FILL_VALUE == jconfig.PAD_FILL_VALUE
    for data_dir in ("data", "/x/y"):
        p, j = DataConfig(data_dir=data_dir), JDataConfig(data_dir=data_dir)
        assert p.annotations_dir == j.annotations_dir
        assert p.patch_level_dir(level) == j.patch_level_dir(level)
        assert p.stain_norm is j.stain_norm is False
    g = PatchGrid.for_slide_level(level, dims, 2.0 ** level, stride)
    jg = JPatchGrid.for_slide_level(level, dims, 2.0 ** level, stride)
    for x, y in jg.coords():
        assert g.valid_patch_extent(x, y) == jg.valid_patch_extent(x, y)


# ---------------------------------------------------------------------------
# Labeling
# ---------------------------------------------------------------------------


def test_is_tissue_matches_the_host_filter_and_jax():
    rng = np.random.default_rng(0)
    n, ps = 64, 16
    patches = rng.integers(200, 256, (n, ps, ps, 3), dtype=np.uint8)
    count = ps * ps * 3
    # cells summing exactly to 240·count and one above it
    patches[0] = 240
    patches[1] = 240
    patches[1, 0, 0, 0] = 241
    patches[2] = 255
    got = labeling.is_tissue(torch.from_numpy(patches)).numpy()
    host = np.array([labeling.is_tissue_host(p) for p in patches])
    np.testing.assert_array_equal(got, host)
    assert got[0] and not got[1] and not got[2]
    jax_keep = np.asarray(jlabeling.is_tissue(jnp.asarray(patches)))
    exact = patches.reshape(n, -1).astype(np.int64).sum(1)
    differ = np.nonzero(jax_keep != got)[0]
    # JAX's float32 mean may differ only within float32 rounding of 240
    assert all(abs(exact[i] / count - 240.0) < 240 * 2 ** -20 for i in differ)
    assert (jax_keep == got).mean() > 0.9
    # a float batch takes the mean
    f = torch.from_numpy(patches.astype(np.float32))
    np.testing.assert_array_equal(labeling.is_tissue(f).numpy(), host)


def test_is_tissue_sums_a_level0_patch_without_overflow():
    white = torch.full((1, 1792, 1792, 3), 255, dtype=torch.uint8)
    dark = torch.full((1, 1792, 1792, 3), 239, dtype=torch.uint8)
    got = labeling.is_tissue(torch.cat([white, dark])).tolist()
    assert got == [False, True]
    assert labeling.tissue_sum_limit(240.0, 1792 * 1792 * 3) == 240 * 1792 * 1792 * 3
    assert labeling.tissue_sum_limit(240.5, 3) == 721


@pytest.mark.parametrize("shape,ps", [((64, 96), 16), ((48, 32), 8), ((9, 6), 3)])
def test_patch_labels_from_mask_equals_jax(shape, ps):
    rng = np.random.default_rng(ps)
    mask = np.where(rng.random(shape) < 0.01, 255, 0).astype(np.uint8)
    want = np.asarray(jlabeling.patch_labels_from_mask(jnp.asarray(mask), ps))
    got = labeling.patch_labels_from_mask(torch.from_numpy(mask), ps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Slides
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """JAX-written slides: tumor_001 (4032×2688, non-square grids, PIL
    tumor), normal_001 (1792×1344, no annotation)."""
    root = str(tmp_path_factory.mktemp("extract_case"))
    jsynthetic.write_synthetic_case(
        root, "tumor_001",
        jsynthetic.tumor_spec(width=4032, height=2688,
                              tissue_radii=(0.45, 0.45), seed=1))
    jsynthetic.write_synthetic_case(
        root, "normal_001",
        jsynthetic.SyntheticSlideSpec(width=1792, height=1344,
                                      tissue_radii=(0.45, 0.45), seed=2))
    return root


def _paths(case, name="tumor_001"):
    return (os.path.join(case, "train", "img", f"{name}.wsi.npz"),
            os.path.join(case, "annotations", f"{name}.xml"))


def _rows(recs):
    return [(r.slide, r.level, r.x, r.y, r.label, r.store, r.row) for r in recs]


def _store_bytes(recs):
    paths = sorted({r.path for r in recs})
    return [open(p, "rb").read() for p in paths], [
        open(p + ".shape").read() for p in paths if p.endswith(".pack")]


def _same_store(precs, jrecs):
    assert _rows(precs) == _rows(jrecs)
    pb, ps = _store_bytes(precs)
    jb, js = _store_bytes(jrecs)
    assert ps == js
    assert pb == jb


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("name", ["tumor_001", "normal_001"])
def test_on_device_extraction_equals_jax_device_and_host(case, tmp_path, level,
                                                        name):
    slide_path, xml = _paths(case, name)
    slide = open_slide(slide_path)
    grid = PatchGrid.for_slide_level(level, slide.level_dimensions[level],
                                     slide.level_downsamples[level])
    polys = parse_annotation_xml(xml) if os.path.exists(xml) else []
    before = extract_patches_on_device.calls
    patches, coords, labels = extract_patches_on_device(
        slide.level_array(level), grid, polys, slide.level_dimensions[0],
        device=CPU)
    assert extract_patches_on_device.calls == before + 1
    jp, jc, jl = jax_on_device(slide.level_array(level), grid, polys,
                               slide.level_dimensions[0])
    # the kept cells: JAX's float32 mean may differ within its rounding of 240
    got = {tuple(c): int(v) for c, v in zip(coords.tolist(), labels)}
    want = {tuple(c): int(v) for c, v in zip(np.asarray(jc).tolist(),
                                             np.asarray(jl))}
    near = [c for c in set(got) ^ set(want)
            if abs(slide.read_region(grid.level0_origin(*c), level,
                                     (grid.patch_size,) * 2).mean() - 240) < 1e-4]
    assert set(got) ^ set(want) == set(near), "kept cells differ"
    assert {c: got[c] for c in want if c in got} == {
        c: want[c] for c in want if c in got}
    for i, c in enumerate(coords.tolist()):
        if tuple(c) in want:
            j = [tuple(x) for x in np.asarray(jc).tolist()].index(tuple(c))
            np.testing.assert_array_equal(patches[i], np.asarray(jp)[j])
    # and the JAX host extractor's rows and bytes
    jrecs = jextract.extract_patches_for_slide(slide_path, xml, level,
                                               str(tmp_path / "j"))
    assert [(r.x, r.y, r.label) for r in jrecs] == [
        (int(x), int(y), int(v)) for (x, y), v in zip(coords, labels)]
    reader = PatchReader(manifest.PatchManifest(jrecs))
    for i in range(len(jrecs)):
        np.testing.assert_array_equal(reader.read(i), patches[i])
    assert patches.dtype == np.uint8 and coords.dtype == np.int32
    slide.close()


@pytest.mark.parametrize("kw", [
    dict(level=3),
    dict(level=2),
    dict(level=1),
    dict(level=3, stride=56),
    dict(level=2, stride=112, only_tumor=True),
    dict(level=3, only_tumor=True),
    dict(level=2, band_budget_bytes=448 * 448 * 3 * 2),  # one column a band
    dict(level=3, stride=28, band_budget_bytes=1),
    dict(level=7),  # a missing level
], ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_extract_patches_for_slide_equals_jax(case, tmp_path, kw):
    slide_path, xml = _paths(case)
    jrecs = jextract.extract_patches_for_slide(
        slide_path, xml, patches_dir=str(tmp_path / "j"), **kw)
    precs = extract.extract_patches_for_slide(
        slide_path, xml, patches_dir=str(tmp_path / "p"), **kw)
    _same_store(precs, jrecs)
    if kw["level"] == 7:
        assert precs == []
    else:
        assert len(precs) > 0
    if "stride" not in kw and kw["level"] != 7:
        drecs = extract.extract_patches_for_slide(
            slide_path, xml, patches_dir=str(tmp_path / "d"), impl="device",
            device=CPU, **kw)
        _same_store(drecs, jrecs)


class _RegionOnly:
    """A slide that only reads regions (no ``level_array``), as a tiled
    reader does."""

    def __init__(self, slide):
        self._slide = slide
        self.level_count = slide.level_count
        self.level_dimensions = slide.level_dimensions
        self.level_downsamples = slide.level_downsamples

    def read_region(self, location, level, size):
        return self._slide.read_region(location, level, size)


@pytest.mark.parametrize("level,stride", [(3, 56), (2, None), (1, 300)])
def test_fetch_band_read_region_route_equals_level_array(case, level, stride):
    slide_path, _ = _paths(case)
    slide = open_slide(slide_path)
    grid = PatchGrid.for_slide_level(level, slide.level_dimensions[level],
                                     slide.level_downsamples[level], stride)
    band_cols = extract._band_columns(grid, 2 * grid.ny * grid.patch_size ** 2 * 3)
    jgrid = jextract.PatchGrid.for_slide_level(
        level, slide.level_dimensions[level], slide.level_downsamples[level],
        stride)
    bands = list(extract._iter_column_bands(grid, band_cols))
    assert [c.tolist() for _, c in bands] == [
        c.tolist() for _, c in jextract._iter_column_bands(jgrid, band_cols)]
    assert len(bands) > 1 or grid.nx <= 2
    for _, coords in bands:
        direct = extract._fetch_band(slide, grid, coords, 2)
        regions = extract._fetch_band(_RegionOnly(slide), grid, coords, 2)
        want = jextract._fetch_band(_RegionOnly(slide), jgrid, coords, 2)
        np.testing.assert_array_equal(direct, regions)
        np.testing.assert_array_equal(regions, want)
    assert extract._fetch_band(slide, grid, coords[:0], 2).shape == (
        0, grid.patch_size, grid.patch_size, 3)
    slide.close()


def test_device_route_falls_back_to_host_over_budget(case, tmp_path, caplog):
    slide_path, xml = _paths(case)
    before = extract_patches_on_device.calls
    jrecs = jextract.extract_patches_for_slide(
        slide_path, xml, 2, str(tmp_path / "j"))
    messages = []
    handler = logging.Handler()
    handler.emit = messages.append
    get_logger("data.extract").addHandler(handler)
    try:
        precs = extract.extract_patches_for_slide(
            slide_path, xml, 2, str(tmp_path / "p"), impl="device",
            band_budget_bytes=1000, device=CPU)
    finally:
        get_logger("data.extract").removeHandler(handler)
    assert extract_patches_on_device.calls == before
    assert any("exceeds the device budget" in m.getMessage() for m in messages)
    _same_store(precs, jrecs)


def test_png_store_equals_jax(case, tmp_path):
    pytest.importorskip("PIL")
    slide_path, xml = _paths(case)
    jrecs = jextract.extract_patches_for_slide(
        slide_path, xml, 3, str(tmp_path / "j"), store_format="png",
        stride=112)
    precs = extract.extract_patches_for_slide(
        slide_path, xml, 3, str(tmp_path / "p"), store_format="png",
        stride=112)
    assert [(r.slide, r.x, r.y, r.label, r.store) for r in precs] == [
        (r.slide, r.x, r.y, r.label, r.store) for r in jrecs]
    for p, j in zip(precs, jrecs):
        assert os.path.basename(p.path) == os.path.basename(j.path)
        assert open(p.path, "rb").read() == open(j.path, "rb").read()


def test_png_store_without_pillow_fails_before_any_slide(case, tmp_path,
                                                         monkeypatch):
    root = str(tmp_path / "c")
    shutil.copytree(case, root)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(RuntimeError, match="Pillow"):
        extract.extract_patches(DataConfig(data_dir=root), level=3,
                                store_format="png", device=CPU)
    assert not os.path.exists(os.path.join(root, "patches"))


def _he_slide(path, seed=0, size=448):
    """A slide whose level 3 (``size`` square) is two-stain H&E tissue
    (random hematoxylin and eosin concentrations on the reference basis)
    under a light band."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.stain import (
        DEFAULT_STAIN_REF,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
        save_npz_slide,
    )

    rng = np.random.default_rng(seed)
    conc = np.stack([rng.uniform(0.2, 1.2, size * size),
                     rng.uniform(0.1, 0.8, size * size)])
    img = np.clip(240.0 * np.exp(-(DEFAULT_STAIN_REF @ conc).T) - 1.0, 0, 255)
    img = img.astype(np.uint8).reshape(size, size, 3)
    # light background (OD under 0.15, mean under 240): the top row of cells
    # holds under 5 % tissue, is kept and passes through unnormalized
    img[:216] = 230
    # levels 0-2 repeat the level-3 pixels (the grid reads level 3)
    save_npz_slide(path, [img.repeat(8 >> k, 0).repeat(8 >> k, 1)
                          for k in range(4)])


def test_stain_norm_extraction_within_tolerance_of_jax(tmp_path):
    """On two-stain tissue: rows equal, bytes within the Macenko tolerance of
    ``test_torch_port_stain.py`` (|Δ| ≤ 1, at most 1 % of bytes), and the
    stored bytes are the port's ``macenko_normalize_batch`` of the plain
    patches exactly."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.stain import (
        macenko_normalize_batch,
    )

    slide_path = str(tmp_path / "he_001.wsi.npz")
    _he_slide(slide_path)
    xml = str(tmp_path / "none.xml")
    kw = dict(level=3, stride=56)
    kw_p = dict(kw, patches_dir=str(tmp_path / "p"))
    jrecs = jextract.extract_patches_for_slide(
        slide_path, xml, patches_dir=str(tmp_path / "j"), stain_norm=True,
        **kw)
    precs = extract.extract_patches_for_slide(
        slide_path, xml, stain_norm=True, device=CPU, **kw_p)
    plain = extract.extract_patches_for_slide(
        slide_path, xml, patches_dir=str(tmp_path / "n"), **kw)
    assert _rows(precs) == _rows(jrecs) == _rows(plain)
    read = lambda recs: PatchReader(manifest.PatchManifest(recs)).read_batch(  # noqa: E731
        range(len(recs)))
    got, want, raw = read(precs), read(jrecs), read(plain)
    diff = np.abs(got.astype(np.int16) - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    np.testing.assert_array_equal(
        got, macenko_normalize_batch(torch.from_numpy(raw)).numpy())
    normalized = (got != raw).reshape(len(got), -1).any(axis=1)
    assert 0 < normalized.sum() < len(got)  # light cells pass through


def _case_copy(case, tmp_path, name="c"):
    root = str(tmp_path / name)
    shutil.copytree(case, root, ignore=shutil.ignore_patterns("patches"))
    return root


def test_extract_patches_equals_jax_with_hook_and_skip(case, tmp_path):
    proot, jroot = _case_copy(case, tmp_path, "p"), _case_copy(case, tmp_path, "j")
    pseen, jseen = [], []
    pm = extract.extract_patches(
        DataConfig(data_dir=proot), level=3, stride=56, device=CPU,
        on_slide=lambda n, r: pseen.append((n, _rows(r))))
    jm = jextract.extract_patches(
        JDataConfig(data_dir=jroot), level=3, stride=56,
        on_slide=lambda n, r: jseen.append((n, _rows(r))))
    assert pseen == jseen and [n for n, _ in pseen] == ["normal_001", "tumor_001"]
    assert _rows(pm) == _rows(jm)
    mpath = manifest.manifest_path(DataConfig(data_dir=proot).patches_dir, 3)
    assert _rows(manifest.PatchManifest.load(mpath)) == _rows(jm)
    _same_store(list(pm), list(jm))
    # idempotent: the second call re-fires with the existing rows, writes
    # nothing
    stamp = os.path.getmtime(pm[0].path)
    again = []
    pm2 = extract.extract_patches(
        DataConfig(data_dir=proot), level=3, stride=56, device=CPU,
        on_slide=lambda n, r: again.append((n, _rows(r))))
    assert again == pseen and _rows(pm2) == _rows(pm)
    assert os.path.getmtime(pm[0].path) == stamp


def test_extract_patches_slide_filter_and_a_corrupt_slide(case, tmp_path):
    proot, jroot = _case_copy(case, tmp_path, "p"), _case_copy(case, tmp_path, "j")
    for root in (proot, jroot):
        with open(os.path.join(root, "train", "img", "bad_001.wsi.npz"),
                  "wb") as f:
            f.write(b"not a slide")
    messages = []
    handler = logging.Handler()
    handler.emit = messages.append
    get_logger("data.extract").addHandler(handler)
    try:
        pm = extract.extract_patches(DataConfig(data_dir=proot), level=3,
                                     device=CPU)
    finally:
        get_logger("data.extract").removeHandler(handler)
    jm = jextract.extract_patches(JDataConfig(data_dir=jroot), level=3)
    assert _rows(pm) == _rows(jm)
    assert sorted({r.slide for r in pm}) == ["normal_001", "tumor_001"]
    assert any(m.levelno == logging.ERROR and "bad_001" in m.getMessage()
               for m in messages)
    # --patch_one_slide's filter
    one = extract.extract_patches(DataConfig(data_dir=_case_copy(
        case, tmp_path, "one")), level=2, slide_filter=["tumor_001"],
        device=CPU)
    jone = jextract.extract_patches(JDataConfig(data_dir=_case_copy(
        case, tmp_path, "jone")), level=2, slide_filter=["tumor_001"])
    assert _rows(one) == _rows(jone) and {r.slide for r in one} == {"tumor_001"}
    # no slide: an empty manifest and a warning
    empty = extract.extract_patches(DataConfig(data_dir=str(tmp_path / "none")),
                                    level=3, device=CPU)
    assert len(empty) == 0


def test_numpy_manifest_round_trip_without_pyarrow(case, tmp_path, monkeypatch):
    root = _case_copy(case, tmp_path)
    data = DataConfig(data_dir=root)
    jm = jextract.extract_patches(JDataConfig(data_dir=_case_copy(
        case, tmp_path, "j")), level=3, stride=56)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    assert not manifest.pyarrow_available()
    assert manifest.level_manifest_path(data.patches_dir, 3).endswith(".npz")
    pm = extract.extract_patches(data, level=3, stride=56, device=CPU)
    assert os.path.exists(manifest.manifest_npz_path(data.patches_dir, 3))
    assert not os.path.exists(manifest.manifest_path(data.patches_dir, 3))
    loaded = manifest.load_or_scan_manifest(data.patches_dir, 3)
    assert _rows(loaded) == _rows(pm) == _rows(jm)
    assert [r.path for r in loaded] == [r.path for r in pm]
    # the idempotent skip reads the numpy manifest back
    seen = []
    extract.extract_patches(data, level=3, stride=56, device=CPU,
                            on_slide=lambda n, r: seen.append(len(r)))
    assert seen == [sum(r.slide == s for r in pm)
                    for s in ("normal_001", "tumor_001")]
    assert manifest.patches_extracted(data, 3)


def test_rasterizers_disagree_on_a_tip_pixel_in_both_packages(tmp_path):
    """The reference labels a cell on the host route from PIL's mask and on
    the device route from its own rasterizer, which marks outline pixels
    only on rows an edge crosses (y0 <= y < y1), so never a polygon's
    bottom tip. A polygon whose tip alone reaches into the next row of
    cells makes that cell tumor on the host route and normal on the device
    route, in both packages."""
    from ss25_hierarchical_multiscale_image_classification_tpu.io.annotations import (
        write_annotation_xml,
    )

    spec = jsynthetic.SyntheticSlideSpec(width=3584, height=3584,
                                         tissue_radii=(0.49, 0.49), seed=5)
    root = str(tmp_path)
    slide_path = jsynthetic.write_synthetic_case(root, "tumor_002", spec)
    xml = os.path.join(root, "annotations", "tumor_002.xml")
    # at level 3 (scale 1/8): a triangle over rows 150..224 whose tip
    # (300, 224) is the only pixel in the cell at (224, 224)
    write_annotation_xml(xml, [np.array([[2240.0, 1200.0], [2560.0, 1200.0],
                                         [2400.0, 1792.0]])])
    run = {
        "host": lambda d: extract.extract_patches_for_slide(
            slide_path, xml, 3, d),
        "device": lambda d: extract.extract_patches_for_slide(
            slide_path, xml, 3, d, impl="device", device=CPU),
        "jax_host": lambda d: jextract.extract_patches_for_slide(
            slide_path, xml, 3, d),
        "jax_device": lambda d: jextract.extract_patches_for_slide(
            slide_path, xml, 3, d, impl="device"),
    }
    labels = {k: {(r.x, r.y): r.label for r in f(str(tmp_path / k))}
              for k, f in run.items()}
    assert labels["host"] == labels["jax_host"]
    assert labels["device"] == labels["jax_device"]
    assert len(labels["host"]) == 4 and set(labels["host"]) == set(labels["device"])
    differ = sorted(c for c in labels["host"]
                    if labels["host"][c] != labels["device"][c])
    assert differ == [(224, 224)]
    assert labels["host"][(224, 224)] == 1 and labels["host"][(224, 0)] == 1
