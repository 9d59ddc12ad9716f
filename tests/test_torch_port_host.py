"""The port's copies of the JAX package's host code equal the originals.

The port loads nothing of the JAX package, so it carries copies of the
constants, the patch grid, the ``.wsi.npz`` reader and the numpy synthetic
slide it needs. Each copy must give exactly what the original gives on the
same inputs.
"""

import dataclasses
import logging

import numpy as np
import pytest

import ss25_hierarchical_multiscale_image_classification_tpu.config as jconfig
from ss25_hierarchical_multiscale_image_classification_tpu.grid import (
    pyramid as jpyramid,
)
from ss25_hierarchical_multiscale_image_classification_tpu.io import slide as jslide
from ss25_hierarchical_multiscale_image_classification_tpu.io import (
    synthetic as jsynthetic,
)
import ss25_hierarchical_multiscale_image_classification_tpu_torch.config as pconfig
from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid import (
    pyramid as ppyramid,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io import slide as pslide
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io import (
    tiff_slide as ptiff,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io import (
    synthetic as psynthetic,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    Timer,
    get_logger,
)

from torch_port_native import load_jax_native_lib


@pytest.fixture(autouse=True, scope="session")
def _jax_native_lib():
    """The JAX TIFF code's library, built or loaded under the workers' lock
    before any test here reaches it (``tests/torch_port_native.py``)."""
    load_jax_native_lib()


def test_config_constants_equal_jax():
    for name in ("PATCH_SIZES", "TISSUE_MEAN_RGB_THRESHOLD",
                 "DETECTION_PROB_THRESHOLD", "IMAGENET_MEAN", "IMAGENET_STD"):
        assert getattr(pconfig, name) == getattr(jconfig, name), name
    assert pconfig.MODELS_DIR == jconfig.Config().models_dir


def test_mil_config_copies_equal_jax():
    """Every field and default of ``MILConfig`` and ``UncertaintyConfig``;
    the ``TrainConfig``, ``DataConfig`` and ``Config`` fields MIL reads."""
    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]  # noqa: E731
    assert fields(pconfig.MILConfig) == fields(jconfig.MILConfig)
    assert fields(pconfig.UncertaintyConfig) == fields(jconfig.UncertaintyConfig)
    jtrain = dict(fields(jconfig.TrainConfig))
    assert all(jtrain[name] == value
               for name, value in fields(pconfig.TrainConfig))
    jdata = dict(fields(jconfig.DataConfig))
    assert all(jdata[name] == value for name, value in fields(pconfig.DataConfig))
    for data_dir in ("data", "/x/y"):
        assert (pconfig.DataConfig(data_dir=data_dir).features_dir
                == jconfig.DataConfig(data_dir=data_dir).features_dir)
    cfg, jcfg = pconfig.Config(), jconfig.Config()
    for name in ("mil", "uncertainty"):
        assert (dataclasses.asdict(getattr(cfg, name))
                == dataclasses.asdict(getattr(jcfg, name)))
    assert cfg.train.seed == jcfg.train.seed


@pytest.mark.parametrize("level,dims,downsample,stride", [
    (3, (1792, 1344), 8.0, 28),
    (3, (250, 130), 8.0, None),   # ragged right and bottom edges
    (2, (1000, 2100), 4.0, 112),
    (0, (5000, 3000), 1.0, None),
    (5, (77, 55), 32.0, 30),      # a level without its own patch size
])
def test_patch_grid_equal_jax(level, dims, downsample, stride):
    g = ppyramid.PatchGrid.for_slide_level(level, dims, downsample, stride)
    j = jpyramid.PatchGrid.for_slide_level(level, dims, downsample, stride)
    assert dataclasses.asdict(g) == dataclasses.asdict(j)
    for attr in ("padded_width", "padded_height", "nx", "ny", "num_patches"):
        assert getattr(g, attr) == getattr(j, attr), attr
    np.testing.assert_array_equal(g.coords_array(), j.coords_array())
    assert g.coords_array().dtype == j.coords_array().dtype
    for x, y in g.coords_array()[::7]:
        assert g.level0_origin(x, y) == j.level0_origin(x, y)
    assert ppyramid.padded_extent(dims[0], 224) == \
        jpyramid.padded_extent(dims[0], 224)


@pytest.mark.parametrize("spec_kw", [
    dict(width=512, height=384, seed=3),
    dict(width=640, height=300, num_levels=3, tissue_center=(0.3, 0.6),
         tissue_radii=(0.2, 0.5), seed=11, noise=20.0),
])
def test_synthetic_slide_equal_jax(spec_kw):
    slide = psynthetic.make_synthetic_slide(psynthetic.SyntheticSlideSpec(**spec_kw))
    jslide_, polys = jsynthetic.make_synthetic_slide(
        jsynthetic.SyntheticSlideSpec(**spec_kw))
    assert polys == []
    assert slide.level_count == jslide_.level_count
    assert slide.level_dimensions == jslide_.level_dimensions
    assert slide.level_downsamples == jslide_.level_downsamples
    for lv in range(slide.level_count):
        np.testing.assert_array_equal(slide.level_array(lv),
                                      jslide_.level_array(lv))


def test_npz_slide_reads_equal_jax(tmp_path):
    rng = np.random.default_rng(5)
    levels = jsynthetic.build_pyramid(
        rng.integers(0, 256, (200, 328, 3), dtype=np.uint8), 3)
    ppath, jpath = str(tmp_path / "p.wsi.npz"), str(tmp_path / "j.wsi.npz")
    pslide.save_npz_slide(ppath, levels)
    jslide.save_npz_slide(jpath, levels)
    with open(ppath, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    p, j = pslide.open_slide(jpath), jslide.open_slide(jpath)
    assert isinstance(p, pslide.Slide)
    assert p.level_dimensions == j.level_dimensions
    assert p.level_downsamples == j.level_downsamples
    assert p.properties == j.properties
    # in-bounds, straddling every edge, and wholly outside
    for loc, level, size in [((0, 0), 0, (328, 200)), ((40, 24), 1, (60, 70)),
                             ((-16, -8), 1, (50, 40)), ((300, 180), 0, (64, 64)),
                             ((250, 120), 2, (30, 30)), ((4000, 0), 0, (8, 8))]:
        np.testing.assert_array_equal(p.read_region(loc, level, size),
                                      j.read_region(loc, level, size))
    # a tiled TIFF of the same pyramid opens through both packages' readers
    tif = str(tmp_path / "x.tif")
    ptiff.write_pyramidal_tiff(tif, levels, tile_size=64)
    pt, jt = pslide.open_slide(tif), jslide.open_slide(tif)
    assert isinstance(pt, pslide.Slide)
    assert pt.level_dimensions == jt.level_dimensions == p.level_dimensions
    assert pt.level_downsamples == jt.level_downsamples
    assert pt.properties == jt.properties
    for loc, level, size in [((0, 0), 0, (328, 200)), ((40, 24), 1, (60, 70)),
                             ((-16, -8), 1, (50, 40)), ((300, 180), 0, (64, 64)),
                             ((250, 120), 2, (30, 30)), ((4000, 0), 0, (8, 8))]:
        got = pt.read_region(loc, level, size)
        np.testing.assert_array_equal(got, jt.read_region(loc, level, size))
        np.testing.assert_array_equal(got, p.read_region(loc, level, size))
    pt.close()
    jt.close()
    with pytest.raises(IOError):
        pslide.open_slide(str(tmp_path / "missing.tif"))
    with pytest.raises(ValueError):
        pslide.open_slide("x.png")


def test_logger_and_timer(caplog):
    log = get_logger("torch.test")
    assert log.name == "hipac.torch.test"
    assert logging.getLogger("hipac").handlers
    log.addHandler(caplog.handler)
    try:
        with Timer("stage", log) as t:
            pass
    finally:
        log.removeHandler(caplog.handler)
    assert t.elapsed >= 0.0
    assert "stage took" in caplog.text
