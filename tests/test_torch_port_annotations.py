"""The port's ASAP annotation XML parser and writer (ElementTree) against
the JAX package's (lxml): each package parses what the other writes into
equal polygons, malformed XML gives ``[]``, a bad coordinate is skipped
with a warning, both XPath branches are taken in document order, and
``write_synthetic_case`` writes a slide and an XML the JAX package reads.
"""

import logging
import os

import numpy as np
import pytest

from ss25_hierarchical_multiscale_image_classification_tpu.io import (
    annotations as jann,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io import (
    annotations as pann,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)

from torch_port_native import load_jax_native_lib

pytest.importorskip("lxml")


@pytest.fixture(autouse=True, scope="session")
def _jax_native_lib():
    """The JAX TIFF code's library, built or loaded under the workers' lock
    before any test here reaches it (``tests/torch_port_native.py``)."""
    load_jax_native_lib()


def _polygons(seed: int, n_polys: int, max_vertices: int = 40):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-50.0, 5000.0, (int(rng.integers(1, max_vertices)), 2))
            for _ in range(n_polys)]


def _equal(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype == np.float64 and np.array_equal(x, y)
        for x, y in zip(a, b))


@pytest.mark.parametrize("seed,n_polys", [(0, 1), (1, 3), (2, 7), (3, 0)])
def test_each_package_parses_what_the_other_writes(tmp_path, seed, n_polys):
    polys = _polygons(seed, n_polys)
    pxml, jxml = str(tmp_path / "p.xml"), str(tmp_path / "j.xml")
    pann.write_annotation_xml(pxml, polys)
    jann.write_annotation_xml(jxml, polys)
    ref = jann.parse_annotation_xml(jxml)
    assert len(ref) == n_polys
    for xml in (pxml, jxml):
        assert _equal(pann.parse_annotation_xml(xml), ref)
        assert _equal(jann.parse_annotation_xml(xml), ref)
    # the writer's %.4f coordinates
    for got, want in zip(ref, polys):
        np.testing.assert_array_equal(
            got, np.array([[float(f"{v:.4f}") for v in row] for row in want]))


def test_group_name_round_trips(tmp_path):
    polys = _polygons(4, 2)
    path = str(tmp_path / "g.xml")
    pann.write_annotation_xml(path, polys, group="_0")
    assert _equal(jann.parse_annotation_xml(path), pann.parse_annotation_xml(path))
    assert 'PartOfGroup="_0"' in open(path).read()


@pytest.mark.parametrize("text", [
    "",
    "<ASAP_Annotations><Annotations>",
    "<a><b></a>",
    "not xml at all",
])
def test_malformed_xml_gives_no_polygons(tmp_path, text):
    path = str(tmp_path / "bad.xml")
    with open(path, "w") as f:
        f.write(text)
    assert pann.parse_annotation_xml(path) == []
    assert jann.parse_annotation_xml(path) == []


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def test_bad_coordinate_is_skipped_with_a_warning(tmp_path):
    path = str(tmp_path / "c.xml")
    with open(path, "w") as f:
        f.write("""<?xml version="1.0"?>
<ASAP_Annotations><Annotations>
 <Annotation Name="a"><Coordinates>
  <Coordinate Order="0" X="1.5" Y="2.5"/>
  <Coordinate Order="1" X="abc" Y="3"/>
  <Coordinate Order="2" Y="4"/>
  <Coordinate Order="3" X=" 7.25 " Y="1e3"/>
 </Coordinates></Annotation>
 <Annotation Name="b"><Coordinates>
  <Coordinate Order="0" X="x" Y="y"/>
 </Coordinates></Annotation>
</Annotations></ASAP_Annotations>""")
    handler = _Records()
    logger = get_logger("io.annotations")
    logger.addHandler(handler)
    try:
        got = pann.parse_annotation_xml(path)
    finally:
        logger.removeHandler(handler)
    assert _equal(got, jann.parse_annotation_xml(path))
    assert len(got) == 1  # the all-bad polygon is dropped
    np.testing.assert_array_equal(got[0], [[1.5, 2.5], [7.25, 1000.0]])
    assert len(handler.records) == 3


def test_both_xpath_branches_in_document_order(tmp_path):
    """``//Annotation/Coordinates`` anywhere (nested, outside
    ``Annotations``), in document order, without duplicates; a
    ``Coordinates`` whose parent is no ``Annotation`` is not read."""
    path = str(tmp_path / "x.xml")
    with open(path, "w") as f:
        f.write("""<?xml version="1.0"?>
<Root>
 <Annotation><Coordinates><Coordinate X="1" Y="1"/></Coordinates>
  <Group><Annotation><Coordinates><Coordinate X="2" Y="2"/></Coordinates>
  </Annotation></Group>
  <Coordinates><Coordinate X="3" Y="3"/></Coordinates>
 </Annotation>
 <Annotations><Annotation><Coordinates><Coordinate X="4" Y="4"/>
 </Coordinates></Annotation></Annotations>
 <Other><Coordinates><Coordinate X="9" Y="9"/></Coordinates></Other>
 <Coordinates><Coordinate X="8" Y="8"/></Coordinates>
</Root>""")
    got = pann.parse_annotation_xml(path)
    assert _equal(got, jann.parse_annotation_xml(path))
    assert [float(p[0, 0]) for p in got] == [1.0, 2.0, 3.0, 4.0]


def test_synthetic_case_is_read_by_the_jax_package(tmp_path):
    from ss25_hierarchical_multiscale_image_classification_tpu.io.slide import (
        open_slide as jopen,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io import (
        synthetic,
    )

    spec = synthetic.tumor_spec(width=256, height=192, seed=3)
    path = synthetic.write_synthetic_case(str(tmp_path), "tumor_009", spec)
    assert path == os.path.join(str(tmp_path), "train", "img",
                                "tumor_009.wsi.npz")
    slide = jopen(path)
    level0, polys = synthetic.make_level0(spec)
    np.testing.assert_array_equal(slide.level_array(0), level0)
    assert slide.level_count == spec.num_levels
    xml = os.path.join(str(tmp_path), "annotations", "tumor_009.xml")
    parsed = jann.parse_annotation_xml(xml)
    assert len(parsed) == len(polys)
    for got, want in zip(parsed, polys):
        np.testing.assert_allclose(got, want, atol=5e-5)
    # a normal slide writes no XML
    synthetic.write_synthetic_case(str(tmp_path), "normal_009",
                                   synthetic.normal_spec(width=64, height=48))
    assert not os.path.exists(os.path.join(str(tmp_path), "annotations",
                                           "normal_009.xml"))
    # the tiled BigTIFF container: the JAX package decodes the same pyramid
    tif = synthetic.write_synthetic_case(str(tmp_path / "tif"), "t", spec,
                                         container="tiff")
    assert tif == os.path.join(str(tmp_path / "tif"), "train", "img", "t.tif")
    tslide = jopen(tif)
    levels = synthetic.build_pyramid(level0, spec.num_levels)
    assert tslide.level_count == spec.num_levels
    for lv, want in enumerate(levels):
        np.testing.assert_array_equal(
            tslide.read_region((0, 0), lv, tslide.level_dimensions[lv]), want)
    tslide.close()
    assert len(jann.parse_annotation_xml(os.path.join(
        str(tmp_path / "tif"), "annotations", "t.xml"))) == len(polys)
    with pytest.raises(ValueError):
        synthetic.write_synthetic_case(str(tmp_path), "t", spec,
                                       container="zarr")
