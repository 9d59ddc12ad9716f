"""The port's main path closed to FROC, against the JAX package.

The same numpy inputs go through the JAX functions and the port's copies:
the FROC evaluation (every function, equal on ``tests/test_froc_golden.py``'s
inputs and on random masks and detections; ``run_froc_evaluation`` on a CSV
and mask directory with a tumor and a normal case), the rasterizer (numpy
in the port, PIL in the JAX package: patch labels equal, differing pixels
counted and all within 1.5 px of a polygon edge), the host labelling, the
synthetic slide with tumor polygons and its mask, the stage gates, and the
command line's ``--predict_slide <dir> --run_evaluation``.
"""

import os

import importlib

import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu.evaluation import (
    froc as jfroc,
)
from ss25_hierarchical_multiscale_image_classification_tpu.grid import (
    rasterize as jr,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch import config
from ss25_hierarchical_multiscale_image_classification_tpu_torch.cli import (
    main as cli,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation import (
    froc,
    metrics,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid import (
    labeling,
    rasterize,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io import (
    download,
    synthetic,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
    save_npz_slide,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
    ResNet18Classifier,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
    save_model,
)

torch.set_num_threads(2)

RES, LEVEL = 0.243, 5
SCALE = 2 ** LEVEL


def _golden_mask():
    mask = np.zeros((64, 64), np.uint8)
    mask[5, 5:45] = 255
    mask[40, 40] = 255
    return mask


def _random_mask(seed, shape=(96, 80), blobs=5):
    rng = np.random.default_rng(seed)
    mask = np.zeros(shape, np.uint8)
    for _ in range(blobs):
        y, x = rng.integers(0, shape[0]), rng.integers(0, shape[1])
        h, w = rng.integers(1, 30, 2)
        mask[y:y + h, x:x + w] = 255
    return mask


def _detections(seed, shape, n=40):
    rng = np.random.default_rng(seed)
    probs = list(np.round(rng.uniform(0.05, 1.0, n), 3))
    xs = list(rng.integers(0, shape[1] * SCALE, n))
    ys = list(rng.integers(0, shape[0] * SCALE, n))
    return probs, xs, ys


def test_froc_constants_equal_jax():
    from ss25_hierarchical_multiscale_image_classification_tpu import (
        config as jconfig,
    )

    for name in ("EVALUATION_MASK_LEVEL", "L0_RESOLUTION_UM_PER_PX",
                 "FROC_ANNOTATION_EXPANSION_UM", "FROC_ITC_THRESHOLD_UM"):
        assert getattr(config, name) == getattr(jconfig, name), name


@pytest.mark.parametrize("mask", ["golden", 1, 2, 3])
def test_evaluation_mask_and_itc_equal_jax(mask):
    m = _golden_mask() if mask == "golden" else _random_mask(mask)
    ev = froc.compute_evaluation_mask(m, RES, LEVEL)
    want = jfroc.compute_evaluation_mask(m, RES, LEVEL)
    np.testing.assert_array_equal(ev, want)
    assert ev.dtype == want.dtype
    assert (froc.compute_itc_list(ev, RES, LEVEL)
            == jfroc.compute_itc_list(want, RES, LEVEL))
    # the three-channel form and a coarser level
    np.testing.assert_array_equal(
        froc.compute_evaluation_mask(np.stack([m] * 3, -1), RES, 4),
        jfroc.compute_evaluation_mask(np.stack([m] * 3, -1), RES, 4))


def test_major_axis_length_equal_jax():
    rng = np.random.default_rng(4)
    for coords in (np.zeros((0, 2)), np.array([[3.0, 7.0]]),
                   np.array([[0.0, 0.0], [0.0, 1.0], [0.0, 2.0]]),
                   rng.normal(size=(50, 2)) * [5, 1]):
        assert froc._major_axis_length(coords) == jfroc._major_axis_length(coords)


@pytest.mark.parametrize("seed,is_tumor", [(0, True), (1, True), (2, False)])
def test_fp_tp_probs_and_curve_equal_jax(seed, is_tumor):
    m = _golden_mask() if seed == 0 else _random_mask(seed)
    ev = froc.compute_evaluation_mask(m, RES, LEVEL)
    itc = froc.compute_itc_list(ev, RES, LEVEL)
    probs, xs, ys = _detections(seed, m.shape)
    got = froc.compute_fp_tp_probs(ys, xs, probs, is_tumor,
                                   ev if is_tumor else None, itc, LEVEL)
    want = jfroc.compute_fp_tp_probs(ys, xs, probs, is_tumor,
                                     ev if is_tumor else None, itc, LEVEL)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == want[1].dtype
    assert got[2:] == want[2:]
    data = {"fp_probs": [got[0], got[0][:3]], "tp_probs": [got[1], got[1]],
            "num_tumors": [got[2], got[2]]}
    fps, sens = froc.compute_froc(data)
    jfps, jsens = jfroc.compute_froc(data)
    np.testing.assert_array_equal(fps, jfps)
    np.testing.assert_array_equal(sens, jsens)
    assert froc.froc_score(fps, sens) == jfroc.froc_score(jfps, jsens)
    assert (froc.froc_score(fps, sens, (0.1, 3)) ==
            jfroc.froc_score(jfps, jsens, (0.1, 3)))


def test_read_csv_content_equal_jax(tmp_path):
    path = tmp_path / "d.csv"
    path.write_text("0.9,100,200\n\n0.25,3.7,4.2\n0.5,0,1\n")
    assert froc.read_csv_content(str(path)) == jfroc.read_csv_content(str(path))


def _eval_dirs(tmp_path):
    csv_dir, mask_dir = tmp_path / "csv", tmp_path / "mask"
    csv_dir.mkdir()
    mask_dir.mkdir()
    m = _random_mask(5)
    np.save(mask_dir / "tumor_001_mask.npy", m)
    for case, seed in (("tumor_001", 6), ("normal_001", 7)):
        probs, xs, ys = _detections(seed, m.shape, n=25)
        (csv_dir / f"{case}.csv").write_text("".join(
            f"{p},{x},{y}\n" for p, x, y in zip(probs, xs, ys)))
    return str(csv_dir), str(mask_dir)


def test_run_froc_evaluation_equal_jax(tmp_path):
    csv_dir, mask_dir = _eval_dirs(tmp_path)
    got = froc.run_froc_evaluation(csv_dir, mask_dir)
    want = jfroc.run_froc_evaluation(csv_dir, mask_dir)
    assert got.keys() == want.keys()
    assert got["names"] == want["names"] == ["normal_001", "tumor_001"]
    assert got["num_tumors"] == want["num_tumors"]
    assert got["fp_probs"] == want["fp_probs"]
    for a, b in zip(got["tp_probs"], want["tp_probs"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["fps_per_image"], want["fps_per_image"])
    np.testing.assert_array_equal(got["sensitivity"], want["sensitivity"])
    assert got["score"] == want["score"]
    assert 0.0 <= got["score"] <= 1.0


def test_run_froc_evaluation_reads_a_slide_mask(tmp_path):
    """A mask as a ``.wsi.npz`` slide container, read through the port's
    slide reader at the evaluation level."""
    csv_dir, mask_dir = _eval_dirs(tmp_path)
    m = np.load(os.path.join(mask_dir, "tumor_001_mask.npy"))
    os.remove(os.path.join(mask_dir, "tumor_001_mask.npy"))
    levels = [np.zeros((4, 4, 3), np.uint8)] * LEVEL + [np.stack([m] * 3, -1)]
    save_npz_slide(os.path.join(mask_dir, "tumor_001_Mask.wsi.npz"), levels)
    got = froc.run_froc_evaluation(csv_dir, mask_dir)
    want = jfroc.run_froc_evaluation(csv_dir, mask_dir)
    assert got["score"] == want["score"]
    assert got["num_tumors"] == want["num_tumors"] and got["num_tumors"][1] > 0


def test_plot_froc_writes_or_skips(tmp_path, monkeypatch):
    fps, sens = np.array([2.0, 1.0, 0.0]), np.array([1.0, 0.5, 0.0])
    path = tmp_path / "froc.png"
    froc.plot_froc(fps, sens, str(path))
    assert path.exists()
    # without matplotlib: skipped, no error
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kw):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    froc.plot_froc(fps, sens, str(tmp_path / "none.png"))
    assert not (tmp_path / "none.png").exists()


def test_metrics_equal_jax():
    from ss25_hierarchical_multiscale_image_classification_tpu.evaluation import (
        metrics as jmetrics,
    )

    rng = np.random.default_rng(8)
    for n in (0, 1, 50):
        y, p = rng.integers(0, 2, n), rng.integers(0, 2, n)
        got = metrics.classification_report(y, p)
        want = jmetrics.classification_report(y, p)
        np.testing.assert_array_equal(got.pop("confusion_matrix"),
                                      want.pop("confusion_matrix"))
        assert got == want
    y, p = rng.integers(0, 3, 30), rng.integers(0, 3, 30)
    np.testing.assert_array_equal(metrics.confusion_matrix(y, p),
                                  jmetrics.confusion_matrix(y, p))


# ---------------------------------------------------------------------------
# rasterizer, labelling, synthetic tumor slides
# ---------------------------------------------------------------------------


def _segment_distance(px, py, poly):
    best = np.full(px.shape, np.inf)
    for i in range(len(poly)):
        a, b = poly[i], poly[(i + 1) % len(poly)]
        d = b - a
        t = np.clip(((px - a[0]) * d[0] + (py - a[1]) * d[1]) / (d @ d), 0, 1)
        best = np.minimum(best, np.hypot(px - a[0] - t * d[0],
                                         py - a[1] - t * d[1]))
    return best


def _polygons(seed, w, h):
    """The default tumor polygon and two random star-shaped ones, in
    level-0 pixels."""
    rng = np.random.default_rng(seed)
    polys = [np.array([(x * w, y * h)
                       for x, y in synthetic._default_tumor_polygon()])]
    for _ in range(2):
        k = rng.integers(3, 9)
        c, r = rng.uniform(0.3, 0.7, 2), rng.uniform(0.05, 0.2)
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        polys.append(np.stack([(c[0] + r * np.cos(ang) * rng.uniform(0.5, 1, k)) * w,
                               (c[1] + r * np.sin(ang) * rng.uniform(0.5, 1, k)) * h],
                              1))
    return polys


# The numpy fill against PIL's: PIL rounds fractional vertices and draws its
# outline by its own line rule, so the two differ in pixels along the edges
# only. Measured over these cases: every differing pixel's centre within
# 1.46 px of the nearest edge (the default polygon at 1024x768: 190 pixels at
# integer vertices, all of them PIL's outline missing from neither side).
EDGE_BAND_PX = 1.5


@pytest.mark.parametrize("w,h,seed", [(1024, 768, 0), (777, 555, 1),
                                      (3584, 2688, 2)])
def test_rasterizer_differs_from_pil_only_along_edges(w, h, seed):
    for poly in _polygons(seed, w, h):
        for lvl in (0, 2, 3):
            dims = (w >> lvl, h >> lvl)
            got = rasterize.polygons_to_mask([poly], dims, (w, h))
            want = jr.polygons_to_mask([poly], dims, (w, h))
            assert got.dtype == np.uint8 and got.shape == want.shape
            assert set(np.unique(got)) <= {0, 255}
            yy, xx = np.nonzero(got != want)
            scaled = rasterize.scale_polygons([poly], dims, (w, h))[0]
            if len(yy):
                assert _segment_distance(xx.astype(float), yy.astype(float),
                                         scaled.astype(float)).max() <= EDGE_BAND_PX
            assert len(yy) <= 2 * (dims[0] + dims[1])  # a band, not an area


@pytest.mark.parametrize("w,h,level,stride", [(3584, 2688, 2, None),
                                              (3584, 2688, 3, 56),
                                              (2600, 1900, 3, 100),
                                              (1800, 3400, 2, 224)])
def test_patch_labels_equal_pil_labels(w, h, level, stride):
    """Patch labels through ``patch_labels_from_mask_host`` from the numpy
    and the PIL mask, on non-square grids: equal."""
    from ss25_hierarchical_multiscale_image_classification_tpu.grid import (
        labeling as jlabeling,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.pyramid import (
        PatchGrid,
    )

    polys = _polygons(level + w, w, h)
    dims = (w >> level, h >> level)
    grid = PatchGrid.for_slide_level(level, dims, 2.0 ** level, stride)
    coords = grid.coords_array()
    labels = []
    for mask, lab in ((rasterize.polygons_to_mask(polys, dims, (w, h)),
                       labeling),
                      (jr.polygons_to_mask(polys, dims, (w, h)), jlabeling)):
        padded = np.zeros((grid.padded_height, grid.padded_width), np.uint8)
        padded[:mask.shape[0], :mask.shape[1]] = mask
        labels.append(lab.patch_labels_from_mask_host(padded, coords,
                                                      grid.patch_size))
    np.testing.assert_array_equal(labels[0], labels[1])
    assert 0 < labels[0].sum() < len(labels[0])


def test_scale_polygons_and_band_equal_jax():
    polys = _polygons(3, 3000, 2000)
    for dims in ((3000, 2000), (375, 250), (93, 62)):
        for a, b in zip(rasterize.scale_polygons(polys, dims, (3000, 2000)),
                        jr.scale_polygons(polys, dims, (3000, 2000))):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    full = rasterize.polygons_to_mask(polys, (750, 500), (3000, 2000))
    # windows of the mask equal its crops, at any offset
    for x0, y0, bw, bh in ((0, 100, 750, 64), (137, 211, 90, 70),
                           (700, 480, 100, 100)):
        band = rasterize.polygons_to_mask_band(polys, (750, 500), (3000, 2000),
                                               x0, y0, bw, bh)
        np.testing.assert_array_equal(band, full[y0:y0 + bh, x0:x0 + bw])
    assert rasterize.polygons_to_mask_band(polys, (750, 500), (3000, 2000),
                                           800, 0).shape == (500, 0)


def test_labeling_host_functions_equal_jax():
    from ss25_hierarchical_multiscale_image_classification_tpu.grid import (
        labeling as jlabeling,
    )

    rng = np.random.default_rng(9)
    assert labeling.LABEL_NAMES == jlabeling.LABEL_NAMES
    assert (labeling.LABEL_NORMAL, labeling.LABEL_TUMOR) == (
        jlabeling.LABEL_NORMAL, jlabeling.LABEL_TUMOR)
    for mean in (100, 239.5, 240, 240.5, 250):
        patch = np.full((8, 8, 3), mean)
        assert labeling.is_tissue_host(patch) == jlabeling.is_tissue_host(patch)
    mask = _random_mask(9, (120, 200))
    coords = rng.integers(0, 150, (30, 2))
    for m in (mask, None):
        got = labeling.patch_labels_from_mask_host(m, coords, 16)
        want = jlabeling.patch_labels_from_mask_host(m, coords, 16)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_synthetic_spec_helpers_equal_jax():
    from ss25_hierarchical_multiscale_image_classification_tpu.io import (
        synthetic as jsynthetic,
    )
    import dataclasses

    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]  # noqa: E731
    assert fields(synthetic.SyntheticSlideSpec) == fields(jsynthetic.SyntheticSlideSpec)
    assert synthetic._default_tumor_polygon() == jsynthetic._default_tumor_polygon()
    assert (dataclasses.asdict(synthetic.tumor_spec(width=300, seed=4))
            == dataclasses.asdict(jsynthetic.tumor_spec(width=300, seed=4)))
    assert (dataclasses.asdict(synthetic.normal_spec(height=200))
            == dataclasses.asdict(jsynthetic.normal_spec(height=200)))


# A slide with polygons: equal to the JAX render but for pixels within 1.5 px
# of a polygon edge, where the numpy fill and PIL's differ (measured: 415 of
# 786,432 level-0 pixels at 1024x768 "tint", 206 at 512x384, 409 with the
# texture).
@pytest.mark.parametrize("spec_kw", [
    dict(width=1024, height=768, seed=1),
    dict(width=512, height=384, seed=3, tissue_radii=(0.45, 0.45)),
    dict(width=1024, height=768, seed=2, tumor_style="texture"),
])
def test_synthetic_tumor_slide_equals_jax_off_the_edges(spec_kw):
    from ss25_hierarchical_multiscale_image_classification_tpu.io import (
        synthetic as jsynthetic,
    )

    img, polys = synthetic.make_level0(synthetic.tumor_spec(**spec_kw))
    jimg, jpolys = jsynthetic.make_level0(jsynthetic.tumor_spec(**spec_kw))
    assert len(polys) == len(jpolys) == 1
    np.testing.assert_array_equal(polys[0], jpolys[0])
    assert img.dtype == jimg.dtype and img.shape == jimg.shape
    yy, xx = np.nonzero((img != jimg).any(axis=-1))
    assert 0 < len(yy) <= 2 * (img.shape[0] + img.shape[1])
    assert _segment_distance(xx.astype(float), yy.astype(float),
                             polys[0]).max() <= EDGE_BAND_PX
    slide = synthetic.make_synthetic_slide(synthetic.tumor_spec(**spec_kw))
    jslide, _ = jsynthetic.make_synthetic_slide(jsynthetic.tumor_spec(**spec_kw))
    assert slide.level_dimensions == jslide.level_dimensions
    # the tumor is darker: a tumor cell's mean is far below a normal one's
    mm = rasterize.fill_polygons(polys, img.shape[1], img.shape[0])
    if spec_kw.get("tumor_style", "tint") == "tint":
        assert img[mm].mean() < img[~mm & (img.mean(-1) < 240)].mean() - 30


def test_write_mask_npy_is_the_level5_mask(tmp_path):
    spec = synthetic.tumor_spec(width=4096, height=3072, seed=0)
    path = synthetic.write_mask_npy(str(tmp_path), "tumor_007", spec)
    assert path == str(tmp_path / "tumor_007_mask.npy")
    mask = np.load(path)
    assert mask.shape == (96, 128) and mask.dtype == np.uint8
    want = jr.polygons_to_mask(synthetic.polygons_level0(spec), (128, 96),
                               (4096, 3072))
    assert ((mask > 0) != (want > 0)).sum() <= 2 * (96 + 128)
    # a region the evaluation keeps (not an ITC)
    ev = froc.compute_evaluation_mask(mask)
    assert ev.max() == 1 and froc.compute_itc_list(ev) == []


def test_list_slides_and_images_downloaded_equal_jax(tmp_path):
    from ss25_hierarchical_multiscale_image_classification_tpu import (
        config as jconfig,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu.data import (
        extract as jextract,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu.io import (
        download as jdownload,
    )

    data = config.DataConfig(data_dir=str(tmp_path))
    jdata = jconfig.DataConfig(data_dir=str(tmp_path))
    assert data.train_img_dir == jdata.train_img_dir
    assert data.test_img_dir == jdata.test_img_dir
    assert not download.images_downloaded(data)
    assert not jdownload.images_downloaded(jdata)
    os.makedirs(data.train_img_dir)
    assert not download.images_downloaded(data)
    for name in ("b.tif", "a.wsi.npz", "c.tiff", "notes.txt", "d.npz"):
        open(os.path.join(data.train_img_dir, name), "w").close()
    assert (download.list_slides(data.train_img_dir)
            == jextract.list_slides(jdata.train_img_dir))
    assert [n for n, _ in download.list_slides(data.train_img_dir)] == [
        "a", "b", "c"]
    assert download.images_downloaded(data) and jdownload.images_downloaded(jdata)
    assert download.list_slides(str(tmp_path / "none")) == []


# ---------------------------------------------------------------------------
# the command line: --predict_slide <dir> --run_evaluation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def eval_root(tmp_path_factory):
    """A data root with a tumor slide (and its level-5 mask) and a normal
    slide under test/img, and a random classifier."""
    root = tmp_path_factory.mktemp("froc_cli")
    img_dir = root / "data" / "test" / "img"
    img_dir.mkdir(parents=True)
    for name, spec in (
            ("tumor_001", synthetic.tumor_spec(width=4096, height=3072, seed=1)),
            ("normal_001", synthetic.normal_spec(width=4096, height=3072,
                                                 seed=2))):
        slide = synthetic.make_synthetic_slide(spec)
        save_npz_slide(str(img_dir / f"{name}.wsi.npz"),
                       [slide.level_array(i) for i in range(slide.level_count)])
        if spec.tumor_polygons:
            synthetic.write_mask_npy(str(root / "data" / "test" / "mask"), name,
                                     spec)
    (img_dir / "readme.txt").write_text("not a slide")
    save_model(str(root / "models" / "resnet18_patch_classifier"),
               ResNet18Classifier(num_filters=8).state_dict())
    return root


def _cli_args(root, *extra):
    return ["--data_dir", str(root / "data"), "--models_dir",
            str(root / "models"), "--device", "cpu", "--batch_size", "16",
            "--stride", "112", *extra]


def test_predict_slide_dir_then_run_evaluation(eval_root):
    csv_dir = eval_root / "models" / "model_predictions_csv"
    rc = cli.main(["--predict_slide", str(eval_root / "data" / "test" / "img"),
                   "--run_evaluation", *_cli_args(eval_root)])
    assert rc == 0
    assert sorted(os.listdir(csv_dir)) == ["normal_001.csv", "tumor_001.csv"]
    result = froc.run_froc_evaluation(
        str(csv_dir), str(eval_root / "data" / "test" / "mask"))
    want = jfroc.run_froc_evaluation(
        str(csv_dir), str(eval_root / "data" / "test" / "mask"))
    assert result["score"] == want["score"] and 0.0 <= result["score"] <= 1.0
    assert result["num_tumors"] == [0, 1]


def test_predict_slide_dir_without_slides_exits_1(tmp_path, eval_root):
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "x.txt").write_text("")
    assert cli.main(["--predict_slide", str(empty),
                     *_cli_args(eval_root)]) == 1


@pytest.mark.parametrize("missing", ["mask", "csv"])
def test_run_evaluation_exit_codes(tmp_path, missing):
    """Exit 1 without the mask folder or the CSV folder, as the JAX CLI."""
    data, models = tmp_path / "data", tmp_path / "models"
    if missing == "csv":
        (data / "test" / "mask").mkdir(parents=True)
    else:
        (models / "model_predictions_csv").mkdir(parents=True)
    argv = ["--run_evaluation", "--data_dir", str(data), "--models_dir",
            str(models)]
    # the package's ``cli`` exports the function ``main`` over the module
    jcli = importlib.import_module(
        "ss25_hierarchical_multiscale_image_classification_tpu.cli.main")
    assert cli.main(argv + ["--device", "cpu"]) == 1
    assert jcli.main(argv) == 1
    # with both folders present it runs
    (data / "test" / "mask").mkdir(parents=True, exist_ok=True)
    (models / "model_predictions_csv").mkdir(parents=True, exist_ok=True)
    (models / "model_predictions_csv" / "normal_001.csv").write_text("0.5,1,1\n")
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert jcli.main(argv) == 0
