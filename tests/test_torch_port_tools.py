"""The port's slide-facing tools against the JAX package's, on the CPU.

- ``infer/overlay.py::render_overlay`` and ``--overlay`` on one slide, a
  directory and the multiscale path: the JAX function's image on the same
  grid, from ``.wsi.npz`` and TIFF slides alike, and with matplotlib's
  import blocked too (the rainbow colormap is a numpy table);
- ``visualization/wsi_viz.py::visualize_and_save_wsi`` and ``--wsi_viz``:
  the JAX package's artifacts;
- the five functions of ``utils/structure.py`` on the same trees: the same
  results, files and warnings;
- the new flags' exit codes and order against the JAX CLI's.

Pillow and matplotlib are installed here; the card's machine lacks
matplotlib, and there ``--wsi_viz``'s figure raises.
"""

import importlib
import logging
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu.infer import (
    overlay as joverlay,
)
from ss25_hierarchical_multiscale_image_classification_tpu.io import (
    tiff_slide as jtiff,
)
from ss25_hierarchical_multiscale_image_classification_tpu.utils import (
    structure as jstructure,
)
from ss25_hierarchical_multiscale_image_classification_tpu.visualization import (
    wsi_viz as jwsi,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.cli import (
    main as cli,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    DataConfig,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer import (
    overlay,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
    predict_slide,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
    open_slide,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.utils import (
    structure,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.visualization import (
    visualize_and_save_wsi,
)

from torch_port_native import load_jax_native_lib

torch.set_num_threads(2)

pytest.importorskip("matplotlib")
pytest.importorskip("PIL")


@pytest.fixture(autouse=True, scope="session")
def _jax_native_lib():
    """The JAX TIFF code's library, built or loaded under the workers' lock
    before any test here reaches it (``tests/torch_port_native.py``)."""
    load_jax_native_lib()


@pytest.fixture(scope="module")
def jcli():
    # the JAX package's ``cli`` exports the function ``main`` over the module
    return importlib.import_module(
        "ss25_hierarchical_multiscale_image_classification_tpu.cli.main")


@pytest.fixture(scope="module")
def slides(synthetic_case, tmp_path_factory):
    """The conftest's JAX-written slides, and the tumor slide as a TIFF."""
    img = os.path.join(synthetic_case, "train", "img")
    tif = str(tmp_path_factory.mktemp("tif") / "tumor_001.tif")
    npz = open_slide(os.path.join(img, "tumor_001.wsi.npz"))
    jtiff.write_pyramidal_tiff(tif, [npz.level_array(i)
                                     for i in range(npz.level_count)])
    return {"tumor": os.path.join(img, "tumor_001.wsi.npz"),
            "normal": os.path.join(img, "normal_001.wsi.npz"),
            "tif": tif, "root": synthetic_case}


def _png(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


# ---------------------------------------------------------------------------
# overlays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("display_level,predict_level,stride", [
    (None, None, None), (2, 3, 112), (1, 2, 448), (3, 3, 56)])
def test_render_overlay_equals_jax(slides, tmp_path, display_level,
                                   predict_level, stride):
    grid = np.random.default_rng(3).random((6, 8)).astype(np.float32)
    kw = dict(display_level=display_level, predict_level=predict_level,
              stride=stride)
    got = overlay.render_overlay(slides["tumor"], grid, save_path=str(
        tmp_path / "p" / "o.png"), **kw)
    want = joverlay.render_overlay(slides["tumor"], grid, save_path=str(
        tmp_path / "j" / "o.png"), **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_png(tmp_path / "p" / "o.png"),
                                  _png(tmp_path / "j" / "o.png"))
    # an open slide and a TIFF of the same pyramid give the same image
    slide = open_slide(slides["tif"])
    np.testing.assert_array_equal(overlay.render_overlay(slide, grid, **kw),
                                  got)
    slide.close()


def test_render_overlay_without_matplotlib_equals_jax(slides, monkeypatch):
    grid = np.random.default_rng(4).random((6, 8)).astype(np.float32)
    grid[0, 0], grid[1, 1] = np.nan, 1.5
    want = joverlay.render_overlay(slides["tumor"], grid)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.cm", None)
    np.testing.assert_array_equal(
        overlay.render_overlay(slides["tumor"], grid), want)


@pytest.fixture(scope="module")
def models_dir(tmp_path_factory):
    """An 8-wide ResNet18 from a seed as ``resnet18_patch_classifier.pt``,
    and a seeded multiscale classifier as ``hierarchical_classifier.pt``."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.hierarchical import (
        HierarchicalPatchClassifier,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
        ResNet18Classifier,
    )

    d = tmp_path_factory.mktemp("models")
    model = ResNet18Classifier(num_filters=8,
                               generator=torch.Generator().manual_seed(5))
    torch.save(model.state_dict(), str(d / "resnet18_patch_classifier.pt"))
    ms = HierarchicalPatchClassifier(generator=torch.Generator().manual_seed(6))
    torch.save(ms.state_dict(), str(d / "hierarchical_classifier.pt"))
    return d, model.eval()


def _fresh_models(models_dir, tmp_path):
    d = tmp_path / "models"
    shutil.copytree(models_dir[0], d)
    return d


@pytest.mark.parametrize("kind", ["tumor", "tif"])
def test_overlay_cli_one_slide_equals_jax_render(slides, models_dir, tmp_path,
                                                 kind):
    d = _fresh_models(models_dir, tmp_path)
    argv = ["--predict_slide", slides[kind], "--overlay", "--stride", "112",
            "--models_dir", str(d), "--device", "cpu"]
    assert cli.main(argv) == 0
    out = d / "overlays" / (os.path.basename(slides[kind]) + ".overlay.png")
    grid, _ = predict_slide(slides[kind], models_dir[1], level=3, stride=112,
                            device="cpu")
    want = joverlay.render_overlay(slides["tumor"], grid, predict_level=3,
                                   stride=112)
    np.testing.assert_array_equal(_png(out), want)


def test_overlay_cli_directory_writes_one_a_slide(slides, models_dir,
                                                  tmp_path):
    d = _fresh_models(models_dir, tmp_path)
    img = tmp_path / "img"
    img.mkdir()
    os.link(slides["tif"], img / "tumor_001.tif")
    os.link(slides["normal"], img / "normal_001.wsi.npz")
    assert cli.main(["--predict_slide", str(img), "--overlay", "--models_dir",
                     str(d), "--device", "cpu"]) == 0
    assert sorted(os.listdir(d / "overlays")) == [
        "normal_001.wsi.npz.overlay.png", "tumor_001.tif.overlay.png"]
    grid, _ = predict_slide(str(img / "normal_001.wsi.npz"), models_dir[1],
                            level=3, device="cpu")
    np.testing.assert_array_equal(
        _png(d / "overlays" / "normal_001.wsi.npz.overlay.png"),
        joverlay.render_overlay(slides["normal"], grid, predict_level=3))


def test_overlay_cli_multiscale_equals_jax_render(slides, models_dir,
                                                  tmp_path):
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.multiscale import (
        predict_slide_multiscale,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        hierarchical_from_state_dict,
    )

    d = _fresh_models(models_dir, tmp_path)
    argv = ["--predict_slide", slides["tif"], "--multiscale", "--overlay",
            "--batch_size", "4", "--models_dir", str(d), "--device", "cpu"]
    assert cli.main(argv) == 0
    out = d / "overlays" / "tumor_001.tif.overlay.png"
    model = hierarchical_from_state_dict(
        torch.load(str(d / "hierarchical_classifier.pt")))
    grid, _ = predict_slide_multiscale(slides["tif"], model, levels=(2, 3),
                                       batch_size=4, device="cpu")
    np.testing.assert_array_equal(
        _png(out), joverlay.render_overlay(slides["tumor"], grid,
                                           predict_level=3))


# ---------------------------------------------------------------------------
# the WSI visualizer
# ---------------------------------------------------------------------------


def _xml(slides):
    return os.path.join(slides["root"], "annotations", "tumor_001.xml")


@pytest.mark.parametrize("level,patch_xy,patch_size", [
    (3, None, 224), (3, (64, 64), 64), (2, (100, 30), 128), (3, (150, 150), 64)])
def test_wsi_viz_equals_jax(slides, tmp_path, level, patch_xy, patch_size):
    kw = dict(level=level, patch_xy=patch_xy, patch_size=patch_size)
    got = visualize_and_save_wsi(slides["tumor"], _xml(slides),
                                 str(tmp_path / "p"), **kw)
    want = jwsi.visualize_and_save_wsi(slides["tumor"], _xml(slides),
                                       str(tmp_path / "j"), **kw)
    assert sorted(got) == sorted(want)
    assert sorted(got) == (["mask"] if patch_xy is None else
                           ["figure", "mask", "mask_crop", "patch"])
    for key in got:
        assert os.path.basename(got[key]) == os.path.basename(want[key])
        if key != "figure":  # matplotlib's PNG: drawn, not compared
            np.testing.assert_array_equal(_png(got[key]), _png(want[key]))
    assert _png(got["mask"]).max() == 255  # the tumor is drawn
    # a TIFF of the same pyramid gives the same artifacts
    tif = visualize_and_save_wsi(slides["tif"], _xml(slides),
                                 str(tmp_path / "t"), **kw)
    for key in tif:
        if key != "figure":
            np.testing.assert_array_equal(_png(tif[key]), _png(got[key]))


def test_wsi_viz_without_an_annotation_draws_an_empty_mask(slides, tmp_path):
    got = visualize_and_save_wsi(slides["normal"], str(tmp_path / "none.xml"),
                                 str(tmp_path / "p"), level=3)
    want = jwsi.visualize_and_save_wsi(slides["normal"],
                                       str(tmp_path / "none.xml"),
                                       str(tmp_path / "j"), level=3)
    np.testing.assert_array_equal(_png(got["mask"]), _png(want["mask"]))
    assert _png(got["mask"]).max() == 0


def test_wsi_viz_cli_equals_jax_cli(jcli, slides, tmp_path):
    common = ["--wsi_viz", slides["tumor"], "--data_dir", slides["root"],
              "--patch_level", "2"]
    assert cli.main(common + ["--models_dir", str(tmp_path / "p")]) == 0
    assert jcli.main(common + ["--models_dir", str(tmp_path / "j")]) == 0
    p, j = tmp_path / "p" / "wsi_viz" / "tumor_001", \
        tmp_path / "j" / "wsi_viz" / "tumor_001"
    assert sorted(os.listdir(p)) == sorted(os.listdir(j)) == ["mask_level2.png"]
    np.testing.assert_array_equal(_png(p / "mask_level2.png"),
                                  _png(j / "mask_level2.png"))


# ---------------------------------------------------------------------------
# the structure tools
# ---------------------------------------------------------------------------


def _write_png(path, value=128, size=8):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(np.full((size, size, 3), value, np.uint8)).save(path)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _both(tmp_path, build):
    """The same tree built under ``p`` and ``j``."""
    for side in ("p", "j"):
        build(str(tmp_path / side))
    return str(tmp_path / "p"), str(tmp_path / "j")


class _Warnings:
    """Messages of the port's and the JAX package's structure loggers."""

    def __init__(self):
        self.handler = logging.Handler(logging.INFO)
        self.records = []
        self.handler.emit = self.records.append

    def __enter__(self):
        for name in ("torch.utils.structure", "utils.structure"):
            get_logger(name).addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        for name in ("torch.utils.structure", "utils.structure"):
            get_logger(name).removeHandler(self.handler)

    def messages(self, logger_suffix):
        return [r.getMessage() for r in self.records
                if r.name.endswith(logger_suffix)]


def test_group_patches_by_slide_equals_jax(tmp_path):
    def build(level):
        _write_png(os.path.join(level, "normal", "normal_001_x0_y0_normal.png"))
        _write_png(os.path.join(level, "normal", "normal_001_x8_y0_normal.png"))
        _write_png(os.path.join(level, "tumor", "tumor_002_x0_y0_tumor.png"))
        os.makedirs(os.path.join(level, "tumor", "keep"))

    p, j = _both(tmp_path, build)
    assert structure.group_patches_by_slide(p) == \
        jstructure.group_patches_by_slide(j) == 3
    assert _tree(p) == _tree(j)
    assert sorted(os.listdir(p)) == sorted(os.listdir(j))
    assert structure.group_patches_by_slide(str(tmp_path / "missing")) == 0


def test_move_files_up_equals_jax(tmp_path):
    def build(level):
        _write_png(os.path.join(level, "tumor_001", "tumor", "a_x0_y0_tumor.png"))
        _write_png(os.path.join(level, "tumor_001", "tumor", "b_x8_y0_tumor.png"))
        _write_png(os.path.join(level, "tumor_002", "c_x0_y0_tumor.png"))
        _write_png(os.path.join(level, "normal_003", "normal", "d.png"))

    p, j = _both(tmp_path, build)
    assert structure.move_files_up(p) == jstructure.move_files_up(j) == 2
    assert structure.move_files_up(p, "normal") == \
        jstructure.move_files_up(j, "normal") == 1
    assert _tree(p) == _tree(j)
    assert sorted(os.listdir(os.path.join(p, "tumor_001"))) == [
        "a_x0_y0_tumor.png", "b_x8_y0_tumor.png"]


def _corrupt_png(patches):
    _write_png(os.path.join(patches, "level_3", "ok_slide", "ok_x0_y0.png"))
    bad = os.path.join(patches, "level_3", "bad_slide")
    os.makedirs(bad)
    with open(os.path.join(bad, "bad_x0_y0_normal.png"), "wb") as f:
        f.write(b"not a png")


def _bad_packs(patches):
    level = os.path.join(patches, "level_2")
    os.makedirs(level)
    for name, size, shape in (("good", 2 * 4 * 4 * 3, "2 4 4 3\n"),
                              ("short", 100, "2 4 4 3\n"),
                              ("noshape", 48, None)):
        with open(os.path.join(level, f"{name}.pack"), "wb") as f:
            f.write(bytes(size))
        if shape is not None:
            with open(os.path.join(level, f"{name}.pack.shape"), "w") as f:
                f.write(shape)


@pytest.mark.parametrize("build,bad", [
    (lambda d: _write_png(os.path.join(d, "level_3", "s", "a.png")), []),
    (_corrupt_png, ["bad_slide"]),
    (_bad_packs, ["noshape", "short"]),
], ids=["clean", "corrupt_png", "bad_packs"])
def test_check_good_files_equals_jax(tmp_path, build, bad):
    p, j = _both(tmp_path, build)
    got = structure.check_good_files(p, str(tmp_path / "p.txt"))
    want = jstructure.check_good_files(j, str(tmp_path / "j.txt"))
    assert got == want == bad
    assert os.path.exists(tmp_path / "p.txt") == bool(bad)
    if bad:
        assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()


def test_check_good_files_without_pillow_raises(tmp_path, monkeypatch):
    _corrupt_png(str(tmp_path / "patches"))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        structure.check_good_files(str(tmp_path / "patches"),
                                   str(tmp_path / "r.txt"))
    assert not os.path.exists(tmp_path / "r.txt")


@pytest.mark.parametrize("layout", ["empty", "full"])
def test_check_structure_equals_jax(slides, tmp_path, layout):
    from ss25_hierarchical_multiscale_image_classification_tpu.config import (
        DataConfig as JDataConfig,
    )

    root = str(tmp_path / "data")
    if layout == "full":
        shutil.copytree(slides["root"], root)
        for d in ("test/img", "patches", "features"):
            os.makedirs(os.path.join(root, d), exist_ok=True)
    with _Warnings() as w:
        got = structure.check_structure(DataConfig(data_dir=root))
        want = jstructure.check_structure(JDataConfig(data_dir=root))
    assert got == want
    assert all(got.values()) == (layout == "full")
    assert w.messages("torch.utils.structure") == [
        m for r in w.records if not r.name.endswith("torch.utils.structure")
        for m in [r.getMessage()]]


def test_count_tumor_patches_equals_jax(tmp_path):
    from ss25_hierarchical_multiscale_image_classification_tpu.data.manifest import (
        PatchManifest as JManifest,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.patch_store import (
        PackedPatchWriter,
    )

    patches = str(tmp_path / "patches")
    rng = np.random.default_rng(0)
    for level, slides_ in ((2, ("normal_001", "tumor_002")),
                           (3, ("tumor_002",))):
        recs = []
        for k, name in enumerate(slides_):
            wr = PackedPatchWriter(patches, level, name, 8)
            labels = np.array([0, 1, 0, 1 if k else 0] if name.startswith(
                "tumor") else [0, 1, 0])  # a tumor patch in a normal slide
            recs += wr.write_batch(
                rng.integers(0, 256, (len(labels), 8, 8, 3), np.uint8),
                np.stack([np.arange(len(labels)) * 8] * 2, 1), labels)
            wr.close()
        JManifest(recs).save(os.path.join(patches, f"level_{level}",
                                          "manifest.parquet"))
    with _Warnings() as w:
        got = structure.count_tumor_patches(patches)
        want = jstructure.count_tumor_patches(patches)
    assert got == want
    assert got[2] == {"normal": 4, "tumor": 3, "total": 7}
    port = w.messages("torch.utils.structure")
    assert any("Normal slide normal_001 contains 1 tumor" in m for m in port)
    assert port == [r.getMessage() for r in w.records
                    if not r.name.endswith("torch.utils.structure")]


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def _data(tmp_path, slides):
    root = tmp_path / "data"
    shutil.copytree(slides["root"], root)
    _write_png(str(root / "patches" / "level_3" / "tumor_001" / "tumor" /
                   "t_x0_y0_tumor.png"))
    _corrupt_png(str(root / "patches"))
    return root


@pytest.mark.parametrize("argv", [
    ["--check_structure"],
    ["--check_good_downloaded_files"],
    ["--move_files"],
    ["--count_tumor_patches"],
    ["--slide", "tumor_001"],
    ["--overlay"],
    ["--check_structure", "--move_files"],
    ["--check_good_downloaded_files", "--check_structure", "--move_files"],
    ["--move_files", "--count_tumor_patches"],
    ["--slide"],
], ids=lambda a: "_".join(x.lstrip("-") for x in a))
def test_tool_flags_exit_and_act_as_the_jax_cli(jcli, slides, tmp_path,
                                                monkeypatch, argv):
    """Exit codes, the files each CLI moves or writes, and the JAX CLI's
    order (the checks first and alone), from the same data root."""
    roots = {side: _data(tmp_path / side, slides) for side in ("p", "j")}
    rcs, trees = {}, {}
    for side, run in (("p", cli.main), ("j", jcli.main)):
        monkeypatch.chdir(tmp_path / side)  # the redownload manifest's place
        try:
            rcs[side] = run(argv + ["--data_dir", str(roots[side])])
        except SystemExit as e:
            rcs[side] = e.code
        trees[side] = _tree(str(tmp_path / side))
    assert rcs["p"] == rcs["j"]
    assert trees["p"] == trees["j"]
    if "--move_files" in argv and "--check_structure" not in argv:
        assert "data/patches/level_3/tumor_001/t_x0_y0_tumor.png" in trees["p"]


def test_tools_resolve_no_device(slides, tmp_path, monkeypatch):
    """The tools run on a machine without a card under the default
    ``--device cuda``; an action that runs on the device still asks."""
    import ss25_hierarchical_multiscale_image_classification_tpu_torch.cli.main as m

    def no_card(device):
        raise RuntimeError("no card")

    monkeypatch.setattr(m, "resolve_device", no_card)
    root = str(_data(tmp_path, slides))
    for argv in (["--check_structure"], ["--count_tumor_patches"],
                 ["--move_files"], ["--wsi_viz", slides["tumor"]],
                 ["--check_good_downloaded_files"]):
        monkeypatch.chdir(tmp_path)
        assert cli.main(argv + ["--data_dir", root, "--models_dir",
                                str(tmp_path / "m")]) == 0
    with pytest.raises(RuntimeError, match="no card"):
        cli.main(["--predict_slide", slides["tumor"], "--data_dir", root])


def test_cli_under_torchrun_refuses_the_tools(slides, tmp_path, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    for flag in (["--wsi_viz", slides["tumor"]], ["--count_tumor_patches"],
                 ["--move_files"]):
        assert cli.main(["--train", *flag, "--data_dir", str(tmp_path),
                         "--device", "cpu"]) == 2
