"""The port's hard-negative mining against the JAX package's, on the CPU.

With ``predict_slide`` replaced in both packages by one returning the same
probability grid (ties included), the mined records and the bytes they
store are equal; annotated slides are not mined; a second call mines
nothing. With the port's own ``predict_slide`` and a seeded narrow
classifier, every mined cell's probability is at least the threshold, in
descending order, and its bytes are a white-padded region read.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu.config import (
    Config as JConfig,
)
from ss25_hierarchical_multiscale_image_classification_tpu.config import (
    DataConfig as JDataConfig,
)
from ss25_hierarchical_multiscale_image_classification_tpu.data import (
    extract as jextract,
)
from ss25_hierarchical_multiscale_image_classification_tpu.grid.pyramid import (
    PatchGrid as JPatchGrid,
)
from ss25_hierarchical_multiscale_image_classification_tpu.io import (
    synthetic as jsynthetic,
)
from ss25_hierarchical_multiscale_image_classification_tpu.train import (
    hard_negatives as jhn,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    Config,
    DataConfig,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
    extract,
    manifest,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.patch_store import (
    PatchReader,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.pyramid import (
    PatchGrid,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
    predict_slide,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
    open_slide,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
    ResNet18Classifier,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train import (
    hard_negatives as hn,
)

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """JAX-written slides: tumor_001 (annotated) and two annotation-free
    slides, normal_001 (4032×2688: a 3×2 grid at level 3) and normal_002."""
    root = str(tmp_path_factory.mktemp("hardneg_case"))
    jsynthetic.write_synthetic_case(
        root, "tumor_001",
        jsynthetic.tumor_spec(width=1792, height=1344,
                              tissue_radii=(0.45, 0.45), seed=1))
    for name, (w, h), seed in (("normal_001", (4032, 2688), 2),
                               ("normal_002", (1792, 1792), 3)):
        jsynthetic.write_synthetic_case(
            root, name, jsynthetic.SyntheticSlideSpec(
                width=w, height=h, tissue_radii=(0.45, 0.45), seed=seed))
    return root


def _copy(case, tmp_path, name):
    root = str(tmp_path / name)
    shutil.copytree(case, root, ignore=shutil.ignore_patterns("patches"))
    return root


def _grid_fn(grid_cls, seed):
    """A ``predict_slide`` stand-in: seeded probabilities over the slide's
    grid at ``level``, a quarter of them tied at 0.75."""
    def fake(slide, *args, level=3, **kw):
        g = grid_cls.for_slide_level(level, slide.level_dimensions[level],
                                     slide.level_downsamples[level])
        rng = np.random.default_rng(seed + slide.level_dimensions[0][0])
        prob = rng.random((g.ny, g.nx)).astype(np.float32)
        prob[rng.random(prob.shape) < 0.25] = 0.75
        return prob, g
    return fake


def _rows(recs):
    return [(r.slide, r.level, r.x, r.y, r.label, r.store, r.row) for r in recs]


@pytest.mark.parametrize("level,threshold,max_per_slide", [
    (3, 0.5, 256), (3, 0.0, 3), (3, 0.7, 2), (2, 0.0, 1)])
def test_mined_records_and_bytes_equal_jax(case, tmp_path, monkeypatch, level,
                                           threshold, max_per_slide):
    proot, jroot = _copy(case, tmp_path, "p"), _copy(case, tmp_path, "j")
    cfg = Config(data=DataConfig(data_dir=proot))
    jcfg = JConfig(data=JDataConfig(data_dir=jroot))
    extract.extract_patches(cfg.data, level=level, device=CPU)
    jextract.extract_patches(jcfg.data, level=level)
    monkeypatch.setattr(hn, "predict_slide", _grid_fn(PatchGrid, level))
    monkeypatch.setattr(jhn, "predict_slide", _grid_fn(JPatchGrid, level))
    mined = hn.mine_hard_negatives(cfg, None, level=level,
                                   prob_threshold=threshold,
                                   max_per_slide=max_per_slide, device=CPU)
    jmined = jhn.mine_hard_negatives(jcfg, None, level=level,
                                     prob_threshold=threshold,
                                     max_per_slide=max_per_slide)
    assert _rows(mined) == _rows(jmined)
    assert len(mined) > 0
    assert {r.slide for r in mined} <= {"normal_001__hardneg",
                                        "normal_002__hardneg"}
    assert all(r.label == 0 for r in mined)
    for slide in {r.slide for r in mined}:
        p = [r.path for r in mined if r.slide == slide][0]
        j = [r.path for r in jmined if r.slide == slide][0]
        assert open(p, "rb").read() == open(j, "rb").read()
        assert open(p + ".shape").read() == open(j + ".shape").read()
    after = manifest.load_level_manifest(cfg.data.patches_dir, level)
    jafter = jextract.PatchManifest.load(
        jextract.manifest_path(jcfg.data.patches_dir, level))
    assert _rows(after) == _rows(jafter)
    # a second call mines nothing, in both
    assert len(hn.mine_hard_negatives(cfg, None, level=level,
                                      prob_threshold=threshold,
                                      max_per_slide=max_per_slide,
                                      device=CPU)) == 0
    assert len(jhn.mine_hard_negatives(jcfg, None, level=level,
                                       prob_threshold=threshold,
                                       max_per_slide=max_per_slide)) == 0
    assert _rows(manifest.load_level_manifest(cfg.data.patches_dir, level)) \
        == _rows(after)


def test_nothing_above_the_threshold_mines_nothing(case, tmp_path,
                                                    monkeypatch):
    root = _copy(case, tmp_path, "p")
    cfg = Config(data=DataConfig(data_dir=root))
    monkeypatch.setattr(hn, "predict_slide", _grid_fn(PatchGrid, 0))
    mined = hn.mine_hard_negatives(cfg, None, level=3, prob_threshold=1.5,
                                   device=CPU)
    assert len(mined) == 0
    assert not os.path.exists(manifest.manifest_path(cfg.data.patches_dir, 3))


def test_mining_with_the_ports_predict_slide(case, tmp_path, monkeypatch):
    """A seeded narrow classifier through the port's ``predict_slide``:
    mined cells are the top of its grid, and the manifest is numpy where
    pyarrow does not import."""
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    root = _copy(case, tmp_path, "p")
    cfg = Config(data=DataConfig(data_dir=root))
    model = ResNet18Classifier(num_filters=16,
                               generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.fc.bias.copy_(torch.tensor([-1.0, 1.0]))  # lean tumor
    model.eval()
    mined = hn.mine_hard_negatives(cfg, model, level=3, prob_threshold=0.5,
                                   max_per_slide=3, batch_size=4,
                                   input_size=64, device=CPU)
    assert len(mined) > 0
    assert os.path.exists(manifest.manifest_npz_path(cfg.data.patches_dir, 3))
    reader = PatchReader(mined)
    for name in ("normal_001", "normal_002"):
        slide = open_slide(os.path.join(root, "train", "img",
                                        f"{name}.wsi.npz"))
        prob, grid = predict_slide(slide, model, level=3, batch_size=4,
                                   input_size=64, device=CPU)
        rows = [i for i, r in enumerate(mined)
                if r.slide == f"{name}__hardneg"]
        probs = [prob[mined[i].y // grid.stride, mined[i].x // grid.stride]
                 for i in rows]
        assert len(rows) == min(3, int((prob >= 0.5).sum()))
        assert all(p >= 0.5 for p in probs)
        assert probs == sorted(probs, reverse=True)
        for i in rows:
            r = mined[i]
            want = slide.read_region(grid.level0_origin(r.x, r.y), 3,
                                     (grid.patch_size, grid.patch_size))
            np.testing.assert_array_equal(reader.read(i), want)
        slide.close()
    assert len(hn.mine_hard_negatives(cfg, model, level=3, max_per_slide=3,
                                      batch_size=4, input_size=64,
                                      device=CPU)) == 0
