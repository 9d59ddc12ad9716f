"""The port's streamed ``--patch --train`` (``train/streaming.py``) on the CPU.

``_stream_batches`` equals the JAX package's for the same per-slide record
lists: bytes, labels, ``valid`` and the wrap-padded rows. JAX keys cannot be
reproduced with a ``torch.Generator``, so the streamed epoch is held by its
bookkeeping (the validation slide held out by name, the patches seen, the
store it leaves behind row-identical to a sequential ``--patch``) and by
the port's own seeded runs (two runs give equal weights). A narrow
ResNet18 (16 filters) stands in for the full width, for time (at 8
filters and 224² inputs, the oneDNN convolution backward of torch 2.13's
CPU build corrupts the heap).
"""

import os
import queue
import shutil

import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu.config import (
    DataConfig as JDataConfig,
)
from ss25_hierarchical_multiscale_image_classification_tpu.data import (
    extract as jextract,
)
from ss25_hierarchical_multiscale_image_classification_tpu.io import (
    synthetic as jsynthetic,
)
from ss25_hierarchical_multiscale_image_classification_tpu.train import (
    streaming as jstreaming,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    Config,
    DataConfig,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
    extract,
    manifest,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
    slide_level_split,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
    ResNet18Classifier,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train import (
    streaming,
    trainer,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
    load_model,
)

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """JAX-written slides: tumor_001 and normal_001, 1792×1344."""
    root = str(tmp_path_factory.mktemp("streaming_case"))
    jsynthetic.write_synthetic_case(
        root, "tumor_001",
        jsynthetic.tumor_spec(width=1792, height=1344,
                              tissue_radii=(0.45, 0.45), seed=1))
    jsynthetic.write_synthetic_case(
        root, "normal_001",
        jsynthetic.SyntheticSlideSpec(width=1792, height=1344,
                                      tissue_radii=(0.45, 0.45), seed=2))
    return root


def _copy(case, tmp_path, name):
    root = str(tmp_path / name)
    shutil.copytree(case, root, ignore=shutil.ignore_patterns("patches"))
    return root


def _queue(items):
    q = queue.Queue()
    for item in items:
        q.put(item)
    q.put(None)
    return q


def _rows(recs):
    return sorted((r.slide, r.level, r.x, r.y, r.label, r.row) for r in recs)


@pytest.mark.parametrize("batch_size,resize_to,stride", [
    (4, 224, 112),   # 448² → 224²: the numpy box mean against cv2
    (3, 64, 112),    # another size: cv2 in both
    (5, 448, 224),   # no resize, one short batch
    (8, 224, 56),
])
def test_stream_batches_equal_jax(case, tmp_path, batch_size, resize_to,
                                  stride):
    recs = jextract.extract_patches(JDataConfig(data_dir=_copy(
        case, tmp_path, "c")), level=2, stride=stride)
    by_slide: dict = {}
    for r in recs:
        by_slide.setdefault(r.slide, []).append(r)
    # an empty list (a held-out validation slide) in the middle
    items = [by_slide["normal_001"], [], by_slide["tumor_001"]]
    got = list(streaming._stream_batches(_queue(items), batch_size, resize_to))
    want = list(jstreaming._stream_batches(_queue(items), batch_size,
                                           resize_to))
    assert len(got) == len(want) == -(-len(recs) // batch_size)
    for (gi, gl, gv), (wi, wl, wv) in zip(got, want):
        assert gi.shape == (batch_size, resize_to, resize_to, 3)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gv, wv)
        assert gl.dtype == wl.dtype and gv.dtype == wv.dtype
    assert sum(int(v.sum()) for _, _, v in got) == len(recs)


def test_stream_batches_raise_the_producers_error():
    q = queue.Queue()
    q.put(ValueError("decode failed"))
    with pytest.raises(ValueError, match="decode failed"):
        list(streaming._stream_batches(q, 4, 224))


@pytest.fixture()
def narrow(monkeypatch):
    def classifier(cfg):
        return ResNet18Classifier(
            num_classes=cfg.model.num_classes, num_filters=16,
            generator=torch.Generator().manual_seed(cfg.train.seed),
            frozen_bn=cfg.train.freeze_bn)

    monkeypatch.setattr(streaming, "_classifier", classifier)
    monkeypatch.setattr(trainer, "_classifier", classifier)


def _cfg(root, models):
    cfg = Config(data=DataConfig(data_dir=root), models_dir=models)
    cfg.train.batch_size = 8
    cfg.model.pretrained = False
    cfg.log_dir = os.path.join(models, "logs")
    return cfg


def test_streamed_run_holds_out_validation_and_matches_sequential_store(
        case, tmp_path, narrow):
    root = _copy(case, tmp_path, "stream")
    cfg = _cfg(root, str(tmp_path / "models"))
    result = streaming.train_resnet_classifier_streaming(
        cfg, level=2, epochs=2, stride=112, store_format="packed",
        device=CPU)
    ep0 = result["streamed_epoch"]
    assert np.isfinite(ep0["loss"])
    stored = manifest.load_level_manifest(cfg.data.patches_dir, 2)
    train_slides, val_slides = slide_level_split(
        ["normal_001", "tumor_001"], cfg.data.val_fraction,
        cfg.data.split_seed)
    assert len(val_slides) == 1
    assert ep0["patches"] == sum(r.slide in train_slides for r in stored) > 0
    # the store left behind equals a sequential --patch, the port's and JAX's
    seq = extract.extract_patches(DataConfig(data_dir=_copy(
        case, tmp_path, "seq")), level=2, stride=112, device=CPU)
    jseq = jextract.extract_patches(JDataConfig(data_dir=_copy(
        case, tmp_path, "jseq")), level=2, stride=112)
    assert _rows(stored) == _rows(seq) == _rows(jseq)
    # epochs 1+ ran the store-based trainer, which saved the artifact
    assert len(result["history"]) == 1
    assert set(load_model(os.path.join(cfg.models_dir,
                                       "resnet18_patch_classifier"))) == set(
        result["variables"])


def test_single_streamed_epoch_saves_it_and_is_seeded(case, tmp_path, narrow):
    runs = []
    for name in ("a", "b"):
        root = _copy(case, tmp_path, name)
        cfg = _cfg(root, str(tmp_path / f"models_{name}"))
        runs.append(streaming.train_resnet_classifier_streaming(
            cfg, level=3, epochs=1, stride=56, device=CPU))
        assert runs[-1]["history"] == []
        saved = load_model(os.path.join(cfg.models_dir,
                                        "resnet18_patch_classifier"))
        for k, v in runs[-1]["variables"].items():
            assert torch.equal(saved[k], v)
    a, b = runs
    assert a["streamed_epoch"] == b["streamed_epoch"]
    for k in a["variables"]:
        assert torch.equal(a["variables"][k], b["variables"][k])
    # and it trained: the head moved from its seeded start
    start = ResNet18Classifier(num_filters=16,
                               generator=torch.Generator().manual_seed(0))
    assert not torch.equal(start.state_dict()["fc.weight"],
                           a["variables"]["fc.weight"])
