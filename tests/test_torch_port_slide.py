"""The port's slide-inference slice against the JAX package.

``predict_slide`` / ``predict_and_export`` run in float32 on the CPU, the
JAX model at ``dtype=float32`` with the same converted weights, on the
``synthetic_case`` tumor slide at level 3 (stride 56: a 4×3 grid with both
tissue and white cells), ``input_size=64`` (so the resize runs) and
``batch_size=8`` (so batches split). The tissue partition must be exactly
equal; tissue margins agree within ``rtol=atol=1e-3``, a bound that allows
for the two frameworks summing the convolutions in different orders in
float32. The host helpers the port carries copies of must give exactly the
JAX package's results on the same grids.
"""

import csv
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ss25_hierarchical_multiscale_image_classification_tpu.infer.sliding_window as jsw
from ss25_hierarchical_multiscale_image_classification_tpu.data.extract import (
    slide_name as jax_slide_name,
)
from ss25_hierarchical_multiscale_image_classification_tpu.grid.pyramid import (
    PatchGrid,
)
from ss25_hierarchical_multiscale_image_classification_tpu.models.resnet import (
    ResNet18Classifier as JaxResNet18Classifier,
)
import ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window as psw
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    resnet18_from_state_dict,
    state_dict_from_flax,
)
from test_torch_port_models import randomized_variables

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE_KW = dict(level=3, stride=56, batch_size=8, input_size=64)
TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxResNet18Classifier(dtype=jnp.float32, num_filters=8)
    variables = randomized_variables(jmodel, seed=7, size=64)
    sd = state_dict_from_flax(variables)
    return jmodel, variables, sd, resnet18_from_state_dict(sd)


@pytest.fixture(scope="module")
def slide_path(synthetic_case):
    return os.path.join(synthetic_case, "train", "img", "tumor_001.wsi.npz")


def _margin_grid(seed, shape):
    rng = np.random.default_rng(seed)
    m = rng.normal(0.0, 3.0, shape).astype(np.float32)
    m[rng.random(shape) < 0.15] = jsw.NON_TISSUE_MARGIN
    return m


@pytest.mark.parametrize("shape,capped", [((37, 53), False), ((90, 70), True)])
def test_host_helpers_equal_jax(shape, capped):
    margins = _margin_grid(sum(shape), shape)
    grid = PatchGrid(level=3, width=shape[1] * 56, height=shape[0] * 56,
                     downsample=8.0, patch_size=224, stride=56)
    np.testing.assert_array_equal(psw.sigmoid(margins), jsw.sigmoid(margins))
    np.testing.assert_array_equal(psw.margin_to_score(margins),
                                  jsw.margin_to_score(margins))
    for p in (0.0, 1e-9, 0.05, 0.5, 1.0):
        assert psw.prob_to_margin(p) == jsw.prob_to_margin(p)

    dets = psw.margin_detections(margins, grid, 1e-9)
    assert dets == jsw.margin_detections(margins, grid, 1e-9)
    # the 1000 cap binds on the large grid, not on the small one
    assert (len(dets) == 1000) == capped
    assert len(dets) > 100

    probs = psw.sigmoid(margins)
    for kw in ({}, {"com_radius": 0}, {"radius_cells": 2, "max_detections": 50}):
        assert psw.nms_detections(probs, grid, 0.3, **kw) == \
            jsw.nms_detections(probs, grid, 0.3, **kw)


def test_slide_name_and_csv_equal_jax(tmp_path):
    for f in ("tumor_001.wsi.npz", "test_002.tif", "a.b.tiff", "plain.png"):
        assert psw.slide_name(f) == jax_slide_name(f)
    dets = [(0.75, 10, 20), (0.5, 3, 4)]
    psw.write_detection_csv(str(tmp_path / "p" / "x.csv"), dets)
    jsw.write_detection_csv(str(tmp_path / "j" / "x.csv"), dets)
    assert (tmp_path / "p" / "x.csv").read_bytes() == \
        (tmp_path / "j" / "x.csv").read_bytes()


@pytest.mark.parametrize("tissue_filter", ["host", "device"])
def test_predict_slide_matches_jax(slide_path, models, tissue_filter):
    jmodel, variables, _, port = models
    ref, jgrid = jsw.predict_slide(slide_path, variables, model=jmodel,
                                   output="margin", tissue_filter=tissue_filter,
                                   **SLICE_KW)
    out, grid = psw.predict_slide(slide_path, port, output="margin",
                                  tissue_filter=tissue_filter, device="cpu",
                                  **SLICE_KW)
    # the port's PatchGrid is its own copy of the JAX class: equal fields
    assert dataclasses.asdict(grid) == dataclasses.asdict(jgrid)
    assert out.shape == ref.shape == (grid.ny, grid.nx)
    white = ref == jsw.NON_TISSUE_MARGIN
    np.testing.assert_array_equal(out == psw.NON_TISSUE_MARGIN, white)
    assert white.any() and (~white).any()
    np.testing.assert_allclose(out[~white], ref[~white], **TOL)

    probs, _ = psw.predict_slide(slide_path, port, tissue_filter=tissue_filter,
                                 device="cpu", **SLICE_KW)
    np.testing.assert_array_equal(probs, psw.sigmoid(out))


def test_predict_slide_rejects_what_the_slice_does_not_take(slide_path, models):
    port = models[3]
    with pytest.raises(ValueError):
        psw.predict_slide(slide_path, port, tissue_filter="nowhere",
                          device="cpu")
    with pytest.raises(ValueError):
        psw.predict_slide(slide_path, port, output="logits", device="cpu")
    with pytest.raises(TypeError):
        psw.predict_slide(slide_path, port, mesh=None, device="cpu")
    with pytest.raises(ValueError):  # the int8 stem folds the normalize
        psw.predict_slide(slide_path, port, int8=True, tissue_filter="device",
                          device="cpu")
    with pytest.raises(TypeError):
        psw.predict_slide(slide_path, port)  # no implicit device


def _read_csv(path):
    with open(path, newline="") as f:
        return np.array([[float(v) for v in row] for row in csv.reader(f)])


def test_predict_and_export_matches_jax(slide_path, models, tmp_path):
    jmodel, variables, _, port = models
    jprobs, jcsv = jsw.predict_and_export(
        slide_path, variables, str(tmp_path / "jax"), threshold=1e-9,
        model=jmodel, **SLICE_KW)
    probs, pcsv = psw.predict_and_export(
        slide_path, port, str(tmp_path / "port"), threshold=1e-9,
        device="cpu", **SLICE_KW)
    assert os.path.basename(pcsv) == os.path.basename(jcsv) == "tumor_001.csv"
    np.testing.assert_allclose(probs, jprobs, **TOL)
    rows, jrows = _read_csv(pcsv), _read_csv(jcsv)
    assert rows.shape == jrows.shape and len(rows) > 0
    np.testing.assert_allclose(rows, jrows, **TOL)


def test_cli_writes_the_detection_csv(slide_path, models, tmp_path):
    """``python -m …_torch.cli.main --device cpu --tissue_filter device`` on
    a ``.pt`` of the converted weights writes the CSV that an in-process
    ``predict_and_export`` with the same arguments writes."""
    sd, port = models[2], models[3]
    models_dir = tmp_path / "models"
    models_dir.mkdir()
    torch.save(sd, str(models_dir / "resnet18_patch_classifier.pt"))
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env.update(OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m",
         "ss25_hierarchical_multiscale_image_classification_tpu_torch.cli.main",
         "--predict_slide", slide_path, "--device", "cpu",
         "--tissue_filter", "device", "--stride", "56", "--batch_size", "8",
         "--detect_threshold", "1e-9", "--models_dir", str(models_dir)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out_csv = models_dir / "model_predictions_csv" / "tumor_001.csv"
    assert out_csv.exists()
    _, ref_csv = psw.predict_and_export(
        slide_path, port, str(tmp_path / "ref"), threshold=1e-9, stride=56,
        batch_size=8, tissue_filter="device", device="cpu")
    np.testing.assert_allclose(_read_csv(str(out_csv)), _read_csv(ref_csv),
                               rtol=1e-5, atol=1e-5)
