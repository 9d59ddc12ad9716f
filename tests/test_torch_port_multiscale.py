"""The port's multiscale slide inference against the JAX package.

``predict_slide_multiscale`` / ``predict_and_export_multiscale`` run in
float32 on the CPU, the JAX function with the flax module at
``dtype=float32`` and the same weights (carried across by
``hierarchical_state_dict_from_flax``, the calibration through
``split_calibration``), on the ``synthetic_case`` tumor slide at levels
(2, 3): stride 56 on the base level gives a 3 × 4 grid (non-square, so a
transposed grid shows) with tissue and white cells; ``input_size=64`` (the
448-px level-2 patches resize or crop, the 224-px level-3 patches resize);
batch 4, so batches split. The trunk's BN statistics are drawn from a seed.

Tolerances, and why:

- the tissue partition, the cascade's survivor set and its bailout
  decision: equal;
- the five score grids: within ``GRID_TOL`` (1e-4) of the largest |score|
  of the column (the module test's bound: both frameworks sum the trunk's
  convolutions in float32, in different orders); each column's tissue
  scores must spread by 100× that bound, so that the check can tell cells
  apart;
- the int8 trunk: ``INT8_RTOL`` (1 %) of the largest |score|, as
  ``tests/test_torch_port_int8_paths.py`` holds the single-level int8 path
  (the same integers from a carried tree; lazily calibrated scales agree
  to ~1e-6 relative and a rounding may flip);
- a run against another run of the port: equal.

JAX is imported inside the tests that compare with it.
"""

import dataclasses
import logging
import os

import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation.calibration import (
    encode_combine,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer import (
    multiscale as pms,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
    NON_TISSUE_MARGIN as NTM,
    sigmoid,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    hierarchical_from_state_dict,
    hierarchical_state_dict_from_flax,
    quantized_from_jax,
    split_calibration,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models import (
    quantized as q,
)
from test_torch_port_int8 import _np_tree, _u8
from test_torch_port_multiscale_data import randomized_hierarchical

torch.set_num_threads(2)

GRID_TOL = 1e-4
INT8_RTOL = 1e-2
KW = dict(levels=(2, 3), stride=56, batch_size=4, input_size=64)
CAL = {"temperature": 2.0, "aux_temperature": 1.5, "ensemble_weight": 0.25,
       "ensemble_base_weight": 0.7, "combine": encode_combine("aux_base")}


@pytest.fixture(scope="module")
def slide_path(synthetic_case):
    return os.path.join(synthetic_case, "train", "img", "tumor_001.wsi.npz")


@pytest.fixture(scope="module")
def jms():
    pytest.importorskip("jax")
    import ss25_hierarchical_multiscale_image_classification_tpu.infer.multiscale as m

    return m


@pytest.fixture(scope="module")
def concat_models():
    """(flax module, variables, port module) with aux heads."""
    jax = pytest.importorskip("jax")
    jmodel, variables = randomized_hierarchical(jax, "concat", True, seed=5)
    port = hierarchical_from_state_dict(
        hierarchical_state_dict_from_flax(variables))
    return jmodel, variables, port


def _with_cal(variables, cal):
    """The JAX variables with ``cal``, and the port's calibration as the
    exported artifact carries it."""
    v = {**variables, "calibration": dict(cal)}
    _, port_cal = split_calibration(hierarchical_state_dict_from_flax(v))
    return v, port_cal


def _both(jms, slide_path, jmodel, variables, port, cal, **kw):
    """(port, JAX) of ``predict_slide_multiscale`` with components, as
    margins unless ``output`` is given."""
    kw = {**KW, "output": "margin", "return_components": True, **kw}
    v, port_cal = _with_cal(variables, cal)
    want = jms.predict_slide_multiscale(slide_path, v, model=jmodel, **kw)
    got = pms.predict_slide_multiscale(slide_path, port, port_cal,
                                       device="cpu", **kw)
    return got, want


def _assert_grids(got, want, tol=GRID_TOL, spread=True):
    (out, grid, comps), (jout, jgrid, jcomps) = got, want
    assert dataclasses.asdict(grid) == dataclasses.asdict(jgrid)
    assert (grid.ny, grid.nx) == (3, 4)
    assert set(comps) == set(pms.COMBINE_COLUMNS)
    for name in pms.COMBINE_COLUMNS:
        g, w = comps[name], jcomps[name]
        assert g.shape == w.shape == (grid.ny, grid.nx) and g.dtype == np.float32
        white = (w == NTM) | (w == 0.0)
        np.testing.assert_array_equal((g == NTM) | (g == 0.0), white)
        assert (~white).sum() >= 3, name
        scale = np.abs(w[~white]).max()
        np.testing.assert_allclose(g[~white], w[~white], rtol=0,
                                   atol=tol * scale)
        if spread:
            assert np.ptp(w[~white]) > 100 * tol * scale, name
    np.testing.assert_allclose(out, jout, rtol=0,
                               atol=tol * np.abs(jout).max())


class _Messages:
    """Log messages of the port's multiscale module, while open."""

    def __enter__(self):
        self.records = []
        handler = logging.Handler()
        handler.emit = self.records.append
        self.handler = handler
        pms.log.addHandler(handler)
        return self

    def __exit__(self, *exc):
        pms.log.removeHandler(self.handler)

    def text(self):
        return "\n".join(r.getMessage() for r in self.records)


# ---------------------------------------------------------------------------
# the float path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("input_mode", [0, 1], ids=["resize", "crop"])
def test_predict_slide_multiscale_matches_jax(jms, slide_path, concat_models,
                                              input_mode):
    """Calibrated artifact, ``combine="auto"`` from its encoded code
    (aux_base), ``input_mode`` from the artifact (crop: level 2's center at
    native size): all five component grids and the selected one."""
    jmodel, variables, port = concat_models
    cal = {**CAL, "input_mode": input_mode}
    got, want = _both(jms, slide_path, jmodel, variables, port, cal)
    _assert_grids(got, want)
    out, _, comps = got
    np.testing.assert_array_equal(out, comps["aux_base"])
    # the mixes, in log-odds space
    tissue = comps["fusion"] > NTM
    np.testing.assert_allclose(
        comps["ensemble_base"][tissue],
        0.7 * comps["fusion"][tissue] + 0.3 * comps["aux_base"][tissue],
        rtol=1e-5, atol=1e-6)
    # probability output is the logistic of the margin surfaces
    probs, _, pcomps = pms.predict_slide_multiscale(
        slide_path, port, _with_cal(variables, cal)[1], device="cpu",
        return_components=True, **KW)
    np.testing.assert_array_equal(probs, sigmoid(out))
    for name in pms.COMBINE_COLUMNS:
        np.testing.assert_array_equal(pcomps[name], sigmoid(comps[name]))
    # the other input mode gives another fine stream (the base level's
    # aux_base does not see it; the fusion head does)
    _, _, other = pms.predict_slide_multiscale(
        slide_path, port, _with_cal(variables, cal)[1], device="cpu",
        output="margin", return_components=True,
        input_mode="resize" if input_mode else "crop", **KW)
    np.testing.assert_array_equal(other["aux_base"], comps["aux_base"])
    f = comps["fusion"][tissue]
    assert np.abs(other["fusion"][tissue] - f).max() > 100 * GRID_TOL * np.abs(f).max()


def test_attention_artifact_is_detected_and_matches_jax(jms, slide_path):
    """The fusion mode comes from the parameters (``attn_v``); without a
    calibration ``combine="auto"`` is the ensemble at weight 0.5."""
    jax = pytest.importorskip("jax")
    jmodel, variables = randomized_hierarchical(jax, "attention", True, seed=6)
    port = hierarchical_from_state_dict(
        hierarchical_state_dict_from_flax(variables))
    assert port.fusion == "attention"
    got, want = _both(jms, slide_path, jmodel, variables, port, {})
    _assert_grids(got, want)
    _, _, comps = got
    tissue = comps["fusion"] > NTM
    np.testing.assert_array_equal(got[0], comps["ensemble"])
    np.testing.assert_allclose(
        comps["ensemble"][tissue],
        0.5 * comps["fusion"][tissue] + 0.5 * comps["aux"][tissue],
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("combine", ["auto", "fusion", "ensemble_base"])
def test_legacy_calibration_keys_match_jax(jms, slide_path, concat_models,
                                           combine):
    """An earlier artifact's ``ensemble_fine_weight`` and string combine
    ``ensemble_fine``; an explicit ``combine`` overrides the calibration."""
    jmodel, variables, port = concat_models
    cal = {"temperature": 1.5, "ensemble_fine_weight": 0.2,
           "combine": "ensemble_fine"}
    v = {**variables, "calibration": dict(cal)}
    kw = {**KW, "output": "margin", "return_components": True,
          "combine": combine}
    want = jms.predict_slide_multiscale(slide_path, v, model=jmodel, **kw)
    # the calibration as the JAX tree holds it (a string), and as the port's
    # artifact stores it (the code)
    for port_cal in (cal, _with_cal(variables, cal)[1]):
        got = pms.predict_slide_multiscale(slide_path, port, port_cal,
                                           device="cpu", **kw)
        _assert_grids(got, want)
        name = "ensemble_base" if combine == "auto" else combine
        np.testing.assert_array_equal(got[0], got[2][name])
    tissue = got[2]["fusion"] > NTM
    np.testing.assert_allclose(
        got[2]["ensemble_base"][tissue],
        0.2 * got[2]["fusion"][tissue] + 0.8 * got[2]["aux_base"][tissue],
        rtol=1e-5, atol=1e-6)


def test_pre_calibration_artifact_falls_back_like_jax(jms, slide_path):
    """Without aux heads every column is the fusion score and ``combine``
    is forced to fusion."""
    jax = pytest.importorskip("jax")
    jmodel, variables = randomized_hierarchical(jax, "concat", False, seed=7)
    port = hierarchical_from_state_dict(
        hierarchical_state_dict_from_flax(variables))
    assert port.aux_head is None
    got, want = _both(jms, slide_path, jmodel, variables, port, {},
                      combine="aux")
    _assert_grids(got, want, spread=False)
    out, _, comps = got
    for name in pms.COMBINE_COLUMNS:
        np.testing.assert_array_equal(comps[name], comps["fusion"])
    np.testing.assert_array_equal(out, comps["fusion"])
    # cascade needs aux heads: ignored, the full pass
    casc, _ = pms.predict_slide_multiscale(
        slide_path, port, {}, device="cpu", output="margin", cascade=0.5,
        **KW)
    np.testing.assert_array_equal(casc, out)


def _read_csv(path):
    return np.loadtxt(path, delimiter=",", ndmin=2)


def test_predict_and_export_multiscale_csvs_match_jax(jms, slide_path,
                                                      concat_models, tmp_path):
    jmodel, variables, port = concat_models
    v, port_cal = _with_cal(variables, CAL)
    kw = dict(levels=(2, 3), stride=56, batch_size=4, input_size=64,
              threshold=1e-9, export_components=True)
    jprobs, jcsv = jms.predict_and_export_multiscale(
        slide_path, v, str(tmp_path / "j" / "csv"), model=jmodel, **kw)
    probs, csv = pms.predict_and_export_multiscale(
        slide_path, port, str(tmp_path / "p" / "csv"), calibration=port_cal,
        device="cpu", **kw)
    assert os.path.basename(csv) == os.path.basename(jcsv) == "tumor_001.csv"
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-5)
    for suffix in ("",) + tuple(f"_{c}" for c in pms.COMPONENT_EXPORTS):
        got = _read_csv(str(tmp_path / "p" / f"csv{suffix}" / "tumor_001.csv"))
        want = _read_csv(str(tmp_path / "j" / f"csv{suffix}" / "tumor_001.csv"))
        assert got.shape == want.shape and len(got) >= 1, suffix
        np.testing.assert_array_equal(got[:, 1:], want[:, 1:])  # coordinates
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5)


# ---------------------------------------------------------------------------
# cascade
# ---------------------------------------------------------------------------


def _median_floor(comps):
    """A probability floor between the two middle screen scores: about half
    of the tissue survives."""
    tissue = comps["aux_base"] > NTM
    u = np.unique(sigmoid(comps["aux_base"][tissue]))
    k = len(u) // 2
    return float(0.5 * (u[k - 1] + u[k]))


def test_cascade_float_floor_matches_jax(jms, slide_path, concat_models):
    """``cascade_bailout=1.0`` (no probe): the survivors get the fused
    pass, screened-out tissue carries the screen margin in ``aux_base`` and
    the selected column only."""
    jmodel, variables, port = concat_models
    full, _ = _both(jms, slide_path, jmodel, variables, port, CAL)
    floor = _median_floor(full[2])
    with _Messages() as msgs:
        got, want = _both(jms, slide_path, jmodel, variables, port, CAL,
                          cascade=floor, cascade_bailout=1.0)
    assert "survive the base-level screen" in msgs.text()
    _assert_grids(got, want, spread=False)
    comps, jcomps = got[2], want[2]
    tissue = full[2]["aux_base"] > NTM
    survived = comps["fusion"] > NTM
    np.testing.assert_array_equal(survived, jcomps["fusion"] > NTM)
    screened = tissue & ~survived
    assert screened.any() and survived.any()
    np.testing.assert_array_equal(
        survived[tissue], sigmoid(full[2]["aux_base"][tissue]) >= floor)
    for name in ("fusion", "aux", "ensemble", "ensemble_base"):
        assert (comps[name][screened] == NTM).all()
        # other batches than the full pass's: the CPU's float32 convolution
        # sums a cell in another order
        np.testing.assert_allclose(comps[name][survived],
                                   full[2][name][survived], rtol=1e-5,
                                   atol=1e-6)
    # the selected column (aux_base) and aux_base: dense, the screen margin
    np.testing.assert_allclose(comps["aux_base"][tissue],
                               full[2]["aux_base"][tissue], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("with_margin", [True, False])
def test_cascade_auto_matches_jax(jms, slide_path, concat_models, with_margin):
    """``cascade="auto"``: the artifact's ``cascade_margin``, or without one
    the full fused pass."""
    jmodel, variables, port = concat_models
    full, _ = _both(jms, slide_path, jmodel, variables, port, CAL)
    cal = dict(CAL)
    if with_margin:
        floor = _median_floor(full[2])
        cal["cascade_margin"] = float(np.log(floor / (1 - floor)))
    with _Messages() as msgs:
        got, want = _both(jms, slide_path, jmodel, variables, port, cal,
                          cascade="auto", cascade_bailout=1.0)
    _assert_grids(got, want, spread=False)
    np.testing.assert_array_equal(got[2]["fusion"] > NTM,
                                  want[2]["fusion"] > NTM)
    if with_margin:
        assert "artifact operating point" in msgs.text()
        assert (got[2]["fusion"] == NTM).sum() > (full[2]["fusion"] == NTM).sum()
    else:
        assert "ships no fitted operating point" in msgs.text()
        for name in pms.COMBINE_COLUMNS:
            np.testing.assert_array_equal(got[2][name], full[2][name])


@pytest.mark.parametrize("batch_size,where", [(1, "mid-flight"),
                                              (64, "final tally")])
def test_cascade_bailout_matches_jax(jms, slide_path, concat_models,
                                     batch_size, where):
    """A keep-everything floor with the probe on: at batch 1 the probe's
    sample (two batches) is in after the second row and the screen is
    abandoned mid-flight; at batch 64 the screen ends first and the final
    tally bails. Either way every component is the full fused pass, as in
    the JAX function."""
    jmodel, variables, port = concat_models
    full, jfull = _both(jms, slide_path, jmodel, variables, port, CAL,
                        batch_size=batch_size)
    with _Messages() as msgs:
        got, want = _both(jms, slide_path, jmodel, variables, port, CAL,
                          batch_size=batch_size, cascade=1e-9,
                          cascade_bailout=0.6)
    text = msgs.text()
    assert "cascade: bailout" in text
    assert ("probe never armed mid-flight" in text) == (where == "final tally")
    for name in pms.COMBINE_COLUMNS:
        np.testing.assert_array_equal(got[2][name], full[2][name])
        np.testing.assert_array_equal(want[2][name], jfull[2][name])
    _assert_grids(got, want)


# ---------------------------------------------------------------------------
# int8
# ---------------------------------------------------------------------------


def _assert_int8(got, want):
    (out, _, comps), (jout, _, jcomps) = got, want
    for name in pms.COMBINE_COLUMNS:
        g, w = comps[name], jcomps[name]
        white = w == NTM
        np.testing.assert_array_equal(g == NTM, white)
        assert np.isfinite(g).all() and g[~white].std() > 0
        np.testing.assert_allclose(g[~white], w[~white], rtol=0,
                                   atol=INT8_RTOL * np.abs(w[~white]).max())


def _np(tree):
    """A JAX quantized tree (``QuantizedResNet18.tree()``) as numpy."""
    return _np_tree(type("Quantized", (), {"tree": lambda self: tree})())


class _Trees:
    """The trees each package's lazy calibration makes, while open."""

    def __enter__(self):
        from ss25_hierarchical_multiscale_image_classification_tpu.models import (
            quantized as jq,
        )

        self.jq, self.trees = jq, {}
        self.orig = (jq.quantize_resnet18, q.quantize_resnet18)

        def wrap(key, fn):
            def quantize(*args, **kw):
                out = fn(*args, **kw)
                self.trees[key] = out.tree()
                return out
            return quantize

        jq.quantize_resnet18 = wrap("jax", self.orig[0])
        q.quantize_resnet18 = wrap("port", self.orig[1])
        return self

    def __exit__(self, *exc):
        self.jq.quantize_resnet18, q.quantize_resnet18 = self.orig


def _assert_same_tree(tree, jtree):
    """Calibrated from the same cells: equal int8 kernels, activation scales
    within 1e-5 relative (the two float32 calibration forwards sum in
    other orders), biases and the stem bias map within 1e-5 of their
    largest value."""
    jtree = _np(jtree)
    assert set(tree["ascales"]) == set(jtree["ascales"])
    for name, k in tree["qkernels"].items():
        np.testing.assert_array_equal(k.permute(2, 3, 1, 0).numpy(),
                                      jtree["qkernels"][name])
    for name, a in tree["ascales"].items():
        np.testing.assert_allclose(float(a), float(jtree["ascales"][name]),
                                   rtol=1e-5)
    for name, b in tree["biases"].items():
        w = jtree["biases"][name]
        np.testing.assert_allclose(b.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    w = jtree["stem_bias_map"]
    np.testing.assert_allclose(tree["stem_bias_map"].numpy(), w, rtol=0,
                               atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("input_mode", [0, 1], ids=["resize", "crop"])
def test_int8_lazy_calibration_matches_jax(jms, slide_path, concat_models,
                                           input_mode):
    """No ``qtree``: both calibrate the trunk on the slide's first fused
    batch (every level resized, a crop level too, as the JAX function
    calibrates; the JAX buffer is white-padded, the port adds one white cell
    per level to the short batch). The two trees agree (kernels equal,
    scales within 1e-5). The scores are held to JAX's with JAX's lazily
    calibrated tree in the port, within ``INT8_RTOL``: at full width a
    scale ~1e-6 away flips a few of the last blocks' requantizations, which
    moves these small random-head scores by up to ~7 % (measured), so the
    port's own lazy scores are held to that tree's run instead, exactly."""
    jmodel, variables, port = concat_models
    cal = {**CAL, "input_mode": input_mode}
    with _Trees() as trees:
        got, want = _both(jms, slide_path, jmodel, variables, port, cal,
                          int8=True, batch_size=8)
    _assert_same_tree(trees.trees["port"], trees.trees["jax"])
    v, port_cal = _with_cal(variables, cal)
    kw = {**KW, "output": "margin", "return_components": True, "int8": True,
          "batch_size": 8}
    with_jax_tree = pms.predict_slide_multiscale(
        slide_path, port, port_cal, device="cpu",
        qtree=quantized_from_jax(_np(trees.trees["jax"])),
        **kw)
    _assert_int8(with_jax_tree, want)
    with_own_tree = pms.predict_slide_multiscale(
        slide_path, port, port_cal, device="cpu",
        qtree=trees.trees["port"], **kw)
    for name in pms.COMBINE_COLUMNS:
        np.testing.assert_array_equal(got[2][name], with_own_tree[2][name])
    # close to the float path
    full, _ = _both(jms, slide_path, jmodel, variables, port, cal,
                    batch_size=8)
    tissue = full[0] > NTM
    assert np.abs(got[0][tissue] - full[0][tissue]).max() < 0.15 * np.abs(
        full[0][tissue]).max() + 0.05


def test_int8_lazy_calibration_split_over_devices_matches_one_device_and_jax(
        jms, slide_path, concat_models):
    """No ``qtree``, two devices: one trunk tree from the whole first fused
    batch, quantized before the split and copied to both. The batch of 3
    rounds up to 4, and every column equals one device's at 4 bit for bit.
    JAX's run on a 2-device mesh calibrates on the same cells: the trees
    agree as in the one-device test, and the port run with JAX's tree on
    the two devices holds JAX's scores within ``INT8_RTOL``."""
    from ss25_hierarchical_multiscale_image_classification_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh,
    )

    jmodel, variables, port = concat_models
    v, port_cal = _with_cal(variables, CAL)
    kw = {**KW, "output": "margin", "return_components": True, "int8": True,
          "batch_size": 3}
    two_devices = dict(device="cpu", devices=["cpu"] * 2)
    with _Trees() as trees:
        got = pms.predict_slide_multiscale(slide_path, port, port_cal,
                                           **two_devices, **kw)
        want = jms.predict_slide_multiscale(
            slide_path, v, model=jmodel, mesh=jax_make_mesh(num_devices=2),
            **kw)
    one = pms.predict_slide_multiscale(slide_path, port, port_cal,
                                       device="cpu", **{**kw, "batch_size": 4})
    for name in pms.COMBINE_COLUMNS:
        np.testing.assert_array_equal(got[2][name], one[2][name])
    assert (got[2]["fusion"] > NTM).sum() > 4  # more than one batch
    _assert_same_tree(trees.trees["port"], trees.trees["jax"])
    with_jax_tree = pms.predict_slide_multiscale(
        slide_path, port, port_cal, qtree=quantized_from_jax(
            _np(trees.trees["jax"])), **two_devices, **kw)
    _assert_int8(with_jax_tree, want)


@pytest.mark.parametrize("fusion", ["concat", "attention"])
def test_int8_step_scores_do_not_depend_on_the_rows_beside_them(fusion):
    """At full width (512 features a level), the int8 step's five columns
    for a cell are the same whatever rows share its call: 16 rows at once,
    and 5 + 11. The float heads run in calls of ``HEAD_ROWS`` rows; called
    on all the rows at once, MKL's products on this CPU (as cuBLAS's on the
    card) round otherwise at another row count."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.hierarchical import (
        HierarchicalPatchClassifier,
    )

    g = torch.Generator().manual_seed(3)
    model = HierarchicalPatchClassifier(fusion=fusion, generator=g)
    model.for_inference("cpu", torch.float32)
    imgs = {2: torch.randint(0, 256, (16, 128, 128, 3), generator=g,
                             dtype=torch.uint8),
            3: torch.randint(0, 256, (16, 64, 64, 3), generator=g,
                             dtype=torch.uint8)}
    tree = q.quantize_resnet18(
        {k: v.float() for k, v in model.trunk.state_dict().items()},
        [imgs[3]], device="cpu").tree()
    step = pms.make_prob_step_multiscale_int8(model, (2, 3), 64,
                                              with_aux=True)
    whole = step(tree, imgs)
    parts = torch.cat([step(tree, {k: v[lo:hi] for k, v in imgs.items()})
                       for lo, hi in ((0, 5), (5, 16))])
    assert whole.shape == (16, len(pms.COMBINE_COLUMNS))
    assert torch.isfinite(whole).all() and whole.std(dim=0).min() > 0
    torch.testing.assert_close(parts, whole, rtol=0, atol=0)


def test_int8_from_a_trunk_artifact_matches_jax(jms, slide_path, concat_models):
    """A trunk tree calibrated once (by the JAX package) and carried across:
    the same integers on both sides, independent of the batch size; the
    cascade's screen then runs the quantized trunk too."""
    jax = pytest.importorskip("jax")
    from ss25_hierarchical_multiscale_image_classification_tpu.models import (
        quantized as jq,
    )

    jmodel, variables, port = concat_models
    trunk = {"params": variables["params"]["trunk"],
             "batch_stats": variables["batch_stats"]["trunk"]}
    jtree = jq.quantize_resnet18(trunk, [_u8(8, (6, 64, 64, 3))])
    qtree = quantized_from_jax(_np_tree(jtree))
    v, port_cal = _with_cal(variables, CAL)
    kw = {**KW, "output": "margin", "return_components": True, "int8": True}
    want = jms.predict_slide_multiscale(slide_path, v, model=jmodel,
                                        qtree=jtree.tree(), **kw)
    got = pms.predict_slide_multiscale(slide_path, port, port_cal,
                                       qtree=qtree, device="cpu", **kw)
    _assert_int8(got, want)
    other = pms.predict_slide_multiscale(slide_path, port, port_cal,
                                         qtree=qtree, device="cpu",
                                         **{**kw, "batch_size": 3})
    for name in pms.COMBINE_COLUMNS:
        np.testing.assert_array_equal(other[2][name], got[2][name])
    # the port's own tree of the same trunk and cells is JAX's
    own = q.quantize_resnet18(
        {k.removeprefix("trunk."): t for k, t in port.state_dict().items()
         if k.startswith("trunk.")}, [_u8(8, (6, 64, 64, 3))],
        device="cpu").tree()
    _assert_same_tree(own, jtree.tree())
    # cascade with the artifact: the screen is the quantized base-level aux
    floor = _median_floor(got[2])
    jcasc = jms.predict_slide_multiscale(slide_path, v, model=jmodel,
                                         qtree=jtree.tree(), cascade=floor,
                                         cascade_bailout=1.0, **kw)
    casc = pms.predict_slide_multiscale(slide_path, port, port_cal,
                                        qtree=qtree, cascade=floor,
                                        cascade_bailout=1.0, device="cpu",
                                        **kw)
    np.testing.assert_array_equal(casc[2]["fusion"] > NTM,
                                  jcasc[2]["fusion"] > NTM)
    assert (casc[2]["fusion"] == NTM).sum() > (got[2]["fusion"] == NTM).sum()
    _assert_int8(casc, jcasc)


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------


def test_predict_slide_multiscale_rejects_what_it_does_not_take(
        slide_path, concat_models):
    port = concat_models[2]
    with pytest.raises(TypeError):
        pms.predict_slide_multiscale(slide_path, port)  # no implicit device
    with pytest.raises(TypeError):
        pms.predict_slide_multiscale(slide_path, port, mesh=None,
                                     device="cpu")
    with pytest.raises(ValueError, match="output"):
        pms.predict_slide_multiscale(slide_path, port, output="logits",
                                     device="cpu")
    with pytest.raises(ValueError, match="combine"):
        pms.predict_slide_multiscale(slide_path, port, combine="max",
                                     device="cpu", **KW)
    with pytest.raises(ValueError, match="batch_size"):
        pms.predict_slide_multiscale(slide_path, port, device="cpu",
                                     **{**KW, "batch_size": 0})
    with pytest.raises(ValueError, match="expected levels"):
        pms.predict_slide_multiscale(slide_path, port, device="cpu",
                                     **{**KW, "levels": (1, 3)})
