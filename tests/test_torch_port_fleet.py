"""The port's slide fleet (``infer/fleet.py``) and ``--group_size``.

``device_groups`` partitions as the JAX function does
(``tests/test_fleet.py``); the fleet over four CPU "devices" in groups of
two (two threads, each batch split in two) gives the single-slide path's
margins and CSV bytes on the same split, one device's within float32
rounding (the CPU convolutions sum a batch of 4 and one of 8 in other
orders: measured one ulp), and the JAX fleet's grids within the slide
tests' float32 bound; a failing slide surfaces as the JAX fleet's
``RuntimeError``; the CLI's ``--group_size`` that does not divide the devices warns and runs
one group. Lazily calibrated int8 (no ``qtree``) split over two devices
equals one device at the same rounded batch bit for bit, and JAX's
2-device mesh within the one-device int8 bound; the fleet calibrates each
slide on its group, and the CLI's ``--int8`` without an artifact takes
every visible device. The launch counts and the lazy kernel build take a lock, held by
a stress test with more threads than cores.
"""

import logging
import os
import shutil
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu.infer.fleet import (
    device_groups as jax_device_groups,
    predict_slide_fleet as jax_predict_slide_fleet,
)
from ss25_hierarchical_multiscale_image_classification_tpu.models.resnet import (
    ResNet18Classifier as JaxResNet18Classifier,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.cli import (
    main as cli,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer import (
    sliding_window as psw,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.fleet import (
    device_groups,
    predict_slide_fleet,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    resnet18_from_state_dict,
    state_dict_from_flax,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops import (
    build,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
    save_model,
)

from test_torch_port_models import randomized_variables

torch.set_num_threads(2)

CPU = torch.device("cpu")
KW = dict(level=3, stride=56, batch_size=8, input_size=64)
TOL = dict(rtol=1e-3, atol=1e-3)  # the slide tests' float32 bound to JAX


@pytest.fixture(scope="module")
def models():
    jmodel = JaxResNet18Classifier(dtype=jnp.float32, num_filters=8)
    variables = randomized_variables(jmodel, seed=7, size=64)
    sd = state_dict_from_flax(variables)
    return jmodel, variables, sd, resnet18_from_state_dict(sd)


@pytest.fixture(scope="module")
def slides(synthetic_case, tmp_path_factory):
    """Three slides: the two of the synthetic case and the tumor slide
    again under another name."""
    d = tmp_path_factory.mktemp("fleet_slides")
    img = os.path.join(synthetic_case, "train", "img")
    for src, dst in (("tumor_001", "a_tumor"), ("normal_001", "b_normal"),
                     ("tumor_001", "c_tumor")):
        shutil.copy(os.path.join(img, f"{src}.wsi.npz"),
                    d / f"{dst}.wsi.npz")
    return str(d), sorted(str(p) for p in d.iterdir())


def _bytes(csv_dir):
    return {f: open(os.path.join(csv_dir, f), "rb").read()
            for f in sorted(os.listdir(csv_dir))}


# ---------------------------------------------------------------------------
# device_groups
# ---------------------------------------------------------------------------

def test_device_groups_partition_as_jax():
    devs = [torch.device("cpu")] * 8
    assert device_groups(None, devs) == [devs]
    for size in (1, 2, 4, 8):
        got = device_groups(size, devs)
        want = jax_device_groups(size)
        assert [len(g) for g in got] == [len(g) for g in want]
        assert [d for g in got for d in g] == devs
    for size in (3, 9, 0):
        with pytest.raises(ValueError) as got:
            device_groups(size, devs)
        with pytest.raises(ValueError) as want:
            jax_device_groups(size)
        assert str(got.value) == str(want.value)


def test_device_groups_default_needs_a_card():
    # the default is every visible card; there is none on this machine
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        device_groups(1)


# ---------------------------------------------------------------------------
# the fleet against the single-slide path and the JAX fleet
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet_run(slides, models, tmp_path_factory):
    _, paths = slides
    out = str(tmp_path_factory.mktemp("fleet_csv"))
    grids = predict_slide_fleet(paths, models[3], out, group_size=2,
                                devices=[CPU] * 4, threshold=0.0, **KW)
    return out, grids


SPLIT_RTOL = 1e-6  # one device against a split batch: float32 rounding


def test_fleet_equals_the_single_slide_path(slides, models, fleet_run,
                                            tmp_path):
    """Two groups of two: each batch of 8 splits 4 + 4; the probability
    grids and the CSV bytes are the single-slide path's on the same two
    devices, and one device's within float32 rounding."""
    _, paths = slides
    out, grids = fleet_run
    assert set(grids) == set(paths)
    for path in paths:
        want, _ = psw.predict_and_export(
            path, models[3], str(tmp_path), threshold=0.0, device="cpu",
            devices=[CPU, CPU], **KW)
        np.testing.assert_array_equal(grids[path], want)
        one, _ = psw.predict_slide(path, models[3], device="cpu", **KW)
        np.testing.assert_allclose(grids[path], one, rtol=SPLIT_RTOL, atol=0)
    assert _bytes(out) == _bytes(str(tmp_path))
    assert sorted(_bytes(out)) == ["a_tumor.csv", "b_normal.csv", "c_tumor.csv"]


def test_fleet_equals_the_jax_fleet(slides, models, fleet_run, tmp_path):
    jmodel, variables, _, _ = models
    _, paths = slides
    _, grids = fleet_run
    want = jax_predict_slide_fleet(paths, variables, str(tmp_path),
                                   group_size=4, model=jmodel, threshold=0.0,
                                   **KW)
    for path in paths:
        np.testing.assert_allclose(grids[path], want[path], **TOL)


def test_split_batch_equals_one_device_and_rounds_the_batch(slides, models):
    """``predict_slide(devices=)``: contiguous rows over the devices, one
    replica each; a batch that the devices do not divide is rounded up with
    the JAX function's log line."""
    _, paths = slides
    model = models[3]
    one, _ = psw.predict_slide(paths[0], model, output="margin", device="cpu",
                               **KW)
    records = []
    handler = logging.Handler(logging.INFO)
    handler.emit = records.append
    logger = get_logger("torch.infer.sliding_window")
    logger.addHandler(handler)
    try:
        three, _ = psw.predict_slide(
            paths[0], [model] * 3, output="margin", device="cpu",
            devices=["cpu"] * 3, **{**KW, "batch_size": 7})
    finally:
        logger.removeHandler(handler)
    np.testing.assert_allclose(three, one, rtol=SPLIT_RTOL, atol=0)
    assert any("batch_size rounded up to 9 (multiple of the 3-device mesh)"
               == r.getMessage() for r in records)


def test_predict_slide_rejects_a_device_list_it_cannot_run(slides, models):
    _, paths = slides
    with pytest.raises(ValueError, match="unsupported device"):
        psw.predict_slide(paths[0], models[3], device="cpu",
                          devices=["cpu", "meta"], **KW)
    with pytest.raises(ValueError, match="2 model replicas for 3"):
        psw.predict_slide(paths[0], [models[3]] * 2, device="cpu",
                          devices=["cpu"] * 3, **KW)


INT8_RTOL = 1e-2  # of the largest margin: the one-device int8 parity bound


@pytest.fixture(scope="module")
def int8_one_device(slides, models):
    """Lazily calibrated int8 margins on one device at batch 8."""
    _, paths = slides
    return psw.predict_slide(paths[0], models[3], output="margin", int8=True,
                             device="cpu", **KW)[0]


def test_split_int8_lazy_calibration_equals_one_device_and_jax(slides,
                                                               models):
    """``int8=True`` without a ``qtree`` on two devices: one tree, quantized
    from the whole first batch before the split, on every device. The
    batch of 3 rounds up to 4 (the slide's 5 tissue cells: a full batch of
    2 + 2 rows, then one row on the first device), and the margins equal
    one device's at 4 bit for bit (int8 sums are exact, the
    requantization works row by row);
    JAX's ``predict_slide(mesh=<2 CPU devices>, int8=True)`` calibrates the
    same way, and the margins agree within the one-device int8 bound."""
    from ss25_hierarchical_multiscale_image_classification_tpu.infer.sliding_window import (
        predict_slide as jax_predict_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh,
    )

    jmodel, variables, _, model = models
    _, paths = slides
    quantized = []
    real = psw._int8_steps

    def spy(*args, **kw):
        steps, calibrate = real(*args, **kw)

        def counted(batch):
            quantized.append(len(batch))
            calibrate(batch)
        return steps, counted

    psw._int8_steps = spy
    try:
        two, _ = psw.predict_slide(paths[0], model, output="margin",
                                   int8=True, device="cpu",
                                   devices=["cpu"] * 2,
                                   **{**KW, "batch_size": 3})
    finally:
        psw._int8_steps = real
    # the hook sees each whole batch; the first one calibrates
    assert quantized == [4, 1]
    one, _ = psw.predict_slide(paths[0], model, output="margin", int8=True,
                               device="cpu", **{**KW, "batch_size": 4})
    np.testing.assert_array_equal(two, one)
    white = two == psw.NON_TISSUE_MARGIN
    assert white.any() and (~white).sum() == 5
    want, _ = jax_predict_slide(paths[0], variables, model=jmodel,
                                output="margin", int8=True,
                                mesh=jax_make_mesh(num_devices=2),
                                **{**KW, "batch_size": 3})
    np.testing.assert_array_equal(want == psw.NON_TISSUE_MARGIN, white)
    np.testing.assert_allclose(two[~white], want[~white], rtol=0,
                               atol=INT8_RTOL * np.abs(want[~white]).max())


def test_int8_fleet_calibrates_each_slide_on_its_group(slides, models,
                                                       int8_one_device,
                                                       tmp_path):
    """Two groups of two without a ``qtree``: each slide is calibrated on
    its own first batch, on its group, and gives the split single-slide
    path's margins and CSV bytes."""
    _, paths = slides
    got = predict_slide_fleet(paths, models[3], str(tmp_path / "fleet"),
                              group_size=2, devices=[CPU] * 4, threshold=0.0,
                              int8=True, **KW)
    for path in paths:
        want, _ = psw.predict_and_export(
            path, models[3], str(tmp_path / "one"), threshold=0.0,
            device="cpu", devices=[CPU, CPU], int8=True, **KW)
        np.testing.assert_array_equal(got[path], want)
    np.testing.assert_array_equal(got[paths[0]],
                                  psw.sigmoid(int8_one_device))
    assert _bytes(str(tmp_path / "fleet")) == _bytes(str(tmp_path / "one"))


def test_two_groups_on_one_device_equal_the_sequential_slides(slides, models,
                                                              tmp_path):
    """Two worker threads sharing one device (groups of one, whole
    batches): the grids and CSV bytes of the slides run one after another
    on that device."""
    _, paths = slides
    got = predict_slide_fleet(paths, models[3], str(tmp_path / "fleet"),
                              group_size=1, devices=[CPU, CPU], threshold=0.0,
                              **KW)
    for path in paths:
        want, _ = psw.predict_and_export(path, models[3], str(tmp_path / "seq"),
                                         threshold=0.0, device="cpu", **KW)
        np.testing.assert_array_equal(got[path], want)
    assert _bytes(str(tmp_path / "fleet")) == _bytes(str(tmp_path / "seq"))


def test_fleet_surfaces_errors_after_the_other_slides(slides, models,
                                                     tmp_path):
    _, paths = slides
    missing = str(tmp_path / "missing.wsi.npz")
    csv_dir = str(tmp_path / "csv")
    with pytest.raises(RuntimeError) as err:
        predict_slide_fleet([paths[0], missing, paths[1]], models[3], csv_dir,
                            group_size=1, devices=[CPU, CPU], **KW)
    assert str(err.value) == f"1 slide(s) failed; first: {missing}"
    assert err.value.__cause__ is not None
    assert sorted(os.listdir(csv_dir)) == ["a_tumor.csv", "b_normal.csv"]


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models_dir(models, tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet_models")
    save_model(str(d / "resnet18_patch_classifier"), models[2])
    return d


class _Records:
    def __init__(self, name):
        self.records, self.logger = [], get_logger(name)
        self.handler = logging.Handler(logging.INFO)
        self.handler.emit = self.records.append

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self.records

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def test_cli_group_size_that_does_not_divide_warns_and_runs_one_group(
        slides, models_dir, fleet_run, tmp_path):
    target, _ = slides
    models = tmp_path / "m"
    shutil.copytree(models_dir, models)
    with _Records("torch.cli") as records:
        rc = cli.main(["--predict_slide", target, "--group_size", "3",
                       "--stride", "56", "--batch_size", "8",
                       "--detect_threshold", "0.0", "--models_dir",
                       str(models), "--device", "cpu"])
    assert rc == 0
    assert [r.getMessage() for r in records
            if r.levelno == logging.WARNING] == [
        "--group_size 3 does not divide the 1 devices; using one group"]
    assert sorted(os.listdir(models / "model_predictions_csv")) == [
        "a_tumor.csv", "b_normal.csv", "c_tumor.csv"]


def test_cli_directory_goes_through_the_fleet(slides, models_dir, monkeypatch,
                                              tmp_path):
    """``--predict_slide <dir> --group_size 1``: one fleet call with the
    CLI's devices, level and threshold; a single slide does not use it."""
    target, paths = slides
    calls = []
    monkeypatch.setattr(cli, "predict_slide_fleet",
                        lambda *a, **kw: calls.append((a, kw)) or {})
    assert cli.main(["--predict_slide", target, "--group_size", "1",
                     "--models_dir", str(models_dir), "--device", "cpu"]) == 0
    (args, kw), = calls
    assert args[0] == paths and kw["group_size"] == 1
    assert kw["devices"] == [CPU] and kw["level"] == 3
    assert kw["tissue_filter"] == "host"
    calls.clear()
    monkeypatch.setattr(cli, "predict_and_export",
                        lambda *a, **kw: (None, "x.csv"))
    assert cli.main(["--predict_slide", paths[0], "--models_dir",
                     str(models_dir), "--device", "cpu"]) == 0
    assert calls == []


def _csv_rows(models_dir):
    out = {}
    for d in sorted(os.listdir(models_dir)):
        if d.startswith("model_predictions_csv"):
            for f in sorted(os.listdir(os.path.join(models_dir, d))):
                path = os.path.join(models_dir, d, f)
                text = open(path).read()
                out[(d, f)] = (np.loadtxt(path, delimiter=",", ndmin=2)
                               if text.strip() else np.empty((0, 3)))
    return out


@pytest.mark.parametrize("extra", [[], ["--cascade", "0.5",
                                        "--cascade_bailout", "1.0"]],
                         ids=["components", "cascade"])
def test_cli_multiscale_fleet_over_groups_of_several_devices(
        slides, tmp_path, monkeypatch, extra):
    """``--predict_slide <dir> --multiscale --group_size 2`` over four CPU
    "devices": two groups, each batch's stacked trunk call split over a
    group's two replicas; the CSVs (the four component surfaces too) hold
    the one-device run's rows within float32 rounding."""
    from test_torch_port_cli import _hierarchical_artifacts

    target, _ = slides
    _, pdir = _hierarchical_artifacts(tmp_path, {}, seed=84)
    argv = ["--predict_slide", target, "--multiscale", "--ms_components",
            "--stride", "112", "--batch_size", "4", "--detect_threshold",
            "0.0", "--models_dir", str(pdir), "--device", "cpu", *extra]
    assert cli.main(argv) == 0
    want = _csv_rows(pdir)
    for d in os.listdir(pdir):
        if d.startswith("model_predictions_csv"):
            shutil.rmtree(pdir / d)
    monkeypatch.setattr(cli, "_visible_devices", lambda device: [CPU] * 4)
    with _Records("torch.infer.fleet") as records:
        assert cli.main(argv + ["--group_size", "2"]) == 0
    assert any(r.getMessage().startswith("fleet[3 slides / 2 groups]")
               for r in records)
    got = _csv_rows(pdir)
    assert got.keys() == want.keys() and len(want) == 15
    for key, rows in want.items():
        assert got[key].shape == rows.shape, key
        np.testing.assert_allclose(got[key], rows, rtol=SPLIT_RTOL, atol=0)


@pytest.mark.parametrize("multiscale", [False, True],
                         ids=["single_level", "multiscale"])
def test_cli_int8_without_an_artifact_runs_every_device(
        slides, models_dir, tmp_path, monkeypatch, multiscale):
    """``--predict_slide <slide> [--multiscale] --int8`` with no int8
    artifact on two visible devices: the producer gets both (it calibrates
    before the split), and the CSV bytes are one device's at the same
    batch."""
    _, paths = slides
    if multiscale:
        from test_torch_port_cli import _hierarchical_artifacts

        _, models = _hierarchical_artifacts(tmp_path, {}, seed=85)
        extra, name = ["--multiscale"], "predict_and_export_multiscale"
    else:
        models = tmp_path / "m"
        shutil.copytree(models_dir, models)
        extra, name = [], "predict_and_export"
    argv = ["--predict_slide", paths[0], "--int8", *extra, "--stride", "56",
            "--batch_size", "4", "--detect_threshold", "0.0",
            "--models_dir", str(models), "--device", "cpu"]
    csv = models / "model_predictions_csv" / "a_tumor.csv"
    assert cli.main(argv) == 0
    one = csv.read_bytes()
    csv.unlink()
    seen = []
    real = getattr(cli, name)
    monkeypatch.setattr(cli, name, lambda *a, **kw: seen.append(
        kw["devices"]) or real(*a, **kw))
    monkeypatch.setattr(cli, "_visible_devices", lambda device: [CPU] * 2)
    assert cli.main(argv) == 0
    assert seen == [[CPU, CPU]]
    assert csv.read_bytes() == one and one


def test_cli_under_torchrun_refuses_actions_without_a_dp_path(tmp_path,
                                                              monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with _Records("torch.cli") as records:
        rc = cli.main(["--train", "--train_mil", "--data_dir", str(tmp_path),
                       "--device", "cpu"])
    assert rc == 2
    assert [r.getMessage() for r in records] == [
        "--train_mil has no data-parallel path: run it without torchrun"]


# ---------------------------------------------------------------------------
# thread safety of the kernels' bookkeeping
# ---------------------------------------------------------------------------

def _hammer(fn, threads=16):
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=fn) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)


def test_launch_counts_lose_no_update_under_threads():
    def wrapper():
        pass

    wrapper.launches = 0

    def work():
        for _ in range(2000):
            build.count_launch(wrapper)

    _hammer(work)
    assert wrapper.launches == 16 * 2000


def test_the_kernel_build_runs_once_under_threads(monkeypatch):
    builds = []

    def fake_build():
        builds.append(threading.get_ident())
        threading.Event().wait(0.05)  # a slow build, other threads arrive
        return []

    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build, "SOURCES", {})
    build._load_library.cache_clear()
    try:
        _hammer(build.load_library)
        assert len(builds) == 1
    finally:
        build._load_library.cache_clear()
