"""The plain reference against the program at a small size on the CPU."""

import numpy as np
import pytest
import torch

from hipac_bench import weights
from hipac_bench.reference import augment as ra
from hipac_bench.reference import detections as rd
from hipac_bench.reference import resnet as rr
from hipac_bench.reference import train as rt

PORT = "ss25_hierarchical_multiscale_image_classification_tpu_torch"


def port(name):
    import importlib

    return importlib.import_module(f"{PORT}.{name}")


def _images(n, size=64, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(60, 256, (n, size, size, 3), dtype=torch.uint8,
                         generator=g)


@pytest.fixture(scope="module")
def classifier():
    sd = weights.resnet18(torch.Generator().manual_seed(4), "cpu", 2)
    sd = weights.calibrate_classifier(sd, _images(6), torch.tensor(
        [True, False] * 3), margin_std=2.0)
    model = port("models.resnet").ResNet18Classifier(num_classes=2)
    model.load_state_dict(sd)
    return sd, model


def test_resnet18_forward_matches_the_program(classifier):
    sd, model = classifier
    x = ra.normalize(_images(3, seed=2))
    with torch.no_grad():
        want = model.eval()(x)
        got = rr.forward(sd, x)
        want_train = model.train()(x)
        got_train = rr.forward(sd, x, train=True)
    model.eval()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_train, want_train, atol=1e-4, rtol=1e-4)


def test_calibrated_margins_spread(classifier):
    sd, _ = classifier
    m = rr.margins(sd, ra.normalize(_images(6)))
    assert float(m.std()) == pytest.approx(2.0, rel=0.05)
    # the probe puts the "tumor" cells (even rows) above the others
    assert float(m[0::2].mean()) > 0 > float(m[1::2].mean())


def test_normalize_and_means_match_the_program():
    u8 = _images(4)
    torch.testing.assert_close(ra.normalize(u8),
                               port("data.augment").normalize(u8))
    _, means = port("ops.preprocess").fused_normalize_reference(u8)
    assert torch.equal(ra.cell_means(u8), means)


def test_augmentation_and_its_draws_match_the_program():
    pa = port("data.augment")
    u8 = _images(8)
    d = ra.draw_augment(torch.Generator().manual_seed(3), 8)
    p = pa.sample_augment_params(torch.Generator().manual_seed(3), 8)
    for k in p:
        assert torch.equal(p[k], d[k]), k
    torch.testing.assert_close(ra.augment(d, u8),
                               pa.augment_batch(p, u8, torch.float32),
                               atol=1e-5, rtol=0)


def test_views_and_their_draws_match_the_program():
    pa = port("data.augment")
    u8 = _images(6)
    g1, g2 = (torch.Generator().manual_seed(8) for _ in range(2))
    d = ra.draw_view(g1, 6, 64)
    boxes = pa.sample_crop_boxes(g2, 6, 64, 64)
    params = pa.sample_simclr_view_params(g2, 6)
    for mine, theirs in zip(("y0", "x0", "hh", "ww"), boxes):
        assert torch.equal(d[mine], theirs)
    for mine, theirs in (("flip", "h"), ("jp", "jp"), ("gp", "gp"),
                         ("fb", "fb"), ("fc", "fc"), ("fs", "fs"),
                         ("fh", "fh")):
        assert torch.equal(d[mine], params[theirs])
    # the program crops and colours in bfloat16
    got = pa.simclr_view_batch(boxes, params, u8, 48).float()
    want = ra.view(d, u8, 48)
    assert float((got - want).abs().max()) < 0.1
    assert float((got - want).abs().mean()) < 0.01


def test_detections_and_csv_match_the_program(tmp_path):
    sw = port("infer.sliding_window")
    grid = port("grid.pyramid").PatchGrid.for_slide_level(
        3, (224 * 13, 224 * 7), 8.0)
    rng = np.random.default_rng(5)
    margins = rng.normal(-3.0, 2.5, (7, 13)).astype(np.float32)
    margins[rng.random((7, 13)) < 0.3] = -1.0e4
    path = tmp_path / "s.csv"
    sw.write_detection_csv(str(path), sw.margin_detections(margins, grid,
                                                           0.05))
    rows = rd.detections(margins, 224, 224, 8.0, 0.05)
    assert len(rows) > 3
    with open(path, newline="") as f:
        assert rd.csv_text(rows) == f.read()


def test_nt_xent_and_adam_match_the_program():
    z1, z2 = torch.randn(6, 16), torch.randn(6, 16)
    torch.testing.assert_close(
        rt.nt_xent(z1, z2, 0.5),
        port("models.simclr").nt_xent_loss(z1, z2, 0.5))
    p0 = torch.randn(5)
    mine = {"w": p0.clone()}
    theirs = torch.nn.Parameter(p0.clone())
    opt = torch.optim.Adam([theirs], lr=1e-2)
    adam = rt.Adam(mine, 1e-2)
    for i in range(3):
        g = torch.randn(5, generator=torch.Generator().manual_seed(i))
        theirs.grad = g.clone()
        opt.step()
        adam.step({"w": g})
    torch.testing.assert_close(mine["w"], theirs.detach())


def test_readings_see_a_fault():
    start = {"a": torch.ones(4), "b": torch.ones(3),
             "bn.running_mean": torch.zeros(2)}
    ref = {"losses": [1.0, 0.9], "grad1": {"a": torch.ones(4),
                                            "b": torch.ones(3)},
           "after": {"a": torch.zeros(4), "b": torch.zeros(3)},
           "running": {"bn.running_mean": torch.ones(2)}}
    same = rt.step_readings(ref, ref, start)
    assert same["loss_gap"] == same["grad_gap"] == same["update_gap"] == 0
    assert same["grad_diff_gap"] == same["bn_gap"] == 0
    stuck = dict(ref, after={k: v for k, v in start.items() if k in "ab"})
    assert rt.step_readings(stuck, ref, start)["update_gap"] == 1.0
