"""A whole run of each cell at a small size on the CPU, with the harness's
look for a card skipped: ``correct`` is true on the program as it is, and
false with the timed path broken underneath, once for each fault the cell
can have (no cell spans chips, so none leaves out an exchange)."""

import pytest
import torch

from hipac_bench import catalog, run
from hipac_bench.tests import tiny

PORT = "ss25_hierarchical_multiscale_image_classification_tpu_torch"


def port(name):
    import importlib

    return importlib.import_module(f"{PORT}.{name}")


def _run(cell: str, tmp_path, monkeypatch) -> dict:
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    out: dict = {}
    rc = run.main(["--workload", cell, "--seed", str(tiny.SEED), "--seconds",
                   "0", "--trace", "0"], overrides=tiny.BY_CELL[cell],
                  device="cpu", out=out)
    assert rc == 0
    assert set(out["checks"]) == set(catalog.workload(cell)["traffic"]
                                     ["limits"])
    return out


# -- slide inference -------------------------------------------------------


def _break_step(monkeypatch, fault):
    sw = port("infer.sliding_window")
    make = sw.make_prob_step

    def broken(*args, **kw):
        step = make(*args, **kw)
        return lambda imgs: fault(step, imgs)

    monkeypatch.setattr(sw, "make_prob_step", broken)


def test_slide_is_correct(tmp_path, monkeypatch):
    assert _run("r18-slide", tmp_path, monkeypatch)["correct"] is True


def test_slide_sees_a_margin_altered(tmp_path, monkeypatch):
    def fault(step, imgs):
        m = step(imgs).clone()
        m[0] += 1.0
        return m

    _break_step(monkeypatch, fault)
    assert _run("r18-slide", tmp_path, monkeypatch)["correct"] is False


def test_slide_sees_half_of_the_batch_left_out(tmp_path, monkeypatch):
    def fault(step, imgs):
        half = max(1, len(imgs) // 2)
        m = step(imgs[:half])
        return torch.cat([m, m[: len(imgs) - half]])

    _break_step(monkeypatch, fault)
    assert _run("r18-slide", tmp_path, monkeypatch)["correct"] is False


def test_slide_sees_a_detection_altered(tmp_path, monkeypatch):
    sw = port("infer.sliding_window")
    write = sw.write_detection_csv

    def broken(path, dets):
        write(path, [(p, x + 1, y) for p, x, y in dets])

    monkeypatch.setattr(sw, "write_detection_csv", broken)
    assert _run("r18-slide", tmp_path, monkeypatch)["correct"] is False


# -- training --------------------------------------------------------------


@pytest.mark.parametrize("cell", ["r18-train", "simclr-pretrain"])
def test_training_is_correct(cell, tmp_path, monkeypatch):
    assert _run(cell, tmp_path, monkeypatch)["correct"] is True


@pytest.mark.parametrize("cell", ["r18-train", "simclr-pretrain"])
def test_training_sees_a_step_that_leaves_its_state(cell, tmp_path,
                                                    monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    assert _run(cell, tmp_path, monkeypatch)["correct"] is False


def test_classifier_sees_half_of_the_batch_left_out(tmp_path, monkeypatch):
    trainer = port("train.trainer")
    loss = trainer.weighted_cross_entropy

    def half(logits, labels, weights=None, valid=None, group=None):
        n = len(labels) // 2
        return loss(logits[:n], labels[:n], weights, valid[:n], group)

    monkeypatch.setattr(trainer, "weighted_cross_entropy", half)
    assert _run("r18-train", tmp_path, monkeypatch)["correct"] is False


def test_simclr_sees_half_of_the_batch_left_out(tmp_path, monkeypatch):
    trainer = port("train.simclr_trainer")
    loss = trainer.simclr_loss

    def half(model, v1, v2, temperature, valid=None, *args):
        n = len(v1) // 2
        return loss(model, v1[:n], v2[:n], temperature, valid[:n], *args)

    monkeypatch.setattr(trainer, "simclr_loss", half)
    assert _run("simclr-pretrain", tmp_path, monkeypatch)["correct"] is False
