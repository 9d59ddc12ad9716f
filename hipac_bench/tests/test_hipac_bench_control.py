"""Each cell's lower-precision control comes out not correct, at a size a
test run holds: the slide cell's is the program's int8 path, a training
cell's the plain reference in float8 in the program's place. On the card
the same readings, at the cells' own sizes, come from
``python3 -m hipac_bench.control``."""

import pytest

from hipac_bench import catalog, control
from hipac_bench.tests import tiny


def _exceeds(cell, readings):
    limits = catalog.workload(cell)["traffic"]["limits"]
    return [k for k, v in limits.items() if readings[k] > v]


@pytest.mark.parametrize("cell", ["r18-slide", "r18-train",
                                  "simclr-pretrain"])
def test_control_fails_a_limit(cell, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    r = control.readings(cell, tiny.SEED, "control", 0.0, device="cpu",
                         overrides=tiny.BY_CELL[cell])
    assert _exceeds(cell, r), r


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["r18-slide", "r18-train",
                                  "simclr-pretrain"])
def test_cell_is_correct_on_the_card(cell, tmp_path, monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from hipac_bench import run

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    out: dict = {}
    assert run.main(["--workload", cell, "--seed", str(tiny.SEED),
                     "--seconds", "1", "--trace", "0"],
                    overrides=tiny.BY_CELL[cell], device="cuda",
                    out=out) == 0
    assert out["correct"] is True, out["checks"]
