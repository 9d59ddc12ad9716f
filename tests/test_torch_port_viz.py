"""The port's colormaps and attention heatmap against matplotlib and JAX.

- ``infer/overlay.py``'s rainbow table and
  ``visualization/attention_heatmap.py``'s jet table against matplotlib's
  ``cm.rainbow`` / ``cm.jet`` uint8 output (``(rgba[..., :3] * 255)
  .astype(uint8)``, what the JAX package draws): 0 bytes different over
  500k seeded values, 0, 1, values outside [0, 1] and NaN, in float32,
  float64 and float16, and on integer grids;
- ``render_overlay`` on grids with NaN and values outside [0, 1], with
  matplotlib's import blocked: JAX's image;
- ``visualize_attention_heatmap`` equal to JAX's arrays (and its two-panel
  figure written where JAX writes one); ``attention_grid_from_bag`` exact.
"""

import os
import sys

import numpy as np
import pytest

from ss25_hierarchical_multiscale_image_classification_tpu.infer import (
    overlay as joverlay,
)
from ss25_hierarchical_multiscale_image_classification_tpu.visualization import (
    attention_heatmap as jheat,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer import (
    overlay,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.visualization import (
    attention_heatmap as heat,
)

cm = pytest.importorskip("matplotlib.cm")
pytest.importorskip("PIL")

EDGES = [0.0, 1.0, -0.5, 1.5, -np.inf, np.inf, np.nan, 0.5, 1 / 256,
         255 / 256, np.nextafter(1.0, 0.0), 1e-12, -1e-12]


def _values(dtype, n=500_000, seed=0):
    v = np.random.default_rng(seed).random(n)
    return np.concatenate([v, np.array(EDGES)]).astype(dtype)


def _mpl(cmap, values):
    return (cmap(np.clip(values, 0.0, 1.0))[..., :3] * 255).astype(np.uint8)


COLORMAPS = {"rainbow": (overlay._colormap_rainbow, cm.rainbow),
             "jet": (heat._jet, cm.jet)}


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16])
@pytest.mark.parametrize("name", sorted(COLORMAPS))
def test_colormap_table_equals_matplotlib(name, dtype):
    ours, theirs = COLORMAPS[name]
    v = _values(dtype)
    got, want = ours(v), _mpl(theirs, v)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert int((got != want).sum()) == 0


@pytest.mark.parametrize("name", sorted(COLORMAPS))
def test_colormap_table_on_grids_and_integers(name):
    ours, theirs = COLORMAPS[name]
    grid = np.random.default_rng(1).random((7, 9)).astype(np.float32) * 1.4 - 0.2
    grid[2, 3] = np.nan
    np.testing.assert_array_equal(ours(grid), _mpl(theirs, grid))
    ints = np.array([[0, 1], [2, -3]])
    np.testing.assert_array_equal(ours(ints), _mpl(theirs, ints))


@pytest.mark.parametrize("name", sorted(COLORMAPS))
def test_colormap_table_every_entry(name):
    ours, theirs = COLORMAPS[name]
    centres = (np.arange(256) + 0.5) / 256
    np.testing.assert_array_equal(ours(centres), _mpl(theirs, centres))
    assert len(np.unique(ours(centres), axis=0)) > 200


def test_nan_is_matplotlibs_bad_colour():
    for ours, _ in COLORMAPS.values():
        np.testing.assert_array_equal(ours(np.array([np.nan])), [[0, 0, 0]])


@pytest.fixture(scope="module")
def slide(synthetic_case):
    return os.path.join(synthetic_case, "train", "img", "tumor_001.wsi.npz")


@pytest.mark.parametrize("case", ["nan", "outside", "constant"])
def test_render_overlay_without_matplotlib_on_odd_grids(slide, monkeypatch,
                                                        case):
    grid = np.random.default_rng(2).random((5, 6))
    if case == "nan":
        grid[::2, ::3] = np.nan
    elif case == "outside":
        grid = grid * 3 - 1
    else:
        grid[:] = 0.25
    want = joverlay.render_overlay(slide, grid, display_level=2,
                                   predict_level=3, stride=112)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.cm", None)
    got = overlay.render_overlay(slide, grid, display_level=2,
                                 predict_level=3, stride=112)
    np.testing.assert_array_equal(got, want)


def _attention(case, shape=(7, 5), seed=3):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=shape)
    if case == "softmaxed":
        e = np.exp(a - a.max())
        return e / e.sum()
    if case == "constant":
        return np.full(shape, 0.2)
    if case == "zeros":
        return np.zeros(shape)
    return a


@pytest.mark.parametrize("blend", [0.5, 0.3])
@pytest.mark.parametrize("case", ["logits", "softmaxed", "constant", "zeros"])
def test_visualize_attention_heatmap_equals_jax(case, blend, monkeypatch):
    image = np.random.default_rng(4).integers(0, 256, (40, 30, 3),
                                              dtype=np.uint8)
    attn = _attention(case)
    want = jheat.visualize_attention_heatmap(image, attn, blend=blend)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.cm", None)
    got = heat.visualize_attention_heatmap(image, attn, blend=blend)
    assert got.dtype == np.uint8 and got.shape == image.shape
    np.testing.assert_array_equal(got, want)


def test_visualize_attention_heatmap_figure_where_jax_writes_it(tmp_path):
    image = np.random.default_rng(5).integers(0, 256, (32, 32, 3),
                                              dtype=np.uint8)
    attn = _attention("logits", (4, 4))
    got = heat.visualize_attention_heatmap(
        image, attn, save_path=str(tmp_path / "p" / "fig.png"))
    want = jheat.visualize_attention_heatmap(
        image, attn, save_path=str(tmp_path / "j" / "fig.png"))
    np.testing.assert_array_equal(got, want)
    from PIL import Image

    assert (Image.open(tmp_path / "p" / "fig.png").size
            == Image.open(tmp_path / "j" / "fig.png").size)


@pytest.mark.parametrize("stride", [224, 56])
def test_attention_grid_from_bag_equals_jax(stride):
    rng = np.random.default_rng(stride)
    coords = rng.integers(0, 10, (20, 2)) * stride
    attn = rng.random(20).astype(np.float32)
    got = heat.attention_grid_from_bag(attn, coords, stride, (10, 10))
    want = jheat.attention_grid_from_bag(attn, coords, stride, (10, 10))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
