"""The inputs come from the seed: the same seed gives the same bytes, and
another seed other bytes."""

import numpy as np

from hipac_bench import inputs
from hipac_bench.tests import tiny

PLANE = dict(height=256, width=512, blobs=4, radius=(0.2, 0.4),
             tumor_share=0.5, device="cpu")


def test_plane_repeats_from_its_seed():
    a, ta, ua = inputs.make_plane(tiny.SEED, **PLANE)
    b, tb, ub = inputs.make_plane(tiny.SEED, **PLANE)
    c, _, _ = inputs.make_plane(tiny.SEED + 1, **PLANE)
    assert a.dtype == np.uint8 and a.shape == (256, 512, 3)
    assert np.array_equal(a, b) and np.array_equal(ta, tb)
    assert np.array_equal(ua, ub)
    assert not np.array_equal(a, c)
    assert 0.05 < ta.mean() < 0.95 and (a == 255).any()


def test_slide_windows_repeat_and_keep_one_set_of_sizes():
    sizes = inputs.slide_sizes(1000, 2000, 4, (0.25, 1.0))
    a = inputs.slide_windows(tiny.SEED, sizes, 1000, 2000, 3)
    assert a == inputs.slide_windows(tiny.SEED, sizes, 1000, 2000, 3)
    b = inputs.slide_windows(tiny.SEED + 1, sizes, 1000, 2000, 3)
    assert a != b
    for rnd in range(3):  # every round sends every size once
        assert sorted((w, h) for _, _, w, h in a[4 * rnd:4 * rnd + 4]) == \
            sorted(sizes) == sorted((w, h) for _, _, w, h in
                                    b[4 * rnd:4 * rnd + 4])
    for x0, y0, w, h in a:
        assert 0 <= x0 <= 2000 - w and 0 <= y0 <= 1000 - h


def test_plane_slide_reads_like_a_padded_window():
    plane, _, _ = inputs.make_plane(tiny.SEED, **PLANE)
    s = inputs.PlaneSlide(plane, 10, 20, 300, 100)
    assert s.level_dimensions[3] == (300, 100)
    assert s.level_dimensions[0] == (2400, 800)
    band = s.read_region((0, 8 * 90), 3, (300, 20))
    assert np.array_equal(band[:10], plane[110:120, 10:310])
    assert (band[10:] == 255).all()


def test_patch_store_repeats_from_its_spec(tmp_path):
    spec = dict(tiny.STORE, seed=5, tumor_blob_share=0.5, tumor_share=0.3)
    path, labels = inputs.patch_store(spec, str(tmp_path / "a"), "cpu")
    again, labels2 = inputs.patch_store(spec, str(tmp_path / "b"), "cpu")
    rows = np.asarray(inputs.read_store(path))
    n, s = tiny.STORE["patches"], tiny.STORE["size"]
    assert rows.shape == (n, s, s, 3)
    assert np.array_equal(rows, np.asarray(inputs.read_store(again)))
    assert np.array_equal(labels, labels2) and labels.sum() == round(0.3 * n)
    other, _ = inputs.patch_store(dict(spec, seed=6), str(tmp_path / "a"),
                                  "cpu")
    assert other != path
    assert not np.array_equal(rows, np.asarray(inputs.read_store(other)))
    # a second call finds the store: nothing is written again
    mtime = (tmp_path / "a").stat().st_mtime_ns
    assert inputs.patch_store(spec, str(tmp_path / "a"), "cpu")[0] == path
    assert (tmp_path / "a").stat().st_mtime_ns == mtime
