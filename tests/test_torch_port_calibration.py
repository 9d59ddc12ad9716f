"""The port's ``evaluation/calibration.py`` against the JAX package's.

Both are host numpy (and ``scipy.optimize.minimize_scalar`` for the
temperature), and the port's is a copy: every function gives the same
result, exactly (``==``), on the cases of ``tests/test_calibration.py`` and
on degenerate inputs (one class, one sample, ties, an uninformative screen).
"""

import numpy as np
import pytest

from ss25_hierarchical_multiscale_image_classification_tpu.evaluation import (
    calibration as jcal,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation import (
    calibration as cal,
)


def _synthetic_logits(rng, n=2000, scale=4.0, sep=1.5):
    labels = rng.integers(0, 2, n)
    margin = sep * (2 * labels - 1) + rng.normal(0, sep, n)
    return np.stack([np.zeros(n), margin * scale], axis=1), labels


def _float32_logits(rng, n=300):
    """Two-class float32 logits, as the trainer's validation pass gives."""
    labels = rng.integers(0, 2, n).astype(np.int32)
    logits = rng.normal(0, 1, (n, 2)).astype(np.float32)
    logits[:, 1] += 1.5 * labels
    return logits, labels


def _tailed(rng, n_pos=200, n_neg=2000):
    """A clean surface and one whose negatives have a heavy right tail."""
    labels = np.array([1] * n_pos + [0] * n_neg)
    slides = np.array([f"s{i % 8}" for i in range(n_pos + n_neg)])
    clean = np.concatenate([rng.normal(1.5, 1.0, n_pos),
                            rng.normal(0, 1.0, n_neg)])
    neg = rng.normal(0, 0.6, n_neg)
    outliers = rng.choice(n_neg, n_neg * 3 // 100, replace=False)
    neg[outliers] = rng.normal(6.0, 0.2, len(outliers))
    tailed = np.concatenate([rng.normal(2.2, 0.6, n_pos), neg])
    return clean, tailed, labels, slides


# ---------------------------------------------------------------------------
# temperature
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["overconfident", "float32", "small"])
def test_fit_temperature_and_nll_equal_jax(case):
    rng = np.random.default_rng(0)
    if case == "overconfident":
        logits, labels = _synthetic_logits(rng)
    elif case == "float32":
        logits, labels = _float32_logits(rng)
    else:
        logits, labels = _synthetic_logits(rng, n=7, scale=0.3)
    t = cal.fit_temperature(logits, labels)
    assert t == jcal.fit_temperature(logits, labels)
    assert t != 1.0
    for temp in (1.0, t, 0.05):
        assert cal._nll(logits, labels, temp) == jcal._nll(logits, labels, temp)
    assert cal._nll(logits, labels, t) < cal._nll(logits, labels, 1.0)


@pytest.mark.parametrize("logits,labels", [
    (np.zeros((1, 2)), np.array([1])),
    (np.zeros((5, 2)), np.ones(5, int)),
    (np.zeros((0, 2)), np.zeros(0, int)),
])
def test_fit_temperature_degenerate_is_identity_in_both(logits, labels):
    assert cal.fit_temperature(logits, labels) == 1.0
    assert jcal.fit_temperature(logits, labels) == 1.0


# ---------------------------------------------------------------------------
# ranking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["informative", "ties", "constant",
                                  "one_class", "aux_mean_float32"])
def test_roc_auc_equals_jax(case):
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 2, 300)
    scores = rng.normal(0, 1, 300) + labels
    if case == "ties":
        scores = np.round(scores * 2) / 2
    elif case == "constant":
        scores = np.zeros(300)
    elif case == "one_class":
        labels = np.ones(300, int)
    elif case == "aux_mean_float32":
        scores = scores.astype(np.float32)
    got = cal.roc_auc(scores, labels)
    assert got == jcal.roc_auc(scores, labels)
    if case in ("constant", "one_class"):
        assert got == 0.5


@pytest.mark.parametrize("case", ["perfect", "random", "no_tumor", "tailed",
                                  "few_negatives"])
def test_patch_froc_proxy_equals_jax(case):
    rng = np.random.default_rng(5)
    labels = np.array([1] * 50 + [0] * 450)
    slides = np.array([f"s{i % 10}" for i in range(500)])
    scores = rng.normal(0, 1, 500)
    if case == "perfect":
        scores = labels + rng.uniform(0, 0.1, 500)
    elif case == "no_tumor":
        labels = np.zeros(500, int)
    elif case == "tailed":
        _, scores, labels, slides = _tailed(rng)
    elif case == "few_negatives":  # k ≥ negatives at the larger rates
        labels = np.array([1] * 40 + [0] * 12)
        slides = np.array([f"s{i % 3}" for i in range(52)])
        scores = rng.normal(0, 1, 52) + labels
    got = cal.patch_froc_proxy(scores, labels, slides)
    assert got == jcal.patch_froc_proxy(scores, labels, slides)
    if case == "perfect":
        assert got == 1.0
    if case == "no_tumor":
        assert got == 0.0


def test_best_mixture_equals_jax():
    rng = np.random.default_rng(6)
    clean, tailed, labels, slides = _tailed(rng)
    grid = np.linspace(0.0, 1.0, 21)
    assert (cal._best_mixture(clean, tailed, labels, slides, grid)
            == jcal._best_mixture(clean, tailed, labels, slides, grid))
    # identical heads: every w ties, the middle wins
    assert cal._best_mixture(clean, clean, labels, slides, grid)[0] == 0.5


@pytest.mark.parametrize("case", ["detection_grade", "identical", "aux_base",
                                  "aux_base_float32", "coarse_grid"])
def test_pick_combine_mode_equals_jax(case):
    rng = np.random.default_rng(7)
    clean, tailed, labels, slides = _tailed(rng)
    kw = {}
    m_fusion, m_aux = clean, tailed
    if case == "identical":
        m_aux = clean.copy()
    elif case in ("aux_base", "aux_base_float32"):
        n_pos = int(labels.sum())
        kw["m_aux_base"] = np.concatenate([
            rng.normal(5.0, 0.5, n_pos),
            rng.normal(0, 0.5, len(labels) - n_pos)])
        if case == "aux_base_float32":
            m_fusion = m_fusion.astype(np.float32)
            m_aux = m_aux.astype(np.float32)
            kw["m_aux_base"] = kw["m_aux_base"].astype(np.float32)
    elif case == "coarse_grid":
        kw["grid"] = np.array([0.0, 0.3, 1.0])
    got = cal.pick_combine_mode(m_fusion, m_aux, labels, slides, **kw)
    want = jcal.pick_combine_mode(m_fusion, m_aux, labels, slides, **kw)
    assert got == want
    mode, _, proxies = got
    assert mode in cal.COMBINE_MODES
    assert proxies[mode] == max(proxies.values())
    if case == "identical":
        assert mode == "fusion"


@pytest.mark.parametrize("case", ["better_head", "swapped", "identical"])
def test_pick_ensemble_weight_equals_jax(case):
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 2, 1000)
    good = labels + rng.normal(0, 0.8, 1000)
    noise = rng.uniform(size=1000)
    a, b = {"better_head": (good, noise), "swapped": (noise, good),
            "identical": (good, good)}[case]
    got = cal.pick_ensemble_weight(a, b, labels)
    assert got == jcal.pick_ensemble_weight(a, b, labels)
    if case == "identical":
        assert got[0] == 0.5


# ---------------------------------------------------------------------------
# the cascade's operating point
# ---------------------------------------------------------------------------


def _lesions(rng):
    n_norm = 200
    m = np.concatenate([rng.normal(-2, 0.5, n_norm),
                        [3.0, 2.5, -3.5, 2.8, 3.2, 2.9]])
    slides = np.array(["n"] * n_norm + ["s1"] * 3 + ["s2"] * 3)
    cells = np.array([[i * 100.0, 0.0] for i in range(n_norm)]
                     + [[0, 0], [100, 0], [200, 0], [0, 0], [100, 0],
                        [0, 100]], np.float64)
    return m, np.array([0] * n_norm + [1] * 6), slides, cells


@pytest.mark.parametrize("case", ["informative", "blind", "no_tumor",
                                  "no_normal", "lesions", "cells_only",
                                  "no_gate", "float32"])
def test_fit_cascade_margin_equals_jax(case):
    rng = np.random.default_rng(0)
    labels = np.array([0] * 200 + [1] * 50)
    m = np.concatenate([rng.normal(-2, 0.5, 200), rng.normal(2, 0.5, 50)])
    kw = {}
    if case == "blind":
        m = rng.normal(0, 1, 250)
    elif case == "no_tumor":
        labels = np.zeros(250, int)
    elif case == "no_normal":
        labels = np.ones(250, int)
    elif case in ("lesions", "cells_only", "no_gate"):
        m, labels, slides, cells = _lesions(rng)
        if case == "lesions":
            kw = {"slides": slides, "cells": cells}
        elif case == "no_gate":
            kw = {"min_screen_rate": 0.0}
    elif case == "float32":
        m = m.astype(np.float32)
    got = cal.fit_cascade_margin(m, labels, **kw)
    assert got == jcal.fit_cascade_margin(m, labels, **kw)
    if case in ("blind", "no_tumor", "no_normal", "cells_only"):
        assert got is None
    else:
        assert got is not None


@pytest.mark.parametrize("case", ["two_slides", "one_cell", "diagonal",
                                  "chain"])
def test_lesion_groups_equal_jax(case):
    if case == "two_slides":
        slides = np.array(["a", "a", "a", "a", "b"])
        cells = np.array([[0, 0], [100, 0], [500, 500], [600, 500], [0, 0]],
                         np.float64)
    elif case == "one_cell":
        slides, cells = np.array(["a"]), np.zeros((1, 2))
    elif case == "diagonal":  # Chebyshev adjacency joins diagonal cells
        slides = np.array(["a"] * 3)
        cells = np.array([[0, 0], [224, 224], [672, 672]], np.float64)
    else:
        slides = np.array(["a"] * 6)
        cells = np.array([[i * 224.0, 0.0] for i in range(6)])[::-1].copy()
    got = cal._lesion_groups(slides, cells)
    np.testing.assert_array_equal(got, jcal._lesion_groups(slides, cells))
    if case == "chain":
        assert len(np.unique(got)) == 1
    if case == "diagonal":
        assert got[0] == got[1] != got[2]
