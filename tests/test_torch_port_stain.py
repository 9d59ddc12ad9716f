"""The port's Macenko stain normalization against the JAX package's.

Tolerance (the same one ``chip_smoke.py`` holds the card's output to,
against the port's CPU output): every normalized byte within 1 of the
reference, and at most 10 % of a batch's bytes differing; stains within
1e-3, maximum concentrations within 5e-3 relative, tissue fractions equal.
The two packages sum the covariance in other float32 orders, and an image
whose eigenvalues lie closer together turns its plane further: the
perturbed-basis images differ by up to 3.7e-4 in a stain, 2.0e-3 relative
in a maximum concentration and by one level in 6.4 % of their bytes.
The inputs are two-stain H&E images (random hematoxylin and eosin
concentrations on a stain basis), where the method is well conditioned.
On tissue of one stain (the synthetic slides' tissue: one colour plus
noise) the covariance's two smaller eigenvalues lie close together and the
JAX function's own output moves by up to ~180 levels when only its float32
summation order changes (a permutation of the pixels), which the last test
shows; the port's output there is not compared with JAX's bytes.

Also: white images pass through exactly, an image's output does not depend
on its batch, and a batch holding an all-white patch does not raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu.data import (
    stain as jstain,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
    stain,
)

MAX_BYTE_DIFF = 1
MAX_DIFF_SHARE = 0.10


def _he(seed, h=64, w=64, stains=None, max_c=(1.2, 0.8), light=0):
    """An H&E-like image from a stain basis and random concentrations; the
    first ``light`` rows are a light background."""
    rng = np.random.default_rng(seed)
    stains = jstain.DEFAULT_STAIN_REF if stains is None else stains
    conc = np.stack([rng.uniform(0.2, max_c[0], h * w),
                     rng.uniform(0.1, max_c[1], h * w)])
    img = np.clip(240.0 * np.exp(-(stains @ conc).T) - 1.0, 0, 255)
    img = img.astype(np.uint8).reshape(h, w, 3)
    img[:light] = 232
    return img


def _perturbed_basis(seed):
    rng = np.random.default_rng(seed)
    basis = np.abs(jstain.DEFAULT_STAIN_REF
                   + rng.normal(0, 0.08, (3, 2)).astype(np.float32))
    return basis / np.linalg.norm(basis, axis=0, keepdims=True)


IMAGES = {
    "reference_basis": lambda: _he(1),
    "perturbed_basis": lambda: _he(5, stains=_perturbed_basis(3)),
    "strong_eosin": lambda: _he(7, max_c=(0.6, 1.4)),
    "light_band": lambda: _he(9, light=40),
    "wide": lambda: _he(11, h=48, w=112, stains=_perturbed_basis(4)),
}


def _batch_check(got, want):
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= MAX_BYTE_DIFF
    assert (diff > 0).mean() <= MAX_DIFF_SHARE


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_stains_equal_jax(name):
    img = IMAGES[name]()
    js, jm, jt = (np.asarray(a) for a in jstain.macenko_stains(jnp.asarray(img)))
    ps, pm, pt = (a.numpy() for a in stain.macenko_stains(torch.from_numpy(img)))
    np.testing.assert_allclose(ps, js, atol=1e-3)
    np.testing.assert_allclose(pm, jm, rtol=5e-3)
    assert pt == jt


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_normalize_equals_jax_within_tolerance(name):
    img = IMAGES[name]()
    want = np.asarray(jstain.macenko_normalize(jnp.asarray(img)))
    got = stain.macenko_normalize(torch.from_numpy(img)).numpy()
    assert got.dtype == np.uint8 and got.shape == img.shape
    _batch_check(got, want)
    assert not np.array_equal(got, img)


def test_normalize_batch_with_references_equals_jax():
    imgs = np.stack([_he(s, stains=_perturbed_basis(s)) for s in range(6)])
    ref = _perturbed_basis(99)
    ref_max = np.array([1.5, 0.9], np.float32)
    want = np.asarray(jstain.macenko_normalize_batch(
        jnp.asarray(imgs), stain_ref=ref, max_conc_ref=ref_max))
    got = stain.macenko_normalize_batch(torch.from_numpy(imgs), stain_ref=ref,
                                        max_conc_ref=ref_max).numpy()
    _batch_check(got, want)


@pytest.mark.parametrize("value", [250, 255, 230])
def test_tissue_free_images_pass_through_exactly(value):
    white = np.full((32, 32, 3), value, np.uint8)
    np.testing.assert_array_equal(
        stain.macenko_normalize(torch.from_numpy(white)).numpy(), white)
    np.testing.assert_array_equal(
        np.asarray(jstain.macenko_normalize(jnp.asarray(white))), white)
    # no tissue pixel: NaN stains and +inf maxima, as in JAX
    ps, pm, pt = stain.macenko_stains(torch.from_numpy(white))
    js, jm, jt = jstain.macenko_stains(jnp.asarray(white))
    assert torch.isnan(ps).all() and np.isnan(np.asarray(js)).all()
    assert torch.isinf(pm).all() and np.isinf(np.asarray(jm)).all()
    assert float(pt) == float(jt) == 0.0


def test_few_tissue_pixels_pass_through_and_min_tissue_frac():
    img = _he(3, light=62)  # 2 of 64 rows are tissue: 3.1 %
    out = stain.macenko_normalize(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(out, img)
    lower = stain.macenko_normalize(torch.from_numpy(img),
                                    min_tissue_frac=0.01).numpy()
    want = np.asarray(jstain.macenko_normalize(jnp.asarray(img),
                                               min_tissue_frac=0.01))
    assert not np.array_equal(lower, img)
    _batch_check(lower, want)


def test_an_images_output_does_not_depend_on_its_batch():
    imgs = [_he(s, stains=_perturbed_basis(s)) for s in range(5)]
    imgs.append(np.full((64, 64, 3), 255, np.uint8))
    alone = [stain.macenko_normalize(torch.from_numpy(im)).numpy() for im in imgs]
    batch = stain.macenko_normalize_batch(torch.from_numpy(np.stack(imgs)))
    reversed_batch = stain.macenko_normalize_batch(
        torch.from_numpy(np.stack(imgs[::-1])))
    for i, a in enumerate(alone):
        np.testing.assert_array_equal(batch[i].numpy(), a)
        np.testing.assert_array_equal(reversed_batch[len(imgs) - 1 - i].numpy(),
                                      a)
    # and the stains
    sb, mb, tb = stain.macenko_stains_batch(torch.from_numpy(np.stack(imgs)))
    s0, m0, t0 = stain.macenko_stains(torch.from_numpy(imgs[2]))
    assert torch.equal(sb[2], s0) and torch.equal(mb[2], m0)


def test_a_batch_with_an_all_white_patch_does_not_raise():
    imgs = np.stack([_he(4), np.full((64, 64, 3), 255, np.uint8), _he(6)])
    out = stain.macenko_normalize_batch(torch.from_numpy(imgs)).numpy()
    np.testing.assert_array_equal(out[1], imgs[1])
    want = np.asarray(jstain.macenko_normalize_batch(jnp.asarray(imgs)))
    _batch_check(out, want)
    assert stain.macenko_normalize_batch(
        torch.zeros((0, 8, 8, 3), dtype=torch.uint8)).shape == (0, 8, 8, 3)


@pytest.mark.parametrize("q", [1.0, 50.0, 99.0])
def test_masked_percentile_equals_jax(q):
    rng = np.random.default_rng(int(q))
    values = rng.normal(size=(5, 257)).astype(np.float32)
    mask = rng.random((5, 257)) < np.array([[0.0], [1 / 257], [0.3], [0.9], [1.0]])
    got = stain._masked_percentile(torch.from_numpy(values),
                                   torch.from_numpy(mask), q).numpy()
    want = np.array([np.asarray(jstain._masked_percentile(
        jnp.asarray(v), jnp.asarray(m), q)) for v, m in zip(values, mask)])
    np.testing.assert_array_equal(got, want)


def test_tree_sum_is_one_order():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 1000)).astype(np.float32))
    got = stain._tree_sum(x)
    np.testing.assert_allclose(got.numpy(), x.double().sum(-1).numpy(),
                               rtol=1e-6)
    np.testing.assert_array_equal(stain._tree_sum(x[1:2]).numpy(),
                                  got[1:2].numpy())


def test_one_stain_tissue_is_ill_conditioned_in_jax_itself():
    """A pixel permutation changes no statistic of the method, only the
    float32 summation order. On the synthetic slides' one-colour tissue the
    JAX function's output then moves far past the tolerance; on H&E images
    it stays within it."""
    from ss25_hierarchical_multiscale_image_classification_tpu.io.synthetic import (
        make_synthetic_slide,
        tumor_spec,
    )

    slide, _ = make_synthetic_slide(tumor_spec(
        width=4032, height=2688, tissue_radii=(0.45, 0.45), seed=1))
    level = slide.level_array(3)  # 504 × 336
    cells = [level[y:y + 224, x:x + 224] for x in range(0, 281, 56)
             for y in range(0, 113, 56)]
    one_stain = np.stack([c for c in cells if c.mean() <= 240])
    he = np.stack([_he(s, h=96, w=96) for s in range(4)])

    def moved(imgs):
        a = np.asarray(jstain.macenko_normalize_batch(jnp.asarray(imgs)))
        perm = np.ascontiguousarray(imgs.transpose(0, 2, 1, 3))
        b = np.asarray(jstain.macenko_normalize_batch(
            jnp.asarray(perm))).transpose(0, 2, 1, 3)
        return np.abs(a.astype(np.int16) - b).max()

    assert moved(he) <= MAX_BYTE_DIFF
    assert moved(one_stain) > 50
