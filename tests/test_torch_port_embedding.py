"""``evaluation/embedding.py`` (the ``--validate`` stage's numerics in torch)
against scikit-learn, the JAX function's own reference, on the CPU.

Bounds:

- the stratified split: indices equal to ``train_test_split``'s;
- PCA: explained-variance ratio within 1e-6 relative, coordinates within
  1e-5 of max|coord|, in each of the three regimes of sklearn's ``"auto"``
  solver (``full``, ``covariance_eigh``, ``randomized``);
- logistic regression: coefficients and intercept within 1e-5 relative of
  ``LogisticRegression(max_iter=1000, class_weight="balanced")`` (float64
  features, so that sklearn's objective is float64 too), predictions equal;
- t-SNE, piece by piece (its descent is chaotic, so no trajectory is held):
  P within 1e-6 of ``_joint_probabilities_nn`` on the same kNN graph; the
  gradient within 1e-5 and the KL within 1e-4 relative of
  ``_kl_divergence_bh(angle=0)`` at embedding scales ≥ 1e-2; the PCA init
  within 1e-5 relative of sklearn's scaled scores; the two-phase descent
  within 1e-6 relative of sklearn's ``_gradient_descent`` driven by the
  port's objective in float64; a default run's KL ≤ 1.05 × sklearn's
  ``kl_divergence_`` + 0.02 and its trustworthiness (k = 5) within 0.02 of
  sklearn's; the row-blocked repulsion within 1e-12 relative of one block;
- trustworthiness equal to sklearn's to 1e-12;
- on the card (marked ``cuda``), two runs of the stage equal bit for bit.
"""

import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation import (
    embedding as E,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation import (
    features_eval as fe,
)

torch.set_num_threads(2)

PCA_RATIO_RTOL = 1e-6
PCA_COORD_TOL = 1e-5
LOGREG_RTOL = 1e-5
P_TOL = 1e-6
GRAD_RTOL, KL_RTOL = 1e-5, 1e-4
INIT_RTOL = 1e-5
DESCENT_RTOL = 1e-6
KL_FACTOR, KL_SLACK = 1.05, 0.02
TRUST_TOL = 0.02
BLOCK_RTOL = 1e-12


def _clusters(n, d, classes=3, seed=0, dtype=np.float32, spread=3.0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n)
    centres = spread * rng.normal(size=(classes, d))
    return (rng.normal(size=(n, d)) + centres[labels]).astype(dtype), labels


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


def _dense(p):
    out = np.zeros((p.n, p.n))
    out[p.rows.numpy(), p.cols.numpy()] = p.vals.numpy()
    return out


# ---------------------------------------------------------------------------
# the stratified split
# ---------------------------------------------------------------------------

def _validate_features_labels(n=60, seed=0):
    """``tests/test_torch_port_actions.py::_features``'s labels."""
    rng = np.random.default_rng(seed)
    return (rng.random(n) < 0.4).astype(np.int64)


@pytest.mark.parametrize("n,classes,seed", [
    # the five cases of test_validate_features_equals_jax (seeds 42, 42, 42,
    # 42, 3 on the same labels), then odd sizes and three classes
    (60, None, 42), (60, None, 3), (61, 3, 0), (97, 3, 5), (13, 2, 1),
    (12, 3, 42), (6, 2, 42), (1001, 3, 7), (35, 4, 11),
])
def test_split_equals_train_test_split(n, classes, seed):
    from sklearn.model_selection import train_test_split

    if classes is None:
        labels = _validate_features_labels(n)
        classes = 2
    else:
        labels = np.random.default_rng(n).permutation(np.arange(n) % classes)
    test_size = max(0.2, classes / n + 1e-9)
    train, test = E.stratified_split(labels, test_size, seed)
    want_train, want_test = train_test_split(
        np.arange(n), test_size=test_size, stratify=labels, random_state=seed)
    np.testing.assert_array_equal(train, want_train)
    np.testing.assert_array_equal(test, want_test)


@pytest.mark.parametrize("labels,test_size", [
    ([0, 0, 0, 1], 0.5),           # a class of one
    ([0, 0, 1, 1, 2, 2], 0.6),     # fewer training rows than classes
    ([0, 0, 0, 0, 1, 1], 0.1),     # fewer test rows than classes
])
def test_split_raises_where_train_test_split_raises(labels, test_size):
    from sklearn.model_selection import train_test_split

    with pytest.raises(ValueError):
        train_test_split(np.arange(len(labels)), test_size=test_size,
                         stratify=labels, random_state=0)
    with pytest.raises(ValueError):
        E.stratified_split(labels, test_size, 0)


# ---------------------------------------------------------------------------
# PCA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,d,solver", [
    (300, 40, "full"), (2000, 50, "covariance_eigh"), (700, 100, "randomized"),
])
def test_pca_equals_sklearn_in_each_auto_regime(n, d, solver, dtype):
    from sklearn.decomposition import PCA

    rng = np.random.default_rng(d)
    x = ((rng.normal(size=(n, 3)) * [5.0, 3.0, 1.0]) @ rng.normal(size=(3, d))
         + 0.1 * rng.normal(size=(n, d))).astype(dtype)
    ref = PCA(n_components=2)
    want = ref.fit_transform(x)
    assert ref._fit_svd_solver == solver
    coords, ratio = E.pca(torch.from_numpy(x), 2)
    np.testing.assert_allclose(ratio.numpy(), ref.explained_variance_ratio_,
                               rtol=PCA_RATIO_RTOL)
    assert _rel(coords.numpy(), want) <= PCA_COORD_TOL


# ---------------------------------------------------------------------------
# logistic regression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("classes", [2, 3])
def test_logistic_regression_equals_sklearn(classes):
    from sklearn.linear_model import LogisticRegression

    x, y = _clusters(500, 24, classes, seed=classes, dtype=np.float64,
                     spread=0.4)
    y = y + 3  # labels other than 0..K-1 map back through classes_
    ref = LogisticRegression(max_iter=1000, class_weight="balanced").fit(x, y)
    fit = E.fit_logistic_regression(torch.from_numpy(x), y)
    np.testing.assert_array_equal(fit.classes, ref.classes_)
    assert fit.coef.shape == ref.coef_.shape
    assert _rel(fit.coef, ref.coef_) <= LOGREG_RTOL
    assert _rel(fit.intercept, ref.intercept_) <= LOGREG_RTOL
    np.testing.assert_array_equal(fit.predict(torch.from_numpy(x)),
                                  ref.predict(x))


def test_logistic_regression_refuses_one_class():
    with pytest.raises(ValueError, match="at least 2 classes"):
        E.fit_logistic_regression(torch.zeros(4, 3), np.ones(4, int))


# ---------------------------------------------------------------------------
# t-SNE
# ---------------------------------------------------------------------------

def _sklearn_knn_graph(x, k):
    from sklearn.neighbors import NearestNeighbors

    graph = NearestNeighbors(n_neighbors=k).fit(x).kneighbors_graph(
        mode="distance")
    graph.data **= 2
    graph.sort_indices()
    return graph


@pytest.mark.parametrize("perplexity", [30.0, 5.0, 2.5])
def test_tsne_p_equals_sklearn_on_the_same_knn_graph(perplexity, monkeypatch):
    from sklearn.manifold._t_sne import _joint_probabilities_nn

    x, _ = _clusters(240, 16)
    n = len(x)
    k = min(n - 1, int(3.0 * perplexity + 1))
    graph = _sklearn_knn_graph(x, k)
    want = _joint_probabilities_nn(graph.copy(), perplexity, 0).toarray()
    d2 = torch.from_numpy(graph.data.reshape(n, k))
    idx = torch.from_numpy(graph.indices.reshape(n, k).astype(np.int64))
    p = E.joint_probabilities_nn(E.binary_search_perplexity(d2, perplexity),
                                 idx)
    assert np.abs(_dense(p) - want).max() <= P_TOL * want.max()
    # the port's own kNN, in blocks of 50 rows, finds the same neighbours at
    # the same distances
    monkeypatch.setattr(E, "BLOCK_BYTES", 50 * 3 * 8 * n)
    got_d2, got_idx = E.knn_sq_distances(torch.from_numpy(x), k)
    for a, b in zip(got_idx.numpy(), graph.indices.reshape(n, k)):
        assert set(a) == set(b)
    assert _rel(np.sort(got_d2.numpy(), axis=1),
                np.sort(graph.data.reshape(n, k), axis=1)) <= P_TOL


@pytest.fixture(scope="module")
def affinities():
    from sklearn.manifold._t_sne import _joint_probabilities_nn

    x, _ = _clusters(300, 20, seed=1)
    k = min(len(x) - 1, int(3.0 * 30.0 + 1))
    graph = _sklearn_knn_graph(x, k)
    want = _joint_probabilities_nn(graph.copy(), 30.0, 0)
    return x, want, E.tsne_affinities(torch.from_numpy(x), 30.0)


@pytest.mark.parametrize("scale", [1e-2, 1.0, 10.0])
def test_tsne_gradient_equals_barnes_hut_at_angle_0(affinities, scale):
    from sklearn.manifold._t_sne import _kl_divergence_bh

    x, p_sk, p = affinities
    n = len(x)
    y = (np.random.default_rng(7).normal(size=(n, 2)) * scale).astype(np.float32)
    kl_sk, grad_sk = _kl_divergence_bh(y.ravel().copy(), p_sk, 1, n, 2,
                                       angle=0.0)
    kl, grad = E.KLObjective(p, torch.float64)(torch.from_numpy(y))
    assert _rel(grad.numpy(), grad_sk) <= GRAD_RTOL
    assert abs(kl / kl_sk - 1.0) <= KL_RTOL


def test_tsne_init_equals_sklearn_scaled_pca_scores(affinities):
    from sklearn.decomposition import PCA

    x = affinities[0]
    want = PCA(n_components=2, svd_solver="randomized",
               random_state=42).fit_transform(x).astype(np.float32)
    want = want / np.std(want[:, 0]) * 1e-4
    got = E.tsne_init(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= INIT_RTOL


@pytest.mark.parametrize("max_iter,min_grad_norm", [
    (255, 1e-7),   # five iterations past the reset at 250
    (120, 1e9),    # both phases stop at their first progress check
])
def test_tsne_descent_equals_sklearn_gradient_descent(affinities, max_iter,
                                                      min_grad_norm,
                                                      monkeypatch):
    """Both phases, the momentum change and the reset of the update and the
    gains, in float64, each side driven by the port's objective."""
    from sklearn.manifold._t_sne import _gradient_descent

    monkeypatch.setattr(E, "MAX_ITER", max_iter)
    monkeypatch.setattr(E, "MIN_GRAD_NORM", min_grad_norm)
    x, _, p = affinities
    n = len(x)
    y0 = torch.from_numpy(np.random.default_rng(3).normal(size=(n, 2)) * 1e-4)
    lr = E.tsne_learning_rate(n)

    def fresh():
        return E.KLObjective(E.JointP(p.rows, p.cols, p.vals.clone(), n),
                             torch.float64)

    got, kl, it = E.tsne_descent(fresh(), y0, lr)
    obj = fresh()

    def objective(params, compute_error=True, **_):
        err, grad = obj(torch.from_numpy(params), compute_error)
        return err, grad.numpy().copy()

    kw = dict(n_iter_check=50, learning_rate=lr, min_grad_norm=min_grad_norm)
    obj.scale(12.0)
    params, want_kl, want_it = _gradient_descent(
        objective, y0.numpy().ravel().copy(), 0, 250,
        n_iter_without_progress=250, momentum=0.5, **kw)
    obj.unscale(12.0)
    params, want_kl, want_it = _gradient_descent(
        objective, params, want_it + 1, max_iter, n_iter_without_progress=300,
        momentum=0.8, **kw)
    assert it == want_it
    assert _rel(got.numpy().ravel(), params) <= DESCENT_RTOL
    assert abs(kl - want_kl) <= DESCENT_RTOL * abs(want_kl)


@pytest.mark.parametrize("n,d,perplexity", [(300, 20, 30.0), (160, 8, 10.0)])
def test_tsne_default_run_reaches_sklearn_kl_and_trustworthiness(n, d,
                                                                 perplexity):
    from sklearn.manifold import TSNE, trustworthiness

    x, _ = _clusters(n, d, seed=n)
    ref = TSNE(n_components=2, perplexity=perplexity, random_state=42)
    want = ref.fit_transform(x)
    got = E.tsne(torch.from_numpy(x), perplexity)
    y = got.embedding.numpy()
    assert y.shape == (n, 2) and y.dtype == np.float32 and np.isfinite(y).all()
    assert got.kl_divergence <= KL_FACTOR * ref.kl_divergence_ + KL_SLACK
    assert abs(trustworthiness(x, y, n_neighbors=5)
               - trustworthiness(x, want, n_neighbors=5)) <= TRUST_TOL


@pytest.mark.parametrize("block_rows,what", [
    *(pytest.param(b, "objective", id=str(b)) for b in (1, 7, 64)),
    *(pytest.param(b, "repulsion", id=f"repulsion-{b}") for b in (1, 7, 64)),
])
def test_tsne_row_blocked_repulsion_equals_one_block(affinities, block_rows,
                                                     what, monkeypatch):
    """KLObjective's gradient and KL, or the plain repulsion's ``neg`` and
    ``sum_q`` it takes them from, in row blocks against one block."""
    x, _, p = affinities
    n = len(x)
    y = torch.from_numpy(np.random.default_rng(5).normal(size=(n, 2)))
    row_bytes = (2 + 4) * 8 * n  # the repulsion's row in float64 at 2-D
    run = (E.KLObjective(p, torch.float64) if what == "objective"
           else E.tsne_repulsion_reference)
    monkeypatch.setattr(E, "BLOCK_BYTES", n * row_bytes)
    one = run(y)
    monkeypatch.setattr(E, "BLOCK_BYTES", block_rows * row_bytes)
    blocked = run(y)
    if what == "objective":
        (kl, grad), (kl_b, grad_b) = one, blocked
    else:
        (grad, kl), (grad_b, kl_b) = one, blocked
    assert _rel(grad_b.numpy(), grad.numpy()) <= BLOCK_RTOL
    assert abs(float(kl_b) - float(kl)) <= BLOCK_RTOL * abs(float(kl))


@pytest.mark.parametrize("n", [10_000, 170_000, 1_000_000])
def test_row_blocks_hold_at_most_a_gigabyte(n):
    """The default blocks of the repulsion (float32, 2-D), the kNN and the
    trustworthiness passes, as each function sizes them."""
    for bytes_per_row in ((2 + 4) * 4 * n, 3 * 8 * n, (4 * 8 + 5) * n):
        rows = E._block_rows(n, bytes_per_row)
        assert 1 <= rows <= n
        assert rows * bytes_per_row <= E.BLOCK_BYTES or rows == 1


@pytest.mark.parametrize("block_rows", [None, 13])
def test_trustworthiness_equals_sklearn(affinities, block_rows, monkeypatch):
    from sklearn.manifold import trustworthiness

    x = affinities[0]
    if block_rows is not None:
        monkeypatch.setattr(E, "BLOCK_BYTES", block_rows * (4 * 8 + 5) * len(x))
    y = np.random.default_rng(11).normal(size=(len(x), 2))
    y[:, 0] += x[:, 0]  # partly faithful, so the ranks spread
    want = trustworthiness(x, y, n_neighbors=5)
    got = E.trustworthiness(torch.from_numpy(x), torch.from_numpy(y), 5)
    assert abs(got - want) <= 1e-12


# ---------------------------------------------------------------------------
# validate_features
# ---------------------------------------------------------------------------

def test_validate_features_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = _clusters(20, 4, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        fe.validate_features(x, y)


def test_validate_features_loads_no_sklearn(tmp_path):
    """In a fresh interpreter: the stage, its plots' numerics and the CLI
    action run and leave ``sklearn`` out of ``sys.modules``."""
    code = """
import sys
import numpy as np
from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation import features_eval as fe
rng = np.random.default_rng(0)
y = np.arange(40) % 2
x = (rng.normal(size=(40, 6)) + y[:, None]).astype(np.float32)
out = fe.validate_features(x, y, device="cpu")
assert set(out) >= {"pca_coords", "tsne_coords", "logreg_confusion"}, out.keys()
assert not any(m.split(".")[0] == "sklearn" for m in sys.modules)
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_validate_features_tsne_full_embeds_every_row():
    x, y = _clusters(45, 6, 2)
    out = fe.validate_features(x, y, tsne_max_samples=len(x), device="cpu")
    assert out["tsne_coords"].shape == (45, 2)
    np.testing.assert_array_equal(out["tsne_labels"], y)
    capped = fe.validate_features(x, y, tsne_max_samples=30, device="cpu")
    assert capped["tsne_coords"].shape == (30, 2)
    assert math.isclose(sum(out["pca_explained_variance"]),
                        sum(capped["pca_explained_variance"]))


@pytest.mark.cuda
def test_validate_features_repeats_bit_for_bit_on_the_card():
    """The attraction sums each row in edge order, with no atomic adds, so a
    card run repeats exactly, as sklearn's seeded one does on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the check is of the card's "
                    "summation order")
    x, y = _clusters(400, 32, 2)
    first = fe.validate_features(x, y, device="cuda")
    again = fe.validate_features(x, y, device="cuda")
    for key in ("pca_coords", "tsne_coords", "logreg_confusion"):
        np.testing.assert_array_equal(first[key], again[key])
