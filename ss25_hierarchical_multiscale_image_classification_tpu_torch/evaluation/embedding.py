"""The feature-evaluation stage's numerics in torch (``--validate``): what the
JAX package takes from scikit-learn, written for the device.

- :func:`stratified_split`: the indices of sklearn 1.9's
  ``train_test_split(..., test_size, stratify=labels, random_state=seed)``
  (``StratifiedShuffleSplit`` over ``_approximate_mode``), drawn from the
  same ``RandomState`` in the same order, so they are equal (host numpy);
- :func:`pca`: ``PCA(n)`` from the eigh of the centred covariance in
  float64, with sklearn's sign rule (``svd_flip(u_based_decision=False)``:
  each component's largest-magnitude loading is positive). Every solver
  sklearn's ``"auto"`` picks converges to this function;
- :func:`fit_logistic_regression`: ``LogisticRegression(max_iter=1000,
  class_weight="balanced")`` with lbfgs: sklearn's ``LinearModelLoss``
  objective (balanced class weights in the sample weights, L2 strength
  ``1 / (C · Σw)``, intercept not penalised) as float64 torch ops on the
  device, minimised by the same ``scipy.optimize.minimize(method=
  "L-BFGS-B")`` call with sklearn's options;
- :func:`tsne`: ``TSNE(n_components=2, perplexity, random_state=seed)``
  with sklearn's defaults: P from the k = min(N − 1, ⌊3·perplexity + 1⌋)
  nearest neighbours with the per-row binary search for the perplexity
  (vectorised over rows), symmetrised and normalised; the PCA init scaled to
  a column-0 standard deviation of 1e-4; the two-phase descent of
  ``_gradient_descent`` (early exaggeration 12 and momentum 0.5 for 250
  iterations, then 0.8, delta-bar-delta gains, a progress check every 50).
  **One deliberate difference**: the repulsive term is exact over all pairs
  (Barnes–Hut at ``angle=0``), where sklearn approximates it at
  ``angle=0.5``: :func:`tsne_repulsion`, the hand-written kernel of
  ``ops/tsne_repulsion.py`` on the card, row blocks of at most ~1 GB of
  torch ops on the CPU;
- :func:`trustworthiness`: sklearn's ``trustworthiness`` (k nearest
  neighbours, Euclidean), in row blocks.

Nothing here imports scikit-learn: the card's machine has none.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

#: sklearn's ``_utils.pyx`` constants, which are C floats
_PERPLEXITY_TOLERANCE = float(np.float32(1e-5))
_EPSILON_DBL = float(np.float32(1e-8))
_BINARY_SEARCH_STEPS = 100
_MACHINE_EPSILON = float(np.finfo(np.float64).eps)
_FLOAT32_TINY = float(np.finfo(np.float32).tiny)

#: the most bytes one row block of the pairwise passes may hold
BLOCK_BYTES = 1 << 30


def _block_rows(n: int, bytes_per_row: int) -> int:
    return max(1, min(n, BLOCK_BYTES // max(1, bytes_per_row)))


# ---------------------------------------------------------------------------
# stratified split (host numpy)
# ---------------------------------------------------------------------------


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """sklearn's ``utils.extmath._approximate_mode``: the draws per class,
    ties in the remainders broken by ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        values = np.sort(np.unique(remainder))[::-1]
        for value in values:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_split(labels, test_size: float, seed: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Train and test indices equal to those of sklearn's
    ``train_test_split(x, labels, test_size=test_size, stratify=labels,
    random_state=seed)`` (a float ``test_size`` in (0, 1)), raising where
    it raises."""
    y = np.asarray(labels)
    n = len(y)
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size={test_size} should be a float in the "
                         "(0, 1) range")
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(f"With n_samples={n}, test_size={test_size} and "
                         "train_size=None, the resulting train set will be "
                         "empty.")
    classes, y_indices, class_counts = np.unique(
        y, return_inverse=True, return_counts=True)
    if class_counts.min() < 2:
        raise ValueError("The least populated classes in y have only 1 "
                         "member, which is too few.")
    if n_train < len(classes):
        raise ValueError(f"The train_size = {n_train} should be greater or "
                         f"equal to the number of classes = {len(classes)}")
    if n_test < len(classes):
        raise ValueError(f"The test_size = {n_test} should be greater or "
                         f"equal to the number of classes = {len(classes)}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train: list = []
    test: list = []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]),
                                     mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


# ---------------------------------------------------------------------------
# PCA
# ---------------------------------------------------------------------------


def pca(x: torch.Tensor, n_components: int
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``PCA(n_components).fit_transform(x)`` and its explained-variance
    ratio, in float64 on ``x``'s device: the top eigenvectors of the centred
    covariance, each signed so that its largest-magnitude loading is
    positive."""
    x = x.to(torch.float64)
    n, d = x.shape
    if not 1 <= n_components <= min(n, d):
        raise ValueError(f"n_components={n_components} must be between 1 and "
                         f"min(n_samples, n_features)={min(n, d)}")
    xc = x - x.mean(dim=0)
    evals, evecs = torch.linalg.eigh(xc.T @ xc / (n - 1))
    evals = evals.flip(0).clamp(min=0.0)
    comps = evecs.flip(1)[:, :n_components].T.contiguous()
    pick = comps.abs().argmax(dim=1, keepdim=True)
    comps *= torch.sign(comps.gather(1, pick))
    return xc @ comps.T, evals[:n_components] / evals.sum()


# ---------------------------------------------------------------------------
# logistic regression (lbfgs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LogisticFit:
    """A fitted model as sklearn stores it: ``coef`` (1 or K, D) and
    ``intercept`` (1 or K,), float64 on the host."""

    classes: np.ndarray
    coef: np.ndarray
    intercept: np.ndarray
    n_iter: int

    def predict(self, x: torch.Tensor) -> np.ndarray:
        """``classes_[argmax]`` of the decision function (binary: class 1
        where the score is > 0)."""
        coef = torch.as_tensor(self.coef, device=x.device)
        scores = (x.to(torch.float64) @ coef.T
                  + torch.as_tensor(self.intercept, device=x.device))
        if scores.shape[1] == 1:
            idx = (scores[:, 0] > 0).long()
        else:
            idx = scores.argmax(dim=1)
        return self.classes[idx.cpu().numpy()]


def _balanced_sample_weight(y_enc: np.ndarray, n_classes: int) -> np.ndarray:
    """sklearn's ``compute_class_weight("balanced")`` taken per sample."""
    recip = len(y_enc) / (n_classes * np.bincount(
        y_enc, minlength=n_classes).astype(np.float64))
    return recip[y_enc]


#: ``LogisticRegression``'s C and tol, and ``--validate``'s max_iter
LOGREG_C, LOGREG_TOL, LOGREG_MAX_ITER = 1.0, 1e-4, 1000


def fit_logistic_regression(x: torch.Tensor, y) -> LogisticFit:
    """``LogisticRegression(max_iter=1000, class_weight="balanced")
    .fit(x, y)`` with the lbfgs solver: binomial for two classes,
    multinomial above. The loss and gradient run in float64 on ``x``'s
    device; scipy's L-BFGS-B drives them with sklearn's options."""
    from scipy import optimize

    y = np.asarray(y)
    classes, y_enc = np.unique(y, return_inverse=True)
    k = len(classes)
    if k < 2:
        raise ValueError("This solver needs samples of at least 2 classes in "
                         f"the data, but the data contains only one class: "
                         f"{classes[0]!r}")
    x = x.to(torch.float64)
    dev = x.device
    n, d = x.shape
    sw_np = _balanced_sample_weight(y_enc, k)
    sw_sum = float(sw_np.sum())
    l2 = 1.0 / (LOGREG_C * sw_sum)
    sw = torch.as_tensor(sw_np, device=dev)
    binary = k == 2
    if binary:
        target = torch.as_tensor(y_enc == 1, dtype=torch.float64, device=dev)
        w0 = np.zeros(d + 1)
    else:
        onehot = torch.nn.functional.one_hot(
            torch.as_tensor(y_enc, device=dev), k).to(torch.float64)
        # classes contiguous for each feature: (K, D + 1) in Fortran order
        w0 = np.zeros(k * (d + 1))

    def loss_grad(w_np: np.ndarray) -> tuple[float, np.ndarray]:
        w = torch.as_tensor(w_np, dtype=torch.float64, device=dev)
        if binary:
            weights, b = w[:d], w[d]
            raw = x @ weights + b
            # log(1 + e^raw) − y·raw, stable at both ends
            pointwise = (raw.clamp(min=0) + torch.log1p(torch.exp(-raw.abs()))
                         - target * raw)
            g = (torch.sigmoid(raw) - target) * sw / sw_sum
            grad = torch.cat([x.T @ g + l2 * weights, g.sum().reshape(1)])
        else:
            wk = w.reshape(d + 1, k).T
            weights, b = wk[:, :d], wk[:, d]
            raw = x @ weights.T + b
            lse = torch.logsumexp(raw, dim=1)
            pointwise = lse - (raw * onehot).sum(dim=1)
            g = (torch.exp(raw - lse[:, None]) - onehot) * (sw / sw_sum)[:, None]
            grad = torch.cat([g.T @ x + l2 * weights, g.sum(dim=0)[:, None]],
                             dim=1).T.reshape(-1)
        loss = (sw * pointwise).sum() / sw_sum + 0.5 * l2 * (weights * weights).sum()
        return float(loss), grad.cpu().numpy()

    res = optimize.minimize(
        loss_grad, w0, method="L-BFGS-B", jac=True,
        options={"maxiter": LOGREG_MAX_ITER, "maxls": 50, "gtol": LOGREG_TOL,
                 "ftol": 64 * np.finfo(float).eps})
    if binary:
        coef, intercept = res.x[None, :d], res.x[d:]
    else:
        wk = res.x.reshape(k, d + 1, order="F")
        coef, intercept = wk[:, :d], wk[:, d]
    return LogisticFit(classes, np.ascontiguousarray(coef),
                       np.ascontiguousarray(intercept), int(res.nit))


# ---------------------------------------------------------------------------
# t-SNE
# ---------------------------------------------------------------------------


def knn_sq_distances(x: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k nearest neighbours of every row of ``x`` among the others, by
    squared Euclidean distance in float64 (one ``x @ xᵀ`` block and a
    ``topk`` a row block): (squared distances (N, k) float64, indices
    (N, k) int64), nearest first."""
    x = x.to(torch.float64)
    n = x.shape[0]
    if not 1 <= k < n:
        raise ValueError(f"k={k} must be in [1, n_samples={n})")
    sq = (x * x).sum(dim=1)
    rows = _block_rows(n, 3 * 8 * n)
    dists, idx = [], []
    for a in range(0, n, rows):
        b = min(n, a + rows)
        d2 = (sq[a:b, None] + sq[None, :] - 2.0 * (x[a:b] @ x.T)).clamp_(min=0.0)
        d2[torch.arange(b - a, device=x.device),
           torch.arange(a, b, device=x.device)] = math.inf
        top = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        dists.append(top.values)
        idx.append(top.indices)
    return torch.cat(dists), torch.cat(idx)


def binary_search_perplexity(sq_distances: torch.Tensor, perplexity: float
                             ) -> torch.Tensor:
    """sklearn's ``_utils._binary_search_perplexity`` over every row at once:
    the conditional P (N, k) in float64 whose entropy is log(perplexity)
    within 1e-5. Distances are taken as float32, the perplexity as a C
    float, as there; each row stops at its own step."""
    d2 = sq_distances.to(torch.float32).to(torch.float64)
    n = d2.shape[0]
    dev = d2.device
    desired = math.log(float(np.float32(perplexity)))
    beta = torch.ones(n, dtype=torch.float64, device=dev)
    beta_min = torch.full_like(beta, -math.inf)
    beta_max = torch.full_like(beta, math.inf)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    out = torch.zeros_like(d2)
    for _ in range(_BINARY_SEARCH_STEPS):
        p = torch.exp(-d2 * beta[:, None])
        sum_p = p.sum(dim=1)
        sum_p = torch.where(sum_p == 0.0, _EPSILON_DBL, sum_p)
        p /= sum_p[:, None]
        entropy = torch.log(sum_p) + beta * (d2 * p).sum(dim=1)
        diff = entropy - desired
        out = torch.where(active[:, None], p, out)
        search = active & (diff.abs() > _PERPLEXITY_TOLERANCE)
        up = search & (diff > 0.0)
        down = search & (diff <= 0.0)
        new_beta = torch.where(
            up, torch.where(beta_max == math.inf, beta * 2.0,
                            (beta + beta_max) / 2.0),
            torch.where(beta_min == -math.inf, beta / 2.0,
                        (beta + beta_min) / 2.0))
        beta_min = torch.where(up, beta, beta_min)
        beta_max = torch.where(down, beta, beta_max)
        beta = torch.where(search, new_beta, beta)
        active = search
        if not bool(active.any()):
            break
    return out


@dataclasses.dataclass
class JointP:
    """The symmetric sparse joint P as COO edges sorted by (row, column):
    both (i, j) and (j, i) are stored, ``vals`` float64 summing to 1."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    n: int


def joint_probabilities_nn(cond_p: torch.Tensor, neighbors: torch.Tensor
                           ) -> JointP:
    """sklearn's ``_joint_probabilities_nn`` after the binary search:
    P + Pᵀ over the kNN graph, divided by its sum."""
    n, k = cond_p.shape
    rows = torch.arange(n, device=cond_p.device).repeat_interleave(k)
    cols = neighbors.reshape(-1)
    # (i, j) and (j, i) summed per pair: a key per pair, sorted as CSR is;
    # at most two terms a key, so the atomic adds' order cannot change a sum
    keys, inverse = torch.unique(torch.cat([rows * n + cols, cols * n + rows]),
                                 sorted=True, return_inverse=True)
    p = cond_p.reshape(-1).to(torch.float64)
    vals = torch.zeros(len(keys), dtype=torch.float64,
                       device=cond_p.device).index_add_(0, inverse,
                                                        torch.cat([p, p]))
    vals /= vals.sum().clamp(min=_MACHINE_EPSILON)
    return JointP(keys // n, keys % n, vals, n)


def tsne_affinities(x: torch.Tensor, perplexity: float) -> JointP:
    """The joint P of ``TSNE(perplexity)`` with ``method="barnes_hut"``:
    the kNN graph, the binary search, the symmetrised normalisation."""
    n = x.shape[0]
    k = min(n - 1, int(3.0 * perplexity + 1))
    d2, idx = knn_sq_distances(x, k)
    return joint_probabilities_nn(binary_search_perplexity(d2, perplexity), idx)


def tsne_init(x: torch.Tensor) -> torch.Tensor:
    """``init="pca"``: the PCA(2) scores in float32, scaled so that column 0
    has standard deviation 1e-4."""
    if min(x.shape) < 2:
        raise ValueError("t-SNE's PCA init needs at least 2 samples and 2 "
                         "features")
    y = pca(x, 2)[0].to(torch.float32)
    return y / y[:, 0].std(correction=0) * 1e-4


def tsne_repulsion_reference(y: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """t-SNE's exact repulsion, plain version: ``(neg (N, D) in y's dtype,
    sum_q float64 scalar)``, ``neg[i] = Σ_{j≠i} q_ij² (y_i − y_j)``,
    ``sum_q = Σ_{i≠j} q_ij``, ``q_ij = 1 / (1 + |y_i − y_j|²)``. Row blocks
    of at most :data:`BLOCK_BYTES`, each writing the coordinate differences,
    q, q² and their products in y's dtype and summing q in float64."""
    n, dim = y.shape
    rows = _block_rows(n, (dim + 4) * y.element_size() * n)
    neg = torch.empty_like(y)
    sum_q = torch.zeros((), dtype=torch.float64, device=y.device)
    ar = torch.arange(rows, device=y.device)
    for a in range(0, n, rows):
        b = min(n, a + rows)
        diffs = [y[a:b, c:c + 1] - y[None, :, c] for c in range(dim)]
        q = diffs[0] * diffs[0]
        for dc in diffs[1:]:
            q.addcmul_(dc, dc)
        q.add_(1.0).reciprocal_()
        q[ar[:b - a], ar[:b - a] + a] = 0.0
        sum_q += q.sum(dtype=torch.float64)
        q.mul_(q)
        for c, dc in enumerate(diffs):
            neg[a:b, c] = (q * dc).sum(dim=1)
    return neg, sum_q


def tsne_repulsion(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(neg, sum_q)`` of the embedding ``y`` (N, D): the kernel of
    ``ops/tsne_repulsion.py`` for CUDA tensors (which takes D = 2 and
    raises on anything else), :func:`tsne_repulsion_reference` for CPU
    tensors."""
    if y.device.type == "cpu":
        return tsne_repulsion_reference(y)
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.tsne_repulsion import (
        tsne_repulsion_kernel,
    )

    return tsne_repulsion_kernel(y.contiguous())


class KLObjective:
    """The t-SNE objective at one degree of freedom (a 2-D embedding): the
    KL divergence of P and Q and its gradient. Attraction runs over the
    sparse P edges, summed a row at a time in edge order (no atomic adds, so
    a run repeats bit for bit on the card); repulsion is exact over all
    pairs (:func:`tsne_repulsion`). The KL is sklearn's Barnes–Hut error term
    (Σ p·log(max(p, tiny) / max(q, tiny)) over the edges), computed only
    when asked for. Works in the embedding's dtype; Σ q in float64."""

    def __init__(self, p: JointP, dtype: torch.dtype = torch.float32):
        self.p = p
        self.dtype = dtype
        self.vals = p.vals.to(dtype)
        self.row_lengths = torch.bincount(p.rows, minlength=p.n)

    def scale(self, factor: float) -> None:
        """Multiply P in place (early exaggeration), in float64 as sklearn
        does, then take it in the working dtype."""
        self.p.vals.mul_(factor)
        self.vals = self.p.vals.to(self.dtype)

    def unscale(self, factor: float) -> None:
        self.p.vals.div_(factor)
        self.vals = self.p.vals.to(self.dtype)

    def attraction(self, y: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(pos (N, D), q_edge)`` of the embedding ``y`` (N, D) in the
        working dtype: ``pos[i] = Σ_j p_ij q_ij (y_i − y_j)`` over the P
        edges, a row at a time in edge order."""
        diff = y[self.p.rows] - y[self.p.cols]
        q_edge = 1.0 / (1.0 + (diff * diff).sum(dim=1))
        pos = torch.segment_reduce((self.vals * q_edge)[:, None] * diff, "sum",
                                   lengths=self.row_lengths, unsafe=True)
        return pos, q_edge

    def __call__(self, y: torch.Tensor, compute_error: bool = True
                 ) -> tuple[float, torch.Tensor]:
        y = y.reshape(self.p.n, -1).to(self.dtype)
        neg, sum_q = tsne_repulsion(y)
        sum_q = sum_q.clamp(min=_MACHINE_EPSILON)
        pos, q_edge = self.attraction(y)
        grad = 4.0 * (pos - neg / sum_q.to(self.dtype))
        error = math.nan
        if compute_error:
            p = self.vals.to(torch.float64)
            qn = q_edge.to(torch.float64) / sum_q
            error = float((p * torch.log(p.clamp(min=_FLOAT32_TINY)
                                         / qn.clamp(min=_FLOAT32_TINY))).sum())
        return error, grad.reshape(-1)


def descent_step(p: torch.Tensor, grad: torch.Tensor, update: torch.Tensor,
                 gains: torch.Tensor, momentum: float, learning_rate: float,
                 min_gain: float
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step of :func:`gradient_descent` after the gradient: the gains
    (+0.2 where the update and the gradient disagree in sign, ×0.8
    elsewhere, at least ``min_gain``), the momentum update, ``p`` moved in
    place. Returns (the gained gradient, update, gains)."""
    inc = update * grad < 0.0
    gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_(min=min_gain)
    grad = grad * gains
    update = momentum * update - learning_rate * grad
    p += update
    return grad, update, gains


def gradient_descent(objective: Callable, p0: torch.Tensor, it: int,
                     max_iter: int, n_iter_check: int,
                     n_iter_without_progress: int, momentum: float,
                     learning_rate: float, min_gain: float,
                     min_grad_norm: float
                     ) -> tuple[torch.Tensor, float, int]:
    """sklearn's ``manifold._t_sne._gradient_descent``: momentum with
    delta-bar-delta gains (+0.2 where the update and the gradient disagree
    in sign, ×0.8 elsewhere, at least ``min_gain``), the error asked for
    every ``n_iter_check`` iterations and at the last, a stop after
    ``n_iter_without_progress`` iterations without a better error or at a
    gradient norm ≤ ``min_grad_norm``. Returns (p, error, last iteration)."""
    p = p0.clone().reshape(-1)
    update = torch.zeros_like(p)
    gains = torch.ones_like(p)
    error = best_error = float(np.finfo(float).max)
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % n_iter_check == 0
        error, grad = objective(p, compute_error=check or i == max_iter - 1)
        grad, update, gains = descent_step(p, grad, update, gains, momentum,
                                           learning_rate, min_gain)
        if check:
            grad_norm = float(torch.linalg.vector_norm(grad))
            if error < best_error:
                best_error = error
                best_iter = i
            elif i - best_iter > n_iter_without_progress:
                break
            if grad_norm <= min_grad_norm:
                break
    return p, error, i


#: sklearn's ``TSNE`` defaults and schedule
EARLY_EXAGGERATION = 12.0
EXPLORATION_ITER = 250
MAX_ITER = 1000
N_ITER_CHECK = 50
N_ITER_WITHOUT_PROGRESS = 300
MIN_GAIN = 0.01
MIN_GRAD_NORM = 1e-7


def tsne_descent(objective: KLObjective, y0: torch.Tensor,
                 learning_rate: float) -> tuple[torch.Tensor, float, int]:
    """``TSNE._tsne``: 250 iterations at momentum 0.5 on the exaggerated P,
    then a fresh descent (update 0, gains 1) at momentum 0.8 up to
    :data:`MAX_ITER`. Returns (embedding (N, 2), KL, last iteration)."""
    kw = dict(n_iter_check=N_ITER_CHECK, learning_rate=learning_rate,
              min_gain=MIN_GAIN, min_grad_norm=MIN_GRAD_NORM)
    objective.scale(EARLY_EXAGGERATION)
    p, kl, it = gradient_descent(
        objective, y0.to(objective.dtype), 0, EXPLORATION_ITER,
        n_iter_without_progress=EXPLORATION_ITER, momentum=0.5, **kw)
    objective.unscale(EARLY_EXAGGERATION)
    if it < EXPLORATION_ITER or MAX_ITER - EXPLORATION_ITER > 0:
        p, kl, it = gradient_descent(
            objective, p, it + 1, MAX_ITER,
            n_iter_without_progress=N_ITER_WITHOUT_PROGRESS, momentum=0.8,
            **kw)
    return p.reshape(y0.shape), kl, it


@dataclasses.dataclass
class TSNEResult:
    embedding: torch.Tensor
    kl_divergence: float
    n_iter: int


def tsne_learning_rate(n: int) -> float:
    """``learning_rate="auto"``."""
    return max(n / EARLY_EXAGGERATION / 4, 50.0)


def tsne(x: torch.Tensor, perplexity: float = 30.0) -> TSNEResult:
    """``TSNE(n_components=2, perplexity=perplexity).fit_transform(x)`` on
    ``x``'s device, float32 as sklearn's (see the module docstring for the
    one difference)."""
    n = x.shape[0]
    if perplexity >= n:
        raise ValueError(f"perplexity ({perplexity}) must be less than "
                         f"n_samples ({n})")
    objective = KLObjective(tsne_affinities(x, perplexity))
    y, kl, it = tsne_descent(objective, tsne_init(x), tsne_learning_rate(n))
    return TSNEResult(y, kl, it)


def kl_divergence(p: JointP, y: torch.Tensor) -> float:
    """The t-SNE objective's KL of P and the embedding ``y``, in float64."""
    return KLObjective(p, torch.float64)(y, compute_error=True)[0]


def trustworthiness(x: torch.Tensor, y: torch.Tensor, n_neighbors: int = 5
                    ) -> float:
    """sklearn's ``manifold.trustworthiness(x, y, n_neighbors)``: how far
    each point's ``n_neighbors`` nearest in ``y`` rank among its nearest in
    ``x`` (ranks by distance in float64, row blocks on ``x``'s device)."""
    x = x.to(torch.float64)
    y = y.to(device=x.device, dtype=torch.float64)
    n, k = x.shape[0], n_neighbors
    if k >= n / 2:
        raise ValueError(f"n_neighbors ({k}) should be less than n_samples / "
                         f"2 ({n / 2})")
    sx, sy = (x * x).sum(dim=1), (y * y).sum(dim=1)
    rows = _block_rows(n, (4 * 8 + k) * n)
    t = 0
    for a in range(0, n, rows):
        b = min(n, a + rows)
        ar = torch.arange(b - a, device=x.device)
        dx = (sx[a:b, None] + sx[None, :] - 2.0 * (x[a:b] @ x.T)).clamp_(min=0.0)
        dy = ((y[a:b, None, :] - y[None, :, :]) ** 2).sum(dim=2)
        dx[ar, ar + a] = math.inf
        dy[ar, ar + a] = math.inf
        nbr = torch.topk(dy, k, dim=1, largest=False).indices
        ranks = (dx[:, None, :] < dx.gather(1, nbr)[:, :, None]).sum(dim=2) + 1
        t += int((ranks - k).clamp(min=0).sum())
    return 1.0 - t * (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)))
