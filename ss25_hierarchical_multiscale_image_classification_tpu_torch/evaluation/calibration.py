"""Post-hoc calibration of the multiscale classifier's detection scores.

Copy of the JAX package's ``evaluation/calibration.py``, held to it by
exact tests (host numpy and ``scipy.optimize.minimize_scalar``):

- :func:`fit_temperature` fits one temperature per head by validation NLL
  (:func:`_nll`);
- :func:`roc_auc` (Mann-Whitney U, tie-aware) and :func:`patch_froc_proxy`
  (mean sensitivity at fixed false positives per slide) score a surface;
- :func:`pick_combine_mode` selects the surface an artifact ships as its
  default (fusion, the aux mean, the base level's aux head, or a mixture
  from :func:`_best_mixture`), :func:`pick_ensemble_weight` a mixture by AUC;
- :func:`fit_cascade_margin` the cascade's screen floor over the
  validation lesions (:func:`_lesion_groups`), or None;
- :data:`COMBINE_MODES`, :func:`encode_combine` and :func:`decode_combine`:
  an artifact stores its default surface as an int code, since a tree of
  arrays carries no strings.

Mixing happens in calibrated log-odds space, where the producer ranks
detections; probability space saturates confident cells to ties.
"""

from __future__ import annotations

import numpy as np

from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)

log = get_logger("evaluation.calibration")


def _nll(logits: np.ndarray, labels: np.ndarray, temperature: float) -> float:
    """Mean negative log-likelihood of softmax(logits / T)."""
    z = logits.astype(np.float64) / float(temperature)
    z = z - z.max(axis=-1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=-1, keepdims=True))
    return float(-logp[np.arange(len(labels)), labels].mean())


def fit_temperature(
    logits: np.ndarray,
    labels: np.ndarray,
    bounds: tuple[float, float] = (0.05, 20.0),
) -> float:
    """Scalar temperature minimizing val NLL (1-D bounded search).

    Returns 1.0 when the fit is degenerate (one class absent, <2 samples).
    """
    labels = np.asarray(labels)
    logits = np.asarray(logits, np.float64)
    if len(labels) < 2 or len(np.unique(labels)) < 2:
        return 1.0
    from scipy.optimize import minimize_scalar

    # optimize in log-T so the search treats 0.5 and 2.0 symmetrically
    res = minimize_scalar(
        lambda logt: _nll(logits, labels, float(np.exp(logt))),
        bounds=(np.log(bounds[0]), np.log(bounds[1])),
        method="bounded",
    )
    t = float(np.exp(res.x))
    log.info("temperature fit: T=%.3f (NLL %.4f → %.4f)", t,
             _nll(logits, labels, 1.0), _nll(logits, labels, t))
    return t


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based ROC-AUC (Mann-Whitney U), tie-aware; 0.5 if degenerate."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    pos = scores[labels == 1]
    neg = scores[labels == 0]
    if len(pos) == 0 or len(neg) == 0:
        return 0.5
    # midranks over the pooled sample
    pooled = np.concatenate([pos, neg])
    order = np.argsort(pooled, kind="mergesort")
    ranks = np.empty(len(pooled), np.float64)
    sorted_vals = pooled[order]
    i = 0
    while i < len(pooled):
        j = i
        while j + 1 < len(pooled) and sorted_vals[j + 1] == sorted_vals[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    r_pos = ranks[: len(pos)].sum()
    u = r_pos - len(pos) * (len(pos) + 1) / 2.0
    return float(u / (len(pos) * len(neg)))


# order matches the score-column layout of
# ``infer/multiscale._combine_scores`` (COMBINE_COLUMNS): index == column.
# aux_base = the BASE (detection-grid) level's aux head alone, at the same
# magnification the single-level producer runs (max level number = most
# downsampled); ensemble_base mixes the fusion head with it.
COMBINE_MODES = ("ensemble", "fusion", "aux", "aux_base", "ensemble_base")


def encode_combine(mode: str) -> int:
    """Combine mode → int code (artifacts carry no strings)."""
    return COMBINE_MODES.index(mode)


#: earlier artifacts shipped these names for the base-level surfaces (the
#: sorted index -1 level is the MOST downsampled one, not the finest)
_LEGACY_COMBINE = {"aux_fine": "aux_base", "ensemble_fine": "ensemble_base"}


def decode_combine(value) -> str:
    """Int code (or already-decoded string) → combine mode."""
    if isinstance(value, str):
        return _LEGACY_COMBINE.get(value, value)
    return COMBINE_MODES[int(np.asarray(value))]


def patch_froc_proxy(
    scores: np.ndarray,
    labels: np.ndarray,
    slides: np.ndarray,
    fp_rates: tuple[float, ...] = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0),
) -> float:
    """Patch-level FROC surrogate: mean sensitivity at fixed FP-per-slide
    rates, the quantity the official consumer averages
    (``evaluation/froc.py``, reference
    ``src/utils/evaluation_FROC.py:176-187``) — computed on held-out patch
    scores instead of detections.

    Pooled ROC-AUC is the wrong selection metric for a detector: it
    integrates ranking quality over ALL operating points, while FROC only
    scores the low-FP regime (≤8 FPs per slide) — a head whose negatives
    have a heavy right tail can win AUC on bulk separation and still sink
    FROC (round 3's second multiscale run: val AUC 0.981 ensemble vs
    0.915 fusion, test FROC 0.841 vs 0.886). Here a false positive is a
    label-0 patch above threshold, normalized by the number of distinct
    val slides; the threshold for each target rate is set by the
    negatives' order statistics.
    """
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    slides = np.asarray(slides)
    pos = scores[labels == 1]
    neg = np.sort(scores[labels == 0])[::-1]  # descending
    n_slides = max(len(np.unique(slides)), 1)
    if len(pos) == 0:
        return 0.0
    sens = []
    for r in fp_rates:
        k = int(r * n_slides)
        if k >= len(neg):
            sens.append(1.0)
        else:
            # threshold just above the (k+1)-th largest negative → exactly
            # k FPs (modulo ties); sensitivity = positives strictly above
            sens.append(float(np.mean(pos > neg[k])))
    return float(np.mean(sens))


def _best_mixture(m_a, m_b, labels, slides, grid):
    """Best w for ``w*m_a + (1-w)*m_b`` by :func:`patch_froc_proxy`.

    Returns (w, proxy); ties prefer the middle (variance-reducing
    default when the heads are indistinguishable on val)."""
    by_w = {
        float(w): patch_froc_proxy(
            w * m_a + (1.0 - w) * m_b, labels, slides
        )
        for w in grid
    }
    w = max(by_w, key=lambda v: (by_w[v], -abs(v - 0.5)))
    return float(w), by_w[w]


def pick_combine_mode(
    m_fusion: np.ndarray,
    m_aux: np.ndarray,
    labels: np.ndarray,
    slides: np.ndarray,
    grid: np.ndarray | None = None,
    m_aux_base: np.ndarray | None = None,
) -> tuple[str, dict, dict]:
    """Select the detection surface the artifact ships as its default.

    Scores every candidate surface by :func:`patch_froc_proxy` on the
    held-out slides: fusion-only, the per-scale aux mean, the BASE
    (detection-grid) level's aux head alone (``m_aux_base``, when given),
    and the grid-searched mixtures fusion×aux-mean (``ensemble``) and
    fusion×aux-base (``ensemble_base``). Returns ``(mode, weights,
    proxies)`` where ``mode`` ∈ ``COMBINE_MODES`` is the argmax (ties
    prefer fusion — the primary head — then the mixtures, then the
    single aux surfaces), ``weights`` carries the best
    ``ensemble_weight`` / ``ensemble_base_weight`` for BOTH mixture
    families, and ``proxies`` maps each candidate to its proxy score.
    """
    if grid is None:
        grid = np.linspace(0.0, 1.0, 21)
    labels = np.asarray(labels)
    p_fusion = patch_froc_proxy(m_fusion, labels, slides)
    p_aux = patch_froc_proxy(m_aux, labels, slides)
    w_ens, p_ens = _best_mixture(m_fusion, m_aux, labels, slides, grid)
    proxies = {"fusion": p_fusion, "ensemble": p_ens, "aux": p_aux}
    weights = {"ensemble_weight": w_ens, "ensemble_base_weight": 0.5}
    # candidate order IS the tie preference: later wins only strictly
    order = ["fusion", "ensemble", "aux"]
    if m_aux_base is not None:
        w_base, p_ens_base = _best_mixture(
            m_fusion, m_aux_base, labels, slides, grid
        )
        proxies["ensemble_base"] = p_ens_base
        proxies["aux_base"] = patch_froc_proxy(m_aux_base, labels, slides)
        weights["ensemble_base_weight"] = w_base
        order = ["fusion", "ensemble", "ensemble_base", "aux_base", "aux"]
    mode = order[0]
    for cand in order[1:]:
        if proxies[cand] > proxies[mode] + 1e-12:
            mode = cand
    log.info(
        "combine mode: %s (weights %s; patch-FROC proxies %s)",
        mode, weights, {k: round(v, 4) for k, v in proxies.items()},
    )
    return mode, weights, proxies


def pick_ensemble_weight(
    p_fusion: np.ndarray,
    p_aux: np.ndarray,
    labels: np.ndarray,
    grid: np.ndarray | None = None,
) -> tuple[float, float]:
    """Pick w maximizing val ROC-AUC of ``w*p_fusion + (1-w)*p_aux``.

    Space-agnostic mixing: callers pass per-head scores in whatever space
    inference will mix them in — the FROC producer uses calibrated
    log-odds (``infer/multiscale._combine_scores``), so the trainer
    passes temperature-scaled margins here, NOT probabilities (the
    logistic saturates confident cells to exact-1.0 float ties that
    destroy rank-based selection and the downstream FROC sweep).
    Returns (w, auc). Ties prefer the middle (w=0.5) — averaging is the
    variance-reducing default when the heads are indistinguishable on val.
    """
    if grid is None:
        grid = np.linspace(0.0, 1.0, 21)
    labels = np.asarray(labels)
    best_w, best_auc = 0.5, -1.0
    for w in sorted(grid, key=lambda v: abs(v - 0.5)):
        auc = roc_auc(w * p_fusion + (1.0 - w) * p_aux, labels)
        if auc > best_auc + 1e-12:
            best_w, best_auc = float(w), auc
    log.info("ensemble weight: w=%.2f (val AUC %.4f; fusion-only %.4f, "
             "aux-only %.4f)", best_w, best_auc,
             roc_auc(p_fusion, labels), roc_auc(p_aux, labels))
    return best_w, best_auc


def _lesion_groups(slides, cells) -> np.ndarray:
    """Cluster grid cells into lesions: same slide, spatially adjacent.

    ``cells`` are (N, 2) level-0 cell origins on a regular grid; cells
    within 1.5× the observed grid pitch (Chebyshev) on the same slide
    join one group. Union-find; returns an (N,) group-id array.
    """
    slides = np.asarray(slides)
    cells = np.asarray(cells, np.float64)
    n = len(slides)
    # grid pitch = the smallest positive coordinate difference observed
    diffs = []
    for col in range(cells.shape[1]):
        u = np.unique(cells[:, col])
        if len(u) > 1:
            diffs.append(float(np.min(np.diff(u))))
    link = 1.5 * min(diffs) if diffs else 1.0

    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(n):
        for j in range(i + 1, n):
            if slides[i] != slides[j]:
                continue
            if np.max(np.abs(cells[i] - cells[j])) <= link:
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[ri] = rj
    return np.array([find(i) for i in range(n)])


def fit_cascade_margin(
    m_aux_base: np.ndarray,
    labels: np.ndarray,
    min_auc: float = 0.6,
    safety_frac: float = 0.1,
    slides=None,
    cells=None,
    min_screen_rate: float = 0.25,
) -> float | None:
    """The cascade's fitted operating point: a base-level screen-margin
    floor, less ``safety_frac`` of the screen's overall margin spread.

    Reference point, strongest evidence available first:

    - With ``slides`` + ``cells`` (val tumor cell locations): the floor
      keeps at least one cell of EVERY validation tumor LESION (spatial
      clusters of tumor cells per slide) — ``min over lesions of max
      cell margin``. This is the FROC consumer's own semantics
      (``evaluation_FROC.py:134``: a lesion counts as hit if ANY reported
      point lands inside it), so a single deep-negative cell inside an
      otherwise well-screened lesion no longer collapses the floor to
      keep-everything.
    - Otherwise: the floor keeps EVERY validation tumor cell (min cell
      margin) — maximally conservative.

    Returns ``None`` — ship NO operating point, so ``--cascade auto``
    runs the full fused pass — when the screen is uninformative on val
    (ROC-AUC < ``min_auc``). A blind screen's val-tumor statistics say
    nothing about where TEST tumors land (e.g. lesions whose texture
    cancels at the base magnification, ``scripts/froc_hard_proof.py``):
    any floor fitted to it screens out test tumors at whatever rate it
    screens tissue. Also ``None`` when val has no tumor cells, and when
    the fitted floor screens out less than ``min_screen_rate`` of the
    val NORMAL cells — a screen that keeps nearly everything can never
    repay its own pass (break-even survivor fraction ~0.56 for two
    levels; see ``infer.multiscale.predict_slide_multiscale``), so the
    artifact should not invite it.
    """
    labels = np.asarray(labels)
    m_aux_base = np.asarray(m_aux_base, np.float64)
    if not (labels == 1).any() or not (labels == 0).any():
        return None
    auc = roc_auc(m_aux_base, labels)
    if auc < min_auc:
        log.warning(
            "base-level screen is uninformative on val (AUC %.3f < %.2f); "
            "not shipping a cascade operating point — --cascade auto will "
            "run the full fused pass", auc, min_auc,
        )
        return None
    tum = labels == 1
    if slides is not None and cells is not None:
        groups = _lesion_groups(
            np.asarray(slides)[tum], np.asarray(cells)[tum]
        )
        m_tum = m_aux_base[tum]
        per_lesion_max = np.array(
            [m_tum[groups == g].max() for g in np.unique(groups)]
        )
        tumor_ref = float(per_lesion_max.min())
        log.info(
            "cascade operating point: lesion-level fit over %d val "
            "lesions (weakest lesion's best cell margin %.4g; cell-level "
            "min would have been %.4g)",
            len(per_lesion_max), tumor_ref, float(m_tum.min()),
        )
    else:
        tumor_ref = float(np.min(m_aux_base[tum]))
    spread = float(np.std(m_aux_base)) + 1e-6
    floor = tumor_ref - safety_frac * spread
    screen_rate = float((m_aux_base[labels == 0] < floor).mean())
    if screen_rate < min_screen_rate:
        log.warning(
            "cascade operating point would screen only %.0f%% of val "
            "normal cells (< %.0f%%) — the screen pass cannot repay "
            "itself; not shipping one",
            100 * screen_rate, 100 * min_screen_rate,
        )
        return None
    return floor
