"""Feature sanity evaluation and analysis plots (``--validate``,
``--tsne_full``).

The JAX package's ``evaluation/features_eval.py`` on the device, without
scikit-learn (the card's machine has none): the same keys with the same
meaning, the numerics in ``evaluation/embedding.py``:

- PCA(2): explained variance ratio + per-class means;
- t-SNE(2, perplexity 30): per-class means, on a seeded 10k subsample
  above ``tsne_max_samples`` rows (``--tsne_full`` lifts it to every row);
  its repulsion is exact where sklearn's is Barnes–Hut at ``angle=0.5``, so
  the coordinates are another run of the same descent, not equal ones;
- LogisticRegression(max_iter=1000, class_weight="balanced") on an 80/20
  stratified split (the same indices as sklearn's): accuracy + confusion
  matrix;
- saved-to-disk PCA/t-SNE scatter plots and the logreg confusion heatmap
  (matplotlib and seaborn, imported inside the functions that draw);
- the unlabeled-patch QA overlay (Pillow).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
    resolve_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation import (
    embedding,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation.metrics import (
    confusion_matrix,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)

log = get_logger("evaluation.features")


def validate_features(
    features: np.ndarray,
    labels: np.ndarray,
    run_tsne: bool = True,
    tsne_perplexity: float = 30.0,
    seed: int = 42,
    tsne_max_samples: int = 10_000,
    device: str | torch.device = "cuda",
) -> dict:
    """Sanity-check extracted patch features on ``device`` (arrays come
    back as numpy on the host).

    t-SNE is O(N²) a descent step; above ``tsne_max_samples`` it runs on a
    seeded random subsample (the class-mean summary it feeds is
    statistically stable under subsampling) — full-dataset PCA and logreg
    are unaffected."""
    dev = resolve_device(device)
    features = np.asarray(features)
    result: dict = {"num_samples": len(features), "feature_dim": features.shape[1]}
    labels = np.asarray(labels)
    classes = np.unique(labels)
    x = torch.as_tensor(features, dtype=torch.float64, device=dev)

    n_comp = min(2, len(features), features.shape[1])
    if n_comp >= 1:
        coords, ratio = embedding.pca(x, n_comp)
        # sklearn's output dtype: float32 stays, anything else is float64
        pca_coords = coords.cpu().numpy().astype(
            np.result_type(features.dtype, np.float32))
        result["pca_explained_variance"] = ratio.cpu().numpy().tolist()
        result["pca_class_means"] = {
            int(c): pca_coords[labels == c].mean(axis=0).tolist() for c in classes
        }
        result["pca_coords"] = pca_coords
        log.info("PCA explained variance: %s", result["pca_explained_variance"])

    if run_tsne and len(features) >= 5:
        t_x, t_labels = x, labels
        if len(features) > tsne_max_samples:
            sel = np.random.default_rng(seed).choice(
                len(features), tsne_max_samples, replace=False
            )
            t_x, t_labels = x[torch.as_tensor(sel, device=dev)], labels[sel]
            log.info(
                "t-SNE on a %d-sample subsample of %d",
                tsne_max_samples, len(features),
            )
        # as in sklearn, the perplexity must stay below n_samples
        perplexity = min(tsne_perplexity, (len(t_x) - 1) / 3.0)
        tsne_coords = embedding.tsne(t_x, perplexity).embedding.cpu().numpy()
        result["tsne_class_means"] = {
            int(c): tsne_coords[t_labels == c].mean(axis=0).tolist() for c in classes
        }
        result["tsne_coords"] = tsne_coords
        result["tsne_labels"] = t_labels  # rows of tsne_coords (may be a subsample)

    min_class = min(int((labels == c).sum()) for c in classes)
    if len(classes) > 1 and min_class >= 2:
        # stratification needs ≥2 members per class and a test split big
        # enough to hold one of each
        test_size = max(0.2, len(classes) / len(features) + 1e-9)
        train, test = embedding.stratified_split(labels, test_size, seed)
        fit = embedding.fit_logistic_regression(
            x[torch.as_tensor(train, device=dev)], labels[train])
        preds = fit.predict(x[torch.as_tensor(test, device=dev)])
        y_te = labels[test]
        result["logreg_accuracy"] = float((preds == y_te).mean())
        result["logreg_confusion"] = confusion_matrix(y_te, preds)
        log.info("Logistic Regression Accuracy: %.4f", result["logreg_accuracy"])
    return result


# ---------------------------------------------------------------------------
# Plot suite (saved artifacts)
# ---------------------------------------------------------------------------


def _scatter(coords, labels, title: str, save_path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 6))
    for c, name, color in ((0, "normal", "#2c7fb8"), (1, "tumor", "#d7301f")):
        sel = labels == c
        ax.scatter(coords[sel, 0], coords[sel, 1], s=4, alpha=0.5,
                   label=name, color=color)
    ax.set_title(title)
    ax.legend()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_pca(features, labels, save_path: str,
             device: str | torch.device = "cuda") -> None:
    x = torch.as_tensor(np.asarray(features), dtype=torch.float64,
                        device=resolve_device(device))
    coords = embedding.pca(x, 2)[0].cpu().numpy()
    _scatter(coords, np.asarray(labels), "PCA of patch features", save_path)


def plot_tsne(features, labels, save_path: str, perplexity: float = 30.0,
              seed: int = 42, device: str | torch.device = "cuda") -> None:
    """The t-SNE scatter (``seed`` is kept for the JAX signature: the port's
    t-SNE draws nothing at random)."""
    x = torch.as_tensor(np.asarray(features), dtype=torch.float64,
                        device=resolve_device(device))
    perplexity = min(perplexity, (len(features) - 1) / 3.0)
    coords = embedding.tsne(x, perplexity).embedding.cpu().numpy()
    _scatter(coords, np.asarray(labels), "t-SNE of patch features", save_path)


def plot_logreg_confusion(confusion: np.ndarray, save_path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import seaborn as sns

    fig, ax = plt.subplots(figsize=(5, 4))
    sns.heatmap(confusion, annot=True, fmt="d", cmap="Blues",
                xticklabels=["normal", "tumor"],
                yticklabels=["normal", "tumor"], ax=ax)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_title("Logistic regression confusion matrix")
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


# ---------------------------------------------------------------------------
# Unlabeled-patch QA
# ---------------------------------------------------------------------------


def find_unlabeled_patches(level_dir: str) -> list[str]:
    """PNG patches whose filename carries neither ``_normal`` nor ``_tumor``."""
    import glob

    out = []
    for path in glob.glob(os.path.join(level_dir, "**", "*.png"), recursive=True):
        name = os.path.basename(path)
        if "_normal" not in name and "_tumor" not in name:
            out.append(path)
    return out


def overlay_unlabeled_on_wsi(
    slide_path: str,
    unlabeled_paths: list[str],
    level: int,
    save_path: str,
) -> None:
    """Red-rectangle overlay of unlabeled patch locations on a slide thumb."""
    import re

    from PIL import Image, ImageDraw

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.pyramid import (
        patch_size_for_level,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
        open_slide,
    )

    slide = open_slide(slide_path)
    try:
        w, h = slide.level_dimensions[level]
        img = Image.fromarray(slide.read_region((0, 0), level, (w, h)))
        draw = ImageDraw.Draw(img)
        ps = patch_size_for_level(level)
        for p in unlabeled_paths:
            m = re.search(r"_x(\d+)_y(\d+)", os.path.basename(p))
            if not m:
                continue
            x, y = int(m.group(1)), int(m.group(2))
            draw.rectangle([x, y, x + ps, y + ps], outline=(255, 0, 0), width=3)
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        img.save(save_path)
    finally:
        slide.close()
