"""Official CAMELYON16 FROC evaluation, in numpy and scipy.

Copy of the JAX package's ``evaluation/froc.py`` (the challenge's algorithm:
annotations expanded by 75 µm through a distance transform, 8-connected
regions, isolated tumor cells below 275 µm left out, one TP per region at
its best score, the FROC curve and its mean sensitivity at 1/4 … 8 false
positives an image), held to the original by exact tests. The mask hit
test divides coordinates by 2^level in integers. A slide-container mask is
read through the port's ``io/slide.py``; ``plot_froc`` needs matplotlib,
which is imported only there, and where it is missing the plot is skipped
with a log line.
"""

from __future__ import annotations

import os

import numpy as np
from scipy import ndimage as nd

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    EVALUATION_MASK_LEVEL,
    L0_RESOLUTION_UM_PER_PX,
    FROC_ANNOTATION_EXPANSION_UM,
    FROC_ITC_THRESHOLD_UM,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)

log = get_logger("evaluation.froc")

#: 8-connectivity structuring element (= skimage ``connectivity=2`` in 2D)
_CONN8 = np.ones((3, 3), dtype=int)


def compute_evaluation_mask(
    mask: np.ndarray | str,
    resolution: float = L0_RESOLUTION_UM_PER_PX,
    level: int = EVALUATION_MASK_LEVEL,
) -> np.ndarray:
    """Ground-truth mask → labeled evaluation regions
    (``evaluation_FROC.py:14-35``).

    Args:
        mask: (H, W) uint8 mask at ``level`` (tumor > 0), or a slide path
            whose level-``level`` plane is the mask.
        resolution: µm/px at level 0.
        level: pyramid level of ``mask``.
    """
    if isinstance(mask, str):
        from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
            open_slide,
        )

        slide = open_slide(mask)
        try:
            w, h = slide.level_dimensions[level]
            mask = slide.read_region((0, 0), level, (w, h))[:, :, 0]
        finally:
            slide.close()
    mask = np.asarray(mask)
    if mask.ndim == 3:
        mask = mask[:, :, 0]

    # 75µm is the equivalent size of 5 tumor cells: expand annotations by
    # thresholding the distance transform of the background.
    distance = nd.distance_transform_edt(255 - np.where(mask > 0, 255, 0))
    threshold = FROC_ANNOTATION_EXPANSION_UM / (resolution * pow(2, level) * 2)
    binary = distance < threshold
    filled = nd.binary_fill_holes(binary)
    evaluation_mask, _ = nd.label(filled, structure=_CONN8)
    return evaluation_mask


def _major_axis_length(coords: np.ndarray) -> float:
    """skimage ``regionprops().major_axis_length``: 4·sqrt(largest eigenvalue
    of the normalized second central moments of the pixel coordinates)."""
    if len(coords) == 0:
        return 0.0
    c = coords - coords.mean(axis=0, keepdims=True)
    mu20 = np.mean(c[:, 0] ** 2) + 1 / 12.0
    mu02 = np.mean(c[:, 1] ** 2) + 1 / 12.0
    mu11 = np.mean(c[:, 0] * c[:, 1])
    common = np.sqrt((mu20 - mu02) ** 2 + 4 * mu11**2)
    lam1 = (mu20 + mu02 + common) / 2.0
    return float(4.0 * np.sqrt(lam1))


def compute_itc_list(
    evaluation_mask: np.ndarray,
    resolution: float = L0_RESOLUTION_UM_PER_PX,
    level: int = EVALUATION_MASK_LEVEL,
) -> list[int]:
    """Labels whose major axis < 275 µm → Isolated Tumor Cells
    (``evaluation_FROC.py:38-64``)."""
    max_label = int(evaluation_mask.max())
    threshold = FROC_ITC_THRESHOLD_UM / (resolution * pow(2, level))
    itc = []
    ys, xs = np.nonzero(evaluation_mask)
    labels = evaluation_mask[ys, xs]
    for i in range(1, max_label + 1):
        sel = labels == i
        coords = np.stack([ys[sel], xs[sel]], axis=1).astype(np.float64)
        if _major_axis_length(coords) < threshold:
            itc.append(i)
    return itc


def read_csv_content(csv_path: str) -> tuple[list[float], list[int], list[int]]:
    """Detection CSV ``prob,x,y`` → (probs, Xcorr, Ycorr)
    (``evaluation_FROC.py:67-88``)."""
    probs, xcorr, ycorr = [], [], []
    with open(csv_path) as f:
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            elems = line.split(",")
            probs.append(float(elems[0]))
            xcorr.append(int(float(elems[1])))
            ycorr.append(int(float(elems[2])))
    return probs, xcorr, ycorr


def compute_fp_tp_probs(
    ycorr,
    xcorr,
    probs,
    is_tumor: bool,
    evaluation_mask: np.ndarray | None,
    itc_labels: list[int],
    level: int = EVALUATION_MASK_LEVEL,
):
    """FP/TP assignment per image (``evaluation_FROC.py:91-155``), with the
    mask hit test using integer division (fixing the Py2 ``/`` bug at
    ``evaluation_FROC.py:134``).

    Returns (fp_probs, tp_probs, num_of_tumors, detection_summary, fp_summary).
    """
    fp_probs: list[float] = []
    fp_summary: dict[str, list] = {}
    detection_summary: dict[str, list] = {}
    fp_counter = 0

    if not is_tumor or evaluation_mask is None:
        for i in range(len(xcorr)):
            fp_probs.append(probs[i])
            fp_summary[f"FP {fp_counter}"] = [probs[i], xcorr[i], ycorr[i]]
            fp_counter += 1
        return fp_probs, np.zeros((0,), np.float32), 0, detection_summary, fp_summary

    max_label = int(evaluation_mask.max())
    tp_probs = np.zeros((max_label,), dtype=np.float32)
    for i in range(1, max_label + 1):
        if i not in itc_labels:
            detection_summary[f"Label {i}"] = []

    scale = pow(2, level)
    h, w = evaluation_mask.shape
    for i in range(len(xcorr)):
        y = int(ycorr[i]) // scale
        x = int(xcorr[i]) // scale
        hit = (
            int(evaluation_mask[y, x]) if (0 <= y < h and 0 <= x < w) else 0
        )
        if hit == 0:
            fp_probs.append(probs[i])
            fp_summary[f"FP {fp_counter}"] = [probs[i], xcorr[i], ycorr[i]]
            fp_counter += 1
        elif hit not in itc_labels:
            if probs[i] > tp_probs[hit - 1]:
                detection_summary[f"Label {hit}"] = [probs[i], xcorr[i], ycorr[i]]
                tp_probs[hit - 1] = probs[i]

    num_of_tumors = max_label - len(itc_labels)
    return fp_probs, tp_probs, num_of_tumors, detection_summary, fp_summary


def compute_froc(froc_data: dict):
    """FROC curve points over all images (``evaluation_FROC.py:158-183``).

    Args:
        froc_data: dict with per-image lists under keys
            "fp_probs", "tp_probs", "num_tumors" (+ "names" optional).
    Returns:
        (total_fps_per_image, total_sensitivity) arrays.
    """
    all_fps = [p for image in froc_data["fp_probs"] for p in image]
    all_tps = [p for image in froc_data["tp_probs"] for p in np.asarray(image)]
    num_images = len(froc_data["fp_probs"])
    total_tumors = float(sum(froc_data["num_tumors"]))

    total_fps, total_tps = [], []
    all_probs = sorted(set(all_fps + all_tps))
    for thresh in all_probs[1:]:
        total_fps.append((np.asarray(all_fps) >= thresh).sum())
        total_tps.append((np.asarray(all_tps) >= thresh).sum())
    total_fps.append(0)
    total_tps.append(0)
    fps_per_image = np.asarray(total_fps) / float(max(num_images, 1))
    sensitivity = np.asarray(total_tps) / max(total_tumors, 1.0)
    return fps_per_image, sensitivity


def froc_score(
    fps_per_image: np.ndarray,
    sensitivity: np.ndarray,
    fp_points=(0.25, 0.5, 1, 2, 4, 8),
) -> float:
    """The challenge's summary score: mean sensitivity at the standard
    FP/image operating points."""
    sens_at = []
    for fp in fp_points:
        valid = fps_per_image <= fp
        sens_at.append(float(sensitivity[valid].max()) if valid.any() else 0.0)
    return float(np.mean(sens_at))


def plot_froc(
    fps_per_image: np.ndarray, sensitivity: np.ndarray, save_path: str | None = None
) -> None:
    """FROC plot (``evaluation_FROC.py:186-205``), saved instead of shown;
    skipped, with a log line, where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        log.info("matplotlib is not installed: FROC plot %s skipped", save_path)
        return

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    plt.xlabel("Average Number of False Positives", fontsize=12)
    plt.ylabel("Metastasis detection sensitivity", fontsize=12)
    fig.suptitle(
        "Free response receiver operating characteristic curve", fontsize=12
    )
    plt.plot(fps_per_image, sensitivity, "-", color="#000000")
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        plt.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def run_froc_evaluation(
    csv_dir: str,
    mask_dir: str,
    resolution: float = L0_RESOLUTION_UM_PER_PX,
    level: int = EVALUATION_MASK_LEVEL,
    plot_path: str | None = None,
) -> dict:
    """Dataset-level evaluation (reference ``src/main.py:1168-1225``): evaluates
    every ``*.csv`` in ``csv_dir`` against masks ``{case}_mask`` in
    ``mask_dir`` (tumor cases only; missing mask ⇒ normal case)."""
    result = {"fp_probs": [], "tp_probs": [], "num_tumors": [], "names": []}
    csv_files = sorted(f for f in os.listdir(csv_dir) if f.endswith(".csv"))
    for fname in csv_files:
        case = fname[: -len(".csv")]
        probs, xcorr, ycorr = read_csv_content(os.path.join(csv_dir, fname))
        mask_path = None
        # accept both the reference's "{case}_Mask.tif" (src/main.py:1198)
        # and lowercase variants across containers
        for suffix in ("_Mask", "_mask"):
            for ext in (".wsi.npz", ".tif", ".tiff", ".npy"):
                cand = os.path.join(mask_dir, f"{case}{suffix}{ext}")
                if os.path.exists(cand):
                    mask_path = cand
                    break
            if mask_path:
                break
        if mask_path is not None:
            if mask_path.endswith(".npy"):
                eval_mask = compute_evaluation_mask(
                    np.load(mask_path), resolution, level
                )
            else:
                eval_mask = compute_evaluation_mask(mask_path, resolution, level)
            itc = compute_itc_list(eval_mask, resolution, level)
            is_tumor = True
        else:
            eval_mask, itc, is_tumor = None, [], False
        fp, tp, n_tumors, _, _ = compute_fp_tp_probs(
            ycorr, xcorr, probs, is_tumor, eval_mask, itc, level
        )
        result["fp_probs"].append(fp)
        result["tp_probs"].append(tp)
        result["num_tumors"].append(n_tumors)
        result["names"].append(case)

    fps, sens = compute_froc(result)
    result["fps_per_image"] = fps
    result["sensitivity"] = sens
    result["score"] = froc_score(fps, sens)
    log.info("FROC score (avg sensitivity @ standard FP rates): %.4f", result["score"])
    if plot_path:
        plot_froc(fps, sens, plot_path)
    return result
