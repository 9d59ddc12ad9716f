"""Evaluation: FROC, feature sanity checks, metrics, uncertainty.

The names of the JAX package's ``evaluation`` resolve here at first use."""

from ss25_hierarchical_multiscale_image_classification_tpu_torch._exports import (
    lazy_exports,
)

__getattr__, __dir__ = lazy_exports(__name__, {
    "compute_evaluation_mask": "froc",
    "compute_fp_tp_probs": "froc",
    "compute_froc": "froc",
    "compute_itc_list": "froc",
    "read_csv_content": "froc",
    "validate_features": "features_eval",
    "accuracy_score": "metrics",
    "confusion_matrix": "metrics",
    "f1_score": "metrics",
    "precision_score": "metrics",
    "recall_score": "metrics",
    "monte_carlo_dropout": "uncertainty",
    "softmax_thresholding": "uncertainty",
})
