"""Classification metrics on numpy arrays.

Copy of the JAX package's ``evaluation/metrics.py`` (accuracy, precision,
recall, F1, confusion matrix; binary by default), held to it by exact tests.
"""

from __future__ import annotations

import numpy as np


def accuracy_score(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if len(y_true) == 0:
        return 0.0
    return float((y_true == y_pred).mean())


def confusion_matrix(y_true, y_pred, num_classes: int | None = None) -> np.ndarray:
    y_true, y_pred = np.asarray(y_true, np.int64), np.asarray(y_pred, np.int64)
    n = num_classes or (int(max(y_true.max(), y_pred.max())) + 1 if len(y_true) else 2)
    cm = np.zeros((n, n), np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def precision_score(y_true, y_pred, positive_class: int = 1) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    tp = int(((y_pred == positive_class) & (y_true == positive_class)).sum())
    fp = int(((y_pred == positive_class) & (y_true != positive_class)).sum())
    return tp / (tp + fp) if tp + fp else 0.0


def recall_score(y_true, y_pred, positive_class: int = 1) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    tp = int(((y_pred == positive_class) & (y_true == positive_class)).sum())
    fn = int(((y_pred != positive_class) & (y_true == positive_class)).sum())
    return tp / (tp + fn) if tp + fn else 0.0


def f1_score(y_true, y_pred, positive_class: int = 1) -> float:
    p = precision_score(y_true, y_pred, positive_class)
    r = recall_score(y_true, y_pred, positive_class)
    return 2 * p * r / (p + r) if p + r else 0.0


def classification_report(y_true, y_pred, num_classes: int = 2) -> dict:
    return {
        "accuracy": accuracy_score(y_true, y_pred),
        "precision": precision_score(y_true, y_pred),
        "recall": recall_score(y_true, y_pred),
        "f1": f1_score(y_true, y_pred),
        "confusion_matrix": confusion_matrix(y_true, y_pred, num_classes),
    }
