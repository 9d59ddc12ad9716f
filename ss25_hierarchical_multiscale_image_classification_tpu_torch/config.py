"""Constants of the slide-inference slice.

Copies of the JAX package's ``config.py`` constants that this slice reads,
held to the originals by exact-equality tests. The port keeps its own copy
so that it loads nothing of the JAX package.
"""

from __future__ import annotations

#: Per-pyramid-level patch edge length in pixels; all four levels cover the
#: same physical field of view at four magnifications.
PATCH_SIZES: dict[int, int] = {0: 1792, 1: 896, 2: 448, 3: 224}

#: Patches are skipped as background when their mean RGB exceeds this.
TISSUE_MEAN_RGB_THRESHOLD: float = 240.0

#: Default emission floor (probability space) for the detection CSV. The
#: FROC consumer sweeps thresholds itself, so a low floor only adds
#: operating points at the high-FP end of the curve.
DETECTION_PROB_THRESHOLD: float = 0.05

#: ImageNet normalization of every classifier input.
IMAGENET_MEAN: tuple[float, float, float] = (0.485, 0.456, 0.406)
IMAGENET_STD: tuple[float, float, float] = (0.229, 0.224, 0.225)

#: Default model artifact directory (the JAX CLI's ``Config.models_dir``).
MODELS_DIR: str = "models_out"
