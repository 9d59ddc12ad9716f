"""Command line of the port: single-slide ``--predict_slide``.

Counterpart of the single-slide branch of the JAX CLI's ``--predict_slide``
(``cli/main.py`` of the JAX package), with its flags for this path under the
same names and defaults, plus ``--device``. It loads
``<models_dir>/<model_name>.pt`` (a torchvision-layout ResNet18 state dict,
e.g. written by ``scripts/export_jax_checkpoint_to_torch.py``) and writes the
detection CSV to ``<models_dir>/model_predictions_csv/<slide>.csv``, where
the JAX CLI writes it.

    python -m ss25_hierarchical_multiscale_image_classification_tpu_torch.cli.main \\
        --predict_slide slide.wsi.npz --tissue_filter device --device cuda

Tiled TIFF slides, directory (fleet) inputs, ``--overlay``, ``--run_evaluation`` and ``--int8``
come with later slices. On the card the model runs in bfloat16, on the CPU
in float32.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    DETECTION_PROB_THRESHOLD,
    MODELS_DIR,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
    resolve_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
    predict_and_export,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import get_logger
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    load_state_dict_file,
    resnet18_from_state_dict,
)

log = get_logger("torch.cli")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="hipac-torch",
        description="Sliding-window tumor detection on one slide (PyTorch/CUDA)",
    )
    parser.add_argument("--predict_slide", type=str, required=True,
                        help="Sliding-window inference on one slide: writes "
                             "the detection CSV (FROC producer)")
    parser.add_argument("--patch_level", type=str, default="3",
                        help="WSI level to grid (0-3; 'all' means 3)")
    parser.add_argument("--stride", type=int, default=None,
                        help="Patch-grid stride in level pixels (default: "
                             "patch size, i.e. non-overlapping)")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="Cells per device batch (default 512)")
    parser.add_argument("--tissue_filter", choices=["host", "device"],
                        default="host",
                        help="Where the white-patch short-circuit runs: "
                             "'host' filters before upload; 'device' uploads "
                             "every cell and runs the fused normalize + "
                             "tissue-statistic kernel")
    parser.add_argument("--models_dir", type=str, default=None,
                        help="Model artifact dir (default: ./models_out)")
    parser.add_argument("--model_name", type=str,
                        default="resnet18_patch_classifier",
                        help="Classifier weights <models_dir>/<model_name>.pt")
    parser.add_argument("--detect_threshold", type=float, default=None,
                        help="Emission floor for detections, in probability "
                             f"space (default {DETECTION_PROB_THRESHOLD})")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="Where the model runs (default cuda; no "
                             "fallback when no card is visible)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if os.path.isdir(args.predict_slide):
        log.error("--predict_slide takes one slide file here; directory "
                  "(fleet) inputs are not ported yet")
        return 1
    device = resolve_device(args.device)
    models_dir = args.models_dir or MODELS_DIR
    weights = os.path.join(models_dir, f"{args.model_name}.pt")
    model = resnet18_from_state_dict(load_state_dict_file(weights))
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = model.to(device=device, dtype=dtype,
                     memory_format=torch.channels_last)
    level = 3 if args.patch_level == "all" else int(args.patch_level)
    threshold = (args.detect_threshold if args.detect_threshold is not None
                 else DETECTION_PROB_THRESHOLD)
    predict_kw = {}
    if args.batch_size:
        predict_kw["batch_size"] = args.batch_size
    if args.stride:
        predict_kw["stride"] = args.stride
    _, csv_path = predict_and_export(
        args.predict_slide, model,
        os.path.join(models_dir, "model_predictions_csv"),
        level=level, threshold=threshold, tissue_filter=args.tissue_filter,
        device=device, **predict_kw,
    )
    log.info("Detections written: %s", csv_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
