"""Command line of the port: ``--patch`` (``-p``), ``--patch_one_slide``,
``--predict_slide`` (one slide or a directory, ``--overlay``),
``--run_evaluation``, ``--train``, ``--train_strategy``, ``--prepare``,
``--validation``, ``--validate`` (``--tsne_full``), ``--evaluate``,
``--download`` (``--remote``), ``--balance_dataset``, ``--train_mil``,
``--train_multiscale``, ``--qat``, ``--extract_features`` (``--profile``),
``--quantize``, ``--mine_hard_negatives``, ``--wsi_viz``, the library
cache's ``--compile_cache_dir`` and the data tools ``--check_structure``, ``--check_good_downloaded_files``,
``--move_files`` and ``--count_tumor_patches`` (``--slide`` is parsed, as
in the JAX CLI).

Counterpart of the JAX CLI (``cli/main.py`` of the JAX package) for these
actions, with their flags under the same names and defaults, plus
``--device``. As there, one call runs every action given, in a fixed order
(``--download``, ``--move_files``, ``--patch``, ``--extract_features``,
``--train``, ``--train_strategy``, ``--prepare``, ``--validation``,
``--validate``, ``--evaluate``, ``--balance_dataset``,
``--count_tumor_patches``,
``--patch_one_slide``, ``--train_mil``, ``--train_multiscale``, ``--qat``,
``--quantize``, ``--mine_hard_negatives``, ``--predict_slide``,
``--wsi_viz``, ``--run_evaluation``), and stops with exit code 1 at a stage
whose inputs are missing; ``--check_good_downloaded_files`` and
``--check_structure`` run first and alone, and return 0;
``--config`` reads a JSON config (nested sections as in ``config.py``),
``--base_dir`` stands for ``--data_dir``, ``--store`` sets the patch store
format; an argument it does not know is logged and exits 1.

``--patch`` extracts the patches of every training slide at
``--patch_level`` (``all``: levels 0-3) into the packed store under
``<data_dir>/patches`` (``data/extract.py``): ``--extract_impl device``
rasterizes, labels and filters a level on the card when its plane fits the
budget, ``--stain_norm`` Macenko-normalizes the stored patches on the card,
``--stride`` sets the grid's stride; the manifest is ``manifest.parquet``
where pyarrow imports, else ``manifest.npz``. ``--patch --train`` streams
the extraction of the training level (3 for ``all``) into the first epoch
(``train/streaming.py``) after extracting the other levels.
``--patch_one_slide NAME`` extracts one slide. ``--mine_hard_negatives``
mines false positives of ``<models_dir>/resnet18_patch_classifier.pt`` on
the annotation-free training slides into the level's store.

``--predict_slide`` loads ``<models_dir>/<model_name>.pt`` (a
torchvision-layout ResNet18 state dict, written by ``--train`` or by
``scripts/export_jax_checkpoint_to_torch.py``) once and writes one
detection CSV a slide to ``<models_dir>/model_predictions_csv/<slide>.csv``,
where the JAX CLI writes it; given a directory, it runs every ``.tif``,
``.tiff`` and ``.wsi.npz`` slide in it, sorted, through the slide fleet
(``infer/fleet.py``): the visible cards split into groups of
``--group_size`` (default: one group of all; a size that does not divide
them is warned about and gives one group), one slide per group at a time,
each batch split over the group's cards. A slide that fails is logged, the
others go on and write their CSVs, and one ``RuntimeError`` at the end names
the count and the first failing path. A single slide uses every visible
card. Unlike the JAX fleet, which always filters tissue on the host, the
directory mode honours ``--tissue_filter device`` per slide (the partitions
are equal); ``--multiscale`` takes the same groups. ``--run_evaluation``
then scores those CSVs against
the masks under ``<data_dir>/test/mask`` (``{case}_mask.npy`` and the other
forms ``evaluation/froc.py`` reads) with the official CAMELYON16 FROC.

``--predict_slide --multiscale`` classifies every cell of the base level
(the largest of ``--levels``, default ``2,3``) from all the levels at once
with ``<models_dir>/hierarchical_classifier.pt`` (written by
``--train_multiscale`` or exported from a JAX artifact by
``scripts/export_jax_checkpoint_to_torch.py``; its calibration picks the
reported surface under ``--ms_combine auto`` and its input mode);
``--ms_components`` also writes the fusion, aux, aux_base and ensemble_base
surfaces' CSVs into ``model_predictions_csv_<surface>/``; ``--cascade
[auto|p]`` screens the tissue with the base level's aux head first (with
``--cascade_bailout``). With ``--int8`` the shared trunk runs the int8
forward, from ``<models_dir>/quantized_hierarchical_trunk.npz`` when
``--quantize --multiscale`` wrote it.

``--train`` trains the ResNet18 patch classifier on the level's patches
(weighted loss, ``--epochs``, default 30) and writes
``<models_dir>/resnet18_patch_classifier.pt`` (+``_best``, ``_epoch{N}``);
``--train_strategy --strategy {balanced,weighted_loss,self_supervised}``
writes ``resnet18_patch_classifier_<strategy>.pt`` (``self_supervised``
pretrains SimCLR first when ``simclr_encoder.pt`` is missing);
``--freeze_bn`` keeps BatchNorm's statistics; ``--evaluate`` reports the
saved classifier on the validation split. Training needs a slide under
``<data_dir>/train/img`` and the level's patch manifest. Under ``torchrun``
(``WORLD_SIZE`` set) ``--train`` and ``--train_strategy`` (SimCLR
pretraining included) train data-parallel, one process a card
(``parallel/``): ``--batch_size`` is the global batch, each rank loads its
rows, BatchNorm and NT-Xent see the global batch, the gradients are summed
over the ranks, and rank 0 writes the artifacts. ``--train_multiscale``, ``--qat``,
``--extract_features`` (rank 0 writes the triplet) and ``--patch --train``
(rank 0 extracts and sends each global batch to the ranks) run the same
way; besides these only ``--evaluate`` (on rank 0) is taken under
``torchrun``: any other action, ``--patch`` without ``--train`` among
them, makes every rank exit 2.

``--download`` fetches the first CAMELYON16 slide of each category and the
two annotation zips into ``<data_dir>`` (``--remote``: every slide up to
``SUBSET_LIMITS``), skipping files already there; ``--balance_dataset``
fetches tumor_036 … tumor_111 and extracts each one's tumor patches at level
3 (``io/download.py``). A file that fails (no network, as on the card's
machine) is logged and the run goes on, as in the JAX CLI.
``--compile_cache_dir DIR`` puts the library cache (the kernels' and the
host libraries, ``ops/build.py``) in ``DIR`` instead of ``ops/_build/``;
``off`` builds into a temporary directory removed at exit.

``--prepare`` extracts ``<data_dir>/train/mask/lesion_annotations.zip``
into ``<data_dir>/annotations``; ``--validation`` logs the level's
slide-level split; ``--validate`` checks the level's feature triplet
(PCA, t-SNE, logistic regression in torch on ``--device``, no
scikit-learn; ``--tsne_full`` runs t-SNE on every row); ``--profile``
writes a ``torch.profiler`` Chrome trace of ``--extract_features`` under
``<log_dir>/profile``.

``--train_mil`` trains the attention-MIL slide classifier on the feature
triplet under ``<data_dir>/features`` at ``--patch_level`` and writes
``<models_dir>/mil_classifier.pt``.

``--train_multiscale`` trains the hierarchical fusion classifier on the
co-located patches of ``--levels`` under ``<data_dir>/patches``
(``--ms_fusion``, ``--ms_input``, ``--epochs``, ``--batch_size``),
warm-started from ``<models_dir>/resnet18_patch_classifier.pt`` when it
exists, calibrates it on the validation cells and writes
``<models_dir>/hierarchical_classifier.pt``. ``--qat`` fine-tunes the
trained classifier under fake int8 quantization on ``--patch_level``'s
patches and writes ``<models_dir>/quantized_resnet18.npz``, which
``--int8`` serves.

    python -m ss25_hierarchical_multiscale_image_classification_tpu_torch.cli.main \\
        --predict_slide slide.wsi.npz --tissue_filter device --device cuda
    python -m ss25_hierarchical_multiscale_image_classification_tpu_torch.cli.main \\
        --predict_slide data/camelyon16/test/img --run_evaluation \\
        --data_dir data/camelyon16
    python -m ss25_hierarchical_multiscale_image_classification_tpu_torch.cli.main \\
        --train --data_dir data/camelyon16 --patch_level 3 --epochs 30
    torchrun --nproc_per_node=4 \\
        -m ss25_hierarchical_multiscale_image_classification_tpu_torch.cli.main \\
        --train --data_dir data/camelyon16 --batch_size 512
    python -m ss25_hierarchical_multiscale_image_classification_tpu_torch.cli.main \\
        --predict_slide data/camelyon16/test/img --group_size 1
    python -m ss25_hierarchical_multiscale_image_classification_tpu_torch.cli.main \\
        --train_mil --data_dir data/camelyon16 --epochs 20 --device cuda
    python -m ss25_hierarchical_multiscale_image_classification_tpu_torch.cli.main \\
        --extract_features --data_dir data/camelyon16 --patch_level 3

``--extract_features`` runs the inference-folded ResNet18 trunk of
``<models_dir>/resnet18_patch_classifier.pt`` (with ``--simclr_features``:
of ``simclr_encoder.pt``) over the level's patches under
``<data_dir>/patches`` and writes the feature triplet under
``<data_dir>/features``.

``--quantize`` calibrates the int8 (w8a8) activation scales of
``<models_dir>/resnet18_patch_classifier.pt`` once, on random training
patches of ``--patch_level`` under ``<data_dir>/patches``, and writes
``<models_dir>/quantized_resnet18.npz`` (the JAX package's artifact format).
``--int8`` with ``--predict_slide`` or ``--extract_features`` runs the int8
forward on the port's int8 kernels: from that artifact when it is there,
else with scales calibrated lazily on the run's first batches.

    python -m ss25_hierarchical_multiscale_image_classification_tpu_torch.cli.main \\
        --quantize --data_dir data/camelyon16 --patch_level 3
    python -m ss25_hierarchical_multiscale_image_classification_tpu_torch.cli.main \\
        --predict_slide slide.wsi.npz --int8
    python -m ss25_hierarchical_multiscale_image_classification_tpu_torch.cli.main \\
        --predict_slide slide.wsi.npz --multiscale --levels 2,3 --ms_components

Slides are ``.wsi.npz`` or tiled (Big)TIFF (``.tif``, ``.tiff``: the
port's libtiff decoder, ``io/tiff_slide.py``). ``--overlay`` writes
``<models_dir>/overlays/<slide file>.overlay.png`` for every slide
predicted with Pillow (the rainbow colormap is a numpy table);
``--wsi_viz`` (``<models_dir>/wsi_viz/<slide>/``) needs Pillow and
matplotlib; each raises ``ImportError`` where one it needs is missing. Only
the actions that use it resolve ``--device``.

Flags the JAX CLI ignores in a combination (``--int8`` or
``--simclr_features`` without their action, no action at all) are ignored
here too. Unlike the JAX CLI, which rebuilds
the data section and so drops it, ``--config``'s ``data.stain_norm`` is
kept. On the card the float model runs in bfloat16, on the CPU
in float32.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    DETECTION_PROB_THRESHOLD,
    Config,
    DataConfig,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.extract import (
    annotation_path_for,
    extract_patches,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
    slide_level_split,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
    load_or_scan_manifest,
    patches_extracted,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
    cuda_devices,
    local_device,
    resolve_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation.classifier_eval import (
    evaluate_resnet_classifier,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation.froc import (
    run_froc_evaluation,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.features import (
    extract_features,
    extract_features_with_simclr,
    load_feature_artifacts,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.fleet import (
    predict_slide_fleet,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.multiscale import (
    COMPONENT_EXPORTS,
    predict_and_export_multiscale,
    predict_slide_multiscale,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.overlay import (
    render_overlay,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
    SLIDE_EXTENSIONS,
    margin_detections,
    predict_and_export,
    slide_name,
    write_detection_csv,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.download import (
    download_all_tumor_extract_patches,
    download_dataset,
    images_downloaded,
    prepare_data,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import get_logger
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    hierarchical_from_state_dict,
    load_state_dict_file,
    resnet18_from_state_dict,
    split_calibration,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quant_artifact import (
    CLASSIFIER_ARTIFACT,
    TRUNK_ARTIFACT,
    maybe_load_artifact,
    quantize_classifier_to_artifact,
    quantize_trunk_to_artifact,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
    set_build_dir,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
    load_model,
    model_artifact_path,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.hard_negatives import (
    mine_hard_negatives,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.mil_trainer import (
    train_mil_classifier,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.multiscale_trainer import (
    train_multiscale_classifier,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.qat import (
    qat_finetune,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.streaming import (
    train_resnet_classifier_streaming,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.trainer import (
    train_resnet_classifier,
    train_resnet_classifier_strategic,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.utils.profiling import (
    trace,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.utils.structure import (
    check_good_files,
    check_structure,
    count_tumor_patches,
    move_files_up,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.visualization.wsi_viz import (
    visualize_and_save_wsi,
)

log = get_logger("torch.cli")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="hipac-torch",
        description="Patch extraction, sliding-window tumor detection "
                    "(single-level and hierarchical multiscale) and its "
                    "FROC evaluation, patch-classifier and multiscale "
                    "training, hard-negative mining, "
                    "attention-MIL slide classification, patch feature "
                    "extraction, int8 quantization and QAT (PyTorch/CUDA)",
    )
    parser.add_argument("--download", action="store_true",
                        help="Download CAMELYON16 dataset")
    parser.add_argument("--remote", action="store_true",
                        help="Download the full dataset (not the "
                             "1-per-class subset)")
    parser.add_argument("--balance_dataset", action="store_true",
                        help="Download tumor slides and extract tumor "
                             "patches")
    parser.add_argument("-p", "--patch", action="store_true",
                        help="Extract patches")
    parser.add_argument("--patch_one_slide", type=str, default=None,
                        help="Extract patches from a single slide (e.g. tumor_109)")
    parser.add_argument("--stain_norm", action="store_true",
                        help="Macenko H&E stain normalization of stored"
                             " patches during --patch (on-device)")
    parser.add_argument("--extract_impl", type=str, default="host",
                        choices=["host", "device"],
                        help="Patch extraction implementation: bounded-memory"
                             " host band streaming, or the on-device program"
                             " (levels whose plane fits the budget)")
    parser.add_argument("--mine_hard_negatives", action="store_true",
                        help="Harvest high-probability false positives from "
                             "annotation-free slides into the patch store "
                             "(retrain afterwards with --train)")
    parser.add_argument("--predict_slide", type=str, default=None,
                        help="Sliding-window inference on one slide, or on "
                             "every slide of a directory: writes the "
                             "detection CSVs (FROC producer)")
    parser.add_argument("--overlay", action="store_true",
                        help="With --predict_slide: save the tumor heatmap "
                             "overlay at the coarsest level (needs Pillow)")
    parser.add_argument("--wsi_viz", type=str, default=None,
                        help="Render annotation-mask QA figures for a slide "
                             "path (needs Pillow and matplotlib)")
    parser.add_argument("--check_structure", action="store_true",
                        help="Check the data directory structure")
    parser.add_argument("--count_tumor_patches", action="store_true",
                        help="Per-level tumor/normal patch census")
    parser.add_argument("--slide", type=str, default=None,
                        help="Slide name for single-slide operations")
    parser.add_argument("--move_files", action="store_true",
                        help="Flatten nested tumor/ patch directories")
    parser.add_argument("--check_good_downloaded_files", action="store_true",
                        help="Scan patch stores for corruption")
    parser.add_argument("--multiscale", action="store_true",
                        help="With --predict_slide: classify every grid "
                             "cell from all --levels magnifications at once "
                             "with the hierarchical fusion classifier "
                             "(<models_dir>/hierarchical_classifier.pt); "
                             "with --quantize: write the int8 artifact of "
                             "its shared trunk")
    parser.add_argument("--levels", type=str, default="2,3",
                        help="Comma-separated pyramid levels of "
                             "--multiscale and --train_multiscale")
    parser.add_argument("--train_multiscale", action="store_true",
                        help="Train the hierarchical multiscale fusion "
                             "classifier on co-located cross-level patches "
                             "(writes <models_dir>/hierarchical_classifier.pt "
                             "with its calibration)")
    parser.add_argument("--ms_fusion", type=str, default="concat",
                        choices=["concat", "attention"],
                        help="With --train_multiscale: how the fused head "
                             "combines the per-scale trunk features. "
                             "Prediction detects the artifact's mode")
    parser.add_argument("--ms_input", type=str, default="resize",
                        choices=["resize", "crop"],
                        help="With --train_multiscale: how a finer level's "
                             "larger patch reaches the trunk input size "
                             "(resize: box mean; crop: the center at native "
                             "magnification). Prediction follows the "
                             "artifact")
    parser.add_argument("--ms_combine", type=str, default="auto",
                        choices=["auto", "ensemble", "fusion", "aux",
                                 "aux_base", "ensemble_base"],
                        help="With --predict_slide --multiscale: which "
                             "surface to report (auto = the one the "
                             "artifact's calibration selected; aux = the "
                             "per-level mean; aux_base = the base level's "
                             "aux head; ensemble_base = fusion x aux_base "
                             "mix)")
    parser.add_argument("--ms_components", action="store_true",
                        help="With --predict_slide --multiscale: also write "
                             "the detection CSVs of the fusion, aux, "
                             "aux_base and ensemble_base surfaces (one pass; "
                             "dirs model_predictions_csv_<surface>)")
    parser.add_argument("--cascade", type=_cascade_value, nargs="?",
                        const="auto", default=None,
                        help="With --predict_slide --multiscale: screen "
                             "every tissue cell with the base level's aux "
                             "head and run the fused model on the survivors "
                             "only. Without a value the artifact's fitted "
                             "operating point; a probability overrides it")
    parser.add_argument("--cascade_bailout", type=float, default=None,
                        help="With --cascade: abandon the screen and run the "
                             "full fused pass when more than this fraction "
                             "of the probed tissue survives (default 0.6; "
                             ">= 1 disables the probe)")
    parser.add_argument("--run_evaluation", action="store_true",
                        help="Run the official CAMELYON16 FROC evaluation")
    parser.add_argument("-train", "--train", action="store_true",
                        help="Train ResNet model (weighted loss, 30 epochs)")
    parser.add_argument("--train_strategy", action="store_true",
                        help="Train with a specific strategy")
    parser.add_argument("--strategy", type=str, default="self_supervised",
                        choices=["balanced", "weighted_loss", "self_supervised"],
                        help="Training strategy")
    parser.add_argument("-eval", "--evaluate", action="store_true",
                        help="Evaluate ResNet model on the validation split")
    parser.add_argument("-prep", "--prepare", action="store_true",
                        help="Prepare data (extract annotation zips)")
    parser.add_argument("-val", "--validation", action="store_true",
                        help="Create validation set (slide-level split is "
                             "computed on the fly; kept for flag parity)")
    parser.add_argument("--validate", action="store_true",
                        help="Validate extracted patch features (sanity "
                             "check; needs scikit-learn)")
    parser.add_argument("--tsne_full", action="store_true",
                        help="With --validate: run t-SNE on ALL features"
                             " instead of the default 10k subsample")
    parser.add_argument("--freeze_bn", action="store_true",
                        help="Fine-tune with frozen BatchNorm statistics "
                             "(gamma/beta still train)")
    parser.add_argument("--train_mil", action="store_true",
                        help="Train the attention-MIL slide classifier on "
                             "extracted features")
    parser.add_argument("--extract_features", action="store_true",
                        help="Extract features from patches")
    parser.add_argument("--simclr_features", action="store_true",
                        help="With --extract_features: use the SimCLR encoder")
    parser.add_argument("--profile", action="store_true",
                        help="Capture a torch.profiler trace around "
                             "--extract_features (a Chrome trace under "
                             "<log_dir>/profile)")
    parser.add_argument("--qat", action="store_true",
                        help="Quantization-aware fine-tune of the trained "
                             "classifier (fake-quant int8 graph, "
                             "straight-through gradients); writes the int8 "
                             "artifact quantized_resnet18.npz for --int8")
    parser.add_argument("--quantize", action="store_true",
                        help="Calibrate int8 scales ONCE on training tissue "
                             "and persist the quantized model artifact "
                             "(quantized_resnet18.npz; with --multiscale: "
                             "quantized_hierarchical_trunk.npz) for "
                             "deterministic --int8 inference")
    parser.add_argument("--int8", action="store_true",
                        help="Post-training int8 (w8a8) inference for "
                             "--extract_features / --predict_slide: BN-fold "
                             "+ per-channel weight quant + calibrated "
                             "activation scales (models/quantized.py). Uses "
                             "the persisted --quantize artifact when "
                             "present; falls back to lazy calibration")
    parser.add_argument("--patch_level", type=str, default="3",
                        help="WSI level for patch extraction (0-3 or 'all': "
                             "--patch extracts every level, "
                             "--extract_features needs the patches of every "
                             "level, and every other action runs at 3)")
    parser.add_argument("--epochs", type=int, default=None,
                        help="Override epoch count")
    parser.add_argument("--data_dir", type=str, default=None,
                        help="Data root (default: ./data/camelyon16)")
    parser.add_argument("--base_dir", type=str, default=None,
                        help="Alias of --data_dir")
    parser.add_argument("--config", type=str, default=None,
                        help="JSON config file (overrides defaults)")
    parser.add_argument("--store", type=str, default=None,
                        choices=["png", "packed"], help="Patch store format")
    parser.add_argument("--stride", type=int, default=None,
                        help="Patch-grid stride in level pixels (default: "
                             "patch size, i.e. non-overlapping). Applies to "
                             "--patch extraction and --predict_slide "
                             "inference")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="Cells or patches per device batch (default "
                             "512)")
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
    parser.add_argument("--group_size", type=int, default=None,
                        help="With --predict_slide <dir>: devices per slide"
                             " group (fleet inference, one slide per group;"
                             " default all devices on one slide at a time)")
    parser.add_argument("--compile_cache_dir", type=str, default=None,
                        help="Library cache of the built kernels and host "
                             "libraries (default ops/_build in the package; "
                             "'off': a temporary directory removed at exit)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="Where the model runs (default cuda; no "
                             "fallback when no card is visible)")
    return parser


def _cascade_value(v: str):
    """``--cascade``'s value: ``auto`` or a probability in [0, 1)."""
    if v == "auto":
        return v
    try:
        f = float(v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--cascade expects 'auto' or a probability in [0, 1), got {v!r}")
    if not 0.0 <= f < 1.0:
        raise argparse.ArgumentTypeError(
            f"--cascade probability must be in [0, 1), got {f}")
    return f


def _reject_unknown_args(parser: argparse.ArgumentParser, argv) -> None:
    """Log and exit 1 on an argument the parser does not know (argparse
    itself would exit 2), as the JAX CLI does."""
    known = {a.dest for a in parser._actions}
    for a in parser._actions:
        known.update(s.lstrip("-").replace("-", "_") for s in a.option_strings)
    given = {
        arg.split("=")[0].lstrip("-").replace("-", "_")
        for arg in argv
        if arg.startswith("-")
    }
    unknown = given - known
    if unknown:
        log.error("Unknown command line arguments: %s", ", ".join(sorted(unknown)))
        sys.exit(1)


def _config_from_args(args) -> Config:
    """The run's config by the JAX CLI's rules: ``--config`` JSON first; the
    data root from ``--data_dir``, else ``--base_dir``, else the JSON's, else
    ``./data/camelyon16`` (the data section is then rebuilt around it,
    keeping the JSON's ``stain_norm``, which the JAX CLI drops);
    ``--store``, ``--models_dir``, ``--batch_size`` (trainer and SimCLR)
    and ``--freeze_bn`` over it."""
    if args.config:
        with open(args.config) as f:
            cfg = Config.from_dict(json.load(f))
    else:
        cfg = Config()
    data_dir = args.data_dir or args.base_dir or (
        cfg.data.data_dir if args.config
        else os.path.join(os.getcwd(), "data", "camelyon16"))
    cfg = cfg.replace(data=DataConfig(data_dir=data_dir,
                                      stain_norm=cfg.data.stain_norm))
    if args.store:
        cfg.data.patch_store_format = args.store
    if args.models_dir:
        cfg = cfg.replace(models_dir=args.models_dir)
    if args.batch_size:
        cfg.train.batch_size = args.batch_size
        cfg.simclr.batch_size = args.batch_size
    if args.freeze_bn:
        cfg.train.freeze_bn = True
    return cfg


def _levels(patch_level: str) -> list[int]:
    return [0, 1, 2, 3] if patch_level == "all" else [int(patch_level)]


def _slide_paths(target: str) -> list[str]:
    """The slide itself, or every slide of a directory, sorted as the JAX
    CLI lists them."""
    if not os.path.isdir(target):
        return [target]
    return sorted(os.path.join(target, f) for f in os.listdir(target)
                  if f.endswith(SLIDE_EXTENSIONS))


def _predict_kw(args) -> dict:
    kw = {}
    if args.batch_size:
        kw["batch_size"] = args.batch_size
    if args.stride:
        kw["stride"] = args.stride
    return kw


def _visible_devices(device) -> list:
    """Every visible card for a CUDA run (the JAX CLI's full mesh), else
    ``[device]``."""
    return cuda_devices() if device.type == "cuda" else [device]


def _checked_group_size(args, n_dev: int) -> int | None:
    """``--group_size``, or None (one group) with a warning when it does not
    divide the devices, as the JAX CLI does."""
    group_size = args.group_size
    if group_size is not None and (group_size < 1 or n_dev % group_size):
        log.warning("--group_size %d does not divide the %d devices; "
                    "using one group", group_size, n_dev)
        group_size = None
    return group_size


def _predict_slide(args, cfg: Config, level: int, device) -> int:
    paths = _slide_paths(args.predict_slide)
    if not paths:
        log.error("No slides in %s", args.predict_slide)
        return 1
    if args.multiscale:
        return _predict_slide_multiscale(args, cfg, device, paths)
    weights = os.path.join(cfg.models_dir, f"{args.model_name}.pt")
    model = resnet18_from_state_dict(load_state_dict_file(weights))
    # the int8 path reads the model only to calibrate lazily: float32 then
    dtype = (torch.bfloat16 if device.type == "cuda" and not args.int8
             else torch.float32)
    model = model.to(device=device, dtype=dtype,
                     memory_format=torch.channels_last)
    threshold = (args.detect_threshold if args.detect_threshold is not None
                 else DETECTION_PROB_THRESHOLD)
    predict_kw = _predict_kw(args)
    predict_kw["tissue_filter"] = args.tissue_filter
    devices = _visible_devices(device)
    if args.int8:
        if args.tissue_filter == "device":
            log.warning("--tissue_filter device is the float path (int8 folds "
                        "normalize into the stem): using host filtering")
            predict_kw["tissue_filter"] = "host"
        predict_kw["int8"] = True
        predict_kw["qtree"] = maybe_load_artifact(cfg.models_dir,
                                                  CLASSIFIER_ARTIFACT)
    csv_dir = os.path.join(cfg.models_dir, "model_predictions_csv")
    if os.path.isdir(args.predict_slide):
        grids = predict_slide_fleet(
            paths, model, csv_dir, level=level,
            group_size=_checked_group_size(args, len(devices)),
            threshold=threshold, devices=devices, **predict_kw)
    else:
        prob_grid, csv_path = predict_and_export(
            paths[0], model, csv_dir, level=level, threshold=threshold,
            device=devices[0], devices=devices, **predict_kw)
        log.info("Detections written: %s", csv_path)
        grids = {paths[0]: prob_grid}
    if args.overlay:
        _save_overlays(args, cfg, grids, level)
    return 0


def _save_overlays(args, cfg: Config, grids: dict, level: int) -> None:
    """``--overlay``: each slide's heatmap over its coarsest level, saved
    as ``<models_dir>/overlays/<slide file>.overlay.png``, shifted to the
    windows' centres for ``--stride``."""
    for path, prob_grid in grids.items():
        out = os.path.join(cfg.models_dir, "overlays",
                           os.path.basename(path) + ".overlay.png")
        render_overlay(path, prob_grid, save_path=out, predict_level=level,
                       stride=args.stride)
        log.info("Overlay saved: %s", out)


def _predict_slide_multiscale(args, cfg: Config, device, paths) -> int:
    """``--predict_slide --multiscale``: the JAX CLI's multiscale branch
    (``--tissue_filter`` and ``--model_name`` do not apply): a slide on
    every visible card, a directory through the fleet."""
    levels = tuple(int(v) for v in args.levels.split(","))
    state, calibration = split_calibration(load_model(model_artifact_path(
        cfg.models_dir, "hierarchical_classifier")))
    model = hierarchical_from_state_dict(state, levels)
    # the int8 path calibrates lazily from the trunk's weights: float32 then
    dtype = (torch.bfloat16 if device.type == "cuda" and not args.int8
             else torch.float32)
    model.for_inference(device, dtype)
    threshold = (args.detect_threshold if args.detect_threshold is not None
                 else DETECTION_PROB_THRESHOLD)
    ms_kw = _predict_kw(args)
    if args.cascade is not None:
        ms_kw["cascade"] = args.cascade
        if args.cascade_bailout is not None:
            ms_kw["cascade_bailout"] = args.cascade_bailout
    devices = _visible_devices(device)
    if args.int8:
        ms_kw["qtree"] = maybe_load_artifact(cfg.models_dir, TRUNK_ARTIFACT)
    csv_dir = os.path.join(cfg.models_dir, "model_predictions_csv")
    ms_kw.update(levels=levels, calibration=calibration,
                 combine=args.ms_combine, int8=args.int8)
    if not os.path.isdir(args.predict_slide):
        prob_grid, csv_path = predict_and_export_multiscale(
            paths[0], model, csv_dir, threshold=threshold,
            export_components=args.ms_components, device=devices[0],
            devices=devices, **ms_kw)
        log.info("Detections written: %s", csv_path)
        if args.overlay:
            _save_overlays(args, cfg, {paths[0]: prob_grid}, max(levels))
        return 0

    def ms_predict(path, models, *, devices, **kw):
        # the fleet asks for margins; the component surfaces come back in
        # the same space
        out = predict_slide_multiscale(
            path, models, device=devices[0], devices=devices,
            return_components=args.ms_components, **kw)
        if args.ms_components:
            margins, grid, comps = out
            name = slide_name(os.path.basename(path))
            for comp in COMPONENT_EXPORTS:
                write_detection_csv(
                    os.path.join(f"{csv_dir}_{comp}", f"{name}.csv"),
                    margin_detections(comps[comp], grid, threshold))
            return margins, grid
        return out

    grids = predict_slide_fleet(
        paths, model, csv_dir,
        group_size=_checked_group_size(args, len(devices)),
        threshold=threshold, devices=devices, predict_fn=ms_predict, **ms_kw)
    if args.overlay:
        _save_overlays(args, cfg, grids, max(levels))
    return 0


def _run_evaluation(cfg: Config) -> int:
    log.info("Running CAMELYON16 evaluation script.")
    mask_dir = os.path.join(cfg.data.data_dir, "test", "mask")
    csv_dir = os.path.join(cfg.models_dir, "model_predictions_csv")
    if not os.path.exists(mask_dir):
        log.error("Evaluation mask folder '%s' not found.", mask_dir)
        return 1
    if not os.path.exists(csv_dir):
        log.error("Model results folder '%s' not found.", csv_dir)
        return 1
    run_froc_evaluation(csv_dir, mask_dir,
                        plot_path=os.path.join(cfg.models_dir, "froc_curve.png"))
    return 0


def _mine_hard_negatives(cfg: Config, level: int, device) -> None:
    """``--mine_hard_negatives`` with ``<models_dir>/
    resnet18_patch_classifier.pt`` (``load_model`` adds the suffix), in
    bfloat16 on the card as ``--predict_slide`` runs it."""
    model = resnet18_from_state_dict(load_model(model_artifact_path(
        cfg.models_dir, "resnet18_patch_classifier")))
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = model.to(device=device, dtype=dtype,
                     memory_format=torch.channels_last)
    mine_hard_negatives(cfg, model, level=level, device=device)


def _training_inputs(cfg: Config, level: int) -> bool:
    """The training actions' gates: slides downloaded, the level's patches
    extracted (each failure logged as the JAX CLI logs it)."""
    if not images_downloaded(cfg.data):
        log.error("Images must be downloaded before training.")
        return False
    if not patches_extracted(cfg.data, level):
        log.error("Patches must be extracted before training.")
        return False
    return True


#: The actions that run on ``--device``; the tools (``--check_structure``,
#: ``--check_good_downloaded_files``, ``--move_files``,
#: ``--count_tumor_patches``, ``--wsi_viz``) and ``--run_evaluation`` run on
#: the host alone, as in the JAX CLI.
_DEVICE_ACTIONS = ("patch", "patch_one_slide", "extract_features", "train",
                   "train_strategy", "validate", "evaluate", "train_mil",
                   "train_multiscale", "qat", "quantize", "mine_hard_negatives",
                   "predict_slide")

#: The actions with a data-parallel path, which ``torchrun`` runs over its
#: process group (``--patch`` only with ``--train``: the streamed trainer).
_GROUP_ACTIONS = ("train", "train_strategy", "train_multiscale", "qat",
                  "extract_features")

#: The actions without a data-parallel path, which ``torchrun`` refuses
#: (``--evaluate`` runs on rank 0 after the group's training).
_SINGLE_PROCESS_ACTIONS = ("download", "balance_dataset",
                           "patch_one_slide", "prepare", "validation",
                           "validate", "train_mil", "quantize",
                           "mine_hard_negatives", "predict_slide",
                           "run_evaluation", "wsi_viz", "check_structure",
                           "check_good_downloaded_files", "move_files",
                           "count_tumor_patches")


def _group_actions_only(args) -> bool:
    """Under ``torchrun``, whether no action without a data-parallel path
    was asked for (each one that was is logged; ``--patch`` has one only
    with ``--train``)."""
    others = [name for name in _SINGLE_PROCESS_ACTIONS
              if getattr(args, name) not in (None, False)]
    if args.patch and not args.train:
        others.insert(0, "patch")
    for name in others:
        log.error("--%s has no data-parallel path: run it without torchrun",
                  name)
    return not others


def _profiled(args, cfg: Config):
    """``--profile``'s trace under ``<log_dir>/profile``, or nothing."""
    return trace(os.path.join(cfg.log_dir, "profile"), enabled=args.profile)


def _validation_split(cfg: Config, level: int) -> None:
    """``--validation``: log the level's slide-level train/val split."""
    manifest = load_or_scan_manifest(cfg.data.patches_dir, level)
    train_slides, val_slides = slide_level_split(
        manifest.slides(), cfg.data.val_fraction, cfg.data.split_seed
    )
    log.info("Validation split (level %d): %d train slides %s / "
             "%d val slides %s", level, len(train_slides), train_slides,
             len(val_slides), val_slides)


def _validate(args, cfg: Config, level: int, device) -> None:
    """``--validate``: the feature sanity check on the level's triplet, on
    ``device`` (``--tsne_full``: t-SNE on every row)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation.features_eval import (
        validate_features,
    )

    feats, labels, _ = load_feature_artifacts(cfg.data.features_dir, level)
    validate_features(
        feats, labels,
        **({"tsne_max_samples": len(feats)} if args.tsne_full else {}),
        device=device,
    )


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    _reject_unknown_args(parser, argv)
    args = parser.parse_args(argv)
    if args.cascade_bailout is not None and args.cascade is None:
        parser.error("--cascade_bailout requires --cascade (the bailout probe "
                     "configures the cascade's screen pass)")
    set_build_dir(args.compile_cache_dir)
    cfg = _config_from_args(args)
    level = 3 if args.patch_level == "all" else int(args.patch_level)
    if "WORLD_SIZE" in os.environ and any(getattr(args, a)
                                          for a in ("patch", *_GROUP_ACTIONS)):
        return _main_in_group(args, cfg, level)
    if args.check_good_downloaded_files:
        log.info("Checking downloaded files for corruption...")
        check_good_files(cfg.data.patches_dir)
        return 0
    if args.check_structure:
        check_structure(cfg.data)
        return 0
    device = (resolve_device(args.device)
              if any(getattr(args, a) not in (None, False)
                     for a in _DEVICE_ACTIONS) else None)
    if args.download:
        download_dataset(cfg.data, remote=args.remote)
    if args.move_files:
        move_files_up(cfg.data.patch_level_dir(3))

    stain_norm = args.stain_norm or cfg.data.stain_norm
    streamed_train = False
    if args.patch:
        if not images_downloaded(cfg.data):
            log.error("Images must be downloaded before extracting patches.")
            return 1
        # --patch --train: extraction of the training level streams into
        # the first epoch (train/streaming.py), after the other levels
        train_level = level if args.train else None
        for lvl in _levels(args.patch_level):
            if lvl != train_level:
                extract_patches(cfg.data, level=lvl,
                                store_format=cfg.data.patch_store_format,
                                impl=args.extract_impl, stain_norm=stain_norm,
                                stride=args.stride, device=device)
        if args.train:
            log.info("--patch --train: streaming extraction into training")
            train_resnet_classifier_streaming(
                cfg, level=level, epochs=args.epochs, stride=args.stride,
                batch_size=args.batch_size,
                store_format=cfg.data.patch_store_format,
                extract_impl=args.extract_impl, stain_norm=stain_norm,
                device=device)
            streamed_train = True
    if args.extract_features:
        for lvl in _levels(args.patch_level):
            if not patches_extracted(cfg.data, lvl):
                log.error("Patches must be extracted at level %d before "
                          "features.", lvl)
                return 1
        extract = (extract_features_with_simclr if args.simclr_features
                   else extract_features)
        with _profiled(args, cfg):
            extract(cfg, level=level, batch_size=args.batch_size,
                    device=device, int8=args.int8)
    if args.train and not streamed_train:
        if not _training_inputs(cfg, level):
            return 1
        train_resnet_classifier(cfg, level=level, epochs=args.epochs,
                                device=device)
    if args.train_strategy:
        if not _training_inputs(cfg, level):
            return 1
        train_resnet_classifier_strategic(cfg, level=level,
                                          strategy=args.strategy,
                                          epochs=args.epochs, device=device)
    if args.prepare:
        prepare_data(cfg.data)
    if args.validation:
        _validation_split(cfg, level)
    if args.validate:
        _validate(args, cfg, level, device)
    if args.evaluate:
        evaluate_resnet_classifier(cfg, level=level, device=device)
    if args.balance_dataset:
        download_all_tumor_extract_patches(cfg.data)
    if args.count_tumor_patches:
        count_tumor_patches(cfg.data.patches_dir)
    if args.patch_one_slide:
        extract_patches(cfg.data, level=level,
                        slide_filter=[args.patch_one_slide], device=device)
    if args.train_mil:
        train_mil_classifier(cfg, level=level, epochs=args.epochs,
                             device=device)
    if args.train_multiscale:
        train_multiscale_classifier(
            cfg, levels=tuple(int(v) for v in args.levels.split(",")),
            epochs=args.epochs, fusion=args.ms_fusion,
            input_mode=args.ms_input, device=device)
    if args.qat:
        qat_finetune(cfg, level=level, epochs=args.epochs,
                     batch_size=args.batch_size, device=device)
    if args.quantize:
        if args.multiscale:
            path = quantize_trunk_to_artifact(
                cfg, levels=tuple(int(v) for v in args.levels.split(",")),
                device=device)
        else:
            path = quantize_classifier_to_artifact(cfg, level=level,
                                                   device=device)
        log.info("Quantized artifact written: %s", path)
    if args.mine_hard_negatives:
        _mine_hard_negatives(cfg, level, device)
    if args.predict_slide is not None:
        rc = _predict_slide(args, cfg, level, device)
        if rc:
            return rc
    if args.wsi_viz:
        name = slide_name(os.path.basename(args.wsi_viz))
        visualize_and_save_wsi(args.wsi_viz, annotation_path_for(cfg.data, name),
                               os.path.join(cfg.models_dir, "wsi_viz", name),
                               level=level)
    if args.run_evaluation:
        return _run_evaluation(cfg)
    return 0


def _main_in_group(args, cfg: Config, level: int) -> int:
    """The data-parallel actions as one rank of the process group that
    ``torchrun`` describes (NCCL on ``cuda:LOCAL_RANK``, gloo with
    ``--device cpu``), in the single-process order: ``--patch --train``
    (rank 0 extracts and streams each global batch to the ranks),
    ``--extract_features`` (rank 0 writes the triplet), ``--train``,
    ``--train_strategy``, ``--evaluate`` (on rank 0), ``--train_multiscale``
    and ``--qat``; rank 0 writes every artifact."""
    import torch.distributed as dist

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.mesh import (
        barrier,
        init_from_env,
        is_main,
    )

    if not _group_actions_only(args):
        return 2
    device = local_device(args.device)
    owned = not dist.is_initialized()
    group = init_from_env(device)
    try:
        streamed_train = False
        if args.patch:
            if not images_downloaded(cfg.data):
                log.error("Images must be downloaded before extracting "
                          "patches.")
                return 1
            stain_norm = args.stain_norm or cfg.data.stain_norm
            if is_main(group):
                for lvl in _levels(args.patch_level):
                    if lvl != level:
                        extract_patches(
                            cfg.data, level=lvl,
                            store_format=cfg.data.patch_store_format,
                            impl=args.extract_impl, stain_norm=stain_norm,
                            stride=args.stride, device=device)
            barrier(group)
            train_resnet_classifier_streaming(
                cfg, level=level, epochs=args.epochs, stride=args.stride,
                batch_size=args.batch_size,
                store_format=cfg.data.patch_store_format,
                extract_impl=args.extract_impl, stain_norm=stain_norm,
                device=device, group=group)
            streamed_train = True
        if args.extract_features:
            for lvl in _levels(args.patch_level):
                if not patches_extracted(cfg.data, lvl):
                    log.error("Patches must be extracted at level %d before "
                              "features.", lvl)
                    return 1
            extract = (extract_features_with_simclr if args.simclr_features
                       else extract_features)
            with _profiled(args, cfg):
                extract(cfg, level=level, batch_size=args.batch_size,
                        device=device, int8=args.int8, group=group)
        if ((args.train and not streamed_train) or args.train_strategy) \
                and not _training_inputs(cfg, level):
            return 1
        if args.train and not streamed_train:
            train_resnet_classifier(cfg, level=level, epochs=args.epochs,
                                    device=device, group=group)
        if args.train_strategy:
            train_resnet_classifier_strategic(cfg, level=level,
                                              strategy=args.strategy,
                                              epochs=args.epochs,
                                              device=device, group=group)
        if args.evaluate and is_main(group):
            evaluate_resnet_classifier(cfg, level=level, device=device)
        if args.train_multiscale:
            train_multiscale_classifier(
                cfg, levels=tuple(int(v) for v in args.levels.split(",")),
                epochs=args.epochs, fusion=args.ms_fusion,
                input_mode=args.ms_input, device=device, group=group)
        if args.qat:
            qat_finetune(cfg, level=level, epochs=args.epochs,
                         batch_size=args.batch_size, device=device,
                         group=group)
        barrier(group)
        return 0
    finally:
        if owned:
            dist.destroy_process_group()


class _CallableModule(types.ModuleType):
    """This module, callable as :func:`main`: the JAX package's ``cli``
    exports its ``main`` function under the name that is this module's
    here, so ``cli.main(argv)`` runs the command line in both."""

    def __call__(self, argv=None) -> int:
        return main(argv)


sys.modules[__name__].__class__ = _CallableModule

if __name__ == "__main__":
    sys.exit(main())
