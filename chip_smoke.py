#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's eight paths once each with random weights from a seed:
full-slide tumor detection at the full width of ResNet18 (224² patches,
64-wide stem, batch 512) on a numpy-rendered synthetic slide with a tumor
polygon (``predict_slide`` → detections → CSV, then the ``hipac-torch``
CLI, then ``--predict_slide <dir> --run_evaluation`` to the FROC score),
SimCLR pretraining (``pretrain_simclr``) on the slide's tissue cells,
attention-MIL slide classification at the full width of ``MILConfig``
(``--train_mil``, then ``mil_predict`` with MC dropout) on synthetic bag
features, folded bf16 feature extraction (``extract_features``) over the
slide's tissue cells at batch 512, and the int8 (w8a8) path (``--quantize``,
``--predict_slide --int8``, ``run_feature_extraction(int8=True)``) on the
same slide and cells, patch-classifier training (``--train``, the
``self_supervised`` strategy, ``--evaluate``) on the slide's labelled tissue
cells, hierarchical multiscale slide inference (``--predict_slide
--multiscale`` at levels (2, 3): float, cascade and int8 on the stacked
trunk batch) on the same slide, and multiscale training with calibration
(``--train_multiscale``), quantization-aware fine-tuning (``--qat``) and
the serving paths of what they write, patch extraction from slides
(``--patch``, host and device routes, ``--stain_norm``) with the two
trainers that read it (``--patch --train``, ``--mine_hard_negatives``), and
data-parallel training over a process group with the slide fleet
(``Trainer(group=)``, the SimCLR step over ranks, ``--predict_slide <dir>
--group_size``), and the main path on tiled TIFF slides (the smoke slide as
deflate and CAMELYON16's JPEG-YCbCr BigTIFFs through ``--predict_slide``,
``--multiscale``, ``--patch``, the fleet, and ``--run_evaluation`` against
a ``{case}_Mask.tif``). It
checks every hand-written kernel of those paths against its plain PyTorch
version on the card. Phases:

1. card and software: ``nvidia-smi`` name and power limit, torch, CUDA, nvcc;
2. build: the kernels from ``ops/csrc/`` of this checkout, and on another
   thread the two host libraries of ``io/native/`` (the OpenMP chunk
   processor; the TIFF reader and writer on libtiff, by its headers or the
   port's ``tiff_abi.h``);
3. kernel against plain version: ``fused_normalize`` at B=512×224²×3, a
   ragged B=37, an odd 7×13 patch and the multiscale level-2 batch
   (256, 448, 448, 3), f32 and bf16, exactly equal; CUDA-event medians of
   kernel and plain at B=512, and bf16 back to back;
3b. NT-Xent kernels against the plain version (loss rows, m, l, dz) at
   (2N, D) = (1024, 128) with the path's 592 dead rows, (1024, 128),
   (74, 128), (8192, 128) and (130, 100) with the loss's mean as upstream
   gradient, then with random upstream gradients at (2, 128), (74, 128),
   (1000, 64), (1024, 128) with dead rows, (4096, 200), (32768, 128),
   (300, 7), (512, 512) and (17000, 100) (the forward's 128-row blocks);
   the backward on the forward's m, l; loss rows, m, l and dz of second
   calls bit-identical; CUDA-event medians and quartiles of forward,
   backward and both, at 2N = 1024 and 32768, per call and back to back;
3c. the MIL attention-pool kernel against the plain version at (B, K, D, H)
   = (1, 4096, 512, 128) (the path), (8, 4096, 512, 128), (3, 1000, 512,
   128) with random masks, a fully masked bag and a bag whose first 512
   slots are masked, (2, 37, 100, 24), (1, 65536, 512, 128), then the
   kernel's layouts: (3, 200, 200, 128) with the traps, (2, 70, 1024, 128),
   (2, 50, 37, 21) and (1, 300, 2048, 512) (V read from device memory); a
   second call bit-identical; CUDA-event medians and quartiles at K = 4096
   and 65536, per call and back to back;
3d. the ``bias_relu_pool`` kernel against its plain version, exactly equal,
   at (512, 112, 112, 64) bf16 with a (64,) bias and with a (112, 112, 64)
   bias map, (3, 112, 112, 64) f32 and an odd plane (2, 30, 26, 16);
   CUDA-event medians and quartiles at B=512 bf16, GB/s against 3.35 TB/s;
3d'. the training stem's kernel pair (``stem_train``: BN statistics, BN,
   ReLU, 3×3/2 maxpool, forward and backward) against its plain version at
   (512, 64, 112, 112) bf16 and an odd plane (3, 64, 37, 45): pooled within a
   bf16 ulp, codes, statistics, running statistics, dx, dγ, dβ; CUDA-event
   quartiles of forward + backward at B=512 in turns with the plain version,
   beside the module chain (BatchNorm2d, relu, max_pool2d with autograd);
   the SimCLR phase counts two calls of each kernel pair a step;
3e. the ``fused_stem`` kernel against its plain version (a float32 conv of
   the same rounded inputs, TF32 off) at B = 512, 37 and 1, with a (64,)
   bias and with the folded route's bfloat16 bias map, float32 and bfloat16
   products; conv planes 45, 125 and 128 wide, with float32 and bfloat16
   maps; medians at B=512 (per call and back to back) beside the library
   conv + ``bias_relu_pool`` for the same stem;
3f. ``int8_conv_requant`` against its plain version (an exact integer
   convolution in float64, eager float32 epilogue), exactly equal, at the
   16 convolutions of one int8 forward (space-to-depth stem with its bias map; per stage 2–4 the stride-2
   conv, the 1×1 downsample with a float32 output, the convs with a float32
   and an int8 residual), the direct 7×7 stem with 3 input channels and a
   stage-1 conv, at B = 37 and 512; CUDA-event medians at B = 512; stage 1
   of planes no cluster holds ((16, 64, 64, 64), a 256² input's, and an odd
   one) through ``fused_stage1_int8``: four ``int8_conv_requant`` launches,
   exactly equal;
3g. ``fused_stage1_int8`` against its plain version, exactly equal, at
   (512, 56, 56, 64), a batch of 3 and an odd plane; at B = 512 in turns
   with four ``int8_conv_requant`` calls and the plain version, beside the
   four convolutions as bfloat16 library calls;
3h. ``int8_maxpool`` against its plain version (the pool in bfloat16),
   exactly equal, at (512, 112, 112, 64), a batch of 3 and an odd plane;
3i. the training augmentation's kernel against its plain version, exactly
   equal, at (512, 224, 224, 3), B = 37, a 7×7 image and (64, 448, 448, 3),
   over every D4 element forced, the jitter ranges' edges and all-black and
   all-white images; CUDA-event medians at B = 512 per call and back to
   back, of the call, of the kernel alone and of the call's matrix ops;
4. the slice: a 3,072-cell slide (level 3 of 14336×10752, stride 28) in both
   tissue-filter modes, launch counts read around the run, partitions equal,
   the timed bfloat16 run's margins on sampled tissue cells against a float32
   CPU forward of the same cells (the model's BN statistics are calibrated on
   the slide's tissue, so margins spread across cells by far more than the
   bound); detections written to a CSV;
5. the CLI: ``--predict_slide … --tissue_filter device --device cuda`` as a
   subprocess on the same slide and weights;
4b. FROC: the slide under ``test/img`` with its level-5 ground-truth mask
   (``{case}_mask.npy``), ``--predict_slide <dir> --run_evaluation
   --tissue_filter device`` through the CLI's ``main`` in this process, the
   normalize kernel's launches counted around it; the FROC score in [0, 1]
   and equal to an in-process ``run_froc_evaluation`` on the same CSVs;
6. SimCLR: the slide's tissue cells cut into a packed store, then
   ``pretrain_simclr`` for two epochs at batch 512 with the NT-Xent kernels
   (``loss_impl="pallas"``); launch counts read around it, losses finite,
   artifacts reloaded; warm step time, views/s and peak device memory;
6b. the SimCLR step's numbers: the kernels against the dense loss in one
   step, and the bf16 card step against a float32 CPU step on 32 cells,
   whose loss must sit far from the blind-model value ln(2N − 1);
7. MIL: a feature triplet of 24 synthetic slides (2,000–12,000 instances of
   width 512 each, half tumor), ``--train_mil --epochs 5 --device cuda``
   through the CLI's ``main`` in this process, then ``mil_predict`` with 100 MC-dropout samples
   on every bag on the card, launch counts read around it (one per call),
   and without MC dropout (bags of 4096+ instances launch once, shorter
   ones not at all); the kernel route against the module route, the card
   against the CPU (the trained and the seeded untrained classifier,
   probabilities and attention); per-bag predict wall and a warm epoch's
   wall;
9. the int8 path (run before phase 8): ``quantize_classifier_to_artifact``
   (the function behind ``--quantize``) calibrates on 4 × 128 cells of the
   packed store and writes ``quantized_resnet18.npz``; ``predict_slide(int8=
   True, qtree=artifact)`` with the launches counted around each run (per
   batch one ``fused_stage1_int8``, 16 ``int8_conv_requant``, one
   ``int8_maxpool``), the tissue partition equal to the float path's, margins
   and features against the float32 ``folded_forward`` on the reference
   cells, margins independent of batch size and run; ``--predict_slide
   --int8`` through the CLI's ``main`` in this process picking the
   artifact up;
   ``run_feature_extraction(int8=True, qtree=artifact)`` with its launches,
   features identical at two batch sizes; the forward's time at B = 512; the
   card's ``quant_forward`` against the CPU's plain one on 64 cells;
10. training (run before phase 8): ``--train --epochs 2`` through the CLI's
   ``main`` on the packed store's labelled cells (a numpy manifest; one
   slide, so validation reads training cells), the augment kernel's
   launches counted (1 a step); ``train_resnet_classifier_strategic(
   "self_supervised")`` for an epoch from phase 6's encoder, checked not to
   pretrain again; ``--evaluate``; the artifacts reloaded and
   ``--predict_slide <dir> --run_evaluation`` from the trained classifier
   (its FROC score logged); one bf16 card step
   against a float32 CPU step from the same weights, cells and draws; warm
   step time, patches/s, peak device memory, and (last in the run) one
   epoch's device idle share under the profiler;
11. multiscale (run before phase 8): a ``hierarchical_classifier`` from the
   slice's BN-calibrated trunk, seeded heads set along the features'
   principal directions and a non-trivial calibration (crop input mode);
   ``predict_slide_multiscale`` at levels (2, 3), stride 28, 256 cells a
   batch (512 images a trunk call) in both input modes, 2a's launches
   counted (2 a batch), the tissue partition equal to phase 4's host
   partition, the five bf16 columns on the reference cells against a
   float32 CPU forward of the same multiscale cells, the component
   identities; ``--predict_slide --multiscale --ms_components`` and
   ``<dir> --multiscale --run_evaluation`` through the CLI's ``main`` (FROC
   in [0, 1]); a cascade at the median screen score (survivors, fill,
   launches) and a keep-everything cascade that bails out;
   ``quantize_trunk_to_artifact`` (``--quantize --multiscale``) on a packed
   store of the calibration cells at both levels, then the int8 path with
   1 + 16 + 1 launches a stacked batch and a logit cosine against float32,
   and ``--predict_slide --multiscale --int8`` picking the artifact up; warm
   walls in turns with the single-level host-filter slice, peak memory, and
   (last in the run) one run's idle share under the profiler;
12. multiscale training (run before phase 8): a level-2 store (448², 1.05 GB)
   of the 1,752 tissue cells beside phase 10's level-3 store, with their
   tumor labels; ``--train_multiscale --levels 2,3 --epochs 2 --batch_size
   512`` through the CLI's ``main`` in the default resize mode (the numpy
   box mean: no cv2 on the card), warm-started from phase 10's classifier,
   the augment kernel's launches counted (2 a step), losses finite, every
   calibration key present, ``input_mode`` 0; once more with ``--ms_input
   crop`` (``input_mode`` 1); ``--predict_slide <dir> --multiscale
   --run_evaluation`` from the trained artifact (2a launches, 2 a batch;
   FROC in [0, 1]) and ``--cascade`` when a margin shipped; one bf16 card
   step against a float32 CPU step; ``--qat --epochs 1`` from phase 10's
   classifier, then ``--predict_slide --int8`` from its artifact (1 + 16 + 1
   launches a batch) and the QAT graph against the artifact's int8 forward
   on the reference cells (logit cosine); warm step times of both trainers,
   peak memory, and (last in the run) one multiscale epoch's idle share
   under the profiler;
13. patch extraction (run before phase 8): a data root of ``tumor_001``,
   the smoke slide's pyramid, whose XML carries the spec's tumor polygon
   and a seeded 1,024-vertex outline, and the annotation-free 3584×2688
   ``normal_001`` of the port's ``write_synthetic_case``; through the CLI's
   ``main``: ``--patch --patch_level all`` with ``--extract_impl host`` and
   with ``device`` into two roots, the device extractions counted (8: every
   level of both slides, level 0 a 154-megapixel mask, none falls back),
   the stores' rows and bytes equal, labels equal except on cells where the
   host route's numpy rasterizer and the device route's copy of the
   reference's device rasterizer disagree (each checked against both
   masks, counted and printed), per-level walls and cells/s of both routes,
   the device program's pieces (upload, means, rasterize, labels, gather)
   by CUDA events and its peak memory; ``--patch_level 3 --stride 28`` on
   the host route: the kept cells are the smoke's 1,752-cell partition and
   the labels the XML's host mask's; ``--stain_norm`` at level 3: Macenko on
   the card against the port's CPU Macenko on the same patches (the CPU
   tests' tolerance), near-white patches byte-equal, ms a batch;
   ``--patch --train --patch_level 3 --stride 28 --epochs 2``: epoch 0 saw
   exactly the training split's patches, the store equals the stride-28
   store, ``augment`` launches counted; ``--mine_hard_negatives`` from that
   artifact: mined cells at probability ≥ 0.5 of the port's own
   ``predict_slide`` grid in descending order, bytes equal to region reads,
   a second call mines nothing; the phase's wall; and (last in the run) the
   streamed epoch's idle share under the profiler;
14. data parallelism and the fleet (run before phase 8): on the first 512
   tissue cells of phase 10's store, the classifier ``Trainer`` (one global
   batch of 512, one step) and one SimCLR step with the NT-Xent kernels
   (``loss_impl="pallas"``, the gathered (1024, 128) matrix on each rank),
   from seeded weights: (a) in this process over a world-1 NCCL group,
   held to the single process (loss within 5e-3, the head's gradients
   within 5e-2 of max|g|: phase 10's bf16 bound) with warm step times
   beside it; (b), (c) in 2 spawned ranks on the one card over gloo (NCCL
   refuses two ranks on one card): weights bit-identical across ranks,
   ``augment``, ``nt_xent_fwd`` and ``nt_xent_bwd`` launched once a rank,
   loss and gradients within the same bound of (a), the group's NT-Xent
   equal to the kernels on the gathered projections within 1e-5; (f) with
   two cards or more, one rank a card over NCCL; (d) ``--predict_slide
   <dir> --group_size 1 --tissue_filter device`` through the CLI's
   ``main`` over the smoke slide and a second seeded slide: CSVs byte-equal
   to the slides run one after another, the same 2a launches; (e)
   ``predict_slide_fleet`` with two groups sharing the card (two threads,
   a stream each): grids and CSVs equal; walls of each; (h) (run after
   phase 15) the data-parallel paths of multiscale training, QAT, the
   streamed trainer and feature extraction at full width, through their
   entry points: ``train_multiscale_classifier`` for an epoch of phase
   12's cells at 448² + 224² (3 steps, calibration on rank 0) and two
   bare steps on one global batch of 512 (Adam's state), ``qat_finetune``
   for one epoch of the level-3 store, the streamed epoch on a fresh copy
   of phase 13's root (rank 0 extracts; 4 global batches of the smoke
   slide) and ``run_feature_extraction`` over the 1,752 cells (default
   stem, ``stem_s2d``, int8 calibrated lazily), in one process, over a
   world-1 NCCL group and in 2 spawned gloo ranks on the card: against one
   process, the bf16 losses a step within 5e-4, BN running statistics
   within 2e-2 of max|value|, weights within Adam's 2·lr a step, QAT's
   float32 loss within 1e-5, int8 features bit-equal, bf16 features within
   1e-3; parameters, BN statistics, Adam state, the calibration, QAT trees
   and features bit-identical over the ranks, rank 0's multiscale artifact
   equal to its state; ``--extract_features --int8`` through the CLI's
   ``main`` as the world-1 NCCL group's rank, its triplet bit-equal to one
   process's; each kernel's launches a rank on each path counted and
   printed;
15. TIFF slides (run before phase 8): (a) the libtiff version and build
   route, the host builds' walls; (b) the smoke slide's rendered pyramid
   written by ``write_pyramidal_tiff`` (what ``write_synthetic_case(
   container="tiff")`` writes after rendering) as a deflate and a
   JPEG-YCbCr BigTIFF (walls, sizes): every deflate level equal to the
   ``.wsi.npz`` plane by ``read_region`` and by ``read_regions`` (a 512²
   grid, white past the edges), the JPEG level 3 within
   :data:`TIFF_JPEG_MEAN_MAX` and :data:`TIFF_JPEG_ABS_MAX` of its source;
   (c) ``--predict_slide <smoke_slide.tif> --tissue_filter device`` through
   the CLI's ``main``: the CSV byte-equal to the ``.wsi.npz`` run's, 2a
   launches equal (6), warm walls in turns with the ``.wsi.npz``, band
   decode ms cold and warm with the tile cache's counters; (d) the JPEG
   file: the tissue partition's differences from the ``.wsi.npz``'s, 2a
   launches, and ``--multiscale --levels 2,3`` (2a twice a batch); (e)
   ``--patch --patch_level all`` from the deflate TIFF on both routes: every
   level's rows and bytes equal to phase 13's stores of the same pyramid;
   (f) ``--predict_slide <dir> --run_evaluation`` from phase 10's classifier
   with the mask as ``smoke_slide_Mask.tif`` (``write_mask_tiff``): the FROC
   score equal to the ``.npy`` mask's and phase 10's, the CSV byte-equal;
   (g) ``--predict_slide <dir> --group_size 1`` over the smoke slide and
   phase 14's second slide as TIFFs (the second written by
   ``write_synthetic_case(container="tiff")``): CSVs byte-equal to phase
   14's, the
   same 2a launches, walls beside phase 14's, two groups sharing the card
   with the tile cache's counters; (h) ``--predict_slide <deflate tif>
   --overlay`` through the CLI's ``main`` with Pillow alone: exit 0 and the
   PNG equal to the slide's coarsest level blended with the rainbow table
   of the grid; (last in the run) one TIFF run's idle share under the
   profiler;
8. feature extraction: the packed store of the slide's 1,752 tissue cells,
   the slice's ResNet18 saved as ``resnet18_patch_classifier.pt``,
   ``extract_features(cfg, level=3, dataset=ds, device="cuda")`` at batch 512
   in bf16 (4 batches, the last wrap-padded), launch counts read around it
   (``bias_relu_pool`` 4), then ``run_feature_extraction(stem_s2d=True)``
   (``fused_stem`` 4); the triplet on disk, the two routes against each
   other, sampled cells against the float32 CPU ``folded_forward`` and the
   unfolded model; warm patches/s of both routes, the loop's device idle
   share and peak device memory;
16. legacy models and tools (last): ResNet50 (4×224²), UNetClassifier
   (2×128²) and CNNEncoder (4×224²) from seeds, float32 on the card (TF32
   off) against the CPU within 1e-4 of max|out|; ``GenericClassifierTrainer``
   fitting a UNetClassifier on the card, its ``torch.export`` program saved,
   reloaded and within 1e-6 of the module; through the CLI's ``main``:
   ``--prepare`` on a zip of 50 XMLs written here, ``--validation`` (one
   split line), ``--extract_features --profile`` (the Chrome trace names the
   ``bias_relu_pool`` kernel), ``--validate --device cuda`` and
   ``--validate --tsne_full --device cuda`` (exit 0, scikit-learn never
   loaded);
17. the last parity gaps (run after phase 15 (h)): (a) ``predict_and_export(
   int8=True)`` with no int8 tree on the smoke slide at batch 512, on one
   device and split over ``devices=[card, card]`` (one tree calibrated on
   the whole first batch before the split): the two trees equal, the CSVs
   byte-equal; the int8 kernels' launches on each (the split launches once
   a non-empty part); (b) the same for ``predict_and_export_multiscale`` at levels
   (2, 3) from phase 11's artifact at batch 256 (the float heads run in
   calls of ``HEAD_ROWS`` rows; called on 256 rows against two calls of
   128 they are printed: cuBLAS takes another kernel); (c) ``--download`` through the CLI's
   ``main`` against a loopback server serving the deflate TIFF and an
   annotation zip under the CAMELYON16 paths (``CAMELYON16_BASE_URL``
   patched in this process; the other three files are 404s, logged): the
   two files byte-equal, five paths requested, and ``--predict_slide`` on
   the downloaded TIFF writing the CSV of the local file; (d)
   ``--compile_cache_dir`` in two CLI processes on the downloaded TIFF: the
   first builds every kernel library (``nvcc``) and the TIFF host
   library into a fresh directory, the second finds them and builds
   nothing (the files untouched, no build line); both CSVs equal; walls;
18. the feature-evaluation stage (last): ``validate_features(device=
   "cuda")`` on phase 8's 1,752 × 512 triplet against the port's own CPU
   run: the PCA ratio within 1e-5, accuracy and confusion equal, the final
   t-SNE KL (both embeddings under the card's P) within 5 % and the
   trustworthiness (k = 5) within 0.02 (the trajectories differ: the
   descent is chaotic), the ``tsne_repulsion`` kernel's launches on the
   card run (none fails the phase) and a second card run bit-equal; its
   pieces (PCA, kNN and P, init, descent, logistic regression) by CUDA
   events; then t-SNE at the default cap on 10,000 × 512 seeded two-class
   features: wall, kNN and P, ms a descent iteration, and the same descent
   with the repulsion's plain version held to it (KL within 5 %,
   trustworthiness within 0.02); the whole ``--tsne_full`` t-SNE at the
   MIL triplet's mean size, 168,000 × 512 (wall, iterations, KL), and a
   descent iteration there by piece (CUDA events, back to back: the whole,
   the repulsion kernel, the attraction, the gains and update); at
   1,752, 10,000 and 168,000 rows the kernel against its plain version on
   those runs' embeddings (float32 and float64: ``neg`` within 1e-4 of
   max|neg| and ``sum_q`` within 1e-6 relative in float32, both 1e-10 in
   float64), timed per call and back to back beside the plain version,
   with its bound (reciprocals: 16 a clock per SM);
19. the device paths that had run only on the CPU (after phase 18), each
   through the CLI's ``main`` with ``--device cuda``, the launches counted
   around each step, each step's wall and the phase's: (a) ``--extract_features
   --simclr_features`` at batch 512 from phase 6's encoder, the triplet
   bit-equal to ``extract_features`` of the encoder's trunk (2b 4), then
   with ``--int8`` (lazy calibration): the features within one int8 step
   of ``quant_forward`` of the encoder's tree calibrated on the same
   batches, every reference cell's feature cosine against the float32
   folded trunk above 0.98 (2d, ``int8_conv_requant``, ``int8_maxpool``);
   (b) ``--train_strategy --strategy balanced``, then ``weighted_loss``,
   one epoch each: strict loads, finite weights and history, ``augment``
   once a step, and a bf16 card step of the balanced classifier on the
   ``BalancedSampler``'s first cells against the float32 CPU step (phase
   10's bounds); (c) ``train_resnet_classifier`` with ``freeze_bn`` from
   phase 10's classifier: BN statistics bit-equal to the warm start's, a
   frozen-BN card step against the CPU step, then ``--train --freeze_bn``
   (no warm start on the card's machine: the warning, statistics at their
   initial values); (d) ``--train_multiscale --ms_fusion attention`` from
   phase 10's classifier, the bf16 ``fuse`` on the card within 0.1 of the
   float32 CPU ``fuse`` on 32 pooled feature rows, then ``--predict_slide
   --multiscale`` with each explicit ``--ms_combine``, each CSV equal to
   that component of an in-process ``predict_slide_multiscale`` (2a 14 a
   slide); (e) ``--quantize`` on phase 10's trained classifier, then
   ``--predict_slide <dir> --int8 --run_evaluation`` (1 + 16 + 1 launches
   a batch) and the float run on the device filter (2a 6): the margins'
   cosine and max|Δ| on the tissue cells, each reference
   cell's feature cosine (above 0.98) and both FROC scores (int8 at least
   the float's); (f) ``--predict_slide --model_name
   resnet18_patch_classifier_balanced --detect_threshold 0.3`` on (b)'s
   artifact, the CSV equal to an in-process ``predict_slide`` +
   ``margin_detections`` at that floor (2a 6).

It imports nothing of JAX or of the JAX package. Run it from the root of a
checkout:

    python3 chip_smoke.py

It exits non-zero, printing no result, without a CUDA card or outside a
checkout. On success the line before the last is the kernel table as JSON
(each kernel's launches on its path, error, time, plain version's time and
its bound on this card) and the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

PKG = "ss25_hierarchical_multiscale_image_classification_tpu_torch"
ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 512
LEVEL, STRIDE = 3, 28
SLIDE_W, SLIDE_H = 14336, 10752
TIMING_RUNS = 25
CALIB_CELLS = 256  # tissue cells that set the BN statistics
REF_CELLS = 32  # other tissue cells held to the float32 CPU forward
MARGIN_STD = 2.0  # the head is scaled to this margin spread over CALIB_CELLS
# Margin bounds (absolute, at margins of std MARGIN_STD), from the H100 run
# recorded in PERF.md (NVIDIA H100 80GB HBM3, 700 W):
# - the timed bf16 slice against the CPU's float32 forward: measured max|Δ|
#   0.044 over 32 cells whose margins spread 6.05; the reference margins
#   must spread by at least 10× the bound;
BF16_ATOL = 0.1
# - device- against host-filter run on the card: the same bf16 inputs in
#   other batches, measured max|Δ| = 0; should cuDNN pick another algorithm
#   for another batch size, the two differ as bf16 differs from float32;
MODES_ATOL = BF16_ATOL
# - the card's float32 forward (TF32 off) against the CPU's: measured 3.6e-6.
F32_ATOL = 1e-4
# the slice's B=512 224² batch, a ragged batch, an odd patch, and the
# multiscale path's level-2 batch (256 cells of 448²)
KERNEL_SHAPES = [(BATCH, 224, 224, 3), (37, 224, 224, 3), (5, 7, 13, 3),
                 (256, 448, 448, 3)]
# augment cases as (batch, size, D4 element or random, jitter at the range
# edges, an all-black and an all-white image): the path's shape, a ragged
# batch, an odd size, the larger training size, then every D4 element forced
# on a batch
AUG_CASES = [(BATCH, 224, None, False, False), (BATCH, 224, None, True, True),
             (37, 224, None, True, True), (16, 7, None, True, True),
             (64, 448, None, True, True),
             *[(8, 224, e, True, True) for e in range(8)]]
AUG_TIMING_RUNS = 20
TAU = 0.5
# NT-Xent cases as (pairs N, D, valid pairs, upstream gradient): 2N = 1024
# with the SimCLR path's last batch (216 of 512 pairs real: 592 dead rows),
# full batches, a ragged one and an odd width (the loss's mean as upstream
# gradient); then the split plans of both kernels: one row (2N = 2), 2N = 74,
# 1000 at D = 64, 4096 at D = 200 and 32768, with random upstream gradients;
# then the forward's edges: a width of 7 (padded to 8) over 4 splits, 512
# columns in depth chunks over 8 splits, and 128-row blocks (8 x 8 tiles) on
# a ragged 2N = 17000 at D = 100 with dead rows
NTX_CASES = [(512, 128, 216, "mean"), (512, 128, 512, "mean"),
             (37, 128, 37, "mean"), (4096, 128, 4096, "mean"),
             (65, 100, 60, "mean"), (1, 128, 1, "random"),
             (37, 128, 37, "random"), (500, 64, 480, "random"),
             (512, 128, 216, "random"), (2048, 200, 2000, "random"),
             (16384, 128, 16384, "random"), (150, 7, 140, "random"),
             (256, 512, 250, "mean"), (8500, 100, 8400, "random")]
NTX_TIMING_ROWS = (1024, 32768)
NTX_TIMING_RUNS = 50
# NT-Xent bounds, kernel against the plain version (TF32 off) on the card.
# Loss rows, m: relative to the largest |value|; l: relative per row.
# Measured (H100 80GB HBM3, 700 W): loss rows ≤ 2.0e-7 relative (1.91e-6 at
# max|loss| 9.7), m ≤ 4.0e-7, l ≤ 4.6e-7.
NTX_RTOL = 1e-5
# dz: relative to max|dz|, times sqrt(2N / 1024) above 2N = 1024: the
# kernel sums the 2N column terms of each entry in one sequential FMA chain,
# cuBLAS in another order, and the rounding of a sum grows with its length.
# Measured: ≤ 5.7e-6 of max|dz| (1.14e-9 at 2N = 8192; 3.96e-9 of 3.41e-3
# at the path's 2N = 1024 with 592 dead rows).
NTX_DZ_RTOL = 1e-5
SIMCLR_EPOCHS = 2
SIMCLR_TIMED_STEPS = 8  # warm steps timed after the path's run
REF_BATCH = 32  # cells of the bf16-card against float32-CPU step
TRAIN_EPOCHS = 2  # cut from TrainConfig.epochs = 30
TRAIN_TIMED_STEPS = 8
# classifier step bounds, bf16 card against float32 CPU on REF_BATCH cells
# of the trained classifier, the same draws (the augmented inputs are equal
# bit for bit). Measured (H100 80GB HBM3, 700 W): loss |Δ| 6.5e-4 at a loss
# of 0.65; the head's gradients 8.4e-3 of max|g| (the inner layers' spread
# to 0.55 of theirs: training BN over 32 cells in bf16)
TRAIN_LOSS_ATOL = 5e-3
TRAIN_GRAD_RTOL = 5e-2  # of max|grad|, the head's tensors
# SimCLR step bounds, measured on the card (H100 80GB HBM3, 700 W):
# - kernels against the dense loss, same state and views, the path's last
#   batch: loss |Δ| measured 0 (bound: the kernels' 1e-5 of phase 3b);
#   projector gradients max|Δ| 2.3e-3 of max|g| (dz agrees to ~1e-6, but
#   it enters the bf16 projector backward, where a rounding flip of one
#   element costs 2^-8 of it);
PALLAS_XLA_LOSS_ATOL = 1e-5
PALLAS_XLA_GRAD_RTOL = 1e-2  # of max|grad|, per projector tensor
# - bf16 card step against the float32 CPU step on 32 cells: loss |Δ|
#   7.3e-5, last projector layer's gradients 1.5e-2 of max|g|; the CPU's
#   loss sat 0.124 from ln(2·32 − 1), 12× the loss bound.
BF16_LOSS_ATOL = 1e-3
BF16_GRAD_RTOL = 5e-2  # of max|grad| of the last projector layer
# MIL pool cases as (B, K, D, H, masks): the path's one bag, a trainer-sized
# batch of bags of random lengths, the mask traps, odd sizes, a long bag;
# then the kernel's layouts: clusters of 2 (the traps again) and 8, widths
# not a multiple of 4 (D = 37, H = 21), V too large to stay in shared memory
# (D = 2048, H = 512: read from device memory)
MIL_CASES = [(1, 4096, 512, 128, "full"), (8, 4096, 512, 128, "lengths"),
             (3, 1000, 512, 128, "traps"), (2, 37, 100, 24, "lengths"),
             (1, 65536, 512, 128, "full"), (3, 200, 200, 128, "traps"),
             (2, 70, 1024, 128, "lengths"), (2, 50, 37, 21, "lengths"),
             (1, 300, 2048, 512, "lengths")]
MIL_TIMING_K = (4096, 65536)
MIL_TIMING_RUNS = 50
# MIL pool bound, kernel against the plain version (TF32 off) on the card,
# relative to max|bag| of the case. Measured (H100 80GB HBM3, 700 W): ≤ 4.0e-7
# over the five cases (3.98e-7 at K = 65536, where a first version that
# summed the 2,048 partial blocks in one serial chain gave 1.75e-6); the
# fully masked bag against the mean of its rows 2.4e-7.
MIL_RTOL = 1e-5
MIL_SLIDES = 24  # half tumor
MIL_INSTANCES = (2000, 12000)
MIL_EPOCHS = 5  # cut from MILConfig.epochs = 20
# The tumor instances' shift: norm MIL_SHIFT on MIL_SHIFT_CHANNELS seeded
# channels (rows have norm ~23). Spread over all 512 channels, a shift of
# norm 32 lies mostly along the rows' common mean and 15 Adam steps at the
# default learning rate do not find it (training accuracy 0.55 on the CPU).
MIL_SHIFT = 32.0
MIL_SHIFT_CHANNELS = 64
MIL_PROBS_ATOL = 1e-5  # kernel route against module route, card against CPU
MIL_ATTN_RTOL = 1e-4  # attention, card against CPU, of max attention


# Stem kernels. bias_relu_pool cases as (shape, dtype, bias map); it must
# equal its plain version exactly.
POOL_CASES = [((BATCH, 112, 112, 64), "bfloat16", False),
              ((BATCH, 112, 112, 64), "bfloat16", True),
              ((3, 112, 112, 64), "float32", True),
              ((2, 30, 26, 16), "float32", False)]
STEM_BATCHES = (BATCH, 37, 1)
# more fused_stem planes as (B, H, W, layout, bias map type): conv planes
# 45 wide (one warpgroup of the wgmma kernel), 125 and 128 wide (three)
STEM_PLANES = [(2, 62, 90, "s2d", "float32"), (2, 224, 250, "folded", "bfloat16"),
               (2, 256, 256, "s2d", "float32"), (3, 64, 96, "folded", "bfloat16")]
# fused_stem against a float32 conv of the same rounded inputs (TF32 off).
# Measured (H100 80GB HBM3, 700 W): float32 products ≤ 1.05e-5 at max|ref| 15
# (7e-7 relative; FMA chains of 192 terms in another order than cuDNN's);
# bfloat16 products with a bfloat16 output differ by one step of the output
# (0.0625 at |ref| 8..16) where the float32 sums round across a step.
STEM_F32_RTOL = 1e-4  # of max|ref|
STEM_BF16_STEP = 2.0 ** -7  # of max(|ref|, 1), per element
STEM_TIMING_RUNS = 20
# the training stem's kernel pair (ops/stem_train.py): the path's plane
# (one SimCLR forward's conv1 output) and an odd one, NCHW shapes
STEM_TRAIN_CASES = [(BATCH, 64, 112, 112), (3, 64, 37, 45)]
# Feature extraction bound, absolute, on features whose largest spread over
# the sampled cells must be ≥ 10× the bound (see phase_features): bf16 card
# features against the float32 CPU folded_forward, and the two stem routes
# against each other. Measured (H100 80GB HBM3, 700 W): 0.171 (default
# route), 0.149 (stem_s2d) and 0.143 (route against route) at features up to
# 4.79 with a spread of 4.65: the trunk's bf16 rounding, ~3.6 % of the largest
# feature. Against the unfolded bf16 model two bf16 forwards differ, so the
# bound there is twice this (measured 0.271).
FEAT_BF16_ATOL = 0.3
FEAT_REF_CELLS = 32
FEAT_TIMED_STEPS = 10
# int8 kernels: each must equal its plain version exactly (integer sums, and
# an epilogue that rounds where the eager float32 ops round).
# int8_conv_requant cases as (name, (H, W, C_in), C_out, k, stride, pad,
# epilogue, on the int8 forward's path): the 16 convolutions of one forward
# (the space-to-depth stem with its bias map; per stage 2-4 the stride-2
# conv, the 1x1 downsample with a float32 output, the conv with a float32
# residual, a plain conv and the conv with an int8 residual), then the
# direct 7x7 stem with 3 input channels and a stage-1 conv, which the
# forward runs on other routes.
INT8_CONV_CASES = [("stem s2d 4x4 +map", (112, 112, 12), 64, 4, 1,
                    ((2, 1), (2, 1)), "map", True)]
for _i, _c in ((2, 64), (3, 128), (4, 256)):
    _h = 56 * 64 // _c
    INT8_CONV_CASES += [
        (f"s{_i}b0c1 3x3/2", (_h, _h, _c), 2 * _c, 3, 2, 1, "relu", True),
        (f"s{_i}b0down 1x1/2", (_h, _h, _c), 2 * _c, 1, 2, 0, "f32", True),
        (f"s{_i}b0c2 3x3 +f32 res", (_h // 2, _h // 2, 2 * _c), 2 * _c, 3, 1, 1,
         "res_f32", True),
        (f"s{_i}b1c1 3x3", (_h // 2, _h // 2, 2 * _c), 2 * _c, 3, 1, 1, "relu",
         True),
        (f"s{_i}b1c2 3x3 +int8 res", (_h // 2, _h // 2, 2 * _c), 2 * _c, 3, 1, 1,
         "res_i8", True),
    ]
INT8_CONV_CASES += [
    ("stem 7x7/2 C_in=3 +map", (224, 224, 3), 64, 7, 2, 3, "map", False),
    ("stage-1 3x3", (56, 56, 64), 64, 3, 1, 1, "relu", False),
]
INT8_ODD_BATCH = 37  # not a multiple of any tile
# what the tiling of the wgmma path can get wrong, as (batch, case), checked
# and not timed: one image at C_out = 128 (a batch smaller than a tile),
# planes whose pixels fill no tile of 64, a strided 1x1 over an odd plane,
# two blocks of 128 channels over a strided 3x3, blocks of 64 channels at
# C_out = 192, a kernel size whose taps the products' loop is not unrolled for
INT8_TILING_CASES = [
    (1, ("C_out=128 B=1", (7, 7, 64), 128, 3, 1, 1, "relu", False)),
    (3, ("ragged tiles", (10, 11, 128), 128, 3, 1, 1, "res_i8", False)),
    (2, ("1x1/2 odd plane", (7, 9, 128), 256, 1, 2, 0, "f32", False)),
    (5, ("3x3/2 two blocks", (14, 14, 128), 256, 3, 2, 1, "relu", False)),
    (2, ("C_out=192", (12, 12, 64), 192, 3, 1, 1, "res_f32", False)),
    (3, ("5x5", (9, 10, 64), 128, 5, 1, 2, "relu", False)),
]
# exact requantization ties through the staged 16-byte stores: an identity
# 1x1 convolution whose (mscale, s_out) put quotients on half-integers, next
# to them, and far outside the int8 range
INT8_TIE_SCALES = [(0.5, 1.0), (0.125, 0.25), (1.5, 3.0), (0.1, 0.2),
                   (1.0, 1e-3), (3.0, 2.0 + 2.0 ** -22)]
INT8_TIMING_RUNS = 10
INT8_PLAIN_RUNS = 4  # the plain version is a float64 im2col convolution
# the path's shape first; then a batch far below one wave of clusters, a
# cluster of four with rows outside the image (30 = 4 * 8 - 2), one image, a
# slab whose pixels (5 * 9) fill no tile of 64 in a cluster of two, and a
# cluster of one
STAGE1_SHAPES = [(BATCH, 56, 56, 64), (3, 56, 56, 64), (2, 30, 26, 64),
                 (1, 56, 56, 64), (2, 9, 9, 64), (3, 6, 7, 64)]
# planes no cluster of the fused stage-1 kernel holds: a 256² input's 64 × 64
# and an odd one; they run stage 1 as four int8_conv_requant launches
STAGE1_CONV_ROUTE_SHAPES = [(16, 64, 64, 64), (3, 70, 66, 64)]
INT8_POOL_SHAPES = [(BATCH, 112, 112, 64), (3, 112, 112, 64), (2, 31, 27, 16)]
# int8 path checks (phase 9), bounds from the H100 run recorded in PERF.md
# (NVIDIA H100 80GB HBM3, 700 W):
# - int8 against the float32 folded forward on the same cells: measured a
#   logit cosine of 0.9956, a worst cell's feature cosine of 0.9821 (the JAX
#   package's own gate on features is 0.98 for a trained model; this one has
#   random weights) and margins max|Δ| 0.2635 (mean 0.19) on a spread of 6.05;
#   the reference margins must spread by at least 10x the bound;
INT8_COSINE_MIN = 0.97
INT8_MARGIN_ATOL = 0.5
# - the card's quant_forward against the CPU's plain quant_forward on 64
#   cells, in int8 steps of the last stage's output scale (features are means
#   of 49 such values): the convolutions are exact, only the float32 order of
#   the stem's bias map sum or of the mean could differ.
INT8_CPU_CELLS = 64
INT8_CPU_STEPS = 1.0
# multiscale slide inference (phase 11): levels (2, 3) on the slice's grid
# (base level 3, stride 28), 256 cells a batch = 512 images a trunk call;
# the artifact's calibration (temperatures, weights, combine = ensemble,
# input mode 1 = crop: the card has no cv2 for --quantize --multiscale)
MS_LEVELS = (2, 3)
MS_BATCH = 256
MS_CAL = {"temperature": 1.3, "aux_temperature": 0.9, "ensemble_weight": 0.6,
          "ensemble_base_weight": 0.4, "combine": 0, "input_mode": 1}
# bf16 card scores against the float32 CPU forward of the same multiscale
# cells, absolute, on calibrated log-odds that must spread ≥ 10x the bound:
# the trunk's bf16 rounding through heads scaled as the slice's (margin std
# MARGIN_STD, divided by the temperatures). Measured on the H100 run
# recorded in PERF.md (NVIDIA H100 80GB HBM3, 700 W): max|Δ| 0.0438 (crop)
# and 0.0480 (resize) over the five columns of 32 cells spreading 4.4-7.4;
# the bound is the slice's
MS_BF16_ATOL = BF16_ATOL
MS_WALL_RUNS = 3  # warm runs of each path, in turns
# multiscale training (phase 12): --train_multiscale at levels (2, 3), B = 512
# cells (S·B = 1,024 images a trunk call), cut from strategy_epochs = 5
MS_TRAIN_EPOCHS = 2
MS_TRAIN_TIMED_STEPS = 6
QAT_TIMED_STEPS = 4
# the QAT graph against the int8 forward of the artifact it wrote: the bound
# of the JAX package's tests/test_qat.py (logit cosine)
QAT_COSINE_MIN = 0.995
# The card's published peaks (H100 SXM): device memory and dense rates.
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
# reciprocals a second: 16 a clock per SM (CUDA programming guide, compute
# capability 9.0) on 132 SMs at the 1,980 MHz boost clock
SFU_RCP_S = 132 * 16 * 1.98e9
TF32_FLOP_S = 495e12
BF16_FLOP_S = 989e12
INT8_OP_S = 1979e12


def bound_ms(nbytes: float, flop: float, flop_s: float = FP32_FLOP_S) -> dict:
    """The least time the card could take: the larger of the bytes moved
    over the memory rate and the operations over the peak rate."""
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = flop / flop_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def busy_us(prof) -> float:
    """Union of the device's kernel and copy intervals of a profile, in µs."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, runs: int) -> list[float]:
    """Per-launch milliseconds of ``fn`` by CUDA events, one pair per run."""
    import torch

    out = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def back_to_back_ms(fn, groups: int = 10, per: int = 20) -> list[float]:
    """Device milliseconds per call of ``fn``: CUDA events around ``per``
    calls enqueued back to back, so that the host's launch overhead hides
    behind the device's work; one value per group."""
    import torch

    out = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / per)
    return out


def phase_card():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: this smoke run "
                         "needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        find_nvcc,
    )

    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, nvcc "
        f"{nvcc.strip().splitlines()[-1]}")
    return smi, torch.device("cuda", 0)


def phase_build() -> dict:
    """The CUDA libraries (one nvcc a source, all at once) and, beside them
    on another thread, the two host libraries of ``io/native``."""
    from concurrent.futures import ThreadPoolExecutor

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        build,
        load_library,
    )

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(host_builds)
        paths = build()
        load_library()
        cuda_wall = time.perf_counter() - t0
        built = host.result()
    log(f"[build] {', '.join(os.path.relpath(p, ROOT) for p in paths)} in "
        f"{cuda_wall:.2f} s; host libraries chunk "
        f"{built['walls']['chunk']:.2f} s, tiff {built['walls']['tiff']:.2f} s "
        f"(libtiff route: {built['route']}), all in "
        f"{time.perf_counter() - t0:.2f} s")
    return built


def phase_kernels(dev) -> dict:
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.preprocess import (
        fused_normalize,
        fused_normalize_reference,
    )

    g = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    for shape in KERNEL_SHAPES:
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                          generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            out, means = fused_normalize(x, dtype)
            torch.cuda.synchronize()
            ref, ref_means = fused_normalize_reference(x, dtype)
            err = max((out.float() - ref.float()).abs().max().item(),
                      (means - ref_means).abs().max().item())
            max_err = max(max_err, err)
            same = torch.equal(out, ref) and torch.equal(means, ref_means)
            log(f"[kernel] fused_normalize {tuple(shape)} {dtype}: "
                f"exact={same} max_abs_err={err}")
            if not same:
                raise AssertionError(f"fused_normalize differs from its plain "
                                     f"version at {shape} {dtype}")

    x = torch.randint(0, 256, KERNEL_SHAPES[0], dtype=torch.uint8, device=dev,
                      generator=g)
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        kernel = lambda: fused_normalize(x, dtype)  # noqa: E731
        plain = lambda: fused_normalize_reference(x, dtype)  # noqa: E731
        for fn in (plain, kernel):
            cuda_ms(fn, 5)  # warm-up
        # in turns: plain, kernel, kernel, plain
        p = cuda_ms(plain, TIMING_RUNS)
        k = cuda_ms(kernel, TIMING_RUNS) + cuda_ms(kernel, TIMING_RUNS)
        p += cuda_ms(plain, TIMING_RUNS)
        times[dtype] = (statistics.median(k), statistics.median(p))
        mb = x.numel() * (1 + torch.finfo(dtype).bits // 8) / 1e6
        log(f"[kernel] fused_normalize B={BATCH} 224² → {dtype}: kernel "
            f"{times[dtype][0]:.4f} ms ({mb / times[dtype][0]:.1f} GB/s), "
            f"plain {times[dtype][1]:.4f} ms (medians of {2 * TIMING_RUNS})")
    # back to back at B=512 bf16: the four launches of a call (allocation,
    # zeroing, kernel, the means' division) without the host between calls
    b2b = statistics.median(back_to_back_ms(
        lambda: fused_normalize(x, torch.bfloat16)))
    # bf16 at B=512: each byte read once, two written; a subtract and a divide
    bound = bound_ms(x.numel() * 3 + 4 * BATCH, 2 * x.numel())
    log(f"[kernel] fused_normalize B={BATCH} → bf16 back to back: {b2b:.4f} ms "
        f"a call (median of 10 groups of 20; bound {bound['bound_ms']:.4f} ms, "
        f"{bound['bound_ms'] / b2b * 100:.1f} % of it)")
    return {"max_abs_err": max_err, "ms": times[torch.bfloat16][0],
            "back_to_back_ms": b2b, "plain_ms": times[torch.bfloat16][1],
            "library_ms": None, **bound}


def ntxent_launchers():
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.nt_xent import (
        nt_xent_bwd,
        nt_xent_fwd,
    )

    return nt_xent_fwd, nt_xent_bwd


def int8_launchers():
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.int8_block import (
        fused_stage1_int8_kernel,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.int8_conv import (
        int8_conv_requant_kernel,
    )

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.int8_pool import (
        int8_maxpool_kernel,
    )

    return fused_stage1_int8_kernel, int8_conv_requant_kernel, int8_maxpool_kernel


def reset_counts() -> None:
    """Every kernel's launch count to 0, just before a path runs."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.augment import (
        augment_batch_kernel,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.fused_stem import (
        bias_relu_pool_kernel,
        fused_stem_kernel,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.mil_pool import (
        mil_attention_pool_kernel,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.preprocess import (
        fused_normalize,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.tsne_repulsion import (
        tsne_repulsion_kernel,
    )

    for fn in (fused_normalize, *ntxent_launchers(), mil_attention_pool_kernel,
               bias_relu_pool_kernel, fused_stem_kernel, *int8_launchers(),
               augment_batch_kernel, tsne_repulsion_kernel,
               *stem_train_launchers()):
        fn.launches = 0


def stem_train_launchers():
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.stem_train import (
        stem_train_backward_kernel,
        stem_train_forward_kernel,
    )

    return stem_train_forward_kernel, stem_train_backward_kernel


def quartiles(xs: list[float]) -> tuple[float, float, float]:
    q1, med, q3 = statistics.quantiles(xs, n=4)
    return q1, med, q3


def ntxent_inputs(dev, g, pairs: int, d: int, valid_pairs: int):
    """L2-normalised rows of 2·``pairs`` and their positive indices, built as
    ``nt_xent_loss_kernel`` builds them: the first ``valid_pairs`` pairs are
    live, the rest dead (both views)."""
    import torch

    z = torch.randn(2 * pairs, d, device=dev, generator=g)
    z = z / z.norm(dim=1, keepdim=True)
    ar = torch.arange(pairs, dtype=torch.int32, device=dev)
    pos = torch.cat([ar + pairs, ar])
    valid = torch.cat([ar < valid_pairs, ar < valid_pairs])
    return z, torch.where(valid, pos, -1)


def phase_ntxent(dev) -> dict:
    """Both NT-Xent kernels against ``nt_xent_rows_reference`` (TF32 off),
    then their times."""
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.nt_xent import (
        bwd_splits,
        fwd_splits,
        fwd_tile,
        nt_xent_bwd,
        nt_xent_fwd,
        nt_xent_rows,
        nt_xent_rows_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err_fwd = err_bwd = 0.0
    for pairs, d, valid_pairs, upstream in NTX_CASES:
        z, pos = ntxent_inputs(dev, g, pairs, d, valid_pairs)
        n = 2 * pairs
        denom = max(int((pos >= 0).sum()), 1)
        up = (torch.full((n,), 1.0 / denom, device=dev) if upstream == "mean"
              else torch.rand(n, device=dev, generator=g) + 0.5)
        zk = z.clone().requires_grad_()
        rows, m, l = nt_xent_rows(zk, pos, TAU)
        rows.backward(up)
        zr = z.clone().requires_grad_()
        rows_r, m_r, l_r = nt_xent_rows_reference(zr, pos, TAU)
        rows_r.backward(up)
        # the same dz, bit for bit, from a second call (a fixed order of
        # the cluster's partial sums, no atomics)
        up_live = torch.where(pos >= 0, up, 0.0)
        again = nt_xent_bwd(z, pos, m, l, up_live, 1.0 / TAU)
        rows2, m2, l2 = nt_xent_fwd(z, pos, 1.0 / TAU)
        torch.cuda.synchronize()
        same = (torch.equal(again, zk.grad) and torch.equal(rows2, rows.detach())
                and torch.equal(m2, m) and torch.equal(l2, l))
        d_rows = (rows - rows_r).abs().max().item()
        d_m = (m - m_r).abs().max().item()
        d_l = ((l - l_r).abs() / l_r).max().item()
        d_dz = (zk.grad - zr.grad).abs().max().item()
        max_rows = rows_r.abs().max().item()
        max_m = m_r.abs().max().item()
        max_dz = zr.grad.abs().max().item()
        dz_bound = NTX_DZ_RTOL * max(1.0, (n / 1024) ** 0.5) * max_dz
        err_fwd = max(err_fwd, d_rows, d_m)
        err_bwd = max(err_bwd, d_dz)
        d4 = d + -d % 4
        log(f"[ntxent] 2N={n} D={d} dead rows {n - 2 * valid_pairs}, upstream "
            f"{upstream}, fwd {fwd_tile(n, d4, sms)}-row blocks x "
            f"{fwd_splits(n, d4, sms)} splits, bwd {bwd_splits(n, d4, sms)} "
            f"splits: loss rows "
            f"max|Δ| {d_rows:.3g} (max|loss| {max_rows:.4g}), m {d_m:.3g} "
            f"(max|m| {max_m:.4g}), l rel {d_l:.3g}; dz max|Δ| {d_dz:.3g} "
            f"(max|dz| {max_dz:.3g}, bound {dz_bound:.3g}); second calls "
            f"(fwd and bwd) bit-identical {same}")
        if not (torch.isfinite(rows).all() and torch.isfinite(zk.grad).all()):
            raise AssertionError(f"non-finite NT-Xent output at 2N={n}")
        if (d_rows > NTX_RTOL * max_rows or d_m > NTX_RTOL * max_m
                or d_l > NTX_RTOL or d_dz > dz_bound or not same):
            raise AssertionError(f"NT-Xent kernels differ from the plain "
                                 f"version (or from themselves) at 2N={n} D={d}")
        del z, zk, zr, rows_r, again, rows2
        torch.cuda.empty_cache()

    times = {}
    for n in NTX_TIMING_ROWS:
        z, pos = ntxent_inputs(dev, g, n // 2, 128, n // 2)
        zg = z.clone().requires_grad_()
        ones = torch.ones(n, device=dev)
        _, m, l = nt_xent_fwd(z, pos, 1.0 / TAU)
        rows_r = nt_xent_rows_reference(zg, pos, TAU)[0]

        def fwd_bwd(impl):
            zz = z.clone().requires_grad_()
            impl(zz, pos, TAU)[0].backward(ones)

        fns = {
            "fwd": (lambda: nt_xent_fwd(z, pos, 1.0 / TAU),
                    lambda: nt_xent_rows_reference(z, pos, TAU)),
            "bwd": (lambda: nt_xent_bwd(z, pos, m, l, ones, 1.0 / TAU),
                    lambda: torch.autograd.grad(rows_r, zg, ones,
                                                retain_graph=True)),
            "fwd+bwd": (lambda: fwd_bwd(nt_xent_rows),
                        lambda: fwd_bwd(nt_xent_rows_reference)),
        }
        for what, (kernel, plain) in fns.items():
            for fn in (plain, kernel):
                cuda_ms(fn, 3)  # warm-up
            half = NTX_TIMING_RUNS // 2
            # in turns: plain, kernel, kernel, plain
            p = cuda_ms(plain, half)
            k = cuda_ms(kernel, half) + cuda_ms(kernel, half)
            p += cuda_ms(plain, half)
            kq, pq = quartiles(k), quartiles(p)
            times[(n, what)] = (kq[1], pq[1])
            flop = 2 * n * n * 128 * {"fwd": 1, "bwd": 2, "fwd+bwd": 3}[what]
            log(f"[ntxent] 2N={n} D=128 {what}: kernel {kq[1]:.4f} ms "
                f"(quartiles {kq[0]:.4f}–{kq[2]:.4f}; {flop / kq[1] / 1e9:.1f}"
                f" TFLOP/s), plain {pq[1]:.4f} ms ({pq[0]:.4f}–{pq[2]:.4f}); "
                f"medians of {2 * half}")
            if what != "fwd+bwd":  # device time without the host's launch
                per = 20 if n <= 1024 else 2
                kb = statistics.median(back_to_back_ms(kernel, 5, per))
                pb = statistics.median(back_to_back_ms(plain, 5, per))
                times[(n, what, "b2b")] = kb
                log(f"[ntxent] 2N={n} D=128 {what} back to back: kernel "
                    f"{kb:.4f} ms ({flop / kb / 1e9:.1f} TFLOP/s), plain "
                    f"{pb:.4f} ms")
        del zg, rows_r
        torch.cuda.empty_cache()
    path_rows = NTX_TIMING_ROWS[0]
    # forward: the (2N)² scores over D; backward: scores again and (A+Aᵀ)Z;
    # z read, rows (and m, l) or dz written, in float32
    flop = 2 * path_rows * path_rows * 128
    return {
        "nt_xent_fwd": {"max_abs_err": err_fwd,
                        "ms": times[(path_rows, "fwd")][0],
                        "plain_ms": times[(path_rows, "fwd")][1],
                        "library_ms": None,
                        **bound_ms(4 * path_rows * (128 + 4), flop)},
        "nt_xent_bwd": {"max_abs_err": err_bwd,
                        "ms": times[(path_rows, "bwd")][0],
                        "plain_ms": times[(path_rows, "bwd")][1],
                        "library_ms": None,
                        **bound_ms(4 * path_rows * (2 * 128 + 4), 2 * flop)},
    }


def mil_pool_inputs(dev, g, b, k, d, h, masks):
    """Bags of non-negative features (as ResNet18's pooled ones) and pool
    parameters at the scale of the classifier's initialisation. ``masks``:
    "full" (every slot real), "lengths" (random bag lengths, the rest
    padding), "traps" (random masks, bag 1 fully masked, bag 2's first 512
    slots masked)."""
    import torch

    x = torch.relu(torch.randn(b, k, d, device=dev, generator=g) + 0.5)
    if masks == "full":
        m = torch.ones(b, k, dtype=torch.bool, device=dev)
    elif masks == "lengths":
        n = torch.randint(1, k + 1, (b, 1), device=dev, generator=g)
        m = torch.arange(k, device=dev)[None] < n
    else:
        m = torch.rand(b, k, device=dev, generator=g) > 0.3
        m[1] = False
        m[2, :512 if k > 512 else k // 2] = False
    v = torch.randn(d, h, device=dev, generator=g) / d ** 0.5
    vb = 0.1 * torch.randn(h, device=dev, generator=g)
    w = torch.randn(h, device=dev, generator=g) / h ** 0.5
    return x, m, v, vb, w


def phase_milpool(dev) -> dict:
    """The MIL pool kernel against ``mil_attention_pool_reference`` (TF32
    off), then its times beside the plain version's."""
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.mil_pool import (
        mil_attention_pool_kernel,
        mil_attention_pool_reference,
        pool_layout,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    for b, k, d, h, masks in MIL_CASES:
        x, m, v, vb, w = mil_pool_inputs(dev, g, b, k, d, h, masks)
        got = mil_attention_pool_kernel(x, m, v, w, vb)
        again = mil_attention_pool_kernel(x, m, v, w, vb)
        torch.cuda.synchronize()
        ref = mil_attention_pool_reference(x, m, v, w, vb)
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        same = torch.equal(got, again)
        max_err = max(max_err, err)
        cs, ds, resident, stages = pool_layout(d, h)
        log(f"[milpool] B={b} K={k} D={d} H={h} masks={masks} (cluster {cs}, "
            f"slices of {ds}, V {'resident' if resident else 'read from memory'},"
            f" {stages} stages): max|Δ| {err:.3g} (max|bag| {scale:.4g}, "
            f"{err / scale:.3g} relative); second call bit-identical {same}")
        if not torch.isfinite(got).all() or err > MIL_RTOL * scale or not same:
            raise AssertionError(f"MIL pool kernel differs from its plain "
                                 f"version (or from itself) at B={b} K={k} "
                                 f"D={d} H={h}")
        if masks == "traps":
            d_mean = (got[1] - x[1].mean(dim=0)).abs().max().item()
            log(f"[milpool] fully masked bag against the mean of its rows: "
                f"max|Δ| {d_mean:.3g}")
            if d_mean > MIL_RTOL * scale:
                raise AssertionError("a fully masked bag is not its mean")

    times = {}
    for k in MIL_TIMING_K:
        x, m, v, vb, w = mil_pool_inputs(dev, g, 1, k, 512, 128, "full")
        kernel = lambda: mil_attention_pool_kernel(x, m, v, w, vb)  # noqa: E731
        plain = lambda: mil_attention_pool_reference(x, m, v, w, vb)  # noqa: E731
        for fn in (plain, kernel):
            cuda_ms(fn, 3)  # warm-up
        half = MIL_TIMING_RUNS // 2
        # in turns: plain, kernel, kernel, plain; one call per event pair
        # (what a caller waits), then device time of back-to-back calls
        p = cuda_ms(plain, half)
        kt = cuda_ms(kernel, half) + cuda_ms(kernel, half)
        p += cuda_ms(plain, half)
        kb = back_to_back_ms(kernel) + back_to_back_ms(kernel)
        pb = back_to_back_ms(plain) + back_to_back_ms(plain)
        kq, pq = quartiles(kt), quartiles(p)
        times[k] = (kq[1], pq[1])
        flop = 2 * k * 512 * 128
        log(f"[milpool] B=1 K={k} D=512 H=128: kernel {kq[1]:.4f} ms "
            f"(quartiles {kq[0]:.4f}–{kq[2]:.4f}), plain {pq[1]:.4f} ms "
            f"({pq[0]:.4f}–{pq[2]:.4f}); medians of {2 * half} calls")
        kb, pb = statistics.median(kb), statistics.median(pb)
        log(f"[milpool] B=1 K={k} back to back: kernel {kb:.4f} ms "
            f"({flop / kb / 1e9:.2f} TFLOP/s = {flop / kb / 1e9 / 67 * 100:.1f} "
            f"% of the 67 TFLOP/s FP32 peak; its 3 TF32 products a product "
            f"{3 * flop / kb / 1e9:.1f} TFLOP/s = "
            f"{3 * flop / kb / TF32_FLOP_S * 1e5:.1f} % of the 495 TFLOP/s "
            f"TF32 peak), plain {pb:.4f} ms ({flop / pb / 1e9:.2f} TFLOP/s)")
    # K = 4096: h, mask, V, w, b read, the bag written; h V (three TF32
    # products each on the tensor cores) and the pooled sum. bound_ms is the
    # tensor-core bound of the work as the kernel does it (the share uses
    # it); the float32 FMA bound of the same function stands beside it.
    k, d, h = 4096, 512, 128
    moved = 4 * (k * d + d * h + 2 * h + d) + k
    rest = 2 * k * h + 2 * k * d
    fp32 = bound_ms(moved, 2 * k * d * h + rest)
    by_ops = (3 * 2 * k * d * h / TF32_FLOP_S + rest / FP32_FLOP_S) * 1e3
    by_bytes = moved / HBM_BYTES_S * 1e3
    tc = {"bound_ms": max(by_ops, by_bytes),
          "bound_by": "operations" if by_ops >= by_bytes else "bytes"}
    log(f"[milpool] bound at K=4096: {tc['bound_ms']:.4f} ms by "
        f"{tc['bound_by']} (3xTF32 on the tensor cores, used for the share), "
        f"{fp32['bound_ms']:.4f} ms by {fp32['bound_by']} (float32 FMA)")
    return {"max_abs_err": max_err, "ms": times[4096][0],
            "plain_ms": times[4096][1], "library_ms": None, **tc,
            "bound_fp32_ms": fp32["bound_ms"]}


def timed_in_turns(kernel, plain, runs: int):
    """Quartiles of per-call CUDA-event times of ``kernel`` and ``plain``,
    run in turns (plain, kernel, kernel, plain) after a warm-up."""
    for fn in (plain, kernel):
        cuda_ms(fn, 3)
    half = max(runs // 2, 2)
    p = cuda_ms(plain, half)
    k = cuda_ms(kernel, half) + cuda_ms(kernel, half)
    p += cuda_ms(plain, half)
    return quartiles(k), quartiles(p)


def phase_stem_pool(dev) -> dict:
    """The ``bias_relu_pool`` kernel against its plain version, exactly
    equal, then its time at the path's shape."""
    import torch
    import torch.nn.functional as F

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.fused_stem import (
        bias_relu_pool_kernel,
        bias_relu_pool_reference,
    )

    g = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    for shape, dtype_name, bias_map in POOL_CASES:
        dtype = getattr(torch, dtype_name)
        x = torch.randn(shape, device=dev, generator=g).to(dtype)
        bias = 0.5 * torch.randn(shape[1:] if bias_map else shape[-1:],
                                 device=dev, generator=g)
        for out_dtype in (torch.bfloat16, torch.float32):
            out = bias_relu_pool_kernel(x, bias, out_dtype)
            torch.cuda.synchronize()
            ref = bias_relu_pool_reference(x, bias, out_dtype)
            err = (out.float() - ref.float()).abs().max().item()
            max_err = max(max_err, err)
            same = out.shape == ref.shape and torch.equal(out, ref)
            log(f"[stem-pool] bias_relu_pool {shape} {dtype_name} bias "
                f"{'map' if bias_map else 'vector'} → {out_dtype}: exact={same} "
                f"max_abs_err={err}")
            if not same:
                raise AssertionError(f"bias_relu_pool differs from its plain "
                                     f"version at {shape} {dtype_name}")
        del x, out, ref

    shape = POOL_CASES[1][0]  # the path: bf16 plane, bias map, bf16 out
    x = torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
    bias = 0.5 * torch.randn(shape[1:], device=dev, generator=g)
    moved = x.numel() * 2 + bias.numel() * 4 + x.numel() // 4 * 2
    kq, pq = timed_in_turns(
        lambda: bias_relu_pool_kernel(x, bias, torch.bfloat16),
        lambda: bias_relu_pool_reference(x, bias, torch.bfloat16),
        STEM_TIMING_RUNS)
    # the nearest library composition in the plane's dtype (three calls)
    b16 = bias.to(torch.bfloat16)
    xn = x.permute(0, 3, 1, 2)
    bn = b16.permute(2, 0, 1)
    lib = quartiles(cuda_ms(
        lambda: F.max_pool2d(torch.relu_(xn + bn), 3, 2, 1), STEM_TIMING_RUNS))
    bound = bound_ms(moved, 3 * x.numel())
    log(f"[stem-pool] {shape} bf16 + map → bf16, {moved / 1e6:.0f} MB moved: "
        f"kernel {kq[1]:.4f} ms (quartiles {kq[0]:.4f}–{kq[2]:.4f}; "
        f"{moved / kq[1] / 1e6:.0f} GB/s = "
        f"{moved / kq[1] / 1e6 / (HBM_BYTES_S / 1e9) * 100:.1f} % of 3.35 TB/s; "
        f"bound {bound['bound_ms']:.4f} ms), plain {pq[1]:.4f} ms "
        f"({pq[0]:.4f}–{pq[2]:.4f}); add + relu_ + max_pool2d in bf16 (three "
        f"library calls, rounding after each) {lib[1]:.4f} ms")
    return {"max_abs_err": max_err, "ms": kq[1], "plain_ms": pq[1],
            "library_ms": None, **bound}


def ulp_gap(a, b):
    """|a − b| in bf16 units in the last place of the larger magnitude."""
    import torch

    m = torch.maximum(a.float().abs(), b.float().abs()).clamp_min(1e-30)
    return (a.float() - b.float()).abs() / torch.exp2(torch.floor(
        torch.log2(m)) - 7)


def phase_stem_train(dev) -> dict:
    """The training stem's kernel pair against its plain version (pooled
    plane within a bf16 ulp, codes, statistics, running statistics; the
    backward on the kernels' codes: dx, dγ, dβ), then forward + backward at
    the path's shape in turns with the plain version, beside the module
    chain BatchNorm2d → ReLU → max_pool2d with autograd (the library)."""
    import torch
    import torch.nn.functional as F

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
        BatchNorm2d,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops import (
        stem_train as st,
    )

    g = torch.Generator(device=dev).manual_seed(SEED)
    cl = torch.channels_last
    max_err = 0.0
    for shape in STEM_TRAIN_CASES:
        x = (1.5 * torch.randn(shape, device=dev, generator=g) + 0.4).to(
            torch.bfloat16).contiguous(memory_format=cl)
        w = 0.5 + torch.rand(64, device=dev, generator=g)
        b = 0.3 * torch.randn(64, device=dev, generator=g)
        run_k = [torch.zeros(64, device=dev), torch.ones(64, device=dev)]
        run_r = [t.clone() for t in run_k]
        out_k, codes_k, stats_k = st.stem_train_forward_kernel(
            x, w, b, *run_k, 0.1, 1e-5)
        torch.cuda.synchronize()
        _, _, stats_r = st.stem_train_forward_reference(x, w, b, *run_r, 0.1,
                                                        1e-5)
        stats_err = (stats_k - stats_r).abs().max().item()
        # BN, ReLU and pool in plain ops on the kernel's statistics: near
        # zero, a float32 rounding of them is many bf16 ulps of the output
        r = torch.relu(st._bn(x.float(), stats_k[0], stats_k[1], w, b).to(
            torch.bfloat16))
        out_r, idx = F.max_pool2d(r, 3, 2, 1, return_indices=True)
        codes_r = st._codes(idx, shape[3])
        pool_ulp = ulp_gap(out_k, out_r).max().item()
        codes_same = (codes_k == codes_r).float().mean().item()
        run_err = max((a - c).abs().max().item() for a, c in zip(run_k, run_r))
        dy = torch.randn(out_k.shape, device=dev, generator=g).to(
            torch.bfloat16).contiguous(memory_format=cl)
        dx_k, dw_k, db_k = st.stem_train_backward_kernel(dy, x, codes_k,
                                                         stats_k, w, b)
        torch.cuda.synchronize()
        dx_r, dw_r, db_r = st.stem_train_backward_reference(dy, x, codes_k,
                                                            stats_k, w, b)
        dx_err = (dx_k.float() - dx_r.float()).abs().max().item()
        dx_off = (ulp_gap(dx_k, dx_r) > 1.0).float().mean().item()
        dwb_err = max((dw_k - dw_r).abs().max().item() / dw_r.abs().max().item(),
                      (db_k - db_r).abs().max().item() / db_r.abs().max().item())
        max_err = max(max_err, dx_err)
        log(f"[stem-train] {shape}: pooled within {pool_ulp:.0f} bf16 ulp, "
            f"codes equal {codes_same * 100:.4f} %, stats |Δ| {stats_err:.3g}, "
            f"running |Δ| {run_err:.3g}; dx |Δ| {dx_err:.4g} (max |dx| "
            f"{dx_r.float().abs().max().item():.4g}, {dx_off * 100:.4f} % "
            f"over one ulp), dγ/dβ relative {dwb_err:.3g}")
        if (pool_ulp > 1.0 or codes_same < 0.999 or stats_err > 1e-4
                or run_err > 1e-5 or dx_off > 1e-4 or dwb_err > 1e-4):
            raise AssertionError(f"stem_train kernels differ from their plain "
                                 f"version at {shape}")
        del x, r, out_k, out_r, codes_k, codes_r, dy, dx_k, dx_r

    shape = STEM_TRAIN_CASES[0]
    x = (1.5 * torch.randn(shape, device=dev, generator=g) + 0.4).to(
        torch.bfloat16).contiguous(memory_format=cl)
    dy = torch.randn(shape[0], 64, 56, 56, device=dev, generator=g).to(
        torch.bfloat16).contiguous(memory_format=cl)
    bn = BatchNorm2d(64).to(dev).train()
    w, b, rm, rv = (bn.weight.detach(), bn.bias.detach(),
                    bn.running_mean.clone(), bn.running_var.clone())

    def kernels():
        _, codes, stats = st.stem_train_forward_kernel(x, w, b, rm, rv, 0.1,
                                                       1e-5)
        st.stem_train_backward_kernel(dy, x, codes, stats, w, b)

    def plain():
        _, codes, stats = st.stem_train_forward_reference(x, w, b, rm, rv,
                                                          0.1, 1e-5)
        st.stem_train_backward_reference(dy, x, codes, stats, w, b)

    xg = x.detach().requires_grad_()

    def chain():
        F.max_pool2d(torch.relu(bn(xg)), 3, 2, 1).backward(dy)

    kq, pq = timed_in_turns(kernels, plain, STEM_TIMING_RUNS // 2)
    fwd = quartiles(cuda_ms(lambda: st.stem_train_forward_kernel(
        x, w, b, rm, rv, 0.1, 1e-5), STEM_TIMING_RUNS))
    lib = quartiles(cuda_ms(chain, STEM_TIMING_RUNS))
    plane, pooled = x.numel() * 2, dy.numel() * 2
    # the least any implementation moves: read x and write the pool; read x
    # and dy and write dx. The design reads x twice each way and the codes.
    moved = (plane + pooled) + (2 * plane + pooled)
    design = (2 * plane + pooled + pooled // 2) + (
        2 * (plane + pooled + pooled // 2) + plane)
    # ~31 float32 operations an element over the four kernels
    bound = bound_ms(moved, 31 * x.numel())
    log(f"[stem-train] {shape} bf16 forward + backward: kernels "
        f"{kq[1]:.4f} ms (quartiles {kq[0]:.4f}–{kq[2]:.4f}; forward alone "
        f"{fwd[1]:.4f}), {moved / kq[1] / 1e6:.0f} GB/s of the least bytes; "
        f"bound {bound['bound_ms']:.4f} ms ({moved / 1e6:.0f} MB, "
        f"{bound['bound_ms'] / kq[1] * 100:.1f} % of it), the design's "
        f"{design / 1e6:.0f} MB at {design / kq[1] / 1e6:.0f} GB/s; plain "
        f"{pq[1]:.4f} ms ({pq[0]:.4f}–{pq[2]:.4f}); the module chain "
        f"(BatchNorm2d, relu, max_pool2d, autograd backward) {lib[1]:.4f} ms "
        f"({lib[0]:.4f}–{lib[2]:.4f})")
    return {"max_abs_err": max_err, "ms": kq[1], "plain_ms": pq[1],
            "library_ms": lib[1], "forward_ms": fwd[1], "design_mb":
            design / 1e6, **bound}


def phase_fused_stem(dev, sd) -> dict:
    """The ``fused_stem`` kernel against its plain version with both kinds of
    input (``stem_space_to_depth`` + ``fold_stem_params`` with a (64,) bias;
    the folded route's cells, weights and bias map), then its times."""
    import torch
    import torch.nn.functional as F

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quantized import (
        fold_resnet18_inference,
        folded_to,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.fused_stem import (
        bias_relu_pool_kernel,
        fold_stem_params,
        fused_stem,
        fused_stem_reference,
        stem_space_to_depth,
    )

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(SEED)
    w2_vec, bias_vec = fold_stem_params(
        sd["conv1.weight"].permute(2, 3, 1, 0), sd["bn1.weight"],
        sd["bn1.bias"], sd["bn1.running_mean"], sd["bn1.running_var"])
    w2_vec, bias_vec = w2_vec.to(dev), bias_vec.to(dev)
    fp = folded_to(fold_resnet18_inference(sd, (224, 224), stem_s2d=True,
                                           dtype=torch.bfloat16), dev)
    # the path's weights and map as the folded forward hands them over
    w2_map, bias_map = fp["stem_w2"], fp["stem_bias_map"]

    def folded_cells(imgs):
        n, h, w, _ = imgs.shape
        t = imgs.to(torch.bfloat16) - 128
        s = t.reshape(n, h // 2, 2, w // 2, 2, 3).permute(0, 1, 3, 2, 4, 5)
        return t, F.pad(s.reshape(n, h // 2, w // 2, 12), (0, 0, 2, 1, 2, 1))

    cases = []
    for batch in STEM_BATCHES:
        imgs = torch.randint(0, 256, (batch, 224, 224, 3), dtype=torch.uint8,
                             device=dev, generator=g)
        cases.append((batch, 224, 224, "vector",
                      (stem_space_to_depth(imgs), w2_vec, bias_vec)))
        cases.append((batch, 224, 224, "map",
                      (folded_cells(imgs)[1], w2_map, bias_map)))
    for batch, h, w, layout, map_type in STEM_PLANES:
        imgs = torch.randint(0, 256, (batch, h, w, 3), dtype=torch.uint8,
                             device=dev, generator=g)
        in2 = stem_space_to_depth(imgs) if layout == "s2d" else folded_cells(imgs)[1]
        bmap = bias_vec + torch.randn(h // 2, w // 2, 64, device=dev, generator=g)
        cases.append((batch, h, w, f"{map_type} map, {layout} cells",
                      (in2, w2_vec, bmap.to(getattr(torch, map_type)))))
        cases.append((batch, h, w, f"vector, {layout} cells", (in2, w2_vec, bias_vec)))

    max_err = 0.0
    for batch, h, w, kind, (in2, w2, bias) in cases:
        out = fused_stem(in2, w2, bias, torch.float32, torch.float32)
        torch.cuda.synchronize()
        ref = fused_stem_reference(in2, w2, bias.float(), torch.float32,
                                   torch.float32)
        scale = ref.abs().max().item()
        e32 = (out - ref).abs().max().item()
        out16 = fused_stem(in2, w2, bias, torch.bfloat16, torch.bfloat16)
        torch.cuda.synchronize()
        ref16 = fused_stem_reference(in2, w2, bias.float(), torch.bfloat16,
                                     torch.bfloat16).float()
        d16 = (out16.float() - ref16).abs()
        steps = (d16 / (STEM_BF16_STEP * ref16.abs().clamp_min(1.0))).max().item()
        max_err = max(max_err, d16.max().item())
        log(f"[stem] fused_stem B={batch} {h}×{w} {in2.dtype} cells, bias {kind}: "
            f"f32 products max|Δ| {e32:.3g} (max|ref| {scale:.4g}, "
            f"{e32 / scale:.3g} relative, bound {STEM_F32_RTOL}); bf16 "
            f"products and output max|Δ| {d16.max().item():.3g} = "
            f"{steps:.3g} bf16 steps of the output (bound 1), "
            f"{(d16 > 0).float().mean().item():.3g} of the elements differ")
        if not (torch.isfinite(out).all() and torch.isfinite(out16).all()):
            raise AssertionError(f"non-finite fused_stem output at B={batch}")
        if out.shape != ref.shape or e32 > STEM_F32_RTOL * scale or steps > 1.0:
            raise AssertionError(f"fused_stem differs from its plain "
                                 f"version at B={batch} {h}×{w}, bias {kind}")
    del cases, out, ref, out16, ref16, d16

    # times at B=512 on the path's inputs: bf16 cells, bias map, bf16 out
    imgs = torch.randint(0, 256, (BATCH, 224, 224, 3), dtype=torch.uint8,
                         device=dev, generator=g)
    t, in2 = folded_cells(imgs)
    in2_f32 = in2.float()
    kq, pq = timed_in_turns(
        lambda: fused_stem(in2, w2_map, bias_map, torch.bfloat16, torch.bfloat16),
        lambda: fused_stem_reference(in2, w2_map, bias_map, torch.bfloat16,
                                     torch.bfloat16),
        STEM_TIMING_RUNS)
    k32 = quartiles(cuda_ms(
        lambda: fused_stem(in2_f32, w2_map, bias_map, torch.bfloat16,
                           torch.float32), STEM_TIMING_RUNS))
    # the default route's stem: library 7×7/2 conv, then kernel 2b
    fp7 = folded_to(fold_resnet18_inference(sd, (224, 224), dtype=torch.bfloat16),
                    dev)
    w7, tn = fp7["kernels"]["stem"], t.permute(0, 3, 1, 2)

    map32 = bias_map.float()  # what bias_relu_pool hands its kernel

    def conv_then_pool():
        y = F.conv2d(tn, w7, None, 2, 3)
        return bias_relu_pool_kernel(y.permute(0, 2, 3, 1), map32,
                                     torch.bfloat16)

    conv = quartiles(cuda_ms(lambda: F.conv2d(tn, w7, None, 2, 3),
                             STEM_TIMING_RUNS))
    both = quartiles(cuda_ms(conv_then_pool, STEM_TIMING_RUNS))
    kb = statistics.median(back_to_back_ms(
        lambda: fused_stem(in2, w2_map, bias_map, torch.bfloat16,
                           torch.bfloat16), 5, 10))
    flop = 2 * BATCH * 112 * 112 * 192 * 64
    moved = in2.numel() * 2 + (w2_map.numel() + bias_map.numel()) \
        * bias_map.element_size() + BATCH * 56 * 56 * 64 * 2
    bound = bound_ms(moved, flop, BF16_FLOP_S)
    log(f"[stem] fused_stem B={BATCH}, bf16 cells + map → bf16 "
        f"({flop / 1e9:.1f} GFLOP, {moved / 1e6:.0f} MB): kernel {kq[1]:.4f} ms "
        f"(quartiles {kq[0]:.4f}–{kq[2]:.4f}; {flop / kq[1] / 1e9:.1f} TFLOP/s = "
        f"{flop / kq[1] / BF16_FLOP_S * 1e5:.1f} % of the 989 TFLOP/s dense bf16 "
        f"tensor peak; bound {bound['bound_ms']:.4f} ms; back to back "
        f"{kb:.4f} ms), f32 cells and "
        f"products on FP32 FMAs {k32[1]:.4f} ms ({flop / k32[1] / 1e9:.1f} "
        f"TFLOP/s; at least {flop / FP32_FLOP_S * 1e3:.4f} ms at the 67 TFLOP/s "
        f"FP32 peak), plain {pq[1]:.4f} ms "
        f"({pq[0]:.4f}–{pq[2]:.4f}); library conv 7×7/2 {conv[1]:.4f} ms, "
        f"conv + bias_relu_pool kernel {both[1]:.4f} ms "
        f"({both[0]:.4f}–{both[2]:.4f})")
    return {"max_abs_err": max_err, "ms": kq[1], "plain_ms": pq[1],
            "library_ms": None, **bound}


def int8_conv_inputs(dev, g, batch, case):
    """One convolution's operands at the scale of a calibrated forward: int8
    activations and weights over the whole range, a dequantization scale
    that brings the sums to unit variance, and an output scale that spreads
    them over the int8 range with some clipping."""
    import torch

    _, (h, w, cin), cout, k, stride, pad, kind, _ = case
    ri = lambda shape: torch.randint(-127, 128, shape, device=dev,  # noqa: E731
                                     generator=g).to(torch.int8)
    xq = ri((batch, h, w, cin))
    qk = ri((cout, cin, k, k)).contiguous(memory_format=torch.channels_last)
    unit = 1.0 / ((k * k * cin) ** 0.5 * 73.3 * 73.3)
    mscale = unit * (0.5 + torch.rand(cout, device=dev, generator=g))
    p = (pad, pad, pad, pad) if isinstance(pad, int) else (*pad[0], *pad[1])
    ho = (h + p[0] + p[1] - k) // stride + 1
    wo = (w + p[2] + p[3] - k) // stride + 1
    bias = 0.3 * torch.randn((ho, wo, cout) if kind == "map" else (cout,),
                             device=dev, generator=g)
    kw = {"relu": kind != "f32", "out_f32": kind == "f32"}
    s_out = None if kind == "f32" else torch.tensor(3.0 / 127, device=dev)
    if kind == "res_f32":
        kw["residual"] = torch.randn(batch, ho, wo, cout, device=dev,
                                     generator=g)
    elif kind == "res_i8":
        kw["residual"] = ri((batch, ho, wo, cout))
        kw["residual_scale"] = torch.tensor(1.0 / 64, device=dev)
    ops = 2 * batch * ho * wo * k * k * cin * cout
    out_bytes = batch * ho * wo * cout * (4 if kind == "f32" else 1)
    moved = (xq.numel() + qk.numel() + out_bytes + 4 * (cout + bias.numel())
             + sum(t.numel() * t.element_size() for t in kw.values()
                   if hasattr(t, "numel")))
    return (xq, qk, mscale, bias, s_out, stride, pad), kw, ops, moved


def stage1_convs_route(dev, g) -> None:
    """Stage 1 of a plane that no cluster of the fused kernel holds (64 × 64,
    a 256² input): ``fused_stage1_int8`` takes four ``int8_conv_requant``
    launches instead, exactly equal to the plain version."""
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.int8_block import (
        fused_stage1_int8,
        fused_stage1_int8_reference,
        stage1_route,
    )

    stage1, conv, _ = int8_launchers()
    for shape in STAGE1_CONV_ROUTE_SHAPES:
        ops = stage1_inputs(dev, g, shape)
        ref = fused_stage1_int8_reference(*ops)
        before = (stage1.launches, conv.launches)
        got = fused_stage1_int8(*ops)
        torch.cuda.synchronize()
        launched = (stage1.launches - before[0], conv.launches - before[1])
        same = torch.equal(got, ref)
        log(f"[int8-conv] stage 1 at {shape}: route "
            f"{stage1_route(*shape[1:3])!r}, launches fused_stage1_int8 "
            f"{launched[0]}, int8_conv_requant {launched[1]}; exactly equal to "
            f"the plain version: {same} (output std "
            f"{ref.float().std().item():.4g})")
        if launched != (0, 4) or not same:
            raise AssertionError(f"stage 1 at {shape} did not take four exact "
                                 f"int8_conv_requant launches")


def phase_int8_conv(dev) -> dict:
    """``int8_conv_requant`` against its plain version, exactly equal, at
    every case and two batch sizes; then the times at B=512."""
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.int8_conv import (
        int8_conv_requant_kernel,
        int8_conv_requant_reference,
        pack_int8_kernel,
    )

    g = torch.Generator(device=dev).manual_seed(SEED)
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops": 0,
             "by": {"bytes": 0, "operations": 0}}
    max_err = 0.0
    for batch, case in INT8_TILING_CASES:
        args, kw, _, _ = int8_conv_inputs(dev, g, batch, case)
        ref = int8_conv_requant_reference(*args, **kw)
        got = int8_conv_requant_kernel(*args, **kw)
        torch.cuda.synchronize()
        max_err = max(max_err, (got.float() - ref.float()).abs().max().item())
        if got.shape != ref.shape or not torch.equal(got, ref):
            raise AssertionError(f"int8_conv_requant differs from its plain "
                                 f"version at {case[0]} B={batch}")
        log(f"[int8-conv] {case[0]} B={batch} {tuple(args[0].shape[1:])} → "
            f"{tuple(ref.shape[1:])}: exactly equal to the plain version")
    xq = torch.randint(-127, 128, (2, 9, 9, 64), device=dev,
                       generator=g).to(torch.int8)
    for cout in (64, 128):  # blocks of 64 and of 128 output channels
        eye = torch.eye(64, device=dev, dtype=torch.int8).repeat(cout // 64, 1)
        qk = eye.reshape(cout, 64, 1, 1).contiguous(
            memory_format=torch.channels_last)
        for mscale, s_out in INT8_TIE_SCALES:
            args = (xq, qk, torch.full((cout,), mscale, device=dev),
                    torch.zeros(cout, device=dev),
                    torch.tensor(s_out, device=dev), 1, 0)
            got = int8_conv_requant_kernel(*args, relu=False)
            torch.cuda.synchronize()
            if not torch.equal(got, int8_conv_requant_reference(
                    *args, relu=False)):
                raise AssertionError(
                    f"int8_conv_requant differs from its plain version at the "
                    f"rounding ties of mscale {mscale}, s_out {s_out}, "
                    f"C_out {cout}")
    log(f"[int8-conv] rounding ties and clipping at {len(INT8_TIE_SCALES)} "
        f"scale pairs, C_out 64 and 128: exactly equal to the plain version")
    stage1_convs_route(dev, g)
    for case in INT8_CONV_CASES:
        name = case[0]
        for batch in (INT8_ODD_BATCH, BATCH):
            args, kw, ops, moved = int8_conv_inputs(dev, g, batch, case)
            ref = int8_conv_requant_reference(*args, **kw)
            got = int8_conv_requant_kernel(*args, **kw)
            torch.cuda.synchronize()
            same = got.shape == ref.shape and torch.equal(got, ref)
            err = (got.float() - ref.float()).abs().max().item()
            max_err = max(max_err, err)
            if not same:
                raise AssertionError(
                    f"int8_conv_requant differs from its plain version at "
                    f"{name} B={batch}: max|Δ| {err}, "
                    f"{(got != ref).float().mean().item():.3g} of the "
                    f"elements")
            spread = ref.float().std().item()
            log(f"[int8-conv] {name} B={batch} {tuple(args[0].shape[1:])} → "
                f"{tuple(ref.shape[1:])} {ref.dtype}: exactly equal to the "
                f"plain version (output std {spread:.4g})")
            del got, ref
        # times at B=512, the weights packed once as the forward packs them
        packed = pack_int8_kernel(args[1])
        kernel = lambda: int8_conv_requant_kernel(*args, **kw, packed=packed)  # noqa: E731
        cuda_ms(kernel, 3)  # warm-up
        kq = quartiles(cuda_ms(kernel, INT8_TIMING_RUNS))
        pq = quartiles(cuda_ms(
            lambda: int8_conv_requant_reference(*args, **kw), INT8_PLAIN_RUNS))
        bound = bound_ms(moved, ops, INT8_OP_S)
        log(f"[int8-conv] {name} B={BATCH}: {ops / 1e9:.1f} G op, "
            f"{moved / 1e6:.1f} MB: kernel {kq[1]:.4f} ms (quartiles "
            f"{kq[0]:.4f}–{kq[2]:.4f}; {ops / kq[1] / 1e9:.1f} TOP/s = "
            f"{ops / kq[1] / INT8_OP_S * 1e5:.1f} % of 1,979 TOP/s), plain "
            f"{pq[1]:.3f} ms; bound {bound['bound_ms']:.4f} ms by "
            f"{bound['bound_by']}")
        if case[-1]:  # one of the 16 convolutions of a forward
            total["ms"] += kq[1]
            total["plain_ms"] += pq[1]
            total["bound_ms"] += bound["bound_ms"]
            total["ops"] += ops
            total["by"][bound["bound_by"]] += 1
        del args, kw, packed
        torch.cuda.empty_cache()
    log(f"[int8-conv] the 16 convolutions of one B={BATCH} forward "
        f"({total['ops'] / 1e12:.3f} T op): kernel {total['ms']:.3f} ms "
        f"({total['ops'] / total['ms'] / 1e9:.1f} TOP/s), plain "
        f"{total['plain_ms']:.1f} ms, bound "
        f"{total['bound_ms']:.4f} ms ({total['by']})")
    by = max(total["by"], key=total["by"].get)
    return {"max_abs_err": max_err, "ms": total["ms"],
            "plain_ms": total["plain_ms"], "library_ms": None,
            "bound_ms": total["bound_ms"], "bound_by": by}


def phase_int8_pool(dev) -> dict:
    """The int8 maxpool kernel against its plain version (the pool in
    bfloat16), exactly equal, then its time at the path's shape."""
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.int8_pool import (
        int8_maxpool_kernel,
        int8_maxpool_reference,
    )

    g = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    for shape in INT8_POOL_SHAPES[::-1]:  # the path's shape last: it is timed
        x = torch.randint(-128, 128, shape, device=dev, generator=g).to(torch.int8)
        x[0, 0, 0] = -128  # a window of lowest values keeps them
        got = int8_maxpool_kernel(x)
        torch.cuda.synchronize()
        ref = int8_maxpool_reference(x)
        same = got.shape == ref.shape and torch.equal(got, ref)
        if same:
            max_err = max(max_err,
                          (got.float() - ref.float()).abs().max().item())
        log(f"[int8-pool] int8_maxpool {shape} → {tuple(got.shape)}: exact={same}")
        if not same:
            raise AssertionError(f"int8_maxpool differs from its plain version "
                                 f"at {shape}")
    kq, pq = timed_in_turns(lambda: int8_maxpool_kernel(x),
                            lambda: int8_maxpool_reference(x), STEM_TIMING_RUNS)
    moved = x.numel() + got.numel()
    bound = bound_ms(moved, x.numel() * 9 // 4)
    log(f"[int8-pool] {INT8_POOL_SHAPES[0]}, {moved / 1e6:.0f} MB moved: kernel "
        f"{kq[1]:.4f} ms (quartiles {kq[0]:.4f}–{kq[2]:.4f}; "
        f"{moved / kq[1] / 1e6:.0f} GB/s = "
        f"{moved / kq[1] / 1e6 / (HBM_BYTES_S / 1e9) * 100:.1f} % of 3.35 TB/s; "
        f"bound {bound['bound_ms']:.4f} ms), plain (to bfloat16, max_pool2d, to "
        f"int8) {pq[1]:.4f} ms ({pq[0]:.4f}–{pq[2]:.4f})")
    return {"max_abs_err": max_err, "ms": kq[1], "plain_ms": pq[1],
            "library_ms": None, **bound}


def augment_params(dev, g, b, element, edges):
    """Augmentation draws for ``b`` images from ``g``; ``element`` (0..7:
    bit 0 transpose, bit 1 x-reverse, bit 2 y-reverse) forces one D4
    element on every image, ``edges`` puts the jitter factors at the edges
    of their ranges."""
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
        _D4_FX,
        _D4_FY,
        _D4_T,
        sample_augment_params,
    )

    p = sample_augment_params(g, b)
    if element is not None:
        h, v, k = next((h, v, k) for h in range(2) for v in range(2)
                       for k in range(4)
                       if _D4_T[h, v, k] + 2 * _D4_FX[h, v, k]
                       + 4 * _D4_FY[h, v, k] == element)
        p["h"] = torch.full((b,), bool(h), device=dev)
        p["v"] = torch.full((b,), bool(v), device=dev)
        p["k"] = torch.full((b,), k, device=dev)
    if edges:
        pick = lambda lo, hi: torch.where(  # noqa: E731
            torch.rand(b, generator=g, device=dev) < 0.5,
            torch.full((b,), lo, device=dev), torch.full((b,), hi, device=dev))
        p.update(fb=pick(0.8, 1.2), fc=pick(0.8, 1.2), fs=pick(0.8, 1.2),
                 fh=pick(-0.1, 0.1))
    return p


def phase_augment(dev) -> dict:
    """The augment kernel against its plain version, exactly equal, at the
    path's shape, a ragged batch, an odd size and S = 448, over every D4
    element forced, the jitter ranges' edges and all-black and all-white
    images; then CUDA-event medians at B=512, per call and back to back:
    the call, the kernel alone on the call's own arguments, and the call's
    matrix ops."""
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
        MEAN_255,
        STD_255,
        augment_batch,
        augment_matrix,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.augment import (
        D4_PACKED,
        INV_255_BF16,
        augment_batch_kernel,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        load_library,
    )

    g = torch.Generator(device=dev).manual_seed(SEED)
    for batch, size, element, edges, extremes in AUG_CASES:
        x = torch.randint(0, 256, (batch, size, size, 3), dtype=torch.uint8,
                          device=dev, generator=g)
        if extremes:
            x[0] = 0
            x[1] = 255
        p = augment_params(dev, g, batch, element, edges)
        got = augment_batch_kernel(p, x)
        torch.cuda.synchronize()
        ref = augment_batch(p, x)
        same = torch.equal(got, ref)
        log(f"[augment] ({batch}, {size}, {size}, 3) D4 "
            f"{'random' if element is None else element} edges={edges} "
            f"black/white={extremes}: exact={same}")
        if not same:
            raise AssertionError(f"augment kernel differs from its plain "
                                 f"version at {(batch, size)} D4 {element}")
    x = torch.randint(0, 256, (BATCH, 224, 224, 3), dtype=torch.uint8,
                      device=dev, generator=g)
    p = augment_params(dev, g, BATCH, None, False)
    kq, pq = timed_in_turns(lambda: augment_batch_kernel(p, x),
                            lambda: augment_batch(p, x), AUG_TIMING_RUNS)
    b2b = statistics.median(back_to_back_ms(lambda: augment_batch_kernel(p, x)))
    # each input byte read once, four written; ~12 operations an output
    bound = bound_ms(5 * x.numel(), 12 * x.numel())
    # the kernel alone, on the call's own arguments, and the matrix ops
    lib = load_library()
    stream = torch.cuda.current_stream().cuda_stream
    md = augment_matrix(p)
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    alone_fn = lambda: lib.hipac_augment(  # noqa: E731
        x.data_ptr(), p["h"].data_ptr(), p["v"].data_ptr(), p["k"].data_ptr(),
        p["k"].element_size() // 4, D4_PACKED, md.data_ptr(),
        p["fb"].data_ptr(), p["fc"].data_ptr(), out.data_ptr(), BATCH, 224,
        INV_255_BF16, *MEAN_255, *STD_255, stream)
    alone_q = quartiles(cuda_ms(alone_fn, AUG_TIMING_RUNS))
    alone = statistics.median(back_to_back_ms(alone_fn))
    matrix_q = quartiles(cuda_ms(lambda: augment_matrix(p), AUG_TIMING_RUNS))
    matrix = statistics.median(back_to_back_ms(lambda: augment_matrix(p)))
    torch.cuda.synchronize()
    if not torch.equal(out, augment_batch_kernel(p, x)):
        raise AssertionError("the kernel alone differs from the call")
    log(f"[augment] the kernel alone: {alone_q[1]:.4f} ms per call "
        f"(quartiles {alone_q[0]:.4f}–{alone_q[2]:.4f}), {alone:.4f} back to "
        f"back = {5 * x.numel() / alone / 1e6:.0f} GB/s, "
        f"{bound['bound_ms'] / alone * 100:.1f} % of the "
        f"{bound['bound_ms']:.4f} ms bound; the call's matrix ops "
        f"(augment_matrix) {matrix_q[1]:.4f} ms per call, {matrix:.4f} back "
        f"to back = {matrix / b2b * 100:.1f} % of the call back to back")
    log(f"[augment] B={BATCH} 224² u8 → f32 ({5 * x.numel() / 1e6:.1f} MB "
        f"moved): the call {kq[1]:.4f} ms per call (quartiles {kq[0]:.4f}–"
        f"{kq[2]:.4f}), {b2b:.4f} back to back = "
        f"{5 * x.numel() / b2b / 1e6:.0f} GB/s; bound {bound['bound_ms']:.4f} "
        f"ms ({bound['bound_ms'] / b2b * 100:.1f} % of it); plain "
        f"{pq[1]:.4f} ms ({pq[0]:.4f}–{pq[2]:.4f})")
    return {"max_abs_err": 0.0, "ms": kq[1], "back_to_back_ms": b2b,
            "kernel_ms": alone_q[1], "kernel_back_to_back_ms": alone,
            "plain_ms": pq[1], "library_ms": None, **bound}


def stage1_inputs(dev, g, shape):
    """Stage-1 operands at the scale of a calibrated forward: a non-negative
    int8 plane (it follows a ReLU and a maxpool), int8 weights, and scales
    that keep every intermediate spread over the int8 range."""
    import torch

    c = shape[3]
    xq = torch.randint(0, 128, shape, device=dev, generator=g).to(torch.int8)
    kernels = torch.randint(-127, 128, (4, 3, 3, c, c), device=dev,
                            generator=g).to(torch.int8)
    scalars = torch.tensor([0.02, 0.03, 0.025, 0.03, 0.028], device=dev)
    # the sums times mscales have about unit variance
    unit = 1.0 / ((9 * c) ** 0.5 * 73.3 * 60.0)
    mscales = unit * (0.5 + torch.rand(4, c, device=dev, generator=g))
    biases = 0.3 * torch.randn(4, c, device=dev, generator=g)
    return xq, kernels, mscales, biases, scalars


def phase_fused_stage1(dev) -> dict:
    """``fused_stage1_int8`` against its plain version, exactly equal; then at
    B=512 its time in turns with four calls of ``int8_conv_requant`` and with
    the plain version, and beside the same four convolutions as bfloat16
    library calls with eager epilogues."""
    import torch
    import torch.nn.functional as F

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.int8_block import (
        active_clusters,
        cluster_plan,
        fused_stage1_int8_kernel,
        fused_stage1_int8_reference,
        pack_stage1_kernels,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.int8_conv import (
        int8_conv_requant_kernel,
        pack_int8_kernel,
    )

    g = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    for shape in STAGE1_SHAPES[::-1]:  # the path's shape last: it is timed
        xq, kernels, mscales, biases, scalars = stage1_inputs(dev, g, shape)
        ref = fused_stage1_int8_reference(xq, kernels, mscales, biases, scalars)
        got = fused_stage1_int8_kernel(xq, kernels, mscales, biases, scalars)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        max_err = max(max_err, err)
        blocks, rows = cluster_plan(shape[1], shape[2])
        log(f"[int8-stage1] fused_stage1_int8 {shape} (clusters of {blocks} "
            f"blocks, {rows} rows a block, {active_clusters(*shape[1:3])} "
            f"clusters at once on this card): "
            f"exact={torch.equal(got, ref)} max_abs_err={err} (output std "
            f"{ref.float().std().item():.4g}, "
            f"{(ref == 0).float().mean().item():.3f} zeros)")
        if not torch.equal(got, ref):
            raise AssertionError(
                f"fused_stage1_int8 differs from its plain version at "
                f"{shape}: {(got != ref).float().mean().item():.3g} of the "
                f"elements")

    # (a) the same stage as four calls of the generic kernel
    names = range(4)
    oihw = [kernels[i].permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last) for i in names]
    packs = [pack_int8_kernel(k) for k in oihw]
    packed = pack_stage1_kernels(kernels)

    def four_calls():
        x = xq
        for blk in range(2):
            c1, c2 = 2 * blk, 2 * blk + 1
            y1 = int8_conv_requant_kernel(x, oihw[c1], mscales[c1], biases[c1],
                                          scalars[1 + 2 * blk], 1, 1,
                                          packed=packs[c1])
            x = int8_conv_requant_kernel(y1, oihw[c2], mscales[c2], biases[c2],
                                         scalars[2 + 2 * blk], 1, 1, residual=x,
                                         residual_scale=scalars[2 * blk],
                                         packed=packs[c2])
        return x

    if not torch.equal(four_calls(), ref):
        raise AssertionError("four int8_conv_requant calls differ from the "
                             "plain stage 1")

    # side time: the four convolutions as bfloat16 library calls, eager
    # epilogues (what a float stand-in would cost; it is not the same function)
    xb = xq.to(torch.bfloat16).permute(0, 3, 1, 2)
    wb = [k.to(torch.bfloat16) for k in oihw]

    def library_bf16():
        x = xb
        for blk in range(2):
            y = torch.relu_(F.conv2d(x, wb[2 * blk], None, 1, 1))
            x = torch.relu_(F.conv2d(y, wb[2 * blk + 1], None, 1, 1) + x)
        return x

    fused = lambda: fused_stage1_int8_kernel(xq, kernels, mscales, biases,  # noqa: E731
                                             scalars, packed=packed)
    kq, pq = timed_in_turns(
        fused, lambda: fused_stage1_int8_reference(xq, kernels, mscales,
                                                   biases, scalars),
        INT8_PLAIN_RUNS)
    for fn in (four_calls, library_bf16):
        cuda_ms(fn, 3)
    half = INT8_TIMING_RUNS // 2
    f4 = cuda_ms(four_calls, half)
    kt = cuda_ms(fused, half) + cuda_ms(fused, half)
    f4 += cuda_ms(four_calls, half)
    kq, f4q = quartiles(kt), quartiles(f4)
    lib = quartiles(cuda_ms(library_bf16, INT8_TIMING_RUNS))
    b, h, w, c = STAGE1_SHAPES[0]
    ops = 4 * 2 * b * h * w * 9 * c * c
    moved = 2 * xq.numel() + kernels.numel() + 4 * (8 * c + 5)
    bound = bound_ms(moved, ops, INT8_OP_S)
    log(f"[int8-stage1] fused_stage1_int8 {STAGE1_SHAPES[0]} ({ops / 1e9:.1f} "
        f"G op, {moved / 1e6:.1f} MB): kernel {kq[1]:.4f} ms (quartiles "
        f"{kq[0]:.4f}–{kq[2]:.4f}; {ops / kq[1] / 1e9:.1f} TOP/s = "
        f"{ops / kq[1] / INT8_OP_S * 1e5:.1f} % of 1,979 TOP/s; bound "
        f"{bound['bound_ms']:.4f} ms by {bound['bound_by']}), four "
        f"int8_conv_requant calls {f4q[1]:.4f} ms ({f4q[0]:.4f}–{f4q[2]:.4f}), "
        f"plain {pq[1]:.2f} ms; the four convolutions as bfloat16 library "
        f"calls with eager ReLU and residual {lib[1]:.4f} ms")
    return {"max_abs_err": max_err, "ms": kq[1], "plain_ms": pq[1],
            "library_ms": None, **bound}


def tissue_cells(slide):
    """The slice's grid at ``LEVEL``/``STRIDE`` and its tissue cells as
    (iy, ix) pairs, by the host filter's rule on the cells as the slice reads
    them (white-padded past the edges)."""
    import numpy as np

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        TISSUE_MEAN_RGB_THRESHOLD,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.pyramid import (
        PatchGrid,
    )

    grid = PatchGrid.for_slide_level(LEVEL, slide.level_dimensions[LEVEL],
                                     slide.level_downsamples[LEVEL], STRIDE)
    cells = [(iy, ix) for ix in range(grid.nx) for iy in range(grid.ny)
             if read_cell(slide, grid, iy, ix).mean() <= TISSUE_MEAN_RGB_THRESHOLD]
    return grid, np.array(cells)


def read_cell(slide, grid, iy, ix):
    x, y = ix * grid.stride, iy * grid.stride
    ps = grid.patch_size
    return slide.read_region(grid.level0_origin(x, y), grid.level, (ps, ps))


def make_model(dev, calib_u8):
    """Full-width ResNet18 (64-wide stem, 2 classes) from a seeded generator,
    as a float32 CPU state dict, a float32 copy on the card and the bf16
    channels_last copy on the card that the slice runs.

    BN affines are random; BN statistics are calibrated on ``calib_u8``
    (tissue cells of the slide) in float32 on the card. With unit statistics
    a random trunk maps every tissue cell to nearly the same features, and a
    check of the margins could not tell a forward that ignores its input.
    The head then reads the features' first principal direction over those
    cells, scaled so that their margins have mean 0 and standard deviation
    :data:`MARGIN_STD`: the trunk's bf16 rounding is ~3 % of the features,
    and along a random direction it buries most of the cells' variation."""
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
        normalize,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        resnet18_from_state_dict,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
        ResNet18Classifier,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(SEED)
    model = ResNet18Classifier(num_classes=2, num_filters=64, generator=g)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for m in bns:
            m.weight.uniform_(0.5, 1.5, generator=g)
            m.bias.normal_(0.0, 0.1, generator=g)
            m.reset_running_stats()
            m.momentum = 1.0  # running statistics = this batch's
    f32 = model.to(dev, memory_format=torch.channels_last)
    x = normalize(torch.from_numpy(calib_u8).to(dev))
    with torch.no_grad():
        f32.train()
        f32(x)
        f32.eval()
        fc, f32.fc = f32.fc, None
        feats = f32(x)  # (cells, 512) float32
        f32.fc = fc
        mean = feats.mean(dim=0)
        d = torch.linalg.svd(feats - mean, full_matrices=False).Vh[0]
        d = d * (MARGIN_STD / ((feats - mean) @ d).std())
        c = -(mean @ d)
        fc.weight.copy_(torch.stack([-d / 2, d / 2]))
        fc.bias.copy_(torch.stack([-c / 2, c / 2]))
    sd = {k: v.detach().cpu().clone() for k, v in f32.state_dict().items()}
    card = resnet18_from_state_dict(sd).to(device=dev, dtype=torch.bfloat16,
                                          memory_format=torch.channels_last)
    return sd, f32, card


def check_reference(sd, f32_card, ref_u8, ref_margins_bf16, dev) -> None:
    """The float32 CPU forward of ``ref_u8`` (tissue cells of the slide)
    against the card's float32 forward (TF32 off), and against the timed
    bf16 slice's margins of the same cells."""
    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
        normalize,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        resnet18_from_state_dict,
    )

    imgs = torch.from_numpy(ref_u8)
    cpu = resnet18_from_state_dict(sd)
    with torch.inference_mode():
        ref = cpu(normalize(imgs))
        got = f32_card(normalize(imgs.to(dev))).cpu()
    m_ref = (ref[:, 1] - ref[:, 0]).numpy()
    m32 = (got[:, 1] - got[:, 0]).numpy()
    d32 = np.abs(m32 - m_ref).max()
    d16 = np.abs(ref_margins_bf16 - m_ref).max()
    spread = m_ref.max() - m_ref.min()
    log(f"[reference] {len(m_ref)} tissue cells: CPU f32 margins span "
        f"{m_ref.min():.4f}..{m_ref.max():.4f} (spread {spread:.4f}, std "
        f"{m_ref.std():.4f})")
    log(f"[reference] card f32 max|Δ|={d32:.3g}; timed bf16 slice "
        f"max|Δ|={d16:.4g}, mean|Δ|={np.abs(ref_margins_bf16 - m_ref).mean():.4g}"
        f" (bound {BF16_ATOL})")
    if not np.isfinite(m_ref).all() or not np.isfinite(ref_margins_bf16).all():
        raise AssertionError("non-finite margins")
    if spread < 10 * BF16_ATOL:
        raise AssertionError("reference margins spread too little to check "
                             "the bf16 forward")
    if d32 > F32_ATOL:
        raise AssertionError("card f32 forward disagrees with the CPU's")
    if d16 > BF16_ATOL:
        raise AssertionError("timed bf16 slice outside the bf16 bound")


def phase_slice(dev, model, slide, ref_cells) -> dict:
    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
        NON_TISSUE_MARGIN,
        margin_detections,
        predict_slide,
        write_detection_csv,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        DETECTION_PROB_THRESHOLD,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.preprocess import (
        fused_normalize,
    )

    kw = dict(level=LEVEL, stride=STRIDE, batch_size=BATCH, output="margin",
              device=dev)
    runs = {}
    reset_counts()  # counts from here on are the slide path's
    for i, mode in enumerate(("device", "host", "device", "host")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        margins, grid = predict_slide(slide, model, tissue_filter=mode, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.setdefault(mode, []).append((wall, margins))
        log(f"[slice] run {i + 1} tissue_filter={mode}: {grid.num_patches} "
            f"cells in {wall:.3f} s = {grid.num_patches / wall:.1f} cells/s "
            f"({'cold' if i < 2 else 'warm'})")
    launches = fused_normalize.launches

    n = grid.num_patches
    dev_batches = -(-n // BATCH)
    log(f"[slice] grid {grid.nx}×{grid.ny} = {n} cells, {dev_batches} "
        f"device-mode batches per run; fused_normalize launches {launches}")
    if launches != 2 * dev_batches:
        raise AssertionError(f"expected {2 * dev_batches} kernel launches on "
                             f"the main path, counted {launches}")
    dev_m, host_m = runs["device"][1][1], runs["host"][1][1]
    if not np.isfinite(dev_m).all():
        raise AssertionError("non-finite margins")
    white = host_m == NON_TISSUE_MARGIN
    if not np.array_equal(dev_m == NON_TISSUE_MARGIN, white):
        raise AssertionError("device and host tissue partitions differ")
    if white.all() or not white.any():
        raise AssertionError("slide lacks tissue or white cells")
    d = np.abs(dev_m[~white] - host_m[~white])
    log(f"[slice] tissue cells {int((~white).sum())}, white {int(white.sum())}; "
        f"device vs host margins max|Δ|={d.max():.4g} "
        f"(max|m|={np.abs(host_m[~white]).max():.4g}, std "
        f"{host_m[~white].std():.4g}); repeat device runs "
        f"max|Δ|={np.abs(runs['device'][0][1] - dev_m).max():.4g}")
    if d.max() > MODES_ATOL:
        raise AssertionError("device and host margins disagree")

    dets = margin_detections(dev_m, grid, DETECTION_PROB_THRESHOLD)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke_slide.csv")
        write_detection_csv(path, dets)
        with open(path) as f:
            rows = f.read().splitlines()
    if len(rows) != len(dets) or not dets:
        raise AssertionError("no detections written")
    log(f"[slice] {len(dets)} detections, top {dets[:3]}")
    iy, ix = ref_cells[:, 0], ref_cells[:, 1]
    if white[iy, ix].any():
        raise AssertionError("a reference cell was filtered as white")
    return {"launches": launches, "ref_margins": dev_m[iy, ix],
            "host_margins": host_m}


def phase_cli(sd, slide) -> None:
    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
        save_npz_slide,
    )

    with tempfile.TemporaryDirectory() as tmp:
        slide_path = os.path.join(tmp, "smoke_slide.wsi.npz")
        save_npz_slide(slide_path, [slide.level_array(i)
                                    for i in range(slide.level_count)])
        models_dir = os.path.join(tmp, "models")
        os.makedirs(models_dir)
        torch.save(sd, os.path.join(models_dir, "resnet18_patch_classifier.pt"))
        cmd = [sys.executable, "-m", f"{PKG}.cli.main",
               "--predict_slide", slide_path, "--tissue_filter", "device",
               "--device", "cuda", "--stride", str(STRIDE),
               "--models_dir", models_dir]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ),
                              capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"CLI failed ({proc.returncode}):\n"
                                 f"{proc.stderr[-4000:]}")
        csv_path = os.path.join(models_dir, "model_predictions_csv",
                                "smoke_slide.csv")
        rows = np.loadtxt(csv_path, delimiter=",", ndmin=2)
    if rows.size == 0 or not ((rows[:, 0] > 0) & (rows[:, 0] < 1)).all():
        raise AssertionError("CLI wrote no valid detections")
    log(f"[cli] {' '.join(cmd[2:4])} … exit 0 in {wall:.1f} s (process "
        f"start and build cache included); {len(rows)} detections in "
        f"{os.path.basename(csv_path)}")


def tumor_labels(spec, slide, grid, cells, polygons=None):
    """Each cell's label from the slide's tumor polygons (or ``polygons``):
    tumor iff a mask pixel lies in its window (the level's mask, padded to
    the grid)."""
    import numpy as np

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.labeling import (
        patch_labels_from_mask_host,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.rasterize import (
        polygons_to_mask,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.synthetic import (
        polygons_level0,
    )

    polys = polygons_level0(spec) if polygons is None else polygons
    mask = polygons_to_mask(polys, slide.level_dimensions[LEVEL],
                            slide.level_dimensions[0])
    padded = np.zeros((grid.padded_height, grid.padded_width), np.uint8)
    padded[:mask.shape[0], :mask.shape[1]] = mask
    coords = np.stack([cells[:, 1], cells[:, 0]], axis=1) * grid.stride
    return patch_labels_from_mask_host(padded, coords, grid.patch_size)


def simclr_dataset(slide, grid, cells, labels, tmp):
    """The tissue cells (224² at level 3) with their labels cut into a
    packed store under ``tmp`` through the port's writer, as a
    ``PatchDataset``."""
    import numpy as np

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
        PatchDataset,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
        PatchManifest,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.patch_store import (
        PackedPatchWriter,
    )

    writer = PackedPatchWriter(tmp, LEVEL, "smoke_slide", grid.patch_size)
    coords = np.stack([cells[:, 1], cells[:, 0]], axis=1) * grid.stride
    recs = []
    for i in range(0, len(cells), BATCH):
        part = cells[i:i + BATCH]
        patches = np.stack([read_cell(slide, grid, iy, ix) for iy, ix in part])
        recs += writer.write_batch(patches, coords[i:i + BATCH],
                                   labels[i:i + BATCH].astype(np.int64))
    writer.close()
    return PatchDataset(PatchManifest(recs))


class _Messages:
    """A logging handler keeping the records of one of the port's loggers
    (the ``hipac`` tree does not propagate)."""

    def __init__(self, name: str):
        import logging

        from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
            get_logger,
        )

        self.records = []
        self.logger = get_logger(name)
        self.handler = logging.Handler(logging.INFO)
        self.handler.emit = self.records.append

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self.records

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def run_cli(argv: list[str]) -> tuple[int, float]:
    """The port's command line, in this process (so that the kernels'
    launch counts can be read around it): exit code and wall in s."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.cli.main import (
        main as cli_main,
    )

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli_main(argv)
    torch.cuda.synchronize()
    return rc, time.perf_counter() - t0


def phase_froc(sd, slide, spec, grid, tmp) -> int:
    """``--predict_slide <dir> --run_evaluation`` on the slide and its
    level-5 ground-truth mask, the normalize kernel's launches counted
    around it; the FROC score in [0, 1] and equal to an in-process
    ``run_froc_evaluation`` on the same CSVs."""
    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation.froc import (
        run_froc_evaluation,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
        save_npz_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.synthetic import (
        write_mask_npy,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.preprocess import (
        fused_normalize,
    )

    data_dir = os.path.join(tmp, "froc_data")
    models_dir = os.path.join(tmp, "froc_models")
    img_dir = os.path.join(data_dir, "test", "img")
    mask_dir = os.path.join(data_dir, "test", "mask")
    os.makedirs(img_dir)
    os.makedirs(models_dir)
    save_npz_slide(os.path.join(img_dir, "smoke_slide.wsi.npz"),
                   [slide.level_array(i) for i in range(slide.level_count)])
    mask_path = write_mask_npy(mask_dir, "smoke_slide", spec)
    mask = np.load(mask_path)
    torch.save(sd, os.path.join(models_dir, "resnet18_patch_classifier.pt"))
    argv = ["--predict_slide", img_dir, "--run_evaluation", "--data_dir",
            data_dir, "--models_dir", models_dir, "--tissue_filter", "device",
            "--stride", str(STRIDE), "--device", "cuda"]
    reset_counts()  # counts from here on are the FROC path's
    with _Messages("evaluation.froc") as records:
        rc, wall = run_cli(argv)
    launches = fused_normalize.launches
    scores = [r.args[0] for r in records if r.msg.startswith("FROC score")]
    if rc != 0 or len(scores) != 1:
        raise AssertionError(f"--predict_slide <dir> --run_evaluation: exit "
                             f"{rc}, FROC scores logged {scores}")
    csv_dir = os.path.join(models_dir, "model_predictions_csv")
    again = run_froc_evaluation(csv_dir, mask_dir)
    rows = np.loadtxt(os.path.join(csv_dir, "smoke_slide.csv"), delimiter=",",
                      ndmin=2)
    batches = -(-grid.num_patches // BATCH)
    log(f"[froc] {' '.join(argv[:3])} … exit 0 in {wall:.1f} s; level-5 mask "
        f"{mask.shape} with {int((mask > 0).sum())} tumor pixels; "
        f"{len(rows)} detections; fused_normalize launches {launches}; FROC "
        f"score {scores[0]!r}, in-process run_froc_evaluation "
        f"{again['score']!r}; {len(again['fps_per_image'])} curve points")
    if launches != batches:
        raise AssertionError(f"expected {batches} normalize launches on the "
                             f"FROC path, counted {launches}")
    if not 0.0 <= scores[0] <= 1.0 or scores[0] != again["score"]:
        raise AssertionError("FROC score outside [0, 1] or unlike the "
                             "in-process evaluation")
    return launches


def simclr_model(sd, dev):
    """A SimCLR model with the state dict ``sd``, on ``dev`` in training
    mode (float32 parameters, channels_last)."""
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.simclr import (
        SimCLRModel,
    )

    model = SimCLRModel()
    model.load_state_dict(sd)
    return model.to(dev, memory_format=torch.channels_last).train()


def phase_simclr(dev, ds, tmp) -> dict:
    """``pretrain_simclr`` at batch 512 on the kernels, counts read around
    it; then warm step times of the same step function."""
    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        Config,
        SimCLRConfig,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
        normalize,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
        BatchIterator,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        load_state_dict_file,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
        ResNet18FeatureExtractor,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.simclr_trainer import (
        make_simclr_train_step,
        pretrain_simclr,
        to_device,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
        create_train_state,
    )

    models_dir = os.path.join(tmp, "models")
    cfg = Config(simclr=SimCLRConfig(batch_size=BATCH, loss_impl="pallas"),
                 models_dir=models_dir)
    steps = SIMCLR_EPOCHS * -(-len(ds) // BATCH)
    real_last = len(ds) - (len(ds) // BATCH) * BATCH
    fwd, bwd = ntxent_launchers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # counts from here on are the SimCLR path's
    t0 = time.perf_counter()
    sd = pretrain_simclr(cfg, level=LEVEL, epochs=SIMCLR_EPOCHS, dataset=ds,
                         device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"nt_xent_fwd": fwd.launches, "nt_xent_bwd": bwd.launches}
    stem_fwd, stem_bwd = stem_train_launchers()
    stem = {"stem_train_fwd": stem_fwd.launches,
            "stem_train_bwd": stem_bwd.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"[simclr] {len(ds)} tissue cells, batch {BATCH}: {SIMCLR_EPOCHS} "
        f"epochs of {steps // SIMCLR_EPOCHS} steps (last batch {real_last} "
        f"real rows, {2 * (BATCH - real_last)} dead of {2 * BATCH}) in "
        f"{wall:.2f} s (cold, build cache and artifact writes included); "
        f"launches {launches}; peak device memory {peak / 2**30:.2f} GiB")
    if launches != {"nt_xent_fwd": steps, "nt_xent_bwd": steps}:
        raise AssertionError(f"expected {steps} launches of each NT-Xent "
                             f"kernel on the SimCLR path, counted {launches}")
    log(f"[simclr] stem_train calls (two forwards a step) {stem}")
    if stem != {"stem_train_fwd": 2 * steps, "stem_train_bwd": 2 * steps}:
        raise AssertionError(f"expected {2 * steps} calls of each stem_train "
                             f"kernel pair on the SimCLR path, counted {stem}")
    launches.update(stem)
    if not all(torch.isfinite(v).all() for v in sd.values()):
        raise AssertionError("non-finite SimCLR state")

    names = sorted(os.listdir(models_dir))
    if not {"simclr_encoder.pt", "simclr_encoder_best.pt"} <= set(names):
        raise AssertionError(f"SimCLR artifacts missing: {names}")
    saved = load_state_dict_file(os.path.join(models_dir, "simclr_encoder.pt"))
    enc = ResNet18FeatureExtractor()
    enc.load_state_dict({k.removeprefix("encoder."): v for k, v in saved.items()
                         if k.startswith("encoder.")}, strict=True)
    imgs, _ = ds.read_batch(range(8))
    x = normalize(torch.from_numpy(imgs).to(dev))
    with torch.no_grad():
        a = enc.to(dev).eval()(x)
        b = simclr_model(sd, dev).eval().encode(x)
    if not (torch.equal(a, b) and torch.isfinite(a).all()):
        raise AssertionError("reloaded encoder differs from the returned state")
    log(f"[simclr] artifacts {names}; simclr_encoder.pt reloads into "
        f"ResNet18FeatureExtractor through 'encoder.', features equal the "
        f"returned state's (std {a.std().item():.4g})")

    # warm step times: the path's step function on the path's batches
    state = create_train_state(simclr_model(sd, dev), cfg.simclr.learning_rate,
                               dev)
    train_step = make_simclr_train_step(cfg.simclr.temperature, 224, "pallas")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batches = [(torch.from_numpy(i).to(dev), torch.from_numpy(v).to(dev).bool())
               for i, _, v in BatchIterator(ds, BATCH, seed=SEED)]
    step_ms, losses = [], []
    for k in range(SIMCLR_TIMED_STEPS + 1):
        imgs_t, valid_t = batches[k % len(batches)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = train_step(state, gen, imgs_t, valid_t)
        torch.cuda.synchronize()
        if k:  # the first is a warm-up
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    q1, med, q3 = quartiles(step_ms)
    log(f"[simclr] warm step (batch on the card, synchronized): median "
        f"{med:.2f} ms (quartiles {q1:.2f}–{q3:.2f}, {len(step_ms)} steps) = "
        f"{2 * BATCH / med * 1e3:.0f} views/s; losses "
        f"{', '.join(f'{v:.4f}' for v in losses)}")
    # the path's loop over an epoch: host reads, copies and steps overlap
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for imgs, _, valid in BatchIterator(ds, BATCH, seed=SEED + 1):
        state, loss = train_step(state, gen, to_device(imgs, dev),
                                 to_device(valid, dev).bool())
        n += 1
    torch.cuda.synchronize()
    epoch_ms = (time.perf_counter() - t0) * 1e3
    log(f"[simclr] one warm epoch as pretrain_simclr runs it ({n} steps, "
        f"packed-store reads included): {epoch_ms:.1f} ms = "
        f"{epoch_ms / n:.2f} ms/step = {2 * BATCH * n / epoch_ms * 1e3:.0f} "
        f"views/s")
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite SimCLR losses")
    return {"launches": launches, "sd": sd}


def phase_simclr_check(dev, ds, sd) -> None:
    """The step's loss and gradients: kernels against the dense loss on the
    card, and the bf16 card step against a float32 CPU step."""
    import math

    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
        simclr_two_views,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.simclr_trainer import (
        simclr_loss,
    )

    def loss_and_grads(model, v1, v2, valid, impl):
        model.zero_grad(set_to_none=True)
        loss = simclr_loss(model, v1, v2, TAU, valid, impl)
        loss.backward()
        grads = {k: p.grad.detach().float().cpu()
                 for k, p in model.named_parameters() if k.startswith("projector")}
        return loss.item(), grads

    # kernels against the dense loss: one step, same state and views, the
    # path's last batch (216 real rows)
    order = torch.arange(len(ds))
    last = len(ds) - (len(ds) // BATCH) * BATCH
    idx = torch.cat([order[-last:], order[:BATCH - last]]).tolist()
    imgs, _ = ds.read_batch(idx)
    imgs_t = torch.from_numpy(imgs).to(dev)
    valid = torch.arange(BATCH, device=dev) < last
    v1, v2 = simclr_two_views(torch.Generator(device=dev).manual_seed(SEED),
                              imgs_t, 224)
    out = {impl: loss_and_grads(simclr_model(sd, dev), v1, v2, valid, impl)
           for impl in ("pallas", "xla")}
    d_loss = abs(out["pallas"][0] - out["xla"][0])
    d_grad = max((out["pallas"][1][k] - g).abs().max().item()
                 / g.abs().max().item() for k, g in out["xla"][1].items())
    log(f"[simclr-check] one step, {last} real rows of {BATCH}: loss pallas "
        f"{out['pallas'][0]:.6f} xla {out['xla'][0]:.6f} (|Δ| {d_loss:.3g}, "
        f"bound {PALLAS_XLA_LOSS_ATOL}); projector grads max|Δ|/max|g| "
        f"{d_grad:.3g} (bound {PALLAS_XLA_GRAD_RTOL})")
    if d_loss > PALLAS_XLA_LOSS_ATOL or d_grad > PALLAS_XLA_GRAD_RTOL:
        raise AssertionError("the NT-Xent kernels and the dense loss disagree "
                             "in the SimCLR step")

    # bf16 on the card against float32 on the CPU, same weights and views
    sub = imgs_t[:REF_BATCH]
    w1, w2 = simclr_two_views(torch.Generator(device=dev).manual_seed(SEED + 1),
                              sub, 224)
    card_loss, card_g = loss_and_grads(simclr_model(sd, dev), w1, w2, None,
                                       "pallas")
    cpu = simclr_model(sd, torch.device("cpu"))
    ref_loss, ref_g = loss_and_grads(cpu, w1.float().cpu(), w2.float().cpu(),
                                     None, "pallas")
    last_layer = [k for k in ref_g if k.startswith("projector.2")]
    d16 = max((card_g[k] - ref_g[k]).abs().max().item()
              / ref_g[k].abs().max().item() for k in last_layer)
    blind = math.log(2 * REF_BATCH - 1)
    log(f"[simclr-check] {REF_BATCH} cells: bf16 card loss {card_loss:.6f}, "
        f"float32 CPU loss {ref_loss:.6f} (|Δ| {abs(card_loss - ref_loss):.3g}, "
        f"bound {BF16_LOSS_ATOL}); last layer grads max|Δ|/max|g| {d16:.3g} "
        f"(bound {BF16_GRAD_RTOL}); ln(2N−1) = {blind:.6f}, reference "
        f"{abs(ref_loss - blind):.4g} away (must be ≥ {10 * BF16_LOSS_ATOL})")
    if not (math.isfinite(card_loss) and math.isfinite(ref_loss)):
        raise AssertionError("non-finite SimCLR loss")
    if abs(card_loss - ref_loss) > BF16_LOSS_ATOL or d16 > BF16_GRAD_RTOL:
        raise AssertionError("bf16 card step outside its bound of the "
                             "float32 CPU step")
    if abs(ref_loss - blind) < 10 * BF16_LOSS_ATOL:
        raise AssertionError("the reference loss is too close to ln(2N−1) to "
                             "check the bf16 step")


def card_step_against_cpu(tag: str, sd, imgs, lab, cw, valid=None,
                          frozen_bn: bool = False) -> float:
    """One bf16 card step of the classifier ``sd`` against a float32 CPU
    step: the same cells, augmentation draws and class weights (``cw``
    None: none), the BatchNorms on their running statistics with
    ``frozen_bn``. The loss within :data:`TRAIN_LOSS_ATOL`, the head's
    gradients within :data:`TRAIN_GRAD_RTOL` of max|g|; returns the loss
    |Δ|."""
    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
        augment_batch,
        sample_augment_params,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        resnet18_from_state_dict,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.augment import (
        augment_batch_kernel,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.trainer import (
        classifier_loss,
        set_bn_frozen,
    )

    params = sample_augment_params(torch.Generator().manual_seed(SEED),
                                   len(imgs))
    out = {}
    for where in ("cuda", "cpu"):
        d = torch.device(where)
        model = resnet18_from_state_dict(sd).to(
            d, memory_format=torch.channels_last).train()
        set_bn_frozen(model, frozen_bn)
        p = {k: v.to(d) for k, v in params.items()}
        x_u8 = torch.from_numpy(imgs).to(d)
        x = (augment_batch_kernel(p, x_u8) if where == "cuda"
             else augment_batch(p, x_u8))
        loss, _ = classifier_loss(
            model, x, torch.from_numpy(lab).long().to(d),
            None if cw is None else torch.from_numpy(cw).to(d),
            None if valid is None else torch.from_numpy(valid).to(d))
        loss.backward()
        out[where] = (loss.item(), x.cpu(),
                      {k: q.grad.detach().float().cpu()
                       for k, q in model.named_parameters()})
    d_loss = abs(out["cuda"][0] - out["cpu"][0])
    d_x = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    d_grad = {k: (out["cuda"][2][k] - g).abs().max().item() / g.abs().max().item()
              for k, g in out["cpu"][2].items() if g.abs().max() > 0}
    head = max(d_grad["fc.weight"], d_grad["fc.bias"])
    log(f"[{tag}] {len(imgs)} cells: bf16 card loss {out['cuda'][0]:.6f}, "
        f"float32 CPU loss {out['cpu'][0]:.6f} (|Δ| {d_loss:.3g}, bound "
        f"{TRAIN_LOSS_ATOL}); augmented inputs card kernel vs CPU plain "
        f"max|Δ| {d_x:.3g}; head grads max|Δ|/max|g| {head:.3g} (bound "
        f"{TRAIN_GRAD_RTOL}); all tensors: median {np.median(list(d_grad.values())):.3g}"
        f", max {max(d_grad.values()):.3g}")
    if not (np.isfinite(out["cuda"][0]) and np.isfinite(out["cpu"][0])):
        raise AssertionError("non-finite classifier loss")
    if d_loss > TRAIN_LOSS_ATOL or head > TRAIN_GRAD_RTOL:
        raise AssertionError(f"[{tag}] bf16 card step outside its bound of "
                             f"the float32 CPU step")
    return d_loss


def phase_train(dev, ds, slide, spec, simclr_models, tmp) -> dict:
    """The patch-classifier trainer on the card through the command line:
    ``--train`` for TRAIN_EPOCHS epochs on the slide's labelled tissue cells
    at batch 512, the augment kernel's launches counted around it; the
    ``self_supervised`` strategy from phase 6's encoder without pretraining
    again; ``--evaluate``; the artifacts reloaded and ``--predict_slide
    <dir> --run_evaluation`` from the trained classifier. Then one bf16 card
    step against a float32 CPU step from the same weights, cells and draws,
    and warm step times."""
    import hashlib
    import shutil

    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        Config,
        DataConfig,
        TrainConfig,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
        BatchIterator,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
        manifest_npz_path,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
        save_npz_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.synthetic import (
        write_mask_npy,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        resnet18_from_state_dict,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.augment import (
        augment_batch_kernel,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
        load_model,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.losses import (
        class_weights_inv_min,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
        create_train_state,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.trainer import (
        make_train_step,
        train_resnet_classifier_strategic,
    )

    data_dir = os.path.join(tmp, "train_data")
    models_dir = os.path.join(tmp, "train_models")
    logs_dir = os.path.join(tmp, "train_logs")
    img_dir = os.path.join(data_dir, "train", "img")
    os.makedirs(img_dir)
    os.makedirs(models_dir)
    save_npz_slide(os.path.join(img_dir, "smoke_slide.wsi.npz"),
                   [slide.level_array(i) for i in range(slide.level_count)])
    # the packed store of phase 6, now with a manifest on disk: numpy
    # columns, as this machine has no pyarrow
    manifest = ds.manifest
    manifest.save(manifest_npz_path(os.path.join(data_dir, "patches"), LEVEL))
    encoder = os.path.join(models_dir, "simclr_encoder.pt")
    shutil.copy(os.path.join(simclr_models, "simclr_encoder.pt"), encoder)
    cfg_path = os.path.join(tmp, "train_config.json")
    with open(cfg_path, "w") as f:
        json.dump({"log_dir": logs_dir,
                   "train": {"checkpoint_every_epochs": 1}}, f)
    common = ["--data_dir", data_dir, "--models_dir", models_dir, "--config",
              cfg_path, "--patch_level", str(LEVEL), "--device", "cuda"]
    labels = ds.labels
    steps = TRAIN_EPOCHS * -(-len(ds) // BATCH)
    log(f"[train] {len(ds)} tissue cells of one slide, {int(labels.sum())} "
        f"tumor, {int((labels == 0).sum())} normal (the split puts the one "
        f"slide on both sides: validation reads training cells)")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # counts from here on are the training path's
    rc, wall = run_cli(["--train", "--epochs", str(TRAIN_EPOCHS), *common])
    launches = augment_batch_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(logs_dir, "train_history.json")) as f:
        history = json.load(f)
    names = sorted(os.listdir(models_dir))
    log(f"[train] --train --epochs {TRAIN_EPOCHS}: exit {rc} in {wall:.2f} s "
        f"(cold); {steps} steps, augment launches {launches}; peak device "
        f"memory {peak / 2**30:.2f} GiB; history "
        f"{[{k: round(v, 4) for k, v in h.items()} for h in history]}; "
        f"artifacts {names}")
    if rc != 0:
        raise AssertionError(f"--train failed with exit code {rc}")
    if launches != steps:
        raise AssertionError(f"expected {steps} augment launches on the "
                             f"training path, counted {launches}")
    want = {"resnet18_patch_classifier.pt", "resnet18_patch_classifier_best.pt",
            *(f"resnet18_patch_classifier_epoch{e + 1}.pt"
              for e in range(TRAIN_EPOCHS))}
    if not want <= set(names) or len(history) != TRAIN_EPOCHS:
        raise AssertionError(f"training artifacts missing: {names}")
    if not all(np.isfinite(h["train_loss"]) for h in history):
        raise AssertionError("non-finite training loss")
    for name in ("resnet18_patch_classifier", "resnet18_patch_classifier_best"):
        sd = load_model(os.path.join(models_dir, name))
        resnet18_from_state_dict(sd)  # strict: every tensor in place
        if not all(torch.isfinite(v).all() for v in sd.values()
                   if v.is_floating_point()):
            raise AssertionError(f"non-finite weights in {name}.pt")

    # the self_supervised strategy from phase 6's encoder, no pretraining
    digest = hashlib.sha256(open(encoder, "rb").read()).hexdigest()
    fwd, bwd = ntxent_launchers()
    reset_counts()
    t0 = time.perf_counter()
    cfg = Config(data=DataConfig(data_dir=data_dir), models_dir=models_dir,
                 log_dir=logs_dir, train=TrainConfig(batch_size=BATCH))
    trainer = train_resnet_classifier_strategic(
        cfg, level=LEVEL, strategy="self_supervised", epochs=1,
        manifest=manifest, device="cuda")
    torch.cuda.synchronize()
    strategy_wall = time.perf_counter() - t0
    same = hashlib.sha256(open(encoder, "rb").read()).hexdigest() == digest
    log(f"[train] self_supervised, 1 epoch from simclr_encoder.pt: "
        f"{strategy_wall:.2f} s, augment launches "
        f"{augment_batch_kernel.launches}, NT-Xent launches "
        f"{fwd.launches + bwd.launches}, encoder unchanged {same}; "
        f"history {trainer.history}")
    if fwd.launches or bwd.launches or not same:
        raise AssertionError("the self_supervised strategy pretrained again")
    if not os.path.exists(os.path.join(
            models_dir, "resnet18_patch_classifier_self_supervised.pt")):
        raise AssertionError("self_supervised artifact missing")

    with _Messages("evaluation.classifier") as records:
        rc, eval_wall = run_cli(["--evaluate", *common])
    acc = [r.args[0] for r in records if r.msg.startswith("Validation accuracy")]
    log(f"[train] --evaluate: exit {rc} in {eval_wall:.2f} s, validation "
        f"accuracy {acc}")
    if rc != 0 or len(acc) != 1 or not 0.0 <= acc[0] <= 1.0:
        raise AssertionError("--evaluate failed")
    # the main path from the trained classifier: the slide's detections and
    # their FROC against its level-5 mask
    write_mask_npy(os.path.join(data_dir, "test", "mask"), "smoke_slide", spec)
    with _Messages("evaluation.froc") as records:
        rc, pred_wall = run_cli(["--predict_slide", img_dir, "--run_evaluation",
                                 "--stride", str(STRIDE), "--tissue_filter",
                                 "device", *common])
    scores = [r.args[0] for r in records if r.msg.startswith("FROC score")]
    rows = np.loadtxt(os.path.join(models_dir, "model_predictions_csv",
                                   "smoke_slide.csv"), delimiter=",", ndmin=2)
    log(f"[train] --predict_slide <dir> --run_evaluation from the trained "
        f"classifier: exit {rc} in {pred_wall:.2f} s, {len(rows)} detections, "
        f"FROC score {scores}")
    if (rc != 0 or len(scores) != 1 or not 0.0 <= scores[0] <= 1.0
            or (rows.size and not ((rows[:, 0] > 0) & (rows[:, 0] < 1)).all())):
        raise AssertionError("--predict_slide from the trained model failed")

    # one bf16 card step against a float32 CPU step: same weights, cells,
    # augmentation draws and class weights
    sd = load_model(os.path.join(models_dir, "resnet18_patch_classifier"))
    imgs, lab = ds.read_batch(range(REF_BATCH))
    cw = class_weights_inv_min(labels, 2)
    card_step_against_cpu("train-check", sd, imgs, lab, cw)

    # warm steps of the path's step function on the path's batches
    state = create_train_state(resnet18_from_state_dict(sd), 1e-4, dev)
    step = make_train_step(cw)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batches = [(torch.from_numpy(i).to(dev), torch.from_numpy(t).long().to(dev),
                torch.from_numpy(v).to(dev))
               for i, t, v in BatchIterator(ds, BATCH, seed=SEED)]
    step_ms, losses = [], []
    for k in range(TRAIN_TIMED_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, gen, *batches[k % len(batches)])
        torch.cuda.synchronize()
        if k:  # the first is a warm-up
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    q1, med, q3 = quartiles(step_ms)
    log(f"[train] warm step (batch on the card, synchronized): median "
        f"{med:.2f} ms (quartiles {q1:.2f}–{q3:.2f}, {len(step_ms)} steps) = "
        f"{BATCH / med * 1e3:.0f} patches/s; losses "
        f"{', '.join(f'{v:.4f}' for v in losses)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch = trainer.train_epoch(0)
    torch.cuda.synchronize()
    epoch_ms = (time.perf_counter() - t0) * 1e3
    log(f"[train] one warm epoch as Trainer.train_epoch runs it "
        f"({epoch['steps']} steps, packed-store reads included): "
        f"{epoch_ms:.1f} ms = {epoch_ms / epoch['steps']:.2f} ms/step = "
        f"{len(ds) / epoch_ms * 1e3:.0f} patches/s")
    return {"launches": launches, "trainer": trainer, "data_dir": data_dir,
            "models_dir": models_dir, "froc": scores[0]}


def phase_train_profile(trainer, n: int) -> None:
    """One warm epoch of the trainer under the profiler: the device's idle
    share. Last in the run: walls taken after a profiler session run long."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = trainer.train_epoch(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = busy_us(prof) / 1e3
    log(f"[train] warm epoch under the profiler ({stats['steps']} steps, "
        f"packed-store reads included): {wall_ms:.1f} ms = "
        f"{n / wall_ms * 1e3:.0f} patches/s; device busy {busy:.1f} ms, idle "
        f"share {1 - busy / wall_ms:.3f}")

    def device_ms(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0)) / 1e3

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(kernels, key=device_ms, reverse=True)[:12]
    log(f"[train] device time by kernel over the epoch (ms, launches; "
        f"{len(kernels)} kernels, {sum(map(device_ms, kernels)):.1f} ms in "
        f"all): " + "; ".join(f"{e.key[:60]} {device_ms(e):.2f} ({e.count})"
                              for e in top))


def mil_features(data_dir: str) -> list:
    """The feature triplet at level 3 of :data:`MIL_SLIDES` synthetic slides
    under ``data_dir/features``, through the port's writer; returns the
    bags as the trainer builds them.

    Instances are non-negative 512-wide rows, like ResNet18's pooled
    features. A tumor slide's bag carries 5–20 % instances shifted along one
    seeded non-negative direction on :data:`MIL_SHIFT_CHANNELS` channels,
    labelled tumor in their patch names."""
    import numpy as np

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.mil import (
        bags_from_artifacts,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.features import (
        _save_artifacts,
    )

    rng = np.random.default_rng(SEED)
    direction = np.zeros(512, np.float32)
    channels = rng.choice(512, MIL_SHIFT_CHANNELS, replace=False)
    direction[channels] = np.abs(rng.normal(size=MIL_SHIFT_CHANNELS)) + 0.5
    direction *= MIL_SHIFT / np.linalg.norm(direction)
    feats, labels, names = [], [], []
    for i in range(MIL_SLIDES):
        tumor = i % 2 == 1
        slide = f"{'tumor' if tumor else 'normal'}_{i // 2 + 1:03d}"
        n = int(rng.integers(*MIL_INSTANCES, endpoint=True))
        f = np.maximum(rng.normal(0.5, 1.0, (n, 512)), 0.0).astype(np.float32)
        lab = np.zeros(n, np.int64)
        if tumor:
            hit = rng.random(n) < rng.uniform(0.05, 0.20)
            f[hit] += direction
            lab[hit] = 1
        feats.append(f)
        labels.append(lab)
        names += [f"{slide}_x{224 * (j % 97)}_y{224 * (j // 97)}_"
                  f"{'tumor' if t else 'normal'}.png" for j, t in enumerate(lab)]
    features_dir = os.path.join(data_dir, "features")
    _save_artifacts(features_dir, LEVEL, np.concatenate(feats),
                    np.concatenate(labels), names)
    return bags_from_artifacts(features_dir, LEVEL)


def phase_mil(dev, tmp) -> dict:
    """``--train_mil`` as a CLI subprocess on the card, then ``mil_predict``
    with MC dropout on every bag, the kernel's launches counted around it."""
    import re

    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        Config,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.mil import (
        MILBagIterator,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.mil import (
        MILClassifier,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.mil_pool import (
        mil_attention_pool_kernel,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
        load_model,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.mil_trainer import (
        mil_predict,
        train_step,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.simclr_trainer import (
        to_device,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
        create_train_state,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    data_dir = os.path.join(tmp, "mil_data")
    models_dir = os.path.join(tmp, "mil_models")
    t0 = time.perf_counter()
    bags = mil_features(data_dir)
    sizes = [len(b.features) for b in bags]
    log(f"[mil] {len(bags)} bags ({sum(b.label for b in bags)} tumor), "
        f"{min(sizes)}–{max(sizes)} instances of width 512 "
        f"({sum(sizes)} in all), triplet written in "
        f"{time.perf_counter() - t0:.1f} s")

    cfg = Config(models_dir=models_dir)
    argv = ["--train_mil", "--data_dir", data_dir, "--patch_level",
            str(LEVEL), "--epochs", str(MIL_EPOCHS), "--models_dir",
            models_dir, "--device", "cuda"]
    with _Messages("train.mil") as records:
        rc, wall = run_cli(argv)
    if rc != 0:
        raise AssertionError(f"--train_mil failed ({rc})")
    text = "\n".join(r.getMessage() for r in records)
    epochs = re.findall(r"MIL epoch (\d+)/\d+: loss (\S+) acc (\S+)", text)
    val = re.search(r"MIL validation accuracy: (\S+)", text)
    log(f"[mil] {' '.join(argv)} … exit 0 in {wall:.1f} s (the CLI's main "
        f"in this process, the triplet's load included); epochs (loss, acc): "
        f"{[(float(l), float(a)) for _, l, a in epochs]}; validation "
        f"accuracy {val.group(1) if val else '?'}")
    if len(epochs) != MIL_EPOCHS:
        raise AssertionError(f"expected {MIL_EPOCHS} epoch lines, got "
                             f"{len(epochs)}")
    losses = [float(l) for _, l, _ in epochs]
    acc = float(epochs[-1][2])
    if not np.isfinite(losses).all() or acc <= 0.7:
        raise AssertionError(f"MIL training: losses {losses}, last training "
                             f"accuracy {acc} (must be > 0.7)")

    sd = load_model(os.path.join(models_dir, "mil_classifier"))
    sd_card = {k: v.to(dev) for k, v in sd.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    walls, preds = [], []
    torch.cuda.synchronize()
    reset_counts()  # counts from here on are the MIL path's
    for bag in bags:
        t0 = time.perf_counter()
        preds.append(mil_predict(sd_card, bag.features, cfg, mc_dropout=True,
                                 generator=gen, device=dev))
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = mil_attention_pool_kernel.launches
    q1, med, q3 = quartiles(walls[1:])
    log(f"[mil] mil_predict with {cfg.uncertainty.monte_carlo_samples} "
        f"MC-dropout samples on {len(bags)} bags: first {walls[0]:.2f} ms, then "
        f"median {med:.2f} ms (quartiles {q1:.2f}–{q3:.2f}) = "
        f"{1e3 / med:.1f} bags/s; mil_attention_pool launches {launches}")
    if launches != len(bags):
        raise AssertionError(f"expected {len(bags)} MIL pool launches (one per "
                             f"MC-dropout call), counted {launches}")
    right = sum(p["prediction"] == b.label for p, b in zip(preds, bags))
    for p, b in zip(preds, bags):
        k = min(len(b.features), cfg.mil.max_bag_size)
        if not (np.isfinite(p["probs"]).all() and np.isfinite(p["mc_mean"]).all()
                and abs(p["attention"].sum() - 1.0) < 1e-4
                and len(p["attention"]) == k and (p["mc_variance"] > 0).all()):
            raise AssertionError(f"bad mil_predict output for {b.slide}")
    log(f"[mil] {right}/{len(bags)} slides right; attention sums to 1, "
        f"mc_variance > 0 on every bag (e.g. {preds[1]['mc_variance']})")

    # without MC dropout: bags of 4096+ instances pool on the kernel
    for bag in bags:
        before = mil_attention_pool_kernel.launches
        mil_predict(sd_card, bag.features, cfg, device=dev)
        expect = int(min(len(bag.features), cfg.mil.max_bag_size)
                     >= cfg.mil.streaming_bag_threshold)
        if mil_attention_pool_kernel.launches - before != expect:
            raise AssertionError(f"{len(bag.features)}-instance bag launched "
                                 f"the kernel {mil_attention_pool_kernel.launches - before}"
                                 f" times without MC dropout, expected {expect}")
    log(f"[mil] without MC dropout: {sum(s >= 4096 for s in sizes)} bags of "
        f"4096+ instances launched once each, the others not at all")

    # kernel route against module route; card against the CPU
    short = next(b for b in bags if len(b.features) < 4096)
    long = next(b for b in bags if len(b.features) >= 4096)
    d_route = 0.0
    for bag in (short, long):
        on = mil_predict(sd_card, bag.features, cfg, streaming=True, device=dev)
        off = mil_predict(sd_card, bag.features, cfg, streaming=False, device=dev)
        d_route = max(d_route, np.abs(on["probs"] - off["probs"]).max())
        if on["prediction"] != off["prediction"]:
            raise AssertionError("the kernel and module routes predict apart")
    # the trained classifier's probabilities may sit at 0 and 1, so the
    # seeded untrained one is held too, and the attention maps
    d_cpu = d_attn = 0.0
    seeded = MILClassifier(input_dim=512).state_dict()
    for params in (sd, seeded):
        for bag in (short, long):
            card = mil_predict(params, bag.features, cfg, device=dev)
            cpu = mil_predict(params, bag.features, cfg, device="cpu")
            d_cpu = max(d_cpu, np.abs(card["probs"] - cpu["probs"]).max())
            d_attn = max(d_attn, np.abs(card["attention"] - cpu["attention"]).max()
                         / cpu["attention"].max())
            log(f"[mil] {'trained' if params is sd else 'seeded'} "
                f"{len(bag.features)}-bag probs card {card['probs']} CPU "
                f"{cpu['probs']}")
    log(f"[mil] probs max|Δ|: kernel route against module route {d_route:.3g}, "
        f"card against CPU {d_cpu:.3g} (bound {MIL_PROBS_ATOL}); attention "
        f"card against CPU {d_attn:.3g} of its max (bound {MIL_ATTN_RTOL})")
    if (d_route > MIL_PROBS_ATOL or d_cpu > MIL_PROBS_ATOL
            or d_attn > MIL_ATTN_RTOL):
        raise AssertionError("MIL probabilities or attention disagree across "
                             "routes or devices")

    # a warm epoch as train_mil_classifier runs it (20 train bags, batch 8)
    order = np.random.default_rng(cfg.train.seed).permutation(len(bags))
    train_bags = [bags[i] for i in order[max(1, int(len(bags) * 0.2)):]]
    model = MILClassifier(input_dim=512)
    model.load_state_dict(sd)
    state = create_train_state(model, cfg.mil.learning_rate, dev)
    batches = MILBagIterator(train_bags, 8, cfg.mil.max_bag_size, seed=SEED)
    epoch_ms = []
    for _ in range(2):  # the first is a warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for feats, mask, labels, valid in batches:
            train_step(state, gen, to_device(feats, dev), to_device(mask, dev),
                       to_device(labels, dev), to_device(valid, dev))
        torch.cuda.synchronize()
        epoch_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[mil] one warm epoch ({len(batches)} steps at batch 8, bags padded "
        f"to {cfg.mil.max_bag_size}, host batching included): "
        f"{epoch_ms[1]:.1f} ms (first {epoch_ms[0]:.1f} ms)")
    return {"launches": launches}


def ms_cells(slide, grid, cells) -> dict:
    """The co-located patches of grid cells at every level of MS_LEVELS,
    as ``predict_slide_multiscale`` cuts them (white past the slide): each
    level's patch shares the base cell's level-0 origin."""
    import numpy as np

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.pyramid import (
        patch_size_for_level,
    )

    out = {}
    for lvl in MS_LEVELS:
        ps = patch_size_for_level(lvl)
        out[lvl] = np.stack([
            slide.read_region(grid.level0_origin(ix * grid.stride,
                                                 iy * grid.stride),
                              lvl, (ps, ps)) for iy, ix in cells])
    return out


def _center(x, size: int = 224):
    off = (x.shape[1] - size) // 2
    return x[:, off:off + size, off:off + size]


def make_hierarchical(dev, sd, calib_u8) -> dict:
    """The multiscale classifier of phase 11 as a state dict with its
    calibration (``hierarchical_classifier.pt``): the slice's BN-calibrated
    trunk, a seeded scale embedding and heads, and the heads set as
    ``make_model`` sets its head. Over the calibration cells' features (the
    artifact's crop input mode), ``aux_head`` reads the first principal
    direction of the scale-embedded per-level features, and two units of
    ``head_hidden`` read that of the concatenated features, one each way,
    whose difference ``head_out`` takes: the fused margin is linear in it.
    Both spread with std MARGIN_STD, far beyond the bf16 bound."""
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
        normalize,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        CALIBRATION_PREFIX,
        strip_head,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.hierarchical import (
        HierarchicalPatchClassifier,
    )

    g = torch.Generator().manual_seed(SEED + 11)
    model = HierarchicalPatchClassifier(levels=MS_LEVELS, aux=True, generator=g)
    model.trunk.load_state_dict(strip_head(sd))
    model = model.to(dev)
    n = len(calib_u8[MS_LEVELS[0]])
    x = torch.cat([torch.from_numpy(_center(calib_u8[MS_LEVELS[0]]).copy()),
                   torch.from_numpy(calib_u8[MS_LEVELS[1]])]).to(dev)

    def direction(rows):
        mean = rows.mean(dim=0)
        d = torch.linalg.svd(rows - mean, full_matrices=False).Vh[0]
        d = d * (MARGIN_STD / ((rows - mean) @ d).std())
        return d, -(mean @ d)

    with torch.no_grad():
        feats = model.trunk(normalize(x)).reshape(2, n, -1).transpose(0, 1)
        e = feats + model.scale_embed[None]
        d, c = direction(e.reshape(n, -1))
        model.head_hidden.weight[0] = d
        model.head_hidden.bias[0] = c
        model.head_hidden.weight[1] = -d
        model.head_hidden.bias[1] = -c
        fused = e.reshape(n, -1) @ d + c
        da, ca = direction(e.reshape(2 * n, -1))
        # the aux margins rise with the fused ones (an SVD direction's sign
        # is arbitrary): the ensembles then spread as their parts do
        if torch.corrcoef(torch.stack([fused, (e[:, -1] @ da + ca)]))[0, 1] < 0:
            da, ca = -da, -ca
        model.aux_head.weight.copy_(torch.stack([-da / 2, da / 2]))
        model.aux_head.bias.copy_(torch.stack([-ca / 2, ca / 2]))
        model.head_out.weight.zero_()
        model.head_out.weight[0, :2] = torch.tensor([-0.5, 0.5])
        model.head_out.weight[1, :2] = torch.tensor([0.5, -0.5])
        model.head_out.bias.zero_()
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    for key, value in MS_CAL.items():
        state[f"{CALIBRATION_PREFIX}{key}"] = torch.tensor(float(value),
                                                          dtype=torch.float64)
    return state


def ms_reference(state, calibration, u8, input_mode):
    """The float32 CPU scores (cells, 5) of multiscale cells, through the
    port's step with its plain versions."""
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.multiscale import (
        make_prob_step_multiscale,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        hierarchical_from_state_dict,
    )

    cpu = hierarchical_from_state_dict(state, MS_LEVELS)
    step = make_prob_step_multiscale(
        cpu, MS_LEVELS, 224, temperature=calibration["temperature"],
        aux_temperature=calibration["aux_temperature"],
        ensemble_weight=calibration["ensemble_weight"], with_aux=True,
        ensemble_base_weight=calibration["ensemble_base_weight"],
        input_mode=input_mode)
    return step({lvl: torch.from_numpy(x) for lvl, x in u8.items()}).numpy()


def phase_multiscale(dev, sd, slide, spec, grid, host_margins, calib, ref,
                     tmp) -> dict:
    """``--predict_slide --multiscale`` at levels (2, 3) on the slice's grid:
    the float path in both input modes with 2a's launches counted, against
    the float32 CPU forward of the same multiscale cells; the component
    identities; the CLI with ``--ms_components``, and ``<dir> --run_evaluation``;
    the cascade (survivors, and a bailout); ``--quantize --multiscale`` and
    the int8 path on the stacked batch; walls in turns with the single-level
    host-filter slice."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        Config,
        DataConfig,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
        PatchManifest,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.multiscale import (
        MultiscaleDataset,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.patch_store import (
        PackedPatchWriter,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.multiscale import (
        COMBINE_COLUMNS,
        COMPONENT_EXPORTS,
        predict_slide_multiscale,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
        NON_TISSUE_MARGIN,
        predict_slide,
        prob_to_margin,
        sigmoid,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
        save_npz_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.synthetic import (
        write_mask_npy,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        hierarchical_from_state_dict,
        resnet18_from_state_dict,
        split_calibration,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quant_artifact import (
        TRUNK_ARTIFACT,
        artifact_input_hw,
        load_quantized,
        quantize_trunk_to_artifact,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quantized import (
        quant_forward,
        quantized_to,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.preprocess import (
        fused_normalize,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
        save_model,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    s = len(MS_LEVELS)
    calib_u8 = ms_cells(slide, grid, calib)
    state = make_hierarchical(dev, sd, calib_u8)
    module_state, cal = split_calibration(state)
    models_dir = os.path.join(tmp, "ms_models")
    save_model(os.path.join(models_dir, "hierarchical_classifier"), state)
    model = hierarchical_from_state_dict(module_state, MS_LEVELS).for_inference(
        dev, torch.bfloat16)
    white = host_margins == NON_TISSUE_MARGIN
    n_tissue = int((~white).sum())
    batches = -(-n_tissue // MS_BATCH)
    kw = dict(levels=MS_LEVELS, stride=STRIDE, batch_size=MS_BATCH,
              output="margin", return_components=True, device=dev)
    ref_u8 = ms_cells(slide, grid, ref)
    iy, ix = ref[:, 0], ref[:, 1]

    # the float path, in the artifact's crop mode and in resize mode (2a at
    # 448² in float32 before the antialiased resize)
    full = {}
    for mode in ("crop", "resize"):
        reset_counts()  # counts from here on are the multiscale path's
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, ms_grid, comps = predict_slide_multiscale(
            slide, model, cal, input_mode=mode, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fused_normalize.launches
        full[mode] = (out, comps, launches)
        log(f"[multiscale] predict_slide_multiscale levels {MS_LEVELS}, "
            f"input_mode={mode}: {ms_grid.num_patches} cells "
            f"({ms_grid.nx}×{ms_grid.ny}, base level {ms_grid.level}) in "
            f"{wall:.3f} s (first run); {batches} batches of ≤ {MS_BATCH} "
            f"cells = {s * MS_BATCH} images a trunk call; fused_normalize "
            f"launches {launches}")
        if (ms_grid.nx, ms_grid.ny) != (grid.nx, grid.ny):
            raise AssertionError("the multiscale grid is not the slice's")
        if launches != s * batches:
            raise AssertionError(f"expected {s * batches} fused_normalize "
                                 f"launches, counted {launches}")
        for name in COMBINE_COLUMNS:
            if not np.isfinite(comps[name]).all():
                raise AssertionError(f"non-finite {name} scores")
            if not np.array_equal(comps[name] == NON_TISSUE_MARGIN, white):
                raise AssertionError(f"the {name} tissue partition differs "
                                     f"from the slice's host partition")
        # the component identities, in log-odds space
        w, wb = cal["ensemble_weight"], cal["ensemble_base_weight"]
        t = ~white
        d_ens = np.abs(comps["ensemble"][t] - (w * comps["fusion"][t] + (
            1 - w) * comps["aux"][t])).max()
        d_base = np.abs(comps["ensemble_base"][t] - (wb * comps["fusion"][t] + (
            1 - wb) * comps["aux_base"][t])).max()
        if (not np.array_equal(out, comps["ensemble"])
                or max(d_ens, d_base) > 1e-4):
            raise AssertionError("multiscale component identities do not hold")
        want = ms_reference(module_state, cal, ref_u8, mode)
        got = np.stack([comps[name][iy, ix] for name in COMBINE_COLUMNS], 1)
        d = np.abs(got - want).max(axis=0)
        spread = np.ptp(want, axis=0)
        log(f"[multiscale] {len(ref)} reference cells, input_mode={mode}: "
            f"bf16 card against float32 CPU per column "
            f"{dict(zip(COMBINE_COLUMNS, np.round(d, 4).tolist()))} (bound "
            f"{MS_BF16_ATOL}); CPU spreads "
            f"{dict(zip(COMBINE_COLUMNS, np.round(spread, 3).tolist()))}; "
            f"identities max|Δ| {d_ens:.3g}, {d_base:.3g}")
        if (spread < 10 * MS_BF16_ATOL).any() or (d > MS_BF16_ATOL).any():
            raise AssertionError("multiscale bf16 scores outside their bound "
                                 "of the float32 forward, or the reference "
                                 "spreads too little to check them")
        # the fine stream's input mode changes the fused scores, not aux_base
    d_modes = np.abs(full["crop"][1]["fusion"][~white]
                     - full["resize"][1]["fusion"][~white]).max()
    log(f"[multiscale] crop against resize: fusion max|Δ| {d_modes:.4g}")
    out, comps, ms_launches = full["crop"]
    split_check("[multiscale]", lambda devs: predict_slide_multiscale(
        slide, model, cal, input_mode="crop", devices=devs, **kw)[2],
        comps, int((~white).sum()), MS_BATCH, s, dev)

    # the CLI: --ms_components, then <dir> --run_evaluation
    slide_path = os.path.join(tmp, "ms_slide", "smoke_slide.wsi.npz")
    os.makedirs(os.path.dirname(slide_path))
    save_npz_slide(slide_path, [slide.level_array(i)
                                for i in range(slide.level_count)])
    argv = ["--predict_slide", slide_path, "--multiscale", "--levels",
            ",".join(map(str, MS_LEVELS)), "--ms_components", "--stride",
            str(STRIDE), "--batch_size", str(MS_BATCH), "--models_dir",
            models_dir, "--device", "cuda"]
    reset_counts()
    rc, wall = run_cli(argv)
    cli_launches = fused_normalize.launches
    csvs = {c: os.path.join(models_dir, f"model_predictions_csv{c}",
                            "smoke_slide.csv")
            for c in [""] + [f"_{c}" for c in COMPONENT_EXPORTS]}
    rows = {c: np.loadtxt(p, delimiter=",", ndmin=2) for c, p in csvs.items()
            if os.path.exists(p)}
    log(f"[multiscale] {' '.join(argv[:2])} --multiscale --ms_components … "
        f"exit {rc} in {wall:.2f} s; fused_normalize launches {cli_launches}; "
        f"detections {[len(r) for r in rows.values()]} in {len(rows)} CSVs")
    if (rc != 0 or len(rows) != len(csvs) or cli_launches != s * batches
            or any(r.size == 0 or not ((r[:, 0] > 0) & (r[:, 0] < 1)).all()
                   for r in rows.values())):
        raise AssertionError("--predict_slide --multiscale --ms_components "
                             "failed or wrote no valid detections")
    data_dir = os.path.join(tmp, "ms_froc_data")
    img_dir = os.path.join(data_dir, "test", "img")
    os.makedirs(img_dir)
    os.link(slide_path, os.path.join(img_dir, "smoke_slide.wsi.npz"))
    write_mask_npy(os.path.join(data_dir, "test", "mask"), "smoke_slide", spec)
    froc_models = os.path.join(tmp, "ms_froc_models")
    save_model(os.path.join(froc_models, "hierarchical_classifier"), state)
    with _Messages("evaluation.froc") as records:
        rc, wall = run_cli(["--predict_slide", img_dir, "--multiscale",
                            "--run_evaluation", "--data_dir", data_dir,
                            "--stride", str(STRIDE), "--batch_size",
                            str(MS_BATCH), "--models_dir", froc_models,
                            "--device", "cuda"])
    scores = [r.args[0] for r in records if r.msg.startswith("FROC score")]
    log(f"[multiscale] --predict_slide <dir> --multiscale --run_evaluation: "
        f"exit {rc} in {wall:.2f} s; FROC score {scores}")
    if rc != 0 or len(scores) != 1 or not 0.0 <= scores[0] <= 1.0:
        raise AssertionError("--predict_slide <dir> --multiscale "
                             "--run_evaluation gave no FROC score in [0, 1]")

    # the cascade: a floor at the median screen score, no probe; then a
    # keep-everything floor with the probe, which bails out
    tissue_base = comps["aux_base"][~white]
    floor = float(np.median(sigmoid(tissue_base)))
    reset_counts()
    with _Messages("torch.infer.multiscale") as records:
        casc, _, ccomps = predict_slide_multiscale(
            slide, model, cal, cascade=floor, cascade_bailout=1.0, **kw)
    casc_launches = fused_normalize.launches
    survived = ccomps["fusion"] != NON_TISSUE_MARGIN
    screened = ~white & ~survived
    n_surv = int(survived.sum())
    want_launches = batches + s * -(-n_surv // MS_BATCH)
    d_surv = np.abs(ccomps["fusion"][survived] - comps["fusion"][survived]).max()
    below = ccomps["aux_base"][screened]
    log(f"[multiscale] cascade floor p={floor:.4f} (margin "
        f"{prob_to_margin(floor):.4f}), bailout 1.0: {n_surv} of {n_tissue} "
        f"tissue cells survive; fused_normalize launches {casc_launches} "
        f"(screen {batches} + {s} × {-(-n_surv // MS_BATCH)}); survivors' "
        f"fusion against the full pass max|Δ| {d_surv:.4g}; screened-out "
        f"aux_base max {below.max() if below.size else float('nan'):.4f}")
    if (not 0 < n_surv < n_tissue or casc_launches != want_launches
            or survived[white].any()
            or (below >= prob_to_margin(floor)).any()
            or not np.array_equal(casc[screened], below)
            or d_surv > MODES_ATOL):
        raise AssertionError("the cascade's survivors, fill or launches are "
                             "wrong")
    with _Messages("torch.infer.multiscale") as records:
        bail, _, bcomps = predict_slide_multiscale(
            slide, model, cal, cascade=1e-9, cascade_bailout=0.6, **kw)
    text = "\n".join(r.getMessage() for r in records)
    d_bail = max(np.abs(bcomps[c][~white] - comps[c][~white]).max()
                 for c in COMBINE_COLUMNS)
    log(f"[multiscale] cascade floor p=1e-9, bailout 0.6: bailed out "
        f"{'mid-flight' if 'probe never armed' not in text else 'at the end'}"
        f" ({'cascade: bailout' in text}); every column against the full "
        f"pass max|Δ| {d_bail:.4g}")
    if "cascade: bailout" not in text or d_bail > MODES_ATOL:
        raise AssertionError("the keep-everything cascade did not bail out to "
                             "the full pass")

    # --quantize --multiscale: the function behind the flag on a packed store
    # of the calibration cells at both levels (crop mode: no cv2 on the card)
    store = os.path.join(tmp, "ms_patches")
    manifests = {}
    for lvl in MS_LEVELS:
        ratio = 2 ** (LEVEL - lvl)  # base-level px → level px
        writer = PackedPatchWriter(store, lvl, "smoke_slide",
                                   calib_u8[lvl].shape[1])
        coords = np.stack([calib[:, 1], calib[:, 0]], 1) * STRIDE * ratio
        manifests[lvl] = PatchManifest(writer.write_batch(
            calib_u8[lvl], coords, np.zeros(len(calib), np.int64)))
        writer.close()
    ds = MultiscaleDataset(manifests, resize_to=224, input_mode="crop")
    cfg = Config(data=DataConfig(data_dir=os.path.join(tmp, "ms_data")),
                 models_dir=models_dir)
    reset_counts()
    t0 = time.perf_counter()
    path = quantize_trunk_to_artifact(cfg, levels=MS_LEVELS, dataset=ds,
                                      device="cuda")
    wall = time.perf_counter() - t0
    tree = load_quantized(path)
    log(f"[multiscale] --quantize --multiscale: {len(ds)} aligned cells, 4 "
        f"batches of 64 stacked to 128 images → {os.path.basename(path)} "
        f"({os.path.getsize(path) / 1e6:.1f} MB, stem "
        f"{tuple(tree['qkernels']['stem'].shape)}, input "
        f"{artifact_input_hw(tree)}) in {wall:.2f} s")
    if (os.path.basename(path) != TRUNK_ARTIFACT or len(ds) != len(calib)
            or artifact_input_hw(tree) != (224, 224) or tree["fc"] is not None):
        raise AssertionError("--quantize --multiscale did not write the trunk "
                             "artifact of a 224² input")
    m32 = hierarchical_from_state_dict(module_state, MS_LEVELS).for_inference(
        dev, torch.float32)
    stage1, conv, pool = int8_launchers()
    reset_counts()  # counts from here on are the int8 multiscale path's
    q_out, _, qcomps = predict_slide_multiscale(
        slide, m32, cal, int8=True, qtree=tree, **kw)
    torch.cuda.synchronize()
    q_launches = (stage1.launches, conv.launches, pool.launches)
    log(f"[multiscale] predict_slide_multiscale(int8=True, qtree=artifact): "
        f"launches fused_stage1_int8 {q_launches[0]}, int8_conv_requant "
        f"{q_launches[1]}, int8_maxpool {q_launches[2]} over {batches} "
        f"stacked batches of ≤ {s * MS_BATCH} images")
    if q_launches != (batches, 16 * batches, batches):
        raise AssertionError(f"expected {batches}, {16 * batches} and "
                             f"{batches} launches on the int8 multiscale path, "
                             f"counted {q_launches}")
    if not np.array_equal(qcomps["fusion"] == NON_TISSUE_MARGIN, white):
        raise AssertionError("the int8 multiscale tissue partition differs")
    qt = quantized_to(tree, dev)
    x_ref = torch.cat([torch.from_numpy(_center(ref_u8[MS_LEVELS[0]]).copy()),
                       torch.from_numpy(ref_u8[MS_LEVELS[1]])]).to(dev)
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
        normalize,
    )

    with torch.inference_mode():
        f8 = quant_forward(qt, x_ref, with_fc=False).reshape(s, len(ref), -1)
        f32 = m32.trunk(normalize(x_ref)).reshape(s, len(ref), -1)
        l8 = m32.fuse(f8.transpose(0, 1))
        l32 = m32.fuse(f32.transpose(0, 1))
    cos = F.cosine_similarity(l8.flatten(), l32.flatten(), dim=0).item()
    m8 = ((l8[:, 1] - l8[:, 0]) / cal["temperature"]).cpu().numpy()
    d_slide = np.abs(qcomps["fusion"][iy, ix] - m8).max()
    log(f"[multiscale] {len(ref)} reference cells: int8 fused logits against "
        f"float32 cosine {cos:.5f} (bound {INT8_COSINE_MIN}); the slide run's "
        f"fusion scores against a direct quant_forward max|Δ| {d_slide:.3g}")
    if cos < INT8_COSINE_MIN or d_slide > 1e-4 * np.abs(m8).max():
        raise AssertionError("int8 multiscale logits outside their bound of "
                             "float32, or the slide run unlike a direct forward")
    with _Messages("models.quant_artifact") as records:
        rc, wall = run_cli(["--predict_slide", slide_path, "--multiscale",
                            "--int8", "--stride", str(STRIDE), "--batch_size",
                            str(MS_BATCH), "--models_dir", models_dir,
                            "--device", "cuda"])
    used = any("using persisted" in r.getMessage() for r in records)
    log(f"[multiscale] --predict_slide --multiscale --int8 … exit {rc} in "
        f"{wall:.2f} s; artifact picked up: {used}")
    if rc != 0 or not used:
        raise AssertionError("--predict_slide --multiscale --int8 did not run "
                             "from the trunk artifact")
    del m32, qt

    # walls in turns with the single-level host-filter slice (bf16, B=512)
    single = resnet18_from_state_dict(sd).to(device=dev, dtype=torch.bfloat16,
                                             memory_format=torch.channels_last)
    one = lambda: predict_slide(slide, single, level=LEVEL, stride=STRIDE,  # noqa: E731
                                batch_size=BATCH, output="margin",
                                tissue_filter="host", device=dev)
    multi = lambda: predict_slide_multiscale(slide, model, cal, **kw)  # noqa: E731
    walls = {"single": [], "multi": []}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)

    one()
    for _ in range(MS_WALL_RUNS):
        for name, fn in (("single", one), ("multi", multi), ("multi", multi),
                         ("single", one)):
            timed(name, fn)
    torch.cuda.reset_peak_memory_stats()
    multi()
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = {k: statistics.median(v) for k, v in walls.items()}
    log(f"[multiscale] warm walls in turns ({2 * MS_WALL_RUNS} runs each): "
        f"multiscale {med['multi']:.4f} s median ({min(walls['multi']):.4f}–"
        f"{max(walls['multi']):.4f}) = {grid.num_patches / med['multi']:.1f} "
        f"cells/s; single-level host filter {med['single']:.4f} s "
        f"({min(walls['single']):.4f}–{max(walls['single']):.4f}) = "
        f"{grid.num_patches / med['single']:.1f} cells/s; ratio "
        f"{med['multi'] / med['single']:.2f}; multiscale peak device memory "
        f"{peak:.2f} GiB")
    return {"launches": ms_launches, "int8_launches": q_launches,
            "model": model, "cal": cal, "walls": walls, "peak_gib": peak}


def phase_multiscale_profile(dev, slide, model, cal) -> None:
    """One warm multiscale run under the profiler: device-busy time and the
    idle share of the wall (last in the run: host walls taken after a
    profiler session come out longer)."""
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.multiscale import (
        predict_slide_multiscale,
    )

    kw = dict(levels=MS_LEVELS, stride=STRIDE, batch_size=MS_BATCH,
              output="margin", device=dev)
    predict_slide_multiscale(slide, model, cal, **kw)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict_slide_multiscale(slide, model, cal, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = busy_us(prof) / 1e3

    def device_ms(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0)) / 1e3

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(kernels, key=device_ms, reverse=True)[:12]
    log(f"[multiscale] one warm run under the profiler: wall {wall * 1e3:.1f} "
        f"ms, device busy {busy:.1f} ms → idle {1 - busy / (wall * 1e3):.3f}; "
        f"device time by kernel (ms, launches): "
        + "; ".join(f"{e.key[:50]} {device_ms(e):.2f} ({e.count})"
                    for e in top))
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")


def ms_level2_store(slide, grid, cells, labels, patches_dir):
    """The tissue cells at level 2 (448², the level-0 origins of the level-3
    cells), with their labels, in a packed store under ``patches_dir`` and a
    numpy manifest beside it; written in chunks (1.05 GB in all)."""
    import numpy as np

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
        PatchManifest,
        manifest_npz_path,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.patch_store import (
        PackedPatchWriter,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.pyramid import (
        patch_size_for_level,
    )

    lvl = MS_LEVELS[0]
    ps = patch_size_for_level(lvl)
    ratio = 2 ** (LEVEL - lvl)  # level-3 px → level-2 px
    writer = PackedPatchWriter(patches_dir, lvl, "smoke_slide", ps)
    coords = np.stack([cells[:, 1], cells[:, 0]], 1) * grid.stride * ratio
    recs = []
    for i in range(0, len(cells), MS_BATCH):
        part = cells[i:i + MS_BATCH]
        patches = np.stack([slide.read_region(
            grid.level0_origin(ix * grid.stride, iy * grid.stride), lvl,
            (ps, ps)) for iy, ix in part])
        recs += writer.write_batch(patches, coords[i:i + MS_BATCH],
                                   labels[i:i + MS_BATCH].astype(np.int64))
    writer.close()
    manifest = PatchManifest(recs)
    manifest.save(manifest_npz_path(patches_dir, lvl))
    return manifest


def phase_ms_train(dev, ds, slide, grid, tissue, labels, ref_u8, train) -> dict:
    """Multiscale training, QAT and their serving paths on the card, through
    the command line: a level-2 store beside phase 10's level-3 store;
    ``--train_multiscale --levels 2,3`` warm-started from phase 10's
    classifier in the default resize mode (augment launches counted, 2 a
    step), then once in crop mode; ``--predict_slide <dir> --multiscale
    --run_evaluation`` from the trained artifact (2a launches counted) and
    ``--cascade`` when a margin shipped; one bf16 card step against a
    float32 CPU step; ``--qat --epochs 1`` and ``--predict_slide --int8``
    from its artifact (int8 launches counted), the QAT graph against the
    artifact's int8 forward; warm step times and peak memory."""
    import shutil

    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.cli import (
        main as cli_module,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        DataConfig,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
        augment_batch,
        sample_augment_params,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
        BatchIterator,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.multiscale import (
        MultiscaleDataset,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation.calibration import (
        COMBINE_MODES,
        decode_combine,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        hierarchical_from_state_dict,
        split_calibration,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quant_artifact import (
        CLASSIFIER_ARTIFACT,
        load_quantized,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quantized import (
        quant_forward,
        quantized_to,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.augment import (
        augment_batch_kernel,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.preprocess import (
        fused_normalize,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
        load_model,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.losses import (
        class_weights_inv_min,
        weighted_cross_entropy,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.multiscale_trainer import (
        make_multiscale_train_step,
        multiscale_loss,
        train_epoch,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.qat import (
        qat_forward,
        trainable_folded,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.simclr_trainer import (
        to_device,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
        create_train_state,
    )

    data_dir, models_dir = train["data_dir"], train["models_dir"]
    data = DataConfig(data_dir=data_dir)
    t0 = time.perf_counter()
    m2 = ms_level2_store(slide, grid, tissue, labels, data.patches_dir)
    msds = MultiscaleDataset({MS_LEVELS[0]: m2, LEVEL: ds.manifest},
                             resize_to=224, input_mode="resize")
    train_idx, val_idx = msds.split_by_slide(data.val_fraction,
                                             data.split_seed)
    steps = MS_TRAIN_EPOCHS * -(-len(train_idx) // BATCH)
    s = len(MS_LEVELS)
    log(f"[ms-train] level-2 store of {len(m2)} cells at 448² "
        f"({os.path.getsize(m2[0].path) / 1e9:.2f} GB) beside phase 10's "
        f"level-3 store in {time.perf_counter() - t0:.1f} s; {len(msds)} "
        f"aligned cells ({int(msds.labels.sum())} tumor), {len(train_idx)} "
        f"train / {len(val_idx)} val (one slide: an 80/20 cell split)")
    if len(msds) != len(tissue):
        raise AssertionError("the two levels' stores do not align")

    # --train_multiscale, resize mode, warm-started from phase 10's classifier
    common = ["--data_dir", data_dir, "--device", "cuda"]
    argv = ["--train_multiscale", "--levels", ",".join(map(str, MS_LEVELS)),
            "--epochs", str(MS_TRAIN_EPOCHS), "--batch_size", str(BATCH),
            "--models_dir", models_dir, *common]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # counts from here on are the multiscale training path's
    with _Messages("train.multiscale") as records:
        rc, wall = run_cli(argv)
    aug_launches = augment_batch_kernel.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [r.args[2] for r in records
              if r.msg.startswith("multiscale epoch")]
    warm = [r for r in records if r.msg.startswith("warm-started")]
    sd_ms = load_model(os.path.join(models_dir, "hierarchical_classifier"))
    state_ms, cal = split_calibration(sd_ms)
    log(f"[ms-train] --train_multiscale --epochs {MS_TRAIN_EPOCHS} --batch_size "
        f"{BATCH}: exit {rc} in {wall:.2f} s (cold); {steps} steps, augment "
        f"launches {aug_launches}; warm-started {len(warm) == 1}; epoch losses "
        f"{losses}; peak device memory {peak:.2f} GiB; calibration {cal}")
    if rc != 0:
        raise AssertionError(f"--train_multiscale failed with exit code {rc}")
    if aug_launches != s * steps:
        raise AssertionError(f"expected {s * steps} augment launches on the "
                             f"multiscale training path, counted "
                             f"{aug_launches}")
    want = {"temperature", "aux_temperature", "ensemble_weight",
            "ensemble_base_weight", "combine", "input_mode"}
    if (len(losses) != MS_TRAIN_EPOCHS or not np.isfinite(losses).all()
            or len(warm) != 1 or not want <= set(cal)
            or decode_combine(cal["combine"]) not in COMBINE_MODES
            or cal["input_mode"] != 0.0
            or not all(np.isfinite(v) for v in cal.values())):
        raise AssertionError("--train_multiscale: losses, warm start or the "
                             "artifact's calibration are wrong")
    hierarchical_from_state_dict(state_ms, MS_LEVELS)  # strict: every tensor

    # once more in crop mode, into its own models dir (same warm start)
    crop_models = os.path.join(os.path.dirname(models_dir), "ms_crop_models")
    os.makedirs(crop_models)
    shutil.copy(os.path.join(models_dir, "resnet18_patch_classifier.pt"),
                crop_models)
    rc, crop_wall = run_cli(["--train_multiscale", "--ms_input", "crop",
                             "--epochs", "1", "--batch_size", str(BATCH),
                             "--models_dir", crop_models, *common])
    _, crop_cal = split_calibration(load_model(os.path.join(
        crop_models, "hierarchical_classifier")))
    log(f"[ms-train] --train_multiscale --ms_input crop --epochs 1: exit {rc} "
        f"in {crop_wall:.2f} s; input_mode {crop_cal.get('input_mode')}")
    if rc != 0 or crop_cal.get("input_mode") != 1.0:
        raise AssertionError("--ms_input crop did not record input_mode 1")

    # the trained artifact serves --predict_slide <dir> --multiscale
    img_dir = os.path.join(data_dir, "train", "img")
    n_batches = -(-len(tissue) // MS_BATCH)
    predict = ["--predict_slide", img_dir, "--multiscale", "--stride",
               str(STRIDE), "--batch_size", str(MS_BATCH), "--models_dir",
               models_dir, *common]
    reset_counts()  # counts from here on are the trained artifact's path
    with _Messages("evaluation.froc") as records:
        rc, pred_wall = run_cli([*predict, "--run_evaluation"])
    ms_launches = fused_normalize.launches
    scores = [r.args[0] for r in records if r.msg.startswith("FROC score")]
    log(f"[ms-train] --predict_slide <dir> --multiscale --run_evaluation from "
        f"the trained artifact (combine {decode_combine(cal['combine'])}): "
        f"exit {rc} in {pred_wall:.2f} s; fused_normalize launches "
        f"{ms_launches}; FROC score {scores}")
    if (rc != 0 or ms_launches != s * n_batches or len(scores) != 1
            or not 0.0 <= scores[0] <= 1.0):
        raise AssertionError("--predict_slide --multiscale from the trained "
                             "artifact failed, launched 2a other than 2 a "
                             "batch, or gave no FROC score in [0, 1]")
    if "cascade_margin" in cal:
        with _Messages("torch.infer.multiscale") as records:
            rc, casc_wall = run_cli([*predict, "--cascade"])
        text = [r.getMessage() for r in records
                if r.getMessage().startswith("cascade")]
        log(f"[ms-train] --cascade (auto, margin {cal['cascade_margin']:.4f}, "
            f"val screen rate {cal.get('cascade_val_screen_rate')}): exit {rc} "
            f"in {casc_wall:.2f} s; {text}")
        if rc != 0 or not text:
            raise AssertionError("--cascade from the trained artifact failed")
    else:
        log("[ms-train] no cascade_margin shipped (the base-level screen was "
            "uninformative on validation): --cascade auto would run the full "
            "fused pass")

    # one bf16 card step against a float32 CPU step: same weights, cells,
    # augmentation draws and class weights
    imgs, lab = msds.read_batch(range(REF_BATCH))
    cw = class_weights_inv_min(msds.labels[train_idx], 2)
    params = sample_augment_params(torch.Generator().manual_seed(SEED),
                                   REF_BATCH)
    out = {}
    for where in ("cuda", "cpu"):
        d = torch.device(where)
        model = hierarchical_from_state_dict(state_ms, MS_LEVELS).to(
            d, memory_format=torch.channels_last).train()
        p = {k: v.to(d) for k, v in params.items()}
        batch = {lvl: (augment_batch_kernel(p, torch.from_numpy(x).to(d))
                       if where == "cuda"
                       else augment_batch(p, torch.from_numpy(x)))
                 for lvl, x in imgs.items()}
        loss, _ = multiscale_loss(model, batch, torch.from_numpy(lab).long().to(d),
                                  torch.from_numpy(cw).to(d),
                                  torch.ones(REF_BATCH, device=d), 0.5)
        loss.backward()
        out[where] = (loss.item(), {k: q.grad.detach().float().cpu()
                                    for k, q in model.named_parameters()})
    d_loss = abs(out["cuda"][0] - out["cpu"][0])
    d_grad = {k: (out["cuda"][1][k] - g).abs().max().item() / g.abs().max().item()
              for k, g in out["cpu"][1].items() if g.abs().max() > 0}
    head = max(d_grad[k] for k in ("head_out.weight", "head_out.bias",
                                   "aux_head.weight", "aux_head.bias"))
    log(f"[ms-train-check] {REF_BATCH} cells × {s} levels: bf16 card loss "
        f"{out['cuda'][0]:.6f}, float32 CPU loss {out['cpu'][0]:.6f} (|Δ| "
        f"{d_loss:.3g}, bound {TRAIN_LOSS_ATOL}); head grads max|Δ|/max|g| "
        f"{head:.3g} (bound {TRAIN_GRAD_RTOL}); all tensors: median "
        f"{np.median(list(d_grad.values())):.3g}, max {max(d_grad.values()):.3g}")
    if not (np.isfinite(out["cuda"][0]) and np.isfinite(out["cpu"][0])):
        raise AssertionError("non-finite multiscale loss")
    if d_loss > TRAIN_LOSS_ATOL or head > TRAIN_GRAD_RTOL:
        raise AssertionError("bf16 multiscale card step outside its bound of "
                             "the float32 CPU step")

    # warm steps of the path's step function on the path's batches
    state = create_train_state(hierarchical_from_state_dict(state_ms,
                                                            MS_LEVELS),
                               1e-4, dev)
    step = make_multiscale_train_step(cw)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batches = []
    for i, (x, t, v) in enumerate(msds.batches(BATCH, seed=SEED,
                                               indices=train_idx)):
        if i == 2:
            break
        batches.append(({lvl: to_device(a, dev) for lvl, a in x.items()},
                        to_device(t.astype(np.int64), dev), to_device(v, dev)))
    step_ms = []
    torch.cuda.reset_peak_memory_stats()
    for k in range(MS_TRAIN_TIMED_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, gen, *batches[k % len(batches)])
        torch.cuda.synchronize()
        if k:  # the first is a warm-up
            step_ms.append((time.perf_counter() - t0) * 1e3)
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    q1, med, q3 = quartiles(step_ms)
    log(f"[ms-train] warm step (batch on the card, synchronized): median "
        f"{med:.2f} ms (quartiles {q1:.2f}–{q3:.2f}, {len(step_ms)} steps) = "
        f"{BATCH / med * 1e3:.0f} cells/s ({s * BATCH} images a trunk call); "
        f"peak device memory {step_peak:.2f} GiB")
    del batches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ep = train_epoch(state, step, gen, msds, BATCH, SEED, train_idx, dev)
    torch.cuda.synchronize()
    epoch_ms = (time.perf_counter() - t0) * 1e3
    log(f"[ms-train] one warm epoch as train_epoch runs it ({ep['steps']} "
        f"steps, store reads and the 448² box mean included): {epoch_ms:.1f} "
        f"ms = {epoch_ms / ep['steps']:.1f} ms/step = "
        f"{len(train_idx) / epoch_ms * 1e3:.0f} cells/s")

    # --qat --epochs 1 from phase 10's classifier, its result kept
    captured = {}
    real_qat = cli_module.qat_finetune

    def keep(*a, **kw):
        captured["out"] = real_qat(*a, **kw)
        return captured["out"]

    cli_module.qat_finetune = keep
    torch.cuda.reset_peak_memory_stats()
    try:
        with _Messages("train.qat") as records:
            rc, qat_wall = run_cli(["--qat", "--epochs", "1", "--patch_level",
                                    str(LEVEL), "--batch_size", str(BATCH),
                                    "--models_dir", models_dir, *common])
    finally:
        cli_module.qat_finetune = real_qat
    qat_peak = torch.cuda.max_memory_allocated() / 2**30
    qat_path = os.path.join(models_dir, CLASSIFIER_ARTIFACT)
    history = captured.get("out", {}).get("history")
    log(f"[qat] --qat --epochs 1 --batch_size {BATCH}: exit {rc} in "
        f"{qat_wall:.2f} s (cold); history {history}; peak device memory "
        f"{qat_peak:.2f} GiB; artifact {os.path.basename(qat_path)} "
        f"{os.path.exists(qat_path)}")
    if (rc != 0 or not os.path.exists(qat_path) or not history
            or not np.isfinite(history[0]["loss"])):
        raise AssertionError("--qat failed or wrote no artifact")
    int8_batches = -(-len(tissue) // BATCH)
    stage1, conv, pool = int8_launchers()
    reset_counts()  # counts from here on are the QAT artifact's int8 path
    with _Messages("models.quant_artifact") as records:
        rc, int8_wall = run_cli(["--predict_slide",
                                 os.path.join(img_dir, "smoke_slide.wsi.npz"),
                                 "--int8", "--stride", str(STRIDE),
                                 "--batch_size", str(BATCH), "--models_dir",
                                 models_dir, *common])
    qat_launches = (stage1.launches, conv.launches, pool.launches)
    used = any("using persisted" in r.getMessage() for r in records)
    log(f"[qat] --predict_slide --int8 from the QAT artifact: exit {rc} in "
        f"{int8_wall:.2f} s; artifact picked up {used}; launches "
        f"fused_stage1_int8 {qat_launches[0]}, int8_conv_requant "
        f"{qat_launches[1]}, int8_maxpool {qat_launches[2]} over "
        f"{int8_batches} batches")
    if rc != 0 or not used:
        raise AssertionError("--predict_slide --int8 did not run from the QAT "
                             "artifact")
    if qat_launches != (int8_batches, 16 * int8_batches, int8_batches):
        raise AssertionError(f"expected {int8_batches}, {16 * int8_batches} "
                             f"and {int8_batches} int8 launches, counted "
                             f"{qat_launches}")
    # the QAT graph (float32, TF32 off) against the artifact's int8 forward
    tree = quantized_to(load_quantized(qat_path), dev)
    fp = trainable_folded(captured["out"]["folded"], dev)
    x_ref = torch.from_numpy(ref_u8).to(dev)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
        l8 = quant_forward(tree, x_ref, with_fc=True).float()
        lq = qat_forward(fp, tree["ascales"], x_ref)
    cos = torch.nn.functional.cosine_similarity(l8.flatten(), lq.flatten(),
                                                dim=0).item()
    rel = ((l8 - lq).abs().max() / l8.abs().max()).item()
    log(f"[qat] {len(ref_u8)} reference cells: qat_forward against the "
        f"artifact's quant_forward, logit cosine {cos:.5f} (bound "
        f"{QAT_COSINE_MIN}), max|Δ|/max|logit| {rel:.4f}")
    if not cos > QAT_COSINE_MIN:
        raise AssertionError("the QAT graph strays from the int8 forward of "
                             "its artifact")
    # warm QAT steps (float32, TF32 off) at the path's batch
    asc = {k: v.to(dev) for k, v in captured["out"]["ascales"].items()}
    opt = torch.optim.Adam([t for v in fp.values() for t in v.values()],
                           lr=1e-5, fused=True)
    cw3 = torch.as_tensor(class_weights_inv_min(ds.labels, 2)).to(dev)
    qb = []
    for i, (x, t, v) in enumerate(BatchIterator(ds, BATCH, seed=SEED)):
        if i == 2:
            break
        qb.append((to_device(x, dev), to_device(t.astype(np.int64), dev),
                   to_device(v, dev)))
    qat_ms = []
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for k in range(QAT_TIMED_STEPS + 1):
            x, t, v = qb[k % len(qb)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = weighted_cross_entropy(qat_forward(fp, asc, x), t, cw3, v)
            loss.backward()
            opt.step()
            torch.cuda.synchronize()
            if k:
                qat_ms.append((time.perf_counter() - t0) * 1e3)
    q1, qmed, q3 = quartiles(qat_ms)
    log(f"[qat] warm QAT step (float32, TF32 off, batch on the card): median "
        f"{qmed:.2f} ms (quartiles {q1:.2f}–{q3:.2f}, {len(qat_ms)} steps) = "
        f"{BATCH / qmed * 1e3:.0f} patches/s")
    del qb, fp, opt, tree
    return {"aug_launches": aug_launches, "ms_launches": ms_launches,
            "qat_launches": qat_launches,
            "profile": (state, step, gen, msds, train_idx)}


def phase_ms_train_profile(dev, state, step, gen, msds, train_idx) -> None:
    """One warm multiscale epoch under the profiler: the device's idle
    share (last in the run: walls taken after a profiler session run
    long)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.multiscale_trainer import (
        train_epoch,
    )

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ep = train_epoch(state, step, gen, msds, BATCH, SEED + 1, train_idx,
                         dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = busy_us(prof) / 1e3

    def device_ms(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0)) / 1e3

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(kernels, key=device_ms, reverse=True)[:12]
    log(f"[ms-train] warm epoch under the profiler ({ep['steps']} steps, "
        f"store reads and the box mean included): {wall_ms:.1f} ms = "
        f"{len(train_idx) / wall_ms * 1e3:.0f} cells/s; device busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}; device time by "
        f"kernel (ms, launches): "
        + "; ".join(f"{e.key[:50]} {device_ms(e):.2f} ({e.count})"
                    for e in top))
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")


# ---------------------------------------------------------------------------
# phase 13: patch extraction on the card
# ---------------------------------------------------------------------------

NORMAL_W, NORMAL_H = 3584, 2688  # the annotation-free slide that is mined
ANNOTATION_VERTICES = 1024  # CAMELYON16 outlines run to hundreds or thousands
EXTRACT_LEVELS = (0, 1, 2, 3)
# Macenko on the card against the port's CPU Macenko on the same patches:
# the tolerance of tests/test_torch_port_stain.py (every byte within 1, at
# most 10 % of the bytes differing)
STAIN_MAX_DIFF, STAIN_MAX_SHARE = 1, 0.10


def annotation_polygon(seed: int, n: int = ANNOTATION_VERTICES):
    """A seeded smooth outline of ``n`` vertices as fractions of the slide:
    a circle of radius 0.12 (of the height) around (0.32, 0.6), its radius
    modulated by five low harmonics, as traced annotations are smooth."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(n) * 2 * np.pi / n
    r = np.ones(n)
    for k in range(2, 7):
        r += rng.uniform(0.03, 0.12) / (k / 2) * np.cos(
            k * t + rng.uniform(0, 2 * np.pi))
    xs = 0.32 + 0.12 * r * np.cos(t) * SLIDE_H / SLIDE_W
    ys = 0.6 + 0.12 * r * np.sin(t)
    return np.stack([xs * SLIDE_W, ys * SLIDE_H], axis=1)


def extract_root(spec, slide, tmp):
    """The data root of phase 13, written by the port: ``tumor_001`` (the
    smoke slide; its XML carries the spec's tumor polygon and a seeded
    1,024-vertex one) and the annotation-free ``normal_001``. Returns the
    root and the XML's polygons. ``tumor_001``'s pyramid is the rendered
    smoke slide's (what ``write_synthetic_case`` of the spec writes, without
    rendering it again)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.annotations import (
        parse_annotation_xml,
        write_annotation_xml,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
        save_npz_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.synthetic import (
        SyntheticSlideSpec,
        polygons_level0,
        write_synthetic_case,
    )

    root = os.path.join(tmp, "extract_src")
    img_dir = os.path.join(root, "train", "img")
    os.makedirs(img_dir)
    save_npz_slide(os.path.join(img_dir, "tumor_001.wsi.npz"),
                   [slide.level_array(i) for i in range(slide.level_count)])
    write_synthetic_case(root, "normal_001", SyntheticSlideSpec(
        width=NORMAL_W, height=NORMAL_H, tissue_radii=(0.45, 0.45), seed=2))
    xml = os.path.join(root, "annotations", "tumor_001.xml")
    write_annotation_xml(xml, polygons_level0(spec) + [annotation_polygon(SEED)])
    polys = parse_annotation_xml(xml)
    if [len(p) for p in polys] != [len(spec.tumor_polygons[0]),
                                   ANNOTATION_VERTICES]:
        raise AssertionError("the annotation XML does not read back")
    return root, polys


def grid_cells(width: int, height: int, level: int) -> int:
    """Cells of a level's grid at stride = patch size."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        PATCH_SIZES,
    )

    ps = PATCH_SIZES[level]
    return -(-width // ps) * -(-height // ps)


def fresh_root(src, dst):
    """A data root with ``src``'s slides (hard links) and annotations, and
    no patches."""
    import shutil

    shutil.copytree(os.path.join(src, "train"), os.path.join(dst, "train"),
                    copy_function=os.link)
    shutil.copytree(os.path.join(src, "annotations"),
                    os.path.join(dst, "annotations"))
    return dst


def store_rows(root, level):
    """(rows (slide, x, y, label) in order, the records) of a level's
    manifest: numpy on the card (no pyarrow), else parquet."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
        load_level_manifest,
    )

    m = load_level_manifest(os.path.join(root, "patches"), level)
    return [(r.slide, r.x, r.y, r.label) for r in m], m


def pack_bytes(records) -> dict:
    return {r.slide: open(r.path, "rb").read() for r in records}


def level_walls(records) -> dict:
    """{(slide, level): s} from the extractor's per-slide timer lines."""
    import re

    out = {}
    for r in records:
        m = re.match(r"extract\[(\S+) L(\d)\] took ([0-9.]+)s", r.getMessage())
        if m:
            out[(m.group(1), int(m.group(2)))] = float(m.group(3))
    return out


def label_disagreements(root, polys, base_dims, level, host_rows, dev_rows,
                        dev) -> list:
    """Rows whose host and device labels differ, each checked to be a cell
    where the two rasterizers' masks disagree: the host route's numpy fill
    (the PIL stand-in of ``grid/rasterize.py``) and the device route's copy
    of the reference's device rasterizer, which marks no pixel on a row no
    edge crosses (a polygon's bottom tip, for one)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.pyramid import (
        PatchGrid,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.rasterize import (
        pad_polygons,
        polygons_to_mask_band,
        polygons_to_mask_device,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
        open_slide,
    )

    differ = [(h, d) for h, d in zip(host_rows, dev_rows) if h != d]
    if not differ:
        return []
    slide = open_slide(os.path.join(root, "train", "img", "tumor_001.wsi.npz"))
    dims = slide.level_dimensions[level]
    grid = PatchGrid.for_slide_level(level, dims, slide.level_downsamples[level])
    slide.close()
    ps = grid.patch_size
    verts, valid = pad_polygons(polys)
    device_mask = polygons_to_mask_device(verts, valid, dims, base_dims,
                                          device=dev).cpu().numpy()
    out = []
    for (slide_name, x, y, host_label), (_, _, _, dev_label) in differ:
        if slide_name != "tumor_001":
            raise AssertionError(f"labels differ on {slide_name}, which has "
                                 "no annotation")
        band = polygons_to_mask_band(polys, dims, base_dims, x0=0, y0=y,
                                     band_w=dims[0], band_h=min(ps, dims[1] - y))
        host_px = int((band[:, x:x + ps] > 0).sum())
        dev_px = int((device_mask[y:y + ps, x:x + ps] > 0).sum())
        if (host_px > 0) != bool(host_label) or (dev_px > 0) != bool(dev_label):
            raise AssertionError(f"level {level} cell ({x}, {y}): labels "
                                 f"{host_label}/{dev_label} do not follow the "
                                 f"masks ({host_px}/{dev_px} pixels)")
        out.append((x, y, host_label, dev_label, host_px, dev_px))
    return out


def device_pieces(root, polys, dev) -> dict:
    """Per level of ``tumor_001``: the device program's pieces timed apart
    by CUDA events (median of 3: upload, means, rasterize, labels, gather)
    and the peak device memory of one extraction."""
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.streamed import (
        cell_view,
        extract_patches_on_device,
        tissue_keep,
        upload_padded_plane,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.labeling import (
        patch_labels_from_mask,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.pyramid import (
        PatchGrid,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.rasterize import (
        pad_polygons,
        polygons_to_mask_device,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
        open_slide,
    )

    slide = open_slide(os.path.join(root, "train", "img", "tumor_001.wsi.npz"))
    base = slide.level_dimensions[0]
    verts, valid = pad_polygons(polys)
    out = {}
    for level in EXTRACT_LEVELS:
        plane_np = slide.level_array(level)
        grid = PatchGrid.for_slide_level(level, slide.level_dimensions[level],
                                         slide.level_downsamples[level])
        ps = grid.patch_size
        gh, gw = grid.padded_height // ps, grid.padded_width // ps
        plane = upload_padded_plane(plane_np, grid, dev)
        mask = torch.zeros((grid.padded_height, grid.padded_width),
                           dtype=torch.uint8, device=dev)
        holder = {}

        def rasterize():
            holder["m"] = polygons_to_mask_device(
                verts, valid, (grid.width, grid.height), base, device=dev)

        def labels():
            mask[:grid.height, :grid.width] = holder["m"]
            holder["l"] = patch_labels_from_mask(mask, ps).T.reshape(-1)

        keep = tissue_keep(plane, ps, 240.0)
        sel = torch.nonzero(keep).flatten()
        ix, iy = sel // gh, sel % gh
        pieces = {
            "upload": lambda: upload_padded_plane(plane_np, grid, dev),
            "means": lambda: tissue_keep(plane, ps, 240.0),
            "rasterize": rasterize,
            "labels": labels,
            "gather": lambda: cell_view(plane, ps)[iy, :, ix],
        }
        ms = {k: statistics.median(cuda_ms(fn, 3)) for k, fn in pieces.items()}
        del plane, mask, holder
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        extract_patches_on_device(plane_np, grid, polys, base, device=dev)
        torch.cuda.synchronize()
        ms["peak_gib"] = (torch.cuda.max_memory_allocated() - before) / 2**30
        ms["cells"] = gh * gw
        ms["kept"] = int(sel.numel())
        ms["mask_mpx"] = grid.width * grid.height / 1e6
        out[level] = ms
    slide.close()
    return out


def phase_extract(dev, spec, slide, grid3, tissue, tmp) -> dict:
    """Phase 13: ``--patch`` on the card through the CLI's ``main`` in this
    process (see the module docstring)."""
    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
        load_level_manifest,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.patch_store import (
        PatchReader,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.stain import (
        macenko_normalize_batch,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.streamed import (
        extract_patches_on_device,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.augment import (
        augment_batch_kernel,
    )

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    src, polys = extract_root(spec, slide, tmp)
    base = (SLIDE_W, SLIDE_H)
    log(f"[extract] data root: tumor_001 {SLIDE_W}×{SLIDE_H} (XML: "
        f"{len(polys[0])} + {len(polys[1])} vertices), normal_001 "
        f"{NORMAL_W}×{NORMAL_H}, written in {time.perf_counter() - t0:.1f} s")

    # 1. --patch --patch_level all, host route, then the device route
    roots, walls, calls = {}, {}, {}
    for route in ("host", "device"):
        roots[route] = fresh_root(src, os.path.join(tmp, f"extract_{route}"))
        torch.cuda.reset_peak_memory_stats()
        before = extract_patches_on_device.calls
        with _Messages("data.extract") as records:
            rc, wall = run_cli(["--patch", "--patch_level", "all",
                                "--extract_impl", route, "--data_dir",
                                roots[route], "--device", "cuda"])
        if rc != 0:
            raise AssertionError(f"--patch --extract_impl {route}: exit {rc}")
        calls[route] = extract_patches_on_device.calls - before
        walls[route] = level_walls(records)
        fell_back = [r.getMessage() for r in records
                     if "exceeds the device budget" in r.getMessage()]
        log(f"[extract] --patch --patch_level all --extract_impl {route}: "
            f"exit 0 in {wall:.2f} s; device extractions {calls[route]}; "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if fell_back:
            raise AssertionError(f"a level fell back to the host: {fell_back}")
    want_calls = 2 * len(EXTRACT_LEVELS)
    if calls["device"] != want_calls or calls["host"] != 0:
        raise AssertionError(f"device extractions {calls}, expected "
                             f"{want_calls} on the device route, 0 on host")
    disagree = {}
    for level in EXTRACT_LEVELS:
        host_rows, host_recs = store_rows(roots["host"], level)
        dev_rows, dev_recs = store_rows(roots["device"], level)
        if [r[:3] for r in host_rows] != [r[:3] for r in dev_rows]:
            raise AssertionError(f"level {level}: host and device kept other "
                                 "cells")
        if pack_bytes(host_recs) != pack_bytes(dev_recs):
            raise AssertionError(f"level {level}: stored bytes differ")
        disagree[level] = label_disagreements(roots["host"], polys, base, level,
                                              host_rows, dev_rows, dev)
        tumor = sum(r[3] for r in host_rows)
        cells = sum(grid_cells(w >> level, h >> level, level)
                    for w, h in ((SLIDE_W, SLIDE_H), (NORMAL_W, NORMAL_H)))
        per_route = []
        for route in ("host", "device"):
            w = sum(v for (_s, lv), v in walls[route].items() if lv == level)
            per_route.append(f"{route} {w:.3f} s = {cells / w:.1f} cells/s")
        log(f"[extract] level {level}: {len(host_rows)} rows ({tumor} tumor "
            f"on the host route) equal in both stores, bytes equal; labels "
            f"differ on {len(disagree[level])} cell(s) where the rasterizers "
            f"disagree {disagree[level]}; walls (both slides) "
            + ", ".join(per_route))
    pieces = device_pieces(src, polys, dev)
    for level, p in pieces.items():
        log(f"[extract] device program, tumor_001 level {level} ({p['cells']} "
            f"cells, {p['kept']} kept, a {p['mask_mpx']:.1f}-megapixel mask): "
            f"upload {p['upload']:.2f} ms, means {p['means']:.3f} ms, "
            f"rasterize {p['rasterize']:.2f} ms, labels {p['labels']:.3f} ms, "
            f"gather {p['gather']:.2f} ms; peak {p['peak_gib']:.3f} GiB")

    # 2. level 3 at stride 28 on the host route: the smoke's grid
    root28 = fresh_root(src, os.path.join(tmp, "extract_28"))
    rc, wall = run_cli(["--patch", "--patch_level", "3", "--stride",
                        str(STRIDE), "--data_dir", root28, "--device", "cuda"])
    rows28, recs28 = store_rows(root28, LEVEL)
    tumor28 = [(x, y) for s, x, y, _ in rows28 if s == "tumor_001"]
    want_xy = [(int(ix) * STRIDE, int(iy) * STRIDE) for iy, ix in tissue]
    labels28 = np.array([lab for s, _, _, lab in rows28 if s == "tumor_001"])
    want_labels = tumor_labels(spec, slide, grid3, tissue, polygons=polys)
    if rc != 0 or tumor28 != want_xy:
        raise AssertionError(f"--stride {STRIDE}: exit {rc}, {len(tumor28)} "
                             f"kept cells against the smoke's {len(want_xy)}")
    if not np.array_equal(labels28, want_labels):
        raise AssertionError("--stride 28 labels differ from the host mask's")
    reader = PatchReader(load_level_manifest(os.path.join(root28, "patches"),
                                             LEVEL))
    idx = [i for i, r in enumerate(reader.manifest) if r.slide == "tumor_001"]
    pick = np.random.default_rng(SEED).choice(len(idx), 64, replace=False)
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
        open_slide,
    )

    stored = open_slide(os.path.join(root28, "train", "img",
                                     "tumor_001.wsi.npz"))
    for k in pick:
        iy, ix = tissue[k]
        if not np.array_equal(reader.read(idx[k]),
                              read_cell(stored, grid3, iy, ix)):
            raise AssertionError("a stored patch differs from its region read")
    stored.close()
    log(f"[extract] --patch_level 3 --stride {STRIDE}: exit 0 in {wall:.2f} s "
        f"({grid3.num_patches / wall:.0f} cells/s of tumor_001's grid); "
        f"{len(tumor28)} kept cells = the smoke's partition, "
        f"{int(labels28.sum())} tumor = the XML's host mask; 64 sampled "
        f"patches equal their region reads")

    # 3. --stain_norm at level 3 against the port's CPU Macenko
    root_sn = fresh_root(src, os.path.join(tmp, "extract_stain"))
    rc, wall = run_cli(["--patch", "--patch_level", "3", "--stain_norm",
                        "--data_dir", root_sn, "--device", "cuda"])
    sn_rows, sn_recs = store_rows(root_sn, LEVEL)
    plain_rows, plain_recs = store_rows(roots["host"], LEVEL)
    if rc != 0 or sn_rows != plain_rows:
        raise AssertionError(f"--stain_norm: exit {rc}, rows unlike --patch's")
    stored = PatchReader(sn_recs).read_batch(range(len(sn_recs)))
    plain = PatchReader(plain_recs).read_batch(range(len(plain_recs)))
    # near-white cells beside them: a light one with a 40² tissue corner
    # (under 5 % tissue: kept by the filter, passed through) and a white one
    light = np.stack([np.full_like(plain[0], v) for v in (232, 255)])
    light[0, :40, :40] = plain[0, :40, :40]
    probe = np.concatenate([plain, light])
    batch = torch.from_numpy(probe).to(dev)
    card = macenko_normalize_batch(batch).cpu().numpy()
    cpu = macenko_normalize_batch(torch.from_numpy(probe)).numpy()
    diff = np.abs(card.astype(np.int16) - cpu)
    share = float((diff > 0).mean())
    sn_ms = statistics.median(cuda_ms(lambda: macenko_normalize_batch(batch),
                                      5))
    log(f"[extract] --stain_norm level 3: exit 0 in {wall:.2f} s; "
        f"{len(stored)} stored patches equal to one card call on them; card "
        f"against the CPU on those and 2 near-white ones: max |Δ| "
        f"{int(diff.max())}, {share:.2e} of bytes differ; Macenko on the card "
        f"{sn_ms:.2f} ms a batch of {len(probe)} ({sn_ms / len(probe):.3f} ms "
        f"a patch)")
    if not np.array_equal(stored, card[:len(stored)]):
        raise AssertionError("the stored patches differ from a card call")
    if diff.max() > STAIN_MAX_DIFF or share > STAIN_MAX_SHARE:
        raise AssertionError("Macenko on the card outside the CPU tolerance")
    if not (np.array_equal(card[-2:], light) and np.array_equal(cpu[-2:], light)):
        raise AssertionError("near-white patches were not passed through")

    # 4. --patch --train (streamed) at level 3, stride 28
    root_tr = fresh_root(src, os.path.join(tmp, "extract_train"))
    models = os.path.join(tmp, "extract_models")
    reset_counts()
    with _Messages("train.streaming") as records:
        rc, wall = run_cli(["--patch", "--train", "--patch_level", "3",
                            "--stride", str(STRIDE), "--epochs", "2",
                            "--data_dir", root_tr, "--models_dir", models,
                            "--device", "cuda"])
    aug_launches = augment_batch_kernel.launches
    tr_rows, _ = store_rows(root_tr, LEVEL)
    epoch0 = [r.args for r in records if r.msg.startswith("streamed epoch 0")]
    timer = [r.getMessage() for r in records
             if r.getMessage().startswith("streamed epoch 0 (")]
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
        slide_level_split,
    )

    train_slides, _val = slide_level_split(["normal_001", "tumor_001"], 0.2, 42)
    n_train = sum(r[0] in train_slides for r in tr_rows)
    want_launches = 2 * -(-n_train // BATCH)
    if rc != 0 or tr_rows != rows28 or not epoch0:
        raise AssertionError(f"--patch --train: exit {rc}, store rows equal "
                             f"to --stride 28's: {tr_rows == rows28}")
    if epoch0[0][2] != n_train or aug_launches != want_launches:
        raise AssertionError(f"streamed epoch saw {epoch0[0][2]} patches of "
                             f"{n_train}; augment launches {aug_launches}, "
                             f"expected {want_launches}")
    log(f"[extract] --patch --train --patch_level 3 --stride {STRIDE} "
        f"--epochs 2: exit 0 in {wall:.2f} s; {timer[0] if timer else ''}; "
        f"epoch 0 saw {epoch0[0][2]} patches = the training split "
        f"{train_slides}, loss {epoch0[0][0]:.4f}; store equal to --stride "
        f"{STRIDE}'s; augment launches {aug_launches}")

    # 5. --mine_hard_negatives from step 4's artifact
    mined = phase_mine(dev, root_tr, models)
    log(f"[extract] phase 13 wall {time.perf_counter() - t_phase:.1f} s")
    return {"aug_launches": aug_launches, "root": src, "mined": mined}


def phase_mine(dev, root, models) -> int:
    """``--mine_hard_negatives`` through the CLI's ``main``: the mined cells
    against the port's own ``predict_slide`` grid and region reads; a second
    call mines nothing."""
    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
        load_level_manifest,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.patch_store import (
        PatchReader,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
        predict_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
        open_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        resnet18_from_state_dict,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
        load_model,
    )

    patches = os.path.join(root, "patches")
    before = len(load_level_manifest(patches, LEVEL))
    argv = ["--mine_hard_negatives", "--data_dir", root, "--models_dir",
            models, "--device", "cuda"]
    rc, wall = run_cli(argv)
    after = load_level_manifest(patches, LEVEL)
    mined = [i for i, r in enumerate(after) if r.slide.endswith("__hardneg")]
    if rc != 0 or len(after) != before + len(mined):
        raise AssertionError(f"--mine_hard_negatives: exit {rc}")
    # the CLI's model: bfloat16 on the card
    model = resnet18_from_state_dict(load_model(os.path.join(
        models, "resnet18_patch_classifier"))).to(
        device=dev, dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32,
        memory_format=torch.channels_last)
    slide = open_slide(os.path.join(root, "train", "img", "normal_001.wsi.npz"))
    prob, grid = predict_slide(slide, model, level=LEVEL, device=dev)
    probs = [float(prob[after[i].y // grid.stride, after[i].x // grid.stride])
             for i in mined]
    want_n = min(256, int((prob >= 0.5).sum()))
    reader = PatchReader(after)
    for i in mined:
        r = after[i]
        if r.slide != "normal_001__hardneg" or r.label != 0:
            raise AssertionError(f"mined {r.slide} label {r.label}")
        ps = grid.patch_size
        region = slide.read_region(grid.level0_origin(r.x, r.y), LEVEL,
                                   (ps, ps))
        if not np.array_equal(reader.read(i), region):
            raise AssertionError("a mined patch differs from its region read")
    slide.close()
    if (len(mined) != want_n or any(p < 0.5 for p in probs)
            or probs != sorted(probs, reverse=True)):
        raise AssertionError(f"mined {len(mined)} cells (probabilities "
                             f"{probs}), the grid has {want_n} at 0.5 or more")
    rc2, wall2 = run_cli(argv)
    again = load_level_manifest(patches, LEVEL)
    if rc2 != 0 or len(again) != len(after):
        raise AssertionError("a second --mine_hard_negatives mined again")
    log(f"[extract] --mine_hard_negatives: exit 0 in {wall:.2f} s; mined "
        f"{len(mined)} cells of normal_001 (grid {prob.shape}, max probability "
        f"{float(prob.max()):.4f}; {want_n} at 0.5 or more), probabilities "
        f"{[round(p, 4) for p in probs]}, bytes equal to region reads; a "
        f"second call mined nothing ({wall2:.2f} s)")
    return len(mined)


def phase_extract_profile(dev, src, tmp) -> None:
    """The streamed epoch (``--patch --train --epochs 1`` at level 3, stride
    28, extraction included) under the profiler: the device's idle share.
    Last in the run: walls taken after a profiler session run long."""
    from torch.profiler import ProfilerActivity, profile

    root = fresh_root(src, os.path.join(tmp, "extract_profile"))
    argv = ["--patch", "--train", "--patch_level", "3", "--stride",
            str(STRIDE), "--epochs", "1", "--data_dir", root, "--models_dir",
            os.path.join(tmp, "extract_profile_models"), "--device", "cuda"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rc, wall = run_cli(argv)
    busy = busy_us(prof) / 1e3
    if rc != 0 or busy <= 0:
        raise AssertionError(f"profiled --patch --train: exit {rc}, device "
                             f"busy {busy} ms")
    log(f"[extract] --patch --train --epochs 1 under the profiler "
        f"(extraction of both slides and epoch 0): {wall * 1e3:.1f} ms, "
        f"device busy {busy:.1f} ms, idle share {1 - busy / (wall * 1e3):.3f}")


def phase_features(dev, ds, sd, tmp) -> dict:
    """``extract_features`` on the card over the packed store of the slide's
    tissue cells, the stem kernels' launches counted around each route."""
    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        Config,
        DataConfig,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.features import (
        extract_features,
        load_feature_artifacts,
        make_feature_step,
        run_feature_extraction,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        resnet18_from_state_dict,
        strip_head,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quantized import (
        fold_batchnorm,
        fold_resnet18_inference,
        folded_forward,
        folded_forward_inference,
        folded_to,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.fused_stem import (
        bias_relu_pool_kernel,
        fused_stem_kernel,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
        save_model,
    )

    models_dir = os.path.join(tmp, "feature_models")
    save_model(os.path.join(models_dir, "resnet18_patch_classifier"), sd)
    cfg = Config(data=DataConfig(data_dir=os.path.join(tmp, "feature_data")),
                 models_dir=models_dir)
    trunk = strip_head(sd)
    n, steps = len(ds), -(-len(ds) // BATCH)

    def counts():
        return {"bias_relu_pool": bias_relu_pool_kernel.launches,
                "fused_stem": fused_stem_kernel.launches}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # counts from here on are the default route's
    t0 = time.perf_counter()
    feats = extract_features(cfg, level=LEVEL, batch_size=BATCH, dataset=ds,
                             device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[features] extract_features: {n} cells, batch {BATCH}, {steps} "
        f"batches (the last {n - (steps - 1) * BATCH} real rows) in {wall:.2f} s"
        f" (cold: folds, first cuDNN calls, artifact writes); launches "
        f"{launches}; peak device memory {peak / 2**30:.2f} GiB")
    if launches != {"bias_relu_pool": steps, "fused_stem": 0}:
        raise AssertionError(f"expected {steps} bias_relu_pool launches on the "
                             f"default route, counted {launches}")
    disk, labels, names = load_feature_artifacts(cfg.data.features_dir, LEVEL)
    if (disk.shape != (n, 512) or disk.dtype != np.float32
            or not np.array_equal(disk, np.asarray(feats))
            or not np.isfinite(disk).all()):
        raise AssertionError("feature artifact is not the (N, 512) float32 "
                             "matrix the call returned")
    if (not np.array_equal(labels, ds.labels)
            or names != [rec.patch_name for rec in ds.manifest]):
        raise AssertionError("labels or names are not in manifest order")

    reset_counts()  # counts from here on are the space-to-depth route's
    feats_s2d, _, _ = run_feature_extraction(ds, trunk, BATCH, device=dev,
                                             stem_s2d=True)
    torch.cuda.synchronize()
    launches_s2d = counts()
    if launches_s2d != {"bias_relu_pool": 0, "fused_stem": steps}:
        raise AssertionError(f"expected {steps} fused_stem launches on the "
                             f"stem_s2d route, counted {launches_s2d}")
    d_routes = np.abs(disk - feats_s2d).max()

    # sampled cells: float32 CPU folded_forward, and the unfolded bf16 model
    idx = np.sort(np.random.default_rng(SEED).choice(n, FEAT_REF_CELLS,
                                                     replace=False))
    imgs, _ = ds.read_batch(idx)
    with torch.inference_mode():
        ref = folded_forward(fold_batchnorm(trunk), torch.from_numpy(imgs),
                             with_fc=False).numpy()
        unfolded = resnet18_from_state_dict(trunk).to(
            device=dev, dtype=torch.bfloat16, memory_format=torch.channels_last)
        plain = make_feature_step(unfolded)(torch.from_numpy(imgs).to(dev))
        plain = plain.cpu().numpy()
    spread = (ref.max(axis=0) - ref.min(axis=0)).max()
    d_ref = np.abs(disk[idx] - ref).max()
    d_ref_s2d = np.abs(feats_s2d[idx] - ref).max()
    d_plain = np.abs(disk[idx] - plain).max()
    log(f"[features] {FEAT_REF_CELLS} sampled cells: float32 CPU features up to "
        f"{ref.max():.4f}, largest spread of a feature over the cells "
        f"{spread:.4f} (must be ≥ {10 * FEAT_BF16_ATOL}); bf16 card max|Δ| "
        f"{d_ref:.4g} (default route; mean|Δ| "
        f"{np.abs(disk[idx] - ref).mean():.4g}), {d_ref_s2d:.4g} (stem_s2d), the "
        f"two routes over all {n} cells {d_routes:.4g} (bound {FEAT_BF16_ATOL}); "
        f"against the unfolded bf16 model {d_plain:.4g} (bound "
        f"{2 * FEAT_BF16_ATOL}); unfolded bf16 model against float32 CPU "
        f"{np.abs(plain - ref).max():.4g}")
    if spread < 10 * FEAT_BF16_ATOL:
        raise AssertionError("reference features spread too little to check "
                             "the bf16 forward")
    if (max(d_ref, d_ref_s2d, d_routes) > FEAT_BF16_ATOL
            or d_plain > 2 * FEAT_BF16_ATOL):
        raise AssertionError("bf16 features outside their bound")

    # warm device-only steps of both routes on one batch on the card
    x = torch.from_numpy(ds.read_batch(range(BATCH))[0]).to(dev)
    step_ms = {}
    with torch.inference_mode():
        fps = {s2d: folded_to(fold_resnet18_inference(
            trunk, (224, 224), stem_s2d=s2d, dtype=torch.bfloat16), dev)
            for s2d in (False, True)}
        model_step = make_feature_step(unfolded)
        fns = {"folded": lambda: folded_forward_inference(fps[False], x, False),
               "folded stem_s2d": lambda: folded_forward_inference(fps[True], x,
                                                                   False),
               "unfolded": lambda: model_step(x)}
        for fn in fns.values():
            cuda_ms(fn, 3)  # warm-up
        for _ in range(2):  # in turns
            for name, fn in fns.items():
                step_ms.setdefault(name, []).extend(
                    cuda_ms(fn, FEAT_TIMED_STEPS // 2))
    for name, ms in step_ms.items():
        q1, med, q3 = quartiles(ms)
        log(f"[features] warm {name} forward at B={BATCH} bf16 (batch on the "
            f"card): median {med:.3f} ms (quartiles {q1:.3f}–{q3:.3f}, "
            f"{len(ms)} steps) = {BATCH / med * 1e3:.0f} patches/s")
    return {"bias_relu_pool": launches["bias_relu_pool"],
            "fused_stem": launches_s2d["fused_stem"],
            "features": disk, "labels": labels}


def phase_features_profile(dev, ds, sd) -> None:
    """The loop as ``run_feature_extraction`` runs it, warm, under the
    profiler, both routes: the device's idle share. Last in the run: walls
    taken after a profiler session run long."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.features import (
        run_feature_extraction,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        strip_head,
    )

    trunk = strip_head(sd)
    n = len(ds)
    for s2d in (False, True):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_feature_extraction(ds, trunk, BATCH, device=dev, stem_s2d=s2d)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy = busy_us(prof) / 1e3
        log(f"[features] warm run_feature_extraction(stem_s2d={s2d}), folds and "
            f"packed-store reads included: {wall_ms:.1f} ms = "
            f"{n / wall_ms * 1e3:.0f} patches/s; device busy {busy:.1f} ms, "
            f"idle share {1 - busy / wall_ms:.3f}")


def phase_int8(dev, ds, sd, slide, host_margins, ref_cells, ref_u8, tmp) -> dict:
    """The int8 path: ``--quantize`` (calibrate once on the packed store's
    tissue, write the artifact), ``--predict_slide --int8`` from the artifact
    (in this process with the launches counted, then through the CLI), and
    ``run_feature_extraction(int8=True, qtree=…)``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        Config,
        DataConfig,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.features import (
        run_feature_extraction,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
        NON_TISSUE_MARGIN,
        predict_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
        save_npz_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        resnet18_from_state_dict,
        strip_head,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quant_artifact import (
        CLASSIFIER_ARTIFACT,
        artifact_input_hw,
        load_quantized,
        quantize_classifier_to_artifact,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quantized import (
        fold_batchnorm,
        folded_forward,
        quant_forward,
        quantized_to,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
        save_model,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    stage1, conv, pool = int8_launchers()
    counts = lambda: (stage1.launches, conv.launches, pool.launches)  # noqa: E731
    models_dir = os.path.join(tmp, "int8_models")
    save_model(os.path.join(models_dir, "resnet18_patch_classifier"), sd)
    cfg = Config(data=DataConfig(data_dir=os.path.join(tmp, "int8_data")),
                 models_dir=models_dir)

    # --quantize: the function behind the flag, on the in-memory manifest of
    # the packed store (a parquet manifest needs pyarrow)
    reset_counts()
    t0 = time.perf_counter()
    path = quantize_classifier_to_artifact(cfg, level=LEVEL, dataset=ds,
                                           device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tree = load_quantized(path)
    stem = tuple(tree["qkernels"]["stem"].shape)
    log(f"[int8] --quantize: 4 batches of 128 of the {len(ds)} tissue cells → "
        f"{os.path.basename(path)} ({os.path.getsize(path) / 1e6:.1f} MB, "
        f"{len(tree['ascales'])} activation scales, stem {stem}, input "
        f"{artifact_input_hw(tree)}) in {wall:.2f} s")
    if (os.path.basename(path) != CLASSIFIER_ARTIFACT or stem != (64, 12, 4, 4)
            or artifact_input_hw(tree) != (224, 224) or counts() != (0, 0, 0)):
        raise AssertionError("--quantize did not write the s2d artifact of a "
                             "224² input through the float forward")

    # --predict_slide --int8 from the artifact, launches counted
    model = resnet18_from_state_dict(sd).to(dev)
    kw = dict(level=LEVEL, stride=STRIDE, output="margin", int8=True, qtree=tree,
              device=dev)
    white = host_margins == NON_TISSUE_MARGIN
    batches = -(-int((~white).sum()) // BATCH)
    runs = []
    for i in range(3):
        reset_counts()  # counts from here on are the int8 slide path's
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        margins, grid = predict_slide(slide, model, batch_size=BATCH, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        slide_counts = counts()
        runs.append(margins)
        log(f"[int8] predict_slide(int8=True, qtree=artifact) run {i + 1}: "
            f"{grid.num_patches} cells in {wall:.3f} s = "
            f"{grid.num_patches / wall:.1f} cells/s ({'cold' if i == 0 else 'warm'}"
            f"); launches fused_stage1_int8 {slide_counts[0]}, "
            f"int8_conv_requant {slide_counts[1]}, int8_maxpool "
            f"{slide_counts[2]}")
        if slide_counts != (batches, 16 * batches, batches):
            raise AssertionError(f"expected {batches}, {16 * batches} and "
                                 f"{batches} launches on the int8 slide path, "
                                 f"counted {slide_counts}")
    margins = runs[-1]
    if not np.isfinite(margins).all():
        raise AssertionError("non-finite int8 margins")
    if not np.array_equal(margins == NON_TISSUE_MARGIN, white):
        raise AssertionError("the int8 and float tissue partitions differ")
    other, _ = predict_slide(slide, model, batch_size=384, **kw)
    d_batch = np.abs(other - margins).max()
    d_run = np.abs(runs[1] - margins).max()

    # against the port's float32 folded forward on the reference cells
    iy, ix = ref_cells[:, 0], ref_cells[:, 1]
    x = torch.from_numpy(ref_u8).to(dev)
    qt = quantized_to(tree, dev)
    with torch.inference_mode():
        l32 = folded_forward(fold_batchnorm(sd), x)
        l8 = quant_forward(qt, x)
        f32 = folded_forward(fold_batchnorm(sd), x, with_fc=False)
        f8 = quant_forward(qt, x, with_fc=False)
    m32, m8 = (l32[:, 1] - l32[:, 0]).cpu().numpy(), (l8[:, 1] - l8[:, 0]).cpu().numpy()
    cos_logits = F.cosine_similarity(l8.flatten(), l32.flatten(), dim=0).item()
    cos_feats = F.cosine_similarity(f8, f32, dim=1).min().item()
    d_margin = np.abs(m8 - m32).max()
    spread = m32.max() - m32.min()
    d_slide = np.abs(margins[iy, ix] - m8).max()
    log(f"[int8] {len(m32)} reference cells: int8 against the float32 "
        f"folded_forward: logit cosine {cos_logits:.5f}, feature cosine (worst "
        f"cell) {cos_feats:.5f} (bound {INT8_COSINE_MIN}), margins max|Δ| "
        f"{d_margin:.4g}, mean|Δ| {np.abs(m8 - m32).mean():.4g} (bound "
        f"{INT8_MARGIN_ATOL} on a spread of {spread:.4f}, must be ≥ "
        f"{10 * INT8_MARGIN_ATOL}); the slide run's margins of these cells "
        f"against a direct quant_forward max|Δ| {d_slide:.3g}; batch 384 against "
        f"{BATCH} max|Δ| {d_batch:.3g}, run against run {d_run:.3g}")
    if spread < 10 * INT8_MARGIN_ATOL:
        raise AssertionError("reference margins spread too little to check "
                             "the int8 forward")
    if (min(cos_logits, cos_feats) < INT8_COSINE_MIN
            or d_margin > INT8_MARGIN_ATOL):
        raise AssertionError("int8 margins outside their bound of the float32 "
                             "forward")
    if max(d_slide, d_batch, d_run) > 1e-5 * np.abs(m8).max():
        raise AssertionError("int8 margins from the artifact depend on the "
                             "batch or the run")

    # the CLI: --predict_slide --int8 picks the artifact up
    slide_path = os.path.join(tmp, "smoke_slide.wsi.npz")
    save_npz_slide(slide_path, [slide.level_array(i)
                                for i in range(slide.level_count)])
    argv = ["--predict_slide", slide_path, "--int8", "--device", "cuda",
            "--stride", str(STRIDE), "--models_dir", models_dir]
    with _Messages("models.quant_artifact") as records:
        rc, wall = run_cli(argv)
    if rc != 0:
        raise AssertionError(f"CLI --int8 failed ({rc})")
    rows = np.loadtxt(os.path.join(models_dir, "model_predictions_csv",
                                   "smoke_slide.csv"), delimiter=",", ndmin=2)
    if (not any(r.getMessage().startswith("using persisted quantization "
                                          "artifact") for r in records)
            or rows.size == 0
            or not ((rows[:, 0] > 0) & (rows[:, 0] < 1)).all()):
        raise AssertionError("CLI --int8 did not use the artifact or wrote no "
                             "valid detections")
    log(f"[int8] {' '.join(argv[:3])} … exit 0 in {wall:.1f} s (the CLI's "
        f"main in this process); {len(rows)} detections")

    # run_feature_extraction(int8=True, qtree=artifact)
    trunk = strip_head(sd)
    n, steps = len(ds), -(-len(ds) // BATCH)
    reset_counts()  # counts from here on are the int8 extraction's
    feats, _, _ = run_feature_extraction(ds, trunk, BATCH, device=dev,
                                         int8=True, qtree=tree)
    torch.cuda.synchronize()
    feat_counts = counts()
    if feat_counts != (steps, 16 * steps, steps):
        raise AssertionError(f"expected {steps}, {16 * steps} and {steps} "
                             f"launches on the int8 extraction, counted "
                             f"{feat_counts}")
    walls = []
    for bs in (384, BATCH, BATCH):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again, _, _ = run_feature_extraction(ds, trunk, bs, device=dev,
                                             int8=True, qtree=tree)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(again, feats):
            raise AssertionError(
                f"int8 features from the artifact differ at batch {bs}: max|Δ| "
                f"{np.abs(again - feats).max():.3g}")
    idx = np.sort(np.random.default_rng(SEED).choice(n, FEAT_REF_CELLS,
                                                     replace=False))
    imgs, _ = ds.read_batch(idx)
    with torch.inference_mode():
        ref = folded_forward(fold_batchnorm(trunk), torch.from_numpy(imgs).to(dev),
                             with_fc=False).cpu()
    cos = F.cosine_similarity(torch.from_numpy(feats[idx]), ref, dim=1).min().item()
    log(f"[int8] run_feature_extraction(int8=True, qtree=artifact): {n} cells, "
        f"{steps} batches; launches fused_stage1_int8 {feat_counts[0]}, "
        f"int8_conv_requant {feat_counts[1]}, int8_maxpool {feat_counts[2]}; "
        f"features identical at batch 384 "
        f"and {BATCH}; against the float32 folded_forward on {len(idx)} cells: "
        f"cosine (worst cell) {cos:.5f} (bound {INT8_COSINE_MIN}), max|Δ| "
        f"{np.abs(feats[idx] - ref.numpy()).max():.4g} at features up to "
        f"{ref.max().item():.4f}; warm loop {walls[-1]:.1f} ms = "
        f"{n / walls[-1] * 1e3:.0f} patches/s")
    if not np.isfinite(feats).all() or cos < INT8_COSINE_MIN:
        raise AssertionError("int8 features outside their bound of the float32 "
                             "forward")

    # the forward alone on one batch on the card, both input layouts
    x = torch.from_numpy(ds.read_batch(range(BATCH))[0]).to(dev)
    xs = x.reshape(BATCH, 112, 2, 112, 2, 3).permute(0, 1, 3, 2, 4, 5).reshape(
        BATCH, 112, 112, 12).contiguous()
    with torch.inference_mode():
        for name, inp in (("(512,224,224,3)", x), ("pre-s2d (512,112,112,12)", xs)):
            fn = lambda: quant_forward(qt, inp, with_fc=False)  # noqa: E731
            cuda_ms(fn, 3)
            q1, med, q3 = quartiles(cuda_ms(fn, FEAT_TIMED_STEPS))
            log(f"[int8] warm quant_forward at B={BATCH}, input {name}: median "
                f"{med:.3f} ms (quartiles {q1:.3f}–{q3:.3f}) = "
                f"{BATCH / med * 1e3:.0f} patches/s")

    # the card against the CPU's plain quant_forward
    imgs, _ = ds.read_batch(range(INT8_CPU_CELLS))
    with torch.inference_mode():
        card = quant_forward(qt, torch.from_numpy(imgs).to(dev), with_fc=False).cpu()
        t0 = time.perf_counter()
        cpu = quant_forward(tree, torch.from_numpy(imgs), with_fc=False)
        wall = time.perf_counter() - t0
    step = tree["ascales"]["s4b1o"].item() / 49  # one int8 step of one value
    d = (card - cpu).abs().max().item()
    log(f"[int8] card against the CPU's plain quant_forward on "
        f"{INT8_CPU_CELLS} cells ({wall:.1f} s on the CPU): features max|Δ| "
        f"{d:.3g} = {d / step:.3g} int8 steps of one of a feature's 49 values "
        f"(bound {INT8_CPU_STEPS}); features up to {cpu.max().item():.4f}")
    if d > INT8_CPU_STEPS * step:
        raise AssertionError("the card's int8 forward differs from the CPU's")
    return {"fused_stage1_int8": slide_counts[0],
            "int8_conv_requant": slide_counts[1],
            "int8_maxpool": slide_counts[2]}


DP_TIMED_STEPS = 5  # warm synchronized steps timed on each side


def sync(dev) -> None:
    """Wait for ``dev``'s work (nothing to wait for on the CPU)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
DP_RANKS_ON_ONE_CARD = 2


def classifier_dp(dev, group, records, sd, timed: int) -> dict:
    """The classifier ``Trainer`` over ``records`` (one global batch, one
    step an epoch) on this rank: the augment launches counted around the
    epoch, loss, gradients, weights, then ``timed`` warm synchronized steps
    on one batch of this rank's rows."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        resnet18_from_state_dict,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.augment import (
        augment_batch_kernel,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
        PatchDataset,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
        PatchManifest,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.losses import (
        class_weights_inv_min,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.trainer import (
        Trainer,
    )

    ds = PatchDataset(PatchManifest(records))
    trainer = Trainer(resnet18_from_state_dict(sd), ds, None,
                      batch_size=len(records), learning_rate=1e-4,
                      class_weights=class_weights_inv_min(ds.labels, 2),
                      seed=SEED, device=dev, group=group)
    sync(dev)
    reset_counts()  # counts from here on are the classifier path's
    stats = trainer.train_epoch(0)
    sync(dev)
    out = {"aug_launches": augment_batch_kernel.launches,
           "loss": stats["train_loss"],
           "grads": {k: p.grad.float().cpu()
                     for k, p in trainer.state.model.named_parameters()},
           "sd": trainer.variables()}
    local = next(iter(trainer._batches(trainer.batch_iter)))
    walls = []
    for _ in range(timed + 1):
        sync(dev)
        t0 = time.perf_counter()
        trainer.train_step(trainer.state, trainer.generator, *local)
        sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = walls[1:]  # the first is a warm-up
    return out


def dp_steps(dev, group, records, sd, simclr_sd, timed: int) -> dict:
    """One rank of phase 14 (or the single process, ``group`` None): the
    classifier step (:func:`classifier_dp`), then one SimCLR step with the
    NT-Xent kernels on the same images, its launches counted around it."""
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
        simclr_two_views,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
        BatchIterator,
        PatchDataset,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
        PatchManifest,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
        set_process_group,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.simclr import (
        SimCLRModel,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.nt_xent import (
        nt_xent_loss_kernel,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.feed import (
        process_batch_slice,
        to_device,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.mesh import (
        rank_and_size,
        replicate,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.simclr_trainer import (
        make_simclr_train_step,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
        create_train_state,
    )

    rank, world = rank_and_size(group)
    batch = len(records)  # one global batch
    out = classifier_dp(dev, group, records, sd, timed)
    ds = PatchDataset(PatchManifest(records))

    # SimCLR: this rank's rows of the first global batch, views of the
    # global draw, the NT-Xent kernels on the gathered (1024, 128) matrix
    model = SimCLRModel()
    model.load_state_dict(simclr_sd)
    set_process_group(model, group)
    state = create_train_state(model, 1e-3, dev)
    replicate(model, group)
    rows = process_batch_slice(batch, rank, world)
    imgs, _, valid = next(iter(BatchIterator(ds, batch, seed=SEED, rows=rows)))
    imgs, valid = to_device(imgs, dev), to_device(valid, dev).bool()
    step = make_simclr_train_step(TAU, 224, "pallas", group)
    sync(dev)
    reset_counts()  # counts from here on are the SimCLR step's
    state, loss = step(state, torch.Generator(device=dev).manual_seed(SEED),
                       imgs, valid)
    sync(dev)
    fwd, bwd = ntxent_launchers()
    out["simclr"] = {"loss": float(loss), "fwd": fwd.launches,
                     "bwd": bwd.launches}
    # the projections of this rank's views after the step, and the kernels'
    # loss over the group: the parent holds it to the kernels on the
    # gathered projections
    v1, v2 = simclr_two_views(torch.Generator(device=dev).manual_seed(SEED + 1),
                              imgs, 224, rows=(rows.start, batch))
    with torch.no_grad(), torch.autocast("cuda", torch.bfloat16):
        z1, z2 = model(v1), model(v2)
    with torch.no_grad():
        out["simclr"]["group_loss"] = float(nt_xent_loss_kernel(
            z1, z2, TAU, valid=valid, group=group))
    out["simclr"]["z"] = (z1.float().cpu(), z2.float().cpu())
    out["simclr"]["valid"] = valid.cpu()
    return out


def _dp_rank(rank: int, world: int, port: int, backend: str, records, sd,
             simclr_sd, out_dir: str) -> None:
    """A spawned rank of phase 14: ``backend`` gloo puts every rank on
    ``cuda:0``, NCCL rank r on ``cuda:r``."""
    import datetime

    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    if not torch.cuda.is_available():  # a rehearsal on the CPU
        dev = torch.device("cpu")
    else:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=5))
    try:
        res = dp_steps(dev, dist.group.WORLD, records, sd, simclr_sd,
                       DP_TIMED_STEPS)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(world: int, backend: str, records, sd, simclr_sd, tmp) -> list:
    """Phase 14's steps in ``world`` spawned ranks; their results."""
    import torch
    import torch.multiprocessing as mp

    out_dir = tempfile.mkdtemp(dir=tmp)
    t0 = time.perf_counter()
    mp.start_processes(_dp_rank, args=(world, _free_port(), backend, records,
                                       sd, simclr_sd, out_dir),
                       nprocs=world, join=True, start_method="spawn")
    log(f"[dp] {world} ranks over {backend} spawned, ran and joined in "
        f"{time.perf_counter() - t0:.1f} s")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _head_close(got: dict, want: dict, what: str) -> float:
    """The bf16 step bound of phase 10: the head's gradients within
    TRAIN_GRAD_RTOL of their max|g|; returns the largest share."""
    worst = 0.0
    for k in ("fc.weight", "fc.bias"):
        scale = want[k].abs().max().item()
        share = (got[k] - want[k]).abs().max().item() / scale
        worst = max(worst, share)
        if share > TRAIN_GRAD_RTOL:
            raise AssertionError(f"{what}: {k} gradient {share:.3g} of max|g| "
                                 f"from the reference (bound "
                                 f"{TRAIN_GRAD_RTOL})")
    return worst


def check_ranks(name: str, res: list, ref: dict) -> None:
    """Phase 14 (b), (c), (f): every rank's weights bit-identical, the
    launches one per rank a step, loss and head gradients within the bf16
    bound of ``ref``, and the group's NT-Xent loss equal to the kernels' on
    the gathered projections within their 1e-5."""
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.nt_xent import (
        nt_xent_loss_kernel,
    )

    for r, out in enumerate(res[1:], 1):
        for k, v in res[0]["sd"].items():
            if not torch.equal(out["sd"][k], v):
                raise AssertionError(f"{name}: rank {r}'s {k} differs from "
                                     "rank 0's after the step")
    for r, out in enumerate(res):
        s = out["simclr"]
        if out["aug_launches"] != 1 or (s["fwd"], s["bwd"]) != (1, 1):
            raise AssertionError(
                f"{name}: rank {r} launched augment {out['aug_launches']}, "
                f"nt_xent_fwd/bwd {s['fwd']}/{s['bwd']} times (want 1 each)")
        if abs(out["loss"] - ref["loss"]) > TRAIN_LOSS_ATOL:
            raise AssertionError(f"{name}: rank {r} classifier loss "
                                 f"{out['loss']} vs {ref['loss']}")
        if abs(s["loss"] - ref["simclr"]["loss"]) > TRAIN_LOSS_ATOL:
            raise AssertionError(f"{name}: rank {r} SimCLR loss {s['loss']} "
                                 f"vs {ref['simclr']['loss']}")
    grad = max(_head_close(out["grads"], ref["grads"], name) for out in res)
    dev = torch.device("cuda", 0)
    z1 = torch.cat([o["simclr"]["z"][0] for o in res]).to(dev)
    z2 = torch.cat([o["simclr"]["z"][1] for o in res]).to(dev)
    valid = torch.cat([o["simclr"]["valid"] for o in res]).to(dev)
    with torch.no_grad():
        gathered = float(nt_xent_loss_kernel(z1, z2, TAU, valid=valid))
    worst = max(abs(o["simclr"]["group_loss"] - gathered) / abs(gathered)
                for o in res)
    steps = [statistics.median(o["step_ms"]) for o in res]
    log(f"[dp] {name}: weights bit-identical over {len(res)} ranks; augment "
        f"1, nt_xent_fwd 1, nt_xent_bwd 1 a rank; classifier loss "
        f"{res[0]['loss']!r} vs {ref['loss']!r}, head gradients within "
        f"{grad:.3g} of max|g|; SimCLR loss {res[0]['simclr']['loss']!r} vs "
        f"{ref['simclr']['loss']!r}; group NT-Xent {res[0]['simclr']['group_loss']!r} "
        f"vs the kernels on the gathered (1024, 128) projections {gathered!r} "
        f"(relative {worst:.3g}); classifier step per rank "
        f"{', '.join(f'{s:.2f}' for s in steps)} ms (median of "
        f"{DP_TIMED_STEPS} synchronized)")
    if worst > NTX_RTOL:
        raise AssertionError(f"{name}: group NT-Xent {worst:.3g} from the "
                             f"kernels on the gathered projections")


GLOBAL_BN_RTOL = 1e-4  # of max|value|: float32, Welford against two passes


def plain_bn_step_ms(dev, group, records, sd) -> list[float]:
    """The world-1 classifier step timed with the global BatchNorm on its
    plain float32 route instead of the synchronized-BN kernels: the A/B
    behind the CUDA route (a measurement only; the route is restored)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel import (
        collectives,
    )

    def plain(x, weight, bias, eps, group):
        import types

        from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
            BatchNorm2d,
        )

        # the route reads only these four attributes of its module
        bn = types.SimpleNamespace(weight=weight, bias=bias, eps=eps,
                                   group=group)
        return BatchNorm2d._global_forward_plain(bn, x)

    kernels = collectives.global_batch_norm
    collectives.global_batch_norm = plain
    try:
        return classifier_dp(dev, group, records, sd, DP_TIMED_STEPS)["step_ms"]
    finally:
        collectives.global_batch_norm = kernels


def check_global_bn(dev, group) -> float:
    """The CUDA route of the global BatchNorm (PyTorch's synchronized-BN
    kernels) against its plain float32 route on the same (64, 64, 56, 56)
    channels_last batch: output, statistics and the three gradients; the
    largest error as a share of each tensor's max|value|."""
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
        BatchNorm2d,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.collectives import (
        global_batch_norm,
    )

    g = torch.Generator(device=dev).manual_seed(SEED)
    x = (torch.randn(64, 64, 56, 56, device=dev, generator=g) * 2 + 1).to(
        memory_format=torch.channels_last)
    coef = torch.randn(x.shape, device=dev, generator=g)
    bn = BatchNorm2d(64).to(dev).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-0.5, 0.5, generator=g)
    bn.group = group
    out = []
    for route in ("cuda", "plain"):
        xi = x.clone().requires_grad_(True)
        bn.zero_grad()
        if route == "cuda":
            y, mean, var = global_batch_norm(xi, bn.weight, bn.bias, bn.eps,
                                             group)
        else:
            y, mean, var = bn._global_forward_plain(xi)
        (y * coef).sum().backward()
        out.append([y.detach(), mean, var, xi.grad, bn.weight.grad.clone(),
                    bn.bias.grad.clone()])
    worst = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(*out))
    log(f"[dp] global BatchNorm on the card, synchronized-BN kernels against "
        f"the plain route at (64, 64, 56, 56) float32: output, mean, "
        f"variance and gradients within {worst:.3g} of max|value| (bound "
        f"{GLOBAL_BN_RTOL})")
    if worst > GLOBAL_BN_RTOL:
        raise AssertionError("the global BatchNorm's CUDA route differs from "
                             "its plain route")
    return worst


def phase_dp(dev, ds, smi, tmp) -> dict:
    """Phase 14 (a)-(c), (f): the data-parallel classifier and SimCLR steps
    on the first 512 tissue cells, against one process."""
    import datetime

    import torch
    import torch.distributed as dist

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
        ResNet18Classifier,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.simclr import (
        SimCLRModel,
    )

    t0 = time.perf_counter()
    records = ds.manifest.records[:BATCH]
    sd = ResNet18Classifier(generator=torch.Generator().manual_seed(SEED)
                            ).state_dict()
    simclr_sd = SimCLRModel(generator=torch.Generator().manual_seed(SEED)
                            ).state_dict()
    one = dp_steps(dev, None, records, sd, simclr_sd, DP_TIMED_STEPS)
    # (a) world 1 over a real NCCL communicator, in this process
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(minutes=5))
    try:
        bn_err = check_global_bn(dev, dist.group.WORLD)
        nccl1 = dp_steps(dev, dist.group.WORLD, records, sd, simclr_sd,
                         DP_TIMED_STEPS)
        plain_ms = statistics.median(plain_bn_step_ms(
            dev, dist.group.WORLD, records, sd))
    finally:
        dist.destroy_process_group()
    check_ranks("(a) world 1 over NCCL", [nccl1], one)
    single, dp1 = (statistics.median(one["step_ms"]),
                   statistics.median(nccl1["step_ms"]))
    log(f"[dp] (a) classifier step B={BATCH}: single process {single:.2f} ms, "
        f"world 1 over NCCL {dp1:.2f} ms (the group's BatchNorm, loss and "
        f"gradient collectives: {dp1 - single:+.2f} ms); with the global "
        f"BatchNorm's plain float32 route {plain_ms:.2f} ms [{smi}]")
    # (b), (c): two ranks share the card; NCCL refuses two ranks on one GPU
    gloo = run_ranks(DP_RANKS_ON_ONE_CARD, "gloo", records, sd, simclr_sd, tmp)
    check_ranks(f"(b)/(c) {DP_RANKS_ON_ONE_CARD} ranks on 1 card, gloo", gloo,
                nccl1)
    out = {"one": one, "nccl1": nccl1, "gloo": gloo, "bn_err": bn_err,
           "plain_bn_ms": plain_ms,
           "aug_launches": sum(o["aug_launches"] for o in gloo),
           "ntx_launches": sum(o["simclr"]["fwd"] for o in gloo)}
    # (f): one rank a card over NCCL, where the machine has several
    cards = torch.cuda.device_count()
    if cards >= 2:
        nccl = run_ranks(cards, "nccl", records, sd, simclr_sd, tmp)
        check_ranks(f"(f) {cards} ranks on {cards} cards, NCCL", nccl, nccl1)
    else:
        log("[dp] (f) skipped: one card visible (NCCL takes one rank a card)")
    log(f"[dp] phase 14 (a)-(c) in {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 14 (h): the data-parallel paths of multiscale training, QAT, the
# streamed trainer and feature extraction
# ---------------------------------------------------------------------------

H_QAT_CALIB = 2  # QAT's calibration batches (of 128)
H_MS_STEPS = 2  # multiscale steps on one global batch
# the streamed run's split seed: the smoke slide trains (4 global batches of
# its tissue cells at stride 28) and normal_001 is held out; at the default
# seed normal_001's 114 cells train, less than one global batch
H_STREAM_SPLIT_SEED = 1
# against one process. The bf16 steps (multiscale, streamed) differ by the
# summation order of another batch split; each bound is 7-9x the largest
# reading on an NVIDIA H100 80GB HBM3, 700.00 W: the losses a step 7.4e-5
# (multiscale) and 6.8e-5 (streamed), the BN running statistics 2.3e-3 of
# a tensor's max|value|
H_MS_LOSS_ATOL = 5e-4
H_STREAM_LOSS_ATOL = 5e-4
H_BN_RTOL = 2e-2
# QAT runs float32 (TF32 off): one process, world-1 NCCL and two ranks differ
# only in the summation order of the loss, the gradients and the
# convolutions of another batch size
H_QAT_LOSS_RTOL = 1e-5
H_FEAT_BF16_ATOL = 1e-3  # bf16 features (measured 0 on both stem routes)


def launch_counts() -> dict:
    """The launch counts of the six kernels the group paths run."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.augment import (
        augment_batch_kernel,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.fused_stem import (
        bias_relu_pool_kernel,
        fused_stem_kernel,
    )

    stage1, conv, pool = int8_launchers()
    return {"augment": augment_batch_kernel.launches,
            "bias_relu_pool": bias_relu_pool_kernel.launches,
            "fused_stem": fused_stem_kernel.launches,
            "fused_stage1_int8": stage1.launches,
            "int8_conv_requant": conv.launches,
            "int8_maxpool": pool.launches}


def _counted(fn, dev):
    """``fn()``'s result and the launches it made (counts zeroed just
    before, read just after), the device synchronized around it."""
    sync(dev)
    reset_counts()
    out = fn()
    sync(dev)
    return out, launch_counts()


def h_paths(dev, group, inp: dict) -> dict:
    """One rank of phase 14 (h), or the single process (``group`` None):
    ``train_multiscale_classifier`` for one epoch of phase 12's 448² + 224²
    cells (and, for Adam's state, two steps of its train step on one global
    batch of 512), ``qat_finetune`` for one epoch of the level-3 store, the
    streamed trainer's epoch on a fresh copy of phase 13's root (rank 0
    extracts) and ``run_feature_extraction`` over the 1,752 cells on both
    stem routes and int8 with lazy calibration; the launches of each."""
    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        Config,
        DataConfig,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
        PatchDataset,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
        PatchManifest,
        load_or_scan_manifest,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.multiscale import (
        MultiscaleDataset,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.features import (
        run_feature_extraction,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.hierarchical import (
        HierarchicalPatchClassifier,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
        set_process_group,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.feed import (
        process_batch_slice,
        to_device,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.mesh import (
        rank_and_size,
        replicate,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
        load_model,
        model_artifact_path,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.multiscale_trainer import (
        make_multiscale_train_step,
        train_multiscale_classifier,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.qat import (
        qat_finetune,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
        create_train_state,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.streaming import (
        train_resnet_classifier_streaming,
    )

    rank, world = rank_and_size(group)
    tag = f"rank{rank}" if group is not None else "one"
    out: dict = {}
    t0 = time.perf_counter()
    msds = MultiscaleDataset({lvl: PatchManifest(recs)
                              for lvl, recs in inp["ms_records"].items()},
                             resize_to=224, input_mode="resize")

    # multiscale through its entry point: one epoch, calibration on rank 0
    cfg = Config(models_dir=os.path.join(inp["tmp"], f"h_ms_{inp['run']}"))
    ms, counts = _counted(lambda: train_multiscale_classifier(
        cfg, levels=MS_LEVELS, epochs=1, dataset=msds, batch_size=BATCH,
        init_from=None, device=dev, group=group), dev)
    path = model_artifact_path(cfg.models_dir, "hierarchical_classifier")
    out["ms"] = {"history": ms["history"], "launches": counts,
                 "variables": {k: v.detach().cpu().clone()
                               for k, v in ms["variables"].items()},
                 "calibration": ms["calibration"],
                 "saved": load_model(path) if rank == 0 else None,
                 "steps": -(-len(msds.split_by_slide(
                     cfg.data.val_fraction, cfg.data.split_seed)[0]) // BATCH),
                 "lr": cfg.train.learning_rate}
    del ms
    torch.cuda.empty_cache()

    # the train step alone, H_MS_STEPS times on the first 512 training
    # cells: Adam's state, which the entry point does not return
    rows = process_batch_slice(BATCH, rank, world)
    imgs, labels, valid = next(msds.batches(
        BATCH, shuffle=False, indices=inp["ms_idx"], rows=rows))
    imgs = {lvl: to_device(x, dev) for lvl, x in imgs.items()}
    labels = to_device(labels.astype(np.int64), dev)
    valid = to_device(valid, dev)
    model = HierarchicalPatchClassifier(
        levels=MS_LEVELS, generator=torch.Generator().manual_seed(SEED))
    set_process_group(model, group)
    state = create_train_state(model, 1e-4, dev)
    replicate(model, group)
    step = make_multiscale_train_step(inp["ms_weights"], 0.5, group)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def ms_steps():
        losses = []
        for _ in range(H_MS_STEPS):
            _, m = step(state, gen, imgs, labels, valid)
            losses.append(m["loss"])
        return [float(v) for v in losses]

    losses, counts = _counted(ms_steps, dev)
    out["ms_step"] = {"losses": losses, "launches": counts,
                      "sd": {k: v.detach().cpu().clone()
                             for k, v in state.model.state_dict().items()},
                      "adam": [v.detach().cpu().clone()
                               for s in state.optimizer.state.values()
                               for v in s.values()
                               if isinstance(v, torch.Tensor)]}
    del state, model, imgs
    torch.cuda.empty_cache()

    # QAT: one epoch of the level-3 store
    cfg = Config(data=DataConfig(data_dir=inp["data_dir"]),
                 models_dir=os.path.join(inp["tmp"], f"h_qat_{inp['run']}"))
    qat, counts = _counted(lambda: qat_finetune(
        cfg, variables=inp["sd"], level=LEVEL, epochs=1, batch_size=BATCH,
        n_calib_batches=H_QAT_CALIB, device=dev, group=group), dev)
    out["qat"] = {"history": qat["history"], "launches": counts,
                  "folded": qat["folded"],
                  "ascales": {k: v.cpu() for k, v in qat["ascales"].items()},
                  "artifact": qat["artifact_path"],
                  "steps": -(-len(load_or_scan_manifest(cfg.data.patches_dir,
                                                        LEVEL)) // BATCH),
                  "lr": 1e-5}  # qat_finetune's default
    del qat
    torch.cuda.empty_cache()

    # the streamed trainer, one epoch on a fresh copy of phase 13's root
    root = inp["stream_root"]
    cfg = Config(data=DataConfig(data_dir=root,
                                 split_seed=H_STREAM_SPLIT_SEED),
                 models_dir=os.path.join(inp["tmp"], f"h_stream_{inp['run']}"))
    cfg.model.pretrained = False
    st, counts = _counted(lambda: train_resnet_classifier_streaming(
        cfg, level=LEVEL, epochs=1, stride=STRIDE, batch_size=BATCH,
        device=dev, group=group), dev)
    out["stream"] = {"epoch": st["streamed_epoch"], "launches": counts,
                     "variables": st["variables"],
                     "lr": cfg.train.learning_rate}
    del st
    torch.cuda.empty_cache()

    # features: both stem routes in bf16, and int8 calibrated lazily
    ds = PatchDataset(PatchManifest(inp["records"]))
    dim = int(inp["trunk"]["layer4.1.conv2.weight"].shape[0])
    out["features"] = {}
    for name, kw in (("bf16", {}), ("s2d", {"stem_s2d": True}),
                     ("int8", {"int8": True})):
        (feats, _, names), counts = _counted(
            lambda: run_feature_extraction(ds, inp["trunk"], batch_size=BATCH,
                                           feature_dim=dim, device=dev,
                                           group=group, **kw), dev)
        out["features"][name] = {"feats": np.array(feats), "launches": counts,
                                 "names": names}
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"[dp-h] {tag}: the four group paths in {out['seconds']:.1f} s")
    return out


def _h_rank(rank: int, world: int, port: int, inp: dict, out_dir: str
            ) -> None:
    """A spawned gloo rank of phase 14 (h) on ``cuda:0``."""
    import datetime

    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=5))
    try:
        res = h_paths(dev, dist.group.WORLD, inp)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _h_identical(name: str, res: list, get) -> None:
    """Every rank's tensors of ``get(result)`` (a dict or a list) bit-equal
    to rank 0's."""
    import torch

    first = get(res[0])
    keys = range(len(first)) if isinstance(first, list) else first.keys()
    for r, out in enumerate(res[1:], 1):
        other = get(out)
        for k in keys:
            a, b = other[k], first[k]
            if isinstance(a, tuple):
                same = all(torch.equal(torch.as_tensor(x), torch.as_tensor(y))
                           for x, y in zip(a, b))
            else:
                same = torch.equal(torch.as_tensor(a), torch.as_tensor(b))
            if not same:
                raise AssertionError(f"(h) {name}: rank {r}'s {k} differs "
                                     "from rank 0's")


def _is_bn_stat(key: str) -> bool:
    return key.endswith(("running_mean", "running_var"))


def _h_against_one(name: str, what: str, got: dict, want: dict,
                   lr: float, steps: int) -> tuple[float, float]:
    """A rank's weights (a state dict) against the single process's:
    parameters within Adam's 2·lr a step, the BN running statistics within
    ``H_BN_RTOL`` of each tensor's max|value|; the largest of each, the
    parameters' over the bound."""
    import torch

    worst_p = worst_bn = 0.0
    for k, w in want.items():
        w = torch.as_tensor(w)
        if not w.is_floating_point() or k.startswith("calibration."):
            continue
        d = (torch.as_tensor(got[k]).double() - w.double()).abs().max().item()
        if _is_bn_stat(k):
            worst_bn = max(worst_bn, d / max(w.abs().max().item(), 1e-12))
        else:
            worst_p = max(worst_p, d / (2 * lr * steps))
    if worst_p > 1.0 or worst_bn > H_BN_RTOL:
        raise AssertionError(f"(h) {name}: {what} weights {worst_p:.3g} of "
                             f"2·lr·steps, BN statistics {worst_bn:.3g} of "
                             f"max|value| (bound {H_BN_RTOL}) from one process")
    return worst_p, worst_bn


def h_check(name: str, res: list, one: dict) -> dict:
    """Phase 14 (h)'s checks of a run (its ranks' results) against the
    single process; the measured differences."""
    import numpy as np
    import torch

    world = len(res)
    worst = {}
    # multiscale through the entry point: bf16 steps; augment twice a step
    steps = one["ms"]["steps"]
    worst["ms_loss"] = max(abs(o["ms"]["history"][0]["loss"]
                               - one["ms"]["history"][0]["loss"]) / steps
                           for o in res)
    if worst["ms_loss"] > H_MS_LOSS_ATOL:
        raise AssertionError(f"(h) {name}: multiscale loss {worst['ms_loss']}"
                             " a step from one process")
    for r, o in enumerate(res):
        if o["ms"]["launches"]["augment"] != 2 * steps:
            raise AssertionError(f"(h) {name}: rank {r} launched augment "
                                 f"{o['ms']['launches']['augment']} times on "
                                 f"the multiscale epoch ({steps} steps)")
        if o["ms"]["calibration"] != res[0]["ms"]["calibration"]:
            raise AssertionError(f"(h) {name}: rank {r}'s calibration differs "
                                 "from rank 0's")
    worst["ms_w"], worst["ms_bn"] = (
        max(v) for v in zip(*(_h_against_one(
            name, "multiscale", o["ms"]["variables"], one["ms"]["variables"],
            one["ms"]["lr"], steps) for o in res)))
    saved, mine = res[0]["ms"]["saved"], res[0]["ms"]["variables"]
    if saved.keys() != mine.keys() or not all(
            torch.equal(saved[k], mine[k]) for k in mine):
        raise AssertionError(f"(h) {name}: rank 0's multiscale artifact is "
                             "not the state it returned")
    # the train step alone, twice on one global batch
    worst["ms_step_loss"] = max(abs(a - b) for o in res
                                for a, b in zip(o["ms_step"]["losses"],
                                                one["ms_step"]["losses"]))
    for r, o in enumerate(res):
        if o["ms_step"]["launches"]["augment"] != 2 * H_MS_STEPS:
            raise AssertionError(f"(h) {name}: rank {r} launched augment "
                                 f"{o['ms_step']['launches']['augment']} "
                                 "times on the multiscale steps")
    if worst["ms_step_loss"] > H_MS_LOSS_ATOL:
        raise AssertionError(f"(h) {name}: multiscale step loss "
                             f"{worst['ms_step_loss']} from one process")
    # QAT: float32
    worst["qat_loss"] = max(abs(o["qat"]["history"][0]["loss"]
                                - one["qat"]["history"][0]["loss"])
                            / abs(one["qat"]["history"][0]["loss"])
                            for o in res)
    if worst["qat_loss"] > H_QAT_LOSS_RTOL:
        raise AssertionError(f"(h) {name}: QAT loss {worst['qat_loss']:.3g} "
                             "from one process")

    def folded(o):
        return {f"{n}.{i}": kb[i] for n, kb in o["qat"]["folded"].items()
                for i in (0, 1)}

    worst["qat_w"] = max(_h_against_one(
        name, "QAT", folded(o), folded(one), one["qat"]["lr"],
        one["qat"]["steps"])[0] for o in res)
    # the streamed epoch: the same patches, bf16 steps
    steps = -(-one["stream"]["epoch"]["patches"] // BATCH)
    if steps < 2:
        raise AssertionError(f"(h) {name}: the streamed epoch is {steps} "
                             "global batch(es)")
    for o in res:
        if o["stream"]["epoch"]["patches"] != one["stream"]["epoch"]["patches"]:
            raise AssertionError(f"(h) {name}: the streamed epoch saw other "
                                 "patches")
    worst["stream_loss"] = max(abs(o["stream"]["epoch"]["loss"]
                                   - one["stream"]["epoch"]["loss"]) / steps
                               for o in res)
    if worst["stream_loss"] > H_STREAM_LOSS_ATOL:
        raise AssertionError(f"(h) {name}: streamed loss {worst['stream_loss']}"
                             " a step from one process")
    for r, o in enumerate(res):
        if o["stream"]["launches"]["augment"] != steps:
            raise AssertionError(f"(h) {name}: rank {r} launched augment "
                                 f"{o['stream']['launches']['augment']} times "
                                 f"on the streamed epoch ({steps} steps)")
    worst["stream_w"], worst["stream_bn"] = (
        max(v) for v in zip(*(_h_against_one(
            name, "streamed", o["stream"]["variables"],
            one["stream"]["variables"], one["stream"]["lr"], steps)
            for o in res)))
    # features: int8 bit-equal to one process, bf16 within a bound
    for r, o in enumerate(res):
        f = o["features"]
        if not np.array_equal(f["int8"]["feats"], one["features"]["int8"]["feats"]):
            raise AssertionError(f"(h) {name}: rank {r}'s int8 features differ "
                                 "from one process's")
        for route in ("bf16", "s2d"):
            d = float(np.abs(f[route]["feats"]
                             - one["features"][route]["feats"]).max())
            worst[f"{route}_feat"] = max(worst.get(f"{route}_feat", 0.0), d)
            if d > H_FEAT_BF16_ATOL:
                raise AssertionError(f"(h) {name}: rank {r}'s {route} features "
                                     f"{d} from one process's")
        if f["int8"]["names"] != one["features"]["int8"]["names"]:
            raise AssertionError(f"(h) {name}: the feature rows' order differs")
    # ranks bit-identical
    _h_identical(name, res, lambda o: o["ms"]["variables"])
    _h_identical(name, res, lambda o: o["ms_step"]["sd"])
    _h_identical(name, res, lambda o: o["ms_step"]["adam"])
    _h_identical(name, res, lambda o: o["qat"]["folded"])
    _h_identical(name, res, lambda o: o["qat"]["ascales"])
    _h_identical(name, res, lambda o: o["stream"]["variables"])
    _h_identical(name, res, lambda o: {k: v["feats"]
                                       for k, v in o["features"].items()})
    launches = {path: [o[path]["launches"] for o in res]
                for path in ("ms", "ms_step", "qat", "stream")}
    launches.update({f"features_{k}": [o["features"][k]["launches"]
                                       for o in res]
                     for k in ("bf16", "s2d", "int8")})
    log(f"[dp-h] {name}, {world} rank(s): parameters, BN statistics, Adam "
        f"state, the multiscale calibration, the QAT trees and the features "
        f"bit-identical over the ranks, rank 0's multiscale artifact equal to "
        f"its state; against one process: multiscale epoch "
        f"({one['ms']['steps']} steps) loss |Δ| a step {worst['ms_loss']:.3g}, "
        f"step loss |Δ| {worst['ms_step_loss']:.3g} (bound {H_MS_LOSS_ATOL}), "
        f"weights {worst['ms_w']:.3g} of 2·lr·steps, BN statistics "
        f"{worst['ms_bn']:.3g} of max|value|; QAT loss {worst['qat_loss']:.3g} "
        f"relative (bound {H_QAT_LOSS_RTOL}), weights {worst['qat_w']:.3g} of "
        f"2·lr·steps; streamed epoch ({steps} steps) loss |Δ| a step "
        f"{worst['stream_loss']:.3g} (bound {H_STREAM_LOSS_ATOL}), weights "
        f"{worst['stream_w']:.3g} of 2·lr·steps, BN statistics "
        f"{worst['stream_bn']:.3g} of max|value| (bound {H_BN_RTOL}); int8 "
        f"features bit-equal, bf16 features max|Δ| {worst['bf16_feat']:.3g} "
        f"(default stem) and {worst['s2d_feat']:.3g} (stem_s2d) (bound "
        f"{H_FEAT_BF16_ATOL}); launches a rank {json.dumps(launches)}")
    return {"worst": worst, "launches": launches}


def h_cli_in_group(dev, data_dir: str, sd: dict, tmp: str) -> dict:
    """``--extract_features --int8`` through the CLI's ``main`` from a
    models directory without an int8 artifact (lazy calibration): in one
    process, then as the one rank of the world-1 NCCL group this process
    holds (``WORLD_SIZE`` set: ``_main_in_group`` joins the group). The two
    triplets bit-equal, the kernels' launches equal."""
    import numpy as np

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        DataConfig,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.features import (
        load_feature_artifacts,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
        save_model,
    )

    models = os.path.join(tmp, "h_cli_models")
    save_model(os.path.join(models, "resnet18_patch_classifier"), sd)
    argv = ["--extract_features", "--int8", "--batch_size", str(BATCH),
            "--data_dir", data_dir, "--models_dir", models, "--device", "cuda"]
    features_dir = DataConfig(data_dir=data_dir).features_dir
    runs = {}
    for name, env in (("one", {}),
                      ("group", {"WORLD_SIZE": "1", "RANK": "0",
                                 "LOCAL_RANK": "0"})):
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            (rc, wall), counts = _counted(lambda: run_cli(argv), dev)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        feats, labels, names = load_feature_artifacts(features_dir, LEVEL)
        if rc != 0:
            raise AssertionError(f"(h) --extract_features --int8 ({name}): "
                                 f"exit {rc}")
        runs[name] = {"feats": feats, "labels": labels, "names": names,
                      "launches": counts, "wall": wall}
    one, grp = runs["one"], runs["group"]
    if (not np.array_equal(one["feats"], grp["feats"])
            or not np.array_equal(one["labels"], grp["labels"])
            or one["names"] != grp["names"]
            or one["launches"] != grp["launches"]
            or grp["launches"]["fused_stage1_int8"] == 0):
        raise AssertionError(f"(h) --extract_features --int8 under the world-1 "
                             f"NCCL group differs from one process: launches "
                             f"{grp['launches']} / {one['launches']}")
    log(f"[dp-h] --extract_features --int8 through the CLI (lazy "
        f"calibration), one process and as rank 0 of the world-1 NCCL group: "
        f"exit 0 both, {len(one['names'])} rows, triplets bit-equal, walls "
        f"{one['wall']:.2f} / {grp['wall']:.2f} s, launches "
        f"{json.dumps(grp['launches'])}")
    return grp["launches"]


def phase_dp_paths(dev, ds, msds, ms_idx, ms_weights, ext_root, data_dir,
                   smi, tmp) -> dict:
    """Phase 14 (h): :func:`h_paths` in one process, over a world-1 NCCL
    group in this process (and the CLI's ``--extract_features --int8`` in
    it, :func:`h_cli_in_group`), and in 2 spawned gloo ranks sharing the
    card."""
    import datetime

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        strip_head,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
        ResNet18Classifier,
    )

    t0 = time.perf_counter()
    sd = ResNet18Classifier(generator=torch.Generator().manual_seed(SEED)
                            ).state_dict()
    ms_records = {lvl: msds.manifests[lvl].records for lvl in MS_LEVELS}

    def inputs(run):
        return {"records": ds.manifest.records, "ms_records": ms_records,
                "ms_idx": ms_idx, "ms_weights": ms_weights, "sd": sd,
                "trunk": strip_head(sd), "data_dir": data_dir, "tmp": tmp,
                "run": run, "stream_root": fresh_root(
                    ext_root, os.path.join(tmp, f"h_stream_root_{run}"))}

    one = h_paths(dev, None, inputs("one"))
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(minutes=5))
    try:
        nccl1 = h_paths(dev, dist.group.WORLD, inputs("nccl1"))
        cli = h_cli_in_group(dev, data_dir, sd, tmp)
    finally:
        dist.destroy_process_group()
    a = h_check("(h) world 1 over NCCL", [nccl1], one)
    out_dir = tempfile.mkdtemp(dir=tmp)
    t1 = time.perf_counter()
    mp.start_processes(_h_rank, args=(DP_RANKS_ON_ONE_CARD, _free_port(),
                                      inputs("gloo"), out_dir),
                       nprocs=DP_RANKS_ON_ONE_CARD, join=True,
                       start_method="spawn")
    gloo = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(DP_RANKS_ON_ONE_CARD)]
    log(f"[dp-h] {DP_RANKS_ON_ONE_CARD} gloo ranks spawned, ran and joined in "
        f"{time.perf_counter() - t1:.1f} s")
    b = h_check(f"(h) {DP_RANKS_ON_ONE_CARD} ranks on 1 card, gloo", gloo, one)
    if not os.path.exists(gloo[0]["qat"]["artifact"]):
        raise AssertionError("(h) rank 0 wrote no QAT artifact")
    log(f"[dp-h] phase 14 (h) in {time.perf_counter() - t0:.1f} s [{smi}]")
    return {"one": {k: one[k]["launches"] if k != "features" else
                    {r: v["launches"] for r, v in one[k].items()}
                    for k in ("ms", "ms_step", "qat", "stream", "features")},
            "nccl1": a, "gloo": b, "cli": cli}


def split_check(tag: str, run, want: dict, cells: int, batch: int,
                levels: int, dev) -> None:
    """The split path (``devices=``) on the one card: ``run([dev, dev])``
    (two replicas, each batch in two contiguous halves) against the
    one-device run ``want`` (score grids by name): the same tissue
    partition, every grid within the bf16 bound (cuDNN may take other
    algorithms for the halves), and 2a once per half a level."""
    import numpy as np

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
        NON_TISSUE_MARGIN,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.preprocess import (
        fused_normalize,
    )

    reset_counts()
    got = run([dev, dev])
    launches = fused_normalize.launches
    sizes = [batch] * (cells // batch) + ([cells % batch] if cells % batch
                                          else [])
    halves = sum(1 if k <= batch // 2 else 2 for k in sizes)
    err = 0.0
    for name, w in want.items():
        white = w == NON_TISSUE_MARGIN
        if not np.array_equal(got[name] == NON_TISSUE_MARGIN, white):
            raise AssertionError(f"{tag} split path: the {name} partition "
                                 "differs")
        err = max(err, float(np.abs(got[name] - w)[~white].max()))
    log(f"{tag} split over two replicas on the card: partitions equal, "
        f"max|Δ| {err:.4g} (bound {MODES_ATOL}); fused_normalize launches "
        f"{launches} = {halves} halves × {levels}")
    if err > MODES_ATOL or launches != halves * levels:
        raise AssertionError(f"{tag} split path differs from one device")


def phase_fleet(dev, sd, slide_path: str, smi, tmp) -> dict:
    """Phase 14 (d), (e): ``--predict_slide <dir> --group_size 1
    --tissue_filter device`` through the CLI's ``main`` over the smoke slide
    and a second seeded slide, against the slides run one after another
    (CSV bytes, 2a launches, walls); then ``predict_slide_fleet`` with two
    groups sharing the card (two threads), grids equal."""
    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.fleet import (
        predict_slide_fleet,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
        predict_and_export,
        predict_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
        save_npz_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.synthetic import (
        make_synthetic_slide,
        normal_spec,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        resnet18_from_state_dict,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.preprocess import (
        fused_normalize,
    )

    slide_dir = os.path.join(tmp, "fleet_slides")
    models_dir = os.path.join(tmp, "fleet_models")
    os.makedirs(slide_dir)
    os.makedirs(models_dir)
    os.link(slide_path, os.path.join(slide_dir, "smoke_slide.wsi.npz"))
    second = make_synthetic_slide(normal_spec(width=3584, height=2688,
                                              seed=SEED + 2))
    save_npz_slide(os.path.join(slide_dir, "second_slide.wsi.npz"),
                   [second.level_array(i) for i in range(second.level_count)])
    torch.save(sd, os.path.join(models_dir, "resnet18_patch_classifier.pt"))
    paths = sorted(os.path.join(slide_dir, f) for f in os.listdir(slide_dir))
    kw = dict(level=LEVEL, stride=STRIDE, tissue_filter="device")

    # the slides one after another, as the directory mode ran them before
    model = resnet18_from_state_dict(sd).to(
        device=dev, dtype=torch.bfloat16, memory_format=torch.channels_last)
    seq_dir = os.path.join(tmp, "fleet_sequential")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    seq = {p: predict_and_export(p, model, seq_dir, device=dev, **kw)[0]
           for p in paths}
    torch.cuda.synchronize()
    seq_wall = time.perf_counter() - t0
    seq_launches = fused_normalize.launches

    # (d) the CLI's directory mode, through the fleet
    argv = ["--predict_slide", slide_dir, "--group_size", "1",
            "--tissue_filter", "device", "--stride", str(STRIDE),
            "--models_dir", models_dir, "--device", "cuda"]
    reset_counts()  # counts from here on are the fleet path's
    rc, cli_wall = run_cli(argv)
    launches = fused_normalize.launches
    csv_dir = os.path.join(models_dir, "model_predictions_csv")
    read = lambda d: {f: open(os.path.join(d, f), "rb").read()  # noqa: E731
                      for f in sorted(os.listdir(d))}
    if rc != 0 or read(csv_dir) != read(seq_dir) or launches != seq_launches:
        raise AssertionError(
            f"(d) fleet CLI: exit {rc}, CSVs equal {read(csv_dir) == read(seq_dir)}"
            f", fused_normalize launches {launches} vs {seq_launches}")
    # (e) two groups, two threads, one card: a stream each
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grids = predict_slide_fleet(paths, model, os.path.join(tmp, "fleet_e"),
                                group_size=1, devices=[dev, dev], **kw)
    torch.cuda.synchronize()
    two_wall = time.perf_counter() - t0
    two_launches = fused_normalize.launches
    same = all(np.array_equal(grids[p], seq[p]) for p in paths)
    if not same or two_launches != seq_launches or read(
            os.path.join(tmp, "fleet_e")) != read(seq_dir):
        raise AssertionError(f"(e) two groups on one card: grids equal {same}, "
                             f"fused_normalize launches {two_launches} vs "
                             f"{seq_launches}")
    log(f"[fleet] (d) {' '.join(argv[:4])} … over {len(paths)} slides: exit 0, "
        f"CSVs byte-equal to the slides run in turn, fused_normalize launches "
        f"{launches} = {seq_launches}; walls: in turn {seq_wall:.3f} s, CLI "
        f"(load included) {cli_wall:.3f} s; (e) two groups sharing the card "
        f"(two threads, a stream each) {two_wall:.3f} s, grids and CSVs equal, "
        f"launches {two_launches} [{smi}]")
    # the smoke slide split over two replicas on the card; every cell
    # uploads under the device filter
    one = {"margin": predict_slide(paths[-1], model, device=dev,
                                   output="margin", **kw)[0]}
    split_check("[fleet]", lambda devs: {"margin": predict_slide(
        paths[-1], model, device=dev, devices=devs, output="margin",
        **kw)[0]}, one, one["margin"].size, BATCH, 1, dev)
    if torch.cuda.device_count() >= 2:
        fleet_split_check(dev, model, paths, kw)
    return {"launches": launches, "seq_wall": seq_wall, "cli_wall": cli_wall,
            "two_wall": two_wall}


def fleet_split_check(dev, model, paths, kw) -> None:
    """With two cards or more: each slide with every batch split over all
    the cards (``predict_slide(devices=...)``, a replica a card) against one
    card: the same tissue partition, margins within the bf16 bound (cuDNN
    may take other algorithms for the smaller batches), and the walls."""
    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
        cuda_devices,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
        NON_TISSUE_MARGIN,
        predict_slide,
        replicate_model,
    )

    cards = cuda_devices()
    models = replicate_model(model, cards)
    for path in paths:
        walls = {}
        for name, devs, m in (("one card", [dev], model),
                              (f"{len(cards)} cards", cards, models)):
            predict_slide(path, m, device=dev, devices=devs, output="margin",
                          **kw)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            walls[name] = predict_slide(path, m, device=dev, devices=devs,
                                        output="margin", **kw)[0]
            torch.cuda.synchronize()
            walls[name + " s"] = time.perf_counter() - t0
        one, split = walls["one card"], walls[f"{len(cards)} cards"]
        white = one == NON_TISSUE_MARGIN
        err = float(np.abs(split - one)[~white].max()) if (~white).any() else 0.0
        log(f"[fleet] {os.path.basename(path)} split over {len(cards)} cards: "
            f"partition equal {np.array_equal(split == NON_TISSUE_MARGIN, white)}, "
            f"max|Δ margin| {err:.4g} (bound {MODES_ATOL}); walls one card "
            f"{walls['one card s']:.3f} s, {len(cards)} cards "
            f"{walls[f'{len(cards)} cards s']:.3f} s")
        if not np.array_equal(split == NON_TISSUE_MARGIN, white) or \
                err > MODES_ATOL:
            raise AssertionError("a slide split over the cards differs from "
                                 "one card")


# ---------------------------------------------------------------------------
# Phase 15: tiled TIFF slides
# ---------------------------------------------------------------------------

#: the JPEG-YCbCr level 3 against its source pixels: mean and largest |Δ|.
#: 3584×2688 and 7168×5376 renders of the spec measured 0.52–0.61 and 24–26
#: on the CPU (libjpeg-turbo, 4:2:0 at quality 90; the largest errors sit
#: on tissue edges, where chroma is halved); the bounds are about twice that.
TIFF_JPEG_MEAN_MAX = 1.0
TIFF_JPEG_ABS_MAX = 48
TIFF_WALL_RUNS = 4  # warm predict_slide runs of each container, in turns
SECOND_W, SECOND_H = 3584, 2688  # phase 14's second fleet slide


def host_builds() -> dict:
    """Build the two host libraries (``io/native``) and time each; the
    libtiff route and version."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io import (
        native_lib,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        HOST_SOURCES,
        host_library,
        libtiff_route,
    )

    walls = {}
    for name in HOST_SOURCES:
        t0 = time.perf_counter()
        host_library(name)
        walls[name] = time.perf_counter() - t0
    route, flags = libtiff_route()
    return {"walls": walls, "route": route, "flags": " ".join(flags),
            "version": native_lib.libtiff_version()}


def regions_equal_plane(tiff, plane, level: int, edge: int = 512) -> int:
    """``read_regions`` of the level's ``edge``-px grid, ragged edge and one
    region wholly outside included, against the plane padded white; returns
    the regions read."""
    import numpy as np

    h, w = plane.shape[:2]
    xs, ys = np.arange(0, w, edge), np.arange(0, h, edge)
    coords = np.array([(x, y) for x in xs for y in ys] + [(w, h)], np.int64)
    padded = np.full((len(ys) * edge + edge, len(xs) * edge + edge, 3), 255,
                     np.uint8)
    padded[:h, :w] = plane
    for i in range(0, len(coords), 256):  # bounded host memory at level 0
        part = coords[i:i + 256]
        got = tiff.read_regions(part, level, (edge, edge))
        for k, (x, y) in enumerate(part):
            if not np.array_equal(got[k], padded[y:y + edge, x:x + edge]):
                raise AssertionError(f"read_regions differs at level {level} "
                                     f"({x}, {y})")
    return len(coords)


def band_decode_ms(slide, grid) -> list[float]:
    """ms of each full-width band read of ``predict_slide``'s loop."""
    level_w, level_h = slide.level_dimensions[grid.level]
    out = []
    for iy in range(grid.ny):
        y = iy * grid.stride
        t0 = time.perf_counter()
        slide.read_region(grid.level0_origin(0, y), grid.level,
                          (level_w, min(grid.patch_size, level_h - y)))
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_tiff(dev, sd, spec, slide, grid, host_margins, npz_path, train,
               ext_root, fleet, built, smi, tmp) -> dict:
    """Phase 15: the smoke slide as tiled BigTIFFs through the main path
    (see the module docstring)."""
    import shutil
    import threading

    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.streamed import (
        extract_patches_on_device,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation.froc import (
        compute_evaluation_mask,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.fleet import (
        predict_slide_fleet,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
        NON_TISSUE_MARGIN,
        predict_and_export,
        predict_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
        open_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.synthetic import (
        normal_spec,
        write_mask_tiff,
        write_synthetic_case,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.tiff_slide import (
        TiffSlide,
        write_pyramidal_tiff,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        resnet18_from_state_dict,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.preprocess import (
        fused_normalize,
    )

    t_phase = time.perf_counter()
    # (a) the host build
    log(f"[tiff] (a) libtiff: {built['version']}; route: {built['route']} "
        f"({built['flags']}); host builds: chunk {built['walls']['chunk']:.2f} s"
        f" (OpenMP only), tiff {built['walls']['tiff']:.2f} s")

    # (b) the smoke slide written as tiled BigTIFFs: the rendered pyramid
    # through the writer that write_synthetic_case(container="tiff") calls
    # (which would first render the 154-megapixel slide again; (g) runs
    # write_synthetic_case on the second slide)
    paths, walls = {}, {}
    levels = [slide.level_array(i) for i in range(slide.level_count)]
    for comp in ("deflate", "jpeg_ycbcr"):
        paths[comp] = os.path.join(tmp, f"tiff_{comp}", "smoke_slide.tif")
        os.makedirs(os.path.dirname(paths[comp]))
        t0 = time.perf_counter()
        write_pyramidal_tiff(paths[comp], levels, compression=comp)
        walls[comp] = time.perf_counter() - t0
    tiff = TiffSlide(paths["deflate"])
    regions = 0
    for level in range(slide.level_count):
        plane = slide.level_array(level)
        if not np.array_equal(tiff.read_region((0, 0), level,
                                               tiff.level_dimensions[level]),
                              plane):
            raise AssertionError(f"deflate TIFF level {level} differs from "
                                 "the .wsi.npz plane")
        regions += regions_equal_plane(tiff, plane, level)
    tiff.close()
    jpeg = TiffSlide(paths["jpeg_ycbcr"])
    diff = np.abs(jpeg.read_region((0, 0), LEVEL, jpeg.level_dimensions[LEVEL])
                  .astype(np.int16) - slide.level_array(LEVEL))
    jpeg.close()
    mb = {c: os.path.getsize(p) / 1e6 for c, p in paths.items()}
    log(f"[tiff] (b) write_pyramidal_tiff of the rendered pyramid: deflate "
        f"{walls['deflate']:.1f} s ({mb['deflate']:.1f} MB), jpeg_ycbcr "
        f"{walls['jpeg_ycbcr']:.1f} s ({mb['jpeg_ycbcr']:.1f} MB); deflate: "
        f"{slide.level_count} levels equal to the .wsi.npz "
        f"planes by read_region and by read_regions ({regions} regions of "
        f"512², white past the edges); jpeg_ycbcr level {LEVEL} against its "
        f"source: mean |Δ| {diff.mean():.4f} (bound {TIFF_JPEG_MEAN_MAX}), "
        f"max |Δ| {int(diff.max())} (bound {TIFF_JPEG_ABS_MAX})")
    if diff.mean() > TIFF_JPEG_MEAN_MAX or diff.max() > TIFF_JPEG_ABS_MAX:
        raise AssertionError("the JPEG-YCbCr TIFF is outside its bound")

    # (c) --predict_slide on the deflate TIFF against the .wsi.npz
    runs = {}
    for kind, src in (("npz", npz_path), ("tif", paths["deflate"])):
        img = os.path.join(tmp, f"tiff_c_{kind}")
        models = os.path.join(tmp, f"tiff_c_models_{kind}")
        os.makedirs(img)
        os.makedirs(models)
        target = os.path.join(img, os.path.basename(src))
        os.link(src, target)
        torch.save(sd, os.path.join(models, "resnet18_patch_classifier.pt"))
        reset_counts()  # counts from here on are this run's
        rc, wall = run_cli(["--predict_slide", target, "--tissue_filter",
                            "device", "--stride", str(STRIDE), "--models_dir",
                            models, "--device", "cuda"])
        csv = os.path.join(models, "model_predictions_csv", "smoke_slide.csv")
        runs[kind] = (rc, fused_normalize.launches, open(csv, "rb").read(), wall)
    batches = -(-grid.num_patches // BATCH)
    if (runs["tif"][0] or runs["npz"][0] or runs["tif"][2] != runs["npz"][2]
            or runs["tif"][1] != runs["npz"][1] or runs["tif"][1] != batches):
        raise AssertionError(
            f"(c) TIFF against .wsi.npz: exits {runs['tif'][0]}/{runs['npz'][0]},"
            f" CSVs equal {runs['tif'][2] == runs['npz'][2]}, 2a launches "
            f"{runs['tif'][1]}/{runs['npz'][1]} (expected {batches})")
    model = resnet18_from_state_dict(sd).to(
        device=dev, dtype=torch.bfloat16, memory_format=torch.channels_last)
    kw = dict(level=LEVEL, stride=STRIDE, tissue_filter="device",
              output="margin", device=dev)
    src = {"npz": npz_path, "tif": paths["deflate"]}
    for kind in src:
        predict_slide(src[kind], model, **kw)  # warm
    turns = {"npz": [], "tif": []}
    for _ in range(TIFF_WALL_RUNS // 2):
        for kind in ("npz", "tif", "tif", "npz"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predict_slide(src[kind], model, **kw)
            torch.cuda.synchronize()
            turns[kind].append(time.perf_counter() - t0)
    med = {k: statistics.median(v) for k, v in turns.items()}
    dec = {}
    for kind in src:
        s = open_slide(src[kind])
        cold = band_decode_ms(s, grid)
        warm = band_decode_ms(s, grid)
        stats = s.cache_stats() if kind == "tif" else None
        s.close()
        dec[kind] = (cold, warm, stats)
    log(f"[tiff] (c) --predict_slide <smoke_slide.tif> --tissue_filter device "
        f"through the CLI's main: exit 0 in {runs['tif'][3]:.2f} s (.wsi.npz "
        f"{runs['npz'][3]:.2f} s, model load included); CSV byte-equal to the "
        f".wsi.npz run's; fused_normalize launches {runs['tif'][1]} = "
        f"{runs['npz'][1]}; warm predict_slide in turns ({TIFF_WALL_RUNS} each):"
        f" TIFF {med['tif']:.4f} s ({min(turns['tif']):.4f}–"
        f"{max(turns['tif']):.4f}) = {grid.num_patches / med['tif']:.0f} "
        f"cells/s, .wsi.npz {med['npz']:.4f} s ({min(turns['npz']):.4f}–"
        f"{max(turns['npz']):.4f}) = {grid.num_patches / med['npz']:.0f} "
        f"cells/s; a band read ({grid.ny} bands of {grid.patch_size} rows): "
        f"TIFF cold {statistics.median(dec['tif'][0]):.3f} ms (sum "
        f"{sum(dec['tif'][0]):.1f}), warm {statistics.median(dec['tif'][1]):.3f}"
        f" ms, tile cache after both passes {dec['tif'][2]}; .wsi.npz "
        f"{statistics.median(dec['npz'][0]):.3f} ms (sum "
        f"{sum(dec['npz'][0]):.1f}) [{smi}]")

    # (d) the JPEG-YCbCr TIFF: single level, then multiscale
    reset_counts()
    jm = predict_slide(paths["jpeg_ycbcr"], model, **kw)[0]
    j_launches = fused_normalize.launches
    npz_tissue = host_margins != NON_TISSUE_MARGIN
    j_tissue = jm != NON_TISSUE_MARGIN
    flips = int((npz_tissue != j_tissue).sum())
    ms_models = os.path.join(tmp, "tiff_ms_models")
    os.makedirs(ms_models)
    os.link(os.path.join(tmp, "ms_models", "hierarchical_classifier.pt"),
            os.path.join(ms_models, "hierarchical_classifier.pt"))
    reset_counts()
    rc, ms_wall = run_cli(["--predict_slide", paths["jpeg_ycbcr"],
                           "--multiscale", "--levels",
                           ",".join(map(str, MS_LEVELS)), "--stride",
                           str(STRIDE), "--batch_size", str(MS_BATCH),
                           "--models_dir", ms_models, "--device", "cuda"])
    ms_launches = fused_normalize.launches
    want_ms = len(MS_LEVELS) * -(-int(j_tissue.sum()) // MS_BATCH)
    log(f"[tiff] (d) jpeg_ycbcr TIFF: tissue partition {int(j_tissue.sum())} "
        f"cells, {flips} differ from the .wsi.npz partition's "
        f"{int(npz_tissue.sum())}; fused_normalize launches {j_launches}; "
        f"--predict_slide --multiscale --levels 2,3 through the CLI's main: "
        f"exit {rc} in {ms_wall:.2f} s, fused_normalize launches {ms_launches} "
        f"({len(MS_LEVELS)} a batch of {MS_BATCH})")
    if j_launches != batches or rc != 0 or ms_launches != want_ms:
        raise AssertionError(f"(d) launches {j_launches} (expected {batches}),"
                             f" multiscale exit {rc}, launches {ms_launches} "
                             f"(expected {want_ms})")

    # (e) --patch from the deflate TIFF on both routes against phase 13's
    # stores of the same pyramid as .wsi.npz
    src_root = os.path.join(tmp, "tiff_extract_src")
    os.makedirs(os.path.join(src_root, "train", "img"))
    os.link(paths["deflate"], os.path.join(src_root, "train", "img",
                                           "tumor_001.tif"))
    os.makedirs(os.path.join(src_root, "annotations"))
    shutil.copy(os.path.join(ext_root, "annotations", "tumor_001.xml"),
                os.path.join(src_root, "annotations"))
    e_walls = {}
    for route in ("host", "device"):
        root = fresh_root(src_root, os.path.join(tmp, f"tiff_extract_{route}"))
        before = extract_patches_on_device.calls
        with _Messages("data.extract") as records:
            rc, e_walls[route] = run_cli(["--patch", "--patch_level", "all",
                                          "--extract_impl", route,
                                          "--data_dir", root, "--device",
                                          "cuda"])
        calls = extract_patches_on_device.calls - before
        per_level = level_walls(records)
        if rc != 0 or calls != (len(EXTRACT_LEVELS) if route == "device" else 0):
            raise AssertionError(f"(e) --patch {route} from TIFF: exit {rc}, "
                                 f"device extractions {calls}")
        for level in EXTRACT_LEVELS:
            rows, recs = store_rows(root, level)
            want_rows, want_recs = store_rows(os.path.join(
                tmp, f"extract_{route}"), level)
            want_rows = [r for r in want_rows if r[0] == "tumor_001"]
            want_recs = [r for r in want_recs if r.slide == "tumor_001"]
            if rows != want_rows or pack_bytes(recs) != pack_bytes(want_recs):
                raise AssertionError(f"(e) {route} level {level}: the TIFF's "
                                     "store differs from the .wsi.npz's")
        log(f"[tiff] (e) --patch --patch_level all --extract_impl {route} from "
            f"tumor_001.tif: exit 0 in {e_walls[route]:.2f} s (levels: "
            + ", ".join(f"L{lv} {s:.3f} s" for (_n, lv), s in
                        sorted(per_level.items(), key=lambda kv: kv[0][1]))
            + f"); device extractions {calls}; every level's rows and bytes "
            f"equal to phase 13's .wsi.npz store of tumor_001")

    # (f) FROC with the mask as the port's {case}_Mask.tif
    data = os.path.join(tmp, "tiff_froc_data")
    img = os.path.join(data, "test", "img")
    os.makedirs(img)
    os.link(paths["deflate"], os.path.join(img, "smoke_slide.tif"))
    t0 = time.perf_counter()
    mask_tif = write_mask_tiff(os.path.join(data, "test", "mask"),
                               "smoke_slide", spec)
    mask_wall = time.perf_counter() - t0
    # the same classifier on the .wsi.npz with the .npy mask (phase 10's
    # data root); phase 10's own CSV has since been overwritten by later
    # phases' runs in its models directory
    found = {}
    for kind, img_dir, data_dir in (
            ("tif", img, data),
            ("npz", os.path.join(train["data_dir"], "train", "img"),
             train["data_dir"])):
        models = os.path.join(tmp, f"tiff_froc_models_{kind}")
        os.makedirs(models)
        shutil.copy(os.path.join(train["models_dir"],
                                 "resnet18_patch_classifier.pt"), models)
        with _Messages("evaluation.froc") as records:
            rc, f_wall = run_cli(["--predict_slide", img_dir, "--run_evaluation",
                                  "--data_dir", data_dir, "--models_dir",
                                  models, "--stride", str(STRIDE),
                                  "--tissue_filter", "device", "--device",
                                  "cuda"])
        scores = [r.args[0] for r in records
                  if r.msg.startswith("FROC score")]
        csv = open(os.path.join(models, "model_predictions_csv",
                                "smoke_slide.csv"), "rb").read()
        found[kind] = (rc, scores, csv, f_wall)
    npy_dir = os.path.join(train["data_dir"], "test", "mask")
    same_mask = np.array_equal(
        compute_evaluation_mask(mask_tif),
        compute_evaluation_mask(np.load(os.path.join(npy_dir,
                                                     "smoke_slide_mask.npy"))))
    log(f"[tiff] (f) --predict_slide <dir of smoke_slide.tif> --run_evaluation"
        f" from phase 10's classifier, mask smoke_slide_Mask.tif (6 levels, "
        f"written in {mask_wall:.2f} s): exit {found['tif'][0]} in "
        f"{found['tif'][3]:.2f} s; FROC score {found['tif'][1]}; the .wsi.npz "
        f"with the .npy mask {found['npz'][1]} (exit {found['npz'][0]}); phase "
        f"10's {train['froc']!r}; CSVs byte-equal "
        f"{found['tif'][2] == found['npz'][2]}; evaluation masks equal "
        f"{same_mask}")
    if (found["tif"][0] != 0 or found["npz"][0] != 0
            or len(found["tif"][1]) != 1 or found["tif"][1] != found["npz"][1]
            or found["tif"][1][0] != train["froc"]
            or found["tif"][2] != found["npz"][2] or not same_mask):
        raise AssertionError("(f) FROC with the TIFF mask differs")

    # (g) the fleet over two TIFF slides
    fleet_dir = os.path.join(tmp, "tiff_fleet")
    os.makedirs(fleet_dir)
    os.link(paths["deflate"], os.path.join(fleet_dir, "smoke_slide.tif"))
    t0 = time.perf_counter()
    second = write_synthetic_case(
        os.path.join(tmp, "tiff_second"), "second_slide",
        normal_spec(width=SECOND_W, height=SECOND_H, seed=SEED + 2),
        container="tiff")
    second_wall = time.perf_counter() - t0
    os.link(second, os.path.join(fleet_dir, "second_slide.tif"))
    models = os.path.join(tmp, "tiff_fleet_models")
    os.makedirs(models)
    torch.save(sd, os.path.join(models, "resnet18_patch_classifier.pt"))
    fkw = dict(level=LEVEL, stride=STRIDE, tissue_filter="device")
    fpaths = sorted(os.path.join(fleet_dir, f) for f in os.listdir(fleet_dir))
    seq_dir = os.path.join(tmp, "tiff_fleet_seq")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = {p: predict_and_export(p, model, seq_dir, device=dev, **fkw)[0]
           for p in fpaths}
    torch.cuda.synchronize()
    seq_wall = time.perf_counter() - t0
    reset_counts()  # counts from here on are the TIFF fleet path's
    rc, cli_wall = run_cli(["--predict_slide", fleet_dir, "--group_size", "1",
                            "--tissue_filter", "device", "--stride",
                            str(STRIDE), "--models_dir", models, "--device",
                            "cuda"])
    f_launches = fused_normalize.launches
    read = lambda d: {f: open(os.path.join(d, f), "rb").read()  # noqa: E731
                      for f in sorted(os.listdir(d))}
    fleet_csvs = read(os.path.join(models, "model_predictions_csv"))
    npz_csvs = read(os.path.join(tmp, "fleet_models", "model_predictions_csv"))
    stats, lock = {}, threading.Lock()

    def counted(path, models_, *, devices, **kw_):
        s = TiffSlide(path)
        try:
            return predict_slide(s, models_, device=devices[0],
                                 devices=devices, **kw_)
        finally:
            with lock:
                stats[os.path.basename(path)] = s.cache_stats()
            s.close()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grids = predict_slide_fleet(fpaths, model, os.path.join(tmp, "tiff_fleet_e"),
                                group_size=1, devices=[dev, dev],
                                predict_fn=counted, **fkw)
    torch.cuda.synchronize()
    two_wall = time.perf_counter() - t0
    same = all(np.array_equal(grids[p], seq[p]) for p in fpaths)
    log(f"[tiff] (g) write_synthetic_case(container='tiff') of phase 14's "
        f"second slide ({SECOND_W}×{SECOND_H}, deflate): {second_wall:.2f} s, "
        f"rendering included; --predict_slide <dir of 2 TIFFs> --group_size 1 "
        f"through the CLI's main: exit {rc}, CSVs byte-equal to phase 14's "
        f".wsi.npz "
        f"fleet {fleet_csvs == npz_csvs} and to the slides in turn "
        f"{fleet_csvs == read(seq_dir)}; fused_normalize launches {f_launches}"
        f" (phase 14: {fleet['launches']}); walls TIFF / .wsi.npz (phase 14): "
        f"in turn {seq_wall:.3f} / {fleet['seq_wall']:.3f} s, CLI "
        f"{cli_wall:.3f} / {fleet['cli_wall']:.3f} s, two groups sharing the "
        f"card {two_wall:.3f} / {fleet['two_wall']:.3f} s (two groups / in "
        f"turn: {two_wall / seq_wall:.3f} / "
        f"{fleet['two_wall'] / fleet['seq_wall']:.3f}); grids equal {same}; "
        f"tile cache (two groups) {stats}")
    if (rc != 0 or fleet_csvs != npz_csvs or fleet_csvs != read(seq_dir)
            or f_launches != fleet["launches"] or not same):
        raise AssertionError("(g) the TIFF fleet differs")
    log(f"[tiff] phase 15 wall {time.perf_counter() - t_phase:.1f} s")
    return {"launches": runs["tif"][1], "jpeg_launches": j_launches,
            "multiscale_launches": ms_launches, "fleet_launches": f_launches,
            "deflate": paths["deflate"]}


def phase_tiff_profile(dev, sd, path) -> None:
    """One warm ``predict_slide`` of the deflate TIFF under the profiler:
    device busy time and idle share (last in the run: walls taken after a
    profiler session come out longer)."""
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
        predict_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        resnet18_from_state_dict,
    )

    model = resnet18_from_state_dict(sd).to(
        device=dev, dtype=torch.bfloat16, memory_format=torch.channels_last)
    kw = dict(level=LEVEL, stride=STRIDE, tissue_filter="device", device=dev)
    predict_slide(path, model, **kw)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict_slide(path, model, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = busy_us(prof) / 1e3
    log(f"[tiff] one warm predict_slide of the deflate TIFF under the "
        f"profiler: wall {wall:.1f} ms, device busy {busy:.1f} ms, idle share "
        f"{1 - busy / wall:.3f}")
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")


# ---------------------------------------------------------------------------
# phase 15 (h): --overlay on the card; phase 16: the legacy models and the
# tools of slice 16
# ---------------------------------------------------------------------------

def phase_overlay(dev, sd, slide_path, tmp) -> dict:
    """Phase 15 (h): ``--predict_slide <tif> --overlay`` through the CLI's
    ``main`` (Pillow alone: no matplotlib on this machine): exit 0, and the
    PNG equal, pixel for pixel, to the slide's coarsest level blended at 0.4
    with the rainbow table of the probability grid (the same grid from
    ``predict_and_export`` in this process) resized bilinearly over it."""
    import numpy as np
    import torch
    from PIL import Image

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.overlay import (
        _colormap_rainbow,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
        predict_and_export,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
        open_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        resnet18_from_state_dict,
    )

    try:
        import matplotlib  # noqa: F401
        has_mpl = True
    except ImportError:
        has_mpl = False
    models = os.path.join(tmp, "overlay_models")
    os.makedirs(models)
    torch.save(sd, os.path.join(models, "resnet18_patch_classifier.pt"))
    rc, wall = run_cli(["--predict_slide", slide_path, "--overlay",
                        "--tissue_filter", "device", "--models_dir", models,
                        "--device", "cuda"])
    png = os.path.join(models, "overlays",
                       os.path.basename(slide_path) + ".overlay.png")
    if rc != 0 or not os.path.exists(png):
        raise AssertionError(f"--overlay: exit {rc}, PNG written "
                             f"{os.path.exists(png)}")
    model = resnet18_from_state_dict(sd).to(
        device=dev, dtype=torch.bfloat16, memory_format=torch.channels_last)
    grid, _ = predict_and_export(slide_path, model,
                                 os.path.join(tmp, "overlay_csv"), level=LEVEL,
                                 device=dev, devices=[dev],
                                 tissue_filter="device")
    slide = open_slide(slide_path)
    try:
        top = slide.level_count - 1
        w, h = slide.level_dimensions[top]
        thumb = slide.read_region((0, 0), top, (w, h))
    finally:
        slide.close()
    heat = Image.fromarray(_colormap_rainbow(grid)).resize((w, h),
                                                           Image.BILINEAR)
    want = np.asarray(Image.blend(Image.fromarray(thumb), heat, 0.4))
    with Image.open(png) as im:
        got = np.asarray(im)
    if not np.array_equal(got, want):
        raise AssertionError("the overlay PNG differs from the rainbow table's "
                             "blend of the grid")
    log(f"[tiff] (h) --predict_slide {os.path.basename(slide_path)} --overlay "
        f"(matplotlib on this machine: {has_mpl}): exit 0 in {wall:.2f} s; "
        f"the {w}×{h} PNG equal to the slide's level {top} blended with the "
        f"rainbow table of the {grid.shape[0]}×{grid.shape[1]} grid")
    return {"wall": wall, "matplotlib": has_mpl}


LEGACY_RTOL = 1e-4  # card float32 (TF32 off) against the CPU, of max|out|
EXPORT_RTOL = 1e-6  # the exported program against the module, of max|out|


def _legacy_forwards(dev) -> dict:
    """ResNet50, UNetClassifier and CNNEncoder from seeds: the card's float32
    forward (TF32 off) against the CPU's on the same inputs; the largest
    difference over max|out|, and the card's ms a forward."""
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.cnn_encoder import (
        CNNEncoder,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
        ResNet50,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.unet import (
        UNetClassifier,
    )

    g = torch.Generator().manual_seed(SEED)
    cases = [("ResNet50", ResNet50(num_classes=2, generator=g), (4, 224, 224)),
             ("UNetClassifier", UNetClassifier(num_classes=10, generator=g),
              (2, 128, 128)),
             ("CNNEncoder", CNNEncoder(generator=g), (4, 224, 224))]
    out = {}
    for name, model, (b, hh, ww) in cases:
        model.eval()
        x = torch.randn(b, hh, ww, 3, generator=g)
        with torch.no_grad():
            want = model(x)
            card = model.to(dev)
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                got = card(x.to(dev))
                ms = statistics.median(cuda_ms(lambda: card(x.to(dev)), 5))
        err = ((got.cpu() - want).abs().max() / want.abs().max()).item()
        out[name] = {"rel_err": err, "ms": ms, "shape": tuple(got.shape)}
        if err > LEGACY_RTOL:
            raise AssertionError(f"{name} on the card {err:.3g} of max|out| "
                                 f"from the CPU (bound {LEGACY_RTOL})")
    return out


def _generic_export(dev, tmp) -> dict:
    """``GenericClassifierTrainer`` fitting a width-16 UNetClassifier on the
    card for two epochs of a toy set, then ``export``, ``torch.export.load``
    and the reloaded program against the module."""
    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.unet import (
        UNetClassifier,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.generic_classifier import (
        ArrayDataset,
        GenericClassifierTrainer,
    )

    rng = np.random.default_rng(SEED)
    labels = rng.integers(0, 2, 160)
    images = np.clip(np.where(labels[:, None, None, None] == 1, 180, 70)
                     + rng.normal(0, 20, (160, 32, 32, 3)), 0,
                     255).astype(np.uint8)
    ds = ArrayDataset.from_arrays(images, labels.astype(np.int32))
    trainer = GenericClassifierTrainer(
        UNetClassifier(2, (16, 32), generator=torch.Generator().manual_seed(SEED)),
        (8, 32, 32, 3), 2, learning_rate=1e-2, device=dev)
    history = trainer.fit(ds, epochs=2, batch_size=16)
    acc = trainer.evaluate(ds.test_x, ds.test_y)
    path = os.path.join(tmp, "generic", "model.pt2")
    trainer.export(path)
    program = torch.export.load(path).module()
    x = torch.from_numpy(ds.test_x[:8].astype(np.float32) / 255.0).to(dev)
    with torch.no_grad():
        got, want = program(x), trainer.model.eval()(x)
    err = ((got - want).abs().max() / want.abs().max()).item()
    if not all(np.isfinite(h["loss"]) for h in history) or err > EXPORT_RTOL:
        raise AssertionError(f"GenericClassifierTrainer: losses {history}, "
                             f"exported program {err:.3g} of max|out| off")
    return {"losses": [h["loss"] for h in history], "test_acc": acc,
            "export_err": err, "bytes": os.path.getsize(path)}


def phase_legacy_tools(dev, train, smi, tmp) -> dict:
    """Phase 16: the legacy models on the card against the CPU, the generic
    trainer with its export, and the CLI's ``--prepare``, ``--validation``,
    ``--extract_features --profile`` (the Chrome trace names the 2b kernel)
    and ``--validate [--tsne_full] --device cuda`` (exit 0, the accuracy
    line logged, scikit-learn never loaded)."""
    import zipfile

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        DataConfig,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.fused_stem import (
        bias_relu_pool_kernel,
    )

    t0 = time.perf_counter()
    legacy = _legacy_forwards(dev)
    log("[legacy] card float32 (TF32 off) against the CPU: " + "; ".join(
        f"{k} {tuple(v['shape'])} {v['rel_err']:.3g} of max|out|, "
        f"{v['ms']:.2f} ms a forward" for k, v in legacy.items())
        + f" (bound {LEGACY_RTOL}) [{smi}]")
    gen = _generic_export(dev, tmp)
    log(f"[legacy] GenericClassifierTrainer on the card: epoch losses "
        f"{[round(v, 4) for v in gen['losses']]}, test accuracy "
        f"{gen['test_acc']:.3f}; torch.export program ({gen['bytes']} bytes) "
        f"reloaded, {gen['export_err']:.3g} of max|out| from the module")

    # --prepare on a zip of XMLs
    root = os.path.join(tmp, "prepare")
    zpath = os.path.join(root, "train", "mask", "lesion_annotations.zip")
    os.makedirs(os.path.dirname(zpath))
    names = [f"tumor_{i:03d}.xml" for i in range(1, 51)]
    with zipfile.ZipFile(zpath, "w") as zf:
        for n in names:
            zf.writestr(n, f"<ASAP_Annotations>{n}</ASAP_Annotations>")
    rc, wall = run_cli(["--prepare", "--data_dir", root])
    got = sorted(os.listdir(DataConfig(data_dir=root).annotations_dir))
    if rc != 0 or got != names:
        raise AssertionError(f"--prepare: exit {rc}, {len(got)} XMLs")
    log(f"[tools] --prepare: exit 0 in {wall:.2f} s, {len(got)} XMLs extracted")

    # --validation on phase 10's store
    data_dir = train["data_dir"]
    with _Messages("torch.cli") as records:
        rc, wall = run_cli(["--validation", "--data_dir", data_dir])
    split = [r.getMessage() for r in records
             if r.getMessage().startswith("Validation split")]
    if rc != 0 or len(split) != 1:
        raise AssertionError(f"--validation: exit {rc}, {split}")
    log(f"[tools] --validation: exit 0 in {wall:.2f} s; {split[0]}")

    # --extract_features --profile: the Chrome trace names the 2b kernel
    log_dir = os.path.join(tmp, "profile_logs")
    cfg_path = os.path.join(tmp, "profile.json")
    with open(cfg_path, "w") as f:
        json.dump({"log_dir": log_dir}, f)
    reset_counts()
    rc, wall = run_cli(["--extract_features", "--profile", "--config",
                        cfg_path, "--data_dir", data_dir, "--models_dir",
                        train["models_dir"], "--device", "cuda"])
    launches = bias_relu_pool_kernel.launches
    trace_path = os.path.join(log_dir, "profile", "trace.json")
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    named = sorted(k for k in kernels if "bias_relu_pool" in k)
    if rc != 0 or not named or launches == 0:
        raise AssertionError(f"--extract_features --profile: exit {rc}, 2b "
                             f"launches {launches}, trace kernels naming it "
                             f"{named}")
    log(f"[tools] --extract_features --profile: exit 0 in {wall:.2f} s; "
        f"{os.path.getsize(trace_path) / 1e6:.1f} MB Chrome trace with "
        f"{len(kernels)} kernel names, {named[0]!r} among them; "
        f"bias_relu_pool launches {launches}")

    # --validate and --validate --tsne_full on the card: no scikit-learn
    for extra in ([], ["--tsne_full"]):
        with _Messages("evaluation.features") as records:
            rc, wall = run_cli(["--validate", *extra, "--data_dir", data_dir,
                                "--device", "cuda"])
        acc = [r.getMessage() for r in records
               if r.getMessage().startswith("Logistic Regression Accuracy")]
        if rc != 0 or len(acc) != 1 or "sklearn" in sys.modules:
            raise AssertionError(f"--validate {extra}: exit {rc}, {acc}, "
                                 f"sklearn loaded: {'sklearn' in sys.modules}")
        log(f"[tools] {' '.join(['--validate', *extra, '--device', 'cuda'])}"
            f": exit 0 in {wall:.2f} s, {acc[0]}; sklearn not loaded")
    log(f"[tools] phase 16 in {time.perf_counter() - t0:.1f} s")
    return {"legacy": legacy, "generic": gen, "bias_relu_pool": launches}


# ---------------------------------------------------------------------------
# phase 17: int8 split over devices without a tree, the download actions,
# --compile_cache_dir
# ---------------------------------------------------------------------------


def split_part_launches(tissue: int, batch: int, parts: int) -> int:
    """The non-empty parts of ``tissue`` cells in batches of ``batch``, each
    split in contiguous parts of ``batch // parts`` rows."""
    per = batch // parts
    full, rest = divmod(tissue, batch)
    return full * parts + -(-rest // per)


class _LoopbackFiles:
    """An HTTP server on 127.0.0.1 serving ``files`` (path → bytes), 404
    for the rest, recording the paths asked for; a context."""

    def __init__(self, files: dict):
        import http.server
        import threading

        self.files, self.requests = files, []
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.lstrip("/")
                outer.requests.append(path)
                body = outer.files.get(path)
                if body is None:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join()


def _cache_files(path: str) -> dict:
    """Each library in a cache directory → (inode, mtime in ns)."""
    out = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".so"):
            st = os.stat(os.path.join(path, name))
            out[name] = (st.st_ino, st.st_mtime_ns)
    return out


def _same_tree(a, b) -> bool:
    """Two quantized trees (nested dicts of tensors) equal bit for bit."""
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_same_tree, a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a.cpu(), b.cpu())
    return a == b


def phase_parity_gaps(dev, sd, spec, npz_path, tiff_path, ms_models,
                      host_margins, tmp) -> dict:
    """Phase 17 (see the module docstring): returns the int8 kernels'
    launches of (a) and (b), one device and split."""
    import zipfile

    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.multiscale import (
        HEAD_ROWS,
        predict_and_export_multiscale,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
        NON_TISSUE_MARGIN,
        predict_and_export,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io import (
        download,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.annotations import (
        write_annotation_xml,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.synthetic import (
        polygons_level0,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        hierarchical_from_state_dict,
        resnet18_from_state_dict,
        split_calibration,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        SOURCES,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
        load_model,
        model_artifact_path,
    )

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "p17")
    stage1, conv, pool = int8_launchers()
    counts = lambda: (stage1.launches, conv.launches, pool.launches)  # noqa: E731
    tissue = int((host_margins != NON_TISSUE_MARGIN).sum())

    def one_and_split(tag, export, model, batch, **kw):
        """``export`` without a tree on one device, then split over two,
        each run's lazily calibrated tree captured: CSV bytes, launches and
        walls. The two trees and the two CSVs must be equal."""
        from ss25_hierarchical_multiscale_image_classification_tpu_torch.models import (
            quantized,
        )

        out, trees = {}, []
        real = quantized.quantize_resnet18

        def spy(*args, **kwargs):
            q = real(*args, **kwargs)
            trees.append(q.tree())
            return q

        quantized.quantize_resnet18 = spy
        try:
            for name, devices in (("one", [dev]), ("split", [dev, dev])):
                csv_dir = os.path.join(root, f"{tag}_{name}")
                reset_counts()  # counts from here on are this run's
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                probs, csv_path = export(npz_path, model, csv_dir,
                                         batch_size=batch, int8=True,
                                         device=dev, devices=devices, **kw)
                torch.cuda.synchronize()
                with open(csv_path, "rb") as f:
                    out[name] = (f.read(), counts(), time.perf_counter() - t0,
                                 probs)
        finally:
            quantized.quantize_resnet18 = real
        (csv1, n1, w1, p1), (csv2, n2, w2, p2) = out["one"], out["split"]
        same_tree = len(trees) == 2 and _same_tree(trees[0], trees[1])
        batches = -(-tissue // batch)
        parts = split_part_launches(tissue, batch, 2)
        d = float(np.abs(p1 - p2).max())
        log(f"[p17] ({tag}) int8 without a tree, batch {batch}: one device "
            f"{w1:.2f} s, launches fused_stage1_int8 {n1[0]}, "
            f"int8_conv_requant {n1[1]}, int8_maxpool {n1[2]}; split over "
            f"[{dev}, {dev}] {w2:.2f} s, launches {n2[0]}, {n2[1]}, {n2[2]}; "
            f"the two lazily calibrated trees equal: {same_tree}; CSV "
            f"{len(csv1)} bytes, byte-equal: {csv1 == csv2}; probability "
            f"grids max|Δ| {d:.3g}")
        if n1 != (batches, 16 * batches, batches):
            raise AssertionError(f"({tag}) one device: expected {batches}, "
                                 f"{16 * batches} and {batches} launches, "
                                 f"counted {n1}")
        if n2 != (parts, 16 * parts, parts):
            raise AssertionError(f"({tag}) split: expected {parts}, "
                                 f"{16 * parts} and {parts} launches, counted "
                                 f"{n2}")
        if not (same_tree and csv1 and csv1 == csv2):
            raise AssertionError(f"({tag}) the split run differs from one "
                                 "device's")
        return {"one": n1, "split": n2}

    # (a) the single-level producer, float32 model as the CLI's --int8 loads it
    model = resnet18_from_state_dict(sd).to(device=dev,
                                            memory_format=torch.channels_last)
    single = one_and_split("a", predict_and_export, model, BATCH,
                           level=LEVEL, stride=STRIDE)
    del model
    # (b) multiscale from phase 11's artifact; the float heads run in calls
    # of HEAD_ROWS rows, so the split's scores are one device's too
    state, cal = split_calibration(load_model(model_artifact_path(
        ms_models, "hierarchical_classifier")))
    m32 = hierarchical_from_state_dict(state, MS_LEVELS).for_inference(
        dev, torch.float32)
    multi = one_and_split("b", predict_and_export_multiscale, m32, MS_BATCH,
                          levels=MS_LEVELS, stride=STRIDE, calibration=cal)
    g = torch.Generator().manual_seed(SEED)
    feats = torch.rand(MS_BATCH, len(MS_LEVELS), 512, generator=g).to(dev)
    with torch.inference_mode():
        heads = {name: (fn(feats) - torch.cat([fn(feats[:MS_BATCH // 2]),
                                               fn(feats[MS_BATCH // 2:])])
                        ).abs().max().item()
                 for name, fn in (("fuse", m32.fuse),
                                  ("aux_logits", m32.aux_logits))}
    log(f"[p17] (b) why the int8 step calls its heads on {HEAD_ROWS} rows at "
        f"a time: called on {MS_BATCH} rows against two calls of "
        f"{MS_BATCH // 2} (random features), logits max|Δ| fuse "
        f"{heads['fuse']:.3g}, aux_logits {heads['aux_logits']:.3g}")
    del m32
    torch.cuda.empty_cache()

    # (c) --download from a loopback server
    xml = os.path.join(root, "tumor_001.xml")
    write_annotation_xml(xml, polygons_level0(spec))
    zbuf = os.path.join(root, "lesion_annotations.zip")
    with zipfile.ZipFile(zbuf, "w") as zf:
        zf.write(xml, "tumor_001.xml")
    with open(tiff_path, "rb") as f:
        tif_bytes = f.read()
    with open(zbuf, "rb") as f:
        zip_bytes = f.read()
    served = {"CAMELYON16/training/tumor/tumor_001.tif": tif_bytes,
              "CAMELYON16/training/lesion_annotations.zip": zip_bytes}
    data = os.path.join(root, "camelyon16")
    real_url = download.CAMELYON16_BASE_URL
    with _LoopbackFiles(served) as srv:
        download.CAMELYON16_BASE_URL = srv.url
        try:
            rc, dl_wall = run_cli(["--download", "--data_dir", data])
        finally:
            download.CAMELYON16_BASE_URL = real_url
    got = os.path.join(data, "train", "img", "tumor_001.tif")
    with open(got, "rb") as f:
        same_tif = f.read() == tif_bytes
    with open(os.path.join(data, "train", "mask", "lesion_annotations.zip"),
              "rb") as f:
        same_zip = f.read() == zip_bytes
    files = sorted(os.path.relpath(os.path.join(d, n), data)
                   for d, _, names in os.walk(data) for n in names)
    log(f"[p17] (c) --download from {srv.url}: exit {rc} in {dl_wall:.2f} s, "
        f"{len(srv.requests)} paths requested, {len(files)} files written "
        f"({', '.join(files)}); the TIFF ({len(tif_bytes)} bytes) and the zip "
        f"byte-equal to the served ones: {same_tif}, {same_zip}")
    if (rc != 0 or len(srv.requests) != 5 or not (same_tif and same_zip)
            or len(files) != 2):
        raise AssertionError("--download did not write the two served files")
    models = os.path.join(root, "models")
    os.makedirs(models)
    torch.save(sd, os.path.join(models, "resnet18_patch_classifier.pt"))
    csvs = {}
    for tag, path in (("downloaded", got), ("local", tiff_path)):
        rc, wall = run_cli(["--predict_slide", path, "--tissue_filter",
                            "device", "--models_dir", models, "--device",
                            dev.type])
        name = os.path.basename(path).rsplit(".", 1)[0]
        with open(os.path.join(models, "model_predictions_csv",
                               f"{name}.csv"), "rb") as f:
            csvs[tag] = f.read()
        if rc != 0:
            raise AssertionError(f"--predict_slide on the {tag} TIFF: exit {rc}")
    log(f"[p17] (c) --predict_slide on the downloaded TIFF: the CSV "
        f"({len(csvs['local'])} bytes) byte-equal to the local file's: "
        f"{csvs['downloaded'] == csvs['local']}")
    if csvs["downloaded"] != csvs["local"] or not csvs["local"]:
        raise AssertionError("the downloaded slide's CSV differs")

    # (d) --compile_cache_dir in two processes
    cache = os.path.join(root, "compile_cache")
    runs = []
    for i in range(2):
        out_models = os.path.join(root, f"cache_models_{i}")
        os.makedirs(out_models)
        torch.save(sd, os.path.join(out_models, "resnet18_patch_classifier.pt"))
        before = _cache_files(cache) if os.path.isdir(cache) else {}
        cmd = [sys.executable, "-m", f"{PKG}.cli.main", "--predict_slide", got,
               "--tissue_filter", "device", "--compile_cache_dir", cache,
               "--models_dir", out_models, "--device", dev.type]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ),
                              capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"--compile_cache_dir run {i + 1} failed "
                                 f"({proc.returncode}):\n{proc.stderr[-4000:]}")
        built = [ln.split(": ", 1)[1] for ln in proc.stderr.splitlines()
                 if "building" in ln and "torch.ops.build" in ln]
        with open(os.path.join(out_models, "model_predictions_csv",
                               "tumor_001.csv"), "rb") as f:
            runs.append((wall, built, before, _cache_files(cache), f.read()))
    (w1, built1, _, after1, csv1), (w2, built2, before2, after2, csv2) = runs
    n_kernels = len([n for n in after1 if not n.startswith(("libhipac_tiff",
                                                            "libhipac_chunk"))])
    log(f"[p17] (d) --compile_cache_dir, first process: {w1:.1f} s, "
        f"{'; '.join(built1)}; {len(after1)} libraries there ({n_kernels} "
        f"kernel libraries); second process: {w2:.1f} s, build lines "
        f"{len(built2)}, libraries untouched: {after2 == before2 == after1}; "
        f"CSVs byte-equal to each other: {csv1 == csv2}, to the in-process "
        f"CLI's: {csv1 == csvs['downloaded']}")
    if (n_kernels != len(SOURCES) or not any(b.startswith("nvcc")
                                               for b in built1)
            or built2 or after2 != after1 or csv1 != csv2 or not csv1):
        raise AssertionError("--compile_cache_dir: the first process did not "
                             "build into the directory, or the second built "
                             "again")
    log(f"[p17] phase 17 in {time.perf_counter() - t_phase:.1f} s")
    return {"single": single, "multi": multi}


# ---------------------------------------------------------------------------
# phase 18: the feature-evaluation stage (validate_features) on the card
# ---------------------------------------------------------------------------

EMB_PCA_RATIO_ATOL = 1e-5  # card against CPU, float64 both sides
EMB_KL_RTOL = 0.05  # the final KL, card against CPU (chaotic trajectories)
EMB_TRUST_ATOL = 0.02  # trustworthiness at k = 5, card against CPU
EMB_TIMING_ROWS = 10_000  # validate_features' default t-SNE cap
EMB_TIMING_DIM = 512
# --tsne_full at the mean size of phase 9's MIL triplet (every row embedded)
EMB_FULL_ROWS = MIL_SLIDES * sum(MIL_INSTANCES) // 2
# the repulsion kernel against its plain version: neg within this share of
# max|neg|, sum_q relative (float32: the hardware reciprocal)
REP_NEG_RTOL = {"float32": 1e-4, "float64": 1e-10}
REP_SUM_RTOL = {"float32": 1e-6, "float64": 1e-10}
# The function's work an unordered pair {i, j} (q_ij = q_ji, so each is
# needed once): one reciprocal, and 10 FP32 instructions: 2 subtracts, 2 FMAs
# for d² + 1, q², the add into Σq, 4 FMAs of q²·(y_i − y_j) into rows i and j
REP_FP32_OPS_PAIR = 10


def _events_ms(fn):
    """(result, ms) of ``fn`` between two CUDA events; the host's waits
    inside ``fn`` (L-BFGS, the descent's progress checks) count."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def check_repulsion(y) -> float:
    """The ``tsne_repulsion`` kernel against its plain version on the
    embedding ``y`` (N, 2), in float32 and float64; returns the float32
    max |Δneg|."""
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation.embedding import (
        tsne_repulsion_reference,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.tsne_repulsion import (
        tsne_repulsion_kernel,
    )

    errs = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        yd = y.to(dtype).contiguous()
        neg, sum_q = tsne_repulsion_kernel(yd)
        torch.cuda.synchronize()
        ref_neg, ref_sum = tsne_repulsion_reference(yd)
        errs[name] = float((neg - ref_neg).abs().max())
        rel = errs[name] / float(ref_neg.abs().max())
        rel_sum = abs(float(sum_q) / float(ref_sum) - 1.0)
        log(f"[embed] tsne_repulsion {tuple(y.shape)} {name}: max_abs_err "
            f"{errs[name]:.3g} = {rel:.3g} of max|neg| (bound "
            f"{REP_NEG_RTOL[name]}), sum_q relative {rel_sum:.3g} (bound "
            f"{REP_SUM_RTOL[name]})")
        if not (rel <= REP_NEG_RTOL[name] and rel_sum <= REP_SUM_RTOL[name]):
            raise AssertionError(f"tsne_repulsion differs from its plain "
                                 f"version at {tuple(y.shape)} {name}")
    return errs["float32"]


def time_repulsion(y, plain_runs: int, smi) -> dict:
    """Per-call CUDA-event times of the kernel and its plain version on
    ``y`` in turns (plain, kernel, kernel, plain), the kernel back to back,
    and its bound: the larger of the reciprocals (one an unordered pair)
    over the special-function units' rate, :data:`REP_FP32_OPS_PAIR` FP32
    instructions an unordered pair over the FP32 pipe's, and the bytes over
    the memory rate. Reciprocals can also be taken by Newton steps on the
    FMA pipe, so the special-function figure alone is no floor."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation.embedding import (
        tsne_repulsion_reference,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.tsne_repulsion import (
        tsne_repulsion_kernel,
    )

    kernel = lambda: tsne_repulsion_kernel(y)  # noqa: E731
    plain = lambda: tsne_repulsion_reference(y)  # noqa: E731
    cuda_ms(kernel, 3)
    cuda_ms(plain, 1)
    p = cuda_ms(plain, plain_runs)
    k = cuda_ms(kernel, 5) + cuda_ms(kernel, 5)
    p += cuda_ms(plain, plain_runs)
    b2b = statistics.median(back_to_back_ms(kernel, groups=5, per=10))
    n = y.shape[0]
    pairs = n * (n - 1) // 2
    by_sfu = pairs / SFU_RCP_S * 1e3
    # an FMA is one instruction of the two operations the peak counts
    by_fp32 = REP_FP32_OPS_PAIR * pairs / (FP32_FLOP_S / 2) * 1e3
    by_bytes = (2 * y.numel() * y.element_size() + 8) / HBM_BYTES_S * 1e3
    bound = max(by_sfu, by_fp32, by_bytes)
    pipe = "sfu" if bound == by_sfu else "fp32" if bound == by_fp32 else None
    k_med, p_med = statistics.median(k), statistics.median(p)
    log(f"[embed] tsne_repulsion at {n} rows: kernel {k_med:.4f} ms a call "
        f"({min(k):.4f}–{max(k):.4f}), {b2b:.4f} back to back; plain "
        f"{p_med:.4f} ms ({min(p):.4f}–{max(p):.4f}); bound {bound:.4f} ms "
        f"over {pairs:.4g} unordered pairs: FP32 pipe {by_fp32:.4f} "
        f"({REP_FP32_OPS_PAIR} instructions a pair at "
        f"{FP32_FLOP_S / 2:.3g}/s), reciprocals {by_sfu:.4f} (one a pair at "
        f"{SFU_RCP_S:.3g}/s), bytes {by_bytes:.6f}; {bound / b2b * 100:.1f} % "
        f"of it back to back [{smi}]")
    return {"ms": k_med, "back_to_back_ms": b2b, "plain_ms": p_med,
            "bound_ms": bound,
            "bound_by": "bytes" if pipe is None else "operations",
            "bound_pipe": pipe, "bound_fp32_ms": by_fp32,
            "bound_sfu_ms": by_sfu}


def time_iteration(objective, y, lr: float, iters: int, smi) -> dict:
    """ms a descent iteration on the embedding ``y`` (N, 2) by piece, each
    piece back to back over ``iters`` calls between CUDA events: the whole
    iteration as ``gradient_descent`` runs it (the objective without its
    error, then ``descent_step`` at momentum 0.8), the repulsion kernel, the
    attraction (the edge gather, ``q_edge``, ``segment_reduce``) and the
    gains and update; the rest of the iteration (the gradient's combination
    and casts) is the whole less the three."""
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation import (
        embedding as E,
    )

    p = y.reshape(-1).clone()
    update, gains = torch.zeros_like(p), torch.ones_like(p)
    yv = p.reshape(objective.p.n, -1)

    def iteration():
        nonlocal update, gains
        _, grad = objective(p, compute_error=False)
        _, update, gains = E.descent_step(p, grad, update, gains, 0.8, lr,
                                          E.MIN_GAIN)

    _, grad = objective(p, compute_error=False)
    pieces = {"iteration": iteration,
              "repulsion": lambda: E.tsne_repulsion(yv),
              "attraction": lambda: objective.attraction(yv),
              "gains_update": lambda: E.descent_step(
                  p.clone(), grad, update, gains, 0.8, lr, E.MIN_GAIN)}
    out = {}
    for name, fn in pieces.items():
        fn()
        out[name] = statistics.median(back_to_back_ms(fn, groups=3,
                                                      per=iters))
    out["rest"] = (out["iteration"] - out["repulsion"] - out["attraction"]
                   - out["gains_update"])
    log(f"[embed] a descent iteration at {objective.p.n} rows "
        f"({objective.p.vals.numel()} edges) by piece, back to back (CUDA "
        f"events, median of 3 × {iters}): whole {out['iteration']:.3f} ms = "
        f"repulsion kernel {out['repulsion']:.3f} + attraction "
        f"{out['attraction']:.3f} + gains and update "
        f"{out['gains_update']:.3f} + rest {out['rest']:.3f} [{smi}]")
    return out


def phase_embedding(dev, feats, labels, smi) -> dict:
    """Phase 18: ``validate_features`` on the card on phase 8's feature
    triplet, held to the port's own CPU run (PCA ratio, split, confusion,
    final KL and trustworthiness; the t-SNE trajectories themselves differ)
    and to a second card run (bit-equal), the ``tsne_repulsion`` kernel's
    launches counted on the card run; its pieces timed by CUDA events; then
    t-SNE at the default cap on 10,000 × 512 seeded two-class features
    (wall, kNN and P, ms a descent iteration), the same descent on the
    repulsion's plain version held to it, and the whole t-SNE at the MIL
    triplet's size, where ``--tsne_full`` embeds every row, with a descent
    iteration there timed by piece. At each of the three sizes the kernel
    is held to its plain version on the embedding the run gave, and timed.
    Returns the kernel's row of the table."""
    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation import (
        embedding as E,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation.features_eval import (
        validate_features,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.tsne_repulsion import (
        tsne_repulsion_kernel,
    )

    t_phase = time.perf_counter()
    n, d = feats.shape
    walls, runs = {}, {}
    for where in ("cuda", "cpu"):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        runs[where] = validate_features(feats, labels, device=where)
        torch.cuda.synchronize()
        walls[where] = time.perf_counter() - t0
        if where == "cuda":
            launches = tsne_repulsion_kernel.launches
    card, cpu = runs["cuda"], runs["cpu"]
    log(f"[embed] tsne_repulsion launches on the card's validate_features: "
        f"{launches}")
    if launches == 0:
        raise AssertionError("validate_features on the card never launched "
                             "the tsne_repulsion kernel")
    again = validate_features(feats, labels, device="cuda")
    repeats = all(np.array_equal(np.asarray(card[k]), np.asarray(again[k]))
                  for k in card)
    log(f"[embed] a second card run equal bit for bit: {repeats}")
    if not repeats:
        raise AssertionError("validate_features on the card does not repeat "
                             "bit for bit")
    d_ratio = float(np.abs(np.subtract(card["pca_explained_variance"],
                                       cpu["pca_explained_variance"])).max())
    x = torch.as_tensor(feats, dtype=torch.float64, device=dev)
    p = E.tsne_affinities(x, 30.0)
    kl = {k: E.kl_divergence(p, torch.as_tensor(r["tsne_coords"], device=dev))
          for k, r in runs.items()}
    trust = {k: E.trustworthiness(x, torch.as_tensor(r["tsne_coords"],
                                                      device=dev), 5)
             for k, r in runs.items()}
    log(f"[embed] validate_features on phase 8's {n}×{d} triplet: card "
        f"{walls['cuda']:.2f} s, CPU {walls['cpu']:.2f} s; PCA ratio "
        f"{card['pca_explained_variance']} (|Δ| {d_ratio:.3g}, bound "
        f"{EMB_PCA_RATIO_ATOL}); logreg accuracy card "
        f"{card['logreg_accuracy']:.4f}, CPU {cpu['logreg_accuracy']:.4f}, "
        f"confusion {card['logreg_confusion'].tolist()}; t-SNE KL card "
        f"{kl['cuda']:.4f}, CPU {kl['cpu']:.4f} (bound {EMB_KL_RTOL:.0%}); "
        f"trustworthiness card {trust['cuda']:.4f}, CPU {trust['cpu']:.4f} "
        f"(bound {EMB_TRUST_ATOL})")
    if (d_ratio > EMB_PCA_RATIO_ATOL
            or card["logreg_accuracy"] != cpu["logreg_accuracy"]
            or not np.array_equal(card["logreg_confusion"],
                                  cpu["logreg_confusion"])
            or abs(kl["cuda"] / kl["cpu"] - 1.0) > EMB_KL_RTOL
            or abs(trust["cuda"] - trust["cpu"]) > EMB_TRUST_ATOL
            or card["tsne_coords"].shape != (n, 2)
            or not np.isfinite(card["tsne_coords"]).all()
            or not np.isfinite(card["pca_coords"]).all()):
        raise AssertionError("validate_features on the card disagrees with "
                             "its CPU run")
    y_card = torch.as_tensor(card["tsne_coords"], device=dev)
    errs = [check_repulsion(y_card)]
    by_rows = {n: time_repulsion(y_card, 5, smi)}

    # the pieces on the card, as validate_features runs them
    test_size = max(0.2, 2 / n + 1e-9)
    pieces = {}
    _, pieces["pca"] = _events_ms(lambda: E.pca(x, 2))
    p, pieces["knn_p"] = _events_ms(lambda: E.tsne_affinities(x, 30.0))
    y0, pieces["init"] = _events_ms(lambda: E.tsne_init(x))
    lr = E.tsne_learning_rate(n)
    (_, _, it), pieces["descent"] = _events_ms(
        lambda: E.tsne_descent(E.KLObjective(p), y0, lr))

    def logreg():
        train, test = E.stratified_split(labels, test_size, 42)
        fit = E.fit_logistic_regression(x[torch.as_tensor(train, device=dev)],
                                        labels[train])
        return fit.predict(x[torch.as_tensor(test, device=dev)]), fit.n_iter

    (_, lbfgs_iter), pieces["logreg"] = _events_ms(logreg)
    log(f"[embed] pieces at {n}×{d} on the card (CUDA events): PCA "
        f"{pieces['pca']:.2f} ms, kNN and P {pieces['knn_p']:.2f} ms, PCA "
        f"init {pieces['init']:.2f} ms, descent {pieces['descent']:.1f} ms "
        f"for {it + 1} iterations = {pieces['descent'] / (it + 1):.3f} ms an "
        f"iteration, logistic regression {pieces['logreg']:.1f} ms "
        f"({lbfgs_iter} L-BFGS iterations) [{smi}]")

    # t-SNE at the default cap, 10,000 × 512 two-class features from SEED
    g = torch.Generator(device=dev).manual_seed(SEED)
    cls = torch.rand(EMB_TIMING_ROWS, generator=g, device=dev) < 0.4
    big = torch.randn(EMB_TIMING_ROWS, EMB_TIMING_DIM, generator=g, device=dev)
    big += 0.5 * cls[:, None] * torch.randn(EMB_TIMING_DIM, generator=g,
                                            device=dev)
    lr_big = E.tsne_learning_rate(EMB_TIMING_ROWS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    p_big, knn_ms = _events_ms(lambda: E.tsne_affinities(big, 30.0))
    p_plain = E.JointP(p_big.rows, p_big.cols, p_big.vals.clone(), p_big.n)
    y0_big, init_ms = _events_ms(lambda: E.tsne_init(big))
    (y_big, kl_big, it_big), desc_ms = _events_ms(lambda: E.tsne_descent(
        E.KLObjective(p_big), y0_big, lr_big))
    torch.cuda.synchronize()
    wall_big = time.perf_counter() - t0
    big_launches = tsne_repulsion_kernel.launches
    if not torch.isfinite(y_big).all() or not np.isfinite(kl_big):
        raise AssertionError("t-SNE at 10,000 rows gave non-finite output")
    trust_big = E.trustworthiness(big, y_big, 5)
    log(f"[embed] t-SNE at {EMB_TIMING_ROWS}×{EMB_TIMING_DIM} (seeded, two "
        f"classes) on the card: wall {wall_big:.2f} s; kNN and P "
        f"{knn_ms:.1f} ms ({p_big.vals.numel()} edges), PCA init "
        f"{init_ms:.1f} ms, descent {desc_ms:.1f} ms for {it_big + 1} "
        f"iterations = {desc_ms / (it_big + 1):.3f} ms an iteration "
        f"(tsne_repulsion launches {big_launches}); KL {kl_big:.4f}, "
        f"trustworthiness {trust_big:.4f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")
    # the same descent with the repulsion's plain version
    tsne_repulsion = E.tsne_repulsion
    E.tsne_repulsion = E.tsne_repulsion_reference
    try:
        (y_plain, kl_plain, it_plain), plain_desc_ms = _events_ms(
            lambda: E.tsne_descent(E.KLObjective(p_plain), y0_big, lr_big))
    finally:
        E.tsne_repulsion = tsne_repulsion
    trust_plain = E.trustworthiness(big, y_plain, 5)
    log(f"[embed] the same descent on the plain repulsion: {plain_desc_ms:.1f} "
        f"ms for {it_plain + 1} iterations = "
        f"{plain_desc_ms / (it_plain + 1):.3f} ms an iteration; KL "
        f"{kl_plain:.4f} (kernel's {kl_big:.4f}, bound {EMB_KL_RTOL:.0%}), "
        f"trustworthiness {trust_plain:.4f} (kernel's {trust_big:.4f}, bound "
        f"{EMB_TRUST_ATOL}); tsne_repulsion launches "
        f"{tsne_repulsion_kernel.launches - big_launches}")
    if (abs(kl_big / kl_plain - 1.0) > EMB_KL_RTOL
            or abs(trust_big - trust_plain) > EMB_TRUST_ATOL
            or tsne_repulsion_kernel.launches != big_launches):
        raise AssertionError("t-SNE at 10,000 rows on the kernel disagrees "
                             "with the plain repulsion's")
    errs.append(check_repulsion(y_big))
    by_rows[EMB_TIMING_ROWS] = time_repulsion(y_big.contiguous(), 5, smi)
    del p_big, p_plain, y_big, y_plain, big

    # --tsne_full at the MIL triplet's size: the whole t-SNE
    cls = torch.rand(EMB_FULL_ROWS, generator=g, device=dev) < 0.4
    full = torch.randn(EMB_FULL_ROWS, EMB_TIMING_DIM, generator=g, device=dev)
    full += 0.5 * cls[:, None] * torch.randn(EMB_TIMING_DIM, generator=g,
                                             device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    p_full, knn_full_ms = _events_ms(lambda: E.tsne_affinities(full, 30.0))
    y_full, init_full_ms = _events_ms(lambda: E.tsne_init(full))
    del full
    (y_full, kl_full, it_full), desc_full_ms = _events_ms(
        lambda: E.tsne_descent(E.KLObjective(p_full), y_full,
                               E.tsne_learning_rate(EMB_FULL_ROWS)))
    torch.cuda.synchronize()
    wall_full = time.perf_counter() - t0
    full_launches = tsne_repulsion_kernel.launches
    if not torch.isfinite(y_full).all() or not np.isfinite(kl_full):
        raise AssertionError(f"t-SNE at {EMB_FULL_ROWS} rows gave non-finite "
                             "output")
    log(f"[embed] --tsne_full at the MIL triplet's size, {EMB_FULL_ROWS}×"
        f"{EMB_TIMING_DIM} (seeded, two classes), the whole t-SNE on the "
        f"card: wall {wall_full:.2f} s; kNN and P {knn_full_ms:.1f} ms "
        f"({p_full.vals.numel()} edges), PCA init {init_full_ms:.1f} ms, "
        f"descent {desc_full_ms:.1f} ms for {it_full + 1} iterations = "
        f"{desc_full_ms / (it_full + 1):.3f} ms an iteration (tsne_repulsion "
        f"launches {full_launches}); KL {kl_full:.4f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")
    iteration = time_iteration(E.KLObjective(p_full), y_full,
                               E.tsne_learning_rate(EMB_FULL_ROWS), 10, smi)
    del p_full
    errs.append(check_repulsion(y_full))
    by_rows[EMB_FULL_ROWS] = time_repulsion(y_full.contiguous(), 1, smi)
    log(f"[embed] phase 18 in {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "max_abs_err": max(errs),
            **by_rows[EMB_FULL_ROWS], "library_ms": None,
            "tsne_10k_launches": big_launches,
            "tsne_full_launches": full_launches,
            "iteration_ms": iteration,
            "by_rows": {str(k): v for k, v in by_rows.items()}}


# ---------------------------------------------------------------------------
# phase 19: the device paths that had run only on the CPU
# ---------------------------------------------------------------------------

# an fc-less trunk's int8 features against its float32 folded forward, per
# cell: the JAX package's own gate (tests/test_quantized.py)
GAPS_FEATURE_COSINE_MIN = 0.98
GAPS_DETECT_THRESHOLD = 0.3  # (f)'s --detect_threshold


def _text(path: str) -> str:
    with open(path) as f:
        return f.read()


def _gaps_simclr(dev, ds, data_dir, root, simclr_models, smi) -> dict:
    """(a) ``--extract_features --simclr_features`` through the CLI: its
    triplet bit-equal to an in-process ``extract_features`` of the
    encoder's trunk, 2b launched once a batch; then with ``--int8`` (lazy
    calibration): the features against ``quant_forward`` of the tree
    quantized from the encoder on the same calibration batches, within
    :data:`INT8_CPU_STEPS` int8 steps, and each reference cell's cosine
    against the float32 folded trunk above :data:`GAPS_FEATURE_COSINE_MIN`."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        Config,
        DataConfig,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.features import (
        extract_features,
        lazy_qtree,
        load_feature_artifacts,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quantized import (
        fold_batchnorm,
        folded_forward,
        quant_forward,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
        load_model,
        save_model,
    )

    n, steps = len(ds), -(-len(ds) // BATCH)
    # phase 10's store under a data root of its own, where the triplet lands
    own = os.path.join(root, "simclr_data")
    os.makedirs(own)
    os.symlink(DataConfig(data_dir=data_dir).patches_dir,
               DataConfig(data_dir=own).patches_dir)
    features_dir = DataConfig(data_dir=own).features_dir
    argv = ["--extract_features", "--simclr_features", "--patch_level",
            str(LEVEL), "--batch_size", str(BATCH), "--data_dir", own,
            "--models_dir", simclr_models, "--device", "cuda"]
    (rc, wall), counts = _counted(lambda: run_cli(argv), dev)
    if rc != 0:
        raise AssertionError(f"--extract_features --simclr_features: exit {rc}")
    feats, labels, names = load_feature_artifacts(features_dir, LEVEL)
    enc = load_model(os.path.join(simclr_models, "simclr_encoder"))
    trunk = {k.removeprefix("encoder."): v for k, v in enc.items()
             if k.startswith("encoder.")}
    trunk_dir = os.path.join(root, "simclr_trunk")
    save_model(os.path.join(trunk_dir, "resnet18_patch_classifier"), trunk)
    cfg = Config(data=DataConfig(data_dir=os.path.join(root, "simclr_ref")),
                 models_dir=trunk_dir)
    extract_features(cfg, level=LEVEL, batch_size=BATCH, dataset=ds,
                     device="cuda")
    want, want_labels, want_names = load_feature_artifacts(
        cfg.data.features_dir, LEVEL)
    same = (np.array_equal(feats, want) and names == want_names
            and np.array_equal(labels, want_labels) and len(names) == n)
    log(f"[gaps] (a) --extract_features --simclr_features from phase 6's "
        f"encoder: exit 0 in {wall:.2f} s; {feats.shape} float32; "
        f"bias_relu_pool launches {counts['bias_relu_pool']} ({steps} "
        f"batches); the triplet bit-equal to extract_features of the "
        f"encoder's trunk: {same}")
    if not same:
        raise AssertionError("--simclr_features differs from extract_features "
                             "of the encoder's trunk")
    if counts["bias_relu_pool"] != steps or counts["fused_stem"]:
        raise AssertionError(f"expected {steps} bias_relu_pool launches on "
                             f"--simclr_features, counted {counts}")

    (rc, wall8), counts8 = _counted(lambda: run_cli([*argv, "--int8"]), dev)
    if rc != 0:
        raise AssertionError(f"--simclr_features --int8: exit {rc}")
    f8, _, _ = load_feature_artifacts(features_dir, LEVEL)
    tree = lazy_qtree(trunk, ds, BATCH, dev)
    with torch.inference_mode():
        direct = np.concatenate([
            quant_forward(tree, torch.from_numpy(
                ds.read_batch(range(i, min(i + BATCH, n)))[0]).to(dev),
                with_fc=False).cpu().numpy()
            for i in range(0, n, BATCH)])
    step = tree["ascales"]["s4b1o"].item() / 49
    d = float(np.abs(f8 - direct).max())
    idx = np.sort(np.random.default_rng(SEED).choice(n, FEAT_REF_CELLS,
                                                     replace=False))
    imgs, _ = ds.read_batch(idx)
    with torch.inference_mode():
        f32 = folded_forward(fold_batchnorm(trunk),
                             torch.from_numpy(imgs).to(dev),
                             with_fc=False).cpu()
    cos = F.cosine_similarity(torch.from_numpy(f8[idx]), f32, dim=1)
    int8 = (counts8["fused_stage1_int8"], counts8["int8_conv_requant"],
            counts8["int8_maxpool"])
    log(f"[gaps] (a) --simclr_features --int8 (lazy calibration): exit 0 in "
        f"{wall8:.2f} s; launches fused_stage1_int8 {int8[0]}, "
        f"int8_conv_requant {int8[1]}, int8_maxpool {int8[2]}; against "
        f"quant_forward of the encoder's tree on the same calibration "
        f"batches max|Δ| {d:.3g} = {d / step:.3g} int8 steps (bound "
        f"{INT8_CPU_STEPS}); feature cosine against the float32 folded trunk "
        f"on {len(idx)} cells: min {cos.min().item():.5f}, median "
        f"{cos.median().item():.5f} (bound > {GAPS_FEATURE_COSINE_MIN}) "
        f"[{smi}]")
    if int8 != (steps, 16 * steps, steps):
        raise AssertionError(f"expected {steps}, {16 * steps} and {steps} int8 "
                             f"launches on --simclr_features --int8, counted "
                             f"{int8}")
    if d > INT8_CPU_STEPS * step or not np.isfinite(f8).all():
        raise AssertionError("--simclr_features --int8 differs from the "
                             "encoder's quantized forward")
    if not cos.min().item() > GAPS_FEATURE_COSINE_MIN:
        raise AssertionError("--simclr_features --int8: a reference cell's "
                             f"feature cosine is at or below "
                             f"{GAPS_FEATURE_COSINE_MIN}")
    return {"bias_relu_pool": counts["bias_relu_pool"], "int8": int8}


def _gaps_strategies(dev, ds, data_dir, root, cfg_path, logs) -> dict:
    """(b) ``--train_strategy --strategy balanced``, then ``weighted_loss``,
    one epoch each through the CLI: each artifact loads strictly with
    finite weights and history, ``augment`` once a step; one bf16 card
    step of the balanced classifier on the ``BalancedSampler``'s first
    cells (no class weights) against the float32 CPU step."""
    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        DataConfig,
        TrainConfig,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
        BalancedSampler,
        BatchIterator,
        make_train_val_datasets,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        resnet18_from_state_dict,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
        load_model,
    )

    models = os.path.join(root, "strategy_models")
    steps = -(-len(ds) // BATCH)  # one slide: the split trains on every cell
    out = {"models_dir": models}
    for strategy in ("balanced", "weighted_loss"):
        argv = ["--train_strategy", "--strategy", strategy, "--epochs", "1",
                "--batch_size", str(BATCH), "--patch_level", str(LEVEL),
                "--data_dir", data_dir, "--models_dir", models, "--config",
                cfg_path, "--device", "cuda"]
        (rc, wall), counts = _counted(lambda: run_cli(argv), dev)
        if rc != 0:
            raise AssertionError(f"--strategy {strategy}: exit {rc}")
        with open(os.path.join(logs, f"train_history_{strategy}.json")) as f:
            history = json.load(f)
        sd = load_model(os.path.join(models,
                                     f"resnet18_patch_classifier_{strategy}"))
        resnet18_from_state_dict(sd)  # strict: every tensor in place
        finite = (all(torch.isfinite(v).all() for v in sd.values()
                      if v.is_floating_point())
                  and all(np.isfinite(h["train_loss"]) for h in history))
        log(f"[gaps] (b) --train_strategy --strategy {strategy} --epochs 1: "
            f"exit 0 in {wall:.2f} s; augment launches {counts['augment']} "
            f"({history[0]['steps']} steps); history "
            f"{[{k: round(v, 4) for k, v in h.items()} for h in history]}; "
            f"resnet18_patch_classifier_{strategy}.pt loads strictly, finite "
            f"{finite}")
        if (len(history) != 1 or history[0]["steps"] != steps or not finite
                or counts["augment"] != steps):
            raise AssertionError(f"--strategy {strategy}: expected one epoch of "
                                 f"{steps} steps with as many augment launches"
                                 f" and finite weights")
        out[strategy] = counts["augment"]
        if strategy == "balanced":
            data = DataConfig(data_dir=data_dir)
            seed = TrainConfig().seed
            train_ds, _ = make_train_val_datasets(
                ds.manifest, val_fraction=data.val_fraction,
                split_seed=data.split_seed,
                balance_val_seed=data.balance_val_seed)
            it = BatchIterator(train_ds, REF_BATCH, shuffle=True, seed=seed,
                               sampler=BalancedSampler(train_ds.labels,
                                                       seed=seed))
            imgs, lab, valid = next(iter(it))
            log(f"[gaps] (b) the BalancedSampler's first {REF_BATCH} cells: "
                f"{int(lab.sum())} tumor, {int((lab == 0).sum())} normal")
            card_step_against_cpu("gaps-balanced-check", sd, imgs, lab, None,
                                  valid.astype(np.float32))
    return out


def _gaps_frozen_bn(dev, ds, data_dir, root, cfg_path, trained) -> dict:
    """(c) ``train_resnet_classifier`` with ``train.freeze_bn`` (the field
    ``--freeze_bn`` sets) warm-started from phase 10's classifier for one
    epoch: every BN running statistic of the artifact bit-equal to the warm
    start's, ``augment`` once a step, one frozen-BN bf16 card step against
    the float32 CPU step; then ``--train --freeze_bn`` through the CLI,
    which has no warm start on this machine: exit 0, the warning, the
    statistics still at their initial values."""
    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        Config,
        DataConfig,
        TrainConfig,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
        load_model,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.losses import (
        class_weights_inv_min,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.trainer import (
        train_resnet_classifier,
    )

    def stats(sd):
        return [k for k in sd if k.endswith(("running_mean", "running_var"))]

    steps = -(-len(ds) // BATCH)
    warm = load_model(trained.removesuffix(".pt"))
    models = os.path.join(root, "frozen_bn_models")
    cfg = Config(data=DataConfig(data_dir=data_dir), models_dir=models,
                 log_dir=os.path.join(root, "frozen_bn_logs"),
                 train=TrainConfig(batch_size=BATCH, freeze_bn=True))
    t0 = time.perf_counter()
    trainer, counts = _counted(lambda: train_resnet_classifier(
        cfg, level=LEVEL, epochs=1, pretrained_variables=warm,
        device="cuda"), dev)
    wall = time.perf_counter() - t0
    art = load_model(os.path.join(models, "resnet18_patch_classifier"))
    keys = stats(warm)
    kept = all(torch.equal(art[k], warm[k]) for k in keys)
    moved = sum(not torch.equal(art[k], warm[k]) for k in art
                if k.endswith(("weight", "bias")))
    finite = all(np.isfinite(h["train_loss"]) for h in trainer.history)
    log(f"[gaps] (c) train_resnet_classifier(freeze_bn) for 1 epoch from "
        f"phase 10's classifier: {wall:.2f} s; augment launches "
        f"{counts['augment']} ({steps} steps); history {trainer.history}; "
        f"{len(keys)} BN running statistics bit-equal to the warm start's: "
        f"{kept}; {moved} weight and bias tensors moved")
    if not kept or not moved or not finite or counts["augment"] != steps:
        raise AssertionError("frozen BatchNorm: statistics moved, nothing "
                             "trained, a non-finite loss or other augment "
                             "launches than steps")
    imgs, lab = ds.read_batch(range(REF_BATCH))
    card_step_against_cpu("gaps-frozen-bn-check", art, imgs, lab,
                          class_weights_inv_min(ds.labels, 2), frozen_bn=True)

    cli_models = os.path.join(root, "freeze_bn_cli_models")
    argv = ["--train", "--freeze_bn", "--epochs", "1", "--batch_size",
            str(BATCH), "--patch_level", str(LEVEL), "--data_dir", data_dir,
            "--models_dir", cli_models, "--config", cfg_path, "--device",
            "cuda"]
    with _Messages("train") as records:
        (rc, cli_wall), cli_counts = _counted(lambda: run_cli(argv), dev)
    warned = any("--freeze_bn without a warm start" in r.getMessage()
                 for r in records)
    sd = load_model(os.path.join(cli_models, "resnet18_patch_classifier"))
    initial = all(torch.count_nonzero(sd[k]) == 0 if k.endswith("mean")
                  else bool((sd[k] == 1).all()) for k in stats(sd))
    log(f"[gaps] (c) --train --freeze_bn --epochs 1: exit {rc} in "
        f"{cli_wall:.2f} s; warned of no warm start {warned}; augment launches "
        f"{cli_counts['augment']}; running statistics at their initial "
        f"values (mean 0, var 1): {initial}")
    if rc != 0 or not warned or not initial or cli_counts["augment"] != steps:
        raise AssertionError("--train --freeze_bn: exit, warning, statistics "
                             "or augment launches wrong")
    return {"frozen_bn": counts["augment"], "freeze_bn_cli": cli_counts["augment"]}


def _gaps_attention(dev, ds, data_dir, root, cfg_path, trained, msds,
                    ms_train_idx, slide_path, smi) -> dict:
    """(d) ``--train_multiscale --ms_fusion attention`` for one epoch from
    phase 10's classifier: the artifact's fusion is attention, ``augment``
    twice a step; its bf16 ``fuse`` on the card against the float32 CPU
    ``fuse`` on 32 pooled feature rows within :data:`BF16_ATOL`; then
    ``--predict_slide --multiscale`` with each explicit ``--ms_combine``:
    each CSV equal to ``margin_detections`` of that component of one
    in-process ``predict_slide_multiscale``, 2a twice a batch."""
    import shutil

    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        DETECTION_PROB_THRESHOLD,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
        normalize,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.multiscale import (
        COMBINE_COLUMNS,
        predict_slide_multiscale,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
        margin_detections,
        write_detection_csv,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        hierarchical_from_state_dict,
        split_calibration,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.preprocess import (
        fused_normalize,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
        load_model,
    )

    s = len(MS_LEVELS)
    levels = ",".join(map(str, MS_LEVELS))
    models = os.path.join(root, "attention_models")
    os.makedirs(models)
    shutil.copy(trained, models)
    argv = ["--train_multiscale", "--ms_fusion", "attention", "--levels",
            levels, "--epochs", "1", "--batch_size", str(BATCH),
            "--data_dir", data_dir, "--models_dir", models, "--config",
            cfg_path, "--device", "cuda"]
    with _Messages("train.multiscale") as records:
        (rc, wall), counts = _counted(lambda: run_cli(argv), dev)
    warm = [r for r in records if r.msg.startswith("warm-started")]
    state, cal = split_calibration(load_model(os.path.join(
        models, "hierarchical_classifier")))
    cpu = hierarchical_from_state_dict(state, MS_LEVELS)
    steps = -(-len(ms_train_idx) // BATCH)
    log(f"[gaps] (d) --train_multiscale --ms_fusion attention --epochs 1: "
        f"exit {rc} in {wall:.2f} s; warm-started {len(warm) == 1}; fusion "
        f"{cpu.fusion}; augment launches {counts['augment']} ({steps} steps "
        f"× {s} levels); calibration {cal}")
    if (rc != 0 or len(warm) != 1 or cpu.fusion != "attention"
            or counts["augment"] != s * steps
            or not all(np.isfinite(v) for v in cal.values())):
        raise AssertionError("--train_multiscale --ms_fusion attention failed, "
                             "lost its warm start or its fusion mode, or "
                             "launched augment other than twice a step")

    # fuse: bf16 heads on the card against float32 on the CPU, on the same
    # pooled features (the trunk's, float32 on the card)
    imgs, _ = msds.read_batch(range(REF_BATCH))
    f32 = hierarchical_from_state_dict(state, MS_LEVELS).to(dev).eval()
    card = hierarchical_from_state_dict(state, MS_LEVELS).for_inference(
        dev, torch.bfloat16)
    with torch.inference_mode():
        x = torch.cat([normalize(torch.from_numpy(imgs[lvl]).to(dev))
                       for lvl in sorted(imgs)])
        feats = f32.trunk(x).reshape(s, REF_BATCH, -1).transpose(0, 1)
        want = cpu.fuse(feats.cpu().contiguous())
        got = card.fuse(feats.contiguous()).float().cpu()
    d = (got - want).abs().max().item()
    margins = want[:, 1] - want[:, 0]
    log(f"[gaps] (d) HierarchicalPatchClassifier.fuse (attention) on "
        f"{REF_BATCH} pooled feature rows × {s} scales: bf16 card against "
        f"float32 CPU max|Δ| {d:.4g} (bound {BF16_ATOL}) = "
        f"{d / want.abs().max().item():.3g} of max|logit|; CPU logits up to "
        f"{want.abs().max().item():.4f}, margins spread "
        f"{(margins.max() - margins.min()).item():.4f} [{smi}]")
    if not d <= BF16_ATOL:
        raise AssertionError("the attention fuse in bf16 on the card strays "
                             "from float32 on the CPU")

    # each explicit --ms_combine against one in-process pass
    del f32, feats
    _, grid, comps = predict_slide_multiscale(
        slide_path, card, cal, levels=MS_LEVELS, stride=STRIDE,
        batch_size=MS_BATCH, output="margin", return_components=True,
        device=dev, devices=[dev])
    want_launches = s * -(-len(ds) // MS_BATCH)
    out = []
    for combine in COMBINE_COLUMNS:
        (rc, wall), _ = _counted(lambda: run_cli([
            "--predict_slide", slide_path, "--multiscale", "--levels", levels,
            "--ms_combine", combine, "--stride", str(STRIDE), "--batch_size",
            str(MS_BATCH), "--models_dir", models, "--device", "cuda"]), dev)
        launches = fused_normalize.launches
        ref = os.path.join(root, "ms_combine_ref", f"{combine}.csv")
        write_detection_csv(ref, margin_detections(comps[combine], grid,
                                                   DETECTION_PROB_THRESHOLD))
        got_csv = _text(os.path.join(models, "model_predictions_csv",
                                     "smoke_slide.csv"))
        equal = got_csv == _text(ref)
        log(f"[gaps] (d) --predict_slide --multiscale --ms_combine {combine}: "
            f"exit {rc} in {wall:.2f} s; {len(got_csv.splitlines())} "
            f"detections, equal to the in-process component: {equal}; "
            f"fused_normalize launches {launches}")
        if rc != 0 or not equal or launches != want_launches:
            raise AssertionError(f"--ms_combine {combine}: exit {rc}, CSV equal "
                                 f"{equal}, 2a launches {launches} (expected "
                                 f"{want_launches})")
        out.append(launches)
    return {"augment": counts["augment"], "fused_normalize": out}


def _gaps_trained_int8(dev, data_dir, root, trained, slide, slide_path,
                       n_tissue, grid_cells, ref_u8, smi) -> dict:
    """(e) int8 on trained weights: ``--quantize`` through the CLI on phase
    10's classifier, then ``--predict_slide <dir> --int8 --run_evaluation``
    (host filter: int8 folds normalize into its stem) and the float
    ``--predict_slide <dir> --run_evaluation`` (device filter, on 2a) from
    that models directory; the margins of both on the tissue cells, each
    reference cell's feature cosine (above
    :data:`GAPS_FEATURE_COSINE_MIN`) and both FROC scores (int8 at least
    the float's)."""
    import shutil

    import numpy as np
    import torch
    import torch.nn.functional as F

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
        NON_TISSUE_MARGIN,
        predict_slide,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        load_state_dict_file,
        resnet18_from_state_dict,
        strip_head,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quant_artifact import (
        CLASSIFIER_ARTIFACT,
        load_quantized,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quantized import (
        fold_batchnorm,
        folded_forward,
        quant_forward,
        quantized_to,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.preprocess import (
        fused_normalize,
    )

    models = os.path.join(root, "trained_int8_models")
    os.makedirs(models)
    shutil.copy(trained, models)
    # the smoke slide alone in a directory: the FROC reads its CSV
    slides = os.path.join(root, "trained_int8_slides")
    os.makedirs(slides)
    os.symlink(slide_path, os.path.join(slides, os.path.basename(slide_path)))
    common = ["--patch_level", str(LEVEL), "--data_dir", data_dir,
              "--models_dir", models, "--device", "cuda"]
    (rc, wall), counts = _counted(lambda: run_cli(["--quantize", *common]), dev)
    path = os.path.join(models, CLASSIFIER_ARTIFACT)
    if rc != 0 or not os.path.exists(path) or any(counts.values()):
        raise AssertionError(f"--quantize on the trained classifier: exit {rc},"
                             f" launches {counts}")
    log(f"[gaps] (e) --quantize on phase 10's trained classifier: exit 0 in "
        f"{wall:.2f} s → {CLASSIFIER_ARTIFACT}")
    predict = ["--predict_slide", slides, "--run_evaluation", "--stride",
               str(STRIDE), "--batch_size", str(BATCH), *common]
    runs = {}
    for name, extra in (("int8", ["--int8", "--tissue_filter", "host"]),
                        ("float", ["--tissue_filter", "device"])):
        with _Messages("evaluation.froc") as froc, \
                _Messages("models.quant_artifact") as artifact:
            (rc, wall), counts = _counted(lambda: run_cli([*predict, *extra]),
                                          dev)
        runs[name] = {
            "rc": rc, "wall": wall, "counts": counts,
            "fused_normalize": fused_normalize.launches,
            "froc": [r.args[0] for r in froc
                     if r.msg.startswith("FROC score")],
            "artifact": any(r.getMessage().startswith(
                "using persisted quantization artifact") for r in artifact)}
    i8, fl = runs["int8"], runs["float"]
    int8 = (i8["counts"]["fused_stage1_int8"], i8["counts"]["int8_conv_requant"],
            i8["counts"]["int8_maxpool"])
    log(f"[gaps] (e) --predict_slide <dir> --int8 --run_evaluation: exit "
        f"{i8['rc']} in {i8['wall']:.2f} s, the artifact used {i8['artifact']},"
        f" launches fused_stage1_int8 {int8[0]}, int8_conv_requant {int8[1]}, "
        f"int8_maxpool {int8[2]}; float --predict_slide <dir> "
        f"--run_evaluation: exit {fl['rc']} in {fl['wall']:.2f} s, "
        f"fused_normalize launches {fl['fused_normalize']}")
    batches, float_batches = -(-n_tissue // BATCH), -(-grid_cells // BATCH)
    if i8["rc"] != 0 or fl["rc"] != 0 or not i8["artifact"]:
        raise AssertionError("--predict_slide --int8 / float from the trained "
                             "classifier failed or left the artifact unused")
    if (int8 != (batches, 16 * batches, batches)
            or fl["fused_normalize"] != float_batches):
        raise AssertionError(f"expected {batches}, {16 * batches} and {batches} "
                             f"int8 launches and {float_batches} of 2a, "
                             f"counted {int8} and {fl['fused_normalize']}")
    if len(i8["froc"]) != 1 or len(fl["froc"]) != 1:
        raise AssertionError("--run_evaluation gave no FROC score")

    # the margins of both on the tissue cells, the reference cells' features
    sd = load_state_dict_file(trained)
    tree = load_quantized(path)
    m8, _ = predict_slide(slide, resnet18_from_state_dict(sd).to(
        dev, memory_format=torch.channels_last), level=LEVEL, stride=STRIDE,
        batch_size=BATCH, output="margin", int8=True, qtree=tree, device=dev)
    mf, _ = predict_slide(slide, resnet18_from_state_dict(sd).to(
        dev, dtype=torch.bfloat16, memory_format=torch.channels_last),
        level=LEVEL, stride=STRIDE, batch_size=BATCH, output="margin",
        tissue_filter="device", device=dev)
    tissue = mf != NON_TISSUE_MARGIN
    a, b = torch.from_numpy(m8[tissue]), torch.from_numpy(mf[tissue])
    cos_m = F.cosine_similarity(a, b, dim=0).item()
    d_m = (a - b).abs()
    x = torch.from_numpy(ref_u8).to(dev)
    with torch.inference_mode():
        f32 = folded_forward(fold_batchnorm(strip_head(sd)), x, with_fc=False)
        f8 = quant_forward(quantized_to(tree, dev), x, with_fc=False)
    cos_f = F.cosine_similarity(f8, f32, dim=1).cpu()
    log(f"[gaps] (e) int8 on trained weights, {int(tissue.sum())} tissue "
        f"cells: margin cosine {cos_m:.5f}; max|Δ| {d_m.max().item():.4f}, "
        f"mean|Δ| {d_m.mean().item():.4f}, on float margins spreading "
        f"{(b.max() - b.min()).item():.4f} (std {b.std().item():.4f}); "
        f"feature cosine on the {len(ref_u8)} reference cells: "
        f"{', '.join(f'{c:.4f}' for c in cos_f.tolist())} (min "
        f"{cos_f.min().item():.5f}, bound > {GAPS_FEATURE_COSINE_MIN}); FROC "
        f"int8 {i8['froc'][0]} against float {fl['froc'][0]} [{smi}]")
    if not np.array_equal(m8 == NON_TISSUE_MARGIN, ~tissue):
        raise AssertionError("the int8 and float tissue partitions differ")
    if not cos_f.min().item() > GAPS_FEATURE_COSINE_MIN:
        raise AssertionError("int8 on trained weights: a reference cell's "
                             "feature cosine is at or below "
                             f"{GAPS_FEATURE_COSINE_MIN}")
    if not i8["froc"][0] >= fl["froc"][0]:
        raise AssertionError("int8 on trained weights: its FROC is below the "
                             "float path's")
    return {"int8": int8, "fused_normalize": fl["fused_normalize"],
            "froc": (i8["froc"][0], fl["froc"][0]), "margin_cosine": cos_m,
            "feature_cosine_min": cos_f.min().item()}


def _gaps_model_name(dev, root, strategy_models, slide_path, grid_cells):
    """(f) ``--predict_slide --model_name resnet18_patch_classifier_balanced
    --detect_threshold 0.3`` on (b)'s artifact: the CSV equal to an
    in-process ``predict_slide`` + ``margin_detections`` at that floor, 2a
    once a batch of the device filter."""
    import numpy as np
    import torch

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
        margin_detections,
        predict_slide,
        write_detection_csv,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        load_state_dict_file,
        resnet18_from_state_dict,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.preprocess import (
        fused_normalize,
    )

    name = "resnet18_patch_classifier_balanced"
    argv = ["--predict_slide", slide_path, "--model_name", name,
            "--detect_threshold", str(GAPS_DETECT_THRESHOLD), "--tissue_filter",
            "device", "--stride", str(STRIDE), "--batch_size", str(BATCH),
            "--models_dir", strategy_models, "--device", "cuda"]
    (rc, wall), _ = _counted(lambda: run_cli(argv), dev)
    launches = fused_normalize.launches
    model = resnet18_from_state_dict(load_state_dict_file(os.path.join(
        strategy_models, f"{name}.pt"))).to(
        dev, dtype=torch.bfloat16, memory_format=torch.channels_last)
    margins, grid = predict_slide(slide_path, model, level=LEVEL, stride=STRIDE,
                                  batch_size=BATCH, output="margin",
                                  tissue_filter="device", device=dev)
    ref = os.path.join(root, "model_name_ref.csv")
    write_detection_csv(ref, margin_detections(margins, grid,
                                               GAPS_DETECT_THRESHOLD))
    csv = os.path.join(strategy_models, "model_predictions_csv",
                       "smoke_slide.csv")
    got = _text(csv)
    rows = np.loadtxt(csv, delimiter=",", ndmin=2) if got.strip() else None
    want_launches = -(-grid_cells // BATCH)
    log(f"[gaps] (f) --predict_slide --model_name {name} --detect_threshold "
        f"{GAPS_DETECT_THRESHOLD}: exit {rc} in {wall:.2f} s; "
        f"{0 if rows is None else len(rows)} detections, lowest "
        f"{None if rows is None else rows[:, 0].min()}; equal to the "
        f"in-process predict_slide + margin_detections: {got == _text(ref)}; "
        f"fused_normalize launches {launches}")
    if (rc != 0 or got != _text(ref) or rows is None
            or not (rows[:, 0] >= GAPS_DETECT_THRESHOLD).all()
            or launches != want_launches):
        raise AssertionError("--model_name/--detect_threshold: exit, CSV, floor"
                             f" or 2a launches ({launches}, expected "
                             f"{want_launches}) wrong")
    return launches


def phase_card_gaps(dev, ds, slide, ref_u8, train, simclr_models, msds,
                    ms_train_idx, grid_cells, smi, tmp) -> dict:
    """Phase 19: the device paths that had run only on the CPU, through the
    CLI on the card, each step's launches counted around it (module
    docstring, 19)."""
    t_phase = time.perf_counter()
    data_dir = train["data_dir"]
    slide_path = os.path.join(data_dir, "train", "img", "smoke_slide.wsi.npz")
    trained = os.path.join(train["models_dir"], "resnet18_patch_classifier.pt")
    root = os.path.join(tmp, "card_gaps")
    logs = os.path.join(root, "logs")
    os.makedirs(root)
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as f:
        json.dump({"log_dir": logs}, f)
    walls, out = {}, {}

    def step(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        walls[name] = time.perf_counter() - t0

    step("a", lambda: _gaps_simclr(dev, ds, data_dir, root, simclr_models, smi))
    step("b", lambda: _gaps_strategies(dev, ds, data_dir, root, cfg_path, logs))
    step("c", lambda: _gaps_frozen_bn(dev, ds, data_dir, root, cfg_path,
                                      trained))
    step("d", lambda: _gaps_attention(dev, ds, data_dir, root, cfg_path,
                                      trained, msds, ms_train_idx, slide_path,
                                      smi))
    step("e", lambda: _gaps_trained_int8(dev, data_dir, root, trained, slide,
                                         slide_path, len(ds), grid_cells,
                                         ref_u8, smi))
    step("f", lambda: _gaps_model_name(dev, root, out["b"]["models_dir"],
                                       slide_path, grid_cells))
    log(f"[gaps] phase 19 in {time.perf_counter() - t_phase:.1f} s; by step "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in walls.items()) + f" [{smi}]")
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        print(f"{PKG}/ not found beside {__file__}: run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import torch

    t_start = time.perf_counter()
    smi, dev = phase_card()
    built = phase_build()
    kernel = phase_kernels(dev)
    ntxent = phase_ntxent(dev)
    milpool = phase_milpool(dev)

    import numpy as np

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.synthetic import (
        make_synthetic_slide,
        tumor_spec,
    )

    t0 = time.perf_counter()
    spec = tumor_spec(width=SLIDE_W, height=SLIDE_H, seed=1)
    slide = make_synthetic_slide(spec)
    log(f"[slide] {SLIDE_W}×{SLIDE_H} synthetic slide with the default tumor "
        f"polygon rendered in {time.perf_counter() - t0:.1f} s; level {LEVEL} "
        f"{slide.level_dimensions[LEVEL]}")
    grid, tissue = tissue_cells(slide)
    labels = tumor_labels(spec, slide, grid, tissue)
    log(f"[slide] grid {grid.num_patches} cells: {len(tissue)} tissue, of "
        f"them {int(labels.sum())} tumor (a tumor pixel in the window) and "
        f"{int((labels == 0).sum())} normal")
    pick = np.random.default_rng(SEED).permutation(len(tissue))
    calib, ref = tissue[pick[:CALIB_CELLS]], tissue[pick[-REF_CELLS:]]
    cells = lambda idx: np.stack([read_cell(slide, grid, iy, ix)  # noqa: E731
                                  for iy, ix in idx])
    sd, f32_card, model = make_model(dev, cells(calib))
    kernel.update(phase_slice(dev, model, slide, ref))
    ref_u8 = cells(ref)
    host_margins = kernel.pop("host_margins")
    check_reference(sd, f32_card, ref_u8, kernel.pop("ref_margins"), dev)
    phase_cli(sd, slide)
    with tempfile.TemporaryDirectory() as froc_tmp:
        froc_launches = phase_froc(sd, slide, spec, grid, froc_tmp)
    del f32_card, model
    torch.cuda.empty_cache()
    stem_pool = phase_stem_pool(dev)
    stem_train = phase_stem_train(dev)
    stem = phase_fused_stem(dev, sd)
    torch.cuda.empty_cache()
    int8_conv = phase_int8_conv(dev)
    stage1 = phase_fused_stage1(dev)
    int8_pool = phase_int8_pool(dev)
    aug = phase_augment(dev)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        ds = simclr_dataset(slide, grid, tissue, labels, tmp)
        simclr = phase_simclr(dev, ds, tmp)
        phase_simclr_check(dev, ds, simclr["sd"])
        simclr_launches = simclr["launches"]
        del simclr
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as mil_tmp:
            milpool.update(phase_mil(dev, mil_tmp))
        torch.cuda.empty_cache()
        int8_launches = phase_int8(dev, ds, sd, slide, host_margins, ref,
                                   ref_u8, tmp)
        torch.cuda.empty_cache()
        train = phase_train(dev, ds, slide, spec, os.path.join(tmp, "models"),
                            tmp)
        torch.cuda.empty_cache()
        dp = phase_dp(dev, ds, smi, tmp)
        fleet = phase_fleet(dev, sd, os.path.join(
            tmp, "train_data", "train", "img", "smoke_slide.wsi.npz"), smi, tmp)
        torch.cuda.empty_cache()
        ms = phase_multiscale(dev, sd, slide, spec, grid, host_margins, calib,
                              ref, tmp)
        torch.cuda.empty_cache()
        ms_train = phase_ms_train(dev, ds, slide, grid, tissue, labels, ref_u8,
                                  train)
        torch.cuda.empty_cache()
        ext = phase_extract(dev, spec, slide, grid, tissue, tmp)
        torch.cuda.empty_cache()
        tiff = phase_tiff(dev, sd, spec, slide, grid, host_margins, os.path.join(
            tmp, "train_data", "train", "img", "smoke_slide.wsi.npz"), train,
            ext["root"], fleet, built, smi, tmp)
        torch.cuda.empty_cache()
        overlay = phase_overlay(dev, sd, tiff["deflate"], tmp)
        torch.cuda.empty_cache()
        gaps = phase_parity_gaps(
            dev, sd, spec, os.path.join(tmp, "train_data", "train", "img",
                                        "smoke_slide.wsi.npz"),
            tiff["deflate"], os.path.join(tmp, "ms_models"), host_margins, tmp)
        torch.cuda.empty_cache()
        # phase 14 (h) here: it reads phase 12's level-2 store and phase 13's
        # slide root
        from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.losses import (
            class_weights_inv_min,
        )

        msds, ms_idx = ms_train["profile"][3:5]
        dp_h = phase_dp_paths(
            dev, ds, msds, ms_idx[:BATCH],
            class_weights_inv_min(msds.labels[ms_idx], 2), ext["root"],
            train["data_dir"], smi, tmp)
        torch.cuda.empty_cache()
        feature_launches = phase_features(dev, ds, sd, tmp)
        torch.cuda.empty_cache()
        tsne_row = phase_embedding(dev, feature_launches.pop("features"),
                                   feature_launches.pop("labels"), smi)
        torch.cuda.empty_cache()
        card = phase_card_gaps(dev, ds, slide, ref_u8, train,
                               os.path.join(tmp, "models"),
                               *ms_train["profile"][3:5], grid.num_patches,
                               smi, tmp)
        torch.cuda.empty_cache()
        # last: they run under torch.profiler, and host-clock walls taken in
        # this process after a profiler session come out longer
        phase_features_profile(dev, ds, sd)
        phase_train_profile(train.pop("trainer"), len(ds))
        phase_multiscale_profile(dev, slide, ms.pop("model"), ms["cal"])
        phase_ms_train_profile(dev, *ms_train.pop("profile"))
        phase_extract_profile(dev, ext["root"], tmp)
        phase_tiff_profile(dev, sd, tiff["deflate"])
        torch.cuda.empty_cache()
        tools = phase_legacy_tools(dev, train, smi, tmp)
    del ds

    jax_pkg = "ss25_hierarchical_multiscale_image_classification_tpu"
    ops = f"{jax_pkg}/ops/pallas"
    log(f"[paths] fused_normalize launches: slide path {kernel['launches']}, "
        f"FROC path {froc_launches}, multiscale path {ms['launches']}; int8 "
        f"multiscale path (fused_stage1_int8, int8_conv_requant, int8_maxpool) "
        f"{ms['int8_launches']}")
    log(f"[paths] --patch --train (streamed): augment launches "
        f"{ext['aug_launches']}; hard negatives mined {ext['mined']}")
    log(f"[paths] multiscale training: augment launches "
        f"{ms_train['aug_launches']}; fused_normalize launches from the "
        f"trained artifact {ms_train['ms_launches']}; int8 from the QAT "
        f"artifact (fused_stage1_int8, int8_conv_requant, int8_maxpool) "
        f"{ms_train['qat_launches']}")
    kernel["multiscale_launches"] = ms["launches"]
    kernel["trained_multiscale_launches"] = ms_train["ms_launches"]
    stage1["multiscale_launches"] = ms["int8_launches"][0]
    int8_conv["multiscale_launches"] = ms["int8_launches"][1]
    int8_pool["multiscale_launches"] = ms["int8_launches"][2]
    for k, row in zip(ms_train["qat_launches"], (stage1, int8_conv, int8_pool)):
        row["qat_launches"] = k
    aug["multiscale_train_launches"] = ms_train["aug_launches"]
    aug["patch_train_launches"] = ext["aug_launches"]
    # phase 14: the data-parallel steps' launches (both ranks) and the fleet's
    aug["dp_launches"] = dp["aug_launches"]
    kernel["fleet_launches"] = fleet["launches"]
    # phase 15: the TIFF paths
    kernel["tiff_launches"] = tiff["launches"]
    kernel["tiff_jpeg_launches"] = tiff["jpeg_launches"]
    kernel["tiff_multiscale_launches"] = tiff["multiscale_launches"]
    kernel["tiff_fleet_launches"] = tiff["fleet_launches"]
    # phase 14 (h): the group paths' launches, summed over the 2 gloo ranks
    h = dp_h["gloo"]["launches"]
    aug["dp_paths_launches"] = sum(c["augment"]
                                   for path in ("ms", "ms_step", "stream")
                                   for c in h[path])
    stem_pool["dp_paths_launches"] = sum(c["bias_relu_pool"]
                                         for c in h["features_bf16"])
    stem["dp_paths_launches"] = sum(c["fused_stem"] for c in h["features_s2d"])
    for i, (row, key) in enumerate(((stage1, "fused_stage1_int8"),
                                    (int8_conv, "int8_conv_requant"),
                                    (int8_pool, "int8_maxpool"))):
        row["dp_paths_launches"] = sum(c[key] for c in h["features_int8"])
        # phase 17: lazily calibrated int8, one device and split over two
        row["lazy_one_device_launches"] = gaps["single"]["one"][i]
        row["split_launches"] = gaps["single"]["split"][i]
        row["multiscale_lazy_one_device_launches"] = gaps["multi"]["one"][i]
        row["multiscale_split_launches"] = gaps["multi"]["split"][i]
        # phase 19: --simclr_features --int8 (lazy), int8 on trained weights
        row["simclr_int8_launches"] = card["a"]["int8"][i]
        row["trained_int8_launches"] = card["e"]["int8"][i]
    # phase 19: the paths that had run only on the CPU
    kernel["ms_combine_launches"] = card["d"]["fused_normalize"]
    kernel["trained_float_launches"] = card["e"]["fused_normalize"]
    kernel["model_name_launches"] = card["f"]
    stem_pool["simclr_features_launches"] = card["a"]["bias_relu_pool"]
    aug["balanced_launches"] = card["b"]["balanced"]
    aug["weighted_loss_launches"] = card["b"]["weighted_loss"]
    aug["frozen_bn_launches"] = card["c"]["frozen_bn"]
    aug["freeze_bn_cli_launches"] = card["c"]["freeze_bn_cli"]
    aug["attention_train_launches"] = card["d"]["augment"]
    log(f"[paths] phase 19: FROC int8 / float on trained weights "
        f"{card['e']['froc']}, margin cosine {card['e']['margin_cosine']:.5f},"
        f" worst reference cell's feature cosine "
        f"{card['e']['feature_cosine_min']:.5f} [{smi}]")
    log(f"[paths] phase 14 (h), {DP_RANKS_ON_ONE_CARD} gloo ranks: launches "
        f"a rank {json.dumps(h)}; single process "
        f"{json.dumps(dp_h['one'])}")
    log(f"[paths] phase 15 (h) --overlay exit 0 (matplotlib here: "
        f"{overlay['matplotlib']}); phase 16: bias_relu_pool launches under "
        f"--profile {tools['bias_relu_pool']}")
    log(f"[paths] TIFF: fused_normalize launches {tiff['launches']} (deflate "
        f"slide), {tiff['jpeg_launches']} (JPEG-YCbCr), "
        f"{tiff['multiscale_launches']} (JPEG-YCbCr multiscale), "
        f"{tiff['fleet_launches']} (fleet over two TIFFs)")
    log(f"[paths] data-parallel steps, {DP_RANKS_ON_ONE_CARD} ranks: augment "
        f"launches {dp['aug_launches']}, nt_xent_fwd and nt_xent_bwd "
        f"{dp['ntx_launches']} each; fleet: fused_normalize launches "
        f"{fleet['launches']}")
    rows = [("fused_normalize", "fused_normalize.cu", f"{ops}/preprocess.py:35",
             kernel)]
    for name, line in (("nt_xent_fwd", 63), ("nt_xent_bwd", 157)):
        rows.append((name, "nt_xent.cu", f"{ops}/nt_xent.py:{line}",
                     {"launches": simclr_launches[name], **ntxent[name],
                      "dp_launches": dp["ntx_launches"]}))
    rows.append(("mil_attention_pool", "mil_pool.cu", f"{ops}/mil_pool.py:33",
                 milpool))
    rows.append(("bias_relu_pool", "bias_relu_pool.cu",
                 f"{ops}/fused_stem.py:220",
                 {"launches": feature_launches["bias_relu_pool"], **stem_pool}))
    rows.append(("fused_stem", "fused_stem.cu", f"{ops}/fused_stem.py:115",
                 {"launches": feature_launches["fused_stem"], **stem}))
    rows.append(("fused_stage1_int8", "int8_block.cu", f"{ops}/int8_block.py:65",
                 {"launches": int8_launches["fused_stage1_int8"], **stage1}))
    # the port's own kernels: they stand for _convq + _requant and for the
    # int8 reduce_window, which XLA compiles in the JAX package (no Pallas
    # kernel there)
    rows.append(("int8_conv_requant", "int8_conv.cu",
                 f"{jax_pkg}/models/quantized.py:460",
                 {"launches": int8_launches["int8_conv_requant"], **int8_conv}))
    rows.append(("int8_maxpool", "int8_pool.cu",
                 f"{jax_pkg}/models/quantized.py:524",
                 {"launches": int8_launches["int8_maxpool"], **int8_pool}))
    # the port's own: XLA fuses augment_batch inside the JAX train step
    rows.append(("augment", "augment.cu", f"{jax_pkg}/data/augment.py:350",
                 {"launches": train["launches"], **aug}))
    # the port's own: XLA fuses the stem of the JAX training step
    rows.append(("stem_train", "stem_train.cu",
                 f"{jax_pkg}/models/resnet.py (stem of the training step)",
                 {"launches": simclr_launches["stem_train_fwd"], **stem_train}))
    # the port's own: the repulsive half of sklearn's Barnes–Hut gradient,
    # which the JAX package runs on the host through TSNE
    rows.append(("tsne_repulsion", "tsne_repulsion.cu",
                 f"{jax_pkg}/evaluation/features_eval.py:82", tsne_row))
    table = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"{PKG}/ops/csrc/{source}",
        "replaces": replaces,
        "launches": k["launches"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": k["library_ms"],
        **{key: k[key] for key in ("bound_fp32_ms", "bound_sfu_ms",
                                   "bound_pipe",
                                   "back_to_back_ms", "by_rows",
                                   "iteration_ms",
                                   "tsne_10k_launches", "tsne_full_launches",
                                   "kernel_ms", "kernel_back_to_back_ms",
                                   "forward_ms", "design_mb",
                                   "multiscale_launches",
                                   "trained_multiscale_launches",
                                   "qat_launches", "multiscale_train_launches",
                                   "patch_train_launches", "dp_launches",
                                   "fleet_launches", "tiff_launches",
                                   "tiff_jpeg_launches",
                                   "tiff_multiscale_launches",
                                   "tiff_fleet_launches", "dp_paths_launches",
                                   "lazy_one_device_launches", "split_launches",
                                   "multiscale_lazy_one_device_launches",
                                   "multiscale_split_launches",
                                   "simclr_features_launches",
                                   "simclr_int8_launches",
                                   "trained_int8_launches",
                                   "trained_float_launches",
                                   "ms_combine_launches",
                                   "model_name_launches",
                                   "balanced_launches",
                                   "weighted_loss_launches",
                                   "frozen_bn_launches",
                                   "freeze_bn_cli_launches",
                                   "attention_train_launches")
           if key in k},
    } for name, source, replaces, k in rows]}
    log(f"[smoke] every phase passed in {time.perf_counter() - t_start:.1f} s "
        f"[{smi}]")
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(json.dumps(table))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
