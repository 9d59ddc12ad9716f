"""Slides → trained classifier in one command: extraction streams into the
first epoch (``--patch --train``).

Counterpart of the JAX package's ``train/streaming.py``. A producer thread
runs the extraction (``data/extract.py``) and hands each finished slide's
records through a queue of two to the trainer, whose first epoch trains on
slides as they land (one slide's patches resident at a time). The
validation split depends only on the slide names, known before any pixel
is decoded, so validation slides are held out of that epoch by name. Once
extraction ends, the remaining epochs run the store-based weighted-loss
trainer (``train/trainer.py::train_resnet_classifier``) over the whole
manifest, warm-started from the streamed epoch's weights.

By design, as in JAX: epoch 0 visits patches in extraction order and uses
unweighted cross entropy (the class counts are unknown until extraction
ends). The step is the port's ``make_train_step(None, frozen_bn)``, so the
augmentation runs on the ``augment`` kernel on the card; its draws come
from a ``torch.Generator`` seeded ``train.seed + 1``.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    INPUT_SIZE,
    Config,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
    slide_level_split,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.extract import (
    extract_patches,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
    PatchManifest,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.patch_store import (
    PatchReader,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
    resolve_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.download import (
    list_slides,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    Timer,
    get_logger,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
    model_artifact_path,
    save_model,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.simclr_trainer import (
    to_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
    create_train_state,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.trainer import (
    _classifier,
    make_train_step,
    train_resnet_classifier,
)

log = get_logger("train.streaming")


def _stream_batches(rec_queue, batch_size: int, resize_to: int):
    """Yield (imgs, labels, valid) static-shape batches from per-slide
    record lists as they arrive; the tail wrap-pads with a validity mask.

    Only the current slide's reader is open and at most one batch of images
    is buffered: memory stays O(batch + one slide's records)."""
    buf_imgs: list[np.ndarray] = []
    buf_labels: list[int] = []

    def drain(final: bool = False):
        while len(buf_imgs) >= batch_size:
            imgs = np.stack(buf_imgs[:batch_size])
            labels = np.asarray(buf_labels[:batch_size], np.int32)
            del buf_imgs[:batch_size], buf_labels[:batch_size]
            yield imgs, labels, np.ones((batch_size,), np.float32)
        if final and buf_imgs:
            n = len(buf_imgs)
            valid = np.zeros((batch_size,), np.float32)
            valid[:n] = 1.0
            while len(buf_imgs) < batch_size:  # wrap-pad (BatchIterator's rule)
                buf_imgs.append(buf_imgs[len(buf_imgs) % n])
                buf_labels.append(buf_labels[len(buf_labels) % n])
            yield (np.stack(buf_imgs), np.asarray(buf_labels, np.int32),
                   valid)
            buf_imgs.clear()
            buf_labels.clear()

    while True:
        item = rec_queue.get()
        if item is None:
            break
        if isinstance(item, BaseException):
            raise item
        recs = item
        if not recs:
            continue
        m = PatchManifest(recs)
        reader = PatchReader(m)
        imgs = reader.read_batch(list(range(len(m))), resize_to=resize_to)
        for img, lab in zip(imgs, m.labels()):
            buf_imgs.append(img)
            buf_labels.append(int(lab))
        yield from drain()
    yield from drain(final=True)


def train_resnet_classifier_streaming(
    cfg: Config,
    level: int = 3,
    epochs: int | None = None,
    stride: int | None = None,
    batch_size: int | None = None,
    store_format: str | None = None,
    extract_impl: str = "host",
    stain_norm: bool = False,
    device: str | torch.device = "cuda",
) -> dict:
    """The combined ``--patch --train`` pipeline (module docstring) on
    ``device``, which also runs the device extraction and ``stain_norm``.

    Returns the trainer's result: ``streamed_epoch`` (loss summed over the
    steps, accuracy, patches seen), ``history`` (epochs 1+) and
    ``variables`` (the final state dict on the CPU). With ``epochs == 1``
    the streamed epoch's weights are saved as ``resnet18_patch_classifier``.
    """
    dev = resolve_device(device)
    epochs = epochs or cfg.train.epochs
    batch_size = batch_size or cfg.train.batch_size
    resize_to = INPUT_SIZE

    slide_names = [n for n, _p in list_slides(cfg.data.train_img_dir)]
    _train_slides, val_slides = slide_level_split(
        slide_names, cfg.data.val_fraction, cfg.data.split_seed
    )
    val_set = set(val_slides)
    log.info(
        "streaming train: %d slides (%d train / %d val held out of the "
        "streamed epoch)", len(slide_names), len(_train_slides), len(val_set),
    )

    rec_q: queue.Queue = queue.Queue(maxsize=2)

    def producer():
        try:
            extract_patches(
                cfg.data, level=level, stride=stride,
                store_format=store_format or cfg.data.patch_store_format,
                impl=extract_impl, stain_norm=stain_norm, device=dev,
                on_slide=lambda name, recs: rec_q.put(
                    [] if name in val_set else recs
                ),
            )
            rec_q.put(None)
        except BaseException as e:
            rec_q.put(e)

    # the store-based epochs' model exactly: epoch 1 warm-starts from it
    state = create_train_state(_classifier(cfg), cfg.train.learning_rate, dev)
    step = make_train_step(None, frozen_bn=cfg.train.freeze_bn)
    generator = torch.Generator(device=dev).manual_seed(cfg.train.seed + 1)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    n_seen = 0
    step_metrics = []
    with Timer("streamed epoch 0 (extraction-overlapped)", log):
        for imgs, labels, valid in _stream_batches(
            rec_q, batch_size, resize_to
        ):
            state, m = step(state, generator, to_device(imgs, dev),
                            to_device(labels.astype(np.int64), dev),
                            to_device(valid, dev))
            step_metrics.append(m)
            n_seen += int(valid.sum())
    thread.join()
    totals = {k: float(torch.stack([m[k] for m in step_metrics]).sum())
              if step_metrics else 0.0 for k in ("loss", "correct", "count")}
    ep0 = {
        "epoch": 0,
        "loss": totals["loss"],
        "acc": totals["correct"] / max(totals["count"], 1.0),
        "patches": n_seen,
    }
    log.info("streamed epoch 0: loss %.4f acc %.4f over %d patches",
             ep0["loss"], ep0["acc"], ep0["patches"])

    # epochs 1+: the store-based weighted-loss path, warm-started
    variables = {k: v.detach().cpu().clone()
                 for k, v in state.model.state_dict().items()}
    result: dict = {"streamed_epoch": ep0, "variables": variables}
    if epochs > 1:
        trainer = train_resnet_classifier(
            cfg, level=level, epochs=epochs - 1,
            pretrained_variables=variables, device=dev,
        )
        result["history"] = trainer.history
        result["variables"] = trainer.variables()
    else:
        save_model(
            model_artifact_path(cfg.models_dir, "resnet18_patch_classifier"),
            variables,
        )
        result["history"] = []
    return result
