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

With a process ``group`` (``torchrun``, one process a card: ``parallel/``)
rank 0 alone extracts, since the store is one set of files on one disk and
a second writer would race it; it broadcasts each global batch of the
stream to the ranks (a header first: a batch follows, the stream ended, or
the extraction failed, which then raises on every rank), and each rank
trains on its contiguous rows of it with the data-parallel step of
``train/trainer.py`` (the augmentation drawn for the global batch, the
``augment`` kernel on the rank's rows, BatchNorm over the global batch, the
gradients summed over the ranks). The validation slides stay held out of
the stream; the epochs after it run the data-parallel store-based trainer.
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
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
    set_process_group,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.feed import (
    process_batch_slice,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.mesh import (
    barrier,
    is_main,
    rank_and_size,
    replicate,
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


def _group_batches(batches, batch_size: int, resize_to: int,
                   dev: torch.device, group):
    """Rank 0's global batches of ``batches`` (None on the other ranks)
    broadcast to every rank of ``group``: yields (images, labels, valid) of
    this rank's rows on ``dev`` and the global batch's valid count."""
    import torch.distributed as dist

    rank, world = rank_and_size(group)
    src = dist.get_global_rank(group, 0)
    rows = process_batch_slice(batch_size, rank, world)
    it = iter(batches) if rank == 0 else None
    while True:
        head = torch.zeros(1, dtype=torch.int64, device=dev)
        imgs = torch.empty((batch_size, resize_to, resize_to, 3),
                           dtype=torch.uint8, device=dev)
        labels = torch.empty(batch_size, dtype=torch.int64, device=dev)
        valid = torch.empty(batch_size, dtype=torch.float32, device=dev)
        err = None
        if it is not None:
            try:
                batch = next(it)
                head.fill_(1)
                for t, a in zip((imgs, labels, valid), batch):
                    t.copy_(torch.from_numpy(a))
            except StopIteration:
                pass
            except Exception as e:  # sent to every rank, raised below
                err = e
                head.fill_(-1)
        dist.broadcast(head, src, group=group)
        state = int(head.item())
        if state == 0:
            return
        if state < 0:
            if err is not None:
                raise err
            raise RuntimeError("the streamed extraction failed on rank 0")
        for t in (imgs, labels, valid):
            dist.broadcast(t, src, group=group)
        yield imgs[rows], labels[rows], valid[rows], int(valid.sum())


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
    group=None,
) -> dict:
    """The combined ``--patch --train`` pipeline (module docstring) on
    ``device``, which also runs the device extraction and ``stain_norm``.

    Returns the trainer's result: ``streamed_epoch`` (loss summed over the
    steps, accuracy, patches seen), ``history`` (epochs 1+) and
    ``variables`` (the final state dict on the CPU). With ``epochs == 1``
    the streamed epoch's weights are saved as ``resnet18_patch_classifier``.
    ``group``: one rank of the data-parallel trainer (``batch_size`` is the
    global batch, which the group's size must divide; rank 0 extracts and
    writes, every rank returns the same weights).
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
    model = _classifier(cfg)
    set_process_group(model, group)
    state = create_train_state(model, cfg.train.learning_rate, dev)
    replicate(model, group)
    step = make_train_step(None, frozen_bn=cfg.train.freeze_bn, group=group)
    generator = torch.Generator(device=dev).manual_seed(cfg.train.seed + 1)

    main = is_main(group)
    thread = threading.Thread(target=producer, daemon=True)
    if main:
        thread.start()
    stream = _stream_batches(rec_q, batch_size, resize_to) if main else None
    if group is None:
        batches = ((to_device(imgs, dev),
                    to_device(labels.astype(np.int64), dev),
                    to_device(valid, dev), int(valid.sum()))
                   for imgs, labels, valid in stream)
    else:
        batches = _group_batches(stream, batch_size, resize_to, dev, group)
    n_seen = 0
    step_metrics = []
    with Timer("streamed epoch 0 (extraction-overlapped)", log):
        for imgs, labels, valid, n_valid in batches:
            state, m = step(state, generator, imgs, labels, valid)
            step_metrics.append(m)
            n_seen += n_valid
    if main:
        thread.join()
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.collectives import (
        epoch_totals,
    )

    totals = epoch_totals(step_metrics, group, dev)
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
    barrier(group)  # rank 0's store is complete
    if epochs > 1:
        trainer = train_resnet_classifier(
            cfg, level=level, epochs=epochs - 1,
            pretrained_variables=variables, device=dev, group=group,
        )
        result["history"] = trainer.history
        result["variables"] = trainer.variables()
    else:
        if main:
            save_model(model_artifact_path(cfg.models_dir,
                                           "resnet18_patch_classifier"),
                       variables)
        barrier(group)
        result["history"] = []
    return result
