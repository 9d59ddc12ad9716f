"""SimCLR self-supervised pretraining on one card.

Counterpart of the JAX package's ``train/simclr_trainer.py``
(``make_simclr_train_step``, ``pretrain_simclr``), with the same epochs,
batch, Adam, τ, best-loss tracking, periodic checkpoints, early stop, final
``simclr_encoder`` artifact, log lines and seeds; an epoch is
:func:`simclr_epoch`. A step makes the two views on the device, runs the
model twice in training mode (bf16 autocast over float32 parameters on the
card; the second forward starts from the running statistics the first
updated), takes the loss with the ``valid`` mask of a wrap-padded final
batch, and applies Adam. ``loss_impl="pallas"`` runs the
hand-written NT-Xent kernels (``ops/nt_xent.py``), ``"xla"`` the dense loss.
The host's time in each part of a step is a span (``utils/profiling.py``):
``hipac.simclr.views``, ``.forward``, ``.loss``, ``.backward`` and
``.optimizer``; the device runs the work later.

With a process ``group`` it is the JAX trainer's SPMD step over the ranks:
each rank loads its rows of every global batch, the views are drawn for the
global batch, BatchNorm takes the global statistics, NT-Xent scores each
rank's rows against every rank's columns, and the gradients are summed over
the ranks; rank 0 writes the artifacts.
"""

from __future__ import annotations

import time

import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    Config,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
    simclr_two_views,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
    BatchIterator,
    PatchDataset,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
    load_or_scan_manifest,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
    resolve_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
    set_process_group,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.simclr import (
    SimCLRModel,
    nt_xent_loss,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.nt_xent import (
    nt_xent_loss_kernel,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.feed import (
    process_batch_slice,
    to_device,
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
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
    TrainState,
    create_train_state,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.utils.profiling import (
    annotate,
)

log = get_logger("train.simclr")


def simclr_loss(model: torch.nn.Module, v1: torch.Tensor, v2: torch.Tensor,
                temperature: float, valid: torch.Tensor | None = None,
                loss_impl: str = "xla", group=None) -> torch.Tensor:
    """The step's loss: two training-mode forwards (under bf16 autocast on
    the card), then NT-Xent in float32 outside the autocast. Each forward
    normalizes with its own batch statistics and moves the running ones.
    ``group``: NT-Xent over the ranks' global batch (the value global, the
    gradient this rank's share)."""
    loss_fn = nt_xent_loss_kernel if loss_impl == "pallas" else nt_xent_loss
    on_card = v1.device.type == "cuda"
    with annotate("hipac.simclr.forward"), torch.autocast(
            "cuda", torch.bfloat16, enabled=on_card):
        z1 = model(v1)
        z2 = model(v2)
    # wrap-padded rows (uneven final batch) are masked out of the loss mean
    # and of every real row's NT-Xent denominator, not out of BN
    with annotate("hipac.simclr.loss"):
        return loss_fn(z1, z2, temperature, valid=valid, group=group)


def make_simclr_train_step(temperature: float, out_size: int = 224,
                           loss_impl: str = "xla", group=None):
    """``train_step(state, generator, imgs_u8, valid) → (state, loss)``:
    views from ``generator``, loss, backward and one Adam update; the loss
    comes back as a device scalar, not fetched. With a ``group`` the batch
    is this rank's rows of the global batch, the draws are the global
    batch's, the loss is the global loss and the gradients are summed over
    the group before Adam (the model's BatchNorm takes the group,
    ``set_process_group``)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.collectives import (
        all_reduce_grads,
    )

    rank, world = rank_and_size(group)

    def train_step(state: TrainState, generator: torch.Generator,
                   imgs_u8: torch.Tensor, valid: torch.Tensor):
        b = imgs_u8.shape[0]
        with annotate("hipac.simclr.views"):
            v1, v2 = simclr_two_views(generator, imgs_u8, out_size=out_size,
                                      rows=None if group is None
                                      else (rank * b, world * b))
        with annotate("hipac.simclr.optimizer"):
            state.optimizer.zero_grad(set_to_none=True)
        loss = simclr_loss(state.model, v1, v2, temperature, valid, loss_impl,
                           group)
        with annotate("hipac.simclr.backward"):
            loss.backward()
        if group is not None:
            all_reduce_grads(state.model.parameters(), group)
        with annotate("hipac.simclr.optimizer"):
            state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return train_step


def simclr_epoch(state: TrainState, train_step, batches: BatchIterator,
                 generator: torch.Generator,
                 device: torch.device) -> tuple[TrainState, float]:
    """One epoch: each batch of ``batches`` to ``device`` (``to_device``),
    then ``train_step``; the state and the epoch's mean loss (the losses
    stay on the device until the epoch ends; 0.0 for no batch)."""
    losses = []
    for imgs, _labels, valid in batches:
        imgs_t = to_device(imgs, device)
        valid_t = to_device(valid, device).bool()
        state, loss = train_step(state, generator, imgs_t, valid_t)
        losses.append(loss)
    epoch_loss = (
        float(sum(torch.stack(losses).cpu().numpy())) / len(losses)
        if losses else 0.0
    )
    return state, epoch_loss


def pretrain_simclr(
    cfg: Config,
    level: int = 3,
    epochs: int | None = None,
    dataset: PatchDataset | None = None,
    input_size: int | None = None,
    device: str | torch.device = "cuda",
    group=None,
) -> dict[str, torch.Tensor]:
    """Run SimCLR pretraining on ``device``; returns the final model's state
    dict (on the CPU) and writes the ``simclr_encoder`` (+``_best``,
    periodic) artifacts under ``cfg.models_dir``. ``"cuda"`` without a card
    raises. ``group``: one rank of data-parallel pretraining over the global
    batch ``simclr.batch_size`` (rank 0 writes; every rank returns the same
    weights)."""
    dev = resolve_device(device)
    sc = cfg.simclr
    epochs = epochs or sc.epochs
    if dataset is None:
        manifest = load_or_scan_manifest(cfg.data.patches_dir, level)
        dataset = PatchDataset(manifest)
    out_size = input_size or dataset.resize_to

    model = SimCLRModel(
        projection_dim=sc.projection_dim,
        projection_hidden_dim=sc.projection_hidden_dim,
        generator=torch.Generator().manual_seed(sc.seed),
    )
    set_process_group(model, group)
    state = create_train_state(model, sc.learning_rate, dev)
    replicate(model, group)
    train_step = make_simclr_train_step(sc.temperature, out_size, sc.loss_impl,
                                        group)
    batches = BatchIterator(dataset, sc.batch_size, seed=sc.seed,
                            rows=process_batch_slice(sc.batch_size,
                                                     *rank_and_size(group)))
    main = is_main(group)
    generator = torch.Generator(device=dev).manual_seed(sc.seed + 17)

    prefix = model_artifact_path(cfg.models_dir, "simclr_encoder")
    best_loss = float("inf")
    epochs_since_best = 0

    def variables() -> dict[str, torch.Tensor]:
        return {k: v.detach().cpu().clone()
                for k, v in state.model.state_dict().items()}

    for epoch in range(epochs):
        t0 = time.perf_counter()
        state, epoch_loss = simclr_epoch(state, train_step, batches,
                                         generator, dev)
        log.info(
            "SimCLR epoch %d/%d: loss %.4f (%.1fs)",
            epoch + 1, epochs, epoch_loss, time.perf_counter() - t0,
        )

        # best tracking + early stop, the JAX trainer's cadence
        # (the loss is the global one: every rank takes the same branches)
        if epoch_loss < best_loss:
            best_loss = epoch_loss
            epochs_since_best = 0
            if main:
                save_model(prefix + "_best", variables())
        else:
            epochs_since_best += 1
        if main and (epoch + 1) % sc.checkpoint_every_epochs == 0:
            save_model(f"{prefix}_epoch{epoch + 1}", variables())
        if (
            (epoch + 1) % sc.early_stop_check_every == 0
            and epochs_since_best >= sc.early_stop_patience
        ):
            log.info("SimCLR early stop at epoch %d (best %.4f)", epoch + 1, best_loss)
            break

    final = variables()
    if main:
        save_model(prefix, final)
        log.info("SimCLR pretraining complete; encoder saved %s", prefix)
    barrier(group)
    return final
