"""Attention-MIL slide classifier: training and slide-level prediction.

Counterpart of the JAX package's ``train/mil_trainer.py``
(``train_mil_classifier``, ``mil_predict``): bags from the feature store →
masked MIL classifier → slide-level probabilities with the attention map
and MC-dropout uncertainty. Training is plain PyTorch float32 with Adam, as
the JAX trainer trains the module; prediction pools bags of
``streaming_bag_threshold``+ instances, and every MC-dropout bag, through
the hand-written kernel (``ops/mil_pool.py``), then samples only the head.
The JAX keys become generators: dropout masks from one seeded
``cfg.train.seed + 5``, weights from one seeded ``cfg.train.seed``.
"""

from __future__ import annotations

import numpy as np
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    Config,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.mil import (
    Bag,
    MILBagIterator,
    bags_from_artifacts,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
    resolve_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation.uncertainty import (
    monte_carlo_dropout,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.mil import (
    MILClassifier,
    apply_head,
    attention_weights,
    pad_bag,
    streaming_attention_pool,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
    model_artifact_path,
    save_model,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.losses import (
    weighted_cross_entropy,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.simclr_trainer import (
    to_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
    TrainState,
    create_train_state,
)

log = get_logger("train.mil")


def _classifier(cfg: Config, input_dim: int,
                generator: torch.Generator | None = None) -> MILClassifier:
    mc = cfg.mil
    return MILClassifier(
        input_dim=input_dim,
        num_classes=mc.num_classes,
        attention_hidden_dim=mc.attention_hidden_dim,
        head_hidden_dim=mc.head_hidden_dim,
        pooling=mc.pooling,
        dropout_rate=mc.dropout_rate,
        generator=generator,
    )


def train_step(state: TrainState, generator: torch.Generator,
               feats: torch.Tensor, mask: torch.Tensor, labels: torch.Tensor,
               valid: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Adam step on a bag batch with dropout masks from ``generator``;
    returns (loss, correct, count) as device scalars, not fetched."""
    state.optimizer.zero_grad(set_to_none=True)
    logits, _ = state.model(feats, mask, train=True, generator=generator)
    loss = weighted_cross_entropy(logits, labels, None, valid)
    loss.backward()
    state.optimizer.step()
    correct = ((logits.detach().argmax(dim=-1) == labels) * valid).sum()
    return loss.detach(), correct, valid.sum()


def train_mil_classifier(
    cfg: Config,
    level: int = 3,
    bags: list[Bag] | None = None,
    epochs: int | None = None,
    val_fraction: float = 0.2,
    device: str | torch.device = "cuda",
) -> dict:
    """Train the attention-MIL bag classifier on ``device``.

    Returns {"variables" (the state dict, on the CPU), "history",
    "val_accuracy", "max_bag_size"} and writes the ``mil_classifier``
    artifact (``<models_dir>/mil_classifier.pt``). ``"cuda"`` without a card
    raises.
    """
    dev = resolve_device(device)
    mc = cfg.mil
    if bags is None:
        bags = bags_from_artifacts(cfg.data.features_dir, level)
    if not bags:
        raise FileNotFoundError(
            "no feature artifacts to build bags from; run --extract_features"
        )
    # slide-level split, as the JAX trainer draws it
    rng_np = np.random.default_rng(cfg.train.seed)
    order = rng_np.permutation(len(bags))
    n_val = max(1, int(len(bags) * val_fraction)) if len(bags) > 1 else 0
    val_bags = [bags[i] for i in order[:n_val]]
    train_bags = [bags[i] for i in order[n_val:]] or bags

    d = train_bags[0].features.shape[1]
    max_bag = min(mc.max_bag_size, max(len(b.features) for b in bags))
    model = _classifier(cfg, d, torch.Generator().manual_seed(cfg.train.seed))
    state = create_train_state(model, mc.learning_rate, dev)

    epochs = epochs or mc.epochs
    batches = MILBagIterator(
        train_bags, batch_size=8, max_bag_size=max_bag, seed=cfg.train.seed
    )
    generator = torch.Generator(device=dev).manual_seed(cfg.train.seed + 5)
    history = []
    for epoch in range(epochs):
        step_out = []  # device scalars; fetched once per epoch
        for feats, mask, labels, valid in batches:
            step_out.append(train_step(
                state, generator, to_device(feats, dev), to_device(mask, dev),
                to_device(labels, dev), to_device(valid, dev)))
        fetched = torch.stack([torch.stack(v) for v in step_out]).double().cpu()
        total_loss, correct, count = fetched.sum(dim=0).tolist()
        acc = correct / max(count, 1.0)
        history.append({"epoch": epoch, "loss": total_loss, "acc": acc})
        log.info("MIL epoch %d/%d: loss %.4f acc %.4f", epoch + 1, epochs,
                 total_loss, acc)

    # validation
    model.eval()
    val_correct = 0
    with torch.no_grad():
        for bag in val_bags:
            feats, mask, _, _ = next(
                iter(MILBagIterator([bag], 1, max_bag, shuffle=False))
            )
            logits, _ = model(to_device(feats, dev), to_device(mask, dev))
            val_correct += int(logits[0].argmax().item() == bag.label)
    val_acc = val_correct / len(val_bags) if val_bags else float("nan")
    log.info("MIL validation accuracy: %.4f (%d slides)", val_acc, len(val_bags))

    out = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    save_model(model_artifact_path(cfg.models_dir, "mil_classifier"), out)
    return {"variables": out, "history": history, "val_accuracy": val_acc,
            "max_bag_size": max_bag}


def mil_predict(
    variables: dict[str, torch.Tensor],
    bag_features: np.ndarray,
    cfg: Config,
    mc_dropout: bool = False,
    generator: torch.Generator | None = None,
    return_attention: bool = True,
    streaming: bool | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Slide-level prediction of one bag (K, D) on ``device``: probabilities,
    prediction, attention map and, with ``mc_dropout``, the MC-dropout mean
    and population variance over ``cfg.uncertainty.monte_carlo_samples``.

    ``variables`` is a ``MILClassifier`` state dict. Bags of
    ``cfg.mil.streaming_bag_threshold``+ instances pool through the streaming
    kernel instead of the module (same numbers); ``streaming`` forces the
    choice either way. MC dropout pools once (through the kernel, with
    attention pooling) and samples only the head, its keep masks from
    ``generator`` (one seeded 0 on ``device`` when none is given).
    """
    dev = resolve_device(device)
    mc = cfg.mil
    params = {k: v.to(dev) for k, v in variables.items()}

    k = min(len(bag_features), mc.max_bag_size)
    # no copy of a float32 bag (JAX's astype copies it: the same values)
    feats_np, mask_np = pad_bag(np.asarray(bag_features, np.float32), max(k, 1))
    feats = torch.from_numpy(feats_np[None]).to(dev)
    mask = torch.from_numpy(mask_np[None]).to(dev)
    if streaming is None:
        streaming = mc.pooling == "attention" and k >= mc.streaming_bag_threshold

    model = None
    pooled = None
    with torch.no_grad():
        if streaming:
            pooled = streaming_attention_pool(params, feats, mask)  # (1, D)
            logits = apply_head(params, pooled)
            attn = (attention_weights(params, feats, mask)
                    if return_attention else None)
        else:
            model = _classifier(cfg, feats.shape[-1]).to(dev)
            model.load_state_dict(params)
            logits, attn = model(feats, mask)
            if not return_attention:
                attn = None
        probs = torch.softmax(logits, dim=-1)[0].cpu().numpy()
        out = {
            "probs": probs,
            "prediction": int(np.argmax(probs)),
            "attention": None if attn is None else attn[0, :k].cpu().numpy(),
        }
        if mc_dropout:
            n_samples = cfg.uncertainty.monte_carlo_samples
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            if mc.pooling == "attention" and pooled is None:
                # pooling is deterministic for every mode; reuse it across
                # samples on the module path too
                pooled = streaming_attention_pool(params, feats, mask)
            if pooled is not None:
                sample_probs = torch.softmax(
                    apply_head(params, pooled.expand(n_samples, *pooled.shape),
                               mc.dropout_rate, generator),
                    dim=-1,
                )  # (S, 1, C)
                mean = sample_probs.mean(dim=0)
                var = sample_probs.var(dim=0, correction=0)
            else:
                mean, var = monte_carlo_dropout(
                    lambda x, g: model(x, mask.expand(x.shape[0], -1),
                                       train=True, generator=g),
                    feats, generator, n_samples)
            out["mc_mean"] = mean[0].cpu().numpy()
            out["mc_variance"] = var[0].cpu().numpy()
    return out
