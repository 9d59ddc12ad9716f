"""Training: trainers, losses, train state, checkpoints, SimCLR pretraining.

The names of the JAX package's ``train`` resolve here at first use."""

from ss25_hierarchical_multiscale_image_classification_tpu_torch._exports import (
    lazy_exports,
)

__getattr__, __dir__ = lazy_exports(__name__, {
    "TrainState": "state",
    "create_train_state": "state",
    "class_weights_inv_min": "losses",
    "class_weights_total_over_count": "losses",
    "weighted_cross_entropy": "losses",
    "Trainer": "trainer",
    "train_resnet_classifier": "trainer",
    "train_resnet_classifier_strategic": "trainer",
    "pretrain_simclr": "simclr_trainer",
})
