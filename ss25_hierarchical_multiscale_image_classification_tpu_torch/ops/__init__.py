"""Hand-written CUDA kernels (``csrc/``), their build, and their wrappers
with plain PyTorch versions beside them.

The JAX package's ``ops`` names resolve here at first use; its
``nt_xent_loss_pallas`` is ``nt_xent_loss_kernel`` here."""

from ss25_hierarchical_multiscale_image_classification_tpu_torch._exports import (
    lazy_exports,
)

__getattr__, __dir__ = lazy_exports(__name__, {
    "nt_xent_loss_kernel": "nt_xent",
    "fused_normalize": "preprocess",
})
