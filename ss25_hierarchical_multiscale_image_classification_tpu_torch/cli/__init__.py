"""Command line of the port (``main.py``).

The names of the JAX package's ``cli`` resolve here at first use."""

from ss25_hierarchical_multiscale_image_classification_tpu_torch._exports import (
    lazy_exports,
)

__getattr__, __dir__ = lazy_exports(__name__, {
    "build_parser": "main",
    "main": "main",
})
