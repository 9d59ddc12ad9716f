"""HiPAC on PyTorch and CUDA: the port of the JAX package for NVIDIA Hopper.

The JAX package (``ss25_hierarchical_multiscale_image_classification_tpu``)
is the reference; this package mirrors its subpackage layout and names
(``models/resnet.py``, ``ops/…``, ``infer/sliding_window.py``,
``cli/main.py``, ``config.py``, ``grid/``, ``io/``) so each counterpart is
easy to find. It imports ``torch`` and loads nothing of JAX or of the JAX
package: the few host pieces it needs from there (constants, the patch
grid, the ``.wsi.npz`` reader, the numpy synthetic slide, NMS and the CSV
writer) are copies, held to the originals by exact-equality tests.

Public functions keep the JAX package's NHWC layout; inside, the model runs
NCHW in ``channels_last`` memory format. Every kernel that the JAX package
wrote in Pallas is a hand-written CUDA kernel here (``ops/csrc/``), with a
plain PyTorch version beside it that CPU tensors take.
"""

__version__ = "0.1.0"

from ss25_hierarchical_multiscale_image_classification_tpu_torch._exports import (
    lazy_exports,
)

# ``Config`` and ``get_config``, and the subpackages, at first use
__getattr__, __dir__ = lazy_exports(__name__, {
    "Config": "config",
    "get_config": "config",
    **{name: name for name in ("io", "grid", "data", "models", "ops",
                               "parallel", "train", "infer", "evaluation",
                               "visualization", "utils", "cli")},
})
