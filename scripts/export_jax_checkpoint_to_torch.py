"""Export a JAX-package ResNet18, SimCLR, MIL or multiscale artifact (Orbax) to the PyTorch port's ``.pt``.

Reads the artifact with the JAX package's ``train/checkpoints.py::load_model``
and writes the state dict that the port loads: torchvision layout for a
ResNet18 (what ``models.convert.load_state_dict_file`` and the port's CLI
read), the port's ``SimCLRModel`` layout (``encoder.*``, ``projector.*``)
for a ``simclr_encoder`` artifact, the port's ``MILClassifier`` layout
(``attention.*``, ``dense_0.*``, ``dense_1.*``) for a ``mil_classifier``
artifact, and the port's ``HierarchicalPatchClassifier`` layout (``trunk.*``,
``scale_embed``, the heads, and the calibration as ``calibration.<key>``
0-d float64 tensors) for a ``hierarchical_classifier`` artifact. The
multiscale artifact is written in ``models/convert.py::hierarchical_artifact``'s
format, the one the port's ``--train_multiscale`` writes, and checked
against it: the converted weights, loaded into the port's module and put
through that function with the same calibration, must give the same keys,
dtypes and values. Needs JAX, so it runs where the JAX package runs; the
port's machine only reads the ``.pt``.

    python scripts/export_jax_checkpoint_to_torch.py \\
        models_out/resnet18_patch_classifier [models_out/resnet18_patch_classifier.pt]
    python scripts/export_jax_checkpoint_to_torch.py \\
        models_out/hierarchical_classifier   # for --predict_slide --multiscale

The output defaults to the artifact path plus ``.pt``: the name the port's
CLI looks for under ``--models_dir`` with the same ``--model_name``.

An int8 artifact (``quantized_resnet18.npz`` or
``quantized_hierarchical_trunk.npz``, written by ``--quantize`` of either
package) needs no export: it is a plain ``.npz`` with the same keys
and HWIO kernels on both sides, and the port's
``models/quant_artifact.py::load_quantized`` reads it as it is.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ss25_hierarchical_multiscale_image_classification_tpu.train.checkpoints import (
    load_model,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    hierarchical_artifact,
    hierarchical_from_state_dict,
    hierarchical_state_dict_from_flax,
    mil_state_dict_from_flax,
    simclr_state_dict_from_flax,
    split_calibration,
    state_dict_from_flax,
)


def check_hierarchical_format(sd: dict) -> None:
    """Raise unless ``sd`` is what the port's multiscale trainer writes for
    the same weights and calibration: the same keys, dtypes and shapes,
    equal values."""
    state, calibration = split_calibration(sd)
    levels = tuple(range(int(state["scale_embed"].shape[0])))
    model = hierarchical_from_state_dict(state, levels)
    want = hierarchical_artifact(model.state_dict(), calibration)
    if set(want) != set(sd):
        raise ValueError(f"keys differ from the trainer's artifact: "
                         f"{sorted(set(want) ^ set(sd))}")
    for key, value in want.items():
        got = sd[key]
        if (got.dtype != value.dtype or got.shape != value.shape
                or not torch.equal(got, value)):
            raise ValueError(f"{key} differs from the trainer's artifact")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("artifact", help="Orbax model artifact directory")
    parser.add_argument("output", nargs="?", default=None,
                        help="destination .pt (default: <artifact>.pt)")
    args = parser.parse_args(argv)
    src = os.path.abspath(args.artifact.rstrip("/"))
    dst = args.output or f"{src}.pt"
    variables = load_model(src)
    params = variables["params"]
    if "scale_embed" in params:  # the multiscale classifier
        convert = hierarchical_state_dict_from_flax
    elif "projector" in params:
        convert = simclr_state_dict_from_flax
    elif "Dense_1" in params:  # the MIL classifier's head
        convert = mil_state_dict_from_flax
    else:
        convert = state_dict_from_flax
    sd = convert(variables)
    if convert is hierarchical_state_dict_from_flax:
        check_hierarchical_format(sd)
    torch.save(sd, dst)
    print(f"{src} → {dst} ({len(sd)} tensors)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
