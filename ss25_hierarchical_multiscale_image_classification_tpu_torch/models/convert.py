"""Weights across the frameworks: flax variables → the port's state dict.

:func:`state_dict_from_flax` is the inverse of the JAX package's
``models/torch_import.py::from_torch_state_dict``:

    stem_conv / stem_norm                  → conv1 / bn1
    stage{L}_block{B}.Conv_{0,1[,2]}       → layer{L}.{B}.conv{1,2[,3]}
    stage{L}_block{B}.BatchNorm_{0,1[,2]}  → layer{L}.{B}.bn{1,2[,3]}
    stage{L}_block{B}.downsample_{conv,norm} → layer{L}.{B}.downsample.{0,1}
    fc                                     → fc

Conv kernels HWIO → OIHW, the Dense kernel (in, out) → (out, in), and
BatchNorm ``scale/bias`` (params) and ``mean/var`` (batch_stats) →
``weight/bias/running_mean/running_var``. :func:`folded_from_jax` and
:func:`quantized_from_jax` carry the inference-folded and the int8 trees
across; :func:`hierarchical_state_dict_from_flax` the multiscale classifier
with its calibration, in :func:`hierarchical_artifact`'s format (which the
port's multiscale trainer writes too), and :func:`split_calibration` and
:func:`hierarchical_from_state_dict` take it apart again;
:func:`cnn_encoder_state_dict_from_flax` and
:func:`unet_state_dict_from_flax` carry the legacy models (ResNet50 goes
through :func:`state_dict_from_flax`, ``Conv_2`` being a Bottleneck's third
convolution). Numpy in (anything ``np.asarray`` takes), tensors out; nothing here
imports jax.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.hierarchical import (
    HierarchicalPatchClassifier,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (  # noqa: F401 (strip_head: re-exported)
    ResNet,
    strip_head,
)

_BLOCK_RE = re.compile(r"^stage(?P<stage>\d+)_block(?P<block>\d+)$")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def state_dict_from_flax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of a ResNet18 → torchvision-layout
    state dict (without ``num_batches_tracked``, which neither eval nor the
    flax-semantics training BN reads)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}

    def conv(dst: str, node) -> None:
        sd[f"{dst}.weight"] = _tensor(np.asarray(node["kernel"]).transpose(3, 2, 0, 1))

    def norm(dst: str, p, s) -> None:
        sd[f"{dst}.weight"] = _tensor(p["scale"])
        sd[f"{dst}.bias"] = _tensor(p["bias"])
        sd[f"{dst}.running_mean"] = _tensor(s["mean"])
        sd[f"{dst}.running_var"] = _tensor(s["var"])

    conv("conv1", params["stem_conv"])
    norm("bn1", params["stem_norm"], stats["stem_norm"])
    for name in sorted(params):
        m = _BLOCK_RE.match(name)
        if not m:
            continue
        dst = f"layer{m.group('stage')}.{m.group('block')}"
        p, s = params[name], stats[name]
        conv(f"{dst}.conv1", p["Conv_0"])
        norm(f"{dst}.bn1", p["BatchNorm_0"], s["BatchNorm_0"])
        conv(f"{dst}.conv2", p["Conv_1"])
        norm(f"{dst}.bn2", p["BatchNorm_1"], s["BatchNorm_1"])
        if "Conv_2" in p:  # Bottleneck
            conv(f"{dst}.conv3", p["Conv_2"])
            norm(f"{dst}.bn3", p["BatchNorm_2"], s["BatchNorm_2"])
        if "downsample_conv" in p:
            conv(f"{dst}.downsample.0", p["downsample_conv"])
            norm(f"{dst}.downsample.1", p["downsample_norm"],
                 s["downsample_norm"])
    if "fc" in params:
        sd["fc.weight"] = _tensor(np.asarray(params["fc"]["kernel"]).T)
        sd["fc.bias"] = _tensor(params["fc"]["bias"])
    return sd


def _conv_bias(sd: dict, dst: str, node) -> None:
    """A flax ``Conv`` (HWIO kernel, bias) as a ``Conv2d``'s entries."""
    sd[f"{dst}.weight"] = _tensor(np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{dst}.bias"] = _tensor(node["bias"])


def _dense(sd: dict, dst: str, node) -> None:
    """A flax ``Dense`` ((in, out) kernel, bias) as a ``Linear``'s."""
    sd[f"{dst}.weight"] = _tensor(np.asarray(node["kernel"]).T)
    sd[f"{dst}.bias"] = _tensor(node["bias"])


def cnn_encoder_state_dict_from_flax(variables: Mapping[str, Any]
                                     ) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of the JAX ``CNNEncoder`` → the
    port's: the ResNet50 trunk through :func:`state_dict_from_flax` under
    ``trunk.``, the projection as a ``Linear``."""
    params = variables["params"]
    trunk = state_dict_from_flax({
        "params": params["trunk"],
        "batch_stats": variables.get("batch_stats", {}).get("trunk", {}),
    })
    sd = {f"trunk.{k}": v for k, v in trunk.items()}
    _dense(sd, "projection", params["projection"])
    return sd


def unet_state_dict_from_flax(variables: Mapping[str, Any]
                              ) -> dict[str, torch.Tensor]:
    """flax params of the JAX ``UNet`` or ``UNetClassifier`` → the port's
    state dict. flax numbers the submodules in call order: ``_DoubleConv_0``
    … the encoder's, the bottleneck's, then the decoder's; ``ConvTranspose_i``
    the up-convolutions (their (kh, kw, in, out) kernels flipped in both
    taps, since ``lax.conv_transpose`` does not flip a kernel that
    ``ConvTranspose2d`` applies flipped); the head is the last ``Conv_0``
    (UNet) or ``Dense_0`` (UNetClassifier)."""
    params = variables.get("params", variables)
    n_up = sum(1 for k in params if k.startswith("ConvTranspose_"))
    sd: dict[str, torch.Tensor] = {}

    def double(dst: str, node) -> None:
        _conv_bias(sd, f"{dst}.conv0", node["Conv_0"])
        _conv_bias(sd, f"{dst}.conv1", node["Conv_1"])

    for i in range(n_up):
        double(f"trunk.down.{i}", params[f"_DoubleConv_{i}"])
        up = np.asarray(params[f"ConvTranspose_{i}"]["kernel"])
        sd[f"trunk.up.{i}.weight"] = _tensor(
            up[::-1, ::-1].transpose(2, 3, 0, 1).copy())
        sd[f"trunk.up.{i}.bias"] = _tensor(params[f"ConvTranspose_{i}"]["bias"])
        double(f"trunk.dec.{i}", params[f"_DoubleConv_{n_up + 1 + i}"])
    double("trunk.bottleneck", params[f"_DoubleConv_{n_up}"])
    if "Dense_0" in params:
        _dense(sd, "head", params["Dense_0"])
    else:
        _conv_bias(sd, "head", params["Conv_0"])
    return sd


def simclr_state_dict_from_flax(variables: Mapping[str, Any]
                                ) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of the JAX ``SimCLRModel`` → the
    port's ``SimCLRModel`` state dict: the encoder through
    :func:`state_dict_from_flax` under ``encoder.``, and the projector's
    ``layers_0``/``layers_2`` (``layers_1`` is the ReLU) as ``projector.0``
    and ``projector.2``, each kernel transposed."""
    params = variables["params"]
    encoder = state_dict_from_flax({
        "params": params["encoder"],
        "batch_stats": variables.get("batch_stats", {}).get("encoder", {}),
    })
    sd = {f"encoder.{k}": v for k, v in encoder.items()}
    for src, dst in (("layers_0", "projector.0"), ("layers_2", "projector.2")):
        layer = params["projector"][src]
        sd[f"{dst}.weight"] = _tensor(np.asarray(layer["kernel"]).T)
        sd[f"{dst}.bias"] = _tensor(layer["bias"])
    return sd


def mil_state_dict_from_flax(variables: Mapping[str, Any]
                             ) -> dict[str, torch.Tensor]:
    """flax ``{"params"}`` of the JAX ``MILClassifier`` → the port's
    ``MILClassifier`` state dict: ``MILAttentionPooling_0/V`` (kernel, bias)
    and ``/w`` (kernel, no bias) as ``attention.V`` and ``attention.w``
    (attention pooling only), ``Dense_0`` and ``Dense_1`` as ``dense_0`` and
    ``dense_1``; every kernel (in, out) transposed to (out, in)."""
    params = variables["params"]
    sd: dict[str, torch.Tensor] = {}
    if "MILAttentionPooling_0" in params:
        pool = params["MILAttentionPooling_0"]
        sd["attention.V.weight"] = _tensor(np.asarray(pool["V"]["kernel"]).T)
        sd["attention.V.bias"] = _tensor(pool["V"]["bias"])
        sd["attention.w.weight"] = _tensor(np.asarray(pool["w"]["kernel"]).T)
    for src, dst in (("Dense_0", "dense_0"), ("Dense_1", "dense_1")):
        sd[f"{dst}.weight"] = _tensor(np.asarray(params[src]["kernel"]).T)
        sd[f"{dst}.bias"] = _tensor(params[src]["bias"])
    return sd


#: State-dict prefix of the multiscale classifier's calibration entries.
CALIBRATION_PREFIX = "calibration."


def hierarchical_state_dict_from_flax(variables: Mapping[str, Any]
                                      ) -> dict[str, torch.Tensor]:
    """A JAX ``hierarchical_classifier`` artifact (``params``,
    ``batch_stats``, optional ``calibration``) → the port's
    :class:`~.hierarchical.HierarchicalPatchClassifier` state dict, with the
    calibration beside it: the trunk through :func:`state_dict_from_flax`
    under ``trunk.``, ``scale_embed`` as it is, every Dense kernel (in, out)
    transposed, and each calibration entry as a 0-d float64 tensor under
    ``calibration.<key>``, so that one ``torch.load(weights_only=True)``
    reads the whole artifact. A legacy string ``combine`` is stored as its
    code (:func:`..evaluation.calibration.encode_combine`), through
    :func:`hierarchical_artifact`."""
    params = variables["params"]
    trunk = state_dict_from_flax({
        "params": params["trunk"],
        "batch_stats": variables.get("batch_stats", {}).get("trunk", {}),
    })
    sd = {f"trunk.{k}": v for k, v in trunk.items()}
    sd["scale_embed"] = _tensor(params["scale_embed"])
    for name in ("head_hidden", "head_out", "aux_head", "attn_v", "attn_w"):
        if name not in params:
            continue
        sd[f"{name}.weight"] = _tensor(np.asarray(params[name]["kernel"]).T)
        if "bias" in params[name]:
            sd[f"{name}.bias"] = _tensor(params[name]["bias"])
    return hierarchical_artifact(sd, variables.get("calibration") or {})


def hierarchical_artifact(state: Mapping[str, torch.Tensor],
                          calibration: Mapping[str, Any]
                          ) -> dict[str, torch.Tensor]:
    """The one format of ``hierarchical_classifier.pt``, whether exported
    from JAX or written by the port's trainer: the module's entries as
    contiguous CPU tensors (BN's ``num_batches_tracked`` left out), then
    each calibration entry as a 0-d float64 tensor under
    ``calibration.<key>``, a string ``combine`` as its code
    (:func:`..evaluation.calibration.encode_combine`)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation.calibration import (
        decode_combine,
        encode_combine,
    )

    sd = {k: v.detach().cpu().contiguous() for k, v in state.items()
          if not k.endswith("num_batches_tracked")}
    for key, value in calibration.items():
        if isinstance(value, str):
            value = encode_combine(decode_combine(value))
        sd[f"{CALIBRATION_PREFIX}{key}"] = torch.tensor(
            float(np.asarray(value)), dtype=torch.float64)
    return sd


def split_calibration(sd: Mapping[str, torch.Tensor]
                      ) -> tuple[dict[str, torch.Tensor], dict[str, float]]:
    """A multiscale artifact's state dict → (the module's entries, the
    calibration as ``{key: float}``)."""
    state = {k: v for k, v in sd.items()
             if not k.startswith(CALIBRATION_PREFIX)}
    calibration = {k[len(CALIBRATION_PREFIX):]: float(v)
                   for k, v in sd.items() if k.startswith(CALIBRATION_PREFIX)}
    return state, calibration


def hierarchical_from_state_dict(sd: Mapping[str, torch.Tensor],
                                 levels=(2, 3)) -> HierarchicalPatchClassifier:
    """The multiscale classifier shaped by ``sd`` (calibration entries
    ignored) for ``levels``, on the CPU in eval mode. The fusion is read off
    the parameters, as the JAX function detects it: ``attn_v`` means
    attention; ``aux_head`` missing means an artifact without aux heads."""
    state, _ = split_calibration(sd)
    levels = tuple(sorted(levels))
    if int(state["scale_embed"].shape[0]) != len(levels):
        raise ValueError(f"the artifact embeds {state['scale_embed'].shape[0]} "
                         f"scales, not the {len(levels)} of levels {levels}")
    model = HierarchicalPatchClassifier(
        levels=levels,
        num_classes=int(state["head_out.weight"].shape[0]),
        fusion="attention" if "attn_v.weight" in state else "concat",
        fusion_hidden_dim=int(state["head_hidden.weight"].shape[0]),
        aux="aux_head.weight" in state,
    )
    model.load_state_dict(state, strict=True)
    return model.eval()


def folded_from_jax(fp: Mapping[str, Any],
                    dtype: torch.dtype = torch.float32) -> dict[str, Any]:
    """A pytree of the JAX package's ``fold_resnet18_inference`` (arrays
    that ``np.asarray`` takes; conv kernels HWIO) → the pytree of the
    port's ``models/quantized.py::folded_forward_inference``: conv kernels
    OIHW in ``dtype``, biases and the stem bias map in ``dtype``, the head
    as ((in, out) ``dtype``, float32 bias). A space-to-depth stem (4, 4, 12,
    O) also gives ``stem_w2`` (4, 48, O), the layout of the fused stem
    kernel."""
    f32 = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))  # noqa: E731
    kernels = {name: f32(k).permute(3, 2, 0, 1).to(dtype).contiguous(
                   memory_format=torch.channels_last)
               for name, k in fp["kernels"].items()}
    out = {
        "kernels": kernels,
        "biases": {name: f32(b).to(dtype) for name, b in fp["biases"].items()},
        "fc": None if fp["fc"] is None else (f32(fp["fc"][0]).to(dtype),
                                             f32(fp["fc"][1])),
        "stem_bias_map": f32(fp["stem_bias_map"]).to(dtype),
    }
    stem = f32(fp["kernels"]["stem"])
    if stem.shape[0] == 4:  # (KY, KX, 12, O) → (KX, KY·12, O)
        out["stem_w2"] = stem.permute(1, 0, 2, 3).reshape(
            4, 48, stem.shape[3]).to(dtype).contiguous()
    return out


def quantized_from_jax(qtree: Mapping[str, Any],
                       device: str | torch.device = "cpu") -> dict[str, Any]:
    """A tree of the JAX package's ``QuantizedResNet18.tree()`` (arrays that
    ``np.asarray`` takes; int8 kernels HWIO) → the quantized tree of the
    port's ``models/quantized.py::quant_forward`` on ``device``: kernels
    ``(C_out, C_in, KH, KW)`` int8 in channels_last memory (the layout the
    int8 kernels read, chosen here once), float32 scales, biases, head and
    stem bias map, and the forward's plan."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quant_artifact import (
        tree_from_arrays,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quantized import (
        quantized_to,
    )

    flat = {f"{field}/{name}": a
            for field in ("qkernels", "wscales", "biases", "ascales")
            for name, a in qtree[field].items()}
    if qtree.get("fc") is not None:
        flat["fc/0"], flat["fc/1"] = qtree["fc"]
    if qtree.get("stem_bias_map") is not None:
        flat["stem_bias_map"] = qtree["stem_bias_map"]
    return quantized_to(tree_from_arrays(flat), device)


def _param_entries(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A flax ResNet18 ``params``-shaped tree (parameters, or optax's Adam
    moments of them) → the state dict's parameter entries."""
    def stats_like(node):
        if "scale" in node:
            return {"mean": node["scale"], "var": node["scale"]}
        return {k: stats_like(v) for k, v in node.items() if isinstance(v, Mapping)}

    sd = state_dict_from_flax({"params": params, "batch_stats": stats_like(params)})
    return {k: v for k, v in sd.items()
            if not k.endswith(("running_mean", "running_var"))}


def adam_state_from_optax(model: torch.nn.Module, count, mu: Mapping[str, Any],
                          nu: Mapping[str, Any]) -> dict:
    """optax ``adam``'s state of a flax ResNet18 (``count``, first moments
    ``mu``, second moments ``nu``) → the ``state`` of a
    ``torch.optim.Adam`` over ``model.parameters()``, for
    ``optimizer.load_state_dict``."""
    m, v = _param_entries(mu), _param_entries(nu)
    return {i: {"step": torch.tensor(float(count)), "exp_avg": m[name],
                "exp_avg_sq": v[name]}
            for i, (name, _) in enumerate(model.named_parameters())}


def classifier_trunk_from_simclr(sd: Mapping[str, torch.Tensor]
                                 ) -> dict[str, torch.Tensor]:
    """A SimCLR model's state dict → its encoder's entries under the
    classifier's names (``encoder.`` dropped, the projector left out): the
    trunk that the ``self_supervised`` strategy fine-tunes under a fresh
    head."""
    return {k.removeprefix("encoder."): v for k, v in sd.items()
            if k.startswith("encoder.")}


def load_state_dict_file(path: str) -> dict[str, torch.Tensor]:
    """A ``.pt``/``.pth`` state dict from disk, with the DataParallel
    ``module.`` prefix that reference checkpoints carry stripped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k.removeprefix("module."): v for k, v in sd.items()}


def resnet18_from_state_dict(sd: Mapping[str, torch.Tensor]) -> ResNet:
    """A ResNet18 shaped by ``sd`` (stem width from ``conv1``, head from
    ``fc`` when present) with its weights loaded, on the CPU in eval mode."""
    num_filters = int(sd["conv1.weight"].shape[0])
    num_classes = int(sd["fc.weight"].shape[0]) if "fc.weight" in sd else None
    model = ResNet((2, 2, 2, 2), num_classes, num_filters)
    model.load_state_dict(dict(sd), strict=True)
    return model.eval()
