"""The yardstick's arithmetic: the card's published peaks, the least time a
call could take, and the operations and bytes of the measured work,
counted from layer shapes.

Peaks are NVIDIA's data sheet for one H100 SXM (dense rates, at the full
700 W): 989 TFLOP/s in bf16, 3.35 TB/s of HBM.
"""

from __future__ import annotations

from hipac_bench.reference.resnet import conv_shapes

BF16_FLOP_S = 989e12
HBM_BYTES_S = 3.35e12
IMAGE = 224  # the classifier's input edge
FEATURES = 512


def bound_s(nbytes: float, flop: float, flop_s: float = BF16_FLOP_S) -> float:
    """The larger of bytes over the memory rate and operations over the
    peak rate, in seconds."""
    return max(nbytes / HBM_BYTES_S, flop / flop_s)


def _out_edge(edge: int, k: int, stride: int, pad: int) -> int:
    return (edge + 2 * pad - k) // stride + 1


def conv_macs(size: int = IMAGE) -> dict[str, int]:
    """Multiply-accumulates of each ResNet18 convolution for one image of
    ``size``², by name."""
    out = {}
    # the stem: 7×7/2 with padding 3, then a 3×3/2 maxpool with padding 1
    stem = conv_shapes()[0][1]
    e1 = _out_edge(size, 7, 2, 3)
    out["conv1"] = e1 * e1 * stem[0] * stem[1] * 49
    # every convolution of a stage writes at the stage's edge; stages 2–4
    # open with a 3×3/2 convolution (and a 1×1/2 downsample beside it)
    edges = {1: _out_edge(e1, 3, 2, 1)}
    for stage in (2, 3, 4):
        edges[stage] = _out_edge(edges[stage - 1], 3, 2, 1)
    for name, (co, ci, kh, kw) in conv_shapes()[1:]:
        e = edges[int(name[len("layer")])]
        out[name] = e * e * co * ci * kh * kw
    return out


def forward_macs(size: int = IMAGE, classes: int | None = 2) -> int:
    """One image through ResNet18's convolutions and its head."""
    head = 0 if classes is None else FEATURES * classes
    return sum(conv_macs(size).values()) + head


def train_flop(size: int = IMAGE, classes: int | None = 2,
               extra_macs: int = 0) -> float:
    """One image's training operations: forward, the gradient of every
    activation and of every weight (three times the forward's products),
    less the stem's gradient of the input image, which no step needs."""
    macs = forward_macs(size, classes) + extra_macs
    return 2.0 * (3 * macs - conv_macs(size)["conv1"])


def projection_macs(hidden: int = 512, out: int = 128) -> int:
    return FEATURES * hidden + hidden * out


def nt_xent_flop(views: int, dim: int = 128) -> float:
    """The similarity matrix of ``views`` projections and its two gradient
    products: 3 · 2 · views² · dim."""
    return 6.0 * views * views * dim


def fused_normalize_bytes(cells: int, size: int = IMAGE,
                          out_bytes: int = 2) -> int:
    """Kernel 2a on ``cells`` uint8 images of ``size``²: each byte read
    once, each normalized value written once (bf16), an 8-byte sum a cell."""
    px = cells * size * size * 3
    return px + px * out_bytes + 8 * cells


def augment_bytes(images: int, size: int = IMAGE) -> int:
    """Kernel ``augment``: uint8 images read once, float32 written once."""
    px = images * size * size * 3
    return px + 4 * px
