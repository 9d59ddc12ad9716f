"""The training stem after ``conv1`` on hand-written CUDA kernels: BatchNorm
with batch statistics (flax's running statistics, as
``models/resnet.py::BatchNorm2d`` keeps them), ReLU and the 3×3 stride-2
maxpool with −inf padding, forward and backward, as one autograd function.

The JAX package has no kernel for it (XLA fuses its training step's stem).
In PyTorch the chain ``maxpool(relu(bn1(x)))`` is eight passes over the
largest plane of ResNet18 and keeps the BN output and int64 pool indices for
the backward; ``ops/csrc/stem_train.cu`` makes it four passes and keeps x,
one uint8 window position (code) a pooled element and the statistics:

- :func:`stem_train_forward_kernel` (two launches: statistics, then BN,
  ReLU and pool) and :func:`stem_train_backward_kernel` (two launches: the
  per-channel sums, then dx) take conv1's bf16 output with 64 channels in
  channels-last memory; each counts its calls in ``.launches`` and raises
  on anything else.
- :func:`stem_train_forward_reference` and
  :func:`stem_train_backward_reference` are the plain versions of the same
  arithmetic, and :func:`stem_train_reference` the autograd function over
  them: the CPU tests hold it against the module chain, the card's checks
  hold the kernels against it.
- :func:`stem_train` sends a CUDA tensor to the kernels (counting
  ``hipac.stem.fused`` in the program's counters) and a CPU tensor to the
  plain version; :func:`stem_train_refusal` says why a training forward
  keeps the module chain instead.

A code is the window position of the pooled element's input, (dy, dx) of
the 3×3 window in row-major order (0..8, padding positions included); the
first maximum in that order wins, as in ``max_pool2d``. The backward routes
each pooled gradient to the element its code names, sums in float32,
rounds to the plane's dtype and masks by the ReLU output, as the chain's
maxpool and ReLU backward do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
    count_launch,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.utils.profiling import (
    count,
)

#: The channels the kernels take: the ResNet stem's width.
CHANNELS = 64
#: Room for partials: blocks a multiprocessor of the two reducing kernels at
#: most (they launch as many as the device holds at once).
BLOCKS_PER_SM = 8
#: The program's counter of forwards that take the kernels.
COUNTER = "hipac.stem.fused"


def pooled_size(h: int, w: int) -> tuple[int, int]:
    """The pooled plane's (height, width): 3×3, stride 2, padding 1."""
    return (h - 1) // 2 + 1, (w - 1) // 2 + 1


def stem_train_refusal(bn: torch.nn.Module, x: torch.Tensor,
                       frozen_bn: bool = False) -> str | None:
    """Why the training stem over ``x`` (conv1's output, NCHW) keeps the
    module chain ``maxpool(relu(bn(x)))``; None where the kernels take it:
    BatchNorm in training mode with batch statistics, this process's batch
    (no process group), float32 parameters and running statistics, and x a
    CUDA bf16 tensor with 64 channels in channels-last memory."""
    if frozen_bn:
        return "frozen BatchNorm"
    if not bn.training:
        return "BatchNorm in eval mode"
    if getattr(bn, "group", None) is not None:
        return "BatchNorm over a process group"
    if bn.momentum is None or not bn.affine or not bn.track_running_stats:
        return "BatchNorm without momentum, affine or running statistics"
    state = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    if any(t.dtype != torch.float32 for t in state):
        return "BatchNorm state not float32"
    if x.dtype != torch.bfloat16:
        return f"{x.dtype}, not bfloat16"
    if x.dim() != 4 or x.shape[1] != CHANNELS:
        return f"shape {tuple(x.shape)}, not (B, {CHANNELS}, H, W)"
    if x.numel() == 0 or not x.is_contiguous(memory_format=torch.channels_last):
        return "not a channels-last plane"
    if x.device.type != "cuda" or any(t.device != x.device for t in state):
        return f"on {x.device}, not a CUDA device"
    return None


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _bn(x32: torch.Tensor, mean: torch.Tensor, invstd: torch.Tensor,
        weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    c = (slice(None), None, None)
    return (x32 - mean[c]) * (invstd * weight)[c] + bias[c]


def _codes(idx: torch.Tensor, w: int) -> torch.Tensor:
    """``max_pool2d``'s flat indices (B, C, ho, wo) → window positions,
    (B, ho, wo, C) uint8."""
    ho, wo = idx.shape[2:]
    oy = torch.arange(ho, device=idx.device).view(ho, 1)
    ox = torch.arange(wo, device=idx.device).view(1, wo)
    code = (idx // w - 2 * oy + 1) * 3 + (idx % w - 2 * ox + 1)
    return code.to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def stem_train_forward_reference(x, weight, bias, running_mean, running_var,
                                 momentum: float, eps: float):
    """Plain version of the forward: (pooled (B, C, ho, wo) in x's dtype,
    channels-last; codes (B, ho, wo, C) uint8; stats (3, C) float32: mean,
    invstd, biased variance). Moves the running statistics in place by
    ``momentum`` toward the batch mean and biased variance."""
    with torch.no_grad(), torch.autocast(x.device.type, enabled=False):
        x32 = x.float()
        var, mean = torch.var_mean(x32, dim=(0, 2, 3), unbiased=False)
        invstd = torch.rsqrt(var + eps)
        running_mean.mul_(1.0 - momentum).add_(mean, alpha=momentum)
        running_var.mul_(1.0 - momentum).add_(var, alpha=momentum)
        r = torch.relu(_bn(x32, mean, invstd, weight, bias).to(x.dtype))
        pooled, idx = F.max_pool2d(r, 3, 2, 1, return_indices=True)
    return (pooled.contiguous(memory_format=torch.channels_last),
            _codes(idx, x.shape[3]), torch.stack([mean, invstd, var]))


def stem_train_backward_reference(dy, x, codes, stats, weight, bias):
    """Plain version of the backward: (dx in x's dtype, channels-last;
    dweight; dbias) from the pooled gradient ``dy`` and what the forward
    kept."""
    with torch.no_grad(), torch.autocast(x.device.type, enabled=False):
        b, c, h, w = x.shape
        ho, wo = codes.shape[1:3]
        mean, invstd = stats[0], stats[1]
        k = codes.permute(0, 3, 1, 2).long()
        oy = torch.arange(ho, device=x.device).view(ho, 1)
        ox = torch.arange(wo, device=x.device).view(1, wo)
        flat = (2 * oy - 1 + k // 3) * w + (2 * ox - 1 + k % 3)
        g = torch.zeros(b, c, h * w, dtype=torch.float32, device=x.device)
        g.scatter_add_(2, flat.reshape(b, c, -1), dy.float().reshape(b, c, -1))
        x32 = x.float()
        y = _bn(x32, mean, invstd, weight, bias).to(x.dtype)
        g = torch.where(y > 0, g.view(b, c, h, w).to(x.dtype).float(), 0.0)
        cc = (slice(None), None, None)
        xhat = (x32 - mean[cc]) * invstd[cc]
        sg = g.sum(dim=(0, 2, 3))
        sgx = (g * xhat).sum(dim=(0, 2, 3))
        n = b * h * w
        dx = (weight * invstd)[cc] * (g - (sg / n)[cc] - xhat * (sgx / n)[cc])
    return (dx.to(x.dtype).contiguous(memory_format=torch.channels_last), sgx,
            sg)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _check_kernel(x: torch.Tensor, *state: torch.Tensor) -> None:
    if (x.dim() != 4 or x.shape[1] != CHANNELS or x.dtype != torch.bfloat16
            or x.device.type != "cuda" or x.numel() == 0
            or not x.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"the stem kernels take a CUDA bf16 (B, {CHANNELS}, H, "
                         f"W) channels-last plane, got {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
    for t in state:
        if (t.dtype != torch.float32 or t.shape != (CHANNELS,)
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"the stem kernels take float32 ({CHANNELS},) "
                             f"parameters on {x.device}")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


_TICKETS: dict[tuple[torch.device, int], torch.Tensor] = {}


def _ticket(device: torch.device, stream) -> torch.Tensor:
    """The reducing kernels' ticket on one stream: a zero, which every launch
    leaves zero again."""
    key = (device, stream.cuda_stream)
    t = _TICKETS.get(key)
    if t is None:
        t = torch.zeros(1, dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def stem_train_forward_kernel(x, weight, bias, running_mean, running_var,
                              momentum: float, eps: float):
    """The forward on the card (two launches): what
    :func:`stem_train_forward_reference` returns, with the running
    statistics moved in place."""
    _check_kernel(x, weight, bias, running_mean, running_var)
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        load_library,
        multiprocessors,
        on_device,
    )

    if x.data_ptr() % 16:
        x = x.clone(memory_format=torch.channels_last)
    b, c, h, w = x.shape
    ho, wo = pooled_size(h, w)
    out = torch.empty(b, ho, wo, c, dtype=x.dtype, device=x.device)
    codes = torch.empty(b, ho, wo, c, dtype=torch.uint8, device=x.device)
    blocks = BLOCKS_PER_SM * multiprocessors(x.device)
    ws = torch.empty(3 * c + blocks * (2 * c + 1), dtype=torch.float32,
                     device=x.device)
    stats = ws[:3 * c].view(3, c)
    stream = torch.cuda.current_stream(x.device)
    with on_device(x.device):
        rc = load_library().hipac_stem_train_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            running_mean.data_ptr(), running_var.data_ptr(), out.data_ptr(),
            codes.data_ptr(), stats.data_ptr(), ws[3 * c:].data_ptr(),
            _ticket(x.device, stream).data_ptr(), b, h, w, blocks, float(eps),
            float(momentum), stream.cuda_stream)
    _raise_on(rc, "stem_train forward")
    count_launch(stem_train_forward_kernel)
    return out.permute(0, 3, 1, 2), codes, stats


stem_train_forward_kernel.launches = 0


def stem_train_backward_kernel(dy, x, codes, stats, weight, bias):
    """The backward on the card (two launches): what
    :func:`stem_train_backward_reference` returns."""
    _check_kernel(x, weight, bias)
    b, c, h, w = x.shape
    ho, wo = pooled_size(h, w)
    if (dy.shape != (b, c, ho, wo) or dy.dtype != x.dtype
            or codes.shape != (b, ho, wo, c) or codes.dtype != torch.uint8
            or stats.shape != (3, c)):
        raise ValueError(f"the stem backward takes the forward's codes and "
                         f"stats and a bf16 {(b, c, ho, wo)} gradient, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    dy = dy.contiguous(memory_format=torch.channels_last)
    if dy.data_ptr() % 16:
        dy = dy.clone(memory_format=torch.channels_last)
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        load_library,
        multiprocessors,
        on_device,
    )

    dx = torch.empty(b, h, w, c, dtype=x.dtype, device=x.device)
    sums = torch.empty(2, c, dtype=torch.float32, device=x.device)
    blocks = BLOCKS_PER_SM * multiprocessors(x.device)
    part = torch.empty(blocks * 2 * c, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device)
    with on_device(x.device):
        rc = load_library().hipac_stem_train_bwd(
            x.data_ptr(), dy.data_ptr(), codes.data_ptr(), stats.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), dx.data_ptr(), sums.data_ptr(),
            part.data_ptr(), _ticket(x.device, stream).data_ptr(), b, h, w,
            blocks, stream.cuda_stream)
    _raise_on(rc, "stem_train backward")
    count_launch(stem_train_backward_kernel)
    return dx.permute(0, 3, 1, 2), sums[1], sums[0]


stem_train_backward_kernel.launches = 0


# ---------------------------------------------------------------------------
# the autograd function
# ---------------------------------------------------------------------------


class _StemTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps, forward, backward):
        pooled, codes, stats = forward(x, weight, bias, running_mean,
                                       running_var, momentum, eps)
        ctx.save_for_backward(x, codes, stats, weight, bias)
        ctx.backward_of = backward
        return pooled

    @staticmethod
    def backward(ctx, dy):
        dx, dweight, dbias = ctx.backward_of(dy, *ctx.saved_tensors)
        return dx, dweight, dbias, None, None, None, None, None, None


def stem_train_reference(x, weight, bias, running_mean, running_var,
                         momentum: float = 0.1, eps: float = 1e-5):
    """``maxpool(relu(bn(x)))`` of a training-mode BatchNorm with flax's
    running statistics, in plain PyTorch ops (any device, any float dtype;
    NCHW in, the pooled plane out), with the kernels' backward in plain ops
    too."""
    return _StemTrain.apply(x, weight, bias, running_mean, running_var,
                            momentum, eps, stem_train_forward_reference,
                            stem_train_backward_reference)


def stem_train(x, weight, bias, running_mean, running_var,
               momentum: float = 0.1, eps: float = 1e-5):
    """The training stem after conv1: the kernels' result for a CUDA tensor
    (what :func:`stem_train_refusal` admits; anything else raises), the
    plain version's for a CPU tensor."""
    if x.device.type == "cpu":
        return stem_train_reference(x, weight, bias, running_mean,
                                    running_var, momentum, eps)
    count(COUNTER)
    return _StemTrain.apply(x, weight, bias, running_mean, running_var,
                            momentum, eps, stem_train_forward_kernel,
                            stem_train_backward_kernel)
