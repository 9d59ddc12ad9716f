"""The training stem's kernels (``ops/stem_train.py``) and their plain version.

On the CPU, :func:`stem_train_reference` (the plain ops the kernels are held
to, with the kernels' backward in plain ops) is held to the module chain
``maxpool(relu(bn1(x)))`` of ``models/resnet.py``: the pooled plane, the
running statistics after two calls, the gradients of x, γ and β, planted
positive ties (the first maximum in window order takes the gradient) and
odd planes; then the rule that sends a training forward to the kernels.
The ``cuda``-marked tests hold the kernels to the plain version on the card
and a SimCLR step through them to one through the module chain; they need
the card and skip elsewhere.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ss25_hierarchical_multiscale_image_classification_tpu_torch.models import (
    resnet,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops import (
    stem_train as st,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.utils import (
    profiling,
)

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bn(seed: int, device="cpu") -> resnet.BatchNorm2d:
    g = torch.Generator().manual_seed(seed)
    bn = resnet.BatchNorm2d(64, eps=1e-5).train()
    with torch.no_grad():
        bn.weight.copy_(0.5 + torch.rand(64, generator=g))
        bn.bias.copy_(0.3 * torch.randn(64, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(64, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(64, generator=g))
    return bn.to(device)


def _plane(seed: int, shape, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = 1.5 * torch.randn(shape, generator=g) + 0.4
    return x.to(device=device, dtype=dtype).contiguous(
        memory_format=torch.channels_last)


def _chain(bn, x):
    return F.max_pool2d(torch.relu(bn(x)), 3, 2, 1)


def _reference(bn, x):
    return st.stem_train_reference(x, bn.weight, bn.bias, bn.running_mean,
                                   bn.running_var, bn.momentum, bn.eps)


def _both(fn_a, fn_b, bn, x, gy):
    """Run ``fn_a`` and ``fn_b`` on copies of ``bn`` and ``x`` with upstream
    gradient ``gy``: (out, x.grad, bn) of each."""
    out = []
    for fn in (fn_a, fn_b):
        b = copy.deepcopy(bn)
        xx = x.detach().clone().requires_grad_()
        y = fn(b, xx)
        y.backward(gy)
        out.append((y.detach(), xx.grad, b))
    return out


def _close(a, b, scale=1.0, tol=2e-6):
    err = (a.double() - b.double()).abs().max().item()
    assert err <= tol * max(scale, b.abs().max().item()), err


# ---------------------------------------------------------------------------
# the plain version against the module chain (CPU, float32)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [
    (2, 64, 30, 26),  # even plane
    (3, 64, 31, 27),  # odd H and W
    (2, 64, 16, 33),  # even H, odd W
    (1, 64, 7, 1),    # a single column
])
def test_stem_train_reference_equals_module_chain(shape):
    bn = _bn(shape[2])
    x = _plane(shape[3], shape)
    gy = torch.randn(shape[0], 64, *st.pooled_size(*shape[2:]),
                     generator=torch.Generator().manual_seed(5))
    (y_c, dx_c, bn_c), (y_r, dx_r, bn_r) = _both(_chain, _reference, bn, x, gy)
    assert y_r.shape == y_c.shape and y_r.dtype == y_c.dtype
    assert y_r.is_contiguous(memory_format=torch.channels_last)
    _close(y_r, y_c)
    _close(dx_r, dx_c)
    _close(bn_r.weight.grad, bn_c.weight.grad, tol=1e-5)
    _close(bn_r.bias.grad, bn_c.bias.grad, tol=1e-5)
    # a second call on another plane: the running statistics follow flax's
    # rule twice (momentum 0.1 toward the biased variance)
    x2 = _plane(shape[3] + 1, shape)
    with torch.no_grad():
        _chain(bn_c, x2)
        _reference(bn_r, x2)
    _close(bn_r.running_mean, bn_c.running_mean)
    _close(bn_r.running_var, bn_c.running_var)
    assert not torch.equal(bn_r.running_var, bn.running_var)


def test_stem_train_reference_planted_ties_take_the_first_maximum():
    """Equal large inputs in one window give equal positive BN outputs; the
    pooled gradient goes to the first of them in row-major window order."""
    bn = _bn(3)
    x = _plane(4, (2, 64, 12, 12)).clone()
    with torch.no_grad():
        x[:, :, 2, 2] = 9.0   # window (1, 1) at (dy, dx) = (1, 1): code 4
        x[:, :, 2, 3] = 9.0   # same window, (1, 2): code 5, a tie
        x[:, :, 7, 5] = 9.0   # window (4, 2) at (0, 2): code 2
        x[:, :, 8, 4] = 9.0   # same window, (1, 1): code 4, a tie
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        _, codes, _ = st.stem_train_forward_reference(
            x, bn.weight, bn.bias, bn.running_mean.clone(),
            bn.running_var.clone(), bn.momentum, bn.eps)
    assert (codes[:, 1, 1] == 4).all()
    # window (4, 2) covers rows 7..9, columns 3..5: (7, 5) is (0, 2), code 2,
    # before (8, 4) at (1, 1)
    assert (codes[:, 4, 2] == 2).all()
    gy = torch.rand(2, 64, 6, 6, generator=torch.Generator().manual_seed(6))
    (_, dx_c, _), (_, dx_r, _) = _both(_chain, _reference, bn, x, gy)
    # the chain routes by max_pool2d's indices: the same gradients
    _close(dx_r, dx_c)


def test_stem_train_codes_name_each_windows_maximum():
    """The codes against a loop over the windows: the first maximum of the
    ReLU'd plane in row-major order, the padding never taken."""
    bn = _bn(8)
    x = _plane(9, (1, 64, 9, 8))
    with torch.no_grad():
        pooled, codes, stats = st.stem_train_forward_reference(
            x, bn.weight, bn.bias, bn.running_mean.clone(),
            bn.running_var.clone(), bn.momentum, bn.eps)
        r = torch.relu(st._bn(x, stats[0], stats[1], bn.weight, bn.bias))
    r, codes, pooled = r[0].numpy(), codes[0].numpy(), pooled[0].numpy()
    ho, wo = st.pooled_size(9, 8)
    for oy in range(ho):
        for ox in range(wo):
            for c in (0, 17, 63):
                best, code = -np.inf, -1
                for k in range(9):
                    iy, ix = 2 * oy - 1 + k // 3, 2 * ox - 1 + k % 3
                    if 0 <= iy < 9 and 0 <= ix < 8 and r[c, iy, ix] > best:
                        best, code = r[c, iy, ix], k
                assert codes[oy, ox, c] == code
                assert pooled[c, oy, ox] == best


# ---------------------------------------------------------------------------
# where the kernels engage
# ---------------------------------------------------------------------------


class _Group:
    """Stands for a process group: only its presence matters."""


@pytest.mark.parametrize("case,reason", [
    ("eval", "eval mode"),
    ("frozen", "frozen BatchNorm"),
    ("group", "process group"),
    ("float32", "not bfloat16"),
    ("channels", "not (B, 64, H, W)"),
    ("cpu", "not a CUDA device"),
])
def test_stem_train_refusal(case, reason):
    """A training forward of a bf16 channels-last 64-channel plane takes the
    kernels on the card only; each case changes one thing of that (on the
    CPU, the last is the device itself)."""
    model = resnet.ResNet((2, 2, 2, 2), None, frozen_bn=case == "frozen").train()
    bn = model.bn1
    x = _plane(0, (2, 64, 8, 8), torch.bfloat16)
    if case == "eval":
        model.eval()
    elif case == "group":
        bn.group = _Group()
    elif case == "float32":
        x = x.float()
    elif case == "channels":
        x = _plane(0, (2, 32, 8, 8), torch.bfloat16)
    got = st.stem_train_refusal(bn, x, model.frozen_bn)
    assert got is not None and reason in got
    if case == "group":
        bn.group = None
    if case != "channels":  # a refused forward keeps the module chain
        with torch.no_grad():
            out = model._stem(x.float())
        assert torch.equal(out, F.max_pool2d(torch.relu(bn(x.float())), 3, 2,
                                             1))


def test_stem_train_cpu_takes_the_plain_version_and_no_kernel():
    bn = _bn(1)
    x = _plane(2, (2, 64, 10, 10))
    before = (st.stem_train_forward_kernel.launches,
              st.stem_train_backward_kernel.launches)
    profiling.reset()
    y = st.stem_train(x, bn.weight, bn.bias, bn.running_mean.clone(),
                      bn.running_var.clone(), bn.momentum, bn.eps)
    y.sum().backward()
    ref = _reference(copy.deepcopy(bn), x)
    assert torch.equal(y, ref)
    assert (st.stem_train_forward_kernel.launches,
            st.stem_train_backward_kernel.launches) == before
    assert st.COUNTER not in profiling.counters()
    for bad in (x, x.to(torch.bfloat16)):
        with pytest.raises(ValueError, match="stem kernels"):
            st.stem_train_forward_kernel(bad, bn.weight, bn.bias,
                                         bn.running_mean, bn.running_var,
                                         0.1, 1e-5)
    assert st.stem_train_forward_kernel.launches == before[0]


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------


def _ulp_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a − b| in bf16 units in the last place of the larger magnitude."""
    m = torch.maximum(a.float().abs(), b.float().abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(m)) - 7)
    return (a.float() - b.float()).abs() / ulp


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(512, 64, 112, 112), (3, 64, 37, 45)])
def test_stem_train_kernels_match_plain_version(cuda_device, shape):
    bn = _bn(shape[2], cuda_device)
    x = _plane(shape[3], shape, torch.bfloat16, cuda_device)
    rm_k, rv_k = bn.running_mean.clone(), bn.running_var.clone()
    rm_r, rv_r = bn.running_mean.clone(), bn.running_var.clone()
    args = (bn.weight.detach(), bn.bias.detach())
    with torch.no_grad():
        out_k, codes_k, stats_k = st.stem_train_forward_kernel(
            x, *args, rm_k, rv_k, bn.momentum, bn.eps)
        torch.cuda.synchronize()
        out_r, codes_r, stats_r = st.stem_train_forward_reference(
            x, *args, rm_r, rv_r, bn.momentum, bn.eps)
    assert out_k.is_contiguous(memory_format=torch.channels_last)
    # statistics and running statistics within float32 rounding
    torch.testing.assert_close(stats_k, stats_r, rtol=2e-5, atol=1e-6)
    torch.testing.assert_close(rm_k, rm_r, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(rv_k, rv_r, rtol=1e-6, atol=1e-7)
    # BN, ReLU and pool on the kernel's statistics (near zero, a float32
    # rounding of the statistics is many bf16 ulps of the output): the pooled
    # plane within one bf16 ulp; the codes equal wherever the window's
    # maximum is unique by more than one ulp
    r = torch.relu(st._bn(x.float(), stats_k[0], stats_k[1], *args).to(
        torch.bfloat16))
    out_r, idx = F.max_pool2d(r, 3, 2, 1, return_indices=True)
    codes_r = st._codes(idx, shape[3])
    assert _ulp_gap(out_k, out_r).max().item() <= 1.0
    unfold = F.unfold(F.pad(r.float(), (1, 1, 1, 1), value=-float("inf")),
                      3, stride=2)  # (B, C·9, L)
    win = unfold.view(shape[0], 64, 9, -1)
    top2 = win.topk(2, dim=2).values
    unique = (_ulp_gap(top2[:, :, 0], top2[:, :, 1]) > 1.0).view(
        shape[0], 64, *out_r.shape[2:]).permute(0, 2, 3, 1)
    assert torch.equal(codes_k[unique], codes_r[unique])
    assert unique.float().mean().item() > 0.5
    # a second call gives the same bits
    out_k2, codes_k2, stats_k2 = st.stem_train_forward_kernel(
        x, *args, rm_k.clone(), rv_k.clone(), bn.momentum, bn.eps)
    assert torch.equal(out_k2, out_k) and torch.equal(codes_k2, codes_k)
    assert torch.equal(stats_k2, stats_k)

    # the backward, both from the kernels' codes and statistics
    g = torch.Generator(device=cuda_device).manual_seed(2)
    dy = torch.randn(out_k.shape, device=cuda_device, generator=g).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    dx_k, dw_k, db_k = st.stem_train_backward_kernel(dy, x, codes_k, stats_k,
                                                     *args)
    torch.cuda.synchronize()
    dx_r, dw_r, db_r = st.stem_train_backward_reference(dy, x, codes_k,
                                                        stats_k, *args)
    # sums of 10⁷ terms in another order: float32 rounding of the sum
    torch.testing.assert_close(db_k, db_r, rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(dw_k, dw_r, rtol=1e-4, atol=1e-2)
    # dx: the sums round apart in float32, so a bf16 rounding may differ;
    # a mask flips only where BN's output rounds to zero
    gap = _ulp_gap(dx_k, dx_r)
    assert (gap > 1.0).float().mean().item() < 1e-4
    torch.testing.assert_close(dx_k.float(), dx_r.float(), rtol=1e-2,
                               atol=1e-2 * dx_r.float().abs().max().item())
    dx_k2, dw_k2, db_k2 = st.stem_train_backward_kernel(dy, x, codes_k,
                                                        stats_k, *args)
    assert torch.equal(dx_k2, dx_k) and torch.equal(dw_k2, dw_k)


def _simclr_steps(dev, start, imgs, valid, fused, monkeypatch):
    from hipac_bench.training import FirstSteps

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.simclr import (
        SimCLRModel,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.simclr_trainer import (
        make_simclr_train_step,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
        create_train_state,
    )

    with monkeypatch.context() as m:
        if not fused:
            m.setattr(resnet, "stem_train_refusal", lambda *a, **k: "off")
        model = SimCLRModel()
        model.load_state_dict(start)
        state = create_train_state(model, 1e-3, dev)
        step = FirstSteps(make_simclr_train_step(0.5, 224), lambda loss: loss,
                          state.model)
        gen = torch.Generator(device=dev).manual_seed(17)
        before = st.stem_train_forward_kernel.launches
        for batch in imgs:
            state, _ = step(state, gen, batch, valid)
        launches = st.stem_train_forward_kernel.launches - before
    return step.result(), launches


@pytest.mark.cuda
def test_simclr_step_through_the_stem_kernels_matches_the_module_chain(
        cuda_device, monkeypatch):
    """Three SimCLR steps from one start through the kernels and through the
    module chain, compared as the benchmark's check compares a cell's steps
    with its reference (the cell's own limits)."""
    from hipac_bench.reference.train import step_readings

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.simclr import (
        SimCLRModel,
    )

    start = {k: v.clone() for k, v in SimCLRModel().state_dict().items()}
    g = torch.Generator(device=cuda_device).manual_seed(3)
    imgs = [torch.randint(0, 256, (64, 224, 224, 3), dtype=torch.uint8,
                          device=cuda_device, generator=g) for _ in range(3)]
    valid = torch.ones(64, dtype=torch.bool, device=cuda_device)
    fused, n_fused = _simclr_steps(cuda_device, start, imgs, valid, True,
                                   monkeypatch)
    chain, n_chain = _simclr_steps(cuda_device, start, imgs, valid, False,
                                   monkeypatch)
    assert (n_fused, n_chain) == (6, 0)  # two forwards a step
    cell = json.loads((Path(__file__).resolve().parents[1] / "hipac_bench" /
                       "workloads" / "simclr-pretrain.json").read_text())
    got = step_readings(fused, chain, start)
    for name, limit in cell["traffic"]["limits"].items():
        assert got[name] <= limit, (name, got[name], limit)
