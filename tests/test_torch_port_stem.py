"""The port's stem (``ops/fused_stem.py``) against the JAX package.

The same numpy inputs go through the JAX functions of
``ops/pallas/fused_stem.py`` (the Pallas kernels in interpret mode, as the
JAX package's own ``tests/test_ops.py`` runs them) and through the port's
functions on the CPU, where ``bias_relu_pool`` and ``fused_stem`` are their
plain PyTorch versions. ``bias_relu_pool`` is compared in float32: there the
JAX kernel's pad row (``−bias``) is exact, while in bfloat16 it is rounded
and can win over an all-zero window (the port computes the true maxpool).
The CUDA kernels are held against the plain versions by the ``cuda``-marked
tests, which need the card and skip elsewhere.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
    normalize,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
    ResNet18Classifier,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops import (
    fused_stem as fs,
)

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _stem_params(seed, c=64):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.1, (7, 7, 3, c)).astype(np.float32),
            rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.normal(0, 0.1, c).astype(np.float32),
            rng.normal(0, 0.1, c).astype(np.float32),
            rng.uniform(0.5, 2.0, c).astype(np.float32))


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _pool_reference(y, bias):
    """numpy: + bias, ReLU, 3×3/2 maxpool with −inf padding, in float32."""
    y = np.maximum(y.astype(np.float32) + bias.astype(np.float32), 0)
    b, h, w, c = y.shape
    p = np.full((b, h + 2, w + 2, c), -np.inf, np.float32)
    p[:, 1:-1, 1:-1] = y
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    out = np.full((b, ho, wo, c), -np.inf, np.float32)
    for dy in range(3):
        for dx in range(3):
            out = np.maximum(out, p[:, dy:dy + 2 * ho:2, dx:dx + 2 * wo:2])
    return out


# ---------------------------------------------------------------------------
# bias + ReLU + maxpool (2b)
# ---------------------------------------------------------------------------


def test_bias_relu_pool_equals_jax_kernel_in_float32():
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from ss25_hierarchical_multiscale_image_classification_tpu.ops.pallas.fused_stem import (
        bias_relu_pool as jax_bias_relu_pool,
    )

    rng = np.random.default_rng(1)
    y = rng.normal(0, 1, (2, 112, 112, 64)).astype(np.float32)
    bias = rng.normal(0, 0.5, 64).astype(np.float32)
    ref = np.asarray(jax_bias_relu_pool(jnp.asarray(y), jnp.asarray(bias),
                                        out_dtype=jnp.float32))
    out = fs.bias_relu_pool(torch.from_numpy(y), torch.from_numpy(bias),
                            torch.float32)
    assert out.shape == (2, 56, 56, 64) and out.dtype == torch.float32
    assert out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), ref)  # one add and maxima


@pytest.mark.parametrize("shape,bias_map,dtype", [
    ((2, 30, 26, 16), False, torch.float32),
    ((2, 31, 27, 8), True, torch.float32),  # odd plane, per-position bias
    ((3, 12, 10, 8), True, torch.bfloat16),
])
def test_bias_relu_pool_any_plane_and_bias_map(shape, bias_map, dtype):
    rng = np.random.default_rng(shape[1])
    y = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dtype)
    bias = rng.normal(0, 0.5, shape[1:] if bias_map else shape[-1:])
    bias = bias.astype(np.float32)
    ref = _pool_reference(y.float().numpy(), bias)
    out = fs.bias_relu_pool(y, torch.from_numpy(bias), torch.float32)
    np.testing.assert_array_equal(out.numpy(), ref)
    out16 = fs.bias_relu_pool(y, torch.from_numpy(bias), torch.bfloat16)
    assert out16.dtype == torch.bfloat16
    assert torch.equal(out16, torch.from_numpy(ref).to(torch.bfloat16))


def test_bias_relu_pool_pad_never_wins():
    """An all-negative plane pools to exact zeros everywhere, borders
    included, whatever the bias rounds to in the plane's dtype."""
    y = torch.full((1, 8, 8, 8), -3.0, dtype=torch.bfloat16)
    bias = torch.full((8,), 0.3337, dtype=torch.float32)  # not a bf16 value
    out = fs.bias_relu_pool(y, bias, torch.bfloat16)
    assert torch.equal(out, torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# whole stem (2c)
# ---------------------------------------------------------------------------


def test_stem_space_to_depth_matches_jax():
    jax = pytest.importorskip("jax")
    from ss25_hierarchical_multiscale_image_classification_tpu.ops.pallas.fused_stem import (
        stem_space_to_depth as jax_s2d,
    )

    imgs = _u8(2, (2, 224, 224, 3))
    ref = np.asarray(jax_s2d(jax.numpy.asarray(imgs)))
    out = fs.stem_space_to_depth(torch.from_numpy(imgs))
    assert out.shape == (2, 115, 115, 12) and out.dtype == torch.float32
    # x·a + b in float32: equal up to a fused multiply-add's last bit
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    # the layout: cell (Y, X), slot (dy·2+dx)·3+c is padded pixel (2Y+dy, 2X+dx)
    x = normalize(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(out[1, 50, 7, (1 * 2 + 0) * 3 + 2].item(),
                               x[1, 2 * 50 + 1 - 3, 2 * 7 + 0 - 3, 2], atol=1e-5)
    assert (out[:, 0] == 0).all() and (out[:, :, 114, 6:] == 0).all()


def test_fold_stem_params_matches_jax():
    pytest.importorskip("jax")
    from ss25_hierarchical_multiscale_image_classification_tpu.ops.pallas.fused_stem import (
        fold_stem_params as jax_fold,
    )

    params = _stem_params(3)
    jw2, jbias = jax_fold(*params)
    w2, bias = fs.fold_stem_params(*params)
    assert w2.shape == (4, 48, 64) and bias.shape == (64,)
    np.testing.assert_allclose(w2.numpy(), np.asarray(jw2), rtol=1e-6, atol=0)
    np.testing.assert_allclose(bias.numpy(), np.asarray(jbias), rtol=1e-6,
                               atol=1e-7)
    # row KY·12 + (dy·2+dx)·3 + c of group KX is tap (2KY+dy, 2KX+dx); tap 7 is 0
    g = params[1] / np.sqrt(params[4] + 1e-5)
    np.testing.assert_allclose(w2[1, 2 * 12 + (1 * 2 + 0) * 3 + 1].numpy(),
                               params[0][2 * 2 + 1, 2 * 1 + 0, 1] * g, rtol=1e-5)
    assert (w2[3, 3 * 12 + 6:] == 0).all() and (w2[:, 3 * 12 + 6:] == 0).all()


def test_fused_stem_matches_jax_kernel_in_float32():
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from ss25_hierarchical_multiscale_image_classification_tpu.ops.pallas import (
        fused_stem as jfs,
    )

    params = _stem_params(4)
    imgs = _u8(5, (1, 224, 224, 3))
    jw2, jbias = jfs.fold_stem_params(*params)
    jin2 = jfs.stem_space_to_depth(jnp.asarray(imgs))
    ref = np.asarray(jfs.fused_stem(jin2, jw2, jbias, out_dtype=jnp.float32,
                                    mm_dtype=jnp.float32))
    # the same inputs (JAX's, as numpy) through the port's function
    out = fs.fused_stem(torch.from_numpy(np.array(jin2)),
                        torch.from_numpy(np.array(jw2)),
                        torch.from_numpy(np.array(jbias)),
                        out_dtype=torch.float32, mm_dtype=torch.float32)
    assert out.shape == (1, 56, 56, 64)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def _unfolded_stem(imgs_u8, params, eps=1e-5):
    """conv1 → bn1 → ReLU → maxpool of the port's ResNet18, NHWC float32."""
    kernel, scale, bias, mean, var = params
    model = ResNet18Classifier(num_filters=kernel.shape[-1])
    with torch.no_grad():
        model.conv1.weight.copy_(torch.from_numpy(kernel).permute(3, 2, 0, 1))
        model.bn1.weight.copy_(torch.from_numpy(scale))
        model.bn1.bias.copy_(torch.from_numpy(bias))
        model.bn1.running_mean.copy_(torch.from_numpy(mean))
        model.bn1.running_var.copy_(torch.from_numpy(var))
        x = normalize(imgs_u8).permute(0, 3, 1, 2)
        y = model.maxpool(model.relu(model.bn1(model.conv1(x))))
    return y.permute(0, 2, 3, 1)


def test_stem_forward_and_hybrid_match_jax_and_the_unfolded_stem():
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from ss25_hierarchical_multiscale_image_classification_tpu.ops.pallas import (
        fused_stem as jfs,
    )

    params = _stem_params(6)
    imgs = _u8(7, (1, 224, 224, 3))
    t_imgs = torch.from_numpy(imgs)
    fused = fs.stem_forward(t_imgs, *params, dtype=torch.float32)
    hybrid = fs.stem_forward_hybrid(t_imgs, *params, dtype=torch.float32)
    unfolded = _unfolded_stem(t_imgs, params)
    scale = unfolded.abs().max().item()
    assert fused.shape == hybrid.shape == unfolded.shape == (1, 56, 56, 64)
    for got in (fused, hybrid):
        assert (got - unfolded).abs().max().item() <= 1e-4 * scale
    assert (fused - hybrid).abs().max().item() <= 1e-4 * scale
    j_fused = np.asarray(jfs.stem_forward(jnp.asarray(imgs), *params,
                                          dtype=jnp.float32))
    j_hybrid = np.asarray(jfs.stem_forward_hybrid(jnp.asarray(imgs), *params,
                                                  dtype=jnp.float32))
    np.testing.assert_allclose(fused.numpy(), j_fused, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(hybrid.numpy(), j_hybrid, rtol=0,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("forward", ["stem_forward", "stem_forward_hybrid"])
def test_stem_forwards_in_bfloat16_stay_near_float32(forward):
    """bfloat16 products (inputs rounded to 8 bits of mantissa, float32
    accumulation) and a bfloat16 output: within 2 % of the largest value of
    the float32 stem, over K = 147 taps."""
    params = _stem_params(8)
    imgs = torch.from_numpy(_u8(9, (2, 64, 96, 3)))
    fn = getattr(fs, forward)
    ref = fn(imgs, *params, dtype=torch.float32)
    out = fn(imgs, *params, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 16, 24, 64)
    assert (out.float() - ref).abs().max().item() <= 0.02 * ref.abs().max().item()


def test_fused_stem_serves_the_folded_route_layout():
    """The folded forward cuts cells first and pads (2, 1), with an 8×8
    front-padded kernel: same shapes and slot order as ``stem_space_to_depth``
    + ``fold_stem_params``, other weights. ``fused_stem`` with those inputs
    and a bias map equals the direct 7×7/2 conv of the unpadded image."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quantized import (
        _stem_kernel_s2d,
    )

    rng = np.random.default_rng(10)
    kernel = rng.normal(0, 0.1, (7, 7, 3, 16)).astype(np.float32)
    bias_map = rng.normal(0, 0.3, (20, 24, 16)).astype(np.float32)
    t = torch.from_numpy(_u8(11, (2, 40, 48, 3))).float() - 128
    k = _stem_kernel_s2d(kernel)  # (KY, KX, 12, O)
    w2 = torch.from_numpy(k.transpose(1, 0, 2, 3).reshape(4, 48, 16).copy())
    s = t.reshape(2, 20, 2, 24, 2, 3).permute(0, 1, 3, 2, 4, 5)
    s = F.pad(s.reshape(2, 20, 24, 12), (0, 0, 2, 1, 2, 1))
    out = fs.fused_stem(s, w2, torch.from_numpy(bias_map), torch.float32,
                        torch.float32)
    y = F.conv2d(t.permute(0, 3, 1, 2),
                 torch.from_numpy(kernel).permute(3, 2, 0, 1), None, 2, 3)
    ref = fs.bias_relu_pool(y.permute(0, 2, 3, 1), torch.from_numpy(bias_map),
                            torch.float32)
    assert out.shape == ref.shape == (2, 10, 12, 16)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_resnet_from_stem_matches_jax():
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from ss25_hierarchical_multiscale_image_classification_tpu.models.resnet import (
        ResNet18Classifier as JaxResNet18Classifier,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        state_dict_from_flax,
    )
    from tests.test_torch_port_models import randomized_variables

    jmodel = JaxResNet18Classifier(dtype=jnp.float32, num_filters=8)
    variables = randomized_variables(jmodel, seed=12)
    x = np.random.default_rng(13).normal(size=(3, 8, 8, 8)).astype(np.float32)
    x = np.maximum(x, 0)  # a pooled stem output is non-negative
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False,
                                  from_stem=True))
    port = ResNet18Classifier(num_filters=8)
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(x), from_stem=True)
        full = port(torch.from_numpy(
            np.random.default_rng(14).normal(size=(3, 32, 32, 3)).astype(np.float32)))
    assert out.shape == full.shape == (3, 2)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-3, atol=2e-4)


def _stem_image_offsets():
    """numpy model of the wgmma weight image: the bf16 element offset of
    ``w2[KX, KY·12 + slot, o]``. K = KY·48 + KX·12 + slot runs in steps of
    16 (2 KB each); in a step, core matrices of 8 channels × 8 values (16
    contiguous bytes a channel): channel groups 256 bytes apart, the two K
    halves 128."""
    kx, r, o = np.meshgrid(np.arange(4), np.arange(48), np.arange(64),
                           indexing="ij")
    ky, slot = r // 12, r % 12
    k = ky * 48 + kx * 12 + slot
    ks, half, e = k // 16, (k % 16) // 8, k % 8
    return ks * 1024 + (o // 8) * 128 + half * 64 + (o % 8) * 8 + e


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", [17, 18])
def test_pack_stem_weights_unpacks_exactly(dtype, seed):
    """Packing, then reading back through the numpy model of the layout,
    gives ``w2`` rounded to bfloat16 exactly, and every element of the image
    is a weight."""
    w2 = torch.from_numpy(np.random.default_rng(seed).normal(
        0, 0.1, (4, 48, 64)).astype(np.float32)).to(dtype)
    packed = fs.pack_stem_weights(w2)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.numel() * 2 == fs.W_IMAGE_BYTES
    at = _stem_image_offsets()
    assert np.array_equal(np.sort(at.reshape(-1)), np.arange(packed.numel()))
    assert torch.equal(packed[torch.from_numpy(at.reshape(-1))].reshape(4, 48, 64),
                       w2.to(torch.bfloat16))
    # the folded forward's s2d stem weights take the same packing
    assert torch.equal(fs.pack_stem_weights(w2.contiguous()), packed)


def test_pack_stem_weights_cache_and_refusals():
    w2 = torch.randn(4, 48, 64)
    first = fs._packed_weights(w2)
    assert fs._packed_weights(w2) is first  # packed once per weight tensor
    w2.mul_(2)  # an in-place change packs again
    again = fs._packed_weights(w2)
    assert again is not first
    assert torch.equal(again, fs.pack_stem_weights(w2))
    with torch.inference_mode():  # the feature loop's weights
        w_inf = torch.randn(4, 48, 64)
        packed = fs._packed_weights(w_inf)
        assert fs._packed_weights(w_inf) is packed
    assert torch.equal(packed, fs.pack_stem_weights(w_inf))
    with pytest.raises(ValueError):
        fs.pack_stem_weights(torch.zeros(4, 48, 32))


# (B, Hc + 3, Wc + 3): the path's plane, Wc < 64, an odd plane, the widest
@pytest.mark.parametrize("b,hin,win", [(512, 115, 115), (37, 115, 115),
                                       (1, 115, 115), (2, 34, 48), (3, 35, 51),
                                       (2, 115, 128), (1, 131, 131), (4, 4, 4)])
@pytest.mark.parametrize("bias", ["vector", "map bf16", "map f32"])
def test_stem_wgmma_plan_fits_and_covers(b, hin, win, bias):
    """The plan's shared memory fits a block, its warps cover every pooled
    column, its bands every pooled row, and there are no more blocks than
    SMs or work items; a (64,) bias takes the whole plane as one band."""
    hc, wc = hin - 3, win - 3
    ho, wo = (hc - 1) // 2 + 1, (wc - 1) // 2 + 1
    is_map, bf16 = bias != "vector", bias == "map bf16"
    pool_rows, blocks, tiles, smem = fs.stem_wgmma_plan(b, hin, win, is_map,
                                                        bf16, 132)
    assert smem <= fs.SMEM_BUDGET
    assert tiles in (1, 2, 3)
    assert 4 * tiles * fs.POOLS_PER_WARP >= wo > 4 * (tiles - 1) * fs.POOLS_PER_WARP
    assert 1 <= pool_rows <= ho
    bands = -(-ho // pool_rows)
    assert 1 <= blocks == min(132, b * bands)
    band_rows = min(2 * pool_rows + 1, hc)
    slot = (win * 24 + 16 + 15) // 16 * 16
    assert slot >= win * 24 + 8 and slot % 16 == 0
    if is_map:
        elem = 2 if bf16 else 4
        assert smem == (fs.W_IMAGE_BYTES + fs.RING_SLOTS * slot
                        + band_rows * wc * fs.BIAS_PITCH * elem)
        # one more pooled row would not fit
        if pool_rows < ho:
            taller = min(2 * pool_rows + 3, hc) * wc * fs.BIAS_PITCH * elem
            assert smem - band_rows * wc * fs.BIAS_PITCH * elem + taller \
                > fs.SMEM_BUDGET
    else:
        assert pool_rows == ho
    if (b, hin, win, bias) == (512, 115, 115, "map bf16"):
        assert (pool_rows, blocks, tiles) == (5, 132, 2)  # the path


def test_stem_wrappers_reject_bad_input_and_count_no_cpu_launch():
    before = (fs.bias_relu_pool_kernel.launches, fs.fused_stem_kernel.launches)
    y = torch.zeros(1, 8, 8, 8)
    fs.bias_relu_pool(y, torch.zeros(8), torch.float32)
    in2 = torch.zeros(1, 7, 7, 12)
    fs.fused_stem(in2, torch.zeros(4, 48, 8), torch.zeros(8), torch.float32,
                  torch.float32)
    assert (fs.bias_relu_pool_kernel.launches,
            fs.fused_stem_kernel.launches) == before  # the CPU takes plain
    with pytest.raises(ValueError):
        fs.bias_relu_pool(y, torch.zeros(4), torch.float32)
    with pytest.raises(ValueError):
        fs.bias_relu_pool(y, torch.zeros(8, 8), torch.float32)
    with pytest.raises(ValueError):
        fs.bias_relu_pool(y.half(), torch.zeros(8), torch.float32)
    with pytest.raises(ValueError):
        fs.bias_relu_pool_kernel(y, torch.zeros(8), torch.float32)  # on the CPU
    with pytest.raises(ValueError):
        fs.fused_stem(in2[..., :9], torch.zeros(4, 48, 8), torch.zeros(8))
    with pytest.raises(ValueError):
        fs.fused_stem(in2, torch.zeros(4, 36, 8), torch.zeros(8))
    with pytest.raises(ValueError):
        fs.fused_stem(in2, torch.zeros(4, 48, 8), torch.zeros(5, 4, 8))
    with pytest.raises(ValueError):
        fs.fused_stem_kernel(in2, torch.zeros(4, 48, 64), torch.zeros(64))
    with pytest.raises(ValueError):
        fs.stem_space_to_depth(torch.zeros(1, 7, 8, 3, dtype=torch.uint8))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,bias_map", [
    ((64, 112, 112, 64), torch.bfloat16, False),
    ((64, 112, 112, 64), torch.bfloat16, True),
    ((3, 112, 112, 64), torch.float32, True),
    ((2, 30, 26, 16), torch.float32, False),
    ((2, 31, 27, 8), torch.bfloat16, True),
])
def test_bias_relu_pool_cuda_kernel_is_exact(cuda_device, shape, dtype,
                                             bias_map):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    y = torch.randn(shape, device=cuda_device, generator=g).to(dtype)
    bias = 0.5 * torch.randn(shape[1:] if bias_map else shape[-1:],
                             device=cuda_device, generator=g)
    for out_dtype in (torch.bfloat16, torch.float32):
        before = fs.bias_relu_pool_kernel.launches
        out = fs.bias_relu_pool(y, bias, out_dtype)
        torch.cuda.synchronize()
        assert fs.bias_relu_pool_kernel.launches == before + 1
        ref = fs.bias_relu_pool_reference(y, bias, out_dtype)
        assert out.dtype == out_dtype and out.shape == ref.shape
        assert torch.equal(out, ref)


def _folded_cells(imgs):
    """The folded forward's space-to-depth input: ``u8 − 128`` cut into
    cells, then padded (2, 1), in bfloat16 (exact)."""
    n, h, w, _ = imgs.shape
    t = imgs.to(torch.bfloat16) - 128
    s = t.reshape(n, h // 2, 2, w // 2, 2, 3).permute(0, 1, 3, 2, 4, 5)
    return F.pad(s.reshape(n, h // 2, w // 2, 12), (0, 0, 2, 1, 2, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,hw,layout", [
    (1, (224, 224), "s2d"), (37, (224, 224), "s2d"), (3, (64, 96), "s2d"),
    (2, (62, 90), "s2d"), (512, (224, 224), "folded"), (37, (224, 224), "folded"),
    (2, (224, 250), "folded"), (2, (256, 256), "s2d"), (1, (222, 226), "folded")])
def test_fused_stem_cuda_kernel_matches_plain_version(cuda_device, batch, hw,
                                                      layout):
    """Both kernels against the plain version: B of 1, 37 and 512; conv
    planes 45–128 wide (one, two and three warpgroups of the wgmma kernel);
    planes of an odd number of cells, whose rows start 0 and 8 bytes past a
    16-byte boundary in turn; a (64,) bias and a map (float32 with the
    ``stem_space_to_depth`` layout, bfloat16 with the folded route's)."""
    torch.backends.cudnn.allow_tf32 = False
    params = _stem_params(15)
    imgs = torch.from_numpy(_u8(16, (batch, *hw, 3))).to(cuda_device)
    w2, bias = fs.fold_stem_params(*params)
    w2, bias = w2.to(cuda_device), bias.to(cuda_device)
    in2 = fs.stem_space_to_depth(imgs) if layout == "s2d" else _folded_cells(imgs)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    bias_map = bias + torch.randn(hw[0] // 2, hw[1] // 2, 64,
                                  device=cuda_device, generator=g)
    if layout == "folded":
        bias_map = bias_map.to(torch.bfloat16)
    for bb in (bias, bias_map):
        before = fs.fused_stem_kernel.launches
        out = fs.fused_stem(in2, w2, bb, torch.float32, torch.float32)
        torch.cuda.synchronize()
        assert fs.fused_stem_kernel.launches == before + 1
        ref = fs.fused_stem_reference(in2, w2, bb.float(), torch.float32,
                                      torch.float32)
        assert out.shape == ref.shape
        # float32 FMA chains of 192 terms in another order than cuDNN's
        assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
        # bfloat16 products: the same rounded inputs, float32 accumulation;
        # the bfloat16 output may round across one step (2^-8 relative)
        for out_dtype in (torch.bfloat16, torch.float32):
            out16 = fs.fused_stem(in2.to(torch.bfloat16), w2, bb, out_dtype)
            ref16 = fs.fused_stem_reference(in2.to(torch.bfloat16), w2,
                                            bb.float(), out_dtype)
            torch.cuda.synchronize()
            assert out16.dtype == out_dtype and out16.shape == ref16.shape
            step = 2.0 ** -7 * ref16.float().abs().clamp_min(1.0)
            assert ((out16.float() - ref16.float()).abs() <= step).all()
