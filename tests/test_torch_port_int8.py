"""The port's int8 (w8a8) ops, quantization and forward against the JAX
package's.

The same numpy inputs (seeded) go through the JAX functions
(``models/quantized.py``: ``_convq``, ``_requant``, ``quantize_*``,
``quant_forward``; ``ops/pallas/int8_block.py`` in interpret mode;
``models/quant_artifact.py``) and the port's, on the CPU, where the port's
int8 kernels are their plain versions (an exact integer convolution and an
eager float32 epilogue).

Tolerances, and why:

- int32 accumulators: equal (integers).
- one conv's int8 output: within 1 step on at most ``CONV_FLIP_RATE`` of the
  elements. XLA's CPU backend may contract ``y·mscale + bias`` into an FMA
  and divide by a reciprocal; eager PyTorch rounds after every op, so a
  value that lands within an ulp of a rounding boundary can fall the other
  way.
- the fused stage 1 (four convs, two blocks): the JAX test's own bound
  between its kernel and its XLA loop, |diff| ≤ 2 on < 5e-3 of the elements
  (``tests/test_ops.py``), for the same reason, cascading through the
  blocks.
- ``quant_forward`` features and logits, and the calibrated activation
  scales: float32 forwards in two frameworks (other summation orders), and
  for the int8 forward a few flipped roundings among thousands of values per
  feature: stated at each test.

The ``cuda``-marked tests hold the CUDA kernels to the plain versions
exactly and run on a machine with a card
(``python -m pytest --noconftest -m cuda tests/test_torch_port_int8.py``);
JAX is imported inside the fixtures that compare with it.
"""

import types

import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.models import (
    quant_artifact as qa,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models import (
    quantized as q,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    quantized_from_jax,
    state_dict_from_flax,
    strip_head,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops import (
    int8_block as ib,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops import (
    int8_conv as ic,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops import (
    int8_pool as ip,
)

torch.set_num_threads(2)

CONV_FLIP_RATE = 2e-3
# (name, (H, W, C_in), C_out, k, stride, pad, epilogue): every row of the
# int8 forward's convolution table at narrow widths
CONV_CASES = [
    ("stem_s2d_map", (12, 12, 12), 8, 4, 1, ((2, 1), (2, 1)), "map"),
    ("stem_direct_map", (24, 24, 3), 8, 7, 2, 3, "map"),
    ("stem_direct_vector", (24, 24, 3), 8, 7, 2, 3, "relu"),
    ("c1", (10, 10, 8), 8, 3, 1, 1, "relu"),
    ("c1_stride2", (10, 10, 8), 16, 3, 2, 1, "relu"),
    ("c2_residual", (10, 10, 16), 16, 3, 1, 1, "res_f32"),
    ("c2_int8_residual", (7, 7, 16), 16, 3, 1, 1, "res_i8"),
    ("down_1x1", (10, 10, 8), 16, 1, 2, 0, "f32"),
    ("down_odd_plane", (7, 9, 16), 32, 1, 2, 0, "f32"),
]


@pytest.fixture(scope="module")
def jx():
    """jax, jax.numpy and the JAX package's int8 modules."""
    jax = pytest.importorskip("jax")
    from ss25_hierarchical_multiscale_image_classification_tpu.models import (
        quant_artifact,
        quantized,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu.ops.pallas import (
        int8_block,
    )

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, q=quantized,
                                 qa=quant_artifact, ib=int8_block)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _conv_operands(seed, batch, case):
    """One conv's operands as numpy: int8 activations and HWIO weights over
    the whole range, scales that spread the output over the int8 range."""
    _, (h, w, cin), cout, k, stride, pad, kind = case
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (batch, h, w, cin)).astype(np.int8)
    hwio = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    unit = 1.0 / ((k * k * cin) ** 0.5 * 73.3 * 73.3)
    mscale = (unit * rng.uniform(0.5, 1.5, cout)).astype(np.float32)
    p = ((pad, pad), (pad, pad)) if isinstance(pad, int) else pad
    ho = (h + sum(p[0]) - k) // stride + 1
    wo = (w + sum(p[1]) - k) // stride + 1
    bias = rng.normal(0, 0.3, (ho, wo, cout) if kind == "map" else (cout,))
    res = None
    if kind == "res_f32":
        res = rng.normal(0, 1, (batch, ho, wo, cout)).astype(np.float32)
    elif kind == "res_i8":
        res = rng.integers(-127, 128, (batch, ho, wo, cout)).astype(np.int8)
    return xq, hwio, mscale, bias.astype(np.float32), res, p


def _torch_conv_args(xq, hwio, mscale, bias, res, kind):
    t = torch.from_numpy
    kw = {"relu": kind != "f32", "out_f32": kind == "f32"}
    if res is not None:
        kw["residual"] = t(res)
        if res.dtype == np.int8:
            kw["residual_scale"] = torch.tensor(1.0 / 64)
    qk = t(hwio).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return (t(xq), qk, t(mscale), t(bias)), kw


# ---------------------------------------------------------------------------
# (1) the int8 conv + requant, every row of the table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_int8_conv_requant_matches_jax(jx, case):
    jnp = jx.jnp
    _, _, _, _, stride, _, kind = case
    xq, hwio, mscale, bias, res, p = _conv_operands(3, 3, case)
    s_out = np.float32(3.0 / 127)
    # JAX: _convq, then _requant (or the downsample's float32 dequantize)
    y32 = jx.q._convq(jnp.asarray(xq), jnp.asarray(hwio), stride,
                      [tuple(p[0]), tuple(p[1])])
    if kind == "f32":
        want = np.asarray(y32.astype(jnp.float32) * mscale + bias)
    else:
        r = res
        if res is not None and res.dtype == np.int8:
            r = jnp.asarray(res).astype(jnp.float32) * np.float32(1.0 / 64)
        want = np.asarray(jx.q._requant(y32, mscale, bias, s_out,
                                        residual_f32=r))

    args, kw = _torch_conv_args(xq, hwio, mscale, bias, res, kind)
    acc = ic.int8_conv_reference(args[0], args[1], stride, p)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(y32))  # exact

    s = None if kind == "f32" else torch.tensor(s_out)
    got = ic.int8_conv_requant(*args, s, stride, p, **kw).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if kind == "f32":
        # float32: one multiply and one add (an FMA differs by an ulp)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1, diff.max()
        assert (diff > 0).mean() <= CONV_FLIP_RATE, (diff > 0).mean()
        assert want.std() > 10  # the outputs use the int8 range


def test_requant_reference_rounds_half_to_even_and_clips():
    acc = torch.tensor([[1, 3, 5, -3, 1000, -1000, 0]], dtype=torch.int32)
    one = torch.ones(7)
    got = ic.requant_reference(acc, one * 0.5, torch.zeros(7),
                               torch.tensor(1.0), relu=False)
    # 0.5, 1.5, 2.5, -1.5 round to even; ±500 clip to ±127
    assert got.tolist() == [[0, 2, 2, -2, 127, -127, 0]]
    assert got.dtype == torch.int8
    relu = ic.requant_reference(acc, one, torch.zeros(7), torch.tensor(1.0))
    assert relu.tolist() == [[1, 3, 5, 0, 127, 0, 0]]


def _image_offsets(c_out, c_in, kh, kw, n):
    """A numpy model of the shared-memory weight image that the ``wgmma``
    kernels read: the byte offset of weight ``[o][ky][kx][ci]``. Per block of
    ``n`` output channels and chunk of 32 input channels the taps follow each
    other; a tap's tile is ``n`` channels × 32 bytes in core matrices (8
    channels × 16 bytes, 128 contiguous bytes): groups of 8 channels 256 bytes
    apart, the two 16-byte halves of the chunk 128."""
    o, ky, kx, ci = np.meshgrid(np.arange(c_out), np.arange(kh), np.arange(kw),
                                np.arange(c_in), indexing="ij")
    tap = ky * kw + kx
    block, group, row = o // n, (o % n) // 8, o % 8
    chunk, half, byte = ci // 32, (ci % 32) // 16, ci % 16
    tile = ((block * (c_in // 32) + chunk) * (kh * kw) + tap) * (n * 32)
    return tile + group * 256 + half * 128 + row * 16 + byte


@pytest.mark.parametrize("c_in,kw_,rows", [(12, 4, 64), (3, 7, 32)])
def test_pack_int8_kernel_layout(c_in, kw_, rows):
    rng = np.random.default_rng(5)
    k = torch.from_numpy(rng.integers(-127, 128, (64, c_in, kw_, kw_))
                         .astype(np.int8))
    packed = ic.pack_int8_kernel(k)
    assert packed.shape == (64, kw_, rows) and packed.is_contiguous()
    assert packed.shape == ic.packed_shape(64, -(-c_in // 4) * 4, kw_, kw_)
    cp = -(-c_in // 4) * 4
    ohwi = torch.zeros(64, kw_, kw_, cp, dtype=torch.int8)
    ohwi[..., :c_in] = k.permute(0, 2, 3, 1)
    want = torch.zeros(64, kw_, rows, dtype=torch.int8)
    want[:, :, :kw_ * cp] = ohwi.reshape(64, kw_, kw_ * cp)
    assert torch.equal(packed, want)


# (C_out, C_in, k): the stage convolutions and 1x1 downsamples of the int8
# forward at full width, a 64-channel block (stage 1) and an odd C_out
@pytest.mark.parametrize("c_out,c_in,k", [
    (64, 64, 3), (128, 64, 3), (128, 64, 1), (128, 128, 3), (256, 128, 3),
    (256, 128, 1), (256, 256, 3), (512, 256, 3), (512, 256, 1), (512, 512, 3),
    (192, 64, 3), (128, 64, 5),
])
def test_pack_int8_kernel_wgmma_image_unpacks_exactly(c_out, c_in, k):
    """The packed image, read back through the numpy model of the layout,
    is ``[o][ky][kx][ci]`` exactly, and every byte of it is a weight."""
    rng = np.random.default_rng(c_out + c_in + k)
    w = rng.integers(-127, 128, (c_out, c_in, k, k)).astype(np.int8)
    packed = ic.pack_int8_kernel(torch.from_numpy(w))
    n = ic.wgmma_block(c_out, k * k)
    assert n == (128 if c_out % 128 == 0 and k < 5 else 64)
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert packed.shape == (c_out // n, c_in // 32, k * k * n * 32)
    assert packed.shape == ic.packed_shape(c_out, c_in, k, k)
    at = _image_offsets(c_out, c_in, k, k, n)
    assert np.array_equal(np.sort(at.reshape(-1)), np.arange(w.size))
    np.testing.assert_array_equal(packed.numpy().reshape(-1)[at],
                                  w.transpose(0, 2, 3, 1))
    # the same image from a channels_last kernel
    cl = torch.from_numpy(w).contiguous(memory_format=torch.channels_last)
    assert torch.equal(ic.pack_int8_kernel(cl), packed)


def test_pack_int8_kernel_refuses_other_widths():
    with pytest.raises(ValueError, match="multiples of 64"):
        ic.pack_int8_kernel(torch.zeros(32, 64, 3, 3, dtype=torch.int8))
    with pytest.raises(ValueError, match="at most 16"):
        ic.pack_int8_kernel(torch.zeros(64, 24, 3, 3, dtype=torch.int8))
    with pytest.raises(ValueError, match="weight image"):
        ic.wgmma_weight_image(torch.zeros(64, 3, 3, 48, dtype=torch.int8), 64)


def test_int8_conv_requant_refuses_bad_arguments():
    xq = torch.zeros(1, 4, 4, 8, dtype=torch.int8)
    k = torch.zeros(8, 8, 3, 3, dtype=torch.int8)
    one, s = torch.ones(8), torch.tensor(1.0)
    with pytest.raises(ValueError, match="int8 batch"):
        ic.int8_conv_requant(xq.float(), k, one, one, s, 1, 1)
    with pytest.raises(ValueError, match="weights"):
        ic.int8_conv_requant(xq, k[:, :4], one, one, s, 1, 1)
    with pytest.raises(ValueError, match="bias"):
        ic.int8_conv_requant(xq, k, one, torch.ones(3), s, 1, 1)
    with pytest.raises(ValueError, match="s_out"):
        ic.int8_conv_requant(xq, k, one, one, None, 1, 1)
    with pytest.raises(ValueError, match="residual_scale"):
        ic.int8_conv_requant(xq, k, one, one, s, 1, 1, residual=xq)
    with pytest.raises(ValueError, match="CUDA"):
        ic.int8_conv_requant_kernel(xq, k, one, one, s, 1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        ib.fused_stage1_int8_kernel(
            torch.zeros(1, 4, 4, 64, dtype=torch.int8),
            torch.zeros(4, 3, 3, 64, 64, dtype=torch.int8),
            torch.ones(4, 64), torch.ones(4, 64), torch.ones(5))


@pytest.mark.parametrize("shape", [(2, 12, 12, 8), (1, 7, 9, 16), (3, 1, 5, 4)])
def test_int8_maxpool_equals_jax_reduce_window(jx, shape):
    """The int8 pool of ``quant_forward`` (pad −128): maxima of integers,
    equal; a window of −128 keeps −128."""
    from jax import lax

    x = np.random.default_rng(4).integers(-128, 128, shape).astype(np.int8)
    x[0, 0, :2] = -128
    want = np.asarray(lax.reduce_window(
        jx.jnp.asarray(x), jx.jnp.int8(-128), lax.max, (1, 3, 3, 1),
        (1, 2, 2, 1), [(0, 0), (1, 1), (1, 1), (0, 0)]))
    got = ip.int8_maxpool(torch.from_numpy(x))
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="int8 plane"):
        ip.int8_maxpool(torch.from_numpy(x).float())
    with pytest.raises(ValueError, match="CUDA"):
        ip.int8_maxpool_kernel(torch.from_numpy(x))


# ---------------------------------------------------------------------------
# (2) the fused stage 1
# ---------------------------------------------------------------------------


def _stage1_operands(seed, shape):
    """The operands of ``tests/test_ops.py::test_fused_stage1_matches_quant_forward``."""
    rng = np.random.default_rng(seed)
    c = shape[3]
    xq = rng.integers(-127, 128, shape).astype(np.int8)
    kernels = rng.integers(-127, 128, (4, 3, 3, c, c)).astype(np.int8)
    wscales = rng.uniform(1e-3, 2e-3, (4, c)).astype(np.float32)
    biases = rng.normal(0, 0.1, (4, c)).astype(np.float32)
    scalars = rng.uniform(0.01, 0.05, 5).astype(np.float32)
    mscales = (scalars[:4, None] * wscales).astype(np.float32)
    return xq, kernels, wscales, mscales, biases, scalars


def _jax_stage1_loop(jx, xq, kernels, wscales, biases, scalars):
    """The stage-1 loop of the JAX ``quant_forward`` (``tests/test_ops.py``)."""
    jnp = jx.jnp
    x = jnp.asarray(xq)
    for blk in range(2):
        c1, c2 = 2 * blk, 2 * blk + 1
        s_x, s_y1, s_o = scalars[2 * blk], scalars[2 * blk + 1], scalars[2 * blk + 2]
        y32 = jx.q._convq(x, jnp.asarray(kernels[c1]), 1, [(1, 1), (1, 1)])
        y1 = jx.q._requant(y32, s_x * wscales[c1], biases[c1], s_y1)
        y32 = jx.q._convq(y1, jnp.asarray(kernels[c2]), 1, [(1, 1), (1, 1)])
        x = jx.q._requant(y32, s_y1 * wscales[c2], biases[c2], s_o,
                          residual_f32=x.astype(jnp.float32) * s_x)
    return np.asarray(x)


def _assert_stage1_close(got, want):
    """The bound of ``tests/test_ops.py:307-312``."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 2, diff.max()
    assert (diff > 0).mean() < 5e-3, (diff > 0).mean()


@pytest.mark.parametrize("batch", [1, 3])
def test_fused_stage1_int8_matches_jax_kernel_and_loop(jx, batch):
    jnp = jx.jnp
    xq, kernels, wscales, mscales, biases, scalars = _stage1_operands(
        0, (batch, 56, 56, 64))
    got = ib.fused_stage1_int8(*(torch.from_numpy(a) for a in
                                 (xq, kernels, mscales, biases, scalars)))
    assert got.shape == xq.shape and got.dtype == torch.int8
    pallas = np.asarray(jx.ib.fused_stage1_int8(
        jnp.asarray(xq), jnp.asarray(kernels), jnp.asarray(mscales),
        jnp.asarray(biases), jnp.asarray(scalars), interpret=True))
    _assert_stage1_close(got.numpy(), pallas)
    _assert_stage1_close(
        got.numpy(), _jax_stage1_loop(jx, xq, kernels, wscales, biases, scalars))


@pytest.mark.parametrize("shape", [(2, 9, 7, 8), (1, 12, 20, 16)])
def test_fused_stage1_int8_reference_any_plane_matches_jax_loop(jx, shape):
    xq, kernels, wscales, mscales, biases, scalars = _stage1_operands(1, shape)
    got = ib.fused_stage1_int8(*(torch.from_numpy(a) for a in
                                 (xq, kernels, mscales, biases, scalars)))
    _assert_stage1_close(
        got.numpy(), _jax_stage1_loop(jx, xq, kernels, wscales, biases, scalars))


def test_fused_stage1_int8_zero_pads_every_intermediate():
    """With zero weights every conv gives its bias: the borders of the result
    equal its interior only if the intermediates were padded with zeros (a
    band kernel that convolves its halo rows would differ at the borders of
    a non-zero-weight case; here the plain version is pinned by hand)."""
    c = 8
    xq = torch.zeros(1, 6, 6, c, dtype=torch.int8)
    kernels = torch.zeros(4, 3, 3, c, c, dtype=torch.int8)
    kernels[:, 1, 1] = torch.eye(c, dtype=torch.int8)  # identity convs
    xq[0, 0, 0] = 100
    ones = torch.ones(4, c)
    out = ib.fused_stage1_int8(xq, kernels, ones, torch.zeros(4, c),
                               torch.ones(5))
    # block 0: y1 = x, out = y1 + x = 2x → clipped to 127; block 1: 127 + 127
    want = torch.zeros_like(xq)
    want[0, 0, 0] = 127
    assert torch.equal(out, want)


def test_band_rows_fit_shared_memory():
    """The cluster plan: blocks per image and rows per block, within a
    block's shared memory (three slabs of rows + 2 rows of W + 2 pixels at 80
    bytes, a table of rows · W offsets, two weight images of 36,864 bytes)."""
    assert ib.cluster_plan(56, 56) == (8, 7)
    assert ib.cluster_plan(30, 26) == (4, 8)
    assert ib.cluster_plan(6, 6) == (1, 6)
    assert ib.cluster_plan(9, 7) == (2, 5)
    assert ib.cluster_plan(56, 64) == (8, 7)
    assert ib.MAX_WIDTH == 217
    for height, width in ((56, 56), (56, 64), (8, ib.MAX_WIDTH), (30, 100)):
        cluster, rows = ib.cluster_plan(height, width)
        assert cluster in (1, 2, 4, 8) and cluster * rows >= height
        assert cluster * rows - height < rows or cluster == 1
        assert (3 * (rows + 2) * (width + 2) * 80 + 4 * rows * width
                + 2 * 36864 <= 232448)
    with pytest.raises(ValueError, match="217"):
        ib.cluster_plan(8, ib.MAX_WIDTH + 1)
    with pytest.raises(ValueError, match="112 × 112"):
        ib.cluster_plan(112, 112)


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_stage1_kernels_image_unpacks_exactly(seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(-127, 128, (4, 3, 3, 64, 64)).astype(np.int8)
    packed = ib.pack_stage1_kernels(torch.from_numpy(k))
    assert packed.shape == (4, 36864) and packed.is_contiguous()
    at = _image_offsets(64, 64, 3, 3, 64)
    assert np.array_equal(np.sort(at.reshape(-1)), np.arange(36864))
    for conv in range(4):
        # HWIO → [o][ky][kx][ci]
        np.testing.assert_array_equal(packed[conv].numpy()[at],
                                      k[conv].transpose(3, 0, 1, 2))
    with pytest.raises(ValueError, match="64"):
        ib.pack_stage1_kernels(torch.zeros(4, 3, 3, 8, 8, dtype=torch.int8))


# ---------------------------------------------------------------------------
# (3) quantization
# ---------------------------------------------------------------------------


def _randomized_variables(jax, seed, num_filters=8, fc=True):
    """flax init of a ResNet18, then every BN scale, bias, mean and variance
    drawn from numpy, so that each folded tensor matters."""
    from ss25_hierarchical_multiscale_image_classification_tpu.models import (
        resnet,
    )

    jnp = jax.numpy
    cls = resnet.ResNet18Classifier if fc else resnet.ResNet18FeatureExtractor
    model = cls(dtype=jnp.float32, num_filters=num_filters)
    variables = model.init(jax.random.key(seed), jnp.zeros((1, 32, 32, 3)),
                           train=False)
    rng = np.random.default_rng(seed)
    draw = {"scale": lambda s: rng.uniform(0.5, 1.5, s),
            "bias": lambda s: rng.normal(0.0, 0.1, s),
            "mean": lambda s: rng.normal(0.0, 0.5, s),
            "var": lambda s: rng.uniform(0.5, 2.0, s)}

    def walk(tree, in_norm):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, in_norm or "norm" in k.lower()
                              or k.startswith("BatchNorm"))
            elif in_norm and k in draw:
                out[k] = draw[k](np.shape(v)).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return {"params": walk(variables["params"], False),
            "batch_stats": walk(variables["batch_stats"], True)}


@pytest.fixture(scope="module")
def variables(jx):
    return _randomized_variables(jx.jax, 31)


@pytest.fixture(scope="module")
def state(variables):
    return state_dict_from_flax(variables)


@pytest.fixture(scope="module")
def calib():
    return [_u8(40, (4, 32, 32, 3)), _u8(41, (4, 32, 32, 3))]


def _np_tree(jq):
    """A JAX ``QuantizedResNet18.tree()`` as numpy arrays."""
    t = jq.tree()
    out = {f: {k: np.asarray(v) for k, v in t[f].items()}
           for f in ("qkernels", "wscales", "biases", "ascales")}
    out["fc"] = None if t["fc"] is None else tuple(np.asarray(a) for a in t["fc"])
    m = t["stem_bias_map"]
    out["stem_bias_map"] = None if m is None else np.asarray(m)
    return out


def test_quantize_weights_equal_jax(jx, variables, state):
    jqk, jws, jbs = jx.q._quantize_weights(jx.q.fold_batchnorm(variables))
    qk, ws, bs = q._quantize_weights(q.fold_batchnorm(state))
    assert set(qk) == set(jqk) and "fc" not in qk
    for name in jqk:
        want = np.asarray(jqk[name]).transpose(3, 2, 0, 1)  # HWIO → OIHW
        assert qk[name].dtype == torch.int8
        np.testing.assert_array_equal(qk[name].numpy(), want)
        np.testing.assert_array_equal(ws[name].numpy(), np.asarray(jws[name]))
        np.testing.assert_array_equal(bs[name].numpy(), np.asarray(jbs[name]))


QUANT_MODES = {
    "s2d_auto": {},
    "direct_7x7": {"stem_s2d": False},
    "unfolded_normalize": {"fold_stem_normalize": False},
}


@pytest.mark.parametrize("mode", QUANT_MODES)
def test_quantize_resnet18_matches_jax(jx, variables, state, calib, mode):
    kw = QUANT_MODES[mode]
    want = _np_tree(jx.q.quantize_resnet18(variables, calib, **kw))
    got = q.quantize_resnet18(state, calib, device="cpu", **kw).tree()
    for name, k in want["qkernels"].items():
        np.testing.assert_array_equal(got["qkernels"][name].numpy(),
                                      k.transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(got["wscales"][name].numpy(),
                                      want["wscales"][name])
        np.testing.assert_array_equal(got["biases"][name].numpy(),
                                      want["biases"][name])
    # calibration is a float32 forward in each framework
    assert set(got["ascales"]) == set(want["ascales"])
    for name, s in want["ascales"].items():
        np.testing.assert_allclose(got["ascales"][name].numpy(), s, rtol=1e-4)
    stem_rows = got["qkernels"]["stem"].shape[2]
    if mode == "unfolded_normalize":
        assert got["stem_bias_map"] is None and want["stem_bias_map"] is None
        assert stem_rows == 7
    else:
        # one float32 conv of a constant plane in each framework
        np.testing.assert_allclose(got["stem_bias_map"].numpy(),
                                   want["stem_bias_map"], rtol=1e-5, atol=1e-5)
        assert stem_rows == (4 if mode == "s2d_auto" else 7)  # auto-enabled
    np.testing.assert_array_equal(got["fc"][0].numpy(), want["fc"][0])


def test_quantize_folded_odd_input_and_errors(jx, state, calib):
    odd = [_u8(42, (2, 31, 31, 3))]
    tree = q.quantize_resnet18(state, odd, device="cpu").tree()
    assert tree["qkernels"]["stem"].shape[2] == 7  # no s2d at odd sizes
    assert tree["stem_bias_map"].shape[:2] == (16, 16)
    with pytest.raises(ValueError, match="fold_stem_normalize"):
        q.quantize_resnet18(state, calib, fold_stem_normalize=False,
                            stem_s2d=True, device="cpu")
    with pytest.raises(ValueError, match="at least one batch"):
        q.calibrate(q.fold_batchnorm(state), [], device="cpu")


# ---------------------------------------------------------------------------
# (4) quant_forward on a JAX tree carried across
# ---------------------------------------------------------------------------

# int8 forward against int8 forward: the same integers except where a value
# sat within an ulp of a rounding boundary; a flipped step moves a feature
# (a mean over the last plane) by a fraction of the last scale. Measured here:
# equal to the last bit at every mode and batch tried; the bound, 0.5 % of the
# largest output, leaves room for a few flipped steps on another XLA build.
FORWARD_RTOL = 5e-3


def _assert_forward_close(got, want):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=FORWARD_RTOL * scale, rtol=0)


@pytest.mark.parametrize("mode", QUANT_MODES)
@pytest.mark.parametrize("with_fc", [True, False])
def test_quant_forward_matches_jax(jx, variables, calib, mode, with_fc):
    jq = jx.q.quantize_resnet18(variables, calib, **QUANT_MODES[mode])
    qp = quantized_from_jax(_np_tree(jq))
    imgs = _u8(43, (3, 32, 32, 3))
    want = np.asarray(jx.q.quant_forward(jq.tree(), jx.jnp.asarray(imgs),
                                         with_fc=with_fc))
    got = q.quant_forward(qp, torch.from_numpy(imgs), with_fc=with_fc).numpy()
    assert got.shape == want.shape == (3, 2 if with_fc else 64)
    _assert_forward_close(got, want)


def test_quant_forward_pre_s2d_input_equals_on_device_s2d(jx, variables, calib):
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.patch_store import (
        space_to_depth_u8,
    )

    jq = jx.q.quantize_resnet18(variables, calib)
    qp = quantized_from_jax(_np_tree(jq))
    imgs = _u8(44, (2, 32, 32, 3))
    s2d = space_to_depth_u8(imgs)
    a = q.quant_forward(qp, torch.from_numpy(imgs))
    b = q.quant_forward(qp, torch.from_numpy(s2d))
    assert torch.equal(a, b)
    want = np.asarray(jx.q.quant_forward(jq.tree(), jx.jnp.asarray(s2d)))
    _assert_forward_close(b.numpy(), want)
    direct = quantized_from_jax(_np_tree(
        jx.q.quantize_resnet18(variables, calib, stem_s2d=False)))
    with pytest.raises(ValueError, match="s2d stem kernel"):
        q.quant_forward(direct, torch.from_numpy(s2d))


def test_quant_forward_fc_less_trunk(jx, calib):
    """A feature extractor's tree has no head: features either way (JAX
    ``tests/test_quantized.py``'s fc-less trunk)."""
    trunk = _randomized_variables(jx.jax, 32, fc=False)
    jq = jx.q.quantize_resnet18(trunk, calib)
    assert jq.fc is None
    qp = quantized_from_jax(_np_tree(jq))
    assert qp["fc"] is None
    imgs = _u8(45, (2, 32, 32, 3))
    want = np.asarray(jx.q.quant_forward(jq.tree(), jx.jnp.asarray(imgs)))
    got = q.quant_forward(qp, torch.from_numpy(imgs), with_fc=True).numpy()
    assert got.shape == (2, 64)
    _assert_forward_close(got, want)
    own = q.quantize_resnet18(strip_head(state_dict_from_flax(trunk)), calib,
                              device="cpu")
    assert own.fc is None
    assert own.features(torch.from_numpy(imgs)).shape == (2, 64)


def test_quantized_model_tracks_its_float_forward(state, calib):
    """The int8 forward approximates the float32 folded forward it was
    calibrated on (cosine of the features; the JAX package's own gate is
    0.98 on features, ``tests/test_quantized.py``)."""
    imgs = torch.from_numpy(_u8(46, (4, 32, 32, 3)))
    model = q.quantize_resnet18(state, calib + [imgs.numpy()], device="cpu")
    ref = q.folded_forward(q.fold_batchnorm(state), imgs, with_fc=False)
    got = model.features(imgs)
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=1)
    assert cos.min() > 0.98, cos
    assert model.forward(imgs).shape == (4, 2)


def test_quant_forward_refuses_float_batches(state, calib):
    model = q.quantize_resnet18(state, calib, device="cpu")
    with pytest.raises(ValueError, match="uint8"):
        model.forward(torch.zeros(1, 32, 32, 3))


def test_stage1_params_from_qtree_equal_jax(jx, variables, calib):
    jq = jx.q.quantize_resnet18(variables, calib)
    want = jx.ib.stage1_params_from_qtree(jq.tree())
    got = ib.stage1_params_from_qtree(quantized_from_jax(_np_tree(jq)))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# (5) the artifact, both directions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", QUANT_MODES)
def test_artifact_written_by_jax_loads_in_the_port(jx, variables, calib, mode,
                                                   tmp_path):
    jq = jx.q.quantize_resnet18(variables, calib, **QUANT_MODES[mode])
    path = jx.qa.save_quantized(str(tmp_path / "q"), jq.tree())
    assert path.endswith(".npz")
    tree = qa.load_quantized(str(tmp_path / "q"))
    carried = quantized_from_jax(_np_tree(jq))
    for field in ("qkernels", "wscales", "biases", "ascales"):
        assert set(tree[field]) == set(carried[field])
        for name in tree[field]:
            assert torch.equal(tree[field][name], carried[field][name])
    imgs = torch.from_numpy(_u8(47, (2, 32, 32, 3)))
    assert torch.equal(q.quant_forward(tree, imgs),
                       q.quant_forward(carried, imgs))
    hw = jx.qa.artifact_input_hw(jq.tree())
    assert qa.artifact_input_hw(tree) == hw
    assert hw == (None if mode == "unfolded_normalize" else (32, 32))


@pytest.mark.parametrize("mode", QUANT_MODES)
def test_artifact_written_by_the_port_loads_in_jax(jx, state, calib, mode,
                                                   tmp_path):
    model = q.quantize_resnet18(state, calib, device="cpu", **QUANT_MODES[mode])
    path = qa.save_quantized(str(tmp_path / "models" / "q.npz"), model.tree())
    jtree = jx.qa.load_quantized(path)
    assert all(np.shape(v) == () for v in jtree["ascales"].values())
    for name, k in model.qkernels.items():
        np.testing.assert_array_equal(np.asarray(jtree["qkernels"][name]),
                                      k.permute(2, 3, 1, 0).numpy())  # HWIO
    imgs = _u8(48, (2, 32, 32, 3))
    want = np.asarray(jx.q.quant_forward(jtree, jx.jnp.asarray(imgs)))
    _assert_forward_close(model.forward(torch.from_numpy(imgs)).numpy(), want)
    # and back: the port reads its own file to the same tree
    back = qa.load_quantized(path)
    assert torch.equal(q.quant_forward(back, torch.from_numpy(imgs)),
                       model.forward(torch.from_numpy(imgs)))
    assert qa.maybe_load_artifact(str(tmp_path / "models"), "q.npz") is not None
    assert qa.maybe_load_artifact(str(tmp_path), "q.npz") is None


# ---------------------------------------------------------------------------
# the CUDA kernels against the plain versions (on a card)
# ---------------------------------------------------------------------------


CUDA_CONV_CASES = [
    ("stem_s2d_map", (112, 112, 12), 64, 4, 1, ((2, 1), (2, 1)), "map"),
    ("stem_direct_map", (224, 224, 3), 64, 7, 2, 3, "map"),
    ("c1_stride2", (56, 56, 64), 128, 3, 2, 1, "relu"),
    ("down_1x1", (56, 56, 64), 128, 1, 2, 0, "f32"),
    ("c2_residual", (28, 28, 128), 128, 3, 1, 1, "res_f32"),
    ("c2_int8_residual", (7, 7, 512), 512, 3, 1, 1, "res_i8"),
    ("odd_plane", (9, 13, 64), 64, 3, 1, 1, "relu"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CONV_CASES,
                         ids=[c[0] for c in CUDA_CONV_CASES])
def test_int8_conv_cuda_kernel_is_exact(cuda_device, case):
    _check_conv_on_card(cuda_device, 5, case)


# what the tiling of the wgmma path can get wrong: a batch smaller than a
# tile at C_out = 128, planes whose pixels fill no tile of 64, a strided 1x1
# over an odd plane, two blocks of 128 channels over a strided 3x3, blocks
# of 64 channels at C_out = 192, and a kernel size whose taps the products'
# loop is not unrolled for
CUDA_TILING_CASES = [
    (1, ("cout128_batch1", (7, 7, 64), 128, 3, 1, 1, "relu")),
    (3, ("ragged_tiles", (10, 11, 128), 128, 3, 1, 1, "res_i8")),
    (2, ("down_odd_plane", (7, 9, 128), 256, 1, 2, 0, "f32")),
    (37, ("stride2_two_blocks", (14, 14, 128), 256, 3, 2, 1, "relu")),
    (2, ("cout192_blocks_of_64", (12, 12, 64), 192, 3, 1, 1, "res_f32")),
    (3, ("kernel_5x5", (9, 10, 64), 128, 5, 1, 2, "relu")),
]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,case", CUDA_TILING_CASES,
                         ids=[c[0] for _, c in CUDA_TILING_CASES])
def test_int8_conv_cuda_kernel_tilings_are_exact(cuda_device, batch, case):
    _check_conv_on_card(cuda_device, batch, case)


def _check_conv_on_card(cuda_device, batch, case):
    xq, hwio, mscale, bias, res, p = _conv_operands(7, batch, case)
    args, kw = _torch_conv_args(xq, hwio, mscale, bias, res, case[6])
    args = tuple(a.to(cuda_device) for a in args)
    args = (args[0], args[1].contiguous(memory_format=torch.channels_last),
            *args[2:])
    kw = {k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v
          for k, v in kw.items()}
    s = None if case[6] == "f32" else torch.tensor(3.0 / 127,
                                                   device=cuda_device)
    got = ic.int8_conv_requant_kernel(*args, s, case[4], p, **kw)
    torch.cuda.synchronize()
    want = ic.int8_conv_requant_reference(*args, s, case[4], p, **kw)
    assert torch.equal(got, want)
    cpu = ic.int8_conv_requant_reference(
        *(a.cpu() for a in args), None if s is None else s.cpu(), case[4], p,
        **{k: v.cpu() if isinstance(v, torch.Tensor) else v
           for k, v in kw.items()})
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 56, 56, 64), (2, 30, 26, 64),
                                   (1, 5, 113, 64), (1, 56, 56, 64),
                                   (2, 9, 7, 64), (3, 6, 6, 64),
                                   (1, 56, 64, 64), (2, 33, 20, 64)])
def test_fused_stage1_cuda_kernel_is_exact(cuda_device, shape):
    ops = _stage1_operands(9, shape)
    xq, kernels, _, mscales, biases, scalars = (
        torch.from_numpy(a).to(cuda_device) for a in ops)
    before = ib.fused_stage1_int8_kernel.launches
    got = ib.fused_stage1_int8(xq, kernels, mscales, biases, scalars)
    torch.cuda.synchronize()
    assert ib.fused_stage1_int8_kernel.launches == before + 1
    want = ib.fused_stage1_int8_reference(xq, kernels, mscales, biases, scalars)
    assert torch.equal(got, want)
    cpu = ib.fused_stage1_int8_reference(xq.cpu(), kernels.cpu(), mscales.cpu(),
                                         biases.cpu(), scalars.cpu())
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 112, 112, 64), (2, 31, 27, 16)])
def test_int8_maxpool_cuda_kernel_is_exact(cuda_device, shape):
    x = torch.from_numpy(np.random.default_rng(8).integers(
        -128, 128, shape).astype(np.int8)).to(cuda_device)
    got = ip.int8_maxpool(x)
    torch.cuda.synchronize()
    assert torch.equal(got, ip.int8_maxpool_reference(x))
    assert torch.equal(got.cpu(), ip.int8_maxpool_reference(x.cpu()))


@pytest.mark.cuda
def test_requant_ties_and_clipping_on_the_card(cuda_device):
    """Quotients that land exactly on half-integers, next to them, and far
    outside the int8 range: where the kernel's guarded reciprocal must take
    the exact quotient."""
    rng = np.random.default_rng(11)
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 9, 9, 64)).astype(np.int8))
    k = torch.zeros(64, 64, 1, 1, dtype=torch.int8)
    k[torch.arange(64), torch.arange(64), 0, 0] = 1  # identity 1x1 conv
    k = k.contiguous(memory_format=torch.channels_last)
    bias = torch.zeros(64)
    for mscale, s_out in ((0.5, 1.0), (0.125, 0.25), (1.5, 3.0), (0.1, 0.2),
                          (1.0, 1e-3), (3.0, 2.0 + 2.0 ** -22)):
        args = (xq.to(cuda_device), k.to(cuda_device).contiguous(
                    memory_format=torch.channels_last),
                torch.full((64,), mscale, device=cuda_device),
                bias.to(cuda_device), torch.tensor(s_out, device=cuda_device))
        got = ic.int8_conv_requant_kernel(*args, 1, 0, relu=False)
        torch.cuda.synchronize()
        want = ic.int8_conv_requant_reference(*args, 1, 0, relu=False)
        assert torch.equal(got, want), (mscale, s_out)
        # the same values twice over 128 channels: the wider block's staged
        # 16-byte stores
        wide = (args[0], torch.cat([args[1], args[1]]).contiguous(
                    memory_format=torch.channels_last),
                args[2].repeat(2), args[3].repeat(2), args[4])
        got = ic.int8_conv_requant_kernel(*wide, 1, 0, relu=False)
        torch.cuda.synchronize()
        assert torch.equal(got, torch.cat([want, want], dim=3)), (mscale, s_out)


@pytest.mark.cuda
def test_quant_forward_cuda_matches_cpu_and_counts_launches(cuda_device):
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
        ResNet18Classifier,
    )

    g = torch.Generator().manual_seed(0)
    sd = ResNet18Classifier(num_classes=2, generator=g).state_dict()
    calib = [_u8(50, (4, 64, 64, 3))]
    imgs = torch.from_numpy(_u8(51, (3, 64, 64, 3)))
    for kw in QUANT_MODES.values():
        tree = q.quantize_resnet18(sd, calib, device="cpu", **kw).tree()
        card = q.quantized_to(tree, cuda_device)
        c0 = ic.int8_conv_requant_kernel.launches
        b0 = ib.fused_stage1_int8_kernel.launches
        p0 = ip.int8_maxpool_kernel.launches
        got = q.quant_forward(card, imgs.to(cuda_device), with_fc=False)
        torch.cuda.synchronize()
        assert ic.int8_conv_requant_kernel.launches == c0 + 16
        assert ib.fused_stage1_int8_kernel.launches == b0 + 1
        assert ip.int8_maxpool_kernel.launches == p0 + 1
        want = q.quant_forward(tree, imgs, with_fc=False)
        # the convs are exact; the mean over the last plane may sum in
        # another order: a few float32 ulps of the features
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)
