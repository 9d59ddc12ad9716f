"""The port's inference folds (``models/quantized.py``) against the JAX
package's.

One flax ResNet18 (narrow: ``num_filters=8``) with randomized BatchNorm
affines and statistics goes to the port through ``state_dict_from_flax``;
the same numpy uint8 batches go through the JAX ``fold_*`` and
``folded_forward*`` functions and the port's, in float32 on the CPU, where
the port's stem kernels are their plain versions. The folds themselves are
numpy float64 on both sides and must agree exactly after the HWIO → OIHW
transpose. The ``cuda``-marked test holds the card's forward, stem kernels
included, against the CPU's. JAX is imported inside the fixtures and tests
that compare with it, so the ``cuda`` test also runs where jax is absent
(``python -m pytest --noconftest -m cuda ...``).
"""

import types

import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
    normalize,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models import (
    quantized as q,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    folded_from_jax,
    resnet18_from_state_dict,
    state_dict_from_flax,
    strip_head,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
    ResNet18Classifier,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops import (
    fused_stem as fs,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jx():
    """jax, jax.numpy and the JAX package's ``models/quantized.py``."""
    jax = pytest.importorskip("jax")
    from ss25_hierarchical_multiscale_image_classification_tpu.models import (
        quantized,
    )

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, q=quantized)


def _randomized_variables(jax, seed, num_filters=8):
    """flax init of a ResNet18 classifier, then every BN scale, bias, mean
    and variance drawn from numpy, so that each folded tensor matters."""
    from ss25_hierarchical_multiscale_image_classification_tpu.models.resnet import (
        ResNet18Classifier as JaxResNet18Classifier,
    )

    jnp = jax.numpy
    model = JaxResNet18Classifier(dtype=jnp.float32, num_filters=num_filters)
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
    return _randomized_variables(jx.jax, 21)


@pytest.fixture(scope="module")
def state(variables):
    return state_dict_from_flax(variables)


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _oihw(k):
    return np.asarray(k, np.float32).transpose(3, 2, 0, 1)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# the folds (exact)
# ---------------------------------------------------------------------------


def test_fold_batchnorm_equals_jax(jx, variables, state):
    jfolded = jx.q.fold_batchnorm(variables)
    folded = q.fold_batchnorm(state)
    assert list(folded) == list(jfolded)
    assert "s2b0down" in folded and "s1b0down" not in folded
    for name, (jk, jb) in jfolded.items():
        k, b = folded[name]
        assert k.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(k, jk if name == "fc" else _oihw(jk))
        np.testing.assert_array_equal(b, jb)
    assert "fc" not in q.fold_batchnorm(strip_head(state))


@pytest.mark.parametrize("hw", [(64, 64), (96, 64)])
def test_stem_bias_map_matches_jax_including_the_borders(jx, variables, state,
                                                         hw):
    jfolded = jx.q.fold_batchnorm(variables)
    ja = np.asarray(jx.q._fold_normalize_into_stem(jfolded, hw))
    folded = q.fold_batchnorm(state)
    a = q._fold_normalize_into_stem(folded, hw)
    assert a.shape == ja.shape == (hw[0] // 2, hw[1] // 2, 8)
    np.testing.assert_array_equal(folded["stem"][0], _oihw(jfolded["stem"][0]))
    tol = 1e-5 * np.abs(ja).max()
    np.testing.assert_allclose(a, ja, rtol=0, atol=tol)
    # the first two and the last border cells see fewer taps than the
    # interior: a per-channel constant would be wrong there
    interior = a[5, 5]
    np.testing.assert_allclose(a[2:-1, 2:-1], np.broadcast_to(
        interior, a[2:-1, 2:-1].shape), rtol=0, atol=tol)
    for border in (a[0, 5], a[1, 5], a[5, 0], a[5, 1], a[-1, 5], a[5, -1],
                   a[0, 0]):
        assert np.abs(border - interior).max() > 100 * tol


def test_stem_kernel_s2d_equals_jax(jx):
    k = np.random.default_rng(22).normal(size=(7, 7, 3, 8)).astype(np.float32)
    np.testing.assert_array_equal(q._stem_kernel_s2d(k),
                                  jx.q._stem_kernel_s2d(k))


@pytest.mark.parametrize("stem_s2d", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_resnet18_inference_tree_equals_jax(jx, variables, state,
                                                 stem_s2d, dtype):
    jdtype = jx.jnp.float32 if dtype == torch.float32 else jx.jnp.bfloat16
    jfp = jx.q.fold_resnet18_inference(variables, (64, 64), stem_s2d, jdtype)
    fp = q.fold_resnet18_inference(state, (64, 64), stem_s2d, dtype)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    assert fp["kernels"].keys() == jfp["kernels"].keys()
    for name, jk in jfp["kernels"].items():
        k = fp["kernels"][name]
        assert k.dtype == dtype
        assert k.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(k.float().numpy(), _oihw(jk))
        np.testing.assert_array_equal(fp["biases"][name].float().numpy(),
                                      f32(jfp["biases"][name]))
    np.testing.assert_array_equal(fp["fc"][0].float().numpy(), f32(jfp["fc"][0]))
    np.testing.assert_array_equal(fp["fc"][1].numpy(), f32(jfp["fc"][1]))
    assert fp["fc"][1].dtype == torch.float32
    jmap = f32(jfp["stem_bias_map"])
    got = fp["stem_bias_map"].float().numpy()
    # float32 convs of the constant plane in two libraries, then one rounding
    np.testing.assert_allclose(
        got, jmap, rtol=0,
        atol=(1e-5 if dtype == torch.float32 else 2.0 ** -7) * np.abs(jmap).max())
    assert ("stem_w2" in fp) == stem_s2d
    if stem_s2d:
        assert fp["kernels"]["stem"].shape == (8, 12, 4, 4)
        jk = f32(jfp["kernels"]["stem"])  # (KY, KX, 12, O)
        np.testing.assert_array_equal(
            fp["stem_w2"].float().numpy(),
            jk.transpose(1, 0, 2, 3).reshape(4, 48, 8))
    with pytest.raises(ValueError):
        q.fold_resnet18_inference(state, (63, 64), True, dtype)


# ---------------------------------------------------------------------------
# the forwards
# ---------------------------------------------------------------------------


def test_folded_forward_matches_jax_and_collects(jx, variables, state):
    imgs = _u8(23, (3, 64, 64, 3))
    jout, jobs = jx.q.folded_forward(jx.q.fold_batchnorm(variables),
                                   jx.jnp.asarray(imgs), collect=True)
    out, obs = q.folded_forward(q.fold_batchnorm(state), torch.from_numpy(imgs),
                                collect=True)
    jout = np.asarray(jout)
    assert out.shape == (3, 2)
    np.testing.assert_allclose(out.numpy(), jout, rtol=0,
                               atol=1e-4 * np.abs(jout).max())
    assert obs.keys() == jobs.keys() and len(obs) == 18
    for name, v in jobs.items():
        np.testing.assert_allclose(obs[name].item(), float(v), rtol=1e-4)
    feats = q.folded_forward(q.fold_batchnorm(state), torch.from_numpy(imgs),
                             with_fc=False)
    assert feats.shape == (3, 64)


@pytest.mark.parametrize("with_fc", [True, False])
@pytest.mark.parametrize("stem_s2d", [False, True])
@pytest.mark.parametrize("hw", [(64, 64), (96, 64)])
def test_folded_forward_inference_float32_matches_jax(jx, variables, state, hw,
                                                      stem_s2d, with_fc):
    imgs = _u8(24, (3, *hw, 3))
    jfp = jx.q.fold_resnet18_inference(variables, hw, stem_s2d, jx.jnp.float32)
    ref = np.asarray(jx.q.folded_forward_inference(jfp, jx.jnp.asarray(imgs),
                                                 with_fc=with_fc))
    jfeats = np.asarray(jx.q.folded_forward_inference(jfp, jx.jnp.asarray(imgs),
                                                    with_fc=False))
    fp = q.fold_resnet18_inference(state, hw, stem_s2d, torch.float32)
    out = q.folded_forward_inference(fp, torch.from_numpy(imgs), with_fc=with_fc)
    assert out.dtype == torch.float32
    assert out.shape == ((3, 2) if with_fc else (3, 64))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(jfeats).max())


@pytest.mark.parametrize("stem_s2d", [False, True])
def test_folded_forward_inference_bfloat16_within_bound(jx, variables, state,
                                                        stem_s2d):
    """bfloat16 weights and activations through 17 convs: features within
    5 % of the largest float32 feature (measured ~1 %), and within the same
    bound of JAX's bfloat16 forward, whose roundings fall elsewhere (it
    rounds each conv before the bias, the port after)."""
    imgs = _u8(25, (4, 64, 64, 3))
    ref = q.folded_forward_inference(
        q.fold_resnet18_inference(state, (64, 64), stem_s2d, torch.float32),
        torch.from_numpy(imgs), with_fc=False)
    fp = q.fold_resnet18_inference(state, (64, 64), stem_s2d, torch.bfloat16)
    out = q.folded_forward_inference(fp, torch.from_numpy(imgs), with_fc=False)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    bound = 0.05 * ref.abs().max().item()
    assert (out - ref).abs().max().item() <= bound
    jfp = jx.q.fold_resnet18_inference(variables, (64, 64), stem_s2d, jx.jnp.bfloat16)
    jout = np.asarray(jx.q.folded_forward_inference(jfp, jx.jnp.asarray(imgs),
                                                  with_fc=False))
    assert np.abs(out.numpy() - jout).max() <= bound


def test_folded_forward_inference_matches_the_unfolded_model(state):
    imgs = torch.from_numpy(_u8(26, (3, 96, 64, 3)))
    model = resnet18_from_state_dict(state)
    with torch.no_grad():
        ref = model(normalize(imgs))
    for stem_s2d in (False, True):
        fp = q.fold_resnet18_inference(state, (96, 64), stem_s2d, torch.float32)
        out = q.folded_forward_inference(fp, imgs)
        assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    with pytest.raises(ValueError):
        q.folded_forward_inference(fp, imgs.float())


@pytest.mark.parametrize("stem_s2d", [False, True])
def test_folded_from_jax_carries_the_tree_across(jx, variables, state, stem_s2d):
    imgs = _u8(27, (2, 64, 64, 3))
    jfp = jx.q.fold_resnet18_inference(variables, (64, 64), stem_s2d, jx.jnp.float32)
    ref = np.asarray(jx.q.folded_forward_inference(jfp, jx.jnp.asarray(imgs)))
    fp = folded_from_jax(jfp)
    out = q.folded_forward_inference(fp, torch.from_numpy(imgs))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    own = q.fold_resnet18_inference(state, (64, 64), stem_s2d, torch.float32)
    assert fp.keys() == own.keys()
    for name, k in own["kernels"].items():
        assert torch.equal(fp["kernels"][name], k)
    if stem_s2d:
        assert torch.equal(fp["stem_w2"], own["stem_w2"])
    # bfloat16 arrays of JAX cross through float32, exactly
    jfp16 = jx.q.fold_resnet18_inference(variables, (64, 64), stem_s2d,
                                       jx.jnp.bfloat16)
    fp16 = folded_from_jax(jfp16, torch.bfloat16)
    own16 = q.fold_resnet18_inference(state, (64, 64), stem_s2d, torch.bfloat16)
    assert all(torch.equal(fp16["kernels"][n], k)
               for n, k in own16["kernels"].items())


def test_strip_head_drops_only_the_head(state):
    trunk = strip_head(state)
    assert set(state) - set(trunk) == {"fc.weight", "fc.bias"}
    fp = q.fold_resnet18_inference(trunk, (64, 64), False, torch.float32)
    assert fp["fc"] is None
    out = q.folded_forward_inference(fp, torch.from_numpy(_u8(28, (2, 64, 64, 3))))
    assert out.shape == (2, 64)  # no head: the features, with_fc or not


def test_stem_input_is_a_channels_last_view_and_launches_nothing_on_cpu(state):
    """``t.permute(0, 3, 1, 2)`` of the NHWC batch is channels_last in memory
    already, so the stem conv reads it without a copy; and on CPU tensors no
    kernel launch is counted."""
    t = torch.from_numpy(_u8(29, (2, 64, 64, 3))).to(torch.bfloat16) - 128
    view = t.permute(0, 3, 1, 2)
    assert view.is_contiguous(memory_format=torch.channels_last)
    assert view.data_ptr() == t.data_ptr()
    before = (fs.bias_relu_pool_kernel.launches, fs.fused_stem_kernel.launches)
    for stem_s2d in (False, True):
        fp = q.fold_resnet18_inference(state, (64, 64), stem_s2d, torch.float32)
        q.folded_forward_inference(fp, torch.from_numpy(_u8(29, (2, 64, 64, 3))))
    assert (fs.bias_relu_pool_kernel.launches,
            fs.fused_stem_kernel.launches) == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("stem_s2d", [False, True])
def test_folded_forward_inference_on_the_card_runs_the_stem_kernel(
        cuda_device, stem_s2d):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(30)
    model = ResNet18Classifier(num_filters=64, generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
                m.running_mean.normal_(0.0, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    state = model.state_dict()
    imgs = torch.from_numpy(_u8(31, (5, 224, 224, 3)))
    fp = q.fold_resnet18_inference(state, (224, 224), stem_s2d, torch.float32)
    ref = q.folded_forward_inference(fp, imgs, with_fc=False)
    kernel = fs.fused_stem_kernel if stem_s2d else fs.bias_relu_pool_kernel
    before = kernel.launches
    out = q.folded_forward_inference(q.folded_to(fp, cuda_device),
                                     imgs.to(cuda_device), with_fc=False)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert out.device.type == "cuda" and out.shape == (5, 512)
    assert (out.cpu() - ref).abs().max().item() <= 1e-3 * ref.abs().max().item()
    fp16 = q.folded_to(
        q.fold_resnet18_inference(state, (224, 224), stem_s2d, torch.bfloat16),
        cuda_device)
    out16 = q.folded_forward_inference(fp16, imgs.to(cuda_device), with_fc=False)
    assert (out16.cpu() - ref).abs().max().item() <= 0.05 * ref.abs().max().item()
