"""Port preprocessing against the JAX package: ``fused_normalize``,
``normalize`` and ``resize``.

On the CPU the port's ``fused_normalize`` is its plain PyTorch version; it is
held against the JAX Pallas kernel run in interpret mode, as the JAX
package's own ``tests/test_ops.py`` runs it. The CUDA kernel itself is held
against that plain version by ``test_fused_normalize_cuda_kernel_is_exact``,
which needs the card (marker ``cuda``) and skips elsewhere. JAX is imported
inside the tests that compare with it, so the ``cuda`` test also runs where
jax is absent (``python -m pytest --noconftest -m cuda ...``).
"""

import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
    normalize,
    resize,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.preprocess import (
    fused_normalize,
    fused_normalize_reference,
)

torch.set_num_threads(2)


def _imgs(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("batch,block_b", [(8, 4), (5, 5)])
def test_fused_normalize_matches_jax_kernel(batch, block_b):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from ss25_hierarchical_multiscale_image_classification_tpu.ops.pallas.preprocess import (
        fused_normalize as jax_fused_normalize,
    )

    imgs = _imgs(batch, (batch, 32, 32, 3))
    j_out, j_means = jax_fused_normalize(jnp.asarray(imgs), dtype=jnp.float32,
                                         block_b=block_b)
    out, means = fused_normalize(torch.from_numpy(imgs), torch.float32)
    assert out.shape == (batch, 32, 32, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=1e-5,
                               atol=1e-5)
    # the port sums exactly; JAX sums in float32 (exact below 2^24)
    np.testing.assert_allclose(means.numpy(), np.asarray(j_means), rtol=1e-6)

    out16, means16 = fused_normalize(torch.from_numpy(imgs), torch.bfloat16)
    assert out16.dtype == torch.bfloat16
    assert torch.equal(out16, out.to(torch.bfloat16))
    assert torch.equal(means16, means)


def test_normalize_matches_jax():
    jax = pytest.importorskip("jax")
    from ss25_hierarchical_multiscale_image_classification_tpu.data.augment import (
        normalize as jax_normalize,
    )

    imgs = _imgs(11, (3, 40, 24, 3))
    ref = np.asarray(jax_normalize(jax.numpy.asarray(imgs)))
    np.testing.assert_allclose(normalize(torch.from_numpy(imgs)).numpy(), ref,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("src,dst", [(128, 64), (32, 64)])
def test_resize_matches_jax_image_resize(src, dst):
    jax = pytest.importorskip("jax")
    x = np.random.default_rng(src).normal(size=(2, src, src, 3)).astype(np.float32)
    ref = jax.image.resize(jax.numpy.asarray(x), (2, dst, dst, 3),
                           method="bilinear")
    out = resize(torch.from_numpy(x), dst)
    assert out.shape == (2, dst, dst, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_fused_normalize_rejects_bad_input_and_counts_no_cpu_launch():
    before = fused_normalize.launches
    ok = torch.from_numpy(_imgs(0, (2, 8, 8, 3)))
    fused_normalize(ok, torch.float32)
    assert fused_normalize.launches == before  # the CPU takes the plain version
    with pytest.raises(ValueError):
        fused_normalize(ok.float(), torch.float32)
    with pytest.raises(ValueError):
        fused_normalize(ok[..., :2], torch.float32)
    with pytest.raises(ValueError):
        fused_normalize(ok[:0], torch.float32)
    with pytest.raises(ValueError):
        fused_normalize(ok, torch.float16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(512, 224, 224, 3), (37, 224, 224, 3),
                                   (5, 7, 13, 3)])
def test_fused_normalize_cuda_kernel_is_exact(cuda_device, shape, dtype):
    imgs = torch.from_numpy(_imgs(1, shape)).to(cuda_device)
    before = fused_normalize.launches
    out, means = fused_normalize(imgs, dtype)
    torch.cuda.synchronize()
    assert fused_normalize.launches == before + 1
    ref_out, ref_means = fused_normalize_reference(imgs, dtype)
    assert out.dtype == dtype and out.shape == shape
    assert torch.equal(out, ref_out)
    assert torch.equal(means, ref_means)
