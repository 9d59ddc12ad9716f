"""The port's training augmentation against the JAX package's.

``data/augment.py::augment_batch`` (the plain version) is held to the JAX
function given the same parameter dict (the frameworks' generators give
different bits, so the draws are made once and handed to both): over all
sixteen (hflip, vflip, k) draws and the edges of the jitter ranges it is
equal, bit for bit. The D4 tables are equal; the per-example oracle agrees
with the batched path within bfloat16; the port's own draws are held by
their distributions. The CUDA kernels (``ops/augment.py``) are held against
the plain version by ``test_augment_cuda_kernel_is_exact`` (marker
``cuda``), which skips without a card; JAX is imported inside the tests
that compare with it, so that test also runs where jax is absent.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
    augment,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.augment import (
    CLUSTER,
    MAX_SIZE,
    augment_batch_kernel,
    band_pitch,
    band_rows,
)

torch.set_num_threads(2)

#: jitter factors at the edges of the training ranges (brightness, contrast
#: and saturation 0.8 and 1.2, hue ±0.1)
EDGES = (0.8, 1.2)


def _params(b, seed, edges=False, geometry=None):
    """A parameter dict as numpy arrays: every (h, v, k) in turn (or the
    given ones), factors uniform in the ranges or at their edges."""
    rng = np.random.default_rng(seed)
    combos = [(h, v, k) for h in (0, 1) for v in (0, 1) for k in range(4)]
    if geometry is None:
        geometry = [combos[i % 16] for i in range(b)]
    h, v, k = (np.array(x) for x in zip(*geometry))

    def factor(lo, hi):
        if edges:
            return rng.choice([lo, hi], b).astype(np.float32)
        return rng.uniform(lo, hi, b).astype(np.float32)

    return {"h": h.astype(bool), "v": v.astype(bool), "k": k.astype(np.int32),
            "fb": factor(*EDGES), "fc": factor(*EDGES), "fs": factor(*EDGES),
            "fh": factor(-0.1, 0.1)}


def _torch_params(p, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in p.items()}


def _imgs(seed, shape, extremes=False):
    imgs = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    if extremes:  # the clip bites: an all-black and an all-white image
        imgs[0] = 0
        imgs[1] = 255
    return imgs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def test_d4_tables_equal_jax():
    pytest.importorskip("jax")
    from ss25_hierarchical_multiscale_image_classification_tpu.data import (
        augment as jaug,
    )

    for mine, theirs in ((augment._D4_T, jaug._D4_T),
                         (augment._D4_FX, jaug._D4_FX),
                         (augment._D4_FY, jaug._D4_FY)):
        np.testing.assert_array_equal(mine, theirs)
        assert mine.dtype == theirs.dtype


# One bfloat16 step of c in [0.5, 1] is 2^-8, i.e. 2^-8·255/(255·0.224) =
# 0.0175 of the output; at most two such steps where the port's float32
# affine or mean differs from JAX's by an ulp and a rounding lands across.
# Measured: 0 differing elements in every case here (exactly equal).
MAX_STEP = 0.035
MAX_SHARE = 1e-3  # of the elements


@pytest.mark.parametrize("size,batch,seed,edges,extremes", [
    (32, 16, 0, False, False),   # all 16 (h, v, k) draws
    (32, 16, 1, True, True),     # range edges; black and white images
    (64, 16, 2, True, False),
    (48, 5, 3, False, True),
    (7, 16, 4, True, False),     # an odd size
    (224, 2, 5, True, True),     # the path's size, exact-integer mean
])
def test_augment_batch_matches_jax(size, batch, seed, edges, extremes):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from ss25_hierarchical_multiscale_image_classification_tpu.data import (
        augment as jaug,
    )

    p = _params(batch, seed, edges)
    imgs = _imgs(seed, (batch, size, size, 3), extremes)
    want = np.asarray(jaug.augment_batch({k: jnp.asarray(v) for k, v in p.items()},
                                         jnp.asarray(imgs)))
    got = augment.augment_batch(_torch_params(p), torch.from_numpy(imgs))
    assert got.dtype == torch.float32 and got.shape == imgs.shape
    d = np.abs(got.numpy() - want)
    assert d.max() <= MAX_STEP
    assert (d > 0).mean() <= MAX_SHARE


def test_augment_batch_clip_and_range():
    p = _params(16, 7, edges=True)
    # the white image (index 1) brightened by 1.2, no other jitter: clipped
    # to 1 everywhere
    for key, value in (("fb", 1.2), ("fc", 1.0), ("fs", 1.0), ("fh", 0.0)):
        p[key][1] = value
    imgs = _imgs(7, (16, 16, 16, 3), extremes=True)
    out = augment.augment_batch(_torch_params(p), torch.from_numpy(imgs))
    mean = np.asarray(augment.MEAN_255, np.float32)
    std = np.asarray(augment.STD_255, np.float32)
    lo, hi = (0.0 - mean) / std, (255.0 - mean) / std
    o = out.numpy()
    assert (o >= lo - 1e-6).all() and (o <= hi + 1e-6).all()
    np.testing.assert_allclose(o[1], np.broadcast_to(hi, o[1].shape),
                               rtol=1e-6)


def test_augment_batch_is_the_d4_map_of_the_images():
    """With identity colour draws the output is the normalized image under
    its D4 element, as numpy's flips and rot90 give it."""
    b = 16
    p = _params(b, 8)
    p.update(fb=np.ones(b, np.float32), fc=np.ones(b, np.float32),
             fs=np.ones(b, np.float32), fh=np.zeros(b, np.float32))
    imgs = _imgs(8, (b, 12, 12, 3))
    out = augment.augment_batch(_torch_params(p), torch.from_numpy(imgs))
    ref = augment.augment_batch(
        _torch_params({**p, "h": np.zeros(b, bool), "v": np.zeros(b, bool),
                       "k": np.zeros(b, np.int32)}),
        torch.from_numpy(np.stack([
            np.rot90(imgs[i][::-1] if p["v"][i] else imgs[i], p["k"][i])
            if not p["h"][i] else
            np.rot90((imgs[i][:, ::-1])[::-1] if p["v"][i]
                     else imgs[i][:, ::-1], p["k"][i])
            for i in range(b)]).copy()))
    assert torch.equal(out, ref)


def test_augment_one_with_params_agrees_with_the_batch():
    """The per-example op chain against the batched path, within bfloat16
    (the JAX package holds its own pair at 0.15 of the output)."""
    b = 16
    p = _params(b, 9)
    imgs = _imgs(9, (b, 32, 32, 3))
    fused = augment.augment_batch(_torch_params(p), torch.from_numpy(imgs))
    mean = np.asarray(augment.MEAN_255)
    std = np.asarray(augment.STD_255)
    for i in range(b):
        ref = augment._augment_one_with_params(
            torch.from_numpy(imgs[i]), p["h"][i], p["v"][i], p["k"][i],
            p["fb"][i], p["fc"][i], p["fs"][i], p["fh"][i])
        ref = (ref.float().numpy() * 255.0 - mean) / std
        np.testing.assert_allclose(fused[i].numpy(), ref, atol=0.15)


def test_augment_one_with_params_matches_jax_oracle():
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from ss25_hierarchical_multiscale_image_classification_tpu.data import (
        augment as jaug,
    )

    p = _params(4, 10)
    imgs = _imgs(10, (4, 24, 24, 3))
    for i in range(4):
        args = [p[k][i] for k in ("h", "v", "k", "fb", "fc", "fs", "fh")]
        want = np.asarray(jaug._augment_one_with_params(
            jnp.asarray(imgs[i]), *[jnp.asarray(a) for a in args]), np.float32)
        got = augment._augment_one_with_params(torch.from_numpy(imgs[i]),
                                               *args).float().numpy()
        # both chains round ~20 times to bfloat16 and reduce the contrast
        # and saturation means in other orders, so a rounding that lands
        # across a step carries on: measured up to 0.0234 (six steps of
        # 2^-8) over seeds 10-15, in [0, 1]
        np.testing.assert_allclose(got, want, atol=2 ** -4)


def test_sample_augment_params_distributions():
    g = torch.Generator().manual_seed(0)
    n = 40000
    p = augment.sample_augment_params(g, n)
    assert set(p) == {"h", "v", "k", "fb", "fc", "fs", "fh"}
    assert p["h"].dtype == torch.bool and p["v"].dtype == torch.bool
    for key in ("h", "v"):
        assert abs(p[key].float().mean().item() - 0.5) < 0.01
    counts = torch.bincount(p["k"], minlength=4).numpy() / n
    assert p["k"].min() >= 0 and p["k"].max() <= 3
    np.testing.assert_allclose(counts, 0.25, atol=0.01)
    for key, (lo, hi) in (("fb", EDGES), ("fc", EDGES), ("fs", EDGES),
                          ("fh", (-0.1, 0.1))):
        x = p[key].numpy()
        assert x.dtype == np.float32 and x.min() >= lo and x.max() <= hi
        assert abs(x.mean() - (lo + hi) / 2) < 0.005 * (hi - lo) * 4
        assert abs(x.std() - (hi - lo) / np.sqrt(12)) < 0.01 * (hi - lo)
    # the JAX draws' ranges, from the same arguments
    q = augment.sample_augment_params(g, 1000, brightness=1.5, hue=0.3)
    assert q["fb"].min() >= 0.0 and q["fb"].max() <= 2.5
    assert q["fh"].abs().max() <= 0.3
    # independent draws from one generator
    assert not torch.equal(p["fb"], p["fc"])


def test_preprocess_batch_train_and_eval():
    imgs = torch.from_numpy(_imgs(11, (6, 16, 16, 3)))
    out = augment.preprocess_batch(None, imgs, training=False)
    assert torch.equal(out, augment.normalize(imgs))
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    a = augment.preprocess_batch(g1, imgs, training=True)
    b = augment.augment_batch(augment.sample_augment_params(g2, 6), imgs)
    assert torch.equal(a, b)
    assert a.dtype == torch.float32 and a.shape == imgs.shape


def test_augment_kernel_wrapper_cpu_route_and_checks():
    p = _torch_params(_params(4, 12))
    imgs = torch.from_numpy(_imgs(12, (4, 8, 8, 3)))
    before = augment_batch_kernel.launches
    assert torch.equal(augment_batch_kernel(p, imgs),
                       augment.augment_batch(p, imgs))
    assert augment_batch_kernel.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError):
        augment_batch_kernel(p, imgs.float())
    with pytest.raises(ValueError):
        augment_batch_kernel(p, imgs[:, :, :6])  # not square
    with pytest.raises(ValueError):
        augment_batch_kernel({**p, "fb": p["fb"][:3]}, imgs)
    with pytest.raises(ValueError):
        augment.augment_batch(p, imgs[:, :, :6])


def test_d4_table_packed_for_the_kernel():
    """The kernel looks an image's D4 element up from its draws in a packed
    table: 3 bits at 3·(8h + 4v + k)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.augment import (
        D4_PACKED,
    )

    assert 0 <= D4_PACKED < 2 ** 48
    for h in range(2):
        for v in range(2):
            for k in range(4):
                code = (D4_PACKED >> (3 * (8 * h + 4 * v + k))) & 7
                assert code == (augment._D4_T[h, v, k] + 2 * augment._D4_FX[h, v, k]
                                + 4 * augment._D4_FY[h, v, k])
    # each of the 8 elements of D4 is reached
    assert len({(D4_PACKED >> (3 * e)) & 7 for e in range(16)}) == 8


def _cases():
    combos = [(h, v, k) for h in (0, 1) for v in (0, 1) for k in range(4)]
    return [
        (512, 224, None, False, False),
        (37, 224, None, True, True),
        (16, 7, None, True, True),
        (8, 448, None, True, True),
        # each D4 element forced on a whole batch
        *[(8, 33, [combos[i]] * 8, True, True) for i in range(0, 16, 2)],
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,size,geometry,edges,extremes", _cases())
def test_augment_cuda_kernel_is_exact(cuda_device, batch, size, geometry,
                                      edges, extremes):
    p = _torch_params(_params(batch, size, edges, geometry), cuda_device)
    imgs = torch.from_numpy(_imgs(size, (batch, size, size, 3), extremes)
                            ).to(cuda_device)
    before = augment_batch_kernel.launches
    out = augment_batch_kernel(p, imgs)
    torch.cuda.synchronize()
    assert augment_batch_kernel.launches == before + 1
    ref = augment.augment_batch(p, imgs)
    assert out.dtype == torch.float32 and out.shape == imgs.shape
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_augment_cuda_size_limit_matches(cuda_device):
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        load_library,
    )

    assert load_library().hipac_augment_max_size() == MAX_SIZE
    s = MAX_SIZE + 1
    p = {k: v.to(cuda_device) for k, v in _torch_params(_params(1, 13)).items()}
    imgs = torch.zeros((1, s, s, 3), dtype=torch.uint8, device=cuda_device)
    before = augment_batch_kernel.launches
    with pytest.raises(ValueError, match=str(MAX_SIZE)):
        augment_batch_kernel(p, imgs)
    assert augment_batch_kernel.launches == before


# ---- the affine split into the matrix and the in-kernel bias ----


def _affine_before_split(params, m0, dtype=torch.bfloat16):
    """The affine as ``augment_batch`` rounded it before the split: both
    halves of ``_jitter_affine`` to ``dtype``, contiguous."""
    m, bias = augment._jitter_affine(params, m0)
    return m.to(dtype).contiguous(), bias.to(dtype).contiguous()


def _augment_batch_before_split(params, imgs_u8, dtype=torch.bfloat16):
    """``augment_batch`` as it was before the split, kept to hold the
    current one to it bit for bit."""
    b = imgs_u8.shape[0]
    t, fx, fy = augment.d4_flags(params)
    x = imgs_u8
    x = torch.where(t[:, None, None, None], x.transpose(1, 2), x)
    x = torch.where(fx[:, None, None, None], x.flip(2), x)
    x = torch.where(fy[:, None, None, None], x.flip(1), x)
    sums = imgs_u8.reshape(b, -1).sum(dim=1, dtype=torch.int64)
    m0 = augment.augment_means(sums, imgs_u8[0].numel())
    md, biasd = _affine_before_split(params, m0, dtype)
    xd = x.to(dtype) * torch.full((), 1.0 / 255.0, dtype=dtype)
    r, g, b3 = xd[..., 0], xd[..., 1], xd[..., 2]
    mean, std = augment._affine(x.device)

    def chan(d):
        c = (md[:, d, 0, None, None] * r + md[:, d, 1, None, None] * g
             + md[:, d, 2, None, None] * b3 + biasd[:, None, None])
        c = torch.clamp(c, 0.0, 1.0).to(torch.float32)
        return (c * 255.0 - mean[d]) / std[d]

    return torch.stack([chan(0), chan(1), chan(2)], dim=-1)


@pytest.mark.parametrize("edges", [False, True])
def test_augment_matrix_and_bias_equal_the_affine(edges):
    n = 20000
    p = _torch_params(_params(n, 20 + edges, edges))
    sums = torch.from_numpy(np.random.default_rng(21).integers(
        0, 224 * 224 * 3 * 255 + 1, n))
    sums[:2] = torch.tensor([0, 224 * 224 * 3 * 255])  # black, white
    m0 = augment.augment_means(sums, 224 * 224 * 3)
    want_m, want_b = _affine_before_split(p, m0)
    got_m, got_b = augment.augment_matrix(p), augment.augment_bias(p, m0)
    assert got_m.dtype == got_b.dtype == torch.bfloat16
    assert got_m.is_contiguous() and got_b.is_contiguous()
    assert torch.equal(got_m.view(torch.int16), want_m.view(torch.int16))
    assert torch.equal(got_b.view(torch.int16), want_b.view(torch.int16))


@pytest.mark.parametrize("size,batch,seed,edges,extremes", [
    (32, 16, 30, False, False),
    (17, 16, 31, True, True),
    (64, 8, 32, True, False),
])
def test_augment_batch_unchanged_by_the_split(size, batch, seed, edges,
                                              extremes):
    p = _torch_params(_params(batch, seed, edges))
    imgs = torch.from_numpy(_imgs(seed, (batch, size, size, 3), extremes))
    want = _augment_batch_before_split(p, imgs)
    got = augment.augment_batch(p, imgs)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _bf16_rne(x):
    """float32 → bfloat16 to nearest even, as float32 (numpy, finite x)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def test_in_kernel_bias_mirror_equals_augment_bias():
    """The kernel's bias, in float32 numpy: m0 = float32(sum) / n / 255,
    then bf16(((1 − fc)·fb)·m0)."""
    n_img = 4096
    for size in (7, 224, 448):
        n = size * size * 3
        p = _params(n_img, size, edges=size == 7)
        sums = np.random.default_rng(size).integers(0, n * 255 + 1, n_img)
        sums[:2] = (0, n * 255)
        m0 = (sums.astype(np.float32) / np.float32(n)) / np.float32(255.0)
        want = _bf16_rne((np.float32(1.0) - p["fc"]) * p["fb"] * m0)
        got = augment.augment_bias(
            _torch_params(p), augment.augment_means(torch.from_numpy(sums), n))
        np.testing.assert_array_equal(got.float().numpy().view(np.uint32),
                                      want.view(np.uint32))


def _band_plan(s: int, j: int, code: int
              ) -> tuple[int, int, int, int, int, int, int]:
    """The kernel's index math (``ops/csrc/augment.cu``), mirrored:
    (y0, ny, x0, nx, org, dy, dx): block ``j`` of an image of size ``s``
    under the D4 element ``code`` (bit 0 transpose, bit 1 x-reverse, bit 2
    y-reverse) writes the output rows [y0, y0+ny) by columns [x0, x0+nx)
    (output rows without a transpose, output columns with one, so that every
    pixel it reads lies in its own band), and the region's pixel (iy, ix)
    reads its band's byte ``org + iy·dy + ix·dx`` (rows ``band_pitch(s)``
    apart)."""
    rows, pitch = band_rows(s), band_pitch(s)
    r0 = j * rows
    nr = max(0, min(rows, s - r0))
    t, fx, fy = code & 1, code & 2, code & 4
    ny, nx = (s, nr) if t else (nr, s)
    y0 = 0 if t else (s - r0 - nr if fy else r0)
    x0 = (s - r0 - nr if fx else r0) if t else 0
    uy, ux = (3, pitch) if t else (pitch, 3)
    org = ((ny - 1) * uy if fy else 0) + ((nx - 1) * ux if fx else 0)
    return y0, ny, x0, nx, org, -uy if fy else uy, -ux if fx else ux


@pytest.mark.parametrize("size", [7, 37, 224, 448])
@pytest.mark.parametrize("code", range(8))
def test_band_plan_covers_each_output_pixel_once(size, code):
    """Block j of an image's cluster writes the region ``_band_plan`` gives;
    every output pixel is written by exactly one block, and the band byte
    the plan reads for it is the first byte of the source pixel the D4
    element maps it to, inside that block's own band (the kernel's index
    math)."""
    t, fx, fy = code & 1, code & 2, code & 4
    rows, pitch = band_rows(size), band_pitch(size)
    hits = np.zeros((size, size), np.int32)
    for j in range(CLUSTER):
        y0, ny, x0, nx, org, dy, dx = _band_plan(size, j, code)
        iy, ix = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
        oy, ox = y0 + iy, x0 + ix
        yy = size - 1 - oy if fy else oy
        xx = size - 1 - ox if fx else ox
        sy, sx = (xx, yy) if t else (yy, xx)
        srow = sy - j * rows
        assert ((srow >= 0) & (srow < rows) & (sy < size)).all()
        np.testing.assert_array_equal(org + iy * dy + ix * dx,
                                      srow * pitch + 3 * sx)
        np.add.at(hits, (oy, ox), 1)
    assert (hits == 1).all()


def _rn32(x):
    """The float32 nearest to the rational ``x``, ties to even."""
    r = np.float32(float(x))
    return min((r, np.nextafter(r, np.float32(np.inf)),
                np.nextafter(r, np.float32(-np.inf))),
               key=lambda c: (abs(Fraction(float(c)) - x),
                              int(np.float32(c).view(np.uint32)) & 1))


def test_kernel_division_is_the_ieee_quotient():
    """The kernel divides a = c·255 − mean_d by std_d as q0 = RN(a·y),
    q = RN(q0 + RN(a − std·q0)·y) with y = RN(1/std) (two FMAs). For every
    bfloat16 c in [0, 1] (the clipped channel) and each channel, in exact
    arithmetic, that is the IEEE float32 quotient the plain version takes."""
    c = (np.arange(0x3F81, dtype=np.uint32) << 16).view(np.float32)
    for mean, std in zip(augment.MEAN_255, augment.STD_255):
        b, mean = np.float32(std), np.float32(mean)
        y = _rn32(1 / Fraction(float(b)))
        a = c * np.float32(255.0) - mean
        # a·y and a − std·q0 are exact in float64, so one rounding each
        q0 = (a.astype(np.float64) * np.float64(y)).astype(np.float32)
        r = (a.astype(np.float64) - np.float64(b) * q0).astype(np.float32)
        y_exact = Fraction(float(y))
        got = np.array([_rn32(Fraction(float(qi)) + Fraction(float(ri))
                              * y_exact) for qi, ri in zip(q0, r)],
                       np.float32)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      (a / b).view(np.uint32))


def test_augment_kernel_band_fits_and_size_limit():
    """The band plan's shared memory: the pitch holds a row in an odd
    number of 16-byte units; S = MAX_SIZE fits the card's kernel. The limit
    is the kernel's: a CPU tensor above it takes the plain version, as the
    JAX function computes any S (the card's route refuses it, see
    ``test_augment_cuda_size_limit_matches``)."""
    for s in (7, 37, 224, 448, MAX_SIZE):
        pitch = band_pitch(s)
        assert pitch >= 3 * s and pitch % 16 == 0 and (pitch // 16) % 2 == 1
    assert MAX_SIZE == 773
    s = MAX_SIZE + 1
    p = _torch_params(_params(1, 13))
    imgs = torch.from_numpy(_imgs(14, (1, s, s, 3)))
    before = augment_batch_kernel.launches
    assert torch.equal(augment_batch_kernel(p, imgs),
                       augment.augment_batch(p, imgs))
    assert augment_batch_kernel.launches == before
