"""Port attention-MIL path against the JAX package, and the MIL pool kernel
against its plain version.

The same numpy-seeded inputs go through both packages at small sizes. On
the CPU the port's pool wrapper takes the plain PyTorch version
(``mil_attention_pool_reference``); it is held against the JAX Pallas
kernel in interpret mode, as the JAX package's own tests run it, and
against the flax module. Dropout draws differ between the frameworks (JAX
keys against ``torch.Generator``s), so paths with dropout on are held
statistically or with dropout off. The ``cuda`` tests hold the kernel
against the plain version on the card (marker ``cuda``; they skip
elsewhere); JAX is imported inside the tests that compare with it, so they
also run where jax is absent (``python -m pytest --noconftest -m cuda``).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch import config
from ss25_hierarchical_multiscale_image_classification_tpu_torch.cli import (
    main as cli,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
    mil as mil_data,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation.uncertainty import (
    monte_carlo_dropout,
    softmax_thresholding,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer import (
    features,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models import (
    mil,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    mil_state_dict_from_flax,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.mil_pool import (
    MAX_D,
    MAX_H,
    NEG_INF,
    SMEM_CAP,
    TILE_K,
    mil_attention_pool,
    mil_attention_pool_kernel,
    mil_attention_pool_reference,
    pool_layout,
    pool_runs,
    pool_smem,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train import (
    mil_trainer,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
    load_model,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.losses import (
    accuracy,
    weighted_cross_entropy,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
    create_train_state,
)

torch.set_num_threads(2)

# float32 on the CPU on both sides, summed in other orders
RTOL, ATOL = 1e-5, 1e-6
D, HA, HH = 16, 8, 12  # instance width, attention and head hidden widths


def _pool_inputs(seed, b, k, d, h):
    """Instances, a random mask with bag 1 fully masked and bag 2's first 8
    slots masked, and the pool's parameters."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, k, d)).astype(np.float32)
    m = rng.random((b, k)) > 0.3
    m[:, -1] = True
    if b > 2:
        m[1] = False
        m[2, :8] = False
    v = (rng.normal(size=(d, h)) / np.sqrt(d)).astype(np.float32)
    vb = rng.normal(size=h).astype(np.float32) * 0.1
    w = rng.normal(size=h).astype(np.float32)
    return x, m, v, vb, w


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's matmul
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# the pool: plain version against the Pallas kernel and the flax module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,block_k", [(32, 8), (37, 37)])
def test_mil_pool_reference_matches_jax_pallas_and_module(k, block_k):
    """(B, K, D, H) = (3, 32, 16, 8) at block 8, and a ragged K = 37 (one
    Pallas block; the port's pool takes any K): random masks, a fully masked
    bag (the mean of its rows) and a bag whose first block is masked."""
    import jax
    import jax.numpy as jnp

    from ss25_hierarchical_multiscale_image_classification_tpu.models.mil import (
        MILAttentionPooling as JaxPooling,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu.ops.pallas.mil_pool import (
        mil_attention_pool_pallas,
    )

    x, m, v, vb, w = _pool_inputs(k, 3, k, D, HA)
    ref = np.asarray(mil_attention_pool_pallas(
        jnp.asarray(x), jnp.asarray(m), jnp.asarray(v), jnp.asarray(w),
        v_bias=jnp.asarray(vb), block_k=block_k))
    params = {"params": {"V": {"kernel": v, "bias": vb}, "w": {"kernel": w[:, None]}}}
    bag_mod, _ = JaxPooling(hidden_dim=HA).apply(params, jnp.asarray(x),
                                                 jnp.asarray(m))
    got = mil_attention_pool(*_t(x, m, v, w), v_bias=torch.from_numpy(vb))
    assert got.dtype == torch.float32 and got.shape == (3, D)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(bag_mod), rtol=RTOL,
                               atol=ATOL)
    # the fully masked bag is the mean of all its rows, not zero
    np.testing.assert_allclose(got[1].numpy(), x[1].mean(0), rtol=RTOL, atol=ATOL)


def test_mil_pool_port_module_and_reference_agree():
    x, m, v, vb, w = _pool_inputs(5, 3, 40, D, HA)
    pool = mil.MILAttentionPooling(D, HA)
    with torch.no_grad():
        pool.V.weight.copy_(torch.from_numpy(v.T))
        pool.V.bias.copy_(torch.from_numpy(vb))
        pool.w.weight.copy_(torch.from_numpy(w[None]))
        bag, attn = pool(*_t(x, m))
    got = mil_attention_pool_reference(*_t(x, m, v, w), torch.from_numpy(vb))
    np.testing.assert_allclose(got.numpy(), bag.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(attn.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert not attn[0][~torch.from_numpy(m[0])].any()
    # without a bias the pool is that of a zero bias
    np.testing.assert_array_equal(
        mil_attention_pool(*_t(x, m, v, w)).numpy(),
        mil_attention_pool(*_t(x, m, v, w), torch.zeros(HA)).numpy())


def test_mil_pool_wrapper_checks_input_and_counts_no_cpu_launch():
    x, m, v, vb, w = _t(*_pool_inputs(1, 2, 8, D, HA))
    before = mil_attention_pool_kernel.launches
    mil_attention_pool(x, m, v, w, vb)  # the CPU takes the plain version
    assert mil_attention_pool_kernel.launches == before
    bad = [
        (x[0], m, v, w),  # rank
        (x, m[:, :5], v, w),  # mask shape
        (x, m, v[:5], w),  # V depth
        (x, m, v, w[:3]),  # w length
        (x[:, :0], m[:, :0], v, w),  # empty bag
        (torch.zeros(2, 8, MAX_D + 1), m, torch.zeros(MAX_D + 1, HA), w),
        (x, m, torch.zeros(D, MAX_H + 1), torch.zeros(MAX_H + 1)),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            mil_attention_pool(*args)
    with pytest.raises(ValueError):
        mil_attention_pool(x, m, v, w, vb[:3])  # bias length
    with pytest.raises(ValueError):
        mil_attention_pool_kernel(x, m, v, w, vb)  # a CPU tensor


@pytest.mark.parametrize("k", [1, 37, 4096, 65536])
@pytest.mark.parametrize("d,h", [(100, 24), (512, 128)])
@pytest.mark.parametrize("b", [1, 8])
def test_pool_plan_fills_one_wave_and_keeps_a_tile_each(b, k, d, h):
    """The kernel's plan: a cluster of 1, 2, 4 or 8 blocks whose depth
    slices cover D and whose shared memory fits; runs of whole 64-instance
    tiles, at least one each, as many as fill the clusters the card runs at
    once (33 clusters of 4 on 132 SMs at the path's shape)."""
    cs, ds, resident, stages = pool_layout(d, h)
    assert cs in (1, 2, 4, 8) and ds % 4 == 0 and cs * ds >= d > (cs - 1) * ds
    assert pool_smem(ds, -(-h // 4) * 4, resident, stages) <= SMEM_CAP
    if (d, h) == (512, 128):
        assert (cs, ds, resident, stages) == (4, 128, True, 2)
    slots = 132 // cs
    runs = pool_runs(b, k, slots)
    tiles = -(-k // TILE_K)
    assert 1 <= runs <= tiles  # every run keeps a tile
    assert b * runs <= slots  # one wave
    assert runs == tiles or b * (runs + 1) > slots  # and no fewer runs


@pytest.mark.parametrize("d,h", [(4096, 512), (2048, 512), (4096, 4),
                                 (600, 200), (7, 3)])
def test_pool_layout_streams_v_only_where_it_cannot_stay(d, h):
    """Large D·H: V is read from device memory, or the ring has one stage;
    chosen by shape, and always within the shared memory a block has."""
    cs, ds, resident, stages = pool_layout(d, h)
    h4 = -(-h // 4) * 4
    assert pool_smem(ds, h4, resident, stages) <= SMEM_CAP
    ds8 = -(-d // 32) * 4  # the slice of a cluster of 8
    if not resident:  # no cluster would keep its slice of V
        assert pool_smem(ds8, h4, True, 1) > SMEM_CAP
    if stages == 1:  # no cluster keeps two h tiles beside its slice of V
        assert pool_smem(ds8, h4, resident, 2) > SMEM_CAP
    if d <= 128 and h <= 128:
        assert (cs, resident, stages) == (1, True, 2)


def _emulate_pool(x, m, v, w, vb, slots):
    """The kernel's blocking and merge order in float32: the plan's depth
    slices (their partial pre-activations summed in rank order), 64-instance
    tiles walked in runs with an online (m, l, acc), the runs merged in
    index order by weights exp(m_c - M)."""
    b, k, d = x.shape
    h = v.shape[1]
    cs, ds, _, _ = pool_layout(d, h)
    runs = pool_runs(b, k, slots)
    tiles = -(-k // TILE_K)
    out = torch.zeros(b, d)
    for bag in range(b):
        parts = []
        for run in range(runs):
            m_run, l_run, acc = torch.tensor(NEG_INF), torch.tensor(0.0), torch.zeros(d)
            for t in range(run * tiles // runs, (run + 1) * tiles // runs):
                rows = x[bag, t * TILE_K:(t + 1) * TILE_K]
                pre = torch.zeros(rows.shape[0], h)
                for r in range(cs):
                    sl = slice(r * ds, (r + 1) * ds)
                    pre = pre + rows[:, sl] @ v[sl]
                a = (torch.tanh(pre + vb) * w).sum(dim=1)
                a = torch.where(m[bag, t * TILE_K:(t + 1) * TILE_K], a, NEG_INF)
                mt = torch.maximum(m_run, a.max())
                scale = torch.exp(m_run - mt)
                p = torch.exp(a - mt)
                l_run = l_run * scale + p.sum()
                acc = acc * scale + p @ rows
                m_run = mt
            parts.append((m_run, l_run, acc))
        big_m = max(pm for pm, _, _ in parts)
        big_l = torch.tensor(0.0)
        total = torch.zeros(d)
        for pm, pl_, pa in parts:
            wgt = torch.exp(pm - big_m)
            big_l = big_l + pl_ * wgt
            total = total + pa * wgt
        out[bag] = total / torch.clamp_min(big_l, 1e-30)
    return out


@pytest.mark.parametrize("b,k,d,h,slots,traps", [
    (1, 4096, 64, 24, 33, "first"),  # 33 runs; the first 3 tiles masked
    (3, 1000, 32, 16, 132, "runs"),  # a fully masked bag; a masked run
    (2, 37, 100, 24, 132, "lengths"),  # ragged K (one tile)
    (2, 130, 600, 200, 16, "lengths"),  # a cluster of 8 splits D
    (4, 300, 512, 128, 33, "lengths"),  # the path's layout, 8 runs a bag
])
def test_pool_emulation_of_the_kernel_order_matches_plain_version(
        b, k, d, h, slots, traps):
    rng = np.random.default_rng(k + d)
    x = torch.from_numpy(np.maximum(rng.normal(size=(b, k, d)) + 0.5, 0)
                         .astype(np.float32))
    if traps == "lengths":
        m = torch.arange(k)[None] < torch.from_numpy(rng.integers(1, k + 1, (b, 1)))
    else:
        m = torch.from_numpy(rng.random((b, k)) > 0.3)
    if traps == "first":
        m[0, :3 * TILE_K] = False
    if traps == "runs":
        m[1] = False  # every logit -1e30: the mean of the bag's rows
        m[2, TILE_K:2 * TILE_K] = False  # one run (a tile) all masked
    v = torch.from_numpy((rng.normal(size=(d, h)) / np.sqrt(d)).astype(np.float32))
    vb = torch.from_numpy((0.1 * rng.normal(size=h)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=h) / np.sqrt(h)).astype(np.float32))
    got = _emulate_pool(x, m, v, w, vb, slots)
    ref = mil_attention_pool_reference(x, m, v, w, vb)
    assert (got - ref).abs().max() <= 1e-6 * ref.abs().max()
    if traps == "runs":
        torch.testing.assert_close(got[1], x[1].mean(0), rtol=1e-6, atol=1e-6)


def test_pool_emulation_matches_jax_pallas():
    """The emulated kernel order against the Pallas kernel (interpret mode,
    blocks of 8) on ragged runs of a 3-bag batch with the mask traps."""
    import jax.numpy as jnp

    from ss25_hierarchical_multiscale_image_classification_tpu.ops.pallas.mil_pool import (
        mil_attention_pool_pallas,
    )

    x, m, v, vb, w = _pool_inputs(9, 3, 200, D, HA)
    ref = np.asarray(mil_attention_pool_pallas(
        jnp.asarray(x), jnp.asarray(m), jnp.asarray(v), jnp.asarray(w),
        v_bias=jnp.asarray(vb), block_k=8))
    got = _emulate_pool(*_t(x, m, v, w, vb), slots=4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the classifier and its functions
# ---------------------------------------------------------------------------


def _jax_classifier(pooling="attention", seed=0, k=24, dropout_rate=0.25):
    import jax
    import jax.numpy as jnp

    from ss25_hierarchical_multiscale_image_classification_tpu.models.mil import (
        MILClassifier as JaxClassifier,
    )

    model = JaxClassifier(attention_hidden_dim=HA, head_hidden_dim=HH,
                          pooling=pooling, dropout_rate=dropout_rate)
    variables = model.init(jax.random.key(seed), jnp.zeros((1, k, D)),
                           jnp.ones((1, k), bool))
    return model, jax.device_get(variables)


def _port_classifier(variables, pooling="attention", dropout_rate=0.25):
    model = mil.MILClassifier(input_dim=D, attention_hidden_dim=HA,
                              head_hidden_dim=HH, pooling=pooling,
                              dropout_rate=dropout_rate)
    model.load_state_dict(mil_state_dict_from_flax(variables), strict=True)
    return model


@pytest.mark.parametrize("pooling", ["attention", "mean", "max"])
def test_mil_classifier_conversion_matches_jax(pooling):
    import jax.numpy as jnp

    jmodel, variables = _jax_classifier(pooling)
    x, m, *_ = _pool_inputs(2, 3, 24, D, HA)
    logits_j, attn_j = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(m))
    model = _port_classifier(variables, pooling).eval()
    with torch.no_grad():
        logits, attn = model(*_t(x, m))
    assert logits.dtype == torch.float32 and logits.shape == (3, 2)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), rtol=RTOL,
                               atol=ATOL)
    if pooling == "attention":
        np.testing.assert_allclose(attn.numpy(), np.asarray(attn_j), rtol=RTOL,
                                   atol=ATOL)
    else:
        assert attn is None and attn_j is None


def test_mil_functions_match_jax():
    """``attention_params``, ``attention_weights``, ``apply_head`` (no
    dropout) and ``streaming_attention_pool`` (K = 40 pads nothing; K = 600
    pads to 1024 at block 512) against the JAX functions."""
    import jax.numpy as jnp

    from ss25_hierarchical_multiscale_image_classification_tpu.models import (
        mil as jmil,
    )

    _, variables = _jax_classifier()
    params = mil_state_dict_from_flax(variables)
    jparams = variables["params"]
    for got, want in zip(mil.attention_params(params),
                         jmil.attention_params(jparams)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for k in (40, 600):
        x, m, *_ = _pool_inputs(k, 2, k, D, HA)
        np.testing.assert_allclose(
            mil.attention_weights(params, *_t(x, m)).numpy(),
            np.asarray(jmil.attention_weights(jparams, jnp.asarray(x),
                                              jnp.asarray(m))),
            rtol=1e-4, atol=ATOL)
        pooled = mil.streaming_attention_pool(params, *_t(x, m))
        np.testing.assert_allclose(
            pooled.numpy(),
            np.asarray(jmil.streaming_attention_pool(jparams, jnp.asarray(x),
                                                     jnp.asarray(m))),
            rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        mil.apply_head(params, pooled).numpy(),
        np.asarray(jmil.apply_head(jparams, jnp.asarray(pooled.numpy()))),
        rtol=RTOL, atol=ATOL)


def test_streaming_pool_pads_a_fully_masked_bag_as_jax():
    """A fully masked bag of K = 600 pools to the mean over 1024 rows, the
    424 zero rows of the padding included: the JAX function's number."""
    import jax.numpy as jnp

    from ss25_hierarchical_multiscale_image_classification_tpu.models import (
        mil as jmil,
    )

    _, variables = _jax_classifier()
    x = np.random.default_rng(3).normal(1.0, 1.0, (1, 600, D)).astype(np.float32)
    m = np.zeros((1, 600), bool)
    got = mil.streaming_attention_pool(mil_state_dict_from_flax(variables),
                                       *_t(x, m)).numpy()
    want = np.asarray(jmil.streaming_attention_pool(
        variables["params"], jnp.asarray(x), jnp.asarray(m)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[0], x[0].sum(0) / 1024, rtol=RTOL, atol=ATOL)


def test_dropout_and_lecun_init_statistics():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200, 500)
    y = mil.dropout(x, 0.25, g)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    assert torch.allclose(y[kept], torch.tensor(1 / 0.75))
    assert torch.equal(mil.dropout(x, 0.0, g), x)
    layer = torch.nn.Linear(512, 4096)
    mil.lecun_normal_(layer, torch.Generator().manual_seed(1))
    wt = layer.weight
    assert abs(wt.std().item() * np.sqrt(512) - 1.0) < 0.01  # variance 1/fan_in
    assert wt.abs().max().item() <= 2 / np.sqrt(512) / 0.87962566103423978
    assert not layer.bias.any()


# ---------------------------------------------------------------------------
# host copies (exact)
# ---------------------------------------------------------------------------


def _names_and_features(seed=0, d=D):
    """Three slides of 7, 12 and 5 patches, reference patch names (one a
    degenerate name), labels."""
    rng = np.random.default_rng(seed)
    names, labels = [], []
    for slide, n, tumor in (("tumor_002", 7, 3), ("normal_001", 12, 0),
                            ("test_003", 5, 1)):
        for i in range(n):
            lbl = "tumor" if i < tumor else "normal"
            names.append(f"{slide}_x{i * 224}_y{448 * (i % 3)}_{lbl}.png")
            labels.append(int(i < tumor))
    names[-1] = "test_003_odd_name"
    order = rng.permutation(len(names))
    feats = rng.normal(size=(len(names), d)).astype(np.float32)
    return (feats, np.asarray(labels)[order],
            [names[i] for i in order])


def test_mil_data_copies_match_jax(tmp_path):
    from ss25_hierarchical_multiscale_image_classification_tpu.data import (
        mil as jdata,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu.infer import (
        features as jfeatures,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu.models import (
        mil as jmil,
    )

    for name in ("tumor_001_x224_y448_tumor.png", "a_b_x0_y0_normal.png",
                 "weird_name_here", "x", "s_x1_y2_other.png"):
        assert mil_data.slide_from_patch_name(name) == \
            jdata.slide_from_patch_name(name)
    for k, size, dtype in ((5, 8, np.float32), (8, 8, np.float32),
                           (13, 8, np.float32), (13, 8, np.float64),
                           (4096, 1000, np.float32)):
        f = np.arange(k * 3, dtype=dtype).reshape(k, 3)
        for got, want in zip(mil.pad_bag(f, size), jmil.pad_bag(f, size)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)

    feats, labels, names = _names_and_features()
    coords = np.arange(2 * len(names)).reshape(-1, 2)
    bags = mil_data.build_bags(feats, labels, names, coords)
    jbags = jdata.build_bags(feats, labels, names, coords)
    assert [dataclasses.astuple(b)[::2] for b in bags] == \
        [dataclasses.astuple(b)[::2] for b in jbags]
    for b, j in zip(bags, jbags):
        np.testing.assert_array_equal(b.features, j.features)
        np.testing.assert_array_equal(b.coords, j.coords)

    it = mil_data.MILBagIterator(bags, batch_size=2, max_bag_size=8, seed=3)
    jit = jdata.MILBagIterator(jbags, batch_size=2, max_bag_size=8, seed=3)
    assert len(it) == len(jit) == 2
    for _epoch in range(2):  # seed + epoch reshuffles
        for got, want in zip(list(it), list(jit), strict=True):
            for a, b in zip(got, want, strict=True):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)

    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    features._save_artifacts(pdir, 3, feats, labels, names)
    jfeatures._save_artifacts(jdir, 3, feats, labels, names)
    for fname in ("patch_features_3.npy", "patch_labels_3.npy",
                  "patch_paths_3.txt"):
        with open(os.path.join(pdir, fname), "rb") as f, \
                open(os.path.join(jdir, fname), "rb") as g:
            assert f.read() == g.read(), fname
    for got, want in zip(features.load_feature_artifacts(jdir, 3),
                         jfeatures.load_feature_artifacts(jdir, 3)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    got_bags = mil_data.bags_from_artifacts(pdir, 3)
    assert [(b.slide, b.label, len(b.features)) for b in got_bags] == \
        [(b.slide, b.label, len(b.features))
         for b in jdata.bags_from_artifacts(jdir, 3)]


# ---------------------------------------------------------------------------
# losses, uncertainty
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
def test_weighted_cross_entropy_and_accuracy_match_jax(weighted, with_valid):
    import jax.numpy as jnp

    from ss25_hierarchical_multiscale_image_classification_tpu.train import (
        losses as jlosses,
    )

    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(8, 3)) * 4).astype(np.float32)
    labels = rng.integers(0, 3, 8).astype(np.int32)
    weights = np.array([0.5, 2.0, 1.5], np.float32) if weighted else None
    valid = (np.arange(8) < 5).astype(np.float32) if with_valid else None
    got = weighted_cross_entropy(
        *_t(logits, labels), weights,
        None if valid is None else torch.from_numpy(valid))
    want = jlosses.weighted_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), weights,
        None if valid is None else jnp.asarray(valid))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    acc = accuracy(*_t(logits, labels),
                   None if valid is None else torch.from_numpy(valid))
    jacc = jlosses.accuracy(jnp.asarray(logits), jnp.asarray(labels),
                            None if valid is None else jnp.asarray(valid))
    assert acc.item() == pytest.approx(float(jacc), abs=1e-7)


def test_softmax_thresholding_matches_jax():
    from ss25_hierarchical_multiscale_image_classification_tpu.evaluation import (
        uncertainty as junc,
    )

    logits = np.array([[2.0, 0.0], [0.2, 0.1], [-1.0, 3.0], [0.0, 0.8473]],
                      np.float32)
    for threshold in (0.7, 0.5, 0.9):
        got = softmax_thresholding(logits, threshold)
        want = junc.softmax_thresholding(logits, threshold)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-6)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_monte_carlo_dropout_shapes_and_seeded_reproducibility():
    _, variables = _jax_classifier("mean")
    model = _port_classifier(variables, "mean")
    x, m, *_ = _pool_inputs(6, 2, 24, D, HA)
    x, m = _t(x, m)

    def apply_fn(xs, g):
        return model(xs, m.repeat(xs.shape[0] // 2, 1), train=True, generator=g)

    with torch.no_grad():
        runs = [monte_carlo_dropout(apply_fn, x,
                                    torch.Generator().manual_seed(s),
                                    n_samples=50) for s in (1, 1, 2)]
    mean, var = runs[0]
    assert mean.shape == var.shape == (2, 2)
    np.testing.assert_allclose(mean.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert (var > 0).all()
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not torch.equal(runs[0][1], runs[2][1])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def test_mil_train_step_matches_jax_without_dropout():
    """One Adam step from the same weights and batch (8 bags of K = 24, two
    padded rows, ragged bags), dropout rate 0: loss, gradients and the
    updated parameters."""
    import jax
    import jax.numpy as jnp
    import optax

    from ss25_hierarchical_multiscale_image_classification_tpu.train.losses import (
        weighted_cross_entropy as jax_wce,
    )

    jmodel, variables = _jax_classifier(dropout_rate=0.0)
    rng = np.random.default_rng(9)
    feats = rng.normal(size=(8, 24, D)).astype(np.float32)
    mask = np.arange(24)[None, :] < rng.integers(5, 25, 8)[:, None]
    labels = rng.integers(0, 2, 8).astype(np.int32)
    valid = (np.arange(8) < 6).astype(np.float32)
    feats *= mask[..., None]

    def loss_fn(p):
        logits, _ = jmodel.apply({"params": p}, feats, mask, train=True,
                                 rngs={"dropout": jax.random.key(0)})
        return jax_wce(logits, labels, None, valid)

    loss, grads = jax.value_and_grad(loss_fn)(variables["params"])
    tx = optax.adam(1e-3)
    updates, _ = tx.update(grads, tx.init(variables["params"]),
                           variables["params"])
    new = optax.apply_updates(variables["params"], updates)

    model = _port_classifier(variables, dropout_rate=0.0)
    state = create_train_state(model, 1e-3, torch.device("cpu"))
    p_loss, correct, count = mil_trainer.train_step(
        state, torch.Generator().manual_seed(0), *_t(feats, mask, labels, valid))
    np.testing.assert_allclose(p_loss.item(), float(loss), rtol=RTOL)
    assert count.item() == 6 and 0 <= correct.item() <= 6
    want_g = mil_state_dict_from_flax({"params": jax.device_get(grads)})
    want_p = mil_state_dict_from_flax({"params": jax.device_get(new)})
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(p.detach().numpy(), want_p[k].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def _toy_bags():
    """The JAX package's toy MIL problem (tests/test_mil.py): 8 bags of 20
    instances of width 16, tumor bags centred at 3."""
    rng = np.random.default_rng(1)
    bags = []
    for i in range(8):
        tumor = i % 2 == 1
        feats = rng.normal(3.0 if tumor else 0.0, 1.0, (20, 16)).astype(np.float32)
        bags.append(mil_data.Bag(slide=f"s{i}", features=feats, label=int(tumor)))
    return bags


def test_train_mil_classifier_end_to_end_on_cpu(tmp_path):
    cfg = config.Config(models_dir=str(tmp_path / "models"))
    cfg.mil.max_bag_size = 32
    cfg.mil.learning_rate = 1e-2  # toy problem, few steps
    result = mil_trainer.train_mil_classifier(cfg, bags=_toy_bags(), epochs=60,
                                              device="cpu")
    assert result["history"][-1]["acc"] > 0.7
    assert np.isfinite([h["loss"] for h in result["history"]]).all()
    assert result["max_bag_size"] == 20 and result["val_accuracy"] >= 0.0
    saved = load_model(os.path.join(cfg.models_dir, "mil_classifier"))
    sd = result["variables"]
    assert saved.keys() == sd.keys()
    assert all(torch.equal(saved[k], sd[k]) for k in sd)
    model = mil.MILClassifier(input_dim=16)
    model.load_state_dict(saved, strict=True)
    pred = mil_trainer.mil_predict(saved, _toy_bags()[1].features, cfg,
                                   mc_dropout=True, device="cpu")
    assert pred["probs"].shape == (2,) and len(pred["attention"]) == 20
    assert pred["mc_variance"].shape == (2,)


def test_train_mil_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        mil_trainer.train_mil_classifier(
            config.Config(models_dir=str(tmp_path)), bags=_toy_bags(),
            epochs=1, device="cuda")


# ---------------------------------------------------------------------------
# mil_predict
# ---------------------------------------------------------------------------


def _predict_setup(seed=3, k=40):
    from ss25_hierarchical_multiscale_image_classification_tpu.config import (
        Config as JaxConfig,
    )

    _, variables = _jax_classifier(k=k, seed=seed)
    feats = np.random.default_rng(seed).normal(0, 1, (k, D)).astype(np.float32)
    jcfg, cfg = JaxConfig(), config.Config()
    for c in (jcfg, cfg):
        c.mil.attention_hidden_dim, c.mil.head_hidden_dim = HA, HH
        c.mil.max_bag_size = 64
    return variables, feats, jcfg, cfg


@pytest.mark.parametrize("route", ["module", "streaming", "auto"])
def test_mil_predict_matches_jax(route):
    from ss25_hierarchical_multiscale_image_classification_tpu.train.mil_trainer import (
        mil_predict as jax_mil_predict,
    )

    variables, feats, jcfg, cfg = _predict_setup()
    streaming = {"module": False, "streaming": True, "auto": None}[route]
    if route == "auto":  # the 40-instance bag is above the threshold
        jcfg.mil.streaming_bag_threshold = cfg.mil.streaming_bag_threshold = 16
    sd = mil_state_dict_from_flax(variables)
    before = mil_attention_pool_kernel.launches
    for bag in (feats, feats[:0]):  # the empty bag pools one masked row
        want = jax_mil_predict(variables, bag, jcfg, streaming=streaming)
        got = mil_trainer.mil_predict(sd, bag, cfg, streaming=streaming,
                                      device="cpu")
        np.testing.assert_allclose(got["probs"], want["probs"], rtol=RTOL,
                                   atol=ATOL)
        assert got["prediction"] == want["prediction"]
        assert got["probs"].dtype == np.float32
        np.testing.assert_allclose(got["attention"], want["attention"],
                                   rtol=1e-4, atol=ATOL)
        assert len(got["attention"]) == len(bag)
    assert mil_attention_pool_kernel.launches == before  # the CPU launches none
    got = mil_trainer.mil_predict(sd, feats, cfg, streaming=streaming,
                                  return_attention=False, device="cpu")
    assert got["attention"] is None


def test_mil_predict_mc_dropout_matches_jax_statistically():
    """400 samples of the head over the once-pooled bag on both sides: the
    predictive means agree within 0.06 (JAX's own bound between its two
    sampling paths); the port's variance is the population variance of its
    own samples."""
    import jax

    from ss25_hierarchical_multiscale_image_classification_tpu.train.mil_trainer import (
        mil_predict as jax_mil_predict,
    )

    variables, feats, jcfg, cfg = _predict_setup(seed=4)
    jcfg.uncertainty.monte_carlo_samples = cfg.uncertainty.monte_carlo_samples = 400
    want = jax_mil_predict(variables, feats, jcfg, mc_dropout=True,
                           rng=jax.random.key(1))
    sd = mil_state_dict_from_flax(variables)
    got = mil_trainer.mil_predict(sd, feats, cfg, mc_dropout=True,
                                  generator=torch.Generator().manual_seed(1),
                                  device="cpu")
    assert got["mc_mean"].shape == got["mc_variance"].shape == (2,)
    np.testing.assert_allclose(got["mc_mean"], want["mc_mean"], atol=0.06)
    assert (got["mc_variance"] > 0).all()
    # the same draws by hand: variance with correction = 0
    feats_p, mask_p = mil.pad_bag(feats, len(feats))
    pooled = mil.streaming_attention_pool(sd, *_t(feats_p[None], mask_p[None]))
    probs = torch.softmax(mil.apply_head(
        sd, pooled.expand(400, 1, D), cfg.mil.dropout_rate,
        torch.Generator().manual_seed(1)), dim=-1)[:, 0]
    np.testing.assert_allclose(got["mc_mean"], probs.mean(0).numpy(), rtol=1e-6)
    np.testing.assert_allclose(got["mc_variance"],
                               probs.var(0, correction=0).numpy(), rtol=1e-5)


def test_mil_predict_mc_dropout_without_attention_runs_the_model():
    """Mean pooling has no kernel path: MC dropout samples the whole model
    (one batched forward), as JAX's ``monte_carlo_dropout`` does."""
    from ss25_hierarchical_multiscale_image_classification_tpu.train.mil_trainer import (
        mil_predict as jax_mil_predict,
    )

    _, variables = _jax_classifier("mean", k=40)
    _, feats, jcfg, cfg = _predict_setup()
    jcfg.mil.pooling = cfg.mil.pooling = "mean"
    jcfg.uncertainty.monte_carlo_samples = cfg.uncertainty.monte_carlo_samples = 400
    want = jax_mil_predict(variables, feats, jcfg, mc_dropout=True)
    got = mil_trainer.mil_predict(mil_state_dict_from_flax(variables), feats,
                                  cfg, mc_dropout=True, device="cpu")
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=RTOL, atol=ATOL)
    assert got["attention"] is None
    np.testing.assert_allclose(got["mc_mean"], want["mc_mean"], atol=0.06)


# ---------------------------------------------------------------------------
# CLI and the export script
# ---------------------------------------------------------------------------


def test_cli_train_mil_on_cpu(tmp_path):
    feats, labels, names = _names_and_features(d=D)
    # three more slides so that the split leaves a train batch and a val bag
    more_f, more_l, more_n = _names_and_features(seed=1, d=D)
    data_dir = tmp_path / "data"
    features._save_artifacts(
        str(data_dir / "features"), 2, np.concatenate([feats, more_f + 1]),
        np.concatenate([labels, more_l]),
        names + [n.replace("_", "b_", 1) for n in more_n])
    models_dir = tmp_path / "models"
    rc = cli.main(["--train_mil", "--data_dir", str(data_dir), "--patch_level",
                   "2", "--epochs", "2", "--models_dir", str(models_dir),
                   "--device", "cpu"])
    assert rc == 0
    sd = load_model(str(models_dir / "mil_classifier"))
    mil.MILClassifier(input_dim=D).load_state_dict(sd, strict=True)


@pytest.mark.parametrize("argv", [[], ["--predict_slide", "s.wsi.npz",
                                       "--train_mil"]])
def test_cli_needs_exactly_one_action(argv, capsys, tmp_path):
    """No action does nothing and returns 0, as the JAX ``main`` does; two
    actions run in the JAX CLI's order, so ``--train_mil`` comes before
    ``--predict_slide`` and misses its features."""
    argv = argv + ["--device", "cpu", "--data_dir", str(tmp_path / "none")]
    if not argv[0].startswith("--predict"):
        assert cli.main(argv) == 0
        assert "usage:" not in capsys.readouterr().err
        assert not os.path.exists(tmp_path / "none")
        return
    with pytest.raises(FileNotFoundError, match="patch_features_3.npy"):
        cli.main(argv)


def test_export_script_writes_a_mil_artifact(tmp_path):
    import importlib.util

    from ss25_hierarchical_multiscale_image_classification_tpu.train.checkpoints import (
        save_model as jax_save_model,
    )

    _, variables = _jax_classifier()
    src = str(tmp_path / "mil_classifier")
    jax_save_model(src, variables)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "export_jax_checkpoint_to_torch",
        os.path.join(repo, "scripts", "export_jax_checkpoint_to_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.main([src]) == 0
    loaded = load_model(src)
    expect = mil_state_dict_from_flax(variables)
    assert loaded.keys() == expect.keys()
    assert all(torch.equal(loaded[k], expect[k]) for k in expect)
    mil.MILClassifier(input_dim=D, attention_hidden_dim=HA,
                      head_hidden_dim=HH).load_state_dict(loaded, strict=True)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,d,h", [(1, 4096, 512, 128), (8, 4096, 512, 128),
                                     (3, 1000, 512, 128), (2, 37, 100, 24),
                                     (2, 70, 600, 200)])
def test_mil_pool_cuda_kernel_matches_plain_version(cuda_device, b, k, d, h):
    x, m, v, vb, w = (t.to(cuda_device) for t in _t(*_pool_inputs(k, b, k, d, h)))
    before = mil_attention_pool_kernel.launches
    got = mil_attention_pool(x, m, v, w, vb)
    torch.cuda.synchronize()
    assert mil_attention_pool_kernel.launches == before + 1
    ref = mil_attention_pool_reference(x, m, v, w, vb)
    # as chip_smoke.py: relative to the largest |value| of the bags
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    if b > 2:  # the fully masked bag is its mean
        torch.testing.assert_close(got[1], x[1].mean(0), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,d,h,layout", [
    (2, 37, 100, 24, (1, True, 2)), (3, 200, 200, 128, (2, True, 2)),
    (1, 4096, 512, 128, (4, True, 2)), (2, 70, 1024, 128, (8, True, 2)),
    (1, 300, 2048, 512, (8, False, 2)), (2, 50, 37, 21, (1, True, 2)),
    (3, 130, 4096, 8, (8, True, 1))])
def test_mil_pool_cuda_layouts_give_the_same_bits_twice(cuda_device, b, k, d,
                                                         h, layout):
    """Clusters of 1, 2, 4 and 8, widths not a multiple of 4, V read from
    device memory (D·H too large to stay), one ring stage: within 1e-5 of
    the plain version, and a second call gives the same bits (the runs are
    merged in index order, no atomics in any sum)."""
    cs, _, resident, stages = pool_layout(d, h)
    assert (cs, resident, stages) == layout
    x, m, v, vb, w = (t.to(cuda_device) for t in _t(*_pool_inputs(k, b, k, d, h)))
    got = mil_attention_pool(x, m, v, w, vb)
    again = mil_attention_pool(x, m, v, w, vb)
    torch.cuda.synchronize()
    ref = mil_attention_pool_reference(x, m, v, w, vb)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert torch.equal(got, again)
    if b > 2:  # the fully masked bag is its mean
        torch.testing.assert_close(got[1], x[1].mean(0), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_mil_predict_on_cuda_matches_cpu(cuda_device):
    cfg = config.Config()
    cfg.mil.streaming_bag_threshold = 16
    sd = mil.MILClassifier(input_dim=D).state_dict()
    feats = np.random.default_rng(3).normal(0, 1, (40, D)).astype(np.float32)
    before = mil_attention_pool_kernel.launches
    card = mil_trainer.mil_predict(sd, feats, cfg, mc_dropout=True,
                                   device=cuda_device)
    assert mil_attention_pool_kernel.launches == before + 1  # pooled once
    cpu = mil_trainer.mil_predict(sd, feats, cfg, device="cpu")
    np.testing.assert_allclose(card["probs"], cpu["probs"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(card["attention"].sum(), 1.0, rtol=1e-5)
