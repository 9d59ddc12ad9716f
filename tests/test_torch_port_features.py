"""The port's feature extraction (``infer/features.py``, ``data/prefetch.py``,
CLI ``--extract_features``) against the JAX package.

A packed store of 40 seeded 32² patches and one narrow flax ResNet18
(``num_filters=8``, randomized BatchNorm) go through the JAX
``run_feature_extraction`` and the port's, in float32 on the CPU (the port's
stem kernels are their plain versions there) at batch 16, so that the last
batch is wrap-padded with 8 real rows. The ``cuda``-marked test runs the
port's loop on the card, pinned buffers, copy stream and stem kernels
included, against the CPU's. JAX is imported inside the tests that compare
with it.
"""

import os
import threading

import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch import config
from ss25_hierarchical_multiscale_image_classification_tpu_torch.cli import (
    main as cli,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
    datasets,
    manifest,
    patch_store,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.prefetch import (
    Prefetcher,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer import (
    features,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    state_dict_from_flax,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
    ResNet18Classifier,
    ResNet18FeatureExtractor,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.simclr import (
    SimCLRModel,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops import (
    fused_stem as fs,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
    save_model,
)

torch.set_num_threads(2)

N, EDGE, BATCH, WIDTH = 40, 32, 16, 8


def _write_store(root, edge=EDGE, n=N, seed=0):
    """Two slides' packed stores of ``n`` seeded patches; the records."""
    rng = np.random.default_rng(seed)
    recs = []
    for slide, count in (("normal_001", n // 2 + 3), ("tumor_002", n - n // 2 - 3)):
        w = patch_store.PackedPatchWriter(root, 3, slide, edge)
        coords = np.stack([np.arange(count) % 7, np.arange(count) // 7], 1) * edge
        labels = (rng.random(count) < 0.3).astype(np.int64)
        recs += w.write_batch(
            rng.integers(0, 256, (count, edge, edge, 3), dtype=np.uint8),
            coords, labels)
        w.close()
    return recs


def _randomized_state(seed, num_filters=WIDTH, num_classes=2):
    """A port ResNet18's state dict with every BN tensor drawn from a seed."""
    g = torch.Generator().manual_seed(seed)
    model = (ResNet18Classifier(num_classes, num_filters, g) if num_classes
             else ResNet18FeatureExtractor(num_filters, g))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
                m.running_mean.normal_(0.0, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    return model.state_dict()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# host pieces (exact)
# ---------------------------------------------------------------------------


def test_prefetcher_keeps_order_and_content_as_jax():
    pytest.importorskip("jax")
    from ss25_hierarchical_multiscale_image_classification_tpu.data.prefetch import (
        Prefetcher as JaxPrefetcher,
    )

    class Source:
        def __init__(self):
            self.threads = []

        def __len__(self):
            return 9

        def __iter__(self):
            self.threads.append(threading.current_thread())
            for i in range(9):
                yield i, np.full((2, 3), i)

    src, jsrc = Source(), Source()
    p, jp = Prefetcher(src, depth=3), JaxPrefetcher(jsrc, depth=3)
    assert len(p) == len(jp) == 9 and p.depth == jp.depth == 3
    for _ in range(2):  # re-iterable
        got, want = list(p), list(jp)
        assert [i for i, _ in got] == [i for i, _ in want] == list(range(9))
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))
    # the producer ran on another thread, which has ended
    assert all(t is not threading.main_thread() and not t.is_alive()
               for t in src.threads)
    assert Prefetcher(src, depth=0).depth == 1


def test_prefetcher_raises_the_producers_error_in_the_consumer():
    def broken():
        yield 1
        raise KeyError("lost batch")

    class Source:
        def __iter__(self):
            return broken()

    got = []
    with pytest.raises(KeyError, match="lost batch"):
        for item in Prefetcher(Source()):
            got.append(item)
    assert got == [1]


@pytest.mark.parametrize("n,bs", [(12, 5), (3, 5), (12, 4)])
def test_unshuffled_batch_iterator_matches_jax(tmp_path, n, bs):
    pytest.importorskip("jax")
    from ss25_hierarchical_multiscale_image_classification_tpu.data import (
        datasets as jax_datasets,
        manifest as jax_manifest,
    )

    recs = _write_store(str(tmp_path), edge=16, n=12)[:n]
    ds = datasets.PatchDataset(manifest.PatchManifest(recs), resize_to=16)
    jds = jax_datasets.PatchDataset(jax_manifest.PatchManifest(recs),
                                    resize_to=16)
    it = datasets.BatchIterator(ds, bs, shuffle=False)
    jit = jax_datasets.BatchIterator(jds, bs, shuffle=False)
    for _ in range(2):  # every epoch walks the manifest in order
        got, want = list(it), list(jit)
        assert len(got) == len(want) == len(it)
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    first = next(iter(it))
    np.testing.assert_array_equal(first[1][:min(n, bs)],
                                  ds.labels[:min(n, bs)])


def test_features_memmap_and_artifacts_match_jax(tmp_path):
    pytest.importorskip("jax")
    from ss25_hierarchical_multiscale_image_classification_tpu.infer import (
        features as jax_features,
    )

    rng = np.random.default_rng(1)
    feats = rng.normal(size=(7, 64)).astype(np.float32)
    labels = rng.integers(0, 2, 7)
    names = [f"s_x{i}_y0_normal.png" for i in range(7)]
    for mod, d in ((features, tmp_path / "port"), (jax_features, tmp_path / "jax")):
        out = mod._features_memmap(str(d), 2, 7, 64)
        assert isinstance(out, np.memmap) and out.shape == (7, 64)
        out[:] = feats
        mod._save_artifacts(str(d), 2, out, labels, names)
        del out
    for name in ("patch_features_2.npy", "patch_labels_2.npy",
                 "patch_paths_2.txt"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    got = features.load_feature_artifacts(str(tmp_path / "jax"), 2)
    np.testing.assert_array_equal(got[0], feats)
    assert got[2] == names
    # an in-memory matrix is saved whole, as before
    features._save_artifacts(str(tmp_path / "mem"), 2, feats, labels, names)
    assert (tmp_path / "mem" / "patch_features_2.npy").read_bytes() == \
        (tmp_path / "jax" / "patch_features_2.npy").read_bytes()


# ---------------------------------------------------------------------------
# the extraction loop
# ---------------------------------------------------------------------------


def test_run_feature_extraction_matches_jax(tmp_path):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from ss25_hierarchical_multiscale_image_classification_tpu.data import (
        datasets as jax_datasets,
        manifest as jax_manifest,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu.infer import (
        features as jax_features,
    )
    from tests.test_torch_port_folded import _randomized_variables

    recs = _write_store(str(tmp_path / "patches"))
    variables = _randomized_variables(jax, 41)
    jds = jax_datasets.PatchDataset(jax_manifest.PatchManifest(recs),
                                    resize_to=EDGE)
    jfeats, jlabels, jnames = jax_features.run_feature_extraction(
        jds, variables, batch_size=BATCH, dtype=jnp.float32, feature_dim=64)

    ds = datasets.PatchDataset(manifest.PatchManifest(recs), resize_to=EDGE)
    out = features._features_memmap(str(tmp_path / "features"), 3, N, 64)
    before = (fs.bias_relu_pool_kernel.launches, fs.fused_stem_kernel.launches)
    feats, labels, names = features.run_feature_extraction(
        ds, state_dict_from_flax(variables), batch_size=BATCH, out=out,
        feature_dim=64, device="cpu")
    assert (fs.bias_relu_pool_kernel.launches,
            fs.fused_stem_kernel.launches) == before
    assert feats.shape == (N, 64) and feats.dtype == np.float32
    assert isinstance(feats, np.memmap)  # spooled into the artifact
    assert np.abs(jfeats).max() > 0.1 and np.std(jfeats, axis=0).max() > 1e-3
    np.testing.assert_allclose(feats, jfeats, rtol=0,
                               atol=1e-4 * np.abs(jfeats).max())
    np.testing.assert_array_equal(labels, jlabels)
    assert names == jnames == [r.patch_name for r in recs]
    # the wrap-padded rows of the last batch (8 real of 16) were dropped:
    # the last real row is patch 39's, not patch 7's
    assert not np.allclose(feats[N - 1], feats[7])

    # the space-to-depth stem gives the same features
    s2d, _, _ = features.run_feature_extraction(
        ds, state_dict_from_flax(variables), batch_size=BATCH, feature_dim=64,
        device="cpu", stem_s2d=True)
    assert isinstance(s2d, np.ndarray) and not isinstance(s2d, np.memmap)
    np.testing.assert_allclose(s2d, jfeats, rtol=0,
                               atol=1e-4 * np.abs(jfeats).max())


@pytest.mark.parametrize("batch", [16, 64, 7])
def test_run_feature_extraction_equals_the_unfolded_step(tmp_path, batch):
    """Any batch size (one larger than the dataset, one that leaves a single
    real row in the last batch... ) gives the rows of the plain route."""
    recs = _write_store(str(tmp_path))
    ds = datasets.PatchDataset(manifest.PatchManifest(recs), resize_to=EDGE)
    state = _randomized_state(42, num_classes=None)
    feats, labels, names = features.run_feature_extraction(
        ds, state, batch_size=batch, feature_dim=64, device="cpu")
    model = ResNet18FeatureExtractor(num_filters=WIDTH)
    model.load_state_dict(state)
    step = features.make_feature_step(model)
    imgs, want_labels = ds.read_batch(range(N))
    ref = step(torch.from_numpy(imgs)).numpy()
    assert feats.shape == ref.shape == (N, 64)
    np.testing.assert_allclose(feats, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    np.testing.assert_array_equal(labels, want_labels)
    assert len(names) == N


def test_run_feature_extraction_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    recs = _write_store(str(tmp_path), n=12)
    ds = datasets.PatchDataset(manifest.PatchManifest(recs), resize_to=EDGE)
    with pytest.raises(RuntimeError, match="cuda"):
        features.run_feature_extraction(ds, _randomized_state(0), device="cuda")
    cfg = config.Config(data=config.DataConfig(data_dir=str(tmp_path)),
                        models_dir=str(tmp_path))
    save_model(str(tmp_path / "resnet18_patch_classifier"), _randomized_state(0))
    with pytest.raises(RuntimeError, match="cuda"):  # the default is the card
        features.extract_features(cfg, dataset=ds)


# ---------------------------------------------------------------------------
# entry points and the CLI
# ---------------------------------------------------------------------------


def _data_root(tmp_path, n=12):
    """``<data_dir>/patches/level_3`` with packed stores and a manifest."""
    pytest.importorskip("jax")
    from ss25_hierarchical_multiscale_image_classification_tpu.data import (
        manifest as jax_manifest,
    )

    data_dir = tmp_path / "data"
    patches_dir = config.DataConfig(data_dir=str(data_dir)).patches_dir
    recs = _write_store(patches_dir, edge=16, n=n)
    jax_manifest.PatchManifest(recs).save(manifest.manifest_path(patches_dir, 3))
    return data_dir, recs


def _reference_features(state, recs):
    """The unfolded float32 forward of the patches as the CLI reads them
    (resized to the default input size)."""
    ds = datasets.PatchDataset(manifest.PatchManifest(recs))
    model = ResNet18FeatureExtractor(num_filters=WIDTH)
    model.load_state_dict({k: v for k, v in state.items()
                           if not k.startswith("fc.")})
    imgs, _ = ds.read_batch(range(len(recs)))
    return features.make_feature_step(model)(torch.from_numpy(imgs)).numpy()


def test_cli_extract_features_on_cpu(tmp_path):
    data_dir, recs = _data_root(tmp_path)
    models_dir = tmp_path / "models"
    state = _randomized_state(43)  # a classifier: the head is stripped
    save_model(str(models_dir / "resnet18_patch_classifier"), state)
    rc = cli.main(["--extract_features", "--data_dir", str(data_dir),
                   "--patch_level", "3", "--batch_size", "8", "--models_dir",
                   str(models_dir), "--device", "cpu"])
    assert rc == 0
    feats, labels, names = features.load_feature_artifacts(
        str(data_dir / "features"), 3)
    assert feats.shape == (12, 64) and feats.dtype == np.float32
    ref = _reference_features(state, recs)
    np.testing.assert_allclose(feats, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    np.testing.assert_array_equal(labels, [r.label for r in recs])
    assert names == [r.patch_name for r in recs]


def test_cli_simclr_features_on_cpu(tmp_path):
    data_dir, recs = _data_root(tmp_path)
    models_dir = tmp_path / "models"
    model = SimCLRModel(generator=torch.Generator().manual_seed(44))
    # narrow encoder under the artifact's ``encoder.`` prefix, as
    # pretrain_simclr writes it, beside projector entries that are ignored
    encoder = _randomized_state(45, num_classes=None)
    sd = {f"encoder.{k}": v for k, v in encoder.items()}
    sd.update({k: v for k, v in model.state_dict().items()
               if k.startswith("projector.")})
    save_model(str(models_dir / "simclr_encoder"), sd)
    rc = cli.main(["--extract_features", "--simclr_features", "--data_dir",
                   str(data_dir), "--batch_size", "8", "--models_dir",
                   str(models_dir), "--device", "cpu"])
    assert rc == 0
    feats, _, names = features.load_feature_artifacts(
        str(data_dir / "features"), 3)
    ref = _reference_features(encoder, recs)
    np.testing.assert_allclose(feats, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    assert len(names) == 12
    # a bare encoder state dict is taken as it is
    save_model(str(models_dir / "bare"), encoder)
    cfg = config.Config(data=config.DataConfig(data_dir=str(data_dir)),
                        models_dir=str(models_dir))
    again = features.extract_features_with_simclr(
        cfg, encoder_path=str(models_dir / "bare"), batch_size=8, device="cpu")
    np.testing.assert_array_equal(np.asarray(again), feats)


def test_cli_extract_features_without_patches_fails(tmp_path):
    rc = cli.main(["--extract_features", "--data_dir", str(tmp_path),
                   "--models_dir", str(tmp_path), "--device", "cpu"])
    assert rc == 1
    assert not os.path.exists(tmp_path / "features")


@pytest.mark.parametrize("argv", [
    ["--extract_features", "--train_mil"],
    ["--extract_features", "--predict_slide", "s.wsi.npz"],
    ["--simclr_features", "--train_mil"],
])
def test_cli_takes_one_action_with_extract_features(argv, capsys, tmp_path):
    """Several actions run in the JAX CLI's order, ``--extract_features``
    first: without patches its gate ends the call with 1 before the next
    action starts. ``--simclr_features`` without ``--extract_features`` is
    ignored, as the JAX CLI ignores it: ``--train_mil`` runs and misses its
    features."""
    argv = argv + ["--device", "cpu", "--data_dir", str(tmp_path / "none"),
                   "--models_dir", str(tmp_path / "models")]
    if "--extract_features" in argv:
        assert cli.main(argv) == 1
        assert not os.path.exists(tmp_path / "none" / "features")
        return
    with pytest.raises(FileNotFoundError, match="patch_features_3.npy"):
        cli.main(argv)
    assert "usage:" not in capsys.readouterr().err


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("stem_s2d", [False, True])
def test_run_feature_extraction_on_the_card(cuda_device, tmp_path, stem_s2d):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    recs = _write_store(str(tmp_path), edge=224, n=N)
    ds = datasets.PatchDataset(manifest.PatchManifest(recs))
    state = _randomized_state(46, num_filters=64, num_classes=None)
    ref, _, _ = features.run_feature_extraction(
        ds, state, batch_size=BATCH, dtype=torch.float32, device="cpu",
        stem_s2d=stem_s2d)
    kernel = fs.fused_stem_kernel if stem_s2d else fs.bias_relu_pool_kernel
    other = fs.bias_relu_pool_kernel if stem_s2d else fs.fused_stem_kernel
    before, other_before = kernel.launches, other.launches
    feats, labels, names = features.run_feature_extraction(
        ds, state, batch_size=BATCH, dtype=torch.float32, device=cuda_device,
        stem_s2d=stem_s2d)
    assert kernel.launches == before + 3 and other.launches == other_before
    assert feats.shape == (N, 512) and len(names) == N
    assert np.abs(feats - ref).max() <= 1e-3 * np.abs(ref).max()
    feats16, _, _ = features.run_feature_extraction(
        ds, state, batch_size=BATCH, device=cuda_device, stem_s2d=stem_s2d)
    assert np.abs(feats16 - ref).max() <= 0.05 * np.abs(ref).max()
