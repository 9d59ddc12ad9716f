"""The multiscale slice's host copies and model against the JAX package.

- ``data/multiscale.py`` (``join_levels``, ``MultiscaleDataset.read_batch``
  in both input modes, ``labels``, ``batches``, ``split_by_slide``), the
  patch store's ``resize_batch`` and ``evaluation/calibration.py``'s combine
  codes are copies: equal results, exactly.
- the patch store's numpy ``INTER_AREA`` at the factors 2, 3, 4 and 8
  (``area_downscale``) equals ``cv2.resize(…, INTER_AREA)`` bit for bit, on
  random blocks and on blocks that sum to rounding ties, and the resize
  mode reads 448², 896² and 1792² stores with cv2 made unimportable.
- ``HierarchicalPatchClassifier`` in float32 on the CPU against the flax
  module with the same converted weights, both fusions, with and without
  aux heads: logits within 1e-4 of max|logit|, a bound that allows for the
  two frameworks summing the trunk's convolutions in different orders in
  float32. The trunk's BN statistics are drawn from a seed, so that cells
  differ, and the test checks that each level moves the logits.
- ``_combine_scores``: float32 element-wise arithmetic on both sides,
  within 1e-6 relative (XLA may contract a product and a sum into one FMA).
- the weight export: ``hierarchical_state_dict_from_flax``, the ``.pt``
  round trip with the calibration, and the export script on an Orbax
  artifact.

JAX is imported inside the tests that compare with it.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
    manifest,
    multiscale,
    patch_store,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation import (
    calibration,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer import (
    multiscale as pms,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    CALIBRATION_PREFIX,
    hierarchical_from_state_dict,
    hierarchical_state_dict_from_flax,
    split_calibration,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.hierarchical import (
    HierarchicalPatchClassifier,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
    load_model,
    save_model,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = 1e-4  # of max|logit|
COMBINE_RTOL = 1e-6


def randomized_hierarchical(jax, fusion="concat", aux=True, seed=0,
                            levels=(2, 3), size=64):
    """flax init of the JAX ``HierarchicalPatchClassifier`` (float32), then
    the trunk's BN scale, bias, mean and variance drawn from numpy."""
    import jax.numpy as jnp

    from ss25_hierarchical_multiscale_image_classification_tpu.models.hierarchical import (
        HierarchicalPatchClassifier as JaxHierarchical,
    )

    model = JaxHierarchical(levels=levels, fusion=fusion, dtype=jnp.float32)
    init = {lvl: jnp.zeros((1, size, size, 3), jnp.float32) for lvl in levels}
    variables = model.init(jax.random.key(seed), init, train=False,
                           with_aux=aux)
    rng = np.random.default_rng(seed)
    draw = {
        "scale": lambda s: rng.uniform(0.5, 1.5, s),
        "bias": lambda s: rng.normal(0.0, 0.1, s),
        "mean": lambda s: rng.normal(0.0, 0.5, s),
        "var": lambda s: rng.uniform(0.5, 2.0, s),
    }

    def walk(tree, in_norm):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v, in_norm or "norm" in k.lower()
                              or k.startswith("BatchNorm"))
            elif in_norm and k in draw:
                out[k] = draw[k](np.shape(v)).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return model, {"params": walk(variables["params"], False),
                   "batch_stats": walk(variables["batch_stats"], True)}


def _images(seed, levels=(2, 3), b=3, size=64):
    rng = np.random.default_rng(seed)
    return {lvl: rng.normal(0.0, 1.0, (b, size, size, 3)).astype(np.float32)
            for lvl in levels}


# ---------------------------------------------------------------------------
# combine codes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value", [
    0, 1, 2, 3, 4, 2.0, np.float64(3.0), np.array(1), "ensemble", "aux",
    "aux_fine", "ensemble_fine",
])
def test_combine_codes_equal_jax(value):
    pytest.importorskip("jax")
    from ss25_hierarchical_multiscale_image_classification_tpu.evaluation import (
        calibration as jcal,
    )

    assert calibration.COMBINE_MODES == jcal.COMBINE_MODES == pms.COMBINE_COLUMNS
    assert calibration._LEGACY_COMBINE == jcal._LEGACY_COMBINE
    assert calibration.decode_combine(value) == jcal.decode_combine(value)
    mode = calibration.decode_combine(value)
    assert calibration.encode_combine(mode) == jcal.encode_combine(mode)
    # a code stored as a 0-d float64 tensor (the port's artifact) decodes too
    if not isinstance(value, str):
        t = torch.tensor(float(np.asarray(value)), dtype=torch.float64)
        assert calibration.decode_combine(float(t)) == mode


# ---------------------------------------------------------------------------
# data/multiscale.py
# ---------------------------------------------------------------------------


def _store(tmp_path, slides=("normal_001", "tumor_002"), seed=0):
    """Packed stores at levels 2 (64-px patches) and 3 (32-px patches) whose
    cells align on level-0 origins, with cells missing at either level and
    one level-2 cell at half stride; the same records as port and JAX
    manifests."""
    pytest.importorskip("jax")
    from ss25_hierarchical_multiscale_image_classification_tpu.data.manifest import (
        PatchManifest as JaxManifest,
        PatchRecord as JaxRecord,
    )

    rng = np.random.default_rng(seed)
    patches_dir = str(tmp_path / "patches")
    recs = {2: [], 3: []}
    for s, slide in enumerate(slides):
        for lvl, edge in ((2, 64), (3, 32)):
            cells = [(i, j) for i in range(4) for j in range(3)
                     if (i + j + s + lvl) % 5]  # a few cells missing
            coords = np.array([(i * edge, j * edge) for i, j in cells])
            if lvl == 2:  # a half-stride cell: it pairs with nothing
                coords = np.concatenate([coords, [[edge // 2, 0]]])
            w = patch_store.PackedPatchWriter(patches_dir, lvl, slide, edge)
            recs[lvl] += w.write_batch(
                rng.integers(0, 256, (len(coords), edge, edge, 3),
                             dtype=np.uint8),
                coords, rng.integers(0, 2, len(coords)))
            w.close()
    port = {lvl: manifest.PatchManifest(r) for lvl, r in recs.items()}
    jax_m = {lvl: JaxManifest([JaxRecord(**vars(x)) for x in r])
             for lvl, r in recs.items()}
    return port, jax_m


def test_join_levels_equals_jax(tmp_path):
    from ss25_hierarchical_multiscale_image_classification_tpu.data.multiscale import (
        join_levels as jax_join,
    )

    port, jax_m = _store(tmp_path)
    got = multiscale.join_levels(port)
    want = jax_join(jax_m)
    assert 10 < len(got) < len(port[3])
    assert [(s.slide, s.cell, s.indices, s.label) for s in got] == \
        [(s.slide, s.cell, s.indices, s.label) for s in want]
    for s in got:
        assert s.cell[0] == port[2][s.indices[2]].x * 4 == port[3][s.indices[3]].x * 8


@pytest.mark.parametrize("input_mode,resize_to", [
    ("crop", 32), ("resize", 32), ("crop", 48), ("resize", 16),
])
def test_read_batch_equals_jax_bytes(tmp_path, input_mode, resize_to):
    """``crop`` takes the level-2 center at native size (or resizes a stored
    patch smaller than the input size); ``resize`` box-resizes (cv2
    ``INTER_AREA``). The base level is never cropped."""
    pytest.importorskip("cv2")
    from ss25_hierarchical_multiscale_image_classification_tpu.data.multiscale import (
        MultiscaleDataset as JaxDataset,
    )

    port, jax_m = _store(tmp_path)
    ds = multiscale.MultiscaleDataset(port, resize_to=resize_to,
                                      input_mode=input_mode)
    jds = JaxDataset(jax_m, resize_to=resize_to, input_mode=input_mode)
    idx = [0, 5, 3, len(ds) - 1, 5]
    got, labels = ds.read_batch(idx)
    want, jlabels = jds.read_batch(idx)
    np.testing.assert_array_equal(labels, jlabels)
    for lvl in (2, 3):
        assert got[lvl].shape == (len(idx), resize_to, resize_to, 3)
        assert got[lvl].flags.c_contiguous
        np.testing.assert_array_equal(got[lvl], want[lvl])
    np.testing.assert_array_equal(ds.labels, jds.labels)


def test_batches_and_split_equal_jax(tmp_path):
    from ss25_hierarchical_multiscale_image_classification_tpu.data.multiscale import (
        MultiscaleDataset as JaxDataset,
    )

    port, jax_m = _store(tmp_path)
    ds = multiscale.MultiscaleDataset(port, resize_to=32, input_mode="crop")
    jds = JaxDataset(jax_m, resize_to=32, input_mode="crop")
    for shuffle in (False, True):
        got = list(ds.batches(4, shuffle=shuffle, seed=3))
        want = list(jds.batches(4, shuffle=shuffle, seed=3))
        assert len(got) == len(want) > 2
        for (gi, gl, gv), (wi, wl, wv) in zip(got, want):
            np.testing.assert_array_equal(gl, wl)
            np.testing.assert_array_equal(gv, wv)
            for lvl in (2, 3):
                np.testing.assert_array_equal(gi[lvl], wi[lvl])
    assert got[-1][2].sum() < 4  # the wrap-padded last batch
    for fraction, seed in ((0.2, 42), (0.5, 1)):
        for a, b in zip(ds.split_by_slide(fraction, seed),
                        jds.split_by_slide(fraction, seed)):
            np.testing.assert_array_equal(a, b)
    one, jone = _store(tmp_path / "one", slides=("tumor_009",))
    ds1 = multiscale.MultiscaleDataset(one, resize_to=32, input_mode="crop")
    jds1 = JaxDataset(jone, resize_to=32, input_mode="crop")
    for a, b in zip(ds1.split_by_slide(), jds1.split_by_slide()):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        multiscale.MultiscaleDataset(port, input_mode="zoom")


def test_resize_batch_equals_jax():
    pytest.importorskip("cv2")
    from ss25_hierarchical_multiscale_image_classification_tpu.data.patch_store import (
        resize_batch as jax_resize_batch,
    )

    x = np.random.default_rng(5).integers(0, 256, (3, 64, 64, 3),
                                          dtype=np.uint8)
    for edge in (64, 32, 48, 96):
        np.testing.assert_array_equal(patch_store.resize_batch(x, edge),
                                      jax_resize_batch(x, edge))
    assert patch_store.resize_batch(x, 64) is x


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fusion", ["concat", "attention"])
@pytest.mark.parametrize("aux", [True, False], ids=["aux", "no_aux"])
def test_hierarchical_classifier_matches_flax(fusion, aux):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    jmodel, variables = randomized_hierarchical(jax, fusion, aux, seed=11)
    sd = hierarchical_state_dict_from_flax(variables)
    port = hierarchical_from_state_dict(sd, (2, 3))
    assert port.fusion == fusion and (port.aux_head is not None) == aux
    x = _images(12)
    out = jmodel.apply(variables, {k: jnp.asarray(v) for k, v in x.items()},
                       train=False, with_aux=aux)
    ref, ref_aux = (out if aux else (out, None))
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in x.items()},
                   with_aux=aux)
    logits, got_aux = got if aux else (got, None)
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    assert logits.dtype == torch.float32 and logits.shape == (3, 2)
    np.testing.assert_allclose(logits.numpy(), ref, rtol=0,
                               atol=LOGIT_TOL * scale)
    if aux:
        ref_aux = np.asarray(ref_aux)
        assert got_aux.shape == (3, 2, 2)
        np.testing.assert_allclose(got_aux.numpy(), ref_aux, rtol=0,
                                   atol=LOGIT_TOL * np.abs(ref_aux).max())
    # each level moves the logits: a forward that dropped one would show
    for lvl in (2, 3):
        moved = dict(x)
        moved[lvl] = _images(13)[lvl]
        with torch.no_grad():
            other = port({k: torch.from_numpy(v) for k, v in moved.items()})
        assert (other - logits).abs().max() > 100 * LOGIT_TOL * scale
    with pytest.raises(ValueError, match="expected levels"):
        port({2: torch.from_numpy(x[2])})


def test_fuse_and_aux_heads_match_flax_on_features():
    """The heads alone on (B, S, 512) features (the int8 path's route), and
    the cascade screen's base-level aux head."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from ss25_hierarchical_multiscale_image_classification_tpu.infer.multiscale import (
        _base_aux_from_feats,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu.models.hierarchical import (
        HierarchicalPatchClassifier as JaxHierarchical,
    )

    for fusion in ("concat", "attention"):
        jmodel, variables = randomized_hierarchical(jax, fusion, True, seed=21)
        port = hierarchical_from_state_dict(
            hierarchical_state_dict_from_flax(variables))
        feats = np.random.default_rng(22).uniform(0, 3, (5, 2, 512)).astype(
            np.float32)
        with torch.no_grad():
            f = torch.from_numpy(feats)
            got = (port.fuse(f), port.aux_logits(f), port.base_aux_logits(f[:, 1]))
        want = (jmodel.apply(variables, jnp.asarray(feats),
                             method=JaxHierarchical.fuse),
                jmodel.apply(variables, jnp.asarray(feats),
                             method=JaxHierarchical.aux_logits),
                jmodel.apply(variables, jnp.asarray(feats[:, 1]),
                             method=_base_aux_from_feats))
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())


def test_seeded_init_and_inference_cast():
    a = HierarchicalPatchClassifier(fusion="attention",
                                    generator=torch.Generator().manual_seed(3))
    b = HierarchicalPatchClassifier(fusion="attention",
                                    generator=torch.Generator().manual_seed(3))
    for (k, v), (_, w) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(v, w), k
    assert a.scale_embed.shape == (2, 512)
    assert 0.01 < float(a.scale_embed.detach().std()) < 0.03
    assert a.attn_w.bias is None
    a.for_inference("cpu", torch.bfloat16)
    assert a.dtype == torch.bfloat16 and a.scale_embed.dtype == torch.float32
    assert a.trunk.conv1.weight.dtype == torch.bfloat16
    with torch.no_grad():
        out = a({lvl: torch.zeros(2, 32, 32, 3) for lvl in (2, 3)})
    assert out.dtype == torch.float32
    with pytest.raises(ValueError):
        HierarchicalPatchClassifier(fusion="sum")
    with pytest.raises(ValueError, match="no aux heads"):
        HierarchicalPatchClassifier(aux=False).aux_logits(torch.zeros(1, 2, 512))


# ---------------------------------------------------------------------------
# _combine_scores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_aux,levels", [(False, 2), (True, 2), (True, 3)])
def test_combine_scores_equal_jax(with_aux, levels):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from ss25_hierarchical_multiscale_image_classification_tpu.infer.multiscale import (
        _combine_scores as jax_combine,
    )

    rng = np.random.default_rng(levels)
    logits = rng.normal(0, 4, (37, 2)).astype(np.float32)
    aux = rng.normal(0, 4, (37, levels, 2)).astype(np.float32) if with_aux else None
    args = (1.7, 1.3, 0.35, 0.8)
    want = np.asarray(jax_combine(jnp.asarray(logits),
                                  None if aux is None else jnp.asarray(aux),
                                  *args))
    got = pms._combine_scores(torch.from_numpy(logits),
                              None if aux is None else torch.from_numpy(aux),
                              *args).numpy()
    assert got.shape == want.shape == (37, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=COMBINE_RTOL, atol=1e-6)
    if not with_aux:
        assert (got == got[:, :1]).all()
    # the base level is aux column -1
    if with_aux:
        base = (aux[:, -1, 1] - aux[:, -1, 0]) / np.float32(1.3)
        np.testing.assert_allclose(got[:, 3], base, rtol=COMBINE_RTOL)


# ---------------------------------------------------------------------------
# the weight export
# ---------------------------------------------------------------------------


def test_hierarchical_state_dict_round_trip(tmp_path):
    jax = pytest.importorskip("jax")
    _, variables = randomized_hierarchical(jax, "attention", True, seed=31)
    variables["calibration"] = {"temperature": 1.25, "combine": "aux_fine",
                                "input_mode": 1, "cascade_margin": -0.5,
                                "ensemble_weight": np.float32(0.3)}
    sd = hierarchical_state_dict_from_flax(variables)
    assert sd["attn_v.weight"].shape == (256, 512)
    assert sd["head_hidden.weight"].shape == (256, 512)
    np.testing.assert_array_equal(
        sd["head_out.weight"].numpy(),
        np.asarray(variables["params"]["head_out"]["kernel"]).T)
    np.testing.assert_array_equal(sd["scale_embed"].numpy(),
                                  variables["params"]["scale_embed"])
    cal = {k: v for k, v in sd.items() if k.startswith(CALIBRATION_PREFIX)}
    assert all(v.dtype == torch.float64 and v.dim() == 0 for v in cal.values())
    save_model(str(tmp_path / "hierarchical_classifier"), sd)
    state, got = split_calibration(load_model(str(tmp_path / "hierarchical_classifier")))
    assert got == {"temperature": 1.25, "combine": 3.0, "input_mode": 1.0,
                   "cascade_margin": -0.5,
                   "ensemble_weight": float(np.float32(0.3))}
    assert calibration.decode_combine(got["combine"]) == "aux_base"
    model = hierarchical_from_state_dict(state)
    assert model.fusion == "attention"
    with pytest.raises(ValueError, match="scales"):
        hierarchical_from_state_dict(state, levels=(1, 2, 3))


def test_export_script_writes_a_hierarchical_artifact(tmp_path):
    pytest.importorskip("jax")
    import jax

    from ss25_hierarchical_multiscale_image_classification_tpu.train.checkpoints import (
        save_model as jax_save_model,
    )

    _, variables = randomized_hierarchical(jax, "concat", True, seed=41)
    variables["calibration"] = {"temperature": 2.0, "combine": 1,
                                "input_mode": 0}
    src = str(tmp_path / "hierarchical_classifier")
    jax_save_model(src, variables)
    spec = importlib.util.spec_from_file_location(
        "export_jax_checkpoint_to_torch",
        os.path.join(REPO, "scripts", "export_jax_checkpoint_to_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.main([src]) == 0
    state, cal = split_calibration(load_model(src))
    assert cal == {"temperature": 2.0, "combine": 1.0, "input_mode": 0.0}
    want = hierarchical_state_dict_from_flax(variables)
    for k, v in state.items():
        assert torch.equal(v, want[k]), k
    hierarchical_from_state_dict(state)


# ---------------------------------------------------------------------------
# size limits the reference does not have (the kernels' limits stay on the
# card)
# ---------------------------------------------------------------------------


def _stage1_operands(seed, shape):
    """Stage-1 operands over the int8 range, scales that spread the outputs
    over it (as ``tests/test_torch_port_int8.py`` draws them)."""
    rng = np.random.default_rng(seed)
    xq = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
    kernels = torch.from_numpy(
        rng.integers(-127, 128, (4, 3, 3, 64, 64)).astype(np.int8))
    mscales = torch.from_numpy(rng.uniform(1e-4, 3e-4, (4, 64)).astype(np.float32))
    biases = torch.from_numpy(rng.normal(0, 0.5, (4, 64)).astype(np.float32))
    scalars = torch.from_numpy(rng.uniform(0.02, 0.05, 5).astype(np.float32))
    return xq, kernels, mscales, biases, scalars


@pytest.mark.parametrize("plane,route", [
    ((56, 56), "block"), ((63, 63), "block"), ((64, 64), "convs"),
    ((112, 112), "convs"), ((8, 217), "block"), ((8, 218), "convs"),
])
def test_stage1_route_takes_the_convs_where_no_cluster_holds_the_plane(
        plane, route):
    """A CUDA plane that 8 blocks cannot hold (64 × 64, a 256² input, and
    up) runs stage 1 as four exact ``int8_conv_requant`` launches; the
    route is decided by the shape. On the CPU the convs' route is the
    plain version's loop, exactly."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops import (
        int8_block as ib,
    )

    assert ib.stage1_route(*plane) == route
    if route == "block":
        assert ib.cluster_plan(*plane)[0] <= ib.MAX_CLUSTER
    else:
        with pytest.raises(ValueError):
            ib.cluster_plan(*plane)
    if plane == (64, 64):
        ops = _stage1_operands(3, (2, 64, 64, 64))
        want = ib.fused_stage1_int8_reference(*ops)
        assert torch.equal(ib.fused_stage1_int8_convs(*ops), want)
        assert torch.equal(ib.fused_stage1_int8(*ops), want)
        assert 0 < int((want != 0).sum()) < want.numel()


def test_augment_on_the_cpu_takes_any_size():
    """S = 800, above the card kernel's 773: a CPU tensor takes the plain
    ``augment_batch``, as the JAX function computes any S."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
        augment,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.augment import (
        MAX_SIZE,
        augment_batch_kernel,
    )

    assert MAX_SIZE == 773
    imgs = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (2, 800, 800, 3), dtype=np.uint8))
    params = augment.sample_augment_params(
        torch.Generator().manual_seed(5), 2)
    before = augment_batch_kernel.launches
    out = augment_batch_kernel(params, imgs)
    assert augment_batch_kernel.launches == before
    assert torch.equal(out, augment.augment_batch(params, imgs))
    assert out.shape == (2, 800, 800, 3) and out.dtype == torch.float32


def test_nt_xent_on_the_cpu_takes_any_width():
    """D = 4100, above the kernels' 4096: the plain version computes the
    loss and its gradient on the CPU, equal to the JAX dense loss."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from ss25_hierarchical_multiscale_image_classification_tpu.models.simclr import (
        nt_xent_loss,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.nt_xent import (
        MAX_D,
        nt_xent_loss_kernel,
    )

    rng = np.random.default_rng(6)
    zi, zj = (rng.normal(size=(9, MAX_D + 4)).astype(np.float32)
              for _ in range(2))
    ref, (gi, gj) = jax.value_and_grad(
        lambda a, b: nt_xent_loss(a, b, 0.5), argnums=(0, 1))(
            jnp.asarray(zi), jnp.asarray(zj))
    ti, tj = (torch.from_numpy(z).requires_grad_() for z in (zi, zj))
    loss = nt_xent_loss_kernel(ti, tj, 0.5)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(gi), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(tj.grad.numpy(), np.asarray(gj), rtol=1e-4,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# F8: the host INTER_AREA without cv2 (the card's machine has none)
# ---------------------------------------------------------------------------


def _area_input(f, edge, b, ties, seed):
    """(b, f·edge, f·edge, 3) uint8; with ``ties`` every f × f block sums to
    a rounding tie (s ≡ f²/2 mod f²; at f = 3, where none exists, to s ≡ 4
    mod 9, the nearest), else uniform random."""
    rng = np.random.default_rng(seed)
    if not ties:
        return rng.integers(0, 256, (b, f * edge, f * edge, 3), dtype=np.uint8)
    a = f * f
    x = rng.integers(0, 256 - a, (b, edge, f, edge, f, 3)).astype(np.int64)
    target = a // 2 if f % 2 == 0 else 4
    x[:, :, f - 1, :, f - 1] += (target - x.sum(axis=(2, 4))) % a
    x = x.astype(np.uint8).reshape(b, f * edge, f * edge, 3)
    assert (area_sums(x, f) % a == target).all()
    return x


def area_sums(x, f):
    b, h, w, c = x.shape
    return x.reshape(b, h // f, f, w // f, f, c).sum(axis=(2, 4), dtype=np.int64)


def _cv2_area(x, edge):
    import cv2

    return np.stack([cv2.resize(img, (edge, edge), interpolation=cv2.INTER_AREA)
                     for img in x])


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("f", [2, 3, 4, 8])
def test_area_downscale_equals_cv2_inter_area(f, ties):
    """Bit for bit, tie blocks included: cv2 rounds half up at f = 2 and
    half to even at 4 and 8; a wrong rule changes thousands of pixels."""
    pytest.importorskip("cv2")
    edge = 28 if f == 8 else 56
    x = _area_input(f, edge, 3, ties, seed=10 * f + ties)
    want = _cv2_area(x, edge)
    got = patch_store.area_downscale(x, f)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(patch_store.resize_batch(x, edge), want)
    np.testing.assert_array_equal(patch_store._resize(x[1], edge), want[1])
    if ties and f in (2, 4, 8):  # the other rule would differ here
        s = area_sums(x, f)
        other = (np.rint(s / (f * f)) if f == 2
                 else (s + f * f // 2) // (f * f)).astype(np.uint8)
        assert (other != want).mean() > 0.2


def _two_level_store(tmp_path, fine_level, edge_fine, seed):
    """Two cells at ``fine_level`` (patches ``edge_fine``²) and at level 3
    (224²), aligned on level-0 origins, as port manifests."""
    rng = np.random.default_rng(seed)
    patches_dir = str(tmp_path / "patches")
    m = {}
    for lvl, edge in ((fine_level, edge_fine), (3, 224)):
        w = patch_store.PackedPatchWriter(patches_dir, lvl, "slide", edge)
        coords = np.array([[0, 0], [edge, 0]])
        m[lvl] = manifest.PatchManifest(w.write_batch(
            rng.integers(0, 256, (2, edge, edge, 3), dtype=np.uint8), coords,
            np.array([0, 1])))
        w.close()
    return m


@pytest.mark.parametrize("fine_level,edge", [(2, 448), (1, 896), (0, 1792)])
def test_resize_mode_reads_pyramid_stores_without_cv2(tmp_path, monkeypatch,
                                                      fine_level, edge):
    """``MultiscaleDataset("resize")`` and ``resize_batch`` read 448², 896²
    and 1792² stores at 224 on a machine without cv2, equal to cv2's
    ``INTER_AREA`` of the same patches."""
    pytest.importorskip("cv2")
    m = _two_level_store(tmp_path, fine_level, edge, seed=edge)
    raw = patch_store.PatchReader(m[fine_level]).read_batch([0, 1])
    want = _cv2_area(raw, 224)
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2  # noqa: F401
    ds = multiscale.MultiscaleDataset(m, resize_to=224, input_mode="resize")
    got, labels = ds.read_batch([1, 0])
    np.testing.assert_array_equal(got[fine_level], want[::-1])
    np.testing.assert_array_equal(labels, [1, 0])
    np.testing.assert_array_equal(patch_store.resize_batch(raw, 224), want)
    # a size that is no integer factor still needs cv2
    with pytest.raises(ImportError):
        patch_store.resize_batch(raw, 200)


def test_quantize_multiscale_reads_a_resize_store_without_cv2(tmp_path,
                                                              monkeypatch):
    """``--quantize --multiscale`` of a resize-mode artifact calibrates on a
    448²/224² store on a machine without cv2."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        Config,
        DataConfig,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models import (
        quant_artifact as qa,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        hierarchical_artifact,
    )

    m = _two_level_store(tmp_path, 2, 448, seed=7)
    data = DataConfig(data_dir=str(tmp_path))
    for lvl, man in m.items():
        man.save(manifest.manifest_npz_path(data.patches_dir, lvl))
    models = tmp_path / "models"
    model = HierarchicalPatchClassifier(
        generator=torch.Generator().manual_seed(3))
    save_model(str(models / "hierarchical_classifier"),
               hierarchical_artifact(model.state_dict(), {"input_mode": 0}))
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    path = qa.quantize_trunk_to_artifact(
        Config(data=data, models_dir=str(models)), levels=(2, 3),
        device="cpu")
    tree = qa.load_quantized(path)
    assert qa.artifact_input_hw(tree) == (224, 224)
    assert set(tree["ascales"]) >= {"in", "p0", "s4b1o"}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 64, 64, 64), (2, 70, 66, 64)])
def test_stage1_convs_route_is_exact_on_the_card(cuda_device, shape):
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops import (
        int8_block as ib,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops import (
        int8_conv as ic,
    )

    ops = _stage1_operands(7, shape)
    want = ib.fused_stage1_int8_reference(*ops)
    before = (ic.int8_conv_requant_kernel.launches,
              ib.fused_stage1_int8_kernel.launches)
    got = ib.fused_stage1_int8(*(t.to(cuda_device) for t in ops))
    assert (ic.int8_conv_requant_kernel.launches,
            ib.fused_stage1_int8_kernel.launches) == (before[0] + 4, before[1])
    assert torch.equal(got.cpu(), want)
