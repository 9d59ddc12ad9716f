"""Port ResNet18 and weight conversion against the JAX package.

Weights travel JAX → port through ``state_dict_from_flax``; the same numpy
inputs go through the JAX ``ResNet18Classifier(dtype=float32).apply`` and
the port's model, in float32 on the CPU. BN scale, bias and running
statistics are randomized first, so every converted tensor moves the output.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu.models.resnet import (
    ResNet18Classifier as JaxResNet18Classifier,
)
from ss25_hierarchical_multiscale_image_classification_tpu.models.resnet import (
    ResNet18FeatureExtractor as JaxResNet18FeatureExtractor,
)
from ss25_hierarchical_multiscale_image_classification_tpu.models.torch_import import (
    from_torch_state_dict,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
    resolve_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    load_state_dict_file,
    resnet18_from_state_dict,
    state_dict_from_flax,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
    ResNet18Classifier,
    ResNet18FeatureExtractor,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def randomized_variables(model, seed, size=32):
    """flax init, then BN scale/bias/mean/var drawn from numpy."""
    variables = model.init(jax.random.key(seed), jnp.zeros((1, size, size, 3)),
                           train=False)
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


@pytest.mark.parametrize("head", [True, False])
def test_resnet18_matches_jax(head):
    jax_cls = JaxResNet18Classifier if head else JaxResNet18FeatureExtractor
    jmodel = jax_cls(dtype=jnp.float32, num_filters=8)
    variables = randomized_variables(jmodel, seed=3)
    x = np.random.default_rng(4).normal(size=(4, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))

    sd = state_dict_from_flax(variables)
    assert ("fc.weight" in sd) == head
    port = ResNet18Classifier(num_filters=8) if head else ResNet18FeatureExtractor(num_filters=8)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert out.dtype == torch.float32
    assert out.shape == ((4, 2) if head else (4, 64))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-3, atol=2e-4)

    # the shape-inferring loader builds the same model
    with torch.no_grad():
        again = resnet18_from_state_dict(sd)(torch.from_numpy(x))
    np.testing.assert_array_equal(again.numpy(), out.numpy())


def test_state_dict_round_trip_through_flax_layout():
    """torchvision-layout state dict → JAX ``from_torch_state_dict`` →
    ``state_dict_from_flax`` gives back every tensor, bit for bit."""
    g = torch.Generator().manual_seed(5)
    model = ResNet18Classifier(num_filters=8, generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
    sd = model.state_dict()
    back = state_dict_from_flax(from_torch_state_dict(sd))
    expect = {k: v for k, v in sd.items() if "num_batches_tracked" not in k}
    assert back.keys() == expect.keys()
    for k, v in expect.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_init_is_seeded_by_the_generator_only():
    a = ResNet18Classifier(num_filters=8, generator=torch.Generator().manual_seed(1))
    torch.manual_seed(123)  # the global generator plays no part
    b = ResNet18Classifier(num_filters=8, generator=torch.Generator().manual_seed(1))
    c = ResNet18Classifier(num_filters=8, generator=torch.Generator().manual_seed(2))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["conv1.weight"], sc["conv1.weight"])


def test_load_state_dict_file_strips_dataparallel_prefix(tmp_path):
    sd = ResNet18Classifier(num_filters=8).state_dict()
    path = str(tmp_path / "ckpt.pth")
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    loaded = load_state_dict_file(path)
    assert loaded.keys() == sd.keys()
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)


def test_export_script_round_trips_an_orbax_artifact(tmp_path):
    from ss25_hierarchical_multiscale_image_classification_tpu.train.checkpoints import (
        save_model,
    )

    jmodel = JaxResNet18Classifier(dtype=jnp.float32, num_filters=8)
    variables = randomized_variables(jmodel, seed=6)
    src = str(tmp_path / "resnet18_patch_classifier")
    save_model(src, variables)

    spec = importlib.util.spec_from_file_location(
        "export_jax_checkpoint_to_torch",
        os.path.join(REPO, "scripts", "export_jax_checkpoint_to_torch.py"),
    )
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.main([src]) == 0

    loaded = load_state_dict_file(src + ".pt")
    expect = state_dict_from_flax(variables)
    assert loaded.keys() == expect.keys()
    assert all(torch.equal(loaded[k], expect[k]) for k in expect)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
