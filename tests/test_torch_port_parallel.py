"""The port's parallel layer against one process and against the JAX package.

``parallel/mesh.py``'s shape rules and errors are the JAX ``make_mesh``'s
(the cases of ``tests/test_parallel.py``); ``parallel/feed.py`` cuts a
global batch as the JAX ``process_batch_slice`` does. The collectives run in
2 and 4 spawned gloo processes (``torch_port_workers.py``) on a global batch
of 8 whose last two rows are wrap padding, and each rank's results are held
to the same function in one process on the whole batch (world 1) and to the
JAX function on the global batch (flax BatchNorm; ``nt_xent_loss`` and
``sharded_attention_pool`` with their ``axis_name`` under ``shard_map`` on a
4-device mesh of the conftest's 8 CPU devices).

Tolerances: float32 sums over ranks run in another order than one sum over
the batch, so world W is held to world 1 at 1e-5 relative (of a tensor's
largest magnitude); the gather is exact (a sum with zeros).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

from ss25_hierarchical_multiscale_image_classification_tpu.models.mil import (
    sharded_attention_pool as jax_sharded_attention_pool,
)
from ss25_hierarchical_multiscale_image_classification_tpu.models.simclr import (
    nt_xent_loss as jax_nt_xent_loss,
)
from ss25_hierarchical_multiscale_image_classification_tpu.parallel import (
    mesh as jax_mesh_mod,
)
from ss25_hierarchical_multiscale_image_classification_tpu.parallel.feed import (
    process_batch_slice as jax_process_batch_slice,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.mil import (
    sharded_attention_pool,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel import (
    feed,
    mesh,
)

import torch_port_workers as workers

torch.set_num_threads(2)

RTOL = 1e-5  # of the tensor's largest magnitude: float32 sums over ranks


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, (
        np.abs(got - want).max() / scale)


# ---------------------------------------------------------------------------
# mesh shapes, errors, feeding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,names,shape", [
    (8, ("data",), None), (8, ("group", "data"), (2, 4)),
    (8, ("group", "data"), (-1, 4)), (8, ("group", "data"), (4, -1)),
    (4, ("group", "data"), (-1, 1)), (6, ("a", "b", "c"), (1, -1, 2)),
])
def test_mesh_shape_equals_jax_make_mesh(n, names, shape):
    devices = jax.devices()[:n]
    want = jax_mesh_mod.make_mesh(devices=devices, axis_names=names,
                                  shape=shape)
    got = mesh.make_mesh(devices=list(range(n)), axis_names=names,
                         shape=shape)
    assert got.devices.shape == want.devices.shape
    assert got.axis_names == want.axis_names == tuple(names)
    # the same row-major layout of the members
    ids = np.vectorize(lambda d: devices.index(d))(want.devices)
    np.testing.assert_array_equal(got.devices.astype(int), ids)


@pytest.mark.parametrize("names,shape", [
    (("a", "b"), None), (("a", "b"), (3, 4)), (("a", "b"), (-1, -1)),
    (("a", "b"), (-1, 3)), (("a",), (4, 2)),
])
def test_mesh_shape_errors_equal_jax(names, shape):
    with pytest.raises(ValueError) as want:
        jax_mesh_mod.make_mesh(axis_names=names, shape=shape)
    with pytest.raises(ValueError) as got:
        mesh.make_mesh(devices=list(range(8)), axis_names=names, shape=shape)
    assert str(got.value) == str(want.value)


def test_group_submeshes_rows_and_error():
    m = mesh.make_mesh(devices=list(range(8)), axis_names=("group", "data"),
                       shape=(2, 4))
    subs = mesh.group_submeshes(m)
    assert [list(s.devices) for s in subs] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert all(s.axis_names == ("data",) and s.group is None for s in subs)
    with pytest.raises(ValueError) as got:
        mesh.group_submeshes(mesh.make_mesh(devices=list(range(8))))
    with pytest.raises(ValueError) as want:
        jax_mesh_mod.group_submeshes(jax_mesh_mod.make_mesh())
    assert str(got.value) == str(want.value)


def test_make_mesh_without_a_group_is_one_rank():
    m = mesh.make_mesh()
    assert m.devices.shape == (1,) and m.devices[0] == 0 and m.group is None
    assert mesh.rank_and_size(None) == (0, 1) and mesh.is_main(None)
    mesh.barrier(None)  # nothing to wait for


@pytest.mark.parametrize("bs,world", [(64, 1), (64, 4), (8, 2), (12, 3)])
def test_process_batch_slice_covers_the_batch(bs, world):
    slices = [feed.process_batch_slice(bs, r, world) for r in range(world)]
    assert [s.start for s in slices] == list(range(0, bs, bs // world))
    assert slices[-1].stop == bs
    if world == 1:  # the JAX function of a single process
        assert slices[0] == jax_process_batch_slice(bs)


def test_process_batch_slice_raises_on_a_remainder():
    with pytest.raises(ValueError, match="not divisible by 4 processes"):
        feed.process_batch_slice(10, 0, 4)


def test_feed_global_batch_and_shard_batch_on_the_cpu():
    imgs = np.arange(8 * 2, dtype=np.float32).reshape(8, 2)
    labels = np.arange(8, dtype=np.int64)
    fed = feed.feed_global_batch({"imgs": imgs, "labels": labels},
                                 torch.device("cpu"))
    assert fed["imgs"].device.type == "cpu"
    np.testing.assert_array_equal(fed["labels"].numpy(), labels)
    # one process holds the whole batch
    for got, want in zip(mesh.shard_batch((imgs, labels)), (imgs, labels)):
        np.testing.assert_array_equal(got, want)


def test_replicate_without_a_group_changes_nothing():
    model = torch.nn.Linear(3, 2)
    before = [p.clone() for p in model.parameters()]
    mesh.replicate(model, None)
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))


# ---------------------------------------------------------------------------
# collectives at world 2 and 4 (one spawn per world)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    w = request.param
    out = str(tmp_path_factory.mktemp(f"collectives{w}"))
    return w, workers.run_world(workers.collectives_worker, w, out, 0)


@pytest.fixture(scope="module")
def inputs():
    return {k: torch.from_numpy(v)
            for k, v in workers.collective_inputs(0).items()}


def test_gather_rows_forward_and_backward(world, inputs):
    w, res = world
    for r, out in enumerate(res):
        # exact: every rank holds the global rows in rank order
        assert torch.equal(out["gathered"], inputs["x"])
        want = w * (w + 1) / 2 * workers.rows(inputs["coef"], r, w)
        close(out["gather_grad"], want)


def _bn_world1(inputs):
    return workers.bn_case(inputs["bn_x"], inputs["bn_coef"], None)


def test_global_batchnorm_equals_world1(world, inputs):
    w, res = world
    y1, dx1, dw1, db1, rm1, rv1 = _bn_world1(inputs)
    for r, out in enumerate(res):
        y, dx, dw, db, rm, rv = out["bn"]
        close(y, workers.rows(y1, r, w))
        close(dx, workers.rows(dx1, r, w))
        close(dw, dw1)
        close(db, db1)
        close(rm, rm1)
        close(rv, rv1)
        # the running statistics are the same bits on every rank
        assert torch.equal(rm, res[0]["bn"][4]) and torch.equal(rv, res[0]["bn"][5])


def _flax_bn(inputs):
    """flax BatchNorm on the global batch (NHWC), the same affine and
    running statistics: y, dx, dscale, dbias, new mean and variance."""
    x = np.transpose(inputs["bn_x"].numpy(), (0, 2, 3, 1))
    coef = np.transpose(inputs["bn_coef"].numpy(), (0, 2, 3, 1))
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.linspace(0.5, 1.5, 6),
                            "bias": jnp.linspace(-0.2, 0.3, 6)},
                 "batch_stats": {"mean": jnp.linspace(-1.0, 1.0, 6),
                                 "var": jnp.linspace(0.5, 2.0, 6)}}

    def loss(params, x):
        y, upd = bn.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, x,
                          mutable=["batch_stats"])
        return jnp.sum(y * coef), (y, upd)

    (_, (y, upd)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                                 has_aux=True)(
        variables["params"], jnp.asarray(x))
    nchw = lambda a: np.transpose(np.asarray(a), (0, 3, 1, 2))  # noqa: E731
    return (nchw(y), nchw(gx), gp["scale"], gp["bias"],
            upd["batch_stats"]["mean"], upd["batch_stats"]["var"])


# flax takes the variance as E[x²] − E[x]² (its fast variance), the port as
# the mean squared deviation: float32 rounding apart
FLAX_RTOL = 1e-4


def test_global_batchnorm_equals_flax_on_the_global_batch(world, inputs):
    w, res = world
    want = _flax_bn(inputs)
    for r, out in enumerate(res):
        y, dx, dw, db, rm, rv = out["bn"]
        close(y, workers.rows(want[0], r, w), FLAX_RTOL)
        close(dx, workers.rows(want[1], r, w), FLAX_RTOL)
        close(dw, want[2], FLAX_RTOL)
        close(db, want[3], FLAX_RTOL)
        close(rm, want[4], FLAX_RTOL)
        # flax's biased variance over the global n (SyncBatchNorm would
        # move toward the unbiased one, 8·9/71 ≈ 1.01 times larger here)
        close(rv, want[5], FLAX_RTOL)


def _ntxent_world1(inputs, kernel_route):
    return workers.ntxent_case(inputs["z_i"], inputs["z_j"], inputs["valid"],
                               None, kernel_route)


@pytest.mark.parametrize("kernel_route", [False, True],
                         ids=["dense", "kernel-route"])
def test_nt_xent_over_a_group_equals_world1(world, inputs, kernel_route):
    """Loss and each rank's input gradients against the loss of the whole
    batch in one process; the padding rows (the last rank's at world 4)
    get no gradient from their own rows."""
    w, res = world
    loss1, gi1, gj1 = _ntxent_world1(inputs, kernel_route)
    for r, out in enumerate(res):
        loss, gi, gj = out[f"ntxent_{kernel_route}"]
        close(loss, loss1)
        close(gi, workers.rows(gi1, r, w))
        close(gj, workers.rows(gj1, r, w))


_JAX_NT_XENT = {}  # shards → the JAX results, made once per world


def _jax_nt_xent(inputs, shards):
    if shards not in _JAX_NT_XENT:
        _JAX_NT_XENT[shards] = _jax_nt_xent_once(inputs, shards)
    return _JAX_NT_XENT[shards]


def _jax_nt_xent_once(inputs, shards):
    """JAX ``nt_xent_loss(axis_name=)`` under ``shard_map`` over ``shards``
    devices (the loss), and the gradient of the global loss."""
    zi, zj = inputs["z_i"].numpy(), inputs["z_j"].numpy()
    valid = inputs["valid"].numpy()
    m = JaxMesh(np.array(jax.devices()[:shards]), ("data",))
    loss = jax.shard_map(
        lambda a, b, v: jax_nt_xent_loss(a, b, workers.TAU, axis_name="data",
                                         valid=v),
        mesh=m, in_specs=(P("data"), P("data"), P("data")), out_specs=P()
    )(jnp.asarray(zi), jnp.asarray(zj), jnp.asarray(valid))
    grads = jax.grad(lambda a, b: jax_nt_xent_loss(a, b, workers.TAU,
                                                   valid=jnp.asarray(valid)),
                     argnums=(0, 1))(jnp.asarray(zi), jnp.asarray(zj))
    return float(loss), np.asarray(grads[0]), np.asarray(grads[1])


@pytest.mark.parametrize("kernel_route", [False, True],
                         ids=["dense", "kernel-route"])
def test_nt_xent_over_a_group_equals_jax_axis_name(world, inputs,
                                                   kernel_route):
    w, res = world
    loss, gi, gj = _jax_nt_xent(inputs, w)
    for r, out in enumerate(res):
        got, got_i, got_j = out[f"ntxent_{kernel_route}"]
        close(got, loss)
        close(got_i, workers.rows(gi, r, w))
        close(got_j, workers.rows(gj, r, w))


def test_sharded_attention_pool_equals_jax_and_the_unsharded_pool(world,
                                                                  inputs):
    """Every rank gives the (D,) pool of the whole bag: JAX's function under
    ``shard_map`` over as many devices, and the port's without a group."""
    w, res = world
    d = {k: v.numpy() for k, v in inputs.items()}
    m = JaxMesh(np.array(jax.devices()[:w]), ("data",))
    want = jax.shard_map(
        lambda hh, mm: jax_sharded_attention_pool(hh, mm, d["v"], d["w"],
                                                  v_bias=d["vb"],
                                                  axis_name="data"),
        mesh=m, in_specs=(P("data"), P("data")), out_specs=P()
    )(jnp.asarray(d["h"]), jnp.asarray(d["mask"]))
    one = sharded_attention_pool(inputs["h"], inputs["mask"], inputs["v"],
                                 inputs["w"], v_bias=inputs["vb"])
    close(one, np.asarray(want), 1e-4)
    for out in res:
        close(out["pool"], one)
        assert torch.equal(out["pool"], res[0]["pool"])


def test_sharded_attention_pool_of_an_empty_bag_is_zero():
    """``p`` is weighted by the mask: no real instance pools to 0, in both
    packages (the unsharded pool gives the mean of the rows there)."""
    rng = np.random.default_rng(5)
    h = rng.normal(size=(16, 8)).astype(np.float32)
    v = rng.normal(size=(8, 4)).astype(np.float32)
    w = rng.normal(size=(4,)).astype(np.float32)
    mask = np.zeros(16, bool)
    m = JaxMesh(np.array(jax.devices()[:1]), ("data",))
    want = jax.shard_map(
        lambda hh, mm: jax_sharded_attention_pool(hh, mm, v, w,
                                                  axis_name="data"),
        mesh=m, in_specs=(P("data"), P("data")), out_specs=P())(jnp.asarray(h), jnp.asarray(mask))
    got = sharded_attention_pool(torch.from_numpy(h), torch.from_numpy(mask),
                                 torch.from_numpy(v), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.any()


def test_init_from_env_needs_torchruns_variables(monkeypatch):
    import torch.distributed as dist

    assert not dist.is_initialized()
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node"):
        mesh.init_from_env("cpu")


def test_local_device_never_drops_to_the_cpu(monkeypatch):
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
        cuda_devices,
        local_device,
    )

    monkeypatch.setenv("LOCAL_RANK", "1")
    assert local_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        local_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        cuda_devices()
