"""Port NT-Xent losses against the JAX package, and the CUDA kernels against
their plain version; on the card also the training-mode BatchNorm that the
SimCLR step runs with them.

On the CPU the port's kernel wrapper (``nt_xent_loss_kernel``) takes the
plain PyTorch version, ``nt_xent_rows_reference``; it is held against the
JAX Pallas kernel run in interpret mode at small blocks, as the JAX
package's own tests run it (one test: the interpreter takes seconds). The
port's dense ``nt_xent_loss`` is held against the JAX dense loss, and the
two port losses against each other. The ``cuda`` tests hold the kernels
against the plain version on the card at the shapes ``chip_smoke.py``
checks (marker ``cuda``; they skip elsewhere). JAX is imported inside the
tests that compare with it, so the ``cuda`` tests also run where jax is
absent (``python -m pytest --noconftest -m cuda ...``).
"""

import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
    BatchNorm2d,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.simclr import (
    nt_xent_loss,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.nt_xent import (
    MAX_D,
    NEG_INF,
    _check_kernel_args,
    bwd_splits,
    fwd_splits,
    fwd_tile,
    nt_xent_bwd,
    nt_xent_fwd,
    nt_xent_loss_kernel,
    nt_xent_rows,
    nt_xent_rows_reference,
)

torch.set_num_threads(2)

# float32 on the CPU on both sides, summed in other orders: values and
# gradients agree to a few ulps of their magnitude
RTOL, ATOL = 1e-5, 1e-6


def _views(seed, n, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


def _port_value_and_grads(loss_fn, zi, zj, tau, valid):
    ti = torch.from_numpy(zi).requires_grad_()
    tj = torch.from_numpy(zj).requires_grad_()
    v = None if valid is None else torch.from_numpy(valid)
    loss = loss_fn(ti, tj, tau, valid=v)
    loss.backward()
    return loss.item(), ti.grad.numpy(), tj.grad.numpy()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's matmul
    return torch.device("cuda")


def test_port_nt_xent_kernel_loss_matches_jax_pallas():
    """n = 13, D = 16, τ = 0.5, 8×8 Pallas blocks (2N = 26 pads to 32), 3
    invalid rows: value and d/dz_i, d/dz_j."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from ss25_hierarchical_multiscale_image_classification_tpu.ops.pallas.nt_xent import (
        nt_xent_loss_pallas,
    )

    zi, zj = _views(0, 13, 16)
    valid = np.ones(13, bool)
    valid[[2, 7, 12]] = False

    def f(a, b):
        return nt_xent_loss_pallas(a, b, 0.5, block_r=8, block_c=8,
                                   valid=jnp.asarray(valid))

    ref, (gi, gj) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(zi),
                                                          jnp.asarray(zj))
    loss, pi, pj = _port_value_and_grads(nt_xent_loss_kernel, zi, zj, 0.5, valid)
    np.testing.assert_allclose(loss, float(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pi, np.asarray(gi), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pj, np.asarray(gj), rtol=RTOL, atol=ATOL)
    assert not pi[~valid].any() and not pj[~valid].any()


@pytest.mark.parametrize("n", [1, 7, 64])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("tau", [0.1, 0.5])
def test_port_dense_nt_xent_matches_jax(n, masked, tau):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from ss25_hierarchical_multiscale_image_classification_tpu.models.simclr import (
        nt_xent_loss as jax_nt_xent_loss,
    )

    zi, zj = _views(n, n, 16)
    valid = (np.arange(n) % 3 != 2) if masked else None

    def f(a, b):
        v = None if valid is None else jnp.asarray(valid)
        return jax_nt_xent_loss(a, b, tau, valid=v)

    ref, (gi, gj) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(zi),
                                                          jnp.asarray(zj))
    loss, pi, pj = _port_value_and_grads(nt_xent_loss, zi, zj, tau, valid)
    np.testing.assert_allclose(loss, float(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pi, np.asarray(gi), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pj, np.asarray(gj), rtol=RTOL, atol=ATOL)

    # the per-row plain version's mean is the same loss
    loss_k, ki, kj = _port_value_and_grads(nt_xent_loss_kernel, zi, zj, tau,
                                           valid)
    np.testing.assert_allclose(loss_k, loss, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ki, pi, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(kj, pj, rtol=RTOL, atol=ATOL)


def test_nt_xent_rows_reference_masks_self_and_dead_columns():
    """m is the row maximum over live, non-self columns, l the sum of
    exp(s − m) with masked scores at exp(−1e30 − m) = 0, dead rows lose 0."""
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32))
    z = z / z.norm(dim=1, keepdim=True)
    pos = torch.tensor([3, 4, -1, 0, 1, -1], dtype=torch.int32)
    rows, m, l = nt_xent_rows_reference(z, pos, 0.5)
    s = (z @ z.T).numpy() * 2.0
    live = [0, 1, 3, 4]
    for r in range(6):
        cols = [c for c in live if c != r]
        expect_m = s[r, cols].max()
        expect_l = np.exp(s[r, cols] - expect_m).sum()
        np.testing.assert_allclose(m[r].item(), expect_m, rtol=1e-6)
        np.testing.assert_allclose(l[r].item(), expect_l, rtol=1e-6)
        if pos[r] >= 0:
            np.testing.assert_allclose(
                rows[r].item(), -s[r, pos[r]] + expect_m + np.log(expect_l),
                rtol=1e-5)
        else:
            assert rows[r].item() == 0.0


def test_nt_xent_wrapper_rejects_bad_input_and_counts_no_cpu_launch():
    z = torch.nn.functional.normalize(torch.randn(6, 4), dim=1)
    pos = torch.tensor([3, 4, 5, 0, 1, 2], dtype=torch.int32)
    before = (nt_xent_fwd.launches, nt_xent_bwd.launches)
    zg = z.clone().requires_grad_()
    rows, _, _ = nt_xent_rows(zg, pos, 0.5)  # the CPU takes the plain version
    rows.sum().backward()
    assert (nt_xent_fwd.launches, nt_xent_bwd.launches) == before
    bad = [
        (z.double(), pos),  # dtype
        (z[:, None], pos),  # rank
        (z, pos.long()),  # index dtype
        (z, pos[:5]),  # index length
        (z[:0], pos[:0]),  # empty
    ]
    for args in bad:
        with pytest.raises(ValueError):
            nt_xent_rows(*args, 0.5)
    # wider rows than the kernels take: the plain version computes them on
    # the CPU, and the kernels' check names the limit
    wide = torch.nn.functional.normalize(torch.randn(6, MAX_D + 1), dim=1)
    assert torch.isfinite(nt_xent_rows(wide, pos, 0.5)[0]).all()
    with pytest.raises(ValueError, match=str(MAX_D)):
        _check_kernel_args(wide, pos)
    # the launchers take only contiguous CUDA tensors; a CPU tensor raises
    with pytest.raises(ValueError):
        nt_xent_fwd(z, pos, 2.0)
    with pytest.raises(ValueError):
        nt_xent_bwd(z, pos, torch.ones(6), torch.ones(6), torch.ones(6), 2.0)


@pytest.mark.parametrize("n", [1, 2, 63, 64, 74, 130, 1000, 1024, 4096, 8192,
                               32768, 65536])
@pytest.mark.parametrize("d", [4, 64, 128, 200, 512])
def test_bwd_splits_fill_the_card_and_keep_a_tile_each(n, d):
    """The backward's column split: a cluster of 1, 2, 4 or 8 blocks, every
    split keeps at least one 64-wide column tile, and the split doubles only
    while the grid has fewer blocks than the card's SMs."""
    sms = 132
    tiles = -(-n // 64)
    base = tiles * -(-d // 128)
    splits = bwd_splits(n, d, sms)
    assert splits in (1, 2, 4, 8) and splits <= tiles
    if splits > 1:
        assert base * splits // 2 < sms
    if splits < 8 and 2 * splits <= tiles:
        assert base * splits >= sms
    if (n, d) == (1024, 128):
        assert splits == 8 and base * splits == 128  # the path: 128 blocks
    if n >= 8448:
        assert splits == 1


@pytest.mark.parametrize("n", [2, 74, 1000, 1024, 4096, 32768])
@pytest.mark.parametrize("d", [100, 128, 512])
def test_fwd_splits_fill_one_wave_and_keep_a_tile_each(n, d):
    """The forward's plan: 128-row blocks only for D <= 128 and at least one
    such block per SM, else 64; a cluster of 1, 2, 4 or 8 blocks, every
    split keeps at least one column tile, and the split doubles only while
    the grid has fewer blocks than the card's SMs."""
    sms = 132
    tile = fwd_tile(n, d, sms)
    assert tile in (64, 128)
    assert tile == 64 or (d <= 128 and -(-n // 128) >= sms)
    tiles = -(-n // tile)
    splits = fwd_splits(n, d, sms)
    assert splits in (1, 2, 4, 8) and splits <= tiles
    if splits > 1:
        assert tiles * splits // 2 < sms
    if splits < 8 and 2 * splits <= tiles:
        assert tiles * splits >= sms
    if (n, d) == (1024, 128):
        assert (tile, splits) == (64, 8)  # the path: 128 blocks of 64 rows
    if (n, d) == (32768, 128):
        assert (tile, splits) == (128, 1)  # 256 blocks of 128 rows


def _xor_tree(v, op):
    """The kernel's shuffle merge over the 16 lanes of a row (last axis):
    offsets 8, 4, 2, 1, each lane with the lane ``i ^ off``."""
    lanes = torch.arange(16)
    for off in (8, 4, 2, 1):
        v = op(v, v[..., lanes ^ off])
    return v


def _emulate_fwd(z, pos, inv_tau, sms):
    """The forward kernel's blocking and merge order in float32: the plan's
    column tiles split over ``fwd_splits`` ranks; within a rank, lane tx of
    a row sees columns ``col0 + tx + 16 j`` of every tile of the rank's run
    with an online (m, l, ps); the 16 lanes merge by the shuffle tree, the
    ranks in rank order."""
    n, d = z.shape
    tile, splits = fwd_tile(n, d, sms), fwd_splits(n, d, sms)
    tiles = -(-n // tile)
    idx = torch.arange(n)
    s = (z @ z.T) * inv_tau
    s = s.masked_fill((idx[:, None] == idx[None, :]) | (pos < 0)[None, :], NEG_INF)
    parts = []
    for rank in range(splits):
        m = torch.full((n, 16), NEG_INF)
        l = torch.zeros(n, 16)
        ps = torch.zeros(n, 16)
        for t in range(rank * tiles // splits, (rank + 1) * tiles // splits):
            cols = t * tile + torch.arange(tile).view(tile // 16, 16)  # [j, tx]
            sc = torch.where(cols < n, s[:, cols.clamp(max=n - 1)],
                             torch.tensor(-float("inf")))  # (n, j, tx)
            mt = torch.maximum(m, sc.amax(dim=1))
            l = l * torch.exp(m - mt) + torch.exp(sc - mt[:, None]).sum(dim=1)
            ps = ps + torch.where(cols[None] == pos[:, None, None].long(), sc,
                                  0.0).sum(dim=1)
            m = mt
        mr = _xor_tree(m, torch.maximum)[:, 0]
        lr = _xor_tree(l * torch.exp(m - mr[:, None]), torch.add)[:, 0]
        parts.append((mr, lr, _xor_tree(ps, torch.add)[:, 0]))
    big_m = parts[0][0]
    for mk, _, _ in parts[1:]:
        big_m = torch.maximum(big_m, mk)
    big_l = torch.zeros(n)
    big_ps = torch.zeros(n)
    for mk, lk, pk in parts:
        big_l = big_l + lk * torch.exp(mk - big_m)
        big_ps = big_ps + pk
    rows = torch.where(pos >= 0, -big_ps + big_m + torch.log(big_l), 0.0)
    return rows, big_m, big_l


def _cpu_pairs(seed, pairs, d, dead_pairs=()):
    rng = np.random.default_rng(seed)
    z = torch.from_numpy(rng.normal(size=(2 * pairs, d)).astype(np.float32))
    z = z / z.norm(dim=1, keepdim=True)
    ar = torch.arange(pairs, dtype=torch.int32)
    pos = torch.cat([ar + pairs, ar])
    dead = torch.zeros(pairs, dtype=torch.bool)
    dead[list(dead_pairs)] = True
    return z, torch.where(torch.cat([dead, dead]), -1, pos)


@pytest.mark.parametrize("pairs,d,dead,sms", [
    (1, 128, (), 132),  # one pair: each row's only other column
    (37, 128, (3, 30), 132),  # ragged 2N = 74, dead rows and columns
    (500, 100, tuple(range(480, 500)), 132),  # ragged 2N = 1000, D = 100
    # the path's 2N = 1024: splits of 128 columns; pairs 0-127 dead, so the
    # splits over columns 0-127 and 512-639 see masked columns only
    (512, 128, tuple(range(128)), 132),
    (300, 64, (0, 299), 4),  # 128-row blocks (a 4-SM plan): 8 x 8 tiles
    (2, 16, (0, 1), 132),  # every row dead
])
def test_fwd_emulation_of_the_kernel_order_matches_plain_version(pairs, d, dead,
                                                                  sms):
    z, pos = _cpu_pairs(pairs, pairs, d, dead)
    rows, m, l = _emulate_fwd(z, pos, 2.0, sms)
    rows_r, m_r, l_r = nt_xent_rows_reference(z, pos, 0.5)
    assert (rows - rows_r).abs().max() <= 1e-6 * max(rows_r.abs().max(), 1.0)
    assert (m - m_r).abs().max() <= 1e-6 * m_r.abs().max()
    assert ((l - l_r).abs() / l_r).max() <= 1e-6
    assert not rows[pos < 0].any()


def test_fwd_emulation_matches_jax_pallas_forward():
    """The emulated kernel order against the JAX forward kernel (interpret
    mode, 8 x 8 blocks) on 2N = 32 rows with two dead pairs."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from ss25_hierarchical_multiscale_image_classification_tpu.ops.pallas.nt_xent import (
        _run_fwd,
    )

    z, pos = _cpu_pairs(11, 16, 16, (2, 9))
    got = _emulate_fwd(z, pos, 2.0, 132)
    ref = _run_fwd(jnp.asarray(z.numpy()), jnp.asarray(pos.numpy()[:, None]),
                   0.5, 8, 8)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r)[:, 0], rtol=RTOL,
                                   atol=ATOL)


def _pairs(device, g, pairs, d, valid_pairs):
    """Rows and positive indices as ``nt_xent_loss_kernel`` builds them,
    the last ``pairs − valid_pairs`` pairs dead in both views."""
    z = torch.randn(2 * pairs, d, device=device, generator=g)
    z = z / z.norm(dim=1, keepdim=True)
    ar = torch.arange(pairs, dtype=torch.int32, device=device)
    valid = torch.cat([ar < valid_pairs, ar < valid_pairs])
    return z, torch.where(valid, torch.cat([ar + pairs, ar]), -1)


@pytest.mark.cuda
@pytest.mark.parametrize("pairs,d,valid_pairs", [
    (512, 128, 216), (512, 128, 512), (37, 128, 37), (4096, 128, 4096),
    (65, 100, 60), (150, 512, 140), (1, 128, 1), (500, 64, 480),
    (2048, 200, 2000), (16384, 128, 16384), (3, 7, 3)])
@pytest.mark.parametrize("upstream", ["ones", "random"])
def test_nt_xent_cuda_kernels_match_plain_version(cuda_device, pairs, d,
                                                  valid_pairs, upstream):
    g = torch.Generator(device=cuda_device).manual_seed(pairs)
    z, pos = _pairs(cuda_device, g, pairs, d, valid_pairs)
    up = (torch.ones(2 * pairs, device=cuda_device) if upstream == "ones"
          else torch.rand(2 * pairs, device=cuda_device, generator=g) + 0.5)
    before = (nt_xent_fwd.launches, nt_xent_bwd.launches)
    zk = z.clone().requires_grad_()
    rows, m, l = nt_xent_rows(zk, pos, 0.5)
    rows.backward(up)
    torch.cuda.synchronize()
    assert (nt_xent_fwd.launches, nt_xent_bwd.launches) == (before[0] + 1,
                                                           before[1] + 1)
    zr = z.clone().requires_grad_()
    rows_r, m_r, l_r = nt_xent_rows_reference(zr, pos, 0.5)
    rows_r.backward(up)
    # as chip_smoke.py: 1e-5 relative on the forward; on dz 1e-5 of max|dz|,
    # times sqrt(2N / 1024) above 2N = 1024 (sequential sums over 2N terms)
    assert (rows - rows_r).abs().max() <= 1e-5 * rows_r.abs().max()
    assert (m - m_r).abs().max() <= 1e-5 * m_r.abs().max()
    assert ((l - l_r).abs() / l_r).max() <= 1e-5
    dz_tol = 1e-5 * max(1.0, (2 * pairs / 1024) ** 0.5)
    assert (zk.grad - zr.grad).abs().max() <= dz_tol * zr.grad.abs().max()
    dead = pos < 0
    assert not rows[dead].any() and not zk.grad[dead].any()


@pytest.mark.cuda
@pytest.mark.parametrize("pairs,d", [(512, 128), (37, 200), (4096, 128)])
def test_nt_xent_bwd_gives_the_same_bits_twice(cuda_device, pairs, d):
    """The column split sums its partials in a fixed rank order, with no
    atomics: two calls on the same input give bit-identical dz."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    z, pos = _pairs(cuda_device, g, pairs, d, pairs - 1)
    _, m, l = nt_xent_fwd(z, pos, 2.0)
    up = torch.where(pos >= 0, torch.rand(2 * pairs, device=cuda_device,
                                          generator=g), 0.0)
    first = nt_xent_bwd(z, pos, m, l, up, 2.0)
    second = nt_xent_bwd(z, pos, m, l, up, 2.0)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("pairs,d,valid_pairs,plan", [
    (1, 128, 1, (64, 1)), (37, 128, 37, (64, 2)), (150, 7, 140, (64, 4)),
    (512, 128, 216, (64, 8)), (256, 512, 250, (64, 8)),
    (8500, 100, 8400, (128, 1))])
def test_nt_xent_fwd_plans_give_the_same_bits_and_feed_the_backward(
        cuda_device, pairs, d, valid_pairs, plan):
    """Every split count, a width not a multiple of 4, depth chunks (D >
    128) and 128-row blocks: the forward within 1e-5 of the plain version,
    the same bits from a second call, and the backward within its bound on
    the forward's m and l."""
    n, d4 = 2 * pairs, d + -d % 4
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    if sms == 132:  # the plans above are those of a 132-SM card
        assert (fwd_tile(n, d4, sms), fwd_splits(n, d4, sms)) == plan
    g = torch.Generator(device=cuda_device).manual_seed(pairs)
    z, pos = _pairs(cuda_device, g, pairs, d, valid_pairs)
    rows, m, l = nt_xent_fwd(z, pos, 2.0)
    again = nt_xent_fwd(z, pos, 2.0)
    up = torch.where(pos >= 0, torch.rand(n, device=cuda_device, generator=g), 0.0)
    dz = nt_xent_bwd(z, pos, m, l, up, 2.0)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((rows, m, l), again))
    zr = z.clone().requires_grad_()
    rows_r, m_r, l_r = nt_xent_rows_reference(zr, pos, 0.5)
    rows_r.backward(up)
    assert (rows - rows_r).abs().max() <= 1e-5 * max(rows_r.abs().max(), 1.0)
    assert (m - m_r).abs().max() <= 1e-5 * m_r.abs().max()
    assert ((l - l_r).abs() / l_r).max() <= 1e-5
    dz_tol = 1e-5 * max(1.0, (n / 1024) ** 0.5)
    assert (dz - zr.grad).abs().max() <= dz_tol * zr.grad.abs().max()


@pytest.mark.cuda
def test_nt_xent_cuda_loss_matches_dense_loss(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    zi = torch.randn(300, 128, device=cuda_device, generator=g)
    zj = torch.randn(300, 128, device=cuda_device, generator=g)
    valid = torch.arange(300, device=cuda_device) < 250
    out = []
    for fn in (nt_xent_loss_kernel, nt_xent_loss):
        a, b = zi.clone().requires_grad_(), zj.clone().requires_grad_()
        loss = fn(a, b, 0.5, valid=valid)
        loss.backward()
        out.append((loss.item(), a.grad, b.grad))
    assert abs(out[0][0] - out[1][0]) <= 1e-5 * abs(out[1][0])
    for k in (1, 2):
        assert (out[0][k] - out[1][k]).abs().max() <= 1e-5 * out[1][k].abs().max()


@pytest.mark.cuda
def test_nt_xent_cuda_launchers_check_their_input(cuda_device):
    z = torch.nn.functional.normalize(torch.randn(8, 4, device=cuda_device), dim=1)
    pos = torch.tensor([4, 5, 6, 7, 0, 1, 2, 3], dtype=torch.int32,
                       device=cuda_device)
    strided = torch.randn(8, 8, device=cuda_device)[:, ::2]
    with pytest.raises(ValueError):
        nt_xent_fwd(strided, pos, 2.0)  # not contiguous
    with pytest.raises(ValueError):
        nt_xent_fwd(z, pos.cpu(), 2.0)  # pos on another device
    _, m, l = nt_xent_fwd(z, pos, 2.0)
    with pytest.raises(ValueError):
        nt_xent_bwd(z, pos, m, l, torch.ones(8, device=cuda_device).double(), 2.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_training_on_cuda_keeps_flax_statistics(cuda_device, dtype):
    """cuDNN's training BN moves its running variance toward the unbiased
    batch variance; the port's BatchNorm2d must end at flax's biased one. A
    batch of 4 at 1×1, as layer4 sees at 32²."""
    x = (torch.randn(4, 8, 1, 1, generator=torch.Generator().manual_seed(0))
         * 2 + 1).to(dtype)
    bn = BatchNorm2d(8).to(cuda_device).train()
    with torch.autocast("cuda", torch.bfloat16, enabled=dtype == torch.bfloat16):
        y = bn(x.to(cuda_device))
    torch.cuda.synchronize()
    xd = x.double()
    mean, var = xd.mean(dim=(0, 2, 3)), xd.var(dim=(0, 2, 3), unbiased=False)
    assert y.dtype == dtype
    torch.testing.assert_close(bn.running_mean.cpu().double(), 0.1 * mean,
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bn.running_var.cpu().double(), 0.9 + 0.1 * var,
                               rtol=1e-5, atol=1e-6)
