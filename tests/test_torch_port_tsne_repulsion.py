"""t-SNE's exact repulsion: its plain version on the CPU
(``evaluation/embedding.py::tsne_repulsion_reference``) and its CUDA kernel
on the card (``ops/tsne_repulsion.py``).

Bounds:

- the plain version against a direct float64 numpy loop over the pairs:
  ``neg`` within 1e-12 of max|neg| and ``sum_q`` within 1e-12 relative in
  float64, 1e-5 in float32; the same with coincident rows off the diagonal
  (q = 1 counts);
- against the repulsive part of sklearn's ``_kl_divergence_bh(angle=0)``
  gradient (the JAX package's t-SNE), ``neg / sum_q`` within 1e-5 of its
  maximum (sklearn works in float32);
- ``KLObjective`` in float32, the descent's working type, against sklearn's
  whole ``_kl_divergence_bh(angle=0)``: the gradient within 1e-5 of its
  maximum, the KL within 1e-5 relative;
- on the card (marked ``cuda``; no jax imported here): the kernel against
  its plain version on the same tensor, ``neg`` within 1e-4 of max|neg| and
  ``sum_q`` within 1e-6 relative in float32 (the hardware reciprocal), both
  within 1e-10 in float64, also at the edges of the kernel's tiles, with
  coincident rows and at scales 1e-3 and 1e3; two launches equal bit for
  bit;
  ``tsne_repulsion_kernel.launches`` counts each call.

The row-blocked plain version is held to one block by
``tests/test_torch_port_embedding.py::test_tsne_row_blocked_repulsion_equals_one_block``.
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation import (
    embedding as E,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops import (
    build,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops import (
    tsne_repulsion as R,
)

torch.set_num_threads(2)

LOOP_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
SKLEARN_RTOL = 1e-5
F32_GRAD_RTOL, F32_KL_RTOL = 1e-5, 1e-5
CARD_NEG_RTOL = {torch.float32: 1e-4, torch.float64: 1e-10}
CARD_SUM_RTOL = {torch.float32: 1e-6, torch.float64: 1e-10}


def _embedding(n, seed=0, scale=10.0, dtype=torch.float64):
    y = np.random.default_rng(seed).normal(size=(n, 2)) * scale
    return torch.from_numpy(y).to(dtype)


def _loop(y: np.ndarray) -> tuple[np.ndarray, float]:
    """``neg`` and ``sum_q`` pair by pair in float64."""
    y = y.astype(np.float64)
    n = len(y)
    neg = np.zeros_like(y)
    sum_q = 0.0
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            d = y[i] - y[j]
            q = 1.0 / (1.0 + d @ d)
            sum_q += q
            neg[i] += q * q * d
    return neg, sum_q


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# ---------------------------------------------------------------------------
# the plain version (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [2, 3, 37, 300])
def test_reference_equals_a_float64_loop_over_the_pairs(n, dtype):
    y = _embedding(n, seed=n, scale=3.0, dtype=dtype)
    neg, sum_q = E.tsne_repulsion_reference(y)
    want_neg, want_sum = _loop(y.numpy())
    assert neg.dtype == dtype and neg.shape == (n, 2)
    assert sum_q.dtype == torch.float64 and sum_q.dim() == 0
    assert _rel(neg.numpy(), want_neg) <= LOOP_RTOL[dtype]
    assert abs(float(sum_q) / want_sum - 1.0) <= LOOP_RTOL[dtype]


def _coincident(n, seed=0, scale=10.0, dtype=torch.float64):
    """An embedding whose every third row, from row 1 on, equals row 0, and
    whose last row equals its first: coincident points off the diagonal,
    where q = 1 counts."""
    y = _embedding(n, seed=seed, scale=scale, dtype=dtype)
    y[1::3] = y[0]
    y[-1] = y[0]
    return y


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [5, 7, 300])
def test_reference_counts_coincident_points_off_the_diagonal(n, dtype):
    """q = 1 for two rows at one point, and they push each other by 0: the
    plain version counts them as the float64 loop does, and leaves only the
    diagonal out."""
    y = _coincident(n, seed=n, scale=3.0, dtype=dtype)
    neg, sum_q = E.tsne_repulsion_reference(y)
    want_neg, want_sum = _loop(y.numpy())
    assert _rel(neg.numpy(), want_neg) <= LOOP_RTOL[dtype]
    assert abs(float(sum_q) / want_sum - 1.0) <= LOOP_RTOL[dtype]
    dup = (y[:, None, :] == y[None, :, :]).all(dim=2).sum() - n
    assert dup > 0 and float(sum_q) >= float(dup)


@pytest.mark.parametrize("scale", [1e-2, 1.0, 10.0])
def test_reference_equals_sklearn_barnes_hut_repulsion_at_angle_0(scale):
    """With every P value 0 the attraction vanishes, and sklearn's gradient
    at one degree of freedom is −4 · neg / sum_q."""
    from scipy.sparse import csr_matrix
    from sklearn.manifold._t_sne import _kl_divergence_bh

    n = 300  # the shape of tests/test_torch_port_embedding.py's affinities
    y = (np.random.default_rng(7).normal(size=(n, 2)) * scale).astype(np.float32)
    p_zero = csr_matrix((n, n), dtype=np.float32)
    _, grad_sk = _kl_divergence_bh(y.ravel().copy(), p_zero, 1, n, 2,
                                   angle=0.0, compute_error=False)
    neg, sum_q = E.tsne_repulsion_reference(torch.from_numpy(y).double())
    got = (neg / sum_q).numpy().ravel()
    assert _rel(got, -grad_sk / 4.0) <= SKLEARN_RTOL


def _ring(n):
    """P over a ring: every row's two next neighbours, 1 / (2n) each."""
    rows = torch.arange(n).repeat_interleave(2)
    cols = (rows + torch.tensor([1, 2]).repeat(n)) % n
    return E.JointP(rows, cols, torch.full((2 * n,), 1 / (2 * n),
                                           dtype=torch.float64), n)


@pytest.mark.parametrize("entry", ["tsne_repulsion", "KLObjective",
                                   "tsne", "kl_divergence"])
def test_cpu_tensors_never_reach_the_kernel(entry, monkeypatch):
    def refuse(y):
        raise AssertionError("the kernel was reached from a CPU tensor")

    monkeypatch.setattr(R, "tsne_repulsion_kernel", refuse)
    y = _embedding(40, dtype=torch.float32)
    if entry == "tsne_repulsion":
        neg, sum_q = E.tsne_repulsion(y)
        want_neg, want_sum = E.tsne_repulsion_reference(y)
        assert torch.equal(neg, want_neg) and torch.equal(sum_q, want_sum)
    elif entry == "KLObjective":
        kl, grad = E.KLObjective(_ring(40))(y)
        assert math.isfinite(kl) and torch.isfinite(grad).all()
    elif entry == "tsne":
        got = E.tsne(_embedding(40, seed=2, scale=1.0), perplexity=10.0)
        assert math.isfinite(got.kl_divergence)
        assert torch.isfinite(got.embedding).all()
    else:
        assert math.isfinite(E.kl_divergence(_ring(40), y))


@pytest.mark.parametrize("scale", [1e-2, 1.0])
def test_float32_objective_equals_barnes_hut_at_angle_0(scale):
    """The descent's float32 objective against sklearn's whole gradient and
    KL at ``angle=0`` (the float64 objective is held by
    ``tests/test_torch_port_embedding.py``)."""
    from sklearn.manifold._t_sne import _joint_probabilities_nn
    from sklearn.manifold._t_sne import _kl_divergence_bh
    from sklearn.neighbors import NearestNeighbors

    rng = np.random.default_rng(1)
    n = 120
    x = rng.normal(size=(n, 8))
    k = min(n - 1, int(3.0 * 10.0 + 1))
    graph = NearestNeighbors(n_neighbors=k).fit(x).kneighbors_graph(
        mode="distance")
    graph.data **= 2
    graph.sort_indices()
    p_sk = _joint_probabilities_nn(graph, 10.0, 0)
    y = (rng.normal(size=(n, 2)) * scale).astype(np.float32)
    kl_sk, grad_sk = _kl_divergence_bh(y.ravel().copy(), p_sk, 1, n, 2,
                                       angle=0.0)
    p = E.tsne_affinities(torch.from_numpy(x), 10.0)
    kl, grad = E.KLObjective(p, torch.float32)(torch.from_numpy(y))
    assert grad.dtype == torch.float32
    assert _rel(grad.numpy(), grad_sk) <= F32_GRAD_RTOL
    assert abs(kl / kl_sk - 1.0) <= F32_KL_RTOL


@pytest.mark.parametrize("shape,dtype,device,match", [
    ((16, 2), torch.float32, "cpu", "CUDA tensors"),
    ((16, 3), torch.float32, "cpu", r"\(N, 2\)"),
    ((16, 2), torch.float16, "cpu", "float32 or float64"),
    ((1, 2), torch.float32, "cpu", "N >= 2"),
    ((1, 2), torch.float64, "cpu", "N >= 2"),
    ((16,), torch.float32, "cpu", r"\(N, 2\)"),
    ((4, 4, 2), torch.float64, "cpu", r"\(N, 2\)"),
    ((16, 2), torch.int32, "cpu", "float32 or float64"),
])
def test_kernel_wrapper_refuses_what_it_cannot_take(shape, dtype, device,
                                                    match):
    before = R.tsne_repulsion_kernel.launches
    with pytest.raises(ValueError, match=match):
        R.tsne_repulsion_kernel(torch.zeros(shape, dtype=dtype, device=device))
    assert R.tsne_repulsion_kernel.launches == before


_P, _I64 = ctypes.c_void_p, ctypes.c_longlong


@pytest.mark.parametrize("entry,argtypes,restype", [
    # y, neg, sum_q, scratch, scratch elements, n, is_double, stream
    ("hipac_tsne_repulsion", [_P, _P, _P, _P, _I64, _I64, ctypes.c_int, _P],
     ctypes.c_int),
    # n -> the scratch a call takes
    ("hipac_tsne_repulsion_scratch", [_I64], _I64),
])
def test_sources_carry_the_entry_point_with_pointer_width_arguments(
        entry, argtypes, restype):
    assert build.SOURCES["tsne_repulsion.cu"][entry] == (argtypes, restype)
    assert (build.CSRC_DIR / "tsne_repulsion.cu").exists()


# ---------------------------------------------------------------------------
# the kernel (card)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [2, 3, 255, 256, 257, 1_752, 10_000])
def test_kernel_equals_its_plain_version_on_the_card(cuda_device, n, dtype):
    y = _embedding(n, seed=n, dtype=dtype).to(cuda_device)
    neg, sum_q = R.tsne_repulsion_kernel(y)
    want_neg, want_sum = E.tsne_repulsion_reference(y)
    torch.cuda.synchronize()
    assert neg.dtype == dtype and neg.shape == (n, 2)
    assert sum_q.dtype == torch.float64 and sum_q.dim() == 0
    assert _rel(neg.cpu().numpy(), want_neg.cpu().numpy()) <= CARD_NEG_RTOL[dtype]
    assert abs(float(sum_q) / float(want_sum) - 1.0) <= CARD_SUM_RTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_repeats_bit_for_bit(cuda_device, dtype):
    y = _embedding(10_000, seed=3, dtype=dtype).to(cuda_device)
    neg, sum_q = R.tsne_repulsion_kernel(y)
    neg2, sum_q2 = R.tsne_repulsion_kernel(y)
    torch.cuda.synchronize()
    assert torch.equal(neg, neg2) and torch.equal(sum_q, sum_q2)


@pytest.mark.cuda
def test_kernel_launches_count_each_call(cuda_device):
    y = _embedding(500, dtype=torch.float32).to(cuda_device)
    before = R.tsne_repulsion_kernel.launches
    E.tsne_repulsion(y)
    R.tsne_repulsion_kernel(y)
    assert R.tsne_repulsion_kernel.launches == before + 2
    ring = _ring(500)
    p = E.JointP(ring.rows.to(cuda_device), ring.cols.to(cuda_device),
                 ring.vals.to(cuda_device), 500)
    E.KLObjective(p)(y)
    torch.cuda.synchronize()
    assert R.tsne_repulsion_kernel.launches == before + 3


def _card_against_plain(y):
    neg, sum_q = R.tsne_repulsion_kernel(y)
    want_neg, want_sum = E.tsne_repulsion_reference(y)
    torch.cuda.synchronize()
    dtype = y.dtype
    assert neg.dtype == dtype and neg.shape == y.shape
    assert torch.isfinite(neg).all()
    assert _rel(neg.cpu().numpy(), want_neg.cpu().numpy()) <= CARD_NEG_RTOL[dtype]
    assert abs(float(sum_q) / float(want_sum) - 1.0) <= CARD_SUM_RTOL[dtype]


# The kernel's tiling: row strips of 2048 (8 warps of 256 rows), column items
# of 128; a strip pairs with the columns from its first row on. At 20,000
# rows on 132 SMs the 850 (strip, item) pairs cut into 213 pieces of 4 and a
# last of 2, and strips cross pieces.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [127, 128, 129, 2_047, 2_048, 2_049, 4_097,
                               20_000])
def test_kernel_at_the_edges_of_its_tiles(cuda_device, n, dtype):
    _card_against_plain(_embedding(n, seed=n + 1, dtype=dtype).to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [300, 2_049, 5_000])
def test_kernel_counts_coincident_points_off_the_diagonal(cuda_device, n,
                                                          dtype):
    """Rows at one point across warps, strips and items count q = 1: the
    diagonal is left out by index, never by distance."""
    _card_against_plain(_coincident(n, seed=n, dtype=dtype).to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scale", [1e-3, 1e3])
def test_kernel_at_small_and_large_scales(cuda_device, scale, dtype):
    """1e-3: every q near 1 (sum_q's float32 chains at their longest
    values); 1e3: most q near 1e-6."""
    _card_against_plain(_embedding(3_000, seed=5, scale=scale,
                                   dtype=dtype).to(cuda_device))
