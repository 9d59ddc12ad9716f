"""t-SNE's exact repulsion over all pairs of a 2-D embedding on a hand-written
CUDA kernel: the O(N²) half of the KL gradient that ``evaluation/
embedding.py::KLObjective`` takes every descent iteration,

    neg[i] = Σ_{j≠i} q_ij² (y_i − y_j),   sum_q = Σ_{i≠j} q_ij,
    q_ij = 1 / (1 + |y_i − y_j|²),

with ``sum_q`` in float64. It replaces no Pallas kernel: it stands for the
repulsive half of sklearn's Barnes–Hut gradient, which the JAX package
reaches through ``TSNE.fit_transform`` in ``evaluation/features_eval.py``
and which runs as Cython on the host. The port computes the term exactly
(Barnes–Hut at ``angle=0``). Its plain version
(``evaluation/embedding.py::tsne_repulsion_reference``) does that in row
blocks of torch ops, about 20 float32 passes over the pairs in device memory
an iteration, which made ``--tsne_full`` at the MIL triplet's 168,000 rows a
~19-minute call on an H100; PyTorch has no call that fuses them, so the port
has a kernel (``ops/csrc/tsne_repulsion.cu``;
``tsne_repulsion_kernel.launches`` counts the calls).

What bounds the kernel is the arithmetic a pair: ten FP32 instructions and
one reciprocal (which the special-function unit issues at 16 a clock per
SM). q_ij = q_ji, so the kernel takes each unordered pair once and adds its
term to both rows, keeps rows in registers and columns in shared memory, and
reads nothing twice from device memory. Its partial sums are summed in a
fixed order with no atomic adds, in two launches, so a call repeats bit for
bit on a card. The tiling is the ``.cu`` file's alone: it reports the
scratch a call takes. The float32 reciprocal is the hardware approximation:
the kernel is held to the plain version within a tolerance, not bit for
bit.
"""

from __future__ import annotations

import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
    count_launch,
)


def _check(y: torch.Tensor) -> None:
    if y.dim() != 2 or y.shape[1] != 2 or y.shape[0] < 2:
        raise ValueError(f"expected an (N, 2) embedding with N >= 2, got "
                         f"{tuple(y.shape)}")
    if y.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"expected float32 or float64, got {y.dtype}")


def tsne_repulsion_kernel(y: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on a contiguous CUDA embedding (N, 2), float32 or
    float64, N ≥ 2: ``(neg (N, 2) in y's dtype, sum_q float64 scalar)``.
    Raises on anything else."""
    _check(y)
    if y.device.type != "cuda":
        raise ValueError(f"the t-SNE repulsion kernel runs on CUDA tensors, "
                         f"not {y.device}")
    if not y.is_contiguous():
        raise ValueError("the t-SNE repulsion kernel needs a contiguous "
                         "embedding")
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        load_library,
        on_device,
    )

    n = y.shape[0]
    neg = torch.empty_like(y)
    sum_q = torch.empty((), dtype=torch.float64, device=y.device)
    with on_device(y.device):
        lib = load_library()
        size = lib.hipac_tsne_repulsion_scratch(n)
        if size < 0:
            raise RuntimeError(f"t-SNE repulsion kernel: cudaError {-size} "
                               f"sizing its scratch")
        scratch = torch.empty(size, dtype=torch.float64, device=y.device)
        rc = lib.hipac_tsne_repulsion(
            y.data_ptr(), neg.data_ptr(), sum_q.data_ptr(), scratch.data_ptr(),
            size, n, int(y.dtype == torch.float64),
            torch.cuda.current_stream(y.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"t-SNE repulsion kernel launch failed: cudaError "
                           f"{rc}")
    count_launch(tsne_repulsion_kernel)
    return neg, sum_q


tsne_repulsion_kernel.launches = 0

