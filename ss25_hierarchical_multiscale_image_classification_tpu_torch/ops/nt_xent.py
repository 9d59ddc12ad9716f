"""Streaming NT-Xent loss: the SimCLR loss on hand-written CUDA kernels.

Counterpart of the JAX package's ``ops/pallas/nt_xent.py``
(``nt_xent_loss_pallas``; kernels ``_fwd_kernel`` and ``_bwd_kernel``). The
loss never holds the (2N, 2N) score matrix: the forward kernel streams score
tiles through an online logsumexp and keeps each row's (m, l), the backward
kernel recomputes the tiles from them (``ops/csrc/nt_xent.cu`` says how).

- :func:`nt_xent_loss_kernel` is ``nt_xent_loss_pallas``: L2 normalisation
  (differentiable PyTorch), positive indices, the ``valid`` mask and the
  mean over valid rows, around :func:`nt_xent_rows`.
- :func:`nt_xent_rows` gives (loss rows, m, l) of pre-normalised rows. For a
  CUDA tensor it runs ``_NTXentRows``, whose forward and backward launch the
  kernels (``nt_xent_fwd.launches`` and ``nt_xent_bwd.launches`` count
  them), or raises; a CPU tensor takes :func:`nt_xent_rows_reference`.
- :func:`nt_xent_rows_reference` is the plain version: the dense score
  matrix, with gradients from autograd. The CPU tests hold it against the
  JAX kernel, and the card's checks hold the kernels against it.

Rows with ``pos_idx < 0`` are dead (a wrap-padded final batch): their loss
is 0 and they leave every other row's denominator. The kernels mask the
ragged edge themselves, so nothing is padded to a block multiple (the TPU
kernel pads to its blocks).
"""

from __future__ import annotations

import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
    count_launch,
)

#: Mask of the self and dead scores, as the Pallas kernel's: exp(−1e30 − m)
#: is 0 for every finite row maximum.
NEG_INF = -1e30
#: Widest rows the wrapper passes to the kernels (the plain version takes
#: any width). They stage z in chunks of 128 columns and write dz in slices
#: of 128; the card's tests reach 512 (the projection width is 128).
MAX_D = 4096


def _check(z: torch.Tensor, pos_idx: torch.Tensor) -> None:
    if z.dtype != torch.float32 or z.dim() != 2 or z.shape[0] < 1:
        raise ValueError(f"expected (n, d) float32 rows with n >= 1, got "
                         f"{tuple(z.shape)} {z.dtype}")
    if pos_idx.dtype != torch.int32 or pos_idx.shape != z.shape[:1]:
        raise ValueError(f"expected ({z.shape[0]},) int32 pos_idx, got "
                         f"{tuple(pos_idx.shape)} {pos_idx.dtype}")
    if pos_idx.device != z.device:
        raise ValueError(f"z on {z.device}, pos_idx on {pos_idx.device}")


def nt_xent_rows_reference(z: torch.Tensor, pos_idx: torch.Tensor,
                           temperature: float
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the kernels: (loss rows, m, l), each (n,) float32.

    Scores are ``(z @ zᵀ) · (1/τ)`` (a product by the reciprocal, as the
    kernel and PyTorch's CUDA division by a host scalar compute it), masked
    to :data:`NEG_INF` on the diagonal and in dead columns; ``m`` is the
    row maximum and ``l = Σ exp(s − m)``. Autograd gives the gradient of
    the loss rows; ``m`` and ``l`` are returned detached.
    """
    _check(z, pos_idx)
    n = z.shape[0]
    s = (z @ z.T) * (1.0 / temperature)
    idx = torch.arange(n, device=z.device)
    dead = (idx[:, None] == idx[None, :]) | (pos_idx < 0)[None, :]
    s = s.masked_fill(dead, NEG_INF)
    m = s.detach().amax(dim=1)
    l = torch.exp(s - m[:, None]).sum(dim=1)
    live = pos_idx >= 0
    ps = s.gather(1, pos_idx.clamp(min=0).long()[:, None])[:, 0]
    rows = torch.where(live, -ps + m + torch.log(l), torch.zeros_like(m))
    return rows, m, l.detach()


def _check_kernel_args(z: torch.Tensor, pos_idx: torch.Tensor) -> None:
    if not 1 <= z.shape[1] <= MAX_D:
        raise ValueError(f"the NT-Xent kernels take rows of width 1..{MAX_D}, "
                         f"got {z.shape[1]}")
    if z.device.type != "cuda":
        raise ValueError(f"the NT-Xent kernels run on CUDA tensors, not {z.device}")
    if not (z.is_contiguous() and pos_idx.is_contiguous()):
        raise ValueError("the NT-Xent kernels need contiguous z and pos_idx")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def fwd_tile(n: int, d: int, sms: int) -> int:
    """Rows of a forward block and columns of its tiles: 128 (8 x 8 scores a
    thread) once rows of width ``d`` <= 128 make at least one such block per
    SM (2N >= 128 · SMs: 2N = 32768 gives 256 blocks), else 64 (4 x 4)."""
    return 128 if d <= 128 and -(-n // 128) >= sms else 64


def fwd_splits(n: int, d: int, sms: int) -> int:
    """Blocks (1, 2, 4 or 8: one cluster) that the forward kernel splits the
    column tiles of each row block over: doubled while the grid has fewer
    blocks than the card has SMs and every split keeps a tile (2N = 1024,
    D = 128: 8, 128 blocks of 64 rows; 2N = 32768: 1, 256 blocks of 128)."""
    tile = fwd_tile(n, d, sms)
    row_blocks = tiles = -(-n // tile)
    splits = 1
    while splits < 8 and 2 * splits <= tiles and row_blocks * splits < sms:
        splits *= 2
    return splits


def _pad4(z: torch.Tensor) -> torch.Tensor:
    """Rows zero-padded to a multiple of 4 wide (bulk copies move 16-byte
    pieces); zero columns leave every dot product unchanged."""
    d = z.shape[1]
    return z if d % 4 == 0 else torch.nn.functional.pad(z, (0, -d % 4))


def nt_xent_fwd(z: torch.Tensor, pos_idx: torch.Tensor, inv_tau: float
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: (loss rows, m, l) of CUDA rows ``z``."""
    _check(z, pos_idx)
    _check_kernel_args(z, pos_idx)
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        load_library,
        multiprocessors,
        on_device,
    )

    n = z.shape[0]
    zp = _pad4(z)
    d = zp.shape[1]
    sms = multiprocessors(z.device)
    loss, m, l = (torch.empty(n, dtype=torch.float32, device=z.device)
                  for _ in range(3))
    with on_device(z.device):
        rc = load_library().hipac_nt_xent_fwd(
            zp.data_ptr(), pos_idx.data_ptr(), n, d, inv_tau, loss.data_ptr(),
            m.data_ptr(), l.data_ptr(), fwd_tile(n, d, sms),
            fwd_splits(n, d, sms), torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "nt_xent_fwd")
    count_launch(nt_xent_fwd)
    return loss, m, l


def bwd_splits(n: int, d: int, sms: int) -> int:
    """Blocks (1, 2, 4 or 8: one cluster) that the backward kernel splits the
    64-wide column tiles of each 64-row block over: doubled while the grid
    (row blocks × slices of 128 columns of dz × splits) has fewer blocks than
    the card has SMs and every split keeps a tile (2N = 1024: 8, 128 blocks;
    2N = 32768: 1)."""
    row_blocks = tiles = -(-n // 64)
    base = row_blocks * -(-d // 128)
    splits = 1
    while splits < 8 and 2 * splits <= tiles and base * splits < sms:
        splits *= 2
    return splits


def nt_xent_bwd(z: torch.Tensor, pos_idx: torch.Tensor, m: torch.Tensor,
                l: torch.Tensor, g: torch.Tensor, inv_tau: float
                ) -> torch.Tensor:
    """Launch the backward kernel: dL/dz for upstream gradient ``g`` of the
    loss rows (dead rows' entries of ``g`` are ignored). Rows whose width is
    not a multiple of 4 go through the kernel zero-padded to one (bulk
    copies move 16-byte pieces); the padding's gradient is dropped."""
    _check(z, pos_idx)
    _check_kernel_args(z, pos_idx)
    for name, t in (("m", m), ("l", l), ("g", g)):
        if (t.dtype != torch.float32 or t.shape != z.shape[:1]
                or t.device != z.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({z.shape[0]},) "
                             f"float32 tensor on {z.device}")
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        load_library,
        multiprocessors,
        on_device,
    )

    n, d = z.shape
    zp = _pad4(z)
    dz = torch.empty_like(zp)
    sms = multiprocessors(z.device)
    with on_device(z.device):
        rc = load_library().hipac_nt_xent_bwd(
            zp.data_ptr(), pos_idx.data_ptr(), m.data_ptr(), l.data_ptr(),
            g.data_ptr(), n, zp.shape[1], inv_tau, dz.data_ptr(),
            bwd_splits(n, zp.shape[1], sms),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "nt_xent_bwd")
    count_launch(nt_xent_bwd)
    return dz if d % 4 == 0 else dz[:, :d].contiguous()


nt_xent_fwd.launches = 0
nt_xent_bwd.launches = 0


class _NTXentRows(torch.autograd.Function):
    """Loss rows from the forward kernel; dz from the backward kernel."""

    @staticmethod
    def forward(ctx, z, pos_idx, inv_tau):
        loss, m, l = nt_xent_fwd(z, pos_idx, inv_tau)
        ctx.save_for_backward(z, pos_idx, m, l)
        ctx.inv_tau = inv_tau
        ctx.mark_non_differentiable(m, l)
        return loss, m, l

    @staticmethod
    def backward(ctx, g, _g_m, _g_l):
        z, pos_idx, m, l = ctx.saved_tensors
        # a dead row's loss is hard zero, so its upstream gradient must not
        # leak into the recomputed scores
        g = torch.where(pos_idx >= 0, g.float(), 0.0).contiguous()
        return nt_xent_bwd(z, pos_idx, m, l, g, ctx.inv_tau), None, None


def nt_xent_rows(z: torch.Tensor, pos_idx: torch.Tensor, temperature: float
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss rows, m, l) of L2-normalised rows ``z`` (n, d) float32 with
    positive partners ``pos_idx`` (n,) int32 (< 0: dead row). The loss rows
    carry the gradient; a CUDA tensor goes through the kernels, a CPU
    tensor through :func:`nt_xent_rows_reference`."""
    _check(z, pos_idx)
    if z.device.type == "cpu":
        return nt_xent_rows_reference(z, pos_idx, temperature)
    _check_kernel_args(z, pos_idx)
    return _NTXentRows.apply(z, pos_idx, 1.0 / temperature)


def nt_xent_loss_kernel(z_i: torch.Tensor, z_j: torch.Tensor,
                        temperature: float = 0.5,
                        valid: torch.Tensor | None = None,
                        group=None) -> torch.Tensor:
    """Mean NT-Xent over the 2n rows of two views' projections (n, D): the
    counterpart of ``nt_xent_loss_pallas`` and the same function as
    ``models/simclr.py::nt_xent_loss``.

    ``valid`` (n,) bool drops rows (and their partners' view) from the mean
    and from every other row's denominator.

    ``group``: the rows are this rank's shard of the global batch, as in
    ``nt_xent_loss``. Every rank gathers the (2N, D) global matrix and runs
    the kernels on all of it; the value is the global loss L and the
    gradient that of L / W, so that the gradients summed over the W ranks
    (the gather's backward sums them) are L's. A kernel over this rank's
    rows against the gathered columns is later work.
    """
    if group is not None:
        from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.collectives import (
            gather_rows,
        )
        from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.mesh import (
            rank_and_size,
        )

        world = rank_and_size(group)[1]
        full_valid = None
        if valid is not None:
            full_valid = gather_rows(valid.float(), group).detach() > 0.5
        loss = nt_xent_loss_kernel(gather_rows(z_i.float(), group),
                                   gather_rows(z_j.float(), group),
                                   temperature, full_valid)
        share = loss / world
        return share + (loss - share).detach()
    n = z_i.shape[0]
    z = torch.cat([z_i, z_j]).float()
    z = z / torch.clamp_min(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                            1e-12)
    ar = torch.arange(n, dtype=torch.int32, device=z.device)
    pos_idx = torch.cat([ar + n, ar])
    if valid is not None:
        mask2 = torch.cat([valid, valid]).bool()
        pos_idx = torch.where(mask2, pos_idx, -1)
        denom = mask2.sum().clamp(min=1)
    else:
        denom = 2 * n
    rows, _, _ = nt_xent_rows(z.contiguous(), pos_idx, temperature)
    return rows.sum() / denom
