"""SimCLR model and the dense NT-Xent loss.

Counterpart of the JAX package's ``models/simclr.py``: a ResNet18 encoder
(fc-stripped, 512 features) and a projector 512 → 512 → ReLU → 128, and the
NT-Xent loss over the (2N, 2N) similarity matrix. Its ``group`` is the JAX
loss's ``axis_name``: each rank holds n rows of each view, and scores them
against the columns of every rank (``parallel/collectives.py::gather_rows``).
``loss_impl="pallas"`` swaps in the streaming kernels of ``ops/nt_xent.py``
for :func:`nt_xent_loss`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
    ResNet18FeatureExtractor,
)

_NEG_INF = -1e9


class SimCLRModel(nn.Module):
    """Encoder + projection head. ``forward`` returns float32 projections
    (B, projection_dim); ``encode`` the encoder's (B, 512) features.

    Parameters are float32. On the card the trainer runs the model under
    bf16 autocast, as the JAX model computes in bf16 over float32
    parameters. Initialised from ``generator`` (seed 0 when none is given):
    the encoder as ``ResNet``, the projector's weights LeCun-normal and its
    biases zero.
    """

    def __init__(self, projection_dim: int = 128,
                 projection_hidden_dim: int = 512,
                 generator: torch.Generator | None = None):
        super().__init__()
        generator = (generator if generator is not None
                     else torch.Generator().manual_seed(0))
        self.encoder = ResNet18FeatureExtractor(generator=generator)
        self.projector = nn.Sequential(
            nn.Linear(512, projection_hidden_dim),
            nn.ReLU(),
            nn.Linear(projection_hidden_dim, projection_dim),
        )
        with torch.no_grad():
            for layer in (self.projector[0], self.projector[2]):
                layer.weight.normal_(0.0, 1.0 / math.sqrt(layer.in_features),
                                     generator=generator)
                layer.bias.zero_()
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalized images → (B, projection_dim) float32."""
        return self.projector(self.encoder(x)).float()

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)


def _normalize(z: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return z / torch.clamp_min(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                               eps)


def nt_xent_loss(z_i: torch.Tensor, z_j: torch.Tensor,
                 temperature: float = 0.5,
                 valid: torch.Tensor | None = None,
                 group=None) -> torch.Tensor:
    """Normalized-temperature cross-entropy of two views' projections
    (n, D): the mean over the valid ones of the 2n rows.

    ``valid`` (n,) bool: False rows (a wrap-padded final batch) drop out of
    the mean and of every other row's softmax denominator. Scores are
    multiplied by 1/τ (what PyTorch's CUDA division by a host scalar does
    anyway).

    ``group``: the rows are this rank's shard of a global batch of N = n·W
    (rank r holds rows [r·n, (r+1)·n) of each view), as the JAX loss's
    ``axis_name``: the local 2n rows are scored against the gathered 2N
    columns, each local row's global index masking its self score. The
    value is the global mean on every rank; the gradient is this rank's
    share (its rows' loss sum over the global valid count), so the
    gradients summed over the ranks are the global loss's.
    """
    z_i = _normalize(z_i.float())
    z_j = _normalize(z_j.float())
    n = z_i.shape[0]
    dev = z_i.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid = valid.bool()
    valid2 = torch.cat([valid, valid])
    if group is None:
        z_full, valid_full, g, big_n = torch.cat([z_i, z_j]), valid2, 0, n
    else:
        from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.collectives import (
            gather_rows,
        )
        from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.mesh import (
            rank_and_size,
        )

        rank, world = rank_and_size(group)
        big_n, g = n * world, rank * n
        z_full = torch.cat([gather_rows(z_i, group), gather_rows(z_j, group)])
        gathered = gather_rows(valid.float(), group).detach() > 0.5
        valid_full = torch.cat([gathered, gathered])
    ar = torch.arange(n, device=dev)
    # global row indices of the local rows, and their positive partners
    local_rows = torch.cat([g + ar, big_n + g + ar])
    pos_cols = torch.cat([big_n + g + ar, g + ar])
    z = torch.cat([z_i, z_j])  # (2n, D)
    sim = (z @ z_full.T) * (1.0 / temperature)  # (2n, 2N)
    cols = torch.arange(2 * big_n, device=dev)
    dead = (cols[None, :] == local_rows[:, None]) | ~valid_full[None, :]
    sim = sim.masked_fill(dead, _NEG_INF)
    pos = sim.gather(1, pos_cols[:, None])[:, 0]
    row_loss = torch.where(valid2, -pos + torch.logsumexp(sim, dim=1), 0.0)
    if group is None:
        return row_loss.sum() / valid2.sum().clamp(min=1)
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.collectives import (
        all_reduce_sum,
        sum_of_shares,
    )

    count = all_reduce_sum(valid2.sum().float(), group)
    return sum_of_shares(row_loss.sum() / count.clamp(min=1), group)
