"""Autograd-aware collectives over a process group.

The JAX package's data-parallel math calls ``jax.lax.all_gather``, ``psum``
and ``pmax`` inside its SPMD programs (``models/simclr.py::nt_xent_loss``,
``models/mil.py::sharded_attention_pool``, and the global BatchNorm that
XLA partitions). Here each is a ``torch.distributed`` call whose gradient
is the transpose JAX uses:

- :func:`gather_rows`: every rank's rows stacked in rank order. The forward
  writes this rank's rows into a zero buffer of the global shape and sums
  the buffers over the group, which is exact in float (a sum with zeros is
  the value) and needs only ``all_reduce``, which gloo has for CPU and CUDA
  tensors alike (``all_gather`` it has for the CPU only). The backward sums
  the incoming gradients over the group and keeps this rank's rows.
- :func:`all_reduce_sum`: the sum over the group; its backward is the sum of
  the incoming gradients (each rank's output feeds every rank's loss).
- :func:`all_reduce_max`: the maximum, without a gradient (it only shifts a
  softmax, which does not depend on the shift).
- :func:`sum_of_shares`: a loss whose value is the global loss on every rank
  and whose gradient is this rank's share of it, so that the gradients
  summed over the ranks (:func:`all_reduce_grads`) are the global loss's;
- :func:`global_batch_norm`: training BatchNorm over the group's global
  batch on CUDA tensors, from PyTorch's synchronized-BatchNorm kernels;
- :func:`epoch_totals`: an epoch's summed step metrics, the group's.

``torch.distributed.nn.functional.all_gather`` is not used: on backends
other than NCCL its backward goes through ``all_to_all``, which gloo lacks
for CUDA tensors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _world(group) -> tuple[int, int]:
    return dist.get_rank(group), dist.get_world_size(group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        rank, world = _world(group)
        n = x.shape[0]
        out = x.new_zeros((world * n, *x.shape[1:]))
        out[rank * n:(rank + 1) * n] = x
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        ctx.group, ctx.rows = group, (rank * n, (rank + 1) * n)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        start, stop = ctx.rows
        return g[start:stop], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(n, ...) rows of every rank → (world·n, ...), rank r's rows at
    [r·n, (r+1)·n); differentiable. Every rank must pass the same shape."""
    return _GatherRows.apply(x.contiguous(), group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``; differentiable."""
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks (no gradient)."""
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def sum_of_shares(share: torch.Tensor, group) -> torch.Tensor:
    """A scalar whose value is the sum of every rank's ``share`` and whose
    gradient is this rank's ``share``'s."""
    total = all_reduce_sum(share.detach(), group)
    return share + (total - share.detach())


@torch.no_grad()
def all_reduce_grads(params, group) -> None:
    """Sum the gradients of ``params`` over the ranks, in one flat bucket
    (one collective a step); parameters without a gradient are skipped, the
    same ones on every rank."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


@torch.no_grad()
def epoch_totals(metrics: list, group=None, device=None) -> dict:
    """The summed ``loss``, ``correct`` and ``count`` of an epoch's step
    metrics (dicts of 0-d tensors) as floats. Each step's loss is its global
    batch's already; ``correct`` and ``count`` are summed over ``group``'s
    ranks, every one of which must call this (with as many steps).
    ``device`` holds the zeros of an epoch without steps."""
    keys = ("loss", "correct", "count")
    sums = (torch.stack([torch.stack([m[k].float() for m in metrics]).sum()
                         for k in keys]) if metrics
            else torch.zeros(len(keys), device=device))
    if group is not None:
        counts = sums[1:].clone()
        dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
        sums = torch.cat([sums[:1], counts])
    return dict(zip(keys, sums.tolist()))


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """(k,) of every rank → (world, k), without autograd (see
    :func:`gather_rows`)."""
    rank, world = _world(group)
    out = x.new_zeros((world, x.shape[0]))
    out[rank] = x
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _GlobalBatchNorm(torch.autograd.Function):
    """``nn.SyncBatchNorm``'s forward and backward (its kernels and its
    collectives, the gather done by :func:`_gather`) without its running
    statistics: it returns the global mean and inverse deviation instead."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        mean, invstd = torch.batch_norm_stats(x, eps)
        count = torch.full((1,), x.numel() // c, dtype=mean.dtype,
                           device=mean.device)
        stats = _gather(torch.cat([mean, invstd, count]), group)
        mean_all, invstd_all, count_all = torch.split(stats, c, dim=1)
        # scratch running statistics (left as they are at momentum 0) make
        # the kernel take float32 counts: without them it wants the input's
        # dtype, and bfloat16 does not hold a count like 256·56·56
        scratch = torch.zeros(c, dtype=mean.dtype, device=mean.device)
        mean, invstd = torch.batch_norm_gather_stats_with_counts(
            x, mean_all, invstd_all, scratch, scratch.clone(), 0.0, eps,
            count_all.view(-1))
        ctx.save_for_backward(x, weight, mean, invstd,
                              count_all.to(torch.int32))
        ctx.group = group
        ctx.mark_non_differentiable(mean, invstd)
        return torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps), \
            mean, invstd

    @staticmethod
    def backward(ctx, g, _g_mean, _g_invstd):
        x, weight, mean, invstd, counts = ctx.saved_tensors
        fmt = (torch.channels_last if x.is_contiguous(
            memory_format=torch.channels_last) else torch.contiguous_format)
        g = g.contiguous(memory_format=fmt)
        sum_dy, sum_dy_xmu, grad_w, grad_b = torch.batch_norm_backward_reduce(
            g, x, mean, invstd, weight, True, True, True)
        sums = torch.cat([sum_dy, sum_dy_xmu])
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=ctx.group)
        sum_dy, sum_dy_xmu = torch.split(sums, x.shape[1])
        grad_x = torch.batch_norm_backward_elemt(
            g, x, mean, invstd, weight, sum_dy, sum_dy_xmu, counts)
        return grad_x, grad_w, grad_b, None, None


def global_batch_norm(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, eps: float, group):
    """Training BatchNorm of a CUDA (N, C, H, W) batch with the statistics
    of the group's global batch: (y in ``x``'s dtype, global mean, global
    biased variance), the last two detached. The weight and bias
    gradients are this rank's (summed over the ranks with the other
    gradients)."""
    if not (x.is_contiguous(memory_format=torch.channels_last)
            or x.is_contiguous()):
        x = x.contiguous()
    y, mean, invstd = _GlobalBatchNorm.apply(x, weight, bias, eps, group)
    return y, mean, invstd.pow(-2) - eps
