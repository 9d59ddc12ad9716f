"""Streaming masked MIL attention pooling on a hand-written CUDA kernel.

Counterpart of the JAX package's ``ops/pallas/mil_pool.py``
(``mil_attention_pool_pallas``, kernel ``_kernel``): for padded bags
``h`` (B, K, D) with ``mask`` (B, K),

    a_k = w · tanh(h_k V + b),   bag = Σ_k softmax(a)_k · h_k,

with masked slots at the logit −1e30, without holding the (B, K, H) tanh
activations in device memory. Forward only, as in JAX: training pools
through the module (``models/mil.py``).

- :func:`mil_attention_pool_kernel` launches ``ops/csrc/mil_pool.cu`` on
  CUDA tensors (``mil_attention_pool_kernel.launches`` counts the launches)
  and raises on anything it does not take.
- :func:`mil_attention_pool_reference` is the plain PyTorch version: the
  CPU tests hold it against the JAX kernel, the card's checks hold the
  kernel against it.
- :func:`mil_attention_pool` sends a CUDA tensor to the kernel and a CPU
  tensor to the plain version.

A bag without a real instance pools to the mean of its K rows: every
logit is −1e30, so each weight is exp(0) = 1 (the Pallas kernel and the flax
module give the same).
"""

from __future__ import annotations

import torch

#: Logit of a masked slot, as the Pallas kernel's.
NEG_INF = -1e30
#: Widest instances and attention the kernel takes: it stages h in depth
#: chunks of 32 and V in 128-wide slices, so any width up to these works.
MAX_D = 4096
MAX_H = 512
#: Instances of one partial block of the kernel (its workspace rows).
BLOCK_K = 32


def _check(h, mask, v, w, v_bias) -> None:
    if h.dim() != 3 or min(h.shape) < 1:
        raise ValueError(f"expected (B, K, D) instances, got {tuple(h.shape)}")
    b, k, d = h.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"instance width {d} outside 1..{MAX_D}")
    if mask.shape != (b, k):
        raise ValueError(f"expected a ({b}, {k}) mask, got {tuple(mask.shape)}")
    if v.dim() != 2 or v.shape[0] != d or not 1 <= v.shape[1] <= MAX_H:
        raise ValueError(f"expected V of ({d}, H) with 1 <= H <= {MAX_H}, "
                         f"got {tuple(v.shape)}")
    hd = v.shape[1]
    if w.shape != (hd,) or (v_bias is not None and v_bias.shape != (hd,)):
        raise ValueError(f"expected w and v_bias of ({hd},)")
    for t in (mask, v, w) + (() if v_bias is None else (v_bias,)):
        if t.device != h.device:
            raise ValueError(f"h on {h.device}, another input on {t.device}")


def mil_attention_pool_reference(h: torch.Tensor, mask: torch.Tensor,
                                 v: torch.Tensor, w: torch.Tensor,
                                 v_bias: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Plain version: (B, D) float32 pooled bags, dense in K."""
    _check(h, mask, v, w, v_bias)
    h = h.float()
    t = h @ v.float()
    if v_bias is not None:
        t = t + v_bias.float()
    a = torch.tanh(t) @ w.float()  # (B, K)
    a = torch.where(mask.bool(), a, NEG_INF)
    p = torch.exp(a - a.amax(dim=1, keepdim=True))
    l = p.sum(dim=1, keepdim=True)
    return (p[:, None, :] @ h)[:, 0] / torch.clamp_min(l, 1e-30)


def mil_attention_pool_kernel(h: torch.Tensor, mask: torch.Tensor,
                              v: torch.Tensor, w: torch.Tensor,
                              v_bias: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Launch the kernel: (B, D) float32 pooled bags of contiguous float32
    CUDA tensors ``h`` (B, K, D), ``v`` (D, H), ``w`` and ``v_bias`` (H,)
    and a bool ``mask`` (B, K). Raises on anything else."""
    _check(h, mask, v, w, v_bias)
    if h.device.type != "cuda":
        raise ValueError(f"the MIL pool kernel runs on CUDA tensors, not {h.device}")
    if v_bias is None:
        v_bias = torch.zeros_like(w)
    floats = (h, v, w, v_bias)
    if any(t.dtype != torch.float32 for t in floats) or mask.dtype != torch.bool:
        raise ValueError("the MIL pool kernel takes float32 h, v, w, v_bias "
                         "and a bool mask")
    if not all(t.is_contiguous() for t in (*floats, mask)):
        raise ValueError("the MIL pool kernel needs contiguous inputs")
    b, k, d = h.shape
    if b > 65535:
        raise ValueError(f"{b} bags in one call; the kernel takes <= 65535")
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        load_library,
    )

    nblk = -(-k // BLOCK_K)
    ws = torch.empty(b * nblk * (d + 2), dtype=torch.float32, device=h.device)
    ws_m, ws_l, ws_acc = ws[:b * nblk], ws[b * nblk:2 * b * nblk], ws[2 * b * nblk:]
    out = torch.empty(b, d, dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        rc = load_library().hipac_mil_attention_pool(
            h.data_ptr(), mask.data_ptr(), v.data_ptr(), v_bias.data_ptr(),
            w.data_ptr(), b, k, d, v.shape[1], ws_m.data_ptr(),
            ws_l.data_ptr(), ws_acc.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mil_attention_pool kernel launch failed: "
                           f"cudaError {rc}")
    mil_attention_pool_kernel.launches += 1
    return out


mil_attention_pool_kernel.launches = 0


def mil_attention_pool(h: torch.Tensor, mask: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, v_bias: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Masked attention pooling of padded bags, the counterpart of
    ``mil_attention_pool_pallas`` (any K: no block multiple is needed).

    Args:
        h: (B, K, D) instance features.
        mask: (B, K), True (non-zero) = real instance.
        v: (D, H) attention projection; w: (H,) scoring vector;
        v_bias: optional (H,) bias of the projection.

    Returns:
        (B, D) float32 pooled bags: the kernel's for CUDA tensors, the
        plain version's for CPU tensors.
    """
    if h.device.type == "cpu":
        return mil_attention_pool_reference(h, mask, v, w, v_bias)
    return mil_attention_pool_kernel(
        h.float().contiguous(), mask.bool().contiguous(),
        v.float().contiguous(), w.float().contiguous(),
        None if v_bias is None else v_bias.float().contiguous())
