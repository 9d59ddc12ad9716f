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
  and raises on anything it does not take. :func:`pool_layout` and
  :func:`pool_runs` are its plan: the cluster that splits D, whether V
  stays resident, and the runs of 64-instance tiles a bag is split into.
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

import ctypes
import functools

import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
    count_launch,
)

#: Logit of a masked slot, as the Pallas kernel's.
NEG_INF = -1e30
#: Widest instances and attention the kernel takes (it splits D over a
#: cluster and H into slices of 128, so any width up to these works).
MAX_D = 4096
MAX_H = 512
#: Instances of one tile of the kernel, width of a slice of H.
TILE_K = 64
SLICE_H = 128
#: Widest depth slice of a block (its acc columns: 2 a thread).
MAX_SLICE = 512
#: Runs (partials) one bag is split into, at most; clusters the kernel forms.
MAX_RUNS = 256
CLUSTERS = (1, 2, 4, 8)
#: Dynamic shared memory a block of the kernel may use (bytes).
SMEM_CAP = 227 * 1024


def _ceil4(x: int) -> int:
    return -(-x // 4) * 4


def _h_pitch(ds: int) -> int:
    return ds + (8 if ds % 8 else 4)


def pool_smem(ds: int, h: int, resident: bool, stages: int) -> int:
    """Bytes of dynamic shared memory of a kernel block whose depth slice is
    ``ds`` wide (``mil_pool.cu::pool_smem``): V's slice when resident (rows
    padded by 8 floats), the h ring, the exchange buffer, vb and w, the
    tile's scores and mask, merge weights."""
    return 4 * ((ds * (h + 8) if resident else 0) + stages * TILE_K * _h_pitch(ds)
                + TILE_K * (SLICE_H + 4) + 2 * h + 4 * TILE_K + MAX_RUNS)


@functools.cache
def pool_layout(d: int, h: int) -> tuple[int, int, bool, int]:
    """(cluster, depth slice, V resident, ring stages) of the kernel for
    instances of width ``d`` and attention width ``h``: the smallest cluster
    whose blocks keep their slice of V resident beside a 2-deep ring of h
    tiles, else one stage, else V read from device memory; chosen by shape.
    At D = 512, H = 128: a cluster of 4, slices of 128, V resident."""
    d4, h4 = _ceil4(d), _ceil4(h)
    for resident, stages in ((True, 2), (True, 1), (False, 2), (False, 1)):
        for cs in CLUSTERS:
            ds = _ceil4(-(-d4 // cs))
            if ds <= MAX_SLICE and pool_smem(ds, h4, resident, stages) <= SMEM_CAP:
                return cs, ds, resident, stages
    raise ValueError(f"no kernel layout for D={d}, H={h}")  # not reached


def pool_runs(b: int, k: int, slots: int) -> int:
    """Runs each of ``b`` bags of ``k`` instances is split into: as many as
    fill the ``slots`` clusters the card runs at once, each run keeping at
    least one tile of 64 instances (an H100 runs 30 clusters of 4 at once:
    K = 4096 gives 30 runs of 2–3 tiles, K = 65536 30 runs of 34–35)."""
    tiles = -(-k // TILE_K)
    return max(1, min(tiles, slots // b, MAX_RUNS))


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


@functools.cache
def _active_clusters(device: torch.device, d: int, h: int, cs: int,
                     resident: bool, stages: int) -> int:
    """Clusters of a layout the card runs at once
    (``cudaOccupancyMaxActiveClusters``)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.build import (
        load_library,
    )

    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = load_library().hipac_mil_pool_active_clusters(
            d, h, cs, int(resident), stages, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: cudaError {rc}")
    return max(count.value, 1)


_TICKETS: dict[tuple[torch.device, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream, b: int) -> torch.Tensor:
    """The kernel's per-bag tickets on one stream: zeros, which every launch
    leaves zero again; grown as needed."""
    key = (device, stream.cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < b:
        t = torch.zeros(max(b, 64), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


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
        on_device,
    )

    hd = v.shape[1]
    cs, _, resident, stages = pool_layout(d, hd)
    # widths to multiples of 4 (16-byte bulk copies): zero columns of h and
    # rows of V leave every score unchanged, zero columns of V with w = 0
    # add nothing; the padding's pooled columns are dropped
    if d % 4:
        h = torch.nn.functional.pad(h, (0, -d % 4))
        v = torch.nn.functional.pad(v, (0, 0, 0, -d % 4))
    if hd % 4:
        v = torch.nn.functional.pad(v, (0, -hd % 4))
        w = torch.nn.functional.pad(w, (0, -hd % 4))
        v_bias = torch.nn.functional.pad(v_bias, (0, -hd % 4))
    # 16-byte aligned rows for the bulk copies
    h, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (h, v))
    d4, h4 = h.shape[2], v.shape[1]
    runs = pool_runs(b, k, _active_clusters(h.device, d4, h4, cs, resident,
                                            stages))
    ws = torch.empty(b * runs * (d4 + 2), dtype=torch.float32, device=h.device)
    ws_m, ws_l, ws_acc = ws[:b * runs], ws[b * runs:2 * b * runs], ws[2 * b * runs:]
    out = torch.empty(b, d4, dtype=torch.float32, device=h.device)
    stream = torch.cuda.current_stream(h.device)
    with on_device(h.device):
        rc = load_library().hipac_mil_attention_pool(
            h.data_ptr(), mask.data_ptr(), v.data_ptr(), v_bias.data_ptr(),
            w.data_ptr(), b, k, d4, h4, cs, runs, int(resident), stages,
            ws_m.data_ptr(), ws_l.data_ptr(), ws_acc.data_ptr(),
            _tickets(h.device, stream, b).data_ptr(), out.data_ptr(),
            stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mil_attention_pool kernel launch failed: "
                           f"cudaError {rc}")
    count_launch(mil_attention_pool_kernel)
    return out if d4 == d else out[:, :d].contiguous()


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
