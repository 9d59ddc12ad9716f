"""Build and bind the port's CUDA kernels: nvcc → shared libraries → ctypes.

The sources under ``ops/csrc/`` expose plain C entry points (no PyTorch
headers), so ``nvcc`` builds each in seconds. Each source becomes a library
of its own, all compiled at once (one ``nvcc`` process per source), at first
use, into ``ops/_build/`` (listed in ``.gitignore``), under a name keyed by
that source, the shared headers and the flags: an edited source builds anew, an unchanged one
loads the library already there. Nothing is built or imported when this
module is imported, so CPU-only installations import it freely. The build
and the launch counts take a lock: the slide fleet launches from one
thread per device group.

No ``--use_fast_math``: the normalize and augment kernels' divisions must
be the IEEE quotient so that they equal their plain PyTorch versions bit
for bit, the
NT-Xent and MIL-pool kernels' ``expf``/``logf``/``tanhf`` stay the
accurate ones, and the stem kernels' float32 adds stay IEEE adds. The int8
kernels write their float32 epilogue with the explicitly rounded intrinsics
(``__fmul_rn``, ``__fadd_rn``, ``__fdiv_rn``), which nvcc never contracts
into an FMA.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import types
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
# source → C signature of each of its entry points: name → (argtypes, restype)
SOURCES = {
    "fused_normalize.cu": {
        "hipac_fused_normalize": (
            [_P, _P, _P, _I64, _I64, _I32, _F32, _F32, _F32, _F32, _F32, _F32,
             _P],
            ctypes.c_int,
        ),
    },
    "augment.cu": {
        # in, hflip, vflip, k, k_words, d4 table, mat, fb, fc, out, batch, s,
        # inv255, mean255 x3, std255 x3, stream
        "hipac_augment": (
            [_P, _P, _P, _P, _I32, ctypes.c_ulonglong, _P, _P, _P, _P, _I64,
             _I32, _F32, _F32, _F32, _F32, _F32, _F32, _F32, _P],
            ctypes.c_int,
        ),
        "hipac_augment_max_size": ([], ctypes.c_int),
    },
    "nt_xent.cu": {
        # z, pos_idx, n_rows, d, inv_tau, loss, m, l, tile, splits, stream
        "hipac_nt_xent_fwd": ([_P, _P, _I64, _I64, _F32, _P, _P, _P, _I32,
                               _I32, _P],
                              ctypes.c_int),
        # z, pos_idx, m, l, g, n_rows, d, inv_tau, dz, splits, stream
        "hipac_nt_xent_bwd": ([_P, _P, _P, _P, _P, _I64, _I64, _F32, _P, _I32,
                               _P],
                              ctypes.c_int),
    },
    "mil_pool.cu": {
        # h, mask, v, vb, w, b, k, d, hd, cs, runs, resident, stages, ws_m,
        # ws_l, ws_acc, tickets, out, stream
        "hipac_mil_attention_pool": (
            [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I32, _I32, _I32,
             _I32, _P, _P, _P, _P, _P, _P],
            ctypes.c_int,
        ),
        # d, hd, cs, resident, stages, clusters (out)
        "hipac_mil_pool_active_clusters": (
            [_I64, _I64, _I32, _I32, _I32, ctypes.POINTER(ctypes.c_int)],
            ctypes.c_int,
        ),
    },
    "bias_relu_pool.cu": {
        # x, bias, out, b, h, w, c, bias_map, in_bf16, out_bf16, stream
        "hipac_bias_relu_pool": (
            [_P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _I32, _P],
            ctypes.c_int,
        ),
    },
    "fused_stem.cu": {
        # in2, w2, bias, out, b, hin, win, pool_rows, bias_map, out_bf16,
        # stream
        "hipac_fused_stem": (
            [_P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _P],
            ctypes.c_int,
        ),
        # in2, wimg, bias, out, b, hin, win, pool_rows, blocks, tiles,
        # bias_map, bias_bf16, out_bf16, stream
        "hipac_fused_stem_wgmma": (
            [_P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _I32, _I32,
             _I32, _P],
            ctypes.c_int,
        ),
    },
    "int8_conv.cu": {
        # x, wt, mscale, bias, bias_map, s_out, residual, res_kind, res_scale,
        # out, out_f32, relu, b, h, w, cin, cout, kh, kw, stride, pad_top,
        # pad_left, ho, wo, stream
        "hipac_int8_conv_requant": (
            [_P, _P, _P, _P, _I32, _P, _P, _I32, _P, _P, _I32, _I32, _I64,
             _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32,
             _P],
            ctypes.c_int,
        ),
    },
    "int8_pool.cu": {
        # x, out, b, h, w, c, stream
        "hipac_int8_maxpool": ([_P, _P, _I64, _I32, _I32, _I32, _P],
                               ctypes.c_int),
    },
    "int8_block.cu": {
        # x, wt, mscales, biases, scalars, out, b, h, w, rows, cluster, stream
        "hipac_fused_stage1_int8": (
            [_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _P],
            ctypes.c_int,
        ),
        # h, w, rows, cluster, clusters (out)
        "hipac_fused_stage1_int8_active_clusters": (
            [_I32, _I32, _I32, _I32, ctypes.POINTER(ctypes.c_int)],
            ctypes.c_int,
        ),
    },
}


def find_nvcc() -> str:
    """``nvcc`` of the CUDA toolkit PyTorch found, else the one on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found (no CUDA toolkit under CUDA_HOME or on PATH); "
            "the CUDA kernels cannot be built"
        )
    return path


def library_path(source: str) -> Path:
    """Where the library built from ``source`` and the flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC_DIR / source).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):  # shared by the sources
        h.update(header.read_bytes())
    return BUILD_DIR / f"libhipac_{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build() -> list[Path]:
    """Compile every source whose library does not exist yet, all at once;
    return the libraries. Concurrent processes each write a private file
    and rename it into place."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for source in SOURCES:
        so = library_path(source)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((so, tmp, cmd, proc))
    failed = []
    for so, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, so)
        else:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                          f"{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return [library_path(source) for source in SOURCES]


_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (a kernel wrapper's count), under a
    lock: ``+= 1`` on an attribute is no atomic step between threads."""
    with _LOCK:
        wrapper.launches += 1


def load_library() -> types.SimpleNamespace:
    """Every entry point of the built libraries, signatures set, as
    attributes of one namespace (``load_library().hipac_nt_xent_fwd``);
    built and loaded once, by the first thread that asks."""
    with _LOCK:
        return _load_library()


@functools.cache
def _load_library() -> types.SimpleNamespace:
    build()
    entry_points = {}
    for source, signatures in SOURCES.items():
        lib = ctypes.CDLL(str(library_path(source)))
        for name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
            entry_points[name] = fn
    return types.SimpleNamespace(**entry_points)


def on_device(device):
    """``torch.cuda.device(device)``, or nothing when ``device`` is already
    the current one: entering the context costs a few microseconds a
    launch, more than a small kernel takes on the card."""
    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


@functools.cache
def multiprocessors(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count
