"""Build and bind the port's CUDA kernels: nvcc → shared library → ctypes.

The sources under ``ops/csrc/`` expose plain C entry points (no PyTorch
headers), so one ``nvcc`` call builds them in seconds. The build happens at
first use, into ``ops/_build/`` (listed in ``.gitignore``), under a name
keyed by the sources and flags: an edited source builds anew, an unchanged
one loads the library already there. Nothing is built or imported when this
module is imported, so CPU-only installations import it freely.

No ``--use_fast_math``: the normalize kernel's division must be the IEEE
quotient so that it equals its plain PyTorch version bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("fused_normalize.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
# C signature of every entry point: name → (argtypes, restype)
_SIGNATURES = {
    "hipac_fused_normalize": (
        [_P, _P, _P, _I64, _I64, _I32, _F32, _F32, _F32, _F32, _F32, _F32, _P],
        ctypes.c_int,
    ),
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


def library_path() -> Path:
    """Where the library built from the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libhipac_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists; return it.
    Concurrent processes each write a private file and rename it into
    place."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC_DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)
    return so


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built kernel library with every entry point's signature set."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
