"""Build and bind the port's CUDA kernels: nvcc → shared libraries → ctypes.

The sources under ``ops/csrc/`` expose plain C entry points (no PyTorch
headers), so ``nvcc`` builds each in seconds. Each source becomes a library
of its own, all compiled at once (one ``nvcc`` process per source), at first
use, into the library cache (``ops/_build/``, listed in ``.gitignore``, or
the directory :func:`set_build_dir` names: the CLI's
``--compile_cache_dir``), under a name keyed by that source, the shared
headers and the flags: an edited source builds anew, an unchanged one
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
into an FMA. The t-SNE repulsion kernel asks for the approximate float32
reciprocal where it wants it, by an explicit ``rcp.approx``.

Beside them, :func:`host_library` builds the two host libraries of
``io/native/`` with the system's C++ compiler (the first of ``$CXX``,
``c++`` and ``g++`` that builds OpenMP code):
``libhipac_chunk_<hash>.so`` (the OpenMP chunk processor, nothing else) and
``libhipac_tiff_<hash>.so`` (the tiled TIFF reader and writer, on
libtiff). Where the compiler finds ``<tiffio.h>`` the TIFF library links
``-ltiff``; where it does not, it compiles against ``io/native/tiff_abi.h``
and links the libtiff that the loader knows (``libtiff.so.N``), else the
copy that Pillow's wheel carries. Each is built at first use, by one
process at a time (an ``fcntl`` lock), into a private file renamed into
place; a failed build raises with the compiler's output.
"""

from __future__ import annotations

import atexit
import contextlib
import ctypes
import ctypes.util
import fcntl
import functools
import hashlib
import importlib.util
import os
import shutil
import subprocess
import tempfile
import threading
import types
from pathlib import Path

from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)

log = get_logger("torch.ops.build")

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
#: the library cache: device and host libraries alike
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
    "stem_train.cu": {
        # x, gamma, beta, running_mean, running_var, out, codes, stats, part,
        # ticket, b, h, w, blocks, eps, momentum, stream
        "hipac_stem_train_fwd": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32,
             _F32, _F32, _P],
            ctypes.c_int,
        ),
        # x, dy, codes, stats, gamma, beta, dx, sums, part, ticket, b, h, w,
        # blocks, stream
        "hipac_stem_train_bwd": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32,
             _P],
            ctypes.c_int,
        ),
    },
    "tsne_repulsion.cu": {
        # n -> the float64 scratch elements a call takes on the current device
        "hipac_tsne_repulsion_scratch": ([_I64], _I64),
        # y, neg, sum_q, scratch, scratch elements, n, is_double, stream
        "hipac_tsne_repulsion": ([_P, _P, _P, _P, _I64, _I64, _I32, _P],
                                 ctypes.c_int),
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


def set_build_dir(path: str | None) -> Path:
    """Point the library cache at ``path`` (the CLI's
    ``--compile_cache_dir``) and return it: None keeps the cache where it
    is (``ops/_build/`` by default); ``"off"`` builds into a temporary
    directory of this process, removed when the process exits. Call it
    before the first library loads: a library already loaded stays
    loaded from where it was built."""
    global BUILD_DIR
    if path is None:
        return BUILD_DIR
    if path == "off":
        tmp = tempfile.mkdtemp(prefix="hipac_build_")
        atexit.register(shutil.rmtree, tmp, ignore_errors=True)
        BUILD_DIR = Path(tmp)
    else:
        BUILD_DIR = Path(path).expanduser().resolve()
    return BUILD_DIR


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
    if jobs:
        log.info("nvcc: building %d kernel libraries into %s", len(jobs),
                 BUILD_DIR)
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


NATIVE_DIR = Path(__file__).resolve().parent.parent / "io" / "native"
HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-fopenmp",
              "-shared")
#: host library → its sources under ``io/native/``
HOST_SOURCES = {"chunk": ("chunkproc.cpp",), "tiff": ("tile_decoder.cpp",)}


_OPENMP_PROBE = ("#include <omp.h>\n"
                 "int main() { return omp_get_max_threads() > 0 ? 0 : 1; }\n")


@functools.cache
def find_cxx() -> str:
    """The first of ``$CXX``, ``c++`` and ``g++`` on PATH that compiles and
    links OpenMP code (a compiler may lack OpenMP's support files)."""
    candidates = dict.fromkeys(filter(None, (
        os.environ.get("CXX"), shutil.which("c++"), shutil.which("g++"))))
    refused = []
    for cxx in candidates:
        try:
            proc = subprocess.run([cxx, "-fopenmp", "-x", "c++", "-o",
                                   os.devnull, "-"], input=_OPENMP_PROBE,
                                  capture_output=True, text=True, timeout=60)
        except OSError as e:
            refused.append(f"{cxx}: {e}")
            continue
        if proc.returncode == 0:
            return cxx
        refused.append(f"{cxx}: {proc.stderr.strip()}")
    raise RuntimeError(
        "no C++ compiler with OpenMP ($CXX, c++ or g++ on PATH); the host "
        "libraries of io/native cannot be built: "
        + ("; ".join(refused) or "none found"))


def _has_tiff_headers(cxx: str) -> bool:
    proc = subprocess.run([cxx, "-x", "c++", "-E", "-o", os.devnull, "-"],
                          input="#include <tiffio.h>\n", capture_output=True,
                          text=True, timeout=60)
    return proc.returncode == 0


def _pillow_libtiff() -> Path | None:
    """The libtiff that Pillow's wheel carries (``pillow.libs/``), found
    without importing Pillow."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or spec.origin is None:
        return None
    found = sorted((Path(spec.origin).parent.parent / "pillow.libs").glob(
        "libtiff-*.so*"))
    return found[0] if found else None


@functools.cache
def libtiff_route() -> tuple[str, tuple[str, ...]]:
    """How the TIFF library compiles and links: ``("headers", (-ltiff))``
    where ``<tiffio.h>`` is found, else ``("abi", flags)`` against
    ``tiff_abi.h`` and the libtiff the loader knows, else Pillow's copy
    (its directory put in the library's search path, as ``DT_RPATH`` so
    that the libjpeg beside it is found too). Raises where there is none."""
    cxx = find_cxx()
    if _has_tiff_headers(cxx):
        return "headers", ("-ltiff",)
    abi = ("-DHIPAC_TIFF_ABI", f"-I{NATIVE_DIR}")
    name = ctypes.util.find_library("tiff")
    if name:
        return "abi", (*abi, f"-l:{name}")
    bundled = _pillow_libtiff()
    if bundled is not None:
        return "abi", (*abi, str(bundled), "-Wl,--disable-new-dtags",
                       f"-Wl,-rpath,{bundled.parent}")
    raise RuntimeError(
        "libtiff not found: no <tiffio.h> for the compiler, no libtiff.so.N "
        "known to the loader and no Pillow wheel carrying one; tiled TIFF "
        "slides cannot be read here (convert them to .wsi.npz)")


def _host_command(name: str) -> list[str]:
    cxx = find_cxx()
    link = libtiff_route()[1] if name == "tiff" else ()
    sources = [str(NATIVE_DIR / s) for s in HOST_SOURCES[name]]
    compile_flags = [f for f in link if f.startswith(("-D", "-I"))]
    link_flags = [f for f in link if f not in compile_flags]
    return [cxx, *HOST_FLAGS, *compile_flags, *sources, *link_flags]


@functools.cache
def _native_target() -> bytes:
    """What ``-march=native`` means to the compiler on this machine (the
    target options it resolves to), so that a library built on one CPU is
    never loaded on another."""
    proc = subprocess.run([find_cxx(), "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True, timeout=60)
    return proc.stdout.encode()


def host_library_path(name: str) -> Path:
    """Where host library ``name`` (``"chunk"`` or ``"tiff"``) lives, keyed
    by its sources, the headers beside them, the command that builds it and
    the CPU it builds for."""
    h = hashlib.sha256(" ".join(_host_command(name)).encode())
    h.update(_native_target())
    for path in sorted(NATIVE_DIR.glob("*.h")) + [
            NATIVE_DIR / s for s in HOST_SOURCES[name]]:
        h.update(path.read_bytes())
    return BUILD_DIR / f"libhipac_{name}_{h.hexdigest()[:16]}.so"


def host_library(name: str) -> Path:
    """Host library ``name``, compiled first if it is not there yet: one
    process at a time, under an ``fcntl`` lock on the build directory, into
    a private file that is renamed into place. Raises with the compiler's
    output if the build fails."""
    so = host_library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():  # another process built it while this one waited
            return so
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = _host_command(name)
        log.info("%s: building host library %s into %s", cmd[0], name,
                 BUILD_DIR)
        proc = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"host build of {name} failed "
                               f"({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, so)
    return so


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
