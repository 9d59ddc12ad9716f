"""Load the JAX package's native library once per test process, safely
across pytest-xdist workers.

The JAX package builds ``io/native/libhipac_native.so`` at first use with an
unlocked ``make`` (``io/native_lib.py::get_lib``). Under ``-n 6`` a worker
can find the file while another worker's linker is still writing it: its
``ctypes.CDLL`` fails ("file too short") and the module marks the build
failed for the rest of the process, so every JAX TIFF read or write in that
worker raises "native TIFF decoder unavailable". The port's tests that reach
the JAX TIFF code call :func:`load_jax_native_lib` first: the build or load
runs under an exclusive ``fcntl`` lock that the workers share, and a load
that met a half-written file (from a JAX test building without the lock) is
tried again once the file is whole.
"""

import fcntl
import hashlib
import os
import tempfile
import time

#: tries, a second apart, while a half-written library stays unloadable
LOAD_TRIES = 60


def load_jax_native_lib():
    """The JAX package's loaded native library, or None where it cannot be
    built here (the tests then fail as they would have)."""
    from ss25_hierarchical_multiscale_image_classification_tpu.io import (
        native_lib,
    )

    key = hashlib.sha1(os.path.abspath(native_lib._LIB_PATH).encode())
    lock_path = os.path.join(tempfile.gettempdir(),
                             f"hipac_native_{key.hexdigest()[:16]}.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            for _ in range(LOAD_TRIES):
                lib = native_lib.get_lib()
                if lib is not None or not os.path.exists(native_lib._LIB_PATH):
                    return lib
                # the file exists but did not load: another process's
                # linker is still writing it
                time.sleep(1.0)
                with native_lib._lock:
                    native_lib._build_failed = False
            return None
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
