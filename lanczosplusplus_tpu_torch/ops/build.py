"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded with ``ctypes``.  No PyTorch
header is involved, so a build takes seconds.  The library lands in the
package's ``_build/`` directory under a name derived from the sources'
and flags' digest: a changed source builds anew, an unchanged one loads
the existing file.  Nothing here runs at import; the first kernel launch
builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the exported launchers; each returns cudaGetLastError()
SIGNATURES = {
    # x, xs0, xs1, a, as0, as1, y, ys0, ys1, m, n, k, accumulate, stream
    "lpp_factor_matmul_f64": (_P, _I, _I, _P, _I, _I, _P, _I, _I,
                              _I, _I, _I, _I, _P),
    "lpp_factor_matmul_f32": (_P, _I, _I, _P, _I, _I, _P, _I, _I,
                              _I, _I, _I, _I, _P),
    # diag, cols, vals, x, y, dim, K, stream
    "lpp_ell_spmv_f64": (_P, _P, _P, _P, _P, _I, _I, _P),
    "lpp_ell_spmv_f32": (_P, _P, _P, _P, _P, _I, _I, _P),
}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"liblpp_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path.
    The compiler's output (register and shared-memory use per kernel)
    is kept beside it as ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    Path(f"{out}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_log() -> str:
    """What nvcc printed for the current library ('' if not built)."""
    log = Path(f"{library_path()}.log")
    return log.read_text() if log.exists() else ""


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every launcher's signature."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
