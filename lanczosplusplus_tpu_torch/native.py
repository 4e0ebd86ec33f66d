"""ctypes binding for the native host runtime (native/lanczos_native.cpp).

Counterpart of ``lanczosplusplus_tpu/native.py``: ``load``, ``available``,
``enumerate_combinations``, ``rank_combinations``, ``scatter_plan_tables``
and ``one_spin_hop_ell``, with the same C signatures.  The native library
accelerates the host-side data preparation (basis enumeration, ranking,
ELL assembly) for large sectors; ``core/combinatorics`` and
``core/sparse`` route to it above their size thresholds and keep their
vectorized numpy paths for a host without a C++ compiler.

The source is the repository's ``native/lanczos_native.cpp``, read only.
It compiles with ``g++`` and the flags of ``native/Makefile`` into the
package's ``_build/`` directory at first use, under a name derived from
the source, the flags and what ``-march=native`` means on this host, so a
changed source, flag or CPU builds anew and an unchanged one loads the
existing file.  Nothing builds at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCE = PACKAGE_DIR.parent / "native" / "lanczos_native.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
# native/Makefile's CXXFLAGS and link flag
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")


def compiler() -> str | None:
    """The C++ compiler, or None on a host without one."""
    return shutil.which("g++")


def library_path(cxx: str) -> Path:
    """Where the library for this source, these flags and this host's
    ``-march=native`` lives."""
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True,
                            check=True).stdout
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(target.encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"liblanczos_native_{digest.hexdigest()[:16]}.so"


def build() -> Path | None:
    """Compile the library if it is not built yet; returns its path, or
    None where there is no compiler or no source.  A compiler that fails
    raises with its output."""
    cxx = compiler()
    if cxx is None or not SOURCE.exists():
        return None
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        made = os.path.join(tmp, out.name)
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", made, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               + proc.stdout + proc.stderr)
        os.replace(made, out)
    return out


@functools.cache
def load():
    """The loaded library with its C signatures declared, or None where
    it cannot be built (the numpy paths then run)."""
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

    lib.lpp_enumerate_combinations.restype = ctypes.c_long
    lib.lpp_enumerate_combinations.argtypes = [ctypes.c_int, ctypes.c_int,
                                               u64p]
    lib.lpp_rank_combinations.restype = None
    lib.lpp_rank_combinations.argtypes = [u64p, ctypes.c_long, i64p,
                                          ctypes.c_int, i64p]
    lib.lpp_one_spin_hop_ell.restype = None
    lib.lpp_one_spin_hop_ell.argtypes = [u64p, ctypes.c_long, i32p, i32p,
                                         f64p, ctypes.c_int, i64p,
                                         ctypes.c_int, i32p, f64p]
    lib.lpp_scatter_plan_count.restype = None
    lib.lpp_scatter_plan_count.argtypes = [i64p, ctypes.c_long,
                                           ctypes.c_long, ctypes.c_long,
                                           ctypes.c_int, i64p]
    lib.lpp_scatter_plan_fill.restype = None
    lib.lpp_scatter_plan_fill.argtypes = [i64p, ctypes.c_long,
                                          ctypes.c_long, ctypes.c_long,
                                          ctypes.c_int, ctypes.c_long,
                                          ctypes.c_char_p, ctypes.c_long,
                                          i32p, ctypes.c_char_p, i32p,
                                          i64p]
    return lib


def available() -> bool:
    return load() is not None


def enumerate_combinations(nsite: int, npart: int):
    """All C(nsite, npart) words in colex order, or None without the
    library."""
    lib = load()
    if lib is None:
        return None
    dim = math.comb(nsite, npart) if npart else 1
    out = np.zeros(max(dim, 1), dtype=np.uint64)
    n = lib.lpp_enumerate_combinations(nsite, npart, out)
    return out[:n]


def rank_combinations(words: np.ndarray, table: np.ndarray):
    """Colex rank of each combination word (`table`: a binomial table of
    at least 65 rows), or None without the library."""
    lib = load()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint64)
    table = np.ascontiguousarray(table, dtype=np.int64)
    out = np.zeros(words.shape[0], dtype=np.int64)
    lib.lpp_rank_combinations(words, words.shape[0], table,
                              table.shape[1], out)
    return out


def scatter_plan_tables(tgt: np.ndarray, amp: np.ndarray, s_src: int,
                        s_dst: int, ndev: int):
    """(send_src, send_amp, dst_idx, maxcount) bucket tables for
    SectorScatterPlan, built in one native pass each for count/fill.
    Returns None when the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    tgt = np.ascontiguousarray(tgt, dtype=np.int64)
    amp = np.ascontiguousarray(amp)
    n = tgt.shape[0]
    counts = np.zeros(ndev * ndev, dtype=np.int64)
    lib.lpp_scatter_plan_count(tgt, n, s_src, s_dst, ndev, counts)
    maxcount = max(int(counts.max(initial=0)), 1)
    send_src = np.zeros((ndev, ndev, maxcount), np.int32)
    send_amp = np.zeros((ndev, ndev, maxcount), amp.dtype)
    dst_idx = np.zeros((ndev, ndev, maxcount), np.int32)
    counts[:] = 0
    lib.lpp_scatter_plan_fill(
        tgt, n, s_src, s_dst, ndev, maxcount,
        amp.ctypes.data_as(ctypes.c_char_p), amp.dtype.itemsize,
        send_src, send_amp.ctypes.data_as(ctypes.c_char_p), dst_idx,
        counts)
    return send_src, send_amp, dst_idx, maxcount


def one_spin_hop_ell(words: np.ndarray, bonds, table: np.ndarray):
    """The one-spin hop ELL map (cols int32, vals float64), each (n, K),
    of real directed bonds (i, j, t) over combination words, or None
    without the library or without bonds."""
    lib = load()
    if lib is None or not bonds:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint64)
    table = np.ascontiguousarray(table, dtype=np.int64)
    bi = np.ascontiguousarray([b[0] for b in bonds], dtype=np.int32)
    bj = np.ascontiguousarray([b[1] for b in bonds], dtype=np.int32)
    t = np.ascontiguousarray([b[2] for b in bonds], dtype=np.float64)
    n = words.shape[0]
    k = len(bonds)
    cols = np.zeros((n, k), dtype=np.int32)
    vals = np.zeros((n, k), dtype=np.float64)
    lib.lpp_one_spin_hop_ell(words, n, bi, bj, t, k, table,
                             table.shape[1], cols, vals)
    return cols, vals
