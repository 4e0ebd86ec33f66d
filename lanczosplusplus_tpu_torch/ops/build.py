"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for Hopper (``sm_90a``), one compiler
process per source and all at once, and link into one shared library with
a plain C interface, loaded with ``ctypes``, linked against libcuda
(``-lcuda``: the bf16 kernel encodes its TMA tensor maps with
``cuTensorMapEncodeTiled``).  No PyTorch header is involved, so a build
takes seconds.  The library lands in the package's
``_build/`` directory under a name derived from the sources' and flags'
digest: a changed source builds anew, an unchanged one loads the existing
file.  Nothing here runs at import; the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas=-v", "-c")
# libcuda for cuTensorMapEncodeTiled, the bf16 kernel's TMA descriptors
LINK_FLAGS = (*ARCH_FLAGS, "-shared", "-lcuda")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of the exported functions; a launcher returns
# cudaGetLastError().
# Strides are in elements and 64 bits wide.
SIGNATURES = {
    # x, xsb, xs0, xs1, a, asb, as0, as1, y, ysb, ys0, ys1, batch, m, n,
    # k, accumulate, plan, stream (xsb, asb, ysb: the batch strides)
    "lpp_factor_matmul_f64": (_P, _L, _L, _L, _P, _L, _L, _L, _P, _L, _L,
                              _L, _I, _I, _I, _I, _I, _I, _P),
    # plan -> bytes of dynamic shared memory (not a launcher)
    "lpp_factor_matmul_f64_smem_bytes": (_I,),
    # as the float64 one; the bf16 forms (bfloat16 X and A, float32 sums)
    # add into a float32 or float64 Y, their plan the bf16 kernel's
    "lpp_factor_matmul_f32": (_P, _L, _L, _L, _P, _L, _L, _L, _P, _L, _L,
                              _L, _I, _I, _I, _I, _I, _I, _P),
    "lpp_factor_matmul_bf16_f32": (_P, _L, _L, _L, _P, _L, _L, _L, _P, _L,
                                   _L, _L, _I, _I, _I, _I, _I, _I, _P),
    "lpp_factor_matmul_bf16_f64": (_P, _L, _L, _L, _P, _L, _L, _L, _P, _L,
                                   _L, _L, _I, _I, _I, _I, _I, _I, _P),
    # diag, perm, offsets, widths, cols, vals (the sliced form), x, src
    # (the gathers' source: x itself, or a longer one), src's batch pitch,
    # y, dim, slices, width (the sliced form's typical width), batch, stream
    **{f"lpp_ell_spmv_{suffix}": (_P, _P, _P, _P, _P, _P, _P, _P, _L, _P,
                                  _I, _I, _I, _I, _P)
       for suffix in ("f64", "f32", "c128", "c64")},
    # x, xsb, xs0, xs1, y, ysb, ys0, ys1, rs, ra, cs, ca, nb, rows, cols,
    # batch, stream (a null table: the identity, amplitude 1); bf16_: a
    # bfloat16 x with amplitudes and y of the suffix's type
    **{f"lpp_perm_gather_{suffix}": (_P, _L, _L, _L, _P, _L, _L, _L, _P, _P,
                                     _P, _P, _I, _I, _I, _I, _P)
       for suffix in ("f64", "f32", "c128", "c64", "bf16_f64", "bf16_f32")},
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
    digest = hashlib.sha256(" ".join((*COMPILE_FLAGS, *LINK_FLAGS)).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"liblpp_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path.
    The compiler's output (registers, shared memory and spills per
    kernel) is kept beside the library as ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [os.path.join(tmp, f"{src.stem}.o") for src in sources()]
        procs = [subprocess.Popen(
            [nvcc, *COMPILE_FLAGS, "-o", obj, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources(), objects)]
        logs = [proc.communicate()[0] for proc in procs]
        linked = os.path.join(tmp, out.name)
        failed = [p.returncode for p in procs if p.returncode != 0]
        if not failed:
            link = subprocess.run([nvcc, *LINK_FLAGS, "-o", linked, *objects],
                                  capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            failed = [link.returncode] if link.returncode != 0 else []
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n"
                               + "".join(logs))
        Path(f"{out}.log").write_text("".join(logs))
        os.replace(linked, out)
    return out


def build_log() -> str:
    """What nvcc printed for the current library ('' if not built)."""
    log = Path(f"{library_path()}.log")
    return log.read_text() if log.exists() else ""


def kernel_resources(log: str) -> list[dict]:
    """Per compiled kernel, from nvcc's ``-Xptxas=-v`` output: mangled
    name, registers per thread, static shared memory, spill stores and
    loads in bytes."""
    out = []
    pattern = re.compile(
        r"Compiling entry function '(\S+)' for 'sm_90a'.*?"
        r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
        r"Used (\d+) registers(?:, used \d+ barriers)?(?:, (\d+) bytes smem)?",
        re.S)
    for name, stores, loads, regs, smem in pattern.findall(log):
        out.append(dict(name=name, registers=int(regs),
                        static_smem_bytes=int(smem or 0),
                        spill_store_bytes=int(stores),
                        spill_load_bytes=int(loads)))
    return out


def sass_opcode_counts(library: Path, prefix: str) -> dict[str, int] | None:
    """How often each machine instruction whose opcode starts with `prefix`
    (``DMMA``, for instance) occurs in the library's code, read with
    ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    counts: dict[str, int] = {}
    for op in re.findall(rf"\b({re.escape(prefix)}[\w.]*)", sass):
        counts[op] = counts.get(op, 0) + 1
    return counts


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every launcher's signature."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
