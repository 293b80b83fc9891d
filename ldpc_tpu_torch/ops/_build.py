"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<stem>.cu`` exposes a plain C interface and compiles into
``build/lib<stem>_<hash>.so`` next to this file (a directory git ignores);
the hash covers the source, the shared headers ``csrc/*.cuh`` and the
flags, so an edited source or header rebuilds and an unchanged one is built
once per checkout.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Flags of single sources: no contraction of a * b + c into an FMA, so the
# elementwise steps round like the plain versions (the trained min-sum
# sources: fused_neural.cu and neural_group.cuh's two other words).  The
# tensor-core sources fused_gnn_tc.cu and fused_msg_gnn_tc.cu need no flag:
# their products are mma and their elementwise multiplies are __fmul_rn,
# which is never contracted (see their headers).
EXTRA_FLAGS: dict[str, tuple[str, ...]] = {
    stem: ("-fmad=false",) for stem in ("fused_neural", "fused_neural_wide", "fused_neural_w128")}

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    found = str(candidate) if candidate.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def library_path(stem: str) -> Path:
    src = _CSRC / f"{stem}.cu"
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(stem, ())
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    key = src.read_bytes() + headers + " ".join(flags).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return BUILD_DIR / f"lib{stem}_{digest}.so"


def build(stem: str) -> Path:
    """Compile ``csrc/<stem>.cu`` unless its library exists; return the path.

    The compiler's ``-Xptxas -v`` report (registers, shared memory, spills
    per kernel) is kept beside the library as ``<lib>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = library_path(stem)
    if lib.exists():
        return lib
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, *EXTRA_FLAGS.get(stem, ()), "-o", str(tmp),
           str(_CSRC / f"{stem}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lib.with_name(lib.name + ".log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {stem}.cu (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
    return lib


def build_log(stem: str) -> str:
    """The compiler's report for the current build of ``stem``."""
    log = library_path(stem).with_name(library_path(stem).name + ".log")
    return log.read_text() if log.exists() else ""


def load(stem: str, signatures: dict[str, tuple[list, object]]) -> ctypes.CDLL:
    """Build if needed, load once per process, and declare ``signatures``
    (function name -> (argtypes, restype))."""
    lib = _LOADED.get(stem)
    if lib is None:
        path = build(stem)
        lib = ctypes.CDLL(str(path))
        for name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LOADED[stem] = lib
    return lib
