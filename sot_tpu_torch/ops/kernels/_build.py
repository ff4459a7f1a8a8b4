"""Build the CUDA sources under ``sot_tpu_torch/csrc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use by ``nvcc`` for ``sm_90a`` into ``sot_tpu_torch/_build`` (listed in
``.gitignore``). The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused. A build
or load failure raises; nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMMON_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(ARCH_FLAGS + COMMON_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile the named sources, all nvcc processes started together.

    Returns the wall seconds of the whole build for each name (0.0 when the
    library was already built). Raises with the compiler's output on failure.
    """
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: Dict[str, Tuple[subprocess.Popen, Path, Path]] = {}
    t0 = time.perf_counter()
    try:
        for name in names:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *ARCH_FLAGS, *COMMON_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, out)
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOGS[name] = log
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    return {name: (seconds if name in procs else 0.0) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
