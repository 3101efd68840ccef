"""Build the CUDA sources under ``repro_torch/csrc`` and load them.

Each ``.cu`` file is compiled by ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes``.  Libraries go to
``build/repro_torch_kernels/`` at the repository root, named by a hash of
the source and the flags, so a stale library is never loaded.  Nothing is
built at import time: the first launch builds what it needs, and
:func:`build_all` starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu", "ssd_intra.cu",
           "rmsnorm.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from PyTorch's CUDA_HOME, else from PATH; raises if absent."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (neither under CUDA_HOME nor on PATH): the port's "
            "CUDA kernels cannot be built")
    return found


def library_path(source: str) -> Path:
    text = (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def _start(source: str, nvcc: str) -> Tuple[subprocess.Popen, Path, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = library_path(source)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), out


def build_all(sources=SOURCES) -> Dict[str, str]:
    """Compile every source whose library is missing, in parallel.

    Returns ``{source: compiler output}`` for what was built (``-Xptxas -v``
    reports registers, shared memory and spills).  Raises on any failure."""
    todo: List[str] = [s for s in sources if not library_path(s).is_file()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    jobs = [(s, *_start(s, nvcc)) for s in todo]
    logs: Dict[str, str] = {}
    failed: List[str] = []
    for source, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        logs[source] = log
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{source} (exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if it is missing."""
    lib = _LOADED.get(source)
    if lib is None:
        build_all((source,))
        lib = ctypes.CDLL(str(library_path(source)))
        _LOADED[source] = lib
    return lib


def check(err: int, lib: ctypes.CDLL, name: str) -> None:
    """Raise if the C entry point ``name`` returned a CUDA error code; each
    library exports ``<name>_error_string`` to name it."""
    if err:
        fn = getattr(lib, f"{name}_error_string")
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{name} failed: CUDA error {err} "
                           f"({fn(err).decode()})")
