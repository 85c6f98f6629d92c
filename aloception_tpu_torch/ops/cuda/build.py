"""Build a CUDA source of ``aloception_tpu_torch/csrc`` into a shared library
and load it with ctypes.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) at its first use
in a process, into ``aloception_tpu_torch/_build/lib<name>_<hash>.so``, where
``<hash>`` is taken from the source text, so an edited source is rebuilt and an
unchanged one is loaded as it is. ``ptxas -v`` reports each kernel's
registers and spills; the report is kept beside the library
(``build_log``). A missing ``nvcc`` or a failed build raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    """``nvcc`` on PATH, else under the CUDA toolkit that torch found."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of aloception_tpu_torch "
                       "are built from source and need the CUDA toolkit")


def _library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_log(name: str) -> str:
    """What nvcc and ptxas reported when ``csrc/<name>.cu`` was built ("" if
    the library was built before reports were kept)."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it."""
    src = CSRC_DIR / f"{name}.cu"
    out = _library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {name}.cu "
                               f"(exit {res.returncode}):\n{res.stderr}")
        out.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    return ctypes.CDLL(str(out))
