"""Build a CUDA source of this package with ``nvcc`` and bind it with ``ctypes``.

Each kernel lives in ``csrc/<name>.cu`` and exports an ``extern "C"``
launcher that takes raw device pointers, sizes and a ``cudaStream_t`` and
returns a ``cudaError_t``. The source is compiled at first use into a shared
library under ``ops/_build/``, named by a hash of the source, the flags and
the compiler, so an edit or a new toolkit rebuilds it and nothing else does.
No ``ninja`` and no PyTorch headers are needed: the build takes seconds.

Nothing here runs at import time; a compile error raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: sm_90a keeps wgmma and setmaxnreg available to the kernels
NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-Xcompiler", "-fPIC",
    "-shared",
    "-lineinfo",
    "-Xptxas", "-v",
)


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A launcher returned a CUDA error."""


def find_nvcc() -> str:
    """The ``nvcc`` of the CUDA toolkit PyTorch was pointed at, else on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        if candidate.is_file():
            return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found: set CUDA_HOME or put the CUDA toolkit on PATH"
        )
    return found


def build_library(source: Path) -> tuple:
    """Compile ``source`` into ``_build/`` unless an up-to-date library is
    there. Returns ``(path, log)``: ``log`` is nvcc's output (register and
    spill counts from ``-Xptxas -v``), empty when the library was cached."""
    nvcc = find_nvcc()
    digest = hashlib.sha256()
    digest.update(source.read_bytes())
    digest.update("\0".join((nvcc, *NVCC_FLAGS)).encode())
    out = BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"
    if out.is_file():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True,
        text=True,
    )
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on {source.name}:\n{log}")
    os.replace(tmp, out)
    return out, log


_LIBRARIES: Dict[Path, ctypes.CDLL] = {}


def load_library(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built once per process however
    many launchers it exports."""
    if source not in _LIBRARIES:
        path, _ = build_library(source)
        _LIBRARIES[source] = ctypes.CDLL(str(path))
    return _LIBRARIES[source]


class CudaKernel:
    """One ``extern "C"`` launcher of one source, built at first call.

    ``launches`` counts the launches that returned without a CUDA error;
    the wrapper that owns the kernel advances it nowhere else.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._error_string = None

    def build(self) -> None:
        if self._fn is not None:
            return
        lib = load_library(self.source)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{self.symbol}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._error_string = err
        self._fn = fn

    def __call__(self, *args) -> None:
        self.build()
        rc = self._fn(*args)
        if rc != 0:
            raise KernelLaunchError(
                f"{self.symbol}: CUDA error {rc}: "
                f"{self._error_string(rc).decode(errors='replace')}"
            )
        self.launches += 1
