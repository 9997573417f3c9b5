"""Build a CUDA source of this package with ``nvcc`` and bind it with ``ctypes``.

Each kernel lives in ``csrc/<name>.cu`` and exports an ``extern "C"``
launcher that takes raw device pointers, sizes and a ``cudaStream_t`` and
returns a ``cudaError_t``. The source is compiled at first use into a shared
library under ``ops/_build/``, named by a hash of the source, the headers it
includes from ``csrc/``, the flags and the compiler, so an edit (of a shared
header too) or a new toolkit rebuilds it and nothing else does.
No ``ninja`` and no PyTorch headers are needed: the build takes seconds.

Nothing here runs at import time; a compile error raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from collections import Counter
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


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_headers(source: Path) -> list:
    """The headers that ``source`` includes with ``#include "..."`` beside
    it, and those they include, each once, in the order first met."""
    found: list = []
    pending = [source]
    while pending:
        current = pending.pop(0)
        for name in _INCLUDE.findall(current.read_text()):
            header = current.parent / name
            if header.is_file() and header not in found:
                found.append(header)
                pending.append(header)
    return found


def build_key(source: Path, flags: Sequence[str], nvcc: str) -> str:
    """The hex digest that names ``source``'s library: its bytes, the bytes
    of every header in :func:`local_headers`, the compiler and the flags."""
    digest = hashlib.sha256()
    for path in (source, *local_headers(source)):
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    digest.update("\0".join((nvcc, *flags)).encode())
    return digest.hexdigest()


def build_library(source: Path, defines: Sequence[str] = ()) -> tuple:
    """Compile ``source`` into ``_build/`` unless an up-to-date library is
    there. ``defines`` are extra ``-D`` flags (``NAME=VALUE``), for a tile
    sweep's variants. Returns ``(path, log)``: ``log`` is nvcc's output
    (register and spill counts from ``-Xptxas -v``), empty when the library
    was cached."""
    nvcc = find_nvcc()
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    out = BUILD_DIR / f"{source.stem}-{build_key(source, flags, nvcc)[:16]}.so"
    if out.is_file():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *flags, "-o", str(tmp), str(source)],
        capture_output=True,
        text=True,
    )
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on {source.name}:\n{log}")
    os.replace(tmp, out)
    return out, log


# a kernel template of this package in a mangled name: name, element type, head_dim
_KERNEL_NAME = re.compile(r"\d([a-z_]+_kernel)I(f|13__nv_bfloat16)Li(\d+)E")


def kernel_name(mangled: str) -> str:
    """``flash_bwd_dq_kernel<f32,64>`` for the mangled name of an
    instantiation of this package's kernels; other names as they are."""
    m = _KERNEL_NAME.search(mangled)
    if m is None:
        return mangled
    return f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'},{m.group(3)}>"


def ptxas_usage(log: str) -> Dict[str, dict]:
    """Registers and spilled bytes of each kernel in a ``-Xptxas -v`` log,
    keyed by :func:`kernel_name`."""
    usage: Dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
            usage[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                usage[name]["spill_stores"] = int(m.group(1))
                usage[name]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                usage[name]["registers"] = int(m.group(1))
    return usage


def sass_opcodes(library: Path, prefixes: Sequence[str]) -> Dict[str, Counter]:
    """How many SASS instructions of each kernel in ``library`` start with
    each of ``prefixes`` (``HMMA``: tensor-core products, ``LDGSTS``:
    ``cp.async`` copies, ``""``: all), from ``cuobjdump -sass``; keyed by
    :func:`kernel_name`."""
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    out = subprocess.run(
        [str(cuobjdump), "-sass", str(library)],
        capture_output=True, text=True, check=True, timeout=300,
    ).stdout
    counts: Dict[str, Counter] = {}
    name = None
    for line in out.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = kernel_name(m.group(1))
            counts[name] = Counter({prefix: 0 for prefix in prefixes})
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name is not None:
            for prefix in prefixes:
                if m.group(1).startswith(prefix):
                    counts[name][prefix] += 1
    return counts


_LIBRARIES: Dict[tuple, ctypes.CDLL] = {}


def load_library(source: Path, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of ``source`` (with ``defines``), built once per
    process however many launchers it exports."""
    key = (source, tuple(defines))
    if key not in _LIBRARIES:
        path, _ = build_library(source, defines)
        _LIBRARIES[key] = ctypes.CDLL(str(path))
    return _LIBRARIES[key]


class CudaKernel:
    """One ``extern "C"`` launcher of one source, built at first call.

    ``launches`` counts the launches that returned without a CUDA error;
    the wrapper that owns the kernel advances it nowhere else.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence,
                 defines: Sequence[str] = ()):
        self.source = CSRC / source
        self.defines = tuple(defines)
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._error_string = None

    def build(self) -> None:
        if self._fn is not None:
            return
        lib = load_library(self.source, self.defines)
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
