"""ctypes loader of the port's native batch packer (``batchpack.cpp``).

A C++ library that packs image-struct rows into one contiguous NHWC batch:
decode, channel normalisation, the BGR flip and, where asked, the
``jax.image.resize``-compatible bilinear, threaded across rows. It replaces
the per-row numpy loop of :func:`~sparkdl_tpu_torch.transformers.utils.decode_image_batch`.

The library is host C++ with a plain C ABI (no pybind11, no CUDA), built
at first use with ``$CXX`` (default ``g++``), ``-O3 -std=c++17 -fPIC
-shared -pthread``, into ``native/_build/`` under a name that hashes the
source, the compiler and the flags, so an edit of either builds afresh. The
build writes a process-unique temporary file and renames it into place, so
concurrent processes never ``dlopen`` a half-written library. Within a
process one thread builds while the others wait on an event, with no lock
held across the compiler or the ``dlopen`` (:class:`Once`). The AOTInductor
runner and ``aoti_tool`` (:mod:`~sparkdl_tpu_torch.native.aoti`) build
through the same helpers (:func:`build_path`, :func:`build`, :class:`Once`).

Everything degrades: without a compiler, or if the build fails,
:func:`is_available` is false and callers take the numpy path. The
verdict is kept for the process. ``SPARKDL_NO_NATIVE=1`` turns the packer
off; it is read at every call, so it takes effect at once.

A call starts its threads afresh. By default a pack at source size runs
on the calling thread alone: it is a copy or a cast, bound by memory and by
the page faults of its fresh output, which more threads do not speed up. A
resize starts one thread for each ``BYTES_PER_THREAD`` of output, up to the
rows and the CPUs this process may run on (:func:`threads_for`).
``n_threads=0`` takes the library's own rule instead, one thread a row up
to ``std::thread::hardware_concurrency`` (the JAX package's).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_PATH = os.path.join(_HERE, "batchpack.cpp")
_BUILD_DIR = os.path.join(_HERE, "_build")
_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
_ABI_VERSION = 1

#: output bytes of a resize that pay for starting one more thread
BYTES_PER_THREAD = 2 << 20

#: image-struct modes (OpenCV type ordinals) the library decodes
_KNOWN_MODES = frozenset({0, 16, 24, 5, 21, 29})
_F32_MODES = frozenset({5, 21, 29})
_U8_MODES = frozenset({0, 16, 24})

def compiler() -> str:
    """The C++ compiler of every native build: ``$CXX``, default ``g++``."""
    return os.environ.get("CXX") or "g++"


def build_path(stem: str, sources: Sequence[str], flags: Sequence[str],
               suffix: str = ".so", extra: Sequence[str] = ()) -> str:
    """Where the build of ``sources`` lies: ``_build/`` and a hash of the
    sources' bytes, the compiler, the flags and ``extra``. Raises
    ``OSError`` where a source cannot be read."""
    digest = hashlib.sha256()
    for path in sources:
        with open(path, "rb") as fh:
            digest.update(fh.read())
    digest.update("\0".join((compiler(), *flags, *extra)).encode())
    return os.path.join(_BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}{suffix}")


def build(sources: Sequence[str], flags: Sequence[str], out: str,
          timeout: float = 900.0) -> str:
    """Compile ``sources`` with ``flags`` to ``out`` unless it is there: into
    a process- and thread-unique temporary file, renamed into place once
    whole (atomic on POSIX), so no process ever loads a half-written file.
    Returns ``out``; raises ``RuntimeError`` with the compiler's message."""
    if os.path.exists(out):
        return out
    name = os.path.basename(out)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        proc = subprocess.run([compiler(), *sources, "-o", tmp, *flags],
                              capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"building {name} failed:\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    except (OSError, subprocess.TimeoutExpired) as e:  # no toolchain, no room
        raise RuntimeError(f"cannot build {name}: {e}") from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


class Once:
    """A value made at most once a process, by its first caller (single
    flight). The maker runs with no lock held, so a caller that only asks
    whether the value is there never waits seconds behind a compiler; the
    callers that come meanwhile wait on an event. The verdict is kept: every
    later call returns the value, or raises the maker's exception again."""

    def __init__(self):
        self._lock = threading.Lock()
        self._done = False
        self._value = None
        self._error: Optional[BaseException] = None
        #: set while the first caller runs the maker; later callers wait on it
        self._inflight: Optional[threading.Event] = None

    def get(self, make):
        while True:
            with self._lock:
                if self._done:
                    if self._error is not None:
                        raise self._error
                    return self._value
                if self._inflight is None:
                    self._inflight = claim = threading.Event()
                    break
                waiter = self._inflight
            waiter.wait()
        value, error = None, None
        try:
            value = make()
        except Exception as e:  # kept for every later caller
            error = e
        except BaseException:  # an interrupt is no verdict: the next caller tries again
            with self._lock:
                self._inflight = None
            claim.set()
            raise
        with self._lock:
            self._value, self._error, self._done, self._inflight = value, error, True, None
        claim.set()
        if error is not None:
            raise error
        return value


_packer = Once()


def _library_path() -> Optional[str]:
    """Where the build of the current source lies: ``_build/`` and a hash of
    the source, the compiler and the flags. None without the source."""
    try:
        return build_path("batchpack", [_SRC_PATH], _FLAGS)
    except OSError:
        return None


def _build(path: str) -> bool:
    """Compile the library to ``path``; False, with the reason logged,
    where it does not build."""
    try:
        build([_SRC_PATH], _FLAGS, path, timeout=300)
    except RuntimeError as e:
        logger.warning("native batch packer unavailable (the numpy path stands in): %s", e)
        return False
    return True


def _load() -> Optional[ctypes.CDLL]:
    """The library's handle, built and loaded at most once per process
    (:class:`Once`); None where the packer is off or did not build."""
    if os.environ.get("SPARKDL_NO_NATIVE") == "1":
        return None
    return _packer.get(_resolve)


def _resolve() -> Optional[ctypes.CDLL]:
    """Build where needed, ``dlopen`` and bind the signatures. Runs with no
    lock held, in one thread per process (see :func:`_load`)."""
    path = _library_path()
    if path is None:
        return None
    if not os.path.exists(path) and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        logger.warning("native batch packer load failed: %s", e)
        return None
    if lib.sdl_abi_version() != _ABI_VERSION:
        logger.warning("native batch packer ABI mismatch; ignoring it")
        return None
    rows_args = [
        ctypes.POINTER(ctypes.c_char_p),  # datas
        ctypes.POINTER(ctypes.c_int32),   # heights
        ctypes.POINTER(ctypes.c_int32),   # widths
        ctypes.POINTER(ctypes.c_int32),   # channels
        ctypes.POINTER(ctypes.c_int32),   # modes
        ctypes.c_int64,                   # n
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # out h, w, c
        ctypes.c_int32,                   # bgr_to_rgb
    ]
    lib.sdl_pack_resize_batch.restype = ctypes.c_int64
    lib.sdl_pack_resize_batch.argtypes = rows_args + [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32]  # out, n_threads
    lib.sdl_pack_batch_u8.restype = ctypes.c_int64
    lib.sdl_pack_batch_u8.argtypes = rows_args + [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32]
    lib.sdl_resize_batch_f32.restype = ctypes.c_int64
    lib.sdl_resize_batch_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # h, w, c
        ctypes.c_int32, ctypes.c_int32,                   # out h, w
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32,
    ]
    logger.info("native batch packer loaded (%s)", path)
    return lib


def is_available() -> bool:
    """Whether the packer is built and loaded (building it at first call);
    false under ``SPARKDL_NO_NATIVE=1``."""
    return _load() is not None


def threads_for(n_rows: int, out_bytes: int) -> int:
    """The threads of a resizing call: one for each :data:`BYTES_PER_THREAD`
    of output, at least one, at most one a row and one a CPU this process
    may run on."""
    try:
        cpus = len(os.sched_getaffinity(0))
    except AttributeError:  # not Linux
        cpus = os.cpu_count() or 1
    return max(1, min(int(n_rows), cpus, int(out_bytes) // BYTES_PER_THREAD))


def _row_meta(rows: Sequence) -> list:
    """The rows' ``(height, width, nChannels, mode)``, one tuple each."""
    return [(int(r["height"]), int(r["width"]), int(r["nChannels"]), int(r["mode"]))
            for r in rows]


def _row_args(rows: Sequence, meta: list, itemsize: Sequence[int]) -> Optional[tuple]:
    """The call's row arguments: the rows' data pointers (a ``char*`` array
    that holds the bytes for the call; the C side reads them in place) and
    their heights, widths, channels and modes as int32 arrays; None where a
    row's buffer is short (the numpy path raises its error)."""
    raws = []
    for r, (h, w, c, _), size in zip(rows, meta, itemsize):
        raw = r["data"]
        if not isinstance(raw, bytes):
            raw = bytes(raw)  # c_char_p takes bytes
        if len(raw) < h * w * c * size:
            return None
        raws.append(raw)
    n = len(raws)
    int32s = ctypes.c_int32 * n
    return ((ctypes.c_char_p * n)(*raws), *(int32s(*col) for col in zip(*meta)))


def _threads(n_threads: Optional[int], n_rows: int, out_bytes: int, resizes: bool) -> int:
    if n_threads is not None:
        return int(n_threads)
    return threads_for(n_rows, out_bytes) if resizes else 1


def pack_image_rows(
    rows: Sequence,
    out_hw: Tuple[int, int],
    out_c: int,
    bgr_to_rgb: bool = False,
    n_threads: Optional[int] = None,
) -> Optional[np.ndarray]:
    """Decode, normalise to ``out_c`` channels, resize where a row is not at
    ``out_hw``, and pack image-struct rows into a float32 NHWC batch in one
    native call. None where the packer is off or a row's mode or buffer is
    not one it reads (the numpy path raises the canonical error); raises
    ``ValueError`` on a channel conversion it does not do. ``n_threads``:
    None runs a pack at source size on the calling thread and sizes a
    resize's threads by its output (:func:`threads_for`); 0 leaves them to
    the library."""
    lib = _load()
    if lib is None:
        return None
    meta = _row_meta(rows)
    if any(m[3] not in _KNOWN_MODES for m in meta):
        return None
    args = _row_args(rows, meta, [4 if m[3] in _F32_MODES else 1 for m in meta])
    if args is None:
        return None
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    out = np.empty((len(rows), out_h, out_w, int(out_c)), dtype=np.float32)
    rc = lib.sdl_pack_resize_batch(
        *args, ctypes.c_int64(len(rows)), out_h, out_w, int(out_c),
        1 if bgr_to_rgb else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        _threads(n_threads, len(rows), out.nbytes,
                 any(m[:2] != (out_h, out_w) for m in meta)),
    )
    if rc != 0:
        raise ValueError(f"native pack failed on row {int(rc) - 1} "
                         f"(unsupported mode/channel combination)")
    return out


def pack_image_rows_u8(
    rows: Sequence,
    out_hw: Tuple[int, int],
    out_c: int,
    bgr_to_rgb: bool = False,
    n_threads: Optional[int] = None,
) -> Optional[np.ndarray]:
    """Pack uint8 rows, all at ``out_hw``, into a uint8 NHWC batch of
    ``out_c`` channels (no resize, no cast: the forward casts on the card,
    a quarter of the bytes over the link). None where the packer is off or
    a row is float, at another size, short, or needs luminance (``out_c``
    1 from colour rows). ``n_threads`` as :func:`pack_image_rows`."""
    lib = _load()
    if lib is None:
        return None
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    meta = _row_meta(rows)
    if any(m[3] not in _U8_MODES or m[:2] != (out_h, out_w) or (int(out_c) == 1 and m[2] != 1)
           for m in meta):
        return None
    args = _row_args(rows, meta, [1] * len(meta))
    if args is None:
        return None
    out = np.empty((len(rows), out_h, out_w, int(out_c)), dtype=np.uint8)
    rc = lib.sdl_pack_batch_u8(
        *args, ctypes.c_int64(len(rows)), out_h, out_w, int(out_c),
        1 if bgr_to_rgb else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _threads(n_threads, len(rows), out.nbytes, False),
    )
    if rc != 0:
        return None  # an unsupported combination: the caller falls back
    return out


def resize_batch(
    batch: np.ndarray, out_hw: Tuple[int, int], n_threads: Optional[int] = None
) -> Optional[np.ndarray]:
    """Bilinear-resize a same-shaped float32 NHWC batch on the host, as
    ``jax.image.resize(..., "bilinear")`` does. None where the packer is
    off. ``n_threads`` as :func:`pack_image_rows`."""
    lib = _load()
    if lib is None:
        return None
    batch = np.ascontiguousarray(batch, dtype=np.float32)
    n, h, w, c = batch.shape
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    out = np.empty((n, out_h, out_w, c), dtype=np.float32)
    rc = lib.sdl_resize_batch_f32(
        batch.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n), h, w, c, out_h, out_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        _threads(n_threads, n, out.nbytes, True),
    )
    if rc != 0:  # pragma: no cover - the resize has no failure mode today
        raise RuntimeError("native resize failed")
    return out
