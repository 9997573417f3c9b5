"""Persistent, content-addressed cache of compiled programs.

Port of ``sparkdl_tpu.engine.cache``. There a program was a serialized XLA
executable; here it is an AOTInductor package (``.pt2``): the function
exported by ``torch.export`` and compiled by
``torch._inductor.aoti_compile_and_package`` into a shared library with its
weights inside, which ``torch._inductor.aoti_load_package`` loads into a
callable. A second process, or a restarted server's ``warmup()``, loads a
package in the time a load takes instead of compiling again.

What :func:`cache_key` hashes:

- the caller's **fingerprint**: only programs whose function and weights
  the caller can name durably (a saved file's path and mtime, a seeded
  model's name) are persisted; a program closing over anonymous weights
  gets no disk entry;
- each argument's **shape, dtype and placement** (device type and index):
  a package compiled for ``cuda:0`` at (32, 224, 224, 3) float32 is that
  program and no other;
- the **placements of what the function closes over**: the device and
  dtype of every parameter and buffer it reaches. The JAX package keys host
  arguments as sharding ``None`` and leaves closed-over weights out
  (``sparkdl_tpu/engine/core.py:126-134``), so two programs that differ
  only there can share an entry; here they cannot;
- the **runtime**: torch, CUDA, the host's machine type and, for each card
  a program runs on, its name and compute capability. A package is not
  stable across any of them, so a change simply misses and compiles.

Disk layout (``SPARKDL_COMPILE_CACHE``, else
``~/.cache/sparkdl_tpu_torch/programs``; ``off`` disables it)::

    <dir>/<key[:2]>/<key>.pt2    the AOTInductor package
    <dir>/<key[:2]>/<key>.json   the key's components, readable

A package is compiled into a temporary name beside its entry and renamed
into place, so a reader never sees half of one. An entry that does not
load is deleted and treated as a miss (the engine then compiles); past
``max_bytes`` the oldest entries are pruned.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import platform
import tempfile
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

logger = logging.getLogger(__name__)

_ENV_VAR = "SPARKDL_COMPILE_CACHE"
_OFF_VALUES = ("off", "none", "0", "disabled")

#: soft disk budget; the oldest entries are pruned past it at store time
DEFAULT_MAX_BYTES = 20 * 1024**3

#: one argument: (shape, dtype, placement), e.g. ((32, 4), "float32", "cuda:0")
ArgSpec = Tuple[Tuple[int, ...], str, str]


def default_cache_dir() -> Optional[str]:
    """The active cache directory, or None when persistence is disabled.
    Read on every call, so that a test or an operator can redirect or
    disable it without rebuilding engines."""
    spec = os.environ.get(_ENV_VAR, "").strip()
    if spec.lower() in _OFF_VALUES:
        return None
    if spec:
        return spec
    return os.path.join(os.path.expanduser("~"), ".cache", "sparkdl_tpu_torch", "programs")


def placement(device: torch.device) -> str:
    """A device as the key names it: its type and index (``cuda:0``; a
    bare ``cuda`` is the current card's index)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def runtime_descriptor(placements: Iterable[str] = ()) -> Dict[str, Any]:
    """Everything about the runtime that invalidates a package: torch and
    CUDA versions, the host's machine type, and each card named in
    ``placements`` with its name and compute capability."""
    cards = {}
    for where in sorted(set(placements)):
        device = torch.device(where)
        if device.type == "cuda":
            cards[where] = {
                "name": torch.cuda.get_device_name(device),
                "capability": list(torch.cuda.get_device_capability(device)),
            }
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "machine": platform.machine(),
        "cards": cards,
    }


def cache_key(
    fingerprint: str,
    arg_specs: Sequence[ArgSpec],
    closure: Sequence[Tuple[str, str]] = (),
    runtime: Optional[Dict[str, Any]] = None,
) -> str:
    """The content address of one program: a sha256 over the canonical JSON
    of every component that must match for reuse to be sound.

    ``arg_specs`` is ``(shape, dtype, placement)`` per argument (the
    structure of nested arguments included as an entry of its own by the
    engine), ``closure`` the ``(placement, dtype)`` pairs of what the
    function closes over. Pure and deterministic: the same components hash
    alike in any process."""
    placements = [p for _, _, p in arg_specs] + [p for p, _ in closure]
    payload = {
        "fingerprint": str(fingerprint),
        "args": [[[int(d) for d in shape], str(dtype), str(where)]
                 for shape, dtype, where in arg_specs],
        "closure": sorted([str(p), str(d)] for p, d in closure),
        "runtime": runtime if runtime is not None else runtime_descriptor(placements),
    }
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


class PersistentCompileCache:
    """The on-disk store of packages addressed by :func:`cache_key`.

    ``cache_dir=None`` (the default) resolves the directory from the
    environment on every access; pass one to pin it."""

    def __init__(self, cache_dir: Optional[str] = None, max_bytes: int = DEFAULT_MAX_BYTES):
        self._pinned = cache_dir
        self.max_bytes = int(max_bytes)

    @property
    def directory(self) -> Optional[str]:
        return self._pinned if self._pinned is not None else default_cache_dir()

    @property
    def enabled(self) -> bool:
        return self.directory is not None

    def paths(self, key: str) -> Tuple[str, str]:
        """The package's and the description's paths of ``key``."""
        shard = os.path.join(self.directory, key[:2])
        return os.path.join(shard, f"{key}.pt2"), os.path.join(shard, f"{key}.json")

    def __contains__(self, key: str) -> bool:
        return self.enabled and os.path.exists(self.paths(key)[0])

    def temp_path(self, key: str) -> str:
        """A fresh path beside ``key``'s entry for a package being written:
        :meth:`commit` renames it into place."""
        package, _ = self.paths(key)
        os.makedirs(os.path.dirname(package), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(package), suffix=".tmp.pt2")
        os.close(fd)
        return tmp

    def commit(self, key: str, tmp: str, meta: Dict[str, Any]) -> None:
        """Rename the package written at ``tmp`` into ``key``'s entry and
        write its description beside it, then prune."""
        package, meta_path = self.paths(key)
        os.replace(tmp, package)
        with open(meta_path + ".tmp", "w") as fh:
            json.dump(meta, fh, indent=1, default=str)
        os.replace(meta_path + ".tmp", meta_path)
        self._prune()

    def evict(self, key: str) -> None:
        """Delete ``key``'s entry (an unloadable package)."""
        for path in self.paths(key):
            try:
                os.remove(path)
            except OSError:
                pass

    def entries(self) -> List[Tuple[str, str, int, float]]:
        """``(key, package_path, bytes, mtime)`` of every stored package."""
        root = self.directory
        if root is None or not os.path.isdir(root):
            return []
        out = []
        for shard in sorted(os.listdir(root)):
            sub = os.path.join(root, shard)
            if not os.path.isdir(sub):
                continue
            for name in sorted(os.listdir(sub)):
                if not name.endswith(".pt2") or name.endswith(".tmp.pt2"):
                    continue
                path = os.path.join(sub, name)
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                out.append((name[:-4], path, st.st_size, st.st_mtime))
        return out

    def stats(self) -> Dict[str, Any]:
        entries = self.entries()
        return {"dir": self.directory, "enabled": self.enabled,
                "entries": len(entries), "bytes": sum(e[2] for e in entries)}

    def _prune(self) -> None:
        """Drop the oldest entries until the store fits ``max_bytes`` (the
        disk analog of the in-memory LRU; mtime stands for recency)."""
        entries = self.entries()
        total = sum(e[2] for e in entries)
        for key, _, size, _ in sorted(entries, key=lambda e: e[3]):
            if total <= self.max_bytes:
                return
            self.evict(key)
            total -= size
            logger.info("compile cache pruned %s (%d bytes)", key[:12], size)
