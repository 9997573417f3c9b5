"""ExecutionEngine: one owner for compiling, caching and loading programs.

Port of ``sparkdl_tpu.engine.core``. A program is a function compiled ahead
of time at the concrete shapes of its example arguments:

- **compile**: ``torch.export.export`` of the function, then
  ``torch._inductor.aoti_compile_and_package`` into an AOTInductor package
  (:func:`compile_package`), loaded by ``aoti_load_package``
  (:func:`load_package`). The port's hand-written kernels stay what they
  are inside a package: the flash forward is a ``torch.library`` op, so the
  package calls it through the dispatcher, which launches the CUDA kernel
  (and counts the launch) on the card and runs the plain version on the
  CPU;
- **two levels of caching**: a bounded in-memory LRU of loaded programs in
  front of the content-addressed
  :class:`~sparkdl_tpu_torch.engine.cache.PersistentCompileCache` on disk.
  Resolution is memory, then disk, then a compile, and
  :attr:`ProgramHandle.source` says which (``"memory"``, ``"disk"``,
  ``"compile"``). Without a fingerprint a program is compiled and kept in
  the LRU, never written to disk: weights the caller cannot name must not
  be baked into a shared entry;
- **watchdogged** compiles and loads: past a soft timeout a probe of the
  card is logged, past a hard one the call raises
  ``DeviceUnresponsive`` (``SPARKDL_ENGINE_COMPILE_TIMEOUT_S`` sets the hard
  one, default 1800 s; the soft one is the smaller of it and 300 s).

A compile that fails raises: no caller is handed the eager function in its
place. A disk entry that does not load is deleted and compiled again.

XLA's buffer donation has no counterpart here: a package allocates its
outputs, and callers stage host inputs through
:class:`~sparkdl_tpu_torch.engine.executor.PinnedStaging`, whose buffers
are refilled only after the copy that last read them has completed.

Metrics: ``engine.cache_hit`` and ``engine.cache_miss`` count the disk
tier's outcomes (memory hits are free and not counted), the timers
``engine.compile`` and ``engine.cache_load`` the slow paths.
"""

from __future__ import annotations

import functools
import itertools
import logging
import os
import shutil
import tempfile
import time
import types
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from sparkdl_tpu_torch.engine.cache import (
    PersistentCompileCache,
    cache_key,
    placement,
    runtime_descriptor,
)
from sparkdl_tpu_torch.resilience.watchdog import watchdogged
from sparkdl_tpu_torch.utils.lru import LRUCache
from sparkdl_tpu_torch.utils.metrics import metrics

logger = logging.getLogger(__name__)

#: per-process ids of anonymous (unpersistable) functions
_anon_ids = itertools.count(1)

_COMPILE_TIMEOUT_ENV = "SPARKDL_ENGINE_COMPILE_TIMEOUT_S"
_DEFAULT_COMPILE_SOFT_S = 300.0
_DEFAULT_COMPILE_HARD_S = 1800.0


def _compile_timeouts() -> Tuple[float, float]:
    spec = os.environ.get(_COMPILE_TIMEOUT_ENV, "").strip()
    if not spec:
        return _DEFAULT_COMPILE_SOFT_S, _DEFAULT_COMPILE_HARD_S
    hard = float(spec)
    return min(hard, _DEFAULT_COMPILE_SOFT_S), hard


class _Program(torch.nn.Module):
    """A plain function as the module ``torch.export`` takes."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_program(fn: Callable, example_args: Sequence[Any]):
    """``torch.export`` of ``fn`` at the concrete shapes of
    ``example_args``, gradients off. Tensors ``fn`` closes over become
    constants of the program, copied into its package; weights passed in
    ``example_args`` stay inputs (serving passes an endpoint's params so)."""
    module = fn if isinstance(fn, torch.nn.Module) else _Program(fn)
    with torch.no_grad():
        return torch.export.export(module, tuple(example_args))


def compile_package(fn: Callable, example_args: Sequence[Any], path: str) -> None:
    """Compile ``fn`` at ``example_args``' shapes into the AOTInductor
    package ``path``: the engine's one compile. Inductor builds the
    package's C++ with ``$CXX`` (``g++`` when it is unset), which must link
    OpenMP (``-fopenmp``)."""
    torch._inductor.aoti_compile_and_package(export_program(fn, example_args),
                                             package_path=path)


def load_package(path: str) -> Callable:
    """The callable of the package at ``path``."""
    return torch._inductor.aoti_load_package(path)


def _as_tensor(x):
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.from_numpy(np.ascontiguousarray(x))
    return x


class ProgramHandle:
    """One resolved program and how it was obtained: ``source`` is
    ``"memory"``, ``"disk"`` or ``"compile"``; ``seconds`` the resolve's
    cost (0.0 for a memory hit), what serving's warmup report shows."""

    __slots__ = ("callable", "source", "seconds", "key")

    def __init__(self, callable: Callable, source: str, seconds: float, key: str):
        self.callable = callable
        self.source = source
        self.seconds = seconds
        self.key = key

    def __call__(self, *args):
        return self.callable(*args)

    def __repr__(self):
        return (f"ProgramHandle(source={self.source!r}, seconds={self.seconds:.3f}, "
                f"key={self.key[:12]})")


class _Runner:
    """A loaded package as a function: tensor arguments made contiguous (a
    package is compiled for the layout of its example inputs); one output
    comes back alone, several as a tuple (so a function returning a
    1-tuple comes back as its one tensor)."""

    __slots__ = ("_package",)

    def __init__(self, package: Callable):
        self._package = package

    def __call__(self, *args):
        args = [a.contiguous() if isinstance(a, torch.Tensor) else a
                for a in (_as_tensor(a) for a in args)]
        out = self._package(*args)
        if isinstance(out, (list, tuple)):
            return out[0] if len(out) == 1 else tuple(out)
        return out


def closure_placements(fn: Any, max_depth: int = 8) -> List[Tuple[str, str]]:
    """The ``(placement, dtype)`` pairs of every tensor ``fn`` reaches
    through what it closes over: a module's parameters and buffers, a
    function's closure cells and defaults, a bound method's object, a
    ``functools.partial``'s arguments, the containers among them and the
    attributes of this package's objects (a ``TorchFunction``'s params).
    What a function reaches through globals is not seen."""
    seen, found = set(), set()

    def walk(obj, depth):
        if depth > max_depth or id(obj) in seen:
            return
        seen.add(id(obj))
        if isinstance(obj, torch.Tensor):
            found.add((placement(obj.device), str(obj.dtype)))
        elif isinstance(obj, torch.nn.Module):
            for t in itertools.chain(obj.parameters(), obj.buffers()):
                walk(t, depth + 1)
            walk(vars(obj).get("fn"), depth + 1)
        elif isinstance(obj, types.FunctionType):
            for cell in obj.__closure__ or ():
                try:
                    walk(cell.cell_contents, depth + 1)
                except ValueError:  # an empty cell
                    pass
            for value in (obj.__defaults__ or ()):
                walk(value, depth + 1)
            for value in (obj.__kwdefaults__ or {}).values():
                walk(value, depth + 1)
            walk(getattr(obj, "__wrapped__", None), depth + 1)
        elif isinstance(obj, types.MethodType):
            walk(obj.__self__, depth + 1)
            walk(obj.__func__, depth + 1)
        elif isinstance(obj, functools.partial):
            walk(obj.func, depth + 1)
            for value in (*obj.args, *obj.keywords.values()):
                walk(value, depth + 1)
        elif isinstance(obj, dict):
            for value in obj.values():
                walk(value, depth + 1)
        elif isinstance(obj, (list, tuple, set, frozenset)):
            for value in obj:
                walk(value, depth + 1)
        elif type(obj).__module__.startswith("sparkdl_tpu_torch") and hasattr(obj, "__dict__"):
            for value in vars(obj).values():
                walk(value, depth + 1)

    walk(fn, 0)
    return sorted(found)


def _leaf_spec(leaf) -> Tuple[Tuple[int, ...], str, str]:
    """(shape, dtype, placement) of one argument leaf."""
    leaf = _as_tensor(leaf)
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype), placement(leaf.device)
    return (), type(leaf).__name__ + ":" + repr(leaf), "host"


class ExecutionEngine:
    """Process-wide program manager: a bounded LRU of loaded programs over
    the persistent on-disk cache.

    The default instance (:data:`sparkdl_tpu_torch.engine.engine`) serves
    the decode plane; serving's ``ProgramCache`` builds its own, so that its
    ``cache_size`` eviction really releases a program."""

    def __init__(self, maxsize: int = 64, cache: Optional[PersistentCompileCache] = None,
                 persistent: bool = True):
        self._programs = LRUCache(maxsize)
        self._meta: Dict[str, Dict[str, Any]] = {}
        self.cache = (cache if cache is not None
                      else (PersistentCompileCache() if persistent else None))

    # ------------------------------------------------------------------
    # resolution
    # ------------------------------------------------------------------
    def lookup(self, key: str):
        """The loaded program of ``key``, or None."""
        return self._programs.get(key)

    def key(self, fn: Callable, example_args: Sequence[Any],
            fingerprint: Optional[str] = None) -> str:
        """The cache key of ``fn`` at ``example_args``: the fingerprint (or
        this process's id of an anonymous function), each argument's shape,
        dtype and placement, the arguments' structure, and the placements
        of what ``fn`` closes over."""
        fp = fingerprint
        if fp is None:
            fp = getattr(fn, "_engine_anon_id", None)
            if fp is None:
                fp = f"anon:{next(_anon_ids)}"
                try:
                    fn._engine_anon_id = fp
                except AttributeError:  # bound methods and the like
                    fp = f"anon:id:{id(fn)}"
        leaves, spec = pytree.tree_flatten(tuple(example_args))
        arg_specs = [_leaf_spec(leaf) for leaf in leaves]
        arg_specs.append(((0,), str(spec), "structure"))
        closure = closure_placements(fn)
        places = [p for _, _, p in arg_specs] + [p for p, _ in closure]
        runtime = runtime_descriptor(p for p in places if p not in ("host", "structure"))
        return cache_key(fp, arg_specs, closure, runtime=runtime)

    def program(self, fn: Callable, example_args: Sequence[Any],
                fingerprint: Optional[str] = None,
                name: Optional[str] = None) -> ProgramHandle:
        """The program of ``fn`` at the concrete signature of
        ``example_args`` (tensors or numpy arrays, on the device the program
        will run on): from memory, else from disk, else compiled.

        ``fingerprint`` must name the function and every weight it closes
        over durably; without one the program is compiled and kept in memory
        but never persisted."""
        example_args = tuple(_as_tensor(a) for a in example_args)
        key = self.key(fn, example_args, fingerprint)
        hit = self._programs.get(key)
        if hit is not None:
            return ProgramHandle(hit, "memory", 0.0, key)
        return self._resolve(fn, example_args, key, fingerprint,
                             name or getattr(fn, "__name__", "program"))

    def _resolve(self, fn, example_args, key, fingerprint, name) -> ProgramHandle:
        persistable = fingerprint is not None and self.cache is not None and self.cache.enabled
        soft_s, hard_s = _compile_timeouts()

        if persistable and key in self.cache:
            package, _ = self.cache.paths(key)
            start = time.perf_counter()
            try:
                with metrics.timer("engine.cache_load").time():
                    loaded = watchdogged(load_package, package, soft_timeout_s=soft_s,
                                         hard_timeout_s=hard_s, name="engine_cache_load")
            except Exception as exc:  # an unloadable entry: delete it, compile
                logger.warning("compile cache entry %s does not load (%s); "
                               "deleting it and compiling", key[:12], exc)
                self.cache.evict(key)
            else:
                elapsed = time.perf_counter() - start
                metrics.counter("engine.cache_hit").add(1)
                runner = _Runner(loaded)
                self._remember(key, runner, fingerprint, name, "disk")
                return ProgramHandle(runner, "disk", elapsed, key)

        metrics.counter("engine.cache_miss").add(1)
        start = time.perf_counter()
        scratch = None if persistable else tempfile.mkdtemp(prefix="sparkdl-program-")
        path = self.cache.temp_path(key) if persistable else os.path.join(scratch, "program.pt2")
        try:
            with metrics.timer("engine.compile").time():
                watchdogged(compile_package, fn, example_args, path, soft_timeout_s=soft_s,
                            hard_timeout_s=hard_s, name="engine_compile")
            elapsed = time.perf_counter() - start
            if persistable:
                self.cache.commit(key, path, meta={
                    "fingerprint": fingerprint,
                    "program": name,
                    "args": [list(_leaf_spec(a)) for a in pytree.tree_leaves(example_args)],
                    "closure": closure_placements(fn),
                    "compile_seconds": round(elapsed, 3),
                    "runtime": runtime_descriptor(),
                })
                path = self.cache.paths(key)[0]
            loaded = watchdogged(load_package, path, soft_timeout_s=soft_s,
                                 hard_timeout_s=hard_s, name="engine_load")
        finally:
            if scratch is not None:
                shutil.rmtree(scratch, ignore_errors=True)
            elif os.path.exists(path) and path.endswith(".tmp.pt2"):
                os.remove(path)  # a compile that failed before its commit
        runner = _Runner(loaded)
        self._remember(key, runner, fingerprint, name, "compile")
        return ProgramHandle(runner, "compile", time.perf_counter() - start, key)

    def _remember(self, key, runner, fingerprint, name, source) -> None:
        self._programs[key] = runner
        self._meta[key] = {"fingerprint": fingerprint, "program": name, "source": source}
        if len(self._meta) > 4 * max(self._programs.maxsize, 1):
            self._meta = {k: v for k, v in self._meta.items() if self._programs.get(k) is not None}

    # ------------------------------------------------------------------
    # introspection and lifecycle
    # ------------------------------------------------------------------
    def evict(self, key: str) -> bool:
        """Release one loaded program (its disk entry stays)."""
        self._meta.pop(key, None)
        return self._programs.pop(key)

    def stats(self) -> Dict[str, Any]:
        live = self._programs.keys()
        out = {
            "programs": len(live),
            "maxsize": self._programs.maxsize,
            "entries": [{"key": k[:16], **{f: self._meta.get(k, {}).get(f)
                                          for f in ("program", "fingerprint", "source")}}
                        for k in live],
        }
        if self.cache is not None:
            out["persistent"] = self.cache.stats()
        return out
