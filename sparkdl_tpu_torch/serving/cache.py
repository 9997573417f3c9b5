"""Warm program cache: (model, shape bucket) -> engine-compiled program.

Port of ``sparkdl_tpu.serving.cache``. A cold endpoint's first request
would pay a compile (an AOTInductor compile of a full-width model takes
minutes), so the serving layer keeps one compiled program per (model,
bucket) in a bounded LRU, and :meth:`ProgramCache.warmup` compiles the hot
ones before traffic arrives.

Every program takes ``(params, batch, ...)``: an endpoint's weights are an
input, not constants compiled in, so the slot-block program and each rung
of the ladder share one copy of them on the device, and a package on disk
holds code only. Programs resolve through a private
:class:`~sparkdl_tpu_torch.engine.ExecutionEngine`, so that this cache's
``cache_size`` eviction really releases a loaded program. An endpoint with a durable fingerprint has its programs
persisted to the engine's disk cache: a restarted server's ``warmup()``
loads them instead of compiling, counted in ``serving.cache_load`` (beside
``serving.compiles``) and reported per bucket in :meth:`stats`.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.engine import ExecutionEngine
from sparkdl_tpu_torch.engine.slots import slot_block_fingerprint
from sparkdl_tpu_torch.transformers.utils import bucket_ladder
from sparkdl_tpu_torch.utils.lru import LRUCache
from sparkdl_tpu_torch.utils.metrics import metrics


def _zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(tuple(int(d) for d in shape),
                       dtype=torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype,
                       device=device)


class ProgramCache:
    """Bounded LRU of engine-compiled programs keyed by ``(model_id, bucket,
    item_shape, dtype)``; a ragged endpoint's one slot-block program sits in
    the same LRU under ``("ragged", n_slots)`` in the bucket's place
    (occupancy is a runtime mask, not a key)."""

    def __init__(self, maxsize: int = 32, compile_counter=None):
        self._lock = threading.Lock()
        # single flight: serving key -> Event set when its resolve (which
        # may compile for minutes) ends. The compile runs OUTSIDE the lock,
        # so stats() and other endpoints never stall behind a cold bucket;
        # the event keeps concurrent requests for one key from compiling it
        # N times
        self._inflight: Dict[Tuple, threading.Event] = {}
        # serving key -> {"callable", "engine_key", "source", "seconds"}
        self._programs = LRUCache(maxsize)
        self._compile_counter = compile_counter
        # private engine: eviction below keeps it in step with the LRU
        self._engine = ExecutionEngine(maxsize=maxsize)
        # model_id -> {bucket: {"source", "seconds"}} of the last warmup
        self._warmup_report: Dict[str, Dict[Any, Dict[str, Any]]] = {}

    @staticmethod
    def _key(model_id: str, bucket, item_shape, dtype) -> Tuple:
        return (model_id, bucket, tuple(int(d) for d in item_shape), np.dtype(dtype).str)

    def program(self, model_id: str, forward: Callable, bucket: int,
                item_shape: Sequence[int], dtype: Any, device,
                fingerprint: Optional[str] = None, params: Any = ()) -> Callable:
        """The compiled program of one (model, bucket), resolved through the
        engine (memory, disk, compile) at first use: ``forward(params,
        batch)`` for batches of ``bucket`` items on ``device``, called the
        same way. ``fingerprint`` (the model's durable identity, weights
        included) makes the program persistable."""
        key = self._key(model_id, int(bucket), item_shape, dtype)
        return self._resolve(key, lambda: self._engine.program(
            forward, (params, _zeros((int(bucket), *item_shape), dtype, device)),
            fingerprint=f"serving:{fingerprint}" if fingerprint else None,
            name=f"serving_{model_id}_b{bucket}",
        ))

    def ragged_program(self, model_id: str, fused: Callable, n_slots: int,
                       item_shape: Sequence[int], dtype: Any, device,
                       fingerprint: str, params: Any = ()) -> Callable:
        """The one program of a ragged endpoint: ``fused(params, block,
        mask)`` over the fixed ``(n_slots, *item_shape)`` block and its bool
        occupancy mask, so a dispatch at any occupancy runs the same program.
        ``fingerprint`` is required: the batcher serves an unfingerprinted
        compiled endpoint on the padded ladder rather than compile an
        anonymous slot-block program in every process."""
        if fingerprint is None:
            raise ValueError("ragged slot-block programs require a durable model "
                             "fingerprint (unfingerprinted endpoints serve padded)")
        key = self._key(model_id, ("ragged", int(n_slots)), item_shape, dtype)
        return self._resolve(key, lambda: self._engine.program(
            fused, (params, _zeros((int(n_slots), *item_shape), dtype, device),
                    torch.zeros(int(n_slots), dtype=torch.bool, device=device)),
            fingerprint="serving:" + slot_block_fingerprint(fingerprint, "ragged", n_slots),
            name=f"serving_{model_id}_ragged{n_slots}",
        ))

    def _resolve(self, key: Tuple, build: Callable) -> Callable:
        """Single-flight resolve of one program: claim the key (or wait for
        whoever holds it), then run ``build`` outside the lock."""
        while True:
            with self._lock:
                hit = self._programs.get(key)
                if hit is not None:
                    return hit["callable"]
                waiter = self._inflight.get(key)
                if waiter is None:
                    self._inflight[key] = threading.Event()
                    break
            waiter.wait()

        try:
            start = time.perf_counter()
            handle = build()
            seconds = time.perf_counter() - start
            if handle.source == "compile":
                if self._compile_counter is not None:
                    self._compile_counter.add(1)
            elif handle.source == "disk":
                metrics.counter("serving.cache_load").add(1)
            with self._lock:
                # evict the LRU entry from BOTH maps before admitting the new
                # program, so the engine holds no program the serving stats
                # no longer admit to
                while len(self._programs) >= self._programs.maxsize:
                    oldest = self._programs.keys()[0]
                    self._engine.evict(self._programs.get(oldest)["engine_key"])
                    self._programs.pop(oldest)
                self._programs[key] = {"callable": handle.callable, "engine_key": handle.key,
                                       "source": handle.source, "seconds": seconds}
            return handle.callable
        finally:
            # wake the waiters even on failure: they re-enter the claim loop
            # and one of them resolves
            with self._lock:
                event = self._inflight.pop(key, None)
            if event is not None:
                event.set()

    def source(self, key: Tuple) -> str:
        with self._lock:
            entry = self._programs.get(key)
        return entry["source"] if entry else "memory"

    def report(self, model_id: str, bucket, source: str, seconds: float) -> None:
        """Record one warmed program in :meth:`stats`' warmup report."""
        with self._lock:
            self._warmup_report.setdefault(model_id, {})[bucket] = {
                "source": source, "seconds": round(seconds, 4)}

    def warmup(self, model_id: str, forward: Callable, item_shape: Sequence[int],
               dtype: Any, device, buckets: Optional[Sequence[int]] = None,
               max_batch: int = 32, fingerprint: Optional[str] = None,
               params: Any = ()) -> Tuple[int, ...]:
        """Compile (or load) ``buckets`` (default: the whole
        :func:`~sparkdl_tpu_torch.transformers.utils.bucket_ladder` of
        ``max_batch``) and run zeros through each program, so that no
        steady-state request shape compiles at request time. Returns the
        buckets warmed; each one's source and seconds land in
        :meth:`stats`."""
        buckets = tuple(buckets) if buckets else bucket_ladder(max_batch)
        for b in buckets:
            start = time.perf_counter()
            fn = self.program(model_id, forward, b, item_shape, dtype, device,
                              fingerprint=fingerprint, params=params)
            # run once and wait, off the request path
            fn(params, _zeros((int(b), *item_shape), dtype, device)).cpu()
            self.report(model_id, int(b), self.source(self._key(model_id, int(b), item_shape, dtype)),
                        time.perf_counter() - start)
        return buckets

    def evict_model(self, model_id: str) -> int:
        """Drop every program of ``model_id``; returns how many."""
        with self._lock:
            doomed = [k for k in self._programs.keys() if k[0] == model_id]
            for k in doomed:
                self._engine.evict(self._programs.get(k)["engine_key"])
                self._programs.pop(k)
            self._warmup_report.pop(model_id, None)
            return len(doomed)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            keys = self._programs.keys()
            sources = {k: self._programs.get(k)["source"] for k in keys}
            warmup = {m: dict(report) for m, report in self._warmup_report.items()}
        return {
            "programs": len(keys),
            "maxsize": self._programs.maxsize,
            "keys": [{"model": k[0], "bucket": k[1], "item_shape": list(k[2]), "dtype": k[3],
                      "source": sources[k]} for k in keys],
            "warmup": warmup,
            "persistent": (self._engine.cache.stats() if self._engine.cache is not None
                           else {"enabled": False}),
        }
