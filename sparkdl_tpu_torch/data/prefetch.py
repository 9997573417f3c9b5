"""Bounded background prefetch: the one producer/consumer handoff.

Port of ``sparkdl_tpu.data.prefetch``. The protocol cannot deadlock:

- the producer uses plain *blocking* puts and ALWAYS pushes a final
  sentinel (its ``finally``);
- the consumer's close path sets ``cancel`` and then **drains** the queue
  until the producer thread exits, so the blocking puts always complete,
  the sentinel is never dropped, and ``close()`` returns only after the
  producer thread is joined (no thread outlives a failed call);
- an exception of the producer is re-raised on the consumer.

Instrumented through callbacks: ``on_depth`` gets the items ready ahead of
the consumer after each ``next()`` (the ``data.queue_depth`` gauge) and
``on_wait_ms`` how long the consumer waited on the host (the
``data.device_stall_ms`` histogram). The JAX package's trace-context
handover and ``data.producer_busy`` timer are not ported.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional

#: end-of-stream marker (compared by identity; never reaches a consumer)
_SENTINEL = object()


class _ProducerError:
    """An upstream exception, re-raised on the consumer's side."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchIterator:
    """Iterator over ``source_factory()`` with ``size`` items of background
    lookahead. ``source_factory`` is called once, on the producer thread
    (named ``name``), so a lazy upstream does its work off the consumer's
    thread. ``close()`` mid-stream cancels the producer, drains the queue
    and joins the thread before it returns."""

    def __init__(
        self,
        source_factory: Callable[[], Iterable],
        size: int,
        on_wait_ms: Optional[Callable[[float], None]] = None,
        on_depth: Optional[Callable[[int], None]] = None,
        name: str = "sparkdl-prefetch",
    ):
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, int(size)))
        self._cancel = threading.Event()
        self._done = False
        self._on_wait_ms = on_wait_ms
        self._on_depth = on_depth
        self._thread = threading.Thread(
            target=self._produce, args=(source_factory,), name=name, daemon=True
        )
        self._thread.start()

    def _produce(self, source_factory) -> None:
        it = None
        try:
            it = iter(source_factory())
            while not self._cancel.is_set():
                try:
                    item = next(it)
                except StopIteration:
                    return
                # blocking put: the consumer's close drains the queue, so
                # this completes and the sentinel below is never dropped
                self._queue.put(item)
        except BaseException as exc:  # noqa: BLE001 - re-raised on the consumer
            if not self._cancel.is_set():
                self._queue.put(_ProducerError(exc))
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # pragma: no cover - best-effort cleanup
                    pass
            self._queue.put(_SENTINEL)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        t0 = time.perf_counter()
        item = self._queue.get()
        if self._on_wait_ms is not None:
            self._on_wait_ms((time.perf_counter() - t0) * 1000.0)
        if self._on_depth is not None:
            self._on_depth(self._queue.qsize())
        if item is _SENTINEL:
            self._done = True
            self._thread.join()
            raise StopIteration
        if isinstance(item, _ProducerError):
            self.close()
            raise item.exc
        return item

    def close(self) -> None:
        """Cancel the producer, drain, and join: idempotent, and never
        blocks for good (the producer's puts complete against the drain)."""
        self._done = True
        self._cancel.set()
        while self._thread.is_alive():
            try:
                self._queue.get(timeout=0.05)
            except queue.Empty:
                pass
        self._thread.join()

    def __del__(self):  # pragma: no cover - a safety net for the collector
        try:
            if not self._done:
                self.close()
        except Exception:
            pass
