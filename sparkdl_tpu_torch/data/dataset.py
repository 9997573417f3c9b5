"""A lazy ``Dataset`` pipeline: the part the transform loop runs.

A trimmed copy of ``sparkdl_tpu.data.dataset``: :meth:`Dataset.from_items`,
:meth:`Dataset.map` (in order, on the consumer's thread) and
:meth:`Dataset.prefetch`. A ``Dataset`` is a recipe: ``iter(ds)`` builds a
fresh iterator chain, and closing it mid-stream closes the whole chain, so
a prefetch thread is joined. The other sources and operators (files,
frames, streams, ``shuffle``, ``shard``, ``batch``, a threaded ``map``,
``prefetch_to_device``) are not ported yet (ROADMAP item 11).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional, Sequence


class Dataset:
    """One node of the lazy pipeline: build with :meth:`from_items`, chain
    operators, iterate to run."""

    def __init__(self, iter_factory: Callable[[], Iterator],
                 length: Optional[int] = None, name: str = "dataset"):
        self._iter_factory = iter_factory
        self._length = length
        self._name = name

    @staticmethod
    def from_items(items: Sequence, name: str = "from_items") -> "Dataset":
        """A dataset over a finite sequence (kept by reference)."""
        return Dataset(lambda: iter(items), length=len(items), name=name)

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        """``fn`` on each item, in order."""
        src = self

        def mapped():
            it = iter(src)
            try:
                for item in it:
                    yield fn(item)
            finally:
                _close_iter(it)

        return Dataset(mapped, length=self._length, name="map")

    def prefetch(self, size: int = 2, name: str = "sparkdl-prefetch") -> "Dataset":
        """Run the upstream pipeline ``size`` items ahead on a background
        thread (``name``) through a bounded queue; closing the iterator
        cancels, drains and joins it
        (:class:`~sparkdl_tpu_torch.data.prefetch.PrefetchIterator`).
        Sets the ``data.queue_depth`` gauge and observes the consumer's
        waits in the ``data.device_stall_ms`` histogram."""
        src = self

        def prefetched():
            from sparkdl_tpu_torch.data.prefetch import PrefetchIterator
            from sparkdl_tpu_torch.utils.metrics import metrics

            it = PrefetchIterator(
                lambda: iter(src), size,
                on_wait_ms=metrics.histogram("data.device_stall_ms").observe,
                on_depth=metrics.gauge("data.queue_depth").set,
                name=name,
            )
            try:
                yield from it
            finally:
                it.close()

        return Dataset(prefetched, length=self._length, name="prefetch")

    def __iter__(self) -> Iterator:
        return self._iter_factory()

    def __len__(self) -> int:
        if self._length is None:
            raise TypeError(f"len() of unsized dataset ({self._name})")
        return self._length

    def __repr__(self) -> str:
        size = "?" if self._length is None else str(self._length)
        return f"<Dataset {self._name} n={size}>"


def _close_iter(it) -> None:
    close = getattr(it, "close", None)
    if close is not None:
        close()
