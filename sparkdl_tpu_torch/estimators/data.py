"""The estimators' data plane: load the images, build an epoch's batches.

A copy of ``sparkdl_tpu.estimators.data`` for one host: collect (URI,
label) rows, load the images through the user's ``imageLoader`` in a thread
pool, and batch each epoch's permutation with the cyclic-pad policy of
``in_memory_epoch_dataset``, batch for batch. The multi-host shard
(``runner``) and the streaming loader are not ported yet.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Tuple

import numpy as np


def load_host_shard(
    dataset,
    input_col: str,
    label_col: str,
    loader: Callable[[str], Any],
) -> Tuple[np.ndarray, List[Any]]:
    """Collect every (URI, label) row and load the images via ``loader`` in
    a thread pool. Returns ``(x, labels)``: ``x`` stacked float32,
    ``labels`` the raw label values (the caller owns the dtype policy)."""
    rows = dataset.collect()
    if not rows:
        raise ValueError("fit() received an empty dataset")
    uris = [r[input_col] for r in rows]
    with ThreadPoolExecutor(max_workers=16) as pool:
        images = list(
            pool.map(lambda u: np.asarray(loader(u), dtype=np.float32), uris)
        )
    return np.stack(images), [r[label_col] for r in rows]


def epoch_batches(
    order: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
) -> Iterator[Dict[str, np.ndarray]]:
    """One epoch: ``order`` cut into ``ceil(n / batch_size)`` batches of
    ``{"x", "y", "w"}``, the last one padded by cycling from the start of
    ``order`` (``np.resize``); pad rows carry weight 0, real rows 1."""
    n = len(order)
    steps = -(-n // batch_size)
    idx = np.resize(np.asarray(order, np.int64), steps * batch_size)
    w = (np.arange(steps * batch_size) < n).astype(np.float32)
    for rows, weights in zip(idx.reshape(steps, batch_size),
                             w.reshape(steps, batch_size)):
        yield {"x": x[rows], "y": y[rows], "w": weights}
