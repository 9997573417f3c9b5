"""The estimators' data plane: load the images, build an epoch's batches.

A copy of ``sparkdl_tpu.estimators.data`` for one host: collect (URI,
label) rows, load the images through the user's ``imageLoader`` in a thread
pool, and batch each epoch's permutation with the cyclic-pad policy of
``in_memory_epoch_dataset``, batch for batch; ``labels_to_array`` is the
Keras estimator's label policy. The multi-host shard (``runner``) and the
streaming loader are not ported yet (ROADMAP.md items 12 and 7b).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Tuple

import numpy as np

from sparkdl_tpu_torch.utils.metrics import metrics


def load_host_shard(
    dataset,
    input_col: str,
    label_col: str,
    loader: Callable[[str], Any],
) -> Tuple[np.ndarray, List[Any]]:
    """Collect every (URI, label) row and load the images via ``loader`` in
    a thread pool, timed into ``sparkdl.load``. Returns ``(x, labels)``:
    ``x`` stacked float32, ``labels`` the raw label values (the caller owns
    the dtype policy)."""
    rows = dataset.collect()
    if not rows:
        raise ValueError("fit() received an empty dataset")
    uris = [r[input_col] for r in rows]
    with metrics.timer("sparkdl.load").time(), ThreadPoolExecutor(max_workers=16) as pool:
        images = list(
            pool.map(lambda u: np.asarray(loader(u), dtype=np.float32), uris)
        )
        x = np.stack(images)
    return x, [r[label_col] for r in rows]


def labels_to_array(labels: List[Any]) -> np.ndarray:
    """Scalar labels -> int32 class ids; vector labels -> float32 rows
    (one dtype policy for both estimator data paths)."""
    first = np.asarray(labels[0])
    if first.ndim == 0:
        return np.asarray(labels, dtype=np.int32)
    return np.stack([np.asarray(l, dtype=np.float32) for l in labels])


def epoch_batches(
    order: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    weighted: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """One epoch: ``order`` cut into ``ceil(n / batch_size)`` batches of
    ``{"x", "y", "w"}``, the last one padded by cycling from the start of
    ``order`` (``np.resize``); pad rows carry weight 0, real rows 1.
    ``weighted=False`` leaves ``"w"`` out (a loss without a per-sample
    form trains the pad rows at full weight, as in the JAX package)."""
    n = len(order)
    steps = -(-n // batch_size)
    idx = np.resize(np.asarray(order, np.int64), steps * batch_size)
    w = (np.arange(steps * batch_size) < n).astype(np.float32)
    for rows, weights in zip(idx.reshape(steps, batch_size),
                             w.reshape(steps, batch_size)):
        batch = {"x": x[rows], "y": y[rows]}
        if weighted:
            batch["w"] = weights
        yield batch
