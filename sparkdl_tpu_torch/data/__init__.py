"""sparkdl_tpu_torch.data: composable input pipelines with device prefetch.

Port of ``sparkdl_tpu.data``: a lazy :class:`Dataset` graph of sources
(``from_items``, ``from_uris``, ``from_arrays``, ``from_files``,
``from_dataframe``, ``from_stream``) and operators: ``map`` (threaded, in
order), ``shuffle`` (the estimators' permutation stream), ``shard``,
``batch`` (the estimators' cyclic pad), ``prefetch`` (a bounded background
queue, joined on close) and ``prefetch_to_device`` (a pinned buffer and a
side-stream copy per batch, under the consumer's compute on the previous
one). Instrumented with ``data.*`` metrics.
"""

from sparkdl_tpu_torch.data.dataset import Batch, Dataset
from sparkdl_tpu_torch.data.device import default_device_placer
from sparkdl_tpu_torch.data.prefetch import PrefetchIterator

__all__ = [
    "Batch",
    "Dataset",
    "PrefetchIterator",
    "default_device_placer",
]
