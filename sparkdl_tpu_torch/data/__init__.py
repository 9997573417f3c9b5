"""The port's data pipeline: so far what the transform loop runs
(:class:`Dataset` with ``from_items``, ``map`` and ``prefetch``, and the
:class:`PrefetchIterator` behind it)."""

from sparkdl_tpu_torch.data.dataset import Dataset  # noqa: F401
from sparkdl_tpu_torch.data.prefetch import PrefetchIterator  # noqa: F401
